"""The f32 flash attention backward design's arithmetic, replayed on the
CPU (``bwd_replay``): csrc/flash_attention_bwd.cu's f32 kernels step by
step, every product in 3xTF32 as the kernels' mma.sync steps (each operand
split by ``split_rz`` into hi, x with its low 13 bits cleared, and lo = x
- hi, the tensor core reading lo rounded toward zero; per k8 step lo hi,
hi lo, then hi hi, each step's sum added to the f32 accumulator), the
scale after Q K^T folded with log2(e) into exp2, prep's running max and
each lane's share of l, each step's dK, dV and dQ product summed from zero
before it is added, and dQ by two halves (32 keys of each 64-key step)
that meet once at the end.  It is held to the
float64 plain backward within the card's 2e-5 relative l2 (chip_smoke.py's
FLASH_BWD_REL_L2) and to ``jax.grad`` of the reference's attention on the
same numpy inputs.  Two float64 tests pin the fragment mappings the
kernels rest on: ldmatrix.x4 of f32 rows as A and B fragments, and a
product_rows accumulator read in place as the A fragments of the next
product.  One torch thread, as tests/test_torch_flash_replay.py runs."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import attention_ref
from repro.models import attention as ref_attn
from repro_torch.kernels import flash_attention as fa
from test_torch_flash_attention import (LOG2E, _A_AT, _B_AT, _C_AT, _G, _T,
                                        _matrix, _tensor_core, split)
from test_torch_flash_backward_replay import keep_mask

#: the card's check of the f32 backward: relative l2 of each gradient
#: against the float64 plain backward (chip_smoke.py FLASH_BWD_REL_L2)
REL_L2 = 2e-5
#: rows of a block of queries or keys, and of a warp's half of one
BLK, HALF = 64, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests (see
    tests/test_torch_flash_replay.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def split_rz(x):
    """csrc/mma_tf32.cuh's split_rz: x = hi + lo, hi = x with its low 13
    bits cleared (tf32 rounded toward zero, what the tensor core reads of
    x itself), lo = x - hi exact."""
    hi = _tensor_core(x)
    return hi, x - hi


def mma3(a, b, terms=3):
    """a (..., M, K) @ b (..., K, N) as the kernels' mma.sync m16n8k8 steps
    from a zero accumulator: per k8 step (in order) lo hi, hi lo, then hi
    hi, each step's f32 sum added to the accumulator; ``terms`` = 1 keeps
    hi hi alone (1xTF32)."""
    ah, al = split_rz(a)
    bh, bl = split_rz(b)
    al, bl = _tensor_core(al), _tensor_core(bl)
    pairs = ((al, bh), (ah, bl), (ah, bh)) if terms == 3 else ((ah, bh),)
    k = a.shape[-1]
    parts = [torch.einsum("...mck,...ckn->...cmn",
                          x.unflatten(-1, (k // 8, 8)),
                          y.unflatten(-2, (k // 8, 8))) for x, y in pairs]
    acc = torch.zeros(parts[0].shape[:-3] + parts[0].shape[-2:])
    for c in range(k // 8):
        for part in parts:
            acc = acc + part[..., c, :, :]
    return acc


def halves(x, dim):
    """(..., 64, ...) -> (..., 2, 32, ...) on ``dim`` (a negative index of
    x), the half moved just before the matrix dims."""
    x = x.unflatten(dim, (2, HALF))
    return x.movedim(dim - 1 if dim < 0 else dim, -3)


def bwd_replay(q, k, v, o, dout, *, causal=True, window=0, kv_len=None,
               terms=3):
    """csrc/flash_attention_bwd.cu's f32 kernels in plain torch: q, o, dout
    (H, S, D), k, v (KVH, S, D) f32 -> dq, dk, dv f32; ``terms`` 3 (the
    kernels) or 1 (every product 1xTF32).

    prep, a 128-row query block: Delta = rowsum(dO o O); over the forward's
    key tiles (kv_range) in 64-key blocks, S = Q K^T, x = S scale log2(e),
    masked to NEG_INF, the running max m and each lane t's share of l
    (columns 8 j + 2 t + e), 1 / l from (l0 + l1) + (l2 + l3).  dK/dV, a
    64-key block: the group's q heads in turn, each query block whose
    tiles hold the key block, 64 rows at a time: S^T = K Q^T, dP^T = V
    dO^T, P^T = exp2(x - m) / l, dS^T = P^T (dP^T - Delta) (0 where
    masked), then the step's P^T dO and dS^T Q over its 64 queries, each
    summed from zero and added to dV and dK.  dQ, a 64-row query block: per
    64-key block S, dP, dS, then per half of 32 keys the block's dS K added
    to that half's dQ, the halves added at the end.  dK and dQ scaled at
    the end."""
    h, s, d = q.shape
    kvh = k.shape[0]
    rep = h // kvh
    kv_len = s if kv_len is None else kv_len
    scale = torch.tensor(1.0 / d ** 0.5, dtype=torch.float32)
    scale2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    neg = torch.tensor(fa.NEG_INF, dtype=torch.float32)
    delta = (dout * o).sum(-1)
    kf, vf = (x.repeat_interleave(rep, 0) for x in (k, v))
    m, rl = torch.empty(h, s), torch.empty(h, s)

    def tiles(q0):
        return fa.kv_range(q0 - q0 % fa.BQ, s, fa.BQ, fa.BQ, causal, window,
                           kv_len)

    for q0 in range(0, s, fa.BQ):                       # prep
        lo, hi = tiles(q0)
        mm = torch.full((h, fa.BQ), fa.NEG_INF)
        ll = torch.zeros(h, fa.BQ, 4)
        for kb in range(2 * lo, 2 * hi):
            x = mma3(q[:, q0:q0 + fa.BQ],
                     kf[:, BLK * kb:BLK * kb + BLK].transpose(1, 2),
                     terms=terms) * scale2
            x = torch.where(keep_mask(q0, fa.BQ, BLK * kb, BLK, causal,
                                      window, kv_len), x, neg)
            mn = torch.maximum(mm, x.amax(-1))
            share = torch.exp2(x - mn[..., None]).reshape(h, fa.BQ, 8, 4, 2)
            ll = ll * torch.exp2(mm - mn)[..., None] + share.sum(dim=(2, 4))
            mm = mn
        total = (ll[..., 0] + ll[..., 1]) + (ll[..., 2] + ll[..., 3])
        m[:, q0:q0 + fa.BQ] = mm
        rl[:, q0:q0 + fa.BQ] = torch.where(total > 0, 1.0 / total,
                                           torch.zeros_like(total))

    def softmax_grad(sc, dp, keep, mq, rq, dq_):
        p = torch.exp2(torch.where(keep, sc * scale2, neg) - mq) * rq
        ds = torch.where(keep, p * (dp - dq_), torch.zeros_like(p))
        return p, ds

    dk, dv = torch.zeros(kvh, s, d), torch.zeros(kvh, s, d)
    for k0 in range(0, s, BLK):                         # dK/dV
        kt, vt = k[:, k0:k0 + BLK], v[:, k0:k0 + BLK]
        ak, av = torch.zeros(kvh, BLK, d), torch.zeros(kvh, BLK, d)
        for j in range(rep):
            heads = torch.arange(kvh) * rep + j
            for qb in range(s // fa.BQ):
                lo, hi = tiles(fa.BQ * qb)
                if not lo <= k0 // fa.BQ < hi:
                    continue
                for q0 in (fa.BQ * qb, fa.BQ * qb + BLK):
                    rows = slice(q0, q0 + BLK)
                    qt, dt = q[heads, rows], dout[heads, rows]
                    st = mma3(kt, qt.transpose(1, 2), terms=terms)
                    dpt = mma3(vt, dt.transpose(1, 2), terms=terms)
                    keep = keep_mask(q0, BLK, k0, BLK, causal, window,
                                     kv_len).T
                    p, ds = softmax_grad(st, dpt, keep, m[heads, None, rows],
                                         rl[heads, None, rows],
                                         delta[heads, None, rows])
                    av = av + mma3(p, dt, terms=terms)
                    ak = ak + mma3(ds, qt, terms=terms)
        dv[:, k0:k0 + BLK] = av
        dk[:, k0:k0 + BLK] = ak * scale
    dq = torch.zeros(h, s, d)
    for q0 in range(0, s, BLK):                         # dQ
        lo, hi = tiles(q0)
        rows = slice(q0, q0 + BLK)
        aq = torch.zeros(h, 2, BLK, d)
        for kb in range(2 * lo, 2 * hi):
            keys = slice(BLK * kb, BLK * kb + BLK)
            sc = mma3(q[:, rows], kf[:, keys].transpose(1, 2), terms=terms)
            dp = mma3(dout[:, rows], vf[:, keys].transpose(1, 2), terms=terms)
            keep = keep_mask(q0, BLK, BLK * kb, BLK, causal, window, kv_len)
            _, ds = softmax_grad(sc, dp, keep, m[:, rows, None],
                                 rl[:, rows, None], delta[:, rows, None])
            aq = aq + mma3(halves(ds, -1), halves(kf[:, keys], -2),
                           terms=terms)
        dq[:, rows] = (aq[:, 0] + aq[:, 1]) * scale
    return dq, dk, dv


def _inputs(seed, h, kvh, s, d):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 for shape in ((h, s, d), (kvh, s, d), (kvh, s, d),
                               (h, s, d)))


def _rel(got, want):
    got, want = (torch.as_tensor(np.asarray(t, dtype=np.float64))
                 if not isinstance(t, torch.Tensor) else t.double()
                 for t in (got, want))
    return float((got - want).norm() / want.norm())


def _against_float64(q, k, v, dout, terms=3, **kw):
    """The replay's and the plain float64 backward's (dq, dk, dv) of the
    plain forward's output, and each gradient's relative l2."""
    o = fa.flash_attention_plain(q, k, v, **kw)
    got = bwd_replay(q, k, v, o, dout, terms=terms, **kw)
    want = fa.flash_attention_bwd_plain(q.double(), k.double(), v.double(),
                                        o.double(), dout.double(), **kw)
    return got, want, [_rel(a, b) for a, b in zip(got, want)]


@pytest.mark.parametrize("h,kvh,s,d,causal,window,kv_len", [
    (4, 2, 256, 128, True, 0, None), (2, 2, 256, 128, False, 0, None),
    (6, 1, 256, 64, True, 96, None), (4, 4, 256, 128, True, 0, 130),
    (2, 2, 256, 64, False, 0, 200), (4, 2, 256, 128, True, 40, 150),
    (6, 3, 256, 64, False, 100, None)],
    ids=["causal-g2", "non-causal", "window-g6", "causal-kv_len",
         "non-causal-kv_len", "window-kv_len-masked-rows",
         "non-causal-window-g2"])
def test_replay_matches_float64_backward(h, kvh, s, d, causal, window,
                                         kv_len):
    """Each gradient within the card's 2e-5 relative l2 of the float64
    plain backward; window-kv_len holds rows whose every key is masked
    (queries 190 and past see none of keys 0-149), which keep the
    forward's uniform weights and get no dQ."""
    q, k, v, dout = _inputs(0, h, kvh, s, d)
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    got, want, rels = _against_float64(q, k, v, dout, **kw)
    assert all(g.dtype == torch.float32 for g in got)
    assert max(rels) <= REL_L2, rels
    if window and kv_len:
        masked = fa.flash_attention_plain(q, k, v, **kw)[:, kv_len + window:]
        assert masked.abs().sum() > 0     # uniform weights, not zeros
        assert not want[0][:, kv_len + window:].any()
        assert not got[0][:, kv_len + window:].any()


@pytest.mark.parametrize("causal,window,s,d", [
    (True, 0, 256, 64), (False, 0, 128, 128), (True, 96, 256, 64)],
    ids=["causal", "non-causal", "window"])
def test_replay_matches_jax_grad_of_reference_mha(causal, window, s, d):
    """MHA: jax.grad of the reference's attention_ref (f32) on the same
    numpy inputs, within the card's 2e-5 relative l2."""
    q, k, v, dout = _inputs(1, 2, 2, s, d)
    dn = dout.numpy()

    def f(q_, k_, v_):
        return jnp.sum(attention_ref(q_, k_, v_, causal=causal,
                                     window=window) * dn)
    want = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    o = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    got = bwd_replay(q, k, v, o, dout, causal=causal, window=window)
    for g, w in zip(got, want):
        assert _rel(g, w) <= REL_L2


@pytest.mark.parametrize("h,kvh,causal,window,s,d", [
    (4, 2, True, 0, 256, 64), (6, 1, True, 96, 256, 64),
    (6, 3, False, 0, 128, 128)],
    ids=["g2-causal", "g6-window", "g2-non-causal"])
def test_replay_matches_jax_grad_of_reference_gqa(h, kvh, causal, window, s,
                                                  d):
    """GQA: dK and dV summed over each KV head's group in the walk's order,
    against jax.grad of the reference's attend_chunked (B, S, H, D) in
    f32."""
    q, k, v, dout = _inputs(3, h, kvh, s, d)
    idx = jnp.asarray(np.arange(h) // (h // kvh), jnp.int32)
    dn = dout.numpy()

    def f(q_, k_, v_):
        out = ref_attn.attend_chunked(
            q_[None].transpose(0, 2, 1, 3), k_[None].transpose(0, 2, 1, 3),
            v_[None].transpose(0, 2, 1, 3), idx, causal=causal,
            window=window, chunk=64)
        return jnp.sum(out[0].transpose(1, 0, 2) * dn)
    want = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    o = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    got = bwd_replay(q, k, v, o, dout, causal=causal, window=window)
    for g, w in zip(got, want):
        assert _rel(g, w) <= REL_L2


def test_replay_with_kv_len_matches_reference_on_the_true_rows():
    """S = 256 padded past a key count of 200, non-causal: the true rows'
    gradients are jax.grad of the reference over the first 200 rows, the
    padding gets none (its output gradient 0, as the model's slicing)."""
    n = 200
    q, k, v, dout = _inputs(2, 4, 4, 256, 64)
    dout[:, n:] = 0.0
    dn = dout.numpy()[:, :n]

    def f(q_, k_, v_):
        return jnp.sum(attention_ref(q_, k_, v_, causal=False) * dn)
    want = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(t.numpy()[:, :n]) for t in (q, k, v)))
    o = fa.flash_attention_plain(q, k, v, causal=False, kv_len=n)
    got = bwd_replay(q, k, v, o, dout, causal=False, kv_len=n)
    for g, w in zip(got, want):
        assert _rel(g[:, :n], w) <= REL_L2
        assert not g[:, n:].any()


def test_one_tf32_term_misses_the_tolerance(capsys, monkeypatch):
    """Why every product is 3xTF32: with hi hi alone (1xTF32, what the
    tensor core reads of the f32 operands themselves) the gradients miss
    the card's 2e-5 against float64 by an order of magnitude or more, and
    3xTF32 sits within it.  Prints both at s = 256, d = 128, 4 heads over
    2, causal, and 3xTF32 with the forward's split (hi = tf32(x) rounded
    to nearest) beside."""
    q, k, v, dout = _inputs(0, 4, 2, 256, 128)
    _, _, one = _against_float64(q, k, v, dout, terms=1)
    _, _, three = _against_float64(q, k, v, dout)
    assert min(one) > 10 * REL_L2
    assert max(three) <= REL_L2
    monkeypatch.setattr(sys.modules[__name__], "split_rz", split)
    _, _, rna = _against_float64(q, k, v, dout)
    with capsys.disabled():
        print("\nf32 flash backward replay against float64 (s=256, d=128, 4 "
              "heads over 2, causal), relative l2 (dq, dk, dv): 1xTF32 "
              + ", ".join(f"{r:.3g}" for r in one) + "; 3xTF32 "
              + ", ".join(f"{r:.3g}" for r in three) + "; 3xTF32 with hi "
              "rounded to nearest " + ", ".join(f"{r:.3g}" for r in rna))


def _ldmatrix_x4(rows, cols):
    """ldmatrix.x4 of f32 data moved as b16 pairs: lane l gives the address
    of row l % 8 of matrix l // 8, each row 16 bytes (4 f32); register j of
    lane i is f32 (i // 4, i % 4) of matrix j.  rows, cols (32,): the
    (row, first column) each lane's address points at -> (32 lanes, 4
    registers) of (row, column) pairs."""
    lane = torch.arange(32)
    j = torch.arange(4)
    src = 8 * j[None, :] + lane[:, None] // 4     # the lane of j's row
    return rows[src], cols[src] + (lane % 4)[:, None]


def test_ldmatrix_moves_f32_rows_into_tf32_fragments():
    """product_rows' addresses: lane l = 8 mi + r8 points A at row r8 + 8
    (mi % 2), column 4 (mi / 2) of the k-step, and B at row r8 + 8 (mi /
    2), column 4 (mi % 2); ldmatrix.x4 then hands each lane A's a0..a3 and
    the b0, b1 of two n-blocks, in float64 against the product."""
    lane = torch.arange(32)
    r8, mi = lane % 8, lane // 8
    a_rows, a_cols = _ldmatrix_x4(r8 + 8 * (mi % 2), 4 * (mi // 2))
    b_rows, b_cols = _ldmatrix_x4(r8 + 8 * (mi // 2), 4 * (mi % 2))
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.normal(size=(16, 8)))
    y = torch.from_numpy(rng.normal(size=(16, 8)))   # two n-blocks' rows
    af = a[a_rows, a_cols]                              # (32, 4)
    for n in range(2):
        bf = y[b_rows[:, 2 * n:2 * n + 2], b_cols[:, 2 * n:2 * n + 2]]
        got = _matrix(af, _A_AT, 16) @ _matrix(bf, _B_AT, 8)
        assert torch.allclose(got, a @ y[8 * n:8 * n + 8].T, rtol=0,
                              atol=1e-12)


def test_accumulator_read_in_place_as_a_fragments():
    """product_cols on the m16n8k8 layouts in float64: n-block j of a
    product_rows accumulator C (16 x 8) taken as the A fragment (a0..a3 =
    c0, c2, c1, c3), with B rows 2 t and 2 t + 1 of the step's 8 Y rows at
    column 32 c + 4 g + i for n-block 4 c + i, gives C Y, its register 2 r
    + e of n-block 4 c + i being row g + 8 r, column 32 c + 8 t + 4 e + i
    (put_cols' order)."""
    rng = np.random.default_rng(6)
    c = torch.from_numpy(rng.normal(size=(16, 8)))
    y = torch.from_numpy(rng.normal(size=(8, 128)))
    cf = c.reshape(-1)[_C_AT].reshape(32, 4)
    af = cf[:, [0, 2, 1, 3]]
    a = _matrix(af, _A_AT, 16)
    want = c @ y
    out = torch.full((16, 128), float("nan"), dtype=torch.float64)
    for nb in range(16):
        cc, i = nb // 4, nb % 4
        bf = torch.stack([y[2 * _T, 32 * cc + 4 * _G + i],
                          y[2 * _T + 1, 32 * cc + 4 * _G + i]], -1)
        acc = a @ _matrix(bf, _B_AT, 8)
        regs = acc.reshape(-1)[_C_AT].reshape(32, 4)
        for r in range(2):
            for e in range(2):
                out[_G + 8 * r, 32 * cc + 8 * _T + 4 * e + i] = \
                    regs[:, 2 * r + e]
    assert torch.allclose(out, want, rtol=0, atol=1e-12)
