"""The bf16 flash attention backward design's arithmetic, replayed on the
CPU (``bwd_replay``): csrc/flash_attention_bwd.cu's bf16 kernels step by
step, with bf16 q, k and v, dO, P and dS split into bf16 terms, every
product an f32 sum of k16 steps added in the kernel's order, the scale
after Q K^T folded with log2(e) into exp2, each lane's share of the
softmax denominator, and the gradients rounded to bf16.  It is held to the
float64 plain backward within the card's 3e-3 relative l2 (chip_smoke.py's
FLASH_BWD_REL_L2) and to ``jax.grad`` of the reference's attention on the
same numpy inputs.  One torch thread, as tests/test_torch_flash_replay.py
runs (the replay is many small torch ops)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import attention_ref
from repro.models import attention as ref_attn
from repro_torch.kernels import flash_attention as fa
from test_torch_flash_attention import LOG2E, bf16_terms

#: the card's check of the bf16 backward: relative l2 of each gradient
#: against the float64 plain backward (chip_smoke.py FLASH_BWD_REL_L2)
REL_L2 = 3e-3
#: bf16 terms of (P, dO, dS) in the kernel (kTerms)
TERMS = (2, 2, 2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests (see
    tests/test_torch_flash_replay.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def steps(a, b, acc=None):
    """acc + a (..., M, K) @ b (..., K, N), one f32 sum of a k16 step at a
    time added to the accumulator: a chain of wgmma steps."""
    if acc is None:
        acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for c in range(0, a.shape[-1], 16):
        acc = acc + a[..., c:c + 16] @ b[..., c:c + 16, :]
    return acc


def term_pairs(ta, tb):
    """The (A term, B term) products of two split operands, kept where the
    terms' ranks sum below the larger count, smallest first (the kernel's
    dV: P_lo dO_hi, P_hi dO_lo, P_hi dO_hi)."""
    n = max(ta, tb)
    return sorted(((i, j) for i in range(ta) for j in range(tb) if i + j < n),
                  key=lambda p: (-(p[0] + p[1]), -p[0]))


def keep_mask(q0, nq, k0, nk, causal, window, kv_len):
    """(nq, nk): which of queries q0.. see keys k0.. (the forward's mask)."""
    qi = q0 + torch.arange(nq)[:, None]
    kj = k0 + torch.arange(nk)[None, :]
    keep = (kj < kv_len) & (qi >= 0)
    if causal:
        keep &= kj <= qi
    if window > 0:
        keep &= kj > qi - window
    return keep


def bwd_replay(q, k, v, o, dout, *, causal=True, window=0, kv_len=None,
               terms=TERMS):
    """csrc/flash_attention_bwd.cu's bf16 kernels in plain torch: q, o, dout
    (H, S, D), k, v (KVH, S, D), q, k, v f32 holding bf16 values -> dq, dk,
    dv bf16.  ``terms``: bf16 terms of (P, dO, dS).

    prep, a 128-row query block: Delta = rowsum(dO o O); dO's terms; over
    the forward's key tiles (kv_range) in 64-key blocks, S = Q K^T (k16
    steps over D), x = S scale log2(e), masked to NEG_INF, the running max
    m and each lane t's share of l (columns 8 n + 2 t + e), 1 / l from
    (l0 + l1) + (l2 + l3).  dK/dV, a 64-key block: the group's q heads in
    turn, each query block whose tiles hold the key block, 64 rows at a
    time: S^T = K Q^T, dP^T = V dO_lo^T then V dO_hi^T into one chain, P^T
    = exp2(x - m) / l, dS^T = P^T (dP^T - Delta) (0 where masked), then
    per 16 queries dV += the term products of P^T and dO (smallest first)
    and dK += dS^T's terms (lo, then hi) times Q.  dQ, a 128-row query
    block: per 64-key block S, dP (dO's lo then hi), dS, then per 16 keys
    dQ += dS's terms times K.  dK and dQ scaled at the end."""
    tp, tdo, tds = terms
    h, s, d = q.shape
    kvh = k.shape[0]
    rep = h // kvh
    kv_len = s if kv_len is None else kv_len
    scale = torch.tensor(1.0 / d ** 0.5, dtype=torch.float32)
    scale2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    neg = torch.tensor(fa.NEG_INF, dtype=torch.float32)
    delta = (dout * o).sum(-1)
    dts = bf16_terms(dout, tdo)
    kf, vf = (x.repeat_interleave(rep, 0) for x in (k, v))
    m, rl = torch.empty(h, s), torch.empty(h, s)
    ranges = {}
    for q0 in range(0, s, fa.BQ):                       # prep
        lo, hi = fa.kv_range(q0, s, fa.BQ, fa.BQ, causal, window, kv_len)
        ranges[q0] = (lo, hi)
        mm = torch.full((h, fa.BQ), fa.NEG_INF)
        ll = torch.zeros(h, fa.BQ, 4)
        for kb in range(2 * lo, 2 * hi):
            x = steps(q[:, q0:q0 + fa.BQ],
                      kf[:, 64 * kb:64 * kb + 64].transpose(1, 2)) * scale2
            x = torch.where(keep_mask(q0, fa.BQ, 64 * kb, 64, causal, window,
                                      kv_len), x, neg)
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
    for k0 in range(0, s, 64):                          # dK/dV
        kt, vt = k[:, k0:k0 + 64], v[:, k0:k0 + 64]
        ak, av = torch.zeros(kvh, 64, d), torch.zeros(kvh, 64, d)
        for j in range(rep):
            heads = torch.arange(kvh) * rep + j
            for qb in range(s // fa.BQ):
                lo, hi = ranges[fa.BQ * qb]
                if not lo <= k0 // fa.BQ < hi:
                    continue
                for q0 in (fa.BQ * qb, fa.BQ * qb + 64):
                    rows = slice(q0, q0 + 64)
                    qt = q[heads, rows]
                    st = steps(kt, qt.transpose(1, 2))
                    dpt = None
                    for i in reversed(range(tdo)):
                        dpt = steps(vt, dts[i][heads, rows].transpose(1, 2),
                                    dpt)
                    keep = keep_mask(q0, 64, k0, 64, causal, window,
                                     kv_len).T
                    p, ds = softmax_grad(st, dpt, keep, m[heads, None, rows],
                                         rl[heads, None, rows],
                                         delta[heads, None, rows])
                    pt, dst = bf16_terms(p, tp), bf16_terms(ds, tds)
                    for c in range(0, 64, 16):
                        cc, qc = slice(c, c + 16), slice(q0 + c, q0 + c + 16)
                        for i, jj in term_pairs(tp, tdo):
                            av = av + pt[i][..., cc] @ dts[jj][heads, qc]
                        for i in reversed(range(tds)):
                            ak = ak + dst[i][..., cc] @ qt[:, c:c + 16]
        dk[:, k0:k0 + 64] = ak * scale
        dv[:, k0:k0 + 64] = av
    dq = torch.zeros(h, s, d)
    for q0 in range(0, s, fa.BQ):                       # dQ
        lo, hi = ranges[q0]
        rows = slice(q0, q0 + fa.BQ)
        aq = torch.zeros(h, fa.BQ, d)
        for kb in range(2 * lo, 2 * hi):
            keys = slice(64 * kb, 64 * kb + 64)
            sc = steps(q[:, rows], kf[:, keys].transpose(1, 2))
            dp = None
            for i in reversed(range(tdo)):
                dp = steps(dts[i][:, rows], vf[:, keys].transpose(1, 2), dp)
            keep = keep_mask(q0, fa.BQ, 64 * kb, 64, causal, window, kv_len)
            _, ds = softmax_grad(sc, dp, keep, m[:, rows, None],
                                 rl[:, rows, None], delta[:, rows, None])
            dst = bf16_terms(ds, tds)
            for c in range(0, 64, 16):
                kc = slice(64 * kb + c, 64 * kb + c + 16)
                for i in reversed(range(tds)):
                    aq = aq + dst[i][..., c:c + 16] @ kf[:, kc]
        dq[:, rows] = aq * scale
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


def _inputs(seed, h, kvh, s, d):
    """q, k, v rounded to bf16 (as f32) and an f32 output gradient."""
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.normal(size=shape).astype(np.float32)
                     for shape in ((h, s, d), (kvh, s, d), (kvh, s, d),
                                   (h, s, d)))
    q, k, v = (torch.from_numpy(t).bfloat16().float() for t in (q, k, v))
    return q, k, v, torch.from_numpy(dout)


def _rel(got, want):
    got, want = (torch.as_tensor(np.asarray(t, dtype=np.float64))
                 if not isinstance(t, torch.Tensor) else t.double()
                 for t in (got, want))
    return float((got - want).norm() / want.norm())


def _against_float64(q, k, v, dout, terms=TERMS, **kw):
    """The replay's and the plain float64 backward's (dq, dk, dv) of the
    plain forward's output, and each gradient's relative l2."""
    o = fa.flash_attention_plain(q, k, v, **kw)
    got = bwd_replay(q, k, v, o, dout, terms=terms, **kw)
    want = fa.flash_attention_bwd_plain(q.double(), k.double(), v.double(),
                                        o.double(), dout.double(), **kw)
    return got, want, [_rel(a, b) for a, b in zip(got, want)]


@pytest.mark.parametrize("h,kvh,s,d,causal,window,kv_len", [
    (4, 2, 256, 128, True, 0, None), (2, 2, 384, 128, False, 0, None),
    (6, 1, 384, 64, True, 96, None), (4, 4, 256, 128, True, 0, 130),
    (2, 2, 256, 64, False, 0, 200), (4, 2, 384, 128, True, 96, 200),
    (6, 3, 256, 64, False, 100, None)],
    ids=["causal-g2", "non-causal", "window-g6", "causal-kv_len",
         "non-causal-kv_len", "window-kv_len-masked-rows",
         "non-causal-window-g2"])
def test_replay_matches_float64_backward(h, kvh, s, d, causal, window,
                                         kv_len):
    """Each gradient within the card's 3e-3 relative l2 of the float64
    plain backward, in bf16; window-kv_len holds rows whose every key is
    masked (queries 296 and past see none of keys 0-199), which keep the
    forward's uniform weights."""
    q, k, v, dout = _inputs(0, h, kvh, s, d)
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    got, want, rels = _against_float64(q, k, v, dout, **kw)
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert max(rels) <= REL_L2, rels
    if window and kv_len:
        masked = fa.flash_attention_plain(q, k, v, **kw)[:, kv_len + window:]
        assert masked.abs().sum() > 0     # uniform weights, not zeros
        for g, w in zip(got[:1], want[:1]):
            assert not w[:, kv_len + window:].any()
            assert not g[:, kv_len + window:].float().any()


@pytest.mark.parametrize("causal,window,s,d", [
    (True, 0, 256, 64), (False, 0, 256, 128), (True, 96, 384, 64)],
    ids=["causal", "non-causal", "window"])
def test_replay_matches_jax_grad_of_reference_mha(causal, window, s, d):
    """MHA: jax.grad of the reference's attention_ref (f32) on the same
    bf16-valued inputs, within the card's 3e-3 relative l2."""
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


@pytest.mark.parametrize("h,kvh,causal,window,s", [
    (4, 2, True, 0, 256), (6, 1, True, 96, 384), (6, 3, False, 0, 256)],
    ids=["g2-causal", "g6-window", "g2-non-causal"])
def test_replay_matches_jax_grad_of_reference_gqa(h, kvh, causal, window, s):
    """GQA: dK and dV summed over each KV head's group in the walk's order,
    against jax.grad of the reference's attend_chunked (B, S, H, D) in
    f32."""
    q, k, v, dout = _inputs(3, h, kvh, s, 64)
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
        assert not g[:, n:].float().any()


def test_one_bf16_term_each_misses_the_tolerance(capsys):
    """Why dO, P and dS are split: on bf16 inputs at s = 256, d = 128,
    causal, one bf16 term of each misses the card's 3e-3 against float64,
    and two of each sit at the gradients' own bf16 rounding.  Prints each
    candidate's relative l2 (dq, dk, dv) at s = 1024, 4 heads (the
    design's choice in csrc/flash_attention_bwd.cu)."""
    q, k, v, dout = _inputs(0, 4, 2, 256, 128)
    _, want, one = _against_float64(q, k, v, dout, terms=(1, 1, 1))
    _, _, two = _against_float64(q, k, v, dout)
    floor = [_rel(w.to(torch.bfloat16), w) for w in want]
    assert max(one) > REL_L2
    assert all(t <= 1.01 * f for t, f in zip(two, floor))
    q, k, v, dout = _inputs(0, 4, 4, 1024, 128)
    rows = []
    for terms in ((1, 1, 1), (1, 2, 2), (2, 2, 1), (2, 2, 2), (3, 3, 3)):
        _, want, rels = _against_float64(q, k, v, dout, terms=terms)
        rows.append(f"{terms} " + ", ".join(f"{r:.3g}" for r in rels))
    floor = ", ".join(f"{_rel(w.to(torch.bfloat16), w):.3g}" for w in want)
    with capsys.disabled():
        print("\nbf16 flash backward replay against float64 (s=1024, "
              "d=128, 4 heads, causal), (P, dO, dS) terms: relative l2 "
              "(dq, dk, dv): " + "; ".join(rows) + f"; bf16 rounding alone "
              f"{floor}")


def test_dout_terms_sum_back_within_an_ulp_of_the_lo_term():
    """prep's two bf16 terms of the f32 dO: hi = bf16(dO), lo = bf16(dO -
    hi); hi + lo is dO within one bf16 ulp of lo (16 of dO's 24
    significand bits)."""
    _, _, _, dout = _inputs(4, 4, 2, 256, 128)
    dout = torch.cat([dout.flatten(), torch.tensor([0.0, 1.0, -3e-30,
                                                    1e30])])
    hi, lo = bf16_terms(dout, 2)
    assert torch.equal(hi, dout.bfloat16().float())
    assert torch.equal(lo, (dout - hi).bfloat16().float())
    exp = torch.frexp(lo)[1].double()
    ulp = torch.where(lo == 0, torch.zeros_like(exp), 2.0 ** (exp - 8))
    assert ((dout.double() - hi.double() - lo.double()).abs() <= ulp).all()


def test_the_query_blocks_that_visit_a_key_tile_are_a_run():
    """fa_bwd16_dkdv walks, for each key tile, one run of query blocks:
    both ends of kv_range grow with the query block, so the blocks whose
    tiles hold a key tile are consecutive, under every mask."""
    for s in (128, 384, 1024):
        for causal in (True, False):
            for window in (0, 1, 96, 200, 1000):
                for kv_len in (1, 130, s):
                    for t in range(s // fa.BQ):
                        hits = [qb for qb in range(s // fa.BQ)
                                if fa.kv_range(qb * fa.BQ, s, fa.BQ, fa.BQ,
                                               causal, window,
                                               kv_len)[0] <= t <
                                fa.kv_range(qb * fa.BQ, s, fa.BQ, fa.BQ,
                                            causal, window, kv_len)[1]]
                        assert hits == list(range(hits[0], hits[-1] + 1)) \
                            if hits else True
