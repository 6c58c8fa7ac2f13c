"""The port's flash attention on CPU tensors (its plain torch version: the
reference's tiled online softmax with its KV pruning) against the
reference's Pallas kernel in interpret mode and the oracles, on the same
numpy inputs.

On a CUDA tensor the same wrapper launches csrc/flash_attention.cu; that
kernel is held to the plain version on the card by ``chip_smoke.py``.
``mma_replay`` replays the kernel's arithmetic here, lane by lane: its
3xTF32 ``mma.sync`` fragments, relabelled KV rows and permuted d columns,
and its online softmax over kc-row sub-tiles."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                         # noqa: E402

from repro.bench import scenario as ref_scenario                # noqa: E402
from repro.core import Strategy as RefStrategy                  # noqa: E402
from repro.kernels import flash_attention as ref_fa             # noqa: E402
from repro.kernels import ops as ref_ops                        # noqa: E402
from repro.kernels import ref as ref_ref                        # noqa: E402
from repro.tuning import search_space as ref_space              # noqa: E402
from repro_torch.bench import runner, scenario                  # noqa: E402
from repro_torch.bench.scenario import args_from_numpy          # noqa: E402
from repro_torch.core.async_pipeline import (PipelineSpec,      # noqa: E402
                                             Strategy)
from repro_torch.kernels import _build, flash_attention, ops    # noqa: E402
from repro_torch.kernels import ref                             # noqa: E402
from repro_torch.tuning import search_space                     # noqa: E402

STRATEGIES = [s.value for s in RefStrategy]
#: the reference's tolerance (tests/test_kernels.py::test_flash_attention)
TOL = 2e-5


def _qkv(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in (shape_q, shape_kv, shape_kv))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 256)])
@pytest.mark.parametrize("h,kvh", [(4, 2), (4, 4), (8, 1)])
def test_flash_matches_reference(strategy, causal, window, h, kvh):
    s, d = 256, 64
    q, k, v = _qkv((h, s, d), (kvh, s, d), 0)
    want = ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window, strategy=strategy, bq=128,
                                   bk=128)
    tq, tk, tv = args_from_numpy("flash_attention", [q, k, v], "cpu")
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                              strategy=strategy, bq=128, bk=128)
    assert got.dtype == torch.float32 and tuple(got.shape) == (h, s, d)
    _close(got, want)
    kr, vr = (np.repeat(t, h // kvh, axis=0) for t in (k, v))
    _close(got, ref_ref.attention_ref(jnp.asarray(q), jnp.asarray(kr),
                                      jnp.asarray(vr), causal=causal,
                                      window=window))


def test_flash_batched_matches_reference():
    """Leading batch dims: the reference vmaps them, the port folds them
    into one call (one launch on the card)."""
    b, h, s, d = 2, 4, 256, 64
    q, k, v = _qkv((b, h, s, d), (b, 2, s, d), 1)
    want = ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v))
    got = ops.flash_attention(*args_from_numpy("flash_attention", [q, k, v],
                                               "cpu"))
    _close(got, want)
    _close(got, scenario.ORACLES["flash_attention"](
        tuple(torch.from_numpy(t) for t in (q, k, v)), {}))


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 96),
                                           (False, 200)])
def test_attention_ref_matches_reference_oracle(causal, window):
    q, k, v = _qkv((3, 64, 32), (3, 64, 32), 2)
    got = ref.attention_ref(*(torch.from_numpy(t) for t in (q, k, v)),
                            causal=causal, window=window, scale=0.3)
    _close(got, ref_ref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      window=window, scale=0.3))


@pytest.mark.parametrize("bk", [32, 64, 128])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 100),
                                           (False, 300)])
def test_plain_tiles_match_oracle(bk, causal, window):
    """The plain version's pruned online softmax, at other tile widths,
    equals the dense oracle."""
    q, k, v = (torch.from_numpy(t) for t in _qkv((2, 3, 512, 64),
                                                  (2, 1, 512, 64), 3))
    got = flash_attention.flash_attention_plain(q, k, v, causal=causal,
                                                window=window, bq=128, bk=bk)
    want = scenario.ORACLES["flash_attention"](
        (q, k, v), {"causal": causal, "window": window})
    _close(got, want)


def test_kv_range_prunes_exactly_the_masked_tiles():
    """[lo, hi) are exactly the KV tiles a q block's mask lets any entry
    of through (the reference's formula)."""
    s, bq = 1024, 128
    for bk in (64, 128, 256):
        for causal, window in ((True, 0), (False, 0), (True, 200),
                               (False, 300)):
            for q0 in range(0, s, bq):
                lo, hi = flash_attention.kv_range(q0, s, bq, bk, causal,
                                                  window)
                qi = np.arange(q0, q0 + bq)[:, None]
                kv = np.arange(s)[None, :]
                keep = np.ones((bq, s), bool)
                if causal:
                    keep &= kv <= qi
                if window > 0:
                    keep &= kv > qi - window
                tiles = np.flatnonzero(keep.reshape(bq, s // bk, bk)
                                       .any(axis=(0, 2)))
                assert (lo, hi) == (tiles.min(), tiles.max() + 1)
    assert flash_attention.kv_range(512, 4096, 128, 128, True, 256) == (2, 5)
    assert flash_attention.kv_range(3968, 4096, 128, 128, True, 0) == (0, 32)


@pytest.mark.parametrize("call", [
    lambda: ops.flash_attention(torch.zeros(2, 200, 64), torch.zeros(2, 200, 64),
                                torch.zeros(2, 200, 64)),
    lambda: ops.flash_attention(torch.zeros(3, 256, 64), torch.zeros(2, 256, 64),
                                torch.zeros(2, 256, 64)),
    lambda: ops.flash_attention(torch.zeros(2, 256, 64), torch.zeros(2, 128, 64),
                                torch.zeros(2, 128, 64)),
    lambda: flash_attention.flash_attention_cuda(
        *(torch.zeros(2, 256, 64, device="meta"),) * 3)])
def test_invalid_calls_raise_value_error(call):
    with pytest.raises(ValueError):
        call()


def test_non_divisible_seq_raises_like_reference():
    q = np.zeros((2, 192, 64), np.float32)
    with pytest.raises(ValueError, match="must divide"):
        ref_ops.flash_attention(*(jnp.asarray(q),) * 3, bq=128, bk=128)
    with pytest.raises(ValueError, match="must divide"):
        ops.flash_attention(*(torch.from_numpy(q),) * 3, bq=128, bk=128)


@pytest.mark.parametrize("shape", [(2, 256, 64), (12, 4096, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_spec_matches_reference(shape, dtype):
    """(h, s, d) is the reference's model; (b, h, kvh, s, d) is the same
    model per batch and q head."""
    spec, want = search_space.SPECS["flash_attention"], \
        ref_space.SPECS["flash_attention"]
    cfg = ops.default_config("flash_attention")
    ref_fb = want.flops_bytes(shape, dtype, cfg)
    assert spec.flops_bytes(shape, dtype, cfg) == pytest.approx(ref_fb)
    assert spec.n_tiles(shape, cfg) == want.n_tiles(shape, cfg)
    h, s, d = shape
    for b, kvh in ((1, h), (4, 2)):
        assert spec.flops_bytes((b, h, kvh, s, d), dtype, cfg) == \
            pytest.approx(tuple(b * x for x in ref_fb))
        assert spec.n_tiles((b, h, kvh, s, d), cfg) == want.n_tiles(shape, cfg)
    q, k, v = spec.make_args((2, 4, 2, 128, 64), dtype,
                             torch.Generator().manual_seed(0), "cpu")
    assert tuple(q.shape) == (2, 4, 128, 64)
    assert tuple(k.shape) == tuple(v.shape) == (2, 2, 128, 64)
    assert q.dtype == getattr(torch, dtype) and abs(float(q.float().mean())) < 0.1


def test_h100_cell_work():
    """h100/flash_attention: 206.2 GFLOP (the causal half) on 234.9 MB of
    q, k, v and out."""
    sc = scenario.get_scenario("h100/flash_attention/overlap")
    b, h, kvh, s, d = sc.shape
    assert (sc.dtype, sc.workload) == ("float32", {"causal": True, "window": 0})
    assert 2 * b * h * s * s * d == 206_158_430_208
    assert (2 * b * h + 2 * b * kvh) * s * d * 4 == 234_881_024
    assert (h, kvh, d) == (12, 2, 128)


def test_cpu_calls_launch_nothing_and_build_nothing():
    flash_attention.LAUNCHES = 0
    q = torch.rand(2, 4, 128, 64)
    ops.flash_attention(q, q[:, :2], q[:, :2])
    ops.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16(), window=64)
    assert flash_attention.LAUNCHES == 0
    assert _build._libs == {}


def test_smoke_cell_matches_reference():
    sc = scenario.get_scenario("smoke/flash_attention")
    ref_sc = ref_scenario.get_scenario("smoke/flash_attention")
    assert (sc.kernel, sc.shape, sc.dtype, sc.workload) == \
        (ref_sc.kernel, ref_sc.shape, ref_sc.dtype, ref_sc.workload)
    row = runner.run_scenario(sc, runner.RunOptions(device="cpu", repeats=2,
                                                    warmup=0))
    assert row.metrics["check_ok"] is True and row.metrics["max_err"] < TOL


def test_check_sees_a_skipped_kv_tile(monkeypatch):
    """The flash check at its tolerance passes a sound result and fails one
    whose q blocks each skipped their first KV tile."""
    sc = scenario.get_scenario("h100/flash_attention/overlap")
    sc = scenario.Scenario(name="test/flash", kernel="flash_attention",
                           shape=(1, 4, 2, 512, 64), workload=sc.workload)
    args = sc.make_args("cpu", seed=5)
    tol = scenario.CHECK_TOL["flash_attention"]
    plain = flash_attention.flash_attention_plain
    assert scenario.check_output(sc, args, plain(*args)) < TOL
    kv_range = flash_attention.kv_range
    monkeypatch.setattr(flash_attention, "kv_range",
                        lambda *a: (kv_range(*a)[0] + 1, kv_range(*a)[1]))
    assert scenario.check_output(sc, args, plain(*args)) > 10 * tol


# -- the kernel's arithmetic, lane by lane ---------------------------------

#: lane (g, t) = (lane // 4, lane % 4) of an mma.sync m16n8k8 tf32 warp
_LANE = torch.arange(32)
_G, _T = _LANE // 4, _LANE % 4
#: (row, column) of each fragment register as the PTX ISA lays them out, as
#: a flat index into the row-major matrix: A (16 x 8) a0..a3, B (8 x 8,
#: k x n) b0..b1, C/D (16 x 8) c0..c3; each is a bijection
_A_AT = torch.stack([(_G + 8 * (i % 2)) * 8 + _T + 4 * (i // 2)
                     for i in range(4)], -1).reshape(-1)
_B_AT = torch.stack([(_T + 4 * i) * 8 + _G for i in range(2)], -1).reshape(-1)
_C_AT = torch.stack([(_G + 8 * (i // 2)) * 8 + 2 * _T + i % 2
                     for i in range(4)], -1).reshape(-1)


def tf32(x):
    """cvt.rna.tf32.f32 (the kernel's integer add and mask): round to 10
    mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tensor_core(x):
    """What mma.sync's tf32 operand reads of an f32 register: its top 19
    bits (the low 13 ignored: rounded toward zero)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x):
    """x = hi + lo exactly: hi = tf32(x), lo = x - hi in f32 (the kernel's
    ``split``; the tensor core reads lo rounded toward zero)."""
    hi = tf32(x)
    return hi, x - hi


def _matrix(frag, at, rows):
    """Fragments (..., 32, regs) -> the warp's matrix (..., rows, 8)."""
    flat = frag.reshape(*frag.shape[:-2], -1)
    return flat[..., torch.argsort(at)].reshape(*frag.shape[:-2], rows, 8)


def mma(c, a, b):
    """One mma.sync m16n8k8 tf32 on fragments (..., 32, regs): c + a b in
    f32, a and b read as the tensor core reads them."""
    a, b = _tensor_core(a), _tensor_core(b)
    d = _matrix(c, _C_AT, 16) + _matrix(a, _A_AT, 16) @ _matrix(b, _B_AT, 8)
    return d.reshape(*d.shape[:-2], -1)[..., _C_AT].reshape(c.shape)


def mma3(c, a, b, terms=3):
    """c + a b in 3xTF32: lo hi, hi lo, then hi hi (``terms=2``: lo hi and
    hi hi, the bf16 kernel's two products for a b exact in TF32;
    ``terms=1``: hi hi alone, one TF32 product)."""
    (ah, al), (bh, bl) = split(a), split(b)
    if terms == 3:
        c = mma(mma(c, al, bh), ah, bl)
    elif terms == 2:
        c = mma(c, al, bh)
    return mma(c, ah, bh)


def _pair_col(j, ev):
    """The first d column of q pair j at lane t, with ev values a 16-byte
    chunk: 4 ev (j // (ev / 4)) + ev t + 4 (j % (ev / 4)) (16 j + 4 t for
    f32)."""
    return 4 * ev * (j // (ev // 4)) + ev * _T + 4 * (j % (ev // 4))


def mma_replay(q, k, v, *, causal=True, window=0, kc=32, bk=128, terms=3,
               chains=1, ev=4):
    """csrc/flash_attention.cu's arithmetic in plain torch: q (H, S, D),
    k, v (KVH, S, D) f32 (holding bf16 values for the bf16 kernel: ``ev=8``
    values a 16-byte chunk, ``terms=2``) -> (H, S, D).  Per q block of 128
    rows, warp w owns rows 16 w ..; the q tile is stored and read in
    fragment order; each kc-row sub-tile of the pruned KV range runs Q K^T
    (KV row sigma(n) in S column n, d = _pair_col(j) + e in k-steps 2j, 2j
    + 1; with ``chains=2``, DROP_OFF's, the even and odd q pairs into two
    sums added at the end), the softmax on the fragments (quad max,
    per-lane sums) and P V (P's A fragment from S's registers, V rows t and
    t + 4, O column 8 ev c + off(n) + i of n-block ev c + i, off(n) = 4 ev
    (n % 2) + ev (n / 2)).  The n-blocks of one mma step run as one batch:
    they are independent."""
    h, s_len, d = q.shape
    rep, pairs, nb = h // k.shape[0], d // 16, kc // 8
    kf, vf = (x.repeat_interleave(rep, 0)[:, None] for x in (k, v))
    krow = 8 * torch.arange(nb)[:, None] + _G // 2 + 4 * (_G % 2)  # sigma(g)
    off = 4 * ev * (_G % 2) + ev * (_G // 2)
    vcol = (8 * ev * torch.arange(d // (8 * ev))[:, None, None] +
            torch.arange(ev)[:, None] + off).reshape(d // 8, 32)
    qs = q * (1.0 / d ** 0.5)
    out = torch.empty_like(q)
    # the kernel's store of the q tile: row r = 16 w + 8 hh + g, the float4
    # of columns _pair_col(j) .. + 3 at lane t -> ((w * pairs + j) * 2 +
    # hh) * 32 + 4 g + t
    r, c4 = torch.meshgrid(torch.arange(128), torch.arange(d // 4),
                           indexing="ij")
    c = 4 * c4
    j = (c // (4 * ev)) * (ev // 4) + (c % ev) // 4
    at = ((((r // 16) * pairs + j) * 2 + (r // 8) % 2) * 32 +
          4 * (r % 8) + (c % (4 * ev)) // ev).reshape(-1)
    rows = 16 * torch.arange(8)[:, None] + _G            # (w, lane): row g
    for q0 in range(0, s_len, flash_attention.BQ):
        frags = torch.empty(h, 128 * d // 4, 4)
        frags[:, at] = qs[:, q0:q0 + 128].reshape(h, -1, 4)
        frags = frags.reshape(h, 8, pairs, 2, 32, 4)     # (head, w, j, hh, lane)
        m = torch.full((h, 8, 32, 2), flash_attention.NEG_INF)
        l = torch.zeros(h, 8, 32, 2)
        o = torch.zeros(h, 8, d // 8, 32, 4)
        lo, hi = flash_attention.kv_range(q0, s_len, 128, bk, causal, window)
        for kv0 in range(lo * bk, hi * bk, kc):
            kt, vt = kf[:, :, kv0:kv0 + kc], vf[:, :, kv0:kv0 + kc]
            sums = [torch.zeros(h, 8, nb, 32, 4) for _ in range(chains)]
            for j in range(pairs):
                sc = sums[j % chains]
                for e in (0, 2):
                    qa, qb = frags[:, :, j, 0, :, e], frags[:, :, j, 1, :, e]
                    qa1, qb1 = (frags[:, :, j, hh, :, e + 1] for hh in (0, 1))
                    a = torch.stack([qa, qb, qa1, qb1], -1)[:, :, None]
                    col = _pair_col(j, ev) + e
                    b = torch.stack([kt[:, :, krow, col], kt[:, :, krow, col + 1]],
                                    -1)
                    sc = mma3(sc, a, b, terms)
                sums[j % chains] = sc
            sc = sums[0] if chains == 1 else sums[0] + sums[1]
            # s[n][c]: q row g + 8 (c // 2), KV row kv0 + 8 n + t + 4 (c % 2)
            kv = (kv0 + 8 * torch.arange(nb)[:, None, None] + _T[:, None] +
                  4 * torch.arange(2))
            for rr in range(2):
                x = sc[..., 2 * rr:2 * rr + 2]             # (h, w, n, lane, e)
                qi = (q0 + rows + 8 * rr)[:, None, :, None]
                keep = torch.ones(x.shape[1:], dtype=torch.bool)
                if causal:
                    keep &= kv <= qi
                if window > 0:
                    keep &= kv > qi - window
                x = x.masked_fill(~keep, flash_attention.NEG_INF)
                mx = x.amax(dim=(2, 4)).reshape(h, 8, 8, 4).amax(-1)
                mn = torch.maximum(m[..., rr], mx.repeat_interleave(4, -1))
                alpha = torch.exp(m[..., rr] - mn)
                p = torch.exp(x - mn[:, :, None, :, None])
                l[..., rr] = l[..., rr] * alpha + p.sum(dim=(2, 4))
                m[..., rr] = mn
                o[..., 2 * rr:2 * rr + 2] *= alpha[:, :, None, :, None]
                sc[..., 2 * rr:2 * rr + 2] = p
            for n in range(nb):
                a = sc[:, :, n, :, [0, 2, 1, 3]][:, :, None]   # P's A fragment
                b = torch.stack([vt[:, :, 8 * n + _T[None, :], vcol],
                                 vt[:, :, 8 * n + 4 + _T[None, :], vcol]], -1)
                o = mma3(o, a, b, terms)
        q_sum = l + l[:, :, _LANE ^ 1]
        q_sum = q_sum + q_sum[:, :, _LANE ^ 2]
        inv = 1.0 / q_sum.clamp_min(1e-30)                 # (h, w, lane, rr)
        blk = torch.empty(h, 8, 16, d)
        for rr in range(2):
            for e in range(2):
                # accumulator column 2t + e of n-block ev c + i: O column
                # 8 ev c + 4 ev e + ev t + i
                col = vcol - off + 4 * ev * e + ev * _T
                blk[:, :, (_G + 8 * rr)[None, :], col] = \
                    o[..., 2 * rr + e] * inv[:, :, None, :, rr]
        out[:, q0:q0 + 128] = blk.reshape(h, 128, d)
    return out


@functools.lru_cache(maxsize=None)
def _reference(h, kvh, causal, window):
    q, k, v = _qkv((h, 256, 64), (kvh, 256, 64), 7)
    want = ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window, bq=128, bk=128)
    return (q, k, v), np.asarray(want)


@pytest.mark.parametrize("kc", [8, 16, 32])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 96),
                                           (False, 200)])
@pytest.mark.parametrize("h,kvh", [(4, 2), (2, 1)])
def test_mma_replay_matches_reference(kc, causal, window, h, kvh):
    """The kernel's 3xTF32 fragments, KV relabelling and sub-tiled online
    softmax hold the reference's Pallas kernel (interpret mode) to 2e-5, at
    the card's slots (DROP_OFF's 8 rows in two chains, the others' 32) and
    at 16."""
    (q, k, v), want = _reference(h, kvh, causal, window)
    got = mma_replay(*(torch.from_numpy(t) for t in (q, k, v)),
                     causal=causal, window=window, kc=kc,
                     chains=2 if kc == 8 else 1)
    _close(got, want)


@pytest.mark.parametrize("kc", [8, 32])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 96)])
def test_mma_replay_bf16_matches_reference(kc, causal, window):
    """The bf16 kernel's arithmetic (K and V chunks of 8 values, their q
    pairs and O columns relabelled to match, two TF32 products for each
    product) holds the reference's Pallas kernel (interpret mode) on the
    same bf16 arrays to 2e-5."""
    q, k, v = _qkv((4, 256, 64), (2, 256, 64), 9)
    q, k, v = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    want = ref_fa.flash_attention_pallas(q, k, v, causal=causal,
                                         window=window, interpret=True)
    got = mma_replay(*(torch.from_numpy(np.asarray(t, np.float32))
                       for t in (q, k, v)), causal=causal, window=window,
                     kc=kc, chains=2 if kc == 8 else 1, terms=2, ev=8)
    _close(got, want)


def test_bf16_values_split_exactly_into_tf32():
    """Every finite bf16 value is exact in TF32 (8 significand bits of
    11): its split has lo = 0, so the bf16 kernel's two products are the
    three of 3xTF32."""
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16) \
        .view(torch.bfloat16).float()
    x = x[torch.isfinite(x)]
    hi, lo = split(x)
    assert x.numel() == 2 ** 16 - 2 ** 8      # less the infinities and NaNs
    assert torch.equal(hi, x) and not lo.any()
    assert torch.equal(_tensor_core(x), x)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 96)])
@pytest.mark.parametrize("h,kvh", [(4, 2), (8, 1)])
def test_flash_bf16_plain_matches_reference(causal, window, h, kvh):
    """The plain version on bf16 inputs (what the CPU computes and the card's
    bf16 kernel is held to) against the reference's Pallas kernel in
    interpret mode on the same bf16 arrays: f32 out, 2e-5."""
    q, k, v = _qkv((h, 256, 64), (kvh, 256, 64), 10)
    q, k, v = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    want = ref_fa.flash_attention_pallas(q, k, v, causal=causal,
                                         window=window, interpret=True)
    tq, tk, tv = (torch.from_numpy(np.asarray(t, np.float32))
                  .to(torch.bfloat16) for t in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.float32
    _close(got, want)


def test_card_takes_bf16_and_refuses_other_types():
    for strategy in Strategy:
        spec = PipelineSpec(strategy, 4)
        flash_attention.check_card_config(128, torch.bfloat16, spec, 128, 128)
        # each ring slot's K and V rows take 2 of the 4 bytes a value
        f32, bf16 = (flash_attention.flash_smem(spec, 128, t)
                     for t in (torch.float32, torch.bfloat16))
        slot = 2 * flash_attention.kv_tile(strategy) * 128 * 2
        assert (f32 - bf16) % slot == 0 and f32 - bf16 >= slot
    for dtype in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(ValueError, match="built for"):
            flash_attention.check_card_config(128, dtype, PipelineSpec(),
                                              128, 128)


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -11 - 2 ** -23])
    assert tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
                                -(1.0 + 2 ** -10), 1.0]
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    hi, lo = split(x)
    assert torch.equal(tf32(hi), hi) and torch.equal(hi + lo, x)
    assert float((lo / hi).abs().max()) <= 2 ** -11
    assert float(((lo - _tensor_core(lo)) / hi).abs().max()) < 2 ** -21


def test_one_tf32_product_misses_the_tolerance():
    """Why the kernel splits: at s = 1024, d = 128, causal, one TF32
    product (hi hi) misses the reference's 2e-5 against a float64 oracle,
    and the three of 3xTF32 hold it."""
    q, k, v = (torch.from_numpy(t) for t in _qkv((1, 1024, 128),
                                                 (1, 1024, 128), 8))
    want = ref.attention_ref(*(t.double() for t in (q, k, v)), causal=True)
    err = {terms: float((mma_replay(q, k, v, terms=terms).double() - want)
                        .abs().max()) for terms in (1, 3)}
    assert err[3] < TOL < err[1]
    assert err[1] > 10 * TOL


def test_ab_gives_the_base_flash_library_the_whole_block():
    """bench.ab launches another checkout's flash attention library with
    the card's whole block of shared memory (its layout may need more than
    this one's), and every other library with this checkout's budgets."""
    from repro_torch.bench import ab
    from repro_torch.core.async_pipeline import SMEM_PER_BLOCK, PipelineSpec
    spec = PipelineSpec()
    here = flash_attention.flash_smem(spec, 128)
    assert here < SMEM_PER_BLOCK
    with ab._base_budget("flash_attention"):
        assert flash_attention.flash_smem(spec, 128) == SMEM_PER_BLOCK
    assert flash_attention.flash_smem(spec, 128) == here
    with ab._base_budget("matmul"):
        assert flash_attention.flash_smem(spec, 128) == here
