"""The port's flash attention on CPU tensors (its plain torch version: the
reference's tiled online softmax with its KV pruning) against the
reference's Pallas kernel in interpret mode and the oracles, on the same
numpy inputs.

On a CUDA tensor the same wrapper launches csrc/flash_attention.cu; that
kernel is held to the plain version on the card by ``chip_smoke.py``.
Its two designs' arithmetic is replayed here: ``mma_replay`` the f32
design's, lane by lane (its 3xTF32 ``mma.sync`` fragments, relabelled KV
rows and permuted d columns, and its online softmax over kc-row
sub-tiles), and ``wgmma_replay`` the bf16 design's (bf16 products in f32
sums of k16 steps, the scale after Q K^T, the online softmax over kc-row
sub-tiles with each lane's share of the denominator, P split into bf16
terms, smallest first)."""
import functools
import importlib.util
from pathlib import Path

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
from repro_torch.core.async_pipeline import (SMEM_PER_BLOCK,    # noqa: E402
                                             PipelineSpec, Strategy)
from repro_torch.kernels import _build, flash_attention, ops    # noqa: E402
from repro_torch.kernels import ref                             # noqa: E402
from repro_torch.tuning import search_space                     # noqa: E402

STRATEGIES = [s.value for s in RefStrategy]
ROOT = Path(__file__).resolve().parents[1]
#: the reference's tolerance (tests/test_kernels.py::test_flash_attention)
TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: they run many small
    torch ops, which the default pool (a thread a core) slows many times
    over when several test processes share the cores (see
    tests/test_torch_flash_replay.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _chip_smoke_configs():
    """The (strategy, depth, wait_group, out_depth) chip_smoke.py checks."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return tuple(mod.configs())


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
    # the card's ring by type: every spec chip_smoke.py runs fits, through
    # the search space's hooks and the wrapper's
    tdtype = getattr(torch, dtype)
    for st, depth, wg, od in _chip_smoke_configs():
        pspec = PipelineSpec(st, depth, wg, od)
        assert 128 % flash_attention.kv_tile(st, tdtype) == 0
        spec.check_card(shape, dtype, cfg, pspec)
        flash_attention.check_card_config(d, tdtype, pspec, 128, 128)
        assert spec.smem_bytes(shape, dtype, cfg, pspec) == \
            flash_attention.flash_smem(pspec, d, tdtype) <= SMEM_PER_BLOCK
    q, k, v = spec.make_args((2, 4, 2, 128, 64), dtype,
                             torch.Generator().manual_seed(0), "cpu")
    assert tuple(q.shape) == (2, 4, 128, 64)
    assert tuple(k.shape) == tuple(v.shape) == (2, 2, 128, 64)
    assert q.dtype == getattr(torch, dtype) and abs(float(q.float().mean())) < 0.1


def test_ring_terms_by_type():
    """The f32 ring keeps its 32-row slots (8 for DROP_OFF) of rows padded
    by 16 bytes; the bf16 ring takes 64-row slots (16 for DROP_OFF) of
    unpadded rows on 1,024 bytes; a bf16 ring past the block raises
    ValueError naming the budget."""
    for st in Strategy:
        assert flash_attention.kv_tile(st) == \
            flash_attention.kv_tile(st, torch.float32) == \
            (8 if st is Strategy.DROP_OFF else 32)
        assert flash_attention.kv_tile(st, torch.bfloat16) == \
            (16 if st is Strategy.DROP_OFF else 64)
    f32 = {(st, depth, d): flash_attention.flash_smem(PipelineSpec(st, depth),
                                                      d)
           for st in Strategy for depth in (2, 4) for d in (64, 128)}
    assert f32[(Strategy.OVERLAP, 4, 128)] == 4 * 2 * 32 * (512 + 16) + \
        128 * 128 * 4 == 200_704
    assert f32[(Strategy.TMA, 4, 128)] == 200_736
    assert f32[(Strategy.DROP_OFF, 2, 64)] == 2 * 2 * 8 * (256 + 16) + \
        128 * 64 * 4 == 41_472
    assert f32[(Strategy.SYNC, 2, 128)] == 99_328
    bf16 = functools.partial(flash_attention.flash_smem, d=128,
                             dtype=torch.bfloat16)
    assert bf16(PipelineSpec(Strategy.OVERLAP, 4)) == 1024 + 4 * 32_768 + \
        32_768 == 164_864
    assert bf16(PipelineSpec(Strategy.TMA, 4)) == 1024 + 132_096 + 32_768
    assert bf16(PipelineSpec(Strategy.DROP_OFF, 4)) == 1024 + 4 * 8192 + \
        32_768
    deep = PipelineSpec(Strategy.OVERLAP, 7)
    assert bf16(deep) > SMEM_PER_BLOCK
    with pytest.raises(ValueError, match=f"{bf16(deep)} bytes of shared "
                                         f"memory > {SMEM_PER_BLOCK}"):
        flash_attention.check_card_config(128, torch.bfloat16, deep, 128,
                                          128)
    with pytest.raises(ValueError, match="KV sub-tile 64"):
        flash_attention.check_card_config(128, torch.bfloat16,
                                          PipelineSpec(), 128, 32)
    flash_attention.check_card_config(128, torch.float32, PipelineSpec(),
                                      128, 32)


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
               chains=1, ev=4, kv_len=None):
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
    they are independent.  ``kv_len``: the key count, the KV range cut to
    it and the keys at it and past masked, as the kernel does."""
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
        lo, hi = flash_attention.kv_range(q0, s_len, 128, bk, causal, window,
                                          kv_len)
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
                if kv_len is not None:
                    keep &= kv < kv_len
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


#: bf16 terms of each f32 P value in the bf16 design (kPTerms)
P_TERMS = 3
#: log2(e), which the bf16 design folds into the softmax scale (kLog2e)
LOG2E = 1.44269504088896340736


def bf16_terms(p, terms=P_TERMS):
    """The kernel's ``bf16_terms``: p = t_0 + t_1 + ..., t_0 = bf16(p)
    rounded to nearest, each next term the bf16 of the (exact) f32
    remainder; largest first."""
    out = []
    for _ in range(terms):
        t = p.to(torch.bfloat16).float()
        out.append(t)
        p = p - t
    return out


def wgmma_replay(q, k, v, *, causal=True, window=0, kc=64, bk=128,
                 terms=P_TERMS, chains=1, kv_len=None):
    """csrc/flash_attention.cu's bf16 arithmetic in plain torch: q (H, S,
    D), k, v (KVH, S, D) f32 holding bf16 values -> (H, S, D).  Per q block
    of 128 rows, each kc-row sub-tile of the pruned KV range runs Q K^T as
    D / 16 bf16 products of k16 steps, each summed in f32 and added to the
    f32 logits (``chains=2``, DROP_OFF's: the even and odd steps into two
    sums added at the end), scales the logits after the product by the
    scale times log2(e) in f32, masks and runs the online softmax on exp2
    (each lane t's share of the denominator is the
    columns 8 n + 2 t + e, summed over the quad at the end as (l0 + l1) +
    (l2 + l3)), rescales O and adds P V: P split into ``terms`` bf16 terms,
    at each k16 step of KV rows the smallest term's product first, each an
    f32 sum added to O.  The output is O times 1 / max(l, 1e-30).
    ``kv_len``: the key count, as the kernel takes it."""
    h, s_len, d = q.shape
    rep = h // k.shape[0]
    kf, vf = (x.repeat_interleave(rep, 0) for x in (k, v))
    scale2 = torch.tensor(1.0 / d ** 0.5, dtype=torch.float32) * \
        torch.tensor(LOG2E, dtype=torch.float32)
    neg = torch.tensor(flash_attention.NEG_INF, dtype=torch.float32)
    out = torch.empty_like(q)
    rows = torch.arange(128)[:, None]
    for q0 in range(0, s_len, flash_attention.BQ):
        qb = q[:, q0:q0 + 128]
        m = torch.full((h, 128, 1), flash_attention.NEG_INF)
        l = torch.zeros(h, 128, 4)                      # each lane t's share
        o = torch.zeros(h, 128, d)
        lo, hi = flash_attention.kv_range(q0, s_len, 128, bk, causal, window,
                                          kv_len)
        for kv0 in range(lo * bk, hi * bk, kc):
            kt, vt = kf[:, kv0:kv0 + kc], vf[:, kv0:kv0 + kc]
            sums = [torch.zeros(h, 128, kc) for _ in range(chains)]
            for ks in range(d // 16):
                c = slice(16 * ks, 16 * ks + 16)
                sums[ks % chains] = sums[ks % chains] + \
                    qb[..., c] @ kt[..., c].transpose(-1, -2)
            x = (sums[0] if chains == 1 else sums[0] + sums[1]) * scale2
            qi, kv = q0 + rows, kv0 + torch.arange(kc)[None, :]
            keep = torch.ones(128, kc, dtype=torch.bool)
            if causal:
                keep &= kv <= qi
            if window > 0:
                keep &= kv > qi - window
            if kv_len is not None:
                keep &= kv < kv_len
            x = torch.where(keep, x, neg)
            mn = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp2(m - mn)
            p = torch.exp2(x - mn)
            l = l * alpha + p.reshape(h, 128, kc // 8, 4, 2).sum(dim=(2, 4))
            m = mn
            o = o * alpha
            parts = bf16_terms(p, terms)
            for ks in range(kc // 16):
                c = slice(16 * ks, 16 * ks + 16)
                for part in reversed(parts):
                    o = o + part[..., c] @ vt[:, c]
        total = (l[..., 0] + l[..., 1]) + (l[..., 2] + l[..., 3])
        out[:, q0:q0 + 128] = o * (1.0 / total.clamp_min(1e-30))[..., None]
    return out


@functools.lru_cache(maxsize=None)
def _bf16_reference(h, kvh, causal, window, seed=9):
    """bf16 q, k, v (their values in f32) and the reference's Pallas kernel
    on them in interpret mode."""
    q, k, v = _qkv((h, 256, 64), (kvh, 256, 64), seed)
    q, k, v = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    want = ref_fa.flash_attention_pallas(q, k, v, causal=causal,
                                         window=window, interpret=True)
    return (tuple(np.asarray(t, np.float32) for t in (q, k, v)),
            np.asarray(want))


@pytest.mark.parametrize("kc", [16, 64])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 96)])
def test_mma_replay_bf16_matches_reference(kc, causal, window):
    """The bf16 kernel's arithmetic (bf16 wgmma products, P in three bf16
    terms; DROP_OFF's 16-row slots in two chains, the others' 64) holds
    the reference's Pallas kernel (interpret mode) on the same bf16 arrays
    to 2e-5."""
    (q, k, v), want = _bf16_reference(4, 2, causal, window)
    got = wgmma_replay(*(torch.from_numpy(t) for t in (q, k, v)),
                       causal=causal, window=window, kc=kc,
                       chains=2 if kc == 16 else 1)
    _close(got, want)


@pytest.mark.parametrize("kc", [16, 64])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 96),
                                           (False, 200)])
@pytest.mark.parametrize("h,kvh", [(4, 2), (2, 1)])
def test_wgmma_replay_matches_reference(kc, causal, window, h, kvh):
    """The bf16 design over the f32 replay's grid (both slots, causal,
    full, windowed and non-causal windowed masks, both GQA shapes) holds
    the reference's Pallas kernel in interpret mode on bf16 inputs to 2e-5,
    and to half of it."""
    (q, k, v), want = _bf16_reference(h, kvh, causal, window)
    got = wgmma_replay(*(torch.from_numpy(t) for t in (q, k, v)),
                       causal=causal, window=window, kc=kc,
                       chains=2 if kc == 16 else 1)
    _close(got, want)
    assert float((got - torch.from_numpy(want.copy())).abs().max()) <= TOL / 2


def test_bf16_terms_sum_to_p_exactly():
    """Three bf16 terms of an f32 probability sum back to it exactly (8 of
    p's 24 significand bits a term, the remainders exact in f32), two keep
    it to 2^-16 of p, one to 2^-8."""
    p = torch.rand(1 << 16, generator=torch.Generator().manual_seed(0))
    p = torch.cat([p, torch.exp(-40 * p), torch.tensor([0.0, 1.0])])
    for terms, bound in ((1, 2 ** -8), (2, 2 ** -16), (3, 0.0)):
        parts = bf16_terms(p, terms)
        assert all(torch.equal(t.bfloat16().float(), t) for t in parts)
        total = parts[0]
        for t in parts[1:]:
            total = total + t
        assert float(((total.double() - p.double()).abs() /
                      p.double().clamp_min(1e-38)).max()) <= bound


def test_bf16_values_split_exactly_into_tf32():
    """Every finite bf16 value is exact in TF32 (8 significand bits of
    11): its split has lo = 0, so on bf16 inputs the f32 design's 3xTF32
    keeps two products (``mma_replay(terms=2, ev=8)``, the bf16 kernel
    before its wgmma design)."""
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
        # the bf16 ring: K and V slots of kv_tile rows, 2 bytes a value and
        # no row pad, on 1,024 bytes, then the bf16 q tile on 1,024 bytes
        f32, bf16 = (flash_attention.flash_smem(spec, 128, t)
                     for t in (torch.float32, torch.bfloat16))
        slot = 2 * flash_attention.kv_tile(strategy, torch.bfloat16) * 128 * 2
        ring = spec.ring_depth * slot + \
            (8 * spec.ring_depth if strategy is Strategy.TMA else 0)
        assert bf16 == 1024 + -(-ring // 1024) * 1024 + 128 * 128 * 2
        assert bf16 < f32
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


def test_bf16_products_against_float64(capsys):
    """Why the bf16 kernel splits P in three: at s = 1024, d = 128, causal,
    on bf16 inputs, against a float64 oracle, one bf16 term of P misses
    the reference's 2e-5, two and three hold it within half of it (three
    within a tenth, beside the f32 plain version's own error), as does the
    f32 design's two-TF32 arithmetic that the bf16 kernel ran before."""
    q, k, v = (torch.from_numpy(t).bfloat16().float()
               for t in _qkv((1, 1024, 128), (1, 1024, 128), 8))
    want = ref.attention_ref(*(t.double() for t in (q, k, v)), causal=True)

    def err(got):
        return float((got.double() - want).abs().max())

    errs = {t: err(wgmma_replay(q, k, v, terms=t)) for t in (1, 2, 3)}
    drop_off = err(wgmma_replay(q, k, v, kc=16, chains=2))
    two_tf32 = err(mma_replay(q, k, v, terms=2, ev=8))
    plain = err(flash_attention.flash_attention_plain(q, k, v))
    with capsys.disabled():
        print(f"\nbf16 flash against float64 (s=1024, d=128, causal): "
              f"wgmma terms 1 {errs[1]:.3g}, 2 {errs[2]:.3g}, 3 {errs[3]:.3g}"
              f" (DROP_OFF's mma.sync {drop_off:.3g}); two TF32 products "
              f"{two_tf32:.3g}; f32 plain {plain:.3g}")
    assert errs[1] > 10 * TOL
    assert errs[3] <= errs[2] <= TOL / 2
    assert max(errs[P_TERMS], drop_off) <= TOL / 10
    assert two_tf32 <= TOL / 10 and plain <= TOL / 10


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


# -- the key count: S padded up to the kernel's rows, the padded keys masked

#: (s, the padded length, kv_len) of the key-count cases: whisper's prefill
#: width 448 and cohort widths 300 and 97 of phase 8's trace, padded up to
#: 128-row blocks, and one key
KV_LEN_CASES = [(300, 384, 300), (97, 128, 97), (448, 512, 448),
                (1, 128, 1)]


def _padded(s, s_pad, seed, h=4, kvh=2, d=64):
    """q, k, v of s rows and their copies padded to s_pad rows with
    noise (so that a key the mask misses moves the result)."""
    q, k, v = _qkv((h, s_pad, d), (kvh, s_pad, d), seed)
    return (q[:, :s], k[:, :s], v[:, :s]), (q, k, v)


@pytest.mark.parametrize("s,s_pad,kv_len", KV_LEN_CASES)
@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0), (True, 96),
                                           (False, 200)])
def test_plain_kv_len_equals_the_unpadded_call(s, s_pad, kv_len, causal,
                                               window):
    """On inputs padded with noise past kv_len = s, the plain version's
    real rows are the dense oracle's over the s unpadded rows (the port's
    and the reference's)."""
    (q, k, v), padded = _padded(s, s_pad, 21)
    got = flash_attention.flash_attention_plain(
        *(torch.from_numpy(t) for t in padded), causal=causal, window=window,
        kv_len=kv_len)[:, :s]
    want = ref_ref.attention_ref(*(jnp.asarray(np.repeat(t, 4 // t.shape[0],
                                                         axis=0))
                                   for t in (q, k, v)),
                                 causal=causal, window=window)
    _close(got, want)
    _close(got, ref.attention_ref(*(torch.from_numpy(t).repeat_interleave(
        4 // t.shape[0], 0) for t in (q, k, v)), causal=causal,
        window=window))
    if not causal:
        bare = flash_attention.flash_attention_plain(
            *(torch.from_numpy(t) for t in padded), causal=causal,
            window=window)[:, :s]
        assert float((bare - got).abs().max()) > 10 * TOL


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 96),
                                           (False, 200)])
def test_kv_len_of_s_is_bit_identical(causal, window):
    """kv_len = S is the call without a key count, bit for bit (the plain
    version, and the tiles the kernel reads)."""
    q, k, v = (torch.from_numpy(t) for t in _qkv((4, 384, 64),
                                                  (2, 384, 64), 22))
    plain = flash_attention.flash_attention_plain
    assert torch.equal(plain(q, k, v, causal=causal, window=window,
                             kv_len=384),
                       plain(q, k, v, causal=causal, window=window))
    for q0 in range(0, 384, 128):
        assert flash_attention.kv_range(q0, 384, 128, 128, causal, window,
                                        384) == \
            flash_attention.kv_range(q0, 384, 128, 128, causal, window)


def test_kv_range_with_kv_len_prunes_exactly_the_masked_tiles():
    """With a key count, hi is cut to the last tile that holds a key the
    causal and window masks and kv_len let through, lo stays the
    reference's (a window may leave its first tiles wholly masked, as
    without a key count), and [lo, hi) holds every such tile."""
    s, bq = 1024, 128
    for bk in (64, 128):
        for causal, window in ((True, 0), (False, 0), (True, 200),
                               (False, 300)):
            for kv_len in (1, 100, 129, 700, 1024):
                for q0 in range(0, s, bq):
                    lo, hi = flash_attention.kv_range(q0, s, bq, bk, causal,
                                                      window, kv_len)
                    qi = np.arange(q0, q0 + bq)[:, None]
                    kv = np.arange(s)[None, :]
                    keep = np.broadcast_to(kv < kv_len, (bq, s))
                    if causal:
                        keep = keep & (kv <= qi)
                    if window > 0:
                        keep = keep & (kv > qi - window)
                    tiles = np.flatnonzero(keep.reshape(bq, s // bk, bk)
                                           .any(axis=(0, 2)))
                    lo0, hi0 = flash_attention.kv_range(q0, s, bq, bk,
                                                        causal, window)
                    assert (lo, hi) == (lo0, max(min(hi0, -(-kv_len // bk)),
                                                 lo0))
                    if tiles.size:
                        assert lo <= tiles.min() and hi == tiles.max() + 1


@pytest.mark.parametrize("kv_len", [0, -1, 257])
def test_kv_len_out_of_range_raises(kv_len):
    """kv_len outside [1, S] raises ValueError before any launch: the plain
    version, ops, and the card's wrapper on a tensor it would launch on."""
    q = torch.zeros(2, 256, 64)
    flash_attention.LAUNCHES = 0
    for call in (
            lambda: flash_attention.flash_attention_plain(q, q, q,
                                                          kv_len=kv_len),
            lambda: ops.flash_attention(q, q, q, kv_len=kv_len),
            lambda: flash_attention.flash_attention_cuda(
                *(torch.zeros(2, 256, 64, device="meta"),) * 3,
                kv_len=kv_len)):
        with pytest.raises(ValueError, match="kv_len"):
            call()
    assert flash_attention.LAUNCHES == 0


@pytest.mark.parametrize("kc", [8, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0),
                                           (False, 200)])
def test_mma_replay_with_kv_len_matches_the_unpadded_oracle(kc, dtype,
                                                            causal, window):
    """The kernel's arithmetic with a key count (its tiles cut to kv_len,
    the keys at it and past masked) on S = 300 padded to 384 with noise:
    the real rows are the reference's dense oracle over the 300 rows.
    float32 replays the mma.sync design at kc, bfloat16 the wgmma design
    at its slot of the same strategy (DROP_OFF 16, the others 64)."""
    (q, k, v), padded = _padded(300, 384, 23)
    if dtype == "bfloat16":
        q, k, v = (np.asarray(jnp.asarray(t, jnp.bfloat16), np.float32)
                   for t in (q, k, v))
        padded = tuple(np.asarray(jnp.asarray(t, jnp.bfloat16), np.float32)
                       for t in padded)
    args = tuple(torch.from_numpy(t) for t in padded)
    if dtype == "bfloat16":
        # the bf16 design's slot at the same strategy (DROP_OFF 16, else 64)
        got = wgmma_replay(*args, causal=causal, window=window, kc=2 * kc,
                           chains=2 if kc == 8 else 1, kv_len=300)
    else:
        got = mma_replay(*args, causal=causal, window=window, kc=kc,
                         chains=2 if kc == 8 else 1, kv_len=300)
    want = ref_ref.attention_ref(*(jnp.asarray(np.repeat(t, 2, axis=0))
                                   if t.shape[0] == 2 else jnp.asarray(t)
                                   for t in (q, k, v)),
                                 causal=causal, window=window)
    _close(got[:, :300], want)


@pytest.mark.parametrize("s", [300, 97])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 2e-2)])
def test_attend_chunked_flash_non_causal_ragged_matches_reference(s, dtype,
                                                                  tol):
    """attend_chunked(impl="flash") non-causal at a length that is no
    multiple of 128 (S padded up, kv_len = S): impl="chunked" and the
    reference's attend_chunked, at the tolerances of
    tests/test_torch_models.py (2e-5 in fp32, 2e-2 in bf16)."""
    from repro.models import attention as ref_attn
    from repro_torch.models import attention as attn
    rng = np.random.default_rng(24)
    q, k, v = (rng.normal(size=(2, s, n, 32)).astype(np.float32)
               for n in (6, 2, 2))
    idx = attn.kv_index_map(6, 2, 6)
    want = ref_attn.attend_chunked(*(jnp.asarray(t, dtype) for t in (q, k, v)),
                                   idx, causal=False, window=0, chunk=64)
    tq, tk, tv = (torch.from_numpy(t).to(getattr(torch, dtype))
                  for t in (q, k, v))
    got = attn.attend_chunked(tq, tk, tv, idx, causal=False, window=0,
                              chunk=64, impl="flash")
    chunked = attn.attend_chunked(tq, tk, tv, idx, causal=False, window=0,
                                  chunk=64, impl="chunked")
    assert got.shape == tq.shape and got.dtype == tq.dtype
    for other in (want, chunked):
        np.testing.assert_allclose(np.asarray(got.float()),
                                   np.asarray(jnp.asarray(other, jnp.float32)
                                              if not isinstance(
                                                  other, torch.Tensor)
                                              else other.float()),
                                   rtol=tol, atol=tol)


def test_ab_runs_the_base_flash_through_its_own_wrapper():
    """bench.ab times another checkout's flash attention through that
    checkout's own wrapper (its launchers' arguments may differ: the key
    count came in after), in f32 and bf16 at the h100 cell's shape."""
    from repro_torch.bench import ab
    assert "flash_attention" in ab.OWN_WRAPPER
    cases = [c for lib, c, _ in ab.CASES if lib == "flash_attention"]
    assert cases == ["flash_attention f32 (4, 12, 2, 4096, 128) causal",
                     "flash_attention bf16 (4, 12, 2, 4096, 128) causal"]
