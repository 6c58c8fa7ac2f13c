"""The port's matmul on CPU tensors (its plain torch version) against the
reference's Pallas kernel in interpret mode and its jnp oracle, on the same
numpy inputs.

On a CUDA tensor the same wrapper launches csrc/matmul.cu; that kernel is
held to the plain version on the card by ``chip_smoke.py``."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                         # noqa: E402

from repro.bench import scenario as ref_scenario                # noqa: E402
from repro.core import Strategy as RefStrategy                  # noqa: E402
from repro.kernels import ops as ref_ops                        # noqa: E402
from repro.kernels import ref as ref_ref                        # noqa: E402
from repro.tuning import search_space as ref_space              # noqa: E402
from repro_torch.bench import runner, scenario                  # noqa: E402
from repro_torch.bench.scenario import args_from_numpy          # noqa: E402
from repro_torch.core.async_pipeline import (                   # noqa: E402
    SMEM_PER_BLOCK, PipelineSpec, Strategy, smem_budget)
from repro_torch.kernels import (_build, flash_attention,       # noqa: E402
                                 matmul, ops, ref)
from repro_torch.tuning import search_space                     # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
STRATEGIES = [s.value for s in RefStrategy]
#: the reference's tolerances (tests/test_kernels.py::test_matmul): rtol
#: tol, atol 10 tol
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _chip_smoke_configs():
    """The (strategy, depth, wait_group, out_depth) chip_smoke.py checks."""
    return _chip_smoke().configs()


def _operands(m, k, n, dtype, seed):
    rng = np.random.default_rng(seed)
    a = jnp.asarray(rng.normal(size=(m, k)).astype(np.float32)).astype(dtype)
    b = jnp.asarray(rng.normal(size=(k, n)).astype(np.float32)).astype(dtype)
    return a, b


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("m,k,n", [(128, 256, 128), (256, 128, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_reference(strategy, m, k, n, dtype):
    a, b = _operands(m, k, n, dtype, 0)
    want = ref_ops.matmul(a, b, strategy=strategy, depth=3)
    ta, tb = args_from_numpy("matmul", [np.asarray(a), np.asarray(b)], "cpu")
    assert ta.dtype == tb.dtype == getattr(torch, dtype)
    got = ops.matmul(ta, tb, strategy=strategy, depth=3)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=10 * tol)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_ref.matmul_ref(a, b)),
                               rtol=tol, atol=10 * tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_ref_matches_reference_oracle(dtype):
    a, b = _operands(64, 96, 32, dtype, 1)
    ta, tb = args_from_numpy("matmul", [np.asarray(a), np.asarray(b)], "cpu")
    np.testing.assert_allclose(ref.matmul_ref(ta, tb).numpy(),
                               np.asarray(ref_ref.matmul_ref(a, b)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bk", [32, 128, 256])
def test_plain_k_tiles_sum_to_the_product(bk):
    a, b = (torch.from_numpy(np.random.default_rng(2).normal(size=s)
                             .astype(np.float32)) for s in ((64, 256), (256, 32)))
    torch.testing.assert_close(matmul.matmul_plain(a, b, bk=bk), a @ b,
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m,k,n", [(100, 128, 128), (128, 100, 128),
                                   (128, 128, 100)])
def test_non_divisible_shapes_raise_value_error(m, k, n):
    a, b = _operands(m, k, n, "float32", 3)
    with pytest.raises(ValueError, match="not divisible"):
        ref_ops.matmul(a, b)
    ta, tb = args_from_numpy("matmul", [np.asarray(a), np.asarray(b)], "cpu")
    with pytest.raises(ValueError, match="not divisible"):
        ops.matmul(ta, tb)


@pytest.mark.parametrize("call", [
    lambda: ops.matmul(torch.zeros(128, 64), torch.zeros(128, 128)),
    lambda: ops.matmul(torch.zeros(128), torch.zeros(128, 128)),
    lambda: matmul.matmul_cuda(torch.zeros(128, 128, device="meta"),
                               torch.zeros(128, 128, device="meta"))])
def test_invalid_calls_raise_value_error(call):
    with pytest.raises(ValueError):
        call()


def test_installed_bk_falls_back_to_seed():
    a, b = torch.rand(128, 384), torch.rand(384, 128)
    try:
        ops.set_default_config("matmul", bk=256)        # 384 % 256 != 0
        got = ops.matmul(a, b)
    finally:
        ops.reset_default_configs()
    torch.testing.assert_close(got, a @ b, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError):                     # explicit: no retry
        ops.matmul(a, b, bk=256)


@pytest.mark.parametrize("shape", [(256, 256, 256), (8192, 1536, 8960)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_spec_matches_reference(shape, dtype):
    spec, want = search_space.SPECS["matmul"], ref_space.SPECS["matmul"]
    for cfg in (ops.default_config("matmul"), dict(bm=256, bk=128, bn=256)):
        assert spec.flops_bytes(shape, dtype, cfg) == \
            pytest.approx(want.flops_bytes(shape, dtype, cfg))
        assert spec.n_tiles(shape, cfg) == want.n_tiles(shape, cfg)
    a, b = spec.make_args((64, 32, 128), dtype,
                          torch.Generator().manual_seed(0), "cpu")
    assert (tuple(a.shape), tuple(b.shape)) == ((64, 32), (32, 128))
    assert a.dtype == b.dtype == getattr(torch, dtype)
    assert float(a.min()) >= 0 and float(a.max()) <= 1


def test_h100_cell_work():
    """h100/matmul: 225.5 GFLOP on 346.3 MB of A, B and C."""
    sc = scenario.get_scenario("h100/matmul/overlap")
    m, k, n = sc.shape
    assert (sc.dtype, 2 * m * k * n) == ("bfloat16", 225_485_783_040)
    assert (m * k + k * n) * 2 + m * n * 4 == 346_292_224


def test_smem_fits_every_checked_spec():
    """Every spec chip_smoke.py checks fits a block at the card's K
    sub-tiles, at the seed blocks; the reference's 128-row K tile would
    not fit a ring of depth 2 (f32) or 4 (bf16)."""
    configs = _chip_smoke_configs()
    assert len(configs) == 27
    for s, depth, wg, od in configs:
        spec = PipelineSpec(s, depth, wg, od)
        for dtype in (torch.float32, torch.bfloat16):
            assert 128 % matmul.k_tile(dtype, s) == 0
            assert 0 < matmul.matmul_smem(spec, dtype) <= SMEM_PER_BLOCK
        for d in flash_attention.CARD_D:
            assert 128 % flash_attention.kv_tile(s) == 0
            assert 0 < flash_attention.flash_smem(spec, d) <= SMEM_PER_BLOCK
    deep = PipelineSpec(Strategy.OVERLAP, 4)
    assert smem_budget(PipelineSpec(Strategy.OVERLAP, 2),
                       [128 * 128 * 4] * 2, 0).card > SMEM_PER_BLOCK
    assert smem_budget(deep, [128 * 128 * 2] * 2, 0).card > SMEM_PER_BLOCK
    assert matmul.matmul_smem(deep, torch.float32) == 4 * (
        128 * (32 * 4 + 16) + 32 * (256 * 4 + 16))


def test_cpu_calls_launch_nothing_and_build_nothing():
    matmul.LAUNCHES.update(float32=0, bfloat16=0)
    ops.matmul(torch.rand(128, 128), torch.rand(128, 256))
    ops.matmul(torch.rand(128, 128).bfloat16(), torch.rand(128, 128).bfloat16())
    assert matmul.LAUNCHES == {"float32": 0, "bfloat16": 0}
    assert _build._libs == {}


def test_smoke_cell_checks_ok_on_cpu():
    sc = scenario.get_scenario("smoke/matmul")
    ref_sc = ref_scenario.get_scenario("smoke/matmul")
    assert (sc.kernel, sc.shape, sc.dtype, sc.workload) == \
        (ref_sc.kernel, ref_sc.shape, ref_sc.dtype, ref_sc.workload)
    row = runner.run_scenario(sc, runner.RunOptions(device="cpu", repeats=2,
                                                    warmup=0))
    assert row.metrics["check_ok"] is True and row.metrics["max_err"] < 1e-4


def test_check_sees_a_skipped_k_tile():
    """The matmul check at its tolerance passes a sound product and fails
    one whose first K tile of 128 rows was skipped."""
    sc = scenario.get_scenario("smoke/matmul")
    a, b = sc.make_args("cpu", seed=4)
    tol = scenario.CHECK_TOL["matmul"]
    assert scenario.check_output(sc, (a, b), matmul.matmul_plain(a, b)) < tol
    skipped = matmul.matmul_plain(a[:, 128:], b[128:])
    assert scenario.check_output(sc, (a, b), skipped) > 100 * tol


# -- the f32 kernel's tiles and launches (csrc/matmul.cu, MatmulF32Body) ------

@pytest.mark.parametrize("strategy", list(Strategy))
@pytest.mark.parametrize("depth", [2, 3, 4])
def test_f32_smem_is_the_kernel_layout(strategy, depth):
    """matmul_smem(f32) is mm_f32_smem at the strategy's widest tile: A
    (128 rows of kc floats) and B (kc rows of 256 floats; DROP_OFF 4-row
    slots of 128) a slot, every row padded by 16 bytes for the copies;
    under TMA dense boxes, A's rows 128 bytes (the swizzle's) and every
    slot on 1024 bytes after 1024 for the ring base; then TMA's
    mbarriers."""
    spec = PipelineSpec(strategy, depth)
    drop_off, tma = strategy is Strategy.DROP_OFF, strategy is Strategy.TMA
    kc, width = (4, 128) if drop_off else (32, 256)
    pad = 0 if tma else 16
    a_tile, b_tile = matmul.f32_tiles(strategy)
    assert (a_tile, b_tile) == (128 * (kc * 4 + pad), kc * (width * 4 + pad))
    assert matmul.f32_tile_width(strategy) == width
    if tma:
        assert kc * 4 == 128
        assert a_tile % 1024 == 0 and (a_tile + b_tile) % 1024 == 0
    slots = 1 if strategy is Strategy.SYNC else spec.ring_depth
    need = (1024 if tma else 0) + slots * (a_tile + b_tile) + \
        (8 * spec.ring_depth if tma else 0)
    assert matmul.matmul_smem(spec, torch.float32) == need <= SMEM_PER_BLOCK


@pytest.mark.parametrize("strategy", list(Strategy))
@pytest.mark.parametrize("n", [128, 256, 384, 1152, 8960])
def test_f32_launch_plan(strategy, n):
    """256-wide tiles, then one 128-column strip when n % 256 == 128;
    DROP_OFF 128-wide tiles in one launch.  The launches cover the columns
    once, in order."""
    plan = matmul.f32_launch_plan(n, strategy)
    if strategy is Strategy.DROP_OFF:
        assert plan == [(0, n, 128)]
    else:
        wide = n // 256 * 256
        assert plan == [(0, wide, 256)] * (wide > 0) + \
            [(wide, 128, 128)] * (n % 256 == 128)
    assert [c0 for c0, _, _ in plan] == \
        list(np.cumsum([0] + [cols for _, cols, _ in plan])[:-1])
    assert sum(cols for _, cols, _ in plan) == n
    assert all(cols % width == 0 for _, cols, width in plan)
    assert matmul.launches(torch.float32, strategy, n) == len(plan)
    assert matmul.launches(torch.bfloat16, strategy, n) == 1


@pytest.mark.parametrize("strategy", list(Strategy))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_launches_counts_the_plan(strategy, dtype, monkeypatch):
    """matmul_cuda adds one call's launches to LAUNCHES once the C launcher
    returns success: at N = 384 two f32 launches but DROP_OFF's one, one
    bf16 launch.  A stand-in library takes the launch."""
    calls = []

    class Lib:
        def matmul_launch(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(matmul, "LAUNCHES", {"float32": 0, "bfloat16": 0})
    monkeypatch.setattr(matmul, "_check", lambda *args: True)
    monkeypatch.setattr(_build, "library", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    dt = getattr(torch, dtype)
    matmul.matmul_cuda(torch.zeros(256, 128, dtype=dt),
                       torch.zeros(128, 384, dtype=dt),
                       spec=PipelineSpec(strategy))
    two = dtype == "float32" and strategy is not Strategy.DROP_OFF
    assert len(calls) == 1
    assert matmul.LAUNCHES == {"float32": 2 if two else int(dtype == "float32"),
                               "bfloat16": int(dtype == "bfloat16")}


# -- the bf16 kernel's wgmma geometry (csrc/matmul.cu, MatmulBf16Body) --------

#: the descriptors MatmulBf16Body builds: A K-major, a k16 step 32 bytes
#: on; B N-major, its halves LBO apart, a k16 step 16 rows on; 8-row groups
#: SBO apart in both
A_STEP, B_STEP, B_LBO, SBO = 32, 16 * 128, 8192, 1024


@pytest.mark.parametrize("strategy", list(Strategy))
def test_bf16_k_tile_is_64_at_every_strategy(strategy):
    """One 128-byte swizzled row of bf16 a slot row, DROP_OFF included;
    f32 keeps its 32-row (DROP_OFF 4-row) sub-tiles."""
    assert matmul.k_tile(torch.bfloat16, strategy) == 64
    assert matmul.k_tile(torch.float32, strategy) == \
        (4 if strategy is Strategy.DROP_OFF else 32)


@pytest.mark.parametrize("strategy", list(Strategy))
@pytest.mark.parametrize("depth", [2, 3, 4])
def test_bf16_smem_is_the_kernel_layout(strategy, depth):
    """matmul_smem(bf16) is MatmulBf16Launch's need: 1024 bytes for the
    ring base's rounding, ring slots of 32 KB whose three tiles start on
    1024 bytes, then TMA's mbarriers."""
    spec = PipelineSpec(strategy, depth)
    tiles = matmul.bf16_tiles()
    assert tiles == (16384, 8192, 8192)
    assert all(off % 1024 == 0 for off in np.cumsum((0,) + tiles))
    slots = 1 if strategy is Strategy.SYNC else spec.ring_depth
    barriers = 8 * spec.ring_depth if strategy is Strategy.TMA else 0
    assert matmul.matmul_smem(spec, torch.bfloat16) == \
        matmul.RING_ALIGN + slots * sum(tiles) + barriers
    assert matmul.RING_ALIGN == 1024


def test_bf16_depth_3_leaves_room_for_two_blocks():
    """A slot is 32 KB: depth 3 takes 96 KB and two blocks share an SM's
    228 KB; depth 4 takes 128 KB."""
    for s in (Strategy.OVERLAP, Strategy.DROP_OFF, Strategy.TMA):
        assert 2 * matmul.matmul_smem(PipelineSpec(s, 3), torch.bfloat16) \
            <= 228 * 1024
        assert matmul.matmul_smem(PipelineSpec(s, 4), torch.bfloat16) \
            > 128 * 1024


@pytest.mark.parametrize("strategy", list(Strategy))
def test_card_config_value_errors(strategy):
    """The card's bf16 kernel takes bk in multiples of 64 at every
    strategy (DROP_OFF took 32 before it ran on wgmma); f32 keeps bk 32;
    a ring of 8 bf16 slots, blocks of 256 and float16 raise."""
    spec = PipelineSpec(strategy, 2)
    matmul.check_card_config(torch.bfloat16, spec, 128, 64, 128)
    matmul.check_card_config(torch.float32, spec, 128, 32, 128)
    with pytest.raises(ValueError, match="K sub-tile 64"):
        matmul.check_card_config(torch.bfloat16, spec, 128, 32, 128)
    with pytest.raises(ValueError, match="blocks"):
        matmul.check_card_config(torch.bfloat16, spec, 256, 128, 256)
    with pytest.raises(ValueError, match="float16"):
        matmul.check_card_config(torch.float16, spec, 128, 128, 128)
    if strategy not in (Strategy.SYNC, Strategy.REGISTER_BYPASS):
        with pytest.raises(ValueError, match="shared memory"):
            matmul.check_card_config(torch.bfloat16, PipelineSpec(strategy, 8),
                                     128, 128, 128)
        matmul.check_card_config(torch.bfloat16, PipelineSpec(strategy, 7),
                                 128, 128, 128)


def _swizzle128(row, chunk):
    """Byte offset in its tile of the 16-byte ``chunk`` (< 8) of ``row`` of
    a 128-byte-row tile in the 128-byte swizzle: Operand::at in
    csrc/async_pipeline.cuh, and where a CU_TENSOR_MAP_SWIZZLE_128B box
    lands."""
    return row * 128 + ((chunk ^ (row & 7)) << 4)


def _swizzle_fill(slot, tile, base):
    """Write ``tile`` (rows of 64 bf16 = 128 bytes) into the byte array
    ``slot`` at ``base`` chunk by chunk, where st.shared, cp.async and a
    SWIZZLE_128B TMA box put them."""
    raw = tile.view(np.uint8)
    for r in range(tile.shape[0]):
        for q in range(8):
            at = base + _swizzle128(r, q)
            slot[at:at + 16] = raw[r, 16 * q:16 * q + 16]


def _sw128(addr):
    """The hardware's 128-byte swizzle of a shared-memory byte address:
    bits 4-6 XOR bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _element(slot, addr):
    return slot[addr:addr + 2].view(np.uint16)[0]


def test_swizzle128_is_a_permutation_of_each_row():
    for r in range(16):
        offs = sorted(_swizzle128(r, q) for q in range(8))
        assert offs == [r * 128 + 16 * q for q in range(8)]


def test_swizzled_slot_reads_back_through_wgmma_descriptors():
    """A bf16 slot filled at swizzled (row, chunk) addresses gives back A's
    128 x 64 tile and both 64 x 64 halves of B's 64 x 128 tile when read
    through the canonical layouts of MatmulBf16Body's descriptors
    (K-major A and N-major B, SWIZZLE_128B), and A's fragments through
    DROP_OFF's ldmatrix row addresses."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 2 ** 16, (128, 64), dtype=np.uint16)
    b = rng.integers(0, 2 ** 16, (64, 128), dtype=np.uint16)
    a_tile, b_half, _ = matmul.bf16_tiles()
    slot = np.zeros(a_tile + 2 * b_half, np.uint8)
    _swizzle_fill(slot, a, 0)
    for h in range(2):
        _swizzle_fill(slot, np.ascontiguousarray(b[:, 64 * h:64 * h + 64]),
                      a_tile + h * b_half)
    for s in range(4):                               # the four k16 steps
        for wg in range(2):                          # A: warpgroup rows
            start = wg * 64 * 128 + A_STEP * s
            got = np.array([[_element(slot, _sw128(
                start + (m % 8) * 128 + (m // 8) * SBO + (k // 8) * 16 +
                (k % 8) * 2)) for k in range(16)] for m in range(64)])
            np.testing.assert_array_equal(
                got, a[64 * wg:64 * wg + 64, 16 * s:16 * s + 16])
        start = a_tile + B_STEP * s                  # B: N-major, trans-b
        got = np.array([[_element(slot, _sw128(
            start + (n // 64) * B_LBO + (n % 64) // 8 * 16 + (n % 8) * 2 +
            (k % 8) * 128 + (k // 8) * SBO)) for n in range(128)]
            for k in range(16)])
        np.testing.assert_array_equal(got, b[16 * s:16 * s + 16])
    for r in range(128):                             # DROP_OFF's ldmatrix
        for q in range(8):
            at = r * 128 + ((q ^ (r & 7)) << 4)
            np.testing.assert_array_equal(slot[at:at + 16].view(np.uint16),
                                          a[r, 8 * q:8 * q + 8])


#: the mnemonics chip_smoke.py's instruction phase counts (SASS_OPS)
SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "UBLKCP", "FFMA", "LDS", "STL",
            "LDL", "MUFU.RCP", "LDG")


def _sass(kernel, *targs, ops=()):
    """A cuobjdump function name of ``kernel``<targs> and its counts."""
    name = f"_ZN2rt{len(kernel)}{kernel}I" + "".join(f"Li{t}E" for t in targs) + "EEvPKf"
    return name, {op: int(op in ops) for op in SASS_OPS}


def _sass_of_this_design():
    """What the instruction phase should see: HGMMA in every bf16 matmul
    kernel, FFMA and LDS but no STL or LDL in every f32 matmul kernel (256
    and 128 columns wide, DROP_OFF 128 only), UTMALDG in the matmuls', lud_internal's
    and lud_internal_panel's TMA kernels, no STL or LDL in any nw kernel
    (every strategy at out_depth 1-4), HMMA (mma.sync) with no STL or
    LDL in every flash attention kernel (D 64 and 128, f32 and bf16:
    element bytes 4 and 2), LDG and one
    MUFU.RCP (the block's reciprocals) with no STL or LDL in the lud
    perimeter kernel (bs 16, 32 and 64), no STL or LDL in any
    pathfinder kernel (every strategy, no out ring), and none in any
    hotspot kernel (every strategy at out_depth 1-4)."""
    pairs = [(0, 0), (1, 0)] + [(s, a) for s in (2, 3) for a in range(4)] + \
        [(4, a) for a in (1, 2, 3)]
    mm = dict(_sass("matmul_f32_kernel", s, a, 0, w,
                    ops=("FFMA", "LDS") + (("UTMALDG",) if s == 4 else ()))
              for s, a in pairs for w in ((128,) if s == 3 else (256, 128)))
    mm.update(_sass("matmul_bf16_kernel", s, a, 0,
                    ops=("HGMMA", "UTMALDG") if s == 4 else ("HGMMA",))
              for s, a in pairs)
    lud_ = dict(_sass("lud_internal_kernel", s, a, o,
                      ops=("UTMALDG",) if s == 4 else ("UBLKCP",))
                for s, a in pairs for o in (1, 2, 3, 4))
    lud_.update(_sass("lud_internal_panel_kernel", s, a, 0,
                      ops=("UTMALDG",) if s == 4 else ())
                for s, a in pairs)
    lud_.update(_sass("lud_diagonal_kernel", bs) for bs in (16, 32, 64))
    lud_.update(_sass("lud_perimeters_kernel", bs,
                      ops=("LDG", "FFMA", "LDS", "MUFU.RCP"))
                for bs in (16, 32, 64))
    nw_ = dict(_sass("nw_kernel", s, a, o, ops=("FFMA", "LDS"))
               for s, a in pairs for o in (1, 2, 3, 4))
    flash = dict(_sass("flash_kernel", d, s, a, 0, eb,
                       ops=("HMMA", "LDS") + (("UBLKCP",) if s == 4 else ()))
                 for d in (64, 128) for s, a in pairs for eb in (4, 2))
    pf = dict(_sass("pathfinder_spans_kernel", s, a, 0,
                    ops=("LDS", "LDG") + (("UBLKCP",) if s == 4 else ()))
              for s, a in pairs)
    hs = dict(_sass("hotspot_kernel", s, a, o,
                    ops=("LDS",) + (("UBLKCP",) if s == 4 else ()))
              for s, a in pairs for o in (1, 2, 3, 4))
    return {"matmul": mm, "lud": lud_, "nw": nw_, "flash_attention": flash,
            "pathfinder": pf, "hotspot": hs}


@pytest.mark.parametrize("fault", [None, "no HGMMA", "no UTMALDG in lud",
                                   "no cuobjdump", "no UTMALDG in lud panel",
                                   "f32 spills", "no UTMALDG in f32",
                                   "f32 missing", "drop_off spills",
                                   "nw local memory", "no HMMA in flash",
                                   "flash spills", "flash drop_off spills",
                                   "perimeter local memory",
                                   "division a step", "perimeter missing",
                                   "lud_internal local memory",
                                   "lud_internal drop_off spills",
                                   "pathfinder local memory",
                                   "pathfinder drop_off spills",
                                   "pathfinder missing",
                                   "hotspot local memory",
                                   "hotspot drop_off spills",
                                   "hotspot missing"])
def test_sass_phase_fails_what_the_design_forbids(fault, monkeypatch, capsys):
    """chip_smoke.py's instruction phase passes this design's counts and
    fails a bf16 matmul kernel without wgmma, an f32 matmul kernel other
    than DROP_OFF's with a spill, a matmul, lud_internal or
    lud_internal_panel TMA kernel without a tensor-map load, a missing f32
    kernel, an nw kernel with local memory, a flash attention kernel
    without mma.sync or, but for DROP_OFF's, with local memory, a lud
    perimeter kernel with local memory or with a MUFU.RCP in each of the
    column solve's bs steps, a missing perimeter kernel, a lud_internal (K
    = bs) kernel other than DROP_OFF's with local memory, a pathfinder
    kernel other than DROP_OFF's with local memory, a missing pathfinder
    kernel, a hotspot kernel other than DROP_OFF's with local memory, a
    missing hotspot kernel, and a card without cuobjdump; DROP_OFF's f32
    matmul, flash attention, lud_internal, pathfinder and hotspot kernels
    may spill (their slot share sits in registers beside the sums, the
    rows or the column)."""
    mod = _chip_smoke()
    assert mod.SASS_OPS == SASS_OPS
    counts = _sass_of_this_design()
    if fault == "no HGMMA":
        counts["matmul"][_sass("matmul_bf16_kernel", 3, 1, 0)[0]]["HGMMA"] = 0
    if fault == "no UTMALDG in lud":
        counts["lud"][_sass("lud_internal_kernel", 4, 2, 3)[0]]["UTMALDG"] = 0
    if fault == "no UTMALDG in lud panel":
        counts["lud"][_sass("lud_internal_panel_kernel", 4, 3, 0)[0]][
            "UTMALDG"] = 0
    if fault == "f32 spills":
        counts["matmul"][_sass("matmul_f32_kernel", 2, 1, 0, 256)[0]][
            "STL"] = 2
    if fault == "no UTMALDG in f32":
        counts["matmul"][_sass("matmul_f32_kernel", 4, 1, 0, 128)[0]][
            "UTMALDG"] = 0
    if fault == "f32 missing":
        del counts["matmul"][_sass("matmul_f32_kernel", 0, 0, 0, 256)[0]]
    if fault == "drop_off spills":
        counts["matmul"][_sass("matmul_f32_kernel", 3, 1, 0, 128)[0]][
            "STL"] = 2
    if fault == "nw local memory":
        counts["nw"][_sass("nw_kernel", 3, 2, 1)[0]]["LDL"] = 1
    if fault == "no HMMA in flash":
        counts["flash_attention"][_sass("flash_kernel", 64, 2, 1, 0, 2)[0]][
            "HMMA"] = 0
    if fault == "flash spills":
        counts["flash_attention"][_sass("flash_kernel", 128, 4, 3, 0, 4)[0]][
            "STL"] = 4
    if fault == "flash drop_off spills":
        counts["flash_attention"][_sass("flash_kernel", 128, 3, 2, 0, 2)[0]][
            "LDL"] = 4
    if fault == "perimeter local memory":
        counts["lud"][_sass("lud_perimeters_kernel", 64)[0]]["STL"] = 2
    if fault == "division a step":
        counts["lud"][_sass("lud_perimeters_kernel", 32)[0]][
            "MUFU.RCP"] = 33
    if fault == "perimeter missing":
        del counts["lud"][_sass("lud_perimeters_kernel", 16)[0]]
    if fault == "lud_internal local memory":
        counts["lud"][_sass("lud_internal_kernel", 2, 1, 2)[0]]["LDL"] = 3
    if fault == "lud_internal drop_off spills":
        counts["lud"][_sass("lud_internal_kernel", 3, 1, 2)[0]]["STL"] = 3
    if fault == "pathfinder local memory":
        counts["pathfinder"][_sass("pathfinder_spans_kernel", 4, 2, 0)[0]][
            "STL"] = 2
    if fault == "pathfinder drop_off spills":
        counts["pathfinder"][_sass("pathfinder_spans_kernel", 3, 1, 0)[0]][
            "LDL"] = 2
    if fault == "pathfinder missing":
        del counts["pathfinder"][_sass("pathfinder_spans_kernel", 2, 3, 0)[0]]
    if fault == "hotspot local memory":
        counts["hotspot"][_sass("hotspot_kernel", 4, 1, 2)[0]]["STL"] = 2
    if fault == "hotspot drop_off spills":
        counts["hotspot"][_sass("hotspot_kernel", 3, 2, 4)[0]]["LDL"] = 2
    if fault == "hotspot missing":
        del counts["hotspot"][_sass("hotspot_kernel", 0, 0, 3)[0]]

    def sass_counts(path):
        if fault == "no cuobjdump":
            raise RuntimeError("cuobjdump not found")
        return counts[path]

    monkeypatch.setattr(mod, "sass_counts", sass_counts)
    mod.check_sass({"matmul": "matmul", "lud": "lud", "nw": "nw",
                    "pathfinder": "pathfinder",
                    "flash_attention": "flash_attention",
                    "hotspot": "hotspot"})
    out = capsys.readouterr().out
    assert ("sass matmul matmul_bf16_kernel<4,1,0>: HGMMA 1 HMMA 0 UTMALDG 1"
            in out) == (fault != "no cuobjdump")
    assert ("sass matmul matmul_f32_kernel<2,3,0,256>: HGMMA 0 HMMA 0 "
            "UTMALDG 0 UBLKCP 0 FFMA 1 LDS 1 STL 0 LDL 0" in out) == \
        (fault != "no cuobjdump")
    assert ("sass flash_attention flash_kernel<128,4,2,0,4>: HGMMA 0 HMMA 1 "
            "UTMALDG 0 UBLKCP 1 FFMA 0 LDS 1 STL 0 LDL 0" in out) == \
        (fault != "no cuobjdump")
    assert bool(mod.FAILURES) == (fault not in (
        None, "drop_off spills", "flash drop_off spills",
        "lud_internal drop_off spills", "pathfinder drop_off spills",
        "hotspot drop_off spills"))
    if fault == "hotspot local memory":
        assert mod.FAILURES == [
            "sass hotspot_kernel<4,1,2>: spills (STL 2, LDL 0)"]
    if fault == "hotspot missing":
        assert "13 pathfinder, 52 hotspot" in mod.FAILURES[0]
    if fault == "pathfinder local memory":
        assert mod.FAILURES == [
            "sass pathfinder_spans_kernel<4,2,0>: spills (STL 2, LDL 0)"]
    if fault == "pathfinder missing":
        assert "3 lud perimeter, 13 pathfinder" in mod.FAILURES[0]
    if fault == "lud_internal local memory":
        assert mod.FAILURES == [
            "sass lud_internal_kernel<2,1,2>: spills (STL 0, LDL 3)"]
    if fault == "no HGMMA":
        assert "matmul_bf16_kernel<3,1,0>: no HGMMA" in mod.FAILURES[0]
    if fault == "no UTMALDG in lud":
        assert "lud_internal_kernel<4,2,3>: no UTMALDG" in mod.FAILURES[0]
    if fault == "no cuobjdump":
        assert "cuobjdump not found" in mod.FAILURES[0]
    if fault == "no UTMALDG in lud panel":
        assert "lud_internal_panel_kernel<4,3,0>: no UTMALDG" in \
            mod.FAILURES[0]
    if fault == "f32 spills":
        assert mod.FAILURES == [
            "sass matmul_f32_kernel<2,1,0,256>: spills (STL 2, LDL 0)"]
    if fault == "no UTMALDG in f32":
        assert "matmul_f32_kernel<4,1,0,128>: no UTMALDG" in mod.FAILURES[0]
    if fault == "f32 missing":
        assert "not 13 bf16 and 22 f32 matmul, 24 TMA, 52 nw and 52 flash " \
            "attention" in mod.FAILURES[0]
    if fault == "nw local memory":
        assert mod.FAILURES == ["sass nw_kernel<3,2,1>: spills (STL 0, LDL 1)"]
    if fault == "no HMMA in flash":
        assert mod.FAILURES == ["sass flash_kernel<64,2,1,0,2>: no HMMA "
                                "(mma.sync)"]
    if fault == "flash spills":
        assert mod.FAILURES == [
            "sass flash_kernel<128,4,3,0,4>: spills (STL 4, LDL 0)"]
    if fault == "perimeter local memory":
        assert mod.FAILURES == [
            "sass lud_perimeters_kernel<64>: spills (STL 2, LDL 0)"]
    if fault == "division a step":
        assert mod.FAILURES == [
            "sass lud_perimeters_kernel<32>: 33 MUFU.RCP, a division in "
            "each step of the column solve"]
    if fault == "perimeter missing":
        assert "52 nw and 52 flash attention, 3 lud perimeter" in \
            mod.FAILURES[0]


def test_ptxas_log_gives_each_kernel_its_registers_and_spills():
    """chip_smoke.py reads each f32 matmul kernel's registers and spill
    bytes from the ``-Xptxas -v`` log that kernels/_build.py keeps."""
    mod = _chip_smoke()
    f32 = _sass("matmul_f32_kernel", 2, 1, 0, 256)[0] + "S2_Pfiiii"
    bf16 = _sass("matmul_bf16_kernel", 4, 1, 0)[0] + "S2_Pfiii"
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{f32}' for 'sm_90a'",
        f"ptxas info    : Function properties for {f32}",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 232 registers, used 1 barriers, 384 bytes "
        "cmem[0]",
        f"ptxas info    : Compiling entry function '{bf16}' for 'sm_90a'",
        f"ptxas info    : Function properties for {bf16}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers"])
    assert mod.ptxas_kernels(log) == {f32: (232, 8, 4), bf16: (128, 0, 0)}
    assert mod.kernel_label(f32) == ("matmul_f32_kernel<2,1,0,256>",
                                     [2, 1, 0, 256])
    assert mod.kernel_label("_Z8rt_error_stringi") == (None, None)


def test_failures_reach_standard_error(capsys):
    """A failed phase is reported on standard error as well as on standard
    output, and the run's closing count of failures names them there."""
    mod = _chip_smoke()
    mod.fail("matmul sync: max_abs_err 1 beyond rtol 0.05")
    captured = capsys.readouterr()
    assert "FAIL matmul sync" in captured.out
    assert "FAIL matmul sync" in captured.err
    assert mod.FAILURES == ["matmul sync: max_abs_err 1 beyond rtol 0.05"]


@pytest.mark.parametrize("kernel,launches", [("nw", 159), ("lud", 1021),
                                             ("pathfinder", 1)])
@pytest.mark.parametrize("seen", ["whole", "partial"])
def test_profiles_take_only_whole_traces(kernel, launches, seen, monkeypatch,
                                         capsys):
    """chip_smoke.py's nw, pathfinder and lud profiles ask device_events
    for a trace that holds every kernel the call launched (lud:
    ``launches`` spread over its six kernels, checked by kernel), and fail
    the run on one that still lacks some after device_events' retries."""
    mod = _chip_smoke()
    names = {"nw": ["nw_kernel"], "pathfinder": ["pathfinder_spans_kernel"],
             "lud": ["lud_diagonal_kernel", "lud_perimeter_row_kernel",
                     "lud_perimeter_col_kernel", "lud_internal_kernel",
                     "lud_internal_panel_kernel",
                     "lud_perimeters_kernel"]}[kernel]
    n = launches if seen == "whole" else launches - 1
    events = [(names[i % len(names)], 0.03) for i in range(n)] + \
        [("Memcpy DtoD", 0.001)]
    by_kernel = tuple(sum(i % len(names) == j for i in range(launches))
                      for j in range(len(names)))
    judged = []

    def device_events(fn, reps=1, attempts=5, whole=None):
        judged.append(whole(events))
        return 40.0, events

    monkeypatch.setattr(mod, "device_events", device_events)
    if kernel in ("nw", "pathfinder"):
        mod.profile_one(lambda: None, kernel, "overlap", launches)
    else:
        mod.profile_lud(lambda: None, "overlap", by_kernel)
    assert judged == [seen == "whole"]
    out = capsys.readouterr().out
    assert (f"profile {kernel} overlap: call 40.000 ms" in out) == \
        (seen == "whole")
    assert bool(mod.FAILURES) == (seen == "partial")
    if seen == "partial" and kernel in ("nw", "pathfinder"):
        assert f"{n} {kernel} kernels seen, not {launches}" in \
            mod.FAILURES[0]
    if seen == "partial" and kernel == "lud":
        short = tuple(sum(i % len(names) == j for i in range(n))
                      for j in range(len(names)))
        assert f"{short} lud kernels seen by kernel, not {by_kernel}" in \
            mod.FAILURES[0]
