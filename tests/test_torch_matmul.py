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


def _chip_smoke_configs():
    """The (strategy, depth, wait_group, out_depth) chip_smoke.py checks."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.configs()


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
        128 * (32 * 4 + 16) + 32 * (128 * 4 + 16))


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
