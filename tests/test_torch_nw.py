"""The port's Needleman-Wunsch on CPU tensors (its plain torch version)
against the reference's Pallas kernel in interpret mode and its jnp oracle,
on the same numpy inputs.

On a CUDA tensor the same wrapper launches csrc/nw.cu; that kernel is held
to the plain version on the card by ``chip_smoke.py``."""
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
from repro_torch.bench.scenario import config_from_reference    # noqa: E402
from repro_torch.core.async_pipeline import (                   # noqa: E402
    SMEM_PER_BLOCK, PipelineSpec, Strategy)
from repro_torch.kernels import _build, nw, ops, ref            # noqa: E402
from repro_torch.tuning import search_space                     # noqa: E402

STRATEGIES = [s.value for s in RefStrategy]
#: the reference's nw tolerance (tests/test_kernels.py::test_nw)
TOL = 1e-4


def _scores(n, seed):
    """Integer similarities in [-3, 4) as float32, the reference's input."""
    rng = np.random.default_rng(seed)
    return rng.integers(-3, 4, (n, n)).astype(np.float32)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("n,penalty", [(32, 10), (64, 3)])
def test_nw_matches_pallas(strategy, n, penalty):
    s = _scores(n, 1)
    want = ref_ops.nw(jnp.asarray(s), penalty=penalty, strategy=strategy)
    got = ops.nw(torch.from_numpy(s), penalty=penalty, strategy=strategy)
    assert tuple(got.shape) == tuple(want.shape) == (n + 1, n + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("n,penalty,tile_rows", [
    (200, 10, 8),       # n not a multiple of the card's 64 x 256 blocks
    (90, 3, 6),         # nor of 4
])
def test_nw_matches_oracle(n, penalty, tile_rows):
    s = _scores(n, 2)
    got = ops.nw(torch.from_numpy(s), penalty=penalty, tile_rows=tile_rows)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref_ref.nw_ref(jnp.asarray(s), penalty)),
        atol=TOL)


@pytest.mark.parametrize("n,penalty", [(32, 10), (48, 3)])
def test_nw_ref_matches_reference_oracle(n, penalty):
    s = _scores(n, 3)
    np.testing.assert_array_equal(
        ref.nw_ref(torch.from_numpy(s), penalty).numpy(),
        np.asarray(ref_ref.nw_ref(jnp.asarray(s), penalty)))


@pytest.mark.parametrize("n,penalty", [(256, 10), (129, 1)])
def test_anti_diagonal_oracle_equals_row_scan(n, penalty):
    """The port's oracle (anti-diagonals) and plain version (row scans)
    are independent formulations; on integer scores they agree exactly."""
    s = torch.from_numpy(_scores(n, 4))
    torch.testing.assert_close(ref.nw_ref(s, penalty), nw.nw_plain(s, penalty),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n,tile_rows", [(36, 8), (32, 3)])
def test_n_not_divisible_raises_value_error_like_reference(n, tile_rows):
    s = _scores(n, 5)
    with pytest.raises(ValueError, match="must divide"):
        ref_ops.nw(jnp.asarray(s), tile_rows=tile_rows)
    with pytest.raises(ValueError, match="must divide"):
        ops.nw(torch.from_numpy(s), tile_rows=tile_rows)


@pytest.mark.parametrize("call", [
    lambda: nw.nw_cuda(torch.zeros(32, 16), 10),
    lambda: nw.nw_cuda(torch.zeros(32, 32, device="meta"), 10)])
def test_invalid_calls_raise_value_error(call):
    with pytest.raises(ValueError):
        call()


def test_defaults_match_reference():
    assert ops.default_config("nw") == config_from_reference(
        ref_ops.seed_default_config("nw"))


def test_cpu_calls_launch_nothing_and_build_nothing():
    nw.LAUNCHES = 0
    ops.nw(torch.from_numpy(_scores(32, 6)))
    assert nw.LAUNCHES == 0
    assert "nw" not in _build._libs


@pytest.mark.parametrize("name", ["smoke/nw", "fig4/nw/register_bypass"])
def test_nw_cells_check_ok_on_cpu(name):
    sc = scenario.get_scenario(name)
    ref_sc = ref_scenario.get_scenario(name)
    assert (sc.kernel, sc.shape, sc.dtype, sc.workload) == \
        (ref_sc.kernel, ref_sc.shape, ref_sc.dtype, ref_sc.workload)
    row = runner.run_scenario(sc, runner.RunOptions(device="cpu", repeats=2,
                                                    warmup=0))
    assert row.metrics["check_ok"] is True and row.metrics["max_err"] == 0


def test_nw_check_sees_a_wrong_cell():
    sc = scenario.get_scenario("smoke/nw")
    (s,) = sc.make_args("cpu")
    out = nw.nw_plain(s, 10)
    assert scenario.check_output(sc, (s,), out) == 0
    out[20, 7] -= 1
    assert scenario.check_output(sc, (s,), out) > scenario.CHECK_TOL["nw"]


def test_nw_spec_matches_reference():
    spec, want = search_space.SPECS["nw"], ref_space.SPECS["nw"]
    for n, tr in ((32, 8), (8192, 8), (128, 16)):
        cfg = dict(tile_rows=tr)
        assert spec.flops_bytes((n,), "float32", cfg) == \
            pytest.approx(want.flops_bytes((n,), "float32", cfg))
        assert spec.n_tiles((n,), cfg) == want.n_tiles((n,), cfg)
    (s,) = spec.make_args((32,), "float32", torch.Generator().manual_seed(0),
                          "cpu")
    assert s.dtype == torch.float32 and tuple(s.shape) == (32, 32)
    assert float(s.min()) >= -3 and float(s.max()) <= 3
    assert torch.equal(s, s.round())


def test_diagonals_and_smem_of_every_checked_spec():
    """n = 8192 is 128 block rows and 32 block columns, 159 launches; every
    spec chip_smoke.py checks fits a block."""
    assert nw.diagonals(8192, 8) == 159
    assert nw.diagonals(200, 8) == 4 + 1 - 1
    assert nw.diagonals(90, 6) == 2
    for s in Strategy:
        for depth in (2, 3, 4):
            for od in (1, 2, 4):
                for tr in (4, 8, 16):
                    smem = nw._smem(PipelineSpec(s, depth, None, od), tr)
                    assert 0 < smem <= SMEM_PER_BLOCK
