"""The port's pathfinder on CPU tensors (its plain torch version) against the
reference's Pallas kernel in interpret mode and its jnp oracle, on the same
numpy inputs.

On a CUDA tensor the same wrapper launches csrc/pathfinder.cu; that kernel
is held to the plain version on the card by ``chip_smoke.py``."""
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
from repro_torch.kernels import _build, ops, pathfinder, ref    # noqa: E402
from repro_torch.tuning import search_space                     # noqa: E402

STRATEGIES = [s.value for s in RefStrategy]


def _wall(rows, cols, seed):
    """int32 costs in [0, 10), the reference's pathfinder input."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 10, (rows, cols)).astype(np.int32)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("rows,cols", [(33, 128), (17, 256)])
def test_pathfinder_matches_pallas(strategy, rows, cols):
    wall = _wall(rows, cols, 1)
    want = ref_ops.pathfinder(jnp.asarray(wall), strategy=strategy)
    got = ops.pathfinder(torch.from_numpy(wall), strategy=strategy)
    assert tuple(got.shape) == tuple(want.shape) == (1, cols)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rows,cols,tile_rows", [
    (65, 1000, 8),      # cols not a multiple of the card's 256-wide strips
    (129, 1003, 4),     # nor of 4; two pyramids of 64 rows
    (1, 40, 8),         # no DP row: the first row is the result
])
def test_pathfinder_matches_oracle(rows, cols, tile_rows):
    wall = _wall(rows, cols, 2)
    got = ops.pathfinder(torch.from_numpy(wall), tile_rows=tile_rows)
    np.testing.assert_array_equal(
        got.numpy()[0], np.asarray(ref_ref.pathfinder_ref(jnp.asarray(wall))))


def test_pathfinder_ref_matches_reference_oracle():
    wall = _wall(41, 300, 3)
    np.testing.assert_array_equal(
        ref.pathfinder_ref(torch.from_numpy(wall)).numpy(),
        np.asarray(ref_ref.pathfinder_ref(jnp.asarray(wall))))


@pytest.mark.parametrize("rows,tile_rows", [(34, 8), (17, 5)])
def test_rows_not_divisible_raise_value_error_like_reference(rows,
                                                              tile_rows):
    wall = _wall(rows, 128, 4)
    with pytest.raises(ValueError, match="must divide"):
        ref_ops.pathfinder(jnp.asarray(wall), tile_rows=tile_rows)
    with pytest.raises(ValueError, match="must divide"):
        ops.pathfinder(torch.from_numpy(wall), tile_rows=tile_rows)


@pytest.mark.parametrize("call", [
    lambda: pathfinder.pathfinder_cuda(torch.zeros(64, dtype=torch.int32)),
    lambda: pathfinder.pathfinder_cuda(
        torch.zeros(33, 128, dtype=torch.int32, device="meta"))])
def test_invalid_calls_raise_value_error(call):
    with pytest.raises(ValueError):
        call()


def test_defaults_match_reference():
    cfg = ops.default_config("pathfinder")
    assert cfg == config_from_reference(
        ref_ops.seed_default_config("pathfinder"))
    assert "out_depth" not in cfg


def test_installed_tile_rows_falls_back_to_seed():
    wall = torch.from_numpy(_wall(33, 128, 5))
    try:
        ops.set_default_config("pathfinder", tile_rows=5)   # 32 % 5 != 0
        got = ops.pathfinder(wall)
    finally:
        ops.reset_default_configs()
    torch.testing.assert_close(got, pathfinder.pathfinder_plain(wall))


def test_cpu_calls_launch_nothing_and_build_nothing():
    pathfinder.LAUNCHES = 0
    ops.pathfinder(torch.from_numpy(_wall(17, 256, 6)))
    assert pathfinder.LAUNCHES == 0
    assert "pathfinder" not in _build._libs


@pytest.mark.parametrize("name", ["smoke/pathfinder",
                                  "fig4/pathfinder/drop_off"])
def test_pathfinder_cells_check_ok_on_cpu(name):
    sc = scenario.get_scenario(name)
    ref_sc = ref_scenario.get_scenario(name)
    assert (sc.kernel, sc.shape, sc.dtype, sc.workload) == \
        (ref_sc.kernel, ref_sc.shape, ref_sc.dtype, ref_sc.workload)
    row = runner.run_scenario(sc, runner.RunOptions(device="cpu", repeats=2,
                                                    warmup=0))
    assert row.metrics["check_ok"] is True and row.metrics["max_err"] == 0


def test_pathfinder_check_sees_a_wrong_cell():
    sc = scenario.get_scenario("smoke/pathfinder")
    (wall,) = sc.make_args("cpu")
    out = pathfinder.pathfinder_plain(wall)
    assert wall.dtype == torch.int32 and tuple(out.shape) == (1, 128)
    assert scenario.check_output(sc, (wall,), out) == 0
    out[0, 77] += 1
    assert scenario.check_output(sc, (wall,), out) > \
        scenario.CHECK_TOL["pathfinder"]


def test_pathfinder_spec_matches_reference():
    spec, want = search_space.SPECS["pathfinder"], ref_space.SPECS["pathfinder"]
    for shape, tr in (((33, 128), 8), ((1001, 100000), 8), ((17, 256), 4)):
        cfg = dict(tile_rows=tr)
        assert spec.flops_bytes(shape, "float32", cfg) == \
            pytest.approx(want.flops_bytes(shape, "float32", cfg))
        assert spec.n_tiles(shape, cfg) == want.n_tiles(shape, cfg)
    (wall,) = spec.make_args((33, 128), "float32",
                             torch.Generator().manual_seed(0), "cpu")
    assert wall.dtype == torch.int32 and tuple(wall.shape) == (33, 128)
    assert int(wall.min()) >= 0 and int(wall.max()) < 10


def test_pyramids_and_smem_of_every_checked_spec():
    """The h100 cell's 1,000 DP rows are 16 launches of at most HALO rows,
    and every spec chip_smoke.py checks fits a block."""
    assert pathfinder.pyramids(1001, 8) == 16
    assert pathfinder.pyramids(129, 4) == 2
    assert pathfinder.pyramids(33, 16) == 1
    for s in Strategy:
        for depth in (2, 3, 4):
            for tr in (4, 8, 16):
                smem = pathfinder._smem(PipelineSpec(s, depth), tr)
                assert 0 < smem <= SMEM_PER_BLOCK
