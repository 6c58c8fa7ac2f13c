"""The port's pathfinder on CPU tensors (its plain torch version) against the
reference's Pallas kernel in interpret mode and its jnp oracle, on the same
numpy inputs; and a lane-by-lane replay of csrc/pathfinder.cu's spans,
warps and hand-offs against both.

On a CUDA tensor the same wrapper launches csrc/pathfinder.cu; that kernel
is held to the plain version on the card by ``chip_smoke.py``."""
import re
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
    (129, 1003, 4),     # nor of 4; four 32-row steps
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


_CSRC = Path(pathfinder.__file__).resolve().parents[1] / "csrc"


def _constant(source, name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", source)
    assert m, name
    return m.group(1)


def _layout(spec, tile_rows, region):
    """pf_extra_offset(region) + kPfExtra: the ring (one slot for SYNC and
    REGISTER_BYPASS) of tile_rows x region int32, TMA's mbarriers, then
    the warps' edge buffers at the next 16 bytes."""
    slots = 1 if spec.strategy in (Strategy.SYNC,
                                   Strategy.REGISTER_BYPASS) \
        else spec.ring_depth
    bars = 8 * spec.ring_depth if spec.strategy is Strategy.TMA else 0
    return (slots * tile_rows * region * 4 + bars + 15) // 16 * 16 + \
        2 * 8 * 2 * 16 * 4


def test_pyramids_and_smem_of_every_checked_spec():
    """One launch a call (the 16 pyramid launches of the h100 cell gave way
    to one launch of spans), and every spec chip_smoke.py checks fits a
    block at tile_rows 4-16 with the kernel's layout at the widest region
    (768 columns); at tile_rows 64 the region narrows to what fits, never
    under a span of HALO and its two halos."""
    assert pathfinder.LAUNCHES_PER_CALL == 1
    assert not hasattr(pathfinder, "pyramids")
    for s in Strategy:
        for depth in (2, 3, 4):
            spec = PipelineSpec(s, depth)
            for tr in (4, 8, 16):
                smem = pathfinder._smem(spec, tr)
                assert pathfinder.region_cap(spec, tr) == pathfinder.REGION
                assert smem == _layout(spec, tr, pathfinder.REGION)
                assert 0 < smem <= SMEM_PER_BLOCK
            cap = pathfinder.region_cap(spec, 64)
            assert 3 * pathfinder.HALO <= cap <= pathfinder.REGION
            assert cap % 4 == 0
            assert _layout(spec, 64, cap) <= SMEM_PER_BLOCK < \
                _layout(spec, 64, cap + 4) or cap == pathfinder.REGION
            assert pathfinder._smem(spec, 64) == _layout(spec, 64, cap)


@pytest.mark.parametrize("strategy", list(Strategy))
@pytest.mark.parametrize("tile_rows", [1, 4, 8, 16, 17, 21, 32, 64, 65])
def test_card_refusals_raise_value_error(strategy, tile_rows):
    """What the card refuses raises ValueError before any launch: a tile
    of more than MAX_TILE_ROWS rows, and DROP_OFF above the 16 rows it
    holds in registers (it took up to 21 with the pyramid layout)."""
    spec = PipelineSpec(strategy, 3)
    refused = tile_rows > pathfinder.MAX_TILE_ROWS or (
        strategy is Strategy.DROP_OFF and tile_rows > 16)
    if refused:
        with pytest.raises(ValueError):
            pathfinder.check_card_config(spec, tile_rows)
    else:
        pathfinder.check_card_config(spec, tile_rows)


def test_constants_match_the_kernel_source():
    """COLS, GHOST, HALO, WARP_COLS, REGION, MAX_TILE_ROWS, DROP_OFF's rows
    and _EXTRA are the CUDA source's PF_COLS, PF_GHOST, PF_HALO,
    PF_WARP_COLS, PF_REGION, kPfTileRows, kPfDropOffRows and kPfExtra;
    every strategy's narrowest span is one the launcher takes (PF_HALO or
    more, a multiple of 4)."""
    src = (_CSRC / "pathfinder.cu").read_text()
    threads = int(_constant((_CSRC / "async_pipeline.cuh").read_text(),
                            "kThreads"))
    assert int(_constant(src, "PF_COLS")) == pathfinder.COLS == 4
    assert int(_constant(src, "PF_GHOST")) == pathfinder.GHOST
    assert int(_constant(src, "PF_HALO")) == pathfinder.HALO
    assert set(pathfinder.SPAN_MIN) == set(Strategy)
    assert all(w % 4 == 0 and w >= pathfinder.HALO
               for w in pathfinder.SPAN_MIN.values())
    assert int(_constant(src, "kPfTileRows")) == pathfinder.MAX_TILE_ROWS
    assert int(_constant(src, "kPfDropOffRows")) == pathfinder._DROP_OFF_ROWS
    names = {"PF_COLS": pathfinder.COLS, "PF_GHOST": pathfinder.GHOST,
             "kThreads": threads, "kPfWarps": threads // 32}
    warp_cols = eval(_constant(src, "PF_WARP_COLS"), names)
    assert warp_cols == pathfinder.WARP_COLS == 96
    names["PF_WARP_COLS"] = warp_cols
    assert eval(_constant(src, "PF_REGION"), names) == pathfinder.REGION
    assert eval(_constant(src, "kPfExtra"), names) == pathfinder._EXTRA


@pytest.mark.parametrize("cols,blocks,region,span_min,want", [
    (100000, 528, 768, 128, (192, 521, 521, 1)),   # the h100 cell, 4 an SM
    (100000, 264, 768, 128, (380, 264, 264, 1)),   # at 2 an SM
    (100000, 528, 768, 384, (384, 261, 261, 1)),   # OVERLAP, DROP_OFF, TMA
    (100, 528, 768, 128, (128, 1, 1, 1)),          # a width under one span
    (130, 528, 768, 128, (128, 2, 2, 1)),          # a last span of 2 columns
    (400000, 528, 768, 384, (704, 569, 528, 2)),   # more spans than blocks
    (2000, 3, 200, 128, (136, 15, 3, 5)),          # a narrow region
    (2000, 3, 200, 384, (136, 15, 3, 5)),          # ... wider than a span
])
def test_plan(cols, blocks, region, span_min, want):
    p = pathfinder.plan(cols, blocks, region, span_min)
    assert tuple(p) == want
    assert p.span % 4 == 0 and p.span >= pathfinder.HALO
    assert p.span + 2 * pathfinder.HALO <= region
    assert (p.n_spans - 1) * p.span < cols <= p.n_spans * p.span
    assert p.n_spans <= p.grid * p.m <= blocks * p.m


@pytest.mark.parametrize("plan", [pathfinder.Plan(192, 521, 521, 1),
                                  pathfinder.Plan(136, 15, 3, 5)])
def test_workspace_has_the_sizes_the_launcher_takes(plan):
    """pathfinder_spans_launch takes nedges >= grid * m * 4 HALO zero
    (value, step) pairs and, for m > 1, grid * m * 256 int4 of saved
    lanes."""
    edges, save = pathfinder.workspace(plan, "cpu")
    spans = plan.grid * plan.m
    assert edges.dtype == torch.int64 and int(edges.abs().sum()) == 0
    assert edges.numel() == spans * 4 * pathfinder.HALO
    if plan.m == 1:
        assert save is None
    else:
        assert save.dtype == torch.int32
        assert tuple(save.shape) == (spans * 256, pathfinder.COLS)
    src = (_CSRC / "pathfinder.cu").read_text()
    assert "nedges < spans * 4 * rt::PF_HALO" in src


def test_tiles_are_the_kernels_walk():
    """For m > 1, block b's tile i is tile i * grid + b of ``tiles``: span
    j = b + (i % m) grid, DP rows (i // m) tile_rows + 1.., its region from
    HALO columns left of the span, zero outside the wall."""
    wall = torch.from_numpy(_wall(33, 2000, 8))
    tr, h = 8, pathfinder.HALO
    p = pathfinder.plan(2000, 3, 200)
    t = pathfinder.tiles(wall, p, tr)
    region = p.span + 2 * h
    assert tuple(t.shape) == (32 // tr, p.grid * p.m, tr, region)
    flat = t.reshape(-1, tr, region)
    padded = torch.zeros((33, p.grid * p.m * p.span + 2 * h),
                         dtype=torch.int32)
    padded[:, h:h + 2000] = wall
    for b in range(p.grid):
        for i in range(32 // tr * p.m):
            j = b + (i % p.m) * p.grid
            r = (i // p.m) * tr + 1
            x0 = j * p.span - h
            want = padded[r:r + tr, x0 + h:x0 + h + region]
            assert torch.equal(flat[i * p.grid + b], want)


_INT_MAX = 2 ** 31 - 1


def _exchange(v, live):
    """The warps' ghost zones: warp w's first GHOST columns from warp w-1's
    last owned ones, its last GHOST from warp w+1's first owned ones."""
    g, wc = pathfinder.GHOST, pathfinder.WARP_COLS
    old = v.copy()
    v[1:, :g] = old[:-1, wc:wc + g]
    v[:-1, wc + g:] = old[1:, g:2 * g]
    v[:] = np.where(live, v, _INT_MAX)


def _span_replay(wall, blocks, region, order_seed):
    """The last DP row as csrc/pathfinder.cu computes it, lane by lane, for
    a card that holds ``blocks`` blocks: the spans from ``plan`` (the
    wrapper's helper), warp w of a span holding 128 columns of its region
    from 96 w - 16 (four a lane; the outer 16 a side are ghosts), a column
    outside the region or the array INT_MAX and never updated, a lane's
    outer neighbours by shuffle (its own value at the warp's edges), the
    warps' exchange every GHOST rows, and every HALO rows a step: each span
    writes its HALO edge columns (two parities), and at the next step's
    start its halo lanes take the neighbours'.  Within a step the spans go
    in an order drawn from ``order_seed``; a step starts only after every
    span wrote its edges of the step before, as the step tags enforce."""
    wall = np.asarray(wall, dtype=np.int64)
    rows, cols = wall.shape
    p = pathfinder.plan(cols, blocks, region)
    h, g, wc = pathfinder.HALO, pathfinder.GHOST, pathfinder.WARP_COLS
    dp = rows - 1
    win = np.arange(8)[:, None] * wc - g + np.arange(128)[None, :]
    owner = np.zeros(win.shape, dtype=bool)
    owner[:, g:g + wc] = True
    spans = []
    for j in range(p.n_spans):
        x0 = j * p.span - h
        x = x0 + win
        live = (x >= max(x0, 0)) & (x < min(x0 + p.span + 2 * h, cols))
        v = np.where(live, wall[0, np.clip(x, 0, cols - 1)], _INT_MAX)
        spans.append((x, live, v, x - j * p.span))
    edges = np.full((p.n_spans, 2, 2, h), -7, dtype=np.int64)
    out = np.full(cols, -1, dtype=np.int64)
    bounds = list(range(0, dp, h)) + [dp]
    rng = np.random.default_rng(order_seed)
    for k in range(len(bounds) - 1):
        for j in rng.permutation(p.n_spans):
            x, live, v, rel = spans[j]
            if k > 0:                        # the halo, then the exchange
                par = k & 1
                if j > 0:
                    m = owner & (rel >= -h) & (rel < 0)
                    v[m] = edges[j - 1, par, 1, rel[m] + h]
                if j + 1 < p.n_spans:
                    m = owner & (rel >= p.span) & (rel < p.span + h)
                    v[m] = edges[j + 1, par, 0, rel[m] - p.span]
                v[:] = np.where(live, v, _INT_MAX)
                _exchange(v, live)
            for rr in range(bounds[k] + 1, bounds[k + 1] + 1):
                left = np.concatenate([v[:, 3:4], v[:, :-1]], 1)
                right = np.concatenate([v[:, 1:], v[:, 124:125]], 1)
                nxt = wall[rr, np.clip(x, 0, cols - 1)] + np.minimum(
                    np.minimum(left, v), right)
                v[:] = np.where(live, nxt, _INT_MAX)
                if rr % g == 0 and rr < dp and rr % h:
                    _exchange(v, live)
            end = bounds[k + 1]
            if end < dp:                     # this span's edges of step k + 1
                par = (end // h) & 1
                if j > 0:
                    m = owner & (rel >= 0) & (rel < h)
                    edges[j, par, 0, rel[m]] = v[m]
                if j + 1 < p.n_spans:
                    m = owner & (rel >= p.span - h) & (rel < p.span)
                    edges[j, par, 1, rel[m] - (p.span - h)] = v[m]
            else:
                m = owner & (rel >= 0) & (rel < p.span) & (x < cols)
                out[x[m]] = v[m]
    return out, p


@pytest.mark.parametrize("rows,cols,tile_rows,blocks,region,m", [
    (33, 128, 8, 528, 768, 1),       # the parity shapes
    (17, 256, 8, 528, 768, 1),
    (129, 1003, 4, 4, 768, 1),       # ragged: no multiple of the span nor 4
    (65, 1000, 8, 3, 768, 1),
    (81, 2003, 8, 5, 768, 1),        # rows - 1 no multiple of HALO
    (41, 100, 8, 528, 768, 1),       # a width under one span
    (101, 130, 4, 528, 768, 1),      # a last span of 2 columns
    (57, 259, 8, 528, 768, 1),       # a last span of 3 columns
    (201, 5000, 8, 7, 768, 2),       # more spans than blocks
    (49, 2000, 8, 3, 200, 5),        # ... in narrow regions
])
def test_span_decomposition_equals_plain_and_reference(rows, cols, tile_rows,
                                                       blocks, region, m):
    """The kernel's spans, warps and hand-offs, spans taken in a random
    order within each step, equal pathfinder_plain and the reference's
    pathfinder_pallas (interpret mode) exactly."""
    wall = _wall(rows, cols, rows * cols)
    got, p = _span_replay(wall, blocks, region, order_seed=rows + cols)
    assert p.m == m
    plain = pathfinder.pathfinder_plain(torch.from_numpy(wall))[0].numpy()
    np.testing.assert_array_equal(got, plain)
    want = ref_ops.pathfinder(jnp.asarray(wall), tile_rows=tile_rows)
    np.testing.assert_array_equal(got, np.asarray(want)[0])
