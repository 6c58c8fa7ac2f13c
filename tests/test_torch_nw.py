"""The port's Needleman-Wunsch on CPU tensors (its plain torch version)
against the reference's Pallas kernel in interpret mode and its jnp oracle,
on the same numpy inputs.

On a CUDA tensor the same wrapper launches csrc/nw.cu; that kernel is held
to the plain version on the card by ``chip_smoke.py``.  Here the kernel's
strip decomposition and hand-off protocol are replayed in torch, and its
shared-memory layout and workspace are held to the CUDA source."""
import itertools
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
    (200, 10, 8),       # n not a multiple of the card's 256-column strips
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


def _layout(spec, tile_rows):
    """csrc/nw.cu's shared memory: nw_extra_offset (the ring, or SYNC's
    one staging slot, the out ring and TMA's mbarriers, rounded up to 16
    bytes), then kNwExtra (two sets of eight warp maxima, kNwTileRows
    seeds, the strip index padded to 16 bytes)."""
    tile = tile_rows * 256 * 4
    slots = 1 if spec.strategy is Strategy.SYNC else spec.ring_depth
    bars = 8 * spec.ring_depth if spec.strategy is Strategy.TMA else 0
    offset = (slots * tile + spec.out_depth * tile + bars + 15) // 16 * 16
    return offset + (2 * 8 + 64) * 4 + 16


def test_diagonals_and_smem_of_every_checked_spec():
    """One launch a call (the 159 anti-diagonal launches at n = 8192 gave
    way to one launch of column strips): n = 8192 is 32 strips of 256
    columns.  Every spec chip_smoke.py checks fits a block at tile_rows
    4-16 with the kernel's shared-memory layout; at tile_rows 64 (64 KiB
    a slot) only three slots do: at ring depth 2, single-buffered rings
    with up to two out slots, the others with one."""
    assert nw.LAUNCHES_PER_CALL == 1
    assert (nw.strips(8192), nw.strips(2100), nw.strips(1536),
            nw.strips(200), nw.strips(90)) == (32, 9, 6, 1, 1)
    for s in Strategy:
        for depth in (2, 3, 4):
            for od in (1, 2, 4):
                for tr in (4, 8, 16):
                    spec = PipelineSpec(s, depth, None, od)
                    smem = nw._smem(spec, tr)
                    assert smem == _layout(spec, tr)
                    assert 0 < smem <= SMEM_PER_BLOCK
    fits = {(s, od) for s in Strategy for od in (1, 2, 4)
            if nw._smem(PipelineSpec(s, 2, None, od), 64) <= SMEM_PER_BLOCK}
    assert fits == {(Strategy.SYNC, 1), (Strategy.SYNC, 2),
                    (Strategy.REGISTER_BYPASS, 1),
                    (Strategy.REGISTER_BYPASS, 2), (Strategy.OVERLAP, 1),
                    (Strategy.DROP_OFF, 1), (Strategy.TMA, 1)}


_CSRC = Path(nw.__file__).resolve().parents[1] / "csrc"


def _constant(source, name):
    m = re.search(rf"constexpr int {name} = (\w+);", source)
    assert m, name
    return m.group(1)


def test_constants_match_the_kernel_source():
    """STRIP, MAX_TILE_ROWS, DROP_OFF's rows and _EXTRA are the CUDA
    source's NW_STRIP (= kThreads), kNwTileRows, kNwDropOffRows and
    kNwExtra."""
    src = (_CSRC / "nw.cu").read_text()
    threads = int(_constant((_CSRC / "async_pipeline.cuh").read_text(),
                            "kThreads"))
    assert _constant(src, "NW_STRIP") == "kThreads"
    assert nw.STRIP == threads == 256
    assert int(_constant(src, "kNwTileRows")) == nw.MAX_TILE_ROWS
    assert int(_constant(src, "kNwDropOffRows")) == nw._DROP_OFF_ROWS
    extra = re.search(r"constexpr int kNwExtra = (.+);", src).group(1)
    assert eval(extra, {"kWarps": threads // 32,
                        "kNwTileRows": nw.MAX_TILE_ROWS}) == nw._EXTRA


@pytest.mark.parametrize("strategy", list(Strategy))
@pytest.mark.parametrize("tile_rows", [1, 6, 8, 16, 64])
def test_smem_is_the_kernels_layout(strategy, tile_rows):
    for depth, od in itertools.product((1, 2, 3, 4), (1, 2, 3, 4)):
        spec = PipelineSpec(strategy, depth, None, od)
        assert nw._smem(spec, tile_rows) == _layout(spec, tile_rows)
        if tile_rows <= 16:
            assert nw._smem(spec, tile_rows) <= SMEM_PER_BLOCK


@pytest.mark.parametrize("n", [1, 90, 256, 257, 2100, 8192])
def test_workspace_has_the_sizes_the_launcher_takes(n):
    """nw_strips_launch takes one zero int32 (the ticket) and nedge >= nbc n
    f32 of NaN (the edge buffer, NaN until written), nbc = ceil(n / 256)."""
    ticket, edge = nw.workspace(n, "cpu")
    nbc = -(-n // 256)
    assert ticket.dtype == torch.int32 and tuple(ticket.shape) == (1,)
    assert int(ticket) == 0
    assert edge.dtype == torch.float32 and edge.numel() == nbc * n
    assert edge.isnan().all()
    src = (_CSRC / "nw.cu").read_text()
    assert "nedge < static_cast<long long>(nbc) * n" in src


def _strip_table(scores, penalty, strip, tile_rows, order_seed):
    """The table strip by strip as csrc/nw.cu computes it, one thread a
    column and warps of 32: per row t = max(up_left + s, up - p) + j p,
    thread 0 folds in the seed (seed - p), a scan in each warp, pre = the
    maximum of the warps to the left, m = max(v, pre) - j p, and the next
    up_left from the left lane's scan value (lane 0 of warp w:
    pre - (32 w - 1) p; thread 0: the seed).  Strips advance a tile at a
    time in an order drawn from ``order_seed``; the left strip's last
    column reaches a strip through the edge buffer, NaN until written, and
    a strip starts a tile only when none of its seeds is NaN (a NaN that
    got through would reach the table)."""
    n = scores.shape[0]
    p = float(penalty)
    warps = strip // 32
    nbc = -(-n // strip)
    neg = torch.tensor(float("-inf"))
    pj = p * torch.arange(n + 1, dtype=torch.float32)
    table = torch.full((n + 1, n + 1), float("nan"))
    table[0] = -pj
    table[1:, 0] = -pj[1:]
    edge = torch.full((nbc, n), float("nan"))
    jp = p * torch.arange(strip, dtype=torch.float32)
    lane0 = torch.arange(strip) % 32 == 0
    warp = torch.arange(strip) // 32
    state = []
    for J in range(nbc):
        j0 = 1 + J * strip
        width = min(strip, n + 1 - j0)
        up = torch.zeros(strip)
        up_left = torch.zeros(strip)
        up[:width] = table[0, j0:j0 + width]
        up_left[:width] = table[0, j0 - 1:j0 - 1 + width]
        sc = torch.zeros((n, strip))
        sc[:, :width] = scores[:, j0 - 1:j0 - 1 + width]
        state.append([j0, width, up, up_left, sc, 0])
    rng = np.random.default_rng(order_seed)
    tiles = n // tile_rows
    while any(st[5] < tiles for st in state):
        J = int(rng.integers(nbc))
        j0, width, up, up_left, sc, t = state[J]
        rows = slice(t * tile_rows, (t + 1) * tile_rows)
        if t == tiles or (J > 0 and edge[J - 1, rows].isnan().any()):
            continue                         # done, or waiting on its left
        for k in range(tile_rows):
            i = t * tile_rows + k + 1
            seed = torch.tensor(-p * i) if J == 0 else edge[J - 1, i - 1]
            v = torch.maximum(up_left + sc[i - 1], up - p) + jp
            v[0] = torch.maximum(v[0], seed - p)
            v = torch.cummax(v.view(warps, 32), 1).values
            wm = v[:, -1]
            pre = torch.cat([neg.view(1), torch.cummax(wm, 0).values[:-1]])
            m = torch.maximum(v, pre[:, None]).reshape(-1) - jp
            v_left = torch.cat([neg.expand(warps, 1), v[:, :-1]], 1)
            nxt = torch.maximum(v_left, pre[:, None]).reshape(-1) - (jp - p)
            first = pre - (32 * torch.arange(warps) - 1) * p
            nxt = torch.where(lane0, first[warp], nxt)
            nxt[0] = seed
            up, up_left = m, nxt
            table[i, j0:j0 + width] = m[:width]
            if J + 1 < nbc:
                edge[J, i - 1] = m[strip - 1]
        state[J][2:4] = [up, up_left]
        state[J][5] = t + 1
    return table


@pytest.mark.parametrize("strip", [64, 128])
@pytest.mark.parametrize("n,penalty,tile_rows", [(90, 10, 6), (200, 3, 8),
                                                  (300, 10, 6)])
def test_strip_decomposition_equals_plain_and_reference(n, penalty,
                                                        tile_rows, strip):
    """The kernel's strips, with strips narrower than the card's 256 so
    that n = 90-300 crosses 2-5 of them (the last ragged at 90, 200 and
    300), equal nw_plain and the reference's nw_ref exactly."""
    s = _scores(n, 7)
    got = _strip_table(torch.from_numpy(s), penalty, strip, tile_rows,
                       order_seed=n + strip)
    assert not got.isnan().any()
    assert torch.equal(got, nw.nw_plain(torch.from_numpy(s), penalty))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_ref.nw_ref(jnp.asarray(s), penalty)))
