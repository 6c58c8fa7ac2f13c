"""The port's hotspot on the CPU: a step-by-step replay of csrc/hotspot.cu's
walk (column tiles with their aligned, edge-cut windows; a band's tiles
with the carried row pair; the clamping selects) against the reference's
Pallas kernel in interpret mode and the plain torch version, on the same
numpy inputs; the source's constants, ``_pitched``, and what the card
refuses.

On a CUDA tensor the wrapper launches csrc/hotspot.cu; that kernel is held
to the plain version on the card by ``chip_smoke.py``."""
import re
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                         # noqa: E402

from repro.kernels import ops as ref_ops                        # noqa: E402
from repro_torch.core.async_pipeline import (                   # noqa: E402
    SMEM_PER_BLOCK, PipelineSpec, Strategy)
from repro_torch.kernels import hotspot                         # noqa: E402

_CSRC = Path(hotspot.__file__).resolve().parents[1] / "csrc"
TC, OFF, WIN = hotspot.TILE_COLS, hotspot.OFF, hotspot.WIN
RX = RY = np.float32(0.1)
RZ = CAP = np.float32(0.5)


def _round4(n):
    return (n + 3) // 4 * 4


def _cell(c, u, d, left, right, p):
    """HotspotBody::cell in float32, in the kernel's order."""
    two, hot = np.float32(2.0), np.float32(80.0)
    return c + CAP * (p + (u + d - two * c) * RY
                      + (left + right - two * c) * RX + (hot - c) * RZ)


def _as_caller(x, pitch):
    """x (R, C) in rows of ``pitch`` floats, NaN past C: the layout the
    kernel reads, whose row padding may hold anything."""
    buf = np.full((x.shape[0], pitch), np.nan, np.float32)
    buf[:, :x.shape[1]] = x
    return buf


def replay_step(field, power, cols, grid, tile_rows, moved=None):
    """One launch of csrc/hotspot.cu, block by block: ``field`` and
    ``power`` (R, pitch >= round4(cols)) as the caller lays them out;
    returns the (R, round4(cols)) output buffer.  Shared memory starts as
    NaN and every slot is NaN again before its copy, so a read of a byte
    no copy brought shows in the result.  ``moved`` (a dict) counts the
    bytes each array's copies request."""
    rows = field.shape[0]
    w = _round4(cols)
    out = np.full((rows, w), np.nan, np.float32)
    n_tiles = rows // grid // tile_rows
    lane = np.arange(TC)
    for b in range(grid):
        row0 = b * n_tiles * tile_rows
        for c0 in range(0, cols, TC):
            w4 = _round4(min(TC, cols - c0))
            ws, we = max(c0 - OFF, 0), min(c0 + TC + OFF, w)
            k = c0 - ws + lane          # the slot column: 0 at c0 = 0
            col = c0 + lane
            kl = np.where(col == 0, k, k - 1)
            kr = np.where(col == cols - 1, k, k + 1)
            carry = np.full((2, 2, WIN), np.nan, np.float32)
            carry[0, 0, :we - ws] = field[max(row0 - 1, 0), ws:we]
            carry[0, 1, :we - ws] = field[row0, ws:we]
            buf = 0
            if moved is not None:
                moved["temp"] += 2 * (we - ws) * 4
            for i in range(n_tiles):
                r0 = row0 + i * tile_rows
                t_slot = np.full((tile_rows, WIN), np.nan, np.float32)
                p_slot = np.full((tile_rows, TC), np.nan, np.float32)
                for r in range(tile_rows):      # Operand::glast: a row past
                    g = min(r0 + 1 + r, rows - 1)           # R - 1 reads it
                    t_slot[r, :we - ws] = field[g, ws:we]
                p_slot[:, :w4] = power[r0:r0 + tile_rows, c0:c0 + w4]
                if moved is not None:
                    moved["temp"] += tile_rows * (we - ws) * 4
                    moved["power"] += tile_rows * w4 * 4
                    moved["out"] += tile_rows * w4 * 4
                mid = carry[buf, 1]
                u, c = carry[buf, 0][k], mid[k]
                for r in range(tile_rows):
                    dn = t_slot[r]
                    d = dn[k]
                    y = _cell(c, u, d, mid[kl], mid[kr], p_slot[r])
                    out[r0 + r, c0:c0 + w4] = y[:w4]
                    u, c, mid = c, d, dn
                nxt = carry[buf ^ 1]
                nxt[0][k], nxt[1][k] = u, c
                # the halo columns, by the first and the last thread
                nxt[1][kl[0]] = mid[kl[0]]
                nxt[1][kr[-1]] = mid[kr[-1]]
                buf ^= 1
    return out


def replay(temp, power, *, iters, grid, tile_rows, pitch):
    """``iters`` launches as ``hotspot_cuda`` chains them: step k + 1 reads
    step k's (R, round4(C)) output in place, padding and all."""
    cols = temp.shape[1]
    field = _as_caller(temp, pitch)
    power_p = _as_caller(power, pitch)
    for _ in range(iters):
        field = replay_step(field, power_p, cols, grid, tile_rows)
    return field[:, :cols]


def _inputs(rows, cols, seed):
    rng = np.random.default_rng(seed)
    temp = (rng.uniform(size=(rows, cols)) * 100 + 300).astype(np.float32)
    power = rng.uniform(size=(rows, cols)).astype(np.float32)
    return temp, power


# (cols, grid, tile_rows, n_tiles a band, iters, extra row pitch): every
# width of the edge cases, each tile_rows at three of them, grids 1-3 and
# iters 1-3; a pitch past round4(C) where the caller's rows are a view
_CASES = [
    (1, 2, 8, 1, 2, 0), (3, 3, 2, 2, 3, 4), (4, 1, 1, 3, 1, 0),
    (126, 2, 8, 2, 3, 0), (128, 1, 2, 3, 2, 8), (255, 3, 1, 2, 2, 0),
    (256, 2, 2, 2, 1, 4), (257, 2, 8, 2, 3, 0), (260, 3, 1, 3, 2, 0),
    (513, 3, 8, 1, 2, 4), (126, 1, 1, 4, 1, 4), (257, 1, 2, 2, 2, 0),
]


@pytest.mark.parametrize("cols,grid,tile_rows,n_tiles,iters,extra", _CASES)
def test_replay_matches_reference_and_plain(cols, grid, tile_rows, n_tiles,
                                            iters, extra):
    rows = grid * tile_rows * n_tiles
    temp, power = _inputs(rows, cols, cols + rows)
    got = replay(temp, power, iters=iters, grid=grid, tile_rows=tile_rows,
                 pitch=_round4(cols) + extra)
    assert np.isfinite(got).all(), "a kept cell read a byte no copy brought"
    want = ref_ops.hotspot(jnp.asarray(temp), jnp.asarray(power),
                           iters=iters, strategy="overlap",
                           tile_rows=tile_rows, grid=grid)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-3)
    plain = torch.from_numpy(temp)
    for _ in range(iters):
        plain = hotspot.hotspot_step_plain(plain, torch.from_numpy(power))
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("rows,cols,grid,tile_rows", [
    (16, 1, 2, 8), (24, 257, 3, 8), (64, 513, 2, 8), (12, 260, 3, 1)])
def test_moved_bytes_counts_the_replays_copies(rows, cols, grid, tile_rows):
    temp, power = _inputs(rows, cols, 7)
    moved = dict(temp=0, power=0, out=0)
    replay_step(_as_caller(temp, _round4(cols)),
                _as_caller(power, _round4(cols)), cols, grid, tile_rows,
                moved)
    assert moved == hotspot._moved_bytes(rows, cols, grid, tile_rows)


def test_moved_bytes_at_the_h100_cell():
    """(8192, 8192), grid 32: 8,440 window columns of 8,192 over 8,256 rows
    of 8,192, and power and out exactly the bound's."""
    got = hotspot._moved_bytes(8192, 8192, 32, 8)
    assert got["temp"] == 8256 * (2 * 260 + 30 * 264) * 4
    assert got["power"] == got["out"] == 8192 * 8192 * 4


def _constant(source, name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", source)
    assert m, name
    return m.group(1)


def test_constants_match_the_kernel_source():
    """TILE_COLS, OFF, WIN, DROP_OFF_ROWS and the carry's bytes are the
    CUDA source's HOTSPOT_TILE_COLS, kHsOff, kHsWin, kHsDropOffRows and
    kHsCarry; a tile has a column a thread (kThreads)."""
    src = (_CSRC / "hotspot.cu").read_text()
    threads = int(_constant((_CSRC / "async_pipeline.cuh").read_text(),
                            "kThreads"))
    assert int(_constant(src, "HOTSPOT_TILE_COLS")) == TC == threads
    assert int(_constant(src, "kHsOff")) == OFF == 4
    names = {"HOTSPOT_TILE_COLS": TC, "kHsOff": OFF}
    assert eval(_constant(src, "kHsWin"), names) == WIN == TC + 8
    assert int(_constant(src, "kHsDropOffRows")) == hotspot.DROP_OFF_ROWS
    names["kHsWin"] = WIN
    assert eval(_constant(src, "kHsCarry"), names) == hotspot._CARRY
    assert "hotspot_bands_launch" in src


def test_pitched_keeps_a_pitched_view_and_copies_the_rest():
    base = torch.rand(6, 132)
    for t in (base, base[:, :130], base[:, :129], base[2:, :128],
              base[:, 4:130], base.view(torch.int32)[:, :5]):
        got = hotspot._pitched(t)
        assert got is t and got.data_ptr() == t.data_ptr()
    for t in (torch.rand(6, 126), base[:, 1:130], base.t()[:6],
              torch.rand(6, 8)[:, ::2],
              torch.rand(6 * 128 - 2).as_strided((6, 126), (128, 1))):
        got = hotspot._pitched(t)
        assert got.data_ptr() != t.data_ptr()
        assert tuple(got.shape) == tuple(t.shape) and got.stride(1) == 1
        assert got.stride(0) == _round4(t.shape[1])
        assert got.data_ptr() % 16 == 0
        assert torch.equal(got, t)


def _layout(strategy, depth, out_depth, tile_rows):
    """hotspot_smem: the ring (one slot for SYNC) of temperature rows of
    WIN and power rows of TILE_COLS floats, the out ring, TMA's
    mbarriers, then the carry (2 x 2 rows of WIN) at the next 16 bytes."""
    slot = tile_rows * (WIN + TC) * 4
    ring = (1 if strategy is Strategy.SYNC else depth) * slot
    bars = 8 * depth if strategy is Strategy.TMA else 0
    head = ring + out_depth * tile_rows * TC * 4 + bars
    return (head + 15) // 16 * 16 + 2 * 2 * WIN * 4


@pytest.mark.parametrize("strategy", list(Strategy))
@pytest.mark.parametrize("tile_rows", [1, 2, 8, 9, 16, 24, 33, 37, 64])
def test_card_refusals_match_the_layout(strategy, tile_rows):
    """check_card_config, and the wrapper's check of a CUDA call, refuse
    exactly DROP_OFF above its 8 register rows and a layout past a block's
    shared memory; _smem is the launcher's layout."""
    cuda = types.SimpleNamespace(shape=(8 * tile_rows, 300),
                                 device=torch.device("cuda"),
                                 dtype=torch.float32)
    for depth in (1, 2, 3, 4):
        for out_depth in (1, 2, 4):
            spec = PipelineSpec(strategy, depth, None, out_depth)
            layout = _layout(strategy, spec.ring_depth, out_depth, tile_rows)
            assert hotspot._smem(spec, tile_rows) == layout
            refused = layout > SMEM_PER_BLOCK or (
                strategy is Strategy.DROP_OFF and tile_rows > 8)
            for check in (lambda: hotspot.check_card_config(spec, tile_rows),
                          lambda: hotspot._check(cuda, cuda, spec, tile_rows,
                                                 8)):
                if refused:
                    with pytest.raises(ValueError):
                        check()
                else:
                    check()


def test_h100_cell_fits_four_blocks_an_sm():
    """The h100 cell's overlap layout (depth 2, out_depth 2, tile_rows 8):
    53.9 KB a block, four of them in an SM's 228 KB."""
    smem = hotspot._smem(PipelineSpec(Strategy.OVERLAP), 8)
    assert smem == 2 * 8 * (WIN + TC) * 4 + 2 * 8 * TC * 4 + 4 * WIN * 4
    assert 4 * (smem + 1024) <= 233_472
