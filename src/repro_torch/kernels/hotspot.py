"""Rodinia hotspot: the 5-point thermal stencil on an edge-replicated field.

The counterpart of ``repro.kernels.hotspot`` (``hotspot_step_pallas``,
``hotspot_pallas``).  ``hotspot_step_cuda`` launches ``csrc/hotspot.cu`` for
CUDA tensors and computes ``hotspot_step_plain`` for CPU tensors; nothing
else reaches the plain version.  ``LAUNCHES`` counts kernel launches, one a
step and no other device work.

On the card a block is one row band (``grid`` bands, as in the reference)
times one column tile of ``TILE_COLS`` columns, one a thread.  The kernel
reads the caller's temperature itself and replicates its edges by selects
on the index; a block reads each temperature row of its band once,
carrying the two rows above a tile over from the tile before.  The copies
move 16-byte units: a tile's temperature rows are the window of ``WIN``
columns from ``OFF`` left of it, cut to the row, and every array needs a
row pitch of at least round4(C) floats, a multiple of 4 (``_pitched``).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..core.async_pipeline import (ALL_STRATEGIES, SMEM_PER_BLOCK,
                                   PipelineSpec, Strategy, as_spec,
                                   smem_budget)
from . import _build

__all__ = ["hotspot_step_cuda", "hotspot_cuda", "hotspot_step_plain",
           "check_card_config", "LAUNCHES", "TILE_COLS",
           "OFF", "WIN", "DROP_OFF_ROWS"]

#: kernel launches so far (the count chip_smoke.py reads around a run)
LAUNCHES = 0

#: the constants of csrc/hotspot.cu: HOTSPOT_TILE_COLS columns a tile (one
#: a thread); kHsOff, the columns a tile's window reaches past it on each
#: side (the slot column of its first column, but 0 at column 0); kHsWin,
#: floats a temperature row in shared memory; kHsDropOffRows, the rows
#: DROP_OFF holds in registers
TILE_COLS = 256
OFF = 4
WIN = TILE_COLS + 2 * OFF
DROP_OFF_ROWS = 8
#: bytes of the carry after the pipeline's (kHsCarry): 2 buffers x 2 rows
_CARRY = 2 * 2 * WIN * 4


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def hotspot_step_plain(temp: torch.Tensor, power: torch.Tensor, *,
                       rx: float = 0.1, ry: float = 0.1, rz: float = 0.5,
                       cap: float = 0.5) -> torch.Tensor:
    """One step in plain torch, on the same replicate padding."""
    tpad = F.pad(temp[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    t = tpad[1:-1, 1:-1]
    up, down = tpad[:-2, 1:-1], tpad[2:, 1:-1]
    left, right = tpad[1:-1, :-2], tpad[1:-1, 2:]
    delta = cap * (power + (up + down - 2.0 * t) * ry
                   + (left + right - 2.0 * t) * rx
                   + (80.0 - t) * rz)
    return t + delta


def _pitched(t: torch.Tensor) -> torch.Tensor:
    """A 2-D tensor of 4-byte elements whose rows the kernels can copy in
    16-byte units: ``t`` itself, a strided view included, where its rows
    start on 16 bytes at a pitch of at least round4(C) elements, a
    multiple of 4, with round4(C) elements of storage from each row's
    start; else a copy with rows of round4(C).  Pathfinder and nw use it
    too."""
    rows, cols = t.shape
    w = _round4(cols)
    if cols == w and t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t                # the common case, without the storage reads
    if t.stride(1) == 1 and t.stride(0) % 4 == 0 and t.stride(0) >= w \
            and t.data_ptr() % 16 == 0 and t.storage_offset() \
            + (rows - 1) * t.stride(0) + w \
            <= t.untyped_storage().nbytes() // t.element_size():
        return t
    buf = t.new_empty((rows, w))
    buf[:, :cols] = t
    return buf[:, :cols]


def _moved_bytes(rows: int, cols: int, grid: int, tile_rows: int) -> dict:
    """The bytes one step's copies request, by array: temperature, each
    band's rows and the two above it (the first band's top row twice) in
    each column tile's window; power and the output, round4 of each
    column tile's columns a row."""
    temp = power = 0
    for c0 in range(0, cols, TILE_COLS):
        ws, we = max(c0 - OFF, 0), min(c0 + TILE_COLS + OFF, _round4(cols))
        temp += (rows + 2 * grid) * (we - ws) * 4
        power += rows * _round4(min(TILE_COLS, cols - c0)) * 4
    return {"temp": temp, "power": power, "out": power}


def _check(temp: torch.Tensor, power: torch.Tensor, spec: PipelineSpec,
           tile_rows: int, grid: int) -> int:
    """Validate one call; returns the tiles per row band."""
    rows, cols = temp.shape
    if tuple(power.shape) != (rows, cols):
        raise ValueError(f"power {tuple(power.shape)} != temp {(rows, cols)}")
    if grid < 1 or tile_rows < 1 or rows % (grid * tile_rows):
        raise ValueError(f"rows={rows} not divisible by grid*tile_rows")
    if temp.device.type == "cpu" and power.device.type == "cpu":
        return rows // grid // tile_rows
    if temp.device.type != "cuda" or power.device != temp.device:
        raise ValueError(f"hotspot takes temp and power on one CPU or CUDA "
                         f"device, got {temp.device} and {power.device}")
    if temp.dtype != torch.float32 or power.dtype != torch.float32:
        raise ValueError("hotspot kernel is built for float32")
    check_card_config(spec, tile_rows)
    return rows // grid // tile_rows


def check_card_config(spec: PipelineSpec, tile_rows: int) -> None:
    """Raise ``ValueError`` for a (spec, tile_rows) the card refuses:
    DROP_OFF above the rows it holds in registers, a layout past a
    block's shared memory.  Callable on the CPU."""
    if spec.strategy is Strategy.DROP_OFF and tile_rows > DROP_OFF_ROWS:
        raise ValueError(f"DROP_OFF holds {DROP_OFF_ROWS} rows per thread "
                         f"in registers: tile_rows must be <= "
                         f"{DROP_OFF_ROWS}")
    smem = _smem(spec, tile_rows)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"{spec} at tile_rows={tile_rows} needs {smem} "
                         f"bytes of shared memory > {SMEM_PER_BLOCK}")


@functools.lru_cache(maxsize=None)
def _smem(spec: PipelineSpec, tile_rows: int) -> int:
    """run_pipeline's ring (a slot: tile_rows temperature rows of WIN and
    power rows of TILE_COLS floats), out ring and barriers, then the
    carry at the next 16 bytes: hotspot_smem in csrc/hotspot.cu."""
    tile = tile_rows * TILE_COLS * 4
    ring = smem_budget(spec, [tile_rows * WIN * 4, tile], tile).card
    return (ring + 15) // 16 * 16 + _CARRY


def _launch(temp_p: torch.Tensor, power_p: torch.Tensor, spec: PipelineSpec,
            tile_rows: int, n_tiles: int, rx: float, ry: float, rz: float,
            cap: float) -> torch.Tensor:
    """One kernel step on 16-byte-pitched temperature and power.  Returns
    the (R, C) view of an (R, round4(C)) output, which the next step reads
    in place."""
    global LAUNCHES
    rows, cols = temp_p.shape
    out = temp_p.new_empty((rows, _round4(cols)))
    lib = _build.library("hotspot")
    rc = lib.hotspot_bands_launch(
        temp_p.device.index or 0, ALL_STRATEGIES.index(spec.strategy),
        spec.ahead, spec.out_depth, spec.ring_depth, temp_p.data_ptr(),
        temp_p.stride(0), power_p.data_ptr(), power_p.stride(0),
        out.data_ptr(), out.stride(0), rows, cols, tile_rows, n_tiles,
        TILE_COLS, rx, ry, rz, cap, _smem(spec, tile_rows),
        torch.cuda.current_stream(temp_p.device).cuda_stream)
    _build.check(lib, rc, f"hotspot kernel launch ({spec})")
    LAUNCHES += 1
    return out if out.shape[1] == cols else out[:, :cols]


def hotspot_step_cuda(temp: torch.Tensor, power: torch.Tensor, *,
                      spec: PipelineSpec = PipelineSpec(),
                      tile_rows: int = 8, rx: float = 0.1, ry: float = 0.1,
                      rz: float = 0.5, cap: float = 0.5,
                      grid: int = 1) -> torch.Tensor:
    """One hotspot iteration.  temp/power: (R, C); R divisible by
    grid*tile_rows."""
    return hotspot_cuda(temp, power, iters=1, spec=spec, tile_rows=tile_rows,
                        rx=rx, ry=ry, rz=rz, cap=cap, grid=grid)


def hotspot_cuda(temp: torch.Tensor, power: torch.Tensor, *, iters: int,
                 spec: PipelineSpec = PipelineSpec(), tile_rows: int = 8,
                 rx: float = 0.1, ry: float = 0.1, rz: float = 0.5,
                 cap: float = 0.5, grid: int = 1) -> torch.Tensor:
    """``iters`` steps (the host loop of ``hotspot_pallas``)."""
    spec = as_spec(spec)
    n_tiles = _check(temp, power, spec, tile_rows, grid)
    if temp.device.type == "cpu":
        for _ in range(iters):
            temp = hotspot_step_plain(temp, power, rx=rx, ry=ry, rz=rz,
                                      cap=cap)
        return temp
    power_p = _pitched(power)
    for _ in range(iters):
        temp = _launch(_pitched(temp), power_p, spec, tile_rows, n_tiles, rx,
                       ry, rz, cap)
    return temp.contiguous()
