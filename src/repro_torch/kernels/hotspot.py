"""Rodinia hotspot: the 5-point thermal stencil on an edge-replicated field.

The counterpart of ``repro.kernels.hotspot`` (``hotspot_step_pallas``,
``hotspot_pallas``).  ``hotspot_step_cuda`` launches ``csrc/hotspot.cu`` for
CUDA tensors and computes ``hotspot_step_plain`` for CPU tensors; nothing
else reaches the plain version.  ``LAUNCHES`` counts kernel launches.

On the card a block is one row band (``grid`` bands, as in the reference)
times one column tile of ``TILE_COLS`` columns.  The copies move 16-byte
units, so the wrapper pads temperature into rows of ``round4(C + 2)``
floats and gives power and the output rows of ``round4(C)`` floats.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.async_pipeline import (ALL_STRATEGIES, SMEM_PER_BLOCK,
                                   PipelineSpec, Strategy, as_spec,
                                   smem_budget)
from . import _build

__all__ = ["hotspot_step_cuda", "hotspot_cuda", "hotspot_step_plain",
           "LAUNCHES", "TILE_COLS"]

#: kernel launches so far (the count chip_smoke.py reads around a run)
LAUNCHES = 0

#: columns per tile; equals HOTSPOT_TILE_COLS in csrc/hotspot.cu
TILE_COLS = 256

#: DROP_OFF holds this many cells per thread in registers
_DROP_OFF_CELLS = 8
_THREADS = 256


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


def _pad_edge(temp: torch.Tensor) -> torch.Tensor:
    """temp (R, C) -> (R+2, round4(C+2)) with replicated edges; the columns
    past C+1 are row padding the kernel never reads into a kept cell."""
    rows, cols = temp.shape
    buf = temp.new_empty((rows + 2, _round4(cols + 2)))
    buf[1:rows + 1, 1:cols + 1] = temp
    buf[0, 1:cols + 1] = temp[0]
    buf[rows + 1, 1:cols + 1] = temp[rows - 1]
    buf[:, 0] = buf[:, 1]
    buf[:, cols + 1] = buf[:, cols]
    return buf


def _pitched(power: torch.Tensor) -> torch.Tensor:
    """power with a row pitch of round4(C) floats (a view when it has one)."""
    rows, cols = power.shape
    if cols % 4 == 0 and power.is_contiguous() and power.data_ptr() % 16 == 0:
        return power
    buf = power.new_empty((rows, _round4(cols)))
    buf[:, :cols] = power
    return buf


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
    if spec.strategy is Strategy.DROP_OFF and \
            tile_rows * TILE_COLS > _DROP_OFF_CELLS * _THREADS:
        raise ValueError(f"DROP_OFF holds {_DROP_OFF_CELLS} cells per thread "
                         f"in registers: tile_rows must be <= "
                         f"{_DROP_OFF_CELLS * _THREADS // TILE_COLS}")
    smem = _smem(spec, tile_rows)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"{spec} at tile_rows={tile_rows} needs {smem} "
                         f"bytes of shared memory > {SMEM_PER_BLOCK}")
    return rows // grid // tile_rows


def _smem(spec: PipelineSpec, tile_rows: int) -> int:
    halo = (tile_rows + 2) * (TILE_COLS + 4) * 4
    tile = tile_rows * TILE_COLS * 4
    return smem_budget(spec, [halo, tile], tile).card


def _launch(temp: torch.Tensor, power_p: torch.Tensor, spec: PipelineSpec,
            tile_rows: int, n_tiles: int, rx: float, ry: float, rz: float,
            cap: float) -> torch.Tensor:
    """One kernel step; power_p already has a 16-byte row pitch.  Returns
    the (R, C) view of an (R, round4(C)) output."""
    global LAUNCHES
    rows, cols = temp.shape
    tpad = _pad_edge(temp)
    out = temp.new_empty((rows, _round4(cols)))
    lib = _build.library("hotspot")
    rc = lib.hotspot_step_launch(
        temp.device.index or 0, ALL_STRATEGIES.index(spec.strategy),
        spec.ahead, spec.out_depth, spec.ring_depth, tpad.data_ptr(),
        tpad.stride(0), power_p.data_ptr(), power_p.stride(0),
        out.data_ptr(), out.stride(0), rows, cols, tile_rows, n_tiles,
        TILE_COLS, rx, ry, rz, cap, _smem(spec, tile_rows),
        torch.cuda.current_stream(temp.device).cuda_stream)
    _build.check(lib, rc, f"hotspot kernel launch ({spec})")
    LAUNCHES += 1
    return out[:, :cols]


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
        temp = _launch(temp, power_p, spec, tile_rows, n_tiles, rx, ry, rz,
                       cap)
    return temp.contiguous()
