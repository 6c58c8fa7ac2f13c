"""Rodinia pathfinder: the int32 row DP, as a pyramid of strips.

The counterpart of ``repro.kernels.pathfinder`` (``pathfinder_pallas``).
``pathfinder_cuda`` launches ``csrc/pathfinder.cu`` for a CUDA tensor and
computes ``pathfinder_plain`` for a CPU tensor; nothing else reaches the
plain version.  ``LAUNCHES`` counts kernel launches.

The reference is one program that carries the whole DP row.  On the card
block b owns ``STRIP`` columns and keeps ``HALO`` more on each side, so
one launch (a pyramid) can run up to ``HALO`` rows before its owned
columns depend on another block's; one C call (``pathfinder_launch``) runs
the host loop over the pyramids and counts the launches it enqueues.  The
reference's pipeline has no write-back ring, so the spec's ``out_depth`` is
not used here.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.async_pipeline import (ALL_STRATEGIES, SMEM_PER_BLOCK,
                                   PipelineSpec, Strategy, as_spec,
                                   smem_budget)
from . import _build
from .hotspot import _pitched, _round4
from .ref import pathfinder_ref

__all__ = ["pathfinder_cuda", "pathfinder_plain", "pyramids", "LAUNCHES",
           "STRIP", "HALO"]

#: kernel launches so far (the count chip_smoke.py reads around a run)
LAUNCHES = 0

#: columns a block owns, and halo columns on each side (the most rows one
#: launch runs); PF_STRIP and PF_HALO in csrc/pathfinder.cu
STRIP = 256
HALO = 64

#: DROP_OFF holds this many 16-byte chunks per thread in registers
_DROP_OFF_CHUNKS = 8
_THREADS = 256


def pathfinder_plain(wall: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: the (1, cols) last DP row."""
    return pathfinder_ref(wall)[None]


def pyramids(rows: int, tile_rows: int) -> int:
    """Launches of one call: pyramids of the largest multiple of
    ``tile_rows`` up to ``HALO`` rows over the rows - 1 DP rows."""
    return -(-(rows - 1) // (HALO // tile_rows * tile_rows))


def _smem(spec: PipelineSpec, tile_rows: int) -> int:
    """run_pipeline's ring (no out ring) for a tile of the widest strip,
    then the two DP state rows at the next 16 bytes."""
    row = (STRIP + 2 * HALO) * 4
    ring = smem_budget(spec, [tile_rows * row], 0).card
    return (ring + 15) // 16 * 16 + 2 * row


def _check(wall: torch.Tensor, spec: PipelineSpec, tile_rows: int) -> None:
    if wall.dim() != 2:
        raise ValueError(f"wall must be (rows, cols), got {tuple(wall.shape)}")
    rows, cols = wall.shape
    if tile_rows < 1 or (rows - 1) % tile_rows:
        raise ValueError(f"rows-1={rows - 1} must divide "
                         f"tile_rows={tile_rows}")
    if wall.device.type == "cpu":
        return
    if wall.device.type != "cuda":
        raise ValueError(f"pathfinder takes a CPU or CUDA tensor, got "
                         f"{wall.device}")
    if wall.dtype != torch.int32:
        raise ValueError(f"pathfinder kernel is built for int32, not "
                         f"{wall.dtype}")
    if tile_rows > HALO:
        raise ValueError(f"a pyramid runs at most HALO={HALO} rows: "
                         f"tile_rows={tile_rows} must be <= {HALO}")
    chunks = tile_rows * (STRIP + 2 * HALO) // 4
    if spec.strategy is Strategy.DROP_OFF and \
            chunks > _DROP_OFF_CHUNKS * _THREADS:
        raise ValueError(f"DROP_OFF holds {_DROP_OFF_CHUNKS} chunks per "
                         f"thread in registers: tile_rows={tile_rows} needs "
                         f"{chunks} > {_DROP_OFF_CHUNKS * _THREADS}")
    smem = _smem(spec, tile_rows)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"{spec} at tile_rows={tile_rows} needs {smem} "
                         f"bytes of shared memory > {SMEM_PER_BLOCK}")


def pathfinder_cuda(wall: torch.Tensor, *,
                    spec: PipelineSpec = PipelineSpec(Strategy.DROP_OFF),
                    tile_rows: int = 8) -> torch.Tensor:
    """wall: (rows, cols); rows-1 must divide by tile_rows.  Returns the
    (1, cols) final DP row.  Invalid shapes and configs raise
    ``ValueError``; a failed build or launch raises ``RuntimeError``."""
    global LAUNCHES
    spec = as_spec(spec)
    _check(wall, spec, tile_rows)
    if wall.device.type == "cpu":
        return pathfinder_plain(wall)
    rows, cols = wall.shape
    if rows == 1:                       # no DP row: the first row is the result
        return wall.clone()
    w = _pitched(wall)
    rowbuf = wall.new_empty((2, _round4(cols)))
    lib = _build.library("pathfinder")
    launched = ctypes.c_int(0)
    rc = lib.pathfinder_launch(
        wall.device.index or 0, ALL_STRATEGIES.index(spec.strategy),
        spec.ahead, spec.ring_depth, w.data_ptr(), w.stride(0), rows, cols,
        tile_rows, rowbuf.data_ptr(), rowbuf.stride(0),
        _smem(spec, tile_rows), ctypes.byref(launched),
        torch.cuda.current_stream(wall.device).cuda_stream)
    LAUNCHES += launched.value
    _build.check(lib, rc, f"pathfinder_launch ({spec})")
    want = pyramids(rows, tile_rows)
    if launched.value != want:
        raise RuntimeError(f"pathfinder_launch enqueued {launched.value} "
                           f"launches, not the {want} of rows={rows} "
                           f"tile_rows={tile_rows}")
    last = (want - 1) % 2
    return rowbuf[last:last + 1, :cols]
