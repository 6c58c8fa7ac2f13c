"""Rodinia pathfinder: the int32 row DP, as one persistent launch of spans.

The counterpart of ``repro.kernels.pathfinder`` (``pathfinder_pallas``).
``pathfinder_cuda`` launches ``csrc/pathfinder.cu`` for a CUDA tensor and
computes ``pathfinder_plain`` for a CPU tensor; nothing else reaches the
plain version.  ``LAUNCHES`` counts kernel launches.

The reference is one program that carries the whole DP row.  On the card
one cooperative launch (``LAUNCHES_PER_CALL``) runs at most as many blocks
as the card holds at once; ``plan`` cuts the row into spans of at least
``SPAN_MIN[strategy]`` columns, one a block (or, past what the blocks
hold, several a block, walked in turn by tile row).  Each block walks
every DP row of its span as one tile stream, with ``HALO`` more columns
on each side: every ``HALO`` rows (a step) it hands the ``HALO`` edge
columns of its span to its neighbours through ``workspace``'s edge
buffer, each value tagged with its step, and takes theirs.  In a block, a
lane holds ``COLS`` columns and a warp trades ``GHOST`` columns with its
neighbours every ``GHOST`` rows.  The reference's pipeline has no
write-back ring, so the spec's ``out_depth`` is not used here.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.async_pipeline import (ALL_STRATEGIES, SMEM_PER_BLOCK,
                                   PipelineSpec, Strategy, as_spec,
                                   smem_budget)
from . import _build
from .hotspot import _pitched, _round4
from .ref import pathfinder_ref

__all__ = ["pathfinder_cuda", "pathfinder_plain", "plan", "region_cap",
           "workspace", "tiles", "check_card_config", "Plan", "LAUNCHES",
           "LAUNCHES_PER_CALL", "COLS", "GHOST", "HALO", "REGION",
           "SPAN_MIN", "MAX_TILE_ROWS"]

#: kernel launches so far (the count chip_smoke.py reads around a run)
LAUNCHES = 0
#: kernel launches of one pathfinder_cuda call on the card
LAUNCHES_PER_CALL = 1

#: the constants of csrc/pathfinder.cu: PF_COLS columns a lane; PF_GHOST
#: ghost columns on each side of a warp (and DP rows between the warps'
#: exchanges); PF_HALO halo columns on each side of a span (and DP rows a
#: step); PF_REGION, a span and its halos at most (8 warps of PF_WARP_COLS
#: owned columns); kPfTileRows, rows of a tile at most
COLS = 4
GHOST = 16
HALO = 32
WARP_COLS = 32 * COLS - 2 * GHOST
REGION = 8 * WARP_COLS
MAX_TILE_ROWS = 64

#: the narrowest span but the last, by strategy.  A block of OVERLAP,
#: DROP_OFF or TMA keeps its next copies in flight while it computes, and
#: fewer, wider spans cut the halo's share: at 100,000 columns 384 (two
#: blocks an SM) beat 192 (four) by 15-20% at overlap and tma (PERF.md §6,
#: `twoper`).  A block of SYNC or REGISTER_BYPASS waits out each
#: tile's load, which only other blocks of its SM hide: there four an SM
#: beat two by 4-14%, and the span stays as narrow as the blocks allow.
SPAN_MIN = {Strategy.SYNC: 128, Strategy.REGISTER_BYPASS: 128,
            Strategy.OVERLAP: 384, Strategy.DROP_OFF: 384, Strategy.TMA: 384}

#: DROP_OFF holds this many rows of its columns per thread in registers
_DROP_OFF_ROWS = 16
#: bytes after the pipeline's: the warps' edge buffers (kPfExtra)
_EXTRA = 2 * 8 * 2 * GHOST * 4


class Plan(NamedTuple):
    """One launch's spans: ``span`` columns each (the last may be
    ragged), ``n_spans`` of them over ``grid`` blocks, ``m`` a block
    (block b walks spans b, b + grid, ...)."""
    span: int
    n_spans: int
    grid: int
    m: int


def pathfinder_plain(wall: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: the (1, cols) last DP row."""
    return pathfinder_ref(wall)[None]


def _smem_at(spec: PipelineSpec, tile_rows: int, region: int) -> int:
    """run_pipeline's ring (no out ring) for tiles of ``region`` columns,
    then the warps' edge buffers at the next 16 bytes."""
    ring = smem_budget(spec, [tile_rows * region * 4], 0).card
    return (ring + 15) // 16 * 16 + _EXTRA


@functools.lru_cache(maxsize=None)
def region_cap(spec: PipelineSpec, tile_rows: int) -> int:
    """The widest region (a span and its two halos, a multiple of 4 up to
    ``REGION``) whose ring fits a block's shared memory."""
    region = REGION
    while region > 0 and _smem_at(spec, tile_rows, region) > SMEM_PER_BLOCK:
        region -= 4
    return region


def _smem(spec: PipelineSpec, tile_rows: int) -> int:
    """The launch's shared memory: the layout at ``region_cap``, whatever
    the plan's span, so that the blocks the card holds at once (and so the
    plan) follow from the spec alone."""
    return _smem_at(spec, tile_rows, region_cap(spec, tile_rows))


def plan(cols: int, blocks: int, region: int = REGION,
         span_min: int = 128) -> Plan:
    """The spans of one launch for ``cols`` columns on a card that holds
    ``blocks`` blocks at once, regions at most ``region`` wide: a span
    of round4(cols / blocks), at least ``span_min`` and at most the widest
    the region leaves; one a block while they fit the blocks, else the
    widest, ``m`` a block."""
    widest = (region - 2 * HALO) // 4 * 4
    span = min(max(_round4(-(-cols // blocks)), span_min), widest)
    n = -(-cols // span)
    if n <= blocks:
        return Plan(span, n, n, 1)
    return Plan(span, n, blocks, -(-n // blocks))


def workspace(p: Plan, device) -> Tuple[torch.Tensor,
                                        Optional[torch.Tensor]]:
    """The kernel's scratch for one call: the edge buffer (by span, two
    parities x two sides x HALO (value, step) pairs, an int64 each, zero:
    no step yet) and, for m > 1, the lanes' saved columns (by span, 256
    lanes x COLS int32)."""
    spans = p.grid * p.m
    edges = torch.zeros(spans * 4 * HALO, dtype=torch.int64, device=device)
    save = None if p.m == 1 else torch.empty(
        (spans * 256, COLS), dtype=torch.int32, device=device)
    return edges, save


def tiles(wall: torch.Tensor, p: Plan, tile_rows: int) -> torch.Tensor:
    """For m > 1: rows 1.. of the wall as the kernel walks them,
    [tile row][span][tile_rows][region] over grid * m spans (span j at
    index j, block b's tile i at i * grid + b), each span's region from
    HALO columns left of it, zero past the array."""
    rows = wall.shape[0]
    cols = min(wall.shape[1], p.n_spans * p.span)
    region = p.span + 2 * HALO
    spans = p.grid * p.m
    padded = wall.new_zeros((rows - 1, spans * p.span + 2 * HALO))
    padded[:, HALO:HALO + cols] = wall[1:, :cols]
    win = padded.unfold(1, region, p.span)[:, :spans]
    return win.reshape((rows - 1) // tile_rows, tile_rows, spans,
                       region).permute(0, 2, 1, 3).contiguous()


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
    check_card_config(spec, tile_rows)


def check_card_config(spec: PipelineSpec, tile_rows: int) -> None:
    """Raise ``ValueError`` for a (spec, tile_rows) the card refuses: more
    than MAX_TILE_ROWS rows a tile, DROP_OFF above the rows it holds in
    registers, a ring that leaves no region of a HALO-wide span and its
    halos.  Callable on the CPU."""
    if tile_rows > MAX_TILE_ROWS:
        raise ValueError(f"a tile has at most MAX_TILE_ROWS={MAX_TILE_ROWS} "
                         f"rows: tile_rows={tile_rows} must be <= "
                         f"{MAX_TILE_ROWS}")
    if spec.strategy is Strategy.DROP_OFF and tile_rows > _DROP_OFF_ROWS:
        raise ValueError(f"DROP_OFF holds {_DROP_OFF_ROWS} rows per thread "
                         f"in registers: tile_rows must be <= "
                         f"{_DROP_OFF_ROWS}")
    if region_cap(spec, tile_rows) < 3 * HALO:
        raise ValueError(f"{spec} at tile_rows={tile_rows} needs "
                         f"{_smem_at(spec, tile_rows, 3 * HALO)} bytes of "
                         f"shared memory > {SMEM_PER_BLOCK}")


#: (device, strategy, ahead, smem) -> blocks the card holds at once
_BLOCKS = {}


def _blocks(lib, spec: PipelineSpec, smem: int, device) -> int:
    key = (device.index or 0, spec.strategy, spec.ahead, smem, id(lib))
    if key not in _BLOCKS:
        n = ctypes.c_int(0)
        _build.check(lib, lib.pathfinder_blocks(
            key[0], ALL_STRATEGIES.index(spec.strategy), spec.ahead, smem,
            ctypes.byref(n)), f"pathfinder_blocks ({spec})")
        if n.value < 1:
            raise RuntimeError(f"pathfinder at {smem} bytes of shared memory "
                               f"fits no block on {device}")
        _BLOCKS[key] = n.value
    return _BLOCKS[key]


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
    dev = wall.device
    w = _pitched(wall)
    lib = _build.library("pathfinder")
    smem = _smem(spec, tile_rows)
    p = plan(cols, _blocks(lib, spec, smem, dev), region_cap(spec, tile_rows),
             SPAN_MIN[spec.strategy])
    out = wall.new_empty((1, _round4(cols)))
    edges, save = workspace(p, dev)
    laid = tiles(w, p, tile_rows) if p.m > 1 else None
    launched = ctypes.c_int(0)
    rc = lib.pathfinder_spans_launch(
        dev.index or 0, ALL_STRATEGIES.index(spec.strategy), spec.ahead,
        spec.ring_depth, w.data_ptr(), w.stride(0), rows, cols, tile_rows,
        p.span, p.grid, p.m, None if laid is None else laid.data_ptr(),
        out.data_ptr(), edges.data_ptr(), edges.numel(),
        None if save is None else save.data_ptr(), smem,
        ctypes.byref(launched), torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES += launched.value
    _build.check(lib, rc, f"pathfinder_spans_launch ({spec})")
    if launched.value != LAUNCHES_PER_CALL:
        raise RuntimeError(f"pathfinder_spans_launch enqueued "
                           f"{launched.value} launches, not "
                           f"{LAUNCHES_PER_CALL}")
    return out[:, :cols]
