"""Rodinia Needleman-Wunsch: the DP table as one launch of column strips.

The counterpart of ``repro.kernels.nw`` (``nw_pallas``, ``_cummax``).
``nw_cuda`` launches ``csrc/nw.cu`` for a CUDA tensor and computes
``nw_plain`` for a CPU tensor; nothing else reaches the plain version.
``LAUNCHES`` counts kernel launches.

``nw_plain`` is the reference's row formulation: each row is
c[j] = max(m[i-1, j-1] + s, m[i-1, j] - p), then a max-plus prefix scan
(``torch.cummax`` of c + j p, less j p).  On the card one launch
(``LAUNCHES_PER_CALL``) runs ``strips(n)`` blocks, each a strip of
``STRIP`` columns (one a thread) walked from row 1 to row n as one tile
stream; each row is the same recurrence, its scan seeded with the left
strip's last column.  A block takes its strip from a ticket in the order
blocks start, so it waits only on a strip that is running.  The left
strip hands its last column over through an edge buffer that starts as
NaN, so that each value is its own flag, and the right strip reads a
tile's seeds a tile ahead; a wait longer than a second traps, so a fault
fails the launch instead of hanging it.  ``workspace`` allocates the
ticket (zero) and the edge buffer (NaN) for each call.

The kernel writes a pitched table whose row holds column j at float 3 + j,
so that every strip's first column, and its scores, start on 16 bytes;
``nw_cuda`` returns the (n+1, n+1) view of it.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.async_pipeline import (ALL_STRATEGIES, SMEM_PER_BLOCK,
                                   PipelineSpec, Strategy, as_spec,
                                   smem_budget)
from . import _build
from .hotspot import _pitched

__all__ = ["nw_cuda", "nw_plain", "strips", "workspace", "check_card_config",
           "LAUNCHES", "LAUNCHES_PER_CALL", "STRIP", "MAX_TILE_ROWS"]

#: kernel launches so far (the count chip_smoke.py reads around a run)
LAUNCHES = 0
#: kernel launches of one nw_cuda call on the card
LAUNCHES_PER_CALL = 1

#: columns of a strip, one a thread (NW_STRIP in csrc/nw.cu); rows of a
#: tile, at most (kNwTileRows)
STRIP = 256
MAX_TILE_ROWS = 64

#: DROP_OFF holds one score a row, this many rows, in registers
_DROP_OFF_ROWS = 16
#: bytes of shared memory after the pipeline's: two sets of the eight
#: warps' maxima, the tile's seeds and the strip index (padded to 16)
_EXTRA = (2 * 8 + MAX_TILE_ROWS) * 4 + 16
#: the table's first column sits this many floats into its row
_COL0 = 3


def nw_plain(seq_scores: torch.Tensor, penalty: int) -> torch.Tensor:
    """The (n+1, n+1) f32 table, row by row as the reference's kernel
    computes it."""
    n = seq_scores.shape[0]
    s = seq_scores.to(torch.float32)
    pj = penalty * torch.arange(n + 1, dtype=torch.float32,
                                device=s.device)
    table = torch.empty((n + 1, n + 1), dtype=torch.float32, device=s.device)
    table[0] = -pj
    c = torch.empty(n + 1, dtype=torch.float32, device=s.device)
    for i in range(1, n + 1):
        prev = table[i - 1]
        c[0] = -penalty * i
        torch.maximum(prev[:-1] + s[i - 1], prev[1:] - penalty, out=c[1:])
        table[i] = torch.cummax(c + pj, 0).values - pj
    return table


def strips(n: int) -> int:
    """Blocks of one launch: the table's column strips."""
    return -(-n // STRIP)


def workspace(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's scratch for one call: the ticket (one int32, zero) and
    the edge buffer (each strip's last column by row, strips(n) x n f32,
    NaN until the kernel writes it)."""
    return (torch.zeros(1, dtype=torch.int32, device=device),
            torch.full((strips(n) * n,), float("nan"), device=device))


def _smem(spec: PipelineSpec, tile_rows: int) -> int:
    """run_pipeline's ring and out ring for a (tile_rows, STRIP) tile, then
    the warp maxima, seeds and strip index at the next 16 bytes."""
    tile = tile_rows * STRIP * 4
    ring = smem_budget(spec, [tile], tile).card
    return (ring + 15) // 16 * 16 + _EXTRA


def _check(seq_scores: torch.Tensor, spec: PipelineSpec,
           tile_rows: int) -> int:
    if seq_scores.dim() != 2 or seq_scores.shape[0] != seq_scores.shape[1]:
        raise ValueError(f"nw takes an (n, n) score matrix, got "
                         f"{tuple(seq_scores.shape)}")
    n = seq_scores.shape[0]
    if tile_rows < 1 or n % tile_rows:
        raise ValueError(f"n={n} must divide tile_rows={tile_rows}")
    if seq_scores.device.type == "cpu":
        return n
    if seq_scores.device.type != "cuda":
        raise ValueError(f"nw takes a CPU or CUDA tensor, got "
                         f"{seq_scores.device}")
    check_card_config(seq_scores.dtype, spec, tile_rows)
    return n


def check_card_config(dtype: torch.dtype, spec: PipelineSpec,
                      tile_rows: int) -> None:
    """Raise ``ValueError`` for what the card's kernel refuses: scores that
    are not floats, more than MAX_TILE_ROWS rows a tile, DROP_OFF above the
    rows it holds in registers, a ring past a block's shared memory.
    Callable on the CPU."""
    if not dtype.is_floating_point:
        raise ValueError(f"nw takes float scores, not {dtype}")
    if tile_rows > MAX_TILE_ROWS:
        raise ValueError(f"a tile has at most MAX_TILE_ROWS={MAX_TILE_ROWS} "
                         f"rows: tile_rows={tile_rows} must be <= "
                         f"{MAX_TILE_ROWS}")
    if spec.strategy is Strategy.DROP_OFF and tile_rows > _DROP_OFF_ROWS:
        raise ValueError(f"DROP_OFF holds {_DROP_OFF_ROWS} rows per thread "
                         f"in registers: tile_rows must be <= "
                         f"{_DROP_OFF_ROWS}")
    smem = _smem(spec, tile_rows)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"{spec} at tile_rows={tile_rows} needs {smem} "
                         f"bytes of shared memory > {SMEM_PER_BLOCK}")


def nw_cuda(seq_scores: torch.Tensor, penalty: int, *,
            spec: PipelineSpec = PipelineSpec(Strategy.REGISTER_BYPASS),
            tile_rows: int = 8) -> torch.Tensor:
    """seq_scores: (n, n) similarity matrix, n divisible by tile_rows.
    Returns the (n+1, n+1) f32 DP table (matches ``ref.nw_ref``).  Invalid
    shapes and configs raise ``ValueError``; a failed build or launch
    raises ``RuntimeError``."""
    global LAUNCHES
    spec = as_spec(spec)
    n = _check(seq_scores, spec, tile_rows)
    if seq_scores.device.type == "cpu":
        return nw_plain(seq_scores, penalty)
    s = _pitched(seq_scores.to(torch.float32))
    dev = seq_scores.device
    pitch = (n + _COL0 + 1 + 31) // 32 * 32     # >= round4(n) + 4, 128-byte rows
    table = torch.empty((n + 1, pitch), dtype=torch.float32, device=dev)
    view = table[:, _COL0:_COL0 + n + 1]
    torch.mul(torch.arange(n + 1, dtype=torch.float32, device=dev),
              -penalty, out=view[0])
    ticket, edge = workspace(n, dev)
    lib = _build.library("nw")
    launched = ctypes.c_int(0)
    rc = lib.nw_strips_launch(
        dev.index or 0, ALL_STRATEGIES.index(spec.strategy), spec.ahead,
        spec.out_depth, spec.ring_depth, s.data_ptr(), s.stride(0),
        table.data_ptr(), pitch, n, int(penalty), tile_rows,
        _smem(spec, tile_rows), ticket.data_ptr(), edge.data_ptr(),
        edge.numel(), ctypes.byref(launched),
        torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES += launched.value
    _build.check(lib, rc, f"nw_strips_launch ({spec})")
    if launched.value != LAUNCHES_PER_CALL:
        raise RuntimeError(f"nw_strips_launch enqueued {launched.value} "
                           f"launches, not {LAUNCHES_PER_CALL}")
    return view
