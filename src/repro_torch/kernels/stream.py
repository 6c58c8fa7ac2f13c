"""Paper section 4.1 microbenchmark: f(x) = 0.5 x + 0.5 applied ``iters`` times.

The counterpart of ``repro.kernels.stream`` (``stream_pallas``,
``stream_flops_bytes``).  ``stream_cuda`` launches ``csrc/stream.cu`` for a
CUDA tensor and computes ``stream_plain`` for a CPU tensor; nothing else
reaches the plain version.  ``LAUNCHES`` counts kernel launches.

On the card a block is one row band (``n_tiles`` tiles of ``tile_rows``
rows, streamed through the strategy's ring) times one column tile of
``TILE_COLS`` columns.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.async_pipeline import (ALL_STRATEGIES, SMEM_PER_BLOCK,
                                   PipelineSpec, Strategy, as_spec,
                                   smem_budget)
from . import _build

__all__ = ["stream_cuda", "stream_plain", "stream_flops_bytes", "LAUNCHES",
           "TILE_COLS"]

#: kernel launches so far (the count chip_smoke.py reads around a run)
LAUNCHES = 0

#: columns per tile; equals STREAM_TILE_COLS in csrc/stream.cu
TILE_COLS = 256

#: DROP_OFF holds a thread's share of a tile in this many 16-byte registers
_DROP_OFF_CHUNKS = 8
_THREADS = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def stream_plain(x: torch.Tensor, iters: int = 1) -> torch.Tensor:
    """The kernel's function in plain torch, in the input's dtype (bf16
    rounds after every iteration, as the kernel does)."""
    for _ in range(iters):
        x = x * 0.5 + 0.5
    return x


def stream_cuda(x: torch.Tensor, *, iters: int = 1,
                spec: PipelineSpec = PipelineSpec(), tile_rows: int = 8,
                n_tiles: int = 4) -> torch.Tensor:
    """Run the microbenchmark kernel.  x: (rows, width); rows must equal
    g * n_tiles * tile_rows for an integer g.  Invalid shapes and configs
    raise ``ValueError``; a failed build or launch raises ``RuntimeError``."""
    global LAUNCHES
    spec = as_spec(spec)
    rows, width = x.shape
    block = n_tiles * tile_rows
    if tile_rows < 1 or n_tiles < 1 or rows % block:
        raise ValueError(
            f"rows={rows} not divisible by n_tiles*tile_rows={block}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if x.device.type == "cpu":
        return stream_plain(x, iters)
    if x.device.type != "cuda":
        raise ValueError(f"stream_cuda takes a CPU or CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"stream kernel is built for float32 and bfloat16, "
                         f"not {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("stream kernel needs a contiguous, 16-byte aligned "
                         "input")
    isz = x.element_size()
    if (width * isz) % 16:
        raise ValueError(f"row of {width * isz} bytes is not a multiple of "
                         f"16 (cp.async and bulk copies move 16-byte units)")
    tile = tile_rows * TILE_COLS * isz
    if spec.strategy is Strategy.DROP_OFF and \
            tile > _DROP_OFF_CHUNKS * _THREADS * 16:
        raise ValueError(f"DROP_OFF holds at most "
                         f"{_DROP_OFF_CHUNKS * _THREADS * 16} tile bytes in "
                         f"registers, tile_rows={tile_rows} needs {tile}")
    smem = smem_budget(spec, [tile], tile).card
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"{spec} at tile_rows={tile_rows} needs {smem} "
                         f"bytes of shared memory > {SMEM_PER_BLOCK}")
    out = torch.empty_like(x)
    lib = _build.library("stream")
    rc = lib.stream_launch(
        x.device.index or 0, ALL_STRATEGIES.index(spec.strategy), spec.ahead,
        spec.out_depth, spec.ring_depth, _DTYPES[x.dtype], x.data_ptr(),
        out.data_ptr(), rows, width, tile_rows, n_tiles, iters, TILE_COLS,
        smem, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, f"stream kernel launch ({spec})")
    LAUNCHES += 1
    return out


def stream_flops_bytes(x_shape: Tuple[int, int], iters: int,
                       dtype_bytes: int = 4) -> Tuple[float, float]:
    """Analytic flops/bytes: 2 flops per element per iteration; one read +
    one write per element."""
    n = float(x_shape[0] * x_shape[1])
    return 2.0 * n * iters, 2.0 * n * dtype_bytes
