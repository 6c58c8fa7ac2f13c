"""Analytic cost model and kernel specs for the ported kernels.

The counterpart of ``repro.tuning.search_space`` lines 31-114 plus the
``STREAM`` and ``HOTSPOT`` specs.  The candidate enumeration, pruning and
autotuner come with a later slice.

The cost constants are the reference's, which model the TPU's DMA engines.
None of them has been fitted on the H100 yet; ``predicted_us`` on a port
row is the reference model evaluated with the H100's catalog peaks, not a
measurement.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..core import hardware
from ..core.async_pipeline import Strategy
from ..kernels.stream import stream_flops_bytes

__all__ = ["predict_time", "issue_ahead", "KernelSpec", "SPECS", "KERNELS",
           "STREAM", "HOTSPOT", "ISSUE_S", "DMA_LATENCY_S", "TMA_LATENCY_S",
           "TMA_ISSUE_S", "TMA_BULK_BW_FRAC", "dtype_bytes"]

#: per-tile copy issue overhead (seconds) -- not yet fitted on the H100
ISSUE_S = 1e-6

#: copy latency (seconds) before a copy's first byte lands -- not yet
#: fitted on the H100.  With issue-ahead A, sustained bandwidth is capped by
#: Little's law at A * t_tile / (latency + t_tile) of peak.
DMA_LATENCY_S = 2e-6

#: TMA cost terms (higher per-transaction latency, a fraction of the issue
#: cost, a bulk-bandwidth cap) -- not yet fitted on the H100
TMA_LATENCY_S = 3e-6
TMA_ISSUE_S = 0.25e-6
TMA_BULK_BW_FRAC = 0.93


def issue_ahead(depth: int, wait_group: Optional[int]) -> int:
    """Issue-ahead distance A for a (depth, wait_group) pipeline shape:
    at most A copies are in flight while tile i computes."""
    d = max(depth, 2)
    return d - 1 if wait_group is None else max(0, min(wait_group, d - 1))


def predict_time(strategy: Strategy, flops: float, nbytes: float, *,
                 depth: int, n_tiles: int,
                 wait_group: Optional[int] = None,
                 chip: Optional[hardware.Chip] = None) -> float:
    """Analytic execution-time model (seconds) for one strategy.

    sync:            t_m * 1.5 + t_c   (staging re-pass)
    register_bypass: t_m + t_c         (no overlap, no staging)
    overlap:         max(t_m / bw_frac, t_c) + ring fill, with the
                     Little's-law bandwidth fraction of issue-ahead A
    drop_off:        the same law at chunk granularity (tile/4), plus
                     chunked issue overhead
    tma:             bulk-copy pipeline at the deepest issue-ahead, with the
                     TMA latency, bandwidth cap and issue cost
    """
    chip = chip or hardware.TARGET
    t_c = flops / (chip.tflops_f32 * 1e12)
    t_m = nbytes / (chip.mem_bw_gbs * 1e9)
    n_tiles = max(n_tiles, 1)
    issue = ISSUE_S * n_tiles
    if strategy == Strategy.SYNC:
        return t_m * 1.5 + t_c + issue
    if strategy == Strategy.REGISTER_BYPASS:
        return t_m + t_c + issue
    if strategy == Strategy.TMA:
        ahead = max(depth, 2) - 1
        t_tile = t_m / n_tiles
        bw_frac = TMA_BULK_BW_FRAC * min(
            1.0, ahead * t_tile / (TMA_LATENCY_S + t_tile))
        fill = ahead * t_tile + TMA_LATENCY_S
        return max(t_m / bw_frac, t_c) + fill + TMA_ISSUE_S * n_tiles
    ahead = issue_ahead(depth, wait_group)
    t_tile = t_m / n_tiles
    if strategy == Strategy.OVERLAP:
        if ahead == 0:
            return t_m + t_c + issue
        bw_frac = min(1.0, ahead * t_tile / (DMA_LATENCY_S + t_tile))
        fill = ahead * t_tile + DMA_LATENCY_S
        return max(t_m / bw_frac, t_c) + fill + issue
    t_chunk = t_tile / 4
    a_eff = max(ahead, 1)
    bw_frac = min(1.0, a_eff * t_chunk / (DMA_LATENCY_S + t_chunk))
    fill = t_chunk + DMA_LATENCY_S
    return max(t_m / bw_frac, t_c) + fill + 4 * issue


def dtype_bytes(dtype: str) -> int:
    return getattr(torch, dtype).itemsize


@dataclass
class KernelSpec:
    name: str
    #: make_args(shape, dtype, generator, device) -> input tensors
    make_args: Callable[[Tuple[int, ...], str, torch.Generator, Any], Tuple]
    flops_bytes: Callable[[Tuple[int, ...], str, Dict[str, Any]],
                          Tuple[float, float]]
    n_tiles: Callable[[Tuple[int, ...], Dict[str, Any]], int]


def _uniform(shape, dtype, generator, device):
    """U[0, 1) in ``dtype``, drawn in float32 on ``device``."""
    x = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return x.to(getattr(torch, dtype))


#: fixed workload intensity for tuning runs
STREAM_ITERS = 4

STREAM = KernelSpec(
    name="stream",
    make_args=lambda shape, dtype, g, dev: (_uniform(shape, dtype, g, dev),),
    flops_bytes=lambda shape, dtype, cfg: stream_flops_bytes(
        shape, STREAM_ITERS, dtype_bytes(dtype)),
    n_tiles=lambda shape, cfg: cfg["n_tiles"],
)

HOTSPOT = KernelSpec(
    name="hotspot",
    make_args=lambda shape, dtype, g, dev: (_uniform(shape, dtype, g, dev),
                                            _uniform(shape, dtype, g, dev)),
    flops_bytes=lambda shape, dtype, cfg: (
        10.0 * shape[0] * shape[1],
        3.0 * shape[0] * shape[1] * dtype_bytes(dtype)),
    n_tiles=lambda shape, cfg: max(shape[0] // cfg["tile_rows"], 1),
)

SPECS: Dict[str, KernelSpec] = {s.name: s for s in (STREAM, HOTSPOT)}

KERNELS: Tuple[str, ...] = tuple(SPECS)
