"""Analytic cost model and kernel specs for the ported kernels.

The counterpart of ``repro.tuning.search_space`` lines 31-114 plus the
``STREAM``, ``HOTSPOT``, ``PATHFINDER``, ``NW``, ``LUD``, ``MATMUL`` and
``FLASH`` specs.  The
candidate enumeration, pruning and autotuner come with a later slice.

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
           "STREAM", "HOTSPOT", "PATHFINDER", "NW", "LUD", "MATMUL", "FLASH",
           "ISSUE_S",
           "DMA_LATENCY_S", "TMA_LATENCY_S", "TMA_ISSUE_S",
           "TMA_BULK_BW_FRAC", "dtype_bytes"]

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

PATHFINDER = KernelSpec(
    name="pathfinder",
    make_args=lambda shape, dtype, g, dev: (
        torch.randint(0, 10, shape, generator=g, device=dev,
                      dtype=torch.int32),),
    flops_bytes=lambda shape, dtype, cfg: (
        3.0 * shape[0] * shape[1], float(shape[0] * shape[1] * 4)),
    n_tiles=lambda shape, cfg: max((shape[0] - 1) // cfg["tile_rows"], 1),
)


def _nw_width(n: int) -> int:
    """The reference's row width: n + 1 rounded up to 128."""
    return ((n + 1 + 127) // 128) * 128


NW = KernelSpec(
    name="nw",
    make_args=lambda shape, dtype, g, dev: (
        torch.randint(-3, 4, (shape[0], shape[0]), generator=g,
                      device=dev).to(torch.float32),),
    flops_bytes=lambda shape, dtype, cfg: (
        4.0 * shape[0] * _nw_width(shape[0]),
        2.0 * shape[0] * _nw_width(shape[0]) * 4),
    n_tiles=lambda shape, cfg: max(shape[0] // cfg["tile_rows"], 1),
)

LUD = KernelSpec(
    name="lud",
    make_args=lambda shape, dtype, g, dev: (
        _uniform((shape[0], shape[0]), dtype, g, dev)
        + shape[0] * torch.eye(shape[0], dtype=getattr(torch, dtype),
                               device=dev),),
    flops_bytes=lambda shape, dtype, cfg: (
        (2.0 / 3.0) * shape[0] ** 3,
        2.0 * shape[0] ** 3 / (3.0 * cfg["bs"]) * dtype_bytes(dtype)),
    n_tiles=lambda shape, cfg: max(shape[0] // cfg["bs"] - 1, 1),
)



def _matmul_flops_bytes(shape, dtype, cfg):
    """The reference's model: A streamed once per N block, B once per M
    block, the f32 C written once."""
    m, k, n = shape
    isz = dtype_bytes(dtype)
    nbytes = (m * k * (n // cfg["bn"]) + k * n * (m // cfg["bm"])) * isz \
        + m * n * 4
    return 2.0 * m * k * n, nbytes


MATMUL = KernelSpec(
    name="matmul",
    make_args=lambda shape, dtype, g, dev: (
        _uniform((shape[0], shape[1]), dtype, g, dev),
        _uniform((shape[1], shape[2]), dtype, g, dev)),
    flops_bytes=_matmul_flops_bytes,
    n_tiles=lambda shape, cfg: shape[1] // cfg["bk"],
)


def _flash_shapes(shape):
    """(q shape, k/v shape) of a FLASH shape: the reference's (h, s, d),
    with KVH = H, or (b, h, kvh, s, d)."""
    if len(shape) == 3:
        return shape, shape
    b, h, kvh, s, d = shape
    return (b, h, s, d), (b, kvh, s, d)


def _flash_flops_bytes(shape, dtype, cfg):
    """The reference's model per q head (and batch): two products over the
    causal half, K and V streamed once per q block, q read and the f32
    output written once."""
    q_shape, _ = _flash_shapes(shape)
    heads = 1
    for dim in q_shape[:-2]:
        heads *= dim
    s, d = q_shape[-2:]
    isz = dtype_bytes(dtype)
    flops = 2.0 * 2.0 * heads * s * s * d * 0.5
    nbytes = heads * (s // cfg["bq"]) * 2 * s * d * isz * 0.5 \
        + heads * s * d * (isz + 4)
    return flops, nbytes


def _normal(shape, dtype, generator, device):
    """N(0, 1) in ``dtype``, drawn in float32 on ``device``."""
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return x.to(getattr(torch, dtype))


def _flash_args(shape, dtype, generator, device):
    """q, k, v, each N(0, 1)."""
    q_shape, kv_shape = _flash_shapes(shape)
    return tuple(_normal(sh, dtype, generator, device)
                 for sh in (q_shape, kv_shape, kv_shape))


FLASH = KernelSpec(
    name="flash_attention",
    make_args=_flash_args,
    flops_bytes=_flash_flops_bytes,
    n_tiles=lambda shape, cfg: max(shape[-2] // cfg["bk"], 1),
)

SPECS: Dict[str, KernelSpec] = {
    s.name: s for s in (STREAM, HOTSPOT, PATHFINDER, NW, LUD, MATMUL, FLASH)}

KERNELS: Tuple[str, ...] = tuple(SPECS)
