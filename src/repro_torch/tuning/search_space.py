"""Candidate enumeration, analytic cost model and pruning for the autotuner.

The counterpart of ``repro.tuning.search_space``.  Per kernel it enumerates
the reference's (strategy x ring depth x wait group x tile shape)
candidates, attaches the reference's analytic time, and drops, before any
timing:

  * card: configs the card's kernel refuses (``check_card_config`` of the
    kernel's module: tiles its registers or shared memory cannot hold,
    block shapes it is not built for) -- where the reference drops configs
    past the chip's VMEM, which no config at the H100 row's 128 MiB reaches;
  * break-even: pipelines whose issue-ahead covers the whole tile stream;
  * dominated: predicted more than ``keep_ratio`` x the best prediction.

The cost constants are the reference's, which model the TPU's DMA engines.
None of them has been fitted on the H100; ``predicted_us`` is the reference
model evaluated with the H100's catalog peaks, not a measurement.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..bench.timing import require_device
from ..core import hardware
from ..core.async_pipeline import PipelineSpec, Strategy
from ..kernels import flash_attention as _fa
from ..kernels import hotspot as _hs
from ..kernels import lud as _lud
from ..kernels import matmul as _mm
from ..kernels import nw as _nw
from ..kernels import ops
from ..kernels import pathfinder as _pf
from ..kernels import stream as _st
from ..kernels.stream import stream_flops_bytes

__all__ = ["predict_time", "issue_ahead", "Candidate", "KernelSpec", "SPECS",
           "KERNELS", "STRATEGIES", "DEPTHS", "strategy_depths",
           "strategy_depth_waits", "SearchSpace", "TuningTask",
           "default_task", "DEFAULT_KEEP_RATIO", "STREAM", "HOTSPOT",
           "PATHFINDER", "NW", "LUD", "MATMUL", "FLASH", "STREAM_ITERS",
           "ISSUE_S", "DMA_LATENCY_S", "TMA_LATENCY_S", "TMA_ISSUE_S",
           "TMA_BULK_BW_FRAC", "dtype_bytes"]

#: keep candidates predicted within this factor of the analytic best
DEFAULT_KEEP_RATIO = 2.0

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
class Candidate:
    """One point of a kernel's search space, with its analytic position.
    ``vmem_bytes`` holds the shared memory of one block on the card (the
    reference's field name: its VMEM bytes)."""
    config: Dict[str, Any]
    predicted_us: float = 0.0
    vmem_bytes: int = 0
    feasible: bool = True
    why_pruned: str = ""

    @property
    def strategy(self) -> Strategy:
        return self.config["strategy"]


STRATEGIES: Tuple[Strategy, ...] = tuple(Strategy)
DEPTHS: Tuple[int, ...] = (2, 3, 4)


def strategy_depths(strategy: Strategy) -> Tuple[int, ...]:
    """Ring depths worth searching: SYNC and REGISTER_BYPASS are
    single-buffered, so depth variants would be duplicate candidates."""
    if strategy in (Strategy.SYNC, Strategy.REGISTER_BYPASS):
        return (2,)
    return DEPTHS


def strategy_depth_waits(strategy: Strategy
                         ) -> Tuple[Tuple[int, Optional[int]], ...]:
    """(depth, wait_group) pipeline shapes worth searching per strategy:
    the deepest issue-ahead (``wait_group=None``) at every depth, and at
    depths past 2 a shallow wait (``wait_group=1``).  TMA has no wait-group
    axis: its per-slot mbarrier always runs at issue-ahead depth - 1."""
    if strategy in (Strategy.SYNC, Strategy.REGISTER_BYPASS):
        return ((2, None),)
    if strategy is Strategy.TMA:
        return tuple((d, None) for d in strategy_depths(strategy))
    out = []
    for d in strategy_depths(strategy):
        out.append((d, None))
        if d > 2:
            out.append((d, 1))
    return tuple(out)


def _strategy_depth_pairs():
    return [(s, d, w) for s in STRATEGIES
            for d, w in strategy_depth_waits(s)]


def _torch_dtype(dtype: str) -> torch.dtype:
    return getattr(torch, dtype)


@dataclass
class KernelSpec:
    name: str
    default_shape: Tuple[int, ...]
    #: make_args(shape, dtype, generator, device) -> input tensors
    make_args: Callable[[Tuple[int, ...], str, torch.Generator, Any], Tuple]
    #: call(args, config, workload) -> the kernel's output, through ``ops``
    call: Callable[[Tuple, Dict[str, Any], Dict[str, Any]], Any]
    #: the call's problem keywords in a tuning run (the reference's)
    workload: Dict[str, Any]
    enumerate_configs: Callable[[Tuple[int, ...]], List[Dict[str, Any]]]
    flops_bytes: Callable[[Tuple[int, ...], str, Dict[str, Any]],
                          Tuple[float, float]]
    n_tiles: Callable[[Tuple[int, ...], Dict[str, Any]], int]
    #: smem_bytes(shape, dtype, config, spec) -> one block's shared memory
    smem_bytes: Callable[..., int]
    #: check_card(shape, dtype, config, spec): ``ValueError`` where the
    #: card's kernel refuses the config
    check_card: Callable[..., None]


def _uniform(shape, dtype, generator, device):
    """U[0, 1) in ``dtype``, drawn in float32 on ``device``."""
    x = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return x.to(getattr(torch, dtype))


# -- stream -----------------------------------------------------------------

#: fixed workload intensity for tuning runs
STREAM_ITERS = 4


def _stream_configs(shape):
    rows, _ = shape
    out = []
    for (s, depth, wg), tr, nt in itertools.product(
            _strategy_depth_pairs(), (8, 16, 32), (2, 4, 8)):
        if rows % (tr * nt):
            continue
        out.append(dict(strategy=s, depth=depth, wait_group=wg,
                        out_depth=2, tile_rows=tr, n_tiles=nt))
    return out


STREAM = KernelSpec(
    name="stream",
    default_shape=(512, 256),
    make_args=lambda shape, dtype, g, dev: (_uniform(shape, dtype, g, dev),),
    call=lambda a, cfg, w: ops.stream(a[0], **w, **cfg),
    workload={"iters": STREAM_ITERS},
    enumerate_configs=_stream_configs,
    flops_bytes=lambda shape, dtype, cfg: stream_flops_bytes(
        shape, STREAM_ITERS, dtype_bytes(dtype)),
    n_tiles=lambda shape, cfg: cfg["n_tiles"],
    smem_bytes=lambda shape, dtype, cfg, spec: _st.stream_smem(
        spec, cfg["tile_rows"], dtype_bytes(dtype)),
    check_card=lambda shape, dtype, cfg, spec: _st.check_card_config(
        shape[1], _torch_dtype(dtype), spec, cfg["tile_rows"]),
)


# -- hotspot ----------------------------------------------------------------

def _hotspot_configs(shape):
    rows, _ = shape
    out = []
    for (s, depth, wg), tr in itertools.product(_strategy_depth_pairs(),
                                                (8, 16, 32)):
        if rows % tr:
            continue
        out.append(dict(strategy=s, depth=depth, wait_group=wg,
                        out_depth=2, tile_rows=tr))
    return out


HOTSPOT = KernelSpec(
    name="hotspot",
    default_shape=(256, 256),
    make_args=lambda shape, dtype, g, dev: (_uniform(shape, dtype, g, dev),
                                            _uniform(shape, dtype, g, dev)),
    call=lambda a, cfg, w: ops.hotspot(a[0], a[1], **w, **cfg),
    workload={"iters": 1},
    enumerate_configs=_hotspot_configs,
    flops_bytes=lambda shape, dtype, cfg: (
        10.0 * shape[0] * shape[1],
        3.0 * shape[0] * shape[1] * dtype_bytes(dtype)),
    n_tiles=lambda shape, cfg: max(shape[0] // cfg["tile_rows"], 1),
    smem_bytes=lambda shape, dtype, cfg, spec: _hs._smem(
        spec, cfg["tile_rows"]),
    check_card=lambda shape, dtype, cfg, spec: _hs.check_card_config(
        spec, cfg["tile_rows"]),
)


# -- pathfinder -------------------------------------------------------------

def _pathfinder_configs(shape):
    rows, _ = shape
    out = []
    for (s, depth, wg), tr in itertools.product(_strategy_depth_pairs(),
                                                (4, 8, 16)):
        if (rows - 1) % tr:
            continue
        out.append(dict(strategy=s, depth=depth, wait_group=wg,
                        tile_rows=tr))
    return out


PATHFINDER = KernelSpec(
    name="pathfinder",
    default_shape=(129, 256),
    make_args=lambda shape, dtype, g, dev: (
        torch.randint(0, 10, shape, generator=g, device=dev,
                      dtype=torch.int32),),
    call=lambda a, cfg, w: ops.pathfinder(a[0], **w, **cfg),
    workload={},
    enumerate_configs=_pathfinder_configs,
    flops_bytes=lambda shape, dtype, cfg: (
        3.0 * shape[0] * shape[1], float(shape[0] * shape[1] * 4)),
    n_tiles=lambda shape, cfg: max((shape[0] - 1) // cfg["tile_rows"], 1),
    smem_bytes=lambda shape, dtype, cfg, spec: _pf._smem(
        spec, cfg["tile_rows"]),
    check_card=lambda shape, dtype, cfg, spec: _pf.check_card_config(
        spec, cfg["tile_rows"]),
)


# -- nw ---------------------------------------------------------------------

def _nw_configs(shape):
    n = shape[0]
    out = []
    for (s, depth, wg), tr in itertools.product(_strategy_depth_pairs(),
                                                (4, 8, 16)):
        if n % tr:
            continue
        out.append(dict(strategy=s, depth=depth, wait_group=wg,
                        out_depth=2, tile_rows=tr))
    return out


def _nw_width(n: int) -> int:
    """The reference's row width: n + 1 rounded up to 128."""
    return ((n + 1 + 127) // 128) * 128


NW = KernelSpec(
    name="nw",
    default_shape=(128,),
    make_args=lambda shape, dtype, g, dev: (
        torch.randint(-3, 4, (shape[0], shape[0]), generator=g,
                      device=dev).to(torch.float32),),
    call=lambda a, cfg, w: ops.nw(a[0], **w, **cfg),
    workload={"penalty": 10},
    enumerate_configs=_nw_configs,
    flops_bytes=lambda shape, dtype, cfg: (
        4.0 * shape[0] * _nw_width(shape[0]),
        2.0 * shape[0] * _nw_width(shape[0]) * 4),
    n_tiles=lambda shape, cfg: max(shape[0] // cfg["tile_rows"], 1),
    smem_bytes=lambda shape, dtype, cfg, spec: _nw._smem(
        spec, cfg["tile_rows"]),
    # make_args draws float32 scores whatever the dtype
    check_card=lambda shape, dtype, cfg, spec: _nw.check_card_config(
        torch.float32, spec, cfg["tile_rows"]),
)


# -- lud --------------------------------------------------------------------

def _lud_configs(shape):
    n = shape[0]
    out = []
    for (s, depth, wg), bs in itertools.product(_strategy_depth_pairs(),
                                                (16, 32, 64)):
        if n % bs or bs >= n:
            continue
        out.append(dict(strategy=s, depth=depth, wait_group=wg,
                        out_depth=2, bs=bs))
    return out


LUD = KernelSpec(
    name="lud",
    default_shape=(64,),
    make_args=lambda shape, dtype, g, dev: (
        _uniform((shape[0], shape[0]), dtype, g, dev)
        + shape[0] * torch.eye(shape[0], dtype=getattr(torch, dtype),
                               device=dev),),
    call=lambda a, cfg, w: ops.lud(a[0], **w, **cfg),
    workload={},
    enumerate_configs=_lud_configs,
    flops_bytes=lambda shape, dtype, cfg: (
        (2.0 / 3.0) * shape[0] ** 3,
        2.0 * shape[0] ** 3 / (3.0 * cfg["bs"]) * dtype_bytes(dtype)),
    n_tiles=lambda shape, cfg: max(shape[0] // cfg["bs"] - 1, 1),
    smem_bytes=lambda shape, dtype, cfg, spec: _lud.lud_smem(spec, cfg["bs"]),
    check_card=lambda shape, dtype, cfg, spec: _lud.check_card_config(
        _torch_dtype(dtype), spec, cfg["bs"]),
)


# -- matmul -----------------------------------------------------------------

def _matmul_configs(shape):
    m, k, n = shape
    out = []
    for (s, depth, wg), bm, bk, bn in itertools.product(
            _strategy_depth_pairs(), (128, 256), (128, 256), (128, 256)):
        if m % bm or k % bk or n % bn:
            continue
        out.append(dict(strategy=s, depth=depth, wait_group=wg,
                        bm=bm, bk=bk, bn=bn))
    return out


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
    default_shape=(256, 256, 256),
    make_args=lambda shape, dtype, g, dev: (
        _uniform((shape[0], shape[1]), dtype, g, dev),
        _uniform((shape[1], shape[2]), dtype, g, dev)),
    call=lambda a, cfg, w: ops.matmul(a[0], a[1], **w, **cfg),
    workload={},
    enumerate_configs=_matmul_configs,
    flops_bytes=_matmul_flops_bytes,
    n_tiles=lambda shape, cfg: shape[1] // cfg["bk"],
    smem_bytes=lambda shape, dtype, cfg, spec: _mm.matmul_smem(
        spec, _torch_dtype(dtype)),
    check_card=lambda shape, dtype, cfg, spec: _mm.check_card_config(
        _torch_dtype(dtype), spec, cfg["bm"], cfg["bk"], cfg["bn"]),
)


# -- flash attention --------------------------------------------------------

def _flash_shapes(shape):
    """(q shape, k/v shape) of a FLASH shape: the reference's (h, s, d),
    with KVH = H, or (b, h, kvh, s, d)."""
    if len(shape) == 3:
        return shape, shape
    b, h, kvh, s, d = shape
    return (b, h, s, d), (b, kvh, s, d)


def _flash_configs(shape):
    s_len = shape[-2]
    out = []
    for (s, depth, wg), bq, bk in itertools.product(
            _strategy_depth_pairs(), (128, 256), (128, 256)):
        if s_len % bq or s_len % bk:
            continue
        out.append(dict(strategy=s, depth=depth, wait_group=wg,
                        bq=bq, bk=bk))
    return out


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
    default_shape=(2, 256, 64),
    make_args=_flash_args,
    call=lambda a, cfg, w: ops.flash_attention(a[0], a[1], a[2], **w, **cfg),
    workload={"causal": True},
    enumerate_configs=_flash_configs,
    flops_bytes=_flash_flops_bytes,
    n_tiles=lambda shape, cfg: max(shape[-2] // cfg["bk"], 1),
    smem_bytes=lambda shape, dtype, cfg, spec: _fa.flash_smem(
        spec, shape[-1], _torch_dtype(dtype)),
    check_card=lambda shape, dtype, cfg, spec: _fa.check_card_config(
        shape[-1], _torch_dtype(dtype), spec, cfg["bq"], cfg["bk"]),
)

SPECS: Dict[str, KernelSpec] = {
    s.name: s for s in (STREAM, HOTSPOT, PATHFINDER, NW, LUD, MATMUL, FLASH)}

KERNELS: Tuple[str, ...] = tuple(SPECS)


# ---------------------------------------------------------------------------
# SearchSpace + TuningTask
# ---------------------------------------------------------------------------

class SearchSpace:
    """All candidates for (kernel, shape, dtype) with analytic annotations."""

    def __init__(self, kernel: str, shape: Sequence[int],
                 dtype: str = "float32",
                 chip: Optional[hardware.Chip] = None):
        if kernel not in SPECS:
            raise KeyError(f"unknown kernel {kernel!r}; known: {KERNELS}")
        self.spec = SPECS[kernel]
        self.kernel = kernel
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.chip = chip or hardware.TARGET

    def annotate(self, config: Dict[str, Any]) -> Candidate:
        flops, nbytes = self.spec.flops_bytes(self.shape, self.dtype, config)
        t = predict_time(config["strategy"], flops, nbytes,
                         depth=config["depth"],
                         n_tiles=self.spec.n_tiles(self.shape, config),
                         wait_group=config.get("wait_group"),
                         chip=self.chip)
        smem = self.spec.smem_bytes(self.shape, self.dtype, config,
                                    PipelineSpec.from_config(config))
        return Candidate(config=dict(config), predicted_us=t * 1e6,
                         vmem_bytes=int(smem))

    def candidates(self) -> List[Candidate]:
        return [self.annotate(c)
                for c in self.spec.enumerate_configs(self.shape)]

    def card_refusal(self, config: Dict[str, Any]) -> Optional[str]:
        """Why the card's kernel refuses ``config`` (its check's
        ``ValueError``), or None where it takes it."""
        try:
            self.spec.check_card(self.shape, self.dtype, config,
                                 PipelineSpec.from_config(config))
        except ValueError as e:
            return str(e)
        return None

    def pruned(self, keep_ratio: float = DEFAULT_KEEP_RATIO
               ) -> Tuple[List[Candidate], List[Candidate]]:
        """(survivors, dropped).  Drops what the card refuses (where the
        reference drops what exceeds the VMEM), pipeline shapes past
        analytic break-even (issue-ahead covering the whole tile stream:
        the ring fill then costs the entire memory time up front, so the
        pipeline cannot beat the synchronous bound), and candidates
        analytically dominated by more than ``keep_ratio``."""
        cands = self.candidates()
        for c in cands:
            why = self.card_refusal(c.config)
            if why is not None:
                c.feasible = False
                c.why_pruned = f"card: {why}"
        for c in cands:
            if not c.feasible:
                continue
            if c.config["strategy"] in (Strategy.OVERLAP, Strategy.DROP_OFF,
                                        Strategy.TMA):
                ahead = issue_ahead(c.config["depth"],
                                    c.config.get("wait_group"))
                n = max(self.spec.n_tiles(self.shape, c.config), 1)
                if ahead >= n:
                    c.feasible = False
                    c.why_pruned = (
                        f"break-even: issue-ahead {ahead} >= n_tiles {n}; "
                        "ring fill spans the whole stream, cannot beat sync")
        feasible = [c for c in cands if c.feasible]
        if feasible:
            best = min(c.predicted_us for c in feasible)
            for c in feasible:
                if c.predicted_us > keep_ratio * best:
                    c.feasible = False
                    c.why_pruned = (f"predicted {c.predicted_us:.1f}us > "
                                    f"{keep_ratio:g}x best {best:.1f}us")
        survivors = [c for c in cands if c.feasible]
        dropped = [c for c in cands if not c.feasible]
        return survivors, dropped


@dataclass
class TuningTask:
    """One tunable cell: a kernel at a concrete shape/dtype, measured on
    ``device``.  "cuda" (the default) needs a card and raises without one;
    "cpu" times the plain torch versions.  ``chip`` defaults to the card's
    catalog row (``TARGET`` on the CPU).  ``workload`` overrides the spec's
    call keywords (e.g. hotspot's ``grid``, which sets how many blocks the
    card runs)."""
    kernel: str
    shape: Tuple[int, ...]
    dtype: str = "float32"
    chip: Optional[str] = None
    device: str = "cuda"
    keep_ratio: float = DEFAULT_KEEP_RATIO
    workload: Optional[Dict[str, Any]] = None
    space: SearchSpace = field(init=False)

    def __post_init__(self):
        dev = require_device(self.device)
        self.shape = tuple(int(s) for s in self.shape)
        if self.chip is None:
            self.chip = hardware.detect_chip(dev.index or 0) \
                if dev.type == "cuda" else hardware.TARGET.name
        self.space = SearchSpace(self.kernel, self.shape, self.dtype,
                                 chip=hardware.get_chip(self.chip))

    @property
    def interpret(self) -> bool:
        """The registry's mode: False ("compiled") for the card's kernels,
        True ("interpret") for the CPU's plain versions."""
        return torch.device(self.device).type != "cuda"

    def make_args(self, seed: int = 0) -> Tuple:
        g = torch.Generator(device=self.device).manual_seed(seed)
        return self.space.spec.make_args(self.shape, self.dtype, g,
                                         self.device)

    def call(self, args: Tuple, config: Dict[str, Any]):
        spec = self.space.spec
        return spec.call(args, config,
                         {**spec.workload, **(self.workload or {})})


def default_task(kernel: str, *, shape: Optional[Sequence[int]] = None,
                 dtype: str = "float32", device: str = "cuda",
                 chip: Optional[str] = None,
                 workload: Optional[Dict[str, Any]] = None) -> TuningTask:
    spec = SPECS[kernel]
    return TuningTask(kernel=kernel,
                      shape=tuple(shape or spec.default_shape), dtype=dtype,
                      chip=chip, device=device, workload=workload)
