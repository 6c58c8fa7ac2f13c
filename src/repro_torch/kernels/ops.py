"""Public entry points for the ported kernels.

The counterpart of ``repro.kernels.ops`` for ``stream`` and ``hotspot``:
the same keywords minus ``interpret``, the same ``KERNEL_DEFAULTS`` table
and the same seed fallback.  A CUDA tensor launches the hand-written
Hopper kernel; a CPU tensor runs the kernel's plain torch version.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict

from ..core.async_pipeline import PipelineSpec, Strategy
from . import hotspot as _hs
from . import stream as _st

log = logging.getLogger("repro_torch.kernels")

__all__ = ["stream", "hotspot", "Strategy", "KERNEL_DEFAULTS",
           "default_config", "seed_default_config", "set_default_config",
           "reset_default_configs"]


#: The single source of per-kernel tunable constants (the reference's seed
#: values).  ``wait_group=None`` means the deepest safe issue-ahead
#: (depth - 1); ``out_depth`` is the write-back ring depth.
KERNEL_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "stream": dict(strategy=Strategy.OVERLAP, tile_rows=8, n_tiles=4,
                   depth=2, wait_group=None, out_depth=2),
    "hotspot": dict(strategy=Strategy.OVERLAP, tile_rows=8, depth=2,
                    wait_group=None, out_depth=2),
}

_SEED_DEFAULTS = {k: dict(v) for k, v in KERNEL_DEFAULTS.items()}


def default_config(kernel: str) -> Dict[str, Any]:
    """A copy of the current default config for ``kernel``."""
    return dict(KERNEL_DEFAULTS[kernel])


def seed_default_config(kernel: str) -> Dict[str, Any]:
    """The original hard-coded config, regardless of installed tunings."""
    return dict(_SEED_DEFAULTS[kernel])


def set_default_config(kernel: str, **config: Any) -> Dict[str, Any]:
    """Overwrite default constants for ``kernel``; unknown keys raise."""
    cur = KERNEL_DEFAULTS[kernel]
    unknown = set(config) - set(cur)
    if unknown:
        raise KeyError(f"unknown config keys for {kernel}: {sorted(unknown)}")
    cur.update(config)
    return dict(cur)


def reset_default_configs() -> None:
    """Restore the seed defaults."""
    for k, v in _SEED_DEFAULTS.items():
        KERNEL_DEFAULTS[k] = dict(v)


def _resolve(kernel: str, **given: Any) -> Dict[str, Any]:
    cfg = KERNEL_DEFAULTS[kernel]
    return {k: (cfg[k] if v is None else v) for k, v in given.items()}


def _with_seed_fallback(kernel: str, given: Dict[str, Any],
                        call: Callable[[Dict[str, Any]], Any]):
    """Run ``call`` with defaults-resolved config; if an installed default
    is structurally invalid for this problem (``ValueError``), retry once
    with the seed constants.  Explicit (non-None) parameters are never
    overridden, and build or launch failures (``RuntimeError``) are never
    retried."""
    cfg = _resolve(kernel, **given)
    seed = {k: (_SEED_DEFAULTS[kernel][k] if v is None else v)
            for k, v in given.items()}
    try:
        return call(cfg)
    except ValueError:
        if cfg == seed:
            raise
        log.warning("installed %s config %s invalid for this shape; "
                    "falling back to seed defaults", kernel,
                    {k: v for k, v in cfg.items() if given[k] is None})
        return call(seed)


def _spec(cfg: Dict[str, Any]) -> PipelineSpec:
    return PipelineSpec(strategy=cfg["strategy"], depth=cfg["depth"],
                        wait_group=cfg["wait_group"],
                        out_depth=cfg["out_depth"])


def stream(x, *, iters=1, strategy=None, tile_rows=None, n_tiles=None,
           depth=None, wait_group=None, out_depth=None):
    return _with_seed_fallback(
        "stream", dict(strategy=strategy, tile_rows=tile_rows,
                       n_tiles=n_tiles, depth=depth, wait_group=wait_group,
                       out_depth=out_depth),
        lambda cfg: _st.stream_cuda(x, iters=iters, spec=_spec(cfg),
                                    tile_rows=cfg["tile_rows"],
                                    n_tiles=cfg["n_tiles"]))


def hotspot(temp, power, *, iters=1, strategy=None, tile_rows=None,
            depth=None, wait_group=None, out_depth=None, grid=1):
    return _with_seed_fallback(
        "hotspot", dict(strategy=strategy, tile_rows=tile_rows, depth=depth,
                        wait_group=wait_group, out_depth=out_depth),
        lambda cfg: _hs.hotspot_cuda(temp, power, iters=iters,
                                     spec=_spec(cfg),
                                     tile_rows=cfg["tile_rows"], grid=grid))
