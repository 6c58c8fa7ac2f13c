"""Empirical autotuner: time the surviving candidates, cache the winner.

The counterpart of ``repro.tuning.autotuner``.  Measurement uses the
port's one timing protocol, ``bench.timing`` (warmup calls, ``repeats``
timed calls, one-sided IQR outlier rejection, median; CUDA events on the
card); this module owns no timing loop of its own.  The hard-coded default
config is always measured even if the analytic model pruned it, so every
record carries a tuned-vs-default speedup with full provenance.
"""
from __future__ import annotations

import datetime
import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..bench.timing import TimingStats, time_callable   # noqa: F401  (re-export)
from ..core import hardware
from ..core.async_pipeline import Strategy, parse_strategy
from ..kernels import ops
from ..obs.trace import get_tracer
from .registry import Measurement, Registry, TuningRecord, \
    default_registry_path
from .search_space import Candidate, TuningTask, default_task

log = logging.getLogger("repro_torch.tuning")

__all__ = ["Autotuner", "TimingStats", "time_callable", "decode_config",
           "tuned", "apply_registry_defaults", "apply_tuned_kernel_defaults",
           "tune_kernel"]


class Autotuner:
    """Drives TuningTasks through the registry-backed measure/cache cycle."""

    def __init__(self, registry: Optional[Registry] = None, *,
                 warmup: int = 1, repeats: int = 5,
                 keep_ratio: Optional[float] = None):
        self.registry = registry if registry is not None else Registry()
        self.warmup = warmup
        self.repeats = repeats
        self.keep_ratio = keep_ratio

    def tune(self, task: TuningTask, *, force: bool = False,
             verbose: bool = False) -> TuningRecord:
        """Return the cached record for the task, measuring on a miss."""
        cached = self.registry.get(task.kernel, task.shape, task.dtype,
                                   task.chip, task.interpret)
        if cached is not None and not force:
            log.info("tuning cache hit: %s", cached.key)
            return cached

        keep_ratio = self.keep_ratio or task.keep_ratio
        survivors, dropped = task.space.pruned(keep_ratio)
        # baseline against the SEED constants, not the live defaults table:
        # apply_registry_defaults may already have installed a tuned winner
        # there, which would collapse speedup_vs_default to ~1.0
        default_cfg = ops.seed_default_config(task.kernel)
        if not any(_config_eq(c.config, default_cfg) for c in survivors):
            # always measure the hard-coded default for the speedup baseline
            survivors = survivors + [task.space.annotate(default_cfg)]
        log.info("tuning %s shape=%s: %d candidates (%d pruned analytically)",
                 task.kernel, task.shape, len(survivors), len(dropped))

        args = task.make_args()
        measurements: List[Measurement] = []
        # the search becomes a span tree (tune -> one span per candidate)
        with get_tracer().span(
                f"tune:{task.kernel}",
                shape="x".join(map(str, task.shape)), dtype=task.dtype,
                chip=task.chip, device=task.device,
                n_candidates=len(survivors), n_pruned=len(dropped)):
            for cand in survivors:
                meas = self._measure(task, args, cand)
                measurements.append(meas)
                if verbose:
                    status = f"{meas.us_median:10.1f}us" \
                        if meas.error is None else f"FAILED ({meas.error})"
                    print(f"  {_config_str(cand.config):<56s} "
                          f"pred={meas.predicted_us:9.1f}us meas={status}",
                          flush=True)

        ok = [m for m in measurements if m.error is None]
        if not ok:
            raise RuntimeError(
                f"autotuning {task.kernel} {task.shape}: every candidate "
                f"failed; first error: {measurements[0].error}")
        best = min(ok, key=lambda m: m.us_median)
        default_meas = next(
            (m for m in ok if _config_eq(m.config, _encode(default_cfg))),
            None)
        default_us = default_meas.us_median if default_meas else 0.0
        record = TuningRecord(
            kernel=task.kernel, shape=list(task.shape), dtype=task.dtype,
            chip=task.chip, best=best.config, best_us=best.us_median,
            default_us=default_us,
            speedup_vs_default=(default_us / best.us_median
                                if best.us_median and default_us else 0.0),
            measurements=measurements,
            n_candidates=len(survivors), n_pruned=len(dropped),
            interpret=task.interpret, jax_version="",
            created_at=datetime.datetime.now(
                datetime.timezone.utc).isoformat(timespec="seconds"))
        self.registry.put(record)
        return record

    def _measure(self, task: TuningTask, args: Tuple,
                 cand: Candidate) -> Measurement:
        cfg = _encode(cand.config)
        with get_tracer().span("candidate", config=_config_str(cand.config),
                               predicted_us=cand.predicted_us) as span:
            try:
                stats = time_callable(lambda: task.call(args, cand.config),
                                      warmup=self.warmup,
                                      repeats=self.repeats,
                                      device=task.device)
                if span is not None:
                    span.attrs["us_median"] = stats.median
                return Measurement(config=cfg, us_median=stats.median,
                                   us_mean=stats.mean, us_min=stats.best,
                                   us_std=stats.std,
                                   n_trials=len(stats.times_us),
                                   n_outliers=stats.n_outliers,
                                   predicted_us=cand.predicted_us)
            except Exception as e:      # candidate infeasible in practice
                log.warning("candidate %s failed: %s", cfg, e)
                if span is not None:
                    span.attrs["error"] = f"{type(e).__name__}"
                return Measurement(config=cfg,
                                   predicted_us=cand.predicted_us,
                                   error=f"{type(e).__name__}: {e}")


# ---------------------------------------------------------------------------
# Config (de)serialisation: Strategy enums <-> registry JSON strings
# ---------------------------------------------------------------------------

def _encode(config: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (v.value if isinstance(v, Strategy) else v)
            for k, v in config.items()}


def decode_config(config: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(config)
    if isinstance(out.get("strategy"), str):
        out["strategy"] = parse_strategy(out["strategy"])
    return out


def _config_eq(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    return _encode(a) == _encode(b)


def _config_str(config: Dict[str, Any]) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(_encode(config).items()))


# ---------------------------------------------------------------------------
# Lookup API
# ---------------------------------------------------------------------------

_REGISTRY_CACHE: Dict[str, Registry] = {}


def _default_registry() -> Registry:
    """Memoized default Registry so per-call-site ``tuned()`` lookups do not
    re-read the JSON file every invocation.  The in-memory view is stable
    for the process lifetime; external registry edits need a new process
    (or an explicit Registry passed in)."""
    path = default_registry_path()
    reg = _REGISTRY_CACHE.get(path)
    if reg is None:
        reg = _REGISTRY_CACHE[path] = Registry(path)
    return reg


def _on_card() -> bool:
    """Whether this process measures on a card ("compiled" records)."""
    return torch.cuda.is_available()


def _local_chip() -> str:
    """The card's catalog row, or ``TARGET`` on a host with no card."""
    return hardware.detect_chip(0) if _on_card() else hardware.TARGET.name


def tuned(kernel: str, shape: Sequence[int], dtype: str = "float32", *,
          chip: Optional[str] = None, interpret: Optional[bool] = None,
          registry: Optional[Registry] = None,
          fallback_to_default: bool = True) -> Optional[Dict[str, Any]]:
    """Best known config for (kernel, shape, dtype, chip), decoded and ready
    to splat into the ops wrapper:  ``ops.stream(x, **tuned("stream",
    x.shape))``.  ``chip`` and ``interpret`` default to this host's: the
    card's catalog row and "compiled" where there is a card, else
    ``TARGET`` and "interpret".  On a registry miss falls back to the
    kernel's SEED constants, never to an ``apply_registry_defaults``
    install (an installed winner was tuned at another shape, and splatting
    it as explicit kwargs would bypass the wrappers' degrade-to-seed net).
    Returns None on a miss if ``fallback_to_default=False``."""
    reg = registry if registry is not None else _default_registry()
    rec = reg.get(kernel, tuple(int(s) for s in shape), dtype,
                  chip or _local_chip(),
                  (not _on_card()) if interpret is None else interpret)
    if rec is not None:
        return decode_config(rec.best)
    return ops.seed_default_config(kernel) if fallback_to_default else None


def apply_registry_defaults(registry: Optional[Registry] = None, *,
                            chip: Optional[str] = None,
                            dtype: Optional[str] = None,
                            interpret: Optional[bool] = None
                            ) -> Dict[str, Dict[str, Any]]:
    """Install registry winners as the kernels' default configs.

    For each kernel with tuned records on ``chip`` (default: this host's,
    as in ``tuned``), the record with the largest problem size wins.
    ``dtype`` and ``interpret`` filter on the records' measurement
    provenance: pass ``interpret=False`` on the card so configs timed on the
    CPU's plain versions are never installed for the card's kernels.
    Returns the {kernel: config} dict that was applied."""
    reg = registry if registry is not None else Registry()
    chip = chip or _local_chip()
    applied: Dict[str, Dict[str, Any]] = {}
    by_kernel: Dict[str, list] = {}
    for r in reg.records():             # parse the registry once, not 7x
        if r.chip == chip \
                and (dtype is None or r.dtype == dtype) \
                and (interpret is None or r.interpret == interpret):
            by_kernel.setdefault(r.kernel, []).append(r)
    for kernel in ops.KERNEL_DEFAULTS:
        recs = by_kernel.get(kernel, [])
        if not recs:
            continue

        def _size(r):
            n = 1
            for s in r.shape:
                n *= s
            return n
        best = max(recs, key=_size)
        cfg = decode_config(best.best)
        try:
            ops.set_default_config(kernel, **cfg)
        except (KeyError, ValueError) as e:
            # one stale record (e.g. a key a newer kernel dropped) costs
            # only that kernel, not the rest of the install
            log.warning("skipping tuned record %s for %s: %s",
                        _config_str(cfg), kernel, e)
            continue
        applied[kernel] = cfg
        log.info("tuned defaults for %s <- %s (%.1fus, %.2fx vs default)",
                 kernel, _config_str(cfg), best.best_us,
                 best.speedup_vs_default or 1.0)
    return applied


def apply_tuned_kernel_defaults(registry_path: Optional[str] = None
                                ) -> Dict[str, Dict[str, Any]]:
    """Best-effort startup installer for serve/train entry points.

    Loads the persistent registry, keeps the measurements of this process's
    mode ("compiled" records where there is a card, "interpret" ones
    elsewhere), and installs the winners as kernel defaults.  A missing or
    stale registry is a silent no-op: startup must succeed cold."""
    try:
        applied = apply_registry_defaults(Registry(registry_path),
                                          interpret=not _on_card())
        if applied:
            log.info("autotuned kernel defaults installed for: %s",
                     ", ".join(sorted(applied)))
        return applied
    except Exception as e:              # registry problems never block startup
        log.warning("tuning registry unavailable (%s); using seed defaults",
                    e)
        return {}


def tune_kernel(kernel: str, *, shape: Optional[Sequence[int]] = None,
                dtype: str = "float32", registry: Optional[Registry] = None,
                device: str = "cuda", force: bool = False,
                warmup: int = 1, repeats: int = 5,
                verbose: bool = False) -> TuningRecord:
    """One-call convenience: build the default task and tune it."""
    task = default_task(kernel, shape=shape, dtype=dtype, device=device)
    tuner = Autotuner(registry, warmup=warmup, repeats=repeats)
    return tuner.tune(task, force=force, verbose=verbose)
