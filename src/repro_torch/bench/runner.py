"""Execute scenarios: resolve config, check, measure, project, record.

The counterpart of ``repro.bench.runner`` (``RunOptions``,
``resolve_config``, ``run_scenario``, ``run_scenarios``, ``new_report``,
``project_scenario``).  For each ``Scenario`` it

  1. resolves the kernel config -- the tuning registry's winner for this
     (kernel, shape, dtype, chip, mode) cell if one exists, the seed default
     otherwise, then the scenario's pinned strategy and overrides on top --
     and records which of those happened (``config_source``: "tuned",
     "default", each with "+scenario" where the scenario pins);
  2. checks the kernel against its ``kernels.ref`` oracle on the same
     device (``max_err``, ``check_ok``);
  3. times it with ``bench.timing`` (CUDA events on the card); and
  4. emits a schema-v2 ``BenchResult`` the reference package can read.

``sweep`` adds the paper's generation study, as ``repro.bench.runner.sweep``
does: every scenario measured on the device is also projected through the
roofline model onto every ``core.hardware`` chip, and the ``regime/*`` rows
are folded into one verdict row a kernel cell (``bench.regime``).

A run on "cuda" needs a card: with none it raises, and never falls back to
the CPU.
"""
from __future__ import annotations

import functools
import logging
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..core import hardware
from ..core.async_pipeline import PipelineSpec
from ..obs.trace import get_tracer
from ..kernels import ops
from ..kernels.stream import stream_flops_bytes
from ..tuning.autotuner import _default_registry, decode_config
from ..tuning.registry import Registry
from ..tuning.search_space import SPECS, dtype_bytes, predict_time
from .regime import regime_rows
from .results import BenchReport, BenchResult, now_iso
from .scenario import (CHECK_TOL, Scenario, call_kernel, check_output,
                       scenarios)
from .timing import require_device, time_callable

log = logging.getLogger("repro_torch.bench")

__all__ = ["RunOptions", "resolve_config", "run_scenario", "run_scenarios",
           "project_scenario", "sweep", "new_report", "require_device"]


@functools.lru_cache(maxsize=None)
def _card_metrics(index: int) -> Tuple[Tuple[str, str], ...]:
    return (("torch_version", torch.__version__),
            ("cuda_version", torch.version.cuda or ""),
            ("device_name", torch.cuda.get_device_name(index)),
            ("power_limit", hardware.card_power_limit(index)))


@dataclass
class RunOptions:
    """Measurement policy for a batch of scenario runs."""
    warmup: int = 1
    repeats: int = 5
    device: str = "cuda"                # the card, unless the caller asks
    check: bool = True                  # compare against the ref oracle
    use_tuned: bool = True              # consult the tuning registry
    chip: Optional[str] = None          # provenance chip
    registry: Optional[Registry] = None
    emit: Optional[Callable[[BenchResult], None]] = None  # streaming hook

    def resolved_chip(self) -> str:
        """``chip``, else the card's catalog row, else ``TARGET`` (the CPU,
        or a projection on a host with no card; a measurement there raises
        in ``require_device``)."""
        if self.chip:
            return self.chip
        dev = torch.device(self.device)
        if dev.type == "cuda" and torch.cuda.is_available():
            return hardware.detect_chip(dev.index or 0)
        return hardware.TARGET.name

    @property
    def interpret(self) -> bool:
        """The registry mode of this device's measurements: "compiled" on
        the card, "interpret" for the CPU's plain versions."""
        return torch.device(self.device).type != "cuda"


def new_report(device: str = "cuda") -> BenchReport:
    return BenchReport(jax_version="", backend=torch.device(device).type,
                       created_at=now_iso())


def resolve_config(sc: Scenario, opts: RunOptions
                   ) -> Tuple[Dict[str, object], str, Optional[str]]:
    """(config, source, tuned_key) for this scenario on this chip and mode.
    A tuned config under the scenario's pinned strategy or overrides that
    the card refuses raises ``ValueError``: no other config is swapped in."""
    cfg = ops.default_config(sc.kernel)
    source, tuned_key = "default", None
    if opts.use_tuned:
        # the memoized process-wide registry: a sweep must not re-parse the
        # registry file once per scenario
        reg = opts.registry if opts.registry is not None \
            else _default_registry()
        rec = reg.get(sc.kernel, sc.shape, sc.dtype, opts.resolved_chip(),
                      opts.interpret)
        if rec is not None:
            cfg = decode_config(rec.best)
            source, tuned_key = "tuned", rec.key
    if sc.strategy is not None or sc.config:
        cfg = dict(cfg)
        if sc.strategy is not None:
            cfg["strategy"] = sc.strategy
        cfg.update(sc.config)
        source += "+scenario"
        if tuned_key is not None:
            try:
                SPECS[sc.kernel].check_card(sc.shape, sc.dtype, cfg,
                                            PipelineSpec.from_config(cfg))
            except ValueError as e:
                raise ValueError(
                    f"scenario {sc.name}: the tuned config {tuned_key} under "
                    f"the scenario's pins is one the card refuses: {e}"
                ) from None
    return cfg, source, tuned_key


def _flops_bytes(sc: Scenario, cfg: Dict[str, object]) -> Tuple[float, float]:
    """Analytic work/traffic for the scenario's actual workload."""
    if sc.kernel == "stream":
        return stream_flops_bytes(sc.shape, sc.workload.get("iters", 4),
                                  dtype_bytes(sc.dtype))
    flops, nbytes = SPECS[sc.kernel].flops_bytes(sc.shape, sc.dtype, cfg)
    if sc.kernel == "hotspot":          # spec models iters=1; scale both
        iters = sc.workload.get("iters", 1)
        flops, nbytes = flops * iters, nbytes * iters
    return flops, nbytes


def _strategy_name(cfg: Dict[str, object]) -> str:
    s = cfg.get("strategy")
    return getattr(s, "value", str(s))


def run_scenario(sc: Scenario, opts: Optional[RunOptions] = None, *,
                 resolved: Optional[Tuple] = None) -> BenchResult:
    """Measure one scenario on ``opts.device`` and return its result row."""
    opts = opts or RunOptions()
    dev = require_device(opts.device)
    cfg, source, tuned_key = resolved or resolve_config(sc, opts)
    chip = opts.resolved_chip()
    args = sc.make_args(dev)
    fn = lambda: call_kernel(sc, args, cfg)

    metrics: Dict[str, object] = {}
    with get_tracer().span(
            f"scenario:{sc.name}", kernel=sc.kernel,
            shape="x".join(map(str, sc.shape)), dtype=sc.dtype,
            strategy=_strategy_name(cfg), config_source=source,
            tuned_key=tuned_key, chip=chip, device=str(dev),
            repeats=opts.repeats) as span:
        warmup = opts.warmup
        if opts.check:
            # the oracle call runs the kernel once, so it doubles as one
            # warmup iteration (and builds the kernel on first use)
            with get_tracer().span("oracle"):
                out = fn()
                err = check_output(sc, args, out)
            warmup = max(warmup - 1, 0)
            metrics["max_err"] = err
            metrics["check_ok"] = bool(err <= CHECK_TOL[sc.kernel])
            if not metrics["check_ok"]:
                log.warning("scenario %s: max_err %.3g exceeds tol %.3g",
                            sc.name, err, CHECK_TOL[sc.kernel])
        stats = time_callable(fn, warmup=warmup, repeats=opts.repeats,
                              device=dev)
        metrics.update(stats.to_metrics())
        if span is not None:
            span.attrs["us_median"] = stats.median

    flops, nbytes = _flops_bytes(sc, cfg)
    metrics["intensity"] = flops / nbytes if nbytes else 0.0
    metrics["predicted_us"] = predict_time(
        cfg["strategy"], flops, nbytes, depth=int(cfg.get("depth", 2)),
        n_tiles=SPECS[sc.kernel].n_tiles(sc.shape, cfg),
        wait_group=cfg.get("wait_group"),
        chip=hardware.get_chip(chip)) * 1e6
    if dev.type == "cuda":
        # the analytic bytes over the measured device time
        metrics["gb_per_s"] = nbytes / stats.median / 1e3
        metrics.update(_card_metrics(dev.index or 0))

    result = BenchResult(
        scenario=sc.name, kernel=sc.kernel, shape=list(sc.shape),
        dtype=sc.dtype, strategy=_strategy_name(cfg), chip=chip,
        metrics=metrics,
        config={k: getattr(v, "value", v) for k, v in cfg.items()},
        config_source=source, tuned_key=tuned_key,
        trace_id=span.span_id if span is not None else None,
        kind="measured", section=sc.section, interpret=False,
        backend=dev.type, jax_version="", created_at=now_iso())
    if opts.emit:
        opts.emit(result)
    return result


def project_scenario(sc: Scenario, chip_name: str,
                     opts: Optional[RunOptions] = None, *,
                     resolved: Optional[Tuple] = None) -> BenchResult:
    """Roofline-model expectation row for ``sc`` on ``chip_name``."""
    opts = opts or RunOptions()
    cfg, source, tuned_key = resolved or resolve_config(sc, opts)
    chip = hardware.get_chip(chip_name)
    flops, nbytes = _flops_bytes(sc, cfg)
    t_c = flops / (chip.tflops_f32 * 1e12)
    t_m = nbytes / (chip.mem_bw_gbs * 1e9)
    t = predict_time(cfg["strategy"], flops, nbytes,
                     depth=int(cfg.get("depth", 2)),
                     n_tiles=SPECS[sc.kernel].n_tiles(sc.shape, cfg),
                     wait_group=cfg.get("wait_group"), chip=chip)
    metrics = {"predicted_us": t * 1e6, "t_compute_us": t_c * 1e6,
               "t_memory_us": t_m * 1e6,
               "intensity": flops / nbytes if nbytes else 0.0,
               "bound": "compute" if t_c > t_m else "memory"}
    result = BenchResult(
        scenario=sc.name, kernel=sc.kernel, shape=list(sc.shape),
        dtype=sc.dtype, strategy=_strategy_name(cfg), chip=chip_name,
        metrics=metrics,
        config={k: getattr(v, "value", v) for k, v in cfg.items()},
        config_source=source, tuned_key=tuned_key, kind="model",
        section=sc.section or "lineage", interpret=False,
        backend="", jax_version="", created_at=now_iso())
    if opts.emit:
        opts.emit(result)
    return result


def run_scenarios(scs: Sequence[Scenario],
                  opts: Optional[RunOptions] = None) -> BenchReport:
    """Measure a batch of scenarios into one report."""
    opts = opts or RunOptions()
    require_device(opts.device)
    report = new_report(opts.device)
    for sc in scs:
        report.add(run_scenario(sc, opts))
    return report


def sweep(scs: Optional[Sequence[Scenario]] = None,
          chips: Optional[Sequence[str]] = None,
          opts: Optional[RunOptions] = None) -> BenchReport:
    """The generation sweep: measure every scenario on ``opts.device``, then
    project each one across the chip lineage (default: every ``CATALOG``
    chip), then append the regime verdict rows."""
    opts = opts or RunOptions()
    require_device(opts.device)
    if scs is None:
        scs = scenarios(smoke=True)
    if chips is None:
        chips = list(hardware.CATALOG)
    for name in chips:
        hardware.get_chip(name)         # fail fast on a typo'd chip
    report = new_report(opts.device)
    with get_tracer().span("sweep", n_scenarios=len(scs),
                           n_chips=len(chips)):
        for sc in scs:
            resolved = resolve_config(sc, opts)     # once per scenario
            report.add(run_scenario(sc, opts, resolved=resolved))
            for chip_name in chips:
                report.add(project_scenario(sc, chip_name, opts,
                                            resolved=resolved))
    for row in regime_rows(report.results):
        report.add(row)
        if opts.emit:
            opts.emit(row)
    return report
