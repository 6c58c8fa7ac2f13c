"""Observability for the port: span tracing, metrics and the regression gate.

  trace      a copy of ``repro.obs.trace``: nested spans, JSONL sink and
             Chrome-trace/Perfetto export; off by default
  metrics    a copy of ``repro.obs.metrics``: labeled counters, gauges and
             histograms with quantile snapshots
  compare    the noise-aware BENCH_*.json regression gate of
             ``repro.obs.compare``, over the port's own ``bench.results``
  cli        python -m repro_torch.obs.cli {summary,export-trace,compare}
"""
from . import compare, metrics, trace                       # noqa: F401

__all__ = ["compare", "metrics", "trace"]
