"""Labeled in-process metrics: counters, gauges, histograms.

The serving loop (and anything else with request-shaped work) records into
a ``Registry``; a snapshot is a plain list of dict rows — JSON-dumpable,
renderable by ``experiments/make_report.py``, and printable by
``python -m repro_torch.obs.cli summary``.  A copy of ``repro.obs.metrics``.

  Counter     monotonically increasing total      (requests, tokens)
  Gauge       last-set value                      (queue depth, occupancy)
  Histogram   observations + quantile snapshots   (TTFT, per-token latency)

Metrics are identified by (name, sorted labels): asking the registry for
the same name+labels twice returns the same instance, so call sites never
coordinate.  All three types are thread-safe.  Histograms keep samples in
a fixed-size ring (default 8192) — once full, new observations overwrite
the oldest, so quantiles describe the recent window; ``count``/``sum``
stay exact totals.
"""
from __future__ import annotations

import json
import threading
from typing import Any, Dict, IO, List, Tuple, Union

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "registry",
           "counter", "gauge", "histogram", "quantile"]

#: quantiles every histogram snapshot reports.
SNAPSHOT_QUANTILES = (0.5, 0.9, 0.99)


def quantile(sorted_samples: List[float], q: float) -> float:
    """Linear-interpolation quantile over an already-sorted list."""
    if not sorted_samples:
        return 0.0
    if len(sorted_samples) == 1:
        return sorted_samples[0]
    pos = q * (len(sorted_samples) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_samples) - 1)
    frac = pos - lo
    return sorted_samples[lo] * (1.0 - frac) + sorted_samples[hi] * frac


class _Metric:
    kind = "?"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()

    def label_dict(self) -> Dict[str, str]:
        return dict(self.labels)

    def _row(self) -> Dict[str, Any]:
        return {"kind": self.kind, "name": self.name,
                "labels": self.label_dict()}


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> Dict[str, Any]:
        return dict(self._row(), value=self._value)


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> Dict[str, Any]:
        return dict(self._row(), value=self._value)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, labels, max_samples: int = 8192):
        super().__init__(name, labels)
        self.max_samples = max(int(max_samples), 1)
        self._samples: List[float] = []
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            if len(self._samples) < self.max_samples:
                self._samples.append(v)
            else:                       # ring overwrite: recent window
                self._samples[self._count % self.max_samples] = v
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    @property
    def count(self) -> int:
        return self._count

    def samples(self) -> List[float]:
        """Copy of the retained sample window, in observation order (the
        bench serving rows export these as raw ``times_us``)."""
        with self._lock:
            return list(self._samples)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            samples = sorted(self._samples)
            count, total = self._count, self._sum
            lo = self._min if count else 0.0
            hi = self._max if count else 0.0
        row = dict(self._row(), count=count, sum=total, min=lo, max=hi,
                   mean=(total / count if count else 0.0))
        for q in SNAPSHOT_QUANTILES:
            row[f"p{int(q * 100)}"] = quantile(samples, q)
        return row


class Registry:
    """Get-or-create store of labeled metrics."""

    _TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, str, Tuple[Tuple[str, str], ...]],
                            _Metric] = {}

    def _get(self, kind: str, name: str, labels: Dict[str, Any]) -> _Metric:
        key = (kind, name,
               tuple(sorted((str(k), str(v)) for k, v in labels.items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = self._TYPES[kind](name, key[2])
            return m

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels: Any) -> Histogram:
        return self._get("histogram", name, labels)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            metrics = list(self._metrics.values())
        return [m.snapshot() for m in sorted(
            metrics, key=lambda m: (m.name, m.labels))]

    def to_dict(self) -> Dict[str, Any]:
        return {"schema_version": 1, "kind": "obs-metrics",
                "rows": self.snapshot()}

    def save(self, out: Union[str, IO[str]]) -> None:
        if hasattr(out, "write"):
            json.dump(self.to_dict(), out, indent=1, sort_keys=True)
            out.write("\n")
        else:
            with open(out, "w") as f:
                json.dump(self.to_dict(), f, indent=1, sort_keys=True)
                f.write("\n")


# ---------------------------------------------------------------------------
# The process-wide registry
# ---------------------------------------------------------------------------

_REGISTRY = Registry()


def registry() -> Registry:
    return _REGISTRY


def counter(name: str, **labels: Any) -> Counter:
    return _REGISTRY.counter(name, **labels)


def gauge(name: str, **labels: Any) -> Gauge:
    return _REGISTRY.gauge(name, **labels)


def histogram(name: str, **labels: Any) -> Histogram:
    return _REGISTRY.histogram(name, **labels)
