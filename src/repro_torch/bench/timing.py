"""The measurement primitive of the port's benchmarks.

The counterpart of ``repro.bench.timing``: warmup calls, ``repeats`` timed
calls, one-sided median + k*IQR outlier rejection, then the median.  On a
CUDA device each trial is timed with CUDA events recorded on the current
stream around the call and read after the end event has completed, where
the reference blocks with ``jax.block_until_ready``; on the CPU it is the
host's ``perf_counter``.  With ``repro_torch.obs`` tracing enabled every
trial becomes a span, recorded after the fact from the host clock readings
the loop takes anyway.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Union

import torch

from ..obs.trace import get_tracer

__all__ = ["TimingStats", "time_callable", "reject_outliers",
           "outlier_flags"]


@dataclass
class TimingStats:
    """Per-call time statistics over the post-rejection samples."""
    times_us: List[float]
    n_outliers: int = 0

    @property
    def median(self) -> float:
        return statistics.median(self.times_us) if self.times_us else 0.0

    @property
    def mean(self) -> float:
        return statistics.fmean(self.times_us) if self.times_us else 0.0

    @property
    def best(self) -> float:
        return min(self.times_us) if self.times_us else 0.0

    @property
    def std(self) -> float:
        return statistics.pstdev(self.times_us) \
            if len(self.times_us) > 1 else 0.0

    def to_metrics(self) -> dict:
        """The flat metric dict every result row carries, ``times_us`` (the
        kept samples) included."""
        return {"us_median": self.median, "us_mean": self.mean,
                "us_min": self.best, "us_std": self.std,
                "n_trials": len(self.times_us),
                "n_outliers": self.n_outliers,
                "times_us": [round(t, 3) for t in self.times_us]}


def _trial(fn: Callable[[], Any], stream) -> float:
    """One call's time in microseconds (``stream`` None: host clock)."""
    if stream is None:
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e6
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    fn()
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) * 1e3


def time_callable(fn: Callable[[], Any], *, warmup: int = 1,
                  repeats: int = 5, outlier_iqr: float = 3.0,
                  device: Union[str, torch.device] = "cuda") -> TimingStats:
    """Time ``fn`` on ``device``.  ``warmup=0`` is honored: first-call
    costs (a kernel build) land in the timings, where the IQR rule flags
    them instead of letting them poison the median."""
    stream = None
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        stream = torch.cuda.current_stream(device)
    tracer = get_tracer()
    traced = tracer.enabled
    warm_marks = []
    for _ in range(max(warmup, 0)):
        t0 = time.perf_counter()
        _trial(fn, stream)
        if traced:
            warm_marks.append((t0, time.perf_counter()))
    times = []
    marks = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        times.append(_trial(fn, stream))
        if traced:
            marks.append((t0, time.perf_counter()))
    flags = outlier_flags(times, outlier_iqr)
    kept = [t for t, cut in zip(times, flags) if not cut]
    if traced:
        for i, (w0, w1) in enumerate(warm_marks):
            tracer.record("warmup", w0, w1, trial=i, phase="warmup")
        for i, ((t0, t1), cut) in enumerate(zip(marks, flags)):
            tracer.record("timed", t0, t1, trial=i, phase="timed",
                          outlier=bool(cut))
    return TimingStats(times_us=kept, n_outliers=len(times) - len(kept))


def outlier_flags(times: List[float], k: float) -> List[bool]:
    """Per-sample rejection flags (True = slow outlier) under the one-sided
    median + k*IQR rule; the all-flagged case degrades to keeping all."""
    if len(times) < 4 or k <= 0:
        return [False] * len(times)
    s = sorted(times)
    q1 = s[len(s) // 4]
    q3 = s[(3 * len(s)) // 4]
    cut = statistics.median(s) + k * max(q3 - q1, 1e-9)
    flags = [t > cut for t in times]
    if all(flags):
        return [False] * len(times)
    return flags


def reject_outliers(times: List[float], k: float) -> List[float]:
    """Drop samples above median + k*IQR (one-sided: slow outliers only)."""
    return [t for t, cut in zip(times, outlier_flags(times, k)) if not cut]
