"""Fault tolerance for long training runs: a copy of
``repro.distributed.fault_tolerance`` (plain Python, so copied, not
imported), which the port's trainer uses as the reference's does.

Three mechanisms, all exercised by tests:

1. **Preemption-safe training** — SIGTERM/SIGINT installs a "save at next
   step boundary" flag; the runner checkpoints and exits with a restartable
   code instead of dying mid-step.
2. **Step retry with backoff** — transient device/IO errors re-run the step
   from the last good on-device state (synchronous SPMD means a failed step
   has no partial effects once inputs are re-fed deterministically).  The
   port's trainer retries a step's gradients only: its optimizer update
   writes the parameters in place, so a retried update would not start
   from the last good state.
3. **Elastic restart** — restore onto a *different* mesh (scale up/down or
   drop a failed pod): checkpoints store full logical arrays, the restore
   path re-shards onto the target topology, and the data pipeline replays
   from (seed, step), so the trajectory is preserved.

Straggler mitigation at SPMD scale is topology-level: the runner tracks a
rolling step-time watermark; when a step exceeds ``straggler_factor`` x the
median it records the event and (in a real deployment) triggers the elastic
path minus the slow pod.  On one host the detection logic is what the
tests cover.
"""
from __future__ import annotations

import logging
import signal
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

log = logging.getLogger("repro_torch.ft")

EXIT_PREEMPTED = 143


class PreemptionGuard:
    """Install signal handlers that request a graceful stop."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._prev = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:          # non-main thread (tests)
                pass
        return self

    def _handler(self, signum, frame):
        log.warning("preemption signal %s received; will save and exit "
                    "at the next step boundary", signum)
        self.requested = True

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        return False


@dataclass
class StepStats:
    times: List[float] = field(default_factory=list)
    straggler_events: List[int] = field(default_factory=list)

    def record(self, step: int, dt: float, factor: float = 3.0) -> bool:
        """Returns True if this step is a straggler outlier."""
        self.times.append(dt)
        window = self.times[-50:]
        med = sorted(window)[len(window) // 2]
        is_straggler = len(window) >= 5 and dt > factor * med
        if is_straggler:
            self.straggler_events.append(step)
            log.warning("straggler step %d: %.3fs vs median %.3fs",
                        step, dt, med)
        return is_straggler


def run_with_retries(step_fn: Callable, *, max_retries: int = 3,
                     backoff: float = 0.1,
                     retryable=(RuntimeError, OSError)):
    """Run one training step with transient-failure retries."""
    for attempt in range(max_retries + 1):
        try:
            return step_fn()
        except retryable as e:                     # pragma: no cover - timing
            if attempt == max_retries:
                raise
            log.warning("step failed (%s); retry %d/%d", e, attempt + 1,
                        max_retries)
            time.sleep(backoff * (2 ** attempt))
