"""Span-based tracing: what happened between "scenario start" and "median".

The paper's method only works because every phase was individually timed;
this module makes the repo's own measurement stack observable the same
way.  A ``Span`` is one named interval on the process's monotonic clock
(``time.perf_counter``) with attributes, a parent, and a trace id; the
``Tracer`` keeps a thread-safe in-process buffer of finished spans and
exports it two ways:

  JSONL          one span per line — greppable, appendable, diffable
  Chrome trace   the ``traceEvents`` JSON that chrome://tracing and
                 https://ui.perfetto.dev load directly (complete "X"
                 events; span nesting becomes track stacking)

Tracing is OFF by default and the disabled path is a single attribute
check — the canonical timer's hot loop must not move by even a
microsecond when nobody is tracing.  Producers therefore either use
``tracer.span(...)`` as a context manager (fine outside timed regions) or
``tracer.record(name, t0, t1, ...)`` to log an interval *retroactively*
from timestamps they already took (``bench.timing`` does this: the timed
region contains zero tracing code).

Nesting is tracked per thread: a span opened while another is open on the
same thread becomes its child, and ``record()`` attaches to the innermost
open span.  Span attributes stay mutable until export, so producers may
annotate after the fact (e.g. flagging which trials were outlier-rejected
once the rejection ran).
"""
from __future__ import annotations

import json
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, IO, List, Optional, Union

__all__ = ["Span", "Tracer", "tracer", "get_tracer", "enable", "disable",
           "load_jsonl", "chrome_trace"]


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass
class Span:
    """One finished (or still-open) named interval."""
    name: str
    t0_us: float                        # perf_counter-based, microseconds
    t1_us: Optional[float] = None       # None while still open
    attrs: Dict[str, Any] = field(default_factory=dict)
    span_id: str = field(default_factory=_new_id)
    parent_id: Optional[str] = None
    trace_id: str = ""
    thread_id: int = 0

    @property
    def dur_us(self) -> float:
        return (self.t1_us - self.t0_us) if self.t1_us is not None else 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "t0_us": self.t0_us, "t1_us": self.t1_us,
                "dur_us": self.dur_us, "attrs": self.attrs,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "trace_id": self.trace_id, "thread_id": self.thread_id}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Span":
        return cls(name=d["name"], t0_us=d["t0_us"], t1_us=d.get("t1_us"),
                   attrs=dict(d.get("attrs", {})),
                   span_id=d.get("span_id", ""),
                   parent_id=d.get("parent_id"),
                   trace_id=d.get("trace_id", ""),
                   thread_id=int(d.get("thread_id", 0)))


def _now_us() -> float:
    return time.perf_counter() * 1e6


class _NoopSpanCtx:
    """The disabled path: one shared immutable context manager."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpanCtx()


class _SpanCtx:
    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        self._tracer._push(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self._span.attrs.setdefault("error", exc_type.__name__)
        self._tracer._pop(self._span)
        return False


class Tracer:
    """Thread-safe in-process span buffer.  One module-level instance
    (``tracer()``) serves the whole repo; tests may make their own."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.trace_id = _new_id()
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._local = threading.local()

    # -- lifecycle ----------------------------------------------------------

    def enable(self) -> "Tracer":
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
        self.trace_id = _new_id()

    # -- span production ----------------------------------------------------

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    def span(self, name: str, **attrs: Any):
        """Context manager for a live span; yields the ``Span`` (or None
        when tracing is disabled, so ``with ... as sp: if sp:`` guards)."""
        if not self.enabled:
            return _NOOP
        parent = self.current()
        sp = Span(name=name, t0_us=_now_us(), attrs=attrs,
                  parent_id=parent.span_id if parent else None,
                  trace_id=self.trace_id,
                  thread_id=threading.get_ident() & 0x7FFFFFFF)
        return _SpanCtx(self, sp)

    def _push(self, sp: Span) -> None:
        self._stack().append(sp)

    def _pop(self, sp: Span) -> None:
        sp.t1_us = _now_us()
        st = self._stack()
        if st and st[-1] is sp:
            st.pop()
        with self._lock:
            self._spans.append(sp)

    def record(self, name: str, t0_s: float, t1_s: float,
               **attrs: Any) -> Optional[Span]:
        """Log an interval retroactively from ``time.perf_counter()``
        readings the caller already took — zero tracing code runs inside
        the interval itself.  Attaches under the innermost open span."""
        if not self.enabled:
            return None
        parent = self.current()
        sp = Span(name=name, t0_us=t0_s * 1e6, t1_us=t1_s * 1e6, attrs=attrs,
                  parent_id=parent.span_id if parent else None,
                  trace_id=self.trace_id,
                  thread_id=threading.get_ident() & 0x7FFFFFFF)
        with self._lock:
            self._spans.append(sp)
        return sp

    # -- consumption --------------------------------------------------------

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def save_jsonl(self, out: Union[str, IO[str]]) -> int:
        """Write one span per line; returns the number written."""
        spans = self.spans()
        if hasattr(out, "write"):
            for sp in spans:
                out.write(json.dumps(sp.to_dict(), sort_keys=True) + "\n")
        else:
            with open(out, "w") as f:
                for sp in spans:
                    f.write(json.dumps(sp.to_dict(), sort_keys=True) + "\n")
        return len(spans)

    def chrome_trace(self) -> Dict[str, Any]:
        return chrome_trace(self.spans())


def load_jsonl(path: str) -> List[Span]:
    spans = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                spans.append(Span.from_dict(json.loads(line)))
    return spans


def chrome_trace(spans: List[Span]) -> Dict[str, Any]:
    """The Chrome trace-event JSON (Perfetto-loadable): complete "X" events,
    ``ts``/``dur`` in microseconds, one track per thread.  Span attributes
    travel in ``args`` (plus the span/parent ids, so the tree survives)."""
    pid = os.getpid()
    events = []
    for sp in spans:
        if sp.t1_us is None:
            continue
        args = {str(k): v for k, v in sp.attrs.items()}
        args["span_id"] = sp.span_id
        if sp.parent_id:
            args["parent_id"] = sp.parent_id
        events.append({
            "name": sp.name, "ph": "X", "cat": "repro",
            "ts": sp.t0_us, "dur": sp.dur_us,
            "pid": pid, "tid": sp.thread_id or pid, "args": args,
        })
    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"generator": "repro_torch.obs.trace"}}


# ---------------------------------------------------------------------------
# The process-wide tracer
# ---------------------------------------------------------------------------

_TRACER = Tracer()


def tracer() -> Tracer:
    return _TRACER


#: alias kept for hot-path importers (``from repro_torch.obs.trace import
#: get_tracer``) — same object, clearer intent at the call site.
get_tracer = tracer


def enable() -> Tracer:
    return _TRACER.enable()


def disable() -> Tracer:
    return _TRACER.disable()
