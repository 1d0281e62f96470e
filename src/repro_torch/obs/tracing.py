"""Span-based tracing for the planning/simulation hot seams.

A span is one timed region -- a GA generation, a fused DES fitness batch, a
MILP solve phase, a fleet admission decision.  Spans nest (a per-thread
stack tracks the active parent), survive exceptions (the duration is
recorded and the stack popped either way, with the exception type attached
to the span), and use monotonic clocks, so a span summary is a faithful
"where did the wall clock go" decomposition.

Cost model: tracing is DISABLED by default.  A disabled `span()` returns a
shared no-op context manager -- one attribute check, no allocation -- so
instrumenting per-generation / per-batch paths costs well under the 2%
budget of even the smoke-sized GA runs (see tests/test_obs.py, which bounds
the per-call overhead directly).  Enable via `tracer.enable()`,
``$REPRO_TRACE=1``, or the `enabled(...)` context manager.

Exports:
  * `Tracer.summary()`   -- {span name: {count, total_s, max_s}} rollup (the
    jit-vs-simulate-vs-solve split the benchmark rows attach);
  * `Tracer.to_chrome_trace()` -- Chrome trace-event JSON (Perfetto-ready),
    one track per originating thread, nesting preserved via B/E pairs
    rendered as complete ``X`` events.

One process-wide default tracer (`TRACER`) is shared by all instrumented
modules; `span(name, **attrs)` is the module-level shorthand bound to it.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time

__all__ = ["SpanRecord", "Tracer", "TRACER", "span", "enabled"]


class SpanRecord:
    """One closed span: name, [t0, t0+dur) on the monotonic clock, parent
    span name (or None at the root), nesting depth, originating thread and
    free-form attrs (plus ``error`` when the body raised)."""

    __slots__ = ("name", "t0", "dur", "parent", "depth", "thread", "attrs")

    def __init__(self, name: str, t0: float, dur: float,
                 parent: str | None, depth: int, thread: int, attrs: dict):
        self.name = name
        self.t0 = t0
        self.dur = dur
        self.parent = parent
        self.depth = depth
        self.thread = thread
        self.attrs = attrs

    def as_dict(self) -> dict:
        return {"name": self.name, "t0": self.t0, "dur": self.dur,
                "parent": self.parent, "depth": self.depth,
                "thread": self.thread, "attrs": self.attrs}

    def __repr__(self) -> str:   # pragma: no cover - debugging aid
        return (f"SpanRecord({self.name!r}, dur={self.dur:.6f}, "
                f"parent={self.parent!r})")


class _NullSpan:
    """Shared no-op context manager: the disabled-mode fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        """Attr updates are dropped when tracing is off."""


_NULL_SPAN = _NullSpan()


class _Span:
    """Active span handle; closes into a `SpanRecord` on exit."""

    __slots__ = ("_tracer", "name", "attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> None:
        """Attach attrs mid-span (e.g. a result size known only at the
        end of the body)."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        stack = self._tracer._stack()
        stack.append(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self._t0
        stack = self._tracer._stack()
        # exception safety: pop our own frame even if the body replaced
        # the stack contents via nested tracer misuse
        if stack and stack[-1] == self.name:
            stack.pop()
        elif self.name in stack:   # pragma: no cover - defensive
            stack.remove(self.name)
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        parent = stack[-1] if stack else None
        self._tracer._record(SpanRecord(
            self.name, self._t0, dur, parent, len(stack),
            threading.get_ident(), self.attrs))
        return False   # never swallow the exception


class Tracer:
    """Thread-safe span collector with a per-thread nesting stack."""

    def __init__(self, enabled: bool | None = None,
                 max_records: int = 1_000_000):
        if enabled is None:
            enabled = os.environ.get("REPRO_TRACE", "0") not in ("0", "")
        self._enabled = bool(enabled)
        self.max_records = int(max_records)
        self.dropped = 0
        self._records: list[SpanRecord] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    # ------------------------------------------------------------ state
    @property
    def is_enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    @contextlib.contextmanager
    def enabled(self, on: bool = True):
        """Temporarily flip tracing on/off (benchmark harness hook)."""
        prev = self._enabled
        self._enabled = bool(on)
        try:
            yield self
        finally:
            self._enabled = prev

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self.dropped = 0

    def _stack(self) -> list[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, rec: SpanRecord) -> None:
        with self._lock:
            if len(self._records) >= self.max_records:
                self.dropped += 1
                return
            self._records.append(rec)

    # ------------------------------------------------------------- spans
    def span(self, name: str, **attrs):
        """Context manager timing one region.  Near-free when disabled."""
        if not self._enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    @property
    def records(self) -> list[SpanRecord]:
        with self._lock:
            return list(self._records)

    # ----------------------------------------------------------- exports
    def summary(self) -> dict[str, dict[str, float]]:
        """Per-name rollup: {name: {count, total_s, max_s}}."""
        out: dict[str, dict[str, float]] = {}
        for rec in self.records:
            row = out.setdefault(rec.name,
                                 {"count": 0, "total_s": 0.0, "max_s": 0.0})
            row["count"] += 1
            row["total_s"] += rec.dur
            row["max_s"] = max(row["max_s"], rec.dur)
        return out

    def to_chrome_trace(self, process_name: str = "repro_torch") -> dict:
        """Chrome trace-event JSON: complete (``X``) events in µs, one
        track per originating thread, openable in Perfetto / about:tracing.
        """
        events: list[dict] = [{
            "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
            "args": {"name": process_name}}]
        threads = {}
        for rec in self.records:
            tid = threads.setdefault(rec.thread, len(threads))
            events.append({
                "name": rec.name, "ph": "X", "pid": 0, "tid": tid,
                "ts": rec.t0 * 1e6, "dur": rec.dur * 1e6,
                "args": {**rec.attrs, "parent": rec.parent}})
        for ident, tid in threads.items():
            events.append({"name": "thread_name", "ph": "M", "pid": 0,
                           "tid": tid, "args": {"name": f"thread-{ident}"}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}


TRACER = Tracer()


def span(name: str, **attrs):
    """Shorthand for ``TRACER.span(...)`` (the instrumentation call every
    hot seam uses; one attribute check when tracing is off)."""
    if not TRACER._enabled:
        return _NULL_SPAN
    return _Span(TRACER, name, attrs)


def enabled(on: bool = True):
    """Shorthand for ``TRACER.enabled(...)``."""
    return TRACER.enabled(on)
