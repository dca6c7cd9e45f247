"""Span tracer: nestable timed regions in per-thread ring buffers.

``span("join.direct_probe", rows=...)`` opens a context manager that
records name, monotonic wall-clock interval, thread, parent span, and
free-form attributes on exit.  Records land in a fixed-capacity ring
buffer owned by the writing thread — appends take no lock (only the
owner writes; readers snapshot under the GIL), so tracing from the
serve worker, prefetch threads, and client threads never contend.

Toggled by ``CONFIG.tracing``:

- ``"off"`` (default): ``span()`` returns one shared no-op context
  manager — a single branch, no allocation, no clock read;
- ``"on"``: operator-level spans record (joins, spill events);
- ``"detailed"``: additionally records per-chunk spans
  (``detailed_span``), such as retry backoffs.

While a span records and a ``torch.profiler`` session is recording, the
span also opens a profiler record of its own name, closed with it, so
the profiler's timeline (host and device, on the epoch clock) names the
program's layers.  ``SpanRecord.start_ns`` stays on ``perf_counter_ns``
(``mark_ns()`` floors are on that clock); ``EPOCH_OFFSET_NS`` moves it
onto the profiler's epoch clock.

This module imports no torch: the profiler is looked up in
``sys.modules``, and ``CONFIG`` is resolved lazily on first use,
mirroring ``repro_torch.store.spill``.
"""
from __future__ import annotations

import itertools
import sys
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

__all__ = [
    "EPOCH_OFFSET_NS",
    "SpanRecord",
    "annotate",
    "clear",
    "current_span_id",
    "detailed",
    "detailed_span",
    "enabled",
    "span",
    "spans",
]

_CFG = None


def _cfg():
    global _CFG
    if _CFG is None:
        from repro_torch.core.config import CONFIG  # lazy: keeps obs torch-free

        _CFG = CONFIG
    return _CFG


#: Per-thread ring capacity (spans).  A full ring overwrites its oldest
#: records and counts them in ``dropped``.
CAPACITY = 1 << 16

#: ``time_ns() - perf_counter_ns()``, taken once at import: a span's
#: ``start_ns`` plus this is its start on the epoch clock, the clock of
#: ``torch.profiler``'s events.
EPOCH_OFFSET_NS = time.time_ns() - time.perf_counter_ns()

_IDS = itertools.count(1)  # next() is atomic under the GIL
_LOCK = threading.Lock()
_RINGS: List["_Ring"] = []


class SpanRecord(NamedTuple):
    name: str
    tid: int
    thread: str
    start_ns: int
    dur_ns: int
    span_id: int
    parent_id: int  # 0 = top-level
    attrs: Optional[Dict[str, Any]]


class _Ring:
    """Fixed-capacity overwrite-oldest buffer; single-writer."""

    __slots__ = ("buf", "cap", "i", "dropped", "tid", "thread")

    def __init__(self, cap: int, tid: int, thread: str) -> None:
        self.buf: List[SpanRecord] = []
        self.cap = cap
        self.i = 0
        self.dropped = 0
        self.tid = tid
        self.thread = thread

    def append(self, rec: SpanRecord) -> None:
        if len(self.buf) < self.cap:
            self.buf.append(rec)
        else:
            self.buf[self.i] = rec
            self.i = (self.i + 1) % self.cap
            self.dropped += 1


class _State(threading.local):
    """Per-thread open-span stack + ring, created on first span."""

    def __init__(self) -> None:
        t = threading.current_thread()
        self.stack: List["_Span"] = []
        self.ring = _Ring(CAPACITY, t.ident or 0, t.name)
        with _LOCK:
            _RINGS.append(self.ring)


_STATE = _State()


class _NoopSpan:
    """Shared disabled-mode span: every call is a no-op."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def set(self, **attrs) -> None:
        pass

    span_id = 0


_NOOP = _NoopSpan()


def _profiler_record(name: str):
    """An entered ``torch.profiler`` record of ``name`` while a profiler
    records in this process, else None.  Never imports torch."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return None
    rec = torch._C._profiler._RecordFunctionFast(name)
    rec.__enter__()
    return rec


class _Span:
    __slots__ = ("name", "attrs", "t0", "span_id", "parent_id", "rec")

    def __init__(self, name: str, attrs: Optional[Dict[str, Any]]) -> None:
        self.name = name
        self.attrs = attrs or None

    def set(self, **attrs) -> None:
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        st = _STATE
        self.parent_id = st.stack[-1].span_id if st.stack else 0
        self.span_id = next(_IDS)
        st.stack.append(self)
        self.rec = _profiler_record(self.name)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        if self.rec is not None:
            self.rec.__exit__(None, None, None)
        st = _STATE
        if st.stack and st.stack[-1] is self:
            st.stack.pop()
        else:  # mis-nested exit (should not happen); drop gracefully
            try:
                st.stack.remove(self)
            except ValueError:
                pass
        st.ring.append(
            SpanRecord(
                self.name,
                st.ring.tid,
                st.ring.thread,
                self.t0,
                t1 - self.t0,
                self.span_id,
                self.parent_id,
                self.attrs,
            )
        )


def enabled() -> bool:
    return _cfg().tracing != "off"


def detailed() -> bool:
    return _cfg().tracing == "detailed"


def span(name: str, **attrs):
    """Open a traced region; ``with obs.span("x", rows=n) as sp: ...``.

    Disabled mode returns one shared no-op object (no allocation)."""
    if _cfg().tracing == "off":
        return _NOOP
    return _Span(name, attrs)


def detailed_span(name: str, **attrs):
    """A span recorded only under ``CONFIG.tracing = "detailed"``
    (per-chunk events that would dominate the ring at scale)."""
    if _cfg().tracing != "detailed":
        return _NOOP
    return _Span(name, attrs)


def annotate(**attrs) -> None:
    """Attach attributes to the innermost open span of this thread
    (no-op when tracing is off or no span is open).  Lets deep engine
    code report decisions — e.g. the chosen join algorithm — without
    plumbing a handle through every call."""
    st = _STATE
    if st.stack:
        st.stack[-1].set(**attrs)


def current_span_id() -> int:
    st = _STATE
    return st.stack[-1].span_id if st.stack else 0


def spans(since_ns: Optional[int] = None) -> List[SpanRecord]:
    """Snapshot every thread's recorded spans, oldest first."""
    with _LOCK:
        rings = list(_RINGS)
    out: List[SpanRecord] = []
    for r in rings:
        out.extend(r.buf)  # GIL-atomic enough: records are immutable
    if since_ns is not None:
        out = [s for s in out if s.start_ns >= since_ns]
    out.sort(key=lambda s: s.start_ns)
    return out


def dropped() -> int:
    with _LOCK:
        return sum(r.dropped for r in _RINGS)


def clear() -> None:
    """Drop all recorded spans (open spans on other threads may lose
    their record — tracing is best-effort by design)."""
    with _LOCK:
        for r in _RINGS:
            r.buf = []
            r.i = 0
            r.dropped = 0


def mark_ns() -> int:
    """A monotonic timestamp usable as ``spans(since_ns=...)`` floor."""
    return time.perf_counter_ns()
