"""Engine observability for the port.

Three pieces behind one namespace:

- **Span tracing** (``obs.span`` / ``obs.detailed_span``): nestable
  timed regions in lock-free per-thread ring buffers, toggled by
  ``CONFIG.tracing = "off" | "on" | "detailed"``.  Disabled mode is one
  branch and no allocation.
- **Profiler bridge**: while tracing is on and a ``torch.profiler``
  session records, each span also opens a profiler record of its own
  name (``torch._C._profiler._RecordFunctionFast``), so the profiler's
  host and device timeline names the program's layers.
- **Metrics** (``obs.metrics``): a central registry absorbing every
  layer's STATS object (``core.join``, ``core.load``, ``sql.compile``,
  ``store.pool``, ``store.spill``, ``resilience`` — the module-level
  names stay valid aliases) plus native counters, with ``snapshot()`` /
  ``reset()`` / ``diff()``.
- **Exporters**: ``obs.export_chrome_trace(path)`` (open in Perfetto /
  chrome://tracing beside the profiler's own trace: both are on the
  epoch clock) and ``obs.export_json()`` (operator-time breakdown +
  metrics snapshot).

The spans along one SQL query, root first: ``sql.execute`` (attribute
``route``: ``compiled_hit``, ``compiled_miss``, ``fallback`` or
``op_by_op``; ``digest`` when compiled) over ``sql.parse``,
``sql.plan``, ``sql.optimize``, then ``sql.compile.prepare`` (host work
before the replay; ``tables``) and ``sql.compile.execute`` (``digest``,
``cache_hit``, ``rows``), or op by op ``sql.exec.<Node>`` with
``core.join`` beneath; the result's trip to the host is
``frame.to_host`` (``rows``, ``columns``).  Counters at the same
boundaries, always on: ``frame.d2h_copies`` (native, group
``"obs"``), ``core.load``'s ``factorize_s`` and ``sql.compile``'s hits
and misses.

Import-time constraint: ``import repro_torch.obs`` is host-side Python
and imports no torch — engine layers register their metrics groups when
they import, and ``obs.metrics.load_engine_groups()`` pulls them all in
explicitly.
"""
from . import metrics  # noqa: F401  (module-as-namespace)
from .export import aggregate_operators, export_chrome_trace, export_json
from .trace import (
    SpanRecord,
    annotate,
    clear as clear_trace,
    current_span_id,
    detailed,
    detailed_span,
    dropped,
    enabled,
    mark_ns,
    span,
    spans,
)

__all__ = [
    "SpanRecord",
    "aggregate_operators",
    "annotate",
    "clear_trace",
    "current_span_id",
    "detailed",
    "detailed_span",
    "dropped",
    "enabled",
    "export_chrome_trace",
    "export_json",
    "mark_ns",
    "metrics",
    "span",
    "spans",
]
