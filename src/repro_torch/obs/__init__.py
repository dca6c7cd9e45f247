"""Engine observability for the port.

Three pieces behind one namespace:

- **Span tracing** (``obs.span`` / ``obs.detailed_span``): nestable
  timed regions in lock-free per-thread ring buffers, toggled by
  ``CONFIG.tracing = "off" | "on" | "detailed"``.  Disabled mode is one
  branch and no allocation.
- **Metrics** (``obs.metrics``): a central registry absorbing every
  layer's STATS object (``core.join``, ``store.pool``, ``store.spill``,
  ``resilience`` — the module-level names stay valid aliases) plus
  native counters/gauges/histograms, with ``snapshot()`` / ``reset()``
  / ``diff()``.
- **Exporters**: ``obs.export_chrome_trace(path)`` (open in Perfetto /
  chrome://tracing) and ``obs.export_json()`` (operator-time breakdown
  + metrics snapshot).

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
