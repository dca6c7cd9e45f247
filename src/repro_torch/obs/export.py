"""Exporters: Chrome/Perfetto ``trace_event`` JSON and JSON profiles.

``export_chrome_trace(path)`` writes the recorded spans as complete
("ph": "X") trace events — open the file at https://ui.perfetto.dev or
chrome://tracing to see per-thread operator timelines.

``export_json()`` returns the machine-readable profile: an
operator-time breakdown aggregated by span name (count, total/self
milliseconds) plus a full metrics snapshot.  Imports no torch.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from . import metrics as _metrics
from . import trace as _trace

__all__ = ["aggregate_operators", "export_chrome_trace", "export_json"]


def _span_args(attrs) -> Dict:
    if not attrs:
        return {}
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = repr(v)
    return out


def export_chrome_trace(
    path: str, since_ns: Optional[int] = None
) -> int:
    """Write recorded spans as Chrome ``trace_event`` JSON; returns the
    number of events written."""
    records = _trace.spans(since_ns=since_ns)
    pid = os.getpid()
    events: List[Dict] = []
    names = {}
    for s in records:
        events.append(
            {
                "name": s.name,
                "cat": s.name.split(".", 1)[0],
                "ph": "X",
                "ts": s.start_ns / 1e3,  # microseconds
                "dur": s.dur_ns / 1e3,
                "pid": pid,
                "tid": s.tid,
                "args": _span_args(s.attrs),
            }
        )
        names.setdefault(s.tid, s.thread)
    # thread-name metadata rows make the Perfetto timeline readable
    for tid, tname in names.items():
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": tname},
            }
        )
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    with open(path, "w") as fh:
        json.dump(doc, fh)
        fh.write("\n")
    return len(events)


def aggregate_operators(records) -> Dict[str, Dict]:
    """Per span-name totals: ``{name: {count, total_ms, self_ms}}``.

    ``self_ms`` subtracts each span's direct children, so nested
    operator spans don't double-count toward a breakdown."""
    child_ns: Dict[int, int] = {}
    for s in records:
        if s.parent_id:
            child_ns[s.parent_id] = child_ns.get(s.parent_id, 0) + s.dur_ns
    out: Dict[str, Dict] = {}
    for s in records:
        rec = out.setdefault(
            s.name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0}
        )
        rec["count"] += 1
        rec["total_ms"] += s.dur_ns / 1e6
        rec["self_ms"] += max(s.dur_ns - child_ns.get(s.span_id, 0), 0) / 1e6
    for rec in out.values():
        rec["total_ms"] = round(rec["total_ms"], 3)
        rec["self_ms"] = round(rec["self_ms"], 3)
    return out


def export_json(since_ns: Optional[int] = None) -> Dict:
    """Profile document: operator-time breakdown + metrics snapshot."""
    records = _trace.spans(since_ns=since_ns)
    return {
        "schema": "repro-obs/v1",
        "operators": aggregate_operators(records),
        "spans_recorded": len(records),
        "spans_dropped": _trace.dropped(),
        "metrics": _metrics.snapshot(),
    }
