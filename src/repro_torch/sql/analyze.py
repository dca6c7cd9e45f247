"""EXPLAIN ANALYZE: execute a plan with per-operator accounting.

``repro_torch.sql.execute(query, scope, explain="analyze")`` runs the
optimized plan op-by-op with tracing forced on and an active collector
(``lower.ANALYZE_COLLECTOR``), then renders the plan tree annotated
with per-operator wall time (total and self), input/output row counts,
bytes materialized, and — for joins — the algorithm the stats-driven
picker actually chose (mined from the ``core.join`` span recorded
under each ``sql.exec.Join`` span).

Wall times settle asynchronous launches per node (each node on a CUDA
frame waits for its device with ``torch.cuda.synchronize``), so an
analyzed run is slower than production execution — it buys honest
attribution, not a benchmark number.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch import obs

from .plan import (
    Aggregate,
    AttachScalar,
    Distinct,
    Filter,
    Join,
    Limit,
    Project,
    Shared,
    Sort,
    node_label,
)

__all__ = ["AnalyzeResult", "NodeStats", "run_analyze"]

_JOIN_ATTRS = ("algorithm", "build_rows", "probe_rows", "how")


@dataclasses.dataclass
class NodeStats:
    wall_ns: int = 0
    rows_out: Optional[int] = None
    rows_in: Optional[int] = None
    bytes_out: int = 0
    materialized: bool = True  # False: RowView (selection vectors only)
    span_id: int = 0
    calls: int = 0
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


class Collector:
    """Accumulates per-plan-node execution facts during lowering."""

    def __init__(self) -> None:
        self.stats: Dict[int, NodeStats] = {}  # id(node) -> stats

    def block(self, frame) -> None:
        """Wait for the frame's device so the node's wall time covers
        its compute, not just its launches (CPU work is synchronous)."""
        if frame.device.type == "cuda":
            torch.cuda.synchronize(frame.device)

    def record(
        self, node, wall_ns: int, out, span_id: int, rows_in=None
    ) -> None:
        st = self.stats.setdefault(id(node), NodeStats())
        st.calls += 1
        if st.calls > 1:  # memoized Shared re-request: keep first run
            return
        st.wall_ns = wall_ns
        st.span_id = span_id
        st.rows_in = rows_in
        st.rows_out = out.nrows
        if out.is_view:
            st.materialized = False
            rowmat = out._view.rowmat
            st.bytes_out = int(rowmat.nbytes) if rowmat is not None else 0
        else:
            st.bytes_out = int(out._itensor.nbytes) + int(out._ftensor.nbytes)

    def finalize(self, records) -> None:
        """Mine recorded spans: attach each ``core.join`` span's
        algorithm decision to the nearest enclosing plan-node span."""
        by_id = {s.span_id: s for s in records}
        node_of_span = {
            st.span_id: key
            for key, st in self.stats.items()
            if st.span_id
        }
        for s in records:
            if s.name != "core.join" or not s.attrs:
                continue
            p = s.parent_id
            while p:
                key = node_of_span.get(p)
                if key is not None:
                    extra = self.stats[key].extra
                    for k in _JOIN_ATTRS:
                        if k in s.attrs and k not in extra:
                            extra[k] = s.attrs[k]
                    break
                parent = by_id.get(p)
                p = parent.parent_id if parent is not None else 0


def _fmt_bytes(n: int) -> str:
    if n >= 1 << 30:
        return f"{n / (1 << 30):.2f}GiB"
    if n >= 1 << 20:
        return f"{n / (1 << 20):.2f}MiB"
    if n >= 1 << 10:
        return f"{n / (1 << 10):.1f}KiB"
    return f"{n}B"


def _fmt_ms(ns: int) -> str:
    return f"{ns / 1e6:.2f}ms"


class AnalyzeResult:
    """The frame plus the annotated plan; ``str()`` renders the tree."""

    def __init__(self, frame, plan, collector: Collector, wall_ns: int):
        self.frame = frame
        self.plan = plan
        self.stats = collector.stats
        self.wall_ns = wall_ns

    # -- rendering -------------------------------------------------------
    def _children(self, node):
        if isinstance(node, Join):
            return [node.left, node.right]
        if isinstance(node, AttachScalar):
            return [node.child, node.sub.v]
        if isinstance(
            node,
            (Filter, Aggregate, Project, Sort, Limit, Distinct, Shared),
        ):
            return [node.child]
        return []

    def _annotation(self, node) -> str:
        st = self.stats.get(id(node))
        if st is None:
            return "[not executed]"
        kids = [
            self.stats.get(id(c))
            for c in self._children(node)
            if self.stats.get(id(c)) is not None
        ]
        self_ns = max(st.wall_ns - sum(k.wall_ns for k in kids), 0)
        parts = [f"time={_fmt_ms(st.wall_ns)}", f"self={_fmt_ms(self_ns)}"]
        if st.rows_in is not None:
            parts.append(f"rows_in={st.rows_in}")
        if st.rows_out is not None:
            parts.append(f"rows={st.rows_out}")
        tag = "" if st.materialized else " (view)"
        parts.append(f"bytes={_fmt_bytes(st.bytes_out)}{tag}")
        if "algorithm" in st.extra:
            parts.append(f"algo={st.extra['algorithm']}")
            if "build_rows" in st.extra:
                parts.append(f"build={st.extra['build_rows']}")
        if st.calls > 1:
            parts.append(f"reused x{st.calls - 1}")
        return "[" + " ".join(parts) + "]"

    def _render(self, node, indent: int) -> str:
        pad = "  " * indent
        line = f"{pad}{node_label(node)}  {self._annotation(node)}"
        return "\n".join(
            [line]
            + [self._render(c, indent + 1) for c in self._children(node)]
        )

    def render(self) -> str:
        head = (
            f"== EXPLAIN ANALYZE ==  total {_fmt_ms(self.wall_ns)}, "
            f"{self.frame.nrows} row(s) out"
        )
        return head + "\n" + self._render(self.plan, 0)

    __str__ = render

    def __repr__(self) -> str:
        return self.render()

    # -- machine-readable -----------------------------------------------
    def to_dict(self) -> Dict:
        def walk(node):
            st = self.stats.get(id(node))
            d = {
                "node": type(node).__name__,
                "label": node_label(node),
                "children": [walk(c) for c in self._children(node)],
            }
            if st is not None:
                d.update(
                    wall_ms=st.wall_ns / 1e6,
                    rows_out=st.rows_out,
                    rows_in=st.rows_in,
                    bytes_out=st.bytes_out,
                    materialized=st.materialized,
                    **st.extra,
                )
            return d

        return {"total_ms": self.wall_ns / 1e6, "plan": walk(self.plan)}


def run_analyze(plan, frames, device=None) -> AnalyzeResult:
    """Execute ``plan`` op-by-op with the collector active and tracing
    forced on; restores ``CONFIG.tracing`` after.  Store scans land on
    ``device`` (default ``CONFIG.device``)."""
    import time

    from repro_torch.core.config import CONFIG

    from .lower import ANALYZE_COLLECTOR, lower_plan

    coll = Collector()
    saved = CONFIG.tracing
    if saved == "off":
        CONFIG.tracing = "on"
    mark = obs.mark_ns()
    token = ANALYZE_COLLECTOR.set(coll)
    t0 = time.perf_counter_ns()
    try:
        frame = lower_plan(plan, frames, device=device)
    finally:
        ANALYZE_COLLECTOR.reset(token)
        CONFIG.tracing = saved
    wall_ns = time.perf_counter_ns() - t0
    coll.finalize(obs.spans(since_ns=mark))
    return AnalyzeResult(frame, plan, coll, wall_ns)
