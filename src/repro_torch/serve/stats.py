"""Serving observability: lock-guarded counters + latency reservoir.

One process-wide ``STATS`` object mirrors ``repro_torch.sql.compile.STATS``
for the serving tier: how many queries were admitted, how they were
grouped into micro-batches, how often batching paid off (shared store
scans, coalesced duplicates, compiled-plan cache hits), and end-to-end
latency percentiles from a bounded reservoir.  Every mutation happens
under one lock — the admission worker and arbitrary client threads
both write here.
"""
from __future__ import annotations

import threading
from typing import Dict, List

__all__ = ["STATS", "ServeStats"]

_RESERVOIR = 4096


def _fresh() -> Dict[str, int]:
    return {
        "admitted": 0,  # queries accepted into the queue
        "batches": 0,  # micro-batches executed
        "batched_queries": 0,  # queries that shared a batch with >=1 other
        "shared_scan_groups": 0,  # store-scan groups answered by one pass
        "shared_scan_queries": 0,  # queries that rode a shared scan
        "shared_scan_errors": 0,  # shared passes that fell back per-query
        "plan_cache_hits": 0,  # compiled-plan cache hits during serving
        "coalesced": 0,  # duplicate queries answered by one execution
        "prepared": 0,  # executions through a Prepared statement
        "udf_queries": 0,  # executions under a non-empty UDF registry
        "shed_requests": 0,  # requests resolved without executing
        "worker_restarts": 0,  # admission workers found dead + restarted
    }


#: Per-query latency decomposition recorded by the executor: time in
#: the admission queue, batch planning, compiled-path trace+capture,
#: and engine execution.
PHASES = ("queue", "plan", "compile", "execute")


def _quantiles(lat: List[float], points: Dict[str, float]) -> Dict[str, float]:
    lat = sorted(lat)
    if not lat:
        return {name: 0.0 for name in points}

    def q(p: float) -> float:
        i = min(len(lat) - 1, int(p * (len(lat) - 1) + 0.5))
        return lat[i] * 1e3

    return {name: q(p) for name, p in points.items()}


class ServeStats:
    """Counters + latency reservoir for the serving layer."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts = _fresh()
        self._errors: Dict[str, int] = {}  # QueryError code -> count
        self._shed: Dict[str, int] = {}  # shed reason -> count
        self._lat: List[float] = []  # seconds, bounded reservoir
        self._phase: Dict[str, List[float]] = {p: [] for p in PHASES}

    def bump(self, **deltas: int) -> None:
        with self._lock:
            for k, d in deltas.items():
                self._counts[k] += d

    def bump_error(self, code: str, n: int = 1) -> None:
        """Count ``n`` queries resolved with a typed error of ``code``
        (``repro_torch.resilience.errors`` class tags)."""
        with self._lock:
            self._errors[code] = self._errors.get(code, 0) + n

    def bump_shed(self, reason: str, n: int = 1) -> None:
        """Count ``n`` requests shed without executing (deadline passed
        in queue, queue overflow, cancel, shutdown)."""
        with self._lock:
            self._counts["shed_requests"] += n
            self._shed[reason] = self._shed.get(reason, 0) + n

    @staticmethod
    def _push(lat: List[float], seconds: float) -> None:
        if len(lat) >= _RESERVOIR:
            # drop the oldest half; percentiles stay recent-biased
            del lat[: _RESERVOIR // 2]
        lat.append(float(seconds))

    def record_latency(self, seconds: float) -> None:
        with self._lock:
            self._push(self._lat, seconds)

    def record_phase(self, phase: str, seconds: float) -> None:
        """Record one query's time in an admission/execution phase
        (``PHASES``); each phase keeps its own percentile reservoir."""
        with self._lock:
            self._push(self._phase[phase], seconds)

    def percentiles(self) -> Dict[str, float]:
        """p50/p90/p95/p99 end-to-end latency in milliseconds."""
        with self._lock:
            lat = list(self._lat)
        return _quantiles(
            lat, {"p50_ms": 0.50, "p90_ms": 0.90, "p95_ms": 0.95,
                  "p99_ms": 0.99}
        )

    def phase_percentiles(self) -> Dict[str, Dict[str, float]]:
        """Per-phase p50/p95/p99 (ms): where a served query's latency
        goes — queueing, planning, compiling, or executing."""
        with self._lock:
            phases = {p: list(lat) for p, lat in self._phase.items()}
        return {
            p: dict(
                _quantiles(
                    lat, {"p50_ms": 0.50, "p95_ms": 0.95, "p99_ms": 0.99}
                ),
                count=len(lat),
            )
            for p, lat in phases.items()
        }

    def snapshot(self) -> Dict:
        with self._lock:
            out = dict(self._counts)
            out["errors"] = dict(self._errors)
            out["errors_total"] = sum(self._errors.values())
            out["shed"] = dict(self._shed)
            n = len(self._lat)
        out["latencies_recorded"] = n
        out.update(self.percentiles())
        out["phases"] = self.phase_percentiles()
        return out

    def reset(self) -> None:
        with self._lock:
            self._counts = _fresh()
            self._errors = {}
            self._shed = {}
            self._lat = []
            self._phase = {p: [] for p in PHASES}

    def __getitem__(self, key: str) -> int:
        with self._lock:
            if key == "errors":  # legacy alias: total across classes
                return sum(self._errors.values())
            return self._counts[key]


STATS = ServeStats()

from repro_torch import obs as _obs  # noqa: E402  (torch-free)

_obs.metrics.register_group("serve", STATS.snapshot, STATS.reset)
