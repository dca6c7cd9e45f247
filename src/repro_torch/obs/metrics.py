"""Central metrics registry: one namespace over every engine counter.

Each engine layer keeps its own STATS object (``core.join.STATS``,
``sql.compile.STATS``, the store's spill and pool counters, the
resilience layer's fault and retry counts) where it is — those names keep working — but each module
registers itself here at import time, so ``obs.metrics.snapshot()``
reads every layer through one interface and ``reset()`` clears them all
(the port's test files reset through it before each test).

Native instruments (``counter``/``gauge``/``histogram``) cover new
instrumentation that has no legacy dict; they appear in snapshots under
the ``"obs"`` group.  ``diff(before, after)`` subtracts two snapshots
leaf-wise (numeric leaves only).

This module is a *namespace*, not a class: ``obs.metrics.snapshot()``
etc. delegate to one process-wide ``Registry``.  Thread-safe: group
snapshot/reset functions are called under the registry lock, and the
legacy objects guard their own mutation.  Imports no torch.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "counter",
    "diff",
    "gauge",
    "groups",
    "histogram",
    "load_engine_groups",
    "register_group",
    "reset",
    "snapshot",
]


class Counter:
    """Monotonic (between resets) thread-safe counter."""

    __slots__ = ("_lock", "_v")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._v = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        return self._v

    def reset(self) -> None:
        with self._lock:
            self._v = 0

    def snapshot(self):
        return self._v


class Gauge:
    """Last-write-wins value."""

    __slots__ = ("_v",)

    def __init__(self) -> None:
        self._v = 0.0

    def set(self, v: float) -> None:
        self._v = v

    @property
    def value(self) -> float:
        return self._v

    def reset(self) -> None:
        self._v = 0.0

    def snapshot(self):
        return self._v


_RESERVOIR = 4096


class Histogram:
    """count/sum/min/max plus a bounded recent-biased reservoir for
    percentiles (same halving policy as ``serve.ServeStats``)."""

    __slots__ = ("_lock", "count", "total", "vmin", "vmax", "_res")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self._res: list = []

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if v < self.vmin:
                self.vmin = v
            if v > self.vmax:
                self.vmax = v
            if len(self._res) >= _RESERVOIR:
                del self._res[: _RESERVOIR // 2]
            self._res.append(v)

    def percentile(self, p: float) -> float:
        with self._lock:
            res = sorted(self._res)
        if not res:
            return 0.0
        i = min(len(res) - 1, int(p * (len(res) - 1) + 0.5))
        return res[i]

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.total = 0.0
            self.vmin = float("inf")
            self.vmax = float("-inf")
            self._res = []

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            n, total = self.count, self.total
            vmin, vmax = self.vmin, self.vmax
        if n == 0:
            return {"count": 0, "sum": 0.0}
        return {
            "count": n,
            "sum": total,
            "min": vmin,
            "max": vmax,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }


class Registry:
    """Named groups of metrics; each group snapshots/resets as a unit."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._groups: "OrderedDict[str, tuple]" = OrderedDict()
        self._own: "OrderedDict[str, object]" = OrderedDict()

    # -- legacy/group registration --------------------------------------
    def register_group(
        self,
        name: str,
        snapshot: Callable[[], Dict],
        reset: Optional[Callable[[], None]] = None,
    ) -> None:
        """Expose an existing stats object through the registry.
        Re-registration replaces (modules may be reloaded in tests)."""
        with self._lock:
            self._groups[name] = (snapshot, reset)

    # -- native instruments ---------------------------------------------
    def _instrument(self, name: str, cls):
        with self._lock:
            inst = self._own.get(name)
            if inst is None:
                inst = self._own[name] = cls()
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}"
                )
        return inst

    def counter(self, name: str) -> Counter:
        return self._instrument(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._instrument(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._instrument(name, Histogram)

    # -- snapshot / reset / diff ----------------------------------------
    def groups(self) -> list:
        with self._lock:
            return list(self._groups)

    def snapshot(self) -> Dict[str, Dict]:
        """``{group: {key: value}}`` over every registered group plus
        native instruments (group ``"obs"``)."""
        with self._lock:
            items = list(self._groups.items())
            own = list(self._own.items())
        out: Dict[str, Dict] = {}
        for name, (snap, _) in items:
            try:
                out[name] = snap()
            except Exception as e:  # a broken group must not hide the rest
                out[name] = {"__error__": f"{type(e).__name__}: {e}"}
        if own:
            out["obs"] = {n: inst.snapshot() for n, inst in own}
        return out

    def reset(self) -> None:
        with self._lock:
            items = list(self._groups.items())
            own = list(self._own.values())
        for _, (_, rst) in items:
            if rst is not None:
                rst()
        for inst in own:
            inst.reset()

    @staticmethod
    def diff(before: Dict, after: Dict) -> Dict:
        """Leaf-wise ``after - before`` over numeric leaves (recursing
        into nested dicts); non-numeric leaves are dropped, keys only in
        ``after`` count from zero."""
        out: Dict = {}
        for k, av in after.items():
            bv = before.get(k)
            if isinstance(av, dict):
                sub = Registry.diff(bv if isinstance(bv, dict) else {}, av)
                if sub:
                    out[k] = sub
            elif isinstance(av, bool):
                continue
            elif isinstance(av, (int, float)):
                b = bv if isinstance(bv, (int, float)) and not isinstance(bv, bool) else 0
                d = av - b
                if d:
                    out[k] = d
        return out


#: The process-wide registry behind the module-level functions.
REGISTRY = Registry()

register_group = REGISTRY.register_group
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
snapshot = REGISTRY.snapshot
reset = REGISTRY.reset
groups = REGISTRY.groups
diff = Registry.diff


def load_engine_groups() -> list:
    """Import every engine layer that self-registers a metrics group
    (pulls torch — callers wanting the full engine view opt in; a bare
    ``import repro_torch.obs`` stays torch-free).  Returns the group names."""
    import repro_torch.core.join  # noqa: F401
    import repro_torch.sql.compile  # noqa: F401
    import repro_torch.store  # noqa: F401  (pool + spill)
    import repro_torch.resilience  # noqa: F401  (faults + retries)

    return groups()
