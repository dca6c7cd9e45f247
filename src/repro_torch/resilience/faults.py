"""Deterministic fault injection for chaos testing.

``inject(site, exc=OSError, rate=0.3, seed=7)`` arms a seeded fault
rule for the duration of a ``with`` block; every instrumented boundary
in the engine calls ``fault_point(site)`` and an armed rule either
raises a fresh ``exc`` or (with ``delay_s``) sleeps — the mechanism the
resilience tests use to make queries slow without touching engine code.

Rules are *scoped by the context manager but visible process-wide*
while armed: the serving worker, chunk-prefetch producers and spill
I/O all run on threads that do not inherit the arming thread's
contextvars, so a thread-local registry would silently miss exactly the
paths chaos tests need to hit.  Each rule draws from its own
``random.Random(seed)`` under a lock, so a single-threaded run triggers
on an exactly reproducible subsequence of hits; multi-threaded runs
stay seeded per rule (which *hit* fires varies with scheduling, the
trigger count distribution does not).

``fault_point`` is one attribute read + truthiness check when nothing
is armed, so production paths keep their hooks for free.

Imports no torch.
"""
from __future__ import annotations

import contextlib
import random
import threading
import time
from typing import Dict, List, Optional, Type

__all__ = ["FaultRule", "clear", "fault_point", "inject", "sites_hit"]

_LOCK = threading.Lock()
_RULES: List["FaultRule"] = []

#: Observable injection counters (registered as the ``resilience``
#: metrics group by the package __init__).
STATS: Dict[str, Dict[str, int]] = {"injected": {}, "delayed": {}}


def reset_stats() -> None:
    with _LOCK:
        STATS["injected"] = {}
        STATS["delayed"] = {}


class FaultRule:
    """One armed fault: raise ``exc`` (or sleep ``delay_s``) at
    ``site`` with probability ``rate``, at most ``limit`` times."""

    def __init__(
        self,
        site: str,
        exc: Optional[Type[BaseException]] = OSError,
        *,
        rate: float = 1.0,
        seed: int = 0,
        limit: Optional[int] = None,
        delay_s: Optional[float] = None,
    ) -> None:
        self.site = site
        self.exc = exc
        self.rate = float(rate)
        self.limit = limit
        self.delay_s = delay_s
        self._rng = random.Random(seed)
        self.triggered = 0
        self.hits = 0

    def _roll(self) -> bool:
        """Under _LOCK: should this hit trigger?"""
        self.hits += 1
        if self.limit is not None and self.triggered >= self.limit:
            return False
        if self._rng.random() >= self.rate:
            return False
        self.triggered += 1
        return True


def fault_point(site: str) -> None:
    """Engine-side hook: every I/O and compile boundary calls this."""
    if not _RULES:  # unlocked fast path: chaos-off costs one check
        return
    fire: List[FaultRule] = []
    with _LOCK:
        for rule in _RULES:
            if rule.site == site and rule._roll():
                kind = "delayed" if rule.delay_s is not None else "injected"
                STATS[kind][site] = STATS[kind].get(site, 0) + 1
                fire.append(rule)
    for rule in fire:
        if rule.delay_s is not None:
            time.sleep(rule.delay_s)
        else:
            raise rule.exc(f"injected fault at {site}")


@contextlib.contextmanager
def inject(
    site: str,
    exc: Optional[Type[BaseException]] = OSError,
    *,
    rate: float = 1.0,
    seed: int = 0,
    limit: Optional[int] = None,
    delay_s: Optional[float] = None,
):
    """Arm a fault rule for the with-block (process-wide; see module
    docstring).  Yields the rule so tests can read ``triggered``."""
    rule = FaultRule(
        site, exc, rate=rate, seed=seed, limit=limit, delay_s=delay_s
    )
    with _LOCK:
        _RULES.append(rule)
    try:
        yield rule
    finally:
        with _LOCK:
            try:
                _RULES.remove(rule)
            except ValueError:
                pass


def clear() -> None:
    """Disarm every rule (test teardown safety net)."""
    with _LOCK:
        _RULES.clear()


def sites_hit() -> Dict[str, int]:
    """``{site: times a rule actually fired}`` since the last reset."""
    with _LOCK:
        out: Dict[str, int] = {}
        for kind in ("injected", "delayed"):
            for site, n in STATS[kind].items():
                out[site] = out.get(site, 0) + n
        return out
