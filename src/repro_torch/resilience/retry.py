"""Bounded retry with exponential backoff + deterministic jitter.

``call(fn, site=...)`` re-invokes ``fn`` on *retryable* failures
(``OSError`` and ``TransientIOError`` by default — the classes spill
and store I/O raise, including injected chaos faults) up to
``CONFIG.io_retries`` times, sleeping ``base * 2**attempt * jitter``
between attempts.  Jitter draws from a module-level seeded RNG so test
runs are reproducible; sleeps are capped so a misconfigured budget can
never stall a worker for long.

Anything non-retryable (corrupt data -> ``ValueError``, semantic
errors, cancellation) propagates immediately — retrying cannot fix it
and must not delay the typed error on its way to the caller.

Imports no torch.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, Optional, Tuple, Type

from .errors import TransientIOError

__all__ = ["call"]

DEFAULT_RETRY_ON: Tuple[Type[BaseException], ...] = (
    OSError,
    EOFError,
    TransientIOError,
)

_MAX_SLEEP_S = 0.25

_LOCK = threading.Lock()
_RNG = random.Random(0xC0FFEE)

#: Observable retry counters (exposed through the ``resilience``
#: metrics group).
STATS: Dict[str, int] = {"retries": 0, "giveups": 0}


def reset_stats() -> None:
    with _LOCK:
        STATS["retries"] = 0
        STATS["giveups"] = 0


def call(
    fn: Callable,
    *,
    site: str = "",
    retries: Optional[int] = None,
    base_s: Optional[float] = None,
    retry_on: Tuple[Type[BaseException], ...] = DEFAULT_RETRY_ON,
):
    """Run ``fn`` with up to ``retries`` backoff retries on transient
    failures; re-raises the last failure when the budget is spent."""
    if retries is None or base_s is None:
        from repro_torch.core.config import CONFIG

        if retries is None:
            retries = max(0, int(CONFIG.io_retries))
        if base_s is None:
            base_s = float(CONFIG.io_retry_base_s)
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            if attempt >= retries:
                with _LOCK:
                    STATS["giveups"] += 1
                raise
            with _LOCK:
                STATS["retries"] += 1
                jitter = 0.5 + _RNG.random()  # [0.5, 1.5)
            delay = min(base_s * (2.0 ** attempt) * jitter, _MAX_SLEEP_S)
            from repro_torch import obs

            with obs.detailed_span(
                "resilience.backoff", site=site, attempt=attempt
            ):
                time.sleep(delay)
            attempt += 1
            last = e  # noqa: F841  (kept for debugger visibility)
