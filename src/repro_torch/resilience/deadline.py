"""Per-request deadlines and cooperative cancellation.

A ``Deadline`` pairs an optional absolute expiry (monotonic clock) with
a ``CancelToken``.  The executing thread enters a ``deadline_scope``
(contextvar-backed, nestable — the innermost scope wins) and the engine
calls ``checkpoint()`` at safe boundaries (in the JAX package: between
plan operators, at every streamed chunk and at admission-queue dequeue;
the port's SQL, out-of-core and serving layers are still to come).
``checkpoint`` is a single contextvar read
when no scope is active, so instrumented hot paths cost nothing in
normal operation.

Cancellation is *cooperative*: a request inside one device kernel
cannot be interrupted mid-kernel; it is caught at the next checkpoint.

Imports no torch.
"""
from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from typing import Optional

from .errors import QueryCancelled, QueryTimeout

__all__ = [
    "CancelToken",
    "Deadline",
    "checkpoint",
    "current",
    "deadline_scope",
]


class CancelToken:
    """Thread-safe one-way cancellation flag."""

    __slots__ = ("_event",)

    def __init__(self) -> None:
        self._event = threading.Event()

    def cancel(self) -> None:
        self._event.set()

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()


class Deadline:
    """An expiry instant plus a cancel token, checked at checkpoints."""

    __slots__ = ("expires_at", "token")

    def __init__(
        self,
        timeout_s: Optional[float] = None,
        *,
        at: Optional[float] = None,
        token=None,
    ) -> None:
        if at is not None:
            self.expires_at: Optional[float] = at
        elif timeout_s is not None:
            self.expires_at = time.monotonic() + float(timeout_s)
        else:
            self.expires_at = None
        self.token = token if token is not None else CancelToken()

    @property
    def expired(self) -> bool:
        return (
            self.expires_at is not None
            and time.monotonic() > self.expires_at
        )

    def remaining(self) -> Optional[float]:
        if self.expires_at is None:
            return None
        return self.expires_at - time.monotonic()

    def check(self, site: str = "") -> None:
        """Raise the typed error if cancelled or past the deadline."""
        if self.token is not None and self.token.cancelled:
            raise QueryCancelled(
                f"cancelled at {site or 'checkpoint'}"
            )
        if self.expired:
            over = time.monotonic() - self.expires_at
            raise QueryTimeout(
                f"deadline exceeded by {over * 1e3:.1f}ms at "
                f"{site or 'checkpoint'}"
            )


_SCOPE: "contextvars.ContextVar[Optional[Deadline]]" = (
    contextvars.ContextVar("repro_deadline", default=None)
)


def current() -> Optional[Deadline]:
    return _SCOPE.get()


@contextlib.contextmanager
def deadline_scope(
    timeout_s: Optional[float] = None,
    *,
    at: Optional[float] = None,
    token=None,
):
    """Run the body under a ``Deadline`` visible to ``checkpoint()``.

    Note contextvars do not propagate into worker threads spawned
    *inside* the scope body; the engine's own threads (chunk prefetch)
    deliberately leave deadline enforcement to the consuming thread.
    """
    d = Deadline(timeout_s, at=at, token=token)
    tok = _SCOPE.set(d)
    try:
        yield d
    finally:
        _SCOPE.reset(tok)


def checkpoint(site: str = "") -> None:
    """Cooperative cancellation/deadline check — cheap no-op without an
    active scope."""
    d = _SCOPE.get()
    if d is not None:
        d.check(site)
