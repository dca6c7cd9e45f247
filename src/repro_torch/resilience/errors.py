"""Typed error taxonomy for the serving/execution stack.

Every failure that crosses a subsystem boundary (admission queue ->
client, engine -> serving layer, spill manager -> pipeline) is wrapped
in a ``QueryError`` subclass, so callers can tell *retryable* faults
(``TransientIOError``) from *semantic* ones (``PlanError``), *policy*
ones (``QueryTimeout`` / ``QueryCancelled`` / ``ResourceExhausted``)
and *unclassified* engine failures (``ExecutionError``) without string
matching.  ``classify`` is the single choke point that maps foreign
exceptions onto the taxonomy; the original exception always rides along
as ``__cause__``.

Imports no torch (the store and obs layers depend on it).
"""
from __future__ import annotations

__all__ = [
    "ExecutionError",
    "PlanError",
    "QueryCancelled",
    "QueryError",
    "QueryTimeout",
    "ResourceExhausted",
    "TransientIOError",
    "classify",
]


class QueryError(Exception):
    """Base of every typed serving/execution failure.

    ``retryable`` tells callers whether re-submitting the same request
    can reasonably succeed; ``code`` is a stable machine-readable tag
    (the per-class error counters key on it).
    """

    retryable = False
    code = "query_error"


class PlanError(QueryError):
    """Parse / plan / optimize rejected the query (semantic: the same
    text will fail again)."""

    code = "plan_error"


class QueryTimeout(QueryError):
    """The request's deadline passed — while queued (shed before
    execution) or at a cooperative checkpoint mid-execution."""

    code = "timeout"


class QueryCancelled(QueryError):
    """Explicitly cancelled (``Session.cancel``) or abandoned by an
    executor shutdown while still pending."""

    code = "cancelled"


class ResourceExhausted(QueryError):
    """A budget said no: admission queue full, per-session in-flight
    cap, memory budget, device OOM.  Retryable later, not immediately."""

    code = "resource_exhausted"


class TransientIOError(QueryError):
    """An I/O fault (spill read/write, store payload read) that
    survived its retry budget.  Safe to retry from the top."""

    retryable = True
    code = "transient_io"


class ExecutionError(QueryError):
    """Unclassified engine failure during execution — the typed
    replacement for a bare ``Exception`` reaching a caller."""

    code = "execution_error"


def classify(exc: BaseException, phase: str = "execute") -> QueryError:
    """Wrap ``exc`` into the taxonomy (idempotent for QueryErrors).

    ``phase`` biases the mapping: SQL front-end errors raised while
    planning are ``PlanError``; the same class escaping execution (e.g.
    a scalar subquery returning two rows) still maps to ``PlanError``
    because resubmitting cannot help either way.
    """
    if isinstance(exc, QueryError):
        return exc
    name = type(exc).__name__
    if name == "SqlError":  # avoid importing the sql package here
        err: QueryError = PlanError(str(exc))
    elif isinstance(exc, (OSError, EOFError)):
        err = TransientIOError(f"{name}: {exc}")
    elif isinstance(exc, MemoryError) or "RESOURCE_EXHAUSTED" in str(exc):
        err = ResourceExhausted(f"{name}: {exc}")
    elif phase == "plan":
        err = PlanError(f"{name}: {exc}")
    else:
        err = ExecutionError(f"{name}: {exc}")
    err.__cause__ = exc
    return err
