"""Resilience layer: typed errors, deadlines, retries, fault injection.

The machinery that routes failures toward the engine's degradation
tiers instead of letting them escape as bare exceptions or hangs:

- ``errors`` — the ``QueryError`` taxonomy (``QueryTimeout``,
  ``QueryCancelled``, ``ResourceExhausted``, ``TransientIOError``,
  ``PlanError``, ``ExecutionError``) plus ``classify`` for foreign
  exceptions;
- ``deadline`` — per-request deadlines and cooperative cancellation
  checked at operator/chunk/admission checkpoints;
- ``retry`` — bounded exponential backoff with deterministic jitter
  for transient I/O;
- ``faults`` — the seeded fault-injection registry the chaos suite
  arms at every I/O and compile boundary.

The whole package is host-side Python and imports no torch (the store
layer depends on it).
"""
from . import deadline, errors, faults, retry
from .deadline import (
    CancelToken,
    Deadline,
    checkpoint,
    current,
    deadline_scope,
)
from .errors import (
    ExecutionError,
    PlanError,
    QueryCancelled,
    QueryError,
    QueryTimeout,
    ResourceExhausted,
    TransientIOError,
    classify,
)

__all__ = [
    "CancelToken",
    "Deadline",
    "ExecutionError",
    "PlanError",
    "QueryCancelled",
    "QueryError",
    "QueryTimeout",
    "ResourceExhausted",
    "TransientIOError",
    "checkpoint",
    "classify",
    "current",
    "deadline",
    "deadline_scope",
    "errors",
    "faults",
    "retry",
]


def _snapshot() -> dict:
    return {
        "faults": {k: dict(v) for k, v in faults.STATS.items()},
        "retries": retry.STATS["retries"],
        "retry_giveups": retry.STATS["giveups"],
    }


def _reset() -> None:
    faults.reset_stats()
    retry.reset_stats()


from repro_torch import obs as _obs  # noqa: E402  (torch-free)

_obs.metrics.register_group("resilience", _snapshot, _reset)
