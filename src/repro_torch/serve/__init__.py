"""Serving runtime of the port.

Two tiers live here:

- ``engine`` — the batched LM decode with KV caches or recurrent state
  and its continuous-batching scheduler (and ``PreparedStatement``, a
  parameterized SQL query over the compiled-plan cache);
- ``sql``   — the concurrent SQL serving layer: ``Executor`` sessions
  over store tables and frames on one device, per-session
  ``torch.func.vmap``-lowered UDFs, prepared statements riding the
  whole-plan capture cache, and an admission queue that micro-batches
  compatible concurrent queries (shared zone-map store scans, duplicate
  coalescing).

``STATS`` (``serve.stats``) counts what the SQL batcher did —
admissions, batches, shared-scan groups, coalesced duplicates,
compiled-plan cache hits — with latency percentiles.
"""
from .stats import STATS, ServeStats

__all__ = ["STATS", "ServeStats", "Executor", "Prepared", "Session"]


def __getattr__(name):
    # Executor pulls in the SQL stack; keep ``import repro_torch.serve``
    # light for engine-only users
    if name in ("Executor", "Prepared", "Session"):
        from . import sql as _sql

        return getattr(_sql, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
