"""The port's queries in its dataframe API: the 22 TPC-H queries
(``tpch_frames``) and the paper's five TPC-DS queries (``tpcds_frames``).

This module is also the table registry: benchmark table-sets are
registered by name, so ``scope("tpcds", sf=0.01, device="cpu")`` builds
the frames without hand-assembling them.  Every loader takes
``device=`` (default ``CONFIG.device``).
"""
from __future__ import annotations

from typing import Callable, Dict

_SCOPE_LOADERS: Dict[str, Callable] = {}


def register_scope(name: str, loader: Callable) -> None:
    """Register a named table-set loader: ``loader(**kwargs) -> dict of
    TensorFrames keyed by table name``."""
    _SCOPE_LOADERS[name] = loader


def scope(name: str, **kwargs):
    """Build the named scope (e.g. ``scope("tpch", sf=0.01, seed=0)``)."""
    if name not in _SCOPE_LOADERS:
        raise KeyError(f"unknown scope {name!r}; registered: {sorted(_SCOPE_LOADERS)}")
    return _SCOPE_LOADERS[name](**kwargs)


def _tpch_scope(sf: float = 0.01, seed: int = 0, device=None):
    from repro_torch.data import tpch

    return tpch.as_frames(tpch.generate(sf=sf, seed=seed), device=device)


def _tpcds_scope(sf: float = 0.01, seed: int = 1, device=None):
    from repro_torch.data import tpcds

    return tpcds.as_frames(tpcds.generate(sf=sf, seed=seed), device=device)


register_scope("tpch", _tpch_scope)
register_scope("tpcds", _tpcds_scope)
