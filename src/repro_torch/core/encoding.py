"""Cardinality-aware column encoding (paper §III).

Low-cardinality non-numeric columns are mapped to dense integer ids and
stored inside the frame's int tensor; high-cardinality columns are
offloaded.  Dictionaries are kept **sorted**, so codes are
order-isomorphic to the string order — string range predicates and
sort-by-string reduce to integer comparisons on codes.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def factorize(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Map values to dense ids against a sorted unique dictionary.

    Returns (codes int64, dictionary).  The dictionary is sorted, so
    ``dictionary[codes] == values`` and code order == value order.
    """
    values = np.asarray(values)
    dictionary, codes = np.unique(values, return_inverse=True)
    return codes.astype(np.int64).reshape(values.shape), dictionary


def merge_dictionaries(
    da: np.ndarray, db: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge two sorted dictionaries into a shared integer space.

    This is the shared-factorization step of the paper's
    factorize-then-join (Alg. 3 line 5).  Returns
    (merged_dictionary, remap_a, remap_b) where ``remap_x[old_code]``
    gives the code in the merged (sorted) dictionary.

    Columns that share one dictionary object degenerate to an identity
    remap — no concatenate, no re-sort (the paper's "dictionary
    operations" hot spot).
    """
    if da is db:
        identity = np.arange(da.shape[0], dtype=np.int64)
        return da, identity, identity
    merged = np.unique(np.concatenate([da, db]))
    remap_a = np.searchsorted(merged, da).astype(np.int64)
    remap_b = np.searchsorted(merged, db).astype(np.int64)
    return merged, remap_a, remap_b


def shared_codes_numeric(
    a: np.ndarray, b: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Densify two numeric key columns into one shared code space.

    Joins address a direct table indexed by code, so codes must be dense
    over the *combined* key domain.  Returns (codes_a, codes_b, domain).
    """
    domain_vals = np.unique(np.concatenate([a, b]))
    ca = np.searchsorted(domain_vals, a)
    cb = np.searchsorted(domain_vals, b)
    # searchsorted gives positions even for values absent from the other
    # side; both sides were included in domain_vals so lookups are exact.
    return ca.astype(np.int64), cb.astype(np.int64), int(domain_vals.shape[0])


def is_string_like(arr: np.ndarray) -> bool:
    return arr.dtype.kind in ("U", "S", "O")


def cardinality_ratio(values: np.ndarray) -> float:
    n = max(1, values.shape[0])
    return float(np.unique(values).shape[0]) / float(n)
