"""Multi-key sort.

Dictionary codes are order-isomorphic to string order (sorted
dictionaries — encoding.py), so sorting by a string column is an
integer sort on its codes: cardinality-awareness pays again.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

from .frame import INT, TensorFrame


def _sort_key(frame: TensorFrame, name: str) -> torch.Tensor:
    # view-aware: gathers only the sort-key column from a lazy frame
    return frame.col_values(name)


def sort_values(
    frame: TensorFrame,
    by: Union[str, Sequence[str]],
    ascending: Union[bool, Sequence[bool]] = True,
) -> TensorFrame:
    """Multi-key stable sort: equal-key rows keep their input order, so
    ``head``/``LIMIT`` after a sort is deterministic and matches any
    stable reference implementation (e.g. Python's ``sorted``).
    Descending keys are negated, which preserves tie order, unlike a
    post-hoc reversal.

    The lexicographic order is a chain of stable argsorts, least
    significant key first, starting from the identity permutation (the
    original row position is the final tie-break)."""
    by = [by] if isinstance(by, str) else list(by)
    if isinstance(ascending, bool):
        ascending = [ascending] * len(by)
    if len(ascending) != len(by):
        raise ValueError("ascending must match by")
    order = torch.arange(frame.nrows, dtype=INT, device=frame.device)
    for name, asc in reversed(list(zip(by, ascending))):
        k = _sort_key(frame, name)
        if not asc:
            k = -k
        order = order[torch.argsort(k[order], stable=True)]
    return frame.take(order, stats="permutation")
