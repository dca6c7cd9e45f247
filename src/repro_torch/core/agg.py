"""Aggregation functions: whole-frame and per-segment (group-by) forms.

Every per-group sum goes through ``kernels.ops.segment_sum``: the
hand-written segment-sum kernel on the card, its plain version on the
CPU; under ``CONFIG.distributed`` through ``repro_torch.dist``, whose
shard-local sums take the same kernel.
"""
from __future__ import annotations

from typing import Dict, List, Tuple, Union

import numpy as np
import torch

from ..kernels import ops
from .config import CONFIG
from .frame import INT, TensorFrame, float_dtype

AggSpec = Tuple[str, str, str]  # (out_name, fn, column) — column '' for size

AGG_FNS = ("sum", "mean", "min", "max", "count", "size", "nunique", "first")


def normalize_specs(specs) -> List[AggSpec]:
    out: List[AggSpec] = []
    if isinstance(specs, dict):
        for out_name, v in specs.items():
            fn, colname = v if isinstance(v, (tuple, list)) else (v, "")
            out.append((out_name, fn, colname))
    else:
        for item in specs:
            out.append(tuple(item))  # type: ignore[arg-type]
    for name, fn, _ in out:
        if fn not in AGG_FNS:
            raise ValueError(f"unknown aggregation {fn!r} for {name!r}")
    return out


def _num_values(frame: TensorFrame, name: str) -> torch.Tensor:
    m = frame.meta(name)
    if m.kind in ("float", "int", "bool", "date"):
        # view-aware: a lazy frame gathers only this column
        return frame.col_values(name)
    raise TypeError(f"aggregation over non-numeric column {name!r}")


def _count_weights(frame: TensorFrame, name: str) -> torch.Tensor:
    """1 where the value is non-null else 0 (SQL COUNT(col))."""
    valid = frame.valid_array(name)
    if valid is None:
        return torch.ones((frame.nrows,), dtype=INT, device=frame.device)
    return valid.to(INT)


def _segment_sum(vals: torch.Tensor, gids: torch.Tensor, m: int) -> torch.Tensor:
    """Segment sum with an optional sharded route.

    The single-device path is the segment-sum kernel; when the
    distributed route is enabled (``CONFIG.distributed`` and the process
    group, see ``repro_torch.dist.dframe.dist_enabled``) the reduction
    runs as shard-local dense sums + ``all_reduce`` over a data mesh
    spanning every rank.
    """
    if CONFIG.distributed != "off":
        from ..dist import dframe

        if dframe.dist_enabled(int(vals.shape[0])):
            return dframe.dist_groupby_sum(dframe.data_mesh(), gids, vals, m)
    return ops.segment_sum(vals.contiguous(), gids.contiguous(), m)


def segment_min(vals: torch.Tensor, gids: torch.Tensor, m: int) -> torch.Tensor:
    """Per-segment minimum; empty segments hold the dtype's maximum."""
    big = torch.inf if vals.is_floating_point() else torch.iinfo(vals.dtype).max
    out = torch.full((m,), big, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, gids, vals, reduce="amin", include_self=True)


def segment_max(vals: torch.Tensor, gids: torch.Tensor, m: int) -> torch.Tensor:
    """Per-segment maximum; empty segments hold the dtype's minimum."""
    small = -torch.inf if vals.is_floating_point() else torch.iinfo(vals.dtype).min
    out = torch.full((m,), small, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, gids, vals, reduce="amax", include_self=True)


# ----------------------------------------------------------------------
# segment (grouped) aggregation
# ----------------------------------------------------------------------
def segment_agg(
    frame: TensorFrame,
    gids: torch.Tensor,
    m: int,
    fn: str,
    colname: str,
):
    if fn == "size":
        return _segment_sum(torch.ones((frame.nrows,), dtype=INT, device=frame.device), gids, m)
    if fn == "count":
        return _segment_sum(_count_weights(frame, colname), gids, m)
    if fn == "nunique":
        return _segment_nunique(frame, gids, m, colname)
    if fn == "first":
        rep = segment_min(torch.arange(frame.nrows, dtype=INT, device=frame.device), gids, m)
        return frame.col_values(colname)[rep]
    vals = _num_values(frame, colname)
    valid = frame.valid_array(colname)
    if fn == "sum":
        if valid is not None:
            vals = torch.where(valid, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
        return _segment_sum(vals, gids, m)
    if fn == "mean":
        if valid is not None:
            vals = torch.where(valid, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
        s = _segment_sum(vals.to(float_dtype()), gids, m)
        c = _segment_sum(_count_weights(frame, colname), gids, m)
        return s / torch.clamp(c, min=1).to(float_dtype())
    if fn == "min":
        if valid is not None:
            big = torch.inf if vals.is_floating_point() else np.iinfo(np.int64).max
            vals = torch.where(valid, vals, torch.full((), big, dtype=vals.dtype, device=vals.device))
        return segment_min(vals, gids, m)
    if fn == "max":
        if valid is not None:
            small = -torch.inf if vals.is_floating_point() else np.iinfo(np.int64).min
            vals = torch.where(valid, vals, torch.full((), small, dtype=vals.dtype, device=vals.device))
        return segment_max(vals, gids, m)
    raise ValueError(fn)


def _segment_nunique(frame: TensorFrame, gids: torch.Tensor, m: int, colname: str) -> torch.Tensor:
    """COUNT(DISTINCT col) per group: distinct (gid, code) pairs, then a
    per-gid count — pure tensor ops, no dictionaries."""
    from . import hashing

    if frame.meta(colname).kind == "float":
        raise TypeError("nunique over float column")
    codes, card = hashing.key_codes(frame, colname)
    valid = frame.valid_array(colname)
    card64 = max(1, card)
    pair = gids * card64 + codes.to(INT)
    if valid is not None:
        # shunt nulls into a per-group sentinel bucket that we exclude
        pair = torch.where(valid, pair, -1)
    uniq, _, mu = hashing.distinct(pair)
    pair_gid = torch.where(uniq >= 0, torch.div(uniq, card64, rounding_mode="floor"), m)
    ones = (uniq >= 0).to(INT)
    return _segment_sum(ones, pair_gid, m + 1)[:m]


# ----------------------------------------------------------------------
# whole-frame aggregation
# ----------------------------------------------------------------------
def frame_agg(frame: TensorFrame, specs) -> Dict[str, Union[float, int]]:
    out: Dict[str, Union[float, int]] = {}
    gids = torch.zeros((frame.nrows,), dtype=INT, device=frame.device)
    for out_name, fn, colname in normalize_specs(specs):
        if frame.nrows == 0:
            # Pandas semantics (the paper's comparison target): empty
            # SUM is 0; empty mean/min/max are NaN
            if fn in ("count", "size", "nunique"):
                out[out_name] = 0
            elif fn == "sum":
                out[out_name] = 0.0
            else:
                out[out_name] = float("nan")
            continue
        out[out_name] = segment_agg(frame, gids, 1, fn, colname)[0].item()
    return out
