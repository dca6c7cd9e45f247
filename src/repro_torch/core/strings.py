"""String operations on packed byte tensors.

MojoFrame's headline result (TPC-H Q13, §VI-E) is a *stateless* string
UDF (``not_string_exists_before``) compiled and parallelized instead of
applied row-by-row.  The port packs a string column into an ``(n, L)
uint8`` tensor + int32 lengths and evaluates substring searches through
``kernels.ops.substr_find``: the hand-written CUDA kernel on the card,
its plain PyTorch version on the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from .config import CONFIG


def pack_strings(
    values: np.ndarray, max_len: Optional[int], device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack a host string array into ((n, L) uint8, (n,) int32 lengths)
    on ``device``.

    Vectorized via numpy's fixed-width bytes dtype (ASCII fast path);
    non-ASCII data falls back to a per-string loop."""
    n = values.shape[0]
    cap = max_len or CONFIG.max_packed_len
    if n == 0:
        return (
            torch.zeros((0, 1), dtype=torch.uint8, device=device),
            torch.zeros((0,), dtype=torch.int32, device=device),
        )
    try:
        as_s = np.asarray(values).astype("S")  # null-padded fixed width
        W = as_s.dtype.itemsize or 1
        L = min(cap, W) if max_len is None else cap
        buf = as_s.view(np.uint8).reshape(n, W)  # a writable view, no copy
        lens = np.char.str_len(as_s).astype(np.int32)
        if W < L:
            buf = np.pad(buf, ((0, 0), (0, L - W)))
        else:
            buf = buf[:, :L]
        lens = np.minimum(lens, L)
        return (
            torch.as_tensor(np.ascontiguousarray(buf), device=device),
            torch.as_tensor(lens, device=device),
        )
    except UnicodeEncodeError:
        pass
    encoded = [str(s).encode("utf-8") for s in values]
    actual = max((len(b) for b in encoded), default=1)
    L = min(cap, max(1, actual)) if max_len is None else cap
    buf = np.zeros((n, L), dtype=np.uint8)
    lens = np.zeros((n,), dtype=np.int32)
    for i, b in enumerate(encoded):
        b = b[:L]
        buf[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        lens[i] = len(b)
    return torch.as_tensor(buf, device=device), torch.as_tensor(lens, device=device)


_PACK_CACHE: dict = {}


def pack_strings_cached(values: np.ndarray, max_len: Optional[int], device: torch.device):
    """Cached packing keyed on the array object and device (dictionaries
    are stable objects held by their frames)."""
    key = (id(values), max_len, str(device))
    hit = _PACK_CACHE.get(key)
    if hit is not None and hit[0] is values:
        return hit[1]
    packed = pack_strings(values, max_len, device)
    _PACK_CACHE[key] = (values, packed)  # keep a ref so id stays valid
    if len(_PACK_CACHE) > 256:
        _PACK_CACHE.pop(next(iter(_PACK_CACHE)))
    return packed


def _pat_tensor(pat: str, device: torch.device) -> torch.Tensor:
    return torch.tensor(list(pat.encode("utf-8")), dtype=torch.uint8, device=device)


def find_first(
    packed: torch.Tensor, lens: torch.Tensor, pat: str, start: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Per-row index of first occurrence of ``pat`` at or after ``start``
    (elementwise), or -1."""
    if start is not None:
        start = start.to(torch.int32).contiguous()
    return ops.substr_find(packed, lens, _pat_tensor(pat, packed.device), start)


def contains(packed: torch.Tensor, lens: torch.Tensor, pat: str) -> torch.Tensor:
    return find_first(packed, lens, pat) >= 0


def startswith(packed: torch.Tensor, lens: torch.Tensor, pat: str) -> torch.Tensor:
    p = pat.encode("utf-8")
    m = len(p)
    n, L = packed.shape
    if m == 0:
        return torch.ones((n,), dtype=torch.bool, device=packed.device)
    if m > L:
        return torch.zeros((n,), dtype=torch.bool, device=packed.device)
    ok = lens >= m
    for k in range(m):
        ok = ok & (packed[:, k] == p[k])
    return ok


def endswith(packed: torch.Tensor, lens: torch.Tensor, pat: str) -> torch.Tensor:
    p = pat.encode("utf-8")
    m = len(p)
    n, L = packed.shape
    if m == 0:
        return torch.ones((n,), dtype=torch.bool, device=packed.device)
    start = lens.to(torch.int64) - m
    ok = start >= 0
    rows = torch.arange(n, device=packed.device)
    for k in range(m):
        idx = torch.clamp(start + k, 0, L - 1)
        ok = ok & (packed[rows, idx] == p[k])
    return ok


def exists_before(packed: torch.Tensor, lens: torch.Tensor, first: str, second: str) -> torch.Tensor:
    """True where ``first`` occurs and ``second`` occurs after its end (on
    the card one launch of the substring kernel's fused form).  The
    paper's ``not_string_exists_before`` (Q13/Q16) is the negation."""
    dev = packed.device
    return ops.exists_before(packed, lens, _pat_tensor(first, dev), _pat_tensor(second, dev))


def like(packed: torch.Tensor, lens: torch.Tensor, pattern: str) -> torch.Tensor:
    """SQL LIKE with ``%`` wildcards (the only wildcard in our workloads).

    Translates to anchored/ordered substring search: parts between ``%``
    must occur in order, the first/last parts anchor when the pattern
    does not start/end with ``%``.
    """
    parts = pattern.split("%")
    anchored_start = parts[0] != ""
    anchored_end = parts[-1] != ""
    inner = [p for p in parts if p != ""]
    n = packed.shape[0]
    ok = torch.ones((n,), dtype=torch.bool, device=packed.device)
    pos = torch.zeros((n,), dtype=torch.int32, device=packed.device)
    for i, part in enumerate(inner):
        m = len(part.encode("utf-8"))
        if i == 0 and anchored_start:
            ok = ok & startswith(packed, lens, part)
            pos = torch.where(ok, m, pos).to(torch.int32)
            continue
        f = find_first(packed, lens, part, start=pos)
        ok = ok & (f >= 0)
        pos = torch.where(f >= 0, f + m, pos).to(torch.int32)
    if anchored_end and inner:
        last = inner[-1]
        m = len(last.encode("utf-8"))
        if len(inner) == 1 and anchored_start:
            # pattern like 'abc' (no %): exact match
            ok = ok & (lens == m)
        else:
            ends = endswith(packed, lens, last)
            if len(inner) >= 2 or not anchored_start:
                # the last part must also be the trailing match
                ok = ok & ends
    return ok
