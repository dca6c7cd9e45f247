"""Entry points of the hand-written kernels, dispatched by device.

A CUDA tensor launches the kernel (and its wrapper counts the launch in
``LAUNCHES``); a CPU tensor takes the plain PyTorch version; any other
device raises.  Nothing falls back: a kernel that fails to build or
launch raises.  Where autograd wants a gradient of attention (K4) or the
WKV recurrence (K5), a CUDA tensor goes through the kernel's autograd
Function (its forward kernel, then its backward kernel); on the CPU
autograd differentiates the plain version.

K4 and K5 have two more routes.  A fake or meta tensor (shapes without
data, as the dry run traces the step) takes the fake route: outputs of
the kernel's shapes and dtypes, the call's bytes and operations recorded
in ``build.FAKE_COSTS``, nothing launched (``FakeFlashAttentionFn`` /
``FakeWkv6Fn`` where a gradient is wanted).  A DTensor goes to
``kernels.sharded``, which runs the kernel on each rank's local shards
through ``local_map`` and comes back here with plain tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from . import build, sharded
from .build import LAUNCHES  # noqa: F401  (re-exported)
from .flash_attention import (
    FakeFlashAttentionFn, FlashAttentionFn, flash_attention_cuda, flash_attention_fake,
    flash_attention_plain,
)
from .hash32x2 import hash32x2_cuda, hash32x2_plain
from .segment_reduce import PATH_LAUNCHES, segment_sum_cuda, segment_sum_plain
from .substr_find import (
    MODE_LAUNCHES, exists_before_cuda, exists_before_plain, substr_find_cuda, substr_find_plain,
)
from .wkv6 import FakeWkv6Fn, Wkv6Fn, wkv6_cuda, wkv6_fake, wkv6_plain


def reset_launches() -> None:
    """Zero every kernel's launch count, the segment sum's by path and
    the substring search's by form."""
    build.reset_launches()
    for counts in (PATH_LAUNCHES, MODE_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _route(t: torch.Tensor, fn: str, fake: bool = False) -> str:
    """``cuda`` (the kernel), ``cpu`` (the plain version) or, where the
    entry point has one and ``t`` holds no data, ``fake``."""
    if fake and build.is_fake(t):
        return "fake"
    kind = t.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"{fn}: no kernel or plain version for device {t.device}")
    return kind


def segment_sum(values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment sums over int64 ids in any order (K1)."""
    if _route(values, "segment_sum") == "cuda":
        return segment_sum_cuda(values, seg_ids, num_segments)
    return segment_sum_plain(values, seg_ids, num_segments)


def substr_find(
    packed: torch.Tensor,
    lens: torch.Tensor,
    pattern: torch.Tensor,
    start: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-row index of the first ``pattern`` at or after ``start``, or -1 (K2)."""
    if _route(packed, "substr_find") == "cuda":
        return substr_find_cuda(packed, lens, pattern, start)
    return substr_find_plain(packed, lens, pattern, start)


def exists_before(packed, lens, pat_a: torch.Tensor, pat_b: torch.Tensor) -> torch.Tensor:
    """True where ``pat_a`` occurs and ``pat_b`` occurs after the end of
    its first occurrence (K2): on the card one launch of the substring
    kernel's fused form, which reads each row once; on the CPU the two
    plain finds that ``exists_before_pallas`` also makes."""
    if _route(packed, "exists_before") == "cuda":
        return exists_before_cuda(packed, lens, pat_a, pat_b)
    return exists_before_plain(packed, lens, pat_a, pat_b)


def hash32x2(cols: torch.Tensor) -> torch.Tensor:
    """Two-lane uint32 tuple hash of (n, k) int32/uint32 columns (K3)."""
    if _route(cols, "hash32x2") == "cuda":
        return hash32x2_cuda(cols)
    return hash32x2_plain(cols)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """Grouped-query attention, q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) (K4)."""
    if isinstance(q, DTensor):
        return sharded.flash_attention(q, k, v, causal)
    route = _route(q, "flash_attention", fake=True)
    if route == "cuda":
        if build.wants_grad(q, k, v):
            return FlashAttentionFn.apply(q, k, v, causal)
        return flash_attention_cuda(q, k, v, causal)
    if route == "fake":
        if build.wants_grad(q, k, v):
            return FakeFlashAttentionFn.apply(q, k, v, causal)
        return flash_attention_fake(q, k, v, causal)
    return flash_attention_plain(q, k, v, causal)


def wkv6(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: Optional[torch.Tensor] = None,
    *,
    state_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RWKV6 recurrence over (B, H, T, D) inputs of any strides (stride
    1 on D for the kernel), state carried (K5).  y comes back as the
    (B, H, T, D) view of a (B, T, H, D) tensor.  ``state_out``, where
    given, receives the final state and is returned; it may be ``state``
    itself.  Without it ``state`` is left as it was.  Where a gradient is
    wanted ``state_out`` is refused: an update in place has none."""
    grad = build.wants_grad(r, k, v, w, u, state)
    if grad and state_out is not None:
        raise ValueError("wkv6: state_out (an update in place) takes no gradient")
    if isinstance(r, DTensor):
        return sharded.wkv6(r, k, v, w, u, state, state_out)
    route = _route(r, "wkv6", fake=True)
    if route == "cuda":
        if grad:
            return Wkv6Fn.apply(r, k, v, w, u, state)
        return wkv6_cuda(r, k, v, w, u, state, state_out=state_out)
    if route == "fake":
        if grad:
            return FakeWkv6Fn.apply(r, k, v, w, u, state)
        return wkv6_fake(r, k, v, w, u, state, state_out=state_out)
    return wkv6_plain(r, k, v, w, u, state, state_out=state_out)
