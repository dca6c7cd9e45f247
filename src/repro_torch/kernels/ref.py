"""Plain-PyTorch oracles for the ported kernels, under the names of the
JAX package's ``repro.kernels.ref``.  Each runs on any device."""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_plain
from .hash32x2 import fmix32, hash32x2_plain  # noqa: F401  (fmix32 re-exported)
from .segment_reduce import segment_sum_plain
from .substr_find import exists_before_plain, substr_find_plain
from .wkv6 import wkv6_plain

#: K3's contract: (n, k) int32/uint32 -> (n, 2) uint32; ``fmix32`` on
#: int64 values in [0, 2^32), as PyTorch has no uint32 shift on the CPU
hash32x2 = hash32x2_plain
substr_find = substr_find_plain
exists_before = exists_before_plain


def segment_sum_sorted(values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int):
    """Segment sum over sorted ids (K1's contract); the plain version
    takes ids in any order, so sorted ids are just a special case."""
    return segment_sum_plain(values, seg_ids.to(torch.int64), num_segments)


#: K4's contract: q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), GQA by head groups
mha_reference = flash_attention_plain
#: K5's contract: the RWKV6 recurrence, returning (y, final state f32)
wkv6_reference = wkv6_plain
