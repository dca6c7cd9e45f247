"""K4 and K5 on DTensors: each kernel runs on its local shards.

``kernels.ops`` sends DTensor inputs here.  The placements follow the
head sharding: on each mesh dim, a batch sharding of q (r for K5) is
kept for every input and output; otherwise the heads are sharded where
the mesh dim divides them, and the inputs are replicated on that dim
where it does not (DTensor's own redistribution, the all-gather the
sharded step would need anyway).  For attention, k and v follow q's head
sharding where they are sharded on heads themselves and the mesh dim
divides the kv heads too; otherwise (GQA with fewer kv heads than
ranks, or ``kv_shard="replicated"``) they stay replicated on that dim
and each rank takes the kv heads its query heads read, by its
coordinate.  ``local_map`` redistributes the inputs to these placements
and calls ``kernels.ops`` on the local tensors, so the card launches the
kernel (or its autograd Function), the CPU runs the plain version and a
fake or meta tensor takes the fake route; nothing gathers a whole tensor
to call a kernel.  Where a rank's gradient for an input holds only its
own part (k and v replicated over the head dim and sliced per rank; u
over the batch dims) ``local_map`` returns it as a partial sum, and k's
and v's are all-reduced where they arise (``grad_to_own``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map


class _GradTo(torch.autograd.Function):
    """The identity; its backward brings the gradient to ``placements``."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def grad_to_own(x):
    """``x`` as it is, its gradient brought to ``x``'s own placements
    (partial sums replicated) where it arrives.  Before a ``local_map``
    whose gradient for ``x`` is a partial sum: left to itself DTensor
    resolves the partial sum wherever a later op in the backward needs it,
    and may reduce-scatter it onto the batch dim over "model", unevenly
    where those ranks do not divide a data rank's rows (2 rows on 16 in the
    train cells), and views of such shards fail.  Here it becomes an
    all-reduce to the placements the forward ran with."""
    if not (isinstance(x, DTensor) and x.requires_grad and torch.is_grad_enabled()):
        return x
    own = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return _GradTo.apply(x, own)


def _batch_dims(t: DTensor) -> List[bool]:
    """Per mesh dim: is ``t`` sharded there on its batch dim (0) evenly?"""
    mesh = t.device_mesh
    return [isinstance(p, Shard) and p.dim == 0 and t.shape[0] % mesh.size(i) == 0
            for i, p in enumerate(t.placements)]


def _head_dim(t: DTensor, heads: int, batch: List[bool]) -> Optional[int]:
    """The first mesh dim that is not a batch dim and divides ``heads``:
    the dim the heads are sharded over (None: heads replicated)."""
    mesh = t.device_mesh
    for i in range(mesh.ndim):
        if not batch[i] and mesh.size(i) > 1 and heads % mesh.size(i) == 0:
            return i
    return None


def _placements(ndim: int, batch: List[bool], head: Optional[int], shard_heads: bool,
                head_axis: int = 1) -> Tuple:
    out = []
    for i in range(ndim):
        if batch[i]:
            out.append(Shard(0))
        elif i == head and shard_heads:
            out.append(Shard(head_axis))
        else:
            out.append(Replicate())
    return tuple(out)


def flash_attention(q: DTensor, k: DTensor, v: DTensor, causal: bool) -> DTensor:
    """``ops.flash_attention`` on DTensors q (B, Hq, Sq, D) and k, v (B,
    Hkv, Sk, D) of one mesh."""
    from . import ops

    mesh = q.device_mesh
    Hq, Hkv = q.shape[1], k.shape[1]
    group = Hq // Hkv
    batch = _batch_dims(q)
    head = _head_dim(q, Hq, batch)
    kv_sharded = False
    take = None  # (kv heads a rank takes, its first kv head) under replicated kv
    if head is not None:
        n = mesh.size(head)
        per = Hq // n  # query heads a rank holds
        kv_on_heads = isinstance(k.placements[head], Shard) and k.placements[head].dim == 1
        if kv_on_heads and Hkv % n == 0:
            kv_sharded = True
        elif per % group == 0 or group % per == 0:
            first = mesh.get_local_rank(head) * per // group
            take = (max(1, per // group), first)
        else:
            head = None  # no kv slice fits a rank's query heads: replicate the heads
    q_pl = _placements(mesh.ndim, batch, head, True)
    kv_pl = _placements(mesh.ndim, batch, head, kv_sharded)
    # k and v replicated over the head dim: each rank's gradient holds
    # only its query heads' part, a partial sum over that dim
    kv_grad = tuple(Partial() if i == head and not kv_sharded else p
                    for i, p in enumerate(kv_pl))

    def local(ql, kl, vl):
        if take is not None:
            kl = kl[:, take[1]:take[1] + take[0]]
            vl = vl[:, take[1]:take[1] + take[0]]
        return ops.flash_attention(ql, kl, vl, causal)

    fn = local_map(local, out_placements=(q_pl,), in_placements=(q_pl, kv_pl, kv_pl),
                   in_grad_placements=(q_pl, kv_grad, kv_grad), redistribute_inputs=True,
                   device_mesh=mesh)
    if kv_grad != kv_pl:
        k, v = grad_to_own(k), grad_to_own(v)
    return fn(q, k, v)


def wkv6(r: DTensor, k: DTensor, v: DTensor, w: DTensor, u, state=None,
         state_out=None) -> Tuple[DTensor, DTensor]:
    """``ops.wkv6`` on DTensors r, k, v, w (B, H, T, D), u (H, D) and the
    state (B, H, D, D), heads over the first mesh dim that divides them.
    ``state_out``, where given, receives the final state through
    ``copy_`` (it may be laid out otherwise than the kernel's shards)."""
    from . import ops

    mesh = r.device_mesh
    H = r.shape[1]
    batch = _batch_dims(r)
    head = _head_dim(r, H, batch)
    x_pl = _placements(mesh.ndim, batch, head, True)
    u_pl = _placements(mesh.ndim, [False] * mesh.ndim, head, True, head_axis=0)
    # u replicated over the batch dims: each rank's gradient holds only
    # its batch rows' part, a partial sum over those of more than one rank
    u_grad = tuple(Partial() if b and mesh.size(i) > 1 else p
                   for i, (b, p) in enumerate(zip(batch, u_pl)))
    if not isinstance(u, DTensor):
        u = DTensor.from_local(u, mesh, [Replicate()] * mesh.ndim, run_check=False)

    if state is None:
        fn = local_map(lambda *a: ops.wkv6(*a), out_placements=(x_pl, x_pl),
                       in_placements=(x_pl, x_pl, x_pl, x_pl, u_pl),
                       in_grad_placements=(x_pl, x_pl, x_pl, x_pl, u_grad),
                       redistribute_inputs=True, device_mesh=mesh)
        y, s_new = fn(r, k, v, w, u)
    else:
        fn = local_map(lambda *a: ops.wkv6(*a), out_placements=(x_pl, x_pl),
                       in_placements=(x_pl, x_pl, x_pl, x_pl, u_pl, x_pl),
                       in_grad_placements=(x_pl, x_pl, x_pl, x_pl, u_grad, x_pl),
                       redistribute_inputs=True, device_mesh=mesh)
        y, s_new = fn(r, k, v, w, u, state)
    if state_out is None:
        return y, s_new
    state_out.copy_(s_new)
    return y, state_out
