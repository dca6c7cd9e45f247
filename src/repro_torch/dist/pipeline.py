"""GPipe-style microbatch pipeline over a ``pipe`` process group
(``repro/dist/pipeline.py``).

Layers are split contiguously across ``S`` pipeline stages, one a rank:
stage ``s`` applies layers ``[s*L/S, (s+1)*L/S)`` of the stacked weights.
Microbatches stream through the classic ``M + S - 1`` tick schedule: at
tick ``t`` stage 0 ingests microbatch ``t``, every stage applies its
layer slice to the activation it holds, and activations shift one stage
to the right round the ring (``batch_isend_irecv``; the wrap-around into
stage 0 is overwritten by the next ingest).  The last stage finishes
microbatch ``t - (S - 1)`` at tick ``t``; at the end its outputs are made
whole on every rank by an ``all_reduce`` in which the other stages add
zeros, as the JAX package's masked ``psum`` does.  With one stage the
shift is the identity: nothing is sent.

This is the forward-only schedule, and it matches the sequential loop
bit for bit per microbatch, since every stage applies the very same
``block`` function.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .dframe import COLLECTIVES, DataMesh, _not_capturing, all_reduce

AXIS = "pipe"


def apply_stage(block: Callable, weights: torch.Tensor, h: torch.Tensor, stage: int,
                stages: int) -> torch.Tensor:
    """Stage ``stage``'s layers of the stacked ``weights`` applied to ``h``
    (the shard-local part: no communication)."""
    per = weights.shape[0] // stages
    for w in weights[stage * per:(stage + 1) * per]:
        h = block(w, h)
    return h


def _shift(h: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """``h`` to the next stage, the previous stage's ``h`` back (a ring)."""
    stages, r = mesh.size, mesh.rank
    if stages == 1:
        return h
    _not_capturing(h)
    peer = lambda s: dist.get_global_rank(mesh.group, s % stages)
    recv = torch.empty_like(h)
    COLLECTIVES["send_recv"] += 1
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, h.contiguous(), peer(r + 1), mesh.group),
        dist.P2POp(dist.irecv, recv, peer(r - 1), mesh.group),
    ])
    for req in reqs:
        req.wait()
    return recv


def pipeline_forward(
    mesh: DataMesh,
    block: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    weights: torch.Tensor,
    x: torch.Tensor,
    n_layers: int,
    axis: str = AXIS,
) -> torch.Tensor:
    """Run ``x`` (microbatches, batch, d) through ``n_layers`` blocks.

    ``weights`` is the stacked ``(n_layers, ...)`` per-layer parameters,
    the same on every rank; ``block(w_l, h)`` applies one layer.
    ``n_layers`` must divide evenly across the mesh's ``axis`` size.
    Every rank returns the whole ``(M, batch, d)`` output.
    """
    stages = mesh.shape[axis]
    if n_layers % stages:
        raise ValueError(f"{n_layers} layers do not split over {stages} stages")
    sidx, n_micro = mesh.rank, x.shape[0]
    buf = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    outs = torch.zeros_like(x)
    for t in range(n_micro + stages - 1):
        inp = x[min(max(t, 0), n_micro - 1)]
        h = apply_stage(block, weights, inp if sidx == 0 else buf, sidx, stages)
        out_t = t - (stages - 1)
        if sidx == stages - 1 and out_t >= 0:
            outs[out_t] = h
        buf = _shift(h, mesh)
    # only the last stage holds real outputs; the others add zeros
    return all_reduce(outs, mesh)
