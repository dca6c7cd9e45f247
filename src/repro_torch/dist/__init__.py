"""Distributed execution subsystem (``repro/dist``) on ``torch.distributed``.

Scales the single-device TensorFrame kernels past one card:

- ``dframe`` -- sharded relational ops over a 1-D ``data`` process group:
  dense group-by sums via shard-local segment sums (K1 on the card) +
  ``all_reduce``, semi-join membership against a replicated build side,
  and a hash-partition all-to-all repartition with capacity/overflow
  accounting.
- ``compression`` -- per-block int8 gradient quantization with
  error-feedback residuals and a ``compressed_mean`` collective for the
  training leg.
- ``pipeline`` -- a GPipe-style microbatch pipeline schedule over a
  ``pipe`` process group, stage to stage by point-to-point sends.

**Process model.** The JAX package runs one process over a mesh, and
``shard_map`` splits each op's *global* arrays into contiguous blocks,
one a device in device order.  The port runs one process per rank (SPMD
over ``torch.distributed``): every rank runs the same engine on the same
replicated global tensors, and rank ``r`` of ``W`` takes rows ``[r*b,
(r+1)*b)`` of an array padded to a multiple of ``W`` -- the block
``shard_map`` gives device ``r``.  Outputs follow the reference's
``out_specs``: a replicated (``P()``) output is made whole with an
``all_reduce``, a sharded (``P(axis)``) one is gathered in rank order, so
every rank returns the reference's global array.  Each op is a
shard-local function of ``(global inputs, rank, world)`` that launches
no collective, and the collective around it; calling the shard-local
function once for each rank of a simulated world, and combining the
results in rank order, gives what the collective would.

A mesh is a ``DataMesh``, a process group plus an axis name
(``data_mesh(ndev)``); no op ever stands in a one-device mesh for a group
that is not there: ``data_mesh`` raises ``ProcessGroupError``.
``dframe.init_local(device)`` makes the one-rank group that the
reference's one-device mesh stands for (gloo, and NCCL for CUDA tensors
where the device is a card).

The relational ops are wired into the engine: ``TensorFrame.groupby``
aggregation sums and semi/anti-join probes route here when
``repro_torch.core.config.CONFIG.distributed`` allows it (see
``dframe.dist_enabled``).  Importing this package initialises no group.
"""
from . import compression, dframe, pipeline
from .dframe import (
    data_mesh,
    dist_enabled,
    dist_groupby_sum,
    dist_repartition_by_key,
    dist_semi_join_mask,
)
from .compression import compressed_mean, dequantize, quantize
from .pipeline import pipeline_forward

__all__ = [
    "compression",
    "dframe",
    "pipeline",
    "data_mesh",
    "dist_enabled",
    "dist_groupby_sum",
    "dist_repartition_by_key",
    "dist_semi_join_mask",
    "compressed_mean",
    "dequantize",
    "quantize",
    "pipeline_forward",
]
