"""Sharded dataframe ops over a 1-D process group (``repro/dist/dframe.py``).

The single-device kernels (factorize-then-join, dense group-by) scale out
the way partitioned dataframe engines do:

- ``dist_groupby_sum`` -- every rank reduces its block of rows into a
  dense ``(domain,)`` accumulator through the segment-sum kernel (K1 on
  the card), then one ``all_reduce`` combines the rank partials.  The
  all-reduce moves ``O(domain)`` values per rank instead of ``O(n)`` rows.
- ``dist_semi_join_mask`` -- the build side is replicated on every rank;
  each rank probes its block of the probe side with the engine's sorted
  membership, and the blocks' masks are gathered in rank order.
- ``dist_repartition_by_key`` -- a hash-partition all-to-all: rows go to
  rank ``splitmix64(key) % ndev`` so each key's rows land on exactly one
  rank.  Fixed-capacity send buckets give static shapes; rows beyond a
  bucket's capacity are counted in ``dropped`` (capacity >= n guarantees
  a lossless shuffle).

Every op takes the *global* tensors, replicated on every rank, plus a
``DataMesh``; rank ``r`` of ``W`` works on rows ``[r*b, (r+1)*b)`` of the
input padded with null keys (negative) to a multiple of ``W``, the blocks
``shard_map`` gives device ``r`` in the JAX package.  Each op is a
shard-local function of ``(global inputs, rank, world)``, which launches
no collective (``*_shard``), and the collective around it; the output is
the reference's global array on every rank.

``COLLECTIVES`` counts the collectives these ops launch, by kind, and
``ROUTED`` the ops themselves; ``reset_counts()`` zeroes both.  No
collective may run while a CUDA stream is capturing a graph: the compiled
SQL route calls the segment-sum kernel itself and never reaches here.
"""
from __future__ import annotations

import dataclasses
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..core import hashing
from ..core.config import CONFIG, resolve_device
from ..core.join import membership
from ..kernels import ops

AXIS = "data"

COLLECTIVES: Dict[str, int] = {"all_reduce": 0, "all_gather": 0, "all_to_all": 0, "send_recv": 0}
ROUTED: Dict[str, int] = {"groupby_sum": 0, "semi_join": 0, "repartition": 0}


class ProcessGroupError(RuntimeError):
    """The sharded route was asked for and no process group is up."""


def reset_counts() -> None:
    for counts in (COLLECTIVES, ROUTED):
        for name in counts:
            counts[name] = 0


# ----------------------------------------------------------------------
# mesh + routing helpers
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A process group seen as a 1-D mesh with one named axis."""

    group: dist.ProcessGroup
    axis: str = AXIS

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis: size}``, as a JAX mesh's ``shape``."""
        return {self.axis: self.size}


_SUBGROUPS: Dict[Tuple[int, int], dist.ProcessGroup] = {}


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def data_mesh(ndev: Optional[int] = None, axis: str = AXIS) -> DataMesh:
    """A 1-D mesh over the default process group, or over a subgroup of
    its first ``ndev`` ranks (every rank must make the same call, since
    making a subgroup is collective; a rank outside it raises)."""
    if not _group_up():
        raise ProcessGroupError(
            "no process group is initialised: call torch.distributed.init_process_group, "
            "or dframe.init_local(device) for one rank"
        )
    world = dist.get_world_size()
    if ndev is None or ndev == world:
        return DataMesh(dist.group.WORLD, axis)
    if not 1 <= ndev <= world:
        raise ValueError(f"a mesh of {ndev} ranks in a world of {world}")
    key = (id(dist.group.WORLD), ndev)
    if key not in _SUBGROUPS:
        _SUBGROUPS[key] = dist.new_group(ranks=list(range(ndev)))
    if dist.get_rank() >= ndev:
        raise ValueError(f"rank {dist.get_rank()} is outside a mesh of the first {ndev} ranks")
    return DataMesh(_SUBGROUPS[key], axis)


def init_local(device: Union[str, torch.device],
               timeout: Optional[timedelta] = None) -> DataMesh:
    """The one-rank process group that the JAX package's one-device mesh
    stands for: gloo for CPU tensors and, where ``device`` is a CUDA
    device, NCCL for CUDA tensors (made at once, so a card whose NCCL
    cannot start fails here).  ``timeout`` bounds each collective (the
    process group's default where None).  Returns its mesh; tear it down
    with ``torch.distributed.destroy_process_group()``."""
    dev = torch.device(device)
    if _group_up():
        raise ProcessGroupError("a process group is already initialised")
    store = dist.HashStore()
    kw = {} if timeout is None else {"timeout": timeout}
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
        dist.init_process_group(backend="cpu:gloo,cuda:nccl", store=store, rank=0,
                                world_size=1, device_id=dev, **kw)
    elif dev.type == "cpu":
        dist.init_process_group(backend="gloo", store=store, rank=0, world_size=1, **kw)
    else:
        raise ValueError(f"unsupported device {dev}")
    return data_mesh()


def dist_enabled(nrows: int) -> bool:
    """Should the engine take the sharded route for an ``nrows`` input?

    ``CONFIG.distributed``: 'off' never; 'force' always (tests use this
    with a one-rank group), and it raises when no process group is up;
    'auto' only when a group of more than one rank is up and the input is
    large enough to amortize the collectives.
    """
    mode = CONFIG.distributed
    if mode == "off":
        return False
    if mode == "force":
        if not _group_up():
            raise ProcessGroupError(
                "CONFIG.distributed = 'force' but no process group is initialised"
            )
        return True
    if mode != "auto":
        raise ValueError(f"CONFIG.distributed must be 'off', 'auto' or 'force', not {mode!r}")
    return _group_up() and dist.get_world_size() > 1 and nrows >= CONFIG.dist_min_rows


def _from_chunks(arr, dtype: Optional[torch.dtype], device) -> torch.Tensor:
    """Accept a chunk sequence (``repro_torch.store`` column chunks, or
    any list of host arrays) as one tensor on ``device``: a chunk is the
    store's natural shard unit, so chunked columns feed the all-to-all
    in one host-to-device copy.  A tensor stays where it is."""
    if isinstance(arr, torch.Tensor):
        return arr
    dev = resolve_device(device)
    if isinstance(arr, (list, tuple)):
        if not arr:
            return torch.zeros((0,), dtype=dtype or torch.float64, device=dev)
        arr = np.concatenate([np.asarray(c) for c in arr])
    t = torch.from_numpy(np.require(np.asarray(arr), requirements=("C", "W")))
    return t.to(device=dev, dtype=dtype or t.dtype)


def _pad_to(ndev: int, keys: torch.Tensor, vals: Optional[torch.Tensor]):
    """Pad to a multiple of ``ndev`` with null keys / zero values."""
    n = int(keys.shape[0])
    pad = (-n) % ndev
    if pad:
        keys = torch.cat([keys, torch.full((pad,), -1, dtype=keys.dtype, device=keys.device)])
        if vals is not None:
            vals = torch.cat([vals, torch.zeros((pad,), dtype=vals.dtype, device=vals.device)])
    return keys, vals, n


def _block(t: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s rows of a tensor whose length ``world`` divides (a view)."""
    b = int(t.shape[0]) // world
    return t[rank * b:(rank + 1) * b]


def _check_rank(rank: int, world: int) -> None:
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} of a world of {world}")


def _not_capturing(t: torch.Tensor) -> None:
    if t.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a collective inside a CUDA graph capture")


def all_reduce(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Sum ``t`` over the mesh in place (counted)."""
    _not_capturing(t)
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def all_gather(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every rank's ``t`` concatenated in rank order (counted); bool goes
    over the wire as uint8."""
    _not_capturing(t)
    wire = t.contiguous().view(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    COLLECTIVES["all_gather"] += 1
    dist.all_gather(parts, wire, group=mesh.group)
    out = torch.cat(parts)
    return out.view(torch.bool) if t.dtype == torch.bool else out


def all_to_all(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Block ``d`` of ``t``'s leading axis to rank ``d``; block ``s`` of the
    result from rank ``s`` (counted)."""
    _not_capturing(t)
    out = torch.empty_like(t)
    COLLECTIVES["all_to_all"] += 1
    dist.all_to_all_single(out, t.contiguous(), group=mesh.group)
    return out


# ----------------------------------------------------------------------
# shard-local dense segment sum (reused by the group-by route)
# ----------------------------------------------------------------------
def local_dense_sum(keys: torch.Tensor, vals: torch.Tensor, domain: int) -> torch.Tensor:
    """Dense ``(domain,)`` sums of ``vals`` bucketed by ``keys``, in the
    dtype of ``vals`` (float32, float64, int64).

    Negative keys (nulls, padding) go to an extra slot ``domain``, which
    is dropped, so they contribute nothing: the sum runs over ``domain +
    1`` segments through ``kernels.ops.segment_sum`` (K1 on the card,
    which takes ids in any order and keeps each segment's sum, NaN and
    infinities included, to itself; no sort is needed, and ``vals`` goes
    to it as it is).  The JAX package's ``use_pallas`` switch has no
    counterpart: there is one reducer.
    """
    safe = torch.where(keys >= 0, keys.to(torch.int64), domain)
    return ops.segment_sum(vals.contiguous(), safe, domain + 1)[:domain]


# ----------------------------------------------------------------------
# sharded group-by sum
# ----------------------------------------------------------------------
def groupby_sum_shard(keys: torch.Tensor, vals: torch.Tensor, domain: int, rank: int,
                      world: int) -> torch.Tensor:
    """Rank ``rank``'s dense partial sums: its block of the padded rows."""
    _check_rank(rank, world)
    keys, vals, _ = _pad_to(world, keys, vals)
    return local_dense_sum(_block(keys, rank, world), _block(vals, rank, world), domain)


def dist_groupby_sum(mesh: DataMesh, keys: torch.Tensor, vals: torch.Tensor, domain: int,
                     axis: str = AXIS) -> torch.Tensor:
    """Global dense group-by sum: shard-local segment sums + ``all_reduce``.

    ``keys`` are dense group ids in ``[0, domain)`` (negative = null);
    returns the ``(domain,)`` per-group sums on every rank.
    """
    ROUTED["groupby_sum"] += 1
    part = groupby_sum_shard(keys, vals, domain, mesh.rank, mesh.shape[axis])
    return all_reduce(part, mesh)


# ----------------------------------------------------------------------
# broadcast-build semi join
# ----------------------------------------------------------------------
def semi_join_shard(probe: torch.Tensor, build: torch.Tensor, rank: int,
                    world: int) -> torch.Tensor:
    """``membership`` of rank ``rank``'s block of the padded probe side
    against the whole build side."""
    _check_rank(rank, world)
    probe, _, _ = _pad_to(world, probe, None)
    return membership(_block(probe, rank, world), build)


def dist_semi_join_mask(mesh: DataMesh, probe: torch.Tensor, build: torch.Tensor,
                        axis: str = AXIS) -> torch.Tensor:
    """``exists(probe[i] in build)`` with the probe side sharded.

    The build side is replicated on every rank and probed with the
    engine's sorted membership; negative probe keys (nulls) never match,
    as SQL semi/anti joins want.  The ranks' masks are gathered in rank
    order and cut to ``len(probe)``.
    """
    ROUTED["semi_join"] += 1
    local = semi_join_shard(probe, build, mesh.rank, mesh.shape[axis])
    return all_gather(local, mesh)[: int(probe.shape[0])]


# ----------------------------------------------------------------------
# hash-partition all-to-all
# ----------------------------------------------------------------------
def _umod(h: torch.Tensor, n: int) -> torch.Tensor:
    """``h % n`` of int64 bit patterns read as uint64 (``n < 2**31``)."""
    hi = (h >> 32) & 0xFFFFFFFF
    lo = h & 0xFFFFFFFF
    return ((hi % n) * ((1 << 32) % n) + lo) % n


def repartition_shard(keys: torch.Tensor, vals: torch.Tensor, capacity: int, rank: int,
                      world: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank ``rank``'s send buffers, ``(world, bucket)`` keys (-1 = empty)
    and values, row ``d`` for rank ``d``, and its overflow count."""
    _check_rank(rank, world)
    # ceil: a source rank holds ceil(n / world) rows, so capacity >= n
    # really does fit every row (lossless)
    bucket = max(1, -(-capacity // world))
    keys, vals, _ = _pad_to(world, keys, vals)
    k, v = _block(keys, rank, world), _block(vals, rank, world)
    nl, dev = int(k.shape[0]), k.device
    ok = k >= 0
    dest = torch.where(ok, _umod(hashing.splitmix64(k), world), world)  # nulls -> trash
    order = torch.argsort(dest, stable=True)  # stable: ties keep row order
    ks, vs, ds, oks = k[order], v[order], dest[order], ok[order]
    counts = torch.zeros((world + 1,), dtype=torch.int64, device=dev).scatter_add_(
        0, ds, torch.ones_like(ds))
    offs = torch.cumsum(counts, 0) - counts
    within = torch.arange(nl, dtype=torch.int64, device=dev) - offs[ds]
    fits = oks & (within < bucket)
    dropped = (oks & ~fits).sum()
    slot = torch.where(fits, ds * bucket + within, world * bucket)
    buf_k = torch.full((world * bucket + 1,), -1, dtype=ks.dtype, device=dev)
    buf_k[slot] = torch.where(fits, ks, -1)
    buf_v = torch.zeros((world * bucket + 1,), dtype=vs.dtype, device=dev)
    buf_v[slot] = torch.where(fits, vs, torch.zeros((), dtype=vs.dtype, device=dev))
    return (buf_k[: world * bucket].reshape(world, bucket),
            buf_v[: world * bucket].reshape(world, bucket), dropped)


def dist_repartition_by_key(
    mesh: DataMesh,
    keys: Union[torch.Tensor, Sequence],
    vals: Union[torch.Tensor, Sequence],
    capacity: int,
    axis: str = AXIS,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shuffle rows so each key's rows land on exactly one rank.

    Rows go to rank ``splitmix64(key) % ndev``.  Each source rank owns a
    fixed send bucket of ``ceil(capacity / ndev)`` slots per destination
    (static shapes for the all-to-all); a source's rows beyond its bucket
    are counted in ``dropped``.  ``capacity >= len(keys)`` guarantees no
    bucket overflows: the shuffle is lossless.

    Returns ``(keys2, vals2, valid, dropped)``: global slot arrays of
    length ``ndev * ndev * ceil(capacity / ndev)`` (rank ``d``'s received
    slots at ``[d * ndev * bucket, (d + 1) * ndev * bucket)``), the mask
    of the occupied slots, and the global overflow count, on every rank.

    ``keys``/``vals`` may each be a *sequence of chunks* (the per-chunk
    physical arrays of a ``repro_torch.store`` column) instead of one
    tensor; they then go to ``device`` (default ``CONFIG.device``), and
    the row order is the chunks' concatenation order.
    """
    ROUTED["repartition"] += 1
    keys = _from_chunks(keys, torch.int64, device)
    vals = _from_chunks(vals, None, keys.device)
    buf_k, buf_v, dropped = repartition_shard(keys, vals, capacity, mesh.rank, mesh.shape[axis])
    rk = all_to_all(buf_k, mesh).reshape(-1)
    rv = all_to_all(buf_v, mesh).reshape(-1)
    keys2 = all_gather(rk, mesh)
    return keys2, all_gather(rv, mesh), keys2 >= 0, all_reduce(dropped, mesh)
