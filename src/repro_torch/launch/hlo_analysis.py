"""The step analysis behind the dry run's roofline terms.

The JAX package's module of this name walks the compiled HLO of a step
and weights each while-loop body by its trip count.  The port has no
HLO: this module analyses the torch step itself, as it runs under
DTensor on tensors without data (meta tensors, one rank's view of the
mesh), by watching the operations each rank would run on its local
shards:

- FLOPs: ``torch.utils.flop_counter``'s formula for each matrix product
  (``flops``; the products alone in ``dot_flops``), plus the kernels'
  own formulas for the calls that took their fake route (K4 and K5,
  ``kernels.build.FAKE_COSTS``: ``kernel_flops``);
- collective operand bytes by kind, from each ``c10d_functional``
  collective (and DTensor's all-to-all), under the reference's five
  kind names (``COLLECTIVES``);
- matrix-product traffic (``dot_bytes``: operand and result bytes),
  every operation's (``op_bytes``: tensor inputs read and outputs
  written, views excluded; the eager step fuses nothing), the kernels'
  (``kernel_bytes``), and the reference's ``giant_bytes`` rule;
- the calls of each aten operation by its overload-packet name
  (``op_calls``; ``count_op`` reads it);
- the peak of live memory: the storages of the rank's local tensors,
  the step's inputs from the start, each freed when its storage is
  (torch's ``MemTracker``, on the card machine's torch 2.11, also
  counted DTensor's sharding-propagation tensors, at global shapes: 478
  GB for a step whose own peak was 14 GB).

The port runs every block as a Python loop, so each operation is seen
as often as it runs: no trip weighting is needed.  Operations DTensor
runs to propagate shardings (on fake tensors of global shapes) are not
the rank's and are skipped.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, Iterable, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels import build

COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

#: the kind of each collective operation, by its op name
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_DOTS = {"mm": (0, 1), "bmm": (0, 1), "addmm": (1, 2), "baddbmm": (1, 2)}
#: results (and operands) of products this large count as giant
#: intermediates, by the reference's rule
GIANT = 64 * 1024 * 1024


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(items, out=None) -> list:
    """The tensors among ``items`` and in their lists and tuples (an op's
    arguments and results are no deeper)."""
    out = [] if out is None else out
    for a in items:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            _tensors(a, out)
    return out


class StepCounter(TorchDispatchMode):
    """Counts one rank's work while active (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.dot_flops = 0
        self.dot_bytes = 0
        self.op_bytes = 0
        self.giant_bytes = 0
        self.coll: Dict[str, int] = defaultdict(int)
        self.coll_calls: Dict[str, int] = defaultdict(int)
        #: (kind, process group name) -> operand bytes
        self.by_group: Dict[Tuple[str, str], int] = defaultdict(int)
        #: aten overload-packet name -> calls
        self.op_calls: Dict[str, int] = defaultdict(int)
        self._live: Dict[int, int] = {}  # storage -> bytes, of live local tensors
        self.live_bytes = 0
        self.peak_bytes = 0

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live from now until it is freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        nbytes = st.nbytes()
        self._live[key] = nbytes
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor turns it into local ops, seen below
        out = func(*args, **kwargs)
        ins = _tensors(args, _tensors(kwargs.values()))
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out  # DTensor's sharding propagation, not the rank's work
        ns, name = func.namespace, func._overloadpacket.__name__
        self.op_calls[name] += 1
        if func.is_view:
            return out  # moves and computes nothing
        for t in outs:
            self.track(t)
        if ns in ("_c10d_functional", "c10d_functional", "_dtensor") and name in _KINDS:
            kind, nbytes = _KINDS[name], sum(_nbytes(t) for t in ins)
            group = [a for a in (*args, *kwargs.values()) if isinstance(a, str)][-1]
            self.coll[kind] += nbytes
            self.coll_calls[kind] += 1
            self.by_group[(kind, group)] += nbytes
            return out
        if ns in ("_c10d_functional", "c10d_functional", "_c10d_functional_autograd"):
            return out  # waits and wrappers move nothing
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += flops
            if name in _DOTS:
                self.dot_flops += flops
                opers = [_nbytes(args[i]) for i in _DOTS[name]]
                res = _nbytes(outs[0])
                self.dot_bytes += res + sum(opers)
                if res >= GIANT and res >= 4 * max(1, sum(opers)):
                    self.giant_bytes += res
                self.giant_bytes += sum(b for b in opers if b >= GIANT and b >= 4 * max(1, res))
        if not name.startswith("empty"):
            self.op_bytes += sum(_nbytes(t) for t in ins + outs)
        return out

    def collectives(self) -> Dict[str, int]:
        return {k: int(self.coll[k]) for k in COLLECTIVES if k in self.coll} | {
            k: int(v) for k, v in self.coll.items() if k not in COLLECTIVES}


def local_tensors(tree: Any) -> Iterable[torch.Tensor]:
    """Every tensor of ``tree`` (its local shard where it is a DTensor),
    once each; modules give their parameters."""
    seen = {}  # id -> the tensor, kept alive so that no id is reused
    for leaf in tree_leaves(tree, is_leaf=lambda x: isinstance(x, torch.nn.Module)):
        ts = (list(leaf.parameters()) if isinstance(leaf, torch.nn.Module)
              else [leaf] if isinstance(leaf, torch.Tensor) else [])
        for t in ts:
            if id(t) not in seen:
                seen[id(t)] = t
                yield t.to_local() if isinstance(t, DTensor) else t


def tree_bytes(tree: Any) -> int:
    """Bytes of the local shards of every tensor of ``tree``."""
    return sum(_nbytes(t) for t in local_tensors(tree))


def analyze(step: Callable[[], Any], inputs: Any) -> Tuple[Any, Dict[str, Any]]:
    """Run ``step()`` under the counters, with ``inputs`` (the tree of the
    step's arguments) live from the start; return its result and the
    counts, per device."""
    build.reset_fake_costs()
    counter = StepCounter()
    for t in local_tensors(inputs):
        counter.track(t)
    with counter:
        result = step()
    peak = counter.peak_bytes
    kernel_flops = sum(c["ops"] for c in build.FAKE_COSTS.values())
    kernel_bytes = sum(c["bytes"] for c in build.FAKE_COSTS.values())
    coll = counter.collectives()
    counts = {
        "flops": counter.flops + kernel_flops,
        "aten_flops": counter.flops,
        "dot_flops": counter.dot_flops + kernel_flops,
        "kernel_flops": kernel_flops,
        "dot_bytes": counter.dot_bytes + kernel_bytes,
        "op_bytes": counter.op_bytes + kernel_bytes,
        "kernel_bytes": kernel_bytes,
        "giant_bytes": counter.giant_bytes,
        "collectives": coll,
        "collective_calls": {k: int(v) for k, v in counter.coll_calls.items()},
        "coll_total": sum(coll.values()),
        "by_group": dict(counter.by_group),
        "op_calls": dict(counter.op_calls),
        "kernels": {k: dict(v) for k, v in build.FAKE_COSTS.items()},
        "peak_bytes": int(peak),
    }
    return result, counts


def collective_bytes(counts: Dict[str, Any]) -> Dict[str, int]:
    """Collective operand bytes per kind plus ``"total"``, the keys of the
    JAX package's helper of this name, read from the counts ``analyze``
    returns (the port has no HLO text to read them from)."""
    out = {k: int(v) for k, v in counts["collectives"].items()}
    out["total"] = int(counts.get("coll_total", 0))
    return out


def count_op(counts: Dict[str, Any], opname: str) -> int:
    """How often the aten operation ``opname`` (its overload-packet name,
    e.g. ``"mm"``) ran in the step ``analyze`` counted; the JAX package's
    helper of this name counts instructions in HLO text instead."""
    return int(counts["op_calls"].get(opname, 0))
