"""Parameter/activation partition rules for the production meshes
(``repro/models/partition.py``), as DTensor placements.

Axes: ("pod", "data", "model") multi-pod or ("data", "model") single-pod.
- TP over "model": attention heads, d_ff, vocab, experts (EP).
- ZeRO-style parameter sharding over "data" on the other major dim.
- DP batch over ("pod", "data").

Rules match on parameter-path key names, so every architecture family
shares one table.  The port keeps one weight per block
(``blocks.0.attn.wq``) where the JAX package stacks the blocks on a
leading layer axis, so a per-block weight's spec is the reference's
stacked spec without its leading ``None``; every other weight
(``shared_attn``, ``embed``, ...) gets the reference's spec as it is.

A spec is a ``P``: one entry per tensor dim, naming the mesh axis (or a
tuple of axes, major first) that dim is sharded over, or ``None``.
``shardings_from_specs`` turns specs into ``NamedSharding``s, DTensor
placements on a ``DeviceMesh`` (``Shard(d)`` on each mesh dim named at
tensor dim ``d``, ``Replicate()`` elsewhere), and ``distribute_tree``
places a tree of tensors by them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor


class P(tuple):
    """A partition spec: ``P("data", "model")``, ``P(("pod", "data"), None)``,
    ``P()``; a tuple of one axis is that axis, as in JAX."""

    def __new__(cls, *axes):
        return super().__new__(cls, (a[0] if isinstance(a, tuple) and len(a) == 1 else a
                                     for a in axes))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else f"P({self[0]!r})"


# name -> spec builder over the trailing (non-layer-stacked) dims
_RULES = [
    # MoE experts: (E, D, F) / (E, F, D)
    ("moe.w_gate", ("model", "data", None)),
    ("moe.w_up", ("model", "data", None)),
    ("moe.w_down", ("model", "data", None)),
    ("moe.router", ("data", None)),
    ("moe.shared.w_gate", ("data", "model")),
    ("moe.shared.w_up", ("data", "model")),
    ("moe.shared.w_down", ("model", "data")),
    # attention
    (".attn.wq", ("data", "model")),
    (".attn.wk", ("data", "model")),
    (".attn.wv", ("data", "model")),
    (".attn.wo", ("model", "data")),
    (".attn.bq", ("model",)),
    (".attn.bk", ("model",)),
    (".attn.bv", ("model",)),
    # dense mlp
    ("mlp.w_gate", ("data", "model")),
    ("mlp.w_up", ("data", "model")),
    ("mlp.w_down", ("model", "data")),
    # rwkv
    (".wr", ("data", "model")),
    (".wk", ("data", "model")),
    (".wv", ("data", "model")),
    (".wg", ("data", "model")),
    (".wo", ("model", "data")),
    (".ck", ("data", "model")),
    (".cv", ("model", "data")),
    (".cr", ("data", "model")),
    (".wA", ("data", None)),
    (".wB", (None, "model")),
    # mamba
    ("in_proj", ("data", "model")),
    ("out_proj", ("model", "data")),
    # embeddings: vocab over data (ZeRO), d_model over model -- the token
    # gather then only all-gathers a (V, D/|model|) slice over 'data'
    # instead of fully rematerializing a vocab-sharded table
    ("embed", ("data", "model")),
    ("lm_head", ("data", "model")),
]


def spec_for(path_str: str, ndim: int, stacked: bool) -> P:
    """PartitionSpec for a parameter; `stacked` = leading layer dim."""
    for pat, axes in _RULES:
        if pat in "." + path_str:
            trailing = list(axes)
            lead = [None] if stacked else []
            spec = lead + trailing
            # pad/trim to ndim
            while len(spec) < ndim:
                spec.append(None)
            return P(*spec[:ndim])
    return P(*([None] * ndim))


_KV_PATTERNS = (".attn.wk", ".attn.wv", ".attn.bk", ".attn.bv")


def param_specs(params: Any, cfg=None) -> Dict[str, P]:
    """Spec of every weight of a ``Params`` (or a ``{name: tensor}``
    mapping), keyed by parameter name (``blocks.0.attn.wq``).

    cfg.kv_shard == 'replicated' keeps KV projections unsharded on the
    model axis: with GQA kv_heads < |model| the per-device KV slice is a
    fraction of a head and the attention einsums force resharding
    traffic; replicating the (small) KV projections removes it."""
    named = dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)
    replicate_kv = cfg is not None and getattr(cfg, "kv_shard", "model") == "replicated"
    out = {}
    for name, leaf in named.items():
        ndim = len(leaf.shape)
        spec = spec_for(name, ndim, stacked=False)
        if replicate_kv and any(pat in "." + name for pat in _KV_PATTERNS):
            spec = P(*[("data" if a == "data" else None)
                       for a in (list(spec) + [None] * ndim)[:ndim]])
        out[name] = spec
    return out


# ----------------------------------------------------------------------
# batch and decode-state specs
# ----------------------------------------------------------------------
def mesh_shape(mesh: Any) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of such a mapping)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh)


def batch_axes(mesh: Any) -> Tuple[str, ...]:
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def _divisible_dp(mesh: Any, B: int) -> Optional[Tuple[str, ...]]:
    """Largest prefix of the dp axes that divides B (B=1 -> replicate)."""
    shape = mesh_shape(mesh)
    axes = []
    prod = 1
    for a in batch_axes(mesh):
        prod *= shape[a]
        if B % prod == 0:
            axes.append(a)
        else:
            break
    return tuple(axes) if axes else None


def _tree_map(fn, tree: Any, path: str = ""):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v, f"{path}.{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_tree_map(fn, v, f"{path}.{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def batch_specs(mesh: Any, batch_shape: Any) -> Any:
    """Shard the leading batch dim over (pod, data) where divisible."""

    def fn(_, leaf):
        ndim = len(leaf.shape)
        B = leaf.shape[0] if ndim else 1
        dp = _divisible_dp(mesh, B)
        spec = [dp] + [None] * (ndim - 1) if dp else [None] * ndim
        return P(*spec)

    return _tree_map(fn, batch_shape)


def decode_state_specs(mesh: Any, state_shape: Dict) -> Dict:
    """KV caches: (L, B, Smax, Hkv, hd) -> batch over dp axes, sequence
    over 'model' (flash-decode style sharded cache); recurrent states:
    batch over dp axes.  ``pos`` (a host int in the port) is replicated."""
    shape = mesh_shape(mesh)

    def fn(name, leaf):
        if name in ("k", "v", "xk", "xv"):
            B = leaf.shape[1]
            dp = _divisible_dp(mesh, B)
            smax = leaf.shape[2]
            seq = "model" if smax % shape["model"] == 0 and smax >= 4096 else None
            return P(None, dp, seq, None, None)
        if name == "pos":
            return P()
        ndim = len(leaf.shape)
        if name in ("S", "h"):  # (L, B, H, ...) recurrent states
            B = leaf.shape[1]
            dp = _divisible_dp(mesh, B)
            spec = [None, dp] + [None] * (ndim - 2)
            return P(*spec)
        # tm_prev/cm_prev: (L, B, 1, D)
        B = leaf.shape[1]
        dp = _divisible_dp(mesh, B)
        return P(*([None, dp] + [None] * (ndim - 2)))

    return _tree_map(fn, state_shape)


# ----------------------------------------------------------------------
# specs -> DTensor placements
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the placement of each mesh dim (``placements``)."""

    mesh: DeviceMesh
    spec: P

    @property
    def placements(self) -> Tuple:
        names = self.mesh.mesh_dim_names
        named = [a for entry in self.spec if entry is not None
                 for a in (entry if isinstance(entry, tuple) else (entry,))]
        unknown = [a for a in named if a not in names]
        if unknown or len(set(named)) != len(named):
            raise ValueError(f"spec {self.spec} on mesh axes {names}")
        for entry in self.spec:
            if isinstance(entry, tuple) and list(entry) != sorted(entry, key=names.index):
                raise ValueError(f"spec {self.spec}: the axes of one dim must go major first")
        out = []
        for name in names:
            dims = [d for d, entry in enumerate(self.spec)
                    if entry == name or (isinstance(entry, tuple) and name in entry)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def gather_for_use(w):
    """A weight as the step uses it: a DTensor sharded over a batch axis
    ("pod", "data": the ZeRO sharding of the rules above) comes back
    replicated over it, an all-gather whose backward reduce-scatters the
    gradient, as FSDP gathers a weight for its layer; its sharding over
    "model" stays.  Anything else is returned as it is."""
    if not isinstance(w, DTensor):
        return w
    mesh = w.device_mesh
    placements = [Replicate() if name in ("pod", "data") and mesh.size(i) > 1 and p.is_shard()
                  else p for i, (name, p) in enumerate(zip(mesh.mesh_dim_names, w.placements))]
    if placements == list(w.placements):
        return w
    return w.redistribute(mesh, placements)


def shardings_from_specs(mesh: DeviceMesh, specs: Any) -> Any:
    """The tree of ``specs`` with each spec a ``NamedSharding`` on ``mesh``."""
    return _tree_map(lambda _, s: NamedSharding(mesh, s), specs)


def distribute(t: torch.Tensor, sharding: NamedSharding):
    """``t`` (whole, the same on every rank) as a DTensor placed by ``sharding``."""
    mesh = sharding.mesh
    return distribute_tensor(t.to(mesh.device_type), mesh, sharding.placements)


def distribute_tree(tree: Any, shardings: Any) -> Any:
    """Every tensor of ``tree`` placed by the matching leaf of ``shardings``
    (a tree of the same structure); other leaves stay as they are."""
    if isinstance(tree, Mapping):
        return {k: distribute_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute_tree(v, s) for v, s in zip(tree, shardings))
    return distribute(tree, shardings) if isinstance(tree, torch.Tensor) else tree
