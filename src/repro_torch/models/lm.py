"""Model facade: init / forward / loss / prefill / decode for every
family of the JAX package (dense, MoE, RWKV6, the Mamba2 hybrid,
cross-attention layers, embedding inputs), a Python loop over layers
where the JAX package scans over stacked layer parameters, each block
under ``cfg.remat`` while a gradient is wanted.

Mirrors ``repro/models/lm.py``.  Weights live in a ``Params`` module:
one sub-module per block (``params["blocks"][i]``, and
``params["cross_blocks"][i]``), every weight a parameter under the
reference's name, frozen unless training makes it trainable
(``train.train_step.init_train_state``).  ``load_reference_params``
carries the JAX package's parameter pytree over, so both packages
compute the same logits from the same weights; ``reference_tree`` is its
inverse, for weights and for gradients.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils import checkpoint as ckpt

from ..core.config import resolve_device
from . import layers, mamba, partition, rwkv
from .config import ModelConfig
from .layers import cdtype


class Params(nn.Module):
    """A tree of weights as a module: each tensor of ``tree`` becomes a
    frozen parameter, each dict a sub-module and each list a
    ``ModuleList``.  Read by name, ``p["wq"]``, as the JAX package reads
    its pytrees; a DTensor weight sharded over a batch axis reads as
    ``partition.gather_for_use`` gathers it."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, Mapping):
                self.add_module(name, Params(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(name, nn.ModuleList(Params(v) for v in val))
            else:
                self.register_parameter(name, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, name: str):
        # a weight sharded over a batch axis is gathered for its use (ZeRO)
        return partition.gather_for_use(getattr(self, name))

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def trainable(self) -> bool:
        """Whether any weight requires a gradient.  The flat tuple of the
        weights is kept on first use (a walk of the module tree costs about
        0.5 ms at 40 layers, every forward); their flags are read anew."""
        flat = self.__dict__.get("_flat")
        if flat is None:
            flat = self.__dict__["_flat"] = tuple(self.parameters())
        return any(p.requires_grad for p in flat)


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------
def init_params(
    cfg: ModelConfig,
    generator: Optional[torch.Generator] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Params:
    """Random weights drawn from ``generator`` on ``device`` (the CUDA
    card unless the caller asks for the CPU).  The generator must live on
    that device; none means one seeded with 0.  Its numbers differ from
    ``jax.random``'s: carry the JAX package's weights over with
    ``load_reference_params`` to compare the two."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    if torch.device(generator.device).type != dev.type:
        raise ValueError(f"generator on {generator.device}, weights wanted on {dev}")
    return Params(_init_tree(cfg, generator))


def _init_tree(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    pd = layers.pdtype(cfg)
    D, V = cfg.d_model, cfg.vocab
    dev = gen.device
    ones = lambda: torch.ones((D,), dtype=pd, device=dev)
    p: Dict = {
        "final_norm": ones(),
        "lm_head": layers.normal(gen, (D, V), 1.0 / np.sqrt(D), pd),
    }
    if cfg.embed_inputs:
        p["embed"] = layers.normal(gen, (V, D), 0.02, pd)
    if cfg.family == "rwkv6":
        p["blocks"] = [rwkv.init_rwkv_block(gen, cfg) for _ in range(cfg.n_layers)]
        return p
    if cfg.family == "mamba_hybrid":
        p["blocks"] = [mamba.init_mamba_block(gen, cfg) for _ in range(cfg.n_layers)]
        # ONE shared attention+MLP block, reused every attn_every layers
        p["shared_attn"] = {"norm1": ones(), "attn": layers.init_attention(gen, cfg),
                            "norm2": ones(), "mlp": layers.init_mlp(gen, cfg)}
        return p

    def init_block():
        blk = {"norm1": ones(), "attn": layers.init_attention(gen, cfg), "norm2": ones()}
        if cfg.moe:
            blk["moe"] = layers.init_moe(gen, cfg)
        else:
            blk["mlp"] = layers.init_mlp(gen, cfg)
        return blk

    if cfg.cross_attn_every:
        n_cross = cfg.n_layers // cfg.cross_attn_every
        p["blocks"] = [init_block() for _ in range(cfg.n_layers - n_cross)]
        p["cross_blocks"] = [
            {"norm1": ones(), "attn": layers.init_attention(gen, cfg, cross=True),
             "norm2": ones(), "mlp": layers.init_mlp(gen, cfg)}
            for _ in range(n_cross)
        ]
        return p
    p["blocks"] = [init_block() for _ in range(cfg.n_layers)]
    return p


def load_reference_params(
    cfg: ModelConfig, tree: Mapping, device: Optional[Union[str, torch.device]] = None
) -> Params:
    """The port's weights from the JAX package's parameter pytree, given
    as numpy arrays (``jax.tree.map(np.asarray, params)``).  The leading
    layer axis of ``tree["blocks"]`` and ``tree["cross_blocks"]`` is
    unstacked into one module per block (``shared_attn``, one block
    reused, stays as it is); dtypes are kept."""
    dev = resolve_device(device)

    def to_torch(val):
        if isinstance(val, Mapping):
            return {name: to_torch(v) for name, v in val.items()}
        arr = np.asarray(val)
        if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: go through its bits
            return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(dev)
        return torch.from_numpy(np.array(arr)).to(dev)

    out = {}
    for name, val in tree.items():
        out[name] = to_torch(val)
        if name in ("blocks", "cross_blocks"):
            n = len(next(iter(_leaves(out[name]))))
            out[name] = [_take_layer(out[name], i) for i in range(n)]
    return Params(out)


def tree_from_names(named: Mapping[str, torch.Tensor]) -> Dict:
    """``{"blocks.0.attn.wq": t, ...}`` (``named_parameters``' names, as
    gradients are keyed) as the nested dict, with lists for the per-block
    modules, that ``Params`` is built from: ``Params(tree_from_names(
    dict(p.named_parameters())))`` rebuilds ``p``."""
    out: Dict = {}
    for name, t in named.items():
        parts = name.split(".")
        node = out
        for part, nxt in zip(parts[:-1], parts[1:]):
            child = [] if nxt.isdigit() else {}
            if isinstance(node, list):
                i = int(part)
                node.extend(None for _ in range(i + 1 - len(node)))
                if node[i] is None:
                    node[i] = child
                node = node[i]
            else:
                node = node.setdefault(part, child)
        node[parts[-1]] = t
    return out


def reference_tree(tree: Union[Params, Mapping[str, torch.Tensor]]) -> Dict:
    """The inverse of ``load_reference_params``: the port's weights (a
    ``Params``), or gradients keyed by parameter name, as the JAX
    package's pytree of numpy arrays.  Each leaf of the per-block lists
    (``blocks``, ``cross_blocks``) is stacked on a leading layer axis;
    bfloat16 comes back as float32, which holds it exactly."""
    tree = tree_from_names(dict(tree.named_parameters()) if isinstance(tree, Params) else tree)

    def to_np(val):
        if isinstance(val, Mapping):
            return {name: to_np(v) for name, v in val.items()}
        t = val.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    out = {}
    for name, val in tree.items():
        if isinstance(val, list):
            per = [to_np(v) for v in val]
            out[name] = _stack(per)
        else:
            out[name] = to_np(val)
    return out


def _stack(per: list):
    if isinstance(per[0], Mapping):
        return {name: _stack([p[name] for p in per]) for name in per[0]}
    return np.stack(per)


def _leaves(tree: Mapping):
    for val in tree.values():
        if isinstance(val, Mapping):
            yield from _leaves(val)
        else:
            yield val


def _take_layer(tree: Mapping, i: int) -> Dict:
    return {
        name: _take_layer(val, i) if isinstance(val, Mapping) else val[i]
        for name, val in tree.items()
    }


# ----------------------------------------------------------------------
# remat policy
# ----------------------------------------------------------------------
#: what ``remat="dots"`` saves: the outputs of matrix products (the
#: counterpart of ``checkpoint_dots_with_no_batch_dims``; the port's
#: products with a batch dim, the MoE experts' ``bmm``, are saved too)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn: Callable, cfg: ModelConfig, grad: bool) -> Callable:
    """``fn`` under ``cfg.remat`` (``torch.utils.checkpoint``, non-reentrant)
    while a gradient is wanted (``grad``), else ``fn`` itself:
    ``"nothing"`` keeps only the block's inputs and runs its forward again
    in the backward; ``"dots"`` keeps the outputs of its matrix products
    too; ``"none"`` keeps everything."""
    if not grad or cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        ctx = functools.partial(ckpt.create_selective_checkpoint_contexts, _save_dots)
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False, context_fn=ctx)
    if cfg.remat != "nothing":
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False)


def residual(x: torch.Tensor) -> torch.Tensor:
    """The residual stream between blocks as the sharded step keeps it:
    a DTensor batch-sharded over the batch axes where it is, replicated
    over the others (Megatron's layout: each tensor-parallel block
    starts from replicated activations and ends in one all-reduce).
    Without this explicit redistribute DTensor lets the stream drift to
    placements (d_model sharded, partial sums) from which it picks
    strategies that leave the logits or a block's products as whole
    partial sums on every rank.  Mesh dims of one rank and plain tensors
    are left as they are."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    pl = [p if mesh.size(i) == 1
          else Shard(0) if name in ("pod", "data") and isinstance(p, Shard) and p.dim == 0
          else Replicate()
          for i, (name, p) in enumerate(zip(mesh.mesh_dim_names, x.placements))]
    return x if pl == list(x.placements) else x.redistribute(mesh, pl)


def _wants_grad(params: Params) -> bool:
    return torch.is_grad_enabled() and params.trainable()


# ----------------------------------------------------------------------
# forward (train / prefill)
# ----------------------------------------------------------------------
def _ffn(cfg: ModelConfig, bp, xn, real_rows: Optional[int] = None):
    if "moe" in bp:
        return layers.moe_ffn(bp["moe"], cfg, xn, real_rows)
    return layers.mlp(bp["mlp"], cfg, xn)


def _self_block(cfg: ModelConfig, x, bp, positions, real_rows: Optional[int] = None):
    h, _ = layers.attention(
        bp["attn"], cfg, layers.rms_norm(x, bp["norm1"], cfg.norm_eps), positions
    )
    x = x + h
    return x + _ffn(cfg, bp, layers.rms_norm(x, bp["norm2"], cfg.norm_eps), real_rows)


def _cross_block(cfg: ModelConfig, x, bp, img):
    h, _ = layers.attention(
        bp["attn"], cfg, layers.rms_norm(x, bp["norm1"], cfg.norm_eps),
        positions=None, kv_x=img, causal=False,
    )
    x = x + h
    return x + layers.mlp(bp["mlp"], cfg, layers.rms_norm(x, bp["norm2"], cfg.norm_eps))


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  On a DTensor table the gather runs through
    ``local_map``: DTensor's strategy for its backward (``index_put``)
    fails on some torch builds for a table sharded on its last dim.  Each
    rank gathers its tokens' rows from the table replicated over the mesh
    dims that shard the vocab or the tokens, its own slice of d_model
    where the table is sharded on it; the table's gradient is a partial
    sum over the mesh dims of more than one rank that shard the tokens."""
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    tab, grad, tok, out = [], [], [], []
    for i, (tp, kp) in enumerate(zip(table.placements, tokens.placements)):
        by_batch = isinstance(kp, Shard) and kp.dim == 0
        by_width = not by_batch and isinstance(tp, Shard) and tp.dim == 1
        tab.append(Shard(1) if by_width else Replicate())
        grad.append(Partial() if by_batch and mesh.size(i) > 1 else tab[-1])
        tok.append(Shard(0) if by_batch else Replicate())
        out.append(Shard(0) if by_batch else Shard(2) if by_width else Replicate())
    return local_map(lambda t, k: t[k], out_placements=(tuple(out),),
                     in_placements=(tuple(tab), tuple(tok)),
                     in_grad_placements=(tuple(grad), tuple(tok)), redistribute_inputs=True,
                     device_mesh=mesh)(table, tokens)


def _inputs(cfg: ModelConfig, params: Params, batch: Mapping[str, torch.Tensor]):
    dt = cdtype(cfg)
    if cfg.embed_inputs:
        return _embed(params["embed"].to(dt), batch["tokens"])
    return batch["embeddings"].to(dt)


class _RowPad(NamedTuple):
    """How a DTensor batch is padded: the mesh dims that shard its rows,
    the rows each such shard holds, and the rows added to each."""
    dims: Tuple[bool, ...]
    rows: int
    pad: int


def _row_pad(batch: Mapping[str, torch.Tensor]) -> Optional[_RowPad]:
    """The padding of a DTensor batch whose shards' rows the mesh dims that
    do not shard them (the "model" axis) cannot split: DTensor refuses
    views of a dim sharded unevenly, where the reference's partitioner
    pads.  Each shard's rows are padded up to a multiple of those dims
    where neither of the two divides the other (3 rows on 2 ranks, not 2
    on 16 or 4 on 2); None where nothing is padded (plain tensors, and
    such batches)."""
    lead = batch.get("tokens", batch.get("embeddings"))
    if not isinstance(lead, DTensor):
        return None
    mesh = lead.device_mesh
    dims = tuple(isinstance(p, Shard) and p.dim == 0 for p in lead.placements)
    rows = lead.shape[0] // int(np.prod([mesh.size(i) for i, d in enumerate(dims) if d]))
    others = int(np.prod([mesh.size(i) for i, d in enumerate(dims) if not d]))
    if rows % others == 0 or others % rows == 0:
        return None
    return _RowPad(dims, rows, -(-rows // others) * others - rows)


def _row_placements(t: DTensor, dims: Tuple[bool, ...]) -> Tuple:
    """``t``'s placements with its rows sharded over ``dims`` alone."""
    return tuple(Shard(0) if d else Replicate() if isinstance(p, Shard) and p.dim == 0 else p
                 for d, p in zip(dims, t.placements))


def _pad_rows(t: DTensor, rp: _RowPad, value=0) -> DTensor:
    """Each shard of ``t``'s rows with ``rp.pad`` rows of ``value`` after it."""
    pl = _row_placements(t, rp.dims)
    fill = lambda x: torch.cat([x, x.new_full((rp.pad, *x.shape[1:]), value)])
    return local_map(fill, out_placements=(pl,), in_placements=(pl,), redistribute_inputs=True,
                     device_mesh=t.device_mesh)(t)


def _unpad_rows(t: torch.Tensor, rp: Optional[_RowPad]) -> torch.Tensor:
    """``t`` without the rows ``_pad_rows`` added to each shard."""
    if rp is None:
        return t
    pl = _row_placements(t, rp.dims)
    return local_map(lambda x: x[:rp.rows], out_placements=(pl,), in_placements=(pl,),
                     redistribute_inputs=True, device_mesh=t.device_mesh)(t)


def _padded(batch: Mapping[str, torch.Tensor], rp: Optional[_RowPad]) -> Mapping:
    """The batch with every leaf's shards padded (tokens, labels,
    embeddings with zeros, ``loss_mask`` with zeros, made of ones for the
    real rows where the batch has none)."""
    if rp is None:
        return batch
    out = dict(batch)
    if "labels" in out and "loss_mask" not in out:
        out["loss_mask"] = torch.ones_like(out["labels"], dtype=torch.float32)
    return {k: _pad_rows(v, rp) for k, v in out.items()}


def forward(
    cfg: ModelConfig,
    params: Params,
    batch: Mapping[str, torch.Tensor],
    return_hidden: bool = False,
) -> torch.Tensor:
    """batch: {'tokens' (B,S) | 'embeddings' (B,S,D)} [+ 'img_embed'
    (B,n_img_tokens,D)].  Returns logits (B, S, V) in f32 (or the final
    hidden states).  A DTensor batch whose rows the "model" axis cannot
    split runs padded (``_row_pad``) and comes back without the pad."""
    rp = _row_pad(batch)
    return _unpad_rows(_forward(cfg, params, _padded(batch, rp), return_hidden, rp), rp)


def _forward(cfg: ModelConfig, params: Params, batch: Mapping[str, torch.Tensor],
             return_hidden: bool, rp: Optional[_RowPad]) -> torch.Tensor:
    """``forward`` on a batch as ``_padded`` leaves it (``rp`` its padding:
    the MoE layers route only the real rows)."""
    dt = cdtype(cfg)
    real = None if rp is None else rp.rows
    x = residual(_inputs(cfg, params, batch))
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int64, device=x.device).expand(B, S)
    blocks = params["blocks"]
    # each block under the remat policy, as the JAX package's scans are
    # (not the hybrid's shared attention block, as there)
    grad = _wants_grad(params)
    remat = lambda fn: (lambda x: residual(_remat(fn, cfg, grad)(x)))
    if cfg.family == "rwkv6":
        for bp in blocks:
            x = remat(lambda x, bp=bp: rwkv.rwkv_block(bp, cfg, x)[0])(x)
    elif cfg.family == "mamba_hybrid":
        sp = params["shared_attn"]
        for i, bp in enumerate(blocks):
            x = remat(lambda x, bp=bp: mamba.mamba_block(bp, cfg, x)[0])(x)
            if (i + 1) % cfg.attn_every == 0:
                # the shared attention block (same params every group)
                x = residual(_self_block(cfg, x, sp, positions, real))
    elif cfg.cross_attn_every:
        img = batch["img_embed"].to(dt)
        per = cfg.cross_attn_every - 1
        for g, cp in enumerate(params["cross_blocks"]):
            for bp in blocks[g * per:(g + 1) * per]:
                x = remat(lambda x, bp=bp: _self_block(cfg, x, bp, positions, real))(x)
            x = remat(lambda x, cp=cp: _cross_block(cfg, x, cp, img))(x)
    else:
        for bp in blocks:
            x = remat(lambda x, bp=bp: _self_block(cfg, x, bp, positions, real))(x)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x
    logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"].to(dt))
    return logits.to(torch.float32)


def _vocab_sharded(logits: torch.Tensor) -> bool:
    """Is ``logits`` a DTensor sharded on its last (vocab) dim over a mesh
    dim of more than one rank?"""
    if not isinstance(logits, DTensor):
        return False
    mesh = logits.device_mesh
    return any(isinstance(p, Shard) and p.dim == logits.ndim - 1 and mesh.size(i) > 1
               for i, p in enumerate(logits.placements))


def _label_logit(logits: DTensor, labels: torch.Tensor) -> DTensor:
    """``logits[..., labels]`` for logits sharded on their vocab dim,
    through ``local_map``: each rank picks the labels that fall in its
    slice of the vocab (0 for the others), a partial sum over the mesh
    dims that shard the vocab.  DTensor's own gather (and its backward's
    scatter) would replicate the whole vocab of logits on every rank."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh, last = logits.device_mesh, logits.ndim - 1
    _, offsets = compute_local_shape_and_global_offset(logits.shape, mesh, logits.placements)
    start = offsets[last]
    by_vocab = [isinstance(p, Shard) and p.dim == last for p in logits.placements]
    batch = [isinstance(p, Shard) and p.dim == 0 for p in logits.placements]
    out = tuple(Partial() if v else Shard(0) if b else Replicate()
                for v, b in zip(by_vocab, batch))
    lab = tuple(Shard(0) if b else Replicate() for b in batch)

    def pick(x, lbl):
        idx = lbl.to(torch.int64) - start
        inside = (idx >= 0) & (idx < x.shape[-1])
        got = torch.gather(x, -1, idx.clamp(0, x.shape[-1] - 1)[..., None])[..., 0]
        return torch.where(inside, got, 0.0)

    return local_map(pick, out_placements=(out,), in_placements=(logits.placements, lab),
                     redistribute_inputs=True, device_mesh=mesh)(logits, labels)


def loss_fn(cfg: ModelConfig, params: Params, batch: Mapping[str, torch.Tensor]):
    """The masked mean of -log_softmax at the labels: (loss, {"loss",
    "tokens"}).  ``batch`` adds 'labels' (B, S) and optionally
    'loss_mask' (B, S) to ``forward``'s inputs.  A padded batch
    (``_row_pad``) keeps its pad: the mask leaves the padded rows out of
    the sum and of its normaliser."""
    rp = _row_pad(batch)
    batch = _padded(batch, rp)
    logits = _forward(cfg, params, batch, False, rp)
    labels = batch["labels"].to(torch.int64)
    if _vocab_sharded(logits):
        # DTensor replicates a log_softmax over a sharded dim (a whole
        # vocab of logits on every rank): the log-likelihood from
        # reductions DTensor keeps partial, and a gather it masks by shard
        shifted = logits - logits.detach().amax(-1, keepdim=True)
        lse = torch.log(torch.exp(shifted).sum(-1))
        ll = _label_logit(shifted, labels) - lse
    else:
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    mask = batch.get("loss_mask")
    mask = torch.ones_like(ll) if mask is None else mask.to(ll.dtype)
    loss = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, {"loss": loss, "tokens": mask.sum()}


def prefill(cfg: ModelConfig, params: Params, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Prefill: run the stack over the prompt and emit logits for the
    LAST position only, (B, V) in f32."""
    rp = _row_pad(batch)
    h = _forward(cfg, params, _padded(batch, rp), True, rp)
    logits = torch.einsum("bd,dv->bv", h[:, -1, :], params["lm_head"].to(cdtype(cfg)))
    return _unpad_rows(logits.to(torch.float32), rp)


# ----------------------------------------------------------------------
# decode state and step
# ----------------------------------------------------------------------
def init_decode_state(
    cfg: ModelConfig,
    batch_size: int,
    max_len: int,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict:
    """Zero caches and recurrent state, stacked over layers as in the JAX
    package; ``pos`` is a host int."""
    dev = resolve_device(device)
    dt = cdtype(cfg)
    L, D = cfg.n_layers, cfg.d_model
    zeros = lambda *shape, dtype=dt: torch.zeros(shape, dtype=dtype, device=dev)
    if cfg.family == "rwkv6":
        H = cfg.n_heads
        hd = D // H
        return {
            "S": zeros(L, batch_size, H, hd, hd, dtype=torch.float32),
            "tm_prev": zeros(L, batch_size, 1, D),
            "cm_prev": zeros(L, batch_size, 1, D),
            "pos": 0,
        }
    kv = (batch_size, max_len, cfg.n_kv_heads, cfg.hd)
    if cfg.family == "mamba_hybrid":
        groups = L // cfg.attn_every
        return {
            "h": zeros(L, batch_size, cfg.ssm_heads or cfg.n_heads, cfg.ssm_head_dim,
                       cfg.ssm_state, dtype=torch.float32),
            "k": zeros(groups, *kv),
            "v": zeros(groups, *kv),
            "pos": 0,
        }
    state = {"k": zeros(L, *kv), "v": zeros(L, *kv), "pos": 0}
    if cfg.cross_attn_every:
        n_cross = L // cfg.cross_attn_every
        img = (batch_size, cfg.n_img_tokens, cfg.n_kv_heads, cfg.hd)
        # as in the JAX package, no function fills these: decode
        # cross-attention reads zeros
        state["xk"] = zeros(n_cross, *img)
        state["xv"] = zeros(n_cross, *img)
        # self-attn cache excludes cross layers
        state["k"] = zeros(L - n_cross, *kv)
        state["v"] = zeros(L - n_cross, *kv)
    return state


def decode_step(
    cfg: ModelConfig,
    params: Params,
    state: Dict,
    batch: Mapping[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict]:
    """batch: {'tokens' (B,1) | 'embeddings' (B,1,D)} [+ 'kv_start' (B,)].
    Returns (logits (B, V) f32, new state).  The state's tensors are
    updated in place and shared with the new state, whose ``pos`` is one
    more.  As in the JAX package, only the dense and MoE stacks read
    ``kv_start``: a refilled RWKV6, Mamba2-hybrid or cross-attention slot
    keeps the previous occupant's state and cache prefix."""
    dt = cdtype(cfg)
    x = residual(_inputs(cfg, params, batch))
    # a host int, or a 0-d tensor that no host reads (the sharded dry run)
    pos = state["pos"] if isinstance(state["pos"], torch.Tensor) else int(state["pos"])
    blocks = params["blocks"]
    if cfg.family == "rwkv6":
        for i, bp in enumerate(blocks):
            S_i = state["S"][i]  # the WKV kernel writes the new state over it
            x, ns = rwkv.rwkv_block(
                bp, cfg, x,
                state={"S": S_i, "tm_prev": state["tm_prev"][i],
                       "cm_prev": state["cm_prev"][i]},
                S_out=S_i,
            )
            for name in ("tm_prev", "cm_prev"):
                state[name][i].copy_(ns[name])
            x = residual(x)
    elif cfg.family == "mamba_hybrid":
        sp = params["shared_attn"]
        for i, bp in enumerate(blocks):
            x, h = mamba.mamba_block(bp, cfg, x, state=state["h"][i])
            x = residual(x)
            state["h"][i].copy_(h)
            if (i + 1) % cfg.attn_every == 0:
                g = i // cfg.attn_every
                h, _, _ = layers.decode_attention(
                    sp["attn"], cfg, layers.rms_norm(x, sp["norm1"], cfg.norm_eps),
                    state["k"][g], state["v"][g], pos,
                )
                x = x + h
                x = residual(
                    x + layers.mlp(sp["mlp"], cfg, layers.rms_norm(x, sp["norm2"], cfg.norm_eps)))
    elif cfg.cross_attn_every:
        per = cfg.cross_attn_every - 1
        for g, cp in enumerate(params["cross_blocks"]):
            for i in range(g * per, (g + 1) * per):
                bp = blocks[i]
                h, _, _ = layers.decode_attention(
                    bp["attn"], cfg, layers.rms_norm(x, bp["norm1"], cfg.norm_eps),
                    state["k"][i], state["v"][i], pos,
                )
                x = x + h
                x = residual(
                    x + layers.mlp(bp["mlp"], cfg, layers.rms_norm(x, bp["norm2"], cfg.norm_eps)))
            h, _, _ = layers.decode_attention(
                cp["attn"], cfg, layers.rms_norm(x, cp["norm1"], cfg.norm_eps),
                state["xk"][g], state["xv"][g], pos, rope=False, update_cache=False,
                kv_len=cfg.n_img_tokens, gated=True,
            )
            x = x + h
            x = residual(
                x + layers.mlp(cp["mlp"], cfg, layers.rms_norm(x, cp["norm2"], cfg.norm_eps)))
    else:
        # the FFN is chosen once a step, not looked up in every layer
        ffn, ffn_name = (layers.moe_ffn, "moe") if cfg.moe else (layers.mlp, "mlp")
        kv_start = batch.get("kv_start")
        for i, bp in enumerate(blocks):
            h, _, _ = layers.decode_attention(
                bp["attn"], cfg, layers.rms_norm(x, bp["norm1"], cfg.norm_eps),
                state["k"][i], state["v"][i], pos, kv_start=kv_start,
            )
            x = x + h
            x = residual(x + ffn(bp[ffn_name], cfg, layers.rms_norm(x, bp["norm2"], cfg.norm_eps)))
    new_state = dict(state)
    new_state["pos"] = pos + 1
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"].to(dt))
    return logits[:, 0].to(torch.float32), new_state
