"""The assigned input-shape set and per-(arch, shape) input specs
(``repro/launch/shapes.py``).

Inputs and states are meta tensors (``device="meta"`` by default): the
shapes and dtypes of the reference's ``ShapeDtypeStruct``s and no
allocation.  Per-block weights are in the port's layout, one weight per
block (``models/partition.py``), and so are the optimizer's moments
(adafactor stacks each group of per-block weights, as the reference
does).  The step counters (``step`` of the train state and of the
optimizer) and the decode position are 0-d int32 tensors, as in the
reference.  ``long_500k`` applies only to sub-quadratic architectures
(rwkv6, zamba2); the skip is recorded per cell.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_map, tree_map_only

from ..models import lm
from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch: 500k decode requires sub-quadratic state (skip per assignment)"
    return True, ""


def sds(shape, dtype, device="meta") -> torch.Tensor:
    """A tensor of this shape and dtype without data."""
    return torch.empty(tuple(shape), dtype=getattr(torch, str(dtype)), device=device)


def batch_specs_for(cfg: ModelConfig, sp: ShapeSpec, device="meta") -> Dict[str, Any]:
    """The step function's batch argument."""
    B, S = sp.global_batch, sp.seq_len
    S_in = 1 if sp.kind == "decode" else S
    batch: Dict[str, Any] = {}
    if cfg.embed_inputs:
        batch["tokens"] = sds((B, S_in), "int32", device)
    else:
        batch["embeddings"] = sds((B, S_in, cfg.d_model), cfg.compute_dtype, device)
    if cfg.cross_attn_every:
        batch["img_embed"] = sds((B, cfg.n_img_tokens, cfg.d_model), cfg.compute_dtype, device)
    if sp.kind == "train":
        batch["labels"] = sds((B, S_in), "int32", device)
    return batch


def _without_data(build, device):
    """``build()``'s tensors traced on fake CPU tensors (no allocation, not
    even of a 32k cache), as tensors without data on ``device``."""
    with FakeTensorMode():
        tree = build()
    return tree_map_only(torch.Tensor, lambda t: sds(t.shape, str(t.dtype)[6:], device), tree)


@functools.lru_cache(maxsize=16)
def _param_tree(cfg: ModelConfig):
    """The weights' tree of (shape, dtype), traced once per configuration.
    On fake tensors each weight is drawn in one slice (``layers.normal``
    slices a draw only to bound host memory, which fake tensors do not
    take)."""
    from ..models import layers

    saved, layers.SLICE_ELEMS = layers.SLICE_ELEMS, 1 << 62
    try:
        tree = _without_data(
            lambda: lm._init_tree(cfg, torch.Generator("cpu").manual_seed(0)), "meta")
    finally:
        layers.SLICE_ELEMS = saved
    return tree_map_only(torch.Tensor, lambda t: (tuple(t.shape), str(t.dtype)[6:]), tree)


def param_shapes(cfg: ModelConfig, device="meta") -> lm.Params:
    """The model's weights (a frozen ``Params``) without data."""
    return lm.Params(tree_map(lambda leaf: sds(*leaf, device), _param_tree(cfg),
                              is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
                              and isinstance(x[1], str)))


def state_shapes_for(cfg: ModelConfig, sp: ShapeSpec, device="meta"):
    """The train state, the decode state, or (prefill) the weights."""
    if sp.kind == "train":
        from ..train.train_step import init_train_state

        state = init_train_state(cfg, params=param_shapes(cfg, device))
        state["opt"]["step"] = sds((), "int32", device)
        state["step"] = sds((), "int32", device)
        return state
    if sp.kind == "decode":
        state = _without_data(
            lambda: lm.init_decode_state(cfg, sp.global_batch, sp.seq_len, device="cpu"), device)
        state["pos"] = sds((), "int32", device)
        return state
    return param_shapes(cfg, device)


def input_specs(cfg: ModelConfig, shape_name, device="meta") -> Dict[str, Any]:
    """The cell's state, batch and kind; ``shape_name`` names one of
    ``SHAPES`` or is a ``ShapeSpec`` of its own."""
    sp = shape_name if isinstance(shape_name, ShapeSpec) else SHAPES[shape_name]
    return {
        "state": state_shapes_for(cfg, sp, device),
        "batch": batch_specs_for(cfg, sp, device),
        "kind": sp.kind,
    }
