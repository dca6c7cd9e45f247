"""Checkpoints of a train state (``repro/train/checkpoint.py``).

Layout, as the JAX package's: one directory per step, ``step_%08d``, with
a JSON manifest (key, shape and dtype of every leaf) and one ``.npy`` per
leaf, written to ``.tmp-<step>`` and renamed, so a preemption during a
save never corrupts the latest checkpoint.  A leaf's key is its path in
the state, ``/``-joined (``params/blocks/0/attn/wq``); bfloat16 leaves
are stored as their int16 bits (numpy has no bfloat16) and the manifest
says ``bfloat16``.  Python ints (the step counts) are 0-d int64 arrays.

``restore(..., device=)`` loads leaves on the host and moves them to
``device`` (else to the device of the matching leaf of ``like``), so a
checkpoint written on the card restores on the CPU, and the other way
round.  ``restore(..., shardings=)``, as the JAX package's, places each
leaf by its ``models.partition.NamedSharding`` on the CURRENT mesh as a
DTensor: elastic resharding, so a checkpoint written on one rank
restores onto any mesh.  A ``Params`` takes its shardings keyed by
parameter name, as ``partition.param_specs`` gives its specs.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from ..models import lm, partition


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, lm.Params):
        tree = lm.tree_from_names(dict(tree.named_parameters()))
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, val in items:
        out.update(_flatten(val, f"{prefix}/{key}" if prefix else str(key)))
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    return np.asarray(leaf, dtype=np.int64 if isinstance(leaf, int) else None)


def save(state: Any, directory: str, step: int) -> str:
    tmp = os.path.join(directory, f".tmp-{step}")
    final = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for key, leaf in _flatten(state).items():
        arr = _to_numpy(leaf)
        fname = re.sub(r"[^\w\-]", "_", key) + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        manifest["leaves"][key] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": "bfloat16" if bf16 else str(arr.dtype),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory) if d.startswith("step_")]
    return max(steps) if steps else None


def restore(
    directory: str,
    like: Any,
    step: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
    shardings: Any = None,
) -> Any:
    """A new state with the structure, dtypes and trainability of ``like``
    and the values of checkpoint ``step`` (the latest when None), on
    ``device`` or, where that is None, on each leaf's device in ``like``;
    where ``shardings`` (a tree like ``like``'s of ``NamedSharding``) is
    given, each tensor leaf is a DTensor placed by its sharding."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    def load(key: str, leaf, sharding):
        entry = manifest["leaves"][key]
        arr = np.load(os.path.join(d, entry["file"]))
        if isinstance(leaf, torch.Tensor):
            if list(arr.shape) != list(leaf.shape):
                raise ValueError(f"checkpoint leaf {key}: shape {arr.shape}, wants "
                                 f"{tuple(leaf.shape)}")
            t = torch.from_numpy(arr)
            if entry["dtype"] == "bfloat16":
                t = t.view(torch.bfloat16)
            if sharding is not None:
                return partition.distribute(t.to(leaf.dtype), sharding)
            return t.to(device=leaf.device if device is None else device, dtype=leaf.dtype)
        return type(leaf)(arr)

    def rebuild(tree: Any, prefix: str, sh: Any) -> Any:
        if isinstance(tree, lm.Params):
            named = lm.tree_from_names(dict(tree.named_parameters()))
            out = lm.Params(rebuild(named, prefix, None if sh is None else lm.tree_from_names(sh)))
            return out.requires_grad_(any(p.requires_grad for p in tree.parameters()))
        if isinstance(tree, Mapping):
            return {k: rebuild(v, f"{prefix}/{k}" if prefix else str(k),
                               None if sh is None else sh[k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, f"{prefix}/{i}" if prefix else str(i),
                                      None if sh is None else sh[i])
                              for i, v in enumerate(tree))
        return load(prefix, tree, sh)

    return rebuild(like, "", shardings)


def prune(directory: str, keep: int = 3) -> None:
    if not os.path.isdir(directory):
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(directory) if d.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)
