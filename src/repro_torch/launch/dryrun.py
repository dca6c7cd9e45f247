"""The multi-pod dry run (``repro/launch/dryrun.py``) on the torch step.

For every (architecture x input shape x mesh) cell, the train, prefill or
decode step runs once on a production mesh of 256 or 512 ranks over a
``"fake"`` process group, its weights, optimizer state, decode state and
batch DTensors placed by ``partition.param_specs``,
``optimizer.state_specs``, ``partition.decode_state_specs`` and
``partition.batch_specs``, every tensor a meta tensor (one rank's
shards, no data, no allocation).  ``hlo_analysis.analyze`` counts what
that rank runs: FLOPs, bytes, collective bytes by kind, peak memory.  A
cell writes a JSON artifact with the reference's fields, but:

- ``trace_s`` (the traced step's wall time) replaces ``lower_s`` and
  ``compile_s``;
- the default output directory is ``artifacts/dryrun_torch``, which
  ``benchmarks/bench_roofline.py`` (reading the reference's
  ``artifacts/dryrun``) never reads;
- the roofline uses an H100 SXM5 80 GB (700 W) instead of the TPU's
  constants, each with its source below;
- the collective term is per device: each collective's operand bytes
  over the bandwidth of the link its mesh axis crosses (NVLink where the
  axis's ranks share a node of 8, the inter-node link otherwise),
  summed.  The reference divides the per-device total by every chip
  (``coll_total / (chips * ICI_BW)``), which makes the term shrink with
  the mesh while each device's traffic does not.

``run_cell(..., mesh=)`` predicts a cell on a mesh the caller already
has (a real process group): the inputs are still meta tensors, so
nothing is allocated and nothing is sent.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--out DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..configs import ARCHS, get
from ..models import lm, partition
from ..train.optimizer import get_optimizer
from ..train.train_step import make_train_step
from . import hlo_analysis
from .mesh import make_production_mesh
from .shapes import SHAPES, ShapeSpec, cell_applicable, input_specs, param_shapes

# H100 SXM5 80 GB at 700 W, NVIDIA H100 Tensor Core GPU datasheet
PEAK_FLOPS = 989e12  # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12  # HBM3 bytes/s
NVLINK_BW = 450e9  # NVLink 4 bytes/s a direction (900 GB/s both ways), within a node of 8
NET_BW = 50e9  # bytes/s a direction: one 400 Gb/s ConnectX-7 NIC per GPU (DGX H100), between nodes
NODE = 8  # GPUs a node
HBM_PER_CHIP = 80 * 1024**3  # 80 GB HBM3


def _fake_world(ranks: int) -> None:
    """A ``"fake"`` default process group of ``ranks`` ranks (this rank 0),
    replacing a fake group of another size."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == ranks:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is up: pass its mesh as mesh=")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=ranks)


def place(t: torch.Tensor, mesh: DeviceMesh, spec: partition.P) -> DTensor:
    """A meta DTensor of ``t``'s global shape and dtype placed by ``spec``:
    this rank's shard, without data."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    placements = partition.NamedSharding(mesh, spec).placements
    local_shape, _ = compute_local_shape_and_global_offset(t.shape, mesh, placements)
    local = torch.empty(local_shape, dtype=t.dtype, device="meta")
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=t.shape,
                              stride=torch.empty(t.shape, device="meta").stride())


def place_tree(tree: Any, mesh: DeviceMesh, specs: Any) -> Any:
    if isinstance(tree, lm.Params):
        named = {name: place(p, mesh, specs[name]) for name, p in tree.named_parameters()}
        return lm.Params(lm.tree_from_names(named))
    if isinstance(tree, dict):
        return {k: place_tree(v, mesh, specs[k]) for k, v in tree.items()}
    return place(tree, mesh, specs) if isinstance(tree, torch.Tensor) else tree


def _mesh_name(multi_pod: bool, mesh: Optional[DeviceMesh]) -> str:
    if mesh is not None:
        return "x".join(str(s) for s in mesh.mesh.shape)
    return "2x16x16" if multi_pod else "16x16"


def _link_bw(mesh: DeviceMesh) -> Dict[str, float]:
    """Group name -> the bandwidth of the link each mesh dim's collectives
    cross: NVLink where the dim's ranks lie in one node of ``NODE``."""
    out = {}
    strides = [int(s) for s in mesh.mesh.stride()]
    for i in range(mesh.ndim):
        span = strides[i] * (mesh.size(i) - 1) + 1
        out[mesh.get_group(i).group_name] = NVLINK_BW if span <= NODE else NET_BW
    return out


def run_cell(arch: str, shape, multi_pod: bool, extra: Dict[str, Any] | None = None,
             mesh: Optional[DeviceMesh] = None) -> Dict[str, Any]:
    """One cell: ``shape`` names one of ``SHAPES`` or is a ``ShapeSpec`` of
    the caller's (a batch a mesh of its own can hold); ``extra`` overrides
    fields of the architecture's config; ``mesh``, where given, is the
    caller's mesh (else the production mesh over a fake group)."""
    cfg = get(arch)
    if extra:
        cfg = dataclasses.replace(cfg, **extra)
    sp = shape if isinstance(shape, ShapeSpec) else SHAPES[shape]
    shape = sp.name
    ok, why = cell_applicable(cfg, shape)
    cell = {"arch": arch, "shape": shape, "mesh": _mesh_name(multi_pod, mesh),
            "chips": 512 if multi_pod else 256}
    if mesh is not None:
        cell["chips"] = mesh.size()
    if not ok:
        cell.update({"status": "skipped", "reason": why})
        return cell

    if mesh is None:
        _fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cuda")
    chips = mesh.size()
    specs = input_specs(cfg, sp)
    kind = specs["kind"]
    t0 = time.time()

    params_meta = {"train": lambda: specs["state"]["params"], "prefill": lambda: specs["state"],
                   "decode": lambda: param_shapes(cfg)}[kind]()
    pspecs = partition.param_specs(params_meta, cfg)
    batch = place_tree(specs["batch"], mesh, partition.batch_specs(mesh, specs["batch"]))
    if kind == "train":
        opt = get_optimizer(cfg.optimizer)
        state_specs = {"params": pspecs, "opt": opt.state_specs(pspecs, params_meta),
                       "step": partition.P()}
        state = place_tree(specs["state"], mesh, state_specs)
        state["params"].requires_grad_(True)
        step = make_train_step(cfg)
        args = (state, batch)
        run = lambda: step(state, batch)
    elif kind == "prefill":
        params = place_tree(specs["state"], mesh, pspecs)
        args = (params, batch)
        run = lambda: lm.prefill(cfg, params, batch)
    else:
        params = place_tree(params_meta, mesh, pspecs)
        dstate = place_tree(specs["state"], mesh,
                            partition.decode_state_specs(mesh, specs["state"]))
        args = (params, dstate, batch)
        run = lambda: lm.decode_step(cfg, params, dstate, batch)

    with implicit_replication():
        out, ha = hlo_analysis.analyze(run, args)
    t_trace = time.time() - t0

    argument_bytes = hlo_analysis.tree_bytes(args)
    inputs = {t.untyped_storage()._cdata for t in hlo_analysis.local_tensors(args)}
    output_bytes = sum(t.numel() * t.element_size() for t in hlo_analysis.local_tensors(out)
                       if t.untyped_storage()._cdata not in inputs)
    coll = ha["collectives"]
    coll_total = int(ha["coll_total"])
    bw = _link_bw(mesh)
    collective_t = sum(b / bw.get(group, NET_BW) for (_, group), b in ha["by_group"].items())

    # every operation's counts hold the products' (the reference takes the
    # larger of two independent estimates)
    flops_per_device = float(ha["flops"])
    bytes_per_device = float(ha["op_bytes"])
    tokens = sp.global_batch * (sp.seq_len if kind != "decode" else 1)
    n_par = cfg.param_count()
    n_act = cfg.active_param_count()
    model_flops = (6 if kind == "train" else 2) * n_act * tokens

    compute_t = flops_per_device / PEAK_FLOPS
    memory_t = bytes_per_device / HBM_BW
    peak = int(ha["peak_bytes"])
    cell.update(
        {
            "status": "ok",
            "kind": kind,
            "trace_s": round(t_trace, 2),
            "flops_per_device": flops_per_device,
            "bytes_per_device": bytes_per_device,
            "collective_bytes_total": coll_total,
            "collectives": coll,
            "cost_analysis_flops": float(ha["aten_flops"] + ha["kernel_flops"]),
            "dot_flops_trip_weighted": float(ha["dot_flops"]),
            "giant_intermediate_bytes": float(ha["giant_bytes"]),
            "memory_s_fused_kernels": max(
                0.0, (bytes_per_device - float(ha["giant_bytes"])) / HBM_BW),
            "memory": {
                "argument_bytes": argument_bytes,
                "output_bytes": output_bytes,
                "temp_bytes": max(0, peak - argument_bytes - output_bytes),
                "peak_bytes": peak,
            },
            "fits_hbm": peak <= HBM_PER_CHIP,
            "kernels": ha["kernels"],
            "tokens": tokens,
            "params": n_par,
            "active_params": n_act,
            "model_flops": model_flops,
            "roofline": {
                "compute_s": compute_t,
                "memory_s": memory_t,
                "collective_s": collective_t,
                "dominant": max(
                    [("compute", compute_t), ("memory", memory_t), ("collective", collective_t)],
                    key=lambda kv: kv[1],
                )[0],
                "useful_flops_ratio": (
                    model_flops / (flops_per_device * chips) if flops_per_device else None
                ),
            },
        }
    )
    return cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--override", default="", help="k=v,... ModelConfig overrides")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    # DTensor warns of every redistribution it finds suboptimal, and of the
    # fake group's missing all-to-all: the counts say what they cost
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)

    extra: Dict[str, Any] = {}
    for kv in filter(None, args.override.split(",")):
        k, v = kv.split("=")
        try:
            extra[k] = int(v)
        except ValueError:
            try:
                extra[k] = float(v)
            except ValueError:
                extra[k] = v

    cells = []
    if args.all:
        targets = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        targets = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    t_start = time.time()
    for arch, shape in targets:
        for mp in meshes:
            name = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
            if args.tag:
                name += f"__{args.tag}"
            path = os.path.join(args.out, name + ".json")
            try:
                cell = run_cell(arch, shape, mp, extra or None)
            except Exception as e:  # noqa: BLE001
                cell = {
                    "arch": arch, "shape": shape,
                    "mesh": "2x16x16" if mp else "16x16",
                    "status": "error",
                    "error": f"{type(e).__name__}: {e}",
                    "trace": traceback.format_exc()[-4000:],
                }
            with open(path, "w") as f:
                json.dump(cell, f, indent=1)
            cells.append(cell)
            st = cell["status"]
            ro = cell.get("roofline", {})
            print(
                f"[{st:7s}] {name} "
                f"trace={cell.get('trace_s', '-')}s "
                f"dominant={ro.get('dominant', '-')} "
                f"mem_peak={cell.get('memory', {}).get('peak_bytes', '-')}",
                flush=True,
            )
    bad = [c for c in cells if c["status"] == "error"]
    print(f"done: {len(cells)} cells, {len(bad)} errors in {time.time() - t_start:.1f} s")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
