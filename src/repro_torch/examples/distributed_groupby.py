"""Distributed relational ops: hash-repartitioned group-by and
broadcast semi-join over a data-parallel process group.

    PYTHONPATH=src python -m repro_torch.examples.distributed_groupby [--world N] [--device cpu]

``--world 1`` (the default) runs in this process on a one-rank group
(``dframe.init_local``: NCCL on the card, gloo on the CPU).  ``--world
N`` with N > 1 starts N gloo ranks on the CPU, joined through a file
store in a temporary directory; rank 0 prints.  Every rank holds the
global inputs and works on its block of rows, as each device of the
JAX package's mesh does.  On the card the group-by's shard-local sums
run the segment-sum kernel (K1).  The group is torn down at exit.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from datetime import timedelta
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import resolve_device
from repro_torch.dist.dframe import (
    DataMesh, data_mesh, dist_groupby_sum, dist_repartition_by_key, dist_semi_join_mask,
    init_local,
)

N, DOMAIN = 1 << 16, 256
#: the bound on each collective of the ranks
TIMEOUT = timedelta(seconds=60)


def run(mesh: DataMesh, device=None) -> Dict:
    """The script's three ops on ``mesh`` over tensors on ``device``
    (default ``CONFIG.device``): ``{"lines": what the script prints,
    "sums", "max_err", "matched", "expected_matched", "preserved",
    "dropped"}``, the same on every rank."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    n, domain = N, DOMAIN
    keys_np = rng.integers(0, domain, n).astype(np.int32)
    vals_np = rng.normal(size=n).astype(np.float32)
    keys = torch.as_tensor(keys_np, device=dev)
    vals = torch.as_tensor(vals_np, device=dev)

    sums = dist_groupby_sum(mesh, keys, vals, domain).cpu().numpy()
    check = np.zeros(domain, np.float32)
    np.add.at(check, keys_np, vals_np)
    err = float(np.abs(sums - check).max())
    lines = [f"dist group-by sum over {mesh.shape}: n={n} domain={domain} max_err={err:.2e}"]

    build_np = rng.choice(np.arange(1024), 128, replace=False).astype(np.int32)
    probe_np = rng.integers(0, 1024, n).astype(np.int32)
    mask = dist_semi_join_mask(mesh, torch.as_tensor(probe_np, device=dev),
                               torch.as_tensor(build_np, device=dev))
    matched = int(mask.sum())
    lines.append(f"broadcast semi-join: {matched} of {n} rows matched")

    _, _, valid, dropped = dist_repartition_by_key(mesh, keys, vals, capacity=n)
    preserved, dropped = int(valid.sum()), int(dropped)
    lines.append(f"full shuffle: rows preserved={preserved}/{n} dropped={dropped}")
    return {"lines": lines, "sums": sums, "max_err": err, "matched": matched,
            "expected_matched": int(np.isin(probe_np, build_np).sum()),
            "preserved": preserved, "dropped": dropped}


def _rank(rank: int, world: int, store_dir: str) -> None:
    """One gloo rank of a world of ``world`` on the CPU."""
    # gloo binds to the loopback device: the address the host name
    # resolves to may not be reachable
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        out = run(data_mesh(), "cpu")
        if rank == 0:
            print("\n".join(out["lines"]), flush=True)
    finally:
        dist.destroy_process_group()


def main(argv: Optional[List[str]] = None) -> Optional[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=1,
                    help="ranks: 1 in this process, more as gloo processes on the CPU")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu at --world 1; the ranks of a larger world "
                         "run on the CPU")
    args = ap.parse_args(argv)
    if args.world > 1:
        import torch.multiprocessing as mp

        with tempfile.TemporaryDirectory() as store_dir:
            mp.start_processes(_rank, args=(args.world, store_dir), nprocs=args.world,
                               join=True, start_method="spawn")
        return None
    dev = resolve_device(args.device)
    mesh = init_local(dev, timeout=TIMEOUT)
    try:
        out = run(mesh, dev)
    finally:
        dist.destroy_process_group()
    print("\n".join(out["lines"]))
    return out


if __name__ == "__main__":
    main()
