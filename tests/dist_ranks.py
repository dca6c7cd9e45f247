"""Child processes of the multi-rank tests of ``repro_torch.dist`` and
``repro_torch.models.partition`` (tests/test_torch_dist.py,
tests/test_torch_partition.py), and the seeded inputs both packages get.

    python tests/dist_ranks.py ops|reshard RANK WORLD WORKDIR
    python tests/dist_ranks.py jax WORKDIR

``ops`` and ``reshard`` run one gloo rank of a world of WORLD, joined
through a ``FileStore`` in WORKDIR (no port), and write the rank's
outputs to ``WORKDIR/<scenario>-<rank>.pkl``; ``jax`` computes the JAX
package's ops on as many forced host devices as ``XLA_FLAGS`` gives it
and writes ``WORKDIR/jax.npz``.  The file is not named ``test_*``, so
pytest does not collect it.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TPCH_SF = 0.002
#: routed TPC-H queries: group sums everywhere; semi joins in q4, q18,
#: q21; anti joins in q16, q21, q22
TPCH_QUERIES = ("q1", "q4", "q13", "q16", "q18", "q21", "q22")
PIPE_LAYERS, PIPE_D = 8, 16


def inputs() -> dict:
    """The seeded inputs of every op, the same for both packages."""
    rng = np.random.default_rng(20)
    n, domain = 4093, 37  # n not a multiple of the world: the last block is padded
    out = {
        "domain": domain,
        "gkeys": rng.integers(-1, domain, n).astype(np.int64),
        "gvals": rng.normal(size=n).astype(np.float32),
        "gvals_int": rng.integers(-1000, 1000, n).astype(np.int64),
        "probe": rng.integers(-1, 100, n).astype(np.int64),
        "build": rng.choice(100, 64, replace=False).astype(np.int64),
        "skew_keys": np.full(500, 7, dtype=np.int64),  # every row to one rank
        "skew_vals": np.arange(500, dtype=np.float32),
        "over_keys": rng.integers(0, 5, 1000).astype(np.int64),
        "over_vals": rng.normal(size=1000).astype(np.float32),
        "over_capacity": 400,
        "pipe_w": (rng.normal(size=(PIPE_LAYERS, PIPE_D, PIPE_D)) * 0.3).astype(np.float32),
        "pipe_x": rng.normal(size=(6, 4, PIPE_D)).astype(np.float32),
        "grads": rng.normal(size=(WORLD, 1024)).astype(np.float32),
    }
    return out


# ----------------------------------------------------------------------
# the JAX package, on forced host devices
# ----------------------------------------------------------------------
def run_jax(workdir: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as JP

    jax.config.update("jax_enable_x64", True)
    from repro.dist import compression, dframe, pipeline

    ndev = jax.device_count()
    mesh = jax.make_mesh((ndev,), ("data",))
    x = inputs()
    out = {}
    gsum = jax.jit(lambda k, v: dframe.dist_groupby_sum(mesh, k, v, x["domain"]))
    out["gsum"] = gsum(x["gkeys"], x["gvals"])
    out["gsum_int"] = gsum(x["gkeys"], x["gvals_int"])
    # the reference cannot slice a padded shard_map output under this jax
    # (the [:n] gather of a sharded array); it is given the probe padded
    # with null keys, which its own padding would add, and cut here
    n = x["probe"].shape[0]
    padded = np.concatenate([x["probe"], np.full((-n) % ndev, -1, np.int64)])
    out["mask"] = np.asarray(jax.jit(lambda p, b: dframe.dist_semi_join_mask(mesh, p, b))(
        padded, x["build"]))[:n]
    for case, (k, v, cap) in {
        "lossless": (x["gkeys"], x["gvals"], x["gkeys"].shape[0]),
        "skew": (x["skew_keys"], x["skew_vals"], x["skew_keys"].shape[0]),
        "overflow": (x["over_keys"], x["over_vals"], x["over_capacity"]),
    }.items():
        fn = jax.jit(lambda k, v, cap=cap: dframe.dist_repartition_by_key(mesh, k, v, capacity=cap))
        for name, val in zip(("keys2", "vals2", "valid", "dropped"), fn(k, v)):
            out[f"{case}_{name}"] = val
    pmesh = jax.make_mesh((ndev,), ("pipe",))
    out["pipe"] = jax.jit(lambda w, h: pipeline.pipeline_forward(
        pmesh, lambda wl, hl: jnp.tanh(hl @ wl), w, h, n_layers=PIPE_LAYERS))(
        x["pipe_w"], x["pipe_x"])

    def cmean(gl):
        mean, resid = compression.compressed_mean(gl[0], "data")
        return mean[None], resid[None]

    mean, resid = jax.jit(shard_map(cmean, mesh=mesh, in_specs=(JP("data"),),
                                    out_specs=(JP("data"), JP("data")), check_rep=False))(
        x["grads"])
    out["cmean"], out["cresid"] = mean, resid
    np.savez(os.path.join(workdir, "jax.npz"), **{k: np.asarray(v) for k, v in out.items()})


# ----------------------------------------------------------------------
# one gloo rank of the port
# ----------------------------------------------------------------------
def _join(rank: int, world: int, workdir: str):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    return torch, dist


def _as_numpy(res) -> dict:
    res = res if isinstance(res, dict) else res.to_dict()
    return {k: np.asarray(v) for k, v in res.items()}


def run_ops(rank: int, world: int, workdir: str) -> dict:
    torch, dist = _join(rank, world, workdir)
    from repro_torch.core.config import CONFIG
    from repro_torch.data import tpch
    from repro_torch.dist import compression, dframe, pipeline
    from repro_torch.queries import tpch_frames as QF

    x = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in inputs().items()}
    mesh = dframe.data_mesh()
    out = {"rank": mesh.rank, "world": mesh.size}
    out["gsum"] = dframe.dist_groupby_sum(mesh, x["gkeys"], x["gvals"], x["domain"])
    out["gsum_int"] = dframe.dist_groupby_sum(mesh, x["gkeys"], x["gvals_int"], x["domain"])
    out["mask"] = dframe.dist_semi_join_mask(mesh, x["probe"], x["build"])
    for case, (k, v, cap) in {
        "lossless": (x["gkeys"], x["gvals"], x["gkeys"].shape[0]),
        "skew": (x["skew_keys"], x["skew_vals"], x["skew_keys"].shape[0]),
        "overflow": (x["over_keys"], x["over_vals"], x["over_capacity"]),
    }.items():
        for name, val in zip(("keys2", "vals2", "valid", "dropped"),
                             dframe.dist_repartition_by_key(mesh, k, v, capacity=cap)):
            out[f"{case}_{name}"] = val
    # the lossless case again from store-like chunks of unequal lengths
    cuts = [0, 1000, 1001, 3000, x["gkeys"].shape[0]]
    chunks = lambda t: [t.numpy()[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    for name, val in zip(("keys2", "vals2", "valid", "dropped"), dframe.dist_repartition_by_key(
            mesh, chunks(x["gkeys"]), chunks(x["gvals"]), capacity=x["gkeys"].shape[0],
            device="cpu")):
        out[f"chunks_{name}"] = val
    # the shard-local functions alone: this rank's part
    out["gsum_shard"] = dframe.groupby_sum_shard(x["gkeys"], x["gvals"], x["domain"],
                                                 mesh.rank, world)
    out["mask_shard"] = dframe.semi_join_shard(x["probe"], x["build"], mesh.rank, world)
    out["lossless_send"] = dframe.repartition_shard(x["gkeys"], x["gvals"],
                                                    x["gkeys"].shape[0], mesh.rank, world)
    block = lambda w, h: torch.tanh(h @ w)
    pmesh = dframe.data_mesh(axis="pipe")
    out["pipe"] = pipeline.pipeline_forward(pmesh, block, x["pipe_w"], x["pipe_x"],
                                            n_layers=PIPE_LAYERS)
    try:
        pipeline.pipeline_forward(pmesh, block, x["pipe_w"][:6], x["pipe_x"], n_layers=6)
    except ValueError as e:
        out["pipe_error"] = str(e)
    out["cmean"], out["cresid"] = compression.compressed_mean(x["grads"][mesh.rank], mesh)
    # a two-rank subgroup: every rank makes it, only its ranks use it
    try:
        sub = dframe.data_mesh(2)
        out["sub_gsum"] = dframe.dist_groupby_sum(sub, x["gkeys"], x["gvals"], x["domain"])
    except ValueError as e:
        out["sub_error"] = str(e)
    dist.barrier()

    # the engine routed: TPC-H queries under 'force', then 'off'
    with open(os.path.join(workdir, "tables.pkl"), "rb") as f:
        frames = tpch.as_frames(pickle.load(f), device="cpu")
    dframe.reset_counts()
    routed, local = {}, {}
    CONFIG.distributed = "force"
    for q in TPCH_QUERIES:
        routed[q] = _as_numpy(QF.ALL[q](frames, sf=TPCH_SF, apply_limit=False))
    out["routed_counts"] = dict(dframe.ROUTED)
    out["routed_collectives"] = dict(dframe.COLLECTIVES)
    dframe.reset_counts()
    CONFIG.distributed = "off"
    for q in TPCH_QUERIES:
        local[q] = _as_numpy(QF.ALL[q](frames, sf=TPCH_SF, apply_limit=False))
    CONFIG.distributed = "auto"
    for q in ("q4", "q13"):  # auto routes at dist_min_rows and above only
        QF.ALL[q](frames, sf=TPCH_SF, apply_limit=False)
    out["unrouted_counts"] = dict(dframe.ROUTED)
    out["routed"], out["local"] = routed, local
    dist.destroy_process_group()
    return out


def run_reshard(rank: int, world: int, workdir: str) -> dict:
    torch, dist = _join(rank, world, workdir)
    from repro_torch.configs.registry import get
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import partition
    from repro_torch.models.config import reduced
    from repro_torch.train import checkpoint
    from repro_torch.train.optimizer import get_optimizer
    from repro_torch.train.train_step import init_train_state

    cfg = reduced(get("phi3-mini-3.8b"), n_layers=2)
    mesh = make_host_mesh(2, device_type="cpu")
    like = init_train_state(cfg, torch.Generator("cpu").manual_seed(5), device="cpu")
    pspecs = partition.param_specs(like["params"])
    opt = get_optimizer(cfg.optimizer)
    specs = {"params": pspecs, "opt": opt.state_specs(pspecs, like["params"]),
             "step": partition.P()}
    shardings = partition.shardings_from_specs(mesh, specs)
    state = checkpoint.restore(os.path.join(workdir, "ckpt"), like, shardings=shardings)
    out = {"rank": rank, "coord": tuple(mesh.get_coordinate()), "step": state["step"],
           "mesh": tuple(mesh.mesh.shape), "leaves": {}}
    leaves = {f"params/{n}": p for n, p in state["params"].named_parameters()}
    leaves.update({f"opt/m/{n}": t for n, t in state["opt"]["m"].items()})
    for key, t in leaves.items():
        out["leaves"][key] = {
            "local": t.to_local().detach().numpy().copy(),
            # per mesh dim: the tensor dim it shards, or None (replicated)
            "placements": [p.dim if p.is_shard() else None for p in t.placements],
            "full": t.full_tensor().detach().numpy().copy(),
            "requires_grad": t.requires_grad,
        }
    dist.destroy_process_group()
    return out


# ----------------------------------------------------------------------
# the parent's side
# ----------------------------------------------------------------------
def _spawn(args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               **(env_extra or {}))
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()), *args],
                            env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def run_ranks(scenario: str, workdir: Path, world: int = WORLD, extra=()):
    """Start ``world`` gloo ranks of ``scenario`` (and any ``extra``
    processes, ``(args, env)``), wait for all, fail on any non-zero exit,
    and return each rank's outputs."""
    procs = [_spawn([scenario, str(r), str(world), str(workdir)]) for r in range(world)]
    procs += [_spawn(args, env) for args, env in extra]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    outs = []
    for r in range(world):
        with open(workdir / f"{scenario}-{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _to_numpy(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


def main(argv) -> int:
    if argv[0] == "jax":
        run_jax(argv[1])
        return 0
    scenario, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    out = {"ops": run_ops, "reshard": run_reshard}[scenario](rank, world, workdir)
    with open(os.path.join(workdir, f"{scenario}-{rank}.pkl"), "wb") as f:
        pickle.dump(_to_numpy(out), f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
