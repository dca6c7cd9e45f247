"""Child processes of the multi-rank tests of ``repro_torch.dist``,
``repro_torch.models.partition`` and the model's sharded step
(tests/test_torch_dist.py, tests/test_torch_partition.py,
tests/test_torch_dryrun.py) and of the distributed group-by example
(tests/test_torch_examples.py), and the seeded inputs both packages get.

    python tests/dist_ranks.py ops|reshard|sharded|example RANK WORLD WORKDIR
    python tests/dist_ranks.py jax WORKDIR

``ops``, ``reshard``, ``sharded`` and ``example`` run one gloo rank of a world of WORLD, joined
through a ``FileStore`` in WORKDIR (no port) on the loopback device,
each collective bounded by ``GLOO_TIMEOUT``, and write the rank's
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
import time
from datetime import timedelta
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TPCH_SF = 0.002
#: routed TPC-H queries: group sums everywhere; semi joins in q4, q18,
#: q21; anti joins in q16, q21, q22
TPCH_QUERIES = ("q1", "q4", "q13", "q16", "q18", "q21", "q22")
PIPE_LAYERS, PIPE_D = 8, 16
#: the bound on each gloo collective of these tests, in process and in the
#: child ranks, and on all the child processes of one ``run_ranks`` together
GLOO_TIMEOUT = timedelta(seconds=60)
RANKS_DEADLINE_S = 120
# gloo binds to the loopback device: the address the host name resolves
# to may not be reachable, and a rank that cannot connect would wait out
# its timeout (children inherit the variable)
os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")


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
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=GLOO_TIMEOUT)
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


def run_example(rank: int, world: int, workdir: str) -> dict:
    """``repro_torch.examples.distributed_groupby``'s ops on this rank."""
    _, dist = _join(rank, world, workdir)
    from repro_torch.dist.dframe import data_mesh
    from repro_torch.examples import distributed_groupby

    try:
        return distributed_groupby.run(data_mesh(), "cpu")
    finally:
        dist.destroy_process_group()


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


def sharded_configs() -> dict:
    """The reduced configs of the sharded step on a (2, 2) mesh."""
    import dataclasses

    from repro_torch.configs.registry import get
    from repro_torch.models.config import reduced

    # GQA, 8 query heads on 2 kv heads, the kv projections replicated:
    # each "model" rank slices the kv head its 4 query heads read
    qwen = reduced(get("qwen3-14b"), n_heads=8, n_kv_heads=2, kv_shard="replicated",
                   microbatches=2)
    # one kv head: its projection's width is sharded over "model", which
    # does not divide the heads, so the split into heads gathers it first
    qwen_kv1 = reduced(get("qwen3-14b"), n_heads=8, n_kv_heads=1)
    # 4 experts over "model", each token's 2 experts; capacity for every
    # token on each expert, so no token drops, sharded (each data rank's
    # tokens) or not
    dbrx = reduced(get("dbrx-132b"), microbatches=2)
    dbrx = dataclasses.replace(dbrx, moe=dataclasses.replace(
        dbrx.moe, capacity_factor=dbrx.moe.n_experts / dbrx.moe.top_k))
    # K5 on batch-sharded inputs: u's gradient sums over the data ranks
    rwkv = reduced(get("rwkv6-7b"), microbatches=2)
    # capacity factor 1 with expert 0 made the first choice of most tokens
    # (``DROP_ROUTER_BIAS``): its slots overflow the capacity of the whole
    # batch, and a rank's share of them differs from its tokens' share
    dbrx_drop = dataclasses.replace(dbrx, moe=dataclasses.replace(dbrx.moe, capacity_factor=1.0))
    # 3 rows a data rank (``ROWS3_B``), which the 2 "model" ranks do not divide
    qwen_rows3 = reduced(get("qwen3-14b"), n_heads=8, n_kv_heads=2, kv_shard="replicated",
                         microbatches=1)
    return {"qwen3": qwen, "qwen3_kv1": qwen_kv1, "dbrx": dbrx, "rwkv6": rwkv,
            "dbrx_drop": dbrx_drop, "qwen3_rows3": qwen_rows3}


#: the sharded step's batch (each microbatch 2 rows a data rank), and its
#: decode cache and position: the cache is long enough for
#: ``decode_state_specs`` to shard its sequence over "model", and the
#: position falls in the second rank's half
SHARD_B, SHARD_S, SHARD_SMAX, SHARD_POS = 8, 16, 4096, 2100
#: the rows of ``qwen3_rows3``'s batch: 3 a data rank in its one microbatch
ROWS3_B = 6
#: added to the router's column of expert 0 in ``dbrx_drop``: with the
#: reduced width's normalized inputs, most tokens route to expert 0 first
DROP_ROUTER_BIAS = 0.5


def record_kept(layers, log: list) -> None:
    """Wrap ``layers._moe_dispatch`` so that every call appends its slots'
    kept mask in slot order (token-major, then choice) to ``log``: on a
    rank of the sharded step, its own tokens' slots."""
    import torch

    dispatch = layers._moe_dispatch

    def wrapped(*args, **kwargs):
        buf, dest, order, keep = dispatch(*args, **kwargs)
        kept = torch.zeros(keep.shape, dtype=torch.bool)
        kept[order] = keep
        log.append(kept)
        return buf, dest, order, keep

    layers._moe_dispatch = wrapped


def place(tree, mesh, specs):
    """``tree`` (weights, a batch or a state) as DTensors placed by ``specs``."""
    from repro_torch.models import lm, partition

    shardings = partition.shardings_from_specs(mesh, specs)
    if isinstance(tree, lm.Params):
        named = {n: partition.distribute(p.detach(), shardings[n])
                 for n, p in tree.named_parameters()}
        return lm.Params(lm.tree_from_names(named))
    return partition.distribute_tree(tree, shardings)


def run_sharded(rank: int, world: int, workdir: str) -> dict:
    """The prefill, one train step (two microbatches) and one decode step
    at a 0-d tensor position on a (2, 2) ("data", "model") mesh of
    DTensors placed by the partition specs, each as a whole tensor; rank
    0 adds the unsharded results on the same inputs."""
    torch, dist = _join(rank, world, workdir)
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers, lm, partition
    from repro_torch.train.optimizer import get_optimizer
    from repro_torch.train.train_step import init_train_state, make_train_step

    mesh = make_host_mesh(2, device_type="cpu")
    rng = np.random.default_rng(11)
    tokens = torch.as_tensor(rng.integers(0, 256, (SHARD_B, SHARD_S)), dtype=torch.int32)
    step_batch = {"tokens": tokens[:, :1]}
    dstep_batch = place(step_batch, mesh, partition.batch_specs(mesh, step_batch))
    gen = lambda: torch.Generator("cpu").manual_seed(2)
    plain = rank == 0
    out = {"rank": rank, "coord": tuple(mesh.get_coordinate())}
    kept: list = []
    record_kept(layers, kept)

    def init_params(cfg, name):
        params = lm.init_params(cfg, gen(), device="cpu")
        if name == "dbrx_drop":
            with torch.no_grad():
                for pname, t in params.named_parameters():
                    if pname.endswith("router"):
                        t[:, 0] += DROP_ROUTER_BIAS
        return params

    for name, cfg in sharded_configs().items():
        res = out[name] = {}
        rows = tokens if name != "qwen3_rows3" else torch.as_tensor(
            rng.integers(0, 256, (ROWS3_B, SHARD_S)), dtype=torch.int32)
        batch = {"tokens": rows, "labels": torch.roll(rows, -1, 1)}
        dbatch = place(batch, mesh, partition.batch_specs(mesh, batch))
        params = init_params(cfg, name)
        pspecs = partition.param_specs(params, cfg)
        kept.clear()
        with implicit_replication():
            res["prefill"] = lm.prefill(cfg, place(params, mesh, pspecs), dbatch).full_tensor()
        if name == "qwen3_kv1":
            if plain:
                res["prefill_plain"] = lm.prefill(cfg, params, batch)
            state = lm.init_decode_state(cfg, SHARD_B, SHARD_SMAX, device="cpu")
            g = torch.Generator("cpu").manual_seed(3)
            for key in ("k", "v"):  # a cache as a prefill would leave it
                state[key].normal_(generator=g)
            before = {key: state[key].clone() for key in ("k", "v")}
            dstate = dict(state, k=state["k"].clone(), v=state["v"].clone(),
                          pos=torch.tensor(SHARD_POS, dtype=torch.int32))
            dspecs = partition.decode_state_specs(mesh, dstate)
            res["cache_spec"] = tuple(dspecs["k"])
            dstate = place(dstate, mesh, dspecs)
            with implicit_replication():
                logits, new = lm.decode_step(cfg, place(params, mesh, pspecs), dstate,
                                             dstep_batch)
            res["decode"] = logits.full_tensor()
            res["pos"] = int(new["pos"].full_tensor())
            for key in ("k", "v"):
                full = dstate[key].full_tensor()
                res[f"slot_{key}"] = full[:, :, SHARD_POS].clone()
                full[:, :, SHARD_POS] = before[key][:, :, SHARD_POS]
                res[f"rest_{key}_unchanged"] = torch.equal(full, before[key])
            if plain:
                state["pos"] = SHARD_POS
                logits, new = lm.decode_step(cfg, params, state, step_batch)
                res["decode_plain"], res["pos_plain"] = logits, new["pos"]
                for key in ("k", "v"):
                    res[f"slot_{key}_plain"] = state[key][:, :, SHARD_POS].clone()
            continue
        opt = get_optimizer(cfg.optimizer)
        specs = {"params": pspecs, "opt": opt.state_specs(pspecs, params), "step": partition.P()}
        dstate = init_train_state(cfg, device="cpu", params=init_params(cfg, name))
        dstate = {"params": place(dstate["params"], mesh, pspecs),
                  "opt": place(dstate["opt"], mesh, specs["opt"]), "step": 0}
        dstate["params"].requires_grad_(True)
        step = make_train_step(cfg)
        with implicit_replication():
            dstate, metrics = step(dstate, dbatch)
        res["metrics"] = {k: metrics[k].full_tensor() for k in ("loss", "grad_norm")}
        res["params"] = {n: p.full_tensor().detach()
                         for n, p in dstate["params"].named_parameters()}
        # each MoE call's kept mask of this rank's slots: the prefill's,
        # then the step's forwards
        res["kept"] = [m.clone() for m in kept]
        if plain:
            kept.clear()
            res["prefill_plain"] = lm.prefill(cfg, params, batch)
            state, metrics = step(init_train_state(cfg, device="cpu",
                                                   params=init_params(cfg, name)), batch)
            res["metrics_plain"] = {k: metrics[k] for k in ("loss", "grad_norm")}
            res["params_plain"] = {n: p.detach() for n, p in state["params"].named_parameters()}
            res["kept_plain"] = [m.clone() for m in kept]
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
    processes, ``(args, env)``), wait for all of them together for at most
    ``RANKS_DEADLINE_S``, fail on any non-zero exit or on the deadline, and
    return each rank's outputs."""
    deadline = time.monotonic() + RANKS_DEADLINE_S
    procs = [_spawn([scenario, str(r), str(world), str(workdir)]) for r in range(world)]
    procs += [_spawn(args, env) for args, env in extra]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(0.1, deadline - time.monotonic()))[0])
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
    out = {"ops": run_ops, "reshard": run_reshard, "sharded": run_sharded,
           "example": run_example}[scenario](
        rank, world, workdir)
    with open(os.path.join(workdir, f"{scenario}-{rank}.pkl"), "wb") as f:
        pickle.dump(_to_numpy(out), f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
