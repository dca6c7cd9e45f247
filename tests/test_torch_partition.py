"""The port's partition specs (``repro_torch.models.partition``), the
optimizers' ``state_specs``, ``launch/mesh.py`` and elastic resharding of
checkpoints, on the CPU.

- For each of the ten registered configs at a reduced size, every weight's
  spec equals the JAX package's ``param_specs`` spec of its leaf, without
  the leading ``None`` of the stacked layer axis for a per-block weight,
  also under ``kv_shard="replicated"``; ``batch_specs`` and
  ``decode_state_specs`` over a (2, 2) mesh's sizes equal the reference's
  over a (2, 2) mesh, and ``adamw``'s and ``adafactor``'s ``state_specs``
  equal the reference's.
- Specs become DTensor placements; a checkpoint restores with
  ``shardings=`` onto a one-rank (1, 1) mesh bit for bit, and, written on
  one rank, onto a (2, 2) mesh of four gloo ranks (tests/dist_ranks.py)
  shard for shard: every rank's local shard is its slice of the saved
  leaf and ``full_tensor()`` gives the leaf back (the twin of
  tests/test_distributed.py::test_elastic_checkpoint_reshard).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import get as j_get
from repro.models import lm as j_lm
from repro.models import partition as j_partition
from repro.models.config import reduced as j_reduced
from repro.train import optimizer as j_optimizer
from repro_torch.configs.registry import ARCHS, get
from repro_torch.dist import dframe
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import lm, partition
from repro_torch.models.config import reduced
from repro_torch.models.partition import P
from repro_torch.train import checkpoint
from repro_torch.train import optimizer as port_optimizer
from repro_torch.train.train_step import init_train_state

sys.path.insert(0, str(Path(__file__).resolve().parent))
import dist_ranks  # noqa: E402

MESHES = [{"data": 2, "model": 2}, {"pod": 2, "data": 2, "model": 2}]


@pytest.fixture(autouse=True, scope="module")
def _x64_on(_x64_policy):
    jax.config.update("jax_enable_x64", True)
    yield


def _configs(arch: str, **overrides):
    return reduced(get(arch), **overrides), j_reduced(j_get(arch), **overrides)


def _port_params(cfg):
    return lm.init_params(cfg, torch.Generator("cpu").manual_seed(0), device="cpu")


def _ref_leaves(tree) -> dict:
    """``{dotted path: spec}`` of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))
    return {j_partition._path_str(path): spec for path, spec in flat}


def _unstacked(name: str) -> tuple:
    """(reference leaf path, per-block?) of a port weight name."""
    parts = name.split(".")
    return ".".join(p for p in parts if not p.isdigit()), any(p.isdigit() for p in parts)


@pytest.mark.parametrize("kv_shard", ["model", "replicated"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, kv_shard):
    cfg, jcfg = _configs(arch, kv_shard=kv_shard)
    got = partition.param_specs(_port_params(cfg), cfg)
    shapes = jax.eval_shape(lambda: j_lm.init_params(jcfg, jax.random.PRNGKey(0)))
    want = _ref_leaves(j_partition.param_specs(shapes, jcfg))
    assert {_unstacked(n)[0] for n in got} == set(want)
    for name, spec in got.items():
        path, per_block = _unstacked(name)
        ref = tuple(want[path])
        assert isinstance(spec, P)
        assert tuple(spec) == (ref[1:] if per_block else ref), (name, spec, ref)
    if kv_shard == "replicated":
        assert all("model" not in spec for n, spec in got.items() if ".attn.wk" in "." + n)


@pytest.mark.parametrize("sizes", MESHES, ids=["data-model", "pod-data-model"])
@pytest.mark.parametrize("arch", ["qwen3-14b", "rwkv6-7b", "zamba2-2.7b", "llama-3.2-vision-90b"])
def test_batch_and_decode_state_specs_equal_the_reference(arch, sizes):
    cfg, jcfg = _configs(arch)
    jmesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    for B in (1, 2, 3, 4, 8):
        batch = {"tokens": torch.zeros(B, 16, dtype=torch.int32),
                 "labels": torch.zeros(B, 16, dtype=torch.int32), "scalar": torch.zeros(())}
        jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32) for k, v in batch.items()}
        got, want = partition.batch_specs(sizes, batch), j_partition.batch_specs(jmesh, jbatch)
        assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}
        for max_len in (64, 4096):
            state = lm.init_decode_state(cfg, B, max_len, device="cpu")
            jstate = jax.eval_shape(lambda: j_lm.init_decode_state(jcfg, B, max_len))
            got = partition.decode_state_specs(sizes, state)
            want = j_partition.decode_state_specs(jmesh, jstate)
            assert set(got) == set(want)
            for k in want:
                assert tuple(got[k]) == tuple(want[k]), (k, got[k], want[k])


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "kimi-k2-1t-a32b", "rwkv6-7b", "zamba2-2.7b"])
def test_optimizer_state_specs_equal_the_reference(arch, opt):
    cfg, jcfg = _configs(arch)
    params = _port_params(cfg)
    got = port_optimizer.get_optimizer(opt).state_specs(partition.param_specs(params), params)
    shapes = jax.eval_shape(lambda: j_lm.init_params(jcfg, jax.random.PRNGKey(0)))
    want = j_optimizer.get_optimizer(opt).state_specs(j_partition.param_specs(shapes), shapes)
    assert tuple(got["step"]) == tuple(want["step"]) == ()
    if opt == "adamw":
        for part in ("m", "v", "master"):
            ref = _ref_leaves(want[part])
            for name, spec in got[part].items():
                path, per_block = _unstacked(name)
                assert tuple(spec) == tuple(ref[path])[1 if per_block else 0:], (part, name)
    else:
        # the moments of a stacked group are stacked in both packages
        ref = _ref_leaves(want["moments"])
        flat = {f"{key}.{m}": spec for key, moms in got["moments"].items()
                for m, spec in moms.items()}
        assert set(flat) == set(ref)
        for key, spec in flat.items():
            assert tuple(spec) == tuple(ref[key]), key


def test_placements_of_specs():
    mesh = dframe.init_local("cpu", timeout=dist_ranks.GLOO_TIMEOUT)
    try:
        host = port_mesh.make_host_mesh(1, device_type="cpu")
        assert host.mesh_dim_names == ("data", "model") and tuple(host.mesh.shape) == (1, 1)
        assert partition.mesh_shape(host) == {"data": 1, "model": 1}
        sh = partition.shardings_from_specs(host, {"w": P("data", "model"), "b": P(None),
                                                   "t": P(("data", "model"), None),
                                                   "s": P("model", None, "data")})
        assert [repr(p) for p in sh["w"].placements] == ["Shard(dim=0)", "Shard(dim=1)"]
        assert [repr(p) for p in sh["b"].placements] == ["Replicate()", "Replicate()"]
        assert [repr(p) for p in sh["t"].placements] == ["Shard(dim=0)", "Shard(dim=0)"]
        assert [repr(p) for p in sh["s"].placements] == ["Shard(dim=2)", "Shard(dim=0)"]
        for bad in (P("pod"), P("data", "data"), P(("model", "data"))):
            with pytest.raises(ValueError):
                partition.NamedSharding(host, bad).placements
        with pytest.raises(ValueError):
            port_mesh.make_production_mesh()  # 256 ranks wanted, 1 up
        assert mesh.size == 1
    finally:
        torch.distributed.destroy_process_group()
    with pytest.raises(RuntimeError):
        port_mesh.make_host_mesh(1, device_type="cpu")  # no group: no mesh


def _train_state(seed: int):
    cfg = reduced(get("phi3-mini-3.8b"), n_layers=2)
    return cfg, init_train_state(cfg, torch.Generator("cpu").manual_seed(seed), device="cpu")


def _specs(cfg, params):
    pspecs = partition.param_specs(params)
    opt = port_optimizer.get_optimizer(cfg.optimizer)
    return {"params": pspecs, "opt": opt.state_specs(pspecs, params), "step": P()}


def test_restore_with_shardings_on_one_rank(tmp_path):
    cfg, state = _train_state(3)
    checkpoint.save(state, str(tmp_path), 3)
    dframe.init_local("cpu", timeout=dist_ranks.GLOO_TIMEOUT)
    try:
        host = port_mesh.make_host_mesh(1, device_type="cpu")
        _, like = _train_state(99)
        sh = partition.shardings_from_specs(host, _specs(cfg, like["params"]))
        got = checkpoint.restore(str(tmp_path), like, shardings=sh)
        assert got["step"] == 0
        for name, p in got["params"].named_parameters():
            assert type(p.data).__name__ == "DTensor" and p.requires_grad
            assert torch.equal(p.to_local(), dict(state["params"].named_parameters())[name])
        for name, t in got["opt"]["master"].items():
            assert torch.equal(t.full_tensor(), state["opt"]["master"][name])
        placed = partition.distribute_tree({"a": torch.ones(4, 2), "n": 5},
                                           {"a": sh["params"]["lm_head"], "n": None})
        assert placed["n"] == 5 and torch.equal(placed["a"].full_tensor(), torch.ones(4, 2))
    finally:
        torch.distributed.destroy_process_group()


def _chunk(size: int, n: int, i: int) -> slice:
    """DTensor's ``Shard``: ceil-sized pieces in order, the last ones short
    or empty."""
    c = -(-size // n)
    return slice(min(i * c, size), min((i + 1) * c, size))


def _expected_shard(leaf: np.ndarray, placements, coord, mesh_shape) -> np.ndarray:
    out = leaf
    for mdim, tdim in enumerate(placements):
        if tdim is not None:
            idx = [slice(None)] * out.ndim
            idx[tdim] = _chunk(out.shape[tdim], mesh_shape[mdim], coord[mdim])
            out = out[tuple(idx)]
    return out


def test_elastic_checkpoint_reshard(tmp_path):
    """A checkpoint written on one rank restores onto a (2, 2) mesh of four
    gloo ranks, shard for shard."""
    _, state = _train_state(5)
    checkpoint.save(state, str(tmp_path / "ckpt"), 3)
    saved = {f"params/{n}": p.detach().numpy() for n, p in state["params"].named_parameters()}
    saved.update({f"opt/m/{n}": t.numpy() for n, t in state["opt"]["m"].items()})
    ranks = dist_ranks.run_ranks("reshard", tmp_path)
    coords = {out["coord"] for out in ranks}
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}
    for out in ranks:
        assert out["step"] == 0 and out["mesh"] == (2, 2)
        assert set(out["leaves"]) == set(saved)
        for key, leaf in out["leaves"].items():
            np.testing.assert_array_equal(leaf["full"], saved[key])
            want = _expected_shard(saved[key], leaf["placements"], out["coord"], out["mesh"])
            assert leaf["local"].shape == want.shape, key
            np.testing.assert_array_equal(leaf["local"], want)
            assert leaf["requires_grad"] == key.startswith("params/")
        wq = out["leaves"]["params/blocks.0.attn.wq"]
        assert wq["placements"] == [0, 1]  # data on dim 0, model on dim 1
        assert wq["local"].size * 4 == saved["params/blocks.0.attn.wq"].size
