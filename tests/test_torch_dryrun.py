"""The port's sharded dry run (``repro_torch.launch``: ``shapes``,
``hlo_analysis``, ``dryrun``) and the kernels' fake and DTensor routes.

- In process: the input specs of all 10 archs x 4 shapes against
  ``repro.launch.shapes`` (applicability and its reason, batch shapes and
  dtypes, every leaf of the states, the port's per-block weights stacked
  as the reference stacks them); the L-layer matmul chain counted to 1 %;
  K4's and K5's fake routes against their plain versions in shape and
  dtype, forward and backward, with the recorded costs; and the sharded
  step on a one-rank gloo group, a (1, 1) mesh of DTensors, equal bit for
  bit to the unsharded step.
- In a subprocess (a ``"fake"`` default group never shares a process
  with the gloo groups of other tests): the calibration twins of
  tests/test_hlo_analysis.py on a fake 4-rank mesh, every layer counted,
  both production meshes, and reduced Qwen3-14B, RWKV6-7B and DBRX-132B
  cells on the 16 x 16 mesh against ``repro.launch.dryrun.run_cell`` on
  256 forced host devices (run beside it, in parallel); DBRX's train cell
  with 2 rows a data rank in each microbatch.
- Four gloo ranks (tests/dist_ranks.py): the prefill, train and decode
  steps on a (2, 2) mesh against the unsharded steps.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro.configs import get as j_get
from repro.launch import shapes as j_shapes
from repro_torch.configs.registry import ARCHS, get
from repro_torch.kernels import build, ops
from repro_torch.kernels.flash_attention import (
    attention_bwd_cost, attention_cost, flash_attention_plain,
)
from repro_torch.kernels.wkv6 import wkv6_bwd_cost, wkv6_cost, wkv6_plain
from repro_torch.launch import hlo_analysis, shapes

sys.path.insert(0, str(Path(__file__).resolve().parent))
import dist_ranks  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
#: the reduced cells held to the reference: widths the 16-way axes divide
REDUCED = dict(n_layers=2, d_model=256, n_heads=16, n_kv_heads=16, head_dim=16, d_ff=512,
               vocab=1024, microbatches=1)
CELLS = (("qwen3-14b", "train_4k"), ("rwkv6-7b", "prefill_32k"), ("dbrx-132b", "decode_32k"))


# ----------------------------------------------------------------------
# input specs against the reference
# ----------------------------------------------------------------------
def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def _ref_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            (tuple(leaf.shape), str(leaf.dtype)) for path, leaf in flat}


def _port_leaves(tree, prefix="") -> dict:
    """``{path: (shape, dtype)}`` of a port state in the reference's layout:
    the per-block weights (and adamw's moments of them) stacked on a
    leading layer dim."""
    out, stacked = {}, {}
    items = (tree.named_parameters() if isinstance(tree, torch.nn.Module) else tree.items())
    for name, leaf in items:
        path = f"{prefix}{name}"
        if isinstance(leaf, dict):
            out.update(_port_leaves(leaf, path + "."))
            continue
        parts = path.split(".")
        key = ".".join(p for p in parts if not p.isdigit())
        if key != path:
            stacked.setdefault(key, []).append((tuple(leaf.shape), _dtype(leaf.dtype)))
        else:
            out[path] = (tuple(leaf.shape), _dtype(leaf.dtype))
    for key, members in stacked.items():
        assert len(set(members)) == 1, key
        out[key] = ((len(members),) + members[0][0], members[0][1])
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch):
    cfg, jcfg = get(arch), j_get(arch)
    assert set(shapes.SHAPES) == set(j_shapes.SHAPES)
    for name, sp in shapes.SHAPES.items():
        assert (sp.seq_len, sp.global_batch, sp.kind) == (
            j_shapes.SHAPES[name].seq_len, j_shapes.SHAPES[name].global_batch,
            j_shapes.SHAPES[name].kind)
        assert shapes.cell_applicable(cfg, name) == j_shapes.cell_applicable(jcfg, name)
        if not shapes.cell_applicable(cfg, name)[0]:
            continue
        got, want = shapes.input_specs(cfg, name), j_shapes.input_specs(jcfg, name)
        assert got["kind"] == want["kind"]
        assert {k: (tuple(v.shape), _dtype(v.dtype)) for k, v in got["batch"].items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in want["batch"].items()}
        assert all(t.is_meta for t in got["batch"].values())
        state = got["state"]
        if got["kind"] == "train":
            port = _port_leaves(state["params"], "params.")
            port.update(_port_leaves({k: v for k, v in state["opt"].items()}, "opt."))
            port["step"] = (tuple(state["step"].shape), _dtype(state["step"].dtype))
            assert all(p.requires_grad and p.is_meta for p in state["params"].parameters())
        else:
            port = _port_leaves(state)
        assert port == _ref_leaves(want["state"]), (arch, name)


# ----------------------------------------------------------------------
# the step analysis, in process (no process group)
# ----------------------------------------------------------------------
def test_matmul_chain_flops_counted_per_layer():
    L, D, B = 8, 256, 64
    ws = [torch.empty(D, D, device="meta") for _ in range(L)]
    x = torch.empty(B, D, device="meta")

    def chain():
        y = x
        for w in ws:
            y = torch.tanh(y @ w)
        return y

    _, a = hlo_analysis.analyze(chain, (ws, x))
    expected = 2.0 * B * D * D * L
    assert abs(a["flops"] / expected - 1) <= 0.01, (a["flops"], expected)
    assert a["dot_flops"] == a["flops"]
    assert a["dot_bytes"] == L * 4 * (B * D + D * D + B * D)
    # inputs live from the start, then at most two (B, D) results at once
    assert a["peak_bytes"] >= 4 * (L * D * D + B * D)
    assert a["collectives"] == {} and a["coll_total"] == 0


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fake_route_matches_the_plain_version(dtype, causal):
    B, Hq, Hkv, Sq, Sk, D = 2, 8, 2, 48, 64, 32
    rng = np.random.default_rng(3)
    real = [torch.as_tensor(rng.normal(size=s), dtype=dtype).requires_grad_()
            for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))]
    want = flash_attention_plain(*real, causal)
    want_grads = torch.autograd.grad(want.float().sum(), real)
    build.reset_fake_costs()
    fake = [_meta(*t.shape, dtype=dtype) for t in real]
    got = ops.flash_attention(*fake, causal)
    assert got.is_meta and got.shape == want.shape and got.dtype == want.dtype
    assert not build.LAUNCHES["flash_attention_sm90"]
    name = "flash_attention_sm90" if dtype == torch.bfloat16 else "flash_attention_f32_sm90"
    cost = attention_cost(B, Hq, Hkv, Sq, Sk, D, causal, real[0].element_size())
    assert build.FAKE_COSTS == {name: {"calls": 1, "bytes": cost[0], "ops": cost[1]}}
    # with a gradient: the autograd Function of the fake route
    fake = [t.requires_grad_() for t in fake]
    got = ops.flash_attention(*fake, causal)
    grads = torch.autograd.grad(got.float().sum(), fake)
    for g, w in zip(grads, want_grads):
        assert g.is_meta and g.shape == w.shape and g.dtype == w.dtype
    bwd = "flash_attention_bwd_sm90" if dtype == torch.bfloat16 else "flash_attention_bwd_f32_sm90"
    cost = attention_bwd_cost(B, Hq, Hkv, Sq, Sk, D, causal, real[0].element_size())
    assert build.FAKE_COSTS[bwd] == {"calls": 1, "bytes": cost[0], "ops": cost[1]}
    assert build.FAKE_COSTS[name]["calls"] == 2


def test_attention_pairs_closed_form_counts_the_mask():
    from repro_torch.kernels.flash_attention import attention_pairs

    for Sq, Sk in ((1, 1), (5, 5), (7, 19), (64, 64), (0, 4)):
        loop = sum(min(Sk, i + (Sk - Sq) + 1) for i in range(Sq))
        assert attention_pairs(Sq, Sk, True) == loop
        assert attention_pairs(Sq, Sk, False) == Sq * Sk


@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_fake_route_matches_the_plain_version(with_state):
    B, H, T, D = 2, 3, 7, 16
    rng = np.random.default_rng(4)
    x = lambda: torch.as_tensor(rng.normal(size=(B, T, H, D)), dtype=torch.bfloat16)
    r, k, v = (x().transpose(1, 2) for _ in range(3))
    w = torch.as_tensor(rng.uniform(0.5, 0.99, size=(B, T, H, D)), dtype=torch.bfloat16)
    w = w.transpose(1, 2)
    u = torch.as_tensor(rng.normal(size=(H, D)), dtype=torch.bfloat16)
    s0 = torch.as_tensor(rng.normal(size=(B, H, D, D)), dtype=torch.float32) if with_state else None
    y, s = wkv6_plain(r, k, v, w, u, s0)
    as_meta = lambda t: None if t is None else torch.empty_strided(
        t.shape, t.stride(), dtype=t.dtype, device="meta")
    build.reset_fake_costs()
    fy, fs = ops.wkv6(*(as_meta(t) for t in (r, k, v, w, u, s0)))
    for got, want in ((fy, y), (fs, s)):
        assert got.is_meta and got.shape == want.shape and got.dtype == want.dtype
    assert fy.stride() == y.stride()  # the (B, H, T, D) view of a (B, T, H, D) tensor
    cost = wkv6_cost(B, H, T, D, 2, 2)
    assert build.FAKE_COSTS == {"wkv6": {"calls": 1, "bytes": cost[0], "ops": cost[1]}}
    # with a gradient
    leaves = [as_meta(t).requires_grad_() for t in (r, k, v, w, u)]
    fy, _ = ops.wkv6(*leaves, None)
    grads = torch.autograd.grad(fy.float().sum(), leaves)
    for g, t in zip(grads, (r, k, v, w, u)):
        assert g.is_meta and g.shape == t.shape and g.dtype == t.dtype
    cost = wkv6_bwd_cost(B, H, T, D, 2)
    assert build.FAKE_COSTS["wkv6_bwd"] == {"calls": 1, "bytes": cost[0], "ops": cost[1]}


def test_only_k4_and_k5_take_a_fake_route():
    with pytest.raises(ValueError):
        ops.segment_sum(_meta(8, dtype=torch.float64), _meta(8, dtype=torch.int64), 4)
    with pytest.raises(ValueError):
        ops.hash32x2(_meta(8, 2, dtype=torch.int32))


# ----------------------------------------------------------------------
# the sharded step on a (1, 1) mesh of one gloo rank equals the unsharded
# ----------------------------------------------------------------------
@pytest.fixture
def host_mesh():
    from repro_torch.dist import dframe
    from repro_torch.launch.mesh import make_host_mesh

    dframe.init_local("cpu", timeout=dist_ranks.GLOO_TIMEOUT)
    try:
        yield make_host_mesh(1, device_type="cpu")
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen3-14b", "rwkv6-7b", "dbrx-132b"])
def test_sharded_step_on_one_rank_equals_the_unsharded(host_mesh, arch):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import lm, partition
    from repro_torch.models.config import reduced
    from repro_torch.train.train_step import init_train_state, make_train_step

    cfg = reduced(get(arch), microbatches=2)
    rng = np.random.default_rng(9)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 16)), dtype=torch.int32)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    gen = lambda: torch.Generator("cpu").manual_seed(2)
    params = lm.init_params(cfg, gen(), device="cpu")
    pspecs = partition.param_specs(params, cfg)
    sharded = dist_ranks.place(params, host_mesh, pspecs)
    dbatch = dist_ranks.place(batch, host_mesh, partition.batch_specs(host_mesh, batch))
    with implicit_replication():
        got = lm.prefill(cfg, sharded, dbatch)
    assert torch.equal(got.full_tensor(), lm.prefill(cfg, params, batch))
    # one train step: loss, grad norm and every updated weight
    state = init_train_state(cfg, gen(), device="cpu")
    from repro_torch.train.optimizer import get_optimizer

    opt = get_optimizer(cfg.optimizer)
    specs = {"params": pspecs, "opt": opt.state_specs(pspecs, state["params"]),
             "step": partition.P()}
    dstate = init_train_state(cfg, gen(), device="cpu")
    dstate = {"params": dist_ranks.place(dstate["params"], host_mesh, pspecs),
              "opt": dist_ranks.place(dstate["opt"], host_mesh, specs["opt"]), "step": 0}
    dstate["params"].requires_grad_(True)
    step = make_train_step(cfg)
    state, metrics = step(state, batch)
    with implicit_replication():
        dstate, dmetrics = step(dstate, dbatch)
    for key in ("loss", "grad_norm"):
        assert torch.equal(dmetrics[key].full_tensor(), metrics[key]), key
    want = dict(state["params"].named_parameters())
    for name, p in dstate["params"].named_parameters():
        assert torch.equal(p.full_tensor(), want[name]), name


# ----------------------------------------------------------------------
# the sharded step on a (2, 2) mesh of four gloo ranks
# ----------------------------------------------------------------------
def test_sharded_steps_on_a_2x2_mesh_equal_the_unsharded(tmp_path):
    """Four gloo ranks (tests/dist_ranks.py ``sharded``), a (2, 2)
    ("data", "model") mesh: the prefill and a train step of two
    microbatches of reduced Qwen3 (GQA, each rank slicing its kv head;
    the vocab-sharded loss), DBRX (4 experts over "model", no token
    dropped) and RWKV6 (K5 on batch-sharded inputs), and a decode step of
    Qwen3 with one kv head at a 0-d tensor position inside the second
    "model" rank's half of a sequence-sharded cache.  Every rank's whole
    tensors are held to the unsharded step's on the same inputs: logits,
    loss and grad norm within float32 rounding (rtol and atol 1e-5); the
    weights after one adamw step within 2e-5, which a gradient of the
    wrong sign or size breaks (adamw's first step moves a weight by about
    lr = 3e-4); the position and the cache outside the written slot
    exactly.  Two more cases: DBRX at capacity factor 1 with expert 0
    made most tokens' first choice, so that slots drop (each MoE call's
    kept slots, the data ranks' masks in order, equal the unsharded call's
    exactly); and Qwen3 at 3 rows a data rank, which the 2 "model" ranks do
    not divide."""
    outs = dist_ranks.run_ranks("sharded", tmp_path)
    assert sorted(out["coord"] for out in outs) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    plain = outs[0]
    by_coord = {out["coord"]: out for out in outs}
    for name in ("dbrx", "dbrx_drop"):
        want = plain[name]["kept_plain"]
        assert len(want) > 0
        for m in (0, 1):
            masks = [by_coord[(d, m)][name]["kept"] for d in (0, 1)]
            assert len(masks[0]) == len(masks[1]) == len(want)
            for lo, hi, w in zip(*masks, want):
                np.testing.assert_array_equal(np.concatenate([lo, hi]), w)
        dropped = sum(int((~w).sum()) for w in want)
        assert (dropped > 0) == (name == "dbrx_drop"), (name, dropped)
    close = lambda got, want, tol=1e-5: np.testing.assert_allclose(got, want, rtol=1e-5,
                                                                   atol=tol)
    for out in outs:
        for name in dist_ranks.sharded_configs():
            got, want = out[name], plain[name]
            close(got["prefill"], want["prefill_plain"])
            if name == "qwen3_kv1":
                assert got["cache_spec"] == (None, "data", "model", None, None)
                close(got["decode"], want["decode_plain"])
                assert got["pos"] == want["pos_plain"] == dist_ranks.SHARD_POS + 1
                for key in ("k", "v"):
                    close(got[f"slot_{key}"], want[f"slot_{key}_plain"])
                    assert got[f"rest_{key}_unchanged"], key
                continue
            for key in ("loss", "grad_norm"):
                close(got["metrics"][key], want["metrics_plain"][key])
            assert got["params"].keys() == want["params_plain"].keys()
            for key, p in got["params"].items():
                close(p, want["params_plain"][key], 2e-5)


# ----------------------------------------------------------------------
# fake process groups, in a subprocess beside the reference's
# ----------------------------------------------------------------------
PORT_SCRIPT = r"""
import json, sys
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import make_production_mesh

out = {}
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)

from repro_torch.models.partition import P

def dt(shape, mesh, spec):
    return dryrun.place(torch.empty(shape, device="meta"), mesh, spec)

# a batch-sharded matmul: a quarter of the global FLOPs on each rank
mesh = init_device_mesh("cuda", (4,), mesh_dim_names=("data",))
B, D = 256, 256
w, x = dt((D, D), mesh, P(None, None)), dt((B, D), mesh, P("data", None))
_, a = hlo_analysis.analyze(lambda: x @ w, (w, x))
out["sharded_flops"] = a["flops"]
out["sharded_expected"] = 2.0 * B * D * D / 4

# a contraction over a sharded dim: an all-reduce of the partial product
mesh = init_device_mesh("cuda", (4,), mesh_dim_names=("model",))
D = 512
w, x = dt((D, D), mesh, P("model", None)), dt((64, D), mesh, P(None, "model"))
_, a = hlo_analysis.analyze(lambda: (x @ w).redistribute(mesh, [Replicate()]), (w, x))
out["contraction"] = {"collectives": a["collectives"], "operand_bytes": 64 * D * 4}

# every layer counted: the reduced prefill and train step on a (2, 2) mesh
mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
small = dict(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=256,
             microbatches=1)
layers = {}
for shape in ("prefill_32k", "train_4k"):
    for n in (1, 2, 3):
        c = dryrun.run_cell("qwen3-14b", shape, False, dict(small, n_layers=n), mesh=mesh)
        layers[f"{shape}/{n}"] = {k: c[k] for k in ("flops_per_device", "kernels",
                                                     "collective_bytes_total")}
out["layers"] = layers
dist.destroy_process_group()

# both production meshes over fake groups
for mp, ranks in ((False, 256), (True, 512)):
    dryrun._fake_world(ranks)
    m = make_production_mesh(multi_pod=mp, device_type="cuda")
    out[f"mesh{ranks}"] = [list(m.mesh.shape), list(m.mesh_dim_names)]

cells = {}
for arch, shape in CELLS:
    c = dryrun.run_cell(arch, shape, False, dict(REDUCED))
    cells[f"{arch}/{shape}"] = c
out["cells"] = cells

# DBRX's train cell with 8 microbatches: 2 rows a data rank, which the 16
# "model" ranks do not divide, under the MoE's partial-sum gradients
try:
    c = dryrun.run_cell("dbrx-132b", "train_4k", False, dict(REDUCED, microbatches=8))
    out["uneven"] = {k: c[k] for k in ("status", "collectives", "kernels")}
except Exception as e:
    out["uneven"] = {"status": "error", "error": repr(e)}
print("RESULT " + json.dumps(out))
"""

REF_SCRIPT = r"""
import json
from repro.launch.dryrun import run_cell
cells = {}
for arch, shape in CELLS:
    cells[f"{arch}/{shape}"] = run_cell(arch, shape, False, dict(REDUCED))
print("RESULT " + json.dumps(cells))
"""


def _start(script: str, env_extra: dict) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu", **env_extra)
    body = f"CELLS = {CELLS!r}\nREDUCED = {REDUCED!r}\n" + script
    return subprocess.Popen([sys.executable, "-c", body], env=env, cwd=str(REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _result(p: subprocess.Popen) -> dict:
    try:
        stdout, stderr = p.communicate(timeout=300)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == 0, stderr[-6000:]
    line = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def runs():
    """The port's fake-group script and the reference's dry run on 256
    forced host devices, started together."""
    port = _start(PORT_SCRIPT, {})
    ref = _start(REF_SCRIPT, {
        "DRYRUN_XLA_FLAGS": "--xla_force_host_platform_device_count=256"})
    return _result(port), _result(ref)


def test_batch_sharded_matmul_counts_a_quarter_per_rank(runs):
    out = runs[0]
    ratio = out["sharded_flops"] / out["sharded_expected"]
    assert abs(ratio - 1) <= 0.01, ratio


def test_sharded_contraction_reports_its_all_reduce(runs):
    c = runs[0]["contraction"]
    assert c["collectives"]["all-reduce"] == c["operand_bytes"], c
    assert sum(c["collectives"].values()) == c["operand_bytes"]


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_every_layer_is_counted(runs, shape):
    got = {n: runs[0]["layers"][f"{shape}/{n}"] for n in (1, 2, 3)}
    per_layer = got[2]["flops_per_device"] - got[1]["flops_per_device"]
    assert per_layer > 0
    assert got[3]["flops_per_device"] - got[2]["flops_per_device"] == per_layer
    for n, c in got.items():
        k = c["kernels"]
        if shape == "prefill_32k":
            assert k == {"flash_attention_sm90": k["flash_attention_sm90"]}
            assert k["flash_attention_sm90"]["calls"] == n
        else:
            # remat "nothing" runs each block's forward again in the backward
            assert k["flash_attention_sm90"]["calls"] == 2 * n
            assert k["flash_attention_bwd_sm90"]["calls"] == n


def test_production_meshes_over_fake_groups(runs):
    assert runs[0]["mesh256"] == [[16, 16], ["data", "model"]]
    assert runs[0]["mesh512"] == [[2, 16, 16], ["pod", "data", "model"]]


def test_moe_train_cell_with_rows_the_model_axis_does_not_divide(runs):
    """The expert-parallel MoE's gradient for its tokens is a partial sum
    over "model"; it is all-reduced where it arises (``sharded.grad_to_own``)
    and the backward never splits a data rank's 2 rows over 16 ranks."""
    c = runs[0]["uneven"]
    assert c["status"] == "ok", c
    assert c["collectives"]["all-reduce"] > 0
    assert c["kernels"]["flash_attention_bwd_sm90"]["calls"] == 2 * 8


@pytest.mark.parametrize("cell", [f"{a}/{s}" for a, s in CELLS])
def test_reduced_cells_equal_the_reference(runs, cell):
    got, want = runs[0]["cells"][cell], runs[1][cell]
    for key in ("status", "kind", "tokens", "params", "active_params", "model_flops", "chips",
                "mesh"):
        assert got[key] == want[key], (key, got[key], want[key])
    assert got["memory"]["argument_bytes"] == want["memory"]["argument_bytes"]
    assert got["trace_s"] >= 0 and "lower_s" not in got
    assert got["flops_per_device"] > 0 and got["bytes_per_device"] > 0
    assert set(got["collectives"]) <= set(hlo_analysis.COLLECTIVES)
    assert got["roofline"]["dominant"] in ("compute", "memory", "collective")
