"""The port's distributed layer (``repro_torch.dist``) on the CPU.

- In process, over a one-rank gloo group (``dframe.init_local("cpu")``):
  the twins of tests/test_dist_fallback.py -- every op on one rank, the
  engine's group-by sums and semi/anti joins routed under
  ``CONFIG.distributed = "force"`` and equal to ``"off"``, ``"auto"``
  local on one rank, ``"force"`` without a group raising; the compiled
  SQL route never reaching a collective, the streamed route reaching the
  hooks.  The semi-join mask is held to ``np.isin`` and to the local
  ``membership``, since the reference's one-device mask fails under this
  jax; ``quantize``'s codes and scales equal the JAX package's.
- Four gloo ranks in child processes (tests/dist_ranks.py), started once
  for the session (xdist workers share them through a file lock) beside
  one JAX process on four forced host devices: the
  repartition's slot arrays, ``valid``, ``dropped`` and the semi mask
  equal the JAX package's exactly, float32 group-by sums within 1e-6 of
  the largest sum (a sum that cancels can be far smaller than its
  terms, and float32 rounds each in another order), the pipeline within the reference test's 1e-5; routed TPC-H
  queries at SF 0.002 equal ``"off"`` (ints exact, floats rtol 1e-12);
  ``compressed_mean`` within ``0.02 * max(scale, 1)`` of the numpy mean.
"""
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from filelock import FileLock

import jax
import jax.numpy as jnp

from repro.dist import compression as j_compression
from repro.dist import pipeline as j_pipeline
from repro_torch import sql, store
from repro_torch.core import TensorFrame
from repro_torch.core import pipeline as ooc_pipeline
from repro_torch.core.config import CONFIG
from repro_torch.core.join import membership
from repro_torch.data import tpch
from repro_torch.dist import compression, dframe, pipeline
from repro_torch.kernels import ops
from repro_torch.queries.tpch_sql import sql_text
from repro_torch.sql import compile as plan_compile

sys.path.insert(0, str(Path(__file__).resolve().parent))
import dist_ranks  # noqa: E402

SF = 0.002  # must match the shared tpch_small fixture (conftest.py)


@pytest.fixture(autouse=True, scope="module")
def _x64_on(_x64_policy):
    jax.config.update("jax_enable_x64", True)
    yield


@pytest.fixture(autouse=True)
def _config():
    """Every test leaves the routing knobs and the counters as it found them."""
    saved = (CONFIG.distributed, CONFIG.dist_min_rows, CONFIG.compiled, CONFIG.out_of_core)
    dframe.reset_counts()
    yield
    CONFIG.distributed, CONFIG.dist_min_rows, CONFIG.compiled, CONFIG.out_of_core = saved


@pytest.fixture
def mesh1():
    """A one-rank gloo group, torn down after the test."""
    mesh = dframe.init_local("cpu", timeout=dist_ranks.GLOO_TIMEOUT)
    try:
        yield mesh
    finally:
        torch.distributed.destroy_process_group()


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _sequential(block, weights, x):
    """The layers applied one microbatch at a time, as the pipeline does."""
    out = []
    for h in x:
        for w in weights:
            h = block(w, h)
        out.append(h)
    return torch.stack(out)


# ----------------------------------------------------------------------
# every op on one rank
# ----------------------------------------------------------------------
def test_dist_groupby_sum_single_rank(mesh1):
    rng = np.random.default_rng(0)
    n, domain = 1000, 13
    keys = rng.integers(0, domain, n).astype(np.int32)
    vals = rng.normal(size=n).astype(np.float32)
    got = dframe.dist_groupby_sum(mesh1, _t(keys), _t(vals), domain)
    want = np.zeros(domain, np.float32)
    np.add.at(want, keys, vals)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert dframe.ROUTED["groupby_sum"] == dframe.COLLECTIVES["all_reduce"] == 1


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64])
def test_dist_groupby_sum_null_keys_and_k1_route(mesh1, monkeypatch, dtype):
    keys = _t(np.array([0, -1, 1, 0, -1], dtype=np.int64))
    vals = _t(np.array([1, 99, 2, 3, 99], dtype=dtype))
    calls = []

    def spy(values, ids, m):
        calls.append((values.dtype, m))
        return ops.segment_sum_plain(values, ids, m)

    monkeypatch.setattr(ops, "segment_sum", spy)
    got = dframe.dist_groupby_sum(mesh1, keys, vals, 2)
    assert got.dtype == vals.dtype
    np.testing.assert_array_equal(got.numpy(), np.array([4, 2], dtype=dtype))
    # the shard-local reducer: one segment sum over domain + 1 slots
    np.testing.assert_array_equal(dframe.local_dense_sum(keys, vals, 2).numpy(), [4, 2])
    assert calls == [(vals.dtype, 3)] * 2


def test_dist_semi_join_mask_single_rank(mesh1):
    rng = np.random.default_rng(1)
    probe = rng.integers(-1, 50, 777).astype(np.int64)
    build = np.array([3, 7, 11, 42], dtype=np.int64)
    mask = dframe.dist_semi_join_mask(mesh1, _t(probe), _t(build))
    np.testing.assert_array_equal(mask.numpy(), np.isin(probe, build))
    np.testing.assert_array_equal(mask.numpy(), membership(_t(probe), _t(build)).numpy())
    assert mask.dtype == torch.bool and dframe.COLLECTIVES["all_gather"] == 1


def test_dist_repartition_single_rank_lossless(mesh1):
    rng = np.random.default_rng(2)
    n, domain = 500, 17
    keys = rng.integers(0, domain, n).astype(np.int64)
    vals = rng.normal(size=n).astype(np.float32)
    k2, v2, valid, dropped = dframe.dist_repartition_by_key(mesh1, _t(keys), _t(vals), capacity=n)
    assert int(dropped) == 0
    kept = k2.numpy()[valid.numpy()]
    assert kept.shape[0] == n
    want = np.zeros(domain, np.float32)
    np.add.at(want, keys, vals)
    got = np.zeros(domain, np.float32)
    np.add.at(got, kept, v2.numpy()[valid.numpy()])
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_dist_repartition_overflow_accounting(mesh1):
    """capacity below n: the excess is counted in dropped, survivors stay
    consistent."""
    n, cap = 100, 40
    k2, v2, valid, dropped = dframe.dist_repartition_by_key(
        mesh1, torch.zeros(n, dtype=torch.int64), torch.ones(n, dtype=torch.float32), capacity=cap)
    assert int(dropped) == n - cap
    assert int(valid.sum()) == cap
    assert float(v2[valid].sum()) == cap


def test_dist_repartition_accepts_chunked_inputs(mesh1):
    rng = np.random.default_rng(6)
    n = 600
    t = store.Table.from_arrays({"k": rng.integers(0, 37, n), "v": rng.normal(size=n)},
                                chunk_rows=100)
    key_chunks = [t.columns["k"].chunk_physical(i) for i in range(t.n_chunks)]
    val_chunks = [t.columns["v"].chunk_physical(i) for i in range(t.n_chunks)]
    k2, v2, valid, dropped = dframe.dist_repartition_by_key(mesh1, key_chunks, val_chunks,
                                                            capacity=n, device="cpu")
    km, vm, validm, droppedm = dframe.dist_repartition_by_key(
        mesh1, _t(np.concatenate(key_chunks)), _t(np.concatenate(val_chunks)), capacity=n)
    assert int(dropped) == int(droppedm) == 0
    assert v2.dtype == torch.float64
    for a, b in ((k2, km), (v2, vm), (valid, validm)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("n,dtype", [(700, np.float32), (256, np.float32), (1000, np.float64)])
def test_quantize_roundtrip_and_error_feedback(n, dtype):
    rng = np.random.default_rng(3)
    xn = rng.normal(size=n).astype(dtype)
    x = _t(xn)
    q, s, r = compression.quantize(x)
    # the same codes and scales as the JAX package's, residual too
    jq, js, jr = (np.asarray(a) for a in j_compression.quantize(jnp.asarray(xn)))
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)
    np.testing.assert_array_equal(r.numpy(), jr)
    deq = compression.dequantize(q, s, n)
    # error bound: half a quantization step per block
    step = float(s.max())
    assert float((x - deq).abs().max()) <= 0.51 * step
    np.testing.assert_allclose((x - deq).numpy(), r.numpy(), atol=1e-6)
    # feeding the residual back recovers the lost mass
    q2, s2, r2 = compression.quantize(torch.zeros_like(x), resid=r)
    jq2, js2, _ = j_compression.quantize(jnp.zeros_like(jnp.asarray(xn)), resid=jnp.asarray(jr))
    np.testing.assert_array_equal(q2.numpy(), np.asarray(jq2))
    np.testing.assert_array_equal(s2.numpy(), np.asarray(js2))
    deq2 = compression.dequantize(q2, s2, n)
    np.testing.assert_allclose((deq + deq2).numpy(), xn, atol=2e-2)
    # all-zero input: scale falls back to 1, residual exactly zero
    qz, sz, rz = compression.quantize(torch.zeros(256, dtype=torch.float32))
    assert bool((qz == 0).all()) and bool((sz == 1.0).all()) and bool((rz == 0).all())


def test_compressed_mean_single_rank(mesh1):
    rng = np.random.default_rng(4)
    g = _t(rng.normal(size=512).astype(np.float32))
    mean, resid = compression.compressed_mean(g, mesh1)
    # one-rank mean == dequantized self; adding the residual restores x
    np.testing.assert_allclose((mean + resid).numpy(), g.numpy(), atol=1e-6)
    assert dframe.COLLECTIVES["all_reduce"] == 1


def test_pipeline_single_stage_matches_sequential(mesh1):
    rng = np.random.default_rng(5)
    L, D = 3, 8
    W = (rng.normal(size=(L, D, D)) * 0.3).astype(np.float32)
    x = rng.normal(size=(4, 2, D)).astype(np.float32)
    seq = _sequential(lambda w, h: torch.tanh(h @ w), _t(W), _t(x))
    pmesh = dframe.data_mesh(axis="pipe")
    got = pipeline.pipeline_forward(pmesh, lambda w, h: torch.tanh(h @ w), _t(W), _t(x), n_layers=L)
    np.testing.assert_array_equal(got.numpy(), seq.numpy())  # bit for bit
    assert dframe.COLLECTIVES["send_recv"] == 0  # one stage sends nothing
    want = j_pipeline.pipeline_forward(jax.make_mesh((1,), ("pipe",)),
                                       lambda w, h: jnp.tanh(h @ w), jnp.asarray(W),
                                       jnp.asarray(x), n_layers=L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(KeyError):  # a data mesh has no pipe axis
        pipeline.pipeline_forward(mesh1, lambda w, h: h, _t(W), _t(x), n_layers=L)


# ----------------------------------------------------------------------
# CONFIG routing: the engine takes the sharded route end-to-end
# ----------------------------------------------------------------------
def _table(n=400, seed=6):
    rng = np.random.default_rng(seed)
    return TensorFrame.from_arrays(
        {
            "k": rng.integers(0, 11, n),
            "g": np.asarray(list("abc"))[rng.integers(0, 3, n)].astype(object),
            "v": rng.normal(size=n),
        },
        device="cpu",
    )


def test_routed_groupby_matches_local(mesh1):
    f = _table()
    specs = [("s", "sum", "v"), ("m", "mean", "v"), ("n", "size", "")]
    CONFIG.distributed = "force"
    got = f.groupby(["g", "k"]).agg(specs)
    # sum, the mean's sum and count, size
    assert dframe.ROUTED["groupby_sum"] == dframe.COLLECTIVES["all_reduce"] == 4
    CONFIG.distributed = "off"
    want = f.groupby(["g", "k"]).agg(specs)
    assert dframe.ROUTED["groupby_sum"] == 4
    np.testing.assert_allclose(got.column("s"), want.column("s"), rtol=1e-12)
    np.testing.assert_allclose(got.column("m"), want.column("m"), rtol=1e-12)
    np.testing.assert_array_equal(got.column("n"), want.column("n"))
    np.testing.assert_array_equal(got.column("g"), want.column("g"))


def test_routed_semi_and_anti_join_match_local(mesh1):
    f = _table(seed=7)
    right = TensorFrame.from_arrays({"k": np.array([1, 2, 3, 5, 8])}, device="cpu")
    CONFIG.distributed = "force"
    got_semi = f.join(right, on="k", how="semi")
    got_anti = f.join(right, on="k", how="anti")
    assert dframe.ROUTED["semi_join"] == 2
    CONFIG.distributed = "off"
    want_semi = f.join(right, on="k", how="semi")
    want_anti = f.join(right, on="k", how="anti")
    assert dframe.ROUTED["semi_join"] == 2
    np.testing.assert_array_equal(got_semi.column("v"), want_semi.column("v"))
    np.testing.assert_array_equal(got_anti.column("v"), want_anti.column("v"))
    # and to numpy truth
    k = f.column("k")
    np.testing.assert_array_equal(got_semi.column("v"), f.column("v")[np.isin(k, [1, 2, 3, 5, 8])])


def test_auto_route_stays_local_on_one_rank(mesh1):
    assert CONFIG.distributed == "auto"
    # a one-rank group: auto must not shard, however large the input
    assert not dframe.dist_enabled(1 << 30)
    _table().groupby("k").agg([("s", "sum", "v")])
    assert dframe.ROUTED["groupby_sum"] == 0
    CONFIG.distributed = "bogus"
    with pytest.raises(ValueError):
        dframe.dist_enabled(1)


def test_force_without_a_group_raises():
    assert not torch.distributed.is_initialized()
    assert not dframe.dist_enabled(1 << 30)  # auto, no group: local
    CONFIG.distributed = "force"
    with pytest.raises(dframe.ProcessGroupError):
        _table().groupby("k").agg([("s", "sum", "v")])
    with pytest.raises(dframe.ProcessGroupError):
        dframe.data_mesh()
    CONFIG.distributed = "off"
    _table().groupby("k").agg([("s", "sum", "v")])


def test_init_local_refuses_a_second_group(mesh1):
    assert mesh1.size == 1 and mesh1.rank == 0 and mesh1.shape == {"data": 1}
    with pytest.raises(dframe.ProcessGroupError):
        dframe.init_local("cpu", timeout=dist_ranks.GLOO_TIMEOUT)


@pytest.fixture(scope="module")
def tpch_port(tpch_small):
    tables, _ = tpch_small
    return tables, tpch.as_frames(tables, device="cpu")


def test_compiled_route_never_reaches_a_collective(mesh1, tpch_port):
    """Under 'force' the compiled plan still sums through the kernel itself:
    no collective in the trace (a CUDA graph could not hold one)."""
    _, frames = tpch_port
    text = sql_text("q1", SF)
    CONFIG.distributed = "force"
    plan_compile.clear_cache()
    plan_compile.reset_stats()
    CONFIG.compiled = "force"
    try:
        got = sql.execute(text, frames)
        assert plan_compile.STATS["compiles"] == 1 and plan_compile.STATS["fallbacks"] == 0
    finally:
        plan_compile.clear_cache()
    assert sum(dframe.COLLECTIVES.values()) == 0
    CONFIG.compiled = "off"
    routed = sql.execute(text, frames)
    assert dframe.ROUTED["groupby_sum"] > 0
    for name in got.column_names:
        a, b = np.asarray(got.column(name)), np.asarray(routed.column(name))
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-12)
        else:
            np.testing.assert_array_equal(a, b)


def test_streamed_route_reaches_the_hooks(mesh1, tpch_port):
    """Each chunk's partial group-by and each merge route through
    core/agg.py, as in the reference."""
    tables, _ = tpch_port
    stores = tpch.as_store(tables, chunk_rows=2048, sort_fact_by_date=True)
    text = sql_text("q1", SF)
    CONFIG.out_of_core = "force"
    CONFIG.distributed = "off"
    ooc_pipeline.reset_stats()
    want = sql.execute(text, stores, device="cpu")
    assert ooc_pipeline.STATS["pipelines"] == 1
    CONFIG.distributed = "force"
    got = sql.execute(text, stores, device="cpu")
    assert ooc_pipeline.STATS["pipelines"] == 2
    # every group sum of every chunk and merge: sum, mean's sum and count, size
    assert dframe.ROUTED["groupby_sum"] >= ooc_pipeline.STATS["chunks_streamed"]
    for name in want.column_names:
        a, b = np.asarray(got.column(name)), np.asarray(want.column(name))
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-12)
        else:
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------
# four gloo ranks against the JAX package on four forced host devices
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def four(tmp_path_factory, tpch_small):
    """The port on four gloo ranks and the JAX package on four forced host
    devices, on the same seeded inputs, run once for the session: under
    xdist the first worker to take the lock runs them into the session's
    shared temp directory and the others read its outputs."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # shared by the session's workers
    workdir = root / "dist4"
    with FileLock(str(root / "dist4.lock")):
        if not (workdir / "done").exists():
            workdir.mkdir(exist_ok=True)
            with open(workdir / "tables.pkl", "wb") as f:
                pickle.dump(tpch_small[0], f)
            jax_env = {"XLA_FLAGS": f"--xla_force_host_platform_device_count={dist_ranks.WORLD}",
                       "JAX_PLATFORMS": "cpu"}
            dist_ranks.run_ranks("ops", workdir, extra=[(["jax", str(workdir)], jax_env)])
            (workdir / "done").touch()
    ranks = []
    for r in range(dist_ranks.WORLD):
        with open(workdir / f"ops-{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    ref = dict(np.load(workdir / "jax.npz"))
    return ranks, ref, dist_ranks.inputs()


SLOTS = [f"{case}_{name}" for case in ("lossless", "skew", "overflow")
         for name in ("keys2", "vals2", "valid", "dropped")]


@pytest.mark.parametrize("key", ["mask", "gsum_int"] + SLOTS)
def test_four_ranks_equal_the_jax_package_exactly(four, key):
    ranks, ref, _ = four
    for out in ranks:
        assert out[key].dtype == ref[key].dtype, (key, out[key].dtype, ref[key].dtype)
        np.testing.assert_array_equal(out[key], ref[key])


def _close_sums(got, want):
    """float32 group sums: within 1e-6 of the largest |sum|."""
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_four_rank_group_sums_and_pipeline_near_the_jax_package(four):
    ranks, ref, x = four
    for out in ranks:
        _close_sums(out["gsum"], ref["gsum"])
        np.testing.assert_allclose(out["pipe"], ref["pipe"], rtol=1e-5, atol=1e-5)
    # the pipeline is the sequential loop, bit for bit
    seq = _sequential(lambda w, h: torch.tanh(h @ w), _t(x["pipe_w"]), _t(x["pipe_x"]))
    np.testing.assert_array_equal(ranks[0]["pipe"], seq.numpy())
    assert ranks[0]["pipe_error"] == "6 layers do not split over 4 stages"


def test_four_rank_repartition_lossless_skew_and_overflow(four):
    out, _, x = four[0][0], four[1], four[2]
    domain = x["domain"]
    for case, keys, vals in (("lossless", x["gkeys"], x["gvals"]),
                             ("skew", x["skew_keys"], x["skew_vals"])):
        valid = out[f"{case}_valid"]
        assert int(out[f"{case}_dropped"]) == 0
        assert valid.sum() == (keys >= 0).sum()  # every row but the nulls
        k2, v2 = out[f"{case}_keys2"][valid], out[f"{case}_vals2"][valid]
        np.testing.assert_array_equal(np.sort(k2), np.sort(keys[keys >= 0]))
        np.testing.assert_array_equal(np.sort(v2), np.sort(vals[keys >= 0]))
    # each key's rows land on exactly one rank
    slots = out["lossless_keys2"].reshape(dist_ranks.WORLD, -1)
    homes = [{r for r in range(dist_ranks.WORLD) if (slots[r] == k).any()} for k in range(domain)]
    assert all(len(h) == 1 for h in homes)
    valid = out["overflow_valid"]
    assert int(out["overflow_dropped"]) == len(x["over_keys"]) - int(valid.sum()) > 0


def test_four_rank_chunked_repartition_equals_the_array_one(four):
    for out in four[0]:
        for name in ("keys2", "vals2", "valid", "dropped"):
            np.testing.assert_array_equal(out[f"chunks_{name}"], out[f"lossless_{name}"])


def test_shard_local_functions_combine_to_the_collectives(four):
    """Each rank's shard-local part, combined in rank order as the
    collective combines it: a sum for a replicated output, concatenation
    for a sharded one, the all-to-all's exchange for the repartition."""
    ranks, _, x = four
    n = len(x["probe"])
    _close_sums(sum(o["gsum_shard"] for o in ranks), ranks[0]["gsum"])
    np.testing.assert_array_equal(np.concatenate([o["mask_shard"] for o in ranks])[:n],
                                  ranks[0]["mask"])
    sends = [o["lossless_send"] for o in ranks]
    for part, name in ((0, "keys2"), (1, "vals2")):
        recv = np.concatenate([np.concatenate([s[part][d] for s in sends]) for d in range(len(sends))])
        np.testing.assert_array_equal(recv, ranks[0][f"lossless_{name}"])
    assert sum(int(s[2]) for s in sends) == int(ranks[0]["lossless_dropped"])


def test_four_rank_compressed_mean(four):
    ranks, ref, x = four
    g = x["grads"]
    exact = g.mean(axis=0)
    for r, out in enumerate(ranks):
        err = np.abs(out["cmean"] - exact).max()
        scale = np.abs(exact).max() + 1e-6
        assert err < 0.02 * max(scale, 1.0), err
        # error feedback: the residual is this rank's quantization error
        q, s, _ = compression.quantize(_t(g[r]))
        deq = (q.numpy().astype(np.float32).reshape(-1, 256) * s.numpy()).reshape(-1)[:1024]
        np.testing.assert_allclose(g[r] - deq, out["cresid"], atol=1e-6)
        np.testing.assert_allclose(out["cmean"], ref["cmean"][r], rtol=1e-6, atol=1e-7)
        # (jitted, the reference may fuse x - q * s into one rounding)
        np.testing.assert_allclose(out["cresid"], ref["cresid"][r], atol=1e-6)


def test_four_rank_subgroup(four):
    ranks = four[0]
    for out in ranks[:2]:
        _close_sums(out["sub_gsum"], ranks[0]["gsum"])
    for r in (2, 3):
        assert ranks[r]["sub_error"] == f"rank {r} is outside a mesh of the first 2 ranks"


@pytest.mark.parametrize("q", dist_ranks.TPCH_QUERIES)
def test_four_rank_routed_tpch_equals_local(four, q):
    for out in four[0]:
        got, want = out["routed"][q], out["local"][q]
        assert list(got) == list(want)
        for name in want:
            if want[name].dtype.kind == "f":
                np.testing.assert_allclose(got[name], want[name], rtol=1e-12, atol=0)
            else:
                np.testing.assert_array_equal(got[name], want[name])


def test_four_rank_routing_counts(four):
    for out in four[0]:
        routed = out["routed_counts"]
        assert routed["groupby_sum"] > 0 and routed["semi_join"] > 0
        assert out["routed_collectives"]["all_reduce"] == routed["groupby_sum"]
        assert out["routed_collectives"]["all_gather"] == routed["semi_join"]
        # auto: TPC-H at SF 0.002 is under dist_min_rows, so nothing routes
        assert out["unrouted_counts"] == {"groupby_sum": 0, "semi_join": 0, "repartition": 0}
