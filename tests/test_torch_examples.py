"""The six example twins (``repro_torch.examples``) on the CPU, against
the scripts under ``examples/`` where those run here:

* ``quickstart`` and ``sql_quickstart`` print the reference script's
  lines (the reference run in this process, its output captured), but
  for a frame repr's device suffix and floats of a shown table, which
  are held within rtol 1e-8 (the order of the sums differs);
* ``tpch_analytics --sf 0.002 --row-engine`` prints its 22 rows;
* ``serve_lm`` serves 12 of 12 requests, each to its ``max_new``, and
  with the JAX example's weights carried over its first three requests'
  tokens equal the JAX engine's;
* ``train_lm`` at a reduced width: the loss falls and a checkpoint is
  written;
* ``distributed_groupby`` at world 1 in this process and at world 2 in
  two gloo ranks: sums as ``np.add.at``'s, the semi join's count as
  ``np.isin``'s, the shuffle lossless;
* without a card, every twin's default device raises.
"""
import contextlib
import io
import re
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import dist_ranks
from repro_torch.examples import (
    distributed_groupby, quickstart, serve_lm, sql_quickstart, tpch_analytics, train_lm,
)

ROOT = Path(__file__).resolve().parents[1]
FLOAT_RTOL = 1e-8
TWINS = {"quickstart": quickstart, "sql_quickstart": sql_quickstart,
         "tpch_analytics": tpch_analytics, "serve_lm": serve_lm, "train_lm": train_lm,
         "distributed_groupby": distributed_groupby}


@pytest.fixture(autouse=True, scope="module")
def _x64_on(_x64_policy):
    # the conftest policy turns x64 off for this file's prefix; the
    # reference engine needs exact int64 keys
    jax.config.update("jax_enable_x64", True)
    yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the twins run small here: one intra-op thread is about as fast alone,
    # and under the suite's parallel workers it does not oversubscribe the
    # cores (with a thread a core in six workers the train test took 60
    # times as long)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stdout(fn) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


_DEVICE_SUFFIX = re.compile(r"; (cpu|cuda(:\d+)?)\)$")


def _tokens(line: str) -> list:
    """A shown table's line as its cells: padding and rule widths follow
    the printed values, so only the values are compared."""
    if line and set(line) <= {"-", "+"}:
        return ["rule"] * line.count("+")
    return [t for t in re.split(r"\s+|\|", line) if t]


def _same_line(got: str, want: str) -> bool:
    if got.startswith("TensorFrame("):
        got = _DEVICE_SUFFIX.sub(")", got)
    if got == want:
        return True
    a, b = _tokens(got), _tokens(want)
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x == y:
            continue
        try:
            fx, fy = float(x), float(y)
        except ValueError:
            return False
        if not ("." in x + y or "e" in x + y) or not np.isclose(fx, fy, rtol=FLOAT_RTOL, atol=0):
            return False
    return True


@pytest.mark.parametrize("name", ["quickstart", "sql_quickstart"])
def test_quickstarts_print_the_reference_scripts_lines(name):
    want = _stdout(lambda: runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                                          run_name="__main__"))
    got = _stdout(lambda: TWINS[name].main(["--device", "cpu"]))
    assert len(got) == len(want), (len(got), len(want))
    bad = [(i, g, w) for i, (g, w) in enumerate(zip(got, want)) if not _same_line(g, w)]
    assert not bad, bad[:5]


def test_quickstart_results_on_the_cpu():
    out = quickstart.run("cpu")
    top = out["results"]["top"]
    assert out["results"]["filtered"] > 0
    assert sorted(top["segment"]) == ["BUILDING", "HOUSEHOLD", "MACHINERY"]
    assert list(top["revenue"]) == sorted(top["revenue"], reverse=True)
    assert int(np.sum(top["orders"])) <= out["results"]["filtered"]


def test_tpch_analytics_prints_22_rows_with_the_row_engine():
    lines = _stdout(lambda: tpch_analytics.main(
        ["--sf", "0.002", "--row-engine", "--device", "cpu"]))
    rows = [ln for ln in lines if re.match(r"^q\d+ ", ln)]
    assert [ln.split()[0] for ln in rows] == [f"q{i}" for i in range(1, 23)]
    assert all(re.match(r"^q\d+\s+[\d.]+ms\s+[\d.]+ms\s+[\d.]+x$", ln) for ln in rows), rows
    assert lines[0].startswith("TPC-H sf=0.002: lineitem=")


def _served(out) -> None:
    reqs = out["requests"]
    assert out["lines"][0].startswith(f"served 12/12 requests, {sum(r.max_new for r in reqs)} ")
    assert all(r.done and len(r.out) == r.max_new for r in reqs)


def test_serve_lm_serves_every_request_to_its_max_new():
    _served(serve_lm.run("cpu"))


@pytest.fixture
def x32():
    # the JAX example draws its weights with JAX's default 32-bit types
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


def test_serve_lm_with_the_jax_examples_weights_gives_its_tokens(x32):
    from repro.configs import get as jget
    from repro.models import lm as jlm
    from repro.models.config import reduced as jreduced
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServeEngine as JServeEngine
    from repro_torch.models import lm

    jcfg = jreduced(jget("phi3-mini-3.8b"), n_layers=4, d_model=128, n_heads=4,
                    n_kv_heads=4, head_dim=32, d_ff=256, vocab=2048)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    params = lm.load_reference_params(serve_lm.config(), jax.tree.map(np.asarray, jparams), "cpu")
    out = serve_lm.run("cpu", params=params)
    _served(out)
    # the JAX engine on the script's 12 requests (about a second here)
    jreqs = [JRequest(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
             for r in serve_lm.requests(serve_lm.config())]
    JServeEngine(jcfg, jparams, batch_slots=serve_lm.SLOTS, max_len=128).run(jreqs, max_steps=600)
    for got, want in zip(out["requests"][:3], jreqs[:3]):
        assert got.out == [int(t) for t in want.out], got.rid


def test_train_lm_loss_falls_and_a_checkpoint_is_written(tmp_path):
    small = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
                 vocab=256)
    out = train_lm.run(steps=40, ckpt_dir=str(tmp_path), device="cpu", overrides=small)
    losses = out["losses"]
    assert out["final_step"] == 40 and len(losses) == 40
    assert losses[-1] < losses[0]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses
    assert (tmp_path / "step_00000040").is_dir()
    assert out["lines"][-1].startswith(f"loss: {losses[0]:.3f} -> ")


def _check_groupby(out: dict, world: int) -> None:
    rng = np.random.default_rng(0)
    keys = rng.integers(0, distributed_groupby.DOMAIN, distributed_groupby.N).astype(np.int32)
    vals = rng.normal(size=distributed_groupby.N).astype(np.float32)
    check = np.zeros(distributed_groupby.DOMAIN, np.float32)
    np.add.at(check, keys, vals)
    err = float(np.abs(np.asarray(out["sums"]) - check).max())
    assert err == out["max_err"] and err <= 1e-3
    assert f"{{'data': {world}}}" in out["lines"][0] and f"max_err={err:.2e}" in out["lines"][0]
    assert out["matched"] == out["expected_matched"] > 0
    assert out["preserved"] == distributed_groupby.N and out["dropped"] == 0


def test_distributed_groupby_at_world_1():
    lines = _stdout(lambda: distributed_groupby.main(["--device", "cpu"]))
    assert not torch.distributed.is_initialized()  # torn down at exit
    from repro_torch.dist import dframe

    mesh = dframe.init_local("cpu", timeout=dist_ranks.GLOO_TIMEOUT)
    try:
        out = distributed_groupby.run(mesh, "cpu")
    finally:
        torch.distributed.destroy_process_group()
    _check_groupby(out, 1)
    assert lines == out["lines"]


def test_distributed_groupby_at_world_2(tmp_path):
    outs = dist_ranks.run_ranks("example", tmp_path, world=2)
    for out in outs:
        _check_groupby(out, 2)
    np.testing.assert_array_equal(outs[0]["sums"], outs[1]["sums"])


@pytest.mark.parametrize("name", sorted(TWINS))
def test_every_twin_wants_a_card_unless_asked_for_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TWINS[name].main([])
