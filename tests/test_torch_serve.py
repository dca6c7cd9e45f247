"""The port's serving engine (``repro_torch.serve.engine``) and launcher
against the JAX package's ``ServeEngine``, on the same weights
(``load_reference_params``), at reduced float32 configs on the CPU.

Greedy tokens must be identical: both engines take the first maximum of
float32 logits.  Every run uses more requests than slots, so slots are
refilled: a dense slot starts a new ``kv_start`` window, an RWKV6 slot
inherits the previous request's recurrent state (a caveat of the
reference that the port keeps).  One run goes past ``max_len``, where
the JAX package's cache write clamps to the last position.
"""
import numpy as np
import pytest
import torch

import jax

from repro.configs import get as jget
from repro.models import lm as jlm
from repro.models.config import reduced as jreduced
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get as tget
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.models.config import reduced as treduced
from repro_torch.serve.engine import Request, ServeEngine


def _engines(arch: str, slots: int, max_len: int):
    over = {"n_kv_heads": 2} if arch == "qwen3-14b" else {}
    jcfg, tcfg = jreduced(jget(arch), **over), treduced(tget(arch), **over)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = tlm.load_reference_params(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return (JServeEngine(jcfg, jparams, batch_slots=slots, max_len=max_len),
            ServeEngine(tcfg, tparams, batch_slots=slots, max_len=max_len))


def _prompts(seed: int, n: int, vocab: int, lo: int = 3, hi: int = 12):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, rng.integers(lo, hi)).astype(np.int32) for _ in range(n)]


def _serve_both(arch, slots, max_len, prompts, max_new):
    jeng, teng = _engines(arch, slots, max_len)
    jreqs = [JRequest(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    teng.run(treqs)
    return jeng, teng, jreqs, treqs


@pytest.mark.parametrize("arch", ["qwen3-14b", "rwkv6-7b"])
def test_engine_tokens_equal_the_jax_engine_with_slot_reuse(arch):
    prompts = _prompts(11, 5, 256)
    ops.reset_launches()
    jeng, teng, jreqs, treqs = _serve_both(arch, slots=2, max_len=64, prompts=prompts, max_new=6)
    assert teng.steps == jeng.steps
    assert all(r.done for r in treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(len(r.out) == 6 for r in treqs)
    assert teng.state["pos"] == int(jeng.state["pos"]) == teng.steps
    assert sum(ops.LAUNCHES.values()) == 0  # the CPU takes the plain versions


def test_engine_past_max_len_clamps_the_cache_write_as_the_jax_engine():
    """The shared position runs past max_len = 8 while slots keep being
    refilled; the cache write lands on the last position, as
    ``dynamic_update_slice`` clamps it."""
    prompts = _prompts(5, 5, 256, lo=4, hi=7)
    jeng, teng, jreqs, treqs = _serve_both("qwen3-14b", slots=2, max_len=8, prompts=prompts,
                                           max_new=4)
    assert teng.state["pos"] > teng.max_len
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    np.testing.assert_allclose(teng.state["k"].numpy(), np.asarray(jeng.state["k"]),
                               rtol=1e-4, atol=1e-4)


def test_launcher_serves_on_the_cpu(capsys):
    reqs = tserve.main(["--arch", "rwkv6-7b", "--device", "cpu", "--requests", "5",
                        "--slots", "2", "--max-new", "3"])
    assert len(reqs) == 5 and all(r.done and len(r.out) == 3 for r in reqs)
    out = capsys.readouterr().out
    assert "arch=rwkv6-7b device=cpu served 5/5 requests, 15 tokens" in out


def test_launcher_wants_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "phi3-mini-3.8b", "--requests", "1"])
