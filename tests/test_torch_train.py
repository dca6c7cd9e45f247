"""The port's training path (``repro_torch.train``, ``lm.loss_fn``,
``data.tokens``, ``launch.train``) against the JAX package's.

* ``loss_fn`` and every gradient leaf against
  ``jax.value_and_grad(repro.models.lm.loss_fn)`` for the reduced float32
  config of each of the ten registered families, the JAX weights carried
  over by ``load_reference_params`` and the gradients carried back by
  ``reference_tree`` (cross-attention gates opened to 0.5);
* adamw and adafactor train steps against the JAX ``make_train_step``
  over 3 steps, at one and at 2 microbatches (Kimi-K2's reduced config
  keeps its adafactor and bfloat16 gradient accumulation);
* gradient accumulation against the full batch, the loss falling, the
  remat policies, checkpoints, the fault-tolerant loop, ``curate`` and
  ``token_batches`` against the JAX package's, and the launcher.

Everything runs on the CPU, where the port takes the kernels' plain
versions.  JAX runs with its default 32-bit types for the models, as the
JAX package's model and runtime tests do; the curation comparison turns
x64 on for the JAX engine, which needs exact int64 keys.
"""
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core  # noqa: F401  (the JAX engine, for curate; sets x64 at import)
from repro.configs import ARCHS as JARCHS
from repro.configs import get as jget
from repro.data import tokens as jtok
from repro.models import lm as jlm
from repro.models.config import reduced as jreduced
from repro.train.train_step import make_train_step as jmake_train_step
from repro.train.optimizer import get_optimizer as jget_optimizer
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import get as tget
from repro_torch.data import tokens as ttok
from repro_torch.kernels import ops
from repro_torch.models import lm as tlm
from repro_torch.models.config import reduced as treduced
from repro_torch.train import checkpoint
from repro_torch.train.loop import PrefetchIterator, TrainLoop
from repro_torch.train.train_step import init_train_state, make_train_step

#: float32 loss and gradients: rtol, and atol relative to the largest
#: |value| of the leaf (sums in another order than XLA's, 2 layers)
GRAD_TOL = 1e-4
#: train steps: loss and grad norm (rtol), and the weights after each
#: step (atol; adamw moves a weight by at most lr = 3e-4 a step).  With
#: bfloat16 accumulation (Kimi-K2) a gradient on either side of a bf16
#: rounding boundary differs by 2^-8, and so does its update, which
#: adafactor makes up to a few times lr = 1e-3 a step: 1e-4 over 3 steps
STEP_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "params": 2e-5, "params_bf16_acc": 1e-4}
CROSS_GATE = 0.5


@pytest.fixture(autouse=True, scope="module")
def _x64_off(_x64_policy):
    # the conftest policy leaves x64 off for this file's prefix; pinned
    # here as well, since importing repro.core turns it on
    jax.config.update("jax_enable_x64", False)
    yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the models here are tiny: one intra-op thread is as fast alone, and
    # under the suite's parallel workers it does not oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_every_registered_family_is_compared():
    assert sorted(TARCHS) == sorted(JARCHS) and len(TARCHS) == 10


def _configs(arch: str, **over):
    if arch == "qwen3-14b":
        over.setdefault("n_kv_heads", 2)  # reduced() would make it MHA
    return jreduced(jget(arch), **over), treduced(tget(arch), **over)


def _jparams(jcfg, seed=0):
    """The JAX package's weights, every cross-attention gate at CROSS_GATE."""
    p = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    if "cross_blocks" in p:
        attn = dict(p["cross_blocks"]["attn"], gate=jnp.full_like(
            p["cross_blocks"]["attn"]["gate"], CROSS_GATE))
        p = dict(p, cross_blocks=dict(p["cross_blocks"], attn=attn))
    return p


def _batch(cfg, B: int, S: int, seed: int = 0):
    """The same training batch for both packages: (jax batch, torch batch)."""
    rng = np.random.default_rng(seed)
    arrs = {}
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    if cfg.embed_inputs:
        arrs["tokens"] = toks[:, :-1]
    else:
        arrs["embeddings"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    arrs["labels"] = toks[:, 1:]
    if cfg.cross_attn_every:
        arrs["img_embed"] = rng.normal(size=(B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    tb = {name: torch.from_numpy(np.ascontiguousarray(a)) for name, a in arrs.items()}
    for name in ("tokens", "labels"):
        if name in tb:
            tb[name] = tb[name].long()
    return {name: jnp.asarray(a) for name, a in arrs.items()}, tb


def _close_tree(got, want, rtol, atol_rel, msg=""):
    """Leaf by leaf: |got - want| <= atol_rel * max|want leaf| + rtol |want|."""
    g_leaves = jax.tree_util.tree_leaves_with_path(got)
    w_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g_leaves] == [p for p, _ in w_leaves], msg
    for (path, g), (_, w) in zip(g_leaves, w_leaves):
        w = np.asarray(w, np.float32)
        scale = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(np.asarray(g, np.float32), w, rtol=rtol,
                                   atol=atol_rel * scale + 1e-30,
                                   err_msg=f"{msg} {jax.tree_util.keystr(path)}")


# ----------------------------------------------------------------------
# loss and gradients, every family
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(TARCHS))
def test_loss_and_every_gradient_leaf_match_jax(arch):
    jcfg, tcfg = _configs(arch)
    jp = _jparams(jcfg)
    jb, tb = _batch(tcfg, 2, 16)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jcfg, p, b), has_aux=True))(jp, jb)
    tp = tlm.load_reference_params(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    tp.requires_grad_(True)
    names, leaves = zip(*tp.named_parameters())
    tloss, taux = tlm.loss_fn(tcfg, tp, tb)
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=GRAD_TOL)
    assert float(taux["tokens"]) == float(jaux["tokens"]) == 2 * 16
    _close_tree(tlm.reference_tree(dict(zip(names, grads))), jgrads, GRAD_TOL, GRAD_TOL, arch)


def test_loss_mask_and_no_graph_while_serving():
    """A loss mask weights the mean as the JAX package's does; frozen
    weights (serving) build no autograd graph."""
    jcfg, tcfg = _configs("phi3-mini-3.8b")
    jp = _jparams(jcfg)
    jb, tb = _batch(tcfg, 2, 8, seed=3)
    mask = (np.arange(8)[None, :] < np.array([[5], [8]])).astype(np.float32)
    jb["loss_mask"], tb["loss_mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    jloss, jaux = jlm.loss_fn(jcfg, jp, jb)
    tp = tlm.load_reference_params(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    tloss, taux = tlm.loss_fn(tcfg, tp, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=GRAD_TOL)
    assert float(taux["tokens"]) == float(jaux["tokens"]) == 13
    assert not tloss.requires_grad and tlm.prefill(tcfg, tp, tb).grad_fn is None


@pytest.mark.parametrize("remat", ["nothing", "dots", "none"])
def test_remat_policies_give_the_same_gradients(remat):
    """``cfg.remat`` changes what is kept for the backward, not the result;
    the rwkv6 and hybrid stacks checkpoint their blocks too."""
    for arch in ("qwen3-14b", "rwkv6-7b", "zamba2-2.7b"):
        base = treduced(tget(arch))
        cfg = dataclasses.replace(base, remat=remat)
        p = tlm.init_params(base, torch.Generator("cpu").manual_seed(2), device="cpu")
        p.requires_grad_(True)
        _, tb = _batch(cfg, 2, 12, seed=4)
        want = torch.autograd.grad(tlm.loss_fn(dataclasses.replace(base, remat="none"), p, tb)[0],
                                   list(p.parameters()))
        got = torch.autograd.grad(tlm.loss_fn(cfg, p, tb)[0], list(p.parameters()))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)


def test_reference_tree_inverts_load_reference_params():
    jcfg, tcfg = _configs("llama-3.2-vision-90b")
    jp = jax.tree.map(np.asarray, _jparams(jcfg, seed=1))
    back = tlm.reference_tree(tlm.load_reference_params(tcfg, jp, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------
# train steps against the JAX package's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch,opt", [
    ("phi3-mini-3.8b", "adamw"),
    ("phi3-mini-3.8b", "adafactor"),
    ("rwkv6-7b", "adamw"),
    ("kimi-k2-1t-a32b", "adafactor"),  # its own: bf16 gradient accumulation
])
@pytest.mark.parametrize("micro", [1, 2])
def test_train_steps_match_jax(arch, opt, micro):
    jcfg, tcfg = _configs(arch, optimizer=opt, microbatches=micro)
    if arch == "kimi-k2-1t-a32b":
        assert tcfg.grad_dtype == "bfloat16" and tcfg.optimizer == "adafactor"
    jp = _jparams(jcfg, seed=micro)
    jstate = {"params": jp, "opt": jget_optimizer(opt).init(jp), "step": jnp.zeros((), jnp.int32)}
    tparams = tlm.load_reference_params(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    tstate = init_train_state(tcfg, params=tparams)
    jstep = jax.jit(jmake_train_step(jcfg))
    tstep = make_train_step(tcfg)
    atol = STEP_TOL["params_bf16_acc" if tcfg.grad_dtype == "bfloat16" else "params"]
    for i in range(3):
        jb, tb = _batch(tcfg, 4, 12, seed=10 + i)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=STEP_TOL["loss"])
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=STEP_TOL["grad_norm"])
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(
                tlm.reference_tree(tstate["params"])), jax.tree.leaves(jstate["params"])):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=atol,
                                       err_msg=f"{arch} step {i} {jax.tree_util.keystr(path)}")
    assert tstate["step"] == int(jstate["step"]) == 3
    if opt == "adafactor":  # the factored moments, stacked as the JAX package keeps them
        # bf16 accumulation: a gradient on either side of a bf16 rounding
        # boundary differs by 2^-8, its square by 2^-7
        rtol = 1e-2 if tcfg.grad_dtype == "bfloat16" else 1e-3
        jm_ = jstate["opt"]["moments"]
        for key, mom in tstate["opt"]["moments"].items():
            want = jm_
            for part in key.split("."):
                want = want[part]
            for name in mom:
                np.testing.assert_allclose(mom[name].numpy(), np.asarray(want[name]),
                                           rtol=rtol, atol=1e-12, err_msg=f"{key}/{name}")


def _tiny(**kw):
    kw.setdefault("microbatches", 2)
    return treduced(tget("phi3-mini-3.8b"), n_layers=2, **kw)


def _batches(cfg, n, B=4, S=16, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab, (B, S + 1))
        yield {"tokens": torch.as_tensor(toks[:, :-1]), "labels": torch.as_tensor(toks[:, 1:])}


def _state(cfg, seed):
    return init_train_state(cfg, torch.Generator("cpu").manual_seed(seed), device="cpu")


def test_grad_accumulation_matches_full_batch():
    cfg1, cfg4 = _tiny(microbatches=1), _tiny(microbatches=4)
    s1, s4 = _state(cfg1, 1), _state(cfg4, 1)
    batch = next(_batches(cfg1, 1, B=8))
    s1b, m1 = make_train_step(cfg1)(s1, batch)
    s4b, m4 = make_train_step(cfg4)(s4, batch)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m4["grad_norm"]), rtol=1e-5)
    for a, b in zip(s1b["params"].parameters(), s4b["params"].parameters()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("opt,steps,drop", [("adamw", 30, 0.5), ("adafactor", 40, 0.3)])
def test_train_step_reduces_loss(opt, steps, drop):
    cfg = _tiny(optimizer=opt)
    state = _state(cfg, 0)
    step = make_train_step(cfg)
    batch = next(_batches(cfg, 1))
    losses = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - drop, losses[:3] + losses[-3:]
    assert state["step"] == steps


# ----------------------------------------------------------------------
# checkpoints and the loop
# ----------------------------------------------------------------------
def test_checkpoint_roundtrip_keeps_values_dtypes_and_trainability(tmp_path):
    cfg = _tiny(param_dtype="bfloat16", compute_dtype="bfloat16")
    state = _state(cfg, 2)
    state, _ = make_train_step(cfg)(state, next(_batches(cfg, 1)))
    d = str(tmp_path / "ckpt")
    checkpoint.save(state, d, 7)
    assert checkpoint.latest_step(d) == 7
    assert not any(name.startswith(".tmp") for name in os.listdir(d))
    like = _state(cfg, 99)
    restored = checkpoint.restore(d, like, device="cpu")
    assert restored["step"] == 1 and isinstance(restored["params"], tlm.Params)
    for (n, a), (m, b) in zip(state["params"].named_parameters(),
                              restored["params"].named_parameters()):
        assert n == m and b.dtype == a.dtype == torch.bfloat16 and b.requires_grad
        assert torch.equal(a, b)
    for key in ("m", "v", "master"):
        for name, t in state["opt"][key].items():
            assert torch.equal(t, restored["opt"][key][name])
    assert restored["opt"]["step"] == 1


def test_checkpoint_prune(tmp_path):
    cfg = _tiny()
    state = _state(cfg, 2)
    d = str(tmp_path / "ckpt")
    for s in (1, 2, 3, 4, 5):
        checkpoint.save(state, d, s)
    checkpoint.prune(d, keep=2)
    assert checkpoint.latest_step(d) == 5
    assert sorted(int(x.split("_")[1]) for x in os.listdir(d)) == [4, 5]


def test_loop_crash_recovery(tmp_path):
    cfg = _tiny()
    d = str(tmp_path / "ckpt")
    step = make_train_step(cfg)
    loop = TrainLoop(step, _state(cfg, 3), _batches(cfg, 6), ckpt_dir=d, ckpt_every=2)
    out = loop.run(6)
    assert out["final_step"] == 6
    # a second run resumes from the checkpoint, not from scratch
    loop2 = TrainLoop(step, _state(cfg, 99), _batches(cfg, 10), ckpt_dir=d, ckpt_every=5)
    out2 = loop2.run(9)
    assert out2["final_step"] == 9
    assert len(out2["metrics"]) == 3  # only steps 6, 7, 8 executed
    for a, b in zip(loop.state["params"].parameters(), _state(cfg, 99)["params"].parameters()):
        assert not torch.equal(a, b)


def test_loop_retries_transient_fault():
    cfg = _tiny()
    fails = {"n": 0}

    def flaky(step_no):
        if step_no == 1 and fails["n"] < 2:
            fails["n"] += 1
            raise RuntimeError("injected node flake")

    loop = TrainLoop(make_train_step(cfg), _state(cfg, 4), _batches(cfg, 3), max_step_retries=3,
                     fault_hook=flaky)
    out = loop.run(3)
    assert out["final_step"] == 3 and fails["n"] == 2


def test_loop_fails_after_retry_budget(tmp_path):
    cfg = _tiny()

    def always_fail(step_no):
        raise RuntimeError("hard fault")

    loop = TrainLoop(make_train_step(cfg), _state(cfg, 4), _batches(cfg, 2),
                     ckpt_dir=str(tmp_path / "c"), max_step_retries=1, fault_hook=always_fail)
    with pytest.raises(RuntimeError):
        loop.run(2)
    assert checkpoint.latest_step(str(tmp_path / "c")) is not None  # emergency checkpoint


def test_loop_checkpoints_at_the_next_step_after_sigterm(tmp_path):
    cfg = _tiny()
    d = str(tmp_path / "ckpt")

    def preempt_at_2(step_no):
        if step_no == 2:
            loop._preempted = True  # what the SIGTERM handler sets

    loop = TrainLoop(make_train_step(cfg), _state(cfg, 5), _batches(cfg, 8), ckpt_dir=d,
                     ckpt_every=0, fault_hook=preempt_at_2)
    out = loop.run(8)
    assert out["final_step"] == 3 and checkpoint.latest_step(d) == 3


def test_prefetch_straggler_skip():
    def slow_gen():
        yield 1
        yield 2
        time.sleep(1.0)  # straggler
        yield 3

    it = PrefetchIterator(slow_gen(), deadline_s=0.2)
    got = [next(it), next(it), next(it)]
    assert got == [1, 2, 2]  # the spare reused
    assert it.skipped == 1


# ----------------------------------------------------------------------
# data and the launcher
# ----------------------------------------------------------------------
def test_curate_and_token_batches_match_jax():
    """The curation plan on the port's TensorFrame (CPU) gives the JAX
    engine's doc ids and weights; the batcher the same tokens."""
    corpus = jtok.synthetic_corpus(2000, seed=0)
    tcorpus = ttok.synthetic_corpus(2000, seed=0)
    assert corpus.keys() == tcorpus.keys()
    for name in corpus:
        np.testing.assert_array_equal(tcorpus[name], corpus[name])
    mixture = {"web": 1.0, "books": 2.0, "wiki": 1.5, "code": 1.0}
    with jax.enable_x64(True):
        jids, jw = jtok.curate(corpus, mixture=mixture)
    ops.reset_launches()
    tids, tw = ttok.curate(tcorpus, mixture=mixture, device="cpu")
    assert sum(ops.LAUNCHES.values()) == 0  # the CPU takes the plain versions
    assert len(tids) > 100 and tids.dtype == np.int64
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tw, jw, rtol=1e-12)
    for jb, tb in zip(jtok.token_batches(jids, jw, 256, 4, 16, seed=1, steps=3),
                      ttok.token_batches(tids, tw, 256, 4, 16, seed=1, steps=3)):
        for name in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[name], jb[name])


def test_launch_train_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    out = train.main(["--arch", "rwkv6-7b", "--device", "cpu", "--steps", "4", "--batch", "4",
                      "--seq", "16", "--ckpt-dir", str(tmp_path / "c"), "--ckpt-every", "2"])
    assert out["final_step"] == 4 and len(out["metrics"]) == 4
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in out["metrics"])
    assert checkpoint.latest_step(str(tmp_path / "c")) == 4
    assert "curated corpus" in capsys.readouterr().out
