"""The port's MoE FFN, Mamba2 (SSD) block and cross-attention against
the JAX package's, on the same weights and inputs (numpy, from a seed),
float32 within rtol = atol = 1e-5.

* ``layers.moe_ffn`` at prefill and decode token counts: tied router
  probabilities (``jax.lax.top_k`` puts the lower index first), a decode
  step whose capacity C = 1 drops token-slots, a shared expert;
  ``moe_aux_loss``;
* ``mamba.ssd_chunked`` and ``mamba.mamba_block`` at T 32 (chunk 8),
  T 37 (chunk 1) and T 1, with and without an initial state; at T 128
  (two chunks of 64) ``ssd_chunked`` against the reference with its
  cumulative sums accumulated as the port's are, and float64 witnesses:
  the recurrence step by step, the reference's own block and whole
  zamba2 model run in float64;
* ``layers.attention`` with ``kv_x`` (no RoPE, not causal, Sq above and
  below Sk) and an open gate, and ``layers.decode_attention`` over a
  cache it does not update, masked at ``kv_len``.
"""
import contextlib
import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get as jget
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import mamba as jmamba
from repro.models.config import MoEConfig as JMoE
from repro.models.config import reduced as jreduced
from repro_torch.configs import get as tget
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import mamba as tmamba
from repro_torch.models.config import MoEConfig as TMoE
from repro_torch.models.config import reduced as treduced

TOL = 1e-5


def _configs(arch: str, moe=None, **over):
    jcfg, tcfg = jreduced(jget(arch), **over), treduced(tget(arch), **over)
    if moe is not None:
        jcfg = jcfg.__class__(**{**jcfg.__dict__, "moe": JMoE(*moe)})
        tcfg = tcfg.__class__(**{**tcfg.__dict__, "moe": TMoE(*moe)})
    return jcfg, tcfg


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, tol=TOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=msg)


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ----------------------------------------------------------------------
# MoE
# ----------------------------------------------------------------------
def test_top_k_puts_the_lower_index_first_on_ties():
    probs = np.array([[0.1, 0.3, 0.3, 0.3, 0.0], [0.2, 0.2, 0.2, 0.2, 0.2]], np.float32)
    for k in (1, 2, 3, 5):
        want_p, want_e = jax.lax.top_k(jnp.asarray(probs), k)
        got_p, got_e = tlayers.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    assert tlayers.top_k(torch.from_numpy(probs), 2)[1][0].tolist() == [1, 2]


def _moe_case(arch, moe, seed):
    jcfg, tcfg = _configs(arch, moe)
    jp = jlayers.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp


@pytest.mark.parametrize("arch,moe,B,S", [
    ("dbrx-132b", None, 2, 16),  # prefill: N 32, C 20
    ("dbrx-132b", None, 4, 1),  # decode: N 4, C 3
    ("kimi-k2-1t-a32b", None, 2, 16),  # a shared expert
    ("kimi-k2-1t-a32b", None, 4, 1),
    ("kimi-k2-1t-a32b", (32, 4, 1, 1.25), 4, 1),  # decode with C 1: slots dropped
    ("dbrx-132b", (8, 2, 0, 1.0), 3, 24),  # capacity factor 1: drops in prefill
])
def test_moe_ffn_matches_the_reference(arch, moe, B, S):
    jcfg, tcfg, jp = _moe_case(arch, moe, B * S)
    x = _x(S, B, S, tcfg.d_model)
    want = jax.jit(jlayers.moe_ffn, static_argnums=1)(jp, jcfg, jnp.asarray(x))
    got = tlayers.moe_ffn(_to_torch(jp), tcfg, torch.from_numpy(x))
    assert got.shape == (B, S, tcfg.d_model) and got.dtype == torch.float32
    _close(got, want)
    N, mc = B * S, tcfg.moe
    C = tlayers.moe_capacity(tcfg, N)
    if moe and moe[0] == 32:
        assert C == 1
    # count the token-slots past capacity: the cases with a small C drop some
    probs = torch.softmax(torch.from_numpy(x.reshape(N, -1)) @ _to_torch(jp)["router"], -1)
    per_expert = torch.bincount(tlayers.top_k(probs, mc.top_k)[1].reshape(-1),
                                minlength=mc.n_experts)
    dropped = int(torch.clamp(per_expert - C, min=0).sum())
    if moe:
        assert dropped > 0


def test_moe_ffn_with_tied_router_probabilities():
    """Experts 1, 2 and 3 share one router column and lead every token:
    top 2 must take experts 1 and 2 for every token, as the reference."""
    jcfg, tcfg, jp = _moe_case("dbrx-132b", (5, 2, 0, 1.25), 0)
    router = np.array(jp["router"])
    router[:, 2] = router[:, 3] = router[:, 1]
    router[0, 1:4] += 4.0
    jp = dict(jp, router=jnp.asarray(router))
    x = _x(3, 2, 8, tcfg.d_model)
    x[..., 0] = 3.0
    tp = _to_torch(jp)
    probs = torch.softmax(torch.from_numpy(x.reshape(16, -1)) @ tp["router"], -1)
    assert torch.equal(probs[:, 1], probs[:, 2]) and torch.equal(probs[:, 2], probs[:, 3])
    assert (tlayers.top_k(probs, 2)[1] == torch.tensor([1, 2])).all()
    want = jax.jit(jlayers.moe_ffn, static_argnums=1)(jp, jcfg, jnp.asarray(x))
    _close(tlayers.moe_ffn(tp, tcfg, torch.from_numpy(x)), want)


@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_moe_aux_loss_matches_the_reference(arch):
    jcfg, tcfg, jp = _moe_case(arch, None, 1)
    x = _x(4, 2, 16, tcfg.d_model)
    want = jlayers.moe_aux_loss(jp, jcfg, jnp.asarray(x))
    got = tlayers.moe_aux_loss(_to_torch(jp), tcfg, torch.from_numpy(x))
    assert got.shape == () and got.dtype == torch.float32
    _close(got, want)


# ----------------------------------------------------------------------
# Mamba2 (SSD)
# ----------------------------------------------------------------------
def _ssd_inputs(seed, B, T, H, P, N):
    rng = np.random.default_rng(seed)
    xbar = rng.normal(size=(B, T, H, P)).astype(np.float32)
    loga = -rng.uniform(0.05, 1.5, size=(B, T, H)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, T, N)).astype(np.float32) for _ in range(2))
    s0 = rng.normal(size=(B, H, P, N)).astype(np.float32)
    return xbar, loga, Bm, Cm, s0


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T,chunk", [(32, 8), (37, 64), (1, 64)])
def test_ssd_chunked_matches_the_reference(T, chunk, with_state):
    """T 32 in chunks of 8, T 37 in chunks of 1 (64 halved until it
    divides 37), T 1 (decode)."""
    *arrs, s0 = _ssd_inputs(T, 2, T, 3, 4, 5)
    state = s0 if with_state else None
    yj, hj = jmamba.ssd_chunked(*map(jnp.asarray, arrs), None if state is None else
                                jnp.asarray(state), chunk=chunk)
    yt, ht = tmamba.ssd_chunked(*map(torch.from_numpy, arrs), None if state is None else
                                torch.from_numpy(state), chunk=chunk)
    assert yt.shape == (2, T, 3, 4) and ht.shape == (2, 3, 4, 5) and ht.dtype == torch.float32
    _close(yt, yj, msg="y")
    _close(ht, hj, msg="state")


def _ssd_float64(xbar, loga, Bm, Cm, s0):
    """The SSD recurrence one step at a time in float64:
    h_t = exp(loga_t) h_(t-1) + xbar_t B_t^T, y_t = h_t C_t."""
    x, a, b, c = (v.astype(np.float64) for v in (xbar, loga, Bm, Cm))
    h = s0.astype(np.float64)
    ys = []
    for t in range(x.shape[1]):
        h = np.exp(a[:, t])[:, :, None, None] * h + np.einsum("bhp,bn->bhpn", x[:, t], b[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", h, c[:, t]))
    return np.stack(ys, 1), h


@pytest.mark.parametrize("package", ["port", "reference"])
def test_ssd_chunked_agrees_with_a_float64_recurrence(package):
    """A witness independent of both packages' chunked sums: at T 128 (two
    chunks of 64, zamba2's widths reduced) each package's float32 result
    lies within 1e-5 of the largest value of the step-by-step recurrence
    in float64.  (Elementwise, neither holds 1e-5: a few outputs are sums
    that cancel, where any float32 order is off by some 2e-5.)"""
    xbar, loga, Bm, Cm, s0 = _ssd_inputs(7, 2, 128, 4, 16, 16)
    y64, h64 = _ssd_float64(xbar, loga, Bm, Cm, s0)
    if package == "port":
        y, h = tmamba.ssd_chunked(*map(torch.from_numpy, (xbar, loga, Bm, Cm, s0)))
    else:
        y, h = jmamba.ssd_chunked(*map(jnp.asarray, (xbar, loga, Bm, Cm, s0)))
    for got, want in ((y, y64), (h, h64)):
        assert np.abs(np.asarray(got) - want).max() <= TOL * np.abs(want).max()


def _exact_cumsum(x, axis):
    """``jnp.cumsum`` with a float64 accumulator, as ``torch.cumsum``
    accumulates float32 on the CPU.  XLA's CPU cumsum adds in float32, in
    runs of 16 with the runs' totals carried after."""
    return jax.pure_callback(
        lambda a: np.cumsum(np.asarray(a, np.float64), axis=axis).astype(a.dtype),
        jax.ShapeDtypeStruct(x.shape, x.dtype), x)


@pytest.fixture
def exact_cumsum_reference(monkeypatch):
    """The JAX package's mamba module with ``_exact_cumsum`` for its
    ``jnp.cumsum``, and nothing else changed."""
    class Jnp(types.ModuleType):
        def __getattr__(self, name):
            return getattr(jnp, name)

    proxy = Jnp("jnp")
    proxy.cumsum = _exact_cumsum
    monkeypatch.setattr(jmamba, "jnp", proxy)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_in_two_chunks_of_64_matches_the_reference(with_state,
                                                                exact_cumsum_reference):
    """T 128: a prefill's chunk of 64, the state carried once.  The
    packages' cumulative sums add in other orders (the reference's is
    the less exact, as the witness above and the model test's float64
    run show), so the reference sums as the port does; every other op
    is its own, and the two agree within 1e-5."""
    *arrs, s0 = _ssd_inputs(128, 2, 128, 3, 4, 5)
    state = s0 if with_state else None
    yj, hj = jmamba.ssd_chunked(*map(jnp.asarray, arrs), None if state is None else
                                jnp.asarray(state))
    yt, ht = tmamba.ssd_chunked(*map(torch.from_numpy, arrs), None if state is None else
                                torch.from_numpy(state))
    _close(yt, yj, msg="y")
    _close(ht, hj, msg="state")


def test_segsum_matches_the_reference():
    la = _x(0, 2, 3, 9)
    want = np.asarray(jmamba._segsum(jnp.asarray(la)))
    got = tmamba._segsum(torch.from_numpy(la)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=TOL, atol=TOL)


_FIRST_EXP = """
import numpy as np, torch
import repro_torch.models.mamba as m
la = -torch.from_numpy(np.random.default_rng(128).uniform(0.05, 1.5, (2, 2, 3, 64))
                       .astype(np.float32))
seg = m._segsum(la)
got, want = torch.exp(seg), torch.exp(seg.double())
print(float(((got - want).abs() / want.clamp(min=1e-30)).max()))
"""


def test_the_first_exp_of_a_process_is_exact():
    """The SSD's decay matrix as the first exp of fresh processes (the
    first exp of a process on several CPU threads could come back good to
    about 12 bits from MKL's vector math; importing the port makes a
    small one first): float32 rounding, in each of 8 processes."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    procs = [subprocess.Popen([sys.executable, "-c", _FIRST_EXP], env=env, text=True,
                              stdout=subprocess.PIPE) for _ in range(8)]
    errs = [float(p.communicate(timeout=120)[0]) for p in procs]
    assert all(e < 1e-6 for e in errs), errs


def _mamba_case(T: int, with_state: bool):
    """zamba2's reduced block with decay and step bias away from their
    initial 0, as trained weights; x (2, T, D) and maybe a state."""
    jcfg, tcfg = _configs("zamba2-2.7b")
    jp = jmamba.init_mamba_block(jax.random.PRNGKey(T), jcfg)
    rng = np.random.default_rng(T)
    H = tcfg.ssm_heads
    jp = dict(jp, A_log=jnp.asarray(rng.normal(size=H).astype(np.float32) * 0.5),
              dt_bias=jnp.asarray(rng.normal(size=H).astype(np.float32) * 0.5))
    x = _x(T + 1, 2, T, tcfg.d_model)
    s0 = (rng.normal(size=(2, H, tcfg.ssm_head_dim, tcfg.ssm_state)).astype(np.float32)
          if with_state else None)
    return jcfg, tcfg, jp, x, s0


def _mamba_both(jcfg, tcfg, jp, x, s0):
    """(reference y, state), (port y, state), in float32."""
    want = jax.jit(jmamba.mamba_block, static_argnums=1)(
        jp, jcfg, jnp.asarray(x), None if s0 is None else jnp.asarray(s0))
    got = tmamba.mamba_block(_to_torch(jp), tcfg, torch.from_numpy(x),
                             None if s0 is None else torch.from_numpy(s0))
    return want, got


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", [32, 37, 1])
def test_mamba_block_matches_the_reference(T, with_state):
    (yj, hj), (yt, ht) = _mamba_both(*_mamba_case(T, with_state))
    _close(yt, yj, msg="y")
    _close(ht, hj, msg="state")


@pytest.fixture
def in_float64(monkeypatch):
    """A context in which the JAX package's model code runs in float64:
    x64 on, and every ``jnp.float32`` of its layers, mamba and lm modules
    read as ``jnp.float64``.  Weights and configs go in through ``_to64``."""
    class Jnp(types.ModuleType):
        float32 = jnp.float64

        def __getattr__(self, name):
            return getattr(jnp, name)

    @contextlib.contextmanager
    def ctx():
        with monkeypatch.context() as m, jax.enable_x64(True):
            for mod in (jlayers, jmamba, jlm):
                m.setattr(mod, "jnp", Jnp("jnp"))
            yield
    return ctx


def _to64(cfg, *trees):
    """The config and trees in float64 (to be called in ``in_float64``)."""
    c64 = dataclasses.replace(cfg, compute_dtype="float64", param_dtype="float64")

    def up(a):
        return jnp.asarray(a, jnp.float64) if np.asarray(a).dtype == np.float32 else jnp.asarray(a)
    return (c64, *(None if t is None else jax.tree.map(up, t) for t in trees))


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_block_in_two_chunks_of_64_agrees_with_a_float64_run(with_state, in_float64):
    """T 128: a prefill's chunk of 64, the state carried once.  Each
    package's float32 block lies within 1e-5 of the reference's own code
    run in float64.  The two float32 blocks differ by a little more than
    that in one element of 16384, on either side of the float64 value:
    any two float32 orders may."""
    jcfg, tcfg, jp, x, s0 = _mamba_case(128, with_state)
    (yj, hj), (yt, ht) = _mamba_both(jcfg, tcfg, jp, x, s0)
    with in_float64():
        c64, p64, x64, s64 = _to64(jcfg, jp, x, s0)
        y64, h64 = (np.asarray(a) for a in jmamba.mamba_block(p64, c64, x64, s64))
    assert y64.dtype == h64.dtype == np.float64
    for name, (y, h) in (("port", (yt, ht)), ("reference", (yj, hj))):
        _close(y, y64, msg=f"{name} y")
        _close(h, h64, msg=f"{name} state")


def test_zamba2_logits_are_nearer_a_float64_run_than_the_references(in_float64):
    """The whole reduced zamba2 at T 128, where the two packages' float32
    logits differ most (by up to 9.3e-5, inside the model tests' 1e-4):
    against the reference's own code run in float64, the port's logits
    lie within 1e-4 and nearer than the reference's float32 logits do.
    The drift between the packages is the reference's."""
    jcfg, tcfg = _configs("zamba2-2.7b")
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tlm.load_reference_params(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 128)).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, b: jlm.forward(jcfg, p, b))(
        jp, {"tokens": jnp.asarray(tokens)}))
    got = tlm.forward(tcfg, tp, {"tokens": torch.from_numpy(tokens).long()}).numpy()
    with in_float64():
        c64, p64 = _to64(jcfg, jp)
        exact = np.asarray(jlm.forward(c64, p64, {"tokens": jnp.asarray(tokens)}))
    assert exact.dtype == np.float64
    np.testing.assert_allclose(got, exact, rtol=1e-4, atol=1e-4)
    assert np.abs(got - exact).max() <= np.abs(want - exact).max()


# ----------------------------------------------------------------------
# cross-attention
# ----------------------------------------------------------------------
def _cross_params(gate: float):
    jcfg, tcfg = _configs("llama-3.2-vision-90b")
    jp = jlayers.init_attention(jax.random.PRNGKey(5), jcfg, cross=True)
    assert float(jp["gate"]) == 0.0  # closed at the start, as in the reference
    tp0 = tlayers.init_attention(torch.Generator("cpu").manual_seed(0), tcfg, cross=True)
    assert set(tp0) == set(jp) and float(tp0["gate"]) == 0.0
    jp = dict(jp, gate=jnp.full_like(jp["gate"], gate))
    return jcfg, tcfg, jp, _to_torch(jp)


@pytest.mark.parametrize("Sq,Sk", [(20, 8), (5, 13)])
def test_cross_attention_matches_the_reference(Sq, Sk):
    """kv_x given: keys and values from it, no RoPE, not causal."""
    jcfg, tcfg, jp, tp = _cross_params(0.5)
    x, img = _x(Sq, 2, Sq, tcfg.d_model), _x(Sk, 2, Sk, tcfg.d_model)
    pos = np.broadcast_to(np.arange(Sq), (2, Sq))
    yj, (kj, vj) = jlayers.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                     kv_x=jnp.asarray(img), causal=False)
    yt, (kt, vt) = tlayers.attention(tp, tcfg, torch.from_numpy(x), None,
                                     kv_x=torch.from_numpy(img), causal=False)
    _close(yt, yj, msg="y")
    _close(kt, kj, msg="k")
    _close(vt, vj, msg="v")
    closed = dict(tp, gate=torch.zeros(()))
    assert not tlayers.attention(closed, tcfg, torch.from_numpy(x), None,
                                 kv_x=torch.from_numpy(img))[0].any()


@pytest.mark.parametrize("update_cache,rope,kv_len", [
    (False, False, 6),  # the cross layer's decode: a cache it never writes
    (True, True, None),  # a self layer's decode
])
def test_decode_attention_matches_the_reference(update_cache, rope, kv_len):
    jcfg, tcfg, jp, tp = _cross_params(0.5)
    B, Smax, pos = 2, 9, 4
    x = _x(1, B, 1, tcfg.d_model)
    shape = (B, Smax, tcfg.n_kv_heads, tcfg.hd)
    ck, cv = _x(2, *shape), _x(3, *shape)
    yj, kj, vj = jlayers.decode_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(ck),
                                          jnp.asarray(cv), pos, rope=rope,
                                          update_cache=update_cache, kv_len=kv_len)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    yt, kt, vt = tlayers.decode_attention(tp, tcfg, torch.from_numpy(x), tk, tv, pos,
                                          rope=rope, update_cache=update_cache, kv_len=kv_len,
                                          gated=True)
    _close(yt, yj, msg="y")
    _close(kt, kj, msg="k")
    _close(vt, vj, msg="v")
    if not update_cache:
        assert np.array_equal(kt.numpy(), ck) and np.array_equal(vt.numpy(), cv)
