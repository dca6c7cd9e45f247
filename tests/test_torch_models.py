"""The port's LM stack (``repro_torch.models``) and its two kernels' plain
versions against the JAX package.

* ``wkv6_plain`` (K5) against ``repro.kernels.ref.wkv6_reference`` and
  the Pallas kernel in interpret mode;
* ``flash_attention_plain`` (K4) against ``ref.mha_reference`` and the
  Pallas kernel in interpret mode, plus ragged lengths against the
  reference alone (the Pallas kernel asserts divisibility);
* reduced ``phi3-mini-3.8b``, ``qwen3-14b`` (GQA group 2) and
  ``rwkv6-7b`` (2 layers, float32) with the JAX weights carried over by
  ``load_reference_params``: ``forward`` and ``prefill`` logits and five
  ``decode_step``s with their state.

The CUDA kernels are held to these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.  JAX runs with its
default (32-bit) types here, as the model stack does: ``jax.random``
under x64 would draw other weights.  Inputs are made from a seed with
numpy and handed to both packages.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get as jget
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.wkv6 import wkv6_pallas
from repro.models import lm as jlm
from repro.models.config import reduced as jreduced
from repro.models.rwkv import wkv6_chunked
from repro_torch.configs import get as tget
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.wkv6 import wkv6_plain
from repro_torch.models import lm as tlm
from repro_torch.models.config import reduced as treduced

# float32 tolerances of tests/test_kernels.py (kernel vs reference) and
# of the model comparisons (float32 sums in another order, 2 layers)
KERNEL_TOL = {"float32": (1e-4, 2e-5), "bfloat16": (4e-2, 2e-2)}  # (wkv6, attention)
MODEL_TOL = 1e-4
ARCHS = ["phi3-mini-3.8b", "qwen3-14b", "rwkv6-7b"]


def _np(x):
    return np.asarray(x, np.float32) if x.dtype != torch.bfloat16 else x.float().numpy()


def _both(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


# ----------------------------------------------------------------------
# K5: wkv6
# ----------------------------------------------------------------------
def _wkv6_inputs(seed, B, H, T, D):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, H, T, D)).astype(np.float32) * 0.5 for _ in range(3))
    w = rng.uniform(0.7, 0.999, size=(B, H, T, D)).astype(np.float32)
    u = (rng.normal(size=(H, D)) * 0.1).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,T,D", [(1, 2, 64, 16), (2, 3, 128, 32)])
def test_wkv6_plain_matches_reference_and_pallas(dtype, B, H, T, D):
    arrs = _wkv6_inputs(B + T, B, H, T, D)
    j = [_both(a, dtype)[0] for a in arrs]
    t = [_both(a, dtype)[1] for a in arrs]
    y, s = wkv6_plain(*t)
    assert y.dtype == getattr(torch, dtype) and s.dtype == torch.float32
    y_ref, s_ref = jref.wkv6_reference(*j)
    y_pal, s_pal = wkv6_pallas(*j, bt=32)
    tol = KERNEL_TOL[dtype][0]
    for want_y, want_s in ((y_ref, s_ref), (y_pal, s_pal)):
        np.testing.assert_allclose(_np(y), np.asarray(want_y, np.float32), rtol=tol, atol=tol)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=tol, atol=tol)


def test_wkv6_plain_chains_state_and_takes_single_steps():
    """Two halves chained through the state, and T single steps, equal
    one full run (and the JAX reference), float32 within 1e-4."""
    B, H, T, D = 1, 2, 64, 16
    arrs = _wkv6_inputs(9, B, H, T, D)
    r, k, v, w, u = (torch.from_numpy(a) for a in arrs)
    y_full, s_full = wkv6_plain(r, k, v, w, u)
    y_ref, s_ref = jref.wkv6_reference(*(jnp.asarray(a) for a in arrs))
    np.testing.assert_allclose(y_full.numpy(), np.asarray(y_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s_full.numpy(), np.asarray(s_ref), rtol=1e-4, atol=1e-4)
    half = T // 2
    y1, s1 = wkv6_plain(r[:, :, :half], k[:, :, :half], v[:, :, :half], w[:, :, :half], u)
    y2, s2 = wkv6_plain(r[:, :, half:], k[:, :, half:], v[:, :, half:], w[:, :, half:], u, s1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=2), y_full, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s2, s_full, rtol=1e-4, atol=1e-4)
    s, ys = None, []
    for t in range(T):
        sl = slice(t, t + 1)
        y_t, s = wkv6_plain(r[:, :, sl], k[:, :, sl], v[:, :, sl], w[:, :, sl], u, s)
        ys.append(y_t)
    torch.testing.assert_close(torch.cat(ys, dim=2), y_full, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, s_full, rtol=1e-4, atol=1e-4)


def _heads_view(a: np.ndarray, dtype: str) -> torch.Tensor:
    """A (B, H, T, D) array as the model hands it to the kernel: the
    (B, H, T, D) view of a (B, T, H, D) tensor."""
    t = torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
    return t.to(getattr(torch, dtype)).transpose(1, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 7, 64])
def test_wkv6_plain_strided_in_place_matches_reference_and_chunked(dtype, T):
    """Strided (B, H, T, D) views and the state written over itself, as
    the decode step calls K5, against ``ref.wkv6_reference`` (the kernel
    tolerance) and the JAX package's chunked form ``wkv6_chunked`` (its
    own tolerance against the reference, 2e-3, or the bf16 one)."""
    B, H, D = 2, 3, 16
    arrs = _wkv6_inputs(T, B, H, T, D)
    s0 = np.random.default_rng(T + 1).normal(size=(B, H, D, D)).astype(np.float32)
    r, k, v, w = (_heads_view(a, dtype) for a in arrs[:4])
    u = torch.from_numpy(arrs[4]).to(getattr(torch, dtype))
    if T > 1:
        assert not r.is_contiguous() and r.stride(3) == 1
    state = torch.from_numpy(s0.copy())  # a clone: the call writes over it
    y, s = wkv6_plain(r, k, v, w, u, state, state_out=state)
    assert s is state and s.dtype == torch.float32
    assert y.shape == (B, H, T, D) and y.transpose(1, 2).is_contiguous()
    j = [_both(a, dtype)[0] for a in arrs]
    tol = KERNEL_TOL[dtype][0]
    y_ref, s_ref = jref.wkv6_reference(*j, state=jnp.asarray(s0))
    np.testing.assert_allclose(_np(y), np.asarray(y_ref, np.float32), rtol=tol, atol=tol)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=tol, atol=tol)
    y_c, s_c = wkv6_chunked(*j, state=jnp.asarray(s0), chunk=min(T, 16))
    tol_c = max(2e-3, tol)
    np.testing.assert_allclose(_np(y), np.asarray(y_c, np.float32), rtol=tol_c, atol=tol_c)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_c), rtol=tol_c, atol=tol_c)


def test_wkv6_without_state_out_leaves_the_state_and_returns_a_new_one():
    arrs = _wkv6_inputs(4, 2, 3, 5, 16)
    r, k, v, w = (_heads_view(a, "float32") for a in arrs[:4])
    u = torch.from_numpy(arrs[4])
    s0 = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 3, 16, 16)).astype(np.float32))
    kept = s0.clone()
    for T in (5, 0):  # no steps: the state comes back unchanged, still a new tensor
        y, s = ops.wkv6(r[:, :, :T], k[:, :, :T], v[:, :, :T], w[:, :, :T], u, s0)
        assert s is not s0 and s.data_ptr() != s0.data_ptr()
        assert torch.equal(s0, kept)
    torch.testing.assert_close(s, kept)
    out = torch.full_like(s0, float("nan"))
    y2, s2 = ops.wkv6(r, k, v, w, u, s0, state_out=out)
    y1, s1 = ops.wkv6(r, k, v, w, u, s0)
    assert s2 is out and torch.equal(s0, kept)
    torch.testing.assert_close(s2, s1)
    torch.testing.assert_close(y2, y1)


# ----------------------------------------------------------------------
# K4: flash attention
# ----------------------------------------------------------------------
def _qkv(seed, B, Hq, Hkv, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Hq, Sq, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(1, 4, 2, 128, 32), (1, 2, 2, 64, 16)])
def test_flash_attention_plain_matches_reference_and_pallas(dtype, B, Hq, Hkv, S, D):
    arrs = _qkv(B * S + Hq, B, Hq, Hkv, S, S, D)
    j = [_both(a, dtype)[0] for a in arrs]
    t = [_both(a, dtype)[1] for a in arrs]
    got = flash_attention_plain(*t, causal=True)
    assert got.dtype == getattr(torch, dtype)
    tol = KERNEL_TOL[dtype][1]
    for want in (jref.mha_reference(*j, causal=True),
                 flash_attention_pallas(*j, causal=True, bq=64, bk=64)):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_flash_attention_plain_noncausal_matches_pallas():
    arrs = _qkv(3, 1, 2, 2, 128, 128, 32)
    got = flash_attention_plain(*(torch.from_numpy(a) for a in arrs), causal=False)
    want = flash_attention_pallas(*(jnp.asarray(a) for a in arrs), causal=False, bq=64, bk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Hq,Hkv,Sq,Sk,D", [
    (2, 1, 100, 100, 16), (5, 1, 37, 100, 64), (4, 2, 1, 77, 96), (2, 2, 130, 130, 128),
])
def test_flash_attention_plain_ragged_matches_reference(causal, Hq, Hkv, Sq, Sk, D):
    """Lengths that are not a multiple of any tile, and Sq < Sk (the
    causal mask offset by Sk - Sq), against mha_reference (f32, 2e-5)."""
    arrs = _qkv(Sq * 7 + Sk, 2, Hq, Hkv, Sq, Sk, D)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in arrs), causal=causal)
    want = jref.mha_reference(*(jnp.asarray(a) for a in arrs), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_flash_attention_refuses_causal_queries_past_the_keys():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 2, 2, 9, 4, 16))
    with pytest.raises(ValueError, match="Sq=9 > Sk=4"):
        flash_attention_plain(q, k, v, causal=True)
    assert flash_attention_plain(q, k, v, causal=False).shape == q.shape


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    ops.reset_launches()
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 4, 2, 33, 33, 16))
    torch.testing.assert_close(ops.flash_attention(q, k, v), tref.mha_reference(q, k, v))
    r, kk, vv, w, u = (torch.from_numpy(a) for a in _wkv6_inputs(2, 1, 2, 5, 16))
    y, s = ops.wkv6(r, kk, vv, w, u)
    y2, s2 = tref.wkv6_reference(r, kk, vv, w, u)
    torch.testing.assert_close(y, y2)
    torch.testing.assert_close(s, s2)
    assert ops.LAUNCHES["flash_attention"] == 0 and ops.LAUNCHES["wkv6"] == 0
    assert ops.LAUNCHES["flash_attention_sm90"] == 0


# ----------------------------------------------------------------------
# the models, on the JAX package's weights
# ----------------------------------------------------------------------
def _configs(arch: str, **over):
    if arch == "qwen3-14b":
        over.setdefault("n_kv_heads", 2)  # reduced() would make it MHA
    return jreduced(jget(arch), **over), treduced(tget(arch), **over)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, tcfg = _configs(request.param)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tlm.load_reference_params(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def test_reduced_configs_are_the_shapes_compared(model):
    jcfg, tcfg, _, tparams = model
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert (tcfg.n_layers, tcfg.d_model, tcfg.compute_dtype) == (2, 64, "float32")
    assert len(tparams["blocks"]) == 2
    if tcfg.name == "qwen3-14b":
        assert (tcfg.n_heads, tcfg.n_kv_heads, tcfg.qk_norm) == (4, 2, True)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def test_forward_and_prefill_logits_match(model):
    """S = 128 > q_chunk = 64, so the JAX package takes its chunked
    attention branch; the port one K4 call.  f32 within 1e-4."""
    jcfg, tcfg, jparams, tparams = model
    toks = _tokens(tcfg, 2, 128)
    want = jax.jit(lambda p, b: jlm.forward(jcfg, p, b))(jparams, {"tokens": jnp.asarray(toks)})
    got = tlm.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 128, tcfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MODEL_TOL, atol=MODEL_TOL)
    want = jax.jit(lambda p, b: jlm.prefill(jcfg, p, b))(jparams, {"tokens": jnp.asarray(toks)})
    got = tlm.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MODEL_TOL, atol=MODEL_TOL)


def test_decode_steps_match_with_their_state(model):
    jcfg, tcfg, jparams, tparams = model
    B, max_len = 3, 8
    jstate = jlm.init_decode_state(jcfg, B, max_len)
    tstate = tlm.init_decode_state(tcfg, B, max_len, device="cpu")
    step = jax.jit(lambda p, s, b: jlm.decode_step(jcfg, p, s, b))
    toks = _tokens(tcfg, B, 5, seed=1)
    start = np.array([0, 1, 2], np.int32)
    for t in range(5):
        jb = {"tokens": jnp.asarray(toks[:, t:t + 1]), "kv_start": jnp.asarray(start)}
        tb = {"tokens": torch.from_numpy(toks[:, t:t + 1]).long(),
              "kv_start": torch.from_numpy(start)}
        want, jstate = step(jparams, jstate, jb)
        got, tstate = tlm.decode_step(tcfg, tparams, tstate, tb)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MODEL_TOL, atol=MODEL_TOL)
        assert tstate["pos"] == int(jstate["pos"]) == t + 1
        for name in set(jstate) - {"pos"}:
            np.testing.assert_allclose(
                tstate[name].numpy(), np.asarray(jstate[name]), rtol=MODEL_TOL, atol=MODEL_TOL,
                err_msg=name,
            )


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "rwkv6-7b"])
def test_load_reference_params_keeps_bfloat16_bits_and_unstacks_layers(arch):
    jcfg, tcfg = _configs(arch, param_dtype="bfloat16", compute_dtype="bfloat16", n_layers=3)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, jparams)
    tparams = tlm.load_reference_params(tcfg, tree, "cpu")
    assert len(tparams["blocks"]) == 3
    got = tparams["embed"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), tree["embed"].astype(np.float32))
    blocks = tree["blocks"]
    leaf = ("attn", "wq") if arch == "phi3-mini-3.8b" else ("wr",)
    stacked = blocks[leaf[0]] if len(leaf) == 1 else blocks[leaf[0]][leaf[1]]
    for i, bp in enumerate(tparams["blocks"]):
        mod = bp
        for name in leaf:
            mod = mod[name]
        np.testing.assert_array_equal(mod.float().numpy(), stacked[i].astype(np.float32))


@pytest.mark.parametrize("arch", [
    "dbrx-132b",  # moe
    "zamba2-2.7b",  # mamba_hybrid
    "llama-3.2-vision-90b",  # cross-attention layers
    "musicgen-medium",  # embed_inputs=False
])
def test_unported_families_and_features_refuse(arch):
    cfg = treduced(tget(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP.md, M11"):
        tlm.init_params(cfg, torch.Generator("cpu"), device="cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tlm.init_decode_state(cfg, 2, 8, device="cpu")


def test_init_params_draws_from_the_generator_on_the_asked_device():
    cfg = treduced(tget("rwkv6-7b"))
    a = tlm.init_params(cfg, torch.Generator("cpu").manual_seed(5), device="cpu")
    b = tlm.init_params(cfg, torch.Generator("cpu").manual_seed(5), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert a["lm_head"].device.type == "cpu" and not a["lm_head"].requires_grad
    n = sum(p.numel() for p in a.parameters())
    assert n > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlm.init_params(cfg)
