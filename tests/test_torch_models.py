"""The port's LM stack (``repro_torch.models``) and its two kernels' plain
versions against the JAX package.

* ``wkv6_plain`` (K5) against ``repro.kernels.ref.wkv6_reference`` and
  the Pallas kernel in interpret mode;
* ``flash_attention_plain`` (K4) against ``ref.mha_reference`` and the
  Pallas kernel in interpret mode, plus ragged lengths against the
  reference alone (the Pallas kernel asserts divisibility);
* every family at a reduced float32 config, with the JAX weights
  carried over by ``load_reference_params``: ``phi3-mini-3.8b``,
  ``qwen3-14b`` (GQA group 2), ``rwkv6-7b``, the MoE FFN (``dbrx-132b``;
  ``kimi-k2-1t-a32b`` with a shared expert), the Mamba2 hybrid
  (``zamba2-2.7b``), cross-attention layers (``llama-3.2-vision-90b``,
  its gate opened to 0.5 so that the layers add something) and
  embedding inputs (``musicgen-medium``): ``forward`` and ``prefill``
  logits and five ``decode_step``s with their state.

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
from repro_torch.configs import ARCHS as TARCHS
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
ARCHS = ["phi3-mini-3.8b", "qwen3-14b", "rwkv6-7b", "dbrx-132b", "kimi-k2-1t-a32b",
         "zamba2-2.7b", "llama-3.2-vision-90b", "musicgen-medium"]
#: the gate the cross-attention layers are opened to (it starts at 0)
CROSS_GATE = 0.5


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
    assert ops.LAUNCHES["flash_attention_f32_sm90"] == 0 and ops.LAUNCHES["wkv6"] == 0
    assert ops.LAUNCHES["flash_attention_sm90"] == 0


# ----------------------------------------------------------------------
# the models, on the JAX package's weights
# ----------------------------------------------------------------------
def _configs(arch: str, **over):
    if arch == "qwen3-14b":
        over.setdefault("n_kv_heads", 2)  # reduced() would make it MHA
    return jreduced(jget(arch), **over), treduced(tget(arch), **over)


def open_cross_gates(jparams, gate: float = CROSS_GATE):
    """The JAX weights with every cross-attention gate set to ``gate``."""
    if "cross_blocks" not in jparams:
        return jparams
    out = dict(jparams, cross_blocks=dict(jparams["cross_blocks"]))
    attn = dict(out["cross_blocks"]["attn"])
    attn["gate"] = jnp.full_like(attn["gate"], gate)
    out["cross_blocks"]["attn"] = attn
    return out


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, tcfg = _configs(request.param)
    jparams = open_cross_gates(jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = tlm.load_reference_params(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def test_reduced_configs_are_the_shapes_compared(model):
    jcfg, tcfg, _, tparams = model
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert (tcfg.d_model, tcfg.compute_dtype) == (64, "float32")
    n_cross = tcfg.n_layers // tcfg.cross_attn_every if tcfg.cross_attn_every else 0
    assert tcfg.n_layers == (4 if tcfg.attn_every else 2)
    assert len(tparams["blocks"]) == tcfg.n_layers - n_cross
    assert ("embed" in tparams) == tcfg.embed_inputs
    if tcfg.name == "qwen3-14b":
        assert (tcfg.n_heads, tcfg.n_kv_heads, tcfg.qk_norm) == (4, 2, True)
    if tcfg.moe:
        moe = tparams["blocks"][0]["moe"]
        assert moe["router"].dtype == torch.float32
        assert moe["w_gate"].shape == (4, 64, 128) and ("shared" in moe) == bool(tcfg.moe.n_shared)
    if tcfg.attn_every:  # one shared block, kept as it is
        assert tparams["shared_attn"]["attn"]["wq"].shape == (64, 64)
    if n_cross:
        assert len(tparams["cross_blocks"]) == n_cross
        assert float(tparams["cross_blocks"][0]["attn"]["gate"]) == CROSS_GATE


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def model_batch(cfg, B: int, S: int, seed: int = 0, img: bool = True):
    """The same inputs for both packages, (jax batch, torch batch): tokens,
    or frame embeddings where the model takes no tokens; with ``img`` the
    image embeddings of a cross-attention model."""
    rng = np.random.default_rng(seed)
    arrs = {}
    if cfg.embed_inputs:
        arrs["tokens"] = _tokens(cfg, B, S, seed)
    else:
        arrs["embeddings"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    if img and cfg.cross_attn_every:
        arrs["img_embed"] = rng.normal(size=(B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    tb = {name: torch.from_numpy(a).long() if name == "tokens" else torch.from_numpy(a)
          for name, a in arrs.items()}
    return {name: jnp.asarray(a) for name, a in arrs.items()}, tb


def test_forward_and_prefill_logits_match(model):
    """S = 128 > q_chunk = 64, so the JAX package takes its chunked
    attention branch; the port one K4 call (cross-attention: non-causal,
    Sq 128 > Sk 8).  f32 within 1e-4."""
    jcfg, tcfg, jparams, tparams = model
    jb, tb = model_batch(tcfg, 2, 128)
    want = jax.jit(lambda p, b: jlm.forward(jcfg, p, b))(jparams, jb)
    got = tlm.forward(tcfg, tparams, tb)
    assert got.shape == (2, 128, tcfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MODEL_TOL, atol=MODEL_TOL)
    want = jax.jit(lambda p, b: jlm.prefill(jcfg, p, b))(jparams, jb)
    got = tlm.prefill(tcfg, tparams, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MODEL_TOL, atol=MODEL_TOL)


def test_decode_steps_match_with_their_state(model):
    jcfg, tcfg, jparams, tparams = model
    B, max_len = 3, 8
    jstate = jlm.init_decode_state(jcfg, B, max_len)
    tstate = tlm.init_decode_state(tcfg, B, max_len, device="cpu")
    step = jax.jit(lambda p, s, b: jlm.decode_step(jcfg, p, s, b))
    jin, tin = model_batch(tcfg, B, 5, seed=1, img=False)
    start = np.array([0, 1, 2], np.int32)
    for t in range(5):
        jb = {name: a[:, t:t + 1] for name, a in jin.items()}
        tb = {name: a[:, t:t + 1] for name, a in tin.items()}
        jb["kv_start"], tb["kv_start"] = jnp.asarray(start), torch.from_numpy(start)
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


@pytest.mark.parametrize("arch", TARCHS)
def test_every_registered_config_builds_params_and_a_decode_state(arch):
    """Every family of the registry, reduced: the parameter tree has the
    JAX package's names and shapes, and the decode state its arrays."""
    jcfg, tcfg = _configs(arch)
    tparams = tlm.init_params(tcfg, torch.Generator("cpu").manual_seed(2), device="cpu")
    jshapes = jax.eval_shape(lambda: jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    tree = {name: _stacked_shapes(tparams[name]) for name, _ in tparams.named_children()}
    tree.update({name: tuple(p.shape) for name, p in tparams.named_parameters(recurse=False)})
    assert tree == jax.tree.map(lambda a: tuple(a.shape), jshapes)
    tstate = tlm.init_decode_state(tcfg, 2, 8, device="cpu")
    jstate = jax.eval_shape(lambda: jlm.init_decode_state(jcfg, 2, 8))
    assert set(tstate) == set(jstate) and tstate["pos"] == 0
    for name in set(jstate) - {"pos"}:
        assert tuple(tstate[name].shape) == jstate[name].shape, name
        assert not tstate[name].any()


def _stacked_shapes(mod):
    """Shapes of a Params subtree, a list of blocks stacked on a leading
    axis as the JAX package stacks them."""
    if isinstance(mod, torch.nn.ModuleList):
        per = [_stacked_shapes(m) for m in mod]
        return jax.tree.map(lambda *s: (len(per),) + s[0], *per,
                            is_leaf=lambda x: isinstance(x, tuple))
    out = {name: _stacked_shapes(m) for name, m in mod.named_children()}
    out.update({name: tuple(p.shape) for name, p in mod.named_parameters(recurse=False)})
    return out


def test_normal_draws_a_large_weight_in_slices(monkeypatch):
    """A weight is drawn in slices of about SLICE_ELEMS along its first
    dim into the target dtype (no whole float32 temporary): a weight of
    one slice is the whole draw; a sliced one has the shape and dtype
    asked for, the same numbers again from the same seed, N(0, scale)."""
    from repro_torch.models import layers as tlayers

    whole = tlayers.normal(torch.Generator("cpu").manual_seed(3), (64, 96, 32), 0.5,
                           torch.float32)
    want = torch.randn((64, 96, 32), generator=torch.Generator("cpu").manual_seed(3)) * 0.5
    assert torch.equal(whole, want)
    monkeypatch.setattr(tlayers, "SLICE_ELEMS", 1000)
    parts = tlayers.normal(torch.Generator("cpu").manual_seed(3), (64, 96, 32), 0.5,
                           torch.float32)
    again = tlayers.normal(torch.Generator("cpu").manual_seed(3), (64, 96, 32), 0.5,
                           torch.float32)
    assert parts.shape == whole.shape and torch.equal(parts, again)
    assert abs(float(parts.mean())) < 0.01 and abs(float(parts.std()) - 0.5) < 0.01
    rows = tlayers.normal(torch.Generator("cpu").manual_seed(3), (5, 7, 1000), 1.0,
                          torch.bfloat16)  # one row over the limit: a row a draw
    assert rows.dtype == torch.bfloat16 and rows.shape == (5, 7, 1000)
    assert len({float(rows[i].float().std()) for i in range(5)}) == 5


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


# ----------------------------------------------------------------------
# the backward kernels' plain versions (training)
# ----------------------------------------------------------------------
#: float32 gradients, relative to the largest |gradient| of the call
#: (sums in another order than XLA's)
BWD_TOL = 1e-4


def _close_grads(got, want, msg=""):
    want = [np.asarray(w, np.float32) for w in want]
    scale = max(float(np.abs(w).max()) for w in want) or 1.0
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.detach().float().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, w, rtol=BWD_TOL, atol=BWD_TOL * scale,
                                   err_msg=f"{msg} gradient {i}")


@pytest.mark.parametrize("causal,B,Hq,Hkv,Sq,Sk,D", [
    (True, 2, 4, 4, 33, 33, 16),  # causal, MHA
    (True, 1, 6, 2, 20, 45, 32),  # causal, GQA group 3, Sq < Sk
    (False, 1, 8, 2, 40, 12, 16),  # non-causal cross, Sq > Sk, GQA group 4
])
def test_flash_attention_bwd_plain_matches_jax_vjp(causal, B, Hq, Hkv, Sq, Sk, D):
    q, k, v = _qkv(Sq + Sk, B, Hq, Hkv, Sq, Sk, D)
    do = np.random.default_rng(D).normal(size=(B, Hq, Sq, D)).astype(np.float32)
    o, vjp = jax.vjp(lambda a, b, c: jref.mha_reference(a, b, c, causal),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    lse = tref.attention_lse_plain(tq, tk, causal)
    got = tref.flash_attention_bwd_plain(tq, tk, tv, torch.from_numpy(np.array(o)), lse,
                                         torch.from_numpy(do), causal)
    assert [g.shape for g in got] == [tq.shape, tk.shape, tv.shape]
    _close_grads(got, want, "attention")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_plain_matches_autograd_of_the_plain_forward(causal):
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(3, 2, 6, 3, 17, 29, 16))
    o = flash_attention_plain(q, k, v, causal)
    do = torch.from_numpy(np.random.default_rng(4).normal(size=o.shape).astype(np.float32))
    want = torch.autograd.grad(o, (q, k, v), do)
    with torch.no_grad():
        got = tref.flash_attention_bwd_plain(q, k, v, o, tref.attention_lse_plain(q, k, causal),
                                             do, causal)
    _close_grads(got, [w.numpy() for w in want], "attention")


def _wkv6_bwd_case(seed, B=2, H=3, T=19, D=16):
    r, k, v, w, u = _wkv6_inputs(seed, B, H, T, D)
    rng = np.random.default_rng(seed + 1)
    s0 = rng.normal(size=(B, H, D, D)).astype(np.float32)
    dy = rng.normal(size=(B, H, T, D)).astype(np.float32)
    ds = rng.normal(size=(B, H, D, D)).astype(np.float32)
    return (r, k, v, w, u, s0), dy, ds


def test_wkv6_bwd_plain_matches_jax_vjp_with_an_initial_state():
    """All six gradients (r, k, v, w, u and the initial state) against
    ``jax.vjp`` of the reference recurrence, the final state's gradient
    given too."""
    args, dy, ds = _wkv6_bwd_case(5)
    _, vjp = jax.vjp(jref.wkv6_reference, *(jnp.asarray(a) for a in args))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    got = tref.wkv6_bwd_plain(*(torch.from_numpy(a) for a in args), torch.from_numpy(dy),
                              torch.from_numpy(ds))
    assert len(got) == 6 and got[-1].dtype == torch.float32
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        _close_grads([g], [w], name)


def test_wkv6_bwd_plain_matches_autograd_of_the_plain_forward():
    """Without an initial state or a final-state gradient (the model's
    training call): the plain reverse recurrence equals autograd through
    ``wkv6_plain``; and with them."""
    args, dy, ds = _wkv6_bwd_case(6, T=11)
    for state, dstate in ((False, None), (True, ds)):
        ins = [torch.from_numpy(a).requires_grad_() for a in args[:5]]
        s0 = torch.from_numpy(args[5]).requires_grad_() if state else None
        y, s = wkv6_plain(*ins, s0)
        outs, grads_out = ((y, s), (torch.from_numpy(dy), torch.from_numpy(dstate))) \
            if state else ((y,), (torch.from_numpy(dy),))
        want = torch.autograd.grad(outs, ins + ([s0] if state else []), grads_out)
        with torch.no_grad():
            got = tref.wkv6_bwd_plain(*ins, s0, torch.from_numpy(dy),
                                      None if dstate is None else torch.from_numpy(dstate))
        for name, g, w in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
            _close_grads([g], [w.numpy()], name)


def _wkv6_bwd_three_phase(r, k, v, w, u, s0, dy, ds, chunk, cols, group):
    """A plain float32 twin of ``csrc/wkv6_bwd.cu``'s arithmetic: (a) the
    state before each chunk, forwards, and (b) its gradient after each
    group of chunks, backwards, both column slice by column slice (columns
    evolve apart), then (c) each group on its own, its chunks from the
    last: P_t forwards from the chunk's state (kept), G_t backwards, carried
    from chunk to chunk, the gradients.  Steps past T are padded with w 1
    and zeros, which leave P and G as they are.  Nothing divides."""
    B, H, T, D = r.shape
    nc = -(-T // chunk)
    ng = -(-nc // group)
    pad = ng * group * chunk - T

    def padded(x, value=0.0):
        return torch.cat([x, torch.full((B, H, pad, D), value)], 2) if pad else x

    r, k, v, dy = (padded(x) for x in (r, k, v, dy))
    w = padded(w, 1.0)
    zero = torch.zeros((B, H, D, D))
    pst, gst = torch.empty((B, H, nc, D, D)), torch.empty((B, H, ng, D, D))
    ds0 = torch.empty((B, H, D, D))
    for j0 in range(0, D, cols):  # (a), (b): a block's columns
        sl = slice(j0, min(D, j0 + cols))
        S = (zero if s0 is None else s0)[..., sl].clone()
        for c in range(nc):
            pst[:, :, c, :, sl] = S
            for t in range(c * chunk, (c + 1) * chunk if c < nc - 1 else 0):
                S = w[:, :, t, :, None] * S + k[:, :, t, :, None] * v[:, :, t, None, sl]
        G = (zero if ds is None else ds)[..., sl].clone()
        for g in reversed(range(ng)):
            gst[:, :, g, :, sl] = G
            for t in reversed(range(g * group * chunk, (g + 1) * group * chunk)):
                G = w[:, :, t, :, None] * G + r[:, :, t, :, None] * dy[:, :, t, None, sl]
        ds0[..., sl] = G
    dr, dk, dv, dw = (torch.empty((B, H, ng * group * chunk, D)) for _ in range(4))
    du = torch.zeros((B, H, D))
    vdy = (v * dy).sum(-1)
    ruk = (r * u[:, None] * k).sum(-1)
    chunks = [(g, c) for g in range(ng)
              for c in reversed(range(g * group, min(nc, (g + 1) * group)))]
    for g, c in chunks:  # (c): every group apart, its chunks from the last
        steps = range(c * chunk, (c + 1) * chunk)
        if c == min(nc, (g + 1) * group) - 1:
            G = gst[:, :, g]
        P, hist = pst[:, :, c], {}
        for t in steps:
            hist[t] = P
            dr[:, :, t] = torch.einsum("bhij,bhj->bhi", P, dy[:, :, t]) + u * k[:, :, t] * vdy[
                :, :, t, None]
            P = w[:, :, t, :, None] * P + k[:, :, t, :, None] * v[:, :, t, None, :]
        for t in reversed(steps):
            dk[:, :, t] = r[:, :, t] * u * vdy[:, :, t, None] + torch.einsum(
                "bhij,bhj->bhi", G, v[:, :, t])
            dw[:, :, t] = (G * hist[t]).sum(-1)
            dv[:, :, t] = ruk[:, :, t, None] * dy[:, :, t] + torch.einsum(
                "bhij,bhi->bhj", G, k[:, :, t])
            G = w[:, :, t, :, None] * G + r[:, :, t, :, None] * dy[:, :, t, None, :]
        du += (r[:, :, steps] * k[:, :, steps] * vdy[:, :, steps, None]).sum(2)
    return dr[:, :, :T], dk[:, :, :T], dv[:, :, :T], dw[:, :, :T], du.sum(0), ds0


@pytest.mark.parametrize("T,chunk,cols,group,with_state", [
    (37, 16, 6, 4, True),  # T not a multiple of the chunk, ragged column slices
    (37, 16, 16, 4, False),  # the model's call: no state, no final-state gradient
    (19, 5, 7, 2, True),  # many chunks and groups, the last ones short
    (1, 16, 16, 4, True),  # one step
])
def test_wkv6_bwd_three_phase_twin_matches_the_reverse_recurrence_and_jax_vjp(
        T, chunk, cols, group, with_state):
    """The backward kernel's three phases, rehearsed in float32 on the CPU
    with w drawn down to 1e-12 (where a decay taken as a quotient of
    cumulative products would overflow), against ``wkv6_bwd_plain`` and
    ``jax.vjp`` of the reference recurrence; tolerance BWD_TOL of each
    gradient's largest value (sums in another order)."""
    B, H, D = 2, 3, 16
    args, dy, ds = _wkv6_bwd_case(T + chunk, B=B, H=H, T=T, D=D)
    rng = np.random.default_rng(T)
    w = np.exp(rng.uniform(np.log(1e-12), np.log(0.999), size=(B, H, T, D))).astype(np.float32)
    args = (*args[:3], w, *args[4:])
    s0 = torch.from_numpy(args[5]) if with_state else None
    dst = torch.from_numpy(ds) if with_state else None
    t_args = [torch.from_numpy(a) for a in args[:5]]
    got = _wkv6_bwd_three_phase(*t_args, s0, torch.from_numpy(dy), dst, chunk, cols, group)
    plain = tref.wkv6_bwd_plain(*t_args, s0, torch.from_numpy(dy), dst)
    j_args = [jnp.asarray(a) for a in args[:5]]
    if with_state:
        _, vjp = jax.vjp(jref.wkv6_reference, *j_args, jnp.asarray(args[5]))
        want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    else:
        _, vjp = jax.vjp(lambda *a: jref.wkv6_reference(*a)[0], *j_args)
        want = (*vjp(jnp.asarray(dy)), np.asarray(plain[5]))
    assert float(w.min()) < 1e-10
    for name, g, p, wnt in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, plain, want):
        assert torch.isfinite(g).all(), name
        _close_grads([g], [p.numpy()], f"{name} vs the reverse recurrence")
        _close_grads([g], [wnt], f"{name} vs jax.vjp")


def test_cpu_gradients_take_the_plain_versions_and_launch_nothing():
    """On the CPU, autograd differentiates the plain versions through
    ``ops``; no kernel, forward or backward, is launched."""
    ops.reset_launches()
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(7, 1, 4, 2, 9, 9, 16))
    ops.flash_attention(q, k, v).sum().backward()
    args = [torch.from_numpy(a).requires_grad_() for a in _wkv6_inputs(8, 1, 2, 5, 16)]
    y, s = ops.wkv6(*args)
    (y.sum() + s.sum()).backward()
    assert all(t.grad is not None for t in [q, k, v] + args)
    assert sum(ops.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="state_out"):
        ops.wkv6(*args, state_out=torch.zeros(1, 2, 16, 16))


def test_backward_kernel_wrappers_refuse_cpu_tensors_before_any_build():
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    from repro_torch.kernels.wkv6 import wkv6_bwd_cuda

    ops.reset_launches()
    x = torch.zeros((1, 2, 3, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(x, x, x, x, torch.zeros((1, 2, 3)), x)
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_bwd_cuda(x, x, x, x, torch.zeros((2, 16)), None, x)
    assert sum(ops.LAUNCHES.values()) == 0
