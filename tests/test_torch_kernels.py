"""The port's kernel module (``repro_torch.kernels``) against the JAX
package: plain versions vs ``repro.kernels.ref``, the Pallas kernels in
interpret mode and ``jax.ops.segment_sum``; and the device dispatch.
The CUDA kernels themselves are held to these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Inputs are made from a seed with numpy and handed to both packages."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import strings as jstrings
from repro.kernels import ref as jref
from repro.kernels.segment_reduce import run_ranks_sorted as j_run_ranks
from repro.kernels.segment_reduce import segment_sum_sorted_pallas
from repro.kernels.substr_find import exists_before_pallas, substr_find_pallas
from repro_torch.core import strings as tstrings
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.segment_reduce import run_ranks_sorted, segment_sum_cuda
from repro_torch.kernels.substr_find import substr_find_cuda, substr_find_plain


@pytest.fixture(autouse=True, scope="module")
def _x64_on(_x64_policy):
    # the conftest policy turns x64 off for this file's prefix; the
    # engine-level comparisons need exact int64 / float64 on both sides
    jax.config.update("jax_enable_x64", True)
    yield


def _pack(strings, L):
    n = len(strings)
    buf = np.zeros((n, L), np.uint8)
    lens = np.zeros((n,), np.int32)
    for i, s in enumerate(strings):
        b = s.encode()[:L]
        buf[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return buf, lens


def _random_strings(seed, n, L):
    rng = np.random.default_rng(seed)
    alphabet = list("abspecialx yz")
    return ["".join(rng.choice(alphabet, rng.integers(0, L))) for _ in range(n)]


def _t(a):
    return torch.as_tensor(np.array(a))  # a writable copy


# ----------------------------------------------------------------------
# substr_find / exists_before
# ----------------------------------------------------------------------
@pytest.mark.parametrize("L,pat", [(16, "ab"), (64, "special"), (128, "x")])
def test_substr_find_plain_matches_pallas_and_ref(L, pat):
    strs = _random_strings(L * 131 + len(pat), 733, L)
    buf, lens = _pack(strs, L)
    p = np.frombuffer(pat.encode(), np.uint8)
    got = substr_find_plain(_t(buf), _t(lens), _t(p)).numpy()
    pallas = np.asarray(substr_find_pallas(jnp.asarray(buf), jnp.asarray(lens), jnp.asarray(p), block_rows=128))
    want = np.asarray(jref.substr_find(jnp.asarray(buf), jnp.asarray(lens), jnp.asarray(p)))
    truth = np.array([s.find(pat) if len(s) else -1 for s in strs], np.int32)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)  # exact
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, truth)


@pytest.mark.parametrize("pat", ["", "a", "special", "x" * 17])
def test_substr_find_start_and_edge_lengths_match_ref(pat):
    rng = np.random.default_rng(5)
    L = 16
    buf, lens = _pack(_random_strings(11, 300, L), L)
    start = rng.integers(-3, L + 2, 300).astype(np.int32)
    p = np.frombuffer(pat.encode(), np.uint8)
    for st in (None, start):
        got = substr_find_plain(_t(buf), _t(lens), _t(p), None if st is None else _t(st))
        want = jref.substr_find(
            jnp.asarray(buf), jnp.asarray(lens), jnp.asarray(p),
            None if st is None else jnp.asarray(st),
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # exact


def test_exists_before_matches_pallas_ref_and_python():
    strs = [
        "the special customer filed requests",
        "requests then special",
        "special",
        "",
        "specialrequests",
        "many special words and more requests here",
    ]
    buf, lens = _pack(strs, 64)
    a, b = np.frombuffer(b"special", np.uint8), np.frombuffer(b"requests", np.uint8)
    got_ref = tref.exists_before(_t(buf), _t(lens), _t(a), _t(b)).numpy()
    got_ops = ops.exists_before(_t(buf), _t(lens), _t(a), _t(b)).numpy()
    pallas = np.asarray(exists_before_pallas(
        jnp.asarray(buf), jnp.asarray(lens), jnp.asarray(a), jnp.asarray(b), block_rows=128
    ))
    want = np.asarray(jref.exists_before(jnp.asarray(buf), jnp.asarray(lens), jnp.asarray(a), jnp.asarray(b)))

    def truth(s):
        i = s.find("special")
        return i >= 0 and s.find("requests", i + len("special")) >= 0

    for got in (got_ref, got_ops):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, pallas)
        np.testing.assert_array_equal(got, np.array([truth(s) for s in strs]))


@pytest.mark.parametrize("pat", ["special", "zz", ""])
def test_engine_string_search_matches_jax_engine(pat):
    rng = np.random.default_rng(3)
    words = np.array(["special", "requests", "pending", "a", "zz", "ironic"], dtype=object)
    values = np.array(
        [" ".join(rng.choice(words, rng.integers(0, 6))) for _ in range(400)], dtype=object
    )
    jp, jl = jstrings.pack_strings(values, 32)
    tp, tl = tstrings.pack_strings(values, 32, torch.device("cpu"))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    start = rng.integers(0, 20, 400).astype(np.int32)
    got = tstrings.find_first(tp, tl, pat, start=_t(start)).numpy()
    want = np.asarray(jstrings.find_first(jp, jl, pat, start=jnp.asarray(start)))
    np.testing.assert_array_equal(got, want)  # exact
    got = tstrings.exists_before(tp, tl, pat, "requests").numpy()
    want = np.asarray(jstrings.exists_before(jp, jl, pat, "requests"))
    np.testing.assert_array_equal(got, want)  # exact


# ----------------------------------------------------------------------
# segment_sum
# ----------------------------------------------------------------------
@pytest.mark.parametrize(
    "n,m,gaps", [(1, 1, False), (100, 5, True), (4096, 4096, True)]
)
def test_segment_sum_sorted_matches_pallas(n, m, gaps):
    rng = np.random.default_rng(n + m)
    ids = np.sort(rng.integers(0, m, n)).astype(np.int32)
    if gaps:
        ids = np.sort(rng.choice(np.arange(0, 4 * m, 4), n)).astype(np.int32)
        m_eff = 4 * m
    else:
        m_eff = m
    vals = rng.normal(size=n).astype(np.float32)
    got = tref.segment_sum_sorted(_t(vals), _t(ids), m_eff).numpy()
    pallas = np.asarray(segment_sum_sorted_pallas(jnp.asarray(vals), jnp.asarray(ids), m_eff, block_rows=256))
    want = np.asarray(jref.segment_sum_sorted(jnp.asarray(vals), jnp.asarray(ids), m_eff))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)  # f32, as tests/test_kernels.py
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float64", "int64", "float32"])
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
def test_segment_sum_matches_jax_segment_sum(dtype, order):
    rng = np.random.default_rng(17)
    n, m = 5000, 700
    ids = rng.integers(-2, m + 2, n)  # out-of-range ids are dropped on both sides
    if order == "sorted":
        ids = np.sort(ids)
    if dtype == "int64":
        vals = rng.integers(-(1 << 50), 1 << 50, n)
    else:
        vals = (rng.normal(size=n) * 1e4).astype(dtype)
    got = ops.segment_sum(_t(vals), _t(ids), m).numpy()
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(ids), m))
    assert got.dtype == np.dtype(dtype)
    if dtype == "int64":
        np.testing.assert_array_equal(got, want)  # exact
    elif dtype == "float64":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_run_ranks_sorted_matches_jax():
    rng = np.random.default_rng(2)
    ids = np.sort(rng.integers(0, 50, 1000))
    got = run_ranks_sorted(_t(ids)).numpy()
    want = np.asarray(j_run_ranks(jnp.asarray(ids)))
    np.testing.assert_array_equal(got, want)
    assert run_ranks_sorted(torch.zeros(0, dtype=torch.int64)).shape == (0,)


# ----------------------------------------------------------------------
# dispatch
# ----------------------------------------------------------------------
def test_ops_dispatch_raises_on_other_devices():
    v = torch.zeros(4, dtype=torch.float64, device="meta")
    g = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.segment_sum(v, g, 2)
    packed = torch.zeros((4, 8), dtype=torch.uint8, device="meta")
    lens = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.substr_find(packed, lens, torch.zeros(2, dtype=torch.uint8, device="meta"))


def test_cuda_wrappers_refuse_cpu_tensors_before_any_build():
    ops.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        segment_sum_cuda(torch.zeros(3, dtype=torch.float64), torch.zeros(3, dtype=torch.int64), 2)
    with pytest.raises(ValueError, match="CUDA"):
        substr_find_cuda(
            torch.zeros((3, 4), dtype=torch.uint8), torch.zeros(3, dtype=torch.int32),
            torch.zeros(1, dtype=torch.uint8),
        )
    assert ops.LAUNCHES == {"segment_sum": 0, "substr_find": 0}


def test_plain_versions_launch_nothing_on_cpu():
    ops.reset_launches()
    ops.segment_sum(torch.ones(10, dtype=torch.int64), torch.arange(10) % 3, 3)
    buf, lens = _pack(["abc", "xabc"], 8)
    ops.exists_before(_t(buf), _t(lens), _t(np.frombuffer(b"a", np.uint8)), _t(np.frombuffer(b"c", np.uint8)))
    assert ops.LAUNCHES == {"segment_sum": 0, "substr_find": 0}
