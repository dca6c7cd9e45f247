"""The port's kernel module (``repro_torch.kernels``) against the JAX
package: plain versions vs ``repro.kernels.ref``, the Pallas kernels in
interpret mode and ``jax.ops.segment_sum``; and the device dispatch.
The CUDA kernels themselves are held to these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Inputs are made from a seed with numpy and handed to both packages."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import strings as jstrings
from repro.kernels import ref as jref
from repro.kernels.hash32x2 import hash32x2_pallas
from repro.kernels.segment_reduce import run_ranks_sorted as j_run_ranks
from repro.kernels.segment_reduce import segment_sum_sorted_pallas
from repro.kernels.substr_find import exists_before_pallas, substr_find_pallas
from repro_torch.core import strings as tstrings
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda, flash_attention_sm90,
)
from repro_torch.kernels.hash32x2 import hash32x2_cuda, hash32x2_plain
from repro_torch.kernels import wkv6 as twkv6
from repro_torch.kernels.segment_reduce import (
    run_ranks_sorted, segment_path, segment_sum_cuda,
)
from repro_torch.kernels.substr_find import (
    MODE_LAUNCHES, exists_before_cuda, exists_before_plain, substr_find_cuda, substr_find_plain,
)
from repro_torch.kernels.wkv6 import wkv6_cuda


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
# hash32x2
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 7, 1024, 3000])
@pytest.mark.parametrize("k", [1, 2, 5])
def test_hash32x2_plain_matches_pallas_and_ref(n, k):
    rng = np.random.default_rng(n * 31 + k)  # the inputs of tests/test_kernels.py
    cols = rng.integers(0, 2**31, size=(n, k), dtype=np.int32)
    got = hash32x2_plain(_t(cols)).numpy()
    pallas = np.asarray(hash32x2_pallas(jnp.asarray(cols), block_rows=256))
    want = np.asarray(jref.hash32x2(jnp.asarray(cols)))
    assert got.dtype == np.uint32 and got.shape == (n, 2)
    np.testing.assert_array_equal(got, pallas)  # bit for bit
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ops.hash32x2(_t(cols)).numpy(), want)
    np.testing.assert_array_equal(tref.hash32x2(_t(cols)).numpy(), want)


@pytest.mark.parametrize("shape", [(0, 3), (6, 0), (0, 0)])
def test_hash32x2_no_rows_or_no_columns_match_ref(shape):
    # the Pallas kernel cannot take an empty block (no grid step, or a zero
    # width); the reference's loop gives no rows, or the two seeds per row
    cols = np.zeros(shape, np.int32)
    got = hash32x2_plain(_t(cols)).numpy()
    want = np.asarray(jref.hash32x2(jnp.asarray(cols)))
    assert got.dtype == np.uint32 and got.shape == (shape[0], 2)
    np.testing.assert_array_equal(got, want)
    if shape[1] == 0:
        np.testing.assert_array_equal(got, np.tile(np.array([0x9E3779B9, 0x7F4A7C15], np.uint32), (shape[0], 1)))


@pytest.mark.parametrize("dtype", [np.int32, np.uint32])
def test_hash32x2_high_bit_inputs_match_pallas_and_ref(dtype):
    # negative int32 is read as its uint32 bits; uint32 at and above 2^31
    rng = np.random.default_rng(41)
    if dtype == np.int32:
        cols = rng.integers(-(2**31), 0, size=(777, 3)).astype(np.int32)
        cols[0] = [-1, -(2**31), -2]
    else:
        cols = rng.integers(2**31, 2**32, size=(777, 3)).astype(np.uint32)
        cols[0] = [2**31, 2**32 - 1, 2**32 - 2]
    got = ops.hash32x2(_t(cols)).numpy()
    np.testing.assert_array_equal(got, np.asarray(hash32x2_pallas(jnp.asarray(cols), block_rows=256)))
    np.testing.assert_array_equal(got, np.asarray(jref.hash32x2(jnp.asarray(cols))))
    # the same bits give the same hashes whichever the dtype
    np.testing.assert_array_equal(got, hash32x2_plain(_t(cols.view(np.uint32 if dtype == np.int32 else np.int32))).numpy())


def test_fmix32_matches_ref():
    x = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 0x9E3779B9], np.uint32)
    got = tref.fmix32(torch.as_tensor(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, np.asarray(jref.fmix32(jnp.asarray(x))).astype(np.int64))


def test_hash32x2_distributes():
    rng = np.random.default_rng(0)
    cols = rng.integers(0, 1000, size=(20000, 2), dtype=np.int32)
    h = ops.hash32x2(_t(cols)).numpy()
    buckets = h[:, 0] % 16
    counts = np.bincount(buckets, minlength=16)
    assert counts.min() > 0.8 * counts.mean()  # roughly uniform


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


def _edge_rows(seed, n, L, a: bytes, b: bytes):
    """Rows of L bytes (NUL and bytes >= 0x80 among them, random past each
    length) with lengths -1, 0, L, L + 3 and 0..L; some rows end in ``a``,
    some hold ``a`` first and ``b`` last, some start with "aaab"."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"aab\x00\x80\xffspecial", np.uint8)
    buf = alphabet[rng.integers(0, alphabet.size, (n, L))]
    lens = rng.integers(0, L + 1, n).astype(np.int32)
    lens[:4] = (-1, 0, L, L + 3)
    for r in range(4, n):
        e = int(min(lens[r], L))
        if r % 4 == 1 and len(a) <= e:
            buf[r, e - len(a):e] = np.frombuffer(a, np.uint8)
        elif r % 4 == 2 and len(a) + len(b) <= e:
            buf[r, :len(a)] = np.frombuffer(a, np.uint8)
            buf[r, e - len(b):e] = np.frombuffer(b, np.uint8)
        elif r % 4 == 3 and e >= 4:
            buf[r, :4] = np.frombuffer(b"aaab", np.uint8)
    return buf, lens


def _exists_before_truth(buf, lens, a: bytes, b: bytes):
    out = []
    for row, n in zip(buf, lens):
        s = row[: max(0, min(int(n), row.size))].tobytes()
        i = s.find(a)
        out.append(i >= 0 and s.find(b, i + len(a)) >= 0)
    return np.array(out)


@pytest.mark.parametrize("L,a,b", [
    (1, b"a", b"a"),                      # a == b, m == L
    (15, b"aab", b"\x80\x00"),           # self-overlapping a; bytes >= 0x80 and NUL
    (17, b"special", b"spe"),             # b a prefix of a
    (37, b"\xffa", b"aab"),
    (16, b"", b"ab"),                     # a empty: b searched from 0
    (16, b"ab", b""),                     # b empty: true where a occurs
    (16, b"", b""),                       # both empty: every row, any length
    (16, b"x" * 17, b"a"),                # a longer than L
    (16, b"a", b"x" * 17),                # b longer than L
])
def test_exists_before_plain_matches_pallas_ref_and_python(L, a, b):
    buf, lens = _edge_rows(L * 7 + len(a), 64, L, a, b)
    pa, pb = np.frombuffer(a, np.uint8), np.frombuffer(b, np.uint8)
    got = exists_before_plain(_t(buf), _t(lens), _t(pa), _t(pb)).numpy()
    pallas = np.asarray(exists_before_pallas(
        jnp.asarray(buf), jnp.asarray(lens), jnp.asarray(pa), jnp.asarray(pb), block_rows=64))
    want = np.asarray(jref.exists_before(jnp.asarray(buf), jnp.asarray(lens), jnp.asarray(pa),
                                         jnp.asarray(pb)))
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)  # exact
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, _exists_before_truth(buf, lens, a, b))


def test_ops_exists_before_takes_the_plain_route_on_cpu():
    buf, lens = _edge_rows(3, 40, 24, b"special", b"aab")
    pa, pb = _t(np.frombuffer(b"special", np.uint8)), _t(np.frombuffer(b"aab", np.uint8))
    MODE_LAUNCHES["exists_before"] = 5  # reset_launches zeroes the counts by form too
    ops.reset_launches()
    got = ops.exists_before(_t(buf), _t(lens), pa, pb)
    assert torch.equal(got, exists_before_plain(_t(buf), _t(lens), pa, pb))
    assert torch.equal(got, tref.exists_before(_t(buf), _t(lens), pa, pb))
    assert MODE_LAUNCHES == {"find": 0, "exists_before": 0}
    assert sum(ops.LAUNCHES.values()) == 0


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


@pytest.mark.parametrize("m,path", [
    (1, "few"), (6, "few"), (16, "few"), (17, "mid"), (4096, "mid"), (4097, "many"),
    (1_500_000, "many"),
])
def test_segment_sum_path_by_number_of_segments(m, path):
    assert segment_path(m) == path


@pytest.mark.parametrize("dtype", ["float64", "int64", "float32"])
@pytest.mark.parametrize("m", [1, 2, 6, 15, 16, 17, 4096, 4097])
def test_segment_sum_at_the_path_bounds_matches_jax(dtype, m):
    """The kernel's path bounds, runs of 1 to 7 equal ids (as lineitem's
    order keys), ids out of range, and an odd length (n = 1001): the
    plain version against ``jax.ops.segment_sum``."""
    rng = np.random.default_rng(m)
    starts = np.sort(rng.integers(-2, m + 2, 400))
    ids = np.repeat(starts, rng.integers(1, 8, starts.size))[:1001]
    if dtype == "int64":
        vals = rng.integers(-(1 << 50), 1 << 50, ids.size)
    else:
        vals = (rng.normal(size=ids.size) * 1e4).astype(dtype)
    got = ops.segment_sum(_t(vals), _t(ids), m).numpy()
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(ids), m))
    assert got.dtype == np.dtype(dtype) and got.shape == (m,)
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
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.exists_before(packed, lens, torch.zeros(2, dtype=torch.uint8, device="meta"),
                          torch.zeros(1, dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.hash32x2(torch.zeros((4, 2), dtype=torch.int32, device="meta"))


def test_cuda_wrappers_refuse_cpu_tensors_before_any_build():
    ops.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        segment_sum_cuda(torch.zeros(3, dtype=torch.float64), torch.zeros(3, dtype=torch.int64), 2)
    with pytest.raises(ValueError, match="CUDA"):
        substr_find_cuda(
            torch.zeros((3, 4), dtype=torch.uint8), torch.zeros(3, dtype=torch.int32),
            torch.zeros(1, dtype=torch.uint8),
        )
    with pytest.raises(ValueError, match="CUDA"):
        exists_before_cuda(
            torch.zeros((3, 4), dtype=torch.uint8), torch.zeros(3, dtype=torch.int32),
            torch.zeros(1, dtype=torch.uint8), torch.zeros(2, dtype=torch.uint8),
        )
    x = torch.zeros((1, 2, 3, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_sm90(x.bfloat16(), x.bfloat16(), x.bfloat16())
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_cuda(x, x, x, x, torch.zeros((2, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        hash32x2_cuda(torch.zeros((3, 2), dtype=torch.int32))
    assert ops.LAUNCHES == {name: 0 for name in (
        "segment_sum", "substr_find", "wkv6", "flash_attention_sm90",
        "flash_attention_f32_sm90", "hash32x2", "flash_attention_bwd_sm90",
        "flash_attention_bwd_f32_sm90", "wkv6_bwd")}
    assert MODE_LAUNCHES == {"find": 0, "exists_before": 0}


def test_wkv6_signature_cache_checks_each_new_signature_in_full():
    """A signature (shapes, dtypes, strides, devices, optional tensors)
    is checked once and its launch arguments kept; a call that differs
    from a cached one in any of them is checked anew and refused."""
    B, H, T, D = 2, 3, 1, 16
    heads = lambda dtype=torch.bfloat16: torch.zeros((B, T, H, D), dtype=dtype).transpose(1, 2)
    r, k, v, w = heads(), heads(), heads(), heads()
    u = torch.zeros((H, D), dtype=torch.bfloat16)
    S = torch.zeros((B, H, D, D))
    plan = twkv6.wkv6_launch_plan(r, k, v, w, u, S, S)
    assert twkv6.wkv6_launch_plan(r, k, v, w, u, S, S) is plan
    S2 = S.clone()
    assert twkv6.wkv6_launch_plan(heads(), heads(), heads(), heads(), u.clone(), S2,
                                  S2) is plan  # same signature, other tensors
    apart = twkv6.wkv6_launch_plan(r, k, v, w, u, S, S.clone())  # state_out not the state
    assert apart is not plan and list(apart.dims) == list(plan.dims)
    assert list(plan.dims) == [B, H, T, D] + list(r.stride()[:3]) * 4
    assert (plan.dtype, plan.cast_state, plan.empty) == (1, False, False)
    with pytest.raises(ValueError, match="shape"):
        twkv6.wkv6_launch_plan(r, k[:, :2], v, w, u, S, S)
    with pytest.raises(ValueError, match="shape"):
        twkv6.wkv6_launch_plan(r, k, v, w, u, S, S[:1])
    with pytest.raises(TypeError, match="is torch.float32"):
        twkv6.wkv6_launch_plan(r, heads(torch.float32), v, w, u, S, S)
    with pytest.raises(ValueError, match="stride 1 on D"):
        twkv6.wkv6_launch_plan(r, k, torch.zeros((B, H, T, 2 * D), dtype=r.dtype)[..., ::2],
                               w, u, S, S)
    with pytest.raises(ValueError, match="on meta"):
        twkv6.wkv6_launch_plan(r, k, v, w, u.to("meta"), S, S)
    with pytest.raises(ValueError, match="contiguous float32"):
        twkv6.wkv6_launch_plan(r, k, v, w, u, S, S.transpose(2, 3))
    # a state of another dtype is passed as a float32 copy
    assert twkv6.wkv6_launch_plan(r, k, v, w, u, S.double()).cast_state


def test_wkv6_float32_u_is_cast_once_and_again_after_an_update():
    u = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 16))).to(torch.bfloat16)
    a = twkv6._u_f32(u)
    assert a.dtype == torch.float32 and twkv6._u_f32(u) is a
    u.add_(1.0)  # an in-place update bumps the version counter
    b = twkv6._u_f32(u)
    assert b is not a and torch.equal(b, u.float())
    f = torch.zeros((3, 16))
    assert twkv6._u_f32(f) is f  # already float32 and contiguous: no copy


def test_plain_versions_launch_nothing_on_cpu():
    ops.reset_launches()
    ops.segment_sum(torch.ones(10, dtype=torch.int64), torch.arange(10) % 3, 3)
    buf, lens = _pack(["abc", "xabc"], 8)
    ops.exists_before(_t(buf), _t(lens), _t(np.frombuffer(b"a", np.uint8)), _t(np.frombuffer(b"c", np.uint8)))
    ops.hash32x2(torch.zeros((5, 2), dtype=torch.int32))
    assert ops.LAUNCHES == {name: 0 for name in (
        "segment_sum", "substr_find", "wkv6", "flash_attention_sm90",
        "flash_attention_f32_sm90", "hash32x2", "flash_attention_bwd_sm90",
        "flash_attention_bwd_f32_sm90", "wkv6_bwd")}


def test_backward_routes_bf16_to_the_tensor_core_kernel_and_f32_to_the_cuda_cores():
    """The backward's plan, as the card would launch it: bf16 goes to
    ``flash_attention_bwd_sm90`` with its padded lse/Delta buffer and
    layouts the copy engine can describe (others copied), float32 to
    ``flash_attention_bwd_f32_sm90`` (split TF32 on the tensor cores) with
    its lse/Delta buffer and its split scratch; no other dtype."""
    from repro_torch.kernels import flash_attention as tfa

    B, Hq, Hkv, Sq, Sk, D = 2, 6, 2, 37, 50, 64
    f32_scratch = ((B * Hq, Sq, 128), (B * Hq, Sq, 128), (B * Hkv, Sk, 128), (B * Hkv, Sk, 128),
                   (B * Hq, 2, 64, 64), (B * Hq, 2, 64, 64), (B * Hkv, 2, 64, 64))
    for dtype, name, rows, scratch in (
            (torch.bfloat16, "flash_attention_bwd_sm90", (B * Hq * 2 * 192,), ()),
            (torch.float32, "flash_attention_bwd_f32_sm90", (B * Hq * 2 * 64,), f32_scratch)):
        q = torch.zeros((B, Sq, Hq, D), dtype=dtype).transpose(1, 2)  # the model's strides
        k, v = torch.zeros((B, Hkv, Sk, D), dtype=dtype), torch.zeros((B, Hkv, Sk, D), dtype=dtype)
        do = torch.zeros((B, Hq, Sq, D), dtype=dtype)
        plan = tfa.bwd_launch_plan(q, k, v, do)
        assert (plan.name, tuple(plan.rows), plan.scratch) == (name, rows, scratch)
        assert plan.q is q and plan.k is k and plan.do is do  # taken as they are
        assert ops.LAUNCHES[name] == 0
    assert tfa.bwd_ld_elements(1, 40, 4096) == 40 * 2 * 4224  # 22 tiles of 192 queries
    assert tfa.bwd_ld_elements(1, 1, 1) == 2 * 192
    assert tfa.bwd_ld_elements(1, 40, 4096, torch.float32) == 40 * 2 * 4096
    assert tfa.bwd_ld_elements(1, 1, 1, torch.float32) == 2 * 64
    # a bf16 sequence stride of 36 elements (72 bytes) is no multiple of 16 bytes
    odd = torch.zeros((1, 4, 3, 36), dtype=torch.bfloat16)[..., :32]
    plan = tfa.bwd_launch_plan(odd, odd[:, :2], odd[:, :2], odd)
    assert plan.q is not odd and plan.q.is_contiguous() and torch.equal(plan.q, odd)
    with pytest.raises(KeyError):
        tfa.bwd_launch_plan(*(odd.half(),) * 4)


@pytest.mark.parametrize("B,H,T,D", [(1, 64, 4096, 64), (2, 3, 17, 16), (1, 2, 1, 128)])
def test_wkv6_bwd_scratch_is_the_states_at_chunk_boundaries(B, H, T, D):
    """The chunk-parallel backward's scratch: the forward state before each
    chunk of BWD_CHUNK steps, the state's gradient after each group of
    BWD_GROUP chunks, and each chunk's du (268 MB and 67 MB of states at
    RWKV6-7B's training shape)."""
    chunks = -(-T // twkv6.BWD_CHUNK)
    groups = -(-chunks // twkv6.BWD_GROUP)
    assert twkv6.bwd_scratch_sizes(B, H, T, D) == (
        B * H * chunks * D * D, B * H * groups * D * D, B * H * chunks * D)
    if (B, H, T, D) == (1, 64, 4096, 64):
        assert [n * 4 for n in twkv6.bwd_scratch_sizes(B, H, T, D)[:2]] == [
            268_435_456, 67_108_864]
    if T == 1:
        assert twkv6.bwd_scratch_sizes(B, H, T, D)[1] == B * H * D * D


# ----------------------------------------------------------------------
# K4's float32 kernels: split TF32 on the tensor cores, twinned on the CPU
# ----------------------------------------------------------------------
#: the float32 tolerances the kernels are held to on the card
#: (``ATTN_TOL["float32"]`` and ``BWD_TOL["float32"]`` of chip_smoke.py)
F32_ATTN_TOL, F32_BWD_TOL = 2e-5, 1e-4


def _tf32_matmul(a, b, terms):
    """a @ b as the float32 kernels' tensor cores take it, accumulated in
    float32: split TF32 (terms 3: a_lo b_hi + a_hi b_lo + a_hi b_hi, the
    small terms first) or one TF32 product (terms 1)."""
    from repro_torch.kernels.flash_attention import split_tf32

    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh if terms == 3 else ah @ bh


def _kv_and_mask(q, k, v, causal):
    B, Hq, Sq, D = q.shape
    Sk = k.shape[2]
    group = Hq // k.shape[1]
    keep = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        keep = torch.arange(Sk)[None, :] <= torch.arange(Sq)[:, None] + (Sk - Sq)
    return k.repeat_interleave(group, 1), v.repeat_interleave(group, 1), keep


def _attention_tf32(q, k, v, causal, terms):
    """K4's forward as the float32 kernel computes it: S = Q K^T, the
    online softmax's P = exp(S - m) split again, O = P V / l."""
    kk, vv, keep = _kv_and_mask(q, k, v, causal)
    s = _tf32_matmul(q, kk.transpose(-1, -2), terms) / math.sqrt(q.shape[-1])
    s = s.masked_fill(~keep, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return _tf32_matmul(p, vv, terms) / p.sum(-1, keepdim=True)


def _attention_bwd_tf32(q, k, v, o, lse, do, causal, terms):
    """K4's backward formulas (those of ``flash_attention_bwd_plain``)
    with each of the five products taken as the float32 kernel takes it."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    kk, vv, keep = _kv_and_mask(q, k, v, causal)
    scale = 1.0 / math.sqrt(D)
    s = _tf32_matmul(q, kk.transpose(-1, -2), terms) * scale
    p = torch.exp(s - lse[..., None]).masked_fill(~keep, 0.0)
    dv = _tf32_matmul(p.transpose(-1, -2), do, terms)
    dp = _tf32_matmul(do, vv.transpose(-1, -2), terms)
    ds = p * (dp - (do * o).sum(-1, keepdim=True))
    dq = _tf32_matmul(ds, kk, terms) * scale
    dk = _tf32_matmul(ds.transpose(-1, -2), q, terms) * scale
    fold = lambda t: t.reshape(B, Hkv, Hq // Hkv, Sk, D).sum(2)
    return dq, fold(dk), fold(dv)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal", [
    (1, 4, 2, 70, 90, 16, True), (1, 4, 2, 70, 90, 16, False),
    (2, 2, 1, 33, 50, 64, True), (2, 2, 1, 33, 50, 64, False),
    (1, 4, 2, 65, 100, 80, True), (1, 4, 2, 65, 100, 80, False),
    (1, 4, 2, 65, 100, 128, True), (1, 4, 2, 65, 100, 128, False),
    # cross-attention: more queries than keys, no causal mask
    (1, 2, 1, 100, 40, 128, False), (1, 5, 1, 41, 17, 64, False),
])
def test_split_tf32_attention_meets_the_float32_tolerances(B, Hq, Hkv, Sq, Sk, D, causal):
    """The float32 kernels' arithmetic on the CPU: K4's forward and
    backward formulas with every product in split TF32 stay within the
    float32 tolerances of the plain versions (and the forward of the JAX
    reference); one TF32 product a product, 11 bits of each operand, does
    not, which is why each product is three."""
    from repro_torch.kernels.flash_attention import (
        attention_lse_plain, flash_attention_bwd_plain, flash_attention_plain,
    )

    rng = np.random.default_rng(Sq * 7 + Sk + D)
    q, do = (rng.normal(size=(B, Hq, Sq, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32) for _ in range(2))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    want = flash_attention_plain(tq, tk, tv, causal)
    jwant = torch.from_numpy(np.array(jref.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)))
    lse = attention_lse_plain(tq, tk, causal)
    bwant = flash_attention_bwd_plain(tq, tk, tv, want, lse, tdo, causal)
    scale = max(float(w.abs().max()) for w in bwant)
    errs = {}
    for terms in (3, 1):
        got = _attention_tf32(tq, tk, tv, causal, terms)
        fwd_ok = all(bool(((got - w).abs() <= F32_ATTN_TOL + F32_ATTN_TOL * w.abs()).all())
                     for w in (want, jwant))
        grads = _attention_bwd_tf32(tq, tk, tv, want, lse, tdo, causal, terms)
        bwd_err = max(float((g - w).abs().max()) for g, w in zip(grads, bwant)) / scale
        errs[terms] = (fwd_ok, bwd_err)
    assert errs[3][0] and errs[3][1] <= F32_BWD_TOL, errs
    assert not errs[1][0] and errs[1][1] > F32_BWD_TOL, errs


def test_tf32_round_is_cvt_rna():
    """``tf32_round`` is PTX ``cvt.rna.tf32.f32``: 10 mantissa bits, to
    nearest, ties away from zero; the split's parts reconstruct x to 2^-21
    of |x| and have their low 13 bits clear."""
    from repro_torch.kernels.flash_attention import split_tf32, tf32_round

    one = 1.0 + 2.0 ** -11  # exactly half an ulp of TF32 above 1
    got = tf32_round(torch.tensor([one, -one, 1.0 + 2.0 ** -12, 3.0, 0.0, -0.0]))
    assert got.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0, 0.0, 0.0]
    rng = np.random.default_rng(3)
    x = (rng.normal(size=20_000) * 10.0 ** rng.integers(-20, 20, 20_000)).astype(np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(x.astype(np.float64)))) - 10)
    want = np.sign(x) * np.floor(np.abs(x.astype(np.float64)) / ulp + 0.5) * ulp
    np.testing.assert_array_equal(tf32_round(torch.from_numpy(x)).numpy(), want.astype(np.float32))
    hi, lo = split_tf32(torch.from_numpy(x))
    for part in (hi, lo):
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    err = np.abs(hi.double().numpy() + lo.double().numpy() - x.astype(np.float64))
    assert bool((err <= 2.0 ** -21 * np.abs(x)).all())


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D", [(2, 3, 1, 37, 45, 80), (1, 2, 2, 8, 64, 16),
                                              (1, 4, 2, 1, 1, 128)])
def test_f32_split_layouts_reconstruct_and_permute_the_keys(B, Hq, Hkv, Sq, Sk, D):
    """The plain version of the float32 kernels' split: the rows' hi and lo
    halves (DQ columns each, zeros past D) add up to the input, and the
    transposed copy (hi then lo, DV rows, zeros past D and S) holds key
    8 g + KEY_ORDER[p] at position 8 g + p, which makes the accumulator's
    columns (2t, 2t + 1) the A fragment's (t, t + 4): P V through the
    permuted copy is P V.  Shapes are those the wrappers allocate."""
    from repro_torch.kernels import flash_attention as tfa

    rng = np.random.default_rng(D + Sk)
    q, do = (torch.from_numpy(rng.normal(size=(B, Hq, Sq, D)).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32)) for _ in range(2))
    qs, ks, vt = tfa.f32_split_plain(q, k, v)
    assert tuple(t.shape for t in (qs, ks, vt)) == tfa.f32_scratch_shapes(B, Hq, Hkv, Sq, Sk, D)
    bwd = tfa.f32_split_plain(q, k, v, do)
    assert tuple(t.shape for t in bwd) == tfa.f32_scratch_shapes(B, Hq, Hkv, Sq, Sk, D,
                                                                 backward=True)
    assert torch.equal(bwd[0], qs) and torch.equal(bwd[2], ks)
    DQ, DV = tfa.f32_widths(D)
    for x, rows in ((q, qs), (k, ks), (do, bwd[1]), (v, bwd[3])):
        halves = rows.reshape(-1, x.shape[2], 2, DQ).double()
        assert not bool(halves[..., D:].any())
        recon = halves[:, :, 0, :D] + halves[:, :, 1, :D]
        flat = x.reshape(-1, x.shape[2], D).double()
        assert bool(((recon - flat).abs() <= 2.0 ** -21 * flat.abs()).all())
    assert [tfa.KEY_ORDER[t] for t in range(4)] == [0, 2, 4, 6]
    assert [tfa.KEY_ORDER[t + 4] for t in range(4)] == [1, 3, 5, 7]
    for x, cols in ((v, vt), (q, bwd[4]), (do, bwd[5]), (k, bwd[6])):
        S = x.shape[2]
        Sp = cols.shape[-1]
        assert Sp % 32 == 0 and Sp >= S and cols.shape[2] == DV
        whole = cols[:, 0].double() + cols[:, 1].double()  # (B H, DV, Sp)
        assert not bool(whole[:, D:].any())
        key = torch.arange(Sp) // 8 * 8 + torch.tensor(tfa.KEY_ORDER).repeat(Sp // 8)
        flat = x.reshape(-1, S, D).double()
        for p in range(Sp):
            if key[p] < S:
                assert bool(((whole[:, :D, p] - flat[:, key[p]]).abs()
                             <= 2.0 ** -21 * flat[:, key[p]].abs()).all())
            else:
                assert not bool(whole[:, :, p].any())
        # P (rows x S) times x through the permuted copy: P's columns in key order
        P = torch.from_numpy(rng.normal(size=(5, S))).double()
        Pp = torch.zeros((5, Sp), dtype=torch.float64)
        Pp[:, key < S] = P[:, key[key < S]]
        torch.testing.assert_close(torch.einsum("rs,bds->brd", Pp, whole)[..., :D],
                                   torch.einsum("rs,bsd->brd", P, flat),
                                   rtol=1e-5, atol=1e-5)


def test_float32_attention_routes_to_the_split_tf32_kernels():
    """Both float32 routes name the tensor-core kernels in split TF32, and
    no float32 kernel on the CUDA cores is left; no wrapper takes a CPU
    tensor."""
    from repro_torch.kernels import flash_attention as tfa

    assert tfa.FWD_KERNELS == {torch.bfloat16: "flash_attention_sm90",
                               torch.float32: "flash_attention_f32_sm90"}
    assert tfa.BWD_KERNELS[torch.float32] == "flash_attention_bwd_f32_sm90"
    assert "flash_attention_bwd" not in ops.LAUNCHES and "flash_attention" not in ops.LAUNCHES
    ops.reset_launches()
    x = torch.zeros((1, 2, 3, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd_cuda(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_cuda(x, x, x, x, torch.zeros((1, 2, 3)), x)
    assert sum(ops.LAUNCHES.values()) == 0
