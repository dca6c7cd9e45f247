"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and a query and the reduced LM path on the card against the
CPU path.

Every test needs a CUDA device and skips without one.  The file imports
neither jax nor the JAX package, so it also runs on a machine without
them (``tests/conftest.py`` imports jax, hence ``--noconftest``):

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import get
from repro_torch.core import oracle as orc
from repro_torch.core.config import CONFIG
from repro_torch.data import tpch
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
from repro_torch.kernels.hash32x2 import hash32x2_cuda, hash32x2_plain
from repro_torch.kernels.segment_reduce import segment_sum_cuda, segment_sum_plain
from repro_torch.kernels.substr_find import (
    MODE_LAUNCHES, exists_before_cuda, exists_before_plain, substr_find_cuda, substr_find_plain,
)
from repro_torch.kernels.wkv6 import _wkv6_launch, wkv6_cuda, wkv6_form, wkv6_plain
from repro_torch.models import lm
from repro_torch.models.config import reduced
from repro_torch import sql
from repro_torch.queries import tpch_frames, tpch_sql
from repro_torch.serve.engine import Request, ServeEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int64])
@pytest.mark.parametrize("n,m", [(1, 1), (10_000, 4), (10_000, 4096), (10_000, 50_000)])
def test_segment_sum_kernel_matches_plain(cuda_device, dtype, n, m):
    rng = np.random.default_rng(n + m)
    ids = torch.as_tensor(rng.integers(-1, m + 1, n), device=cuda_device)  # -1, m dropped
    vals = torch.as_tensor(rng.normal(size=n) * 100, device=cuda_device).to(dtype)
    got = segment_sum_cuda(vals, ids, m)
    want = segment_sum_plain(vals, ids, m)
    if dtype == torch.int64:
        assert torch.equal(got, want)
    else:
        # the kernel's exact sums on a grid and the plain version's adds
        # in row order round differently
        rtol = 1e-12 if dtype == torch.float64 else 1e-4
        torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * float(want.abs().max()))


def _segment_case(rng, n, m, order, dtype, device):
    """n + 1 ids for m segments (-1 and m among them: dropped) at random or
    in runs of 1 to 7 equal ids, and values of ``dtype``."""
    if order == "runs":
        starts = np.sort(rng.integers(-1, m + 1, (n + 1) // 2 + 2))  # 2n ids on average
        ids = np.repeat(starts, rng.integers(1, 8, starts.size))[:n + 1]
    else:
        ids = rng.integers(-1, m + 1, n + 1)
    if dtype == torch.int64:
        vals = rng.integers(-(1 << 40), 1 << 40, ids.size)
    else:
        vals = rng.normal(size=ids.size) * 100
    return (torch.as_tensor(vals, device=device).to(dtype),
            torch.as_tensor(ids, dtype=torch.int64, device=device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int64])
@pytest.mark.parametrize("m", [1, 2, 6, 15, 16, 17, 4096, 4097, 1_500_000])
@pytest.mark.parametrize("order", ["random", "runs"])
def test_segment_sum_paths_match_plain(cuda_device, dtype, m, order):
    """Each of the kernel's paths (few <= 16 < mid <= 4096 < many) at its
    bounds: odd lengths and lengths below a warp, runs of equal ids, ids
    out of range, and pointers one row off 16-byte alignment (both, or
    only the values: one row a thread)."""
    rng = np.random.default_rng(m)
    for n in (1, 2, 17, 31, 1001, 65_537, 3_000_001 if m == 1_500_000 else 200_003):
        vals, ids = _segment_case(rng, n, m, order, dtype, cuda_device)
        assert ids.numel() == n + 1
        for vs, gs in ((slice(0, n), slice(0, n)), (slice(1, None), slice(1, None)),
                       (slice(1, None), slice(0, n))):
            v, g = vals[vs], ids[gs]
            got = segment_sum_cuda(v, g, m)
            want = segment_sum_plain(v, g, m)
            if dtype == torch.int64:
                assert torch.equal(got, want), (n, vs, gs)
            else:
                # values of both signs: a sum's rounding in any order scales
                # with the sum of |value| over its segment, not with the sum
                rtol = 1e-12 if dtype == torch.float64 else 1e-4
                terms = float(segment_sum_plain(v.abs(), g, m).max())
                torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * max(terms, 1.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [6, 1000, 1_500_000])
def test_segment_sum_gives_the_same_bits_on_every_launch(cuda_device, dtype, m):
    """K1 is deterministic on each path: five launches on one input (ids
    at random, so a segment's rows meet in any order) return the same
    bits; and a call whose segments differ in magnitude by 2^100 holds
    each segment to its own scale."""
    rng = np.random.default_rng(m)
    n = 1_000_003
    ids = torch.as_tensor(rng.integers(-1, m + 1, n), device=cuda_device)
    vals = torch.as_tensor(rng.normal(size=n) * 100, device=cuda_device).to(dtype)
    outs = [segment_sum_cuda(vals, ids, m) for _ in range(5)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    # even segments near 1e15, odd ones near 1e-15
    ids = torch.as_tensor(rng.integers(0, m, n), device=cuda_device)
    mag = torch.where(ids % 2 == 0, 1e15, 1e-15).to(torch.float64)
    vals = (torch.as_tensor(rng.normal(size=n), device=cuda_device) * mag).to(dtype)
    outs = [segment_sum_cuda(vals, ids, m) for _ in range(5)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    want = segment_sum_plain(vals.double(), ids, m)
    scale = segment_sum_plain(vals.double().abs(), ids, m)
    rtol = 1e-12 if dtype == torch.float64 else 1e-4
    err = (outs[0].double() - want).abs() / scale.clamp(min=1e-300)
    assert float(err.max()) <= rtol


@pytest.mark.parametrize("pat", ["", "a", "special", "x" * 130])
def test_substr_find_kernel_matches_plain(cuda_device, pat):
    rng = np.random.default_rng(9)
    alphabet = np.frombuffer(b"abspecialx yz", dtype=np.uint8)
    packed = torch.as_tensor(alphabet[rng.integers(0, alphabet.size, (2000, 128))], device=cuda_device)
    lens = torch.as_tensor(rng.integers(0, 129, 2000).astype(np.int32), device=cuda_device)
    start = torch.as_tensor(rng.integers(-1, 100, 2000).astype(np.int32), device=cuda_device)
    p = torch.tensor(list(pat.encode()), dtype=torch.uint8, device=cuda_device)
    for st in (None, start):
        assert torch.equal(substr_find_cuda(packed, lens, p, st), substr_find_plain(packed, lens, p, st))


def _offset_rows(rng, n, L, offset, device):
    """(n, L) uint8 rows whose first byte lies ``offset`` bytes past a
    16-byte boundary (a view into a fresh allocation), from an alphabet
    with NUL and bytes >= 0x80, lengths -1, 0, L, L + 3 and 0..L; some rows
    end in "aab", some start with "aaab" then "special"."""
    alphabet = np.frombuffer(b"aab\x00\x80\xffspecial", np.uint8)
    flat = alphabet[rng.integers(0, alphabet.size, offset + n * L)]
    rows = flat[offset:].reshape(n, L)
    lens = rng.integers(0, L + 1, n).astype(np.int32)
    lens[:4] = (-1, 0, L, L + 3)
    for r in range(4, n, 3):
        e = int(min(lens[r], L))
        if e >= 11:
            rows[r, :4] = np.frombuffer(b"aaab", np.uint8)
            rows[r, e - 7:e] = np.frombuffer(b"special", np.uint8)
        elif e >= 3:
            rows[r, e - 3:e] = np.frombuffer(b"aab", np.uint8)
    buf = torch.as_tensor(flat, device=device)
    return buf[offset:].view(n, L), torch.as_tensor(lens, device=device)


@pytest.mark.parametrize("L", [1, 15, 16, 17, 37, 100, 128])
@pytest.mark.parametrize("offset", [0, 1, 7, 15])
def test_substr_kernels_match_plain_at_edge_shapes(cuda_device, L, offset):
    """The find (without and with starts from -3 to L + 3) and the fused
    exists_before, exactly, at base pointers off 16-byte alignment and
    pattern lengths 0 to L + 1."""
    rng = np.random.default_rng(L * 16 + offset)
    packed, lens = _offset_rows(rng, 3001, L, offset, cuda_device)
    start = torch.as_tensor(rng.integers(-3, L + 4, 3001).astype(np.int32), device=cuda_device)

    def pat(raw):
        return torch.tensor(list(raw), dtype=torch.uint8, device=cuda_device)

    pats = [pat(b"")] + [pat(b"aab"[:m] if m <= 3 else rng.choice(
        np.frombuffer(b"aab\x00\x80\xffspecial", np.uint8), m).tobytes())
        for m in (1, 2, 3, 7, 8, 15, 16, 17, 33, L, L + 1)]
    pats += [pat(b"special"[: min(7, L)]), pat(b"x" * (L + 1))]
    for p in pats:
        for st in (None, start):
            assert torch.equal(substr_find_cuda(packed, lens, p, st),
                               substr_find_plain(packed, lens, p, st))
    for a in pats:
        for b in (pats[0], pats[1], pat(b"special"[: min(7, L)]), a):
            assert torch.equal(exists_before_cuda(packed, lens, a, b),
                               exists_before_plain(packed, lens, a, b))


def test_exists_before_is_one_launch_of_the_fused_form(cuda_device):
    rng = np.random.default_rng(2)
    packed, lens = _offset_rows(rng, 50_001, 128, 0, cuda_device)
    a = torch.tensor(list(b"aab"), dtype=torch.uint8, device=cuda_device)
    b = torch.tensor(list(b"special"), dtype=torch.uint8, device=cuda_device)
    ops.reset_launches()
    got = ops.exists_before(packed, lens, a, b)
    assert ops.LAUNCHES["substr_find"] == 1
    assert MODE_LAUNCHES == {"find": 0, "exists_before": 1}
    assert got.dtype == torch.bool and torch.equal(got, exists_before_plain(packed, lens, a, b))
    ops.substr_find(packed, lens, a)
    assert ops.LAUNCHES["substr_find"] == 2 and MODE_LAUNCHES == {"find": 1, "exists_before": 1}


def test_substr_wrappers_refuse_what_the_kernel_does_not_take(cuda_device):
    packed = torch.zeros((4, 32), dtype=torch.uint8, device=cuda_device)
    lens = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    a = torch.zeros(2, dtype=torch.uint8, device=cuda_device)
    for find in (lambda p, l, x: substr_find_cuda(p, l, x),
                 lambda p, l, x: exists_before_cuda(p, l, x, x)):
        with pytest.raises(ValueError, match="not contiguous"):
            find(packed[:, ::2], lens, a)
        with pytest.raises(ValueError, match="not contiguous"):
            find(packed, lens, torch.zeros(4, dtype=torch.uint8, device=cuda_device)[::2])
        with pytest.raises(ValueError):
            find(packed, lens.cpu(), a)
        with pytest.raises(ValueError):
            find(packed, lens, a.cpu())
        with pytest.raises(TypeError):
            find(packed, lens.long(), a)
        with pytest.raises(TypeError):
            find(packed.int(), lens, a)
    with pytest.raises(ValueError, match="not contiguous"):
        substr_find_cuda(packed, lens, a, torch.zeros(8, dtype=torch.int32, device=cuda_device)[::2])


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    v = torch.zeros(4, dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        segment_sum_cuda(v, torch.zeros(4, dtype=torch.int32, device=cuda_device), 2)
    with pytest.raises(ValueError):
        segment_sum_cuda(torch.zeros((4, 2), dtype=torch.float64, device=cuda_device)[:, 0],
                         torch.zeros(4, dtype=torch.int64, device=cuda_device), 2)
    with pytest.raises(ValueError):
        segment_sum_cuda(v, torch.zeros(4, dtype=torch.int64), 2)


@pytest.mark.parametrize("qname", ["q1", "q13", "q16", "q18"])
def test_query_on_the_card_matches_the_cpu_path(cuda_device, qname):
    tables = tpch.generate(sf=0.01, seed=1)
    ops.reset_launches()
    got = tpch_frames.ALL[qname](tpch.as_frames(tables, device=cuda_device), sf=0.01)
    assert ops.LAUNCHES["segment_sum"] > 0
    want = tpch_frames.ALL[qname](tpch.as_frames(tables, device="cpu"), sf=0.01)
    got, want = got.to_dict(), want.to_dict()
    assert list(got) == list(want)
    for c in want:
        if want[c].dtype.kind == "f":
            np.testing.assert_allclose(got[c], want[c], rtol=1e-8, atol=0)
        else:
            np.testing.assert_array_equal(got[c], want[c])


@pytest.fixture
def op_by_op():
    """SQL op by op (the compiled route would take these texts at SF 0.01,
    and its replays launch the kernels without their wrappers' counts)."""
    CONFIG.compiled = "off"
    yield
    CONFIG.compiled = "auto"


@pytest.mark.parametrize("qname", ["q1", "q6", "q13", "q15"])
def test_sql_on_the_card_matches_the_cpu(cuda_device, op_by_op, qname):
    """The SQL front end on the card: each aggregate launches K1, q13's
    NOT LIKE over the o_comment dictionary K2's find; the result is the
    CPU's (ints, codes and row sets exact, floats rtol 1e-8), run after
    run (q15 compares two spellings of one float SUM for equality)."""
    tables = tpch.generate(sf=0.01, seed=1)
    text = tpch_sql.sql_text(qname, 0.01)
    frames = tpch.as_frames(tables, device=cuda_device)
    want = sql.execute(text, tpch.as_frames(tables, device="cpu"))
    for _ in range(4):
        ops.reset_launches()
        got = sql.execute(text, frames)
        assert got.device.type == "cuda"
        assert ops.LAUNCHES["segment_sum"] > 0
        if qname == "q13":
            assert MODE_LAUNCHES["find"] > 0
        assert got.column_names == want.column_names
        orc.assert_odf_equal(orc.frame_to_odf(got), orc.frame_to_odf(want), sort=True,
                             rtol=1e-8)


@pytest.fixture
def compiled():
    from repro_torch.sql import compile as plan_compile

    plan_compile.clear_cache()
    plan_compile.reset_stats()
    CONFIG.compiled = "force"
    yield plan_compile
    CONFIG.compiled = "auto"
    plan_compile.clear_cache()


@pytest.mark.parametrize("qname", ["q1", "q9", "q13", "q15", "q18"])
def test_compiled_sql_replays_its_graph(cuda_device, compiled, qname):
    """A compiled text on the card is one captured CUDA graph: the first
    run traces and captures it (K1, and K2 in q13, inside: at SF 0.01
    only q13's dictionary reaches K2's 2048 strings), the
    next runs replay it (no wrapper launches) with the result of op by
    op on the card and of the compiled CPU path; q15 returns its row
    every time."""
    tables = tpch.generate(sf=0.01, seed=1)
    text = tpch_sql.sql_text(qname, 0.01)
    frames = tpch.as_frames(tables, device=cuda_device)
    want = sql.execute(text, tpch.as_frames(tables, device="cpu"))
    CONFIG.compiled = "off"
    dispatch = sql.execute(text, frames)
    CONFIG.compiled = "force"
    compiled.reset_stats()
    ops.reset_launches()
    first = sql.execute(text, frames)
    assert compiled.STATS["compiles"] == 1 and compiled.STATS["fallbacks"] == 0
    # the CPU run above compiled an entry of its own, without a graph
    (entry,) = [e for e in compiled._CACHE.values() if e.graph is not None]
    assert isinstance(entry.graph, torch.cuda.CUDAGraph)
    assert ops.LAUNCHES["segment_sum"] > 0
    if qname == "q13":
        assert ops.LAUNCHES["substr_find"] > 0
    for got in [first] + [None] * 3:
        if got is None:
            before = dict(ops.LAUNCHES)
            got = sql.execute(text, frames)
            assert dict(ops.LAUNCHES) == before  # a replay, not the wrappers
        assert got.device.type == "cuda"
        assert got.column_names == want.column_names
        if qname == "q15":
            assert got.nrows == 1
        for other in (want, dispatch):
            orc.assert_odf_equal(orc.frame_to_odf(got), orc.frame_to_odf(other), sort=True,
                                 rtol=1e-8)
    assert compiled.STATS["hits"] == 3 and compiled.STATS["compiles"] == 1


def test_compiled_literal_change_replays_without_capture(cuda_device, compiled):
    """The same plan with another literal is a hit: no new capture, the
    literal reaches the graph through its parameter buffer."""
    tables = tpch.generate(sf=0.01, seed=1)
    frames = tpch.as_frames(tables, device=cuda_device)
    cpu = tpch.as_frames(tables, device="cpu")
    text = tpch_sql.sql_text("q6", 0.01)
    for qty in (24, 10, 40):
        t = text.replace("l_quantity < 24", f"l_quantity < {qty}")
        got = sql.execute(t, frames)
        CONFIG.compiled = "off"
        want = sql.execute(t, cpu)
        CONFIG.compiled = "force"
        assert orc.frame_to_odf(got)["revenue"][0] == pytest.approx(
            orc.frame_to_odf(want)["revenue"][0], rel=1e-8)
    assert compiled.STATS["compiles"] == 1 and compiled.STATS["hits"] == 2


# tolerances of tests/test_kernels.py: (wkv6, attention) per dtype
KERNEL_TOL = {torch.float32: (1e-4, 2e-5), torch.bfloat16: (4e-2, 2e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,T,D", [(1, 2, 1, 16), (2, 3, 7, 32), (4, 64, 1, 64), (1, 2, 64, 128)])
def test_wkv6_kernel_matches_plain_and_chains_state(cuda_device, dtype, B, H, T, D):
    rng = np.random.default_rng(B * T + D)
    mk = lambda: torch.as_tensor(rng.normal(size=(B, H, T, D)) * 0.5, device=cuda_device).to(dtype)
    r, k, v = mk(), mk(), mk()
    w = torch.as_tensor(rng.uniform(0.7, 0.999, (B, H, T, D)), device=cuda_device).to(dtype)
    u = torch.as_tensor(rng.normal(size=(H, D)) * 0.1, device=cuda_device).to(dtype)
    s0 = torch.as_tensor(rng.normal(size=(B, H, D, D)), device=cuda_device).float()
    tol = KERNEL_TOL[dtype][0]
    for state in (None, s0):
        y, s = wkv6_cuda(r, k, v, w, u, state)
        y_want, s_want = wkv6_plain(r, k, v, w, u, state)
        torch.testing.assert_close(y.float(), y_want.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(s, s_want, rtol=tol, atol=tol)
    if T > 1:
        h = T // 2
        y1, s1 = wkv6_cuda(r[:, :, :h].contiguous(), k[:, :, :h].contiguous(),
                           v[:, :, :h].contiguous(), w[:, :, :h].contiguous(), u)
        y2, s2 = wkv6_cuda(r[:, :, h:].contiguous(), k[:, :, h:].contiguous(),
                           v[:, :, h:].contiguous(), w[:, :, h:].contiguous(), u, s1)
        y, s = wkv6_cuda(r, k, v, w, u)
        torch.testing.assert_close(torch.cat([y1, y2], 2).float(), y.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(s2, s, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 7, 64])
def test_wkv6_kernel_strided_with_state_written_in_place(cuda_device, dtype, T):
    """K5 as the decode step calls it: (B, H, T, D) views of (B, T, H, D)
    tensors, bf16 or f32 u, the final state written over the initial one
    (and into a separate buffer), against the plain version."""
    B, H, D = 4, 8, 64
    rng = np.random.default_rng(T)
    heads = lambda a: torch.as_tensor(a, device=cuda_device).to(dtype).transpose(1, 2)
    r, k, v = (heads(rng.normal(size=(B, T, H, D)) * 0.5) for _ in range(3))
    w = heads(rng.uniform(0.7, 0.999, (B, T, H, D)))
    u = torch.as_tensor(rng.normal(size=(H, D)) * 0.1, device=cuda_device).to(dtype)
    s0 = torch.as_tensor(rng.normal(size=(B, H, D, D)), device=cuda_device).float()
    tol = KERNEL_TOL[dtype][0]
    y_want, s_want = wkv6_plain(r, k, v, w, u, s0)
    state = s0.clone()
    y, s = wkv6_cuda(r, k, v, w, u, state, state_out=state)
    assert s is state and y.shape == (B, H, T, D) and y.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(y.float(), y_want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(s, s_want, rtol=tol, atol=tol)
    other = torch.full_like(s0, float("nan"))
    y, s = wkv6_cuda(r, k, v, w, u, s0, state_out=other)
    assert s is other
    torch.testing.assert_close(s, s_want, rtol=tol, atol=tol)
    kept = s0.clone()
    wkv6_cuda(r, k, v, w, u, s0)
    assert torch.equal(s0, kept)  # without state_out the state is left as it was
    buf = torch.zeros(s0.numel() + 1, device=cuda_device)
    with pytest.raises(ValueError, match="overlaps"):  # one float apart
        wkv6_cuda(r, k, v, w, u, buf[:-1].view_as(s0), state_out=buf[1:].view_as(s0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,T,D", [(1, 2, 1, 16), (2, 3, 63, 32), (1, 2, 65, 64),
                                     (2, 2, 200, 128), (1, 3, 129, 16), (1, 4, 300, 64)])
def test_wkv6_chunked_kernel_matches_plain_with_tiny_decays(cuda_device, dtype, B, H, T, D):
    """K5's chunked forward (``csrc/wkv6_chunked.cu``, forced at any T:
    one step, ragged across chunk and sub-chunk boundaries), strided as
    the model hands it over, w log-uniform down to 1e-12, with and without
    a state, ``state_out`` aliased to the state and apart; against the
    plain version within the kernel tolerance, and bit for bit again on a
    second launch."""
    rng = np.random.default_rng(T * D + B)
    heads = lambda a: torch.as_tensor(a, device=cuda_device).to(dtype).transpose(1, 2)
    r, k, v = (heads(rng.normal(size=(B, T, H, D)) * 0.5) for _ in range(3))
    w = heads(np.exp(rng.uniform(np.log(1e-12), np.log(0.999), (B, T, H, D))))
    u = torch.as_tensor(rng.normal(size=(H, D)) * 0.1, device=cuda_device).to(dtype)
    s0 = torch.as_tensor(rng.normal(size=(B, H, D, D)), device=cuda_device).float()
    tol = KERNEL_TOL[dtype][0]
    chunked = lambda *a, **kw: _wkv6_launch("wkv6_chunked", *a, **kw)
    for state in (None, s0):
        ops.reset_launches()
        y, s = chunked(r, k, v, w, u, state)
        y2, s2 = chunked(r, k, v, w, u, state)
        assert ops.LAUNCHES["wkv6_chunked"] == 2 and ops.LAUNCHES["wkv6"] == 0
        y_want, s_want = wkv6_plain(r, k, v, w, u, state)
        torch.testing.assert_close(y.float(), y_want.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(s, s_want, rtol=tol, atol=tol)
        assert torch.equal(y, y2) and torch.equal(s, s2)
    kept = s0.clone()
    alias = s0.clone()
    y, s = chunked(r, k, v, w, u, alias, state_out=alias)
    assert s is alias and torch.equal(s0, kept)
    torch.testing.assert_close(y.float(), y_want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(s, s_want, rtol=tol, atol=tol)
    other = torch.full_like(s0, float("nan"))
    _, s = chunked(r, k, v, w, u, s0, state_out=other)
    assert s is other and torch.equal(s0, kept)
    torch.testing.assert_close(s, s_want, rtol=tol, atol=tol)
    # the state and state_out 4 bytes off 16-byte alignment: the scan's
    # one-element path
    buf = torch.full((2 * s0.numel() + 1,), float("nan"), device=cuda_device)
    s_in = buf[1:1 + s0.numel()].view_as(s0).copy_(s0)
    s_out = buf[1 + s0.numel():].view_as(s0)
    assert s_in.data_ptr() % 16 and s_out.data_ptr() % 16
    _, s = chunked(r, k, v, w, u, s_in, state_out=s_out)
    assert s is s_out and torch.equal(s_in, s0)
    torch.testing.assert_close(s, s_want, rtol=tol, atol=tol)


def test_wkv6_picks_its_form_by_the_steps(cuda_device):
    """The wrapper launches the serial kernel below
    CHUNKED_MIN_T steps and the chunked one from it on, and the two agree
    on the same inputs; a chunked call chained through the state over 2
    chunks and a remainder equals one call."""
    from repro_torch.kernels.wkv6 import CHUNK, CHUNKED_MIN_T

    rng = np.random.default_rng(3)
    B, H, D = 2, 4, 64
    T = CHUNKED_MIN_T + 2 * CHUNK + 5
    mk = lambda: torch.as_tensor(rng.normal(size=(B, H, T, D)) * 0.5, device=cuda_device).float()
    r, k, v = mk(), mk(), mk()
    w = torch.as_tensor(rng.uniform(0.7, 0.999, (B, H, T, D)), device=cuda_device).float()
    u = torch.as_tensor(rng.normal(size=(H, D)) * 0.1, device=cuda_device).float()
    ops.reset_launches()
    wkv6_cuda(r[:, :, :1], k[:, :, :1], v[:, :, :1], w[:, :, :1], u)
    wkv6_cuda(r[:, :, :CHUNKED_MIN_T - 1], k[:, :, :CHUNKED_MIN_T - 1],
              v[:, :, :CHUNKED_MIN_T - 1], w[:, :, :CHUNKED_MIN_T - 1], u)
    assert ops.LAUNCHES["wkv6"] == 2 and ops.LAUNCHES["wkv6_chunked"] == 0
    y, s = wkv6_cuda(r, k, v, w, u)
    assert ops.LAUNCHES["wkv6_chunked"] == 1
    y_serial, s_serial = _wkv6_launch("wkv6", r, k, v, w, u)
    tol = KERNEL_TOL[torch.float32][0]
    torch.testing.assert_close(y, y_serial, rtol=tol, atol=tol)
    torch.testing.assert_close(s, s_serial, rtol=tol, atol=tol)
    part = lambda t, a, b: t[:, :, a:b]
    cut = [0, CHUNK, 2 * CHUNK, T]
    state, ys = None, []
    for a, b in zip(cut, cut[1:]):
        y_p, state = _wkv6_launch("wkv6_chunked", *(part(t, a, b) for t in (r, k, v, w)),
                                  u, state)
        ys.append(y_p)
    torch.testing.assert_close(torch.cat(ys, 2), y, rtol=tol, atol=tol)
    torch.testing.assert_close(state, s, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D", [
    (1, 4, 2, 128, 128, 32), (2, 2, 2, 100, 100, 16), (1, 5, 1, 37, 200, 64),
    (1, 4, 2, 1, 77, 96), (1, 10, 2, 130, 130, 128),
    # the tensor-core kernel's 128-row tiles: ragged Sq and Sk around 128,
    # D not a multiple of 64, groups 1, 2 and 5, Sq < Sk
    (1, 2, 2, 127, 127, 80), (1, 4, 2, 129, 129, 112), (2, 5, 1, 200, 200, 48),
    (1, 2, 1, 37, 300, 128), (1, 10, 2, 257, 257, 64),
])
def test_flash_attention_kernel_matches_plain(cuda_device, dtype, causal, B, Hq, Hkv, Sq, Sk, D):
    rng = np.random.default_rng(Sq + Sk + D)
    q = torch.as_tensor(rng.normal(size=(B, Sq, Hq, D)), device=cuda_device).to(dtype)
    k = torch.as_tensor(rng.normal(size=(B, Hkv, Sk, D)), device=cuda_device).to(dtype)
    v = torch.as_tensor(rng.normal(size=(B, Hkv, Sk, D)), device=cuda_device).to(dtype)
    q = q.transpose(1, 2)  # strided, as the model hands it over
    ops.reset_launches()
    got = flash_attention_cuda(q, k, v, causal)
    # both on the tensor cores: bf16, and f32 in split TF32
    bf16 = dtype == torch.bfloat16
    assert (ops.LAUNCHES["flash_attention_sm90"], ops.LAUNCHES["flash_attention_f32_sm90"]) == (
        (1, 0) if bf16 else (0, 1))
    assert sum(ops.LAUNCHES.values()) == 1
    want = flash_attention_plain(q, k, v, causal)
    tol = KERNEL_TOL[dtype][1]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D", [
    # cross-attention: more queries than keys, no causal mask
    (1, 8, 1, 300, 130, 128), (1, 4, 4, 129, 37, 112), (2, 8, 2, 200, 64, 80),
])
def test_flash_attention_kernel_non_causal_queries_past_the_keys(cuda_device, dtype, B, Hq, Hkv,
                                                                 Sq, Sk, D):
    rng = np.random.default_rng(Sq * Sk + D)
    q = torch.as_tensor(rng.normal(size=(B, Sq, Hq, D)), device=cuda_device).to(dtype)
    k = torch.as_tensor(rng.normal(size=(B, Hkv, Sk, D)), device=cuda_device).to(dtype)
    v = torch.as_tensor(rng.normal(size=(B, Hkv, Sk, D)), device=cuda_device).to(dtype)
    q = q.transpose(1, 2)
    got = flash_attention_cuda(q, k, v, False)
    want = flash_attention_plain(q, k, v, False)
    tol = KERNEL_TOL[dtype][1]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="leaves queries with no key"):
        flash_attention_cuda(q, k, v, True)


def test_flash_attention_sm90_takes_layouts_the_copy_engine_cannot_describe(cuda_device):
    # q one element into its buffer (base not 16-byte aligned) and k with
    # a sequence stride of D + 1 elements: the wrapper copies those first
    rng = np.random.default_rng(5)
    B, Hq, Hkv, S, D = 1, 4, 2, 150, 64
    qbuf = torch.as_tensor(rng.normal(size=(B * Hq * S * D + 1,)), device=cuda_device)
    q = qbuf.to(torch.bfloat16)[1:].view(B, Hq, S, D)
    k = torch.as_tensor(rng.normal(size=(B, Hkv, S, D + 1)), device=cuda_device)
    k = k.to(torch.bfloat16)[..., :D]
    v = torch.as_tensor(rng.normal(size=(B, Hkv, S, D)), device=cuda_device).to(torch.bfloat16)
    assert q.data_ptr() % 16 != 0 and k.stride(2) % 8 != 0
    for causal in (True, False):
        got = flash_attention_cuda(q, k, v, causal)
        want = flash_attention_plain(q, k, v, causal)
        tol = KERNEL_TOL[torch.bfloat16][1]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("n,k", [(1, 1), (7, 2), (1024, 5), (3000, 5), (5, 0), (1_000_003, 2), (999, 40)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.uint32])
def test_hash32x2_kernel_matches_plain(cuda_device, n, k, dtype):
    rng = np.random.default_rng(n + k)
    bits = rng.integers(0, 2**32, size=(n, k), dtype=np.uint64).astype(np.uint32)  # high bit set in half
    cols = torch.as_tensor(bits.view(np.int32), device=cuda_device).view(dtype)
    ops.reset_launches()
    got = hash32x2_cuda(cols)
    assert ops.LAUNCHES["hash32x2"] == 1 and got.dtype == torch.uint32 and got.shape == (n, 2)
    want = hash32x2_plain(cols)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))  # bit for bit
    assert hash32x2_cuda(cols[:0]).shape == (0, 2)


def test_lm_path_on_the_card_matches_the_cpu(cuda_device):
    """Reduced float32 qwen3-14b (GQA 2) and rwkv6-7b with the same weights
    on both devices: prefill logits within 1e-4, served tokens equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch, over in (("qwen3-14b", {"n_kv_heads": 2}), ("rwkv6-7b", {})):
        cfg = reduced(get(arch), **over)
        cpu = lm.init_params(cfg, torch.Generator("cpu").manual_seed(1), device="cpu")
        card = copy.deepcopy(cpu).to(cuda_device)  # Module.to moves in place
        toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab, (2, 96)))
        ops.reset_launches()
        got = lm.prefill(cfg, card, {"tokens": toks.to(cuda_device)})
        name = wkv6_form(toks.shape[1]) if cfg.family == "rwkv6" else "flash_attention_f32_sm90"
        assert ops.LAUNCHES[name] == cfg.n_layers
        want = lm.prefill(cfg, cpu, {"tokens": toks})
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        prompts = [np.random.default_rng(i).integers(0, cfg.vocab, 3 + i).astype(np.int32)
                   for i in range(5)]
        outs = []
        for params in (card, cpu):
            reqs = [Request(rid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)]
            ServeEngine(cfg, params, batch_slots=2, max_len=32).run(reqs)
            outs.append([r.out for r in reqs])
        assert outs[0] == outs[1]


@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b", "zamba2-2.7b",
                                  "llama-3.2-vision-90b", "musicgen-medium"])
def test_later_families_prefill_on_the_card_matches_the_cpu(cuda_device, arch):
    """Reduced float32 MoE, Mamba2-hybrid, cross-attention (gates opened
    to 0.5) and embedding-input models with the same weights on both
    devices: prefill logits within 1e-4, one f32 attention launch per
    attention layer and nothing else."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get(arch))
    cpu = lm.init_params(cfg, torch.Generator("cpu").manual_seed(1), device="cpu")
    for block in (cpu["cross_blocks"] if "cross_blocks" in cpu else []):
        block["attn"]["gate"].fill_(0.5)
    card = copy.deepcopy(cpu).to(cuda_device)
    rng = np.random.default_rng(2)
    batch = {}
    if cfg.embed_inputs:
        batch["tokens"] = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 96)))
    else:
        batch["embeddings"] = torch.as_tensor(rng.normal(size=(2, 96, cfg.d_model)),
                                              dtype=torch.float32)
    if cfg.cross_attn_every:
        batch["img_embed"] = torch.as_tensor(rng.normal(size=(2, cfg.n_img_tokens, cfg.d_model)),
                                             dtype=torch.float32)
    ops.reset_launches()
    got = lm.prefill(cfg, card, {name: t.to(cuda_device) for name, t in batch.items()})
    layers = cfg.n_layers // cfg.attn_every if cfg.attn_every else cfg.n_layers
    assert ops.LAUNCHES["flash_attention_f32_sm90"] == layers == sum(ops.LAUNCHES.values())
    want = lm.prefill(cfg, cpu, batch)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------------------
# the backward kernels (training)
# ----------------------------------------------------------------------
#: relative to the largest |plain gradient| of the call (float32: sums in
#: another order; bf16: the gradients' own rounding)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _rel_errs(got, want):
    scale = max(float(w.double().abs().max()) for w in want) or 1.0
    return [float((g.double() - w.double()).abs().max()) / scale for g, w in zip(got, want)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,B,Hq,Hkv,Sq,Sk,D", [
    (True, 1, 5, 1, 100, 100, 16), (True, 2, 8, 1, 37, 200, 64), (True, 1, 10, 2, 130, 130, 128),
    (False, 1, 16, 2, 300, 130, 128), (False, 1, 4, 4, 65, 190, 80), (True, 1, 2, 2, 1, 1, 32),
])
def test_flash_attention_bwd_kernel_matches_plain(cuda_device, dtype, causal, B, Hq, Hkv, Sq, Sk,
                                                  D):
    from repro_torch.kernels.flash_attention import (
        BWD_KERNELS, attention_lse_plain, flash_attention_bwd_cuda, flash_attention_bwd_plain,
        flash_attention_fwd_cuda,
    )

    rng = np.random.default_rng(Sq + Sk + D)
    q = torch.as_tensor(rng.normal(size=(B, Sq, Hq, D)), device=cuda_device).to(dtype)
    q = q.transpose(1, 2)  # strided, as the model hands it over
    k, v = (torch.as_tensor(rng.normal(size=(B, Hkv, Sk, D)), device=cuda_device).to(dtype)
            for _ in range(2))
    o, lse = flash_attention_fwd_cuda(q, k, v, causal)
    torch.testing.assert_close(lse, attention_lse_plain(q, k, causal), rtol=1e-4, atol=1e-4)
    do = torch.as_tensor(rng.normal(size=o.shape), device=cuda_device).to(dtype)
    ops.reset_launches()
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    # both on the tensor cores: bf16, and float32 in split TF32
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == {BWD_KERNELS[dtype]: 1}
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    assert max(_rel_errs(got, want)) <= BWD_TOL[dtype]
    again = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: repeats exactly


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 7, 64])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_bwd_kernel_matches_plain(cuda_device, dtype, T, with_state):
    from repro_torch.kernels.wkv6 import wkv6_bwd_cuda, wkv6_bwd_plain

    rng = np.random.default_rng(T)
    B, H, D = 2, 3, 64
    shape = (B, T, H, D)  # strided (B, H, T, D) views, as the model hands them over
    r, k, v = (torch.as_tensor(rng.normal(size=shape) * 0.5, device=cuda_device)
               .to(dtype).transpose(1, 2) for _ in range(3))
    w = torch.as_tensor(rng.uniform(0.7, 0.999, shape), device=cuda_device).to(dtype)
    w = w.transpose(1, 2)
    u = torch.as_tensor(rng.normal(size=(H, D)) * 0.1, device=cuda_device).to(dtype)
    s0 = (torch.as_tensor(rng.normal(size=(B, H, D, D)), device=cuda_device).float()
          if with_state else None)
    dy = torch.as_tensor(rng.normal(size=r.shape), device=cuda_device).to(dtype)
    ds = torch.as_tensor(rng.normal(size=(B, H, D, D)), device=cuda_device).float()
    dstate = ds if with_state else None
    got = wkv6_bwd_cuda(r, k, v, w, u, s0, dy, dstate)
    want = wkv6_bwd_plain(r, k, v, w, u, s0, dy, dstate)
    for g, wnt in zip(got, want):
        assert max(_rel_errs([g], [wnt])) <= BWD_TOL[dtype]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal", [
    (1, 8, 8, 129, 129, 112, True), (2, 5, 1, 200, 200, 48, True),
    (1, 40, 8, 257, 513, 128, True), (1, 8, 1, 200, 77, 112, False),
])
def test_flash_attention_bwd_sm90_on_several_tiles_and_heads(cuda_device, B, Hq, Hkv, Sq, Sk,
                                                           D, causal):
    """The tensor-core backward over several 64- and 128-row tiles, the
    causal offset across them, groups 1, 5 and 8, and the copy engine's
    zero fill (D 48, 112), against the plain backward; bit for bit again."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain, flash_attention_fwd_cuda,
    )

    rng = np.random.default_rng(Sq * D + Hq)
    q = torch.as_tensor(rng.normal(size=(B, Sq, Hq, D)), device=cuda_device).bfloat16()
    q = q.transpose(1, 2)
    k, v = (torch.as_tensor(rng.normal(size=(B, Hkv, Sk, D)), device=cuda_device).bfloat16()
            for _ in range(2))
    o, lse = flash_attention_fwd_cuda(q, k, v, causal)
    do = torch.as_tensor(rng.normal(size=o.shape), device=cuda_device).bfloat16()
    ops.reset_launches()
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    again = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == {"flash_attention_bwd_sm90": 2}
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    assert max(_rel_errs(got, want)) <= BWD_TOL[torch.bfloat16]
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("D", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,causal", [
    (1, 5, 1, 77, 200, True), (2, 4, 2, 130, 65, False),
])
def test_flash_attention_f32_sm90_forward_and_backward_at_every_head_dim(cuda_device, D, B, Hq,
                                                                         Hkv, Sq, Sk, causal):
    """The float32 kernels (split TF32 on the tensor cores) at every head
    dim they take, over ragged 16-, 32- and 64-row tiles, the causal offset
    (Sq < Sk) and cross-attention (Sq > Sk): o within the float32
    tolerance, lse within 1e-4, the gradients within 1e-4 of the largest
    plain gradient, bit for bit again; their launches and nothing else."""
    from repro_torch.kernels.flash_attention import (
        attention_lse_plain, flash_attention_bwd_cuda, flash_attention_bwd_plain,
        flash_attention_fwd_cuda,
    )

    rng = np.random.default_rng(D * Sq + Sk)
    q = torch.as_tensor(rng.normal(size=(B, Sq, Hq, D)), device=cuda_device).float()
    q = q.transpose(1, 2)
    k, v = (torch.as_tensor(rng.normal(size=(B, Hkv, Sk, D)), device=cuda_device).float()
            for _ in range(2))
    ops.reset_launches()
    o, lse = flash_attention_fwd_cuda(q, k, v, causal)
    do = torch.as_tensor(rng.normal(size=o.shape), device=cuda_device).float()
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    again = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == {
        "flash_attention_f32_sm90": 1, "flash_attention_bwd_f32_sm90": 2}
    tol = KERNEL_TOL[torch.float32][1]
    torch.testing.assert_close(o, flash_attention_plain(q, k, v, causal), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, attention_lse_plain(q, k, causal), rtol=1e-4, atol=1e-4)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    assert max(_rel_errs(got, want)) <= BWD_TOL[torch.float32]
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D", [(1, 10, 2, 4096, 4096, 128),
                                              (1, 5, 1, 192, 32768, 128)])
def test_flash_attention_bwd_f32_sm90_over_a_long_group(cuda_device, causal, B, Hq, Hkv, Sq, Sk,
                                                        D):
    """Sums over long runs, where the tensor cores' float32 accumulation
    alone drifts past the tolerance: dK and dV over many query rows (a
    group of 5 heads over 4096 queries: 20480 rows, as Qwen3-14B trains),
    and O and dQ over 32768 keys (12288 products a row); o within the
    float32 tolerance, lse within 1e-4, the gradients within 1e-4 of the
    largest plain gradient, bit for bit again."""
    from repro_torch.kernels.flash_attention import (
        attention_lse_plain, flash_attention_bwd_cuda, flash_attention_bwd_plain,
        flash_attention_fwd_cuda,
    )

    rng = np.random.default_rng(Sk + causal)
    q = torch.as_tensor(rng.normal(size=(B, Sq, Hq, D)), device=cuda_device).float().transpose(1, 2)
    k, v = (torch.as_tensor(rng.normal(size=(B, Hkv, Sk, D)), device=cuda_device).float()
            for _ in range(2))
    o, lse = flash_attention_fwd_cuda(q, k, v, causal)
    tol = KERNEL_TOL[torch.float32][1]
    torch.testing.assert_close(o, flash_attention_plain(q, k, v, causal), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, attention_lse_plain(q, k, causal), rtol=1e-4, atol=1e-4)
    do = torch.as_tensor(rng.normal(size=o.shape), device=cuda_device).float()
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    again = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    assert max(_rel_errs(got, want)) <= BWD_TOL[torch.float32]
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,D,with_state", [(17, 64, True), (300, 64, False), (129, 128, True),
                                            (257, 16, False), (33, 32, True)])
def test_wkv6_bwd_chunk_parallel_with_tiny_decays(cuda_device, dtype, T, D, with_state):
    """The chunk-parallel backward with w drawn down to 1e-12 (where a
    decay taken as a quotient would overflow), T not a multiple of the
    chunk and past several stages of the boundary kernel, strided inputs;
    against the reverse recurrence, and bit for bit again."""
    from repro_torch.kernels.wkv6 import wkv6_bwd_cuda, wkv6_bwd_plain

    rng = np.random.default_rng(T + D)
    B, H = 1, 3
    shape = (B, T, H, D)
    r, k, v, dy = (torch.as_tensor(rng.normal(size=shape) * 0.5, device=cuda_device)
                   .to(dtype).transpose(1, 2) for _ in range(4))
    w = np.exp(rng.uniform(np.log(1e-12), np.log(0.999), size=shape))
    w = torch.as_tensor(w, device=cuda_device).to(dtype).transpose(1, 2)
    u = torch.as_tensor(rng.normal(size=(H, D)) * 0.1, device=cuda_device).to(dtype)
    s0, dstate = ((torch.as_tensor(rng.normal(size=(B, H, D, D)), device=cuda_device).float()
                   for _ in range(2)) if with_state else (None, None))
    got = wkv6_bwd_cuda(r, k, v, w, u, s0, dy, dstate)
    again = wkv6_bwd_cuda(r, k, v, w, u, s0, dy, dstate)
    want = wkv6_bwd_plain(r, k, v, w, u, s0, dy, dstate)
    for g, wnt in zip(got, want):
        assert max(_rel_errs([g], [wnt])) <= BWD_TOL[dtype]
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_kernel_wrappers_refuse_inputs_that_want_a_gradient(cuda_device):
    """The bare kernels write their outputs through raw pointers: on CUDA
    inputs that require a gradient they raise (the output would carry
    none, and training would go wrong without an error); ``ops`` takes
    such inputs through the autograd Functions."""
    q = torch.randn(1, 4, 33, 64, device=cuda_device, requires_grad=True)
    k = torch.randn(1, 2, 33, 64, device=cuda_device)
    with pytest.raises(RuntimeError, match="gradient"):
        flash_attention_cuda(q, k, k, True)
    r = torch.randn(1, 2, 5, 16, device=cuda_device)
    u = torch.randn(2, 16, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="gradient"):
        wkv6_cuda(r, r, r, r.sigmoid(), u)
    with pytest.raises(ValueError, match="state_out"):
        ops.wkv6(r, r, r, r.sigmoid(), u, state_out=torch.zeros(1, 2, 16, 16, device=cuda_device))
    with torch.no_grad():  # serving: no gradient wanted, the bare kernels run
        flash_attention_cuda(q, k, k, True)
        wkv6_cuda(r, r, r, r.sigmoid(), u)
    ops.reset_launches()
    ops.flash_attention(q, k, k).sum().backward()
    y, _ = ops.wkv6(r, r, r, r.sigmoid(), u)
    y.sum().backward()
    assert q.grad is not None and u.grad is not None and u.grad.abs().max() > 0
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == {
        "flash_attention_f32_sm90": 1, "flash_attention_bwd_f32_sm90": 1, "wkv6": 1,
        "wkv6_bwd": 1}


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "rwkv6-7b"])
def test_train_step_on_the_card_matches_the_cpu(cuda_device, arch):
    from repro_torch.train.train_step import init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get(arch), microbatches=2)
    cpu = lm.init_params(cfg, torch.Generator("cpu").manual_seed(0), device="cpu")
    card = copy.deepcopy(cpu).to(cuda_device)
    cpu_s, card_s = init_train_state(cfg, params=cpu), init_train_state(cfg, params=card)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (4, 33))
    batch = {"tokens": torch.as_tensor(toks[:, :-1]), "labels": torch.as_tensor(toks[:, 1:])}
    step = make_train_step(cfg)
    for _ in range(2):
        card_s, mc = step(card_s, {n: t.to(cuda_device) for n, t in batch.items()})
        cpu_s, mh = step(cpu_s, batch)
        assert abs(float(mc["loss"]) - float(mh["loss"])) <= 1e-5 * abs(float(mh["loss"]))
    for a, b in zip(card_s["params"].parameters(), cpu_s["params"].parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0, atol=2e-5)
