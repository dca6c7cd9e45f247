"""The port's last public names against the JAX package's, on the CPU:

* the Fig. 11 group-by baselines (``incremental_group_ids``,
  ``pydict_group_ids``, ``transposed_group_ids``), group id for group id
  on seeded int columns, 0 rows, 1 row and a column of one value;
* ``cardinality_ratio``, ``INT_NULL`` and ``ColumnMeta.is_int_like``;
* ``models.rwkv.wkv6_chunked`` against the reference's and against the
  port's plain ``ops.wkv6``;
* the row-at-a-time TPC-H and TPC-DS references, byte for byte;
* ``launch.hlo_analysis.collective_bytes`` and ``count_op`` on a small
  step of a one-rank gloo group.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import dist_ranks
from repro.core import encoding as j_encoding
from repro.core import frame as j_frame
from repro.core import groupby as j_groupby
from repro.models import rwkv as j_rwkv
from repro_torch.core import encoding, frame, groupby
from repro_torch.kernels import ops
from repro_torch.launch import hlo_analysis
from repro_torch.models import rwkv

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _x64_on(_x64_policy):
    # the conftest policy turns x64 off for this file's prefix; the
    # reference's transposed baseline packs int64 keys
    jax.config.update("jax_enable_x64", True)
    yield


# ----------------------------------------------------------------------
# Fig. 11 baselines
# ----------------------------------------------------------------------
BASELINES = ("incremental_group_ids", "pydict_group_ids", "transposed_group_ids")


def _columns(case: str, k: int):
    rng = np.random.default_rng(100 + k)
    if case == "seeded":
        # cardinalities 7, 40, 3: the composite key takes every mixed radix
        return [rng.integers(0, card, 500) for card in (7, 40, 3)[:k]]
    if case == "empty":
        return [np.zeros(0, dtype=np.int64) for _ in range(k)]
    if case == "one_row":
        return [rng.integers(0, 9, 1) for _ in range(k)]
    # one value in the first column, seeded values in the rest
    return [np.full(300, 5, dtype=np.int64)] + [rng.integers(0, 11, 300) for _ in range(k - 1)]


@pytest.mark.parametrize("case", ["seeded", "empty", "one_row", "one_value"])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("name", BASELINES)
def test_group_id_baselines_equal_the_reference(name, k, case):
    cols = _columns(case, k)
    want = np.asarray(getattr(j_groupby, name)(cols))
    kw = {"device": "cpu"} if name == "transposed_group_ids" else {}
    got = getattr(groupby, name)(cols, **kw)
    assert isinstance(got, np.ndarray)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_transposed_group_ids_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        groupby.transposed_group_ids([np.arange(4)], device="cuda")


# ----------------------------------------------------------------------
# small names
# ----------------------------------------------------------------------
@pytest.mark.parametrize("values", [
    np.array([3, 1, 3, 3, 2]),
    np.array(["a", "b", "a"], dtype=object),
    np.zeros(0, dtype=np.int64),
])
def test_cardinality_ratio_equals_the_reference(values):
    assert encoding.cardinality_ratio(values) == j_encoding.cardinality_ratio(values)


def test_int_null_and_is_int_like_equal_the_reference():
    assert frame.INT_NULL == j_frame.INT_NULL and frame.INT_NULL.dtype == j_frame.INT_NULL.dtype
    for kind in ("int", "float", "bool", "date", "dict", "obj"):
        got = frame.ColumnMeta("c", kind, 0).is_int_like()
        assert got == j_frame.ColumnMeta("c", kind, 0).is_int_like(), kind


# ----------------------------------------------------------------------
# wkv6_chunked
# ----------------------------------------------------------------------
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_chunked_matches_the_reference_and_the_plain_kernel(with_state):
    B, H, T, hd = 1, 2, 64, 16
    rng = np.random.default_rng(31)
    r, k, v = (rng.normal(size=(B, H, T, hd)).astype(np.float32) for _ in range(3))
    # the form divides by the running product of w: w stays in [0.5, 1)
    w = rng.uniform(0.5, 1.0, size=(B, H, T, hd)).astype(np.float32)
    u = (rng.normal(size=(H, hd)) * 0.5).astype(np.float32)
    s0 = rng.normal(size=(B, H, hd, hd)).astype(np.float32) if with_state else None
    y_ref, s_ref = j_rwkv.wkv6_chunked(r, k, v, w, u, state=s0)
    t = lambda a: torch.from_numpy(a)
    y, s = rwkv.wkv6_chunked(t(r), t(k), t(v), t(w), t(u),
                             state=None if s0 is None else t(s0))
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    state = torch.zeros((B, H, hd, hd)) if s0 is None else t(s0)
    y_plain, s_plain = ops.wkv6(t(r), t(k), t(v), t(w), t(u), state)
    # within 1e-5 of each output's largest magnitude (y reaches about 35
    # here, where a float32 ulp is 3.8e-6)
    for got, ref, plain in ((y, y_ref, y_plain), (s, s_ref, s_plain)):
        ref = np.asarray(ref)
        tol = 1e-5 * float(np.abs(ref).max())
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=tol)


# ----------------------------------------------------------------------
# row references
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["tpch_numpy.py", "tpcds_numpy.py"])
def test_row_references_are_byte_copies(name):
    port = (ROOT / "src" / "repro_torch" / "queries" / name).read_bytes()
    assert port == (ROOT / "src" / "repro" / "queries" / name).read_bytes()


# ----------------------------------------------------------------------
# collective_bytes and count_op
# ----------------------------------------------------------------------
def test_collective_bytes_and_count_op_on_a_one_rank_step():
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.dist import dframe
    from repro_torch.launch.mesh import make_host_mesh

    dframe.init_local("cpu", timeout=dist_ranks.GLOO_TIMEOUT)
    try:
        mesh = make_host_mesh(1, device_type="cpu")
        D = 32
        gen = torch.Generator("cpu").manual_seed(4)
        w = distribute_tensor(torch.randn(D, D, generator=gen), mesh, [Replicate(), Replicate()])
        x = distribute_tensor(torch.randn(8, D, generator=gen), mesh, [Replicate(), Replicate()])

        def step():
            y = (x @ w).to_local()  # a product on DTensors: one local mm
            y = funcol.all_reduce(y, "sum", mesh["data"])  # one all-reduce of 8 x D floats
            y = y @ w.to_local()
            return y @ w.to_local()

        out, counts = hlo_analysis.analyze(step, (w, x))
    finally:
        torch.distributed.destroy_process_group()
    xl, wl = x.to_local(), w.to_local()
    torch.testing.assert_close(out, xl @ wl @ wl @ wl)
    assert hlo_analysis.collective_bytes(counts) == {"all-reduce": 8 * D * 4, "total": 8 * D * 4}
    assert hlo_analysis.count_op(counts, "mm") == 3
    assert hlo_analysis.count_op(counts, "all_reduce") == 1
    assert hlo_analysis.count_op(counts, "bmm") == 0
    # no collective: the reference's shape, a total of 0
    _, none = hlo_analysis.analyze(lambda: xl @ wl, (xl, wl))
    assert hlo_analysis.collective_bytes(none) == {"total": 0}
    assert hlo_analysis.count_op(none, "mm") == 1
