"""The port's engine modules (``repro_torch.core``, ``repro_torch.data``)
against the JAX package on the CPU: representation round-trips, hashing,
group-by, aggregation, sort, joins, expressions, state carried across
from a JAX frame, and the TPC-H generator.

Every input is made from a seed with numpy and handed to both
packages.  Integers, codes, row order and null masks must match
exactly; float sums are held to rtol 1e-12 (both sides add in row
order on the CPU, so in practice they agree bit for bit)."""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core as J
from repro.core import agg as j_agg
from repro.core import expr as j_expr
from repro.core import hashing as j_hashing
from repro.core.frame import _valid_name as j_valid_name
from repro.data import tpch as j_tpch
import repro_torch.core as T
from repro_torch.core import agg as t_agg
from repro_torch.core import expr as t_expr
from repro_torch.core import hashing as t_hashing
from repro_torch.core.config import CONFIG
from repro_torch.core.frame import _valid_name
from repro_torch.data import tpch as t_tpch

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _x64_on(_x64_policy):
    # the conftest policy turns x64 off for this file's prefix; the
    # reference engine needs exact int64 keys
    jax.config.update("jax_enable_x64", True)
    yield


@pytest.fixture(params=[True, False], ids=["late", "eager"])
def late(request):
    saved_j, saved_t = J.CONFIG.late_materialization, CONFIG.late_materialization
    J.CONFIG.late_materialization = CONFIG.late_materialization = request.param
    yield request.param
    J.CONFIG.late_materialization, CONFIG.late_materialization = saved_j, saved_t


def _pair(data, valid=None, encode=None):
    """The same host data as a JAX frame and a port frame on the CPU,
    with validity companions for the columns in ``valid``."""
    jf = J.TensorFrame.from_arrays(data, encode=encode)
    tf = T.TensorFrame.from_arrays(data, encode=encode, device="cpu")
    for name, mask in (valid or {}).items():
        v = mask.astype(np.int64)
        jf = jf._append_int_column(j_valid_name(name), jnp.asarray(v), "bool")
        tf = tf._append_int_column(_valid_name(name), torch.as_tensor(v), "bool")
    return jf, tf


def _mixed(n=60, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "i": rng.integers(-5, 20, n),
        "f": np.round(rng.random(n) * 10, 3),
        "s": rng.choice(["aa", "bb", "cc", "dd"], n).astype(object),
        "o": np.array([f"obj-{v % 37}" for v in range(n)], dtype=object),
        "dt": np.datetime64("1969-06-01") + rng.integers(0, 900, n).astype("timedelta64[D]"),
        "b": rng.random(n) < 0.5,
        "k": rng.integers(0, 8, n),
    }


def _masks(n=60, seed=0):
    rng = np.random.default_rng(seed + 100)
    return {"i": rng.random(n) < 0.8, "f": rng.random(n) < 0.8, "s": rng.random(n) < 0.9}


def _assert_same_dict(a, b, rtol=0.0):
    assert list(a) == list(b)
    for c in a:
        x, y = np.asarray(a[c]), np.asarray(b[c])
        assert x.shape == y.shape, c
        if x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=rtol, atol=0, equal_nan=True, err_msg=c)
        else:
            np.testing.assert_array_equal(x, y, err_msg=c)


def _arr(t):
    return np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)


# ----------------------------------------------------------------------
# representation
# ----------------------------------------------------------------------
@pytest.mark.parametrize("nulls", [False, True], ids=["no-nulls", "nulls"])
def test_roundtrip_every_kind_matches_jax(late, nulls):
    data = _mixed()
    jf, tf = _pair(data, _masks() if nulls else None, encode={"s": "dict", "o": "obj"})
    assert [m.kind for m in tf.columns.values()] == [m.kind for m in jf.columns.values()]
    _assert_same_dict(tf.to_dict(), jf.to_dict())
    rows = np.array([7, 3, 3, 0, 59, 12, 40, 40])
    jv, tv = jf.take(rows), tf.take(rows)
    assert tv.is_view == late
    _assert_same_dict(tv.to_dict(), jv.to_dict())
    # filter -> with_column -> take keeps decoding like the JAX engine
    jv = jv.filter(J.col("k") > 2).with_column("x", J.col("f") * 2 + 1).take(np.array([1, 0, 2]))
    tv = tv.filter(T.col("k") > 2).with_column("x", T.col("f") * 2 + 1).take(np.array([1, 0, 2]))
    _assert_same_dict(tv.to_dict(), jv.to_dict())
    assert tv.materialize().to_dict().keys() == jv.to_dict().keys()


def test_state_roundtrip_and_device_of_derived_frames():
    jf, tf = _pair(_mixed(), _masks(), encode={"s": "dict", "o": "obj"})
    tf.set_stats("k", vmin=0, vmax=7)
    sub = tf.take(np.arange(10), stats="subset")
    back = T.TensorFrame.from_state(sub.to_state(), device="cpu")
    _assert_same_dict(back.to_dict(), sub.to_dict())
    assert back.col_stats("k") == tf.col_stats("k")
    derived = tf.filter(T.col("k") > 1).groupby("s").agg([("n", "size", "")])
    assert derived.device == CPU and derived.itensor.device == CPU


def test_entry_points_raise_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is usable")
    assert CONFIG.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.TensorFrame.from_arrays({"a": np.arange(3)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_tpch.as_frames({"t": {"a": np.arange(3)}})
    assert T.TensorFrame.from_arrays({"a": np.arange(3)}, device="cpu").device == CPU


# ----------------------------------------------------------------------
# hashing, composite keys, distinct
# ----------------------------------------------------------------------
def test_splitmix64_and_hash_combine_bit_exact():
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        rng.integers(-(1 << 63), (1 << 63) - 1, 2000, dtype=np.int64),
        rng.integers(1 << 62, (1 << 63) - 1, 500, dtype=np.int64),  # above 2^62
        np.array([0, 1, -1, (1 << 63) - 1, -(1 << 63), 1 << 62], dtype=np.int64),
    ])
    got = t_hashing.splitmix64(torch.as_tensor(vals)).numpy()
    want = np.asarray(j_hashing.splitmix64(jnp.asarray(vals))).view(np.int64)
    np.testing.assert_array_equal(got, want)
    cols = [vals, np.roll(vals, 7), rng.integers(0, 1000, vals.size)]
    got = t_hashing.hash_combine([torch.as_tensor(c) for c in cols]).numpy()
    want = np.asarray(j_hashing.hash_combine([jnp.asarray(c) for c in cols]))
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).all()


_WIDE = ["w1", "w2", "w3", "w4"]


@pytest.mark.parametrize("keys", [["s", "k"], ["i", "dt", "b"], ["f"], ["o", "s"], _WIDE])
def test_composite_key_and_distinct_match_jax(keys):
    data = _mixed(200, seed=3)
    rng = np.random.default_rng(4)
    # four ints spanning 2^20 each: their domain product overflows exact
    # packing, so the key takes the splitmix64 hash path
    for c in _WIDE:
        data[c] = rng.integers(0, 1 << 20, 200)
    jf, tf = _pair(data, encode={"s": "dict", "o": "obj"})
    jp, jexact, jdom = j_hashing.composite_key(jf, keys)
    tp, texact, tdom = t_hashing.composite_key(tf, keys)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert (texact, tdom) == (jexact, jdom)
    assert texact == (keys != _WIDE)
    for dom in {None, tdom}:  # sort path, and the dense path where it applies
        ju, jg, jm = j_hashing.distinct(jp, dom)
        tu, tg, tm = t_hashing.distinct(tp, dom)
        assert tm == jm
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


# ----------------------------------------------------------------------
# group-by aggregation and sort
# ----------------------------------------------------------------------
_SPECS = [
    ("n", "size", ""),
    ("cnt_i", "count", "i"),
    ("sum_i", "sum", "i"),
    ("sum_f", "sum", "f"),
    ("mean_f", "mean", "f"),
    ("mean_i", "mean", "i"),
    ("min_i", "min", "i"),
    ("max_f", "max", "f"),
    ("min_dt", "min", "dt"),
    ("nu_s", "nunique", "s"),
    ("nu_i", "nunique", "i"),
    ("first_s", "first", "s"),
    ("first_dt", "first", "dt"),
    ("first_b", "first", "b"),
]


@pytest.mark.parametrize(
    "keys,late", [(["s"], True), (["k", "b"], False)], indirect=["late"]
)
def test_every_aggregation_matches_jax(late, keys):
    assert {fn for _, fn, _ in _SPECS} == set(t_agg.AGG_FNS) == set(j_agg.AGG_FNS)
    jf, tf = _pair(_mixed(300, seed=5), _masks(300, seed=5), encode={"s": "dict", "o": "obj"})
    jg = jf.groupby(keys).agg(_SPECS)
    tg = tf.groupby(keys).agg(_SPECS)
    _assert_same_dict(tg.to_dict(), jg.to_dict(), rtol=1e-12)
    for name in ("i", "f", "s"):
        assert (tg.valid_array(name) is None) == (jg.valid_array(name) is None)
    whole = [s for s in _SPECS if s[1] != "first"]
    tw, jw = tf.agg(whole), jf.agg(whole)
    assert list(tw) == list(jw)
    for k in tw:
        assert type(tw[k]) is type(jw[k]), k
        assert tw[k] == pytest.approx(jw[k], rel=1e-12), k
    te, je = tf.take(np.arange(0)).agg(whole), jf.take(np.arange(0)).agg(whole)
    assert te.keys() == je.keys()
    for k in te:  # pandas semantics on no rows: 0 for counts and sums, else NaN
        assert te[k] == je[k] or (np.isnan(te[k]) and np.isnan(je[k])), k


@pytest.mark.parametrize(
    "by,asc",
    [
        (["k"], True),
        (["s", "k"], [False, True]),
        (["b", "f", "dt"], [True, False, True]),
        (["o"], False),
    ],
)
def test_sort_values_with_ties_matches_jax(late, by, asc):
    jf, tf = _pair(_mixed(120, seed=9), encode={"s": "dict", "o": "obj"})
    _assert_same_dict(tf.sort_values(by, asc).to_dict(), jf.sort_values(by, asc).to_dict())


def test_civil_from_days_matches_jax_on_negative_days():
    days = np.concatenate([np.arange(-800_000, 800_000, 997), [-719468, -719469, -1, 0, 59, 60]])
    got = t_expr.civil_from_days(torch.as_tensor(days))
    want = j_expr.civil_from_days(jnp.asarray(days))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ----------------------------------------------------------------------
# joins
# ----------------------------------------------------------------------
def _join_pair(rng, n, tag):
    k1 = rng.integers(0, 6, n)
    k2 = np.array([f"s{v}" for v in rng.integers(0, 4, n)], dtype=object)
    nulls = rng.random(n) < 0.2
    return _pair(
        {"k1": k1, "k2": k2, f"payload{tag}": np.arange(n), f"val{tag}": rng.random(n)},
        {"k1": ~nulls},
        encode={"k2": "dict"},
    )


def _row_multiset(frame):
    d = frame.to_dict()
    names = sorted(d)
    valid = {c: _arr(frame.valid_array(c)) if frame.has_nulls(c) else None for c in names}

    def cell(c, i):
        if valid[c] is not None and not valid[c][i]:
            return "<null>"
        v = d[c][i]
        return "<nan>" if isinstance(v, float) and np.isnan(v) else str(v)

    return sorted(tuple(cell(c, i) for c in names) for i in range(frame.nrows))


_JOIN_CASES = [
    # (how, nkeys, algorithm, late)
    ("inner", 2, "auto", True),
    ("inner", 1, "sortmerge", False),
    ("left", 2, "sorted", True),
    ("semi", 2, "auto", True),
    ("anti", 1, "auto", False),
]


@pytest.mark.parametrize("how,nkeys,algorithm,late", _JOIN_CASES, indirect=["late"])
def test_joins_with_nulls_and_duplicates_match_jax(late, how, nkeys, algorithm):
    rng = np.random.default_rng(nkeys * 7 + len(how))
    jl, tl = _join_pair(rng, 35, "L")
    jr, tr = _join_pair(rng, 25, "R")
    keys = ["k1", "k2"][:nkeys]
    jo = jl.join(jr, on=keys, how=how, algorithm=algorithm)
    to = tl.join(tr, on=keys, how=how, algorithm=algorithm)
    assert to.nrows == jo.nrows
    assert _row_multiset(to) == _row_multiset(jo)


def test_unique_build_side_takes_the_direct_address_path():
    t_join = importlib.import_module("repro_torch.core.join")

    rng = np.random.default_rng(1)
    jl, tl = _pair({"k": rng.integers(0, 50, 200), "v": rng.random(200)})
    jr, tr = _pair({"k": np.arange(0, 60, 2), "w": rng.random(30)})
    t_join.reset_stats()
    _assert_same_dict(tl.join(tr, on="k").to_dict(), jl.join(jr, on="k").to_dict())
    assert t_join.STATS["uniqueness_sort_tests"] == 1
    tl.join(tr, on="k")  # the verdict is cached on the build frame
    assert t_join.STATS["stats_unique_hits"] == 1


# ----------------------------------------------------------------------
# expressions and string predicates
# ----------------------------------------------------------------------
def _string_exprs(M):
    c = M.col
    return [
        c("s").str.contains("b"),
        c("o").str.contains("-1"),
        c("o").str.startswith("obj-2"),
        c("o").str.endswith("7"),
        c("o").str.like("%bj%3"),
        c("o").str.not_exists_before("obj", "2"),
        c("s") == "bb",
        c("s") >= "bb",
        c("o").isin(["obj-1", "obj-30"]),
        c("dt").dt.year() == 1970,
        c("dt").dt.month() >= 6,
        c("i").is_null(),
        M.if_else(c("b"), c("f"), c("i").cast_float()) > 5.0,
    ]


@pytest.mark.parametrize(
    "n,device_strings",
    [(60, False), (3000, False), (60, True)],
    ids=["host-lut", "packed-lut", "device-path"],
)
def test_filters_and_string_predicates_match_jax(device_strings, n):
    data = _mixed(n, seed=11)
    data["o"] = np.array([f"obj-{v}" for v in range(n)], dtype=object)  # n distinct
    jf, tf = _pair(data, _masks(n, seed=11), encode={"s": "dict", "o": "obj"})
    saved = J.CONFIG.use_device_strings, CONFIG.use_device_strings
    J.CONFIG.use_device_strings = CONFIG.use_device_strings = device_strings
    try:
        for je, te in zip(_string_exprs(J), _string_exprs(T)):
            np.testing.assert_array_equal(_arr(te.eval_bool(tf)), np.asarray(je.eval_bool(jf)))
        jv = jf.with_column("p", J.col("o").str.slice(0, 5)).with_column("ln", J.col("s").str.len())
        tv = tf.with_column("p", T.col("o").str.slice(0, 5)).with_column("ln", T.col("s").str.len())
        _assert_same_dict(tv.to_dict(), jv.to_dict())
    finally:
        J.CONFIG.use_device_strings, CONFIG.use_device_strings = saved


def test_udf_lowers_through_vmap_like_jax_udf():
    jf, tf = _pair(_mixed(), _masks())
    je = J.udf(lambda a, b: a * 2.0 + b, J.col("f"), J.col("i"))
    te = T.udf(lambda a, b: a * 2.0 + b, T.col("f"), T.col("i"))
    _assert_same_dict(
        tf.with_column("u", te).to_dict(), jf.with_column("u", je).to_dict(), rtol=1e-15
    )


# ----------------------------------------------------------------------
# data carried across from the JAX package
# ----------------------------------------------------------------------
def _jax_state(frame):
    """The eager host representation of a (materialized) JAX frame."""
    frame.materialize()
    return {
        "nrows": frame.nrows,
        "itensor": np.asarray(frame.itensor),
        "ftensor": np.asarray(frame.ftensor),
        "columns": [(m.name, m.kind, m.slot, m.dictionary) for m in frame.columns.values()],
        "offloaded": {
            name: (oc.values, np.asarray(oc.idx)) for name, oc in frame.offloaded.items()
        },
        "stats": {k: dataclasses.asdict(v) for k, v in frame._stats.items()},
    }


def test_from_state_carries_a_jax_frame_across(late):
    jf, _ = _pair(_mixed(), _masks(), encode={"s": "dict", "o": "obj"})
    jv = jf.take(np.array([5, 1, 1, 9, 30])).filter(J.col("k") >= 0)
    jv.set_stats("k", vmin=0, vmax=7)
    tf = T.TensorFrame.from_state(_jax_state(jv), device="cpu")
    _assert_same_dict(tf.to_dict(), jv.to_dict())
    assert tf.col_stats("k").vmax == 7
    _assert_same_dict(
        tf.groupby("s").agg([("t", "sum", "f")]).to_dict(),
        jv.groupby("s").agg([("t", "sum", "f")]).to_dict(),
        rtol=1e-12,
    )


def test_generate_matches_the_reference_generator(tpch_small):
    tables, _ = tpch_small
    mine = t_tpch.generate(sf=0.002, seed=42)
    assert list(mine) == list(tables)
    for name, cols in tables.items():
        assert list(mine[name]) == list(cols), name
        for c, arr in cols.items():
            assert mine[name][c].dtype == arr.dtype, (name, c)
            np.testing.assert_array_equal(mine[name][c], arr, err_msg=f"{name}.{c}")
    assert j_tpch.generate is not t_tpch.generate
