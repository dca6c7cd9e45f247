"""The port's store (``repro_torch.store``) and ``TensorFrame.from_store``
against the JAX package's on the CPU.

The same host arrays (made from a seed with numpy) go through both
packages: the chunks, encodings, zone-map ``ChunkStats`` and interned
dictionaries must be identical, ``scan`` must return the same rows,
``rows_scanned`` and ``chunks_skipped`` for the same predicates, a tfb
v2 file written by the port must be byte-identical to the reference's,
each package must read the other's v1 and v2 files, and ``from_store``
frames must hold the same columns, codes and dictionaries and move the
join ``STATS`` counters as the reference's do.  The store-level tests of
tests/test_store.py, test_store_properties.py and the store half of
test_store_pushdown.py run on the port as well.
"""
import importlib
import os

import numpy as np
import pytest

import jax

from repro import store as j_store
from repro.core import TensorFrame as JFrame
from repro.core import io as j_io
from repro_torch import obs
from repro_torch import store
from repro_torch.core import TensorFrame, encoding
from repro_torch.core import io as tio
from repro_torch.store.pool import StringPool

j_join = importlib.import_module("repro.core.join")
t_join = importlib.import_module("repro_torch.core.join")


@pytest.fixture(autouse=True, scope="module")
def _x64_on(_x64_policy):
    # the conftest policy turns x64 off for this file's prefix; the
    # reference engine needs exact int64 keys
    jax.config.update("jax_enable_x64", True)
    yield


@pytest.fixture(autouse=True)
def _port_metrics_reset():
    obs.metrics.reset()
    obs.clear_trace()
    yield


# ----------------------------------------------------------------------
# inputs: each made from a seed with numpy
# ----------------------------------------------------------------------
def _mixed_table(n=300, seed=5):
    rng = np.random.default_rng(seed)
    return {
        "i": rng.integers(0, 1000, n),
        "f": np.round(rng.uniform(-10, 10, n), 3),
        "d": np.datetime64("1993-05-01", "D")
        + np.sort(rng.integers(0, 400, n)).astype("timedelta64[D]"),
        "s": np.array(["AA", "BB", "CC"], dtype=object)[rng.integers(0, 3, n)],
        "hc": np.array([f"key-{i:05d}" for i in range(n)], dtype=object),
    }


def _policy_table(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "low_card": np.array(["a", "b", "c"], dtype=object)[rng.integers(0, 3, n)],
        "high_card": np.array([f"id{i}" for i in range(n)], dtype=object),
        "clustered": np.sort(rng.integers(0, 40, n)),
        "scattered": rng.integers(0, 1 << 40, n),
        "measure": rng.uniform(0, 1, n),
        "flag": rng.integers(0, 2, n).astype(bool),
    }


def _null_table(n=128, chunk_rows=16, seed=7):
    rng = np.random.default_rng(seed)
    price = rng.random(n) * 100
    price[rng.random(n) < 0.25] = np.nan
    price[:chunk_rows] = np.nan  # one all-null chunk
    cat = rng.choice(["alpha", "alphonse", "beta", "gamma", "delta"], n).astype(object)
    ship = np.sort(rng.choice([f"MODE{i}" for i in range(40)], n)).astype(object)
    return {"k": np.arange(n), "price": price, "cat": cat, "ship": ship}


DATASETS = {
    "mixed": (_mixed_table, dict(chunk_rows=64)),
    "policy": (_policy_table, dict(chunk_rows=512)),
    "nulls": (_null_table, dict(chunk_rows=16, encode={"ship": "plain"})),
    "forced": (_mixed_table, dict(chunk_rows=37, encode={"hc": "dict", "s": "plain", "d": "rle"})),
}


def _validity(data, seed=11):
    """Bitmaps for the int and string columns of a table (nullable
    non-float columns)."""
    rng = np.random.default_rng(seed)
    return {
        name: rng.random(arr.shape[0]) > 0.2
        for name, arr in data.items()
        if arr.dtype.kind in "iO"
    }


def _both(make, kw, validity=False):
    data = make()
    kw = dict(kw)
    if validity:
        kw["validity"] = _validity(data)
    return data, store.Table.from_arrays(data, **kw), j_store.Table.from_arrays(data, **kw)


def _stats(c):
    return (c.stats.vmin, c.stats.vmax, c.stats.null_count, c.stats.distinct)


def _assert_same_array(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(a, b, err_msg=what)  # NaN == NaN here
    else:
        assert a.tolist() == b.tolist(), what


def _assert_same_table(mine, ref):
    assert (mine.nrows, mine.chunk_rows, mine.n_chunks) == (ref.nrows, ref.chunk_rows, ref.n_chunks)
    assert mine.column_names == ref.column_names
    assert mine.schema() == ref.schema()
    for name in ref.column_names:
        a, b = mine.columns[name], ref.columns[name]
        assert (a.ctype, a.encoding) == (b.ctype, b.encoding), name
        if b.dictionary is None:
            assert a.dictionary is None, name
        else:
            _assert_same_array(a.dictionary, b.dictionary, f"{name} dictionary")
            assert not a.dictionary.flags.writeable  # interned: read-only
        assert len(a.chunks) == len(b.chunks)
        for i, (ca, cb) in enumerate(zip(a.chunks, b.chunks)):
            assert ca.n == cb.n
            assert _stats(ca) == _stats(cb), (name, i)
            pa, pb = ca.payload(), cb.payload()
            if a.encoding == "rle":
                for x, y in zip(pa, pb):
                    _assert_same_array(x, y, f"{name}[{i}] rle")
            else:
                _assert_same_array(pa, pb, f"{name}[{i}]")
            va, vb = ca.validity(), cb.validity()
            assert (va is None) == (vb is None), (name, i)
            if vb is not None:
                _assert_same_array(va, vb, f"{name}[{i}] validity")
        assert a.uniqueness_from_stats() == b.uniqueness_from_stats(), name
        if a.ctype != "str":
            for x, y in zip(a.zone_bounds(), b.zone_bounds()):
                _assert_same_array(x, y, f"{name} zone bounds")


# ----------------------------------------------------------------------
# chunks, encodings, stats, dictionaries: the reference's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("validity", [False, True])
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_table_matches_reference(name, validity):
    make, kw = DATASETS[name]
    _, mine, ref = _both(make, kw, validity)
    _assert_same_table(mine, ref)
    assert mine.memory_bytes() == ref.memory_bytes()


def test_policy_picks_dict_rle_plain():
    data, t, _ = _both(*DATASETS["policy"])
    assert t.columns["low_card"].encoding == "dict"
    assert t.columns["high_card"].encoding == "plain"
    assert t.columns["clustered"].encoding == "rle"
    assert t.columns["scattered"].encoding == "plain"
    assert t.columns["measure"].encoding == "plain"
    assert t.n_chunks == (4000 + 511) // 512


def test_forced_encoding_overrides_policy():
    arr = {"s": np.array([f"u{i}" for i in range(100)], dtype=object)}
    assert store.Table.from_arrays(arr, encode={"s": "dict"}).columns["s"].encoding == "dict"
    with pytest.raises(ValueError):
        store.Table.from_arrays({"x": np.arange(5.0)}, encode={"x": "rle"})


def test_chunk_stats_zone_maps_and_nulls():
    vals = np.array([3.0, np.nan, 7.0, np.nan, 5.0])
    s = store.compute_stats(vals, "float")
    ref = j_store.compute_stats(vals, "float")
    assert (s.vmin, s.vmax, s.null_count, s.distinct) == (ref.vmin, ref.vmax, ref.null_count, ref.distinct)
    assert s.vmin == 3.0 and s.vmax == 7.0
    assert s.null_count == 2 and s.distinct == 3
    all_null = store.compute_stats(np.array([np.nan, np.nan]), "float")
    assert all_null.vmin is None and all_null.null_count == 2
    # all-null chunks are skippable under every predicate except <>,
    # where NaN cells match (IEEE, like the engine's filter lowering)
    assert not store.chunk_may_match(all_null, ("=", 1.0))
    assert not store.chunk_may_match(all_null, ("<", 1.0))
    assert store.chunk_may_match(all_null, ("<>", 1.0))


def test_dict_zone_maps_are_code_ranges():
    t = store.Table.from_arrays({"s": np.array(list("aabbccdd"), dtype=object)}, chunk_rows=4)
    col = t.columns["s"]
    assert col.encoding == "dict"
    # sorted dictionary => chunk 0 holds codes {0,1}, chunk 1 {2,3}
    assert (col.chunks[0].stats.vmin, col.chunks[0].stats.vmax) == (0, 1)
    assert (col.chunks[1].stats.vmin, col.chunks[1].stats.vmax) == (2, 3)
    r = store.scan(t, ["s"], [store.Pred("s", "=", "a")])
    assert r.chunks_skipped == 1 and r.nrows == 2


# ----------------------------------------------------------------------
# scan: the reference's rows, rows_scanned and chunks_skipped
# ----------------------------------------------------------------------
_MIXED_PREDS = [
    ("i", "<", 300), ("i", ">=", 998), ("i", "=", 17), ("i", "<>", 17),
    ("i", "<", 2.5), ("i", "between", (100, 200)), ("i", "in", (3, 999, 40)),
    ("f", "<=", -9.5), ("f", ">", 0.0), ("d", "<", np.datetime64("1993-07-01")),
    ("d", "between", (np.datetime64("1993-09-01"), np.datetime64("1993-10-01"))),
    ("s", "=", "BB"), ("s", "<>", "AA"), ("s", ">", "AZ"), ("s", "in", ("CC", "ZZ")),
    ("hc", ">=", "key-00250"), ("hc", "like", "key-001"), ("s", "like", "B"),
    ("i", "isnull", None), ("i", "notnull", None),
]
_NULL_PREDS = [
    ("price", "isnull", None), ("price", "notnull", None), ("price", "<>", 50.0),
    ("price", "<", 10.0), ("cat", "like", "alph"), ("ship", "like", "MODE3"),
    ("cat", "like", "zzz"), ("k", "isnull", None), ("cat", "notnull", None),
]


def _scan_both(mine, ref, cols, preds):
    a = store.scan(mine, cols, [store.Pred(*p) for p in preds])
    b = j_store.scan(ref, cols, [j_store.Pred(*p) for p in preds])
    assert (a.nrows, a.chunks_total, a.chunks_skipped, a.rows_scanned) == (
        b.nrows, b.chunks_total, b.chunks_skipped, b.rows_scanned), preds
    assert list(a.columns) == list(b.columns)
    for name in b.columns:
        ma, mb = a.columns[name], b.columns[name]
        assert ma.ctype == mb.ctype
        _assert_same_array(ma.values, mb.values, name)
        assert (ma.dictionary is None) == (mb.dictionary is None)
        if mb.dictionary is not None:
            _assert_same_array(ma.dictionary, mb.dictionary, name)
        assert (ma.validity is None) == (mb.validity is None)
        if mb.validity is not None:
            _assert_same_array(ma.validity, mb.validity, name)
    return a


@pytest.mark.parametrize("validity", [False, True])
@pytest.mark.parametrize("pred", _MIXED_PREDS, ids=lambda p: f"{p[0]}{p[1]}")
def test_scan_matches_reference(pred, validity):
    _, mine, ref = _both(*DATASETS["mixed"], validity=validity)
    _scan_both(mine, ref, ["i", "f", "s", "hc"], [pred])


@pytest.mark.parametrize("pred", _NULL_PREDS, ids=lambda p: f"{p[0]}{p[1]}")
def test_scan_with_nulls_matches_reference(pred):
    _, mine, ref = _both(*DATASETS["nulls"])
    _scan_both(mine, ref, ["k", "cat", "ship"], [pred])


def test_conjunctions_and_shared_scan_match_reference():
    _, mine, ref = _both(*DATASETS["mixed"])
    preds = [("i", "<", 600), ("s", "<>", "CC"), ("d", ">=", np.datetime64("1993-08-01"))]
    r = _scan_both(mine, ref, None, preds)
    assert r.chunks_skipped > 0
    reqs = [(["i", "f"], [store.Pred("i", "<", 50)]), (["s"], [store.Pred(*preds[2])])]
    jreqs = [(["i", "f"], [j_store.Pred("i", "<", 50)]), (["s"], [j_store.Pred(*preds[2])])]
    for a, b in zip(store.shared_scan(mine, reqs), j_store.shared_scan(ref, jreqs)):
        assert (a.nrows, a.chunks_skipped, a.rows_scanned) == (b.nrows, b.chunks_skipped, b.rows_scanned)
        for name in b.columns:
            _assert_same_array(a.columns[name].values, b.columns[name].values, name)


def test_clustered_scan_skips_chunks_at_low_selectivity():
    rng = np.random.default_rng(7)
    n = 40_000
    dates = np.sort(np.datetime64("1994-01-01", "D") + rng.integers(0, 2000, n).astype("timedelta64[D]"))
    t = store.Table.from_arrays({"d": dates, "v": rng.uniform(0, 1, n)}, chunk_rows=1024)
    cut = dates[int(0.99 * (n - 1))]  # ~1% selectivity
    r = store.scan(t, ["v"], [store.Pred("d", ">=", cut)])
    assert r.nrows == int((dates >= cut).sum())
    assert r.chunks_skipped >= 0.9 * r.chunks_total
    assert r.rows_scanned <= 0.1 * n


def test_float_constants_against_int_columns_not_truncated():
    """`k < 2.5` means `k <= 2`, never `k < int(2.5) == 2`."""
    arr = np.arange(10)
    t = store.Table.from_arrays({"k": arr}, chunk_rows=3)

    def got(op, v):
        return list(store.scan(t, ["k"], [store.Pred("k", op, v)]).columns["k"].values)

    assert got("<", 2.5) == [0, 1, 2]
    assert got("<=", 2.5) == [0, 1, 2]
    assert got(">", 2.5) == [3, 4, 5, 6, 7, 8, 9]
    assert got(">=", 2.5) == [3, 4, 5, 6, 7, 8, 9]
    assert got("=", 2.5) == []
    assert got("<>", 2.5) == list(arr)
    assert got("between", (1.5, 3.5)) == [2, 3]
    assert got("in", (2.5, 3)) == [3]


def test_huge_int_constants_stay_exact():
    """Constants >= 2**53 must not round-trip through float64."""
    base = 1 << 53
    t = store.Table.from_arrays({"k": np.array([base, base + 1, base + 2], dtype=np.int64)}, chunk_rows=2)
    assert list(store.scan(t, ["k"], [store.Pred("k", "=", base + 1)]).columns["k"].values) == [base + 1]
    assert list(store.scan(t, ["k"], [store.Pred("k", "in", (base + 2,))]).columns["k"].values) == [base + 2]
    r = store.scan(t, ["k"], [store.Pred("k", "between", (base + 1, base + 1))])
    assert list(r.columns["k"].values) == [base + 1]


def test_neq_keeps_chunks_with_nulls_among_uniform_values():
    arr = np.array([5.0, 5.0, np.nan, 5.0, 1.0, 2.0])
    t = store.Table.from_arrays({"x": arr}, chunk_rows=4)
    got = store.scan(t, ["x"], [store.Pred("x", "<>", 5.0)]).columns["x"].values
    with np.errstate(invalid="ignore"):
        ref = arr[arr != 5.0]
    np.testing.assert_array_equal(got, ref)
    t2 = store.Table.from_arrays({"x": np.array([5.0] * 4 + [1.0] * 4)}, chunk_rows=4)
    r = store.scan(t2, ["x"], [store.Pred("x", "<>", 5.0)])
    assert r.chunks_skipped == 1 and list(r.columns["x"].values) == [1.0] * 4


# ----------------------------------------------------------------------
# interned dictionaries and the bounded pool
# ----------------------------------------------------------------------
def test_intern_returns_same_object_for_equal_content():
    a = store.intern_dictionary(np.array(["a", "b"], dtype=object))
    b = store.intern_dictionary(np.array(["a", "b"], dtype=object))
    c = store.intern_dictionary(np.array(["a", "c"], dtype=object))
    assert a is b and a is not c
    with pytest.raises(ValueError):
        a[0] = "z"  # interned arrays are read-only
    # the port's pool is its own: it shares no object with the reference's
    assert j_store.intern_dictionary(np.array(["a", "b"], dtype=object)) is not a


def test_merge_dictionaries_identity_fast_path():
    d = store.intern_dictionary(np.array(["a", "b", "c"], dtype=object))
    merged, ra, rb = encoding.merge_dictionaries(d, d)
    assert merged is d
    np.testing.assert_array_equal(ra, [0, 1, 2])
    np.testing.assert_array_equal(rb, [0, 1, 2])


def _dic(i):
    return np.array([f"v{i}a", f"v{i}b"], dtype=object)


def test_pool_evicts_lru_and_counts_like_reference():
    from repro.store.pool import StringPool as JPool

    mine, ref = StringPool(max_entries=3), JPool(max_entries=3)
    for p in (mine, ref):
        first = p.intern(_dic(0))
        for i in (1, 2, 0, 3, 4, 1, 0):
            p.intern(_dic(i))
        assert p.intern(_dic(0)) is not first  # evicted, re-interned
    assert mine.stats_snapshot() == ref.stats_snapshot()
    assert len(mine) == len(ref) == 3


def test_pool_lru_touch_protects_hot_entries():
    p = StringPool(max_entries=2)
    hot = p.intern(_dic(0))
    p.intern(_dic(1))
    assert p.intern(_dic(0)) is hot  # touch 0 -> 1 becomes LRU
    p.intern(_dic(2))  # evicts 1, not 0
    assert p.intern(_dic(0)) is hot


def test_pool_clear_unbounded_and_metrics_group():
    p = StringPool(max_entries=None)
    for i in range(64):
        p.intern(_dic(i))
    assert len(p) == 64 and p.evictions == 0
    p.clear()
    assert len(p) == 0 and p.hits == 0 and p.misses == 0
    assert store.POOL.max_entries is not None
    store.intern_dictionary(_dic(1000))
    store.intern_dictionary(_dic(1000))
    assert obs.metrics.snapshot()["store.pool"]["hits"] >= 1


# ----------------------------------------------------------------------
# .tfb v2 (and v1): byte-identical files, read across packages
# ----------------------------------------------------------------------
def _files(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("validity", [False, True])
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_v2_files_byte_identical_to_reference(tmp_path, name, validity):
    make, kw = DATASETS[name]
    data, mine, ref = _both(make, kw, validity)
    store.write_store(str(tmp_path / "port"), mine)
    j_store.write_store(str(tmp_path / "ref"), ref)
    a, b = _files(str(tmp_path / "port")), _files(str(tmp_path / "ref"))
    assert list(a) == list(b)
    for f in b:
        assert a[f] == b[f], f


@pytest.mark.parametrize("version", [1, 2])
def test_each_package_reads_the_others_files(tmp_path, version):
    data = _mixed_table()
    tio.write_tfb(str(tmp_path / "port"), data, version=version, chunk_rows=50)
    j_io.write_tfb(str(tmp_path / "ref"), data, version=version, chunk_rows=50)
    assert _files(str(tmp_path / "port")) == _files(str(tmp_path / "ref"))
    for reader, path in ((tio, "ref"), (j_io, "port")):
        got = reader.read_tfb_arrays(str(tmp_path / path))
        assert list(got) == list(data)
        for c, want in data.items():
            if want.dtype == object:
                assert list(got[c]) == list(want), (path, c)
            else:
                np.testing.assert_array_equal(got[c], want, err_msg=f"{path} {c}")
    # projection through both
    p = tio.read_tfb_arrays(str(tmp_path / "ref"), ["f", "i"])
    assert list(p) == ["f", "i"]
    np.testing.assert_array_equal(p["i"], data["i"])


def test_v2_round_trip_lazy(tmp_path):
    data = _mixed_table()
    path = str(tmp_path / "t")
    assert store.write_arrays(path, data, chunk_rows=64).nrows == 300
    t = store.open_store(path)
    assert not any(c.loaded for col in t.columns.values() for c in col.chunks)
    out = t.to_arrays()
    for name, want in data.items():
        if want.dtype == object:
            assert list(out[name]) == list(want)
        else:
            np.testing.assert_array_equal(out[name], want)
    _assert_same_table(t, j_store.Table.from_arrays(data, chunk_rows=64))


def test_v2_with_validity_round_trips_across_packages(tmp_path):
    data = _mixed_table()
    validity = _validity(data)
    store.write_arrays(str(tmp_path / "t"), data, chunk_rows=64, validity=validity)
    ref = j_store.open_store(str(tmp_path / "t"))
    _assert_same_table(store.open_store(str(tmp_path / "t")), ref)
    for name, v in validity.items():
        np.testing.assert_array_equal(ref.columns[name].validity(), v)


def test_v2_projection_only_touches_requested_columns(tmp_path):
    path = str(tmp_path / "t")
    store.write_arrays(path, _mixed_table(), chunk_rows=64)
    t = store.open_store(path)
    t.to_arrays(["i"])
    assert all(c.loaded for c in t.columns["i"].chunks)
    assert not any(c.loaded for c in t.columns["f"].chunks)
    assert t.columns["s"]._dictionary is None  # dictionary stays lazy


def test_unpruned_scan_uses_bulk_load(tmp_path):
    data = {"k": np.arange(1000), "v": np.arange(1000) * 0.5}
    path = str(tmp_path / "t")
    store.write_arrays(path, data, chunk_rows=64)
    t = store.open_store(path)
    r = store.scan(t, ["v"], [store.Pred("k", ">=", 0)])  # keeps all
    assert r.chunks_skipped == 0 and r.nrows == 1000
    assert all(c.loaded for c in t.columns["v"].chunks)
    np.testing.assert_allclose(r.columns["v"].values, data["v"])


def test_v1_and_v2_read_compat_through_io(tmp_path):
    data = _mixed_table()
    p1, p2 = str(tmp_path / "v1"), str(tmp_path / "v2")
    tio.write_tfb(p1, data, version=1)
    tio.write_tfb(p2, data, version=2, chunk_rows=50)
    a1, a2 = tio.read_tfb_arrays(p1), tio.read_tfb_arrays(p2)
    assert set(a1) == set(a2) == set(data)
    for name in data:
        if data[name].dtype == object:
            assert list(a1[name]) == list(a2[name])
        else:
            np.testing.assert_array_equal(a1[name], a2[name])
    cut = np.datetime64("1994-01-01", "D")
    f2 = tio.read_tfb(p2, ["f", "d"], [store.Pred("d", "<", cut)], device="cpu")
    assert f2.nrows == int((data["d"] < cut).sum())
    np.testing.assert_array_equal(f2.column("f"), data["f"][data["d"] < cut])
    with pytest.raises(ValueError):
        tio.read_tfb(p1, ["f"], [store.Pred("d", "<", cut)], device="cpu")
    with pytest.raises(ValueError):
        tio.write_tfb(str(tmp_path / "v3"), data, version=3)


def test_none_object_cells_stringify_like_v1(tmp_path):
    data = {"s": np.array(["a", None, "b"], dtype=object)}
    p1, p2 = str(tmp_path / "v1"), str(tmp_path / "v2")
    tio.write_tfb(p1, data, version=1)
    tio.write_tfb(p2, data, version=2)
    assert list(tio.read_tfb_arrays(p1)["s"]) == ["a", "None", "b"]
    assert list(tio.read_tfb_arrays(p2)["s"]) == ["a", "None", "b"]


# ----------------------------------------------------------------------
# TensorFrame.from_store against the reference's
# ----------------------------------------------------------------------
def _assert_same_frame(got, want):
    assert got.column_names == want.column_names
    assert list(got.columns) == list(want.columns)  # hidden __v__ columns too
    assert got.nrows == want.nrows
    for name in want.columns:
        ma, mb = got.meta(name), want.meta(name)
        assert ma.kind == mb.kind, name
        if mb.kind == "dict":
            _assert_same_array(ma.dictionary, mb.dictionary, name)
            np.testing.assert_array_equal(got.col_values(name).numpy(), np.asarray(want.col_values(name)))
    for name in want.column_names:
        a, b = got.column(name), np.asarray(want.column(name))
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert list(a) == list(b), name
    assert {k: (s.unique, s.distinct, s.vmin, s.vmax) for k, s in got._stats.items()} == {
        k: (s.unique, s.distinct, s.vmin, s.vmax) for k, s in want._stats.items()}


@pytest.mark.parametrize("validity", [False, True])
@pytest.mark.parametrize("preds", [[], [("i", "<", 500)], [("d", ">=", np.datetime64("1993-10-01"))]],
                         ids=["all", "i<500", "d>=oct"])
def test_from_store_matches_reference(preds, validity):
    data, mine, ref = _both(*DATASETS["mixed"], validity=validity)
    mine_k = store.Table.from_arrays({"key": np.arange(300) * 3, **data}, chunk_rows=64)
    ref_k = j_store.Table.from_arrays({"key": np.arange(300) * 3, **data}, chunk_rows=64)
    for t, r in ((mine, ref), (mine_k, ref_k)):
        got = TensorFrame.from_store(t, None, [store.Pred(*p) for p in preds], device="cpu")
        want = JFrame.from_store(r, None, [j_store.Pred(*p) for p in preds])
        assert got.device.type == "cpu"
        _assert_same_frame(got, want)


def test_from_store_keeps_the_interned_dictionary():
    data = {"k": np.array(list("xyzxyz"), dtype=object), "v": np.arange(6.0)}
    t = store.Table.from_arrays(data, chunk_rows=2)
    fa = TensorFrame.from_store(t, ["k", "v"], device="cpu")
    fb = TensorFrame.from_store(t, ["k"], device="cpu")
    assert fa.meta("k").dictionary is fb.meta("k").dictionary is t.columns["k"].dictionary
    assert fa.join(fb, on="k", how="semi").nrows == 6


def test_from_store_matches_from_arrays():
    rng = np.random.default_rng(3)
    n = 700
    data = {
        "i": rng.integers(-5, 5, n),
        "f": rng.uniform(-1, 1, n),
        "b": rng.integers(0, 2, n).astype(bool),
        "d": np.datetime64("1996-01-01", "D") + rng.integers(0, 90, n).astype("timedelta64[D]"),
        "s": np.array(["lo", "mid", "hi"], dtype=object)[rng.integers(0, 3, n)],
        "hc": np.array([f"row{i}" for i in range(n)], dtype=object),
    }
    got = TensorFrame.from_store(store.Table.from_arrays(data, chunk_rows=97), device="cpu")
    ref = TensorFrame.from_arrays(data, device="cpu")
    assert got.column_names == ref.column_names
    for name in ref.column_names:
        assert got.meta(name).kind == ref.meta(name).kind
        np.testing.assert_array_equal(got.column(name), ref.column(name))
    forced = TensorFrame.from_store(store.Table.from_arrays(data, chunk_rows=97),
                                    encode={"s": "obj", "hc": "dict"}, device="cpu")
    assert (forced.meta("s").kind, forced.meta("hc").kind) == ("obj", "dict")
    np.testing.assert_array_equal(forced.column("s"), data["s"])


def test_from_store_pushdown_equals_filter():
    rng = np.random.default_rng(4)
    n = 1500
    data = {"k": rng.integers(0, 100, n), "v": rng.uniform(0, 1, n)}
    t = store.Table.from_arrays(data, chunk_rows=128)
    got = TensorFrame.from_store(t, ["v"], [store.Pred("k", "<", 10)], device="cpu")
    np.testing.assert_array_equal(got.column("v"), data["v"][data["k"] < 10])
    empty = TensorFrame.from_store(t, ["v"], [store.Pred("k", "=", 10_000)], device="cpu")
    assert empty.nrows == 0 and empty.column("v").shape == (0,)


def test_from_store_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    import torch

    from repro_torch.core.config import CONFIG

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = store.Table.from_arrays({"k": np.arange(4)})
    assert CONFIG.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TensorFrame.from_store(t)


@pytest.mark.parametrize("how", ["inner", "semi"])
def test_store_frame_joins_move_the_reference_stats(how):
    """Zone-map uniqueness seeds the stats cache exactly as the
    reference's does, so ``join(algorithm="auto")`` answers from it the
    same number of times."""
    rng = np.random.default_rng(9)
    n, m = 900, 120
    fact = {"fk": rng.integers(0, m + 20, n), "x": rng.uniform(0, 1, n),
            "dup": rng.integers(0, 30, n)}
    dim = {"pk": np.arange(m), "w": rng.uniform(0, 1, m),
           "g": np.array(["p", "q", "r"], dtype=object)[rng.integers(0, 3, m)]}
    deltas = []
    for st, Frame, join_mod, kw in ((store, TensorFrame, t_join, {"device": "cpu"}),
                                    (j_store, JFrame, j_join, {})):
        f = Frame.from_store(st.Table.from_arrays(fact, chunk_rows=100), **kw)
        d = Frame.from_store(st.Table.from_arrays(dim, chunk_rows=50), **kw)
        dp = Frame.from_store(st.Table.from_arrays(dim, chunk_rows=50), None,
                              [st.Pred("pk", "<", 80)], **kw)
        join_mod.reset_stats()
        out = [
            f.join(d, left_on="fk", right_on="pk", how=how, algorithm="auto"),
            f.join(dp, left_on="fk", right_on="pk", how=how, algorithm="auto"),
            d.join(f, left_on="pk", right_on="dup", how=how, algorithm="auto"),
        ]
        deltas.append((dict(join_mod.STATS), [o.nrows for o in out]))
    assert deltas[0] == deltas[1]
    if how != "semi":
        assert deltas[0][0]["stats_unique_hits"] >= 2


# ----------------------------------------------------------------------
# the scan contract, fuzzed (needs the optional hypothesis package)
# ----------------------------------------------------------------------
def test_scan_equals_whole_array_filter_fuzzed():
    pytest.importorskip("hypothesis")
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    ops_ = ("=", "<>", "<", "<=", ">", ">=", "between", "in")

    @settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
    @given(
        data=st.lists(st.integers(-50, 50), min_size=0, max_size=300),
        chunk_rows=st.integers(1, 64),
        op=st.sampled_from(ops_),
        v=st.integers(-55, 55),
        w=st.integers(-55, 55),
        sort=st.booleans(),
    )
    def check(data, chunk_rows, op, v, w, sort):
        arr = np.array(sorted(data) if sort else data, dtype=np.int64)
        cols = {"x": arr, "row": np.arange(arr.shape[0])}
        t = store.Table.from_arrays(cols, chunk_rows=chunk_rows)
        value = (min(v, w), max(v, w)) if op == "between" else (v, w) if op == "in" else v
        ref = {
            "=": arr == v, "<>": arr != v, "<": arr < v, "<=": arr <= v, ">": arr > v,
            ">=": arr >= v, "between": (arr >= min(v, w)) & (arr <= max(v, w)),
            "in": np.isin(arr, [v, w]),
        }[op]
        r = _scan_both(t, j_store.Table.from_arrays(cols, chunk_rows=chunk_rows),
                       ["x", "row"], [("x", op, value)])
        np.testing.assert_array_equal(r.columns["x"].values, arr[ref])
        np.testing.assert_array_equal(r.columns["row"].values, np.arange(arr.shape[0])[ref])
        assert r.rows_scanned >= r.nrows  # pruning drops whole chunks only

    check()
