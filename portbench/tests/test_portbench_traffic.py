"""The parameter draws stay within the specification's ranges and repeat
for a seed."""
import datetime as dt
import json
from pathlib import Path

import numpy as np
import pytest

from portbench import traffic

WL = Path(__file__).resolve().parents[1] / "workloads"
TPCH = json.loads((WL / "tpch-sf1.compiled.json").read_text())["queries"]


def draws(queries, seed, n=600, sf=1.0):
    s = traffic.stream(queries, np.random.default_rng([seed, 2]), sf)
    return [next(s) for _ in range(n)]


def d(s):
    return dt.date.fromisoformat(s)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 2 ** 40 + 3])
def test_draws_repeat_for_a_seed(seed):
    assert draws(TPCH, seed) == draws(TPCH, seed)
    assert draws(TPCH, seed) != draws(TPCH, seed + 1)


def test_each_round_is_a_permutation():
    got = [q for q, _ in draws(TPCH, 5, n=22 * 10)]
    for r in range(10):
        assert sorted(got[22 * r:22 * (r + 1)]) == sorted(TPCH)


def test_tpch_draws_within_clause_2_4():
    for q, p in draws(TPCH, 3, n=22 * 60):
        if q == "q1":
            assert 60 <= p["delta"] <= 120
            assert d(p["date"]) == d("1998-12-01") - dt.timedelta(days=p["delta"])
        elif q == "q2":
            assert 1 <= p["size"] <= 50
        elif q == "q3":
            assert d("1995-03-01") <= d(p["date"]) <= d("1995-03-31")
        elif q in ("q4", "q15"):
            assert d("1993-01-01") <= d(p["date"]) <= d("1997-10-01") and d(p["date"]).day == 1
        elif q == "q10":
            assert d("1993-02-01") <= d(p["date"]) <= d("1995-01-01") and d(p["date"]).day == 1
        elif q == "q14":
            assert d("1993-01-01") <= d(p["date"]) <= d("1997-12-01") and d(p["date"]).day == 1
        elif q in ("q5", "q6", "q12", "q20"):
            assert p["date"][5:] == "01-01" and 1993 <= int(p["date"][:4]) <= 1997
            assert int(p["date_end"][:4]) == int(p["date"][:4]) + 1
        if q == "q6":
            assert 2 <= p["discount"] <= 9 and p["quantity"] in (24, 25)
            assert p["discount_lo"] == (p["discount"] - 1) / 100
            assert p["discount_hi"] == (p["discount"] + 1) / 100
        if q == "q18":
            assert 312 <= p["quantity"] <= 315
        if q == "q19":
            assert 1 <= p["quantity1"] <= 10 and 10 <= p["quantity2"] <= 20
            assert 20 <= p["quantity3"] <= 30
            for i in (1, 2, 3):
                assert p[f"quantity{i}_hi"] == p[f"quantity{i}"] + 10
        if q in ("q4", "q10", "q15"):
            a, b = d(p["date"]), d(p["date_end"])
            assert (b.year - a.year) * 12 + b.month - a.month == 3
        if q == "q11":
            assert p["fraction"] == 0.0001
        if q in ("q7", "q8", "q9", "q13", "q16", "q17", "q21", "q22"):
            assert p == {}


def test_sql_rendering_fills_every_slot():
    import tomllib

    with open(Path(__file__).resolve().parents[1] / "queries" / "tpch.toml", "rb") as f:
        t = tomllib.load(f)
    for q, p in draws(TPCH, 9, n=22):
        text = traffic.render_sql(t[q]["sql"], p)
        assert "{" not in text and "}" not in text
