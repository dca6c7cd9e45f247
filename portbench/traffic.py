"""The one traffic generator: reads a workload file's parameter draws and
turns a seed into the stream of (query, parameters) a client sends.

A workload file (``workloads/<cell>.json``) lists each query by name
with its parameters, drawn per execution in the order given:

- ``{"int": [lo, hi]}``: a whole number, uniform, both ends included;
- ``{"day": [lo, hi]}``, ``{"month": ["YYYY-MM", "YYYY-MM"]}``,
  ``{"year": [lo, hi]}``: a date (the first of the month or year), as
  ``YYYY-MM-DD``;
- ``{"days_before": ["YYYY-MM-DD", name]}``, ``{"months_after": [name, k]}``:
  a date computed from a date and an earlier parameter;
- ``{"plus": [name, k]}``: an earlier whole number plus ``k``;
- ``{"hundredths": [name, k]}``: (an earlier whole number plus ``k``) / 100;
- ``{"per_sf": x}``: ``x`` divided by the configuration's scale factor.

One client in a closed loop sends the queries round after round, each
round a permutation of all of them drawn from the seed.
"""
from __future__ import annotations

import datetime as _dt
from typing import Dict, Iterator, Tuple

import numpy as np


def _date(s: str) -> _dt.date:
    return _dt.date.fromisoformat(s)


def _add_months(d: _dt.date, k: int) -> _dt.date:
    m = d.month - 1 + k
    return _dt.date(d.year + m // 12, m % 12 + 1, 1 if d.day == 1 else d.day)


def _rand_int(rng, lo: int, hi: int) -> int:
    return int(rng.integers(lo, hi + 1))


def draw(spec: Dict[str, dict], rng: np.random.Generator, sf: float) -> Dict[str, object]:
    """One execution's parameters from a query's spec."""
    out: Dict[str, object] = {}
    for name, rule in spec.items():
        (kind, arg), = rule.items()
        if kind == "int":
            out[name] = _rand_int(rng, *arg)
        elif kind == "day":
            lo, hi = _date(arg[0]), _date(arg[1])
            out[name] = (lo + _dt.timedelta(days=_rand_int(rng, 0, (hi - lo).days))).isoformat()
        elif kind == "month":
            lo, hi = _date(arg[0] + "-01"), _date(arg[1] + "-01")
            span = (hi.year - lo.year) * 12 + hi.month - lo.month
            out[name] = _add_months(lo, _rand_int(rng, 0, span)).isoformat()
        elif kind == "year":
            out[name] = f"{_rand_int(rng, *arg)}-01-01"
        elif kind == "days_before":
            out[name] = (_date(arg[0]) - _dt.timedelta(days=int(out[arg[1]]))).isoformat()
        elif kind == "months_after":
            out[name] = _add_months(_date(out[arg[0]]), int(arg[1])).isoformat()
        elif kind == "plus":
            out[name] = int(out[arg[0]]) + int(arg[1])
        elif kind == "hundredths":
            out[name] = (int(out[arg[0]]) + int(arg[1])) / 100
        elif kind == "per_sf":
            out[name] = float(arg) / sf
        else:
            raise ValueError(f"unknown parameter rule {kind!r} for {name}")
    return out


def stream(queries: Dict[str, dict], rng: np.random.Generator, sf: float
           ) -> Iterator[Tuple[str, Dict[str, object]]]:
    """Endless (query, parameters): round after round, each a permutation
    of every query, with fresh parameters for each execution."""
    names = list(queries)
    while True:
        for i in rng.permutation(len(names)):
            name = names[int(i)]
            yield name, draw(queries[name], rng, sf)


def render_sql(template: str, params: Dict[str, object]) -> str:
    """A SQL template with its ``{name}`` slots filled in."""
    return template.format(**{k: repr(v) if isinstance(v, float) else v
                              for k, v in params.items()})
