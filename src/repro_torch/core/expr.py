"""Trait-based stateless expression algebra (paper §IV-A, Fig. 4).

MojoFrame legalizes parallel UDF execution by forcing user filters to be
composed from a closed set of stateless, compiler-visible base
operations.  Here ``Expr`` is a pure combinator tree over
columns/literals; evaluation lowers to vectorized PyTorch ops on the
frame's device, and substring predicates to the substring kernel.
Statelessness is structural — there is no escape hatch into
row-at-a-time Python.

String predicates exploit cardinality-awareness twice: on
dictionary-encoded columns the predicate is evaluated over the (tiny)
dictionary and broadcast through a code-indexed LUT gather.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import encoding, strings
from .config import CONFIG
from .frame import INT, TensorFrame, float_dtype


# ----------------------------------------------------------------------
# evaluated values
# ----------------------------------------------------------------------
@dataclasses.dataclass
class Value:
    kind: str  # 'num' | 'bool' | 'str' | 'date'
    arr: torch.Tensor  # codes for 'str'
    dictionary: Optional[np.ndarray] = None
    valid: Optional[torch.Tensor] = None

    def as_num(self) -> "Value":
        if self.kind == "str":
            raise TypeError("string value used in numeric context")
        if self.kind in ("bool",):
            return Value("num", self.arr.to(INT), valid=self.valid)
        return self


def _combine_valid(*vals: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    present = [v for v in vals if v is not None]
    if not present:
        return None
    out = present[0]
    for v in present[1:]:
        out = out & v
    return out


# ----------------------------------------------------------------------
# helpers for date math
# ----------------------------------------------------------------------
def parse_date(s: str) -> int:
    """'YYYY-MM-DD' -> days since 1970-01-01."""
    return int(np.datetime64(s, "D").astype(np.int64))


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(days: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vectorized proleptic-Gregorian (y, m, d) from epoch days (floor
    division throughout, so days before 1970 decode too)."""
    z = days.to(INT) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524) - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    dd = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + 3 - 12 * (mp >= 10).to(INT)
    y = y + (m <= 2).to(INT)
    return y, m, dd


# ----------------------------------------------------------------------
# string predicate evaluation over a dictionary (host numpy)
# ----------------------------------------------------------------------
def _like_regex(pattern: str) -> "re.Pattern":
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("".join(out), flags=re.S)


def _host_exists_before(s: str, first: str, second: str) -> bool:
    i = s.find(first)
    if i < 0:
        return False
    return s.find(second, i + len(first)) >= 0


def _lut(values: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values), device=device)


# ----------------------------------------------------------------------
# Expr nodes
# ----------------------------------------------------------------------
class Expr:
    # -------- operators --------
    def __add__(self, o): return BinArith("add", self, wrap(o))
    def __radd__(self, o): return BinArith("add", wrap(o), self)
    def __sub__(self, o): return BinArith("sub", self, wrap(o))
    def __rsub__(self, o): return BinArith("sub", wrap(o), self)
    def __mul__(self, o): return BinArith("mul", self, wrap(o))
    def __rmul__(self, o): return BinArith("mul", wrap(o), self)
    def __truediv__(self, o): return BinArith("div", self, wrap(o))
    def __rtruediv__(self, o): return BinArith("div", wrap(o), self)
    def __eq__(self, o): return Cmp("eq", self, wrap(o))  # type: ignore[override]
    def __ne__(self, o): return Cmp("ne", self, wrap(o))  # type: ignore[override]
    def __lt__(self, o): return Cmp("lt", self, wrap(o))
    def __le__(self, o): return Cmp("le", self, wrap(o))
    def __gt__(self, o): return Cmp("gt", self, wrap(o))
    def __ge__(self, o): return Cmp("ge", self, wrap(o))
    def __and__(self, o): return BoolOp("and", self, wrap(o))
    def __or__(self, o): return BoolOp("or", self, wrap(o))
    def __invert__(self): return Not(self)
    def __hash__(self):  # Expr overrides __eq__; keep hashable by identity
        return id(self)

    def isin(self, values: Sequence) -> "Expr": return IsIn(self, list(values))
    def between(self, lo, hi) -> "Expr": return BoolOp("and", Cmp("ge", self, wrap(lo)), Cmp("le", self, wrap(hi)))
    def fillna(self, v) -> "Expr": return FillNa(self, wrap(v))
    def is_null(self) -> "Expr": return IsNull(self)
    def cast_float(self) -> "Expr": return Cast(self, "float")
    def cast_int(self) -> "Expr": return Cast(self, "int")

    # math traits
    def sin(self): return MathFn("sin", self)
    def cos(self): return MathFn("cos", self)
    def exp(self): return MathFn("exp", self)
    def log(self): return MathFn("log", self)
    def sqrt(self): return MathFn("sqrt", self)
    def abs(self): return MathFn("abs", self)
    def floor(self): return MathFn("floor", self)

    # string traits
    @property
    def str(self) -> "StrNamespace": return StrNamespace(self)
    # date traits
    @property
    def dt(self) -> "DtNamespace": return DtNamespace(self)

    # -------- evaluation --------
    def eval(self, frame: TensorFrame) -> Value:
        raise NotImplementedError

    def eval_bool(self, frame: TensorFrame) -> torch.Tensor:
        v = self.eval(frame)
        if v.kind != "bool":
            raise TypeError(f"filter expression is {v.kind}, not bool")
        arr = v.arr
        if v.valid is not None:
            arr = arr & v.valid  # SQL: NULL comparisons are not-true
        return arr


def wrap(x) -> Expr:
    return x if isinstance(x, Expr) else Lit(x)


@dataclasses.dataclass(eq=False)
class Col(Expr):
    name: str

    def eval(self, frame: TensorFrame) -> Value:
        # view-aware single-column access: a lazy (RowView) frame
        # gathers just this column, not the whole payload
        m = frame.meta(self.name)
        valid = frame.valid_array(self.name)
        if m.kind == "float":
            return Value("num", frame.col_values(self.name), valid=valid)
        if m.kind == "dict":
            return Value("str", frame.col_values(self.name), m.dictionary, valid)
        if m.kind == "obj":
            codes, dictionary = frame.offloaded[self.name].codes()
            return Value("str", codes, dictionary, valid)
        arr = frame.col_values(self.name)
        if m.kind == "date":
            return Value("date", arr, valid=valid)
        if m.kind == "bool":
            return Value("bool", arr != 0, valid=valid)
        return Value("num", arr, valid=valid)


@dataclasses.dataclass(eq=False)
class Lit(Expr):
    value: Any

    def eval(self, frame: TensorFrame) -> Value:
        v = self.value
        n, dev = frame.nrows, frame.device
        if isinstance(v, bool):
            return Value("bool", torch.full((n,), v, dtype=torch.bool, device=dev))
        if isinstance(v, (int, np.integer)):
            return Value("num", torch.full((n,), int(v), dtype=INT, device=dev))
        if isinstance(v, (float, np.floating)):
            return Value("num", torch.full((n,), float(v), dtype=float_dtype(), device=dev))
        if isinstance(v, str):
            # scalar string literal: single-entry dictionary, code 0
            return Value(
                "str", torch.zeros((n,), dtype=INT, device=dev), np.array([v], dtype=object)
            )
        if isinstance(v, (np.datetime64,)):
            days = int(v.astype("datetime64[D]").astype(np.int64))
            return Value("date", torch.full((n,), days, dtype=INT, device=dev))
        raise TypeError(f"unsupported literal {type(v)}")


@dataclasses.dataclass(eq=False)
class DateLit(Expr):
    days: int

    def eval(self, frame: TensorFrame) -> Value:
        return Value(
            "date", torch.full((frame.nrows,), self.days, dtype=INT, device=frame.device)
        )


def d(s: str) -> DateLit:
    """Date literal: d('1994-01-01')."""
    return DateLit(parse_date(s))


_ARITH = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
}


@dataclasses.dataclass(eq=False)
class BinArith(Expr):
    op: str
    a: Expr
    b: Expr

    def eval(self, frame: TensorFrame) -> Value:
        va, vb = self.a.eval(frame), self.b.eval(frame)
        valid = _combine_valid(va.valid, vb.valid)
        # date +/- int days stays a date
        if va.kind == "date" and vb.kind == "num" and self.op in ("add", "sub"):
            return Value("date", _ARITH[self.op](va.arr, vb.arr.to(INT)), valid=valid)
        if va.kind == "date" and vb.kind == "date" and self.op == "sub":
            return Value("num", va.arr - vb.arr, valid=valid)
        a, b = va.as_num().arr, vb.as_num().arr
        if self.op == "div":
            fd = float_dtype()
            return Value("num", a.to(fd) / b.to(fd), valid=valid)
        return Value("num", _ARITH[self.op](a, b), valid=valid)


_CMPS = {
    "eq": torch.eq,
    "ne": torch.ne,
    "lt": torch.lt,
    "le": torch.le,
    "gt": torch.gt,
    "ge": torch.ge,
}


@dataclasses.dataclass(eq=False)
class Cmp(Expr):
    op: str
    a: Expr
    b: Expr

    def eval(self, frame: TensorFrame) -> Value:
        va, vb = self.a.eval(frame), self.b.eval(frame)
        valid = _combine_valid(va.valid, vb.valid)
        if va.kind == "str" or vb.kind == "str":
            return self._eval_str(va, vb, valid)
        a = va.as_num().arr if va.kind != "date" else va.arr
        b = vb.as_num().arr if vb.kind != "date" else vb.arr
        return Value("bool", _CMPS[self.op](a, b), valid=valid)

    def _eval_str(self, va: Value, vb: Value, valid) -> Value:
        if va.kind != "str" or vb.kind != "str":
            raise TypeError("comparison between string and non-string")
        # scalar-literal fast path: dictionary of size 1 from Lit
        if vb.dictionary is not None and vb.dictionary.shape[0] == 1 and isinstance(self.b, Lit):
            return Value("bool", self._codes_vs_literal(va, str(vb.dictionary[0])), valid=valid)
        if va.dictionary is not None and va.dictionary.shape[0] == 1 and isinstance(self.a, Lit):
            flipped = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}.get(self.op, self.op)
            return Value("bool", Cmp(flipped, self.b, self.a)._codes_vs_literal(vb, str(va.dictionary[0])), valid=valid)
        # column vs column: shared factorization then code compare
        if va.dictionary is vb.dictionary:
            ca, cb = va.arr, vb.arr
        else:
            _, ra, rb = encoding.merge_dictionaries(va.dictionary, vb.dictionary)
            ca = _lut(ra, va.arr.device)[va.arr]
            cb = _lut(rb, vb.arr.device)[vb.arr]
        return Value("bool", _CMPS[self.op](ca, cb), valid=valid)

    def _codes_vs_literal(self, v: Value, lit: str) -> torch.Tensor:
        dic = v.dictionary
        codes = v.arr
        left = int(np.searchsorted(dic.astype("U"), lit, side="left"))
        right = int(np.searchsorted(dic.astype("U"), lit, side="right"))
        present = right > left
        if self.op == "eq":
            return (codes == left) if present else torch.zeros_like(codes, dtype=torch.bool)
        if self.op == "ne":
            return (codes != left) if present else torch.ones_like(codes, dtype=torch.bool)
        if self.op == "lt":
            return codes < left
        if self.op == "le":
            return codes < right
        if self.op == "gt":
            return codes >= right
        if self.op == "ge":
            return codes >= left
        raise ValueError(self.op)


@dataclasses.dataclass(eq=False)
class BoolOp(Expr):
    op: str
    a: Expr
    b: Expr

    def eval(self, frame: TensorFrame) -> Value:
        va, vb = self.a.eval(frame), self.b.eval(frame)
        if va.kind != "bool" or vb.kind != "bool":
            raise TypeError("boolean op on non-boolean")
        # fold null as False before combining (NULL predicates are
        # not-true)
        a = va.arr if va.valid is None else (va.arr & va.valid)
        b = vb.arr if vb.valid is None else (vb.arr & vb.valid)
        out = (a & b) if self.op == "and" else (a | b)
        return Value("bool", out)


@dataclasses.dataclass(eq=False)
class Not(Expr):
    a: Expr

    def eval(self, frame: TensorFrame) -> Value:
        v = self.a.eval(frame)
        if v.kind != "bool":
            raise TypeError("~ on non-boolean")
        arr = v.arr if v.valid is None else (v.arr & v.valid)
        out = ~arr
        if v.valid is not None:
            out = out & v.valid  # NOT NULL is still NULL -> not-true
        return Value("bool", out)


@dataclasses.dataclass(eq=False)
class IsIn(Expr):
    a: Expr
    values: List[Any]

    def eval(self, frame: TensorFrame) -> Value:
        v = self.a.eval(frame)
        if v.kind == "str":
            lut = np.isin(v.dictionary.astype("U"), np.asarray(self.values, dtype="U"))
            return Value("bool", _lut(lut, v.arr.device)[v.arr], valid=v.valid)
        arr = v.as_num().arr if v.kind != "date" else v.arr
        vals = [parse_date(x) if isinstance(x, str) and v.kind == "date" else x for x in self.values]
        out = torch.zeros(arr.shape, dtype=torch.bool, device=arr.device)
        for x in vals:
            out = out | (arr == x)
        return Value("bool", out, valid=v.valid)


_MATH = {
    "sin": torch.sin, "cos": torch.cos, "exp": torch.exp, "log": torch.log,
    "sqrt": torch.sqrt, "abs": torch.abs, "floor": torch.floor,
}


@dataclasses.dataclass(eq=False)
class MathFn(Expr):
    fn: str
    a: Expr

    def eval(self, frame: TensorFrame) -> Value:
        v = self.a.eval(frame).as_num()
        return Value("num", _MATH[self.fn](v.arr.to(float_dtype())), valid=v.valid)


@dataclasses.dataclass(eq=False)
class IfElse(Expr):
    cond: Expr
    t: Expr
    f: Expr

    def eval(self, frame: TensorFrame) -> Value:
        c = self.cond.eval(frame)
        vt = self.t.eval(frame)
        vf = self.f.eval(frame)
        carr = c.arr if c.valid is None else (c.arr & c.valid)
        if vt.kind == "str" or vf.kind == "str":
            raise TypeError("if_else on strings not supported")
        fd = float_dtype()
        ta, fa = vt.as_num().arr, vf.as_num().arr
        if ta.dtype != fa.dtype:
            ta, fa = ta.to(fd), fa.to(fd)
        return Value("num", torch.where(carr, ta, fa),
                     valid=_combine_valid(vt.valid, vf.valid))


def if_else(cond, t, f) -> Expr:
    return IfElse(wrap(cond), wrap(t), wrap(f))


@dataclasses.dataclass(eq=False)
class Cast(Expr):
    a: Expr
    to: str

    def eval(self, frame: TensorFrame) -> Value:
        v = self.a.eval(frame).as_num()
        if self.to == "float":
            return Value("num", v.arr.to(float_dtype()), valid=v.valid)
        return Value("num", v.arr.to(INT), valid=v.valid)


@dataclasses.dataclass(eq=False)
class FillNa(Expr):
    a: Expr
    v: Expr

    def eval(self, frame: TensorFrame) -> Value:
        va = self.a.eval(frame)
        if va.valid is None:
            return va
        vb = self.v.eval(frame).as_num()
        a = va.as_num().arr
        arr = torch.where(va.valid, a, vb.arr.to(a.dtype))
        return Value(va.kind if va.kind != "bool" else "num", arr)


@dataclasses.dataclass(eq=False)
class IsNull(Expr):
    a: Expr

    def eval(self, frame: TensorFrame) -> Value:
        v = self.a.eval(frame)
        if v.valid is None:
            # no validity companion: float NaN cells are the nulls
            if v.kind == "num" and v.arr.is_floating_point():
                return Value("bool", torch.isnan(v.arr))
            return Value(
                "bool", torch.zeros((frame.nrows,), dtype=torch.bool, device=frame.device)
            )
        return Value("bool", ~v.valid)


@dataclasses.dataclass(eq=False)
class Udf(Expr):
    """Stateless numeric UDF: a pure function of one row's values,
    lowered over the columns with ``torch.func.vmap``.

    The 'trait' contract of the paper: the function sees only its row's
    inputs — no cross-row state is expressible.
    """

    fn: Callable
    args: Tuple[Expr, ...]
    returns: str = "num"  # or 'bool'

    def eval(self, frame: TensorFrame) -> Value:
        vals = [a.eval(frame) for a in self.args]
        arrs = [v.as_num().arr if v.kind != "date" else v.arr for v in vals]
        out = torch.func.vmap(self.fn)(*arrs)
        return Value(self.returns, out, valid=_combine_valid(*[v.valid for v in vals]))


def udf(fn: Callable, *args, returns: str = "num") -> Expr:
    return Udf(fn, tuple(wrap(a) for a in args), returns)


# ----------------------------------------------------------------------
# string namespace
# ----------------------------------------------------------------------
#: packed-byte string predicates (the substring kernel's callers)
_PACKED_FNS = {
    "contains": strings.contains,
    "startswith": strings.startswith,
    "endswith": strings.endswith,
    "like": strings.like,
    "exists_before": strings.exists_before,
}


@dataclasses.dataclass(eq=False)
class StrOp(Expr):
    op: str
    a: Expr
    args: Tuple[Any, ...]

    def _device_path(self, frame: TensorFrame) -> Optional[torch.Tensor]:
        """Packed-byte path over the physical rows of an offloaded
        column (under ``CONFIG.use_device_strings``)."""
        if not CONFIG.use_device_strings or not isinstance(self.a, Col):
            return None
        m = frame.meta(self.a.name)
        if m.kind != "obj" or self.op not in _PACKED_FNS:
            return None
        oc = frame.offloaded[self.a.name]
        packed, lens = oc.packed()
        phys = _PACKED_FNS[self.op](packed, lens, *self.args)
        return phys[oc.idx]

    # dictionaries at least this large evaluate the predicate on their
    # packed byte tensor instead of a Python loop (high-card columns)
    _PACK_THRESHOLD = 2048

    def _packed_dict_lut(self, dic: np.ndarray, device: torch.device) -> Optional[torch.Tensor]:
        """Evaluate the predicate over the dictionary via the packed
        byte-tensor path — the cardinality-aware fast path for large
        dictionaries.  A kernel failure raises: there is no host
        fallback to hide it."""
        if self.op not in _PACKED_FNS or dic.shape[0] < self._PACK_THRESHOLD:
            return None
        packed, lens = strings.pack_strings_cached(dic, CONFIG.max_packed_len, device)
        return _PACKED_FNS[self.op](packed, lens, *self.args)

    def eval(self, frame: TensorFrame) -> Value:
        dev = self._device_path(frame)
        if dev is not None:
            return Value("bool", dev)
        v = self.a.eval(frame)
        if v.kind != "str":
            raise TypeError(f"string op {self.op} on {v.kind}")
        dic = v.dictionary
        plut = self._packed_dict_lut(dic, v.arr.device)
        if plut is not None:
            return Value("bool", plut[v.arr], valid=v.valid)
        as_u = dic.astype("U")
        if self.op == "contains":
            lut = np.char.find(as_u, self.args[0]) >= 0
        elif self.op == "startswith":
            lut = np.char.startswith(as_u, self.args[0])
        elif self.op == "endswith":
            lut = np.char.endswith(as_u, self.args[0])
        elif self.op == "like":
            rx = _like_regex(self.args[0])
            lut = np.array([bool(rx.fullmatch(s)) for s in as_u], dtype=bool)
        elif self.op == "exists_before":
            first, second = self.args
            lut = np.array([_host_exists_before(s, first, second) for s in as_u], dtype=bool)
        elif self.op == "slice":
            start, stop = self.args
            sliced = np.array([s[start:stop] for s in as_u], dtype=object)
            new_dic, remap = np.unique(sliced, return_inverse=True)
            codes = _lut(remap.astype(np.int64), v.arr.device)[v.arr]
            return Value("str", codes, new_dic, v.valid)
        elif self.op == "len":
            lens = np.array([len(s) for s in as_u], dtype=np.int64)
            return Value("num", _lut(lens, v.arr.device)[v.arr], valid=v.valid)
        else:
            raise ValueError(self.op)
        return Value("bool", _lut(lut, v.arr.device)[v.arr], valid=v.valid)


class StrNamespace:
    def __init__(self, e: Expr):
        self._e = e

    def contains(self, pat: str) -> Expr: return StrOp("contains", self._e, (pat,))
    def startswith(self, pat: str) -> Expr: return StrOp("startswith", self._e, (pat,))
    def endswith(self, pat: str) -> Expr: return StrOp("endswith", self._e, (pat,))
    def like(self, pattern: str) -> Expr: return StrOp("like", self._e, (pattern,))
    def exists_before(self, first: str, second: str) -> Expr:
        return StrOp("exists_before", self._e, (first, second))
    def not_exists_before(self, first: str, second: str) -> Expr:
        """The paper's not_string_exists_before (Q13/Q16 UDF)."""
        return Not(StrOp("exists_before", self._e, (first, second)))
    def slice(self, start: int, stop: int) -> Expr: return StrOp("slice", self._e, (start, stop))
    def len(self) -> Expr: return StrOp("len", self._e, ())


class DtNamespace:
    def __init__(self, e: Expr):
        self._e = e

    def year(self) -> Expr: return DateField("year", self._e)
    def month(self) -> Expr: return DateField("month", self._e)
    def day(self) -> Expr: return DateField("day", self._e)


@dataclasses.dataclass(eq=False)
class DateField(Expr):
    field: str
    a: Expr

    def eval(self, frame: TensorFrame) -> Value:
        v = self.a.eval(frame)
        if v.kind != "date":
            raise TypeError("dt accessor on non-date")
        y, m, dd = civil_from_days(v.arr)
        out = {"year": y, "month": m, "day": dd}[self.field]
        return Value("num", out, valid=v.valid)


def col(name: str) -> Col:
    return Col(name)


def lit(v) -> Lit:
    return Lit(v)
