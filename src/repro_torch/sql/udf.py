"""Per-session scalar UDFs, lowered through ``torch.func.vmap``.

Python scalar functions are registered per session (framequery's
``add_function`` surface).  A registered function sees one *scalar*
per argument; the engine lowers a call over whole columns by
``torch.func.vmap``-ing it once and applying the vectorized function to
the evaluated argument tensors — so a UDF written as
``lambda price, disc: price * (1 - disc)`` runs as tensor operations
over the columns on their device, not a python loop.

Registration is scoped, not global: ``udf_scope(mapping)`` installs an
active registry for the duration of a query (a ``contextvars`` context
var, so concurrent sessions on different threads never see each other's
functions), and ``sql.lower.to_expr`` consults ``active_udfs()`` when
it meets a function name it doesn't know.  ``plan_uses_udf`` tells
whether a plan calls any of a set of registered names.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import threading
from typing import Callable, Mapping, Optional

import torch

from repro_torch.core.expr import Expr, Value, _combine_valid
from repro_torch.core.frame import INT, float_dtype

from .parser import SFunc, SqlError, transform

__all__ = [
    "Udf",
    "active_udfs",
    "plan_uses_udf",
    "udf_scope",
]

_KINDS = ("num", "bool")


class Udf:
    """A named scalar function: python scalars in, scalar out.

    ``returns`` declares the SQL-side kind of the result: ``"num"``
    (default) or ``"bool"`` (usable in WHERE).  The vmapped callable is
    built lazily on first use and cached, so registration itself never
    touches a device.
    """

    __slots__ = ("name", "fn", "returns", "_vfn", "calls")

    def __init__(self, name: str, fn: Callable, returns: str = "num"):
        if returns not in _KINDS:
            raise ValueError(
                f"UDF {name!r}: returns must be one of {_KINDS}, "
                f"not {returns!r}"
            )
        self.name = name.lower()
        self.fn = fn
        self.returns = returns
        self._vfn = None
        self.calls = 0  # column-level evaluations (not rows)

    def vectorized(self) -> Callable:
        if self._vfn is None:
            self._vfn = torch.func.vmap(self.fn)
        return self._vfn


_DEFAULT_DTYPE_LOCK = threading.Lock()

_ACTIVE: contextvars.ContextVar[Optional[Mapping[str, Udf]]] = (
    contextvars.ContextVar("repro_sql_udfs", default=None)
)


def active_udfs() -> Mapping[str, Udf]:
    """The UDF registry installed for the current context (or {})."""
    return _ACTIVE.get() or {}


@contextlib.contextmanager
def udf_scope(udfs: Mapping[str, Udf]):
    """Install ``udfs`` as the active registry for the enclosed query
    execution.  Context-local: safe under concurrent sessions."""
    token = _ACTIVE.set(dict(udfs))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


@dataclasses.dataclass(eq=False)
class UdfCall(Expr):
    """Core expression applying a vmapped UDF to evaluated columns."""

    udf: Udf
    args: tuple

    def eval(self, frame) -> Value:
        vals = [a.eval(frame) for a in self.args]
        arrs = []
        for v in vals:
            if v.kind == "str":
                raise SqlError(
                    f"UDF {self.udf.name!r} cannot take string arguments"
                )
            arrs.append(v.arr)
        self.udf.calls += 1
        # python float constants inside the function take the engine's
        # float dtype (torch would make ``0.01 * int_column`` float32);
        # the default dtype is process-wide, so calls take turns
        with _DEFAULT_DTYPE_LOCK:
            saved = torch.get_default_dtype()
            torch.set_default_dtype(float_dtype())
            try:
                out = self.udf.vectorized()(*arrs)
            finally:
                torch.set_default_dtype(saved)
        if self.udf.returns == "bool":
            out = out.to(torch.bool)
            return Value("bool", out, valid=_combine_valid(*[v.valid for v in vals]))
        if not out.dtype.is_floating_point:
            out = out.to(INT)
        else:
            out = out.to(float_dtype())
        return Value("num", out, valid=_combine_valid(*[v.valid for v in vals]))


def plan_uses_udf(plan, names) -> bool:
    """True when any expression in ``plan`` calls a function whose
    (lowercase) name is in ``names``.  Walks Boxed subplans too."""
    if not names:
        return False
    from .plan import AttachScalar, iter_plan_exprs

    hit = False

    def probe(e):
        nonlocal hit
        if isinstance(e, SFunc) and e.name in names:
            hit = True
        return e

    def roots(node):
        # iter_plan_exprs covers one plan tree but never crosses into
        # the Boxed subquery plans AttachScalar carries; surface those
        # as additional roots
        yield node
        stack = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, AttachScalar):
                yield n.sub.v
                stack.append(n.sub.v)
            for attr in ("child", "left", "right"):
                c = getattr(n, attr, None)
                if c is not None:
                    stack.append(c)

    for root in roots(plan):
        for e in iter_plan_exprs(root):
            transform(e, probe)
            if hit:
                return True
    return hit
