"""Row-expression IR — the typed expression language operators execute.

Reference analog: ``io.trino.sql.relational.RowExpression`` hierarchy
(CallExpression, SpecialForm, InputReferenceExpression, ConstantExpression)
that the reference's bytecode compiler consumes (``sql/gen/``); here the
consumer is the JAX tracer in ``expr/compiler.py``.

Special forms are Calls with ``$``-prefixed names: ``$and $or $not $if
$case $coalesce $in $between $is_null $cast $like`` — they need non-default
null semantics or laziness, everything else is a registry function with
RETURN_NULL_ON_NULL convention.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

from .. import types as T


@dataclass(frozen=True)
class RowExpression:
    type: T.Type


@dataclass(frozen=True)
class InputRef(RowExpression):
    """Reference to input channel (column index) of the page."""

    channel: int = 0

    def __repr__(self):
        return f"#{self.channel}:{self.type}"


@dataclass(frozen=True)
class Literal(RowExpression):
    value: Any = None  # python value; None = typed NULL

    def __repr__(self):
        return f"lit({self.value!r}:{self.type})"


@dataclass(frozen=True)
class ParamRef(RowExpression):
    """Opaque plan-template parameter: the i-th cache-marked literal of a
    normalized statement shape (``cache.normalize_statement``).

    Deliberately NOT a ``Literal`` subclass — every plan-time constant
    reader (constant folding, domain translation, rank bounds) is
    ``isinstance(_, Literal)``-gated, so a ParamRef is opaque by
    construction: one optimized plan serves every literal vector of the
    shape.  The compiler binds it to a traced input slot instead of a
    baked constant, which is what lets a same-shape batch ``vmap`` over
    the stacked literal axis.
    """

    index: int = 0

    def __repr__(self):
        return f"param({self.index}):{self.type}"


@dataclass(frozen=True)
class Call(RowExpression):
    name: str = ""
    args: Tuple[RowExpression, ...] = ()

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.args))})"


def input_channels(expr: RowExpression) -> set:
    """All input channels referenced by an expression tree."""
    out = set()

    def walk(e):
        if isinstance(e, InputRef):
            out.add(e.channel)
        elif isinstance(e, Call):
            for a in e.args:
                walk(a)

    walk(expr)
    return out


def param_indices(expr: RowExpression) -> set:
    """All template-parameter indices referenced by an expression tree."""
    out = set()

    def walk(e):
        if isinstance(e, ParamRef):
            out.add(e.index)
        elif isinstance(e, Call):
            for a in e.args:
                walk(a)

    walk(expr)
    return out
