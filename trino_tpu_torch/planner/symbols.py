"""Plan symbols: named, typed columns flowing between plan nodes.

Reference analog: ``sql/planner/Symbol.java`` + ``SymbolAllocator.java``.
Plan-level expressions are the same RowExpression IR the compiler executes
(``expr/ir.py``), except column references are ``SymbolRef``s; the local
execution planner rewrites them to channel-based ``InputRef``s once the
physical layout of each pipeline is fixed (reference analog: the
symbol→channel translation inside ``LocalExecutionPlanner.java``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Set

from .. import types as T
from ..expr.ir import Call, InputRef, Literal, RowExpression


@dataclass(frozen=True)
class Symbol:
    name: str
    type: T.Type

    def ref(self) -> "SymbolRef":
        return SymbolRef(self.type, self.name)

    def __repr__(self):
        return f"{self.name}:{self.type}"


@dataclass(frozen=True)
class SymbolRef(RowExpression):
    """Reference to a plan symbol (pre-physical-layout InputRef)."""

    name: str = ""

    def __repr__(self):
        return f"${self.name}"


class SymbolAllocator:
    """Unique symbol names per query plan."""

    def __init__(self):
        self._names: Set[str] = set()

    def new_symbol(self, hint: str, type_: T.Type) -> Symbol:
        base = _clean(hint)
        name = base
        i = 0
        while name in self._names:
            i += 1
            name = f"{base}_{i}"
        self._names.add(name)
        return Symbol(name, type_)


def _clean(hint: str) -> str:
    out = "".join(ch if (ch.isalnum() or ch == "_") else "_"
                  for ch in hint.lower())
    return out[:24] or "expr"


def referenced_symbols(expr: RowExpression) -> Set[str]:
    out: Set[str] = set()

    def walk(e):
        if isinstance(e, SymbolRef):
            out.add(e.name)
        elif isinstance(e, Call):
            for a in e.args:
                walk(a)

    walk(expr)
    return out


def rewrite_symbols(expr: RowExpression,
                    mapping: Dict[str, RowExpression]) -> RowExpression:
    """Replace SymbolRefs by name (used for projection inlining)."""
    if isinstance(expr, SymbolRef):
        return mapping.get(expr.name, expr)
    if isinstance(expr, Call):
        args = tuple(rewrite_symbols(a, mapping) for a in expr.args)
        if args == expr.args:
            return expr
        return Call(expr.type, expr.name, args)
    return expr


def to_input_refs(expr: RowExpression,
                  layout: Dict[str, int]) -> RowExpression:
    """SymbolRef → channel InputRef for a fixed physical layout."""
    if isinstance(expr, SymbolRef):
        return InputRef(expr.type, layout[expr.name])
    if isinstance(expr, Call):
        return Call(expr.type, expr.name,
                    tuple(to_input_refs(a, layout) for a in expr.args))
    return expr
