"""Expression -> TupleDomain extraction.

Reference analog: ``sql/planner/DomainTranslator.java`` (fromPredicate /
ExtractionResult). Conjuncts of the canonical comparison forms translate
EXACTLY into per-symbol Domains (SQL comparisons exclude NULL, so
extracted domains have null_allowed=False); anything else stays
residual. Because extraction is exact, a translated conjunct can be
DROPPED once a connector enforces its domain.

Value spaces: domains are expressed in the COLUMN's raw representation
(scaled ints for decimals, day numbers for dates, micros for
timestamps, str for varchar/char). Coercion casts around either side
are unwound with exact rational arithmetic — a bound like
``cast(l_quantity as decimal(13,2)) < 24.5`` integerizes to
``raw <= 2449`` — so no rounding ever widens a domain.
"""

from __future__ import annotations

import math
from decimal import Decimal
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

from .. import types as T
from ..expr.ir import Call, Literal, RowExpression
from ..predicate import Domain, Range, ValueSet
from .symbols import SymbolRef

_CMP = {"eq", "ne", "lt", "le", "gt", "ge"}
_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
         "eq": "eq", "ne": "ne"}


def _unwrap_ref(expr) -> Optional[SymbolRef]:
    """The underlying SymbolRef when ``expr`` is a bare ref or a
    VALUE-PRESERVING numeric coercion cast of one (int/decimal/date
    widening; float targets excluded — double rounding would make the
    bound inexact)."""
    if isinstance(expr, SymbolRef):
        return expr
    if isinstance(expr, Call) and expr.name == "$cast" \
            and len(expr.args) == 1 \
            and isinstance(expr.args[0], SymbolRef):
        src_t = expr.args[0].type
        dst_t = expr.type
        if _numeric_scale(src_t) is None or _numeric_scale(dst_t) is None:
            return None
        if _numeric_scale(dst_t) < _numeric_scale(src_t):
            return None  # narrowing rounds: not value-preserving
        return expr.args[0]
    return None


def _numeric_scale(t: T.Type) -> Optional[int]:
    """Decimal scale for the exact-integer value family; None for types
    outside it (floats, strings, booleans, pooled composites)."""
    if t.is_decimal:
        return t.scale or 0
    if t in (T.BIGINT, T.INTEGER, T.SMALLINT, T.TINYINT, T.DATE,
             T.TIMESTAMP) or t.is_timestamp_tz:
        return 0
    return None


def _true_literal(expr) -> Optional[Literal]:
    """The underlying Literal beneath coercion casts, unwrapped ONLY
    when each cast layer is exactly value-preserving — the compiled
    kernel applies the cast to the literal (truncating/rounding per
    cast semantics), so a cast that changes the value must stay
    residual (e.g. ``cast(-2.6 as bigint)``)."""
    while isinstance(expr, Call) and expr.name == "$cast" \
            and len(expr.args) == 1:
        inner = expr.args[0]
        lit = inner if isinstance(inner, Literal) else None
        if lit is None and isinstance(inner, Call):
            lit = _true_literal(inner)
        if lit is None:
            return None
        dst = expr.type
        v = lit.value
        if v is None:
            return Literal(dst, None)
        if dst.is_string:
            if not isinstance(v, str):
                return None
        else:
            s = _numeric_scale(dst)
            if s is None:
                return None  # float/other targets may round
            x = _rational(lit)
            if x is None or (x * 10 ** s).denominator != 1:
                return None  # the cast would round: not value-preserving
        expr = lit
    return expr if isinstance(expr, Literal) else None


def _rational(lit: Literal) -> Optional[Fraction]:
    """The literal's SEMANTIC value as an exact rational. Matches the
    compiler's convention (_literal_raw): int values of scale-0 types
    are their raw units (days, micros, counts); int OR Decimal values
    of decimal types are semantic (the compiler applies to_raw)."""
    v = lit.value
    if isinstance(v, bool) or v is None:
        return None
    if isinstance(v, int):
        if _numeric_scale(lit.type) is None:
            return None
        return Fraction(v)
    if isinstance(v, Decimal):
        return Fraction(v)
    return None


def _range_domain(op: str, x: Fraction, scale: int) -> Domain:
    """Exact integerized domain for ``raw OP x*10^scale`` over the
    column's integer raw space."""
    b = x * (10 ** scale)
    if op == "eq":
        if b.denominator == 1:
            return Domain.single(int(b))
        return Domain.none()
    if op == "ne":
        if b.denominator == 1:
            return Domain(ValueSet.of(int(b)).complement(), False)
        return Domain.not_null()
    if op == "le":
        hi = math.floor(b)
        return Domain(ValueSet.of_ranges(Range(None, False, hi, True)),
                      False)
    if op == "lt":
        hi = int(b) - 1 if b.denominator == 1 else math.floor(b)
        return Domain(ValueSet.of_ranges(Range(None, False, hi, True)),
                      False)
    if op == "ge":
        lo = math.ceil(b)
        return Domain(ValueSet.of_ranges(Range(lo, True, None, False)),
                      False)
    # gt
    lo = int(b) + 1 if b.denominator == 1 else math.ceil(b)
    return Domain(ValueSet.of_ranges(Range(lo, True, None, False)), False)


def _float_domain(op: str, v: float) -> Optional[Domain]:
    if math.isnan(v):
        return None  # NaN comparisons don't translate to ranges
    if op == "eq":
        return Domain.single(v)
    if op == "ne":
        # the compiled kernel's IEEE not_equal KEEPS NaN rows, but a
        # complement range set excludes them — not expressible exactly
        return None
    if op == "lt":
        return Domain(ValueSet.of_ranges(Range(None, False, v, False)),
                      False)
    if op == "le":
        return Domain(ValueSet.of_ranges(Range(None, False, v, True)),
                      False)
    if op == "gt":
        return Domain(ValueSet.of_ranges(Range(v, False, None, False)),
                      False)
    return Domain(ValueSet.of_ranges(Range(v, True, None, False)), False)


def _scalar_domain(ref: SymbolRef, op: str, lit: Literal
                   ) -> Optional[Domain]:
    """Domain over ``ref``'s raw space for ``ref OP lit``."""
    t = ref.type
    v = lit.value
    if v is None:
        return None
    if t.is_string:
        if not isinstance(v, str):
            return None
        if op == "eq":
            return Domain.single(v)
        if op == "ne":
            return Domain(ValueSet.of(v).complement(), False)
        lo, li, hi, hin = {
            "lt": (None, False, v, False), "le": (None, False, v, True),
            "gt": (v, False, None, False), "ge": (v, True, None, False),
        }[op]
        return Domain(ValueSet.of_ranges(Range(lo, li, hi, hin)), False)
    if t == T.BOOLEAN:
        if not isinstance(v, bool) or op not in ("eq", "ne"):
            return None
        val = v if op == "eq" else (not v)
        return Domain.single(val)
    if t in (T.DOUBLE, T.REAL):
        if not isinstance(v, (int, float, Decimal)):
            return None
        return _float_domain(op, float(v))
    scale = _numeric_scale(t)
    if scale is None:
        return None
    x = _rational(lit)
    if x is None:
        return None
    return _range_domain(op, x, scale)


def conjunct_domain(e: RowExpression) -> Optional[Tuple[str, Domain]]:
    """(symbol_name, domain) for one conjunct, or None if residual."""
    if isinstance(e, SymbolRef) and e.type == T.BOOLEAN:
        return e.name, Domain.single(True)
    if not isinstance(e, Call):
        return None
    if e.name in _CMP and len(e.args) == 2:
        a, b = e.args
        ref = _unwrap_ref(a)
        lit = _true_literal(b)
        op = e.name
        if ref is None or lit is None:
            ref = _unwrap_ref(b)
            lit = _true_literal(a)
            op = _FLIP[e.name]
        if ref is None or lit is None or ref.type.is_pooled \
                and not ref.type.is_string:
            return None
        dom = _scalar_domain(ref, op, lit)
        return (ref.name, dom) if dom is not None else None
    if e.name == "$between" and len(e.args) == 3:
        ref = _unwrap_ref(e.args[0])
        lo = _true_literal(e.args[1])
        hi = _true_literal(e.args[2])
        if ref is None or lo is None or hi is None:
            return None
        d1 = _scalar_domain(ref, "ge", lo)
        d2 = _scalar_domain(ref, "le", hi)
        if d1 is None or d2 is None:
            return None
        return ref.name, d1.intersect(d2)
    if e.name == "$is_null" and len(e.args) == 1 \
            and isinstance(e.args[0], SymbolRef):
        return e.args[0].name, Domain.only_null()
    if e.name in ("not", "$not") and len(e.args) == 1:
        inner = e.args[0]
        if isinstance(inner, Call) and inner.name == "$is_null" \
                and isinstance(inner.args[0], SymbolRef):
            return inner.args[0].name, Domain.not_null()
        if isinstance(inner, SymbolRef) and inner.type == T.BOOLEAN:
            return inner.name, Domain.single(False)
        return None
    if e.name == "$in" and len(e.args) >= 2:
        ref = _unwrap_ref(e.args[0])
        if ref is None:
            return None
        dom: Optional[Domain] = None
        for item in e.args[1:]:
            lit = _true_literal(item)
            if lit is None:
                return None
            d = _scalar_domain(ref, "eq", lit)
            if d is None:
                return None
            dom = d if dom is None else dom.union(d)
        return (ref.name, dom) if dom is not None else None
    if e.name == "$or":
        parts = [conjunct_domain(a) for a in e.args]
        if any(p is None for p in parts):
            return None
        names = {n for n, _ in parts}
        if len(names) != 1:
            return None  # multi-column OR is not a single-column domain
        name = names.pop()
        dom = parts[0][1]
        for _, d in parts[1:]:
            dom = dom.union(d)
        return name, dom
    return None


