"""Name/type resolution: AST expressions -> typed RowExpressions.

Reference analog: ``sql/analyzer/ExpressionAnalyzer.java`` +
``StatementAnalyzer.java`` (scoping) + ``sql/planner/TranslationMap.java``
(AST -> IR translation). The reference splits analysis and IR translation
into two passes over an ``Analysis`` side-table; here both happen in one
pass because the IR (``expr/ir.py``) carries types directly.

Scopes resolve unqualified and alias-qualified column names to plan
Symbols; parent scopes give correlated subqueries access to outer columns
(resolution records the outer reference for the decorrelator).
"""

from __future__ import annotations

import datetime as _dt
import re
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from .. import types as T
from ..expr import functions as F
from ..expr.functions import days_from_civil_host
from ..expr.ir import Call, Literal, ParamRef, RowExpression
from ..planner.symbols import Symbol, SymbolRef
from ..types import TrinoError
from . import ast


class AnalysisError(TrinoError):
    def __init__(self, message: str):
        super().__init__(message, code="ANALYSIS_ERROR")


#: template-planning parameter context: when a normalized
#: statement shape is planned DIRECTLY (its cache-marked literals left
#: as ``ast.Parameter`` markers), this thread-local carries the IR type
#: of each parameter slot so ``_an_Parameter`` can lower the marker to
#: an opaque ``ParamRef`` instead of a baked constant.  Outside the
#: context a Parameter is an analysis error — ordinary statements never
#: contain markers.
_TEMPLATE_PARAMS = threading.local()


@contextmanager
def template_parameters(types_: Tuple[T.Type, ...]):
    """Plan with ``ast.Parameter(i)`` lowering to ``ParamRef(types_[i], i)``."""
    prev = getattr(_TEMPLATE_PARAMS, "types", None)
    _TEMPLATE_PARAMS.types = tuple(types_)
    try:
        yield
    finally:
        _TEMPLATE_PARAMS.types = prev


# aggregate function names (reference: metadata/SystemFunctionBundle
# aggregation registrations)
AGGREGATE_FUNCTIONS = {
    "count", "sum", "avg", "min", "max", "stddev", "stddev_samp",
    "stddev_pop", "variance", "var_samp", "var_pop", "count_if",
    "bool_and", "bool_or", "every", "arbitrary", "any_value",
    "approx_distinct", "approx_percentile", "geometric_mean",
}

_COMPARISON_FN = {"=": "eq", "<>": "ne", "!=": "ne", "<": "lt",
                  "<=": "le", ">": "gt", ">=": "ge"}
_ARITHMETIC_FN = {"+": "add", "-": "subtract", "*": "multiply",
                  "/": "divide", "%": "modulus"}


@dataclass
class FieldDef:
    """One named column of a relation scope (reference:
    sql/analyzer/Field.java)."""

    name: Optional[str]            # None for anonymous expressions
    symbol: Symbol
    relation_alias: Optional[str] = None
    hidden: bool = False


class Scope:
    """Reference: sql/analyzer/Scope.java."""

    def __init__(self, fields: List[FieldDef],
                 parent: Optional["Scope"] = None):
        self.fields = fields
        self.parent = parent

    def visible_fields(self) -> List[FieldDef]:
        return [f for f in self.fields if not f.hidden]

    def resolve(self, name: str, alias: Optional[str] = None
                ) -> Tuple[FieldDef, int]:
        """Returns (field, outer_level); outer_level 0 = local."""
        name = name.lower()
        alias = alias.lower() if alias else None
        scope: Optional[Scope] = self
        level = 0
        while scope is not None:
            matches = [f for f in scope.fields
                       if f.name == name and
                       (alias is None or f.relation_alias == alias)]
            if len(matches) > 1:
                # identical symbol from USING-join expansion is fine
                if len({m.symbol for m in matches}) > 1:
                    raise AnalysisError(f"column '{name}' is ambiguous")
            if matches:
                return matches[0], level
            scope = scope.parent
            level += 1
        qual = f"{alias}.{name}" if alias else name
        raise AnalysisError(f"column '{qual}' cannot be resolved")


@dataclass
class Session:
    """Query session (reference: Session.java). start_date drives
    current_date/now determinism."""

    catalog: Optional[str] = None
    schema: str = "tiny"
    start_date: _dt.date = field(default_factory=_dt.date.today)
    properties: Dict[str, str] = field(default_factory=dict)
    timezone: str = "UTC"
    user: str = "trino"


def coerce(expr: RowExpression, target: T.Type) -> RowExpression:
    if expr.type == target:
        return expr
    if isinstance(expr, Literal) and expr.value is None:
        return Literal(target, None)
    if expr.type == T.UNKNOWN:
        return Literal(target, None)
    return Call(target, "$cast", (expr,))


def common_type(a: T.Type, b: T.Type, what: str) -> T.Type:
    ct = T.common_super_type(a, b)
    if ct is None:
        raise AnalysisError(f"cannot apply {what} to {a} and {b}")
    return ct


def find_aggregates(e: ast.Expression) -> List[ast.FunctionCall]:
    """All top-most aggregate calls in an AST expression (reference:
    sql/analyzer/AggregationAnalyzer.java). Does not descend into
    subqueries — their aggregates belong to the inner query."""
    out: List[ast.FunctionCall] = []

    def walk(n):
        if isinstance(n, (ast.ScalarSubquery, ast.InSubquery,
                          ast.ExistsPredicate, ast.QuantifiedComparison)):
            return
        if isinstance(n, ast.FunctionCall) and \
                n.name.lower() in AGGREGATE_FUNCTIONS and n.window is None:
            out.append(n)
            return  # no nested aggregates
        for f in getattr(n, "__dataclass_fields__", {}):
            v = getattr(n, f)
            if isinstance(v, ast.Node):
                walk(v)
            elif isinstance(v, tuple):
                for item in v:
                    if isinstance(item, ast.Node):
                        walk(item)

    walk(e)
    return out


def find_windows(e: ast.Expression) -> List[ast.FunctionCall]:
    """All window function calls (OVER clauses) in an expression, not
    descending into subqueries (reference: WindowFunctionExtractor)."""
    out: List[ast.FunctionCall] = []

    def walk(n):
        if isinstance(n, (ast.ScalarSubquery, ast.InSubquery,
                          ast.ExistsPredicate, ast.QuantifiedComparison)):
            return
        if isinstance(n, ast.FunctionCall) and n.window is not None:
            out.append(n)
            return
        for f in getattr(n, "__dataclass_fields__", {}):
            v = getattr(n, f)
            if isinstance(v, ast.Node):
                walk(v)
            elif isinstance(v, tuple):
                for item in v:
                    if isinstance(item, ast.Node):
                        walk(item)

    walk(e)
    return out


def expression_uses_scope(e: ast.Expression) -> bool:
    """Does the expression reference any column (vs pure literals)?"""
    if isinstance(e, (ast.Identifier, ast.DereferenceExpression)):
        return True
    for f in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f)
        if isinstance(v, ast.Node) and expression_uses_scope(v):
            return True
        if isinstance(v, tuple):
            for item in v:
                if isinstance(item, ast.Node) and expression_uses_scope(item):
                    return True
    return False


class ExpressionAnalyzer:
    """Lower one AST expression against a scope.

    ``replacements`` maps AST subtrees (value equality) to symbols —
    used above aggregations so ``sum(x)`` / group-key expressions resolve
    to the aggregation's outputs.
    ``subquery_hook(node) -> RowExpression`` handles ScalarSubquery /
    InSubquery / Exists nodes (the planner supplies it; bare analysis
    rejects subqueries).
    Correlated references (resolved in a parent scope) are recorded in
    ``outer_references``.
    """

    def __init__(self, scope: Scope, session: Session,
                 replacements: Optional[Dict[ast.Expression, Symbol]] = None,
                 subquery_hook: Optional[Callable] = None):
        self.scope = scope
        self.session = session
        self.replacements = replacements or {}
        self.subquery_hook = subquery_hook
        self.outer_references: List[Symbol] = []

    # ------------------------------------------------------------------

    def analyze(self, e: ast.Expression) -> RowExpression:
        if self.replacements:
            sym = self.replacements.get(e)
            if sym is not None:
                return sym.ref()
        m = getattr(self, "_an_" + type(e).__name__, None)
        if m is None:
            raise AnalysisError(
                f"unsupported expression: {type(e).__name__}")
        return m(e)

    # -- literals ------------------------------------------------------

    def _an_NullLiteral(self, e):
        return Literal(T.UNKNOWN, None)

    def _an_BooleanLiteral(self, e):
        return Literal(T.BOOLEAN, e.value)

    def _an_LongLiteral(self, e):
        return Literal(T.BIGINT, e.value)

    def _an_Parameter(self, e):
        # cache-marked literal slot of a normalized shape: opaque to
        # every plan-time constant reader (template planning)
        types_ = getattr(_TEMPLATE_PARAMS, "types", None)
        if types_ is None or e.position >= len(types_):
            raise AnalysisError("parameter outside template planning")
        return ParamRef(types_[e.position], e.position)

    def _an_DoubleLiteral(self, e):
        return Literal(T.DOUBLE, e.value)

    def _an_DecimalLiteral(self, e):
        text = e.text
        neg = text.startswith("-")
        digits = text.lstrip("+-")
        if "." in digits:
            ip, fp = digits.split(".", 1)
        else:
            ip, fp = digits, ""
        precision = max(1, len(ip.lstrip("0")) + len(fp))
        t = T.decimal_type(min(18, precision), len(fp))
        from decimal import Decimal

        return Literal(t, Decimal(text))

    def _an_StringLiteral(self, e):
        return Literal(T.varchar_type(len(e.value)), e.value)

    def _an_GenericLiteral(self, e):
        tn = e.type_name.lower()
        if tn == "date":
            y, m, d = map(int, e.value.split("-"))
            return Literal(T.DATE, days_from_civil_host(y, m, d))
        if tn == "timestamp":
            dtpart, zone = _split_timestamp_zone(e.value)
            try:
                wall = _parse_timestamp_micros(dtpart)
                if zone is None:
                    return Literal(T.TIMESTAMP, wall)
                from ..expr.tz import wall_to_utc_host

                utc = wall_to_utc_host(wall, zone)
            except ValueError as ex:
                raise AnalysisError(
                    f"invalid timestamp literal '{e.value}': {ex}")
            return Literal(T.timestamp_tz_type(zone), utc)
        if tn in ("decimal", "numeric"):
            return self._an_DecimalLiteral(ast.DecimalLiteral(e.value))
        if tn == "char":
            return Literal(T.varchar_type(len(e.value)), e.value)
        # fall back: cast string literal to the named type
        t = T.parse_type(tn)
        return coerce(Literal(T.varchar_type(len(e.value)), e.value), t)

    def _an_IntervalLiteral(self, e):
        unit = e.unit.lower()
        n = int(e.value) * e.sign
        if unit in ("day", "hour", "minute", "second"):
            scale = {"day": 86_400_000_000, "hour": 3_600_000_000,
                     "minute": 60_000_000, "second": 1_000_000}[unit]
            return Literal(T.INTERVAL_DAY_SECOND, n * scale)
        if unit in ("year", "month"):
            months = n * (12 if unit == "year" else 1)
            return Literal(T.INTERVAL_YEAR_MONTH, months)
        raise AnalysisError(f"unsupported interval unit {unit}")

    # -- names ---------------------------------------------------------

    def _an_Identifier(self, e):
        f, level = self.scope.resolve(e.name)
        if level > 0:
            self.outer_references.append(f.symbol)
        return f.symbol.ref()

    def _an_DereferenceExpression(self, e):
        if not isinstance(e.base, ast.Identifier):
            raise AnalysisError("row-field dereference not supported yet")
        f, level = self.scope.resolve(e.field_name, alias=e.base.name)
        if level > 0:
            self.outer_references.append(f.symbol)
        return f.symbol.ref()

    # -- operators -----------------------------------------------------

    def _an_ComparisonExpression(self, e):
        left = self.analyze(e.left)
        right = self.analyze(e.right)
        fn = _COMPARISON_FN[e.op]
        if fn in ("lt", "le", "gt", "ge"):
            for side in (left, right):
                if not side.type.orderable:
                    raise AnalysisError(
                        f"type {side.type} is not orderable")
        if left.type != right.type:
            ct = common_type(left.type, right.type, e.op)
            left, right = coerce(left, ct), coerce(right, ct)
        return Call(T.BOOLEAN, fn, (left, right))

    def _an_ArithmeticBinary(self, e):
        left = self.analyze(e.left)
        right = self.analyze(e.right)
        name = _ARITHMETIC_FN[e.op]
        fn = F.get_function(name)
        rt = fn.resolve([left.type, right.type])
        return Call(rt, name, (left, right))

    def _an_ArithmeticUnary(self, e):
        v = self.analyze(e.value)
        if e.op == "+":
            return v
        if isinstance(v, Literal) and v.value is not None:
            return Literal(v.type, -v.value)
        fn = F.get_function("negate")
        return Call(fn.resolve([v.type]), "negate", (v,))

    def _an_LogicalBinary(self, e):
        left = coerce(self.analyze(e.left), T.BOOLEAN)
        right = coerce(self.analyze(e.right), T.BOOLEAN)
        name = "$and" if e.op.lower() == "and" else "$or"
        # flatten nested and/or into one n-ary special form
        args: List[RowExpression] = []
        for side in (left, right):
            if isinstance(side, Call) and side.name == name:
                args.extend(side.args)
            else:
                args.append(side)
        return Call(T.BOOLEAN, name, tuple(args))

    def _an_NotExpression(self, e):
        return Call(T.BOOLEAN, "$not",
                    (coerce(self.analyze(e.value), T.BOOLEAN),))

    def _an_IsNullPredicate(self, e):
        return Call(T.BOOLEAN, "$is_null", (self.analyze(e.value),))

    def _an_IsNotNullPredicate(self, e):
        return Call(T.BOOLEAN, "$not",
                    (Call(T.BOOLEAN, "$is_null", (self.analyze(e.value),)),))

    def _an_BetweenPredicate(self, e):
        v = self.analyze(e.value)
        if not v.type.orderable:
            raise AnalysisError(f"type {v.type} is not orderable")
        lo = self.analyze(e.min)
        hi = self.analyze(e.max)
        ct = v.type
        for other in (lo.type, hi.type):
            ct = common_type(ct, other, "BETWEEN")
        return Call(T.BOOLEAN, "$between",
                    (coerce(v, ct), coerce(lo, ct), coerce(hi, ct)))

    def _an_InPredicate(self, e):
        v = self.analyze(e.value)
        items = [self.analyze(x) for x in e.value_list]
        ct = v.type
        for it in items:
            ct = common_type(ct, it.type, "IN")  # raises on type mismatch
        if v.type.is_string:
            # string IN compares dictionary values host-side; items must
            # stay bare literals (no casts — varchar lengths are erased)
            for it in items:
                if not isinstance(it, Literal):
                    raise AnalysisError(
                        "string IN list items must be literals")
            return Call(T.BOOLEAN, "$in", tuple([v] + items))
        return Call(T.BOOLEAN, "$in",
                    tuple([coerce(v, ct)] + [coerce(i, ct) for i in items]))

    def _an_LikePredicate(self, e):
        v = self.analyze(e.value)
        if not v.type.is_string:
            raise AnalysisError("LIKE requires a varchar value")
        args = [v, self.analyze(e.pattern)]
        if e.escape is not None:
            args.append(self.analyze(e.escape))
        return Call(T.BOOLEAN, "$like", tuple(args))

    def _an_Cast(self, e):
        v = self.analyze(e.value)
        target = T.parse_type(e.type_name)
        if isinstance(v, Literal) and v.value is None:
            return Literal(target, None)
        if v.type == target:
            return v
        # TRY_CAST lowers to $cast for now: device casts never trap, so
        # the difference (NULL on overflow) only shows on out-of-range
        # values
        return Call(target, "$cast", (v,))

    def _an_Extract(self, e):
        v = self.analyze(e.value)
        name = f"$extract_{e.field_name.lower()}"
        fn = F.get_function(name)
        return Call(fn.resolve([v.type]), name, (v,))

    def _an_CurrentTime(self, e):
        d = self.session.start_date
        days = days_from_civil_host(d.year, d.month, d.day)
        if e.kind == "current_date":
            return Literal(T.DATE, days)
        # current_timestamp is TIMESTAMP WITH TIME ZONE in the session
        # zone (reference: SystemSessionProperties start-time semantics);
        # deterministic at midnight of start_date
        from ..expr.tz import wall_to_utc_host

        zone = getattr(self.session, "timezone", "UTC") or "UTC"
        utc = wall_to_utc_host(days * 86_400_000_000, zone)
        return Literal(T.timestamp_tz_type(zone), utc)

    def _an_Row(self, e):
        """ROW literal -> pooled tuple (elements must fold to literals,
        like arrays)."""
        elems = [self.analyze(x) for x in e.items]
        vals = []
        for el in elems:
            if not isinstance(el, Literal):
                raise AnalysisError(
                    "ROW elements must be literals (per-row construction "
                    "is not supported)")
            vals.append(el.value)
        rt = T.row_type([(None, el.type) for el in elems])
        return Literal(rt, tuple(vals))

    def _an_ArrayConstructor(self, e):
        """ARRAY literal -> pooled value (a python tuple in the code
        pool). Elements must fold to literals: per-row array
        construction would need host work per row."""
        elems = [self.analyze(x) for x in e.elements]
        et = T.UNKNOWN
        for el in elems:
            et = common_type(et, el.type, "ARRAY")
        vals = []
        for el in elems:
            el = coerce(el, et)
            if not isinstance(el, Literal):
                raise AnalysisError(
                    "ARRAY elements must be literals (per-row array "
                    "construction is not supported)")
            vals.append(el.value)
        return Literal(T.array_type(et), tuple(vals))

    def _an_Subscript(self, e):
        base = self.analyze(e.base)
        idx = self.analyze(e.index)
        if not isinstance(idx, Literal):
            raise AnalysisError("subscript index must be a literal")
        if base.type.is_array:
            return Call(base.type.element, "$subscript", (base, idx))
        if getattr(base.type, "is_row", False):
            if not isinstance(idx.value, int) or not (
                    1 <= idx.value <= len(base.type.types)):
                raise AnalysisError(
                    f"row field index {idx.value} out of range")
            return Call(base.type.types[idx.value - 1], "$subscript",
                        (base, idx))
        if base.type.is_map:
            # deviation from the reference: missing keys yield NULL
            # (element_at semantics) instead of an error
            if T.common_super_type(idx.type, base.type.key) is None:
                raise AnalysisError(
                    f"map key type {base.type.key} does not match "
                    f"subscript type {idx.type}")
            return Call(base.type.value, "$map_get", (base, idx))
        raise AnalysisError(
            f"subscript requires an array or map, got {base.type}")

    def _an_AtTimeZone(self, e):
        from ..expr import tz as _tz

        try:
            _tz.utc_offset_table(e.zone)  # validate the zone early
        except ValueError as ex:
            raise AnalysisError(str(ex))
        v = self.analyze(e.value)
        if v.type.is_timestamp_tz:
            # same instant, different rendering zone: a type-only change
            return Call(T.timestamp_tz_type(e.zone), "$cast", (v,))
        if v.type in (T.TIMESTAMP, T.DATE):
            # wall clock interpreted in the SESSION zone, rendered in the
            # requested zone (reference: AtTimeZone semantics)
            sess = T.timestamp_tz_type(
                getattr(self.session, "timezone", "UTC") or "UTC")
            as_ts = coerce(v, T.TIMESTAMP)
            return Call(T.timestamp_tz_type(e.zone), "$cast",
                        (Call(sess, "$cast", (as_ts,)),))
        raise AnalysisError(
            f"AT TIME ZONE requires a timestamp, got {v.type}")

    def _an_SearchedCase(self, e):
        whens = [(coerce(self.analyze(w.condition), T.BOOLEAN),
                  self.analyze(w.result)) for w in e.when_clauses]
        default = self.analyze(e.default) if e.default is not None else \
            Literal(T.UNKNOWN, None)
        rt = default.type
        for _, r in whens:
            rt = common_type(rt, r.type, "CASE")
        args: List[RowExpression] = []
        for c, r in whens:
            args.append(c)
            args.append(coerce(r, rt))
        args.append(coerce(default, rt))
        return Call(rt, "$case", tuple(args))

    def _an_SimpleCase(self, e):
        operand = e.operand
        whens = tuple(
            ast.WhenClause(ast.ComparisonExpression("=", operand,
                                                    w.condition), w.result)
            for w in e.when_clauses)
        return self._an_SearchedCase(ast.SearchedCase(whens, e.default))

    def _an_IfExpression(self, e):
        c = coerce(self.analyze(e.condition), T.BOOLEAN)
        t = self.analyze(e.true_value)
        f = self.analyze(e.false_value) if e.false_value is not None else \
            Literal(T.UNKNOWN, None)
        rt = common_type(t.type, f.type, "IF")
        return Call(rt, "$if", (c, coerce(t, rt), coerce(f, rt)))

    def _an_CoalesceExpression(self, e):
        args = [self.analyze(a) for a in e.args]
        rt = args[0].type
        for a in args[1:]:
            rt = common_type(rt, a.type, "COALESCE")
        return Call(rt, "$coalesce", tuple(coerce(a, rt) for a in args))

    def _an_NullIfExpression(self, e):
        a = self.analyze(e.first)
        b = self.analyze(e.second)
        ct = common_type(a.type, b.type, "NULLIF")
        cond = Call(T.BOOLEAN, "eq", (coerce(a, ct), coerce(b, ct)))
        return Call(a.type, "$if", (cond, Literal(a.type, None), a))

    def _an_FunctionCall(self, e):
        name = e.name.lower()
        if name in AGGREGATE_FUNCTIONS:
            raise AnalysisError(
                f"aggregate {name}() not allowed in this context")
        if name == "if":
            return self._an_IfExpression(
                ast.IfExpression(e.args[0], e.args[1],
                                 e.args[2] if len(e.args) > 2 else None))
        if name == "coalesce":
            return self._an_CoalesceExpression(ast.CoalesceExpression(e.args))
        if name == "nullif":
            return self._an_NullIfExpression(
                ast.NullIfExpression(e.args[0], e.args[1]))
        if name in ("date_add", "date_diff", "date_trunc"):
            return self._date_fn(name, e)
        if name == "element_at" and len(e.args) == 2:
            base = self.analyze(e.args[0])
            idx = self.analyze(e.args[1])
            if base.type.is_map:
                # map lookup routes to the key-typed host LUT, not the
                # 1-based array subscript
                if T.common_super_type(idx.type, base.type.key) is None:
                    raise AnalysisError(
                        f"map key type {base.type.key} does not match "
                        f"element_at key type {idx.type}")
                return Call(base.type.value, "$map_get", (base, idx))
            fn = F.get_function(name)
            return Call(fn.resolve([base.type, idx.type]), name,
                        (base, idx))
        args = [self.analyze(a) for a in e.args]
        # session-zone semantics (reference: DateTimeFunctions.java —
        # from_unixtime renders in the session zone; to_unixtime reads a
        # plain TIMESTAMP's wall clock in the session zone)
        if name in ("from_unixtime", "to_unixtime"):
            zone = getattr(self.session, "timezone", "UTC") or "UTC"
            if name == "from_unixtime":
                fn = F.get_function(name)
                fn.resolve([a.type for a in args])  # validate arg
                return Call(T.timestamp_tz_type(zone), name, tuple(args))
            if args and args[0].type == T.TIMESTAMP:
                # wall micros -> UTC instant via the session zone's rules
                args[0] = Call(T.timestamp_tz_type(zone), "$cast",
                               (args[0],))
        fn = F.get_function(name)
        rt = fn.resolve([a.type for a in args])
        return Call(rt, name, tuple(args))

    def _date_fn(self, name, e):
        unit_lit = e.args[0]
        if not isinstance(unit_lit, ast.StringLiteral):
            raise AnalysisError(f"{name} unit must be a string literal")
        unit = unit_lit.value.lower()
        if name == "date_add":
            n = self.analyze(e.args[1])
            v = self.analyze(e.args[2])
            scale = {"day": 86_400_000_000, "hour": 3_600_000_000,
                     "minute": 60_000_000, "second": 1_000_000,
                     "week": 7 * 86_400_000_000}.get(unit)
            if scale is None:
                raise AnalysisError(f"date_add unit {unit} not supported")
            if not isinstance(n, Literal):
                raise AnalysisError("date_add amount must be a literal")
            ival = Literal(T.INTERVAL_DAY_SECOND, int(n.value) * scale)
            return Call(v.type, "add", (v, ival))
        if name == "date_trunc":
            v = self.analyze(e.args[1])
            fn = F.get_function(f"$date_trunc_{unit}")
            return Call(fn.resolve([v.type]), f"$date_trunc_{unit}", (v,))
        if name == "date_diff":
            a = self.analyze(e.args[1])
            b = self.analyze(e.args[2])
            scale = {"day": 86_400_000_000, "hour": 3_600_000_000,
                     "minute": 60_000_000, "second": 1_000_000,
                     "week": 7 * 86_400_000_000,
                     "millisecond": 1_000}.get(unit)
            if scale is None:
                raise AnalysisError(f"date_diff unit {unit} not supported")
            # b - a in micros (dates upcast), truncated toward zero by
            # whole units (reference: DateTimeFunctions.diffDate)
            ts = T.TIMESTAMP
            au = coerce(a, ts) if a.type == T.DATE else a
            bu = coerce(b, ts) if b.type == T.DATE else b
            return Call(T.BIGINT, "$ts_diff",
                        (bu, au, Literal(T.BIGINT, scale)))
        raise AnalysisError(f"{name} not supported yet")

    # -- subqueries ----------------------------------------------------

    def _an_ScalarSubquery(self, e):
        return self._subquery(e)

    def _an_InSubquery(self, e):
        return self._subquery(e)

    def _an_ExistsPredicate(self, e):
        return self._subquery(e)

    def _an_QuantifiedComparison(self, e):
        return self._subquery(e)

    def _subquery(self, e):
        if self.subquery_hook is None:
            raise AnalysisError("subquery not allowed in this context")
        return self.subquery_hook(self, e)


_TS_ZONE_RE = re.compile(
    r"^(\d{4}-\d{2}-\d{2}(?:[ T]\d{1,2}:\d{2}(?::\d{2}(?:\.\d+)?)?)?)"
    r"(?:\s+([A-Za-z][A-Za-z0-9_/+-]*(?:/[A-Za-z0-9_+-]+)*)"
    r"|\s*([+-]\d{1,2}:\d{2}))?$")


def _split_timestamp_zone(text: str):
    """'2020-01-01 10:00:00 +02:00' -> (datetime part, zone or None)."""
    m = _TS_ZONE_RE.match(text.strip())
    if m is None:
        return text, None
    zone = m.group(2) or m.group(3)
    return m.group(1), zone


def _parse_timestamp_micros(text: str) -> int:
    text = text.strip()
    if len(text) > 10 and text[10] in ("T", "t"):  # ISO 'T' separator
        text = text[:10] + " " + text[11:]
    date_part, _, time_part = text.partition(" ")
    y, m, d = map(int, date_part.split("-"))
    micros = days_from_civil_host(y, m, d) * 86_400_000_000
    if time_part:
        hh, mm, ss = (time_part.split(":") + ["0", "0"])[:3]
        sec, _, frac = ss.partition(".")
        micros += (int(hh) * 3600 + int(mm) * 60 + int(sec)) * 1_000_000
        if frac:
            micros += int(frac[:6].ljust(6, "0"))
    return micros
