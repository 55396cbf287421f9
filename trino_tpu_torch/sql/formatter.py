"""AST -> SQL text round-trip.

Reference analog: ``core/trino-parser/.../sql/SqlFormatter.java`` +
``ExpressionFormatter.java``. Used for DELETE rewrites, view expansion,
and EXPLAIN rendering.

The JAX engine's ``trino_tpu/sql/formatter.py``, copied: one expression
formats to the same text in both engines.
"""

from __future__ import annotations

from . import ast


def format_expression(e: ast.Expression) -> str:
    f = format_expression
    if isinstance(e, ast.NullLiteral):
        return "null"
    if isinstance(e, ast.BooleanLiteral):
        return "true" if e.value else "false"
    if isinstance(e, ast.LongLiteral):
        return str(e.value)
    if isinstance(e, ast.DoubleLiteral):
        return repr(e.value)
    if isinstance(e, ast.DecimalLiteral):
        return e.text
    if isinstance(e, ast.StringLiteral):
        return "'" + e.value.replace("'", "''") + "'"
    if isinstance(e, ast.GenericLiteral):
        return f"{e.type_name} '{e.value}'"
    if isinstance(e, ast.IntervalLiteral):
        sign = "-" if e.sign < 0 else ""
        return f"interval {sign}'{e.value}' {e.unit}"
    if isinstance(e, ast.Identifier):
        return e.name
    if isinstance(e, ast.DereferenceExpression):
        return f"{f(e.base)}.{e.field_name}"
    if isinstance(e, ast.ComparisonExpression):
        return f"({f(e.left)} {e.op} {f(e.right)})"
    if isinstance(e, ast.ArithmeticBinary):
        return f"({f(e.left)} {e.op} {f(e.right)})"
    if isinstance(e, ast.ArithmeticUnary):
        return f"({e.op}{f(e.value)})"
    if isinstance(e, ast.LogicalBinary):
        return f"({f(e.left)} {e.op.lower()} {f(e.right)})"
    if isinstance(e, ast.NotExpression):
        return f"(not {f(e.value)})"
    if isinstance(e, ast.IsNullPredicate):
        return f"({f(e.value)} is null)"
    if isinstance(e, ast.IsNotNullPredicate):
        return f"({f(e.value)} is not null)"
    if isinstance(e, ast.BetweenPredicate):
        return f"({f(e.value)} between {f(e.min)} and {f(e.max)})"
    if isinstance(e, ast.InPredicate):
        items = ", ".join(f(x) for x in e.value_list)
        return f"({f(e.value)} in ({items}))"
    if isinstance(e, ast.LikePredicate):
        out = f"({f(e.value)} like {f(e.pattern)}"
        if e.escape is not None:
            out += f" escape {f(e.escape)}"
        return out + ")"
    if isinstance(e, ast.Cast):
        kw = "try_cast" if e.safe else "cast"
        return f"{kw}({f(e.value)} as {e.type_name})"
    if isinstance(e, ast.Extract):
        return f"extract({e.field_name} from {f(e.value)})"
    if isinstance(e, ast.CurrentTime):
        return e.kind
    if isinstance(e, ast.SearchedCase):
        parts = ["case"]
        for w in e.when_clauses:
            parts.append(f"when {f(w.condition)} then {f(w.result)}")
        if e.default is not None:
            parts.append(f"else {f(e.default)}")
        parts.append("end")
        return " ".join(parts)
    if isinstance(e, ast.SimpleCase):
        parts = [f"case {f(e.operand)}"]
        for w in e.when_clauses:
            parts.append(f"when {f(w.condition)} then {f(w.result)}")
        if e.default is not None:
            parts.append(f"else {f(e.default)}")
        parts.append("end")
        return " ".join(parts)
    if isinstance(e, ast.CoalesceExpression):
        return "coalesce(" + ", ".join(f(a) for a in e.args) + ")"
    if isinstance(e, ast.NullIfExpression):
        return f"nullif({f(e.first)}, {f(e.second)})"
    if isinstance(e, ast.IfExpression):
        out = f"if({f(e.condition)}, {f(e.true_value)}"
        if e.false_value is not None:
            out += f", {f(e.false_value)}"
        return out + ")"
    if isinstance(e, ast.FunctionCall):
        args = ", ".join(f(a) for a in e.args)
        if e.distinct:
            args = "distinct " + args
        return f"{e.name}({args})"
    if isinstance(e, ast.Row):
        return "row(" + ", ".join(f(x) for x in e.items) + ")"
    raise NotImplementedError(
        f"cannot format {type(e).__name__}")
