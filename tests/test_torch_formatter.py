"""The SQL expression formatter: the torch engine against the JAX engine.

``format(parse(q))`` in both engines for the 22 TPC-H queries: every
expression node of each parsed statement (top-level expressions and
every sub-expression, in walk order) formats to the same text in both
engines, or fails with the same error type where the formatter has no
form for it (subqueries, window calls). Then the forms TPC-H does not
reach — every literal kind, IS [NOT] NULL, LIKE ... ESCAPE, TRY_CAST,
simple CASE, NULLIF, IF, ROW — from statements made up for them.
"""

import pytest

from trino_tpu.cache import _walk_nodes as j_walk
from trino_tpu.resources.tpch_queries import TPCH_QUERIES
from trino_tpu.sql import ast as jast
from trino_tpu.sql.formatter import format_expression as j_format
from trino_tpu.sql.parser import parse_statement as j_parse
from trino_tpu_torch.cache import _walk_nodes
from trino_tpu_torch.sql import ast
from trino_tpu_torch.sql.formatter import format_expression
from trino_tpu_torch.sql.parser import parse_statement


def _formatted(stmt, walk, expression_type, fmt):
    out = []
    for node in walk(stmt):
        if not isinstance(node, expression_type):
            continue
        try:
            out.append(fmt(node))
        except NotImplementedError as e:
            out.append(("unformattable", str(e)))
    return out


def _both(sql):
    got = _formatted(parse_statement(sql), _walk_nodes, ast.Expression,
                     format_expression)
    want = _formatted(j_parse(sql), j_walk, jast.Expression, j_format)
    assert got == want
    return got


@pytest.mark.parametrize("qid", sorted(TPCH_QUERIES))
def test_tpch_expressions_format_as_jax(qid):
    got = _both(TPCH_QUERIES[qid])
    assert any(isinstance(x, str) for x in got)


EXTRA = [
    "select null, true, false, 7, 1.5e0, 12.50, 'it''s', "
    "date '1998-12-01', interval '3' day, interval -'2' month",
    "select a.b from t a where x is null and y is not null "
    "and not (z between 1 and 2)",
    "select 1 from t where s like 'a!%' escape '!' and k in (1, 2, 3)",
    "select try_cast(x as bigint), cast(y as varchar), "
    "extract(year from d) from t",
    "select case k when 1 then 'a' when 2 then 'b' else 'c' end, "
    "case when k > 1 then 1 end, nullif(a, b), if(a > b, a), "
    "if(a > b, a, b), coalesce(a, b, 0) from t",
    "select count(distinct k), row(1, 'x'), -k, current_date from t",
]


@pytest.mark.parametrize("sql", EXTRA, ids=[f"sql{i}"
                                            for i in range(len(EXTRA))])
def test_other_forms_format_as_jax(sql):
    got = _both(sql)
    assert all(isinstance(x, str) for x in got), got
