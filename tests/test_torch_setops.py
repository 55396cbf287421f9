"""DISTINCT, set operations, UNNEST and scalar subqueries: the torch engine
against the JAX engine.

Each statement runs through both engines over the same generated data;
rows must be equal (in order under a total ORDER BY, else as sorted
lists). A scalar subquery that returns two rows must raise
SUBQUERY_MULTIPLE_ROWS in both engines; one that returns none yields
NULL. Plans the torch engine still does not run (writers, EXPLAIN
ANALYZE) raise NOT_SUPPORTED.
"""

import pytest

from test_torch_tpch_q1 import _runners, _same_rows
from trino_tpu.types import TrinoError as JTrinoError
from trino_tpu_torch.types import TrinoError

#: (sql, rows in a total order)
SQL = [
    # DISTINCT
    ("select distinct n_regionkey from nation order by 1", True),
    ("select distinct l_returnflag, l_linestatus from lineitem", False),
    ("select distinct o_orderpriority, o_orderstatus from orders "
     "where o_orderkey < 500 order by 1, 2", True),
    ("select l_returnflag, count(distinct l_suppkey) from lineitem "
     "group by l_returnflag order by 1", True),
    # UNION [ALL]
    ("select 1 x union all select 2 union all select 1 order by x", True),
    ("select 1 x union select 1 union select 2 order by x", True),
    ("select 'a' x union select 'b' union select 'a' order by x", True),
    ("select n_name from nation union all select r_name from region",
     False),
    ("select n_regionkey k from nation union select r_regionkey from "
     "region order by k", True),
    ("select c_nationkey, count(*) from (select c_nationkey from customer "
     "union all select s_nationkey from supplier) group by c_nationkey "
     "order by 1", True),
    # INTERSECT / EXCEPT
    ("select n_regionkey from nation intersect select r_regionkey from "
     "region where r_regionkey < 3", False),
    ("select s_nationkey from supplier except select c_nationkey from "
     "customer where c_acctbal > 5000", False),
    ("select o_custkey from orders intersect select c_custkey from "
     "customer where c_mktsegment = 'BUILDING'", False),
    ("select r_name from region except select n_name from nation", False),
    # UNNEST
    ("select * from unnest(array[1,2,3]) t(x)", True),
    ("select x, o from unnest(array['a','b','c']) with ordinality t(x, o) "
     "order by o", True),
    ("select * from unnest(array[1,2], array['a','b','c']) t(x, y)", False),
    ("select n_name, w, o from nation cross join unnest(split(n_name, ' ')) "
     "with ordinality t(w, o) where n_nationkey > 20 order by n_name, o",
     True),
    ("select w, count(*) c from nation cross join unnest(split(n_name, ' '))"
     " t(w) group by w order by c desc, w limit 5", True),
    # scalar subqueries: one row, zero rows (NULL), correlated
    ("select n_name, (select max(r_name) from region) from nation "
     "order by n_name", True),
    ("select (select r_name from region where r_regionkey = 2)", True),
    ("select (select r_name from region where r_regionkey = 99), 1", True),
    ("select n_name from nation where n_regionkey = (select r_regionkey "
     "from region where r_name = 'ASIA') order by n_name", True),
    ("select c_custkey, c_acctbal from customer where c_acctbal > "
     "(select avg(c_acctbal) from customer) and c_custkey < 40 "
     "order by c_custkey", True),
    ("select n_name, (select count(*) from customer c where c.c_nationkey "
     "= n.n_nationkey) from nation n order by n_name", True),
]


@pytest.fixture(scope="module")
def runners():
    return _runners("micro", page_rows=2048)


@pytest.mark.parametrize("sql,ordered", SQL,
                         ids=[f"sql{i}" for i in range(len(SQL))])
def test_sql_equals_jax(runners, sql, ordered):
    jr, pr = runners
    want = jr.execute(sql).rows
    got = pr.execute(sql).rows
    assert want
    if not ordered:
        want, got = sorted(want, key=repr), sorted(got, key=repr)
    _same_rows(got, want)


@pytest.mark.parametrize("sql", [
    "select (select r_name from region where r_regionkey < 2)",
    "select n_name, (select n_nationkey from nation) from nation",
])
def test_scalar_subquery_with_two_rows_raises_in_both(runners, sql):
    jr, pr = runners
    with pytest.raises(JTrinoError) as je:
        jr.execute(sql)
    with pytest.raises(TrinoError) as pe:
        pr.execute(sql)
    assert je.value.code == pe.value.code == "SUBQUERY_MULTIPLE_ROWS"


@pytest.mark.parametrize("sql", [
    "create table t as select * from nation",
    "explain analyze select count(*) from nation",
])
def test_writers_and_explain_analyze_raise_not_supported(runners, sql):
    _, pr = runners
    with pytest.raises(TrinoError) as e:
        pr.execute(sql)
    assert e.value.code == "NOT_SUPPORTED"
