"""TPC-H q3 and the join, TopN and LIMIT paths at the SQL level: the
torch engine against the JAX engine.

The same SQL runs through ``trino_tpu.runner.LocalQueryRunner`` and
``trino_tpu_torch.LocalQueryRunner(device="cpu")`` over the same
generated data. Rows under ORDER BY or TopN must come out equal and in
the same order; rows of a query without ORDER BY are compared as sorted
lists (a join's lane order is not part of its result). Decimals compare
exactly, DOUBLE within a relative 1e-12 (``_same_rows``).
"""

import pytest

from test_torch_tpch_q1 import _runners, _same_rows
from trino_tpu.resources.tpch_queries import TPCH_QUERIES


def _sorted(rows):
    return sorted(rows, key=repr)


def _join_ops(res):
    return [op for op in res.stats["operators"] if "Join" in op["name"]]


@pytest.mark.parametrize("strategy", ["AUTOMATIC", "SORTED_INDEX",
                                      "MATMUL"])
@pytest.mark.parametrize("dynamic_filtering", [True, False])
@pytest.mark.parametrize("schema", ["micro", "tiny"])
def test_q3_rows_equal_jax(schema, dynamic_filtering, strategy):
    props = {"enable_dynamic_filtering": dynamic_filtering,
             "join_strategy": strategy}
    jr, pr = _runners(schema, props)
    want = jr.execute(TPCH_QUERIES[3])
    got = pr.execute(TPCH_QUERIES[3])
    assert got.column_names == want.column_names
    assert [t.name for t in got.types] == [t.name for t in want.types]
    assert len(got.rows) == 10
    _same_rows(got.rows, want.rows)
    # the build domains prune the same probe rows in both engines
    assert got.stats.get("dynamic_filters") == \
        (want.stats or {}).get("dynamic_filters")
    assert bool(got.stats.get("dynamic_filters")) == dynamic_filtering
    # the cost model stamps matmul on micro's orders x customer join; a
    # forced MATMUL probe re-checks each build's key range and takes the
    # sorted index where the range is too wide (lineitem x orders, and
    # both joins at tiny)
    ran = sorted(op.get("strategy", "sorted-index")
                 for op in _join_ops(got))
    want_ran = {
        ("micro", "AUTOMATIC"): ["matmul", "sorted-index"],
        ("micro", "MATMUL"): ["matmul", "matmul->sorted-index"],
        ("tiny", "MATMUL"): ["matmul->sorted-index"] * 2,
    }.get((schema, strategy), ["sorted-index"] * 2)
    assert ran == want_ran


JOIN_SQL = [
    # left, with an ON-clause residual across both sides
    "select o_orderkey, o_custkey, l_linenumber, l_partkey from orders "
    "left join lineitem on o_orderkey = l_orderkey "
    "and l_partkey > o_custkey * 10 where o_orderkey < 400",
    # inner with a residual
    "select o_orderkey, l_linenumber from orders join lineitem "
    "on o_orderkey = l_orderkey and l_suppkey < o_custkey "
    "where o_orderkey < 300",
    # full outer, duplicate and NULL keys, with and without a residual
    "select t.x, u.a from (values (1), (1), (2), (3), "
    "(cast(null as integer))) t(x) full outer join (values (1), (3), (4), "
    "(cast(null as integer))) u(a) on t.x = u.a",
    "select t.x, u.a from (values (1), (2), (3)) t(x) full outer join "
    "(values (2), (3), (4)) u(a) on t.x = u.a and t.x < 3",
    "select r_name, c from region full outer join (select n_regionkey, "
    "count(*) c from nation where n_nationkey < 3 group by n_regionkey) x "
    "on r_regionkey = n_regionkey",
    # semi: IN and EXISTS
    "select c_custkey, c_name from customer where c_custkey in "
    "(select o_custkey from orders where o_totalprice > 200000)",
    "select r_name from region r where exists (select * from nation n "
    "where n.n_regionkey = r.r_regionkey and n.n_name like 'A%')",
    # anti: NOT EXISTS
    "select c_custkey from customer c where not exists (select * from "
    "orders o where o.o_custkey = c.c_custkey)",
    # cross join
    "select n_name, r_name from nation cross join region "
    "where n_nationkey < 6",
    # string keys (dictionary codes remapped into the build's pool)
    "select n1.n_name, n2.n_nationkey from nation n1 join nation n2 "
    "on n1.n_name = n2.n_name",
    # two 32-bit keys (packed: a date and dictionary codes), two keys
    # of which one is 64-bit (hashed), and a float key (frexp)
    "select l1.l_orderkey, l2.l_orderkey from lineitem l1 join lineitem l2 "
    "on l1.l_shipdate = l2.l_shipdate and l1.l_shipmode = l2.l_shipmode "
    "where l1.l_orderkey < 300",
    "select o1.o_orderkey, o2.o_orderkey from orders o1 join orders o2 "
    "on o1.o_custkey = o2.o_custkey "
    "and o1.o_orderstatus = o2.o_orderstatus",
    "select o1.o_orderkey, o2.o_orderkey from orders o1 join orders o2 "
    "on o1.o_totalprice * 1e0 = o2.o_totalprice * 1e0 "
    "where o1.o_orderkey < 200",
    # three-way join through a projection, and a residual semi join
    "select n_name, count(*) from customer join orders "
    "on c_custkey = o_custkey join nation on c_nationkey = n_nationkey "
    "group by n_name",
    "select count(*) from lineitem l1 where exists (select * from "
    "lineitem l2 where l2.l_orderkey = l1.l_orderkey "
    "and l2.l_suppkey <> l1.l_suppkey)",
]


@pytest.mark.parametrize("sql", JOIN_SQL)
def test_join_sql_equal_jax(sql):
    jr, pr = _runners("micro")
    want = jr.execute(sql).rows
    assert want, "the case must produce rows"
    _same_rows(_sorted(pr.execute(sql).rows), _sorted(want))


ORDERED_SQL = [
    "select n_nationkey, n_name from nation order by n_nationkey limit 3",
    "select n_nationkey from nation order by n_nationkey offset 5 limit 4",
    "select n_name from nation order by n_name desc offset 20 limit 10",
    "select l_orderkey, l_linenumber, l_extendedprice from lineitem "
    "order by l_extendedprice desc, l_orderkey limit 7",
    "select o_orderkey, o_totalprice from orders "
    "order by o_totalprice limit 40",
]


@pytest.mark.parametrize("sql", ORDERED_SQL)
def test_topn_limit_offset_equal_jax(sql):
    jr, pr = _runners("micro")
    _same_rows(pr.execute(sql).rows, jr.execute(sql).rows)


@pytest.mark.parametrize("limit,offset", [(1500, 0), (700, 900), (5, 3000)])
def test_limit_inside_a_page_equal_jax(limit, offset):
    """LIMIT/OFFSET without ORDER BY over pages of 1,024 rows: the limit
    fills in the middle of a page, and the rows kept are the first
    ``limit`` after ``offset`` in scan order, in both engines."""
    sql = (f"select l_orderkey, l_linenumber from lineitem "
           f"offset {offset} limit {limit}")
    jr, pr = _runners("micro", page_rows=1024)
    want = jr.execute(sql).rows
    got = pr.execute(sql).rows
    assert len(got) == limit
    _same_rows(got, want)


@pytest.mark.parametrize("lanes", [16, 256])
def test_small_expand_lanes_equal_jax(lanes):
    """A lane budget far below a page's matches forces the overflow
    re-expansion and the chunked expansion; rows stay the reference's."""
    sql = ("select o_orderkey, l_linenumber, l_quantity from orders "
           "join lineitem on o_orderkey = l_orderkey "
           "where o_orderkey < 2000")
    props = {"join_max_expand_lanes": lanes,
             "enable_dynamic_filtering": False}
    jr, pr = _runners("micro", props)
    want = jr.execute(sql).rows
    got = pr.execute(sql)
    _same_rows(_sorted(got.rows), _sorted(want))
    assert len(want) > 4 * lanes


@pytest.mark.parametrize("join", ["join", "left join"])
def test_key_minus_one_skips_filtered_build_rows(join):
    """A BIGINT key of -1 has the bits of the unusable-lane sentinel, so
    its candidates include the build rows the filter turned off. The
    torch engine verifies that a candidate build row is usable; the JAX
    engine checks only the raw keys and joins the filtered-out row
    (-1, 1) here, so this case is held against the SQL answer, and the
    JAX engine's rows differ from it by that one row."""
    sql = (f"select t.k, u.x from (values (-1), (2), (3)) t(k) {join} "
           "(select * from (values (-1, 1), (2, 10), (-1, 7)) v(k, x) "
           "where x > 5) u on t.k = u.k")
    jr, pr = _runners("micro")
    want = [(-1, 7), (2, 10)] + ([(3, None)] if join == "left join" else [])
    assert _sorted(pr.execute(sql).rows) == _sorted(want)
    assert _sorted(jr.execute(sql).rows) == _sorted(want + [(-1, 1)])
