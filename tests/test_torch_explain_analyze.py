"""EXPLAIN ANALYZE and EXPLAIN: the torch engine against the JAX engine.

EXPLAIN ANALYZE runs the statement and renders the optimized plan, a
``Query:`` line (wall, output rows), a ``Memory:`` line (peak, spills,
disk files when the disk tier is on) and one line per operator per
pipeline. Over the same generated data both engines must give the same
plan lines, the same output rows, and the same operators, pipeline by
pipeline, with the same output rows and pages (wall times differ, and
the compile counts and program costs differ). The line shapes the JAX
engine's own tests read (tests/test_session_stats.py,
tests/test_predicate.py, tests/test_matmul_join.py) hold here too, and
VERBOSE adds its ``Kernels:`` line in both. EXPLAIN keeps the
optimizer's provenance block: for the 22 TPC-H queries both engines
print the same lines.
"""

import re

import pytest

from test_torch_tpch_q1 import _runners
from trino_tpu.resources.tpch_queries import TPCH_QUERIES

_QUERY = re.compile(r"Query: [0-9.]+ms, (\d+) rows")
_MEMORY = re.compile(r"Memory: peak (\d+) bytes, (\d+) spills \((\d+) "
                     r"bytes\)(, disk (\d+) files \((\d+) bytes\))?")
_PIPELINE = re.compile(r"Pipeline (\d+):")
_OPERATOR = re.compile(r"  (\w+): (\d+) rows, (\d+) pages, [0-9.]+ms(.*)")


def explain_analyze_parts(rows):
    """(plan lines, output rows, Memory match, [(pipeline, operator,
    rows, pages)]) of one EXPLAIN ANALYZE result; every line must have
    its expected shape."""
    lines = [r[0] for r in rows]
    blank = lines.index("")
    query = _QUERY.fullmatch(lines[blank + 1])
    memory = _MEMORY.fullmatch(lines[blank + 2])
    assert query and memory, lines[blank + 1:blank + 3]
    ops, pipeline = [], None
    for line in lines[blank + 3:]:
        m = _PIPELINE.fullmatch(line)
        if m:
            pipeline = int(m.group(1))
            continue
        m = _OPERATOR.fullmatch(line)
        assert m and pipeline is not None, line
        ops.append((pipeline, m.group(1), int(m.group(2)), int(m.group(3))))
    return lines[:blank], int(query.group(1)), memory, ops


# history-based statistics add estimate columns and a worst-misestimate
# line, and re-plan a repeated statement from its recorded actuals: these
# cases compare single runs, so both engines plan without history
# (tests/test_torch_hbo.py holds the history against the JAX engine's)
NO_HBO = {"hbo_enabled": False}

SQL = [
    "select n_regionkey, count(*) from nation group by n_regionkey",
    TPCH_QUERIES[1],
    TPCH_QUERIES[3],
    "select c.c_custkey, o.o_orderkey from customer c "
    "join orders o on c.c_custkey = o.o_custkey",
    "select * from lineitem where l_quantity < 3 order by l_extendedprice "
    "desc, l_orderkey, l_linenumber",
    "select n_name from nation union all select r_name from region",
]


@pytest.fixture(scope="module")
def runners():
    return _runners("micro", NO_HBO, page_rows=2048)


@pytest.mark.parametrize("sql", SQL, ids=[f"sql{i}" for i in range(len(SQL))])
def test_explain_analyze_equals_jax(runners, sql):
    jr, pr = runners
    jplan, jrows, jmem, jops = explain_analyze_parts(
        jr.execute("explain analyze " + sql).rows)
    pplan, prows, pmem, pops = explain_analyze_parts(
        pr.execute("explain analyze " + sql).rows)
    assert pplan == jplan
    assert prows == jrows == len(jr.execute(sql).rows)
    assert pops == jops
    assert pmem.group(2) == jmem.group(2) == "0"  # no spill without a cap


def test_explain_analyze_spill_counts_equal_jax():
    """Under a cap with both spill tiers on, both engines spill and
    write spill files; the rows and the operators' rows agree."""
    props = dict(NO_HBO, query_max_memory_bytes=600_000,
                 spill_enabled=True, spill_to_disk_enabled=True,
                 spill_host_memory_bytes=0)
    jr, pr = _runners("micro", props, page_rows=1024)
    sql = ("explain analyze select l_orderkey, sum(l_quantity) qty from "
           "lineitem group by l_orderkey order by qty desc, l_orderkey "
           "limit 10")
    jplan, jrows, jmem, jops = explain_analyze_parts(jr.execute(sql).rows)
    pplan, prows, pmem, pops = explain_analyze_parts(pr.execute(sql).rows)
    assert (pplan, prows, pops) == (jplan, jrows, jops)
    assert int(pmem.group(2)) > 0 and int(jmem.group(2)) > 0
    assert int(pmem.group(5)) > 0 and int(jmem.group(5)) > 0


def test_explain_analyze_line_shapes(runners):
    """tests/test_session_stats.py's test_explain_analyze on the port."""
    _, pr = runners
    res = pr.execute("explain analyze select n_regionkey, count(*) from "
                     "nation group by n_regionkey")
    text = "\n".join(r[0] for r in res.rows)
    assert "Aggregation" in text
    assert "TableScanOperator" in text
    assert "rows" in text and "ms" in text


def _scan_rows(runner, sql):
    """TableScan output rows from EXPLAIN ANALYZE operator stats
    (tests/test_predicate.py's reader)."""
    rows, seen = 0, False
    for (line,) in runner.execute("explain analyze " + sql).rows:
        if "TableScanOperator" in line:
            seen = True
            rows += int(line.split(":")[1].strip().split(" ")[0])
    assert seen, "no TableScanOperator line in EXPLAIN ANALYZE"
    return rows


def test_scan_rows_show_stats_pruning():
    """tests/test_predicate.py's scan-pruning reader: with filter
    pushdown the scan emits under a quarter of the rows it emits
    without, in both engines, and the counts agree."""
    sql = ("select count(*) from lineitem "
           "where l_shipdate <= date '1995-06-17' and l_quantity < 10")
    jon, pon = _runners("micro", NO_HBO, page_rows=2048)
    off = dict(NO_HBO, filter_pushdown_enabled=False)
    joff, poff = _runners("micro", off, page_rows=2048)
    assert pon.execute(sql).rows == poff.execute(sql).rows
    pruned, full = _scan_rows(pon, sql), _scan_rows(poff, sql)
    assert pruned < full / 4, (pruned, full)
    assert (pruned, full) == (_scan_rows(jon, sql), _scan_rows(joff, sql))


def test_matmul_strategy_lines():
    """tests/test_matmul_join.py's EXPLAIN ANALYZE reads: the matmul
    operator line shows the strategy and the estimate, and a forced
    matmul on a wide key shows the fallback."""
    _, auto = _runners("micro", NO_HBO, page_rows=4096)
    txt = "\n".join(r[0] for r in auto.execute(
        "explain analyze select c.c_custkey, o.o_orderkey from customer c "
        "join orders o on c.c_custkey = o.o_custkey").rows)
    assert "MatmulJoinOperator" in txt
    assert "strategy matmul" in txt
    assert "key range 150" in txt
    _, forced = _runners("micro", dict(NO_HBO, join_strategy="MATMUL"),
                         page_rows=4096)
    txt = "\n".join(r[0] for r in forced.execute(
        "explain analyze select o.o_orderkey, l.l_quantity from orders o "
        "join lineitem l on o.o_orderkey = l.l_orderkey").rows)
    assert "matmul->sorted-index" in txt


def test_explain_analyze_verbose_raises_not_supported(runners):
    """Checks that VERBOSE WORKS and equals the JAX engine's; the name,
    from when it raised, is kept so the test's id stays the same.

    VERBOSE is ported: it no longer raises NOT_SUPPORTED, and it
    renders what the plain form renders plus the ``Kernels:`` line
    (its per-operator programs are held against the JAX engine's in
    tests/test_torch_profiler.py)."""
    jr, pr = runners
    sql = "explain analyze verbose select count(*) from nation"
    got = [r[0] for r in pr.execute(sql).rows]
    want = [r[0] for r in jr.execute(sql).rows]
    assert got[-1].startswith("Kernels: ") and want[-1].startswith(
        "Kernels: ")
    jplan, jrows, _, jops = explain_analyze_parts([(w,) for w in want[:-1]])
    pplan, prows, _, pops = explain_analyze_parts([(g,) for g in got[:-1]])
    assert (pplan, prows, pops) == (jplan, jrows, jops)


@pytest.mark.parametrize("qid", sorted(TPCH_QUERIES))
def test_explain_provenance_equals_jax(runners, qid):
    """EXPLAIN's lines, the "Optimizer rules applied:" block included."""
    jr, pr = runners
    want = [r[0] for r in jr.execute("explain " + TPCH_QUERIES[qid]).rows]
    got = [r[0] for r in pr.execute("explain " + TPCH_QUERIES[qid]).rows]
    assert "Optimizer rules applied:" in want
    assert got == want
