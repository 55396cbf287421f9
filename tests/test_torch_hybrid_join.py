"""The dynamic hybrid hash join: the torch engine against the JAX engine.

Under memory pressure the join build partitions its input by a hash of
the key values, keeps the hot partitions on the device and parks the
cold ones through the spill tiers; cold probe rows park beside their
partition and join in per-partition passes once the probe input is done,
repartitioning a partition that still does not fit. These are the four
hybrid cases of tests/test_memory_governance.py that need no
history-based statistics (tests/test_torch_hbo.py holds the second run's
fan-out from history against the JAX engine's), plus inner,
LEFT, semi and anti joins on integer and string keys squeezed the same
way, each returning the JAX engine's rows.
"""

import numpy as np
import pytest
import torch

import trino_tpu_torch as P
from test_torch_tpch_q1 import _runners
from trino_tpu.connectors.tpch import TpchConnector as JConnector
from trino_tpu.runner import LocalQueryRunner as JRunner
from trino_tpu.sql.analyzer import Session as JSession
from trino_tpu_torch import types as T
from trino_tpu_torch.block import DevicePage
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.exec.memory import MemoryExceededError, QueryMemoryPool
from trino_tpu_torch.ops import join as J
from trino_tpu_torch.sql.analyzer import Session

#: no aggregation above the join: the bar is the join surviving a pool
#: far smaller than its build (ORDER BY pins row order — cold
#: partitions emit after the resident stream)
HYBRID_SQL = ("select o_orderkey, o_orderpriority, l_quantity "
              "from orders o, lineitem l "
              "where o.o_orderkey = l.l_orderkey and l_quantity > 45 "
              "order by o_orderkey, l_quantity limit 50")

SQUEEZE = {"spill_enabled": True, "spill_to_disk_enabled": True,
           "spill_host_memory_bytes": 0}


def make_runner(**props):
    session = Session(catalog="tpch", schema="micro")
    session.properties.update(props)
    return P.LocalQueryRunner({"tpch": TpchConnector(page_rows=1024)},
                              session, desired_splits=8, device="cpu")


@pytest.fixture(scope="module")
def hybrid_baseline():
    r = JRunner({"tpch": JConnector(page_rows=1024)},
                JSession(catalog="tpch", schema="micro",
                         properties={"hbo_enabled": False}),
                desired_splits=8)
    return r.execute(HYBRID_SQL).rows


def test_hybrid_join_over_pool_completes_without_retry(hybrid_baseline):
    """A join whose build and probe transients exceed the pool several
    times over completes in one attempt — partition demotions
    (partition_spills > 0) instead of a MemoryExceededError — and returns
    the JAX engine's rows."""
    res = make_runner(query_max_memory_bytes=60_000,
                      **SQUEEZE).execute(HYBRID_SQL)
    mem = res.stats["memory"]
    assert mem["partition_spills"] > 0, mem
    assert mem["partition_spilled_bytes"] > 0
    assert mem["disk_spill_events"] > 0
    assert mem["peak_bytes"] <= 60_000
    assert res.rows == hybrid_baseline
    build = next(op for op in res.stats["operators"]
                 if op["name"] == "HashBuilderOperator")
    assert build["hybrid_spill"]["partitions_spilled"] > 0
    assert build["hybrid_spill"]["source"] == "local"


def test_hybrid_disabled_property_restores_wholesale_spill(
        hybrid_baseline):
    """hybrid_join_enabled=false falls back to parking the whole build:
    still the same rows, zero partition demotions."""
    res = make_runner(query_max_memory_bytes=150_000,
                      hybrid_join_enabled=False,
                      **SQUEEZE).execute(HYBRID_SQL)
    assert res.stats["memory"]["partition_spills"] == 0
    assert res.rows == hybrid_baseline


def test_hybrid_session_fanout(hybrid_baseline):
    """hybrid_join_fanout fixes the partition count (source=session)."""
    res = make_runner(query_max_memory_bytes=60_000, hybrid_join_fanout=8,
                      **SQUEEZE).execute(HYBRID_SQL)
    build = next(op for op in res.stats["operators"]
                 if op["name"] == "HashBuilderOperator")
    assert build["hybrid_spill"]["fanout"] == 8
    assert build["hybrid_spill"]["source"] == "session"
    assert res.rows == hybrid_baseline


JOINS = [
    # inner on an integer key, wide build
    "select o_orderkey, o_custkey, l_linenumber from orders o join "
    "lineitem l on o.o_orderkey = l.l_orderkey where l_quantity > 40",
    # LEFT: unmatched probe rows and null keys emitted exactly once
    "select l.l_orderkey, l.l_linenumber, o.o_orderpriority from lineitem l "
    "left join (select * from orders where o_orderkey % 3 = 0) o "
    "on l.l_orderkey = o.o_orderkey where l_quantity > 35",
    # LEFT with a residual ON clause
    "select l.l_orderkey, l.l_linenumber, o.o_orderpriority from lineitem l "
    "left join (select * from orders where o_orderkey % 3 = 0) o "
    "on l.l_orderkey = o.o_orderkey and l.l_quantity < o.o_shippriority "
    "+ 30 where l_quantity > 35",
    # semi / anti through IN / NOT IN
    "select o_orderkey, o_orderpriority from orders where o_orderkey in "
    "(select l_orderkey from lineitem where l_quantity > 10)",
    "select o_orderkey from orders where o_orderkey not in "
    "(select l_orderkey from lineitem where l_quantity > 10)",
    # a string key (value-hashed partitions), and a string + integer key
    "select o1.o_orderkey, o2.o_orderkey from orders o1 join orders o2 "
    "on o1.o_comment = o2.o_comment",
    "select o1.o_orderkey, o2.o_custkey from orders o1 join orders o2 "
    "on o1.o_clerk = o2.o_clerk and o1.o_orderkey = o2.o_orderkey",
]

#: far below every build of JOINS at micro (page_rows 512)
JOIN_CAP = 96_000


@pytest.mark.parametrize("sql", JOINS, ids=[f"join{i}"
                                            for i in range(len(JOINS))])
def test_squeezed_joins_equal_jax(sql):
    """Each join under a cap far below its build, both spill tiers on:
    the JAX engine's rows, with build partitions parked whenever the JAX
    engine parks them, and the JAX engine's dynamic filters (built over
    the resident and the parked build rows alike)."""
    props = dict(SQUEEZE, query_max_memory_bytes=JOIN_CAP,
                 hbo_enabled=False)
    jr, pr = _runners("micro", props, page_rows=512)
    want = jr.execute(sql)
    got = pr.execute(sql)
    assert sorted(got.rows, key=repr) == sorted(want.rows, key=repr)
    jmem, pmem = want.stats["memory"], got.stats["memory"]
    assert (pmem["partition_spills"] > 0) == (jmem["partition_spills"] > 0)
    assert pmem["peak_bytes"] <= JOIN_CAP
    assert got.stats.get("dynamic_filters") == \
        want.stats.get("dynamic_filters")


def test_squeezed_joins_park_partitions():
    """The inner, anti and string-key joins of JOINS park partitions in
    the port (the parity check above is not vacuous)."""
    props = dict(SQUEEZE, query_max_memory_bytes=JOIN_CAP,
                 hbo_enabled=False)
    _, pr = _runners("micro", props, page_rows=512)
    for i in (0, 4, 5, 6):
        assert pr.execute(JOINS[i]).stats["memory"]["partition_spills"] \
            > 0, JOINS[i]


#: a join under a global aggregation: the aggregation's per-page
#: partials, not the join build, are what a revocation takes
AGG_OVER_JOIN_SQL = ("select count(*), sum(l_quantity), sum(o_totalprice) "
                     "from lineitem, orders where l_orderkey = o_orderkey")


def test_join_under_global_aggregation_spills_partials_not_build():
    """Under a quarter of its peak, the statement spills the global
    aggregation's partials and leaves the hash build resident
    (partition_spills 0) in both engines, with the same rows, peak and
    spill counts: a cap alone does not start the hybrid join."""
    props = {"spill_enabled": True, "query_max_memory_bytes": 282_624,
             "hbo_enabled": False}
    jr, pr = _runners("micro", props, page_rows=512)
    want, got = jr.execute(AGG_OVER_JOIN_SQL), pr.execute(AGG_OVER_JOIN_SQL)
    assert got.rows == want.rows
    keys = ("peak_bytes", "spill_events", "spilled_bytes", "partition_spills")
    jmem, pmem = want.stats["memory"], got.stats["memory"]
    assert {k: pmem[k] for k in keys} == {k: jmem[k] for k in keys}
    assert pmem["spill_events"] > 0 and pmem["partition_spills"] == 0
    build = next(op for op in got.stats["operators"]
                 if op["name"] == "HashBuilderOperator")
    assert "hybrid_spill" not in build


def _skewed_join_page(fanout: int, heavy_pid_rows: int,
                      light_pid_rows: int):
    """One bigint key page whose rows are heavily skewed onto a single
    partition of ``fanout`` (returns the page and the heavy pid)."""
    hs = J.HybridJoinState(fanout)
    keys = np.arange(16384, dtype=np.int64)
    pids = hs.partition_ids([keys], [np.zeros(keys.size, bool)],
                            [T.BIGINT], [None])
    heavy = int(np.bincount(pids, minlength=fanout).argmax())
    picked = [keys[pids == heavy][:heavy_pid_rows]]
    for pid in range(fanout):
        if pid != heavy:
            picked.append(keys[pids == pid][:light_pid_rows])
    col = np.concatenate(picked)
    page = DevicePage([T.BIGINT], [torch.from_numpy(col)],
                      [torch.zeros(col.size, dtype=torch.bool)],
                      torch.ones(col.size, dtype=torch.bool), [None])
    return page, heavy


def test_partition_ids_equal_jax():
    """The host partition hash is the JAX engine's, value for value (so
    a key lands in the same partition in both engines), for integer,
    float and null keys at two salts."""
    from trino_tpu import types as JT
    from trino_tpu.ops import join as JJ

    rng = np.random.default_rng(7)
    ints = rng.integers(-2**40, 2**40, 4096)
    floats = rng.standard_normal(4096)
    floats[:3] = [0.0, -0.0, np.nan]
    nulls = rng.random(4096) < 0.1
    for depth in (0, 2):
        pj, jj = J.HybridJoinState(16, depth=depth), \
            JJ.HybridJoinState(16, depth=depth)
        got = pj.partition_ids([ints, floats], [nulls, nulls],
                               [T.BIGINT, T.DOUBLE], [None, None])
        want = jj.partition_ids([ints, floats], [nulls, nulls],
                                [JT.BIGINT, JT.DOUBLE], [None, None])
        assert np.array_equal(got, want)
        assert got.min() >= 0 and got.max() < 16


def test_hybrid_mid_build_revocation_demotes_largest_in_place():
    """One revocation demotes exactly the largest resident partition —
    the rest of the build stays on the device (in place), the pool
    counts one partition spill."""
    pool = QueryMemoryPool(1 << 20, spill_enabled=True)
    ctx = pool.create_context("build")
    bridge = J.JoinBridge()
    op = J.HashBuilderOperator(
        [T.BIGINT], [0], bridge, "cpu", memory_context=ctx,
        hybrid={"fanout": 4, "max_depth": 3})
    page, heavy = _skewed_join_page(4, 1024, 16)
    op.add_input(page)
    with ctx.lock:
        freed = op._revoke()
    hs = bridge.hybrid
    assert freed > 0
    assert hs.demotions == 1
    assert set(hs.spilled_build) == {heavy}, \
        "demotion did not pick the largest resident partition"
    assert hs.resident == frozenset(range(4)) - {heavy}
    assert any(isinstance(p, DevicePage) for p in op._pages), \
        "revocation spilled the whole build instead of one partition"
    assert pool.stats()["partition_spills"] == 1
    assert hs.spill_fraction() > 0.5  # the heavy partition dominated
    ctx.close()
    pool.close()


def test_hybrid_recursive_repartition_depth_bound():
    """An oversized cold partition repartitions with a depth-salted hash
    while depth < max_depth; at the bound it must reserve or raise
    instead of recursing forever."""
    types_ = [T.BIGINT]
    b = J._assemble_build_side(
        types_, [0], [torch.arange(64, dtype=torch.int64)],
        [torch.zeros(64, dtype=torch.bool)],
        torch.ones(64, dtype=torch.bool), [None])
    bridge = J.JoinBridge()
    bridge.set_build(b)
    op = J.LookupJoinOperator(types_, [0], bridge, "inner")
    pool = QueryMemoryPool(64, spill_enabled=True)  # nothing fits
    ctx = pool.create_context("build")
    hs = J.HybridJoinState(4, max_depth=2)
    hs.ctx = ctx
    keys = np.arange(4096, dtype=np.int64)
    sp = J._host_spilled(types_, [keys], [np.zeros(keys.size, bool)],
                         keys.size, [None], "cpu")
    spp = J._host_spilled(types_, [keys[:128]], [np.zeros(128, bool)],
                          128, [None], "cpu")
    # below the bound: splits into depth-1 children at the queue front
    op._deferred = [{"depth": 0, "build": [sp], "probe": [spp]}]
    op._advance_deferred(hs)
    assert hs.repartitions == 1
    assert op._deferred and all(e["depth"] == 1 for e in op._deferred)
    child_rows = sum(int(p.valid.sum())
                     for e in op._deferred for p in e["build"])
    assert child_rows == keys.size  # no rows lost across the split
    assert len(op._deferred) > 1  # the salted hash redistributed it
    # at the bound: no further recursion — the reserve failure surfaces
    op._deferred = [{"depth": 2, "build": [sp], "probe": [spp]}]
    with pytest.raises(MemoryExceededError):
        op._advance_deferred(hs)
    assert hs.repartitions == 1  # did not split past max_depth
    assert hs.max_depth_seen == 1
    ctx.close()
    pool.close()


def test_deferred_pass_joins_every_parked_probe_row():
    """A partition joined in the deferred pass after a recursive split:
    every parked probe row finds its build row, none twice."""
    types_ = [T.BIGINT, T.BIGINT]
    keys = np.arange(2048, dtype=np.int64)
    b = J._assemble_build_side(
        types_, [0], [torch.zeros(16, dtype=torch.int64)] * 2,
        [torch.ones(16, dtype=torch.bool)] * 2,
        torch.zeros(16, dtype=torch.bool), [None, None])
    bridge = J.JoinBridge()
    bridge.set_build(b)
    op = J.LookupJoinOperator(types_, [0], bridge, "inner")
    pool = QueryMemoryPool(40_000, spill_enabled=True)
    ctx = pool.create_context("build")
    hs = J.HybridJoinState(4, max_depth=3)
    hs.ctx = ctx
    build = J._host_spilled(types_, [keys, keys * 10],
                            [np.zeros(keys.size, bool)] * 2, keys.size,
                            [None, None], "cpu")
    probe = J._host_spilled(types_, [keys[::3], keys[::3] + 7],
                            [np.zeros(keys[::3].size, bool)] * 2,
                            keys[::3].size, [None, None], "cpu")
    op._deferred = [{"depth": 0, "build": [build], "probe": [probe]}]
    while op._deferred:
        op._advance_deferred(hs)
    assert hs.repartitions >= 1
    rows = sorted(r for p in op._ready for r in p.to_page().to_rows())
    assert rows == [(k, k + 7, k, 10 * k) for k in keys[::3]]
    ctx.close()
    pool.close()
