"""Plan, result and processor caches and admission batching: the torch
engine against the JAX engine.

The cases of tests/test_query_cache.py, each sent through both engines
(both with ``hbo_enabled=false``) over their own memory
catalogs: the same rows, the same served-by stats (plan cache, result
cache, template), the same error codes and the same cache counters. The
invalidation matrix is the heart: an identical re-submission must hit,
while DDL on a referenced table, a write (the connector's version bump)
and a differing session fingerprint must all miss and recompute.

"Zero traces" has no torch meaning; its counterpart is that a repeat
statement builds no PageProcessor: every one comes from the processor
cache.
"""

import sys
import threading

import pytest

from test_torch_batched import Pair
# the autouse fixture that clears both engines' process-wide template
# seeds and capacity histories before each case
from test_torch_batched import _fresh_process_state  # noqa: F401
from trino_tpu.cache import is_deterministic as j_is_deterministic
from trino_tpu.cache import normalize_statement as j_normalize
from trino_tpu.cache import statement_catalogs as j_statement_catalogs
from trino_tpu.sql.analyzer import Session as JSession
from trino_tpu.sql.parser import parse_statement as j_parse
from trino_tpu_torch import session_properties as SP
from trino_tpu_torch.cache import (ResultCache, is_deterministic,
                                   normalize_statement, statement_catalogs)
from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.expr.compiler import PageProcessor
from trino_tpu_torch.resource_groups import ResourceGroupManager
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.security import (AccessDeniedError,
                                      RuleBasedAccessControl, TableRule)
from trino_tpu_torch.sql.analyzer import Session
from trino_tpu_torch.sql.parser import parse_statement


def kv_pair() -> Pair:
    p = Pair()
    p.execute("create table t (k bigint, v bigint)")
    p.execute("insert into t values (1, 10), (2, 20), (3, 30)")
    return p


def _mem_runner(**kwargs):
    return LocalQueryRunner({"memory": MemoryConnector()},
                            Session(catalog="memory", schema="default"),
                            device="cpu", **kwargs)


# -- shape normalization ----------------------------------------------------


@pytest.mark.parametrize("a,b", [
    ("select v from t where k = 5 and v > 1.5",
     "select v from t where k = 9 and v > 2.5"),
    ("select * from t where k = 5", "select * from t where k = 5.0"),
    ("select v from t where k = 5 or v > 1.5",
     "select v from t where k = 5 and v > 1.5"),
])
def test_normalize_equals_jax(a, b):
    """Shapes and literal vectors equal the JAX engine's: the same
    statements share a shape, the same literal kinds stay apart."""
    got = [normalize_statement(parse_statement(s)) for s in (a, b)]
    want = [j_normalize(j_parse(s)) for s in (a, b)]
    assert [lits for _, lits in got] == [lits for _, lits in want]
    assert (got[0][0] == got[1][0]) == (want[0][0] == want[1][0])
    assert repr(got[0][0]) == repr(want[0][0])


def test_normalize_parameterizes_literals():
    sa, la = normalize_statement(parse_statement(
        "select v from t where k = 5 and v > 1.5"))
    sb, lb = normalize_statement(parse_statement(
        "select v from t where k = 9 and v > 2.5"))
    assert sa == sb and la != lb and hash(sa) == hash(sb)
    assert la == (("long", 5), ("decimal", "1.5"))


def test_statement_catalogs_resolution():
    session = Session(catalog="memory", schema="default")
    jsession = JSession(catalog="memory", schema="default")
    for sql, want in (
            ("select * from t", {"memory"}),
            ("select * from tpch.tiny.orders o join t on o.o_orderkey = t.k",
             {"tpch", "memory"}),
            ("with w as (select 1 x) select * from w", {"memory"})):
        assert statement_catalogs(parse_statement(sql), session) == want
        assert j_statement_catalogs(j_parse(sql), jsession) == want


def test_is_deterministic():
    for sql, want in (("select k from t", True),
                      ("select random()", False)):
        assert is_deterministic(parse_statement(sql)) is want
        assert j_is_deterministic(j_parse(sql)) is want


# -- plan cache: hit path + invalidation matrix -----------------------------


def test_repeat_query_hits_plan_cache_and_reuses_processors(monkeypatch):
    p = kv_pair()
    sql = "select sum(v) s from t where k >= 2"
    assert p.execute(sql).rows == [(50,)]
    built = []
    real_init = PageProcessor.__init__

    def counting_init(self, *a, **kw):
        built.append(self)
        real_init(self, *a, **kw)

    monkeypatch.setattr(PageProcessor, "__init__", counting_init)
    again = p.execute(sql)
    assert again.rows == [(50,)]
    assert again.stats.get("plan_cache") == "hit"
    assert built == [], "a repeat statement must build no processor"
    assert p.counters()["plan_hits"] == 1


def test_write_invalidates_plan_cache():
    p = kv_pair()
    sql = "select sum(v) s from t where k >= 0"
    assert p.execute(sql).rows == [(60,)]
    p.execute("insert into t values (4, 40)")
    res = p.execute(sql)
    assert res.rows == [(100,)] and res.stats.get("plan_cache") != "hit"
    assert p.counters()["plan_invalidations"] >= 1
    p.execute("delete from t where k = 4")
    assert p.execute(sql).rows == [(60,)]
    p.counters()


def test_ddl_on_referenced_table_invalidates():
    p = kv_pair()
    p.execute("create table d (x bigint)")
    p.execute("insert into d values (7)")
    sql = "select count(*) c from d"
    assert p.execute(sql).rows == [(1,)]
    assert p.execute(sql).stats.get("plan_cache") == "hit"
    p.execute("drop table d")
    p.execute("create table d (x bigint)")
    res = p.execute(sql)
    assert res.stats.get("plan_cache") != "hit" and res.rows == [(0,)]
    p.counters()


def test_session_fingerprint_differs():
    p = kv_pair()
    sql = "select max(v) m from t"
    p.execute(sql)
    assert p.execute(sql).stats.get("plan_cache") == "hit"
    p.execute("set session desired_splits = 3")
    res = p.execute(sql)
    assert res.stats.get("plan_cache") != "hit" and res.rows == [(30,)]
    assert p.execute(sql).stats.get("plan_cache") == "hit"
    p.counters()


def test_plan_cache_disabled_by_property():
    p = kv_pair()
    p.execute("set session plan_cache_enabled = false")
    sql = "select count(*) c from t"
    p.execute(sql)
    assert p.execute(sql).stats.get("plan_cache") is None
    assert p.counters()["plan_hits"] == 0


def test_system_catalog_uncacheable():
    p = kv_pair()
    sql = "select count(*) c from system.runtime.metrics"
    p.t.execute(sql)
    res = p.t.execute(sql)
    assert res.stats.get("plan_cache") is None
    assert p.t.query_cache.cache_key(
        p.t.query_cache.parse(sql, p.t.session), p.t.session) is None


def test_system_runtime_tables_not_ported_raise():
    """Checks that both tables WORK with the JAX engine's columns; the
    name, from when they raised, is kept so the test's id stays the same.

    Both tables are ported now: a scan of either returns the JAX
    engine's columns instead of raising NOT_SUPPORTED (their rows are
    held against the JAX engine's in tests/test_torch_telemetry.py)."""
    p = kv_pair()
    for table in ("kernels", "plan_stats"):
        sql = f"select * from system.runtime.{table}"
        assert p.t.execute(sql).column_names == \
            p.j.execute(sql).column_names


# -- result cache -----------------------------------------------------------


def test_result_cache_hit_and_write_invalidation():
    p = kv_pair()
    p.execute("set session result_cache_enabled = true")
    sql = "select sum(v) s from t where k <= 2"
    a = p.execute(sql)
    b = p.execute(sql)
    assert b.stats.get("result_cache") == "hit"
    assert b.rows == a.rows == [(30,)]
    b.rows.append(("junk",))
    assert p.execute(sql).rows == [(30,)]
    p.execute("insert into t values (0, 5)")
    c = p.execute(sql)
    assert c.stats.get("result_cache") != "hit" and c.rows == [(35,)]
    p.execute("delete from t where k = 0")
    assert p.execute(sql).rows == [(30,)]
    p.counters()


def test_result_cache_memory_bounded():
    rc = ResultCache(max_bytes=8_192)
    rows = [(i, "x" * 40) for i in range(40)]
    for i in range(12):
        rc.store(("shape", i), ["a", "b"], None, list(rows))
    assert rc.evictions > 0
    assert rc.reserved_bytes <= 8_192
    rc.store(("big",), ["a"], None, [("y" * 200,)] * 400)
    assert rc.lookup(("big",)) is None
    assert rc.reserved_bytes <= 8_192


# -- admission batching -----------------------------------------------------


def test_execute_batch_equal_and_coalesced():
    p = kv_pair()
    sqls = ["select sum(v) s from t where k >= 1",
            "select sum(v) s from t where k >= 2",
            "select sum(v) s from t where k >= 1",   # identical: coalesces
            "select count(*) c from t"]              # shape diverges
    serial = [p.t.execute(s).rows for s in sqls]
    for s in sqls:
        p.j.execute(s)
    out = p.batch(sqls)
    assert [r.rows for r in out] == serial
    assert p.counters()["coalesced"] == 1


def test_execute_batch_failure_is_per_statement():
    p = kv_pair()
    out = p.batch(["select sum(v) s from t", "select no_such_column from t"])
    assert out[0].rows == [(60,)]
    assert isinstance(out[1], Exception)
    p.counters()


def test_protocol_batch_formation_and_fallback():
    """A backlog of same-shape statements drains as ONE batch under one
    admission slot; a divergent shape is left for its own drain."""
    from trino_tpu_torch.server.protocol import ProtocolServer, _QueryState

    rg = ResourceGroupManager.from_config(
        {"groups": [{"name": "global", "max_concurrency": 4}]})
    r = _mem_runner(resource_groups=rg)
    r.execute("create table t (k bigint, v bigint)")
    r.execute("insert into t values (1, 10), (2, 20)")
    srv = ProtocolServer(r)   # not started: drive internals directly
    admitted0 = rg.roots[0].total_admitted
    try:
        texts = ["select sum(v) s from t where k >= 1",
                 "select sum(v) s from t where k >= 2",
                 "select count(*) c from t"]
        states = []
        for i, sql in enumerate(texts):
            q = _QueryState(f"q{i}", sql)
            q.shape = r.query_cache.parse(sql, r.session).shape
            states.append(q)
            srv._backlog.append(q)
        srv._drain_batch()
        assert [s.state for s in states] == ["FINISHED", "FINISHED",
                                             "QUEUED"]
        srv._drain_batch()
        assert states[2].state == "FINISHED"
        assert [s.result.rows for s in states] == [[(30,)], [(20,)], [(2,)]]
        assert rg.roots[0].total_admitted - admitted0 == 2
    finally:
        srv.stop()


def test_protocol_user_header_routes_resource_group():
    from trino_tpu_torch.client import Client
    from trino_tpu_torch.server.protocol import ProtocolServer

    rg = ResourceGroupManager.from_config({"groups": [
        {"name": "tenants", "user": "tenant-.*", "max_concurrency": 4},
        {"name": "global", "max_concurrency": 4}]})
    r = _mem_runner(resource_groups=rg)
    r.execute("create table t (k bigint)")
    r.execute("insert into t values (1)")
    srv = ProtocolServer(r).start()
    try:
        res = Client(srv.uri, user="tenant-3").execute(
            "select count(*) c from t")
        assert res.rows == [[1]]
        tenants = {name: adm for name, adm, _, _ in rg.counter_stats()}
        assert tenants["tenants"] == 1
    finally:
        srv.stop()


def test_protocol_eviction_timer_is_deterministic():
    import json
    import time
    import urllib.request

    from trino_tpu_torch.server.protocol import ProtocolServer

    srv = ProtocolServer(_mem_runner(), query_ttl=0.6,
                         evict_interval=0.15).start()
    try:
        req = urllib.request.Request(srv.uri + "/v1/statement",
                                     data=b"select 1", method="POST")
        doc = json.loads(urllib.request.urlopen(req).read())
        deadline = time.time() + 10
        while doc["id"] in srv.queries and time.time() < deadline:
            time.sleep(0.1)
        assert doc["id"] not in srv.queries and len(srv.queries) == 0
    finally:
        srv.stop()


def test_cache_counters_via_metrics_and_sql():
    p = kv_pair()
    p.execute("select sum(v) s from t")
    for r in (p.j, p.t):
        fams = {f["name"] for f in r.metrics_families()}
        assert {"trino_plan_cache_total", "trino_result_cache_total",
                "trino_processor_cache_total",
                "trino_admission_batches_total"} <= fams
    rows = p.t.execute("select name, value from system.runtime.metrics "
                       "where name like 'trino_plan_cache%'").rows
    assert "trino_plan_cache_total" in {n for n, _v in rows}


def test_runner_families_equal_jax():
    """The runner's families are the JAX engine's, the exchange and
    rebalance counters included. Both engines'
    process-wide history stores and profilers start empty, so the
    families that read them are absent from both (on the CPU neither
    engine reports device memory)."""
    from trino_tpu.telemetry import profiler as j_profiler
    from trino_tpu.telemetry import stats_store as j_stats_store
    from trino_tpu_torch.telemetry import profiler, stats_store

    for store in (stats_store.store(), j_stats_store.store()):
        store.clear()
    profiler.reset()
    j_profiler.reset()
    p = kv_pair()
    p.execute("select sum(v) s from t")
    want = {f["name"] for f in p.j.metrics_families()}
    assert {"trino_jit_traces_total", "trino_exchange_splits_total",
            "trino_writer_rebalances_total"} <= want
    assert {f["name"] for f in p.t.metrics_families()} == want


def test_resource_group_counters_exported():
    rg = ResourceGroupManager.from_config(
        {"groups": [{"name": "global", "max_concurrency": 2}]})
    r = _mem_runner(resource_groups=rg)
    r.execute("create table t (k bigint)")
    r.execute("select count(*) from t")
    fams = {f["name"]: f for f in r.metrics_families()}
    assert "trino_resource_group_queue_peak" in fams
    admitted = [v for lbl, v in
                fams["trino_resource_group_admissions_total"]["samples"]
                if lbl.get("kind") == "admitted"]
    assert admitted and admitted[0] >= 1


def test_session_properties_registered():
    for name, type_ in (("plan_cache_enabled", "boolean"),
                        ("plan_cache_entries", "integer"),
                        ("result_cache_enabled", "boolean"),
                        ("admission_batching_enabled", "boolean"),
                        ("admission_batch_max", "integer")):
        assert SP.REGISTRY[name].type == type_
    props = {}
    SP.set_property(props, "admission_batch_max", "8")
    assert props["admission_batch_max"] == 8
    with pytest.raises(Exception):
        SP.set_property(props, "admission_batch_max", "1")


def test_plan_cache_lru_bound():
    p = kv_pair()
    p.execute("set session plan_cache_entries = 4")
    # templates would serve the repeats without storing plans
    p.execute("set session plan_template_enabled = false")
    for i in range(8):
        p.execute(f"select sum(v) s from t where k > {i}")
    assert len(p.t.query_cache.plans) <= 4
    assert p.t.query_cache.plans.evictions >= 4
    assert p.t.query_cache.plans.evictions == \
        p.j.query_cache.plans.evictions


def test_result_cache_is_user_scoped_and_rechecks_acl():
    acl = RuleBasedAccessControl([
        TableRule(user="alice", privileges=["SELECT", "INSERT",
                                            "OWNERSHIP"]),
        TableRule(user="trino", privileges=["SELECT", "INSERT",
                                            "OWNERSHIP"]),
    ])
    r = _mem_runner(access_control=acl)
    r.execute("create table t (k bigint)")
    r.execute("insert into t values (1)")
    r.execute("set session result_cache_enabled = true")
    sql = "select count(*) c from t"
    assert r.execute(sql, user="alice").rows == [(1,)]
    assert r.execute(sql, user="alice").stats.get("result_cache") == "hit"
    with pytest.raises(AccessDeniedError):
        r.execute(sql, user="bob")
    acl.rules = [rule for rule in acl.rules if rule.user != "alice"]
    with pytest.raises(AccessDeniedError):
        r.execute(sql, user="alice")


def test_execute_batch_never_coalesces_writes():
    p = kv_pair()
    p.execute("create table w (k bigint)")
    out = p.batch(["insert into w values (1)", "insert into w values (1)"])
    assert not any(isinstance(o, Exception) for o in out)
    assert p.execute("select count(*) c from w").rows == [(2,)]


def test_concurrent_repeat_queries_share_processors():
    """Six concurrent executions of a cached plan share PageProcessor
    instances; the processor's lock keeps every result right."""
    p = kv_pair()
    sql = "select sum(v) s from t where k >= 1"
    expect = p.t.execute(sql).rows
    out = [None] * 6

    def go(i):
        out[i] = p.t.execute(sql).rows

    threads = [threading.Thread(target=go, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert all(r == expect for r in out)


def test_four_concurrent_executes_equal_serial():
    """Four threads run four different statements of two shapes at once
    against the shared processor cache (templates, grouped and global
    aggregations, string keys); each equals the serial run, and the
    processors they share come from the cache."""
    from trino_tpu_torch.connectors.tpch import TpchConnector

    r = LocalQueryRunner({"tpch": TpchConnector()},
                         Session(catalog="tpch", schema="tiny"),
                         device="cpu")
    sqls = ["select l_returnflag, l_linestatus, sum(l_quantity), "
            "avg(l_extendedprice), count(*) from lineitem "
            "where l_quantity < %d group by l_returnflag, l_linestatus "
            "order by 1, 2" % q for q in (20, 40)] + \
        ["select sum(l_extendedprice * l_discount) from lineitem "
         "where l_discount between %s and %s" % b
         for b in (("0.02", "0.04"), ("0.05", "0.07"))]
    serial = [r.execute(s).rows for s in sqls]
    hits0 = r.query_cache.processors.hits
    out = [None] * 4

    def go(i):
        out[i] = r.execute(sqls[i]).rows

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)   # switch threads often: races show
    try:
        for _ in range(2):
            threads = [threading.Thread(target=go, args=(i,))
                       for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive()
            assert out == serial
    finally:
        sys.setswitchinterval(interval)
    assert r.query_cache.processors.hits > hits0
