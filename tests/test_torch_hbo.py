"""History-based statistics: the torch engine against the JAX engine.

The one-device cases of tests/test_hbo.py (and the hybrid join's
second-run fan-out of tests/test_memory_governance.py), each sent
through both engines over their own memory catalogs with the same lying
statistics, and both engines' process-wide history stores cleared
before and after every case. Both must fingerprint a statement and its
plan nodes alike, plan the same EXPLAIN before and after a first run
(the matmul flip with ``source=hbo``, the star join's ``[hbo]`` /
``(hbo reordered)`` order), return the same rows, invalidate the same
cached plans, record the same actuals (rows and runs exactly; the wall,
bytes and operations fields measure each engine's own work, so they are
left out of the comparisons), and serve them back through the same
surfaces: EXPLAIN ANALYZE's Q-errors, the slow-query log, the progress
fallback, the admission hint, ``system.runtime.plan_stats`` and the
``trino_hbo_*`` families. A burst records one history per real lane and
pads to the JAX engine's depth. Q-errors (DOUBLE) compare within a
relative 1e-9: both are ratios of the same row counts and estimates.
"""

import json
import math
import warnings

import pytest

from test_torch_tpch_q1 import _same_rows
from trino_tpu.cache import normalize_statement as j_normalize
from trino_tpu.connectors import spi as jspi
from trino_tpu.connectors.memory import MemoryConnector as JMemory
from trino_tpu.connectors.tpch import TpchConnector as JTpch
from trino_tpu.events import EventListener as JListener
from trino_tpu.ops import join as JJ
from trino_tpu.planner.plan import JoinNode as JJoinNode
from trino_tpu.resources.tpch_queries import TPCH_QUERIES
from trino_tpu.runner import LocalQueryRunner as JRunner
from trino_tpu.sql.analyzer import Session as JSession
from trino_tpu.sql.parser import parse_statement as j_parse
from trino_tpu.telemetry import stats_store as jss
from trino_tpu.telemetry.metrics import parse_prometheus, render_prometheus
from trino_tpu.telemetry.progress import QueryProgress as JProgress
from trino_tpu_torch.cache import normalize_statement
from trino_tpu_torch.connectors import spi
from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.events import EventListener
from trino_tpu_torch.ops import join as PJ
from trino_tpu_torch.planner.plan import JoinNode
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.sql.analyzer import Session
from trino_tpu_torch.sql.parser import parse_statement
from trino_tpu_torch.telemetry import stats_store as pss
from trino_tpu_torch.telemetry.progress import QueryProgress

#: fields of a recorded node that measure the engine's own work
MEASURED = ("wall_ms", "bytes", "flops", "peak_bytes")


@pytest.fixture(autouse=True)
def _fresh_stores():
    """Both engines' process-wide stores start empty and are left
    empty."""
    for s in (pss.store(), jss.store()):
        s.clear()
    yield
    for s in (pss.store(), jss.store()):
        s.clear()


# ---------------------------------------------------------------------------
# the lying connector, for either engine: truthful data, wrong statistics


class _LyingMetadata:
    def __init__(self, inner, lies):
        self._inner = inner
        self._lies = lies

    def get_statistics(self, table):
        return self._lies.get((table.schema, table.table)) \
            or self._inner.get_statistics(table)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _lying(base):
    class Lying(base):
        def __init__(self, lies):
            super().__init__()
            self.lies = lies

        def metadata(self):
            return _LyingMetadata(super().metadata(), self.lies)

    return Lying


class Pair:
    """One runner per engine over its own memory catalog (lying
    statistics from ``lies(spi_module)``), driven alike."""

    def __init__(self, lies=None, connector=None, **props):
        def conn(base, mod):
            if connector is not None:
                return connector[0 if mod is jspi else 1]()
            return _lying(base)(lies(mod) if lies else {})

        self.j = JRunner({"memory": conn(JMemory, jspi)},
                         JSession(catalog="memory", schema="default",
                                  properties=dict(props)))
        self.t = LocalQueryRunner({"memory": conn(MemoryConnector, spi)},
                                  Session(catalog="memory",
                                          schema="default",
                                          properties=dict(props)),
                                  device="cpu")

    def run(self, sql, **kw):
        """Both engines' results; the same rows in the same order."""
        want = self.j.execute(sql, **kw)
        got = self.t.execute(sql, **kw)
        _same_rows(got.rows, want.rows)
        return want, got

    def explain(self, sql):
        want, got = self.j.explain(sql), self.t.explain(sql)
        assert got == want
        return got


def _join_lies(m):
    return {
        ("default", "dim"): m.TableStatistics(
            row_count=50_000_000.0,
            columns={"k": m.ColumnStatistics(distinct_count=10.0,
                                             min_value=0, max_value=99),
                     "name": m.ColumnStatistics(distinct_count=10.0)}),
        ("default", "fact"): m.TableStatistics(row_count=500_000_000.0),
    }


def join_pair(**props) -> Pair:
    """fact(4 rows) join dim(3 rows), with statistics claiming both are
    in the hundreds of millions: the matmul probe is cost-model
    ineligible until history corrects the build side."""
    p = Pair(_join_lies, **props)
    p.run("create table fact (fk bigint, amt bigint)")
    p.run("create table dim (k bigint, name bigint)")
    p.run("insert into fact values (1, 10), (2, 20), (3, 30), (1, 40)")
    p.run("insert into dim values (1, 100), (2, 200), (3, 300)")
    return p


JOIN_SQL = ("select f.fk, d.name, f.amt from fact f "
            "join dim d on f.fk = d.k order by f.amt")


def _star_lies(m):
    return {("default", "f"): m.TableStatistics(row_count=500_000.0),
            ("default", "d1"): m.TableStatistics(row_count=2.0),
            ("default", "d2"): m.TableStatistics(row_count=50_000.0)}


def star_pair(**props) -> Pair:
    """fact(12) joining d1(50) and d2(2), the statistics inverting the
    dimension sizes: estimates join d1 first, actuals d2."""
    p = Pair(_star_lies, **props)
    p.run("create table f (k bigint, j bigint, v bigint)")
    p.run("create table d1 (k bigint, a bigint)")
    p.run("create table d2 (j bigint, b bigint)")
    p.run("insert into f values " + ", ".join(
        f"({i % 3 + 1}, {i % 2 + 1}, {i * 10})" for i in range(12)))
    p.run("insert into d1 values " + ", ".join(
        f"({i + 1}, {i * 100})" for i in range(50)))
    p.run("insert into d2 values (1, 7), (2, 8)")
    return p


STAR_SQL = ("select f.k, f.j, f.v, d1.a, d2.b from f "
            "join d1 on f.k = d1.k join d2 on f.j = d2.j "
            "order by f.v")


def kv_pair(**props) -> Pair:
    p = Pair(**props)
    p.run("create table t (k bigint, v bigint)")
    p.run("insert into t values (1, 10), (2, 20), (3, 30)")
    return p


def _snapshot(store):
    """A store's rows, the measured fields left out, in a stable
    order."""
    return sorted((tuple(sorted((k, v) for k, v in e.items()
                                if k not in MEASURED))
                   for e in store.snapshot()), key=repr)


def _same_history():
    assert _snapshot(pss.store()) == _snapshot(jss.store())
    assert pss.store().counters() == jss.store().counters()


# ---------------------------------------------------------------------------
# fingerprints


FP_SQL = ["select v from t where k = 5", "select v from t where k = 9",
          "select v from t where k < 9", JOIN_SQL, STAR_SQL] \
    + [TPCH_QUERIES[q] for q in sorted(TPCH_QUERIES)]


@pytest.mark.parametrize("sql", FP_SQL,
                         ids=[f"sql{i}" for i in range(len(FP_SQL))])
def test_statement_fingerprint_equals_jax(sql):
    """The shape digest of a statement is the JAX engine's: one history
    stream per statement shape in both engines."""
    got = pss.statement_fingerprint(
        normalize_statement(parse_statement(sql))[0])
    want = jss.statement_fingerprint(j_normalize(j_parse(sql))[0])
    assert got == want


def test_literal_vectors_share_one_fingerprint():
    fp = [pss.statement_fingerprint(normalize_statement(
        parse_statement(s))[0]) for s in FP_SQL[:3]]
    assert fp[0] == fp[1] != fp[2]


def _node_fps(root, fp):
    out = []

    def walk(n):
        out.append((type(n).__name__, fp(n)))
        for s in n.sources:
            walk(s)

    walk(root)
    return out


@pytest.mark.parametrize("qid", sorted(TPCH_QUERIES))
def test_plan_node_fingerprints_equal_jax(qid):
    """Node for node, the optimized plans of the 22 TPC-H queries carry
    the JAX engine's canonical fingerprints."""
    jr = JRunner({"tpch": JTpch()},
                 JSession(catalog="tpch", schema="tiny"))
    pr = LocalQueryRunner({"tpch": TpchConnector()},
                          Session(catalog="tpch", schema="tiny"),
                          device="cpu")
    sql = TPCH_QUERIES[qid]
    assert _node_fps(pr.create_plan(sql), pss.plan_node_fp) == \
        _node_fps(jr.create_plan(sql), jss.plan_node_fp)


def test_plan_node_fp_canonicalizes_literals_and_strategy():
    p = join_pair()
    for r, mod in ((p.j, jss), (p.t, pss)):
        a, b = (_node_fps(r.create_plan(
            f"select f.amt from fact f where f.fk = {lit}"), mod.plan_node_fp)
            for lit in (5, 9))
        assert a == b

        def find_join(n):
            if isinstance(n, (JoinNode, JJoinNode)):
                return n
            for s in n.sources:
                got = find_join(s)
                if got is not None:
                    return got

        jn = find_join(r.create_plan(JOIN_SQL))
        before = mod.plan_node_fp(jn)
        jn.strategy, jn.strategy_detail = "matmul", "whatever"
        assert mod.plan_node_fp(jn) == before


# ---------------------------------------------------------------------------
# store mechanics, the same steps on both engines' stores


def _ewma(m):
    st = m.RuntimeStatsStore()
    st.record_query("s1", "snap", [{"fp": "n1", "name": "Scan",
                                    "rows": 100.0}])
    first = st.lookup("s1", "n1", "snap").rows
    st.record_query("s1", "snap", [{"fp": "n1", "name": "Scan",
                                    "rows": 200.0}])
    h = st.lookup("s1", "n1", "snap")
    assert first == 100.0
    assert h.rows == pytest.approx((1 - m.DEFAULT_EWMA_ALPHA) * 100.0
                                   + m.DEFAULT_EWMA_ALPHA * 200.0)
    return first, h.rows, h.runs


def _material(m):
    st = m.RuntimeStatsStore()
    return (st.record_query("s1", "snap", [
        {"fp": "n1", "name": "Filter", "rows": 1000.0, "est_rows": 1.0}]),
        st.record_query("s2", "snap", [
            {"fp": "n2", "name": "Scan", "rows": 1000.0, "est_rows": 1.0,
             "decision": True}]),
        st.record_query("s2", "snap", [
            {"fp": "n2", "name": "Scan", "rows": 1000.0,
             "est_rows": 1000.0, "decision": True}]))


def _versions(m):
    st = m.RuntimeStatsStore()
    st.record_query("s1", "snapA", [{"fp": "n1", "name": "Scan",
                                     "rows": 10.0}])
    out = [st.lookup("s1", "n1", "snapA").rows,
           st.lookup("s1", "n1", "snapB"), st.invalidations,
           st.lookup("s1", "n1", "snapA")]
    st.record_query("s1", "snapB", [{"fp": "n1", "name": "Scan",
                                     "rows": 20.0}])
    out.append(st.lookup("s1", "n1", "snapB").rows)
    st.record_query("s1", "snapC", [{"fp": "n1", "name": "Scan",
                                     "rows": 99.0}])
    h = st.lookup("s1", "n1", "snapC")
    return out + [h.rows, h.runs]


def _lru(m):
    st = m.RuntimeStatsStore(max_statements=4)
    for i in range(10):
        st.record_query(f"s{i}", "snap", [{"fp": "n", "name": "X",
                                           "rows": 1.0}])
    return (st.counters()["statements"],
            st.lookup("s9", "n", "snap") is not None,
            st.lookup("s0", "n", "snap") is None)


def _quantiles(m):
    st = m.RuntimeStatsStore()
    st.record_query("s1", "snap", [
        {"fp": f"n{i}", "name": "Scan", "rows": 10.0,
         "est_rows": 10.0 * (2 ** i)} for i in range(4)])
    return (st.qerror_quantile(0.5), st.qerror_quantile(0.9),
            m.RuntimeStatsStore().qerror_quantile(0.5))


def _merge(m):
    return m.merge_actuals([
        [{"fp": "a", "name": "Scan", "rows": 10.0, "bytes": 0.0,
          "wall_ms": 1.0, "flops": 0.0, "peak_bytes": 0.0}],
        [{"fp": "a", "name": "Scan", "rows": 5.0, "bytes": 0.0,
          "wall_ms": 2.0, "flops": 0.0, "peak_bytes": 0.0,
          "adaptive": {"verdict": "aggregate"}}]])


def _q_errors(m):
    return m.q_error(10, 1000), m.q_error(1000, 10), m.q_error(0, 0)


def _flips(m):
    st = m.RuntimeStatsStore()
    st.record_query("s", "snap", [{"fp": "n", "name": "X", "rows": 1.0}])
    st.note_plan_flip("join_order")
    st.note_plan_flip("distribution")
    st.note_plan_flip("distribution")
    return st.families(), st.counters()


def _spill_record(m):
    rec = {"fanout": 16, "source": "local", "fraction": 0.25,
           "partitions_spilled": 3, "demotions": 3, "repartitions": 0,
           "max_depth": 0}
    h = m.NodeHistory("fp0", "JoinNode")
    h.merge({"rows": 100.0, "spill": rec}, alpha=0.3)
    h.merge({"rows": 120.0}, alpha=0.3)
    kept = h.spill
    h.merge({"rows": 90.0, "spill": dict(rec, fanout=32)}, alpha=0.3)
    back = m.NodeHistory.from_dict(h.to_dict())
    return kept, back.spill, back.runs, back.rows


STORE_CASES = {"ewma": _ewma, "material": _material,
               "data_version": _versions, "bounded_lru": _lru,
               "qerror_quantiles": _quantiles, "merge_actuals": _merge,
               "q_error": _q_errors, "plan_flips": _flips,
               "spill_record": _spill_record}


@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_store_mechanics_equal_jax(case):
    """EWMA merge, material misestimates, snapshot invalidation both
    ways, the bounded LRU, Q-error quantiles, shard merging, the
    plan-flip family and the spill record: the same steps give the same
    values (floats exactly — the same float operations in the same
    order)."""
    got, want = STORE_CASES[case](pss), STORE_CASES[case](jss)
    assert got == want


def test_persistence_roundtrip_and_corrupt_sidecar(tmp_path):
    path = str(tmp_path / "hbo.json")
    st = pss.RuntimeStatsStore()
    st.record_query("s1", "snapA",
                    [{"fp": "n1", "name": "Scan", "rows": 42.0,
                      "peak_bytes": 1024.0,
                      "adaptive": {"verdict": "passthrough"}}],
                    scan_rows=42.0, peak_bytes=2048.0)
    st.save(path)
    fresh = jss.RuntimeStatsStore()      # the JAX engine reads it back
    assert fresh.load(path) is True
    h = fresh.lookup("s1", "n1", "snapA")
    assert (h.rows, h.runs, h.adaptive) == (42.0, 1,
                                            {"verdict": "passthrough"})
    assert fresh.statement_hint("s1", "snapA")["peak_bytes"] == 2048.0
    bad = tmp_path / "bad.json"
    empty = pss.RuntimeStatsStore()
    for body in ("{this is not json", json.dumps({"something": "else"})):
        bad.write_text(body)
        with pytest.warns(RuntimeWarning, match="corrupt"):
            assert empty.load(str(bad)) is False
    assert empty.corrupt_loads == 2
    assert empty.counters()["statements"] == 0


def test_sidecars_after_the_same_runs_are_equal(tmp_path):
    """Both engines write the same sidecar after the same runs: the
    same statements, snapshots, scanned rows and runs, and per node the
    same fingerprint, name, rows, runs and records (the measured fields
    aside)."""
    paths = [str(tmp_path / "jax.json"), str(tmp_path / "torch.json")]
    p = Pair(_join_lies)
    for r, path in ((p.j, paths[0]), (p.t, paths[1])):
        r.session.properties["hbo_store_path"] = path
    for sql in ("create table fact (fk bigint, amt bigint)",
                "create table dim (k bigint, name bigint)",
                "insert into fact values (1, 10), (2, 20), (3, 30), "
                "(1, 40)",
                "insert into dim values (1, 100), (2, 200), (3, 300)",
                JOIN_SQL, JOIN_SQL):
        p.run(sql)

    def body(path):
        with open(path) as f:
            doc = json.load(f)
        for s in doc["statements"]:
            s.pop("peak_bytes")
            for n in s["nodes"]:
                for k in MEASURED:
                    n.pop(k)
            s["nodes"].sort(key=lambda n: n["fp"])
        return doc

    assert body(paths[1]) == body(paths[0])


# ---------------------------------------------------------------------------
# the loop: a misestimated join flips to matmul on a re-run


def test_misestimated_join_flips_to_matmul_on_rerun():
    p = join_pair()
    ex1 = p.explain(JOIN_SQL)
    assert "strategy=matmul" not in ex1
    want1, got1 = p.run(JOIN_SQL)
    assert got1.stats["hbo"] == want1.stats["hbo"]
    assert got1.stats["hbo"]["material"] is True
    assert p.t.query_cache.plans.hbo_invalidations == \
        p.j.query_cache.plans.hbo_invalidations >= 1
    ex2 = p.explain(JOIN_SQL)
    assert "strategy=matmul" in ex2 and "source=hbo" in ex2
    _want2, got2 = p.run(JOIN_SQL)
    assert got2.rows == got1.rows
    want3, got3 = p.run(JOIN_SQL)
    assert got3.stats.get("plan_cache") == \
        want3.stats.get("plan_cache") == "hit"
    _same_history()


def test_hbo_disabled_restores_pre_hbo_plan():
    p = join_pair(hbo_enabled=False)
    want1, got1 = p.run(JOIN_SQL)
    assert "hbo" not in got1.stats and "hbo" not in want1.stats
    c = pss.store().counters()
    assert c["records"] == 0 and c["misses"] == 0
    _want2, got2 = p.run(JOIN_SQL)
    assert got2.stats.get("plan_cache") == "hit"
    assert p.t.query_cache.plans.hbo_invalidations == 0
    assert "strategy=matmul" not in p.explain(JOIN_SQL)


def test_literal_sibling_shares_history():
    p = join_pair()
    tpl = ("select f.fk, d.name, f.amt from fact f "
           "join dim d on f.fk = d.k where f.amt >= {} order by f.amt")
    p.run(tpl.format(0))
    ex = p.explain(tpl.format(15))
    assert "source=hbo" in ex and "strategy=matmul" in ex


def test_sidecar_survives_process_restart(tmp_path):
    path = str(tmp_path / "hbo.json")
    p = join_pair(hbo_store_path=path)
    _, got1 = p.run(JOIN_SQL)
    pss.store().clear()
    fresh = join_pair(hbo_store_path=path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ex = fresh.t.explain(JOIN_SQL)
    assert "strategy=matmul" in ex and "source=hbo" in ex
    assert fresh.t.execute(JOIN_SQL).rows == got1.rows


# ---------------------------------------------------------------------------
# the star join: history reorders on a re-run


def _scan_order(explain_text, *tables):
    pos = {t: explain_text.find(f"memory.default.{t}") for t in tables}
    assert all(v >= 0 for v in pos.values()), explain_text
    return sorted(tables, key=lambda t: pos[t])


def test_hbo_reorders_join_order_on_rerun():
    p = star_pair()
    ex1 = p.explain(STAR_SQL)
    assert "(hbo reordered)" not in ex1
    assert _scan_order(ex1, "d1", "d2") == ["d1", "d2"]
    _, got1 = p.run(STAR_SQL)
    assert got1.stats["hbo"]["material"] is True
    ex2 = p.explain(STAR_SQL)
    line = next(x for x in ex2.splitlines() if "ReorderJoins" in x)
    assert "[hbo]" in line and "(hbo reordered)" in line
    assert _scan_order(ex2, "f", "d1", "d2") != \
        _scan_order(ex1, "f", "d1", "d2")
    assert pss.store().plan_flips == jss.store().plan_flips
    assert pss.store().plan_flips.get("join_order", 0) >= 1
    _, got2 = p.run(STAR_SQL)
    assert got2.rows == got1.rows == sorted(got1.rows, key=lambda t: t[2])
    _same_history()


def test_reorder_gate_keeps_connector_order():
    p = star_pair(hbo_reorder_joins_enabled=False)
    p.run(STAR_SQL)
    ex = p.explain(STAR_SQL)
    assert "(hbo reordered)" not in ex
    assert _scan_order(ex, "d1", "d2") == ["d1", "d2"]
    assert pss.store().plan_flips.get("join_order", 0) == 0


# ---------------------------------------------------------------------------
# EXPLAIN ANALYZE, the slow-query log, progress, admission


def _analyze_tail(rows):
    """Operator lines' (name, rows, est, q) and the worst-misestimate
    line of an EXPLAIN ANALYZE: the parts history adds."""
    out = []
    for (line,) in rows:
        s = line.strip()
        if " [est " in s:
            name = s.split(":")[0]
            est = s.split(" [est ")[1]
            out.append((name, s.split(":")[1].split(" rows")[0].strip(),
                        est))
        elif s.startswith("Worst misestimate:"):
            out.append((s,))
    return out


def test_explain_analyze_renders_qerror_and_worst():
    p = join_pair()
    p.run(JOIN_SQL)
    want = p.j.execute("explain analyze " + JOIN_SQL)
    got = p.t.execute("explain analyze " + JOIN_SQL)
    text = "\n".join(r[0] for r in got.rows)
    assert "q=" in text and "est " in text and "Worst misestimate:" in text
    assert _analyze_tail(got.rows) == _analyze_tail(want.rows)


def _slow_records(runner):
    events = []

    base = JListener if isinstance(runner, JRunner) else EventListener

    class Listener(base):
        def query_completed(self, e):
            events.append(e)

    runner.event_manager.listeners.append(Listener())
    return events


def test_slow_query_log_carries_worst_misestimate():
    p = join_pair(slow_query_log_threshold=1e-9)
    jev, tev = _slow_records(p.j), _slow_records(p.t)
    p.run(JOIN_SQL)
    worst = []
    for events in (jev, tev):
        slow = [e for e in events if (e.stats or {}).get("slow_query")]
        assert slow, "no slow-query record fired"
        rec = slow[-1].stats["slow_query"]
        assert rec["threshold_s"] == 1e-9 and rec["wall_ms"] > 0
        worst.append(rec["worst_misestimate"])
    assert worst[1] == worst[0] and worst[1]["qerror"] >= 2.0
    sql = "select slow from system.runtime.queries where slow is not null"
    rows = p.t.execute(sql).rows
    assert any("misest=" in r[0] for r in rows)


class _Statless:
    """A memory connector reporting no statistics at all."""

    def __new__(cls, base, mod):
        class Statless(base):
            def metadata(self):
                inner = super().metadata()

                class M:
                    def get_statistics(self, table, _inner=inner):
                        return mod.TableStatistics()

                    def __getattr__(self, name, _inner=inner):
                        return getattr(_inner, name)

                return M()

        return Statless()


def test_progress_falls_back_to_hbo_actuals():
    p = Pair(connector=(lambda: _Statless(JMemory, jspi),
                        lambda: _Statless(MemoryConnector, spi)))
    p.run("create table t (k bigint)")
    p.run("insert into t values (1), (2), (3)")
    sql = "select count(*) c from t"
    seen = []
    for run in range(2):
        progs = (JProgress(f"j{run}"), QueryProgress(f"t{run}"))
        p.j.execute(sql, progress=progs[0])
        p.t.execute(sql, progress=progs[1])
        assert (progs[1].total_rows, progs[1].estimate_source) == \
            (progs[0].total_rows, progs[0].estimate_source)
        seen.append((progs[1].total_rows, progs[1].estimate_source))
    assert seen == [(0, "connector"), (3, "hbo")]


def test_admission_hint_lowers_memory_charge():
    from trino_tpu_torch.resource_groups import (ResourceGroupManager,
                                                 ResourceGroupSpec)

    p = kv_pair()
    p.t.resource_groups = ResourceGroupManager([ResourceGroupSpec("all")])
    sql = "select sum(k) s from t"
    p.run(sql)
    hinted = p.t._hbo_admission_bytes(sql)
    assert hinted == p.j._hbo_admission_bytes(sql) == 64 << 20
    assert p.t.execute(sql).rows == [(6,)]


# ---------------------------------------------------------------------------
# observability surfaces


def test_plan_stats_rows_equal_jax():
    p = kv_pair()
    p.run("select count(*) c from t")
    sql = ("select statement, node, name, runs, rows "
           "from system.runtime.plan_stats")
    want, got = (sorted(r.execute(sql).rows) for r in (p.j, p.t))
    assert got == want and got
    assert "TableScanOperator" in {row[2] for row in got}


def test_hbo_metric_families_prometheus_roundtrip():
    p = kv_pair()
    p.run("select count(*) c from t")
    parsed = []
    for r in (p.j, p.t):
        fams = {f["name"]: f for f in r.metrics_families()}
        assert fams["trino_hbo_qerror"]["type"] == "histogram"
        parsed.append(parse_prometheus(render_prometheus(
            [f for f in r.metrics_families()
             if f["name"].startswith("trino_hbo_")])))
    assert parsed[1] == parsed[0]
    assert sum(parsed[1]["trino_hbo_qerror_count"].values()) >= 1
    assert "trino_hbo_records_total" in parsed[1]


# ---------------------------------------------------------------------------
# bursts: per-lane actuals and the padded depth


AGG_BURST = ["select k, count(*) c, sum(v) s from f where v > %d group by k"
             % (i * 7) for i in range(3)]


def burst_pair(**props) -> Pair:
    p = Pair(**props)
    p.run("create table f (k bigint, v bigint)")
    p.run("insert into f values "
          + ", ".join("(%d, %d)" % (i % 4, i) for i in range(64)))
    return p


@pytest.mark.parametrize("pad_rows_limit", [1_000_000, 1])
def test_burst_records_actuals_and_pads_as_jax(pad_rows_limit):
    """Each real lane of a burst records its own actuals (3 records for
    3 members, none for the padding lane), and the burst pads as the JAX
    engine pads: to a power of two, or — once history says the shape
    scans at least ``batched_execution_pad_rows_limit`` rows — to
    exactly its members."""
    p = burst_pair(batched_execution_pad_rows_limit=pad_rows_limit)
    depths = []
    for _ in range(2):
        want = p.j.execute_batch(AGG_BURST)
        got = p.t.execute_batch(AGG_BURST)
        for w, g in zip(want, got):
            _same_rows(g.rows, w.rows)
            assert g.stats == w.stats
        depths.append(got[0].stats["batched_depth"])
    assert depths == ([4, 4] if pad_rows_limit > 64 else [4, 3])
    assert pss.store().counters()["records"] == 6
    _same_history()
    names = {e["name"] for e in pss.store().snapshot()}
    assert {"TableScanOperator", "HashAggregationOperator"} <= names


# ---------------------------------------------------------------------------
# the hybrid join's second run sizes its fan-out from history


HYBRID_SQL = ("select o_orderkey, o_orderpriority, l_quantity "
              "from orders o, lineitem l "
              "where o.o_orderkey = l.l_orderkey and l_quantity > 45 "
              "order by o_orderkey, l_quantity limit 50")


def test_hybrid_second_run_sizes_fanout_from_hbo(monkeypatch):
    props = {"query_max_memory_bytes": 60_000, "spill_enabled": True,
             "spill_to_disk_enabled": True, "spill_host_memory_bytes": 0}
    states = {"jax": [], "torch": []}
    for key, mod in (("jax", JJ), ("torch", PJ)):
        orig = mod.HashBuilderOperator._init_partitions

        def spy(self, _orig=orig, _out=states[key]):
            _orig(self)
            _out.append((self._hstate.source, self._hstate.fanout))

        monkeypatch.setattr(mod.HashBuilderOperator, "_init_partitions", spy)
    jr = JRunner({"tpch": JTpch(page_rows=1024)},
                 JSession(catalog="tpch", schema="micro",
                          properties=dict(props)), desired_splits=8)
    pr = LocalQueryRunner({"tpch": TpchConnector(page_rows=1024)},
                          Session(catalog="tpch", schema="micro",
                                  properties=dict(props)),
                          desired_splits=8, device="cpu")
    for _ in range(2):
        assert pr.execute(HYBRID_SQL).rows == jr.execute(HYBRID_SQL).rows
    for key in ("jax", "torch"):
        (s1, f1), (s2, f2) = states[key][0], states[key][-1]
        assert (s1, s2) == ("local", "hbo") and f2 >= f1, states
    assert states["torch"][-1][0] == states["jax"][-1][0]


def test_qerror_tolerance_is_stated():
    """The Q-error summaries of one run agree within the stated
    relative 1e-9 (they are ratios of equal row counts and equal
    estimates)."""
    p = join_pair()
    want, got = p.run(JOIN_SQL)
    w, g = want.stats["hbo"]["worst"], got.stats["hbo"]["worst"]
    assert g["name"] == w["name"] and g["actual_rows"] == w["actual_rows"]
    assert math.isclose(g["qerror"], w["qerror"], rel_tol=1e-9)
    assert math.isclose(g["est_rows"], w["est_rows"], rel_tol=1e-9)
