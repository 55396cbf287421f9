"""Plan templates and batched execution: the torch engine against the JAX
engine.

The cases of tests/test_batched_execution.py that have a counterpart in
the port. Each sends the same statements through both engines (both
with ``hbo_enabled=false``, so the counters compare runs planned without
history; tests/test_torch_hbo.py holds a burst's history and depth
against the JAX engine's) and compares the rows (integers and decimals exactly, DOUBLE within a
relative 1e-12), the error codes, the cache and template counters and
the dispositions. A burst must also equal the port's own serial runs of
the same texts, row for row and in order.

"Zero traces" has no torch meaning; its counterpart here is the same
``PageProcessor`` objects reused from the processor cache, and the
segment-reduce calls a burst makes on the CPU path, counted by the
plain version's calls: one folded call per aggregated page and one for
the merge, whatever the burst's depth.

Left out (ROADMAP queue 1): the hot-lane output-buffer cases (the
exchange output buffer comes with distribution) and the template seed's
worker RPC and process-runner transport.
"""

import threading

import pytest

from test_torch_tpch_q1 import _same_rows
from trino_tpu import types as JT
from trino_tpu.cache import template_seeds as j_template_seeds
from trino_tpu.connectors.memory import MemoryConnector as JMemory
from trino_tpu.expr.ir import Literal as JLiteral
from trino_tpu.expr.ir import ParamRef as JParamRef
from trino_tpu.expr.ir import param_indices as j_param_indices
from trino_tpu.ops.kernel_sizing import KERNEL_SIZING as J_SIZING
from trino_tpu.runner import LocalQueryRunner as JRunner
from trino_tpu.security import RuleBasedAccessControl as JAcl
from trino_tpu.security import TableRule as JRule
from trino_tpu.sql.analyzer import Session as JSession
from trino_tpu_torch import types as T
from trino_tpu_torch.cache import TemplateSeedStore, statement_fingerprint
from trino_tpu_torch.cache import template_seeds
from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.expr.compiler import PageProcessor
from trino_tpu_torch.expr.ir import Call, Literal, ParamRef, param_indices
from trino_tpu_torch.ops import kernels
from trino_tpu_torch.ops.kernel_sizing import KERNEL_SIZING
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.security import (AccessDeniedError,
                                      RuleBasedAccessControl, TableRule)
from trino_tpu_torch.sql.analyzer import Session

#: the stats each statement reports about how it was served
SERVED = ("plan_template", "plan_cache", "result_cache", "batched_depth")
#: the counters both engines keep the same way
COUNTERS = ("plan_hits", "plan_misses", "plan_shape_hits",
            "plan_invalidations", "result_hits", "result_misses",
            "batches", "batched_queries", "coalesced", "batched_launches",
            "batched_spills", "result_shortcircuits", "template_hits",
            "template_misses", "template_builds", "template_fallbacks",
            "template_entries")


@pytest.fixture(autouse=True)
def _fresh_process_state():
    """Both engines keep process-wide template seeds and capacity
    histories; each case starts both from empty."""
    for store in (template_seeds(), j_template_seeds()):
        store.clear()
    for sizing in (KERNEL_SIZING, J_SIZING):
        sizing.reset()
    yield
    for store in (template_seeds(), j_template_seeds()):
        store.clear()


class Pair:
    """One runner per engine over its own memory catalog, driven with
    the same statements."""

    def __init__(self, jax_acl=None, torch_acl=None, share_from=None):
        props = {"hbo_enabled": False}
        jconn = share_from.j.metadata.connectors if share_from \
            else {"memory": JMemory()}
        tconn = share_from.t.metadata.connectors if share_from \
            else {"memory": MemoryConnector()}
        self.j = JRunner({k: v for k, v in jconn.items() if k != "system"},
                         JSession(catalog="memory", schema="default",
                                  properties=dict(props)),
                         access_control=jax_acl)
        self.t = LocalQueryRunner(
            {k: v for k, v in tconn.items() if k != "system"},
            Session(catalog="memory", schema="default",
                    properties=dict(props)),
            device="cpu", access_control=torch_acl)

    def execute(self, sql, **kw):
        """Run ``sql`` in both engines: the same rows and served-by
        stats, or the same error code. Returns the port's result."""
        outs = []
        for r in (self.j, self.t):
            try:
                outs.append(r.execute(sql, **kw))
            except Exception as e:  # compared below
                outs.append(e)
        same_outcome(*outs)
        return outs[1]

    def batch(self, sqls, **kw):
        """``execute_batch`` in both engines, compared member by member;
        the port's members also equal its own serial runs. Returns the
        port's results."""
        want = self.j.execute_batch(sqls, **kw)
        got = self.t.execute_batch(sqls, **kw)
        assert len(got) == len(want) == len(sqls)
        for g, w in zip(got, want):
            same_outcome(w, g)
        return got

    def counters(self):
        """Both engines' counters, fallbacks and dispositions: equal."""
        jq, tq = self.j.query_cache, self.t.query_cache
        jc, tc = jq.counters(), tq.counters()
        assert {k: tc[k] for k in COUNTERS} == {k: jc[k] for k in COUNTERS}
        assert tq.templates.fallbacks == jq.templates.fallbacks
        assert tq.templates.dispositions == jq.templates.dispositions
        return tc


def same_outcome(want, got):
    """The same rows (decimals exactly, DOUBLE within a relative 1e-12)
    in the same order and the same served-by stats, or the same error
    code when the JAX engine raised."""
    if isinstance(want, Exception):
        assert isinstance(got, Exception), (want, got)
        assert getattr(got, "code", type(got).__name__) == \
            getattr(want, "code", type(want).__name__), (want, got)
        return
    assert not isinstance(got, Exception), (want, got)
    assert got.column_names == want.column_names
    _same_rows(got.rows, want.rows)
    ws, gs = want.stats or {}, got.stats or {}
    assert {k: gs.get(k) for k in SERVED} == \
        {k: ws.get(k) for k in SERVED}, (ws, gs)


def mem_pair(**kw) -> Pair:
    p = Pair(**kw)
    p.execute("create table t (k bigint, v bigint)")
    p.execute("insert into t values (1, 10), (2, 20), (3, 30), "
              "(4, 40), (5, 50), (6, 60), (7, 70), (8, 80)")
    return p


def star_pair(nfact=64, nhot=0) -> Pair:
    """The star shape the batched join targets: a param-filtered fact
    (probe) against a small param-free dim (build)."""
    p = Pair()
    p.execute("create table f (k bigint, v bigint)")
    p.execute("create table d (k bigint, w bigint)")
    p.execute("insert into f values "
              + ", ".join("(%d, %d)" % (i % 4, i) for i in range(nfact)))
    drows = ["(0, %d)" % i for i in range(nhot)] \
        + ["(%d, %d)" % (k, k * 10) for k in (0, 1, 2, 3)]
    p.execute("insert into d values " + ", ".join(drows))
    return p


def serial_rows(runner, sqls):
    """The port's serial rows of each statement, batching off."""
    props = runner.session.properties
    props["batched_execution_enabled"] = False
    try:
        return [runner.execute(s).rows for s in sqls]
    finally:
        props.pop("batched_execution_enabled")


BURST = ["select v from t where k = %d" % i for i in range(1, 9)]
EXPECT = [[(10 * i,)] for i in range(1, 9)]
AGG_BURST = ["select k, count(*) c, sum(v) s from f where v > %d group by k"
             % (i * 7) for i in range(8)]


class _TwinCalls:
    """Counts the plain segment-reduce version's calls (the CPU path of
    ``segment_reduce_columns``) with their segment counts."""

    def __init__(self, monkeypatch):
        self.calls = []
        inner = kernels.segment_reduce_columns_reference

        def counted(cols, gid, num_segments, kinds, order=None):
            self.calls.append(num_segments)
            return inner(cols, gid, num_segments, kinds, order)

        monkeypatch.setattr(kernels, "segment_reduce_columns_reference",
                            counted)


# -- IR opacity -----------------------------------------------------------


def test_paramref_is_not_a_literal():
    """Every plan-time constant reader is ``isinstance(_, Literal)``-
    gated, so ParamRef is opaque by construction, in both engines."""
    p = ParamRef(T.BIGINT, 0)
    assert not isinstance(p, Literal)
    assert param_indices(p) == j_param_indices(JParamRef(JT.BIGINT, 0)) \
        == {0}
    expr = Call(T.BIGINT, "add", (ParamRef(T.BIGINT, 1),
                                  Literal(T.BIGINT, 5)))
    assert param_indices(expr) == {1}
    assert not isinstance(JParamRef(JT.BIGINT, 0), JLiteral)


def test_paramref_evaluates_as_its_literal():
    """A processor over ``k = ParamRef`` bound to 3 equals the one over
    ``k = 3``; the batched pass of 1, 3 and 9 equals three serial ones."""
    import torch

    from trino_tpu_torch.block import DevicePage

    k = torch.arange(8, dtype=torch.int64)
    page = DevicePage([T.BIGINT], [k], [torch.zeros(8, dtype=torch.bool)],
                      torch.ones(8, dtype=torch.bool), [None])
    from trino_tpu_torch.expr.ir import InputRef

    ref = InputRef(T.BIGINT, 0)
    lit = PageProcessor([T.BIGINT], [ref],
                        Call(T.BOOLEAN, "eq", (ref, Literal(T.BIGINT, 3))))
    par = PageProcessor([T.BIGINT], [ref],
                        Call(T.BOOLEAN, "eq", (ref, ParamRef(T.BIGINT, 0))))
    assert par.param_indices == (0,)
    assert torch.equal(lit.process(page).valid,
                       par.process(page, par.bind_params((3,))).valid)
    _, _, valid, _ = par.process_batched(
        page.cols, page.nulls, page.valid, page.dictionaries,
        (torch.tensor([1, 3, 9]),), "shared")
    assert valid.shape == (3, 8)
    for i, v in enumerate((1, 3, 9)):
        assert torch.equal(valid[i],
                           par.process(page, par.bind_params((v,))).valid)


# -- serial template reuse ------------------------------------------------


def test_serial_template_reuse_across_literals():
    """Second-and-later uses of a shape ride the template without
    re-planning: the same root, different bindings."""
    p = mem_pair()
    r1, r2, r3 = (p.execute("select v from t where k = %d" % i)
                  for i in (1, 2, 3))
    assert (r1.rows, r2.rows, r3.rows) == ([(10,)], [(20,)], [(30,)])
    assert r1.stats.get("plan_template") is None
    assert r2.stats.get("plan_template") == "hit"
    assert r3.stats.get("plan_template") == "hit"
    c = p.counters()
    assert c["template_builds"] == 1 and c["template_hits"] >= 1
    assert c["template_fallbacks"] == 0


def test_template_disabled_by_session_property():
    p = mem_pair()
    p.execute("set session plan_template_enabled = false")
    for i in (1, 2, 3):
        res = p.execute("select v from t where k = %d" % i)
        assert res.stats.get("plan_template") is None
    assert p.counters()["template_builds"] == 0


# -- batched execution: equality matrix -----------------------------------


def test_batch_matches_serial_oracle():
    p = mem_pair()
    out = p.batch(BURST)
    assert p.counters()["batched_launches"] == 8
    assert [o.rows for o in out] == EXPECT == serial_rows(p.t, BURST)
    assert all(o.stats.get("plan_template") == "hit" for o in out)


def test_batch_mixed_literals_and_duplicates():
    """Identical literal vectors coalesce to one lane; results still
    demux to every submitter positionally."""
    p = mem_pair()
    sqls = [BURST[0], BURST[3], BURST[0], BURST[5], BURST[3]]
    out = p.batch(sqls)
    assert [o.rows for o in out] == [EXPECT[0], EXPECT[3], EXPECT[0],
                                     EXPECT[5], EXPECT[3]]
    p.counters()


def test_batch_failing_member_demuxes_positionally():
    p = mem_pair()
    out = p.batch([BURST[0], "select nope from t where k = 2", BURST[2]])
    assert out[0].rows == EXPECT[0]
    assert isinstance(out[1], Exception)
    assert out[2].rows == EXPECT[2]
    p.counters()


def test_batch_mixed_shapes_grouped():
    p = mem_pair()
    sqls = [BURST[0], "select k from t where v = 20", BURST[2],
            "select k from t where v = 40", BURST[4],
            "select k from t where v = 60"]
    out = p.batch(sqls)
    assert [o.rows for o in out] == [EXPECT[0], [(2,)], EXPECT[2],
                                     [(4,)], EXPECT[4], [(6,)]]
    p.counters()


def test_batch_mixed_tenants_acl_enforced_per_member():
    """Per-tenant ACL is enforced per statement: the denied tenant's
    members fail with AccessDenied, in both engines."""
    seed = mem_pair()
    p = Pair(jax_acl=JAcl([JRule(user="alice", privileges=["SELECT"])]),
             torch_acl=RuleBasedAccessControl(
                 [TableRule(user="alice", privileges=["SELECT"])]),
             share_from=seed)
    sqls = ["select v from t where k = 1", "select v from t where k = 2"]
    assert [o.rows for o in p.batch(sqls, user="alice")] == \
        [[(10,)], [(20,)]]
    out = p.batch(sqls, user="mallory")
    assert all(isinstance(o, AccessDeniedError) for o in out)
    p.counters()


def test_batch_result_cache_hit_short_circuits_lane():
    p = mem_pair()
    p.execute("set session result_cache_enabled = true")
    p.execute(BURST[0])
    out = p.batch([BURST[0], BURST[1], BURST[2]])
    assert [o.rows for o in out] == EXPECT[:3]
    assert out[0].stats.get("result_cache") == "hit"
    c = p.counters()
    assert c["result_shortcircuits"] == 1
    assert c["batched_launches"] == 2
    assert p.execute(BURST[1]).stats.get("result_cache") == "hit"


def test_batch_reuses_processors_and_reduces_once_per_page(monkeypatch):
    """The port's counterpart of "zero new traces, one launch per
    stage": a repeat burst of 8 builds no PageProcessor (every one comes
    from the processor cache), runs each stage's processor once for the
    whole burst, and its aggregation makes exactly the segment-reduce
    calls of ONE serial run — one folded call per page, one merge —
    over 8 lanes of segments."""
    p = star_pair()
    first = p.batch(AGG_BURST)
    built = []
    real_init = PageProcessor.__init__

    def counting_init(self, *a, **kw):
        built.append(self)
        real_init(self, *a, **kw)

    monkeypatch.setattr(PageProcessor, "__init__", counting_init)
    passes = []
    real_batched = PageProcessor.process_batched

    def counting_batched(self, *a, **kw):
        passes.append(id(self))
        return real_batched(self, *a, **kw)

    monkeypatch.setattr(PageProcessor, "process_batched", counting_batched)
    twin = _TwinCalls(monkeypatch)
    again = p.t.execute_batch(AGG_BURST)
    assert [o.rows for o in again] == [o.rows for o in first]
    assert built == []
    assert passes and len(passes) == len(set(passes))
    burst_calls = list(twin.calls)
    twin.calls.clear()
    p.t.session.properties["batched_execution_enabled"] = False
    p.t.execute(AGG_BURST[0])
    # the serial run's table is one page: one grouping call, no merge
    assert len(burst_calls) == len(twin.calls) == 1
    assert burst_calls[0] == 8 * twin.calls[0]


def test_batch_depth_chunking():
    p = mem_pair()
    p.execute("set session batched_execution_max_depth = 4")
    out = p.batch(BURST)
    assert [o.rows for o in out] == EXPECT
    assert {o.stats.get("batched_depth") for o in out} == {4}
    p.counters()


def test_batch_depth_padding_power_of_two():
    p = mem_pair()
    out = p.batch(BURST[:3])
    assert [o.rows for o in out] == EXPECT[:3]
    assert {o.stats.get("batched_depth") for o in out} == {4}
    p.counters()


# -- fallback taxonomy ----------------------------------------------------


def test_fallback_string_param():
    p = mem_pair()
    p.execute("create table s (name varchar, v bigint)")
    p.execute("insert into s values ('a', 1), ('b', 2)")
    out = p.batch(["select v from s where name = 'a'",
                   "select v from s where name = 'b'"])
    assert [o.rows for o in out] == [[(1,)], [(2,)]]
    assert p.t.query_cache.templates.fallbacks.get("string_param")
    p.counters()


def test_fallback_ordinal_param():
    p = mem_pair()
    out = p.batch(["select k, count(*) from t where v > %d group by 1" % i
                   for i in (5, 25)])
    assert sorted(out[0].rows) == [(i, 1) for i in range(1, 9)]
    assert sorted(out[1].rows) == [(i, 1) for i in range(3, 9)]
    assert p.t.query_cache.templates.fallbacks.get("ordinal_param")
    p.counters()


def test_fallback_value_dependent():
    p = mem_pair()
    out = p.batch(["select lag(v, %d) over (order by k) from t" % i
                   for i in (1, 2)])
    assert out[0].rows[:3] == [(None,), (10,), (20,)]
    assert out[1].rows[:3] == [(None,), (None,), (10,)]
    assert p.t.query_cache.templates.fallbacks.get("value_dependent")
    p.counters()


def test_fallback_plan_shape_not_vmappable():
    p = mem_pair()
    out = p.batch(["select v from t where k > %d order by v" % i
                   for i in (5, 6)])
    assert [o.rows for o in out] == [[(60,), (70,), (80,)], [(70,), (80,)]]
    c = p.counters()
    assert p.t.query_cache.templates.fallbacks.get("unsupported_stage") == 1
    assert c["batched_launches"] == 0


def test_global_aggregation_now_vmaps():
    p = mem_pair()
    out = p.batch(["select count(*) from t where k > %d" % i
                   for i in (1, 2)])
    assert [o.rows for o in out] == [[(7,)], [(6,)]]
    c = p.counters()
    assert p.t.query_cache.templates.dispositions == \
        {"agg_stage_vmapped": 1}
    assert c["batched_launches"] == 2 and c["template_fallbacks"] == 0


def test_nondeterministic_and_writes_never_batch():
    p = mem_pair()
    out = p.batch(["insert into t values (100, 1000)",
                   "insert into t values (100, 1000)"])
    assert all(not isinstance(o, Exception) for o in out)
    assert p.execute("select count(*) from t where k = 100").rows == [(2,)]
    assert p.counters()["batched_launches"] == 0


def test_batched_execution_disabled_property():
    p = mem_pair()
    p.execute("set session batched_execution_enabled = false")
    assert [o.rows for o in p.batch(BURST)] == EXPECT
    assert p.counters()["batched_launches"] == 0


def test_template_counters_scrapeable():
    p = mem_pair()
    p.batch(BURST)
    c = p.counters()
    assert c["template_builds"] >= 1 and c["batched_launches"] >= 8
    names = {f["name"] for f in p.t.metrics_families()}
    assert {"trino_plan_template_total",
            "trino_plan_template_entries"} <= names


def test_optimizer_template_param_slots():
    from trino_tpu_torch.planner.optimizer import template_param_slots

    p = mem_pair()
    for i in (1, 2):
        p.execute("select v from t where k = %d" % i)
    tc = p.t.query_cache.templates
    (tmpl,) = [v for v in tc._entries.values() if not isinstance(v, str)]
    assert template_param_slots(tmpl.root) == (0,)
    plain = p.t.plan_statement(p.t.query_cache.parse(
        "select v from t where k = 1", p.t.session).stmt)
    assert template_param_slots(plain) == ()
    assert any(name == "PlanTemplate"
               for name, _ in tmpl.root.optimizer_trace)


# -- masked aggregation and join lanes ------------------------------------


def test_batch_group_by_equal_and_counted():
    p = star_pair()
    out = p.batch(AGG_BURST)
    c = p.counters()
    assert p.t.query_cache.templates.dispositions == \
        {"agg_stage_vmapped": 1}
    assert c["batched_launches"] == 8 and c["batched_spills"] == 0
    assert [o.rows for o in out] == serial_rows(p.t, AGG_BURST)


@pytest.mark.parametrize("hash_grouping", [True, False])
def test_batch_agg_null_group_keys(hash_grouping):
    """NULL group keys form their own group in every lane, on the hash
    and on the sort grouping path."""
    p = star_pair()
    p.execute("insert into f values (null, 3), (null, 100), (null, 200)")
    p.execute("set session hash_grouping_enabled = %s"
              % str(hash_grouping).lower())
    out = p.batch(AGG_BURST)
    p.counters()
    assert [o.rows for o in out] == serial_rows(p.t, AGG_BURST)


def test_batch_agg_all_rows_masked_empty_lane():
    """A member whose filter keeps ZERO rows yields an empty GROUP BY
    result (and a global aggregation its NULL row) from its all-masked
    lane while sibling lanes aggregate."""
    p = star_pair()
    burst = ["select k, count(*) c from f where v > %d group by k" % x
             for x in (10, 10 ** 6, 20)]
    out = p.batch(burst)
    glob = ["select count(*), sum(v), max(v) from f where v > %d" % x
            for x in (10, 10 ** 6)]
    gout = p.batch(glob)
    assert p.t.query_cache.templates.dispositions == \
        {"agg_stage_vmapped": 2}
    p.counters()
    assert out[1].rows == []
    assert [o.rows for o in out] == serial_rows(p.t, burst)
    assert gout[1].rows == [(0, None, None)]
    assert [o.rows for o in gout] == serial_rows(p.t, glob)


def test_batch_global_agg_every_lane_masked_one_page():
    """A global aggregation over a one-page table where EVERY member's
    filter keeps no row: each still yields its one row of empty-input
    states (the compacted partial keeps a column), as the JAX engine
    and the serial runs do."""
    p = star_pair()
    glob = ["select count(*), sum(v), max(v) from f where v > %d" % x
            for x in (10 ** 6, 10 ** 7)]
    out = p.batch(glob)
    assert p.t.query_cache.templates.dispositions == \
        {"agg_stage_vmapped": 1}
    p.counters()
    assert [o.rows for o in out] == [[(0, None, None)]] * 2
    assert [o.rows for o in out] == serial_rows(p.t, glob)


@pytest.mark.parametrize("sql", [
    "select f.v, d.w from f join d on f.k = d.k where f.v > %d",
    "select f.v, d.w from f left join d on f.k = d.k where f.v > %d",
    "select v from f where k in (select k from d) and v > %d",
    "select v from f where k not in (select k from d) and v > %d",
], ids=["inner", "left", "semi", "anti"])
def test_batch_join_matrix_equal(sql):
    burst = [sql % (i * 11) for i in range(8)]
    p = star_pair()
    # anti needs probe keys missing from the dim to produce rows
    p.execute("insert into f values (7, 1), (8, 2), (9, 500)")
    out = p.batch(burst)
    p.counters()
    assert p.t.query_cache.templates.dispositions == \
        {"join_stage_vmapped": 1}
    assert not p.t.query_cache.templates.fallbacks
    assert [o.rows for o in out] == serial_rows(p.t, burst)


def test_batch_join_then_group_by_one_pipeline():
    burst = ["select f.k, count(*) c, sum(d.w) s from f join d "
             "on f.k = d.k where f.v > %d group by f.k" % (i * 17)
             for i in range(8)]
    p = star_pair()
    out = p.batch(burst)
    p.counters()
    assert p.t.query_cache.templates.dispositions == \
        {"join_stage_vmapped": 1, "agg_stage_vmapped": 1}
    assert [o.rows for o in out] == serial_rows(p.t, burst)


def test_batch_lane_overflow_falls_back_alone():
    """One member probes a hot build key hard enough to overflow the
    unified expansion capacity: that lane alone replays serially."""
    burst = ["select count(*) from f join d on f.k = d.k where f.v < %d"
             % x for x in (16, 32, 16, 900)]
    p = star_pair(1024, nhot=64)
    p.execute("set session join_max_expand_lanes = 1024")
    out = p.batch(burst)
    c = p.counters()
    assert c["batched_spills"] == 1 and c["batched_launches"] == 2
    assert p.t.query_cache.templates.fallbacks.get("lane_overflow") == 1
    assert [o.rows for o in out] == serial_rows(p.t, burst)


def test_batch_agg_failing_member_demuxes_positionally():
    p = star_pair()
    out = p.batch([AGG_BURST[0], "select nope from f group by k",
                   AGG_BURST[2]])
    assert isinstance(out[1], Exception)
    p.counters()
    assert [out[0].rows, out[2].rows] == \
        serial_rows(p.t, [AGG_BURST[0], AGG_BURST[2]])


def test_batch_agg_denied_member_demuxes_positionally():
    seed = star_pair()
    seed.execute("create table secret (k bigint)")
    seed.execute("insert into secret values (1)")
    p = Pair(jax_acl=JAcl([JRule(user="alice", table="f|d",
                                 privileges=["SELECT"])]),
             torch_acl=RuleBasedAccessControl(
                 [TableRule(user="alice", table="f|d",
                            privileges=["SELECT"])]),
             share_from=seed)
    out = p.batch([AGG_BURST[0], "select k from secret", AGG_BURST[2]],
                  user="alice")
    assert isinstance(out[1], AccessDeniedError)
    assert not isinstance(out[0], Exception)
    assert not isinstance(out[2], Exception)


def test_disposition_taxonomy_and_legacy_alias():
    p = star_pair()
    p.batch(AGG_BURST)
    p.batch(["select v from f where k > %d order by v" % i for i in (1, 2)])
    p.counters()
    fams = {f["name"]: f for f in p.t.metrics_families()}
    by_label = {tuple(sorted(labels.items())): value
                for labels, value in fams["trino_plan_template_total"]
                ["samples"]}
    assert by_label.get((("outcome", "fallback:non_fp_stage"),)) == 1
    assert by_label.get((("outcome", "fallback:unsupported_stage"),)) == 1
    assert by_label.get((("outcome", "disposition:agg_stage_vmapped"),)) \
        == 1


def test_concurrent_bursts_equal_serial():
    """Bursts from several threads share the processor cache; every
    member equals its serial run."""
    p = star_pair()
    want = serial_rows(p.t, AGG_BURST)
    out = [None] * 4

    def go(i):
        out[i] = [o.rows for o in p.t.execute_batch(AGG_BURST)]

    threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert out == [want] * 4


# -- template seed store --------------------------------------------------


def test_template_seed_roundtrip_and_bounds():
    src = TemplateSeedStore()
    for i in range(40):
        src.note("fp%d" % i, i + 1)
    src.note_fallback_shape("bad", "value_dependent")
    seed = src.export_seed(max_shapes=8)
    assert len(seed["shapes"]) == 8
    assert {fp for fp, _, _ in seed["shapes"][:7]} <= \
        {"fp%d" % i for i in range(32, 40)}
    dst = TemplateSeedStore()
    assert dst.import_seed(seed) == 8
    assert dst.uses("fp39") == 40


def test_template_seed_max_merge_and_first_verdict_wins():
    dst = TemplateSeedStore()
    dst.note("s", 10)
    dst.note_fallback_shape("s", "string_param")
    src = TemplateSeedStore()
    src.note("s", 3)
    src.note_fallback_shape("s", "value_dependent")
    src.note("other", 7)
    assert dst.import_seed(src.export_seed()) == 1
    assert dst.uses("s") == 10
    assert dst.fallback_reason("s") == "string_param"
    assert dst.uses("other") == 7


def test_template_seed_malformed_warns_and_imports_nothing():
    dst = TemplateSeedStore()
    with pytest.warns(RuntimeWarning, match="template seed"):
        assert dst.import_seed({"shapes": [["fp"]]}) == 0
    assert dst.corrupt_loads == 1
    assert dst.uses("fp") == 0


def test_statement_fingerprint_equals_jax():
    from trino_tpu.telemetry.stats_store import \
        statement_fingerprint as j_fp

    p = mem_pair()
    sql = "select v from t where k = 1"
    assert statement_fingerprint(
        p.t.query_cache.parse(sql, p.t.session).shape) == \
        j_fp(p.j.query_cache.parse(sql, p.j.session).shape)


def _seed_shape(p, sql, fallback=None):
    for r, store in ((p.t, template_seeds()), (p.j, j_template_seeds())):
        fp = statement_fingerprint(r.query_cache.parse(sql,
                                                       r.session).shape)
        store.note(fp, 50)
        if fallback:
            store.note_fallback_shape(fp, fallback)


def test_seeded_runner_rides_template_on_first_statement():
    p = mem_pair()
    _seed_shape(p, "select v from t where k = 1")
    res = p.execute("select v from t where k = 2")
    assert res.rows == [(20,)]
    assert res.stats.get("plan_template") == "hit"
    assert p.counters()["template_builds"] == 1


def test_seeded_fallback_skips_local_trial():
    p = mem_pair()
    _seed_shape(p, "select v from t where k = 1", "value_dependent")
    assert p.execute("select v from t where k = 2").rows == [(20,)]
    assert p.counters()["template_builds"] == 0
    assert p.t.query_cache.templates.fallbacks == {"value_dependent": 1}


def test_template_seed_disabled_by_session_property():
    p = mem_pair()
    _seed_shape(p, "select v from t where k = 1")
    p.execute("set session plan_template_seed_enabled = false")
    res = p.execute("select v from t where k = 1")
    assert res.rows == [(10,)]
    assert res.stats.get("plan_template") is None
    assert p.counters()["template_builds"] == 0


def test_batch_type_drift_member_fails_alone():
    """A member of the burst's shape whose literal has another type (a
    string where the template has a number) leaves the batch
    (``param_type_drift``) and fails alone with the JAX engine's code;
    its siblings still ride the batched lanes."""
    p = star_pair()
    sqls = ["select count(*), sum(v) from f where v > %s" % x
            for x in ("3", "17", "'abc'", "40")]
    out = p.batch(sqls)
    assert out[2].code == "ANALYSIS_ERROR"
    c = p.counters()
    assert c["batched_launches"] == 3
    assert p.t.query_cache.templates.fallbacks.get("param_type_drift")
    good = [sqls[i] for i in (0, 1, 3)]
    assert [out[i].rows for i in (0, 1, 3)] == serial_rows(p.t, good)


def test_burst_over_the_memory_budget_runs_serially():
    """The port's guard (the JAX engine has none): a burst whose float-sum
    partials, kept at full capacity, would hold more than the query's
    memory budget leaves the batch (``memory_budget``) and its members
    run serially, each within the budget, with the serial rows; under a
    larger budget the same burst rides the batched lanes."""
    sqls = ["select k, sum(v), count(*) from f where v > %d group by k"
            % (i * 7) for i in range(8)]
    for budget, batched in ((16_000, False), (64_000, True)):
        r = LocalQueryRunner({"memory": MemoryConnector()},
                             Session(catalog="memory", schema="default"),
                             device="cpu")
        r.execute("create table f (k bigint, v double)")
        r.execute("insert into f values " + ", ".join(
            "(%d, %d.5)" % (i % 4, i) for i in range(64)))
        r.execute(f"set session query_max_memory_bytes = {budget}")
        out = r.execute_batch(sqls)
        assert [o.rows for o in out] == serial_rows(r, sqls)
        tc = r.query_cache.templates
        if batched:
            assert r.query_cache.batched_launches == 8 and not tc.fallbacks
        else:
            assert r.query_cache.batched_launches == 0
            assert tc.fallbacks == {"memory_budget": 1}
