"""The program profiler: the torch engine against the JAX engine.

The one-device cases of tests/test_profiler.py on the port: the registry
(one entry per program and signature, calls growing on repeats, a
python scalar keyed by its type, a static value or a new shape making a
new entry), the refcounted scopes, nesting (a program called inside
another profiled program is part of it, as a JAX program called inside
another's trace), the zero cost of the off switch — no CUDA event, no
synchronise, nothing recorded — and the boundary reads of the device
time while it is on, EXPLAIN ANALYZE VERBOSE, ``system.runtime.kernels``,
the profile document, validator and differ, and the
slow-query log.

EXPLAIN ANALYZE VERBOSE runs at micro in both engines, and per operator
the port's set of program names must equal the JAX engine's (the JAX
engine's set is read by wrapping its profiler's call path and its
driver's cost attribution in this test). Both engines' profilers are
reset around every case. No DOUBLE is compared across engines here: the
times and costs measure each engine's own programs.
"""

import json
import re
import threading

import pytest
import torch

from test_torch_tpch_q1 import _runners
from trino_tpu.exec import driver as jdriver
from trino_tpu.resources.tpch_queries import TPCH_QUERIES
from trino_tpu.telemetry import profiler as jprof
from trino_tpu_torch import jit_stats
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.sql.analyzer import Session
from trino_tpu_torch.telemetry import profiler
from trino_tpu_torch.telemetry.profiler import (diff_profiles, instrument,
                                                validate_profile)

NO_HBO = {"hbo_enabled": False}


@pytest.fixture(autouse=True)
def _profilers_reset():
    """Both engines' profilers start empty and are left off."""
    profiler.reset()
    jprof.reset()
    yield
    profiler.reset()
    jprof.reset()


def _entries_for(name):
    return [e for e in profiler.snapshot() if e["name"] == name]


def _program(name, **kw):
    def f(x, y, n):
        return (x * 2.0 + y).reshape(n, -1)

    return instrument(name, f, static_argnames=("n",), **kw)


# -- registry core ---------------------------------------------------------


def test_costs_recorded_once_per_signature():
    f = _program("t_registry_core", flops=lambda x, y, n: 2 * x.numel())
    x = torch.arange(8, dtype=torch.float32)
    y = torch.ones(8, dtype=torch.float32)
    profiler.enable()
    r1 = f(x, y, n=2)
    r2 = f(x, y, n=2)
    assert torch.equal(r1, r2)
    (e,) = _entries_for("t_registry_core")
    assert e["compiles"] == 1 and e["calls"] == 2
    assert e["trace_ms"] == 0.0 and e["compile_ms"] == 0.0
    assert e["execute_ms"] >= 0.0 and e["fallbacks"] == 0
    assert e["flops"] == 16.0
    # x and y read once, the result written once: 3 x 8 float32
    assert e["bytes_accessed"] == 96.0
    assert e["argument_bytes"] == 64 and e["output_bytes"] == 32
    f(x, y, n=4)           # a new static value: a new program
    assert len(_entries_for("t_registry_core")) == 2
    f(torch.arange(16.0), torch.ones(16), n=2)  # a new shape too
    assert len(_entries_for("t_registry_core")) == 3
    tot = profiler.totals()
    assert tot["programs"] == 3 and tot["calls"] == 4
    assert tot["flops"] == 16.0 * 3 + 32.0


def test_python_scalar_does_not_fragment_registry():
    w = instrument("t_weak_scalar", lambda x, s: x * s)
    x = torch.arange(4, dtype=torch.float32)
    profiler.enable()
    assert float(w(x, 2.0)[2]) == 4.0
    assert float(w(x, 3.5)[2]) == 7.0
    (e,) = _entries_for("t_weak_scalar")
    assert e["compiles"] == 1 and e["calls"] == 2


def test_first_calls_counted_whether_or_not_profiling():
    """``jit_stats`` counts a program's first call at each signature,
    profiling on or off; a repeat adds nothing."""
    f = _program("t_first_calls")
    x, y = torch.arange(8.0), torch.ones(8)
    before = jit_stats.total_for("t_first_calls")
    f(x, y, n=2)
    f(x, y, n=2)
    assert jit_stats.total_for("t_first_calls") == before + 1
    profiler.enable()
    f(x, y, n=2)
    f(x, y, n=4)
    assert jit_stats.total_for("t_first_calls") == before + 2


def test_profiling_scopes_refcount():
    plain = profiler.profiling(False)
    verbose = profiler.profiling(True)
    plain.__enter__()
    verbose.__enter__()
    plain.__exit__(None, None, None)
    assert profiler.enabled(), "no-op scope exit disabled profiling"
    verbose.__exit__(None, None, None)
    assert not profiler.enabled()
    profiler.enable()
    scope = profiler.profiling(True)
    scope.__enter__()
    scope.__exit__(None, None, None)
    assert profiler.enabled()
    profiler.enable(False)
    assert not profiler.enabled()


def test_nested_program_is_part_of_its_caller():
    """A program called inside another profiled program records nothing
    of its own (the JAX engine's inner program is staged out into the
    outer trace); a kernel entry records every launch even there, and
    device time sums over outer calls only."""
    inner = _program("t_inner")
    kern = _program("t_kernel", kernel=True)

    def body(x, y):
        return inner(x, y, n=2).sum() + kern(x, y, n=2).sum()

    outer = instrument("t_outer", body)
    profiler.enable()
    out = outer(torch.arange(8.0), torch.ones(8))
    assert float(out) == 2 * float((torch.arange(8.0) * 2 + 1).sum())
    assert _entries_for("t_inner") == []
    assert _entries_for("t_kernel")[0]["calls"] == 1
    tot = profiler.totals()
    assert tot["outer_execute_ms"] == pytest.approx(
        _entries_for("t_outer")[0]["execute_ms"], abs=1e-3)


# -- the off switch and the boundary reads ---------------------------------


class _FakeEvent:
    """Stands for ``torch.cuda.Event`` on a machine without a card."""

    made = 0
    synced = 0
    clock = 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        type(self).clock += 1.0
        self.t = type(self).clock

    def synchronize(self):
        type(self).synced += 1

    def elapsed_time(self, end):
        return end.t - self.t


@pytest.fixture
def fake_card(monkeypatch):
    """Every tensor looks like a CUDA tensor to the profiler, and CUDA
    events and synchronise calls are counted."""
    _FakeEvent.made = _FakeEvent.synced = 0
    syncs = []
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(1))
    monkeypatch.setattr(profiler, "_any_cuda", lambda x: True)
    return syncs


def test_profiling_off_is_zero_cost(fake_card):
    """Off, a profiled program makes no CUDA event and no synchronise and
    records nothing — over single calls and over a whole query through
    the driver's stats path; the wrapper's own work is one attribute
    check before the counted program."""
    f = _program("t_zero_cost")
    x, y = torch.arange(8.0), torch.ones(8)
    for _ in range(50):
        f(x, y, n=2)
    runner = LocalQueryRunner({"tpch": TpchConnector(page_rows=2048)},
                              Session(catalog="tpch", schema="micro"),
                              device="cpu")
    runner.execute("explain analyze " + TPCH_QUERIES[1])
    runner.execute(TPCH_QUERIES[3])
    assert (_FakeEvent.made, _FakeEvent.synced, len(fake_card)) == (0, 0, 0)
    assert profiler.snapshot() == []
    assert profiler.totals()["calls"] == 0


def test_events_are_read_only_at_boundaries(fake_card):
    """On, each call records one pair of events on the stream and reads
    nothing; the pairs are read (one wait on each end event) only when
    an operator boundary or a report asks."""
    f = _program("t_events")
    x, y = torch.arange(8.0), torch.ones(8)
    profiler.enable()
    for _ in range(5):
        f(x, y, n=2)
    assert (_FakeEvent.made, _FakeEvent.synced) == (10, 0)
    assert profiler.thread_device_ms() == 5.0    # each pair: 1 "ms"
    assert _FakeEvent.synced == 5
    (e,) = profiler.snapshot()
    assert e["calls"] == 5 and e["execute_ms"] == 5.0
    assert _FakeEvent.synced == 5 and not fake_card


# -- EXPLAIN ANALYZE VERBOSE -----------------------------------------------


_PROGRAMS = re.compile(r"  (\w+): \d+ rows.*[ \[]programs ([^\]]*)\]")


@pytest.fixture
def jax_operator_programs(monkeypatch):
    """Makes the JAX engine's operator lines end with the programs each
    operator ran, as the port's do: its profiler's recorded calls are
    collected per thread and handed to the operator at each cost
    attribution."""
    tls = threading.local()
    orig_call = jprof.ProfiledFunction._profiled_call

    def call(self, args, kwargs):
        import jax

        if not any(isinstance(leaf, jax.core.Tracer)
                   for leaf in jax.tree_util.tree_leaves((args, kwargs))):
            tls.names = getattr(tls, "names", []) + [self.name]
        return orig_call(self, args, kwargs)

    orig_attr = jdriver.Driver._attribute_cost

    def attribute(st, before):
        orig_attr(st, before)
        st._programs = getattr(st, "_programs", set()) | set(
            getattr(tls, "names", []))
        tls.names = []

    orig_line = jdriver.OperatorStats.line

    def line(self):
        names = getattr(self, "_programs", set())
        return orig_line(self) + (
            " [programs " + " ".join(sorted(names)) + "]" if names else "")

    monkeypatch.setattr(jprof.ProfiledFunction, "_profiled_call", call)
    monkeypatch.setattr(jdriver.Driver, "_attribute_cost",
                        staticmethod(attribute))
    monkeypatch.setattr(jdriver.OperatorStats, "line", line)


def _operator_programs(rows):
    """[(pipeline, operator, {programs})] of an EXPLAIN ANALYZE VERBOSE,
    operators that ran no program included with an empty set."""
    out, pipeline = [], None
    for (line,) in rows:
        if line.startswith("Pipeline "):
            pipeline = int(line.split()[1].rstrip(":"))
            continue
        if pipeline is None or not line.startswith("  "):
            continue
        m = _PROGRAMS.match(line)
        name = line.split(":")[0].strip()
        out.append((pipeline, name,
                    frozenset(m.group(2).split()) if m else frozenset()))
    return out


VERBOSE_SQL = [
    TPCH_QUERIES[1], TPCH_QUERIES[3], TPCH_QUERIES[18],
    "select c.c_custkey, o.o_orderkey from customer c "
    "join orders o on c.c_custkey = o.o_custkey",
    "select * from lineitem where l_quantity < 3 order by l_extendedprice "
    "desc, l_orderkey, l_linenumber",
    "select o_custkey, o_orderkey, rank() over (partition by o_custkey "
    "order by o_totalprice desc) r from orders",
    "select * from (select o_custkey, o_orderkey, row_number() over "
    "(partition by o_custkey order by o_orderdate) rn from orders) "
    "where rn <= 2",
    "select n_regionkey, count(*) from nation group by n_regionkey",
    "select o_orderkey from orders where o_custkey in "
    "(select c_custkey from customer where c_acctbal > 0)",
]


@pytest.mark.parametrize("sql", VERBOSE_SQL,
                         ids=[f"sql{i}" for i in range(len(VERBOSE_SQL))])
def test_verbose_programs_per_operator_equal_jax(jax_operator_programs,
                                                 sql):
    jr, pr = _runners("micro", NO_HBO, page_rows=2048)
    stmt = "explain analyze verbose " + sql
    want = jr.execute(stmt).rows
    got = pr.execute(stmt).rows
    got_ops, want_ops = _operator_programs(got), _operator_programs(want)
    assert got_ops == want_ops
    assert any(names for _, _, names in got_ops)
    assert got[-1][0].startswith("Kernels: ")


def test_explain_analyze_verbose_local():
    _, pr = _runners("micro", NO_HBO, page_rows=4096)
    sql = ("explain analyze verbose select l_returnflag, "
           "sum(l_quantity) q from lineitem group by l_returnflag")
    text = "\n".join(r[0] for r in pr.execute(sql).rows)
    assert "[cost " in text and "flops" in text and "device " in text
    assert "Kernels:" in text
    plain = "\n".join(r[0] for r in pr.execute(
        "explain analyze select count(*) from region").rows)
    assert "Kernels:" not in plain and "[cost " not in plain


@pytest.mark.parametrize("qid", [1, 3])
def test_repeat_verbose_run_adds_no_program(qid):
    """A repeat-shape VERBOSE run reuses every registry entry: "0 new,
    0 compiles this run"."""
    _, pr = _runners("micro", NO_HBO, page_rows=4096)
    sql = "explain analyze verbose " + TPCH_QUERIES[qid]
    first = pr.execute(sql).rows[-1][0]
    assert re.match(r"Kernels: \d+ programs in registry, [1-9]\d* new",
                    first), first
    before = profiler.totals()
    again = pr.execute(sql).rows[-1][0]
    assert profiler.totals()["programs"] == before["programs"]
    assert "0 new, 0 compiles this run" in again, again


def test_system_runtime_kernels_sql():
    jr, pr = _runners("micro", NO_HBO, page_rows=4096)
    for r in (jr, pr):
        r.execute("explain analyze verbose " + TPCH_QUERIES[1])
    sql = ("select name, key, compiles, calls, trace_ms, compile_ms, "
           "execute_ms, flops, bytes_accessed, output_bytes, temp_bytes, "
           "code_bytes from system.runtime.kernels")
    want, got = jr.execute(sql), pr.execute(sql)
    assert got.column_names == want.column_names
    assert [t.name for t in got.types] == [t.name for t in want.types]
    assert got.rows
    assert "page_processor" in {r[0] for r in got.rows}
    assert {r[0] for r in got.rows} <= {r[0] for r in want.rows} | {
        "segment_reduce_pallas"}
    for row in got.rows:
        assert row[2] == 1 and row[3] >= 1 and row[4] == 0.0


def test_query_profiling_enabled_session_property():
    _, pr = _runners("micro", {"hbo_enabled": False,
                               "query_profiling_enabled": True},
                     page_rows=4096)
    pr.execute(TPCH_QUERIES[6])
    assert profiler.totals()["calls"] > 0
    assert not profiler.enabled()   # the query's scope closed


# -- the profile document, validator and differ ----------------------------


def _kernel(name, key="k", compiles=1, calls=1, compile_ms=0.0,
            flops=100.0, bytes_accessed=1000.0):
    return {"name": name, "key": key, "compiles": compiles,
            "calls": calls, "trace_ms": 0.0, "compile_ms": compile_ms,
            "execute_ms": 1.0, "flops": flops,
            "bytes_accessed": bytes_accessed, "output_bytes": 0,
            "temp_bytes": 0, "argument_bytes": 0, "code_bytes": 0,
            "fallbacks": 0}


def _doc(kernels):
    return {"version": 1, "role": "unit", "kernels": kernels,
            "totals": {"compiles": sum(k["compiles"] for k in kernels),
                       "calls": sum(k["calls"] for k in kernels),
                       "compile_ms": 0.0}}


def test_differ_names_the_program_that_moved():
    old = _doc([_kernel("join_probe"), _kernel("agg")])
    new = _doc([_kernel("join_probe"), _kernel("agg", key="k0"),
                _kernel("agg", key="k1", bytes_accessed=3000.0)])
    moved = diff_profiles(old, new)
    assert moved and all(m["kernel"] == "agg" for m in moved)
    assert {"recompiled", "bytes_accessed-grew"} <= {m["change"]
                                                     for m in moved}
    assert diff_profiles(old, old) == []
    assert diff_profiles(old, new) == jprof.diff_profiles(old, new)


def test_differ_flags_new_and_vanished_programs():
    changes = {(m["kernel"], m["change"]) for m in diff_profiles(
        _doc([_kernel("a")]), _doc([_kernel("b")]))}
    assert {("a", "vanished"), ("b", "new-kernel")} <= changes


def test_validate_profile():
    """Empty and disconnected profiles are refused; a zero compile wall
    is not (torch programs compile nothing)."""
    assert validate_profile({}) != []
    assert validate_profile({"kernels": []}) != []
    assert validate_profile(_doc([_kernel("x", compiles=0,
                                          calls=0)])) != []
    good = _doc([_kernel("x")])
    assert validate_profile(good) == []
    assert validate_profile(json.loads(json.dumps(good))) == []


def test_profile_document_shape():
    f = _program("t_doc")
    profiler.enable()
    f(torch.arange(8.0), torch.ones(8), n=2)
    profiler.enable(False)
    doc = profiler.profile_document("unit", extra={"run": 1})
    assert validate_profile(doc) == []
    assert doc["role"] == "unit" and doc["run"] == 1
    assert doc["backend"] == "cpu" and doc["device"] == "cpu"
    assert any(k["name"] == "t_doc" for k in doc["kernels"])
    assert set(doc["kernels"][0]) == set(_kernel("x"))


def test_device_memory_stats_on_the_cpu_is_none():
    """As the JAX engine on the CPU: no device memory to report."""
    assert profiler.device_memory_stats() is None
    assert jprof.device_memory_stats() is None


# -- slow-query log --------------------------------------------------------


def test_slow_query_log_local():
    runner = LocalQueryRunner(
        {"tpch": TpchConnector(page_rows=4096)},
        Session(catalog="tpch", schema="micro",
                properties={"slow_query_log_threshold": 1e-9}),
        device="cpu")
    runner.execute("select count(*) from region")
    slow = (runner.event_manager.history(1)[-1].stats or {}).get(
        "slow_query")
    assert slow is not None and slow["wall_ms"] > 0
    assert slow["threshold_s"] == 1e-9
    res = runner.execute("select query, slow from system.runtime.queries "
                         "where state = 'FINISHED'")
    flagged = [r for r in res.rows if r[1] is not None]
    assert flagged and "wall=" in flagged[0][1]


def test_fast_queries_not_flagged():
    runner = LocalQueryRunner({"tpch": TpchConnector(page_rows=4096)},
                              Session(catalog="tpch", schema="micro"),
                              device="cpu")
    runner.execute("select count(*) from region")
    assert "slow_query" not in (
        runner.event_manager.history(1)[-1].stats or {})
