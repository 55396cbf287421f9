"""Tracing, metrics and the new metric families: the torch engine against
the JAX engine.

The tracing unit cases of tests/test_telemetry.py and tests/test_profiler.py
on the port's copy of ``telemetry/tracing.py`` (the null tracer, context
propagation across a process boundary, the Chrome trace and OTLP
exports, the critical path and the slow-query record), the metrics
exposition, the event history ring, and operator spans from a finished
driver. The same synthetic spans through both engines' functions give
the same values. Then the families this
slice adds — ``trino_jit_traces_total``, ``trino_profiler_programs_total``,
``trino_profiler_seconds_total`` and the ``trino_hbo_*`` families —
round-tripped through the Prometheus text, with the JAX engine's names,
types and labels; on the CPU neither engine reports
``trino_device_memory_bytes``.
"""

import json
import threading

import pytest

from test_torch_tpch_q1 import _runners
from trino_tpu.telemetry import profiler as jprof
from trino_tpu.telemetry import stats_store as jss
from trino_tpu.telemetry import tracing as jtracing
from trino_tpu.resources.tpch_queries import TPCH_QUERIES
from trino_tpu_torch.events import EventListenerManager, QueryMonitor
from trino_tpu_torch.exec.driver import Driver
from trino_tpu_torch.telemetry import profiler, stats_store, tracing
from trino_tpu_torch.telemetry.metrics import (ClusterMetrics,
                                               MetricsRegistry,
                                               parse_prometheus,
                                               render_prometheus)
from trino_tpu_torch.telemetry.tracing import (NULL_TRACER, Tracer,
                                               critical_path, span_tree,
                                               to_chrome_trace, trace_line)


@pytest.fixture(autouse=True)
def _fresh_process_state():
    for s in (stats_store.store(), jss.store()):
        s.clear()
    profiler.reset()
    jprof.reset()
    yield
    for s in (stats_store.store(), jss.store()):
        s.clear()
    profiler.reset()
    jprof.reset()


# -- the tracer ------------------------------------------------------------


def test_null_tracer_zero_cost():
    with NULL_TRACER.span("query") as s:
        assert s.context() is None and not s
        with NULL_TRACER.span("child", parent=s) as c:
            c.set("k", 1)
    assert NULL_TRACER.finished() == []


def test_cross_process_parenting():
    t = Tracer(process="coordinator")
    with t.span("query") as root:
        ctx = root.context(attempt=2, speculative=False)
        assert ctx["trace_id"] == t.trace_id
        assert ctx["traceparent"].startswith(f"00-{t.trace_id}-")
        w = Tracer(process="worker-9", trace_id=ctx["trace_id"])
        with w.span("task x", parent=ctx) as task:
            assert task.parent_id == root.span_id
            assert task.trace_id == t.trace_id
        t.add_finished(w.finished())
    roots, children, orphans = span_tree(t.finished())
    assert len(roots) == 1 and not orphans
    assert children[root.span_id][0]["name"] == "task x"


def _synthetic_trace():
    """A query span over two task spans, each with operator children —
    the shape a distributed run produces — built by hand."""
    def span(sid, parent, name, start, end, **attrs):
        return {"trace_id": "t", "span_id": sid, "parent_id": parent,
                "name": name, "process": "coordinator", "start": start,
                "end": end, "attrs": attrs}

    return [span("q", None, "query", 0.0, 1.0),
            span("t1", "q", "task 1", 0.1, 0.6, span_kind="task"),
            span("t2", "q", "task 2", 0.2, 0.9, span_kind="task"),
            span("o1", "t2", "ScanOperator", 0.2, 0.5,
                 span_kind="operator", busy_ms=300.0, flops=5.0,
                 compile_ms=1.0),
            span("o2", "t2", "AggOperator", 0.5, 0.85,
                 span_kind="operator", busy_ms=350.0)]


def test_trace_analysis_equals_jax():
    spans = _synthetic_trace()
    assert [s["name"] for s in critical_path(spans)] == \
        ["query", "task 2", "AggOperator"]
    assert critical_path(spans) == jtracing.critical_path(spans)
    assert trace_line(spans) == jtracing.trace_line(spans)
    got = tracing.slow_query_record(spans, 1000.0, 0.5,
                                    worst_misestimate={"name": "X"})
    assert got == jtracing.slow_query_record(
        spans, 1000.0, 0.5, worst_misestimate={"name": "X"})
    assert [o["name"] for o in got["top_operators"]] == \
        ["AggOperator", "ScanOperator"]
    assert tracing.slow_query_record(None, 5.0, 1.0) == \
        jtracing.slow_query_record(None, 5.0, 1.0)


def test_chrome_trace_and_otlp_documents_equal_jax():
    spans = _synthetic_trace()
    doc = json.loads(json.dumps(to_chrome_trace(spans)))
    assert doc == jtracing.to_chrome_trace(spans)
    for e in doc["traceEvents"]:
        assert e["ph"] in ("X", "M")
        if e["ph"] == "X":
            assert e["ts"] >= 0 and e["dur"] >= 0
    assert tracing.to_otlp(spans) == jtracing.to_otlp(spans)


def _stamped_driver(ns0: int):
    """A finished stats-collecting driver as distribution's workers will
    hand ``add_driver_spans``: per operator its first/last active call
    on the host clock, beside the driver's epoch anchor. The port's
    local driver keeps no such stamps, so it stands in."""
    from types import SimpleNamespace

    def stats(name, first, last, wall, rows, pages, **kw):
        base = dict(name=name, first_ns=first, last_ns=last, wall_ns=wall,
                    output_rows=rows, output_pages=pages, compile_count=2,
                    flops=0.0, device_bytes=0.0, compile_ms=0.0,
                    metrics=None)
        return SimpleNamespace(**{**base, **kw})

    return SimpleNamespace(
        collect_stats=True, epoch_anchor=(1_700_000_000.0, ns0),
        stats=[stats("TableScanOperator", ns0 + 1_000_000,
                     ns0 + 9_000_000, 5_000_000, 6000, 2),
               stats("HashAggregationOperator", ns0 + 2_000_000,
                     ns0 + 12_000_000, 7_500_000, 4, 1, flops=1.5e6,
                     device_bytes=2.0e6, compile_ms=0.25,
                     metrics={"kind": "local", "splits": 3}),
               stats("OutputCollectorOperator", 0, 0, 0, 0, 0)])


def test_driver_spans_equal_jax():
    """``add_driver_spans`` of both engines over the same finished
    driver: the same operator spans (ids aside), the never-run operator
    left out, cost and exchange attributes carried; the port's own
    local driver stamps its operators' timeline when it collects stats,
    so it emits one span per operator that ran, and none without
    stats."""

    def spans_of(mod):
        t = mod.Tracer(process="worker", trace_id="t" * 16)
        with t.span("task") as root:
            n = mod.add_driver_spans(t, _stamped_driver(5_000_000_000),
                                     root)
        return n, [{k: v for k, v in s.items()
                    if k not in ("span_id", "parent_id")}
                   for s in t.finished() if s["name"] != "task"]

    n, spans = spans_of(tracing)
    assert (n, spans) == spans_of(jtracing)
    assert n == 2 and [s["name"] for s in spans] == \
        ["TableScanOperator", "HashAggregationOperator"]
    agg = spans[1]
    assert agg["start"] == pytest.approx(1_700_000_000.0 + 2e-3, abs=1e-6)
    assert agg["end"] - agg["start"] == pytest.approx(7.5e-3, abs=1e-6)
    assert agg["attrs"]["compile_ms"] == 0.25
    assert agg["attrs"]["exchange_splits"] == 3
    assert "flops" not in spans[0]["attrs"]
    _, pr = _runners("micro", {"hbo_enabled": False}, page_rows=4096)
    local = pr._make_local_planner()
    plan = local.plan(pr.create_plan(TPCH_QUERIES[1]))
    plan.execute(collect_stats=True)
    local.memory_pool.close()
    t = Tracer(process="coordinator")
    ran = sum(1 for d in plan.drivers for st in d.stats if st.first_ns)
    with t.span("query") as root:
        assert sum(tracing.add_driver_spans(t, d, root)
                   for d in plan.drivers) == ran
    assert ran == sum(len(d.stats) for d in plan.drivers)
    ops = [s for s in t.finished()
           if s["attrs"].get("span_kind") == "operator"]
    assert len(ops) == ran and all(s["parent_id"] == root.span_id
                                   for s in ops)
    assert tracing.add_driver_spans(t, Driver(plan.drivers[0].operators),
                                    root) == 0


class _FakeCollector:
    """A stdlib OTLP collector on 127.0.0.1 that keeps the POSTed
    bodies."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                outer.bodies.append(json.loads(self.rfile.read(n)))
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

        self.bodies = []
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.endpoint = (f"http://127.0.0.1:"
                         f"{self.httpd.server_address[1]}/v1/traces")
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _spans():
    t = Tracer(process="coordinator")
    with t.span("query") as root:
        with t.span("plan", parent=root):
            pass
    return t.finished()


def test_otlp_export_to_fake_collector():
    collector = _FakeCollector()
    try:
        spans = _spans()
        assert tracing.export_otlp(collector.endpoint, spans) is True
        (body,) = collector.bodies
        otlp = [s for r in body["resourceSpans"]
                for sc in r["scopeSpans"] for s in sc["spans"]]
        assert len(otlp) == len(spans)
        for s in otlp:
            assert len(s["traceId"]) == 32 and len(s["spanId"]) == 16
            assert int(s["endTimeUnixNano"]) >= int(s["startTimeUnixNano"])
        assert sum("parentSpanId" not in s for s in otlp) == 1
    finally:
        collector.stop()


def test_otlp_export_failures_are_silent():
    assert tracing.export_otlp("http://127.0.0.1:9/v1/traces",
                               _spans()) is False
    assert tracing.export_otlp("not a url", _spans()) is False
    assert tracing.export_otlp("", _spans()) is False
    assert tracing.export_otlp("http://127.0.0.1:9/v1/traces", []) is False


# -- metrics and events ----------------------------------------------------


def test_metrics_exposition_roundtrip():
    reg = MetricsRegistry()
    reg.counter("trino_t_total", "help").inc(2, kind="a")
    reg.counter("trino_t_total").inc(3, kind="b")
    reg.gauge("trino_g").set(1.25)
    reg.histogram("trino_h").observe(0.4)
    reg.gauge_fn("trino_live", "pull-time", lambda: 7.0)
    cm = ClusterMetrics()
    cm.update(0, [{"name": "trino_g", "type": "gauge", "help": "",
                   "samples": [[{}, 9.0]]}])
    parsed = parse_prometheus(render_prometheus(cm.collect(reg.collect())))
    assert parsed["trino_t_total"][
        '{kind="a",process="coordinator"}'] == 2.0
    assert parsed["trino_g"]['{process="worker",worker="0"}'] == 9.0
    assert parsed["trino_h_count"]['{process="coordinator"}'] == 1.0
    assert parsed["trino_live"]['{process="coordinator"}'] == 7.0


def test_event_history_ring_and_stats_payload():
    mgr = EventListenerManager(history_capacity=2)
    m1 = QueryMonitor(mgr, "alice", "select 1")
    m1.created()
    assert [e.query_id for e in mgr.running()] == [m1.query_id]
    m1.completed(5, stats={"peak_memory_bytes": 123, "wall_ms": 1.5})
    assert mgr.running() == []
    for i in range(3):
        m = QueryMonitor(mgr, "alice", f"select {i}")
        m.created()
        m.completed(1)
    hist = mgr.history(10)
    assert len(hist) == 2 and all(e.state == "FINISHED" for e in hist)
    m2 = QueryMonitor(mgr, "bob", "select 2")
    m2.created()
    m2.completed(1, stats={"peak_memory_bytes": 7})
    assert mgr.history(1)[0].stats == {"peak_memory_bytes": 7}


# -- the new families ------------------------------------------------------


NEW_FAMILIES = ("trino_jit_traces_total", "trino_profiler_programs_total",
                "trino_profiler_seconds_total", "trino_hbo_plan_flips",
                "trino_hbo_store_entries", "trino_hbo_lookups_total",
                "trino_hbo_records_total", "trino_hbo_qerror")


def _families(runner):
    return {f["name"]: f for f in runner.metrics_families()}


def test_new_families_roundtrip_with_jax_names():
    """After the same VERBOSE run (history on) both engines export the
    new families with the same types and label sets, and the port's
    survive the Prometheus text round trip."""
    jr, pr = _runners("micro", None, page_rows=4096)
    for r in (jr, pr):
        r.execute("explain analyze verbose " + TPCH_QUERIES[6])
    jf, pf = _families(jr), _families(pr)
    for name in NEW_FAMILIES:
        assert name in pf and name in jf, name
        assert pf[name]["type"] == jf[name]["type"]
        if name not in ("trino_jit_traces_total",
                        "trino_profiler_seconds_total"):
            assert [sorted(lbl) for lbl, _ in pf[name]["samples"]] == \
                [sorted(lbl) for lbl, _ in jf[name]["samples"]], name
    kinds = {lbl["kind"] for lbl, _ in
             pf["trino_profiler_seconds_total"]["samples"]}
    assert {"trace", "compile"} <= kinds
    # the history families count the same recorded run
    for name in ("trino_hbo_store_entries", "trino_hbo_lookups_total",
                 "trino_hbo_records_total"):
        assert pf[name]["samples"] == jf[name]["samples"], name
    parsed = parse_prometheus(render_prometheus(list(pf.values())))
    programs = parsed["trino_profiler_programs_total"]
    assert programs['{kind="programs"}'] >= 1
    assert programs['{kind="compiles"}'] == programs['{kind="programs"}']
    traces = parsed["trino_jit_traces_total"]
    assert traces['{kernel="page_processor"}'] >= 1
    assert sum(parsed["trino_hbo_qerror_count"].values()) >= 1
    assert "trino_device_memory_bytes" not in pf
    assert "trino_device_memory_bytes" not in jf


def test_first_call_counts_per_program():
    """``trino_jit_traces_total`` counts, per program, its first calls
    at new signatures: a repeat of the same statement adds nothing."""
    _, pr = _runners("micro", {"hbo_enabled": False,
                               "plan_cache_enabled": False},
                     page_rows=4096)
    pr.execute(TPCH_QUERIES[1])

    def counts():
        fam = _families(pr)["trino_jit_traces_total"]
        return {lbl.get("kernel"): v for lbl, v in fam["samples"]}

    before = counts()
    assert before.get("page_processor", 0) >= 1
    pr.execute(TPCH_QUERIES[1])
    after = counts()
    # a fresh plan builds fresh processors (plan cache off), which count
    # their first calls again, as a fresh jit retraces; the module-level
    # programs do not
    assert after.get("hash_group_ids") == before.get("hash_group_ids")
    assert after.get("hash_segment_reduce") == \
        before.get("hash_segment_reduce")
