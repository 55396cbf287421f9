"""The readers of the program's own spans and counters (the statement
spans, the device-read counters, the operators' thread CPU and call
intervals), over synthetic traces and a synthetic device trace, each
value worked out by hand; and each reader's ``None`` where the program
records none of them."""

import pytest

from sqlbench import readers
from sqlbench.devtrace import DeviceOp, DeviceTrace
from sqlbench.instrument import Execution


def _span(sid, parent, name, start, end, **attrs):
    return {"trace_id": "t", "span_id": sid, "parent_id": parent,
            "name": name, "process": "coordinator", "start": start,
            "end": end, "attrs": attrs}


def _statement(tag, t0, stmt_ms, ops, task_reads, root_reads, calls=()):
    """One statement's trace: a root, statement spans of ``stmt_ms``
    each, a task with ``task_reads`` (reads, bytes, wait ms) and one
    operator span per ``(busy_ms, cpu_ms, reads, bytes, wait_ms)``."""
    def counters(r):
        return {} if r is None else dict(
            d2h_reads=r[0], d2h_bytes=r[1], d2h_wait_ms=r[2])

    spans = [_span(f"{tag}q", None, "query", t0, t0 + 1.0,
                   **counters(root_reads))]
    at = t0
    for i, ms in enumerate(stmt_ms):
        spans.append(_span(f"{tag}s{i}", f"{tag}q",
                           ("parse", "plan", "results", "history")[i],
                           at, at + ms / 1e3, span_kind="statement"))
        at += ms / 1e3
    spans.append(_span(f"{tag}t", f"{tag}q", "task f1.0", t0, t0 + 0.9,
                       span_kind="task", **counters(task_reads)))
    for i, (busy, cpu, n, nbytes, wait) in enumerate(ops):
        attrs = dict(span_kind="operator", busy_ms=busy, cpu_ms=cpu)
        if n:
            attrs.update(d2h_reads=n, d2h_bytes=nbytes, d2h_wait_ms=wait)
        if calls and i == 0:
            attrs["calls"] = [list(c) for c in calls]
        spans.append(_span(f"{tag}o{i}", f"{tag}t", f"Op{i}", t0,
                           t0 + busy / 1e3, **attrs))
    return spans


def _run(traces, trace=None):
    records, executions = [], []
    for i, spans in enumerate(traces):
        sql = f"select {i}"
        t0 = 100.0 + 2 * i
        records.append({"sql": sql, "t_post": t0, "t_done": t0 + 1.5,
                        "latency_ms": 1500.0})
        executions.append(Execution(None, sql, t0 + 0.1, t0 + 1.4,
                                    {"trace": spans} if spans else {}))
    return readers.Run(seconds=10.0, window=(100.0, 110.0),
                       records=records, setup_s=1.0,
                       executions=executions, trace=trace)


def _two_statements(calls=()):
    return [
        _statement("a", 100.1, [2.0, 3.0, 1.0, 4.0],
                   [(50.0, 30.0, 3, 2_000_000, 7.5),
                    (20.0, 20.0, 0, 0, 0.0)],
                   (1, 500_000, 0.5), (1, 0, 0.0), calls),
        _statement("b", 102.1, [5.0, 5.0, 5.0, 5.0],
                   [(10.0, 4.0, 5, 1_500_000, 2.0)], None, None)]


@pytest.mark.parametrize("name,want", [
    # (2 + 3 + 1 + 4) ms and (4 x 5) ms: their mean
    ("statement.host_ms", 15.0),
    # a: operator 3 + task 1 + root 1; b: operator 5
    ("operators.d2h_reads", 5.0),
    # a: 2.0 + 0.5 MB; b: 1.5 MB
    ("operators.d2h_mb", 2.0),
    # a: 7.5 + 0.5 ms; b: 2.0 ms
    ("operators.d2h_wait_ms", 5.0),
    # a: (50 - 30) + (20 - 20); b: 10 - 4
    ("operators.offcpu_ms", 13.0),
])
def test_span_reader_by_hand(name, want):
    assert readers.load(name).read(_run(_two_statements())) == \
        pytest.approx(want, abs=1e-9)


def test_idle_outside_ops_by_hand():
    """Device ops over [0, 1] and [2, 3] s of a 10 s window leave 8 s
    idle: [1, 2] and [3, 10]. Calls over [1.5, 2.5], [4, 6] and [5, 7]
    cover 0.5 s of the first gap and 3 s of the second, so 4.5 of the
    8 idle seconds fall outside every call: 56.25%."""
    trace = DeviceTrace(100.0, 110.0, [
        DeviceOp("k", "kernel", 7, 0.0, 1.0),
        DeviceOp("Memcpy DtoH", "gpu_memcpy", 7, 2.0, 3.0)])
    calls = [(101.5, 102.5), (104.0, 106.0), (105.0, 107.0)]
    run = _run(_two_statements(calls), trace)
    assert readers.load("device.idle_outside_ops_pct").read(run) == \
        pytest.approx(56.25, abs=1e-9)


@pytest.mark.parametrize("name", [
    "statement.host_ms", "operators.d2h_reads", "operators.d2h_mb",
    "operators.d2h_wait_ms", "operators.offcpu_ms",
    "device.idle_outside_ops_pct"])
def test_span_reader_reads_nothing_where_the_program_records_none(name):
    """Traces without the program's statement spans, counters and call
    intervals (and no trace at all) read as None, never as zero."""
    bare = [[{**s, "attrs": {k: v for k, v in s["attrs"].items()
                             if k in ("span_kind", "busy_ms")
                             and v != "statement"}}
             for s in spans] for spans in _two_statements()]
    trace = DeviceTrace(100.0, 110.0, [
        DeviceOp("k", "kernel", 7, 0.0, 1.0)])
    reader = readers.load(name)
    assert reader.read(_run(bare, trace)) is None
    assert reader.read(_run([None, None], trace)) is None
    assert reader.read(_run([], None)) is None
