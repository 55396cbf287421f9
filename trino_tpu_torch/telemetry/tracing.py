"""Distributed tracing core: spans, context propagation, exporters.

Reference analog: the reference engine's OpenTelemetry instrumentation —
``io.opentelemetry.api.trace.Span`` opened per query/stage/task/operator
with ``TrinoAttributes``, context propagated to workers in task requests
(W3C ``traceparent``), and the resulting timeline viewable in any trace
UI.  Here the core is dependency-free: spans are plain dicts once
finished, context is a small dict riding the task RPC envelope, and the
export target is the Chrome trace-event JSON format (loadable in
Perfetto / chrome://tracing, one pid lane per process).

Cost model: tracing must be zero-cost when off — ``NULL_TRACER.span()``
returns a shared no-op span, and spans are only opened at host-side
boundaries, never around single device calls.

Clock model: every time is read on ``perf_counter_ns`` and placed on the
epoch clock (the only clock that aligns across processes on one host,
and the one a ``torch.profiler`` trace is exported on) through one
anchor per process, ``ANCHOR_NS``, read once: spans, the drivers'
operator stamps and the device reads' intervals
(``telemetry.device_reads``) share it, so they lie on one clock.

The JAX engine's ``trino_tpu/telemetry/tracing.py``, copied. Its span
producers in the torch engine: the one-card ``DistributedQueryRunner``
(query, stage and task spans, and operator spans from each task's
drivers through ``add_driver_spans``); the slow-query record and the
span analysis are used as they are.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterable, List, Optional, Tuple


#: (epoch ns, perf_counter ns), read together once per process
ANCHOR_NS = (time.time_ns(), time.perf_counter_ns())
#: the same anchor as (epoch seconds, perf_counter ns): the drivers'
#: ``epoch_anchor``
EPOCH_ANCHOR = (ANCHOR_NS[0] / 1e9, ANCHOR_NS[1])


def epoch_s(pc_ns: int) -> float:
    """A ``perf_counter_ns`` reading as epoch seconds."""
    return (ANCHOR_NS[0] + pc_ns - ANCHOR_NS[1]) / 1e9


def _new_id(nbytes: int = 8) -> str:
    return os.urandom(nbytes).hex()


class Span:
    """One timed operation. Context-manager: exceptions mark the span
    failed (``error`` attribute) and still finish it."""

    __slots__ = ("tracer", "trace_id", "span_id", "parent_id", "name",
                 "process", "start", "end", "attrs", "_pc0")

    def __init__(self, tracer: "Tracer", name: str,
                 parent_id: Optional[str], **attrs):
        self.tracer = tracer
        self.trace_id = tracer.trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.name = name
        self.process = tracer.process
        self._pc0 = time.perf_counter_ns()
        self.start = epoch_s(self._pc0)
        self.end: Optional[float] = None
        self.attrs = attrs

    def set(self, key: str, value):
        self.attrs[key] = value

    def context(self, **extra) -> dict:
        """The propagation envelope shipped in task RPCs (W3C
        traceparent semantics: version-trace_id-parent_id-flags, carried
        as a dict so extra baggage — attempt number, fragment — rides
        along without string parsing)."""
        ctx = {"traceparent":
               f"00-{self.trace_id}-{self.span_id}-01",
               "trace_id": self.trace_id, "span_id": self.span_id}
        ctx.update(extra)
        return ctx

    def finish(self):
        if self.end is None:
            self.end = epoch_s(time.perf_counter_ns())
            self.tracer._record(self.to_dict())

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "name": self.name,
            "process": self.process, "start": self.start,
            "end": self.end if self.end is not None else self.start,
            "attrs": dict(self.attrs),
        }

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None:
            self.attrs.setdefault("error", repr(exc))
        self.finish()
        return False


class _NullSpan:
    """The zero-cost-when-off span: every operation is a no-op and
    ``context()`` is None, so nothing is shipped downstream either."""

    __slots__ = ()
    trace_id = span_id = parent_id = None

    def set(self, key, value):
        pass

    def context(self, **extra):
        return None

    def finish(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False


NULL_SPAN = _NullSpan()


def parse_context(ctx: Optional[dict]) -> Tuple[Optional[str],
                                                Optional[str]]:
    """(trace_id, parent_span_id) from a propagation envelope; accepts
    the dict form or a bare traceparent string."""
    if not ctx:
        return None, None
    if isinstance(ctx, str):
        parts = ctx.split("-")
        if len(parts) == 4:
            return parts[1], parts[2]
        return None, None
    if ctx.get("trace_id"):
        return ctx["trace_id"], ctx.get("span_id")
    return parse_context(ctx.get("traceparent"))


class Tracer:
    """Per-query (coordinator) or per-task (worker) span factory.
    Finished spans accumulate as plain dicts — cheap to ship over the
    task RPC response (the heartbeat-piggyback pattern) and to merge
    coordinator-side into one tree."""

    def __init__(self, process: str = "coordinator",
                 trace_id: Optional[str] = None, enabled: bool = True):
        self.enabled = enabled
        self.process = process
        self.trace_id = trace_id or _new_id(8)
        self._finished: List[dict] = []

    def span(self, name: str, parent=None, **attrs):
        """Open a span. ``parent`` is a Span, a propagation-context
        dict, or None (root)."""
        if not self.enabled:
            return NULL_SPAN
        if isinstance(parent, Span):
            parent_id = parent.span_id
        elif parent is None or isinstance(parent, _NullSpan):
            parent_id = None
        else:
            tid, parent_id = parse_context(parent)
            if tid:
                self.trace_id = tid
        return Span(self, name, parent_id, **attrs)

    def _record(self, span_dict: dict):
        self._finished.append(span_dict)

    def add_finished(self, spans: Optional[Iterable[dict]]):
        """Merge remote (worker-produced) finished spans in."""
        if spans:
            self._finished.extend(spans)

    def finished(self) -> List[dict]:
        return list(self._finished)


NULL_TRACER = Tracer(enabled=False)


def add_driver_spans(tracer: Tracer, driver, parent) -> int:
    """Emit one span per operator of a finished Driver from its
    collected stats (the driver records first/last activity timestamps;
    span duration is the operator's BUSY wall so operator spans of one
    task sum to ~the task's execution wall). Where nonzero, a span also
    carries its operator's device reads (``d2h_reads``, ``d2h_bytes``,
    ``d2h_wait_ms``) and thread CPU (``cpu_ms``), and, for what ran
    while a torch.profiler session recorded, ``calls`` (each call's
    ``[start, end]``) and ``reads`` (each read's ``[start, end, site,
    bytes]``) in epoch seconds. Returns spans emitted."""
    if not tracer.enabled or not getattr(driver, "collect_stats", False):
        return 0
    anchor = getattr(driver, "epoch_anchor", None)
    if anchor is None:
        return 0
    # pull operator-reported metrics (exchange flow/replay counters)
    # into the stats entries so the spans carry them — streaming output
    # drivers have no other stats-rendering path
    collect = getattr(driver, "collect_operator_metrics", None)
    if collect is not None:
        collect()
    epoch0, pc0 = anchor
    parent_id = parent.span_id if isinstance(parent, Span) else \
        parse_context(parent)[1]
    n = 0
    for st in driver.stats:
        if st.first_ns == 0:
            continue  # operator never ran a quantum
        start = epoch0 + (st.first_ns - pc0) / 1e9
        span = {
            "trace_id": tracer.trace_id, "span_id": _new_id(),
            "parent_id": parent_id, "name": st.name,
            "process": tracer.process, "start": start,
            "end": start + st.wall_ns / 1e9,
            "attrs": {"rows": st.output_rows, "pages": st.output_pages,
                      "busy_ms": round(st.wall_ns / 1e6, 3),
                      "compiles": st.compile_count,
                      "span_kind": "operator",
                      "last_activity": epoch0 + (st.last_ns - pc0) / 1e9},
        }
        # profiler cost attribution (EXPLAIN ANALYZE VERBOSE): the span
        # carries its operator's flops/bytes/compile wall so the
        # critical path can split compile-vs-execute
        if st.flops or st.compile_ms:
            span["attrs"]["flops"] = st.flops
            span["attrs"]["device_bytes"] = st.device_bytes
            span["attrs"]["compile_ms"] = round(st.compile_ms, 3)
        if st.metrics:
            for key in ("kind", "first_page_ms", "reconnects",
                        "replayed_frames", "skew_ratio",
                        "lane_skew_ratio", "splits", "rebalances",
                        "source_fragment"):
                if st.metrics.get(key) is not None:
                    span["attrs"][f"exchange_{key}"] = st.metrics[key]
        span["attrs"].update(span_counters(st))
        cpu_ns = getattr(st, "cpu_ns", 0)
        if cpu_ns:
            span["attrs"]["cpu_ms"] = round(cpu_ns / 1e6, 3)
        calls = getattr(st, "call_spans", None)
        if calls:
            span["attrs"]["calls"] = [[epoch_s(a), epoch_s(b)]
                                      for a, b in calls]
        tracer._record(span)
        n += 1
    return n


def span_counters(target) -> dict:
    """A charge target's device reads (``device_reads.Reads`` or an
    ``OperatorStats``) as span attributes: the counters where nonzero,
    and ``reads`` where the target kept intervals."""
    n = getattr(target, "d2h_reads", 0)
    if not n:
        return {}
    out = {"d2h_reads": n, "d2h_bytes": target.d2h_bytes,
           "d2h_wait_ms": round(target.d2h_wait_ns / 1e6, 3)}
    if target.read_spans:
        out["reads"] = [[epoch_s(a), epoch_s(b), site, nbytes]
                        for a, b, site, nbytes in target.read_spans]
    return out


# -- tree assembly + analysis ---------------------------------------------


def span_tree(spans: List[dict]) -> Tuple[List[dict],
                                          Dict[str, List[dict]],
                                          List[dict]]:
    """(roots, children-by-parent-id, orphans). An orphan is a non-root
    span whose parent_id matches no span in the set — the connectivity
    property the distributed assembly must preserve."""
    by_id = {s["span_id"]: s for s in spans}
    children: Dict[str, List[dict]] = {}
    roots, orphans = [], []
    for s in spans:
        pid = s.get("parent_id")
        if pid is None:
            roots.append(s)
        elif pid in by_id:
            children.setdefault(pid, []).append(s)
        else:
            orphans.append(s)
    for kids in children.values():
        kids.sort(key=lambda s: s["start"])
    return roots, children, orphans


def critical_path(spans: List[dict]) -> List[dict]:
    """Root-to-leaf chain following, at each level, the child whose end
    time is latest — the spans that bound the query's execution. The
    coordinator's statement spans (``span_kind`` ``statement``: parse,
    plan, results, history) bracket the execution and are passed over
    where a span has other children."""
    roots, children, _ = span_tree(spans)
    if not roots:
        return []
    path = [max(roots, key=lambda s: s["end"] - s["start"])]
    while True:
        kids = children.get(path[-1]["span_id"])
        if not kids:
            return path
        kids = [k for k in kids if k.get("attrs", {}).get("span_kind")
                != "statement"] or kids
        path.append(max(kids, key=lambda s: s["end"]))


def trace_line(spans: List[dict]) -> Optional[str]:
    """One EXPLAIN ANALYZE line: the critical path with per-span
    durations, plus tree-health counts.  When operator spans carry
    profiler cost attribution (VERBOSE runs), the line also splits the
    path's wall into compile vs execute — the "why was it slow"
    attribution a wall-clock breakdown alone cannot give."""
    if not spans:
        return None
    path = critical_path(spans)
    _, _, orphans = span_tree(spans)
    steps = " > ".join(
        f"{s['name']} {(s['end'] - s['start']) * 1e3:.1f}ms"
        for s in path)
    line = (f"Trace: {len(spans)} spans ({len(orphans)} orphans), "
            f"critical path: {steps}")
    # compile wall over the WHOLE tree (operator spans are leaves, so
    # no double counting): the critical path frequently ends on a
    # consumer waiting at an exchange while the compile burned inside
    # producer tasks — attribution must not vanish with it.  Summed
    # compile can exceed the root wall when processes compile in
    # parallel; execute clamps at zero.
    compile_ms = sum(s.get("attrs", {}).get("compile_ms", 0.0)
                     for s in spans)
    if compile_ms:
        total_ms = (path[0]["end"] - path[0]["start"]) * 1e3
        line += (f" [compile {compile_ms:.1f}ms / execute "
                 f"{max(total_ms - compile_ms, 0.0):.1f}ms]")
    return line


def slow_query_record(spans: Optional[List[dict]], wall_ms: float,
                      threshold_s: float,
                      worst_misestimate: Optional[dict] = None) -> dict:
    """The structured slow-query log record
    (``slow_query_log_threshold``): wall + threshold, the trace
    critical path, the top-3 cost-attributed operators (by busy wall,
    carrying flops/compile-ms when the profiler recorded them), and —
    when history-based statistics recorded the run — the worst-Q-error
    plan node (name, estimate, actual): misestimates surface exactly
    where slow queries are triaged.  One builder shared by every
    runner so the system.runtime.queries renderings cannot drift."""
    record = {"wall_ms": round(wall_ms, 2), "threshold_s": threshold_s,
              "critical_path": None, "top_operators": [],
              "worst_misestimate": worst_misestimate}
    if spans:
        record["critical_path"] = [
            {"name": s["name"],
             "ms": round((s["end"] - s["start"]) * 1e3, 1)}
            for s in critical_path(spans)]
        ops = [s for s in spans
               if s.get("attrs", {}).get("span_kind") == "operator"]
        ops.sort(key=lambda s: -s["attrs"].get("busy_ms", 0.0))
        record["top_operators"] = [
            {"name": s["name"],
             "busy_ms": s["attrs"].get("busy_ms", 0.0),
             "flops": s["attrs"].get("flops", 0.0),
             "compile_ms": s["attrs"].get("compile_ms", 0.0)}
            for s in ops[:3]]
    return record


# -- Chrome trace-event export --------------------------------------------


def to_chrome_trace(spans: List[dict]) -> dict:
    """Chrome trace-event JSON (Perfetto-loadable): one complete ("X")
    event per span, one pid lane per process (coordinator, worker-NNN),
    tids grouping operator spans under their task. Timestamps are
    microseconds relative to the earliest span so the viewer opens at
    t=0."""
    if not spans:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(s["start"] for s in spans)
    pids: Dict[str, int] = {}
    tids: Dict[Tuple[int, str], int] = {}
    events: List[dict] = []

    def pid_for(process: str) -> int:
        if process not in pids:
            pids[process] = len(pids) + 1
            events.append({"name": "process_name", "ph": "M",
                           "pid": pids[process], "tid": 0,
                           "args": {"name": process}})
        return pids[process]

    by_id = {s["span_id"]: s for s in spans}

    def lane_for(s: dict) -> str:
        # operator/exec spans share their owning task's lane; everything
        # else gets a lane per span name (plan/fragment/attempt rows)
        cur = s
        seen = 0
        while cur is not None and seen < 16:
            task = cur.get("attrs", {}).get("task_id")
            if task:
                return str(task)
            cur = by_id.get(cur.get("parent_id"))
            seen += 1
        return s["name"]

    for s in spans:
        pid = pid_for(s.get("process") or "?")
        lane = lane_for(s)
        key = (pid, lane)
        if key not in tids:
            tids[key] = len(tids) + 1
            events.append({"name": "thread_name", "ph": "M",
                           "pid": pid, "tid": tids[key],
                           "args": {"name": lane}})
        args = {k: v for k, v in s.get("attrs", {}).items()
                if isinstance(v, (str, int, float, bool))}
        args["span_id"] = s["span_id"]
        if s.get("parent_id"):
            args["parent_id"] = s["parent_id"]
        events.append({
            "name": s["name"], "cat": "span", "ph": "X",
            "ts": round((s["start"] - t0) * 1e6, 3),
            "dur": round(max(0.0, s["end"] - s["start"]) * 1e6, 3),
            "pid": pid, "tid": tids[key], "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"trace_id": spans[0].get("trace_id")}}


# -- OTLP JSON-over-HTTP export --------------------------------------------


def to_otlp(spans: List[dict], service: str = "trino-tpu") -> dict:
    """The OTLP/HTTP JSON body (`ExportTraceServiceRequest`): one
    resourceSpans entry per process, span/trace ids zero-padded to the
    OTLP widths (16/8 bytes hex), attrs as typed attribute pairs."""
    by_process: Dict[str, List[dict]] = {}
    for s in spans:
        by_process.setdefault(s.get("process") or "?", []).append(s)

    def attr_value(v):
        if isinstance(v, bool):
            return {"boolValue": v}
        if isinstance(v, int):
            return {"intValue": str(v)}
        if isinstance(v, float):
            return {"doubleValue": v}
        return {"stringValue": str(v)}

    resource_spans = []
    for process, group in sorted(by_process.items()):
        otlp_spans = []
        for s in group:
            attrs = [{"key": k, "value": attr_value(v)}
                     for k, v in sorted(s.get("attrs", {}).items())
                     if isinstance(v, (str, int, float, bool))]
            span = {
                "traceId": (s.get("trace_id") or "").rjust(32, "0"),
                "spanId": (s.get("span_id") or "").rjust(16, "0"),
                "name": s["name"],
                "kind": 1,  # SPAN_KIND_INTERNAL
                "startTimeUnixNano": str(int(s["start"] * 1e9)),
                "endTimeUnixNano": str(int(s["end"] * 1e9)),
                "attributes": attrs,
            }
            if s.get("parent_id"):
                span["parentSpanId"] = s["parent_id"].rjust(16, "0")
            otlp_spans.append(span)
        resource_spans.append({
            "resource": {"attributes": [
                {"key": "service.name",
                 "value": {"stringValue": f"{service}:{process}"}}]},
            "scopeSpans": [{"scope": {"name": "trino-tpu"},
                            "spans": otlp_spans}],
        })
    return {"resourceSpans": resource_spans}


def export_otlp(endpoint: str, spans: List[dict],
                timeout: float = 2.0) -> bool:
    """Best-effort POST of the finished span tree to an OTLP/HTTP
    collector (``tracing_otlp_endpoint``).  Returns True on a 2xx ack;
    every failure — bad endpoint, refused connection, non-2xx — is
    swallowed (an observability export must never fail or stall a
    query; the reference exporter contract)."""
    if not endpoint or not spans:
        return False
    import json as _json
    import urllib.request

    try:
        body = _json.dumps(to_otlp(spans)).encode()
        req = urllib.request.Request(
            endpoint, data=body,
            headers={"Content-Type": "application/json"},
            method="POST")
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return 200 <= resp.status < 300
    except Exception:  # qlint: ignore[taxonomy] span export is best-effort: a dead collector must never fail the query path
        return False
