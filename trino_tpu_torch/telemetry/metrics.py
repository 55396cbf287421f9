"""Cluster metrics registry: counters/gauges/histograms + Prometheus
text exposition.

Reference analog: the reference engine's JMX metrics tree (airlift
``@Managed`` beans) scraped through the jmx connector / the
``/v1/status`` surface, compressed to the Prometheus exposition format
everyone actually scrapes.  Process-local registries on every worker
snapshot into JSON-able "families"; snapshots PIGGYBACK on the
heartbeat ping (no extra RPC) and the
coordinator's ``ClusterMetrics`` merges them under a ``worker`` label
for ``GET /v1/metrics`` and ``system.runtime.metrics``.

A family is a plain dict (pickles over the worker RPC, JSONs over
HTTP)::

    {"name": "trino_node_memory_reserved_bytes", "type": "gauge",
     "help": "...", "samples": [[{"worker": "0"}, 123.0], ...]}

Histogram sample values are ``{"count": n, "sum": s,
"buckets": [[le, cumulative_count], ...]}``.

The JAX engine's ``trino_tpu/telemetry/metrics.py``, copied.
``process_families`` exports every family of the JAX engine's.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

#: default histogram buckets (seconds-scale: query/task latencies)
DEFAULT_BUCKETS = (0.005, 0.025, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                   30.0, 60.0, float("inf"))


def _labelkey(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Metric:
    """One family: name + help + per-labelset values."""

    def __init__(self, kind: str, name: str, help_: str,
                 buckets: Optional[Tuple[float, ...]] = None):
        self.kind = kind
        self.name = name
        self.help = help_
        self.buckets = tuple(buckets or DEFAULT_BUCKETS) \
            if kind == "histogram" else None
        self._values: Dict[Tuple, object] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1, **labels):
        assert self.kind == "counter", self.name
        key = _labelkey(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def set(self, value: float, **labels):
        assert self.kind == "gauge", self.name
        with self._lock:
            self._values[_labelkey(labels)] = float(value)

    def observe(self, value: float, **labels):
        assert self.kind == "histogram", self.name
        key = _labelkey(labels)
        with self._lock:
            h = self._values.get(key)
            if h is None:
                h = self._values[key] = {
                    "count": 0, "sum": 0.0,
                    "buckets": [[le, 0] for le in self.buckets]}
            h["count"] += 1
            h["sum"] += value
            for b in h["buckets"]:
                if value <= b[0]:
                    b[1] += 1

    def family(self) -> dict:
        with self._lock:
            samples = [[dict(k), v if not isinstance(v, dict)
                        else {"count": v["count"], "sum": v["sum"],
                              "buckets": [list(b) for b in v["buckets"]]}]
                       for k, v in self._values.items()]
        return {"name": self.name, "type": self.kind, "help": self.help,
                "samples": samples}


class MetricsRegistry:
    """Process-local registry. ``counter``/``gauge``/``histogram`` are
    get-or-create (idempotent across call sites); ``gauge_fn`` registers
    a pull-time callable so live state (pool bytes, queue depths) is
    sampled at scrape/heartbeat time, not mirrored on every change."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._gauge_fns: List[Tuple[str, str, Dict[str, str],
                                    Callable[[], float]]] = []
        self._lock = threading.Lock()

    def _get(self, kind: str, name: str, help_: str,
             buckets=None) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Metric(kind, name, help_,
                                                 buckets)
            assert m.kind == kind, f"{name}: {m.kind} != {kind}"
            return m

    def counter(self, name: str, help_: str = "") -> Metric:
        return self._get("counter", name, help_)

    def gauge(self, name: str, help_: str = "") -> Metric:
        return self._get("gauge", name, help_)

    def histogram(self, name: str, help_: str = "",
                  buckets=None) -> Metric:
        return self._get("histogram", name, help_, buckets)

    def gauge_fn(self, name: str, help_: str,
                 fn: Callable[[], float], **labels):
        with self._lock:
            self._gauge_fns.append((name, help_, dict(labels), fn))

    def collect(self) -> List[dict]:
        with self._lock:
            metrics = list(self._metrics.values())
            fns = list(self._gauge_fns)
        families = [m.family() for m in metrics]
        pulled: Dict[str, dict] = {}
        for name, help_, labels, fn in fns:
            try:
                value = float(fn())
            except Exception:  # qlint: ignore[taxonomy] arbitrary user gauge fn: a broken source must not fail the scrape
                continue
            fam = pulled.setdefault(name, {"name": name, "type": "gauge",
                                           "help": help_, "samples": []})
            fam["samples"].append([labels, value])
        return families + list(pulled.values())


def relabel(families: Iterable[dict], **extra) -> List[dict]:
    """Stamp extra labels (e.g. worker="2") onto every sample."""
    out = []
    for f in families:
        out.append({**f, "samples": [[{**lbl, **{k: str(v) for k, v
                                                 in extra.items()}}, val]
                                     for lbl, val in f["samples"]]})
    return out


def merge_families(*family_lists: Iterable[dict]) -> List[dict]:
    """Concatenate samples of same-name families (label sets are assumed
    disjoint — relabel per source first)."""
    merged: Dict[str, dict] = {}
    for families in family_lists:
        for f in families:
            cur = merged.get(f["name"])
            if cur is None:
                merged[f["name"]] = {**f,
                                     "samples": list(f["samples"])}
            else:
                cur["samples"].extend(f["samples"])
                if not cur.get("help"):
                    cur["help"] = f.get("help", "")
    return [merged[k] for k in sorted(merged)]


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    return repr(float(v))


def render_prometheus(families: Iterable[dict]) -> str:
    """Prometheus text exposition format 0.0.4."""
    lines: List[str] = []
    for f in families:
        name = f["name"]
        if f.get("help"):
            lines.append(f"# HELP {name} {f['help']}")
        lines.append(f"# TYPE {name} {f['type']}")
        for labels, value in f["samples"]:
            if f["type"] == "histogram":
                for le, count in value["buckets"]:
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels({**labels, 'le': _fmt_value(le)})}"
                        f" {count}")
                lines.append(
                    f"{name}_sum{_fmt_labels(labels)} {value['sum']}")
                lines.append(
                    f"{name}_count{_fmt_labels(labels)} {value['count']}")
            else:
                lines.append(
                    f"{name}{_fmt_labels(labels)} {_fmt_value(value)}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> Dict[str, Dict[str, float]]:
    """Minimal exposition parser (tests + system.runtime.metrics round
    trips): {metric_name: {label_string: value}}."""
    out: Dict[str, Dict[str, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        head, _, val = line.rpartition(" ")
        if "{" in head:
            name, _, rest = head.partition("{")
            labels = "{" + rest
        else:
            name, labels = head, ""
        try:
            out.setdefault(name, {})[labels] = float(val)
        except ValueError:
            continue
    return out


# -- shared process-level sources -----------------------------------------


def process_families(tasks: Optional[int] = None,
                     memory: Optional[dict] = None) -> List[dict]:
    """Metric families every engine process exports: program first-call
    counters (``trino_jit_traces_total``, see ``jit_stats``), the
    exchange's split and the writer rebalancer's process counters, the
    program profiler's totals and the card's memory once used, the
    history-store families, and — when provided — the node memory-pool
    snapshot and the running-task count.  ``memory`` must be the SAME
    snapshot a heartbeat would ship (NodeMemoryPool snapshots consume
    deltas on read)."""
    from .. import jit_stats

    reg = MetricsRegistry()
    traces = jit_stats.counts()
    jit = reg.counter("trino_jit_traces_total",
                      "First calls of a program at a new signature "
                      "(shapes, dtypes, static values) per program")
    for kernel, n in sorted(traces.items()):
        jit.inc(n, kernel=kernel)
    if not traces:
        jit.inc(0)
    from ..parallel.device_exchange import DeviceExchange
    from ..parallel.rebalancer import UniformPartitionRebalancer

    reg.counter(
        "trino_exchange_splits_total",
        "Hot partitions split across receiver lanes by the device "
        "exchange").inc(DeviceExchange.total_splits)
    reg.counter(
        "trino_writer_rebalances_total",
        "Scaled-writer partition->lane reassignments").inc(
            UniformPartitionRebalancer.total_rebalances)
    if tasks is not None:
        reg.gauge("trino_worker_tasks",
                  "Tasks currently tracked by this process").set(tasks)
    if memory:
        g = reg.gauge("trino_node_memory_bytes",
                      "Node memory pool state (kind=max|reserved|peak)")
        g.set(memory.get("max_bytes", 0), kind="max")
        g.set(memory.get("reserved_bytes", 0), kind="reserved")
        g.set(memory.get("peak_bytes", 0), kind="peak")
        reg.gauge("trino_node_memory_queries",
                  "Queries holding reservations on this node").set(
            len(memory.get("queries", {})))
    from . import profiler

    ptot = profiler.totals()
    if ptot["programs"]:
        pc = reg.counter(
            "trino_profiler_programs_total",
            "Program profiler registry counters "
            "(kind=programs|compiles|fallbacks)")
        pc.inc(ptot["programs"], kind="programs")
        pc.inc(ptot["compiles"], kind="compiles")
        pc.inc(ptot["fallbacks"], kind="fallbacks")
        ps = reg.counter(
            "trino_profiler_seconds_total",
            "Seconds recorded by the program profiler "
            "(kind=trace|compile|execute; trace is 0 for torch programs, "
            "compile is the kernel library's build, execute the CUDA-event "
            "spans of outer calls)")
        ps.inc(ptot["trace_ms"] / 1e3, kind="trace")
        ps.inc(ptot["compile_ms"] / 1e3, kind="compile")
        ps.inc(ptot["outer_execute_ms"] / 1e3, kind="execute")
    dm = profiler.device_memory_stats()
    if dm:
        g = reg.gauge("trino_device_memory_bytes",
                      "CUDA allocator memory summed over the devices "
                      "(kind=live|peak|limit; limit is the total)")
        g.set(dm["live_bytes"], kind="live")
        g.set(dm["peak_bytes"], kind="peak")
        g.set(dm["limit_bytes"], kind="limit")
    from . import stats_store

    # trino_hbo_*: store size, lookup outcomes, and the misestimate
    # histogram — empty until the first HBO-recorded query
    return reg.collect() + stats_store.store().families()


class ClusterMetrics:
    """Coordinator-side aggregation of heartbeat-piggybacked worker
    metric snapshots (reference: ClusterMemoryManager's MemoryInfo
    polling, applied to the whole metrics surface)."""

    def __init__(self):
        self._snapshots: Dict[int, List[dict]] = {}
        self._lock = threading.Lock()

    def update(self, worker_id: int, families: Optional[List[dict]]):
        with self._lock:
            if families is None:
                self._snapshots.pop(worker_id, None)
            else:
                self._snapshots[worker_id] = families

    def forget(self, worker_id: int):
        self.update(worker_id, None)

    def collect(self, coordinator_families: Iterable[dict] = ()
                ) -> List[dict]:
        with self._lock:
            per_worker = [(wid, fams) for wid, fams
                          in sorted(self._snapshots.items())]
        sources = [relabel(list(coordinator_families),
                           process="coordinator")]
        for wid, fams in per_worker:
            sources.append(relabel(fams, process="worker", worker=wid))
        return merge_families(*sources)
