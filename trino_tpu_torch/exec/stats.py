"""Query/stage/task stats tree for distributed execution.

Reference analog: ``execution/QueryStats.java`` / ``StageInfo`` /
``TaskStats`` / ``OperatorStats`` — the hierarchy the coordinator
aggregates from task status updates and serves on ``/v1/query/{id}``
and through EXPLAIN ANALYZE.

The JAX engine's ``trino_tpu/exec/stats.py``, with the torch engine's
operator fields (the programs' CUDA-event device ms and program names)
summed across a stage's tasks and carried into the task dicts.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .driver import OperatorStats


@dataclass
class TaskStatsTree:
    task_id: int
    operators: List[OperatorStats] = field(default_factory=list)

    @property
    def wall_ns(self) -> int:
        return sum(o.wall_ns for o in self.operators)

    @property
    def output_rows(self) -> int:
        # the tail operator is a sink (output buffer / collector): stage
        # output = rows produced by the operator feeding it
        if len(self.operators) >= 2:
            return self.operators[-2].output_rows
        return self.operators[-1].output_rows if self.operators else 0

    def to_dict(self) -> dict:
        return {
            "task_id": self.task_id,
            "wall_ms": round(self.wall_ns / 1e6, 2),
            "operators": [
                {"name": o.name, "rows": o.output_rows,
                 "pages": o.output_pages,
                 "wall_ms": round(o.wall_ns / 1e6, 2),
                 "compiles": o.compile_count,
                 **({"flops": o.flops,
                     "device_bytes": o.device_bytes,
                     "compile_ms": round(o.compile_ms, 2)}
                    if (o.flops or o.compile_ms) else {}),
                 **({"device_ms": round(o.device_ms, 3),
                     "programs": sorted(o.programs)}
                    if o.programs else {}),
                 **({"exchange": o.metrics} if o.metrics else {})}
                for o in self.operators],
        }


@dataclass
class StageStatsTree:
    stage_id: int
    partitioning: str
    output_kind: str
    tasks: List[TaskStatsTree] = field(default_factory=list)
    #: output-boundary exchange skew stats (device collective or host
    #: buffer — the same dict surface either way), attached by the
    #: runner once the query completes
    exchange: Optional[Dict] = None

    def to_dict(self) -> dict:
        return {
            "stage_id": self.stage_id,
            "partitioning": self.partitioning,
            "output_kind": self.output_kind,
            "exchange": self.exchange,
            "tasks": [t.to_dict() for t in self.tasks],
        }

    def exchange_line(self) -> Optional[str]:
        """One EXPLAIN ANALYZE line for this stage's output exchange:
        identical shape for the device-collective and host paths."""
        ex = self.exchange
        if not ex:
            return None
        parts = [f"exchange [{ex.get('kind', '?')}]:",
                 f"{ex.get('rows', 0)} rows,",
                 f"skew {ex.get('skew_ratio', 0.0):.2f}"]
        if ex.get("sizing") is not None:
            parts.append(f", sizing={ex['sizing']}")
        if ex.get("per_dest") is not None:
            parts.append(f", per_dest={ex['per_dest']}")
        parts.append(f", retries={ex.get('a2a_retries', 0)}")
        if ex.get("splits"):
            # hot partitions split across receiver lanes, e.g.
            # "splits=1x4 (lane skew 1.02)" — the receive-side answer
            # to one partition capping the collective
            parts.append(
                f", splits={ex['splits']}x{ex.get('split_ways', 1)}"
                f" (lane skew {ex.get('lane_skew_ratio', 0.0):.2f})")
        if ex.get("rebalances") is not None:
            parts.append(
                f", rebalances={ex['rebalances']}"
                f" ({ex.get('scaled_partitions', 0)} scaled/"
                f"{ex.get('logical_partitions', 0)} logical -> "
                f"{ex.get('writer_lanes', 0)} lanes)")
        if ex.get("data_collectives"):
            parts.append(
                f", collectives={ex.get('count_collectives', 0)}"
                f"+{ex['data_collectives']}")
        if ex.get("bytes_moved") is not None:
            parts.append(f", {ex['bytes_moved']} bytes moved")
        return " ".join(p.strip() for p in parts).replace(" ,", ",")


@dataclass
class QueryStatsTree:
    stages: List[StageStatsTree] = field(default_factory=list)
    wall_ms: float = 0.0
    memory: Optional[Dict] = None
    #: ClusterMemoryManager.cluster_stats(): worker count, cluster-wide
    #: reserved/max bytes, blocked nodes, low-memory kills + policy —
    #: the coordinator's memory-governance view of this query's run
    cluster_memory: Optional[Dict] = None
    #: self-healing counters for this query (fault.RecoveryStats dict):
    #: attempts, retries by error type, backoff wall-time, workers
    #: replaced, speculative launches/wins — attached by the process
    #: runner so EXPLAIN ANALYZE and the bench surface recovery
    recovery: Optional[Dict] = None
    #: finished distributed-trace spans (telemetry.tracing dicts):
    #: coordinator root/plan/fragment/attempt spans + the worker
    #: task/operator spans piggybacked on task responses — the timeline
    #: the Chrome-trace export and the Trace: line render
    trace: Optional[List[dict]] = None
    #: history-based statistics: node-fingerprint -> estimated rows
    #: (as planned, history consulted) so render() can print per-node
    #: Q-error beside the actual, plus the worst-misestimate summary
    estimates: Optional[Dict[str, float]] = None
    worst_misestimate: Optional[Dict] = None

    def to_dict(self) -> dict:
        return {
            "wall_ms": round(self.wall_ms, 2),
            "memory": self.memory,
            "cluster_memory": self.cluster_memory,
            "recovery": self.recovery,
            "trace": self.trace,
            "stages": [s.to_dict() for s in self.stages],
        }

    def trace_line(self) -> Optional[str]:
        """One EXPLAIN ANALYZE line: span count + the critical path
        through the assembled trace tree; None when tracing was off."""
        if not self.trace:
            return None
        from ..telemetry.tracing import trace_line

        return trace_line(self.trace)

    def cluster_memory_line(self) -> Optional[str]:
        """One EXPLAIN ANALYZE line for the cluster memory view; None
        when no worker reported a pool (local runs stay clean)."""
        cm = self.cluster_memory
        if not cm or not cm.get("workers"):
            return None
        return (f"Cluster memory: {cm.get('total_reserved_bytes', 0)} / "
                f"{cm.get('total_max_bytes', 0)} bytes reserved over "
                f"{cm['workers']} workers, "
                f"{cm.get('blocked_nodes', 0)} blocked, "
                f"{cm.get('kills', 0)} kills "
                f"[{cm.get('killer_policy', 'none')}]")

    def recovery_line(self) -> Optional[str]:
        """One EXPLAIN ANALYZE line summarizing what self-healing did;
        None when the query saw no faults (keep clean plans clean)."""
        r = self.recovery
        if not r:
            return None
        interesting = (r.get("task_retries", 0) or
                       r.get("query_retries", 0) or
                       r.get("workers_replaced", 0) or
                       r.get("speculative_launched", 0))
        if not interesting:
            return None
        by_type = ", ".join(f"{k}={v}" for k, v in
                            sorted(r.get("retries_by_type", {}).items()))
        return (f"Recovery: {r.get('task_attempts', 0)} task attempts, "
                f"{r.get('task_retries', 0)} task retries + "
                f"{r.get('query_retries', 0)} query retries"
                + (f" [{by_type}]" if by_type else "")
                + f", backoff {r.get('backoff_wall_s', 0.0):.2f}s, "
                f"workers replaced {r.get('workers_replaced', 0)}, "
                f"speculative {r.get('speculative_wins', 0)}/"
                f"{r.get('speculative_launched', 0)} won")

    def render(self) -> List[str]:
        """EXPLAIN ANALYZE text: stages top-down with per-task operator
        rows/pages/wall (reference: planprinter/PlanPrinter +
        TextRenderer)."""
        lines: List[str] = []
        lines.append(f"Query: {self.wall_ms:.1f}ms")
        if self.memory:
            disk = ""
            if self.memory.get("disk_spill_events") is not None:
                disk = (f", disk {self.memory['disk_spill_events']} "
                        f"files "
                        f"({self.memory.get('disk_spilled_bytes', 0)} "
                        f"bytes)")
            lines.append(
                f"Memory: peak {self.memory.get('peak_bytes', 0)} bytes, "
                f"{self.memory.get('spill_events', 0)} spills "
                f"({self.memory.get('spilled_bytes', 0)} bytes)" + disk)
        cm_line = self.cluster_memory_line()
        if cm_line:
            lines.append(cm_line)
        rec_line = self.recovery_line()
        if rec_line:
            lines.append(rec_line)
        tr_line = self.trace_line()
        if tr_line:
            lines.append(tr_line)
        for s in sorted(self.stages, key=lambda s: -s.stage_id):
            total_rows = sum(t.output_rows for t in s.tasks)
            lines.append(
                f"Stage {s.stage_id} [{s.partitioning} -> "
                f"{s.output_kind}] {len(s.tasks)} tasks, "
                f"{total_rows} rows out")
            ex_line = s.exchange_line()
            if ex_line:
                lines.append("    " + ex_line)
            # aggregate the per-operator view across tasks (positional:
            # every task of a stage runs the same operator chain)
            agg: Dict[int, OperatorStats] = {}
            for t in s.tasks:
                for i, o in enumerate(t.operators):
                    a = agg.get(i)
                    if a is None:
                        agg[i] = OperatorStats(o.name, o.output_rows,
                                               o.output_pages, o.wall_ns,
                                               o.compile_count,
                                               flops=o.flops,
                                               device_bytes=o.device_bytes,
                                               compile_ms=o.compile_ms,
                                               device_ms=o.device_ms,
                                               programs=set(o.programs),
                                               metrics=o.metrics,
                                               node_fp=o.node_fp,
                                               d2h_reads=o.d2h_reads,
                                               d2h_bytes=o.d2h_bytes,
                                               d2h_wait_ns=o.d2h_wait_ns)
                    else:
                        a.output_rows += o.output_rows
                        a.output_pages += o.output_pages
                        a.wall_ns += o.wall_ns
                        a.compile_count += o.compile_count
                        a.flops += o.flops
                        a.device_bytes += o.device_bytes
                        a.compile_ms += o.compile_ms
                        a.device_ms += o.device_ms
                        a.programs |= o.programs
                        a.d2h_reads += o.d2h_reads
                        a.d2h_bytes += o.d2h_bytes
                        a.d2h_wait_ns += o.d2h_wait_ns
                        # exchange metrics describe the ONE shared
                        # boundary object; every task reports the same
                        # dict, so keep the first
                        if a.metrics is None:
                            a.metrics = o.metrics
            for i in sorted(agg):
                line = "    " + agg[i].line()
                est = (self.estimates or {}).get(agg[i].node_fp) \
                    if agg[i].node_fp is not None else None
                if est is not None:
                    from ..telemetry.stats_store import q_error

                    line += (f" [est {est:.0f} rows, q="
                             f"{q_error(est, agg[i].output_rows):.2f}]")
                lines.append(line)
            for t in s.tasks:
                lines.append(f"    task {t.task_id}: "
                             f"{t.output_rows} rows, "
                             f"{t.wall_ns / 1e6:.1f}ms")
        if self.worst_misestimate:
            w = self.worst_misestimate
            lines.append(
                f"Worst misestimate: {w['name']} est "
                f"{w['est_rows']:.0f} rows, actual {w['actual_rows']} "
                f"(q={w['qerror']:.2f})")
        return lines
