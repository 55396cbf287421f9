"""Driver: the inner execution loop moving pages through an operator chain.

Reference analog: ``operator/Driver.java:380-486`` (processInternal) — walk
adjacent operator pairs, move one page per iteration, finish-propagate.
Synchronous. With ``collect_stats`` each operator call is timed on the
host's wall clock (device work is asynchronous, so an operator's wall is
its enqueue time plus whatever it waited for on the device), its
programs' first calls are counted (``jit_stats``), and, while the
program profiler is on, its programs' operations, bytes, compile wall
and CUDA-event spans ("device ms", see ``telemetry/profiler.py``) are
attributed to it — the spans read at the end of each call, so under
profiling an operator's wall includes its device work. Each operator's
first and last active call are stamped (``first_ns``/``last_ns`` on
``perf_counter_ns``, with the process's ``epoch_anchor``), which places
it on a trace timeline (``telemetry.tracing.add_driver_spans``). A
call's thread CPU is summed beside its wall (``cpu_ns``: the wall less
it is time the thread waited, for the interpreter lock, a lock or the
device), and the host's reads of device tensors during the call are
charged to the operator (``telemetry.device_reads``); while a
torch.profiler session records, each call's interval is kept too.
A task of a distributed query runs its drivers a quantum at a time on
the task executor, parking on ``blocked_tokens`` after a quantum that
moved nothing.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Set

import torch

from .. import jit_stats
from ..ops.operator import Operator
from ..telemetry import device_reads, profiler
from ..telemetry.tracing import EPOCH_ANCHOR


@dataclass
class OperatorStats:
    """Per-operator execution stats (reference:
    operator/OperatorStats.java — wall nanos, rows/pages out).
    ``compile_count`` is the number of program first calls at a new
    signature attributed to this operator's calls (``jit_stats``): after
    warmup it must stay flat for same-shape pages."""

    name: str
    output_rows: int = 0
    output_pages: int = 0
    wall_ns: int = 0
    compile_count: int = 0
    #: program profiler attribution (thread deltas): operations and
    #: bytes of this operator's programs, the compile wall it paid, its
    #: device ms (the programs' CUDA-event spans, which hold the device's
    #: idle time when the host is behind) and the names of the programs
    #: it ran — all zero/empty
    #: unless the profiler was on (EXPLAIN ANALYZE VERBOSE,
    #: ``query_profiling_enabled``)
    flops: float = 0.0
    device_bytes: float = 0.0
    compile_ms: float = 0.0
    device_ms: float = 0.0
    programs: Set[str] = field(default_factory=set)
    #: perf_counter_ns of this operator's first/last active call — with
    #: the driver's ``epoch_anchor`` these place the operator on a trace
    #: timeline (telemetry.tracing.add_driver_spans)
    first_ns: int = 0
    last_ns: int = 0
    #: thread CPU of this operator's calls (``time.thread_time_ns``)
    cpu_ns: int = 0
    #: the host's reads of device tensors made in this operator's calls
    #: (telemetry.device_reads): count, bytes, wall waited
    d2h_reads: int = 0
    d2h_bytes: int = 0
    d2h_wait_ns: int = 0
    #: while a torch.profiler session records: each read's
    #: (start, end, site, bytes) and each call's (start, end), on
    #: perf_counter_ns; None outside one
    read_spans: Optional[list] = None
    call_spans: Optional[list] = None
    #: operator-reported metrics, pulled from ``op.metrics()`` once the
    #: driver finishes
    metrics: Optional[dict] = None
    #: canonical plan-node fingerprint this operator realizes (set by
    #: the local planner when history-based statistics are recording;
    #: telemetry.stats_store keys actuals by it) — None outside HBO
    node_fp: Optional[str] = None

    def line(self) -> str:
        """The operator's EXPLAIN ANALYZE line, in the JAX engine's
        format; under profiling the cost bracket adds the device ms and
        the programs the operator ran."""
        ms = self.wall_ns / 1e6
        base = (f"{self.name}: {self.output_rows} rows, "
                f"{self.output_pages} pages, {ms:.1f}ms, "
                f"{self.compile_count} compiles")
        if self.d2h_reads:
            base += (f" [reads {self.d2h_reads}, "
                     f"{self.d2h_bytes / 1e6:.3f} MB, "
                     f"wait {self.d2h_wait_ns / 1e6:.1f} ms]")
        if self.flops or self.device_bytes or self.compile_ms \
                or self.programs:
            base += (f" [cost {self.flops:.3g} flops, "
                     f"{self.device_bytes:.3g} bytes, "
                     f"compile {self.compile_ms:.1f}ms, "
                     f"device {self.device_ms:.3f}ms, programs "
                     + " ".join(sorted(self.programs)) + "]")
        m = self.metrics or {}
        if m.get("strategy"):
            # kernel-strategy operators report what ran (including a
            # fallback) plus the cost-model estimate that picked it
            base += f" [strategy {m['strategy']}"
            for k in ("estimate", "fallback", "key_range"):
                if m.get(k):
                    base += f" {k}={m[k]!r}"
            base += "]"
        if m.get("adaptive"):
            # the adaptive partial-agg decision (pass-through or
            # per-key-range split) — no 'strategy' key on agg ops
            base += f" [adaptive {m['adaptive']}]"
        extras = " ".join(
            f"{k}={m[k]}" for k in ("skew_ratio", "lane_skew_ratio",
                                    "per_dest", "a2a_retries",
                                    "sizing", "first_page_ms")
            if m.get(k) is not None)
        # split/rebalance/replay counters only when the mechanism
        # engaged (a zero on every boundary would be noise)
        extras += "".join(
            f" {k}={m[k]}" for k in ("splits", "rebalances",
                                     "reconnects", "replayed_frames")
            if m.get(k))
        if extras:
            base += f" [exchange {extras}]"
        return base


class Driver:
    """Executes one operator chain to completion."""

    def __init__(self, operators: Sequence[Operator],
                 collect_stats: bool = False):
        assert operators, "empty pipeline"
        self.operators: List[Operator] = list(operators)
        self.collect_stats = collect_stats
        self.stats: List[OperatorStats] = [
            OperatorStats(type(op).__name__,
                          node_fp=getattr(op, "_hbo_fp", None))
            for op in operators]
        #: per operator, the output pages' live-row counts still on the
        #: device: summed into ``output_rows`` once the driver finished
        #: (one read instead of a synchronise per page)
        self._row_sums: List[List] = [[] for _ in operators]
        #: whether the most recent process() quantum moved any page —
        #: tasks only park on blocked tokens after a no-progress quantum
        self.last_moved = False
        #: (epoch seconds, perf_counter_ns): the process's one anchor
        #: (telemetry.tracing.EPOCH_ANCHOR), which converts the stats'
        #: first_ns/last_ns to wall-clock span timestamps
        self.epoch_anchor = EPOCH_ANCHOR if collect_stats else None

    def _call(self, idx: int, fn):
        """Run one operator call, attributing its wall time, thread CPU,
        device reads, first calls and (under profiling) program costs to
        stats[idx] when collecting stats."""
        if not self.collect_stats:
            return fn()
        st = self.stats[idx]
        local = device_reads.LOCAL
        outer = local.target
        local.target = st
        t0 = time.perf_counter_ns()
        u0 = time.thread_time_ns()
        c0 = jit_stats.thread_total()
        prof = profiler.enabled()
        if prof:
            p0 = profiler.thread_totals()
            d0 = profiler.thread_device_ms()
            profiler.thread_programs()  # drop names run outside operators
        try:
            out = fn()
        finally:
            local.target = outer
        if prof:
            d1 = profiler.thread_device_ms()  # reads this call's events
            p1 = profiler.thread_totals()
            st.flops += p1[0] - p0[0]
            st.device_bytes += p1[1] - p0[1]
            st.compile_ms += p1[2] - p0[2]
            st.device_ms += d1 - d0
            st.programs.update(profiler.thread_programs())
        u1 = time.thread_time_ns()
        t1 = time.perf_counter_ns()
        st.wall_ns += t1 - t0
        st.cpu_ns += u1 - u0
        st.compile_count += jit_stats.thread_total() - c0
        if st.first_ns == 0:
            st.first_ns = t0
        st.last_ns = t1
        if device_reads.recording():
            if st.call_spans is None:
                st.call_spans = []
            st.call_spans.append((t0, t1))
        return out

    def _count_page(self, idx: int, page):
        st = self.stats[idx]
        st.output_pages += 1
        valid = getattr(page, "valid", None)
        if isinstance(valid, torch.Tensor):
            self._row_sums[idx].append(valid.sum())
        else:
            st.output_rows += page.count()

    def process(self) -> bool:
        """One scheduling quantum: move pages between adjacent operators.
        Returns True if the driver is fully finished."""
        ops = self.operators
        moved = False
        for i in range(len(ops) - 1):
            cur, nxt = ops[i], ops[i + 1]
            # finish propagation
            if cur.is_finished() and not nxt._finishing:
                self._call(i + 1, nxt.finish)
            if nxt.needs_input():
                page = self._call(i, cur.get_output)
                if page is not None:
                    if self.collect_stats:
                        self._count_page(i, page)
                    self._call(i + 1, lambda: nxt.add_input(page))
                    moved = True
        # drain the tail operator (sinks produce no output)
        self._call(len(ops) - 1, ops[-1].get_output)
        if not moved:
            # nothing moved: push finish from the head if it is done
            if ops[0].is_finished() and not ops[0]._finishing:
                self._call(0, ops[0].finish)
        self.last_moved = moved
        return ops[-1].is_finished()

    def collect_operator_metrics(self):
        """Pull per-operator metrics and the pending row counts into the
        stats entries. Call after the driver finished."""
        for st, sums in zip(self.stats, self._row_sums):
            if sums:
                st.output_rows += int(device_reads.host_scalar(
                    torch.stack(sums).sum(), "driver.output_rows"))
                sums.clear()
        for op, st in zip(self.operators, self.stats):
            m = getattr(op, "metrics", None)
            if callable(m):
                got = m()
                if got:
                    st.metrics = dict(got)
            # per-operator memory high-water mark (the context's peak
            # survives close()) — history-based statistics record it
            ctx = getattr(op, "_ctx", None)
            peak = getattr(ctx, "peak", 0) if ctx is not None else 0
            if peak:
                st.metrics = dict(st.metrics or {}, peak_bytes=peak)

    def blocked_tokens(self) -> List:
        """Listen tokens of currently-blocked operators. Meaningful
        after a ``process()`` quantum that made no progress: the task
        parks on these instead of spinning (reference:
        Driver.java:380-486 blocked-future handling)."""
        toks = []
        for op in self.operators:
            t = op.blocked_token()
            if t is not None:
                toks.append(t)
        return toks

    def run_to_completion(self, max_quanta: int = 1_000_000):
        for _ in range(max_quanta):
            if self.process():
                return
        raise RuntimeError("driver did not finish (stuck pipeline?)")
