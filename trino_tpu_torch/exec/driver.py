"""Driver: the inner execution loop moving pages through an operator chain.

Reference analog: ``operator/Driver.java:380-486`` (processInternal) — walk
adjacent operator pairs, move one page per iteration, finish-propagate.
Synchronous. With ``collect_stats`` each operator call is timed on the
host's wall clock (device work is asynchronous, so an operator's wall is
its enqueue time plus whatever it waited for on the device).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

from ..ops.operator import Operator


@dataclass
class OperatorStats:
    """Per-operator execution stats (reference:
    operator/OperatorStats.java — wall nanos, rows/pages out)."""

    name: str
    output_rows: int = 0
    output_pages: int = 0
    wall_ns: int = 0
    #: operator-reported metrics, pulled from ``op.metrics()`` once the
    #: driver finishes
    metrics: Optional[dict] = None

    def line(self) -> str:
        """The operator's EXPLAIN ANALYZE line: the JAX engine's format
        without its jit compile count and compiled-program cost (this
        engine runs eager torch ops), so names, rows and pages compare
        line by line."""
        ms = self.wall_ns / 1e6
        base = (f"{self.name}: {self.output_rows} rows, "
                f"{self.output_pages} pages, {ms:.1f}ms")
        m = self.metrics or {}
        if m.get("strategy"):
            # kernel-strategy operators report what ran (including a
            # fallback) plus the cost-model estimate that picked it
            base += f" [strategy {m['strategy']}"
            for k in ("estimate", "fallback", "key_range"):
                if m.get(k):
                    base += f" {k}={m[k]!r}"
            base += "]"
        return base


class Driver:
    """Executes one operator chain to completion."""

    def __init__(self, operators: Sequence[Operator],
                 collect_stats: bool = False):
        assert operators, "empty pipeline"
        self.operators: List[Operator] = list(operators)
        self.collect_stats = collect_stats
        self.stats: List[OperatorStats] = [
            OperatorStats(type(op).__name__) for op in operators]

    def _call(self, idx: int, fn):
        """Run one operator call, attributing its wall time to
        stats[idx] when collecting stats."""
        if not self.collect_stats:
            return fn()
        t0 = time.perf_counter_ns()
        out = fn()
        self.stats[idx].wall_ns += time.perf_counter_ns() - t0
        return out

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
                        st = self.stats[i]
                        st.output_pages += 1
                        st.output_rows += page.count()
                    self._call(i + 1, lambda: nxt.add_input(page))
                    moved = True
        # drain the tail operator (sinks produce no output)
        self._call(len(ops) - 1, ops[-1].get_output)
        if not moved:
            # nothing moved: push finish from the head if it is done
            if ops[0].is_finished() and not ops[0]._finishing:
                self._call(0, ops[0].finish)
        return ops[-1].is_finished()

    def collect_operator_metrics(self):
        """Pull per-operator metrics into the stats entries. Call after
        the driver finished."""
        for op, st in zip(self.operators, self.stats):
            m = getattr(op, "metrics", None)
            if callable(m):
                got = m()
                if got:
                    st.metrics = dict(got)

    def run_to_completion(self, max_quanta: int = 1_000_000):
        for _ in range(max_quanta):
            if self.process():
                return
        raise RuntimeError("driver did not finish (stuck pipeline?)")
