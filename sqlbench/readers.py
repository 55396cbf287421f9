"""What the metric readers (``metrics/<name>.py``) share: the run they
read, and the arithmetic that ties statements, executions, device ops
and kernel calls together.

A reader is ``read(run) -> float | None``; ``None`` (nothing to read)
leaves its metric out of the result line.
"""

from __future__ import annotations

import importlib.util
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import roofline, summary

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Run:
    """One run of a cell, as the readers see it."""
    #: seconds of the measured window, and its (start, end) epoch seconds
    seconds: float
    window: Tuple[float, float]
    #: the streams' records of every statement sent in the window
    records: List[dict]
    setup_s: float
    #: traced runs only: the server's executions (``instrument``), the
    #: device trace and the hand kernels' calls during it
    executions: Optional[list] = None
    trace: object = None
    kernel_calls: Optional[list] = None
    cache: Dict[str, object] = field(default_factory=dict)

    def answered(self) -> List[dict]:
        return [r for r in self.records if "error" not in r]

    def completed_in_window(self) -> List[dict]:
        return [r for r in self.answered() if r["t_done"] <= self.window[1]]


def load(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "sqlbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def matched(run: Run) -> List[Tuple[dict, object]]:
    """Each answered window statement with the server's execution of it:
    the execution of the same text that ran inside the statement's
    client interval, each execution matched once."""
    if "matched" in run.cache:
        return run.cache["matched"]
    free: Dict[str, list] = {}
    for e in sorted(run.executions or (), key=lambda e: e.t0):
        free.setdefault(e.sql, []).append(e)
    out = []
    for rec in sorted(run.answered(), key=lambda r: r["t_post"]):
        cands = free.get(rec["sql"], [])
        for i, e in enumerate(cands):
            if e.t0 >= rec["t_post"] - 1e-3 and e.t1 <= rec["t_done"] + 1e-3:
                out.append((rec, cands.pop(i)))
                break
    run.cache["matched"] = out
    return out


def mean(values) -> Optional[float]:
    values = list(values)
    return sum(values) / len(values) if values else None


def statements_in_trace(run: Run) -> float:
    """Statement-equivalents inside the traced window: each answered
    statement counts with the share of its client interval that lies in
    it."""
    t = run.trace
    total = 0.0
    for r in run.answered():
        span = r["t_done"] - r["t_post"]
        if span > 0:
            total += summary.overlap(r["t_post"], r["t_done"], t.t0,
                                     t.t1) / span
    return total


def per_statement_in_trace(run: Run, amount: float) -> Optional[float]:
    n = statements_in_trace(run)
    return amount / n if n > 0 else None


#: the hand kernels' device kernels, by the library entry that launches
#: them (``ops/kernels.py``): the first name is launched once per call
KERNELS = {"segment_reduce": ("tile_kernel", "carry_kernel"),
           "hash_insert": ("grid_kernel",)}
#: the entries whose call fills its scratch with a memset on its stream
#: just before its first kernel (``csrc/hash_insert.cu``: the table and
#: the barrier's words): the memset is part of the call's device time
MEMSET_FIRST = ("hash_insert",)


def memsets_before(trace, launches) -> float:
    """Seconds of the memsets that ran on a launch's stream as the op
    just before it: each call's own memset."""
    ids = {id(o) for o in launches}
    by_stream: Dict[int, list] = {}
    for o in trace.ops:
        by_stream.setdefault(o.stream, []).append(o)
    total = 0.0
    for ops in by_stream.values():
        ops.sort(key=lambda o: o.start)
        for prev, op in zip(ops, ops[1:]):
            if id(op) in ids and prev.cat == "gpu_memset":
                total += prev.seconds
    return total


def roofline_share(run: Run, kernel: str) -> Optional[float]:
    """Percent of the roofline: the mean bound of the kernel's calls in
    the traced window over the mean device time of a call there (the
    summed time of its kernels' launches, and of the memset before each
    first launch where the call issues one, over the launches of its
    first kernel, one per call)."""
    t = run.trace
    if t is None:
        return None
    calls = [c for c in run.kernel_calls or ()
             if c.kernel == kernel and t.t0 <= c.t <= t.t1]
    names = KERNELS[kernel]
    ops = t.kernels(names)
    launches = [o for o in ops if _first(o.name, names[0])]
    if not calls or not launches:
        return None
    if kernel == "segment_reduce":
        bounds = [roofline.bound_s(roofline.segment_reduce_bytes(
            c.n, c.count, c.itemsizes, c.num_segments, c.with_order))
            for c in calls]
    else:
        bounds = [roofline.bound_s(roofline.hash_insert_bytes(
            c.n, c.count, c.itemsizes)) for c in calls]
    device_s = sum(o.seconds for o in ops)
    if kernel in MEMSET_FIRST:
        device_s += memsets_before(t, launches)
    device_s /= len(launches)
    return 100.0 * (sum(bounds) / len(bounds)) / device_s


def _first(name: str, word: str) -> bool:
    from .devtrace import _has_word

    return _has_word(name, word)
