"""What a traced run (``--trace 1``) adds to the program, all from the
benchmark's side: a delegating wrapper around the runner that the server
calls, which times each statement and keeps its stats; a reader of the
operators' own wall counters in the local runner's result; and, while
the device trace records, a note of every hand kernel call's shapes and
live counts, without copying its inputs.

Nothing here runs in an untraced run.
"""

from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class Execution:
    user: Optional[str]
    sql: str
    t0: float
    t1: float
    stats: dict

    @property
    def wall_ms(self) -> float:
        return (self.t1 - self.t0) * 1e3


class TimedRunner:
    """Delegates to ``runner``; ``execute`` (and ``execute_batch``, where
    the runner has it) keep each statement's host wall, user and stats.
    The wrapped methods keep their signatures, so the server serves the
    wrapper as it serves the runner."""

    def __init__(self, runner):
        self._runner = runner
        self._lock = threading.Lock()
        self.executions: List[Execution] = []
        self.execute = functools.wraps(runner.execute)(
            lambda *a, **kw: self._execute(*a, **kw))
        if hasattr(runner, "execute_batch"):
            self.execute_batch = functools.wraps(runner.execute_batch)(
                lambda *a, **kw: self._execute_batch(*a, **kw))

    def __getattr__(self, name):
        return getattr(self._runner, name)

    def _keep(self, user, sql, t0, t1, res):
        stats = getattr(res, "stats", None) or {}
        with self._lock:
            self.executions.append(Execution(user, sql, t0, t1, stats))

    def _execute(self, sql, *args, **kwargs):
        t0 = time.time()
        res = self._runner.execute(sql, *args, **kwargs)
        self._keep(kwargs.get("user"), sql, t0, time.time(), res)
        return res

    def _execute_batch(self, sqls, *args, **kwargs):
        t0 = time.time()
        out = self._runner.execute_batch(sqls, *args, **kwargs)
        t1 = time.time()
        for sql, res in zip(sqls, out):
            if not isinstance(res, Exception):
                self._keep(kwargs.get("user"), sql, t0, t1, res)
        return out


def read_operator_walls():
    """Makes the local runner's ``stats["operators"]`` carry each
    operator's host wall (``wall_ms``, its driver's ``wall_ns``) and the
    epoch seconds of its first and last active call (``first_s``,
    ``last_s``): counters the drivers keep while history is on. Returns
    a function that undoes it."""
    from trino_tpu_torch import runner as runner_mod

    original = runner_mod._operator_metrics

    def operator_metrics(drivers):
        out = original(drivers)
        walls = []
        for d in drivers:
            anchor = getattr(d, "epoch_anchor", None)
            for st in d.stats:
                w = {"wall_ms": st.wall_ns / 1e6}
                if anchor is not None and st.first_ns:
                    w["first_s"] = anchor[0] + (st.first_ns - anchor[1]) / 1e9
                    w["last_s"] = anchor[0] + (st.last_ns - anchor[1]) / 1e9
                walls.append(w)
        for entry, w in zip(out, walls):
            entry.update(w)
        return out

    runner_mod._operator_metrics = operator_metrics
    return lambda: setattr(runner_mod, "_operator_metrics", original)


@dataclass
class KernelCall:
    kernel: str
    t: float
    n: int
    itemsizes: tuple
    num_segments: int
    with_order: bool
    #: 0-d device tensor: in-range lanes (segment reduce) or live rows
    #: (hash insert), counted on the side stream
    count: object = None


class KernelCalls:
    """While ``on``, notes each call of the two hand kernels' library
    entries (``ops.kernels._run`` and ``_run_hash``): its time, shapes
    and, on a side stream of its own that the device trace leaves out,
    the count of lanes the bound reads."""

    def __init__(self, device):
        import torch

        from trino_tpu_torch.ops import kernels

        self.on = False
        self.calls: List[KernelCall] = []
        self._lock = threading.Lock()
        self.side = torch.cuda.Stream(device)
        self._kernels = kernels
        self._original = (kernels._run, kernels._run_hash)
        seg, hsh = self._original

        def counted(t, count_fn):
            cur = torch.cuda.current_stream(t.device)
            with torch.cuda.stream(self.side):
                self.side.wait_stream(cur)
                count = count_fn()
                t.record_stream(self.side)
            return count

        def run(cols, gid, order, outs, num_segments, *rest):
            if self.on:
                count = counted(gid, lambda: ((gid >= 0) & (
                    gid < num_segments)).sum())
                self._note(KernelCall(
                    "segment_reduce", time.time(), gid.shape[0],
                    tuple(c.element_size() for c in cols), num_segments,
                    order is not None, count))
            return seg(cols, gid, order, outs, num_segments, *rest)

        def run_hash(key_ops, valid, rounds, *rest):
            if self.on:
                count = counted(valid, lambda: valid.sum())
                self._note(KernelCall(
                    "hash_insert", time.time(), valid.shape[0],
                    tuple(op.element_size() for op in key_ops), 0, False,
                    count))
            return hsh(key_ops, valid, rounds, *rest)

        kernels._run, kernels._run_hash = run, run_hash

    def _note(self, call: KernelCall):
        with self._lock:
            self.calls.append(call)

    def probe(self):
        """The counts' ops on a small tensor, on the side stream alone
        (``devtrace.Recorder.warm`` finds the stream's id by them)."""
        import torch

        with torch.cuda.stream(self.side):
            x = torch.arange(64, dtype=torch.int32, device=self.side.device)
            ((x >= 0) & (x < 8)).sum().item()
            (x > 3).sum().item()

    def resolve(self):
        """Reads every count (call after the device is synchronised)."""
        for c in self.calls:
            if c.count is not None and not isinstance(c.count, int):
                c.count = int(c.count)

    def close(self):
        self._kernels._run, self._kernels._run_hash = self._original
