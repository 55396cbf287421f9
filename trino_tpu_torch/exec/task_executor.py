"""TaskExecutor: cooperative time-sharing of task work across a shared
worker pool.

Reference analog: ``execution/executor/TaskExecutor.java:82,491-519`` —
a fixed thread pool pulls prioritized entries from a
``MultilevelSplitQueue`` (5 levels bucketed by accumulated CPU time,
level 0 scheduled most often), runs each for a bounded quantum, and
requeues it at its new level. Long-running queries sink to deeper
levels, so short queries keep low latency under concurrency.

Adaptation: the schedulable unit is a GENERATOR — task code yields
at page boundaries (one driver ``process()`` call per step), and the
executor times each step to accumulate the entry's scheduled nanos.

Blocked-entry state (the streaming scheduler's requirement): a task
that cannot progress yields ``Blocked(tokens)`` — listen tokens from
its blocked operators (empty exchange channel, full output buffer) —
and the entry PARKS instead of re-entering the queue: the first token
to fire re-offers it (reference: ``operator/Driver.java:380-486``
blocked futures + TaskExecutor's waiting splits). A reaper re-offers
parked entries after a few seconds as a safety net, so a lost wakeup
degrades to slow polling, never deadlock.

The JAX engine's ``trino_tpu/exec/task_executor.py``, copied. Every task
of a query runs its device work on the device's current stream, so
pages handed between tasks need no stream bookkeeping.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Iterator, List, Optional

#: level i holds entries with accumulated scheduled time >= threshold
LEVEL_THRESHOLDS_S = (0.0, 1.0, 10.0, 60.0, 300.0)
#: scheduling weight of each level (reference: LEVEL_CONTRIBUTION_CAP /
#: levelMinPriority scheme, compressed to fixed 2:1 ratios)
LEVEL_WEIGHTS = (16, 8, 4, 2, 1)


class TaskFuture:
    def __init__(self):
        self._event = threading.Event()
        self._error: Optional[BaseException] = None

    def _finish(self, error: Optional[BaseException] = None):
        self._error = error
        self._event.set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("task did not finish in time")
        if self._error is not None:
            raise self._error


class Blocked:
    """Yield value signaling the task cannot progress; the executor
    parks the entry until one of the tokens fires."""

    __slots__ = ("tokens",)

    def __init__(self, tokens):
        self.tokens = list(tokens)


class _Entry:
    __slots__ = ("gen", "future", "scheduled_ns", "parked", "parked_at",
                 "park_lock")

    def __init__(self, gen: Iterator):
        self.gen = gen
        self.future = TaskFuture()
        self.scheduled_ns = 0
        self.parked = False
        self.parked_at = 0.0
        self.park_lock = threading.Lock()

    @property
    def level(self) -> int:
        s = self.scheduled_ns / 1e9
        lvl = 0
        for i, th in enumerate(LEVEL_THRESHOLDS_S):
            if s >= th:
                lvl = i
        return lvl


class MultilevelSplitQueue:
    """Five FIFO levels; ``take`` picks a level by weighted round-robin
    credits so lower levels (fresh work) run more often but deep levels
    never starve (reference: executor/MultilevelSplitQueue.java)."""

    def __init__(self):
        self._levels: List[deque] = [deque() for _ in LEVEL_THRESHOLDS_S]
        self._credits = list(LEVEL_WEIGHTS)
        self._cond = threading.Condition()
        self._closed = False

    def offer(self, entry: _Entry):
        with self._cond:
            if self._closed:
                return  # late wakeup after close: drop
            self._levels[entry.level].append(entry)
            self._cond.notify()

    def take(self) -> Optional[_Entry]:
        with self._cond:
            while True:
                if self._closed:
                    return None
                got = self._pick()
                if got is not None:
                    return got
                self._cond.wait()

    def _pick(self) -> Optional[_Entry]:
        nonempty = [i for i, lv in enumerate(self._levels) if lv]
        if not nonempty:
            return None
        # spend credits top-down; replenish when every nonempty level
        # is out of credit
        for i in nonempty:
            if self._credits[i] > 0:
                self._credits[i] -= 1
                return self._levels[i].popleft()
        for i in range(len(self._credits)):
            self._credits[i] = LEVEL_WEIGHTS[i]
        i = nonempty[0]
        self._credits[i] -= 1
        return self._levels[i].popleft()

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()


class TaskExecutor:
    """Shared pool running task generators with per-step timing."""

    #: reaper interval / max park time before a forced re-offer
    reap_every_s = 1.0
    max_park_s = 5.0

    def __init__(self, num_threads: Optional[int] = None,
                 name: str = "task-executor"):
        self.queue = MultilevelSplitQueue()
        self._closed = False
        self._parked: set = set()
        self._parked_lock = threading.Lock()
        n = num_threads or max(1, min(8, os.cpu_count() or 1))
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"{name}-{i}")
            for i in range(n)]
        for t in self._threads:
            t.start()
        self._reaper = threading.Thread(target=self._reap, daemon=True,
                                        name=f"{name}-reaper")
        self._reaper.start()

    def submit(self, gen: Iterator) -> TaskFuture:
        entry = _Entry(gen)
        self.queue.offer(entry)
        return entry.future

    def run_all(self, gens: List[Iterator],
                timeout: Optional[float] = None):
        """Submit a batch and wait for every task (the per-fragment
        barrier of the distributed runner)."""
        futures = [self.submit(g) for g in gens]
        errors = []
        for f in futures:
            try:
                f.result(timeout)
            except BaseException as e:  # noqa: BLE001 - propagate first
                errors.append(e)
        if errors:
            raise errors[0]

    def _unpark(self, entry: _Entry):
        """One-shot wakeup: the first firing token (or the reaper)
        re-offers the entry; later firings are no-ops."""
        with entry.park_lock:
            if not entry.parked:
                return
            entry.parked = False
        with self._parked_lock:
            self._parked.discard(entry)
        self.queue.offer(entry)

    def _park(self, entry: _Entry, blocked: Blocked):
        with entry.park_lock:
            entry.parked = True
            entry.parked_at = time.monotonic()
        with self._parked_lock:
            self._parked.add(entry)
        for token in blocked.tokens:
            token.on_ready(lambda e=entry: self._unpark(e))

    def _reap(self):
        while not self._closed:
            time.sleep(self.reap_every_s)
            now = time.monotonic()
            with self._parked_lock:
                stale = [e for e in self._parked
                         if now - e.parked_at > self.max_park_s]
            for e in stale:
                self._unpark(e)

    def _worker(self):
        while True:
            entry = self.queue.take()
            if entry is None:
                return
            t0 = time.perf_counter_ns()
            try:
                yielded = next(entry.gen)
            except StopIteration:
                entry.scheduled_ns += time.perf_counter_ns() - t0
                entry.future._finish()
                continue
            except BaseException as e:  # noqa: BLE001
                entry.future._finish(e)
                continue
            entry.scheduled_ns += time.perf_counter_ns() - t0
            if isinstance(yielded, Blocked) and yielded.tokens:
                self._park(entry, yielded)
            else:
                self.queue.offer(entry)

    def close(self):
        self._closed = True
        self.queue.close()
        with self._parked_lock:
            self._parked.clear()


_shared: Optional[TaskExecutor] = None
_shared_lock = threading.Lock()


def shared_executor() -> TaskExecutor:
    """The process-wide executor (reference: one TaskExecutor per worker
    JVM); all in-process runners time-share it."""
    global _shared
    with _shared_lock:
        if _shared is None:
            _shared = TaskExecutor()
        return _shared
