"""Live query progress: rows-based completion estimate + task counts.

Reference analog: ``QueryStats``'s progress fields
(``totalDrivers``/``completedDrivers``, ``physicalInputPositions``)
served on ``GET /v1/query/{id}`` while a query RUNS — the reference UI
derives its progress bar from exactly this.  Here the estimate is
rows-based: the planner sums the referenced connectors' statistics
(``TableStatistics.row_count``) into ``total_rows``, table scans report
host rows as they pull pages (pre-upload — no device sync), and the
fraction is ``min(rows_scanned / total_rows, 1)``.

Monotonicity contract: ``rows_scanned`` and ``tasks_done`` only ever
increase and ``fraction()`` clamps at 1.0, so a poll can never observe
progress moving backwards (estimates CAN overshoot — a LIMIT query
stops scanning early and jumps to done).

The registry is process-local and bounded; the protocol server
registers one entry per submitted query id and drops it when the query
reaches a terminal state.

The JAX engine's ``trino_tpu/telemetry/progress.py``, copied.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional


class QueryProgress:
    """One query's live counters. Plain int adds under the GIL — the
    scan hot path must not take a lock per page."""

    __slots__ = ("query_id", "total_rows", "rows_scanned", "tasks_total",
                 "tasks_done", "tasks_running", "started", "state",
                 "estimate_source")

    def __init__(self, query_id: str, total_rows: int = 0):
        self.query_id = query_id
        #: connector-statistics estimate of rows this query will scan
        #: (0 = unknown: fraction stays 0 until terminal).  When
        #: connector statistics are absent the runner falls back to
        #: history-based actuals (telemetry.stats_store) and flips
        #: ``estimate_source`` to "hbo" — a statistics-less connector
        #: no longer means a progress bar stuck at zero
        self.total_rows = int(total_rows)
        self.estimate_source = "connector"
        self.rows_scanned = 0
        self.tasks_total = 0
        self.tasks_done = 0
        self.tasks_running = 0
        self.started = time.time()
        self.state = "QUEUED"

    def add_rows(self, n: int):
        self.rows_scanned += n

    def task_started(self):
        self.tasks_running += 1

    def task_finished(self):
        self.tasks_running = max(0, self.tasks_running - 1)
        self.tasks_done += 1

    def fraction(self) -> float:
        if self.state == "FINISHED":
            return 1.0
        if self.total_rows <= 0:
            return 0.0
        return min(self.rows_scanned / self.total_rows, 1.0)

    def to_dict(self) -> dict:
        return {
            "state": self.state,
            "fraction": round(self.fraction(), 4),
            "rows_scanned": self.rows_scanned,
            "total_rows_estimate": self.total_rows,
            "estimate_source": self.estimate_source,
            "tasks": {"total": self.tasks_total,
                      "running": self.tasks_running,
                      "done": self.tasks_done},
            "elapsed_ms": round((time.time() - self.started) * 1e3, 1),
        }


_lock = threading.Lock()
_registry: Dict[str, QueryProgress] = {}
_MAX_TRACKED = 1024


def register(query_id: str, total_rows: int = 0) -> QueryProgress:
    p = QueryProgress(query_id, total_rows)
    with _lock:
        if len(_registry) >= _MAX_TRACKED:
            # drop the oldest — an abandoned tracker must not pin memory
            oldest = min(_registry.values(), key=lambda q: q.started)
            _registry.pop(oldest.query_id, None)
        _registry[query_id] = p
    return p


def get(query_id: str) -> Optional[QueryProgress]:
    with _lock:
        return _registry.get(query_id)


def unregister(query_id: str):
    with _lock:
        _registry.pop(query_id, None)
