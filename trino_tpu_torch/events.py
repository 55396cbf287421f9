"""Query event listeners.

Reference analog: ``core/trino-spi/.../eventlistener/`` (EventListener,
QueryCreatedEvent, QueryCompletedEvent) + ``event/QueryMonitor.java``
building the payloads and ``EventListenerManager`` fanning them out.
Listener failures are swallowed (an observability plugin must not fail
queries) — the reference contract.

The JAX engine's ``trino_tpu/events.py``, copied.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional


@dataclass(frozen=True)
class QueryCreatedEvent:
    query_id: str
    user: str
    sql: str
    create_time: float


@dataclass(frozen=True)
class QueryCompletedEvent:
    query_id: str
    user: str
    sql: str
    create_time: float
    end_time: float
    state: str                      # FINISHED | FAILED
    output_rows: int = 0
    error_code: Optional[str] = None
    error_message: Optional[str] = None
    #: execution statistics payload (reference: the QueryStatistics
    #: half of QueryCompletedEvent): peak memory, recovery counters,
    #: wall breakdown — whatever the runner observed, as a plain dict
    stats: Optional[dict] = None

    @property
    def wall_ms(self) -> float:
        return (self.end_time - self.create_time) * 1e3


@dataclass(frozen=True)
class WorkerReplacedEvent:
    """A dead worker was detected and a replacement spawned, registered
    and re-synced (the self-healing seam of the process runtime)."""

    worker_index: int
    old_pid: Optional[int]
    new_pid: int
    reason: str                     # heartbeat | on-demand
    time: float


@dataclass(frozen=True)
class MemoryKillEvent:
    """The cluster memory manager killed a query to relieve blocked
    worker pools (or a query_max_total_memory breach)."""

    query_id: str
    policy: str                     # killer policy name
    reserved_bytes: int             # victim's cluster-wide reservation
    time: float


@dataclass(frozen=True)
class NodeJoinedEvent:
    """A worker process joined the cluster (initial spawn, heal
    replacement, or elastic scale-up) — the membership half of the
    self-healing/elasticity seam."""

    node_id: str
    worker_index: int
    pid: int
    generation: int                 # cluster generation at join
    reason: str                     # initial | heal | scale-up | ...
    time: float


@dataclass(frozen=True)
class NodeRetiredEvent:
    """A worker process left the cluster (drain-based retire, autoscale
    scale-down, or replacement of a dead worker)."""

    node_id: str
    pid: Optional[int]
    generation: int                 # cluster generation after retire
    reason: str                     # scale-down | replaced | ...
    drained: bool                   # True when it drained gracefully
    time: float


@dataclass(frozen=True)
class TaskRetryEvent:
    """A task or query attempt was retried (or speculatively
    re-dispatched) after a classified failure."""

    task_id: str
    error_type: str                 # fault.ERROR_TYPES
    attempt: int
    speculative: bool
    query_level: bool
    time: float


class EventListener:
    """Subclass hooks (reference: spi/eventlistener/EventListener.java)."""

    def query_created(self, event: QueryCreatedEvent):
        pass

    def query_completed(self, event: QueryCompletedEvent):
        pass

    def worker_replaced(self, event: WorkerReplacedEvent):
        pass

    def node_joined(self, event: NodeJoinedEvent):
        pass

    def node_retired(self, event: NodeRetiredEvent):
        pass

    def task_retry(self, event: TaskRetryEvent):
        pass

    def memory_kill(self, event: MemoryKillEvent):
        pass


class QueryHistoryListener(EventListener):
    """Ring-buffer listener retaining the last N completed queries plus
    the currently-running set (reference: QueryTracker's history kept
    for ``/v1/query`` + ``system.runtime.queries``).  A lock guards
    both sides: readers snapshot while protocol-server executor
    threads complete queries concurrently (iterating a live deque/dict
    would raise RuntimeError mid-scrape)."""

    def __init__(self, capacity: int = 256):
        import threading

        self._lock = threading.Lock()
        self.completed: Deque[QueryCompletedEvent] = deque(
            maxlen=capacity)
        self.running: Dict[str, QueryCreatedEvent] = {}

    def query_created(self, event: QueryCreatedEvent):
        with self._lock:
            self.running[event.query_id] = event

    def query_completed(self, event: QueryCompletedEvent):
        with self._lock:
            self.running.pop(event.query_id, None)
            self.completed.append(event)

    def snapshot_completed(self) -> List[QueryCompletedEvent]:
        with self._lock:
            return list(self.completed)

    def snapshot_running(self) -> List[QueryCreatedEvent]:
        with self._lock:
            return list(self.running.values())


@dataclass
class EventListenerManager:
    listeners: List[EventListener] = field(default_factory=list)
    _counter: int = 0
    history_capacity: int = 256

    def __post_init__(self):
        # the built-in ring buffer backs system.runtime.queries and
        # /v1/query/{id}; user listeners ride alongside it
        self.history_listener = QueryHistoryListener(
            self.history_capacity)
        self.listeners = list(self.listeners) + [self.history_listener]

    def add(self, listener: EventListener):
        self.listeners.append(listener)

    def history(self, n: int = 100) -> List[QueryCompletedEvent]:
        """The most recent completed-query events, oldest first."""
        return self.history_listener.snapshot_completed()[-n:]

    def running(self) -> List[QueryCreatedEvent]:
        """Currently-executing queries (created, not yet completed)."""
        return sorted(self.history_listener.snapshot_running(),
                      key=lambda e: e.create_time)

    def next_query_id(self) -> str:
        self._counter += 1
        return f"query_{self._counter}"

    def fire_created(self, event: QueryCreatedEvent):
        for listener in self.listeners:
            try:
                listener.query_created(event)
            except Exception:
                pass

    def fire_completed(self, event: QueryCompletedEvent):
        for listener in self.listeners:
            try:
                listener.query_completed(event)
            except Exception:
                pass

    def fire_worker_replaced(self, event: WorkerReplacedEvent):
        for listener in self.listeners:
            try:
                listener.worker_replaced(event)
            except Exception:
                pass

    def fire_node_joined(self, event: NodeJoinedEvent):
        for listener in self.listeners:
            try:
                listener.node_joined(event)
            except Exception:
                pass

    def fire_node_retired(self, event: NodeRetiredEvent):
        for listener in self.listeners:
            try:
                listener.node_retired(event)
            except Exception:
                pass

    def fire_task_retry(self, event: TaskRetryEvent):
        for listener in self.listeners:
            try:
                listener.task_retry(event)
            except Exception:
                pass

    def fire_memory_kill(self, event: MemoryKillEvent):
        for listener in self.listeners:
            try:
                listener.memory_kill(event)
            except Exception:
                pass


class QueryMonitor:
    """Builds + fires the event pair around one query execution
    (reference: event/QueryMonitor.java)."""

    def __init__(self, manager: EventListenerManager, user: str,
                 sql: str):
        self.manager = manager
        self.user = user
        self.sql = sql
        self.query_id = manager.next_query_id()
        self.create_time = time.time()

    def created(self):
        self.manager.fire_created(QueryCreatedEvent(
            self.query_id, self.user, self.sql, self.create_time))

    def completed(self, output_rows: int, stats: Optional[dict] = None):
        self.manager.fire_completed(QueryCompletedEvent(
            self.query_id, self.user, self.sql, self.create_time,
            time.time(), "FINISHED", output_rows, stats=stats))

    def failed(self, error: Exception):
        self.manager.fire_completed(QueryCompletedEvent(
            self.query_id, self.user, self.sql, self.create_time,
            time.time(), "FAILED",
            error_code=getattr(error, "code", type(error).__name__),
            error_message=str(error)))
