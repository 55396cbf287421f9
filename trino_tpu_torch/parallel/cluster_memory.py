"""Coordinator-side cluster memory governance.

Reference analog: ``memory/ClusterMemoryManager.java`` (polls every
worker's MemoryInfo, tracks per-query cluster-wide reservations,
enforces query.max-total-memory) with its pluggable
``memory/LowMemoryKiller.java`` implementations —
``TotalReservationOnBlockedNodesLowMemoryKiller`` (default) and
``TotalReservationLowMemoryKiller`` — plus the fault-tolerant
scheduler's ``PartitionMemoryEstimator`` (observed-peak-driven retry
budgets).

Transport: worker pool snapshots PIGGYBACK on the heartbeat ping the
process runner already sends (no extra RPC); ``ClusterMemoryManager``
aggregates them, exposes the cluster view for QueryResult.stats /
EXPLAIN ANALYZE / the HTTP protocol payload, and registers kills that
the per-query contexts consume as EXCEEDED_CLUSTER_MEMORY — an
INSUFFICIENT_RESOURCES error, so the victim's retry re-admits with an
escalated budget instead of replaying the identical doomed plan.

A copy of the JAX engine's ``trino_tpu/parallel/cluster_memory.py``
(host code; the snapshots it reads are plain ints from each worker's
``NodeMemoryPool``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..types import TrinoError


@dataclass
class NodeMemorySnapshot:
    """One worker's pool state as of its last heartbeat."""

    worker_id: int
    max_bytes: int = 0
    reserved_bytes: int = 0
    peak_bytes: int = 0
    blocked_events: int = 0
    #: query id -> {"reserved", "peak", "spilled"}
    queries: Dict[str, Dict[str, int]] = field(default_factory=dict)
    time: float = 0.0

    @property
    def blocked(self) -> bool:
        """A node is blocked when admission failed on it since the
        previous heartbeat consumed the counter (the killer's trigger:
        reservations that cannot make progress)."""
        return self.blocked_events > 0


# -- low-memory killer policies ------------------------------------------


class LowMemoryKiller:
    """Victim selection over the cluster's node snapshots (reference:
    ``spi/memory/LowMemoryKiller``).  Deterministic: byte totals decide,
    lexicographically-smallest query id breaks ties, so a given cluster
    state always names the same victim."""

    name = "none"

    def choose_victim(self,
                      nodes: List[NodeMemorySnapshot]) -> Optional[str]:
        return None

    @staticmethod
    def _largest(totals: Dict[str, int]) -> Optional[str]:
        best = None
        for qid, total in totals.items():
            if total <= 0:
                continue
            if best is None or total > totals[best] \
                    or (total == totals[best] and qid < best):
                best = qid
        return best


class TotalReservationOnBlockedNodesKiller(LowMemoryKiller):
    """Kill the query holding the most memory ON THE BLOCKED NODES —
    freeing it unblocks exactly the starved pools (reference:
    ``TotalReservationOnBlockedNodesLowMemoryKiller.java``)."""

    name = "total-reservation-on-blocked-nodes"

    def choose_victim(self, nodes):
        totals: Dict[str, int] = {}
        for n in nodes:
            if not n.blocked:
                continue
            for qid, q in n.queries.items():
                totals[qid] = totals.get(qid, 0) + q.get("reserved", 0)
        return self._largest(totals)


class TotalReservationKiller(LowMemoryKiller):
    """Kill the cluster-wide largest query (reference:
    ``TotalReservationLowMemoryKiller.java``) — blunter, but frees the
    most bytes per kill."""

    name = "total-reservation"

    def choose_victim(self, nodes):
        totals: Dict[str, int] = {}
        for n in nodes:
            for qid, q in n.queries.items():
                totals[qid] = totals.get(qid, 0) + q.get("reserved", 0)
        return self._largest(totals)


KILLER_POLICIES = {
    "none": LowMemoryKiller,
    "total-reservation": TotalReservationKiller,
    "total-reservation-on-blocked-nodes":
        TotalReservationOnBlockedNodesKiller,
}


def killer_for(policy: str) -> LowMemoryKiller:
    cls = KILLER_POLICIES.get(policy)
    if cls is None:
        raise TrinoError(f"unknown memory killer policy {policy!r}",
                         "INVALID_SESSION_PROPERTY")
    return cls()


class QueryKilledError(TrinoError):
    """The low-memory killer (or the query_max_total_memory cap) chose
    this query as the victim — INSUFFICIENT_RESOURCES, so the retry
    loop re-admits it with an escalated budget."""

    def __init__(self, query_id: str, reason: str):
        super().__init__(
            f"Query {query_id} killed by the cluster memory manager: "
            f"{reason}", "EXCEEDED_CLUSTER_MEMORY")
        self.query_id = query_id
        self.reason = reason


# -- memory-aware retry sizing -------------------------------------------


class MemoryEstimator:
    """Observed peak memory per query attempt, the input to retry
    escalation (reference: ``PartitionMemoryEstimator`` — size the next
    attempt from what the failed one actually used, not from hope)."""

    GROWTH = 2.0

    def __init__(self):
        self._peaks: Dict[str, int] = {}
        self._lock = threading.Lock()

    def record_peak(self, query_id: str, peak: int):
        with self._lock:
            if len(self._peaks) >= 1024 and query_id not in self._peaks:
                # bounded for a long-lived coordinator: attempt ids are
                # unique per query, so old entries are dead weight
                self._peaks.clear()
            if peak > self._peaks.get(query_id, 0):
                self._peaks[query_id] = peak

    def peak_for(self, query_id: str) -> int:
        with self._lock:
            return self._peaks.get(query_id, 0)

    def next_budget(self, query_id: str, current: int,
                    floor: int) -> int:
        """The re-admission budget for the attempt after a memory
        failure: grow from the observed peak when the heartbeat caught
        one, else from the failed budget itself."""
        observed = self.peak_for(query_id)
        return int(max(floor, self.GROWTH * max(observed, current)))


# -- the manager ----------------------------------------------------------


class ClusterMemoryManager:
    """Aggregates heartbeat-piggybacked worker pool snapshots, enforces
    query_max_total_memory, and runs the low-memory killer when nodes
    report blocked pools (reference: ``ClusterMemoryManager.process``).

    Kill flags are registered here and consumed by the coordinator's
    per-query execution (the synchronous analog of the reference's
    fail-query callback)."""

    def __init__(self, policy: str = "total-reservation-on-blocked-nodes",
                 query_max_total_bytes: int = 0):
        self.killer = killer_for(policy)
        self.query_max_total_bytes = int(query_max_total_bytes)
        self.estimator = MemoryEstimator()
        self._snapshots: Dict[int, NodeMemorySnapshot] = {}
        self._kills: Dict[str, str] = {}     # qid -> reason (pending)
        #: every qid ever killed: one pressure episode = ONE kill, even
        #: though worker snapshots keep naming the dying victim for a
        #: few more heartbeats (bounded; see _kill)
        self._kill_history: set = set()
        self.kill_count = 0
        #: what chose the most recent victim: the killer policy name or
        #: "query-max-total-memory" (the cap path never consults the
        #: policy, and kill events must not claim it did)
        self.last_kill_source = self.killer.name
        self._lock = threading.Lock()

    # -- heartbeat intake -------------------------------------------------

    def update(self, worker_id: int, memory: Optional[dict]):
        """Fold one worker's ping payload in (None = worker has no pool
        configured or predates the protocol: drop its stale snapshot).
        ``blocked_events`` deltas ACCUMULATE across heartbeats — a probe
        that is not followed by a governance tick (on-demand heal,
        manual heartbeat) must not swallow the blocked signal — and are
        zeroed when a kill consumes them."""
        with self._lock:
            if not memory:
                self._snapshots.pop(worker_id, None)
                return
            prior = self._snapshots.get(worker_id)
            pending = prior.blocked_events if prior is not None else 0
            self._snapshots[worker_id] = NodeMemorySnapshot(
                worker_id,
                memory.get("max_bytes", 0),
                memory.get("reserved_bytes", 0),
                memory.get("peak_bytes", 0),
                memory.get("blocked_events", 0) + pending,
                dict(memory.get("queries", {})),
                time.monotonic())
        for qid, q in (memory.get("queries") or {}).items():
            self.estimator.record_peak(qid, q.get("peak", 0))

    def forget_worker(self, worker_id: int):
        with self._lock:
            self._snapshots.pop(worker_id, None)

    # -- governance -------------------------------------------------------

    def query_totals(self) -> Dict[str, int]:
        with self._lock:
            totals: Dict[str, int] = {}
            for n in self._snapshots.values():
                for qid, q in n.queries.items():
                    totals[qid] = totals.get(qid, 0) + q.get("reserved", 0)
            return totals

    def maybe_kill(self) -> Optional[str]:
        """One governance tick: enforce the per-query cluster cap, then
        — if any node is blocked — let the policy pick a victim.
        Returns the newly-killed query id, if any."""
        with self._lock:
            history = set(self._kill_history)  # _kill re-checks under
            # its own lock; this copy only avoids pointless candidates
        if self.query_max_total_bytes > 0:
            totals = self.query_totals()
            over = sorted(q for q, t in totals.items()
                          if t > self.query_max_total_bytes
                          and q not in history)
            if over:
                self.last_kill_source = "query-max-total-memory"
                return self._kill(
                    over[0],
                    f"total reservation {totals[over[0]]} bytes exceeds "
                    f"query_max_total_memory "
                    f"{self.query_max_total_bytes}")
        with self._lock:
            nodes = list(self._snapshots.values())
            blocked = [n for n in nodes if n.blocked]
        if not blocked:
            return None
        victim = self.killer.choose_victim(nodes)
        self.last_kill_source = self.killer.name
        if victim is None or victim in history:
            # this governance tick CONSUMED the blocked signal and
            # decided nothing is killable (the blocking query already
            # failed and released): without this, a latched signal
            # would kill an innocent later query
            with self._lock:
                for n in self._snapshots.values():
                    n.blocked_events = 0
            return None
        return self._kill(
            victim, f"nodes {sorted(n.worker_id for n in blocked)} "
            f"blocked on memory; policy {self.killer.name} chose the "
            "largest reservation")

    def _kill(self, qid: str, reason: str) -> Optional[str]:
        """Register one kill; None (and no event upstream) when this
        attempt id was already killed — snapshots keep naming a dying
        victim for a few heartbeats, and check_killed popping the flag
        must not let it re-register."""
        with self._lock:
            if qid in self._kill_history:
                return None
            if len(self._kill_history) >= 256:
                self._kill_history.clear()
            if len(self._kills) >= 64:   # victims that never checked in
                self._kills.pop(next(iter(self._kills)))
            self._kill_history.add(qid)
            self._kills[qid] = reason
            self.kill_count += 1
            # consume the blocked signal: one blocked episode yields
            # ONE kill, the next heartbeat re-arms it if pressure
            # persists
            for n in self._snapshots.values():
                n.blocked_events = 0
        return qid

    def kill(self, qid: str, reason: str) -> str:
        """Explicit kill registration (tests, admin surface)."""
        return self._kill(qid, reason)

    def check_killed(self, query_id: str):
        """Raise if this query (attempt) was chosen as a victim; the
        flag is consumed so the NEXT attempt runs clean."""
        with self._lock:
            reason = self._kills.pop(query_id, None)
        if reason is not None:
            raise QueryKilledError(query_id, reason)

    # -- observability ----------------------------------------------------

    def cluster_stats(self) -> dict:
        """The cluster-memory section for QueryResult.stats / EXPLAIN
        ANALYZE / the HTTP protocol payload."""
        with self._lock:
            nodes = list(self._snapshots.values())
            kills = self.kill_count
        return {
            "workers": len(nodes),
            "total_max_bytes": sum(n.max_bytes for n in nodes),
            "total_reserved_bytes": sum(n.reserved_bytes for n in nodes),
            "blocked_nodes": sum(1 for n in nodes if n.blocked),
            "queries": self.query_totals(),
            "kills": kills,
            "killer_policy": self.killer.name,
        }
