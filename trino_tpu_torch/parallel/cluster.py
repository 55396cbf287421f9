"""Elastic cluster membership: node ledger + topology-aware placement.

Reference analog: ``metadata/DiscoveryNodeManager.java`` (the
coordinator's view of active/shutting-down nodes, refreshed from
heartbeats) and ``execution/scheduler/NodeScheduler.java`` /
``UniformNodeSelector`` (task placement preferring nodes that already
hold the split's data, falling back round-robin).

The ledger is the single source of truth for membership EVENTS: every
join and retire bumps a monotonically increasing cluster generation, so
a straggling RPC observed against a retired slot can be attributed to a
stale generation instead of a mystery connection error. Worker slots in
ProcessQueryRunner.workers remain the placement-time view; the ledger
records the churn history behind them (system.runtime.nodes reads it).

A copy of the JAX engine's ``trino_tpu/parallel/cluster.py`` (host code).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

NODE_ACTIVE = "active"
NODE_DRAINING = "draining"
NODE_RETIRED = "retired"


@dataclass
class NodeInfo:
    """One worker process's membership record across its lifetime."""

    node_id: str
    address: Tuple[str, int]
    pid: int
    generation: int           # cluster generation at which it joined
    state: str = NODE_ACTIVE
    reason: str = ""          # why it joined (initial/heal/scale-up)
    joined_at: float = field(default_factory=time.monotonic)
    retired_at: Optional[float] = None
    retired_reason: str = ""


class ClusterLedger:
    """Membership event log + generation counter, all under one private
    lock (independent of the runner's heal lock: ledger writes happen
    from heal, retire, and the monitor thread concurrently)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._generation = 0
        self._seq = 0
        self._nodes: Dict[str, NodeInfo] = {}
        self.joined_total = 0
        self.retired_total = 0

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    def record_join(self, address: Tuple[str, int], pid: int,
                    reason: str = "") -> NodeInfo:
        with self._lock:
            self._generation += 1
            self._seq += 1
            node = NodeInfo(node_id=f"node-{self._seq}",
                            address=tuple(address), pid=pid,
                            generation=self._generation, reason=reason)
            self._nodes[node.node_id] = node
            self.joined_total += 1
            return node

    def mark_draining(self, node_id: str):
        with self._lock:
            node = self._nodes.get(node_id)
            if node is not None and node.state == NODE_ACTIVE:
                node.state = NODE_DRAINING

    def record_retire(self, node_id: str, reason: str = "") -> Optional[
            NodeInfo]:
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None or node.state == NODE_RETIRED:
                return None
            self._generation += 1
            node.state = NODE_RETIRED
            node.retired_at = time.monotonic()
            node.retired_reason = reason
            self.retired_total += 1
            return node

    def snapshot(self) -> List[NodeInfo]:
        """Membership history, join order (deterministic)."""
        with self._lock:
            return sorted(self._nodes.values(),
                          key=lambda n: n.generation)

    def counts(self) -> Tuple[int, int]:
        with self._lock:
            return self.joined_total, self.retired_total


def place_task(t: int, retry: int, candidates: Sequence,
               upstream_addrs: Optional[Sequence[tuple]] = None):
    """Deterministic topology-aware placement of task index ``t``.

    Prefer candidates already holding this stage's exchange inputs
    (their address appears among the upstream producer locations — a
    co-located consumer pulls those pages loopback-cheap and keeps
    spool locality); break score ties round-robin by task index, so the
    no-signal case (leaf scans, symmetric input spread, spool-only
    inputs) degenerates to EXACTLY the historical ``t % len`` schedule.
    Retries rotate over the full candidate list regardless of topology:
    the preferred node just failed this task, affinity is stale.
    """
    cands = list(candidates)
    if not cands:
        raise ValueError("no candidates to place task on")
    if retry:
        return cands[(t + retry) % len(cands)]
    if upstream_addrs:
        held = {}
        for a in upstream_addrs:
            a = tuple(a)
            held[a] = held.get(a, 0) + 1
        scores = [held.get(tuple(c.addr), 0) for c in cands]
        best = max(scores)
        if best > 0:
            tied = [c for c, s in zip(cands, scores) if s == best]
            return tied[t % len(tied)]
    return cands[t % len(cands)]
