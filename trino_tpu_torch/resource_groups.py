"""Resource groups: admission control with hierarchical concurrency and
queue limits.

Reference analog: ``execution/resourcegroups/InternalResourceGroup.java``
+ ``InternalResourceGroupManager`` with selector-based routing
(``plugin/trino-resource-group-managers``'s file config form). A query
is routed to the first group whose selector matches its user, then must
acquire a running slot: groups cap hard concurrency (and their parents'
caps apply transitively); when full, queries wait in a bounded queue —
a full queue rejects with QUERY_QUEUE_FULL, the reference behavior.

The JAX engine's ``trino_tpu/resource_groups.py``, copied.
"""

from __future__ import annotations

import re
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import List, Optional

from .types import TrinoError


class QueryQueueFullError(TrinoError):
    def __init__(self, group: str):
        super().__init__(
            f"Too many queued queries for resource group '{group}'",
            "QUERY_QUEUE_FULL")


@dataclass
class ResourceGroupSpec:
    name: str
    max_concurrency: int = 10
    max_queued: int = 100
    user_pattern: str = ".*"        # selector: route by user
    #: memory-aware admission (reference: InternalResourceGroup's
    #: softMemoryLimit): while the group's reserved memory sits above
    #: the SOFT limit no new query is admitted (running ones finish);
    #: a query whose own budget would push reserved past the HARD
    #: limit waits for memory, not just for a concurrency slot
    soft_memory_limit_bytes: Optional[int] = None
    hard_memory_limit_bytes: Optional[int] = None
    subgroups: List["ResourceGroupSpec"] = field(default_factory=list)


class ResourceGroup:
    def __init__(self, spec: ResourceGroupSpec,
                 parent: Optional["ResourceGroup"] = None):
        self.spec = spec
        self.parent = parent
        self.name = spec.name if parent is None \
            else f"{parent.name}.{spec.name}"
        self.running = 0
        self.queued = 0
        self.memory_reserved = 0    # sum of admitted queries' budgets
        # cumulative admission counters (metrics registry /
        # system.runtime.metrics — the qps harness's observables)
        self.total_admitted = 0
        self.total_queued_waits = 0
        self.queue_peak = 0
        # ONE condition per tree: a release in any subgroup may free
        # shared ancestor capacity a SIBLING's waiter is blocked on, and
        # ancestor counters must mutate under one lock
        self._cond = parent._cond if parent is not None \
            else threading.Condition()
        self.subgroups = [ResourceGroup(s, self) for s in spec.subgroups]

    def _chain(self) -> List["ResourceGroup"]:
        out = []
        g: Optional[ResourceGroup] = self
        while g is not None:
            out.append(g)
            g = g.parent
        return out

    def _can_run_locked(self, memory_bytes: int = 0) -> bool:
        for g in self._chain():
            if g.running >= g.spec.max_concurrency:
                return False
            soft = g.spec.soft_memory_limit_bytes
            if soft is not None and g.memory_reserved > soft:
                return False    # soft limit: no NEW admissions
            hard = g.spec.hard_memory_limit_bytes
            if hard is not None and \
                    g.memory_reserved + memory_bytes > hard:
                return False    # hard limit: this query must wait
        return True

    def acquire(self, timeout: Optional[float] = None,
                memory_bytes: int = 0):
        """Block until a running slot AND the memory headroom free up
        along the whole ancestor chain; reject immediately when this
        group's queue is full.  ``memory_bytes`` is the query's
        admission charge (its memory budget) — admission is memory-
        aware, not just slot-counting."""
        # an unsatisfiable request must reject loudly, never queue: no
        # amount of releases lets a budget above the hard limit fit
        for g in self._chain():
            hard = g.spec.hard_memory_limit_bytes
            if hard is not None and memory_bytes > hard:
                raise TrinoError(
                    f"query memory budget {memory_bytes} bytes exceeds "
                    f"resource group '{g.name}' hard memory limit "
                    f"{hard}; lower query_max_memory_bytes",
                    "QUERY_REJECTED")
        with self._cond:
            if not self._can_run_locked(memory_bytes):
                if self.queued >= self.spec.max_queued:
                    raise QueryQueueFullError(self.name)
                self.queued += 1
                self.total_queued_waits += 1
                self.queue_peak = max(self.queue_peak, self.queued)
                try:
                    ok = self._cond.wait_for(
                        lambda: self._can_run_locked(memory_bytes),
                        timeout=timeout)
                    if not ok:
                        raise QueryQueueFullError(self.name)
                finally:
                    self.queued -= 1
            for g in self._chain():
                g.running += 1
                g.memory_reserved += memory_bytes
            self.total_admitted += 1

    def release(self, memory_bytes: int = 0):
        with self._cond:
            for g in self._chain():
                g.running -= 1
                g.memory_reserved = max(
                    0, g.memory_reserved - memory_bytes)
            self._cond.notify_all()

    @contextmanager
    def run(self, timeout: Optional[float] = None,
            memory_bytes: int = 0):
        self.acquire(timeout, memory_bytes)
        try:
            yield self
        finally:
            self.release(memory_bytes)


class ResourceGroupManager:
    """Routes users to groups, depth-first first-match over selectors
    (reference: selector rules in resource-group config files)."""

    def __init__(self, specs: List[ResourceGroupSpec]):
        self.roots = [ResourceGroup(s) for s in specs]

    @classmethod
    def from_config(cls, doc: dict) -> "ResourceGroupManager":
        def spec(d: dict) -> ResourceGroupSpec:
            def limit(key):
                return int(d[key]) if key in d else None

            return ResourceGroupSpec(
                name=d["name"],
                max_concurrency=int(d.get("max_concurrency", 10)),
                max_queued=int(d.get("max_queued", 100)),
                user_pattern=d.get("user", ".*"),
                soft_memory_limit_bytes=limit("soft_memory_limit_bytes"),
                hard_memory_limit_bytes=limit("hard_memory_limit_bytes"),
                subgroups=[spec(s) for s in d.get("subgroups", [])])

        return cls([spec(d) for d in doc.get("groups",
                                             [{"name": "global"}])])

    def stats(self) -> List[tuple]:
        """Queue-depth snapshot over the whole tree — one
        ``(name, running, queued, memory_reserved)`` row per group,
        depth-first — the metrics-registry / system.runtime source
        (reference: resource-group JMX stats)."""
        out: List[tuple] = []

        def walk(groups: List[ResourceGroup]):
            for g in groups:
                out.append((g.name, g.running, g.queued,
                            g.memory_reserved))
                walk(g.subgroups)

        walk(self.roots)
        return out

    def counter_stats(self) -> List[tuple]:
        """Cumulative ``(name, admitted, queued_waits, queue_peak)`` per
        group, depth-first — the counter companion of ``stats()``
        (which snapshots live depths)."""
        out: List[tuple] = []

        def walk(groups: List[ResourceGroup]):
            for g in groups:
                out.append((g.name, g.total_admitted,
                            g.total_queued_waits, g.queue_peak))
                walk(g.subgroups)

        walk(self.roots)
        return out

    def select(self, user: str) -> ResourceGroup:
        def match(groups: List[ResourceGroup]) -> Optional[ResourceGroup]:
            for g in groups:
                if re.fullmatch(g.spec.user_pattern, user):
                    sub = match(g.subgroups)
                    return sub if sub is not None else g
            return None

        got = match(self.roots)
        if got is None:
            raise TrinoError(
                f"no resource group matches user '{user}'",
                "QUERY_REJECTED")
        return got
