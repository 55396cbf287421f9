"""Deterministic hysteresis-guarded autoscaling policy.

Reference analog: Trino's cluster managers scale on queue pressure —
e.g. the Galaxy/EMR-style policies reading ``queuedQueries`` and
cluster memory utilization — while the engine itself only exposes the
signals. Here the policy is IN the engine but deliberately mechanical:
no wall-clock sampling, no randomness — every decision is a pure
function of the tick inputs and the controller's counters, so chaos
tests and the bench role replay identically.

Signals per tick (the monitor thread calls ``tick`` once per heartbeat
interval):
- resource-group queue depth (queries admitted but waiting),
- running queries,
- blocked nodes from the heartbeat-piggybacked memory snapshots.

Hysteresis: scale-up needs ``UP_TICKS`` consecutive pressure ticks,
scale-down needs ``down_idle_ticks`` consecutive fully-idle ticks, and
every decision starts a cooldown window during which no further
decision fires — so a bursty queue cannot flap the membership.
Scale-up doubles (bounded by ``max_workers``): reacting to a burst with
+1 worker chases the queue; doubling converges in O(log n) decisions.
Scale-down retires ONE worker at a time: drains are cheap, and a slow
ramp-down keeps capacity for the next burst.

A copy of the JAX engine's ``trino_tpu/parallel/autoscaler.py`` (host
code).
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional


class Autoscaler:
    """State machine over tick inputs; all mutable state under one
    private lock (ticks come from the monitor thread, reads of
    ``decisions``/counters from metrics scrapes and tests)."""

    #: consecutive pressure ticks required before a scale-up fires
    UP_TICKS = 2
    #: bounded decision history for the bench result line / debugging
    MAX_DECISIONS = 64

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._pressure_ticks = 0
        self._idle_ticks = 0
        self._last_action_at: Optional[float] = None
        self.decisions: List[dict] = []
        self.scale_ups = 0
        self.scale_downs = 0
        self.target: Optional[int] = None

    def _decide(self, direction: str, size: int, target: int,
                reason: str) -> dict:
        decision = {"direction": direction, "from": size, "to": target,
                    "reason": reason}
        self._last_action_at = self._clock()
        self._pressure_ticks = 0
        self._idle_ticks = 0
        self.decisions.append(decision)
        del self.decisions[:-self.MAX_DECISIONS]
        if direction == "up":
            self.scale_ups += 1
        else:
            self.scale_downs += 1
        self.target = target
        return decision

    def _cooled(self, cooldown_s: float) -> bool:
        return self._last_action_at is None or \
            self._clock() - self._last_action_at >= cooldown_s

    def tick(self, *, size: int, queued: int, running: int,
             min_workers: int, max_workers: int, cooldown_s: float,
             up_queue_depth: int, down_idle_ticks: int,
             blocked_nodes: int = 0) -> Optional[dict]:
        """One policy evaluation. Returns a decision dict
        ``{direction, from, to, reason}`` for the membership layer to
        apply, or None. Deterministic given the input sequence."""
        with self._lock:
            if size < min_workers:
                # below the floor is not a policy question: restore
                # immediately, cooldown does not apply
                return self._decide("up", size, min_workers,
                                    "below min_workers")
            pressure = (up_queue_depth > 0 and
                        queued >= up_queue_depth) or blocked_nodes > 0
            if pressure:
                self._pressure_ticks += 1
                self._idle_ticks = 0
                if self._pressure_ticks >= self.UP_TICKS \
                        and size < max_workers \
                        and self._cooled(cooldown_s):
                    target = min(max(size * 2, size + 1), max_workers)
                    why = f"queued={queued}" if queued else \
                        f"blocked_nodes={blocked_nodes}"
                    return self._decide("up", size, target, why)
                return None
            if queued == 0 and running == 0:
                self._idle_ticks += 1
                self._pressure_ticks = 0
                if self._idle_ticks >= max(1, down_idle_ticks) \
                        and size > min_workers \
                        and self._cooled(cooldown_s):
                    return self._decide(
                        "down", size, size - 1,
                        f"idle {self._idle_ticks} ticks")
                return None
            # busy but unpressured: a steady state — reset both streaks
            self._pressure_ticks = 0
            self._idle_ticks = 0
            return None

    def snapshot(self) -> dict:
        with self._lock:
            return {"scale_ups": self.scale_ups,
                    "scale_downs": self.scale_downs,
                    "target": self.target,
                    "decisions": list(self.decisions)}
