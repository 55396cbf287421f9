"""Scaled-writer partition rebalancing: logical partitions -> writer
lanes, re-assigned from observed row counts.

Reference analog: ``operator/output/ScaleWriterPartitioningExchanger``
+ ``operator/exchange/UniformPartitionRebalancer.java`` — the writer
path's answer to a hot partition: rows are hashed into MORE logical
partitions than there are physical writer tasks, per-partition row
counts are observed across pages/collectives, and a hot logical
partition is SCALED onto additional writer lanes (its rows round-robin
across the assigned set) while cold partitions can be MOVED off an
overloaded lane.

Design points kept from the reference:

- EWMA-smoothed loads: one bursty page must not thrash assignments;
- hysteresis: assignments only change when a lane's smoothed load
  exceeds ``max_skew`` x the mean AND at least ``min_collectives``
  observations passed since the last change — so a converged layout is
  STABLE (no flapping) under a stationary distribution;
- determinism: all choices are argmin/argmax with index tie-breaks;
  exact load ties fall to a seeded RNG, so a fixed seed reproduces the
  full assignment history;
- scaling is monotone WITHIN a pass (a scaled partition never drops
  lanes while any lane is hot) and moves must strictly improve the
  imbalance, so every rebalance pass terminates and converges;
- the REVERSE transition: once the cluster is calm, a scaled partition
  whose smoothed load cooled releases lanes again (one per pass, same
  hysteresis window) — but only when its per-lane share after the
  release stays under ``unscale_factor`` x mean, strictly inside the
  scale trigger, so scale/un-scale cannot flap on a stationary
  distribution.

Writer-side correctness does not need key co-location (each writer
lane just appends rows; the statement row count is summed downstream),
which is exactly why the REBALANCER may break partition->lane stability
while the generic hash exchange may not (the device exchange's
hot-partition SPLITTING handles that side — see device_exchange.py).

Instances are process-wide, keyed by exchange shape through
``ExchangeSizingHistory.rebalancer`` so repeat queries of the same
shape reuse the learned assignment instead of re-converging (and the
downstream page shapes stay stable — no recompiles).

The JAX engine's ``trino_tpu/parallel/rebalancer.py``, copied.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, Iterable, List, Sequence

import numpy as np

#: logical partitions per writer lane — more partitions than lanes is
#: what gives the rebalancer room to scale/move (reference:
#: SCALED_WRITER_HASH_DISTRIBUTION's partition count exceeding the
#: task count)
LOGICAL_PER_WRITER = 8


def writer_rebalancer(type_names: Iterable[str], n_writers: int,
                      min_collectives: int):
    """The rebalancer for a scaled-writer boundary of this shape: ONE
    instance per (types, lane count, hysteresis) in the process-wide
    sizing history, shared by every producer task — repeat queries of
    the same shape reuse the learned partition->lane assignment
    instead of re-converging. min_collectives is part of the key, not
    just the factory: a session changing the property must get the
    hysteresis it asked for, not a cached instance built under the old
    value. The single construction path for coordinator threads and
    worker processes (each process holds its own history, so each
    adapts to the load IT observes, like the reference's per-node
    exchanger)."""
    from .device_exchange import SIZING_HISTORY

    n_logical = n_writers * LOGICAL_PER_WRITER
    min_collectives = max(1, int(min_collectives))
    key = ("scaled-writer", tuple(type_names), n_logical, n_writers,
           min_collectives)
    return SIZING_HISTORY.rebalancer(
        key, lambda: UniformPartitionRebalancer(
            n_logical, n_writers, min_collectives=min_collectives))


class UniformPartitionRebalancer:
    """Logical-partition -> writer-lane assignment, adapted from
    observed per-partition row counts."""

    #: process-wide count of assignment changes (bench/test
    #: observability, mirrors DeviceExchange.total_collectives)
    total_rebalances = 0
    _total_lock = threading.Lock()

    #: a scaled partition releases a lane only when its per-lane share
    #: AFTER the release stays below this fraction of the mean lane
    #: load.  The scale trigger needs share > mean, and the mean
    #: (total/w) is invariant under re-assignment — so any factor < 1
    #: makes the transitions flap-free; 0.9 leaves margin for EWMA
    #: drift while still fully un-scaling a genuinely cooled partition
    unscale_factor = 0.9

    def __init__(self, n_partitions: int, n_writers: int,
                 min_collectives: int = 2, max_skew: float = 1.3,
                 alpha: float = 0.5, seed: int = 0):
        assert n_partitions >= 1 and n_writers >= 1
        self.n = n_partitions
        self.w = n_writers
        self.min_collectives = max(1, int(min_collectives))
        self.max_skew = max_skew
        self.alpha = alpha
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._ewma = np.zeros(n_partitions)
        self._obs = 0
        self._last_change = -self.min_collectives  # first obs may act
        #: logical partition p -> sorted writer lanes; len > 1 means the
        #: partition is SCALED (rows round-robin across the set)
        self._assign: List[List[int]] = [[p % n_writers]
                                         for p in range(n_partitions)]
        self.rebalances = 0

    # -- observation ----------------------------------------------------

    def observe(self, partition_rows: Sequence[int]) -> None:
        """Record one collective/page batch's per-partition row counts;
        may re-assign once the hysteresis window allows it."""
        rows = np.asarray(partition_rows, dtype=float)
        assert rows.shape == (self.n,), (rows.shape, self.n)
        with self._lock:
            if self._obs == 0:
                self._ewma = rows.copy()
            else:
                self._ewma = (self.alpha * rows
                              + (1 - self.alpha) * self._ewma)
            self._obs += 1
            if self._obs - self._last_change >= self.min_collectives:
                if self._rebalance_locked():
                    self.rebalances += 1
                    self._last_change = self._obs
                    with UniformPartitionRebalancer._total_lock:
                        UniformPartitionRebalancer.total_rebalances += 1

    # -- the rebalance pass ---------------------------------------------

    def _lane_loads_locked(self) -> np.ndarray:
        loads = np.zeros(self.w)
        for p, lanes in enumerate(self._assign):
            share = self._ewma[p] / len(lanes)
            for lane in lanes:
                loads[lane] += share
        return loads

    def _least_loaded_locked(self, loads: np.ndarray,
                             exclude: List[int]) -> int:
        cand = [lane for lane in range(self.w) if lane not in exclude]
        lo = min(loads[lane] for lane in cand)
        ties = [lane for lane in cand if loads[lane] == lo]
        return ties[0] if len(ties) == 1 else self._rng.choice(ties)

    def _rebalance_locked(self) -> bool:
        """Scale/move partitions until no lane exceeds max_skew x mean;
        returns True when any assignment changed."""
        changed = False
        for _ in range(4 * self.w):  # bounded: scaling is monotone
            loads = self._lane_loads_locked()
            mean = float(loads.mean())
            if mean <= 0:
                break
            hi = int(np.argmax(loads))  # ties -> lowest index
            if loads[hi] <= self.max_skew * mean:
                # calm cluster: the reverse transition — give ONE
                # cooled scaled partition a lane back (same hysteresis
                # window as scaling; see unscale_factor)
                if self._unscale_locked(loads, mean):
                    changed = True
                break
            # partitions feeding the hot lane, hottest per-lane share
            # first (deterministic: share desc, partition id asc)
            cand = sorted(
                ((self._ewma[p] / len(self._assign[p]), p)
                 for p in range(self.n) if hi in self._assign[p]),
                key=lambda t: (-t[0], t[1]))
            acted = False
            for share, p in cand:
                lanes = self._assign[p]
                if len(lanes) >= self.w:
                    continue  # already spread everywhere
                lo = self._least_loaded_locked(loads, exclude=lanes)
                if share > mean:
                    # the partition alone overloads a lane: SCALE it
                    # onto one more writer (the
                    # ScaleWriterPartitioningExchanger move)
                    self._assign[p] = sorted(lanes + [lo])
                    acted = True
                elif len(lanes) == 1 and loads[hi] - loads[lo] > share:
                    # cold-enough partition: MOVE it whole; the strict
                    # improvement condition guarantees convergence
                    self._assign[p] = [lo]
                    acted = True
                if acted:
                    break
            if not acted:
                break
            changed = True
        return changed

    def _unscale_locked(self, loads: np.ndarray, mean: float) -> bool:
        """Un-scale the coldest eligible scaled partition by dropping
        its most-loaded lane (deterministic: share-after asc, partition
        id asc; lane load desc, lane id asc).  Eligible = the per-lane
        share AFTER the drop stays under unscale_factor x mean, so the
        released lanes cannot re-trip the scale condition."""
        cand = sorted(
            ((self._ewma[p] / (len(self._assign[p]) - 1), p)
             for p in range(self.n) if len(self._assign[p]) > 1),
            key=lambda t: (t[0], t[1]))
        for share_after, p in cand:
            if share_after >= self.unscale_factor * mean:
                break  # ascending: nothing colder follows
            lanes = self._assign[p]
            drop = max(lanes, key=lambda ln: (loads[ln], -ln))
            self._assign[p] = [ln for ln in lanes if ln != drop]
            return True
        return False

    # -- read side ------------------------------------------------------

    def assignment(self) -> List[List[int]]:
        with self._lock:
            return [list(lanes) for lanes in self._assign]

    def lanes_for(self, partition: int) -> List[int]:
        with self._lock:
            return list(self._assign[partition])

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "rebalances": self.rebalances,
                "scaled_partitions": sum(
                    1 for lanes in self._assign if len(lanes) > 1),
                "writer_lanes": self.w,
                "logical_partitions": self.n,
            }
