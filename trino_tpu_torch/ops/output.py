"""Stage-output repartitioning + exchange source operators.

Reference analog: ``operator/output/PartitionedOutputOperator.java`` +
``PagePartitioner.java`` (producer side: per-row partition assignment,
per-partition page builders, enqueue to OutputBuffer),
``execution/buffer/`` (PartitionedOutputBuffer / BroadcastOutputBuffer),
and ``operator/ExchangeOperator.java`` (consumer side).

The JAX engine's ``trino_tpu/ops/output.py`` on torch. Partition ids
are computed on the device from the same value-stable uint64
normalization the device exchange uses (``parallel/exchange.py``), so
both paths route a row alike; string keys hash via a LUT of stable crc32
values (codes are pool-local, values are not). The page's live lanes
are compacted on the device and come to the host once, with their
partition ids, and the per-partition row extraction runs there;
consumers upload each page to their device. The device exchange
(``parallel/device_exchange.py``) replaces this path for hash boundaries
that stay on the device.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import types as T
from ..block import Block, Dictionary, DevicePage, Page
from ..telemetry.device_reads import to_host
from ..parallel.exchange import (hash_partition_ids, key_to_u64,
                                 lut_tensor, string_hash_lut)
from .operator import Operator, SourceOperator


class ListenToken:
    """Snapshot of a buffer state version; ``on_ready(cb)`` fires cb
    once when the state changes after the snapshot — immediately if it
    already has (reference: the ListenableFuture returned by
    Operator.isBlocked / OutputBuffer.isFull)."""

    __slots__ = ("_buffer", "_version")

    def __init__(self, buffer: "OutputBuffer", version: int):
        self._buffer = buffer
        self._version = version

    def on_ready(self, cb: Callable[[], None]):
        self._buffer._register(cb, self._version)


class OutputBuffer:
    """Thread-safe per-partition page queues for one fragment's output
    (reference: execution/buffer/PartitionedOutputBuffer.java). With
    ``broadcast=True`` every consumer reads all pages (per-consumer
    cursors).

    Two consumption modes share one producer API:
    - barrier (``pages``): snapshot after the producing stage finished;
    - streaming (``poll``/``at_end``/``listen``): pages are consumed as
      producers enqueue them; ``set_no_more_pages`` marks the end;
      ``full``/``listen`` on the producer side give backpressure
      (reference: PipelinedQueryScheduler's streaming exchanges).
    """

    #: scaled-writer boundaries attach their UniformPartitionRebalancer
    #: here so the STAGE-level stats surface (EXPLAIN ANALYZE exchange
    #: line) carries the rebalance counters, same as the producer
    #: operator's metrics
    rebalancer = None

    def __init__(self, num_partitions: int, broadcast: bool = False,
                 max_pending_pages: Optional[int] = None):
        self.num_partitions = num_partitions
        self.broadcast = broadcast
        #: producer backpressure: a partition holding this many
        #: undrained pages reports full. None = unbounded — REQUIRED for
        #: barrier-mode stages (the consumer stage hasn't started when
        #: the producer runs, so any bound would deadlock); streaming
        #: mode sets a bound. Broadcast buffers are always unbounded
        #: (every consumer must see every page; build sides are small).
        self.max_pending_pages = max_pending_pages
        self._lock = threading.Lock()
        self._pages: List[List[Page]] = [
            [] for _ in range(1 if broadcast else num_partitions)]
        #: per-(partition,consumer) read cursors (broadcast keeps all
        #: pages; partitioned consumers advance a drain cursor so the
        #: barrier ``pages`` snapshot still sees everything)
        self._cursors: Dict[tuple, int] = {}
        self._no_more = False
        self._aborted = False
        self._version = 0
        self._listeners: List[tuple] = []  # (cb, seen_version)
        self._total_rows = 0
        #: per-PARTITION enqueued row counts (broadcast: one logical
        #: partition) — the host-path skew observability mirroring
        #: DeviceExchange.stats, so EXPLAIN ANALYZE reads identically
        #: whichever path a stage boundary took
        self._partition_rows = [0] * (1 if broadcast else num_partitions)
        #: hot-partition lane split (round 16): partition -> lane count.
        #: The host analog of the device collective's receiver spread —
        #: a partition holding most of the exchange's rows saturates its
        #: single pending-page bound and stalls EVERY producer however
        #: much slack its siblings have.  Extra lanes multiply the hot
        #: partition's capacity; enqueue round-robins rows-insensitive
        #: pages across lanes and ``poll`` drains them transparently
        #: (consumer-task co-location is untouched: all lanes ARE the
        #: partition).  Only hash-kind producers may request a split —
        #: merge-kind streams are per-producer SORTED and interleaving
        #: lanes would break the consumer's merge invariant.
        self._hot_lanes: Dict[int, int] = {}
        self._lane_pages: Dict[tuple, List[Page]] = {}
        self._lane_rows: Dict[tuple, int] = {}
        self._enq_rr: Dict[int, int] = {}
        self._drain_rr: Dict[int, int] = {}
        # streaming observability: did any consumer dequeue a page
        # before the producers finished?
        self.first_poll_ts: Optional[float] = None
        self.no_more_ts: Optional[float] = None

    # -- hot-partition lanes ----------------------------------------------

    def split_partition(self, partition: int, ways: int) -> bool:
        """Grow ``partition`` to ``ways`` drain lanes (idempotent,
        monotonic).  Returns whether the lane set changed.  Callers are
        responsible for the kind gate: ONLY order-insensitive (hash)
        producers may split."""
        if self.broadcast or ways <= 1:
            return False
        with self._lock:
            if self._aborted:
                return False
            cur = self._hot_lanes.get(partition, 1)
            if cur >= ways:
                return False
            self._hot_lanes[partition] = ways
            for lane in range(1, ways):
                self._lane_pages.setdefault((partition, lane), [])
                self._lane_rows.setdefault((partition, lane), 0)
            fired = self._bump_locked()
        for cb in fired:
            cb()
        return True

    def _lane_pending_locked(self, partition: int, lane: int) -> int:
        if lane == 0:
            return len(self._pages[partition]) - self._cursors.get(
                (partition, "drain"), 0)
        return len(self._lane_pages[(partition, lane)]) - \
            self._cursors.get((partition, "drain", lane), 0)

    # -- state/version plumbing -----------------------------------------

    def _bump_locked(self) -> List[Callable]:
        self._version += 1
        fired = [cb for cb, _ in self._listeners]
        self._listeners.clear()
        return fired

    def _register(self, cb: Callable[[], None], seen_version: int):
        with self._lock:
            if self._version == seen_version:
                self._listeners.append((cb, seen_version))
                return
        cb()

    def listen(self) -> ListenToken:
        with self._lock:
            return ListenToken(self, self._version)

    # -- producer side ---------------------------------------------------

    def enqueue(self, partition: int, page: Page):
        if page.num_rows == 0:
            return
        with self._lock:
            if self._aborted:
                return
            tgt = 0 if self.broadcast else partition
            lanes = 1 if self.broadcast else self._hot_lanes.get(tgt, 1)
            if lanes > 1:
                k = self._enq_rr.get(tgt, 0)
                self._enq_rr[tgt] = k + 1
                lane = k % lanes
            else:
                lane = 0
            if lane == 0:
                self._pages[tgt].append(page)
            else:
                self._lane_pages[(tgt, lane)].append(page)
                self._lane_rows[(tgt, lane)] += page.num_rows
            self._total_rows += page.num_rows
            self._partition_rows[tgt] += page.num_rows
            fired = self._bump_locked()
        for cb in fired:
            cb()

    def set_no_more_pages(self):
        import time as _time

        with self._lock:
            if self._no_more:
                return
            self._no_more = True
            self.no_more_ts = _time.monotonic()
            fired = self._bump_locked()
        for cb in fired:
            cb()

    def abort(self):
        """Failure path: drop pages, mark ended, wake everyone — blocked
        producers and consumers must all unwind so the query's error can
        propagate instead of deadlocking."""
        with self._lock:
            self._aborted = True
            self._no_more = True
            self._pages = [[] for _ in self._pages]
            self._lane_pages = {k: [] for k in self._lane_pages}
            fired = self._bump_locked()
        for cb in fired:
            cb()

    def full(self, partitions: Optional[Sequence[int]] = None) -> bool:
        if self.broadcast or self.max_pending_pages is None:
            return False
        with self._lock:
            if self._aborted:
                return False
            idxs = range(len(self._pages)) if partitions is None \
                else partitions
            for i in idxs:
                # a split partition reports full only when EVERY lane
                # is at the bound — the whole point of the extra lanes
                lanes = self._hot_lanes.get(i, 1)
                if all(self._lane_pending_locked(i, lane)
                       >= self.max_pending_pages
                       for lane in range(lanes)):
                    return True
        return False

    # -- streaming consumer side ----------------------------------------

    def poll(self, partition: int, consumer_id: int = 0) -> Optional[Page]:
        import time as _time

        with self._lock:
            if self.broadcast:
                cur = self._cursors.get((0, consumer_id), 0)
                ps = self._pages[0]
                if cur < len(ps):
                    self._cursors[(0, consumer_id)] = cur + 1
                    page = ps[cur]
                else:
                    return None
            else:
                page = None
                lanes = self._hot_lanes.get(partition, 1)
                start = self._drain_rr.get(partition, 0)
                for probe in range(lanes):
                    lane = (start + probe) % lanes
                    ps = self._pages[partition] if lane == 0 \
                        else self._lane_pages[(partition, lane)]
                    ckey = (partition, "drain") if lane == 0 \
                        else (partition, "drain", lane)
                    cur = self._cursors.get(ckey, 0)
                    if cur < len(ps):
                        self._cursors[ckey] = cur + 1
                        page = ps[cur]
                        # single-consumer partition: release the slot
                        # so the exchange doesn't pin the whole
                        # intermediate dataset for the query's lifetime
                        ps[cur] = None
                        self._drain_rr[partition] = lane + 1
                        break
                if page is None:
                    return None
            if self.first_poll_ts is None:
                self.first_poll_ts = _time.monotonic()
            fired = self._bump_locked()  # space freed: wake producers
        for cb in fired:
            cb()
        return page

    def _drained_locked(self, partition: int) -> bool:
        return all(self._lane_pending_locked(partition, lane) <= 0
                   for lane in range(self._hot_lanes.get(partition, 1)))

    def at_end(self, partition: int, consumer_id: int = 0) -> bool:
        with self._lock:
            if not self._no_more:
                return False
            if self.broadcast:
                return self._cursors.get((0, consumer_id), 0) >= \
                    len(self._pages[0])
            return self._drained_locked(partition)

    def has_page(self, partition: int, consumer_id: int = 0) -> bool:
        with self._lock:
            if self.broadcast:
                return self._cursors.get((0, consumer_id), 0) < \
                    len(self._pages[0])
            return not self._drained_locked(partition)

    def channel(self, partition: int, consumer_id: int = 0):
        return ExchangeChannel(self, partition, consumer_id)

    # -- barrier consumer side (legacy snapshot) -------------------------

    def pages(self, partition: int) -> List[Page]:
        with self._lock:
            tgt = 0 if self.broadcast else partition
            out = [p for p in self._pages[tgt] if p is not None]
            if not self.broadcast:
                for lane in range(1, self._hot_lanes.get(tgt, 1)):
                    out.extend(p for p in self._lane_pages[(tgt, lane)]
                               if p is not None)
            return out

    @property
    def total_rows(self) -> int:
        with self._lock:
            return self._total_rows

    @property
    def stats(self) -> dict:
        """Host-path exchange skew stats — the SAME surface as
        ``DeviceExchange.stats`` (partition_rows / skew_ratio / rows),
        with device-only fields pinned to host values, so EXPLAIN
        ANALYZE renders stage boundaries identically on both paths."""
        with self._lock:
            rows = list(self._partition_rows)
            hot = dict(self._hot_lanes)
        mean_rows = (sum(rows) / len(rows)) if rows else 0.0
        out = {
            "kind": "host",
            "sizing": None,
            "per_dest": None,
            "a2a_retries": 0,
            "count_collectives": 0,
            "data_collectives": 0,
            "rows": sum(rows),
            "partition_rows": rows,
            "skew_ratio": (round(max(rows) / mean_rows, 3)
                           if mean_rows > 0 else 0.0),
            # device-path parity (DeviceExchange.stats): which
            # partitions went hot and how wide their lanes spread
            "hot_partitions": sorted(hot),
            "splits": len(hot),
            "split_ways": max(hot.values()) if hot else 1,
            "hot_spread": hot,
        }
        if self.rebalancer is not None:
            out.update(self.rebalancer.stats())
        return out

    @property
    def overlapped(self) -> bool:
        """True iff a consumer dequeued a page while producers were
        still running (the streaming-overlap witness)."""
        return self.first_poll_ts is not None and (
            self.no_more_ts is None
            or self.first_poll_ts < self.no_more_ts)


def wait_readable(buffer: OutputBuffer, timeout: float = 0.25):
    """Block the calling thread until the buffer's state version moves
    (page enqueued/drained, no-more, abort) or the timeout passes — the
    thread-world adapter used by the worker's long-poll result server."""
    ev = threading.Event()
    buffer.listen().on_ready(ev.set)
    ev.wait(timeout)


class ExchangeChannel:
    """One consumer's view of an OutputBuffer partition — the streaming
    handle ExchangeSourceOperator drives (reference:
    operator/DirectExchangeClient.java)."""

    __slots__ = ("buffer", "partition", "consumer_id")

    def __init__(self, buffer: OutputBuffer, partition: int,
                 consumer_id: int):
        self.buffer = buffer
        self.partition = partition
        self.consumer_id = consumer_id

    def poll(self) -> Optional[Page]:
        return self.buffer.poll(self.partition, self.consumer_id)

    def at_end(self) -> bool:
        return self.buffer.at_end(self.partition, self.consumer_id)

    def has_page(self) -> bool:
        return self.buffer.has_page(self.partition, self.consumer_id)

    def listen(self) -> ListenToken:
        return self.buffer.listen()


class PartitionedOutputOperator(Operator):
    """Routes each row of the input to an output-buffer partition.
    kind: 'hash' (by key columns), 'single' (partition 0), 'broadcast',
    'merge' (everything to this task's OWN partition so the consumer
    sees one sorted stream per producer).
    """

    def __init__(self, input_types: Sequence[T.Type],
                 key_channels: Sequence[int], buffer: OutputBuffer,
                 kind: str = "hash", task_partition: int = 0,
                 rebalancer=None, hot_split_threshold: float = 0.5):
        assert kind in ("hash", "single", "broadcast", "merge")
        self.input_types = list(input_types)
        self.key_channels = list(key_channels)
        self.buffer = buffer
        self.kind = kind
        self.task_partition = task_partition
        #: host analog of the device collective's hot-partition split
        #: (round 16): when one partition's observed share of this
        #: producer's rows exceeds the threshold on a BOUNDED buffer,
        #: the partition grows extra drain lanes so its pending-page
        #: bound scales like the device path's receiver spread.  Hash
        #: kind ONLY — merge streams are sorted and must not interleave
        #: — and never under a rebalancer (scaled writers already
        #: spread hot partitions across lanes).
        self.hot_split_threshold = float(hot_split_threshold)
        self._observed_rows: Optional[np.ndarray] = None
        #: scaled-writer boundary: a UniformPartitionRebalancer mapping
        #: MORE logical hash partitions than writer lanes; hot logical
        #: partitions are scaled across several lanes (rows round-robin
        #: within the assigned set), re-assigned from observed counts
        #: (reference: ScaleWriterPartitioningExchanger). Writer lanes
        #: don't need key co-location, so remapping is free to chase
        #: balance — the generic hash path must NOT set this.
        self.rebalancer = rebalancer
        #: per-logical-partition round-robin cursor, persistent ACROSS
        #: pages — restarting at lane 0 each page would concentrate a
        #: scaled partition's rows on its first lane under small pages
        #: (the reference exchanger keeps this counter per partition)
        self._rr: Dict[int, int] = {}
        self._done = False
        self._lut_cache: Dict[tuple, torch.Tensor] = {}

    def needs_input(self) -> bool:
        # backpressure: stall the pipeline while any destination
        # partition has too many undrained pages
        return not self._finishing and not self.buffer.full()

    def blocked_token(self):
        if self._finishing:
            return None
        # snapshot-then-recheck: a drain between full() and listen()
        # must not park us on a version that never moves again
        token = self.buffer.listen()
        return token if self.buffer.full() else None

    def add_input(self, page: DevicePage):
        n = self.buffer.num_partitions
        if self.kind == "merge":
            self.buffer.enqueue(self.task_partition, page.to_page())
            return
        if self.kind != "hash" or n == 1:
            host = page.to_page()
            self.buffer.enqueue(0, host)
            return
        keys_u64 = []
        for c in self.key_channels:
            t = page.types[c]
            lut = None
            if t.is_string:
                d = page.dictionaries[c]
                key = (id(d), len(d) if d is not None else 0)
                lut = self._lut_cache.get(key)
                if lut is None:
                    lut = lut_tensor(string_hash_lut(d), page.device)
                    self._lut_cache[key] = lut
            keys_u64.append(key_to_u64(page.cols[c], page.nulls[c], t, lut))
        n_logical = self.rebalancer.n if self.rebalancer is not None else n
        # the page's one trip to the host: the live lanes of the ids and
        # columns, compacted on the device first
        keep = torch.nonzero(page.valid).squeeze(1)
        part = to_host(hash_partition_ids(keys_u64, n_logical)[keep],
                       "output.partition_ids")
        rows, cols, nulls = page.live_lanes(keep)
        valid = np.ones(rows, dtype=bool)
        if self.rebalancer is not None:
            part = self._rebalanced_lanes(part, valid)
        elif self.hot_split_threshold < 1.0 and n > 1 and \
                self.buffer.max_pending_pages is not None:
            self._split_hot(np.bincount(part[valid], minlength=n)[:n])
        for p in range(n):
            idx = np.nonzero(valid & (part == p))[0]
            if len(idx) == 0:
                continue
            blocks = []
            for t, c, nl, d in zip(page.types, cols, nulls,
                                   page.dictionaries):
                bn = nl[idx]
                blocks.append(Block(t, c[idx], bn if bn.any() else None, d))
            self.buffer.enqueue(p, Page(blocks, len(idx)))

    def _split_hot(self, page_rows: np.ndarray):
        """Accumulate this producer's per-partition row histogram and
        grow lanes for any partition above the hot threshold — the same
        observed-share trigger as DeviceExchange's count-pass split,
        applied to the host buffer's capacity bounds."""
        if self._observed_rows is None:
            self._observed_rows = page_rows.astype(np.int64)
        else:
            self._observed_rows += page_rows
        total = int(self._observed_rows.sum())
        if total == 0:
            return
        ways = max(2, self.buffer.num_partitions)
        for p in np.nonzero(self._observed_rows / total
                            > self.hot_split_threshold)[0]:
            self.buffer.split_partition(int(p), ways)

    def _rebalanced_lanes(self, part: np.ndarray,
                          valid: np.ndarray) -> np.ndarray:
        """Logical partition ids -> writer lanes through the current
        rebalancer assignment; feeds the observation that adapts it.
        Scaled partitions round-robin their rows across the assigned
        lane set by row position (deterministic)."""
        reb = self.rebalancer
        reb.observe(np.bincount(part[valid], minlength=reb.n)[:reb.n])
        assignment = reb.assignment()
        first_lane = np.asarray([lanes[0] for lanes in assignment],
                                dtype=part.dtype)
        lane = first_lane[part]
        for lp, lanes in enumerate(assignment):
            if len(lanes) <= 1:
                continue
            idx = np.nonzero(valid & (part == lp))[0]
            if len(idx):
                start = self._rr.get(lp, 0)
                lane[idx] = np.asarray(lanes)[
                    (start + np.arange(len(idx))) % len(lanes)]
                self._rr[lp] = (start + len(idx)) % len(lanes)
        return lane

    def metrics(self) -> Optional[dict]:
        """Host-path exchange stats for OperatorStats (hash kind only:
        single/broadcast/merge routing has no skew to observe).
        Rebalancer counters already ride buffer.stats — the buffer is
        the one merge point."""
        if self.kind != "hash":
            return None
        return self.buffer.stats

    def get_output(self):
        if self._finishing:
            self._done = True
        return None

    def is_finished(self) -> bool:
        return self._done


class ExchangeSourceOperator(SourceOperator):
    """Reads this task's partition of an upstream fragment's output
    (reference: operator/ExchangeOperator.java).

    Host pages upload to ``device``; device-exchange pages are already
    there. Two source modes, decided by what the planner's
    exchange_reader hands over:
    - a CALLABLE (barrier mode): a thunk returning the full page list
      once the producing stage finished; string columns re-encode into
      one pool via Page.concat;
    - an object with ``poll``/``at_end``/``listen`` (streaming mode,
      e.g. ExchangeChannel): pages are consumed as producers enqueue
      them, each re-encoded INCREMENTALLY into stable per-channel pools
      (downstream kernels require one pool per channel across pages);
      when no page is available the operator reports a blocked token so
      the task executor parks the task instead of spinning."""

    def __init__(self, pages_thunk, types_: Sequence[T.Type], device,
                 source_fragment: Optional[int] = None):
        self.device = device
        self._streaming = hasattr(pages_thunk, "poll")
        self._chan = pages_thunk if self._streaming else None
        self._thunk = None if self._streaming else pages_thunk
        self.types = list(types_)
        #: producing fragment id (EXPLAIN ANALYZE attribution of the
        #: exchange metrics below)
        self.source_fragment = source_fragment
        self._pages: Optional[List[Page]] = None
        self._done = False
        #: streaming: the stable target pool per pooled channel — the
        #: first arriving page's pool; later pages remap into it
        self._target_dicts: List[Optional[Dictionary]] = \
            [None] * len(self.types)

    def add_split(self, split):
        raise AssertionError("exchange source has no splits")

    def metrics(self) -> Optional[dict]:
        """The upstream exchange's skew stats, read from the consumer
        side — by the time this driver finishes, the collective has run
        (device path) / all producers enqueued (host path)."""
        chan = self._chan
        stats = None
        if chan is not None:
            stats = getattr(chan, "stats", None)
            if stats is None:
                buf = getattr(chan, "buffer", None)
                stats = getattr(buf, "stats", None)
        if stats and self.source_fragment is not None:
            stats = dict(stats)
            stats["source_fragment"] = self.source_fragment
        return stats

    def blocked_token(self):
        if self._streaming and not self._done:
            token = self._chan.listen()
            # re-check AFTER snapshotting the version: a page/no_more
            # arriving between poll() and listen() must not park us
            if self._chan.at_end() or self._chan.has_page():
                return None
            return token
        return None

    def _reencode(self, page: Page) -> Page:
        """Remap pooled columns into the stable target pools (host-side
        LUT gathers; target pools grow via Dictionary.code)."""
        blocks = []
        changed = False
        for c, t in enumerate(self.types):
            b = page.block(c).numpy()
            if not t.is_pooled or b.dictionary is None:
                blocks.append(b)
                continue
            tgt = self._target_dicts[c]
            if tgt is None:
                self._target_dicts[c] = b.dictionary
                blocks.append(b)
                continue
            if b.dictionary is tgt:
                blocks.append(b)
                continue
            remap = (np.asarray(tgt.encode(list(b.dictionary.values)),
                                dtype=np.int32)
                     if len(b.dictionary) else np.zeros(1, np.int32))
            blocks.append(Block(t, remap[b.data], b.nulls, tgt))
            changed = True
        return Page(blocks, page.num_rows) if changed else page

    def get_output(self) -> Optional[DevicePage]:
        if self._streaming:
            item = self._chan.poll()
            if item is not None:
                if isinstance(item, DevicePage):
                    return item  # device collective: pools pre-unified
                return DevicePage.from_page(self._reencode(item),
                                            self.device)
            if self._chan.at_end():
                self._done = True
            return None
        if self._pages is None:
            items = self._thunk()
            if items and isinstance(items[0], DevicePage):
                # device-collective exchange: rows arrived by all_to_all
                # with unified pools — pass straight through
                self._pages = list(items)
            else:
                pages = [p for p in items if p.num_rows]
                if pages and any(t.is_string for t in self.types):
                    pages = [Page.concat(pages)]
                self._pages = pages
        if self._pages:
            nxt = self._pages.pop(0)
            if isinstance(nxt, DevicePage):
                return nxt
            return DevicePage.from_page(nxt, self.device)
        self._done = True
        return None

    def is_finished(self) -> bool:
        return self._done
