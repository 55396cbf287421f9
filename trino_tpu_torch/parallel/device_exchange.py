"""Device stage exchange: the engine's hash shuffle as ONE program over
every producer's rows and the d device slabs.

Reference analog: the ENTIRE pipelined data plane of a hash exchange —
``operator/output/PartitionedOutputOperator.java`` + ``PagePartitioner``
(producer), ``execution/buffer/PartitionedOutputBuffer.java`` (buffer),
``operator/ExchangeOperator.java:48`` + ``DirectExchangeClient.java:55``
(consumer) — collapsed, for co-resident stages, into a single device
program: rows are bucket-sorted by destination on the device and laid
into per-destination lanes, and every consumer task reads the rows of
its hash partition from them. No serialization, no host round-trip, no
HTTP.

The JAX engine's ``trino_tpu/parallel/device_exchange.py`` on torch.
Its ``jax.devices()`` mesh of d devices is a device list here, one
process driving d slabs as the JAX engine's single controller does:
producer task t's pages land in slab ``t % d`` on ``devices[t % d]``,
partition p lives on slab ``p % d``, partition ids ride along as a
carried channel and each consumer masks its partition out of its slab
(with d = n each slab holds its own partition). The count pass runs its
per-sender histograms slab by slab; its psum is a sum and its pmax a max
over the slabs. The data program lays out every sender's grid and runs
``repartition_a2a``'s all-to-all (receiver j takes lane block j of every
sender). Devices may repeat (``["cpu"] * d`` in the tests, ``["cuda:0"]
* 4`` on one card). With one receiver no partition is ever split
(splitting spreads a hot partition over receivers).

String columns: pools are unified BEFORE the collective (host builds a
code-remap LUT per divergent pool, devices apply it as a gather), and
key hashing uses a value-stable crc LUT so equal strings route equally
regardless of pool. This is the exchange-boundary "pool unification"
contract that downstream group-by/join kernels rely on. Codes index the
remap LUT clamped into range, as JAX gathers clamp.

Sizing protocol (skew-adaptive): all_to_all lanes are fixed capacity
(per_dest per sender/receiver pair), so per_dest must be chosen before
the data program runs. Three modes (``device_exchange_sizing``
session property):

- ``exact``: a count-first pass — a tiny counting collective (per-sender
  destination histograms + psum/pmax, O(n*d) scalars, negligible vs the
  payload) — observes the exact max (sender, dest) load and sizes
  per_dest exactly; the doubling retry below becomes dead code in
  practice (kept as a bug backstop).
- ``history`` (default): a process-wide EWMA of observed max loads keyed
  by exchange shape (types/keys/n/d — the plan-node signature),
  pow2-bucketed through ``padded_size`` so repeat shapes land on the
  same ``_exchange_program`` signature (no new first call, see
  ``jit_stats``); pre-sizes per_dest and skips the count pass once
  confident, falling back to ``exact`` until then.
- ``legacy``: the original guess (2*cap/d); on lane overflow the host
  doubles per_dest and re-runs the whole collective — under real skew
  that pays the full shuffle twice or more (the 2x cost cliff the
  count-first pass removes).

Hot-partition SPLITTING (scaled receivers): lanes are per (sender,
dest) pair, so ONE partition holding most of the rows caps the whole
collective at a single receiver lane's capacity however the collective
is sized — the workload count-first sizing alone cannot fix (reference:
``ScaleWriterPartitioningExchanger`` + ``UniformPartitionRebalancer``).
When the count pass's per-partition histogram (or the sizing history's
remembered partition fractions) shows a partition above
``hot_partition_split_threshold`` of the exchange's rows,
``_exchange_program`` SALTS that partition's destination with a
row-index-derived sub-bucket — its rows spread across ALL d receiver
devices — and the consumer-side ``pages(partition)`` gather re-merges
the sub-buckets (each partition's pages may now come from several
device slabs; the original partition id is carried through the
collective, so co-location per CONSUMER TASK is preserved, which is all
downstream aggregation/join operators require). The hot set rides into
the program as an (n,) mask tensor, so split and unsplit runs of the
same shape share one program signature.

Every collective records skew observability into ``self.stats``:
per-partition row counts, max/mean skew ratio, per-receiver lane loads,
hot partitions split and the receiver lanes they spread across,
per_dest chosen, retries, collective count and bytes moved — surfaced
through OperatorStats and EXPLAIN ANALYZE. ``total_collectives`` counts
the data passes that ran, process-wide.
"""

from __future__ import annotations

import threading
from functools import lru_cache, partial
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import types as T
from ..block import DevicePage, Dictionary, padded_size, storage_dtype
from ..telemetry.profiler import instrument
from ..telemetry.device_reads import host_scalar, to_host
from .exchange import (hash_partition_ids, key_to_u64, lut_tensor,
                       partition_histogram, repartition_a2a,
                       string_hash_lut)


def device_exchange_supported(types_: Sequence[T.Type]) -> bool:
    return all(t.storage is not None for t in types_)


SIZING_MODES = ("exact", "history", "legacy")


class ExchangeSizingHistory:
    """Process-wide EWMA of observed max (sender, dest) lane loads, keyed
    by exchange shape (types/key_channels/n/d — the plan-node signature,
    stable across queries of the same shape). ``presize`` returns a
    pow2-bucketed per_dest through the SAME ``padded_size`` bucketing the
    exact mode uses, so a stable workload re-lands on the identical
    ``_exchange_program`` signature.

    Reference analog: the observed-size adaptive partition sizing of
    ``HashDistributionSplitAssigner`` — capacity decided from counts seen,
    not guessed (the hybrid-hash-join robustness argument)."""

    def __init__(self, alpha: float = 0.5):
        self.alpha = alpha
        self._lock = threading.Lock()
        self._ewma: Dict[tuple, float] = {}
        self._obs: Dict[tuple, int] = {}
        #: last observed per-partition row FRACTIONS per shape — the
        #: hot-partition-split decision for a history-presized repeat
        #: (no count pass ran, so the hot set must be remembered too)
        self._fracs: Dict[tuple, list] = {}
        #: scaled-writer rebalancers keyed by exchange shape — same
        #: lifetime as the sizing EWMAs they ride with, so a repeat
        #: query reuses the learned partition->lane assignment instead
        #: of re-converging (reference: UniformPartitionRebalancer
        #: living on the long-lived exchange, not the query)
        self._rebalancers: Dict[tuple, object] = {}

    def observe(self, key: tuple, max_load: int,
                fractions: Optional[Sequence[float]] = None) -> None:
        with self._lock:
            prev = self._ewma.get(key)
            if prev is None or max_load >= prev:
                # grow IMMEDIATELY: an undersized presize costs a full
                # re-shuffle through the doubling backstop, an oversized
                # one only pads lanes — so track load spikes at once and
                # decay slowly
                self._ewma[key] = float(max_load)
            else:
                self._ewma[key] = (self.alpha * max_load
                                   + (1 - self.alpha) * prev)
            self._obs[key] = self._obs.get(key, 0) + 1
            if fractions is not None:
                self._fracs[key] = list(fractions)

    def presize(self, key: tuple) -> Optional[int]:
        """pow2-bucketed per_dest, or None while unconfident (no
        observation yet for this exchange shape)."""
        with self._lock:
            if self._obs.get(key, 0) < 1:
                return None
            return padded_size(max(int(round(self._ewma[key])), 16))

    def fractions(self, key: tuple) -> Optional[list]:
        """Last observed per-partition row fractions for this shape
        (None until observed) — feeds the presized hot-set decision."""
        with self._lock:
            fr = self._fracs.get(key)
            return list(fr) if fr is not None else None

    def rebalancer(self, key: tuple, factory):
        """The process-wide scaled-writer rebalancer for this exchange
        shape, created on first use by ``factory()``."""
        with self._lock:
            rb = self._rebalancers.get(key)
            if rb is None:
                rb = self._rebalancers[key] = factory()
            return rb

    def export_seed(self) -> list:
        """Serializable (key, ewma, obs, fractions) rows — the sizing
        knowledge a heartbeat piggybacks coordinator-ward so a new or
        replacement worker presizes exchanges from cluster history
        instead of re-learning from scratch."""
        with self._lock:
            return [[list(k), self._ewma[k], self._obs.get(k, 0),
                     self._fracs.get(k)] for k in self._ewma]

    def import_seed(self, seed) -> int:
        """Merge an exported seed, keeping the larger EWMA per shape
        (grow-immediately mirrors ``observe``); idempotent, so repeated
        heartbeat piggybacks are free. Returns rows merged."""
        if not seed:
            return 0
        merged = 0
        with self._lock:
            for row in seed:
                try:
                    key = tuple(tuple(x) if isinstance(x, list) else x
                                for x in row[0])
                    ewma, obs, fracs = float(row[1]), int(row[2]), row[3]
                except (TypeError, ValueError, IndexError):
                    continue
                if ewma >= self._ewma.get(key, 0.0):
                    self._ewma[key] = ewma
                    if fracs is not None:
                        self._fracs[key] = list(fracs)
                self._obs[key] = max(self._obs.get(key, 0), obs)
                merged += 1
        return merged

    def reset(self) -> None:
        with self._lock:
            self._ewma.clear()
            self._obs.clear()
            self._fracs.clear()
            self._rebalancers.clear()


#: the process-wide sizing history (one engine process = one history,
#: like the program signatures it keeps stable)
SIZING_HISTORY = ExchangeSizingHistory()


class DeviceExchange:
    """One fragment's hash-output boundary, executed as one device
    program.

    Producer tasks ``add_page`` their DevicePages; after all producers
    finish (the runner's stage barrier), the first consumer to call
    ``pages`` triggers the exchange; consumer task t reads the rows
    whose keys hash to partition t.

    Drop-in for ``ops.output.OutputBuffer`` on the consumer side: exposes
    ``pages(partition)`` (returning DevicePages, which
    ExchangeSourceOperator passes through).
    """

    def __init__(self, n_partitions: int, devices: Sequence,
                 sizing: str = "history",
                 history_key: Optional[tuple] = None,
                 hot_split_threshold: float = 0.5):
        # p-partitions-on-d-devices layout: with fewer devices than
        # partitions (one card being the important case), partition p
        # lives on device p % d; partition ids are carried through the
        # exchange and consumers split their device's slab by mask.
        # d == n degenerates to the exact 1:1 mapping.
        assert len(devices) >= 1
        assert sizing in SIZING_MODES, sizing
        self.n = n_partitions
        self.devices = [torch.device(x) for x in
                        list(devices)[:min(n_partitions, len(devices))]]
        self.d = len(self.devices)
        self.sizing = sizing
        #: history key override (defaults to the exchange shape —
        #: types/key_channels/n/d — at collect time)
        self.history_key = history_key
        #: a partition holding MORE than this fraction of the
        #: exchange's rows is split across all d receiver devices
        #: (>= 1.0 disables splitting; one receiver never splits)
        self.hot_split_threshold = hot_split_threshold
        self.types: Optional[List[T.Type]] = None
        self.key_channels: Optional[List[int]] = None
        self._by_task: Dict[int, List[DevicePage]] = {}
        self._lock = threading.Lock()
        self._result: Optional[List[List[DevicePage]]] = None
        self.a2a_retries = 0
        self.count_collectives = 0
        self.data_collectives = 0
        self.collective_ran = False  # test observability
        #: skew observability of the last collective (per-partition row
        #: counts, skew ratio, per_dest chosen, retries, bytes moved) —
        #: populated by _collect, surfaced via OperatorStats / EXPLAIN
        #: ANALYZE / bench
        self.stats: Optional[Dict] = None
        # streaming-scheduler support: the collective is a barrier — it
        # needs every producer's rows — so consumers park on a listen
        # token until the runner signals set_no_more_pages()
        self._no_more = False
        self._listeners: List = []

    def set_no_more_pages(self):
        with self._lock:
            if self._no_more:
                return
            self._no_more = True
            fired = list(self._listeners)
            self._listeners.clear()
        for cb in fired:
            cb()

    def abort(self):
        with self._lock:
            self._no_more = True
            self._result = [[] for _ in range(self.n)]
            self._by_task.clear()
            fired = list(self._listeners)
            self._listeners.clear()
        for cb in fired:
            cb()

    def channel(self, partition: int) -> "DeviceExchangeChannel":
        return DeviceExchangeChannel(self, partition)

    #: process-wide count of executed collectives (dryrun/test
    #: observability); guarded by _total_lock — instances have their own
    #: locks, and two exchanges can collect concurrently
    total_collectives = 0
    #: process-wide count of count-first sizing collectives (history
    #: hits skip them — assertable)
    total_count_collectives = 0
    #: process-wide count of hot partitions split across receivers
    #: (bench SKEW_RESULT / test observability)
    total_splits = 0
    _total_lock = threading.Lock()

    # -- producer side --------------------------------------------------

    def configure(self, types_: Sequence[T.Type],
                  key_channels: Sequence[int]):
        with self._lock:
            if self.types is None:
                self.types = list(types_)
                self.key_channels = list(key_channels)
            else:
                assert self.types == list(types_) and \
                    self.key_channels == list(key_channels), \
                    "producer tasks disagree on exchange layout"

    def add_page(self, task_id: int, page: DevicePage):
        with self._lock:
            self._by_task.setdefault(task_id, []).append(page)

    # -- consumer side --------------------------------------------------

    def pages(self, partition: int) -> List[DevicePage]:
        with self._lock:
            if self._result is None:
                self._result = self._collect()
        return self._result[partition]

    @property
    def total_rows(self) -> int:
        if self._result is None:
            return 0
        return sum(p.count() for ps in self._result for p in ps)

    # -- the collective -------------------------------------------------

    def _collect(self) -> List[List[DevicePage]]:
        n, d, types_ = self.n, self.d, self.types
        if types_ is None or not self._by_task:
            return [[] for _ in range(n)]
        nch = len(types_)

        # unify string pools: remap every divergent pool's codes into the
        # first pool seen per channel (device gather through a host LUT)
        target: List[Optional[Dictionary]] = [None] * nch
        for t in range(n):
            for p in self._by_task.get(t, []):
                for c in range(nch):
                    if p.dictionaries[c] is not None and target[c] is None:
                        target[c] = p.dictionaries[c]

        def unified_cols(p: DevicePage) -> List:
            cols = list(p.cols)
            for c in range(nch):
                d = p.dictionaries[c]
                if d is not None and d is not target[c]:
                    remap = (np.asarray(target[c].encode(list(d.values)),
                                        dtype=np.int32)
                             if len(d) else np.zeros(1, np.int32))
                    lut = torch.from_numpy(remap).to(p.cols[c].device)
                    cols[c] = lut[torch.clamp(p.cols[c].to(torch.int64),
                                              0, len(remap) - 1)]
            return cols

        # per-DEVICE slabs (padded lanes + valid masks carried as-is):
        # producer task t's pages land in slab t % d, on devices[t % d],
        # every slab padded to one capacity (the salting lane layout
        # depends on it: the same lanes as the JAX engine's)
        dev_pages: List[List[DevicePage]] = [[] for _ in range(d)]
        for t in sorted(self._by_task):
            dev_pages[t % d].extend(self._by_task[t])
        dev_caps = [sum(p.capacity for p in ps) for ps in dev_pages]
        cap = padded_size(max(max(dev_caps), 16))

        def pad(a, device):
            a = a.to(device)
            k = a.shape[0]
            if k == cap:
                return a
            return torch.cat([a, torch.zeros((cap - k,), dtype=a.dtype,
                                             device=device)])

        cols, nulls, valid = [], [], []
        for ps, device in zip(dev_pages, self.devices):
            page_cols = [unified_cols(p) for p in ps]
            if ps:
                cols.append(tuple(pad(torch.cat([pc[c] for pc in page_cols]),
                                      device) for c in range(nch)))
                nulls.append(tuple(pad(torch.cat([p.nulls[c] for p in ps]),
                                       device) for c in range(nch)))
                valid.append(pad(torch.cat([p.valid for p in ps]), device))
            else:
                cols.append(tuple(torch.zeros(
                    (cap,), dtype=storage_dtype(types_[c]), device=device)
                    for c in range(nch)))
                nulls.append(tuple(torch.zeros((cap,), dtype=torch.bool,
                                               device=device)
                                   for _ in range(nch)))
                valid.append(torch.zeros((cap,), dtype=torch.bool,
                                         device=device))
        # one read per slab (not one per page)
        if not any(host_scalar(v.any(), "device_exchange.any_rows")
                   for v in valid):
            return [[] for _ in range(n)]

        luts = [tuple(lut_tensor(string_hash_lut(target[c]), device)
                      for c in self.key_channels if types_[c].is_string)
                for device in self.devices]

        devs = tuple(str(x) for x in self.devices)
        tkey = tuple(types_)
        kkey = tuple(self.key_channels)
        hkey = self.history_key or (
            tuple(str(t) for t in types_), kkey, n, d)
        sizing = self.sizing
        mode_used = sizing
        # hot-partition splitting is a non-legacy feature (legacy IS the
        # pre-split baseline) and needs >= 2 receivers to spread over
        splittable = (self.hot_split_threshold < 1.0 and d > 1
                      and sizing != "legacy")
        hot: set = set()
        per_dest = None
        if sizing == "history":
            per_dest = SIZING_HISTORY.presize(hkey)
            if per_dest is None:
                mode_used = "exact"  # unconfident: fall back to counting
            elif splittable:
                # no count pass ran: the hot set comes from the
                # history's remembered partition fractions
                fracs = SIZING_HISTORY.fractions(hkey)
                if fracs is not None:
                    hot = {p for p, f in enumerate(fracs)
                           if f > self.hot_split_threshold}
        if sizing == "exact" or (sizing == "history" and per_dest is None):
            # count-first pass: the exact max (sender, dest) load from a
            # tiny counting pass; per_dest needs no retry headroom. Its
            # one host read sizes the lanes.
            cprog = _count_program(devs, tkey, kkey, n, d)
            hist, need, pair_max = cprog(cols, nulls, valid, luts)
            hist = to_host(hist, "device_exchange.count")
            self.count_collectives += 1
            with DeviceExchange._total_lock:
                DeviceExchange.total_count_collectives += 1
            total = int(hist.sum())
            if splittable and total:
                hot = {p for p in range(n)
                       if hist[p] / total > self.hot_split_threshold}
            if hot:
                pair_np = to_host(pair_max, "device_exchange.count"
                                  ).reshape(n, d)
                per_dest = padded_size(max(_salted_need_bound(
                    pair_np, hot, n, d), 16))
            else:
                per_dest = padded_size(max(int(host_scalar(
                    need, "device_exchange.count")), 16))
        elif sizing == "legacy":
            per_dest = padded_size(max(32, (2 * cap) // d))
        per_dest = min(per_dest, cap)
        # the hot set rides as an (n,) mask TENSOR: split and unsplit
        # runs of one shape share one program signature
        hot_mask = np.zeros((n,), dtype=np.int32)
        for p in hot:
            hot_mask[p] = 1
        hot_mask = [torch.from_numpy(hot_mask).to(device)
                    for device in self.devices]
        lanes_moved = 0
        while True:
            prog = _exchange_program(devs, tkey, kkey, n, d, per_dest)
            out_cols, out_nulls, out_valid, out_part, overflow = prog(
                cols, nulls, valid, luts, hot_mask)
            self.data_collectives += 1
            lanes_moved += d * d * per_dest  # at THIS attempt's capacity
            if sum(int(host_scalar(o, "device_exchange.overflow"))
                   for o in overflow) == 0:
                break
            if per_dest >= cap:
                raise T.TrinoError(
                    f"device exchange overflow with per_dest={per_dest} "
                    f">= sender capacity {cap} (bug, not skew)",
                    "GENERIC_INTERNAL_ERROR")
            # backstop only: exact sizing cannot overflow; a stale
            # history presize can, and the doubling recovers it (the
            # observation below re-teaches the history)
            per_dest = min(per_dest * 2, cap)
            self.a2a_retries += 1

        self.collective_ran = True
        with DeviceExchange._total_lock:
            DeviceExchange.total_collectives += 1

        # skew observability + history feedback, from the RESULT (costs
        # one host transfer of the valid/partition lanes, no extra
        # pass in any mode): receiver r's lanes [s*per_dest,
        # (s+1)*per_dest) came from sender s, so per-(receiver, sender)
        # valid counts give the exact max pair load actually observed
        ov = np.stack([to_host(v, "device_exchange.observe")
                       for v in out_valid])
        op_ids = np.stack([to_host(x, "device_exchange.observe")
                           for x in out_part])
        pair_rows = ov.reshape(d, d, per_dest).sum(axis=2)
        observed_max = int(pair_rows.max()) if pair_rows.size else 0
        partition_rows = np.bincount(op_ids[ov], minlength=n)[:n]
        total_rows = int(partition_rows.sum())
        SIZING_HISTORY.observe(
            hkey, observed_max,
            fractions=(partition_rows / total_rows).tolist()
            if total_rows else None)
        mean_rows = float(partition_rows.mean()) if n else 0.0
        # per-receiver-DEVICE loads: the number splitting actually moves
        # (partition skew is a property of the DATA and stays put;
        # spreading a hot partition flattens the receiver lanes)
        lane_rows = ov.reshape(d, -1).sum(axis=1)
        lane_mean = float(lane_rows.mean()) if d else 0.0
        # which receiver devices ended up holding each hot partition's
        # rows: the acceptance witness (>= 2 lanes under real skew) AND
        # the consumer-gather device list below
        devs_for = {
            p: [dev for dev in range(d)
                if ((op_ids[dev] == p) & ov[dev]).any()]
            for p in sorted(hot)}
        hot_spread = {p: len(dl) for p, dl in devs_for.items()}
        if hot:
            with DeviceExchange._total_lock:
                DeviceExchange.total_splits += len(hot)
        lane_bytes = (sum(np.dtype(t.storage).itemsize for t in types_)
                      + 4          # carried partition id (int32)
                      + nch + 1)   # null masks + valid mask (bool lanes)
        self.stats = {
            "kind": "device",
            "sizing": self.sizing,
            "sizing_used": mode_used,
            "per_dest": per_dest,
            "observed_max_pair_rows": observed_max,
            "a2a_retries": self.a2a_retries,
            "count_collectives": self.count_collectives,
            "data_collectives": self.data_collectives,
            "rows": total_rows,
            "partition_rows": [int(r) for r in partition_rows],
            "skew_ratio": (round(float(partition_rows.max()) / mean_rows, 3)
                           if mean_rows > 0 else 0.0),
            "lane_rows": [int(r) for r in lane_rows],
            "lane_skew_ratio": (round(float(lane_rows.max()) / lane_mean, 3)
                                if lane_mean > 0 else 0.0),
            "hot_partitions": sorted(hot),
            "splits": len(hot),
            "split_ways": d if hot else 1,
            "hot_spread": hot_spread,
            "bytes_moved": lanes_moved * lane_bytes,
        }
        # release producer-side inputs: without this the exchange pins
        # ~2x the exchanged bytes on the device for the rest of the query
        self._by_task.clear()
        out_dicts = list(target)
        result: List[List[DevicePage]] = []
        for p in range(n):
            if p in hot:
                # a split partition's rows landed on several devices:
                # gather its sub-buckets (the downstream "merge" — one
                # DevicePage per receiver slab actually holding rows)
                dl = devs_for[p] or [p % d]
            else:
                dl = [p % d]
            pages: List[DevicePage] = []
            for dev in dl:
                pv = out_valid[dev]
                if d < n or hot:
                    # split the device slab by carried partition id
                    # (with any split active, even n == d slabs hold
                    # foreign partitions' sub-buckets)
                    pv = pv & (out_part[dev] == p)
                pages.append(DevicePage(list(types_),
                                        [c[dev] for c in out_cols],
                                        [x[dev] for x in out_nulls],
                                        pv, out_dicts))
            result.append(pages)
        return result


def _salted_need_bound(pair_max: np.ndarray, hot: set, n: int,
                       d: int) -> int:
    """Safe upper bound on the max (sender, dest) lane load under the
    salted destination map, from the count pass's per-(partition,
    sub-bucket) per-sender maxima (``pair_max[p, sub]`` = pmax over
    senders of that sender's rows with partition p in sub-bucket sub).

    Per destination r, any single sender contributes at most: its rows
    of every UNSPLIT partition homed at r (bounded by the partition's
    per-sender max, i.e. pair_max summed over sub) plus, for every HOT
    partition, exactly its rows in the one sub-bucket that maps to r.
    pmax over senders bounds each term independently, so the sum bounds
    every sender — sized from it, the data collective cannot overflow
    (zero retries by construction, like the unsplit exact mode)."""
    per_part = pair_max.sum(axis=1)  # >= any sender's rows of partition p
    need = np.zeros(d, dtype=np.int64)
    for p in range(n):
        if p in hot:
            for sub in range(d):
                need[(p + sub) % d] += pair_max[p, sub]
        else:
            need[p % d] += per_part[p]
    return int(need.max()) if need.size else 0


def _normalized_keys(cols, nulls, luts, types_: tuple,
                     key_channels: tuple) -> List:
    """Per-row uint64 key columns for partition hashing — THE one
    normalization both the count and data programs run, so they cannot
    disagree on routing (a disagreement would turn exact sizing into
    silent overflow)."""
    keys = []
    li = 0
    for c in key_channels:
        lut = None
        if types_[c].is_string:
            lut = luts[li]
            li += 1
        keys.append(key_to_u64(cols[c], nulls[c], types_[c], lut))
    return keys


@lru_cache(maxsize=128)
def _count_program(devices: tuple, types_: tuple, key_channels: tuple,
                   n: int, d: int):
    """The count-first pass: each sender histograms its live rows by
    destination device, a sum over senders (the JAX ``psum``) gives the
    global per-partition row counts and a max (``pmax``) the exact max
    (sender, dest) lane load — O(n*d) scalars, negligible vs the payload
    it sizes. Also maxes the per-(partition, sub-bucket) histogram (n*d
    scalars) so the host can size the SALTED map exactly if it then
    decides to split a hot partition — one count pass covers both
    layouts. Memoized on (devices, types, keys, n, d) like the JAX
    engine's builder; its first call at each sender capacity counts one
    ``jit_stats`` first call. Takes per-slab lists (slab s on
    ``devices[s]``); the reductions over slabs run on the first slab's
    device."""

    def count(cols, nulls, valid, luts):
        hists, needs, pairs = [], [], []
        home = valid[0].device
        for scols, snulls, svalid, sluts in zip(cols, nulls, valid, luts):
            keys = _normalized_keys(scols, snulls, sluts, types_,
                                    key_channels)
            part = hash_partition_ids(keys, n)
            dest = part % d if d < n else part
            # the sub-bucket MUST match _exchange_program's salt exactly
            # (same lane layout -> same arange), or exact sizing of a
            # split run silently overflows
            sub = torch.arange(svalid.shape[0], dtype=torch.int32,
                               device=svalid.device) % d
            hists.append(partition_histogram(part, svalid, n).to(home))
            pairs.append(partition_histogram(part * d + sub, svalid,
                                             n * d).to(home))
            needs.append(torch.max(partition_histogram(dest, svalid,
                                                       d)).to(home))
        total_hist = torch.stack(hists).sum(dim=0)
        max_need = torch.stack(needs).max()
        pair_max = torch.stack(pairs).max(dim=0).values
        return total_hist, max_need, pair_max

    # profiled (telemetry.profiler) under the builder's own memo key:
    # same-shape but different programs never alias
    return instrument("device_exchange_count", count,
                      key=(devices, types_, key_channels, n, d))


@lru_cache(maxsize=128)
def _exchange_program(devices: tuple, types_: tuple, key_channels: tuple,
                      n: int, d: int, per_dest: int):
    """Build the shuffle: normalize keys -> partition ids -> bucket-sort
    -> the all-to-all over the d slabs. Memoized on (devices, types,
    keys, n, d, per_dest) so repeat shapes reuse the program (and count
    no new first call).

    With d < n the exchange routes to DEVICE p % d and the partition id
    rides along as an extra carried channel so the consumer can split
    its slab; with d == n device == partition and the carry is still
    returned (cheap) but unused.

    ``hot`` is a per-slab (n,) int32 mask TENSOR of hot partitions: a
    hot partition's rows salt their destination with a row-index-derived
    sub-bucket — ``(home + lane_index % d) % d`` — spreading ONE
    partition's rows across all d receivers while the carried original
    partition id lets the consumer gather re-merge them. A tensor (not
    a memo key) so split and unsplit runs share the program.

    Receiver r's slab is the concatenation of every sender's lane block
    r (``repartition_a2a``), on ``devices[r]``. Returns (cols, nulls)
    as per-column lists of receiver slabs, the receivers' valid and
    carried partition-id slabs, and each sender's overflow count."""

    def exchanged(cols, nulls, valid, luts, hot):
        send_cols, send_nulls, dests = [], [], []
        for scols, snulls, svalid, sluts, shot in zip(cols, nulls, valid,
                                                      luts, hot):
            keys = _normalized_keys(scols, snulls, sluts, types_,
                                    key_channels)
            part = hash_partition_ids(keys, n)
            base = part % d  # == part when d == n (part < n)
            sub = torch.arange(svalid.shape[0], dtype=torch.int32,
                               device=svalid.device) % d
            dests.append(torch.where(shot[part.to(torch.int64)] > 0,
                                     (base + sub) % d, base))
            false_ = torch.zeros(svalid.shape, dtype=torch.bool,
                                 device=svalid.device)
            send_cols.append(tuple(scols) + (part,))
            send_nulls.append(tuple(snulls) + (false_,))
        ex_cols, ex_nulls, ex_valid, overflow = repartition_a2a(
            send_cols, send_nulls, list(valid), dests, num_partitions=d,
            per_dest=per_dest, devices=devices)
        ncols = len(cols[0])
        return (tuple([r[i] for r in ex_cols] for i in range(ncols)),
                tuple([r[i] for r in ex_nulls] for i in range(ncols)),
                ex_valid, [r[ncols] for r in ex_cols], overflow)

    return instrument("device_exchange_program", exchanged,
                      key=(devices, types_, key_channels, n, d, per_dest))


class _DeviceExchangeToken:
    """Listen token over the exchange's producers-done event."""

    __slots__ = ("_ex",)

    def __init__(self, ex: DeviceExchange):
        self._ex = ex

    def on_ready(self, cb):
        with self._ex._lock:
            if not self._ex._no_more:
                self._ex._listeners.append(cb)
                return
        cb()


class DeviceExchangeChannel:
    """Streaming-consumer adapter: parks until ALL producers finished
    (the collective is inherently a barrier), then streams the
    partition's DevicePages."""

    def __init__(self, ex: DeviceExchange, partition: int):
        self.ex = ex
        self.partition = partition
        self._pages: Optional[List[DevicePage]] = None

    @property
    def stats(self) -> Optional[Dict]:
        """The exchange's skew stats (ready once the collective ran) —
        the consumer-side surface ExchangeSourceOperator.metrics reads."""
        return self.ex.stats

    def poll(self):
        if not self.ex._no_more:
            return None
        if self._pages is None:
            self._pages = list(self.ex.pages(self.partition))
        return self._pages.pop(0) if self._pages else None

    def at_end(self) -> bool:
        return self.ex._no_more and self._pages is not None \
            and not self._pages

    def has_page(self) -> bool:
        return self.ex._no_more and (self._pages is None
                                     or len(self._pages) > 0)

    def listen(self):
        return _DeviceExchangeToken(self.ex)


class DeviceExchangeSinkOperator:
    """Pipeline tail handing DevicePages to the exchange (replaces
    PartitionedOutputOperator on the device path — no host transfer)."""

    _finishing = False

    def __init__(self, input_types: Sequence[T.Type],
                 key_channels: Sequence[int], exchange: DeviceExchange,
                 task_id: int):
        exchange.configure(input_types, key_channels)
        self.exchange = exchange
        self.task_id = task_id
        self._done = False

    def needs_input(self) -> bool:
        return not self._finishing

    def blocked_token(self):
        return None

    def add_input(self, page: DevicePage):
        self.exchange.add_page(self.task_id, page)

    def metrics(self) -> Optional[Dict]:
        """Exchange skew stats for OperatorStats (None until a consumer
        triggered the collective — producer tasks finish before it
        runs; the stage-level attachment in distributed.py reads the
        final value)."""
        return self.exchange.stats

    def get_output(self):
        if self._finishing:
            self._done = True
        return None

    def finish(self):
        self._finishing = True

    def is_finished(self) -> bool:
        return self._done
