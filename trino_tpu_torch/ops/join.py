"""Hash joins on torch: the JAX engine's sorted-index join.

Reference analog: ``operator/join/HashBuilderOperator.java`` (build side)
+ ``LookupJoinOperator.java`` / ``JoinProbe`` (probe side), plus
``SetBuilderOperator``/``ChannelSet`` for semi joins.

The design is the JAX engine's (``trino_tpu/ops/join.py``): the build side
becomes a **sorted index** — key columns normalize to one 64-bit key
(exact for single keys; packed or hashed for multi-key), one sort orders
the build rows, and probing is two ``searchsorted`` calls giving each
probe row its candidate range. Matches expand via cumsum offsets into an
output whose capacity is GUESSED from a running expansion ratio; the
exact total rides along as a device scalar and is read only once the
probe pipeline is ``pipeline_depth`` pages deep, so the host never blocks
on the page it just enqueued, and an overflowing guess re-expands at the
exact size. Candidates are verified against the raw key columns, so hash
collisions cost only capacity, never correctness. Unmatched-probe lanes
for LEFT/ANTI come from a segment-OR over verified matches.

torch has no uint64 ``searchsorted``, ``<`` or logical ``>>``, so the key
is the JAX engine's uint64 with bit 63 flipped, held as int64 (as
``ops/sortkeys.py`` does for sort keys): signed order over the flipped
key is unsigned order over the JAX key, and the JAX engine's all-ones
sentinel for unusable build lanes becomes int64 max.

CUDA gathers do not clamp an index that is out of range (JAX's do), so
every index a dead lane can carry is put in range before it is used.

Under memory pressure the build degrades as the JAX engine's dynamic
hybrid hash join does ("Design Trade-offs for a Robust Dynamic Hybrid Hash
Join"): the first revocation partitions the build input by a splitmix64
hash of the join key VALUES; hot partitions stay on the device and feed
the sorted index, cold partitions park page by page through the spill
tiers (``exec/memory.py``). Probe rows of cold partitions park beside
their partition and join in per-partition unspill -> probe passes once
the probe input is done; a partition that still does not fit
repartitions with a depth-salted hash (``hybrid_join_max_depth``). The
partition hash runs on the host in numpy uint64, as in the JAX engine:
the rows are on the host for parking anyway, and torch has no uint64
shifts. FULL OUTER, or ``hybrid_join_enabled=false``, parks the whole
build instead.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as T
from ..block import (DevicePage, Dictionary, padded_size, storage_dtype,
                     unify_dictionaries)
from ..telemetry.profiler import instrument
from ..telemetry.device_reads import host_scalar, to_host
from .kernels import _i64, _shr
from .operator import Operator
from .sort import _pad
from .sortkeys import group_operands

_SIGN64 = -(1 << 63)          # int64 with only bit 63 set
#: the JAX engine's uint64 sentinel 0xFFFF_FFFF_FFFF_FFFF, bit 63 flipped
KEY_SENTINEL = (1 << 63) - 1


def _canonical_codes(codes, dictionary):
    """Map dictionary codes to the FIRST code of their value, so equal
    strings in an aligned (duplicate-valued) pool compare equal by code."""
    if dictionary is None or len(dictionary) == 0:
        return codes
    canon = np.fromiter(
        (dictionary.lookup(v) for v in dictionary.values),
        dtype=np.int32, count=len(dictionary))
    if (canon == np.arange(len(canon), dtype=np.int32)).all():
        return codes  # already canonical (the common, dedup'd pool)
    return torch.from_numpy(canon).to(codes.device)[codes.to(torch.int64)]


def _key_u64(cols, nulls, types_, mode: str) -> Tuple:
    """(key, any_null): the combined 64-bit join key per row, as the JAX
    engine's uint64 with bit 63 flipped (int64).

    mode (decided once on the build side and shared via the build side
    so both sides encode identically):
    - 'single': one key, exact
    - 'packed': two keys, both known to fit 32 bits — exact pack
    - 'hashed': splitmix-combined (collisions verified against raw keys)
    """
    ops = []
    anynull = None
    for c, nl, t in zip(cols, nulls, types_):
        null_bit, key = group_operands(c, nl, t)
        if key.dtype == torch.float64:
            # float join keys: the JAX engine's frexp-based 64-bit key;
            # 2 dropped mantissa bits => rare extra candidates, all
            # filtered by the raw-key verify pass
            m, e = torch.frexp(key)
            mant = (m.abs() * float(1 << 53)).to(torch.int64) >> 2
            sign = (key < 0).to(torch.int64)
            key = ((e.to(torch.int64) + 1100) << 52) | mant | (sign << 63)
        ops.append(key)
        anynull = null_bit.bool() if anynull is None \
            else (anynull | null_bit.bool())
    if mode == "single":
        key = ops[0]
    elif mode == "packed":
        key = (ops[0] << 32) | (ops[1] & 0xFFFFFFFF)
    else:
        key = _hash_combine(ops)
    return key ^ _SIGN64, anynull


_H1 = _i64(0x9E3779B97F4A7C15)
_H2 = _i64(0xBF58476D1CE4E5B9)


def _hash_combine(ops):
    """The JAX engine's uint64 key combine on int64 lanes: products wrap
    like uint64 and ``>>`` is logical (``_shr``)."""
    acc = torch.zeros_like(ops[0])
    for k in ops:
        z = (k + _H1) * _H2
        z = z ^ _shr(z, 29)
        acc = (acc * 31) ^ z
    return acc


def _build_sorted(key, anynull, cols, nulls, valid):
    """Sort the build rows by key; null-key or invalid lanes sort last.
    ``valid`` rides along so FULL OUTER can emit unmatched build rows
    (including null-key rows, which are never ``usable``). The sort is
    stable, so equal keys keep their input order on every device."""
    usable = valid & ~anynull
    sort_key = torch.where(usable, key, KEY_SENTINEL)
    order = torch.sort(sort_key, stable=True).indices
    return (sort_key[order], usable[order], valid[order],
            [c[order] for c in cols], [n[order] for n in nulls])


# profiled programs (telemetry.profiler), under the JAX engine's names;
# plain calls when profiling is off. ``_probe_counts_impl`` is what the
# batched executor composes, as the JAX engine composes its un-jitted
# implementation; the expansion below runs inside ``_expand_verified``
# in both engines, never as a program of its own
_build_sorted = instrument("join_build_sorted", _build_sorted)


def _probe_counts_impl(build_keys, build_usable, probe_keys, probe_usable):
    """Each probe row's candidate range: (lo, count) into the sorted
    build keys."""
    lo = torch.searchsorted(build_keys, probe_keys)
    hi = torch.searchsorted(build_keys, probe_keys, right=True)
    count = torch.where(probe_usable, hi - lo, 0)
    return lo, count


_probe_counts = instrument("join_probe_counts", _probe_counts_impl)


def _expand_matches(lo, count, out_cap: int):
    """Candidate pairs: output lane j -> (probe_row, build_row, live).
    Dead lanes (j >= total) point at build row 0: their JAX formula can
    pass the build's capacity, which a CUDA gather would not clamp."""
    off_end = torch.cumsum(count, 0)
    total = off_end[-1]
    j = torch.arange(out_cap, dtype=torch.int64, device=count.device)
    probe_idx = torch.searchsorted(off_end, j, right=True) \
        .clamp_(0, count.shape[0] - 1)
    start = off_end[probe_idx] - count[probe_idx]
    lane_valid = j < total
    build_idx = torch.where(lane_valid, lo[probe_idx] + (j - start), 0)
    return probe_idx, build_idx, lane_valid


def _expand_verified(lo, count, pkey_cols, bkey_cols, build_usable,
                     out_cap: int):
    """Candidate lanes with verification applied: the raw keys are equal
    and the build row is usable. A probe key with the sentinel's 64 bits
    (a BIGINT -1) finds the unusable build rows — NULL keys and dead
    lanes, whose raw key can equal it — as candidates; the JAX engine
    checks only the raw keys and so joins a dead build lane holding -1."""
    probe_idx, build_idx, keep = _expand_matches(lo, count, out_cap)
    keep = keep & build_usable[build_idx]
    for pc, bc in zip(pkey_cols, bkey_cols):
        keep = keep & (pc[probe_idx] == bc[build_idx])
    return probe_idx, build_idx, keep


def _segment_any(keep, probe_idx, probe_cap: int):
    """OR of ``keep`` lanes per probe row: every kept lane writes True at
    its row, every other lane at the sink lane ``probe_cap``."""
    matched = torch.zeros(probe_cap + 1, dtype=torch.bool,
                          device=keep.device)
    matched[torch.where(keep, probe_idx, probe_cap)] = True
    return matched[:-1]


def _semi_matched(lo, count, pkey_cols, bkey_cols, build_usable,
                  probe_cap: int, out_cap: int):
    """Per-probe-row matched flag: expand candidates, verify them,
    segment-OR back onto probe rows (collision-safe for any key mode)."""
    probe_idx, _, keep = _expand_verified(lo, count, pkey_cols, bkey_cols,
                                          build_usable, out_cap)
    return _segment_any(keep, probe_idx, probe_cap)


def _mark_build_matched(acc, keep, build_idx):
    """OR kept lanes into the per-sorted-build-row matched accumulator,
    in place (last lane of ``acc`` is the dead-lane sink)."""
    acc[torch.where(keep, build_idx, acc.shape[0] - 1)] = True
    return acc


def _finalize_join(pcols, pnulls, pvalid, bcols, bnulls, probe_idx,
                   build_idx, keep, left: bool):
    """Gather joined output lanes; for LEFT, append one lane per probe
    row, valid iff the row matched no kept lane (NULL build columns)."""
    lane_cap = probe_idx.shape[0]
    dev = keep.device
    if left:
        matched = _segment_any(keep, probe_idx, pvalid.shape[0])
        n_extra = pvalid.shape[0]
        probe_idx = torch.cat([probe_idx, torch.arange(
            n_extra, dtype=probe_idx.dtype, device=dev)])
        build_idx = torch.cat([build_idx, torch.zeros(
            n_extra, dtype=build_idx.dtype, device=dev)])
        keep = torch.cat([keep, pvalid & ~matched])
        build_is_null = torch.cat([
            torch.zeros(lane_cap, dtype=torch.bool, device=dev),
            torch.ones(n_extra, dtype=torch.bool, device=dev)])
    else:
        build_is_null = torch.zeros(lane_cap, dtype=torch.bool, device=dev)
    out_cols = [c[probe_idx] for c in pcols] + [c[build_idx] for c in bcols]
    out_nulls = [n[probe_idx] for n in pnulls] + \
        [n[build_idx] | build_is_null for n in bnulls]
    return out_cols, out_nulls, keep


@dataclass
class BuildSide:
    key_sorted: torch.Tensor
    usable_sorted: torch.Tensor
    valid_sorted: torch.Tensor
    cols: List
    nulls: List
    types: List
    dictionaries: List
    key_channels: List
    key_mode: str = "single"


class JoinBridge:
    """Hand-off from the build pipeline to the probe pipeline (reference:
    operator/join/JoinBridge.java / PartitionedLookupSourceFactory)."""

    def __init__(self):
        self.build: Optional[BuildSide] = None
        self.release = None  # set by the builder; probe calls at finish
        #: HybridJoinState once the builder entered partitioned mode
        #: under memory pressure; None on the (common) fully resident
        #: path. The probe routes rows by it and runs the deferred
        #: per-partition unspill -> probe passes at finish.
        self.hybrid: Optional["HybridJoinState"] = None

    def set_build(self, b: BuildSide):
        self.build = b

    def destroy(self):
        """Probe side is done: drop the build index + its memory
        reservation (reference: LookupSourceFactory destroy)."""
        self.build = None
        if self.release is not None:
            self.release()
            self.release = None


def _assemble_build_side(input_types, key_channels, cols, nulls, valid,
                         dicts) -> BuildSide:
    """Canonicalize key codes, pick the key mode, normalize the keys and
    sort: the tail of the build publish."""
    kc = list(key_channels)
    cols = list(cols)
    # pooled keys (strings and array/map/row composites) join on
    # dictionary CODES in the build's pool: the probe side remaps its
    # codes into this pool (LookupJoinOperator._remap). Canonical codes
    # first: an aligned pool may map one value to several codes, and
    # code equality must mean value equality. Canonical codes decode to
    # the same values, so rewriting the stored column is output-safe.
    for c in kc:
        if input_types[c].is_pooled:
            cols[c] = _canonical_codes(cols[c], dicts[c])
    key_types = [T.BIGINT if input_types[c].is_pooled
                 else input_types[c] for c in kc]
    mode = "single" if len(kc) == 1 else "hashed"
    if len(kc) == 2:
        # pack two keys iff both are provably 32-bit lanes (4-byte
        # integer/bool storage, or pooled codes); floats use all 64 bits
        # of their key. The key only buckets — candidates are verified
        # against raw keys — so a conservative choice is safe.
        fits32 = [
            input_types[c].is_pooled
            or (t.storage is not None
                and np.dtype(t.storage).kind in "iub"
                and np.dtype(t.storage).itemsize <= 4)
            for c, t in zip(kc, key_types)]
        mode = "packed" if all(fits32) else "hashed"
    key, anynull = _key_u64([cols[c] for c in kc], [nulls[c] for c in kc],
                            key_types, mode)
    ks, us, vs, scols, snulls = _build_sorted(key, anynull, cols, nulls,
                                              valid)
    return BuildSide(ks, us, vs, scols, snulls, list(input_types),
                     list(dicts), kc, mode)


# -- dynamic hybrid hash join ------------------------------------------------


def _splitmix64_np(z: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over a uint64 numpy array (wraps mod 2^64)."""
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _salt_for_depth(depth: int) -> int:
    """Per-recursion-level hash salt: the same key must land in different
    sub-partitions when an oversized partition repartitions, or recursion
    could never split it."""
    return (0x9E3779B97F4A7C15 * (depth + 1)) & 0xFFFFFFFFFFFFFFFF


class HybridJoinState:
    """Resident-set bookkeeping shared by the build and probe operators
    of one hybrid hash join.

    ``_lock`` guards the partition table: ``resident`` (the device
    resident partition ids) and the cold-partition spill lists mutate
    under it — the build driver routing input, the pool's revocation
    callback demoting partitions, and the probe driver parking cold
    probe rows."""

    def __init__(self, fanout: int, max_depth: int = 3,
                 source: str = "local", depth: int = 0):
        self._lock = threading.RLock()
        self.fanout = fanout
        self.max_depth = max_depth
        self.source = source        # fanout provenance: session|hbo|local
        self.depth = depth
        self.salt = _salt_for_depth(depth)
        self.resident = frozenset(range(fanout))
        #: pid -> [SpilledPage] (build rows of demoted partitions)
        self.spilled_build: Dict[int, List] = {}
        #: pid -> [SpilledPage] (probe rows parked beside their build)
        self.spilled_probe: Dict[int, List] = {}
        self.demotions = 0          # revocation-driven partition demotions
        self.repartitions = 0       # recursive splits on unspill
        self.max_depth_seen = depth
        self.spilled_build_rows = 0
        self.total_build_rows = 0
        #: the build's memory context (set by the builder): the probe's
        #: deferred passes reserve partition transients against it
        self.ctx = None
        #: pooled-key value-hash LUT cache (dict objects pinned so a
        #: reused id() can never alias a dead pool)
        self._hash_luts: Dict[tuple, tuple] = {}

    # -- partition table mutations (all under _lock) --------------------

    def demote(self, pid: int, pages: List, rows: int):
        """Revocation demoted partition ``pid``: drop it from the
        resident set and park its build pages."""
        with self._lock:
            self.resident = self.resident - {pid}
            self.spilled_build.setdefault(pid, []).extend(pages)
            self.spilled_build_rows += rows
            self.demotions += 1

    def route_build_spill(self, pid: int, page, rows: int):
        """A build page arriving for an already cold partition parks
        directly (page at a time — no device residency)."""
        with self._lock:
            self.resident = self.resident - {pid}
            self.spilled_build.setdefault(pid, []).append(page)
            self.spilled_build_rows += rows

    def add_probe_spill(self, pid: int, page):
        with self._lock:
            self.spilled_probe.setdefault(pid, []).append(page)

    def count_build_rows(self, rows: int):
        with self._lock:
            self.total_build_rows += rows

    def note_depth(self, depth: int):
        with self._lock:
            self.repartitions += 1
            self.max_depth_seen = max(self.max_depth_seen, depth)

    def spill_fraction(self) -> float:
        with self._lock:
            return self.spilled_build_rows / max(1, self.total_build_rows)

    # -- partition hash --------------------------------------------------

    def _value_hash_lut(self, d) -> np.ndarray:
        """code -> stable-within-process value hash for one pool, so both
        sides partition pooled keys by VALUE (their code spaces differ
        until the probe-side remap, which happens later)."""
        key = (id(d), len(d) if d else 0)
        hit = self._hash_luts.get(key)
        if hit is not None:
            return hit[0]
        if d is None or len(d) == 0:
            lut = np.zeros(1, dtype=np.uint64)
        else:
            lut = np.fromiter(
                (hash(v) & 0xFFFFFFFFFFFFFFFF for v in d.values),
                dtype=np.uint64, count=len(d))
        self._hash_luts[key] = (lut, d)
        return lut

    def partition_ids(self, cols: List[np.ndarray],
                      nulls: List[np.ndarray], types_, dicts,
                      salt: Optional[int] = None,
                      fanout: Optional[int] = None) -> np.ndarray:
        """Per-row partition id from the raw key VALUES (host arrays).

        Value-based — not code- or storage-based — so build and probe
        rows with join-equal keys land in the same partition even when
        their dictionaries or integer widths differ. Null keys hash as
        key 0; callers route them resident (they match nothing, and
        LEFT/ANTI must emit them exactly once). Ids lie in
        ``[0, fanout)`` for every lane, dead lanes included."""
        salt = self.salt if salt is None else salt
        fanout = self.fanout if fanout is None else fanout
        acc = np.zeros(cols[0].shape[0], dtype=np.uint64)
        for c, nl, t, d in zip(cols, nulls, types_, dicts):
            if t.is_pooled:
                lut = self._value_hash_lut(d)
                codes = np.clip(c.astype(np.int64), 0, len(lut) - 1)
                k = lut[codes]
            elif np.issubdtype(c.dtype, np.floating):
                f = c.astype(np.float64)
                f = np.where(f == 0.0, 0.0, f)   # -0.0 joins +0.0
                k = f.view(np.uint64)
                k = np.where(np.isnan(f),
                             np.uint64(0x7FF8000000000000), k)
            elif c.dtype == bool:
                k = c.astype(np.uint64)
            else:
                k = c.astype(np.int64).view(np.uint64)
            k = np.where(nl, np.uint64(0), k)
            acc = (acc * np.uint64(31)) ^ _splitmix64_np(
                k + np.uint64(0x9E3779B97F4A7C15))
        pid = _splitmix64_np(acc ^ np.uint64(salt)) \
            & np.uint64(fanout - 1)
        return pid.astype(np.int64)


def _host_spilled(types_, cols: List[np.ndarray], nulls: List[np.ndarray],
                  k: int, dicts, device):
    """An in-RAM SpilledPage over k extracted host rows (pow2-padded),
    chargeable to the ledger and demotable to the disk tier like any
    other parked page; it reloads onto ``device``."""
    from ..exec.memory import SpilledPage, np_pad

    cap = padded_size(max(int(k), 1))
    v = np.zeros(cap, dtype=bool)
    v[:k] = True
    return SpilledPage.from_host(
        types_, [np_pad(c, cap) for c in cols],
        [np_pad(n, cap, fill=True) for n in nulls], v, dicts, device)


def _host_arrays(page: DevicePage):
    """(cols, nulls, valid) of a device page as host numpy arrays."""
    return ([to_host(c, "join.spill") for c in page.cols],
            [to_host(n, "join.spill") for n in page.nulls],
            to_host(page.valid, "join.spill"))


def _upload_parked(pages: List, nch: int):
    """(cols, nulls, valid, dicts) of parked pages: host concat
    (disk-parked pages stream back through ``serde.read_spill_file`` via
    host()), padded and uploaded once onto the pages' device."""
    from ..exec.memory import np_pad

    hosts = [p.host() for p in pages]
    device = hosts[0].device
    cap = padded_size(sum(p.capacity for p in hosts))

    def up(arrays, fill=False):
        return torch.from_numpy(np_pad(np.concatenate(arrays), cap,
                                       fill=fill)).to(device)

    cols = [up([p.cols[i] for p in hosts]) for i in range(nch)]
    nulls = [up([p.nulls[i] for p in hosts], fill=True)
             for i in range(nch)]
    valid = up([p.valid for p in hosts])
    return cols, nulls, valid, unify_dictionaries(hosts, nch)


def _build_side_from_spilled(input_types, key_channels,
                             pages: List) -> BuildSide:
    """One cold partition's sorted index from its parked pages: one
    upload, then the shared assembly tail."""
    return _assemble_build_side(input_types, key_channels,
                                *_upload_parked(pages, len(input_types)))


class HashBuilderOperator(Operator):
    """Accumulates the build side and publishes a sorted index."""

    def __init__(self, input_types: Sequence[T.Type],
                 key_channels: Sequence[int], bridge: JoinBridge,
                 device, memory_context=None,
                 dynamic_filters: Sequence = (),
                 hybrid: Optional[dict] = None):
        self.input_types = list(input_types)
        self.key_channels = list(key_channels)
        self.bridge = bridge
        self.device = device
        # [(channel, DynamicFilter)] to fill at publish (reference:
        # DynamicFilterSourceOperator collecting build values)
        self.dynamic_filters = list(dynamic_filters)
        #: hybrid-hash-join options from the planner: {"fanout": session
        #: override (0 = auto), "max_depth": recursion bound, "hint": the
        #: HBO spill record of this node's last run (sizes fan-out with
        #: source=hbo)}, or None when hybrid degradation is off (FULL
        #: OUTER, or disabled by session property)
        self._hybrid = hybrid
        self._hstate: Optional[HybridJoinState] = None
        #: parallel to _pages in partitioned mode: the partition id of
        #: each device page, or -1 for a not-yet-split mixed page
        self._page_pid: List[int] = []
        self._pages: List = []  # DevicePage | SpilledPage
        self._done = False
        self._ctx = memory_context
        if self._ctx is not None:
            self._ctx.set_revoke_callback(self._revoke)

    def add_input(self, page: DevicePage):
        if self._ctx is None:
            self._pages.append(page)
            return
        if self._hstate is not None:
            self._add_input_partitioned(page)
            return
        from ..exec.memory import reserve_and_append

        reserve_and_append(self._ctx, self._pages, page)
        with self._ctx.lock:
            if self._hstate is not None:
                # the reserve above fired the first revocation:
                # partitioned mode began mid-append, so _init_partitions
                # counted only the pages before this one — pair and
                # count this page now
                while len(self._page_pid) < len(self._pages):
                    self._page_pid.append(-1)
                self._hstate.count_build_rows(page.count())

    def _revoke(self) -> int:
        """Memory revocation (runs under the context lock, on whatever
        thread needed the bytes). Hybrid path: enter partitioned mode on
        the first call and demote the largest resident partition — the
        resident set shrinks in place and the query keeps building.
        Otherwise (hybrid off, FULL OUTER): park everything in host RAM,
        with the disk tier below it when the ledger overflows."""
        from ..exec.memory import spill_pages

        if self._hybrid is None:
            return spill_pages(self._pages, self._ctx.pool,
                               self._ctx.lock)
        if self._hstate is None:
            self._init_partitions()
        return self._demote_next()

    # -- hybrid: partitioned build --------------------------------------

    def _init_partitions(self):
        """First revocation: decide the fan-out and enter partitioned
        mode. The session's ``hybrid_join_fanout`` wins; then the HBO
        spill hint of this node's previous run (source=hbo — the second
        run sizes its fan-out right); otherwise the fan-out is sized so
        one partition fits in ~1/4 of the pool, with the bytes seen so
        far doubled as the guess of the whole build, rounded through the
        process-wide ``KERNEL_SIZING`` history as the JAX engine rounds
        it."""
        from ..exec.memory import device_page_bytes
        from .kernel_sizing import KERNEL_SIZING

        opts = self._hybrid or {}
        hint = opts.get("hint") or {}
        if opts.get("fanout"):
            fanout, source = int(opts["fanout"]), "session"
        elif hint.get("fanout"):
            # size from the previous run's observed spill: a build that
            # spilled a meaningful fraction gets a finer fan-out so each
            # partition fits without recursion; one that barely spilled
            # keeps its grain
            fanout, source = int(hint["fanout"]), "hbo"
            frac = float(hint.get("fraction") or 0.0)
            if frac > 0.5:
                fanout *= 4
            elif frac > 0.125:
                fanout *= 2
            if int(hint.get("repartitions") or 0) > 0:
                fanout *= 2
        else:
            pool = self._ctx.pool
            dev_bytes = sum(device_page_bytes(p) for p in self._pages
                            if isinstance(p, DevicePage))
            per_part = max(1, pool.max_bytes // 4)
            need = max(4, -(-dev_bytes * 2 // per_part))
            fanout = KERNEL_SIZING.suggest(
                ("hybrid_join_fanout", len(self.key_channels)),
                need, minimum=4)
            source = "local"
        fanout = padded_size(max(2, min(int(fanout), 256)), minimum=2)
        self._hstate = HybridJoinState(
            fanout, max_depth=int(opts.get("max_depth", 3)),
            source=source)
        # the probe's deferred per-partition passes charge their
        # transients (and parked probe pages) to the build's context,
        # which stays open for the probe's lifetime via bridge.release
        self._hstate.ctx = self._ctx
        self.bridge.hybrid = self._hstate
        self._page_pid = [-1] * len(self._pages)
        self._hstate.count_build_rows(sum(
            p.count() if isinstance(p, DevicePage)
            else int(np.count_nonzero(p.host().valid))
            for p in self._pages))

    def _key_cols_host(self, cols, nulls, dicts):
        """(cols, nulls, types, dicts) of the key channels from host
        arrays, feeding HybridJoinState.partition_ids."""
        kc = self.key_channels
        return ([cols[c] for c in kc], [nulls[c] for c in kc],
                [self.input_types[c] for c in kc], [dicts[c] for c in kc])

    def _split_mixed(self):
        """Split every mixed (-1) page into per-partition pages: rows of
        resident partitions repack into one device page per partition
        present; rows of cold partitions park as SpilledPages (caller
        holds the context lock)."""
        from ..exec.memory import SpilledPage

        hs = self._hstate
        pages, pids = self._pages, self._page_pid
        if len(pids) < len(pages):
            # a page appended by a reserve whose own revocation rewrote
            # these lists has no pid yet: it is mixed by construction
            pids = pids + [-1] * (len(pages) - len(pids))
        out_pages: List = []
        out_pids: List[int] = []
        buckets: Dict[int, List[tuple]] = {}
        for pg, pid in zip(pages, pids):
            if pid != -1 or isinstance(pg, SpilledPage):
                out_pages.append(pg)
                out_pids.append(pid)
                continue
            cols, nulls, valid = _host_arrays(pg)
            rowpid = hs.partition_ids(*self._key_cols_host(
                cols, nulls, pg.dictionaries))
            for pid_ in np.unique(rowpid[valid]):
                pid_ = int(pid_)
                keep = np.nonzero(valid & (rowpid == pid_))[0]
                buckets.setdefault(pid_, []).append((
                    [c[keep] for c in cols], [n[keep] for n in nulls],
                    len(keep), pg.dictionaries, pg.types))
        for pid_, parts in sorted(buckets.items()):
            cols = [np.concatenate([p[0][i] for p in parts])
                    for i in range(len(self.input_types))]
            nulls = [np.concatenate([p[1][i] for p in parts])
                     for i in range(len(self.input_types))]
            k = sum(p[2] for p in parts)
            sp = _host_spilled(parts[0][4], cols, nulls, k, parts[0][3],
                               self.device)
            if pid_ in hs.resident:
                out_pages.append(sp.to_device())
                out_pids.append(pid_)
            else:
                self._park_spilled(pid_, sp, k)
        self._pages[:] = out_pages
        self._page_pid[:] = out_pids

    def _park_spilled(self, pid: int, sp, rows: int):
        """Charge one cold-partition build page to the host ledger and
        demote through the disk tier when the ledger overflows (caller
        holds the context lock)."""
        hs = self._hstate
        pool = self._ctx.pool
        hs.route_build_spill(pid, sp, rows)
        plist = hs.spilled_build[pid]
        pool.host_ledger.charge(sp)
        pool.host_ledger.track(plist, self._ctx.lock, pool)
        pool.maybe_demote(plist)

    def _demote_next(self) -> int:
        """Demote resident partitions largest-first until device bytes
        actually came free; returns the bytes freed (the partial
        revocation contract: one demotion per round, repeated by
        revoke_up_to while more is needed). Caller holds the context
        lock."""
        from ..exec.memory import SpilledPage, device_page_bytes

        hs = self._hstate

        def device_bytes():
            return sum(device_page_bytes(p) for p in self._pages
                       if isinstance(p, DevicePage))

        before = device_bytes()
        self._split_mixed()
        pool = self._ctx.pool
        freed_any = False
        while True:
            sizes: Dict[int, int] = {}
            for pg, pid in zip(self._pages, self._page_pid):
                if pid >= 0 and pid in hs.resident \
                        and isinstance(pg, DevicePage):
                    sizes[pid] = sizes.get(pid, 0) + device_page_bytes(pg)
            if (before - device_bytes() > 0 and freed_any) or not sizes:
                break
            victim = max(sizes, key=lambda p: sizes[p])
            vpages, vrows = [], 0
            keep_pages, keep_pids = [], []
            for pg, pid in zip(self._pages, self._page_pid):
                if pid == victim and isinstance(pg, DevicePage):
                    sp = SpilledPage(pg)
                    vrows += int(np.count_nonzero(sp.valid))
                    vpages.append(sp)
                else:
                    keep_pages.append(pg)
                    keep_pids.append(pid)
            self._pages[:] = keep_pages
            self._page_pid[:] = keep_pids
            hs.demote(victim, vpages, vrows)
            for sp in vpages:
                pool.host_ledger.charge(sp)
            pool.host_ledger.track(hs.spilled_build[victim],
                                   self._ctx.lock, pool)
            pool.maybe_demote(hs.spilled_build[victim])
            pool.record_partition_spill(sizes[victim], 1)
            freed_any = True
        return max(before - device_bytes(), 0)

    def _add_input_partitioned(self, page: DevicePage):
        """Partitioned-mode input routing: resident-partition rows stay
        on the device (one compacted page), cold-partition rows park
        beside their partition — page at a time, never resident."""
        from ..exec.memory import device_page_bytes

        hs = self._hstate
        cols, nulls, valid = _host_arrays(page)
        rowpid = hs.partition_ids(*self._key_cols_host(
            cols, nulls, page.dictionaries))
        hs.count_build_rows(int(np.count_nonzero(valid)))
        with hs._lock:
            resident = hs.resident
        cold_pids = [int(p) for p in np.unique(rowpid[valid])
                     if int(p) not in resident]
        if not cold_pids:
            self._add_input_resident(page)
            return
        cold_rows = np.isin(rowpid, np.asarray(cold_pids))
        res_valid = valid & ~cold_rows
        dev = None
        if res_valid.any():
            dev = _host_spilled(
                page.types, [c[res_valid] for c in cols],
                [n[res_valid] for n in nulls],
                int(np.count_nonzero(res_valid)), page.dictionaries,
                self.device).to_device()
            self._ctx.reserve(device_page_bytes(dev))
        with self._ctx.lock:
            if dev is not None:
                self._pages.append(dev)
                self._page_pid.append(-1)
            for pid_ in cold_pids:
                keep = np.nonzero(valid & (rowpid == pid_))[0]
                sp = _host_spilled(
                    page.types, [c[keep] for c in cols],
                    [n[keep] for n in nulls], len(keep),
                    page.dictionaries, self.device)
                self._park_spilled(pid_, sp, len(keep))

    def _add_input_resident(self, page: DevicePage):
        from ..exec.memory import reserve_and_append

        reserve_and_append(self._ctx, self._pages, page)
        with self._ctx.lock:
            # the reserve above may have revoked: _split_mixed rewrites
            # both lists, so resync (unpaired pages are trailing
            # appends, mixed by construction)
            while len(self._page_pid) < len(self._pages):
                self._page_pid.append(-1)

    def metrics(self) -> dict:
        hs = self._hstate
        if hs is None:
            return {}
        with hs._lock:
            return {"hybrid_spill": {
                "fanout": hs.fanout,
                "source": hs.source,
                "fraction": round(hs.spilled_build_rows
                                  / max(1, hs.total_build_rows), 4),
                "partitions_spilled": len(hs.spilled_build),
                "demotions": hs.demotions,
                "repartitions": hs.repartitions,
                "max_depth": hs.max_depth_seen,
            }}

    def get_output(self):
        if self._finishing and not self._done:
            self._publish()
            self._done = True
        return None

    def _reserve_publish_hybrid(self):
        """Hybrid publish: when the index and its concat/sort transients
        do not fit the pool, shrink the resident set instead of parking
        the whole build — demoted partitions move to the probe's
        deferred per-partition passes, so the published index covers
        exactly what fits."""
        from ..exec.memory import (MemoryExceededError, SpilledPage,
                                   device_page_bytes)

        with self._ctx.lock:
            self._ctx.set_revoke_callback(None)
            if self._hstate is not None and self._hstate.spilled_build:
                # straggler mixed pages: a page appended by the very
                # reserve call whose revocation demoted a partition
                # still carries that partition's rows under pid -1;
                # route them now — a cold row in the resident index
                # would never be probed
                self._split_mixed()

        def demote_once() -> int:
            with self._ctx.lock:
                if self._hstate is None:
                    self._init_partitions()
                freed = self._demote_next()
            if freed > 0:
                self._ctx.pool.record_spill(freed)
                self._ctx.free(freed)
            return freed

        budget = max(1, self._ctx.pool.max_bytes // 4)
        while True:
            total = sum(device_page_bytes(p) for p in self._pages)
            uploads = sum(device_page_bytes(p) for p in self._pages
                          if isinstance(p, SpilledPage))
            if total > budget and demote_once() > 0:
                # the retained index must leave headroom for the probe
                # and everything downstream — the same 1/4-pool target
                # the fan-out sizing uses
                continue
            try:
                self._ctx.reserve(uploads + 2 * total, revocable=False)
                return
            except MemoryExceededError:
                if demote_once() <= 0:
                    raise

    def _publish(self):
        from ..exec.memory import SpilledPage

        if self._ctx is not None and self._hybrid is not None:
            self._reserve_publish_hybrid()
        elif self._ctx is not None:
            # publish owns the state; the index it creates is retained
            # (non-revocable) for the probe's lifetime
            from ..exec.memory import prepare_finish

            total, uploads = prepare_finish(self._ctx, self._pages)
            all_spilled = bool(self._pages) and all(
                isinstance(p, SpilledPage) for p in self._pages)
            # transient: concat + sorted copy, plus per-page re-uploads
            # on the mixed path (the all-spilled path concatenates in
            # host RAM and uploads once)
            self._ctx.reserve(2 * total if all_spilled
                              else uploads + 2 * total, revocable=False)
        nch = len(self.input_types)
        if self._pages and all(isinstance(p, SpilledPage)
                               for p in self._pages):
            # pressure path: concatenate in host RAM, upload once
            cols, nulls, valid, dicts = _upload_parked(self._pages, nch)
            cap = int(valid.shape[0])
        elif self._pages:
            pages = [p.to_device() if isinstance(p, SpilledPage) else p
                     for p in self._pages]
            cap = padded_size(sum(p.capacity for p in pages))
            cols = [_pad(torch.cat([p.cols[i] for p in pages]), cap)
                    for i in range(nch)]
            nulls = [_pad(torch.cat([p.nulls[i] for p in pages]), cap,
                          fill=True) for i in range(nch)]
            valid = _pad(torch.cat([p.valid for p in pages]), cap)
            dicts = unify_dictionaries(pages, nch)
        else:
            cap = 16
            cols = [torch.zeros(cap, dtype=storage_dtype(t),
                                device=self.device)
                    for t in self.input_types]
            nulls = [torch.ones(cap, dtype=torch.bool, device=self.device)
                     for _ in self.input_types]
            valid = torch.zeros(cap, dtype=torch.bool, device=self.device)
            dicts = [Dictionary() if t.is_pooled else None
                     for t in self.input_types]
        self._collect_dynamic_filters(cols, nulls, valid)
        self.bridge.set_build(_assemble_build_side(
            self.input_types, self.key_channels, cols, nulls, valid, dicts))
        self._pages = []  # release the input pages; only the index remains
        if self._ctx is not None:
            # retain only the published index: sorted key (8B) + usable
            # + valid (1B each) + per-channel data/null lanes
            retained = cap * (10 + sum(c.element_size() + 1 for c in cols))
            self._ctx.close()
            self._ctx.reserve(retained, revocable=False)
            self.bridge.release = self._ctx.close

    def _collect_dynamic_filters(self, cols, nulls, valid):
        """Fill the join's dynamic filters over ALL build rows — the
        resident arrays plus every cold-partition page: a filter built
        from the resident set alone would wrongly prune probe rows that
        match only spilled build rows."""
        if not self.dynamic_filters:
            return
        hs = self._hstate
        spilled = []
        if hs is not None:
            with hs._lock:
                spilled = [p for ps in hs.spilled_build.values()
                           for p in ps]
        if not spilled:
            for ch, df in self.dynamic_filters:
                df.collect(cols[ch], nulls[ch], valid)
            return
        # host concat, as the parked pages already are there: uploading
        # them would take device bytes no reservation covers
        hosts = [p.host() for p in spilled]

        def cat(resident, parked):
            return torch.from_numpy(np.concatenate(
                [to_host(resident, "join.spill")] + parked))

        sv = cat(valid, [h.valid for h in hosts])
        for ch, df in self.dynamic_filters:
            df.collect(cat(cols[ch], [h.cols[ch] for h in hosts]),
                       cat(nulls[ch], [h.nulls[ch] for h in hosts]), sv,
                       device=cols[ch].device)

    def is_finished(self) -> bool:
        return self._done


class LookupJoinOperator(Operator):
    """Probe side. join_type: inner | left | full | semi | anti.

    Output layout: all probe channels, then (inner/left/full) all build
    channels — build channels NULL on unmatched left rows. semi/anti emit
    probe channels only. FULL OUTER additionally OR-accumulates a
    matched flag per (sorted) build row across all probe pages and, once
    the probe side finishes, emits one final page of unmatched build rows
    with NULL probe channels (reference: LookupJoinOperator's
    OuterLookupSource / buildOuter position iterator)."""

    #: bound on candidate-expansion lanes per expansion: a probe page
    #: whose total match count pads beyond this is sliced into contiguous
    #: row chunks (greedy, from the per-row counts pulled to host ONCE),
    #: so skewed or high-fanout joins never materialize all pairs in one
    #: buffer (session ``join_max_expand_lanes``)
    max_lanes = 1 << 20

    #: probe pages whose guessed-capacity outputs are enqueued on the
    #: device but not yet overflow-checked. The oldest is checked — ONE
    #: scalar read, computed pipeline_depth-1 pages ago — only when the
    #: pipeline is full or upstream stalls, so the host never blocks on
    #: work it just enqueued
    pipeline_depth = 4

    def __init__(self, probe_types: Sequence[T.Type],
                 probe_key_channels: Sequence[int], bridge: JoinBridge,
                 join_type: str = "inner", filter_fn=None,
                 max_lanes: Optional[int] = None,
                 memory_limited: bool = False):
        assert join_type in ("inner", "left", "full", "semi", "anti")
        self.probe_types = list(probe_types)
        self.probe_keys = list(probe_key_channels)
        self.bridge = bridge
        self.join_type = join_type
        self.filter_fn = filter_fn  # optional post-join residual filter
        if max_lanes is not None:
            self.max_lanes = max_lanes
        if memory_limited:
            # pool-governed query: the pending buffers are invisible to
            # the pool's reserve/revoke machinery, so keep one page in
            # flight
            self.pipeline_depth = 1
        self._pending: List[dict] = []   # awaiting overflow check
        self._ready: List[DevicePage] = []
        # EWMA lanes-per-probe-row for the capacity guess. Starts below
        # 1 so the first guess lands in the page's own pow2 bucket (N:1
        # joins then never overflow and never double the page); a
        # fan-out join overflows once, the ratio learns, later pages
        # guess right. pow2 padding gives the headroom.
        self._ratio = 0.75
        self._added_since_get = False
        self._done = False
        #: deferred cold-partition work queue (hybrid join): None until
        #: the probe input finished, then [{"depth", "build", "probe"}]
        #: processed one partition at a time
        self._deferred: Optional[List[dict]] = None
        # FULL OUTER state: per-sorted-build-row matched flag (cap+1
        # lanes — the last is the dead-lane sink) + the dictionary pools
        # of the last probe page (the unmatched-build page's probe
        # channels are all-NULL, but string channels still need a pool)
        self._build_matched = None
        self._probe_dicts = None
        self._emitted_unmatched = False
        # probe-dict -> build-dict code remap LUTs for pooled join keys
        self._remap_cache: dict = {}

    @property
    def output_types(self) -> List[T.Type]:
        if self.join_type in ("semi", "anti"):
            return list(self.probe_types)
        return list(self.probe_types) + list(self.bridge.build.types)

    def needs_input(self) -> bool:
        return (not self._ready
                and len(self._pending) < self.pipeline_depth
                and not self._finishing)

    def add_input(self, page: DevicePage):
        """Enqueue the whole probe chain for this page — counts,
        guessed-capacity expansion, finalize — WITHOUT reading anything
        back; the overflow check happens in get_output once the
        pipeline is deep enough to have hidden this page's latency."""
        b = self.bridge.build
        assert b is not None, "probe started before build finished"
        hs = self.bridge.hybrid
        if hs is not None and hs.spilled_build:
            # hybrid join: rows of cold build partitions park beside
            # their partition for the deferred unspill -> probe pass;
            # null-key rows always stay resident (they match nothing and
            # LEFT/ANTI must emit them exactly once)
            page = self._route_probe(page, hs)
            if page is None:
                self._added_since_get = True
                return
        kc = self.probe_keys
        pkey_cols, key_types = self._probe_key_cols(page, b)
        pkey, panynull = _key_u64(pkey_cols, [page.nulls[c] for c in kc],
                                  key_types, b.key_mode)
        pusable = page.valid & ~panynull
        direct = self._probe_direct(page, b, pkey, pusable)
        if direct is not None:
            self._ready.append(direct)
            self._added_since_get = True
            return
        lo, count = self._probe_lo_count(b, pkey, pusable)
        rows = page.capacity
        cap = padded_size(max(16, int(rows * self._ratio * 1.1)))
        while cap > self.max_lanes and cap > 16:
            cap >>= 1  # budget is checked POST-padding, like every path
        out, keep, bidx = self._make_out(b, page, pkey_cols, pusable, lo,
                                         count, cap)
        self._pending.append({
            "b": b, "page": page, "pkey_cols": pkey_cols,
            "pusable": pusable, "lo": lo, "count": count, "rows": rows,
            "cap": cap, "total": count.sum(), "out": out, "keep": keep,
            "bidx": bidx})
        self._added_since_get = True

    def _probe_direct(self, page: DevicePage, b: BuildSide, pkey,
                      pusable) -> Optional[DevicePage]:
        """Strategy seam: a complete output page computed straight from
        the probe keys (no candidate expansion), or None to run the
        lo/count path below. The matmul strategy
        (``ops/matmul_join.py``) answers semi/anti membership here."""
        return None

    def _probe_lo_count(self, b: BuildSide, pkey, pusable):
        """Strategy seam: each probe row's candidate range (lo, count)
        against the sorted build index — here two binary searches; the
        matmul strategy overrides with the blocked one-hot matmul."""
        return _probe_counts(b.key_sorted, b.usable_sorted, pkey, pusable)

    def get_output(self):
        if self._ready:
            return self._ready.pop(0)
        if self._pending and (self._finishing
                              or len(self._pending) >= self.pipeline_depth
                              or not self._added_since_get):
            self._verify_oldest()
            self._added_since_get = False
            if self._ready:
                return self._ready.pop(0)
        self._added_since_get = False
        if self._finishing and not self._pending:
            hs = self.bridge.hybrid
            if hs is not None and self._deferred is None:
                self._init_deferred(hs)
            while self._deferred and not self._ready:
                self._advance_deferred(hs)
            if self._ready:
                return self._ready.pop(0)
            if self.join_type == "full" and not self._emitted_unmatched:
                self._emitted_unmatched = True
                return self._unmatched_build_page()
            if not self._done:
                self.bridge.destroy()
            self._done = True
        return None

    def _verify_oldest(self):
        """Overflow-check the oldest pending page: the deferred scalar
        read. Fits the guess (common) -> emit as-is; overflowed (rare)
        -> re-expand at the now-known exact size, chunked under the
        lane budget."""
        rec = self._pending.pop(0)
        tot = int(host_scalar(rec["total"], "join.expand_total"))
        self._ratio = 0.75 * self._ratio \
            + 0.25 * (tot / max(rec["rows"], 1))
        if tot <= rec["cap"]:
            self._mark_full(rec["keep"], rec["bidx"],
                            rec["page"].dictionaries)
            self._ready.append(rec["out"])
            return
        for unit in self._chunk_units(rec, tot):
            out, keep, bidx = self._make_out(rec["b"], *unit)
            self._mark_full(keep, bidx, rec["page"].dictionaries)
            self._ready.append(out)

    def _chunk_units(self, rec: dict, total: int) -> List:
        """(page, pkey_cols, pusable, lo, count, lane_cap) units whose
        expansions fit the lane budget; greedy contiguous row chunks
        from the per-row counts (host copy only on this over-budget
        path). A single row exceeding the budget still becomes its own
        unit: its lane capacity grows to its fan-out.

        The JAX engine's greedy row loop, cut by binary searches over
        the counts' prefix sums: a row joins the unit while the unit's
        padded lane count stays within the budget, i.e. while its count
        stays within the largest power of two not above it — the same
        units, one search per unit instead of Python work per row (a
        device exchange hands a consumer a whole slab of millions of
        lanes)."""
        page, pkey_cols, pusable = rec["page"], rec["pkey_cols"], \
            rec["pusable"]
        lo, count = rec["lo"], rec["count"]
        if padded_size(max(total, 16)) <= self.max_lanes:
            return [(page, pkey_cols, pusable, lo, count,
                     padded_size(max(total, 16)))]
        counts = to_host(count, "join.expand_chunks").astype(np.int64)
        # padded_size(max(x, 16)) <= max_lanes  <=>  x <= limit
        limit = 1 << (self.max_lanes.bit_length() - 1) \
            if self.max_lanes >= 16 else -1
        prefix = np.concatenate([[0], np.cumsum(counts)])
        units: List = []
        n = counts.shape[0]
        i = 0
        while i < n:
            j = int(np.searchsorted(prefix, prefix[i] + limit,
                                    side="right")) - 1
            j = min(max(j, i + 1), n)
            run = int(prefix[j] - prefix[i])
            cap = padded_size(j - i)
            sl = slice(i, j)
            sub = DevicePage(page.types,
                             [_pad(c[sl], cap) for c in page.cols],
                             [_pad(x[sl], cap) for x in page.nulls],
                             _pad(page.valid[sl], cap), page.dictionaries)
            units.append((sub, [_pad(k[sl], cap) for k in pkey_cols],
                          _pad(pusable[sl], cap), _pad(lo[sl], cap),
                          _pad(count[sl], cap), padded_size(max(run, 16))))
            i = j
        return units

    def _route_probe(self, page: DevicePage,
                     hs: HybridJoinState) -> Optional[DevicePage]:
        """Split one probe page by build partition: cold-partition rows
        park beside their build partition, the rest probe the resident
        index now (a valid-mask restriction — each probe row joins in
        exactly one pass)."""
        kc = self.probe_keys
        cols, nulls, valid = _host_arrays(page)
        knulls = [nulls[c] for c in kc]
        anynull = np.zeros_like(valid)
        for nl in knulls:
            anynull |= nl
        rowpid = hs.partition_ids(
            [cols[c] for c in kc], knulls,
            [self.probe_types[c] for c in kc],
            [page.dictionaries[c] for c in kc])
        with hs._lock:
            cold_pids = np.fromiter(hs.spilled_build, dtype=np.int64)
        cold = valid & ~anynull & np.isin(rowpid, cold_pids)
        if not cold.any():
            return page
        ctx = hs.ctx
        for pid_ in np.unique(rowpid[cold]):
            pid_ = int(pid_)
            keep = np.nonzero(cold & (rowpid == pid_))[0]
            sp = _host_spilled(page.types, [c[keep] for c in cols],
                               [n[keep] for n in nulls], len(keep),
                               page.dictionaries, page.device)
            hs.add_probe_spill(pid_, sp)
            if ctx is not None:
                pool = ctx.pool
                pool.host_ledger.charge(sp)
                with ctx.lock:
                    pool.host_ledger.track(hs.spilled_probe[pid_],
                                           ctx.lock, pool)
                    pool.maybe_demote(hs.spilled_probe[pid_])
        res_valid = valid & ~cold
        if not res_valid.any():
            return None
        return DevicePage(page.types, page.cols, page.nulls,
                          torch.from_numpy(res_valid).to(page.device),
                          page.dictionaries)

    # -- hybrid: deferred cold-partition passes --------------------------

    def _init_deferred(self, hs: HybridJoinState):
        """Snapshot the cold-partition work queue once the probe input
        finished (the resident set is frozen after the build's publish,
        so the snapshot is race-free)."""
        with hs._lock:
            pids = sorted(set(hs.spilled_build) | set(hs.spilled_probe))
            self._deferred = [
                {"depth": hs.depth,
                 "build": list(hs.spilled_build.get(pid, ())),
                 "probe": list(hs.spilled_probe.get(pid, ()))}
                for pid in pids]

    def _advance_deferred(self, hs: HybridJoinState):
        """Unspill one cold partition and probe it: build a
        per-partition sorted index from the parked build pages, then run
        every parked probe page against it. A partition whose index would
        not fit the pool repartitions with a depth-salted hash instead
        (children joined depth-first, recursion bounded by
        hybrid_join_max_depth)."""
        from ..exec.memory import MemoryExceededError, device_page_bytes

        entry = self._deferred.pop(0)
        if not entry["probe"]:
            # probe-driven join types only (FULL OUTER never goes
            # hybrid): no parked probe rows means no output
            return
        ctx = hs.ctx
        est = sum(device_page_bytes(p) for p in entry["build"])
        # index + sort transients ~4x the partition bytes; an oversized
        # partition repartitions rather than thrash the pool
        need = 4 * max(est, 1)
        if ctx is not None and entry["depth"] < hs.max_depth \
                and need > ctx.pool.max_bytes:
            self._split_deferred(hs, entry)
            return
        if ctx is not None:
            try:
                ctx.reserve(need, revocable=False)
            except MemoryExceededError:
                if entry["depth"] < hs.max_depth:
                    self._split_deferred(hs, entry)
                    return
                raise
        try:
            b = self.bridge.build
            bp = _build_side_from_spilled(
                b.types, b.key_channels, entry["build"]) \
                if entry["build"] else self._empty_build_side(b)
            for sp in entry["probe"]:
                self._probe_spilled_page(bp, sp)
        finally:
            if ctx is not None:
                ctx.free(need, revocable=False)

    def _split_deferred(self, hs: HybridJoinState, entry: dict):
        """Recursive repartition: re-hash the partition's build AND probe
        pages at depth+1 with a fresh salt; children go to the front of
        the queue (depth-first keeps the parked-page peak bounded by one
        partition's lineage)."""
        depth = entry["depth"] + 1
        hs.note_depth(depth)
        salt = _salt_for_depth(depth)
        sub_fanout = 4  # quarters per level: depth 3 = 64x the fan-out
        b = self.bridge.build
        bsplit = self._split_spilled(hs, entry["build"], b.types,
                                     b.key_channels, salt, sub_fanout)
        psplit = self._split_spilled(hs, entry["probe"],
                                     self.probe_types, self.probe_keys,
                                     salt, sub_fanout)
        for q in sorted(set(bsplit) | set(psplit), reverse=True):
            self._deferred.insert(0, {
                "depth": depth,
                "build": bsplit.get(q, []),
                "probe": psplit.get(q, [])})

    def _split_spilled(self, hs: HybridJoinState, pages: List, types_,
                       key_channels, salt: int, fanout: int) -> dict:
        """Partition parked pages by a re-salted key hash (host work;
        disk-parked pages stream back through host())."""
        buckets: dict = {}
        for p in pages:
            h = p.host()
            rowpid = hs.partition_ids(
                [h.cols[c] for c in key_channels],
                [h.nulls[c] for c in key_channels],
                [types_[c] for c in key_channels],
                [h.dictionaries[c] for c in key_channels],
                salt=salt, fanout=fanout)
            for q in np.unique(rowpid[h.valid]):
                q = int(q)
                keep = np.nonzero(h.valid & (rowpid == q))[0]
                buckets.setdefault(q, []).append(_host_spilled(
                    h.types, [c[keep] for c in h.cols],
                    [n[keep] for n in h.nulls], len(keep),
                    h.dictionaries, h.device))
        return buckets

    def _empty_build_side(self, b: BuildSide) -> BuildSide:
        """A zero-row index (recursive splits can leave a probe-only
        sub-bucket; LEFT/ANTI must still emit its rows unmatched)."""
        cap = 16
        dev = b.key_sorted.device
        cols = [torch.zeros(cap, dtype=storage_dtype(t), device=dev)
                for t in b.types]
        nulls = [torch.ones(cap, dtype=torch.bool, device=dev)
                 for _ in b.types]
        valid = torch.zeros(cap, dtype=torch.bool, device=dev)
        dicts = [Dictionary() if t.is_pooled else None for t in b.types]
        return _assemble_build_side(b.types, b.key_channels, cols, nulls,
                                    valid, dicts)

    def _probe_spilled_page(self, b: BuildSide, sp):
        """One parked probe page against one per-partition index,
        straight through the sorted-index path. The strategy seams
        (_probe_direct/_probe_lo_count) are bypassed on purpose: the
        matmul strategy caches one table from the resident build side
        and must not see per-partition indexes."""
        page = sp.to_device()
        kc = self.probe_keys
        pkey_cols, key_types = self._probe_key_cols(page, b)
        pkey, panynull = _key_u64(pkey_cols, [page.nulls[c] for c in kc],
                                  key_types, b.key_mode)
        pusable = page.valid & ~panynull
        lo, count = _probe_counts(b.key_sorted, b.usable_sorted, pkey,
                                  pusable)
        rec = {"b": b, "page": page, "pkey_cols": pkey_cols,
               "pusable": pusable, "lo": lo, "count": count}
        for unit in self._chunk_units(
                rec, int(host_scalar(count.sum(), "join.expand_total"))):
            out, _keep, _bidx = self._make_out(b, *unit)
            self._ready.append(out)

    def _mark_full(self, keep, build_idx, pdicts):
        """FULL OUTER bookkeeping, applied only AFTER the overflow check
        passed (a truncated expansion must not mark build rows)."""
        if self.join_type != "full" or keep is None:
            return
        b = self.bridge.build
        if self._build_matched is None:
            self._build_matched = torch.zeros(
                b.valid_sorted.shape[0] + 1, dtype=torch.bool,
                device=keep.device)
        _mark_build_matched(self._build_matched, keep, build_idx)
        self._probe_dicts = pdicts

    def _unmatched_build_page(self) -> DevicePage:
        """FULL OUTER tail: build rows no kept lane ever matched, with
        all probe channels NULL."""
        b = self.bridge.build
        cap = int(b.valid_sorted.shape[0])
        dev = b.valid_sorted.device
        unmatched = b.valid_sorted if self._build_matched is None \
            else b.valid_sorted & ~self._build_matched[:cap]
        pcols = [torch.zeros(cap, dtype=storage_dtype(t), device=dev)
                 for t in self.probe_types]
        pnulls = [torch.ones(cap, dtype=torch.bool, device=dev)
                  for _ in self.probe_types]
        pdicts = self._probe_dicts
        if pdicts is None:
            pdicts = [Dictionary() if t.is_pooled else None
                      for t in self.probe_types]
        return DevicePage(self.output_types, pcols + list(b.cols),
                          pnulls + list(b.nulls), unmatched,
                          list(pdicts) + list(b.dictionaries))

    def is_finished(self) -> bool:
        return self._done

    def _remap(self, probe_dict, build_dict, device):
        """Probe-pool code -> build-pool code LUT (-1 = absent, matches
        nothing; always canonical first-occurrence codes, so aligned
        pools with duplicate values compare correctly). Host work once
        per (probe pool, build pool) pair; the gather runs on the device.
        The cache entry pins both dict objects: bare id() keys would go
        stale if a pool were freed and its address reused."""
        key = (id(probe_dict), len(probe_dict) if probe_dict else 0,
               id(build_dict), len(build_dict) if build_dict else 0)
        hit = self._remap_cache.get(key)
        if hit is not None:
            return hit[0]
        if build_dict is None:
            lut = np.full(max(1, len(probe_dict or ())), -1,
                          dtype=np.int64)
        else:
            lut = np.fromiter(
                (build_dict.lookup(v) for v in probe_dict.values),
                dtype=np.int64,
                count=len(probe_dict)) if probe_dict and \
                len(probe_dict) else np.full(1, -1, dtype=np.int64)
        lut = torch.from_numpy(lut).to(device)
        if len(self._remap_cache) >= 128:  # evict BEFORE inserting
            self._remap_cache.clear()
        self._remap_cache[key] = (lut, probe_dict, build_dict)
        return lut

    def _probe_key_cols(self, page: DevicePage, b: BuildSide):
        """Per key channel: the probe column transformed into the build's
        key space (identity for unpooled types; canonical code remap for
        pooled keys — also when pools are shared, since an aligned pool
        may hold duplicate values under distinct codes)."""
        out = []
        types_ = []
        for i, c in enumerate(self.probe_keys):
            t = self.probe_types[c]
            if t.is_pooled:
                lut = self._remap(page.dictionaries[c],
                                  b.dictionaries[b.key_channels[i]],
                                  page.device)
                # dead lanes may hold any code: keep the gather in range
                codes = page.cols[c].to(torch.int64) \
                    .clamp(0, lut.shape[0] - 1)
                out.append(lut[codes])
                types_.append(T.BIGINT)
            else:
                out.append(page.cols[c])
                types_.append(t)
        return out, types_

    def _make_out(self, b: BuildSide, page: DevicePage, pkey_cols,
                  pusable, lo, count, lane_cap: int) -> Tuple:
        """One expansion at capacity ``lane_cap``: returns (out_page,
        keep, build_idx). keep/build_idx feed the FULL OUTER marker —
        applied by the caller only after the overflow check — and are
        None for semi/anti (no build channels in the output)."""
        bkeys = [b.cols[c] for c in b.key_channels]
        if self.join_type in ("semi", "anti"):
            if self.filter_fn is None:
                matched = _semi_matched(lo, count, pkey_cols, bkeys,
                                        b.usable_sorted, page.capacity,
                                        lane_cap)
            else:
                # residual-filtered semi/anti (q21's l3.l_suppkey <>
                # l1.l_suppkey): expand candidate lanes, verify keys,
                # evaluate the filter over the combined probe+build row,
                # then segment-OR back onto probe rows
                probe_idx, build_idx, keep = _expand_verified(
                    lo, count, pkey_cols, bkeys, b.usable_sorted, lane_cap)
                lanes = _gather_lanes(page, b, probe_idx, build_idx, keep)
                matched = _segment_any(self.filter_fn(lanes).valid,
                                       probe_idx, page.capacity)
            if self.join_type == "semi":
                new_valid = page.valid & matched
            else:
                new_valid = page.valid & ~matched
            return (DevicePage(page.types, page.cols, page.nulls,
                               new_valid, page.dictionaries), None, None)

        probe_idx, build_idx, keep = _expand_verified(
            lo, count, pkey_cols, bkeys, b.usable_sorted, lane_cap)
        if self.filter_fn is not None:
            # ON-clause residual runs BEFORE left-join padding: lanes
            # failing it make the probe row unmatched, not dropped
            lanes = _gather_lanes(page, b, probe_idx, build_idx, keep)
            keep = self.filter_fn(lanes).valid
        out_cols, out_nulls, out_valid = _finalize_join(
            page.cols, page.nulls, page.valid, b.cols, b.nulls,
            probe_idx, build_idx, keep,
            left=self.join_type in ("left", "full"))
        dicts = list(page.dictionaries) + list(b.dictionaries)
        return (DevicePage(self.output_types, out_cols, out_nulls,
                           out_valid, dicts), keep, build_idx)


def _gather_lanes(page: DevicePage, b: BuildSide, probe_idx, build_idx,
                  keep) -> DevicePage:
    """Combined probe+build rows for candidate lanes (residual-filter
    evaluation layout: probe channels, then build channels)."""
    return DevicePage(
        list(page.types) + list(b.types),
        [c[probe_idx] for c in page.cols] + [c[build_idx] for c in b.cols],
        [n[probe_idx] for n in page.nulls]
        + [n[build_idx] for n in b.nulls],
        keep,
        list(page.dictionaries) + list(b.dictionaries))
