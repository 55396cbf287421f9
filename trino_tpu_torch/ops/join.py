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

Not ported: the JAX engine's hybrid partitioned build (``HybridJoinState``
and the deferred per-partition passes). It starts only on a memory
revocation, and this engine has no spill tier (``exec/memory.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as T
from ..block import (DevicePage, Dictionary, padded_size, storage_dtype,
                     unify_dictionaries)
from .hashtable import _i64, _shr
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


def _probe_counts(build_keys, build_usable, probe_keys, probe_usable):
    """Each probe row's candidate range: (lo, count) into the sorted
    build keys."""
    lo = torch.searchsorted(build_keys, probe_keys)
    hi = torch.searchsorted(build_keys, probe_keys, right=True)
    count = torch.where(probe_usable, hi - lo, 0)
    return lo, count


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


class HashBuilderOperator(Operator):
    """Accumulates the build side and publishes a sorted index."""

    def __init__(self, input_types: Sequence[T.Type],
                 key_channels: Sequence[int], bridge: JoinBridge,
                 device, memory_context=None,
                 dynamic_filters: Sequence = ()):
        self.input_types = list(input_types)
        self.key_channels = list(key_channels)
        self.bridge = bridge
        self.device = device
        # [(channel, DynamicFilter)] to fill at publish (reference:
        # DynamicFilterSourceOperator collecting build values)
        self.dynamic_filters = list(dynamic_filters)
        self._pages: List[DevicePage] = []
        self._done = False
        self._ctx = memory_context

    def add_input(self, page: DevicePage):
        if self._ctx is None:
            self._pages.append(page)
            return
        from ..exec.memory import reserve_and_append

        reserve_and_append(self._ctx, self._pages, page)

    def get_output(self):
        if self._finishing and not self._done:
            self._publish()
            self._done = True
        return None

    def _publish(self):
        if self._ctx is not None:
            from ..exec.memory import prepare_finish

            # transient: the concatenation and its sorted copy
            self._ctx.reserve(2 * prepare_finish(self._ctx, self._pages))
        if self._pages:
            pages = self._pages
            cap = padded_size(sum(p.capacity for p in pages))
            cols, nulls = [], []
            for i in range(len(self.input_types)):
                cols.append(_pad(torch.cat([p.cols[i] for p in pages]), cap))
                nulls.append(_pad(torch.cat([p.nulls[i] for p in pages]),
                                  cap, fill=True))
            valid = _pad(torch.cat([p.valid for p in pages]), cap)
            dicts = unify_dictionaries(pages, len(self.input_types))
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
        for ch, df in self.dynamic_filters:
            df.collect(cols[ch], nulls[ch], valid)
        self.bridge.set_build(_assemble_build_side(
            self.input_types, self.key_channels, cols, nulls, valid, dicts))
        self._pages = []  # release the input pages; only the index remains
        if self._ctx is not None:
            # retain only the published index: sorted key (8B) + usable
            # + valid (1B each) + per-channel data/null lanes
            retained = cap * (10 + sum(c.element_size() + 1 for c in cols))
            self._ctx.close()
            self._ctx.reserve(retained)
            self.bridge.release = self._ctx.close

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
                 max_lanes: Optional[int] = None):
        assert join_type in ("inner", "left", "full", "semi", "anti")
        self.probe_types = list(probe_types)
        self.probe_keys = list(probe_key_channels)
        self.bridge = bridge
        self.join_type = join_type
        self.filter_fn = filter_fn  # optional post-join residual filter
        if max_lanes is not None:
            self.max_lanes = max_lanes
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
        tot = int(rec["total"])
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
        unit: its lane capacity grows to its fan-out."""
        page, pkey_cols, pusable = rec["page"], rec["pkey_cols"], \
            rec["pusable"]
        lo, count = rec["lo"], rec["count"]
        if padded_size(max(total, 16)) <= self.max_lanes:
            return [(page, pkey_cols, pusable, lo, count,
                     padded_size(max(total, 16)))]
        counts = count.cpu().numpy()
        units: List = []
        n = counts.shape[0]
        i = 0
        while i < n:
            j = i
            run = 0
            while j < n and (j == i or
                             padded_size(max(run + int(counts[j]), 16))
                             <= self.max_lanes):
                run += int(counts[j])
                j += 1
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
