"""Window functions on torch.

Reference analog: ``operator/WindowOperator.java`` + ``operator/window/``
(36 files: PagesIndex sort, per-partition WindowPartition driving
ranking/value/aggregate window functions row by row).

The JAX engine's design (``trino_tpu/ops/window.py``), as plain torch ops:
one sort orders the whole batch by (partition keys, order keys);
partition/peer-run boundaries come from adjacent-row comparison; every
function computes as a vectorized scan — rank/dense_rank from boundary
prefix sums, running aggregates from segmented scans with a
segment-reset combiner, full-partition aggregates gathered from the
partition-end lane. No per-row loops.

Supported frames: full partition (no ORDER BY, or UNBOUNDED..UNBOUNDED),
RANGE UNBOUNDED PRECEDING..CURRENT ROW (the SQL default with ORDER BY —
peers included via run-end gather), and ROWS frames with any bound
combination (UNBOUNDED / CURRENT ROW / k PRECEDING / k FOLLOWING).
Bounded-rows aggregates use prefix-difference for sum/count/avg and a
doubling (sparse-table) range query for min/max. RANGE with value
offsets is not supported.

torch has no eager ``associative_scan``: the segmented scan is a
log-step (Hillis–Steele) scan with the same combiner, exact for min, max
and integer sums. DOUBLE sums add in another order than XLA's scan (and
the sort is stable where the reference's is too), so they agree with the
JAX engine within rounding only. Every gather index is clamped into
range first (JAX clamps, a CUDA gather asserts).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from .. import types as T
from ..block import DevicePage, padded_size, storage_dtype
from ..telemetry.profiler import instrument
from ..types import TrinoError
from .operator import Operator
from .sort import _concat_pages
from .sortkeys import SortKey, group_operands, lexsort_indices, sort_operands

RANKING = {"row_number", "rank", "dense_rank", "ntile"}
VALUE_FNS = {"lag", "lead", "first_value", "last_value", "nth_value"}
AGG_FNS = {"count", "count_star", "sum", "avg", "min", "max"}


@dataclass(frozen=True)
class WindowCall:
    """One window function over the operator's shared (partition, order)
    spec. ``frame_mode``: 'partition' (whole partition), 'range' (default
    running frame incl. peers), 'rows' (exact rows). For 'rows',
    ``frame_start``/``frame_end`` are row offsets relative to the current
    row (negative = PRECEDING, positive = FOLLOWING, 0 = CURRENT ROW,
    None = UNBOUNDED); the default (None, 0) is the running frame."""

    function: str
    arg_channel: Optional[int]
    arg_type: Optional[T.Type]
    output_type: T.Type
    frame_mode: str = "range"
    offset: int = 1          # lag/lead distance; ntile buckets; nth n
    frame_start: Optional[int] = None
    frame_end: Optional[int] = 0


def resolve_window_type(function: str, arg_type: Optional[T.Type]) -> T.Type:
    if function in ("row_number", "rank", "dense_rank", "ntile",
                    "count", "count_star"):
        return T.BIGINT
    if function in ("lag", "lead", "first_value", "last_value",
                    "nth_value"):
        return arg_type
    if function in ("sum", "avg"):
        from .aggregation import resolve_agg_type

        return resolve_agg_type(function, arg_type)
    if function in ("min", "max"):
        return arg_type
    raise TrinoError(f"unknown window function {function}",
                     "FUNCTION_NOT_FOUND")


def _seg_scan(op, x, reset):
    """Segmented inclusive scan: ``op`` accumulates within a segment,
    restarting where ``reset`` is True. Log-step scan with the classic
    segmented combiner (a, b) -> (fa | fb, fb ? vb : op(va, vb))."""
    f, v = reset, x
    n = x.shape[0]
    d = 1
    while d < n:
        v = torch.cat([v[:d], torch.where(f[d:], v[d:], op(v[:-d], v[d:]))])
        f = torch.cat([f[:d], f[:-d] | f[d:]])
        d *= 2
    return v


def _suffix_seg_scan(op, x, pend_flag):
    """Segmented scan from each partition's END backwards: out[i] =
    op-fold of x[i..partition_end]."""
    return torch.flip(_seg_scan(op, torch.flip(x, [0]),
                                torch.flip(pend_flag, [0])), [0])


def _sparse_table(op, x):
    """Stacked doubling tables: table[k, i] = op-fold of
    x[i .. i + 2^k - 1] (clamped). O(n log n) build, O(1) range query."""
    n = x.shape[0]
    idx = torch.arange(n, device=x.device)
    levels = [x]
    step = 1
    while step < n:
        prev = levels[-1]
        levels.append(op(prev, prev[torch.clamp(idx + step, max=n - 1)]))
        step *= 2
    return torch.stack(levels)


def _range_query(table, op, lo, hi):
    """op-fold of x[lo..hi] (lo <= hi assumed; caller masks empties) via
    two overlapping power-of-two windows."""
    length = torch.clamp(hi - lo + 1, min=1)
    # float64 log2 is exact at powers of two, so floor() is safe
    k = torch.floor(torch.log2(length.to(torch.float64))).to(torch.int64)
    k = torch.clamp(k, max=table.shape[0] - 1)
    pow2 = torch.ones_like(k) << k
    a = table[k, lo]
    b = table[k, torch.maximum(hi - pow2 + 1, lo)]
    return op(a, b)


def _new_run(ops, n, device):
    flag = torch.zeros(n, dtype=torch.bool, device=device)
    flag[0] = True
    for o in ops:
        flag[1:] |= o[1:] != o[:-1]
    return flag


def _cummax(x):
    return torch.cummax(x, 0).values


def _rev_cummin(x):
    return torch.flip(torch.cummin(torch.flip(x, [0]), 0).values, [0])


def _window_kernel(part_ops, order_ops, cols, nulls, valid,
                   calls: Sequence[WindowCall]):
    """Sort + compute all window outputs. Returns sorted (cols, nulls,
    valid) + per-call (raw, null) output columns."""
    n = valid.shape[0]
    dev = valid.device
    perm = lexsort_indices([(~valid).to(torch.uint8)] + list(part_ops)
                           + list(order_ops))
    s_part = [o[perm] for o in part_ops]
    s_order = [o[perm] for o in order_ops]
    s_cols = [c[perm] for c in cols]
    s_nulls = [x[perm] for x in nulls]
    s_valid = valid[perm]

    idx = torch.arange(n, dtype=torch.int64, device=dev)
    zeros_b = torch.zeros(n, dtype=torch.bool, device=dev)

    # validity participates in partition detection: sort puts valid rows
    # first, so the valid->padding transition starts a (dead) partition
    # and pend_idx/partition sizes never include padding lanes
    pstart = _new_run(s_part + [s_valid], n, dev)
    rstart = pstart | _new_run(s_order, n, dev) if s_order else pstart

    # index of the current partition/run start (indices are monotone)
    pstart_idx = _cummax(torch.where(pstart, idx, 0))
    rstart_idx = _cummax(torch.where(rstart, idx, 0))
    # index of the partition/run end (reverse cummin of flagged indices)
    pend_flag = torch.cat([pstart[1:], torch.ones(1, dtype=torch.bool,
                                                  device=dev)])
    rend_flag = torch.cat([rstart[1:], torch.ones(1, dtype=torch.bool,
                                                  device=dev)])
    pend_idx = torch.clamp(_rev_cummin(torch.where(pend_flag, idx, n)),
                           0, n - 1)
    rend_idx = torch.clamp(_rev_cummin(torch.where(rend_flag, idx, n)),
                           0, n - 1)

    row_number = idx - pstart_idx + 1

    def frame_lo_hi(call):
        """(lo, hi, empty) row-index frame bounds for one call."""
        if call.frame_mode == "partition":
            return pstart_idx, pend_idx, zeros_b
        if call.frame_mode == "range":
            return pstart_idx, rend_idx, zeros_b
        fs, fe = call.frame_start, call.frame_end
        lo_raw = pstart_idx if fs is None else idx + fs
        hi_raw = pend_idx if fe is None else idx + fe
        lo = torch.maximum(lo_raw, pstart_idx)
        hi = torch.minimum(hi_raw, pend_idx)
        return torch.clamp(lo, 0, n - 1), torch.clamp(hi, 0, n - 1), lo > hi

    outs = []
    for call in calls:
        f = call.function
        if f == "row_number":
            outs.append((row_number, None))
            continue
        if f == "rank":
            outs.append((rstart_idx - pstart_idx + 1, None))
            continue
        if f == "dense_rank":
            prefix = torch.cumsum(rstart.to(torch.int64), 0)
            at_pstart = _cummax(torch.where(pstart, prefix, 0))
            outs.append((prefix - at_pstart + 1, None))
            continue
        if f == "ntile":
            size = pend_idx - pstart_idx + 1
            outs.append((torch.div((row_number - 1) * call.offset, size,
                                   rounding_mode="floor") + 1, None))
            continue
        if f in ("lag", "lead"):
            x = s_cols[call.arg_channel]
            xn = s_nulls[call.arg_channel]
            k = call.offset if f == "lag" else -call.offset
            src = idx - k
            in_part = (src >= pstart_idx) & (src <= pend_idx)
            src_c = torch.clamp(src, 0, n - 1)
            xs = x[src_c]
            outs.append((torch.where(in_part, xs, torch.zeros_like(xs)),
                         ~in_part | xn[src_c]))
            continue
        if f in ("first_value", "last_value", "nth_value"):
            x = s_cols[call.arg_channel]
            xn = s_nulls[call.arg_channel]
            lo, hi, empty = frame_lo_hi(call)
            if f == "first_value":
                pos = lo
            elif f == "last_value":
                pos = hi
            else:
                pos = lo + (call.offset - 1)
                empty = empty | (pos > hi)
            pos = torch.clamp(pos, 0, n - 1)
            outs.append((x[pos], empty | xn[pos]))
            continue

        # aggregates over the frame
        if call.arg_channel is None:       # count(*)
            xval = s_valid.to(torch.int64)
            live = s_valid
        else:
            x = s_cols[call.arg_channel]
            live = s_valid & ~s_nulls[call.arg_channel]
            is_float = call.arg_type in (T.REAL, T.DOUBLE)
            if f in ("sum", "avg", "count"):
                dt = torch.float64 if is_float else torch.int64
                xval = torch.where(live, x.to(dt), torch.zeros((), dtype=dt,
                                                               device=dev))
            elif is_float:  # min/max sentinels
                sent = float("inf") if f == "min" else float("-inf")
                xval = torch.where(live, x.to(torch.float64), sent)
            else:
                info = torch.iinfo(x.dtype)
                sent = info.max if f == "min" else info.min
                xval = torch.where(live, x, torch.tensor(
                    sent, dtype=x.dtype, device=dev))
        zero = torch.zeros((), dtype=xval.dtype, device=dev)

        fs, fe = call.frame_start, call.frame_end
        both_bounded = call.frame_mode == "rows" \
            and fs is not None and fe is not None
        start_bounded = call.frame_mode == "rows" and fs is not None

        if both_bounded:
            # prefix-difference for additive fns; sparse-table range
            # query for min/max (subtraction has no inverse there)
            lo, hi, empty = frame_lo_hi(call)
            before = torch.clamp(lo - 1, min=0)
            pref_cnt = torch.cumsum(live.to(torch.int64), 0)
            cnt = pref_cnt[hi] - torch.where(lo > 0, pref_cnt[before], 0)
            cnt = torch.where(empty, 0, cnt)
            if f in ("count", "count_star"):
                outs.append((cnt, None))
                continue
            if f in ("sum", "avg"):
                pref = torch.cumsum(xval, 0)
                val = pref[hi] - torch.where(lo > 0, pref[before], zero)
                val = torch.where(empty, zero, val)
            else:
                op = torch.minimum if f == "min" else torch.maximum
                val = _range_query(_sparse_table(op, xval), op, lo, hi)
        elif start_bounded:
            # k PRECEDING .. UNBOUNDED FOLLOWING: suffix scan at lo
            lo, hi, empty = frame_lo_hi(call)
            cnt_sfx = _suffix_seg_scan(torch.add, live.to(torch.int64),
                                       pend_flag)
            cnt = torch.where(empty, 0, cnt_sfx[lo])
            if f in ("count", "count_star"):
                outs.append((cnt, None))
                continue
            op = {"sum": torch.add, "avg": torch.add, "min": torch.minimum,
                  "max": torch.maximum}[f]
            val = _suffix_seg_scan(op, xval, pend_flag)[lo]
            if f in ("sum", "avg"):
                val = torch.where(empty, zero, val)
        else:
            # running frames: forward segmented scan read at the frame
            # end (partition end / peer-run end / current row / +k rows)
            cnt_scan = _seg_scan(torch.add, live.to(torch.int64), pstart)
            if f in ("count", "count_star"):
                scan = cnt_scan
            else:
                op = {"sum": torch.add, "avg": torch.add,
                      "min": torch.minimum, "max": torch.maximum}[f]
                scan = _seg_scan(op, xval, pstart)

            empty = zeros_b
            if call.frame_mode == "partition":
                at = pend_idx
            elif call.frame_mode == "range":
                at = rend_idx
            elif fe == 0:
                at = idx
            else:  # UNBOUNDED PRECEDING .. k ROWS (k != 0)
                hi_raw = idx + fe
                empty = hi_raw < pstart_idx
                at = torch.clamp(torch.minimum(hi_raw, pend_idx), 0, n - 1)
            val = scan[at]
            cnt = torch.where(empty, 0, cnt_scan[at])
            if f in ("count", "count_star"):
                outs.append((cnt, None))
                continue
            if f in ("sum", "avg"):
                val = torch.where(empty, zero, val)

        if f == "avg":
            if call.output_type.is_decimal:
                from ..expr.functions import div_round_half_up

                outs.append((div_round_half_up(val, torch.clamp(cnt, min=1)),
                             cnt == 0))
            else:
                outs.append((val.to(torch.float64) / torch.clamp(cnt, min=1),
                             cnt == 0))
        else:
            outs.append((val, cnt == 0))

    out_cols = [r for r, _ in outs]
    out_nulls = [zeros_b if nl is None else nl for _, nl in outs]
    return s_cols, s_nulls, s_valid, out_cols, out_nulls


# profiled program (telemetry.profiler): a plain call when profiling is off
_window_kernel = instrument("window_kernel", _window_kernel,
                            static_argnames=("calls",))


def partition_operands(page: DevicePage, channels: Sequence[int],
                       rank_cache: dict) -> List:
    """Grouping operands of the partition keys; pooled keys partition by
    value RANK (derived pools may alias one value under several codes)."""
    from .aggregation import _lut, _rank_and_inverse

    ops: List = []
    for c in channels:
        t = page.types[c]
        if t.is_pooled:
            rank_lut, _ = _rank_and_inverse(page.dictionaries[c], rank_cache)
            ops.extend(group_operands(
                _lut(rank_lut, page.device)[page.cols[c].to(torch.int64)],
                page.nulls[c], T.BIGINT))
        else:
            ops.extend(group_operands(page.cols[c], page.nulls[c], t))
    return ops


def order_operands(page: DevicePage, keys: Sequence[SortKey]) -> List:
    ops: List = []
    for k in keys:
        ops.extend(sort_operands(
            page.cols[k.channel], page.nulls[k.channel],
            page.types[k.channel], page.dictionaries[k.channel],
            ascending=k.ascending, nulls_last=k.nulls_last))
    return ops


class WindowOperator(Operator):
    """Materializes input, sorts by (partition, order), appends one
    column per window call."""

    def __init__(self, input_types: Sequence[T.Type],
                 partition_channels: Sequence[int],
                 sort_keys: Sequence[SortKey],
                 calls: Sequence[WindowCall]):
        self.input_types = list(input_types)
        self.partition_channels = list(partition_channels)
        self.sort_keys = list(sort_keys)
        self.calls = tuple(calls)
        self._pages: List[DevicePage] = []
        self._rank_cache: dict = {}
        self._emitted = False
        self._done = False

    @property
    def output_types(self) -> List[T.Type]:
        return self.input_types + [c.output_type for c in self.calls]

    def add_input(self, page: DevicePage):
        self._pages.append(page)

    def get_output(self) -> Optional[DevicePage]:
        if not self._finishing or self._emitted:
            return None
        self._emitted = True
        self._done = True
        if not self._pages:
            return None
        from .aggregation import _lut, _rank_and_inverse

        cap = padded_size(sum(p.capacity for p in self._pages))
        page = _concat_pages(self._pages, cap)
        self._pages = []
        dev = page.device
        part_ops = partition_operands(page, self.partition_channels,
                                      self._rank_cache)
        order_ops = order_operands(page, self.sort_keys)
        # pooled (string/array/map/row) min/max args reduce on value
        # RANKS, not raw pool codes (insertion order): append a rank
        # column per such call, retarget the call at it, and map the
        # reduced rank back to a representative code after the kernel
        calls = list(self.calls)
        all_cols = list(page.cols)
        all_nulls = list(page.nulls)
        restore: dict = {}
        for i, c in enumerate(calls):
            if c.function in ("min", "max") and c.arg_type is not None \
                    and c.arg_type.is_pooled:
                d = page.dictionaries[c.arg_channel]
                rank_lut, inv = _rank_and_inverse(d, self._rank_cache)
                restore[i] = (_lut(inv, dev), d)
                calls[i] = dataclasses.replace(
                    c, arg_channel=len(all_cols), arg_type=T.BIGINT)
                all_cols.append(_lut(rank_lut, dev)[
                    page.cols[c.arg_channel].to(torch.int64)])
                all_nulls.append(page.nulls[c.arg_channel])
        nch = len(page.types)
        s_cols, s_nulls, s_valid, w_cols, w_nulls = _window_kernel(
            part_ops, order_ops, all_cols, all_nulls, page.valid, calls)
        for i, (inv, _d) in restore.items():
            w_cols[i] = inv[torch.clamp(w_cols[i], 0, inv.shape[0] - 1)]
        cols = list(s_cols[:nch]) + [
            c.to(storage_dtype(call.output_type))
            for c, call in zip(w_cols, self.calls)]
        nulls = list(s_nulls[:nch]) + list(w_nulls)
        # value functions over pooled args keep the arg's code pool;
        # rank-reduced min/max restores the captured pool
        dicts = list(page.dictionaries) + [
            restore[i][1] if i in restore
            else (page.dictionaries[c.arg_channel]
                  if (c.output_type.is_pooled and c.arg_channel is not None)
                  else None)
            for i, c in enumerate(self.calls)]
        return DevicePage(self.output_types, cols, nulls, s_valid, dicts)

    def is_finished(self) -> bool:
        return self._done
