"""Batched execution: run a same-shape admission burst as ONE pass per
pipeline stage, with an explicit leading batch axis.

The JAX engine's ``trino_tpu/exec/batched.py``, ported. There a burst of
B same-shape statements stacks its literal vectors on a ``(B,)`` axis and
``jit(vmap(...))``s each stage. Here the batch axis is explicit: the
plan template's literals are ``ParamRef`` slots, so a stage is one
function of its parameters; the parameters become ``(B,)`` tensors
broadcast against the page (``PageProcessor.process_batched``), and every
lane downstream is ``(B, n)``. ``torch.vmap`` is not used: it cannot
batch the data-dependent ops the engine runs (``nonzero``, ``index_put_``
with host syncs) nor a ctypes kernel launch.

- **masked execution**: filtered rows are never compacted per lane; each
  stage carries a ``(B, n)`` validity mask and the only compaction
  happens at the final host demux (``DevicePage.to_page``).
- **aggregation** (``HashAggregationOperator``, step ``single``): the B
  lanes of a stage page FOLD into one problem. Lane ``d``'s rows occupy
  rows ``[d*S, (d+1)*S)`` of a flat page (``S`` is the page capacity
  rounded up to the segment-reduce kernel's tile, so every lane starts
  on a tile edge), the lane index is one more grouping operand, so one
  hash insert groups the whole burst, and one ``segment_reduce_columns``
  call reduces every state column of every lane with
  ``gid' = lane * (cap + 1) + gid`` over ``B * (cap + 1)`` segments —
  on the card, the hand-written Hopper kernel. Per-lane dense group ids
  and counts come back by the lane offset, so every lane's groups sit
  where its serial run puts them, in the same first-occurrence order.
  The merge and the final projection run the same way once the scan
  drains. A global aggregation folds the same way, one group per lane.
  When every state is order-free (integer sums, MIN, MAX), each page's
  partial is cut to its lanes' live rows before the merge
  (``_compact_lanes``): the merge then spans the burst's groups, not
  B times the partials' capacity. A burst whose partials and merge
  would hold more than the query's memory budget leaves the batch
  (``memory_budget``; the serial path would spill instead).
- **joins** (``LookupJoinOperator`` — the matmul strategy's sorted-index
  probe gives the same candidates, so the batched path always uses the
  sorted index): the build side is literal-independent by template
  construction (the aux pipelines are proved param-free), so ONE serial
  build serves every lane. inner/left expand at a lane capacity unified
  across the batch; semi/anti are pure mask updates.
- **per-lane overflow falls back alone**: a lane whose join expansion
  exceeds the unified capacity (or whose rows exhaust the hash table's
  probe budget) is marked spilled — the runner re-runs that member
  (only) serially; the other lanes' results are served from the batch.

Every gather index a masked or padding lane can carry is in range (a
CUDA gather asserts where JAX clamps).

Eligibility is narrower than template eligibility: a template whose
plan holds an unsupported stage (limits, full-outer joins, residual
join filters, partial-step aggregations) executes through the shared
template serially. ``BatchIneligible.reason`` feeds the fallback
taxonomy counters either way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np
import torch

from ..block import DevicePage, Dictionary, Page, padded_size, \
    storage_dtype
from ..expr.compiler import param_raw
from ..ops.aggregation import (HashAggregationOperator, _final_project,
                               _init_states, _merge_states, _state_plan)
from ..ops.hashtable import hash_insert, hashable_key_types
from ..ops.join import LookupJoinOperator, _key_u64, _probe_counts_impl
from ..ops.kernel_sizing import KERNEL_SIZING
from ..ops.kernels import segment_reduce_columns, segment_tile_rows
from ..ops.operator import (FilterProjectOperator, OutputCollectorOperator,
                            TableScanOperator)
from ..ops.sortkeys import lexsort_indices
from ..telemetry.profiler import instrument
from ..telemetry.device_reads import host_scalar, to_cpu, to_host


class BatchIneligible(Exception):
    """This plan/batch cannot ride the batched path; ``reason`` is one
    of the fallback-taxonomy tags (the JAX engine's)."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


@dataclass
class BatchResult:
    """One batched execution's demuxed output.

    pages:        host pages per member (spilled members get none here)
    spilled:      member positions that overflowed a per-lane capacity
                  and must re-run serially (counted by the runner)
    dispositions: what actually ran beyond filter/project stages
                  (``agg_stage_vmapped`` / ``join_stage_vmapped``, the
                  JAX engine's tags) — feeds the taxonomy counters
    stage_rows:   per HBO-fingerprinted stage: exact per-lane output
                  row counts (rows key is a ``(D,)`` host array over the
                  PADDED batch; the runner records real, non-spilled
                  lanes only)
    scan_rows:    rows the shared scan produced (lane-invariant)
    """

    pages: List[List[Page]]
    spilled: Set[int]
    dispositions: List[str]
    stage_rows: List[dict]
    scan_rows: int


def vmappable_stages(plan) -> Tuple[List, TableScanOperator, List[Tuple],
                                    List[str]]:
    """Classify a plan for batching: returns (aux_pipelines, scan,
    stages, dispositions) or raises ``BatchIneligible`` with the
    taxonomy reason.

    ``stages`` is the main pipeline's interior as ("fp" | "agg" |
    "join", operator) pairs; ``aux_pipelines`` (join builds) are proved
    param-free so one serial run serves every lane."""
    pipelines = list(plan.pipelines)
    mains = [p for p in pipelines
             if p.operators and isinstance(p.operators[-1],
                                           OutputCollectorOperator)]
    if len(mains) != 1:
        raise BatchIneligible("no_collect_tail")
    main = mains[0].operators
    aux = [p for p in pipelines if p is not mains[0]]
    for p in aux:
        for op in p.operators:
            if isinstance(op, FilterProjectOperator) \
                    and op.processor.param_indices:
                # a literal reaching a build pipeline would break the
                # one-build-serves-all-lanes invariant
                raise BatchIneligible("unsupported_stage")
    if not main or not isinstance(main[0], TableScanOperator):
        raise BatchIneligible("no_scan_head")
    stages: List[Tuple] = []
    dispositions: List[str] = []
    seen_param = False
    for op in main[1:-1]:
        if isinstance(op, FilterProjectOperator):
            if op.processor.param_indices:
                seen_param = True
            stages.append(("fp", op))
        elif isinstance(op, HashAggregationOperator):
            # the batch axis must exist before a masked stage can demux
            # per lane; step single only
            if op.step != "single" or not seen_param:
                raise BatchIneligible("unsupported_stage")
            stages.append(("agg", op))
            if "agg_stage_vmapped" not in dispositions:
                dispositions.append("agg_stage_vmapped")
        elif isinstance(op, LookupJoinOperator):
            if op.join_type not in ("inner", "left", "semi", "anti") \
                    or op.filter_fn is not None or not seen_param:
                raise BatchIneligible("unsupported_stage")
            stages.append(("join", op))
            if "join_stage_vmapped" not in dispositions:
                dispositions.append("join_stage_vmapped")
        else:
            raise BatchIneligible("unsupported_stage")
    return aux, main[0], stages, dispositions


def check_params_consumed(fps: Sequence[FilterProjectOperator],
                          num_params: int):
    """Every literal slot of the shape must reach a stage: an
    unconsumed slot would mean two members with different literals
    produce identical (wrong for one of them) results."""
    consumed = set()
    for fp in fps:
        consumed.update(fp.processor.param_indices)
    if consumed != set(range(num_params)):
        raise BatchIneligible("params_unconsumed")


def stack_bindings(fps: Sequence[FilterProjectOperator], param_types,
                   bindings: Sequence[Tuple]) -> List[Tuple]:
    """Per-stage stacked parameter tensors: for each stage, a tuple
    (one entry per consumed slot, in ``param_indices`` order) of
    ``(D,)`` tensors over the padded batch ``bindings`` (python literal
    values per global slot, one tuple per batch lane)."""
    out = []
    for fp in fps:
        idxs = fp.processor.param_indices
        out.append(tuple(
            torch.from_numpy(np.stack([
                np.asarray(param_raw(param_types[i], vals[i]))
                for vals in bindings]))
            for i in idxs))
    return out


# ---------------------------------------------------------------------------
# folded lanes: B independent problems laid end to end in one flat page


def _lane_stride(cap: int, device) -> int:
    """Rows per lane in a folded page: ``cap`` rounded up to the
    segment-reduce kernel's tile, so each lane starts on a tile edge and
    reduces exactly as its serial run does (float sums associate in the
    same order)."""
    tile = segment_tile_rows(device)
    return -(-cap // tile) * tile


def _flat(x: torch.Tensor, stride: int) -> torch.Tensor:
    """``(D, cap)`` -> ``(D * stride,)``: each lane padded with zeros
    (False for masks) up to ``stride`` rows."""
    d, cap = x.shape
    if stride != cap:
        x = torch.cat([x, x.new_zeros((d, stride - cap))], dim=1)
    return x.reshape(-1)


def _lanes_of(flat: torch.Tensor, depth: int, per_lane: int,
              cap: int) -> torch.Tensor:
    """The first ``cap`` of every lane's ``per_lane`` entries of a flat
    result, as a contiguous ``(depth, cap)`` tensor."""
    return flat.view(depth, per_lane)[:, :cap].contiguous()


def _fold_group_reduce(key_ops: Sequence, key_raws: Sequence,
                       key_nulls: Sequence, state_cols: Sequence,
                       valid: torch.Tensor, kinds: Tuple, hash_path: bool):
    """Group and reduce a ``(D, cap)`` page, every lane on its own, in
    one folded pass: one hash insert (or one sort) with the lane as the
    leading grouping operand, then ONE ``segment_reduce_columns`` call
    over ``D * (cap + 1)`` segments. The stacked counterpart of
    ``hashtable.hash_segment_reduce`` / ``aggregation.group_reduce``,
    lane for lane: the same dense first-occurrence (hash) or key-order
    (sort) group ids, the same reduced values.

    Returns (key_raws, key_nulls, reduced_states, out_valid, overflow):
    ``(D, cap)`` tensors and a ``(D,)`` mask of lanes whose rows
    exhausted the hash probe budget (their groups are not trustworthy)."""
    depth, cap = valid.shape
    dev = valid.device
    stride = _lane_stride(cap, dev)
    n = depth * stride
    seg = cap + 1
    vflat = _flat(valid, stride)
    lane = torch.arange(depth, dtype=torch.int64,
                        device=dev).repeat_interleave(stride)
    ops = [_flat(k, stride) for k in key_ops]
    if hash_path:
        rep, resolved = hash_insert(ops + [lane], vflat)
        overflow = (~resolved).view(depth, stride).any(1)
        rep = rep.to(torch.int64)
        row = torch.arange(n, dtype=torch.int64, device=dev)
        leader = vflat & (rep == row)
        counts = leader.view(depth, stride).sum(1)
        offs = torch.cumsum(counts, 0) - counts
        # lanes are contiguous and leaders number in row order, so lane
        # d's groups are global ids [offs[d], offs[d] + counts[d])
        prefix = torch.cumsum(leader.to(torch.int64), 0) - 1
        live = vflat & (rep < n)
        local = torch.where(live, prefix[rep.clamp(0, n - 1)] - offs[lane],
                            cap)
        gidp = (lane * seg + local).to(torch.int32)
        order = torch.sort(gidp, stable=True).indices
        reduced = segment_reduce_columns(
            [_flat(s, stride) for s in state_cols], gidp[order],
            depth * seg, kinds, order=order)
        # each (lane, group)'s representative row; dead slots read row 0
        rows = torch.zeros(depth * cap + 1, dtype=torch.int64, device=dev)
        rows.index_put_((torch.where(leader, lane * cap + local,
                                     depth * cap),), row)
        rows = rows[:-1].view(depth, cap)
        out_valid = torch.arange(cap, device=dev)[None, :] < counts[:, None]
        out_keys = [_flat(k, stride)[rows] for k in key_raws]
        out_key_nulls = [_flat(k, stride)[rows] & out_valid
                         for k in key_nulls]
    else:
        overflow = torch.zeros(depth, dtype=torch.bool, device=dev)
        # invalid lanes sort last within their lane: leading operands
        # (lane, ~valid), then the keys
        perm = lexsort_indices([lane, (~vflat).to(torch.uint8)] + ops)
        s_ops = [op[perm] for op in ops]
        s_valid = vflat[perm]
        diff = lane != torch.roll(lane, 1)
        diff[0] = True
        for op in s_ops:
            d = op != torch.roll(op, 1)
            d[0] = True
            diff = diff | d
        boundary = diff & s_valid
        counts = boundary.view(depth, stride).sum(1)
        offs = torch.cumsum(counts, 0) - counts
        gid = torch.cumsum(boundary.to(torch.int64), 0) - 1
        local = torch.where(s_valid, gid - offs[lane], cap)
        gidp = (lane * seg + local).to(torch.int32)
        *reduced, first = segment_reduce_columns(
            [_flat(s, stride)[perm] for s in state_cols]
            + [torch.arange(n, dtype=torch.int32, device=dev)],
            gidp, depth * seg, list(kinds) + ["min"])
        out_valid = torch.arange(cap, device=dev)[None, :] < counts[:, None]
        first = _lanes_of(first, depth, seg, cap)
        rows = torch.where(out_valid, first, 0).to(torch.int64)
        out_keys = [_flat(k, stride)[perm][rows] for k in key_raws]
        out_key_nulls = [s_ops[2 * i][rows] > 0
                         for i in range(len(key_raws))]
    reduced = [_lanes_of(r, depth, seg, cap) for r in reduced]
    return out_keys, out_key_nulls, reduced, out_valid, overflow


# the burst's programs, profiled under the JAX engine's lane-program
# names (``trino_tpu/exec/batched.py``): a page's partials, the merge,
# the final projection, and the join stage's probe and expansion
_fold_partial = instrument("batched_agg_partial", _fold_group_reduce,
                           static_argnames=("kinds", "hash_path"))
_fold_merge = instrument("batched_agg_merge", _fold_group_reduce,
                         static_argnames=("kinds", "hash_path"))


def _final_lanes(aggregates: Tuple, cols, nulls, valid, nkeys: int):
    """The aggregation's final projection over ``(D, cap)`` merged
    states: each aggregate's output column and null mask after the
    keys (``HashAggregationOperator._finalize``'s walk)."""
    out_cols = list(cols[:nkeys])
    out_nulls = list(nulls[:nkeys])
    idx = nkeys
    for a in aggregates:
        m = len(_state_plan(a))
        raw, null = _final_project(a, cols[idx:idx + m])
        idx += m
        out_cols.append(raw.to(storage_dtype(a.output_type)))
        out_nulls.append(null | ~valid)
    return out_cols, out_nulls


_final_lanes = instrument("batched_agg_finalize", _final_lanes,
                          static_argnames=("nkeys",))


@dataclass
class _BatchPage:
    """One page mid-pipeline: columns either shared (param-free prefix,
    1-D) or stacked over the batch axis (2-D, ``batched=True``)."""

    types: List
    cols: Tuple
    nulls: Tuple
    valid: torch.Tensor
    dicts: List
    batched: bool

    def device_page(self) -> DevicePage:
        return DevicePage(list(self.types), list(self.cols),
                          list(self.nulls), self.valid, list(self.dicts))


class _AggAccumulator:
    """Barrier state of one batched aggregation stage: per-page folded
    partials accumulate, then merge + finalize once the scan drains —
    the stacked mirror of the operator's partials list /
    ``_merge_partials`` / ``_finalize`` walk, call for call, so every
    lane equals its serial run."""

    def __init__(self, op: HashAggregationOperator, depth: int):
        self.op = op
        self.depth = depth
        self.parts: List[Tuple] = []   # (cols, nulls, valid), (D, cap)
        self.overflow = None
        key_types = [op.input_types[c] for c in op.group_channels]
        self.hash_path = op.hash_grouping and hashable_key_types(key_types)
        self.nkeys = len(op.group_channels)
        #: every state reduces to the same bits in any row order
        #: (integer sums, MIN, MAX): partials may then be compacted
        #: before the merge (see ``feed``)
        self.order_free = all(kind != "sum" or dt != torch.float64
                              for a in op.aggregates
                              for kind, dt in _state_plan(a))

    def _capture_dicts(self, page: _BatchPage):
        # mirrors add_input's capture; lanes share pages, so pools are
        # lane-invariant by construction
        op = self.op
        for i, c in enumerate(op.group_channels):
            d = page.dicts[c]
            if d is not None:
                op._group_dicts[i] = d
        k = 0
        for a in op.aggregates:
            for _ in _state_plan(a):
                if op._str_state[k]:
                    d = page.dicts[a.arg_channel]
                    if d is not None:
                        op._state_dicts[k] = d
                k += 1

    def _group(self, page: DevicePage, intermediate: bool) -> Tuple:
        """``HashAggregationOperator._aggregate_page`` over a ``(D,
        cap)`` page, folded: (cols, nulls, valid) of the per-lane
        partials."""
        op = self.op
        nkeys = self.nkeys
        if intermediate:
            key_channels = list(range(nkeys))
            key_types = op._intermediate_types()[:nkeys]
        else:
            key_channels = op.group_channels
            key_types = [op.input_types[c] for c in op.group_channels]
        key_ops, key_raws = op._grouping_operands(page, key_channels,
                                                  key_types)
        state_cols: List = []
        if intermediate:
            idx = nkeys
            for a in op.aggregates:
                m = len(_state_plan(a))
                state_cols.extend(_merge_states(
                    a, page.cols[idx:idx + m], page.valid,
                    page.dictionaries[idx:idx + m], op._rank_cache))
                idx += m
        else:
            for a in op.aggregates:
                state_cols.extend(_init_states(a, page.cols, page.nulls,
                                               page.valid, page.dictionaries,
                                               op._rank_cache))
        fold = _fold_merge if intermediate else _fold_partial
        keys, key_nulls, reduced, out_valid, overflow = fold(
            key_ops, key_raws, [page.nulls[c] for c in key_channels],
            state_cols, page.valid, tuple(op._kinds), self.hash_path)
        self.overflow = overflow if self.overflow is None \
            else self.overflow | overflow
        reduced = op._states_rank_to_code(list(reduced))
        cols = list(keys) + reduced
        nulls = list(key_nulls) + [torch.zeros_like(out_valid)
                                   for _ in reduced]
        return cols, nulls, out_valid

    def feed(self, page: _BatchPage):
        self._capture_dicts(page)
        part = self._group(page.device_page(), intermediate=False)
        if self.order_free:
            part = _compact_lanes(*part)
        self.parts.append(part)
        self._check_budget(0)

    def _check_budget(self, merge_cap: int):
        """The burst's partials (and, at the merge, the concatenated page
        and its result) must fit the query's memory budget, as the
        serial operator's reservations must: a burst over it leaves the
        batch (``memory_budget``) and its members run serially, each
        within the budget. The serial path spills instead; a burst does
        not."""
        ctx = self.op._ctx
        if ctx is None:
            return
        held = sum(t.numel() * t.element_size()
                   for cols, nulls, valid in self.parts
                   for t in (*cols, *nulls, valid))
        if merge_cap:
            width = sum(c.element_size() + 1 for c in self.parts[0][0]) + 1
            held += 2 * self.depth * merge_cap * width
        if held > ctx.pool.max_bytes:
            raise BatchIneligible("memory_budget")

    def finalize(self) -> _BatchPage:
        op = self.op
        types = op._intermediate_types()
        nkeys = self.nkeys
        depth = self.depth
        dev = op.device
        for i in range(nkeys):
            # a scan that saw no input never captured key dictionaries;
            # string outputs still need (empty) pools
            if op._group_dicts[i] is None and types[i].is_pooled:
                op._group_dicts[i] = Dictionary()
        dicts = list(op._group_dicts) + op._state_dict_tail()
        if not self.parts:
            # no input: zero groups — except global aggregation, which
            # emits one group of empty-input states (the serial cap-16
            # zero page, on every lane)
            cap = 16
            cols = [torch.zeros((depth, cap), dtype=storage_dtype(t),
                                device=dev) for t in types]
            nulls = [torch.zeros((depth, cap), dtype=torch.bool,
                                 device=dev) for _ in types]
            valid = torch.zeros((depth, cap), dtype=torch.bool, device=dev)
            if nkeys == 0:
                valid[:, 0] = True
            merged = (cols, nulls, valid)
        elif len(self.parts) == 1:
            # single partial: the merged output IS the partial (the
            # serial path returns parts[0] unchanged for a single step)
            merged = self.parts[0]
        else:
            # the serial merge concatenates at padded_size(total) too
            cap = padded_size(sum(int(p[2].shape[-1]) for p in self.parts))
            self._check_budget(cap)
            ncols = len(self.parts[0][0])
            cols = [_pad_lanes(torch.cat([p[0][i] for p in self.parts],
                                         dim=-1), cap)
                    for i in range(ncols)]
            nulls = [_pad_lanes(torch.cat([p[1][i] for p in self.parts],
                                          dim=-1), cap)
                     for i in range(ncols)]
            valid = _pad_lanes(torch.cat([p[2] for p in self.parts],
                                         dim=-1), cap)
            self.parts = []
            merged = self._group(DevicePage(types, cols, nulls, valid,
                                            dicts), intermediate=True)
        cols, nulls, valid = merged
        if nkeys == 0:
            # global aggregation emits exactly one row, even over zero
            # input rows (lane 0 then holds empty-input states)
            valid = valid | (torch.arange(valid.shape[-1],
                                          device=valid.device) == 0)
        out_cols, out_nulls = _final_lanes(tuple(op.aggregates), cols,
                                           nulls, valid, nkeys)
        agg_dicts = []
        k = 0
        for a in op.aggregates:
            agg_dicts.append(op._state_dicts[k]
                             if op._str_state[k] else None)
            k += len(_state_plan(a))
        return _BatchPage(list(op.output_types), tuple(out_cols),
                          tuple(out_nulls), valid,
                          list(op._group_dicts) + agg_dicts, True)


def _compact_lanes(cols, nulls, valid) -> Tuple:
    """A ``(D, cap)`` partial cut to ``(D, k)``, k the most live rows of
    any lane: each lane's live rows first, in their order (a stable sort
    of the mask), then dead lanes. The merge's groups and their
    first-occurrence order are those of the full partials; only the
    rows' positions in the merge's kernel call move, which changes no
    integer sum, MIN or MAX — so only order-free states are compacted
    (a float sum would associate in another order than its serial
    merge). At SF1 this keeps a burst of q1's 24 partials of 262,144
    lanes from an 8 x 16,777,216-lane merge. At least one column stays:
    a global aggregation's single partial, every lane dead, is its
    result, whose first column is the row of empty-input states. One
    host sync per page."""
    k = max(1, int(host_scalar(valid.sum(1).max(), "batched.compact")))
    if k == valid.shape[1]:
        return cols, nulls, valid
    keep = torch.sort((~valid).to(torch.uint8), dim=1,
                      stable=True).indices[:, :k]
    return ([c.gather(1, keep) for c in cols],
            [n.gather(1, keep) for n in nulls], valid.gather(1, keep))


def _pad_lanes(arr: torch.Tensor, cap: int) -> torch.Tensor:
    """Pad the row (last) axis to ``cap`` with zeros/False."""
    n = arr.shape[-1]
    if n == cap:
        return arr
    pad = arr.new_zeros(arr.shape[:-1] + (cap - n,))
    return torch.cat([arr, pad], dim=-1)


# ---------------------------------------------------------------------------
# join lanes: the serial probe's pieces (ops/join.py) with a batch axis


def _expand_verified(lo, count, pkey_cols, bkey_cols, build_usable,
                     out_cap: int):
    """``join._expand_verified`` per lane of ``(D, n)`` candidate
    ranges: output lane j of lane d -> (probe row, build row, keep).
    Dead lanes point at probe row n-1 and build row 0 (in range)."""
    depth, n = count.shape
    off_end = torch.cumsum(count, -1)
    total = off_end[:, -1:]
    j = torch.arange(out_cap, dtype=torch.int64,
                     device=count.device).expand(depth, out_cap) \
        .contiguous()
    probe_idx = torch.searchsorted(off_end, j, right=True) \
        .clamp_(0, n - 1)
    start = off_end.gather(-1, probe_idx) - count.gather(-1, probe_idx)
    keep = j < total
    build_idx = torch.where(keep, lo.gather(-1, probe_idx) + (j - start), 0)
    keep = keep & build_usable[build_idx]
    for pc, bc in zip(pkey_cols, bkey_cols):
        keep = keep & (pc.gather(-1, probe_idx) == bc[build_idx])
    return probe_idx, build_idx, keep


def _segment_any(keep, probe_idx, probe_cap: int):
    """``join._segment_any`` per lane: OR of ``keep`` per probe row, with
    one sink slot per lane for the lanes that keep nothing."""
    depth = keep.shape[0]
    matched = torch.zeros(depth * (probe_cap + 1), dtype=torch.bool,
                          device=keep.device)
    base = torch.arange(depth, device=keep.device)[:, None] * (probe_cap + 1)
    matched[(torch.where(keep, probe_idx, probe_cap) + base).reshape(-1)] \
        = True
    return matched.view(depth, probe_cap + 1)[:, :probe_cap]


def _finalize_join(pcols, pnulls, pvalid, bcols, bnulls, probe_idx,
                   build_idx, keep, left: bool):
    """``join._finalize_join`` per lane: gather the joined lanes; LEFT
    appends one lane per probe row, valid iff the row matched nothing."""
    depth, lane_cap = probe_idx.shape
    n = pvalid.shape[-1]
    dev = keep.device
    if left:
        matched = _segment_any(keep, probe_idx, n)
        probe_idx = torch.cat([probe_idx, torch.arange(
            n, dtype=probe_idx.dtype, device=dev).expand(depth, n)], -1)
        build_idx = torch.cat([build_idx, torch.zeros(
            (depth, n), dtype=build_idx.dtype, device=dev)], -1)
        keep = torch.cat([keep, pvalid & ~matched], -1)
        build_is_null = torch.cat([
            torch.zeros((depth, lane_cap), dtype=torch.bool, device=dev),
            torch.ones((depth, n), dtype=torch.bool, device=dev)], -1)
    else:
        build_is_null = torch.zeros((depth, lane_cap), dtype=torch.bool,
                                    device=dev)
    out_cols = [c.gather(-1, probe_idx) for c in pcols] + \
        [c[build_idx] for c in bcols]
    out_nulls = [n_.gather(-1, probe_idx) for n_ in pnulls] + \
        [n_[build_idx] | build_is_null for n_ in bnulls]
    return out_cols, out_nulls, keep


def _join_semi_lanes(lo, count, pkey_cols, bkeys, build_usable, valid,
                     lane_cap: int, anti: bool):
    """A semi (anti) join stage's new ``(D, n)`` valid mask."""
    probe_idx, _build_idx, keep = _expand_verified(
        lo, count, pkey_cols, bkeys, build_usable, lane_cap)
    matched = _segment_any(keep, probe_idx, valid.shape[-1])
    return valid & (~matched if anti else matched)


def _join_expand_lanes(lo, count, pkey_cols, bkeys, build_usable, pcols,
                       pnulls, pvalid, bcols, bnulls, lane_cap: int,
                       left: bool):
    """An inner (left) join stage's ``(D, lane_cap)`` output lanes."""
    probe_idx, build_idx, keep = _expand_verified(
        lo, count, pkey_cols, bkeys, build_usable, lane_cap)
    return _finalize_join(pcols, pnulls, pvalid, bcols, bnulls, probe_idx,
                          build_idx, keep, left=left)


_batched_probe = instrument("batched_join_probe", _probe_counts_impl)
_join_semi_lanes = instrument("batched_join_semi", _join_semi_lanes,
                              static_argnames=("lane_cap", "anti"))
_join_expand_lanes = instrument("batched_join_expand", _join_expand_lanes,
                                static_argnames=("lane_cap", "left"))


def _apply_join(op: LookupJoinOperator, page: _BatchPage,
                spill: np.ndarray) -> _BatchPage:
    """One join stage over a batched probe page against the shared
    build. ONE deliberate host sync per probe page: the unified lane
    capacity is a host integer. Already-spilled lanes are excluded so
    their (re-run serially anyway) fan-out cannot inflate it."""
    b = op.bridge.build
    assert b is not None, "probe started before build finished"
    hs = getattr(op.bridge, "hybrid", None)
    if hs is not None and hs.spilled_build:
        # the batched probe only sees the resident index; a build that
        # went hybrid under memory pressure must not silently drop its
        # cold partitions — fail the batch loudly
        raise RuntimeError("batched probe over a hybrid-spilled build")
    kc = op.probe_keys
    pkey_cols, key_types = op._probe_key_cols(page.device_page(), b)
    pkey, panynull = _key_u64(pkey_cols, [page.nulls[c] for c in kc],
                              key_types, b.key_mode)
    pusable = page.valid & ~panynull
    lo, count = _batched_probe(b.key_sorted, b.usable_sorted, pkey,
                               pusable)
    totals = np.where(spill, 0, to_host(count.sum(-1),
                                        "batched.probe_totals"))
    need = int(totals.max()) if totals.size else 16
    cfg = (tuple(kc), tuple(repr(t) for t in key_types), b.key_mode)
    lane_cap = KERNEL_SIZING.suggest(("batched_join_expand",) + cfg,
                                     max(min(need, op.max_lanes), 16))
    while lane_cap > op.max_lanes and lane_cap > 16:
        lane_cap >>= 1  # budget checked POST-padding, like every path
    spill |= totals > lane_cap
    bkeys = [b.cols[c] for c in b.key_channels]
    if op.join_type in ("semi", "anti"):
        valid = _join_semi_lanes(lo, count, pkey_cols, bkeys,
                                 b.usable_sorted, page.valid, lane_cap,
                                 op.join_type == "anti")
        return _BatchPage(page.types, page.cols, page.nulls, valid,
                          page.dicts, True)
    out_cols, out_nulls, out_valid = _join_expand_lanes(
        lo, count, pkey_cols, bkeys, b.usable_sorted, page.cols,
        page.nulls, page.valid, b.cols, b.nulls, lane_cap,
        op.join_type == "left")
    return _BatchPage(list(op.output_types), tuple(out_cols),
                      tuple(out_nulls), out_valid,
                      list(page.dicts) + list(b.dictionaries), True)


# ---------------------------------------------------------------------------
# the batched driver


def execute_batched(plan, param_types, bindings: Sequence[Tuple],
                    num_members: int) -> BatchResult:
    """Drive the plan with the whole padded batch, one pass per stage
    per scan page.

    ``bindings`` is the PADDED batch (length D >= num_members); result
    pages demux positionally for the first ``num_members`` lanes only.
    Returns host pages per member, equal to running each member through
    the serial path (padding lanes compute and are discarded), plus the
    spilled-lane set, the stage dispositions, and the per-lane row
    actuals of every HBO-fingerprinted stage."""
    aux, scan, stages, dispositions = vmappable_stages(plan)
    fps = [op for kind, op in stages if kind == "fp"]
    check_params_consumed(fps, len(param_types))
    fp_params = iter(stack_bindings(fps, param_types, bindings))
    stage_params = [next(fp_params) if kind == "fp" else None
                    for kind, _op in stages]

    # the shared build side(s): literal-independent by template
    # construction (vmappable_stages proved the aux pipelines are
    # param-free), so ONE serial run serves every lane
    from .driver import Driver

    for p in aux:
        Driver(p.operators).run_to_completion()

    depth = len(bindings)
    spill = np.zeros(depth, dtype=bool)
    agg_accs: Dict[int, _AggAccumulator] = {
        k: _AggAccumulator(op, depth)
        for k, (kind, op) in enumerate(stages) if kind == "agg"}
    rows_acc: Dict[int, torch.Tensor] = {}
    scan_rows_acc = None
    final: List[_BatchPage] = []

    def note_rows(k: int, op, valid):
        # exact per-lane output rows of a fingerprinted stage, summed on
        # the device and read once at the end
        if getattr(op, "_hbo_fp", None) is None:
            return
        r = valid.sum(-1) if valid.dim() == 2 \
            else valid.sum().expand(depth)
        rows_acc[k] = r if k not in rows_acc else rows_acc[k] + r

    def apply_fp(k: int, op, page: _BatchPage) -> _BatchPage:
        proc = op.processor
        params = stage_params[k]
        if not page.batched and not params:
            # param-free prefix stage: members are identical here — one
            # UNBATCHED pass shared by the whole burst
            dp = proc.process(page.device_page())
            return _BatchPage(proc.output_types, tuple(dp.cols),
                              tuple(dp.nulls), dp.valid,
                              list(dp.dictionaries), False)
        # a param-free stage over a batched page carries the page's
        # depth; a stage with params over the shared page broadcasts it
        mode = "carried" if page.batched else "shared"
        cols, nulls, valid, dicts = proc.process_batched(
            page.cols, page.nulls, page.valid, page.dicts, params or (),
            mode)
        return _BatchPage(proc.output_types, tuple(cols), tuple(nulls),
                          valid, list(dicts), True)

    def run_from(i: int, page: _BatchPage):
        for k in range(i, len(stages)):
            kind, op = stages[k]
            if kind == "fp":
                page = apply_fp(k, op, page)
            elif kind == "join":
                page = _apply_join(op, page, spill)
            else:
                agg_accs[k].feed(page)
                return
            note_rows(k, op, page.valid)
        if not page.batched:
            # cannot happen after check_params_consumed with
            # param_types non-empty; guard for the zero-literal case
            raise BatchIneligible("params_unconsumed")
        final.append(page)

    while True:
        dpage = scan.get_output()
        if dpage is None:
            if scan.is_finished():
                break
            continue
        cnt = dpage.valid.sum()
        scan_rows_acc = cnt if scan_rows_acc is None \
            else scan_rows_acc + cnt
        run_from(0, _BatchPage(list(dpage.types), tuple(dpage.cols),
                               tuple(dpage.nulls), dpage.valid,
                               list(dpage.dictionaries), False))

    # agg barriers drain in stage order: each finalize feeds the
    # remaining stages (which may include another barrier downstream)
    for k in sorted(agg_accs):
        acc = agg_accs[k]
        page = acc.finalize()
        if acc.overflow is not None:
            spill |= to_host(acc.overflow, "batched.overflow")
        note_rows(k, stages[k][1], page.valid)
        run_from(k + 1, page)

    spilled = {m for m in range(num_members) if spill[m]}
    out_pages: List[List[Page]] = [[] for _ in range(num_members)]
    for page in final:
        # one device -> host copy per column for the whole burst
        cols = [to_cpu(c, "batched.results") for c in page.cols]
        nulls = [to_cpu(n, "batched.results") for n in page.nulls]
        valid = to_cpu(page.valid, "batched.results")
        for m in range(num_members):
            if m in spilled:
                continue
            host = DevicePage(list(page.types), [c[m] for c in cols],
                              [n[m] for n in nulls], valid[m],
                              list(page.dicts)).to_page()
            if host.num_rows:
                out_pages[m].append(host)
    scan_rows = int(host_scalar(scan_rows_acc, "batched.scan_rows")) \
        if scan_rows_acc is not None else 0
    stage_rows = [
        {"fp": getattr(stages[k][1], "_hbo_fp", None),
         "name": type(stages[k][1]).__name__,
         "rows": to_host(rows_acc[k], "batched.stage_rows")}
        for k in sorted(rows_acc)]
    if getattr(scan, "_hbo_fp", None) is not None:
        # the shared scan is lane-invariant: every lane observed it
        stage_rows.insert(0, {"fp": scan._hbo_fp,
                              "name": type(scan).__name__,
                              "rows": np.full(depth, scan_rows)})
    return BatchResult(out_pages, spilled, dispositions, stage_rows,
                       scan_rows)
