"""Hash aggregation on torch.

Reference analog: ``operator/HashAggregationOperator.java`` +
``operator/MultiChannelGroupByHash.java`` (vectorized open-addressing
putIfAbsent) + the bytecode-compiled accumulators
(``operator/aggregation/AccumulatorCompiler.java``).

Grouping runs one of two paths, as in the JAX engine
(``trino_tpu/ops/aggregation.py``):

- **hash** (default): the vectorized open-addressing table of
  ``ops/hashtable.py`` assigns each row a dense group id; the states are
  sorted by gid and each state column is one ``segment_reduce`` (the
  hand-written CUDA kernel on the card). Float grouping keys and
  probe-budget overflow fall back to:
- **sort** (oracle/fallback): normalize key columns to (null-bit, int64)
  operand pairs, sort the batch lexicographically (stable argsorts from
  the last key to the first), detect group boundaries by adjacent-row
  comparison, cumsum dense group ids, segment-reduce. Forceable via the
  ``hash_grouping_enabled`` session property for cross-checking.

Streaming: each input page is partially aggregated on the device
(bounded output = its own row count), partials accumulate; ``finish``
re-groups the concatenated partials and applies final projections.

Adaptive partial aggregation (the JAX engine's pass-through switch for
``step="partial"``) is not ported yet: a partial step always aggregates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import types as T
from ..block import DevicePage, Dictionary, padded_size, storage_dtype
from ..types import TypeError_
from .hashtable import hash_group_ids, hash_segment_reduce, \
    hashable_key_types
from .kernels import segment_reduce
from .operator import Operator
from .sortkeys import group_operands, lexsort_indices

#: adaptive partial aggregation defaults (the session registry re-exports
#: them); the torch engine does not act on them yet
ADAPTIVE_MIN_ROWS = 100_000
ADAPTIVE_RATIO_THRESHOLD = 0.9
ADAPTIVE_KEY_BUCKETS = 8


# ---------------------------------------------------------------------------
# aggregate function descriptors
# (reference analog: operator/aggregation/* builtin implementations)


@dataclass(frozen=True)
class AggCall:
    """One aggregate in a GROUP BY: function over an input channel."""

    function: str                 # count | count_star | sum | avg | min | max
    arg_channel: Optional[int]    # None for count(*)
    arg_type: Optional[T.Type]
    output_type: T.Type
    distinct: bool = False


def resolve_agg_type(function: str, arg_type: Optional[T.Type]) -> T.Type:
    if function in ("count", "count_star"):
        return T.BIGINT
    if function == "sum":
        if arg_type.is_decimal:
            return T.decimal_type(18, arg_type.scale)
        if arg_type in (T.REAL, T.DOUBLE):
            return T.DOUBLE
        if arg_type in (T.TINYINT, T.SMALLINT, T.INTEGER, T.BIGINT):
            return T.BIGINT
        raise TypeError_(f"cannot sum {arg_type}")
    if function == "avg":
        if arg_type.is_decimal:
            return arg_type
        return T.DOUBLE
    if function in ("min", "max", "arbitrary", "any_value"):
        return arg_type
    if function in ("stddev", "stddev_samp", "stddev_pop", "variance",
                    "var_samp", "var_pop", "geometric_mean"):
        return T.DOUBLE
    if function in ("bool_and", "bool_or", "every"):
        if arg_type != T.BOOLEAN:
            raise TypeError_(f"{function} expects boolean, got {arg_type}")
        return T.BOOLEAN
    if function == "count_if":
        if arg_type != T.BOOLEAN:
            raise TypeError_(f"count_if expects boolean, got {arg_type}")
        return T.BIGINT
    if function == "approx_distinct":
        return T.BIGINT
    if function == "approx_percentile":
        # same-type contract as the reference; the sketch rewrite
        # rounds back for integers (logical_planner._plan_dd_percentile)
        if arg_type in (T.TINYINT, T.SMALLINT, T.INTEGER, T.BIGINT):
            return T.BIGINT
        if arg_type in (T.REAL, T.DOUBLE):
            return T.DOUBLE
        if arg_type.is_decimal:
            return arg_type
        raise TypeError_(
            f"approx_percentile does not support {arg_type} yet")
    raise TypeError_(f"unknown aggregate function {function}")


# Each aggregate lowers to a list of (reduce_kind, state_dtype) states:
#   sum   -> [sum(x), count(nonnull)]
#   count -> [count(nonnull)]
#   avg   -> [sum(x), count(nonnull)]
#   min   -> [min(x or +sentinel), count]
#   max   -> [max(x or -sentinel), count]
#   stddev/variance -> [sum(x), sum(x^2), count]  (as float64)


def _state_plan(agg: AggCall):
    f = agg.function
    if f in ("count_star", "count", "count_if"):
        return [("sum", torch.int64)]
    if f in ("sum", "avg"):
        dt = torch.float64 if (agg.arg_type in (T.REAL, T.DOUBLE)) \
            else torch.int64
        return [("sum", dt), ("sum", torch.int64)]
    if f in ("min", "arbitrary", "any_value", "bool_and", "every"):
        return [("min", None), ("sum", torch.int64)]
    if f in ("max", "bool_or"):
        return [("max", None), ("sum", torch.int64)]
    if f == "geometric_mean":
        return [("sum", torch.float64), ("sum", torch.int64)]
    if f in ("stddev", "stddev_samp", "stddev_pop", "variance", "var_samp",
             "var_pop"):
        return [("sum", torch.float64), ("sum", torch.float64),
                ("sum", torch.int64)]
    raise TypeError_(f"unknown aggregate function {f}")


def intermediate_state_types(function: str,
                             arg_type: Optional[T.Type]) -> List[T.Type]:
    """SQL types of one aggregate's partial-state columns. String min/max
    states are VARCHAR: partials carry dictionary CODES; the reduce
    itself runs on lexicographic ranks (codes are pool-order, not
    value-order) and maps back to codes at every page boundary."""
    call = AggCall(function, None, arg_type, T.BIGINT)
    out: List[T.Type] = []
    for (kind, dt) in _state_plan(call):
        if kind in ("min", "max"):
            if arg_type in (T.REAL, T.DOUBLE):
                out.append(T.DOUBLE)
            elif arg_type == T.BOOLEAN:
                out.append(T.BIGINT)  # 0/1 lanes (bool_and/bool_or)
            else:
                out.append(arg_type or T.BIGINT)
        else:
            out.append(T.DOUBLE if dt == torch.float64 else T.BIGINT)
    return out


def _rank_and_inverse(dictionary, cache: dict):
    """(rank_lut, inverse_lut) numpy arrays: rank_lut[code] = dense lex
    rank; inverse_lut[rank] = FIRST code of that rank (aligned pools may
    repeat values). Cached in ``cache`` per (pool uid, size) — pools are
    append-only."""
    if dictionary is None or len(dictionary) == 0:
        return (np.zeros(1, dtype=np.int64), np.zeros(1, dtype=np.int32))
    key = (dictionary.uid, len(dictionary))
    hit = cache.get(key)
    if hit is not None:
        return hit
    ranks = dictionary.sort_rank().astype(np.int64)
    nr = int(ranks.max()) + 1 if len(ranks) else 1
    inv = np.zeros(nr, dtype=np.int32)
    # reversed scatter: the FIRST code of each rank lands last, winning
    inv[ranks[::-1]] = np.arange(len(ranks) - 1, -1, -1, dtype=np.int32)
    cache[key] = (ranks, inv)
    return ranks, inv


def _lut(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(arr).to(device)


def _int_sentinel(dtype: torch.dtype, kind: str) -> int:
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def _init_states(agg: AggCall, cols, nulls, valid, dicts,
                 rank_cache: dict) -> List:
    """Per-row initial state columns for one aggregate."""
    f = agg.function
    if f == "count_star":
        return [valid.to(torch.int64)]
    raw = cols[agg.arg_channel]
    nl = nulls[agg.arg_channel]
    live = valid & ~nl
    if f == "count":
        return [live.to(torch.int64)]
    if f == "count_if":
        return [(live & raw.to(torch.bool)).to(torch.int64)]
    if f in ("bool_and", "every", "bool_or"):
        # min/max over {0,1}; dead lanes take the neutral sentinel
        neutral = 1 if f != "bool_or" else 0
        x = torch.where(live, raw.to(torch.int64), neutral)
        return [x, live.to(torch.int64)]
    if f == "geometric_mean":
        x = raw.to(torch.float64)
        if agg.arg_type is not None and agg.arg_type.is_decimal:
            x = x / (10.0 ** agg.arg_type.scale)
        # log(0) = -inf => result 0; log(<0) = NaN => result NaN (the
        # reference's semantics); dead lanes are masked by `live`
        return [torch.where(live, torch.log(x), 0.0),
                live.to(torch.int64)]
    if f in ("arbitrary", "any_value"):
        f = "min"  # deterministic pick: the smallest value
    if f in ("sum", "avg"):
        if agg.arg_type in (T.REAL, T.DOUBLE):
            return [torch.where(live, raw.to(torch.float64), 0.0),
                    live.to(torch.int64)]
        return [torch.where(live, raw.to(torch.int64), 0),
                live.to(torch.int64)]
    if f in ("min", "max"):
        if agg.arg_type is not None and agg.arg_type.is_pooled:
            # reduce on lexicographic RANKS (codes are pool-order);
            # _states_rank_to_code restores codes after the reduce
            rank_lut, _ = _rank_and_inverse(dicts[agg.arg_channel],
                                            rank_cache)
            ranks = _lut(rank_lut, raw.device)[raw.to(torch.int64)]
            x = torch.where(live, ranks, _int_sentinel(torch.int64, f))
            return [x, live.to(torch.int64)]
        if agg.arg_type in (T.REAL, T.DOUBLE):
            sent = float("inf") if f == "min" else float("-inf")
            x = torch.where(live, raw.to(torch.float64), sent)
        else:
            if raw.dtype == torch.bool:
                raw = raw.to(torch.int64)
            x = torch.where(live, raw, _int_sentinel(raw.dtype, f))
        return [x, live.to(torch.int64)]
    # stddev family
    x = torch.where(live, raw.to(torch.float64), 0.0)
    if agg.arg_type is not None and agg.arg_type.is_decimal:
        x = x / (10.0 ** agg.arg_type.scale)
    return [x, x * x, live.to(torch.int64)]


def _merge_states(agg: AggCall, state_cols, valid, state_dicts,
                  rank_cache: dict) -> List:
    """Partial-state columns re-entering a (final) aggregation: states
    combine with their own reduce kinds. min/max values are neutralized
    to their sentinel on invalid lanes AND on empty partials (count
    state 0), which would otherwise contribute a bogus 0. String min/max
    states arrive as codes and re-enter the reduce as lexicographic
    ranks."""
    plan = _state_plan(agg)
    count = state_cols[-1]  # every aggregate's last state is its count
    is_str = agg.arg_type is not None and agg.arg_type.is_pooled
    out = []
    for j, ((kind, _dt), s) in enumerate(zip(plan, state_cols)):
        if kind == "sum":
            out.append(torch.where(valid, s, torch.zeros((), dtype=s.dtype,
                                                         device=s.device)))
            continue
        live = valid & (count > 0)
        if is_str:
            rank_lut, _ = _rank_and_inverse(state_dicts[j], rank_cache)
            s = _lut(rank_lut, s.device)[s.to(torch.int64)]
        if s.dtype == torch.float64:
            sent = float("inf") if kind == "min" else float("-inf")
        else:
            sent = _int_sentinel(s.dtype, kind)
        out.append(torch.where(live, s, sent))
    return out


def _final_project(agg: AggCall, states: List):
    """states (per-group reduced) -> (raw, null) in output_type storage."""
    f = agg.function
    if f in ("count", "count_star", "count_if"):
        return states[0], torch.zeros_like(states[0], dtype=torch.bool)
    cnt = states[-1]
    null = cnt == 0
    if f in ("sum", "min", "max", "arbitrary", "any_value"):
        return states[0], null
    if f == "avg":
        s = states[0]
        if agg.output_type.is_decimal:
            from ..expr.functions import div_round_half_up

            return div_round_half_up(s, torch.clamp(cnt, min=1)), null
        return s.to(torch.float64) / torch.clamp(cnt, min=1), null
    if f in ("bool_and", "every", "bool_or"):
        return (states[0] != 0), null
    if f == "geometric_mean":
        return torch.exp(states[0] / torch.clamp(cnt, min=1)), null
    # stddev family
    s, s2 = states[0], states[1]
    n = torch.clamp(cnt, min=1).to(torch.float64)
    mean = s / n
    m2 = torch.clamp(s2 / n - mean * mean, min=0.0)
    pop = f in ("stddev_pop", "var_pop")
    denom = n if pop else torch.clamp(n - 1, min=1)
    var = m2 * n / denom
    if f.startswith("stddev"):
        var = torch.sqrt(var)
    if not pop:
        null = null | (cnt < 2)
    return var, null


# ---------------------------------------------------------------------------
# the sort-path grouping kernel


def group_reduce(key_ops: Sequence, key_raws: Sequence,
                 state_cols: Sequence, valid, kinds: Sequence):
    """Sort-group-reduce one batch.

    key_ops: flattened (null_bit, key) pairs for each group key
    key_raws: the raw key columns (carried through the sort)
    state_cols: per-row state columns (carried through the sort)
    Returns (group_key_raws, group_key_nullbits, reduced_states, out_valid).
    """
    cap = valid.shape[0]
    device = valid.device
    # invalid lanes sort last: leading operand = ~valid
    perm = lexsort_indices([(~valid).to(torch.uint8)] + list(key_ops))
    s_keyops = [op[perm] for op in key_ops]
    s_keyraws = [kr[perm] for kr in key_raws]
    s_states = [s[perm] for s in state_cols]
    s_valid = valid[perm]

    # boundary: first row, or any key operand differs from previous row
    diff = torch.zeros(cap, dtype=torch.bool, device=device)
    diff[0] = True
    for op in s_keyops:
        d = op != torch.roll(op, 1)
        d[0] = True
        diff = diff | d
    boundary = diff & s_valid
    gid = torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32) - 1
    # invalid lanes -> dump segment
    gid = torch.where(s_valid, gid, cap)

    reduced = [segment_reduce(col, gid, num_segments=cap + 1,
                              kind=kind)[:cap]
               for kind, col in zip(kinds, s_states)]

    # group keys: first sorted row of each segment
    first_idx = segment_reduce(
        torch.arange(cap, dtype=torch.int32, device=device), gid,
        num_segments=cap + 1, kind="min")[:cap]
    ngroups = boundary.sum()
    out_valid = torch.arange(cap, device=device) < ngroups
    safe_idx = torch.where(out_valid, first_idx, 0).to(torch.int64)
    out_key_raws = tuple(kr[safe_idx] for kr in s_keyraws)
    out_key_nulls = tuple(s_keyops[2 * i][safe_idx] > 0
                          for i in range(len(key_raws)))
    return out_key_raws, out_key_nulls, tuple(reduced), out_valid


class HashAggregationOperator(Operator):
    """GROUP BY over device batches (see module docstring).

    step: 'single' (raw in, final out), 'partial' (raw in, states out),
    'final' (states in, final out) — mirroring the reference's
    PARTIAL/FINAL/SINGLE AggregationNode steps.
    """

    def __init__(self, input_types: Sequence[T.Type],
                 group_channels: Sequence[int],
                 aggregates: Sequence[AggCall], device,
                 step: str = "single", memory_context=None,
                 hash_grouping: bool = True):
        assert step in ("single", "partial", "final")
        #: where the empty-input page is built (input pages carry their
        #: own device)
        self.device = device
        self.input_types = list(input_types)
        self.group_channels = list(group_channels)
        self.aggregates = list(aggregates)
        self.step = step
        self.hash_grouping = hash_grouping
        #: pages grouped per path, for EXPLAIN/observability
        self.path_counts = {"hash": 0, "sort": 0}
        self._partials: List[DevicePage] = []
        self._emitted = False
        self._done = False
        self._group_dicts: List = [None] * len(group_channels)
        self._kinds = tuple(k for a in self.aggregates
                            for (k, _) in _state_plan(a))
        # per-state: True for a string min/max VALUE state (reduced as a
        # rank, carried across pages as a code in the arg's pool)
        self._str_state: List[bool] = []
        for a in self.aggregates:
            is_str = a.arg_type is not None and a.arg_type.is_pooled
            for (k, _) in _state_plan(a):
                self._str_state.append(is_str and k in ("min", "max"))
        self._state_dicts: List = [None] * len(self._str_state)
        #: (pool uid, size) -> (rank LUT, inverse LUT), per operator
        self._rank_cache: dict = {}
        self._ctx = memory_context

    # output layout: group key columns, then state/final columns per agg
    @property
    def output_types(self) -> List[T.Type]:
        if self.step == "partial":
            return self._intermediate_types()
        keys = [self.input_types[c] for c in self.group_channels]
        return keys + [a.output_type for a in self.aggregates]

    def needs_input(self) -> bool:
        return not self._finishing

    def add_input(self, page: DevicePage):
        # capture group-key dictionaries (assumed stable pools per column)
        for i, c in enumerate(self.group_channels):
            d = page.dictionaries[c]
            if d is not None:
                prev = self._group_dicts[i]
                if prev is not None and prev is not d:
                    raise TypeError_(
                        "group key dictionaries changed across pages; "
                        "exchange must unify pools")
                self._group_dicts[i] = d
        # string min/max state pools: same stability contract
        intermediate = self.step == "final"
        nkeys = len(self.group_channels)
        k = 0
        for a in self.aggregates:
            for _ in _state_plan(a):
                if self._str_state[k]:
                    ch = (nkeys + k) if intermediate else a.arg_channel
                    d = page.dictionaries[ch]
                    if d is not None:
                        prev = self._state_dicts[k]
                        if prev is not None and prev is not d:
                            raise TypeError_(
                                "aggregate arg dictionaries changed "
                                "across pages; exchange must unify pools")
                        self._state_dicts[k] = d
                k += 1
        partial = self._aggregate_page(page, intermediate=intermediate)
        if self._ctx is not None:
            from ..exec.memory import device_page_bytes

            self._ctx.reserve(device_page_bytes(partial))
        self._partials.append(partial)

    def _aggregate_page(self, page: DevicePage,
                        intermediate: bool) -> DevicePage:
        """intermediate=False: page is raw input rows (layout:
        self.input_types, keys at self.group_channels).
        intermediate=True: page is partial-agg output (layout:
        _intermediate_types — keys at channels [0..nkeys), then states)."""
        nkeys = len(self.group_channels)
        if intermediate:
            key_channels = list(range(nkeys))
            key_types = self._intermediate_types()[:nkeys]
        else:
            key_channels = self.group_channels
            key_types = [self.input_types[c] for c in self.group_channels]
        key_ops, key_raws = self._grouping_operands(page, key_channels,
                                                    key_types)

        state_cols: List = []
        if intermediate:
            # states laid out after the keys
            idx = nkeys
            for a in self.aggregates:
                plan = _state_plan(a)
                state_cols.extend(_merge_states(
                    a, page.cols[idx:idx + len(plan)], page.valid,
                    page.dictionaries[idx:idx + len(plan)],
                    self._rank_cache))
                idx += len(plan)
        else:
            for a in self.aggregates:
                state_cols.extend(_init_states(a, page.cols, page.nulls,
                                               page.valid, page.dictionaries,
                                               self._rank_cache))

        result = None
        if self.hash_grouping and hashable_key_types(key_types):
            result = self._hash_group_page(page, key_ops, key_raws,
                                           key_channels, state_cols)
        if result is None:
            self.path_counts["sort"] += 1
            result = group_reduce(key_ops, key_raws, state_cols,
                                  page.valid, self._kinds)
        out_keys, out_key_nulls, reduced, out_valid = result

        # string min/max: reduced RANK -> representative CODE in the
        # captured pool (dead/sentinel lanes clamp; count==0 nulls them)
        reduced = self._states_rank_to_code(list(reduced))

        cols, nulls = list(out_keys), list(out_key_nulls)
        for r in reduced:
            cols.append(r)
            nulls.append(torch.zeros_like(out_valid))
        dicts = list(self._group_dicts) + self._state_dict_tail()
        return DevicePage(self._intermediate_types(), cols, nulls,
                          out_valid, dicts)

    def _grouping_operands(self, page: DevicePage, key_channels,
                           key_types):
        """(key_ops, key_raws) grouping operands of one page — pooled
        keys group by lexicographic RANK, not raw code: aligned
        (derived) pools may hold one value under several codes.  The
        representative raw code still rides along for output."""
        key_ops: List = []
        key_raws: List = []
        for c, t in zip(key_channels, key_types):
            col = page.cols[c]
            if getattr(t, "is_pooled", False):
                rank_lut, _ = _rank_and_inverse(page.dictionaries[c],
                                                self._rank_cache)
                ops = group_operands(
                    _lut(rank_lut, col.device)[col.to(torch.int64)],
                    page.nulls[c], T.BIGINT)
            else:
                ops = group_operands(col, page.nulls[c], t)
            key_ops.extend(ops)
            key_raws.append(col)
        return key_ops, key_raws

    def _hash_group_page(self, page: DevicePage, key_ops, key_raws,
                         key_channels, state_cols):
        """Hash-path grouping of one page; None => the caller falls
        back to the sort oracle (probe-budget overflow)."""
        gid, group_rows, ngroups, overflow = hash_group_ids(
            key_ops, page.valid, exact=self.step != "partial")
        if overflow:
            return None
        key_nulls = tuple(page.nulls[c] for c in key_channels)
        self.path_counts["hash"] += 1
        return hash_segment_reduce(gid, group_rows, ngroups,
                                   tuple(key_raws), key_nulls,
                                   tuple(state_cols), self._kinds)

    def _states_rank_to_code(self, state_cols: List) -> List:
        """String min/max value states: lexicographic RANK -> the
        representative CODE in the captured pool (the intermediate-page
        wire contract). Dead/sentinel lanes clamp into range; their
        count state of 0 nulls them downstream."""
        for k, is_str in enumerate(self._str_state):
            if is_str:
                _, inv = _rank_and_inverse(self._state_dicts[k],
                                           self._rank_cache)
                r = torch.clamp(state_cols[k], 0, len(inv) - 1)
                state_cols[k] = _lut(inv, r.device)[r]
        return state_cols

    def _intermediate_types(self) -> List[T.Type]:
        keys = [self.input_types[c] for c in self.group_channels]
        states: List[T.Type] = []
        for a in self.aggregates:
            states.extend(intermediate_state_types(a.function, a.arg_type))
        return keys + states

    def get_output(self) -> Optional[DevicePage]:
        if not self._finishing or self._emitted:
            return None
        self._emitted = True
        self._done = True
        merged = self._merge_partials()
        self._partials = []
        if self.step in ("single", "final"):
            merged = self._finalize(merged)
        if self._ctx is not None:
            self._ctx.close()  # output page is in flight, not retained
        return merged

    def _merge_partials(self) -> DevicePage:
        types = self._intermediate_types()
        nkeys = len(self.group_channels)
        # a task that saw no input never captured key dictionaries;
        # string outputs still need (empty) pools
        for i in range(nkeys):
            if self._group_dicts[i] is None and types[i].is_pooled:
                self._group_dicts[i] = Dictionary()
        if not self._partials:
            # no input: zero groups — except global aggregation, which
            # emits exactly one group of empty-input states (count=0,
            # sum=NULL), per SQL semantics
            cap = 16
            dev = self.device
            cols = [torch.zeros(cap, dtype=storage_dtype(t), device=dev)
                    for t in types]
            nulls = [torch.zeros(cap, dtype=torch.bool, device=dev)
                     for _ in types]
            valid = torch.zeros(cap, dtype=torch.bool, device=dev)
            if nkeys == 0:
                valid[0] = True
            return DevicePage(types, cols, nulls, valid,
                              list(self._group_dicts)
                              + self._state_dict_tail())
        from ..exec.memory import device_page_bytes

        parts = self._partials
        if len(parts) == 1 and self.step != "partial":
            return parts[0]
        # merge in budget-bounded chunks: each round touches at most
        # ~budget bytes of device memory (concat + result)
        budget = None
        if self._ctx is not None:
            # each chunk's transient is 2x its bytes (concat + result):
            # cap chunks at max/4 so the transient stays under max/2
            budget = max(self._ctx.pool.max_bytes // 4, 1 << 16)
        while True:
            chunks: List[List] = []
            cur: List = []
            cur_bytes = 0
            for p in parts:
                nb = device_page_bytes(p)
                if cur and len(cur) >= 2 and budget is not None \
                        and cur_bytes + nb > budget:
                    chunks.append(cur)
                    cur, cur_bytes = [], 0
                cur.append(p)
                cur_bytes += nb
            chunks.append(cur)
            if len(chunks) == 1:
                return self._merge_chunk(chunks[0])
            parts = [self._merge_chunk(c) for c in chunks]

    def _merge_chunk(self, chunk: List[DevicePage]) -> DevicePage:
        """Concatenate one chunk of partials and re-group with merge
        semantics."""
        from ..exec.memory import device_page_bytes

        types = self._intermediate_types()
        total = sum(device_page_bytes(p) for p in chunk)
        transient = 2 * total  # concat buffer + result
        if self._ctx is not None:
            self._ctx.reserve(transient)
        cap = padded_size(sum(p.capacity for p in chunk))
        cols = [_pad_to(torch.cat([p.cols[i] for p in chunk]), cap)
                for i in range(len(types))]
        nulls = [_pad_to(torch.cat([p.nulls[i] for p in chunk]), cap)
                 for i in range(len(types))]
        valid = _pad_to(torch.cat([p.valid for p in chunk]), cap)
        page = DevicePage(types, cols, nulls, valid,
                          list(self._group_dicts) + self._state_dict_tail())
        out = self._aggregate_page(page, intermediate=True)
        if self._ctx is not None:
            # release the transient + the chunk inputs' reservations,
            # keep the merged result reserved
            self._ctx.free(transient + total)
            self._ctx.reserve(device_page_bytes(out))
        return out

    def _finalize(self, merged: DevicePage) -> DevicePage:
        nkeys = len(self.group_channels)
        if nkeys == 0:
            # global aggregation always emits exactly one row, even over
            # zero input rows (lane 0 then holds empty-input states)
            one = torch.arange(merged.capacity,
                               device=merged.valid.device) == 0
            merged = DevicePage(merged.types, merged.cols, merged.nulls,
                                merged.valid | one, merged.dictionaries)
        out_cols = list(merged.cols[:nkeys])
        out_nulls = list(merged.nulls[:nkeys])
        idx = nkeys
        for a in self.aggregates:
            plan = _state_plan(a)
            states = merged.cols[idx:idx + len(plan)]
            idx += len(plan)
            raw, null = _final_project(a, states)
            out_cols.append(raw.to(storage_dtype(a.output_type)))
            out_nulls.append(null | ~merged.valid)
        agg_dicts = []
        k = 0
        for a in self.aggregates:
            agg_dicts.append(self._state_dicts[k]
                             if self._str_state[k] else None)
            k += len(_state_plan(a))
        dicts = list(self._group_dicts) + agg_dicts
        return DevicePage(self.output_types, out_cols, out_nulls,
                          merged.valid, dicts)

    def _state_dict_tail(self) -> List:
        """Dictionaries for the state columns of an intermediate-layout
        page (string min/max value states keep their pool)."""
        return [self._state_dicts[k] if self._str_state[k] else None
                for k in range(len(self._str_state))]

    def metrics(self) -> dict:
        """Grouping-path observability: pages per path."""
        return {"grouping_paths": {k: v for k, v in
                                   self.path_counts.items() if v}}

    def is_finished(self) -> bool:
        return self._done


def _pad_to(arr, cap: int):
    n = arr.shape[0]
    if n == cap:
        return arr
    return torch.cat([arr, torch.zeros((cap - n,), dtype=arr.dtype,
                                       device=arr.device)])
