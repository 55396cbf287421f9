"""Global-hash device aggregation: ONE table across the device slabs.

Reference analog: "Global Hash Tables Strike Back!" (PAPERS.md,
arXiv 2505.04153) — a single shared hash table updated by every thread
beats partition-then-aggregate for GROUP BY across a wide NDV range.
The JAX engine's ``trino_tpu/ops/global_hash_agg.py`` on torch: instead
of the exchange+merge-final shape (an all-to-all of partial groups, then
per-device re-grouping — ``parallel/mesh_query.q1_exchange_final_fn``),
every device slab holds a REPLICATED open-addressing table and updates it
by scatter: a local scatter into the table, then one elementwise
sum/min/max per state column over the d replicas (the JAX ``psum``/
``pmin``/``pmax``), written back to every slab so the replicas never
diverge. For low-NDV grouping the table is tiny, so the reduction moves
O(table) bytes instead of O(partial groups) rows — and no re-grouping
kernel runs at all.

Insert protocol (the claim loop — ``ops/hashtable.py``'s vectorized
insert-or-lookup lifted to the slabs):

- group keys pack injectively into one uint64 (``pack_keys``; the cost
  model gates on packability), hashed by the same splitmix64 finalizer
  the local GroupByHash uses;
- each probe round, unresolved rows propose slot ``(h + r) & mask``;
  the candidate key per slot is the scatter-MIN of proposers, agreed by
  a min over the slabs, and lands only in still-empty slots — every slab
  applies the identical update;
- rows whose key owns their slot are resolved; colliders advance.
  Rows unresolved after the round budget are reported so the caller can
  fall back to the exchange path — exactness first. The rounds stop
  early once no slab has an unresolved row (one host read per round):
  a round with nothing to claim changes no slot.

Every argument is a list of d per-slab tensors, each on its own device
(devices may repeat); the JAX single-device mode (``axis_name=None``) is
a list of one slab and needs nothing from the exchange.

uint64 on int64 lanes: keys are int64 tensors holding the JAX engine's
uint64 bits. Wrapping ``+`` and ``*`` give the same bits, a logical
right shift is an arithmetic shift plus a mask (``kernels._shr``), and
the claim's MIN runs on the key with bit 63 flipped, which orders as the
uint64 does. ``EMPTY`` (all ones, int64 -1) flips to the int64 maximum,
so it stays the largest key and the value of a free slot. Scatters of
dead lanes go to the dummy slot ``table_size``, in range by
construction (CUDA asserts where JAX drops).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..telemetry.profiler import instrument
from ..telemetry.device_reads import host_scalar
from .kernels import _i64, _shr, splitmix64

#: empty-slot sentinel, the uint64 all-ones as its int64 bits: packed
#: keys reserve it by construction (``pack_keys`` biases every operand
#: by +1, so all-ones cannot occur within the gated bit budget)
EMPTY = -1

#: linear-probe round budget (mirrors ``hashtable.PROBE_ROUNDS``): with
#: load factor <= 0.5 an unresolved row after 32 probes is
#: astronomically rare; the caller falls back on overflow regardless
PROBE_ROUNDS = 32

_SIGN = -(1 << 63)
#: EMPTY with bit 63 flipped: the int64 maximum, the claim's identity
_FLIPPED_EMPTY = EMPTY ^ _SIGN


def _flip(x: torch.Tensor) -> torch.Tensor:
    """uint64 bits <-> the int64 that orders as the uint64 does."""
    return x ^ _SIGN


def _mask(w: int) -> int:
    return _i64((1 << w) - 1) if w < 64 else -1


def pack_keys(cols: Sequence, nulls: Sequence, widths: Tuple[int, ...]):
    """Injective uint64 packing of non-negative key operands: each
    column takes ``width`` bits holding value+1 (0 = NULL), so distinct
    key tuples — including NULLs — pack to distinct u64s and the
    all-ones EMPTY sentinel is unreachable. The caller gates that values
    fit the widths. A left shift is a wrapping multiply by 2**w."""
    acc = torch.zeros(cols[0].shape, dtype=torch.int64,
                      device=cols[0].device)
    for c, nl, w in zip(cols, nulls, widths):
        v = c.to(torch.int64) + 1
        if nl is not None:
            v = torch.where(nl, torch.zeros_like(v), v)
        acc = (acc * _i64(1 << w) if w < 64 else acc * 0) | v
    return acc


def unpack_keys(packed: torch.Tensor, widths: Tuple[int, ...]):
    """Inverse of ``pack_keys``: [(value_i64, null_bool)] per column."""
    out = []
    shift = 0
    for w in reversed(widths):
        v = (_shr(packed, shift) if shift else packed) & _mask(w)
        null = v == 0
        out.append(((v - 1) & _mask(w), null))
        shift += w
    return list(reversed(out))


def _over_slabs(parts: List[torch.Tensor], reduce: str) -> List[torch.Tensor]:
    """The JAX ``psum``/``pmin``/``pmax`` over d slabs: the elementwise
    reduction of every slab's tensor (on the first slab's device, in
    slab order), written back to each slab's device."""
    if len(parts) == 1:
        return parts
    home = parts[0].device
    stacked = torch.stack([p.to(home) for p in parts])
    if reduce == "sum":
        r = stacked.sum(dim=0, dtype=parts[0].dtype)
    elif reduce == "min":
        r = stacked.amin(dim=0)
    else:
        r = stacked.amax(dim=0)
    return [r.to(p.device) for p in parts]


def global_hash_insert(packed: Sequence[torch.Tensor],
                       valid: Sequence[torch.Tensor], table_size: int,
                       rounds: int = PROBE_ROUNDS):
    """Claim-loop insert into the replicated global table.

    ``packed``/``valid`` are the d slabs' tensors. Returns (tables,
    slot_of, resolved, unresolved): ``tables`` (one per slab, identical)
    hold the owning packed key per slot (EMPTY = free);
    ``slot_of``/``resolved`` are each slab's per-row assignments;
    ``unresolved`` is the GLOBAL count of live rows that exhausted the
    probe budget (nonzero => caller must fall back), a 0-d int32 tensor
    on the first slab's device."""
    ps, vs = list(packed), list(valid)
    mask = table_size - 1
    slot0 = [(splitmix64(p) & mask).to(torch.int32) for p in ps]
    flipped = [_flip(p) for p in ps]
    tables = [torch.full((table_size,), EMPTY, dtype=torch.int64,
                         device=p.device) for p in ps]
    resolved = [~v for v in vs]
    slot_of = [torch.zeros_like(s) for s in slot0]
    for r in range(rounds):
        if not any(host_scalar((~res).any(), "global_hash_agg.round")
                   for res in resolved):
            break
        slots, claims = [], []
        for i in range(len(ps)):
            active = ~resolved[i]
            slot = torch.where(active, (slot0[i] + r) & mask,
                               table_size).to(torch.int64)
            # candidate owner per slot: scatter-min of the flipped keys
            # (masked lanes land in the dummy slot)
            claim = torch.full((table_size + 1,), _FLIPPED_EMPTY,
                               dtype=torch.int64, device=ps[i].device)
            claim.scatter_reduce_(0, slot, flipped[i], "amin",
                                  include_self=True)
            slots.append(slot)
            claims.append(claim[:table_size])
        claims = _over_slabs(claims, "min")
        for i in range(len(ps)):
            active = ~resolved[i]
            claim = _flip(claims[i])
            tables[i] = torch.where(tables[i] == EMPTY, claim, tables[i])
            owner = tables[i][torch.clamp(slots[i], 0, table_size - 1)]
            won = active & (owner == ps[i])
            slot_of[i] = torch.where(won, slots[i].to(torch.int32),
                                     slot_of[i])
            resolved[i] = resolved[i] | won
    unresolved = _over_slabs([(v & ~res).sum(dtype=torch.int32).reshape(1)
                              for v, res in zip(vs, resolved)], "sum")[0]
    return tables, slot_of, resolved, unresolved.reshape(())


def _sentinel(kind: str, dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def global_hash_reduce(slot_of: Sequence, resolved: Sequence,
                       valid: Sequence, state_cols: Sequence[Tuple],
                       kinds: Tuple, table_size: int):
    """Scatter-reduce of per-row states into the global table: a local
    scatter by assigned slot, then one sum/min/max per state column over
    the slabs merges the replicas. Each argument is a list per slab
    (``state_cols`` a list per slab of column tuples); the result is a
    list per slab of reduced tuples, identical on every slab. States
    arrive sentinel-neutralized (``aggregation._merge_states``/
    ``_init_states``), so empty slots hold each kind's neutral element
    and ``_final_project`` nulls them via the count state."""
    per_slab = []
    for s_of, res, va, cols in zip(slot_of, resolved, valid, state_cols):
        idx = torch.where(res & va, s_of, table_size).to(torch.int64)
        out = []
        for kind, col in zip(kinds, cols):
            if kind == "sum":
                acc = torch.zeros((table_size + 1,), dtype=col.dtype,
                                  device=col.device)
                acc.index_add_(0, idx, col)
            else:
                acc = torch.full((table_size + 1,), _sentinel(kind, col.dtype),
                                 dtype=col.dtype, device=col.device)
                acc.scatter_reduce_(0, idx, col,
                                    "amin" if kind == "min" else "amax",
                                    include_self=True)
            out.append(acc[:table_size])
        per_slab.append(out)
    merged = [_over_slabs([slab[j] for slab in per_slab], kind)
              for j, kind in enumerate(kinds)]
    return [tuple(m[i] for m in merged) for i in range(len(per_slab))]


# profiled programs (telemetry.profiler), under the JAX engine's names:
# the first call at a new signature counts one ``jit_stats`` first call,
# as a JAX trace would
global_hash_insert = instrument("global_hash_insert", global_hash_insert,
                                static_argnames=("table_size", "rounds"))
global_hash_reduce = instrument("global_hash_reduce", global_hash_reduce,
                                static_argnames=("kinds", "table_size"))
