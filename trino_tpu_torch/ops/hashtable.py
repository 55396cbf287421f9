"""Vectorized open-addressing GroupByHash primitive, on torch.

Reference analog: ``operator/MultiChannelGroupByHash.java`` (the
putIfAbsent loop assigning dense group ids) — a vectorized
page-at-a-time pass instead of a row-at-a-time loop.

Design (the JAX engine's, ``trino_tpu/ops/hashtable.py``):
  - keys arrive as the engine's normalized grouping operands
    (``ops/sortkeys.group_operands``: a (tag, int64) pair per key column),
    so one splitmix64 mix per operand yields the bucket hash;
  - the table is ``2 * capacity`` slots (power of two, load factor
    <= 0.5) storing the REPRESENTATIVE ROW INDEX of the group that owns
    each slot (``capacity`` = empty sentinel), plus one dummy slot that
    absorbs masked scatters;
  - insert-or-lookup runs linear-probe ROUNDS (a Python loop, up to
    ``PROBE_ROUNDS``), each fully vectorized over the page: every
    unresolved row probes ``(h + round) & mask``, empty slots are claimed
    by scatter-min on row index, claimants re-gather the installed owner
    and compare full keys — equal keys join the owner's group, colliders
    advance to the next probe;
  - dense group ids are a cumsum over "row owns itself" leaders, so gid
    order is first-occurrence order, with no sort anywhere. They equal
    the JAX engine's gids exactly.

The hash runs on int64 lanes: multiplication and addition wrap like the
JAX engine's uint64, and a logical right shift is the arithmetic shift
masked to the bits that remain.

Float keys are NOT hashed here (the JAX engine's TPU restriction, kept
so both engines take the same path); ``hashable_key_types`` is the gate.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .. import types as T
from .kernels import segment_reduce_columns

#: linear-probe rounds per page: with load factor <= 0.5 and a 64-bit
#: mixed hash, an unresolved row after 32 probes is astronomically rare
#: for non-adversarial input; adversarial input falls back / singles out.
PROBE_ROUNDS = 32


def _i64(u: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


_M1 = _i64(0xBF58476D1CE4E5B9)
_M2 = _i64(0x94D049BB133111EB)
_M3 = _i64(0x9E3779B97F4A7C15)  # golden-ratio increment


def hashable_key_types(key_types: Sequence[T.Type]) -> bool:
    """True when every grouping key can take the hash path (integer
    operands only — floats keep the sort path, see module docstring)."""
    return all(t not in (T.DOUBLE, T.REAL) for t in key_types)


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 lanes read as uint64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer over int64 lanes holding uint64 bits."""
    x = x + _M3
    x = (x ^ _shr(x, 30)) * _M1
    x = (x ^ _shr(x, 27)) * _M2
    return x ^ _shr(x, 31)


def mix_operands(key_ops: Sequence[torch.Tensor], n: int, device
                 ) -> torch.Tensor:
    """Combine the flattened (tag, key) operand columns into one 64-bit
    hash per row. Zero key columns (global aggregation) hash to 0."""
    h = torch.zeros((n,), dtype=torch.int64, device=device)
    for op in key_ops:
        h = splitmix64(h ^ op.to(torch.int64))
    return h


def hash_group_ids(key_ops: Sequence[torch.Tensor], valid: torch.Tensor,
                   rounds: int = PROBE_ROUNDS, exact: bool = True):
    """Vectorized insert-or-lookup over one page.

    key_ops: flattened (tag, int64) grouping operands (integer dtypes).
    valid:   bool lane mask; invalid lanes get the dump gid ``capacity``.

    Returns (gid, group_rows, ngroups, overflow):
      gid        int32 (cap,)   dense group id per row, first-occurrence
                                order; invalid lanes get ``cap``
      group_rows int32 (cap,)   representative row index per group id
      ngroups    int            number of groups assigned
      overflow   bool           exact mode only: some row exhausted its
                                probe budget and NO gid is trustworthy
                                (caller must fall back). In non-exact
                                mode always False: unresolved rows become
                                their own singleton groups.
    """
    device = valid.device
    cap = valid.shape[0]
    # 2x capacity rounded up to a power of two (pages are pow2-padded
    # already; defend against odd capacities so the & mask stays sound)
    tsize = 1 << max(2 * cap - 1, 1).bit_length()
    row_idx = torch.arange(cap, dtype=torch.int32, device=device)
    slot0 = mix_operands(key_ops, cap, device) & (tsize - 1)

    # slot -> owning row index; ``cap`` = empty; slot ``tsize`` is the
    # dummy that absorbs scatters from masked-off lanes
    table = torch.full((tsize + 1,), cap, dtype=torch.int32, device=device)
    rep = torch.where(valid, cap, row_idx)  # resolved rows' owner row
    resolved = ~valid
    dummy = torch.tensor(tsize, dtype=torch.int64, device=device)

    # typical pages resolve in 1-3 rounds; the loop exits as soon as
    # every row found its group, paying the full budget only under
    # adversarial collision chains (one host sync per round)
    for r in range(rounds):
        active = ~resolved
        if not bool(active.any()):
            break
        slot = torch.where(active, (slot0 + r) & (tsize - 1), dummy)
        owner = table[slot]
        empty = active & (owner == cap)
        # claim empty slots: smallest probing row index wins the install
        claim = torch.full((tsize + 1,), cap, dtype=torch.int32,
                           device=device)
        claim.scatter_reduce_(0, torch.where(empty, slot, dummy), row_idx,
                              "amin", include_self=True)
        winner = empty & (claim[slot] == row_idx)
        table.index_put_((torch.where(winner, slot, dummy),), row_idx)
        owner = table[slot]
        # full-key compare against the (possibly just-installed) owner
        owner_safe = torch.clamp(owner, 0, cap - 1).to(torch.int64)
        eq = active & (owner < cap)
        for op in key_ops:
            eq = eq & (op == op[owner_safe])
        rep = torch.where(eq, owner, rep)
        resolved = resolved | eq

    unresolved = ~resolved
    if exact:
        overflow = bool(unresolved.any())
    else:
        # partial aggregation tolerates duplicate groups: unresolved
        # rows lead their own singleton group
        rep = torch.where(unresolved, row_idx, rep)
        overflow = False

    leader = valid & (rep == row_idx)
    prefix = torch.cumsum(leader.to(torch.int32), 0, dtype=torch.int32) - 1
    rep_safe = torch.clamp(rep, 0, cap - 1).to(torch.int64)
    gid = torch.where(valid & (rep < cap), prefix[rep_safe],
                      torch.tensor(cap, dtype=torch.int32, device=device))
    ngroups = int(leader.sum())
    group_rows = torch.zeros((cap + 1,), dtype=torch.int32, device=device)
    group_rows.index_put_(
        (torch.where(leader, prefix, cap).to(torch.int64),), row_idx)
    return gid, group_rows[:cap], ngroups, overflow


def hash_segment_reduce(gid, group_rows, ngroups: int, key_raws: Tuple,
                        key_nulls: Tuple, state_cols: Tuple, kinds: Tuple):
    """Reduce state columns by hash-assigned gid and gather group keys.

    The segment-reduce kernel takes sorted gids, so the int32 gid takes
    one stable sort; then one ``segment_reduce_columns`` call reduces
    every state column, reading it through the sort's permutation.

    Returns (group_key_raws, group_key_nulls, reduced_states, out_valid)
    in the exact shape contract of ``aggregation.group_reduce``.
    """
    cap = gid.shape[0]
    order = torch.sort(gid, stable=True).indices
    r_gid = gid[order]
    reduced = [r[:cap] for r in segment_reduce_columns(
        state_cols, r_gid, cap + 1, kinds, order=order)]

    out_valid = torch.arange(cap, dtype=torch.int32,
                             device=gid.device) < ngroups
    safe_idx = torch.where(out_valid, group_rows, 0).to(torch.int64)
    out_key_raws = tuple(kr[safe_idx] for kr in key_raws)
    out_key_nulls = tuple(kn[safe_idx] & out_valid for kn in key_nulls)
    return out_key_raws, out_key_nulls, tuple(reduced), out_valid
