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
  - insert-or-lookup runs linear-probe ROUNDS, up to ``PROBE_ROUNDS``:
    every unresolved row probes ``(h + round) & mask``, empty slots go
    to the smallest probing row index, claimants re-read the installed
    owner and compare full keys — equal keys join the owner's group,
    colliders advance to the next probe. On a CUDA page one launch of the
    hand-written kernel (``kernels.hash_insert``, csrc/hash_insert.cu)
    runs every round on the device, as the JAX engine's
    ``jax.lax.while_loop`` does; on the CPU its plain version loops;
  - dense group ids are a cumsum over "row owns itself" leaders, so gid
    order is first-occurrence order, with no sort anywhere. They equal
    the JAX engine's gids exactly.

The group count and the overflow flag stay device scalars, as in the JAX
engine: grouping a page reads nothing on the host.

Float keys are NOT hashed here (the JAX engine's TPU restriction, kept
so both engines take the same path); ``hashable_key_types`` is the gate.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .. import types as T
from ..telemetry.profiler import instrument
from . import kernels
from .kernels import segment_reduce_columns

#: linear-probe rounds per page: with load factor <= 0.5 and a 64-bit
#: mixed hash, an unresolved row after 32 probes is astronomically rare
#: for non-adversarial input; adversarial input falls back / singles out.
PROBE_ROUNDS = 32


def hashable_key_types(key_types: Sequence[T.Type]) -> bool:
    """True when every grouping key can take the hash path (integer
    operands only — floats keep the sort path, see module docstring)."""
    return all(t not in (T.DOUBLE, T.REAL) for t in key_types)


def umod(x: torch.Tensor, m: int) -> torch.Tensor:
    """Unsigned remainder of int64 lanes read as uint64, for 0 < m <
    2**31: a negative lane is ``x + 2**64``, so its remainder adds
    ``2**64 mod m`` to the floored remainder of ``x`` (an int64 ``%``
    alone gives such a lane another remainder, silently)."""
    r = torch.remainder(x, m)
    return torch.where(x < 0, torch.remainder(r + (1 << 64) % m, m), r)


def hash_insert(key_ops: Sequence[torch.Tensor], valid: torch.Tensor,
                rounds: int = PROBE_ROUNDS):
    """The linear-probe rounds of one vectorized insert-or-lookup.

    Returns (rep, resolved): ``rep`` int32 (cap,) is the representative
    (owning) row of each valid row's group — ``cap`` for a row that
    exhausted its probe budget, the row itself for an invalid lane —
    and ``resolved`` marks the rows whose group is known (invalid lanes
    count as resolved). One kernel launch on a CUDA page
    (``kernels.hash_insert``)."""
    rep, resolved, _taken = kernels.hash_insert(key_ops, valid, rounds)
    return rep, resolved


def hash_group_ids(key_ops: Sequence[torch.Tensor], valid: torch.Tensor,
                   rounds: int = PROBE_ROUNDS, exact: bool = True):
    """Vectorized insert-or-lookup over one page.

    key_ops: flattened (tag, int64) grouping operands (integer dtypes).
    valid:   bool lane mask; invalid lanes get the dump gid ``capacity``.

    Returns (gid, group_rows, ngroups, overflow):
      gid        int32 (cap,)   dense group id per row, first-occurrence
                                order; invalid lanes get ``cap``
      group_rows int32 (cap,)   representative row index per group id
      ngroups    int32 scalar   number of groups assigned (0-d tensor)
      overflow   bool scalar    exact mode only: some row exhausted its
                                probe budget and NO gid is trustworthy
                                (caller must fall back). In non-exact
                                mode always False: unresolved rows become
                                their own singleton groups. A 0-d tensor
                                on the page's device.
    """
    device = valid.device
    cap = valid.shape[0]
    row_idx = torch.arange(cap, dtype=torch.int32, device=device)
    rep, resolved = hash_insert(key_ops, valid, rounds)

    unresolved = ~resolved
    if exact:
        overflow = unresolved.any()
    else:
        # partial aggregation tolerates duplicate groups: unresolved
        # rows lead their own singleton group
        rep = torch.where(unresolved, row_idx, rep)
        overflow = torch.zeros((), dtype=torch.bool, device=device)

    leader = valid & (rep == row_idx)
    prefix = torch.cumsum(leader.to(torch.int32), 0, dtype=torch.int32) - 1
    rep_safe = torch.clamp(rep, 0, cap - 1).to(torch.int64)
    gid = torch.where(valid & (rep < cap), prefix[rep_safe], cap)
    ngroups = leader.sum(dtype=torch.int32)
    group_rows = torch.zeros((cap + 1,), dtype=torch.int32, device=device)
    group_rows.index_put_(
        (torch.where(leader, prefix, cap).to(torch.int64),), row_idx)
    return gid, group_rows[:cap], ngroups, overflow


def hash_segment_reduce(gid, group_rows, ngroups, key_raws: Tuple,
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


# profiled programs (telemetry.profiler), under the JAX engine's names;
# plain calls when profiling is off
hash_group_ids = instrument("hash_group_ids", hash_group_ids,
                            static_argnames=("rounds", "exact"))
hash_segment_reduce = instrument("hash_segment_reduce", hash_segment_reduce,
                                 static_argnames=("kinds",))
