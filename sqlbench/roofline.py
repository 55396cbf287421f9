"""The bytes each hand kernel's call must move, and the card's peaks.

Frozen with the benchmark, so a kernel's share of its roofline reads the
same work whatever kernel implements it: each input byte the call needs
is read once, each output byte is written once, and no scratch counts.

- ``segment_reduce_columns`` (SUM/MIN/MAX of state columns over sorted
  group ids, optionally read through ``order``): ``gid`` (int32) and
  ``order`` (int64) for every lane, each column for the in-range lanes
  only (ids in ``[0, num_segments)``; the others are dropped), and each
  column's output once per segment.
- ``hash_insert`` (insert-or-lookup of every valid row's key): the valid
  mask (one byte a lane), the key operands of the live (valid) rows
  once, and per lane the group id (int32 ``rep``) and the ``resolved``
  flag (one byte) written once.

A bound is bytes over the published HBM bandwidth. Both kernels do a few
integer operations per byte, far under the card's compute peak, so
bandwidth bounds them.
"""

from __future__ import annotations

from typing import Sequence

#: NVIDIA H100 SXM5 80 GB, from NVIDIA's data sheet, at its full 700 W
#: power limit (the card's limit is printed beside every share)
H100_HBM_BYTES_PER_S = 3.35e12
H100_HBM_BYTES = 80e9


def segment_reduce_bytes(n: int, in_range: int, itemsizes: Sequence[int],
                         num_segments: int, with_order: bool) -> int:
    """Bytes one ``segment_reduce_columns`` call must move: ``n`` lanes
    of which ``in_range`` have an id in ``[0, num_segments)``, columns of
    ``itemsizes`` bytes per value."""
    return n * (4 + (8 if with_order else 0)) + sum(
        (in_range + num_segments) * size for size in itemsizes)


def hash_insert_bytes(n: int, live: int,
                      operand_itemsizes: Sequence[int]) -> int:
    """Bytes one ``hash_insert`` call must move: ``n`` lanes of which
    ``live`` are valid, key operands of ``operand_itemsizes`` bytes."""
    return n + live * sum(operand_itemsizes) + n * (4 + 1)


def bound_s(nbytes: int) -> float:
    """Seconds the card needs at least to move ``nbytes``."""
    return nbytes / H100_HBM_BYTES_PER_S
