"""The arithmetic of the end-to-end metrics and of the spreads."""

from __future__ import annotations

import math
import statistics
from typing import List, Sequence, Tuple


def geomean(values: Sequence[float]) -> float:
    """Geometric mean of positive values."""
    if not values:
        raise ValueError("geomean of no values")
    return math.exp(sum(math.log(v) for v in values) / len(values))


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0 < q < 100) of all values, linear
    between the closest ranks (NumPy's default): over all statements,
    not a mean of per-stream percentiles."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(completed: int, seconds: float) -> float:
    return completed / seconds


def spread(values: Sequence[float]) -> float:
    """The distance between the first and the third quartile as a share
    of the median (``statistics.quantiles``, n=4)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union_length(intervals: Sequence[Tuple[float, float]]) -> float:
    """Total length covered by the union of (start, end) intervals."""
    total = 0.0
    end = -math.inf
    start = None
    for a, b in sorted(intervals):
        if a > end:
            if start is not None:
                total += end - start
            start, end = a, b
        elif b > end:
            end = b
    if start is not None:
        total += end - start
    return total


def gaps(intervals: Sequence[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    out = []
    at = lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def overlap(a0: float, a1: float, b0: float, b1: float) -> float:
    """Length of [a0, a1] that lies in [b0, b1]."""
    return max(0.0, min(a1, b1) - max(a0, b0))
