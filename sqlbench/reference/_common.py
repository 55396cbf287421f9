"""Helpers of the plain references: decimals, dates and the
accumulation type.

A reference works in the tables' own storage: a decimal is an int64 of
its unscaled value, a date the days since 1970-01-01, a string an int32
code into its column's pool. Sums of decimals are exact in int64
(``acc="exact"``); ``"float64"`` and ``"float32"`` compute the same sums
in that float type and round to the result's scale, which is the
control that the comparison must fail.
"""

from __future__ import annotations

import datetime
from decimal import Decimal

import numpy as np

EPOCH = datetime.date(1970, 1, 1)
FLOATS = {"float64": np.float64, "float32": np.float32}


def days(iso: str) -> int:
    return (datetime.date.fromisoformat(iso) - EPOCH).days


def iso(day: int) -> str:
    return (EPOCH + datetime.timedelta(days=int(day))).isoformat()


def dec(unscaled: int, scale: int) -> Decimal:
    return Decimal(int(unscaled)).scaleb(-scale)


def code_of(pool, value: str) -> int:
    """The code of ``value`` in a column's pool, -1 if it has none."""
    try:
        return list(pool).index(value)
    except ValueError:
        return -1


def values(x, acc: str):
    """A decimal column (or product) in the accumulation type."""
    if acc == "exact":
        return np.asarray(x, dtype=np.int64)
    return np.asarray(x).astype(FLOATS[acc])


def total(x, acc: str) -> int:
    """Sum of ``x`` in the accumulation type, as an unscaled integer."""
    if acc == "exact":
        return int(np.sum(x, dtype=np.int64))
    return int(np.rint(np.sum(x, dtype=FLOATS[acc])))


def totals_by(keys, x, size: int, acc: str) -> np.ndarray:
    """Per key in [0, size): the sum of ``x`` over its rows."""
    if acc == "exact":
        out = np.zeros(size, dtype=np.int64)
        np.add.at(out, keys, np.asarray(x, dtype=np.int64))
        return out
    out = np.zeros(size, dtype=FLOATS[acc])
    np.add.at(out, keys, np.asarray(x).astype(FLOATS[acc]))
    return np.rint(out).astype(np.int64)


def avg_half_up(s: int, n: int) -> int:
    """The decimal AVG of a sum over n rows, at the sum's scale, rounded
    half away from zero."""
    q, r = divmod(abs(s), n)
    if 2 * r >= n:
        q += 1
    return q if s >= 0 else -q


def memo(tables: dict, key, make):
    """``make()`` once per set of tables (a check computes each answer
    from the same tables): what every draw of a template shares."""
    store = tables.setdefault("__memo__", {})
    if key not in store:
        store[key] = make()
    return store[key]


def sums_by_runs(keys, columns, acc: str):
    """Rows sorted by ``keys`` (a tuple of arrays, the last the primary
    sort key, as ``np.lexsort``) cut into runs of equal keys: each run's
    first row index into the sorted order, the keys at each run, and
    each column's sum over each run in the accumulation type."""
    order = np.lexsort(keys)
    sk = [k[order] for k in keys]
    change = np.zeros(len(order), dtype=bool)
    if len(order):
        change[0] = True
        for k in sk:
            change[1:] |= k[1:] != k[:-1]
    starts = np.nonzero(change)[0]
    sums = [np.add.reduceat(values(c, acc)[order], starts)
            if len(starts) else np.zeros(0) for c in columns]
    return [k[starts] for k in sk], sums
