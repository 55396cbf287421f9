"""TupleDomain predicate algebra: the engine/connector lingua franca for
filter pushdown.

Reference analog: ``spi/predicate/TupleDomain.java:56`` +
``Domain.java`` / ``SortedRangeSet.java`` / ``Range.java``. A Domain
describes the admissible values of one column as a canonical list of
disjoint, sorted ranges plus a null flag; a TupleDomain maps columns to
Domains (absent column = unconstrained) or is NONE (contradiction).
Values are host Python scalars in the column's raw representation (ints
for integer/date/timestamp/decimal-unscaled, float for double/real, str
for varchar/char, bool for boolean) so connectors can evaluate them
against generated/stored data without engine involvement.

The numpy evaluation helper at the bottom is the shared row-mask
enforcement used by the generator-backed connectors.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Range", "ValueSet", "Domain", "TupleDomain", "domain_mask"]


@dataclass(frozen=True)
class Range:
    """One interval; ``low``/``high`` None = unbounded on that side."""

    low: Any = None
    low_inclusive: bool = False
    high: Any = None
    high_inclusive: bool = False

    def __post_init__(self):
        if self.low is not None and self.high is not None:
            if self.low > self.high or (
                    self.low == self.high
                    and not (self.low_inclusive and self.high_inclusive)):
                raise ValueError(f"empty range {self}")

    @classmethod
    def single(cls, v) -> "Range":
        return cls(v, True, v, True)

    @property
    def is_single(self) -> bool:
        return self.low is not None and self.low == self.high

    def includes(self, v) -> bool:
        if self.low is not None:
            if v < self.low or (v == self.low and not self.low_inclusive):
                return False
        if self.high is not None:
            if v > self.high or (v == self.high
                                 and not self.high_inclusive):
                return False
        return True

    def _starts_before(self, other: "Range") -> bool:
        """self's low bound starts at or before other's."""
        if self.low is None:
            return True
        if other.low is None:
            return False
        if self.low != other.low:
            return self.low < other.low
        return self.low_inclusive >= other.low_inclusive

    def overlaps_or_adjacent(self, other: "Range") -> bool:
        a, b = (self, other) if self._starts_before(other) else (other,
                                                                 self)
        if a.high is None:
            return True
        if b.low is None:
            return True
        if a.high > b.low:
            return True
        if a.high < b.low:
            return False
        return a.high_inclusive or b.low_inclusive

    def merge(self, other: "Range") -> "Range":
        """Union of two overlapping/adjacent ranges."""
        if self.low is None or other.low is None:
            low, low_inc = None, False
        elif self.low != other.low:
            low, low_inc = ((self.low, self.low_inclusive)
                            if self.low < other.low
                            else (other.low, other.low_inclusive))
        else:
            low, low_inc = self.low, self.low_inclusive or \
                other.low_inclusive
        if self.high is None or other.high is None:
            high, high_inc = None, False
        elif self.high != other.high:
            high, high_inc = ((self.high, self.high_inclusive)
                             if self.high > other.high
                             else (other.high, other.high_inclusive))
        else:
            high, high_inc = self.high, self.high_inclusive or \
                other.high_inclusive
        return Range(low, low_inc, high, high_inc)

    def intersect(self, other: "Range") -> Optional["Range"]:
        if self.low is None:
            low, low_inc = other.low, other.low_inclusive
        elif other.low is None or self.low > other.low:
            low, low_inc = self.low, self.low_inclusive
        elif self.low < other.low:
            low, low_inc = other.low, other.low_inclusive
        else:
            low, low_inc = self.low, \
                self.low_inclusive and other.low_inclusive
        if self.high is None:
            high, high_inc = other.high, other.high_inclusive
        elif other.high is None or self.high < other.high:
            high, high_inc = self.high, self.high_inclusive
        elif self.high > other.high:
            high, high_inc = other.high, other.high_inclusive
        else:
            high, high_inc = self.high, \
                self.high_inclusive and other.high_inclusive
        try:
            return Range(low, low_inc, high, high_inc)
        except ValueError:
            return None


def _sort_key(r: Range):
    # -inf lows first; among equal lows, inclusive first
    return (0 if r.low is None else 1, r.low, 0 if r.low_inclusive else 1)


def _canonical(ranges: Sequence[Range]) -> Tuple[Range, ...]:
    """Sorted, disjoint, non-adjacent."""
    if not ranges:
        return ()
    rs = sorted(ranges, key=_sort_key)
    out: List[Range] = [rs[0]]
    for r in rs[1:]:
        if out[-1].overlaps_or_adjacent(r):
            out[-1] = out[-1].merge(r)
        else:
            out.append(r)
    return tuple(out)


@dataclass(frozen=True)
class ValueSet:
    """Canonical sorted range set (reference: SortedRangeSet.java)."""

    ranges: Tuple[Range, ...] = ()
    is_all: bool = False

    @classmethod
    def all_(cls) -> "ValueSet":
        return cls((), True)

    @classmethod
    def none(cls) -> "ValueSet":
        return cls(())

    @classmethod
    def of(cls, *values) -> "ValueSet":
        return cls(_canonical([Range.single(v) for v in values]))

    @classmethod
    def of_ranges(cls, *ranges: Range) -> "ValueSet":
        return cls(_canonical(ranges))

    @property
    def is_none(self) -> bool:
        return not self.is_all and not self.ranges

    @property
    def is_single(self) -> bool:
        return (not self.is_all and len(self.ranges) == 1
                and self.ranges[0].is_single)

    def includes(self, v) -> bool:
        if self.is_all:
            return True
        return any(r.includes(v) for r in self.ranges)

    def union(self, other: "ValueSet") -> "ValueSet":
        if self.is_all or other.is_all:
            return ValueSet.all_()
        return ValueSet(_canonical(list(self.ranges) +
                                   list(other.ranges)))

    def intersect(self, other: "ValueSet") -> "ValueSet":
        if self.is_all:
            return other
        if other.is_all:
            return self
        out: List[Range] = []
        for a in self.ranges:
            for b in other.ranges:
                c = a.intersect(b)
                if c is not None:
                    out.append(c)
        return ValueSet(_canonical(out))

    def complement(self) -> "ValueSet":
        """Complement over the column's value universe. Exact for
        totally-ordered value spaces; exclusive bounds stay exclusive
        (continuous-domain semantics — sound for integers too, just not
        minimal)."""
        if self.is_all:
            return ValueSet.none()
        if not self.ranges:
            return ValueSet.all_()
        out: List[Range] = []
        prev_high: Any = None
        prev_inc = False
        first = self.ranges[0]
        if first.low is not None:
            out.append(Range(None, False, first.low,
                             not first.low_inclusive))
        for r in self.ranges:
            if prev_high is not None or prev_inc:
                try:
                    out.append(Range(prev_high, not prev_inc, r.low,
                                     not r.low_inclusive))
                except ValueError:
                    pass
            prev_high, prev_inc = r.high, r.high_inclusive
        last = self.ranges[-1]
        if last.high is not None:
            out.append(Range(last.high, not last.high_inclusive, None,
                             False))
        return ValueSet(tuple(out))


@dataclass(frozen=True)
class Domain:
    """Admissible values of one column (reference: Domain.java)."""

    values: ValueSet = ValueSet.all_()
    null_allowed: bool = True

    @classmethod
    def all_(cls) -> "Domain":
        return cls(ValueSet.all_(), True)

    @classmethod
    def none(cls) -> "Domain":
        return cls(ValueSet.none(), False)

    @classmethod
    def only_null(cls) -> "Domain":
        return cls(ValueSet.none(), True)

    @classmethod
    def not_null(cls) -> "Domain":
        return cls(ValueSet.all_(), False)

    @classmethod
    def single(cls, v) -> "Domain":
        return cls(ValueSet.of(v), False)

    @classmethod
    def of_values(cls, *vs) -> "Domain":
        return cls(ValueSet.of(*vs), False)

    @property
    def is_all(self) -> bool:
        return self.values.is_all and self.null_allowed

    @property
    def is_none(self) -> bool:
        return self.values.is_none and not self.null_allowed

    def includes(self, v) -> bool:
        if v is None:
            return self.null_allowed
        return self.values.includes(v)

    def union(self, other: "Domain") -> "Domain":
        return Domain(self.values.union(other.values),
                      self.null_allowed or other.null_allowed)

    def intersect(self, other: "Domain") -> "Domain":
        return Domain(self.values.intersect(other.values),
                      self.null_allowed and other.null_allowed)

    def complement(self) -> "Domain":
        return Domain(self.values.complement(), not self.null_allowed)


@dataclass(frozen=True)
class TupleDomain:
    """column key -> Domain; ``columns is None`` = NONE (unsatisfiable).
    Absent keys are unconstrained (reference: TupleDomain.java:56)."""

    columns: Optional[Tuple[Tuple[Any, Domain], ...]] = ()

    @classmethod
    def all_(cls) -> "TupleDomain":
        return cls(())

    @classmethod
    def none(cls) -> "TupleDomain":
        return cls(None)

    @classmethod
    def of(cls, mapping: Dict[Any, Domain]) -> "TupleDomain":
        items = []
        for k, d in mapping.items():
            if d.is_none:
                return cls.none()
            if not d.is_all:
                items.append((k, d))
        return cls(tuple(sorted(items, key=lambda kv: repr(kv[0]))))

    @property
    def is_none(self) -> bool:
        return self.columns is None

    @property
    def is_all(self) -> bool:
        return self.columns == ()

    def as_dict(self) -> Dict[Any, Domain]:
        return dict(self.columns or ())

    def domain(self, key) -> Domain:
        return self.as_dict().get(key, Domain.all_())

    def intersect(self, other: "TupleDomain") -> "TupleDomain":
        if self.is_none or other.is_none:
            return TupleDomain.none()
        merged = self.as_dict()
        for k, d in other.as_dict().items():
            merged[k] = merged[k].intersect(d) if k in merged else d
        return TupleDomain.of(merged)

    def union(self, other: "TupleDomain") -> "TupleDomain":
        """Column-wise union — a sound UPPER bound of the true union
        (like the reference's columnWiseUnion)."""
        if self.is_none:
            return other
        if other.is_none:
            return self
        a, b = self.as_dict(), other.as_dict()
        # only columns constrained on BOTH sides stay constrained
        return TupleDomain.of({k: a[k].union(b[k])
                               for k in a.keys() & b.keys()})


# ------------------------------------------------------------ numpy ----

def domain_mask(data: np.ndarray, nulls: Optional[np.ndarray],
                dictionary, domain: Domain) -> np.ndarray:
    """Row-keep mask for one column block under ``domain`` — the shared
    enforcement kernel of the generator-backed connectors. ``data`` is
    raw storage (codes for pooled columns; ``dictionary`` maps them)."""
    n = data.shape[0]
    if domain.is_all:
        return np.ones(n, dtype=bool)
    isnull = nulls if nulls is not None else np.zeros(n, dtype=bool)
    if dictionary is not None:
        # pooled: decide per pool VALUE once, gather by code
        lut = np.fromiter(
            (domain.values.includes(v) for v in dictionary.values),
            dtype=bool, count=len(dictionary)) \
            if len(dictionary) else np.zeros(1, dtype=bool)
        codes = np.clip(data, 0, max(len(lut) - 1, 0))
        keep = lut[codes]
    elif domain.values.is_all:
        keep = np.ones(n, dtype=bool)
    elif domain.values.is_none:
        keep = np.zeros(n, dtype=bool)
    else:
        keep = np.zeros(n, dtype=bool)
        for r in domain.values.ranges:
            m = np.ones(n, dtype=bool)
            if r.low is not None:
                m &= (data > r.low) | ((data == r.low)
                                       if r.low_inclusive else False)
            if r.high is not None:
                m &= (data < r.high) | ((data == r.high)
                                        if r.high_inclusive else False)
            keep |= m
    keep = np.where(isnull, domain.null_allowed, keep)
    return keep
