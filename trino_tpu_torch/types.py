"""SQL type system.

Reference analog: ``core/trino-spi/src/main/java/io/trino/spi/type/`` (82
files: Type, TypeSignature, BigintType, DecimalType, VarcharType, ...).

TPU-first design: every type declares its *device storage* — the numpy/jax
dtype its values occupy in a Block on device — plus null semantics. Types
whose values don't vectorize (VARCHAR, CHAR) store dictionary codes on
device (int32) and keep the string pool on host; all comparisons, joins and
group-bys run on codes.

DECIMAL(p, s) with p <= 18 is stored as scaled int64 ("short decimal",
reference: ``spi/type/DecimalType.java`` short/long split) so aggregation is
exact integer arithmetic on device. p > 18 is rejected at analysis time for
now (TPC-H/DS need <= 15).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


class TrinoError(Exception):
    """Base error with an error-code name, mirroring the reference's
    ``StandardErrorCode`` (``spi/StandardErrorCode.java``)."""

    def __init__(self, message: str, code: str = "GENERIC_INTERNAL_ERROR"):
        super().__init__(message)
        self.code = code


class TypeError_(TrinoError):
    def __init__(self, message: str):
        super().__init__(message, code="TYPE_MISMATCH")


@dataclass(frozen=True)
class Type:
    """A SQL type. Immutable and interned for the parameterless types."""

    name: str                      # canonical lowercase display name
    storage: Optional[np.dtype]    # device dtype; None => host-only (unsupported on device)
    comparable: bool = True
    orderable: bool = True

    def __str__(self) -> str:
        return self.name

    @property
    def is_string(self) -> bool:
        return False

    @property
    def is_decimal(self) -> bool:
        return False

    @property
    def is_timestamp_tz(self) -> bool:
        return False

    @property
    def is_array(self) -> bool:
        return False

    @property
    def is_map(self) -> bool:
        return False

    @property
    def is_row(self) -> bool:
        return False

    @property
    def is_pooled(self) -> bool:
        """Device storage is int32 codes into a host-side value pool
        (strings, arrays, maps, rows); kernels see only the codes."""
        return self.is_string or self.is_array or self.is_map \
            or self.is_row

    def zero(self):
        """Neutral raw storage value used for padding lanes."""
        return np.zeros((), dtype=self.storage)[()]


# ---------------------------------------------------------------------------
# Fixed-width primitive types


BOOLEAN = Type("boolean", np.dtype(np.bool_))
TINYINT = Type("tinyint", np.dtype(np.int8))
SMALLINT = Type("smallint", np.dtype(np.int16))
INTEGER = Type("integer", np.dtype(np.int32))
BIGINT = Type("bigint", np.dtype(np.int64))
REAL = Type("real", np.dtype(np.float32))
DOUBLE = Type("double", np.dtype(np.float64))
# DATE = days since epoch (reference: spi/type/DateType.java)
DATE = Type("date", np.dtype(np.int32))
# TIMESTAMP(6) = microseconds since epoch, no tz (spi/type/TimestampType.java)
TIMESTAMP = Type("timestamp(6)", np.dtype(np.int64))


@dataclass(frozen=True)
class TimestampTZType(Type):
    """TIMESTAMP(6) WITH TIME ZONE. Device storage is the **UTC instant**
    in int64 micros (comparison/join/group-by are instant-ordered, the
    reference's contract, ``spi/type/TimestampWithTimeZoneType.java``);
    the zone rides on the type as column metadata and only matters for
    wall-clock conversion (casts, EXTRACT, rendering) — evaluated on
    device via a searchsorted over the zone's transition table
    (``expr/tz.py``), not per-value host calls."""

    zone: str = "UTC"

    @property
    def is_timestamp_tz(self) -> bool:
        return True


def timestamp_tz_type(zone: str = "UTC") -> TimestampTZType:
    from .expr.tz import canonical_zone

    return TimestampTZType(name="timestamp(6) with time zone",
                           storage=np.dtype(np.int64),
                           zone=canonical_zone(zone))


TIMESTAMP_TZ = TimestampTZType(name="timestamp(6) with time zone",
                               storage=np.dtype(np.int64), zone="UTC")
# INTERVAL types: day-seconds as micros / months as int32
INTERVAL_DAY_SECOND = Type("interval day to second", np.dtype(np.int64))
INTERVAL_YEAR_MONTH = Type("interval year to month", np.dtype(np.int32))
UNKNOWN = Type("unknown", np.dtype(np.bool_))  # the NULL literal's type


@dataclass(frozen=True)
class DecimalType(Type):
    """DECIMAL(precision, scale) as scaled int64 (short decimal only)."""

    precision: int = 38
    scale: int = 0

    def __str__(self) -> str:
        return self.name

    @property
    def is_decimal(self) -> bool:
        return True

    def to_raw(self, value) -> int:
        """Python Decimal/float/int -> scaled int64."""
        from decimal import Decimal

        d = Decimal(str(value)).scaleb(self.scale)
        return int(d.to_integral_value())

    def from_raw(self, raw: int):
        from decimal import Decimal

        return Decimal(int(raw)).scaleb(-self.scale)


def decimal_type(precision: int, scale: int) -> DecimalType:
    if precision > 18:
        # Long decimal (int128) is a follow-up: twin-int64 limbs on device.
        raise TypeError_(f"DECIMAL precision {precision} > 18 not yet supported")
    if not (0 <= scale <= precision):
        raise TypeError_(f"invalid DECIMAL({precision},{scale})")
    return DecimalType(
        name=f"decimal({precision},{scale})",
        storage=np.dtype(np.int64),
        precision=precision,
        scale=scale,
    )


@dataclass(frozen=True)
class VarcharType(Type):
    """VARCHAR(n): device storage is int32 dictionary codes; strings on host."""

    length: Optional[int] = None  # None = unbounded

    @property
    def is_string(self) -> bool:
        return True

    def __str__(self) -> str:
        return self.name


def varchar_type(length: Optional[int] = None) -> VarcharType:
    name = "varchar" if length is None else f"varchar({length})"
    return VarcharType(name=name, storage=np.dtype(np.int32), length=length)


VARCHAR = varchar_type(None)


@dataclass(frozen=True)
class CharType(Type):
    length: int = 1

    @property
    def is_string(self) -> bool:
        return True


def char_type(length: int) -> CharType:
    return CharType(name=f"char({length})", storage=np.dtype(np.int32), length=length)


@dataclass(frozen=True)
class ArrayType(Type):
    """ARRAY(T). Pooled representation: device storage is int32 codes
    into a host dictionary whose values are python tuples — the string
    strategy generalized to composites (SURVEY §7 'varchar on TPU'),
    so grouping/joins/sorting on arrays run on codes/ranks."""

    element: Type = UNKNOWN

    @property
    def is_array(self) -> bool:
        return True


def array_type(element: Type) -> ArrayType:
    return ArrayType(name=f"array({element})",
                     storage=np.dtype(np.int32), element=element)


@dataclass(frozen=True)
class RowType(Type):
    """ROW(T1, T2, ...). Pooled like arrays: pool entries are python
    tuples; field access is a LUT gather."""

    names: tuple = ()
    types: tuple = ()

    @property
    def is_row(self) -> bool:
        return True


def row_type(fields_: list) -> RowType:
    names = tuple(n for n, _ in fields_)
    types = tuple(t for _, t in fields_)
    name = "row(" + ", ".join(
        (f"{n} {t}" if n else str(t)) for n, t in fields_) + ")"
    return RowType(name=name, storage=np.dtype(np.int32), names=names,
                   types=types, orderable=False)


@dataclass(frozen=True)
class MapType(Type):
    """MAP(K, V). Pooled like arrays: device codes into a host pool of
    sorted (key, value) pair tuples — equal maps share one pool entry
    regardless of construction order."""

    key: Type = UNKNOWN
    value: Type = UNKNOWN

    @property
    def is_map(self) -> bool:
        return True


def map_type(key: Type, value: Type) -> MapType:
    # comparable (equality) but NOT orderable, as in the reference
    return MapType(name=f"map({key}, {value})",
                   storage=np.dtype(np.int32), key=key, value=value,
                   orderable=False)


# ---------------------------------------------------------------------------
# Parsing + coercion rules
# (reference analog: spi/type/TypeSignature.java + metadata/TypeCoercion.java)

_SIMPLE_TYPES = {
    "boolean": BOOLEAN,
    "tinyint": TINYINT,
    "smallint": SMALLINT,
    "integer": INTEGER,
    "int": INTEGER,
    "bigint": BIGINT,
    "real": REAL,
    "double": DOUBLE,
    "double precision": DOUBLE,
    "date": DATE,
    "timestamp": TIMESTAMP,
    "timestamp(6)": TIMESTAMP,
    "timestamp with time zone": TIMESTAMP_TZ,
    "timestamp(6) with time zone": TIMESTAMP_TZ,
    "timestamptz": TIMESTAMP_TZ,
    "varchar": VARCHAR,
    "string": VARCHAR,
    "interval day to second": INTERVAL_DAY_SECOND,
    "interval year to month": INTERVAL_YEAR_MONTH,
    "unknown": UNKNOWN,
}

_PARAM_RE = re.compile(r"^(\w+)\s*\(\s*(\d+)\s*(?:,\s*(\d+)\s*)?\)$")


def parse_type(text: str) -> Type:
    t = re.sub(r"\s+", " ", text.strip().lower())
    if t in _SIMPLE_TYPES:
        return _SIMPLE_TYPES[t]
    if t.endswith(" with time zone") and t.startswith("timestamp"):
        return TIMESTAMP_TZ
    if t.startswith("array(") and t.endswith(")"):
        return array_type(parse_type(t[len("array("):-1]))
    if t.startswith("row(") and t.endswith(")"):
        inner = t[len("row("):-1]
        parts, depth, start = [], 0, 0
        for i, ch in enumerate(inner):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            elif ch == "," and depth == 0:
                parts.append(inner[start:i])
                start = i + 1
        parts.append(inner[start:])
        return row_type([(None, parse_type(p)) for p in parts])
    if t.startswith("map(") and t.endswith(")"):
        inner = t[len("map("):-1]
        depth = 0
        for i, ch in enumerate(inner):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            elif ch == "," and depth == 0:
                return map_type(parse_type(inner[:i]),
                                parse_type(inner[i + 1:]))
    m = _PARAM_RE.match(t)
    if m:
        base, p1, p2 = m.group(1), int(m.group(2)), m.group(3)
        if base == "varchar":
            return varchar_type(p1)
        if base == "char":
            return char_type(p1)
        if base in ("decimal", "numeric"):
            return decimal_type(p1, int(p2) if p2 is not None else 0)
        if base == "timestamp":
            return TIMESTAMP
    raise TypeError_(f"unknown type: {text}")


_NUMERIC_LADDER = [TINYINT, SMALLINT, INTEGER, BIGINT, REAL, DOUBLE]


def is_numeric(t: Type) -> bool:
    return t in _NUMERIC_LADDER or t.is_decimal


def common_super_type(a: Type, b: Type) -> Optional[Type]:
    """Least common type both coerce to, or None (reference:
    ``metadata/TypeCoercion.getCommonSuperType``)."""
    if a == b:
        return a
    if a == UNKNOWN:
        return b
    if b == UNKNOWN:
        return a
    if a.is_string and b.is_string:
        la = getattr(a, "length", None)
        lb = getattr(b, "length", None)
        if la is None or lb is None:
            return VARCHAR
        return varchar_type(max(la, lb))
    if a.is_decimal and b.is_decimal:
        # Like the reference's min(38, ...) cap (DecimalType.MAX_PRECISION)
        # but at 18 while long decimal (int128) is unsupported; values whose
        # integer digits exceed the capped precision overflow at runtime,
        # same as the reference does past 38.
        scale = max(a.scale, b.scale)
        ints = max(a.precision - a.scale, b.precision - b.scale)
        return decimal_type(min(18, ints + scale), scale)
    if a.is_decimal or b.is_decimal:
        dec, other = (a, b) if a.is_decimal else (b, a)
        if other in (TINYINT, SMALLINT, INTEGER, BIGINT):
            digits = {TINYINT: 3, SMALLINT: 5, INTEGER: 10, BIGINT: 19}[other]
            return decimal_type(min(18, max(dec.precision - dec.scale, digits) + dec.scale), dec.scale)
        if other in (REAL, DOUBLE):
            return DOUBLE
        return None
    if a in _NUMERIC_LADDER and b in _NUMERIC_LADDER:
        return _NUMERIC_LADDER[max(_NUMERIC_LADDER.index(a), _NUMERIC_LADDER.index(b))]
    if {a, b} == {DATE, TIMESTAMP}:
        return TIMESTAMP
    if a.is_timestamp_tz and b.is_timestamp_tz:
        # zones are per-column metadata; mixed zones meet at the left's
        # (values are instants either way, so only rendering differs)
        return a
    if a.is_timestamp_tz and b in (DATE, TIMESTAMP):
        return a
    if b.is_timestamp_tz and a in (DATE, TIMESTAMP):
        return b
    return None


def can_coerce(source: Type, target: Type) -> bool:
    if source == target or source == UNKNOWN:
        return True
    c = common_super_type(source, target)
    return c == target
