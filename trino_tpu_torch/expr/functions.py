"""Scalar function registry: type resolution + device kernels.

Reference analog: the builtin function catalog registered in
``metadata/SystemFunctionBundle.java`` — scalar ops from
``core/trino-main/src/main/java/io/trino/type/*Operators.java`` (decimal
type-derivation rules mirrored from ``type/DecimalOperators.java:76,158,239,
323,503``) and ``operator/scalar/``.

Each function carries:
- ``resolve(arg_types) -> return type`` (raises TypeError_ on no match)
- ``kernel(raws, arg_types, ret_type) -> raw`` — runs eagerly over raw
  storage tensors (decimals are scaled int64, dates int32 days, ...);
  a scalar operand is a 0-d tensor on the same device
- string functions instead carry host-side transforms applied over
  dictionary values (``str_transform`` for string->string,
  ``str_scalar`` for string->fixed-width); the compiler turns them into
  per-code lookup tables gathered on device.

Null propagation is the compiler's job (RETURN_NULL_ON_NULL default);
kernels see raw lanes and may compute garbage in null lanes (masked out).

The registry, every ``resolve`` and every device body are the JAX
engine's (``trino_tpu/expr/functions.py``), so the analyzer types every
function the same way and each body computes the same lanes, but for
one repair: SQL mod by a negative divisor (``_mod_kernel``).

torch promotes a 0-d tensor into a dimensioned one's dtype where JAX
(with x64) promotes to the wider type, so kernels cast explicitly
(``_promote``); floor division is ``torch.div(..., rounding_mode="floor")``.
Integer division and modulus replace a zero divisor by 1 first, dead and
NULL lanes included (torch raises on the CPU and returns garbage on
CUDA); ``x / 0`` is thus ``x``, as in the JAX engine. Shifts, ``sign``
and the uint64 sketch hashes spell out the JAX semantics that torch's
operators do not share (shift counts past 63, the sign of NaN and -0.0,
logical right shifts).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from .. import types as T
from ..block import storage_dtype
from ..types import TypeError_, is_numeric


@dataclass
class ScalarFunction:
    name: str
    resolve: Callable
    kernel: Optional[Callable] = None
    str_transform: Optional[Callable] = None   # (*py_args) -> str|None
    str_scalar: Optional[Callable] = None      # (*py_args) -> python scalar|None


REGISTRY: dict = {}


def register(fn: ScalarFunction):
    REGISTRY[fn.name] = fn
    return fn


def get_function(name: str) -> ScalarFunction:
    f = REGISTRY.get(name)
    if f is None:
        raise TypeError_(f"unknown function: {name}")
    return f


# ---------------------------------------------------------------------------
# helpers

_POW10 = [10 ** i for i in range(19)]
_DAY_US = 86_400_000_000


def _floordiv(x, y):
    return torch.div(x, y, rounding_mode="floor")


def _nonzero(b):
    """``b`` with 0 replaced by 1: the divisor the JAX engine uses, so
    ``x / 0`` is ``x`` on every lane (dead lanes hold 0 too)."""
    return torch.where(b == 0, torch.ones_like(b), b)


def _float_to_int64(x):
    """float -> int64 as XLA converts: toward zero, saturating at the
    int64 range, NaN to 0 (torch leaves these lanes undefined)."""
    big = 2.0 ** 63
    out = torch.where(torch.isnan(x) | (x >= big) | (x < -big),
                      torch.zeros_like(x), x).to(torch.int64)
    out = torch.where(x >= big, torch.full_like(out, 2 ** 63 - 1), out)
    return torch.where(x < -big, torch.full_like(out, -2 ** 63), out)


def _pow10_lut(device) -> torch.Tensor:
    return torch.tensor(_POW10, dtype=torch.int64, device=device)


def _promote(a, b):
    """Cast two operands to their common dtype, as JAX promotes: torch
    would otherwise narrow a 0-d int64 into an int32 column's dtype."""
    if a.dtype == b.dtype:
        return a, b
    common = torch.promote_types(a.dtype, b.dtype)
    return a.to(common), b.to(common)


def rescale(x, k: int):
    """x * 10^k (k static python int; negative k divides flooring)."""
    if k == 0:
        return x
    if k > 0:
        return x * _POW10[k]
    return _floordiv(x, _POW10[-k])


def div_round_half_up(x, y):
    """Integer divide rounding half away from zero (reference:
    DecimalOperators.divideRoundUp)."""
    sign = torch.where((x < 0) ^ (y < 0), -1, 1).to(x.dtype)
    ax = torch.abs(x)
    ay = torch.abs(y)
    ay_safe = torch.where(ay == 0, 1, ay)  # null/error lanes masked upstream
    q = _floordiv(2 * ax + ay_safe, 2 * ay_safe)
    return sign * q


def _is_int(t):
    return t in (T.TINYINT, T.SMALLINT, T.INTEGER, T.BIGINT)


def _is_float(t):
    return t in (T.REAL, T.DOUBLE)


def _as_decimal(t) -> T.DecimalType:
    """View an integer type as decimal(p, 0) for mixed arithmetic."""
    if t.is_decimal:
        return t
    digits = {T.TINYINT: 3, T.SMALLINT: 5, T.INTEGER: 10, T.BIGINT: 18}[t]
    return T.decimal_type(digits, 0)


def _numeric_pair(a, b):
    """Classify a binary numeric op: 'float' | 'decimal' | 'int'."""
    if _is_float(a) or _is_float(b):
        return "float"
    if a.is_decimal or b.is_decimal:
        return "decimal"
    if _is_int(a) and _is_int(b):
        return "int"
    return None


# ---------------------------------------------------------------------------
# arithmetic


def _resolve_add_sub(args):
    a, b = args
    kind = _numeric_pair(a, b)
    if kind == "float":
        return T.DOUBLE if T.DOUBLE in (a, b) else T.REAL
    if kind == "int":
        return T.common_super_type(a, b)
    if kind == "decimal":
        da, db = _as_decimal(a), _as_decimal(b)
        s = max(da.scale, db.scale)
        p = min(18, max(da.precision - da.scale, db.precision - db.scale) + s + 1)
        return T.decimal_type(p, s)
    # date/timestamp[tz] +- interval
    if (a in (T.DATE, T.TIMESTAMP) or a.is_timestamp_tz) \
            and b in (T.INTERVAL_DAY_SECOND, T.INTERVAL_YEAR_MONTH):
        return a
    if (b in (T.DATE, T.TIMESTAMP) or b.is_timestamp_tz) \
            and a in (T.INTERVAL_DAY_SECOND, T.INTERVAL_YEAR_MONTH):
        return b
    raise TypeError_(f"cannot add/subtract {a} and {b}")


def _date_plus_interval(val, ival, itype, sign):
    if itype == T.INTERVAL_DAY_SECOND:
        days = _floordiv(ival.to(torch.int64), _DAY_US)
        return (val.to(torch.int64) + sign * days).to(torch.int32)
    # year-month: civil-calendar month addition
    y, m, d = _civil_from_days(val)
    months = (y * 12 + (m - 1)) + sign * ival.to(torch.int64)
    ny = _floordiv(months, 12)
    nm = months - ny * 12 + 1
    # clamp day to last day of target month
    last = _days_in_month(ny, nm)
    nd = torch.minimum(d, last)
    return _days_from_civil(ny, nm, nd).to(torch.int32)


def _to_float(x, t):
    if t.is_decimal:
        return x.to(torch.float64) / _POW10[t.scale]
    return x.to(torch.float64)


def coerce_raw(x, t, ret):
    """Convert raw storage of type t to raw storage of type ret."""
    if t == ret:
        return x
    if ret.is_decimal:
        if _is_float(t):
            return (x.to(torch.float64) * _POW10[ret.scale]).to(torch.int64)
        return rescale(x.to(torch.int64), ret.scale - _as_decimal(t).scale)
    if _is_float(ret):
        return _to_float(x, t).to(storage_dtype(ret))
    if t.is_decimal:  # decimal -> int: truncate toward zero
        q = _floordiv(torch.abs(x), _POW10[t.scale])
        return (torch.sign(x) * q).to(storage_dtype(ret))
    return x.to(storage_dtype(ret))


def _add_sub_kernel(sign):
    def kernel(raws, arg_types, ret_type):
        a, b = raws
        ta, tb = arg_types
        if tb in (T.DATE, T.TIMESTAMP) or tb.is_timestamp_tz:
            # interval + date => date + interval
            a, b, ta, tb = b, a, tb, ta
        if ta.is_timestamp_tz and tb in (T.INTERVAL_DAY_SECOND,
                                         T.INTERVAL_YEAR_MONTH):
            if tb == T.INTERVAL_DAY_SECOND:
                return a + sign * b  # instant arithmetic
            # year-month intervals add in WALL time (reference:
            # TimestampWithTimeZoneOperators) — convert, add, convert back
            from .tz import device_utc_to_wall, device_wall_to_utc

            wall = device_utc_to_wall(a, ta.zone)
            days = _date_plus_interval(
                _floordiv(wall, _DAY_US).to(torch.int32), b, tb, sign)
            new_wall = days.to(torch.int64) * _DAY_US + wall % _DAY_US
            return device_wall_to_utc(new_wall, ta.zone)
        if ta in (T.DATE, T.TIMESTAMP) and tb in (T.INTERVAL_DAY_SECOND,
                                                  T.INTERVAL_YEAR_MONTH):
            if ta == T.TIMESTAMP:
                if tb == T.INTERVAL_DAY_SECOND:
                    return a + sign * b
                days = _date_plus_interval(
                    _floordiv(a, _DAY_US).to(torch.int32), b, tb, sign)
                return days.to(torch.int64) * _DAY_US + a % _DAY_US
            return _date_plus_interval(a, b, tb, sign)
        if ta == T.DATE and tb == T.DATE and sign == -1:
            return a.to(torch.int64) - b.to(torch.int64)
        return coerce_raw(a, ta, ret_type) + sign * coerce_raw(b, tb, ret_type)

    return kernel


register(ScalarFunction("add", _resolve_add_sub, _add_sub_kernel(1)))
register(ScalarFunction("subtract", _resolve_add_sub, _add_sub_kernel(-1)))


def _resolve_mul(args):
    a, b = args
    kind = _numeric_pair(a, b)
    if kind == "float":
        return T.DOUBLE if T.DOUBLE in (a, b) else T.REAL
    if kind == "int":
        return T.common_super_type(a, b)
    if kind == "decimal":
        da, db = _as_decimal(a), _as_decimal(b)
        return T.decimal_type(min(18, da.precision + db.precision),
                              da.scale + db.scale)
    if a == T.INTERVAL_DAY_SECOND and _is_int(b):
        return a
    raise TypeError_(f"cannot multiply {a} and {b}")


def _mul_kernel(raws, arg_types, ret_type):
    a, b = raws
    ta, tb = arg_types
    if _is_float(ret_type):
        return (_to_float(a, ta) * _to_float(b, tb)).to(
            storage_dtype(ret_type))
    if ret_type.is_decimal:
        return a.to(torch.int64) * b.to(torch.int64)
    dt = storage_dtype(ret_type)
    return a.to(dt) * b.to(dt)


register(ScalarFunction("multiply", _resolve_mul, _mul_kernel))


def _resolve_div(args):
    a, b = args
    kind = _numeric_pair(a, b)
    if kind == "float":
        return T.DOUBLE if T.DOUBLE in (a, b) else T.REAL
    if kind == "int":
        return T.common_super_type(a, b)
    if kind == "decimal":
        da, db = _as_decimal(a), _as_decimal(b)
        # reference: DecimalOperators.java:323-324
        p = min(18, da.precision + db.scale + max(db.scale - da.scale, 0))
        s = max(da.scale, db.scale)
        return T.decimal_type(p, s)
    raise TypeError_(f"cannot divide {a} and {b}")


def _div_kernel(raws, arg_types, ret_type):
    a, b = raws
    ta, tb = arg_types
    if _is_float(ret_type):
        return (_to_float(a, ta) / _to_float(b, tb)).to(
            storage_dtype(ret_type))
    if ret_type.is_decimal:
        da, db = _as_decimal(ta), _as_decimal(tb)
        # rescaleFactor = resultScale - dividendScale + divisorScale
        k = ret_type.scale - da.scale + db.scale
        return div_round_half_up(rescale(a.to(torch.int64), k),
                                 b.to(torch.int64))
    dt = storage_dtype(ret_type)
    return _floordiv(a.to(dt), _nonzero(b).to(dt))


register(ScalarFunction("divide", _resolve_div, _div_kernel))


def _resolve_mod(args):
    a, b = args
    kind = _numeric_pair(a, b)
    if kind == "float":
        return T.DOUBLE if T.DOUBLE in (a, b) else T.REAL
    if kind == "int":
        return T.common_super_type(a, b)
    if kind == "decimal":
        da, db = _as_decimal(a), _as_decimal(b)
        # reference: DecimalOperators.java:503-504
        s = max(da.scale, db.scale)
        p = min(db.precision - db.scale, da.precision - da.scale) + s
        return T.decimal_type(min(18, p), s)
    raise TypeError_(f"cannot mod {a} and {b}")


def _mod_kernel(raws, arg_types, ret_type):
    a, b = raws
    ta, tb = arg_types
    if _is_float(ret_type):
        return torch.fmod(_to_float(a, ta), _to_float(b, tb)).to(
            storage_dtype(ret_type))
    # SQL mod takes the dividend's sign (truncated remainder, fmod), for
    # either sign of the divisor. The JAX engine computes
    # a - sign(a) * (|a| // |b|) * b, which is that only for b > 0 (for
    # b < 0 it gives a + |b| * (|a| // |b|)); x mod 0 is 0 in both.
    if ret_type.is_decimal:
        da, db = _as_decimal(ta), _as_decimal(tb)
        s = ret_type.scale
        ra = rescale(a.to(torch.int64), s - da.scale)
        rb = rescale(b.to(torch.int64), s - db.scale)
        return torch.fmod(ra, _nonzero(rb))
    # the divisor is cast to the dividend's dtype, as in the JAX engine
    return torch.fmod(a, _nonzero(b).to(a.dtype)).to(storage_dtype(ret_type))


register(ScalarFunction("modulus", _resolve_mod, _mod_kernel))
register(ScalarFunction("mod", _resolve_mod, _mod_kernel))


def _resolve_negate(args):
    (a,) = args
    if _is_int(a) or _is_float(a) or a.is_decimal or a in (
            T.INTERVAL_DAY_SECOND, T.INTERVAL_YEAR_MONTH):
        return a
    raise TypeError_(f"cannot negate {a}")


register(ScalarFunction("negate", _resolve_negate,
                        lambda raws, at, rt: -raws[0]))


# ---------------------------------------------------------------------------
# comparisons (numeric / date / boolean; string comparisons are routed
# through dictionary rank LUTs by the compiler, not this kernel)


def _resolve_cmp(args):
    a, b = args
    if a == b or T.common_super_type(a, b) is not None:
        return T.BOOLEAN
    raise TypeError_(f"cannot compare {a} and {b}")


def _cmp_kernel(op):
    def kernel(raws, arg_types, ret_type):
        a, b = raws
        ta, tb = arg_types
        if ta.is_decimal or tb.is_decimal:
            if _is_float(ta) or _is_float(tb):
                a, b = _to_float(a, ta), _to_float(b, tb)
            else:
                da, db = _as_decimal(ta), _as_decimal(tb)
                s = max(da.scale, db.scale)
                a = rescale(a.to(torch.int64), s - da.scale)
                b = rescale(b.to(torch.int64), s - db.scale)
        elif _is_float(ta) or _is_float(tb):
            a, b = _to_float(a, ta), _to_float(b, tb)
        return op(*_promote(a, b))

    return kernel


# orderability of lt/le/gt/ge is enforced once, at analysis
# (_an_ComparisonExpression / sort planning), not per-resolver
for _n, _op in [("eq", torch.eq), ("ne", torch.ne), ("lt", torch.lt),
                ("le", torch.le), ("gt", torch.gt), ("ge", torch.ge)]:
    register(ScalarFunction(_n, _resolve_cmp, _cmp_kernel(_op)))


# ---------------------------------------------------------------------------
# math


def _resolve_unary_double(args):
    (a,) = args
    if _is_int(a) or _is_float(a) or a.is_decimal:
        return T.DOUBLE
    raise TypeError_(f"expected numeric, got {a}")


def _unary_double(fn):
    return lambda raws, at, rt: fn(_to_float(raws[0], at[0]))


register(ScalarFunction("sqrt", _resolve_unary_double,
                        _unary_double(torch.sqrt)))
register(ScalarFunction("ln", _resolve_unary_double, _unary_double(torch.log)))
register(ScalarFunction("log10", _resolve_unary_double,
                        _unary_double(torch.log10)))
register(ScalarFunction("exp", _resolve_unary_double, _unary_double(torch.exp)))
register(ScalarFunction("sin", _resolve_unary_double, _unary_double(torch.sin)))
register(ScalarFunction("cos", _resolve_unary_double, _unary_double(torch.cos)))
register(ScalarFunction("tan", _resolve_unary_double, _unary_double(torch.tan)))


def _resolve_same(args):
    (a,) = args
    if _is_int(a) or _is_float(a) or a.is_decimal:
        return a
    raise TypeError_(f"expected numeric, got {a}")


register(ScalarFunction("abs", _resolve_same,
                        lambda raws, at, rt: torch.abs(raws[0])))


def _binary_double(op):
    def kernel(raws, arg_types, ret_type):
        return op(_to_float(raws[0], arg_types[0]),
                  _to_float(raws[1], arg_types[1]))

    return kernel


def _resolve_round(args):
    a = args[0]
    if len(args) == 2 and not _is_int(args[1]):
        raise TypeError_("round() scale must be integer")
    if a.is_decimal:
        if len(args) == 2:
            # round(decimal, n) keeps the type (digits beyond n zeroed)
            return a
        return T.decimal_type(min(18, a.precision - a.scale + 1), 0)
    if _is_int(a) or _is_float(a):
        return a
    raise TypeError_(f"cannot round {a}")


def _round_kernel(raws, arg_types, ret_type):
    a = raws[0]
    ta = arg_types[0]
    if _is_float(ta):
        # SQL rounds half away from zero (not banker's rounding)
        if len(raws) == 2:
            # the JAX engine's factor is float64, which widens a REAL
            f = torch.pow(10.0, raws[1].to(torch.float64))
            a64 = a.to(torch.float64)
            return (torch.sign(a64) * torch.floor(torch.abs(a64) * f + 0.5)
                    / f).to(storage_dtype(ta))
        return (torch.sign(a) * torch.floor(torch.abs(a) + 0.5)).to(
            storage_dtype(ta))
    if ta.is_decimal:
        if len(raws) == 1:
            return div_round_half_up(a, torch.tensor(
                _POW10[ta.scale], dtype=torch.int64, device=a.device))
        # round(decimal, n): zero out digits beyond scale n (n per lane)
        k = torch.clamp(ta.scale - raws[1].to(torch.int64), 0, 18)
        f = _pow10_lut(a.device)[k]
        return div_round_half_up(a, f) * f
    return a


register(ScalarFunction("round", _resolve_round, _round_kernel))


def _resolve_floor_ceil(args):
    (a,) = args
    if a.is_decimal:
        return T.decimal_type(min(18, a.precision - a.scale + 1), 0)
    if _is_int(a) or _is_float(a):
        return a
    raise TypeError_(f"cannot floor/ceil {a}")


def _floor_kernel(raws, arg_types, ret_type):
    a, ta = raws[0], arg_types[0]
    if ta.is_decimal:
        return _floordiv(a, _POW10[ta.scale])
    if _is_float(ta):
        return torch.floor(a)
    return a


def _ceil_kernel(raws, arg_types, ret_type):
    a, ta = raws[0], arg_types[0]
    if ta.is_decimal:
        return -_floordiv(-a, _POW10[ta.scale])
    if _is_float(ta):
        return torch.ceil(a)
    return a


register(ScalarFunction("floor", _resolve_floor_ceil, _floor_kernel))
register(ScalarFunction("ceil", _resolve_floor_ceil, _ceil_kernel))
register(ScalarFunction("ceiling", _resolve_floor_ceil, _ceil_kernel))


def _resolve_greatest(args):
    t = args[0]
    for a in args[1:]:
        t2 = T.common_super_type(t, a)
        if t2 is None:
            raise TypeError_(f"greatest/least mixed types {t}, {a}")
        t = t2
    return t


def _minmax_kernel(fn):
    def kernel(raws, arg_types, ret_type):
        acc = None
        for r, t in zip(raws, arg_types):
            if ret_type.is_decimal:
                v = rescale(r.to(torch.int64),
                            ret_type.scale - _as_decimal(t).scale)
            elif _is_float(ret_type):
                v = _to_float(r, t)
            else:
                v = r.to(storage_dtype(ret_type))
            acc = v if acc is None else fn(acc, v)
        return acc

    return kernel


register(ScalarFunction("greatest", _resolve_greatest,
                        _minmax_kernel(torch.maximum)))
register(ScalarFunction("least", _resolve_greatest,
                        _minmax_kernel(torch.minimum)))


# ---------------------------------------------------------------------------
# date / time (civil calendar math; Howard Hinnant's algorithms —
# vectorized integer ops, no host round-trip)


def _civil_from_days(days):
    z = days.to(torch.int64) + 719468
    era = _floordiv(z, 146097)
    doe = z - era * 146097
    yoe = _floordiv(doe - _floordiv(doe, 1460) + _floordiv(doe, 36524)
                    - _floordiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _floordiv(yoe, 4) - _floordiv(yoe, 100))
    mp = _floordiv(5 * doy + 2, 153)
    d = doy - _floordiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


def _days_from_civil(y, m, d):
    y = y - (m <= 2).to(y.dtype)
    era = _floordiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _floordiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _floordiv(yoe, 4) - _floordiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _days_in_month(y, m):
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    lengths = torch.tensor([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                           dtype=torch.int64, device=m.device)
    base = lengths[m - 1]
    return torch.where((m == 2) & leap, 29, base)


def days_from_civil_host(y: int, m: int, d: int) -> int:
    import datetime
    return datetime.date(y, m, d).toordinal() - datetime.date(1970, 1, 1).toordinal()


def _resolve_date_part(args):
    (a,) = args
    if a in (T.DATE, T.TIMESTAMP) or a.is_timestamp_tz:
        return T.BIGINT
    raise TypeError_(f"expected date/timestamp, got {a}")


def _to_days(raw, t):
    if t.is_timestamp_tz:
        from .tz import device_utc_to_wall

        wall = device_utc_to_wall(raw, t.zone)
        return _floordiv(wall, _DAY_US).to(torch.int32)
    if t == T.TIMESTAMP:
        return _floordiv(raw, _DAY_US).to(torch.int32)
    return raw


def _wall_micros(raw, t):
    """Wall-clock micros-of-day for time-of-day fields (0 for DATE)."""
    if t.is_timestamp_tz:
        from .tz import device_utc_to_wall

        return torch.remainder(device_utc_to_wall(raw, t.zone), _DAY_US)
    if t == T.TIMESTAMP:
        return torch.remainder(raw, _DAY_US)
    return torch.zeros_like(raw, dtype=torch.int64)


def _jan1(y):
    one = torch.ones_like(y)
    return _days_from_civil(y, one, one)


def _date_part_kernel(part):
    def kernel(raws, arg_types, ret_type):
        if part in ("hour", "minute", "second", "millisecond"):
            us = _wall_micros(raws[0], arg_types[0])
            if part == "hour":
                return _floordiv(us, 3_600_000_000)
            if part == "minute":
                return _floordiv(us, 60_000_000) % 60
            if part == "second":
                return _floordiv(us, 1_000_000) % 60
            return _floordiv(us, 1_000) % 1000
        days = _to_days(raws[0], arg_types[0])
        y, m, d = _civil_from_days(days)
        if part == "year":
            return y
        if part == "month":
            return m
        if part == "day":
            return d
        if part == "quarter":
            return _floordiv(m - 1, 3) + 1
        d64 = days.to(torch.int64)
        if part == "day_of_week":  # ISO: Mon=1..Sun=7 (1970-01-01 = Thursday)
            return (d64 + 3) % 7 + 1
        if part == "day_of_year":
            return d64 - _jan1(y) + 1
        if part == "week":  # ISO week number via the Thursday rule
            thursday = d64 + (3 - (d64 + 3) % 7)
            ty, _, _ = _civil_from_days(thursday.to(torch.int32))
            return _floordiv(thursday - _jan1(ty), 7) + 1
        raise TypeError_(f"unsupported extract field {part}")

    return kernel


for _p in ["year", "month", "day", "quarter", "day_of_week", "day_of_year",
           "week", "hour", "minute", "second", "millisecond"]:
    register(ScalarFunction(f"$extract_{_p}", _resolve_date_part,
                            _date_part_kernel(_p)))
for _n in ("hour", "minute", "second", "millisecond", "year", "month", "day",
           "quarter"):
    register(ScalarFunction(_n, _resolve_date_part, _date_part_kernel(_n)))


def _resolve_date_diff(args):
    raise TypeError_("date_diff requires literal unit (handled by analyzer)")


# ---------------------------------------------------------------------------
# string functions (host dictionary transforms; compiler wires LUTs)


def _resolve_strlen(args):
    (a,) = args
    if a.is_string:
        return T.BIGINT
    raise TypeError_(f"length() expects varchar, got {a}")


register(ScalarFunction("length", _resolve_strlen,
                        str_scalar=lambda s: len(s)))


def _resolve_str_to_str(nargs_ok):
    def resolve(args):
        if not args[0].is_string:
            raise TypeError_(f"expected varchar, got {args[0]}")
        if not nargs_ok(len(args)):
            raise TypeError_("wrong argument count")
        return T.VARCHAR

    return resolve


register(ScalarFunction("lower", _resolve_str_to_str(lambda n: n == 1),
                        str_transform=lambda s: s.lower()))
register(ScalarFunction("upper", _resolve_str_to_str(lambda n: n == 1),
                        str_transform=lambda s: s.upper()))
register(ScalarFunction("trim", _resolve_str_to_str(lambda n: n == 1),
                        str_transform=lambda s: s.strip()))
register(ScalarFunction("ltrim", _resolve_str_to_str(lambda n: n == 1),
                        str_transform=lambda s: s.lstrip()))
register(ScalarFunction("rtrim", _resolve_str_to_str(lambda n: n == 1),
                        str_transform=lambda s: s.rstrip()))
register(ScalarFunction("reverse", _resolve_str_to_str(lambda n: n == 1),
                        str_transform=lambda s: s[::-1]))


def _substr(s, start, length=None):
    # SQL substr: 1-based; 0 treated as 1; negative counts from end
    start = int(start)
    if start == 0:
        start = 1
    if start > 0:
        i = start - 1
    else:
        i = len(s) + start
        if i < 0:
            i = 0
    if length is None:
        return s[i:]
    return s[i:i + int(length)]


def _resolve_substr(args):
    if not args[0].is_string:
        raise TypeError_(f"substr expects varchar, got {args[0]}")
    for a in args[1:]:
        if not _is_int(a):
            raise TypeError_("substr offsets must be integers")
    return T.VARCHAR


register(ScalarFunction("substr", _resolve_substr, str_transform=_substr))
register(ScalarFunction("substring", _resolve_substr, str_transform=_substr))


def _resolve_concat(args):
    for a in args:
        if not a.is_string:
            raise TypeError_(f"concat expects varchar, got {a}")
    return T.VARCHAR


register(ScalarFunction("concat", _resolve_concat,
                        str_transform=lambda *parts: "".join(parts)))


def like_to_regex(pattern: str, escape: Optional[str] = None) -> "re.Pattern":
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if escape and c == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


def _resolve_strpos(args):
    if not (args[0].is_string and args[1].is_string):
        raise TypeError_("strpos expects (varchar, varchar)")
    return T.BIGINT


register(ScalarFunction("strpos", _resolve_strpos,
                        str_scalar=lambda s, sub: s.find(sub) + 1))
register(ScalarFunction(
    "starts_with", lambda args: T.BOOLEAN,
    str_scalar=lambda s, pre: s.startswith(pre)))
register(ScalarFunction(
    "replace", _resolve_str_to_str(lambda n: n in (2, 3)),
    str_transform=lambda s, find, repl="": s.replace(find, repl)))
register(ScalarFunction(
    "lpad", _resolve_str_to_str(lambda n: n == 3),
    str_transform=lambda s, n, pad: s.rjust(int(n), pad[:1] or " ")[:int(n)]))
register(ScalarFunction(
    "rpad", _resolve_str_to_str(lambda n: n == 3),
    str_transform=lambda s, n, pad: s.ljust(int(n), pad[:1] or " ")[:int(n)]))


# ---------------------------------------------------------------------------
# math breadth (reference: operator/scalar/MathFunctions.java)


def _resolve_binary_double(args):
    if len(args) != 2:
        raise TypeError_(f"expected 2 arguments, got {len(args)}")
    for a in args:
        if not (is_numeric(a)):
            raise TypeError_(f"expected numeric, got {a}")
    return T.DOUBLE


register(ScalarFunction("power", _resolve_binary_double,
                        _binary_double(torch.pow)))
register(ScalarFunction("pow", _resolve_binary_double,
                        _binary_double(torch.pow)))
register(ScalarFunction("atan2", _resolve_binary_double,
                        _binary_double(torch.atan2)))
register(ScalarFunction(
    "log", _resolve_binary_double,
    _binary_double(lambda b, x: torch.log(x) / torch.log(b))))

for _n, _f in [("cbrt", lambda x: torch.sign(x) * torch.abs(x) ** (1 / 3)),
               ("asin", torch.asin), ("acos", torch.acos),
               ("atan", torch.atan), ("sinh", torch.sinh),
               ("cosh", torch.cosh), ("tanh", torch.tanh),
               ("degrees", torch.rad2deg), ("radians", torch.deg2rad),
               ("log2", torch.log2)]:
    register(ScalarFunction(_n, _resolve_unary_double, _unary_double(_f)))


def _resolve_sign(args):
    (a,) = args
    if not is_numeric(a):
        raise TypeError_(f"sign expects numeric, got {a}")
    return T.DOUBLE if a in (T.REAL, T.DOUBLE) else T.BIGINT


def _sign_kernel(raws, arg_types, ret_type):
    x = raws[0]
    if arg_types[0] not in (T.REAL, T.DOUBLE):
        return torch.sign(x.to(torch.int64))
    # jnp.sign keeps NaN and -0.0; torch.sign maps both to +0.0
    x = x.to(torch.float64)
    return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))


register(ScalarFunction("sign", _resolve_sign, _sign_kernel))


def _resolve_truncate(args):
    if not (1 <= len(args) <= 2):
        raise TypeError_(f"truncate expects 1-2 arguments, got {len(args)}")
    if not is_numeric(args[0]):
        raise TypeError_(f"truncate expects numeric, got {args[0]}")
    if len(args) == 2 and not _is_int(args[1]):
        raise TypeError_("truncate digit count must be an integer")
    return T.DOUBLE if args[0] in (T.REAL, T.DOUBLE) else args[0]


def _truncate_kernel(raws, arg_types, ret_type):
    t = arg_types[0]
    x = raws[0]
    n = raws[1].to(torch.int64) if len(raws) > 1 \
        else torch.zeros((), dtype=torch.int64, device=x.device)
    if t in (T.REAL, T.DOUBLE):
        f = torch.pow(10.0, n.to(torch.float64))
        return torch.trunc(x.to(torch.float64) * f) / f
    if t.is_decimal and t.scale is not None:
        # zero digits beyond n decimal places, toward zero; negative n
        # zeroes digits LEFT of the point (f grows past the scale)
        f = _pow10_lut(x.device)[torch.clamp(t.scale - n, 0, 18)]
        return torch.sign(x) * _floordiv(torch.abs(x), f) * f
    return x


register(ScalarFunction("truncate", _resolve_truncate, _truncate_kernel))


def _resolve_double_predicate(args):
    if not is_numeric(args[0]):
        raise TypeError_(f"expected numeric, got {args[0]}")
    return T.BOOLEAN


for _n, _f in [("is_nan", torch.isnan), ("is_finite", torch.isfinite),
               ("is_infinite", torch.isinf)]:
    register(ScalarFunction(
        _n, _resolve_double_predicate,
        lambda raws, at, rt, _f=_f: _f(_to_float(raws[0], at[0]))))

# constants: a Python float, which the compiler puts on the page's device
for _n, _v in [("pi", math.pi), ("e", math.e), ("nan", math.nan),
               ("infinity", math.inf)]:
    register(ScalarFunction(
        _n, lambda args, _n=_n: T.DOUBLE if not args
        else (_ for _ in ()).throw(TypeError_(f"{_n} takes no args")),
        lambda raws, at, rt, _v=_v: _v))


# bitwise (reference: operator/scalar/BitwiseFunctions.java)

def _resolve_bitwise(args):
    for a in args:
        if not _is_int(a):
            raise TypeError_(f"bitwise function expects integers, got {a}")
    return T.BIGINT


def _shift_kernel(left: bool):
    """int64 shift with the JAX engine's semantics: a count outside
    [0, 63] gives 0, and a right shift is logical (on the uint64 bits)."""
    def kernel(raws, arg_types, ret_type):
        x = raws[0].to(torch.int64)
        n = raws[1].to(torch.int64)
        inside = (n >= 0) & (n < 64)
        k = torch.where(inside, n, torch.zeros_like(n))
        if left:
            out = x << k
        else:
            # arithmetic shift, then clear the k sign-filled top bits
            k1 = torch.clamp(k, min=1)
            out = torch.where(k == 0, x, (x >> k1) & ~(
                torch.full_like(x, -1) << (64 - k1)))
        return torch.where(inside, out, torch.zeros_like(out))

    return kernel


for _n, _f in [("bitwise_and", torch.bitwise_and),
               ("bitwise_or", torch.bitwise_or),
               ("bitwise_xor", torch.bitwise_xor)]:
    register(ScalarFunction(
        _n, _resolve_bitwise,
        lambda raws, at, rt, _f=_f: _f(raws[0].to(torch.int64),
                                       raws[1].to(torch.int64))))
register(ScalarFunction("bitwise_not", _resolve_bitwise,
                        lambda raws, at, rt: ~raws[0].to(torch.int64)))
register(ScalarFunction("bitwise_left_shift", _resolve_bitwise,
                        _shift_kernel(left=True)))
register(ScalarFunction("bitwise_right_shift", _resolve_bitwise,
                        _shift_kernel(left=False)))


# string breadth (host pool transforms)

register(ScalarFunction("codepoint", _resolve_strlen,
                        str_scalar=lambda s: ord(s[0]) if s else 0))


def _split_part(s, delim, n):
    parts = s.split(delim)
    i = int(n)
    return parts[i - 1] if 1 <= i <= len(parts) else None


register(ScalarFunction(
    "split_part", _resolve_str_to_str(lambda n: n == 3),
    str_transform=_split_part))
register(ScalarFunction(
    "translate", _resolve_str_to_str(lambda n: n == 3),
    str_transform=lambda s, frm, to: s.translate(
        {ord(f): (to[i] if i < len(to) else None)
         for i, f in enumerate(frm)})))


# date/time breadth (reference: operator/scalar/DateTimeFunctions.java)

def _trunc_days(days, unit):
    y, m, d = _civil_from_days(days)
    one = torch.ones_like(m)
    if unit == "year":
        return _days_from_civil(y, one, one)
    if unit == "quarter":
        return _days_from_civil(y, _floordiv(m - 1, 3) * 3 + 1, one)
    if unit == "month":
        return _days_from_civil(y, m, one)
    d64 = days.to(torch.int64)
    if unit == "week":  # ISO week starts Monday
        return d64 - (d64 + 3) % 7
    return d64


def _trunc_wall_micros(x, unit):
    if unit in ("year", "quarter", "month", "week", "day"):
        days = _floordiv(x, _DAY_US).to(torch.int32)
        return _trunc_days(days, unit).to(torch.int64) * _DAY_US
    scale = {"hour": 3_600_000_000, "minute": 60_000_000,
             "second": 1_000_000}[unit]
    return _floordiv(x, scale) * scale


def _date_trunc_kernel(unit):
    def kernel(raws, arg_types, ret_type):
        t = arg_types[0]
        x = raws[0]
        if t == T.DATE:
            return _trunc_days(x, unit).to(torch.int32)
        if t.is_timestamp_tz:
            from .tz import device_utc_to_wall, device_wall_to_utc

            wall = device_utc_to_wall(x, t.zone)
            return device_wall_to_utc(_trunc_wall_micros(wall, unit), t.zone)
        return _trunc_wall_micros(x, unit)

    return kernel


def _resolve_trunc_unit(args):
    (a,) = args
    if a in (T.DATE, T.TIMESTAMP) or a.is_timestamp_tz:
        return a
    raise TypeError_(f"date_trunc expects date/timestamp, got {a}")


for _u in ("year", "quarter", "month", "week", "day", "hour", "minute",
           "second"):
    register(ScalarFunction(f"$date_trunc_{_u}", _resolve_trunc_unit,
                            _date_trunc_kernel(_u)))

for _n, _p in [("day_of_week", "day_of_week"), ("dow", "day_of_week"),
               ("day_of_year", "day_of_year"), ("doy", "day_of_year"),
               ("week", "week"), ("week_of_year", "week")]:
    register(ScalarFunction(_n, _resolve_date_part, _date_part_kernel(_p)))


def _resolve_last_day(args):
    if args[0] not in (T.DATE, T.TIMESTAMP):
        raise TypeError_("last_day_of_month expects date/timestamp")
    return T.DATE


def _last_day_kernel(raws, arg_types, ret_type):
    y, m, _ = _civil_from_days(_to_days(raws[0], arg_types[0]))
    return (_days_from_civil(y, m, torch.ones_like(m))
            + _days_in_month(y, m) - 1).to(torch.int32)


register(ScalarFunction("last_day_of_month", _resolve_last_day,
                        _last_day_kernel))


def _resolve_to_unixtime(args):
    if args[0] not in (T.TIMESTAMP,) and not args[0].is_timestamp_tz:
        raise TypeError_("to_unixtime expects a timestamp")
    return T.DOUBLE


register(ScalarFunction(
    "to_unixtime", _resolve_to_unixtime,
    lambda raws, at, rt: raws[0].to(torch.float64) / 1e6))


def _resolve_from_unixtime(args):
    if not is_numeric(args[0]):
        raise TypeError_("from_unixtime expects numeric seconds")
    return T.timestamp_tz_type("UTC")


register(ScalarFunction(
    "from_unixtime", _resolve_from_unixtime,
    lambda raws, at, rt: _float_to_int64(_to_float(raws[0], at[0]) * 1e6)))


def _resolve_ts_diff(args):
    return T.BIGINT


def _ts_diff_kernel(raws, arg_types, ret_type):
    b, a, scale = raws
    d = b.to(torch.int64) - a.to(torch.int64)
    # truncate toward zero in whole units (the unit is a literal, never 0)
    return torch.sign(d) * _floordiv(torch.abs(d), scale.to(torch.int64))


register(ScalarFunction("$ts_diff", _resolve_ts_diff, _ts_diff_kernel))


# ---------------------------------------------------------------------------
# arrays (pooled composites; reference: operator/scalar/ArrayFunctions +
# ArraySubscriptOperator — here host pool LUTs like the string strategy)


def _resolve_cardinality(args):
    if not (args[0].is_array or args[0].is_map):
        raise TypeError_(
            f"cardinality expects array or map, got {args[0]}")
    return T.BIGINT


register(ScalarFunction("cardinality", _resolve_cardinality,
                        str_scalar=lambda a: len(a)))


def _element_of(a, i):
    i = int(i)
    return a[i - 1] if 1 <= i <= len(a) else None


def _resolve_element_at(args):
    if not args[0].is_array:
        raise TypeError_(f"element_at expects array, got {args[0]}")
    if not _is_int(args[1]):
        raise TypeError_("element_at index must be an integer")
    return args[0].element


# $subscript is emitted by the analyzer for base[i]; element_at is the
# two-arg function form — same host lookup (1-based, out of range NULL)
register(ScalarFunction("$subscript", _resolve_element_at,
                        str_scalar=_element_of, str_transform=_element_of))
register(ScalarFunction("element_at", _resolve_element_at,
                        str_scalar=_element_of, str_transform=_element_of))


def _resolve_contains(args):
    if not args[0].is_array:
        raise TypeError_(f"contains expects array, got {args[0]}")
    return T.BOOLEAN


register(ScalarFunction("contains", _resolve_contains,
                        str_scalar=lambda a, x: x in a))


def _resolve_split(args):
    if not (args[0].is_string and args[1].is_string):
        raise TypeError_("split expects (varchar, varchar)")
    return T.array_type(T.VARCHAR)


register(ScalarFunction("split", _resolve_split,
                        str_transform=lambda s, d: tuple(s.split(d))))


def _resolve_array_join(args):
    if not args[0].is_array:
        raise TypeError_(f"array_join expects array, got {args[0]}")
    return T.VARCHAR


register(ScalarFunction(
    "array_join", _resolve_array_join,
    str_transform=lambda a, sep, nullrepl=None: sep.join(
        (nullrepl if v is None else str(v))
        for v in a if v is not None or nullrepl is not None)))


def _resolve_array_minmax(args):
    if not args[0].is_array:
        raise TypeError_(f"expected array, got {args[0]}")
    return args[0].element


register(ScalarFunction(
    "array_min", _resolve_array_minmax,
    str_scalar=lambda a: min((v for v in a if v is not None),
                             default=None),
    str_transform=lambda a: min((v for v in a if v is not None),
                                default=None)))
register(ScalarFunction(
    "array_max", _resolve_array_minmax,
    str_scalar=lambda a: max((v for v in a if v is not None),
                             default=None),
    str_transform=lambda a: max((v for v in a if v is not None),
                                default=None)))


# maps (pooled: sorted (key, value) pair tuples)


def _resolve_map_ctor(args):
    if len(args) != 2 or not (args[0].is_array and args[1].is_array):
        raise TypeError_("map expects (array, array)")
    return T.map_type(args[0].element, args[1].element)


def _map_ctor(ks, vs):
    from ..types import TrinoError

    if len(ks) != len(vs):
        raise TrinoError("Key and value arrays must be the same length",
                         "INVALID_FUNCTION_ARGUMENT")
    if any(k is None for k in ks):
        raise TrinoError("map key cannot be null",
                         "INVALID_FUNCTION_ARGUMENT")
    if len(set(ks)) != len(ks):
        raise TrinoError("Duplicate map keys are not allowed",
                         "INVALID_FUNCTION_ARGUMENT")
    return tuple(sorted(zip(ks, vs)))


register(ScalarFunction("map", _resolve_map_ctor,
                        str_transform=_map_ctor))


def _resolve_map_get(args):
    if not args[0].is_map:
        raise TypeError_(f"expected map, got {args[0]}")
    return args[0].value


def _map_get(m, k):
    return dict(m).get(k)


register(ScalarFunction("$map_get", _resolve_map_get,
                        str_scalar=_map_get, str_transform=_map_get))


def _resolve_map_keys(args):
    if not args[0].is_map:
        raise TypeError_(f"expected map, got {args[0]}")
    return T.array_type(args[0].key)


def _resolve_map_values(args):
    if not args[0].is_map:
        raise TypeError_(f"expected map, got {args[0]}")
    return T.array_type(args[0].value)


register(ScalarFunction("map_keys", _resolve_map_keys,
                        str_transform=lambda m: tuple(k for k, _ in m)))
register(ScalarFunction("map_values", _resolve_map_values,
                        str_transform=lambda m: tuple(v for _, v in m)))


# ---------------------------------------------------------------------------
# sketch primitives: HLL (approx_distinct) + DDSketch (approx_percentile)
#
# Reference analog: ``spi/type/setdigest/`` + ``operator/aggregation/``'s
# HyperLogLog state and ``airlift/stats`` digests. TPU-first redesign:
# sketches are not opaque binary accumulator states — the logical planner
# rewrites the aggregate onto RELATIONAL algebra over these row-level
# primitives (register id / rank for HLL, log-bucket for DDSketch), so
# partial/final merging and exchange transport reuse the engine's
# ordinary distributed group-by kernels (planner/logical_planner.py
# _plan_sketch_aggs).

HLL_BITS = 11            #: m = 2048 registers -> standard error ~2.3%
HLL_M = 1 << HLL_BITS
HLL_ALPHA = 0.7213 / (1.0 + 1.079 / HLL_M)

DD_GAMMA = 1.0202027073175195   #: relative accuracy alpha = 0.01
DD_OFFSET = 40000               #: keeps positive-value buckets positive


def _hash_u64_dev(raw, t):
    """Device value hash: the JAX engine's uint64 splitmix64 over the
    value's bits, held as int64. Floats hash their bit pattern (``+0.0``
    folds -0.0 in); a REAL hashes its 32 bits zero-extended."""
    from ..ops.kernels import splitmix64

    if t in (T.DOUBLE, T.REAL):
        x = raw + 0.0
        if x.dtype == torch.float64:
            k = x.view(torch.int64)
        else:
            k = x.to(torch.float32).view(torch.int32).to(torch.int64) \
                & 0xFFFFFFFF
    else:
        k = raw.to(torch.int64)
    return splitmix64(k)


def _hash_u64_host(v) -> int:
    """Host value hash for pooled (string/composite) arguments — any
    stable 64-bit digest works; bucket/rho only need consistency."""
    import hashlib

    digest = hashlib.blake2b(repr(v).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little")


def _resolve_sketchable(name):
    def resolve(args):
        (a,) = args
        if a == T.UNKNOWN:
            raise TypeError_(f"{name}() cannot hash NULL-typed input")
        return T.BIGINT

    return resolve


def _hll_bucket_host(v):
    return _hash_u64_host(v) & (HLL_M - 1)


def _hll_rho_host(v):
    rest = _hash_u64_host(v) >> HLL_BITS
    return 53 - rest.bit_length() + 1


def _hll_bucket_kernel(raws, arg_types, ret_type):
    return _hash_u64_dev(raws[0], arg_types[0]) & (HLL_M - 1)


def _bit_length(v):
    """Bit length of non-negative int64 lanes by halving (exact)."""
    bl = torch.zeros_like(v)
    x = v
    for s in (32, 16, 8, 4, 2, 1):
        m = x >= (1 << s)
        bl = bl + torch.where(m, s, 0)
        x = torch.where(m, x >> s, x)
    return bl + x


def _hll_rho_kernel(raws, arg_types, ret_type):
    from ..ops.kernels import _shr

    rest = _shr(_hash_u64_dev(raws[0], arg_types[0]), HLL_BITS)  # 53 bits
    return 53 - _bit_length(rest) + 1


register(ScalarFunction("$hll_bucket", _resolve_sketchable("$hll_bucket"),
                        _hll_bucket_kernel, str_scalar=_hll_bucket_host))
register(ScalarFunction("$hll_rho", _resolve_sketchable("$hll_rho"),
                        _hll_rho_kernel, str_scalar=_hll_rho_host))


def _resolve_dd_bucket(args):
    (a,) = args
    if not is_numeric(a):
        raise TypeError_(f"approx_percentile expects numeric, got {a}")
    return T.BIGINT


def _dd_bucket_kernel(raws, arg_types, ret_type):
    t = arg_types[0]
    x = raws[0].to(torch.float64)
    if t.is_decimal:
        x = x / float(10 ** t.scale)
    mag = torch.abs(x)
    lg = torch.log(torch.clamp(mag, min=1e-300)) / math.log(DD_GAMMA)
    b = _float_to_int64(torch.ceil(lg)) + DD_OFFSET
    return torch.where(mag < 1e-300, torch.zeros_like(b),
                       torch.where(x > 0, b, -b))


register(ScalarFunction("$dd_bucket", _resolve_dd_bucket,
                        _dd_bucket_kernel))


def _resolve_dd_value(args):
    return T.DOUBLE


def _dd_value_kernel(raws, arg_types, ret_type):
    b = raws[0]
    mag = torch.abs(b).to(torch.float64) - DD_OFFSET
    # geometric midpoint of the bucket (gamma^(b-1), gamma^b]
    val = torch.exp((mag - 0.5) * math.log(DD_GAMMA))
    return torch.where(b == 0, torch.zeros_like(val),
                       torch.where(b > 0, val, -val))


register(ScalarFunction("$dd_value", _resolve_dd_value, _dd_value_kernel))
