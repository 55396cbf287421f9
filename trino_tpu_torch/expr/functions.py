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

The registry and every ``resolve`` are the JAX engine's
(``trino_tpu/expr/functions.py``), so the analyzer types every function
the same way. The torch engine has device bodies for the functions TPC-H
q1 evaluates: ``add``, ``subtract`` (numbers, dates and timestamps with
intervals), ``multiply`` and the six comparisons, with their helpers
``rescale``, ``div_round_half_up``, ``coerce_raw`` and the civil-calendar
math. Every other device body raises NOT_SUPPORTED when called
(``_unported``); the host string/array transforms are complete.

torch promotes a 0-d tensor into a dimensioned one's dtype where JAX
(with x64) promotes to the wider type, so kernels cast explicitly
(``_promote``); floor division is ``torch.div(..., rounding_mode="floor")``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from .. import types as T
from ..block import storage_dtype
from ..types import TrinoError, TypeError_, is_numeric


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


def _unported(name: str):
    """The device body of a function the torch engine has not ported."""
    def kernel(raws, arg_types, ret_type):
        raise TrinoError(f"function {name} has no torch kernel yet",
                         "NOT_SUPPORTED")

    return kernel


# ---------------------------------------------------------------------------
# helpers

_POW10 = [10 ** i for i in range(19)]
_DAY_US = 86_400_000_000


def _floordiv(x, y):
    return torch.div(x, y, rounding_mode="floor")


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


register(ScalarFunction("divide", _resolve_div, _unported("divide")))


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


register(ScalarFunction("modulus", _resolve_mod, _unported("modulus")))
register(ScalarFunction("mod", _resolve_mod, _unported("mod")))


def _resolve_negate(args):
    (a,) = args
    if _is_int(a) or _is_float(a) or a.is_decimal or a in (
            T.INTERVAL_DAY_SECOND, T.INTERVAL_YEAR_MONTH):
        return a
    raise TypeError_(f"cannot negate {a}")


register(ScalarFunction("negate", _resolve_negate, _unported("negate")))


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


register(ScalarFunction("sqrt", _resolve_unary_double, _unported("sqrt")))
register(ScalarFunction("ln", _resolve_unary_double, _unported("ln")))
register(ScalarFunction("log10", _resolve_unary_double, _unported("log10")))
register(ScalarFunction("exp", _resolve_unary_double, _unported("exp")))
register(ScalarFunction("sin", _resolve_unary_double, _unported("sin")))
register(ScalarFunction("cos", _resolve_unary_double, _unported("cos")))
register(ScalarFunction("tan", _resolve_unary_double, _unported("tan")))


def _resolve_same(args):
    (a,) = args
    if _is_int(a) or _is_float(a) or a.is_decimal:
        return a
    raise TypeError_(f"expected numeric, got {a}")


register(ScalarFunction("abs", _resolve_same, _unported("abs")))


def _resolve_power(args):
    a, b = args
    if _numeric_pair(a, b):
        return T.DOUBLE
    raise TypeError_(f"cannot power {a}, {b}")


register(ScalarFunction("power", _resolve_power, _unported("power")))
register(ScalarFunction("pow", _resolve_power, _unported("pow")))


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


register(ScalarFunction("round", _resolve_round, _unported("round")))


def _resolve_floor_ceil(args):
    (a,) = args
    if a.is_decimal:
        return T.decimal_type(min(18, a.precision - a.scale + 1), 0)
    if _is_int(a) or _is_float(a):
        return a
    raise TypeError_(f"cannot floor/ceil {a}")


register(ScalarFunction("floor", _resolve_floor_ceil, _unported("floor")))
register(ScalarFunction("ceil", _resolve_floor_ceil, _unported("ceil")))
register(ScalarFunction("ceiling", _resolve_floor_ceil,
                        _unported("ceiling")))


def _resolve_greatest(args):
    t = args[0]
    for a in args[1:]:
        t2 = T.common_super_type(t, a)
        if t2 is None:
            raise TypeError_(f"greatest/least mixed types {t}, {a}")
        t = t2
    return t


register(ScalarFunction("greatest", _resolve_greatest,
                        _unported("greatest")))
register(ScalarFunction("least", _resolve_greatest, _unported("least")))


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


for _p in ["year", "month", "day", "quarter", "day_of_week", "day_of_year",
           "week", "hour", "minute", "second", "millisecond"]:
    register(ScalarFunction(f"$extract_{_p}", _resolve_date_part,
                            _unported(f"$extract_{_p}")))
for _n in ("hour", "minute", "second", "millisecond", "year", "month", "day",
           "quarter"):
    register(ScalarFunction(_n, _resolve_date_part, _unported(_n)))


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


for _n in ("power", "pow", "atan2", "log"):
    register(ScalarFunction(_n, _resolve_binary_double, _unported(_n)))

for _n in ("cbrt", "asin", "acos", "atan", "sinh", "cosh", "tanh",
           "degrees", "radians", "log2"):
    register(ScalarFunction(_n, _resolve_unary_double, _unported(_n)))


def _resolve_sign(args):
    (a,) = args
    if not is_numeric(a):
        raise TypeError_(f"sign expects numeric, got {a}")
    return T.DOUBLE if a in (T.REAL, T.DOUBLE) else T.BIGINT


register(ScalarFunction("sign", _resolve_sign, _unported("sign")))


def _resolve_truncate(args):
    if not (1 <= len(args) <= 2):
        raise TypeError_(f"truncate expects 1-2 arguments, got {len(args)}")
    if not is_numeric(args[0]):
        raise TypeError_(f"truncate expects numeric, got {args[0]}")
    if len(args) == 2 and not _is_int(args[1]):
        raise TypeError_("truncate digit count must be an integer")
    return T.DOUBLE if args[0] in (T.REAL, T.DOUBLE) else args[0]


register(ScalarFunction("truncate", _resolve_truncate,
                        _unported("truncate")))


def _resolve_double_predicate(args):
    if not is_numeric(args[0]):
        raise TypeError_(f"expected numeric, got {args[0]}")
    return T.BOOLEAN


for _n in ("is_nan", "is_finite", "is_infinite"):
    register(ScalarFunction(_n, _resolve_double_predicate, _unported(_n)))

for _n in ("pi", "e", "nan", "infinity"):
    register(ScalarFunction(
        _n, lambda args, _n=_n: T.DOUBLE if not args
        else (_ for _ in ()).throw(TypeError_(f"{_n} takes no args")),
        _unported(_n)))


# bitwise (reference: operator/scalar/BitwiseFunctions.java)

def _resolve_bitwise(args):
    for a in args:
        if not _is_int(a):
            raise TypeError_(f"bitwise function expects integers, got {a}")
    return T.BIGINT


for _n in ("bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
           "bitwise_left_shift", "bitwise_right_shift"):
    register(ScalarFunction(_n, _resolve_bitwise, _unported(_n)))


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

def _resolve_trunc_unit(args):
    (a,) = args
    if a in (T.DATE, T.TIMESTAMP) or a.is_timestamp_tz:
        return a
    raise TypeError_(f"date_trunc expects date/timestamp, got {a}")


for _u in ("year", "quarter", "month", "week", "day", "hour", "minute",
           "second"):
    register(ScalarFunction(f"$date_trunc_{_u}", _resolve_trunc_unit,
                            _unported(f"$date_trunc_{_u}")))

for _n in ("day_of_week", "dow", "day_of_year", "doy", "week",
           "week_of_year"):
    register(ScalarFunction(_n, _resolve_date_part, _unported(_n)))


def _resolve_last_day(args):
    if args[0] not in (T.DATE, T.TIMESTAMP):
        raise TypeError_("last_day_of_month expects date/timestamp")
    return T.DATE


register(ScalarFunction("last_day_of_month", _resolve_last_day,
                        _unported("last_day_of_month")))


def _resolve_to_unixtime(args):
    if args[0] not in (T.TIMESTAMP,) and not args[0].is_timestamp_tz:
        raise TypeError_("to_unixtime expects a timestamp")
    return T.DOUBLE


register(ScalarFunction("to_unixtime", _resolve_to_unixtime,
                        _unported("to_unixtime")))


def _resolve_from_unixtime(args):
    if not is_numeric(args[0]):
        raise TypeError_("from_unixtime expects numeric seconds")
    return T.timestamp_tz_type("UTC")


register(ScalarFunction("from_unixtime", _resolve_from_unixtime,
                        _unported("from_unixtime")))


def _resolve_ts_diff(args):
    return T.BIGINT


register(ScalarFunction("$ts_diff", _resolve_ts_diff, _unported("$ts_diff")))


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


register(ScalarFunction("$hll_bucket", _resolve_sketchable("$hll_bucket"),
                        _unported("$hll_bucket"),
                        str_scalar=_hll_bucket_host))
register(ScalarFunction("$hll_rho", _resolve_sketchable("$hll_rho"),
                        _unported("$hll_rho"), str_scalar=_hll_rho_host))


def _resolve_dd_bucket(args):
    (a,) = args
    if not is_numeric(a):
        raise TypeError_(f"approx_percentile expects numeric, got {a}")
    return T.BIGINT


register(ScalarFunction("$dd_bucket", _resolve_dd_bucket,
                        _unported("$dd_bucket")))


def _resolve_dd_value(args):
    return T.DOUBLE


register(ScalarFunction("$dd_value", _resolve_dd_value,
                        _unported("$dd_value")))
