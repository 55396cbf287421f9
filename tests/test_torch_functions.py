"""Every scalar function body of the torch engine against the JAX engine's.

Each device body of ``trino_tpu_torch/expr/functions.py`` runs on the same
seeded numpy lanes as its counterpart in ``trino_tpu/expr/functions.py``:
negative operands, zero divisors (on every kind of lane: the kernels see
dead and NULL lanes too), NaN, -0.0 and infinities, dates before 1970,
decimal rescale edges, shift counts outside [0, 63], and literal (0-d)
operands. Integer, decimal, date and boolean lanes must be equal; DOUBLE
lanes within a relative 1e-12 (XLA and torch may round a transcendental
one ulp apart; XLA on the CPU flushes subnormal results to zero, so
DOUBLE lanes may also differ by the smallest normal number), NaN equal
to NaN. Then the same bodies run through both
engines' SQL paths over NULLs and padded pages.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trino_tpu import types as JT
from trino_tpu.expr import compiler as jcompiler
from trino_tpu.expr import functions as JF
from trino_tpu.expr import ir as jir
from trino_tpu import block as jblock
from trino_tpu.connectors.tpch import TpchConnector as JConnector
from trino_tpu.runner import LocalQueryRunner as JRunner
from trino_tpu.sql.analyzer import Session as JSession

import trino_tpu_torch as P
from trino_tpu_torch import interop
from trino_tpu_torch import types as PT
from trino_tpu_torch.connectors.tpch import TpchConnector as PConnector
from trino_tpu_torch.expr import compiler as pcompiler
from trino_tpu_torch.expr import functions as PF
from trino_tpu_torch.expr import ir as pir
from trino_tpu_torch.sql.analyzer import Session as PSession

torch.set_num_threads(2)

N = 96
TZ = "America/New_York"
DEC = "decimal(12,2)"
DEC4 = "decimal(12,4)"

#: the bodies q1 evaluates (tested in test_torch_expr.py)
Q1_BODIES = {"add", "subtract", "multiply", "eq", "ne", "lt", "le", "gt",
             "ge"}


def _types(spec):
    """(JAX type, torch type) of one argument spec."""
    if isinstance(spec, tuple):       # ("tz", zone)
        return JT.timestamp_tz_type(spec[1]), PT.timestamp_tz_type(spec[1])
    return JT.parse_type(spec), PT.parse_type(spec)


def _lanes(rng, spec, role):
    """Seeded raw lanes for one argument: ``role`` picks the range."""
    jt, _ = _types(spec)
    if role == "divisor":
        base = _lanes(rng, spec, "value")
        base[rng.random(N) < 0.25] = 0
        base[:4] = 0                   # lanes 0..3 always divide by zero
        return base
    if role == "digits":
        return rng.integers(-3, 6, N).astype(jt.storage)
    if role == "shift":
        return rng.integers(-3, 71, N).astype(jt.storage)
    if role == "unit":
        return np.full(N, 3_600_000_000, dtype=np.int64)
    if role == "bucket":
        return rng.integers(-45_000, 45_000, N).astype(np.int64)
    if jt in (JT.DOUBLE, JT.REAL):
        x = rng.normal(0, 50, N)
        x[:8] = [np.nan, -0.0, 0.0, np.inf, -np.inf, 2.5, -2.5, 0.5]
        if role == "unit_interval":
            x = np.clip(x / 100, -1, 1)
            x[0] = np.nan
        return x.astype(jt.storage)
    if jt == JT.BOOLEAN:
        return rng.random(N) < 0.5
    if jt == JT.DATE:                  # 1888 .. 2052, 1970-01-01 included
        x = rng.integers(-30_000, 30_000, N)
        x[:3] = [0, -1, 59]
        return x.astype(np.int32)
    if jt == JT.TIMESTAMP or isinstance(spec, tuple):
        x = rng.integers(-2 * 10 ** 15, 2 * 10 ** 15, N)
        x[:2] = [0, -1]
        return x.astype(np.int64)
    if jt == JT.INTERVAL_DAY_SECOND:
        return rng.integers(-10 ** 12, 10 ** 12, N).astype(np.int64)
    if jt.is_decimal:                  # up to the type's digits, both signs
        hi = 10 ** (jt.precision - 2)
        x = rng.integers(-hi, hi, N)
        x[:6] = [5, -5, 15, -15, 10 ** jt.scale // 2, -(10 ** jt.scale // 2)]
        return x.astype(np.int64)
    lim = {JT.TINYINT: 100, JT.SMALLINT: 30_000, JT.INTEGER: 2 ** 31 - 1,
           JT.BIGINT: 2 ** 62}[jt]
    x = rng.integers(-min(lim, 10 ** 6), min(lim, 10 ** 6), N)
    x[:4] = [7, -7, 7, -7]
    return x.astype(jt.storage)


# (function, argument specs, argument roles, scalar argument positions)
V = "value"
CASES = [
    *[("divide", a, (V, "divisor"), s) for a, s in [
        (("bigint", "bigint"), ()), (("integer", "bigint"), ()),
        (("integer", "integer"), (1,)), ((DEC, "decimal(10,3)"), ()),
        ((DEC, "integer"), ()), ((DEC, DEC4), (1,)),
        (("double", "bigint"), ()), (("real", "real"), ())]],
    *[(f, a, (V, "divisor"), s) for f in ("mod", "modulus") for a, s in [
        (("bigint", "bigint"), ()), (("integer", "bigint"), (1,)),
        (("integer", "integer"), ()), ((DEC, "decimal(10,3)"), ()),
        ((DEC, "integer"), ()), (("double", "double"), ()),
        (("real", "double"), ())]],
    *[("negate", (t,), (V,), ()) for t in
      ("bigint", "integer", DEC, "double", "interval day to second")],
    *[("abs", (t,), (V,), ()) for t in ("integer", "bigint", DEC, "double",
                                        "real")],
    *[("round", a, r, s) for a, r, s in [
        (("double",), (V,), ()), (("double", "integer"), (V, "digits"), ()),
        (("real",), (V,), ()), (("real", "integer"), (V, "digits"), (1,)),
        ((DEC,), (V,), ()), ((DEC4, "integer"), (V, "digits"), ()),
        (("bigint",), (V,), ())]],
    *[(f, (t,), (V,), ()) for f in ("floor", "ceil", "ceiling")
      for t in (DEC, DEC4, "double", "real", "bigint")],
    *[(f, a, (V,) * len(a), ()) for f in ("greatest", "least") for a in [
        ("bigint", "integer"), (DEC, "integer"), ("double", "bigint"),
        (DEC, DEC4, "integer"), ("date", "date")]],
    *[("sign", (t,), (V,), ()) for t in ("bigint", "integer", DEC,
                                         "double", "real")],
    *[("truncate", a, r, ()) for a, r in [
        (("double",), (V,)), (("double", "integer"), (V, "digits")),
        ((DEC4,), (V,)), ((DEC4, "integer"), (V, "digits")),
        (("bigint",), (V,))]],
    *[(f, a, (V, V), ()) for f in ("power", "pow", "atan2", "log")
      for a in [("double", "double"), ("bigint", "double"), (DEC, "integer")]],
    *[(f, (t,), (V,), ()) for f in
      ("sqrt", "ln", "log10", "log2", "exp", "sin", "cos", "tan", "cbrt",
       "atan", "sinh", "cosh", "tanh", "degrees", "radians")
      for t in ("double", DEC, "bigint")],
    *[(f, ("double",), ("unit_interval",), ()) for f in ("asin", "acos")],
    *[(f, (t,), (V,), ()) for f in ("is_nan", "is_finite", "is_infinite")
      for t in ("double", "real", DEC)],
    *[(f, (), (), ()) for f in ("pi", "e", "nan", "infinity")],
    *[(f, ("bigint", "bigint"), (V, V), ()) for f in
      ("bitwise_and", "bitwise_or", "bitwise_xor")],
    ("bitwise_not", ("integer",), (V,), ()),
    *[(f, ("bigint", "integer"), (V, "shift"), ()) for f in
      ("bitwise_left_shift", "bitwise_right_shift")],
    ("bitwise_right_shift", ("bigint", "bigint"), (V, "shift"), (1,)),
    *[(f, (t,), (V,), ()) for f in
      [f"$extract_{p}" for p in ("year", "month", "day", "quarter",
                                 "day_of_week", "day_of_year", "week",
                                 "hour", "minute", "second", "millisecond")]
      + ["year", "month", "day", "quarter", "hour", "minute", "second",
         "millisecond", "day_of_week", "dow", "day_of_year", "doy", "week",
         "week_of_year"]
      for t in ("date", "timestamp", ("tz", TZ))],
    *[(f"$date_trunc_{u}", (t,), (V,), ()) for u in
      ("year", "quarter", "month", "week", "day", "hour", "minute", "second")
      for t in ("date", "timestamp", ("tz", TZ), ("tz", "+05:30"))],
    *[("last_day_of_month", (t,), (V,), ()) for t in ("date", "timestamp")],
    *[("to_unixtime", (t,), (V,), ()) for t in ("timestamp", ("tz", TZ))],
    *[("from_unixtime", (t,), (V,), ()) for t in ("double", "bigint", DEC)],
    ("$ts_diff", ("timestamp", "timestamp", "bigint"), (V, V, "unit"), (2,)),
    *[(f, (t,), (V,), ()) for f in ("$hll_bucket", "$hll_rho")
      for t in ("bigint", "integer", "double", "real", "boolean", "date",
                DEC)],
    *[("$dd_bucket", (t,), (V,), ()) for t in ("double", DEC, "bigint")],
    ("$dd_value", ("bigint",), ("bucket",), ()),
]


def _case_id(case):
    name, specs, _, scalars = case
    args = ",".join(s if isinstance(s, str) else f"tz {s[1]}"
                    for s in specs)
    return f"{name}({args}){'~scalar' + str(scalars) if scalars else ''}"


def _assert_lanes_equal(got, want, what):
    got = np.broadcast_to(np.asarray(got), want.shape)
    if want.dtype.kind == "f":
        assert got.dtype.kind == "f", what
        g, w = got.astype(np.float64), want.astype(np.float64)
        nan = np.isnan(w)
        np.testing.assert_array_equal(np.isnan(g), nan, err_msg=what)
        # XLA flushes subnormals to zero: the smallest normal is the atol
        np.testing.assert_allclose(g[~nan], w[~nan], rtol=1e-12,
                                   atol=np.finfo(want.dtype).tiny,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_body_equals_jax(case):
    name, specs, roles, scalars = case
    rng = np.random.default_rng(abs(hash(_case_id(case))) % 2 ** 32)
    types_ = [_types(s) for s in specs]
    jts, pts = [t[0] for t in types_], [t[1] for t in types_]
    jf, pf = JF.get_function(name), PF.get_function(name)
    jret = jf.resolve(jts)
    pret = pf.resolve(pts)
    assert pret.name == jret.name
    raws = []
    for i, (spec, role) in enumerate(zip(specs, roles)):
        x = _lanes(rng, spec, role)
        raws.append(x[:1].reshape(()) if i in scalars else x)
    want = np.asarray(jf.kernel([jnp.asarray(x) for x in raws], jts, jret))
    got = pf.kernel([torch.from_numpy(np.array(x)) for x in raws], pts,
                    pret)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    shape = (N,) if specs and len(scalars) < len(specs) else ()
    want = np.broadcast_to(want, shape).astype(jret.storage)
    got = np.broadcast_to(got, shape).astype(jret.storage)
    if name in ("mod", "modulus") and not jret.storage.kind == "f":
        # the JAX engine's integer mod is wrong for a negative divisor
        # (test_mod_takes_the_dividend_sign): compare the other lanes
        keep = np.broadcast_to(raws[1] >= 0, shape)
        got, want = got[keep], want[keep]
    _assert_lanes_equal(got, want, _case_id(case))


@pytest.mark.parametrize("specs", [("bigint", "bigint"),
                                   ("integer", "bigint"),
                                   (DEC, "decimal(10,3)"), (DEC, "integer")])
def test_mod_takes_the_dividend_sign(specs):
    """SQL mod is the truncated remainder: the sign of the dividend, for
    either sign of the divisor (x mod 0 is 0, as x / 0 is x). The JAX
    engine gets a negative divisor wrong (its mod(7, -2) is 13); the
    torch engine departs from it there."""
    rng = np.random.default_rng(21)
    (ja, pa), (jb, pb) = (_types(s) for s in specs)
    a = _lanes(rng, specs[0], V)
    b = _lanes(rng, specs[1], "divisor")
    ret = PF.get_function("mod").resolve([pa, pb])
    got = PF.get_function("mod").kernel(
        [torch.from_numpy(a), torch.from_numpy(b)], [pa, pb], ret).numpy()
    sa = ret.scale - (pa.scale if pa.is_decimal else 0) if ret.is_decimal \
        else 0
    sb = ret.scale - (pb.scale if pb.is_decimal else 0) if ret.is_decimal \
        else 0
    ra = [int(x) * 10 ** sa for x in a]
    rb = [int(y) * 10 ** sb for y in b]
    want = [0 if y == 0 else int(math.copysign(abs(x) % abs(y), x))
            for x, y in zip(ra, rb)]
    np.testing.assert_array_equal(got.astype(np.int64), want)
    jret = JF.get_function("mod").resolve([ja, jb])
    jgot = np.asarray(JF.get_function("mod").kernel(
        [jnp.asarray(a), jnp.asarray(b)], [ja, jb], jret))
    neg = b < 0
    assert neg.any() and (jgot[neg] != got[neg]).any()
    np.testing.assert_array_equal(jgot[~neg], got[~neg])


def test_every_formerly_unported_body_is_tested():
    """Each device body beyond q1's has a case above, and none raises."""
    bodies = {n for n, f in JF.REGISTRY.items() if f.kernel is not None}
    tested = {c[0] for c in CASES}
    assert bodies - Q1_BODIES == tested
    assert all(PF.REGISTRY[n].kernel is not None for n in bodies)


# ------------------------------------------------------- through the SQL


def _runners():
    jr = JRunner({"tpch": JConnector()},
                 JSession(catalog="tpch", schema="micro"))
    pr = P.LocalQueryRunner({"tpch": PConnector()},
                            PSession(catalog="tpch", schema="micro"),
                            device="cpu")
    return jr, pr


def _same_rows(a, b):
    assert len(a) == len(b), (a, b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            assert type(x) is type(y), (ra, rb)
            if isinstance(x, float) and math.isnan(x):
                assert math.isnan(y), (ra, rb)
            elif isinstance(x, float):
                assert math.isclose(x, y, rel_tol=1e-12), (ra, rb)
            else:
                assert x == y, (ra, rb)


VALUES = ("(values (7, 2, cast(1.25 as decimal(12,2)), date '1969-12-31', "
          "-3.5e0), (-7, 0, cast(-0.05 as decimal(12,2)), date '1900-02-28', "
          "cast('NaN' as double)), (null, 3, null, null, null), "
          "(-9, 4, cast(99.99 as decimal(12,2)), date '2000-02-29', "
          "cast('-0.0' as double))) as t (a, b, d, dt, x)")


@pytest.mark.parametrize("exprs", [
    "a / b, a % b, mod(a, b), -a, abs(a), d / b, mod(d, 0.3), d / 0.00",
    "round(d), round(d, 1), round(x), round(x, 1), floor(d), ceil(x), "
    "truncate(d), sign(x), sign(a), greatest(a, b, 0), least(d, a)",
    "year(dt), month(dt), day(dt), quarter(dt), day_of_week(dt), "
    "day_of_year(dt), week(dt), extract(year from dt), "
    "date_trunc('month', dt), date_trunc('week', dt), "
    "last_day_of_month(dt)",
    "power(a, 2), sqrt(abs(x)), ln(abs(d)), exp(b), is_nan(x), pi(), "
    "bitwise_and(a, b), bitwise_right_shift(a, 1), "
    "bitwise_left_shift(b, 70)",
    "approx_distinct(x)",
    "approx_percentile(d, 0.5)",
    "approx_percentile(x, 0.9)",
])
def test_sql_over_nulls_equals_jax(exprs):
    """The bodies behind SQL, over NULLs and zero divisors on live rows."""
    sql = f"select {exprs} from {VALUES}"
    jr, pr = _runners()
    _same_rows(pr.execute(sql).rows, jr.execute(sql).rows)


def test_sql_mod_by_a_negative_divisor():
    """The torch engine's SQL answer; the JAX engine's differs here."""
    sql = ("select mod(7, -2), mod(-7, -2), -7 % 2, "
           "mod(cast(7.5 as decimal(3,1)), -2), mod(7, 0)")
    jr, pr = _runners()
    from decimal import Decimal

    assert pr.execute(sql).rows == [(1, -1, -1, Decimal("1.5"), 0)]
    assert jr.execute(sql).rows != pr.execute(sql).rows


def test_zero_divisors_on_dead_lanes_equal_jax():
    """A padded page whose dead lanes hold 0 in the divisor: integer
    divide and mod run on every lane and the live lanes equal the JAX
    engine's."""
    cap, n = 64, 41
    rng = np.random.default_rng(11)
    a = rng.integers(-50, 50, cap).astype(np.int64)
    b = rng.integers(-5, 5, cap).astype(np.int64)
    b[n:] = 0
    nulls = [rng.random(cap) < 0.1, rng.random(cap) < 0.1]
    valid = np.arange(cap) < n
    jtypes, ptypes = [JT.BIGINT, JT.BIGINT], [PT.BIGINT, PT.BIGINT]

    def exprs(M, T, F):
        x, y = M.InputRef(T.BIGINT, 0), M.InputRef(T.BIGINT, 1)
        return [M.Call(T.BIGINT, f, (x, y)) for f in ("divide", "mod")]

    jpage = jblock.DevicePage(jtypes, [jnp.asarray(a), jnp.asarray(b)],
                              [jnp.asarray(x) for x in nulls],
                              jnp.asarray(valid), [None, None])
    jout = jcompiler.PageProcessor(jtypes, exprs(jir, JT, JF)).process(jpage)
    pout = pcompiler.PageProcessor(ptypes, exprs(pir, PT, PF)).process(
        interop.device_page_from_numpy(ptypes, [a, b], nulls, valid,
                                       [None, None], "cpu"))
    for f, jc, pc, jn in zip(("divide", "mod"), jout.cols, pout.cols,
                             jout.nulls):
        live = valid & ~np.asarray(jn)
        if f == "mod":   # see test_mod_takes_the_dividend_sign
            live &= b >= 0
        np.testing.assert_array_equal(pc.numpy()[live],
                                      np.asarray(jc)[live])
