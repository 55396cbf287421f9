"""The torch engine's PageProcessor against the JAX engine's.

One page of numpy lanes goes through ``trino_tpu.expr.compiler``'s
PageProcessor and, via ``trino_tpu_torch.interop``, through the torch
engine's. Output columns, null masks, the valid mask and the output
dictionaries must be equal lane for lane: integer, decimal, boolean and
string-code lanes exactly; DOUBLE lanes within a relative 1e-15 (XLA may
turn a division by a constant into a multiplication by its reciprocal,
one rounding apart from torch's division).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import trino_tpu_torch as P
from trino_tpu import block as jblock
from trino_tpu import types as JT
from trino_tpu.connectors.tpch import TpchConnector as JConnector
from trino_tpu.expr import compiler as jcompiler
from trino_tpu.expr import functions as JF
from trino_tpu.expr import ir as jir
from trino_tpu.planner import plan as jplan
from trino_tpu.planner.symbols import to_input_refs as j_to_input_refs
from trino_tpu.resources.tpch_queries import TPCH_QUERIES
from trino_tpu.runner import LocalQueryRunner as JRunner
from trino_tpu.sql.analyzer import Session as JSession
from trino_tpu_torch import interop
from trino_tpu_torch import types as PT
from trino_tpu_torch.connectors.tpch import TpchConnector as PConnector
from trino_tpu_torch.expr import compiler as pcompiler
from trino_tpu_torch.expr import functions as PF
from trino_tpu_torch.expr import ir as pir
from trino_tpu_torch.planner import plan as pplan
from trino_tpu_torch.planner.symbols import to_input_refs as p_to_input_refs
from trino_tpu_torch.sql.analyzer import Session as PSession
from trino_tpu_torch.sql.parser import parse_statement as p_parse
from trino_tpu_torch.types import TrinoError

torch.set_num_threads(2)


def _to_port(jpage):
    """A JAX DevicePage's lanes as a torch DevicePage on the CPU."""
    return interop.device_page_from_numpy(
        [PT.parse_type(t.name) for t in jpage.types],
        [np.asarray(c) for c in jpage.cols],
        [np.asarray(n) for n in jpage.nulls], np.asarray(jpage.valid),
        [d.values if d is not None else None for d in jpage.dictionaries],
        device="cpu")


def _assert_same_lanes(jout, pout):
    np.testing.assert_array_equal(pout.valid.numpy(), np.asarray(jout.valid))
    assert [t.name for t in pout.types] == [t.name for t in jout.types]
    for i, (jc, pc, jn, pn) in enumerate(zip(jout.cols, pout.cols,
                                             jout.nulls, pout.nulls)):
        np.testing.assert_array_equal(pn.numpy(), np.asarray(jn),
                                      err_msg=f"nulls of column {i}")
        live = ~np.asarray(jn)
        got, want = pc.numpy()[live], np.asarray(jc)[live]
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=1e-15, atol=0,
                                       err_msg=f"column {i}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"column {i}")
        jd, pd = jout.dictionaries[i], pout.dictionaries[i]
        assert (jd is None) == (pd is None)
        if jd is not None:
            assert pd.values == jd.values


def _q1_filter_project(root, plan_mod, to_input_refs):
    """(scan, filter predicate, projections) of q1's plan, bound to the
    scan's channel layout."""
    node, chain = root, []
    while not isinstance(node, plan_mod.TableScanNode):
        chain.append(node)
        node = node.sources[0]
    layout = {s.name: i for i, (s, _) in enumerate(node.assignments)}
    filt = next(n for n in chain if isinstance(n, plan_mod.FilterNode))
    proj = next(n for n in chain if isinstance(n, plan_mod.ProjectNode)
                and n.sources[0] is filt)
    return (node, to_input_refs(filt.predicate, layout),
            [to_input_refs(e, layout) for _, e in proj.assignments])


@pytest.mark.parametrize("schema", ["micro", "tiny"])
def test_q1_filter_and_projections_equal_jax(schema):
    sql = TPCH_QUERIES[1]
    jroot = JRunner({"tpch": JConnector()},
                    JSession(catalog="tpch", schema=schema)).create_plan(sql)
    proot = P.LocalQueryRunner({"tpch": PConnector()},
                               PSession(catalog="tpch", schema=schema),
                               device="cpu").plan_statement(p_parse(sql))
    jscan, jpred, jprojs = _q1_filter_project(jroot, jplan, j_to_input_refs)
    pscan, ppred, pprojs = _q1_filter_project(proot, pplan, p_to_input_refs)
    assert repr(ppred) == repr(jpred)
    assert [repr(e) for e in pprojs] == [repr(e) for e in jprojs]
    jtypes = [s.type for s, _ in jscan.assignments]
    ptypes = [s.type for s, _ in pscan.assignments]
    conn = JConnector()
    split = conn.split_manager().get_splits(jscan.table, 1)[0]
    src = conn.page_source(split, [c for _, c in jscan.assignments])
    page = src.get_next_page()
    jpage = jblock.DevicePage.from_page(page)
    jout = jcompiler.PageProcessor(jtypes, jprojs, jpred).process(jpage)
    pout = pcompiler.PageProcessor(ptypes, pprojs, ppred).process(
        _to_port(jpage))
    assert int(np.asarray(jout.valid).sum()) > 0
    _assert_same_lanes(jout, pout)


# --------------------------------------------------------------- breadth


def _exprs(M, T, F):
    """Expressions over the synthetic page, built in one engine's IR."""
    c = M.InputRef
    lit = M.Literal
    d12 = T.decimal_type(12, 2)

    def call(name, *args):
        t = F.get_function(name).resolve([a.type for a in args])
        return M.Call(t, name, tuple(args))

    i32, i64, dec = c(T.INTEGER, 0), c(T.BIGINT, 1), c(d12, 2)
    s, day, ts = c(T.varchar_type(None), 3), c(T.DATE, 4), c(T.TIMESTAMP, 5)
    b = c(T.BOOLEAN, 6)
    B = T.BOOLEAN
    return [
        call("add", i32, lit(T.BIGINT, 2 ** 40)),          # widening
        M.Call(B, "gt", (i32, lit(T.BIGINT, 2 ** 40))),    # no narrowing
        call("subtract", i64, i32),
        call("multiply", dec, call("subtract", lit(T.BIGINT, 1), dec)),
        call("add", dec, i32),
        M.Call(B, "le", (dec, lit(d12, 5000))),
        M.Call(T.DOUBLE, "$cast", (dec,)),
        M.Call(T.BIGINT, "$cast", (dec,)),
        call("add", day, lit(T.INTERVAL_YEAR_MONTH, 13)),
        call("subtract", day, lit(T.INTERVAL_DAY_SECOND,
                                  3 * 86_400_000_000)),
        call("add", ts, lit(T.INTERVAL_YEAR_MONTH, -1)),
        M.Call(T.BIGINT, "subtract", (day, day)),
        M.Call(B, "$and", (b, M.Call(B, "lt", (i64, lit(T.BIGINT, 0))))),
        M.Call(B, "$or", (b, M.Call(B, "$is_null", (i32,)))),
        M.Call(B, "$not", (b,)),
        M.Call(T.BIGINT, "$coalesce", (i64, M.Call(T.BIGINT, "$cast",
                                                   (i32,)))),
        M.Call(T.INTEGER, "$if", (b, i32, lit(T.INTEGER, -7))),
        M.Call(T.INTEGER, "$case", (M.Call(B, "gt", (i32, lit(T.INTEGER,
                                                               0))),
                                    lit(T.INTEGER, 1),
                                    M.Call(B, "lt", (i32, lit(T.INTEGER,
                                                              0))),
                                    lit(T.INTEGER, -1), lit(T.INTEGER, 0))),
        M.Call(B, "$in", (i32, lit(T.INTEGER, 3), lit(T.INTEGER, -2),
                          lit(T.INTEGER, None))),
        M.Call(B, "$between", (i64, lit(T.BIGINT, -100),
                               lit(T.BIGINT, 100))),
        M.Call(B, "eq", (s, lit(T.varchar_type(None), "R"))),
        M.Call(B, "lt", (s, lit(T.varchar_type(None), "N"))),
        M.Call(B, "$like", (s, lit(T.varchar_type(None), "%a%"))),
        M.Call(B, "$in", (s, lit(T.varchar_type(None), "A"),
                          lit(T.varchar_type(None), "RA"))),
        s,
        M.Call(T.varchar_type(None), "$if", (b, s, lit(
            T.varchar_type(None), "zz"))),
        call("length", s),
        call("upper", s),
    ]


def _synthetic_page(types):
    rng = np.random.default_rng(5)
    cap, n = 64, 57
    words = ["R", "A", "N", "banana", "RA", "", "car"]
    cols = [rng.integers(-5, 6, cap).astype(np.int32),
            rng.integers(-300, 300, cap).astype(np.int64),
            rng.integers(-999_999, 999_999, cap).astype(np.int64),
            rng.integers(0, len(words), cap).astype(np.int32),
            rng.integers(-800, 20_000, cap).astype(np.int32),
            rng.integers(-10 ** 15, 10 ** 15, cap).astype(np.int64),
            rng.random(cap) < 0.5]
    nulls = [rng.random(cap) < 0.15 for _ in cols]
    valid = np.arange(cap) < n
    pools = [None, None, None, words, None, None, None]
    jpage = jblock.DevicePage(
        types, [jnp.asarray(c) for c in cols],
        [jnp.asarray(nl) for nl in nulls], jnp.asarray(valid),
        [jblock.Dictionary.aligned(p) if p else None for p in pools])
    return jpage


def test_expression_breadth_equal_jax():
    jtypes = [JT.INTEGER, JT.BIGINT, JT.decimal_type(12, 2),
              JT.varchar_type(None), JT.DATE, JT.TIMESTAMP, JT.BOOLEAN]
    ptypes = [PT.parse_type(t.name) for t in jtypes]
    jexprs = _exprs(jir, JT, JF)
    pexprs = _exprs(pir, PT, PF)
    assert [repr(e) for e in pexprs] == [repr(e) for e in jexprs]
    jpage = _synthetic_page(jtypes)
    jpred, ppred = jexprs[5], pexprs[5]  # dec <= 50.00 as the filter
    jout = jcompiler.PageProcessor(jtypes, jexprs, jpred).process(jpage)
    pout = pcompiler.PageProcessor(ptypes, pexprs, ppred).process(
        _to_port(jpage))
    _assert_same_lanes(jout, pout)


@pytest.mark.parametrize("name", ["divide", "abs", "round", "year"])
def test_unported_functions_raise_not_supported(name):
    args = [pir.InputRef(PT.DOUBLE, 0)] * (2 if name == "divide" else 1)
    if name == "year":
        args = [pir.InputRef(PT.DATE, 1)]
    t = PF.get_function(name).resolve([a.type for a in args])
    proc = pcompiler.PageProcessor([PT.DOUBLE, PT.DATE],
                                   [pir.Call(t, name, tuple(args))])
    page = interop.device_page_from_numpy(
        [PT.DOUBLE, PT.DATE], [np.ones(16), np.zeros(16, np.int32)],
        [np.zeros(16, bool)] * 2, np.ones(16, bool), [None, None], "cpu")
    with pytest.raises(TrinoError) as e:
        proc.process(page)
    assert e.value.code == "NOT_SUPPORTED"


def test_registry_resolves_like_jax():
    """Every function the JAX engine registers resolves to the same type
    in the torch engine (the analyzer depends on it)."""
    assert sorted(PF.REGISTRY) == sorted(JF.REGISTRY)
    probes = [[JT.BIGINT, JT.BIGINT], [JT.decimal_type(12, 2), JT.INTEGER],
              [JT.DOUBLE], [JT.DATE], [JT.varchar_type(None)],
              [JT.DATE, JT.INTERVAL_DAY_SECOND]]
    for name, jf in JF.REGISTRY.items():
        pf = PF.REGISTRY[name]
        assert (pf.str_transform is None) == (jf.str_transform is None)
        assert (pf.str_scalar is None) == (jf.str_scalar is None)
        assert (pf.kernel is None) == (jf.kernel is None)
        for args in probes:
            try:
                want = jf.resolve(args).name
            except Exception as e:  # noqa: BLE001 — compare failures too
                want = type(e).__name__
            try:
                got = pf.resolve([PT.parse_type(a.name) for a in args]).name
            except Exception as e:  # noqa: BLE001
                got = type(e).__name__
            assert got == want, (name, args)
