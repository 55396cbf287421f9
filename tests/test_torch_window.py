"""Window functions and grouped top-N: the torch engine against the JAX
engine.

At the SQL level, the window and ranking SQL of ``tests/test_window.py``
and ``tests/test_grouped_topn.py`` (their memory tables as VALUES) and
more runs through both engines; rows must be equal (in order under a
total ORDER BY, else as sorted lists). Then the kernels lane for lane, on
seeded numpy inputs with NULLs, ties, NaN, -0.0 and padding lanes:
``_window_kernel`` for every function and every frame kind,
``_topn_kernel``, ``_seg_scan``, ``_suffix_seg_scan`` and
``_range_query``. Integer, decimal and date lanes must be equal, MIN/MAX
of DOUBLE too; a DOUBLE sum is added in another order (torch's log-step
scan, XLA's associative scan), so it must agree within a relative 1e-12
of the largest prefix sum in its partition.

``_topn_kernel`` sorts unstably in the JAX engine and stably here, so the
``row_number`` cases order uniquely within each partition.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import GROUPED_TOPN_SQL, WINDOW_AGGS_SQL, _unscaled, \
    window_oracle
from test_torch_tpch_q1 import _runners, _same_rows
from trino_tpu import types as JT
from trino_tpu.ops import grouped_topn as jtopn
from trino_tpu.ops import sortkeys as jsk
from trino_tpu.ops import window as jw
from trino_tpu_torch import types as PT
from trino_tpu_torch.ops import grouped_topn as ptopn
from trino_tpu_torch.ops import sortkeys as psk
from trino_tpu_torch.ops import window as pw

torch.set_num_threads(2)

T1 = ("(values (1, 10), (1, 10), (1, 20), (2, 5), (2, 6), (2, 6), (2, 7)) "
      "as t (g, v)")
T2 = ("(values (1, 10), (1, 20), (1, 30), (1, 40), (2, 5), (2, 6), (2, 7)) "
      "as t (g, v)")
RANKING_SQL = (
    "select * from (select c_nationkey, c_name, c_acctbal, "
    "row_number() over (partition by c_nationkey "
    "order by c_acctbal desc, c_custkey) rn from customer) "
    "where rn <= 2 order by c_nationkey, rn")
#: (sql, rows in a total order)
SQL = [
    ("select n_name, row_number() over (partition by n_regionkey "
     "order by n_name) rn from nation where n_regionkey = 1 order by rn",
     True),
    (f"select g, v, rank() over (partition by g order by v) rk, "
     f"dense_rank() over (partition by g order by v) dr from {T1} "
     "order by g, v", True),
    (f"select g, v, sum(v) over (partition by g order by v) s from {T1} "
     "order by g, v", True),
    (f"select g, v, sum(v) over (partition by g order by v "
     f"rows unbounded preceding) s from {T1} order by g, v, s", True),
    ("select distinct n_regionkey, count(*) over (partition by n_regionkey)"
     " c from nation order by n_regionkey", True),
    ("select n_nationkey, lag(n_nationkey) over (order by n_nationkey) lg, "
     "lead(n_nationkey, 2) over (order by n_nationkey) ld from nation "
     "order by n_nationkey limit 4", True),
    ("select n_nationkey, first_value(n_name) over (partition by "
     "n_regionkey order by n_nationkey) fv, ntile(2) over (order by "
     "n_nationkey) nt from nation order by n_nationkey", True),
    ("select n_regionkey, count(*) c, sum(count(*)) over () total "
     "from nation group by n_regionkey order by n_regionkey", True),
    ("select n_regionkey, n_name from (select n_regionkey, n_name, "
     "row_number() over (partition by n_regionkey order by n_name) rn "
     "from nation) t where rn = 1 order by n_regionkey", True),
    (f"select g, v, last_value(v) over (partition by g order by v) lv "
     f"from {T2} order by g, v", True),
    (f"select g, v, last_value(v) over (partition by g order by v rows "
     f"between unbounded preceding and unbounded following) lv from {T2} "
     "order by g, v", True),
    (f"select g, v, nth_value(v, 2) over (partition by g order by v rows "
     f"between unbounded preceding and unbounded following) nv from {T2} "
     "order by g, v", True),
    (f"select g, v, nth_value(v, 3) over (partition by g order by v) nv "
     f"from {T2} order by g, v", True),
    (f"select g, v, sum(v) over (partition by g order by v rows between "
     f"1 preceding and 1 following) s, count(*) over (partition by g "
     f"order by v rows between 1 preceding and 1 following) c from {T2} "
     "order by g, v", True),
    (f"select g, v, min(v) over (partition by g order by v rows between "
     f"2 preceding and current row) mn, max(v) over (partition by g "
     f"order by v rows between current row and 2 following) mx from {T2} "
     "order by g, v", True),
    (f"select g, v, sum(v) over (partition by g order by v rows between "
     f"1 preceding and unbounded following) s from {T2} order by g, v",
     True),
    (f"select g, v, sum(v) over (partition by g order by v rows between "
     f"3 following and 4 following) s from {T2} order by g, v", True),
    # pooled partition keys and string min/max (value ranks)
    ("select c_mktsegment, c_custkey, min(c_name) over (partition by "
     "c_mktsegment), max(c_phone) over (partition by c_mktsegment order by "
     "c_custkey rows between 2 preceding and current row), "
     "lag(c_name) over (partition by c_mktsegment order by c_custkey) "
     "from customer where c_custkey < 60 order by c_mktsegment, c_custkey",
     True),
    # decimal and double running averages, sums and counts
    ("select o_custkey, o_orderkey, avg(o_totalprice) over (partition by "
     "o_custkey order by o_orderkey), sum(o_totalprice * 0.5e0) over "
     "(partition by o_custkey order by o_orderkey rows between 1 preceding "
     "and 1 following), count(o_comment) over (partition by o_custkey) "
     "from orders where o_custkey < 40 order by o_custkey, o_orderkey",
     True),
    (WINDOW_AGGS_SQL, True),
    (GROUPED_TOPN_SQL, True),
    (RANKING_SQL, True),
    ("select * from (select l_linestatus, l_quantity, rank() over "
     "(partition by l_linestatus order by l_quantity) rk from lineitem) "
     "where rk <= 3", False),
    ("select * from (select o_orderstatus, o_orderkey, row_number() over "
     "(partition by o_orderstatus order by o_totalprice, o_orderkey) rn "
     "from orders) where rn < 4 order by o_orderstatus, rn", True),
]


@pytest.fixture(scope="module")
def runners():
    return _runners("micro", page_rows=2048)


@pytest.mark.parametrize("sql,ordered", SQL,
                         ids=[f"sql{i}" for i in range(len(SQL))])
def test_window_sql_equals_jax(runners, sql, ordered):
    jr, pr = runners
    want = jr.execute(sql).rows
    got = pr.execute(sql).rows
    assert want
    if not ordered:
        want, got = sorted(want, key=repr), sorted(got, key=repr)
    _same_rows(got, want)


@pytest.mark.parametrize("sql", [WINDOW_AGGS_SQL, GROUPED_TOPN_SQL])
def test_chip_window_queries_at_tiny_equal_jax(sql):
    jr, pr = _runners("tiny")
    _same_rows(pr.execute(sql).rows, jr.execute(sql).rows)


@pytest.mark.parametrize("schema", ["micro", "tiny"])
def test_chip_window_oracle_equals_engine(schema):
    """chip_smoke.py's numpy oracle (its check of the window queries at
    SF1 on the card) gives the engine's rows at small scale."""
    _, pr = _runners(schema)
    want = window_oracle(schema)
    for name, sql in (("window_aggs", WINDOW_AGGS_SQL),
                      ("grouped_topn", GROUPED_TOPN_SQL)):
        res = pr.execute(sql)
        assert [_unscaled(r, res.types) for r in res.rows] == [want[name]]


def test_ranking_query_plans_to_grouped_topn(runners):
    _, pr = runners
    plan = "\n".join(r[0] for r in pr.execute("explain " + RANKING_SQL).rows)
    assert "TopNRanking" in plan
    assert "- Window" not in plan
    res = pr.execute(RANKING_SQL)
    assert any(op["name"] == "GroupedTopNOperator"
               for op in res.stats["operators"])
    assert len(res.rows) == 50


def test_grouped_topn_flushes_mid_stream_equal_jax(monkeypatch):
    """A buffer over FLUSH_ROWS truncates to each group's top rows before
    the next page arrives; the rows stay the JAX engine's."""
    monkeypatch.setattr(ptopn.GroupedTopNOperator, "FLUSH_ROWS", 4096)
    jr, pr = _runners("tiny", page_rows=2048)
    _same_rows(pr.execute(RANKING_SQL).rows, jr.execute(RANKING_SQL).rows)


# ---------------------------------------------------------- lane for lane

CAP, N = 128, 113
BIG, INT, DBL, DAT = "bigint", "integer", "double", "date"
DEC = "decimal(12,2)"
COLS = [BIG, INT, BIG, DBL, DEC, DAT]   # g, o, x, d, m, dt


def _columns(seed):
    """Seeded lanes: partition key g (6 values and NULL), order key o
    (ties, NULLs), values x/d/m/dt with NULLs; d holds -0.0, +0.0 and a
    NaN; lanes N.. are padding."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, 6, CAP), rng.integers(0, 12, CAP).astype(np.int32),
            rng.integers(-1000, 1000, CAP),
            np.round(rng.normal(0, 100, CAP), 3),
            rng.integers(-10 ** 7, 10 ** 7, CAP),
            rng.integers(-5000, 20000, CAP).astype(np.int32)]
    cols[3][:4] = [-0.0, 0.0, np.nan, -0.0]
    nulls = [rng.random(CAP) < p for p in (0.08, 0.05, 0.15, 0.1, 0.1, 0.1)]
    return cols, nulls, np.arange(CAP) < N


def _jt(name):
    return JT.parse_type(name)


def _pt(name):
    return PT.parse_type(name)


def _operands(sk, tconv, cols, nulls, asarray):
    g, o, d = (asarray(cols[i]) for i in (0, 1, 3))
    gn, on, dn = (asarray(nulls[i]) for i in (0, 1, 3))
    part = sk.group_operands(g, gn, tconv(BIG))
    order = sk.sort_operands(o, on, tconv(INT), None, ascending=True,
                             nulls_last=True) \
        + sk.sort_operands(d, dn, tconv(DBL), None, ascending=False,
                           nulls_last=False)
    return part, order


FRAMES = [("partition", None, None), ("range", None, 0), ("rows", None, 0),
          ("rows", None, 2), ("rows", None, -1), ("rows", -2, 1),
          ("rows", -1, None), ("rows", 2, 3), ("rows", -3, -1)]


def _agg_calls(mod, tconv, frame):
    mode, fs, fe = frame
    calls = [("count_star", None)]
    for f in ("count", "sum", "avg", "min", "max"):
        for ch in (2, 3, 4):
            calls.append((f, ch))
    calls += [("min", 5), ("max", 5), ("max", 1)]
    out = []
    for f, ch in calls:
        at = tconv(COLS[ch]) if ch is not None else None
        out.append(mod.WindowCall(f, ch, at, mod.resolve_window_type(f, at),
                                  mode, 1, fs, fe))
    return out


def _value_calls(mod, tconv):
    out = []
    for f, off in (("row_number", 1), ("rank", 1), ("dense_rank", 1),
                   ("ntile", 3), ("ntile", 200)):
        out.append(mod.WindowCall(f, None, None, tconv(BIG), "partition",
                                  off, None, None))
    for f, ch, off in (("lag", 2, 1), ("lead", 3, 2), ("lag", 4, 3),
                       ("lead", 5, 40)):
        at = tconv(COLS[ch])
        out.append(mod.WindowCall(f, ch, at, at, "range", off, None, 0))
    for mode, fs, fe in (("range", None, 0), ("partition", None, None),
                         ("rows", -1, 1), ("rows", 2, 3)):
        for f, off in (("first_value", 1), ("last_value", 1),
                       ("nth_value", 2)):
            at = tconv(DBL)
            out.append(mod.WindowCall(f, 3, at, at, mode, off, fs, fe))
    return out


def _partition_scale(s_cols, s_nulls, s_valid, x, live):
    """Per lane: the largest |prefix sum| of ``x`` over its partition."""
    g, gn = s_cols[0], s_nulls[0]
    scale = np.zeros(len(x))
    start = 0
    for i in range(1, len(x) + 1):
        if i == len(x) or s_valid[i] != s_valid[start] \
                or gn[i] != gn[start] or (not gn[i] and g[i] != g[start]):
            seg = np.where(live[start:i], x[start:i], 0.0)
            scale[start:i] = np.nanmax(np.abs(np.cumsum(seg)), initial=0.0)
            start = i
    return scale


def _run_both(calls_of, seed):
    cols, nulls, valid = _columns(seed)
    jpart, jorder = _operands(jsk, _jt, cols, nulls, jnp.asarray)
    ppart, porder = _operands(psk, _pt, cols, nulls, torch.from_numpy)
    jcalls, pcalls = calls_of(jw, _jt), calls_of(pw, _pt)
    jout = jw._window_kernel(
        tuple(jpart), tuple(jorder), tuple(jnp.asarray(c) for c in cols),
        tuple(jnp.asarray(n) for n in nulls), jnp.asarray(valid),
        num_part_ops=len(jpart), num_order_ops=len(jorder),
        calls=tuple(jcalls))
    pout = pw._window_kernel(
        ppart, porder, [torch.from_numpy(c) for c in cols],
        [torch.from_numpy(n) for n in nulls], torch.from_numpy(valid),
        pcalls)
    return jout, pout, jcalls


def _assert_window_equal(jout, pout, jcalls):
    js_cols, js_nulls, js_valid, jw_cols, jw_nulls = \
        [[np.asarray(a) for a in x] if isinstance(x, (tuple, list))
         else np.asarray(x) for x in jout]
    ps_cols, ps_nulls, ps_valid, pw_cols, pw_nulls = \
        [[a.numpy() for a in x] if isinstance(x, list) else x.numpy()
         for x in pout]
    np.testing.assert_array_equal(ps_valid, js_valid)
    v = js_valid
    for jc, pc, jn, pn in zip(js_cols, ps_cols, js_nulls, ps_nulls):
        np.testing.assert_array_equal(pn[v], jn[v])
        np.testing.assert_array_equal(pc[v], jc[v])
    for call, jc, pc, jn, pn in zip(jcalls, jw_cols, pw_cols, jw_nulls,
                                    pw_nulls):
        what = repr(call)
        np.testing.assert_array_equal(pn[v], jn[v], err_msg=what)
        live = v & ~jn
        want = jc.astype(call.output_type.storage)[live]
        got = pc.astype(call.output_type.storage)[live]
        if call.function in ("sum", "avg") and call.arg_type == JT.DOUBLE:
            x = js_cols[call.arg_channel]
            xlive = js_valid & ~js_nulls[call.arg_channel]
            scale = _partition_scale(js_cols, js_nulls, js_valid, x,
                                     xlive)[live]
            nan = np.isnan(want)
            np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
            assert np.all(np.abs(got - want)[~nan]
                          <= 1e-12 * scale[~nan]), what
        else:
            np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("frame", FRAMES, ids=[str(f) for f in FRAMES])
def test_window_kernel_aggregates_equal_jax(frame):
    jout, pout, jcalls = _run_both(
        lambda mod, tconv: _agg_calls(mod, tconv, frame), seed=3)
    _assert_window_equal(jout, pout, jcalls)


@pytest.mark.parametrize("seed", [1, 2])
def test_window_kernel_ranking_and_values_equal_jax(seed):
    jout, pout, jcalls = _run_both(_value_calls, seed)
    _assert_window_equal(jout, pout, jcalls)


@pytest.mark.parametrize("ranking,max_rank", [("row_number", 2),
                                              ("row_number", 1),
                                              ("rank", 3), ("rank", 1)])
def test_topn_kernel_equals_jax(ranking, max_rank):
    cols, nulls, valid = _columns(7)
    if ranking == "row_number":
        # unique order within every partition: the JAX sort is unstable
        cols[1] = np.random.default_rng(8).permutation(CAP).astype(np.int32)
        nulls[1][:] = False
    jpart, jorder = _operands(jsk, _jt, cols, nulls, jnp.asarray)
    ppart, porder = _operands(psk, _pt, cols, nulls, torch.from_numpy)
    jorder, porder = jorder[:2], porder[:2]          # order by o only
    jc, jn, jkeep, jrk, jcount = jtopn._topn_kernel(
        tuple(jpart), tuple(jorder), tuple(jnp.asarray(c) for c in cols),
        tuple(jnp.asarray(n) for n in nulls), jnp.asarray(valid),
        n_part=len(jpart), n_order=len(jorder), ranking=ranking,
        max_rank=max_rank, ncols=len(cols))
    pc, pn, pkeep, prk, pcount = ptopn._topn_kernel(
        ppart, porder, [torch.from_numpy(c) for c in cols],
        [torch.from_numpy(n) for n in nulls], torch.from_numpy(valid),
        ranking, max_rank)
    k = int(jcount)
    assert pcount == k > 0
    np.testing.assert_array_equal(pkeep.numpy(), np.asarray(jkeep))
    got = np.stack([a.numpy()[:k].astype(np.float64)
                    for a in pc + pn + [prk]], axis=1)
    want = np.stack([np.asarray(b)[:k].astype(np.float64)
                     for b in list(jc) + list(jn) + [jrk]], axis=1)
    if ranking == "rank":
        # the survivors are the same; the unstable sort may order ties
        # within a rank differently, so compare them as sorted rows
        got, want = (x[np.lexsort(x.T[::-1])] for x in (got, want))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["int64", "float64", "int32"])
@pytest.mark.parametrize("op", ["add", "minimum", "maximum"])
def test_seg_scans_equal_jax(op, dtype):
    rng = np.random.default_rng(hash((op, dtype)) % 2 ** 32)
    n = 1000
    x = (rng.normal(0, 1e3, n) if dtype == "float64"
         else rng.integers(-10 ** 6, 10 ** 6, n)).astype(dtype)
    if dtype == "float64":
        x[:3] = [-0.0, 0.0, -0.0]
    reset = rng.random(n) < 0.05
    reset[0] = True
    jop, pop = getattr(jnp, op), getattr(torch, op)
    for jfn, pfn in ((jw._seg_scan, pw._seg_scan),
                     (jw._suffix_seg_scan, pw._suffix_seg_scan)):
        want = np.asarray(jfn(jop, jnp.asarray(x), jnp.asarray(reset)))
        got = pfn(pop, torch.from_numpy(x), torch.from_numpy(reset)).numpy()
        if op == "add" and dtype == "float64":
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-12 * np.abs(x).sum())
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["minimum", "maximum"])
def test_range_query_equals_jax(op):
    rng = np.random.default_rng(17)
    n = 777
    x = rng.integers(-10 ** 9, 10 ** 9, n)
    lo = rng.integers(0, n, 4000)
    hi = np.minimum(lo + rng.integers(0, 300, 4000), n - 1)
    jop, pop = getattr(jnp, op), getattr(torch, op)
    want = np.asarray(jw._range_query(jw._sparse_table(jop, jnp.asarray(x)),
                                      jop, jnp.asarray(lo), jnp.asarray(hi)))
    got = pw._range_query(pw._sparse_table(pop, torch.from_numpy(x)), pop,
                          torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_array_equal(got.numpy(), want)
    # and against the definition
    fold = np.minimum if op == "minimum" else np.maximum
    np.testing.assert_array_equal(
        want, [fold.reduce(x[a:b + 1]) for a, b in zip(lo, hi)])
