"""The torch engine on a CUDA card: its kernels against their plain
versions, and q1 on the card against q1 on the CPU.

Every test here needs a card (a CUDA kernel has no CPU mode): each is
marked ``cuda`` and skips without one. The file imports neither jax nor
trino_tpu, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: ints and MIN/MAX exactly; a float SUM within SUM_RTOL of the
segment's sum of |x| from the exact sum (the float values are multiples
of 2^-10, so the plain version in float64 adds them exactly).
"""

import numpy as np
import pytest
import torch

from trino_tpu_torch import LocalQueryRunner
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.ops import kernels
from trino_tpu_torch.resources.tpch_queries import TPCH_QUERIES
from trino_tpu_torch.sql.analyzer import Session

pytestmark = pytest.mark.cuda

KINDS = ["sum", "min", "max"]
DTYPES = [torch.int32, torch.int64, torch.float32, torch.float64]
SUM_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(rng, n, groups, dtype, dev):
    """Sorted gids (``groups`` runs over the first 95% of rows, then the
    dump segment n) and values of ``dtype``."""
    live = max(1, n - n // 20) if n else 0
    b = np.zeros(n, dtype=np.int32)
    if groups > 1 and live > 1:
        b[np.sort(rng.choice(np.arange(1, live), min(groups, live) - 1,
                             replace=False))] = 1
    gid = np.cumsum(b).astype(np.int32)
    gid[live:] = n
    if dtype.is_floating_point:
        col = np.floor(rng.uniform(0, 1000, n) * 1024) / 1024
    elif dtype == torch.int32:
        col = rng.integers(-2 ** 30, 2 ** 30, n)
    else:
        col = rng.integers(-2 ** 62, 2 ** 62, n, dtype=np.int64)
    return (torch.from_numpy(col).to(dtype).to(dev),
            torch.from_numpy(gid).to(dev))


def _assert_matches(got, col, gid, ns, kind):
    if kind != "sum" or not col.dtype.is_floating_point:
        assert torch.equal(
            got, kernels.segment_reduce_reference(col, gid, ns, kind))
        return
    want = kernels.segment_reduce_reference(col.double(), gid, ns, "sum")
    mag = kernels.segment_reduce_reference(col.abs().double(), gid, ns,
                                           "sum")
    limit = SUM_RTOL[col.dtype] * mag
    assert bool(((got.double() - want).abs() <= limit).all())


# q1's aggregation page (262,144) and its final merge of 24 page partials
# (8,388,608: several carry tiles), each at 4 groups and at ~n/7
@pytest.mark.parametrize("n,groups", [(262_144, 4), (262_144, 37_449),
                                      (8_388_608, 4), (8_388_608, 1_198_372),
                                      (1000, 140), (7, 3), (2048, 1)])
def test_kernel_matches_plain_version(dev, n, groups):
    rng = np.random.default_rng(n + groups)
    for dtype in DTYPES:
        col, gid = _inputs(rng, n, groups, dtype, dev)
        for kind in KINDS:
            before = kernels.segment_reduce.launches
            got = kernels.segment_reduce(col, gid, n + 1, kind)
            assert kernels.segment_reduce.launches == before + 1
            _assert_matches(got, col, gid, n + 1, kind)


def test_empty_input_is_all_identity(dev):
    col = torch.empty(0, dtype=torch.int64, device=dev)
    gid = torch.empty(0, dtype=torch.int32, device=dev)
    got = kernels.segment_reduce(col, gid, 5, "min")
    assert got.tolist() == [torch.iinfo(torch.int64).max] * 5


def test_repeated_float_sums_are_bit_identical(dev):
    rng = np.random.default_rng(1)
    col, gid = _inputs(rng, 262_144, 4, torch.float32, dev)
    first = kernels.segment_reduce(col, gid, 262_145, "sum")
    for _ in range(3):
        assert torch.equal(kernels.segment_reduce(col, gid, 262_145, "sum"),
                           first)


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    col = torch.ones(16, dtype=torch.int64, device=dev)
    gid = torch.zeros(16, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        kernels.segment_reduce(col, gid.to(torch.int64), 1, "sum")
    with pytest.raises(TypeError):
        kernels.segment_reduce(col.to(torch.int16), gid, 1, "sum")
    with pytest.raises(ValueError):
        kernels.segment_reduce(col[::2], gid[::2].clone(), 1, "sum")
    with pytest.raises(ValueError):
        kernels.segment_reduce(col, gid.cpu(), 1, "sum")


#: (dtype, kind) of each column of the mixed table: more than 32 int64 SUM
#: columns (the kernel launches 32 columns of one dtype and kind at a
#: time) and two of each other pair
MIXED = ([(torch.int64, "sum")] * 34 + [(torch.int32, "min"),
                                        (torch.float32, "max"),
                                        (torch.float64, "sum")] * 2)


def _table(rng, n, groups, with_order, dev):
    """(cols, gid, order) of a mixed table: with ``order``, the gids are
    the hash path's (unsorted, ``groups`` groups interleaved, 5% of rows in
    the dump segment n) sorted, and ``order`` the stable sort's permutation;
    without, sorted gids as ``_inputs`` makes them."""
    if with_order:
        raw = rng.integers(0, groups, n).astype(np.int32)
        raw[rng.random(n) < 0.05] = n
        order = torch.sort(torch.from_numpy(raw).to(dev), stable=True).indices
        gid = torch.from_numpy(raw).to(dev)[order]
    else:
        order = None
        gid = _inputs(rng, n, groups, torch.int32, dev)[1]
    base = {dt: _inputs(rng, n, 1, dt, dev)[0]
            for dt in dict.fromkeys(dt for dt, _ in MIXED)}
    cols = [base[dt].roll(7919 * i + 1) for i, (dt, _) in enumerate(MIXED)]
    return cols, gid, order


@pytest.mark.parametrize("with_order", [False, True])
@pytest.mark.parametrize("n,groups", [(262_144, 4), (8_388_608, 4),
                                      (1000, 140)])
def test_columns_match_plain_version(dev, n, groups, with_order):
    rng = np.random.default_rng(n + groups + with_order)
    cols, gid, order = _table(rng, n, groups, with_order, dev)
    kinds = [kind for _, kind in MIXED]
    before = kernels.segment_reduce.launches
    got = kernels.segment_reduce_columns(cols, gid, n + 1, kinds, order)
    assert kernels.segment_reduce.launches == before + 1
    for (dtype, kind), col, out in zip(MIXED, cols, got):
        assert out.dtype == dtype and out.shape == (n + 1,)
        _assert_matches(out, col if order is None else col[order], gid,
                        n + 1, kind)


def test_repeated_column_float_sums_are_bit_identical(dev):
    rng = np.random.default_rng(2)
    cols, gid, order = _table(rng, 262_144, 4, True, dev)
    floats = [c for c in cols if c.dtype.is_floating_point]
    kinds = ["sum"] * len(floats)
    first = kernels.segment_reduce_columns(floats, gid, 262_145, kinds, order)
    for _ in range(3):
        again = kernels.segment_reduce_columns(floats, gid, 262_145, kinds,
                                               order)
        assert all(torch.equal(a, b) for a, b in zip(again, first))


def test_wrapper_rejects_a_bad_order(dev):
    cols = [torch.ones(16, dtype=torch.int64, device=dev)]
    gid = torch.zeros(16, dtype=torch.int32, device=dev)
    order = torch.arange(16, device=dev)
    with pytest.raises(TypeError):
        kernels.segment_reduce_columns(cols, gid, 1, ["sum"],
                                       order.to(torch.int32))
    with pytest.raises(ValueError):
        kernels.segment_reduce_columns(cols, gid, 1, ["sum"], order[:15])
    with pytest.raises(ValueError):
        kernels.segment_reduce_columns(cols, gid, 1, ["sum"], order.cpu())


def test_q1_on_the_card_equals_the_cpu_path(dev):
    def run(device):
        runner = LocalQueryRunner({"tpch": TpchConnector(page_rows=4096)},
                                  Session(catalog="tpch", schema="tiny"),
                                  device=device)
        return runner.execute(TPCH_QUERIES[1])

    before = kernels.segment_reduce.launches
    on_card = run(dev)
    launched = kernels.segment_reduce.launches - before
    # one kernel call per aggregated page, every state column in it
    pages = sum(sum(op.get("grouping_paths", {}).values())
                for op in on_card.stats["operators"]
                if op["name"] == "HashAggregationOperator")
    assert pages > 0 and launched == pages
    assert on_card.rows == run("cpu").rows


@pytest.mark.parametrize("strategy", ["AUTOMATIC", "MATMUL"])
@pytest.mark.parametrize("schema", ["micro", "tiny"])
def test_q3_on_the_card_equals_the_cpu_path(dev, schema, strategy):
    """q3's joins, dynamic filters, aggregation and TopN on the card give
    the CPU path's rows, in order, and the same pruned-row counts."""
    def run(device):
        runner = LocalQueryRunner(
            {"tpch": TpchConnector(page_rows=4096)},
            Session(catalog="tpch", schema=schema,
                    properties={"join_strategy": strategy}),
            device=device)
        return runner.execute(TPCH_QUERIES[3])

    before = kernels.segment_reduce.launches
    on_card = run(dev)
    launched = kernels.segment_reduce.launches - before
    pages = sum(sum(op.get("grouping_paths", {}).values())
                for op in on_card.stats["operators"]
                if op["name"] == "HashAggregationOperator")
    assert pages > 0 and launched == pages
    on_cpu = run("cpu")
    assert len(on_card.rows) == 10
    assert on_card.rows == on_cpu.rows
    assert on_card.stats["dynamic_filters"] == on_cpu.stats["dynamic_filters"]


def test_matmul_probe_on_the_card_equals_the_sorted_index(dev):
    """The one-hot product's (lo, count) on the card equals the two
    binary searches' for every usable probe row, at a build of 2^20 rows
    (positions far above TF32's 11 exact bits) — also with TF32 allowed
    for float32 products, which the float64 product does not use."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.ops import join, matmul_join

    rng = np.random.default_rng(7)
    n_build, k_range = 1 << 20, 1000
    bkey = torch.from_numpy(rng.integers(0, k_range, n_build)).to(dev)
    bnull = torch.from_numpy(rng.random(n_build) < 0.05).to(dev)
    bvalid = torch.from_numpy(rng.random(n_build) < 0.95).to(dev)
    b = join._assemble_build_side([T.BIGINT], [0], [bkey], [bnull], bvalid,
                                  [None])
    bridge = join.JoinBridge()
    bridge.set_build(b)
    op = matmul_join.MatmulJoinOperator([T.BIGINT], [0], bridge)
    pkey_raw = torch.from_numpy(rng.integers(-3, k_range + 3, 1 << 16)).to(dev)
    pnull = torch.from_numpy(rng.random(1 << 16) < 0.05).to(dev)
    pkey, anynull = join._key_u64([pkey_raw], [pnull], [T.BIGINT], "single")
    usable = ~anynull & (pkey_raw != -1)   # -1 has the sentinel's bits
    slo, scount = join._probe_counts(b.key_sorted, b.usable_sorted, pkey,
                                     usable)
    allow = torch.backends.cuda.matmul.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            op._mm = None
            assert op._ensure_table(b), op._fallback_reason
            lo, count = op._probe_lo_count(b, pkey, usable)
            assert torch.equal(count, scount)
            live = scount > 0
            assert torch.equal(lo[live], slo[live])
            assert int(slo[live].max()) > 1 << 19
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def _on_card_and_cpu(dev, sql, schema):
    def run(device):
        runner = LocalQueryRunner({"tpch": TpchConnector(page_rows=4096)},
                                  Session(catalog="tpch", schema=schema),
                                  device=device)
        return runner.execute(sql)

    return run(dev), run("cpu")


@pytest.mark.parametrize("schema", ["micro", "tiny"])
@pytest.mark.parametrize("qid", [7, 11, 18])
def test_tpch_on_the_card_equals_the_cpu_path(dev, qid, schema):
    """q7 (extract year), q11 (a scalar subquery in HAVING) and q18 with
    HAVING lowered to 150 (rows at micro: the semijoin and the
    large-group aggregation) give the CPU path's rows, in order."""
    sql = TPCH_QUERIES[qid]
    if qid == 18:
        sql = sql.replace("> 300", "> 150")
    on_card, on_cpu = _on_card_and_cpu(dev, sql, schema)
    assert on_card.rows and on_card.rows == on_cpu.rows


@pytest.mark.parametrize("query", ["window_aggs", "grouped_topn"])
def test_window_queries_on_the_card_equal_the_cpu_path(dev, query):
    from chip_smoke import GROUPED_TOPN_SQL, WINDOW_AGGS_SQL

    sql = {"window_aggs": WINDOW_AGGS_SQL,
           "grouped_topn": GROUPED_TOPN_SQL}[query]
    on_card, on_cpu = _on_card_and_cpu(dev, sql, "tiny")
    assert on_card.rows == on_cpu.rows
    name = {"window_aggs": "WindowOperator",
            "grouped_topn": "GroupedTopNOperator"}[query]
    assert name in [op["name"] for op in on_card.stats["operators"]]


def test_integer_divide_and_mod_by_zero_on_dead_lanes(dev):
    """Integer divide and mod run on every lane, dead and NULL lanes
    holding a 0 divisor included, without a device-side error; the live
    lanes equal the CPU path's."""
    from trino_tpu_torch import interop
    from trino_tpu_torch import types as T
    from trino_tpu_torch.expr import compiler, functions, ir

    cap, n = 4096, 3000
    rng = np.random.default_rng(5)
    a = rng.integers(-10 ** 6, 10 ** 6, cap)
    b = rng.integers(-9, 9, cap)
    b[n:] = 0
    nulls = [rng.random(cap) < 0.1, rng.random(cap) < 0.1]
    valid = np.arange(cap) < n
    x, y = ir.InputRef(T.BIGINT, 0), ir.InputRef(T.BIGINT, 1)
    d32 = ir.Call(T.INTEGER, "$cast", (x,))
    exprs = [ir.Call(T.BIGINT, f, (x, y)) for f in ("divide", "mod")] + [
        ir.Call(functions.get_function(f).resolve([T.INTEGER, T.BIGINT]),
                f, (d32, ir.Literal(T.BIGINT, 0)))
        for f in ("divide", "mod")]
    proc = compiler.PageProcessor([T.BIGINT, T.BIGINT], exprs)
    outs = {}
    for device in (dev, "cpu"):
        page = interop.device_page_from_numpy(
            [T.BIGINT, T.BIGINT], [a, b], nulls, valid, [None, None], device)
        out = proc.process(page)
        torch.cuda.synchronize()
        outs[str(device)] = [(c.cpu().numpy(), nl.cpu().numpy())
                             for c, nl in zip(out.cols, out.nulls)]
    for (gc, gn), (wc, wn) in zip(outs[str(dev)], outs["cpu"]):
        live = valid & ~wn
        np.testing.assert_array_equal(gn[valid], wn[valid])
        np.testing.assert_array_equal(gc[live], wc[live])
