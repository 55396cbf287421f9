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

# the kernel design's edge cases (imports neither jax nor trino_tpu)
from test_torch_segment_reduce_plan import EDGE_CASES, edge_gids
# the hash kernel's inputs: chip_smoke.py's hash_kernel phase, which
# imports nothing at module level beyond the standard library
from chip_smoke import HASH_CASES, _hash_inputs, hash_barriers

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
#: columns (past 32 columns the kernel's descriptor table goes to the
#: device) and two of each other pair
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


def _edge_case(case):
    """(sorted int32 gids, num_segments) of an edge case: those of
    ``EDGE_CASES``, one segment over all 8,388,608 rows (4,096 tiles: the
    carries' long run), and negative gids (dropped) before the groups."""
    if case == "segment_over_all_rows":
        return np.zeros(8_388_608, dtype=np.int32), 2
    if case == "negative_gids":
        gid = np.concatenate([np.full(3000, -7), np.full(1500, -1),
                              np.arange(4000) // 3]).astype(np.int32)
        return gid, int(gid[-1]) + 1
    return edge_gids(case)


@pytest.mark.parametrize("with_order", [False, True])
@pytest.mark.parametrize("case", sorted(EDGE_CASES) + [
    "segment_over_all_rows", "negative_gids"])
def test_edge_cases_match_plain_version(dev, case, with_order):
    """What the two-launch design could get wrong: gaps longer than a fill
    chunk (in the middle, at the tail, across tile edges), a segment over
    several tiles and over all 8,388,608 rows, one row, a tile and a row,
    gids past num_segments and below 0; each with the mixed table's 40
    columns of four (dtype, kind) pairs in one call, against the plain
    version."""
    gid, ns = _edge_case(case)
    n = len(gid)
    rng = np.random.default_rng(len(case) + with_order)
    base = {dt: _inputs(rng, n, 1, dt, dev)[0]
            for dt in dict.fromkeys(dt for dt, _ in MIXED)}
    cols = [base[dt].roll(7919 * i + 1) for i, (dt, _) in enumerate(MIXED)]
    order = torch.from_numpy(rng.permutation(n)).to(dev) if with_order \
        else None
    gid = torch.from_numpy(gid).to(dev)
    kinds = [kind for _, kind in MIXED]
    before = kernels.segment_reduce.launches
    got = kernels.segment_reduce_columns(cols, gid, ns, kinds, order)
    assert kernels.segment_reduce.launches == before + 1
    for (dtype, kind), col, out in zip(MIXED, cols, got):
        assert out.dtype == dtype and out.shape == (ns,)
        _assert_matches(out, col if order is None else col[order], gid, ns,
                        kind)


@pytest.mark.parametrize("n,ns", [(262_144, 262_145), (8_388_608, 8_388_609),
                                  (7, 8), (0, 100)])
@pytest.mark.parametrize("table", ["one", "q1", "mixed"])
def test_at_most_two_kernels_per_call(dev, table, n, ns):
    """Whatever the columns' dtypes and kinds, one call launches at most
    two CUDA kernels (the tile pass and the carries; the tile pass alone
    when the rows fit one tile), counted by torch.profiler; past 32
    columns the descriptor table's one host-to-device copy is no
    kernel."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    table = {"one": [(torch.float64, "sum")],
             "q1": [(torch.int64, "sum")] * 15, "mixed": MIXED}[table]
    rng = np.random.default_rng(n)
    gid = _inputs(rng, n, 4, torch.int32, dev)[1]
    cols = [_inputs(rng, n, 1, dt, dev)[0] for dt, _ in table]
    kinds = [kind for _, kind in table]
    order = torch.arange(n, device=dev) if len(table) > 1 else None
    kernels.segment_reduce_columns(cols, gid, ns, kinds, order)
    torch.cuda.synchronize()
    # over 20 calls, so that a kernel record the profiler drops now and
    # then cannot hide a third kernel (nor make two read as one)
    calls = 20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            kernels.segment_reduce_columns(cols, gid, ns, kinds, order)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    launched = round(sum(e.count for e in device
                         if re.search(r"\b(tile|carry)_kernel\b", e.key))
                     / calls)
    # nothing else runs on the card but the table's copy
    assert all(re.search(r"\b(tile|carry)_kernel\b", e.key)
               or e.key.startswith("Memcpy HtoD") for e in device)
    assert launched == (2 if n > kernels.TILE_ROWS else 1)


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


def _memory_runner(device, **props):
    """A runner over memory tables filled by CTAS from tpch tiny."""
    from trino_tpu_torch.connectors.memory import MemoryConnector

    runner = LocalQueryRunner(
        {"memory": MemoryConnector(),
         "tpch": TpchConnector(page_rows=4096)},
        Session(catalog="memory", schema="default", properties=props),
        device=device)
    for t in ("lineitem", "orders"):
        runner.execute(f"create table {t} as select * from tpch.tiny.{t}")
    return runner


def test_memory_table_q1_on_the_card_equals_the_cpu_path(dev):
    """CTAS moves tiny lineitem through the card into a memory table; q1
    over it on the card gives the CPU path's rows, one kernel call per
    aggregated page."""
    on_cpu = _memory_runner("cpu").execute(TPCH_QUERIES[1])
    runner = _memory_runner(dev)
    before = kernels.segment_reduce.launches
    on_card = runner.execute(TPCH_QUERIES[1])
    launched = kernels.segment_reduce.launches - before
    pages = sum(sum(op.get("grouping_paths", {}).values())
                for op in on_card.stats["operators"]
                if op["name"] == "HashAggregationOperator")
    assert pages > 0 and launched == pages
    assert on_card.rows == on_cpu.rows


@pytest.mark.parametrize("to_disk", [False, True])
def test_spilled_aggregation_on_the_card_equals_unspilled(dev, to_disk):
    """The large-group aggregation and a join under a cap far below their
    state, on the card: the partials and build partitions go to the host
    (and to disk), come back onto the runner's device and give the
    unspilled run's rows."""
    sql = ("select l_orderkey, sum(l_quantity) qty, count(*) c from "
           "lineitem group by l_orderkey order by qty desc, l_orderkey "
           "limit 20")
    join = ("select o_orderpriority, count(*), sum(l_quantity) from orders "
            "o join lineitem l on o.o_orderkey = l.l_orderkey group by "
            "o_orderpriority order by o_orderpriority")
    free = _memory_runner(dev)
    props = {"spill_enabled": True, "spill_to_disk_enabled": to_disk,
             "spill_host_memory_bytes": 0 if to_disk else 1 << 30,
             "query_max_memory_bytes": 4_000_000}
    capped = _memory_runner(dev, **props)
    for q in (sql, join):
        want = free.execute(q)
        got = capped.execute(q)
        mem = got.stats["memory"]
        assert got.rows == want.rows
        assert mem["spill_events"] > 0 and mem["peak_bytes"] <= 4_000_000
        assert (mem.get("disk_spill_events", 0) > 0) == to_disk


def _folded_inputs(rng, depth, cap, dtype, dev, dead=()):
    """A burst's folded call: ``depth`` lanes of ``cap`` rows, each with
    its own sorted dense gids (a few groups, then the dump segment
    ``cap``), laid end to end at the kernel's lane stride, each lane's
    rows read through its own permutation; the lanes in ``dead`` hold
    only dump rows (an all-masked lane). Returns (col, gid', order,
    segments, stride)."""
    from trino_tpu_torch.exec.batched import _lane_stride

    stride = _lane_stride(cap, dev)
    seg = cap + 1
    gids, cols, orders = [], [], []
    for d in range(depth):
        g = np.full(stride, cap, dtype=np.int64)
        if d not in dead:
            live = int(rng.integers(1, cap + 1))
            raw = np.sort(rng.integers(0, max(1, live // 3), live))
            g[:live] = np.unique(raw, return_inverse=True)[1]
        gids.append(d * seg + g)
        orders.append(d * stride + rng.permutation(stride))
        if dtype.is_floating_point:
            cols.append(np.floor(rng.uniform(-1000, 1000, stride) * 1024)
                        / 1024)
        else:
            cols.append(rng.integers(-2 ** 62, 2 ** 62, stride,
                                     dtype=np.int64))
    return (torch.from_numpy(np.concatenate(cols)).to(dtype).to(dev),
            torch.from_numpy(np.concatenate(gids)).to(torch.int32).to(dev),
            torch.from_numpy(np.concatenate(orders)).to(dev),
            depth * seg, stride)


@pytest.mark.parametrize("depth", [1, 3, 8, 16])
def test_folded_lanes_match_plain_version(dev, depth):
    """One folded ``segment_reduce_columns`` call over a burst's lanes —
    gid' = lane * (cap + 1) + gid, read through each lane's order —
    against the plain version, for SUM/MIN/MAX over int64 and float64,
    with all-masked lanes (identity in every segment); and each lane's
    result, float sums included, bit-identical to the same lane reduced
    alone (every lane starts on a tile edge)."""
    rng = np.random.default_rng(depth)
    cap = 4096
    seg = cap + 1
    dead = {0, depth - 1} if depth > 2 else set()
    for dtype in (torch.int64, torch.float64):
        col, gid, order, ns, stride = _folded_inputs(rng, depth, cap, dtype,
                                                     dev, dead)
        before = kernels.segment_reduce.launches
        got = kernels.segment_reduce_columns([col] * 3, gid, ns, KINDS,
                                             order=order)
        assert kernels.segment_reduce.launches == before + 1
        for out, kind in zip(got, KINDS):
            _assert_matches(out, col[order], gid, ns, kind)
        for d in range(depth):
            rows = slice(d * stride, (d + 1) * stride)
            alone = kernels.segment_reduce_columns(
                [col[rows]] * 3, (gid[rows] - d * seg).contiguous(), seg,
                KINDS, order=(order[rows] - d * stride).contiguous())
            for a, g, kind in zip(alone, got, KINDS):
                lane = g[d * seg:(d + 1) * seg]
                assert torch.equal(a, lane)
                if d in dead:   # every segment but the dump's
                    assert bool((lane[:cap] == kernels.segment_identity(
                        kind, dtype)).all())


def test_burst_on_the_card_equals_its_serial_runs(dev):
    """Eight same-shape aggregations over a memory table of several pages
    on the card as one burst: every member equals its serial run on the
    card exactly (DOUBLE sums and averages too: each lane starts on a
    kernel tile edge, so its float sums associate as in its serial run),
    and the burst makes the serial run's kernel calls, not eight times as
    many."""
    from trino_tpu_torch.connectors.memory import MemoryConnector

    runner = LocalQueryRunner(
        {"tpch": TpchConnector(page_rows=4096), "memory": MemoryConnector()},
        Session(catalog="memory", schema="default"), device=dev)
    runner.execute("create table lineitem as select l_returnflag, "
                   "l_linestatus, l_quantity, l_extendedprice, l_discount "
                   "from tpch.tiny.lineitem")
    burst = ["select l_returnflag, l_linestatus, sum(l_quantity), "
             "avg(l_extendedprice), min(l_discount), count(*), "
             "sum(l_extendedprice * 1.0e0), avg(l_discount * 1.0e0) "
             "from lineitem "
             "where l_quantity < %d group by l_returnflag, l_linestatus"
             % k for k in (51, 45, 40, 35, 30, 25, 20, 15)]
    before = kernels.segment_reduce.launches
    out = runner.execute_batch(burst)
    burst_calls = kernels.segment_reduce.launches - before
    assert runner.query_cache.batched_launches == 8
    runner.session.properties["batched_execution_enabled"] = False
    before = kernels.segment_reduce.launches
    serial = [runner.execute(s).rows for s in burst]
    serial_calls = (kernels.segment_reduce.launches - before) // 8
    assert [o.rows for o in out] == serial
    assert 0 < burst_calls <= serial_calls


def test_profiled_kernel_calls_equal_launches(dev):
    """Under EXPLAIN ANALYZE VERBOSE on the card the profiler's
    ``segment_reduce_pallas`` entries count exactly the kernel's launches
    of the run, their CUDA-event device time is positive and within the
    run's wall, and a repeat run adds no program."""
    import re

    from trino_tpu_torch.telemetry import profiler

    profiler.reset()
    try:
        runner = LocalQueryRunner({"tpch": TpchConnector(page_rows=4096)},
                                  Session(catalog="tpch", schema="tiny"),
                                  device=dev)
        sql = "explain analyze verbose " + TPCH_QUERIES[1]
        before = kernels.segment_reduce.launches
        text = "\n".join(r[0] for r in runner.execute(sql).rows)
        launched = kernels.segment_reduce.launches - before
        entries = [e for e in profiler.snapshot()
                   if e["name"] == "segment_reduce_pallas"]
        assert launched > 0
        assert sum(e["calls"] for e in entries) == launched
        device_ms = sum(e["execute_ms"] for e in entries)
        wall_ms = float(re.search(r"Query: ([0-9.]+)ms", text).group(1))
        assert 0 < device_ms <= wall_ms
        again = runner.execute(sql).rows[-1][0]
        assert "0 new, 0 compiles this run" in again, again
    finally:
        profiler.reset()


def test_profiling_off_makes_no_event(dev, monkeypatch):
    """With profiling off a query on the card creates no CUDA event."""
    made = []
    real = torch.cuda.Event

    def counted(*a, **k):
        made.append(1)
        return real(*a, **k)

    monkeypatch.setattr(torch.cuda, "Event", counted)
    runner = LocalQueryRunner({"tpch": TpchConnector(page_rows=4096)},
                              Session(catalog="tpch", schema="tiny"),
                              device=dev)
    runner.execute(TPCH_QUERIES[1])
    runner.execute("explain analyze " + TPCH_QUERIES[1])
    assert made == []


DISTRIBUTED_SQL = [
    TPCH_QUERIES[1],
    TPCH_QUERIES[3],
    "select l_shipmode, count(*), sum(l_quantity) from lineitem "
    "group by l_shipmode",
    "select o_orderpriority, count(*) from orders, lineitem "
    "where o_orderkey = l_orderkey and l_quantity < 10 "
    "group by o_orderpriority",
]


@pytest.mark.parametrize("sql", DISTRIBUTED_SQL)
def test_distributed_on_the_card_equals_the_cpu(dev, sql):
    """The one-card distributed runner (four workers, PARTITIONED joins,
    the device exchange) returns the CPU run's rows, as sorted lists;
    the exchange and the kernel both ran on the card."""
    from trino_tpu_torch.parallel import DistributedQueryRunner
    from trino_tpu_torch.parallel.device_exchange import DeviceExchange

    def run(device):
        s = Session(catalog="tpch", schema="tiny")
        s.properties["join_distribution_type"] = "PARTITIONED"
        r = DistributedQueryRunner({"tpch": TpchConnector(page_rows=4096)},
                                   s, n_workers=4, desired_splits=8,
                                   device=device)
        return sorted(r.execute(sql).rows, key=repr)

    want = run("cpu")
    before = (DeviceExchange.total_collectives, kernels.segment_reduce.launches)
    assert run(dev) == want
    assert DeviceExchange.total_collectives > before[0]
    assert kernels.segment_reduce.launches > before[1]


def test_process_cluster_on_the_card_equals_the_cpu(dev, tmp_path):
    """The multi-process cluster on the card: two worker processes, each
    with its own CUDA context and a quarter of the card for its node
    pool, return the CPU path's rows for q1 and q3 at tiny, each worker
    process launched the kernel for q1's aggregations, and every launch
    each process kept equals the plain version on its inputs."""
    from trino_tpu_torch.parallel import ProcessQueryRunner

    local = LocalQueryRunner({"tpch": TpchConnector(page_rows=4096)},
                             Session(catalog="tpch", schema="tiny"),
                             device="cpu")
    s = Session(catalog="tpch", schema="tiny")
    s.properties["node_max_memory_bytes"] = \
        torch.cuda.mem_get_info()[1] // 4
    with ProcessQueryRunner({"tpch": {"connector": "tpch",
                                      "page_rows": 4096}}, s,
                            n_workers=2, desired_splits=8,
                            device=dev) as cluster:
        for qid in (1, 3):
            cluster.kernel_launches(reset=True)
            cluster.record_kernel_calls()
            cluster.record_kernel_calls(kernel="hash_insert")
            got = cluster.execute(TPCH_QUERIES[qid]).rows
            launches = cluster.kernel_launches()
            kept = cluster.record_kernel_calls(str(tmp_path))
            hash_dir = tmp_path / "hash"
            hash_dir.mkdir(exist_ok=True)
            hash_kept = cluster.record_kernel_calls(str(hash_dir),
                                                    "hash_insert")
            assert got == local.execute(TPCH_QUERIES[qid]).rows, qid
            assert kept == {proc: n["segment_reduce"]
                            for proc, n in launches.items()}, (kept,
                                                              launches)
            assert hash_kept == {proc: n["hash_insert"]
                                 for proc, n in launches.items()}
            if qid == 1:
                assert all(launches[f"worker-{i}"]["segment_reduce"] > 0
                           and launches[f"worker-{i}"]["hash_insert"] > 0
                           for i in range(2)), launches
            for proc in hash_kept:
                for ops, valid, rounds in torch.load(
                        hash_dir / f"{proc}.pt", map_location=dev,
                        weights_only=True):
                    got = kernels.hash_insert(ops, valid, rounds)
                    want = kernels.hash_insert_reference(ops, valid, rounds)
                    for g, w in zip(got, want):
                        assert torch.equal(g, w), (proc, qid)
            # each worker's launches, replayed here against the plain
            # version on the inputs that worker gave the kernel
            for proc in kept:
                for cols, gid, ns, kinds, order in torch.load(
                        tmp_path / f"{proc}.pt", map_location=dev,
                        weights_only=True):
                    got = kernels.segment_reduce_columns(cols, gid, ns,
                                                         kinds, order)
                    want = kernels.segment_reduce_columns_reference(
                        cols, gid, ns, kinds, order)
                    for g, w in zip(got, want):
                        assert torch.equal(g, w), (proc, qid)


def test_mesh_q1_on_four_slabs_of_the_card(dev):
    """Mesh q1 at micro over four slabs of the one card, for the
    exchange and the global-hash strategies: the rows equal the same
    mesh over four CPU slabs, the kernel launched once per slab in the
    partial step (and once per slab in the exchange's merge-final), and
    every launch, kept, equals the plain version on its inputs."""
    from trino_tpu_torch.parallel.mesh_query import run_q1_mesh

    slabs = [f"{dev.type}:{dev.index or 0}"] * 4
    for strategy, merges in (("exchange", 4), ("global_hash", 0)):
        want, _r, _c, _p = run_q1_mesh(["cpu"] * 4, "micro",
                                       agg_strategy=strategy)
        kernels.segment_reduce.launches = 0
        kernels.record_calls(True)
        got, retries, _c, _p = run_q1_mesh(slabs, "micro",
                                           agg_strategy=strategy)
        calls = kernels.record_calls(False)
        assert sorted(got) == sorted(want) and len(got) == 4
        assert retries == 0
        assert kernels.segment_reduce.launches == len(calls) == 4 + merges
        for cols, gid, ns, kinds, order in calls:
            got_cols = kernels.segment_reduce_columns(cols, gid, ns, kinds,
                                                      order)
            want_cols = kernels.segment_reduce_columns_reference(
                cols, gid, ns, kinds, order)
            for g, w in zip(got_cols, want_cols):
                assert torch.equal(g, w)


def test_mesh_device_exchange_on_the_card_equals_the_cpu(dev):
    """``DeviceExchange(4, ["cuda:0"] * 4)`` over a skewed key column
    (a hot key) equals the same exchange over four CPU slabs: each
    partition's rows as sorted lists, and the stats exactly."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.block import DevicePage, Page
    from trino_tpu_torch.parallel import device_exchange as de

    rng = np.random.default_rng(41)
    pages = []
    for _ in range(4):
        keys = np.where(rng.random(5000) < 0.7, 7,
                        rng.integers(0, 100_000, 5000))
        pages.append(Page.from_pylists(
            [T.BIGINT, T.BIGINT],
            [keys.tolist(), rng.integers(0, 1000, 5000).tolist()]))
    slab = f"{dev.type}:{dev.index or 0}"
    out = {}
    for devices in (["cpu"] * 4, [slab] * 4):
        de.SIZING_HISTORY.reset()
        ex = de.DeviceExchange(4, devices, sizing="exact")
        ex.configure([T.BIGINT, T.BIGINT], [0])
        for t, p in enumerate(pages):
            ex.add_page(t, DevicePage.from_page(p, devices[t]))
        ex.set_no_more_pages()
        parts = []
        for part in range(4):
            rows = []
            for pg in ex.pages(part):
                assert pg.valid.device.type == torch.device(devices[0]).type
                rows.extend(pg.to_page().to_rows())
            parts.append(sorted(rows))
        out[devices[0]] = (parts, ex.stats)
    de.SIZING_HISTORY.reset()
    (cpu_parts, cpu_stats), (card_parts, card_stats) = out.values()
    assert card_parts == cpu_parts
    assert card_stats == cpu_stats
    assert card_stats["splits"] == 1 and card_stats["split_ways"] == 4


@pytest.mark.parametrize("case", sorted(HASH_CASES))
def test_hash_kernel_matches_plain_version(dev, case):
    """One launch per call, and rep, resolved and the rounds run equal to
    the plain version's exactly (near-full tables overflow their budget
    of one or two rounds)."""
    n, distinct, null_share, rounds = HASH_CASES[case]
    ops, valid = _hash_inputs(np.random.default_rng(n + len(distinct)), n,
                              distinct, null_share, dev)
    before = kernels.hash_insert.launches
    got = kernels.hash_insert(ops, valid, rounds)
    torch.cuda.synchronize()
    assert kernels.hash_insert.launches == before + 1
    want = kernels.hash_insert_reference(ops, valid, rounds)
    for g, w in zip(got, want):
        assert torch.equal(g, w), case
    if case.startswith("near_full"):
        assert not bool(got[1].all())


@pytest.mark.parametrize("case", sorted(HASH_CASES))
def test_hash_kernel_runs_the_designs_barriers(dev, case):
    """Every input gives the plain version's rep, resolved and rounds
    run exactly, under the plan ``hash_plan`` makes for this card, in the
    barriers the design runs (at most rounds + 1)."""
    n, distinct, null_share, rounds = HASH_CASES[case]
    ops, valid = _hash_inputs(np.random.default_rng(n + len(distinct)), n,
                              distinct, null_share, dev)
    run = kernels.hash_insert_run(ops, valid, rounds)
    want = kernels.hash_insert_reference(ops, valid, rounds)
    assert torch.equal(run.rep, want[0]) and torch.equal(run.resolved,
                                                         want[1])
    assert int(run.taken) == int(want[2])
    barriers = int(run.barriers)
    assert barriers == hash_barriers(int(run.taken), rounds)
    assert barriers <= rounds + 1
    width = kernels.hash_entry_width(n, rounds)
    assert run.plan == kernels.hash_plan(
        n, rounds, kernels.hash_resident_grid(valid.get_device(), width))


def test_hash_plan_the_library_refuses_raises(dev, monkeypatch):
    """A plan the C entry does not take (a buffer too small for the
    table, one without room for the worklists its grid spills, a 32-bit
    entry a tag overflows, more blocks than the card keeps resident)
    raises with the CUDA error and launches nothing: no plain version."""
    n = 4608
    ops, valid = _hash_inputs(np.random.default_rng(5), n, [600], 0.0, dev)
    kernels.hash_insert(ops, valid, 32)
    good = kernels.hash_plan(
        n, 32, kernels.hash_resident_grid(valid.get_device(), 32))
    resident = kernels.hash_resident_grid(valid.get_device(), 32)
    before = kernels.hash_insert.launches
    for bad, rounds in ((good._replace(nbytes=1024), 32),
                        (good._replace(blocks=1), 32),
                        (good, 1 << 30),
                        (good._replace(blocks=resident + 1), 32)):
        monkeypatch.setattr(kernels, "_card_plan", lambda *_: bad)
        with pytest.raises(RuntimeError, match="launch failed"):
            kernels.hash_insert(ops, valid, rounds)
    assert kernels.hash_insert.launches == before


def test_hash_group_ids_on_the_card_equals_the_cpu(dev):
    """``hash_group_ids`` over q1's grouping operands at micro: the card
    (one kernel launch) gives the CPU path's gids, group rows, group count
    and overflow flag, the two scalars as device tensors."""
    from trino_tpu_torch.benchmarks import scan_q1_pages
    from trino_tpu_torch.block import DevicePage, Page
    from trino_tpu_torch.ops.hashtable import hash_group_ids
    from trino_tpu_torch.ops.sortkeys import group_operands

    pages = scan_q1_pages(TpchConnector(page_rows=4096), "micro", 1)
    page = Page.concat(pages)
    out = {}
    for where in ("cpu", dev):
        dp = DevicePage.from_page(page, device=where)
        ops = []
        for c in (0, 1):
            ops += group_operands(dp.cols[c], dp.nulls[c], dp.types[c])
        before = kernels.hash_insert.launches
        out[str(where)] = hash_group_ids(ops, dp.valid)
        assert kernels.hash_insert.launches == before + (where != "cpu")
    (cg, crows, cn, cov), (gg, grows, gn, gov) = out.values()
    assert gn.is_cuda and gov.is_cuda and gn.shape == gov.shape == ()
    assert int(gn) == int(cn) == 4 and not bool(gov) and not bool(cov)
    assert torch.equal(gg.cpu(), cg) and torch.equal(grows.cpu(), crows)


def test_hash_library_call_refuses_a_cpu_tensor(dev):
    """A CPU operand beside a CUDA mask (or the reverse) raises before
    any launch; so does a float operand."""
    valid = torch.ones(16, dtype=torch.bool, device=dev)
    key = torch.arange(16, device=dev)
    before = kernels.hash_insert.launches
    with pytest.raises(ValueError, match="one CUDA device"):
        kernels.hash_insert([key.cpu()], valid, 32)
    with pytest.raises(ValueError, match="one CUDA device"):
        kernels.hash_insert([key], valid.cpu(), 32)
    with pytest.raises(TypeError):
        kernels.hash_insert([key.double()], valid, 32)
    assert kernels.hash_insert.launches == before


def test_hash_kernel_takes_its_most_operands_and_refuses_more(dev):
    """Every descriptor travels in the launch parameters: the most
    operands the kernel takes give the plain version's result; one more
    raises before any launch."""
    rng = np.random.default_rng(7)
    n = 4096
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    ops = [torch.from_numpy(rng.integers(0, 2, n)).to(dev)
           for _ in range(kernels.HASH_MAX_OPERANDS)]
    got = kernels.hash_insert(ops, valid, 32)
    want = kernels.hash_insert_reference(ops, valid, 32)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    before = kernels.hash_insert.launches
    with pytest.raises(ValueError, match="at most"):
        kernels.hash_insert(ops + ops[:1], valid, 32)
    assert kernels.hash_insert.launches == before


def test_a_device_read_shows_on_its_operator_span(dev):
    """A known copy of N bytes to the host inside an operator's call is
    one read of N bytes on that operator's span; while a CUDA-only
    torch.profiler session records, the span also carries the read's
    interval, inside the call's, and the trace holds the copy."""
    from torch.profiler import ProfilerActivity, profile

    from trino_tpu_torch.exec.driver import Driver
    from trino_tpu_torch.ops.operator import Operator
    from trino_tpu_torch.telemetry import device_reads
    from trino_tpu_torch.telemetry.tracing import Tracer, add_driver_spans

    n = 1 << 20
    t = torch.arange(n, dtype=torch.int32, device=dev)

    class Reader(Operator):
        done = False

        def get_output(self):
            if not self.done:
                host = device_reads.to_cpu(t * 2, "test.operator")
                assert host.device.type == "cpu" and int(host[3]) == 6
                self.done = True
            return None

        def is_finished(self):
            return self.done

    def span_of(driver):
        tracer = Tracer()
        with tracer.span("task") as task:
            add_driver_spans(tracer, driver, task)
        (span,) = [s for s in tracer.finished() if s["name"] == "Reader"]
        return span["attrs"]

    driver = Driver([Reader()], collect_stats=True)
    driver.run_to_completion()
    a = span_of(driver)
    assert (a["d2h_reads"], a["d2h_bytes"]) == (1, 4 * n)
    assert "reads" not in a and "calls" not in a
    torch.cuda.synchronize()
    driver = Driver([Reader()], collect_stats=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        driver.run_to_completion()
        torch.cuda.synchronize()
    a = span_of(driver)
    ((r0, r1, site, nbytes),) = a["reads"]
    assert (site, nbytes) == ("test.operator", 4 * n)
    assert any(c0 <= r0 <= r1 <= c1 for c0, c1 in a["calls"])
    copies = [e for e in prof.events()
              if "Memcpy DtoH" in e.name and e.device_type.name == "CUDA"]
    assert copies, [e.name for e in prof.events()][:20]
