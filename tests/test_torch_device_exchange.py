"""The device exchange of the torch engine against the JAX engine's.

Partition and sub-bucket ids (``parallel/exchange.py``) must be bit-equal
to the JAX functions' for every key type: the hash is uint64 arithmetic
that the port runs on int64 lanes, and a wrong (signed) remainder still
returns right rows when both sides of a join use it — only a comparison
of the ids catches it. Keys are made from numpy seeds: BIGINT with
negative and bit-63 values, INTEGER, DATE, BOOLEAN, DECIMAL, DOUBLE with
NaN, +-0.0, infinities and out-of-range values, VARCHAR from two pools
holding the same strings under other codes, NULLs in every column, and
1 to 8 key columns.

The exchange itself runs here on one device (the d > 1 cases are in
``test_torch_mesh_exchange.py``, apart from the two-device cases that
replaced this file's refusal checks); the JAX engine's is given one
device (``jax.devices()[:1]``, or ``jax.devices`` monkeypatched
for a runner, as tests/test_device_exchange.py does), and the two must
record equal ``stats`` (per-partition counts, skew, ``per_dest``,
retries, collectives, bytes) and deliver equal rows per partition, in
the ``exact``, ``history`` and ``legacy`` sizing modes of
tests/test_exchange_sizing.py. On one receiver no partition splits; the
salted sizing bound that a split would use is compared directly. The
scaled-writer rebalancer cases run under a fixed seed against the JAX
engine's assignment trail. Both engines' sizing histories are reset
around every case.
"""

import numpy as np
import pytest
import torch

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from trino_tpu import jit_stats as jjit
from trino_tpu import types as JT
from trino_tpu.block import DevicePage as JDevicePage
from trino_tpu.block import Dictionary as JDictionary
from trino_tpu.block import Page as JPage
from trino_tpu.connectors.memory import MemoryConnector as JMemory
from trino_tpu.connectors.tpch import TpchConnector as JTpch
from trino_tpu.parallel import device_exchange as jde
from trino_tpu.parallel import exchange as jex
from trino_tpu.parallel import rebalancer as jreb
from trino_tpu.parallel.distributed import DistributedQueryRunner as JDist
from trino_tpu.parallel.exchange import shard_map
from trino_tpu.sql.analyzer import Session as JSession
from trino_tpu.sql.parser import parse_statement as j_parse
from trino_tpu.telemetry import stats_store as jss
from trino_tpu_torch import jit_stats as pjit
from trino_tpu_torch import types as PT
from trino_tpu_torch.block import DevicePage as PDevicePage
from trino_tpu_torch.block import Dictionary as PDictionary
from trino_tpu_torch.block import Page as PPage
from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.parallel import DistributedQueryRunner
from trino_tpu_torch.parallel import device_exchange as pde
from trino_tpu_torch.parallel import exchange as pex
from trino_tpu_torch.parallel import rebalancer as preb
from trino_tpu_torch.sql.analyzer import Session
from trino_tpu_torch.sql.parser import parse_statement
from trino_tpu_torch.telemetry import stats_store as pss

SIZING_KERNELS = ("device_exchange_program", "device_exchange_count")


@pytest.fixture(autouse=True)
def _fresh_history():
    for h in (jde.SIZING_HISTORY, pde.SIZING_HISTORY):
        h.reset()
    for s in (jss.store(), pss.store()):
        s.clear()
    yield
    for h in (jde.SIZING_HISTORY, pde.SIZING_HISTORY):
        h.reset()
    for s in (jss.store(), pss.store()):
        s.clear()


# -- partition ids, bit for bit ---------------------------------------------

STRINGS = ["", "a", "AIR", "MAIL", "REG AIR", "TRUCK", "x" * 40, "ünï"]


def _key_column(rng, kind, n):
    """(jax type, torch type, raw numpy column, nulls) of one key."""
    nulls = rng.random(n) < 0.15
    if kind == "bigint":
        col = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64)
        col[:8] = [-1, -2 ** 63, 2 ** 63 - 1, 0, 1, -7, 2 ** 62, 12]
        return JT.BIGINT, PT.BIGINT, col, nulls
    if kind == "integer":
        col = rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)
        return JT.INTEGER, PT.INTEGER, col, nulls
    if kind == "date":
        col = rng.integers(8000, 11000, n).astype(np.int32)
        return JT.DATE, PT.DATE, col, nulls
    if kind == "boolean":
        return JT.BOOLEAN, PT.BOOLEAN, rng.random(n) < 0.5, nulls
    if kind == "decimal":
        col = rng.integers(-10 ** 12, 10 ** 12, n).astype(np.int64)
        return (JT.decimal_type(12, 2), PT.decimal_type(12, 2), col,
                nulls)
    pool = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1e300, -1e300,
                     2.0 ** 47, -2.0 ** 47 - 0.5, 1.25, -3e-300, 7.0])
    col = np.where(rng.random(n) < 0.5, pool[rng.integers(0, len(pool), n)],
                   rng.normal(size=n) * 1e6)
    return JT.DOUBLE, PT.DOUBLE, col, nulls


def _ids(keys_j, keys_p, parts):
    """(jax ids, torch ids) of both hashes for one partition count."""
    return ((np.asarray(jex.hash_partition_ids(keys_j, parts)),
             pex.hash_partition_ids(keys_p, parts).numpy()),
            (np.asarray(jex.subbucket_ids(keys_j, parts)),
             pex.subbucket_ids(keys_p, parts).numpy()))


KEY_SETS = [["bigint"], ["integer"], ["date"], ["boolean"], ["decimal"],
            ["double"], ["bigint", "double"], ["date", "boolean", "integer"],
            ["bigint", "integer", "date", "boolean", "decimal", "double",
             "bigint", "double"]]


@pytest.mark.parametrize("kinds", KEY_SETS,
                         ids=["-".join(k) for k in KEY_SETS])
def test_partition_ids_bit_for_bit(kinds):
    rng = np.random.default_rng(sum(map(len, kinds)) * 7 + len(kinds))
    n = 4096
    cols = [_key_column(rng, k, n) for k in kinds]
    keys_j = [jex.key_to_u64(jnp.asarray(c), jnp.asarray(m), jt)
              for jt, _, c, m in cols]
    keys_p = [pex.key_to_u64(torch.from_numpy(c), torch.from_numpy(m), pt)
              for _, pt, c, m in cols]
    for kj, kp in zip(keys_j, keys_p):
        np.testing.assert_array_equal(kp.numpy(),
                                      np.asarray(kj).view(np.int64))
    for parts in (1, 2, 3, 4, 5, 7, 8, 16, 1000, 65_537):
        for got_j, got_p in _ids(keys_j, keys_p, parts):
            np.testing.assert_array_equal(got_p, got_j)
            assert got_p.dtype == np.int32


def test_string_keys_route_by_value_across_pools():
    """Two pools holding the same strings under other codes: each
    pool's ids equal the JAX engine's, and a value routes alike from
    either pool (the crc LUT hashes the string, not the code)."""
    rng = np.random.default_rng(5)
    n = 2048
    values = [STRINGS[i] for i in rng.integers(0, len(STRINGS), n)]
    nulls = rng.random(n) < 0.1
    other = list(reversed(STRINGS))
    ids = []
    for order in (STRINGS, other):
        jd, pd = JDictionary(order), PDictionary(order)
        codes = np.asarray([order.index(v) for v in values], np.int32)
        kj = [jex.key_to_u64(jnp.asarray(codes), jnp.asarray(nulls),
                             JT.VARCHAR,
                             jnp.asarray(jex.string_hash_lut(jd)))]
        kp = [pex.key_to_u64(torch.from_numpy(codes),
                             torch.from_numpy(nulls), PT.VARCHAR,
                             pex.lut_tensor(pex.string_hash_lut(pd),
                                            "cpu"))]
        for parts in (3, 4, 8):
            for got_j, got_p in _ids(kj, kp, parts):
                np.testing.assert_array_equal(got_p, got_j)
        ids.append(pex.hash_partition_ids(kp, 4).numpy())
    np.testing.assert_array_equal(ids[0], ids[1])


def test_partition_histogram_and_send_grid():
    """The count-first histogram equals the JAX engine's; the send grid
    holds every live row of each destination once, in its lane block,
    and counts the rows past ``per_dest`` as overflow."""
    rng = np.random.default_rng(9)
    n, parts = 1024, 4
    part = rng.integers(0, parts, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    got = pex.partition_histogram(torch.from_numpy(part),
                                  torch.from_numpy(valid), parts).numpy()
    want = np.asarray(jex.partition_histogram(jnp.asarray(part),
                                              jnp.asarray(valid), parts))
    np.testing.assert_array_equal(got, want)
    vals = np.arange(n, dtype=np.int64)
    for per_dest in (int(want.max()), 64):
        (cols,), (nl,), gv, over = pex.send_grid(
            (torch.from_numpy(vals),), (torch.zeros(n, dtype=torch.bool),),
            torch.from_numpy(valid), torch.from_numpy(part), parts,
            per_dest)
        gv = gv.numpy().reshape(parts, per_dest)
        cols = cols.numpy().reshape(parts, per_dest)
        for p in range(parts):
            rows = sorted(cols[p][gv[p]].tolist())
            live = sorted(vals[valid & (part == p)].tolist())
            # a stable sort keeps each destination's first rows
            assert rows == live[:per_dest]
        assert int(over) == int(np.maximum(want - per_dest, 0).sum())
    # two senders over two devices (refused until the mesh slice): the
    # all-to-all gives receiver j lane block j of both grids, the rows
    # of the JAX engine's collective over two devices as multisets
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("x",))
    halves = [slice(0, n // 2), slice(n // 2, n)]
    dest = (part % 2).astype(np.int32)
    per_dest = n // 2

    @partial(shard_map, mesh=mesh, in_specs=(P("x"),) * 3,
             out_specs=(P("x"),) * 3, check_vma=False)
    def jprog(v, va, p):
        rc, _rn, rv, over = jex.repartition_a2a(
            (v[0],), (jnp.zeros_like(va[0]),), va[0], p[0],
            num_partitions=2, per_dest=per_dest, axis_name="x")
        return rc[0][None], rv[None], over[None]

    jc, jv, jo = (np.asarray(a) for a in jprog(
        jnp.asarray(vals.reshape(2, -1)), jnp.asarray(valid.reshape(2, -1)),
        jnp.asarray(dest.reshape(2, -1))))
    rc, _rn, rv, over = pex.repartition_a2a(
        [(torch.from_numpy(vals[h]),) for h in halves],
        [(torch.zeros(n // 2, dtype=torch.bool),) for _ in halves],
        [torch.from_numpy(valid[h]) for h in halves],
        [torch.from_numpy(dest[h]) for h in halves], 2, per_dest,
        devices=["cpu", "cpu"])
    assert [int(o) for o in over] == jo.tolist() == [0, 0]
    for j in range(2):
        got = rc[j][0].numpy()[rv[j].numpy()]
        assert sorted(got.tolist()) == sorted(jc[j][jv[j]].tolist())
        assert sorted(got.tolist()) == \
            sorted(vals[valid & (dest == j)].tolist())


def test_salted_need_bound_equals_jax():
    rng = np.random.default_rng(3)
    for n, d in ((4, 2), (4, 4), (8, 3), (3, 1)):
        pair = rng.integers(0, 500, (n, d))
        for hot in (set(), {0}, {1, n - 1}):
            assert pde._salted_need_bound(pair, hot, n, d) == \
                jde._salted_need_bound(pair, hot, n, d)


# -- the exchange, stats equal to the JAX engine's ---------------------------


def _feed(ex, engine, n, rows_per_task, hot_frac, seed):
    """Skewed BIGINT (key, value) pages, ~hot_frac of them on key 7,
    one page per producer task; the same pages for either engine."""
    rng = np.random.default_rng(seed)
    for t in range(n):
        keys = np.where(rng.random(rows_per_task) < hot_frac, 7,
                        rng.integers(0, 10_000, rows_per_task))
        vals = rng.integers(0, 100, rows_per_task)
        if engine == "jax":
            p = JPage.from_pylists([JT.BIGINT, JT.BIGINT],
                                   [keys.tolist(), vals.tolist()])
            ex.add_page(t, JDevicePage.from_page(p))
        else:
            p = PPage.from_pylists([PT.BIGINT, PT.BIGINT],
                                   [keys.tolist(), vals.tolist()])
            ex.add_page(t, PDevicePage.from_page(p, "cpu"))


def _exchange_pair(sizing, n=4, rows_per_task=1000, hot_frac=0.9,
                   seed=0, threshold=0.5):
    """The same exchange through both engines, the JAX one on one
    device; returns (jax exchange, torch exchange), each drained."""
    out = []
    for engine in ("jax", "torch"):
        if engine == "jax":
            ex = jde.DeviceExchange(n, jax.devices()[:1], sizing=sizing,
                                    hot_split_threshold=threshold)
            ex.configure([JT.BIGINT, JT.BIGINT], [0])
        else:
            ex = pde.DeviceExchange(n, [torch.device("cpu")],
                                    sizing=sizing,
                                    hot_split_threshold=threshold)
            ex.configure([PT.BIGINT, PT.BIGINT], [0])
        _feed(ex, engine, n, rows_per_task, hot_frac, seed)
        ex.set_no_more_pages()
        total = sum(pg.count() for part in range(n) for pg in ex.pages(part))
        assert total == n * rows_per_task
        out.append(ex)
    return out


def _partition_rows(ex, n):
    out = []
    for part in range(n):
        rows = []
        for pg in ex.pages(part):
            v = np.asarray(pg.valid)
            rows.extend(zip(np.asarray(pg.cols[0])[v].tolist(),
                            np.asarray(pg.cols[1])[v].tolist()))
        out.append(sorted(rows))
    return out


def _same_exchange(jx, px, n=4):
    assert px.stats == jx.stats
    assert _partition_rows(px, n) == _partition_rows(jx, n)
    for attr in ("a2a_retries", "count_collectives", "data_collectives",
                 "collective_ran", "d", "n"):
        assert getattr(px, attr) == getattr(jx, attr), attr


@pytest.mark.parametrize("sizing", ["exact", "history", "legacy"])
@pytest.mark.parametrize("hot_frac", [0.0, 0.9])
def test_exchange_stats_equal_jax(sizing, hot_frac):
    jx, px = _exchange_pair(sizing, hot_frac=hot_frac, seed=1)
    _same_exchange(jx, px)
    assert px.stats["kind"] == "device" and px.d == 1
    assert px.stats["splits"] == 0  # one receiver: nothing to spread
    if hot_frac:
        assert px.stats["skew_ratio"] > 2.5


def test_exact_sizing_zero_retries_single_data_collective():
    before = pde.DeviceExchange.total_collectives
    jx, px = _exchange_pair("exact")
    _same_exchange(jx, px)
    assert px.a2a_retries == 0 and px.data_collectives == 1
    assert px.count_collectives == 1
    assert pde.DeviceExchange.total_collectives - before == 1
    s = px.stats
    assert s["sizing_used"] == "exact"
    assert max(s["partition_rows"]) > 0.85 * s["rows"]
    assert s["per_dest"] >= s["observed_max_pair_rows"]


def test_history_presizes_repeat_without_count_or_first_call():
    jx1, px1 = _exchange_pair("history", seed=1)
    _same_exchange(jx1, px1)
    assert px1.count_collectives == 1  # unconfident: counted
    before = pjit.total_for(*SIZING_KERNELS)
    jbefore = jjit.total_for(*SIZING_KERNELS)
    jx2, px2 = _exchange_pair("history", seed=1)
    _same_exchange(jx2, px2)
    # presized from history: no count pass, no doubling, and the data
    # program ran at a signature it had seen (no new first call), as the
    # JAX engine's hit its compiled cache (no new trace)
    assert px2.count_collectives == 0 and px2.a2a_retries == 0
    assert px2.stats["sizing_used"] == "history"
    assert px2.stats["per_dest"] == px1.stats["per_dest"]
    assert pjit.total_for(*SIZING_KERNELS) == before
    assert jjit.total_for(*SIZING_KERNELS) == jbefore


def test_stale_history_recovers_via_backstop_and_relearns():
    """An undersized history presize must not wedge the exchange: the
    doubling backstop completes it and re-teaches the history."""
    small = _exchange_pair("history", rows_per_task=40, hot_frac=0.0,
                           seed=2)
    _same_exchange(*small)
    big = _exchange_pair("history", rows_per_task=4000, seed=3)
    _same_exchange(*big)
    assert big[1].count_collectives == 0  # presized (stale)
    assert big[1].a2a_retries >= 1        # backstop fired
    nxt = _exchange_pair("history", rows_per_task=4000, seed=3)
    _same_exchange(*nxt)
    assert nxt[1].a2a_retries == 0        # history re-learned


def test_legacy_sizing_and_routing():
    """Legacy sizing on one receiver: lanes the size of the slab, so no
    retry; every row lands in the partition its key hashes to."""
    jx, px = _exchange_pair("legacy", rows_per_task=500, hot_frac=0.95,
                            seed=13)
    _same_exchange(jx, px)
    assert px.count_collectives == 0 and px.a2a_retries == 0
    for part in range(4):
        for pg in px.pages(part):
            keys = pg.cols[0][pg.valid]
            if len(keys):
                got = pex.hash_partition_ids(
                    [pex.key_to_u64(keys, torch.zeros_like(keys,
                                                           dtype=torch.bool),
                                    PT.BIGINT)], 4)
                assert bool((got == part).all())


def test_string_pools_unify_before_the_exchange():
    """Producers coding one string column against different pools: the
    exchange remaps every code into the first pool and routes by value,
    so each partition's strings equal the JAX engine's."""
    n = 3
    out = {}
    for engine in ("jax", "torch"):
        D, P_, T_ = ((JDictionary, JPage, JT) if engine == "jax"
                     else (PDictionary, PPage, PT))
        ex = (jde.DeviceExchange(n, jax.devices()[:1], sizing="exact")
              if engine == "jax" else
              pde.DeviceExchange(n, [torch.device("cpu")], sizing="exact"))
        ex.configure([T_.VARCHAR, T_.BIGINT], [0])
        r = np.random.default_rng(17)
        for t in range(n):
            order = STRINGS if t % 2 == 0 else list(reversed(STRINGS))
            vals = [STRINGS[i] for i in r.integers(0, len(STRINGS), 300)]
            page = P_.from_pylists([T_.VARCHAR, T_.BIGINT],
                                   [vals, list(range(300))],
                                   dictionaries=[D(order), None])
            ex.add_page(t, JDevicePage.from_page(page) if engine == "jax"
                        else PDevicePage.from_page(page, "cpu"))
        ex.set_no_more_pages()
        parts = []
        for p in range(n):
            rows = []
            for pg in ex.pages(p):
                host = pg.to_page()
                rows.extend(host.to_rows())
            parts.append(sorted(rows))
        out[engine] = (parts, ex.stats)
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][1] == out["jax"][1]


def test_more_than_one_device_is_refused():
    """More than one device was refused until the mesh slice; now an
    exchange over two CPU slabs equals the JAX engine's over two
    devices: rows per partition, stats (the hot partition split over
    both receivers) and collectives."""
    out = []
    for engine in ("jax", "torch"):
        if engine == "jax":
            ex = jde.DeviceExchange(4, jax.devices()[:2], sizing="exact")
            ex.configure([JT.BIGINT, JT.BIGINT], [0])
        else:
            ex = pde.DeviceExchange(4, ["cpu", "cpu"], sizing="exact")
            ex.configure([PT.BIGINT, PT.BIGINT], [0])
        _feed(ex, engine, 4, 500, 0.9, 23)
        ex.set_no_more_pages()
        out.append(ex)
    jx, px = out
    assert px.d == 2
    _same_exchange(jx, px)
    assert px.stats["splits"] == 1 and px.stats["split_ways"] == 2


def test_host_buffer_stats_parity():
    """The host path exposes the same stats surface the device path
    records, and equals the JAX engine's host buffer."""
    from trino_tpu.ops.output import OutputBuffer as JBuffer
    from trino_tpu_torch.ops.output import OutputBuffer

    got = []
    for Buf, P_, T_ in ((JBuffer, JPage, JT), (OutputBuffer, PPage, PT)):
        buf = Buf(4)
        for p, rows in ((0, 90), (1, 5), (2, 5)):
            buf.enqueue(p, P_.from_pylists([T_.BIGINT],
                                           [list(range(rows))]))
        got.append(buf.stats)
    assert got[1] == got[0]
    assert got[1]["partition_rows"] == [90, 5, 5, 0]
    _, px = _exchange_pair("exact", seed=4)
    assert set(got[1]) <= set(px.stats) | {"source_fragment"}


# -- the scaled-writer rebalancer ---------------------------------------------


def _trail(reb, hist, times):
    trail = []
    for _ in range(times):
        reb.observe(hist)
        trail.append(reb.assignment())
    return trail


HOT = [9000, 50, 40, 60, 30, 45, 55, 35]
COOL = [50, 50, 40, 60, 30, 45, 55, 35]


@pytest.mark.parametrize("case", ["seeded", "scale", "unscale",
                                  "hysteresis", "calm"])
def test_rebalancer_equals_jax(case):
    """Every assignment of the torch engine's rebalancer equals the JAX
    engine's under the same seed and history, and the properties of
    tests/test_exchange_sizing.py hold."""
    trails = []
    for mod in (jreb, preb):
        if case == "seeded":
            reb = mod.UniformPartitionRebalancer(8, 4, seed=42)
            trail = _trail(reb, HOT, 6)
        elif case == "scale":
            reb = mod.UniformPartitionRebalancer(8, 4, min_collectives=2)
            trail = [reb.assignment()] + _trail(reb, HOT, 10)
            assert len(trail[-1][0]) >= 2
            assert trail[-1] == trail[-2] == trail[-3]
            assert reb.stats()["scaled_partitions"] >= 1
        elif case == "unscale":
            reb = mod.UniformPartitionRebalancer(8, 4, min_collectives=2)
            trail = _trail(reb, HOT, 16) + _trail(reb, COOL, 24)
            assert len(reb.lanes_for(0)) == 1
            assert trail[-1] == trail[-2] == trail[-3]
        elif case == "hysteresis":
            reb = mod.UniformPartitionRebalancer(8, 4, min_collectives=4)
            trail = _trail(reb, HOT, 12)
            changes = [i for i, (a, b) in enumerate(zip(trail, trail[1:]))
                       if a != b]
            assert all(b - a >= 4 for a, b in zip(changes, changes[1:]))
        else:
            reb = mod.UniformPartitionRebalancer(8, 4, min_collectives=2)
            trail = _trail(reb, [100] * 8, 6)
            assert reb.rebalances == 0
        trails.append((trail, reb.stats()))
    assert trails[1] == trails[0]


def test_writer_rebalancer_is_shared_per_shape():
    a = preb.writer_rebalancer(["bigint"], 4, 2)
    b = preb.writer_rebalancer(["bigint"], 4, 2)
    c = preb.writer_rebalancer(["bigint"], 4, 3)
    assert a is b and a is not c
    assert a.n == 4 * preb.LOGICAL_PER_WRITER == \
        jreb.writer_rebalancer(["bigint"], 4, 2).n


# -- through the runner --------------------------------------------------------

QUERIES = [
    # group-by: partial agg -> hash exchange -> final agg
    "select l_returnflag, l_linestatus, count(*), sum(l_quantity) "
    "from lineitem group by l_returnflag, l_linestatus",
    # string group keys: pool unification + value-stable routing
    "select l_shipmode, count(*) from lineitem group by l_shipmode",
    # partitioned join: both sides hash-exchange on orderkey
    "select o_orderpriority, count(*) from orders, lineitem "
    "where o_orderkey = l_orderkey and l_quantity < 10 "
    "group by o_orderpriority",
]


@pytest.fixture(scope="module")
def one_device():
    real = jax.devices()
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "devices", lambda *a, **k: real[:1])
    yield
    mp.undo()


def _runners(device_exchange, sizing="history", n_workers=3):
    out = []
    for S, C, R, kw in ((JSession, JTpch, JDist, {}),
                        (Session, TpchConnector, DistributedQueryRunner,
                         {"device": "cpu"})):
        s = S(catalog="tpch", schema="micro")
        s.properties["device_exchange"] = device_exchange
        s.properties["device_exchange_sizing"] = sizing
        out.append(R({"tpch": C(page_rows=2048)}, s, n_workers=n_workers,
                     desired_splits=8, broadcast_threshold=300.0, **kw))
    return out


def _key(row):
    return tuple(("\0" if v is None else str(v)) for v in row)


def _stage_exchanges(res):
    return [s.exchange for s in sorted(res.stats["query_stats"].stages,
                                       key=lambda s: s.stage_id)]


@pytest.mark.parametrize("sql", QUERIES)
def test_device_vs_host_exchange_equal_jax(one_device, sql):
    """Device exchange on and off give the same rows, equal to the JAX
    engine's; with it on the exchange runs (no silent host fallback)
    and every stage boundary records the JAX engine's stats."""
    jd, pd = _runners(True, sizing="exact")
    before = pde.DeviceExchange.total_collectives
    jres = jd._execute_query(j_parse(sql), collect_stats=True)
    pres = pd._execute_query(parse_statement(sql), collect_stats=True)
    assert pde.DeviceExchange.total_collectives > before
    assert sorted(pres.rows, key=_key) == sorted(jres.rows, key=_key)
    assert _stage_exchanges(pres) == _stage_exchanges(jres)
    _, host = _runners(False)
    assert sorted(host.execute(sql).rows, key=_key) == \
        sorted(pres.rows, key=_key)


def test_device_exchange_chosen_for_hash_only():
    _, on = _runners(True)
    _, off = _runners(False)
    sql = ("select l_returnflag, count(*) from lineitem "
           "group by l_returnflag")
    frag = [f for f in on.create_fragments(sql) if f.output_kind == "hash"]
    assert frag
    ex = on._device_exchange_for(frag[0], on.n_workers)
    assert isinstance(ex, pde.DeviceExchange) and ex.d == 1
    # task-count mismatch -> host path; device exchange off -> host path
    assert on._device_exchange_for(frag[0], on.n_workers + 1) is None
    assert off._device_exchange_for(frag[0], off.n_workers) is None


def test_explain_analyze_shows_exchange_skew_lines():
    _, pd = _runners(True, sizing="exact")
    res = pd.execute(
        "EXPLAIN ANALYZE SELECT l_returnflag, count(*), sum(l_quantity) "
        "FROM lineitem GROUP BY l_returnflag")
    text = "\n".join(row[0] for row in res.rows)
    device_lines = [ln for ln in text.splitlines()
                    if "exchange [device]" in ln]
    assert device_lines, text
    for ln in device_lines:
        assert "skew" in ln and "per_dest=" in ln and "retries=" in ln
        assert "sizing=exact" in ln
    assert any("exchange [host]" in ln for ln in text.splitlines())


def _memory_runner(engine, conn, **props):
    S, R, kw = ((JSession, JDist, {}) if engine == "jax" else
                (Session, DistributedQueryRunner, {"device": "cpu"}))
    s = S(catalog="mem", schema="default")
    s.properties.update(props)
    return R({"mem": conn}, s, n_workers=4, desired_splits=4, **kw)


def _load(engine, conn, r, name, cols):
    P_, T_ = (JPage, JT) if engine == "jax" else (PPage, PT)
    r.execute(f"create table {name} (k bigint, v bigint)")
    h = conn.metadata().get_table_handle("default", name)
    sink = conn.page_sink(h, conn.metadata().get_columns(h))
    sink.append_page(P_.from_pylists([T_.BIGINT, T_.BIGINT],
                                     [c.tolist() for c in cols]))
    sink.finish()


def test_partitioned_join_over_a_hot_key_equals_broadcast(one_device):
    """A PARTITIONED join whose probe side is 90% one key ships raw rows
    through the device exchange with zero retries and returns the
    broadcast plan's rows — and the JAX engine's on one device."""
    rng = np.random.default_rng(31)
    keys = np.where(rng.random(6000) < 0.9, 7, rng.integers(0, 300, 6000))
    sql = "select count(*) from z, dim where z.k = dim.k"
    got = {}
    for engine, Conn in (("jax", JMemory), ("torch", MemoryConnector)):
        conn = Conn()
        r = _memory_runner(engine, conn,
                           join_distribution_type="PARTITIONED",
                           device_exchange_sizing="exact")
        _load(engine, conn, r, "z", [keys, keys])
        _load(engine, conn, r, "dim", [np.append(np.arange(300), 7),
                                       np.arange(301)])
        text = "\n".join(row[0] for row in
                         r.execute("EXPLAIN ANALYZE " + sql).rows)
        device_lines = [ln for ln in text.splitlines()
                        if "exchange [device]" in ln]
        assert device_lines and all("retries=0" in ln
                                    for ln in device_lines)
        rows = r.execute(sql).rows
        b = _memory_runner(engine, conn, join_distribution_type="BROADCAST")
        assert rows == b.execute(sql).rows
        got[engine] = rows
    assert got["torch"] == got["jax"]


def test_scaled_writer_ctas_correct_and_rebalances():
    """CTAS over a 90%-hot key with scale_writers_enabled routes rows
    through the rebalancing hash boundary: written rows equal the
    unscaled plan's and the JAX engine's, the rebalancer engages and
    the metric family counts it."""
    rng = np.random.default_rng(21)
    keys = np.where(rng.random(8000) < 0.9, 7, rng.integers(0, 500, 8000))
    vals = rng.integers(0, 100, 8000)

    def run(engine, scale):
        (jde if engine == "jax" else pde).SIZING_HISTORY.reset()
        Conn = JMemory if engine == "jax" else MemoryConnector
        conn = Conn()
        r = _memory_runner(engine, conn, scale_writers_enabled=scale)
        _load(engine, conn, r, "z", [keys, vals])
        written = r.execute("create table out as select k, v from z")
        return written.rows, sorted(r.execute("select k, v from out").rows)

    before = preb.UniformPartitionRebalancer.total_rebalances
    off = run("torch", False)
    on = run("torch", True)
    assert on == off and on[0] == [(8000,)]
    assert preb.UniformPartitionRebalancer.total_rebalances > before
    assert run("jax", True) == on
    _, pd = _runners(True)
    fams = {f["name"]: f for f in pd.metrics_families()}
    jd, _ = _runners(True)
    jfams = {f["name"]: f for f in jd.metrics_families()}
    for name in ("trino_exchange_splits_total",
                 "trino_writer_rebalances_total"):
        assert fams[name]["type"] == jfams[name]["type"] == "counter"
    assert fams["trino_writer_rebalances_total"]["samples"][0][1] == \
        preb.UniformPartitionRebalancer.total_rebalances


# -- the host buffer's hot lanes (tests/test_batched_execution.py) ------------


def _buf_page(v, rows=1):
    return PPage.from_pylists([PT.BIGINT], [[v] * rows])


class TestOutputBufferHotLanes:
    def test_split_scales_capacity_and_full_needs_all_lanes(self):
        from trino_tpu_torch.ops.output import OutputBuffer

        buf = OutputBuffer(4, max_pending_pages=2)
        buf.enqueue(1, _buf_page(1))
        buf.enqueue(1, _buf_page(2))
        assert buf.full([1])
        assert buf.split_partition(1, 4)
        assert not buf.full([1]), "extra lanes must add slack"
        for i in range(3, 11):
            buf.enqueue(1, _buf_page(i))
        assert buf.full([1]), "full only when EVERY lane is at bound"

    def test_drain_preserves_rows_across_lanes(self):
        from trino_tpu_torch.ops.output import OutputBuffer

        buf = OutputBuffer(2, max_pending_pages=4)
        buf.split_partition(0, 3)
        vals = list(range(10))
        for v in vals:
            buf.enqueue(0, _buf_page(v))
        buf.set_no_more_pages()
        got = []
        while buf.has_page(0):
            got.append(int(buf.poll(0).block(0).numpy().data[0]))
        assert buf.at_end(0)
        assert sorted(got) == vals
        assert buf.poll(0) is None

    def test_barrier_pages_snapshot_sees_all_lanes(self):
        from trino_tpu_torch.ops.output import OutputBuffer

        buf = OutputBuffer(2)
        buf.split_partition(1, 2)
        for v in range(5):
            buf.enqueue(1, _buf_page(v))
        assert len(buf.pages(1)) == 5
        assert buf.pages(0) == []

    def test_stats_parity_with_device_exchange(self):
        from trino_tpu_torch.ops.output import OutputBuffer

        buf = OutputBuffer(4, max_pending_pages=2)
        buf.split_partition(2, 4)
        buf.enqueue(2, _buf_page(7, rows=3))
        s = buf.stats
        assert s["hot_partitions"] == [2]
        assert s["splits"] == 1 and s["split_ways"] == 4
        assert s["hot_spread"] == {2: 4}
        assert s["partition_rows"][2] == 3

    def test_broadcast_and_merge_never_split(self):
        from trino_tpu_torch.ops.output import (OutputBuffer,
                                                PartitionedOutputOperator)

        assert not OutputBuffer(2, broadcast=True).split_partition(0, 4)
        buf = OutputBuffer(2, max_pending_pages=2)
        PartitionedOutputOperator([PT.BIGINT], [0], buf, kind="merge",
                                  hot_split_threshold=0.1)
        assert buf._hot_lanes == {}

    def test_hash_producer_splits_hot_partition(self):
        """One dominant key drives >threshold of rows -> its partition
        grows lanes, the same partition as in the JAX engine."""
        from trino_tpu.ops.output import OutputBuffer as JBuffer
        from trino_tpu.ops.output import PartitionedOutputOperator as JOut
        from trino_tpu_torch.ops.output import (OutputBuffer,
                                                PartitionedOutputOperator)

        keys, vals = [5] * 64, list(range(64))
        hot = []
        for Buf, Out, P_, T_, D in (
                (JBuffer, JOut, JPage, JT, JDevicePage.from_page),
                (OutputBuffer, PartitionedOutputOperator, PPage, PT,
                 lambda p: PDevicePage.from_page(p, "cpu"))):
            buf = Buf(4, max_pending_pages=8)
            op = Out([T_.BIGINT, T_.BIGINT], [0], buf, kind="hash",
                     hot_split_threshold=0.5)
            op.add_input(D(P_.from_pylists([T_.BIGINT, T_.BIGINT],
                                           [keys, vals])))
            assert len(buf._hot_lanes) == 1
            (hot_p, ways), = buf._hot_lanes.items()
            assert ways == 4 and buf.stats["hot_partitions"] == [hot_p]
            assert sum(p.num_rows for p in buf.pages(hot_p)) == 64
            hot.append(hot_p)
        assert hot[1] == hot[0]

    def test_unbounded_buffer_never_splits(self):
        from trino_tpu_torch.ops.output import (OutputBuffer,
                                                PartitionedOutputOperator)

        buf = OutputBuffer(4)    # barrier mode: no pending bound
        op = PartitionedOutputOperator([PT.BIGINT], [0], buf, kind="hash",
                                       hot_split_threshold=0.5)
        op.add_input(PDevicePage.from_page(
            PPage.from_pylists([PT.BIGINT], [[0] * 16]), "cpu"))
        assert buf._hot_lanes == {}
