"""The torch engine's device exchange over d > 1 device slabs against
the JAX engine's collective over ``jax.devices()[:d]``.

The JAX engine runs its mesh on the 8 virtual CPU devices of
tests/conftest.py; the port holds the same mesh as d slabs of the CPU
(``["cpu"] * d``). Inputs come from numpy seeds.

- ``repartition_a2a`` at d = 2, 4 and 8: each receiver's rows, and the
  rows of each (receiver, sender) lane block, equal the JAX
  ``all_to_all``'s as sorted multisets (the JAX bucket sort is unstable,
  so lane order within a block may differ); at overflow each block's
  live count and each sender's overflow count are equal.
- ``DeviceExchange`` at d = 2, 4 and 8, in the ``exact``, ``history``
  and ``legacy`` sizing modes, with and without a hot key: each
  partition's rows as sorted multisets and the ``stats`` dicts exactly
  equal (``per_dest``, ``partition_rows``, ``lane_rows``, ``hot_spread``,
  ``a2a_retries``, collectives, ``bytes_moved``), hot splits included.
- The cases of tests/test_device_exchange.py through the runners, the
  port given ``devices=["cpu"] * d`` and the JAX runner ``jax.devices``
  cut to d, including ``test_fewer_devices_than_partitions`` at d = 1
  and 2.
- The 22 TPC-H queries at d = 3: ``test_torch_mesh_tpch.py``.

Both engines' sizing histories, history stores and profilers are
cleared around every case.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from test_torch_device_exchange import _feed
from test_torch_distributed import clear_stores
from trino_tpu.parallel import device_exchange as jde
from trino_tpu.parallel import exchange as jex
from trino_tpu.parallel.exchange import shard_map
from trino_tpu.sql.parser import parse_statement as j_parse
from trino_tpu_torch import types as PT
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.parallel import DistributedQueryRunner
from trino_tpu_torch.parallel import device_exchange as pde
from trino_tpu_torch.parallel import exchange as pex
from trino_tpu_torch.sql.analyzer import Session
from trino_tpu_torch.sql.parser import parse_statement
from trino_tpu import types as JT


@pytest.fixture(autouse=True)
def _fresh_stores():
    clear_stores()
    yield
    clear_stores()


# -- repartition_a2a ---------------------------------------------------------


def _a2a_inputs(d, cap, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-2 ** 40, 2 ** 40, (d, cap))
    nulls = rng.random((d, cap)) < 0.1
    valid = rng.random((d, cap)) < 0.8
    # skewed destinations: half the rows go to receiver 0
    part = np.where(rng.random((d, cap)) < 0.5, 0,
                    rng.integers(0, d, (d, cap))).astype(np.int32)
    return vals, nulls, valid, part


def _jax_a2a(d, per_dest, vals, nulls, valid, part):
    mesh = Mesh(np.asarray(jax.devices()[:d]), ("x",))

    @partial(shard_map, mesh=mesh, in_specs=(P("x"),) * 4,
             out_specs=(P("x"),) * 4, check_vma=False)
    def prog(v, nl, va, p):
        rc, rn, rv, over = jex.repartition_a2a(
            (v[0],), (nl[0],), va[0], p[0], num_partitions=d,
            per_dest=per_dest, axis_name="x")
        return rc[0][None], rn[0][None], rv[None], over[None]

    return [np.asarray(a) for a in prog(jnp.asarray(vals),
                                        jnp.asarray(nulls),
                                        jnp.asarray(valid),
                                        jnp.asarray(part))]


def _blocks(vals, nulls, valid, d, per_dest):
    """Sorted (value, null) multiset of each (receiver, sender) block."""
    out = []
    for r in range(d):
        for s in range(d):
            lo, hi = s * per_dest, (s + 1) * per_dest
            v = valid[r][lo:hi]
            out.append(sorted(zip(vals[r][lo:hi][v].tolist(),
                                  nulls[r][lo:hi][v].tolist())))
    return out


@pytest.mark.parametrize("d", [2, 4, 8])
def test_repartition_a2a_equals_jax(d):
    cap = 256
    vals, nulls, valid, part = _a2a_inputs(d, cap, seed=d)
    counts = np.stack([np.bincount(part[s][valid[s]], minlength=d)
                       for s in range(d)])
    exact = int(counts.max())
    for per_dest in (exact, max(exact // 4, 1)):
        jc, jn, jv, jo = _jax_a2a(d, per_dest, vals, nulls, valid, part)
        slabs = ["cpu"] * d
        rc, rn, rv, over = pex.repartition_a2a(
            [(torch.from_numpy(vals[s]),) for s in range(d)],
            [(torch.from_numpy(nulls[s]),) for s in range(d)],
            [torch.from_numpy(valid[s]) for s in range(d)],
            [torch.from_numpy(part[s]) for s in range(d)],
            num_partitions=d, per_dest=per_dest, devices=slabs)
        pc = np.stack([c[0].numpy() for c in rc])
        pn = np.stack([x[0].numpy() for x in rn])
        pv = np.stack([v.numpy() for v in rv])
        assert pv.shape == jv.shape == (d, d * per_dest)
        np.testing.assert_array_equal([int(o) for o in over], jo)
        pb, jb = (_blocks(pc, pn, pv, d, per_dest),
                  _blocks(jc, jn, jv, d, per_dest))
        if per_dest == exact:
            assert int(jo.sum()) == 0
            assert pb == jb
            # every live row arrived, at the receiver its id names
            for r in range(d):
                want = sorted(zip(vals[part == r][valid[part == r]].tolist(),
                                  nulls[part == r][valid[part == r]]
                                  .tolist()))
                assert sorted(x for s in range(d)
                              for x in pb[r * d + s]) == want
        else:
            # overflow: the kept rows may differ (unstable JAX sort); the
            # counts may not
            assert int(jo.sum()) > 0
            assert [len(b) for b in pb] == [len(b) for b in jb]


# -- DeviceExchange -----------------------------------------------------------


def _mesh_pair(sizing, d, n=8, rows_per_task=600, hot_frac=0.9, seed=0,
               threshold=0.5):
    """The same exchange through both engines over d devices; returns
    (jax exchange, torch exchange), each drained."""
    out = []
    for engine in ("jax", "torch"):
        if engine == "jax":
            ex = jde.DeviceExchange(n, jax.devices()[:d], sizing=sizing,
                                    hot_split_threshold=threshold)
            ex.configure([JT.BIGINT, JT.BIGINT], [0])
        else:
            ex = pde.DeviceExchange(n, ["cpu"] * d, sizing=sizing,
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


def _same_exchange(jx, px, n=8):
    assert px.stats == jx.stats
    assert _partition_rows(px, n) == _partition_rows(jx, n)
    for attr in ("a2a_retries", "count_collectives", "data_collectives",
                 "collective_ran", "d", "n"):
        assert getattr(px, attr) == getattr(jx, attr), attr


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("sizing,hot_frac", [
    ("exact", 0.0), ("exact", 0.9), ("history", 0.9), ("legacy", 0.9)])
def test_mesh_exchange_stats_equal_jax(d, sizing, hot_frac):
    jx, px = _mesh_pair(sizing, d, hot_frac=hot_frac, seed=d)
    _same_exchange(jx, px)
    assert px.d == d and px.stats["lane_rows"] and \
        len(px.stats["lane_rows"]) == d
    if hot_frac and sizing != "legacy":
        # the hot key's partition splits over every receiver
        assert px.stats["splits"] == 1
        assert list(px.stats["hot_spread"].values()) == [d]
        assert px.stats["split_ways"] == d
    if sizing == "history":
        # the repeat presizes from history: no count pass, the same
        # stats as the JAX engine's repeat (the hot set remembered)
        jx2, px2 = _mesh_pair(sizing, d, hot_frac=hot_frac, seed=d)
        _same_exchange(jx2, px2)
        assert px2.count_collectives == 0
        assert px2.stats["hot_partitions"] == px.stats["hot_partitions"]


def test_mesh_exchange_overflow_backstop_equals_jax():
    """A stale history presize at d = 4 overflows: the doubling backstop
    completes the exchange in both engines with the same retries, and
    the observation re-teaches both histories."""
    small = _mesh_pair("history", 4, rows_per_task=40, hot_frac=0.0,
                       seed=2)
    _same_exchange(*small)
    big = _mesh_pair("history", 4, rows_per_task=3000, hot_frac=0.0,
                     seed=3)
    _same_exchange(*big)
    assert big[1].count_collectives == 0 and big[1].a2a_retries >= 1
    again = _mesh_pair("history", 4, rows_per_task=3000, hot_frac=0.0,
                       seed=3)
    _same_exchange(*again)
    assert again[1].a2a_retries == 0


def test_consumer_pages_hold_their_partition_only():
    """d = n: each consumer's page is its own receiver slab (d lanes
    blocks of ``per_dest``), not the whole exchange's rows, and its live
    lanes are exactly its partition's rows."""
    jx, px = _mesh_pair("exact", 4, n=4, hot_frac=0.0, seed=5)
    _same_exchange(jx, px, n=4)
    per_dest = px.stats["per_dest"]
    for part in range(4):
        (pg,) = px.pages(part)
        assert pg.capacity == 4 * per_dest
        assert pg.count() == px.stats["partition_rows"][part]


# -- through the runners -------------------------------------------------------


QUERIES = [
    "select l_returnflag, l_linestatus, count(*), sum(l_quantity) "
    "from lineitem group by l_returnflag, l_linestatus",
    "select l_shipmode, count(*) from lineitem group by l_shipmode",
    "select o_orderpriority, count(*) from orders, lineitem "
    "where o_orderkey = l_orderkey and l_quantity < 10 "
    "group by o_orderpriority",
]


def _key(row):
    return tuple(("\0" if v is None else str(v)) for v in row)


def _port_runner(device_exchange, devices, n_workers=3):
    s = Session(catalog="tpch", schema="micro")
    s.properties["device_exchange"] = device_exchange
    return DistributedQueryRunner({"tpch": TpchConnector(page_rows=2048)},
                                  s, n_workers=n_workers, desired_splits=8,
                                  broadcast_threshold=300.0, devices=devices)


def _jax_runner(device_exchange, n_workers=3):
    from trino_tpu.connectors.tpch import TpchConnector as JTpch
    from trino_tpu.parallel.distributed import DistributedQueryRunner as JD
    from trino_tpu.sql.analyzer import Session as JSession

    s = JSession(catalog="tpch", schema="micro")
    s.properties["device_exchange"] = device_exchange
    return JD({"tpch": JTpch(page_rows=2048)}, s, n_workers=n_workers,
              desired_splits=8, broadcast_threshold=300.0)


def _stage_exchanges(res):
    return [s.exchange for s in sorted(res.stats["query_stats"].stages,
                                       key=lambda s: s.stage_id)]


@pytest.mark.parametrize("n_devices", [1, 2])
@pytest.mark.parametrize("sql", QUERIES)
def test_fewer_devices_than_partitions(monkeypatch, sql, n_devices):
    """p partitions on d < p device slabs (partition p on slab p % d,
    ids carried through the exchange): the exchange RUNS, not the host
    path, its rows equal the host path's and the JAX engine's on d
    devices, and every boundary's stats equal the JAX engine's."""
    real = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a, **k: real[:n_devices])
    ran = []
    orig = pde.DeviceExchange._collect

    def spying_collect(self):
        assert self.d == min(n_devices, self.n)
        out = orig(self)
        ran.append(self.collective_ran)
        return out

    monkeypatch.setattr(pde.DeviceExchange, "_collect", spying_collect)
    jres = _jax_runner(True)._execute_query(j_parse(sql),
                                            collect_stats=True)
    pres = _port_runner(True, ["cpu"] * n_devices)._execute_query(
        parse_statement(sql), collect_stats=True)
    monkeypatch.undo()
    assert any(ran), "device exchange fell back to host path"
    prows = sorted(pres.rows, key=_key)
    assert prows == sorted(jres.rows, key=_key)
    assert _stage_exchanges(pres) == _stage_exchanges(jres)
    host = _port_runner(False, ["cpu"] * n_devices)
    assert sorted(host.execute(sql).rows, key=_key) == prows


@pytest.mark.parametrize("sql", QUERIES)
def test_device_vs_host_exchange_identical(sql):
    """At d = 3 (the JAX runner's 8 devices cut by its three workers):
    device and host exchange give the same rows, the JAX engine's."""
    dev = _port_runner(True, ["cpu"] * 3)
    before = pde.DeviceExchange.total_collectives
    drows = sorted(dev.execute(sql).rows, key=_key)
    assert pde.DeviceExchange.total_collectives > before
    assert drows == sorted(_port_runner(False, ["cpu"] * 3)
                           .execute(sql).rows, key=_key)
    assert drows == sorted(_jax_runner(True).execute(sql).rows, key=_key)


def test_device_exchange_chosen_for_hash():
    r = _port_runner(True, ["cpu"] * 3)
    sql = ("select l_returnflag, count(*) from lineitem "
           "group by l_returnflag")
    frag = [f for f in r.create_fragments(sql) if f.output_kind == "hash"]
    assert frag
    ex = r._device_exchange_for(frag[0], r.n_workers)
    assert isinstance(ex, pde.DeviceExchange) and ex.d == 3
    # task-count mismatch -> host fallback; exchange off -> host path
    assert r._device_exchange_for(frag[0], r.n_workers + 1) is None
    off = _port_runner(False, ["cpu"] * 3)
    assert off._device_exchange_for(frag[0], off.n_workers) is None
    # more devices than workers: the exchange takes n of them
    wide = _port_runner(True, ["cpu"] * 8)
    assert wide._device_exchange_for(frag[0], wide.n_workers).d == 3
