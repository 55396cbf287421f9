"""The torch engine's global-hash aggregation (``ops/global_hash_agg.py``)
against the JAX engine's: the 8 cases of tests/test_global_hash_agg.py.

The port's functions take a list of per-slab tensors; the JAX engine's
single-device mode (``axis_name=None``) is a list of one slab. Inputs
come from numpy seeds. Each case runs both engines on the same
keys and values: the packed keys, the table (the JAX uint64 against the
port's int64 of the same bits), each row's slot, its resolved flag and
the unresolved count must be equal; integer states exactly and float32
min/max states exactly (a min or max picks a value, it does not round).
The mesh case runs the JAX kernel on the 8 virtual CPU devices of
tests/conftest.py and the port on 8 CPU slabs (``["cpu"] * 8``): every
slab's replica of the table must equal the JAX table. The strategy
rule and the EXPLAIN annotation are held against the JAX engine's
planner.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from trino_tpu.ops import global_hash_agg as jg
from trino_tpu.parallel.exchange import shard_map
from trino_tpu_torch.ops import global_hash_agg as pg


def _u64(t: torch.Tensor) -> np.ndarray:
    """The port's int64 key lanes as the JAX engine's uint64."""
    return t.numpy().view(np.uint64)


def _occupied(table: np.ndarray) -> dict:
    """slot -> key of an occupied table (single 32-bit key column)."""
    occ = np.nonzero(table != np.uint64(jg.EMPTY))[0]
    return {int(s): int((table[s] & np.uint64(0xFFFFFFFF)) - 1) for s in occ}


def test_pack_unpack_roundtrip_with_nulls():
    k1 = np.asarray([0, 5, 1 << 20, 3, 7, (1 << 32) - 2], dtype=np.int64)
    n1 = np.asarray([False, False, False, True, False, False])
    k2 = np.asarray([9, 0, 2, 4, 1 << 30, 11], dtype=np.int64)
    jp = jg.pack_keys([jnp.asarray(k1), jnp.asarray(k2)],
                      [jnp.asarray(n1), None], (32, 32))
    pp = pg.pack_keys([torch.from_numpy(k1), torch.from_numpy(k2)],
                      [torch.from_numpy(n1), None], (32, 32))
    np.testing.assert_array_equal(_u64(pp), np.asarray(jp))
    assert not (_u64(pp) == np.uint64(jg.EMPTY)).any()
    assert len(set(_u64(pp).tolist())) == len(k1)
    jun = jg.unpack_keys(jp, (32, 32))
    pun = pg.unpack_keys(pp, (32, 32))
    for (jv, jn), (pv, pn) in zip(jun, pun):
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    (v1, u1), (v2, u2) = pun
    np.testing.assert_array_equal(u1.numpy(), n1)
    np.testing.assert_array_equal(v1.numpy()[~n1], k1[~n1])
    np.testing.assert_array_equal(v2.numpy(), k2)
    # three widths, one of them odd
    k3 = np.asarray([1, 2, 3, 4, 5, 6], dtype=np.int64)
    jp3 = jg.pack_keys([jnp.asarray(k1 & 0xFFFF), jnp.asarray(k2 & 0xFFFF),
                        jnp.asarray(k3)], [None, None, None], (17, 21, 26))
    pp3 = pg.pack_keys([torch.from_numpy(k1 & 0xFFFF),
                        torch.from_numpy(k2 & 0xFFFF),
                        torch.from_numpy(k3)], [None, None, None],
                       (17, 21, 26))
    np.testing.assert_array_equal(_u64(pp3), np.asarray(jp3))


def _host_groupby(keys, vals, valid):
    out = {}
    for k, v, va in zip(keys, vals, valid):
        if va:
            s, c, mn, mx = out.get(int(k), (0, 0, 1 << 62, -(1 << 62)))
            out[int(k)] = (s + int(v), c + 1, min(mn, int(v)),
                           max(mx, int(v)))
    return out


def _int_states(np_mod, v, va):
    """sum, count, min and max states of one value column, neutralized
    on dead lanes; ``np_mod`` is ``jnp`` or ``torch``."""
    info = np.iinfo(np.int64)
    return (np_mod.where(va, v, 0), va.astype(np.int64) if np_mod is jnp
            else va.to(torch.int64),
            np_mod.where(va, v, info.max), np_mod.where(va, v, info.min))


def test_single_device_kernel_matches_host_oracle():
    rng = np.random.default_rng(2)
    n, ndv, ts = 4096, 300, 1024
    keys = rng.integers(0, ndv, n)
    vals = rng.integers(-500, 500, n).astype(np.int64)
    valid = rng.random(n) > 0.1
    jt, js, jr, ju = jg.global_hash_insert(
        jg.pack_keys([jnp.asarray(keys)], [None], (32,)),
        jnp.asarray(valid), ts)
    (pt,), (ps,), (pr,), pu = pg.global_hash_insert(
        [pg.pack_keys([torch.from_numpy(keys)], [None], (32,))],
        [torch.from_numpy(valid)], ts)
    np.testing.assert_array_equal(_u64(pt), np.asarray(jt))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    assert int(pu) == int(ju) == 0
    kinds = ("sum", "sum", "min", "max")
    jred = jg.global_hash_reduce(
        js, jr, jnp.asarray(valid),
        _int_states(jnp, jnp.asarray(vals), jnp.asarray(valid)), kinds, ts)
    pva = torch.from_numpy(valid)
    (pred,) = pg.global_hash_reduce(
        [ps], [pr], [pva], [_int_states(torch, torch.from_numpy(vals), pva)],
        kinds, ts)
    for a, b in zip(pred, jred):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    t = _u64(pt)
    got = {key: tuple(int(c.numpy()[s]) for c in pred)
           for s, key in _occupied(t).items()}
    assert got == _host_groupby(keys, vals, valid)


def test_mesh_kernel_matches_host_oracle_all_kinds():
    rng = np.random.default_rng(7)
    n_dev, rows, ndv, ts = 8, 1024, 150, 512
    keys = rng.integers(0, ndv, (n_dev, rows))
    vals = rng.integers(-100, 900, (n_dev, rows)).astype(np.int64)
    valid = rng.random((n_dev, rows)) > 0.05
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("x",))
    info = jnp.iinfo(jnp.int64)
    kinds = ("sum", "sum", "min", "max")

    @partial(shard_map, mesh=mesh, in_specs=(P("x"),) * 3,
             out_specs=(P("x"),) * 8, check_vma=False)
    def prog(k, v, va):
        k, v, va = k[0], v[0], va[0]
        packed = jg.pack_keys([k], [None], (32,))
        table, slot_of, resolved, unresolved = jg.global_hash_insert(
            packed, va, ts, axis_name="x")
        sums, cnts, mns, mxs = jg.global_hash_reduce(
            slot_of, resolved, va,
            (jnp.where(va, v, 0), va.astype(jnp.int64),
             jnp.where(va, v, info.max), jnp.where(va, v, info.min)),
            kinds, ts, axis_name="x")
        return (table[None], slot_of[None], resolved[None],
                unresolved[None], sums[None], cnts[None], mns[None],
                mxs[None])

    jout = [np.asarray(a) for a in prog(jnp.asarray(keys),
                                        jnp.asarray(vals),
                                        jnp.asarray(valid))]
    slabs = ["cpu"] * n_dev
    pk = [torch.from_numpy(keys[i]).to(d) for i, d in enumerate(slabs)]
    pv = [torch.from_numpy(vals[i]).to(d) for i, d in enumerate(slabs)]
    pva = [torch.from_numpy(valid[i]).to(d) for i, d in enumerate(slabs)]
    packed = [pg.pack_keys([k], [None], (32,)) for k in pk]
    tables, slot_of, resolved, unresolved = pg.global_hash_insert(
        packed, pva, ts)
    red = pg.global_hash_reduce(
        slot_of, resolved, pva,
        [_int_states(torch, v, va) for v, va in zip(pv, pva)], kinds, ts)
    for i in range(n_dev):
        np.testing.assert_array_equal(_u64(tables[i]), jout[0][i])
        np.testing.assert_array_equal(slot_of[i].numpy(), jout[1][i])
        np.testing.assert_array_equal(resolved[i].numpy(), jout[2][i])
        for j in range(4):
            np.testing.assert_array_equal(red[i][j].numpy(), jout[4 + j][i])
    assert int(unresolved) == int(jout[3][0]) == 0
    got = {key: tuple(int(c.numpy()[s]) for c in red[0])
           for s, key in _occupied(_u64(tables[0])).items()}
    want = _host_groupby(keys.reshape(-1), vals.reshape(-1),
                         valid.reshape(-1))
    assert got == want
    assert len(got) <= ndv


def test_reduce_handles_float32_min_max_states():
    """REAL aggregates carry float32 min/max states: the sentinels are
    +-inf, not the integer limits."""
    rng = np.random.default_rng(11)
    n, ts = 512, 64
    keys = rng.integers(0, 20, n)
    vals = rng.standard_normal(n).astype(np.float32)
    valid = np.ones(n, dtype=bool)
    jt, js, jr, ju = jg.global_hash_insert(
        jg.pack_keys([jnp.asarray(keys)], [None], (32,)),
        jnp.asarray(valid), ts)
    (pt,), (ps,), (pr,), pu = pg.global_hash_insert(
        [pg.pack_keys([torch.from_numpy(keys)], [None], (32,))],
        [torch.from_numpy(valid)], ts)
    assert int(pu) == int(ju) == 0
    np.testing.assert_array_equal(_u64(pt), np.asarray(jt))
    jv = jnp.asarray(vals)
    pv = torch.from_numpy(vals)
    jmn, jmx = jg.global_hash_reduce(js, jr, jnp.asarray(valid), (jv, jv),
                                     ("min", "max"), ts)
    ((pmn, pmx),) = pg.global_hash_reduce(
        [ps], [pr], [torch.from_numpy(valid)], [(pv, pv)], ("min", "max"),
        ts)
    assert pmn.dtype == torch.float32
    np.testing.assert_array_equal(pmn.numpy(), np.asarray(jmn))
    np.testing.assert_array_equal(pmx.numpy(), np.asarray(jmx))
    for slot, key in _occupied(_u64(pt)).items():
        sel = vals[keys == key]
        assert pmn.numpy()[slot] == sel.min()
        assert pmx.numpy()[slot] == sel.max()
    # empty slots keep the float sentinels
    free = _u64(pt) == np.uint64(jg.EMPTY)
    assert np.isposinf(pmn.numpy()[free]).all()
    assert np.isneginf(pmx.numpy()[free]).all()


def test_probe_budget_overflow_is_reported_not_wrong():
    """More distinct keys than the table can hold: unresolved rows are
    REPORTED (the caller's fallback trigger), equal to the JAX engine's
    count, and every resolved row still aggregates correctly."""
    n, ts = 512, 16
    keys = np.arange(n)
    valid = np.ones(n, dtype=bool)
    jt, js, jr, ju = jg.global_hash_insert(
        jg.pack_keys([jnp.asarray(keys)], [None], (32,)),
        jnp.asarray(valid), ts)
    (pt,), (ps,), (pr,), pu = pg.global_hash_insert(
        [pg.pack_keys([torch.from_numpy(keys)], [None], (32,))],
        [torch.from_numpy(valid)], ts)
    assert int(pu) == int(ju) > 0
    assert int(pu) == n - int(pr.sum())
    np.testing.assert_array_equal(_u64(pt), np.asarray(jt))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    (jsum,) = jg.global_hash_reduce(js, jr, jnp.asarray(valid),
                                    (jnp.asarray(keys, jnp.int64),),
                                    ("sum",), ts)
    ((psum,),) = pg.global_hash_reduce(
        [ps], [pr], [torch.from_numpy(valid)], [(torch.from_numpy(keys),)],
        ("sum",), ts)
    np.testing.assert_array_equal(psum.numpy(), np.asarray(jsum))
    for slot, key in _occupied(_u64(pt)).items():
        r = pr.numpy() & (keys == key)
        assert int(psum.numpy()[slot]) == int(keys[r].sum())


def test_kernel_sizing_history_stabilizes_capacity():
    from trino_tpu.ops.kernel_sizing import ShapeSizingHistory as JHistory
    from trino_tpu_torch.ops.kernel_sizing import ShapeSizingHistory

    trail = []
    for H in (JHistory, ShapeSizingHistory):
        h = H()
        key = ("test", "shape")
        got = [h.suggest(key, 1000), h.suggest(key, 5000),
               h.suggest(key, 900), h.suggest(("other",), 17)]
        got += [h.suggest(key, 900) for _ in range(12)]
        trail.append(got)
    assert trail[1] == trail[0]
    assert trail[1][:2] == [1024, 8192] and trail[1][2] >= 2048
    assert trail[1][3] == 32 and trail[1][-1] == 1024


@pytest.mark.parametrize("override,expect", [
    ("AUTOMATIC", "global-hash"),
    ("EXCHANGE", "exchange"),
    ("GLOBAL_HASH", "global-hash"),
])
def test_agg_strategy_cost_rule_and_override(override, expect):
    from trino_tpu.planner.optimizer import choose_agg_strategy as jchoose
    from trino_tpu_torch.planner.optimizer import choose_agg_strategy

    got = choose_agg_strategy(10, 4, override=override)
    assert got == jchoose(10, 4, override=override)
    assert got[0] == expect and got[1]
    high = choose_agg_strategy(1 << 20, 4)
    assert high == jchoose(1 << 20, 4) and high[0] == "exchange"


def test_agg_strategy_annotation_in_explain():
    """The planner annotates grouped aggregations with the cost-model
    pick, honoring the session override both ways, as the JAX engine's
    EXPLAIN does. Both engines' history stores start empty: a recorded
    run of the same statement in this process would source the estimate
    from history instead of the connector."""
    from trino_tpu.connectors.tpch import TpchConnector as JTpch
    from trino_tpu.runner import LocalQueryRunner as JLocal
    from trino_tpu.sql.analyzer import Session as JSession
    from trino_tpu.telemetry import stats_store as jss
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.runner import LocalQueryRunner
    from trino_tpu_torch.sql.analyzer import Session
    from trino_tpu_torch.telemetry import stats_store as pss

    for store in (jss.store(), pss.store()):
        store.clear()

    low = ("select l_returnflag, count(*) from lineitem "
           "group by l_returnflag")
    high = ("select l_orderkey, count(*) from lineitem "
            "group by l_orderkey")

    def plans(**props):
        out = []
        for S, C, R, kw in ((JSession, JTpch, JLocal, {}),
                            (Session, TpchConnector, LocalQueryRunner,
                             {"device": "cpu"})):
            s = S(catalog="tpch", schema="micro")
            s.properties.update(props)
            r = R({"tpch": C(page_rows=4096)}, s, **kw)
            out.append((r.explain(low), r.explain(high)))
        return out

    for props, lo, hi in (({}, True, None),
                          ({"aggregation_strategy": "EXCHANGE"}, False,
                           False),
                          ({"global_hash_agg_max_table": 16}, None, False),
                          ({"aggregation_strategy": "GLOBAL_HASH"}, True,
                           True)):
        (jlo, jhi), (plo, phi) = plans(**props)
        assert plo == jlo and phi == jhi
        if lo is not None:
            assert ("strategy=global-hash" in plo) == lo
        if hi is not None:
            assert ("strategy=global-hash" in phi) == hi
