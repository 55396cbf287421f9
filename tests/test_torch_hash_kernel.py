"""The hash table's probe kernel (``kernels.hash_insert``) on the CPU: its
wrapper, its plain version and the hash-grouped page around it.

On a CPU tensor the wrapper runs ``hash_insert_reference`` and launches
nothing; the kernel itself runs only on a card (``tests/test_torch_cuda.py``
holds it against the plain version there). Here: the wrapper's CPU path,
the rounds it reports, the table size against the JAX engine's, and
``HashAggregationOperator._hash_group_page``, which dispatches the reduce
before its one host read (the overflow flag) and falls back to the sort
path on an overflowed page with the JAX engine's rows.
"""

import numpy as np
import pytest
import torch

import trino_tpu_torch as P
from trino_tpu.connectors.tpch import TpchConnector as JConnector
from trino_tpu.runner import LocalQueryRunner as JRunner
from trino_tpu.sql.analyzer import Session as JSession
from trino_tpu.telemetry import profiler as jprof
from trino_tpu.telemetry import stats_store as jss
from trino_tpu_torch.connectors.tpch import TpchConnector as PConnector
from trino_tpu_torch.ops import aggregation, hashtable, kernels
from trino_tpu_torch.sql.analyzer import Session as PSession
from trino_tpu_torch.telemetry import profiler as pprof
from trino_tpu_torch.telemetry import stats_store as pss

torch.set_num_threads(2)

GROUP_SQL = ("select l_returnflag, l_linestatus, sum(l_quantity), "
             "count(*) from lineitem group by l_returnflag, l_linestatus "
             "order by l_returnflag, l_linestatus")


def _operands(rng, cap, nvals):
    """A (uint8 null tag, int64 key) pair and an int32 and a bool
    operand: every dtype class the kernel reads."""
    key = rng.integers(0, nvals, cap).astype(np.int64) * 7919 - 3
    tag = (rng.random(cap) < 0.1).astype(np.uint8)
    small = rng.integers(-2, 2, cap).astype(np.int32)
    flag = rng.random(cap) < 0.5
    return [torch.from_numpy(a) for a in (tag, key, small, flag)]


@pytest.mark.parametrize("cap,nvals", [(1, 1), (7, 3), (1000, 140),
                                       (4096, 4096)])
def test_cpu_wrapper_runs_the_plain_version(cap, nvals):
    """A CPU page takes the plain version: the same (rep, resolved,
    rounds), no launch counted and nothing recorded."""
    rng = np.random.default_rng(cap)
    ops = _operands(rng, cap, nvals)
    valid = torch.from_numpy(np.arange(cap) < cap - cap // 10)
    before = kernels.launch_counts()
    kernels.record_calls(True, "hash_insert")
    try:
        got = kernels.hash_insert(ops, valid, hashtable.PROBE_ROUNDS)
    finally:
        kept = kernels.record_calls(False, "hash_insert")
    want = kernels.hash_insert_reference(ops, valid, hashtable.PROBE_ROUNDS)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert kernels.launch_counts() == before
    assert kept == []
    rep, resolved, taken = got
    assert rep.dtype == torch.int32 and resolved.dtype == torch.bool
    assert taken.shape == () and taken.dtype == torch.int32


@pytest.mark.parametrize("cap,nvals,rounds", [(256, 4, 32), (4096, 585, 32),
                                              (4096, 4096, 32),
                                              (4096, 4096, 2), (0, 1, 32)])
def test_rounds_taken_is_the_least_budget_that_resolves(cap, nvals, rounds):
    """The rounds reported are the while_loop's: the least budget under
    which every row resolves, or the whole budget when some row does
    not; a budget of one round less leaves a row unresolved."""
    rng = np.random.default_rng(cap + nvals + rounds)
    ops = _operands(rng, cap, nvals)[:2]
    valid = torch.ones(cap, dtype=torch.bool)
    rep, resolved, taken = kernels.hash_insert(ops, valid, rounds)
    taken = int(taken)
    assert 0 <= taken <= rounds
    if bool(resolved.all()):
        again = kernels.hash_insert(ops, valid, taken)
        assert torch.equal(again[0], rep) and bool(again[1].all())
        if taken:
            assert not bool(kernels.hash_insert(ops, valid,
                                                taken - 1)[1].all())
    else:
        assert taken == rounds
        assert bool((rep[~resolved] == cap).all())


def test_zero_rounds_and_zero_operands():
    """No budget: every valid row is unresolved (rep = cap), every invalid
    lane resolved to itself. No operands (a global aggregation): every
    valid row joins the first valid row in one round."""
    valid = torch.tensor([False, True, True, False, True])
    rep, resolved, taken = kernels.hash_insert([], valid, 0)
    assert rep.tolist() == [0, 5, 5, 3, 5] and int(taken) == 0
    assert resolved.tolist() == [True, False, False, True, False]
    rep, resolved, taken = kernels.hash_insert([], valid, 32)
    assert rep.tolist() == [0, 1, 1, 3, 1] and int(taken) == 1
    assert bool(resolved.all())


@pytest.mark.parametrize("cap", [0, 1, 2, 3, 1000, 262_144, 16_777_216])
def test_table_size_is_the_jax_engines(cap):
    want = 1 << max(2 * cap - 1, 1).bit_length()   # trino_tpu hashtable
    assert kernels.table_size(cap) == want
    assert want >= 2 * cap and want & (want - 1) == 0


def test_operand_dtypes_the_kernel_reads():
    """Bool, the unsigned tag byte and the signed integer widths; a float
    operand is refused on the card (floats keep the sort path)."""
    assert set(kernels._OPERAND_CODE) == {
        torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32,
        torch.int64}
    with pytest.raises(ValueError, match="one CUDA device"):
        kernels._check_hash([torch.zeros(2)], torch.ones(2, dtype=bool), 1)


class _Flag:
    """A stand-in for the overflow scalar that logs its host read."""

    def __init__(self, value, log):
        self.value, self.log = value, log

    def __bool__(self):
        self.log.append("overflow read")
        return self.value


@pytest.fixture
def clean_stores():
    """Both engines' history stores and profilers empty before and after
    a test that runs queries: they are process-wide, and a later test
    file in the same process must not plan from this one's history."""
    def clear():
        for store in (jss.store(), pss.store()):
            store.clear()
        for prof in (jprof, pprof):
            prof.reset()
    clear()
    yield
    clear()


def _runner():
    return P.LocalQueryRunner({"tpch": PConnector(page_rows=4096)},
                              PSession(catalog="tpch", schema="micro"),
                              device="cpu")


def test_hash_page_dispatches_reduce_before_reading_overflow(monkeypatch,
                                                           clean_stores):
    """``_hash_group_page`` calls ``hash_segment_reduce`` before its one
    host read, the overflow flag, as the JAX engine orders them
    (trino_tpu/ops/aggregation.py:770-782)."""
    log = []
    group_ids, reduce = aggregation.hash_group_ids, \
        aggregation.hash_segment_reduce

    def logged_group_ids(*args, **kwargs):
        gid, rows, ngroups, overflow = group_ids(*args, **kwargs)
        log.append("group ids")
        assert ngroups.shape == () and overflow.shape == ()
        return gid, rows, ngroups, _Flag(bool(overflow), log)

    def logged_reduce(*args, **kwargs):
        log.append("reduce dispatched")
        return reduce(*args, **kwargs)

    monkeypatch.setattr(aggregation, "hash_group_ids", logged_group_ids)
    monkeypatch.setattr(aggregation, "hash_segment_reduce", logged_reduce)
    res = _runner().execute(GROUP_SQL)
    assert len(res.rows) == 4
    pages = log.count("group ids")
    assert pages > 0
    assert log == ["group ids", "reduce dispatched", "overflow read"] * pages


def test_overflowed_page_falls_back_to_sort_with_jax_rows(monkeypatch,
                                                         clean_stores):
    """A page whose rows exhaust the probe budget (a budget of 0 rounds
    here) takes the sort path, and the query still returns the JAX
    engine's rows."""
    group_ids = aggregation.hash_group_ids

    def no_budget(key_ops, valid, exact=True):
        return group_ids(key_ops, valid, rounds=0, exact=exact)

    jr = JRunner({"tpch": JConnector(page_rows=4096)},
                 JSession(catalog="tpch", schema="micro"))
    want = jr.execute(GROUP_SQL).rows
    monkeypatch.setattr(aggregation, "hash_group_ids", no_budget)
    res = _runner().execute(GROUP_SQL)
    assert res.rows == want
    paths = [op["grouping_paths"] for op in res.stats["operators"]
             if op["name"] == "HashAggregationOperator"]
    assert paths and all(p.get("hash", 0) == 0 and p.get("sort", 0) > 0
                         for p in paths), paths
