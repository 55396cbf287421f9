"""The hash table's probe kernel (``kernels.hash_insert``) on the CPU: its
wrapper, its plan, its plain version, a model of its order, and the
hash-grouped page around it.

On a CPU tensor the wrapper runs ``hash_insert_reference`` and launches
nothing; the kernel itself runs only on a card (``tests/test_torch_cuda.py``
holds it against the plain version there). Here: the wrapper's CPU path,
the rounds it reports, the table size against the JAX engine's,
``hash_plan`` (entry width, grid, the call's buffer) at its edges, a plain-torch
model of the kernel's round-tagged, fused-phase lockstep held against the
plain version and the JAX engine's ``hash_group_ids``, and
``HashAggregationOperator._hash_group_page``, which dispatches the reduce
before its one host read (the overflow flag) and falls back to the sort
path on an overflowed page with the JAX engine's rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trino_tpu_torch as P
from trino_tpu.ops import hashtable as jht
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


#: blocks of the kernel an H100 keeps resident (132 SMs x 4)
H100_RESIDENT = 528


@pytest.mark.parametrize("n,rounds,spills,width", [
    (0, 32, False, 32), (1, 32, False, 32), (1, 0, False, 32),
    (16, 32, False, 32), (64, 32, False, 32),
    (512, 32, False, 32), (513, 32, False, 32),
    (8_192, 32, False, 32), (16_384, 32, False, 32),
    (16_385, 32, False, 32), (262_144, 32, False, 32),
    (1 << 26, 32, True, 32), ((1 << 26) + 1, 32, True, 64),
    (134_217_728, 32, True, 64), (512, (1 << 23) - 1, False, 32),
    (512, 1 << 23, False, 64)])
def test_hash_plan_tiers_widths_and_scratch(n, rounds, spills, width):
    """The plan of a call on an H100's resident grid at small pages,
    either side of the entry width's switch (2^26 lanes at the 32-round
    budget, or a budget that pushes a tag past 32 bits), 0 and 1 rows and
    0 rounds: every tag stays below the empty entry of its width, a block
    a tile up to the resident grid, and the call's buffer holds rep, the
    rounds and barriers run, the table at a 256-byte boundary, its
    barrier's words and, where a block's tiles outgrow its shared memory,
    the worklists, in whole int32 words."""
    plan = kernels.hash_plan(n, rounds, H100_RESIDENT)
    assert (plan.width, plan.spills) == (width, spills)
    tsize = kernels.table_size(n)
    bits = max(n - 1, 0).bit_length()
    assert (rounds << bits) - 1 < (1 << width) - 1
    if width == 64:
        assert rounds << bits >= 1 << 32
    tiles = -(-n // kernels.HASH_GRID_THREADS)
    assert plan.blocks == max(1, min(tiles, H100_RESIDENT))
    table_at, list_at, nbytes = kernels.hash_layout(n, width, spills)
    assert table_at % 256 == 0 and table_at >= 4 * n + 8
    assert list_at == table_at + tsize * width // 8 + 24
    rows = tiles * kernels.HASH_GRID_THREADS   # whole tiles
    assert plan.nbytes == nbytes == list_at + (8 * rows if spills else 0)
    assert nbytes % 8 == 0


@pytest.mark.parametrize("resident,n,spills", [
    (H100_RESIDENT, H100_RESIDENT * 4096, False),
    (H100_RESIDENT, H100_RESIDENT * 4096 + 1, True),
    (132, 132 * 4096, False), (132, 132 * 4096 + 512, True),
    (1, 4096, False), (1, 4097, True)])
def test_hash_plan_shared_tier_room(resident, n, spills):
    """A block's worklist stays in its shared memory while its tiles hold
    at most ``HASH_LIST_ROWS`` rows (4,096 x the resident grid's blocks
    in all), and spills into the call's buffer one tile past that; a grid
    of no blocks raises."""
    plan = kernels.hash_plan(n, 32, resident)
    assert plan.blocks == resident and plan.spills == spills
    tiles = -(-n // kernels.HASH_GRID_THREADS)
    most = -(-tiles // resident) * kernels.HASH_GRID_THREADS  # a block's
    assert (most > kernels.HASH_LIST_ROWS) == spills
    with pytest.raises(ValueError, match="resident grid"):
        kernels.hash_plan(n, 32, 0)


#: a slot no claim names (the model's empty entry, above every tag)
_EMPTY = (1 << 63) - 1


def fused_lockstep(key_ops, valid, rounds):
    """A plain-torch model of the kernel's order: one phase a round, a
    table entry ``(round << bits) | row`` (empty above every tag), a claim
    the minimum of ``(round, row)``, and in phase k the key compare of
    round k - 1 before the claims of round k, which must leave every slot
    the phase compared against as it was. Returns (rep, resolved, rounds
    run, barriers run), barriers one after each phase but the last of a
    call at its budget."""
    n = valid.shape[0]
    width = kernels.hash_entry_width(n, rounds)
    bits = max(n - 1, 0).bit_length()
    assert (rounds << bits) - 1 < min(_EMPTY, (1 << width) - 1)
    tsize = kernels.table_size(n)
    mask = tsize - 1
    row = torch.arange(n, dtype=torch.int64)
    first = kernels.mix_operands(key_ops, n, "cpu") & mask
    table = torch.full((tsize + 1,), _EMPTY, dtype=torch.int64)
    rep = torch.where(valid, n, row).to(torch.int32)
    resolved = ~valid
    active = valid.clone()

    def claim(k):
        slot = torch.where(active, (first + k) & mask, tsize)
        table.scatter_reduce_(0, slot, (k << bits) | row, "amin")

    if rounds == 0:
        return rep, resolved, 0, 0
    claim(0)
    k = barriers = 0
    while True:
        barriers += 1
        if not bool(active.any()):
            return rep, resolved, k, barriers
        k += 1
        slot = (first + k - 1) & mask
        held = table[slot]
        filled = held != _EMPTY
        owner = torch.where(filled, held & ((1 << bits) - 1), 0)
        compared = active.clone()
        eq = active & filled
        for op in key_ops:
            eq &= op == op[owner]
        rep = torch.where(eq, owner.to(torch.int32), rep)
        resolved |= eq
        active &= ~eq
        if k == rounds:
            return rep, resolved, k, barriers
        claim(k)
        assert torch.equal(table[slot][compared], held[compared])


def _colliding_keys(rng, cap, count, span):
    """``count`` distinct int64 keys whose first slot (as a (uint8 tag 0,
    key) operand pair) falls in the first ``span`` slots of a page of
    ``cap`` lanes: one long probe chain."""
    cand = rng.integers(-(1 << 40), 1 << 40, 40_000)
    ops = [torch.zeros(cand.size, dtype=torch.uint8), torch.from_numpy(cand)]
    slot = kernels.mix_operands(ops, cand.size, "cpu") & (
        kernels.table_size(cap) - 1)
    picked = np.unique(cand[(slot < span).numpy()])[:count]
    assert picked.size == count
    return picked


def _lockstep_case(case):
    """(key_ops, valid, rounds) of one case of the model's test."""
    rng = np.random.default_rng(sum(map(ord, case)))
    cap = {"near_full_1_round": 4096, "near_full_2_rounds": 4096,
           "long_chains": 256, "long_chains_budget": 256, "nulls": 1000,
           "zero_keys": 300, "zero_rounds": 64, "one_row": 1}[case]
    valid = torch.from_numpy(np.arange(cap) < cap - cap // 20)
    rounds = 32
    if case.startswith("near_full"):
        ops = [torch.zeros(cap, dtype=torch.uint8),
               torch.from_numpy(rng.permutation(cap) * 1_000_003 - 7)]
        rounds = 1 if case == "near_full_1_round" else 2
    elif case.startswith("long_chains"):
        keys = _colliding_keys(rng, cap, 40, 3)
        ops = [torch.zeros(cap, dtype=torch.uint8),
               torch.from_numpy(keys[rng.integers(0, keys.size, cap)])]
        rounds = 64 if case == "long_chains" else 16
    elif case == "zero_keys":
        ops = []
    else:
        ops = _operands(rng, cap, 140 if case == "nulls" else 5)
        rounds = 0 if case == "zero_rounds" else 32
    return ops, valid, rounds


@pytest.mark.parametrize("case", [
    "near_full_1_round", "near_full_2_rounds", "long_chains",
    "long_chains_budget", "nulls", "zero_keys", "zero_rounds", "one_row"])
def test_fused_lockstep_model_is_the_reference(monkeypatch, case):
    """The kernel's order (round-tagged claims, one phase a round) gives
    the plain version's (rep, resolved, rounds run) exactly, overflow
    included, with one barrier a round (``rounds`` at the budget), and
    its group ids, group rows, group count and overflow flag equal the
    JAX engine's ``hash_group_ids``."""
    ops, valid, rounds = _lockstep_case(case)
    rep, resolved, taken, barriers = fused_lockstep(ops, valid, rounds)
    want = kernels.hash_insert_reference(ops, valid, rounds)
    assert torch.equal(rep, want[0]) and torch.equal(resolved, want[1])
    assert taken == int(want[2])
    assert barriers == (taken + 1 if taken < rounds else rounds)
    if case in ("near_full_1_round", "near_full_2_rounds",
                "long_chains_budget"):
        assert not bool(resolved.all())     # the budget runs out
    if case == "long_chains":
        assert bool(resolved.all()) and taken > 16
    monkeypatch.setattr(kernels, "hash_insert", lambda k, v, r: (
        lambda out: (out[0], out[1], torch.tensor(out[2])))(
            fused_lockstep(k, v, r)))
    got = hashtable.hash_group_ids(ops, valid, rounds=rounds)
    jgot = jht.hash_group_ids(tuple(jnp.asarray(op.numpy()) for op in ops),
                              jnp.asarray(valid.numpy()), rounds=rounds)
    ngroups = int(got[2])
    assert ngroups == int(jgot[2]) and bool(got[3]) == bool(jgot[3])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jgot[0]))
    np.testing.assert_array_equal(got[1].numpy()[:ngroups],
                                  np.asarray(jgot[1])[:ngroups])


class _Flag:
    """A stand-in for the overflow scalar (a 0-d host tensor) that logs
    its host read, made through the device-read helper's ``item()``."""

    is_cuda = False

    def __init__(self, value, log):
        self.value, self.log = value, log

    def item(self):
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
