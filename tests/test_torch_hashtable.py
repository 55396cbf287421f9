"""The torch engine's hash grouping against the JAX engine's.

``trino_tpu_torch.ops.hashtable`` ports ``trino_tpu.ops.hashtable``: the
splitmix64 mix runs on int64 lanes instead of uint64, and the probe loop
(``lax.while_loop`` there) is a kernel on the card and its plain version,
a Python loop, on the CPU. Gids are dense, numbered in first-occurrence
order, so they must EQUAL the JAX gids lane for lane — as must
``group_rows``, ``ngroups``, the overflow flag (both 0-d tensors in both
engines) and the reduced states of ``hash_segment_reduce`` (integer
states, so exactly).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trino_tpu import types as JT
from trino_tpu.block import Dictionary as JDictionary
from trino_tpu.ops import hashtable as jht
from trino_tpu.ops.sortkeys import group_operands as j_group_operands
from trino_tpu_torch import types as PT
from trino_tpu_torch.block import Dictionary as PDictionary
from trino_tpu_torch.ops import hashtable as pht
from trino_tpu_torch.ops import kernels as pkernels
from trino_tpu_torch.ops.sortkeys import group_operands as p_group_operands

torch.set_num_threads(2)

WORDS = ["delta", "alpha", "charlie", "bravo", "alpha", "echo"]


def _keys(rng, cap, n, nvals, with_nulls):
    """Two key columns (int64 and a string column's lexicographic ranks),
    optional nulls, ``n`` valid lanes of ``cap``."""
    k1 = rng.integers(0, nvals, cap).astype(np.int64) * 1_000_003 - 5
    codes = rng.integers(0, len(WORDS), cap).astype(np.int32)
    # pooled keys group by rank: an aligned pool may hold "alpha" twice
    jr = JDictionary.aligned(WORDS).sort_rank().astype(np.int64)[codes]
    pr = PDictionary.aligned(WORDS).sort_rank().astype(np.int64)[codes]
    assert (jr == pr).all()
    n1 = rng.random(cap) < 0.2 if with_nulls else np.zeros(cap, bool)
    n2 = rng.random(cap) < 0.1 if with_nulls else np.zeros(cap, bool)
    valid = np.arange(cap) < n
    return [k1, jr], [n1, n2], valid


def _both_gids(keys, nulls, valid, **kw):
    j_ops = []
    p_ops = []
    for k, nl in zip(keys, nulls):
        j_ops += j_group_operands(jnp.asarray(k), jnp.asarray(nl), JT.BIGINT)
        p_ops += p_group_operands(torch.from_numpy(k), torch.from_numpy(nl),
                                  PT.BIGINT)
    j = jht.hash_group_ids(tuple(j_ops), jnp.asarray(valid), **kw)
    p = pht.hash_group_ids(p_ops, torch.from_numpy(valid), **kw)
    return j, p


@pytest.mark.parametrize("cap,n,nvals", [(16, 11, 3), (256, 200, 40),
                                         (1024, 1000, 900),
                                         (4096, 4096, 7)])
@pytest.mark.parametrize("with_nulls", [False, True])
def test_gids_equal_jax(cap, n, nvals, with_nulls):
    rng = np.random.default_rng(cap + nvals)
    keys, nulls, valid = _keys(rng, cap, n, nvals, with_nulls)
    (jg, jrows, jng, jov), (pg, prows, png, pov) = _both_gids(keys, nulls,
                                                              valid)
    assert not bool(jov) and not bool(pov)
    png = int(png)
    assert png == int(jng)
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(prows.numpy()[:png],
                                  np.asarray(jrows)[:png])


@pytest.mark.parametrize("exact", [True, False])
def test_probe_budget_overflow_equal_jax(exact):
    """One probe round: exact mode flags overflow in both engines; the
    partial (non-exact) mode singles out unresolved rows identically."""
    cap = 256
    keys = [np.arange(cap, dtype=np.int64) * 7919]
    nulls = [np.zeros(cap, bool)]
    valid = np.ones(cap, bool)
    (jg, _jr, jng, jov), (pg, _pr, png, pov) = _both_gids(
        keys, nulls, valid, rounds=1, exact=exact)
    assert bool(pov) == bool(jov) == exact
    if not exact:
        assert int(png) == int(jng)
        np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))


def test_global_aggregation_is_one_group():
    cap = 32
    valid = np.arange(cap) < 20
    jg, jrows, jng, _ = jht.hash_group_ids((), jnp.asarray(valid))
    pg, prows, png, _ = pht.hash_group_ids([], torch.from_numpy(valid))
    assert int(png) == int(jng) == 1
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))


@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("exact", [True, False])
def test_probe_budget_near_full_table_equal_jax(rounds, exact):
    """A near-full table (every row its own key, load factor 1/2) under a
    budget of one or two rounds, where rows overflow: the gids, the
    group rows, the group count and the overflow flag equal the JAX
    engine's in both modes — in the partial mode the unresolved rows
    single out identically — and both results are device scalars."""
    rng = np.random.default_rng(100 * rounds + exact)
    cap = 4096
    keys = [rng.permutation(cap).astype(np.int64) * 1_000_003 - 7,
            rng.integers(0, 3, cap).astype(np.int64)]
    nulls = [np.zeros(cap, bool), rng.random(cap) < 0.1]
    valid = np.arange(cap) < cap - 5
    (jg, jrows, jng, jov), (pg, prows, png, pov) = _both_gids(
        keys, nulls, valid, rounds=rounds, exact=exact)
    assert pov.shape == png.shape == ()
    assert pov.dtype == torch.bool and png.dtype == torch.int32
    assert bool(pov) == bool(jov)
    assert bool(jov) == exact   # the budget is too small for this page
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
    assert int(png) == int(jng)
    np.testing.assert_array_equal(prows.numpy()[:int(png)],
                                  np.asarray(jrows)[:int(jng)])


def test_splitmix_bits_equal_jax():
    rng = np.random.default_rng(3)
    x = rng.integers(-2 ** 63, 2 ** 63 - 1, 64, dtype=np.int64)
    want = np.asarray(jht.splitmix64(jnp.asarray(x.view(np.uint64))))
    got = pkernels.splitmix64(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), want)


@pytest.mark.parametrize("with_nulls", [False, True])
def test_hash_segment_reduce_equal_jax(with_nulls):
    rng = np.random.default_rng(11)
    cap, n = 512, 480
    keys, nulls, valid = _keys(rng, cap, n, 25, with_nulls)
    (jg, jrows, jng, _), (pg, prows, png, _) = _both_gids(keys, nulls, valid)
    states = [rng.integers(-2 ** 40, 2 ** 40, cap).astype(np.int64),
              valid.astype(np.int64),
              rng.integers(-1000, 1000, cap).astype(np.int64),
              rng.integers(-1000, 1000, cap).astype(np.int64)]
    kinds = ("sum", "sum", "min", "max")
    j = jht.hash_segment_reduce(
        jg, jrows, jng, tuple(jnp.asarray(k) for k in keys),
        tuple(jnp.asarray(nl) for nl in nulls),
        tuple(jnp.asarray(s) for s in states), kinds)
    p = pht.hash_segment_reduce(
        pg, prows, png, tuple(torch.from_numpy(k) for k in keys),
        tuple(torch.from_numpy(nl) for nl in nulls),
        tuple(torch.from_numpy(s) for s in states), kinds)
    j_keys, j_knulls, j_states, j_valid = j
    p_keys, p_knulls, p_states, p_valid = p
    live = np.asarray(j_valid)
    np.testing.assert_array_equal(p_valid.numpy(), live)
    for a, b in zip(p_keys + p_knulls + p_states,
                    j_keys + j_knulls + j_states):
        np.testing.assert_array_equal(a.numpy()[live], np.asarray(b)[live])
