"""The torch engine's many-column segment reduce against the JAX engine.

``trino_tpu_torch.ops.kernels.segment_reduce_columns`` reduces every state
column of a page in one call, optionally reading the columns through the
permutation that sorted the gids. It replaces the JAX engine's per-column
loop of ``trino_tpu.ops.pallas_kernels.segment_reduce`` calls over the
sorted states (``trino_tpu/ops/hashtable.py`` ``_hash_segment_reduce_impl``).
On the CPU it runs its plain PyTorch version; the JAX side runs the Pallas
kernel in interpret mode per column, as tests/test_pallas_kernels.py does,
on the column already gathered into gid order. Same numpy-seeded inputs go
to both. Ints and MIN/MAX must match exactly; float SUMs within a relative
1e-12 (float64) or 1e-5 (float32) of the segment's sum of magnitudes, as
in tests/test_torch_segment_reduce.py.

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trino_tpu.ops import pallas_kernels as pk
from trino_tpu_torch.ops import kernels

# the one-column file's inputs, tolerances and interpret-mode fixture
from test_torch_segment_reduce import (RTOL, _sorted_gids, _values,  # noqa: F401
                                       force_interpret)
# the kernel design's edge cases
from test_torch_segment_reduce_plan import EDGE_CASES, edge_gids

torch.set_num_threads(2)

#: (dtype, kind) of each column of the mixed table: more than 32 int64
#: SUM columns (past 32 columns the kernel's descriptor table goes to the
#: device) and two of each other pair
MIXED = ([("int64", "sum")] * 34 + [("int32", "min"), ("float32", "max"),
                                    ("float64", "sum")] * 2)


def _hash_gids(rng, n, groups):
    """Gids as the hash path makes them: dense, in first-occurrence order,
    interleaved over the page; about a tenth of the rows invalid (the dump
    segment n)."""
    raw = rng.integers(0, groups, n)
    invalid = rng.random(n) < 0.1
    invalid[0] = False
    live = raw[~invalid]
    _, first = np.unique(live, return_index=True)
    rank = np.full(groups, -1, dtype=np.int64)
    rank[live[np.sort(first)]] = np.arange(len(first))
    return np.where(invalid, n, rank[raw]).astype(np.int32)


def _assert_column(got, want, col, gid, dtype, kind, live):
    got, want = got[:live], want[:live]
    if dtype in RTOL and kind == "sum":
        scale = np.zeros(gid.max() + 1)
        np.add.at(scale, gid, np.abs(col.astype(np.float64)))
        assert np.all(np.abs(got.astype(np.float64) - want)
                      <= RTOL[dtype] * scale[:live])
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_order", [False, True])
@pytest.mark.parametrize("n", [7, 1000, 4096])
def test_columns_match_pallas_kernel(n, with_order, force_interpret):
    rng = np.random.default_rng(7 + n + with_order)
    if with_order:
        gid = _hash_gids(rng, n, max(2, n // 7))
        order = np.argsort(gid, kind="stable")
    else:
        gid = _sorted_gids(rng, n, max(2, n // 7), min(n // 5, 100))
        order = np.arange(n)
    r_gid = gid[order]
    cols = [_values(rng, n, dtype) for dtype, _ in MIXED]
    kinds = [kind for _, kind in MIXED]
    got = kernels.segment_reduce_columns(
        [torch.from_numpy(c) for c in cols], torch.from_numpy(r_gid), n + 1,
        kinds, order=torch.from_numpy(order) if with_order else None)
    assert len(got) == len(MIXED)
    live = int(r_gid[r_gid < n].max()) + 1
    for (dtype, kind), col, out in zip(MIXED, cols, got):
        assert out.dtype == getattr(torch, dtype)
        assert out.shape == (n + 1,)
        want = np.asarray(pk.segment_reduce(
            jnp.asarray(col[order]), jnp.asarray(r_gid), num_segments=n + 1,
            kind=kind))
        _assert_column(out.numpy(), want, col[order], r_gid, dtype, kind,
                       live)


@pytest.mark.parametrize("with_order", [False, True])
def test_columns_empty_segments_and_dump_tail(with_order):
    """Segments no row names hold the identity, and gids at or past
    num_segments (the dump tail) are dropped, as in the JAX engine's
    plain ``jax.ops.segment_*`` path."""
    n, ns = 12, 9
    gid = np.array([0, 0, 2, 2, 2, 5, 5, 8, 9, 9, 9, 9], dtype=np.int32)
    rng = np.random.default_rng(3)
    order = rng.permutation(n) if with_order else np.arange(n)
    cols = [_values(rng, n, dtype) for dtype, _ in MIXED]
    kinds = [kind for _, kind in MIXED]
    got = kernels.segment_reduce_columns(
        [torch.from_numpy(c) for c in cols], torch.from_numpy(gid), ns,
        kinds, order=torch.from_numpy(order) if with_order else None)
    for (dtype, kind), col, out in zip(MIXED, cols, got):
        want = np.asarray(pk.segment_reduce(
            jnp.asarray(col[order]), jnp.asarray(gid), num_segments=ns,
            kind=kind, mode=""))
        ident = kernels.segment_identity(kind, getattr(torch, dtype))
        for empty in (1, 3, 4, 6, 7):
            assert out[empty].item() == ident
        _assert_column(out.numpy(), want, col[order], gid, dtype, kind, ns)


#: one column of each (dtype, kind) pair the edge cases hold
EDGE_COLUMNS = [("int64", "sum"), ("int32", "min"), ("float32", "max"),
                ("float64", "sum")]


@pytest.mark.parametrize("with_order", [False, True])
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_columns_edge_cases_match_jax(case, with_order, force_interpret):
    """Long gaps (in the middle, at the tail, across tile edges), a
    segment over several tiles, one row, a tile and a row, and gids past
    num_segments: the plain version against the JAX engine, through its
    Pallas kernel in interpret mode where the gids step by at most 1, else
    through its plain ``jax.ops.segment_*`` path."""
    gid, ns = edge_gids(case)
    n = len(gid)
    rng = np.random.default_rng(len(case) + with_order)
    order = rng.permutation(n) if with_order else np.arange(n)
    cols = [_values(rng, n, dtype) for dtype, _ in EDGE_COLUMNS]
    kinds = [kind for _, kind in EDGE_COLUMNS]
    got = kernels.segment_reduce_columns(
        [torch.from_numpy(c) for c in cols], torch.from_numpy(gid), ns,
        kinds, order=torch.from_numpy(order) if with_order else None)
    mode = None if EDGE_CASES[case] else ""
    for (dtype, kind), col, out in zip(EDGE_COLUMNS, cols, got):
        assert out.shape == (ns,)
        want = np.asarray(pk.segment_reduce(
            jnp.asarray(col[order]), jnp.asarray(gid), num_segments=ns,
            kind=kind, mode=mode))
        if dtype in RTOL and kind == "sum":
            keep = gid < ns
            scale = np.zeros(ns)
            np.add.at(scale, gid[keep],
                      np.abs(col[order][keep].astype(np.float64)))
            assert np.all(np.abs(out.numpy().astype(np.float64) - want)
                          <= RTOL[dtype] * scale)
        else:
            np.testing.assert_array_equal(out.numpy(), want)


def test_no_columns_give_no_outputs():
    gid = torch.zeros(4, dtype=torch.int32)
    assert kernels.segment_reduce_columns([], gid, 1, []) == []


def test_columns_cpu_path_never_counts_a_launch():
    before = kernels.segment_reduce.launches
    kernels.segment_reduce_columns(
        [torch.ones(8, dtype=torch.int64), torch.ones(8)],
        torch.zeros(8, dtype=torch.int32), 1, ["sum", "max"],
        order=torch.arange(8))
    assert kernels.segment_reduce.launches == before


def test_columns_reject_bad_kinds():
    cols = [torch.ones(2), torch.ones(2)]
    gid = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown kind"):
        kernels.segment_reduce_columns(cols, gid, 1, ["sum", "avg"])
    with pytest.raises(ValueError, match="2 columns, 1 kinds"):
        kernels.segment_reduce_columns(cols, gid, 1, ["sum"])
