"""All 22 TPC-H queries: the torch engine against the JAX engine.

The same SQL runs through ``trino_tpu.runner.LocalQueryRunner`` and
``trino_tpu_torch.LocalQueryRunner(device="cpu")`` over the same
generated data at ``micro``; every query's rows must come out equal and
in the same order (``_same_rows``: decimals exactly, DOUBLE within a
relative 1e-12). q18's HAVING threshold (300) selects no order at
``micro``, so a variant with a lower threshold holds its semijoin and
large-group aggregation to rows. ``test_torch_tpch_tiny.py`` repeats the
queries that return rows at ``tiny``.
"""

import pytest

from test_torch_tpch_q1 import _runners, _same_rows
from trino_tpu.resources.tpch_queries import TPCH_QUERIES

#: q18 with HAVING sum(l_quantity) > 150: rows at micro
Q18_LOW = TPCH_QUERIES[18].replace("> 300", "> 150")


@pytest.fixture(scope="module")
def runners():
    return _runners("micro")


@pytest.mark.parametrize("qid", sorted(TPCH_QUERIES))
def test_tpch_query_equals_jax(runners, qid):
    jr, pr = runners
    want = jr.execute(TPCH_QUERIES[qid])
    got = pr.execute(TPCH_QUERIES[qid])
    assert got.column_names == want.column_names
    assert [t.name for t in got.types] == [t.name for t in want.types]
    _same_rows(got.rows, want.rows)


def test_q18_low_threshold_returns_rows_equal_jax(runners):
    jr, pr = runners
    assert Q18_LOW != TPCH_QUERIES[18]
    want = jr.execute(Q18_LOW).rows
    got = pr.execute(Q18_LOW).rows
    assert len(want) > 0
    _same_rows(got, want)
