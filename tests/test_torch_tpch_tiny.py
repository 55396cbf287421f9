"""TPC-H at ``tiny``: the torch engine against the JAX engine.

Every TPC-H query that returns rows at ``tiny`` (q18 returns none there
and q19 is held at ``micro`` only: at ``tiny`` the two engines together
take minutes on it), run through both engines over the same generated
data; rows equal and in the same order (``_same_rows``).
"""

import pytest

from test_torch_tpch_q1 import _runners, _same_rows
from trino_tpu.resources.tpch_queries import TPCH_QUERIES

TINY = sorted(set(TPCH_QUERIES) - {18, 19})


@pytest.fixture(scope="module")
def runners():
    return _runners("tiny")


@pytest.mark.parametrize("qid", TINY)
def test_tpch_query_at_tiny_equals_jax(runners, qid):
    jr, pr = runners
    want = jr.execute(TPCH_QUERIES[qid]).rows
    got = pr.execute(TPCH_QUERIES[qid]).rows
    assert len(want) > 0
    _same_rows(got, want)
