"""TPC-DS at ``micro``: the torch engine against the JAX engine (3 of 3).

See ``test_torch_tpcds.py``: each query's rows must equal the JAX
engine's, in the same order.
"""

import pytest

from test_torch_tpcds import QUERIES, check_query, tpcds_runners


@pytest.fixture(scope="module")
def runners():
    return tpcds_runners()


@pytest.mark.parametrize("qid", QUERIES[3])
def test_tpcds_query_equals_jax(runners, qid):
    check_query(runners, qid)
