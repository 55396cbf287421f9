"""The 22 TPC-H queries through the torch engine's DistributedQueryRunner
against the JAX engine's (micro, three workers, the fixtures of
tests/test_distributed.py; see ``test_torch_distributed.py``), and each
query's fragment plan: ``fragments_str`` equal to the JAX engine's.

Rows compare as in tests/test_distributed.py: sorted where there is no
ORDER BY, DOUBLE at 9 significant digits, integers and decimals exactly;
q2, q15, q17 and q20 may pick other rows among ties, so they compare
row counts and the multiset of first-column values.
"""

import pytest

from test_torch_distributed import check, norm, _fresh_stores  # noqa: F401
from test_torch_distributed import one_device, pair  # noqa: F401
from trino_tpu.planner.fragmenter import fragments_str as j_fragments_str
from trino_tpu.resources.tpch_queries import TPCH_QUERIES
from trino_tpu_torch.planner.fragmenter import fragments_str

TIES = (2, 15, 17, 20)


@pytest.mark.parametrize("qid", sorted(TPCH_QUERIES))
def test_tpch_distributed_equals_jax(pair, qid):  # noqa: F811
    jd, pd = pair
    jfr = j_fragments_str(jd.create_fragments(TPCH_QUERIES[qid]))
    pfr = fragments_str(pd.create_fragments(TPCH_QUERIES[qid]))
    assert pfr == jfr
    if qid in TIES:
        jrows = jd.execute(TPCH_QUERIES[qid]).rows
        prows = pd.execute(TPCH_QUERIES[qid]).rows
        assert len(prows) == len(jrows)
        assert sorted(norm((r[0],)) for r in prows) == \
            sorted(norm((r[0],)) for r in jrows)
        return
    check(pair, TPCH_QUERIES[qid])
