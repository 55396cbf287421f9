"""The 22 TPC-H queries through the torch engine's
``DistributedQueryRunner(devices=["cpu"] * 3)`` against the JAX
engine's runner on its 8 virtual CPU devices (tests/conftest.py).

Both run three workers at micro with the fixtures of
tests/test_distributed.py, so the JAX exchange takes three of its
devices and the port's holds three CPU slabs: each hash boundary is a
d = 3 all-to-all in both engines. Rows compare as in
``test_torch_distributed_tpch.py`` (sorted where there is no ORDER BY,
DOUBLE at 9 significant digits, integers and decimals exactly; q2, q15,
q17 and q20 may pick other rows among ties, so they compare row counts
and the first column's multiset), and every stage boundary's exchange
stats equal the JAX engine's. Both engines' sizing histories, history
stores and profilers are cleared around every case.
"""

import pytest

from test_torch_distributed import _fresh_stores, make_pair, norm  # noqa: F401
from test_torch_mesh_exchange import _stage_exchanges
from trino_tpu.resources.tpch_queries import TPCH_QUERIES
from trino_tpu.sql.parser import parse_statement as j_parse
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.parallel import DistributedQueryRunner
from trino_tpu_torch.sql.analyzer import Session
from trino_tpu_torch.sql.parser import parse_statement

TIES = (2, 15, 17, 20)


@pytest.fixture(scope="module")
def mesh_pair():
    """(JAX runner on its 8 devices, port runner on three CPU slabs)."""
    jd, _ = make_pair()
    s = Session(catalog="tpch", schema="micro")
    pd = DistributedQueryRunner({"tpch": TpchConnector(page_rows=4096)}, s,
                                n_workers=3, desired_splits=8,
                                broadcast_threshold=300.0,
                                devices=["cpu"] * 3)
    return jd, pd


@pytest.mark.parametrize("qid", sorted(TPCH_QUERIES))
def test_tpch_mesh_equals_jax(mesh_pair, qid):
    jd, pd = mesh_pair
    sql = TPCH_QUERIES[qid]
    jres = jd._execute_query(j_parse(sql), collect_stats=True)
    pres = pd._execute_query(parse_statement(sql), collect_stats=True)
    jrows = [norm(r) for r in jres.rows]
    prows = [norm(r) for r in pres.rows]
    if qid in TIES:
        assert len(prows) == len(jrows)
        assert sorted(r[0] for r in prows) == sorted(r[0] for r in jrows)
        return
    if "order by" not in sql.lower():
        jrows, prows = sorted(jrows), sorted(prows)
    assert prows == jrows
    assert _stage_exchanges(pres) == _stage_exchanges(jres)
    assert all(ex.get("kind") != "device" or len(ex["lane_rows"]) == 3
               for ex in _stage_exchanges(pres) if ex)
