"""The TPC-DS set of tests/test_distributed.py (q3, q7, q19, q42, q55,
q64, q72) through the torch engine's DistributedQueryRunner against the
JAX engine's, micro, three workers. The JAX runner takes the host
exchange, as in tests/test_distributed.py (its device exchange would
compile one XLA program per join boundary); the port's takes the device
exchange, so its hash boundaries run the exchange program."""

import pytest

from test_torch_distributed import check, make_pair
from test_torch_distributed import _fresh_stores, one_device  # noqa: F401
from trino_tpu.connectors.tpcds import TpcdsConnector as JTpcds
from trino_tpu.resources.tpcds_queries import TPCDS_QUERIES
from trino_tpu_torch.connectors.tpcds import TpcdsConnector
from trino_tpu_torch.parallel.device_exchange import DeviceExchange


@pytest.fixture(scope="module")
def tpcds_pair(one_device):  # noqa: F811
    jd, pd = make_pair(catalog="tpcds",
                       conns=({"tpcds": JTpcds(page_rows=4096)},
                              {"tpcds": TpcdsConnector(page_rows=4096)}))
    jd.session.properties["device_exchange"] = False
    return jd, pd


@pytest.mark.parametrize("qid", (3, 7, 19, 42, 55, 64, 72))
def test_tpcds_distributed_equals_jax(tpcds_pair, qid):
    before = DeviceExchange.total_collectives
    check(tpcds_pair, TPCDS_QUERIES[qid])
    assert DeviceExchange.total_collectives > before
