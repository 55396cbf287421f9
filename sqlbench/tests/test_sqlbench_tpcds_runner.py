"""A second schema through the harness: a micro TPC-DS database, found
by the configuration's ``schema`` (``porttpcdsgen``, the port's rows,
nulls among them), paged and loaded into the port's memory connector by
``data`` and served by the harness's own runner (four worker tasks,
CPU), answers TPC-DS queries as the port's TPC-DS connector does: the
same rows, compared as sorted multisets."""

import pytest

from sqlbench.tests.conftest import tpcds_config


def _rows(result):
    return sorted(tuple("\0" if v is None else str(v) for v in row)
                  for row in result.rows)


@pytest.fixture(scope="module")
def runners():
    from sqlbench import data, system
    from trino_tpu_torch.connectors.tpcds import TpcdsConnector
    from trino_tpu_torch.parallel import DistributedQueryRunner
    from trino_tpu_torch.sql.analyzer import Session

    cfg = tpcds_config()
    ours = system.make_runner(cfg, data.generate(cfg, 0), "cpu")
    port = DistributedQueryRunner(
        {"tpcds": TpcdsConnector(page_rows=cfg["page_rows"])},
        Session(catalog="tpcds", schema="micro"),
        n_workers=cfg["runner"]["n_workers"],
        desired_splits=cfg["desired_splits"], device="cpu")
    return ours, port


@pytest.mark.parametrize("qid", [3, 72])
def test_tpcds_query_answers_as_the_ports_connector(runners, qid):
    from trino_tpu_torch.resources.tpcds_queries import TPCDS_QUERIES

    ours, port = runners
    got = _rows(ours.execute(TPCDS_QUERIES[qid]))
    assert got, f"q{qid} selects no rows at micro"
    assert got == _rows(port.execute(TPCDS_QUERIES[qid]))


def test_nulls_survive_the_load(runners):
    """A masked array's mask reaches the memory table as its nulls."""
    ours, port = runners
    sql = "select count(*), count(ss_promo_sk) from store_sales"
    got = _rows(ours.execute(sql))
    assert got == _rows(port.execute(sql))
    total, promo = (int(v) for v in got[0])
    assert 0 < promo < total
