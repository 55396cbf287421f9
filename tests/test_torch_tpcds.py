"""TPC-DS at ``micro``: the torch engine against the JAX engine (1 of 3).

The torch engine's TPC-DS connector is a copy of the JAX engine's host
generator; its pages must equal the JAX connector's bit for bit. Each of
the repo's 32 TPC-DS queries (``resources/tpcds_queries.py``, q64 and
q72 included) runs through both engines over that data and the rows must
come out equal and in the same order (``_same_rows``). The queries are
split over three files so that none runs long:
``test_torch_tpcds.py``, ``test_torch_tpcds_2.py`` and
``test_torch_tpcds_3.py``.
"""

import numpy as np
import pytest
import torch

import trino_tpu_torch as P
from test_torch_tpch_q1 import _same_rows
from trino_tpu.connectors.tpcds import TpcdsConnector as JConnector
from trino_tpu.resources.tpcds_queries import TPCDS_QUERIES
from trino_tpu.runner import LocalQueryRunner as JRunner
from trino_tpu.sql.analyzer import Session as JSession
from trino_tpu_torch.connectors.tpcds import TpcdsConnector as PConnector
from trino_tpu_torch.resources.tpcds_queries import \
    TPCDS_QUERIES as P_TPCDS_QUERIES
from trino_tpu_torch.sql.analyzer import Session as PSession

torch.set_num_threads(2)

#: the queries of each file, balanced by the JAX engine's run time
QUERIES = {1: [7, 21, 25, 29, 37, 40, 43, 48, 55, 84, 96],
           2: [3, 13, 26, 46, 50, 52, 62, 64, 68, 82, 92],
           3: [15, 19, 32, 42, 72, 73, 79, 88, 91, 99]}


def tpcds_runners():
    jr = JRunner({"tpcds": JConnector(page_rows=8192)},
                 JSession(catalog="tpcds", schema="micro"))
    pr = P.LocalQueryRunner({"tpcds": PConnector(page_rows=8192)},
                            PSession(catalog="tpcds", schema="micro"),
                            device="cpu")
    return jr, pr


def check_query(runners, qid):
    jr, pr = runners
    want = jr.execute(TPCDS_QUERIES[qid])
    got = pr.execute(TPCDS_QUERIES[qid])
    assert got.column_names == want.column_names
    assert [t.name for t in got.types] == [t.name for t in want.types]
    _same_rows(got.rows, want.rows)


@pytest.fixture(scope="module")
def runners():
    return tpcds_runners()


def test_files_cover_every_query():
    assert sorted(q for qs in QUERIES.values() for q in qs) == \
        sorted(TPCDS_QUERIES)
    assert P_TPCDS_QUERIES == TPCDS_QUERIES


@pytest.mark.parametrize("table", ["store_sales", "date_dim", "item",
                                   "customer", "inventory"])
def test_connector_pages_equal_jax(table):
    jc, pc = JConnector(page_rows=2048), PConnector(page_rows=2048)
    jh = jc.metadata().get_table_handle("micro", table)
    ph = pc.metadata().get_table_handle("micro", table)
    jcols = jc.metadata().get_columns(jh)
    pcols = pc.metadata().get_columns(ph)
    assert [(c.name, c.type.name) for c in pcols] == \
        [(c.name, c.type.name) for c in jcols]
    for js, ps in zip(jc.split_manager().get_splits(jh, 2),
                      pc.split_manager().get_splits(ph, 2)):
        jsrc, psrc = jc.page_source(js, jcols), pc.page_source(ps, pcols)
        while True:
            jp, pp = jsrc.get_next_page(), psrc.get_next_page()
            assert (jp is None) == (pp is None)
            if jp is None:
                break
            for jb, pb in zip(jp.blocks, pp.blocks):
                np.testing.assert_array_equal(pb.data, jb.data)
                np.testing.assert_array_equal(pb.nulls_array(),
                                              jb.nulls_array())
                if jb.dictionary is not None:
                    assert pb.dictionary.values == jb.dictionary.values


@pytest.mark.parametrize("qid", QUERIES[1])
def test_tpcds_query_equals_jax(runners, qid):
    check_query(runners, qid)
