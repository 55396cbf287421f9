"""The frozen generator with seed 0 reproduces the port's TPC-H
generator, and another seed gives another database of the same shape;
each schema's pages cover its rows."""

import os

import numpy as np
import pytest

from sqlbench import tpchgen
from sqlbench.tests.conftest import ROOT, tpcds_config

COLUMNS = {
    "lineitem": ["l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
                 "l_quantity", "l_extendedprice", "l_discount", "l_tax",
                 "l_returnflag", "l_linestatus", "l_shipdate",
                 "l_commitdate", "l_receiptdate", "l_shipinstruct",
                 "l_shipmode", "l_comment"],
    "orders": ["o_orderkey", "o_custkey", "o_orderstatus", "o_totalprice",
               "o_orderdate", "o_orderpriority", "o_clerk",
               "o_shippriority", "o_comment"],
    "customer": ["c_custkey", "c_name", "c_address", "c_nationkey",
                 "c_phone", "c_acctbal", "c_mktsegment", "c_comment"],
    "part": ["p_partkey", "p_name", "p_mfgr", "p_brand", "p_type", "p_size",
             "p_container", "p_retailprice", "p_comment"],
    "partsupp": ["ps_partkey", "ps_suppkey", "ps_availqty",
                 "ps_supplycost", "ps_comment"],
    "supplier": ["s_suppkey", "s_name", "s_address", "s_nationkey",
                 "s_phone", "s_acctbal", "s_comment"],
    "nation": ["n_nationkey", "n_name", "n_regionkey", "n_comment"],
    "region": ["r_regionkey", "r_name", "r_comment"],
}


def _decoded(v):
    if isinstance(v, tuple):
        codes, pool = v
        return [pool[c] for c in codes]
    return list(np.asarray(v))


def _port_table(name, sf):
    from trino_tpu_torch.block import Page
    from trino_tpu_torch.connectors.tpch import (TpchConnector, _SCHEMAS,
                                                 _counts)

    conn = TpchConnector(page_rows=1 << 20)
    n = _counts(_SCHEMAS["micro"])["orders"] if name == "lineitem" \
        else conn.table(name).row_count(sf)
    page = conn.table(name).generate(sf, 0, n, COLUMNS[name])
    return {c: Page([b], b.data.shape[0]).blocks[0].to_pylist()
            for c, b in zip(COLUMNS[name], page.blocks)}


@pytest.mark.parametrize("table", sorted(COLUMNS))
def test_seed_zero_is_the_ports_generator(table):
    sf = 0.001
    ours = tpchgen.generate(table, sf, COLUMNS[table], 0)
    port = _port_table(table, sf)
    for c in COLUMNS[table]:
        got = _decoded(ours[c])
        want = port[c]
        if isinstance(want[0], str):
            assert got == want, c
        else:
            np.testing.assert_array_equal(
                np.asarray(got, dtype=np.int64),
                np.asarray([_raw(v) for v in want], dtype=np.int64), c)


def _raw(v):
    """A value of the port's to_pylist as its storage integer."""
    import datetime
    from decimal import Decimal

    if isinstance(v, Decimal):
        return int(v.scaleb(2))
    if isinstance(v, datetime.date):
        return (v - datetime.date(1970, 1, 1)).days
    return int(v)


def test_other_seed_other_database_same_shape():
    a = tpchgen.generate("lineitem", 0.001, ["l_quantity", "l_shipdate"], 0)
    b = tpchgen.generate("lineitem", 0.001, ["l_quantity", "l_shipdate"],
                         2 ** 31 + 5)
    assert not np.array_equal(a["l_quantity"][:100], b["l_quantity"][:100])
    for v in (a, b):
        assert v["l_quantity"].min() >= 100 and \
            v["l_quantity"].max() <= 5000
    o = tpchgen.generate("orders", 0.001, ["o_orderkey"], 2 ** 31 + 5)
    assert len(o["o_orderkey"]) == tpchgen.counts(0.001)["orders"]


def test_split_pages_cover_every_row_once():
    pages = tpchgen.split_pages(150_000, 8, 65536)
    rows = np.concatenate([np.arange(a, b) for a, b in pages])
    np.testing.assert_array_equal(rows, np.arange(150_000))
    assert max(b - a for a, b in pages) <= 65536


@pytest.mark.parametrize("schema", ["tpch", "tpcds"])
def test_page_bounds_cover_every_row_once(schema):
    """Through ``data.generate``: each table's pages, in order, cover
    its generated rows once, none longer than ``page_rows`` source rows
    (a lineitem page holds the lines of at most that many orders)."""
    from sqlbench import data, workload

    if schema == "tpch":
        cfg = workload.read_json(os.path.join(
            ROOT, "sqlbench", "configs", "tpch_sf1_cluster4.json"))
        cfg = dict(cfg, page_rows=1000)
    else:
        cfg = tpcds_config(page_rows=1000)
    db = data.generate(cfg, 2 ** 31 + 5 if schema == "tpch" else 0, 0.001)
    gen = data.generator(cfg)
    assert list(db.tables) == list(gen.TABLES)
    for name, table in db.tables.items():
        first = table.arrays[table.columns[0][0]]
        n = len(first[0] if isinstance(first, tuple) else first)
        rows = np.concatenate([np.arange(a, b) for a, b in table.pages])
        np.testing.assert_array_equal(rows, np.arange(n), name)
        assert all(b > a for a, b in table.pages), name
        if name != "lineitem":
            assert max(b - a for a, b in table.pages) <= 1000, name
    if schema == "tpch":
        assert len(db.tables["lineitem"].pages) == \
            len(db.tables["orders"].pages)
