"""TPC-H q1 end to end: the torch engine against the JAX engine.

The same SQL runs through ``trino_tpu.runner.LocalQueryRunner`` and
``trino_tpu_torch.LocalQueryRunner(device="cpu")`` over the same
generated data; rows must be equal, decimals exactly (see _same_rows). Also: the two tpch
connectors generate the same pages bit for bit, ORDER BY keeps the JAX
engine's NULL / NaN / -0.0 order, importing the torch engine loads
neither jax nor trino_tpu, and a runner asked for CUDA without a card
raises instead of running on the CPU.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import trino_tpu_torch as P
from trino_tpu.connectors.tpch import TpchConnector as JConnector
from trino_tpu.resources.tpch_queries import TPCH_QUERIES
from trino_tpu.runner import LocalQueryRunner as JRunner
from trino_tpu.sql.analyzer import Session as JSession
from trino_tpu_torch.connectors.tpch import TpchConnector as PConnector
from trino_tpu_torch.exec.memory import (MemoryExceededError,
                                         default_node_memory_bytes)
from trino_tpu_torch.ops import kernels
from trino_tpu_torch.sql.analyzer import Session as PSession
from trino_tpu_torch.types import TrinoError

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _runners(schema, props=None, **conn):
    jr = JRunner({"tpch": JConnector(**conn)},
                 JSession(catalog="tpch", schema=schema,
                          properties=dict(props or {})))
    pr = P.LocalQueryRunner({"tpch": PConnector(**conn)},
                            PSession(catalog="tpch", schema=schema,
                                     properties=dict(props or {})),
                            device="cpu")
    return jr, pr


def _same_rows(a, b):
    """Equal rows: every value of the same type and equal, decimals
    exactly; DOUBLE within a relative 1e-12 (a decimal scaled to double
    may round once differently: XLA multiplies by a reciprocal where
    torch divides), NaN equal to NaN."""
    assert len(a) == len(b), (a, b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            assert type(x) is type(y), (ra, rb)
            if isinstance(x, float) and math.isnan(x):
                assert math.isnan(y), (ra, rb)
            elif isinstance(x, float):
                assert math.isclose(x, y, rel_tol=1e-12), (ra, rb)
            else:
                assert x == y, (ra, rb)


@pytest.mark.parametrize("schema", ["micro", "tiny"])
@pytest.mark.parametrize("hash_grouping", [True, False])
def test_q1_rows_equal_jax(schema, hash_grouping):
    props = {"hash_grouping_enabled": hash_grouping}
    jr, pr = _runners(schema, props)
    want = jr.execute(TPCH_QUERIES[1])
    got = pr.execute(TPCH_QUERIES[1])
    assert got.column_names == want.column_names
    assert [t.name for t in got.types] == [t.name for t in want.types]
    assert len(got.rows) == 4
    _same_rows(got.rows, want.rows)
    paths = [op["grouping_paths"] for op in got.stats["operators"]
             if op["name"] == "HashAggregationOperator"]
    assert list(paths[0]) == (["hash"] if hash_grouping else ["sort"])


def test_q1_multi_page_merge_equal_jax():
    """Small connector pages: many partials, then the merge re-groups
    them (the path SF1 takes with 24 pages)."""
    jr, pr = _runners("tiny", page_rows=4096)
    want = jr.execute(TPCH_QUERIES[1]).rows
    got = pr.execute(TPCH_QUERIES[1])
    _same_rows(got.rows, want)
    agg = [op for op in got.stats["operators"]
           if op["name"] == "HashAggregationOperator"][0]
    assert sum(agg["grouping_paths"].values()) > 2


@pytest.mark.parametrize("sql", [
    # every aggregate of the state plan, string and date keys, nulls
    "select l_returnflag, l_shipmode, min(l_shipdate), max(l_shipdate), "
    "min(l_shipinstruct), max(l_comment), count(l_tax), sum(l_linenumber), "
    "avg(l_linenumber), stddev(l_quantity), variance(l_discount), "
    "bool_or(l_quantity > 40), count_if(l_tax = 0) from lineitem "
    "group by l_returnflag, l_shipmode order by l_shipmode, l_returnflag",
    # global aggregation, and over zero rows
    "select count(*), sum(l_quantity), avg(l_extendedprice) from lineitem",
    "select count(*), sum(l_quantity), min(l_shipdate) from lineitem "
    "where l_quantity < 0",
    "select l_linestatus, count(*) from lineitem where l_quantity < 0 "
    "group by l_linestatus",
    # ORDER BY on several keys, descending, over a projection
    "select l_orderkey, l_linenumber, l_quantity * 2 from lineitem "
    "where l_orderkey < 40 order by l_quantity desc, l_orderkey, "
    "l_linenumber desc",
    # double grouping keys take the sort path
    "select o_totalprice * 0.5e0 as h, count(*) from orders "
    "where o_orderkey < 200 group by 1 order by h desc",
])
def test_other_queries_equal_jax(sql):
    jr, pr = _runners("micro")
    _same_rows(pr.execute(sql).rows, jr.execute(sql).rows)


@pytest.mark.parametrize("order", ["x", "x desc", "x nulls first",
                                   "x desc nulls last"])
def test_order_by_null_nan_negative_zero_like_jax(order):
    sql = ("select x, y from (values (cast('NaN' as double), 1), "
           "(cast(null as double), 2), (cast('-0.0' as double), 3), "
           "(cast('0.0' as double), 4), (1.5e0, 5), "
           "(cast('-Infinity' as double), 6), (cast('NaN' as double), 7), "
           "(cast('-0.0' as double), 8), (cast(null as double), 9)) "
           f"as t (x, y) order by {order}")
    jr, pr = _runners("micro")
    want = jr.execute(sql).rows
    got = pr.execute(sql).rows
    _same_rows(got, want)
    # -0.0 and +0.0 keep their own signs through the sort
    assert [math.copysign(1, r[0]) for r in got if r[0] == 0.0] == \
        [math.copysign(1, r[0]) for r in want if r[0] == 0.0]


@pytest.mark.parametrize("table", ["lineitem", "orders", "nation"])
def test_connector_pages_equal_jax(table):
    jc, pc = JConnector(page_rows=2048), PConnector(page_rows=2048)
    jh = jc.metadata().get_table_handle("micro", table)
    ph = pc.metadata().get_table_handle("micro", table)
    jcols = jc.metadata().get_columns(jh)
    pcols = pc.metadata().get_columns(ph)
    assert [(c.name, c.type.name) for c in pcols] == \
        [(c.name, c.type.name) for c in jcols]
    jsplits = jc.split_manager().get_splits(jh, 3)
    psplits = pc.split_manager().get_splits(ph, 3)
    assert len(jsplits) == len(psplits)
    for js, ps in zip(jsplits, psplits):
        jsrc, psrc = jc.page_source(js, jcols), pc.page_source(ps, pcols)
        while True:
            jp, pp = jsrc.get_next_page(), psrc.get_next_page()
            assert (jp is None) == (pp is None)
            if jp is None:
                break
            assert jp.num_rows == pp.num_rows
            for jb, pb in zip(jp.blocks, pp.blocks):
                np.testing.assert_array_equal(pb.data, jb.data)
                np.testing.assert_array_equal(pb.nulls_array(),
                                              jb.nulls_array())
                if jb.dictionary is not None:
                    assert pb.dictionary.values == jb.dictionary.values


def test_explain_and_set_session_like_jax():
    jr, pr = _runners("micro")
    assert pr.execute("explain " + TPCH_QUERIES[1]).rows[0] == \
        jr.execute("explain " + TPCH_QUERIES[1]).rows[0]
    assert pr.execute("set session hash_grouping_enabled = false").rows \
        == [(True,)]
    res = pr.execute(TPCH_QUERIES[1])
    agg = [op for op in res.stats["operators"]
           if op["name"] == "HashAggregationOperator"][0]
    assert list(agg["grouping_paths"]) == ["sort"]


@pytest.mark.parametrize("sql", [
    "select n_name from nation union all select r_name from region",
    "select n_name, (select max(r_name) from region) from nation",
    "select n_name, rank() over (order by n_name) from nation",
])
def test_unported_plans_raise_not_supported(sql):
    """A union, a scalar subquery and a window raised NOT_SUPPORTED until
    their operators were ported; now their rows equal the JAX engine's
    (the plans still unported are in test_torch_setops.py)."""
    jr, pr = _runners("micro")
    _same_rows(sorted(pr.execute(sql).rows, key=repr),
               sorted(jr.execute(sql).rows, key=repr))


def test_memory_limit_and_spill_are_enforced():
    _, pr = _runners("micro", {"query_max_memory_bytes": 1 << 16})
    with pytest.raises(MemoryExceededError):
        pr.execute(TPCH_QUERIES[1])
    _, pr = _runners("micro", {"spill_enabled": True})
    with pytest.raises(TrinoError) as e:
        pr.execute(TPCH_QUERIES[1])
    assert e.value.code == "NOT_SUPPORTED"
    assert default_node_memory_bytes("cpu", fallback=123) == 123


def test_cpu_run_launches_no_kernel():
    _, pr = _runners("micro")
    before = kernels.segment_reduce.launches
    pr.execute(TPCH_QUERIES[1])
    assert kernels.segment_reduce.launches == before


def test_import_loads_neither_jax_nor_trino_tpu():
    code = ("import sys, trino_tpu_torch, trino_tpu_torch.interop; "
            "import trino_tpu_torch.ops.kernels, trino_tpu_torch.ops.join; "
            "import trino_tpu_torch.ops.matmul_join; "
            "import trino_tpu_torch.exec.dynamic_filter; "
            "import trino_tpu_torch.ops.window, "
            "trino_tpu_torch.ops.grouped_topn, trino_tpu_torch.ops.unnest; "
            "import trino_tpu_torch.connectors.tpcds, "
            "trino_tpu_torch.resources.tpcds_queries; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'trino_tpu' or "
            "m.startswith('trino_tpu.')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_runner_without_device_needs_a_card():
    """The default device is CUDA; without a card the runner raises
    rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.LocalQueryRunner({"tpch": PConnector()},
                           PSession(catalog="tpch", schema="micro"))


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises; it never falls back."""
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernels.os.path, "exists",
                        lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()
    assert not (tmp_path / "build").exists()
