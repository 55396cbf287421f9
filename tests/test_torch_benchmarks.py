"""The torch engine's benchmark builders (``trino_tpu_torch/benchmarks.py``)
against the JAX engine's (``trino_tpu/benchmarks.py``).

The two cases of tests/test_bench_smoke.py that drive the builders: q1
and q18 at micro through the hash and the sort grouping paths give the
same rows, and those rows equal the JAX builders' (decimals exactly,
q1's averages as the engines round them). ``q1_device_step`` on
``q1_example_args("micro")`` equals the JAX step lane for lane (the JAX
step on the CPU runs its plain path, as its own tests run it): the same
hash group ids, group keys and int64 states, exactly, and every group
equals the sort-based ``group_reduce`` of the same page. The
``stage_breakdown`` rollup buckets the same operators as the JAX one.
"""

import numpy as np
import pytest
import torch

from trino_tpu import benchmarks as jb
from trino_tpu.block import Page as JPage
from trino_tpu.connectors.tpch import TpchConnector as JTpch
from trino_tpu_torch import benchmarks as pb
from trino_tpu_torch.block import Page
from trino_tpu_torch.connectors.tpch import TpchConnector


def _drain(sink, page_cls):
    if not sink.pages:
        return []
    return page_cls.concat(sink.pages).to_rows()


@pytest.fixture(scope="module")
def q1_pages():
    return (jb.scan_q1_pages(JTpch(page_rows=4096), "micro", 4),
            pb.scan_q1_pages(TpchConnector(page_rows=4096), "micro", 4))


def test_q1_hash_and_sort_paths_identical(q1_pages):
    jpages, ppages = q1_pages
    conn = TpchConnector(page_rows=4096)
    rows = {}
    for label, hg in (("hash", True), ("sort", False)):
        driver, sink = pb.build_q1_driver(conn, "micro",
                                          source_pages=list(ppages),
                                          hash_grouping=hg, device="cpu")
        driver.run_to_completion()
        rows[label] = sorted(_drain(sink, Page))
    assert rows["hash"] == rows["sort"]
    assert len(rows["hash"]) == 4  # the 4 (returnflag, linestatus) groups
    jdriver, jsink = jb.build_q1_driver(JTpch(page_rows=4096), "micro",
                                        source_pages=list(jpages))
    jdriver.run_to_completion()
    assert rows["hash"] == sorted(_drain(jsink, JPage))


def test_q18_hash_and_sort_paths_identical():
    ppages = pb.scan_q18_pages(TpchConnector(page_rows=4096), "micro", 4)
    rows, agg_groups, stages = {}, {}, {}
    for label, hg in (("hash", True), ("sort", False)):
        driver, sink = pb.build_q18_driver(ppages, hash_grouping=hg,
                                           collect_stats=True, device="cpu")
        driver.run_to_completion()
        rows[label] = sorted(_drain(sink, Page))
        # the rollup reads the row counts left on the device first
        stages[label] = pb.stage_breakdown([driver])
        agg_groups[label] = next(
            st.output_rows for st in driver.stats
            if st.name.startswith("HashAggregation"))
    # the HAVING may filter micro down to nothing — the large-group
    # aggregation itself is the point: both paths must produce the same
    # (large) group count and the same final rows
    assert rows["hash"] == rows["sort"]
    assert agg_groups["hash"] == agg_groups["sort"] > 1000
    jpages = jb.scan_q18_pages(JTpch(page_rows=4096), "micro", 4)
    jdriver, jsink = jb.build_q18_driver(jpages, collect_stats=True)
    jdriver.run_to_completion()
    assert rows["hash"] == sorted(_drain(jsink, JPage))
    jstages = jb.stage_breakdown([jdriver])
    assert agg_groups["hash"] == next(
        st.output_rows for st in jdriver.stats
        if st.name.startswith("HashAggregation"))
    for label in stages:
        assert set(stages[label]) == set(jstages)
        busy = {k for k, v in stages[label]["stage_ms"].items() if v > 0}
        assert busy <= {k for k in jstages["stage_ms"]}
        assert stages[label]["stage_ms"]["agg"] > 0


def test_q1_device_step_equals_jax():
    jstep, jargs = jb.q1_example_args("micro")
    pstep, pargs = pb.q1_example_args("micro", device="cpu")
    for ja, pa in zip(jargs[:3], pargs[:3]):
        if isinstance(ja, tuple):
            for x, y in zip(ja, pa):
                np.testing.assert_array_equal(y.numpy(), np.asarray(x))
        else:
            np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    jk, jn, jr, jv = jstep(*jargs)
    pk, pn, pr, pv = pstep(*pargs)
    jv, pv = np.asarray(jv), pv.numpy()
    np.testing.assert_array_equal(pv, jv)
    assert 0 < int(pv.sum()) <= 4
    live = pv
    for x, y in list(zip(jk, pk)) + list(zip(jn, pn)):
        np.testing.assert_array_equal(y.numpy()[live], np.asarray(x)[live])
    assert len(pr) == len(jr) == 15
    for x, y in zip(jr, pr):
        assert y.dtype == torch.int64
        np.testing.assert_array_equal(y.numpy()[:len(live)][live],
                                      np.asarray(x)[:len(live)][live])


def test_q1_device_step_equals_sort_group_reduce():
    """The hash step's groups equal the sort-based ``group_reduce`` of
    the same filtered page: keys, and every state exactly."""
    from trino_tpu_torch.ops.aggregation import (_init_states, _state_plan,
                                                 group_reduce)
    from trino_tpu_torch.ops.sortkeys import group_operands

    step, (cols, nulls, valid, luts) = pb.q1_example_args("micro",
                                                          device="cpu")
    keys, knulls, reduced, out_valid = step(cols, nulls, valid, luts)
    types = _q1_types()
    projections, filt, aggs = pb.q1_expressions(types)
    proc = pb.PageProcessor(types, projections, filt)
    pcols, pnulls, pvalid = proc._run(cols, nulls, valid, luts)
    key_ops = []
    for c in (0, 1):
        key_ops.extend(group_operands(pcols[c], pnulls[c],
                                      proc.output_types[c]))
    states = []
    for a in aggs:
        states.extend(_init_states(a, pcols, pnulls, pvalid,
                                   [None] * len(pcols), {}))
    kinds = [k for a in aggs for (k, _) in _state_plan(a)]
    skeys, _sk, sred, svalid = group_reduce(key_ops, [pcols[0], pcols[1]],
                                            states, pvalid, kinds)

    def groups(k, r, v):
        v = v.numpy()
        return sorted(tuple([int(k[0][i]), int(k[1][i])] +
                            [int(x[i]) for x in r])
                      for i in np.nonzero(v)[0])

    assert groups(keys, reduced, out_valid) == \
        groups(skeys, sred, svalid)


def _q1_types():
    md = TpchConnector(page_rows=4096).metadata()
    cols = {c.name: c for c in md.get_columns(
        md.get_table_handle("micro", "lineitem"))}
    return [cols[n].type for n in pb.Q1_COLUMNS]
