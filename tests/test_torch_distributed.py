"""DistributedQueryRunner of the torch engine against the JAX engine's.

The fixtures of tests/test_distributed.py (``TpchConnector(page_rows=
4096)``, micro, ``n_workers=3``, ``desired_splits=8``,
``broadcast_threshold=300.0``), the port's runner on the CPU and the JAX
runner on one device (``jax.devices`` monkeypatched, as
tests/test_device_exchange.py does). Rows compare as sorted lists
where there is no ORDER BY (the exchange's row order and DOUBLE addend
order are not fixed), DOUBLE at 9 significant digits; integers and
decimals exactly. Both engines' history stores, profilers and exchange
sizing histories are cleared around every case.

This file: the cases of tests/test_distributed.py (scan, global and
grouped aggregation, string keys, full outer, broadcast, partitioned,
semi join, DISTINCT, top-N and LIMIT, the cold connector), EXPLAIN
ANALYZE's stats tree with its stage/task spans, the memory-table
distributed read, adaptive partial aggregation (the same pass-through
and key-range decisions and the same ``agg_bucket_stats`` /
``agg_key_range_mask`` profiled calls), and the runner's device rule.
The 22 TPC-H queries and the TPC-DS set are in
``test_torch_distributed_tpch.py`` and ``test_torch_distributed_tpcds.py``.
"""

import pytest

import jax
from trino_tpu.connectors.memory import MemoryConnector as JMemory
from trino_tpu.connectors.tpch import TpchConnector as JTpch
from trino_tpu.parallel import device_exchange as jde
from trino_tpu.parallel.distributed import DistributedQueryRunner as JDist
from trino_tpu.runner import LocalQueryRunner as JLocal
from trino_tpu.sql.analyzer import Session as JSession
from trino_tpu.telemetry import profiler as jprof
from trino_tpu.telemetry import stats_store as jss
from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.parallel import DistributedQueryRunner
from trino_tpu_torch.parallel import device_exchange as pde
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.sql.analyzer import Session
from trino_tpu_torch.telemetry import profiler as pprof
from trino_tpu_torch.telemetry import stats_store as pss


def clear_stores():
    for s in (jss.store(), pss.store()):
        s.clear()
    for p in (jprof, pprof):
        p.reset()
    for h in (jde.SIZING_HISTORY, pde.SIZING_HISTORY):
        h.reset()


@pytest.fixture(autouse=True)
def _fresh_stores():
    clear_stores()
    yield
    clear_stores()


@pytest.fixture(scope="module")
def one_device():
    real = jax.devices()
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "devices", lambda *a, **k: real[:1])
    yield
    mp.undo()


def make_pair(catalog="tpch", schema="micro", conns=None, n_workers=3,
              desired_splits=8, broadcast_threshold=300.0, **props):
    """(JAX runner, torch runner) over their own connectors."""
    jconns, pconns = conns or ({catalog: JTpch(page_rows=4096)},
                               {catalog: TpchConnector(page_rows=4096)})
    out = []
    for S, R, cs, kw in ((JSession, JDist, jconns, {}),
                         (Session, DistributedQueryRunner, pconns,
                          {"device": "cpu"})):
        s = S(catalog=catalog, schema=schema)
        s.properties.update(props)
        out.append(R(cs, s, n_workers=n_workers,
                     desired_splits=desired_splits,
                     broadcast_threshold=broadcast_threshold, **kw))
    return tuple(out)


@pytest.fixture(scope="module")
def pair(one_device):
    return make_pair()


def norm(row):
    return tuple("\0" if v is None
                 else f"{v:.9g}" if isinstance(v, float) else str(v)
                 for v in row)


def check(pair, sql, ordered=None):
    jd, pd = pair
    jrows = [norm(r) for r in jd.execute(sql).rows]
    prows = [norm(r) for r in pd.execute(sql).rows]
    if ordered is None:
        ordered = "order by" in sql.lower()
    if not ordered:
        jrows, prows = sorted(jrows), sorted(prows)
    assert prows == jrows, f"{sql[:80]}\nport={prows[:5]}\njax={jrows[:5]}"
    return prows


CASES = {
    "scan_filter": "select n_name from nation where n_regionkey = 2",
    "global_agg": "select count(*), sum(l_quantity), min(l_shipdate), "
                  "avg(l_discount) from lineitem",
    "group_by": "select l_returnflag, l_linestatus, count(*), "
                "sum(l_quantity) from lineitem group by l_returnflag, "
                "l_linestatus order by l_returnflag, l_linestatus",
    "string_group_keys": "select l_shipmode, count(*) from lineitem "
                         "group by l_shipmode order by l_shipmode",
    "full_outer_join": "select o_custkey, c_custkey from (select o_custkey "
                       "from orders where o_custkey < 100) o full outer "
                       "join customer c on o_custkey = c_custkey",
    "broadcast_join": "select n_name, count(*) c from customer, nation "
                      "where c_nationkey = n_nationkey group by n_name "
                      "order by c, n_name",
    "partitioned_join": "select o_orderpriority, count(*) from orders, "
                        "lineitem where o_orderkey = l_orderkey and "
                        "l_quantity < 10 group by o_orderpriority "
                        "order by o_orderpriority",
    "distinct": "select distinct c_nationkey from customer "
                "order by c_nationkey",
    "topn": "select c_custkey, c_acctbal from customer "
            "order by c_acctbal desc, c_custkey limit 7",
    "limit": "select count(*) from (select * from lineitem limit 100) t",
    "semi_join": "select count(*) from orders where o_custkey in "
                 "(select c_custkey from customer where c_acctbal > 0)",
    "min_max_strings": "select l_returnflag, min(l_shipmode), "
                       "max(l_shipinstruct), count(distinct l_linestatus) "
                       "from lineitem group by l_returnflag",
    "order_by_merge": "select o_orderkey, o_totalprice from orders "
                      "where o_orderkey < 400 order by o_totalprice desc, "
                      "o_orderkey",
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_equals_jax(pair, name):
    rows = check(pair, CASES[name])
    if name == "limit":
        assert rows == [("100",)]


def test_cold_connector_string_groups(one_device):
    """Fresh connectors: dictionary pools grow concurrently across scan
    tasks; the rows equal the JAX engine's and the port's local
    runner's."""
    sql = ("select l_shipmode, count(*) from lineitem "
           "group by l_shipmode order by l_shipmode")
    jd, pd = make_pair(conns=({"tpch": JTpch(page_rows=512)},
                              {"tpch": TpchConnector(page_rows=512)}),
                       n_workers=4, broadcast_threshold=None)
    got = pd.execute(sql).rows
    assert got == jd.execute(sql).rows
    local = LocalQueryRunner({"tpch": TpchConnector(page_rows=512)},
                             Session(catalog="tpch", schema="micro"),
                             device="cpu")
    assert got == local.execute(sql).rows


def test_explain_analyze_stats_tree_and_spans(pair):
    """The stats tree has the JAX engine's stages and tasks; the trace
    holds the query, one span per stage and per task, and the
    operators under the tasks, so the Trace line names a critical
    path."""
    jd, pd = pair
    sql = ("explain analyze select n_regionkey, count(*) c from nation "
           "group by n_regionkey order by c desc")
    res = pd.execute(sql)
    text = "\n".join(r[0] for r in res.rows)
    assert "Stage" in text and "task 0:" in text
    assert "TableScanOperator" in text
    assert "Trace:" in text and "critical path: query" in text
    tree = res.stats["query_stats"]
    jtree = jd.execute(sql).stats["query_stats"]
    assert [(s["stage_id"], s["partitioning"], s["output_kind"],
             len(s["tasks"])) for s in tree["stages"]] == \
        [(s["stage_id"], s["partitioning"], s["output_kind"],
          len(s["tasks"])) for s in jtree["stages"]]
    for s in tree["stages"]:
        for t in s["tasks"]:
            assert isinstance(t["wall_ms"], float) and t["operators"]
    spans = tree["trace"]
    kinds = [sp["attrs"].get("span_kind") for sp in spans]
    n_tasks = sum(len(s["tasks"]) for s in tree["stages"])
    assert kinds.count("stage") == len(tree["stages"])
    assert kinds.count("task") == n_tasks
    assert kinds.count("operator") >= n_tasks
    by_id = {sp["span_id"]: sp for sp in spans}
    for sp in spans:
        if sp["attrs"].get("span_kind") == "operator":
            assert by_id[sp["parent_id"]]["attrs"]["span_kind"] == "task"


def test_slow_query_record_has_critical_path(pair):
    _, pd = pair
    pd.session.properties["slow_query_log_threshold"] = 1e-9
    try:
        res = pd.execute("select l_returnflag, count(*) from lineitem "
                         "group by l_returnflag")
    finally:
        del pd.session.properties["slow_query_log_threshold"]
    slow = res.stats["slow_query"]
    path = [s["name"] for s in slow["critical_path"]]
    assert path[0] == "query" and path[1].startswith("stage f")
    assert path[2].startswith("task f")
    assert slow["top_operators"]


def test_smoke_step_labels_cover_every_kernel_call(pair):
    """chip_smoke.py's recorder labels each kernel call of a distributed
    aggregation with the step it serves, and picks its timed calls from
    those labels: every call is labelled, with a step of the split
    aggregation."""
    import chip_smoke

    _, pd = pair
    calls, labels = [], []
    with chip_smoke._recorded(calls, labels):
        pd.execute(CASES["group_by"])
    assert calls and len(labels) == len(calls)
    assert set(labels) >= {"partial_page", "final_page"}
    assert set(labels) <= {"partial_page", "partial_merge", "final_page",
                           "final_merge"}
    picks = chip_smoke._step_picks(calls, labels)
    assert labels[picks["page"]] == "partial_page"
    assert labels[picks["merge"]] in ("final_page", "final_merge")


def test_memory_distributed_read():
    """SF tables copied into the memory connector serve every worker:
    each task reads its share of the table's pages."""
    sql = "select count(*), sum(l_quantity) from li"
    got = []
    for Mem, Tpch, S, L, R, kw in (
            (JMemory, JTpch, JSession, JLocal, JDist, {}),
            (MemoryConnector, TpchConnector, Session, LocalQueryRunner,
             DistributedQueryRunner, {"device": "cpu"})):
        mem, tpch = Mem(), Tpch(page_rows=1024)
        local = L({"memory": mem, "tpch": tpch},
                  S(catalog="memory", schema="default"), **kw)
        local.execute("create table li as select l_orderkey, l_quantity "
                      "from tpch.micro.lineitem")
        dist = R({"memory": mem, "tpch": tpch},
                 S(catalog="memory", schema="default"), n_workers=3, **kw)
        want = local.execute(sql).rows
        rows = dist.execute(sql).rows
        assert rows == want
        got.append(rows)
    assert got[1] == got[0]


ADAPTIVE = {
    # unique keys: every bucket non-reducing -> whole-stream pass-through
    "passthrough": "select l_orderkey, l_linenumber, sum(l_quantity) "
                   "from lineitem group by l_orderkey, l_linenumber",
    # a reducing key: the partial keeps aggregating
    "aggregate": "select l_suppkey, count(*), sum(l_extendedprice) "
                 "from lineitem group by l_suppkey",
}


def _adaptive_view(runner, sql):
    """Per stage, the adaptive bracket of every aggregation line, and
    the profiled calls of the adaptive programs."""
    res = runner.execute("explain analyze verbose " + sql)
    lines = [r[0] for r in res.rows]
    brackets = sorted(ln[ln.index("[adaptive"):].split("]")[0]
                      for ln in lines if "[adaptive" in ln)
    return brackets, lines


def _calls(prof):
    out = {}
    for e in prof.snapshot():
        if e["name"] in ("agg_bucket_stats", "agg_key_range_mask"):
            out[e["name"]] = out.get(e["name"], 0) + e["calls"]
    return out


@pytest.mark.parametrize("case", sorted(ADAPTIVE))
def test_adaptive_partial_aggregation_equals_jax(one_device, case):
    """With a small observation window both engines decide alike, per
    task, and call the adaptive programs as often; the second run is
    seeded from history in both; the rows are equal."""
    props = {"adaptive_partial_aggregation_min_rows": 256,
             "adaptive_partial_aggregation_unique_rows_ratio_threshold":
                 0.8}
    jd, pd = make_pair(**props)
    sql = ADAPTIVE[case]
    views = []
    for r, prof in ((jd, jprof), (pd, pprof)):
        prof.reset()
        first, _ = _adaptive_view(r, sql)
        calls = _calls(prof)
        second, _ = _adaptive_view(r, sql)
        views.append((first, calls, second))
    assert views[1] == views[0]
    first, calls, second = views[1]
    if case == "passthrough":
        assert first and all("passthrough" in b for b in first)
        assert all("seeded by hbo" in b for b in second)
    else:
        assert first == []
    assert calls.get("agg_bucket_stats", 0) >= 1
    check((jd, pd), sql)


def test_range_split_decision_equals_jax(one_device):
    """A skewed key stream: the hot key range keeps aggregating, the
    cold ranges pass through — the same buckets in both engines, and
    the per-page masks (``agg_key_range_mask``) called as often."""
    props = {"adaptive_partial_aggregation_min_rows": 256,
             "adaptive_partial_aggregation_unique_rows_ratio_threshold":
                 0.5,
             "adaptive_partial_aggregation_key_range_buckets": 4}
    jd, pd = make_pair(conns=({"tpch": JTpch(page_rows=256)},
                              {"tpch": TpchConnector(page_rows=256)}),
                       **props)
    sql = ("select case when l_quantity < 40 then 0 else l_orderkey end k, "
           "count(*), sum(l_quantity) from lineitem group by 1")
    views = []
    for r, prof in ((jd, jprof), (pd, pprof)):
        prof.reset()
        first, _ = _adaptive_view(r, sql)
        views.append((first, _calls(prof)))
    assert views[1] == views[0]
    first, calls = views[1]
    assert first and all("range-split" in b for b in first)
    assert calls["agg_key_range_mask"] >= 1
    check((jd, pd), sql)


def test_device_rule():
    """CUDA unless the caller asks for the CPU; a runner asked for CUDA
    without a card raises instead of running on the CPU."""
    import torch

    conns = {"tpch": TpchConnector(page_rows=4096)}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DistributedQueryRunner(conns, Session(catalog="tpch",
                                                  schema="micro"))
    r = DistributedQueryRunner(conns, Session(catalog="tpch",
                                              schema="micro"),
                               device="cpu")
    assert r.device.type == "cpu"
    assert "system" in r.metadata.connectors


@pytest.mark.parametrize("max_lanes", [1024, 1500, 4096])
def test_probe_chunk_units_equal_jax(max_lanes):
    """An over-budget probe page splits into the JAX engine's units:
    the same row ranges and lane capacities (the port cuts them with
    prefix-sum searches where the JAX engine loops per row; a device
    exchange's consumer page holds millions of lanes)."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    from trino_tpu import types as JT
    from trino_tpu.block import DevicePage as JPage
    from trino_tpu.ops import join as jj
    from trino_tpu_torch import types as PT
    from trino_tpu_torch.block import DevicePage as PPage
    from trino_tpu_torch.ops import join as pj

    rng = np.random.default_rng(max_lanes)
    n = 4096
    counts = np.where(rng.random(n) < 0.7, rng.integers(0, 4, n), 0)
    counts[100] = 3000  # one row over the budget: its own unit
    counts = counts.astype(np.int32)
    vals = np.arange(n, dtype=np.int64)
    valid = np.ones(n, dtype=bool)
    got = {}
    for eng in ("jax", "torch"):
        if eng == "jax":
            t, P, mod = JT, JPage, jj
            arr = jnp.asarray
        else:
            t, P, mod = PT, PPage, pj
            arr = torch.from_numpy
        page = P([t.BIGINT], [arr(vals)], [arr(np.zeros(n, bool))],
                 arr(valid), [None])
        op = mod.LookupJoinOperator.__new__(mod.LookupJoinOperator)
        op.max_lanes = max_lanes
        rec = {"page": page, "pkey_cols": [arr(vals)],
               "pusable": arr(valid), "lo": arr(vals), "count":
               arr(counts)}
        units = op._chunk_units(rec, int(counts.sum()))
        got[eng] = [(u[0].capacity, np.asarray(u[3]).tolist(),
                     np.asarray(u[4]).tolist(), u[5]) for u in units]
    assert len(got["torch"]) >= 2
    assert got["torch"] == got["jax"]
