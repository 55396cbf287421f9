"""ProcessQueryRunner of the torch engine: a coordinator and real worker
processes on the CPU, against the JAX engine.

The fourteen cases of tests/test_process_runner.py (task RPC, the wire
serde, pull-based shuffle, failure injection with task retry, worker
death with query retry and replacement, heartbeat, streaming overlap
across processes, concurrent queries over the HTTP protocol,
distributed writes, barrier-mode task retry, the worker-slot snapshot
and the serde round trip), the two ``ft_cluster`` cases of
tests/test_spool.py (retry-from-spool) and
``test_protocol_stats_carry_recovery_and_cluster_memory`` of
tests/test_memory_governance.py. Rows are checked against the JAX
engine's ``LocalQueryRunner`` as tests/test_process_runner.py's
``check`` does: sorted where there is no ORDER BY, integers and
decimals exactly, DOUBLE at 9 significant digits. Every runner here
passes ``device="cpu"``; the workers it spawns run the port's plain
paths on the CPU. Both engines' history stores, profilers and exchange
sizing histories in this process are cleared around every case (each
worker process keeps its own).

Two more cases hold the port's boundaries: every response a worker
sends holds only Python values (no tensor rides the pickle); the worker
and every module of the multi-process runtime import neither ``jax`` nor
``trino_tpu``, a runner without ``device`` raises on a machine with no
card, and a worker that cannot open its device makes the coordinator's
error name the cause.
"""

import subprocess
import sys
import threading
import time

import pytest

from trino_tpu.connectors.tpch import TpchConnector as JTpch
from trino_tpu.parallel import device_exchange as jde
from trino_tpu.resources.tpch_queries import TPCH_QUERIES
from trino_tpu.runner import LocalQueryRunner as JLocal
from trino_tpu.sql.analyzer import Session as JSession
from trino_tpu.telemetry import profiler as jprof
from trino_tpu.telemetry import stats_store as jss
from trino_tpu_torch.parallel import ProcessQueryRunner
from trino_tpu_torch.parallel import device_exchange as pde
from trino_tpu_torch.sql.analyzer import Session
from trino_tpu_torch.telemetry import profiler as pprof
from trino_tpu_torch.telemetry import stats_store as pss

CATALOGS = {"tpch": {"connector": "tpch", "page_rows": 4096}}


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
def cluster():
    runner = ProcessQueryRunner(
        CATALOGS, Session(catalog="tpch", schema="micro"),
        n_workers=2, desired_splits=4, broadcast_threshold=300.0,
        device="cpu")
    yield runner
    runner.close()


@pytest.fixture(scope="module")
def local():
    return JLocal({"tpch": JTpch(page_rows=4096)},
                  JSession(catalog="tpch", schema="micro"))


def norm(row):
    return tuple("\0" if v is None
                 else f"{v:.9g}" if isinstance(v, float) else str(v)
                 for v in row)


def check(local, cluster, sql, ordered=None):
    lrows = [norm(r) for r in local.execute(sql).rows]
    drows = [norm(r) for r in cluster.execute(sql).rows]
    if ordered is None:
        ordered = "order by" in sql.lower()
    if not ordered:
        lrows, drows = sorted(lrows), sorted(drows)
    assert drows == lrows, \
        f"process != local for {sql[:70]}...\n" \
        f"proc={drows[:5]}\nlocal={lrows[:5]}"
    return drows


def test_scan_filter(local, cluster):
    check(local, cluster,
          "select n_name from nation where n_regionkey = 2")


def test_group_agg_strings(local, cluster):
    check(local, cluster,
          "select l_returnflag, l_linestatus, count(*), sum(l_quantity) "
          "from lineitem group by l_returnflag, l_linestatus")


def test_join_q3(local, cluster):
    check(local, cluster, TPCH_QUERIES[3])


def test_semijoin(local, cluster):
    check(local, cluster,
          "select count(*) from lineitem where l_orderkey in "
          "(select o_orderkey from orders where "
          "o_orderpriority = '1-URGENT')")


def test_order_limit(local, cluster):
    check(local, cluster,
          "select o_custkey, o_totalprice from orders "
          "order by o_totalprice desc limit 7")


def test_heartbeat(cluster):
    assert cluster.heartbeat() == [True, True]


def test_kernel_calls_recorded_per_process(cluster, tmp_path):
    """``record_kernel_calls`` arms every process, then writes the calls
    each one kept to ``<dir>/<process>.pt``: as many as its launches.
    On the CPU the plain path launches nothing, so each file holds an
    empty list."""
    import torch

    cluster.kernel_launches(reset=True)
    started = cluster.record_kernel_calls()
    cluster.execute("select l_returnflag, sum(l_quantity) from lineitem "
                    "group by l_returnflag")
    launches = {proc: counts["segment_reduce"] for proc, counts
                in cluster.kernel_launches().items()}
    kept = cluster.record_kernel_calls(str(tmp_path))
    assert set(started) == set(kept) == \
        {"coordinator", "worker-0", "worker-1"}
    assert not any(started.values())
    assert kept == launches == dict.fromkeys(kept, 0)
    for proc in kept:
        assert torch.load(tmp_path / f"{proc}.pt", weights_only=True) == []


def test_injected_task_failure_recovers(local, cluster):
    """A task that fails on its first worker retries on another and the
    query still returns the JAX engine's rows."""
    cluster.inject_task_failure("q", times=1)  # first task of next query
    check(local, cluster, TPCH_QUERIES[3])
    assert not any(cluster.failure_injections.values())


def test_worker_death_query_retry_and_replacement(local, cluster):
    """Killing a worker: the query retries on survivors and the
    self-healing path replaces the dead worker."""
    victim = cluster.workers[1]
    victim.proc.kill()
    victim.proc.wait(timeout=10)
    sql = "select count(*), sum(l_quantity) from lineitem"
    res = cluster.execute(sql)
    assert [norm(r) for r in res.rows] == \
        [norm(r) for r in local.execute(sql).rows]
    assert cluster.heal() == [True, True]
    assert cluster.workers[1].generation >= 1
    assert cluster.workers[1].proc.pid != victim.proc.pid
    # the replacement serves queries as a first-class worker
    res2 = cluster.execute(sql)
    assert res2.rows == res.rows


def test_streaming_cross_process_overlap(cluster):
    """Some mid-plan task's first output page was drained by its
    consumer (another process) before that task finished."""
    res = cluster.execute(
        "select l_returnflag, l_linestatus, count(*), sum(l_quantity) "
        "from lineitem group by l_returnflag, l_linestatus")
    overlap = res.stats["process_overlap"]
    assert len(overlap) >= 2
    assert any(overlap.values()), \
        f"no cross-process producer/consumer overlap: {overlap}"


def test_concurrent_queries_interleave(cluster):
    """Two queries submitted through the port's HTTP protocol run
    concurrently against the worker processes."""
    from trino_tpu_torch.client import Client
    from trino_tpu_torch.server.protocol import ProtocolServer

    srv = ProtocolServer(cluster, page_size=1000).start()
    try:
        windows = {}
        errors = []

        def run(tag, sql):
            c = Client(srv.uri)
            t0 = time.monotonic()
            try:
                res = c.execute(sql)
                windows[tag] = (t0, time.monotonic(), len(res.rows))
            except Exception as e:  # surfaces in the main thread
                errors.append(e)

        sqls = {
            "a": "select l_returnflag, count(*), sum(l_quantity) "
                 "from lineitem group by l_returnflag",
            "b": "select o_orderpriority, count(*) from orders, lineitem "
                 "where o_orderkey = l_orderkey "
                 "group by o_orderpriority",
        }
        threads = [threading.Thread(target=run, args=(tag, sql))
                   for tag, sql in sqls.items()]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert not any(th.is_alive() for th in threads)
        assert not errors, errors
        assert windows["a"][2] == 3 and windows["b"][2] == 5
        a0, a1, _ = windows["a"]
        b0, b1, _ = windows["b"]
        assert a0 < b1 and b0 < a1, \
            f"queries serialized: a={a0, a1} b={b0, b1}"
    finally:
        srv.stop()


def test_distributed_writes_memory_catalog():
    """INSERT/CTAS writer tasks execute on worker processes (page-sink
    RPC to the coordinator's catalog), commits replicate to every
    worker, and the written table is then scanned distributed."""
    with ProcessQueryRunner(
            {"tpch": {"connector": "tpch", "page_rows": 4096},
             "memory": {"connector": "memory"}},
            Session(catalog="memory", schema="default"),
            n_workers=2, desired_splits=4, device="cpu") as c:
        res = c.execute("create table t as select n_nationkey k, n_name "
                        "from tpch.micro.nation")
        assert res.rows == [(25,)]
        res = c.execute("insert into t select n_nationkey + 100, n_name "
                        "from tpch.micro.nation where n_regionkey = 2")
        assert res.rows == [(5,)]
        res = c.execute("select count(*) from t")
        assert res.rows == [(30,)]
        res = c.execute(
            "select r_name, count(*) c from t, tpch.micro.nation n, "
            "tpch.micro.region r where t.k % 100 = n.n_nationkey and "
            "n.n_regionkey = r.r_regionkey group by r_name "
            "order by c desc, r_name")
        assert res.rows[0][1] == 10  # ASIA nations counted twice
        res = c.execute("delete from t where k >= 100")
        assert res.rows == [(5,)]
        assert c.execute("select count(*) from t").rows == [(25,)]
        res2 = c.execute("select count(*) from tpch.micro.region")
        assert res2.rows[0][0] == 5
        # retried writes must not double-apply: pages stage at the
        # coordinator and only the successful attempt commits
        c.inject_task_failure("q", times=1)
        res = c.execute("insert into t select n_nationkey + 200, n_name "
                        "from tpch.micro.nation where n_regionkey = 0")
        assert res.rows == [(5,)]
        assert c.execute("select count(*) from t").rows == [(30,)]


def test_barrier_mode_task_retry():
    """With streaming off, an injected task failure retries on another
    worker without restarting the query."""
    s = Session(catalog="tpch", schema="micro")
    s.properties["streaming_execution"] = False
    with ProcessQueryRunner(CATALOGS, s, n_workers=2, desired_splits=4,
                            broadcast_threshold=300.0, device="cpu") as c:
        c.inject_task_failure("q", times=1)
        res = c.execute("select l_returnflag, count(*) from lineitem "
                        "group by l_returnflag")
        assert sorted(res.rows) == [("A", 1590), ("N", 2773),
                                    ("R", 1516)]
        assert not any(c.failure_injections.values())


def test_worker_snapshot_consistent_under_concurrent_replacement():
    """Query-path readers copy the worker slots under ``_heal_lock``; a
    snapshot taken during a storm of concurrent slot swaps is always a
    complete, valid view."""
    r = ProcessQueryRunner.__new__(ProcessQueryRunner)  # no spawn
    r._heal_lock = threading.Lock()
    slots = [object() for _ in range(4)]
    spares = [object() for _ in range(4)]
    r.workers = list(slots)
    valid = set(slots) | set(spares)

    snap = r._worker_snapshot()
    assert snap == r.workers and snap is not r.workers  # a copy

    stop = threading.Event()

    def swapper():
        i = 0
        while not stop.is_set():
            with r._heal_lock:
                r.workers[i % 4] = spares[i % 4] if i % 2 \
                    else slots[i % 4]
            i += 1

    t = threading.Thread(target=swapper, daemon=True)
    t.start()
    try:
        for _ in range(2000):
            s = r._worker_snapshot()
            assert len(s) == 4
            assert all(w in valid for w in s)
    finally:
        stop.set()
        t.join(timeout=5)
    assert not t.is_alive()


def test_serde_roundtrip():
    from trino_tpu_torch import types as T
    from trino_tpu_torch.block import Dictionary, Page
    from trino_tpu_torch.exec.serde import PageDeserializer, PageSerializer

    d = Dictionary()
    page = Page.from_pylists(
        [T.BIGINT, T.VARCHAR, T.DOUBLE, T.DATE],
        [[1, 2, None], ["a", None, "bb"], [1.5, None, -2.0],
         [10, None, 20]],
        dictionaries=[None, d, None, None])
    ser = PageSerializer()
    de = PageDeserializer()
    out = de.deserialize(ser.serialize(page))
    assert out.to_rows() == page.to_rows()
    # second page on the same stream: the pool ships only the delta
    page2 = Page.from_pylists([T.BIGINT, T.VARCHAR, T.DOUBLE, T.DATE],
                              [[4], ["cc"], [0.0], [30]],
                              dictionaries=[None, d, None, None])
    out2 = de.deserialize(ser.serialize(page2))
    assert out2.to_rows() == page2.to_rows()
    assert out2.blocks[1].dictionary is out.blocks[1].dictionary


# ---------------------------------------------- retry-from-spool (TASK) ----


@pytest.fixture(scope="module")
def ft_cluster():
    s = Session(catalog="tpch", schema="micro")
    s.properties["streaming_execution"] = False
    s.properties["retry_policy"] = "TASK"
    with ProcessQueryRunner(CATALOGS, s, n_workers=2, desired_splits=4,
                            broadcast_threshold=300.0, device="cpu") as c:
        yield c


SQL = ("select l_returnflag, l_linestatus, count(*), sum(l_quantity) "
       "from lineitem group by l_returnflag, l_linestatus")
EXPECTED_GROUPS = 4


def test_task_retry_does_not_rerun_producer(local, ft_cluster):
    """A failure injected into a final-stage task retries reading its
    input from the spool; the producer stage's tasks launch exactly
    once."""
    c = ft_cluster
    qid = f"q{c._task_seq + 1}a0"
    c.inject_task_failure(f"{qid}.f1", times=1)
    c.task_launches.clear()
    res = c.execute(SQL)
    assert len(res.rows) == EXPECTED_GROUPS
    assert sorted(norm(r) for r in res.rows) == \
        sorted(norm(r) for r in local.execute(SQL).rows)
    assert not any(c.failure_injections.values())
    f0 = [t for t in c.task_launches if f"{qid}.f0." in t]
    f1 = [t for t in c.task_launches if f"{qid}.f1." in t]
    assert len(f0) == 2, f"producer stage re-ran: {f0}"
    assert len(f1) == 3, f"expected one retried final task: {f1}"


def test_worker_death_recovers_from_spool(local, ft_cluster):
    """A worker killed between stages: its final-stage task retries on
    the survivor from the spooled producer output; neither the producer
    stage nor the query re-runs."""
    c = ft_cluster
    qid = f"q{c._task_seq + 1}a0"
    c.task_launches.clear()
    victim = c.workers[1]

    def killer():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if any(f"{qid}.f1." in t for t in c.task_launches):
                victim.proc.kill()
                return
            time.sleep(0.001)

    th = threading.Thread(target=killer)
    th.start()
    res = c.execute(SQL)
    th.join(timeout=90)
    assert not th.is_alive()
    assert sorted(norm(r) for r in res.rows) == \
        sorted(norm(r) for r in local.execute(SQL).rows)
    assert all("a0." in t for t in c.task_launches), c.task_launches
    f0 = [t for t in c.task_launches if f"{qid}.f0." in t]
    assert len(f0) == 2, f"producer stage re-ran: {f0}"
    c.heartbeat()


# ------------------------------------------------------- HTTP protocol ----


def test_protocol_stats_carry_recovery_and_cluster_memory():
    import json
    import urllib.request

    from trino_tpu_torch import types as T
    from trino_tpu_torch.runner import QueryResult
    from trino_tpu_torch.server.protocol import ProtocolServer

    class Stub:
        def execute(self, sql):
            return QueryResult(["x"], [T.BIGINT], [(1,)], stats={
                "memory": {"peak_bytes": 7},
                "recovery": {"task_attempts": 3},
                "cluster_memory": {"workers": 2, "kills": 1},
            })

    srv = ProtocolServer(Stub()).start()
    try:
        doc = json.loads(urllib.request.urlopen(urllib.request.Request(
            f"{srv.uri}/v1/statement", data=b"select 1",
            method="POST"), timeout=30).read())
        for _ in range(100):
            if "data" in doc or "error" in doc:
                break
            doc = json.loads(
                urllib.request.urlopen(doc["nextUri"], timeout=30).read())
        assert doc["stats"]["recovery"]["task_attempts"] == 3
        assert doc["stats"]["clusterMemory"]["kills"] == 1
        assert doc["stats"]["memory"]["peak_bytes"] == 7
    finally:
        srv.stop()


# -------------------------------------------------------- the wire ----


def _plain(obj, path="resp"):
    """Every leaf of a response is a plain Python value: no tensor, no
    numpy scalar rides the pickle back to the coordinator."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            _plain(k, f"{path}.key")
            _plain(v, f"{path}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _plain(v, f"{path}[{i}]")
    else:
        assert obj is None or type(obj) in (str, int, float, bool, bytes), \
            f"{path} is {type(obj).__module__}.{type(obj).__name__}"


def test_worker_responses_hold_only_python_values():
    """A barrier task run in an in-process worker with history and
    profiling on: its response (rows, memory peak, spans, history
    actuals), the task status, the profile and the heartbeat ping carry
    only Python values."""
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.parallel import DistributedQueryRunner
    from trino_tpu_torch.parallel.rpc import call
    from trino_tpu_torch.parallel.worker import WorkerServer
    from trino_tpu_torch.telemetry.tracing import Tracer

    props = {"hbo_enabled": True, "query_profiling_enabled": True,
             "streaming_execution": False}
    s = Session(catalog="tpch", schema="micro")
    s.properties.update(props)
    planning = DistributedQueryRunner(
        {"tpch": TpchConnector(page_rows=4096)}, s, n_workers=1,
        desired_splits=4, device="cpu")
    frags = planning.create_fragments(
        "select l_returnflag, count(*), sum(l_quantity), avg(l_discount) "
        "from lineitem group by l_returnflag")
    leaf = frags[0]
    w = WorkerServer(0, "cpu")
    th = threading.Thread(target=w.serve_forever, daemon=True)
    th.start()
    try:
        addr = ("127.0.0.1", w.port)
        assert call(addr, {"op": "configure", "catalogs": CATALOGS,
                           "properties": props}, timeout=30)["ok"]
        span = Tracer(process="coordinator").span("attempt")
        req = {"op": "run_task", "task_id": "q1a0.f0.t0.r0",
               "fragment": leaf, "task_index": 0, "task_count": 1,
               "n_partitions": 1, "output_kind": leaf.output_kind,
               "upstream": {}, "desired_splits": 4, "session": props,
               "hbo": {"stmt_fp": "fp", "snap": "snap"},
               "trace": span.context(attempt=0)}
        resp = call(addr, req, timeout=60)
        assert resp["ok"] and resp["rows"] > 0, resp
        assert resp["memory_peak"] > 0 and resp["hbo"] and resp["spans"]
        _plain(resp)
        _plain(call(addr, {"op": "task_status", "task_ids": None,
                           "include_spans": True}, timeout=30))
        _plain(call(addr, {"op": "profile"}, timeout=30))
        ping = call(addr, {"op": "ping"}, timeout=30)
        assert ping["memory"]["queries"]["q1a0"]["peak"] > 0
        _plain(ping)
    finally:
        w.server.shutdown()
        w.server.server_close()
        th.join(timeout=10)
    assert not th.is_alive()


# ------------------------------------------------------------ boundary ----


RUNTIME_MODULES = ["fault", "rpc", "cluster", "autoscaler",
                   "cluster_memory", "spool", "spool_backend",
                   "remote_exchange", "worker", "process_runner"]


def test_runtime_imports_no_jax_and_needs_a_card_by_default():
    """In a fresh interpreter, importing the worker and every module of
    the multi-process runtime loads neither ``jax`` nor ``trino_tpu``;
    and a runner without ``device`` raises where there is no card."""
    code = (
        "import sys\n"
        "import trino_tpu_torch.exec.serde, trino_tpu_torch.exec.memory\n"
        + "".join(f"import trino_tpu_torch.parallel.{m}\n"
                  for m in RUNTIME_MODULES)
        + "bad = sorted(m for m in sys.modules if m == 'jax' or "
          "m.startswith('jax.') or m == 'trino_tpu' or "
          "m.startswith('trino_tpu.'))\n"
          "print('LEAKED', bad)\n")
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device opens")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProcessQueryRunner(CATALOGS, Session(catalog="tpch",
                                             schema="micro"))
    # a worker that cannot open its device: the coordinator's error
    # names the cause the worker reported, not only "failed to start"
    from trino_tpu_torch.types import TrinoError

    r = ProcessQueryRunner.__new__(ProcessQueryRunner)  # no spawn yet
    r.device = torch.device("cuda")
    with pytest.raises(TrinoError, match="no CUDA device is available"):
        r._spawn_worker_process()
