"""Seeded chaos of the torch engine's multi-process runtime, part two:
barrier QUERY retry, memory governance and the elastic cluster.

The cases of tests/test_chaos.py that run on its ``barrier_cluster``
(retry_policy=QUERY, streaming off) and ``elastic_cluster``
(partial_stage_retry over streaming), and its in-process barrier-driver
case, under the same ``FaultSchedule``s, each with the JAX case's
assertions: an RPC drop mid-frame recovered in place, memory escalation
(a grown budget and a halved width), the low-memory killer's policy
victim, the heartbeat's pool snapshots, revoke-memory mid-build and
mid-probe of the hybrid join, the barrier driver's abort at page
boundaries, partial retry of only the lost tasks (q1 and the join
pipeline), scale-down mid-query (streaming and barrier), membership churn
racing the heal, the sizing seed shipped to a joining worker and
``system.runtime.nodes``. Clean runs equal the JAX engine's
``LocalQueryRunner``; every runner is on ``device="cpu"``; both engines'
history stores, profilers and sizing histories in this process are
cleared around every case.
"""

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
from trino_tpu_torch.events import EventListener
from trino_tpu_torch.parallel import ProcessQueryRunner
from trino_tpu_torch.parallel import device_exchange as pde
from trino_tpu_torch.parallel.fault import FaultSchedule
from trino_tpu_torch.sql.analyzer import Session
from trino_tpu_torch.telemetry import profiler as pprof
from trino_tpu_torch.telemetry import stats_store as pss

CATALOGS = {"tpch": {"connector": "tpch", "page_rows": 4096},
            "memory": {"connector": "memory"}}
Q1 = ("select l_returnflag, l_linestatus, count(*), sum(l_quantity) "
      "from lineitem group by l_returnflag, l_linestatus")
Q3 = TPCH_QUERIES[3]


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


def _mk_session(**props):
    s = Session(catalog="tpch", schema="micro")
    s.properties.update({"retry_initial_backoff": 0.02,
                         "retry_max_backoff": 0.2, **props})
    return s


@pytest.fixture(scope="module")
def local():
    """The JAX engine's local runner: the oracle of every clean run."""
    return JLocal({"tpch": JTpch(page_rows=4096)},
                  JSession(catalog="tpch", schema="micro"))


@pytest.fixture(scope="module")
def barrier_cluster():
    """retry_policy=QUERY, streaming off: barrier stages whose results
    are pulled over get_results."""
    s = _mk_session(streaming_execution=False, retry_policy="QUERY")
    with ProcessQueryRunner(CATALOGS, s, n_workers=2, desired_splits=4,
                            broadcast_threshold=300.0,
                            heartbeat_interval=0.25,
                            device="cpu") as c:
        c.fault_schedule = FaultSchedule(seed=42)
        yield c


def _await_capacity(c, timeout=90):
    """Wait for self-healing to restore every worker slot."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if all(c.heal()):
            return
        time.sleep(0.1)
    raise AssertionError(f"cluster never healed: {c.heartbeat()}")


def _next_qid(c):
    return f"q{c._task_seq + 1}a0"


def _launches_since(c, mark):
    return c.task_launches[mark:]


def test_rpc_drop_mid_frame_recovers_in_place(local, barrier_cluster):
    """A connection torn mid-frame during a result pull is retried at
    the transport layer (each get_results response is an independent
    snapshot): NO task relaunch, NO query retry — zero extra launches
    vs the fault-free run."""
    c = barrier_cluster
    mark0 = len(c.task_launches)
    clean = sorted(c.execute(Q1).rows)
    assert clean == sorted(local.execute(Q1).rows)
    clean_count = len(c.task_launches) - mark0
    qid = _next_qid(c)
    c.fault_schedule.add(f"{qid}.f1", "drop-connection")
    mark = len(c.task_launches)
    res = c.execute(Q1)
    assert sorted(res.rows) == clean
    launches = _launches_since(c, mark)
    # identical attempt shape to the fault-free run: no silent
    # double-launch anywhere
    assert len(launches) == clean_count, (launches, clean_count)
    assert not any(".r1" in t or "a1." in t for t in launches), launches
    assert res.stats["recovery"]["retries_by_type"].get(
        "EXTERNAL", 0) >= 1
    assert res.stats["recovery"]["query_retries"] == 0


def test_memory_escalation_retry(barrier_cluster):
    """THE memory-governance acceptance path: an attempt that dies with
    INSUFFICIENT_RESOURCES (per-query cap far below the working set)
    re-admits with a GROWN budget — max(retry_initial_memory, 2x the
    observed peak the worker piggybacked on its failure response) — and
    a halved task width, instead of replaying the identical doomed
    plan."""
    c = barrier_cluster
    _await_capacity(c)
    clean = sorted(c.execute(Q1).rows)
    saved = dict(c.session.properties)
    c.session.properties.update({"query_max_memory_bytes": 60_000,
                                 "retry_initial_memory": 1 << 30})
    mark = len(c.task_launches)
    try:
        res = c.execute(Q1)
    finally:
        c.session.properties.clear()
        c.session.properties.update(saved)
    assert sorted(res.rows) == clean
    rec = res.stats["recovery"]
    assert rec["memory_escalations"] >= 1
    assert rec["retries_by_type"].get("INSUFFICIENT_RESOURCES", 0) >= 1
    launches = _launches_since(c, mark)
    # width reduction: the escalated attempt (a1) runs its partitioned
    # fragments at half width -> no .t1 tasks
    a1 = [t for t in launches if "a1." in t]
    assert a1, launches
    assert not any(".t1" in t for t in a1), a1
    # the configured session must come back untouched (overrides are
    # per-attempt state, not global mutation)
    assert c.session.properties == saved


def test_low_memory_killer_kills_policy_victim(barrier_cluster):
    """Cluster-overcommit: with a blocked node attributing the largest
    reservation to the in-flight query, the governance tick kills
    exactly the policy-chosen victim (EXCEEDED_CLUSTER_MEMORY); the
    victim then SUCCEEDS on retry while a concurrent query finishes
    unharmed."""
    from trino_tpu_torch.events import EventListener

    class KillRecorder(EventListener):
        def __init__(self):
            self.kills = []

        def memory_kill(self, event):
            self.kills.append(event)

    c = barrier_cluster
    _await_capacity(c)
    rec = KillRecorder()
    c.event_manager.add(rec)
    clean = sorted(c.execute(Q1).rows)
    victim_qid = _next_qid(c)
    # slow the victim's scan tasks so the kill window is open
    c.fault_schedule.add(f"{victim_qid}.f1", "delay", times=2,
                         delay_s=1.5)
    results = {}

    def run_victim():
        results["victim"] = sorted(c.execute(Q1).rows)

    th = threading.Thread(target=run_victim, daemon=True)
    th.start()
    time.sleep(0.4)  # victim tasks are now sleeping in their delay
    # a blocked node reports the victim attempt as its largest holder
    # (synthetic worker id: real heartbeats never overwrite it)
    c.cluster_memory.update(99, {
        "max_bytes": 1000, "reserved_bytes": 1000, "blocked_events": 1,
        "queries": {victim_qid: {"reserved": 900, "peak": 900},
                    "tiny_q": {"reserved": 100, "peak": 100}}})
    assert c.run_memory_governance() == victim_qid
    # a concurrent query sails through while the victim is dying
    assert sorted(c.execute(Q1).rows) == clean
    th.join(timeout=60)
    assert not th.is_alive()
    c.cluster_memory.forget_worker(99)
    assert results["victim"] == clean
    assert [e.query_id for e in rec.kills] == [victim_qid]
    assert rec.kills[0].policy == "total-reservation-on-blocked-nodes"


def test_barrier_driver_observes_abort_at_page_boundaries():
    """The kill path's lever INSIDE a worker: a barrier (non-streaming)
    task polls its abort flag at every page-move quantum, so an
    abort_task broadcast (low-memory kill, superseded attempt) stops
    the driver mid-execution — not after it drained its pipeline."""
    from trino_tpu_torch.parallel.fault import RemoteTaskError
    from trino_tpu_torch.parallel.remote_exchange import run_barrier_driver

    class Driver:
        def __init__(self, finish_at=None, abort=None, abort_at=None):
            self.quanta = 0
            self._finish_at = finish_at
            self._abort = abort
            self._abort_at = abort_at

        def process(self):
            self.quanta += 1
            if self._abort_at == self.quanta:
                self._abort.set()
            return self._finish_at == self.quanta

    # pre-set abort: not a single page moves
    d = Driver()
    with pytest.raises(RemoteTaskError):
        run_barrier_driver(d, _set_event())
    assert d.quanta == 0
    # abort lands mid-run: observed at the NEXT page boundary
    ev = threading.Event()
    d = Driver(abort=ev, abort_at=7)
    with pytest.raises(RemoteTaskError):
        run_barrier_driver(d, ev)
    assert d.quanta == 7
    # flag never set: the driver runs to completion untouched
    d = Driver(finish_at=3)
    run_barrier_driver(d, threading.Event())
    assert d.quanta == 3
    # a driver that can NEVER finish still terminates (stuck-pipeline
    # bound), it does not spin the worker thread forever
    with pytest.raises(RemoteTaskError):
        run_barrier_driver(Driver(), threading.Event(), max_quanta=100)


def _set_event():
    ev = threading.Event()
    ev.set()
    return ev


def test_heartbeat_piggybacks_pool_snapshots(barrier_cluster):
    """Stats parity: what the ClusterMemoryManager aggregated from the
    heartbeat must equal what the workers report when asked directly."""
    from trino_tpu_torch.parallel.rpc import call

    c = barrier_cluster
    _await_capacity(c)
    c.execute(Q1)
    c.heartbeat()
    stats = c.cluster_memory.cluster_stats()
    direct = []
    for w in c.workers:
        resp = call(w.addr, {"op": "ping"}, timeout=10)
        assert resp.get("memory") is not None
        direct.append(resp["memory"])
    assert stats["workers"] == len(c.workers)
    assert stats["total_max_bytes"] == sum(m["max_bytes"]
                                           for m in direct)
    # per-query peaks flowed through: the finished query left its peak
    # in some worker's released-peaks section
    peaks = [q["peak"] for m in direct
             for q in m.get("queries", {}).values()]
    assert any(p > 0 for p in peaks)
    # EXPLAIN ANALYZE surfaces the cluster view
    res = c.execute("explain analyze " + Q1)
    text = "\n".join(r[0] for r in res.rows)
    assert "Cluster memory:" in text


def _spill_records():
    """Hybrid-join spill records currently in the coordinator's HBO
    store (worker demotions ride task responses into it — the witness
    that a fault actually demoted build partitions, not just fired)."""
    from trino_tpu_torch.telemetry import stats_store

    st = stats_store.store()
    with st._lock:
        return [h.spill for s in st._stmts.values()
                for h in s["nodes"].values() if h.spill is not None]


def test_revoke_memory_mid_build_hybrid_join(barrier_cluster):
    """A seeded revoke-memory fault forces a full pool revocation
    early in the join stage (mid-BUILD): the builder enters
    partitioned mode and demotes partitions in place — the query
    completes byte-equal with ZERO retries of any kind."""
    c = barrier_cluster
    _await_capacity(c)
    clean = c.execute(Q3).rows
    before = len(_spill_records())
    qid = _next_qid(c)
    c.fault_schedule.add(f"{qid}.", "revoke-memory", times=16,
                         countdown=2)
    res = c.execute(Q3)
    assert res.rows == clean
    rec = res.stats["recovery"]
    assert rec["query_retries"] == 0, rec
    assert rec["task_retries"] == 0, rec
    assert len(_spill_records()) > before, \
        "no partition demotion reached the coordinator's history store"


def test_revoke_memory_mid_probe_hybrid_join(barrier_cluster):
    """Same fault armed DEEP into the task (mid-PROBE / downstream):
    cold probe rows park beside their build partition and replay in
    the deferred per-partition passes — still byte-equal, still zero
    retries."""
    c = barrier_cluster
    _await_capacity(c)
    clean = c.execute(Q3).rows
    qid = _next_qid(c)
    c.fault_schedule.add(f"{qid}.", "revoke-memory", times=16,
                         countdown=24)
    res = c.execute(Q3)
    assert res.rows == clean
    rec = res.stats["recovery"]
    assert rec["query_retries"] == 0, rec
    assert rec["task_retries"] == 0, rec


@pytest.fixture(scope="module")
def elastic_cluster():
    """partial_stage_retry over the default streaming shape: producers
    retain their serialized frames (durable streams), tee pages into
    the external spool backend, and consumers resolve lost producers
    through the coordinator's resolve_task op — the elastic-cluster
    fault model where task output outlives its worker."""
    s = _mk_session(retry_policy="QUERY", partial_stage_retry=True)
    with ProcessQueryRunner(CATALOGS, s, n_workers=2, desired_splits=4,
                            broadcast_threshold=300.0,
                            heartbeat_interval=0.25,
                            device="cpu") as c:
        c.fault_schedule = FaultSchedule(seed=42)
        yield c


def test_partial_retry_restarts_only_lost_tasks(local, elastic_cluster):
    """THE acceptance scenario: a producer-task worker dies mid-stream
    during a multi-stage streaming query. ONLY the lost tasks restart
    (same wire ids, ``.r1`` markers), consumers resume from their ack
    cursors, results stay byte-equal, and the query-retry counter stays
    at ZERO — no wholesale re-execution."""
    c = elastic_cluster
    clean = sorted(c.execute(Q1).rows)
    assert clean == sorted(local.execute(Q1).rows)
    qid = _next_qid(c)
    c.fault_schedule.add(f"{qid}.f1", "kill-worker")
    mark = len(c.task_launches)
    res = c.execute(Q1)
    assert sorted(res.rows) == clean
    rec = res.stats["recovery"]
    assert rec["query_retries"] == 0, rec
    launches = _launches_since(c, mark)
    assert not any("a1." in t for t in launches), launches
    assert any(".r1" in t for t in launches), launches
    _await_capacity(c)
    assert sorted(c.execute(Q1).rows) == clean


def test_partial_retry_join_pipeline(elastic_cluster):
    """Same fault against the join+TopN pipeline (4 fragments, merge
    output): the resolve cascade repoints merge channels too, still
    zero query retries, still byte-equal."""
    c = elastic_cluster
    _await_capacity(c)
    clean = c.execute(Q3).rows
    qid = _next_qid(c)
    c.fault_schedule.add(f"{qid}.f1", "kill-worker")
    res = c.execute(Q3)
    assert res.rows == clean
    assert res.stats["recovery"]["query_retries"] == 0
    _await_capacity(c)


def test_scale_down_mid_query_streaming(elastic_cluster):
    """retire_worker(drain=True) while a streaming query runs: the
    slot drains (finishes its tasks) before the process dies, the
    in-flight query loses nothing, and the shrunk cluster keeps
    answering correctly."""
    c = elastic_cluster
    _await_capacity(c)
    clean = sorted(c.execute(Q1).rows)
    assert c.add_workers(1, reason="test-grow") == 1
    results = {}

    def run_q():
        results["r"] = c.execute(Q1)

    th = threading.Thread(target=run_q, daemon=True)
    th.start()
    time.sleep(0.05)
    assert c.retire_worker(len(c.workers) - 1, drain=True, timeout=60)
    th.join(timeout=60)
    assert not th.is_alive()
    assert sorted(results["r"].rows) == clean
    assert results["r"].stats["recovery"]["query_retries"] == 0
    assert len(c.workers) == 2
    assert sorted(c.execute(Q1).rows) == clean


def test_scale_down_mid_query_barrier(elastic_cluster):
    """Drain-based retire under the barrier shape: stage results on the
    draining worker are pulled before it exits — loss-free, zero
    retries of any kind."""
    c = elastic_cluster
    _await_capacity(c)
    saved = dict(c.session.properties)
    c.session.properties["streaming_execution"] = False
    try:
        clean = sorted(c.execute(Q1).rows)
        assert c.add_workers(1, reason="test-grow") == 1
        results = {}

        def run_q():
            results["r"] = c.execute(Q1)

        th = threading.Thread(target=run_q, daemon=True)
        th.start()
        time.sleep(0.05)
        assert c.retire_worker(len(c.workers) - 1, drain=True,
                               timeout=60)
        th.join(timeout=60)
        assert not th.is_alive()
    finally:
        c.session.properties.clear()
        c.session.properties.update(saved)
    assert sorted(results["r"].rows) == clean
    # a stage launch may race the retire onto the dying slot; the
    # lost-worker seam absorbs it as a task retry — never a query retry
    assert results["r"].stats["recovery"]["query_retries"] == 0
    assert len(c.workers) == 2


def test_membership_churn_races_heal(elastic_cluster):
    """A worker dies the moment the membership is also growing: the
    heal loop replaces the dead slot while add_workers registers a new
    one — no lost slots, no double-registration, queries stay exact,
    and the ledger recorded every transition."""
    c = elastic_cluster
    _await_capacity(c)
    clean = sorted(c.execute(Q1).rows)
    joined_before, retired_before = c.cluster.counts()
    victim = c.workers[0]
    victim.proc.kill()
    assert c.add_workers(1, reason="churn") == 1
    _await_capacity(c)
    assert sorted(c.execute(Q1).rows) == clean
    assert c.retire_worker(len(c.workers) - 1, drain=True, timeout=60)
    assert len(c.workers) == 2
    joined, retired = c.cluster.counts()
    assert joined >= joined_before + 2   # churn join + heal replacement
    assert retired >= retired_before + 2  # killed slot + drained retire
    active = [n for n in c.cluster.snapshot() if n.state == "active"]
    assert len(active) == len(c.workers)


def test_sizing_seed_ships_to_joining_worker(elastic_cluster):
    """Exchange-sizing knowledge crosses the membership boundary: a
    joining worker is configured with the coordinator's merged sizing
    history and acknowledges how many entries it imported."""
    from trino_tpu_torch.parallel.device_exchange import SIZING_HISTORY

    c = elastic_cluster
    _await_capacity(c)
    SIZING_HISTORY.import_seed(
        [[[["bigint"], "chaos-synthetic", 2, 4], 321.0, 3, None]])
    assert c.add_workers(1, reason="seed-test") == 1
    try:
        assert c.workers[-1].sizing_seeded >= 1
    finally:
        assert c.retire_worker(len(c.workers) - 1, drain=True,
                               timeout=60)
    assert len(c.workers) == 2


def test_system_runtime_nodes_reflects_ledger(elastic_cluster):
    """system.runtime.nodes is the SQL view of the membership ledger:
    one ACTIVE row per live slot, RETIRED rows for everything the
    module churned through, generations monotonic."""
    c = elastic_cluster
    _await_capacity(c)
    rows = c.execute(
        "select node_id, address, state, pid, generation "
        "from system.runtime.nodes").rows
    active = [r for r in rows if r[2] == "ACTIVE"]
    assert len(active) == len(c.workers)
    live_pids = {w.proc.pid for w in c.workers}
    assert {r[3] for r in active} == live_pids
    assert any(r[2] == "RETIRED" for r in rows)
    gens = [r[4] for r in rows]
    assert gens == sorted(gens)
    # elastic metrics families are registered alongside
    fams = {f["name"] for f in c.metrics_families()}
    assert {"trino_cluster_size", "trino_nodes_total",
            "trino_autoscaler_target_workers"} <= fams
