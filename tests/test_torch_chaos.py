"""Seeded chaos of the torch engine's multi-process runtime, part one:
the TASK and the streaming QUERY policies.

The cases of tests/test_chaos.py that run on its ``task_cluster``
(retry_policy=TASK over the spooled barrier shape) and its
``stream_cluster`` (retry_policy=QUERY, streaming), under the same
``FaultSchedule``s (seed 42, the same task-id patterns), each with the
JAX case's assertions: kill-worker under TASK (q1, q3, during a
partitioned spill join) and under streaming QUERY, fail-after-publish,
truncate-spool, a straggler's speculative re-dispatch, a USER error
never retried (TASK and streaming), the deadline, replacement with
replica re-sync, EXPLAIN ANALYZE's Recovery line, kill-after-publish
served from the spool, one and repeated RPC drops mid-frame on the
streaming pull, the listener events, and the spool's loud corruption.
Clean runs equal the JAX engine's ``LocalQueryRunner``; every runner is
on ``device="cpu"``; both engines' history stores, profilers and sizing
histories in this process are cleared around every case. The
barrier/QUERY, memory and elastic cases are in test_torch_chaos_2.py.
"""

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
from trino_tpu_torch.types import TrinoError

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


class _Recorder(EventListener):
    def __init__(self):
        self.replaced = []
        self.retries = []

    def worker_replaced(self, event):
        self.replaced.append(event)

    def task_retry(self, event):
        self.retries.append(event)


RECORDER = _Recorder()


@pytest.fixture(scope="module")
def task_cluster():
    """retry_policy=TASK over the spooled barrier shape: retry-from-spool,
    speculation, replacement. Speculation is off except in the straggler
    case (a cold replacement's first task must not let a speculative win
    rescue a faulted task before the task-retry path runs)."""
    s = _mk_session(streaming_execution=False, retry_policy="TASK",
                    speculative_execution_enabled=False,
                    speculation_min_seconds=0.3)
    with ProcessQueryRunner(CATALOGS, s, n_workers=2, desired_splits=4,
                            broadcast_threshold=300.0,
                            heartbeat_interval=0.25,
                            event_listeners=[RECORDER],
                            device="cpu") as c:
        c.fault_schedule = FaultSchedule(seed=42)
        yield c


@pytest.fixture(scope="module")
def stream_cluster():
    """retry_policy=QUERY, streaming on: outputs are not durable, every
    fault recovers via full-query retry."""
    s = _mk_session(retry_policy="QUERY")
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


def test_task_clean_baselines(local, task_cluster):
    """Fault-free anchors (also warms the per-cluster compile caches so
    later straggler medians are tight)."""
    c = task_cluster
    c._q1_clean = sorted(c.execute(Q1).rows)
    c._q3_clean = c.execute(Q3).rows
    assert c._q1_clean == sorted(local.execute(Q1).rows)
    assert c._q3_clean == local.execute(Q3).rows


def test_kill_worker_mid_query_task_policy(task_cluster):
    """THE acceptance scenario: a seeded FaultSchedule kills a worker
    mid-query under TASK policy — correct results, completed producer
    stages NOT re-run (task_launches), all recovery inside attempt 0,
    and the replacement worker serves the next query."""
    c = task_cluster
    _await_capacity(c)
    qid = _next_qid(c)
    c.fault_schedule.add(f"{qid}.f1", "kill-worker")
    mark = len(c.task_launches)
    res = c.execute(Q1)
    assert sorted(res.rows) == c._q1_clean
    launches = _launches_since(c, mark)
    assert all("a0." in t for t in launches), launches
    f0 = [t for t in launches if f"{qid}.f0." in t]
    f1 = [t for t in launches if f"{qid}.f1." in t]
    assert len(f0) == 2, f"producer stage re-ran: {f0}"
    assert len(f1) == 3, f"expected exactly one retried task: {f1}"
    rec = res.stats["recovery"]
    assert rec["task_retries"] == 1
    assert rec["retries_by_type"].get("EXTERNAL") == 1
    assert rec["query_retries"] == 0
    # self-healing: the killed slot comes back and serves queries
    _await_capacity(c)
    assert sorted(c.execute(Q1).rows) == c._q1_clean


def test_kill_worker_q3_join_task_policy(task_cluster):
    """Same fault against the join+TopN pipeline (more fragments, merge
    output): recovery stays inside attempt 0."""
    c = task_cluster
    _await_capacity(c)
    qid = _next_qid(c)
    c.fault_schedule.add(f"{qid}.f1", "kill-worker")
    mark = len(c.task_launches)
    res = c.execute(Q3)
    assert res.rows == c._q3_clean
    launches = _launches_since(c, mark)
    assert all("a0." in t for t in launches), launches
    _await_capacity(c)


def test_fail_after_spool_publish_first_publish_wins(task_cluster):
    """A task that fails AFTER publishing its spool output retries; the
    duplicate publish is discarded (first-publish-wins hard link) and
    results stay exact."""
    c = task_cluster
    _await_capacity(c)
    qid = _next_qid(c)
    c.fault_schedule.add(f"{qid}.f0", "fail-after-publish")
    mark = len(c.task_launches)
    res = c.execute(Q1)
    assert sorted(res.rows) == c._q1_clean
    launches = _launches_since(c, mark)
    assert all("a0." in t for t in launches), launches
    assert any(".r1" in t for t in launches
               if f"{qid}.f0." in t), launches
    assert res.stats["recovery"]["retries_by_type"].get("INTERNAL") == 1


def test_truncate_spool_frame_query_retry(task_cluster):
    """A torn spool file must fail loudly (never partial rows); a task
    retry re-reads the same bytes, so recovery comes from the QUERY
    retry rebuilding the exchange under a fresh attempt id."""
    c = task_cluster
    _await_capacity(c)
    qid = _next_qid(c)
    c.fault_schedule.add(f"{qid}.f0", "truncate-spool")
    mark = len(c.task_launches)
    res = c.execute(Q1)
    assert sorted(res.rows) == c._q1_clean
    launches = _launches_since(c, mark)
    assert any("a1." in t for t in launches), launches
    assert res.stats["recovery"]["query_retries"] >= 1


def test_straggler_speculative_redispatch(task_cluster):
    """A task delayed far past its sibling's median is re-dispatched on
    another worker; the speculative attempt wins and the query never
    waits out the straggler's full delay."""
    c = task_cluster
    _await_capacity(c)
    qid = _next_qid(c)
    c.fault_schedule.add(f"{qid}.f0", "delay", delay_s=4.0)
    mark = len(c.task_launches)
    c.session.properties["speculative_execution_enabled"] = True
    try:
        res = c.execute(Q1)
    finally:
        c.session.properties["speculative_execution_enabled"] = False
    assert sorted(res.rows) == c._q1_clean
    launches = _launches_since(c, mark)
    assert any(t.endswith(".spec") for t in launches), launches
    rec = res.stats["recovery"]
    assert rec["speculative_launched"] >= 1
    assert rec["speculative_wins"] >= 1
    assert rec["query_retries"] == 0
    assert all("a0." in t for t in launches), launches


def test_user_error_is_never_retried(task_cluster):
    """A USER-typed failure (deterministic) fails the query fast: zero
    task retries, zero query retries, and the TrinoError names the real
    remote failure including its traceback."""
    c = task_cluster
    _await_capacity(c)
    qid = _next_qid(c)
    c.fault_schedule.add(f"{qid}.f0", "user-error")
    mark = len(c.task_launches)
    before = (c.recovery_total.task_retries,
              c.recovery_total.query_retries)
    with pytest.raises(TrinoError) as ei:
        c.execute(Q1)
    assert ei.value.code == "DIVISION_BY_ZERO"
    assert "injected user error" in str(ei.value)
    assert "remote traceback" in str(ei.value)
    launches = _launches_since(c, mark)
    assert not any(".r1" in t or ".spec" in t or "a1." in t
                   for t in launches), launches
    assert (c.recovery_total.task_retries,
            c.recovery_total.query_retries) == before


def test_query_deadline_enforced_as_user_error(task_cluster):
    """query_max_run_time caps the query across all RPCs and raises
    EXCEEDED_TIME_LIMIT — classified USER, so no retry burns the
    remaining budget on a doomed query."""
    c = task_cluster
    _await_capacity(c)
    mark = len(c.task_launches)
    c.session.properties["query_max_run_time"] = 0.001
    try:
        with pytest.raises(TrinoError) as ei:
            c.execute(Q1)
    finally:
        del c.session.properties["query_max_run_time"]
    assert ei.value.code == "EXCEEDED_TIME_LIMIT"
    launches = _launches_since(c, mark)
    assert not any("a1." in t for t in launches), launches


def test_worker_replacement_resyncs_replicated_tables(task_cluster):
    """Replacement is a full re-register: the new process receives the
    replicated memory-catalog tables, so distributed scans of local
    replicas stay correct after the swap."""
    c = task_cluster
    _await_capacity(c)
    c.execute("create table memory.default.chaos_t as "
              "select n_nationkey k, n_name from tpch.micro.nation")
    victim = c.workers[0]
    victim.proc.kill()
    victim.proc.wait(timeout=10)
    _await_capacity(c)
    assert c.workers[0].proc.pid != victim.proc.pid
    res = c.execute("select count(*) from memory.default.chaos_t")
    assert res.rows == [(25,)]
    c.execute("drop table memory.default.chaos_t")


def test_explain_analyze_surfaces_recovery(task_cluster):
    """EXPLAIN ANALYZE on the process runner renders the recovery
    counters (attempts, retries by type, backoff) for a faulted run."""
    c = task_cluster
    _await_capacity(c)
    qid = _next_qid(c)
    c.fault_schedule.add(f"{qid}.f1", "error")
    res = c.execute("explain analyze " + Q1)
    text = "\n".join(r[0] for r in res.rows)
    assert "Recovery:" in text, text
    assert "task retries" in text
    assert "INTERNAL=1" in text


def test_kill_worker_during_partitioned_spill_join(task_cluster):
    """kill-worker lands while the join stage is running partitioned
    (a revoke-memory fault demoted build partitions first): TASK
    policy recovers inside attempt 0 and the answer stays byte-equal
    to the fault-free oracle."""
    c = task_cluster
    _await_capacity(c)
    clean = getattr(c, "_q3_clean", None) or c.execute(Q3).rows
    qid = _next_qid(c)
    c.fault_schedule.add(f"{qid}.", "revoke-memory", times=16,
                         countdown=2)
    c.fault_schedule.add(f"{qid}.f1", "kill-worker")
    mark = len(c.task_launches)
    res = c.execute(Q3)
    assert res.rows == clean
    launches = _launches_since(c, mark)
    assert all("a0." in t for t in launches), launches
    rec = res.stats["recovery"]
    assert rec["query_retries"] == 0
    _await_capacity(c)


def test_kill_after_publish_served_from_spool(task_cluster):
    """A worker dies right AFTER durably publishing a task's output:
    the output outlives the process — the coordinator adopts the
    published spool bytes instead of relaunching the task (zero
    retries), and the dead slot heals in the background."""
    c = task_cluster
    _await_capacity(c)
    clean = getattr(c, "_q1_clean", None) or sorted(c.execute(Q1).rows)
    pids = sorted(w.proc.pid for w in c.workers)
    qid = _next_qid(c)
    c.fault_schedule.add(f"{qid}.f1", "kill-after-publish")
    mark = len(c.task_launches)
    res = c.execute(Q1)
    assert sorted(res.rows) == clean
    launches = _launches_since(c, mark)
    assert not any(".r1" in t for t in launches
                   if f"{qid}.f1." in t), launches
    rec = res.stats["recovery"]
    assert rec["task_retries"] == 0, rec
    assert rec["query_retries"] == 0, rec
    _await_capacity(c)
    # the fault really killed a process: one slot healed to a new pid
    assert sorted(w.proc.pid for w in c.workers) != pids


def test_chaos_events_recorded(task_cluster):
    """The event listener SPI observed the module's self-healing:
    replacements and typed retries fanned out to listeners."""
    assert any(e.new_pid != e.old_pid for e in RECORDER.replaced)
    assert any(e.error_type == "EXTERNAL" for e in RECORDER.retries)
    assert any(e.speculative for e in RECORDER.retries)


def test_kill_worker_streaming_query_retry(local, stream_cluster):
    """Streaming outputs are not durable: a killed worker loses them,
    the query retries wholesale on the healed cluster, answers stay
    exact."""
    c = stream_cluster
    clean = sorted(c.execute(Q1).rows)
    assert clean == sorted(local.execute(Q1).rows)
    qid = _next_qid(c)
    c.fault_schedule.add(f"{qid}.f0", "kill-worker")
    mark = len(c.task_launches)
    res = c.execute(Q1)
    assert sorted(res.rows) == clean
    launches = _launches_since(c, mark)
    assert any("a1." in t for t in launches), launches
    assert res.stats["recovery"]["query_retries"] >= 1
    _await_capacity(c)


def test_rpc_drop_streaming_replays_in_place(stream_cluster):
    """A mid-frame drop on the streaming pull RECOVERS IN PLACE: the
    producer retains unacked frames (_RetainedStream), so the channel
    reconnects and replays them byte-identically from its cursor — zero
    full-query restarts for a single dropped connection, identical
    attempt shape to the fault-free run."""
    c = stream_cluster
    _await_capacity(c)
    mark0 = len(c.task_launches)
    clean = sorted(c.execute(Q1).rows)
    clean_count = len(c.task_launches) - mark0
    qid = _next_qid(c)
    c.fault_schedule.add(f"{qid}.f0", "drop-connection")
    mark = len(c.task_launches)
    res = c.execute(Q1)
    assert sorted(res.rows) == clean
    assert res.stats["recovery"]["query_retries"] == 0
    launches = _launches_since(c, mark)
    assert len(launches) == clean_count, (launches, clean_count)
    assert not any("a1." in t for t in launches), launches


def test_rpc_drop_streaming_repeated_drops_still_replay(stream_cluster):
    """Several torn connections across the query's streaming pulls
    (one drop per producer task, on both fragments) all replay in
    place — drops on independent streams never accumulate toward any
    shared budget or escalate to a query retry."""
    c = stream_cluster
    _await_capacity(c)
    clean = sorted(c.execute(Q3).rows)
    qid = _next_qid(c)
    c.fault_schedule.add(f"{qid}.f0", "drop-connection", times=2)
    c.fault_schedule.add(f"{qid}.f1", "drop-connection")
    res = c.execute(Q3)
    assert sorted(res.rows) == clean
    assert res.stats["recovery"]["query_retries"] == 0


def test_user_error_fails_fast_streaming(stream_cluster):
    """The taxonomy propagates transitively through streaming pulls:
    a USER error in a mid-plan task surfaces as the original error with
    zero query retries."""
    c = stream_cluster
    _await_capacity(c)
    qid = _next_qid(c)
    c.fault_schedule.add(f"{qid}.f0", "user-error")
    mark = len(c.task_launches)
    with pytest.raises(TrinoError) as ei:
        c.execute(Q1)
    assert ei.value.code == "DIVISION_BY_ZERO"
    assert "injected user error" in str(ei.value)
    launches = _launches_since(c, mark)
    assert not any("a1." in t for t in launches), launches


def test_stream_spool_corruption_is_loud_and_typed():
    """A corrupted committed spool object fails the reader with the
    typed SpoolCorruption — short reads and checksum mismatches never
    surface as silently-partial rows."""
    import os

    from trino_tpu_torch import types as T
    from trino_tpu_torch.block import Page
    from trino_tpu_torch.parallel.spool import SpoolCorruption
    from trino_tpu_torch.parallel.spool_backend import (
        LocalFileSpoolBackend, SpooledTaskWriter, committed_attempt,
        open_committed_partition, partition_key)

    be = LocalFileSpoolBackend()
    try:
        w = SpooledTaskWriter(be, "qx", 0, 0, 0, 1)
        w.add(0, Page.from_pylists([T.BIGINT, T.VARCHAR],
                                   [[1, 2], ["a", "b"]]))
        assert w.commit()
        assert committed_attempt(be, "qx", 0, 0) == 0
        path = os.path.join(be.base_dir,
                            partition_key("qx", 0, 0, 0, 0))
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 3)
        with pytest.raises(SpoolCorruption):
            open_committed_partition(be, "qx", 0, 0, 0).pages()
    finally:
        be.remove_all()
