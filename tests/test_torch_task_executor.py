"""TaskExecutor of the torch engine: cooperative quanta, multilevel
feedback, concurrent query time-sharing — the cases of
tests/test_task_executor.py against ``trino_tpu_torch.exec.task_executor``
(a copy of the JAX engine's host module); the concurrent queries run
through the port's DistributedQueryRunner on the CPU and return the JAX
engine's rows."""

import threading
import time

import pytest

from trino_tpu.connectors.tpch import TpchConnector as JTpch
from trino_tpu.parallel.distributed import DistributedQueryRunner as JDist
from trino_tpu.sql.analyzer import Session as JSession
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.exec.task_executor import (LEVEL_THRESHOLDS_S,
                                                MultilevelSplitQueue,
                                                TaskExecutor, _Entry)
from trino_tpu_torch.parallel import DistributedQueryRunner
from trino_tpu_torch.sql.analyzer import Session


def test_executor_runs_generators_to_completion():
    ex = TaskExecutor(num_threads=2, name="pt1")
    log = []

    def gen(tag, steps):
        for i in range(steps):
            log.append((tag, i))
            yield

    ex.run_all([gen("a", 5), gen("b", 3)], timeout=30)
    assert sorted(log) == [("a", i) for i in range(5)] \
        + [("b", i) for i in range(3)]
    ex.close()


def test_executor_propagates_errors():
    ex = TaskExecutor(num_threads=1, name="pt2")

    def boom():
        yield
        raise ValueError("kaput")

    with pytest.raises(ValueError, match="kaput"):
        ex.run_all([boom()], timeout=30)
    ex.close()


def test_executor_interleaves_tasks():
    """With ONE worker thread, a long task must not starve a short one:
    steps of both tasks interleave through the queue."""
    ex = TaskExecutor(num_threads=1, name="pt3")
    order = []

    def gen(tag, steps):
        for _ in range(steps):
            order.append(tag)
            yield

    ex.run_all([gen("long", 40), gen("short", 3)], timeout=30)
    last_short = max(i for i, t in enumerate(order) if t == "short")
    assert last_short < len(order) - 1
    ex.close()


def test_level_assignment():
    e = _Entry(iter(()))
    assert e.level == 0
    e.scheduled_ns = int(LEVEL_THRESHOLDS_S[2] * 1e9) + 1
    assert e.level == 2
    e.scheduled_ns = int(LEVEL_THRESHOLDS_S[4] * 1e9) + 1
    assert e.level == 4


def test_queue_weighted_pick_never_starves_deep_levels():
    q = MultilevelSplitQueue()
    deep = []
    for _ in range(40):
        q.offer(_Entry(iter(())))
    for _ in range(5):
        e = _Entry(iter(()))
        e.scheduled_ns = int(400e9)  # level 4
        q.offer(e)
        deep.append(e)
    taken = [q.take() for _ in range(45)]
    # the deep entries all surface despite the shallow backlog
    assert all(d in taken for d in deep)
    q.close()
    assert q.take() is None


SQL = ("select l_shipmode, count(*) from lineitem "
       "group by l_shipmode order by l_shipmode")


def test_concurrent_queries_share_executor():
    conn = TpchConnector(page_rows=2048)
    runners = [DistributedQueryRunner(
        {"tpch": conn}, Session(catalog="tpch", schema="micro"),
        n_workers=2, desired_splits=4, broadcast_threshold=300.0,
        device="cpu") for _ in range(2)]
    results = [None, None]
    errors = []

    def go(i):
        try:
            results[i] = runners[i].execute(SQL).rows
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(2)]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors
    assert results[0] == results[1] and results[0]
    assert time.time() - t0 < 120
    want = JDist({"tpch": JTpch(page_rows=2048)},
                 JSession(catalog="tpch", schema="micro"), n_workers=2,
                 desired_splits=4, broadcast_threshold=300.0).execute(SQL)
    assert results[0] == want.rows
