"""The host's reads of device tensors (``telemetry.device_reads``): every
read goes through the helper, each is charged where it was made, the
intervals are kept only while a profiler records, and statements in
flight at once keep their own traces.

On the CPU no tensor is on a device, so the accounting is driven by
treating every tensor as a device tensor (the helper's ``_on_device``
check replaced for the test). The coverage test replaces the tensor
methods that read a tensor to the host and counts their calls from the
port's code outside the helper. The runs use the benchmark cell's
configuration (``sqlbench/configs/tpch_sf1_cluster4.json``: TPC-H in the
memory connector, joins PARTITIONED, four worker tasks) at SF 0.01.
"""

import collections
import os
import sys
import threading

import pytest
import torch

import trino_tpu_torch
from trino_tpu_torch.exec.driver import Driver
from trino_tpu_torch.ops.operator import Operator
from trino_tpu_torch.telemetry import device_reads
from trino_tpu_torch.telemetry.tracing import Tracer, add_driver_spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from sqlbench import data, system, workload  # noqa: E402

SF = 0.01
SEED = 2 ** 31 + 11
#: the benchmark's templates, with literals that select rows at SF 0.01
PARAMS = {"q1": {"DELTA": 90},
          "q3": {"SEGMENT": "BUILDING", "DATE": "1995-03-15"},
          "q6": {"DATE": "1994-01-01", "DISCOUNT": "0.06",
                 "QUANTITY": 24},
          "q18": {"QUANTITY": 250}}
#: the tensor methods through which the host reads a tensor
READ_METHODS = ("cpu", "item", "tolist", "numpy", "__array__", "__int__",
                "__bool__", "__float__", "__index__")
#: reads left out of the helper on purpose, by (file, function): none
EXEMPT = {}


def _sql(name):
    return workload.load_template(name).render(PARAMS[name])


@pytest.fixture(scope="module")
def db():
    cfg = workload.read_json(os.path.join(
        ROOT, "sqlbench", "configs", "tpch_sf1_cluster4.json"))
    return cfg, data.generate(cfg, SEED, SF)


def _runner(db, kind="distributed"):
    cfg, tables = db
    cfg = dict(cfg, runner={"kind": kind, **(
        {"n_workers": 4} if kind == "distributed" else {})})
    return system.make_runner(cfg, tables, "cpu")


class _RawReads:
    """Replaces ``READ_METHODS`` on ``torch.Tensor`` and counts, by
    (file, line, method), their calls made from the port's code outside
    the helper."""

    def __init__(self):
        self.found = collections.Counter()
        self._saved = {}

    def __enter__(self):
        pkg = os.path.dirname(os.path.abspath(trino_tpu_torch.__file__))
        helper = os.path.abspath(device_reads.__file__)
        found, lock = self.found, threading.Lock()

        def wrap(name, original):
            def method(self, *args, **kwargs):
                code = sys._getframe(1).f_code
                path = code.co_filename
                if path.startswith(pkg) and path != helper and \
                        (os.path.relpath(path, pkg), code.co_name) \
                        not in EXEMPT:
                    with lock:
                        found[(os.path.relpath(path, pkg),
                               sys._getframe(1).f_lineno, name)] += 1
                return original(self, *args, **kwargs)
            return method

        for name in READ_METHODS:
            self._saved[name] = torch.Tensor.__dict__.get(name)
            setattr(torch.Tensor, name,
                    wrap(name, getattr(torch.Tensor, name)))
        return self.found

    def __exit__(self, *exc):
        for name, original in self._saved.items():
            if original is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, original)
        return False


@pytest.mark.parametrize("kind", ["distributed", "local"])
def test_every_read_goes_through_the_helper(db, kind):
    """q1, q3, q6 and q18 through the runner make no read of a tensor
    outside ``device_reads`` (``EXEMPT`` names any left out, with its
    reason)."""
    runner = _runner(db, kind)
    with _RawReads() as found:
        for name in ("q1", "q3", "q6", "q18"):
            assert runner.execute(_sql(name)).rows is not None
    assert not found, sorted(found.items())


# -- the helper and its charge targets -------------------------------------


@pytest.fixture
def counted(monkeypatch):
    """Every tensor counts as a device tensor; the process's counters
    start at zero."""
    monkeypatch.setattr(device_reads, "_on_device", lambda t: True)
    device_reads.reset()
    yield
    device_reads.reset()


def test_a_cpu_tensor_is_no_device_read():
    device_reads.reset()
    t = torch.arange(6, dtype=torch.int64)
    assert device_reads.to_host(t, "test").tolist() == list(range(6))
    assert device_reads.to_cpu(t, "test") is t
    assert device_reads.host_scalar(t.sum(), "test") == 15
    assert device_reads.totals() == (0, 0, 0)


class _Reader(Operator):
    """A one-operator pipeline that reads ``t`` to the host once."""

    def __init__(self, t):
        self.t = t
        self.done = False

    def get_output(self):
        if not self.done:
            device_reads.to_cpu(self.t, "test.operator")
            self.done = True
        return None

    def is_finished(self):
        return self.done


def test_reads_are_charged_to_operator_task_statement(counted):
    """Inside an operator's call a read goes to its stats, else to the
    task whose quantum runs, else to the statement, else to the
    process's uncharged reads; the process tally counts each once."""
    t = torch.zeros(5, dtype=torch.int32)
    statement, task = device_reads.Reads(), device_reads.Reads()
    driver = Driver([_Reader(t)], collect_stats=True)

    def task_body():
        device_reads.host_scalar(t[0], "test.task")
        yield
        driver.run_to_completion()
        device_reads.to_host(t, "test.task")

    with device_reads.charging(statement):
        device_reads.to_host(t, "test.statement")
        assert list(device_reads.charged(task_body(), task)) == [None]
    device_reads.to_host(t[:2], "test.uncharged")
    op = driver.stats[0]
    assert (op.d2h_reads, op.d2h_bytes) == (1, 20)
    assert (task.d2h_reads, task.d2h_bytes) == (2, 24)
    assert (statement.d2h_reads, statement.d2h_bytes) == (1, 20)
    assert (device_reads.UNCHARGED.d2h_reads,
            device_reads.UNCHARGED.d2h_bytes) == (1, 8)
    reads, nbytes, wait = device_reads.totals()
    assert (reads, nbytes) == (5, 72)
    assert wait == sum(r.d2h_wait_ns for r in (
        op, task, statement, device_reads.UNCHARGED))
    assert device_reads.LOCAL.target is None
    assert op.cpu_ns > 0 and op.cpu_ns <= op.wall_ns + 1_000_000


def test_operator_span_and_line_carry_the_reads(counted):
    t = torch.zeros(1000, dtype=torch.float64)
    driver = Driver([_Reader(t)], collect_stats=True)
    driver.run_to_completion()
    tracer = Tracer()
    with tracer.span("task") as task:
        assert add_driver_spans(tracer, driver, task) == 1
    (span,) = [s for s in tracer.finished() if s["name"] == "_Reader"]
    a = span["attrs"]
    assert (a["d2h_reads"], a["d2h_bytes"]) == (1, 8000)
    assert a["d2h_wait_ms"] >= 0 and "cpu_ms" in a
    assert "calls" not in a and "reads" not in a
    assert "[reads 1, 0.008 MB, wait " in driver.stats[0].line()
    quiet = Driver([_Reader(t)], collect_stats=True)
    device_reads._on_device = lambda t: t.is_cuda
    quiet.run_to_completion()
    assert quiet.stats[0].d2h_reads == 0
    assert "[reads" not in quiet.stats[0].line()


# -- attribution over a statement ------------------------------------------


def _spans_of(res, kind=None):
    return [s for s in res.stats["trace"]
            if kind is None or s["attrs"].get("span_kind") == kind]


def test_statement_counters_sum_to_the_tally(db, counted):
    """Over a statement, the reads its operator, task and root spans
    carry sum to the helper's own tally of the process: none is dropped
    or charged twice."""
    runner = _runner(db)
    for name in ("q3", "q18"):
        runner.execute(_sql(name))  # settle the plan
        device_reads.reset()
        res = runner.execute(_sql(name))
        reads, nbytes, _ = device_reads.totals()
        assert device_reads.UNCHARGED.d2h_reads == 0
        spans = _spans_of(res)
        assert sum(s["attrs"].get("d2h_reads", 0) for s in spans) == reads
        assert sum(s["attrs"].get("d2h_bytes", 0) for s in spans) == nbytes
        by_kind = collections.Counter()
        for s in spans:
            by_kind[s["attrs"].get("span_kind")] += \
                s["attrs"].get("d2h_reads", 0)
        assert by_kind["operator"] > 0 and by_kind["task"] > 0, by_kind
        assert set(by_kind) <= {"operator", "task", None, "stage",
                                "statement"}
        assert by_kind["stage"] == by_kind["statement"] == 0


def test_explain_analyze_line_shows_the_reads(db, counted):
    runner = _runner(db)
    text = "\n".join(r[0] for r in runner.execute(
        "explain analyze " + _sql("q3")).rows)
    assert "[reads " in text and " MB, wait " in text
    device_reads._on_device = lambda t: t.is_cuda
    text = "\n".join(r[0] for r in runner.execute(
        "explain analyze " + _sql("q3")).rows)
    assert "[reads " not in text


def test_intervals_only_while_a_profiler_records(db, counted):
    """``calls`` and ``reads`` appear only while a torch.profiler session
    records, each call inside its operator's span (first call to last
    activity) and each of an operator's reads inside one of its calls."""
    from torch.profiler import ProfilerActivity, profile

    runner = _runner(db)
    sql = _sql("q3")
    res = runner.execute(sql)
    assert not any("calls" in s["attrs"] or "reads" in s["attrs"]
                   for s in _spans_of(res))
    with profile(activities=[ProfilerActivity.CPU]):
        res = runner.execute(sql)
    eps = 1e-6
    ops = _spans_of(res, "operator")
    assert ops and all(s["attrs"].get("calls") for s in ops)
    n_reads = 0
    for s in ops:
        a = s["attrs"]
        calls = a["calls"]
        for c0, c1 in calls:
            assert s["start"] - eps <= c0 <= c1 <= \
                a["last_activity"] + eps
        assert len(a.get("reads", ())) == a.get("d2h_reads", 0)
        for r0, r1, site, nbytes in a.get("reads", ()):
            n_reads += 1
            assert isinstance(site, str) and nbytes >= 0
            assert any(c0 - eps <= r0 <= r1 <= c1 + eps
                       for c0, c1 in calls)
    assert n_reads > 0
    by_id = {s["span_id"]: s for s in _spans_of(res)}
    for s in _spans_of(res, "task"):
        for r0, r1, _, _ in s["attrs"].get("reads", ()):
            assert s["start"] - eps <= r0 <= r1 <= s["end"] + eps
        assert by_id[s["parent_id"]]["attrs"]["span_kind"] == "stage"
    res = runner.execute(sql)
    assert not any("calls" in s["attrs"] or "reads" in s["attrs"]
                   for s in _spans_of(res))


# -- statements in flight at once ------------------------------------------


STATEMENT_SPANS = ["history", "parse", "plan", "results"]


def test_concurrent_statements_keep_their_own_traces(db):
    """q3 and q18 sent at once from two threads, three times: each
    statement's trace has one trace id of its own, the spans of its solo
    run (the statement spans among them) and no other, and its rows are
    the solo run's."""
    runner = _runner(db)
    sqls = {name: _sql(name) for name in ("q3", "q18")}
    solo = {}
    for _ in range(2):  # history settles each plan after its first run
        for name, sql in sqls.items():
            res = runner.execute(sql)
            solo[name] = (sorted(res.rows), len(res.stats["trace"]))
    for name, sql in sqls.items():
        res = runner.execute(sql)
        assert (sorted(res.rows), len(res.stats["trace"])) == solo[name]
        assert sorted(s["name"] for s in _spans_of(res, "statement")) == \
            STATEMENT_SPANS
    for _ in range(3):
        out, errors = {}, []
        barrier = threading.Barrier(2)

        def send(name):
            try:
                barrier.wait(timeout=60)
                out[name] = runner.execute(sqls[name])
            except BaseException as e:  # noqa: B036 reported below
                errors.append(e)

        threads = [threading.Thread(target=send, args=(n,)) for n in sqls]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert not any(th.is_alive() for th in threads) and not errors
        ids = {}
        for name, res in out.items():
            spans = res.stats["trace"]
            (ids[name],) = {s["trace_id"] for s in spans}
            assert sorted(res.rows) == solo[name][0]
            assert len(spans) == solo[name][1], name
            assert sorted(s["name"] for s in
                          _spans_of(res, "statement")) == STATEMENT_SPANS
            assert not [s for s in spans if s["parent_id"] is not None
                        and s["parent_id"] not in
                        {x["span_id"] for x in spans}]
        assert ids["q3"] != ids["q18"]
