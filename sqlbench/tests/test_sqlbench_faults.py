"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run on the CPU, at a small scale, past
the harness's look for a card: the tables, the runner behind the
statement server, the streams' child process, the window and the
comparison with the reference. Each fault is one the cells can have: an
answer altered where it is produced, half of the rows left out, and (in
the cluster) one producer's pages left out of the exchange."""

import pytest

from sqlbench import run
from sqlbench.tests.conftest import SEED, SF, with_staged_cells


class _Broken:
    """Serves ``runner`` with every result passed through ``fault``."""

    def __init__(self, runner, fault):
        self._runner = runner
        self._fault = fault
        self.execute = self._execute
        if hasattr(runner, "execute_batch"):
            self.execute_batch = self._execute_batch

    def __getattr__(self, name):
        return getattr(self._runner, name)

    def _execute(self, sql, *args, **kwargs):
        return self._fault(self._runner.execute(sql, *args, **kwargs))

    def _execute_batch(self, sqls, *args, **kwargs):
        return [r if isinstance(r, Exception) else self._fault(r)
                for r in self._runner.execute_batch(sqls, *args, **kwargs)]


def _alter_one_value(res):
    for i, row in enumerate(res.rows):
        for j, v in enumerate(row):
            if isinstance(v, int) and not isinstance(v, bool):
                res.rows[i] = row[:j] + (v + 1,) + row[j + 1:]
                return res
    return res


def _drop_half(res):
    res.rows = res.rows[: len(res.rows) // 2]
    return res


def _run(workload, wrap=None):
    line, numbers, _, _ = run.run_cell(workload, SEED, 3.0, False,
                                       device="cpu", sf=SF,
                                       wrap_runner=wrap,
                                       bench=with_staged_cells())
    return line, numbers


@pytest.mark.parametrize("workload", ["tpch_sf1_single.agg",
                                      "tpch_sf1_cluster4.exchange",
                                      "tpch_sf1_cluster4.exchange2"])
def test_sound_run_is_correct(workload):
    line, numbers = _run(workload)
    assert line["correct"] and numbers["compared"] >= 2
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("fault", [_alter_one_value, _drop_half])
@pytest.mark.parametrize("workload", ["tpch_sf1_single.agg",
                                      "tpch_sf1_cluster4.exchange",
                                      "tpch_sf1_cluster4.exchange2"])
def test_broken_answer_is_not_correct(workload, fault):
    line, numbers = _run(workload, lambda r: _Broken(r, fault))
    assert not line["correct"]
    assert numbers["mismatched"] >= 1


@pytest.mark.parametrize("workload", ["tpch_sf1_cluster4.exchange",
                                      "tpch_sf1_cluster4.exchange2"])
def test_exchange_left_out_is_not_correct(monkeypatch, workload):
    from trino_tpu_torch.parallel import device_exchange

    used = []
    add_page = device_exchange.DeviceExchange.add_page

    def drop_task0(self, task_id, page):
        used.append(task_id)
        if task_id != 0:
            add_page(self, task_id, page)

    monkeypatch.setattr(device_exchange.DeviceExchange, "add_page",
                        drop_task0)
    line, numbers = _run(workload)
    assert used and not line["correct"]
    assert numbers["mismatched"] >= 1


class _FailAfter(_Broken):
    """Serves ``runner``, failing every statement after the first
    ``after`` (the warm-up's plan reads, ``EXPLAIN``, not counted)."""

    def __init__(self, runner, after):
        super().__init__(runner, lambda res: res)
        self._left = after

    def _count(self, sql):
        if not sql.lstrip().upper().startswith("EXPLAIN"):
            self._left -= 1
            if self._left < 0:
                raise RuntimeError("planted failure")

    def _execute(self, sql, *args, **kwargs):
        self._count(sql)
        return self._runner.execute(sql, *args, **kwargs)

    def _execute_batch(self, sqls, *args, **kwargs):
        for sql in sqls:
            self._count(sql)
        return self._runner.execute_batch(sqls, *args, **kwargs)


def test_failed_statement_is_not_correct():
    from sqlbench import workload

    traffic = workload.load_traffic("agg")
    most = traffic.get("warmup_max_per_template",
                       traffic["warmup_per_template"])
    assert most == traffic["warmup_per_template"]
    warmup = traffic["streams"] * len(traffic["templates"]) * most
    line, numbers = _run("tpch_sf1_single.agg",
                         lambda r: _FailAfter(r, warmup))
    assert not line["correct"]
    assert numbers["failed"] >= 1 and line["failed"] == numbers["failed"]


def test_failed_warmup_gives_no_result():
    def fail(res):
        raise RuntimeError("planted failure")

    with pytest.raises(RuntimeError, match="warm-up"):
        _run("tpch_sf1_single.agg", lambda r: _Broken(r, fail))
