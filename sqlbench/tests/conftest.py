"""Shared fixtures of the harness's CPU tests: one small database and
the port's CPU runner over it."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: the tests' scale: TPC-H "tiny" (SF 0.01)
SF = 0.01
SEED = 2 ** 31 + 11


@pytest.fixture(scope="session")
def config():
    from sqlbench import workload

    return workload.read_json(os.path.join(
        ROOT, "sqlbench", "configs", "tpch_sf1_single.json"))


@pytest.fixture(scope="session")
def db(config):
    from sqlbench import data

    return data.generate(config, SEED, SF)


@pytest.fixture(scope="session")
def cpu_runner(config, db):
    from sqlbench import system

    return system.make_runner(config, db, "cpu")


def with_staged_cells() -> dict:
    """``BENCHMARK.json`` with the cell whose files are staged under
    ``sqlbench/`` added: the single-node cell (it waits for history to
    settle; PERF.md §7), so the CPU tests cover the local runner's path
    too."""
    import json

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tpch_sf1_single",
                             "file": "sqlbench/configs/tpch_sf1_single.json"})
    bench["workloads"].append({"name": "tpch_sf1_single.agg",
                               "config": "tpch_sf1_single",
                               "traffic": "agg", "chips": 1})
    return bench


def tpcds_config(sf: float = 0.001, **over) -> dict:
    """A TPC-DS configuration of every table and column of the port's
    TPC-DS connector, with its types, on the four-worker runner, its
    schema served by ``porttpcdsgen`` (no configuration file has a
    second schema yet)."""
    from trino_tpu_torch.connectors.tpcds import _TABLE_COLUMNS

    cfg = {"schema": "tests.porttpcds", "scale_factor": sf,
           "page_rows": 4096,
           "desired_splits": 8,
           "runner": {"kind": "distributed", "n_workers": 4},
           "session": {}}
    for table, columns in _TABLE_COLUMNS.items():
        cfg[table] = {c: str(t) for c, t in columns}
    cfg.update(over)
    return cfg
