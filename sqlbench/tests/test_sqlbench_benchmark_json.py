"""BENCHMARK.json is well formed: names and units use the allowed
characters, every cell's files are found, and every ``moves`` names an
end-to-end metric that each of the metric's cells reports."""

import glob
import json
import os
import re

import pytest

from sqlbench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "cell": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source"},
    "layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_keys_names_and_units(bench):
    assert set(bench) == KEYS["top"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and \
        1 <= bench["run_seconds"] <= 51
    for c in bench["configs"]:
        assert set(c) == KEYS["config"]
        assert NAME.match(c["name"]) and _line(c["source"]) and \
            _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == KEYS["cell"]
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and \
            NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["e2e"]
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["layer"]
        assert _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(names)) == len(names)
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for group in ("configs", "workloads"):
        names = [x["name"] for x in bench[group]]
        assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_every_cells_files_are_found(bench):
    from sqlbench import readers, workload

    configs = {c["name"]: c for c in bench["configs"]}
    used = {w["config"] for w in bench["workloads"]}
    assert used == set(configs)
    for path in bench["paths"]:
        assert os.path.isdir(os.path.join(ROOT, path))
    for c in configs.values():
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        cfg = workload.read_json(os.path.join(ROOT, c["file"]))
        for key in c["reduced"]:
            assert key in cfg
    for w in bench["workloads"]:
        traffic = workload.load_traffic(w["traffic"])
        for name in traffic["templates"]:
            workload.load_template(name)
            __import__(f"sqlbench.reference.{name}")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(readers.load(m["name"]).read)


def test_moves_names_a_metric_its_cells_report(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in bench["end_to_end"]}
    reported = {c: set() for c in cells}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert c in cells
            assert c in e2e[m["moves"]]
            reported[c].add(m["name"])
    for c in cells:
        assert c in e2e["setup_s"]
        assert any(c in ws for n, ws in e2e.items() if n != "setup_s")
        assert reported[c]
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


CONFIGS = sorted(os.path.basename(p)[:-5] for p in glob.glob(
    os.path.join(ROOT, "sqlbench", "configs", "*.json")))


@pytest.mark.parametrize("name", CONFIGS)
def test_configuration_holds_every_tpch_table_and_column(name):
    """A configuration keeps its schema's widths: every table and every
    column of the port's connector of its schema (``"schema"``, TPC-H
    by default), with its type, in the schema's order, and its schema
    has a generator of every one of those tables."""
    import importlib

    from sqlbench import data, workload

    cfg = workload.read_json(os.path.join(ROOT, "sqlbench", "configs",
                                          f"{name}.json"))
    schema = cfg.get("schema", "tpch")
    port = importlib.import_module(f"trino_tpu_torch.connectors.{schema}")
    assert set(data.generator(cfg).TABLES) == set(port._TABLE_COLUMNS)
    for table, columns in port._TABLE_COLUMNS.items():
        assert list(cfg[table].items()) == \
            [(c, str(t)) for c, t in columns], table

