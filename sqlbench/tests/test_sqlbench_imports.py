"""No run loads JAX or the JAX package, and the references import no
engine code. Names are compared whole, before the first dot: the port's
own name starts with the JAX package's."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from sqlbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "trino_tpu"}


def test_rehearsed_setup_loads_no_jax():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from sqlbench import run\n"
        "line, numbers, _, _ = run.run_cell('tpch_sf1_cluster4.exchange', "
        "7, 2.0, True, device='cpu', sf=0.001)\n"
        "print(json.dumps({'bad': run.forbidden_modules(), "
        "'correct': line['correct'], 'torch': 'trino_tpu_torch' in "
        "sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    import json

    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "correct": True, "torch": True}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_references_import_no_engine():
    files = glob.glob(os.path.join(ROOT, "sqlbench", "reference", "*.py"))
    assert len(files) >= 5
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN | {"trino_tpu_torch", "torch"}, \
                (path, name)


GENERATORS = sorted(os.path.basename(p)[:-3] for p in glob.glob(
    os.path.join(ROOT, "sqlbench", "*gen.py")))


@pytest.mark.parametrize("module", GENERATORS)
def test_generators_import_no_engine(module):
    """A schema's generator is plain NumPy: the benchmark's data never
    moves with the port's connectors."""
    for name in _imports(os.path.join(ROOT, "sqlbench", f"{module}.py")):
        assert name.split(".")[0] not in \
            FORBIDDEN | {"trino_tpu_torch", "torch"}, (module, name)


def test_harness_imports_no_jax():
    for path in glob.glob(os.path.join(ROOT, "sqlbench", "**", "*.py"),
                          recursive=True):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_forbidden_names_compare_whole():
    from sqlbench import run

    sys.modules.setdefault("trino_tpu_torch", sys.modules.get(
        "trino_tpu_torch") or type(sys)("trino_tpu_torch"))
    assert "trino_tpu_torch" not in run.forbidden_modules()
    assert set(run.FORBIDDEN) == FORBIDDEN
