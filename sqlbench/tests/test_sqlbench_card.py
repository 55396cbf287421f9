"""On the card: one short run of each cell, untraced and traced, comes
out correct and reports every metric its cell lists. Skips without a
card (the decision is made inside the test)."""

import json
import os
import subprocess
import sys

import pytest

from sqlbench.tests.conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", ["tpch_sf1_cluster4.exchange",
                                      "tpch_sf1_cluster4.exchange2"])
def test_short_run_on_the_card(workload, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sqlbench import run

    bench, cell, _, _ = run.load_cell(workload)
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "sqlbench", "run.py"),
         "--workload", workload, "--seed", str(2 ** 31 + 3), "--seconds",
         "8", "--trace", str(trace)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"]
    want = {m["name"] for m in run.cell_metrics(bench, cell, bool(trace))}
    assert set(line["metrics"]) == want
    assert line["device"]["platform"] == "gpu"
    for name, m in line["metrics"].items():
        if name.endswith("_roofline"):
            assert 0 < m["value"] <= 100
