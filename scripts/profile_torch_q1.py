#!/usr/bin/env python3
"""Where TPC-H q1's time goes in the torch engine.

    python3 scripts/profile_torch_q1.py

Runs q1 at SF1 on the CUDA card once to warm up, then three timed runs,
and prints JSON lines:

- ``generate``: host time to generate the scanned lineitem columns alone
  (the tpch connector is a numpy generator on the host);
- ``run``: each timed run's wall (host clock, ending in a device sync);
- ``operators``: per-operator host wall of one run (the driver's stats;
  device work is asynchronous, so an operator's wall is its enqueue time
  plus whatever it waited for on the device);
- ``device``: ``torch.profiler`` over one run — the sum of device-side
  time (kernels and copies), its share of the run's wall (the profiler
  itself slows the host, so the share is a lower bound), the
  segment-reduce kernels' own time, and the top device events.

Every line carries the card's name and power limit.
"""

import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RUNS = 3


def emit(obj):
    print(json.dumps(obj), flush=True)


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from trino_tpu_torch import LocalQueryRunner
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.resources.tpch_queries import TPCH_QUERIES
    from trino_tpu_torch.sql.analyzer import Session
    from trino_tpu_torch.sql.parser import parse_statement

    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()

    def sync():
        torch.cuda.synchronize(device)

    conn = TpchConnector(page_rows=1 << 16)
    runner = LocalQueryRunner({"tpch": conn},
                              Session(catalog="tpch", schema="sf1"),
                              desired_splits=8, device=device)
    sql = TPCH_QUERIES[1]

    # host generation of the scanned columns, without the engine
    root = runner.plan_statement(parse_statement(sql))
    scan = root
    while scan.sources:
        scan = scan.sources[0]
    cols = [c for _, c in scan.assignments]
    t0 = time.perf_counter()
    rows = 0
    for split in conn.split_manager().get_splits(scan.table, 8):
        src = conn.page_source(split, cols)
        while not src.is_finished():
            page = src.get_next_page()
            if page is not None:
                rows += page.num_rows
        src.close()
    emit({"phase": "generate", "rows": rows, "columns": len(cols),
          "seconds": time.perf_counter() - t0, "card": card})

    runner.execute(sql)  # warm-up: loads the kernel library
    for i in range(RUNS):
        sync()
        t0 = time.perf_counter()
        runner.execute(sql)
        sync()
        emit({"phase": "run", "run": i,
              "seconds": time.perf_counter() - t0, "card": card})

    # per-operator host wall of one run
    local = runner._make_local_planner()
    try:
        plan = local.plan(runner.plan_statement(parse_statement(sql)))
        sync()
        t0 = time.perf_counter()
        plan.execute(collect_stats=True)
        sync()
        wall = time.perf_counter() - t0
    finally:
        local.memory_pool.close()
    emit({"phase": "operators", "seconds": wall, "card": card,
          "operators": [{"name": st.name, "wall_s": st.wall_ns / 1e9,
                         "pages_out": st.output_pages}
                        for d in plan.drivers for st in d.stats]})

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.execute(sql)
        sync()
        wall = time.perf_counter() - t0
    # device-side events only (kernels and copies): an aten op's own
    # device time is the sum of its kernels', so counting both would
    # count every kernel twice
    kernels = [e for e in prof.key_averages()
               if e.device_type != DeviceType.CPU]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    ours = [e for e in kernels
            if re.search(r"\b(fill|tile|carry)_kernel<", e.key)]
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    emit({"phase": "device", "wall_s": wall, "device_busy_s": busy_s,
          "device_busy_share": busy_s / wall, "card": card,
          "segment_reduce_launches": sum(e.count for e in ours) // 3,
          "segment_reduce_device_s": sum(e.self_device_time_total
                                         for e in ours) / 1e6,
          "top": [{"name": e.key[:80], "calls": e.count,
                   "device_s": e.self_device_time_total / 1e6}
                  for e in top]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
