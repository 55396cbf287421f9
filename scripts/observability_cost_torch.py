#!/usr/bin/env python3
"""What history-based statistics and the program profiler cost on the card.

    python3 scripts/observability_cost_torch.py [--repo DIR] [--step STEP]

``--repo DIR`` imports ``trino_tpu_torch`` from another checkout (for
example the parent commit unpacked with ``git archive``), so two trees
can be compared on one card in one call: run parent, change, change,
parent. ``--step`` is ``history`` (the default), ``http``, ``profiler`` or
``all``. Prints JSON lines, each with the card's name and power limit:

- ``history``: TPC-H q1 at SF1 over the tpch generator (the engine's
  warm path, page_rows 65,536, 8 splits), then a burst of eight
  q6-shape statements (``chip_smoke.py``'s ``SERVING_Q6_SQL`` and
  arguments) through ``LocalQueryRunner.execute_batch`` over a memory
  copy of lineitem at SF1. After one untimed run in each mode, each is
  timed six times with ``hbo_enabled`` off and on in turns (off, on,
  on, off, off, on); every run's wall ends in a device synchronise.
  On a tree without history the switch is ignored, so its two modes
  time the same code.
- ``http``: the same burst through the statement server
  (``ProtocolServer`` on 127.0.0.1, port 0) and eight clients, submitted
  while the server's executor is held and timed from its release to the
  last client's last page (``chip_smoke.py``'s ``_burst``), history off
  and on in the same turns.
- ``profiler``: EXPLAIN ANALYZE VERBOSE of q1 over the same memory
  table, to find out what the profiler's per-call span measures. For
  the kernel entry ``segment_reduce_pallas`` it sets beside the
  profiler's event-span sum: the host time of the wrapper calls, the
  event span and host time of the library call alone (the launch of
  its three kernels, without the output allocation before it), how
  many calls found the stream already idle when they began (at the
  wrapper's entry, before the outputs are allocated), and, from
  a run under ``torch.profiler``, the kernels' own device time and
  the whole run's busy device time.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = (False, True, True, False, False, True)
RUNS = len(ORDER)


def emit(obj):
    print(json.dumps(obj), flush=True)


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def _timed(runner, fn, hbo: bool) -> float:
    import torch

    runner.session.properties["hbo_enabled"] = hbo
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    finally:
        runner.session.properties.pop("hbo_enabled")


def _alternate(runner, fn) -> dict:
    for hbo in (False, True):
        _timed(runner, fn, hbo)  # untimed: loads, plans, records
    walls = {"off": [], "on": []}
    for hbo in ORDER:
        walls["on" if hbo else "off"].append(_timed(runner, fn, hbo))
    return {"walls_s": walls,
            "mean_off_s": sum(walls["off"]) / len(walls["off"]),
            "mean_on_s": sum(walls["on"]) / len(walls["on"])}


def _memory_runner(tables):
    from chip_smoke import MEMORY_TABLES
    from trino_tpu_torch import LocalQueryRunner
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.sql.analyzer import Session

    runner = LocalQueryRunner(
        {"tpch": TpchConnector(page_rows=1 << 16),
         "memory": MemoryConnector()},
        Session(catalog="memory", schema="default"), desired_splits=8,
        device="cuda")
    for table in tables:
        runner.execute(f"create table {table} as select "
                       f"{', '.join(MEMORY_TABLES[table])} "
                       f"from tpch.sf1.{table}")
    return runner


def history_step(card: str, tree: str):
    from chip_smoke import SERVING_Q6_ARGS, SERVING_Q6_SQL
    from trino_tpu_torch import LocalQueryRunner
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.resources.tpch_queries import TPCH_QUERIES
    from trino_tpu_torch.sql.analyzer import Session

    runner = LocalQueryRunner({"tpch": TpchConnector(page_rows=1 << 16)},
                              Session(catalog="tpch", schema="sf1"),
                              desired_splits=8, device="cuda")
    emit({"step": "history", "tree": tree, "case": "generator_q1",
          **_alternate(runner, lambda: runner.execute(TPCH_QUERIES[1])),
          "card": card})
    del runner
    runner = _memory_runner(["lineitem"])
    sqls = [SERVING_Q6_SQL % (c, c, q) for c, q in SERVING_Q6_ARGS]
    depths = []

    def burst():
        out = runner.execute_batch(sqls)
        bad = [o for o in out if isinstance(o, Exception)]
        if bad:
            raise bad[0]
        depths.append(out[0].stats.get("batched_depth"))

    emit({"step": "history", "tree": tree, "case": "q6_burst_8",
          **_alternate(runner, burst), "batched_depths": sorted(
              set(depths)), "card": card})


def http_step(card: str, tree: str):
    from chip_smoke import SERVING_Q6_ARGS, SERVING_Q6_SQL, _burst
    from trino_tpu_torch.server.protocol import ProtocolServer

    runner = _memory_runner(["lineitem"])
    sqls = [SERVING_Q6_SQL % (c, c, q) for c, q in SERVING_Q6_ARGS]
    srv = ProtocolServer(runner, host="127.0.0.1", port=0).start()
    try:
        def burst():
            out, _ = _burst(srv, sqls)
            bad = [o for o in out if isinstance(o, Exception)]
            if bad:
                raise bad[0]

        emit({"step": "http", "tree": tree, "case": "q6_burst_8",
              **_alternate(runner, burst), "card": card})
    finally:
        srv.stop()


def profiler_step(card: str, tree: str):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from trino_tpu_torch.ops import kernels
    from trino_tpu_torch.resources.tpch_queries import TPCH_QUERIES
    from trino_tpu_torch.telemetry import profiler

    runner = _memory_runner(["lineitem"])
    sql = "explain analyze verbose " + TPCH_QUERIES[1]
    runner.execute(sql)  # loads the library, registers every program
    kernels._library()
    lib = kernels._lib
    launch = kernels._launch
    acc = {}

    class TimedLibrary:
        """The kernel library with the launch call timed: host clock
        and a CUDA event pair on the current stream around it."""

        def __getattr__(self, name):
            return getattr(lib, name)

        def segment_reduce_columns(self, *args):
            stream = torch.cuda.current_stream()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record(stream)
            rc = lib.segment_reduce_columns(*args)
            end.record(stream)
            acc["launch_host_ms"] += (time.perf_counter() - t0) * 1e3
            acc["events"].append((start, end))
            return rc

    def timed_launch(*args, **kwargs):
        acc["idle_at_entry"] += torch.cuda.current_stream().query()
        t0 = time.perf_counter()
        out = launch(*args, **kwargs)
        acc["wrapper_host_ms"] += (time.perf_counter() - t0) * 1e3
        return out

    def kernel_ms():
        return sum(e["execute_ms"] for e in profiler.snapshot()
                   if e["name"] == "segment_reduce_pallas")

    def one_run(traced: bool):
        acc.update(launch_host_ms=0.0, wrapper_host_ms=0.0,
                   idle_at_entry=0, events=[])
        ms0 = kernel_ms()
        kernels.segment_reduce.launches = 0
        kernels._lib, kernels._launch = TimedLibrary(), timed_launch
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if traced:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    runner.execute(sql)
                    torch.cuda.synchronize()
            else:
                runner.execute(sql)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            kernels._lib, kernels._launch = lib, launch
        out = {"step": "profiler", "tree": tree, "query": "q1",
               "torch_profiler": traced, "wall_ms": wall * 1e3,
               "calls": kernels.segment_reduce.launches,
               "span_ms": kernel_ms() - ms0,
               "wrapper_host_ms": acc["wrapper_host_ms"],
               "launch_span_ms": sum(s.elapsed_time(e)
                                     for s, e in acc["events"]),
               "launch_host_ms": acc["launch_host_ms"],
               "idle_at_entry": acc["idle_at_entry"]}
        if traced:
            device = [e for e in prof.key_averages()
                      if e.device_type != DeviceType.CPU]
            ours = [e for e in device
                    if re.search(r"\b(tile|carry)_kernel\b", e.key)]
            out["kernels_device_ms"] = sum(
                e.self_device_time_total for e in ours) / 1e3
            out["run_busy_device_ms"] = sum(
                e.self_device_time_total for e in device) / 1e3
        emit({**out, "card": card})

    for traced in (False, False, True):
        one_run(traced)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--repo", default=HERE)
    parser.add_argument("--step", default="history",
                        choices=("history", "http", "profiler", "all"))
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("observability_cost_torch: no CUDA device", file=sys.stderr)
        return 1
    repo = os.path.abspath(args.repo)
    # the tree under test first; chip_smoke's statements from this one
    sys.path[:0] = [repo, HERE]
    card = _card()
    tree = os.path.relpath(repo, HERE)
    if args.step in ("history", "all"):
        history_step(card, tree)
    if args.step in ("http", "all"):
        http_step(card, tree)
    if args.step in ("profiler", "all"):
        profiler_step(card, tree)
    return 0


if __name__ == "__main__":
    sys.exit(main())
