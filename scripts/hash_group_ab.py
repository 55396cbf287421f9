#!/usr/bin/env python3
"""The hash-grouped page of two trees on one card, in turns: host syncs,
the grouping's time, and TPC-H q1, q3 and q18 over SF1 memory tables.

    python3 scripts/hash_group_ab.py --parent DIR [--runs 1] [--profile]
        [--kernel [CALLS]] [--kernel-only]

DIR is another tree of this repository (for example the parent commit
unpacked with ``git archive HEAD | tar -x -C .archive/parent``). The
script runs one process per tree and turn, parent, change, change,
parent (``--runs 2``: twice over), each importing ``trino_tpu_torch``
from its own tree and building that tree's kernel libraries. Each
process:

- groups one page the way ``HashAggregationOperator._hash_group_page``
  does (``hash_group_ids``, ``hash_segment_reduce``, then the overflow
  flag read on the host), at q1's page (262,144 lanes, two pooled keys as
  (uint8, int64) operand pairs, 4 groups, 15 int64 SUM states) and at a
  q18-like page (524,288 lanes, one key, 65,536 groups, 2 states), and
  counts the host syncs of one such page, and of its
  ``hash_group_ids`` and its ``hash_segment_reduce`` alone, under
  ``torch.cuda.set_sync_debug_mode("warn")`` (each synchronizing CUDA
  call warns once, a host read of a device value or an upload of a host
  scalar alike); then times ``hash_group_ids`` alone (host clock over
  20 back-to-back pages ending in a device sync, and CUDA events around
  one page);
- creates lineitem, orders and customer from ``tpch.sf1`` as memory
  tables (CTAS, as ``chip_smoke.py``'s ``memory_sf1``) and runs q1, q3
  and q18 over them: a cold run, then three warm runs (host clock ending
  in a device sync), and one more warm run under the sync debug mode
  counting the whole query's host syncs beside its hash-grouped pages.

With ``--kernel``, each process first times the hash kernel alone on the
device (``chip_smoke.hash_device_ms`` of this tree's ``chip_smoke.py``:
every device op of one ``kernels.hash_insert`` call, the memset
included) at every input of this tree's ``chip_smoke.HASH_CASES``, at
every call kept under the directory CALLS (the ``*.pt`` files
``chip_smoke.py`` writes there when run with ``HASH_CALLS_DIR=CALLS``:
each replay phase's timed page and merge), and at the DOUBLE-sum burst
merge's shape (134,217,728 lanes, 192 live, too large to keep), each
beside its bound (``chip_smoke._hash_bound_ms``: the live rows' keys).
Beside the device time it times the call as the host issues it: 20
back-to-back wrapper calls between CUDA events (``wrapper_ms``, the
smoke's ``kernel_ms``), the host's time to issue one wrapper call
(``wrapper_host_us``) and one bare call of the tree's C entry on outputs
allocated beforehand (``entry_host_us``: the entry's memset and launch
calls and ctypes, without the wrapper's checks, allocation and plan).
``--kernel-only`` leaves out the pages, the memory tables and the
queries.

With ``--profile``, each turn also runs that tree's
``scripts/profile_torch_q1.py 18`` (q18 over the generator-fed SF1: the
device busy share). One JSON line per (tree, turn, measurement), then a
summary per measurement with each tree's values, and the card's name and
power limit (nvidia-smi). Needs a CUDA card.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
import warnings

import ab_turns

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261018
QUERIES = (1, 3, 18)
WARM_RUNS = 3


def emit(obj):
    print(json.dumps(obj), flush=True)


def _count_syncs(fn):
    """(result, host syncs) of ``fn()``: the warnings of torch's sync
    debug mode, one per synchronizing CUDA call."""
    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def _page(rng, n, groups, keys, states, dev):
    """(key_ops, valid, state columns) of one page: ``keys`` key columns
    as (uint8 null tag, int64 key) operand pairs, ``groups`` groups over
    the first 95% of the lanes."""
    import numpy as np
    import torch

    ops = []
    g = rng.integers(0, groups, n)
    for k in range(keys):
        key = (g // (groups ** (k / keys) if keys > 1 else 1)).astype(
            np.int64) * 7919 + k
        ops += [torch.zeros(n, dtype=torch.uint8, device=dev),
                torch.from_numpy(key).to(dev)]
    valid = torch.from_numpy(np.arange(n) < n - n // 20).to(dev)
    cols = [torch.from_numpy(rng.integers(-1000, 1000, n)).to(dev)
            for _ in range(states)]
    return ops, valid, cols


def _group_page(hashtable, ops, valid, cols):
    """One page as the aggregation groups it: the ids, the reduce
    dispatched, then the one host read of the overflow flag."""
    gid, rows, ngroups, overflow = hashtable.hash_group_ids(ops, valid)
    out = hashtable.hash_segment_reduce(gid, rows, ngroups, (), (),
                                        tuple(cols), ("sum",) * len(cols))
    if overflow:
        raise AssertionError("the page overflowed its probe budget")
    return out


def _smoke():
    """This tree's ``chip_smoke.py`` as a module: both trees' kernels are
    timed and their inputs made by the same code."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _burst_merge(dev):
    """(key_ops, valid, rounds) at the DOUBLE-sum burst merge's shape:
    134,217,728 lanes, 192 of them live (spread evenly), a (uint8 null
    tag, int64 key) operand pair of 24 keys."""
    import torch

    n, live = 134_217_728, 192
    valid = torch.zeros(n, dtype=torch.bool, device=dev)
    at = torch.arange(live, device=dev) * (n // live)
    valid[at] = True
    key = torch.zeros(n, dtype=torch.int64, device=dev)
    key[at] = torch.arange(live, device=dev) % 24 * 7919
    return [torch.zeros(n, dtype=torch.uint8, device=dev), key], valid, 32


def _kernel_inputs(smoke, calls_dir, dev):
    """Every (name, (key_ops, valid, rounds)) the kernel mode times, made
    one at a time."""
    import torch

    for case, (n, distinct, null_share, rounds) in smoke.HASH_CASES.items():
        ops, valid = smoke._hash_inputs(smoke.hash_case_rng(case), n,
                                        distinct, null_share, dev)
        yield case, (ops, valid, rounds)
    if calls_dir:
        for name in sorted(os.listdir(calls_dir)):
            if name.endswith(".pt"):
                ops, valid, rounds = torch.load(
                    os.path.join(calls_dir, name), map_location=dev)
                yield name[:-3], (ops, valid, rounds)
    yield "burst_merge_shape", _burst_merge(dev)


def _entry_call(kernels, ops, valid, rounds):
    """A call of this tree's C entry alone, on outputs allocated here
    once: this tree's buffer and resolved, or the parent's rep, resolved
    and scratch."""
    import torch

    n = valid.shape[0]
    lib = kernels._hash_library()
    table = kernels._operand_table(len(ops)).pack(*[v for op in ops for v in (
        op.data_ptr(), kernels._OPERAND_CODE[op.dtype])])
    stream = kernels._current_stream(valid.get_device())
    tsize = kernels.table_size(n)
    if hasattr(kernels, "hash_layout"):
        width = kernels.hash_entry_width(n, rounds)
        plan = kernels.hash_plan(n, rounds, kernels.hash_resident_grid(
            valid.get_device(), width))
        kept = [torch.empty(plan.nbytes // 4, dtype=torch.int32,
                            device=valid.device),
                torch.empty(n, dtype=torch.bool, device=valid.device)]
        args = (table, len(ops), valid.data_ptr(), n, rounds, plan.width,
                plan.blocks, kept[0].data_ptr(), kept[1].data_ptr(),
                plan.nbytes, tsize, stream)
    else:
        kept = [torch.empty(n + 1, dtype=torch.int32, device=valid.device),
                torch.empty(n, dtype=torch.bool, device=valid.device),
                torch.empty(tsize + n + kernels.HASH_MAX_GRID,
                            dtype=torch.int32, device=valid.device)]
        args = (table, len(ops), valid.data_ptr(), n, rounds,
                kept[0].data_ptr(), kept[1].data_ptr(),
                kept[0].data_ptr() + 4 * n, tsize, kept[2].data_ptr(),
                stream)

    def call():
        if lib.hash_insert(*args) != 0:
            raise RuntimeError("hash_insert: the entry refused the call")
        return kept
    return call


def _host_us(fn, calls: int = 50) -> float:
    """The host's time to issue one call of ``fn``, over ``calls`` calls
    after the card has gone idle (the device catches up afterwards)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / calls * 1e6


def kernel_times(base: dict, calls_dir) -> None:
    """One line per input of the kernel mode: the rows, live rows,
    operands, rounds run, the bound, the device ms of one call, the
    back-to-back wrapper ms and the host's us to issue a wrapper call and
    a bare entry call."""
    import torch

    from trino_tpu_torch.ops import kernels

    smoke = _smoke()
    dev = torch.device("cuda")
    for name, (ops, valid, rounds) in _kernel_inputs(smoke, calls_dir, dev):
        n = valid.shape[0]

        def wrapper():
            return kernels.hash_insert(ops, valid, rounds)

        taken = int(wrapper()[2])
        bound_ms, _, _ = smoke._hash_bound_ms(ops, valid)
        device_ms, device_ops = smoke.hash_device_ms(wrapper)
        entry = _entry_call(kernels, ops, valid, rounds)
        rec = {**base, "case": name, "n": n, "live": int(valid.sum()),
               "operands": len(ops), "rounds": taken, "bound_ms": bound_ms,
               "device_ms": device_ms, "device_ops": device_ops,
               "wrapper_ms": smoke.time_ms(wrapper),
               "wrapper_host_us": _host_us(wrapper),
               "entry_host_us": _host_us(entry)}
        if hasattr(kernels, "hash_layout"):
            plan = kernels.hash_insert_run(ops, valid, rounds).plan
            rec.update(width=plan.width, blocks=plan.blocks,
                       spills=plan.spills)
        emit(rec)
        del ops, valid, entry
        torch.cuda.empty_cache()


def child(tree: str, turn: int, calls_dir, kernel: bool,
          kernel_only: bool) -> int:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from trino_tpu_torch import LocalQueryRunner
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.ops import hashtable, kernels
    from trino_tpu_torch.resources.tpch_queries import TPCH_QUERIES
    from trino_tpu_torch.sql.analyzer import Session

    if not kernels.__file__.startswith(
            os.path.join(tree, "trino_tpu_torch") + os.sep):
        raise RuntimeError(f"imported {kernels.__file__}, not {tree}'s")
    name = "change" if os.path.realpath(tree) == os.path.realpath(REPO) \
        else "parent"
    base = {"tree": name, "turn": turn}
    kernels.build()
    if kernel:
        kernel_times(base, calls_dir)
    if kernel_only:
        return 0
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    for case, (n, groups, keys, states) in {
            "q1_page": (262_144, 4, 2, 15),
            "q18_page": (524_288, 65_536, 1, 2)}.items():
        ops, valid, cols = _page(rng, n, groups, keys, states, dev)
        _group_page(hashtable, ops, valid, cols)             # warm
        _, page_syncs = _count_syncs(
            lambda: _group_page(hashtable, ops, valid, cols))
        ids, ids_syncs = _count_syncs(
            lambda: hashtable.hash_group_ids(ops, valid))
        _, reduce_syncs = _count_syncs(
            lambda: hashtable.hash_segment_reduce(
                *ids[:3], (), (), tuple(cols), ("sum",) * len(cols)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            hashtable.hash_group_ids(ops, valid)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / 20
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        hashtable.hash_group_ids(ops, valid)
        end.record()
        end.synchronize()
        emit({**base, "case": case, "n": n, "groups": groups,
              "operands": len(ops), "states": states,
              "page_host_syncs": page_syncs,
              "group_ids_host_syncs": ids_syncs,
              "reduce_host_syncs": reduce_syncs,
              "group_ids_ms_back_to_back": host_ms,
              "group_ids_ms_one": start.elapsed_time(end)})
        del ops, valid, cols
    tpch = TpchConnector(page_rows=1 << 16)
    runner = LocalQueryRunner({"tpch": tpch, "memory": MemoryConnector()},
                              Session(catalog="memory", schema="default"),
                              desired_splits=8, device="cuda")
    for table, cols in _smoke().MEMORY_TABLES.items():
        t0 = time.perf_counter()
        runner.execute(f"create table {table} as select {', '.join(cols)} "
                       f"from tpch.sf1.{table}")
        torch.cuda.synchronize()
        emit({**base, "ctas": table,
              "wall_s": time.perf_counter() - t0})
    for qid in QUERIES:
        sql = TPCH_QUERIES[qid]
        runner.execute(sql)
        walls = []
        for _ in range(WARM_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = runner.execute(sql)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        res, syncs = _count_syncs(lambda: runner.execute(sql))
        hash_pages = sum(op.get("grouping_paths", {}).get("hash", 0)
                         for op in res.stats["operators"]
                         if op["name"] == "HashAggregationOperator")
        emit({**base, "query": f"q{qid}", "warm_s": walls,
              "rows_out": len(res.rows), "hash_pages": hash_pages,
              "host_syncs": syncs,
              "launches": kernels.launch_counts()})
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--kernel", nargs="?", const="", default=None,
                    metavar="CALLS")
    ap.add_argument("--kernel-only", action="store_true")
    ap.add_argument("--child")
    ap.add_argument("--turn", type=int, default=0)
    args = ap.parse_args()
    kernel = args.kernel is not None or args.kernel_only
    calls_dir = os.path.realpath(args.kernel) if args.kernel else None
    if args.child:
        return child(os.path.realpath(args.child), args.turn, calls_dir,
                     kernel, args.kernel_only)
    card = ab_turns.card()
    emit({"card": card})
    trees = {"parent": os.path.realpath(args.parent),
             "change": os.path.realpath(REPO)}
    lines = []
    for name, turn, records in ab_turns.turns(
            trees, args.runs, lambda name, turn: [
                sys.executable, os.path.abspath(__file__), "--child",
                trees[name], "--turn", str(turn)] + (
                    ["--kernel", calls_dir or ""] if kernel else []) + (
                    ["--kernel-only"] if args.kernel_only else [])):
        lines += records
        if args.profile:
            prof = subprocess.run(
                [sys.executable, os.path.join(trees[name], "scripts",
                                              "profile_torch_q1.py"), "18"],
                capture_output=True, text=True, cwd=trees[name])
            if prof.returncode != 0:
                print(prof.stdout + prof.stderr, file=sys.stderr)
                return prof.returncode
            for line in prof.stdout.splitlines():
                rec = json.loads(line)
                if rec.get("phase") in ("run", "device"):
                    rec.pop("top", None)
                    emit({"tree": name, "turn": turn, "profile_q18": rec})
    summary = {}
    for rec in lines:
        key = rec.get("case") or rec.get("query") or rec.get("ctas")
        for field, value in rec.items():
            if field in ("tree", "turn", "case", "query", "ctas"):
                continue
            summary.setdefault(f"{key}.{field}", {}).setdefault(
                rec["tree"], []).append(value)
    emit({"summary": summary, "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
