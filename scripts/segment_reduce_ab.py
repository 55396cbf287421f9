#!/usr/bin/env python3
"""Time the segment-reduce kernel of two trees on one card, in turns.

    python3 scripts/segment_reduce_ab.py --parent DIR [--runs 2]

DIR is another tree of this repository (for example the parent commit
unpacked with ``git archive HEAD | tar -x -C .archive/parent``). The
script runs one process per tree and turn, parent, change, change,
parent (``--runs 2``: twice over), each importing ``trino_tpu_torch``
from its own tree and building that tree's kernel library, at the calls
PERF.md section 6 tracks, built from one seed by ``chip_smoke.py``'s
generators (``_hash_table``, ``kernel_case``):

- ``q1_page``: q1's aggregation page, 262,144 rows, 15 int64 SUM states
  read through the gid sort's ``order``, 4 groups interleaved over
  250,000 live rows;
- ``q1_merge``: q1's merge as q1 makes it, 8,388,608 lanes: 24 page
  partials of 262,144 lanes with 4 live lanes each, then padding; 96
  live, the dead lanes read through ``order``;
- ``q1_merge_sorted``: the same merge as the sort path calls it, the
  columns already in gid order and no ``order``;
- ``q1_merge_dense``: the same lanes with 4 groups interleaved over all
  but 1,000 of them (``chip_smoke.py``'s synthetic merge);
- ``q18_merge``: 16,777,216 lanes, 24 partials of 524,288 lanes with
  62,500 live each (1,500,000 groups), 2 columns, ``order``;
- ``distributed_q1_merge``: the partial step's merge, 4,194,304 lanes,
  24 live, 15 columns, ``order``;
- ``process_q3_merge``: 8,192 lanes, 4 partials of 2,048 lanes with 1,400
  live each, 2 columns, ``order``;
- ``mesh_merge_final``: 64 lanes (4 senders of 16, 3 live each), 3
  groups, 15 int64 SUM and the int32 first-row MIN, sorted, no ``order``.

Per case: the kernels' device ms per call (``torch.profiler``), the
wrapper's back-to-back ms (CUDA events over 20 calls), ``index_add_``
ms (one call per column over the unsorted gids), the bytes bound and
the error against the plain version (exact); at the two small merges,
the wrapper's host us per call and per step. One JSON line per (tree,
turn, case), then one per case with each tree's values, and the card's
name and power limit (nvidia-smi). Needs a CUDA card.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import sys
import time

import ab_turns

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261017
SMALL = ("process_q3_merge", "mesh_merge_final")


def _smoke():
    """This tree's ``chip_smoke.py``, whose generators build the cases."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _case(smoke, name, rng, dev):
    """(cols, gid, num_segments, kinds, order, unsorted gids) of a case."""
    if name in ("q1_page", "q1_merge_dense"):
        n = smoke.PAGE_ROWS if name == "q1_page" else smoke.MERGE_ROWS
        live = smoke.PAGE_LIVE if name == "q1_page" else n - 1000
        cols, unsorted, gid, order = smoke._hash_table(
            rng, n, live, ["int64"] * smoke.STATES_PER_PAGE, dev)
        return cols, gid, n + 1, ["sum"] * len(cols), order, unsorted
    return smoke.kernel_case(name, rng, dev)


def _device_ms(fn, iters=10):
    """Device time per call of every kernel and copy ``fn`` launches,
    their names and the records per call (whatever the tree names its
    kernels; at these cases each name launches once per call): the sum of
    each name's mean over the launches the profiler recorded (it drops
    records now and then; a count per call below the kernels' number
    says so)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a window that recorded nothing is profiled again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type != DeviceType.CPU and e.count]
        if events:
            break
    else:
        raise RuntimeError("the profiler recorded no device activity")
    return (sum(e.self_device_time_total / e.count for e in events) / 1e3,
            sorted({e.key for e in events}),
            sum(e.count for e in events) / iters)


def _host_us(fn, reps=300):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    us = (time.perf_counter_ns() - t0) / reps / 1e3
    torch.cuda.synchronize()
    return us


def _parent_steps(kernels, cols, gid, ns, kinds, order):
    """Host us per call of each step of the three-launch wrapper (the
    tree before the redesign): ``_dtype_codes``, the allocations of
    ``_launch``, the four ctypes arrays of ``_run``, the stream lookup,
    the library call, the profiled ``_run`` and the whole call."""
    import torch

    codes = kernels._dtype_codes(cols, gid, order, ns)
    k, n, dev = len(cols), gid.shape[0], gid.device

    def allocate():
        outs = [None] * k
        for dtype in {c.dtype for c in cols}:
            idx = [i for i, c in enumerate(cols) if c.dtype == dtype]
            block = torch.empty((len(idx), ns), dtype=dtype, device=dev)
            for i, row in zip(idx, block.unbind(0)):
                outs[i] = row
        carries = 2 * -(-n // kernels._tile_rows)
        return (outs, torch.empty((carries,), dtype=torch.int32, device=dev),
                torch.empty((k * carries,), dtype=torch.int64, device=dev))

    outs, cg, cv = allocate()
    kind_codes = [kernels._KIND_CODE[x] for x in kinds]

    def arrays():
        return ((ctypes.c_void_p * k)(*[c.data_ptr() for c in cols]),
                (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs]),
                (ctypes.c_int * k)(*codes), (ctypes.c_int * k)(*kind_codes))

    arr = arrays()
    stream = torch.cuda.current_stream(dev).cuda_stream
    order_ptr = None if order is None else order.data_ptr()

    def library():
        kernels._lib.segment_reduce_columns(
            *arr, k, gid.data_ptr(), order_ptr, n, ns, cg.data_ptr(),
            cv.data_ptr(), stream)

    steps = {
        "check": lambda: kernels._dtype_codes(cols, gid, order, ns),
        "allocate": allocate,
        "ctypes": arrays,
        "stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "library": library,
        "run": lambda: kernels._run(cols, gid, order, outs, cg, cv, ns,
                                    tuple(kinds), tuple(codes)),
        "call": lambda: kernels.segment_reduce_columns(cols, gid, ns, kinds,
                                                       order),
    }
    return {name: _host_us(fn) for name, fn in steps.items()}


def _steps(smoke, kernels, cols, gid, ns, kinds, order):
    if hasattr(kernels, "plan_columns"):
        return smoke.wrapper_steps(cols, gid, ns, kinds, order)
    return _parent_steps(kernels, cols, gid, ns, kinds, order)


def one_tree(tree: str, label: str, cases) -> None:
    """Every case on this process's card, with ``tree``'s kernel."""
    import numpy as np
    import torch

    sys.path.insert(0, tree)
    from trino_tpu_torch.ops import kernels

    if not kernels.__file__.startswith(os.path.abspath(tree) + os.sep):
        raise RuntimeError(f"{kernels.__file__} is not under {tree}")
    t0 = time.perf_counter()
    kernels.build()
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    smoke = _smoke()
    for name in cases:
        rng = np.random.default_rng(SEED)
        cols, gid, ns, kinds, order, unsorted = _case(smoke, name, rng, dev)
        n = gid.shape[0]

        def call():
            return kernels.segment_reduce_columns(cols, gid, ns, kinds,
                                                  order)

        got = call()
        want = kernels.segment_reduce_columns_reference(cols, gid, ns, kinds,
                                                        order)
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                  for a, b in zip(got, want))
        del got, want
        unsorted64 = unsorted.to(torch.int64)
        outs = [torch.empty(ns, dtype=c.dtype, device=dev) for c in cols]

        def library():
            for out, col in zip(outs, cols):
                out.index_add_(0, unsorted64, col)

        device_ms, device_kernels, launches = _device_ms(call)
        bound_ms, _, bytes_ = smoke._bound_ms(cols, n, ns,
                                              order is not None)
        line = {"tree": label, "case": name, "n": n, "columns": len(cols),
                "order": order is not None, "bytes": bytes_,
                "bound_ms": bound_ms, "device_ms": device_ms,
                "bound_share": bound_ms / device_ms,
                "device_kernels": device_kernels,
                "device_launches_per_call": launches,
                "kernel_ms": smoke.time_ms(call),
                "library_ms": smoke.time_ms(library), "max_abs_err": err,
                "build_s": round(build_s, 3)}
        if name in SMALL:
            line["host_us"] = _host_us(call)
            line["host_steps_us"] = _steps(smoke, kernels, cols, gid, ns,
                                           kinds, order)
        print(json.dumps(line), flush=True)
        if err:
            raise AssertionError(f"{label} {name}: error {err}")
        del cols, gid, order, unsorted, unsorted64, outs
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="the other tree, timed in turns")
    ap.add_argument("--runs", type=int, default=1,
                    help="rounds of parent, change, change, parent")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    ap.add_argument("--label", help=argparse.SUPPRESS)
    ap.add_argument("--cases", default="q1_page,q1_merge,q1_merge_sorted,"
                    "q1_merge_dense,q18_merge,distributed_q1_merge,"
                    "process_q3_merge,mesh_merge_final")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("segment_reduce_ab: no CUDA device", file=sys.stderr)
        return 1
    cases = args.cases.split(",")
    if args.tree:
        one_tree(args.tree, args.label, cases)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    smi = ab_turns.card()
    print(smi, flush=True)
    trees = {"parent": os.path.abspath(args.parent), "change": REPO}
    results = {}
    for label, _turn, records in ab_turns.turns(
            trees, args.runs, lambda label, _turn: [
                sys.executable, os.path.abspath(__file__), "--tree",
                trees[label], "--label", label, "--cases", args.cases]):
        for rec in records:
            results.setdefault(rec["case"], {}).setdefault(
                label, []).append(rec)
    keys = ("device_ms", "kernel_ms", "library_ms", "bound_share",
            "host_us")
    for case, by_tree in results.items():
        print(json.dumps({"case": case, "card": smi, **{
            label: {k: [r[k] for r in recs if k in r] for k in keys}
            for label, recs in by_tree.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
