#!/usr/bin/env python3
"""Drive trino_tpu_torch on one CUDA card and check what comes out.

    python3 chip_smoke.py

Phases, one JSON line each on standard output:

1. device  — the card's name and power limit (``nvidia-smi``); exits
             non-zero, printing no result, without a CUDA device;
2. build   — compiles every CUDA kernel of the engine from the sources in
             ``trino_tpu_torch/csrc`` with ``nvcc`` for ``sm_90a`` (one
             ``nvcc`` per source, all started together);
3. kernel  — each kernel against its plain PyTorch version on the card,
             one column at a time for every kind x dtype at both shapes
             q1's path gives it: the aggregation page (262,144 rows) and
             the final merge of the 24 page partials (8,388,608 rows),
             each with 4 groups and with ~n/7 groups, plus a ragged n with
             a dump tail; ints and MIN/MAX must match exactly, float sums
             the exact sum within SUM_RTOL of the segment's sum of |x|;
             times the kernel, the plain version and one PyTorch library
             call;
4. columns — the many-column call as q1's hash path makes it: 15 int64
             SUM states read through the gid sort's permutation, 4 groups
             interleaved over the rows, at the page and at the merge
             (exact against the plain version), plus a mixed table (more
             than 32 columns of four dtype/kind pairs, with and without
             the permutation) at the page; times the kernel, the plain
             version, the same work one column at a time (15 gathers and
             15 one-column calls) and ``index_add_`` over the unsorted
             gids of the (n, 15) block, and the kernels' own device time
             (torch.profiler, without the wrapper's host work) and
             launches per call; then, from ``KERNEL_CASES``, q1's merge
             as q1 makes it (24 page partials of 4 live lanes in
             8,388,608, the dead lanes through the permutation), process
             q3's 8,192-lane merge and the mesh's 64-lane merge-final
             (16 columns, sorted), each exact and timed beside
             ``index_add_`` with its bound share (bound ms / device ms),
             and at the 8,192-lane call the wrapper's host us per step
             (``wrapper_steps``);
   hash_kernel — the hash table's probe kernel (``kernels.hash_insert``,
             every probe round in one cooperative launch, under the plan
             ``hash_plan`` makes) against its plain version on the card,
             exactly (rep, resolved and the rounds run; the barriers run
             are the design's, at most rounds + 1), at every input of
             ``HASH_CASES``: q1's page shape (262,144 lanes, 4 groups), a
             page of ~n/7 groups, the largest cap the main path gives
             (16,777,216 lanes), a ragged cap, zero key columns (a global
             aggregation), nulls in the keys, a near-full table under one
             and under two rounds, where rows overflow, small pages of
             512 to 16,385 lanes, an 8,192-lane merge, a 1,048,576-lane
             page of 22 rounds and 64-bit table entries; each timed back
             to back, alone on the device (torch.profiler: every device
             op of a call, the memset included), once after an idle
             card, beside its bytes bound (the live rows' keys) and the
             plain version (no single PyTorch call computes
             first-occurrence group ids: no library time);
5. q1_sf1  — TPC-H q1 at SF1 through ``trino_tpu_torch.LocalQueryRunner``
             on the card, held against the oracle answer in
             ``tests/sf1_expected.py``; every kernel launch counter is set
             to 0 just before the timed run and read just after, and the
             segment-reduce kernel must have been called once per
             aggregated page, the hash kernel once per hash-grouped page;
             the cold run keeps the inputs of every hash kernel launch;
   q1_hash, q3_hash, q18_hash — those launches (of q1's, q3's and q18's
             cold runs) replayed against the plain version, exactly, each
             with its grid, entry width and barriers run; the call with
             the most lanes (the merge) and the page call with the most
             live rows timed as in hash_kernel (and written, when
             HASH_CALLS_DIR names a directory, for
             ``scripts/hash_group_ab.py --kernel``), as every ``*_hash``
             phase below does;
6. q3_sf1  — TPC-H q3 at SF1 the same way: two hash joins (build sides
             orders and customer), the dynamic filters their builds put
             on the lineitem and orders scans, the aggregation over the
             joined pages (one kernel call per aggregated page) and TopN;
             held against the oracle; reports cold and warm wall, the
             lineitem rows scanned, the pruned rows, the strategy each
             join took and the launches; the cold run keeps a copy of
             the inputs of every kernel call it makes;
7. q3_columns — each of those calls again, on q3's own inputs (one int64
             SUM state read through the hash sort's order, thousands of
             groups per joined page, then the merge), exact against the
             plain version; the largest page call and the merge timed
             beside the plain version, ``index_add_`` over the unsorted
             gids, their device time and their bound;
8. q6_sf1, q13_sf1, q18_sf1 — TPC-H q6 (one global aggregation), q13
             (a left outer join and two aggregations) and q18 (a
             ~1.5-million-group aggregation of lineitem behind a semijoin)
             at SF1 the same way, each held against the oracle, with cold
             and warm wall, kernel calls (one per aggregated page) and the
             joins' strategies; q18's cold run records its kernel calls;
9. q18_columns — q18's calls replayed like q3's, exact; its page call
             with the most live rows and the merge with the most groups
             timed the same way;
10. window_sf1 — two window queries over orders at SF1 (window
             aggregates over four specifications of o_custkey, and a
             row_number filter that plans to grouped top-N), each held
             exactly against a numpy oracle that reads the same generated
             columns through the connector's page source and computes the
             answer with lexsort/cumsum, decimals as unscaled integers;
11. sql_surface — the 22 TPC-H queries at tiny (q19 at micro), the 32
             TPC-DS queries at micro and one each of DISTINCT, UNION ALL,
             INTERSECT, EXCEPT, UNNEST and a scalar subquery, on the card
             and on the engine's CPU path: the rows must agree (as sorted
             lists);
12. memory_sf1 — CTAS of lineitem, orders and customer (every column
             but the free-text comments) from ``tpch.sf1`` into memory
             tables, through the card, each checked against the table's
             row count, with its wall time, written rows and the host
             bytes the tables hold; then q1, q3, q6 and q18 over the
             memory tables, each held against the oracle, with cold and
             warm wall beside the same query's warm wall over the
             generator from the phases above, the device busy share
             (torch.profiler, as ``scripts/profile_torch_q1.py``), the
             kernel calls (one per aggregated page) and the joins; the
             cold runs of q3 and q18 record their kernel calls, whose
             page counts differ from the generator's (the memory scan
             does not coalesce pages);
    memory_q3_columns, memory_q18_columns — those calls replayed like
             q3's, exact, page and merge timed;
    distributed_sf1 — the one-card distributed engine over the same
             memory tables: ``DistributedQueryRunner(n_workers=4,
             desired_splits=8)`` runs q1, q3 and q18 (their joins
             PARTITIONED, so both sides shuffle) and q3 once more with
             ``device_exchange=false`` (the host exchange), each cold and
             warm against the oracle; every aggregation splits into a
             partial step before the hash exchange and a final step
             after it, both through the kernel; each warm wall beside
             the local runner's warm wall over the same tables, the busy
             share, every stage boundary's exchange stats, the kernel
             calls (one per aggregated or merged page, equal to the
             launches) and the device exchanges that ran
             (``DeviceExchange.total_collectives``, one per hash
             boundary; none through the host exchange); the cold runs
             of q1 and q18 record their kernel calls with the step each
             serves; then q1, q3 and q18 again over four device slabs
             of the card (``devices=["cuda:0"] * 4``, runs ``*_d4``):
             warm walls beside the one-slab walls, each consumer page's
             lanes beside its partition's live rows, and every launch of
             their cold and warm runs kept and held against the plain
             version;
    distributed_*_hash — every run's warm hash kernel launches (one per
             hash-grouped page; at d = 4 the slabs' tasks launch at
             once) replayed exactly, as q1_hash;
    distributed_q1_columns, distributed_q18_columns,
    distributed_q1_d4_columns, distributed_q18_d4_columns — those calls
             replayed like q3's, exact; timed: the partial step's page
             call with the most live rows, its merge with the most
             groups, and the final step's merge with the most groups
             (q1's final tasks each receive one page and merge nothing:
             its final page call);
    process_sf1 — the multi-process cluster: ``ProcessQueryRunner(
             n_workers=2, desired_splits=8, device="cuda")`` over the
             generator-fed ``tpch.sf1``, a coordinator and two worker
             processes on the card, each with its own CUDA context and a
             node pool of a third of the card; first the in-process
             distributed runner at the same task count, q1, q3 and q18
             cold (kernel calls recorded) and warm (launches counted);
             then the cluster: q1, q3 and q18 cold and warm against the
             oracle, each warm wall beside the local runner's
             generator-fed warm wall and the in-process one, the warm
             run's kernel launches per process (q1's above 0 in each
             worker), each process keeping the inputs of its launches; q1
             under ``query_profiling_enabled``, the profiler's
             ``segment_reduce_pallas`` calls and device memory per
             process (above 0 in each worker); q1 under
             ``retry_policy=TASK`` with a worker killed on its first leaf
             task: the oracle's rows, one task retry inside attempt 0,
             the worker replaced by the runtime's heartbeat monitor;
    process_q{1,3,18}_hash — every hash kernel launch of the cluster's
             warm runs, kept by the process that made it, replayed here
             exactly, as q1_hash;
    process_threads_q{1,3,18}_columns, process_q{1,3,18}_columns — the
             in-process runs' recorded calls, and every launch of the
             cluster's warm runs (written by each worker process, read
             back onto this process's card), replayed like q3's, exact;
             the page call with the most live rows and the merge timed;
    mesh_exchange — ``DeviceExchange`` over slabs of the card (4
             partitions on ``["cuda:0"] * 4``, 8 on ``["cuda:0"] * 2``)
             fed SF1's lineitem keys with 60% set to one hot key: each
             partition's rows against a numpy oracle, the hot partition
             split over every slab, the stats and the wall, cold and
             sized from history;
    mesh_q1_sf1 — q1 at SF1 as the mesh program
             (``parallel.mesh_query.run_q1_mesh(["cuda:0"] * 4, "sf1")``)
             under the ``exchange``, ``global_hash`` and ``auto``
             strategies, cold and warm, and with ``per_dest=1`` (the
             doubling backstop): rows against the oracle, retries, the
             kernel's launches (one per slab per step), every launch
             kept and held against the plain version, walls beside the
             host generation each run repeats;
    mesh_q1_columns — the exchange strategy's cold calls replayed like
             q3's: a slab's partial call and the largest merge-final
             timed;
    device_step_sf1, device_step_columns — ``benchmarks.q1_device_step``
             over a 262,144-row SF1 page against the sort path's plain
             version on the CPU, its one call replayed and timed;
13. explain_analyze_sf1 — EXPLAIN ANALYZE of q18 over the memory tables:
             the plan, a ``Query:`` line whose row count is the oracle's,
             the ``Memory:`` line, one stats line per operator under
             each ``Pipeline i:`` and history's worst-misestimate line,
             all printed;
14. spill_sf1 — over the memory tables: (a) q18 with both spill tiers on,
             a cap of 3/4 of its unspilled peak from memory_sf1 and no
             host budget (every parked page goes to disk), held against
             the oracle with spill and disk events; (b) lineitem join
             orders under 1/8 of its unspilled peak, where the hybrid
             build parks partitions, equal to the uncapped run; (c) an
             ORDER BY over orders under half its unspilled peak with
             spill off, which only the host sort fits, equal to the
             uncapped run; wall, spilled and file bytes, kernel calls; no
             spill file may be left behind; (a) records its kernel calls;
    spill_q18_columns — (a)'s calls replayed like q3's, exact: its merges
             take partials reloaded from disk, compacted, in budget
             chunks;
15. serving_sf1 — the statement server (``ProtocolServer`` on 127.0.0.1,
             port 0) over the memory runner, driven through the engine's
             ``Client``: q1, q3, q6 and q18 once each against the oracle
             (wall from submit to last page, kernel calls); q1 again (a
             cached plan: the plan cache's, or the shape's template once
             history re-planned it) and with the result cache on (a hit
             with no kernel launch); a burst of eight q6-shape statements
             (discount centre and quantity cut vary, the first is q6),
             one of eight q1-shape statements (q1 without its ORDER BY,
             a quantity cut varies, the first is q1's rows) and one of
             eight q6-shape statements summing a DOUBLE, each submitted
             at once from eight threads while the server's executor is
             held: one admission batch of 8, a plan template, the
             ``agg_stage_vmapped`` disposition, every member equal to
             the engine's serial run of its text (DOUBLEs bit for bit)
             and the first of q6 and q1 to the oracle, and no more kernel
             calls than one serial run (one folded call per page over
             8 x (cap + 1) segments, and the merge), each recorded; then
             the same burst again, recording nothing, with its wall; a
             denied user (PERMISSION_DENIED) and a burst member whose
             literal has another type (ANALYSIS_ERROR, its siblings
             equal to their serial runs);
             GET /v1/query/{id}, GET /v1/metrics and
             ``system.runtime.queries`` listing the statements above;
    serving_q6_hash, serving_q1_hash, serving_q6d_hash — each burst's
             hash kernel launches (one per folded hash-grouped page, the
             lane a leading operand), kept and replayed exactly;
    serving_q6_columns, serving_q1_columns, serving_q6d_columns — the
             bursts' recorded folded calls replayed like q3's (ints,
             MIN and MAX exactly, float sums within SUM_RTOL), the
             largest page call and the merge timed;
16. observability_sf1 — over the memory runner, the history store
             emptied first: q18 and q3 twice each with history on (rows
             against the oracle both times, the recorded history, the
             worst Q-error, plan flips, whether the second run
             re-planned); EXPLAIN ANALYZE VERBOSE of q1 and q18, twice
             each (the ``Kernels:`` line, "0 new" on the repeat, the
             profiler's ``segment_reduce_pallas`` calls equal to the
             kernel's launches of the run, its CUDA-event device time
             above 0 and within the run's wall, the programs' summed
             device time beside the wall); ``system.runtime.kernels``,
             ``plan_stats``, a slow-query record in
             ``system.runtime.queries`` and the new families in GET
             /v1/metrics, ``trino_device_memory_bytes`` read from the
             card; q1's warm wall with profiling off and on, and with
             history off and on, in turns; the runs planned from history
             (q18's and q3's second), the first VERBOSE run of q1 and of
             q18 and the slow q6 record their kernel calls;
    observability_{q18_run2,q3_run2,verbose_q1_run1,verbose_q18_run1,
    slow_q6}_columns — those calls replayed like q3's, exact, page and
             merge timed;
17. the wall of the whole script;
18. the ``kernels`` line: per kernel its route, source, the TPU kernel it
   replaces, launches on the main path (the sum over every query run
   above, with the count of each beside it, and the profiler's count of
   each VERBOSE run's calls), its error against the plain
   version, its time, the plain version's, the library call's and its
   memory/compute bound at the main path's shape (q1's page call), the
   wrapper's host us per step at the 8,192-lane call
   (``wrapper_host_us``), the columns phase's merges
   (``columns_shapes``), and the same, with each bound share, at the
   page and merge calls of every replay above
   (``q3_shapes``, ``q18_shapes``, ``memory_q3_shapes``,
   ``memory_q18_shapes``, ``distributed_q1_shapes``,
   ``distributed_q18_shapes``, ``distributed_q1_d4_shapes``,
   ``distributed_q18_d4_shapes``, ``mesh_q1_shapes``,
   ``device_step_shapes``, ``process_threads_q*_shapes``,
   ``process_q*_shapes``, ``spill_q18_shapes``,
   and ``observability_*_shapes``) and of the serving
   bursts' folded calls (``serving_shapes``);
   The line's second entry is the hash kernel's: its route, source, the
   JAX program it replaces (a jit ``while_loop``, not a Pallas kernel),
   its launches on the main path (every run that counts segment-reduce
   launches, each beside it; where the run's result carries operator
   stats, equal to its hash-grouped pages), its error against the plain
   version, its times, the plain version's and its bound at q1's page,
   the rounds it ran, and the same at every hash_kernel input
   (``case_shapes``) and at the timed calls of each replay
   (``q1_shapes``, ``q3_shapes``, ``q18_shapes``, ``process_q*_shapes``,
   ``distributed_*_shapes``, ``serving_*_burst_shapes``);
19. the last line: ``{"ok": true, "device": {...}}``.

Any failed check raises; nothing is caught, so a failed phase ends the
run with a non-zero exit code before the last line is printed.
"""

import ast
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
#: the script's start, for the wall of the whole run
T0 = time.perf_counter()

#: H100 SXM HBM3 bandwidth (NVIDIA data sheet) for the memory bound
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores, used for the
#: operations bound of the (add/compare) reductions
VECTOR_OPS_PER_S = 67e12
PAGE_ROWS = 262_144        # q1's aggregation page at SF1 (24 pages)
PAGE_LIVE = 250_000        # ~rows per page that reach the aggregation
MERGE_ROWS = 8_388_608     # the merge's lanes: padded_size(24 * PAGE_ROWS)
STATES_PER_PAGE = 15       # q1's int64 state columns
#: a float SUM may differ from the exact sum by this much of the
#: segment's sum of |x| (the kernel and the plain version add in
#: different orders)
SUM_RTOL = {"float32": 1e-5, "float64": 1e-12}


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started (``at_s``), the script's timeline."""
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - T0, 1)}
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, rows: int, iters: int = 10,
                     attempts: int = 3) -> dict:
    """Device time per call of the segment-reduce kernels that ``fn``
    launches over ``rows`` rows, per kernel (tile, carry) and in total,
    and the launches recorded per call, from torch.profiler: unlike
    ``time_ms`` it leaves out the wrapper's host work. Each kernel
    launches once per call (the carry kernel when the rows span more than
    one tile), and its time is the mean over the launches the profiler
    recorded: it drops records, now and then every record of a kernel in
    a window. A window that recorded no launch of a kernel the call makes
    is profiled again, up to ``attempts`` times; else the times are None,
    not measured."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from trino_tpu_torch.ops import kernels

    made = ("tile", "carry") if rows > kernels.TILE_ROWS else ("tile",)
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {"tile": 0.0, "carry": 0.0}
        counts = {"tile": 0, "carry": 0}
        for e in prof.key_averages():
            m = re.search(r"\b(tile|carry)_kernel\b", e.key)
            if m and e.device_type != DeviceType.CPU and e.count:
                out[m.group(1)] += e.self_device_time_total / 1e3 / e.count
                counts[m.group(1)] += e.count
        if all(counts[k] for k in made):
            out["total"] = out["tile"] + out["carry"]
            out["launches_per_call"] = sum(counts.values()) / iters
            return out
    return {"tile": None, "carry": None, "total": None,
            "launches_per_call": sum(counts.values()) / iters}


def _share(bound_ms: float, device_ms):
    """Bound ms over device ms, or None where the device time was not
    measured."""
    return None if device_ms is None else bound_ms / device_ms


def device_phase():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    card = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit({"phase": "device", **card})
    return card


def build_phase():
    from trino_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    paths = kernels.build()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "flags": " ".join(kernels.NVCC_FLAGS),
          "sources": [f"trino_tpu_torch/csrc/{source}"
                      for source in kernels.SOURCES],
          "libraries": [os.path.relpath(path, REPO) for path in paths]})


def _gids(rng, n: int, groups: int, live: int):
    """Sorted gids as the engine makes them: ``groups`` runs over the
    first ``live`` rows (steps of 1), then the dump segment ``n``."""
    import numpy as np

    b = np.zeros(n, dtype=np.int32)
    if groups > 1:
        b[np.sort(rng.choice(np.arange(1, live), groups - 1,
                             replace=False))] = 1
    gid = np.cumsum(b).astype(np.int32)
    gid[live:] = n
    return gid


def _values(rng, n: int, dtype: str):
    import numpy as np

    if dtype == "int32":
        return rng.integers(-2 ** 30, 2 ** 30, n, dtype=np.int64) \
            .astype(np.int32)
    if dtype == "int64":
        return rng.integers(-2 ** 62, 2 ** 62, n, dtype=np.int64)
    # multiples of 2^-10 in [0, 1000): exact in float32, and every partial
    # sum of up to MERGE_ROWS of them is exact in float64, so the plain
    # version on col.double() gives the exact sum in any order
    return (np.floor(rng.uniform(0.0, 1000.0, n) * 1024) / 1024) \
        .astype(dtype)


def _compare(got, kind, col, gid, ns, kernels, what):
    """``got`` against the plain version of ``col`` over ``gid``; returns
    the max abs error and the max error relative to the segment's sum of
    |x|. Ints and MIN/MAX must match exactly; a float SUM must be within
    SUM_RTOL * sum|x| of the exact sum, per segment."""
    import torch

    if not col.dtype.is_floating_point or kind != "sum":
        want = kernels.segment_reduce_reference(col, gid, ns, kind)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).nonzero()[:5].flatten().tolist()
            raise AssertionError(f"{what}: mismatch at segments {bad}")
        return 0.0, 0.0
    want = kernels.segment_reduce_reference(col.double(), gid, ns, "sum")
    mag = kernels.segment_reduce_reference(col.abs().double(), gid, ns,
                                           "sum")
    err = (got.double() - want).abs()
    limit = SUM_RTOL[str(col.dtype).removeprefix("torch.")] * mag
    if bool((err > limit).any()):
        i = int((err - limit).argmax())
        raise AssertionError(f"{what}: segment {i} error {float(err[i])} "
                             f"over limit {float(limit[i])}")
    rel = err / torch.where(mag > 0, mag, 1.0)
    return float(err.max()), float(rel.max())


def _check_case(kind, col, gid, ns, kernels):
    """The one-column kernel vs its plain version on one input."""
    return _compare(kernels.segment_reduce(col, gid, ns, kind), kind, col,
                    gid, ns, kernels, f"segment_reduce {kind} {col.dtype}")


def kernel_phase():
    """segment_reduce against its plain version, every kind x dtype."""
    import numpy as np
    import torch

    from trino_tpu_torch.ops import kernels

    rng = np.random.default_rng(20261016)
    dev = torch.device("cuda")
    cases = {  # name: (rows, groups, live rows before the dump tail)
        "q1_page": (PAGE_ROWS, 4, PAGE_LIVE),
        "many_groups": (PAGE_ROWS, PAGE_ROWS // 7, PAGE_ROWS - 1000),
        "merge": (MERGE_ROWS, 4, MERGE_ROWS - 1000),
        "merge_many_groups": (MERGE_ROWS, MERGE_ROWS // 7,
                              MERGE_ROWS - 1000),
        "ragged": (1000, 1000 // 7, 900),
    }
    timed = ("q1_page", "merge")
    for kind in kernels.SEGMENT_KINDS:
        for dtype in ("int32", "int64", "float32", "float64"):
            timings = {}
            errors = {}
            rel_errors = {}
            for case, (n, groups, live) in cases.items():
                gid = torch.from_numpy(_gids(rng, n, groups, live)).to(dev)
                col = torch.from_numpy(_values(rng, n, dtype)).to(dev)
                errors[case], rel_errors[case] = _check_case(
                    kind, col, gid, n + 1, kernels)
                if case not in timed:
                    continue
                gid64 = gid.to(torch.int64)
                out = torch.empty(n + 1, dtype=col.dtype, device=dev)
                if kind == "sum":
                    def library():
                        out.index_add_(0, gid64, col)
                else:
                    red = "amin" if kind == "min" else "amax"

                    def library():
                        out.scatter_reduce_(0, gid64, col, red,
                                            include_self=True)
                timings[case] = {
                    "kernel_ms": time_ms(lambda: kernels.segment_reduce(
                        col, gid, n + 1, kind)),
                    "plain_ms": time_ms(
                        lambda: kernels.segment_reduce_reference(
                            col, gid, n + 1, kind)),
                    "library_ms": time_ms(library),
                }
            emit({"phase": "kernel", "kernel": "segment_reduce",
                  "kind": kind, "dtype": dtype,
                  "shapes": {c: cases[c][0] for c in cases},
                  "sum_rtol": SUM_RTOL.get(dtype) if kind == "sum" else None,
                  "max_abs_err": errors, "max_rel_err": rel_errors,
                  "ms": timings})


def _hash_table(rng, n: int, live: int, dtypes, dev):
    """Columns and gids as q1's hash path hands them to the kernel: gids
    of 4 groups interleaved over the first ``live`` rows (the rest in the
    dump segment n), sorted, with the stable sort's permutation; one
    column per entry of ``dtypes``, each a rotation of one random column
    of its dtype."""
    import numpy as np
    import torch

    raw = rng.integers(0, 4, n).astype(np.int32)
    raw[live:] = n
    unsorted = torch.from_numpy(raw).to(dev)
    order = torch.sort(unsorted, stable=True).indices
    base = {dt: torch.from_numpy(_values(rng, n, dt)).to(dev)
            for dt in dict.fromkeys(dtypes)}
    cols = [base[dt].roll(7919 * i + 1) for i, dt in enumerate(dtypes)]
    return cols, unsorted, unsorted[order], order


def _check_columns(cols, gid, ns, kinds, order, kernels):
    """The many-column call vs its plain version; returns the max abs
    error over the columns."""
    got = kernels.segment_reduce_columns(cols, gid, ns, kinds, order)
    return max(_compare(out, kind, col if order is None else col[order],
                        gid, ns, kernels,
                        f"segment_reduce_columns column {i} {kind} "
                        f"{col.dtype}")[0]
               for i, (out, col, kind) in enumerate(zip(got, cols, kinds)))


#: the calls PERF.md tracks, as ``kernel_case`` builds them: (lanes,
#: page partials, lanes per partial, live lanes per partial, group ids of
#: a partial's live lanes, columns, read through ``order``)
KERNEL_CASES = {
    # q1's merge as q1 makes it: 24 page partials of 262,144 lanes with 4
    # live lanes each, padded to 8,388,608; 96 live
    "q1_merge": (MERGE_ROWS, 24, PAGE_ROWS, 4, "same", 15, True),
    # the same lanes as the sort path hands them over: columns already in
    # gid order, no permutation
    "q1_merge_sorted": (MERGE_ROWS, 24, PAGE_ROWS, 4, "same", 15, False),
    # q18's merge: 24 partials of 524,288 lanes, 62,500 live each, one
    # group per live lane (1,500,000 groups)
    "q18_merge": (16_777_216, 24, 524_288, 62_500, "distinct", 2, True),
    # the distributed q1 partial step's merge: 8 partials, 24 live
    "distributed_q1_merge": (4_194_304, 8, 524_288, 3, "same", 15, True),
    # process q3's merge: 4 partials of 2,048 lanes, 1,400 live each
    "process_q3_merge": (8_192, 4, 2_048, 1_400, "distinct", 2, True),
    # the mesh's merge-final: 4 senders of 16 lanes, 3 live each, 3
    # groups; 15 int64 SUM and the int32 first-row MIN, already sorted
    # (the sort path: no order)
    "mesh_merge_final": (64, 4, 16, 3, "same", 16, False),
}


def kernel_case(name: str, rng, dev):
    """(cols, gid, num_segments, kinds, order, unsorted gids) of one of
    ``KERNEL_CASES``: the partials' live lanes first in each, dead lanes
    in the dump segment n; gids sorted stably (``order`` the sort's
    permutation, or the columns gathered into gid order without it);
    int64 SUM columns, and the last an int32 MIN of 16 columns."""
    import numpy as np
    import torch

    n, pages, lanes, live, groups, ncols, with_order = KERNEL_CASES[name]
    raw = np.full(n, n, dtype=np.int64)
    for p in range(pages):
        base = p * live if groups == "distinct" else 0
        raw[p * lanes:p * lanes + live] = base + np.arange(live)
    unsorted = torch.from_numpy(raw.astype(np.int32)).to(dev)
    order = torch.sort(unsorted, stable=True).indices
    gid = unsorted[order].contiguous()
    kinds = ["sum"] * ncols
    cols = [torch.from_numpy(_values(rng, n, "int64")).to(dev)
            for _ in range(ncols)]
    if ncols == 16:
        kinds[-1] = "min"
        cols[-1] = torch.from_numpy(_values(rng, n, "int32")).to(dev)
    if not with_order:
        cols = [c[order].contiguous() for c in cols]
        return cols, gid, n + 1, kinds, None, gid
    return cols, gid, n + 1, kinds, order, unsorted


def wrapper_steps(cols, gid, ns, kinds, order, reps: int = 300) -> dict:
    """Host us per call of each step of ``segment_reduce_columns`` on the
    card, each timed alone over ``reps`` calls (``time.perf_counter_ns``):
    the checks, the plan, the outputs' allocation, the descriptor table's
    packing, the stream lookup, the library call (its launches), the
    profiled ``_run`` around it (instrument wrapper, count under its
    lock), and the whole call."""
    import torch

    from trino_tpu_torch.ops import kernels

    n = gid.shape[0]
    dtypes = [c.dtype for c in cols]
    dev = gid.get_device()
    plan = kernels.plan_columns(dtypes, kinds, n, ns)
    outs, ptrs, scratch = kernels.allocate_outputs(plan, ns, gid.device)

    def pack():
        return plan.table.pack(*[v for c, o, code in zip(cols, ptrs,
                                                         plan.codes)
                                 for v in (c.data_ptr(), o, code)])

    table = pack()
    stream = kernels._current_stream(dev)
    order_ptr = None if order is None else order.data_ptr()
    table_ptr = None if plan.table_offset < 0 else \
        scratch + plan.table_offset

    def library():
        kernels._lib.segment_reduce_columns(
            table, len(cols), gid.data_ptr(), order_ptr, n, ns,
            scratch + plan.carry_gid_offset, scratch + plan.carry_val_offset,
            table_ptr, stream)

    steps = {
        "check": lambda: kernels._check(cols, gid, order, ns),
        "plan": lambda: kernels.plan_columns(dtypes, kinds, n, ns),
        "allocate": lambda: kernels.allocate_outputs(plan, ns, gid.device),
        "pack": pack,
        "stream": lambda: kernels._current_stream(dev),
        "library": library,
        "run": lambda: kernels._run(cols, gid, order, outs, ns, tuple(kinds),
                                    plan, table, scratch),
        "call": lambda: kernels.segment_reduce_columns(cols, gid, ns, kinds,
                                                       order),
    }
    out = {}
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter_ns() - t0) / reps / 1e3
        torch.cuda.synchronize()
    return out


def columns_phase():
    """segment_reduce_columns as q1's hash path calls it, against its
    plain version, at the page and at the merge; times it beside the
    plain version, the one-column-at-a-time path and ``index_add_``."""
    import numpy as np
    import torch

    from trino_tpu_torch.ops import kernels

    rng = np.random.default_rng(20261017)
    dev = torch.device("cuda")

    # mixed table at the page: 34 int64 SUM (past 32 columns the descriptor
    # table goes to the device)
    # and two each of int32 MIN, float32 MAX, float64 SUM
    mixed = [("int64", "sum")] * 34 + [("int32", "min"), ("float32", "max"),
                                       ("float64", "sum")] * 2
    cols, _, gid, order = _hash_table(rng, PAGE_ROWS, PAGE_LIVE,
                                      [dt for dt, _ in mixed], dev)
    kinds = [kind for _, kind in mixed]
    mixed_err = {
        "order": _check_columns(cols, gid, PAGE_ROWS + 1, kinds, order,
                                kernels),
        "sorted": _check_columns(cols, gid, PAGE_ROWS + 1, kinds, None,
                                 kernels)}
    emit({"phase": "columns", "case": "mixed", "n": PAGE_ROWS,
          "columns": len(mixed), "max_abs_err": mixed_err})
    del cols

    main = None
    kinds = ["sum"] * STATES_PER_PAGE
    for case, (n, live) in {"page": (PAGE_ROWS, PAGE_LIVE),
                            "merge": (MERGE_ROWS, MERGE_ROWS - 1000)}.items():
        cols, unsorted, gid, order = _hash_table(
            rng, n, live, ["int64"] * STATES_PER_PAGE, dev)
        err = _check_columns(cols, gid, n + 1, kinds, order, kernels)
        block = torch.stack(cols, dim=1)          # (n, 15) int64
        out2d = torch.empty((n + 1, STATES_PER_PAGE), dtype=torch.int64,
                            device=dev)
        unsorted64 = unsorted.to(torch.int64)

        def one_column_at_a_time():
            for col in cols:
                kernels.segment_reduce(col[order], gid, n + 1, "sum")

        timings = {
            "kernel_ms": time_ms(lambda: kernels.segment_reduce_columns(
                cols, gid, n + 1, kinds, order)),
            "plain_ms": time_ms(
                lambda: kernels.segment_reduce_columns_reference(
                    cols, gid, n + 1, kinds, order)),
            "per_column_ms": time_ms(one_column_at_a_time),
            "library_ms": time_ms(
                lambda: out2d.index_add_(0, unsorted64, block)),
            "device_ms": kernel_device_ms(
                lambda: kernels.segment_reduce_columns(
                    cols, gid, n + 1, kinds, order), n),
        }
        # gid and order read once per row, each column read once per row
        # and written once per segment
        bytes_ = n * (4 + 8) + n * 8 * STATES_PER_PAGE \
            + (n + 1) * 8 * STATES_PER_PAGE
        emit({"phase": "columns", "case": case, "n": n,
              "columns": STATES_PER_PAGE, "kind": "sum", "dtype": "int64",
              "order": True, "groups": 4, "max_abs_err": err,
              "bytes": bytes_, "ms": timings})
        if case == "page":
            main = dict(timings, n=n, bytes=bytes_, max_abs_err=err)
        del cols, block, out2d

    # q1's merge as q1 makes it, and the small merges of the process
    # cluster (q3) and the mesh (the merge-final), each beside
    # ``index_add_`` over the unsorted gids, one call per column; at the
    # 8,192-lane call, the wrapper's host time per step
    shapes = {}
    for case in ("q1_merge", "process_q3_merge", "mesh_merge_final"):
        cols, gid, ns, kinds, order, unsorted = kernel_case(case, rng, dev)
        n = gid.shape[0]
        err = _check_columns(cols, gid, ns, kinds, order, kernels)
        unsorted64 = unsorted.to(torch.int64)
        outs = [torch.empty(ns, dtype=c.dtype, device=dev) for c in cols]

        def library():
            for out, col in zip(outs, cols):
                out.index_add_(0, unsorted64, col)

        def kernel():
            kernels.segment_reduce_columns(cols, gid, ns, kinds, order)

        bound_ms, bound_by, bytes_ = _bound_ms(cols, n, ns,
                                               order is not None)
        device = kernel_device_ms(kernel, n)
        shapes[case] = {
            "n": n, "live": int((gid < n).sum()), "columns": len(cols),
            "order": order is not None, "max_abs_err": err,
            "bytes": bytes_, "bound_ms": bound_ms, "bound_by": bound_by,
            "kernel_ms": time_ms(kernel),
            "plain_ms": time_ms(
                lambda: kernels.segment_reduce_columns_reference(
                    cols, gid, ns, kinds, order)),
            "library_ms": time_ms(library), "device_ms": device["total"],
            "device_kernels_ms": device,
            "bound_share": _share(bound_ms, device["total"])}
        if case == "process_q3_merge":
            shapes[case]["wrapper_host_us"] = wrapper_steps(
                cols, gid, ns, kinds, order)
        emit({"phase": "columns", "case": case, **shapes[case]})
        del cols, gid, order, unsorted, unsorted64, outs
    return main, shapes


#: the hash kernel's inputs (phase hash_kernel): name -> (rows, distinct
#: values per key column (None: every row its own key), null share, probe
#: rounds). q1's page (two keys of 3 and 2 values), a page of ~n/7 groups,
#: the largest cap the main path gives (q18's merge), a ragged cap, a
#: global aggregation, nulls in the keys, a near-full table (load factor
#: 1/2, every row its own key) under one and two rounds, where rows
#: overflow; small pages of one and two tiles (512 and 513 lanes) and of
#: 16,384 and 16,385 lanes, the process cluster's q3 merge (8,192 lanes)
#: and its q18 merge (1,048,576 lanes, ~740,000 groups, 22 rounds), and a
#: budget that takes 64-bit table entries
HASH_CASES = {
    "q1_page": (PAGE_ROWS, [3, 2], 0.0, 32),
    "many_groups": (PAGE_ROWS, [PAGE_ROWS // 7], 0.0, 32),
    "largest_cap": (16_777_216, [16_777_216 // 8], 0.0, 32),
    "ragged_cap": (1_000_003, [1_000_003 // 7, 3], 0.0, 32),
    "zero_keys": (PAGE_ROWS, [], 0.0, 32),
    "nulls": (PAGE_ROWS, [50, 40], 0.3, 32),
    "near_full_1_round": (PAGE_ROWS, [None], 0.0, 1),
    "near_full_2_rounds": (PAGE_ROWS, [None], 0.0, 2),
    "page_512": (512, [80], 0.0, 32),
    "page_513": (513, [80], 0.0, 32),
    "page_16384": (16_384, [16_384 // 7], 0.0, 32),
    "page_16385": (16_385, [16_385 // 7], 0.0, 32),
    "merge_8192": (8_192, [1_400], 0.0, 32),
    "many_rounds": (1_048_576, [1_600_000], 0.0, 32),
    "wide_entries": (PAGE_ROWS, [PAGE_ROWS // 7], 0.0, 1 << 14),
}


def hash_case_rng(case: str):
    """The generator of one ``HASH_CASES`` input: seeded by its name, so
    an input is the same whichever cases run before it."""
    import zlib

    import numpy as np

    return np.random.default_rng(zlib.crc32(case.encode()))


def _hash_inputs(rng, n: int, distinct, null_share: float, dev):
    """(key_ops, valid): a (uint8 null tag, int64 key) operand pair per key
    column, as ``group_operands`` makes them, and a valid mask whose last
    5% of lanes are dead."""
    import numpy as np
    import torch

    ops = []
    for d in distinct:
        key = rng.permutation(n) if d is None else rng.integers(0, d, n)
        key = key.astype(np.int64) * 1_000_003 - 11
        null = rng.random(n) < null_share
        ops += [torch.from_numpy(null.astype(np.uint8)).to(dev),
                torch.from_numpy(np.where(null, 0, key)).to(dev)]
    valid = torch.from_numpy(np.arange(n) < n - n // 20).to(dev)
    return ops, valid


def hash_barriers(taken: int, rounds: int) -> int:
    """The grid barriers a hash kernel call runs (csrc/hash_insert.cu):
    one after each phase but the last of a call that spends its budget,
    so never more than ``rounds + 1``."""
    if rounds == 0:
        return 0
    return taken + 1 if taken < rounds else rounds


def _hash_check(key_ops, valid, rounds: int, what: str) -> dict:
    """The kernel against its plain version on one call's inputs, exactly:
    rep, resolved and the rounds run; the barriers the call ran are the
    design's (``hash_barriers``). Returns the call's shape (rows, live
    rows, operands, groups, rounds run, unresolved rows, the plan's entry
    width, blocks and worklist spill, the barriers run) and the largest
    difference (0)."""
    import torch

    from trino_tpu_torch.ops import kernels

    run = kernels.hash_insert_run(key_ops, valid, rounds)
    rep, resolved, taken = run.rep, run.resolved, run.taken
    want = kernels.hash_insert_reference(key_ops, valid, rounds)
    err = max(int((rep.to(torch.int64) - want[0]).abs().max())
              if rep.numel() else 0,
              int((resolved != want[1]).sum()),
              abs(int(taken) - int(want[2])))
    if err:
        raise AssertionError(f"{what}: hash_insert differs from its plain "
                             f"version by {err}")
    barriers = int(run.barriers)
    if barriers != hash_barriers(int(taken), rounds):
        raise AssertionError(
            f"{what}: {barriers} barriers for {int(taken)} of {rounds} "
            "rounds")
    n = valid.shape[0]
    leaders = valid & (rep == torch.arange(n, device=rep.device))
    return {"n": n, "live": int(valid.sum()), "operands": len(key_ops),
            "groups": int(leaders.sum()), "rounds": int(taken),
            "unresolved": int((~resolved).sum()), "width": run.plan.width,
            "blocks": run.plan.blocks, "spills": run.plan.spills,
            "barriers": barriers, "max_abs_err": err}


def _hash_bound_ms(key_ops, valid):
    """(bound ms, bound_by, bytes) of one ``hash_insert`` call: the key
    operands of the live rows read twice (the hash, the compare; no row
    reads a dead lane's keys), the valid mask once, the table
    (table_size(n) int32) written once, rep and resolved written once;
    against a few integer operations per operand and live row and per
    lane."""
    from trino_tpu_torch.ops import kernels

    n = valid.shape[0]
    live = int(valid.sum())
    bytes_ = 2 * live * sum(op.element_size() for op in key_ops) + n \
        + 4 * kernels.table_size(n) + 4 * n + n
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = (live * 8 * len(key_ops) + 8 * n) / VECTOR_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), \
        "bytes" if bytes_ms >= ops_ms else "operations", bytes_


def hash_device_ms(fn, iters: int = 10, attempts: int = 3):
    """Device time of one call of ``fn`` (one hash kernel call): every
    device op of a profiled window of calls (the table's memset and the
    kernel), each the mean over its recorded launches
    (the profiler drops records now and then), summed; and those means by
    op. (None, {}) (not measured) when no window recorded a kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ops = {e.key: e.self_device_time_total / 1e3 / e.count
               for e in prof.key_averages()
               if e.device_type != DeviceType.CPU and e.count}
        if any("kernel" in key for key in ops):
            return sum(ops.values()), ops
    return None, {}


def _time_hash(key_ops, valid, rounds: int, shape: dict) -> dict:
    """The kernel's times on one call's inputs beside its bound and the
    plain version's: back to back (``kernel_ms``, CUDA events over 20
    calls, the wrapper included), alone (``device_ms``, the profiler's
    kernel time), and one call after an idle card (``single_ms``, CUDA
    events around one call, median of 5)."""
    import statistics

    import torch

    from trino_tpu_torch.ops import kernels

    def kernel():
        kernels.hash_insert(key_ops, valid, rounds)

    single = []
    for _ in range(5):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        kernel()
        end.record()
        end.synchronize()
        single.append(start.elapsed_time(end))
    bound_ms, bound_by, bytes_ = _hash_bound_ms(key_ops, valid)
    device, device_ops = hash_device_ms(kernel)
    return {**shape, "bytes": bytes_, "bound_ms": bound_ms,
            "bound_by": bound_by, "kernel_ms": time_ms(kernel),
            "single_ms": statistics.median(single), "device_ms": device,
            "device_ops": device_ops,
            "bound_share": _share(bound_ms, device),
            "plain_ms": time_ms(lambda: kernels.hash_insert_reference(
                key_ops, valid, rounds), iters=5),
            "library_ms": None}


def hash_kernel_phase():
    """The hash kernel against its plain version at every input of
    ``HASH_CASES``, exactly (rep, resolved, the rounds run and the
    barriers run); each timed beside its bound and the plain version. No
    single PyTorch call computes first-occurrence group ids, so there is
    no library time."""
    import torch

    from trino_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    shapes = {}
    for case, (n, distinct, null_share, rounds) in HASH_CASES.items():
        ops, valid = _hash_inputs(hash_case_rng(case), n, distinct,
                                  null_share, dev)
        before = kernels.hash_insert.launches
        kernels.hash_insert(ops, valid, rounds)
        torch.cuda.synchronize()
        if kernels.hash_insert.launches != before + 1:
            raise AssertionError(f"hash_kernel {case}: "
                                 f"{kernels.hash_insert.launches - before} "
                                 "launches for one call")
        shape = _hash_check(ops, valid, rounds, f"hash_kernel {case}")
        if case.startswith("near_full") and not shape["unresolved"]:
            raise AssertionError(f"hash_kernel {case}: no row overflowed")
        if case == "many_rounds" and shape["rounds"] < 20 or \
                case == "wide_entries" and shape["width"] != 64:
            raise AssertionError(f"hash_kernel {case}: {shape['rounds']} "
                                 f"rounds, {shape['width']}-bit entries")
        shapes[case] = _time_hash(ops, valid, rounds, shape)
        emit({"phase": "hash_kernel", "case": case, "probe_budget": rounds,
              "null_share": null_share, **shapes[case]})
        del ops, valid
    return shapes


#: a timed replay whose rows are at most this many is written to the
#: directory HASH_CALLS_DIR names, when it names one, for
#: ``scripts/hash_group_ab.py --kernel`` to time on two trees
HASH_KEEP_ROWS = 1 << 25


def hash_replay_phase(phase: str, calls, page_by: str = "live"):
    """Every recorded ``hash_insert`` launch of a run, on the inputs the
    run gave it, against the plain version, exactly; then the call with
    the most groups (the merge, the last of equals) and, of the others,
    the one with the most ``page_by`` (the page) timed like the
    hash_kernel phase's (``columns_replay_phase``'s picks)."""
    if not calls:
        raise AssertionError(f"{phase}: no hash_insert launch was kept")
    shapes = [_hash_check(ops, valid, rounds, f"{phase} call {i}")
              for i, (ops, valid, rounds) in enumerate(calls)]
    emit({"phase": phase, "calls": len(calls),
          "operands": sorted({s["operands"] for s in shapes}),
          "rounds": sorted({s["rounds"] for s in shapes}),
          "shapes": shapes, "max_abs_err": 0})
    merge = max(range(len(calls)), key=lambda i: (shapes[i]["groups"], i))
    picks = {"merge": merge}
    others = [i for i in range(len(calls)) if i != merge]
    if others:
        picks["page"] = max(others, key=lambda i: shapes[i][page_by])
    timed = {}
    keep = os.environ.get("HASH_CALLS_DIR")
    for case, i in picks.items():
        ops, valid, rounds = calls[i]
        timed[case] = {"call": i, **_time_hash(ops, valid, rounds,
                                               shapes[i])}
        emit({"phase": phase, "case": case, **timed[case]})
        if keep and valid.shape[0] <= HASH_KEEP_ROWS:
            import torch

            os.makedirs(keep, exist_ok=True)
            torch.save(([op.cpu() for op in ops], valid.cpu(), rounds),
                       os.path.join(keep, f"{phase}.{case}.pt"))
    return timed


def _hash_pages(res) -> int:
    """Pages the run's aggregations grouped on the hash path (one hash
    kernel launch each)."""
    return sum(op.get("grouping_paths", {}).get("hash", 0)
               for op in res.stats.get("operators", ())
               if op["name"] == "HashAggregationOperator")


#: the hash kernel's launches by run, under the keys of the segment-reduce
#: entry's ``launches_by_query`` (``_hash_launched``)
HASH_LAUNCHES = {}


def _hash_launched(name: str, res=None, at_least: bool = False) -> int:
    """The hash kernel's launches since the counters were last reset,
    added to ``HASH_LAUNCHES[name]``. With ``res`` (the run's result) they
    must equal its hash-grouped pages (``at_least``: be no fewer, where a
    spilled merge re-groups reloaded partials in chunks)."""
    from trino_tpu_torch.ops import kernels

    made = kernels.hash_insert.launches
    if res is not None:
        pages = _hash_pages(res)
        if made < pages or (made != pages and not at_least):
            raise AssertionError(
                f"{name}: hash_insert launched {made} times for {pages} "
                "hash-grouped pages (want one per page)")
    HASH_LAUNCHES[name] = HASH_LAUNCHES.get(name, 0) + made
    return made


def _load_expected(qid: int):
    """``EXPECTED[qid]`` of tests/sf1_expected.py, read as data."""
    path = os.path.join(REPO, "tests", "sf1_expected.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "EXPECTED":
            return ast.literal_eval(node.value)[qid]
    raise AssertionError(f"{path} holds no EXPECTED")


def _assert_same(res, oracle_rows, query: str):
    """tests/test_tpch_oracle.py's comparison, rows in order: decimals as
    floats, dates as ISO strings, the oracle quantized to each decimal
    column's scale, floats within rel 1e-6 / abs 0.011 (half-up vs
    half-even on .5 ties)."""
    import datetime
    import math
    from decimal import Decimal

    def norm(v, t=None):
        if isinstance(v, Decimal):
            return float(v)
        if t is not None and t.name == "date" and isinstance(v, int):
            return (datetime.date(1970, 1, 1)
                    + datetime.timedelta(days=v)).isoformat()
        return v

    def quantize(v, t):
        if v is not None and t.is_decimal and isinstance(v, float):
            return round(v, t.scale)
        return v

    def close(a, b):
        if a is None or b is None:
            return a is None and b is None
        if isinstance(a, float) or isinstance(b, float):
            return math.isclose(float(a), float(b), rel_tol=1e-6,
                                abs_tol=0.011)
        return a == b

    got = [tuple(norm(v, t) for v, t in zip(row, res.types))
           for row in res.rows]
    want = [tuple(quantize(norm(v), t) for v, t in zip(row, res.types))
            for row in oracle_rows]
    if len(got) != len(want):
        raise AssertionError(f"{query}: {len(got)} rows, oracle {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        for j, (a, b) in enumerate(zip(g, w)):
            if not close(a, b):
                raise AssertionError(
                    f"{query} row {i} col {j}: engine={a!r} oracle={b!r}")


def _aggregated_pages(res) -> int:
    return sum(sum(op.get("grouping_paths", {}).values())
               for op in res.stats["operators"]
               if op["name"] == "HashAggregationOperator")


def q1_phase(card, walls):
    import torch

    from trino_tpu_torch import LocalQueryRunner
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.ops import kernels
    from trino_tpu_torch.resources.tpch_queries import TPCH_QUERIES
    from trino_tpu_torch.sql.analyzer import Session

    runner = LocalQueryRunner({"tpch": TpchConnector(page_rows=1 << 16)},
                              Session(catalog="tpch", schema="sf1"),
                              desired_splits=8, device="cuda")
    sql = TPCH_QUERIES[1]
    t0 = time.perf_counter()
    kernels.record_calls(True, "hash_insert")
    cold = runner.execute(sql)                # cold: loads the libraries
    hash_calls = kernels.record_calls(False, "hash_insert")
    cold_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    kernels.launch_counts(reset=True)
    t0 = time.perf_counter()
    res = runner.execute(sql)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    walls[1] = round(warm_s, 4)
    _assert_same(res, _load_expected(1), "q1")
    pages = _aggregated_pages(res)
    if pages == 0 or launches["segment_reduce"] != pages:
        raise AssertionError(
            f"segment_reduce launched {launches['segment_reduce']} times "
            f"for {pages} aggregated pages (want one per page)")
    _check_hash_launches("q1", launches, res, cold, hash_calls)
    rows = sum(r[-1] for r in res.rows)       # count(*) over all groups
    emit({"phase": "q1_sf1", "rows_out": len(res.rows),
          "matches_oracle": True, "aggregated_pages": pages,
          "launches": launches, "cold_s": round(cold_s, 3),
          "warm_s": round(warm_s, 4), "hbo": _hbo_note(res),
          "lineitem_rows_aggregated": rows,
          "aggregated_rows_per_s": round(rows / warm_s),
          "peak_bytes": res.stats["memory"]["peak_bytes"],
          "card": card["nvidia_smi"]})
    return launches, hash_calls


def _check_hash_launches(query: str, launches: dict, res, cold,
                         hash_calls) -> None:
    """The hash kernel launched once per hash-grouped page of the warm
    run, some, and the cold run kept one call per hash-grouped page."""
    pages = _hash_pages(res)
    if pages == 0 or launches["hash_insert"] != pages or \
            len(hash_calls) != _hash_pages(cold):
        raise AssertionError(
            f"{query}: hash_insert launched {launches['hash_insert']} times "
            f"for {pages} hash-grouped pages (cold run: {len(hash_calls)} "
            f"kept for {_hash_pages(cold)}; want one per page, and some)")


#: the aggregation step a thread's kernel call serves (``_step_labels``)
_STEP = threading.local()
_RECORD_LOCK = threading.Lock()


def _recording(calls, labels=None):
    """A stand-in for ``segment_reduce_columns`` that keeps a copy of
    each call's inputs in ``calls`` (and, with ``labels``, the step
    label of the calling thread beside it) and then makes the call.
    Safe for the tasks of a distributed query, which call from several
    threads."""
    from trino_tpu_torch.ops import kernels

    def record(cols, gid, num_segments, kinds, order=None):
        entry = ([c.clone() for c in cols], gid.clone(), num_segments,
                 list(kinds), None if order is None else order.clone())
        with _RECORD_LOCK:
            calls.append(entry)
            if labels is not None:
                labels.append(getattr(_STEP, "label", None))
        return kernels.segment_reduce_columns(cols, gid, num_segments, kinds,
                                              order)
    return record


@contextlib.contextmanager
def _recorded(calls, labels=None):
    """Within the block, every ``segment_reduce_columns`` call of the
    engine's aggregation paths (serial and burst) keeps a copy of its
    inputs in ``calls``; with ``labels``, the aggregation step of each
    call (``_step_labels``) too."""
    from trino_tpu_torch.exec import batched
    from trino_tpu_torch.ops import aggregation, hashtable, kernels

    callers = (aggregation, hashtable, batched)
    for module in callers:
        module.segment_reduce_columns = _recording(calls, labels)
    try:
        with _step_labels() if labels is not None \
                else contextlib.nullcontext():
            yield
    finally:
        for module in callers:
            module.segment_reduce_columns = kernels.segment_reduce_columns


@contextlib.contextmanager
def _step_labels():
    """Within the block, an aggregation's kernel call is labelled on its
    thread with the operator's step and whether it reduces a page or
    merges the partials: ``partial_page``, ``partial_merge``,
    ``final_page``, ``final_merge`` (or ``single_*``)."""
    from trino_tpu_torch.ops.aggregation import HashAggregationOperator

    op = HashAggregationOperator
    page, merge = op._aggregate_page, op._merge_chunk

    def labelled_page(self, *args, **kwargs):
        what = "merge" if getattr(_STEP, "merging", False) else "page"
        _STEP.label = f"{self.step}_{what}"
        try:
            return page(self, *args, **kwargs)
        finally:
            _STEP.label = None      # pooled task threads run other tasks

    def labelled_merge(self, chunk):
        _STEP.merging = True
        try:
            return merge(self, chunk)
        finally:
            _STEP.merging = False

    op._aggregate_page, op._merge_chunk = labelled_page, labelled_merge
    try:
        yield
    finally:
        op._aggregate_page, op._merge_chunk = page, merge


def q3_phase(card, walls):
    """q3 at SF1; returns the launches of the warm run and the inputs of
    every kernel call of the cold run (the same calls: the data and the
    operators' capacity guesses are the same in both runs)."""
    import torch

    from trino_tpu_torch import LocalQueryRunner
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.ops import kernels
    from trino_tpu_torch.resources.tpch_queries import TPCH_QUERIES
    from trino_tpu_torch.sql.analyzer import Session

    runner = LocalQueryRunner({"tpch": TpchConnector(page_rows=1 << 16)},
                              Session(catalog="tpch", schema="sf1"),
                              desired_splits=8, device="cuda")
    sql = TPCH_QUERIES[3]
    calls = []
    t0 = time.perf_counter()
    kernels.record_calls(True, "hash_insert")
    with _recorded(calls):
        cold = runner.execute(sql)
    hash_calls = kernels.record_calls(False, "hash_insert")
    cold_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.launch_counts(reset=True)
    t0 = time.perf_counter()
    res = runner.execute(sql)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    walls[3] = round(warm_s, 4)
    _assert_same(res, _load_expected(3), "q3")
    pages = _aggregated_pages(res)
    if pages == 0 or launches["segment_reduce"] != pages \
            or len(calls) != _aggregated_pages(cold):
        raise AssertionError(
            f"q3: segment_reduce launched {launches['segment_reduce']} "
            f"times (cold run: {len(calls)} calls for "
            f"{_aggregated_pages(cold)}) for {pages} aggregated pages "
            "(want one per page)")
    _check_hash_launches("q3", launches, res, cold, hash_calls)
    dfs = res.stats["dynamic_filters"]
    joins = [{"name": op["name"],
              "strategy": op.get("strategy", "sorted-index"),
              **({"fallback": op["fallback"]} if "fallback" in op else {})}
             for op in res.stats["operators"] if "Join" in op["name"]]
    if len(joins) != 2 or len(dfs) != 2 or not all(d["ready"] for d in dfs):
        raise AssertionError(f"q3: joins {joins}, dynamic filters {dfs}")
    emit({"phase": "q3_sf1", "rows_out": len(res.rows),
          "matches_oracle": True, "aggregated_pages": pages,
          "launches": launches, "cold_s": round(cold_s, 3),
          "warm_s": round(warm_s, 4),
          "lineitem_rows_scanned": next(
              d["scanned_rows"] for d in dfs
              if d["filter"].startswith("l_orderkey")),
          "dynamic_filters": dfs, "joins": joins, "hbo": _hbo_note(res),
          "peak_bytes": res.stats["memory"]["peak_bytes"],
          # less the recorded inputs, which the warm run found resident
          "device_peak_bytes": torch.cuda.max_memory_allocated()
          - _recorded_bytes(calls, hash_calls),
          "card": card["nvidia_smi"]})
    return launches, calls, hash_calls


def _recorded_bytes(calls, hash_calls) -> int:
    """Device bytes held by the kept inputs of kernel calls."""
    return sum(t.nbytes for cols, gid, _, _, order in calls
               for t in [*cols, gid] + ([] if order is None else [order])) \
        + sum(t.nbytes for ops, valid, _ in hash_calls
              for t in [*ops, valid])


def _hbo_note(res):
    """How history served a warm run: the plan from the plan cache, the
    shape's template (history earns one at once), or re-planned after
    the cold run's material misestimate; and this run's recording
    (nodes, material, worst Q-error)."""
    hbo = (res.stats or {}).get("hbo") or {}
    worst = hbo.get("worst") or {}
    return {"plan_cache": (res.stats or {}).get("plan_cache"),
            "plan_template": (res.stats or {}).get("plan_template"),
            "recorded": hbo.get("recorded"),
            "material": hbo.get("material"),
            "worst_qerror": worst.get("qerror")}


def _join_strategies(res):
    return [{"name": op["name"],
             "strategy": op.get("strategy", "sorted-index"),
             **({"fallback": op["fallback"]} if "fallback" in op else {})}
            for op in res.stats["operators"] if "Join" in op["name"]]


def _sf1_runner(device="cuda", schema="sf1"):
    from trino_tpu_torch import LocalQueryRunner
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.sql.analyzer import Session

    return LocalQueryRunner({"tpch": TpchConnector(page_rows=1 << 16)},
                            Session(catalog="tpch", schema=schema),
                            desired_splits=8, device=device)


def tpch_sf1_phase(card, qid: int, walls, calls=None, hash_calls=None):
    """TPC-H ``qid`` at SF1, held against the oracle; cold and warm wall,
    segment-reduce calls (one per aggregated page), hash kernel launches
    (one per hash-grouped page) and the joins' strategies. With
    ``calls`` (``hash_calls``), the cold run keeps a copy of the inputs
    of every segment-reduce call (hash kernel launch) it makes. Returns
    the warm run's launches of each kernel."""
    import torch

    from trino_tpu_torch.ops import kernels
    from trino_tpu_torch.resources.tpch_queries import TPCH_QUERIES

    runner = _sf1_runner()
    sql = TPCH_QUERIES[qid]
    t0 = time.perf_counter()
    kernels.record_calls(True, "hash_insert")
    with _recorded(calls) if calls is not None else contextlib.nullcontext():
        cold = runner.execute(sql)
    kept = kernels.record_calls(False, "hash_insert")
    cold_s = time.perf_counter() - t0
    if hash_calls is not None:
        hash_calls.extend(kept)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.launch_counts(reset=True)
    t0 = time.perf_counter()
    res = runner.execute(sql)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    walls[qid] = round(warm_s, 4)
    _assert_same(res, _load_expected(qid), f"q{qid}")
    pages = _aggregated_pages(res)
    if pages == 0 or launches["segment_reduce"] != pages or \
            (calls is not None and len(calls) != _aggregated_pages(cold)):
        raise AssertionError(
            f"q{qid}: segment_reduce launched {launches['segment_reduce']} "
            f"times (cold run: {None if calls is None else len(calls)} "
            f"calls) for {pages} aggregated pages (want one per page)")
    _check_hash_launches(f"q{qid}", launches, res, cold, kept)
    del kept
    emit({"phase": f"q{qid}_sf1", "rows_out": len(res.rows),
          "matches_oracle": True, "aggregated_pages": pages,
          "hash_pages": _hash_pages(res), "launches": launches,
          "cold_s": round(cold_s, 3), "warm_s": round(warm_s, 4),
          "joins": _join_strategies(res), "hbo": _hbo_note(res),
          "peak_bytes": res.stats["memory"]["peak_bytes"],
          "device_peak_bytes": torch.cuda.max_memory_allocated()
          - _recorded_bytes(calls or [], hash_calls or []),
          "card": card["nvidia_smi"]})
    return launches


#: window aggregates over orders: four window specifications of
#: partition o_custkey (frames count apart), so four WindowOperators
WINDOW_AGGS_SQL = """
select count(*), sum(rn), sum(rk), sum(run), sum(mv), sum(mx), sum(prv) from (
  select row_number() over (partition by o_custkey
                            order by o_orderdate, o_orderkey) rn,
         rank() over (partition by o_custkey order by o_orderpriority) rk,
         sum(o_totalprice) over (partition by o_custkey
                                 order by o_orderdate, o_orderkey) run,
         sum(o_totalprice) over (partition by o_custkey
                                 order by o_orderdate, o_orderkey
                                 rows between 2 preceding and current row) mv,
         max(o_totalprice) over (partition by o_custkey
                                 order by o_orderdate, o_orderkey
                                 rows between 3 preceding and 1 following) mx,
         lag(o_orderkey) over (partition by o_custkey
                               order by o_orderdate, o_orderkey) prv
  from orders)"""
#: grouped top-N: the filter on row_number plans to a TopNRanking node
GROUPED_TOPN_SQL = """
select count(*), sum(o_orderkey), sum(rn) from (
  select o_orderkey, row_number() over (partition by o_custkey
         order by o_totalprice desc, o_orderkey) rn from orders)
where rn <= 3"""


def orders_columns(schema: str):
    """o_orderkey, o_custkey, o_orderdate, the rank of o_orderpriority
    and o_totalprice (unscaled cents) of every order, read through the
    torch engine's TpchConnector page source on the host."""
    import numpy as np

    from trino_tpu_torch.connectors.tpch import TpchConnector

    conn = TpchConnector(page_rows=1 << 16)
    meta = conn.metadata()
    handle = meta.get_table_handle(schema, "orders")
    by_name = {c.name: c for c in meta.get_columns(handle)}
    names = ["o_orderkey", "o_custkey", "o_orderdate", "o_orderpriority",
             "o_totalprice"]
    parts = {n: [] for n in names}
    for split in conn.split_manager().get_splits(handle, 8):
        src = conn.page_source(split, [by_name[n] for n in names])
        while not src.is_finished():
            page = src.get_next_page()
            if page is None:
                continue
            for n, b in zip(names, page.blocks):
                if b.nulls is not None and bool(np.asarray(b.nulls).any()):
                    raise AssertionError(f"{n} holds NULLs")
                if n == "o_orderpriority":
                    values = b.dictionary.values
                    order = {v: i for i, v in enumerate(sorted(set(values)))}
                    lut = np.asarray([order[v] for v in values], np.int64)
                    parts[n].append(lut[b.data])
                else:
                    parts[n].append(np.asarray(b.data, dtype=np.int64))
        src.close()
    return [np.concatenate(parts[n]) for n in names]


def _partition_starts(part):
    """Index of each sorted row's partition start, and its partition end."""
    import numpy as np

    n = len(part)
    idx = np.arange(n)
    start = np.r_[True, part[1:] != part[:-1]]
    end = np.r_[part[1:] != part[:-1], True]
    pstart = np.maximum.accumulate(np.where(start, idx, 0))
    pend = np.minimum.accumulate(np.where(end, idx, n)[::-1])[::-1]
    return idx, pstart, pend


def window_oracle(schema: str):
    """The rows of WINDOW_AGGS_SQL and GROUPED_TOPN_SQL from numpy alone
    (lexsort, cumsum): decimals as unscaled integers."""
    import numpy as np

    key, cust, date, prio, price = orders_columns(schema)
    o = np.lexsort((key, date, cust))
    k, p = key[o], price[o]
    idx, pstart, pend = _partition_starts(cust[o])
    rn = idx - pstart + 1
    csum = np.cumsum(p)
    before = lambda lo: np.where(lo > 0, csum[np.maximum(lo - 1, 0)], 0)
    run = csum - before(pstart)
    mv = csum - before(np.maximum(idx - 2, pstart))
    mx = p.copy()
    for s in (1, 2, 3):
        ok = idx - s >= pstart
        mx = np.where(ok, np.maximum(mx, p[np.maximum(idx - s, 0)]), mx)
    ok = idx + 1 <= pend
    mx = np.where(ok, np.maximum(mx, p[np.minimum(idx + 1, len(p) - 1)]),
                  mx)
    has_prev = idx - 1 >= pstart
    prv = int(k[np.maximum(idx - 1, 0)][has_prev].sum())
    o2 = np.lexsort((prio, cust))
    pr = prio[o2]
    idx2, pstart2, _ = _partition_starts(cust[o2])
    rstart = (idx2 == pstart2) | np.r_[True, pr[1:] != pr[:-1]]
    rk = np.maximum.accumulate(np.where(rstart, idx2, 0)) - pstart2 + 1
    aggs = (len(key), int(rn.sum()), int(rk.sum()), int(run.sum()),
            int(mv.sum()), int(mx.sum()), prv)
    o3 = np.lexsort((key, -price, cust))
    idx3, pstart3, _ = _partition_starts(cust[o3])
    rn3 = idx3 - pstart3 + 1
    keep = rn3 <= 3
    topn = (int(keep.sum()), int(key[o3][keep].sum()), int(rn3[keep].sum()))
    return {"window_aggs": aggs, "grouped_topn": topn}


def _unscaled(row, types):
    """A result row with decimals as unscaled integers."""
    from decimal import Decimal

    return tuple(int(v.scaleb(t.scale)) if isinstance(v, Decimal) else v
                 for v, t in zip(row, types))


def window_phase(card, schema: str = "sf1", device: str = "cuda"):
    """The two window queries over orders, each against the numpy oracle,
    exactly; the window aggregates must have run WindowOperators and the
    top-N query a GroupedTopNOperator. Returns the warm runs' launches."""
    import torch

    from trino_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    want = window_oracle(schema)
    oracle_s = time.perf_counter() - t0
    runner = _sf1_runner(device, schema)
    launches = 0
    for name, sql, op_name in (
            ("window_aggs", WINDOW_AGGS_SQL, "WindowOperator"),
            ("grouped_topn", GROUPED_TOPN_SQL, "GroupedTopNOperator")):
        t0 = time.perf_counter()
        runner.execute(sql)
        cold_s = time.perf_counter() - t0
        if device == "cuda":
            torch.cuda.synchronize()
        kernels.launch_counts(reset=True)
        t0 = time.perf_counter()
        res = runner.execute(sql)
        if device == "cuda":
            torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        launches += kernels.segment_reduce.launches
        if device == "cuda":
            _hash_launched("window", res)
        got = _unscaled(res.rows[0], res.types)
        if len(res.rows) != 1 or got != want[name]:
            raise AssertionError(f"{name}: engine {res.rows} "
                                 f"oracle {want[name]}")
        ops = [op["name"] for op in res.stats["operators"]]
        if op_name not in ops or (name == "grouped_topn"
                                  and "WindowOperator" in ops):
            raise AssertionError(f"{name}: operators {ops}")
        emit({"phase": "window_sf1", "query": name, "schema": schema,
              "rows": list(got), "matches_oracle": True,
              "operators": {o: ops.count(o) for o in (
                  "WindowOperator", "GroupedTopNOperator")},
              "cold_s": round(cold_s, 3), "warm_s": round(warm_s, 4),
              "oracle_s": round(oracle_s, 3),
              "card": card["nvidia_smi"]})
    return launches


#: one statement each of DISTINCT, UNION ALL, INTERSECT, EXCEPT, UNNEST
#: and a scalar subquery, at tiny
SURFACE_SQL = [
    "select distinct l_returnflag, l_linestatus, l_shipmode from lineitem",
    "select n_name from nation union all select r_name from region",
    "select o_custkey from orders intersect select c_custkey from customer "
    "where c_mktsegment = 'BUILDING'",
    "select s_nationkey from supplier except select c_nationkey from "
    "customer where c_acctbal > 9000",
    "select n_name, w, o from nation cross join unnest(split(n_name, ' ')) "
    "with ordinality t(w, o)",
    "select c_custkey, c_acctbal from customer where c_acctbal > "
    "(select avg(c_acctbal) from customer) and c_custkey < 400",
]


def _same_rows(got, want, what: str):
    """The tests' comparison over rows as sorted lists: same types,
    decimals and integers exactly, DOUBLE within a relative 1e-12, NaN
    equal to NaN."""
    import math

    got, want = sorted(got, key=repr), sorted(want, key=repr)
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} rows, want {len(want)}")
    for rg, rw in zip(got, want):
        for x, y in zip(rg, rw):
            if type(x) is not type(y):
                raise AssertionError(f"{what}: {rg} vs {rw}")
            if isinstance(x, float) and math.isnan(y):
                ok = math.isnan(x)
            elif isinstance(x, float):
                ok = math.isclose(x, y, rel_tol=1e-12)
            else:
                ok = x == y
            if not ok:
                raise AssertionError(f"{what}: {rg} vs {rw}")


def sql_surface_phase(card):
    """The 22 TPC-H queries at tiny (q19 at micro: its join expands to
    ~100 mostly dead pages at tiny, a minute on the CPU path), the 32
    TPC-DS queries at micro and SURFACE_SQL on the card and on the
    engine's own CPU path; the rows must agree (as sorted lists).
    Returns the card runs' launches."""
    import torch

    from trino_tpu_torch import LocalQueryRunner
    from trino_tpu_torch.connectors.tpcds import TpcdsConnector
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.ops import kernels
    from trino_tpu_torch.resources.tpcds_queries import TPCDS_QUERIES
    from trino_tpu_torch.resources.tpch_queries import TPCH_QUERIES
    from trino_tpu_torch.sql.analyzer import Session

    tiny = sorted(set(TPCH_QUERIES) - {19})
    suites = [("tpch", "tiny", TpchConnector,
               [(f"tpch_q{q}", TPCH_QUERIES[q]) for q in tiny]
               + [(f"surface_{i}", q) for i, q in enumerate(SURFACE_SQL)]),
              ("tpch", "micro", TpchConnector,
               [("tpch_q19", TPCH_QUERIES[19])]),
              ("tpcds", "micro", lambda: TpcdsConnector(page_rows=8192),
               [(f"tpcds_q{q}", TPCDS_QUERIES[q])
                for q in sorted(TPCDS_QUERIES)])]
    launches = 0
    card_s = cpu_s = 0.0
    checked = []
    for catalog, schema, make, queries in suites:
        runners = {dev: LocalQueryRunner(
            {catalog: make()}, Session(catalog=catalog, schema=schema),
            device=dev) for dev in ("cuda", "cpu")}
        for name, sql in queries:
            kernels.launch_counts(reset=True)
            t0 = time.perf_counter()
            res = runners["cuda"].execute(sql)
            got = res.rows
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            launches += kernels.segment_reduce.launches
            _hash_launched("sql_surface", res if res.stats else None)
            want = runners["cpu"].execute(sql).rows
            cpu_s += time.perf_counter() - t1
            card_s += t1 - t0
            _same_rows(got, want, name)
            checked.append(name)
    emit({"phase": "sql_surface", "statements": len(checked),
          "equal_to_cpu_path": True, "card_s": round(card_s, 3),
          "cpu_s": round(cpu_s, 3), "launches": launches,
          "card": card["nvidia_smi"]})
    return launches


#: the memory tables of ``memory_sf1``: every column but the free-text
#: comments (each SF1 comment column is millions of distinct strings,
#: and no query of the phase reads one)
MEMORY_TABLES = {
    "lineitem": ["l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
                 "l_quantity", "l_extendedprice", "l_discount", "l_tax",
                 "l_returnflag", "l_linestatus", "l_shipdate",
                 "l_commitdate", "l_receiptdate", "l_shipinstruct",
                 "l_shipmode"],
    "orders": ["o_orderkey", "o_custkey", "o_orderstatus", "o_totalprice",
               "o_orderdate", "o_orderpriority", "o_clerk",
               "o_shippriority"],
    "customer": ["c_custkey", "c_name", "c_address", "c_nationkey",
                 "c_phone", "c_acctbal", "c_mktsegment"],
}
MEMORY_QUERIES = (1, 3, 6, 18)


def _busy_share(run) -> float:
    """Device busy share of one run: the self device time of every
    device-side event (kernels and copies) from torch.profiler over the
    host wall, as scripts/profile_torch_q1.py measures it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type != DeviceType.CPU) / 1e6
    return busy / wall


def _host_bytes(conn, table: str) -> int:
    data = conn.tables[("default", table)]
    return sum(b.numpy().data.nbytes + (0 if b.nulls is None
                                        else b.nulls.nbytes)
               for p in data.pages for b in p.blocks)


def memory_sf1_phase(card, tpch_warm, memory_warm):
    """CTAS of lineitem, orders and customer from ``tpch.sf1`` into
    memory tables (through the card: scan, project, TableWriter), then
    q1, q3, q6 and q18 over them, each held against the oracle, with cold
    and warm wall, the device busy share, the segment-reduce calls (one
    per aggregated page) and the joins' strategies, beside the same
    query's warm wall over the generator (``tpch_warm``). The cold runs
    of q3 and q18 keep a copy of the inputs of every kernel call they
    make. Returns the runner, the warm runs' launches per query, each
    query's unspilled peak bytes and the recorded calls per query; the
    warm walls go into ``memory_warm``."""
    import torch

    from trino_tpu_torch import LocalQueryRunner
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.ops import kernels
    from trino_tpu_torch.resources.tpch_queries import TPCH_QUERIES
    from trino_tpu_torch.sql.analyzer import Session

    tpch = TpchConnector(page_rows=1 << 16)
    mem = MemoryConnector()
    runner = LocalQueryRunner({"tpch": tpch, "memory": mem},
                              Session(catalog="memory", schema="default"),
                              desired_splits=8, device="cuda")
    ctas = {}
    for table, cols in MEMORY_TABLES.items():
        t0 = time.perf_counter()
        res = runner.execute(f"create table {table} as select "
                             f"{', '.join(cols)} from tpch.sf1.{table}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        meta = tpch.metadata()
        want = int(meta.get_statistics(
            meta.get_table_handle("sf1", table)).row_count)
        if res.rows != [(want,)]:
            raise AssertionError(f"CTAS {table}: wrote {res.rows}, the "
                                 f"table holds {want} rows")
        ctas[table] = {"wall_s": round(wall, 3), "rows": want,
                       "pages": len(mem.tables[("default", table)].pages),
                       "host_bytes": _host_bytes(mem, table)}
    emit({"phase": "memory_sf1", "ctas": ctas,
          "host_bytes": sum(c["host_bytes"] for c in ctas.values()),
          "card": card["nvidia_smi"]})
    launches, peaks, calls = {}, {}, {3: [], 18: []}
    for qid in MEMORY_QUERIES:
        sql = TPCH_QUERIES[qid]
        t0 = time.perf_counter()
        with _recorded(calls[qid]) if qid in calls \
                else contextlib.nullcontext():
            cold = runner.execute(sql)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        kernels.launch_counts(reset=True)
        t0 = time.perf_counter()
        res = runner.execute(sql)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        launches[qid] = kernels.segment_reduce.launches
        _hash_launched(f"memory_q{qid}", res)
        memory_warm[qid] = round(warm_s, 4)
        _assert_same(res, _load_expected(qid), f"memory q{qid}")
        pages, cold_pages = _aggregated_pages(res), _aggregated_pages(cold)
        if pages == 0 or launches[qid] != pages or \
                (qid in calls and len(calls[qid]) != cold_pages):
            raise AssertionError(
                f"memory q{qid}: segment_reduce launched {launches[qid]} "
                f"times (cold run: {len(calls.get(qid, []))} calls) for "
                f"{pages} aggregated pages (want one per page)")
        peaks[qid] = res.stats["memory"]["peak_bytes"]
        emit({"phase": "memory_sf1", "query": f"q{qid}",
              "rows_out": len(res.rows), "matches_oracle": True,
              "aggregated_pages": pages,
              "launches": {"segment_reduce": launches[qid]},
              "cold_s": round(cold_s, 3), "warm_s": round(warm_s, 4),
              "tpch_warm_s": tpch_warm.get(qid),
              "device_busy_share": _busy_share(lambda: runner.execute(sql)),
              "joins": _join_strategies(res), "hbo": _hbo_note(res),
              "peak_bytes": peaks[qid],
              "card": card["nvidia_smi"]})
    return runner, launches, peaks, calls


#: distributed_sf1: (run name, TPC-H query, session properties); the
#: joins of q3 and q18 shuffle both sides (PARTITIONED), the last run
#: takes the host exchange instead of the device exchange
#: (name, query, session properties, device slabs): one slab is the
#: runner's one device; four are ``["cuda:0"] * 4``, the mesh of the
#: device exchange over which each consumer reads its own slab
DISTRIBUTED_RUNS = (
    ("q1", 1, {}, 1),
    ("q3", 3, {"join_distribution_type": "PARTITIONED"}, 1),
    ("q18", 18, {"join_distribution_type": "PARTITIONED"}, 1),
    ("q3_host_exchange", 3, {"join_distribution_type": "PARTITIONED",
                             "device_exchange": False}, 1),
    ("q1_d4", 1, {}, 4),
    ("q3_d4", 3, {"join_distribution_type": "PARTITIONED"}, 4),
    ("q18_d4", 18, {"join_distribution_type": "PARTITIONED"}, 4),
)
DISTRIBUTED_WORKERS = 4
#: the runs whose cold run records its kernel calls for the timed replay
DISTRIBUTED_RECORDED = ("q1", "q18", "q1_d4", "q18_d4")


def _kernel_calls(res) -> int:
    """Kernel calls a distributed run made: one per page an aggregation
    reduced or merged (its hash and sort paths; a passed-through page
    makes none), summed over every task."""
    return sum(op.get("grouping_paths", {}).get(path, 0)
               for op in res.stats["operators"]
               if op["name"] == "HashAggregationOperator"
               for path in ("hash", "sort"))


def _consumer_pages(res) -> dict:
    """Per device boundary: the lanes of each consumer's page (its slab:
    slabs x ``per_dest``) against the live rows of the largest
    partition and of all partitions."""
    return {str(fid): {"slabs": len(ex["lane_rows"]),
                       "page_lanes": len(ex["lane_rows"]) * ex["per_dest"],
                       "live_rows_max": max(ex["partition_rows"]),
                       "live_rows": ex["rows"]}
            for fid, ex in sorted(res.stats["exchanges"].items())
            if ex and ex.get("kind") == "device"}


def _check_kept(calls, what: str) -> float:
    """Every kept kernel call (``kernels.record_calls``) against the
    plain version on its inputs; returns the max abs error."""
    from trino_tpu_torch.ops import kernels

    errs = [_check_columns(cols, gid, ns, kinds, order, kernels)
            for cols, gid, ns, kinds, order in calls]
    if not errs:
        raise AssertionError(f"{what}: no kernel call was kept")
    return max(errs)


def _exchange_summary(res) -> dict:
    """Each stage boundary's exchange stats, by producing fragment."""
    keys = ("kind", "rows", "partition_rows", "skew_ratio", "sizing_used",
            "per_dest", "observed_max_pair_rows", "lane_rows",
            "a2a_retries", "count_collectives", "data_collectives",
            "bytes_moved")
    return {str(fid): {k: ex[k] for k in keys if k in ex}
            for fid, ex in sorted(res.stats["exchanges"].items()) if ex}


def distributed_sf1_phase(card, runner, memory_warm):
    """The one-card distributed engine over the SF1 memory tables:
    ``DistributedQueryRunner(n_workers=4, desired_splits=8)`` runs q1,
    q3 and q18 (their joins PARTITIONED) and q3 again through the host
    exchange, each cold and warm, held against the oracle; each warm
    wall beside the local runner's warm wall over the same tables
    (``memory_warm``), the busy share, the exchange stats, the kernel
    calls (one per aggregated or merged page, partial and final steps)
    and the exchanges that ran (``DeviceExchange.total_collectives``);
    the kernel and the exchange must both have run. The cold runs of q1
    and q18 record their kernel calls with the step each serves. The
    runs named ``*_d4`` repeat q1, q3 and q18 over four device slabs of
    the card (``devices=["cuda:0"] * 4``): their warm walls stand beside
    the one-slab walls of the same run, each consumer page's lanes
    beside its live rows, and every launch of their cold and warm runs
    is kept and held against the plain version. Every run's warm hash
    kernel launches (one per hash-grouped page, the slabs' tasks
    launching at once) are kept and replayed exactly. Returns the warm
    runs' launches, the recorded (calls, labels) and the hash replays'
    timed calls."""
    import torch

    from trino_tpu_torch.ops import kernels
    from trino_tpu_torch.parallel import DistributedQueryRunner
    from trino_tpu_torch.parallel.device_exchange import DeviceExchange
    from trino_tpu_torch.resources.tpch_queries import TPCH_QUERIES
    from trino_tpu_torch.sql.analyzer import Session

    connectors = {name: conn for name, conn in
                  runner.metadata.connectors.items() if name != "system"}
    launches, recorded, warm_walls, hash_replayed = {}, {}, {}, {}
    for name, qid, props, slabs in DISTRIBUTED_RUNS:
        session = Session(catalog="memory", schema="default")
        session.properties.update(props)
        dist = DistributedQueryRunner(connectors, session,
                                      n_workers=DISTRIBUTED_WORKERS,
                                      desired_splits=8, device="cuda",
                                      devices=["cuda:0"] * slabs)
        sql = TPCH_QUERIES[qid]
        calls, labels = [], []
        kept = {}
        t0 = time.perf_counter()
        if slabs > 1 and name not in DISTRIBUTED_RECORDED:
            kernels.record_calls(True)
        with _recorded(calls, labels) if name in DISTRIBUTED_RECORDED \
                else contextlib.nullcontext():
            cold = dist.execute(sql)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        if slabs > 1 and name not in DISTRIBUTED_RECORDED:
            kept["cold"] = kernels.record_calls(False)
        _assert_same(cold, _load_expected(qid), f"distributed {name} cold")
        kernels.launch_counts(reset=True)
        exchanges0 = DeviceExchange.total_collectives
        if slabs > 1:
            kernels.record_calls(True)
        kernels.record_calls(True, "hash_insert")
        t0 = time.perf_counter()
        res = dist.execute(sql)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        hash_calls = kernels.record_calls(False, "hash_insert")
        launches[name] = kernels.segment_reduce.launches
        hash_made = _hash_launched(f"distributed_{name}", res)
        if hash_made == 0 or len(hash_calls) != hash_made:
            raise AssertionError(
                f"distributed {name}: {len(hash_calls)} hash_insert calls "
                f"kept for {hash_made} launches (want some)")
        if slabs > 1:
            kept["warm"] = kernels.record_calls(False)
            if len(kept["warm"]) != launches[name]:
                raise AssertionError(
                    f"distributed {name}: {len(kept['warm'])} calls kept "
                    f"for {launches[name]} launches")
        warm_walls[name] = warm_s
        exchanges = DeviceExchange.total_collectives - exchanges0
        _assert_same(res, _load_expected(qid), f"distributed {name}")
        calls_made = _kernel_calls(res)
        device_boundaries = sum(
            1 for ex in res.stats["exchanges"].values()
            if ex and ex.get("kind") == "device")
        if launches[name] == 0 or launches[name] != calls_made:
            raise AssertionError(
                f"distributed {name}: segment_reduce launched "
                f"{launches[name]} times for {calls_made} aggregated and "
                "merged pages (want one per page, and some)")
        if name in DISTRIBUTED_RECORDED and len(calls) != _kernel_calls(cold):
            raise AssertionError(
                f"distributed {name}: the cold run recorded {len(calls)} "
                f"calls for {_kernel_calls(cold)} pages")
        want_exchanges = 0 if props.get("device_exchange") is False \
            else device_boundaries
        if exchanges != want_exchanges or (
                "device_exchange" not in props and exchanges == 0):
            raise AssertionError(
                f"distributed {name}: {exchanges} device exchanges ran "
                f"for {device_boundaries} device boundaries")
        if name in DISTRIBUTED_RECORDED:
            recorded[name] = (calls, labels)
        steps = {}
        for label in labels:
            steps[label] = steps.get(label, 0) + 1
        replay = {run: {"calls": len(c), "max_abs_err": _check_kept(
            c, f"distributed {name} {run}")} for run, c in kept.items()}
        kept.clear()
        hash_replayed[name] = hash_replay_phase(f"distributed_{name}_hash",
                                                hash_calls)
        del hash_calls
        emit({"phase": "distributed_sf1", "query": name,
              "workers": DISTRIBUTED_WORKERS, "properties": props,
              "device_slabs": slabs,
              "rows_out": len(res.rows), "matches_oracle": True,
              "cold_s": round(cold_s, 3), "warm_s": round(warm_s, 4),
              "one_slab_warm_s": round(warm_walls[name[:-3]], 4)
              if slabs > 1 else None,
              "local_memory_warm_s": memory_warm.get(qid),
              "consumer_pages": _consumer_pages(res),
              "kept_calls_replayed": replay or None,
              "device_busy_share": _busy_share(lambda: dist.execute(sql)),
              "launches": {"segment_reduce": launches[name],
                           "hash_insert": hash_made},
              "cold_calls_by_step": steps or None,
              "device_exchanges": exchanges,
              "exchanges": _exchange_summary(res),
              "streaming_overlap": res.stats.get("streaming_overlap"),
              "hbo": _hbo_note(res),
              "peak_bytes": res.stats["memory"]["peak_bytes"],
              "card": card["nvidia_smi"]})
    return launches, recorded, hash_replayed


def _np_partition_ids(keys, n: int):
    """The exchange's partition id of BIGINT keys, in numpy uint64 (the
    oracle of ``parallel/exchange.hash_partition_ids`` for one key
    column)."""
    import numpy as np

    k = keys.astype(np.int64).view(np.uint64)
    with np.errstate(over="ignore"):
        z = (k + np.uint64(0x9E3779B97F4A7C15)) * np.uint64(0xBF58476D1CE4E5B9)
        z = z ^ (z >> np.uint64(27))
        z = z ^ (z >> np.uint64(33))
    return (z % np.uint64(n)).astype(np.int64)


#: the mesh exchange's configurations: (partitions, device slabs)
MESH_EXCHANGES = ((4, 4), (8, 2))
#: the share of lineitem rows whose key is replaced by one hot key
MESH_HOT_SHARE = 0.6


def mesh_exchange_phase(card):
    """``DeviceExchange`` over d device slabs of the one card: 4
    partitions on ``["cuda:0"] * 4`` and 8 on ``["cuda:0"] * 2``, fed
    SF1's lineitem (l_orderkey, l_quantity) from the generator in one
    producer page per partition, with MESH_HOT_SHARE of the keys set to
    one key so its partition is hot and splits over every slab. Each
    partition's received rows must equal a numpy oracle (the partition
    hash in uint64, the rows sorted); prints the stats (``per_dest``,
    ``lane_rows``, ``hot_spread``, retries, bytes) and the exchange's
    wall, cold (count pass) and warm (sized from history)."""
    import numpy as np
    import torch

    from trino_tpu_torch import types as T
    from trino_tpu_torch.benchmarks import scan_q18_pages
    from trino_tpu_torch.block import Block, DevicePage, Page
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.parallel import device_exchange as de

    t0 = time.perf_counter()
    host = Page.concat(scan_q18_pages(TpchConnector(page_rows=1 << 16),
                                      "sf1", 8))
    gen_s = time.perf_counter() - t0
    keys = np.asarray(host.blocks[0].data, dtype=np.int64).copy()
    vals = np.asarray(host.blocks[1].data, dtype=np.int64)
    rng = np.random.default_rng(11)
    keys[rng.random(keys.shape[0]) < MESH_HOT_SHARE] = int(keys[0])
    for n, slabs in MESH_EXCHANGES:
        devices = ["cuda:0"] * slabs
        chunks = np.array_split(np.arange(keys.shape[0]), n)
        pages = [DevicePage.from_page(Page(
            [Block(T.BIGINT, keys[c]), Block(T.BIGINT, vals[c])],
            c.shape[0]), devices[t % slabs]) for t, c in enumerate(chunks)]
        part = _np_partition_ids(keys, n)
        order = np.lexsort((vals, keys, part))
        bounds = np.searchsorted(part[order], np.arange(n + 1))
        de.SIZING_HISTORY.reset()
        walls = []
        for run in ("cold", "warm"):
            ex = de.DeviceExchange(n, devices, sizing="history")
            ex.configure([T.BIGINT, T.BIGINT], [0])
            for t, page in enumerate(pages):
                ex.add_page(t, page)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ex.set_no_more_pages()
            got = [ex.pages(p) for p in range(n)]
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            for p in range(n):
                k = np.concatenate([pg.cols[0][pg.valid].cpu().numpy()
                                    for pg in got[p]])
                v = np.concatenate([pg.cols[1][pg.valid].cpu().numpy()
                                    for pg in got[p]])
                o = np.lexsort((v, k))
                want = order[bounds[p]:bounds[p + 1]]
                if not (np.array_equal(k[o], keys[want])
                        and np.array_equal(v[o], vals[want])):
                    raise AssertionError(
                        f"mesh exchange n={n} d={slabs} {run}: partition "
                        f"{p} holds {k.shape[0]} rows, oracle "
                        f"{want.shape[0]}")
            st = ex.stats
            if st["splits"] != 1 or list(st["hot_spread"].values()) != \
                    [slabs]:
                raise AssertionError(f"mesh exchange n={n} d={slabs}: the "
                                     f"hot partition did not split: {st}")
            emit({"phase": "mesh_exchange", "partitions": n,
                  "device_slabs": slabs, "run": run,
                  "rows": int(keys.shape[0]), "matches_oracle": True,
                  "wall_s": round(walls[-1], 4),
                  **{k_: st[k_] for k_ in (
                      "sizing_used", "per_dest", "observed_max_pair_rows",
                      "a2a_retries", "count_collectives",
                      "data_collectives", "partition_rows", "lane_rows",
                      "hot_partitions", "hot_spread", "bytes_moved")},
                  "generate_s": round(gen_s, 3),
                  "card": card["nvidia_smi"]})
            del ex, got
    de.SIZING_HISTORY.reset()


MESH_SLABS = ["cuda:0"] * 4


def _mesh_rows(rows):
    """Mesh q1's rows as a result for ``_assert_same``: sorted by the
    grouping keys, typed as q1's output."""
    from types import SimpleNamespace

    from trino_tpu_torch.benchmarks import q1_expressions, Q1_COLUMNS
    from trino_tpu_torch.connectors.tpch import TpchConnector

    md = TpchConnector().metadata()
    cols = {c.name: c for c in md.get_columns(
        md.get_table_handle("sf1", "lineitem"))}
    types = [cols[c].type for c in Q1_COLUMNS]
    projections, _filt, aggs = q1_expressions(types)
    out_types = [p.type for p in projections[:2]] + \
        [a.output_type for a in aggs]
    return SimpleNamespace(rows=sorted(rows, key=lambda r: (r[0], r[1])),
                           types=out_types)


def mesh_q1_sf1_phase(card):
    """q1 at SF1 as the mesh program over four slabs of the card
    (``run_q1_mesh(["cuda:0"] * 4, "sf1", agg_strategy=...)``) for the
    ``exchange``, ``global_hash`` and ``auto`` strategies, each cold and
    warm, and once with ``per_dest=1`` (the doubling backstop): rows
    against tests/sf1_expected.py's q1, retries, the strategy the run
    took, the kernel's launches (one per slab for the partial step, one
    more per slab for the exchange's merge-final), every launch kept and
    held against the plain version, and each wall beside the host
    generation of the same scan (which every run repeats). Returns the
    warm runs' launches and the exchange strategy's cold calls."""
    import torch

    from trino_tpu_torch.benchmarks import scan_q1_pages
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.ops import kernels
    from trino_tpu_torch.parallel.mesh_query import run_q1_mesh

    t0 = time.perf_counter()
    scan_q1_pages(TpchConnector(page_rows=1 << 14), "sf1", len(MESH_SLABS))
    gen_s = time.perf_counter() - t0
    expected = _load_expected(1)
    launches, timed = {}, None
    runs = [(s, {"agg_strategy": s}, run) for s in
            ("exchange", "global_hash", "auto") for run in ("cold", "warm")]
    runs.append(("backstop", {"agg_strategy": "exchange", "per_dest": 1},
                 "cold"))
    for name, kwargs, run in runs:
        stats = {}
        kernels.launch_counts(reset=True)
        kernels.record_calls(True)
        t0 = time.perf_counter()
        rows, retries, _conn, _pages = run_q1_mesh(
            MESH_SLABS, "sf1", stats_out=stats, **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls = kernels.record_calls(False)
        made = kernels.segment_reduce.launches
        _assert_same(_mesh_rows(rows), expected, f"mesh q1 {name} {run}")
        strategy = stats["agg_strategy"]
        # the partial step once per slab; the exchange's merge-final
        # once per slab per attempt (the backstop re-runs only it)
        want = len(MESH_SLABS) * (
            2 + retries if strategy == "exchange" else 1)
        if made != want or len(calls) != made:
            raise AssertionError(
                f"mesh q1 {name} {run}: {made} launches, {len(calls)} "
                f"kept, want {want}")
        if (name == "backstop") != (retries > 0):
            raise AssertionError(f"mesh q1 {name}: {retries} retries")
        if name == "auto" and strategy != "global-hash":
            raise AssertionError(f"mesh q1 auto took {strategy}")
        err = _check_kept(calls, f"mesh q1 {name} {run}")
        if name == "exchange" and run == "cold":
            timed = calls
        del calls
        if run == "warm":
            launches[f"mesh_q1_{name}"] = made
            _hash_launched(f"mesh_q1_{name}")
        emit({"phase": "mesh_q1_sf1", "strategy": name, "run": run,
              "device_slabs": len(MESH_SLABS), "rows_out": len(rows),
              "matches_oracle": True, "agg_strategy": strategy,
              "a2a_retries": retries, "wall_s": round(wall, 4),
              "generate_s": round(gen_s, 3),
              "launches": {"segment_reduce": made},
              "kept_calls_max_abs_err": err,
              "stats": {k: stats[k] for k in (
                  "per_dest", "table_slots", "partition_rows",
                  "data_collectives", "strategy_detail") if k in stats},
              "card": card["nvidia_smi"]})
    return launches, timed


def device_step_sf1_phase(card):
    """``q1_device_step`` over one SF1 lineitem page of 262,144 rows (the
    first pages of the generator's scan, coalesced as q1's scan does):
    its groups against the sort-based ``group_reduce`` of the same
    filtered page, run on the CPU through the plain version (keys and
    the 15 states exactly), its one kernel launch kept and held against
    the plain version. Returns the kept call."""
    import numpy as np
    import torch

    from trino_tpu_torch.benchmarks import (q1_device_step, q1_expressions,
                                            scan_table_pages, Q1_COLUMNS)
    from trino_tpu_torch.block import DevicePage, Page
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.ops import kernels
    from trino_tpu_torch.ops.aggregation import (_init_states, _state_plan,
                                                 group_reduce)
    from trino_tpu_torch.ops.sortkeys import group_operands

    pages, rows = [], 0
    for p in scan_table_pages(TpchConnector(page_rows=1 << 16), "sf1",
                              "lineitem", Q1_COLUMNS, 8):
        if rows + p.num_rows > PAGE_ROWS:
            break
        pages.append(p)
        rows += p.num_rows
    dp = DevicePage.from_page(Page.concat(pages), device="cuda")
    proc, step = q1_device_step(dp.types)
    luts = proc._fill_luts(dp.dictionaries, dp.device)
    args = (tuple(dp.cols), tuple(dp.nulls), dp.valid, luts)
    step(*args)                                   # warm
    kernels.launch_counts(reset=True)
    kernels.record_calls(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    keys, _kn, reduced, out_valid = step(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    calls = kernels.record_calls(False)
    made = kernels.segment_reduce.launches
    if made != 1 or len(calls) != 1 or _hash_launched("device_step") != 1:
        raise AssertionError(f"q1_device_step: {made} launches, "
                             f"{len(calls)} kept, "
                             f"{HASH_LAUNCHES['device_step']} hash "
                             "launches, want 1 each")
    err = _check_kept(calls, "q1_device_step")
    # the oracle: the sort path's plain version on the CPU
    _proj, _filt, aggs = q1_expressions(dp.types)
    pcols, pnulls, pvalid = proc._run(*args)
    pcols = [c.cpu() for c in pcols]
    pnulls = [x.cpu() for x in pnulls]
    pvalid = pvalid.cpu()
    key_ops = []
    for c in (0, 1):
        key_ops.extend(group_operands(pcols[c], pnulls[c],
                                      proc.output_types[c]))
    states = []
    for a in aggs:
        states.extend(_init_states(a, pcols, pnulls, pvalid,
                                   [None] * len(pcols), {}))
    kinds = [k for a in aggs for (k, _) in _state_plan(a)]
    skeys, _sk, sred, svalid = group_reduce(key_ops, [pcols[0], pcols[1]],
                                            states, pvalid, kinds)

    def groups(k, r, v):
        live = np.nonzero(v.cpu().numpy())[0]
        cols = [x.cpu().numpy()[live] for x in list(k) + list(r)]
        return sorted(zip(*[c.tolist() for c in cols]))

    got, want = groups(keys, reduced, out_valid), groups(skeys, sred, svalid)
    if got != want:
        raise AssertionError(f"q1_device_step: {got} != {want}")
    emit({"phase": "device_step_sf1", "page_rows": rows,
          "lanes": int(dp.valid.shape[0]), "groups": len(got),
          "matches_sort_path": True, "launches": {"segment_reduce": made},
          "kept_calls_max_abs_err": err, "step_wall_s": round(wall, 5),
          "card": card["nvidia_smi"]})
    return calls


#: the multi-process cluster: a coordinator and this many worker
#: processes on the one card, each with its own CUDA context
PROCESS_WORKERS = 2
PROCESS_QUERIES = (1, 3, 18)


def _await_replacement(runner, events, pids, timeout: float = 90.0):
    """Wait, without healing, until the runtime has replaced a worker of
    ``pids`` (a ``WorkerReplacedEvent`` in ``events``) and every slot
    answers the heartbeat; returns the replacement events."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        replaced = [e for e in events if e.old_pid in pids]
        if replaced and all(runner.heartbeat()):
            return replaced
        time.sleep(0.5)
    raise AssertionError(f"no worker of {pids} was replaced within "
                         f"{timeout}s: {runner.heartbeat()}")


def _load_calls(paths):
    """The kernel calls that worker processes wrote (``record_kernel_
    calls``), on this process's card, in the order of ``paths``; each
    file is removed once read."""
    import torch

    calls = []
    for path in paths:
        calls.extend(torch.load(path, map_location="cuda",
                                weights_only=True))
        os.remove(path)
    return calls


def process_sf1_phase(card, tpch_warm, dump_dir):
    """The multi-process cluster on the card:
    ``ProcessQueryRunner(n_workers=2, desired_splits=8)`` over the
    generator-fed ``tpch.sf1``, every process on CUDA, each worker's node
    pool a third of the card. First the in-process distributed runner
    over the same generator and task count, q1, q3 and q18 each cold
    (its kernel calls recorded and replayed against the plain version)
    then warm (its launches counted), against the oracle. Then the
    cluster: q1, q3 and q18 cold and warm against the oracle, each warm
    wall beside the local runner's generator-fed warm wall
    (``tpch_warm``) and the in-process one, the warm run's kernel
    launches per process (every counter set to 0 just before, read just
    after; q1's in each worker above 0) and the inputs of each of those
    launches, kept by each process and written under ``dump_dir``, then
    replayed here against the plain version; q1 under
    ``query_profiling_enabled`` with the profiler's
    ``segment_reduce_pallas`` calls and device memory per process (each
    worker's calls above 0); then q1 under ``retry_policy=TASK`` with a
    ``kill-worker`` fault on its first leaf task: the oracle's rows, one
    task retry inside attempt 0, and the dead worker replaced by the
    runtime's heartbeat monitor (the script calls no heal). The runner
    closes in a ``finally``, so no worker outlives the script. The
    cluster's warm runs also count and keep every hash kernel launch per
    process, replayed here exactly. Returns the warm runs' launches
    (summed over the processes), the replays' timed calls, and the same
    two for the hash kernel."""
    import torch

    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.events import EventListener
    from trino_tpu_torch.ops import kernels
    from trino_tpu_torch.parallel import (DistributedQueryRunner,
                                          ProcessQueryRunner)
    from trino_tpu_torch.parallel.fault import FaultSchedule
    from trino_tpu_torch.resources.tpch_queries import TPCH_QUERIES
    from trino_tpu_torch.sql.analyzer import Session

    launches, replayed, hash_launches, hash_replayed = {}, {}, {}, {}
    # the same plan shape in one process: the in-process distributed
    # runner over the generator, as many tasks per stage
    threads = DistributedQueryRunner(
        {"tpch": TpchConnector(page_rows=1 << 16)},
        Session(catalog="tpch", schema="sf1"), n_workers=PROCESS_WORKERS,
        desired_splits=8, device="cuda")
    threads_warm = {}
    for qid in PROCESS_QUERIES:
        sql, name = TPCH_QUERIES[qid], f"process_threads_q{qid}"
        calls = []
        with _recorded(calls):
            cold = threads.execute(sql)
        torch.cuda.synchronize()
        _assert_same(cold, _load_expected(qid), f"in-process q{qid} cold")
        if len(calls) != _kernel_calls(cold):
            raise AssertionError(
                f"in-process q{qid}: the cold run recorded {len(calls)} "
                f"calls for {_kernel_calls(cold)} pages")
        kernels.launch_counts(reset=True)
        t0 = time.perf_counter()
        res = threads.execute(sql)
        torch.cuda.synchronize()
        threads_warm[qid] = round(time.perf_counter() - t0, 4)
        launches[name] = kernels.segment_reduce.launches
        _hash_launched(name, res)
        _assert_same(res, _load_expected(qid), f"in-process q{qid}")
        if launches[name] == 0 or launches[name] != _kernel_calls(res):
            raise AssertionError(
                f"in-process q{qid}: segment_reduce launched "
                f"{launches[name]} times for {_kernel_calls(res)} "
                "aggregated and merged pages (want one per page, and some)")
        replayed[name] = columns_replay_phase(f"{name}_columns", calls,
                                              "live")
        del calls
    del threads, cold, res
    # the coordinator's cached blocks go back to the card before the
    # workers open their contexts beside it
    torch.cuda.empty_cache()
    card_bytes = torch.cuda.mem_get_info()[1]
    session = Session(catalog="tpch", schema="sf1")
    # several processes share the card and each would otherwise size
    # its pool to all of it: a third each (the coordinator, 2 workers)
    session.properties["node_max_memory_bytes"] = card_bytes // 3

    class Replacements(EventListener):
        def __init__(self):
            self.events = []

        def worker_replaced(self, event):
            self.events.append(event)

    replacements = Replacements()
    t0 = time.perf_counter()
    runner = ProcessQueryRunner(
        {"tpch": {"connector": "tpch", "page_rows": 1 << 16}}, session,
        n_workers=PROCESS_WORKERS, desired_splits=8,
        event_listeners=[replacements], device="cuda")
    spawn_s = time.perf_counter() - t0
    try:
        for qid in PROCESS_QUERIES:
            sql, name = TPCH_QUERIES[qid], f"process_q{qid}"
            t0 = time.perf_counter()
            cold = runner.execute(sql)
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
            _assert_same(cold, _load_expected(qid), f"process q{qid} cold")
            runner.kernel_launches(reset=True)
            runner.record_kernel_calls()
            runner.record_kernel_calls(kernel="hash_insert")
            t0 = time.perf_counter()
            res = runner.execute(sql)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            counts = runner.kernel_launches()
            by_process = {proc: n["segment_reduce"]
                          for proc, n in counts.items()}
            hash_by_process = {proc: n["hash_insert"]
                               for proc, n in counts.items()}
            kept = runner.record_kernel_calls(dump_dir)
            hash_dir = os.path.join(dump_dir, "hash")
            os.makedirs(hash_dir, exist_ok=True)
            hash_kept = runner.record_kernel_calls(hash_dir, "hash_insert")
            _assert_same(res, _load_expected(qid), f"process q{qid}")
            idle = [proc for proc, n in by_process.items()
                    if n == 0 and proc != "coordinator"]
            if sum(by_process.values()) == 0 or (qid == 1 and idle):
                raise AssertionError(
                    f"process q{qid}: segment_reduce launches per process "
                    f"{by_process} (want some, and in every worker for "
                    "q1)")
            if kept != by_process or hash_kept != hash_by_process or \
                    sum(hash_by_process.values()) == 0:
                raise AssertionError(
                    f"process q{qid}: calls kept per process {kept} for "
                    f"launches {by_process}; hash_insert calls kept "
                    f"{hash_kept} for launches {hash_by_process} (want "
                    "some)")
            launches[name] = sum(by_process.values())
            hash_launches[name] = sum(hash_by_process.values())
            emit({"phase": "process_sf1", "query": f"q{qid}",
                  "workers": PROCESS_WORKERS, "rows_out": len(res.rows),
                  "matches_oracle": True, "spawn_s": round(spawn_s, 3),
                  "cold_s": round(cold_s, 3), "warm_s": round(warm_s, 4),
                  "local_generator_warm_s": tpch_warm.get(qid),
                  "in_process_distributed_warm_s": threads_warm[qid],
                  "launches_by_process": by_process,
                  "hash_launches_by_process": hash_by_process,
                  "node_max_memory_bytes": card_bytes // 3,
                  "memory_peak_bytes":
                      (res.stats.get("memory") or {}).get("peak_bytes"),
                  "process_overlap": sum(
                      bool(v) for v in
                      (res.stats.get("process_overlap") or {}).values()),
                  "card": card["nvidia_smi"]})
            # every launch of the warm run, in the process that made it,
            # against the plain version on the same inputs
            calls = _load_calls([os.path.join(dump_dir, f"{proc}.pt")
                                 for proc in sorted(kept)])
            replayed[name] = columns_replay_phase(f"{name}_columns", calls,
                                                  "live")
            del calls
            calls = _load_calls([os.path.join(hash_dir, f"{proc}.pt")
                                 for proc in sorted(hash_kept)])
            hash_replayed[name] = hash_replay_phase(f"{name}_hash", calls)
            del calls
        # the profiler's view: each worker process's kernel calls
        session.properties["query_profiling_enabled"] = True
        try:
            t0 = time.perf_counter()
            res = runner.execute(TPCH_QUERIES[1])
            profiled_s = time.perf_counter() - t0
        finally:
            del session.properties["query_profiling_enabled"]
        _assert_same(res, _load_expected(1), "process q1 profiled")
        snap = runner.profile_snapshot()
        calls, entries = {}, {}
        for k in snap["kernels"]:
            if k["name"] == "segment_reduce_pallas":
                calls[k["process"]] = calls.get(k["process"], 0) + k["calls"]
                # the shapes the kernel saw after the wire, its CUDA-event
                # ms and the bytes bound of one call at that signature
                entries.setdefault(k["process"], []).append({
                    "key": k["key"], "calls": k["calls"],
                    "execute_ms": k["execute_ms"],
                    "bytes_per_call": k["bytes_accessed"],
                    "bound_ms_per_call":
                        k["bytes_accessed"] / HBM_BYTES_PER_S * 1e3})
        workers = [f"worker-{i}" for i in range(PROCESS_WORKERS)]
        if any(calls.get(w, 0) == 0 for w in workers):
            raise AssertionError(
                f"process q1 profiled: segment_reduce_pallas calls per "
                f"process {calls} (want some in every worker)")
        emit({"phase": "process_sf1", "step": "profiled_q1",
              "wall_s": round(profiled_s, 4),
              "segment_reduce_pallas_calls": calls,
              "segment_reduce_pallas_entries": entries,
              "device_memory": snap["device_memory"],
              "card": card["nvidia_smi"]})
        # retry_policy=TASK: a worker killed on q1's first leaf task
        session.properties["retry_policy"] = "TASK"
        try:
            runner.fault_schedule = FaultSchedule(seed=42)
            qid = f"q{runner._task_seq + 1}a0"
            runner.fault_schedule.add(f"{qid}.f0", "kill-worker")
            pids = [w.proc.pid for w in runner.workers]
            replaced0 = runner.recovery_total.workers_replaced
            mark = len(runner.task_launches)
            t0 = time.perf_counter()
            res = runner.execute(TPCH_QUERIES[1])
            torch.cuda.synchronize()
            chaos_s = time.perf_counter() - t0
            _assert_same(res, _load_expected(1), "process q1 kill-worker")
            recovery = res.stats["recovery"]
            t0 = time.perf_counter()
            events = _await_replacement(runner, replacements.events, pids)
            replaced_after_s = time.perf_counter() - t0
        finally:
            del session.properties["retry_policy"]
        replaced = runner.recovery_total.workers_replaced - replaced0
        new_pids = [w.proc.pid for w in runner.workers]
        attempts = runner.task_launches[mark:]
        if recovery["task_retries"] != 1 or recovery["query_retries"] \
                or recovery["retries_by_type"].get("EXTERNAL") != 1 \
                or not all(f"{qid}." in t for t in attempts) \
                or replaced < 1 or new_pids == pids \
                or runner.fault_schedule.armed():
            raise AssertionError(
                f"process q1 kill-worker: recovery {recovery}, attempts "
                f"{attempts}, workers replaced {replaced}, pids {pids} -> "
                f"{new_pids}")
        emit({"phase": "process_sf1", "step": "kill_worker_task_retry",
              "query": "q1", "matches_oracle": True,
              "wall_s": round(chaos_s, 4), "recovery": recovery,
              "workers_replaced": replaced,
              "replaced_by": sorted({e.reason for e in events}),
              "replaced_s_after_query": round(replaced_after_s, 3),
              "task_attempts": attempts,
              "pids": [pids, new_pids], "card": card["nvidia_smi"]})
    finally:
        runner.close()
    return launches, replayed, hash_launches, hash_replayed


def _step_picks(calls, labels) -> dict:
    """The replay's timed calls of a distributed run: the partial step's
    page call with the most live rows (``page``), its merge with the
    most groups (``partial_merge``), and the final step's merge with
    the most groups (``merge``, the last of equals) — or, where every
    final task received one page from the exchange and so merges
    nothing (q1), the final step's page call with the most groups."""
    def live(i):
        gid = calls[i][1]
        return int((gid < gid.shape[0]).sum())

    def groups(i):
        gid = calls[i][1]
        ok = gid < gid.shape[0]
        return int(gid[ok].max()) + 1 if bool(ok.any()) else 0

    pages = [i for i, lb in enumerate(labels) if lb == "partial_page"]
    partial = [i for i, lb in enumerate(labels) if lb == "partial_merge"]
    merges = [i for i, lb in enumerate(labels) if lb == "final_merge"] \
        or [i for i, lb in enumerate(labels) if lb == "final_page"]
    if not pages or not partial or not merges:
        raise AssertionError(f"no partial page, partial merge or final "
                             f"call among the recorded steps "
                             f"{sorted(set(labels))}")
    return {"page": max(pages, key=live),
            "partial_merge": max(partial, key=lambda i: (groups(i), i)),
            "merge": max(merges, key=lambda i: (groups(i), i))}


_OPERATOR_LINE = r"  (\w+): (\d+) rows, (\d+) pages, [0-9.]+ms.*"


def explain_analyze_phase(card, runner):
    """EXPLAIN ANALYZE of q18 over the memory tables: the plan, then the
    ``Query:`` line (whose row count must be q18's), the ``Memory:`` line
    and one stats line per operator under each ``Pipeline i:``."""
    import re

    from trino_tpu_torch.ops import kernels
    from trino_tpu_torch.resources.tpch_queries import TPCH_QUERIES

    kernels.launch_counts(reset=True)
    t0 = time.perf_counter()
    lines = [r[0] for r in runner.execute(
        "explain analyze " + TPCH_QUERIES[18]).rows]
    wall = time.perf_counter() - t0
    launches = kernels.segment_reduce.launches
    _hash_launched("explain_analyze_q18")
    blank = lines.index("")
    query = re.fullmatch(r"Query: ([0-9.]+)ms, (\d+) rows", lines[blank + 1])
    memory = re.fullmatch(r"Memory: peak \d+ bytes, \d+ spills \(\d+ "
                          r"bytes\)", lines[blank + 2])
    if not (query and memory and lines[0].startswith("- Output")):
        raise AssertionError(f"EXPLAIN ANALYZE q18: {lines}")
    want_rows = len(_load_expected(18))
    if int(query.group(2)) != want_rows:
        raise AssertionError(f"EXPLAIN ANALYZE q18: {query.group(2)} rows, "
                             f"the oracle has {want_rows}")
    pipelines, operators, pipeline, worst = 0, [], None, None
    for line in lines[blank + 3:]:
        if line.startswith("Worst misestimate: ") and worst is None:
            worst = line     # history's summary line, after the operators
            continue
        m = re.fullmatch(r"Pipeline (\d+):", line)
        if m:
            pipeline = int(m.group(1))
            if pipeline != pipelines:
                raise AssertionError(f"EXPLAIN ANALYZE q18: {line}")
            pipelines += 1
            continue
        m = re.fullmatch(_OPERATOR_LINE, line)
        if not m or pipeline is None or worst is not None:
            raise AssertionError(f"EXPLAIN ANALYZE q18: {line!r}")
        operators.append((pipeline, m.group(1), int(m.group(2))))
    heads = {p for p, name, _ in operators
             if name in ("TableScanOperator", "DeferredPagesSourceOperator")}
    sink = [r for p, name, r in operators if p == pipelines - 1]
    # the last pipeline ends in the output collector, fed q18's rows
    if heads != set(range(pipelines)) or sink[-2] != want_rows:
        raise AssertionError(f"EXPLAIN ANALYZE q18: operators {operators}")
    emit({"phase": "explain_analyze_sf1", "wall_s": round(wall, 3),
          "query_ms": float(query.group(1)), "rows": want_rows,
          "pipelines": pipelines, "operators": len(operators),
          "worst_misestimate": worst,
          "launches": {"segment_reduce": launches}, "lines": lines,
          "card": card["nvidia_smi"]})
    return launches


#: no aggregation above the join: its unspilled peak is the build's
SPILL_JOIN_SQL = ("select l_orderkey, l_linenumber, o_totalprice from "
                  "lineitem, orders where l_orderkey = o_orderkey and "
                  "l_quantity > 49")
SPILL_SORT_SQL = ("select o_orderkey, o_totalprice, o_orderdate from orders "
                  "order by o_totalprice desc, o_orderkey")


def _spill_run(runner, sql, props, calls=None, key=None):
    """One statement under the session properties ``props`` (restored
    afterwards): (result, wall seconds, segment-reduce calls). With
    ``calls``, it keeps a copy of the inputs of every kernel call."""
    import torch

    from trino_tpu_torch.ops import kernels

    saved = dict(runner.session.properties)
    runner.session.properties.update(props)
    try:
        kernels.launch_counts(reset=True)
        t0 = time.perf_counter()
        with _recorded(calls) if calls is not None \
                else contextlib.nullcontext():
            res = runner.execute(sql)
        torch.cuda.synchronize()
        if key is not None:
            _hash_launched(key, res, at_least=True)
        return res, time.perf_counter() - t0, kernels.segment_reduce.launches
    finally:
        runner.session.properties.clear()
        runner.session.properties.update(saved)


def _spill_record(res, wall, launches):
    m = res.stats["memory"]
    return {"wall_s": round(wall, 3), "peak_bytes": m["peak_bytes"],
            "max_bytes": m["max_bytes"], "spill_events": m["spill_events"],
            "spilled_bytes": m["spilled_bytes"],
            "partition_spills": m["partition_spills"],
            "disk_spill_events": m.get("disk_spill_events"),
            "disk_spilled_bytes": m.get("disk_spilled_bytes"),
            "disk_file_bytes": m.get("disk_file_bytes"),
            "launches": {"segment_reduce": launches}}


def spill_phase(card, runner, peaks):
    """The spill tiers over the memory tables, each run held against its
    oracle: (a) q18 with both tiers on, a cap of 3/4 of its unspilled
    peak from ``memory_sf1`` and no host budget, so every parked page
    goes to disk; (b) lineitem join orders under a cap of 1/8 of the
    unspilled run's peak, which the hybrid build survives by parking
    partitions; (c) an ORDER BY under half its unspilled peak with spill
    off, which only the host sort fits. No spill file may be left.
    Returns the launches per case and the inputs of every kernel call
    of (a), whose merges take reloaded partials in budget chunks."""
    from trino_tpu_torch.exec.memory import spill_root
    from trino_tpu_torch.resources.tpch_queries import TPCH_QUERIES

    launches, calls = {}, []
    # (a) the disk tier under q18
    cap = peaks[18] * 3 // 4
    res, wall, n = _spill_run(runner, TPCH_QUERIES[18], {
        "query_max_memory_bytes": cap, "spill_enabled": True,
        "spill_to_disk_enabled": True, "spill_host_memory_bytes": 0}, calls,
        "spill_q18")
    _assert_same(res, _load_expected(18), "spilled q18")
    rec = _spill_record(res, wall, n)
    if not (rec["spill_events"] > 0 and rec["disk_spill_events"] > 0
            and rec["peak_bytes"] <= cap and len(calls) == n
            and n >= _aggregated_pages(res) > 0):
        raise AssertionError(f"spilled q18: {len(calls)} calls recorded, "
                             f"{_aggregated_pages(res)} aggregated pages, "
                             f"{rec}")
    launches["spill_q18"] = n
    emit({"phase": "spill_sf1", "case": "q18_disk",
          "unspilled_peak_bytes": peaks[18], **rec,
          "card": card["nvidia_smi"]})
    # (b) the hybrid join
    free, free_wall, free_n = _spill_run(runner, SPILL_JOIN_SQL, {},
                                         key="spill_join")
    cap = free.stats["memory"]["peak_bytes"] // 8
    res, wall, n = _spill_run(runner, SPILL_JOIN_SQL, {
        "query_max_memory_bytes": cap, "spill_enabled": True},
        key="spill_join")
    rec = _spill_record(res, wall, n)
    # cold partitions join after the resident stream: compare as sets
    if sorted(res.rows) != sorted(free.rows) or not (
            rec["partition_spills"] > 0 and rec["peak_bytes"] <= cap):
        raise AssertionError(f"hybrid join: {len(res.rows)} rows vs "
                             f"{len(free.rows)}, {rec}")
    build = next(op for op in res.stats["operators"]
                 if op["name"] == "HashBuilderOperator")
    launches["spill_join"] = free_n + n
    emit({"phase": "spill_sf1", "case": "hybrid_join",
          "unspilled_peak_bytes": free.stats["memory"]["peak_bytes"],
          "unspilled_wall_s": round(free_wall, 3), "rows": len(free.rows),
          "hybrid": build.get("hybrid_spill"), **rec,
          "card": card["nvidia_smi"]})
    # (c) the host sort, spill off
    free, free_wall, _ = _spill_run(runner, SPILL_SORT_SQL, {})
    cap = free.stats["memory"]["peak_bytes"] // 2
    res, wall, n = _spill_run(runner, SPILL_SORT_SQL, {
        "query_max_memory_bytes": cap}, key="spill_sort")
    rec = _spill_record(res, wall, n)
    if res.rows != free.rows or rec["peak_bytes"] > cap \
            or rec["spill_events"]:
        raise AssertionError(f"host sort: {len(res.rows)} rows vs "
                             f"{len(free.rows)}, {rec}")
    launches["spill_sort"] = n
    emit({"phase": "spill_sf1", "case": "host_sort",
          "unspilled_peak_bytes": free.stats["memory"]["peak_bytes"],
          "unspilled_wall_s": round(free_wall, 3), "rows": len(res.rows),
          **rec, "card": card["nvidia_smi"]})
    root = os.path.join(spill_root(), str(os.getpid()))
    left = [f for d in (os.listdir(root) if os.path.isdir(root) else [])
            for f in os.listdir(os.path.join(root, d))]
    if left:
        raise AssertionError(f"spill files left behind: {left}")
    return launches, calls


#: q6's shape with its discount centre and quantity cut as the literals
#: that vary; the first member is q6 itself
SERVING_Q6_SQL = """select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1994-01-01' + interval '1' year
  and l_discount between %s - 0.01 and %s + 0.01
  and l_quantity < %s"""
SERVING_Q6_ARGS = [("0.06", 24), ("0.05", 24), ("0.04", 30), ("0.07", 20),
                   ("0.03", 25), ("0.08", 24), ("0.02", 40), ("0.06", 10)]
#: q6's shape summing a DOUBLE, with SERVING_Q6_ARGS: float-sum partials
#: stay at full capacity and each lane starts on a kernel tile edge, so
#: every member's sum must equal its serial run's bit for bit. One float
#: sum keeps the burst's full-capacity partials and merge inside the
#: default 8 GiB query budget; a second would exceed it (memory_budget)
SERVING_Q6D_SQL = """select
  sum(l_extendedprice * l_discount * 1.0e0) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1994-01-01' + interval '1' year
  and l_discount between %s - 0.01 and %s + 0.01
  and l_quantity < %s"""
#: q1 without its ORDER BY (a sort is not a batched stage) and with a
#: quantity cut as the literal that varies; its interval literal stays
#: in the statement's shape, so a delta that varies would make eight
#: shapes. The first member (every quantity is below 51) is q1's rows.
SERVING_Q1_SQL = """select
    l_returnflag, l_linestatus,
    sum(l_quantity) as sum_qty,
    sum(l_extendedprice) as sum_base_price,
    sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
    sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
    avg(l_quantity) as avg_qty,
    avg(l_extendedprice) as avg_price,
    avg(l_discount) as avg_disc,
    count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval '90' day
  and l_quantity < %d
group by l_returnflag, l_linestatus"""
SERVING_Q1_ARGS = [51, 45, 40, 35, 30, 25, 20, 15]


def _http_result(res):
    """A client result as the runner's result shape (types, rows with
    decimals as Decimal), for ``_assert_same``."""
    from decimal import Decimal

    from trino_tpu_torch import types as T
    from trino_tpu_torch.runner import QueryResult

    types_ = [T.parse_type(c["type"]) for c in res.columns]
    rows = [tuple(Decimal(v) if t.is_decimal and v is not None else v
                  for v, t in zip(row, types_)) for row in res.rows]
    return QueryResult(res.column_names, types_, rows)


def _burst(srv, sqls, user=None):
    """Submit ``sqls`` at once from one thread each while the server's
    executor threads are held, then release them: the statements wait in
    the backlog together, as a burst arriving at a busy server does.
    Returns the client results (or exceptions) in order and the wall
    from the release to the last client's last page."""
    import threading

    from trino_tpu_torch.client import Client

    gate = threading.Event()
    holds = [srv.executor.submit(gate.wait)
             for _ in range(srv.executor._max_workers)]
    out = [None] * len(sqls)

    def go(i):
        try:
            out[i] = Client(srv.uri, user=user).execute(sqls[i])
        except Exception as e:  # reported per statement
            out[i] = e

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(sqls))]
    for t in threads:
        t.start()
    deadline = time.time() + 60
    while len(srv._backlog) < len(sqls):
        if time.time() > deadline:
            raise AssertionError("the burst never reached the backlog")
        time.sleep(0.005)
    t0 = time.perf_counter()
    gate.set()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    for h in holds:
        h.result()
    return out, wall


def _admission_batches(srv) -> dict:
    from trino_tpu_torch.telemetry.metrics import parse_prometheus

    return parse_prometheus(srv.metrics_text()).get(
        "trino_http_admission_batches_total", {})


def _serving_burst(card, srv, runner, name, sqls, oracle_qid, calls,
                   hash_calls):
    """One burst of eight same-shape statements over HTTP: one admission
    batch of 8 on a plan template, the aggregation through the folded
    kernel calls (recorded in ``calls``), every member equal to the
    engine's serial run of its text and, with ``oracle_qid``, the first
    member to that query's oracle rows; at most as many kernel calls as
    one serial run. The hash kernel's launches are kept in
    ``hash_calls``: one per folded hash-grouped page, so as many as the
    segment-reduce calls when the serial run groups every page on the
    hash path, else no more than the serial run's. Then the same burst
    again, recording nothing: the same rows and calls. Returns the
    launches of both."""
    import torch

    from trino_tpu_torch.ops import kernels

    before = _admission_batches(srv)
    disp0 = dict(runner.query_cache.templates.dispositions)
    launched0 = runner.query_cache.batched_launches
    torch.cuda.synchronize()
    kernels.launch_counts(reset=True)
    kernels.record_calls(True, "hash_insert")
    with _recorded(calls):
        out, wall = _burst(srv, sqls)
    torch.cuda.synchronize()
    hash_calls.extend(kernels.record_calls(False, "hash_insert"))
    burst_launches = kernels.segment_reduce.launches
    burst_hash = _hash_launched(f"serving_{name}_burst")
    bad = [o for o in out if isinstance(o, Exception)]
    if bad:
        raise AssertionError(f"{name} burst: {bad[0]!r}")
    after = _admission_batches(srv)
    grew = {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}
    if grew != {'{size="8"}': 1.0}:
        raise AssertionError(f"{name} burst: admission batches {grew}, "
                             "want one batch of 8")
    disp = {k: v - disp0.get(k, 0) for k, v in
            runner.query_cache.templates.dispositions.items()}
    if disp.get("agg_stage_vmapped") != 1 or \
            runner.query_cache.batched_launches - launched0 != 8:
        raise AssertionError(f"{name} burst: dispositions {disp}, "
                             "want one agg_stage_vmapped batch of 8")
    # the serial oracle: each text alone, batching off (still through the
    # template), launches of the first member counted
    runner.session.properties["batched_execution_enabled"] = False
    serial_walls, serial_launches = [], None
    serial_hash, serial_all_hash = None, False
    try:
        for i, sql in enumerate(sqls):
            kernels.launch_counts(reset=True)
            t0 = time.perf_counter()
            want = runner.execute(sql)
            torch.cuda.synchronize()
            serial_walls.append(round(time.perf_counter() - t0, 4))
            if serial_launches is None:
                serial_launches = kernels.segment_reduce.launches
                serial_hash = kernels.hash_insert.launches
                serial_all_hash = _hash_pages(want) == \
                    _aggregated_pages(want)
            if want.stats.get("plan_template") != "hit":
                raise AssertionError(f"{name} serial {i}: not templated")
            got = _http_result(out[i]).rows
            if sorted(got) != sorted(want.rows):
                raise AssertionError(f"{name} member {i}: batched rows "
                                     "differ from the serial run")
    finally:
        runner.session.properties.pop("batched_execution_enabled")
    if oracle_qid is not None:
        first = _http_result(out[0])
        first.rows.sort(key=lambda r: tuple(str(v) for v in r))
        _assert_same(first, _load_expected(oracle_qid), f"{name} member 0")
    if burst_launches != len(calls) or burst_launches > serial_launches:
        raise AssertionError(
            f"{name} burst: {burst_launches} kernel calls ({len(calls)} "
            f"recorded), one serial run makes {serial_launches}")
    if burst_hash != len(hash_calls) or burst_hash > serial_hash or (
            serial_all_hash and burst_hash != burst_launches) or (
            serial_hash and not burst_hash):
        raise AssertionError(
            f"{name} burst: {burst_hash} hash_insert launches "
            f"({len(hash_calls)} kept) for {burst_launches} folded pages; "
            f"one serial run makes {serial_hash}")
    # the same burst again, recording nothing: the first burst's wall
    # holds the copies of its recorded inputs and is the shape's first
    # burst in the process
    torch.cuda.synchronize()
    kernels.launch_counts(reset=True)
    again, repeat_wall = _burst(srv, sqls)
    torch.cuda.synchronize()
    repeat_launches = kernels.segment_reduce.launches
    if any(isinstance(o, Exception) for o in again) or \
            [sorted(map(str, _http_result(o).rows)) for o in again] != \
            [sorted(map(str, _http_result(o).rows)) for o in out] or \
            repeat_launches != burst_launches or \
            _hash_launched(f"serving_{name}_burst_repeat") != burst_hash:
        raise AssertionError(f"{name} burst repeat: {again}, "
                             f"{repeat_launches} kernel calls")
    emit({"phase": "serving_sf1", "step": f"{name}_burst",
          "members": len(sqls), "admission_batches": grew,
          "dispositions": disp, "burst_wall_s": round(wall, 4),
          "repeat_burst_wall_s": round(repeat_wall, 4),
          "serial_walls_s": serial_walls,
          "serial_wall_sum_s": round(sum(serial_walls), 4),
          "launches": {"segment_reduce": burst_launches,
                       "hash_insert": burst_hash},
          "serial_launches": {"segment_reduce": serial_launches,
                              "hash_insert": serial_hash},
          "segments_per_call": sorted({c[2] for c in calls}),
          "rows_per_call": sorted({c[1].shape[0] for c in calls}),
          "matches_serial": True,
          "member0_matches_oracle": oracle_qid is not None,
          "card": card["nvidia_smi"]})
    return {f"{name}_burst": burst_launches,
            f"{name}_burst_repeat": repeat_launches}


def serving_phase(card, runner):
    """The statement server over the memory runner: ProtocolServer on
    127.0.0.1 (port 0) driven through the engine's Client. Single q1,
    q3, q6 and q18 against the oracle; q1 again from a cached plan (the
    plan cache's or its shape's template) and from the result cache (no
    kernel launch); a q6-shape and a q1-shape burst of eight; a denied
    user and a failing member of a burst; /v1/query/{id}, /v1/metrics
    and system.runtime.queries. Returns the
    launches per step, the recorded folded calls per burst and the
    bursts' kept hash kernel calls."""
    import json
    import urllib.request

    import torch

    from trino_tpu_torch.client import Client
    from trino_tpu_torch.ops import kernels
    from trino_tpu_torch.resources.tpch_queries import TPCH_QUERIES
    from trino_tpu_torch.security import (ALLOW_ALL,
                                          RuleBasedAccessControl,
                                          TableRule)
    from trino_tpu_torch.server.protocol import ProtocolServer
    from trino_tpu_torch.types import TrinoError

    served = {}
    execute_batch = runner.execute_batch

    def observed(sqls, user=None):
        out = execute_batch(sqls, user=user)
        for sql, res in zip(sqls, out):
            if not isinstance(res, Exception):
                served[sql] = res.stats or {}
        return out

    # the server's path (it drains statements through execute_batch):
    # keeps each result's stats (plan/result cache hits); observation only
    runner.execute_batch = observed
    srv = ProtocolServer(runner, host="127.0.0.1", port=0).start()
    client = Client(srv.uri)
    launches, calls = {}, {"q6": [], "q1": [], "q6d": []}
    hash_calls = {"q6": [], "q1": [], "q6d": []}
    qids = {}
    try:
        for qid in MEMORY_QUERIES:
            sql = TPCH_QUERIES[qid]
            torch.cuda.synchronize()
            kernels.launch_counts(reset=True)
            t0 = time.perf_counter()
            res = client.execute(sql)
            wall = time.perf_counter() - t0
            launches[f"http_q{qid}"] = kernels.segment_reduce.launches
            _hash_launched(f"serving_http_q{qid}")
            _assert_same(_http_result(res), _load_expected(qid),
                         f"http q{qid}")
            emit({"phase": "serving_sf1", "step": "single",
                  "query": f"q{qid}", "wall_s": round(wall, 4),
                  "rows_out": len(res.rows), "matches_oracle": True,
                  "launches": {"segment_reduce":
                               launches[f"http_q{qid}"]},
                  "card": card["nvidia_smi"]})
        q1 = TPCH_QUERIES[1]
        rows1 = client.execute(q1).rows
        # a repeat runs a cached plan: the plan cache's, or — once a
        # first run's material misestimate dropped that plan and history
        # earned the shape a template — the template's
        repeat = {k: served[q1].get(k)
                  for k in ("plan_cache", "plan_template")}
        if "hit" not in repeat.values():
            raise AssertionError(f"q1 repeat: {served[q1]}, want a plan "
                                 "cache or plan template hit")
        client.execute("set session result_cache_enabled = true")
        client.execute(q1)                    # new keyspace: stores
        torch.cuda.synchronize()
        kernels.launch_counts(reset=True)
        t0 = time.perf_counter()
        again = client.execute(q1)
        wall = time.perf_counter() - t0
        hit_launches = kernels.segment_reduce.launches \
            + kernels.hash_insert.launches
        client.execute("set session result_cache_enabled = false")
        if served[q1].get("result_cache") != "hit" or hit_launches or \
                again.rows != rows1:
            raise AssertionError(f"q1 result cache: {served[q1]}, "
                                 f"{hit_launches} launches")
        emit({"phase": "serving_sf1", "step": "repeat",
              **repeat, "result_cache": "hit",
              "result_cache_wall_s": round(wall, 4),
              "result_cache_launches": hit_launches,
              "card": card["nvidia_smi"]})
        launches.update(_serving_burst(
            card, srv, runner, "q6",
            [SERVING_Q6_SQL % (c, c, q) for c, q in SERVING_Q6_ARGS], 6,
            calls["q6"], hash_calls["q6"]))
        launches.update(_serving_burst(
            card, srv, runner, "q1",
            [SERVING_Q1_SQL % k for k in SERVING_Q1_ARGS], 1, calls["q1"],
            hash_calls["q1"]))
        launches.update(_serving_burst(
            card, srv, runner, "q6d",
            [SERVING_Q6D_SQL % (c, c, q) for c, q in SERVING_Q6_ARGS], None,
            calls["q6d"], hash_calls["q6d"]))
        # errors: a denied user, and a member of a burst whose literal
        # has another type (it leaves the batch and fails alone)
        runner.access_control = RuleBasedAccessControl([
            TableRule(user="mallory", privileges=[]),
            TableRule(privileges=["SELECT", "INSERT", "DELETE",
                                  "OWNERSHIP"])])
        try:
            Client(srv.uri, user="mallory").execute(TPCH_QUERIES[6])
            denied = None
        except TrinoError as e:
            denied = e.code
        finally:
            runner.access_control = ALLOW_ALL
        args = [("0.06", "24"), ("0.05", "24"), ("0.06", "'abc'"),
                ("0.04", "30")]
        sqls = [SERVING_Q6_SQL % (c, c, q) for c, q in args]
        out, _ = _burst(srv, sqls)
        codes = [getattr(o, "code", None) for o in out]
        runner.session.properties["batched_execution_enabled"] = False
        try:
            for i in (0, 1, 3):
                if _http_result(out[i]).rows != runner.execute(
                        sqls[i]).rows:
                    raise AssertionError(f"error burst member {i} differs "
                                         "from its serial run")
        finally:
            runner.session.properties.pop("batched_execution_enabled")
        if denied != "PERMISSION_DENIED" or \
                codes != [None, None, "ANALYSIS_ERROR", None]:
            raise AssertionError(f"errors: denied {denied}, burst {codes}")
        emit({"phase": "serving_sf1", "step": "errors",
              "denied_user": denied, "burst_codes": codes,
              "others_match_serial": True, "card": card["nvidia_smi"]})
        # endpoints: the stats tree of a finished statement, the metrics
        # text, and the statements above in system.runtime.queries
        doc = json.loads(urllib.request.urlopen(urllib.request.Request(
            srv.uri + "/v1/statement", data=TPCH_QUERIES[6].encode(),
            method="POST")).read())
        nxt = doc["nextUri"]
        while nxt:
            nxt = json.loads(urllib.request.urlopen(nxt).read()) \
                .get("nextUri")
        info = json.loads(urllib.request.urlopen(
            f"{srv.uri}/v1/query/{doc['id']}").read())
        text = urllib.request.urlopen(srv.uri + "/v1/metrics").read() \
            .decode()
        families = [f for f in ("trino_http_statements_total",
                                "trino_http_admission_batches_total",
                                "trino_plan_cache_total",
                                "trino_result_cache_total",
                                "trino_plan_template_total",
                                "trino_admission_batches_total",
                                "trino_queries_total")
                    if f"# TYPE {f} " in text]
        listed = client.execute(
            "select query, state from system.runtime.queries").rows
        states = {}
        for query, state in listed:
            states.setdefault(query, set()).add(state)
        want = [TPCH_QUERIES[q] for q in MEMORY_QUERIES] + \
            [SERVING_Q6_SQL % (c, c, q) for c, q in SERVING_Q6_ARGS] + \
            [SERVING_Q1_SQL % k for k in SERVING_Q1_ARGS] + \
            [SERVING_Q6D_SQL % (c, c, q) for c, q in SERVING_Q6_ARGS]
        missing = [q for q in want if "FINISHED" not in states.get(q, ())]
        if info["state"] != "FINISHED" or info["rows"] != 1 or \
                len(families) != 7 or missing or \
                "FAILED" not in states.get(sqls[2], ()):
            raise AssertionError(
                f"endpoints: query {info['state']}/{info['rows']}, "
                f"families {families}, {len(missing)} statements missing "
                "from system.runtime.queries")
        emit({"phase": "serving_sf1", "step": "endpoints",
              "query_info": {k: info[k] for k in ("state", "rows")},
              "query_info_wall_ms": info["stats"]["wall_ms"],
              "metrics_families": families,
              "runtime_queries_rows": len(listed),
              "card": card["nvidia_smi"]})
    finally:
        srv.stop()
        del runner.execute_batch
    return launches, calls, hash_calls


#: the families a metrics scrape must carry: program first calls, the
#: program profiler's, the card's memory and the history store's
OBSERVABILITY_FAMILIES = ("trino_jit_traces_total",
                          "trino_profiler_programs_total",
                          "trino_profiler_seconds_total",
                          "trino_device_memory_bytes",
                          "trino_hbo_store_entries",
                          "trino_hbo_lookups_total",
                          "trino_hbo_records_total", "trino_hbo_qerror",
                          "trino_hbo_plan_flips")


def _profiled_kernel_calls(profiler) -> int:
    return sum(e["calls"] for e in profiler.snapshot()
               if e["name"] == "segment_reduce_pallas")


def observability_phase(card, runner):
    """History, the profiler, the runtime tables and the slow-query log
    over the memory tables, the history store emptied first. (1) q18 and
    q3 twice each: both runs equal the oracle and record history; the
    worst Q-error, the plan flips and whether the second run re-planned.
    (2) EXPLAIN ANALYZE VERBOSE of q1 and q18: the ``Kernels:`` line,
    the profiler's ``segment_reduce_pallas`` calls equal to the kernel's
    launches in the same run, its CUDA-event device time > 0 and within
    the run's wall, the programs' summed device time beside the wall, and
    a repeat run adding no program. (3) ``system.runtime.kernels`` and
    ``plan_stats`` return rows; under ``slow_query_log_threshold`` a
    query's record shows in ``system.runtime.queries.slow``; GET
    /v1/metrics carries the new families, the device memory read from
    the card. (4) q1's warm wall with profiling off and on, in turns,
    and (5) with history off and on. The runs planned from history (the
    second of q18 and of q3), the first VERBOSE run of q1 and of q18 and
    the slow q6 keep a copy of the inputs of every kernel call they
    make, one per launch. Returns the launches per run, the profiled
    kernel calls per VERBOSE run and the recorded calls per run."""
    import re
    import urllib.request

    import torch

    from trino_tpu_torch.ops import kernels
    from trino_tpu_torch.resources.tpch_queries import TPCH_QUERIES
    from trino_tpu_torch.server.protocol import ProtocolServer
    from trino_tpu_torch.telemetry import profiler, stats_store

    store = stats_store.store()
    store.clear()
    launches, profiled, recorded = {}, {}, {}

    def run(sql, key, record=False):
        torch.cuda.synchronize()
        kernels.launch_counts(reset=True)
        calls = None
        if record:
            calls = recorded[key] = []
        t0 = time.perf_counter()
        with _recorded(calls) if record else contextlib.nullcontext():
            res = runner.execute(sql)
        torch.cuda.synchronize()
        launches[key] = kernels.segment_reduce.launches
        # an EXPLAIN ANALYZE's result carries no operator stats
        _hash_launched(key, res if res.stats else None)
        if record and len(calls) != launches[key]:
            raise AssertionError(f"{key}: {len(calls)} calls recorded for "
                                 f"{launches[key]} launches")
        return res, time.perf_counter() - t0

    # (1) history
    for qid in (18, 3):
        sql = TPCH_QUERIES[qid]
        before = runner.explain(sql)
        flips0 = dict(store.plan_flips)
        runs = []
        for i in (1, 2):
            res, wall = run(sql, f"observability_q{qid}_run{i}",
                            record=i == 2)
            _assert_same(res, _load_expected(qid), f"history q{qid} run {i}")
            if not (res.stats or {}).get("hbo"):
                raise AssertionError(f"history q{qid} run {i}: no hbo "
                                     f"record in {sorted(res.stats)}")
            runs.append((res, wall))
        after = runner.explain(sql)
        flips = {k: v - flips0.get(k, 0) for k, v in store.plan_flips.items()
                 if v != flips0.get(k, 0)}
        emit({"phase": "observability_sf1", "step": "history",
              "query": f"q{qid}", "matches_oracle": True,
              "runs": [{"wall_s": round(w, 4), **_hbo_note(r)}
                       for r, w in runs],
              "inputs_recorded_run": 2,
              "second_run_replanned":
                  runs[1][0].stats.get("plan_cache") != "hit",
              "explain_changed": after != before,
              "source_hbo_in_explain": "source=hbo" in after,
              "plan_flips": flips, "store": store.counters(),
              "launches": {"segment_reduce": [
                  launches[f"observability_q{qid}_run{i}"]
                  for i in (1, 2)]},
              "card": card["nvidia_smi"]})
    # (2) the profiler under EXPLAIN ANALYZE VERBOSE
    for qid in (1, 18):
        sql = "explain analyze verbose " + TPCH_QUERIES[qid]
        lines_by_run = []
        for i in (1, 2):
            calls0 = _profiled_kernel_calls(profiler)
            ms0 = sum(e["execute_ms"] for e in profiler.snapshot()
                      if e["name"] == "segment_reduce_pallas")
            outer0 = profiler.totals()["outer_execute_ms"]
            res, wall = run(sql, f"observability_verbose_q{qid}_run{i}",
                            record=i == 1)
            lines = [r[0] for r in res.rows]
            calls = _profiled_kernel_calls(profiler) - calls0
            kernel_ms = sum(e["execute_ms"] for e in profiler.snapshot()
                            if e["name"] == "segment_reduce_pallas") - ms0
            outer_ms = profiler.totals()["outer_execute_ms"] - outer0
            query = re.fullmatch(r"Query: ([0-9.]+)ms, (\d+) rows",
                                 lines[lines.index("") + 1])
            kernels_line = lines[-1]
            n = launches[f"observability_verbose_q{qid}_run{i}"]
            profiled[f"verbose_q{qid}_run{i}"] = calls
            if not kernels_line.startswith("Kernels: ") or calls != n \
                    or n == 0 or not 0 < kernel_ms <= wall * 1e3 \
                    or int(query.group(2)) != len(_load_expected(qid)):
                raise AssertionError(
                    f"VERBOSE q{qid} run {i}: {kernels_line!r}, profiled "
                    f"kernel calls {calls} vs {n} launches, kernel "
                    f"{kernel_ms} ms in a {wall * 1e3:.1f} ms run")
            if i == 2 and " 0 new, 0 compiles this run" not in kernels_line:
                raise AssertionError(f"VERBOSE q{qid} repeat: "
                                     f"{kernels_line!r}")
            lines_by_run.append(lines)
            emit({"phase": "observability_sf1", "step": "verbose",
                  "query": f"q{qid}", "run": i,
                  "inputs_recorded": i == 1,
                  "wall_ms": round(wall * 1e3, 3),
                  "query_line_ms": float(query.group(1)),
                  "kernels_line": kernels_line,
                  "segment_reduce_pallas": {"calls": calls, "launches": n,
                                            "device_ms": round(kernel_ms, 4)},
                  "programs_device_ms": round(outer_ms, 4),
                  "card": card["nvidia_smi"]})
        emit({"phase": "observability_sf1", "step": "verbose_lines",
              "query": f"q{qid}", "lines": lines_by_run[0]})
    # (3) the runtime tables, the slow-query log and the metrics scrape
    kernel_rows = runner.execute("select name, calls, execute_ms from "
                                 "system.runtime.kernels").rows
    plan_rows = runner.execute("select statement, node, name, runs, rows "
                               "from system.runtime.plan_stats").rows
    runner.session.properties["slow_query_log_threshold"] = 1e-9
    try:
        run(TPCH_QUERIES[6], "observability_slow_q6", record=True)
    finally:
        runner.session.properties.pop("slow_query_log_threshold")
    slow = [r for r in runner.execute(
        "select query, slow from system.runtime.queries "
        "where slow is not null").rows if r[0] == TPCH_QUERIES[6]]
    srv = ProtocolServer(runner, host="127.0.0.1", port=0).start()
    try:
        text = urllib.request.urlopen(srv.uri + "/v1/metrics").read() \
            .decode()
    finally:
        srv.stop()
    missing = [f for f in OBSERVABILITY_FAMILIES
               if f"# TYPE {f} " not in text]
    limit = [float(line.split()[-1]) for line in text.splitlines()
             if line.startswith("trino_device_memory_bytes{kind=\"limit\"")]
    total = torch.cuda.mem_get_info()[1]
    if not kernel_rows or not plan_rows or not slow or missing or \
            limit != [float(total)] or \
            "segment_reduce_pallas" not in {r[0] for r in kernel_rows}:
        raise AssertionError(
            f"tables: {len(kernel_rows)} kernels rows, {len(plan_rows)} "
            f"plan_stats rows, {len(slow)} slow records, families missing "
            f"{missing}, device memory limit {limit} vs {total}")
    emit({"phase": "observability_sf1", "step": "tables",
          "kernels_rows": len(kernel_rows),
          "plan_stats_rows": len(plan_rows), "slow_record": slow[-1][1],
          "metrics_families": list(OBSERVABILITY_FAMILIES),
          "device_memory_limit_bytes": total,
          "card": card["nvidia_smi"]})
    # (4) the cost of profiling on q1's warm wall, off and on in turns
    walls = {"off": [], "on": []}
    for i, mode in enumerate(("off", "on", "on", "off")):
        runner.session.properties["query_profiling_enabled"] = mode == "on"
        try:
            res, wall = run(TPCH_QUERIES[1],
                            f"observability_cost_q1_{mode}{i}")
        finally:
            runner.session.properties.pop("query_profiling_enabled")
        _assert_same(res, _load_expected(1), f"profiling {mode} q1")
        walls[mode].append(round(wall, 4))
    emit({"phase": "observability_sf1", "step": "profiling_cost",
          "query": "q1", "walls_s": walls,
          "mean_off_s": round(sum(walls["off"]) / 2, 4),
          "mean_on_s": round(sum(walls["on"]) / 2, 4),
          "card": card["nvidia_smi"]})
    # (5) the cost of recording history on the same wall, off and on in
    # turns (history is on in every run above)
    walls = {"off": [], "on": []}
    for i, mode in enumerate(("off", "on", "on", "off")):
        runner.session.properties["hbo_enabled"] = mode == "on"
        try:
            res, wall = run(TPCH_QUERIES[1],
                            f"observability_hbo_q1_{mode}{i}")
        finally:
            runner.session.properties.pop("hbo_enabled")
        _assert_same(res, _load_expected(1), f"history {mode} q1")
        walls[mode].append(round(wall, 4))
    emit({"phase": "observability_sf1", "step": "history_cost",
          "query": "q1", "walls_s": walls,
          "mean_off_s": round(sum(walls["off"]) / 2, 4),
          "mean_on_s": round(sum(walls["on"]) / 2, 4),
          "card": card["nvidia_smi"]})
    return launches, profiled, recorded


def _bound_ms(cols, n: int, num_segments: int, with_order: bool):
    """(bound ms, bound_by, bytes) of one ``segment_reduce_columns`` call:
    gid (and order) read once per row, each column read once per row and
    written once per segment, against one add/compare per value."""
    bytes_ = n * (4 + (8 if with_order else 0)) + sum(
        (n + num_segments) * c.element_size() for c in cols)
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = n * len(cols) / VECTOR_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), \
        "bytes" if bytes_ms >= ops_ms else "operations", bytes_


def columns_replay_phase(phase: str, calls, page_by: str,
                         depth: int = 0, picks=None):
    """Every ``segment_reduce_columns`` call of a recorded run, on the
    inputs the run gave it, against its plain version (ints exactly);
    then one page call (the one with the most lanes, or with the most
    live rows: ``page_by`` "n" or "live") and the merge (the call with
    the most groups, the last of equals) timed beside the plain version
    and ``index_add_`` over the unsorted gids. With ``depth``, the calls
    are a burst's folded calls over ``depth`` lanes (each lane's last
    segment is its dump segment), and the merge is the last call.
    ``picks`` names the timed calls instead ({case: call index})."""
    import torch

    from trino_tpu_torch.ops import kernels

    errs = [_check_columns(cols, gid, ns, kinds, order, kernels)
            for cols, gid, ns, kinds, order in calls]
    shapes = []
    for cols, gid, ns, kinds, order in calls:
        if depth:
            live = gid % (ns // depth) != ns // depth - 1
            g = gid[live]
            groups = int((g[1:] != g[:-1]).sum()) + 1 if g.numel() else 0
        else:
            live = gid < gid.shape[0]
            groups = int(gid[live].max()) + 1 if bool(live.any()) else 0
        shapes.append({"n": gid.shape[0], "live": int(live.sum()),
                       "groups": groups, "segments": ns})
    emit({"phase": phase, "calls": len(calls),
          "columns": sorted({len(c[0]) for c in calls}),
          "dtypes": sorted({str(col.dtype).removeprefix("torch.")
                            for c in calls for col in c[0]}),
          "kinds": sorted({k for c in calls for k in c[3]}),
          "order": all(c[4] is not None for c in calls),
          "shapes": shapes, "max_abs_err": max(errs)})
    if picks is None:
        merge = len(calls) - 1 if depth else \
            max(range(len(calls)), key=lambda i: (shapes[i]["groups"], i))
        largest = max((i for i in range(len(calls)) if i != merge),
                      key=lambda i: shapes[i][page_by])
        picks = {"page": largest, "merge": merge}
    timed = {}
    for case, i in picks.items():
        cols, gid, ns, kinds, order = calls[i]
        n = gid.shape[0]
        unsorted = torch.empty_like(gid)
        if order is None:
            unsorted.copy_(gid)
        else:
            unsorted[order] = gid
        unsorted64 = unsorted.to(torch.int64)
        outs = [torch.empty(ns, dtype=c.dtype, device=c.device)
                for c in cols]

        def library():
            for out, col in zip(outs, cols):
                out.index_add_(0, unsorted64, col)

        def kernel():
            kernels.segment_reduce_columns(cols, gid, ns, kinds, order)

        bound_ms, bound_by, bytes_ = _bound_ms(cols, n, ns,
                                               order is not None)
        timed[case] = {
            **shapes[i], "call": i, "columns": len(cols), "bytes": bytes_,
            "max_abs_err": errs[i], "bound_ms": bound_ms,
            "bound_by": bound_by, "kernel_ms": time_ms(kernel),
            "plain_ms": time_ms(
                lambda: kernels.segment_reduce_columns_reference(
                    cols, gid, ns, kinds, order)),
            "library_ms": time_ms(library)}
        device = kernel_device_ms(kernel, n)
        timed[case].update(device_ms=device["total"],
                           device_launches=device["launches_per_call"],
                           bound_share=_share(bound_ms, device["total"]))
        emit({"phase": phase, "case": case, **timed[case]})
    return timed


#: what the kernels line keeps of each timed hash kernel call
HASH_KEYS = ("n", "live", "operands", "groups", "rounds", "unresolved",
             "width", "blocks", "spills", "barriers", "max_abs_err",
             "kernel_ms",
             "device_ms", "single_ms", "plain_ms", "bound_ms", "bound_by",
             "bound_share", "library_ms")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "trino_tpu_torch")):
        print("chip_smoke: trino_tpu_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    card = device_phase()
    build_phase()
    kernel_phase()
    main_shape, columns_shapes = columns_phase()
    hash_shapes = hash_kernel_phase()
    tpch_warm = {}
    q1_launches, q1_hash_calls = q1_phase(card, tpch_warm)
    hash_replayed = {"q1": hash_replay_phase("q1_hash", q1_hash_calls)}
    del q1_hash_calls
    q3_launches, q3_calls, q3_hash_calls = q3_phase(card, tpch_warm)
    hash_replayed["q3"] = hash_replay_phase("q3_hash", q3_hash_calls)
    del q3_hash_calls
    by_query = {"q1": q1_launches, "q3": q3_launches}
    q3_shapes = columns_replay_phase("q3_columns", q3_calls, "n")
    del q3_calls
    by_query["q6"] = tpch_sf1_phase(card, 6, tpch_warm)
    by_query["q13"] = tpch_sf1_phase(card, 13, tpch_warm)
    q18_calls, q18_hash_calls = [], []
    by_query["q18"] = tpch_sf1_phase(card, 18, tpch_warm, q18_calls,
                                     q18_hash_calls)
    hash_replayed["q18"] = hash_replay_phase("q18_hash", q18_hash_calls)
    del q18_hash_calls
    launches = {q: n["segment_reduce"] for q, n in by_query.items()}
    hash_launches = {q: n["hash_insert"] for q, n in by_query.items()}
    q18_shapes = columns_replay_phase("q18_columns", q18_calls, "live")
    del q18_calls
    launches["window"] = window_phase(card)
    launches["sql_surface"] = sql_surface_phase(card)
    memory_warm = {}
    runner, memory_launches, peaks, memory_calls = memory_sf1_phase(
        card, tpch_warm, memory_warm)
    launches.update({f"memory_q{q}": n for q, n in memory_launches.items()})
    replayed = {"q3": q3_shapes, "q18": q18_shapes}
    for qid, page_by in ((3, "n"), (18, "live")):
        replayed[f"memory_q{qid}"] = columns_replay_phase(
            f"memory_q{qid}_columns", memory_calls.pop(qid), page_by)
    distributed_launches, distributed_calls, distributed_hash = \
        distributed_sf1_phase(card, runner, memory_warm)
    hash_replayed.update({f"distributed_{name}": shapes
                          for name, shapes in distributed_hash.items()})
    launches.update({f"distributed_{name}": n
                     for name, n in distributed_launches.items()})
    for name in DISTRIBUTED_RECORDED:
        calls, labels = distributed_calls.pop(name)
        replayed[f"distributed_{name}"] = columns_replay_phase(
            f"distributed_{name}_columns", calls, "live",
            picks=_step_picks(calls, labels))
        del calls
    with tempfile.TemporaryDirectory(prefix="chip_smoke_calls_") as dump:
        process_launches, process_shapes, process_hash_launches, \
            process_hash_shapes = process_sf1_phase(card, tpch_warm, dump)
    launches.update(process_launches)
    replayed.update(process_shapes)
    hash_launches.update(process_hash_launches)
    hash_replayed.update(process_hash_shapes)
    mesh_exchange_phase(card)
    mesh_launches, mesh_calls = mesh_q1_sf1_phase(card)
    launches.update(mesh_launches)
    half = len(mesh_calls) // 2          # partial calls, then merge-finals

    def _live(i):
        gid = mesh_calls[i][1]
        return int((gid < gid.shape[0]).sum())

    replayed["mesh_q1"] = columns_replay_phase(
        "mesh_q1_columns", mesh_calls, "live",
        picks={"page": max(range(half), key=_live),
               "merge": max(range(half, len(mesh_calls)), key=_live)})
    del mesh_calls
    step_calls = device_step_sf1_phase(card)
    launches["device_step"] = len(step_calls)
    replayed["device_step"] = columns_replay_phase(
        "device_step_columns", step_calls, "live", picks={"page": 0})
    del step_calls
    launches["explain_analyze_q18"] = explain_analyze_phase(card, runner)
    spill_launches, spill_calls = spill_phase(card, runner, peaks)
    launches.update(spill_launches)
    replayed["spill_q18"] = columns_replay_phase("spill_q18_columns",
                                                 spill_calls, "live")
    del spill_calls
    serving_launches, serving_calls, serving_hash_calls = serving_phase(
        card, runner)
    for name in ("q6", "q1", "q6d"):
        hash_replayed[f"serving_{name}_burst"] = hash_replay_phase(
            f"serving_{name}_hash", serving_hash_calls.pop(name))
    launches.update({f"serving_{k}": n for k, n in serving_launches.items()})
    observability_launches, profiled_calls, observability_calls = \
        observability_phase(card, runner)
    launches.update(observability_launches)
    del runner
    for key, page_by in (("q18_run2", "live"), ("q3_run2", "n"),
                         ("verbose_q1_run1", "live"),
                         ("verbose_q18_run1", "live"), ("slow_q6", "live")):
        replayed[f"observability_{key}"] = columns_replay_phase(
            f"observability_{key}_columns",
            observability_calls.pop(f"observability_{key}"), page_by)
    serving_shapes = {
        f"{name}_burst": columns_replay_phase(
            f"serving_{name}_columns", serving_calls.pop(name), "live",
            depth=8)
        for name in ("q6", "q1", "q6d")}
    bytes_ms = main_shape["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = main_shape["n"] * STATES_PER_PAGE / VECTOR_OPS_PER_S * 1e3
    hash_launches.update(HASH_LAUNCHES)
    emit({"phase": "wall", "script_s": round(time.perf_counter() - T0, 1)})
    emit({"kernels": [{
        "name": "segment_reduce",
        "route": "cuda",
        "source": "trino_tpu_torch/csrc/segment_reduce.cu",
        "replaces": "trino_tpu/ops/pallas_kernels.py:100",
        "launches": sum(launches.values()),
        "launches_by_query": launches,
        "profiled_calls_by_query": profiled_calls,
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["kernel_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": main_shape["library_ms"],
        "wrapper_host_us": columns_shapes["process_q3_merge"][
            "wrapper_host_us"],
        "columns_shapes": {case: {k: t[k] for k in (
            "n", "live", "columns", "max_abs_err", "kernel_ms", "plain_ms",
            "device_ms", "bound_ms", "bound_by", "bound_share",
            "library_ms")} for case, t in columns_shapes.items()},
        **{f"{q}_shapes": {case: {k: t[k] for k in (
            "n", "groups", "columns", "max_abs_err", "kernel_ms",
            "plain_ms", "device_ms", "device_launches", "bound_ms",
            "bound_by", "bound_share", "library_ms")}
            for case, t in shapes.items()}
           for q, shapes in replayed.items()},
        "serving_shapes": {burst: {case: {k: t[k] for k in (
            "n", "groups", "segments", "columns", "max_abs_err",
            "kernel_ms", "plain_ms", "device_ms", "device_launches",
            "bound_ms", "bound_by", "bound_share", "library_ms")}
            for case, t in shapes.items()}
            for burst, shapes in serving_shapes.items()},
    }, {
        "name": "hash_insert",
        "route": "cuda",
        "source": "trino_tpu_torch/csrc/hash_insert.cu",
        # a jit jax.lax.while_loop inside the hash_group_ids program, not
        # a Pallas kernel
        "replaces": "trino_tpu/ops/hashtable.py:153",
        "launches": sum(hash_launches.values()),
        "launches_by_query": hash_launches,
        "max_abs_err": max(t["max_abs_err"] for t in hash_shapes.values()),
        "ms": hash_shapes["q1_page"]["kernel_ms"],
        "device_ms": hash_shapes["q1_page"]["device_ms"],
        "single_ms": hash_shapes["q1_page"]["single_ms"],
        "plain_ms": hash_shapes["q1_page"]["plain_ms"],
        "bound_ms": hash_shapes["q1_page"]["bound_ms"],
        "bound_by": hash_shapes["q1_page"]["bound_by"],
        "library_ms": None,
        "rounds": hash_shapes["q1_page"]["rounds"],
        "case_shapes": {case: {k: t[k] for k in HASH_KEYS}
                        for case, t in hash_shapes.items()},
        **{f"{q}_shapes": {case: {k: t[k] for k in HASH_KEYS}
                           for case, t in shapes.items()}
           for q, shapes in hash_replayed.items()},
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                 "count": card["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
