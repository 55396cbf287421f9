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
             (torch.profiler, without the wrapper's host work);
5. q1_sf1  — TPC-H q1 at SF1 through ``trino_tpu_torch.LocalQueryRunner``
             on the card, held against the oracle answer in
             ``tests/sf1_expected.py``; every kernel launch counter is set
             to 0 just before the timed run and read just after, and the
             kernel must have been called once per aggregated page;
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
12. the ``kernels`` line: per kernel its route, source, the TPU kernel it
   replaces, launches on the main path (the sum over every query run
   above, with the count of each beside it), its error against the plain
   version, its time, the plain version's, the library call's and its
   memory/compute bound at the main path's shape (q1's page call), and
   the same at q3's and q18's page and merge calls (``q3_shapes``,
   ``q18_shapes``);
13. the last line: ``{"ok": true, "device": {...}}``.

Any failed check raises; nothing is caught, so a failed phase ends the
run with a non-zero exit code before the last line is printed.
"""

import ast
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

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


def kernel_device_ms(fn, iters: int = 10) -> dict:
    """Device time per call of the segment-reduce kernels that ``fn``
    launches, per kernel (fill, tile, carry) and in total, from
    torch.profiler: unlike ``time_ms`` it leaves out the wrapper's host
    work."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {"fill": 0.0, "tile": 0.0, "carry": 0.0}
    for e in prof.key_averages():
        m = re.search(r"\b(fill|tile|carry)_kernel<", e.key)
        if m and e.device_type != DeviceType.CPU:
            out[m.group(1)] += e.self_device_time_total / 1e3 / iters
    out["total"] = sum(out.values())
    return out


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
    path = kernels.build()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "flags": " ".join(kernels.NVCC_FLAGS),
          "source": f"trino_tpu_torch/csrc/{kernels.SOURCE}",
          "library": os.path.relpath(path, REPO)})


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


def columns_phase():
    """segment_reduce_columns as q1's hash path calls it, against its
    plain version, at the page and at the merge; times it beside the
    plain version, the one-column-at-a-time path and ``index_add_``."""
    import numpy as np
    import torch

    from trino_tpu_torch.ops import kernels

    rng = np.random.default_rng(20261017)
    dev = torch.device("cuda")

    # mixed table at the page: 34 int64 SUM (two tables of <= 32 columns)
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
                    cols, gid, n + 1, kinds, order)),
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
    return main


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


def q1_phase(card):
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
    runner.execute(sql)                       # cold: loads the library
    cold_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    kernels.segment_reduce.launches = 0
    t0 = time.perf_counter()
    res = runner.execute(sql)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = {"segment_reduce": kernels.segment_reduce.launches}
    _assert_same(res, _load_expected(1), "q1")
    pages = _aggregated_pages(res)
    if pages == 0 or launches["segment_reduce"] != pages:
        raise AssertionError(
            f"segment_reduce launched {launches['segment_reduce']} times "
            f"for {pages} aggregated pages (want one per page)")
    rows = sum(r[-1] for r in res.rows)       # count(*) over all groups
    emit({"phase": "q1_sf1", "rows_out": len(res.rows),
          "matches_oracle": True, "aggregated_pages": pages,
          "launches": launches, "cold_s": round(cold_s, 3),
          "warm_s": round(warm_s, 4),
          "lineitem_rows_aggregated": rows,
          "aggregated_rows_per_s": round(rows / warm_s),
          "peak_bytes": res.stats["memory"]["peak_bytes"],
          "card": card["nvidia_smi"]})
    return launches


def _recording(calls):
    """A stand-in for ``segment_reduce_columns`` that keeps a copy of
    each call's inputs in ``calls`` and then makes the call."""
    from trino_tpu_torch.ops import kernels

    def record(cols, gid, num_segments, kinds, order=None):
        calls.append(([c.clone() for c in cols], gid.clone(), num_segments,
                      list(kinds), None if order is None else order.clone()))
        return kernels.segment_reduce_columns(cols, gid, num_segments, kinds,
                                              order)
    return record


def q3_phase(card):
    """q3 at SF1; returns the launches of the warm run and the inputs of
    every kernel call of the cold run (the same calls: the data and the
    operators' capacity guesses are the same in both runs)."""
    import torch

    from trino_tpu_torch import LocalQueryRunner
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.ops import aggregation, hashtable, kernels
    from trino_tpu_torch.resources.tpch_queries import TPCH_QUERIES
    from trino_tpu_torch.sql.analyzer import Session

    runner = LocalQueryRunner({"tpch": TpchConnector(page_rows=1 << 16)},
                              Session(catalog="tpch", schema="sf1"),
                              desired_splits=8, device="cuda")
    sql = TPCH_QUERIES[3]
    calls = []
    aggregation.segment_reduce_columns = _recording(calls)
    hashtable.segment_reduce_columns = _recording(calls)
    t0 = time.perf_counter()
    runner.execute(sql)
    cold_s = time.perf_counter() - t0
    aggregation.segment_reduce_columns = kernels.segment_reduce_columns
    hashtable.segment_reduce_columns = kernels.segment_reduce_columns
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.segment_reduce.launches = 0
    t0 = time.perf_counter()
    res = runner.execute(sql)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = {"segment_reduce": kernels.segment_reduce.launches}
    _assert_same(res, _load_expected(3), "q3")
    pages = _aggregated_pages(res)
    if pages == 0 or launches["segment_reduce"] != pages \
            or len(calls) != pages:
        raise AssertionError(
            f"q3: segment_reduce launched {launches['segment_reduce']} "
            f"times (cold run: {len(calls)} calls) for {pages} aggregated "
            "pages (want one per page)")
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
          "dynamic_filters": dfs, "joins": joins,
          "peak_bytes": res.stats["memory"]["peak_bytes"],
          # less the recorded inputs, which the warm run found resident
          "device_peak_bytes": torch.cuda.max_memory_allocated() - sum(
              t.nbytes for cols, gid, _, _, order in calls
              for t in [*cols, gid] + ([] if order is None else [order])),
          "card": card["nvidia_smi"]})
    return launches, calls


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


def tpch_sf1_phase(card, qid: int, calls=None):
    """TPC-H ``qid`` at SF1, held against the oracle; cold and warm wall,
    segment-reduce calls (one per aggregated page) and the joins'
    strategies. With ``calls``, the cold run keeps a copy of the inputs
    of every kernel call it makes. Returns the warm run's launches."""
    import torch

    from trino_tpu_torch.ops import aggregation, hashtable, kernels
    from trino_tpu_torch.resources.tpch_queries import TPCH_QUERIES

    runner = _sf1_runner()
    sql = TPCH_QUERIES[qid]
    if calls is not None:
        aggregation.segment_reduce_columns = _recording(calls)
        hashtable.segment_reduce_columns = _recording(calls)
    t0 = time.perf_counter()
    runner.execute(sql)
    cold_s = time.perf_counter() - t0
    aggregation.segment_reduce_columns = kernels.segment_reduce_columns
    hashtable.segment_reduce_columns = kernels.segment_reduce_columns
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.segment_reduce.launches = 0
    t0 = time.perf_counter()
    res = runner.execute(sql)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = kernels.segment_reduce.launches
    _assert_same(res, _load_expected(qid), f"q{qid}")
    pages = _aggregated_pages(res)
    if pages == 0 or launches != pages or \
            (calls is not None and len(calls) != pages):
        raise AssertionError(
            f"q{qid}: segment_reduce launched {launches} times (cold run: "
            f"{None if calls is None else len(calls)} calls) for {pages} "
            "aggregated pages (want one per page)")
    emit({"phase": f"q{qid}_sf1", "rows_out": len(res.rows),
          "matches_oracle": True, "aggregated_pages": pages,
          "launches": {"segment_reduce": launches},
          "cold_s": round(cold_s, 3), "warm_s": round(warm_s, 4),
          "joins": _join_strategies(res),
          "peak_bytes": res.stats["memory"]["peak_bytes"],
          "device_peak_bytes": torch.cuda.max_memory_allocated() - sum(
              t.nbytes for cols, gid, _, _, order in (calls or [])
              for t in [*cols, gid] + ([] if order is None else [order])),
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
        kernels.segment_reduce.launches = 0
        t0 = time.perf_counter()
        res = runner.execute(sql)
        if device == "cuda":
            torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        launches += kernels.segment_reduce.launches
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
            kernels.segment_reduce.launches = 0
            t0 = time.perf_counter()
            got = runners["cuda"].execute(sql).rows
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            launches += kernels.segment_reduce.launches
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


def columns_replay_phase(phase: str, calls, page_by: str):
    """Every ``segment_reduce_columns`` call of a query's cold run, on the
    inputs the run gave it, against its plain version (ints exactly);
    then one page call (the one with the most lanes, or with the most
    live rows: ``page_by`` "n" or "live") and the merge (the call with
    the most groups) timed beside the plain version and ``index_add_``
    over the unsorted gids."""
    import torch

    from trino_tpu_torch.ops import kernels

    errs = [_check_columns(cols, gid, ns, kinds, order, kernels)
            for cols, gid, ns, kinds, order in calls]
    shapes = []
    for cols, gid, ns, kinds, order in calls:
        live = gid < gid.shape[0]
        shapes.append({"n": gid.shape[0], "live": int(live.sum()),
                       "groups": int(gid[live].max()) + 1
                       if bool(live.any()) else 0})
    emit({"phase": phase, "calls": len(calls),
          "columns": sorted({len(c[0]) for c in calls}),
          "dtypes": sorted({str(col.dtype).removeprefix("torch.")
                            for c in calls for col in c[0]}),
          "kinds": sorted({k for c in calls for k in c[3]}),
          "order": all(c[4] is not None for c in calls),
          "shapes": shapes, "max_abs_err": max(errs)})
    merge = max(range(len(calls)), key=lambda i: shapes[i]["groups"])
    largest = max((i for i in range(len(calls)) if i != merge),
                  key=lambda i: shapes[i][page_by])
    timed = {}
    for case, i in (("page", largest), ("merge", merge)):
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
            "library_ms": time_ms(library),
            "device_ms": kernel_device_ms(kernel)["total"]}
        emit({"phase": phase, "case": case, **timed[case]})
    return timed


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
    main_shape = columns_phase()
    q1_launches = q1_phase(card)
    q3_launches, q3_calls = q3_phase(card)
    launches = {"q1": q1_launches["segment_reduce"],
                "q3": q3_launches["segment_reduce"]}
    q3_shapes = columns_replay_phase("q3_columns", q3_calls, "n")
    del q3_calls
    launches["q6"] = tpch_sf1_phase(card, 6)
    launches["q13"] = tpch_sf1_phase(card, 13)
    q18_calls = []
    launches["q18"] = tpch_sf1_phase(card, 18, q18_calls)
    q18_shapes = columns_replay_phase("q18_columns", q18_calls, "live")
    del q18_calls
    launches["window"] = window_phase(card)
    launches["sql_surface"] = sql_surface_phase(card)
    bytes_ms = main_shape["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = main_shape["n"] * STATES_PER_PAGE / VECTOR_OPS_PER_S * 1e3
    emit({"kernels": [{
        "name": "segment_reduce",
        "route": "cuda",
        "source": "trino_tpu_torch/csrc/segment_reduce.cu",
        "replaces": "trino_tpu/ops/pallas_kernels.py:100",
        "launches": sum(launches.values()),
        "launches_by_query": launches,
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["kernel_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": main_shape["library_ms"],
        **{f"{q}_shapes": {case: {k: t[k] for k in (
            "n", "groups", "columns", "max_abs_err", "kernel_ms",
            "plain_ms", "device_ms", "bound_ms", "bound_by", "library_ms")}
            for case, t in shapes.items()}
           for q, shapes in (("q3", q3_shapes), ("q18", q18_shapes))},
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                 "count": card["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
