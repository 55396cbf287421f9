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
             for every kind x dtype at both shapes q1's path gives it:
             the aggregation page (262,144 rows) and the final merge of
             the 24 page partials (8,388,608 rows), each with 4 groups
             and with ~n/7 groups, plus a ragged n with a dump tail;
             ints and MIN/MAX must match exactly, float sums the exact
             sum within SUM_RTOL of the segment's sum of |x|; times the
             kernel, the plain version and one PyTorch library call;
4. q1_sf1  — TPC-H q1 at SF1 through ``trino_tpu_torch.LocalQueryRunner``
             on the card, held against the oracle answer in
             ``tests/sf1_expected.py``; every kernel launch counter is set
             to 0 just before the timed run and read just after;
5. the ``kernels`` line: per kernel its route, source, the TPU kernel it
   replaces, launches on the main path, its error against the plain
   version, its time, the plain version's, the library call's and its
   memory/compute bound at the main path's shape;
6. the last line: ``{"ok": true, "device": {...}}``.

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


def _check_case(kind, col, gid, ns, kernels):
    """Kernel vs plain version on one input; returns the max abs error
    and the max error relative to the segment's sum of |x|. Ints and
    MIN/MAX must match exactly; a float SUM must be within
    SUM_RTOL * sum|x| of the exact sum, per segment."""
    import torch

    got = kernels.segment_reduce(col, gid, ns, kind)
    if not col.dtype.is_floating_point or kind != "sum":
        want = kernels.segment_reduce_reference(col, gid, ns, kind)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).nonzero()[:5].flatten().tolist()
            raise AssertionError(f"segment_reduce {kind} {col.dtype}: "
                                 f"mismatch at segments {bad}")
        return 0.0, 0.0
    want = kernels.segment_reduce_reference(col.double(), gid, ns, "sum")
    mag = kernels.segment_reduce_reference(col.abs().double(), gid, ns,
                                           "sum")
    err = (got.double() - want).abs()
    limit = SUM_RTOL[str(col.dtype).removeprefix("torch.")] * mag
    if bool((err > limit).any()):
        i = int((err - limit).argmax())
        raise AssertionError(
            f"segment_reduce sum {col.dtype}: segment {i} error "
            f"{float(err[i])} over limit {float(limit[i])}")
    rel = err / torch.where(mag > 0, mag, 1.0)
    return float(err.max()), float(rel.max())


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
    main = None
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
                if case == "q1_page" and kind == "sum" and dtype == "int64":
                    # q1's states at the page: 360 of the main path's 375
                    # launches have this shape
                    bytes_ = n * (col.element_size() + gid.element_size()) \
                        + (n + 1) * col.element_size()
                    main = dict(timings[case], n=n, bytes=bytes_,
                                max_abs_err=errors[case])
            emit({"phase": "kernel", "kernel": "segment_reduce",
                  "kind": kind, "dtype": dtype,
                  "shapes": {c: cases[c][0] for c in cases},
                  "sum_rtol": SUM_RTOL.get(dtype) if kind == "sum" else None,
                  "max_abs_err": errors, "max_rel_err": rel_errors,
                  "ms": timings})
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


def _assert_same(res, oracle_rows):
    """tests/test_tpch_oracle.py's comparison: decimals as floats, the
    oracle quantized to each decimal column's scale, floats within
    rel 1e-6 / abs 0.011 (half-up vs half-even on .5 ties)."""
    import math
    from decimal import Decimal

    def norm(v):
        return float(v) if isinstance(v, Decimal) else v

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

    got = [tuple(norm(v) for v in row) for row in res.rows]
    want = [tuple(quantize(norm(v), t) for v, t in zip(row, res.types))
            for row in oracle_rows]
    if len(got) != len(want):
        raise AssertionError(f"q1: {len(got)} rows, oracle {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        for j, (a, b) in enumerate(zip(g, w)):
            if not close(a, b):
                raise AssertionError(
                    f"q1 row {i} col {j}: engine={a!r} oracle={b!r}")


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
    _assert_same(res, _load_expected(1))
    pages = sum(sum(op.get("grouping_paths", {}).values())
                for op in res.stats["operators"]
                if op["name"] == "HashAggregationOperator")
    if pages == 0 or launches["segment_reduce"] < STATES_PER_PAGE * pages:
        raise AssertionError(
            f"segment_reduce launched {launches['segment_reduce']} times "
            f"for {pages} aggregated pages (want >= {STATES_PER_PAGE} "
            "per page)")
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
    main_shape = kernel_phase()
    launches = q1_phase(card)
    bytes_ms = main_shape["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = main_shape["n"] / VECTOR_OPS_PER_S * 1e3
    emit({"kernels": [{
        "name": "segment_reduce",
        "route": "cuda",
        "source": "trino_tpu_torch/csrc/segment_reduce.cu",
        "replaces": "trino_tpu/ops/pallas_kernels.py:100",
        "launches": launches["segment_reduce"],
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["kernel_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": main_shape["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                 "count": card["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
