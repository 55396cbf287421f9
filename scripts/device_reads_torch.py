#!/usr/bin/env python3
"""Where the host reads device tensors back, and what counting it costs,
on the card.

    python3 scripts/device_reads_torch.py coverage [--workload W]
        [--seed N] [--seconds S] [--out PATH]
    python3 scripts/device_reads_torch.py cost [--out PATH]

``coverage`` makes one traced run of a benchmark cell
(``sqlbench/run.py``'s ``run_cell``, ``--trace 1``), keeping every
statement's spans, and lays the read intervals the spans carry
(``reads`` on operator, task and root spans) over the device trace's
copies: the share of the device time of ``Memcpy DtoH (Device ->
Pageable)`` copies that lies inside a read, the median distance from a
copy's end to the end of the read around it, the share of ``Memcpy DtoH
(Device -> Pinned)`` time outside every read, the reads ranked by
operator and by site (by wait and by bytes), and the operator calls and
reads per statement. It prints the run's result line and a summary.

``cost`` times what the counters add on this host: per operator call
(two thread-CPU clock reads, the charge target's swap, the adds), per
read (two clock reads and the charge), and per call and read while a
profiler records (one tuple append each).

Both write their JSON to ``--out`` too and print the card's name and
power limit. Imports neither JAX nor the JAX package.
"""

import argparse
import functools
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

PAGEABLE = "Memcpy DtoH (Device -> Pageable)"
PINNED = "Memcpy DtoH (Device -> Pinned)"


class _Keep:
    """Delegates to the runner and keeps each statement's spans."""

    def __init__(self, runner):
        self._runner = runner
        self.traces = []
        self.execute = functools.wraps(runner.execute)(
            lambda *a, **kw: self._execute(*a, **kw))

    def __getattr__(self, name):
        return getattr(self._runner, name)

    def _execute(self, sql, *args, **kwargs):
        res = self._runner.execute(sql, *args, **kwargs)
        self.traces.append(res.stats.get("trace") or [])
        return res


def _copies(doc):
    """(name, start, end) in epoch seconds of the device copies of an
    exported Chrome trace."""
    base = int(doc.get("baseTimeNanoseconds", 0)) / 1e9
    out = []
    for e in doc.get("traceEvents", ()):
        if e.get("ph") == "X" and e.get("cat") == "gpu_memcpy":
            start = base + float(e["ts"]) / 1e6
            out.append((e["name"], start,
                        start + float(e.get("dur", 0.0)) / 1e6))
    return out


def _covered(a, b, intervals):
    """Length of [a, b] inside the union of sorted ``intervals``."""
    from sqlbench.summary import union_length

    return union_length([(max(a, s), min(b, e)) for s, e in intervals
                         if e > a and s < b])


def coverage(args) -> dict:
    import bisect

    from sqlbench import run

    keep = []

    def wrap(runner):
        keep.append(_Keep(runner))
        return keep[0]

    line, _, _, _ = run.run_cell(args.workload, args.seed, args.seconds,
                                 True, wrap_runner=wrap)
    print(json.dumps(line), flush=True)
    with open(os.path.join(run.OUT_DIR,
                           f"{args.workload}.trace.json")) as f:
        doc = json.load(f)
    copies = _copies(doc)
    reads, by_op, by_site = [], {}, {}
    calls_per, reads_per = [], []
    for spans in keep[0].traces:
        n_calls = n_reads = 0
        for s in spans:
            a = s.get("attrs", {})
            kind = a.get("span_kind")
            who = s["name"] if kind == "operator" else \
                (kind or "statement root")
            if a.get("d2h_reads"):
                o = by_op.setdefault(who, [0, 0, 0.0])
                o[0] += a["d2h_reads"]
                o[1] += a["d2h_bytes"]
                o[2] += a["d2h_wait_ms"]
                n_reads += a["d2h_reads"]
            for r0, r1, site, nbytes in a.get("reads") or ():
                reads.append((r0, r1))
                o = by_site.setdefault(site, [0, 0, 0.0])
                o[0] += 1
                o[1] += nbytes
                o[2] += (r1 - r0) * 1e3
            n_calls += len(a.get("calls") or ())
        if n_calls:
            calls_per.append(n_calls)
            reads_per.append(n_reads)
    reads.sort()
    # only the copies inside the window in which reads were recorded
    lo = reads[0][0] if reads else 0.0
    hi = reads[-1][1] if reads else 0.0
    pageable = [(s, e) for n, s, e in copies if n == PAGEABLE
                and s >= lo - 1.0 and e <= hi + 1.0]
    pinned = [(s, e) for n, s, e in copies if n == PINNED
              and s >= lo - 1.0 and e <= hi + 1.0]
    starts = [r[0] for r in reads]
    gaps = []
    for s, e in pageable:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and reads[i][1] >= e:
            gaps.append((reads[i][1] - e) * 1e3)
    total = sum(e - s for s, e in pageable)
    inside = sum(_covered(s, e, reads) for s, e in pageable)
    ptotal = sum(e - s for s, e in pinned)
    pinside = sum(_covered(s, e, reads) for s, e in pinned)

    def ranked(d, i):
        return [[k] + v for k, v in sorted(d.items(), key=lambda x:
                                              -x[1][i])]

    return {
        "step": "coverage", "workload": args.workload, "seed": args.seed,
        "pageable_copies": len(pageable), "pageable_s": total,
        "pageable_inside_pct": 100.0 * inside / total if total else None,
        "pageable_inside_a_read": len(gaps),
        "read_end_after_copy_end_ms_median":
            statistics.median(gaps) if gaps else None,
        "read_end_after_copy_end_ms_quartiles":
            statistics.quantiles(gaps, n=4) if len(gaps) > 1 else None,
        "pinned_copies": len(pinned), "pinned_s": ptotal,
        "pinned_outside_pct":
            100.0 * (ptotal - pinside) / ptotal if ptotal else None,
        "reads_recorded": len(reads),
        "calls_per_statement": calls_per,
        "reads_per_statement": reads_per,
        # [name, reads, bytes, wait ms] over every window statement
        "by_operator_wait": ranked(by_op, 2),
        "by_operator_bytes": ranked(by_op, 1),
        # [site, reads, bytes, host ms] over the traced statements
        "by_site_wait": ranked(by_site, 2),
        "by_site_bytes": ranked(by_site, 1),
    }


def _per_op(fn, n=200_000) -> float:
    """ns per call of ``fn`` (best of five loops of ``n``)."""
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter_ns() - t0) / n)
    return best


def cost(args) -> dict:
    from trino_tpu_torch.exec.driver import OperatorStats
    from trino_tpu_torch.telemetry import device_reads

    st = OperatorStats("x")
    local = device_reads.LOCAL

    def empty():
        pass

    def call():
        # what Driver._call adds to each call
        outer = local.target
        local.target = st
        u0 = time.thread_time_ns()
        try:
            pass
        finally:
            local.target = outer
        u1 = time.thread_time_ns()
        st.cpu_ns += u1 - u0
        if device_reads.recording():
            pass

    def read():
        # what a read adds beside the copy itself
        t0 = time.perf_counter_ns()
        device_reads._charge(8, t0, time.perf_counter_ns(), "cost")

    spans = []

    def append():
        spans.append((1, 2))
        if len(spans) > 100_000:
            spans.clear()

    base = _per_op(empty)
    local.target = st
    try:
        per_read = _per_op(read) - base
    finally:
        local.target = None
    return {"step": "cost", "empty_ns": base,
            "thread_time_ns": _per_op(time.thread_time_ns) - base,
            "perf_counter_ns": _per_op(time.perf_counter_ns) - base,
            "per_call_ns": _per_op(call) - base,
            "per_read_ns": per_read,
            "per_interval_ns": _per_op(append) - base}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("step", choices=("coverage", "cost"))
    ap.add_argument("--workload", default="tpch_sf1_cluster4.exchange")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 101)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from sqlbench.run import cache_dirs, power_limit

    cache_dirs()
    out = coverage(args) if args.step == "coverage" else cost(args)
    out["card"] = power_limit()
    print(json.dumps(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
