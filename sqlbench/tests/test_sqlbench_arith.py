"""The arithmetic, on inputs worked out by hand: the geometric mean, p90
over all statements, the rate, the union of busy intervals and the idle
gaps, both roofline bounds, and the readers that combine them."""

import math

import pytest

from sqlbench import devtrace, instrument, readers, roofline, summary


def test_geomean_percentile_rate():
    assert summary.geomean([1, 100]) == pytest.approx(10.0)
    assert summary.geomean([2, 8, 4]) == pytest.approx(4.0)
    # 11 values 0..100 by 10: the 90th percentile is the tenth, 90
    assert summary.percentile(list(range(0, 101, 10)), 90) == \
        pytest.approx(90.0)
    # 10 values 1..10: rank 8.1 lies between 9 and 10
    assert summary.percentile(list(range(1, 11)), 90) == pytest.approx(9.1)
    assert summary.rate(90, 40.0) == pytest.approx(2.25)
    assert summary.spread([1, 2, 3, 4, 5]) == pytest.approx(
        (4.5 - 1.5) / 3)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert summary.union_length(iv) == pytest.approx(5.0)
    assert summary.gaps(iv, 0, 10) == [(3, 5), (6, 8), (9, 10)]
    assert summary.gaps([], 1, 2) == [(1, 2)]
    assert summary.overlap(0, 10, 5, 20) == 5


def test_roofline_bytes():
    # 1,000 lanes, 600 in range, two int64 columns, 4 segments, order
    assert roofline.segment_reduce_bytes(1000, 600, (8, 8), 4, True) == \
        1000 * 12 + 2 * (600 + 4) * 8
    assert roofline.segment_reduce_bytes(1000, 600, (8, 4), 4, False) == \
        1000 * 4 + (600 + 4) * 8 + (600 + 4) * 4
    # 1,000 lanes, 250 live, an int64 and an int32 key operand
    assert roofline.hash_insert_bytes(1000, 250, (8, 4)) == \
        1000 + 250 * 12 + 1000 * 5
    assert roofline.bound_s(3.35e12) == pytest.approx(1.0)


def _trace():
    doc = {"baseTimeNanoseconds": 1_000_000_000,
           "traceEvents": [
               {"ph": "X", "cat": "kernel", "name": "void tile_kernel<true>(P)",
                "ts": 100.0, "dur": 10.0, "args": {"stream": 7}},
               {"ph": "X", "cat": "kernel", "name": "carry_kernel(P)",
                "ts": 115.0, "dur": 5.0, "args": {"stream": 7}},
               {"ph": "X", "cat": "kernel", "name": "grid_kernel(P)",
                "ts": 130.0, "dur": 20.0, "args": {"stream": 7}},
               {"ph": "X", "cat": "gpu_memcpy",
                "name": "Memcpy HtoD (Pageable -> Device)",
                "ts": 160.0, "dur": 40.0, "args": {"stream": 7}},
               {"ph": "X", "cat": "kernel", "name": "reduce_kernel",
                "ts": 90.0, "dur": 1.0, "args": {"stream": 9}},
               {"ph": "X", "cat": "kernel", "name": "reduce_kernel",
                "ts": 140.0, "dur": 50.0, "args": {"stream": 9}},
               {"ph": "X", "cat": "cpu_op", "name": "aten::add",
                "ts": 0.0, "dur": 999.0, "args": {}},
           ]}
    return devtrace.parse(doc, 1.0 + 100e-6, 1.0 + 300e-6, exclude={9})


def test_trace_busy_idle_and_own_stream():
    t = _trace()
    assert t.own_ops == 2 and len(t.ops) == 4
    # busy: [100,110] [115,120] [130,150] [160,200] = 75 us of 200
    assert t.busy_s() == pytest.approx(75e-6)
    assert t.window_s == pytest.approx(200e-6)
    gaps = t.idle_gaps()
    assert [(b - a) * 1e6 for a, b in gaps] == pytest.approx(
        [5, 10, 10, 100])
    assert len(t.kernels()) == 3
    assert len(t.kernels(("tile_kernel", "carry_kernel"))) == 2


def _run(trace, calls, records):
    return readers.Run(seconds=1.0, window=(trace.t0, trace.t1),
                       records=records, setup_s=1.0, trace=trace,
                       kernel_calls=calls)


def test_roofline_share_and_per_statement():
    t = _trace()
    mid = (t.t0 + t.t1) / 2
    seg = instrument.KernelCall("segment_reduce", mid, 1000, (8,), 10,
                                False, 500)
    hsh = instrument.KernelCall("hash_insert", mid, 1000, (8,), 0, False,
                                400)
    records = [{"t_post": t.t0 - t.window_s, "t_done": t.t1,
                "latency_ms": 1.0}]          # half inside the window
    run = _run(t, [seg, hsh], records)
    seg_bytes = 1000 * 4 + (500 + 10) * 8
    assert readers.roofline_share(run, "segment_reduce") == pytest.approx(
        100 * seg_bytes / 3.35e12 / 15e-6)
    hash_bytes = 1000 + 400 * 8 + 1000 * 5
    assert readers.roofline_share(run, "hash_insert") == pytest.approx(
        100 * hash_bytes / 3.35e12 / 20e-6)
    assert readers.statements_in_trace(run) == pytest.approx(0.5)
    h2d = readers.load("scan.h2d_ms").read(run)
    assert h2d == pytest.approx(0.040 / 0.5)
    assert readers.load("device.launches_per_query").read(run) == \
        pytest.approx(3 / 0.5)
    assert readers.load("device.idle_pct").read(run) == pytest.approx(
        100 * (1 - 75 / 200))


def test_hash_roofline_charges_the_calls_memset():
    """A hash-insert call's device time is its kernel and the memset
    just before it on its stream; a memset elsewhere is not charged."""
    doc = {"baseTimeNanoseconds": 1_000_000_000,
           "traceEvents": [
               {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
                "ts": 110.0, "dur": 4.0, "args": {"stream": 7}},
               {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
                "ts": 120.0, "dur": 6.0, "args": {"stream": 7}},
               {"ph": "X", "cat": "kernel", "name": "grid_kernel(P)",
                "ts": 130.0, "dur": 20.0, "args": {"stream": 7}},
               {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
                "ts": 125.0, "dur": 8.0, "args": {"stream": 8}},
               {"ph": "X", "cat": "kernel", "name": "fill_kernel",
                "ts": 150.0, "dur": 2.0, "args": {"stream": 8}},
               {"ph": "X", "cat": "kernel", "name": "grid_kernel(P)",
                "ts": 160.0, "dur": 30.0, "args": {"stream": 8}},
           ]}
    t = devtrace.parse(doc, 1.0 + 100e-6, 1.0 + 300e-6)
    mid = (t.t0 + t.t1) / 2
    calls = [instrument.KernelCall("hash_insert", mid, 1000, (8,), 0, False,
                                   400)] * 2
    run = _run(t, calls, [])
    hash_bytes = 1000 + 400 * 8 + 1000 * 5
    # stream 7: its kernel and the memset just before it (6 us, not the
    # earlier 4); stream 8: a kernel ran between the memset and the call
    assert readers.memsets_before(t, t.kernels(("grid_kernel",))) == \
        pytest.approx(6e-6)
    assert readers.roofline_share(run, "hash_insert") == pytest.approx(
        100 * hash_bytes / 3.35e12 / ((20e-6 + 6e-6 + 30e-6) / 2))


def test_end_to_end_readers():
    recs = [{"t_post": 0.0, "t_done": 1.0, "latency_ms": 100.0},
            {"t_post": 1.0, "t_done": 2.0, "latency_ms": 1000.0},
            {"t_post": 9.5, "t_done": 10.5, "latency_ms": 10.0},
            {"t_post": 3.0, "t_done": 3.1, "error": "x"}]
    run = readers.Run(seconds=10.0, window=(0.0, 10.0), records=recs,
                      setup_s=3.0)
    assert readers.load("queries_per_s").read(run) == pytest.approx(0.2)
    assert readers.load("serving.geomean_ms").read(run) == pytest.approx(100.0)
    # three latencies 10, 100, 1000: rank 1.5 lies between 100 and 1000
    assert readers.load("p75_ms").read(run) == pytest.approx(
        100 + 0.5 * 900)
    assert readers.load("setup_s").read(run) == 3.0
    assert math.isfinite(readers.load("p75_ms").read(run))


def test_device_ms_leaves_host_copies_out():
    t0 = 5.0
    ops = [devtrace.DeviceOp("tile_kernel", "kernel", 7, 0.10, 0.30),
           devtrace.DeviceOp("grid_kernel", "kernel", 8, 0.20, 0.40),
           devtrace.DeviceOp("Memset (Device)", "gpu_memset", 7, 0.50,
                             0.60),
           devtrace.DeviceOp("Memcpy DtoD (Device -> Device)",
                             "gpu_memcpy", 7, 0.60, 0.70),
           devtrace.DeviceOp("Memcpy DtoH (Device -> Pageable)",
                             "gpu_memcpy", 7, 0.70, 1.50),
           devtrace.DeviceOp("Memcpy HtoD (Pageable -> Device)",
                             "gpu_memcpy", 7, 1.50, 1.90)]
    t = devtrace.DeviceTrace(t0, t0 + 2.0, ops)
    records = [{"t_post": t0, "t_done": t0 + 1.0, "latency_ms": 1e3},
               {"t_post": t0 + 1.0, "t_done": t0 + 2.0, "latency_ms": 1e3}]
    run = _run(t, [], records)
    # [0.1, 0.4] + [0.5, 0.7] = 0.5 s of the device's own work, two
    # statements
    assert readers.load("device_ms").read(run) == pytest.approx(250.0)
    assert readers.load("device_ms").read(_run(
        devtrace.DeviceTrace(t0, t0 + 2.0, ops[4:]), [], records)) is None

