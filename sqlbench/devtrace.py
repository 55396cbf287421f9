"""The device trace of a traced run: ``torch.profiler`` over the last
``trace_seconds`` of the window, exported as a Chrome trace, and read
back into device intervals on the host's epoch clock.

A device op is a kernel, a copy or a set (``cat`` ``kernel``,
``gpu_memcpy``, ``gpu_memset``). Ops on the side stream of
``instrument.KernelCalls`` are the benchmark's own and are left out of
everything here; ``Recorder.warm`` finds that stream's id in a short
trace of set-up in which only the side stream works.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from . import summary

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class DeviceOp:
    name: str
    cat: str
    stream: int
    #: seconds after the trace's ``t0`` (epoch seconds lack the digits
    #: for a kernel of a few microseconds)
    start: float
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class DeviceTrace:
    #: host epoch seconds at which the profiler started and stopped
    t0: float
    t1: float
    ops: List[DeviceOp] = field(default_factory=list)
    #: ops that were left out as the benchmark's own
    own_ops: int = 0

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def clipped(self) -> List[Tuple[float, float]]:
        """Every op's interval inside the window, in seconds after t0."""
        w = self.window_s
        return [(max(o.start, 0.0), min(o.end, w))
                for o in self.ops if o.end > 0.0 and o.start < w]

    def busy_s(self) -> float:
        """Seconds in which some device op ran (the union of their
        intervals, inside the traced window)."""
        return summary.union_length(self.clipped())

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """The stretches of the window with no device op, in epoch
        seconds."""
        return [(self.t0 + a, self.t0 + b) for a, b in
                summary.gaps(self.clipped(), 0.0, self.window_s)]

    def kernels(self, names: Tuple[str, ...] = ()) -> List[DeviceOp]:
        """Kernel launches, or those whose name holds one of ``names``
        as a word."""
        out = [o for o in self.ops if o.cat == "kernel"]
        if names:
            out = [o for o in out if any(_has_word(o.name, n)
                                         for n in names)]
        return out

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for o in self.ops:
            by[o.name] = by.get(o.name, 0.0) + o.seconds
        return [[n[:200], s] for n, s in
                sorted(by.items(), key=lambda x: -x[1])[:k]]


def _has_word(text: str, word: str) -> bool:
    i = text.find(word)
    while i >= 0:
        before = text[i - 1] if i > 0 else " "
        j = i + len(word)
        after = text[j] if j < len(text) else " "
        if not (before.isalnum() or before == "_") and \
                not (after.isalnum() or after == "_"):
            return True
        i = text.find(word, i + 1)
    return False


def parse(doc: dict, t0: float, t1: float,
          exclude=frozenset()) -> DeviceTrace:
    """The device ops of an exported Chrome trace, whose timestamps are
    microseconds after ``baseTimeNanoseconds`` on the epoch clock; ``t0``
    and ``t1`` (epoch seconds) bound the traced window: ops that began
    after it, and ops on the streams ``exclude``, are left out."""
    offset = (int(doc.get("baseTimeNanoseconds", 0)) - round(t0 * 1e9)) / 1e9
    ops = []
    for e in doc.get("traceEvents", ()):
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        start = offset + float(e["ts"]) / 1e6
        args = e.get("args") or {}
        ops.append(DeviceOp(e.get("name", "?"), e["cat"],
                            int(args.get("stream", -1)), start,
                            start + float(e.get("dur", 0.0)) / 1e6))
    trace = DeviceTrace(t0, t1, [o for o in ops if o.stream not in exclude
                                 and o.start < t1 - t0 and o.end > 0.0])
    trace.own_ops = sum(o.stream in exclude for o in ops)
    if ops and not any(abs(o.start) < 3600 for o in ops):
        raise RuntimeError(
            f"device trace: its clock does not match the host's (the first "
            f"op {ops[0].start:.3f} s after the profiler started)")
    return trace


class Recorder:
    """``torch.profiler`` on the device's activity only. The caller
    starts it, closes the traced window (``close``), and stops it and
    ``read``s the trace once the statements have drained, so that the
    profiler's seconds-long stop holds up no statement of the window.
    ``read`` exports the Chrome trace to ``path`` and returns the ops of
    the window."""

    def __init__(self, path: str):
        self.path = path
        self.prof = None
        self.t0 = self.t1 = 0.0
        #: streams whose ops are the benchmark's own
        self.exclude = frozenset()

    def warm(self, probe):
        """A short profile in set-up, so that the profiler's first start
        (seconds, in which the process holds its interpreter lock) does
        not fall into the window; ``probe`` launches ops on the side
        stream alone, whose id the profile then shows. Returns it."""
        import torch

        torch.cuda.synchronize()
        self.start()
        for _ in range(3):
            probe()
        torch.cuda.synchronize()
        self.close()
        self.stop()
        warm = self.read()
        self.exclude = frozenset(o.stream for o in warm.ops)
        if len(self.exclude) != 1:
            raise RuntimeError(f"device trace: the side stream's ops ran on "
                               f"streams {sorted(self.exclude)}")
        return self.exclude

    def warm_alone(self) -> None:
        """A short profile of one op in set-up, for a run with no side
        stream: the profiler's first start stays out of the window."""
        import torch

        torch.cuda.synchronize()
        self.start()
        torch.ones(1, device="cuda").add_(1)
        self.close()
        self.stop()
        self.read()

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.time()

    def close(self) -> None:
        self.t1 = time.time()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.prof.stop()

    def read(self) -> DeviceTrace:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        with open(self.path) as f:
            doc = json.load(f)
        return parse(doc, self.t0, self.t1, self.exclude)
