"""Device-to-host reads: the one door through which the host reads a
device tensor, and the counters each read is charged to.

Every read of a device tensor by the host (an explicit copy to the
host, a list of its values, one scalar, and the implicit ones: ``int``,
``bool`` or ``float`` of a 0-d tensor, ``np.asarray`` of a tensor) waits
until the device has computed the tensor, then copies it. The port's
code makes each such read through ``to_cpu``, ``to_host`` or
``host_scalar``, naming its site. For a tensor on a CUDA device the read
is charged with its bytes, one count and the host's wall from call to
return (``perf_counter_ns``) to the target on the calling thread:

- the operator whose call is running (``exec.driver.Driver._call`` sets
  its ``OperatorStats``);
- else the task whose quantum is running (``charged``);
- else the statement the thread is executing (``charging``);
- else ``UNCHARGED``, the process's reads outside any statement.

Each read also adds to the process-wide ``TALLY``. A CPU tensor's copy
is no device read and is charged nothing. While a ``torch.profiler``
session records, each read also keeps its ``(start, end, site, bytes)``
on its target (``read_spans``, perf_counter ns), so that a trace can lay
the reads beside the device's copies (``telemetry.tracing.ANCHOR_NS``
puts them on the epoch clock).
"""

from __future__ import annotations

import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch
import torch.autograd.profiler as _torch_profiler


class Reads:
    """A charge target's counters (``OperatorStats`` carries the same
    four fields)."""

    __slots__ = ("d2h_reads", "d2h_bytes", "d2h_wait_ns", "read_spans")

    def __init__(self):
        self.d2h_reads = 0
        self.d2h_bytes = 0
        self.d2h_wait_ns = 0
        #: (start ns, end ns, site, bytes) of each read made while a
        #: torch.profiler session recorded; None outside one
        self.read_spans: Optional[list] = None


class _Local(threading.local):
    #: the target reads on this thread are charged to
    target = None


LOCAL = _Local()
#: reads made outside any statement (a local runner's coordinator work,
#: the CLI, tests)
UNCHARGED = Reads()
#: every read of the process, whatever it was charged to
TALLY = Reads()
_lock = threading.Lock()


def recording() -> bool:
    """Whether a torch.profiler session records now (the module flag is
    process-wide: the executor's threads see it too)."""
    return _torch_profiler._is_profiler_enabled


def _on_device(t: torch.Tensor) -> bool:
    """Whether reading ``t`` is a device read (tests replace it to drive
    the accounting on the CPU)."""
    return t.is_cuda


def _charge(nbytes: int, t0: int, t1: int, site: str) -> None:
    target = LOCAL.target
    shared = target is None
    if shared:
        target = UNCHARGED
    rec = (t0, t1, site, nbytes) if recording() else None
    with _lock:  # qlint: ignore[trace-purity] the counters' adds, after the read returned: the launches queued before it are done
        for r in ((TALLY, target) if shared else (TALLY,)):
            _add(r, nbytes, t0, t1, rec)
    if not shared:
        # one operator, task or statement target is charged from one
        # thread at a time
        _add(target, nbytes, t0, t1, rec)


def _add(r, nbytes, t0, t1, rec) -> None:
    r.d2h_reads += 1
    r.d2h_bytes += nbytes
    r.d2h_wait_ns += t1 - t0
    if rec is not None:
        if r.read_spans is None:
            r.read_spans = []
        r.read_spans.append(rec)


def to_cpu(t: torch.Tensor, site: str) -> torch.Tensor:
    """``t`` as a CPU tensor."""
    if not _on_device(t):
        return t.cpu()  # qlint: ignore[recompile] the helper's own read: a caller's call of it is the finding, where it is made
    t0 = time.perf_counter_ns()
    out = t.cpu()  # qlint: ignore[recompile] the helper's own read (above)
    _charge(t.numel() * t.element_size(), t0, time.perf_counter_ns(),
            site)
    return out


def to_host(t: torch.Tensor, site: str) -> np.ndarray:
    """``t`` as a numpy array."""
    return to_cpu(t, site).numpy()


def host_scalar(t: torch.Tensor, site: str):
    """The Python number of a one-element tensor."""
    if not _on_device(t):
        return t.item()  # qlint: ignore[recompile] the helper's own read (to_cpu)
    t0 = time.perf_counter_ns()
    out = t.item()  # qlint: ignore[recompile] the helper's own read (to_cpu)
    _charge(t.element_size(), t0, time.perf_counter_ns(), site)
    return out


class charging:
    """Context manager: reads on this thread outside an operator's call
    are charged to ``target`` (a statement's counters)."""

    __slots__ = ("target", "prev")

    def __init__(self, target):
        self.target = target

    def __enter__(self):
        self.prev = LOCAL.target
        LOCAL.target = self.target
        return self.target

    def __exit__(self, *exc):
        LOCAL.target = self.prev
        return False


def charged(gen: Iterator, target) -> Iterator:
    """Steps ``gen`` (a task on the task executor, whose quanta may run
    on any of its threads), charging each quantum's reads outside an
    operator's call to ``target``."""
    try:
        while True:
            prev = LOCAL.target
            LOCAL.target = target
            try:
                item = next(gen)
            except StopIteration:
                return
            finally:
                LOCAL.target = prev
            yield item
    finally:
        gen.close()


def totals() -> tuple:
    """(reads, bytes, wait ns) of every read of the process."""
    with _lock:
        return TALLY.d2h_reads, TALLY.d2h_bytes, TALLY.d2h_wait_ns


def reset() -> None:
    """Zero the process-wide counters (tests)."""
    with _lock:
        for r in (TALLY, UNCHARGED):
            r.__init__()
