"""Program profiler: per-program calls, device time, bytes and operations.

The counterpart of the JAX engine's ``trino_tpu/telemetry/profiler.py``,
with its API (``enabled``, ``enable``, ``profiling``, ``instrument``,
``snapshot``, ``totals``, ``thread_totals``, ``reset``,
``device_memory_stats``, ``profile_document``, ``validate_profile``,
``diff_profiles``) and its entry fields, keyed the same way: one entry
per (program name, owner key, signature), where the signature is the
shapes and dtypes of the tensor arguments and the values of the static
ones (``jit_stats.signature``). The program names are the JAX engine's,
so one query's profile diffs by name across the two engines.

What each field means here:

- ``compiles``: 1 for the entry's first call (the first call of the
  program at that signature while profiling). A repeat run at the same
  shapes adds no entry — EXPLAIN ANALYZE VERBOSE's "0 new".
- ``execute_ms``: the call's event span. For CUDA arguments a pair of
  ``torch.cuda.Event(enable_timing=True)`` is recorded on the current
  stream around the call and read only at a boundary — the end of an
  operator call under profiling (``thread_totals`` /
  ``thread_device_ms``) or ``snapshot``/``totals`` — never per call.
  The span is the time on the device's clock from the first event to
  the second: the call's device time while the device runs behind the
  host, but when the stream is idle as the call begins it also holds
  the device's idle time while the host enqueues the call's work, up to
  the call's whole host time. EXPLAIN ANALYZE VERBOSE, the
  ``execute_ms`` column of ``system.runtime.kernels`` and
  ``trino_profiler_seconds_total`` show this span under the JAX
  engine's names. The kernel entry brackets the library call alone
  (its outputs are allocated before it), so its span exceeds its
  kernels' own time only by the host's gaps between their launches.
  On the CPU, the host clock around the call.
- ``bytes_accessed``: each tensor argument read once plus each tensor
  result written once, per call (the mean over the entry's calls).
- ``flops``: operations per call, from the ``flops`` counter the
  instrument site passes. Only the kernel entry has one: one operation
  per state column per row, the count ``chip_smoke.py`` bounds the
  kernel with. A torch program's operations are whatever PyTorch's
  kernels do, which nothing here counts, so it reports 0.
- ``trace_ms``, ``compile_ms``: 0 for torch programs (no trace, no
  compile). The kernel entry's ``compile_ms`` is its library's ``nvcc``
  build and ``ctypes`` load, charged once per process to the first
  entry of the kernel.
- ``argument_bytes`` / ``output_bytes``: the last call's; ``temp_bytes``
  and ``code_bytes`` are not measured (0).

Switch: off (the default), a profiled function is one attribute check
and a plain call of its counted program (``jit_stats``): no event, no
synchronise, nothing recorded. Nesting: a program called inside another
profiled program's call is part of that program and is not recorded,
as a JAX program called inside another's trace is staged out inline —
except the kernel entry (``kernel=True``), which records every launch,
so its calls equal the kernel's launch count. Device time sums over
outer calls only (``totals()["outer_execute_ms"]``), so a kernel inside
a program is not counted twice.

Attribution: every recorded call folds its bytes and operations (and
on a new entry, its compile wall) into THREAD-local accumulators; the
driver snapshots deltas around operator calls exactly like the
``jit_stats`` counters, so EXPLAIN ANALYZE VERBOSE renders per-operator
operations / bytes / compile ms / device ms and the programs each
operator ran.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from ..jit_stats import CountedProgram

__all__ = [
    "enabled", "enable", "profiling", "instrument", "snapshot",
    "totals", "thread_totals", "thread_device_ms", "thread_programs",
    "reset", "device_memory_stats", "diff_profiles", "validate_profile",
    "profile_document", "ProfiledFunction",
]


class _State:
    """Module-global switch + registry. A single object so the hot-path
    check is one attribute load.  ``enabled`` is derived state:
    ``sticky`` (manual enable()) OR ``depth`` > 0 (active profiling()
    scopes, REFCOUNTED — a concurrent scope exiting must not clobber
    another scope still running on a different thread)."""

    __slots__ = ("enabled", "sticky", "depth", "lock", "entries",
                 "max_entries", "dropped", "pending", "device_ms",
                 "outer_ms")

    def __init__(self):
        self.enabled = False
        self.sticky = False
        self.depth = 0
        self.lock = threading.Lock()
        #: (name, key_extra, sig) -> _Entry
        self.entries: Dict[tuple, "_Entry"] = {}
        self.max_entries = 4096
        self.dropped = 0
        #: CUDA event pairs not read yet:
        #: (thread ident, entry, start, end, outer call)
        self.pending: List[tuple] = []
        #: thread ident -> device ms of that thread's outer calls
        self.device_ms: Dict[int, float] = {}
        #: device ms of every outer call, all threads
        self.outer_ms = 0.0


_STATE = _State()
_tls = threading.local()


class _Entry:
    """One program at one signature and the costs recorded for it."""

    __slots__ = ("name", "key_repr", "compiles", "calls", "trace_ms",
                 "compile_ms", "execute_ms", "flops_sum", "bytes_sum",
                 "output_bytes", "argument_bytes", "fallbacks")

    def __init__(self, name: str, key_repr: str):
        self.name = name
        self.key_repr = key_repr
        self.compiles = 1
        self.calls = 0
        self.trace_ms = 0.0
        self.compile_ms = 0.0
        self.execute_ms = 0.0
        self.flops_sum = 0.0
        self.bytes_sum = 0.0
        self.output_bytes = 0
        self.argument_bytes = 0
        self.fallbacks = 0

    def to_dict(self) -> dict:
        calls = max(self.calls, 1)
        return {
            "name": self.name, "key": self.key_repr,
            "compiles": self.compiles, "calls": self.calls,
            "trace_ms": round(self.trace_ms, 3),
            "compile_ms": round(self.compile_ms, 3),
            "execute_ms": round(self.execute_ms, 3),
            "flops": self.flops_sum / calls,
            "bytes_accessed": self.bytes_sum / calls,
            "output_bytes": self.output_bytes,
            "temp_bytes": 0,
            "argument_bytes": self.argument_bytes,
            "code_bytes": 0,
            "fallbacks": self.fallbacks,
        }


# -- switch ----------------------------------------------------------------


def enabled() -> bool:
    return _STATE.enabled


def enable(on: bool = True):
    """Manual (sticky) switch: enable() keeps the profiler on until
    enable(False), independent of any profiling() scopes in flight."""
    with _STATE.lock:
        _STATE.sticky = bool(on)
        _STATE.enabled = _STATE.sticky or _STATE.depth > 0


class profiling:
    """Context manager enabling the profiler for a scope (EXPLAIN
    ANALYZE VERBOSE, ``query_profiling_enabled``).  Scopes REFCOUNT:
    concurrent queries on different threads each hold a count, and the
    profiler only switches off when the last scope exits (a plain
    query's no-op scope can never clobber a profiled neighbor)."""

    def __init__(self, on: bool = True):
        self.on = bool(on)

    def __enter__(self):
        if self.on:
            with _STATE.lock:
                _STATE.depth += 1
                _STATE.enabled = True
        return self

    def __exit__(self, *exc):
        if self.on:
            with _STATE.lock:
                _STATE.depth = max(0, _STATE.depth - 1)
                _STATE.enabled = _STATE.sticky or _STATE.depth > 0
        return False


def reset():
    """Drop every registry entry, the unread events and the thread
    accumulators (tests). Programs' seen signatures (``jit_stats``) are
    untouched."""
    with _STATE.lock:
        _STATE.entries.clear()
        _STATE.dropped = 0
        _STATE.sticky = False
        _STATE.depth = 0
        _STATE.enabled = False
        _STATE.pending.clear()
        _STATE.device_ms.clear()
        _STATE.outer_ms = 0.0
    for k in ("flops", "bytes", "compile_ms", "compiles"):
        setattr(_tls, k, 0.0)
    _tls.programs = []


# -- thread attribution ----------------------------------------------------


def thread_totals() -> Tuple[float, float, float, int]:
    """(flops, bytes_accessed, compile_ms, compiles) accumulated by
    profiled calls on THIS thread — the Driver snapshots deltas around
    operator calls to attribute program costs per operator (same
    mechanism as jit_stats.thread_total)."""
    return (getattr(_tls, "flops", 0.0), getattr(_tls, "bytes", 0.0),
            getattr(_tls, "compile_ms", 0.0),
            int(getattr(_tls, "compiles", 0)))


def thread_device_ms() -> float:
    """Device ms of THIS thread's outer profiled calls. While profiling,
    reads the thread's pending CUDA events first (a synchronise on the
    last one) — the operator-boundary read the driver makes."""
    ident = threading.get_ident()
    if _STATE.enabled:
        _resolve(ident)
    with _STATE.lock:
        return _STATE.device_ms.get(ident, 0.0)


def thread_programs() -> List[str]:
    """Names of the programs THIS thread's recorded calls ran since the
    last call, in order; the list is handed over and emptied."""
    out = getattr(_tls, "programs", None) or []
    _tls.programs = []
    return out


def _tls_add(flops: float, bytes_: float, compile_ms: float,
             compiles: int, name: str):
    _tls.flops = getattr(_tls, "flops", 0.0) + flops
    _tls.bytes = getattr(_tls, "bytes", 0.0) + bytes_
    _tls.compile_ms = getattr(_tls, "compile_ms", 0.0) + compile_ms
    _tls.compiles = int(getattr(_tls, "compiles", 0)) + compiles
    programs = getattr(_tls, "programs", None)
    if programs is None:
        programs = _tls.programs = []
    if len(programs) < 4096:  # bounded when no driver hands it over
        programs.append(name)


def _resolve(ident: Optional[int] = None):
    """Read the pending CUDA event pairs (of thread ``ident``, or all):
    each end event is waited for, then its elapsed time is folded into
    its entry and, for an outer call, into its thread's device ms."""
    with _STATE.lock:
        if ident is None:
            todo, _STATE.pending = _STATE.pending, []
        else:
            todo = [p for p in _STATE.pending if p[0] == ident]
            if not todo:
                return
            _STATE.pending = [p for p in _STATE.pending if p[0] != ident]
    for tid, entry, start, end, outer in todo:
        end.synchronize()
        ms = start.elapsed_time(end)
        with _STATE.lock:
            entry.execute_ms += ms
            if outer:
                _STATE.device_ms[tid] = _STATE.device_ms.get(tid, 0.0) + ms
                _STATE.outer_ms += ms


# -- the wrapper -----------------------------------------------------------


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    return 0


def _any_cuda(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, (list, tuple)):
        return any(_any_cuda(v) for v in x)
    if isinstance(x, dict):
        return any(_any_cuda(v) for v in x.values())
    return False


class ProfiledFunction:
    """Callable wrapper around one named torch program (see the module
    docstring). ``key`` scopes the registry entries — per-instance
    programs (PageProcessor) pass their own cache key so same-shaped
    but different programs never alias."""

    __slots__ = ("name", "program", "key_extra", "flops_fn", "kernel",
                 "compile_ms_fn")

    def __init__(self, name: str, fn, key=None,
                 static_argnames: Tuple[str, ...] = (), flops=None,
                 kernel: bool = False, compile_ms=None, signature=None):
        self.name = name
        self.program = CountedProgram(name, fn, tuple(static_argnames),
                                      signature)
        self.key_extra = key
        self.flops_fn = flops
        self.kernel = kernel
        self.compile_ms_fn = compile_ms

    # the disabled path must stay as close to a bare call as python
    # allows: one global attribute load, then the counted program
    def __call__(self, *args, **kwargs):
        if not _STATE.enabled:
            return self.program(*args, **kwargs)
        return self._profiled_call(args, kwargs)

    def _profiled_call(self, args, kwargs):
        prog = self.program
        try:
            sig = prog.signature(args, kwargs)
        except TypeError:
            return prog(*args, **kwargs)  # unhashable static: plain path
        prog.note(sig)
        depth = getattr(_tls, "depth", 0)
        if depth and not self.kernel:
            # inside another profiled program's call: part of it
            return prog.fn(*args, **kwargs)
        key = (self.name, self.key_extra, sig)
        st = _STATE
        with st.lock:
            entry = st.entries.get(key)
        cuda = _any_cuda(args) or _any_cuda(kwargs)
        _tls.depth = depth + 1
        try:
            if cuda:
                stream = torch.cuda.current_stream()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(stream)
                out = prog.fn(*args, **kwargs)
                end.record(stream)
            else:
                t0 = time.perf_counter()
                out = prog.fn(*args, **kwargs)
                host_ms = (time.perf_counter() - t0) * 1e3
        finally:
            _tls.depth = depth
        arg_bytes = _nbytes(args) + _nbytes(kwargs)
        out_bytes = _nbytes(out)
        flops = float(self.flops_fn(*args, **kwargs)) \
            if self.flops_fn is not None else 0.0
        compile_ms, compiles = 0.0, 0
        if entry is None:
            entry, compile_ms, compiles = self._new_entry(key, sig)
            if entry is None:
                return out  # registry full: counted in ``dropped``
        outer = depth == 0
        with st.lock:
            entry.calls += 1
            entry.flops_sum += flops
            entry.bytes_sum += arg_bytes + out_bytes
            entry.argument_bytes = arg_bytes
            entry.output_bytes = out_bytes
            if cuda:
                st.pending.append((threading.get_ident(), entry, start,
                                   end, outer))
            else:
                entry.execute_ms += host_ms
                if outer:
                    ident = threading.get_ident()
                    st.device_ms[ident] = st.device_ms.get(ident, 0.0) \
                        + host_ms
                    st.outer_ms += host_ms
        _tls_add(flops, arg_bytes + out_bytes, compile_ms, compiles,
                 self.name)
        return out

    def _new_entry(self, key, sig):
        """Registry miss: a new entry, charged the kernel library's
        build wall when this is the kernel's first entry in the
        process. A concurrent duplicate loses the store race and merges
        into the winner."""
        st = _STATE
        entry = _Entry(self.name, _short_repr((self.key_extra, sig)))
        if self.compile_ms_fn is not None:
            entry.compile_ms = float(self.compile_ms_fn())
        with st.lock:
            cur = st.entries.get(key)
            if cur is not None:
                cur.compile_ms += entry.compile_ms
                return cur, entry.compile_ms, 0
            if len(st.entries) >= st.max_entries:
                st.dropped += 1
                return None, 0.0, 0
            st.entries[key] = entry
        return entry, entry.compile_ms, 1


def _short_repr(obj, limit: int = 160) -> str:
    r = repr(obj)
    return r if len(r) <= limit else r[:limit - 3] + "..."


def instrument(name: str, fn, key=None,
               static_argnames: Tuple[str, ...] = (), flops=None,
               kernel: bool = False, compile_ms=None,
               signature=None) -> ProfiledFunction:
    """Wrap one torch program for the registry. ``name`` is the JAX
    engine's program name; ``key`` is the owning cache's key (processor
    IR key) for per-instance programs; ``static_argnames`` are the
    arguments whose VALUES shape the program; ``flops(*args, **kwargs)``
    counts a call's operations; ``kernel`` marks the hand-written
    kernel's launch entry (recorded even when nested);
    ``compile_ms()`` returns the build wall to charge its first
    entry; ``signature(*args, **kwargs)``, a hashable key standing for
    the arguments' shapes and static values, replaces tokenizing every
    argument on each call (see ``jit_stats.CountedProgram``)."""
    return ProfiledFunction(name, fn, key=key,
                            static_argnames=tuple(static_argnames),
                            flops=flops, kernel=kernel,
                            compile_ms=compile_ms, signature=signature)


# -- reporting -------------------------------------------------------------


def snapshot() -> List[dict]:
    """Every registry entry as a JSON-able dict, stable order (by name,
    then key) — the system.runtime.kernels rows. Reads every pending
    CUDA event first."""
    _resolve()
    with _STATE.lock:
        entries = list(_STATE.entries.values())
    return sorted((e.to_dict() for e in entries),
                  key=lambda d: (d["name"], d["key"]))


def totals() -> dict:
    """Aggregate view: program count + summed compile/trace/cost, and
    ``outer_execute_ms``, the device ms of outer calls only (the sum of
    ``execute_ms`` counts a nested kernel launch twice). Reads every
    pending CUDA event first."""
    _resolve()
    out = {"programs": 0, "compiles": 0, "calls": 0, "trace_ms": 0.0,
           "compile_ms": 0.0, "execute_ms": 0.0, "flops": 0.0,
           "bytes_accessed": 0.0, "fallbacks": 0}
    with _STATE.lock:
        for e in _STATE.entries.values():
            out["programs"] += 1
            out["compiles"] += e.compiles
            out["calls"] += e.calls
            out["trace_ms"] += e.trace_ms
            out["compile_ms"] += e.compile_ms
            out["execute_ms"] += e.execute_ms
            out["flops"] += e.flops_sum
            out["bytes_accessed"] += e.bytes_sum
            out["fallbacks"] += e.fallbacks
        out["outer_execute_ms"] = _STATE.outer_ms
    for k in ("trace_ms", "compile_ms", "execute_ms", "outer_execute_ms"):
        out[k] = round(out[k], 3)
    return out


def device_memory_stats() -> Optional[dict]:
    """Live/peak/total device memory summed over the CUDA devices, or
    None where there is none in use (no GPU, or CUDA never initialized
    in this process — the CPU path, where the JAX engine reports None
    too). Live and peak are PyTorch's allocator counters; the limit is
    the card's total memory."""
    try:
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return None
        live = peak = limit = 0
        for i in range(torch.cuda.device_count()):
            ms = torch.cuda.memory_stats(i)
            live += int(ms.get("allocated_bytes.all.current", 0) or 0)
            peak += int(ms.get("allocated_bytes.all.peak", 0) or 0)
            limit += int(torch.cuda.mem_get_info(i)[1])
        return {"live_bytes": live, "peak_bytes": peak,
                "limit_bytes": limit}
    except RuntimeError:
        return None


# -- flight recorder -------------------------------------------------------


def profile_document(role: str, extra: Optional[dict] = None,
                     kernels: Optional[List[dict]] = None,
                     table_totals: Optional[dict] = None) -> dict:
    """A profile artifact body: per-program table + totals + provenance
    (``backend`` is ``cuda`` with the card's name in ``device`` once the
    process uses a GPU, else ``cpu``)."""
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    doc = {
        "version": 1,
        "role": role,
        "backend": "cuda" if cuda else "cpu",
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "kernels": snapshot() if kernels is None else kernels,
        "totals": totals() if table_totals is None else table_totals,
    }
    if extra:
        doc.update(extra)
    return doc


def validate_profile(doc: dict) -> List[str]:
    """Problems that make a profile artifact unusable (empty table, no
    entry or call recorded, malformed rows). Unlike the JAX engine's, a
    zero compile wall is no problem: torch programs compile nothing."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return ["artifact is not a JSON object"]
    kernels = doc.get("kernels")
    if not kernels:
        problems.append("empty kernel table (profiler never engaged?)")
        return problems
    required = ("name", "compiles", "compile_ms", "flops",
                "bytes_accessed")
    for i, row in enumerate(kernels):
        for f in required:
            if f not in row:
                problems.append(f"kernel[{i}] missing field {f!r}")
                break
    tot = doc.get("totals") or {}
    if not tot.get("compiles"):
        problems.append("totals.compiles == 0: disconnected profile")
    if not tot.get("calls"):
        problems.append("totals.calls == 0: no program call recorded")
    return problems


def _by_name(doc: dict) -> Dict[str, dict]:
    agg: Dict[str, dict] = {}
    for row in doc.get("kernels") or ():
        a = agg.setdefault(row["name"], {
            "compiles": 0, "calls": 0, "compile_ms": 0.0,
            "trace_ms": 0.0, "flops": 0.0, "bytes_accessed": 0.0,
            "programs": 0})
        a["programs"] += 1
        a["compiles"] += row.get("compiles", 0)
        a["calls"] += row.get("calls", 0)
        a["compile_ms"] += row.get("compile_ms", 0.0)
        a["trace_ms"] += row.get("trace_ms", 0.0)
        a["flops"] += row.get("flops", 0.0)
        a["bytes_accessed"] += row.get("bytes_accessed", 0.0)
    return agg


def diff_profiles(old: dict, new: dict, cost_ratio: float = 1.5,
                  compile_ratio: float = 2.0) -> List[dict]:
    """Name the programs that MOVED between two profile artifacts:
    new/vanished programs, extra entries (a shape started changing),
    and per-program flops/bytes/compile growth past the ratios.  Sorted
    worst-first by compile growth then cost growth."""
    a, b = _by_name(old), _by_name(new)
    moved: List[dict] = []
    for name in sorted(set(a) | set(b)):
        oa, nb = a.get(name), b.get(name)
        if oa is None:
            moved.append({"kernel": name, "change": "new-kernel",
                          "detail": f"{nb['programs']} program(s), "
                                    f"{nb['compile_ms']:.1f}ms compile"})
            continue
        if nb is None:
            moved.append({"kernel": name, "change": "vanished"})
            continue
        if nb["programs"] > oa["programs"]:
            moved.append({
                "kernel": name, "change": "recompiled",
                "detail": f"programs {oa['programs']} -> "
                          f"{nb['programs']} (new shape/cache key)"})
        for field, ratio in (("flops", cost_ratio),
                             ("bytes_accessed", cost_ratio),
                             ("compile_ms", compile_ratio)):
            if oa[field] > 0 and nb[field] > oa[field] * ratio:
                moved.append({
                    "kernel": name, "change": f"{field}-grew",
                    "detail": f"{oa[field]:.6g} -> {nb[field]:.6g} "
                              f"({nb[field] / oa[field]:.2f}x)"})

    def rank(m):
        order = {"recompiled": 0, "compile_ms-grew": 1, "flops-grew": 2,
                 "bytes_accessed-grew": 3, "new-kernel": 4,
                 "vanished": 5}
        return order.get(m["change"], 9)

    moved.sort(key=rank)
    return moved
