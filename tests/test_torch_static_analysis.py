"""qlint for the torch engine: per-pass fixture snippets, one known-bad
and one known-good each, so no pass of ``trino_tpu_torch.analysis`` can
go blind. Each case is the counterpart of one in
``tests/test_static_analysis.py`` (the JAX engine's analyzer), written in
the port's idiom: ``instrument("k", fn)`` registers a device program
where the JAX engine's fixtures stage one with ``jax.jit``, and a host
read of a tensor (``.item()``, ``if t.any():``) stands where they branch
on a tracer. The gate over ``trino_tpu_torch/`` itself and the CLI are
in ``test_torch_static_analysis_gate.py``.

The analyzer is pure stdlib ``ast``: these tests import neither torch
nor JAX for it.
"""

import textwrap

import pytest

from trino_tpu_torch.analysis import (PASSES, ProjectIndex, apply_baseline,
                                      run_passes)


def index_of(**sources):
    """Fixture index from {module_name: dedented source}."""
    return ProjectIndex.from_sources(
        {name: textwrap.dedent(src) for name, src in sources.items()})


def rules(findings):
    return {(f.pass_id, f.rule) for f in findings}


# -- trace-purity --------------------------------------------------------

def test_trace_purity_catches_lock_and_io_inside_program():
    idx = index_of(**{"pkg.kern": """
        import threading
        from ..telemetry.profiler import instrument

        _lock = threading.Lock()

        def kernel(x, n):
            with _lock:
                return helper(x)

        def helper(x):
            with open("/tmp/trace") as f:
                f.write(str(x))
            return x

        kernel = instrument("kernel", kernel, static_argnames=("n",))
    """})
    found = run_passes(idx, ["trace-purity"])
    assert ("trace-purity", "lock-in-program") in rules(found)
    # interprocedural: helper's open() reached through the call graph
    assert ("trace-purity", "host-io") in rules(found)
    assert any(f.qualname == "helper" for f in found)


def test_trace_purity_builder_return_entry_and_lock():
    """A program handed over as a builder's return value resolves one
    hop, to the nested def (the ``mesh_query`` / ``device_exchange``
    builder idiom)."""
    idx = index_of(**{"pkg.build": """
        import subprocess, threading
        from ..telemetry.profiler import instrument

        _lock = threading.Lock()

        def build():
            def staged(x):
                _lock.acquire()
                subprocess.run(["true"])
                return x
            return staged

        prog = instrument("staged", build())
    """})
    found = run_passes(idx, ["trace-purity"])
    got = rules(found)
    assert ("trace-purity", "lock-in-program") in got
    assert ("trace-purity", "host-io") in got
    assert all(f.qualname == "build.staged" for f in found)


def test_trace_purity_clean_program_and_allowlisted_records():
    """Effects whose hazard does not survive eager execution (print,
    time, spans), ``jit_stats.bump`` and the kernel's pragma'd records
    are not findings; a pragma'd call is not walked into (the kernel's
    load-once build); host effects outside every program are not this
    pass's business."""
    idx = index_of(**{
        "pkg.ops.kernels": """
            import threading
            import time
            import torch
            from .. import jit_stats
            from ..telemetry.profiler import instrument

            _count_lock = threading.Lock()

            def _library():
                with open("/tmp/lib.so", "rb") as f:
                    return f.read()

            def _run(x):
                jit_stats.bump("kernel")
                _library()  # qlint: ignore[trace-purity] load-once build
                print("launch", time.perf_counter())
                with _count_lock:  # qlint: ignore[trace-purity] the counter
                    pass
                return torch.sum(x * 2)

            _run = instrument("kernel", _run, kernel=True)

            def host_side():
                with open("/tmp/x") as f:
                    return f.read()
        """})
    assert run_passes(idx, ["trace-purity"]) == []


def test_trace_purity_walks_into_unpragmad_kernel_records():
    """Without their pragmas the same records are findings: the lock at
    its line, and the build's IO through the unpragma'd call."""
    idx = index_of(**{
        "pkg.ops.kernels": """
            import threading
            import torch
            from ..telemetry.profiler import instrument

            _count_lock = threading.Lock()

            def _library():
                with open("/tmp/lib.so", "rb") as f:
                    return f.read()

            def _run(x):
                _library()
                with _count_lock:
                    pass
                return torch.sum(x * 2)

            _run = instrument("kernel", _run, kernel=True)
        """})
    found = run_passes(idx, ["trace-purity"])
    assert {(f.rule, f.qualname) for f in found} == {
        ("host-io", "_library"), ("lock-in-program", "_run")}


def test_trace_purity_sees_through_package_init_reexports():
    """A helper re-exported through a package __init__ must stay on
    the call graph: package-__init__ relative imports resolve against
    the package itself, not its parent."""
    idx = ProjectIndex.from_sources({
        "pkg.tel": textwrap.dedent("""
            from ..telemetry.profiler import instrument
            from .inner import io_helper

            def kernel(x):
                return io_helper(x)

            kernel = instrument("kernel", kernel)
        """),
        "pkg.tel.inner": textwrap.dedent("""
            import os

            def io_helper(x):
                os.makedirs("/tmp/out")
                return x
        """),
    }, packages=("pkg.tel",))
    found = run_passes(idx, ["trace-purity"])
    assert ("trace-purity", "host-io") in rules(found)


def test_bare_call_in_method_binds_module_level_not_sibling_method():
    """Python scoping: `helper()` inside C.m is the module-level
    helper, never the sibling method — a misresolution here fabricates
    false lock cycles / masks real host effects. The bound method is
    registered the PageProcessor way (``instrument(..., self._run)``)."""
    idx = index_of(**{"pkg.m": """
        from ..telemetry.profiler import instrument

        def helper(x):
            open("/tmp/x")
            return x

        class C:
            def __init__(self):
                self._prog = instrument("m", self.m)

            def m(self, x):
                return helper(x)

            def helper(self, x):
                return x
    """})
    found = run_passes(idx, ["trace-purity"])
    assert [f.qualname for f in found] == ["helper"]
    assert found[0].rule == "host-io"


def test_trace_purity_pragma_opt_out():
    idx = index_of(**{"pkg.cfg": """
        import os
        from ..telemetry.profiler import instrument

        def kernel(x):
            mode = os.environ.get("MODE", "")  # qlint: ignore[trace-purity] process-static knob
            return x

        kernel = instrument("kernel", kernel)
    """})
    assert run_passes(idx, ["trace-purity"]) == []


def test_trace_purity_rng_stats_write_and_param_store():
    """The effects the port keeps beside locks and IO: the global RNGs
    (explicit generators are the rule), a history-store write, and a
    subscript store into a program's argument."""
    idx = index_of(**{"pkg.m": """
        import random
        import numpy as np
        import torch
        from ..telemetry.profiler import instrument

        def kernel(x, store):
            jitter = random.random() + np.random.rand()
            noise = torch.rand(4)
            store.record_actuals(x)
            x[0] = jitter
            return x + noise

        kernel = instrument("kernel", kernel)

        def seeded(x, gen):
            rng = np.random.default_rng(7)
            return x + torch.rand(4, generator=gen) + rng.random()

        seeded = instrument("seeded", seeded)
    """})
    found = run_passes(idx, ["trace-purity"])
    by_rule = {}
    for f in found:
        by_rule.setdefault(f.rule, []).append(f)
    assert sorted(f.subject for f in by_rule["host-rng"]) == [
        "np.random.rand", "random.random", "torch.rand"]
    assert [f.qualname for f in by_rule["stats-store-write"]] == ["kernel"]
    assert [f.subject for f in by_rule["host-mutation"]] == ["store:x"]
    assert not any(f.qualname == "seeded" for f in found)


def test_program_entries_cover_every_registration_form():
    """instrument() rebinds, bound methods, builder returns, facades
    (name and program forwarded), ``kernel=True`` (the pallas kind) and
    CountedProgram all register a program; static_argnames ride along."""
    from trino_tpu_torch.analysis.trace_purity import (profiled_entries,
                                                       program_entries,
                                                       program_reachable)
    idx = index_of(**{"pkg.m": """
        from ..telemetry.profiler import instrument
        from ..jit_stats import CountedProgram

        def plain(x, n):
            return helper(x)

        def helper(x):
            return x

        plain = instrument("plain", plain, static_argnames=("n",))

        def _run(x):
            return x

        _run = instrument("kernel", _run, kernel=True)

        def _batched(name, fn):
            return instrument(name, fn)

        def lane(x):
            return x

        lane_prog = _batched("batched_lane", lane)

        def counted(x, k):
            return x

        counted_prog = CountedProgram("counted", counted, ("k",))
    """})
    entries = program_entries(idx)
    assert sorted(entries) == ["pkg.m:_run", "pkg.m:counted",
                               "pkg.m:lane", "pkg.m:plain"]
    assert entries["pkg.m:_run"].kind == "pallas"
    assert entries["pkg.m:plain"].kind == "program"
    assert entries["pkg.m:plain"].static_params == {"n"}
    assert entries["pkg.m:counted"].static_params == {"k"}
    assert "pkg.m:helper" in program_reachable(idx)
    assert sorted(profiled_entries(idx)) == ["batched_lane", "kernel",
                                             "plain"]


# -- lock-order ----------------------------------------------------------

AB_BA = """
    import threading

    class Ledger:
        def __init__(self):
            self._lock = threading.Lock()

        def demote(self, pool: "Pool"):
            with self._lock:
                pool.reserve()

        def park(self):
            with self._lock:
                pass

    class Pool:
        def __init__(self):
            self._lock = threading.Lock()

        def reserve(self):
            with self._lock:
                pass

        def revoke(self, ledger: Ledger):
            with self._lock:
                ledger.park()
"""


def test_lock_order_catches_seeded_ab_ba_cycle():
    idx = index_of(**{"pkg.spill": AB_BA})
    found = run_passes(idx, ["lock-order"])
    cycles = [f for f in found if f.rule == "lock-cycle"]
    assert len(cycles) == 1
    assert "Ledger._lock" in cycles[0].message
    assert "Pool._lock" in cycles[0].message


def test_lock_order_consistent_order_is_clean():
    # same two locks, always acquired Ledger -> Pool: no cycle
    idx = index_of(**{"pkg.spill": """
        import threading

        class Ledger:
            def __init__(self):
                self._lock = threading.Lock()

            def demote(self, pool: "Pool"):
                with self._lock:
                    pool.reserve()

        class Pool:
            def __init__(self):
                self._lock = threading.Lock()

            def reserve(self):
                with self._lock:
                    pass
    """})
    assert run_passes(idx, ["lock-order"]) == []


def test_lock_order_nonblocking_acquire_breaks_no_cycle():
    # the demote_across pattern: the back-edge uses
    # acquire(blocking=False), which cannot deadlock
    idx = index_of(**{"pkg.spill": AB_BA.replace(
        "ledger.park()",
        "ledger._lock.acquire(blocking=False)")})
    found = run_passes(idx, ["lock-order"])
    assert [f for f in found if f.rule == "lock-cycle"] == []


def test_lock_order_self_deadlock_and_rlock_exemption():
    idx = index_of(**{"pkg.locks": """
        import threading

        class A:
            def __init__(self):
                self._lock = threading.Lock()

            def outer(self):
                with self._lock:
                    self.inner()

            def inner(self):
                with self._lock:
                    pass

        class B:
            def __init__(self):
                self._lock = threading.RLock()

            def outer(self):
                with self._lock:
                    with self._lock:
                        pass
    """})
    found = run_passes(idx, ["lock-order"])
    subs = {f.subject for f in found if f.rule == "self-deadlock"}
    assert "self:pkg.locks.A._lock" in subs          # Lock: deadlock
    assert not any("B._lock" in s for s in subs)     # RLock: reentrant


def test_lock_order_rpc_under_lock():
    idx = index_of(**{"pkg.srv": """
        import threading, subprocess

        _lock = threading.Lock()

        def ship(frames):
            with _lock:
                subprocess.run(["scp", "x"])
    """})
    found = run_passes(idx, ["lock-order"])
    assert ("lock-order", "lock-over-rpc") in rules(found)


# -- recompile -----------------------------------------------------------

def test_recompile_unhashable_arg():
    idx = index_of(**{"pkg.exch": """
        from functools import lru_cache

        @lru_cache(maxsize=8)
        def build_program(mesh, opts):
            return (mesh, opts)

        def run(mesh):
            return build_program(mesh, {"sizing": "exact"})
    """})
    found = run_passes(idx, ["recompile"])
    assert ("recompile", "unhashable-arg") in rules(found)


def test_recompile_host_sync_on_item_any_and_branch():
    """The counterpart of the JAX engine's traced-branch case: inside an
    instrument'd function, `.item()`, `bool(t.any())` and `if t:` each
    wait for the card; `.shape` and a static argument do not."""
    idx = index_of(**{"pkg.kern": """
        import torch
        from ..telemetry.profiler import instrument

        def kernel(t, exact):
            if exact:                    # static: fine
                pass
            if t.shape[0] > 128:         # shapes are host values
                pass
            n = t.sum().item()
            if bool(t.any()):
                pass
            if t:
                return t
            return -t

        kernel = instrument("kernel", kernel, static_argnames=("exact",))
    """})
    found = [f for f in run_passes(idx, ["recompile"])
             if f.rule == "host-sync"]
    assert sorted((f.line, f.subject) for f in found) == [
        (10, "sync:t.sum():0"), (11, "sync:t.any():0"), (13, "sync:t:0")]
    assert "`.item()`" in found[0].message
    assert "`bool()`" in found[1].message
    assert "`if`" in found[2].message


def test_recompile_host_sync_reaches_helpers_once_per_read():
    """Helpers a program reaches are checked too: a local bound from
    torch ops is a tensor, a chain `t.cpu().numpy()` is ONE wait, and
    torch.cuda.synchronize is a wait; the same helper called from host
    code only is not."""
    idx = index_of(**{"pkg.kern": """
        import torch
        from ..telemetry.profiler import instrument

        def helper(x: torch.Tensor, n: int):
            active = ~(x > 0)
            while active.any():
                active = active & (x < n)
            if n > 4:                    # an int: fine
                pass
            arr = x.cpu().numpy()
            torch.cuda.synchronize()
            return arr

        def kernel(x):
            return helper(x, 3)

        kernel = instrument("kernel", kernel)

        def host_only(x: torch.Tensor):
            return x.cpu().numpy()
    """})
    found = [f for f in run_passes(idx, ["recompile"])
             if f.rule == "host-sync"]
    assert [(f.qualname, f.line) for f in found] == [
        ("helper", 7), ("helper", 11), ("helper", 12)]
    assert "reached from program kernel" in found[0].message


def test_recompile_host_sync_through_the_read_helper():
    """A call of the device-read helper on a tensor inside a program is
    the read, reported where it is made, with its tensor as the
    subject; the helper on host data is not a read."""
    idx = index_of(**{"pkg.kern": """
        import numpy as np
        from ..telemetry.device_reads import host_scalar, to_host
        from ..telemetry.profiler import instrument

        def kernel(t):
            if host_scalar(t.any(), "kern.any"):
                pass
            arr = to_host(t + 1, "kern.rows")
            host = np.asarray([1, 2])
            return arr, to_host(host, "kern.host")

        kernel = instrument("kernel", kernel)
    """})
    found = [f for f in run_passes(idx, ["recompile"])
             if f.rule == "host-sync"]
    assert sorted((f.line, f.subject) for f in found) == [
        (7, "sync:t.any():0"), (9, "sync:t + 1:0")]
    assert "`host_scalar()` of a tensor" in found[0].message


def test_recompile_static_accessors_are_clean():
    idx = index_of(**{"pkg.kern": """
        import numpy as np
        import torch
        from typing import Sequence
        from ..telemetry.profiler import instrument

        def kernel(x, lut, ops: Sequence[torch.Tensor], k: int):
            if x.shape[0] > 128:   # shapes are host values
                pass
            if len(x.shape) == 2 and x.dim() == 2:
                pass
            if lut is None:        # identity tests are host values
                return x
            if ops and k > 0:      # a list's truth is its length
                pass
            ranks = np.asarray([3, 1])
            if int(ranks.max()) > 2:   # numpy data is host data
                pass
            return x

        kernel = instrument("kernel", kernel)

        def run(mesh, key):
            return build(mesh, tuple(sorted(key)))
    """})
    assert run_passes(idx, ["recompile"]) == []


def test_recompile_host_sync_pragma_opt_out():
    idx = index_of(**{"pkg.kern": """
        from ..telemetry.profiler import instrument

        def kernel(t):
            return int(t.sum())  # qlint: ignore[recompile] sizes the output: read on the host by design

        kernel = instrument("kernel", kernel)
    """})
    assert run_passes(idx, ["recompile"]) == []


# -- session-props -------------------------------------------------------

SP_REG = """
    REGISTRY = {}

    def register(prop):
        REGISTRY[prop.name] = prop

    class SessionProperty:
        def __init__(self, name, type, default, description):
            self.name = name

    register(SessionProperty(
        "knob_used", "integer", 4, "read below"))
    register(SessionProperty(
        "knob_dead", "boolean", False, "never read"))
    register(SessionProperty(
        "knob_typo", "int", 0, "bad type vocab"))

    def value(session, name):
        return REGISTRY[name]

    def prop_value(props, name):
        return props.get(name)
"""


def test_session_props_dead_undeclared_and_bad_type():
    idx = index_of(**{
        "pkg.session_properties": SP_REG,
        "pkg.engine": """
            from . import session_properties as SP

            def plan(session):
                a = SP.value(session, "knob_used")
                b = SP.value(session, "knob_missing")
                return a, b
        """,
    })
    found = run_passes(idx, ["session-props"])
    by_rule = {}
    for f in found:
        by_rule.setdefault(f.rule, []).append(f)
    assert [f.subject for f in by_rule["dead-property"]] \
        == ["dead:knob_dead", "dead:knob_typo"]
    assert by_rule["undeclared-lookup"][0].subject \
        == "undeclared:knob_missing"
    assert by_rule["bad-type"][0].subject == "bad-type:knob_typo"


def test_session_props_every_declared_and_read_is_clean():
    idx = index_of(**{
        "pkg.session_properties": SP_REG.replace(
            '    register(SessionProperty(\n        "knob_dead"',
            '    _ = (lambda: None) or register(SessionProperty(\n'
            '        "knob_dead"').replace(
            '"knob_typo", "int"', '"knob_typo", "integer"'),
        "pkg.engine": """
            from . import session_properties as SP

            def plan(session):
                return (SP.value(session, "knob_used"),
                        SP.value(session, "knob_dead"),
                        SP.prop_value({}, "knob_typo"))
        """,
    })
    assert run_passes(idx, ["session-props"]) == []


# -- taxonomy ------------------------------------------------------------

def test_taxonomy_bare_raise_and_broad_swallow():
    idx = index_of(**{"pkg.parallel.worker": """
        def flush(resp):
            if not resp.get("ok"):
                raise RuntimeError("sink rejected")

        def loop():
            try:
                flush({})
            except Exception:
                pass
    """})
    found = run_passes(idx, ["taxonomy"])
    got = rules(found)
    assert ("taxonomy", "bare-raise") in got
    assert ("taxonomy", "broad-swallow") in got


def test_taxonomy_typed_raise_and_routed_handler_are_clean():
    idx = index_of(**{"pkg.parallel.worker": """
        from ..types import DeviceUnavailableError
        from .fault import RemoteTaskError, serialize_failure

        def flush(resp):
            if not resp.get("ok"):
                raise RemoteTaskError("sink rejected", "INTERNAL")

        def open_device(ok):
            if not ok:
                raise DeviceUnavailableError("no CUDA device")

        def loop(sock):
            try:
                flush({})
            except Exception as e:
                sock.send(serialize_failure(e))

        def reraise():
            try:
                flush({})
            except Exception:
                raise
    """})
    assert run_passes(idx, ["taxonomy"]) == []


def test_taxonomy_scoped_to_parallel_and_pragma():
    idx = index_of(**{
        # outside parallel/: not this pass's business
        "pkg.ops.sort": "def f():\n    raise RuntimeError('x')\n",
        # fault.py defines the vocabulary: exempt
        "pkg.parallel.fault": "def g():\n    raise RuntimeError('y')\n",
        "pkg.parallel.chaos": """
            def inject(task_id):
                raise RuntimeError(  # qlint: ignore[taxonomy] chaos-injected
                    f"injected failure for {task_id}")
        """,
    })
    assert run_passes(idx, ["taxonomy"]) == []


def test_taxonomy_covers_telemetry_and_cache():
    """telemetry/ and the serving cache are runtime paths too — an
    erased error type there silently disables a surface instead of
    reaching dispatch."""
    idx = index_of(**{
        "pkg.telemetry.metrics": """
            def scrape(fn):
                try:
                    return fn()
                except Exception:
                    return None
        """,
        "pkg.cache": """
            def lookup(key):
                raise RuntimeError("bad key")
        """,
        # fault.py-style exemption preserved
        "pkg.telemetry.fault": "def g():\n    raise RuntimeError('y')\n",
    })
    found = run_passes(idx, ["taxonomy"])
    assert ("taxonomy", "broad-swallow") in rules(found)
    assert ("taxonomy", "bare-raise") in rules(found)
    assert not any(f.module == "pkg.telemetry.fault" for f in found)


# -- blocked-protocol ----------------------------------------------------

def test_blocked_protocol_partial_channel_and_stale_token():
    idx = index_of(**{"pkg.chan": """
        class HalfChannel:
            def poll(self):
                return self._q.pop(0) if self._q else None

            def listen(self):
                return self._token

        class Source:
            def blocked_token(self):
                return self._chan.listen()   # no readiness re-check
    """})
    found = run_passes(idx, ["blocked-protocol"])
    got = rules(found)
    assert ("blocked-protocol", "channel-contract") in got
    assert ("blocked-protocol", "stale-token-park") in got
    contract = [f for f in found if f.rule == "channel-contract"]
    assert "at_end" in contract[0].message
    assert "has_page" in contract[0].message


def test_blocked_protocol_waker_under_lock():
    idx = index_of(**{"pkg.buf": """
        import threading

        class Buf:
            def __init__(self):
                self._lock = threading.Lock()
                self._listeners = []

            def enqueue(self, page):
                with self._lock:
                    self._pages.append(page)
                    for cb in self._listeners:
                        cb()      # fires under the state lock
    """})
    found = run_passes(idx, ["blocked-protocol"])
    assert ("blocked-protocol", "waker-under-lock") in rules(found)


def test_blocked_protocol_repo_idioms_are_clean():
    """The engine's own patterns pass: full quartet, snapshot-then-
    recheck blocked_token, collect-under-lock / fire-after-release."""
    idx = index_of(**{"pkg.ok": """
        import threading

        class Chan:
            def poll(self):
                return None

            def at_end(self):
                return True

            def has_page(self):
                return False

            def listen(self):
                return self._token

        class Source:
            def blocked_token(self):
                token = self._chan.listen()
                if self._chan.at_end() or self._chan.has_page():
                    return None
                return token

        class Buf:
            def __init__(self):
                self._lock = threading.Lock()
                self._listeners = []

            def _bump_locked(self):
                fired = list(self._listeners)
                self._listeners.clear()
                return fired

            def enqueue(self, page):
                with self._lock:
                    self._pages.append(page)
                    fired = self._bump_locked()
                for cb in fired:
                    cb()
    """})
    assert run_passes(idx, ["blocked-protocol"]) == []


# -- alias tracking (core) -----------------------------------------------

def test_alias_local_rebind_resolves_lock_identity():
    """`lk = self._lock; with lk:` would scope the lock to the function
    (invisible); alias expansion recovers the class identity, so the
    self-routed re-acquire is a caught deadlock."""
    idx = index_of(**{"pkg.locks": """
        import threading

        class A:
            def __init__(self):
                self._lock = threading.Lock()

            def outer(self):
                lk = self._lock
                with lk:
                    self.inner()

            def inner(self):
                with self._lock:
                    pass
    """})
    found = run_passes(idx, ["lock-order"])
    assert any(f.rule == "self-deadlock"
               and "pkg.locks.A._lock" in f.subject for f in found)


def test_alias_rebound_name_never_unifies():
    """A name bound twice is NOT a must-alias: no finding may be
    fabricated from it."""
    idx = index_of(**{"pkg.locks": """
        import threading

        class A:
            def __init__(self):
                self._lock = threading.Lock()
                self._other = threading.RLock()

            def outer(self):
                lk = self._lock
                lk = self._other
                with lk:
                    self.inner()

            def inner(self):
                with self._lock:
                    pass
    """})
    assert run_passes(idx, ["lock-order"]) == []


def test_attr_types_resolve_cross_instance_calls():
    """`self.ledger.park()` resolves through the __init__-typed
    attribute."""
    idx = index_of(**{"pkg.m": """
        from ..telemetry.profiler import instrument

        class Ledger:
            def park(self):
                open("/tmp/ledger")

        class Ctx:
            def __init__(self, ledger: Ledger):
                self.ledger = ledger
                self._prog = instrument("kernel", self.kernel)

            def kernel(self, x):
                self.ledger.park()
                return x
    """})
    found = run_passes(idx, ["trace-purity"])
    assert any(f.qualname == "Ledger.park" for f in found)


def test_attr_types_ambiguity_tombstones():
    """An attribute assigned two different types must resolve to
    NOTHING (no finding can be fabricated from a may-alias)."""
    idx = index_of(**{"pkg.m": """
        from ..telemetry.profiler import instrument

        class Ledger:
            def park(self):
                open("/tmp/ledger")

        class Other:
            def park(self):
                return 1

        class Ctx:
            def __init__(self, ledger: Ledger, other: Other, flag):
                if flag:
                    self.dep = ledger
                else:
                    self.dep = other
                self._prog = instrument("kernel", self.kernel)

            def kernel(self, x):
                self.dep.park()
                return x
    """})
    assert run_passes(idx, ["trace-purity"]) == []


def test_attr_types_untyped_rebind_tombstones():
    """An attribute rebound from an UNannotated name (or a lowercase
    factory call) is ambiguous — the earlier typed assignment must not
    survive, or a may-alias could fabricate findings."""
    idx = index_of(**{"pkg.m": """
        from ..telemetry.profiler import instrument

        class Ledger:
            def park(self):
                open("/tmp/ledger")

        class Ctx:
            def __init__(self):
                self.dep = Ledger()
                self._prog = instrument("kernel", self.kernel)

            def adopt(self, thing):
                self.dep = thing

            def kernel(self, x):
                self.dep.park()
                return x
    """})
    assert run_passes(idx, ["trace-purity"]) == []


def test_returned_attribute_accessor_names_the_lock():
    """`with ctx.lock():` where lock() returns self._lock acquires the
    target class's attribute — visible in the acquisition graph."""
    from trino_tpu_torch.analysis.lock_order import build_lock_graph
    idx = index_of(**{"pkg.m": """
        import threading

        class Ctx:
            def __init__(self):
                self._lock = threading.Lock()

            def lock(self):
                return self._lock

        class Spiller:
            def __init__(self):
                self._lock = threading.Lock()

            def spill(self, ctx: Ctx):
                with self._lock:
                    with ctx.lock():
                        pass
    """})
    lg = build_lock_graph(idx)
    assert "pkg.m.Ctx._lock" in lg.graph.get("pkg.m.Spiller._lock", set())
    assert ("pkg.m.Spiller._lock", "pkg.m.Ctx._lock") \
        in lg.cross_instance_edges


# -- lock-order: cross-instance + parametric flow -------------------------

CROSS_AB_BA = """
    import threading

    class Ledger:
        def __init__(self):
            self._lock = threading.Lock()

        def demote(self, ctx: "Ctx"):
            with self._lock:
                spill_pages([], lock=ctx._lock)

        def park(self):
            with self._lock:
                pass

    def spill_pages(pages, lock=None):
        with lock:
            return pages

    class Ctx:
        def __init__(self, ledger: Ledger):
            self._lock = threading.Lock()
            self.ledger = ledger

        def finish(self):
            with self._lock:
                self.ledger.park()
"""


def test_lock_order_cross_instance_ab_ba_via_argument_flow():
    """The forward edge needs parametric lock flow (`lock=ctx._lock`
    into `with lock:`), the back edge needs typed-attribute resolution
    (`self.ledger.park()`)."""
    from trino_tpu_torch.analysis.lock_order import build_lock_graph
    idx = index_of(**{"pkg.spill": CROSS_AB_BA})
    found = run_passes(idx, ["lock-order"])
    cycles = [f for f in found if f.rule == "lock-cycle"]
    assert len(cycles) == 1
    assert "Ledger._lock" in cycles[0].message
    assert "Ctx._lock" in cycles[0].message
    assert "cross-instance" in cycles[0].message
    lg = build_lock_graph(idx)
    assert ("pkg.spill.Ledger._lock", "pkg.spill.Ctx._lock") \
        in lg.cross_instance_edges


def test_lock_order_param_flow_nonblocking_stays_clean():
    """The same shape with a non-blocking try on the flowed lock (the
    demote_across idiom) must not cycle."""
    idx = index_of(**{"pkg.spill": CROSS_AB_BA.replace(
        "with lock:\n            return pages",
        "ok = lock.acquire(blocking=False)\n        return pages")})
    found = run_passes(idx, ["lock-order"])
    assert [f for f in found if f.rule == "lock-cycle"] == []


def test_lock_order_parametric_must_alias_self_deadlock():
    """Passing the HELD lock itself into a helper that blocking-
    acquires its parameter is a must-alias self-deadlock — provable
    only through argument flow."""
    idx = index_of(**{"pkg.m": """
        import threading

        class A:
            def __init__(self):
                self._lock = threading.Lock()

            def outer(self):
                with self._lock:
                    helper(self._lock)

        def helper(lock):
            lock.acquire()
    """})
    found = run_passes(idx, ["lock-order"])
    assert any(f.rule == "self-deadlock"
               and "flows through a call argument" in f.message
               for f in found)


def test_lock_order_direct_nested_two_instances_not_self_deadlock():
    """Hand-over-hand locking of TWO instances of one class directly
    nested in one body is ordered locking, not a self-cycle: only
    identical source chains prove same-object."""
    idx = index_of(**{"pkg.m": """
        import threading

        class Pool:
            def __init__(self):
                self._lock = threading.Lock()

            def transfer(self, other: "Pool"):
                with self._lock:
                    with other._lock:
                        pass

            def reacquire(self):
                with self._lock:
                    with self._lock:
                        pass
    """})
    found = run_passes(idx, ["lock-order"])
    subs = [f for f in found if f.rule == "self-deadlock"]
    assert [f.qualname for f in subs] == ["Pool.reacquire"]


def test_lock_order_via_self_on_peer_lock_not_self_deadlock():
    """Holding a PEER instance's structurally-equal lock while
    self-calling a method that takes this instance's own lock is
    ordered locking."""
    idx = index_of(**{"pkg.m": """
        import threading

        class Pool:
            def __init__(self, other: "Pool" = None):
                self._lock = threading.Lock()
                self.other = other

            def f(self):
                with self.other._lock:
                    self.park()

            def park(self):
                with self._lock:
                    pass
    """})
    found = run_passes(idx, ["lock-order"])
    assert [f for f in found if f.rule == "self-deadlock"] == []


def test_lock_order_alias_to_unlockish_name_still_acquires():
    """`lock = self._mu; with lock:` — the RAW name qualifies even
    when the canonical target's name doesn't look lockish."""
    idx = index_of(**{"pkg.srv": """
        import threading, subprocess

        class S:
            def __init__(self):
                self._mu = threading.Lock()

            def ship(self):
                lock = self._mu
                with lock:
                    subprocess.run(["scp", "x"])
    """})
    found = run_passes(idx, ["lock-order"])
    assert ("lock-order", "lock-over-rpc") in rules(found)


def test_lock_order_param_flow_of_peer_lock_not_self_deadlock():
    """Handing a DIFFERENT instance's structurally-equal lock to a
    blocking helper while holding your own is a cross-instance
    hand-off."""
    idx = index_of(**{"pkg.m": """
        import threading

        class A:
            def __init__(self):
                self._lock = threading.Lock()

            def transfer(self, other: "A"):
                with self._lock:
                    grab(other._lock)

        def grab(lock):
            lock.acquire()
    """})
    found = run_passes(idx, ["lock-order"])
    assert [f for f in found if f.rule == "self-deadlock"] == []


def test_lock_order_rebound_head_defeats_same_object_claim():
    """Two textually-identical chains whose head is REBOUND between
    the acquisitions are not the same object."""
    idx = index_of(**{"pkg.m": """
        import threading

        class Ctx:
            def __init__(self):
                self.lock = threading.Lock()
                self._next = None

        class W:
            def drain(self, ctx: Ctx):
                with ctx.lock:
                    ctx = ctx._next
                    with ctx.lock:
                        pass
    """})
    found = run_passes(idx, ["lock-order"])
    assert [f for f in found if f.rule == "self-deadlock"] == []


def test_lock_order_with_item_call_joins_the_graph():
    """A call made INSIDE a with-item expression must reach the call
    graph — its transitive acquisitions close real AB-BA cycles."""
    idx = index_of(**{"pkg.m": """
        import threading

        LOCK_A = threading.Lock()
        LOCK_B = threading.Lock()

        def enter_chan():
            LOCK_B.acquire()
            return open("/dev/null")

        def forward():
            with LOCK_A:
                with enter_chan():
                    pass

        def backward():
            with LOCK_B:
                with LOCK_A:
                    pass
    """})
    found = run_passes(idx, ["lock-order"])
    assert any(f.rule == "lock-cycle" for f in found), \
        [f.render() for f in found]


def test_bind_args_respects_varargs_and_kwonly():
    """`helper(1, self._lock)` into `def helper(x, *args, lock=None)`
    puts the lock in *args at runtime — binding it to the kwonly
    `lock` would fabricate a must-alias self-deadlock."""
    idx = index_of(**{"pkg.m": """
        import threading

        class A:
            def __init__(self):
                self._lock = threading.Lock()

            def outer(self):
                with self._lock:
                    helper(1, self._lock)

        def helper(x, *args, lock=None):
            if lock is not None:
                lock.acquire()
    """})
    found = run_passes(idx, ["lock-order"])
    assert [f for f in found if f.rule == "self-deadlock"] == []


def test_lock_order_two_instances_same_class_not_conflated():
    """Structural identity must NOT turn two instances of one class
    into a self-cycle."""
    idx = index_of(**{"pkg.m": """
        import threading

        class Pool:
            def __init__(self, parent: "Pool" = None):
                self._lock = threading.Lock()
                self.parent = parent

            def charge(self, other: "Pool"):
                with self._lock:
                    other.snapshot()

            def snapshot(self):
                with self._lock:
                    pass
    """})
    found = run_passes(idx, ["lock-order"])
    assert [f for f in found if f.rule == "self-deadlock"] == []


# -- cache-coherence -------------------------------------------------------

def test_cache_coherence_lru_session_read_min_collectives_class():
    """A session-property read inside an lru_cache'd builder whose key
    omits it fails the pass (the `min_collectives` bug class)."""
    idx = index_of(**{"pkg.exch": """
        from functools import lru_cache
        from .. import session_properties as SP

        @lru_cache(maxsize=8)
        def build_program(mesh, n):
            min_c = SP.prop_value({}, "rebalance_min_collectives")
            return (mesh, n, min_c)
    """})
    found = run_passes(idx, ["cache-coherence"])
    hits = [f for f in found if f.rule == "unkeyed-session-read"]
    assert len(hits) == 1
    assert "rebalance_min_collectives" in hits[0].message
    assert "build_program" in hits[0].message


def test_cache_coherence_memo_env_and_global_reads():
    idx = index_of(**{"pkg.progcache": """
        import os

        _MODE = "auto"

        def set_mode(m):
            global _MODE
            _MODE = m

        class Builder:
            def __init__(self):
                self._programs = {}

            def get(self, key):
                hit = self._programs.get(key)
                if hit is None:
                    flavor = os.environ.get("FLAVOR", "")
                    hit = self._programs[key] = (key, flavor, _MODE)
                return hit
    """})
    found = run_passes(idx, ["cache-coherence"])
    got = rules(found)
    assert ("cache-coherence", "unkeyed-env-read") in got
    assert ("cache-coherence", "unkeyed-global-read") in got
    env = [f for f in found if f.rule == "unkeyed-env-read"]
    assert "'FLAVOR'" in env[0].message


def test_cache_coherence_interprocedural_reach():
    """A helper the builder calls reads the property: flagged with the
    builder named (the read is reachable from memoized code)."""
    idx = index_of(**{"pkg.exch": """
        from functools import lru_cache
        from .. import session_properties as SP

        def pick_sizing():
            return SP.prop_value({}, "device_exchange_sizing")

        @lru_cache(maxsize=8)
        def build_program(mesh):
            return (mesh, pick_sizing())
    """})
    found = run_passes(idx, ["cache-coherence"])
    hits = [f for f in found if f.rule == "unkeyed-session-read"]
    assert len(hits) == 1
    assert "reached from cached builder build_program" in hits[0].message
    assert hits[0].qualname == "pick_sizing"


def test_cache_coherence_keyed_reads_are_clean():
    """Hoisting the read into the key (the canonical fix) and
    constant globals produce no findings; a caller reading props
    OUTSIDE the builder is the designed shape."""
    idx = index_of(**{"pkg.ok": """
        from functools import lru_cache
        from .. import session_properties as SP

        _CONST = 8

        @lru_cache(maxsize=8)
        def build_program(mesh, min_c):
            return (mesh, min_c, _CONST)

        def run(mesh, session):
            min_c = SP.value(session, "rebalance_min_collectives")
            return build_program(mesh, min_c)

        class Builder:
            def __init__(self):
                self._programs = {}

            def get(self, key, flavor):
                hit = self._programs.get((key, flavor))
                if hit is None:
                    hit = self._programs[(key, flavor)] = (key, flavor)
                return hit
    """})
    assert run_passes(idx, ["cache-coherence"]) == []


def test_cache_coherence_memo_read_in_key_is_coherent():
    """A memo builder whose env/session read flows INTO the memo key
    is coherent by construction."""
    idx = index_of(**{"pkg.ok": """
        import os

        class Builder:
            def __init__(self):
                self._programs = {}

            def get(self, key):
                flavor = os.environ.get("FLAVOR", "")
                k = (key, flavor)
                hit = self._programs.get(k)
                if hit is None:
                    hit = self._programs[k] = (key, flavor)
                return hit
    """})
    assert run_passes(idx, ["cache-coherence"]) == []


def test_cache_coherence_inline_key_read_and_aliased_container():
    """A read INLINE in the key expression, and a container reached
    through a local alias, are both keyed — coherent."""
    idx = index_of(**{"pkg.ok": """
        import os

        class B:
            def __init__(self):
                self._programs = {}

            def inline(self, key):
                hit = self._programs.get(
                    (key, os.environ.get("FLAVOR", "")))
                if hit is None:
                    self._programs[(key, "x")] = key
                return hit

        class C:
            def __init__(self):
                self._programs = {}

            def aliased(self, key):
                d = self._programs
                flavor = os.environ.get("FLAVOR", "")
                k = (key, flavor)
                hit = d.get(k)
                if hit is None:
                    hit = d[k] = (key, flavor)
                return hit
    """})
    assert run_passes(idx, ["cache-coherence"]) == []


def test_cache_coherence_global_container_not_its_own_input():
    """A lazily-initialized/resettable `global _CACHE` container is
    the cache itself, not an input missing from its own key."""
    idx = index_of(**{"pkg.m": """
        _CACHE = None

        def reset():
            global _CACHE
            _CACHE = None

        def get_prog(key):
            global _CACHE
            if _CACHE is None:
                _CACHE = {}
            v = _CACHE.get(key)
            if v is None:
                v = _CACHE[key] = (key,)
            return v
    """})
    assert run_passes(idx, ["cache-coherence"]) == []


def test_cache_coherence_rmw_accumulators_are_not_builders():
    """Refcounts/EWMAs (`d[k] = d.get(k, 0) + 1`) cache nothing: a
    session read beside one must not be flagged."""
    from trino_tpu_torch.analysis.cache_coherence import cached_builders
    idx = index_of(**{"pkg.w": """
        from .. import session_properties as SP

        class W:
            def __init__(self):
                self._refs = {}

            def acquire(self, qid, session):
                self._refs[qid] = self._refs.get(qid, 0) + 1
                return SP.prop_value(session, "query_max_memory_bytes")
    """})
    assert run_passes(idx, ["cache-coherence"]) == []
    assert cached_builders(idx) == {}


def test_cache_coherence_pragma_opt_out():
    idx = index_of(**{"pkg.exch": """
        import os
        from functools import lru_cache

        @lru_cache(maxsize=8)
        def build(mesh):
            mode = os.environ.get("MODE", "")  # qlint: ignore[cache-coherence] process-static
            return (mesh, mode)
    """})
    assert run_passes(idx, ["cache-coherence"]) == []


# -- resource-lifecycle ----------------------------------------------------

SPOOLY = """
    class SpoolCursor:
        def __init__(self, path):
            self.path = path

        def poll(self):
            return None

        def close(self):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.close()
"""


def test_resource_lifecycle_leak_and_conditional_close():
    idx = index_of(**{"pkg.spool": SPOOLY + """
    def leak(path):
        cur = SpoolCursor(path)
        return cur.poll()

    def racy(path):
        cur = SpoolCursor(path)
        page = cur.poll()
        cur.close()
        return page

    def dropped(path):
        SpoolCursor(path)
    """})
    found = run_passes(idx, ["resource-lifecycle"])
    by_rule = {}
    for f in found:
        by_rule.setdefault(f.rule, []).append(f)
    leaks = by_rule.get("leaked-closeable", [])
    assert any(f.qualname == "leak" for f in leaks)
    assert any(f.qualname == "dropped" for f in leaks)
    conds = by_rule.get("close-not-guaranteed", [])
    assert [f.qualname for f in conds] == ["racy"]


def test_resource_lifecycle_satisfied_shapes_are_clean():
    """with / finally / teardown-list registration / weakref.finalize /
    escape (return, self-store, container) all discharge the
    obligation — the engine's own idioms."""
    idx = index_of(**{"pkg.spool": SPOOLY + """
    import weakref

    def with_managed(path):
        with SpoolCursor(path) as cur:
            return cur.poll()

    def finally_closed(path):
        cur = SpoolCursor(path)
        try:
            return cur.poll()
        finally:
            cur.close()

    def registered(path, state):
        cur = SpoolCursor(path)
        state.channels.append(cur)

    def finalized(path):
        cur = SpoolCursor(path)
        weakref.finalize(cur, print, path)
        return cur

    def factory(path):
        return SpoolCursor(path)

    class Owner:
        def __init__(self, path):
            self._cur = SpoolCursor(path)

        def close(self):
            self._cur.close()
    """})
    assert run_passes(idx, ["resource-lifecycle"]) == []


def test_resource_lifecycle_factory_propagates():
    """A caller of a closeable FACTORY holds a closeable exactly as if
    it had called the constructor."""
    idx = index_of(**{"pkg.spool": SPOOLY + """
    def spool_channel(path):
        return SpoolCursor(path)

    def consumer(path):
        chan = spool_channel(path)
        chan.poll()
    """})
    found = run_passes(idx, ["resource-lifecycle"])
    assert any(f.rule == "leaked-closeable" and f.qualname == "consumer"
               for f in found)


def test_resource_lifecycle_open_builtin_and_pragma():
    idx = index_of(**{"pkg.io": """
    def bad(path):
        f = open(path)
        return f.read()

    def opted(path):
        f = open(path)  # qlint: ignore[resource-lifecycle] fd handed to C extension
        return f.read()

    def good(path):
        with open(path) as f:
            return f.read()
    """})
    found = run_passes(idx, ["resource-lifecycle"])
    assert [f.qualname for f in found] == ["bad"]


# -- pragma audit ----------------------------------------------------------

def test_pragma_audit_flags_bare_and_accepts_reasoned():
    idx = index_of(**{"pkg.m": """
        def f():
            x = 1  # qlint: ignore[taxonomy]
            y = 2  # qlint: ignore[trace-purity] deliberate host read
            return x + y
    """})
    found = run_passes(idx, ["taxonomy"])
    bare = [f for f in found if f.pass_id == "pragma"]
    assert len(bare) == 1
    assert bare[0].rule == "missing-reason"
    assert "taxonomy" in bare[0].message


# -- framework plumbing --------------------------------------------------

def test_unknown_pass_rejected():
    idx = index_of(**{"pkg.m": "x = 1\n"})
    with pytest.raises(ValueError, match="unknown passes"):
        run_passes(idx, ["no-such-pass"])


def test_finding_keys_are_line_stable():
    src = """
        def flush(resp):
            raise RuntimeError("boom")
    """
    a = run_passes(index_of(**{"pkg.parallel.m": src}), ["taxonomy"])
    b = run_passes(index_of(**{"pkg.parallel.m":
                               "\n\n\n" + textwrap.dedent(src)}),
                   ["taxonomy"])
    assert [f.key for f in a] == [f.key for f in b]
    assert a[0].line != b[0].line


def test_apply_baseline_splits_new_suppressed_stale():
    idx = index_of(**{"pkg.parallel.m": """
        def f():
            raise RuntimeError("a")

        def g():
            raise Exception("b")
    """})
    found = run_passes(idx, ["taxonomy"])
    assert len(found) == 2
    baseline = {found[0].key: "triaged", "gone:key": "stale"}
    new, suppressed, stale = apply_baseline(found, baseline)
    assert [f.key for f in new] == [found[1].key]
    assert [f.key for f in suppressed] == [found[0].key]
    assert stale == ["gone:key"]


def test_visitor_walks_as_ast_nodevisitor_does():
    """The analyzer's cached-dispatch visitor sees the same nodes in the
    same order as ``ast.NodeVisitor`` (every pass's visitors rest on
    it)."""
    import ast

    from trino_tpu_torch.analysis.core import FastVisitor

    src = textwrap.dedent("""
        def f(a, *b, c=1, **d):
            with lock as l, g() as (x, y):
                for i in range(3):
                    yield [j async for j in a if j] or {k: v for k, v in d}
            return lambda z: z + c
        class K(Base, metaclass=M):
            x: int = 3
    """)
    tree = ast.parse(src)

    class Plain(ast.NodeVisitor):
        def __init__(self):
            self.seen = []

        def visit_Name(self, node):
            self.seen.append(("name", node.id))
            self.generic_visit(node)

        def visit_Call(self, node):
            self.seen.append(("call", node.lineno))
            self.generic_visit(node)

    class Fast(FastVisitor):
        __init__ = Plain.__init__
        visit_Name = Plain.visit_Name
        visit_Call = Plain.visit_Call

    a, b = Plain(), Fast()
    a.visit(tree)
    b.visit(tree)
    assert a.seen == b.seen and len(a.seen) > 10


def test_own_nodes_kept_walk_equals_a_fresh_walk():
    """``core.own_nodes`` keeps its walk on the function node after the
    first: the second walk yields the same nodes in the same order as
    the first, nested defs excluded and lambdas kept, as a fresh walk
    with the same ownership rule does."""
    import ast

    from trino_tpu_torch.analysis.core import own_nodes

    src = textwrap.dedent("""
        def f(a, *b, c=1, **d):
            with lock as l, g() as (x, y):
                for i in range(3):
                    yield [j async for j in a if j] or {k: v for k, v in d}
            def inner():
                return hidden()
            return lambda z: z + c
    """)
    func = ast.parse(src).body[0]

    def fresh(node):
        out, stack = [], [node]
        while stack:
            cur = stack.pop()
            out.append(cur)
            stack.extend(c for c in ast.iter_child_nodes(cur)
                         if not isinstance(c, (ast.FunctionDef,
                                               ast.AsyncFunctionDef)))
        return out

    first, second = list(own_nodes(func)), list(own_nodes(func))
    assert first == second == fresh(func) and len(first) > 30
    names = {n.id for n in first if isinstance(n, ast.Name)}
    assert "z" in names and "hidden" not in names


# -- guarded-by ----------------------------------------------------------

def test_guarded_by_bare_write_from_timer_thread():
    """Known-bad: an attribute mutated under a lock on the main path
    but written bare from a Timer-thread callback."""
    idx = index_of(**{"pkg.srv": """
        import threading

        class Sweeper:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0
                threading.Timer(5.0, self._tick).start()

            def _tick(self):
                self.count += 1      # bare write on the timer thread

            def bump(self):
                with self._lock:
                    self.count += 1

            def bump_again(self):
                with self._lock:
                    self.count += 1
    """})
    found = run_passes(idx, ["guarded-by"])
    assert ("guarded-by", "guarded-by") in rules(found)
    assert any(f.qualname == "Sweeper._tick" for f in found)
    msg = next(f.message for f in found
               if f.qualname == "Sweeper._tick")
    assert "_lock" in msg and "timer" in msg


def test_guarded_by_interprocedural_lockset_is_clean():
    """A helper that mutates ONLY under callers that hold the lock
    inherits the lockset through the summary fixpoint — no finding."""
    idx = index_of(**{"pkg.srv": """
        import threading

        class Store:
            def __init__(self):
                self._lock = threading.Lock()
                self.total = 0
                threading.Thread(target=self._loop).start()

            def _loop(self):
                with self._lock:
                    self._merge(1)

            def record(self):
                with self._lock:
                    self._merge(2)

            def _merge(self, v):
                self.total += v      # guarded via every caller
    """})
    assert run_passes(idx, ["guarded-by"]) == []


def test_guarded_by_check_then_act_on_shared_dict():
    idx = index_of(**{"pkg.memo": """
        import threading

        class Memo:
            def __init__(self):
                self.memo = {}
                threading.Thread(target=self._sweep).start()

            def _sweep(self):
                for k in list(self.memo):
                    del self.memo[k]

            def get_or_build(self, k):
                if k not in self.memo:    # unlocked test-then-mutate
                    self.memo[k] = object()
                return self.memo[k]
    """})
    found = run_passes(idx, ["guarded-by"])
    assert ("guarded-by", "check-then-act") in rules(found)
    assert any(f.qualname == "Memo.get_or_build" for f in found)


def test_guarded_by_check_then_act_sees_tuple_unpack_store():
    """A container store hidden inside a tuple unpack still counts."""
    idx = index_of(**{"pkg.memo": """
        import threading

        class Memo:
            def __init__(self):
                self.memo = {}
                self.other = 0
                threading.Thread(target=self._sweep).start()

            def _sweep(self):
                for k in list(self.memo):
                    del self.memo[k]

            def get_or_build(self, k):
                if k not in self.memo:
                    self.memo[k], self.other = (1, 2)
                return self.memo[k]
    """})
    found = run_passes(idx, ["guarded-by"])
    assert ("guarded-by", "check-then-act") in rules(found)


def test_guarded_by_locked_check_then_act_is_clean():
    idx = index_of(**{"pkg.memo": """
        import threading

        class Memo:
            def __init__(self):
                self.memo = {}
                self._lock = threading.Lock()
                threading.Thread(target=self._sweep).start()

            def _sweep(self):
                with self._lock:
                    self.memo.clear()

            def get_or_build(self, k):
                with self._lock:
                    if k not in self.memo:
                        self.memo[k] = object()
                    return self.memo[k]
    """})
    assert run_passes(idx, ["guarded-by"]) == []


def test_guarded_by_immutable_after_init_exempt():
    """Assigned solely in __init__ BEFORE the spawn: reads anywhere are
    clean. The same attribute assigned AFTER the spawn is `init-race`."""
    clean = index_of(**{"pkg.a": """
        import threading

        class Ok:
            def __init__(self):
                self._lock = threading.Lock()
                self.config = {"a": 1}
                threading.Thread(target=self._loop).start()

            def _loop(self):
                return self.config.get("a")
    """})
    assert run_passes(clean, ["guarded-by"]) == []

    racy = index_of(**{"pkg.b": """
        import threading

        class Bad:
            def __init__(self):
                threading.Thread(target=self._loop).start()
                self.config = {"a": 1}     # spawned thread reads this

            def _loop(self):
                return self.config.get("a")
    """})
    found = run_passes(racy, ["guarded-by"])
    assert ("guarded-by", "init-race") in rules(found)
    assert any(f.qualname == "Bad.__init__" for f in found)
    untouched = index_of(**{"pkg.c": """
        import threading

        class Meh:
            def __init__(self):
                threading.Thread(target=self._loop).start()
                self.unrelated = 3

            def _loop(self):
                return 1
    """})
    assert run_passes(untouched, ["guarded-by"]) == []


def test_guarded_by_single_entry_exempt():
    """Every site on ONE entry: sequential within the thread — exempt
    even with a lock elsewhere in the class."""
    idx = index_of(**{"pkg.chan": """
        import threading

        class Channel:
            def __init__(self):
                self._lock = threading.Lock()
                self._queue = []
                self._cursor = 0
                threading.Thread(target=self._fetch).start()

            def _fetch(self):
                self._cursor += 1     # only this thread touches it
                with self._lock:
                    self._queue.append(self._cursor)

            def poll(self):
                with self._lock:
                    if self._queue:
                        return self._queue.pop()
    """})
    found = run_passes(idx, ["guarded-by"])
    assert not any("_cursor" in f.message for f in found), found


def test_guarded_by_pragma_opt_out():
    idx = index_of(**{"pkg.srv": """
        import threading

        class Gauge:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0
                threading.Thread(target=self._loop).start()

            def _loop(self):
                self.n += 1  # qlint: ignore[guarded-by] monotonic gauge, torn reads acceptable

            def a(self):
                with self._lock:
                    self.n += 1

            def b(self):
                with self._lock:
                    self.n += 1
    """})
    assert run_passes(idx, ["guarded-by"]) == []


def test_guarded_by_condition_guards_like_a_lock():
    """`with self._cond:` (threading.Condition) is mutual exclusion."""
    idx = index_of(**{"pkg.q": """
        import threading

        class Queue:
            def __init__(self):
                self._cond = threading.Condition()
                self.items = []
                threading.Thread(target=self._drain).start()

            def _drain(self):
                with self._cond:
                    if self.items:
                        self.items.pop()

            def offer(self, x):
                with self._cond:
                    self.items.append(x)
    """})
    assert run_passes(idx, ["guarded-by"]) == []


def test_guarded_by_sees_closure_self_in_nested_thread_target():
    """A nested def that captures the method's `self` is attributed to
    the enclosing class — bare closure accesses cannot hide."""
    idx = index_of(**{"pkg.srv": """
        import threading

        class Pool:
            def __init__(self):
                self._lock = threading.Lock()
                self.slots = [1, 2]

            def swap(self, i):
                with self._lock:
                    self.slots[i] = 0

            def swap2(self, i):
                with self._lock:
                    self.slots[i] = 1

            def launch(self):
                def run_one(t):
                    return [s for s in self.slots if s]  # bare, closure
                threading.Thread(target=run_one, args=(0,)).start()
    """})
    found = run_passes(idx, ["guarded-by"])
    assert ("guarded-by", "guarded-by") in rules(found)
    assert any(f.qualname.endswith("run_one") for f in found), found


def test_thread_entry_kinds_taxonomy():
    """Every entry kind the index models: thread / timer / executor /
    rpc-handler / finalizer."""
    from trino_tpu_torch.analysis.core import thread_entries
    idx = index_of(**{"pkg.m": """
        import threading
        import weakref
        from socketserver import BaseRequestHandler

        class H(BaseRequestHandler):
            def handle(self):
                pass

        class S:
            def __init__(self, pool):
                threading.Thread(target=self._loop).start()
                threading.Timer(1.0, self._tick).start()
                pool.submit(self._job)
                weakref.finalize(self, self._fin)

            def _loop(self): pass
            def _tick(self): pass
            def _job(self): pass
            def _fin(self): pass
    """})
    entries = thread_entries(idx)
    kinds = {e.func_id.split(":")[-1]: e.kind
             for e in entries.values()}
    assert kinds == {"S._loop": "thread", "S._tick": "timer",
                     "S._job": "executor", "S._fin": "finalizer",
                     "H.handle": "rpc-handler"}


def test_nine_passes_registered():
    assert sorted(PASSES) == sorted([
        "trace-purity", "lock-order", "recompile", "session-props",
        "taxonomy", "blocked-protocol", "cache-coherence",
        "resource-lifecycle", "guarded-by"])
