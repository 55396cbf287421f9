"""The tier-1 gate of ``trino_tpu_torch.analysis`` over the port's own
tree: every pass over ``trino_tpu_torch/``, zero non-baselined
findings, no stale baseline entry, the baseline's size pinned; the
not-blind floors that keep the gate meaningful; the analyzer's CPU-time
ratchet; and the CLI (``python -m trino_tpu_torch.analysis``). The
counterpart of the gate half of ``tests/test_static_analysis.py``.

The index over the tree is built once for the file (a module fixture),
and that run is the one the ratchet times.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from trino_tpu_torch.analysis import (PASSES, ProjectIndex, apply_baseline,
                                      default_baseline_path, load_baseline,
                                      run_passes)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "trino_tpu_torch")
P = "trino_tpu_torch."

#: what the port's baseline holds: host reads whose JAX counterpart
#: stays on the device. It may only shrink.
BASELINE_SIZE = 1


@pytest.fixture(scope="module")
def port_findings():
    t0 = time.process_time()
    index = ProjectIndex.from_package(PACKAGE)
    findings = run_passes(index)
    return index, findings, time.process_time() - t0


def test_gate_port_is_clean_modulo_baseline(port_findings):
    """THE gate: every pass over trino_tpu_torch/, zero non-baselined
    findings, no stale baseline entries (the baseline only shrinks)."""
    _index, findings, _cpu = port_findings
    baseline = load_baseline(default_baseline_path(PACKAGE))
    new, _suppressed, stale = apply_baseline(findings, baseline)
    assert not new, "non-baselined findings:\n" + "\n".join(
        f.render() for f in new)
    assert not stale, ("baseline entries that no longer fire "
                       "(remove them): " + ", ".join(stale))
    assert len(baseline) <= BASELINE_SIZE, \
        "analysis/baseline.json grew — fix new findings instead"
    # every entry is a host read whose JAX counterpart stays on the
    # device, and its note names that line of the JAX engine
    for key, note in baseline.items():
        assert key.startswith("recompile:host-sync:"), key
        assert "trino_tpu/" in note and ".py:" in note, (key, note)


def test_default_baseline_is_the_ports_own():
    """The port's suppressions live in its own file, never in the JAX
    engine's ``analysis_baseline.json`` at the repo root."""
    path = default_baseline_path(PACKAGE)
    assert path == os.path.join(PACKAGE, "analysis", "baseline.json")
    assert os.path.exists(path)
    assert os.path.abspath(path) != os.path.join(REPO,
                                                 "analysis_baseline.json")


def test_gate_passes_are_not_blind_on_the_port(port_findings):
    """The gate is only meaningful if the passes index the engine:
    device programs, locks, cached builders, channels, closeables and
    the property registry must all be visible."""
    from trino_tpu_torch.analysis.blocked_protocol import channel_classes
    from trino_tpu_torch.analysis.cache_coherence import cached_builders
    from trino_tpu_torch.analysis.lock_order import build_lock_graph
    from trino_tpu_torch.analysis.recompile import _cached_functions
    from trino_tpu_torch.analysis.resource_lifecycle import (
        closeable_classes, closeable_factories)
    from trino_tpu_torch.analysis.session_props import (_declarations,
                                                        _registry_module)
    from trino_tpu_torch.analysis.trace_purity import (profiled_entries,
                                                       program_entries)
    index, _, _cpu = port_findings
    # the device programs: the port's counterparts of jit entries
    entries = program_entries(index)
    assert len(entries) >= 23, sorted(entries)
    for entry in ("ops.hashtable:hash_group_ids",
                  "ops.hashtable:hash_segment_reduce",
                  "ops.global_hash_agg:global_hash_insert",
                  "ops.global_hash_agg:global_hash_reduce",
                  "ops.aggregation:_bucket_reduction_stats",
                  "ops.matmul_join:_matmul_lo_count",
                  "expr.compiler:PageProcessor._run",
                  "parallel.device_exchange:_exchange_program.exchanged",
                  "parallel.mesh_query:q1_stage1_fn.stage1",
                  "parallel.mesh_query:q1_exchange_final_fn.dist",
                  "parallel.mesh_query:q1_global_hash_fn.dist",
                  "ops.kernels:_run"):
        assert P + entry in entries, entry
    # the kernel's library call is the pallas_call counterpart
    assert entries[P + "ops.kernels:_run"].kind == "pallas"
    assert entries[P + "ops.hashtable:hash_group_ids"].static_params \
        == {"rounds", "exact"}
    cached = _cached_functions(index)
    assert P + "parallel.device_exchange:_exchange_program" in cached
    declared = _declarations(_registry_module(index))
    assert len(declared) == 71
    assert declared["retry_policy"][0] == "varchar"
    assert "page_rows" not in declared
    assert declared["hbo_reorder_joins_enabled"][0] == "boolean"
    assert declared["hbo_distribution_enabled"][0] == "boolean"
    chans = channel_classes(index)
    assert len(chans) >= 5, chans
    assert P + "parallel.remote_exchange:RemoteExchangeChannel" in chans
    assert P + "parallel.spool:SpoolCursor" in chans
    builders = cached_builders(index)
    assert len(builders) >= 10, sorted(builders)
    assert builders[P + "parallel.device_exchange:_exchange_program"] \
        .kind == "lru"
    for memo in ("cache:ProcessorCache.get", "cache:QueryCache.parse",
                 "parallel.mesh_query:_cached_program",
                 "planner.memo:RuleContext.region_stats"):
        assert builders[P + memo].kind == "memo", memo
    vjoin = next(
        (f for f in index.iter_functions()
         if f.module == P + "planner.exchanges"
         and f.qualname == "ExchangePlanner._v_JoinNode"), None)
    assert vjoin is not None
    assert any(c.chain.split(".")[-1] == "note_plan_flip"
               for c in vjoin.calls)
    closeables = closeable_classes(index)
    for cls in ("SpoolCursor", "_ChainedSpoolCursor",
                "RemoteExchangeChannel", "DiskSpiller", "QueryMemoryPool"):
        assert cls in closeables, cls
    factories = closeable_factories(index, closeables)
    assert P + "parallel.spool:spool_channel" in factories
    assert P + "parallel.spool:spool_task_cursor" in factories
    lg = build_lock_graph(index)
    assert (P + "parallel.worker.WorkerServer._lock",
            P + "exec.memory.NodeMemoryPool._lock") \
        in lg.cross_instance_edges, sorted(lg.cross_instance_edges)
    # the program profiler covers the programs: every instrument()
    # registration is indexed by name (a dropped wrapper would blind
    # EXPLAIN ANALYZE VERBOSE and system.runtime.kernels)
    profiled = profiled_entries(index)
    assert len(profiled) >= 29, sorted(profiled)
    for kernel in ("page_processor", "page_processor_batched",
                   "sort_by", "window_kernel",
                   "hash_group_ids", "hash_segment_reduce",
                   "sort_group_reduce", "join_build_sorted",
                   "join_probe_counts", "matmul_join_probe",
                   "grouped_topn_kernel", "device_exchange_program",
                   "device_exchange_count", "mesh_q1_stage1",
                   "segment_reduce_pallas",
                   "batched_agg_partial", "batched_agg_merge",
                   "batched_agg_finalize", "batched_join_probe",
                   "batched_join_expand", "batched_join_semi"):
        assert kernel in profiled, kernel
    assert all(m == P + "exec.batched"
               for m in profiled["batched_agg_partial"])


def test_hbo_record_path_indexed_and_outside_programs(port_findings):
    """The history-store write path is VISIBLE to the index, the device
    programs reach a non-empty set of functions, and no caller of the
    write path is among them: a store write inside a program would fire
    per page instead of once per query."""
    from trino_tpu_torch.analysis.trace_purity import (program_reachable,
                                                       recording_sites)
    index, _, _cpu = port_findings
    sites = recording_sites(index)
    callers = {fid for fids in sites.values() for fid in fids}
    assert any("record_query" in chain for chain in sites), sites
    assert any("record_actuals" in chain for chain in sites), sites
    assert any(fid.startswith(P + "telemetry.stats_store:")
               for fid in callers), sorted(callers)
    reached = set(program_reachable(index))
    assert len(reached) >= 40, sorted(reached)
    assert P + "ops.hashtable:hash_insert" in reached
    assert P + "ops.kernels:segment_reduce_columns" in reached
    inside = callers & reached
    assert not inside, (
        "stats-store write path reachable from a device program: "
        + ", ".join(sorted(inside)))


def test_guarded_by_not_blind_on_the_port(port_findings):
    """The thread-entry index, the guard inference and the named
    shared-state classes must all be populated on the port."""
    from trino_tpu_torch.analysis.core import thread_entries
    from trino_tpu_torch.analysis.guarded_by import analyze
    index, _, _cpu = port_findings
    entries = thread_entries(index)
    assert len(entries) >= 8, sorted(entries)
    mods = {e.func_id.split(":")[0] for e in entries.values()}
    for mod in ("exec.task_executor", "parallel.process_runner",
                "parallel.remote_exchange", "parallel.worker",
                "server.protocol"):
        assert P + mod in mods, sorted(mods)
    kinds = {e.kind for e in entries.values()}
    assert {"thread", "executor", "rpc-handler", "finalizer"} <= kinds
    analysis = analyze(index)
    assert len(analysis.guards) >= 10, sorted(analysis.guards)
    assert analysis.guards[
        P + "parallel.remote_exchange.RemoteExchangeChannel._queue"] \
        .endswith("RemoteExchangeChannel._lock")
    assert analysis.guards[
        P + "parallel.process_runner.ProcessQueryRunner.workers"] \
        .endswith("ProcessQueryRunner._heal_lock")
    for probe in ("parallel.worker._RetainedStream.frames",
                  "server.protocol._QueryState.state",
                  "exec.memory.HostSpillLedger.resident_bytes"):
        assert P + probe in analysis.sites, probe
    assert analysis.guards[
        P + "exec.memory.HostSpillLedger.resident_bytes"] \
        .endswith("HostSpillLedger._lock")


def test_guarded_by_sees_hybrid_join_partition_table(port_findings):
    """The hybrid hash join's partition table: the class is indexed,
    and every post-init access of the partition-table family lexically
    holds ``HybridJoinState._lock``; the single-entry exemption is the
    expected steady state, and if the revocation-callback edge ever
    becomes visible it must flip to the real guard."""
    from trino_tpu_torch.analysis.guarded_by import analyze

    index, _, _cpu = port_findings
    analysis = analyze(index)
    base = P + "ops.join.HybridJoinState."
    lock = base + "_lock"
    for attr in ("resident", "spilled_build", "spilled_probe",
                 "spilled_build_rows", "total_build_rows",
                 "demotions", "repartitions", "max_depth_seen"):
        ss = analysis.sites.get(base + attr)
        assert ss, f"guarded-by pass is blind to {base + attr}"
        post = [s for s in ss if not s.in_init]
        assert post, f"{attr}: no post-init sites indexed"
        for s in post:
            assert lock in s.lexical, (
                f"{attr} touched outside the partition-table lock at "
                f"{s.func_id}:{s.line}")
        guard = analysis.guards.get(base + attr)
        if guard is None:
            assert analysis.exempt.get(base + attr) == "single-entry", \
                (attr, analysis.exempt.get(base + attr))
        else:
            assert guard == lock, (attr, guard)


def test_analyzer_wall_clock_ratchet(port_findings):
    """The analyzer is a pre-commit gate: a FULL fresh run over the
    port (index + all nine passes + pragma audit, the module fixture's
    run) must stay under 10 s of PROCESS CPU time — the JAX engine's
    own bound. CPU time, not wall: the analyzer is single-threaded pure
    Python, so this cannot flake on a loaded host's scheduling."""
    _index, _findings, cpu = port_findings
    assert cpu < 10.0, f"qlint full run took {cpu:.2f}s CPU"


def test_analysis_imports_neither_jax_nor_the_jax_package():
    """Importing the analyzer in a fresh process loads neither ``jax``
    nor ``trino_tpu``: it keeps its own copy of the JAX engine's
    analyzer."""
    code = ("import sys\n"
            "import trino_tpu_torch.analysis.__main__\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'trino_tpu.')) or m == 'trino_tpu')\n"
            "print('LOADED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_device_unavailable_error_is_typed_and_not_retryable():
    """The runners' and the worker's "no CUDA device" error: a
    RuntimeError (callers catch it as before) that the taxonomy calls
    USER, so no retry is spent on it."""
    from trino_tpu_torch.parallel import fault
    from trino_tpu_torch.types import DeviceUnavailableError, TrinoError

    err = DeviceUnavailableError("no CUDA device is available")
    assert isinstance(err, RuntimeError) and isinstance(err, TrinoError)
    assert str(err) == "no CUDA device is available"
    assert fault.classify_exception(err) == fault.USER
    assert not fault.is_retryable(fault.classify_exception(err))
    assert fault.serialize_failure(err)["error_code"] \
        == "DEVICE_UNAVAILABLE"


def _cli(*args, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "trino_tpu_torch.analysis", *args],
        capture_output=True, text=True, env=env, cwd=REPO,
        timeout=timeout)


def test_cli_runs_clean_and_json(tmp_path):
    """`python -m trino_tpu_torch.analysis` end to end: rc 0 on the
    tree (its own package by default), SARIF 2.1.0 shape with the
    baselined findings suppressed, and rc 1 + stale reporting on a bad
    baseline."""
    out = _cli("--json")
    assert out.returncode == 0, out.stdout + out.stderr
    payload = json.loads(out.stdout)
    assert payload["version"] == "2.1.0"
    assert "sarif" in payload["$schema"]
    run = payload["runs"][0]
    assert run["tool"]["driver"]["name"] == "qlint"
    assert [r["suppressions"][0]["kind"] for r in run["results"]] \
        == ["external"] * BASELINE_SIZE
    props = run["properties"]
    assert props["new"] == []
    assert props["stale_baseline_keys"] == []
    assert sorted(props["passes"]) == sorted(PASSES)
    assert os.path.samefile(props["package"], PACKAGE)

    bad = tmp_path / "baseline.json"
    bad.write_text(json.dumps(
        {"findings": [{"key": "taxonomy:bare-raise:gone:f:raise",
                       "note": "stale"}]}))
    out = _cli(PACKAGE, "--passes", "taxonomy", "--baseline", str(bad))
    assert out.returncode == 1
    assert "STALE" in out.stdout


def test_cli_pass_selection():
    """A pass subset reports its own passes only — and the baseline's
    entries of the passes it did not run are neither fired nor stale."""
    out = _cli("--passes", "session-props,taxonomy", "--json", PACKAGE)
    assert out.returncode == 0, out.stdout + out.stderr
    payload = json.loads(out.stdout)
    props = payload["runs"][0]["properties"]
    assert props["passes"] == ["session-props", "taxonomy"]
    assert props["stale_baseline_keys"] == []
    out = _cli("--passes", "bogus", PACKAGE, timeout=60)
    assert out.returncode == 2


def test_cli_changed_since(tmp_path):
    """Diff-aware pre-commit mode: full-index analysis, report
    filtered to files the git diff touched (untracked files included);
    a docs-only diff exits 0 with an explicit note."""
    pkg = tmp_path / "pkg"
    (pkg / "parallel").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "parallel" / "__init__.py").write_text("")
    (pkg / "parallel" / "a.py").write_text(
        "def fa():\n    raise RuntimeError('a')\n")
    (pkg / "parallel" / "b.py").write_text(
        "def fb():\n    raise RuntimeError('b')\n")

    def git(*args):
        out = subprocess.run(
            ["git", "-C", str(tmp_path), "-c", "user.name=t",
             "-c", "user.email=t@t", *args],
            capture_output=True, text=True, timeout=30)
        assert out.returncode == 0, out.stderr
        return out

    git("init", "-q")
    git("add", "-A")
    git("commit", "-qm", "seed")
    # touch ONLY a.py: its finding reports, b.py's is filtered out
    (pkg / "parallel" / "a.py").write_text(
        "def fa():\n    x = 1\n    raise RuntimeError('a')\n")
    # an UNTRACKED new module is part of the changed set too
    (pkg / "parallel" / "c.py").write_text(
        "def fc():\n    raise RuntimeError('c')\n")

    out = _cli(str(pkg), "--no-baseline", "--changed-since", "HEAD")
    assert out.returncode == 1, out.stdout + out.stderr
    assert "pkg.parallel.a" in out.stdout
    assert "pkg.parallel.c" in out.stdout
    assert "pkg.parallel.b" not in out.stdout
    assert "changed-since HEAD" in out.stderr

    # the full run still sees both
    out = _cli(str(pkg), "--no-baseline")
    assert out.returncode == 1
    assert "pkg.parallel.a" in out.stdout
    assert "pkg.parallel.b" in out.stdout

    git("add", "-A")
    git("commit", "-qm", "tree with findings")
    (tmp_path / "NOTES.md").write_text("docs only\n")
    out = _cli(str(pkg), "--no-baseline", "--changed-since", "HEAD")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "no analyzable changes" in out.stderr
    assert "touches no Python files" in out.stderr
