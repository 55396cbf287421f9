"""qlint — static analysis of the torch engine's load-bearing invariants.

The counterpart of the JAX engine's ``trino_tpu/analysis/``. The engine
carries correctness invariants that exist only as prose in docstrings;
each was a hand-found bug once. This package machine-checks them with
stdlib ``ast`` (it never imports the code it analyzes, nor torch, nor
the JAX engine) over a shared module-index/call-graph core
(``core.py``: alias-aware, thread-entry-aware) and nine passes:

- ``trace-purity`` — no host effect that holds the host thread while
  launches are queued (locks, file/socket/process IO), no host RNG, no
  stats-store write and no in-place write into a caller's tensor
  reachable inside a device program (see ``trace_purity.py`` for what
  a device program is in eager torch);
- ``lock-order`` — no cycles in the interprocedural lock-acquisition
  graph, no blocking RPC/subprocess calls under a held lock (the
  ``HostSpillLedger`` finalizer-deadlock class);
- ``recompile`` — no unhashable arguments into ``lru_cache``'d program
  builders, and no host read of a device value (``.item()``,
  ``bool(t.any())``, ``if t:``, ``torch.cuda.synchronize``) inside a
  device program: each one waits for the card (``host-sync``, the
  eager counterpart of the JAX engine's ``traced-branch``);
- ``session-props`` — every property looked up against the registry is
  declared, every declared property has a read site, declared types
  come from the registry vocabulary;
- ``taxonomy`` — in ``parallel/``, ``telemetry/`` and ``cache.py``
  (fault.py exempt), no bare ``raise RuntimeError`` / ``raise
  Exception`` and no broad ``except Exception`` handlers that swallow
  without routing through ``parallel/fault.py``;
- ``blocked-protocol`` — the streaming driver's Blocked/listen-token
  contract: channels implement the full poll/at_end/has_page/listen
  quartet, ``blocked_token`` re-checks readiness after its ``listen()``
  snapshot, waker callbacks never fire under a held lock;
- ``cache-coherence`` — every mutable input a cached builder reads
  (session properties, env vars, rebindable module globals) is part of
  its cache key (the ``min_collectives`` stale-cache class, generalized
  to memo-dict builders and interprocedural reach);
- ``resource-lifecycle`` — every constructed closeable (spool cursors,
  exchange channels, spillers, ``open()`` files) reaches ``close()``
  on all paths: ``with``, ``finally``, teardown-list registration or
  ``weakref.finalize`` all count (the leaked-cursor class);
- ``guarded-by`` — Eraser-style lockset inference: a thread-entry
  index (Thread/Timer targets, executor submits, RPC handler methods,
  finalizer callbacks) plus interprocedural must-alias locksets infer
  each attribute's guard from the lock held at a qualifying majority
  of its mutating sites, then report bare reads/writes from a
  DIFFERENT thread entry, with a check-then-act sub-rule for unlocked
  test-then-mutate on shared containers.

The shared core is alias-aware: single-assignment local rebinds,
``__init__``-typed ``self.*`` attributes, returned-attribute accessors
and call-argument flow all canonicalize to one identity, so lock-order
resolves CROSS-INSTANCE acquisition edges structurally.

Checked-in suppressions live in ``baseline.json`` beside this file
(the package's own ``analysis/baseline.json``; pre-existing, triaged
findings only — the file may only shrink); line-level opt-outs use
``# qlint: ignore[<pass>] <reason>`` for effects that are deliberate.
The trailing reason is MANDATORY: a bare pragma is itself reported by
the always-on framework audit (``pragma/missing-reason``).

CLI: ``python -m trino_tpu_torch.analysis [--json] [--passes a,b]
[--changed-since REV] [path]``. Tier-1 gate:
``tests/test_torch_static_analysis.py`` runs every pass over
``trino_tpu_torch/`` and fails on any non-baselined finding.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional

from .core import Finding, ProjectIndex

__all__ = ["Finding", "ProjectIndex", "PASSES", "run_passes",
           "load_baseline", "apply_baseline", "default_baseline_path"]


def _pass_trace_purity(index):
    from .trace_purity import run
    return run(index)


def _pass_lock_order(index):
    from .lock_order import run
    return run(index)


def _pass_recompile(index):
    from .recompile import run
    return run(index)


def _pass_session_props(index):
    from .session_props import run
    return run(index)


def _pass_taxonomy(index):
    from .taxonomy import run
    return run(index)


def _pass_blocked_protocol(index):
    from .blocked_protocol import run
    return run(index)


def _pass_cache_coherence(index):
    from .cache_coherence import run
    return run(index)


def _pass_resource_lifecycle(index):
    from .resource_lifecycle import run
    return run(index)


def _pass_guarded_by(index):
    from .guarded_by import run
    return run(index)


#: pass slug -> runner(index) -> List[Finding]; slugs are the names
#: used by --passes, pragmas and baseline keys
PASSES = {
    "trace-purity": _pass_trace_purity,
    "lock-order": _pass_lock_order,
    "recompile": _pass_recompile,
    "session-props": _pass_session_props,
    "taxonomy": _pass_taxonomy,
    "blocked-protocol": _pass_blocked_protocol,
    "cache-coherence": _pass_cache_coherence,
    "resource-lifecycle": _pass_resource_lifecycle,
    "guarded-by": _pass_guarded_by,
}


def _audit_pragmas(index: ProjectIndex) -> List[Finding]:
    """Framework-level audit (always on, every run): a ``# qlint:
    ignore[...]`` pragma with no trailing reason is itself a finding —
    a suppression nobody can review is a suppression that outlives its
    justification."""
    findings: List[Finding] = []
    for mod_name in sorted(index.modules):
        mod = index.modules[mod_name]
        ordinals: dict = {}
        for line in sorted(mod.pragmas):
            if mod.pragma_reasons.get(line, ""):
                continue
            passes = ",".join(sorted(mod.pragmas[line]))
            info = mod.enclosing_function(line)
            qual = info.qualname if info is not None else ""
            n = ordinals.get((qual, passes), 0)
            ordinals[(qual, passes)] = n + 1
            findings.append(Finding(
                "pragma", "missing-reason", mod_name, qual, line,
                f"bare `# qlint: ignore[{passes}]` without a trailing "
                f"reason — state WHY the effect is deliberate so the "
                f"suppression stays reviewable",
                f"bare:{passes}:{n}"))
    return findings


def run_passes(index: ProjectIndex,
               passes: Optional[Iterable[str]] = None) -> List[Finding]:
    """Run the selected passes (all by default) plus the always-on
    pragma audit, and return pragma-filtered findings, stable-sorted
    for deterministic output."""
    selected = list(passes) if passes is not None else list(PASSES)
    unknown = [p for p in selected if p not in PASSES]
    if unknown:
        raise ValueError(f"unknown passes {unknown}; "
                         f"expected from {sorted(PASSES)}")
    findings: List[Finding] = []
    for name in selected:
        for f in PASSES[name](index):
            if not index.suppressed(f.module, f.line, f.pass_id):
                findings.append(f)
    findings.extend(_audit_pragmas(index))
    findings.sort(key=lambda f: (f.module, f.line, f.pass_id, f.rule,
                                 f.subject))
    return findings


def default_baseline_path(package_path: str) -> str:
    """The scanned package's own ``analysis/baseline.json`` (for
    ``trino_tpu_torch/``, the file beside this module) — never a
    suppression file outside the package, which could belong to
    another package sharing the parent directory."""
    return os.path.join(os.path.abspath(package_path), "analysis",
                        "baseline.json")


def load_baseline(path: str) -> Dict[str, str]:
    """baseline key -> triage note. Missing file = empty baseline."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    out: Dict[str, str] = {}
    for entry in data.get("findings", ()):
        out[entry["key"]] = entry.get("note", "")
    return out


def apply_baseline(findings: List[Finding], baseline: Dict[str, str]):
    """Split findings into (new, suppressed, stale_keys).

    ``stale_keys`` are baseline entries that no longer fire — the
    baseline is only allowed to shrink, so the gate reports them for
    removal instead of letting dead suppressions accumulate."""
    new: List[Finding] = []
    suppressed: List[Finding] = []
    fired = set()
    for f in findings:
        if f.key in baseline:
            fired.add(f.key)
            suppressed.append(f)
        else:
            new.append(f)
    stale = sorted(k for k in baseline if k not in fired)
    return new, suppressed, stale
