"""taxonomy pass: every failure on the runtime paths is taxonomy-typed.

The retry machinery dispatches on error TYPE (USER fails fast,
infra faults consume the budget, INSUFFICIENT_RESOURCES escalates
memory) — so an untyped failure is not a style problem, it changes
recovery behaviour. Two rules, scoped to ``parallel/``, ``telemetry/``
and the serving cache (``cache.py``) — the three places an erased
error type reaches retry dispatch or silently disables a surface
(``fault.py`` itself is exempt: it defines the vocabulary):

- ``bare-raise``: ``raise RuntimeError(...)`` / ``raise Exception(...)``
  — the coordinator classifies these INTERNAL by default, which makes
  a deterministic condition (aborted task, rejected sink) consume
  retry budget it can never benefit from. Raise ``TrinoError`` with a
  code or ``RemoteTaskError`` with an explicit type instead.
- ``broad-swallow``: an ``except Exception:`` / ``except
  BaseException:`` handler that neither re-raises nor routes the
  exception through the fault vocabulary (``serialize_failure`` /
  ``classify_exception`` / ``RemoteTaskError``) — the failure's type
  is erased exactly where the retry machinery needed it.

Deliberate cases (chaos-harness injected faults, speculative losers)
opt out per line with ``# qlint: ignore[taxonomy] <reason>``.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from .core import Finding, ModuleInfo, ProjectIndex, dotted_chain

PASS_ID = "taxonomy"

_BARE = {"RuntimeError", "Exception"}
_BROAD = {"Exception", "BaseException"}
_FAULT_API = {"serialize_failure", "classify_exception",
              "classify_error_code", "RemoteTaskError",
              "from_response", "is_retryable"}


def _in_scope(name: str) -> bool:
    parts = name.split(".")
    if parts[-1] == "fault":
        return False   # defines the vocabulary
    return ("parallel" in parts[1:] or "telemetry" in parts[1:]
            or parts[-1] == "cache")


def _raised_name(node: ast.Raise) -> Optional[str]:
    exc = node.exc
    if isinstance(exc, ast.Call):
        exc = exc.func
    chain = dotted_chain(exc) if exc is not None else None
    return chain


def _routes_through_fault(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            chain = dotted_chain(node.func)
            if chain and chain.split(".")[-1] in _FAULT_API:
                return True
    return False


def _broad_types(handler: ast.ExceptHandler) -> List[str]:
    t = handler.type
    if t is None:
        return ["<bare except>"]
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    out = []
    for e in elts:
        chain = dotted_chain(e)
        if chain in _BROAD:
            out.append(chain)
    return out


def _enclosing_qualname(mod: ModuleInfo, line: int) -> str:
    info = mod.enclosing_function(line)
    return info.qualname if info is not None else ""


def run(index: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    for name in sorted(index.modules):
        if not _in_scope(name):
            continue
        mod = index.modules[name]
        for node in mod.nodes:
            if isinstance(node, ast.Raise):
                raised = _raised_name(node)
                if raised in _BARE:
                    qual = _enclosing_qualname(mod, node.lineno)
                    findings.append(Finding(
                        PASS_ID, "bare-raise", name, qual,
                        node.lineno,
                        f"bare `raise {raised}` on a parallel-runtime "
                        f"path — classified INTERNAL by default; "
                        f"raise a typed taxonomy error instead",
                        f"raise:{raised}:{qual}:{_stmt_ordinal(mod, node)}"))
            elif isinstance(node, ast.ExceptHandler):
                broad = _broad_types(node)
                if not broad or _routes_through_fault(node):
                    continue
                qual = _enclosing_qualname(mod, node.lineno)
                findings.append(Finding(
                    PASS_ID, "broad-swallow", name, qual,
                    node.lineno,
                    f"`except {broad[0]}` swallows without routing "
                    f"through parallel/fault.py — the failure type "
                    f"is erased where retry dispatch needs it",
                    f"swallow:{broad[0]}:{qual}:{_stmt_ordinal(mod, node)}"))
    return findings


def _stmt_ordinal(mod: ModuleInfo, node: ast.AST) -> int:
    """Ordinal of this finding site among same-kind VIOLATION sites in
    its enclosing function — keeps baseline keys stable across
    unrelated line churn while distinguishing multiple sites in one
    function."""
    qual = _enclosing_qualname(mod, node.lineno)
    ordinal = 0
    for other in mod.nodes:
        if other is node \
                or getattr(other, "lineno", node.lineno) >= node.lineno:
            continue
        if isinstance(node, ast.Raise) and isinstance(other, ast.Raise):
            if _raised_name(other) not in _BARE:
                continue
        elif isinstance(node, ast.ExceptHandler) \
                and isinstance(other, ast.ExceptHandler):
            if not _broad_types(other) or _routes_through_fault(other):
                continue
        else:
            continue
        if _enclosing_qualname(mod, other.lineno) == qual:
            ordinal += 1
    return ordinal
