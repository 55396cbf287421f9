"""blocked-protocol pass: the Blocked/listen-token contract the
streaming driver leans on.

The pipelined execution path parks a task only on listen
tokens collected after a no-progress quantum; three structural
mistakes silently break that into a deadlock or a busy spin, and each
is machine-checkable:

- ``channel-contract``: a streaming channel must implement the WHOLE
  ``poll`` / ``at_end`` / ``has_page`` / ``listen`` quartet. A class
  that implements ``poll`` plus only part of the rest duck-types as a
  channel at the planner seam (``hasattr(x, "poll")``) and then
  crashes — or worse, never parks — once the driver blocks on it.
- ``stale-token-park``: a ``blocked_token`` method that returns a
  ``.listen()`` token WITHOUT re-checking readiness (``at_end`` /
  ``has_page`` / ``full``) afterwards. Tokens snapshot a state
  version; state that changed between the last ``poll()`` and the
  ``listen()`` snapshot is invisible to the token, so the task parks
  on a version that may never move again. Snapshot-then-recheck is the
  load-bearing idiom (see ExchangeSourceOperator.blocked_token).
- ``waker-under-lock``: invoking listener callbacks while a lock is
  held. Wakers run arbitrary downstream code (a parked driver's
  re-offer); firing them under the state lock hands that code the
  lock's criticality — the repo-wide idiom is collect-under-lock
  (``fired = self._bump_locked()``), fire AFTER release.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from .core import (FastVisitor, Finding, FunctionInfo, ModuleInfo,
                   ProjectIndex, dotted_chain)

PASS_ID = "blocked-protocol"

#: the streaming channel quartet (ops/output.ExchangeChannel contract)
_QUARTET = ("poll", "at_end", "has_page", "listen")

#: readiness re-checks that make a listen-token snapshot safe to park on
_RECHECKS = {"at_end", "has_page", "full"}

#: iterable names whose elements are waker callbacks
_WAKER_NAMES = ("listener", "callback", "waiter", "waker", "fired")


def _lockish(chain: Optional[str]) -> bool:
    return bool(chain) and "lock" in chain.split(".")[-1].lower()


def _wakerish(chain: Optional[str]) -> bool:
    if not chain:
        return False
    last = chain.split(".")[-1].lower()
    return any(w in last for w in _WAKER_NAMES)


def _class_defs(mod: ModuleInfo) -> Dict[str, ast.ClassDef]:
    return {node.name: node for node in mod.nodes
            if isinstance(node, ast.ClassDef)}


def channel_classes(index: ProjectIndex) -> List[str]:
    """Fully-quartet-implementing channel classes, as ``module:Class``
    — the not-blind witness for the tier-1 gate (a refactor that hides
    the channels from the index would silence the pass)."""
    out: List[str] = []
    for name in sorted(index.modules):
        mod = index.modules[name]
        for cls, node in sorted(_class_defs(mod).items()):
            methods = {s.name for s in node.body
                       if isinstance(s, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))}
            if all(m in methods for m in _QUARTET):
                out.append(f"{name}:{cls}")
    return out


def _check_channel_contract(mod: ModuleInfo,
                            findings: List[Finding]) -> None:
    for name, node in sorted(_class_defs(mod).items()):
        methods = {s.name for s in node.body
                   if isinstance(s, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))}
        present = [m for m in _QUARTET if m in methods]
        # only classes that ENTER the contract are checked: `poll` plus
        # at least one sibling claims channel-ness (a lone unrelated
        # poll() method — e.g. the HTTP protocol's long-poll — is not a
        # streaming channel)
        if "poll" not in methods or len(present) < 2:
            continue
        missing = [m for m in _QUARTET if m not in methods]
        if missing:
            findings.append(Finding(
                PASS_ID, "channel-contract", mod.name, name,
                node.lineno,
                f"class {name} implements {present} but not "
                f"{missing}: a partial streaming channel duck-types at "
                f"the planner seam and breaks the driver's "
                f"Blocked/park loop",
                f"contract:{name}:{','.join(missing)}"))


def _check_stale_token(mod: ModuleInfo, func: FunctionInfo,
                       findings: List[Finding]) -> None:
    if func.qualname.split(".")[-1] != "blocked_token":
        return
    listens = [c for c in func.calls
               if c.chain.split(".")[-1] == "listen"]
    if not listens:
        return
    rechecks = any(c.chain.split(".")[-1] in _RECHECKS
                   for c in func.calls)
    if not rechecks:
        findings.append(Finding(
            PASS_ID, "stale-token-park", func.module, func.qualname,
            listens[0].line,
            "blocked_token returns a listen() token without re-checking "
            "readiness (at_end/has_page/full) after the snapshot: state "
            "that moved between poll() and listen() is invisible to the "
            "token, so the task can park forever",
            f"stale:{func.qualname}"))


class _WakerVisitor(FastVisitor):
    """Track lexically-held locks and for-targets bound from waker
    collections; flag waker calls made while a lock is held."""

    def __init__(self, mod: ModuleInfo, func: FunctionInfo,
                 findings: List[Finding]):
        self.mod = mod
        self.func = func
        self.findings = findings
        self._held = 0
        self._waker_names: Set[str] = set()

    def visit_With(self, node: ast.With):
        locked = any(_lockish(dotted_chain(i.context_expr))
                     for i in node.items)
        if locked:
            self._held += 1
        for stmt in node.body:
            self.visit(stmt)
        if locked:
            self._held -= 1

    visit_AsyncWith = visit_With

    @staticmethod
    def _target_names(target) -> List[str]:
        if isinstance(target, ast.Name):
            return [target.id]
        if isinstance(target, (ast.Tuple, ast.List)):
            return [e.id for e in target.elts
                    if isinstance(e, ast.Name)]
        return []

    def visit_For(self, node: ast.For):
        names = self._target_names(node.target) \
            if _wakerish(dotted_chain(node.iter)) else []
        self._waker_names.update(names)
        self.generic_visit(node)
        self._waker_names.difference_update(names)

    def visit_Call(self, node: ast.Call):
        if self._held:
            name = node.func.id if isinstance(node.func, ast.Name) \
                else None
            chain = dotted_chain(node.func)
            if (name in self._waker_names) or \
                    (chain and chain.split(".")[-1] == "on_ready"):
                self.findings.append(Finding(
                    PASS_ID, "waker-under-lock", self.func.module,
                    self.func.qualname, node.lineno,
                    f"waker callback `{chain or name}()` fired while a "
                    f"lock is held: the parked task's re-offer runs "
                    f"under the state lock (collect under the lock, "
                    f"fire after release)",
                    f"waker:{self.func.qualname}:{chain or name}"))
        self.generic_visit(node)

    def visit_FunctionDef(self, node):
        if node is not self.func.node:
            return  # nested def: analyzed via its own FunctionInfo
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef


def run(index: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    for name in sorted(index.modules):
        _check_channel_contract(index.modules[name], findings)
    for func in index.iter_functions():
        mod = index.modules[func.module]
        _check_stale_token(mod, func, findings)
        v = _WakerVisitor(mod, func, findings)
        for stmt in func.body:
            v.visit(stmt)
    return findings
