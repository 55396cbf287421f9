"""cache-coherence pass: every mutable input a cached builder reads
must be represented in its cache key.

The bug class of the exchange's ``min_collectives`` knob and of the
session fingerprint: a memoized builder (an ``lru_cache``'d program
builder, a get-or-build memo dict like ``mesh_query._PROGRAM_CACHE``,
``ProcessorCache.get``, ``QueryCache.parse``, the sizing histories)
reads state that can CHANGE between calls — a session property, an
environment variable, a rebindable module global — without that state
being part of the key it is memoized under. The first caller's setting
is baked into the cached value and every later caller silently gets
it. The fix is always the same: hoist the read into the key
(parameters for ``lru_cache``, the key tuple for memo dicts) — which
also makes the finding disappear, because the read moves to the
caller.

Builders are indexed two ways (``cached_builders``):

- ``lru``: ``functools.lru_cache`` / ``functools.cache`` decorated
  functions — the whole parameter list is the key;
- ``memo``: a function that BOTH loads (``D.get(k)`` / ``D[k]``) and
  stores (``D[k] = v`` / ``D.setdefault``) through one container
  reached from ``self.*`` or a module-level name — the hand-rolled
  get-or-build idiom.

From every builder the pass walks resolved call-graph edges (stopping
at other builders: their reads are their own findings) and flags:

- ``unkeyed-session-read``: ``SP.value`` / ``prop_value`` /
  session-property reads (subsumes and extends the old recompile rule
  to memo builders and interprocedural reach);
- ``unkeyed-env-read``: ``os.environ`` / ``os.getenv`` reads — env
  mutates at runtime (tests, workers) but never re-keys the cache;
- ``unkeyed-global-read``: reads of a module global some function
  REBINDS via ``global X`` — the one mutable-global shape that is
  provably not constant.

Deliberate trace-static reads opt out per line with
``# qlint: ignore[cache-coherence] <reason>``.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from .core import (Finding, FunctionInfo, ModuleInfo, ProjectIndex,
                   dotted_chain, own_nodes)
from .recompile import _cached_functions

PASS_ID = "cache-coherence"

_SESSION_READ_LASTS = {"value", "prop_value"}


@dataclass
class BuilderInfo:
    func: FunctionInfo
    kind: str                     # "lru" | "memo"
    container: Optional[str] = None   # memo: the container chain


def _container_base_ok(mod: ModuleInfo, func: FunctionInfo,
                       chain: str) -> bool:
    """A memo container must outlive the call: ``self.*`` state or a
    module-level binding (a local dict rebuilt per call caches
    nothing)."""
    head = chain.split(".")[0]
    if head in ("self", "cls"):
        return True
    return head in mod.module_assigns or head in mod.scopes.get("", {})


def cached_builders(index: ProjectIndex) -> Dict[str, BuilderInfo]:
    """Every memoizing builder in the package, keyed by function id —
    also the not-blind witness the tier-1 gate asserts over (an engine
    where the caches went invisible would gut the pass)."""
    out: Dict[str, BuilderInfo] = {}
    # the shared lru index lives in recompile (its unhashable-arg rule
    # keys off the same decorator set — one vocabulary, two passes)
    for fid, func in _cached_functions(index).items():
        out[fid] = BuilderInfo(func, "lru")
    for func in index.iter_functions():
        if func.id in out:
            continue
        mod = index.modules[func.module]
        loads: Set[str] = set()
        #: container -> saw at least one NON-read-modify-write store
        #: (a store whose value re-reads the same container is an
        #: accumulator — `d[k] = d.get(k, 0) + 1` refcounts/EWMAs
        #: cache nothing and must not classify as builders)
        build_stores: Set[str] = set()
        for node in own_nodes(func.node):
            if isinstance(node, ast.Call):
                chain = dotted_chain(node.func)
                if chain is None:
                    continue
                parts = chain.split(".")
                if len(parts) < 2:
                    continue
                base = ".".join(parts[:-1])
                if parts[-1] == "get" and node.args:
                    loads.add(base)
                elif parts[-1] == "setdefault" and len(node.args) >= 2:
                    if not _reads_container(node.args[1], base):
                        build_stores.add(base)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Subscript):
                        base = dotted_chain(t.value)
                        if base is not None and \
                                not _reads_container(node.value, base):
                            build_stores.add(base)
            elif isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, ast.Load):
                base = dotted_chain(node.value)
                if base is not None:
                    loads.add(base)
        for base in sorted(loads & build_stores):
            base_c = index.canonical_chain(func, base)
            if _container_base_ok(mod, func, base_c):
                out[func.id] = BuilderInfo(func, "memo", base_c)
                break
    return out


def _reads_container(value: ast.AST, base: str) -> bool:
    """True when ``value`` re-reads ``base`` (``d.get(k)`` /
    ``d[k]`` / a bare reference) — the store is then read-modify-write
    accumulation, not get-or-build."""
    for node in ast.walk(value):
        chain = None
        if isinstance(node, (ast.Attribute, ast.Name)):
            chain = dotted_chain(node)
        if chain == base:
            return True
    return False


def _mutated_globals(index: ProjectIndex) -> Dict[str, Set[str]]:
    """module -> names some function rebinds via ``global X; X = ...``
    — the one provably-mutable module-global shape."""
    out: Dict[str, Set[str]] = {}
    for name, mod in index.modules.items():
        muted: Set[str] = set()
        for func in mod.functions.values():
            declared: Set[str] = set()
            for node in own_nodes(func.node):
                if isinstance(node, ast.Global):
                    declared.update(node.names)
            if not declared:
                continue
            for node in own_nodes(func.node):
                targets = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    targets = [node.target]
                for t in targets:
                    if isinstance(t, ast.Name) and t.id in declared:
                        muted.add(t.id)
        if muted:
            out[name] = muted
    return out


def _env_read(node: ast.AST) -> Optional[str]:
    """The env-var name (or "<dynamic>") when ``node`` reads the
    process environment."""
    chain = None
    args: Tuple = ()
    if isinstance(node, ast.Call):
        chain = dotted_chain(node.func)
        args = tuple(node.args)
        if chain is None:
            return None
        if chain in ("os.getenv", "getenv"):
            pass
        elif chain.split(".")[-2:] == ["environ", "get"]:
            pass
        else:
            return None
    elif isinstance(node, ast.Subscript) \
            and isinstance(node.ctx, ast.Load):
        chain = dotted_chain(node.value)
        if chain is None or chain.split(".")[-1] != "environ":
            return None
        args = (node.slice,)
    else:
        return None
    for a in args:
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            return a.value
    return "<dynamic>"


def _session_read(call_chain: str, target: Optional[str]) -> bool:
    resolved = target or ""
    if resolved.endswith((":value", ":prop_value")) \
            and "session_properties" in resolved:
        return True
    if call_chain.split(".")[-1] in _SESSION_READ_LASTS:
        head = call_chain.split(".")[0]
        return head in ("SP", "session_properties")
    return False


def _const_arg(call: ast.Call) -> str:
    for a in call.args:
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            return a.value
    return ""


def _keyed_reads(index: ProjectIndex, builder: BuilderInfo) -> Set[int]:
    """``id()`` of every AST node inside the builder's own body whose
    value flows into the memo KEY: a read that IS part of the key is
    coherent by construction (`flavor = os.environ.get(...); k =
    (key, flavor); d.get(k)` — the prescribed fix for an lru builder
    is hoisting the read into the key; for a memo builder the read
    necessarily stays inside get-or-build, so the pass must recognize
    it there). Name flow closes transitively through single-name
    assignments, bounded."""
    if builder.kind != "memo" or builder.container is None:
        return set()
    func = builder.func
    # names appearing inside the container's get/subscript key exprs;
    # the container chain is matched CANONICALLY (a local alias
    # `d = self._programs; d.get(k)` names the same container)
    keyed: Set[str] = set()
    key_exprs: List[ast.AST] = []
    for node in own_nodes(func.node):
        if isinstance(node, ast.Call):
            chain = dotted_chain(node.func)
            if chain is not None and "." in chain \
                    and index.canonical_chain(
                        func, chain.rsplit(".", 1)[0]) \
                    == builder.container \
                    and chain.split(".")[-1] in ("get", "setdefault") \
                    and node.args:
                key_exprs.append(node.args[0])
        elif isinstance(node, ast.Subscript):
            base = dotted_chain(node.value)
            if base is not None and \
                    index.canonical_chain(func, base) \
                    == builder.container:
                key_exprs.append(node.slice)
    out: Set[int] = set()
    for e in key_exprs:
        for n in ast.walk(e):
            # a read INLINE in the key expression is keyed directly
            out.add(id(n))
            if isinstance(n, ast.Name):
                keyed.add(n.id)
    # transitive closure through plain-name assignments, then collect
    # the node ids of every value expression feeding a keyed name
    assigns = [n for n in own_nodes(func.node)
               if isinstance(n, ast.Assign) and len(n.targets) == 1
               and isinstance(n.targets[0], ast.Name)]
    for _ in range(5):
        grew = False
        for a in assigns:
            if a.targets[0].id in keyed:
                for n in ast.walk(a.value):
                    if isinstance(n, ast.Name) and n.id not in keyed:
                        keyed.add(n.id)
                        grew = True
        if not grew:
            break
    for a in assigns:
        if a.targets[0].id in keyed:
            for n in ast.walk(a.value):
                out.add(id(n))
    return out


def run(index: ProjectIndex) -> List[Finding]:
    builders = cached_builders(index)
    mutated = _mutated_globals(index)
    findings: List[Finding] = []
    seen: Set[Tuple[str, str, str]] = set()

    def emit(builder: BuilderInfo, func: FunctionInfo, rule: str,
             line: int, what: str, subject: str):
        key = (builder.func.id, rule, subject)
        if key in seen:
            return
        seen.add(key)
        via = "" if func.id == builder.func.id else \
            f" (reached from cached builder {builder.func.qualname})"
        keyname = "its parameters" if builder.kind == "lru" \
            else f"the `{builder.container}` key"
        findings.append(Finding(
            PASS_ID, rule, func.module, func.qualname, line,
            f"{builder.kind}-cached `{builder.func.qualname}` reads "
            f"{what}{via} without it being part of {keyname} — the "
            f"first caller's value is baked into the cached entry",
            subject))

    for fid in sorted(builders):
        builder = builders[fid]
        keyed = _keyed_reads(index, builder)
        stack = [fid]
        visited: Set[str] = set()
        while stack:
            cur = stack.pop()
            if cur in visited:
                continue
            visited.add(cur)
            if cur != fid and cur in builders:
                continue   # a nested builder owns its own reads
            func = index.functions.get(cur)
            if func is None:
                continue
            mod = index.modules[func.module]
            for call in func.calls:
                if _session_read(call.chain, call.target):
                    if cur == fid and id(call.node) in keyed:
                        continue   # the read IS part of the memo key
                    prop = _const_arg(call.node)
                    emit(builder, func, "unkeyed-session-read",
                         call.line,
                         f"session property "
                         f"{prop or '<dynamic>'!r}",
                         f"session:{prop or call.chain}")
                elif call.target and call.target in index.functions:
                    stack.append(call.target)
            for node in own_nodes(func.node):
                env = _env_read(node)
                if env is not None:
                    if cur == fid and id(node) in keyed:
                        continue   # the read IS part of the memo key
                    emit(builder, func, "unkeyed-env-read",
                         node.lineno,
                         f"environment variable {env!r}",
                         f"env:{env}")
                    continue
                if isinstance(node, ast.Name) \
                        and isinstance(node.ctx, ast.Load) \
                        and node.id in mutated.get(func.module, ()):
                    if cur == fid and id(node) in keyed:
                        continue   # the read IS part of the memo key
                    if node.id == builder.container:
                        # the builder's OWN container: a lazily-
                        # initialized/resettable `global _CACHE` is
                        # the cache, not an input missing from its key
                        continue
                    emit(builder, func, "unkeyed-global-read",
                         node.lineno,
                         f"mutable module global `{node.id}` "
                         f"(rebound via `global` elsewhere)",
                         f"global:{func.module}.{node.id}")
    return findings
