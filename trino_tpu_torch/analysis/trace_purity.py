"""trace-purity pass: no host effect inside a device program whose
hazard survives eager execution.

What a device program is in eager torch. The JAX engine stages its
programs out (``jax.jit`` / ``shard_map`` / ``pl.pallas_call``); the
torch engine runs them eagerly, and its counterparts of those entries
are:

- every function registered with the program profiler,
  ``telemetry.profiler.instrument("name", fn, ...)`` — module-level
  rebinds (``kernel = instrument("k", kernel)``), bound methods
  (``instrument("page_processor", self._run)``), nested defs a builder
  returns (``instrument("mesh_q1_stage1", q1_stage1_fn(...))`` resolves
  one hop, to the def every return of the builder names), and calls of
  registration facades (a function forwarding its own parameters as
  ``instrument``'s name and program). Kind ``program``; kind
  ``pallas`` when the registration says ``kernel=True``: that entry
  makes the hand-written CUDA kernel's library call, the counterpart
  of ``pl.pallas_call``;
- every function handed to ``jit_stats.CountedProgram(name, fn, ...)``.

``static_argnames`` of either registration are the program's static
arguments, as a jit entry's are.

From every entry the pass walks resolved call-graph edges and flags,
at any reachable function, the effects whose hazard remains in eager
code — the JAX engine's reason ("the body runs once per trace, not per
call") does not hold here, so spans, metrics, ``print`` and ``time.*``
are no longer findings:

- ``lock-in-program``: lock acquisition — the host thread holds (or
  waits for) the lock while the program's launches are queued behind
  it;
- ``host-io``: file/socket/process IO — the same stall, longer;
- ``host-rng``: the process-global RNGs (``random.*``,
  ``np.random.*``, ``torch.rand*`` / ``torch.manual_seed`` without an
  explicit ``generator=``) — the engine's rule is explicit generators,
  so a program's draws never depend on who drew before it;
- ``stats-store-write``: a history-store write (``record_query`` /
  ``record_actuals``) inside a program fires per page, not per query;
- ``host-mutation``: a subscript store into an entry's parameter —
  an in-place write into the caller's tensor.

``jit_stats.bump`` stays allowlisted for the reason it has in the JAX
engine. Any other deliberate effect carries a reasoned
``# qlint: ignore[trace-purity] <reason>`` on its line, as the kernel
wrapper's launch counter and its recording lock do; a call on such a
line is not walked into either, so the kernel's load-once
(``_library()``: the build and load on a process's first launch, the
counterpart of a jitted program's compile on its first trace) is one
pragma at its call, not one per effect of the build.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .core import (Finding, FunctionInfo, ModuleInfo, ProjectIndex,
                   dotted_chain, own_nodes)

PASS_ID = "trace-purity"

#: registrations that make a function a device program: the profiler's
#: ``instrument(name, fn, key, static_argnames, flops, kernel, ...)``
#: and ``jit_stats.CountedProgram(name, fn, static_argnames, ...)``;
#: leaf -> (program position, static_argnames position)
_REGISTRATIONS = {"instrument": (1, 3), "CountedProgram": (1, 2)}
_PARTIAL_CHAINS = {"partial", "functools.partial"}

#: the designed record inside programs (see the module docstring)
_ALLOWED_CALLS = {"jit_stats.bump"}


@dataclass
class EntryInfo:
    """One device program and how it was registered."""
    func: FunctionInfo
    kind: str                      # program | pallas
    static_params: Set[str] = field(default_factory=set)


def _static_names(node: Optional[ast.expr]) -> Set[str]:
    if isinstance(node, (ast.Tuple, ast.List)):
        return {e.value for e in node.elts
                if isinstance(e, ast.Constant)
                and isinstance(e.value, str)}
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    return set()


def _arg(call: ast.Call, pos: int, name: str) -> Optional[ast.expr]:
    """The expression bound to parameter ``name`` (position ``pos``)."""
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    if len(call.args) > pos \
            and not any(isinstance(a, ast.Starred)
                        for a in call.args[:pos + 1]):
        return call.args[pos]
    return None


def _is_true(node: Optional[ast.expr]) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


@dataclass
class _Facade:
    """A function registering its own parameters: ``name_pos`` /
    ``fn_pos`` are the positions of the parameters it forwards as
    ``instrument``'s name / program (None when the program is fixed)."""
    name_pos: int
    fn_pos: Optional[int]
    kind: str
    statics: Set[str]


def _facades(index: ProjectIndex) -> Dict[str, _Facade]:
    """Registration facades by def name: a function whose body forwards
    its own parameter as ``instrument()``'s name — e.g. a
    ``_batched_kernel(name, fn)`` wrapping every batched kernel. Calls
    of a facade with a CONSTANT name register that name (one-hop
    dataflow), so the not-blind floor pins literal names instead of
    going blind behind the helper."""
    out: Dict[str, _Facade] = {}
    for func in index.iter_functions():
        params = [a.arg for a in func.node.args.args]
        for site in func.calls:
            if site.chain.split(".")[-1] != "instrument":
                continue
            call = site.node
            name = _arg(call, 0, "name")
            if not (isinstance(name, ast.Name) and name.id in params):
                continue
            fn = _arg(call, 1, "fn")
            fn_pos = params.index(fn.id) \
                if isinstance(fn, ast.Name) and fn.id in params else None
            out[func.node.name] = _Facade(
                params.index(name.id), fn_pos,
                "pallas" if _is_true(_arg(call, 5, "kernel"))
                else "program",
                _static_names(_arg(call, 3, "static_argnames")))
    return out


def profiled_entries(index: ProjectIndex) -> Dict[str, List[str]]:
    """Program names registered with the profiler (``instrument("name",
    ...)`` call forms, facades resolved), keyed by name with the
    registering module(s) as values — the not-blind witness that the
    cost registry covers the engine's programs (a renamed wrapper or a
    dropped ``instrument()`` call would silently blind EXPLAIN ANALYZE
    VERBOSE and ``system.runtime.kernels``)."""
    out: Dict[str, List[str]] = {}
    facades = _facades(index)
    for mod_name in sorted(index.modules):
        mod = index.modules[mod_name]
        # the whole module tree: most registrations are module-level
        # rebinds, which live outside any FunctionInfo
        for node in mod.nodes:
            if not isinstance(node, ast.Call):
                continue
            chain = dotted_chain(node.func)
            if chain is None:
                continue
            leaf = chain.split(".")[-1]
            if leaf == "instrument":
                name = _arg(node, 0, "name")
            elif leaf in facades:
                name = _arg(node, facades[leaf].name_pos, "name")
            else:
                continue
            if isinstance(name, ast.Constant) \
                    and isinstance(name.value, str):
                out.setdefault(name.value, []).append(mod_name)
    return out


def recording_sites(index: ProjectIndex) -> Dict[str, List[str]]:
    """Call sites of the history-store write path (``record_query`` /
    ``record_actuals``), keyed by called chain with the calling
    function ids as values — the not-blind witness that actuals
    recording exists in the index AND (asserted in tests) stays outside
    every program-reachable function."""
    out: Dict[str, List[str]] = {}
    for mod_name in sorted(index.modules):
        mod = index.modules[mod_name]
        for qual in sorted(mod.functions):
            info = mod.functions[qual]
            for call in info.calls:
                last = call.chain.split(".")[-1]
                if last in ("record_query", "record_actuals"):
                    out.setdefault(call.chain, []).append(info.id)
    return out


def _returned_function(index: ProjectIndex,
                       builder: FunctionInfo) -> Optional[str]:
    """The function every ``return`` of ``builder`` names (a nested
    def or any resolvable function), or None when they disagree."""
    mod = index.modules[builder.module]
    hits: Set[Optional[str]] = set()
    for node in own_nodes(builder.node):
        if isinstance(node, ast.Return):
            chain = dotted_chain(node.value) \
                if node.value is not None else None
            hits.add(index.resolve(mod, builder, chain)
                     if chain is not None else None)
    if len(hits) != 1:
        return None
    hit = hits.pop()
    return hit if hit in index.functions else None


def _resolve_program(index: ProjectIndex, mod: ModuleInfo,
                     info: Optional[FunctionInfo],
                     expr: Optional[ast.expr]) -> Optional[str]:
    """Function id of the program expression handed to a
    registration: a name/attribute chain, ``partial(f, ...)``, or a
    builder call whose returns all name one function."""
    while isinstance(expr, ast.Call) \
            and dotted_chain(expr.func) in _PARTIAL_CHAINS and expr.args:
        expr = expr.args[0]
    if isinstance(expr, ast.Call):
        chain = dotted_chain(expr.func)
        builder = index.resolve(mod, info, chain) \
            if chain is not None else None
        if builder not in index.functions:
            return None
        return _returned_function(index, index.functions[builder])
    chain = dotted_chain(expr) if expr is not None else None
    if chain is None:
        return None
    target = index.resolve(mod, info, chain)
    return target if target in index.functions else None


def program_entries(index: ProjectIndex) -> Dict[str, EntryInfo]:
    """Every device program in the project, keyed by function id (see
    the module docstring). Shared with the recompile pass (host-sync
    needs the same entry set plus each entry's static parameters)."""
    entries: Dict[str, EntryInfo] = {}
    facades = _facades(index)
    for mod_name in sorted(index.modules):
        mod = index.modules[mod_name]
        for node in mod.nodes:
            if not isinstance(node, ast.Call):
                continue
            chain = dotted_chain(node.func)
            if chain is None:
                continue
            leaf = chain.split(".")[-1]
            if leaf in _REGISTRATIONS:
                fn_pos, static_pos = _REGISTRATIONS[leaf]
                fn = _arg(node, fn_pos, "fn")
                statics = _static_names(
                    _arg(node, static_pos, "static_argnames"))
                kind = "pallas" if leaf == "instrument" \
                    and _is_true(_arg(node, 5, "kernel")) else "program"
            elif leaf in facades and facades[leaf].fn_pos is not None:
                facade = facades[leaf]
                fn = _arg(node, facade.fn_pos, "fn")
                statics, kind = facade.statics, facade.kind
            else:
                continue
            info = mod.enclosing_function(node.lineno)
            target = _resolve_program(index, mod, info, fn)
            if target is not None and target not in entries:
                entries[target] = EntryInfo(index.functions[target],
                                            kind, statics)
    return entries


def program_reachable(index: ProjectIndex,
                      entries: Optional[Dict[str, EntryInfo]] = None
                      ) -> Dict[str, str]:
    """Every function id reachable from a device program over resolved
    call edges, mapped to one entry that reaches it (the first in
    sorted order) — the set the purity and host-sync findings walk,
    and the set the stats-store write path must stay OUT of."""
    if entries is None:
        entries = program_entries(index)
    reached: Dict[str, str] = {}
    for fid in sorted(entries):
        stack = [fid]
        while stack:
            cur = stack.pop()
            if cur in reached:
                continue
            reached[cur] = fid
            func = index.functions.get(cur)
            if func is None:
                continue
            for call in func.calls:
                # an allowlisted or pragma'd call's own body is its
                # business
                if call.chain in _ALLOWED_CALLS \
                        or index.suppressed(func.module, call.line,
                                            PASS_ID):
                    continue
                if call.target and call.target in index.functions:
                    stack.append(call.target)
    return reached


# -- impurity tables -----------------------------------------------------

_IO_EXACT = {"open", "input"}
_IO_PREFIXES = ("os.", "socket.", "subprocess.", "shutil.", "io.")
#: torch draws from the process-global generator unless given one
_TORCH_RNG = {"rand", "randn", "randint", "randperm", "rand_like",
              "randn_like", "randint_like", "bernoulli", "multinomial",
              "normal", "poisson"}
_TORCH_SEEDS = {"torch.manual_seed", "torch.seed",
                "torch.cuda.manual_seed", "torch.cuda.manual_seed_all"}
#: numpy's explicit-generator constructors are the prescribed form
_NP_EXPLICIT = {"default_rng", "Generator", "SeedSequence", "PCG64",
                "Philox"}


def _classify_call(chain: str, call: ast.Call
                   ) -> Optional[Tuple[str, str]]:
    """(rule, description) when the called chain is a host effect."""
    parts = chain.split(".")
    last = parts[-1]
    if chain in _IO_EXACT or chain.startswith(_IO_PREFIXES):
        return "host-io", ("file/socket/process IO inside a device "
                           "program holds the host thread while its "
                           "launches wait")
    if last == "acquire" or (len(parts) > 1 and _lockish(parts[-2])):
        return "lock-in-program", ("lock acquisition inside a device "
                                   "program: the launches queue "
                                   "behind the lock")
    if parts[0] == "random" or (chain.startswith(("np.random.",
                                                  "numpy.random."))
                                and last not in _NP_EXPLICIT):
        return "host-rng", ("the process-global RNG inside a device "
                            "program: draws depend on every earlier "
                            "caller (use an explicit generator)")
    if chain in _TORCH_SEEDS or (
            parts[0] == "torch" and len(parts) == 2
            and last in _TORCH_RNG
            and not any(kw.arg == "generator" for kw in call.keywords)):
        return "host-rng", ("torch's global generator inside a device "
                            "program: pass an explicit generator=")
    if last in ("record_query", "record_actuals"):
        return "stats-store-write", ("history-store write inside a "
                                     "device program fires per call, "
                                     "not per query")
    return None


def _lockish(name: str) -> bool:
    """A lock's name: ``lock`` / ``rlock`` / ``mutex`` as one of its
    underscore-separated words (``_count_lock``, ``lock``), never as a
    substring (``block_of`` is a dict)."""
    return bool({"lock", "rlock", "mutex"}
                & set(name.lower().split("_")))


def _with_lockish(stmt: ast.With) -> Optional[str]:
    for item in stmt.items:
        chain = dotted_chain(item.context_expr)
        if chain and _lockish(chain.split(".")[-1]):
            return chain
    return None


def _param_store_targets(func: FunctionInfo) -> List[ast.AST]:
    """Subscript stores into the function's own parameters —
    ``t[i] = x`` on a program's argument writes into the caller's
    tensor."""
    params = set(func.params)
    hits: List[ast.AST] = []
    for node in own_nodes(func.node):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AugAssign):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Subscript) \
                    and isinstance(t.value, ast.Name) \
                    and t.value.id in params:
                hits.append(t)
    return hits


def run(index: ProjectIndex) -> List[Finding]:
    entries = program_entries(index)
    reached_via = program_reachable(index, entries)
    findings: List[Finding] = []
    seen: Set[Tuple[str, str]] = set()
    for cur in sorted(reached_via):
        func = index.functions.get(cur)
        if func is None:
            continue
        entry = entries[reached_via[cur]].func
        via = "" if cur == entry.id \
            else f" (reached from program {entry.qualname})"
        for call in func.calls:
            if call.chain in _ALLOWED_CALLS:
                continue
            hit = _classify_call(call.chain, call.node)
            if hit is None:
                continue
            rule, why = hit
            key = (cur, f"{rule}:{call.chain}")
            if key in seen:
                continue
            seen.add(key)
            findings.append(Finding(
                PASS_ID, rule, func.module, func.qualname, call.line,
                f"`{call.chain}()` inside a device program{via}: {why}",
                f"{call.chain}"))
        for node in own_nodes(func.node):
            if isinstance(node, ast.With):
                chain = _with_lockish(node)
                if chain is None:
                    continue
                key = (cur, f"lock-in-program:{chain}")
                if key in seen:
                    continue
                seen.add(key)
                findings.append(Finding(
                    PASS_ID, "lock-in-program", func.module,
                    func.qualname, node.lineno,
                    f"`with {chain}:` inside a device program{via}: "
                    f"the launches queue behind the lock",
                    f"with:{chain}"))
        if cur in entries:
            for t in _param_store_targets(func):
                name = t.value.id  # type: ignore[attr-defined]
                key = (cur, f"param-store:{name}")
                if key in seen:
                    continue
                seen.add(key)
                findings.append(Finding(
                    PASS_ID, "host-mutation", func.module,
                    func.qualname, t.lineno,
                    f"subscript store into program parameter "
                    f"`{name}` writes into the caller's tensor",
                    f"store:{name}"))
    return findings
