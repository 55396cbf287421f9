"""``trino_tpu_torch.analysis`` held against the JAX engine's analyzer,
``trino_tpu.analysis``, on the same inputs.

The seven passes that carry over as they are (lock-order, guarded-by,
blocked-protocol, cache-coherence, resource-lifecycle, session-props,
taxonomy) and the core under them must see what the JAX engine's see:

- every fixture source of ``tests/test_static_analysis.py`` and of
  ``tests/test_torch_static_analysis.py`` (read from those files, so a
  fixture added to either is compared too) gives the same findings —
  pass, rule, module, function, line, message and key — and the same
  index facts under both analyzers;
- the port's own tree gives the same findings and the same index
  counts (cached builders, closeables, channels, cross-instance lock
  edges, declared session properties, guards, thread entries).

The two adapted passes (trace-purity, recompile) answer another
question on the port and are held to their own fixtures instead.
"""

import ast
import os
import textwrap

import pytest

import trino_tpu.analysis as ref
import trino_tpu_torch.analysis as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "trino_tpu_torch")

SHARED = ["lock-order", "guarded-by", "blocked-protocol",
          "cache-coherence", "resource-lifecycle", "session-props",
          "taxonomy"]

FIXTURE_FILES = ("test_static_analysis.py",
                 "test_torch_static_analysis.py")


def _literal(node, dedent):
    """A fixture source: a string constant, or ``textwrap.dedent`` of
    one (None for anything computed)."""
    if isinstance(node, ast.Call) and len(node.args) == 1 \
            and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "dedent":
        node, dedent = node.args[0], True
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return textwrap.dedent(node.value) if dedent else node.value
    return None


def _sources(call):
    """{module: source} of an ``index_of(**{...})`` or
    ``ProjectIndex.from_sources({...})`` call, or None."""
    func = call.func
    if isinstance(func, ast.Name) and func.id == "index_of":
        mapping = next((kw.value for kw in call.keywords
                        if kw.arg is None), None)
        dedent = True
    elif isinstance(func, ast.Attribute) and func.attr == "from_sources" \
            and call.args:
        mapping, dedent = call.args[0], False
    else:
        return None
    if not isinstance(mapping, ast.Dict) or not mapping.keys:
        return None
    out = {}
    for k, v in zip(mapping.keys, mapping.values):
        src = _literal(v, dedent)
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)) \
                or src is None:
            return None
        out[k.value] = src
    return out


def _fixture_cases():
    cases = []
    for name in FIXTURE_FILES:
        with open(os.path.join(REPO, "tests", name)) as f:
            tree = ast.parse(f.read())
        for test in tree.body:
            if not isinstance(test, ast.FunctionDef):
                continue
            calls = [n for n in ast.walk(test) if isinstance(n, ast.Call)]
            calls.sort(key=lambda n: (n.lineno, n.col_offset))
            for i, call in enumerate(c for c in calls
                                     if _sources(c) is not None):
                cases.append(pytest.param(
                    _sources(call), id=f"{name[:-3]}::{test.name}[{i}]"))
    return cases


FIXTURES = _fixture_cases()


def _rows(findings):
    return [(f.pass_id, f.rule, f.module, f.qualname, f.line, f.message,
             f.key) for f in findings]


def _facts(pkg, index):
    """The index facts the not-blind floors read, as plain values."""
    from importlib import import_module

    def mod(name):
        return import_module(f"{pkg.__name__}.{name}")

    lo = mod("lock_order").build_lock_graph(index)
    rl = mod("resource_lifecycle")
    closeables = rl.closeable_classes(index)
    sp = mod("session_props")
    registry = sp._registry_module(index)
    guards = mod("guarded_by").analyze(index)
    return {
        "builders": sorted(
            (fid, b.kind) for fid, b in
            mod("cache_coherence").cached_builders(index).items()),
        "closeables": sorted((k, sorted(v)) for k, v in closeables.items()),
        "factories": sorted(rl.closeable_factories(index, closeables)),
        "channels": sorted(mod("blocked_protocol").channel_classes(index)),
        "lock_edges": sorted((a, sorted(b)) for a, b in lo.graph.items()),
        "cross_instance_edges": sorted(lo.cross_instance_edges),
        "properties": None if registry is None
        else sorted(sp._declarations(registry).items()),
        "guards": sorted(guards.guards.items()),
        "exempt": sorted(guards.exempt.items()),
        "thread_entries": sorted(
            (k, e.kind, e.func_id)
            for k, e in mod("core").thread_entries(index).items()),
        "functions": sorted(index.functions),
    }


def _build(pkg, sources):
    try:
        return pkg.ProjectIndex.from_sources(sources), None
    except Exception as e:   # a fixture the index refuses
        return None, type(e).__name__


def test_fixtures_are_found():
    """The extraction sees the fixtures of both files (a rename of the
    helpers would otherwise leave this file comparing nothing)."""
    files = {p.id.split("::")[0] for p in FIXTURES}
    assert files == {n[:-3] for n in FIXTURE_FILES}
    assert len(FIXTURES) >= 120, len(FIXTURES)


@pytest.mark.parametrize("sources", FIXTURES)
def test_shared_passes_match_the_jax_analyzer_on_fixtures(sources):
    ref_index, ref_err = _build(ref, sources)
    port_index, port_err = _build(port, sources)
    assert port_err == ref_err
    if ref_index is None:
        return
    assert _rows(port.run_passes(port_index, SHARED)) \
        == _rows(ref.run_passes(ref_index, SHARED))
    assert _facts(port, port_index) == _facts(ref, ref_index)


@pytest.fixture(scope="module")
def both_over_the_port():
    return (ref.ProjectIndex.from_package(PACKAGE),
            port.ProjectIndex.from_package(PACKAGE))


def test_shared_passes_match_the_jax_analyzer_on_the_port(
        both_over_the_port):
    """The port's tree: the same findings (pragmas applied, baseline
    not) from both analyzers' seven shared passes."""
    ref_index, port_index = both_over_the_port
    assert _rows(port.run_passes(port_index, SHARED)) \
        == _rows(ref.run_passes(ref_index, SHARED))


def test_index_counts_match_the_jax_analyzer_on_the_port(
        both_over_the_port):
    """The port's tree: the same modules, functions, call edges and
    index facts under both analyzers, and the facts are not empty."""
    ref_index, port_index = both_over_the_port
    assert sorted(port_index.modules) == sorted(ref_index.modules)
    assert {fid: [(c.chain, c.target, c.line) for c in f.calls]
            for fid, f in port_index.functions.items()} \
        == {fid: [(c.chain, c.target, c.line) for c in f.calls]
            for fid, f in ref_index.functions.items()}
    got, want = _facts(port, port_index), _facts(ref, ref_index)
    assert got == want
    assert len(got["builders"]) >= 10 and len(got["channels"]) >= 5
    assert len(got["closeables"]) >= 5 and got["cross_instance_edges"]
    assert len(got["properties"]) == 71
