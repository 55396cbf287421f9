"""Memo + iterative rule engine: exploration-based plan optimization.

Reference analog: ``sql/planner/iterative/IterativeOptimizer.java:66,129``
(the per-group fixpoint: exploreNode until no rule fires, explore
children, re-explore the node if a child changed), ``Memo.java:64``
(groups + GroupReference indirection so rules rewrite ONE group without
copying the whole tree) and ``lib/trino-matching/.../Pattern.java`` (the
tiny pattern DSL rules declare their shapes with). The ~221 reference
rules compress here to the load-bearing set (planner/rules.py).

Differences kept deliberately: no group deduplication or GC (plans here
are small — thousands of nodes, not millions), and rule matching indexes
on the root node class only, with source patterns checked through the
Lookup at apply time.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Type

from .plan import PlanNode
from .symbols import Symbol


class GroupReference(PlanNode):
    """Stand-in child pointing at a memo group (reference:
    iterative/GroupReference.java). Rules treat it as an opaque leaf;
    the Lookup resolves it when a rule's pattern needs the child."""

    __slots__ = ("group_id", "_symbols")

    def __init__(self, group_id: int, symbols: Sequence[Symbol]):
        self.group_id = group_id
        self._symbols = list(symbols)

    @property
    def sources(self) -> List[PlanNode]:
        return []

    @property
    def output_symbols(self) -> List[Symbol]:
        return list(self._symbols)

    def __repr__(self):
        return f"GroupRef({self.group_id})"

    def __eq__(self, other):
        return isinstance(other, GroupReference) and \
            other.group_id == self.group_id

    def __hash__(self):
        return hash(("group", self.group_id))


def _replace_sources(node: PlanNode, sources: List[PlanNode]) -> PlanNode:
    from .optimizer import _replace_sources as impl

    return impl(node, sources)


class Memo:
    """Group table: group id -> current representative node whose
    children are GroupReferences (reference: Memo.java:64)."""

    def __init__(self):
        self.groups: Dict[int, PlanNode] = {}
        self.versions: Dict[int, int] = {}
        self._next = 0

    def insert(self, node: PlanNode) -> int:
        gid = self._next
        self._next += 1
        self.groups[gid] = self._groupify(node)
        self.versions[gid] = 0
        return gid

    def _groupify(self, node: PlanNode) -> PlanNode:
        """Replace concrete children with group references, inserting
        new subtrees as new groups."""
        if isinstance(node, GroupReference):
            return node
        srcs = node.sources
        if not srcs:
            return node
        new_srcs = [s if isinstance(s, GroupReference)
                    else GroupReference(self.insert(s), s.output_symbols)
                    for s in srcs]
        if all(a is b for a, b in zip(new_srcs, srcs)):
            return node
        return _replace_sources(node, new_srcs)

    def node(self, gid: int) -> PlanNode:
        return self.groups[gid]

    def replace(self, gid: int, node: PlanNode):
        self.groups[gid] = self._groupify(node)
        self.versions[gid] += 1

    def extract(self, node: PlanNode) -> PlanNode:
        """Concrete plan: resolve every group reference recursively."""
        if isinstance(node, GroupReference):
            return self.extract(self.groups[node.group_id])
        srcs = node.sources
        if not srcs:
            return node
        return _replace_sources(node, [self.extract(s) for s in srcs])


class Lookup:
    """Rule-side resolution of group references (reference:
    iterative/Lookup.java)."""

    def __init__(self, memo: Memo):
        self.memo = memo

    def resolve(self, node: PlanNode) -> PlanNode:
        while isinstance(node, GroupReference):
            node = self.memo.node(node.group_id)
        return node


class Pattern:
    """Minimal pattern DSL (reference: lib/trino-matching Pattern):
    node class + optional predicate + optional source sub-pattern, the
    source being matched THROUGH the lookup."""

    def __init__(self, node_cls: Tuple[Type, ...],
                 where: Optional[Callable[[PlanNode], bool]] = None,
                 source: Optional["Pattern"] = None):
        self.node_cls = node_cls if isinstance(node_cls, tuple) \
            else (node_cls,)
        self.where = where
        self.source = source

    def with_source(self, source: "Pattern") -> "Pattern":
        return Pattern(self.node_cls, self.where, source)

    def matching(self, where) -> "Pattern":
        return Pattern(self.node_cls, where, self.source)

    def matches(self, node: PlanNode, lookup: Lookup) -> bool:
        if not isinstance(node, self.node_cls):
            return False
        if self.where is not None and not self.where(node):
            return False
        if self.source is not None:
            srcs = node.sources
            if len(srcs) != 1:
                return False
            return self.source.matches(lookup.resolve(srcs[0]), lookup)
        return True


class Rule:
    """One transformation (reference: iterative/Rule.java). ``apply``
    returns a replacement node (children may be the matched node's
    GroupReferences, or fresh subtrees) or None when it does not fire."""

    name = "rule"
    pattern: Pattern

    def apply(self, node: PlanNode, ctx: "RuleContext"
              ) -> Optional[PlanNode]:
        raise NotImplementedError


class RuleContext:
    def __init__(self, lookup: Lookup, metadata, allocator, session,
                 hbo=None, stats=None):
        self.lookup = lookup
        self.metadata = metadata
        self.allocator = allocator
        self.session = session
        #: the query's history view (telemetry.stats_store.HboContext):
        #: cost-based rules price candidates against recorded actuals
        self.hbo = hbo
        #: ONE StatsCalculator per optimize() run, shared by every rule
        #: application (ReorderJoins used to build a fresh estimator per
        #: region, re-pricing identical subtrees from scratch)
        self.stats_calculator = stats
        # per-(group id, version) estimate memo: a region re-ordered
        # because ONE child changed reuses every unchanged relation's
        # estimate instead of re-walking its subtree
        self._region_stats: Dict[tuple, object] = {}
        self.stats_memo_hits = 0

    def extract(self, node: PlanNode) -> PlanNode:
        return self.lookup.memo.extract(node)

    def shared_stats(self):
        """The run's shared, node-memoized StatsCalculator (history-fed
        when the query has one), built lazily for bare contexts."""
        if self.stats_calculator is None:
            from .stats import StatsCalculator

            self.stats_calculator = StatsCalculator(self.metadata,
                                                    history=self.hbo)
        return self.stats_calculator

    def region_stats(self, leaf: PlanNode, concrete: PlanNode):
        """Estimate one join-region relation, memoized per (group id,
        version[, sunk predicate]): group versions only move when a
        rule rewrites the group, so an unchanged relation prices once
        per optimize() run no matter how many regions re-order."""
        key = self._region_key(leaf)
        if key is not None:
            hit = self._region_stats.get(key)
            if hit is not None:
                self.stats_memo_hits += 1
                return hit
        got = self.shared_stats().stats(concrete)
        if key is not None:
            self._region_stats[key] = got
        return got

    def _region_key(self, leaf: PlanNode):
        from .plan import FilterNode

        memo = self.lookup.memo
        if isinstance(leaf, GroupReference):
            return (leaf.group_id, memo.versions[leaf.group_id], None)
        if isinstance(leaf, FilterNode) and \
                isinstance(leaf.source, GroupReference):
            gid = leaf.source.group_id
            return (gid, memo.versions[gid], repr(leaf.predicate))
        return None


class IterativeOptimizer:
    """Per-group fixpoint driver (reference:
    IterativeOptimizer.java:129 exploreGroup/exploreNode)."""

    MAX_APPLICATIONS = 20_000  # runaway-rule backstop

    MAX_PER_GROUP = 50  # per-(rule, group) firing cap: termination net

    def __init__(self, rules: Sequence[Rule], metadata, allocator,
                 session=None, hbo=None, stats=None):
        self.rules = list(rules)
        self._by_cls: Dict[Type, List[Rule]] = {}
        for r in self.rules:
            for cls in r.pattern.node_cls:
                self._by_cls.setdefault(cls, []).append(r)
        self.metadata = metadata
        self.allocator = allocator
        self.session = session
        self.hbo = hbo
        #: shared per-run estimator handed to the RuleContext (and
        #: readable by tests asserting the estimator-call count)
        self.stats_calculator = stats
        #: provenance: (rule_name, detail) in application order —
        #: surfaced by EXPLAIN
        self.trace: List[Tuple[str, str]] = []
        self._applications = 0
        self._per_group: Dict[Tuple[str, int], int] = {}

    def optimize(self, root: PlanNode) -> PlanNode:
        memo = Memo()
        lookup = Lookup(memo)
        ctx = RuleContext(lookup, self.metadata, self.allocator,
                          self.session, hbo=self.hbo,
                          stats=self.stats_calculator)
        self.stats_calculator = ctx.shared_stats()
        root_gid = memo.insert(root)
        self._explore_group(memo, lookup, ctx, root_gid)
        return memo.extract(memo.node(root_gid))

    # -- the exploration loop (mirrors IterativeOptimizer.java) ---------

    def _explore_group(self, memo, lookup, ctx, gid: int):
        progress = self._explore_node(memo, lookup, ctx, gid)
        while self._explore_children(memo, lookup, ctx, gid):
            # a child changed: the node may match new rules now
            if not self._explore_node(memo, lookup, ctx, gid):
                break
            progress = True
        return progress

    def _explore_node(self, memo, lookup, ctx, gid: int) -> bool:
        changed = False
        fired = True
        while fired:
            fired = False
            node = memo.node(gid)
            for rule in self._by_cls.get(type(node), ()):
                if not rule.pattern.matches(node, lookup):
                    continue
                key = (rule.name, gid)
                if self._per_group.get(key, 0) >= self.MAX_PER_GROUP:
                    continue  # termination net: cost-tie oscillations
                result = rule.apply(node, ctx)
                if result is None or result is node:
                    continue
                # no-change detection must compare CONCRETE trees: a
                # rule may rebuild an identical region whose children
                # are fresh nodes rather than the group's references
                # (ReorderJoins re-applied to an ordered region), and
                # replacing with an equal tree would loop forever
                if memo.extract(result) == memo.extract(node):
                    continue
                self._applications += 1
                self._per_group[key] = self._per_group.get(key, 0) + 1
                if self._applications > self.MAX_APPLICATIONS:
                    raise RuntimeError(
                        "iterative optimizer exceeded "
                        f"{self.MAX_APPLICATIONS} rule applications "
                        "(rule loop?)")
                memo.replace(gid, result)
                detail = getattr(rule, "last_detail", "")
                self.trace.append((rule.name, detail))
                changed = fired = True
                break  # re-fetch the rewritten node
        return changed

    def _explore_children(self, memo, lookup, ctx, gid: int) -> bool:
        changed = False
        node = memo.node(gid)
        # a group whose node IS a group reference (a rule collapsed it
        # onto its child, e.g. identity-projection removal) aliases
        # that child: explore THROUGH it
        children = [node] if isinstance(node, GroupReference) \
            else node.sources
        for src in children:
            if isinstance(src, GroupReference):
                before = memo.versions[src.group_id]
                self._explore_group(memo, lookup, ctx, src.group_id)
                if memo.versions[src.group_id] != before:
                    changed = True
        return changed
