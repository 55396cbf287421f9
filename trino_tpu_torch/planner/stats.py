"""Plan statistics propagation + cost comparison.

Reference analog: ``cost/`` (6.5k LoC: StatsCalculator with per-node
rules — ScanStatsRule, FilterStatsCalculator, JoinStatsRule,
AggregationStatsRule — plus CostCalculator/CostComparator driving join
ordering and distribution choice). Compressed here to the estimates
that move TPC-H/TPC-DS plans: scan stats from connectors, predicate
selectivity from column ndv/min-max under the uniformity assumption,
the classic |L||R|/max(ndv) equi-join cardinality, and group-key ndv
capping for aggregations.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass, field, replace
from decimal import Decimal
from typing import Dict, Optional

from ..expr.ir import Call, Literal, RowExpression
from ..planner.symbols import SymbolRef, referenced_symbols
from .plan import (AggregationNode, CrossJoinNode, DistinctNode,
                   EnforceSingleRowNode, ExchangeNode, FilterNode,
                   JoinNode, LimitNode, PlanNode, ProjectNode,
                   TableScanNode, TopNNode, ValuesNode)

DEFAULT_ROWS = 1000.0
UNKNOWN_FILTER_SELECTIVITY = 0.33   # reference: UNKNOWN_FILTER_COEFFICIENT


@dataclass(frozen=True)
class SymbolStats:
    """Per-column estimate (reference: cost/SymbolStatsEstimate.java)."""

    distinct_count: Optional[float] = None
    null_fraction: float = 0.0
    low: Optional[float] = None     # numeric projection of min
    high: Optional[float] = None


@dataclass
class PlanStats:
    """Per-node estimate (reference: cost/PlanNodeStatsEstimate.java).
    ``source`` names what produced the row count: ``connector``
    (statistics-derived guesses) or ``hbo`` (recorded runtime history
    overrode the estimate) — EXPLAIN and the strategy details surface
    it per estimate."""

    row_count: float = DEFAULT_ROWS
    symbols: Dict[str, SymbolStats] = field(default_factory=dict)
    confident: bool = False
    source: str = "connector"

    def symbol(self, name: str) -> SymbolStats:
        return self.symbols.get(name, SymbolStats())

    def scaled(self, factor: float) -> "PlanStats":
        factor = max(0.0, min(1.0, factor))
        rows = self.row_count * factor
        # ndv caps at the new row count
        syms = {n: replace(s, distinct_count=None
                           if s.distinct_count is None
                           else min(s.distinct_count, max(rows, 1.0)))
                for n, s in self.symbols.items()}
        return PlanStats(rows, syms, self.confident, self.source)


def _as_float(v) -> Optional[float]:
    if v is None:
        return None
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, Decimal):
        return float(v)
    if isinstance(v, _dt.date):
        return float((v - _dt.date(1970, 1, 1)).days)
    return None


class StatsCalculator:
    """Bottom-up estimator with per-node-type rules.  ``history`` (a
    ``telemetry.stats_store.HboContext``) lets recorded runtime actuals
    beat the connector-derived estimate per node — the decision
    precedence is history > connector > defaults, and an overridden
    node reports ``source='hbo'`` with full confidence (an observation
    beats any guess)."""

    def __init__(self, metadata, history=None):
        self.metadata = metadata
        self.history = history
        # the cached NODE rides in the value: a bare id() key would go
        # stale when a freed node's address is reused (the optimizer
        # builds throwaway candidate JoinNodes in a loop)
        self._cache: Dict[int, tuple] = {}
        #: estimate computations (memo misses) — the join-order DP is
        #: O(3^n) estimator calls, so sharing one calculator per
        #: optimize() run must provably reduce this count
        self.calls = 0

    def stats(self, node: PlanNode) -> PlanStats:
        hit = self._cache.get(id(node))
        if hit is not None and hit[0] is node:
            return hit[1]
        self.calls += 1
        m = getattr(self, "_s_" + type(node).__name__, None)
        got = m(node) if m is not None else self._default(node)
        if self.history is not None:
            observed = self.history.rows_for(node)
            if observed is not None:
                # keep the per-symbol detail (ndv/min-max still come
                # from the connector); history owns the cardinality
                got = PlanStats(max(observed, 1.0), got.symbols,
                                True, "hbo")
        self._cache[id(node)] = (node, got)
        return got

    def _default(self, node: PlanNode) -> PlanStats:
        srcs = node.sources
        if not srcs:
            return PlanStats()
        child = [self.stats(s) for s in srcs]
        best = max(child, key=lambda c: c.row_count)
        merged: Dict[str, SymbolStats] = {}
        for c in child:
            merged.update(c.symbols)
        return PlanStats(best.row_count, merged,
                         all(c.confident for c in child))

    # -- leaves --------------------------------------------------------

    def _s_TableScanNode(self, node: TableScanNode) -> PlanStats:
        conn = self.metadata.connectors.get(node.catalog)
        if conn is None:
            return PlanStats()
        tstats = conn.metadata().get_statistics(node.table)
        rows = float(tstats.row_count) if tstats.row_count else DEFAULT_ROWS
        syms: Dict[str, SymbolStats] = {}
        for sym, col in node.assignments:
            cs = tstats.columns.get(col.name) if tstats.columns else None
            if cs is None:
                continue
            syms[sym.name] = SymbolStats(
                distinct_count=cs.distinct_count,
                null_fraction=cs.null_fraction or 0.0,
                low=_as_float(cs.min_value),
                high=_as_float(cs.max_value))
        # a pushed-down constraint prunes at the scan: its selectivity
        # must keep scaling the estimate even though the filter
        # conjuncts left the plan (join ordering depends on it)
        cons = getattr(node.table, "constraint", None)
        if cons is not None and cons.columns:
            for cname, dom in cons.columns:
                cs = tstats.columns.get(cname) if tstats.columns else None
                ss = SymbolStats(
                    distinct_count=cs.distinct_count if cs else None,
                    null_fraction=(cs.null_fraction or 0.0) if cs else 0.0,
                    low=_as_float(cs.min_value) if cs else None,
                    high=_as_float(cs.max_value) if cs else None)
                rows *= _domain_selectivity(dom, ss)
        return PlanStats(rows, syms, tstats.row_count is not None)

    def _s_ValuesNode(self, node: ValuesNode) -> PlanStats:
        return PlanStats(float(len(node.rows)), {}, True)

    def _s_EnforceSingleRowNode(self, node) -> PlanStats:
        return PlanStats(1.0, {}, True)

    # -- relational ----------------------------------------------------

    def _s_FilterNode(self, node: FilterNode) -> PlanStats:
        src = self.stats(node.source)
        sel = self._selectivity(node.predicate, src)
        return src.scaled(sel)

    def _s_ProjectNode(self, node: ProjectNode) -> PlanStats:
        src = self.stats(node.source)
        syms: Dict[str, SymbolStats] = {}
        for sym, expr in node.assignments:
            if isinstance(expr, SymbolRef):
                syms[sym.name] = src.symbol(expr.name)
        return PlanStats(src.row_count, syms, src.confident)

    def _s_ExchangeNode(self, node: ExchangeNode) -> PlanStats:
        return self.stats(node.source)

    def _s_LimitNode(self, node: LimitNode) -> PlanStats:
        src = self.stats(node.source)
        return PlanStats(min(src.row_count, float(node.count)),
                         src.symbols, src.confident)

    def _s_TopNNode(self, node: TopNNode) -> PlanStats:
        src = self.stats(node.source)
        return PlanStats(min(src.row_count, float(node.count)),
                         src.symbols, src.confident)

    def _s_DistinctNode(self, node: DistinctNode) -> PlanStats:
        src = self.stats(node.source)
        ndv = 1.0
        known = False
        for s in node.output_symbols:
            d = src.symbol(s.name).distinct_count
            if d is not None:
                ndv *= max(d, 1.0)
                known = True
        rows = min(src.row_count, ndv) if known \
            else src.row_count * 0.1
        return PlanStats(rows, src.symbols, src.confident and known)

    def _s_AggregationNode(self, node: AggregationNode) -> PlanStats:
        src = self.stats(node.source)
        if not node.group_keys:
            return PlanStats(1.0, {}, src.confident)
        if node.step == "final":
            # the partial already shrank the stream; keys' ndv bounds us
            pass
        ndv = 1.0
        known = False
        for s in node.group_keys:
            d = src.symbol(s.name).distinct_count
            if d is not None:
                ndv *= max(d, 1.0)
                known = True
        rows = min(src.row_count, ndv) if known else src.row_count * 0.1
        syms = {s.name: src.symbol(s.name) for s in node.group_keys}
        return PlanStats(max(rows, 1.0), syms, src.confident and known)

    def _s_JoinNode(self, node: JoinNode) -> PlanStats:
        left = self.stats(node.left)
        right = self.stats(node.right)
        if node.join_type in ("semi", "anti"):
            return left.scaled(0.5)
        if not node.criteria:
            rows = left.row_count * right.row_count
        else:
            # classic equi-join estimate: |L| * |R| / max over clauses
            # of max(ndv_l, ndv_r) (reference: JoinStatsRule)
            rows = left.row_count * right.row_count
            denom = 1.0
            for l, r in node.criteria:
                dl = left.symbol(l.name).distinct_count
                dr = right.symbol(r.name).distinct_count
                cands = [d for d in (dl, dr) if d is not None]
                if cands:
                    denom = max(denom, max(cands))
            rows = rows / denom
        if node.join_type in ("left", "full"):
            rows = max(rows, left.row_count)
        if node.join_type == "full":
            rows = max(rows, right.row_count)
        syms = dict(left.symbols)
        syms.update(right.symbols)
        if node.filter_expr is not None:
            rows *= UNKNOWN_FILTER_SELECTIVITY
        return PlanStats(max(rows, 1.0), syms,
                         left.confident and right.confident)

    def _s_CrossJoinNode(self, node: CrossJoinNode) -> PlanStats:
        left = self.stats(node.left)
        right = self.stats(node.right)
        syms = dict(left.symbols)
        syms.update(right.symbols)
        return PlanStats(left.row_count * right.row_count, syms,
                         left.confident and right.confident)

    # -- predicate selectivity ----------------------------------------

    def _selectivity(self, pred: RowExpression, src: PlanStats) -> float:
        if not isinstance(pred, Call):
            return UNKNOWN_FILTER_SELECTIVITY
        name = pred.name
        if name == "$and":
            out = 1.0
            for a in pred.args:
                out *= self._selectivity(a, src)
            return out
        if name == "$or":
            out = 0.0
            for a in pred.args:
                s = self._selectivity(a, src)
                out = out + s - out * s
            return min(out, 1.0)
        if name == "$not":
            inner = pred.args[0]
            if isinstance(inner, Call) and inner.name == "$is_null":
                sym0, _ = _sym_lit(inner)
                if sym0 is not None:
                    return 1.0 - src.symbol(sym0.name).null_fraction
            return max(0.0, 1.0 - self._selectivity(inner, src))
        sym, lit = _sym_lit(pred)
        if sym is None:
            return UNKNOWN_FILTER_SELECTIVITY
        ss = src.symbol(sym.name)
        live = 1.0 - ss.null_fraction
        if name == "eq":
            if ss.distinct_count:
                return live / max(ss.distinct_count, 1.0)
            return UNKNOWN_FILTER_SELECTIVITY
        if name == "ne":
            if ss.distinct_count:
                return live * (1.0 - 1.0 / max(ss.distinct_count, 1.0))
            return 1 - UNKNOWN_FILTER_SELECTIVITY
        if name in ("lt", "le", "gt", "ge") and lit is not None:
            v = _as_float(lit.value)
            if v is not None and ss.low is not None \
                    and ss.high is not None and ss.high > ss.low:
                frac = (v - ss.low) / (ss.high - ss.low)
                frac = max(0.0, min(1.0, frac))
                if name in ("gt", "ge"):
                    frac = 1.0 - frac
                return live * frac
            return 0.5 * live
        if name == "$in":
            if ss.distinct_count:
                k = max(len(pred.args) - 1, 1)
                return live * min(1.0, k / max(ss.distinct_count, 1.0))
            return UNKNOWN_FILTER_SELECTIVITY
        if name == "$between":
            lo_lit = _as_literal(pred.args[1])
            hi_lit = _as_literal(pred.args[2])
            lo = _as_float(lo_lit.value) if lo_lit is not None else None
            hi = _as_float(hi_lit.value) if hi_lit is not None else None
            if None not in (lo, hi) and ss.low is not None \
                    and ss.high is not None and ss.high > ss.low:
                frac = (min(hi, ss.high) - max(lo, ss.low)) \
                    / (ss.high - ss.low)
                return live * max(0.0, min(1.0, frac))
            return UNKNOWN_FILTER_SELECTIVITY
        if name == "$is_null":
            return ss.null_fraction
        return UNKNOWN_FILTER_SELECTIVITY


def _domain_selectivity(dom, ss: SymbolStats) -> float:
    """Selectivity of a pushed-down Domain, mirroring _selectivity's
    formulas (1/ndv per discrete value; range-overlap fraction over
    [low, high]) so join ordering sees the same estimates whether a
    predicate sits in a FilterNode or in a scan constraint."""
    live = 1.0 - ss.null_fraction
    if dom.values.is_none:
        sel = 0.0
    elif dom.values.is_all:
        sel = live
    elif all(r.is_single for r in dom.values.ranges):
        if ss.distinct_count:
            sel = live * min(1.0, len(dom.values.ranges)
                             / max(ss.distinct_count, 1.0))
        else:
            sel = UNKNOWN_FILTER_SELECTIVITY
    else:
        if ss.low is not None and ss.high is not None \
                and ss.high > ss.low:
            frac = 0.0
            for r in dom.values.ranges:
                lo = _as_float(r.low) if r.low is not None else ss.low
                hi = _as_float(r.high) if r.high is not None else ss.high
                if lo is None or hi is None:
                    frac = None
                    break
                frac += max(0.0, (min(hi, ss.high) - max(lo, ss.low))
                            / (ss.high - ss.low))
            sel = live * min(1.0, frac) \
                if frac is not None else UNKNOWN_FILTER_SELECTIVITY
        else:
            sel = UNKNOWN_FILTER_SELECTIVITY
    if dom.null_allowed:
        sel += ss.null_fraction
    return max(0.0, min(sel, 1.0))


def _as_literal(expr) -> Optional[Literal]:
    """Literal, unwrapping the coercion cast the analyzer inserts
    (``$cast(Literal)``) and RESCALING the value into the target type's
    raw units (decimal literals compare against raw-scaled stats)."""
    if isinstance(expr, Literal):
        return expr
    if isinstance(expr, Call) and expr.name == "$cast" \
            and len(expr.args) == 1 and isinstance(expr.args[0], Literal):
        inner = expr.args[0]
        v = inner.value
        if v is None:
            return Literal(expr.type, None)
        if expr.type.is_decimal and isinstance(v, (int, float, Decimal)):
            return Literal(expr.type, expr.type.to_raw(v))
        return Literal(expr.type, v)
    return None


def _unwrap_sym(expr) -> Optional[SymbolRef]:
    """SymbolRef, looking through the analyzer's coercion cast."""
    if isinstance(expr, SymbolRef):
        return expr
    if isinstance(expr, Call) and expr.name == "$cast" \
            and len(expr.args) == 1 \
            and isinstance(expr.args[0], SymbolRef):
        return expr.args[0]
    return None


def _sym_lit(pred: Call):
    """(symbol, literal) of a simple comparison, else (None, None); the
    symbol side may appear on either side, both sides may be wrapped in
    coercion casts, and the literal is RESCALED into the symbol's raw
    units (column stats are stored raw)."""
    args = pred.args
    sym = None
    lit = None
    for a in args[:2] if len(args) >= 2 else args:
        s = _unwrap_sym(a)
        if s is not None and sym is None:
            sym = s
            continue
        unwrapped = _as_literal(a)
        if unwrapped is not None and lit is None:
            lit = unwrapped
    if sym is not None and lit is not None and lit.value is not None:
        v = _as_float(lit.value)
        if v is not None:
            lscale = lit.type.scale if lit.type.is_decimal else 0
            sscale = sym.type.scale if sym.type.is_decimal else 0
            if lscale != sscale:
                lit = Literal(sym.type, v * (10.0 ** (sscale - lscale)))
    return sym, lit
