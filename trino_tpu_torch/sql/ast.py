"""SQL abstract syntax tree.

Reference analog: ``core/trino-parser/src/main/java/io/trino/sql/tree/``
(248 immutable node classes). Compressed to dataclasses with the same
shape/naming so the analyzer reads like the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class Node:
    pass


class Expression(Node):
    pass


# ---------------------------------------------------------------------------
# literals & names


@dataclass(frozen=True)
class NullLiteral(Expression):
    pass


@dataclass(frozen=True)
class BooleanLiteral(Expression):
    value: bool


@dataclass(frozen=True)
class LongLiteral(Expression):
    value: int


@dataclass(frozen=True)
class DecimalLiteral(Expression):
    text: str  # e.g. "0.05"


@dataclass(frozen=True)
class DoubleLiteral(Expression):
    value: float


@dataclass(frozen=True)
class StringLiteral(Expression):
    value: str


@dataclass(frozen=True)
class IntervalLiteral(Expression):
    value: str
    unit: str            # year|month|day|hour|minute|second
    sign: int = 1
    end_unit: Optional[str] = None


@dataclass(frozen=True)
class GenericLiteral(Expression):
    """DATE '...', TIMESTAMP '...', DECIMAL '...'"""

    type_name: str
    value: str


@dataclass(frozen=True)
class ArrayConstructor(Expression):
    """``ARRAY[e1, e2, ...]`` (reference: sql/tree/ArrayConstructor)."""

    elements: Tuple[Expression, ...]


@dataclass(frozen=True)
class Subscript(Expression):
    """``base[index]`` (reference: sql/tree/SubscriptExpression)."""

    base: Expression
    index: Expression


@dataclass(frozen=True)
class AtTimeZone(Expression):
    """``value AT TIME ZONE 'zone'`` (reference: sql/tree/AtTimeZone.java)."""

    value: Expression
    zone: str


@dataclass(frozen=True)
class Identifier(Expression):
    name: str


@dataclass(frozen=True)
class DereferenceExpression(Expression):
    base: Expression
    field_name: str


@dataclass(frozen=True)
class Parameter(Expression):
    position: int


# ---------------------------------------------------------------------------
# operators


@dataclass(frozen=True)
class ComparisonExpression(Expression):
    op: str  # = != <> < <= > >=
    left: Expression
    right: Expression


@dataclass(frozen=True)
class ArithmeticBinary(Expression):
    op: str  # + - * / %
    left: Expression
    right: Expression


@dataclass(frozen=True)
class ArithmeticUnary(Expression):
    op: str  # + -
    value: Expression


@dataclass(frozen=True)
class LogicalBinary(Expression):
    op: str  # AND | OR
    left: Expression
    right: Expression


@dataclass(frozen=True)
class NotExpression(Expression):
    value: Expression


@dataclass(frozen=True)
class IsNullPredicate(Expression):
    value: Expression


@dataclass(frozen=True)
class IsNotNullPredicate(Expression):
    value: Expression


@dataclass(frozen=True)
class BetweenPredicate(Expression):
    value: Expression
    min: Expression
    max: Expression


@dataclass(frozen=True)
class InPredicate(Expression):
    value: Expression
    value_list: Tuple[Expression, ...]  # literals/exprs


@dataclass(frozen=True)
class InSubquery(Expression):
    value: Expression
    query: "Query"


@dataclass(frozen=True)
class LikePredicate(Expression):
    value: Expression
    pattern: Expression
    escape: Optional[Expression] = None


@dataclass(frozen=True)
class ExistsPredicate(Expression):
    query: "Query"


@dataclass(frozen=True)
class ScalarSubquery(Expression):
    query: "Query"


@dataclass(frozen=True)
class QuantifiedComparison(Expression):
    op: str
    quantifier: str  # ALL | ANY | SOME
    value: Expression
    query: "Query"


@dataclass(frozen=True)
class FunctionCall(Expression):
    name: str
    args: Tuple[Expression, ...]
    distinct: bool = False
    # window/filter clauses arrive later
    window: Optional["Window"] = None


@dataclass(frozen=True)
class Window(Node):
    partition_by: Tuple[Expression, ...] = ()
    order_by: Tuple["SortItem", ...] = ()
    frame: Optional[Tuple[str, str, str]] = None  # (type, start, end)


@dataclass(frozen=True)
class Cast(Expression):
    value: Expression
    type_name: str
    safe: bool = False  # TRY_CAST


@dataclass(frozen=True)
class Extract(Expression):
    field_name: str  # YEAR, MONTH, ...
    value: Expression


@dataclass(frozen=True)
class CurrentTime(Expression):
    kind: str  # current_date | current_timestamp


@dataclass(frozen=True)
class WhenClause(Node):
    condition: Expression
    result: Expression


@dataclass(frozen=True)
class SearchedCase(Expression):
    when_clauses: Tuple[WhenClause, ...]
    default: Optional[Expression]


@dataclass(frozen=True)
class SimpleCase(Expression):
    operand: Expression
    when_clauses: Tuple[WhenClause, ...]
    default: Optional[Expression]


@dataclass(frozen=True)
class CoalesceExpression(Expression):
    args: Tuple[Expression, ...]


@dataclass(frozen=True)
class NullIfExpression(Expression):
    first: Expression
    second: Expression


@dataclass(frozen=True)
class IfExpression(Expression):
    condition: Expression
    true_value: Expression
    false_value: Optional[Expression]


@dataclass(frozen=True)
class Row(Expression):
    items: Tuple[Expression, ...]


# ---------------------------------------------------------------------------
# relations


class Relation(Node):
    pass


@dataclass(frozen=True)
class Table(Relation):
    name: Tuple[str, ...]  # qualified: (catalog, schema, table) suffix


@dataclass(frozen=True)
class AliasedRelation(Relation):
    relation: Relation
    alias: str
    column_names: Tuple[str, ...] = ()


@dataclass(frozen=True)
class SubqueryRelation(Relation):
    query: "Query"


@dataclass(frozen=True)
class Join(Relation):
    join_type: str  # INNER | LEFT | RIGHT | FULL | CROSS | IMPLICIT
    left: Relation
    right: Relation
    criteria: Optional[Expression] = None       # ON expr
    using_columns: Tuple[str, ...] = ()


@dataclass(frozen=True)
class Unnest(Relation):
    expressions: Tuple[Expression, ...]
    with_ordinality: bool = False


@dataclass(frozen=True)
class Values(Relation):
    rows: Tuple[Tuple[Expression, ...], ...]


# ---------------------------------------------------------------------------
# query structure


@dataclass(frozen=True)
class SelectItem(Node):
    pass


@dataclass(frozen=True)
class SingleColumn(SelectItem):
    expression: Expression
    alias: Optional[str] = None


@dataclass(frozen=True)
class AllColumns(SelectItem):
    prefix: Tuple[str, ...] = ()  # t.* has prefix ('t',)


@dataclass(frozen=True)
class SortItem(Node):
    key: Expression
    ascending: bool = True
    nulls_last: Optional[bool] = None  # None = dialect default


@dataclass(frozen=True)
class GroupBy(Node):
    expressions: Tuple[Expression, ...] = ()
    # grouping sets / rollup / cube
    kind: str = "simple"  # simple | rollup | cube | grouping_sets
    sets: Tuple[Tuple[Expression, ...], ...] = ()


@dataclass(frozen=True)
class QuerySpecification(Node):
    select_items: Tuple[SelectItem, ...]
    distinct: bool = False
    from_: Optional[Relation] = None
    where: Optional[Expression] = None
    group_by: Optional[GroupBy] = None
    having: Optional[Expression] = None
    order_by: Tuple[SortItem, ...] = ()
    limit: Optional[int] = None
    offset: int = 0


@dataclass(frozen=True)
class SetOperation(Node):
    op: str  # UNION | INTERSECT | EXCEPT
    distinct: bool
    left: "QueryBody"
    right: "QueryBody"


# QueryBody = QuerySpecification | SetOperation | Values-as-table


@dataclass(frozen=True)
class WithQuery(Node):
    name: str
    query: "Query"
    column_names: Tuple[str, ...] = ()


@dataclass(frozen=True)
class Query(Node):
    body: Node  # QueryBody
    with_queries: Tuple[WithQuery, ...] = ()
    order_by: Tuple[SortItem, ...] = ()
    limit: Optional[int] = None
    offset: int = 0


# ---------------------------------------------------------------------------
# statements


class Statement(Node):
    pass


@dataclass(frozen=True)
class QueryStatement(Statement):
    query: Query


@dataclass(frozen=True)
class Explain(Statement):
    statement: Statement
    analyze: bool = False
    #: EXPLAIN ANALYZE VERBOSE: also profile compiled programs and
    #: render per-operator flops/bytes/compile-ms
    verbose: bool = False
    type: str = "LOGICAL"  # LOGICAL | DISTRIBUTED | IO


@dataclass(frozen=True)
class ShowTables(Statement):
    schema: Optional[Tuple[str, ...]] = None


@dataclass(frozen=True)
class ShowSchemas(Statement):
    catalog: Optional[str] = None


@dataclass(frozen=True)
class ShowCatalogs(Statement):
    pass


@dataclass(frozen=True)
class ShowColumns(Statement):
    table: Tuple[str, ...] = ()


@dataclass(frozen=True)
class CreateTableAsSelect(Statement):
    name: Tuple[str, ...]
    query: Query
    if_not_exists: bool = False


@dataclass(frozen=True)
class CreateTable(Statement):
    name: Tuple[str, ...]
    columns: Tuple[Tuple[str, str], ...]   # (name, type text)
    if_not_exists: bool = False


@dataclass(frozen=True)
class DropTable(Statement):
    name: Tuple[str, ...]
    if_exists: bool = False


@dataclass(frozen=True)
class Delete(Statement):
    table: Tuple[str, ...]
    where: Optional[Expression] = None


@dataclass(frozen=True)
class Insert(Statement):
    table: Tuple[str, ...]
    query: Query
    columns: Tuple[str, ...] = ()


@dataclass(frozen=True)
class SetSession(Statement):
    name: str
    value: Expression


@dataclass(frozen=True)
class ShowSession(Statement):
    pass
