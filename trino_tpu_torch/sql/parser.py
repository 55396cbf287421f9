"""SQL lexer + recursive-descent/Pratt parser.

Reference analog: the ANTLR grammar ``core/trino-parser/src/main/antlr4/io/
trino/sql/parser/SqlBase.g4`` (1,225 lines) + ``sql/parser/SqlParser.java``.
Hand-written here (no parser generator in the image): a Pratt expression
parser with standard SQL precedence and a recursive-descent statement
grammar covering the engine's supported surface (full TPC-H/TPC-DS query
shape: CTEs, joins, subqueries incl. correlated/EXISTS/IN/quantified,
CASE, CAST, EXTRACT, intervals, set operations, window functions,
GROUP BY ROLLUP/CUBE/GROUPING SETS, ORDER BY/LIMIT/OFFSET, EXPLAIN, SHOW,
INSERT, CREATE TABLE AS).
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from ..types import TrinoError
from . import ast


class ParseError(TrinoError):
    def __init__(self, message, pos=None):
        super().__init__(message, code="SYNTAX_ERROR")
        self.pos = pos


# ---------------------------------------------------------------------------
# lexer

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|--[^\n]*|/\*.*?\*/)
  | (?P<number>(\d+\.\d*|\.\d+)([eE][+-]?\d+)?|\d+[eE][+-]?\d+|\d+)
  | (?P<string>'(?:[^']|'')*')
  | (?P<qident>"(?:[^"]|"")*")
  | (?P<ident>[A-Za-z_][A-Za-z0-9_$]*)
  | (?P<op><=|>=|<>|!=|\|\||->|[-+*/%<>=(),.;\[\]?:])
""", re.VERBOSE | re.DOTALL)

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "as", "and", "or", "not", "in", "exists", "between", "like",
    "escape", "is", "null", "true", "false", "case", "when", "then", "else",
    "end", "cast", "try_cast", "extract", "interval", "date", "time",
    "timestamp", "distinct", "all", "any", "some", "union", "intersect",
    "except", "join", "inner", "left", "right", "full", "outer", "cross",
    "on", "using", "with", "values", "asc", "desc", "nulls", "first",
    "last", "year", "month", "day", "hour", "minute", "second", "explain",
    "analyze", "show", "tables", "schemas", "catalogs", "columns", "create",
    "table", "insert", "into", "set", "session", "current_date",
    "current_timestamp", "rollup", "cube", "grouping", "sets", "over",
    "partition", "rows", "range", "unbounded", "preceding", "following",
    "current", "row", "if", "coalesce", "nullif", "substring", "for",
    "unnest", "ordinality", "fetch", "next", "only", "exists", "describe",
    "drop", "delete",
}


class Token:
    __slots__ = ("kind", "value", "pos")

    def __init__(self, kind, value, pos):
        self.kind = kind      # number|string|ident|qident|op|kw|eof
        self.value = value
        self.pos = pos

    def __repr__(self):
        return f"{self.kind}:{self.value}"


def tokenize(sql: str) -> List[Token]:
    out = []
    pos = 0
    n = len(sql)
    while pos < n:
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise ParseError(f"unexpected character {sql[pos]!r} at {pos}",
                             pos)
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        text = m.group()
        if kind == "ident":
            low = text.lower()
            if low in KEYWORDS:
                out.append(Token("kw", low, m.start()))
            else:
                out.append(Token("ident", low, m.start()))
        elif kind == "qident":
            out.append(Token("ident", text[1:-1].replace('""', '"'),
                             m.start()))
        elif kind == "string":
            out.append(Token("string", text[1:-1].replace("''", "'"),
                             m.start()))
        else:
            out.append(Token(kind, text, m.start()))
    out.append(Token("eof", "", n))
    return out


# ---------------------------------------------------------------------------
# parser

_CMP_OPS = {"=", "<", "<=", ">", ">=", "<>", "!="}


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.tokens = tokenize(sql)
        self.i = 0

    # -- token helpers -------------------------------------------------

    @property
    def tok(self) -> Token:
        return self.tokens[self.i]

    def peek(self, k=1) -> Token:
        j = min(self.i + k, len(self.tokens) - 1)
        return self.tokens[j]

    def advance(self) -> Token:
        t = self.tok
        self.i += 1
        return t

    def at_kw(self, *kws) -> bool:
        return self.tok.kind == "kw" and self.tok.value in kws

    def at_op(self, *ops) -> bool:
        return self.tok.kind == "op" and self.tok.value in ops

    def accept_kw(self, *kws) -> Optional[str]:
        if self.at_kw(*kws):
            return self.advance().value
        return None

    def accept_op(self, *ops) -> Optional[str]:
        if self.at_op(*ops):
            return self.advance().value
        return None

    def expect_kw(self, kw) -> str:
        if not self.at_kw(kw):
            raise ParseError(
                f"expected {kw.upper()} but found {self.tok.value!r} "
                f"at position {self.tok.pos}", self.tok.pos)
        return self.advance().value

    def expect_op(self, op) -> str:
        if not self.at_op(op):
            raise ParseError(
                f"expected {op!r} but found {self.tok.value!r} "
                f"at position {self.tok.pos}", self.tok.pos)
        return self.advance().value

    def identifier(self) -> str:
        t = self.tok
        if t.kind == "ident":
            return self.advance().value
        # soft keywords usable as identifiers
        if t.kind == "kw" and t.value in (
                "year", "month", "day", "hour", "minute", "second", "date",
                "time", "timestamp", "values", "tables", "schemas", "row",
                "rows", "columns", "catalogs", "session", "first", "last",
                "next", "only", "if", "analyze", "set", "sets", "all"):
            return self.advance().value
        raise ParseError(f"expected identifier, found {t.value!r} at "
                         f"position {t.pos}", t.pos)

    def qualified_name(self) -> Tuple[str, ...]:
        parts = [self.identifier()]
        while self.accept_op("."):
            parts.append(self.identifier())
        return tuple(parts)

    # -- statements ----------------------------------------------------

    def parse_statement(self) -> ast.Statement:
        stmt = self._statement()
        self.accept_op(";")
        if self.tok.kind != "eof":
            raise ParseError(f"unexpected trailing input "
                             f"{self.tok.value!r} at {self.tok.pos}",
                             self.tok.pos)
        return stmt

    def _statement(self) -> ast.Statement:
        if self.at_kw("explain"):
            self.advance()
            analyze = bool(self.accept_kw("analyze"))
            # VERBOSE is a soft keyword: only meaningful right after
            # ANALYZE, so a column named "verbose" stays an identifier
            verbose = False
            if analyze and self.tok.kind == "ident" \
                    and self.tok.value.lower() == "verbose":
                self.advance()
                verbose = True
            return ast.Explain(self._statement(), analyze=analyze,
                               verbose=verbose)
        if self.at_kw("show"):
            return self._show()
        if self.at_kw("describe"):
            self.advance()
            return ast.ShowColumns(self.qualified_name())
        if self.at_kw("create"):
            return self._create()
        if self.at_kw("drop"):
            self.advance()
            self.expect_kw("table")
            if_exists = bool(self.accept_kw("if"))
            if if_exists:
                self.expect_kw("exists")
            return ast.DropTable(self.qualified_name(), if_exists)
        if self.at_kw("delete"):
            self.advance()
            self.expect_kw("from")
            name = self.qualified_name()
            where = None
            if self.accept_kw("where"):
                where = self._expression()
            return ast.Delete(name, where)
        if self.at_kw("insert"):
            self.advance()
            self.expect_kw("into")
            name = self.qualified_name()
            columns: Tuple[str, ...] = ()
            if self.at_op("(") and self._looks_like_column_list():
                self.advance()
                cols = [self.identifier()]
                while self.accept_op(","):
                    cols.append(self.identifier())
                self.expect_op(")")
                columns = tuple(cols)
            return ast.Insert(name, self.parse_query(), columns)
        if self.at_kw("set"):
            self.advance()
            self.expect_kw("session")
            name = ".".join(self.qualified_name())
            self.expect_op("=")
            return ast.SetSession(name, self._expression())
        return ast.QueryStatement(self.parse_query())

    def _looks_like_column_list(self) -> bool:
        # INSERT INTO t (a, b) SELECT... vs INSERT INTO t (SELECT...)
        j = self.i + 1
        t = self.tokens[j]
        return not (t.kind == "kw" and t.value in ("select", "with",
                                                   "values"))

    def _show(self) -> ast.Statement:
        self.advance()
        if self.accept_kw("tables"):
            schema = None
            if self.accept_kw("from") or self.accept_kw("in"):
                schema = self.qualified_name()
            return ast.ShowTables(schema)
        if self.accept_kw("schemas"):
            cat = None
            if self.accept_kw("from") or self.accept_kw("in"):
                cat = self.identifier()
            return ast.ShowSchemas(cat)
        if self.accept_kw("catalogs"):
            return ast.ShowCatalogs()
        if self.accept_kw("columns"):
            self.expect_kw("from")
            return ast.ShowColumns(self.qualified_name())
        if self.accept_kw("session"):
            return ast.ShowSession()
        raise ParseError(f"unsupported SHOW {self.tok.value!r}",
                         self.tok.pos)

    def _create(self) -> ast.Statement:
        self.advance()
        self.expect_kw("table")
        if_not_exists = False
        if self.accept_kw("if"):
            self.expect_kw("not")
            self.expect_kw("exists")  # via kw 'exists'
            if_not_exists = True
        name = self.qualified_name()
        if self.at_op("("):
            # CREATE TABLE t (col type, ...)
            self.advance()
            columns = []
            while True:
                cname = self.identifier()
                ttext = self._type_text()
                columns.append((cname, ttext))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            return ast.CreateTable(name, tuple(columns), if_not_exists)
        self.expect_kw("as")
        return ast.CreateTableAsSelect(name, self.parse_query(),
                                       if_not_exists)

    def _type_text(self) -> str:
        """A type name with optional (p[,s]) parameters, as raw text."""
        parts = [self.identifier()]
        # multi-word types (e.g. "double precision" not supported; keep 1)
        if self.at_op("("):
            self.advance()
            args = [str(self.tok.value)]
            self.advance()
            while self.accept_op(","):
                args.append(str(self.tok.value))
                self.advance()
            self.expect_op(")")
            parts.append("(" + ", ".join(args) + ")")
        if parts[0] == "timestamp" and self._accept_with_time_zone():
            parts.append(" with time zone")
        return "".join(parts)

    # -- queries -------------------------------------------------------

    def parse_query(self) -> ast.Query:
        withs: List[ast.WithQuery] = []
        if self.accept_kw("with"):
            while True:
                name = self.identifier()
                cols: Tuple[str, ...] = ()
                if self.accept_op("("):
                    c = [self.identifier()]
                    while self.accept_op(","):
                        c.append(self.identifier())
                    self.expect_op(")")
                    cols = tuple(c)
                self.expect_kw("as")
                self.expect_op("(")
                q = self.parse_query()
                self.expect_op(")")
                withs.append(ast.WithQuery(name, q, cols))
                if not self.accept_op(","):
                    break
        body = self._query_body()
        order_by, limit, offset = self._order_limit()
        return ast.Query(body, tuple(withs), order_by, limit, offset)

    def _order_limit(self):
        order_by: Tuple[ast.SortItem, ...] = ()
        if self.accept_kw("order"):
            self.expect_kw("by")
            items = [self._sort_item()]
            while self.accept_op(","):
                items.append(self._sort_item())
            order_by = tuple(items)
        offset = 0
        limit = None
        if self.accept_kw("offset"):
            offset = int(self.advance().value)
            self.accept_kw("rows") or self.accept_kw("row")
        if self.accept_kw("limit"):
            if self.accept_kw("all"):
                limit = None
            else:
                limit = int(self.advance().value)
        elif self.accept_kw("fetch"):
            self.accept_kw("first") or self.accept_kw("next")
            limit = int(self.advance().value)
            self.accept_kw("rows") or self.accept_kw("row")
            self.accept_kw("only")
        return order_by, limit, offset

    def _sort_item(self) -> ast.SortItem:
        key = self._expression()
        asc = True
        if self.accept_kw("asc"):
            asc = True
        elif self.accept_kw("desc"):
            asc = False
        nulls_last = None
        if self.accept_kw("nulls"):
            if self.accept_kw("first"):
                nulls_last = False
            else:
                self.expect_kw("last")
                nulls_last = True
        return ast.SortItem(key, asc, nulls_last)

    def _query_body(self):
        left = self._query_term()
        while self.at_kw("union", "except"):
            op = self.advance().value
            distinct = not self.accept_kw("all")
            if not distinct:
                pass
            else:
                self.accept_kw("distinct")
            right = self._query_term()
            left = ast.SetOperation(op.upper(), distinct, left, right)
        return left

    def _query_term(self):
        left = self._query_primary()
        while self.at_kw("intersect"):
            self.advance()
            distinct = not self.accept_kw("all")
            if distinct:
                self.accept_kw("distinct")
            right = self._query_primary()
            left = ast.SetOperation("INTERSECT", distinct, left, right)
        return left

    def _query_primary(self):
        if self.at_op("("):
            self.advance()
            q = self.parse_query()
            self.expect_op(")")
            # nested query as body: flatten if trivial
            if not q.with_queries and not q.order_by and q.limit is None \
                    and q.offset == 0:
                return q.body
            return q
        if self.at_kw("values"):
            self.advance()
            rows = [self._values_row()]
            while self.accept_op(","):
                rows.append(self._values_row())
            return ast.Values(tuple(rows))
        return self._query_spec()

    def _values_row(self) -> Tuple[ast.Expression, ...]:
        if self.at_op("("):
            self.advance()
            items = [self._expression()]
            while self.accept_op(","):
                items.append(self._expression())
            self.expect_op(")")
            return tuple(items)
        return (self._expression(),)

    def _query_spec(self) -> ast.QuerySpecification:
        self.expect_kw("select")
        distinct = False
        if self.accept_kw("distinct"):
            distinct = True
        else:
            self.accept_kw("all")
        items = [self._select_item()]
        while self.accept_op(","):
            items.append(self._select_item())
        from_: Optional[ast.Relation] = None
        if self.accept_kw("from"):
            from_ = self._relation()
            while self.accept_op(","):
                right = self._relation()
                from_ = ast.Join("IMPLICIT", from_, right)
        where = self._expression() if self.accept_kw("where") else None
        group_by = None
        if self.accept_kw("group"):
            self.expect_kw("by")
            group_by = self._group_by()
        having = self._expression() if self.accept_kw("having") else None
        return ast.QuerySpecification(
            tuple(items), distinct, from_, where, group_by, having)

    def _group_by(self) -> ast.GroupBy:
        if self.at_kw("rollup", "cube"):
            kind = self.advance().value
            self.expect_op("(")
            exprs = [self._expression()]
            while self.accept_op(","):
                exprs.append(self._expression())
            self.expect_op(")")
            return ast.GroupBy(tuple(exprs), kind=kind)
        if self.at_kw("grouping"):
            self.advance()
            self.expect_kw("sets")
            self.expect_op("(")
            sets = []
            while True:
                self.expect_op("(")
                if self.at_op(")"):
                    self.advance()
                    sets.append(())
                else:
                    es = [self._expression()]
                    while self.accept_op(","):
                        es.append(self._expression())
                    self.expect_op(")")
                    sets.append(tuple(es))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            return ast.GroupBy((), kind="grouping_sets", sets=tuple(sets))
        exprs = [self._expression()]
        while self.accept_op(","):
            exprs.append(self._expression())
        return ast.GroupBy(tuple(exprs))

    def _select_item(self) -> ast.SelectItem:
        if self.at_op("*"):
            self.advance()
            return ast.AllColumns()
        # t.* / schema.t.* — lookahead for a dotted star
        if self.tok.kind == "ident":
            j = self.i
            parts = [self.tokens[j].value]
            j += 1
            while (self.tokens[j].kind == "op"
                   and self.tokens[j].value == "."):
                nxt = self.tokens[j + 1]
                if nxt.kind == "op" and nxt.value == "*":
                    self.i = j + 2
                    return ast.AllColumns(tuple(parts))
                if nxt.kind not in ("ident",):
                    break
                parts.append(nxt.value)
                j += 2
        expr = self._expression()
        alias = None
        if self.accept_kw("as"):
            alias = self.identifier()
        elif self.tok.kind == "ident":
            alias = self.advance().value
        return ast.SingleColumn(expr, alias)

    # -- relations -----------------------------------------------------

    def _relation(self) -> ast.Relation:
        left = self._sampled_relation()
        while True:
            if self.accept_kw("cross"):
                self.expect_kw("join")
                right = self._sampled_relation()
                left = ast.Join("CROSS", left, right)
                continue
            jt = None
            if self.at_kw("join"):
                jt = "INNER"
            elif self.at_kw("inner") and self.peek().value == "join":
                self.advance()
                jt = "INNER"
            elif self.at_kw("left", "right", "full"):
                jt = self.tok.value.upper()
                self.advance()
                self.accept_kw("outer")
            if jt is None:
                return left
            self.expect_kw("join")
            right = self._sampled_relation()
            if self.accept_kw("on"):
                left = ast.Join(jt, left, right, self._expression())
            elif self.accept_kw("using"):
                self.expect_op("(")
                cols = [self.identifier()]
                while self.accept_op(","):
                    cols.append(self.identifier())
                self.expect_op(")")
                left = ast.Join(jt, left, right, using_columns=tuple(cols))
            else:
                left = ast.Join(jt, left, right)

    def _sampled_relation(self) -> ast.Relation:
        rel = self._relation_primary()
        # alias
        alias = None
        cols: Tuple[str, ...] = ()
        if self.accept_kw("as"):
            alias = self.identifier()
        elif self.tok.kind == "ident":
            alias = self.advance().value
        if alias is not None and self.at_op("(") and isinstance(
                rel, (ast.SubqueryRelation, ast.Values, ast.Table,
                      ast.Unnest)):
            self.advance()
            c = [self.identifier()]
            while self.accept_op(","):
                c.append(self.identifier())
            self.expect_op(")")
            cols = tuple(c)
        if alias is not None:
            return ast.AliasedRelation(rel, alias, cols)
        return rel

    def _relation_primary(self) -> ast.Relation:
        if self.at_op("("):
            self.advance()
            if self.at_kw("select", "with", "values"):
                q = self.parse_query()
                self.expect_op(")")
                return ast.SubqueryRelation(q)
            rel = self._relation()
            self.expect_op(")")
            return rel
        if self.at_kw("unnest"):
            self.advance()
            self.expect_op("(")
            exprs = [self._expression()]
            while self.accept_op(","):
                exprs.append(self._expression())
            self.expect_op(")")
            with_ord = False
            if self.accept_kw("with"):
                self.expect_kw("ordinality")
                with_ord = True
            return ast.Unnest(tuple(exprs), with_ord)
        if self.at_kw("values"):
            self.advance()
            rows = [self._values_row()]
            while self.accept_op(","):
                rows.append(self._values_row())
            return ast.Values(tuple(rows))
        return ast.Table(self.qualified_name())

    # -- expressions (Pratt) -------------------------------------------

    def _expression(self) -> ast.Expression:
        return self._or_expr()

    def _or_expr(self):
        left = self._and_expr()
        while self.accept_kw("or"):
            left = ast.LogicalBinary("OR", left, self._and_expr())
        return left

    def _and_expr(self):
        left = self._not_expr()
        while self.accept_kw("and"):
            left = ast.LogicalBinary("AND", left, self._not_expr())
        return left

    def _not_expr(self):
        if self.accept_kw("not"):
            return ast.NotExpression(self._not_expr())
        return self._predicate()

    def _predicate(self):
        if self.at_kw("exists"):
            self.advance()
            self.expect_op("(")
            q = self.parse_query()
            self.expect_op(")")
            return ast.ExistsPredicate(q)
        left = self._additive()
        while True:
            negated = False
            save = self.i
            if self.accept_kw("not"):
                negated = True
            if self.at_kw("between"):
                self.advance()
                lo = self._additive()
                self.expect_kw("and")
                hi = self._additive()
                node = ast.BetweenPredicate(left, lo, hi)
                left = ast.NotExpression(node) if negated else node
                continue
            if self.at_kw("in"):
                self.advance()
                self.expect_op("(")
                if self.at_kw("select", "with"):
                    q = self.parse_query()
                    self.expect_op(")")
                    node: ast.Expression = ast.InSubquery(left, q)
                else:
                    items = [self._expression()]
                    while self.accept_op(","):
                        items.append(self._expression())
                    self.expect_op(")")
                    node = ast.InPredicate(left, tuple(items))
                left = ast.NotExpression(node) if negated else node
                continue
            if self.at_kw("like"):
                self.advance()
                pattern = self._additive()
                escape = None
                if self.accept_kw("escape"):
                    escape = self._additive()
                node = ast.LikePredicate(left, pattern, escape)
                left = ast.NotExpression(node) if negated else node
                continue
            if negated:
                self.i = save
                break
            if self.at_kw("is"):
                self.advance()
                if self.accept_kw("not"):
                    self.expect_kw("null")
                    left = ast.IsNotNullPredicate(left)
                else:
                    self.expect_kw("null")
                    left = ast.IsNullPredicate(left)
                continue
            if self.tok.kind == "op" and self.tok.value in _CMP_OPS:
                op = self.advance().value
                if self.at_kw("all", "any", "some"):
                    quant = self.advance().value.upper()
                    self.expect_op("(")
                    q = self.parse_query()
                    self.expect_op(")")
                    left = ast.QuantifiedComparison(op, quant, left, q)
                else:
                    left = ast.ComparisonExpression(op, left,
                                                    self._additive())
                continue
            break
        return left

    def _additive(self):
        left = self._multiplicative()
        while True:
            if self.at_op("+", "-"):
                op = self.advance().value
                left = ast.ArithmeticBinary(op, left,
                                            self._multiplicative())
            elif self.at_op("||"):
                self.advance()
                left = ast.FunctionCall("concat",
                                        (left, self._multiplicative()))
            elif (self.tok.kind == "ident" and self.tok.value == "at"
                  and self.peek().kind == "kw"
                  and self.peek().value == "time"
                  and self.peek(2).kind == "ident"
                  and self.peek(2).value == "zone"):
                # AT TIME ZONE ('at'/'zone' stay soft: plain identifiers)
                self.advance()
                self.advance()
                self.advance()
                if self.tok.kind != "string":
                    raise ParseError(
                        "AT TIME ZONE expects a zone string literal at "
                        f"position {self.tok.pos}", self.tok.pos)
                left = ast.AtTimeZone(left, self.advance().value)
            else:
                return left

    def _multiplicative(self):
        left = self._unary()
        while self.at_op("*", "/", "%"):
            op = self.advance().value
            left = ast.ArithmeticBinary(op, left, self._unary())
        return left

    def _unary(self):
        if self.at_op("-"):
            self.advance()
            return ast.ArithmeticUnary("-", self._unary())
        if self.at_op("+"):
            self.advance()
            return self._unary()
        return self._primary_with_suffix()

    def _primary_with_suffix(self):
        e = self._primary()
        while True:
            if self.at_op("."):
                # dereference (alias.column)
                if isinstance(e, (ast.Identifier,
                                  ast.DereferenceExpression)):
                    self.advance()
                    e = ast.DereferenceExpression(e, self.identifier())
                    continue
                break
            if self.at_op("["):
                self.advance()
                idx = self._expression()
                self.expect_op("]")
                e = ast.Subscript(e, idx)
                continue
            break
        return e

    def _primary(self) -> ast.Expression:
        t = self.tok
        if t.kind == "number":
            self.advance()
            if re.match(r"^\d+$", t.value):
                return ast.LongLiteral(int(t.value))
            if "e" in t.value.lower():
                return ast.DoubleLiteral(float(t.value))
            return ast.DecimalLiteral(t.value)
        if t.kind == "string":
            self.advance()
            return ast.StringLiteral(t.value)
        if t.kind == "op" and t.value == "?":
            self.advance()
            return ast.Parameter(0)
        if t.kind == "ident" and t.value == "array" \
                and self.peek().kind == "op" and self.peek().value == "[":
            self.advance()
            self.advance()
            elements = []
            if not self.at_op("]"):
                elements.append(self._expression())
                while self.accept_op(","):
                    elements.append(self._expression())
            self.expect_op("]")
            return ast.ArrayConstructor(tuple(elements))
        if t.kind == "op" and t.value == "(":
            self.advance()
            if self.at_kw("select", "with"):
                q = self.parse_query()
                self.expect_op(")")
                return ast.ScalarSubquery(q)
            e = self._expression()
            if self.at_op(","):
                items = [e]
                while self.accept_op(","):
                    items.append(self._expression())
                self.expect_op(")")
                return ast.Row(tuple(items))
            self.expect_op(")")
            return e
        if t.kind == "kw":
            v = t.value
            if v == "null":
                self.advance()
                return ast.NullLiteral()
            if v == "true":
                self.advance()
                return ast.BooleanLiteral(True)
            if v == "false":
                self.advance()
                return ast.BooleanLiteral(False)
            if v in ("date", "timestamp") and self.peek().kind == "string":
                self.advance()
                return ast.GenericLiteral(v, self.advance().value)
            if v == "interval":
                self.advance()
                sign = 1
                if self.accept_op("-"):
                    sign = -1
                elif self.accept_op("+"):
                    pass
                value = self.advance().value  # string literal
                unit = self.advance().value   # kw
                end_unit = None
                if self.accept_kw("to"):
                    end_unit = self.advance().value
                return ast.IntervalLiteral(value, unit, sign, end_unit)
            if v in ("cast", "try_cast"):
                self.advance()
                self.expect_op("(")
                e = self._expression()
                self.expect_kw("as")
                type_name = self._type_name()
                self.expect_op(")")
                return ast.Cast(e, type_name, safe=(v == "try_cast"))
            if v == "extract":
                self.advance()
                self.expect_op("(")
                field_name = self.advance().value
                self.expect_kw("from")
                e = self._expression()
                self.expect_op(")")
                return ast.Extract(field_name, e)
            if v == "case":
                return self._case()
            if v == "if":
                self.advance()
                self.expect_op("(")
                cond = self._expression()
                self.expect_op(",")
                tv = self._expression()
                fv = None
                if self.accept_op(","):
                    fv = self._expression()
                self.expect_op(")")
                return ast.IfExpression(cond, tv, fv)
            if v == "coalesce":
                self.advance()
                self.expect_op("(")
                args = [self._expression()]
                while self.accept_op(","):
                    args.append(self._expression())
                self.expect_op(")")
                return ast.CoalesceExpression(tuple(args))
            if v == "nullif":
                self.advance()
                self.expect_op("(")
                a = self._expression()
                self.expect_op(",")
                b = self._expression()
                self.expect_op(")")
                return ast.NullIfExpression(a, b)
            if v == "substring":
                self.advance()
                self.expect_op("(")
                s = self._expression()
                if self.accept_kw("from"):
                    start = self._expression()
                    length = None
                    if self.accept_kw("for"):
                        length = self._expression()
                    self.expect_op(")")
                    args = (s, start) if length is None else (s, start,
                                                              length)
                    return ast.FunctionCall("substr", args)
                self.expect_op(",")
                start = self._expression()
                length = None
                if self.accept_op(","):
                    length = self._expression()
                self.expect_op(")")
                args = (s, start) if length is None else (s, start, length)
                return ast.FunctionCall("substr", args)
            if v in ("current_date", "current_timestamp"):
                self.advance()
                return ast.CurrentTime(v)
            if v == "row":
                self.advance()
                self.expect_op("(")
                items = [self._expression()]
                while self.accept_op(","):
                    items.append(self._expression())
                self.expect_op(")")
                return ast.Row(tuple(items))
            if v == "grouping":
                self.advance()
                self.expect_op("(")
                args = [self._expression()]
                while self.accept_op(","):
                    args.append(self._expression())
                self.expect_op(")")
                return ast.FunctionCall("grouping", tuple(args))
        # identifier or function call
        name = self.identifier()
        if self.at_op("("):
            return self._function_call(name)
        return ast.Identifier(name)

    def _case(self):
        self.expect_kw("case")
        operand = None
        if not self.at_kw("when"):
            operand = self._expression()
        whens = []
        while self.accept_kw("when"):
            cond = self._expression()
            self.expect_kw("then")
            whens.append(ast.WhenClause(cond, self._expression()))
        default = None
        if self.accept_kw("else"):
            default = self._expression()
        self.expect_kw("end")
        if operand is not None:
            return ast.SimpleCase(operand, tuple(whens), default)
        return ast.SearchedCase(tuple(whens), default)

    def _function_call(self, name: str) -> ast.Expression:
        self.expect_op("(")
        distinct = False
        args: List[ast.Expression] = []
        if self.at_op("*"):
            self.advance()
            self.expect_op(")")
            fc = ast.FunctionCall(name, (), False)
            return self._maybe_window(fc)
        if not self.at_op(")"):
            if self.accept_kw("distinct"):
                distinct = True
            else:
                self.accept_kw("all")
            args.append(self._expression())
            while self.accept_op(","):
                args.append(self._expression())
        self.expect_op(")")
        return self._maybe_window(
            ast.FunctionCall(name, tuple(args), distinct))

    def _maybe_window(self, fc: ast.FunctionCall) -> ast.Expression:
        if not self.at_kw("over"):
            return fc
        self.advance()
        self.expect_op("(")
        partition: List[ast.Expression] = []
        order: List[ast.SortItem] = []
        frame = None
        if self.accept_kw("partition"):
            self.expect_kw("by")
            partition.append(self._expression())
            while self.accept_op(","):
                partition.append(self._expression())
        if self.accept_kw("order"):
            self.expect_kw("by")
            order.append(self._sort_item())
            while self.accept_op(","):
                order.append(self._sort_item())
        if self.at_kw("rows", "range"):
            ftype = self.advance().value
            if self.accept_kw("between"):
                start = self._frame_bound()
                self.expect_kw("and")
                end = self._frame_bound()
            else:
                start = self._frame_bound()
                end = "CURRENT ROW"
            frame = (ftype, start, end)
        self.expect_op(")")
        return ast.FunctionCall(fc.name, fc.args, fc.distinct,
                                ast.Window(tuple(partition), tuple(order),
                                           frame))

    def _frame_bound(self) -> str:
        if self.accept_kw("unbounded"):
            d = self.advance().value  # preceding | following
            return f"UNBOUNDED {d.upper()}"
        if self.accept_kw("current"):
            self.expect_kw("row")
            return "CURRENT ROW"
        n = self.advance().value
        d = self.advance().value
        return f"{n} {d.upper()}"

    def _type_name(self) -> str:
        base = self.identifier() if self.tok.kind == "ident" \
            else self.advance().value
        out = base
        if self.at_op("("):
            self.advance()
            params = [self.advance().value]
            while self.accept_op(","):
                params.append(self.advance().value)
            self.expect_op(")")
            out = f"{base}({', '.join(params)})"
        if base == "timestamp" and self._accept_with_time_zone():
            out += " with time zone"
        return out

    def _accept_with_time_zone(self) -> bool:
        if self.at_kw("with") and self.peek().kind == "kw" \
                and self.peek().value == "time" \
                and self.peek(2).kind == "ident" \
                and self.peek(2).value == "zone":
            self.advance()
            self.advance()
            self.advance()
            return True
        return False


def parse_statement(sql: str) -> ast.Statement:
    return Parser(sql).parse_statement()


def parse_expression(sql: str) -> ast.Expression:
    p = Parser(sql)
    e = p._expression()
    if p.tok.kind != "eof":
        raise ParseError(f"trailing input at {p.tok.pos}")
    return e
