# Copied from nds_tpu/sql/parser.py; only import paths changed.
"""Recursive-descent parser for the NDS SQL dialect (Spark-SQL subset).

Covers the constructs used by the 99 TPC-DS query templates in their Spark
dialect form plus the LF_*/DF_* maintenance statements (CREATE TEMP VIEW,
INSERT INTO, DELETE FROM): CTEs, explicit/comma joins, scalar/IN/EXISTS
subqueries, CASE, CAST, BETWEEN/LIKE/IS NULL, interval arithmetic, window
functions, GROUP BY ROLLUP, set operations, ORDER BY w/ NULLS ordering, LIMIT.
"""
from __future__ import annotations

from .ast_nodes import (
    Between, BinOp, Case, Cast, ColumnRef, CreateView, Delete, DropView, Exists,
    FuncCall, GroupBy, InList, InSubquery, Insert, Interval, IsNull, Join, Like,
    Literal, Query, ScalarSubquery, Select, SelectItem, SetOp, SortItem, Star,
    SubqueryRef, TableRef, UnaryOp, WindowSpec,
)
from .lexer import Token, tokenize


class SqlParseError(ValueError):
    def __init__(self, msg: str, token: Token | None = None, sql: str = ""):
        ctx = ""
        if token is not None and sql:
            lo = max(0, token.pos - 40)
            ctx = f" near ...{sql[lo:token.pos + 20]!r}"
        super().__init__(msg + ctx)


_CMP_OPS = {"=", "<>", "!=", "<", "<=", ">", ">="}

# keywords that may still be used as plain identifiers (column/table/alias names)
_NONRESERVED = {
    "date", "first", "last", "current", "row", "rows", "range", "temp",
    "temporary", "view", "table", "if", "values", "using", "replace",
    "partition", "over", "asc", "desc", "rollup", "nulls", "year",
}


class _Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.tokens = tokenize(sql)
        self.i = 0

    # -- token helpers -----------------------------------------------------
    def peek(self, offset: int = 0) -> Token:
        return self.tokens[min(self.i + offset, len(self.tokens) - 1)]

    def next(self) -> Token:
        tok = self.tokens[self.i]
        if tok.kind != "EOF":
            self.i += 1
        return tok

    def at_kw(self, *words: str) -> bool:
        t = self.peek()
        return t.kind == "KW" and t.value in words

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "OP" and t.value in ops

    def accept_kw(self, *words: str) -> bool:
        if self.at_kw(*words):
            self.next()
            return True
        return False

    def accept_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_kw(self, word: str) -> None:
        if not self.accept_kw(word):
            self.fail(f"expected {word.upper()}")

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            self.fail(f"expected {op!r}")

    def fail(self, msg: str):
        raise SqlParseError(msg, self.peek(), self.sql)

    def ident(self) -> str:
        t = self.peek()
        # non-reserved keywords double as identifiers in TPC-DS output columns
        if t.kind == "IDENT" or (t.kind == "KW" and t.value in _NONRESERVED):
            self.next()
            return t.value
        self.fail("expected identifier")

    # -- statements --------------------------------------------------------
    def parse_statements(self) -> list:
        stmts = []
        while self.peek().kind != "EOF":
            if self.accept_op(";"):
                continue
            stmts.append(self.parse_statement())
        return stmts

    def parse_statement(self):
        if self.at_kw("create"):
            return self.create_view()
        if self.at_kw("insert"):
            return self.insert()
        if self.at_kw("delete"):
            return self.delete()
        if self.at_kw("drop"):
            return self.drop()
        return self.query()

    def create_view(self) -> CreateView:
        self.expect_kw("create")
        if self.accept_kw("or"):
            self.expect_kw("replace")
        temp = self.accept_kw("temp") or self.accept_kw("temporary")
        self.expect_kw("view")
        name = self.ident()
        self.expect_kw("as")
        wrapped = self.accept_op("(")
        q = self.query()
        if wrapped:
            self.expect_op(")")
        return CreateView(name, q, temp=temp)

    def insert(self) -> Insert:
        self.expect_kw("insert")
        self.expect_kw("into")
        self.accept_kw("table")
        name = self.ident()
        wrapped = self.accept_op("(")
        q = self.query()
        if wrapped:
            self.expect_op(")")
        return Insert(name, q)

    def delete(self) -> Delete:
        self.expect_kw("delete")
        self.expect_kw("from")
        name = self.ident()
        where = None
        if self.accept_kw("where"):
            where = self.expr()
        return Delete(name, where)

    def drop(self) -> DropView:
        self.expect_kw("drop")
        if not (self.accept_kw("view") or self.accept_kw("table")):
            self.fail("expected VIEW or TABLE")
        self.accept_kw("if")
        self.accept_kw("exists")
        return DropView(self.ident())

    # -- queries -----------------------------------------------------------
    def query(self) -> Query:
        ctes: list[tuple[str, Query]] = []
        if self.accept_kw("with"):
            while True:
                name = self.ident()
                self.expect_kw("as")
                self.expect_op("(")
                ctes.append((name, self.query()))
                self.expect_op(")")
                if not self.accept_op(","):
                    break
        body = self.set_expr()
        order_by: list[SortItem] = []
        limit = None
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by = self.sort_items()
        if self.accept_kw("limit"):
            t = self.next()
            if t.kind != "NUMBER":
                self.fail("expected number after LIMIT")
            limit = int(t.value)
        return Query(body=body, ctes=ctes, order_by=order_by, limit=limit)

    def set_expr(self):
        # INTERSECT binds tighter than UNION/EXCEPT
        left = self.intersect_expr()
        while self.at_kw("union", "except"):
            op = self.next().value
            all_ = self.accept_kw("all")
            self.accept_kw("distinct")
            right = self.intersect_expr()
            left = SetOp(op, all_, left, right)
        return left

    def intersect_expr(self):
        left = self.select_core()
        while self.at_kw("intersect"):
            self.next()
            all_ = self.accept_kw("all")
            self.accept_kw("distinct")
            right = self.select_core()
            left = SetOp("intersect", all_, left, right)
        return left

    def select_core(self):
        if self.accept_op("("):
            # parenthesized query or set-expr
            q = self.query()
            self.expect_op(")")
            return q
        self.expect_kw("select")
        distinct = self.accept_kw("distinct")
        self.accept_kw("all")
        items = [self.select_item()]
        while self.accept_op(","):
            items.append(self.select_item())
        sel = Select(items=items, distinct=distinct)
        if self.accept_kw("from"):
            sel.from_ = self.from_clause()
        if self.accept_kw("where"):
            sel.where = self.expr()
        if self.accept_kw("group"):
            self.expect_kw("by")
            sel.group_by = self.group_by()
        if self.accept_kw("having"):
            sel.having = self.expr()
        return sel

    def select_item(self) -> SelectItem:
        if self.at_op("*"):
            self.next()
            return SelectItem(Star())
        # qualified star: alias.*
        if (self.peek().kind in ("IDENT", "KW") and self.peek(1).kind == "OP"
                and self.peek(1).value == "." and self.peek(2).value == "*"):
            qual = self.ident()
            self.next()  # .
            self.next()  # *
            return SelectItem(Star(qualifier=qual))
        e = self.expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "IDENT":
            alias = self.ident()
        return SelectItem(e, alias)

    def group_by(self) -> GroupBy:
        if self.accept_kw("rollup"):
            self.expect_op("(")
            exprs = [self.expr()]
            while self.accept_op(","):
                exprs.append(self.expr())
            self.expect_op(")")
            return GroupBy(exprs, rollup=True)
        exprs = [self.expr()]
        while self.accept_op(","):
            exprs.append(self.expr())
        return GroupBy(exprs, rollup=False)

    def sort_items(self) -> list[SortItem]:
        items = [self.sort_item()]
        while self.accept_op(","):
            items.append(self.sort_item())
        return items

    def sort_item(self) -> SortItem:
        e = self.expr()
        asc = True
        if self.accept_kw("asc"):
            asc = True
        elif self.accept_kw("desc"):
            asc = False
        nulls_first = None
        if self.accept_kw("nulls"):
            if self.accept_kw("first"):
                nulls_first = True
            elif self.accept_kw("last"):
                nulls_first = False
            else:
                self.fail("expected FIRST or LAST")
        return SortItem(e, asc=asc, nulls_first=nulls_first)

    # -- FROM --------------------------------------------------------------
    def from_clause(self):
        rel = self.table_primary()
        while True:
            if self.accept_op(","):
                rel = Join(rel, self.table_primary(), kind="cross")
                continue
            kind = None
            if self.accept_kw("cross"):
                kind = "cross"
            elif self.accept_kw("inner"):
                kind = "inner"
            elif self.at_kw("left", "right", "full"):
                kind = self.next().value
                self.accept_kw("outer")
            if kind is not None:
                self.expect_kw("join")
            elif self.accept_kw("join"):
                kind = "inner"
            else:
                break
            right = self.table_primary()
            on = None
            if kind != "cross" and self.accept_kw("on"):
                on = self.expr()
            rel = Join(rel, right, kind=kind, on=on)
        return rel

    def table_primary(self):
        if self.accept_op("("):
            q = self.query()
            self.expect_op(")")
            self.accept_kw("as")
            alias = self.ident()
            return SubqueryRef(q, alias)
        name = self.ident()
        # qualified (catalog-dotted) table name: system.query_log etc. —
        # the parts join into ONE catalog key, same token shapes as the
        # dotted column reference below
        while self.at_op(".") and (
                self.peek(1).kind == "IDENT"
                or (self.peek(1).kind == "KW"
                    and self.peek(1).value in _NONRESERVED)):
            self.next()
            name = f"{name}.{self.ident()}"
        alias = None
        if self.accept_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "IDENT":
            alias = self.ident()
        return TableRef(name, alias)

    # -- expressions -------------------------------------------------------
    def expr(self):
        return self.or_expr()

    def or_expr(self):
        left = self.and_expr()
        while self.accept_kw("or"):
            left = BinOp("or", left, self.and_expr())
        return left

    def and_expr(self):
        left = self.not_expr()
        while self.accept_kw("and"):
            left = BinOp("and", left, self.not_expr())
        return left

    def not_expr(self):
        if self.accept_kw("not"):
            return UnaryOp("not", self.not_expr())
        return self.predicate()

    def predicate(self):
        left = self.add_expr()
        while True:
            if self.at_op(*_CMP_OPS):
                op = self.next().value
                if op == "!=":
                    op = "<>"
                right = self.add_expr()
                left = BinOp(op, left, right)
                continue
            negated = False
            save = self.i
            if self.accept_kw("not"):
                if not self.at_kw("between", "in", "like"):
                    self.i = save
                    return left
                negated = True
            if self.accept_kw("between"):
                low = self.add_expr()
                self.expect_kw("and")
                high = self.add_expr()
                left = Between(left, low, high, negated)
                continue
            if self.accept_kw("in"):
                self.expect_op("(")
                if self.at_kw("select", "with") or self.at_op("("):
                    q = self.query()
                    left = InSubquery(left, q, negated)
                else:
                    items = [self.expr()]
                    while self.accept_op(","):
                        items.append(self.expr())
                    left = InList(left, items, negated)
                self.expect_op(")")
                continue
            if self.accept_kw("like"):
                left = Like(left, self.add_expr(), negated)
                continue
            if self.accept_kw("is"):
                neg = self.accept_kw("not")
                self.expect_kw("null")
                left = IsNull(left, negated=neg)
                continue
            return left

    def add_expr(self):
        left = self.mul_expr()
        while self.at_op("+", "-", "||"):
            op = self.next().value
            left = BinOp(op, left, self.mul_expr())
        return left

    def mul_expr(self):
        left = self.unary_expr()
        while self.at_op("*", "/", "%"):
            op = self.next().value
            left = BinOp(op, left, self.unary_expr())
        return left

    def unary_expr(self):
        if self.at_op("+", "-"):
            op = self.next().value
            return UnaryOp(op, self.unary_expr())
        return self.primary()

    def primary(self):
        t = self.peek()
        if t.kind == "NUMBER":
            self.next()
            text = t.value
            if "." in text or "e" in text or "E" in text:
                return Literal(float(text))
            return Literal(int(text))
        if t.kind == "STRING":
            self.next()
            return Literal(t.value)
        if self.at_kw("null"):
            self.next()
            return Literal(None)
        if self.at_kw("date") and self.peek(1).kind == "STRING":
            self.next()
            lit = self.next()
            return Literal(lit.value, type_hint="date")
        if self.at_kw("interval"):
            self.next()
            value = self.unary_expr()
            unit = self.ident().rstrip("s")  # day/days, month/months, year/years
            return Interval(value, unit)
        if self.at_kw("case"):
            return self.case_expr()
        if self.at_kw("cast"):
            return self.cast_expr()
        if self.at_kw("exists"):
            self.next()
            self.expect_op("(")
            q = self.query()
            self.expect_op(")")
            return Exists(q)
        if self.accept_op("("):
            if self.at_kw("select", "with"):
                q = self.query()
                self.expect_op(")")
                return ScalarSubquery(q)
            e = self.expr()
            self.expect_op(")")
            return e
        if t.kind == "IDENT" or (t.kind == "KW" and t.value in _NONRESERVED):
            return self.name_or_call()
        self.fail("expected expression")

    def case_expr(self) -> Case:
        self.expect_kw("case")
        operand = None
        if not self.at_kw("when"):
            operand = self.expr()
        whens = []
        while self.accept_kw("when"):
            cond = self.expr()
            self.expect_kw("then")
            whens.append((cond, self.expr()))
        else_ = None
        if self.accept_kw("else"):
            else_ = self.expr()
        self.expect_kw("end")
        return Case(operand, whens, else_)

    def cast_expr(self) -> Cast:
        self.expect_kw("cast")
        self.expect_op("(")
        e = self.expr()
        self.expect_kw("as")
        to_type = self.type_name()
        self.expect_op(")")
        return Cast(e, to_type)

    def type_name(self) -> str:
        base = self.ident()
        if self.accept_op("("):
            nums = [self.next().value]
            while self.accept_op(","):
                nums.append(self.next().value)
            self.expect_op(")")
            return f"{base}({','.join(nums)})"
        return base

    def name_or_call(self):
        name = self.ident()
        # function call
        if self.at_op("(") and name != "date":
            self.next()
            distinct = self.accept_kw("distinct")
            args: list = []
            if self.at_op("*"):
                self.next()
                args.append(Star())
            elif not self.at_op(")"):
                args.append(self.expr())
                while self.accept_op(","):
                    args.append(self.expr())
            self.expect_op(")")
            over = None
            if self.accept_kw("over"):
                over = self.window_spec()
            return FuncCall(name, args, distinct=distinct, over=over)
        # dotted column reference
        parts = [name]
        while self.at_op(".") and (
                self.peek(1).kind == "IDENT"
                or (self.peek(1).kind == "KW" and self.peek(1).value in _NONRESERVED)):
            self.next()
            parts.append(self.ident())
        return ColumnRef(tuple(parts))

    def window_spec(self) -> WindowSpec:
        self.expect_op("(")
        spec = WindowSpec()
        if self.accept_kw("partition"):
            self.expect_kw("by")
            spec.partition_by.append(self.expr())
            while self.accept_op(","):
                spec.partition_by.append(self.expr())
        if self.accept_kw("order"):
            self.expect_kw("by")
            spec.order_by = self.sort_items()
        # frame clause: consume tokens up to the closing paren (frames beyond the
        # default are recorded but not interpreted; TPC-DS uses default frames)
        frame_toks = []
        depth = 0
        while not (depth == 0 and self.at_op(")")):
            tok = self.next()
            if tok.kind == "EOF":
                self.fail("unterminated window spec")
            if tok.kind == "OP" and tok.value == "(":
                depth += 1
            elif tok.kind == "OP" and tok.value == ")":
                depth -= 1
            frame_toks.append(tok.value)
        self.expect_op(")")
        if frame_toks:
            spec.frame = " ".join(frame_toks)
        return spec


def parse_sql(sql: str) -> Query:
    """Parse a single SELECT query (the power-run path)."""
    p = _Parser(sql)
    q = p.parse_statement()
    p.accept_op(";")
    if p.peek().kind != "EOF":
        p.fail("trailing tokens after statement")
    if not isinstance(q, Query):
        raise SqlParseError("expected a SELECT query")
    return q


def parse_statements(sql: str) -> list:
    """Parse a ;-separated script (maintenance functions)."""
    return _Parser(sql).parse_statements()
