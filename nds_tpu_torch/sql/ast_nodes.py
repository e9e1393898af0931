# Copied from nds_tpu/sql/ast_nodes.py; only import paths changed.
"""AST node definitions for the SQL frontend."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union


class Node:
    pass


# --------------------------------------------------------------------------
# expressions
# --------------------------------------------------------------------------

@dataclass
class Literal(Node):
    value: object          # int | float | str | bool | None
    type_hint: str = ""    # "date" for DATE '...' literals


@dataclass
class ColumnRef(Node):
    parts: tuple[str, ...]  # ("alias", "col") or ("col",)

    @property
    def name(self) -> str:
        return self.parts[-1]

    @property
    def qualifier(self) -> Optional[str]:
        return self.parts[0] if len(self.parts) > 1 else None


@dataclass
class Star(Node):
    qualifier: Optional[str] = None


@dataclass
class WindowSpec(Node):
    partition_by: list[Node] = field(default_factory=list)
    order_by: list["SortItem"] = field(default_factory=list)
    frame: Optional[str] = None  # raw text of frame clause, informational


@dataclass
class FuncCall(Node):
    name: str
    args: list[Node]
    distinct: bool = False
    over: Optional[WindowSpec] = None


@dataclass
class BinOp(Node):
    op: str  # + - * / % = <> < <= > >= and or ||
    left: Node
    right: Node


@dataclass
class UnaryOp(Node):
    op: str  # - + not
    operand: Node


@dataclass
class Case(Node):
    operand: Optional[Node]             # CASE x WHEN ... (simple) if not None
    whens: list[tuple[Node, Node]]      # (condition/value, result)
    else_: Optional[Node] = None


@dataclass
class Cast(Node):
    expr: Node
    to_type: str  # normalized lowercase type text, e.g. "decimal(15,2)", "int"


@dataclass
class Between(Node):
    expr: Node
    low: Node
    high: Node
    negated: bool = False


@dataclass
class InList(Node):
    expr: Node
    items: list[Node]
    negated: bool = False


@dataclass
class InSubquery(Node):
    expr: Node
    query: "Query"
    negated: bool = False


@dataclass
class Exists(Node):
    query: "Query"
    negated: bool = False


@dataclass
class ScalarSubquery(Node):
    query: "Query"


@dataclass
class Like(Node):
    expr: Node
    pattern: Node
    negated: bool = False


@dataclass
class IsNull(Node):
    expr: Node
    negated: bool = False


@dataclass
class Interval(Node):
    value: Node
    unit: str  # singular: "day", "month", "year" (parser normalizes plurals)


# --------------------------------------------------------------------------
# relations / query structure
# --------------------------------------------------------------------------

@dataclass
class SortItem(Node):
    expr: Node
    asc: bool = True
    nulls_first: Optional[bool] = None  # None => dialect default (asc: first, desc: last)


@dataclass
class SelectItem(Node):
    expr: Node
    alias: Optional[str] = None


@dataclass
class TableRef(Node):
    name: str
    alias: Optional[str] = None


@dataclass
class SubqueryRef(Node):
    query: "Query"
    alias: str


@dataclass
class Join(Node):
    left: Node
    right: Node
    kind: str = "inner"  # inner, left, right, full, cross
    on: Optional[Node] = None


@dataclass
class GroupBy(Node):
    exprs: list[Node] = field(default_factory=list)
    rollup: bool = False


@dataclass
class Select(Node):
    items: list[SelectItem] = field(default_factory=list)
    distinct: bool = False
    from_: Optional[Node] = None  # TableRef | SubqueryRef | Join
    where: Optional[Node] = None
    group_by: Optional[GroupBy] = None
    having: Optional[Node] = None


@dataclass
class SetOp(Node):
    op: str  # union, intersect, except
    all: bool
    left: Node  # Select | SetOp | Query
    right: Node


@dataclass
class Query(Node):
    body: Node  # Select | SetOp
    ctes: list[tuple[str, "Query"]] = field(default_factory=list)
    order_by: list[SortItem] = field(default_factory=list)
    limit: Optional[int] = None


# --------------------------------------------------------------------------
# statements (maintenance functions)
# --------------------------------------------------------------------------

@dataclass
class CreateView(Node):
    name: str
    query: Query
    temp: bool = True


@dataclass
class Insert(Node):
    table: str
    query: Query


@dataclass
class Delete(Node):
    table: str
    where: Optional[Node] = None


@dataclass
class DropView(Node):
    name: str


Statement = Union[Query, CreateView, Insert, Delete, DropView]
