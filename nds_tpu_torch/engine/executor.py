# Copied from nds_tpu/engine/executor.py; only import paths changed.
"""Plan executor: walks a bound plan and produces columnar Tables.

CTE plans are shared subtrees; results are memoized by node identity so each
CTE executes once per query (the reference gets this from Spark's lazy DAG;
here it is explicit).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from . import ops
from .column import Column, Table
from .exprs import evaluate
from .plan import (
    AggregateNode, BExpr, DistinctNode, FilterNode, JoinNode, LimitNode,
    MaterializedNode, PlanNode, ProjectNode, ScanNode, SetOpNode, SortNode,
    WindowNode,
)


def _loader_takes_columns(loader) -> bool:
    import inspect
    try:
        sig = inspect.signature(loader)
    except (TypeError, ValueError):
        return False
    params = list(sig.parameters.values())
    positional = [p for p in params
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    return len(positional) >= 2 or \
        any(p.kind == p.VAR_POSITIONAL for p in params)


def load_columns(loader: Callable, table: str, columns) -> Table:
    """Column-pruned load when the loader supports projection (scan pruning;
    plain single-argument callables keep working for tests/fallback nodes).
    Shared by the host and device executors."""
    try:
        return loader(table, tuple(columns))
    except TypeError:
        if _loader_takes_columns(loader):
            raise    # genuine TypeError inside a projection-aware loader
        return loader(table)


class Executor:
    def __init__(self, load_table: Callable[[str], Table],
                 trace: Optional[Callable[[str, float, int], None]] = None):
        self._load_table = load_table
        self._memo: dict[int, Table] = {}
        self._trace = trace

    def _load_columns(self, table: str, columns) -> Table:
        return load_columns(self._load_table, table, columns)

    def execute(self, node: PlanNode) -> Table:
        key = id(node)
        if key in self._memo:
            return self._memo[key]
        result = self._run(node)
        self._memo[key] = result
        return result

    def _eval(self, expr: BExpr, table: Table) -> Column:
        return evaluate(expr, table, subquery_eval=self._scalar)

    def _scalar(self, plan: PlanNode):
        t = self.execute(plan)
        if t.num_rows == 0:
            return None
        col = t.columns[0]
        if not bool(col.validity[0]):
            return None
        if col.dtype == "str":
            return col.decode()[0]
        return np.asarray(col.data)[0].item()

    def _run(self, node: PlanNode) -> Table:
        if isinstance(node, MaterializedNode):
            return node.table
        if isinstance(node, ScanNode):
            t = self._load_columns(node.table, node.columns)
            index = {n: i for i, n in enumerate(t.names)}
            cols = [t.columns[index[c]] for c in node.columns]
            return Table(list(node.out_names), cols)
        if isinstance(node, FilterNode):
            child = self.execute(node.child)
            mask = self._eval(node.predicate, child)
            return ops.filter_table(child, mask)
        if isinstance(node, ProjectNode):
            child = self.execute(node.child)
            cols = [self._eval(e, child) for e in node.exprs]
            return Table(list(node.out_names), cols)
        if isinstance(node, JoinNode):
            return self._run_join(node)
        if isinstance(node, AggregateNode):
            return self._run_aggregate(node)
        if isinstance(node, WindowNode):
            return self._run_window(node)
        if isinstance(node, SortNode):
            child = self.execute(node.child)
            key_cols = [self._eval(k.expr, child) for k in node.keys]
            return ops.sort_table(child, key_cols, node.keys)
        if isinstance(node, LimitNode):
            return self.execute(node.child).head(node.n)
        if isinstance(node, DistinctNode):
            return ops.distinct(self.execute(node.child))
        if isinstance(node, SetOpNode):
            left = self.execute(node.left)
            right = self.execute(node.right)
            out = ops.set_op(node.op, node.all, left, right)
            return Table(list(node.out_names), out.columns)
        raise NotImplementedError(type(node).__name__)

    def _run_join(self, node: JoinNode) -> Table:
        left = self.execute(node.left)
        right = self.execute(node.right)
        lkeys = [self._eval(e, left) for e in node.left_keys]
        rkeys = [self._eval(e, right) for e in node.right_keys]
        residual_eval = None
        if node.residual is not None:
            residual_eval = lambda combined: self._eval(node.residual, combined)
        out, _, _ = ops.join(left, right, node.kind, lkeys, rkeys, residual_eval,
                             null_aware=node.null_aware)
        return Table(list(node.out_names), out.columns)

    def _run_aggregate(self, node: AggregateNode) -> Table:
        child = self.execute(node.child)
        group_cols = [self._eval(e, child) for e in node.group_exprs]
        agg_args = [None if a.arg is None else self._eval(a.arg, child)
                    for a in node.aggs]
        g_out, a_out, gid_col = ops.aggregate(child, group_cols, node.aggs,
                                              agg_args, rollup=node.rollup,
                                              levels=node.rollup_levels)
        cols = g_out + a_out
        if node.rollup:
            cols.append(gid_col)
        return Table(list(node.out_names), cols)

    def _run_window(self, node: WindowNode) -> Table:
        child = self.execute(node.child)
        part_cols = [[self._eval(e, child) for e in f.partition_by]
                     for f in node.funcs]
        order_cols = [[self._eval(k.expr, child) for k in f.order_by]
                      for f in node.funcs]
        arg_cols = [None if f.arg is None else self._eval(f.arg, child)
                    for f in node.funcs]
        extra = ops.window(child, node.funcs, part_cols, order_cols, arg_cols)
        return Table(list(node.out_names), list(child.columns) + extra)
