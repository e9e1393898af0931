# Copied from nds_tpu/engine/colprune.py; only import paths changed.
"""Projection pushdown: prune unused columns from a bound plan.

The planner binds scans to EVERY table column and joins concatenate full
schemas, so without this pass a star join carries fact-table-wide rows
through the whole pipeline (query72's 10-table join is 218 columns wide
while its aggregate needs 8). The reference gets this from Spark's
ColumnPruning + parquet column projection (reference
nds/nds_power.py:124-134 delegates to the Catalyst optimizer); here it is
an explicit plan rewrite shared by all executors (host oracle, device,
streaming), cutting scan IO, device upload, join gather width, and
record-pass memory at once.

Two passes over the plan DAG:
1. collect: per-node set of needed output indices, monotonically grown to
   a fixpoint (shared CTE subtrees take the UNION over all consumers so a
   shared node is still materialized once);
2. rebuild: bottom-up reconstruction where each node keeps only needed
   outputs, with every expression's column indices remapped. Relative
   column order is preserved (kept index lists are ascending), so the root
   output is unchanged.

Nodes whose semantics span the full row (DISTINCT, non-ALL set ops) force
all their input columns needed. Aggregate/Window function lists are kept
as-is (their children still prune — that is where the width lives).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .plan import (
    AggregateNode, BCol, BExpr, BScalarSubquery, DistinctNode, FilterNode,
    JoinNode, LimitNode, MaterializedNode, PlanNode, ProjectNode, ScanNode,
    SetOpNode, SortNode, VirtualScanNode, WindowNode, iter_plan_nodes,
)


def _expr_refs(x, out: set[int], subplans: list) -> None:
    """Column indices referenced by an expression tree; embedded subquery
    plans are collected separately (their indices live in their own space)."""
    if isinstance(x, BCol):
        out.add(x.index)
        return
    if isinstance(x, BScalarSubquery):
        subplans.append(x.plan)
        return
    if isinstance(x, BExpr) or (dataclasses.is_dataclass(x)
                                and not isinstance(x, type)):
        for f in dataclasses.fields(x):
            _expr_refs(getattr(x, f.name), out, subplans)
        return
    if isinstance(x, (list, tuple)):
        for v in x:
            _expr_refs(v, out, subplans)


def _remap_expr(x, mapping: dict[int, int], rebuild_plan=None):
    """Functionally rewrite BCol indices through `mapping`; embedded
    subquery plans are rewritten via rebuild_plan (their own index space)."""
    if isinstance(x, BCol):
        return dataclasses.replace(x, index=mapping[x.index])
    if isinstance(x, BScalarSubquery):
        if rebuild_plan is None:
            return x
        p = rebuild_plan(x.plan)
        return x if p is x.plan else dataclasses.replace(x, plan=p)
    if isinstance(x, PlanNode):
        raise AssertionError("plan node in expression position")
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        changes = {}
        for f in dataclasses.fields(x):
            v = getattr(x, f.name)
            nv = _remap_expr(v, mapping, rebuild_plan)
            if nv is not v:
                changes[f.name] = nv
        return dataclasses.replace(x, **changes) if changes else x
    if isinstance(x, list):
        out = [_remap_expr(v, mapping, rebuild_plan) for v in x]
        return out if any(a is not b for a, b in zip(out, x)) else x
    if isinstance(x, tuple):
        out = tuple(_remap_expr(v, mapping, rebuild_plan) for v in x)
        return out if any(a is not b for a, b in zip(out, x)) else x
    return x


def _width(node: PlanNode) -> int:
    return len(node.out_names)


class _Pruner:
    def __init__(self) -> None:
        self.needed: dict[int, set[int]] = {}
        self.by_id: dict[int, PlanNode] = {}
        self.built: dict[int, tuple[PlanNode, dict[int, int]]] = {}

    # -- pass 1: needed-set fixpoint ----------------------------------------
    def collect(self, node: PlanNode, req: set[int]) -> None:
        self.by_id[id(node)] = node
        if id(node) not in self.needed:
            self.needed[id(node)] = set(req)
            self._propagate(node, self.needed[id(node)])
            return
        cur = self.needed[id(node)]
        if req <= cur:
            return
        cur |= req
        self._propagate(node, cur)

    def _exprs_req(self, *exprs) -> set[int]:
        refs: set[int] = set()
        subs: list = []
        for e in exprs:
            _expr_refs(e, refs, subs)
        for p in subs:
            self.collect(p, set(range(_width(p))))
        return refs

    def _propagate(self, node: PlanNode, need: set[int]) -> None:
        if isinstance(node, (ScanNode, MaterializedNode, VirtualScanNode)):
            return
        if isinstance(node, FilterNode):
            self.collect(node.child,
                         need | self._exprs_req(node.predicate))
            return
        if isinstance(node, ProjectNode):
            keep = sorted(need) or [0]   # must mirror _keep's normalization
            self.collect(node.child, self._exprs_req(
                *[node.exprs[i] for i in keep]))
            return
        if isinstance(node, JoinNode):
            w = _width(node.left)
            lreq = {i for i in need if i < w} if node.kind not in (
                "semi", "anti") else set(need)
            rreq = {i - w for i in need if i >= w} if node.kind not in (
                "semi", "anti") else set()
            lreq |= self._exprs_req(*node.left_keys)
            rreq |= self._exprs_req(*node.right_keys)
            if node.residual is not None:
                res = self._exprs_req(node.residual)
                lreq |= {i for i in res if i < w}
                rreq |= {i - w for i in res if i >= w}
            self.collect(node.left, lreq)
            self.collect(node.right, rreq)
            return
        if isinstance(node, AggregateNode):
            self.collect(node.child, self._exprs_req(
                node.group_exprs, [a.arg for a in node.aggs
                                   if a.arg is not None]))
            return
        if isinstance(node, WindowNode):
            w = _width(node.child)
            req = {i for i in need if i < w}
            req |= self._exprs_req(
                [f.arg for f in node.funcs if f.arg is not None],
                [f.partition_by for f in node.funcs],
                [[k.expr for k in f.order_by] for f in node.funcs])
            self.collect(node.child, req)
            return
        if isinstance(node, SortNode):
            self.collect(node.child, need | self._exprs_req(
                [k.expr for k in node.keys]))
            return
        if isinstance(node, LimitNode):
            self.collect(node.child, set(need))
            return
        if isinstance(node, DistinctNode):
            self.collect(node.child, set(range(_width(node.child))))
            return
        if isinstance(node, SetOpNode):
            if node.op == "union" and node.all:
                req = set(need) or {0}   # must mirror _keep's normalization
                self.collect(node.left, req)
                self.collect(node.right, req)
            else:  # row-equality semantics: every column participates
                self.collect(node.left, set(range(_width(node.left))))
                self.collect(node.right, set(range(_width(node.right))))
            return
        raise AssertionError(f"unhandled plan node {type(node).__name__}")

    # -- pass 2: rebuild ----------------------------------------------------
    def _keep(self, node: PlanNode) -> list[int]:
        need = self.needed.get(id(node), set())
        if not need:
            need = {0}  # row-presence carrier (e.g. COUNT(*) over a scan)
        return sorted(need)

    def rebuild(self, node: PlanNode) -> tuple[PlanNode, dict[int, int]]:
        if id(node) in self.built:
            return self.built[id(node)]
        out = self._rebuild(node)
        self.built[id(node)] = out
        return out

    def _sub(self, plan: PlanNode) -> PlanNode:
        return self.rebuild(plan)[0]

    def _remap(self, x, mapping: dict[int, int]):
        return _remap_expr(x, mapping, rebuild_plan=self._sub)

    def _passthrough(self, node: PlanNode, cmap: dict[int, int],
                     new_child: PlanNode, **extra):
        """Rebuild a width-preserving node: output follows the pruned child."""
        kept = sorted(cmap, key=lambda i: cmap[i])
        return dataclasses.replace(
            node, child=new_child,
            out_names=[node.out_names[i] for i in kept],
            out_dtypes=[node.out_dtypes[i] for i in kept], **extra), dict(cmap)

    def _rebuild(self, node: PlanNode) -> tuple[PlanNode, dict[int, int]]:
        if isinstance(node, (MaterializedNode, VirtualScanNode)):
            return node, {i: i for i in range(_width(node))}
        if isinstance(node, ScanNode):
            keep = self._keep(node)
            if len(keep) == _width(node):
                return node, {i: i for i in keep}
            return ScanNode(
                node.table, [node.columns[i] for i in keep],
                out_names=[node.out_names[i] for i in keep],
                out_dtypes=[node.out_dtypes[i] for i in keep]), \
                {i: p for p, i in enumerate(keep)}
        if isinstance(node, FilterNode):
            child, cmap = self.rebuild(node.child)
            return self._passthrough(node, cmap, child,
                                     predicate=self._remap(node.predicate,
                                                           cmap))
        if isinstance(node, ProjectNode):
            child, cmap = self.rebuild(node.child)
            keep = self._keep(node)
            return ProjectNode(
                child, [self._remap(node.exprs[i], cmap) for i in keep],
                out_names=[node.out_names[i] for i in keep],
                out_dtypes=[node.out_dtypes[i] for i in keep]), \
                {i: p for p, i in enumerate(keep)}
        if isinstance(node, JoinNode):
            left, lmap = self.rebuild(node.left)
            right, rmap = self.rebuild(node.right)
            w, nw = _width(node.left), _width(left)
            comb = dict(lmap)
            comb.update({w + j: nw + rmap[j] for j in rmap})
            residual = None if node.residual is None else \
                self._remap(node.residual, comb)
            if node.kind in ("semi", "anti"):
                out_map = dict(lmap)
                names = list(left.out_names)
                dtypes = list(left.out_dtypes)
            else:
                out_map = comb
                names = list(left.out_names) + list(right.out_names)
                dtypes = list(left.out_dtypes) + list(right.out_dtypes)
            return JoinNode(
                left, right, node.kind,
                [self._remap(k, lmap) for k in node.left_keys],
                [self._remap(k, rmap) for k in node.right_keys],
                residual, null_aware=node.null_aware,
                late_mat=node.late_mat,
                out_names=names, out_dtypes=dtypes), out_map
        if isinstance(node, AggregateNode):
            child, cmap = self.rebuild(node.child)
            return dataclasses.replace(
                node, child=child,
                group_exprs=[self._remap(e, cmap) for e in node.group_exprs],
                aggs=[self._remap(a, cmap) for a in node.aggs]), \
                {i: i for i in range(_width(node))}
        if isinstance(node, WindowNode):
            child, cmap = self.rebuild(node.child)
            w, nw = _width(node.child), _width(child)
            kept = sorted(cmap, key=lambda i: cmap[i])
            out_map = dict(cmap)
            out_map.update({w + k: nw + k for k in range(len(node.funcs))})
            return dataclasses.replace(
                node, child=child,
                funcs=[self._remap(f, cmap) for f in node.funcs],
                out_names=[node.out_names[i] for i in kept] +
                          list(node.out_names[w:]),
                out_dtypes=[node.out_dtypes[i] for i in kept] +
                           list(node.out_dtypes[w:])), out_map
        if isinstance(node, SortNode):
            child, cmap = self.rebuild(node.child)
            return self._passthrough(
                node, cmap, child,
                keys=[self._remap(k, cmap) for k in node.keys])
        if isinstance(node, LimitNode):
            child, cmap = self.rebuild(node.child)
            return self._passthrough(node, cmap, child)
        if isinstance(node, DistinctNode):
            child, cmap = self.rebuild(node.child)
            return self._passthrough(node, cmap, child)
        if isinstance(node, SetOpNode):
            left, lmap = self.rebuild(node.left)
            right, rmap = self.rebuild(node.right)
            keep = (self._keep(node) if node.op == "union" and node.all
                    else list(range(_width(node))))
            left = _project_onto(left, lmap, keep, node)
            right = _project_onto(right, rmap, keep, node)
            return SetOpNode(
                node.op, node.all, left, right,
                out_names=[node.out_names[i] for i in keep],
                out_dtypes=[node.out_dtypes[i] for i in keep]), \
                {i: p for p, i in enumerate(keep)}
        raise AssertionError(f"unhandled plan node {type(node).__name__}")


def _project_onto(branch: PlanNode, bmap: dict[int, int], keep: list[int],
                  setop: SetOpNode) -> PlanNode:
    """Force a set-op branch onto exactly the kept positional layout (both
    branches must line up column-for-column even when one carries extra
    passthrough columns, e.g. a Filter child keeping its predicate cols)."""
    want = [bmap[i] for i in keep]
    if want == list(range(_width(branch))):
        return branch
    return ProjectNode(
        branch,
        [BCol(branch.out_dtypes[j], j, branch.out_names[j]) for j in want],
        out_names=[branch.out_names[j] for j in want],
        out_dtypes=[branch.out_dtypes[j] for j in want])


def prune_plan(root: PlanNode) -> PlanNode:
    """Return an equivalent plan reading/carrying only needed columns.

    The root's output schema is preserved exactly; `cte_segments` (compile
    segmentation candidates) transfer to the rebuilt nodes under their
    original fingerprints — CTE outputs stay full-width so the segment
    cache slot is identical across statements sharing a WITH clause."""
    pr = _Pruner()
    segs = getattr(root, "cte_segments", None)
    if segs:
        # CTE segmentation candidates keep their FULL output width: their
        # compile-segment fingerprints are shared across statements (q14/q23
        # parts), and consumer-dependent pruning would fork the segment
        # cache slot per statement, re-materializing shared CTEs. The CTE's
        # internals still prune (that is where the join/scan width lives).
        reachable = {id(n) for n in iter_plan_nodes(root)}
        for _fp, node in segs:
            if id(node) in reachable:
                pr.collect(node, set(range(_width(node))))
    pr.collect(root, set(range(_width(root))))
    new_root, rmap = pr.rebuild(root)
    if [rmap.get(i) for i in range(_width(root))] != \
            list(range(_width(root))):
        # a passthrough root kept extra expression-only columns: restore the
        # exact original output layout
        new_root = ProjectNode(
            new_root,
            [BCol(root.out_dtypes[i], rmap[i], root.out_names[i])
             for i in range(_width(root))],
            out_names=list(root.out_names),
            out_dtypes=list(root.out_dtypes))
    if segs is not None:
        new_segs = []
        for fp, node in segs:
            if id(node) not in pr.built:
                continue  # CTE never referenced by the pruned plan
            built, _ = pr.built[id(node)]
            new_segs.append((fp, built))
        new_root.cte_segments = new_segs
    return new_root
