# Copied from nds_tpu/engine/streaming.py: only the plan-rewrite helpers the
# planner imports (_mergeable, _decompose, _final_builder, _expr_subplans,
# substitute_nodes), verbatim. The morsel-streaming executor itself is not
# part of the port.
"""Plan-rewrite helpers shared by the planner (from the out-of-core module)."""
from __future__ import annotations

import dataclasses
from dataclasses import replace

from . import plan as P
from .plan import (AggregateNode, AggSpec, BCall, BCol, MaterializedNode,
                   PlanNode, ProjectNode)


def _mergeable(agg: AggregateNode) -> bool:
    if any(s.distinct for s in agg.aggs):
        return False
    return all(s.func in ("sum", "count", "count_star", "min", "max", "avg")
               for s in agg.aggs)


def _decompose(agg: AggregateNode):
    """Per-branch partial agg specs + merge recipes (shared logic with the
    single-path flow)."""
    ngroups = len(agg.group_exprs)
    partial_specs: list[AggSpec] = []
    recipes: list[tuple[str, list[int]]] = []
    for spec in agg.aggs:
        base = len(partial_specs) + ngroups
        if spec.func == "count_star":
            partial_specs.append(replace(spec, name=f"{spec.name}__cs"))
            recipes.append(("sum_int", [base]))
        elif spec.func == "count":
            partial_specs.append(replace(spec, name=f"{spec.name}__c"))
            recipes.append(("sum_int", [base]))
        elif spec.func in ("min", "max"):
            partial_specs.append(spec)
            recipes.append((spec.func, [base]))
        elif spec.func == "sum":
            partial_specs.append(replace(spec, name=f"{spec.name}__s"))
            partial_specs.append(AggSpec("count", spec.arg, False,
                                         f"{spec.name}__n"))
            recipes.append(("sum_guarded", [base, base + 1]))
        else:  # avg
            partial_specs.append(AggSpec("sum", spec.arg, False,
                                         f"{spec.name}__s"))
            partial_specs.append(AggSpec("count", spec.arg, False,
                                         f"{spec.name}__n"))
            recipes.append(("avg", [base, base + 1]))
    p_names = ([f"g{i}" for i in range(ngroups)] +
               [s.name for s in partial_specs])
    p_dtypes = ([e.dtype for e in agg.group_exprs] +
                [s.dtype for s in partial_specs])
    if agg.rollup:
        p_names = p_names + ["__grouping_id"]
        p_dtypes = p_dtypes + ["int"]
    return partial_specs, recipes, p_names, p_dtypes


def _final_builder(agg: AggregateNode, recipes, p_names, p_dtypes):
    """The merge-plan factory over unioned partials (identical semantics to
    the single-path flow's build_final)."""
    ngroups = len(agg.group_exprs)

    def build_final(partials: MaterializedNode) -> PlanNode:
        nmerge = ngroups + (1 if agg.rollup else 0)
        gidx = list(range(ngroups))
        if agg.rollup:
            gidx.append(len(p_names) - 1)
        group_refs = [BCol(p_dtypes[i], i, p_names[i]) for i in gidx]
        merge_specs: list[AggSpec] = []
        for spec, (kind, idxs) in zip(agg.aggs, recipes):
            if kind in ("min", "max"):
                merge_specs.append(AggSpec(
                    kind, BCol(p_dtypes[idxs[0]], idxs[0]), False, spec.name))
            else:
                for j in idxs:
                    merge_specs.append(AggSpec(
                        "sum", BCol(p_dtypes[j], j), False, p_names[j]))
        m_names = ([p_names[i] for i in gidx] +
                   [s.name for s in merge_specs])
        m_dtypes = ([p_dtypes[i] for i in gidx] +
                    [s.dtype for s in merge_specs])
        merged = AggregateNode(child=partials, group_exprs=group_refs,
                               aggs=merge_specs,
                               out_names=m_names, out_dtypes=m_dtypes)
        exprs: list = [BCol(m_dtypes[i], i, m_names[i])
                       for i in range(ngroups)]
        col = nmerge
        for spec, (kind, idxs) in zip(agg.aggs, recipes):
            if kind in ("min", "max", "sum_int"):
                exprs.append(BCol(spec.dtype, col))
                col += 1
            elif kind == "sum_guarded":
                s_ref = BCol(m_dtypes[col], col)
                n_ref = BCol("int", col + 1)
                cond = BCall("bool", "gt", [n_ref, P.BLit("int", 0)])
                exprs.append(BCall(spec.dtype, "case",
                                   [cond, s_ref, P.BLit(spec.dtype, None)]))
                col += 2
            else:  # avg
                s_ref = BCol(m_dtypes[col], col)
                n_ref = BCol("int", col + 1)
                exprs.append(BCall("float", "div", [s_ref, n_ref]))
                col += 2
        if agg.rollup:
            exprs.append(BCol("int", ngroups, "__grouping_id"))
        return ProjectNode(merged, exprs, out_names=list(agg.out_names),
                           out_dtypes=list(agg.out_dtypes))
    return build_final


def _expr_subplans(node: PlanNode):
    """Plans embedded in this node's EXPRESSIONS (BScalarSubquery) —
    q9-class scalar-subquery aggregates over big scans live there."""
    out: list[PlanNode] = []

    def rec(x) -> None:
        if isinstance(x, P.BScalarSubquery):
            out.append(x.plan)
            return
        if isinstance(x, PlanNode):
            return                    # child plans handled by the visitor
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                rec(getattr(x, f.name))
        elif isinstance(x, (list, tuple)):
            for v in x:
                rec(v)

    for f in dataclasses.fields(node):
        if f.name in ("child", "left", "right"):
            continue
        rec(getattr(node, f.name))
    return out


def substitute_nodes(root: PlanNode, mapping: dict) -> PlanNode:
    """Rebuild `root` with nodes replaced by id. Mapping values are either
    a replacement PlanNode (subtree swap, no descent) or a dict of field
    patches applied AFTER children rebuild (semi-join right-side swap).
    Descends expression-embedded subquery plans too; shared nodes rebuild
    once, preserving DAG sharing."""
    memo: dict[int, PlanNode] = {}

    def rw_any(x):
        if isinstance(x, PlanNode):
            return rw(x)
        if isinstance(x, P.BScalarSubquery):
            p = rw(x.plan)
            return x if p is x.plan else replace(x, plan=p)
        if isinstance(x, MaterializedNode):
            return x
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            changes = {}
            for f in dataclasses.fields(x):
                v = getattr(x, f.name)
                nv = rw_any(v)
                if nv is not v:
                    changes[f.name] = nv
            return replace(x, **changes) if changes else x
        if isinstance(x, list):
            out = [rw_any(v) for v in x]
            return out if any(a is not b for a, b in zip(out, x)) else x
        if isinstance(x, tuple):
            out = tuple(rw_any(v) for v in x)
            return out if any(a is not b for a, b in zip(out, x)) else x
        return x

    def rw(node: PlanNode) -> PlanNode:
        patch = mapping.get(id(node))
        if isinstance(patch, PlanNode):
            return patch
        if id(node) in memo:
            return memo[id(node)]
        if isinstance(node, MaterializedNode):
            memo[id(node)] = node
            return node
        repl = {}
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            nv = rw_any(v)
            if nv is not v:
                repl[f.name] = nv
        out = replace(node, **repl) if repl else node
        if isinstance(patch, dict):
            out = replace(out, **patch)
        memo[id(node)] = out
        return out

    return rw(root)
