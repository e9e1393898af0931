# Copied from nds_tpu/engine/planner.py; only import paths changed.
"""AST -> bound logical plan.

Responsibilities:
- name resolution (qualifiers, aliases, CTEs, self-joins) to column positions;
- join-graph extraction from comma-joins + WHERE equalities, with a
  size-heuristic greedy join order (facts probe, dimensions build);
- subquery handling: uncorrelated scalars (runtime-evaluated), IN/EXISTS as
  semi/anti joins, and decorrelation of equality-correlated scalar aggregate
  subqueries into grouped left joins (the TPC-DS q1/q6/q44 pattern);
- aggregate & window rebinding: aggregate calls and group expressions become
  positional columns for post-agg expressions (HAVING/SELECT/ORDER BY).

The reference delegates all of this to Spark Catalyst (nds_power.py:129
`spark.sql(query)`); this module is the TPU framework's Catalyst analog.
"""
from __future__ import annotations

import datetime as _dt
import os
import re
from dataclasses import dataclass, field, replace
from typing import Callable, Optional

import numpy as np

from ..sql import ast_nodes as A
from . import plan as P
from .column import dec_dtype, dec_scale, is_dec


class PlanError(ValueError):
    pass


class PassPipeline:
    """Runs the planner's top-level rewrite passes with machine-checked IR
    invariants between them (engine/verify.py), under
    ``EngineConfig.verify_plans``:

    - ``off``: zero verification cost — passes run exactly as before;
    - ``final``: the fully rewritten plan is verified once per statement
      (cheap safety net for CI);
    - ``per-pass``: every pass output is verified, each pass's input is
      fingerprint-snapshotted so in-place mutation of surviving (shared)
      nodes is caught (the `_exact_rational_keys` hazard class, ADVICE r5),
      and a violation raises PlanVerifyError naming the offending node AND
      the pass that introduced it — the pass whose output first fails.

    Two of the last three rounds shipped fixes for bugs rewrite passes
    introduced silently; this is the safety net cheaper than a SQLite
    differential run."""

    def __init__(self, mode: str, catalog: Optional["Catalog"] = None):
        if mode not in ("off", "final", "per-pass"):
            raise PlanError(f"unknown verify_plans mode {mode!r} "
                            "(expected off, final, or per-pass)")
        self.mode = mode
        self.catalog = catalog
        # rolling fingerprint snapshot of the last verified plan (per-pass
        # mode): each pass's freeze scan doubles as the next pass's
        # snapshot, so verification pays one fingerprint walk per pass
        self._snap: Optional[dict] = None

    def _verify(self, plan, pass_name: str, deep: bool = False) -> None:
        from ..obs.trace import TRACER
        from .verify import PlanVerifyError, node_labels, verify_plan
        with TRACER.span("plan.verify", **{"pass": pass_name}):
            labels = node_labels(plan)
            findings = verify_plan(plan, self.catalog, deep=deep,
                                   labels=labels)
        if findings:
            raise PlanVerifyError(findings, pass_name)

    def check(self, pass_name: str, plan):
        """Verify a pass-less snapshot (the freshly bound plan)."""
        if self.mode == "per-pass":
            self._verify(plan, pass_name)
            from .verify import snapshot
            self._snap = snapshot(plan)
        return plan

    def run(self, pass_name: str, fn, plan):
        """Run one rewrite pass; in per-pass mode, prove surviving nodes
        are structurally frozen and the output plan verifies clean. Every
        pass (and its verification, via _verify) is a traced span, so a
        Perfetto view of planning shows per-pass cost."""
        from ..obs.trace import TRACER
        if self.mode != "per-pass":
            with TRACER.span("plan.pass", **{"pass": pass_name}):
                return fn(plan)
        from .verify import PlanVerifyError, frozen_scan, verify_plan
        before = self._snap if self._snap is not None else \
            frozen_scan(plan, None)[1]
        with TRACER.span("plan.pass", **{"pass": pass_name}):
            out = fn(plan)
        findings, after = frozen_scan(out, before)
        if findings:
            raise PlanVerifyError(findings, pass_name)
        self._snap = after
        if out is plan:
            # same root object and zero mutated survivors: the pass output
            # is byte-identical to its (already verified) input
            return out
        findings = verify_plan(out, self.catalog)
        if findings:
            raise PlanVerifyError(findings, pass_name)
        return out

    def finish(self, plan):
        """Final verification: in ``final`` mode this is the only check; in
        ``per-pass`` mode the shape checks already ran after every pass, so
        only the deep checks (parameter-hoisting round-trip) remain — they
        run once per statement, not per pass."""
        if self.mode == "off":
            return plan
        if self.mode == "final":
            self._verify(plan, "final", deep=True)
            return plan
        from .verify import PlanVerifyError, _fill_labels, check_params
        findings = check_params(plan)
        _fill_labels(findings, plan, None)
        if findings:
            raise PlanVerifyError(findings, "final")
        return plan


# engine dtype helpers -------------------------------------------------------

_AGG_FUNCS = {"sum", "avg", "min", "max", "count", "stddev_samp", "stddev"}
_WINDOW_ONLY = {"rank", "dense_rank", "row_number"}


def _date_to_days(text: str) -> int:
    y, m, d = text.split("-")
    return (_dt.date(int(y), int(m), int(d)) - _dt.date(1970, 1, 1)).days


@dataclass
class ScopeEntry:
    qualifier: Optional[str]
    name: str
    dtype: str
    index: int


@dataclass
class Scope:
    entries: list[ScopeEntry] = field(default_factory=list)
    parent: Optional["Scope"] = None  # outer query scope (correlation)

    def resolve_local(self, name: str, qualifier: Optional[str]
                      ) -> Optional[ScopeEntry]:
        hits = [e for e in self.entries
                if e.name == name and (qualifier is None or e.qualifier == qualifier)]
        if len(hits) > 1:
            # identical source column visible through one qualifier twice is fine
            if len({h.index for h in hits}) > 1:
                raise PlanError(f"ambiguous column {qualifier + '.' if qualifier else ''}{name}")
        return hits[0] if hits else None

    def width(self) -> int:
        return max((e.index for e in self.entries), default=-1) + 1


@dataclass
class Catalog:
    """Maps table names to (schema, row-count estimate, loader)."""
    tables: dict = field(default_factory=dict)  # name -> (names, dtypes, est_rows)
    # decimal_physical="i64": CAST(x AS DECIMAL(p,s)) binds to "dec{s}"
    # instead of float (exact scaled-int64 decimals)
    dec_enabled: bool = False
    # table -> columns declared single-column unique (dimension surrogate
    # keys; schema.UNIQUE_KEYS or an explicit register_* declaration). The
    # late-materialization legality analysis requires the deferred join key
    # to be provably unique — a non-unique build side would double-count
    # through the post-aggregation attribute join.
    unique_cols: dict = field(default_factory=dict)
    # late-materialization rewrite toggle + size gate (EngineConfig mirrors)
    late_mat: bool = True
    late_mat_min_rows: int = 1 << 20
    # static plan-IR verification mode (EngineConfig.verify_plans mirror):
    # off | final | per-pass — see PassPipeline / engine/verify.py
    verify_plans: str = "off"
    # callable(table) -> {column: (lo, hi)} value-range stats in engine
    # units (None = no stats source). The verifier proves declared narrow
    # upload lanes (ScanNode.lanes) wide enough for the recorded ranges;
    # streaming chooses the lanes from the same source (Session.column_stats)
    stats_source: object = None

    def col_stats(self, name: str) -> dict:
        if self.stats_source is None:
            return {}
        try:
            return self.stats_source(name) or {}
        except Exception:
            return {}

    def schema(self, name: str) -> tuple[list[str], list[str]]:
        if name not in self.tables:
            raise PlanError(f"unknown table {name!r}")
        names, dtypes, _ = self.tables[name]
        return names, dtypes

    def est_rows(self, name: str) -> int:
        return self.tables[name][2] if name in self.tables else 1000

    def is_unique(self, table: str, column: str) -> bool:
        return column in self.unique_cols.get(table, ())


# ---------------------------------------------------------------------------


@dataclass
class _Unit:
    """One relation participating in the FROM join graph."""
    plan: P.PlanNode
    entries: list[ScopeEntry]      # local indices 0..w-1
    est_rows: float
    filters: list[A.Node] = field(default_factory=list)


class Planner:
    def __init__(self, catalog: Catalog):
        self.catalog = catalog
        # CTE compile-segmentation candidates: (fingerprint, plan node) in
        # definition order (definition-before-use => topological). The
        # fingerprint is STABLE across planner instances (AST-derived), so
        # q14/q23-style multi-part statements sharing a WITH clause map to
        # the same segment cache slots.
        self.cte_segments: list[tuple[str, P.PlanNode]] = []
        self._cte_fp: dict[int, str] = {}

    # -- public ------------------------------------------------------------
    def plan_query(self, q: A.Query, outer: Optional[Scope] = None,
                   ctes: Optional[dict] = None) -> P.PlanNode:
        top = ctes is None
        ctes = dict(ctes or {})
        for name, cq in q.ctes:
            ctes[name] = self._plan_cte(name, cq, ctes)
        node = self._plan_body(q.body, outer, ctes, q.order_by, q.limit)
        if top:
            # fresh root annotation, never a shared node's field
            node.cte_segments = list(self.cte_segments)  # lint: frozen-exempt (root annotation)
            pipe = PassPipeline(self.catalog.verify_plans, self.catalog)
            pipe.check("bind", node)
            if self.catalog.late_mat and \
                    not os.environ.get("NDS_TPU_NO_LATE_MAT"):
                # BEFORE pruning: the declaration-order permutation projects
                # are still full-width bijections, so the surrogate join key
                # is expressible in the aggregate's input space (pruning
                # would have dropped it — nothing above the join consumes it)
                node = pipe.run("late_materialization",
                                lambda p: self._seg_live(
                                    p, _late_materialization(p, self.catalog)),
                                node)
            if not os.environ.get("NDS_TPU_NO_COLPRUNE"):
                from .colprune import prune_plan
                node = pipe.run("colprune", prune_plan, node)
            if not os.environ.get("NDS_TPU_NO_SELFJOIN_REWRITE"):
                # AFTER pruning (dead columns would hide the single-column
                # key-set shape), and pruned again when it fired (the
                # rewrite kills the pair-expansion column uses)
                node2 = pipe.run("selfjoin_distinct",
                                 lambda p: self._seg_live(
                                     p, _selfjoin_distinct_rewrite(p)),
                                 node)
                if node2 is not node:
                    node = node2
                    if not os.environ.get("NDS_TPU_NO_COLPRUNE"):
                        from .colprune import prune_plan
                        node = pipe.run("colprune", prune_plan, node)
            node = pipe.finish(node)
        return node

    @staticmethod
    def _seg_live(old: P.PlanNode, new: P.PlanNode) -> P.PlanNode:
        """Carry cte_segments across a rewrite, dropping entries no longer
        reachable from the rewritten root."""
        if new is old:
            return new
        segs = getattr(old, "cte_segments", [])
        live = {id(n) for n in P.iter_plan_nodes(new)}
        new.cte_segments = [(fp, n) for fp, n in segs if id(n) in live]  # lint: frozen-exempt (root annotation)
        return new

    def _plan_cte(self, name: str, cq: A.Query, ctes: dict) -> P.PlanNode:
        """Plan one WITH entry and register it as a segmentation candidate."""
        import hashlib

        node = self.plan_query(cq, outer=None, ctes=ctes)
        visible = ";".join(f"{n}:{self._cte_fp.get(id(p), '')}"
                           for n, p in sorted(ctes.items()))
        fp = hashlib.sha1(f"{name}|{cq!r}|{visible}".encode()).hexdigest()[:16]
        self._cte_fp[id(node)] = fp
        self.cte_segments.append((fp, node))
        return node

    # -- query body ---------------------------------------------------------
    def _plan_body(self, body, outer, ctes, order_by, limit) -> P.PlanNode:
        if isinstance(body, A.SetOp):
            left = self._plan_body(body.left, outer, ctes, [], None)
            right = self._plan_body(body.right, outer, ctes, [], None)
            if len(left.out_names) != len(right.out_names):
                raise PlanError("set operation column count mismatch")
            # positionally coerce branches to a common dtype (decimal scales
            # in particular must match: scaled ints of different scales must
            # never concatenate raw)
            target = [a if a == b else _common_dtype([a, b])
                      for a, b in zip(left.out_dtypes, right.out_dtypes)]
            left = self._coerce_branch(left, target)
            right = self._coerce_branch(right, target)
            node = P.SetOpNode(body.op, body.all, left, right,
                               out_names=list(left.out_names),
                               out_dtypes=list(target))
            node = self._order_limit_by_position(node, order_by, limit)
            return node
        if isinstance(body, A.Query):
            sub = self.plan_query(body, outer, ctes)
            return self._order_limit_by_position(sub, order_by, limit)
        if isinstance(body, A.Select):
            return self._plan_select(body, outer, ctes, order_by, limit)
        raise PlanError(f"unsupported query body {type(body).__name__}")

    def _coerce_branch(self, node: P.PlanNode, target: list[str]) -> P.PlanNode:
        """Project a set-op branch onto the positional target dtypes."""
        if list(node.out_dtypes) == list(target):
            return node
        exprs = [_coerce_to(P.BCol(d, i, node.out_names[i]), t)
                 for i, (d, t) in enumerate(zip(node.out_dtypes, target))]
        return P.ProjectNode(node, exprs, out_names=list(node.out_names),
                             out_dtypes=list(target))

    def _order_limit_by_position(self, node: P.PlanNode, order_by, limit):
        if order_by:
            scope = Scope([ScopeEntry(None, n, d, i)
                           for i, (n, d) in enumerate(zip(node.out_names,
                                                          node.out_dtypes))])
            keys = []
            for si in order_by:
                e = self._bind_output_sort(si.expr, scope, node)
                keys.append(P.SortKey(e, si.asc, si.nulls_first))
            node = P.SortNode(node, keys=keys, out_names=list(node.out_names),
                              out_dtypes=list(node.out_dtypes))
        if limit is not None:
            node = P.LimitNode(node, n=limit, out_names=list(node.out_names),
                               out_dtypes=list(node.out_dtypes))
        return node

    def _bind_output_sort(self, expr, scope, node):
        if isinstance(expr, A.Literal) and isinstance(expr.value, int):
            idx = expr.value - 1
            if not (0 <= idx < len(node.out_names)):
                raise PlanError(f"ORDER BY position {expr.value} out of range")
            return P.BCol(node.out_dtypes[idx], idx, node.out_names[idx])
        binder = _Binder(self, scope, ctes={}, allow_outer=False)
        return binder.bind(expr)

    # -- SELECT ------------------------------------------------------------
    def _plan_select(self, sel: A.Select, outer, ctes, order_by, limit
                     ) -> P.PlanNode:
        # FROM + WHERE (join graph)
        rel, scope, deferred = self._plan_from_where(sel, outer, ctes)

        # expand stars
        items: list[A.SelectItem] = []
        for it in sel.items:
            if isinstance(it.expr, A.Star):
                for e in scope.entries:
                    if it.expr.qualifier is None or e.qualifier == it.expr.qualifier:
                        items.append(A.SelectItem(
                            A.ColumnRef((e.qualifier, e.name) if e.qualifier
                                        else (e.name,)), None))
            else:
                items.append(it)

        # aggregate detection
        agg_calls = []
        for it in items:
            _collect_aggs(it.expr, agg_calls)
        if sel.having is not None:
            _collect_aggs(sel.having, agg_calls)
        for si in order_by:
            _collect_aggs(si.expr, agg_calls)
        has_agg = bool(agg_calls) or sel.group_by is not None

        binder = _Binder(self, scope, ctes, outer=outer)

        if has_agg:
            ngroup = len(sel.group_by.exprs) if sel.group_by else 0
            rel, scope, rebound = self._plan_aggregate(
                rel, scope, sel, items, agg_calls, binder, ctes, outer)
            binder = _Binder(self, scope, ctes, outer=outer,
                             rewrites=rebound, num_group_cols=ngroup)

        # windows
        win_calls: list[A.FuncCall] = []
        for it in items:
            _collect_windows(it.expr, win_calls)
        for si in order_by:
            _collect_windows(si.expr, win_calls)
        if win_calls:
            rel, scope, binder = self._plan_windows(rel, scope, win_calls, binder,
                                                    ctes, outer)

        # HAVING
        if sel.having is not None:
            pred = binder.bind(sel.having)
            rel = P.FilterNode(rel, pred, out_names=list(rel.out_names),
                               out_dtypes=list(rel.out_dtypes))

        # SELECT projection
        proj_exprs, proj_names = [], []
        for it in items:
            e = binder.bind(it.expr)
            proj_exprs.append(e)
            proj_names.append(it.alias or _display_name(it.expr))
        project = P.ProjectNode(rel, proj_exprs,
                                out_names=proj_names,
                                out_dtypes=[e.dtype for e in proj_exprs])

        node: P.PlanNode = project
        if sel.distinct:
            node = P.DistinctNode(node, out_names=list(node.out_names),
                                  out_dtypes=list(node.out_dtypes))
            node = self._order_limit_output(node, order_by, limit, items,
                                            proj_exprs)
            return node

        # ORDER BY below-project binding: sort keys are exprs over project input
        if order_by:
            keys = []
            for si in order_by:
                e = self._bind_sort_key(si.expr, items, proj_exprs, binder,
                                        project)
                keys.append(P.SortKey(e, si.asc, si.nulls_first))
            # sort the project INPUT, so keys may use non-projected columns
            sorted_child = P.SortNode(rel, keys=keys,
                                      out_names=list(rel.out_names),
                                      out_dtypes=list(rel.out_dtypes))
            project = P.ProjectNode(sorted_child, proj_exprs,
                                    out_names=proj_names,
                                    out_dtypes=[e.dtype for e in proj_exprs])
            node = project
        if limit is not None:
            node = P.LimitNode(node, n=limit, out_names=list(node.out_names),
                               out_dtypes=list(node.out_dtypes))
        return node

    def _order_limit_output(self, node, order_by, limit, items, proj_exprs):
        """ORDER BY over the (distinct) projected output, by alias/position."""
        if order_by:
            scope = Scope([ScopeEntry(None, n, d, i)
                           for i, (n, d) in enumerate(zip(node.out_names,
                                                          node.out_dtypes))])
            keys = []
            for si in order_by:
                e = self._bind_output_sort_item(si.expr, scope, node, items)
                keys.append(P.SortKey(e, si.asc, si.nulls_first))
            node = P.SortNode(node, keys=keys, out_names=list(node.out_names),
                              out_dtypes=list(node.out_dtypes))
        if limit is not None:
            node = P.LimitNode(node, n=limit, out_names=list(node.out_names),
                               out_dtypes=list(node.out_dtypes))
        return node

    def _bind_output_sort_item(self, expr, scope, node, items):
        if isinstance(expr, A.Literal) and isinstance(expr.value, int):
            idx = expr.value - 1
            return P.BCol(node.out_dtypes[idx], idx, node.out_names[idx])
        for i, it in enumerate(items):
            if it.alias and expr == A.ColumnRef((it.alias,)):
                return P.BCol(node.out_dtypes[i], i, node.out_names[i])
            if it.expr == expr:
                return P.BCol(node.out_dtypes[i], i, node.out_names[i])
        binder = _Binder(self, scope, ctes={}, allow_outer=False)
        return binder.bind(expr)

    def _bind_sort_key(self, expr, items, proj_exprs, binder, project):
        # ordinal -> projected expr
        if isinstance(expr, A.Literal) and isinstance(expr.value, int):
            idx = expr.value - 1
            if not (0 <= idx < len(proj_exprs)):
                raise PlanError(f"ORDER BY position {expr.value} out of range")
            return proj_exprs[idx]
        # alias or identical expression -> projected expr
        for it, bound in zip(items, proj_exprs):
            if it.alias is not None and expr == A.ColumnRef((it.alias,)):
                return bound
            if it.expr == expr:
                return bound
        try:
            return binder.bind(expr)
        except PlanError:
            # aliases nested inside the sort expression (q36's
            # `CASE WHEN lochierarchy = 0 THEN i_category END`)
            return binder.bind(_substitute_aliases(expr, items))

    # -- FROM/WHERE join graph ----------------------------------------------
    def _plan_from_where(self, sel: A.Select, outer, ctes):
        if sel.from_ is None:
            raise PlanError("SELECT without FROM is not supported")
        # explicit INNER JOIN chains flatten into the same unit/edge machinery
        # as comma joins (inner joins commute): ON conjuncts classify exactly
        # like WHERE conjuncts, giving filter pushdown and size-ordered join
        # placement to JOIN-syntax templates (reference query72's
        # cs JOIN inventory ON item would otherwise expand row-count-first in
        # syntax order). Top-level LEFT joins peel into an ordered tail
        # applied after the greedy join.
        tail_specs: list = []
        root = self._peel_outer_tail(sel.from_, tail_specs)
        on_conjs: list = []
        units = self._flatten_from(root, ctes, outer, on_conjs)
        tail_units = [(kind, self._plan_relation(rnode, ctes, outer), on_ast)
                      for kind, rnode, on_ast in tail_specs]
        n_inner = len(units)
        all_units = units + [tu for _, tu, _ in tail_units]

        # full scope in declaration order
        scope_entries, offset = [], 0
        unit_offsets = []
        for u in all_units:
            unit_offsets.append(offset)
            for e in u.entries:
                scope_entries.append(replace(e, index=offset + e.index))
            offset += len(u.entries)
        scope = Scope(scope_entries, parent=outer)

        conjuncts = _split_and(sel.where) if sel.where is not None else []
        conjuncts = conjuncts + on_conjs
        conjuncts = conjuncts + _or_implied_conjuncts(conjuncts)
        edges, residuals, subq_conjs = [], [], []
        for c in conjuncts:
            if _has_subquery(c):
                subq_conjs.append(c)
                continue
            refs = self._referenced_units(c, all_units, scope, unit_offsets)
            if refs is None:
                residuals.append(c)  # references outer scope: bind later
            elif refs and max(refs) >= n_inner:
                # touches a LEFT-join tail unit: filtering inside/below the
                # outer join would change null-extension semantics
                residuals.append(c)
            elif len(refs) <= 1:
                if refs:
                    units[next(iter(refs))].filters.append(c)
                else:
                    residuals.append(c)  # constant predicate
            elif (len(refs) == 2 and isinstance(c, A.BinOp) and c.op == "="):
                lrefs = self._referenced_units(c.left, all_units, scope,
                                               unit_offsets)
                rrefs = self._referenced_units(c.right, all_units, scope,
                                               unit_offsets)
                if lrefs is not None and rrefs is not None and \
                        len(lrefs) == 1 and len(rrefs) == 1 and lrefs != rrefs:
                    la, rb = next(iter(lrefs)), next(iter(rrefs))
                    edges.append((la, rb, c.left, c.right))
                else:
                    residuals.append(c)
            else:
                residuals.append(c)

        # push single-unit filters
        for u in units:
            for f in u.filters:
                local_scope = Scope(u.entries, parent=outer)
                b = _Binder(self, local_scope, ctes, outer=outer)
                pred = b.bind(f)
                u.plan = P.FilterNode(u.plan, pred,
                                      out_names=list(u.plan.out_names),
                                      out_dtypes=list(u.plan.out_dtypes))
                u.est_rows = max(1.0, u.est_rows / 5.0)
            u.filters = []

        rel, col_map = self._join_units(units, edges, ctes, outer)

        # LEFT-join tail, in syntax order, over the greedy-joined group
        width = sum(len(u.entries) for u in units)
        for t_idx, (kind, tu, on_ast) in enumerate(tail_units):
            joined_entries = self._joined_entries(all_units, col_map)
            nleft = width
            combined = joined_entries + [
                replace(e, index=nleft + e.index) for e in tu.entries]
            scope2 = Scope(combined, parent=outer)
            binder2 = _Binder(self, scope2, ctes, outer=outer)
            lkeys, rkeys, res_parts = [], [], []
            for c in _split_and(on_ast):
                pair = self._equi_pair(c, scope2, nleft, binder2)
                if pair is not None:
                    lkeys.append(pair[0])
                    rkeys.append(pair[1])
                else:
                    res_parts.append(binder2.bind(c))
            rel = P.JoinNode(
                rel, tu.plan, kind, lkeys, rkeys, _and_all(res_parts),
                out_names=rel.out_names + tu.plan.out_names,
                out_dtypes=rel.out_dtypes + tu.plan.out_dtypes)
            col_map[n_inner + t_idx] = width
            width += len(tu.entries)

        # permutation back to declaration order
        perm = [None] * len(scope_entries)
        for ui, u in enumerate(all_units):
            for e in u.entries:
                perm[unit_offsets[ui] + e.index] = col_map[ui] + e.index
        exprs = [P.BCol(scope_entries[i].dtype, perm[i], scope_entries[i].name)
                 for i in range(len(scope_entries))]
        rel = P.ProjectNode(rel, exprs,
                            out_names=[e.name for e in scope_entries],
                            out_dtypes=[e.dtype for e in scope_entries])

        binder = _Binder(self, scope, ctes, outer=outer)
        for c in residuals:
            pred = binder.bind(c)
            rel = P.FilterNode(rel, pred, out_names=list(rel.out_names),
                               out_dtypes=list(rel.out_dtypes))

        deferred = []
        for c in subq_conjs:
            rel = self._apply_subquery_conjunct(rel, scope, c, ctes, outer)
        return rel, scope, deferred

    def _peel_outer_tail(self, node, tail: list):
        """Peel top-level LEFT joins into an ordered tail (deepest first);
        returns the inner root. `(G JOIN… ) LEFT JOIN p ON … LEFT JOIN r`
        becomes greedy(G) + tail [p, r] — outer joins are order barriers,
        inner groups beneath them are not."""
        if isinstance(node, A.Join) and node.kind == "left" \
                and node.on is not None:
            inner = self._peel_outer_tail(node.left, tail)
            tail.append((node.kind, node.right, node.on))
            return inner
        return node

    def _flatten_from(self, node, ctes, outer, on_acc: list) -> list[_Unit]:
        """Comma/cross joins AND explicit inner joins become separate units
        (their ON conjuncts accumulate into on_acc for edge classification);
        everything else is one unit."""
        if isinstance(node, A.Join) and node.kind == "cross" and node.on is None:
            return self._flatten_from(node.left, ctes, outer, on_acc) + \
                self._flatten_from(node.right, ctes, outer, on_acc)
        if isinstance(node, A.Join) and node.kind == "inner" \
                and node.on is not None and not _has_subquery(node.on):
            on_acc.extend(_split_and(node.on))
            return self._flatten_from(node.left, ctes, outer, on_acc) + \
                self._flatten_from(node.right, ctes, outer, on_acc)
        return [self._plan_relation(node, ctes, outer)]

    def _plan_relation(self, node, ctes, outer) -> _Unit:
        if isinstance(node, A.TableRef):
            qual = node.alias or node.name
            if node.name in ctes:
                sub = ctes[node.name]
                entries = [ScopeEntry(qual, n, d, i)
                           for i, (n, d) in enumerate(zip(sub.out_names,
                                                          sub.out_dtypes))]
                return _Unit(sub, entries, est_rows=10_000.0)
            names, dtypes = self.catalog.schema(node.name)
            scan = P.ScanNode(node.name, list(names),
                              out_names=list(names), out_dtypes=list(dtypes))
            entries = [ScopeEntry(qual, n, d, i)
                       for i, (n, d) in enumerate(zip(names, dtypes))]
            return _Unit(scan, entries, est_rows=float(self.catalog.est_rows(node.name)))
        if isinstance(node, A.SubqueryRef):
            sub = self.plan_query(node.query, outer=outer, ctes=ctes)
            entries = [ScopeEntry(node.alias, n, d, i)
                       for i, (n, d) in enumerate(zip(sub.out_names,
                                                      sub.out_dtypes))]
            return _Unit(sub, entries, est_rows=10_000.0)
        if isinstance(node, A.Join):
            left = self._plan_relation(node.left, ctes, outer)
            right = self._plan_relation(node.right, ctes, outer)
            combined_entries = list(left.entries) + [
                replace(e, index=e.index + len(left.entries))
                for e in right.entries]
            scope = Scope(combined_entries, parent=outer)
            kind = node.kind
            lkeys, rkeys, residual = [], [], None
            if node.on is not None:
                binder = _Binder(self, scope, ctes, outer=outer)
                nleft = len(left.entries)
                res_parts = []
                for c in _split_and(node.on):
                    pair = self._equi_pair(c, scope, nleft, binder)
                    if pair is not None:
                        lkeys.append(pair[0])
                        rkeys.append(pair[1])
                    else:
                        res_parts.append(binder.bind(c))
                residual = _and_all(res_parts)
            elif kind not in ("cross",):
                kind = "cross"
            out_names = [e.name for e in combined_entries]
            out_dtypes = [e.dtype for e in combined_entries]
            jn = P.JoinNode(left.plan, right.plan, kind, lkeys, rkeys, residual,
                            out_names=out_names, out_dtypes=out_dtypes)
            return _Unit(jn, combined_entries,
                         est_rows=max(left.est_rows, right.est_rows))
        raise PlanError(f"unsupported FROM element {type(node).__name__}")

    def _equi_pair(self, c, scope, nleft, binder):
        if not (isinstance(c, A.BinOp) and c.op == "="):
            return None
        try:
            lb = binder.bind(c.left)
            rb = binder.bind(c.right)
        except PlanError:
            return None
        lcols, rcols = _col_indices(lb), _col_indices(rb)
        if lcols and rcols:
            if max(lcols) < nleft and min(rcols) >= nleft:
                return lb, _shift(rb, -nleft)
            if max(rcols) < nleft and min(lcols) >= nleft:
                return rb, _shift(lb, -nleft)
        return None

    def _referenced_units(self, node, units, scope, unit_offsets):
        """Set of unit ids referenced by the AST; None if outer refs present."""
        refs: set[int] = set()
        outer_seen = [False]

        def visit(x):
            if isinstance(x, A.ColumnRef):
                e = scope.resolve_local(x.name, x.qualifier)
                if e is None:
                    outer_seen[0] = True
                    return
                ui = 0
                for i, off in enumerate(unit_offsets):
                    if e.index >= off:
                        ui = i
                refs.add(ui)
            for child in _children(x):
                visit(child)
        visit(node)
        if outer_seen[0]:
            return None
        return refs

    def _join_units(self, units, edges, ctes, outer):
        """Greedy join: start from the largest (fact) unit, attach connected
        units smallest-first (dimension build sides)."""
        n = len(units)
        if n == 1:
            return units[0].plan, {0: 0}
        remaining = set(range(n))
        start = max(remaining, key=lambda i: units[i].est_rows)
        current_plan = units[start].plan
        col_map = {start: 0}
        width = len(units[start].entries)
        remaining.discard(start)
        placed = {start}
        while remaining:
            connected = [i for i in remaining
                         if any((a in placed and b == i) or (b in placed and a == i)
                                for a, b, _, _ in edges)]
            pick = min(connected, key=lambda i: units[i].est_rows) if connected \
                else min(remaining, key=lambda i: units[i].est_rows)
            unit = units[pick]
            lkeys, rkeys = [], []
            for a, b, lexpr, rexpr in edges:
                if a in placed and b == pick:
                    okey, ikey = lexpr, rexpr
                elif b in placed and a == pick:
                    okey, ikey = rexpr, lexpr
                else:
                    continue
                lkeys.append(self._bind_in_joined(okey, units, col_map, ctes, outer))
                rkeys.append(self._bind_in_unit(ikey, unit, ctes, outer))
            kind = "inner" if lkeys else "cross"
            out_names = current_plan.out_names + unit.plan.out_names
            out_dtypes = current_plan.out_dtypes + unit.plan.out_dtypes
            current_plan = P.JoinNode(current_plan, unit.plan, kind,
                                      lkeys, rkeys, None,
                                      out_names=out_names, out_dtypes=out_dtypes)
            col_map[pick] = width
            width += len(unit.entries)
            placed.add(pick)
            remaining.discard(pick)
        return current_plan, col_map

    @staticmethod
    def _joined_entries(units, col_map):
        """Scope entries of the joined-so-far relation, offset per col_map."""
        entries = []
        for ui, off in col_map.items():
            for e in units[ui].entries:
                entries.append(replace(e, index=off + e.index))
        return entries

    def _bind_in_joined(self, expr, units, col_map, ctes, outer):
        entries = self._joined_entries(units, col_map)
        return _Binder(self, Scope(entries, parent=outer), ctes,
                       outer=outer).bind(expr)

    def _bind_in_unit(self, expr, unit, ctes, outer):
        return _Binder(self, Scope(unit.entries, parent=outer), ctes,
                       outer=outer).bind(expr)

    # -- subquery conjuncts --------------------------------------------------
    def _apply_subquery_conjunct(self, rel, scope, c, ctes, outer):
        binder = _Binder(self, scope, ctes, outer=outer)
        width = len(rel.out_names)

        neg = False
        node = c
        while isinstance(node, A.UnaryOp) and node.op == "not":
            neg = not neg
            node = node.operand

        if isinstance(node, A.Exists):
            if node.negated:
                neg = not neg
            return self._semi_anti(rel, scope, node.query, None, neg, ctes)
        if isinstance(node, A.InSubquery):
            neg2 = neg ^ node.negated
            return self._semi_anti(rel, scope, node.query, node.expr, neg2, ctes)

        # EXISTS/IN nested below the conjunct level (e.g. q10/q35's
        # `EXISTS(...) OR EXISTS(...)`, q45's `zip IN (...) OR id IN (subq)`):
        # mark joins — each subquery left-joins a distinct key set and is
        # replaced by an IS NOT NULL test on the joined mark column
        marks: dict[int, P.BExpr] = {}
        for sub in _nested_subqueries(node):
            rel, mark = self._mark_join(rel, scope, sub, ctes)
            marks[id(sub)] = mark

        # comparison containing scalar subqueries
        rel2, scope2, rewritten = self._decorrelate_scalars(rel, scope, node,
                                                            ctes)
        binder2 = _Binder(self, scope2, ctes, outer=outer,
                          subquery_cols={**rewritten, **marks})
        pred = binder2.bind(node)
        if neg:
            pred = P.BCall("bool", "not", [pred])
        filtered = P.FilterNode(rel2, pred, out_names=list(rel2.out_names),
                                out_dtypes=list(rel2.out_dtypes))
        if len(rel2.out_names) != width:
            exprs = [P.BCol(rel2.out_dtypes[i], i, rel2.out_names[i])
                     for i in range(width)]
            return P.ProjectNode(filtered, exprs,
                                 out_names=list(rel2.out_names[:width]),
                                 out_dtypes=list(rel2.out_dtypes[:width]))
        return filtered

    def _mark_join(self, rel, scope, sub, ctes):
        """Mark join: left-join a distinct correlated key set and return the
        widened relation plus a boolean expression that is TRUE iff the
        subquery matched (two-valued logic; NOT IN null semantics are only
        guaranteed in the conjunct-level path)."""
        in_expr = sub.expr if isinstance(sub, A.InSubquery) else None
        negated = getattr(sub, "negated", False)
        if negated and in_expr is not None:
            # A mark join evaluates NOT IN with two-valued logic: a NULL
            # outer probe or NULLs in the subquery result would yield TRUE
            # instead of UNKNOWN. No TPC-DS template hits this; reject it
            # rather than silently produce wrong rows.
            raise PlanError("negated IN subquery in a nested (OR-level) "
                            "position requires three-valued NOT IN "
                            "semantics, which mark joins do not provide")
        sub_plan, corr_pairs, inner_keys, mixed, _inner_scope = \
            self._plan_correlated(sub.query, scope, ctes)
        if mixed:
            raise PlanError("non-equality correlation in a nested subquery "
                            "is unsupported")
        outer_binder = _Binder(self, scope, ctes, outer=scope.parent)
        lkeys = [outer_binder.bind(oe) for oe, _ in corr_pairs]
        rkeys = list(inner_keys)
        if in_expr is not None:
            lkeys.append(outer_binder.bind(in_expr))
            rkeys.append(P.BCol(sub_plan.out_dtypes[0], 0,
                                sub_plan.out_names[0]))
        if not lkeys:
            raise PlanError("uncorrelated EXISTS in a nested position "
                            "is unsupported")
        key_exprs = [P.BCol(k.dtype, k.index, sub_plan.out_names[k.index])
                     for k in rkeys]
        names = [f"mk{i}" for i in range(len(key_exprs))]
        dtypes = [k.dtype for k in rkeys]
        proj = P.ProjectNode(sub_plan, key_exprs, out_names=names,
                             out_dtypes=dtypes)
        dist = P.DistinctNode(proj, out_names=names, out_dtypes=dtypes)
        new_rkeys = [P.BCol(d, i, names[i]) for i, d in enumerate(dtypes)]
        nleft = len(rel.out_names)
        joined = P.JoinNode(rel, dist, "left", lkeys, new_rkeys, None,
                            out_names=list(rel.out_names) + names,
                            out_dtypes=list(rel.out_dtypes) + dtypes)
        mark = P.BCall("bool", "isnotnull",
                       [P.BCol(dtypes[0], nleft, names[0])])
        if negated:
            mark = P.BCall("bool", "not", [mark])
        return joined, mark

    def _semi_anti(self, rel, scope, subq: A.Query, in_expr, negated, ctes):
        """EXISTS/IN subqueries as semi/anti joins with correlation keys.

        Mixed outer/inner conjuncts that aren't equality correlations (e.g.
        q16's cs1.cs_warehouse_sk <> cs2.cs_warehouse_sk) become a residual
        predicate evaluated over matched [outer row | subquery row] pairs
        before the semi/anti reduction (ops.join residual_eval contract).
        """
        sub_plan, corr_pairs, inner_keys, mixed, inner_scope = \
            self._plan_correlated(subq, scope, ctes)
        outer_binder = _Binder(self, scope, ctes, outer=scope.parent)
        lkeys = [outer_binder.bind(oe) for oe, _ in corr_pairs]
        rkeys = list(inner_keys)
        if in_expr is not None:
            lkeys.append(outer_binder.bind(in_expr))
            rkeys.append(P.BCol(sub_plan.out_dtypes[0], 0,
                                sub_plan.out_names[0]))
        if not lkeys:
            raise PlanError("EXISTS subquery without correlation is unsupported")
        residual = None
        if mixed:
            # combined schema = outer columns, then sub_plan columns; inner
            # entries shadow outer ones (innermost scope wins for unqualified
            # names), with indices offset past the outer width
            nleft = len(rel.out_names)
            ncore = len(sub_plan.out_names) - len(inner_scope.entries)
            entries = [ScopeEntry(e.qualifier, e.name, e.dtype,
                                  nleft + ncore + i)
                       for i, e in enumerate(inner_scope.entries)]
            entries += list(scope.entries)
            combined = Scope(entries, parent=scope.parent)
            rbinder = _Binder(self, combined, ctes, outer=scope.parent)
            for c in mixed:
                pred = rbinder.bind(c)
                residual = pred if residual is None else \
                    P.BCall("bool", "and", [residual, pred])
        kind = "anti" if negated else "semi"
        # NOT IN (subquery) needs SQL null semantics; NOT EXISTS does not
        null_aware = negated and in_expr is not None
        if null_aware and residual is not None:
            # The executors test build-side NULL keys before the residual is
            # applied, so a NOT IN whose mixed conjuncts would exclude the
            # NULL-key build rows would still empty the result. No TPC-DS
            # template combines these; reject instead of diverging.
            raise PlanError("NOT IN subquery with non-equality correlated "
                            "conjuncts (null-aware anti join with residual) "
                            "is unsupported")
        return P.JoinNode(rel, sub_plan, kind, lkeys, rkeys, residual,
                          null_aware=null_aware,
                          out_names=list(rel.out_names),
                          out_dtypes=list(rel.out_dtypes))

    def _decorrelate_scalars(self, rel, scope, node, ctes):
        """Replace correlated scalar agg subqueries in `node` with columns
        appended to `rel` via grouped left joins. Uncorrelated scalars stay as
        runtime BScalarSubquery (handled by the binder)."""
        rewritten: dict[int, P.BCol] = {}

        subqs: list[A.ScalarSubquery] = []

        def find(x):
            if isinstance(x, A.ScalarSubquery):
                subqs.append(x)
                return
            for ch in _children(x):
                find(ch)
        find(node)

        cur = rel
        for sq in subqs:
            if not _is_correlated(sq.query, scope, self, ctes):
                continue
            derived, corr_pairs, inner_keys, value_dtype = \
                self._plan_scalar_agg_subquery(sq.query, scope, ctes)
            outer_binder = _Binder(self, scope, ctes, outer=scope.parent)
            lkeys = [outer_binder.bind(oe) for oe, _ in corr_pairs]
            width = len(cur.out_names)
            cur = P.JoinNode(cur, derived, "left", lkeys, inner_keys, None,
                             out_names=cur.out_names + derived.out_names,
                             out_dtypes=cur.out_dtypes + derived.out_dtypes)
            # value column is the last output of derived
            value_idx = width + len(derived.out_names) - 1
            rewritten[id(sq)] = P.BCol(value_dtype, value_idx,
                                       derived.out_names[-1])
        # keep original entries (with qualifiers) and extend with joined cols
        entries = list(scope.entries)
        for i in range(len(scope.entries), len(cur.out_names)):
            entries.append(ScopeEntry(None, cur.out_names[i],
                                      cur.out_dtypes[i], i))
        return cur, Scope(entries, parent=scope.parent), rewritten

    def _plan_correlated(self, subq: A.Query, outer_scope, ctes):
        """Plan an EXISTS/IN subquery body; extract equality correlations.

        Returns (plan, [(outer_ast, inner_ast)], [bound inner key exprs]).
        The plan outputs the subquery's select items first, then one column
        per correlation key (so callers can use them as join keys).
        """
        if subq.ctes:
            ctes = dict(ctes)
            for nm, cq in subq.ctes:
                ctes[nm] = self._plan_cte(nm, cq, ctes)
        body = subq.body
        if not isinstance(body, A.Select):
            raise PlanError("unsupported subquery form")
        corr, mixed, inner_where = _extract_correlation(body.where,
                                                        outer_scope, self,
                                                        ctes, body)
        inner_sel = replace(body, where=inner_where)
        rel, inner_scope, _ = self._plan_from_where(inner_sel, None, ctes)
        binder = _Binder(self, inner_scope, ctes, outer=None)
        sel_exprs = []
        for it in inner_sel.items:
            if isinstance(it.expr, A.Star):
                sel_exprs.append(P.BLit("int", 1))  # EXISTS (select *): row marker
            else:
                sel_exprs.append(binder.bind(it.expr))
        extra_exprs = [binder.bind(ie) for _, ie in corr]
        all_exprs = sel_exprs + extra_exprs
        # output names mirror what each column IS — select items as c{i},
        # correlation keys as k{i}, exposed inner columns by their own
        # names — so downstream key/residual references resolve by name too
        all_names = [f"c{i}" for i in range(len(sel_exprs))] + \
                    [f"k{i}" for i in range(len(extra_exprs))]
        if mixed:
            # expose every inner column so the caller can bind the residual
            # over the combined [outer | subquery] schema
            all_exprs = all_exprs + [
                P.BCol(e.dtype, e.index, e.name) for e in inner_scope.entries]
            all_names = all_names + [e.name for e in inner_scope.entries]
        plan = P.ProjectNode(rel, all_exprs,
                             out_names=all_names,
                             out_dtypes=[e.dtype for e in all_exprs])
        inner_keys = [P.BCol(e.dtype, len(sel_exprs) + i, f"k{i}")
                      for i, e in enumerate(extra_exprs)]
        return plan, corr, inner_keys, mixed, inner_scope

    def _plan_scalar_agg_subquery(self, subq: A.Query, outer_scope, ctes):
        """Decorrelate `(select AGG-expr from ... where corr-eqs and filters)`.

        Returns (derived_plan, corr_pairs, inner_group_key_cols, value_dtype);
        derived outputs [group keys..., value].
        """
        if subq.ctes:
            ctes = dict(ctes)
            for nm, cq in subq.ctes:
                ctes[nm] = self._plan_cte(nm, cq, ctes)
        body = subq.body
        if not isinstance(body, A.Select) or len(body.items) != 1:
            raise PlanError("unsupported correlated scalar subquery")
        corr, mixed, inner_where = _extract_correlation(body.where,
                                                        outer_scope, self,
                                                        ctes, body)
        if mixed:
            raise PlanError("non-equality correlation in scalar subquery "
                            "is unsupported")
        if not corr:
            raise PlanError("scalar subquery marked correlated but no equality "
                            "correlation found")
        inner_sel = replace(body, where=inner_where)
        rel, scope, _ = self._plan_from_where(inner_sel, None, ctes)
        binder = _Binder(self, scope, ctes, outer=None)
        group_exprs = [binder.bind(ie) for _, ie in corr]
        agg_calls: list[A.FuncCall] = []
        _collect_aggs(body.items[0].expr, agg_calls)
        if not agg_calls:
            raise PlanError("correlated scalar subquery must aggregate")
        aggs = [self._make_aggspec(fc, binder) for fc in agg_calls]
        agg_node = P.AggregateNode(
            rel, group_exprs, aggs, False,
            out_names=[f"g{i}" for i in range(len(group_exprs))] +
                      [f"a{i}" for i in range(len(aggs))],
            out_dtypes=[e.dtype for e in group_exprs] +
                       [a.dtype for a in aggs])
        # value expression over [group keys, agg results]
        rewrites = {}
        for i, fc in enumerate(agg_calls):
            rewrites[_ast_key(fc)] = P.BCol(aggs[i].dtype,
                                            len(group_exprs) + i, f"a{i}")
        post_scope = Scope([ScopeEntry(None, n, d, i)
                            for i, (n, d) in enumerate(zip(agg_node.out_names,
                                                           agg_node.out_dtypes))])
        post_binder = _Binder(self, post_scope, ctes, outer=None,
                              rewrites=rewrites)
        value = post_binder.bind(body.items[0].expr)
        exprs = [P.BCol(e.dtype, i, f"g{i}") for i, e in enumerate(group_exprs)]
        exprs.append(value)
        derived = P.ProjectNode(
            agg_node, exprs,
            out_names=[f"g{i}" for i in range(len(group_exprs))] + ["__value"],
            out_dtypes=[e.dtype for e in exprs])
        inner_keys = [P.BCol(e.dtype, i, f"g{i}")
                      for i, e in enumerate(group_exprs)]
        return derived, corr, inner_keys, value.dtype

    # -- aggregation ---------------------------------------------------------
    def _make_aggspec(self, fc: A.FuncCall, binder) -> P.AggSpec:
        func = fc.name
        if func == "stddev":
            func = "stddev_samp"
        if func == "count" and fc.args and isinstance(fc.args[0], A.Star):
            return P.AggSpec("count_star", None, False, "count(1)")
        arg = binder.bind(fc.args[0]) if fc.args else None
        return P.AggSpec(func, arg, fc.distinct, _display_name(fc))

    def _plan_aggregate(self, rel, scope, sel, items, agg_calls, binder, ctes,
                        outer):
        group_asts = list(sel.group_by.exprs) if sel.group_by else []
        rollup = bool(sel.group_by.rollup) if sel.group_by else False
        # group by alias / ordinal -> replace with select expr
        resolved_groups = []
        for g in group_asts:
            if isinstance(g, A.Literal) and isinstance(g.value, int):
                resolved_groups.append(items[g.value - 1].expr)
            elif isinstance(g, A.ColumnRef) and g.qualifier is None and \
                    scope.resolve_local(g.name, None) is None:
                hit = next((it.expr for it in items if it.alias == g.name), None)
                resolved_groups.append(hit if hit is not None else g)
            else:
                resolved_groups.append(g)
        group_bound = [binder.bind(g) for g in resolved_groups]
        # dedupe agg calls by AST
        uniq_aggs: list[A.FuncCall] = []
        for fc in agg_calls:
            if not any(fc == u for u in uniq_aggs):
                uniq_aggs.append(fc)
        aggs = [self._make_aggspec(fc, binder) for fc in uniq_aggs]
        out_names = [_display_name(g) for g in resolved_groups] + \
                    [a.name or a.func for a in aggs]
        out_dtypes = [e.dtype for e in group_bound] + [a.dtype for a in aggs]
        if rollup:
            out_names.append("__grouping_id")
            out_dtypes.append("int")
        node = P.AggregateNode(rel, group_bound, aggs, rollup,
                               out_names=out_names, out_dtypes=out_dtypes)
        # rewrites: group ASTs and agg ASTs -> positional columns
        rewrites: dict = {}
        for i, g in enumerate(resolved_groups):
            rewrites[_ast_key(g)] = P.BCol(group_bound[i].dtype, i,
                                           out_names[i])
        for i, fc in enumerate(uniq_aggs):
            rewrites[_ast_key(fc)] = P.BCol(aggs[i].dtype,
                                            len(group_bound) + i,
                                            out_names[len(group_bound) + i])
        new_entries = []
        for i, g in enumerate(resolved_groups):
            nm = g.name if isinstance(g, A.ColumnRef) else out_names[i]
            qual = g.qualifier if isinstance(g, A.ColumnRef) else None
            new_entries.append(ScopeEntry(qual, nm, group_bound[i].dtype, i))
        for i in range(len(aggs)):
            new_entries.append(ScopeEntry(None, out_names[len(group_bound) + i],
                                          aggs[i].dtype, len(group_bound) + i))
        if rollup:
            new_entries.append(ScopeEntry(None, "__grouping_id", "int",
                                          len(out_names) - 1))
        new_scope = Scope(new_entries, parent=outer)
        return node, new_scope, rewrites

    # -- windows -------------------------------------------------------------
    def _exact_rational_keys(self, rel, key: "P.SortKey"
                             ) -> tuple["P.PlanNode", list]:
        """Rank order keys that are float divisions of integer-typed values
        (ints or scaled-int decimals) are replaced by TWO exact integer
        keys — floor(p/q) and 56 binary fraction digits — so rank ties are
        decided by exact rational equality on every backend. Float division
        is not correctly rounded under TPU f64 emulation, so equal rationals
        reached through different operand pairs (2/3 vs 4/6) can land 1 ULP
        apart and flip ties the host oracle keeps (the failure class the
        reference validator carves out per-query for floats,
        nds/nds_validate.py:231-244; exact keys remove the need for any
        q49 carve-out here). The operands are hoisted through the
        intervening ProjectNode chain as hidden columns; the chain rebuilds
        COPY-ON-WRITE (returning the possibly-new rel) — chain nodes can be
        shared CTE plan objects, and widening them in place would shift
        positional bindings for every other consumer (ADVICE r5)."""
        chain: list[P.ProjectNode] = []
        e, node = key.expr, rel
        while isinstance(e, P.BCol) and isinstance(node, P.ProjectNode):
            chain.append(node)
            e = node.exprs[e.index]
            node = node.child
        if not (isinstance(e, P.BCall) and e.op == "div"):
            return rel, [key]

        def strip_cast(x):
            while isinstance(x, P.BCall) and x.op == "cast" \
                    and x.dtype == "float":
                x = x.args[0]
            return x if x.dtype == "int" or is_dec(x.dtype) else None

        num, den = strip_cast(e.args[0]), strip_cast(e.args[1])
        if num is None or den is None:
            return rel, [key]

        appends: list[list] = [[] for _ in chain]  # per chain node

        def append_col(ci: int, expr, name: str) -> int:
            proj = chain[ci]
            for i, ex in enumerate(proj.exprs):
                if repr(ex) == repr(expr):
                    return i
            for k, (ex, _nm) in enumerate(appends[ci]):
                if repr(ex) == repr(expr):
                    return len(proj.exprs) + k
            appends[ci].append((expr, name))
            return len(proj.exprs) + len(appends[ci]) - 1

        cols = []
        for opnd, tag in ((num, "num"), (den, "den")):
            if not chain:
                cols.append(opnd)   # already in rel's scope
                continue
            idx = append_col(len(chain) - 1, opnd, f"__rat_{tag}")
            for ci in range(len(chain) - 2, -1, -1):
                idx = append_col(ci, P.BCol(opnd.dtype, idx, f"__rat_{tag}"),
                                 f"__rat_{tag}")
            cols.append(P.BCol(opnd.dtype, idx, f"__rat_{tag}"))
        if chain:
            rebuilt: Optional[P.PlanNode] = None
            for ci in range(len(chain) - 1, -1, -1):
                proj = chain[ci]
                child = rebuilt if rebuilt is not None else proj.child
                if appends[ci] or child is not proj.child:
                    rebuilt = replace(
                        proj, child=child,
                        exprs=list(proj.exprs) + [ex for ex, _ in appends[ci]],
                        out_names=list(proj.out_names) +
                                  [nm for _, nm in appends[ci]],
                        out_dtypes=list(proj.out_dtypes) +
                                   [ex.dtype for ex, _ in appends[ci]])
                else:
                    rebuilt = proj
            rel = rebuilt
        return rel, [P.SortKey(P.BCall("int", op, list(cols)),
                               key.asc, key.nulls_first)
                     for op in ("ratdiv_hi", "ratdiv_lo")]

    def _plan_windows(self, rel, scope, win_calls, binder, ctes, outer):
        uniq: list[A.FuncCall] = []
        for fc in win_calls:
            if not any(fc == u for u in uniq):
                uniq.append(fc)
        funcs = []
        for fc in uniq:
            arg = None
            if fc.args and not isinstance(fc.args[0], A.Star):
                arg = binder.bind(fc.args[0])
            func = fc.name
            if func == "count" and fc.args and isinstance(fc.args[0], A.Star):
                func = "count_star"
            part = [binder.bind(e) for e in fc.over.partition_by]
            okeys = [P.SortKey(binder.bind(si.expr), si.asc, si.nulls_first)
                     for si in fc.over.order_by]
            funcs.append(P.WindowFunc(func, arg, part, okeys,
                                      name=_display_name(fc)))
        for i, f in enumerate(funcs):
            if f.func in ("rank", "dense_rank") and f.order_by:
                new_keys = []
                for k in f.order_by:
                    rel, ks = self._exact_rational_keys(rel, k)
                    new_keys.extend(ks)
                # copy-on-write, like every other plan-IR rewrite: mutating
                # the WindowFunc in place would trip the freeze lint even
                # though this list is planner-local
                funcs[i] = replace(f, order_by=new_keys)
        out_names = list(rel.out_names) + [f.name for f in funcs]
        out_dtypes = list(rel.out_dtypes) + [f.dtype for f in funcs]
        node = P.WindowNode(rel, funcs, out_names=out_names,
                            out_dtypes=out_dtypes)
        rewrites = dict(binder.rewrites)
        base = len(rel.out_names)
        for i, fc in enumerate(uniq):
            rewrites[_ast_key(fc)] = P.BCol(funcs[i].dtype, base + i,
                                            funcs[i].name)
        entries = list(scope.entries)
        for i, f in enumerate(funcs):
            entries.append(ScopeEntry(None, f.name, f.dtype, base + i))
        new_scope = Scope(entries, parent=outer)
        new_binder = _Binder(self, new_scope, ctes, outer=outer,
                             rewrites=rewrites,
                             num_group_cols=binder.num_group_cols)
        return node, new_scope, new_binder


# ---------------------------------------------------------------------------
# binder: AST expression -> bound expression
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# late materialization (q72-class): group by surrogate keys, gather dimension
# attributes after aggregation
# ---------------------------------------------------------------------------

def _lm_compose(chain: list, depth: int, idx: int) -> int:
    """Map a column index through the pure-BCol project chain below `depth`
    (later chain entries are deeper), landing in join-tree output space."""
    for p in chain[depth:]:
        idx = p.exprs[idx].index
    return idx


def _lm_refs(expr, chain: list, depth: int) -> set[int]:
    """Join-space column indices referenced by an expression bound at chain
    depth `depth`. Embedded subquery plans are closed (decorrelated) and
    reference their own spaces — ignored."""
    from .colprune import _expr_refs
    refs: set[int] = set()
    _expr_refs(expr, refs, [])
    return {_lm_compose(chain, depth, r) for r in refs}


def _lm_shared_nodes(plan: P.PlanNode) -> set[int]:
    """Node ids with more than one plan-DAG parent, plus every node of a
    registered CTE segment subtree: the attribute-join side must be cloned,
    and cloning shared work (or a segment-cache slot) would silently
    duplicate it."""
    from .streaming import _expr_subplans
    counts: dict[int, int] = {}
    for nd in P.iter_plan_nodes(plan):
        for f in ("child", "left", "right"):
            sub = getattr(nd, f, None)
            if isinstance(sub, P.PlanNode):
                counts[id(sub)] = counts.get(id(sub), 0) + 1
        for sp in _expr_subplans(nd):
            counts[id(sp)] = counts.get(id(sp), 0) + 1
    out = {i for i, c in counts.items() if c > 1}
    for _fp, seg in getattr(plan, "cte_segments", None) or []:
        out.update(id(x) for x in P.iter_plan_nodes(seg))
    return out


def _lm_clonable(node: P.PlanNode, shared: set[int]) -> bool:
    """A dimension subtree we may duplicate for the post-agg gather: scans,
    filters, and projects only; no shared nodes; no embedded subquery plans
    (cloning would fork their execution)."""
    from .streaming import _expr_subplans
    for x in P.iter_plan_nodes(node):
        if not isinstance(x, (P.ScanNode, P.FilterNode, P.ProjectNode)):
            return False
        if id(x) in shared or _expr_subplans(x):
            return False
    return True


def _lm_clone(node: P.PlanNode) -> P.PlanNode:
    """Fresh node objects for a Scan/Filter/Project subtree (expressions are
    shared — they are treated immutably everywhere). Distinct identity keeps
    colprune's needed-set union from widening the pre-agg build side with the
    post-agg attribute columns."""
    if isinstance(node, P.ScanNode):
        return replace(node, columns=list(node.columns),
                       out_names=list(node.out_names),
                       out_dtypes=list(node.out_dtypes))
    return replace(node, child=_lm_clone(node.child),
                   out_names=list(node.out_names),
                   out_dtypes=list(node.out_dtypes))


def _lm_key_scan(node: P.PlanNode, idx: int):
    """Trace output column `idx` of a dim subtree down to its source scan
    column; (table, column) or None when the path is not a pure passthrough."""
    while True:
        if isinstance(node, P.ProjectNode):
            e = node.exprs[idx]
            if not isinstance(e, P.BCol):
                return None
            idx = e.index
            node = node.child
        elif isinstance(node, P.FilterNode):
            node = node.child
        elif isinstance(node, P.ScanNode):
            return node.table, node.columns[idx]
        else:
            return None


def _try_late_mat(agg: P.AggregateNode, catalog: "Catalog",
                  shared: set[int]) -> Optional[P.PlanNode]:
    """Rewrite one aggregate-over-join to late-materialized form, or None.

    Legality: each deferred dimension joins inner on a single catalog-unique
    key with no residual, and its columns are consumed ONLY as plain-column
    group keys (pre-agg filters, aggregate arguments, other joins' keys, and
    computed group expressions keep a dimension pinned). Exactness: grouping
    by the surrogate key is finer than grouping by its attributes (the key
    functionally determines them through a unique-key join), so a merge
    aggregate over the original group values — the streaming partial/final
    decomposition — restores the exact result, including avg (sum+count) and
    all-NULL sums."""
    from .streaming import _decompose, _final_builder, _mergeable

    if agg.rollup or agg.rollup_levels is not None or not agg.group_exprs:
        return None
    if not _mergeable(agg):
        return None

    # descend pure-BCol projects and filters to the join tree
    chain: list[P.ProjectNode] = []
    filters: list[tuple] = []
    node = agg.child
    while True:
        if isinstance(node, P.ProjectNode) and \
                all(isinstance(e, P.BCol) for e in node.exprs):
            chain.append(node)
            node = node.child
        elif isinstance(node, P.FilterNode):
            filters.append((node.predicate, len(chain)))
            node = node.child
        else:
            break
    if not isinstance(node, P.JoinNode):
        return None

    # size gate: the fact-scale gathers are the win; tiny plans only pay the
    # extra join + merge aggregate
    if catalog.late_mat_min_rows > 0:
        big = max((catalog.est_rows(s.table)
                   for s in P.iter_plan_nodes(agg.child)
                   if isinstance(s, P.ScanNode)), default=0)
        if big < catalog.late_mat_min_rows:
            return None

    # flatten the left spine; every spine join's output keeps its left side
    # as a positional prefix, so right-side spans are valid in the top space
    cands: list[dict] = []
    consumed: set[int] = set()
    cur = node
    while isinstance(cur, (P.JoinNode, P.FilterNode)):
        if isinstance(cur, P.FilterNode):
            filters.append((cur.predicate, len(chain)))
            cur = cur.child
            continue
        for k in cur.left_keys:
            consumed |= _lm_refs(k, chain, len(chain))
        if cur.residual is not None:
            consumed |= _lm_refs(cur.residual, chain, len(chain))
        if cur.kind in ("full", "right"):
            # null-extended left rows below would carry NULL surrogate keys
            # the post-agg inner join could not reproduce: stop here
            break
        if cur.kind == "inner" and not cur.late_mat \
                and cur.residual is None \
                and len(cur.left_keys) == 1 and len(cur.right_keys) == 1 \
                and isinstance(cur.right_keys[0], P.BCol):
            cands.append({"join": cur, "off": len(cur.left.out_names),
                          "w": len(cur.right.out_names),
                          "kidx": cur.right_keys[0].index})
        cur = cur.left
    if not cands:
        return None

    for pred, depth in filters:
        consumed |= _lm_refs(pred, chain, depth)
    for s in agg.aggs:
        if s.arg is not None:
            consumed |= _lm_refs(s.arg, chain, 0)

    def find_cand(gcol: int) -> Optional[int]:
        for ci, c in enumerate(cands):
            if c["off"] <= gcol < c["off"] + c["w"]:
                return ci
        return None

    # classify group exprs: a plain dim-column BCol may defer; anything else
    # consumes its columns pre-agg
    gclass: list = []
    for g in agg.group_exprs:
        ci = None
        if isinstance(g, P.BCol):
            gcol = _lm_compose(chain, 0, g.index)
            ci = find_cand(gcol)
        if ci is None:
            consumed |= _lm_refs(g, chain, 0)
            gclass.append(None)
        else:
            gclass.append((ci, gcol))

    elig: dict[int, dict] = {}
    for ci, c in enumerate(cands):
        span = set(range(c["off"], c["off"] + c["w"]))
        if consumed & span:
            continue
        keyg = c["off"] + c["kidx"]
        if not any(cl is not None and cl[0] == ci and cl[1] != keyg
                   for cl in gclass):
            continue            # no deferred attribute: nothing to gain
        if not _lm_clonable(c["join"].right, shared):
            continue
        traced = _lm_key_scan(c["join"].right, c["kidx"])
        if traced is None or not catalog.is_unique(*traced):
            continue
        elig[ci] = c

    # the surrogate key must be expressible in the aggregate's input space
    # (pre-prune permutation projects are full-width, so it normally is);
    # prefer the fact-side key column — the gathered dim key then dies in
    # the compiled program's DCE
    inv: dict[int, int] = {}
    for t in range(len(agg.child.out_names)):
        inv.setdefault(_lm_compose(chain, 0, t), t)
    for ci in list(elig):
        c = elig[ci]
        lk = c["join"].left_keys[0]
        src = inv.get(lk.index) if isinstance(lk, P.BCol) else None
        if src is None:
            src = inv.get(c["off"] + c["kidx"])
        if src is None:
            del elig[ci]
        else:
            c["key_top"] = src
    if not elig:
        return None

    # assemble: partial agg by surrogate keys -> attribute joins against
    # cloned dims -> projection into the partial schema -> merge aggregate
    n = len(agg.group_exprs)
    partial_specs, recipes, p_names, p_dtypes = _decompose(agg)
    pkeys: list[P.BExpr] = []
    slot: dict[int, int] = {}        # candidate -> partial key slot
    plain_slot: dict[int, int] = {}  # group expr index -> partial key slot
    for i, (g, cl) in enumerate(zip(agg.group_exprs, gclass)):
        if cl is not None and cl[0] in elig:
            ci = cl[0]
            if ci not in slot:
                slot[ci] = len(pkeys)
                src = elig[ci]["key_top"]
                pkeys.append(P.BCol(agg.child.out_dtypes[src], src,
                                    agg.child.out_names[src]))
        else:
            plain_slot[i] = len(pkeys)
            pkeys.append(g)
    m = len(pkeys)
    partial = P.AggregateNode(
        child=agg.child, group_exprs=pkeys, aggs=list(partial_specs),
        out_names=[f"__lm_k{i}" for i in range(m)] +
                  [s.name for s in partial_specs],
        out_dtypes=[e.dtype for e in pkeys] +
                   [s.dtype for s in partial_specs])
    cur2: P.PlanNode = partial
    width = m + len(partial_specs)
    dim_off: dict[int, int] = {}
    for ci in sorted(slot, key=lambda c: slot[c]):
        c = elig[ci]
        rc = _lm_clone(c["join"].right)
        kidx = c["kidx"]
        cur2 = P.JoinNode(
            cur2, rc, "inner",
            left_keys=[P.BCol(pkeys[slot[ci]].dtype, slot[ci],
                              f"__lm_k{slot[ci]}")],
            right_keys=[P.BCol(rc.out_dtypes[kidx], kidx,
                               rc.out_names[kidx])],
            residual=None, late_mat=True,
            out_names=list(cur2.out_names) + list(rc.out_names),
            out_dtypes=list(cur2.out_dtypes) + list(rc.out_dtypes))
        dim_off[ci] = width
        width += len(rc.out_names)
    exprs: list[P.BExpr] = []
    for i, (g, cl) in enumerate(zip(agg.group_exprs, gclass)):
        if cl is not None and cl[0] in elig:
            ci, gcol = cl
            idx = dim_off[ci] + (gcol - elig[ci]["off"])
        else:
            idx = plain_slot[i]
        exprs.append(P.BCol(g.dtype, idx, cur2.out_names[idx]))
    for j in range(len(partial_specs)):
        exprs.append(P.BCol(p_dtypes[n + j], m + j, cur2.out_names[m + j]))
    proj = P.ProjectNode(cur2, exprs, out_names=list(p_names),
                         out_dtypes=list(p_dtypes))
    return _final_builder(agg, recipes, p_names, p_dtypes)(proj)


def _late_materialization(plan: P.PlanNode, catalog: "Catalog") -> P.PlanNode:
    """q72-class late materialization: an aggregate over fact⋈dimension whose
    dimension columns are consumed only as group keys regroups by the
    dimension's surrogate join key; the (small) aggregated result then joins
    the dimension to gather attributes, and a merge aggregate over the
    original group values restores the exact answer. The fact-scale random-
    access gathers materializing attribute columns before aggregation — the
    measured 10-25 ns/element cost class dominating query72 — disappear; the
    reference leaves this to Spark, which materializes the joined columns
    literally (nds_power.py:124-134 runs the stock template). GPU SQL
    engines lean on the same strategy (PAPERS.md: Accelerating Presto with
    GPUs; Flare keeps hot loops narrow the same way)."""
    from .streaming import substitute_nodes

    for _ in range(8):
        shared = _lm_shared_nodes(plan)
        mapping: dict[int, P.PlanNode] = {}
        aggs = [nd for nd in P.iter_plan_nodes(plan)
                if isinstance(nd, P.AggregateNode)]
        for a in aggs:
            out = _try_late_mat(a, catalog, shared)
            if out is not None:
                mapping[id(a)] = out
        if not mapping:
            return plan
        # innermost-first: an outer rewrite would freeze the stale original
        # of a nested rewritten aggregate inside its replacement subtree
        for a in aggs:
            if id(a) not in mapping:
                continue
            if any(id(x) in mapping and x is not a
                   for x in P.iter_plan_nodes(a)):
                del mapping[id(a)]
        if not mapping:
            return plan
        segs = getattr(plan, "cte_segments", None)
        plan = substitute_nodes(plan, mapping)
        if segs is not None and not hasattr(plan, "cte_segments"):
            plan.cte_segments = segs  # lint: frozen-exempt (root annotation)
    return plan


def _selfjoin_distinct_rewrite(plan: P.PlanNode) -> P.PlanNode:
    """q95-class exact rewrite: a CTE like

        SELECT ws1.ws_order_number FROM web_sales ws1, web_sales ws2
        WHERE ws1.ws_order_number = ws2.ws_order_number
          AND ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk

    consumed ONLY as a key set (semi/anti-join build sides — IN/EXISTS
    subqueries) is equivalent to

        SELECT ws_order_number FROM web_sales GROUP BY ws_order_number
        HAVING MIN(ws_warehouse_sk) < MAX(ws_warehouse_sk)

    because `exists a pair with different x` == `more than one distinct
    non-null x in the key group` (SQL `<>` is null-rejecting, and MIN/MAX
    skip nulls). The literal self-join expands to |key-group|^2 pairs —
    the single hottest buffer class in the whole stream (the q95 expand
    join's 16M-row gathers spill to host memory); the aggregate form is a
    couple of segment scans. The reference leaves this to Spark, which
    executes the join literally (nds_power runs the stock template) — this
    engine plans it away."""
    refs: dict[int, list] = {}
    for n in P.iter_plan_nodes(plan):
        for f in ("child", "left", "right"):
            sub = getattr(n, f, None)
            if isinstance(sub, P.PlanNode):
                refs.setdefault(id(sub), []).append((n, f))

    # transitively-consumed column sets, from colprune's needed-set pass:
    # a candidate qualifies when its consumers provably read ONLY the key
    # column (other columns — a CTE root kept full-width for segment
    # fingerprints — may exist but are dead)
    from .colprune import _Pruner
    pr = _Pruner()
    pr.collect(plan, set(range(len(plan.out_names))))

    def match(r: P.PlanNode):
        """r -> (scan, key_idx, x_idx, key_pos) when r is the pattern."""
        # walk down pure-BCol projects and ne-filters, composing the map
        # from current output positions back to the join output space
        node = r
        proj_chain: list = []
        filters: list = []
        while True:
            if isinstance(node, P.ProjectNode) and \
                    all(isinstance(e, P.BCol) for e in node.exprs):
                proj_chain.append([e.index for e in node.exprs])
                node = node.child
            elif isinstance(node, P.FilterNode):
                filters.append((node.predicate, len(proj_chain)))
                node = node.child
            else:
                break
        if not isinstance(node, P.JoinNode) or node.kind != "inner" \
                or node.residual is not None:
            return None
        jl, jr = node.left, node.right
        if not (isinstance(jl, P.ScanNode) and isinstance(jr, P.ScanNode)
                and jl.table == jr.table
                and list(jl.columns) == list(jr.columns)):
            return None
        if len(node.left_keys) != 1 or len(node.right_keys) != 1:
            return None
        lk, rk = node.left_keys[0], node.right_keys[0]
        if not (isinstance(lk, P.BCol) and isinstance(rk, P.BCol)
                and lk.index == rk.index):
            return None
        w = len(jl.out_names)
        k = lk.index

        def to_join_space(idx: int, depth: int) -> int:
            # compose through projects BELOW depth (later entries are
            # deeper): proj_chain[depth:] maps r-space -> join-space
            for m in proj_chain[depth:]:
                idx = m[idx]
            return idx

        # consumers must read exactly one column of r, and it must be the
        # join key (dedup-safety licenses multiplicity changes only —
        # value columns must be provably dead)
        consumed = pr.needed.get(id(r))
        if consumed is None or len(consumed) != 1:
            return None
        key_pos = next(iter(consumed))
        if to_join_space(key_pos, 0) not in (k, w + k):
            return None
        # exactly one ne(x_left, x_right) filter over the same column
        if len(filters) != 1:
            return None
        pred, depth = filters[0]
        if not (isinstance(pred, P.BCall) and pred.op == "ne"
                and len(pred.args) == 2
                and all(isinstance(a, P.BCol) for a in pred.args)):
            return None
        i, j = (to_join_space(a.index, depth) for a in pred.args)
        if i > j:
            i, j = j, i
        if j != w + i or i == k:
            return None
        return jl, k, i, key_pos

    # A node is DEDUP-SAFE when every path from it to an output passes
    # through a set-semantics consumer (semi/anti build side, DISTINCT,
    # non-ALL set op) via multiplicity-preserving nodes — then changing its
    # row multiplicities (the rewrite dedups) cannot change any result.
    safe_memo: dict[int, bool] = {}

    def dedup_safe(node: P.PlanNode) -> bool:
        if id(node) in safe_memo:
            return safe_memo[id(node)]
        safe_memo[id(node)] = False          # cycle guard, conservative
        rs = refs.get(id(node))
        if not rs:          # plan root / subquery root: rows reach output
            out = False
        else:
            def ok(p, f):
                if isinstance(p, P.JoinNode) and p.kind in ("semi", "anti") \
                        and f == "right":
                    return True
                if isinstance(p, P.DistinctNode):
                    return True      # output multiplicity is 1 regardless
                if isinstance(p, P.SetOpNode) and not p.all:
                    return True      # set semantics dedup anyway
                if isinstance(p, (P.ProjectNode, P.FilterNode, P.JoinNode)):
                    return dedup_safe(p)
                if isinstance(p, P.SetOpNode) and p.op == "union" and p.all:
                    return dedup_safe(p)
                return False
            out = all(ok(p, f) for p, f in rs)
        safe_memo[id(node)] = out
        return out

    mapping: dict[int, P.PlanNode] = {}
    for r in P.iter_plan_nodes(plan):
        if id(r) in mapping or not dedup_safe(r):
            continue
        m = match(r)
        if m is None:
            continue
        scan, k, x, key_pos = m
        dk = scan.out_dtypes[k]
        dx = scan.out_dtypes[x]
        key_name = r.out_names[key_pos]
        agg = P.AggregateNode(
            child=scan, group_exprs=[P.BCol(dk, k, scan.out_names[k])],
            aggs=[P.AggSpec("min", P.BCol(dx, x), False, "__mn"),
                  P.AggSpec("max", P.BCol(dx, x), False, "__mx")],
            out_names=[key_name, "__mn", "__mx"],
            out_dtypes=[dk, dx, dx])
        # key IS NOT NULL: the literal self-join's equality can never match
        # NULL keys, but GROUP BY keeps the NULL group — without the filter
        # a NOT IN consumer (null-aware anti join) would see a spurious
        # NULL and return zero rows
        flt = P.FilterNode(
            agg, P.BCall("bool", "and", [
                P.BCall("bool", "isnotnull", [P.BCol(dk, 0, key_name)]),
                P.BCall("bool", "lt", [P.BCol(dx, 1, "__mn"),
                                       P.BCol(dx, 2, "__mx")])]),
            out_names=list(agg.out_names), out_dtypes=list(agg.out_dtypes))
        # same width as r: non-key columns are PROVEN dead (consumed set
        # is exactly the key), so they carry typed NULLs
        exprs = [P.BCol(dk, 0, key_name) if i == key_pos
                 else P.BLit(r.out_dtypes[i], None)
                 for i in range(len(r.out_names))]
        proj = P.ProjectNode(flt, exprs, out_names=list(r.out_names),
                             out_dtypes=list(r.out_dtypes))
        mapping[id(r)] = proj
    if not mapping:
        return plan
    from .streaming import substitute_nodes
    return substitute_nodes(plan, mapping)


def _ast_key(node) -> str:
    return repr(node)


class _Binder:
    def __init__(self, planner: Planner, scope: Scope, ctes,
                 outer: Optional[Scope] = None, rewrites=None,
                 subquery_cols=None, allow_outer: bool = True,
                 num_group_cols: Optional[int] = None):
        self.planner = planner
        self.scope = scope
        self.ctes = ctes
        self.outer = outer
        self.rewrites = rewrites or {}   # repr(ast) -> BCol
        self.subquery_cols = subquery_cols or {}  # id(ScalarSubquery) -> BCol
        self.allow_outer = allow_outer
        self.num_group_cols = num_group_cols

    def bind(self, node) -> P.BExpr:
        key = _ast_key(node)
        if key in self.rewrites:
            return self.rewrites[key]
        method = getattr(self, f"_bind_{type(node).__name__.lower()}", None)
        if method is None:
            raise PlanError(f"cannot bind {type(node).__name__}")
        return method(node)

    # -- leaves -------------------------------------------------------------
    def _bind_literal(self, node: A.Literal) -> P.BExpr:
        v = node.value
        if node.type_hint == "date":
            return P.BLit("date", _date_to_days(v))
        if v is None:
            return P.BLit("int", None)
        if isinstance(v, bool):
            return P.BLit("bool", v)
        if isinstance(v, int):
            return P.BLit("int", v)
        if isinstance(v, float):
            return P.BLit("float", v)
        return P.BLit("str", v)

    def _bind_columnref(self, node: A.ColumnRef) -> P.BExpr:
        e = self.scope.resolve_local(node.name, node.qualifier)
        if e is not None:
            return P.BCol(e.dtype, e.index, e.name)
        raise PlanError(f"cannot resolve column "
                        f"{'.'.join(p for p in node.parts)}")

    # -- operators ----------------------------------------------------------
    _OPMAP = {"=": "eq", "<>": "ne", "<": "lt", "<=": "le", ">": "gt",
              ">=": "ge", "+": "add", "-": "sub", "*": "mul", "/": "div",
              "%": "mod", "and": "and", "or": "or", "||": "concat"}

    def _bind_binop(self, node: A.BinOp) -> P.BExpr:
        op = self._OPMAP[node.op]
        # interval arithmetic folds/date ops
        if op in ("add", "sub") and isinstance(node.right, A.Interval):
            return self._bind_date_interval(node, op)
        left = self.bind(node.left)
        right = self.bind(node.right)
        # mul/div/mod keep decimal operands unscaled: dec(s)*int multiplies
        # raw int64s (scale s), div/mod go through float — aligning scales
        # first would only waste int64 range (SF1000 money sums approach it)
        if not (op in ("mul", "div", "mod")
                and (is_dec(left.dtype) or is_dec(right.dtype))):
            left, right = _coerce_pair(left, right)
        if op in ("eq", "ne", "lt", "le", "gt", "ge"):
            return P.BCall("bool", op, [left, right])
        if op in ("and", "or"):
            return P.BCall("bool", op, [left, right])
        if op == "concat":
            return P.BCall("str", "concat", _flatten_concat(left, right))
        dtype = _arith_dtype(op, left, right)
        return P.BCall(dtype, op, [left, right])

    def _bind_date_interval(self, node: A.BinOp, op: str) -> P.BExpr:
        base = self.bind(node.left)
        iv = node.right
        value = iv.value
        if isinstance(value, A.Literal):
            amount = int(value.value)
        elif isinstance(value, A.UnaryOp) and isinstance(value.operand, A.Literal):
            amount = -int(value.operand.value)
        else:
            raise PlanError("interval amount must be literal")
        if op == "sub":
            amount = -amount
        if iv.unit == "day":
            if isinstance(base, P.BLit):
                return P.BLit("date", base.value + amount)
            return P.BCall("date", "add", [base, P.BLit("int", amount)])
        if iv.unit in ("month", "year"):
            months = amount * (12 if iv.unit == "year" else 1)
            if isinstance(base, P.BLit):
                d = _dt.date(1970, 1, 1) + _dt.timedelta(days=base.value)
                total = d.year * 12 + (d.month - 1) + months
                y, m = divmod(total, 12)
                day = min(d.day, _days_in_month(y, m + 1))
                return P.BLit("date", _date_to_days(f"{y:04d}-{m+1:02d}-{day:02d}"))
            raise PlanError("month/year interval on non-literal date")
        raise PlanError(f"unsupported interval unit {iv.unit}")

    def _bind_unaryop(self, node: A.UnaryOp) -> P.BExpr:
        a = self.bind(node.operand)
        if node.op == "not":
            return P.BCall("bool", "not", [a])
        if node.op == "-":
            if isinstance(a, P.BLit) and a.value is not None:
                return P.BLit(a.dtype, -a.value)
            return P.BCall(a.dtype, "neg", [a])
        return a

    def _bind_between(self, node: A.Between) -> P.BExpr:
        e = self.bind(node.expr)
        lo = self.bind(node.low)
        hi = self.bind(node.high)
        e1, lo = _coerce_pair(e, lo)
        e2, hi = _coerce_pair(e, hi)
        ge = P.BCall("bool", "ge", [e1, lo])
        le = P.BCall("bool", "le", [e2, hi])
        both = P.BCall("bool", "and", [ge, le])
        if node.negated:
            return P.BCall("bool", "not", [both])
        return both

    def _bind_inlist(self, node: A.InList) -> P.BExpr:
        e = self.bind(node.expr)
        values = []
        for item in node.items:
            b = _const_fold(self.bind(item))
            if not isinstance(b, P.BLit):
                raise PlanError("IN list values must be literals")
            v = b.value
            if e.dtype == "date" and b.dtype == "str":
                v = _date_to_days(v)
            if is_dec(b.dtype) and v is not None:
                # executors expect LOGICAL in-list values (they re-scale to
                # the probed column's scale); dec BLits hold scaled ints.
                # Dec-typed probes keep exact Decimals (_scaled_in_values
                # round-trips str(Decimal) losslessly); float probes get
                # float (their comparison is float anyway, and jnp.asarray
                # cannot take Decimal objects)
                import decimal
                d = decimal.Decimal(v).scaleb(-dec_scale(b.dtype))
                if d == d.to_integral_value():
                    v = int(d)
                else:
                    v = d if is_dec(e.dtype) else float(d)
            values.append(v)
        call = P.BCall("bool", "in_list", [e], extra=values)
        if node.negated:
            return P.BCall("bool", "not", [call])
        return call

    def _bind_like(self, node: A.Like) -> P.BExpr:
        e = self.bind(node.expr)
        p = self.bind(node.pattern)
        if not isinstance(p, P.BLit):
            raise PlanError("LIKE pattern must be a literal")
        call = P.BCall("bool", "like", [e], extra=p.value)
        if node.negated:
            return P.BCall("bool", "not", [call])
        return call

    def _bind_isnull(self, node: A.IsNull) -> P.BExpr:
        e = self.bind(node.expr)
        return P.BCall("bool", "isnotnull" if node.negated else "isnull", [e])

    def _bind_case(self, node: A.Case) -> P.BExpr:
        args = []
        branches = []
        for cond, val in node.whens:
            if node.operand is not None:
                cond = A.BinOp("=", node.operand, cond)
            args.append(self.bind(cond))
            branches.append(self.bind(val))
        else_b = self.bind(node.else_) if node.else_ is not None \
            else P.BLit("int", None)
        dtype = _common_dtype([b.dtype for b in branches] + [else_b.dtype])
        branches = [_coerce_to(b, dtype) for b in branches]
        else_b = _coerce_to(else_b, dtype)
        flat = []
        for c, b in zip(args, branches):
            flat += [c, b]
        flat.append(else_b)
        return P.BCall(dtype, "case", flat)

    def _bind_cast(self, node: A.Cast) -> P.BExpr:
        e = self.bind(node.expr)
        t = node.to_type
        if t.startswith("decimal") and self.planner.catalog.dec_enabled:
            m = re.match(r"decimal\s*\(\s*\d+\s*,\s*(\d+)\s*\)", t)
            target = dec_dtype(int(m.group(1)) if m else 0)
        elif t.startswith("decimal") or t in ("double", "float", "real"):
            target = "float"
        elif t in ("int", "integer", "bigint", "long", "smallint", "tinyint"):
            target = "int"
        elif t == "date":
            target = "date"
        elif t in ("string", "varchar", "char") or t.startswith(("varchar", "char")):
            target = "str"
        else:
            raise PlanError(f"unsupported cast target {t}")
        if isinstance(e, P.BLit):
            return _fold_cast_literal(e, target)
        return P.BCall(target, "cast", [e])

    def _bind_funccall(self, node: A.FuncCall) -> P.BExpr:
        name = node.name
        if node.over is not None:
            raise PlanError(f"window function {name} outside window planning")
        if name in _AGG_FUNCS or name in _WINDOW_ONLY:
            raise PlanError(f"aggregate {name} in non-aggregate context")
        args = [self.bind(a) for a in node.args]
        if name in ("substr", "substring"):
            start = args[1].value if isinstance(args[1], P.BLit) else None
            length = args[2].value if len(args) > 2 and \
                isinstance(args[2], P.BLit) else None
            if start is None:
                raise PlanError("substr start must be literal")
            return P.BCall("str", "substr", [args[0]], extra=(start, length))
        if name == "coalesce":
            dtype = _common_dtype([a.dtype for a in args])
            return P.BCall(dtype, "coalesce",
                           [_coerce_to(a, dtype) for a in args])
        if name == "abs":
            return P.BCall(args[0].dtype, "abs", args)
        if name == "round":
            digits = args[1].value if len(args) > 1 and \
                isinstance(args[1], P.BLit) else 0
            out = dec_dtype(max(int(digits), 0)) \
                if is_dec(args[0].dtype) else "float"
            return P.BCall(out, "round", [args[0]], extra=digits)
        if name == "nullif":
            if is_dec(args[0].dtype) or is_dec(args[1].dtype):
                a0, a1 = _coerce_pair(args[0], args[1])
                return P.BCall(a0.dtype, "nullif", [a0, a1])
            return P.BCall(args[0].dtype, "nullif", args)
        if name == "grouping":
            e = self.scope.resolve_local("__grouping_id", None)
            if e is None or self.num_group_cols is None:
                raise PlanError("grouping() outside rollup aggregation")
            target = self.rewrites.get(_ast_key(node.args[0]))
            if target is None:
                raise PlanError("grouping() argument is not a group expression")
            gid_col = P.BCol("int", e.index, "__grouping_id")
            # Spark convention: bit 0 is the LAST group expression
            bit = self.num_group_cols - 1 - target.index
            return P.BCall("int", "grouping_bit", [gid_col], extra=bit)
        if name == "concat":
            return P.BCall("str", "concat", args)
        if name in ("upper", "lower"):
            return P.BCall("str", name, args)
        raise PlanError(f"unsupported function {name}")

    def _bind_scalarsubquery(self, node: A.ScalarSubquery) -> P.BExpr:
        if id(node) in self.subquery_cols:
            return self.subquery_cols[id(node)]
        plan = self.planner.plan_query(node.query, outer=None, ctes=self.ctes)
        if len(plan.out_dtypes) != 1:
            raise PlanError("scalar subquery must return one column")
        return P.BScalarSubquery(plan.out_dtypes[0], plan)

    def _bind_exists(self, node: A.Exists):
        if id(node) in self.subquery_cols:
            return self.subquery_cols[id(node)]
        raise PlanError("EXISTS is only supported as a WHERE conjunct")

    def _bind_insubquery(self, node: A.InSubquery):
        if id(node) in self.subquery_cols:
            return self.subquery_cols[id(node)]
        raise PlanError("IN <subquery> is only supported as a WHERE conjunct")

    def _bind_star(self, node: A.Star):
        raise PlanError("* outside SELECT list")

    def _bind_interval(self, node: A.Interval):
        raise PlanError("interval literal outside +/- expression")


# ---------------------------------------------------------------------------
# small AST utilities
# ---------------------------------------------------------------------------

def _children(node):
    if isinstance(node, A.BinOp):
        return (node.left, node.right)
    if isinstance(node, A.UnaryOp):
        return (node.operand,)
    if isinstance(node, A.FuncCall):
        extra = []
        if node.over is not None:
            extra = list(node.over.partition_by) + \
                [si.expr for si in node.over.order_by]
        return tuple(node.args) + tuple(extra)
    if isinstance(node, A.Case):
        out = []
        if node.operand is not None:
            out.append(node.operand)
        for c, v in node.whens:
            out += [c, v]
        if node.else_ is not None:
            out.append(node.else_)
        return tuple(out)
    if isinstance(node, A.Cast):
        return (node.expr,)
    if isinstance(node, A.Between):
        return (node.expr, node.low, node.high)
    if isinstance(node, A.InList):
        return (node.expr, *node.items)
    if isinstance(node, A.InSubquery):
        return (node.expr,)
    if isinstance(node, A.Like):
        return (node.expr, node.pattern)
    if isinstance(node, A.IsNull):
        return (node.expr,)
    if isinstance(node, A.Interval):
        return (node.value,)
    return ()


def _split_and(node) -> list:
    if isinstance(node, A.BinOp) and node.op == "and":
        return _split_and(node.left) + _split_and(node.right)
    return [node]


def _split_or(node) -> list:
    if isinstance(node, A.BinOp) and node.op == "or":
        return _split_or(node.left) + _split_or(node.right)
    return [node]


def _or_implied_conjuncts(conjuncts: list) -> list:
    """Predicates common to every branch of an OR conjunct are implied by it
    and can be lifted to top level: (A ∧ x) ∨ (A ∧ y) ⇒ A. TPC-DS-style
    queries (e.g. reference query13/query48 templates) bury their equi-join
    conditions inside OR blocks; without lifting, those joins plan as cross
    products. The OR itself stays as a residual filter, so this is purely
    an implication — never a rewrite."""
    implied = []
    for c in conjuncts:
        branches = _split_or(c)
        if len(branches) < 2:
            continue
        branch_maps = [{_ast_key(p): p for p in _split_and(b)}
                       for b in branches]
        common = set(branch_maps[0])
        for bm in branch_maps[1:]:
            common &= set(bm)
        implied.extend(branch_maps[0][k] for k in sorted(common))
    return implied


def _and_all(parts):
    if not parts:
        return None
    out = parts[0]
    for p in parts[1:]:
        out = P.BCall("bool", "and", [out, p])
    return out


def _has_subquery(node) -> bool:
    if isinstance(node, (A.ScalarSubquery, A.InSubquery, A.Exists)):
        return True
    return any(_has_subquery(c) for c in _children(node))


def _collect_aggs(node, out: list):
    if isinstance(node, A.FuncCall):
        if node.over is not None:
            # window call itself is not an aggregate, but aggregates may
            # appear inside its args / PARTITION BY / ORDER BY (rank over sum)
            for c in _children(node):
                _collect_aggs(c, out)
            return
        if node.name in _AGG_FUNCS:
            out.append(node)
            return
    if isinstance(node, (A.ScalarSubquery, A.InSubquery, A.Exists)):
        return
    for c in _children(node):
        _collect_aggs(c, out)


def _collect_windows(node, out: list):
    if isinstance(node, A.FuncCall) and node.over is not None:
        out.append(node)
        return
    for c in _children(node):
        _collect_windows(c, out)


def _is_correlated(q: A.Query, outer_scope: Scope, planner, ctes) -> bool:
    """Does the subquery's WHERE reference a column only the outer resolves?"""
    body = q.body
    if not (isinstance(body, A.Select) and body.where is not None):
        return False
    inner_quals = _relation_aliases(body)
    inner_cols = _inner_columns(body, planner, ctes)
    found = [False]

    def visit(x):
        if isinstance(x, A.ColumnRef):
            if x.qualifier is not None:
                if x.qualifier not in inner_quals and \
                        outer_scope.resolve_local(x.name, x.qualifier) is not None:
                    found[0] = True
            elif x.name not in inner_cols and \
                    outer_scope.resolve_local(x.name, None) is not None:
                found[0] = True
        for c in _children(x):
            visit(c)
    visit(body.where)
    return found[0]


def _inner_columns(sel: A.Select, planner, ctes) -> set:
    """Column names visible from the subquery's own FROM relations."""
    cols: set = set()

    def visit(n):
        if isinstance(n, A.TableRef):
            if n.name in ctes:
                cols.update(ctes[n.name].out_names)
            else:
                try:
                    names, _ = planner.catalog.schema(n.name)
                    cols.update(names)
                except PlanError:
                    pass
        elif isinstance(n, A.SubqueryRef):
            pass  # alias-qualified access only; unqualified matches are rare
        elif isinstance(n, A.Join):
            visit(n.left)
            visit(n.right)
    if sel.from_ is not None:
        visit(sel.from_)
    return cols


def _relation_aliases(sel: A.Select) -> set:
    out = set()

    def visit(n):
        if isinstance(n, A.TableRef):
            out.add(n.alias or n.name)
        elif isinstance(n, A.SubqueryRef):
            out.add(n.alias)
        elif isinstance(n, A.Join):
            visit(n.left)
            visit(n.right)
    if sel.from_ is not None:
        visit(sel.from_)
    return out


def _extract_correlation(where, outer_scope, planner, ctes, inner_sel):
    """Split subquery WHERE into correlation equality pairs and inner-only rest.

    Returns ([(outer_ast, inner_ast)], remaining_where_ast).
    """
    if where is None:
        return [], [], None
    inner_quals = _relation_aliases(inner_sel)
    inner_cols = _inner_columns(inner_sel, planner, ctes)

    def side_is_outer(x) -> Optional[bool]:
        """True if expr references outer scope, False if inner, None if unclear."""
        verdict = []

        def visit(y):
            if isinstance(y, A.ColumnRef):
                if y.qualifier is not None:
                    if y.qualifier in inner_quals:
                        verdict.append(False)
                    elif outer_scope.resolve_local(y.name, y.qualifier) is not None:
                        verdict.append(True)
                    else:
                        verdict.append(False)
                else:
                    if y.name in inner_cols:
                        verdict.append(False)
                    elif outer_scope.resolve_local(y.name, None) is not None:
                        verdict.append(True)
                    else:
                        verdict.append(False)
            for c in _children(y):
                visit(c)
        visit(x)
        if not verdict:
            return None
        if all(verdict):
            return True
        if not any(verdict):
            return False
        return None

    corr = []
    mixed = []
    rest = []
    for c in _split_and(where):
        if isinstance(c, A.BinOp) and c.op == "=":
            ls, rs = side_is_outer(c.left), side_is_outer(c.right)
            if ls is True and rs is False:
                corr.append((c.left, c.right))
                continue
            if ls is False and rs is True:
                corr.append((c.right, c.left))
                continue
        # non-extractable conjuncts that still reference the outer scope
        # (e.g. q16's cs1.cs_warehouse_sk <> cs2.cs_warehouse_sk) become
        # residual predicates on the semi/anti join
        if side_is_outer(c) in (True, None):
            mixed.append(c)
        else:
            rest.append(c)
    remaining = None
    for c in rest:
        remaining = c if remaining is None else A.BinOp("and", remaining, c)
    return corr, mixed, remaining


def _substitute_aliases(expr, items):
    """Rewrite bare ColumnRefs naming a select alias into the aliased
    expression (for ORDER BY expressions referencing output aliases)."""
    import dataclasses

    aliases = {it.alias: it.expr for it in items if it.alias}

    def walk(x):
        if isinstance(x, A.ColumnRef) and x.qualifier is None and \
                x.name in aliases:
            return aliases[x.name]
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            changes = {}
            for f in dataclasses.fields(x):
                v = getattr(x, f.name)
                if isinstance(v, tuple):
                    nv = tuple(walk(e) if dataclasses.is_dataclass(e) else e
                               for e in v)
                    if nv != v:
                        changes[f.name] = nv
                elif isinstance(v, list):
                    nv = [walk(e) if dataclasses.is_dataclass(e) else
                          (tuple(walk(s) if dataclasses.is_dataclass(s) else s
                                 for s in e) if isinstance(e, tuple) else e)
                          for e in v]
                    if nv != v:
                        changes[f.name] = nv
                elif dataclasses.is_dataclass(v) and not isinstance(v, type):
                    nv = walk(v)
                    if nv is not v:
                        changes[f.name] = nv
            return dataclasses.replace(x, **changes) if changes else x
        return x

    return walk(expr)


def _nested_subqueries(node) -> list:
    """Exists/InSubquery nodes anywhere in `node` (the conjunct itself is
    never returned — callers handle the top level); does not descend into
    subquery bodies."""
    out = []

    def visit(x, top):
        if isinstance(x, (A.Exists, A.InSubquery)):
            if not top:
                out.append(x)
            return
        if isinstance(x, A.ScalarSubquery):
            return
        for ch in _children(x):
            visit(ch, False)
    visit(node, True)
    return out


def _trunc_mod(a, b):
    """Truncated (sign-of-dividend) mod, matching the runtime fmod — Python's
    % is floored and diverges on negative operands."""
    r = abs(a) % abs(b)
    return r if a >= 0 else -r


def _const_fold(e: P.BExpr) -> P.BExpr:
    """Fold arithmetic over literals (e.g. the IN-list element [YEAR] + 1
    instantiated as 1999 + 1) into a single literal."""
    if not isinstance(e, P.BCall):
        return e
    ops = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
           "mul": lambda a, b: a * b, "neg": lambda a: -a,
           "div": lambda a, b: a / b, "mod": _trunc_mod}
    fn = ops.get(e.op)
    if fn is None:
        return e
    args = [_const_fold(a) for a in e.args]
    if all(isinstance(a, P.BLit) and a.value is not None for a in args):
        if e.dtype == "float" and any(is_dec(a.dtype) for a in args):
            # dec literals carry ALREADY-SCALED ints; a float-typed result
            # (mul/div/mod with a float operand) must fold on descaled values
            # or it comes out 10^scale too large
            args = [_fold_cast_literal(a, "float") if is_dec(a.dtype) else a
                    for a in args]
        try:
            return P.BLit(e.dtype, fn(*[a.value for a in args]))
        except (TypeError, ZeroDivisionError):
            return e
    return e


# -- dtype coercion ----------------------------------------------------------

def _common_dtype(dtypes: list[str]) -> str:
    s = set(dtypes)
    if "str" in s and s - {"str"}:
        non_null = s - {"str"}
        # NULL literals bind as int; treat mixed str/int-null as str
        if non_null <= {"int"}:
            return "str"
    if len(s) == 1:
        return next(iter(s))
    decs = {d for d in s if is_dec(d)}
    if decs:
        rest = s - decs
        if rest <= {"int"}:              # dec + int -> widest decimal scale
            return dec_dtype(max(dec_scale(d) for d in decs))
        if rest <= {"int", "float"}:     # dec + float -> float
            return "float"
        raise PlanError(f"no common type for {sorted(s)}")
    if s <= {"int", "float"}:
        return "float"
    if s <= {"int", "date"}:
        return "date"
    if s <= {"int", "bool"}:
        return "bool"
    if s <= {"int", "str"}:
        return "str"
    if s <= {"int", "float", "date"}:
        return "float"
    raise PlanError(f"no common type for {sorted(s)}")


def _coerce_to(e: P.BExpr, dtype: str) -> P.BExpr:
    if e.dtype == dtype:
        return e
    if isinstance(e, P.BLit):
        if e.value is None:
            return P.BLit(dtype, None)
        return _fold_cast_literal(e, dtype)
    return P.BCall(dtype, "cast", [e])


def _fold_cast_literal(e: P.BLit, target: str) -> P.BLit:
    v = e.value
    if v is None:
        return P.BLit(target, None)
    if target == "date" and isinstance(v, str):
        return P.BLit("date", _date_to_days(v))
    if target == "float":
        if is_dec(e.dtype):
            return P.BLit("float", v / 10 ** dec_scale(e.dtype))
        return P.BLit("float", float(v))
    if target == "int":
        if is_dec(e.dtype):
            # integer truncation toward zero, matching the runtime cast
            # (float division would round above 2^53)
            s = 10 ** dec_scale(e.dtype)
            return P.BLit("int", (1 if v >= 0 else -1) * (abs(int(v)) // s))
        return P.BLit("int", int(v))
    if target == "str":
        return P.BLit("str", str(v))
    if is_dec(target):
        # decN literal value convention: the ALREADY-SCALED integer
        import decimal
        src = decimal.Decimal(v).scaleb(-dec_scale(e.dtype)) \
            if is_dec(e.dtype) else decimal.Decimal(str(v))
        scaled = int(src.scaleb(dec_scale(target)).to_integral_value(
            rounding=decimal.ROUND_HALF_UP))
        return P.BLit(target, scaled)
    return P.BLit(target, v)


def _dec_representable(v, scale: int) -> bool:
    """Is literal v exact at decimal scale (Decimal-based: float math would
    report 1.1*100 != 110)?"""
    import decimal
    d = decimal.Decimal(str(v)).scaleb(scale)
    return d == d.to_integral_value()


def _coerce_pair(a: P.BExpr, b: P.BExpr) -> tuple[P.BExpr, P.BExpr]:
    if a.dtype == b.dtype:
        return a, b
    # date vs string literal
    if a.dtype == "date" and isinstance(b, P.BLit) and b.dtype == "str":
        return a, P.BLit("date", _date_to_days(b.value))
    if b.dtype == "date" and isinstance(a, P.BLit) and a.dtype == "str":
        return P.BLit("date", _date_to_days(a.value)), b
    # decimal alignment: dec vs dec/int stays exact on scaled integers;
    # dec vs float literal folds the literal to the decimal scale when it is
    # exactly representable there, else both sides go to float
    da, db = is_dec(a.dtype), is_dec(b.dtype)
    if da or db:
        if da and db:
            t = dec_dtype(max(dec_scale(a.dtype), dec_scale(b.dtype)))
            return _coerce_to(a, t), _coerce_to(b, t)
        dec_e, other = (a, b) if da else (b, a)
        t = dec_e.dtype
        if other.dtype == "int" or (
                isinstance(other, P.BLit) and other.dtype == "float"
                and other.value is not None
                and _dec_representable(other.value, dec_scale(t))):
            return _coerce_to(a, t), _coerce_to(b, t)
        return _coerce_to(a, "float"), _coerce_to(b, "float")
    # numeric widening
    if {a.dtype, b.dtype} <= {"int", "float"}:
        return _coerce_to(a, "float"), _coerce_to(b, "float")
    if {a.dtype, b.dtype} <= {"int", "date"}:
        return a, b  # date arithmetic/comparison on day numbers
    # string vs numeric literal comparisons: cast literal to string
    if a.dtype == "str" and isinstance(b, P.BLit):
        return a, P.BLit("str", str(b.value))
    if b.dtype == "str" and isinstance(a, P.BLit):
        return P.BLit("str", str(a.value)), b
    # string column vs numeric column: cast string to float
    if a.dtype == "str":
        return P.BCall("float", "cast", [a]), _coerce_to(b, "float")
    if b.dtype == "str":
        return _coerce_to(a, "float"), P.BCall("float", "cast", [b])
    return a, b


def _arith_dtype(op: str, a: P.BExpr, b: P.BExpr) -> str:
    if op == "div":
        return "float"
    if a.dtype == "date" or b.dtype == "date":
        # date +/- int -> date; date - date -> int
        if a.dtype == "date" and b.dtype == "date":
            return "int"
        return "date"
    da, db = is_dec(a.dtype), is_dec(b.dtype)
    if da or db:
        if a.dtype == "float" or b.dtype == "float" or op == "mod":
            return "float"
        if op == "mul":    # scaled-int product: scales add; dec*int keeps s
            return dec_dtype((dec_scale(a.dtype) if da else 0) +
                             (dec_scale(b.dtype) if db else 0))
        # add/sub arrive scale-aligned from _coerce_pair
        return a.dtype if da else b.dtype
    if a.dtype == "float" or b.dtype == "float":
        return "float"
    return "int"


def _flatten_concat(left: P.BExpr, right: P.BExpr) -> list[P.BExpr]:
    parts = []
    for e in (left, right):
        if isinstance(e, P.BCall) and e.op == "concat":
            parts.extend(e.args)
        else:
            parts.append(e)
    return parts


def _col_indices(e: P.BExpr) -> list[int]:
    out = []

    def visit(x):
        if isinstance(x, P.BCol):
            out.append(x.index)
        if isinstance(x, P.BCall):
            for a in x.args:
                visit(a)
    visit(e)
    return out


def _shift(e: P.BExpr, delta: int) -> P.BExpr:
    if isinstance(e, P.BCol):
        return P.BCol(e.dtype, e.index + delta, e.name)
    if isinstance(e, P.BCall):
        return P.BCall(e.dtype, e.op, [_shift(a, delta) for a in e.args],
                       e.extra)
    return e


def _display_name(node) -> str:
    if isinstance(node, A.ColumnRef):
        return node.name
    if isinstance(node, A.FuncCall):
        inner = ", ".join(_display_name(a) for a in node.args) if node.args else ""
        if node.args and isinstance(node.args[0], A.Star):
            inner = "*"
        return f"{node.name}({inner})"
    if isinstance(node, A.Star):
        return "*"
    if isinstance(node, A.Literal):
        return str(node.value)
    if isinstance(node, A.BinOp):
        return f"({_display_name(node.left)} {node.op} {_display_name(node.right)})"
    if isinstance(node, A.Case):
        return "case"
    if isinstance(node, A.Cast):
        return _display_name(node.expr)
    return type(node).__name__.lower()
