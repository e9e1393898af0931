# Copied from nds_tpu/engine/streaming.py, verbatim but for history notes in
# comments and the functions of later slices: verify_groups, the
# sharded-morsel helpers (partition_morsel_rows, shard_capacity) and
# adapt_schedule are left out.
"""Out-of-core execution: morsel-streamed scan -> filter/join -> partial agg.

The single-chip answer to "the table does not fit" (SURVEY.md §5 long-context
analog; the reference bounds scans with
spark.sql.files.maxPartitionBytes=2gb chunking + shuffle spill,
power_run_gpu.template SPARK_CONF): when a plan aggregates over ONE large
scan through per-row operators (filters, projections, joins whose build
sides are dimension-sized), the large table streams through the device in
fixed-capacity morsels. Each morsel runs the SAME compiled XLA program
(capacities inflated to the morsel bound, so the schedule holds for every
morsel); per-morsel partial aggregates merge on host, and a final plan
recomputes the query's aggregate output from the partials.

Eligibility is decided on the BOUND plan; ineligible plans (windows,
distinct aggs, stddev, big-scan string payloads, multiple big scans) simply
run the normal in-core path.
"""
from __future__ import annotations

import dataclasses
from dataclasses import replace
from typing import Optional

from . import plan as P
from .plan import (AggregateNode, AggSpec, BCall, BCol, FilterNode, JoinNode,
                   LimitNode, MaterializedNode, PlanNode, ProjectNode,
                   ScanNode, SortNode, walk)

MORSEL_TABLE = "__morsel__"


@dataclasses.dataclass
class StreamingPlan:
    """A rewritten plan pair: per-morsel partial plan + final merge plan."""
    big_table: str                 # source table being streamed
    big_columns: list[str]         # projected columns of the big scan
    partial_plan: PlanNode         # aggregates one morsel (scan = MORSEL_TABLE)
    partial_names: list[str]
    partial_dtypes: list[str]
    build_final: "callable"        # (partials Materialized) -> final PlanNode
    path: list = dataclasses.field(default_factory=list)
    # post-aggregate nodes above the original aggregate (for rebuild_above)


def _path_to_aggregate(plan: PlanNode):
    """Locate the single AggregateNode with only post-agg nodes above it.

    Windows ABOVE the aggregate are allowed (rank-over-aggregated shapes):
    they run in the final phase over the merged partials, which are
    group-cardinality-sized."""
    path = []
    node = plan
    while True:
        if isinstance(node, AggregateNode):
            return path, node
        if isinstance(node, (SortNode, LimitNode, ProjectNode, FilterNode,
                             P.WindowNode)) \
                and not isinstance(node, AggregateNode):
            path.append(node)
            node = node.child
            continue
        return None, None


def _big_scan(sub: PlanNode, est_rows, threshold: int
              ) -> Optional[ScanNode]:
    """The unique streaming-eligible big scan under the aggregate, if any.

    The big scan must sit on the LEFT spine (probe side): every JoinNode on
    the path from the aggregate to it must have the big lineage as `left`
    with an inner/left/semi/anti kind, and all other scans must be small.
    Scans inside expression subqueries count too (iter_plan_nodes): a
    scalar subquery over the big table would otherwise embed a full
    big-table scan in every morsel program.
    """
    scans = [n for n in P.iter_plan_nodes(sub) if isinstance(n, ScanNode)]
    big = [s for s in scans if est_rows(s.table) > threshold]
    if len(big) != 1:
        return None
    target = big[0]

    def on_left_spine(node) -> bool:
        if node is target:
            return True
        if isinstance(node, (FilterNode, ProjectNode)):
            return on_left_spine(node.child)
        if isinstance(node, JoinNode):
            if node.kind not in ("inner", "left", "semi", "anti"):
                return False
            # the big scan must not hide in the build side
            if any(n is target for n in walk(node.right)):
                return False
            return on_left_spine(node.left)
        return False

    return target if on_left_spine(sub) else None


def _contains_unsupported(sub: PlanNode, big: ScanNode) -> bool:
    """Unsupported nodes block streaming ONLY when the big scan flows
    through them (the morsel boundary would split their semantics).
    Window/distinct/setop/aggregate shapes on the small side — q6/q8-class
    scalar-subquery joins over dimensions — execute whole inside every
    morsel program and stay correct."""
    for n in P.iter_plan_nodes(sub):
        if isinstance(n, (P.WindowNode, P.DistinctNode, P.SetOpNode,
                          AggregateNode)) \
                and any(m is big for m in P.iter_plan_nodes(n)):
            return True
    # string payloads from the big scan would need per-morsel dictionaries
    # (one compiled program could not be reused); group keys and filters on
    # dimension strings are fine
    for i, dt in enumerate(big.out_dtypes):
        if dt == "str":
            return True
    return False


def try_streaming_plan(plan: PlanNode, est_rows, threshold: int
                       ) -> Optional[StreamingPlan]:
    """Single top-path streamable aggregate (the original API, kept for
    eligibility tests): a thin view over the generalized _try_job
    machinery — one branch, one big scan, post-agg path preserved."""
    path, agg = _path_to_aggregate(plan)
    if agg is None:
        return None
    job = _try_job(agg, est_rows, threshold)
    if job is None or len(job.branches) != 1 \
            or job.branches[0].big_table is None:
        return None
    b = job.branches[0]
    return StreamingPlan(b.big_table, list(b.big_columns), b.partial_plan,
                         job.partial_names, job.partial_dtypes,
                         job.build_final, path)



# ---------------------------------------------------------------------------
# generalized streaming: materialize EVERY maximal streamable
# aggregate subtree anywhere in the plan — not just a single top-path
# aggregate — with UNION ALL branch support, so multi-fact-channel queries
# (q2/q4/q5-class ss+cs+ws unions) and aggregates below joins stream too.
# Reference frame: Spark chunks every scan via maxPartitionBytes and spills
# shuffles regardless of plan position (power_run_gpu.template SPARK_CONF).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BranchStream:
    """One UNION ALL branch of a streamable aggregate."""
    partial_plan: PlanNode          # partial agg over this branch
    big_table: Optional[str]        # None => in-core one-shot branch
    big_columns: list[str]


@dataclasses.dataclass
class StreamJob:
    """A streamable aggregate subtree: stream each branch, union the
    partials, combine/merge, substitute a MaterializedNode for `agg`.

    For semi/anti joins whose BUILD side holds the big scan (q10/q16-class
    EXISTS subqueries), `agg` is a SYNTHESIZED distinct-key aggregate over
    the join's right side: `join_patch` names the join whose right/
    right_keys get patched to the materialized key set (semi/anti only
    consume the right-side key SET, so dedup preserves semantics, including
    null-aware NOT IN — the NULL group survives the group-by)."""
    agg: AggregateNode
    branches: list[BranchStream]
    partial_names: list[str]
    partial_dtypes: list[str]
    build_final: "callable"        # (partials Materialized) -> final PlanNode
    build_combine: "callable"      # (partials Materialized) -> partial-schema
    # re-aggregation plan for periodic compaction of accumulated partials
    join_patch: Optional[JoinNode] = None


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


def _combine_builder(agg: AggregateNode, recipes, p_names, p_dtypes):
    """Partial-schema-preserving re-aggregation: compacts accumulated
    partials mid-stream (bounds host memory when group cardinality is
    large, e.g. customer-grained q4-class aggregates at SF100). Associative
    and idempotent — safe to apply any number of times before build_final."""
    ngroups = len(agg.group_exprs)

    def build_combine(partials: MaterializedNode) -> PlanNode:
        gidx = list(range(ngroups))
        if agg.rollup:
            gidx.append(len(p_names) - 1)
        group_refs = [BCol(p_dtypes[i], i, p_names[i]) for i in gidx]
        specs: list[AggSpec] = []
        piece_cols = []
        for _spec, (kind, idxs) in zip(agg.aggs, recipes):
            for pos, j in enumerate(idxs):
                func = kind if kind in ("min", "max") else "sum"
                specs.append(AggSpec(func, BCol(p_dtypes[j], j), False,
                                     p_names[j]))
                piece_cols.append(j)
        a_names = [p_names[i] for i in gidx] + [s.name for s in specs]
        a_dtypes = [p_dtypes[i] for i in gidx] + [s.dtype for s in specs]
        merged = AggregateNode(child=partials, group_exprs=group_refs,
                               aggs=specs, out_names=a_names,
                               out_dtypes=a_dtypes)
        # project back into the exact partial column order
        exprs: list = []
        for i in range(len(p_names)):
            if i < ngroups:
                exprs.append(BCol(p_dtypes[i], i, p_names[i]))
            elif agg.rollup and i == len(p_names) - 1:
                exprs.append(BCol("int", ngroups, "__grouping_id"))
            else:
                pos = piece_cols.index(i)
                src = len(gidx) + pos
                exprs.append(BCol(a_dtypes[src], src, p_names[i]))
        return ProjectNode(merged, exprs, out_names=list(p_names),
                           out_dtypes=list(p_dtypes))
    return build_combine


def _union_branches(child: PlanNode) -> list[PlanNode]:
    """Flatten a UNION ALL found on the LEFT spine (through Project/Filter
    nodes and probe sides of joins — the q2/q5 shape is
    agg(join(union(ss,cs,ws), dims))) into per-branch plans with the spine
    cloned atop each branch; [child] when there is no union."""
    spine: list[tuple[PlanNode, str]] = []
    node = child
    while True:
        if isinstance(node, (ProjectNode, FilterNode)):
            spine.append((node, "child"))
            node = node.child
        elif isinstance(node, JoinNode) and node.kind in (
                "inner", "left", "semi", "anti"):
            spine.append((node, "left"))
            node = node.left
        else:
            break
    if not (isinstance(node, P.SetOpNode) and node.op == "union" and node.all):
        return [child]
    branches: list[PlanNode] = []

    def flat(n: PlanNode) -> None:
        if isinstance(n, P.SetOpNode) and n.op == "union" and n.all:
            flat(n.left)
            flat(n.right)
        else:
            branches.append(n)

    flat(node)
    out = []
    for b in branches:
        nb = b
        for parent, field in reversed(spine):
            nb = replace(parent, **{field: nb})
        out.append(nb)
    return out


def _commute_join(join: JoinNode) -> PlanNode:
    """Swap an INNER join's sides (keys swapped, residual remapped) and
    restore the original column order with a Project, so the big scan
    lands on the probe (left) spine."""
    from .colprune import _remap_expr

    wl, wr = len(join.left.out_names), len(join.right.out_names)
    mapping = {i: wr + i for i in range(wl)}
    mapping.update({wl + j: j for j in range(wr)})
    residual = None if join.residual is None else \
        _remap_expr(join.residual, mapping)
    swapped = JoinNode(
        join.right, join.left, "inner",
        left_keys=list(join.right_keys), right_keys=list(join.left_keys),
        residual=residual, null_aware=join.null_aware,
        late_mat=join.late_mat,
        out_names=list(join.right.out_names) + list(join.left.out_names),
        out_dtypes=list(join.right.out_dtypes) + list(join.left.out_dtypes))
    perm = [BCol(join.out_dtypes[i], wr + i, join.out_names[i])
            for i in range(wl)] + \
           [BCol(join.out_dtypes[wl + j], j, join.out_names[wl + j])
            for j in range(wr)]
    return ProjectNode(swapped, perm, out_names=list(join.out_names),
                       out_dtypes=list(join.out_dtypes))


def _rotate_big_left(node: PlanNode, est_rows, threshold: int) -> PlanNode:
    """Canonicalize the probe spine: INNER joins whose BUILD side holds the
    big scan commute (q2-class date_dim-join-union plans), so the
    left-spine rule sees the streamable orientation. Descends Project/
    Filter chains, union branches, and probe sides."""
    def has_big(n: PlanNode) -> bool:
        return any(isinstance(m, ScanNode) and est_rows(m.table) > threshold
                   for m in P.iter_plan_nodes(n))

    if isinstance(node, (ProjectNode, FilterNode)):
        child = _rotate_big_left(node.child, est_rows, threshold)
        return node if child is node.child else replace(node, child=child)
    if isinstance(node, P.SetOpNode) and node.op == "union" and node.all:
        left = _rotate_big_left(node.left, est_rows, threshold)
        right = _rotate_big_left(node.right, est_rows, threshold)
        if left is node.left and right is node.right:
            return node
        return replace(node, left=left, right=right)
    if isinstance(node, JoinNode):
        if node.kind == "inner" and has_big(node.right) \
                and not has_big(node.left):
            return _rotate_big_left(_commute_join(node), est_rows, threshold)
        if node.kind in ("inner", "left", "semi", "anti"):
            left = _rotate_big_left(node.left, est_rows, threshold)
            return node if left is node.left else replace(node, left=left)
    return node


def _swap_scan(plan: PlanNode, big: ScanNode) -> PlanNode:
    def swap(node: PlanNode) -> PlanNode:
        if node is big:
            return replace(node, table=MORSEL_TABLE)
        repl = {}
        for f in ("child", "left", "right"):
            sub = getattr(node, f, None)
            if isinstance(sub, PlanNode):
                repl[f] = swap(sub)
        return replace(node, **repl) if repl else node
    return swap(plan)


def _try_job(agg: AggregateNode, est_rows, threshold: int
             ) -> Optional[StreamJob]:
    if not _mergeable(agg):
        return None
    branches = _union_branches(
        _rotate_big_left(agg.child, est_rows, threshold))
    partial_specs, recipes, p_names, p_dtypes = _decompose(agg)
    bstreams: list[BranchStream] = []
    saw_big = False
    for b in branches:
        if any(isinstance(n, MaterializedNode) for n in P.iter_plan_nodes(b)):
            return None
        bigs = [n for n in P.iter_plan_nodes(b) if isinstance(n, ScanNode)
                and est_rows(n.table) > threshold]
        if not bigs:
            bstreams.append(BranchStream(
                AggregateNode(child=b, group_exprs=list(agg.group_exprs),
                              aggs=list(partial_specs), rollup=agg.rollup,
                              out_names=list(p_names),
                              out_dtypes=list(p_dtypes)),
                None, []))
            continue
        big = _big_scan(b, est_rows, threshold)
        if big is None or _contains_unsupported(b, big):
            return None
        saw_big = True
        bstreams.append(BranchStream(
            AggregateNode(child=_swap_scan(b, big),
                          group_exprs=list(agg.group_exprs),
                          aggs=list(partial_specs), rollup=agg.rollup,
                          out_names=list(p_names), out_dtypes=list(p_dtypes)),
            big.table, list(big.columns)))
    if not saw_big:
        return None
    return StreamJob(agg, bstreams, p_names, p_dtypes,
                     _final_builder(agg, recipes, p_names, p_dtypes),
                     _combine_builder(agg, recipes, p_names, p_dtypes))


# ---------------------------------------------------------------------------
# shared-scan morsel fusion: all streaming branches of one query
# that scan the same big table share ONE morsel pass. The union of their
# pruned column sets is packed/uploaded once per morsel; each branch's
# partial program reads its subset as zero-copy views (a ProjectNode of
# BCol references over the shared staged buffer — column selection fuses
# into the compiled program, no copies). q9-class plans carry 15 scalar-
# subquery jobs over store_sales: without sharing, the dominant scan +
# upload cost is paid 15 times per query (the Flare/shared-scan lineage).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ScanGroup:
    """The streaming branches of one query that scan the same big table.

    `plans[i]` is members[i]'s partial plan rewritten (fuse_group) to read
    the shared union-column morsel scan; `members[i]` is the (job_index,
    branch_index) it serves. One morsel iterator + one staged upload per
    morsel serves every member. `lanes` is the STATIC per-column upload
    lane spec (device.plan_lanes, chosen once from table-wide column stats
    and held for every morsel of the pass — widths recorded in the plan,
    never decided per morsel, so they cannot cause mid-stream recompiles);
    None = the legacy wide int64 layout (narrow_lanes off)."""
    table: str
    columns: list[str]             # union of member pruned column sets
    dtypes: list[str]
    members: list[tuple]           # (job_index, branch_index)
    plans: list[PlanNode]
    lanes: Optional[tuple] = None
    # encoded execution (device.plan_encodings): per-column wire encoding
    # tags + host codebooks, chosen ONCE per group from cardinality/run
    # stats like the lane spec is from range stats. When set, `lanes`
    # already carries the dict columns' CODE lanes and `plain_lanes` keeps
    # the value-lane spec for bytes-saved accounting / A-B comparison.
    encodings: Optional[tuple] = None
    codebooks: Optional[tuple] = None
    plain_lanes: Optional[tuple] = None

    @property
    def morsel_key(self) -> str:
        """The executor scan-cache key every member's program reads."""
        return MORSEL_TABLE + "//" + ",".join(self.columns)


def set_group_lanes(group: ScanGroup, lanes: Optional[tuple]) -> None:
    """Attach a lane spec to a scan group: recorded on the group (the
    packer's static per-morsel contract) AND on every member plan's morsel
    ScanNode (width metadata the plan verifier checks against column
    stats). Copy-on-write — morsel scans may be shared across members."""
    if lanes is None:
        return
    group.lanes = tuple(lanes)
    for i, p in enumerate(group.plans):
        scan = _morsel_scan(p)
        group.plans[i] = substitute_nodes(
            p, {id(scan): replace(scan, lanes=tuple(lanes))})


def set_group_encodings(group: ScanGroup, encs: tuple, lanes: tuple,
                        codebooks: tuple) -> None:
    """Attach an encoding spec to a scan group (device.plan_encodings
    output): recorded on the group (the packer's static per-morsel
    contract) AND on every member plan's morsel ScanNode (encoding
    metadata the verifier proves against the same cardinality/run stats,
    and which program fingerprints include). `lanes` is the WIRE lane
    spec — dict columns ride their code lane."""
    group.plain_lanes = group.lanes
    group.lanes = tuple(lanes)
    group.encodings = tuple(encs)
    group.codebooks = tuple(codebooks)
    for i, p in enumerate(group.plans):
        scan = _morsel_scan(p)
        group.plans[i] = substitute_nodes(
            p, {id(scan): replace(scan, lanes=tuple(lanes),
                                  encodings=tuple(encs))})


def _morsel_scan(plan: PlanNode) -> ScanNode:
    return next(n for n in P.iter_plan_nodes(plan)
                if isinstance(n, ScanNode) and n.table == MORSEL_TABLE)


def fuse_group(branches: list[BranchStream]
               ) -> tuple[list[str], list[str], list[PlanNode]]:
    """Union the branches' pruned big-scan column sets and rewrite each
    partial plan so its morsel scan reads the UNION with a projection back
    to the branch's subset: every member then resolves against one staged
    device buffer per morsel (one pack + one upload), and the projection is
    zero-copy column selection inside the traced program. A branch already
    reading exactly the union keeps its plan unchanged (the single-branch /
    shared_scan=off case degenerates to the old per-branch behavior)."""
    union: list[str] = []
    dty: dict[str, str] = {}
    scans = []
    for b in branches:
        scan = _morsel_scan(b.partial_plan)
        scans.append(scan)
        for c, d in zip(scan.columns, scan.out_dtypes):
            if c not in dty:
                union.append(c)
                dty[c] = d
    dtypes = [dty[c] for c in union]
    idx = {c: i for i, c in enumerate(union)}
    plans = []
    for b, scan in zip(branches, scans):
        if list(scan.columns) == union:
            plans.append(b.partial_plan)
            continue
        shared = ScanNode(table=MORSEL_TABLE, columns=list(union),
                          out_names=list(union), out_dtypes=list(dtypes))
        view = P.column_view(shared, [idx[c] for c in scan.columns],
                             list(scan.out_names), list(scan.out_dtypes))
        plans.append(substitute_nodes(b.partial_plan, {id(scan): view}))
    return union, dtypes, plans


def plan_scan_groups(jobs: list[StreamJob], shared: bool) -> list[ScanGroup]:
    """Partition every streaming branch of `jobs` into ScanGroups: by big
    table when `shared` (one morsel pass per table per query), one group
    per branch otherwise (kept reachable for A/B via shared_scan=False).
    Branch order inside a group is (job, branch) order, so partial-merge
    order is deterministic."""
    from ..obs.trace import TRACER

    keyed: dict = {}
    order: list = []
    for ji, job in enumerate(jobs):
        for bi, b in enumerate(job.branches):
            if b.big_table is None:
                continue
            key = b.big_table if shared else (ji, bi)
            if key not in keyed:
                keyed[key] = []
                order.append(key)
            keyed[key].append((ji, bi, b))
    groups = []
    with TRACER.span("stream.plan_groups", shared=shared,
                     branches=sum(len(m) for m in keyed.values())):
        for key in order:
            members = keyed[key]
            cols, dtypes, plans = fuse_group([b for _, _, b in members])
            groups.append(ScanGroup(members[0][2].big_table, cols, dtypes,
                                    [(ji, bi) for ji, bi, _ in members],
                                    plans))
    return groups


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


def _try_semi_join_job(join: JoinNode, est_rows, threshold: int
                       ) -> Optional[StreamJob]:
    """Semi/anti join whose RIGHT (build) side holds the big scan: stream a
    synthesized distinct-key aggregate of the right side, then patch the
    join to probe the materialized key set."""
    if join.kind not in ("semi", "anti") or join.residual is not None:
        return None
    if not join.right_keys:
        return None
    bigs = [n for n in P.iter_plan_nodes(join.right) if isinstance(n, ScanNode)
            and est_rows(n.table) > threshold]
    if not bigs:
        return None
    key_names = [f"k{i}" for i in range(len(join.right_keys))]
    key_dtypes = [e.dtype for e in join.right_keys]
    synth = AggregateNode(
        child=join.right, group_exprs=list(join.right_keys),
        aggs=[AggSpec("count_star", None, False, "__n")],
        out_names=key_names + ["__n"], out_dtypes=key_dtypes + ["int"])
    job = _try_job(synth, est_rows, threshold)
    if job is None:
        return None
    job.join_patch = join
    return job


def find_streaming_jobs(plan: PlanNode, est_rows, threshold: int
                        ) -> list[StreamJob]:
    """Every MAXIMAL streamable aggregate subtree in the plan — including
    scalar-subquery plans (q9) and semi/anti-join build sides (q10) —
    pre-order; a qualifying aggregate claims its whole subtree. Shared
    nodes (CTE DAGs) yield one job serving every parent."""
    jobs: list[StreamJob] = []
    seen: set[int] = set()

    def visit(node: PlanNode) -> None:
        if id(node) in seen:
            return
        seen.add(id(node))
        claimed = False
        if isinstance(node, AggregateNode):
            job = _try_job(node, est_rows, threshold)
            if job is not None:
                jobs.append(job)
                claimed = True
        if not claimed and isinstance(node, JoinNode):
            job = _try_semi_join_job(node, est_rows, threshold)
            if job is not None:
                jobs.append(job)
                visit(node.left)      # probe side still gets its chance
                claimed = True
        if not claimed:
            for f in ("child", "left", "right"):
                sub = getattr(node, f, None)
                if isinstance(sub, PlanNode):
                    visit(sub)
        for sub in _expr_subplans(node):
            visit(sub)

    visit(plan)
    return jobs


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


def rebuild_above(path: list[PlanNode], new_agg_out: PlanNode) -> PlanNode:
    """Re-hang the post-aggregate nodes (sort/limit/having/project) over the
    merged aggregate output."""
    node = new_agg_out
    for parent in reversed(path):
        node = replace(parent, child=node)
    return node


def inflate_schedule(decisions: list, morsel_cap: int) -> list:
    """Round every capacity decision up to the morsel bound so ONE compiled
    program serves every morsel (filters/joins against unique dimension keys
    cannot exceed the morsel row count; a genuine expansion beyond it is
    caught by the schedule check and re-recorded)."""
    return [(kind, max(int(v), morsel_cap) if kind == "cap" else v)
            for kind, v in decisions]

