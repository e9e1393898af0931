# Copied from nds_tpu/engine/plan.py; only import paths changed.
"""Bound logical plan and expression IR.

The planner resolves every name to a column *position* in its input relation,
so self-joins and alias shadowing are settled before execution. Plan nodes are
relational; bound expressions are positional trees the expression evaluator
turns into vectorized JAX/numpy compute.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


# --------------------------------------------------------------------------
# bound expressions
# --------------------------------------------------------------------------

@dataclass
class BExpr:
    dtype: str  # "int" | "float" | "bool" | "date" | "str"


@dataclass
class BCol(BExpr):
    index: int
    name: str = ""


@dataclass
class BLit(BExpr):
    value: object  # python int/float/str/bool/None; date as epoch-days int


@dataclass
class BCall(BExpr):
    op: str
    args: list[BExpr] = field(default_factory=list)
    extra: object = None  # op-specific payload (e.g. cast target, like pattern)


@dataclass
class BParam(BExpr):
    """A hoisted literal: slot `index` of the execution's parameter vector.

    Stream-generated statements differ only in template parameter literals
    (reference dsqgen substitution, nds/nds_gen_query_stream.py:42-89);
    hoisting them out of the plan makes the compiled XLA program identical
    across streams/seeds, so the persistent compile cache serves every
    stream after the first (the Spark analog: re-planning is milliseconds,
    nds/nds_power.py:124-134)."""
    index: int


@dataclass
class BScalarSubquery(BExpr):
    plan: "PlanNode"


@dataclass
class AggSpec:
    func: str                 # sum, count, count_star, avg, min, max, stddev_samp
    arg: Optional[BExpr]      # None for count(*)
    distinct: bool = False
    name: str = ""

    @property
    def dtype(self) -> str:
        if self.func in ("count", "count_star"):
            return "int"
        if self.func in ("avg", "stddev_samp"):
            return "float"
        return self.arg.dtype if self.arg is not None else "int"


@dataclass
class SortKey:
    expr: BExpr
    asc: bool = True
    nulls_first: Optional[bool] = None  # None => Spark default (asc: first, desc: last)


@dataclass
class WindowFunc:
    func: str                     # rank, dense_rank, row_number, sum, avg, min, max, count
    arg: Optional[BExpr]
    partition_by: list[BExpr]
    order_by: list[SortKey]
    name: str = ""

    @property
    def dtype(self) -> str:
        if self.func in ("rank", "dense_rank", "row_number", "count"):
            return "int"
        if self.func == "avg":
            return "float"
        return self.arg.dtype if self.arg is not None else "int"


# --------------------------------------------------------------------------
# plan nodes — every node exposes `out_names`/`out_dtypes` for its output
# --------------------------------------------------------------------------

@dataclass
class PlanNode:
    out_names: list[str] = field(default_factory=list, kw_only=True)
    out_dtypes: list[str] = field(default_factory=list, kw_only=True)


@dataclass
class ScanNode(PlanNode):
    table: str
    columns: list[str]  # physical columns to read, in output order
    # per-column physical upload lane (device.plan_lanes tags) for packed
    # morsel scans; None = layout decided by the executor (in-core scans).
    # Width metadata so the plan verifier can prove every lane wide enough
    # for its column's value range BEFORE a morsel ships on it.
    lanes: Optional[tuple] = None
    # per-column wire encoding tags ("plain" | ("dict", card) |
    # ("rle", runs_bound), device.plan_encodings) for packed morsel scans;
    # None = all plain. Encoding metadata so the verifier can prove each
    # spec legal against recorded cardinality/run stats (the "encoding"
    # findings), and so program fingerprints include the physical encoding.
    encodings: Optional[tuple] = None


@dataclass
class FilterNode(PlanNode):
    child: PlanNode
    predicate: BExpr


@dataclass
class ProjectNode(PlanNode):
    child: PlanNode
    exprs: list[BExpr]


@dataclass
class JoinNode(PlanNode):
    left: PlanNode
    right: PlanNode
    kind: str                 # inner, left, right, full, cross, semi, anti
    left_keys: list[BExpr] = field(default_factory=list)
    right_keys: list[BExpr] = field(default_factory=list)
    residual: Optional[BExpr] = None  # extra non-equi condition, over combined schema
    null_aware: bool = False  # NOT IN semantics for anti joins
    # late materialization (planner._late_materialization): this join gathers
    # dimension attributes AFTER aggregation against a unique-key build side.
    # The flag is an annotation (execution is a plain inner join); it blocks
    # re-application of the rewrite and makes rewritten plans inspectable.
    late_mat: bool = False


@dataclass
class AggregateNode(PlanNode):
    child: PlanNode
    group_exprs: list[BExpr] = field(default_factory=list)
    aggs: list[AggSpec] = field(default_factory=list)
    rollup: bool = False
    # compile segmentation may split a rollup into per-level units: an
    # explicit subset of rollup prefix lengths to emit (None = all levels
    # when rollup, else just the full grouping)
    rollup_levels: Optional[list[int]] = None
    # output: group cols, then agg cols, then (if rollup) int col "__grouping_id"


@dataclass
class WindowNode(PlanNode):
    child: PlanNode
    funcs: list[WindowFunc] = field(default_factory=list)
    # output: child cols, then one col per window func


@dataclass
class SortNode(PlanNode):
    child: PlanNode
    keys: list[SortKey] = field(default_factory=list)


@dataclass
class LimitNode(PlanNode):
    child: PlanNode
    n: int = 0


@dataclass
class DistinctNode(PlanNode):
    child: PlanNode


@dataclass
class SetOpNode(PlanNode):
    op: str    # union, intersect, except
    all: bool
    left: PlanNode
    right: PlanNode


@dataclass
class MaterializedNode(PlanNode):
    """An already-computed table injected into the plan (CTE results, views)."""
    table: object  # engine.column.Table
    label: str = ""


@dataclass
class VirtualScanNode(PlanNode):
    """A scan whose table is the output of another compile unit (a segmented
    CTE): the device executor resolves `key` against its segment cache, so a
    pathologically large plan splits into bounded XLA programs that hand
    device-resident tables to each other (reference analog: Spark reuses one
    compiled plan per query and materializes nothing, nds/nds_power.py:124-134
    — here bounded compile time requires the cut)."""
    key: str
    label: str = ""


def column_view(child: PlanNode, indices: list[int], out_names: list[str],
                out_dtypes: list[str]) -> "ProjectNode":
    """A pure column-selection projection over `child` (BCol references
    only): both executors evaluate it as column picking with no data
    movement — inside a compiled device program the selection fuses away
    entirely. Shared-scan morsel fusion builds these to hand each branch
    its pruned subset of the staged union-column buffer as zero-copy
    views."""
    return ProjectNode(
        child,
        [BCol(child.out_dtypes[i], i, n)
         for i, n in zip(indices, out_names)],
        out_names=list(out_names), out_dtypes=list(out_dtypes))


def walk(node: PlanNode):
    """Pre-order traversal of the child/left/right plan structure, memoized
    on node identity: a shared subtree (CTE DAG) yields ONCE, so traversal
    is linear in the number of distinct nodes instead of exponential in the
    sharing depth (a q14-class WITH clause consumed k times at d nesting
    levels would otherwise expand k^d visits)."""
    seen: set[int] = set()
    stack: list[PlanNode] = [node]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        yield n
        # push right-to-left so pre-order (child first) is preserved
        for f in ("right", "left", "child"):
            sub = getattr(n, f, None)
            if isinstance(sub, PlanNode):
                stack.append(sub)


_FIELD_CACHE: dict[type, tuple] = {}


def type_fields(x) -> tuple:
    """Dataclass field names of x's type, cached per type (dataclasses.
    fields() re-resolves per call; plan traversal is hot enough to care)."""
    import dataclasses as _dc

    t = type(x)
    names = _FIELD_CACHE.get(t)
    if names is None:
        names = tuple(f.name for f in _dc.fields(t))
        _FIELD_CACHE[t] = names
    return names


def iter_plan_nodes(root: PlanNode):
    """Every distinct PlanNode reachable from `root`, INCLUDING plans embedded
    in expressions (BScalarSubquery) — shared nodes (CTE DAG) yield once.
    Traversal memoizes on object identity for EVERY dataclass (plan nodes
    and expression trees alike), so shared-DAG plans walk in linear time."""
    import dataclasses as _dc

    seen: set[int] = set()
    stack: list = [root]
    while stack:
        x = stack.pop()
        if isinstance(x, PlanNode):
            if id(x) in seen:
                continue
            seen.add(id(x))
            yield x
            if isinstance(x, MaterializedNode):
                continue      # its Table payload holds no plan nodes
        elif isinstance(x, (BCol, BLit, BParam)):
            continue          # leaf expressions hold no plan nodes
        if _dc.is_dataclass(x) and not isinstance(x, type):
            if not isinstance(x, PlanNode):
                if id(x) in seen:
                    continue
                seen.add(id(x))
            for name in type_fields(x):
                v = getattr(x, name)
                if v is not None and not isinstance(v, (str, int, float,
                                                        bool)):
                    stack.append(v)
        elif isinstance(x, (list, tuple)):
            stack.extend(v for v in x
                         if v is not None and
                         not isinstance(v, (str, int, float, bool)))


# ops whose handlers consume literal arguments as traced device scalars —
# a literal under any OTHER op (substr positions, LIKE patterns, cast
# payloads, string work) may be read on the host at trace time and must
# stay baked into the program
_PARAM_SAFE_OPS = frozenset({
    "add", "sub", "mul", "div", "mod", "neg", "eq", "ne", "lt", "le", "gt",
    "ge", "and", "or", "not", "case", "coalesce", "nullif", "in_list", "abs",
})


def _param_hoistable(lit: "BLit") -> bool:
    return lit.value is not None and (
        lit.dtype in ("int", "float", "date", "bool")
        or lit.dtype.startswith("dec"))


def parameterize_plan(root: PlanNode) -> tuple[PlanNode, list, list]:
    """Hoist numeric/date/decimal/bool literals into parameter slots.

    Returns (rewritten plan, values, dtypes): every hoisted BLit becomes a
    BParam(index) and its value/dtype land at that index. Only
    literals in _PARAM_SAFE_OPS argument positions hoist; traversal order
    is deterministic, so two stream-instantiations of one template yield
    THE SAME rewritten plan with different `values` — and therefore the
    same compiled program (see BParam). Node sharing (CTE DAGs) is
    preserved."""
    import dataclasses as _dc

    values: list = []
    dtypes: list = []
    memo: dict[int, object] = {}

    def rw_expr(e, safe_parent: bool):
        if isinstance(e, BLit):
            if safe_parent and _param_hoistable(e):
                values.append(e.value)
                dtypes.append(e.dtype)
                return BParam(e.dtype, index=len(values) - 1)
            return e
        if isinstance(e, BCall):
            safe = e.op in _PARAM_SAFE_OPS
            args = [rw_expr(a, safe) for a in e.args]
            extra = e.extra
            # IN-list values ride in `extra` as a host list; int/date items
            # hoist as params (the device handler resolves BParam entries)
            if e.op == "in_list" and isinstance(extra, list) and \
                    args and args[0].dtype in ("int", "date"):
                new_extra = []
                for v in extra:
                    # only EXACT ints hoist against an int/date probe: a
                    # non-integral item (1.5) matches nothing under float
                    # promotion, but an int-dtype param cast would truncate
                    # it into a spurious match
                    if isinstance(v, bool) or not isinstance(v, int):
                        new_extra.append(v)
                    else:
                        values.append(v)
                        dtypes.append(args[0].dtype)
                        new_extra.append(BParam(args[0].dtype,
                                                index=len(values) - 1))
                if any(isinstance(v, BParam) for v in new_extra):
                    extra = new_extra
            if extra is e.extra and all(
                    a is b for a, b in zip(args, e.args)):
                return e
            return _dc.replace(e, args=args, extra=extra)
        if isinstance(e, BScalarSubquery):
            p = rw_plan(e.plan)
            return e if p is e.plan else _dc.replace(e, plan=p)
        return e

    def rw_other(x):
        if isinstance(x, BExpr):
            return rw_expr(x, False)
        if isinstance(x, list):
            out = [rw_other(v) for v in x]
            return out if any(a is not b for a, b in zip(out, x)) else x
        if isinstance(x, tuple):
            out = tuple(rw_other(v) for v in x)
            return out if any(a is not b for a, b in zip(out, x)) else x
        if _dc.is_dataclass(x) and not isinstance(x, type) \
                and not isinstance(x, PlanNode):
            changes = {}
            for f in _dc.fields(x):
                v = getattr(x, f.name)
                nv = rw_other(v)
                if nv is not v:
                    changes[f.name] = nv
            return _dc.replace(x, **changes) if changes else x
        return x

    def rw_plan(node):
        if id(node) in memo:
            return memo[id(node)]
        if isinstance(node, MaterializedNode):
            memo[id(node)] = node
            return node
        changes = {}
        for f in _dc.fields(node):
            v = getattr(node, f.name)
            nv = rw_plan(v) if isinstance(v, PlanNode) else rw_other(v)
            if nv is not v:
                changes[f.name] = nv
        out = _dc.replace(node, **changes) if changes else node
        memo[id(node)] = out
        return out

    return rw_plan(root), values, dtypes


def deparameterize_plan(root: PlanNode, values: list) -> PlanNode:
    """Substitute parameter values back as literals (host-fallback plans:
    the numpy expression engine evaluates literals, not parameter slots)."""
    import dataclasses as _dc

    memo: dict[int, object] = {}

    def rw(x):
        if isinstance(x, BParam):
            return BLit(x.dtype, values[x.index])
        if isinstance(x, BCall):
            args = rw(x.args)
            extra = x.extra
            if isinstance(extra, list) and \
                    any(isinstance(v, BParam) for v in extra):
                # in_list extras hold RAW python values, not BLit nodes
                extra = [values[v.index] if isinstance(v, BParam) else v
                         for v in extra]
            if args is x.args and extra is x.extra:
                return x
            return _dc.replace(x, args=args, extra=extra)
        if isinstance(x, MaterializedNode):
            return x
        if _dc.is_dataclass(x) and not isinstance(x, type):
            if id(x) in memo:
                return memo[id(x)]
            changes = {}
            for f in _dc.fields(x):
                v = getattr(x, f.name)
                nv = rw(v)
                if nv is not v:
                    changes[f.name] = nv
            out = _dc.replace(x, **changes) if changes else x
            memo[id(x)] = out
            return out
        if isinstance(x, list):
            out = [rw(v) for v in x]
            return out if any(a is not b for a, b in zip(out, x)) else x
        if isinstance(x, tuple):
            out = tuple(rw(v) for v in x)
            return out if any(a is not b for a, b in zip(out, x)) else x
        return x

    return rw(root)


def replace_plan_nodes(root, mapping: dict):
    """Functionally rewrite a plan DAG, substituting nodes by identity:
    mapping[id(node)] -> replacement. Untouched shared subtrees keep their
    identity (executor memoization still dedupes them); expression-embedded
    plans (BScalarSubquery) are rewritten too."""
    import dataclasses as _dc

    memo: dict[int, object] = {}

    def rw(x):
        if isinstance(x, PlanNode) and id(x) in mapping:
            return mapping[id(x)]
        if isinstance(x, MaterializedNode):
            return x          # leaf: its Table payload holds no plan nodes
        if _dc.is_dataclass(x) and not isinstance(x, type):
            if id(x) in memo:
                return memo[id(x)]
            changes = {}
            for f in _dc.fields(x):
                v = getattr(x, f.name)
                nv = rw(v)
                if nv is not v:
                    changes[f.name] = nv
            out = _dc.replace(x, **changes) if changes else x
            memo[id(x)] = out
            return out
        if isinstance(x, list):
            nl = [rw(e) for e in x]
            return nl if any(a is not b for a, b in zip(nl, x)) else x
        if isinstance(x, tuple):
            nt = tuple(rw(e) for e in x)
            return nt if any(a is not b for a, b in zip(nt, x)) else x
        return x

    return rw(root)
