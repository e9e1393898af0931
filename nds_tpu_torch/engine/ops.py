# Copied from nds_tpu/engine/ops.py; only import paths changed.
"""Relational operators over columnar Tables.

Execution model: the host does *shape discovery* — group factorization, join
match counting — while bulk compute (segment reductions, gathers, sorts) is
vectorized array math. This is the TPU-first split: every kernel here is
expressible as fixed-shape XLA ops once sizes are known, which is how the
jitted fast-path (nds_tpu.engine.kernels) compiles the same operators; the
numpy forms below are the reference semantics and CPU fallback.

Capability parity targets: the scan/filter/project/join/agg/sort pipeline the
reference runs through Spark SQL + RAPIDS (reference nds_power.py:124-134 is
`spark.sql(query).collect()`; the plugin's columnar ops are the analog here).
"""
from __future__ import annotations

import numpy as np

from .column import (Column, Table, concat_columns, dec_scale, is_dec,
                     merge_dictionaries)
from .plan import AggSpec, SortKey, WindowFunc

_I64_NULL = np.int64(np.iinfo(np.int64).min + 1)


# --------------------------------------------------------------------------
# key normalization & factorization
# --------------------------------------------------------------------------

def key_array(col: Column) -> np.ndarray:
    """int64 representation of a column for grouping/joining; nulls -> sentinel."""
    data = np.asarray(col.data)
    if col.dtype == "float":
        # total order via IEEE bit flip (handles -0.0 == 0.0 by normalizing)
        d = data.astype(np.float64)
        d = np.where(d == 0.0, 0.0, d)
        bits = d.view(np.int64)
        out = np.where(bits < 0, np.int64(np.iinfo(np.int64).min) - bits, bits)
    else:
        out = data.astype(np.int64)
    if col.valid is not None:
        out = np.where(col.valid, out, _I64_NULL)
    return out


def _row_view(arrays: list[np.ndarray]) -> np.ndarray:
    """Pack parallel int64 arrays into one void array for row-wise unique."""
    stacked = np.ascontiguousarray(np.stack(arrays, axis=1))
    return stacked.view([("", np.int64)] * len(arrays)).ravel()


def factorize(key_cols: list[Column], pre_keys: list[np.ndarray] | None = None
              ) -> tuple[np.ndarray, np.ndarray, int]:
    """Assign dense group ids for the given key columns.

    Returns (group_ids[n], first_row_index[ngroups], ngroups); group ids are
    ordered by sorted key value, making output deterministic.
    """
    arrays = pre_keys if pre_keys is not None else [key_array(c) for c in key_cols]
    if not arrays:
        raise ValueError("factorize with no keys")
    n = len(arrays[0])
    if n == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64), 0
    if len(arrays) == 1:
        uniq, first, inverse = np.unique(arrays[0], return_index=True,
                                         return_inverse=True)
    else:
        rows = _row_view(arrays)
        uniq, first, inverse = np.unique(rows, return_index=True,
                                         return_inverse=True)
    return inverse.astype(np.int64), first.astype(np.int64), len(uniq)


def take_with_null(col: Column, indices: np.ndarray) -> Column:
    """Gather; negative indices produce NULL (outer-join fill).

    A zero-row source is legal (outer join against an empty build side:
    every index is -1) — clip would index into nothing, so gather from a
    one-null-row extension instead."""
    if len(col.data) == 0 and len(indices):
        col = Column(col.dtype, np.zeros(1, dtype=np.asarray(col.data).dtype),
                     np.zeros(1, dtype=bool), col.dictionary)
    safe = np.where(indices >= 0, indices, 0)
    out = col.take(safe)
    miss = indices < 0
    if miss.any():
        return out.with_valid(out.validity & ~miss)
    return out


# --------------------------------------------------------------------------
# filter / project / limit / distinct
# --------------------------------------------------------------------------

def filter_table(table: Table, mask_col: Column) -> Table:
    mask = np.asarray(mask_col.data, dtype=bool) & mask_col.validity
    idx = np.nonzero(mask)[0]
    return table.take(idx)


def distinct(table: Table) -> Table:
    if table.num_rows == 0 or not table.columns:
        return table
    _, first, _ = factorize(list(table.columns))
    return table.take(np.sort(first))


# --------------------------------------------------------------------------
# sort
# --------------------------------------------------------------------------

def sort_indices(key_cols: list[Column], keys: list[SortKey]) -> np.ndarray:
    """Spark ordering: asc => NULLS FIRST, desc => NULLS LAST (overridable)."""
    columns = []
    for col, k in zip(key_cols, keys):
        if col.dtype == "str":
            arr = _string_rank_keys(col)
        else:
            arr = key_array(col)
        nulls_first = k.nulls_first if k.nulls_first is not None else k.asc
        null_key = np.iinfo(np.int64).min if nulls_first else np.iinfo(np.int64).max
        if not k.asc:
            arr = -arr  # flip order; null placement applied after
        if col.valid is not None:
            arr = np.where(col.valid, arr, null_key)
        columns.append(arr)
    # lexsort: last key is primary
    return np.lexsort(columns[::-1]) if columns else np.arange(0)


def _string_rank_keys(col: Column) -> np.ndarray:
    d = col.dictionary
    if d is None or len(d) == 0:
        return np.zeros(len(col), dtype=np.int64)
    order = np.argsort(d.astype(str), kind="stable")
    ranks = np.empty(len(d), dtype=np.int64)
    ranks[order] = np.arange(len(d))
    codes = np.asarray(col.data)
    return ranks[np.where(codes >= 0, codes, 0)]


def sort_table(table: Table, key_cols: list[Column], keys: list[SortKey]) -> Table:
    if table.num_rows <= 1:
        return table
    return table.take(sort_indices(key_cols, keys))


# --------------------------------------------------------------------------
# aggregation
# --------------------------------------------------------------------------

def _segment_sum(values: np.ndarray, valid: np.ndarray, gid: np.ndarray,
                 ngroups: int) -> tuple[np.ndarray, np.ndarray]:
    w = np.where(valid, values, 0)
    if np.issubdtype(values.dtype, np.floating):
        sums = np.bincount(gid, weights=w, minlength=ngroups)
    else:
        sums = np.zeros(ngroups, dtype=np.int64)
        np.add.at(sums, gid, w.astype(np.int64))
    counts = np.bincount(gid[valid], minlength=ngroups)
    return sums, counts


def _segment_minmax(values: np.ndarray, valid: np.ndarray, gid: np.ndarray,
                    ngroups: int, is_min: bool) -> tuple[np.ndarray, np.ndarray]:
    if np.issubdtype(values.dtype, np.floating):
        init = np.inf if is_min else -np.inf
        out = np.full(ngroups, init, dtype=np.float64)
        fn = np.minimum if is_min else np.maximum
        fn.at(out, gid[valid], values[valid].astype(np.float64))
    else:
        init = np.iinfo(np.int64).max if is_min else np.iinfo(np.int64).min
        out = np.full(ngroups, init, dtype=np.int64)
        fn = np.minimum if is_min else np.maximum
        fn.at(out, gid[valid], values[valid].astype(np.int64))
    counts = np.bincount(gid[valid], minlength=ngroups)
    return out, counts


def _distinct_pairs(gid: np.ndarray, col: Column) -> tuple[np.ndarray, np.ndarray]:
    """(group_id, first_row_idx) of distinct valid (group, value) pairs."""
    valid = col.validity
    rows = np.nonzero(valid)[0]
    keys = key_array(col)[rows]
    pair_view = _row_view([gid[rows], keys])
    _, first = np.unique(pair_view, return_index=True)
    return gid[rows[first]], rows[first]


def compute_agg(spec: AggSpec, arg: Column | None, gid: np.ndarray,
                ngroups: int, total_rows: int) -> Column:
    if spec.func == "count_star":
        return Column.from_values("int", np.bincount(gid, minlength=ngroups))
    assert arg is not None
    values = np.asarray(arg.data)
    valid = arg.validity
    if spec.distinct:
        if spec.func == "count":
            dgid, _ = _distinct_pairs(gid, arg)
            return Column.from_values("int", np.bincount(dgid, minlength=ngroups))
        dgid, rows = _distinct_pairs(gid, arg)
        gid, values, valid = dgid, values[rows], np.ones(len(rows), dtype=bool)
    if spec.func == "count":
        return Column.from_values("int", np.bincount(gid[valid], minlength=ngroups))
    if spec.func in ("sum", "avg"):
        sums, counts = _segment_sum(values, valid, gid, ngroups)
        if spec.func == "sum":
            # decimal sums stay exact scaled int64 (the TPU decimal story);
            # float stays float, everything else sums as int
            dtype = arg.dtype if arg.dtype == "float" or is_dec(arg.dtype) \
                else "int"
            return Column.from_values(dtype, sums, counts > 0)
        with np.errstate(invalid="ignore"):
            avg = sums / np.maximum(counts, 1)
        if is_dec(arg.dtype):
            avg = avg / 10.0 ** dec_scale(arg.dtype)
        return Column.from_values("float", avg, counts > 0)
    if spec.func in ("min", "max"):
        out, counts = _segment_minmax(values, valid, gid, ngroups,
                                      spec.func == "min")
        if arg.dtype == "str":
            # min/max over dictionary ranks, then map back to codes
            raise NotImplementedError("min/max over strings handled in aggregate()")
        return Column.from_values(arg.dtype, out.astype(values.dtype), counts > 0)
    if spec.func == "stddev_samp":
        v = values.astype(np.float64)
        if is_dec(arg.dtype):
            v = v / 10.0 ** dec_scale(arg.dtype)
        sums, counts = _segment_sum(v, valid, gid, ngroups)
        sq, _ = _segment_sum(v * v, valid, gid, ngroups)
        cnt = counts.astype(np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            var = (sq - sums * sums / np.maximum(cnt, 1)) / np.maximum(cnt - 1, 1)
        return Column.from_values("float", np.sqrt(np.maximum(var, 0)), counts > 1)
    raise NotImplementedError(f"aggregate {spec.func}")


def _agg_string_minmax(spec: AggSpec, arg: Column, gid: np.ndarray,
                       ngroups: int) -> Column:
    ranks = _string_rank_keys(arg)
    valid = arg.validity
    init = np.iinfo(np.int64).max if spec.func == "min" else np.iinfo(np.int64).min
    out = np.full(ngroups, init, dtype=np.int64)
    fn = np.minimum if spec.func == "min" else np.maximum
    fn.at(out, gid[valid], ranks[valid])
    counts = np.bincount(gid[valid], minlength=ngroups)
    # rank -> code lookup
    d = arg.dictionary if arg.dictionary is not None else np.empty(0, dtype=object)
    order = np.argsort(d.astype(str), kind="stable") if len(d) else np.empty(0, np.int64)
    safe = np.where((out >= 0) & (out < len(order)), out, 0)
    codes = order[safe].astype(np.int32) if len(order) else np.zeros(ngroups, np.int32)
    return Column.from_values("str", codes, counts > 0, d)


def aggregate(table: Table, group_cols: list[Column], aggs: list[AggSpec],
              agg_args: list[Column | None], rollup: bool = False,
              levels: list[int] | None = None
              ) -> tuple[list[Column], list[Column], Column | None]:
    """Grouped aggregation.

    Returns (group_out_cols, agg_out_cols, grouping_id_col or None).
    With rollup=True, emits one block per rollup level, null-filling rolled-up
    keys, with a Spark-compatible grouping-id bitmask column. `levels` (an
    explicit subset of rollup prefix lengths) supports per-level compile
    segmentation of big rollups.
    """
    if levels is None:
        levels = [len(group_cols)]
        if rollup:
            levels = list(range(len(group_cols), -1, -1))
    blocks: list[tuple[list[Column], list[Column], int]] = []
    for lvl in levels:
        keys = group_cols[:lvl]
        if keys:
            gid, first, ngroups = factorize(keys)
        else:
            # global aggregate: one group even over zero rows (SQL semantics)
            gid = np.zeros(table.num_rows, dtype=np.int64)
            first = np.zeros(1, dtype=np.int64)
            ngroups = 1
        g_out = []
        for i, c in enumerate(group_cols):
            if i < lvl:
                g_out.append(c.take(first) if table.num_rows else _empty_like(c))
            else:
                nn = ngroups
                g_out.append(Column.constant(c.dtype, None, nn, c.dictionary))
        a_out = []
        for spec, arg in zip(aggs, agg_args):
            if table.num_rows == 0 and keys:
                a_out.append(Column.constant(spec.dtype, None, 0))
                continue
            if spec.func in ("min", "max") and arg is not None and arg.dtype == "str":
                a_out.append(_agg_string_minmax(spec, arg, gid, ngroups))
            else:
                a_out.append(compute_agg(spec, arg, gid, ngroups, table.num_rows))
        # grouping id bitmask: bit i set => group expr i rolled up
        gid_mask = sum(1 << (len(group_cols) - 1 - i)
                       for i in range(lvl, len(group_cols)))
        blocks.append((g_out, a_out, gid_mask))
    if len(blocks) == 1:
        g_out, a_out, mask = blocks[0]
        gidc = Column.from_values(
            "int", np.full(len(g_out[0]) if g_out else len(a_out[0]), mask,
                           np.int64)) \
            if rollup else None
        return g_out, a_out, gidc
    g_cat = [concat_columns([b[0][i] for b in blocks])
             for i in range(len(group_cols))]
    a_cat = [concat_columns([b[1][i] for b in blocks]) for i in range(len(aggs))]
    gid_vals = np.concatenate([
        np.full(len(b[0][0]) if b[0] else len(b[1][0]), b[2], dtype=np.int64)
        for b in blocks])
    return g_cat, a_cat, Column.from_values("int", gid_vals)


def _empty_like(c: Column) -> Column:
    return c.take(np.empty(0, dtype=np.int64))


# --------------------------------------------------------------------------
# join
# --------------------------------------------------------------------------

def _joint_keys(left_keys: list[Column], right_keys: list[Column]
                ) -> tuple[np.ndarray, np.ndarray]:
    """Factorize left+right composite keys into one comparable int64 space."""
    nl = len(left_keys[0]) if left_keys else 0
    arrays = []
    for lc, rc in zip(left_keys, right_keys):
        if lc.dtype == "str" or rc.dtype == "str":
            _, (lcodes, rcodes) = merge_dictionaries([lc, rc])
            la = lcodes.astype(np.int64)
            ra = rcodes.astype(np.int64)
            if lc.valid is not None:
                la = np.where(lc.valid, la, _I64_NULL)
            if rc.valid is not None:
                ra = np.where(rc.valid, ra, _I64_NULL)
        else:
            la, ra = key_array(lc), key_array(rc)
        arrays.append(np.concatenate([la, ra]))
    if len(arrays) == 1:
        joint = arrays[0]
    else:
        gid, _, _ = factorize([], pre_keys=arrays)
        joint = gid
    return joint[:nl], joint[nl:]


def _null_key_mask(cols: list[Column]) -> np.ndarray:
    n = len(cols[0]) if cols else 0
    mask = np.zeros(n, dtype=bool)
    for c in cols:
        if c.valid is not None:
            mask |= ~c.valid
    return mask


def join_match(left_keys: list[Column], right_keys: list[Column]
               ) -> tuple[np.ndarray, np.ndarray]:
    """All matching (left_idx, right_idx) pairs for an equi-join (null-safe:
    null keys match nothing). Sort-probe: build on right, probe from left."""
    lk, rk = _joint_keys(left_keys, right_keys)
    lnull = _null_key_mask(left_keys)
    rnull = _null_key_mask(right_keys)
    rvalid_idx = np.nonzero(~rnull)[0]
    rk_valid = rk[rvalid_idx]
    order = np.argsort(rk_valid, kind="stable")
    rk_sorted = rk_valid[order]
    probe_rows = np.nonzero(~lnull)[0]
    pk = lk[probe_rows]
    lo = np.searchsorted(rk_sorted, pk, side="left")
    hi = np.searchsorted(rk_sorted, pk, side="right")
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    # expand [lo, hi) ranges without a python loop
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    flat = np.arange(total) - np.repeat(offsets, counts) + np.repeat(lo, counts)
    right_idx = rvalid_idx[order[flat]]
    left_idx = np.repeat(probe_rows, counts)
    return left_idx, right_idx


def join(left: Table, right: Table, kind: str,
         left_keys: list[Column], right_keys: list[Column],
         residual_eval=None, null_aware: bool = False
         ) -> tuple[Table, np.ndarray, np.ndarray]:
    """Execute a join; returns (combined_table, left_idx, right_idx).

    residual_eval: callable(combined Table) -> Column(bool) applied to matched
    pairs before outer-fill, so non-equi conditions see the matched rows only.
    null_aware: NOT-IN semantics for anti joins — a NULL probe key or any NULL
    build key disqualifies (predicate is NULL, never TRUE).
    """
    # The null-aware branch below tests build-side NULLs BEFORE the residual
    # filter, which is wrong when a residual could exclude the NULL-key build
    # rows; the planner guarantees the combination never reaches us
    # (planner.py _decorrelate raises PlanError for it). A real raise, not an
    # assert: python -O must not silently return wrong NOT IN results if a
    # future planner change re-enables the combination.
    if null_aware and residual_eval is not None:
        raise NotImplementedError(
            "null-aware anti join with residual is unsupported")
    if kind == "cross" or not left_keys:
        # keyless joins (pure theta: residual-only condition) are a filtered
        # cross product
        nl, nr = left.num_rows, right.num_rows
        left_idx = np.repeat(np.arange(nl, dtype=np.int64), nr)
        right_idx = np.tile(np.arange(nr, dtype=np.int64), nl)
    else:
        left_idx, right_idx = join_match(left_keys, right_keys)
    if residual_eval is not None and len(left_idx):
        matched = _combine(left, right, left_idx, right_idx)
        mask_col = residual_eval(matched)
        keep = np.asarray(mask_col.data, dtype=bool) & mask_col.validity
        left_idx, right_idx = left_idx[keep], right_idx[keep]
    if kind in ("inner", "cross"):
        combined = _combine(left, right, left_idx, right_idx)
        return combined, left_idx, right_idx
    if kind == "semi":
        keep = np.unique(left_idx)
        return left.take(keep), keep, np.empty(0, np.int64)
    if kind == "anti":
        matched_mask = np.zeros(left.num_rows, dtype=bool)
        matched_mask[left_idx] = True
        if null_aware:
            if right.num_rows and _null_key_mask(right_keys).any():
                # NOT IN over a set containing NULL: nothing qualifies
                empty = np.empty(0, np.int64)
                return left.take(empty), empty, empty
            matched_mask |= _null_key_mask(left_keys)  # NULL probe: excluded
        keep = np.nonzero(~matched_mask)[0]
        return left.take(keep), keep, np.empty(0, np.int64)
    if kind in ("left", "full"):
        matched = np.zeros(left.num_rows, dtype=bool)
        matched[left_idx] = True
        extra_l = np.nonzero(~matched)[0]
        left_idx = np.concatenate([left_idx, extra_l])
        right_idx = np.concatenate([right_idx,
                                    np.full(len(extra_l), -1, dtype=np.int64)])
    if kind in ("right", "full"):
        matched_r = np.zeros(right.num_rows, dtype=bool)
        matched_r[right_idx[right_idx >= 0]] = True
        extra_r = np.nonzero(~matched_r)[0]
        left_idx = np.concatenate([left_idx,
                                   np.full(len(extra_r), -1, dtype=np.int64)])
        right_idx = np.concatenate([right_idx, extra_r])
    combined = _combine(left, right, left_idx, right_idx)
    return combined, left_idx, right_idx


def _combine(left: Table, right: Table, left_idx: np.ndarray,
             right_idx: np.ndarray) -> Table:
    cols = [take_with_null(c, left_idx) for c in left.columns]
    cols += [take_with_null(c, right_idx) for c in right.columns]
    return Table(left.names + right.names, cols)


# --------------------------------------------------------------------------
# set operations
# --------------------------------------------------------------------------

def _align_set_tables(a: Table, b: Table) -> tuple[Table, Table]:
    """Position-wise align string dictionaries between two set-op inputs."""
    a_cols, b_cols = list(a.columns), list(b.columns)
    for i, (ca, cb) in enumerate(zip(a_cols, b_cols)):
        if ca.dtype == "str" or cb.dtype == "str":
            merged, (codes_a, codes_b) = merge_dictionaries([ca, cb])
            a_cols[i] = Column.from_values("str", codes_a, ca.valid, merged)
            b_cols[i] = Column.from_values("str", codes_b, cb.valid, merged)
    return Table(a.names, a_cols), Table(b.names, b_cols)


def set_op(op: str, all_: bool, left: Table, right: Table) -> Table:
    left, right = _align_set_tables(left, right)
    if op == "union":
        out = Table(left.names,
                    [concat_columns([lc, rc])
                     for lc, rc in zip(left.columns, right.columns)])
        return out if all_ else distinct(out)
    # intersect / except use distinct row semantics (ALL variants unsupported)
    nl = left.num_rows
    both = Table(left.names,
                 [concat_columns([lc, rc])
                  for lc, rc in zip(left.columns, right.columns)])
    gid, first, ngroups = factorize(list(both.columns))
    in_left = np.zeros(ngroups, dtype=bool)
    in_right = np.zeros(ngroups, dtype=bool)
    in_left[gid[:nl]] = True
    in_right[gid[nl:]] = True
    if op == "intersect":
        keep_groups = in_left & in_right
    elif op == "except":
        keep_groups = in_left & ~in_right
    else:
        raise ValueError(op)
    # first occurrence restricted to left rows
    first_left = np.full(ngroups, -1, dtype=np.int64)
    # reverse iterate trick: assign in reverse so first occurrence wins
    left_rows = np.arange(nl - 1, -1, -1, dtype=np.int64)
    first_left[gid[left_rows]] = left_rows
    rows = first_left[keep_groups & (first_left >= 0)]
    return both.take(np.sort(rows))


# --------------------------------------------------------------------------
# window functions
# --------------------------------------------------------------------------

def window(table: Table, funcs: list[WindowFunc],
           part_cols: list[list[Column]], order_cols: list[list[Column]],
           arg_cols: list[Column | None]) -> list[Column]:
    out: list[Column] = []
    n = table.num_rows
    for wf, pcols, ocols, arg in zip(funcs, part_cols, order_cols, arg_cols):
        if n == 0:
            out.append(Column.constant(wf.dtype, None, 0))
            continue
        if pcols:
            gid, _, ngroups = factorize(pcols)
        else:
            gid, ngroups = np.zeros(n, dtype=np.int64), 1
        if not ocols:
            col = _window_whole_partition(wf, arg, gid, ngroups, n)
        else:
            col = _window_ordered(wf, arg, gid, ngroups, ocols, wf.order_by, n)
        out.append(col)
    return out


def _window_whole_partition(wf: WindowFunc, arg: Column | None,
                            gid: np.ndarray, ngroups: int, n: int) -> Column:
    if wf.func in ("rank", "dense_rank", "row_number"):
        raise ValueError(f"{wf.func} requires ORDER BY")
    c = compute_agg(AggSpec(wf.func, None), arg, gid, ngroups, n)
    return c.take(gid)


def _window_ordered(wf: WindowFunc, arg: Column | None, gid: np.ndarray,
                    ngroups: int, ocols: list[Column], okeys: list[SortKey],
                    n: int) -> Column:
    # global order: partition id, then order keys
    part_key = SortKey(expr=None, asc=True)  # type: ignore[arg-type]
    gid_col = Column.from_values("int", gid)
    order = sort_indices([gid_col] + ocols, [part_key] + okeys)
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)
    sgid = gid[order]
    new_part = np.concatenate([[True], sgid[1:] != sgid[:-1]])
    # tie detection among order keys
    tie_key_arrays = [key_array(c) if c.dtype != "str" else _string_rank_keys(c)
                      for c in ocols]
    skeys = [a[order] for a in tie_key_arrays]
    same_as_prev = np.ones(n, dtype=bool)
    for a in skeys:
        same_as_prev[1:] &= a[1:] == a[:-1]
    same_as_prev[0] = False
    same_as_prev &= ~new_part
    pos_in_part = np.arange(n) - np.maximum.accumulate(
        np.where(new_part, np.arange(n), 0))
    if wf.func == "row_number":
        vals = pos_in_part + 1
        return Column.from_values("int", vals[inv])
    if wf.func == "rank":
        # rank = 1 + offset of the tie-run's first row within its partition
        run_start = np.maximum.accumulate(np.where(~same_as_prev, np.arange(n), 0))
        part_start = np.maximum.accumulate(np.where(new_part, np.arange(n), 0))
        vals = run_start - part_start + 1
        return Column.from_values("int", vals[inv])
    if wf.func == "dense_rank":
        bump = (~same_as_prev) & ~new_part
        dens = np.cumsum(bump) - np.maximum.accumulate(
            np.where(new_part, np.cumsum(bump), 0)) + 1
        return Column.from_values("int", dens[inv])
    # cumulative aggregates with RANGE semantics (ties share the value)
    assert arg is not None or wf.func == "count_star"
    if wf.func == "count_star":
        vals = (pos_in_part + 1).astype(np.float64)
        run = _spread_ties_last(vals, same_as_prev)
        return Column.from_values("int", run[inv].astype(np.int64))
    data = np.asarray(arg.data, dtype=np.float64)[order]
    valid = arg.validity[order]
    w = np.where(valid, data, 0.0)
    csum = np.cumsum(w)
    # running sum within partition: subtract the cumsum just before the partition
    base = _segment_base(csum - w, new_part)
    run_sum = csum - base
    ccount = np.cumsum(valid.astype(np.int64)).astype(np.float64)
    run_count = ccount - _segment_base(ccount - valid, new_part)
    if wf.func in ("sum", "avg"):
        run_sum = _spread_ties_last(run_sum, same_as_prev)
        run_count = _spread_ties_last(run_count, same_as_prev)
        if wf.func == "sum":
            # dec window sums cumulate scaled ints in f64 (exact < 2^53)
            dtype = "float" if arg.dtype == "float" else \
                arg.dtype if is_dec(arg.dtype) else "int"
            vals = run_sum if dtype == "float" else run_sum.astype(np.int64)
            return Column.from_values(dtype, vals[inv], (run_count > 0)[inv])
        with np.errstate(invalid="ignore"):
            res = run_sum / np.maximum(run_count, 1)
        if is_dec(arg.dtype):
            res = res / 10.0 ** dec_scale(arg.dtype)
        return Column.from_values("float", res[inv], (run_count > 0)[inv])
    if wf.func in ("min", "max"):
        fn = np.minimum if wf.func == "min" else np.maximum
        init = np.inf if wf.func == "min" else -np.inf
        vals = np.where(valid, data, init)
        out = _segmented_accumulate(vals, new_part, fn)
        out = _spread_ties_last(out, same_as_prev)
        dtype = arg.dtype if arg.dtype in ("int", "float", "date") \
            or is_dec(arg.dtype) else "float"
        cast = out if dtype == "float" else out.astype(np.int64)
        return Column.from_values(dtype, cast[inv], (run_count > 0)[inv])
    raise NotImplementedError(f"window {wf.func}")


def _segment_base(cum_before: np.ndarray, new_part: np.ndarray) -> np.ndarray:
    """Per-row value of `cum_before` at the row's partition start."""
    n = len(cum_before)
    starts = np.nonzero(new_part)[0]
    seg_id = np.cumsum(new_part) - 1
    return cum_before[starts][seg_id]


def _segmented_accumulate(vals, new_part, fn):
    """Cumulative fn within each partition (loop over partitions, not rows)."""
    out = vals.copy()
    n = len(vals)
    starts = np.nonzero(new_part)[0]
    ends = np.append(starts[1:], n)
    for s, e in zip(starts, ends):
        out[s:e] = fn.accumulate(vals[s:e])
    return out


def _spread_ties_last(vals: np.ndarray, same_as_prev: np.ndarray) -> np.ndarray:
    """RANGE frames: every row of a tie run takes the run's last value."""
    n = len(vals)
    if n == 0:
        return vals
    run_id = np.cumsum(~same_as_prev) - 1
    nruns = run_id[-1] + 1
    last = np.zeros(nruns, dtype=vals.dtype)
    last[run_id] = vals  # later rows overwrite -> last of run
    return last[run_id]
