"""Relational kernels over padded device tensors with alive-row masks.

Counterpart of ``nds_tpu/engine/jax_backend/kernels.py``, in the same
design: grouping and joins are sort-based (multi-column keys reduce to a
dense group id), nulls ride as validity masks, null payload slots hold
canonical zeros, and gids/permutations are int32. Each function computes
what its reference counterpart computes, bit for bit on integer data.

Dispatch seams: ``_sort1``, ``gather_many``, ``_seg_multi`` and ``_seg``
send fact-scale work to the hand-written CUDA kernels (cuda_kernels) when
their family is active for the executing plan, behind the same row gates
as the reference's Pallas seams; everything else is plain torch code.
"""
from __future__ import annotations

import torch

from . import cuda_kernels as _ck

_I32 = torch.int32
_I64 = torch.int64
_F64 = torch.float64


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=_I32, device=device)


def _changed(k: torch.Tensor) -> torch.Tensor:
    """Row i differs from row i-1 (row 0 always counts as changed)."""
    out = torch.ones(k.shape[0], dtype=torch.bool, device=k.device)
    out[1:] = k[1:] != k[:-1]
    return out


def _cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x.to(_I32), 0, dtype=_I32)


def _sort_keyable(k: torch.Tensor) -> torch.Tensor:
    return k.to(_I32) if k.dtype == torch.bool else k


def lexsort(keys: list) -> torch.Tensor:
    """Stable permutation ordering rows lexicographically by ``keys`` (first
    key most significant): the multi-operand stable sort of the reference,
    as successive stable sorts from the least significant key."""
    n = int(keys[0].shape[0])
    perm = _iota(n, keys[0].device).long()
    for k in reversed(keys):
        order = torch.argsort(_sort_keyable(k)[perm], stable=True)
        perm = perm[order]
    return perm.to(_I32)


# ---------------------------------------------------------------------------
# CUDA kernel dispatch seams
# ---------------------------------------------------------------------------

def _sort1(key: torch.Tensor, idx: torch.Tensor):
    """Single-integer-key stable sort carrying an ascending payload (every
    caller passes an iota): the sort kernel for fact-scale arrays
    (SORT_MIN_ROWS), else a stable torch sort. Both return identical
    bits."""
    if int(key.shape[0]) >= _ck.SORT_MIN_ROWS and _ck.op_active("sort"):
        return _ck.sort_pairs(key, idx, idx_ascending=True)
    skey, order = torch.sort(key, stable=True)
    return skey, idx[order]


def gather_many(arrays: list, idx: torch.Tensor) -> list:
    """Batched same-index gather with JAX index semantics: one gather-kernel
    launch over all columns for fact-scale index vectors, else per-column
    torch gathers."""
    if int(idx.shape[0]) >= _ck.GATHER_MIN_ROWS and _ck.op_active("gather"):
        return _ck.take_many(list(arrays), idx.to(_I32))
    return [_ck.take_plain(a, idx) for a in arrays]


def _seg_multi(pairs: list, gid: torch.Tensor, num_segments: int) -> list:
    """Several segment reductions over ONE gid vector: every eligible
    operand rides one fused group-by kernel launch, the rest reduce one by
    one."""
    out: list = [None] * len(pairs)
    if int(gid.shape[0]) >= _ck.GROUPBY_MIN_ROWS and \
            _ck.op_active("groupby"):
        fused = [i for i, (d, op) in enumerate(pairs)
                 if _ck.seg_supported(d, num_segments, op)]
        if fused:
            res = _ck.seg_reduce_multi([pairs[i] for i in fused],
                                       gid.to(_I32), num_segments)
            for i, r in zip(fused, res):
                out[i] = r
    for i, (d, op) in enumerate(pairs):
        if out[i] is None:
            out[i] = _seg(d, gid, num_segments, op)
    return out


def _seg(data: torch.Tensor, gid: torch.Tensor, num_segments: int,
         op: str) -> torch.Tensor:
    if int(gid.shape[0]) >= _ck.GROUPBY_MIN_ROWS and \
            _ck.op_active("groupby") and \
            _ck.seg_supported(data, num_segments, op):
        return _ck.seg_reduce_multi([(data, op)], gid.to(_I32),
                                    num_segments)[0]
    return _ck.seg_reduce_plain(data, gid, num_segments, op)


# ---------------------------------------------------------------------------
# factorize: joint dense ranking of key tuples
# ---------------------------------------------------------------------------

def dense_rank(key_data: list, key_valid: list, alive: torch.Tensor):
    """Assign each alive row a dense group id over its key tuple.

    Returns (gid, num_groups): gid in [0, num_groups) for alive rows and
    == capacity (sentinel segment) for dead rows. Groups are numbered in
    key order (values ascending, nulls last per key)."""
    n = int(alive.shape[0])
    dev = alive.device
    if not key_data:
        gid = torch.where(alive, 0, n).to(_I32)
        return gid, alive.any().to(_I32)
    operands = [(~alive).to(_I32)]
    for d, v in zip(key_data, key_valid):
        operands.append((~v).to(_I32))
        operands.append(torch.where(v & alive, d, torch.zeros_like(d)))
    perm = lexsort(operands)
    p = perm.long()
    alive_sorted = operands[0][p] == 0
    diff = torch.zeros(n, dtype=torch.bool, device=dev)
    for k in operands[1:]:
        diff = diff | _changed(k[p])
    new_group = diff & alive_sorted
    # the first alive row must open a group even if `diff` missed it
    prev_dead = torch.ones(n, dtype=torch.bool, device=dev)
    prev_dead[1:] = ~alive_sorted[:-1]
    new_group = new_group | (alive_sorted & prev_dead)
    return _gid_from_sorted(new_group, alive_sorted, perm, n)


def unscatter(perm: torch.Tensor, values: tuple) -> tuple:
    """Undo a permutation: with the sort kernel active, sort (perm, iota)
    to get the inverse permutation and gather the payloads through it;
    otherwise scatter them back. perm's values are distinct, so both forms
    are bit-identical."""
    n = int(perm.shape[0])
    if n >= _ck.SORT_MIN_ROWS and _ck.op_active("sort"):
        _, inv = _ck.sort_pairs(perm.to(_I32), _iota(n, perm.device),
                                idx_ascending=True)
        return tuple(gather_many(list(values), inv))
    p = perm.long()
    out = []
    for v in values:
        o = torch.empty_like(v)
        o[p] = v
        out.append(o)
    return tuple(out)


def _gid_from_sorted(new_group, alive_sorted, perm, n: int):
    """Shared sorted->gid suffix: cumsum group opens, unscatter back through
    the permutation (dead rows hold the `n` sentinel)."""
    gid_sorted = _cumsum_i32(new_group) - 1
    num_groups = torch.where(alive_sorted, gid_sorted, -1).max() + 1
    (gid,) = unscatter(perm, (torch.where(alive_sorted, gid_sorted,
                                          n).to(_I32),))
    return gid, num_groups


# ---------------------------------------------------------------------------
# packed single-key tier: when every key is integer-typed and the mixed-
# radix domain product fits int64, the key tuple packs into ONE integer and
# a single-key sort replaces the multi-operand one. Groups come out in the
# same order (values ascending, nulls last per key), so gids are identical.
# ---------------------------------------------------------------------------

_PACK_CAP = 1 << 62


def _iinfo(dtype):
    return torch.iinfo(dtype)


def _key_ranges(key_data: list, key_valid: list, alive: torch.Tensor):
    """Per-key runtime (norm, range, ok): norm in [0, range) with values
    mapped order-preserving to [0, span] and NULL to span+1 (nulls last).
    ok guards span overflow (a wrapped difference makes the key
    ineligible). Ranges are 0-d int64 tensors."""
    norms, ranges, oks = [], [], []
    for d, v in zip(key_data, key_valid):
        contrib = alive & v
        cnt = contrib.sum()
        info = _iinfo(d.dtype)
        m = torch.where(contrib, d, info.max).min()
        mx = torch.where(contrib, d, info.min).max()
        span = torch.where(cnt > 0, mx - m, torch.full_like(mx, -1))
        ok = (cnt == 0) | (span >= 0)          # wrapped diff => negative
        span = torch.clamp(span, min=-1)
        norm = torch.where(v, torch.minimum(torch.clamp(d - m, min=0), span),
                           span + 1)
        norms.append(norm)
        ranges.append((span + 2).to(_I64))
        oks.append(ok)
    return norms, ranges, oks


def _sat_product(ranges: list, cap: int) -> torch.Tensor:
    """Product of ranges, saturated at cap+1 without overflow."""
    p = torch.ones((), dtype=_I64, device=ranges[0].device)
    for r in ranges:
        rc = torch.clamp(r, max=cap + 1)
        p = torch.where(p > cap // rc, torch.full_like(p, cap + 1), p * rc)
    return p


def group_tier(key_data: list, key_valid: list, alive) -> torch.Tensor:
    """1 = the key tuple packs into one integer (single-key sort), 0 = the
    generic multi-operand sort."""
    _, ranges, oks = _key_ranges(key_data, key_valid, alive)
    ok = torch.ones((), dtype=torch.bool, device=alive.device)
    for o in oks:
        ok = ok & o
    p_pack = _sat_product(ranges, _PACK_CAP)
    return (ok & (p_pack <= _PACK_CAP)).to(_I32)


def pack_keys(norms: list, ranges: list, n: int, device) -> torch.Tensor:
    """Mixed-radix packed int64 key per row (caller guarantees the domain
    fits)."""
    c = torch.zeros(n, dtype=_I64, device=device)
    for norm, r in zip(norms, ranges):
        c = c * r + norm.to(_I64)
    return c


def dense_rank_packsort(key_data: list, key_valid: list,
                        alive: torch.Tensor):
    """Tier-2 dense_rank: single packed-key sort (one operand vs 2K+2)."""
    n = int(alive.shape[0])
    norms, ranges, _ = _key_ranges(key_data, key_valid, alive)
    c = pack_keys(norms, ranges, n, alive.device)
    key = torch.where(alive, c, _iinfo(_I64).max)
    skey, perm = _sort1(key, _iota(n, alive.device))
    alive_s = alive[perm.long()]
    new_group = alive_s & _changed(skey)
    return _gid_from_sorted(new_group, alive_s, perm, n)


# ---------------------------------------------------------------------------
# filter / compact / limit
# ---------------------------------------------------------------------------

def filter_alive(alive, mask_data, mask_valid) -> torch.Tensor:
    return alive & mask_data.to(torch.bool) & mask_valid


def compaction_perm(alive: torch.Tensor):
    """Stable permutation bringing alive rows to the front; returns
    (perm, count). Entries past `count` are dead-row indices."""
    n = int(alive.shape[0])
    _, perm = _sort1((~alive).to(_I32), _iota(n, alive.device))
    return perm, alive.sum()


def limit_alive(alive: torch.Tensor, n_keep: int) -> torch.Tensor:
    """Keep the first `n_keep` alive rows in physical order."""
    pos = _cumsum_i32(alive) - 1
    return alive & (pos < n_keep)


# ---------------------------------------------------------------------------
# sort
# ---------------------------------------------------------------------------

def sort_perm(key_data: list, key_valid: list, key_specs: tuple,
              alive: torch.Tensor) -> torch.Tensor:
    """Permutation realizing Spark ORDER BY semantics; dead rows go last.
    key_specs: (asc, nulls_first) per key (nulls_first None => asc nulls
    first, desc nulls last)."""
    operands = [(~alive).to(_I32)]
    for col, valid, (asc, nulls_first) in zip(key_data, key_valid,
                                              key_specs):
        if nulls_first is None:
            nulls_first = asc
        # null rank: 0 => before values, 2 => after values; values rank 1
        operands.append(torch.where(valid, 1, 0 if nulls_first else 2)
                        .to(_I32))
        d = torch.where(valid & alive, col, torch.zeros_like(col))
        if not asc:
            d = (~d) if d.dtype == torch.bool else -d
        operands.append(d)
    return lexsort(operands)


def sort_specs(keys: list) -> tuple:
    """(asc, nulls_first) per bound SortKey."""
    return tuple((k.asc, k.nulls_first) for k in keys)


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------

def _extreme(dtype, func: str):
    """Python scalar: the dtype's max for "min" (its min for "max")."""
    info = torch.finfo(dtype) if dtype.is_floating_point else \
        torch.iinfo(dtype)
    return info.max if func == "min" else info.min


def agg_apply(gid: torch.Tensor, alive: torch.Tensor, func: str, arg,
              cap_out: int):
    """One per-group aggregate. `arg` is a (data, valid) tuple or None.

    Returns (values, valid), each of length cap_out. gid for dead rows must
    be >= cap_out so their contributions fall outside the segment range."""
    if func == "count_star":
        vals = _seg(torch.where(alive, 1, 0).to(_I32), gid, cap_out, "sum")
        return vals.to(_I64), torch.ones(cap_out, dtype=torch.bool,
                                         device=gid.device)
    data, valid = arg
    contrib = alive & valid
    cnt_op = contrib.to(_I64)
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    if func == "count":
        return _seg(cnt_op, gid, cap_out, "sum"), \
            torch.ones(cap_out, dtype=torch.bool, device=gid.device)
    if func == "sum":
        z = torch.where(contrib, data, zero)
        cnt, s = _seg_multi([(cnt_op, "sum"), (z, "sum")], gid, cap_out)
        return s, cnt > 0
    if func in ("min", "max"):
        z = torch.where(contrib, data, _extreme(data.dtype, func))
        cnt, vals = _seg_multi([(cnt_op, "sum"), (z, func)], gid, cap_out)
        vals = torch.where(cnt > 0, vals, zero)
        return vals, cnt > 0
    if func == "avg":
        # integer/decimal inputs sum EXACTLY in int64 and divide on the
        # per-group output; float inputs sum in float64
        z = torch.where(contrib, data, zero)
        if data.dtype.is_floating_point or data.dtype == torch.bool:
            z = z.to(_F64)
        cnt, s = _seg_multi([(cnt_op, "sum"), (z, "sum")], gid, cap_out)
        return s.to(_F64) / torch.clamp(cnt, min=1).to(_F64), cnt > 0
    if func == "stddev_samp":
        # squares accumulate in float; the plain sum stays exact for ints
        zf = torch.where(contrib, data, zero).to(_F64)
        s_op = zf if data.dtype.is_floating_point else \
            torch.where(contrib, data, zero)
        cnt, s, s2 = _seg_multi([(cnt_op, "sum"), (s_op, "sum"),
                                 (zf * zf, "sum")], gid, cap_out)
        s = s.to(_F64)
        nf = cnt.to(_F64)
        var = (s2 - s * s / torch.clamp(nf, min=1.0)) / \
            torch.clamp(nf - 1.0, min=1.0)
        return torch.sqrt(torch.clamp(var, min=0.0)), cnt > 1
    raise NotImplementedError(f"device agg {func}")


_MASKED_SEG_MAX = 64


def group_representatives(gid: torch.Tensor, alive: torch.Tensor,
                          data: torch.Tensor, valid: torch.Tensor,
                          cap_out: int):
    """Per-group key value (all rows in a group share it)."""
    if cap_out <= _MASKED_SEG_MAX and data.dtype != torch.bool:
        filled = torch.where(alive, data, _extreme(data.dtype, "max"))
        vals = _seg(filled, gid, cap_out, "max")
        occupied = _seg(alive.to(_I32), gid, cap_out, "max") > 0
        pvalid = _seg((alive & valid).to(_I32), gid, cap_out, "max") > 0
        return torch.where(occupied, vals, torch.zeros_like(vals)), pvalid
    # the reference's .at[].set drops out-of-range gids; torch would fault,
    # so they are masked to the spare slot explicitly
    safe_gid = torch.where(alive & (gid >= 0) & (gid < cap_out), gid,
                           cap_out).long()
    vals = torch.zeros(cap_out + 1, dtype=data.dtype, device=data.device)
    vals.scatter_(0, safe_gid, data)
    pvalid = torch.zeros(cap_out + 1, dtype=torch.bool, device=data.device)
    pvalid.scatter_(0, safe_gid, valid)
    return vals[:cap_out], pvalid[:cap_out]


def first_row_per_gid(gid: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """For each gid in [0, n], the smallest row index with that gid among
    rows in `mask`, n where none, and in slot n the smallest row index of
    all rows outside `mask` too: the reference's
    ``full(n + 1, n).at[where(mask, gid, n)].min(iota)``.

    The reference sends every row outside `mask` to slot n. As a min
    scatter on CUDA those rows would queue on one atomic, so each takes a
    slot of its own past n (a 2n + 1 buffer), and slot n folds them in
    afterwards with one reduction: the same bits."""
    n = int(gid.shape[0])
    iota = _iota(n, gid.device)
    first = torch.full((2 * n + 1,), n, dtype=_I32, device=gid.device)
    target = torch.where(mask, gid.long().clamp(0, n), n + 1 + iota.long())
    first.scatter_reduce_(0, target, iota, "amin")
    first[n] = torch.minimum(first[n], first[n:].min())
    return first[:n + 1]


def distinct_within_group(gid: torch.Tensor, alive: torch.Tensor,
                          data: torch.Tensor, valid: torch.Tensor
                          ) -> torch.Tensor:
    """Alive-mask of one representative row per (gid, value) pair (for
    COUNT/SUM DISTINCT): joint rank then first-occurrence selection."""
    n = int(alive.shape[0])
    ones = torch.ones(n, dtype=torch.bool, device=alive.device)
    pair_gid, _ = dense_rank(
        [gid, torch.where(valid, data, torch.zeros_like(data)),
         (~valid).to(_I32)], [ones, ones, ones], alive & valid)
    first = first_row_per_gid(pair_gid, alive & valid)
    return (alive & valid) & \
        (first[pair_gid.long().clamp(0, n)] == _iota(n, alive.device))


# ---------------------------------------------------------------------------
# sorted aggregation: within-group scans over key-sorted rows
# ---------------------------------------------------------------------------

def run_bounds(x: torch.Tensor):
    """For a NON-DECREASING x: (first, last), the indices of the first and
    the last row that holds x[i]. Equal to the reference's running max of
    flagged starts (``lax.cummax``) and ``segment_max(iota, x)``, with
    neither a scan nor a scatter (both are slow on CUDA)."""
    first = torch.searchsorted(x, x, out_int32=True)
    last = torch.searchsorted(x, x, right=True, out_int32=True) - 1
    return first, last


def sorted_agg_scan(vals: torch.Tensor, new_group: torch.Tensor,
                    op: str) -> torch.Tensor:
    """Inclusive within-group scan of op ("add", "min", "max") over
    KEY-SORTED rows; group totals sit at group-end rows. Integer sums use
    one cumulative sum minus its value before the group's first row
    (exact: wrapping arithmetic is a ring); float sums and min/max use a
    log-depth segmented scan."""
    n = int(vals.shape[0])
    if n == 0:
        return vals
    if op == "add" and not vals.dtype.is_floating_point:
        c = torch.cumsum(vals, 0, dtype=vals.dtype)
        # the group's first row: the reference's running max of flagged
        # row ids, as a binary search over the non-decreasing group count
        start, _ = run_bounds(_cumsum_i32(new_group) - 1)
        start = start.long()
        before = torch.where(start > 0, c[(start - 1).clamp(min=0)],
                             torch.zeros_like(c))
        return c - before
    comb = {"add": torch.add, "min": torch.minimum, "max": torch.maximum}[op]
    flag, out = new_group.clone(), vals.clone()
    d = 1
    while d < n:
        # out[i] <- flag[i] ? out[i] : comb(out[i - d], out[i])
        f_hi = flag[d:]
        merged = comb(out[:-d], out[d:])
        out = torch.cat([out[:d], torch.where(f_hi, out[d:], merged)])
        flag = torch.cat([flag[:d], f_hi | flag[:-d]])
        d <<= 1
    return out


def group_ends(new_group: torch.Tensor, alive_sorted: torch.Tensor
               ) -> torch.Tensor:
    """Row mask of each group's LAST alive row in sorted order."""
    n = int(new_group.shape[0])
    next_new = torch.ones(n, dtype=torch.bool, device=new_group.device)
    next_new[:-1] = new_group[1:]
    next_dead = torch.ones(n, dtype=torch.bool, device=new_group.device)
    next_dead[:-1] = ~alive_sorted[1:]
    return alive_sorted & (next_new | next_dead)


# ---------------------------------------------------------------------------
# window functions
# ---------------------------------------------------------------------------

def window_ordered_core(sgid: torch.Tensor, tie_data: list, tie_valid: list,
                        arg, func: str):
    """Ordered-window values over rows ALREADY sorted by (partition, order):
    the reference's ``window_ordered_core``.

    sgid: sorted partition ids (dead rows hold a trailing sentinel id), so
    non-decreasing. tie_data/tie_valid: sorted order-key columns for RANGE
    tie detection. arg: (data, valid) in sorted order, or None (rank
    family / count_star). Returns (values, valid) in sorted order. RANGE
    frames: every row of a tie run takes the run's last cumulative value.
    Integer sums are bit-identical to the reference's; float sums and
    averages take another order (a log-depth scan)."""
    n = int(sgid.shape[0])
    dev = sgid.device
    iota = _iota(n, dev)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    new_part = _changed(sgid)
    same = ~new_part
    for d, v in zip(tie_data, tie_valid):
        same = same & ~_changed(d) & ~_changed(v)
    part_start, _ = run_bounds(sgid)
    pos_in_part = iota - part_start
    if func == "row_number":
        return pos_in_part + 1, ones
    new_run = ~same          # a run is a maximal tie group in a partition
    run_id = _cumsum_i32(new_run) - 1
    run_start, run_last = run_bounds(run_id)
    if func == "rank":
        return run_start - part_start + 1, ones
    if func == "dense_rank":
        cb = _cumsum_i32(new_run & ~new_part)
        return cb - cb[part_start.long()] + 1, ones

    last = run_last.long()
    if func == "count_star":
        return (pos_in_part + 1)[last], ones
    data, valid = arg
    run_count = sorted_agg_scan(valid.to(_I32), new_part, "add")[last]
    out_valid = run_count > 0
    if func == "count":
        return run_count, ones
    int_in = not data.dtype.is_floating_point and data.dtype != torch.bool
    if func in ("sum", "avg"):
        acc = data.dtype if int_in else _F64
        w = torch.where(valid, data.to(acc), torch.zeros((), dtype=acc,
                                                         device=dev))
        run_sum = sorted_agg_scan(w, new_part, "add")[last]
        if func == "sum":
            return run_sum, out_valid
        return run_sum.to(_F64) / torch.clamp(run_count, min=1).to(_F64), \
            out_valid
    if func in ("min", "max"):
        vals = torch.where(valid, data, _extreme(data.dtype, func))
        out = sorted_agg_scan(vals, new_part, func)[last]
        return torch.where(out_valid, out, torch.zeros_like(out)), out_valid
    raise NotImplementedError(f"device window {func}")


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------

def build_side(gid_right: torch.Tensor, alive_right: torch.Tensor):
    """Sort right-side gids (dead rows pushed to +inf); returns
    (sorted_gid, perm)."""
    key = torch.where(alive_right, gid_right.to(_I32), _iinfo(_I32).max)
    return _sort1(key, _iota(int(alive_right.shape[0]), key.device))


def probe_counts_by_gid(build_gid, build_alive, probe_gid, probe_alive,
                        gid_cap: int):
    """Per-probe-row match range in the gid-sorted build side:
    (start, count), from per-gid build counts and their exclusive prefix."""
    counts = _ck.seg_reduce_plain(
        build_alive.to(_I32), torch.where(build_alive, build_gid, gid_cap),
        gid_cap, "sum")
    offsets = _cumsum_i32(counts) - counts      # exclusive prefix per gid
    safe = probe_gid.long().clamp(0, gid_cap - 1)
    in_range = probe_alive & (probe_gid >= 0) & (probe_gid < gid_cap)
    lo = torch.where(in_range, offsets[safe], 0)
    cnt = torch.where(in_range, counts[safe], 0)
    return lo.to(_I32), cnt.to(_I32)


def expand_join(lo: torch.Tensor, cnt: torch.Tensor, probe_alive,
                cap_out: int):
    """Materialize (left_row, build_sorted_pos) pairs for an inner join.

    cap_out must be >= total matches. Returns (left_idx, build_pos,
    alive_out), each of length cap_out: every probe row with matches marks
    its output-run start with its row id, and a running max spreads the id
    across the run."""
    n = int(cnt.shape[0])
    dev = cnt.device
    cum = _cumsum_i32(cnt)
    total = cum[-1]
    starts = cum - cnt
    rows = _iota(n, dev)
    has = probe_alive & (cnt > 0)
    marker = torch.zeros(cap_out + 1, dtype=_I32, device=dev)
    target = torch.where(has, torch.clamp(starts, max=cap_out), cap_out)
    # the runs' starts are distinct, so a plain scatter equals the
    # reference's .at[].max: only the spare slot cap_out takes several
    # writes, and it is cut off (a max-scatter there serialises every row
    # without a match on one atomic)
    marker.scatter_(0, target.long(), rows)
    left_pos = torch.cummax(marker[:cap_out], 0).values
    left_safe = torch.clamp(left_pos, max=n - 1)
    j = _iota(cap_out, dev)
    k = j - starts[left_safe.long()]
    build_pos = lo[left_safe.long()] + k
    alive_out = j < total
    return left_safe, build_pos, alive_out
