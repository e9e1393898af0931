"""Device plan executor: walks a bound plan over DTables (torch tensors).

Counterpart of the eager path of ``nds_tpu/engine/jax_backend/executor.py``
(``JaxExecutor``): each node runs as torch compute over padded buffers with
an alive-row mask, and row counts sync to the host only where a capacity is
chosen (after filters, joins and aggregates). Scanned tables stay resident
on the device across queries.

Not in this slice: compiled whole-plan replay, batched programs, CTE
segmentation and mesh execution. A node the device path does not cover
raises NotImplementedError and falls back to the numpy host executor for
that node only (``fallback_nodes`` names it), as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..column import Table, dec_scale, is_dec
from ..executor import Executor as HostExecutor
from ..executor import load_columns
from ..plan import (AggregateNode, AggSpec, BCall, BCol, BExpr, DistinctNode,
                    FilterNode, JoinNode, LimitNode, MaterializedNode,
                    PlanNode, ProjectNode, ScanNode, SetOpNode, SortNode,
                    WindowFunc, WindowNode)
from . import cuda_kernels as _ck
from . import exprs, kernels
from .device import (DCol, DTable, bucket, phys_dtype, rank_key,
                     string_rank_maps, to_device, to_host, lut_gather)

_I32 = torch.int32
_I64 = torch.int64
_F64 = torch.float64


class TorchExecutor:
    def __init__(self, load_table: Callable, device,
                 gpu_kernels=_ck.VALID_OPS):
        self._load_table = load_table
        self.device = torch.device(device)
        self._ops = _ck.parse_ops(gpu_kernels)
        self._memo: dict[int, DTable] = {}
        self._scan_cache: dict[str, DTable] = {}   # device-resident scans
        self.fallback_nodes: list[str] = []

    # -- public --------------------------------------------------------------
    def run_query(self, plan: PlanNode) -> DTable:
        self.fallback_nodes = []
        self._memo = {}
        return self.execute(plan)

    def execute(self, node: PlanNode) -> DTable:
        # install this executor's kernel choice for every kernel below
        _ck.set_active(self._ops)
        key = id(node)
        if key in self._memo:
            return self._memo[key]
        try:
            result = self._run(node)
        except NotImplementedError as e:
            self.fallback_nodes.append(f"{type(node).__name__}: {e}")
            result = self._host_fallback(node)
        self._memo[key] = result
        return result

    # -- helpers -------------------------------------------------------------
    @staticmethod
    def _decide(scalar) -> int:
        """Host-sync a device count (a capacity or structural decision)."""
        return int(scalar)

    def _eval(self, expr: BExpr, table: DTable) -> DCol:
        return exprs.evaluate(expr, table, subquery_eval=self._scalar)

    def _iota(self, n: int) -> torch.Tensor:
        return torch.arange(n, dtype=_I32, device=self.device)

    def _dense_rank(self, key_data: list, key_valid: list, alive):
        """dense_rank with the packed single-key tier when the key domain
        fits int64 (all keys integer-typed, capacity >= 8192)."""
        n = int(alive.shape[0])
        if key_data and n >= (1 << 13) and all(map(_is_int, key_data)) and \
                self._decide(kernels.group_tier(key_data, key_valid, alive)):
            return kernels.dense_rank_packsort(key_data, key_valid, alive)
        return kernels.dense_rank(key_data, key_valid, alive)

    def _scalar(self, plan: PlanNode):
        """Uncorrelated scalar subquery -> (host value, None)."""
        t = to_host(self.execute(plan))
        if t.num_rows == 0:
            return None, None
        col = t.columns[0]
        if not bool(col.validity[0]):
            return None, None
        if col.dtype == "str":
            return col.decode()[0], None
        return np.asarray(col.data)[0].item(), None

    def _host_fallback(self, node: PlanNode) -> DTable:
        repl = {}
        for f in ("child", "left", "right"):
            sub = getattr(node, f, None)
            if isinstance(sub, PlanNode):
                t = to_host(self.execute(sub))
                repl[f] = MaterializedNode(
                    table=t, label=f"device:{f}",
                    out_names=list(sub.out_names),
                    out_dtypes=list(sub.out_dtypes))
        host_node = dataclasses.replace(node, **repl) if repl else node
        host = HostExecutor(self._load_table)
        return to_device(host.execute(host_node), self.device)

    def _maybe_compact(self, t: DTable) -> DTable:
        count_t = t.count()
        count = self._decide(count_t)
        cap = bucket(count)
        if t.capacity <= 2 * cap:
            return t
        perm, _ = kernels.compaction_perm(t.alive)
        perm = perm[:cap]
        cols = _gather_cols(t.cols, perm)
        alive = self._iota(cap) < count_t
        return DTable(t.names, cols, alive)

    # -- node dispatch -------------------------------------------------------
    def _run(self, node: PlanNode) -> DTable:
        if isinstance(node, MaterializedNode):
            return to_device(node.table, self.device)
        if isinstance(node, ScanNode):
            return self._run_scan(node)
        if isinstance(node, FilterNode):
            child = self.execute(node.child)
            mask = self._eval(node.predicate, child)
            alive = kernels.filter_alive(child.alive, mask.data, mask.valid)
            return self._maybe_compact(DTable(list(node.out_names),
                                              child.cols, alive))
        if isinstance(node, ProjectNode):
            child = self.execute(node.child)
            cols = [self._eval(e, child) for e in node.exprs]
            return DTable(list(node.out_names), cols, child.alive)
        if isinstance(node, JoinNode):
            return self._run_join(node)
        if isinstance(node, AggregateNode):
            return self._run_aggregate(node)
        if isinstance(node, WindowNode):
            return self._run_window(node)
        if isinstance(node, SortNode):
            return self._run_sort(node)
        if isinstance(node, LimitNode):
            child = self.execute(node.child)
            alive = kernels.limit_alive(child.alive, node.n)
            return self._maybe_compact(DTable(list(node.out_names),
                                              child.cols, alive))
        if isinstance(node, DistinctNode):
            child = self.execute(node.child)
            alive = self._distinct_alive(child, list(range(len(child.cols))))
            return self._maybe_compact(DTable(list(node.out_names),
                                              child.cols, alive))
        if isinstance(node, SetOpNode):
            return self._run_setop(node)
        raise NotImplementedError(type(node).__name__)

    def _run_setop(self, node: SetOpNode) -> DTable:
        left = self.execute(node.left)
        right = self.execute(node.right)
        names = list(node.out_names)
        both = _concat_dtables([left, right], names)
        if node.op == "union":
            if node.all:
                return both
            alive = self._distinct_alive(both, list(range(len(both.cols))))
            return self._maybe_compact(DTable(names, both.cols, alive))
        # intersect / except: distinct-row semantics (the host's ops.set_op)
        n = both.capacity
        iota = self._iota(n)
        is_left = iota < left.capacity
        gid, _ = self._dense_rank([rank_key(c) for c in both.cols],
                                  [c.valid for c in both.cols], both.alive)
        # as in the reference, every row outside a side (and every dead
        # row) lands on the spare slot n of an n + 1 buffer, which no
        # alive row reads
        safe_gid = torch.where(both.alive, gid, n).long()
        in_left = torch.zeros(n + 1, dtype=torch.bool, device=self.device)
        in_left[torch.where(is_left, safe_gid, n)] = True
        in_right = torch.zeros(n + 1, dtype=torch.bool, device=self.device)
        in_right[torch.where(is_left, n, safe_gid)] = True
        keep = in_left & (in_right if node.op == "intersect" else ~in_right)
        first_left = kernels.first_row_per_gid(gid, both.alive & is_left)
        g = gid.long().clamp(0, n)
        alive = both.alive & is_left & keep[g] & (first_left[g] == iota)
        return self._maybe_compact(DTable(names, both.cols, alive))

    def _run_scan(self, node: ScanNode) -> DTable:
        cache_key = node.table + "//" + ",".join(node.columns)
        if cache_key not in self._scan_cache:
            t = load_columns(self._load_table, node.table, node.columns)
            index = {n: i for i, n in enumerate(t.names)}
            cols = [t.columns[index[c]] for c in node.columns]
            self._scan_cache[cache_key] = to_device(
                Table(list(node.out_names), cols), self.device)
        cached = self._scan_cache[cache_key]
        return DTable(list(node.out_names), cached.cols, cached.alive)

    # -- sort / distinct -----------------------------------------------------
    def _run_sort(self, node: SortNode) -> DTable:
        child = self.execute(node.child)
        key_cols = [self._eval(k.expr, child) for k in node.keys]
        perm = kernels.sort_perm([rank_key(c) for c in key_cols],
                                 [c.valid for c in key_cols],
                                 kernels.sort_specs(node.keys), child.alive)
        cols = _gather_cols(child.cols, perm)
        return DTable(list(node.out_names), cols, child.alive[perm.long()])

    def _distinct_alive(self, t: DTable, col_idx: list[int]) -> torch.Tensor:
        keys = [rank_key(t.cols[i]) for i in col_idx]
        valids = [t.cols[i].valid for i in col_idx]
        gid, _ = self._dense_rank(keys, valids, t.alive)
        n = t.capacity
        first = kernels.first_row_per_gid(gid, t.alive)
        return t.alive & (first[gid.long().clamp(0, n)] == self._iota(n))

    # -- window functions ----------------------------------------------------
    def _run_window(self, node: WindowNode) -> DTable:
        child = self.execute(node.child)
        out_cols = list(child.cols)
        for wf in node.funcs:
            out_cols.append(self._window_one(wf, child))
        return DTable(list(node.out_names), out_cols, child.alive)

    def _window_one(self, wf: WindowFunc, child: DTable) -> DCol:
        n = child.capacity
        pcols = [self._eval(e, child) for e in wf.partition_by]
        gid, _ = self._dense_rank([rank_key(c) for c in pcols],
                                  [c.valid for c in pcols], child.alive)
        # the reference widens narrow-lane columns here (widen_col); the
        # port's columns are always wide
        arg_col = None if wf.arg is None else self._eval(wf.arg, child)
        if arg_col is not None and arg_col.dtype == "str":
            raise NotImplementedError("window function over strings (device)")
        func = wf.func
        if arg_col is None:
            if func in ("count", "count_star"):
                func = "count_star"
            arg = None
        else:
            arg = (arg_col.canon().data, arg_col.valid)

        if not wf.order_by:
            if func in ("rank", "dense_rank", "row_number"):
                raise NotImplementedError(f"{func} requires ORDER BY")
            vals, valid = kernels.agg_apply(gid, child.alive, func, arg, n)
            # dead rows (gid n) clamp to the last group slot, as JAX does
            data, dvalid = kernels.gather_many([vals, valid], gid)
        else:
            ocols = [self._eval(k.expr, child) for k in wf.order_by]
            okd = [rank_key(c) for c in ocols]
            okv = [c.valid for c in ocols]
            specs = ((True, None),) + kernels.sort_specs(wf.order_by)
            ones = torch.ones(n, dtype=torch.bool, device=self.device)
            perm = kernels.sort_perm([gid] + okd, [ones] + okv, specs,
                                     child.alive)
            k = len(okd)
            sorted_ = kernels.gather_many(
                [gid] + okd + okv + ([] if arg is None else list(arg)), perm)
            sarg = None if arg is None else tuple(sorted_[1 + 2 * k:])
            vals_s, valid_s = kernels.window_ordered_core(
                sorted_[0], sorted_[1:1 + k], sorted_[1 + k:1 + 2 * k],
                sarg, func)
            data, dvalid = kernels.unscatter(perm, (vals_s, valid_s))
        if arg_col is not None and is_dec(arg_col.dtype) and \
                wf.func == "avg":
            data = data / 10.0 ** dec_scale(arg_col.dtype)   # descale
        return DCol(wf.dtype, data.to(phys_dtype(wf.dtype)),
                    dvalid & child.alive)

    # -- aggregate -----------------------------------------------------------
    def _run_aggregate(self, node: AggregateNode) -> DTable:
        child = self.execute(node.child)
        if node.rollup_levels is not None:
            grouping_sets = [list(range(k)) for k in node.rollup_levels]
        elif node.rollup:
            grouping_sets = [list(range(k))
                             for k in range(len(node.group_exprs), -1, -1)]
        else:
            grouping_sets = [list(range(len(node.group_exprs)))]
        if self._sorted_agg_eligible(node, child):
            return self._aggregate_sorted(node, child, grouping_sets)
        pieces = [self._aggregate_one(node, child, keep)
                  for keep in grouping_sets]
        if len(pieces) == 1:
            return pieces[0]
        return _concat_dtables(pieces, list(node.out_names))

    @staticmethod
    def _sorted_agg_eligible(node: AggregateNode, child: DTable) -> bool:
        """The sorted aggregation path: ONE key sort shared by every rollup
        level, within-group scans instead of segment scatters. Grouped
        aggregates of plain functions over fact-scale inputs only."""
        if not node.group_exprs:
            return False          # global aggregate: segment reduces suffice
        for s in node.aggs:
            if s.distinct or s.func not in (
                    "count_star", "count", "sum", "min", "max", "avg",
                    "stddev_samp"):
                return False
            if s.arg is not None and s.arg.dtype == "str":
                return False
        return child.capacity >= (1 << 13)

    def _aggregate_sorted(self, node: AggregateNode, child: DTable,
                          grouping_sets: list) -> DTable:
        n = child.capacity
        alive = child.alive
        group_cols = [self._eval(e, child) for e in node.group_exprs]
        keys = [rank_key(c) for c in group_cols]
        kvalids = [c.valid for c in group_cols]
        arg_cols = [None if s.arg is None else self._eval(s.arg, child)
                    for s in node.aggs]
        int_keys = all(map(_is_int, keys))
        tier = int_keys and self._decide(
            kernels.group_tier(keys, kvalids, alive))

        # ONE sort: keys (packed when possible) + agg args as payload,
        # deduplicated by expression so SUM(x)/AVG(x) carry x once
        payloads: list = []
        pay_idx: list = []
        seen_args: dict[str, int] = {}
        for s, ac in zip(node.aggs, arg_cols):
            if ac is None:
                pay_idx.append(None)
                continue
            akey = repr(s.arg)
            if akey in seen_args:
                pay_idx.append(seen_args[akey])
                continue
            seen_args[akey] = len(payloads)
            pay_idx.append(len(payloads))
            payloads.append(ac.canon().data)
            payloads.append(ac.valid)
        iota = self._iota(n)
        if tier:
            norms, ranges, _ = kernels._key_ranges(keys, kvalids, alive)
            pack = kernels.pack_keys(norms, ranges, n, self.device)
            key_ops = [torch.where(alive, pack, torch.iinfo(_I64).max)]
        else:
            ranges = None
            key_ops = [(~alive).to(_I32)]
            for d, v in zip(keys, kvalids):
                key_ops.append((~v).to(_I32))
                key_ops.append(torch.where(v & alive, d, torch.zeros_like(d)))
        if len(key_ops) == 1 and _ck.op_active("sort"):
            # the packed key rides the sort kernel with ONLY the row index
            # as payload; the agg payloads follow via one batched gather
            skey, perm = kernels._sort1(key_ops[0], iota)
            sorted_keys = (skey,)
            sorted_pays = tuple(kernels.gather_many(payloads, perm))
        else:
            perm = kernels.lexsort(key_ops)
            p = perm.long()
            sorted_keys = tuple(k[p] for k in key_ops)
            sorted_pays = tuple(x[p] for x in payloads)
        alive_sorted = iota < alive.sum()

        def level_new_group(k: int) -> torch.Tensor:
            first = alive_sorted & (iota == 0)
            if k == 0:
                return first
            if ranges is not None:
                stride = torch.ones((), dtype=_I64, device=self.device)
                for r in ranges[k:]:
                    stride = stride * r
                diff = kernels._changed(torch.div(sorted_keys[0], stride,
                                                  rounding_mode="floor"))
            else:
                diff = torch.zeros(n, dtype=torch.bool, device=self.device)
                for i in range(k):
                    for op in (sorted_keys[1 + 2 * i], sorted_keys[2 + 2 * i]):
                        diff = diff | kernels._changed(op)
            return (alive_sorted & diff) | first

        pieces: list[DTable] = []
        for keep in grouping_sets:
            k = len(keep)
            if k == 0:
                # grand total: one group through the segment-reduce path,
                # which also gives the empty-input one-row semantics
                pieces.append(self._aggregate_one(node, child, keep))
                continue
            new_group = level_new_group(k)
            gid_sorted = kernels._cumsum_i32(new_group) - 1
            num_groups_t = torch.where(alive_sorted, gid_sorted, -1).max() + 1
            cap_out = bucket(max(self._decide(num_groups_t), 1))
            is_end = kernels.group_ends(new_group, alive_sorted)
            end_perm, _ = kernels.compaction_perm(is_end)
            sel = end_perm[:cap_out].long()
            orig = perm[sel].long()
            alive_out = self._iota(cap_out) < num_groups_t

            out_cols: list[DCol] = []
            for i, gc in enumerate(group_cols):
                if i < k:
                    cd = gc.canon().data
                    out_cols.append(DCol(gc.dtype, cd[orig],
                                         gc.valid[orig] & alive_out,
                                         gc.dictionary))
                else:
                    out_cols.append(_null_col(gc, cap_out, self.device))

            ones_i = torch.where(alive_sorted, 1, 0).to(_I32)
            for spec, ac, pi in zip(node.aggs, arg_cols, pay_idx):
                if spec.func == "count_star":
                    cnt_s = kernels.sorted_agg_scan(ones_i, new_group, "add")
                    out_cols.append(DCol(
                        spec.dtype, cnt_s[sel].to(phys_dtype(spec.dtype)),
                        torch.ones(cap_out, dtype=torch.bool,
                                   device=self.device)))
                    continue
                data_s = sorted_pays[pi]
                valid_s = sorted_pays[pi + 1] & alive_sorted
                cnt_sel = kernels.sorted_agg_scan(valid_s.to(_I64), new_group,
                                                  "add")[sel]
                func = spec.func
                if func == "count":
                    out_cols.append(DCol(
                        spec.dtype, cnt_sel.to(phys_dtype(spec.dtype)),
                        torch.ones(cap_out, dtype=torch.bool,
                                   device=self.device)))
                    continue
                int_in = not data_s.dtype.is_floating_point and \
                    data_s.dtype != torch.bool
                zero = torch.zeros((), dtype=data_s.dtype, device=self.device)
                dvalid = cnt_sel > 0
                if func in ("sum", "avg"):
                    acc = data_s.dtype if int_in else _F64
                    w = torch.where(valid_s, data_s, zero).to(acc)
                    sum_sel = kernels.sorted_agg_scan(w, new_group,
                                                      "add")[sel]
                    if func == "sum":
                        vals = sum_sel
                    else:
                        vals = sum_sel.to(_F64) / \
                            torch.clamp(cnt_sel, min=1).to(_F64)
                elif func in ("min", "max"):
                    w = torch.where(valid_s, data_s,
                                    kernels._extreme(data_s.dtype, func))
                    vals = kernels.sorted_agg_scan(w, new_group, func)[sel]
                    vals = torch.where(dvalid, vals, zero)
                else:           # stddev_samp
                    zf = torch.where(valid_s, data_s, zero).to(_F64)
                    s1 = kernels.sorted_agg_scan(
                        torch.where(valid_s, data_s, zero) if int_in else zf,
                        new_group, "add")[sel].to(_F64)
                    s2 = kernels.sorted_agg_scan(zf * zf, new_group,
                                                 "add")[sel]
                    nf = cnt_sel.to(_F64)
                    var = (s2 - s1 * s1 / torch.clamp(nf, min=1.0)) / \
                        torch.clamp(nf - 1.0, min=1.0)
                    vals = torch.sqrt(torch.clamp(var, min=0.0))
                    dvalid = cnt_sel > 1
                if ac is not None and is_dec(ac.dtype) and \
                        spec.func in ("avg", "stddev_samp"):
                    vals = vals / 10.0 ** dec_scale(ac.dtype)
                out_cols.append(DCol(spec.dtype,
                                     vals.to(phys_dtype(spec.dtype)),
                                     dvalid & alive_out))
            if node.rollup:
                out_cols.append(_grouping_id_col(node, range(k), cap_out,
                                                 self.device))
            pieces.append(DTable(list(node.out_names), out_cols, alive_out))
        if len(pieces) == 1:
            return pieces[0]
        return _concat_dtables(pieces, list(node.out_names))

    def _aggregate_one(self, node: AggregateNode, child: DTable,
                       keep: list[int]) -> DTable:
        group_cols = [self._eval(e, child) for e in node.group_exprs]
        active = [group_cols[i] for i in keep]
        gid, num_groups_t = self._dense_rank(
            [rank_key(c) for c in active], [c.valid for c in active],
            child.alive)
        num_groups = self._decide(num_groups_t)
        if not active:
            # a global aggregate (incl. a rollup's grand-total grouping set)
            # over empty input still yields one row
            num_groups = max(num_groups, 1)
            num_groups_t = torch.clamp(num_groups_t, min=1)
        cap_out = bucket(max(num_groups, 1))
        out_cols: list[DCol] = []
        keep_set = set(keep)
        for i, gc in enumerate(group_cols):
            if i in keep_set:
                vals, valid = kernels.group_representatives(
                    gid, child.alive, gc.canon().data, gc.valid, cap_out)
                out_cols.append(DCol(gc.dtype, vals, valid, gc.dictionary))
            else:  # rolled-up column: NULL
                out_cols.append(_null_col(gc, cap_out, self.device))
        out_cols.extend(self._compute_aggs(node.aggs, child, gid,
                                           child.alive, cap_out))
        if node.rollup:
            out_cols.append(_grouping_id_col(node, keep_set, cap_out,
                                             self.device))
        alive = self._iota(cap_out) < num_groups_t
        return DTable(list(node.out_names), out_cols, alive)

    def _compute_aggs(self, specs: list[AggSpec], child: DTable,
                      gid: torch.Tensor, alive: torch.Tensor,
                      cap_out: int) -> list[DCol]:
        out: list[DCol] = []
        for spec in specs:
            arg_col = None if spec.arg is None else \
                self._eval(spec.arg, child)
            use_alive = alive
            if spec.distinct and arg_col is not None:
                use_alive = kernels.distinct_within_group(
                    gid, alive, rank_key(arg_col), arg_col.valid)
            if arg_col is not None and arg_col.dtype == "str":
                out.append(self._agg_string(spec, arg_col, gid, use_alive,
                                            cap_out))
                continue
            arg = None
            if arg_col is not None:
                data = arg_col.canon().data
                if spec.func == "sum" and (arg_col.dtype == "int"
                                           or is_dec(arg_col.dtype)):
                    data = data.to(phys_dtype("int"))
                arg = (data, arg_col.valid)
            vals, valid = kernels.agg_apply(gid, use_alive, spec.func, arg,
                                            cap_out)
            if arg_col is not None and is_dec(arg_col.dtype) and \
                    spec.func in ("avg", "stddev_samp"):
                # the kernel averaged SCALED ints; descale to the value
                vals = vals / 10.0 ** dec_scale(arg_col.dtype)
            out.append(DCol(spec.dtype, vals.to(phys_dtype(spec.dtype)),
                            valid))
        return out

    def _agg_string(self, spec: AggSpec, arg_col: DCol, gid, alive,
                    cap_out: int) -> DCol:
        if spec.func == "count":
            vals, valid = kernels.agg_apply(
                gid, alive, "count", (torch.zeros_like(arg_col.data),
                                      arg_col.valid), cap_out)
            return DCol("int", vals.to(phys_dtype("int")), valid)
        if spec.func not in ("min", "max"):
            raise NotImplementedError(f"device {spec.func} over strings")
        ranks, rank_to_code = string_rank_maps(arg_col.dictionary)
        rank_data = lut_gather(arg_col.data, ranks)
        vals, valid = kernels.agg_apply(gid, alive, spec.func,
                                        (rank_data, arg_col.valid), cap_out)
        codes = lut_gather(vals.to(_I32), rank_to_code)
        return DCol("str", codes, valid, arg_col.dictionary)

    # -- joins ---------------------------------------------------------------
    def _run_join(self, node: JoinNode) -> DTable:
        if node.kind == "right":
            return self._right_join(node)
        left = self.execute(node.left)
        right = self.execute(node.right)
        return self._join(node, left, right)

    def _right_join(self, node: JoinNode) -> DTable:
        # right join == left join with sides swapped, columns re-ordered
        residual = node.residual
        nl = len(node.left.out_names)
        nr = len(node.right.out_names)
        if residual is not None:
            residual = _shift_residual(residual, nl, nr)
        swapped = dataclasses.replace(
            node, kind="left", left=node.right, right=node.left,
            left_keys=node.right_keys, right_keys=node.left_keys,
            residual=residual,
            out_names=[f"__r{i}" for i in range(len(node.out_names))])
        lt = self.execute(node.left)
        rt = self.execute(node.right)
        out = self._join(swapped, rt, lt)
        cols = out.cols[len(rt.cols):] + out.cols[:len(rt.cols)]
        return DTable(list(node.out_names), cols, out.alive)

    def _join(self, node: JoinNode, left: DTable, right: DTable) -> DTable:
        kind = node.kind
        if node.null_aware and node.residual is not None:
            raise NotImplementedError(
                "null-aware anti join with residual is unsupported")
        lcap, rcap = left.capacity, right.capacity
        if kind == "cross":
            lo = torch.zeros(lcap, dtype=_I32, device=self.device)
            perm, rcount_t = kernels.compaction_perm(right.alive)
            cnt = torch.where(left.alive, rcount_t, 0).to(_I32)
            out, _, _ = self._expand_combine(node, left, right, lo, cnt, perm,
                                             residual=node.residual)
            return self._maybe_compact(out)

        lkeys = [self._eval(e, left) for e in node.left_keys]
        rkeys = [self._eval(e, right) for e in node.right_keys]
        lvalid = torch.ones(lcap, dtype=torch.bool, device=self.device)
        rvalid = torch.ones(rcap, dtype=torch.bool, device=self.device)
        for c in lkeys:
            lvalid = lvalid & c.valid
        for c in rkeys:
            rvalid = rvalid & c.valid

        if len(lkeys) == 1 and kind in ("inner", "left", "semi", "anti"):
            # direct-address path: the NDS star-join shape (single int key,
            # unique build side with a bounded key range)
            out = self._fast_join(node, left, right, lkeys[0], rkeys[0],
                                  left.alive & lvalid, right.alive & rvalid,
                                  lvalid, rvalid)
            if out is not None:
                return out

        key_data = []
        for lc, rc in zip(lkeys, rkeys):
            ld, rd = _joinable_pair(lc, rc)
            key_data.append(torch.cat([ld, rd]))
        match_alive = torch.cat([left.alive & lvalid, right.alive & rvalid])
        ones = torch.ones(lcap + rcap, dtype=torch.bool, device=self.device)
        gid, _ = self._dense_rank(key_data, [ones] * len(key_data),
                                  match_alive)
        l_gid, r_gid = gid[:lcap], gid[lcap:]
        _, perm_r = kernels.build_side(
            torch.where(match_alive[lcap:], r_gid, torch.iinfo(_I32).max),
            right.alive & rvalid)
        lo, cnt = kernels.probe_counts_by_gid(
            r_gid, right.alive & rvalid, l_gid, left.alive & lvalid,
            gid_cap=lcap + rcap)

        if kind in ("semi", "anti") and node.residual is None:
            matched = cnt > 0
            if kind == "semi":
                alive = left.alive & matched
            elif node.null_aware:
                build_has_null = bool(self._decide(
                    (right.alive & ~rvalid).any()))
                alive = torch.zeros(lcap, dtype=torch.bool,
                                    device=self.device) if build_has_null \
                    else left.alive & lvalid & ~matched
            else:
                alive = left.alive & ~matched
            return self._maybe_compact(
                DTable(list(node.out_names), left.cols, alive))

        if kind in ("semi", "anti"):
            # residual semi/anti: expand, evaluate, reduce to a left-row flag
            combined, left_idx, _ = self._expand_combine(
                node, left, right, lo, cnt, perm_r, residual=node.residual)
            hit = _ck.seg_reduce_plain(
                combined.alive.to(_I32),
                torch.where(combined.alive, left_idx, lcap), lcap,
                "sum") > 0
            alive = left.alive & hit if kind == "semi" \
                else left.alive & ~hit
            return self._maybe_compact(
                DTable(list(node.out_names), left.cols, alive))

        inner, left_idx, right_rows = self._expand_combine(
            node, left, right, lo, cnt, perm_r, residual=node.residual)
        if kind == "inner":
            return self._maybe_compact(inner)
        matched_left = _ck.seg_reduce_plain(
            inner.alive.to(_I32), torch.where(inner.alive, left_idx, lcap),
            lcap, "sum") > 0
        unmatched_l = left.alive & ~matched_left
        pieces = [inner, _null_extend(left, right, unmatched_l,
                                      names=list(node.out_names),
                                      right_side=True)]
        if kind == "full":
            matched_right = torch.zeros(rcap + 1, dtype=torch.bool,
                                        device=self.device)
            matched_right[torch.where(inner.alive, right_rows,
                                      rcap).long()] = True
            unmatched_r = right.alive & ~matched_right[:rcap]
            pieces.append(_null_extend(right, left, unmatched_r,
                                       names=list(node.out_names),
                                       right_side=False))
        return _concat_dtables(pieces, list(node.out_names))

    @staticmethod
    def _combined_names(node: JoinNode, ncols: int) -> list[str]:
        return list(node.out_names) if len(node.out_names) == ncols \
            else [f"__c{i}" for i in range(ncols)]

    def _apply_residual(self, residual, out: DTable) -> DTable:
        if residual is None:
            return out
        mask = self._eval(residual, out)
        return DTable(out.names, out.cols,
                      kernels.filter_alive(out.alive, mask.data, mask.valid))

    def _fast_join(self, node: JoinNode, left: DTable, right: DTable,
                   lkey: DCol, rkey: DCol, l_ok, r_ok, lvalid, rvalid):
        """Direct-address single-key join against a unique build side:
        build-row indices scatter into a table addressed by (key - min_key);
        the probe is one gather plus a key-equality confirm. Taken when the
        build keys are unique and their range is bounded; None otherwise."""
        kind = node.kind
        lcap, rcap = left.capacity, right.capacity
        ld, rd = _joinable_pair(lkey, rkey)
        if not _is_int(rd):
            return None    # float keys: no address arithmetic
        limit = min(4 * rcap, 1 << 24)
        info = torch.iinfo(rd.dtype)
        rmin = torch.where(r_ok, rd, info.max).min()
        rmax = torch.where(r_ok, rd, info.min).max()
        cnt_r = r_ok.sum()
        span_ok = (rmax - rmin) < limit
        lut_idx = torch.clamp(rd - rmin, 0, limit - 1)
        scatter_idx = torch.where(r_ok, lut_idx, limit).long()
        hist = torch.zeros(limit + 1, dtype=_I32, device=self.device)
        hist.index_add_(0, scatter_idx, torch.ones_like(scatter_idx,
                                                        dtype=_I32))
        unique = hist[:limit].max() <= 1
        if not self._decide(span_ok & unique & (cnt_r > 0)):
            return None
        lut = torch.full((limit + 1,), -1, dtype=_I32, device=self.device)
        lut[scatter_idx] = self._iota(rcap)
        lut = lut[:limit]
        pidx = ld - rmin
        in_range = (pidx >= 0) & (pidx < limit)
        r_row = lut[torch.clamp(pidx, 0, limit - 1).long()]
        safe_r = torch.clamp(r_row, 0, rcap - 1)
        # key-equality confirm: correctness never rests on range arithmetic
        matched = l_ok & in_range & (r_row >= 0) & (rd[safe_r.long()] == ld)

        if kind in ("semi", "anti") and node.residual is None:
            if kind == "semi":
                alive = left.alive & matched
            elif node.null_aware:
                build_has_null = bool(self._decide(
                    (right.alive & ~rvalid).any()))
                alive = torch.zeros(lcap, dtype=torch.bool,
                                    device=self.device) if build_has_null \
                    else left.alive & lvalid & ~matched
            else:
                alive = left.alive & ~matched
            return self._maybe_compact(
                DTable(list(node.out_names), left.cols, alive))

        rcols = _gather_cols(right.cols, safe_r)
        names = self._combined_names(node, len(left.cols) + len(rcols))
        combined = DTable(names, list(left.cols) + rcols, left.alive)
        if node.residual is not None:
            mask = self._eval(node.residual, combined)
            matched = matched & mask.data.to(torch.bool) & mask.valid

        if kind == "semi":
            return self._maybe_compact(DTable(
                list(node.out_names), left.cols, left.alive & matched))
        if kind == "anti":
            return self._maybe_compact(DTable(
                list(node.out_names), left.cols, left.alive & ~matched))
        if kind == "inner":
            return self._maybe_compact(DTable(
                combined.names, combined.cols, left.alive & matched))
        # left join: 1:1 — unmatched probe rows keep a NULL right side
        out_cols = list(left.cols) + [
            dataclasses.replace(
                c, data=torch.where(matched, c.data,
                                    torch.zeros_like(c.data)),
                valid=c.valid & matched) for c in rcols]
        return DTable(list(node.out_names), out_cols, left.alive)

    def _expand_combine(self, node: JoinNode, left: DTable, right: DTable,
                        lo, cnt, perm_r, residual=None):
        """Materialize matched pairs; returns (combined, left_idx,
        right_rows), all padded to the planned output capacity."""
        total = self._decide(cnt.to(_I64).sum())
        cap_out = bucket(max(total, 1))
        left_idx, build_pos, alive_out = kernels.expand_join(
            lo, cnt, left.alive, cap_out)
        right_rows = perm_r[torch.clamp(build_pos, 0,
                                        right.capacity - 1).long()]
        cols = _gather_cols(left.cols, left_idx) + \
            _gather_cols(right.cols, right_rows)
        out = DTable(self._combined_names(node, len(cols)), cols, alive_out)
        out = self._apply_residual(residual, out)
        return out, left_idx, right_rows


def _is_int(t: torch.Tensor) -> bool:
    return not t.dtype.is_floating_point and t.dtype != torch.bool


# -- expression utilities -----------------------------------------------------

def _shift_residual(expr: BExpr, nl: int, nr: int) -> BExpr:
    """Rebase bound column indices from [left|right] to [right|left]."""
    if isinstance(expr, BCol):
        idx = expr.index + nr if expr.index < nl else expr.index - nl
        return dataclasses.replace(expr, index=idx)
    if isinstance(expr, BCall):
        return dataclasses.replace(
            expr, args=[_shift_residual(a, nl, nr) for a in expr.args])
    return expr


# -- column utilities --------------------------------------------------------

def _gather_cols(cols: list, idx: torch.Tensor) -> list:
    """Gather EVERY column of a table by one index vector (the join / sort
    / compaction shape): the data and validity tensors of all columns ride
    one batched gather (kernels.gather_many)."""
    arrays: list = []
    for c in cols:
        arrays.append(c.data)
        arrays.append(c.valid)
    flat = kernels.gather_many(arrays, idx)
    return [dataclasses.replace(c, data=flat[2 * i], valid=flat[2 * i + 1])
            for i, c in enumerate(cols)]


def _joinable_pair(a: DCol, b: DCol):
    """Comparable device key tensors for a join key pair."""
    if a.dtype == "str" or b.dtype == "str":
        return exprs.string_pair_keys(a, b)
    da, db = a.canon().data, b.canon().data
    if da.dtype != db.dtype:
        ct = torch.promote_types(da.dtype, db.dtype)
        da, db = da.to(ct), db.to(ct)
    return da, db


def _null_col(c: DCol, n: int, device) -> DCol:
    return DCol(c.dtype, torch.zeros(n, dtype=c.data.dtype, device=device),
                torch.zeros(n, dtype=torch.bool, device=device), c.dictionary)


def _grouping_id_col(node: AggregateNode, kept, cap_out: int,
                     device) -> DCol:
    kept = set(kept)
    ng = len(node.group_exprs)
    gid_val = sum(1 << (ng - 1 - i) for i in range(ng) if i not in kept)
    return DCol("int", torch.full((cap_out,), gid_val, dtype=_I64,
                                  device=device),
                torch.ones(cap_out, dtype=torch.bool, device=device))


def _null_extend(keep: DTable, other: DTable, mask: torch.Tensor,
                 names: list[str], right_side: bool) -> DTable:
    """Rows of `keep` selected by mask with `other`'s columns all NULL,
    placed on the right (right_side) or on the left (full outer join)."""
    nulls = [_null_col(c, keep.capacity, c.data.device) for c in other.cols]
    kept = list(keep.cols)
    cols = kept + nulls if right_side else nulls + kept
    return DTable(names, cols, mask)


def _concat_dtables(pieces: list[DTable], names: list[str]) -> DTable:
    """Row-concatenate device tables (merging string dictionaries on the
    host)."""
    out_cols: list[DCol] = []
    for ci in range(len(pieces[0].cols)):
        cols = [p.cols[ci] for p in pieces]
        valid = torch.cat([c.valid for c in cols])
        if cols[0].dtype == "str":
            dictionary, datas = exprs.merge_branch_strings(cols)
            out_cols.append(DCol("str", torch.cat(datas), valid, dictionary))
        else:
            pd = cols[0].data.dtype
            out_cols.append(DCol(cols[0].dtype,
                                 torch.cat([c.data.to(pd) for c in cols]),
                                 valid))
    return DTable(names, out_cols, torch.cat([p.alive for p in pieces]))
