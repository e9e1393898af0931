"""Device plan executor: walks a bound plan over DTables (torch tensors).

Counterpart of ``nds_tpu/engine/jax_backend/executor.py`` (``JaxExecutor``):
each node runs as torch compute over padded buffers with an alive-row mask.
A query's units go through the reference's lifecycle (``run_query``): the
first run is eager and records every host decision, the capacity schedule
(row counts sync to the host only where a capacity or a branch is chosen);
the second replays the plan against that schedule and, on the card,
captures the replay as a CUDA graph (compiled.CompiledQuery); every later
run replays the graph. Big plans split at CTE and rollup boundaries into
units that hand device-resident tables to each other (``_segment_plan``).
Scanned tables stay resident on the device across queries, within
``scan_budget_bytes``.

An eager node the device path does not cover raises NotImplementedError
and falls back to the numpy host executor for that node only
(``fallback_nodes`` names it), as in the reference; such a unit is never
replayed. On CUDA the executor runs all its work on a stream of its own,
the one its graphs are captured on.

The streamed path (engine/session.py) records a morsel group's plans with
``record_plans`` and replays them from one morsel slot; the slot's scan
key is kept out of the resident-scan budget and is never loaded here. A
packed slot unpacks inside the program (``_run_scan``); its narrow int32
columns widen and its dictionary codes decode only where values are
needed (``widen_col`` at aggregate and window arguments, ``decode_col``
where group keys are output), and join keys stay on codes
(``_joinable_pair``).

The query service batches compatible queries (one plan fingerprint, other
hoisted literals) through ``run_param_batch``: one program over stacked
parameter slots (compiled.BatchedQuery), on the card one CUDA graph per
(program, batch capacity).

Not in this slice: mesh execution.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Callable, Optional

import numpy as np
import torch

from ..column import Table, dec_scale, is_dec
from ..executor import Executor as HostExecutor
from ..executor import load_columns
from ..plan import (AggregateNode, AggSpec, BCall, BCol, BExpr, DistinctNode,
                    FilterNode, JoinNode, LimitNode, MaterializedNode,
                    PlanNode, ProjectNode, ScanNode, SetOpNode, SortNode,
                    VirtualScanNode, WindowFunc, WindowNode,
                    deparameterize_plan, iter_plan_nodes, parameterize_plan,
                    replace_plan_nodes)
from ...obs import metrics as _metrics
from ...obs.profile import DEVICE_MEM
from ...resilience import FAULTS
from ..streaming import MORSEL_TABLE
from . import compiled as _cq
from . import cuda_kernels as _ck
from . import exprs, kernels
from .compiled import (NOJIT_ERRORS, BatchedQuery, CompiledQuery,
                       NotJittable, Recorder, ReplayMismatch,
                       check_abandoned)
from .device import (DCol, DTable, PackedTable, bucket, decode_col,
                     encode_against, lut_gather, phys_dtype, rank_key,
                     scan_layout, string_rank_maps, to_device, to_host,
                     unpack_table, widen_col)

_I32 = torch.int32
_I64 = torch.int64
_F64 = torch.float64


class TorchExecutor:
    """Executes bound plans on the torch backend with per-node host
    fallback. One instance lives on the Session (scan cache and compiled
    units persist across the query stream); a replay instance is made per
    replay, with a replay Recorder, the unit's scans and its parameters."""

    def __init__(self, load_table: Callable, device,
                 gpu_kernels=_ck.VALID_OPS,
                 recorder: Optional[Recorder] = None,
                 scan_tables: Optional[dict] = None,
                 params: Optional[tuple] = None,
                 jit_plans: bool = True,
                 segment_plan_nodes: int = 18,
                 segment_min_cte_nodes: int = 8,
                 segment_cache_entries: int = 16,
                 scan_budget_bytes: int = 40 << 30):
        self._load_table = load_table
        self.device = torch.device(device)
        self.gpu_ops = _ck.parse_ops(gpu_kernels)
        self._memo: dict[int, DTable] = {}
        # device-resident scans and segment outputs, by key
        self._scan_cache: dict[str, DTable] = scan_tables \
            if scan_tables is not None else {}
        self.fallback_nodes: list[str] = []
        self._rec = recorder
        self._replay = recorder is not None and recorder.mode == "replay"
        # hoisted literal values of the execution in flight: python
        # scalars when eager, 0-d device tensors (parameter slots) under
        # replay
        self._params = params
        self._jit_plans = jit_plans
        self._plans: dict = {}           # unit key -> schedule entry
        self._touched_scans: dict[str, None] = {}   # first-touch order
        self._scan_meta: dict[str, tuple] = {}   # key -> (table, cols, names)
        self._cur_node = None            # the plan node executing
        self._last_record_nodes: Optional[list] = None
        self.last_stats: dict = {}
        # label of the query in flight ("<query>/<unit>" program labels)
        self.query_label: str = ""
        # CTE and rollup segmentation of big plans into units
        self._seg_plan_nodes = segment_plan_nodes
        self._seg_min_cte = segment_min_cte_nodes
        self._seg_cache_entries = segment_cache_entries
        self._segment_lru: list[str] = []
        self._pinned_segments: set[str] = set()
        # device bytes of each resident entry in LRU order; the least
        # recently used unpinned entries leave past the budget
        self._scan_budget = scan_budget_bytes
        self._resident: dict[str, int] = {}
        # the fingerprint whose shared schedule just mismatched here: the
        # record that follows must not adopt it again
        self._fp_block: Optional[str] = None
        # batched programs of the query service: (fingerprint, batch
        # capacity) -> BatchedQuery
        self._batched: dict = {}
        # resident entries as DEVICE_MEM leaves: key -> (leaf id, bytes)
        self._mem_leaves: dict = {}
        self._stream = None
        self._pool = None
        # set by abandon(): a deadline gave up the statement running here
        self.abandoned = False

    def abandon(self) -> None:
        """A deadline gave up the statement running on this executor (its
        worker thread cannot be killed): the worker stops at its next plan
        node, program run or capture (StatementAbandoned), and the session
        runs later statements on a fresh executor."""
        self.abandoned = True

    # -- the CUDA stream and graph pool ---------------------------------------
    @property
    def stream(self):
        """The executor's CUDA stream: eager runs, captures and replays are
        serial on it (a capture needs a stream other than the default)."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def on_stream(self):
        """Context that makes the executor's stream current (nothing on the
        CPU)."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def graph_pool(self):
        """One memory pool for all this executor's graphs: replays are
        serial on one stream and every run consumes its outputs (copied to
        the host, or cloned out of the pool) before the next."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    # -- public --------------------------------------------------------------
    def run_query(self, key, plan_factory: Callable[[], PlanNode]) -> DTable:
        """Session entry point: record -> compile -> replay per unit.

        key: hashable query identity (("sql", text)); None disables the
        lifecycle (every run eager). The plan factory runs on the first
        sighting only: the units are kept. Large plans segment at CTE and
        rollup boundaries (_segment_plan); each segment materializes once
        as a device-resident table shared by later units and statements.
        On CUDA the caller converts the result inside ``on_stream()``."""
        self.fallback_nodes = []
        self.last_stats = {}
        if not self._jit_plans:
            key = None          # eager, whatever an earlier run compiled
        meta_key = ("segmeta", key) if key is not None else None
        meta = self._plans.get(meta_key) if meta_key is not None else None
        if meta is None:
            plan = plan_factory()
            units = self._segment_plan(plan)
            if meta_key is not None and self._jit_plans:
                self._plans[meta_key] = {"units": units}
        else:
            units = meta["units"]
        if len(units) == 1:
            out = self._run_unit(key, units[0][1])
            self.last_stats = _unit_totals([self.last_stats],
                                           self.last_stats)
            return out
        seg_ms = 0.0
        segs_run = 0
        out = None
        unit_stats = []
        if key is not None and self._jit_plans:
            self._prepare_units(
                [(key, "root") if sk is None else (key, sk)
                 for sk, _ in units
                 if sk is None or sk not in self._scan_cache])
        # pin this query's segments: binding segment N must never evict
        # segment M that a later unit still reads
        self._pinned_segments = {sk for sk, _ in units if sk is not None}
        try:
            for seg_key, uplan in units:
                self.last_stats = {}     # per-unit stats
                if seg_key is None:
                    root_key = (key, "root") if key is not None else None
                    out = self._run_unit(root_key, uplan)
                elif seg_key in self._scan_cache:
                    self._touch_segment(seg_key)
                    continue
                else:
                    unit_key = (key, seg_key) if key is not None else None
                    seg_out = self._run_unit(unit_key, uplan,
                                             keep_device=True)
                    self._bind_segment(seg_key, seg_out)
                    segs_run += 1
                    seg_ms += self.last_stats.get("device_ms", 0.0)
                unit_stats.append(self.last_stats)
        finally:
            self._pinned_segments = set()
        root_stats = _unit_totals(unit_stats, self.last_stats)
        root_stats.update(segments=len(units) - 1, segments_run=segs_run,
                          seg_device_ms=round(seg_ms, 3))
        self.last_stats = root_stats
        return out

    def _prepare_units(self, unit_keys: list) -> None:
        """Second sighting of a multi-unit query: compile every unit that
        has a schedule but no program before any of them runs (the
        reference's precompile_parallel call; serial, and only for the
        units this run executes)."""
        for k in unit_keys:
            self._prepare_unit(k)

    def _prepare_unit(self, k) -> Optional[str]:
        """Compile one recorded unit ahead of its next run: "compiled";
        "nojit" (it cannot replay); "skipped: ReplayMismatch" (its scans
        are gone: its own run compiles it); None: nothing to compile."""
        ent = self._plans.get(k)
        if not isinstance(ent, dict) or "decisions" not in ent or \
                ent["cq"] is not None or ent["nojit"]:
            return None
        cq = CompiledQuery(ent["plan"], ent["decisions"], ent["scan_keys"],
                           self, param_dtypes=ent.get("param_dtypes", ()),
                           label=ent.get("label", self._unit_label(k)),
                           decision_nodes=ent.get("decision_nodes"))
        try:
            cq.prepare(self._scans_for(ent), ent.get("params", ()))
        except NOJIT_ERRORS as e:
            ent["nojit"] = True
            ent["nojit_reason"] = f"{type(e).__name__}: {e}"
            return "nojit"
        except ReplayMismatch:
            return "skipped: ReplayMismatch"
        ent["cq"] = cq
        self._publish_cq(ent)
        return "compiled"

    def precompile_parallel(self) -> dict:
        """Compile every recorded, uncompiled unit entry ahead of its next
        run (the reference's cold-start pass after a stream's record-all
        pass, ``JaxExecutor.precompile_parallel``).

        On the card a unit's compile is its first replay and its CUDA
        graph's capture (CompiledQuery.prepare), which runs the unit on
        the device and needs its inputs: a multi-unit query's units go in
        dependency order, and a segment whose output has left the cache
        (the segment LRU, the scan budget) runs again, compiled, so that
        the units after it find it. The entries go serially, on this
        executor's stream: the reference compiles on several threads to
        overlap the round trips of a remote compile service, and several
        captures at once on one card buy nothing.

        Returns {key: "compiled"|"nojit"|"skipped: <error>"}; a unit that
        fails otherwise is skipped, as in the reference, and its own next
        run compiles it."""
        results: dict = {}

        def one(k, run=None):
            try:
                status = run() if run is not None else self._prepare_unit(k)
            except Exception as e:
                status = f"skipped: {type(e).__name__}"
            if status is not None:
                results[k] = status

        with self.on_stream():
            for mkey, meta in list(self._plans.items()):
                if not (isinstance(mkey, tuple) and mkey[0] == "segmeta"
                        and len(meta["units"]) > 1):
                    continue
                qkey, units = mkey[1], meta["units"]
                self._pinned_segments = {sk for sk, _ in units
                                         if sk is not None}
                try:
                    for sk, uplan in units:
                        ukey = (qkey, "root" if sk is None else sk)
                        results.setdefault(ukey, None)
                        if sk is not None and sk not in self._scan_cache:
                            one(ukey, lambda: self._rerun_segment(
                                ukey, sk, uplan))
                        else:
                            one(ukey)
                finally:
                    self._pinned_segments = set()
            for k in list(self._plans):
                if k not in results:
                    one(k)
        return {k: v for k, v in results.items() if v is not None}

    def _rerun_segment(self, ukey, seg_key: str, uplan) -> Optional[str]:
        """A segment unit whose output has left the cache: run it through
        its lifecycle (a recorded one compiles at this, its second
        sighting) and bind its output for the units after it."""
        ent = self._plans.get(ukey)
        todo = isinstance(ent, dict) and ent["cq"] is None and \
            not ent["nojit"]
        self.last_stats = {}
        self._bind_segment(seg_key, self._run_unit(ukey, uplan,
                                                   keep_device=True))
        if not todo:
            return None
        ent = self._plans.get(ukey)
        if ent is None or ent["nojit"]:
            return "nojit"
        return "compiled" if ent["cq"] is not None else "skipped: record"

    # -- segmentation ---------------------------------------------------------
    def _segment_plan(self, plan: PlanNode) -> list:
        """Split a big plan into [(seg_key, unit_plan)...] + [(None, root)]:
        at CTE boundaries (planner-fingerprinted, shared across statements)
        and at rollup grouping-set boundaries. Units are in dependency
        order; a later unit sees earlier outputs as VirtualScanNodes
        resolved against the segment cache."""
        if not self._jit_plans or self._seg_plan_nodes <= 0:
            return [(None, plan)]
        out = []
        for seg_key, uplan in self._cte_units(plan):
            out.extend(self._rollup_units(seg_key, uplan))
        return out

    def _cte_units(self, plan: PlanNode) -> list:
        segs = getattr(plan, "cte_segments", None)
        if not segs:
            return [(None, plan)]
        nodes = list(iter_plan_nodes(plan))
        if len(nodes) < self._seg_plan_nodes:
            return [(None, plan)]
        reachable = {id(n) for n in nodes}
        mapping: dict[int, PlanNode] = {}
        units: list = []
        seen_keys: set[str] = set()
        for fp, node in segs:
            if id(node) not in reachable:
                continue
            if sum(1 for _ in iter_plan_nodes(node)) < self._seg_min_cte:
                continue
            seg_key = "seg:" + fp
            virt = VirtualScanNode(key=seg_key, label="cte",
                                   out_names=list(node.out_names),
                                   out_dtypes=list(node.out_dtypes))
            if seg_key not in seen_keys:
                seen_keys.add(seg_key)
                units.append((seg_key,
                              replace_plan_nodes(node, mapping)
                              if mapping else node))
            mapping[id(node)] = virt
        if not units:
            return [(None, plan)]
        units.append((None, replace_plan_nodes(plan, mapping)))
        return units

    def _rollup_units(self, seg_key, uplan: PlanNode) -> list:
        """Split big rollup aggregates of one unit into per-level units:
        [(child_seg, child), (level_seg, level_agg)..., (seg_key,
        rewritten)]; the rewrite unions the per-level VirtualScans, which
        is the concat the in-unit rollup performs."""
        nodes = list(iter_plan_nodes(uplan))
        if len(nodes) < self._seg_plan_nodes:
            return [(seg_key, uplan)]
        units: list = []
        mapping: dict[int, PlanNode] = {}
        cands = [n for n in nodes
                 if isinstance(n, AggregateNode) and n.rollup
                 and n.rollup_levels is None and len(n.group_exprs) >= 2]
        # innermost first: a rollup nested in another rollup's child is
        # rewritten before the outer child unit is cut
        cands.sort(key=lambda a: sum(1 for _ in iter_plan_nodes(a)))
        for orig in cands:
            child_nodes = list(iter_plan_nodes(orig.child))
            if len(child_nodes) < self._seg_min_cte or \
                    any(isinstance(m, MaterializedNode) for m in child_nodes):
                continue
            child = replace_plan_nodes(orig.child, mapping) if mapping \
                else orig.child
            agg = dataclasses.replace(orig, child=child) if child \
                is not orig.child else orig
            ckey = "seg:" + _cq.plan_fingerprint(child)
            virt_child = VirtualScanNode(
                key=ckey, label="rollup-src",
                out_names=list(child.out_names),
                out_dtypes=list(child.out_dtypes))
            units.append((ckey, child))
            branches: list[PlanNode] = []
            for lvl in range(len(agg.group_exprs), -1, -1):
                lnode = dataclasses.replace(agg, child=virt_child,
                                            rollup_levels=[lvl])
                lkey = "seg:" + _cq.plan_fingerprint(lnode)
                units.append((lkey, lnode))
                branches.append(VirtualScanNode(
                    key=lkey, label=f"rollup-lvl{lvl}",
                    out_names=list(agg.out_names),
                    out_dtypes=list(agg.out_dtypes)))
            chain = branches[0]
            for v in branches[1:]:
                chain = SetOpNode(op="union", all=True, left=chain, right=v,
                                  out_names=list(agg.out_names),
                                  out_dtypes=list(agg.out_dtypes))
            mapping[id(orig)] = chain     # keyed by the ORIGINAL node id
        if not mapping:
            return [(seg_key, uplan)]
        return units + [(seg_key, replace_plan_nodes(uplan, mapping))]

    def _bind_segment(self, seg_key: str, out: DTable) -> None:
        """Stash a segment output for downstream units; LRU-bounded."""
        self._scan_cache[seg_key] = out
        self._account_resident(seg_key, out)
        self._touch_segment(seg_key)

    def _touch_segment(self, seg_key: str) -> None:
        if seg_key in self._segment_lru:
            self._segment_lru.remove(seg_key)
        self._segment_lru.append(seg_key)
        evictable = [k for k in self._segment_lru
                     if k not in self._pinned_segments]
        while len(self._segment_lru) > self._seg_cache_entries and evictable:
            old = evictable.pop(0)
            self._segment_lru.remove(old)
            # torch frees the buffers once the last reference is gone
            self._scan_cache.pop(old, None)
            self._resident.pop(old, None)
        self._sync_mem()

    def _unit_label(self, key) -> str:
        """"<query>/<unit>" label of a unit (segments keep a short
        fingerprint)."""
        base = self.query_label or "query"
        if isinstance(key, tuple) and len(key) == 2 and \
                isinstance(key[1], str):
            if key[1].startswith("seg:"):
                return f"{base}/{key[1][:12]}"
            if key[1] == "root":
                return f"{base}/root"
        return base

    # -- the unit lifecycle ---------------------------------------------------
    def _run_unit(self, key, plan: PlanNode,
                  keep_device: bool = False) -> DTable:
        """One unit through record -> compile+run -> compiled."""
        fb0 = len(self.fallback_nodes)
        ent = self._plans.get(key) if key is not None else None
        if ent is not None:
            if ent["nojit"]:
                self.last_stats["mode"] = "eager"
                if ent.get("nojit_reason"):
                    self.last_stats["nojit_reason"] = ent["nojit_reason"]
                return self._eager_ent(ent)
            cq = ent["cq"]
            if cq is None:                          # second sighting
                cq = CompiledQuery(ent["plan"], ent["decisions"],
                                   ent["scan_keys"], self,
                                   param_dtypes=ent.get("param_dtypes", ()),
                                   label=ent.get("label",
                                                 self._unit_label(key)),
                                   decision_nodes=ent.get("decision_nodes"))
            try:
                out = self._run_compiled(cq, ent, keep_device)
            except NOJIT_ERRORS as e:
                ent["cq"] = None
                ent["nojit"] = True
                ent["nojit_reason"] = f"{type(e).__name__}: {e}"
                self.last_stats["mode"] = "eager"
                self.last_stats["nojit_reason"] = ent["nojit_reason"]
                return self._eager_ent(ent)
            except ReplayMismatch as e:
                # the schedule no longer fits: record again (the reason
                # stays in the stats)
                self.last_stats["replay_mismatch"] = str(e)[:300]
                _cq.strike_shared_program(ent.get("fp"),
                                          reason="ReplayMismatch")
                self._fp_block = ent.get("fp")
                self._plans.pop(key, None)
            else:
                if ent["cq"] is None:
                    ent["cq"] = cq
                    self._publish_cq(ent)
                _cq.absolve_shared_program(ent.get("fp"))
                return out
        # first sighting (or invalidated): eager run, recording the schedule
        fp = None
        if key is not None and self._jit_plans:
            pplan, pvalues, pdtypes = parameterize_plan(plan)
            fp = _cq.shared_fingerprint(pplan, self.gpu_ops,
                                        self._scan_layouts(pplan))
            if self._adopt_shared(key, fp, tuple(pvalues), tuple(pdtypes)):
                out = self._run_unit(key, plan, keep_device)
                run = self.last_stats.get("mode")
                if run in ("compile+run", "compiled"):
                    # (a schedule that did not fit was recorded again)
                    self.last_stats.update(mode="adopted", adopted_run=run)
                return out
        else:       # uncached one-shot: nothing reuses the rewrite
            pplan, pvalues, pdtypes = plan, [], []
        self.last_stats["mode"] = "record"
        out, decisions, scan_keys = self.record_plan(pplan, tuple(pvalues))
        labels = self._decision_labels(pplan)
        if labels:
            rows = _cq.node_rows(decisions, labels,
                                 [v for _k, v in decisions])
            if rows:
                self.last_stats["node_rows"] = rows
        if key is not None and self._jit_plans:
            nojit = len(self.fallback_nodes) > fb0
            ent = {"plan": pplan, "decisions": decisions,
                   "scan_keys": scan_keys,
                   "params": tuple(pvalues), "param_dtypes": tuple(pdtypes),
                   "decision_nodes": labels, "cq": None, "nojit": nojit,
                   "nojit_reason": "host fallback: " + "; ".join(
                       self.fallback_nodes[fb0:]) if nojit else None,
                   "fp": fp, "label": self._unit_label(key)}
            self._publish_recorded(ent)
            self._plans[key] = ent
            self._fp_block = None
        return out

    def _scan_layouts(self, plan: PlanNode) -> tuple:
        """The wire layouts of a plan's morsel scans held in the scan
        cache (device.scan_layout), in plan order."""
        return tuple(scan_layout(self._scan_cache.get(
            n.table + "//" + ",".join(n.columns)))
            for n in iter_plan_nodes(plan)
            if isinstance(n, ScanNode) and n.table == MORSEL_TABLE)

    def _decision_labels(self, pplan) -> Optional[tuple]:
        """Per-decision TypeName#k labels of the schedule just recorded;
        None when no decision has row semantics."""
        nodes = self._last_record_nodes
        if not nodes or all(n is None for n in nodes):
            return None
        labs = _cq.node_labels(pplan)
        return tuple(labs.get(id(n)) if n is not None else None
                     for n in nodes)

    # -- cross-stream program sharing ----------------------------------------
    def _adopt_shared(self, key, fp, pvalues: tuple, pdtypes: tuple) -> bool:
        """Install another stream's schedule for `key` (and its program when
        this executor captured it)."""
        if fp is None or fp == self._fp_block:
            return False
        with _cq._SHARED_LOCK:
            sh = _cq._SHARED_PROGRAMS.get(fp)
            if sh is None or sh.get("volatile") or sh.get("nojit") \
                    or sh.get("param_dtypes") != pdtypes:
                return False
            sh["adoptions"] = sh.get("adoptions", 0) + 1
            _metrics.PROGRAMS_ADOPTED.inc()
            ent = {"plan": sh["plan"], "decisions": list(sh["decisions"]),
                   "scan_keys": sh["scan_keys"], "params": pvalues,
                   "param_dtypes": pdtypes,
                   "cq": _cq.shared_program(sh, self),
                   "decision_nodes": sh.get("decision_nodes"),
                   "nojit": False, "fp": fp}
            scan_meta = dict(sh["scan_meta"])
        for k, v in scan_meta.items():
            self._scan_meta.setdefault(k, v)
        self._plans[key] = ent
        return True

    def _publish_recorded(self, ent) -> None:
        """Publish a freshly recorded schedule; cap-merge with any previous
        stream's so the eventual program serves every stream seen so far."""
        fp = ent.get("fp")
        if fp is None:
            return
        entry = {"plan": ent["plan"], "decisions": list(ent["decisions"]),
                 "scan_keys": ent["scan_keys"],
                 "param_dtypes": ent.get("param_dtypes", ()),
                 "decision_nodes": ent.get("decision_nodes"),
                 "scan_meta": {k: self._scan_meta[k]
                               for k in ent["scan_keys"]
                               if k in self._scan_meta},
                 "cq": None, "nojit": ent.get("nojit", False)}
        with _cq._SHARED_LOCK:
            old = _cq._SHARED_PROGRAMS.get(fp)
            if old is not None and old.get("volatile"):
                return   # proven stream-dependent: stays per-stream
            if old is not None \
                    and len(old["decisions"]) == len(entry["decisions"]):
                pairs = list(zip(old["decisions"], entry["decisions"]))
                if any(k1 != k2 for (k1, _), (k2, _) in pairs):
                    entry["volatile"] = True
                elif any(k == "exact" and v1 != v2
                         for (k, v1), (_, v2) in pairs):
                    # structure differs per stream: sharing would replay
                    # the wrong branch
                    entry["volatile"] = True
                else:
                    merged = [(k, max(v1, v2) if k == "cap" else v1)
                              for (k, v1), (_, v2) in pairs]
                    cq = _cq.shared_program(old, self)
                    if merged == old["decisions"] and cq is not None:
                        ent["decisions"] = list(merged)
                        ent["cq"] = cq
                        return          # its program already covers this
                    entry["decisions"] = merged
                    ent["decisions"] = list(merged)
            elif old is not None:
                entry["volatile"] = True
            _cq._SHARED_PROGRAMS[fp] = entry

    def _publish_cq(self, ent) -> None:
        """Publish a compiled program for adoption by other streams."""
        fp = ent.get("fp")
        if fp is None or ent.get("cq") is None:
            return
        with _cq._SHARED_LOCK:
            sh = _cq._SHARED_PROGRAMS.get(fp)
            if sh is not None and not sh.get("volatile") \
                    and (sh.get("cq") is None or sh["cq"]() is None) \
                    and sh["decisions"] == ent["decisions"]:
                sh["cq"] = weakref.ref(ent["cq"])
                sh["compiles"] = sh.get("compiles", 0) + 1

    def evict_fp(self, fp: Optional[str]) -> int:
        """Drop every local unit entry (and batched program) published
        under shared fingerprint `fp`: the quarantine's follow-through,
        after strike_shared_program evicted the shared entry, so that the
        next sighting records and publishes afresh. Returns the entries
        dropped. Called on the device lane, under the session's statement
        lock."""
        if fp is None:
            return 0
        gone = [k for k, ent in self._plans.items()
                if isinstance(ent, dict) and ent.get("fp") == fp]
        for k in gone:
            del self._plans[k]
        for k in [k for k in self._batched if k[0] == fp]:
            del self._batched[k]
        return len(gone)

    # -- compatible-plan batching (the query service) -------------------------
    def run_param_batch(self, fp: Optional[str], rows: list
                        ) -> Optional[list]:
        """Serve several compatible parameterized queries (one shared
        fingerprint, other hoisted literal values: `rows`) through one
        batched dispatch (BatchedQuery). Returns one host DTable per row,
        or None when batching is unavailable (no live program published
        under `fp` yet, a volatile or nojit entry, a plan without
        parameters, jit_plans off): the caller then serves each query
        through the unit lifecycle. Raises ReplayMismatch when a row's
        data drift past the schedule.

        A captured program reads its own executor's scans, so the batch
        runs over this executor's program; where the published program is
        another executor's, this one builds its own from the shared
        schedule, as adoption does. The rows run as full rungs of the
        capacity ladder (compiled.batch_rungs: five rows as a batched graph
        of four and one of one), each (fp, capacity) its own BatchedQuery
        over the one program; ``last_stats["graphs"]`` holds each rung's
        figures."""
        if fp is None or not self._jit_plans or not rows:
            return None
        with _cq._SHARED_LOCK:
            sh = _cq._SHARED_PROGRAMS.get(fp)
            if sh is None or sh.get("volatile") or sh.get("nojit") \
                    or sh.get("cq") is None or sh["cq"]() is None \
                    or not sh.get("param_dtypes"):
                return None
            own = _cq.shared_program(sh, self)
            decisions = list(sh["decisions"])
            plan, scan_keys = sh["plan"], sh["scan_keys"]
            param_dtypes = tuple(sh["param_dtypes"])
            decision_nodes = sh.get("decision_nodes")
            scan_meta = dict(sh["scan_meta"])
        if any(len(r) != len(param_dtypes) for r in rows):
            return None
        for k, v in scan_meta.items():
            self._scan_meta.setdefault(k, v)
        if own is not None and own.decisions != decisions:
            own = None
        scans = self._scans_for({"scan_keys": scan_keys})
        self.fallback_nodes = []
        caps = _cq.batch_rungs(len(rows))
        outs, graphs, device_ms = [], [], 0.0
        i = 0
        for cap in caps:
            bq = self._batched.get((fp, cap))
            if bq is None or bq.cq.decisions != decisions:
                # a program published again (a cap-merged schedule) makes
                # the batched one stale: build it over the current schedule
                if own is None:
                    own = CompiledQuery(plan, decisions, scan_keys, self,
                                        param_dtypes=param_dtypes,
                                        label=self._unit_label(None),
                                        decision_nodes=decision_nodes)
                bq = BatchedQuery(own, cap)
                self._batched[(fp, cap)] = bq
            st: dict = {}
            outs += bq.run(scans, rows[i:i + cap], stats=st)
            i += cap
            device_ms += st.pop("device_ms")
            del st["mode"], st["batch"]
            graphs.append(dict(cap=cap, **st))
        self.last_stats = {"mode": "batched", "batch_rows": len(rows),
                           "batch_caps": tuple(caps), "graphs": graphs,
                           "device_ms": round(device_ms, 3)}
        if self.device.type == "cuda":
            self.last_stats["graph_ms"] = sum(g["graph_ms"] for g in graphs)
        return outs

    # -- record / replay ------------------------------------------------------
    def record_plan(self, plan: PlanNode, params: tuple = ()):
        """Eager run that records the capacity schedule; returns (result,
        decisions, scan_keys), scan_keys in first-touch order (plan
        traversal order, the same for every stream)."""
        outs, decisions, scan_keys = self.record_plans([plan], params)
        return outs[0], decisions, scan_keys

    def record_plans(self, plans: list, params: tuple = ()):
        """Record several plans under ONE decision schedule (a shared-scan
        morsel group): the plans run in order with one recorder and the
        memo reset per plan, as CompiledQuery replays a list of plans.
        Returns (outs, decisions, scan_keys), scan_keys the union in
        first-touch order across the plans."""
        FAULTS.fire("jax.execute")
        check_abandoned(self)
        rec = Recorder("record")
        self._rec = rec
        self._touched_scans = {}
        old_params = self._params
        self._params = params
        try:
            outs = [self._eager(p) for p in plans]
        finally:
            self._rec = None
            self._params = old_params
        self._last_record_nodes = rec.nodes
        return outs, rec.decisions, tuple(self._touched_scans)

    def _run_compiled(self, cq: CompiledQuery, ent,
                      keep_device: bool = False) -> DTable:
        return cq.run(self._scans_for(ent), ent.get("params", ()),
                      stats=self.last_stats, keep_device=keep_device)

    def _eager_ent(self, ent) -> DTable:
        """Eager-run a cached entry's (parameterized) plan with its values."""
        old = self._params
        self._params = ent.get("params", ())
        try:
            return self._eager(ent["plan"])
        finally:
            self._params = old

    def _eager(self, plan: PlanNode) -> DTable:
        self._memo = {}
        return self.execute(plan)

    # -- resident accounting --------------------------------------------------
    @staticmethod
    def _dtable_bytes(t: DTable) -> int:
        tensors = [t.alive] + [x for c in t.cols for x in (c.data, c.valid)]
        return sum(x.numel() * x.element_size() for x in tensors)

    def _account_resident(self, key: str, t: DTable,
                          pinned: Optional[set] = None) -> None:
        """Track a device-resident entry; evict LRU past the budget.
        _resident mirrors _scan_cache (stale keys pruned here). A morsel
        slot is not counted: it is the streamed group's, which frees it."""
        if _is_morsel(key):
            return
        for k in [k for k in self._resident if k not in self._scan_cache]:
            del self._resident[k]
        self._resident.pop(key, None)
        self._resident[key] = self._dtable_bytes(t)
        if self._scan_budget > 0:
            pinned = (pinned or set()) | self._pinned_segments
            total = sum(self._resident.values())
            for old in list(self._resident):
                if total <= self._scan_budget:
                    break
                if old == key or old in pinned:
                    continue
                total -= self._resident.pop(old)
                # the buffers free once the last user (a running unit's
                # memo) drops them
                self._scan_cache.pop(old, None)
                if old in self._segment_lru:
                    self._segment_lru.remove(old)
        self._sync_mem()

    def _sync_mem(self) -> None:
        """Mirror the resident set into DEVICE_MEM, the accountant of the
        statements' device-memory windows (ExecStats.mem_*)."""
        gone, new = [], []
        for k in [k for k in self._mem_leaves if k not in self._resident]:
            gone.append(self._mem_leaves.pop(k))
        for k, nbytes in self._resident.items():
            t = self._scan_cache.get(k)
            leaf = (id(t.alive), nbytes) if t is not None else None
            if leaf is not None and self._mem_leaves.get(k) != leaf:
                if k in self._mem_leaves:
                    gone.append(self._mem_leaves[k])
                self._mem_leaves[k] = leaf
                new.append(leaf)
        if gone:
            DEVICE_MEM.free(gone)
        if new:
            DEVICE_MEM.add(new)

    def _scans_for(self, ent) -> dict:
        """Device-resident scan tables of a compiled run (uploaded again
        when evicted; segment outputs must still be resident)."""
        out = {}
        for k in ent["scan_keys"]:
            if k not in self._scan_cache:
                if k.startswith("seg:"):
                    raise ReplayMismatch(f"segment output miss: {k}")
                if _is_morsel(k):     # never loaded from the big table
                    raise RuntimeError(f"morsel slot {k!r} not staged")
                if k not in self._scan_meta:
                    raise ReplayMismatch(f"scan meta miss: {k}")
                table, columns, names = self._scan_meta[k]
                self._scan_cache[k] = self._load_scan(table, columns, names)
            out[k] = self._scan_cache[k]
        pinned = set(ent["scan_keys"])
        for k in ent["scan_keys"]:
            self._account_resident(k, out[k], pinned)
        return out

    def _load_scan(self, table: str, columns, names) -> DTable:
        t = load_columns(self._load_table, table, columns)
        index = {n: i for i, n in enumerate(t.names)}
        cols = [t.columns[index[c]] for c in columns]
        return to_device(Table(list(names), cols), self.device)

    def execute(self, node: PlanNode) -> DTable:
        # install this executor's kernel choice for every kernel below
        _ck.set_active(self.gpu_ops)
        key = id(node)
        if key in self._memo:
            return self._memo[key]
        prev_node = self._cur_node
        self._cur_node = node
        try:
            result = self._run(node)
        except NotImplementedError as e:
            if self._replay:
                raise
            self.fallback_nodes.append(f"{type(node).__name__}: {e}")
            result = self._host_fallback(node)
        finally:
            self._cur_node = prev_node
        self._memo[key] = result
        return result

    # -- capacity decisions (record / replay) --------------------------------
    def _check(self, kind: str, value) -> int:
        """Replay: the next recorded decision, after checking its kind, and
        the device actual `value` (a tensor, or a callable making one) kept
        as its check."""
        rec = self._rec
        k, v = rec.decisions[rec.idx]
        rec.idx += 1
        if k != kind:
            raise NotJittable(f"decision kind drift ({kind})")
        if callable(value):
            value = value() if v else torch.zeros((), dtype=_I64,
                                                  device=self.device)
        rec.checks.append(value.to(_I64).reshape(()))
        return v

    def _decide_cap(self, scalar: torch.Tensor) -> int:
        """Host-sync a row count for capacity planning; schedule-aware."""
        rec = self._rec
        if rec is None:
            return int(scalar)
        if rec.mode == "record":
            v = int(scalar)
            rec.decisions.append(("cap", v))
            rec.nodes.append(self._cur_node)
            return v
        return self._check("cap", scalar)

    def _decide_exact(self, scalar: torch.Tensor) -> int:
        """Host-sync a value that selects program structure (must replay
        equal)."""
        rec = self._rec
        if rec is None:
            return int(scalar)
        if rec.mode == "record":
            v = int(scalar)
            rec.decisions.append(("exact", v))
            rec.nodes.append(self._cur_node)
            return v
        return self._check("exact", scalar)

    def _decide_exact_lazy(self, fn: Callable[[], torch.Tensor]) -> int:
        """Exact decision whose device scalar is computed lazily: where the
        recorded value is 0, replay skips the computation and checks a
        constant (taking the general path is always correct, so an
        ineligible fast path never pays its eligibility probe in replay)."""
        rec = self._rec
        if rec is None:
            return int(fn())
        if rec.mode == "record":
            v = int(fn())
            rec.decisions.append(("exact", v))
            rec.nodes.append(None)   # eligibility probe: no row semantics
            return v
        return self._check("exact", fn)

    def _decide_branch(self, value: bool) -> bool:
        """Record/replay a capacity-dependent structural branch: replay
        takes the recorded side (both sides are correct), and checks a
        constant equal to it."""
        rec = self._rec
        if rec is None:
            return value
        if rec.mode == "record":
            rec.decisions.append(("exact", int(value)))
            rec.nodes.append(None)   # performance branch: not a row count
            return value
        # the check: 1 where the recorded side was taken, else 0
        return bool(self._check("exact", lambda: torch.ones(
            (), dtype=_I64, device=self.device)))

    # -- helpers -------------------------------------------------------------
    def _eval(self, expr: BExpr, table: DTable) -> DCol:
        return exprs.evaluate(expr, table, subquery_eval=exprs.EvalCtx(
            subquery=self._scalar, param=self._param, replay=self._replay))

    def _param(self, expr, n: int) -> DCol:
        if self._params is None:
            raise NotJittable("parameter slot without bound values")
        v = self._params[expr.index]
        if not isinstance(v, torch.Tensor):
            return exprs.constant(expr.dtype, v, n, self.device)
        data = v.to(phys_dtype(expr.dtype)).expand(n).contiguous()
        return DCol(expr.dtype, data,
                    torch.ones(n, dtype=torch.bool, device=self.device))

    def _iota(self, n: int) -> torch.Tensor:
        return torch.arange(n, dtype=_I32, device=self.device)

    def _dense_rank(self, key_data: list, key_valid: list, alive):
        """dense_rank with the packed single-key tier when the key domain
        fits int64 (all keys integer-typed): the size cutoff is a recorded
        branch and the tier probe a lazy exact decision, as in the
        reference."""
        n = int(alive.shape[0])
        if key_data and all(map(_is_int, key_data)):
            if self._decide_branch(n >= (1 << 13)) and \
                    self._decide_exact_lazy(lambda: kernels.group_tier(
                        key_data, key_valid, alive)):
                return kernels.dense_rank_packsort(key_data, key_valid, alive)
        return kernels.dense_rank(key_data, key_valid, alive)

    def _scalar(self, plan: PlanNode):
        """Uncorrelated scalar subquery -> (value, validity). Eager: a host
        value (validity None: from the value). Replay: a device scalar and
        its device validity; a string one raises, as in the reference (its
        dictionary would be data-dependent)."""
        if self._replay:
            dt = self.execute(plan)
            col = decode_col(dt.cols[0])
            if col.dtype == "str":
                raise NotJittable("string scalar subquery under trace")
            perm, cnt = kernels.compaction_perm(dt.alive)
            first = perm[:1].long()
            value = col.data.index_select(0, first).reshape(())
            valid = (cnt > 0) & col.valid.index_select(0, first).reshape(())
            return value, valid
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
        if self._params is not None:
            # the numpy expression engine evaluates literals, not slots
            host_node = deparameterize_plan(host_node, list(self._params))
        # expression-embedded subplans can still read segmented CTEs, which
        # the host executor cannot resolve: materialize them
        vmap = {}
        for n in iter_plan_nodes(host_node):
            if isinstance(n, VirtualScanNode):
                src = self._scan_cache.get(n.key)
                if src is None:
                    raise RuntimeError(f"segment {n.key!r} not materialized")
                vmap[id(n)] = MaterializedNode(
                    table=to_host(src), label=n.key,
                    out_names=list(n.out_names),
                    out_dtypes=list(n.out_dtypes))
        if vmap:
            host_node = replace_plan_nodes(host_node, vmap)
        host = HostExecutor(self._load_table)
        return to_device(host.execute(host_node), self.device)

    def _maybe_compact(self, t: DTable) -> DTable:
        count_t = t.count()
        count = self._decide_cap(count_t)
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
        if self.abandoned:
            check_abandoned(self)
        if isinstance(node, MaterializedNode):
            return to_device(node.table, self.device)
        if isinstance(node, VirtualScanNode):
            return self._run_virtual(node)
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
        # (index_fill_: an indexed store of a python scalar copies it from
        # the host and waits on the device)
        in_left = torch.zeros(n + 1, dtype=torch.bool, device=self.device) \
            .index_fill_(0, torch.where(is_left, safe_gid, n), True)
        in_right = torch.zeros(n + 1, dtype=torch.bool, device=self.device) \
            .index_fill_(0, torch.where(is_left, n, safe_gid), True)
        keep = in_left & (in_right if node.op == "intersect" else ~in_right)
        first_left = kernels.first_row_per_gid(gid, both.alive & is_left)
        g = gid.long().clamp(0, n)
        alive = both.alive & is_left & keep[g] & (first_left[g] == iota)
        return self._maybe_compact(DTable(names, both.cols, alive))

    def _run_virtual(self, node: VirtualScanNode) -> DTable:
        """A segment's output, resolved against the segment cache (run_query
        materializes segments before their consumers)."""
        self._touched_scans.setdefault(node.key)
        t = self._scan_cache.get(node.key)
        if t is None:
            if self._replay:
                raise NotJittable(f"segment {node.key!r} missing under trace")
            raise RuntimeError(      # orchestration bug, never a fallback
                f"segment {node.key!r} not materialized")
        return DTable(list(node.out_names), t.cols, t.alive)

    def _run_scan(self, node: ScanNode) -> DTable:
        cache_key = node.table + "//" + ",".join(node.columns)
        self._touched_scans.setdefault(cache_key)
        if _is_morsel(cache_key):
            # the streamed group stages each morsel into its slot; the
            # big table itself is never loaded here
            cached = self._scan_cache.get(cache_key)
            if cached is None:
                raise RuntimeError(f"morsel slot {cache_key!r} not staged")
            if isinstance(cached, PackedTable):
                # a packed slot: unpacked inside the program (views of
                # its buffer, bits, run expansion)
                cached = unpack_table(cached)
            return DTable(list(node.out_names), cached.cols, cached.alive)
        if cache_key not in self._scan_cache:
            if self._replay:
                raise NotJittable(f"scan {cache_key!r} missing under trace")
            self._scan_cache[cache_key] = self._load_scan(
                node.table, node.columns, node.out_names)
            self._account_resident(cache_key, self._scan_cache[cache_key],
                                   set(self._touched_scans))
        self._scan_meta[cache_key] = (node.table, list(node.columns),
                                      list(node.out_names))
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
        arg_col = None if wf.arg is None else widen_col(
            self._eval(wf.arg, child))
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

    def _sorted_agg_eligible(self, node: AggregateNode,
                             child: DTable) -> bool:
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
        # the capacity cutoff last, after the static gates, so the
        # recorded branch sits at a fixed place in the schedule
        return self._decide_branch(child.capacity >= (1 << 13))

    def _aggregate_sorted(self, node: AggregateNode, child: DTable,
                          grouping_sets: list) -> DTable:
        n = child.capacity
        alive = child.alive
        group_cols = [self._eval(e, child) for e in node.group_exprs]
        keys = [rank_key(c) for c in group_cols]
        kvalids = [c.valid for c in group_cols]
        # aggregate arguments widen off narrow lanes: the within-group
        # scan sums in the payload's dtype, and an int32 sum over a morsel
        # would wrap (group KEYS stay narrow, and on codes)
        arg_cols = [None if s.arg is None else widen_col(
            self._eval(s.arg, child)) for s in node.aggs]
        int_keys = all(map(_is_int, keys))
        tier = self._decide_exact_lazy(
            lambda: kernels.group_tier(keys, kvalids, alive)) if int_keys \
            else self._decide_exact(torch.zeros((), dtype=_I32,
                                                device=self.device))

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
            cap_out = bucket(max(self._decide_cap(num_groups_t), 1))
            if cap_out > n:
                # a replayed schedule that plans more groups than the input
                # has rows (an adopted schedule of a larger data set, or a
                # morsel schedule inflated to the morsel bound over a
                # smaller input): the reference's replay fails on it (its
                # shapes disagree); here the replay fails the schedule, and
                # the caller records again
                raise ReplayMismatch(f"sorted aggregation plans {cap_out} "
                                     f"groups over {n} input rows")
            is_end = kernels.group_ends(new_group, alive_sorted)
            end_perm, _ = kernels.compaction_perm(is_end)
            sel = end_perm[:cap_out].long()
            orig = perm[sel].long()
            alive_out = self._iota(cap_out) < num_groups_t

            out_cols: list[DCol] = []
            for i, gc in enumerate(group_cols):
                if i < k:
                    cd = gc.canon().data
                    # sort and scan ran on codes; the group-sized output
                    # decodes
                    out_cols.append(decode_col(DCol(
                        gc.dtype, cd[orig], gc.valid[orig] & alive_out,
                        gc.dictionary, codebook=gc.codebook)))
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
        num_groups = self._decide_cap(num_groups_t)
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
                # grouping ran on codes (rank_key); the group-sized
                # representative is the decode site
                out_cols.append(decode_col(DCol(gc.dtype, vals, valid,
                                                gc.dictionary,
                                                codebook=gc.codebook)))
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
                widen_col(self._eval(spec.arg, child))
            use_alive = alive
            if spec.distinct and arg_col is not None:
                use_alive = kernels.distinct_within_group(
                    gid, alive, rank_key(arg_col), arg_col.valid)
            if arg_col is not None and arg_col.dtype == "str":
                out.append(self._agg_string(spec, arg_col, gid, use_alive,
                                            cap_out))
                continue
            arg = None if arg_col is None else \
                (arg_col.canon().data, arg_col.valid)
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
                build_has_null = bool(self._decide_exact(
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
            matched_right = torch.zeros(
                rcap + 1, dtype=torch.bool, device=self.device).index_fill_(
                    0, torch.where(inner.alive, right_rows, rcap).long(), True)
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
        state: dict = {}

        def probe() -> torch.Tensor:
            rmin = torch.where(r_ok, rd, info.max).min()
            rmax = torch.where(r_ok, rd, info.min).max()
            cnt_r = r_ok.sum()
            span_ok = (rmax - rmin) < limit
            lut_idx = torch.clamp(rd - rmin, 0, limit - 1)
            scatter_idx = torch.where(r_ok, lut_idx, limit).long()
            hist = torch.zeros(limit + 1, dtype=_I32, device=self.device)
            hist.index_add_(0, scatter_idx,
                            torch.ones_like(scatter_idx, dtype=_I32))
            unique = hist[:limit].max() <= 1
            state.update(rmin=rmin, scatter_idx=scatter_idx)
            return span_ok & unique & (cnt_r > 0)

        # replay computes the probe only where the record pass took the path
        if not self._decide_exact_lazy(probe):
            return None
        rmin, scatter_idx = state["rmin"], state["scatter_idx"]
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
                build_has_null = bool(self._decide_exact(
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
        total = self._decide_cap(cnt.to(_I64).sum())
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


def _is_morsel(key: str) -> bool:
    """A scan key of a streamed group's morsel slot."""
    return key.startswith(MORSEL_TABLE + "//")


def _unit_totals(unit_stats: list, root: dict) -> dict:
    """The root unit's stats, with every unit run's mode (``unit_modes``),
    nojit reasons, and capture and graph figures summed over the units."""
    out = dict(root)
    out["unit_modes"] = [st.get("mode") for st in unit_stats]
    reasons = [st["nojit_reason"] for st in unit_stats
               if st.get("nojit_reason")]
    if reasons:
        out["nojit_reason"] = "; ".join(reasons)
    for k in ("graph_ms", "capture_s", "pool_growth_bytes"):
        if any(k in st for st in unit_stats):
            out[k] = sum(st.get(k, 0) for st in unit_stats)
    launches: dict = {}
    for st in unit_stats:
        for name, n in st.get("captured_launches", {}).items():
            launches[name] = launches.get(name, 0) + n
    if launches:
        out["captured_launches"] = launches
    return out


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
    """Comparable device key tensors for a join key pair. Where one side
    carries a codebook the join runs on its codes: the plain side's
    values go into that code space (device.encode_against: the code, or
    -1, which matches nothing), so the big encoded side keeps its int32
    codes. Codes meet only codes of the same codebook; two different
    codebooks decode."""
    if a.dtype == "str" or b.dtype == "str":
        return exprs.string_pair_keys(a, b)
    if a.codebook is not None or b.codebook is not None:
        if a.codebook is b.codebook:
            return a.canon().data, b.canon().data
        if b.codebook is None:
            return a.canon().data, encode_against(a.codebook, b)
        if a.codebook is None:
            return encode_against(b.codebook, a), b.canon().data
        a, b = decode_col(a), decode_col(b)   # different codebooks
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
        # pieces may mix encodings and widths (an encoded inner-join piece
        # beside a plain null extension): codes of different codebooks
        # never share a buffer, so a concatenation is a decode site
        cols = [decode_col(p.cols[ci]) for p in pieces]
        valid = torch.cat([c.valid for c in cols])
        if cols[0].dtype == "str":
            dictionary, datas = exprs.merge_branch_strings(cols)
            out_cols.append(DCol("str", torch.cat(datas), valid, dictionary))
        else:
            pd = cols[0].data.dtype
            for c in cols[1:]:
                pd = torch.promote_types(pd, c.data.dtype)
            out_cols.append(DCol(cols[0].dtype,
                                 torch.cat([c.data.to(pd) for c in cols]),
                                 valid))
    return DTable(names, out_cols, torch.cat([p.alive for p in pieces]))
