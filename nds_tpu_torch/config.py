"""Engine configuration of the port: only what the in-core path reads.

Counterpart of ``nds_tpu/config.py``'s ``EngineConfig``; field names and
defaults follow it except where the card differs (``decimal_physical``
defaults to exact int64 decimals, ``gpu_kernels`` replaces ``pallas_ops``
with all three kernels on by default, and ``scan_budget_gb`` is sized to
the card's 80 GB).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class EngineConfig:
    # DECIMAL columns: "i64" = exact scaled int64 ("decN" engine dtype),
    # "f64" = doubles. Torch has int64 natively, so there is no x64 switch.
    decimal_physical: str = "i64"
    # late materialization of dimension attributes past join-heavy
    # aggregates (planner rewrite), and the scan size that turns it on
    late_materialization: bool = True
    late_mat_min_rows: int = 1 << 20
    # plan-IR verification: the port supports "off" only
    verify_plans: str = "off"
    # the hand-written CUDA kernel families the device path dispatches to
    # (a subset of {"sort", "groupby", "gather"}); on CPU tensors each
    # kernel's plain version runs in its place
    gpu_kernels: tuple = ("gather", "groupby", "sort")
    # scans of tables above this estimated row count would stream through
    # the device in morsels in the reference; the port runs in-core only
    # and refuses them
    out_of_core_min_rows: int = 48_000_000
    # torch device for the device path: None = "cuda"
    device: Optional[str] = None
    # compiled replay: a unit's first run records its capacity schedule,
    # the second replays it (captured as a CUDA graph on the card), later
    # runs replay the graph. False: every run eager, as before replay
    jit_plans: bool = True
    # plans with at least this many nodes split each CTE of at least
    # segment_min_cte_nodes nodes (and each big rollup) into a unit of its
    # own whose output stays device-resident; 0 disables
    segment_plan_nodes: int = 18
    segment_min_cte_nodes: int = 8
    # device-resident segment outputs kept before LRU eviction
    segment_cache_entries: int = 16
    # device memory (GB) for resident scans and segment outputs; the least
    # recently used unpinned entries leave past it (0: never). The
    # reference's 10 GB budget is a TPU v5e's 16 GB HBM; the H100 holds
    # 80 GB, and the SF10 scans of the smoke's fourteen queries (tens of
    # columns of up to 33.5M padded rows) must stay resident between
    # queries, while half the card stays free for intermediates and graphs
    scan_budget_gb: float = 40.0
