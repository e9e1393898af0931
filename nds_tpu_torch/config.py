"""Engine configuration of the port: only what the in-core path reads.

Counterpart of ``nds_tpu/config.py``'s ``EngineConfig``; field names and
defaults follow it except where the card differs (``decimal_physical``
defaults to exact int64 decimals, and ``gpu_kernels`` replaces
``pallas_ops`` with all three kernels on by default).
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
