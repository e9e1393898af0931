"""Engine configuration of the port: what the in-core and streamed paths read.

Counterpart of ``nds_tpu/config.py``'s ``EngineConfig``; field names and
defaults follow it, the streamed path's too, except where the card differs
(``decimal_physical`` defaults to exact int64 decimals, ``gpu_kernels``
replaces ``pallas_ops`` with all three kernels on by default, and
``scan_budget_gb`` is sized to the card's 80 GB). The drivers' fields
(timeouts, attempts, fault points), ``from_property_file``,
``load_properties`` and ``apply_decimal`` are copied from it.

The reference's ``maybe_enable_compile_cache`` (JAX's persistent compile
cache) has no counterpart: the CUDA kernels build once into
``nds_tpu_torch/_build/`` and a CUDA graph is captured per process.
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
    # out-of-core execution: every maximal streamable aggregate over one
    # big scan streams its table through the card in chunk_rows morsels
    # (one compiled program, captured as a CUDA graph, serves every morsel
    # of a scan group; partials merge on the host). Plans with no
    # streaming job run in-core
    out_of_core: bool = True
    # a scan streams (rather than staying device-resident) when its table
    # exceeds this estimated row count
    out_of_core_min_rows: int = 48_000_000
    # rows per morsel; every morsel lands in a device slot of
    # bucket(chunk_rows) rows
    chunk_rows: int = 1 << 22
    # accumulated streamed-partial rows that trigger a host-side compaction
    # (partial-schema-preserving re-aggregation), bounding host memory for
    # high-cardinality groups
    stream_compact_rows: int = 8_000_000
    # shared scan: all streaming branches of one query over the same big
    # table share ONE morsel pass (the union of their columns is staged
    # once per morsel)
    shared_scan: bool = True
    # a shared-scan group of at most this many branches runs as ONE
    # multi-output program per morsel (one CUDA graph); larger groups run
    # per-branch programs over the same slot. 0 = fuse unconditionally
    stream_fusion_max_branches: int = 16
    # narrow-lane packed uploads: a streamed morsel rides one packed byte
    # buffer, each column at its least width (u8/u16/u32/i32 lanes chosen
    # once per scan group from table-wide min/max stats, validity one bit
    # a row; device.plan_lanes/pack_table), unpacked on the card inside the
    # morsel's program; a column whose range fits 32 bits executes on int32
    # and widens to int64 only where it is summed or computed with.
    # False: the plain slot (int64 data, one byte of validity a row)
    narrow_lanes: bool = True
    # encoded execution (needs narrow_lanes): low-cardinality int, date
    # and decimal columns ride dictionary codes on u8/u16 lanes with a
    # sorted host codebook (uploaded once per scan group), clustered ones
    # (value, run length) pairs expanded on the card; chosen once per
    # group from cardinality and run stats (Session.column_enc_stats).
    # Filters, join and group keys and sorts run on the codes;
    # device.decode_col gives values where arithmetic, aggregates and
    # outputs need them
    encoded_exec: bool = True
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
    # -- transactional warehouse (warehouse.py _snapshots log) -------------
    # PIN reader registrations (Warehouse.register_all) to the latest
    # published warehouse version, so a statement never sees table A at
    # version k beside table B at k+1. False = the pre-transactional
    # manifest-latest reads, no _snapshots log consulted.
    # Property: nds.tpu.warehouse_transactions.
    warehouse_transactions: bool = True
    # -- resilience (nds_tpu_torch/resilience.py) --------------------------
    # per-query wall-clock budget in seconds; an overrun abandons the query
    # and records Failed (DeadlineExceeded). 0 = unbounded.
    query_timeout_s: float = 0.0
    # timed attempts per query: transient failures retry with exponential
    # backoff before the query records Failed. 1 = no retry.
    query_attempts: int = 1
    # base backoff between retry attempts (doubles per attempt, capped)
    retry_backoff_s: float = 0.1
    # per-stream wall-clock budget for the throughput supervisor; a stream
    # past it is killed (process mode) or abandoned (thread mode). 0 = none.
    stream_timeout_s: float = 0.0
    # spawn attempts per throughput stream (crash/timeout => restart with
    # backoff until exhausted). 1 = no restart.
    stream_attempts: int = 1
    # armed fault-injection specs, e.g. ("jax.execute:hang:5#1",
    # "arrow.read:raise@0.1") - see resilience.FaultSpec for the grammar;
    # property file: nds.tpu.fault_points=point:action,point:action
    fault_points: tuple = ()

    @staticmethod
    def from_property_file(path: Optional[str]) -> "EngineConfig":
        """A config from a java-style property file: ``nds.tpu.<field>``
        sets the field of that name (``nds.tpu.device=cpu``,
        ``nds.tpu.gpu_kernels=sort,gather``); other keys are ignored."""
        cfg = EngineConfig()
        for k, v in load_properties(path).items():
            key = k.replace("nds.tpu.", "").replace(".", "_")
            if not hasattr(cfg, key):
                continue
            cur = getattr(cfg, key)
            if key == "device":
                setattr(cfg, key, v or None)
            elif isinstance(cur, bool):
                setattr(cfg, key, v.lower() in ("1", "true", "yes"))
            elif isinstance(cur, int):
                setattr(cfg, key, int(v))
            elif isinstance(cur, float):
                setattr(cfg, key, float(v))
            elif isinstance(cur, str):
                setattr(cfg, key, v)
            elif isinstance(cur, tuple):
                parts = [x.strip() for x in v.split(",") if x.strip()]
                try:
                    setattr(cfg, key, tuple(int(x) for x in parts))
                except ValueError:
                    setattr(cfg, key, tuple(parts))
        return cfg


def load_properties(path: Optional[str]) -> dict:
    """Parse a java-style key=value property file (reference
    nds_power.py:306-312)."""
    props: dict = {}
    if not path:
        return props
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            name, _, value = line.partition("=")
            props[name.strip()] = value.strip()
    return props


def apply_decimal(config: EngineConfig, decimal: Optional[str]) -> None:
    """Apply a runner-level decimal override: "i64" exact scaled int64
    (the port's default), "f64" doubles. Torch has int64 natively, so
    there is no 64-bit switch to turn on."""
    if decimal:
        if decimal not in ("f64", "i64"):
            raise ValueError(f"unknown decimal physical type {decimal!r} "
                             "(expected f64 or i64)")
        config.decimal_physical = decimal
