# Copied from nds_tpu/obs/stats.py, verbatim.
"""Typed per-query execution stats.

``Session.last_exec_stats`` used to be an untyped dict assembled in two
divergent code paths (the in-core executor path and the streaming morsel
path), and every PR grew new ad-hoc keys. ``ExecStats`` is the one typed
shape both paths construct; the session installs it through a single
method (``Session._finish_exec_stats``), keeping a dict view
(``to_dict``) for every existing consumer — bench/power JSON, tests, and
report summaries read the same keys as before.

Field groups:
- execution mode + device timing (every backend path);
- compile-segmentation counters (multi-unit plans);
- streaming/morsel counters (out-of-core queries);
- failure observability: host-fallback reasons and ALL prefetch errors
  (the old path kept only the first staging-thread failure).
Unknown executor-surfaced keys ride ``extra`` verbatim so a new stat in
the device layer never silently vanishes from reports.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


#: executor last_stats keys with first-class fields (everything else
#: passes through ``extra``)
_EXECUTOR_FIELDS = ("mode", "device_ms", "precompile_s", "nojit_reason",
                    "transient", "spec_mismatch", "segments", "segments_run",
                    "seg_device_ms")


@dataclass
class ExecStats:
    """One query execution's observability record."""
    # -- mode + device timing ------------------------------------------------
    mode: str = ""           # record|compile+run|compiled|eager|adopted|
    #                          streaming (the session's out-of-core path)
    device_ms: Optional[float] = None
    precompile_s: Optional[float] = None
    nojit_reason: Optional[str] = None
    transient: Optional[str] = None
    spec_mismatch: Optional[str] = None
    # -- compile segmentation ------------------------------------------------
    segments: Optional[int] = None
    segments_run: Optional[int] = None
    seg_device_ms: Optional[float] = None
    # -- streaming -----------------------------------------------------------
    jobs: Optional[int] = None
    morsels: Optional[int] = None
    morsel_rows: Optional[int] = None
    re_records: Optional[int] = None
    shared_scan: Optional[bool] = None
    scan_passes: Optional[int] = None
    tables_streamed: Optional[int] = None
    branches_served: Optional[int] = None
    fused_groups: Optional[int] = None
    bytes_uploaded: Optional[int] = None
    morsels_per_table: Optional[dict] = None
    narrow_lanes: Optional[bool] = None
    lane_spec: Optional[dict] = None
    # -- encoded execution (EngineConfig.encoded_exec) -----------------------
    #: whether dictionary/RLE wire encodings were eligible for this run
    encoded_exec: Optional[bool] = None
    #: per-table per-column chosen encoding tags ("plain"/"dict[k]"/"rle[r]")
    enc_spec: Optional[dict] = None
    #: upload bytes the encodings removed vs the plain narrow-lane layout
    enc_bytes_saved: Optional[int] = None
    #: decode_col sites that materialized values during this run's traces
    decode_sites: Optional[int] = None
    #: column slots those decodes materialized (rows x sites) — group keys
    #: that stay on codes keep this far below morsels x capacity
    decode_rows: Optional[int] = None
    #: per-table host-side Arrow->engine morsel decode wall (ms) — the
    #: staging-thread bottleneck, finally measurable
    host_decode_ms: Optional[dict] = None
    # -- sharded morsel execution (EngineConfig.mesh_shards) -----------------
    #: data-parallel replica count the streamed groups ran on (None = off)
    mesh_shards: Optional[int] = None
    #: scan groups whose morsels actually dispatched over the mesh
    sharded_groups: Optional[int] = None
    #: per-device ingress of the per-morsel partial all_gathers (ring model)
    collective_bytes: Optional[int] = None
    #: measured wall of the partial-gather dispatches
    collective_ms: Optional[float] = None
    # -- pallas kernels (EngineConfig.pallas_ops) ----------------------------
    #: the validated op subset active for this execution (None = flag off)
    pallas_ops: Optional[list] = None
    #: why the XLA lowering served despite the flag (platform/import/mesh)
    pallas_fallback_reason: Optional[str] = None
    # -- query service (nds_tpu/service) -------------------------------------
    #: wall spent between service admission and execution start (ms) — the
    #: service-mode latency decomposition: latency = queue_wait + execute
    queue_wait_ms: Optional[float] = None
    #: co-served queries: how many OTHER admitted queries rode the same
    #: compiled dispatch (compatible-plan batching); None = not batched
    batched_with: Optional[int] = None
    #: the query's ``service/ticket`` root span id — joins this stats
    #: record to its span subtree in a Chrome-trace/JSONL export (None
    #: outside the service, 0 when tracing was disabled at submit)
    trace_id: Optional[int] = None
    # -- per-plan-node actuals (obs/profile.py) ------------------------------
    #: {TypeName#k label: actual row count} — the row counts the engine
    #: ALREADY computes riding out for free: schedule-check values on the
    #: compiled path (group counts, join build/probe sizes), morsel/partial/
    #: final counts on the streamed path, exact per-node counts under
    #: profiled (EXPLAIN ANALYZE) execution. Labels match verify.py
    #: findings and PlanProfile nodes (same TypeName#k minting).
    node_stats: Optional[dict] = None
    # -- device-memory watermarks (obs/profile.DEVICE_MEM) -------------------
    #: high-water mark of tracked device bytes during THIS statement
    mem_peak_bytes: Optional[int] = None
    #: tracked device bytes live when the statement finished
    mem_live_bytes: Optional[int] = None
    #: scan-budget headroom above the statement's peak (budget - peak;
    #: None when the budget is unbounded)
    mem_headroom_bytes: Optional[int] = None
    # -- failure observability -----------------------------------------------
    fallback_reasons: list = field(default_factory=list)
    #: EVERY staging-thread failure of the run ("Type: message"), not just
    #: the first — repeated prefetch degradation is a pattern, not an event
    prefetch_error_details: list = field(default_factory=list)
    #: forward-compat passthrough for executor keys without a field
    extra: dict = field(default_factory=dict)

    # -- constructors (the ONE place each path builds stats) -----------------
    @classmethod
    def from_executor(cls, last_stats: dict,
                      fallbacks: Optional[list] = None) -> "ExecStats":
        """Typed view of ``JaxExecutor.last_stats`` (in-core path)."""
        known = {k: last_stats[k] for k in _EXECUTOR_FIELDS
                 if k in last_stats}
        extra = {k: v for k, v in last_stats.items()
                 if k not in _EXECUTOR_FIELDS}
        # per-node actuals the executor attributed from its capacity-
        # schedule checks ride the first-class field, not the passthrough
        node_stats = extra.pop("node_rows", None)
        return cls(fallback_reasons=list(fallbacks or ()),
                   node_stats=node_stats, extra=extra, **known)

    @classmethod
    def streaming(cls, *, jobs: int, morsels: int, morsel_rows: int,
                  re_records: int, shared_scan: bool, scan_passes: int,
                  tables_streamed: int, branches_served: int,
                  fused_groups: int, bytes_uploaded: int,
                  morsels_per_table: dict, narrow_lanes: bool,
                  lane_spec: dict,
                  encoded_exec: Optional[bool] = None,
                  enc_spec: Optional[dict] = None,
                  enc_bytes_saved: Optional[int] = None,
                  decode_sites: Optional[int] = None,
                  decode_rows: Optional[int] = None,
                  host_decode_ms: Optional[dict] = None,
                  prefetch_error_details: Optional[list] = None,
                  fallbacks: Optional[list] = None,
                  mesh_shards: Optional[int] = None,
                  sharded_groups: Optional[int] = None,
                  collective_bytes: Optional[int] = None,
                  collective_ms: Optional[float] = None,
                  node_stats: Optional[dict] = None) -> "ExecStats":
        """Typed record of one out-of-core (morsel-streamed) execution."""
        return cls(mode="streaming", jobs=jobs, morsels=morsels,
                   morsel_rows=morsel_rows, re_records=re_records,
                   shared_scan=shared_scan, scan_passes=scan_passes,
                   tables_streamed=tables_streamed,
                   branches_served=branches_served,
                   fused_groups=fused_groups, bytes_uploaded=bytes_uploaded,
                   morsels_per_table=dict(morsels_per_table),
                   narrow_lanes=narrow_lanes, lane_spec=dict(lane_spec),
                   encoded_exec=encoded_exec,
                   enc_spec=dict(enc_spec) if enc_spec is not None else None,
                   enc_bytes_saved=enc_bytes_saved,
                   decode_sites=decode_sites, decode_rows=decode_rows,
                   host_decode_ms=host_decode_ms,
                   mesh_shards=mesh_shards, sharded_groups=sharded_groups,
                   collective_bytes=collective_bytes,
                   collective_ms=collective_ms,
                   node_stats=node_stats,
                   prefetch_error_details=list(prefetch_error_details or ()),
                   fallback_reasons=list(fallbacks or ()))

    # -- views ---------------------------------------------------------------
    def to_dict(self) -> dict:
        """Backward-compatible dict view: exactly the keys the untyped
        ``last_exec_stats`` carried (None fields dropped, legacy
        ``prefetch_errors``/``prefetch_error`` aliases preserved)."""
        out: dict = {}
        if self.mode:
            out["mode"] = self.mode
        for k in ("device_ms", "precompile_s", "nojit_reason", "transient",
                  "spec_mismatch", "segments", "segments_run",
                  "seg_device_ms", "jobs", "morsels", "morsel_rows",
                  "re_records", "shared_scan", "scan_passes",
                  "tables_streamed", "branches_served", "fused_groups",
                  "bytes_uploaded", "morsels_per_table", "narrow_lanes",
                  "lane_spec", "encoded_exec", "enc_spec",
                  "enc_bytes_saved", "decode_sites", "decode_rows",
                  "host_decode_ms", "mesh_shards", "sharded_groups",
                  "collective_bytes", "collective_ms",
                  "pallas_ops", "pallas_fallback_reason",
                  "queue_wait_ms", "batched_with", "trace_id",
                  "node_stats", "mem_peak_bytes", "mem_live_bytes",
                  "mem_headroom_bytes"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        out.update(self.extra)
        if self.fallback_reasons:
            out["fallback_reasons"] = list(self.fallback_reasons)
        if self.prefetch_error_details:
            out["prefetch_errors"] = len(self.prefetch_error_details)
            out["prefetch_error"] = self.prefetch_error_details[0]
            out["prefetch_error_details"] = list(self.prefetch_error_details)
        return out
