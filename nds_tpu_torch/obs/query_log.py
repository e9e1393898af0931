# Copied from nds_tpu/obs/query_log.py; one word of the docstring changed.
"""Durable query log: one flat row per completed statement.

Every ExecStats the engine produces is rich but ephemeral — it describes
the LAST statement, lives in Python, and dies with the process. The query
log is the durable, queryable complement: at ``Session._finish_exec_stats``
time (and at every service ticket's completion) the typed stats flatten
into ONE flat dict — O(row) work, no plan walk — appended to

- a bounded in-memory ring (``system.query_log`` serves SQL over it live:
  ``SELECT tenant, wall_ms FROM system.query_log`` works mid-overload), and
- an opt-in buffered JSONL file with size-capped rotation, so every
  scored run leaves a self-describing artifact ``scripts/slo_report.py``
  can compute per-tenant SLO attainment and burn rates from offline.

Disabled (the default) a record is ONE attribute read — the engine adds
zero counters and zero allocation per statement. Enable with
``EngineConfig.query_log`` / ``--query_log`` on the runners /
``NDS_TPU_QUERY_LOG=1`` (or ``=<path>`` for the JSONL sink).

The row schema is FROZEN (``COLUMNS``): tests pin the column names and
dtypes, ``system.query_log`` materializes exactly these columns, and the
JSONL rows are the ring rows verbatim (ring<->file equivalence is a
tested property). Unknown fields are dropped at record time rather than
growing the schema silently.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional

#: the frozen row schema: (column, engine dtype). Dtypes are the engine's
#: logical dtypes ("int" = int64, "float" = f64, "str") — the same names
#: system_tables pins into the system.query_log catalog schema. Nullable
#: everywhere; absent fields land as None/null.
COLUMNS = (
    ("ts", "float"),            # unix seconds at completion
    ("seq", "int"),             # per-process total order
    ("source", "str"),          # session | service
    ("label", "str"),           # query label (runners pass "query9" etc.)
    ("tenant", "str"),          # service tenant ("" outside the service)
    ("template", "str"),        # parameterized-plan fingerprint prefix
    ("trace_id", "int"),        # joins the row to its span subtree
    ("status", "str"),          # "ok" | error class name
    ("error", "str"),           # error message ("" when ok)
    ("wall_ms", "float"),       # statement wall (service: admission->done)
    ("queue_ms", "float"),      # admission -> execution start
    ("plan_ms", "float"),       # planner-stage wall (service path)
    ("exec_ms", "float"),       # device-lane/dispatch wall (service path)
    ("materialize_ms", "float"),  # deferred client-side conversion, when
    #                               it happened before the row was cut
    ("rows", "int"),            # result rows (None when not materialized)
    ("bytes_uploaded", "int"),  # host->device bytes staged (streamed)
    ("mode", "str"),            # exec mode (compiled/adopted/streaming/...)
    ("cache_mode", "str"),      # "" | exact | subsumed (result cache)
    ("mesh_shards", "int"),     # data-parallel replicas (streamed shards)
    ("morsels", "int"),         # morsels executed (streamed)
    ("mem_peak_bytes", "int"),  # device-memory high-water mark
    ("node_stats", "str"),      # {TypeName#k: actual rows} as JSON —
    #                             offline tooling (slo_report,
    #                             explain_report --audit, the feedback
    #                             store's replay_log) reconstructs
    #                             per-node actuals without explain folders
    ("preempted", "int"),       # interactive tickets served at this
    #                             streamed query's morsel-boundary yield
    #                             points (0 outside the fair scheduler)
)

COLUMN_NAMES = tuple(c for c, _ in COLUMNS)

#: ring rows kept in memory (system.query_log's window) by default
DEFAULT_CAPACITY = 4096
#: JSONL rows buffered before a write syscall (flushed on rotation/close)
FLUSH_EVERY = 64
#: rotation default: the active file rolls past this size
DEFAULT_MAX_BYTES = 64 << 20
#: rotated files kept (oldest deleted first); the active file rides beside
DEFAULT_MAX_FILES = 4


def _cache_mode(mode: str) -> str:
    if mode == "cached":
        return "exact"
    if mode == "cached_subsumed":
        return "subsumed"
    return ""


def flatten_stats(stats, **ctx) -> dict:
    """One ExecStats -> one flat row dict (O(fields), no plan walk).

    ``ctx`` carries what the stats record does not know (source, label,
    tenant, wall_ms, error, ...); unknown keys are dropped so the frozen
    schema cannot grow by accident."""
    row = dict.fromkeys(COLUMN_NAMES)
    if stats is not None:
        row["mode"] = stats.mode or None
        row["cache_mode"] = _cache_mode(stats.mode) or None
        row["trace_id"] = stats.trace_id
        row["queue_ms"] = stats.queue_wait_ms
        row["bytes_uploaded"] = stats.bytes_uploaded
        row["mesh_shards"] = stats.mesh_shards
        row["morsels"] = stats.morsels
        row["mem_peak_bytes"] = stats.mem_peak_bytes
        if stats.node_stats:
            row["node_stats"] = json.dumps(stats.node_stats,
                                           sort_keys=True)
    for k, v in ctx.items():
        if k in row and v is not None:
            row[k] = v
    if row["status"] is None:
        row["status"] = type(row["error"]).__name__ \
            if isinstance(row["error"], BaseException) else \
            ("error" if row["error"] else "ok")
    if isinstance(row["error"], BaseException):
        row["error"] = str(row["error"])
    return row


class QueryLog:
    """Process-wide statement log (one instance: ``QUERY_LOG``).

    The ring append and the JSONL buffer share one lock; rotation renames
    the active file to ``<path>.<k>`` with a MONOTONIC k (1, 2, ...) so
    lexicographic sort of a rotation set is chronological, and deletes
    the oldest rotated file beyond ``max_files``."""

    def __init__(self) -> None:
        self.enabled = False
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=DEFAULT_CAPACITY)
        self._seq = 0
        self.path: Optional[str] = None
        self.max_bytes = DEFAULT_MAX_BYTES
        self.max_files = DEFAULT_MAX_FILES
        self.flush_every = FLUSH_EVERY
        self._buf: list[str] = []
        self._file_bytes = 0
        self._rot_seq = 0

    # -- control -------------------------------------------------------------
    def configure(self, enabled: bool = True,
                  capacity: Optional[int] = None,
                  path: Optional[str] = None,
                  max_bytes: Optional[int] = None,
                  max_files: Optional[int] = None,
                  flush_every: Optional[int] = None,
                  clear: bool = True) -> "QueryLog":
        with self._lock:
            if capacity is not None:
                self._ring = deque(self._ring, maxlen=capacity)
            if path is not None:
                self.path = path or None
                self._file_bytes = (os.path.getsize(path)
                                    if path and os.path.exists(path) else 0)
            if max_bytes is not None:
                self.max_bytes = max_bytes
            if max_files is not None:
                self.max_files = max_files
            if flush_every is not None:
                self.flush_every = max(1, flush_every)
            if clear:
                self._ring.clear()
                self._buf = []
                self._seq = 0
                self._rot_seq = 0
            self.enabled = enabled
        return self

    def close(self) -> None:
        """Flush the JSONL buffer and disable."""
        self.flush()
        with self._lock:
            self.enabled = False

    # -- recording -----------------------------------------------------------
    def record(self, stats=None, **ctx) -> Optional[dict]:
        """Append one statement row (no-op while disabled). ``stats`` is
        the ExecStats to flatten; ``ctx`` the out-of-band fields (source,
        label, tenant, wall_ms, error, rows, ...)."""
        if not self.enabled:
            return None
        row = flatten_stats(stats, **ctx)
        row["ts"] = round(time.time(), 3)
        flush_now = None
        with self._lock:
            self._seq += 1
            row["seq"] = self._seq
            self._ring.append(row)
            if self.path:
                self._buf.append(json.dumps(row))
                if len(self._buf) >= self.flush_every:
                    flush_now = self._drain_locked()
        from .metrics import QUERY_LOG_ROWS
        QUERY_LOG_ROWS.inc()
        if flush_now:
            self._write(flush_now)
        return row

    # -- JSONL sink ----------------------------------------------------------
    def _drain_locked(self) -> list[str]:
        out, self._buf = self._buf, []
        return out

    def flush(self) -> None:
        with self._lock:
            pending = self._drain_locked() if self.path else []
        if pending:
            self._write(pending)

    def _write(self, lines: list[str]) -> None:
        """Append buffered rows; rotate first when the active file would
        cross max_bytes (checked against the TRACKED size, one stat-free
        comparison per flush)."""
        payload = "\n".join(lines) + "\n"
        with self._lock:
            path = self.path
            if path is None:
                return
            if self._file_bytes and \
                    self._file_bytes + len(payload) > self.max_bytes:
                self._rotate_locked()
            self._file_bytes += len(payload)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a") as f:
            f.write(payload)

    def _rotate_locked(self) -> None:
        """Roll the active file to ``<path>.<k>`` (monotonic k) and drop
        the oldest rotated file past max_files. Called under the lock."""
        self._rot_seq += 1
        try:
            os.replace(self.path, f"{self.path}.{self._rot_seq}")
        except OSError:
            pass          # active file vanished: nothing to roll
        drop = self._rot_seq - self.max_files
        if drop >= 1:
            try:
                os.remove(f"{self.path}.{drop}")
            except OSError:
                pass
        self._file_bytes = 0
        from .metrics import QUERY_LOG_ROTATIONS
        QUERY_LOG_ROTATIONS.inc()

    # -- inspection ----------------------------------------------------------
    def rows(self) -> list[dict]:
        """The ring, oldest first (the system.query_log snapshot source)."""
        with self._lock:
            return [dict(r) for r in self._ring]

    def load_rows(self, rows) -> int:
        """Replay saved rows (a JSONL artifact) into the ring so
        ``system.query_log`` SQL works over an OFFLINE log — the
        scripts/slo_report.py dogfooding path. Returns rows loaded."""
        n = 0
        with self._lock:
            for r in rows:
                clean = {k: r.get(k) for k in COLUMN_NAMES}
                self._ring.append(clean)
                n += 1
            self._seq = max(self._seq,
                            max((r.get("seq") or 0 for r in self._ring),
                                default=0))
        return n


def read_jsonl(path: str) -> list[dict]:
    """Rows of one query-log JSONL file (rotated sets: pass each file;
    lexicographic filename order is chronological by construction)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


#: the process-global query log every statement completion reports into.
QUERY_LOG = QueryLog()

_env = os.environ.get("NDS_TPU_QUERY_LOG", "")
if _env and _env.lower() not in ("0", "false", "no", "off"):
    QUERY_LOG.configure(
        enabled=True,
        path=None if _env.lower() in ("1", "true", "yes", "on") else _env)
