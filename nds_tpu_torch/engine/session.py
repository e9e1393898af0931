"""Session: the user-facing entry point of the port's SQL engine.

Counterpart of ``nds_tpu/engine/session.py`` for the in-core path: tables
register from Arrow or CSV, and ``sql()`` parses, plans and
executes on the device (``backend="torch"``) or on the host numpy oracle
(``backend="numpy"``). The device is explicit: ``Session()`` runs on
"cuda" and raises when CUDA is absent; the CPU runs only when asked for
(``device="cpu"``), where each CUDA kernel's plain version stands in.

A repeated statement is not parsed or planned again: the executor keeps its
units by SQL text and takes them through record, compile+run and compiled
(``last_stats`` says which, see TorchExecutor.run_query).

Out-of-core (``out_of_core``, on by default): every maximal streamable
aggregate over a table above ``out_of_core_min_rows`` streams that table
through the card in ``chunk_rows`` morsels (``_sql_streaming``); a plan
with no streaming job runs in-core, whatever its scans' sizes.
``last_stats["mode"]`` is "streamed" for a streamed run. A morsel rides
one packed buffer (``narrow_lanes``) with dictionary and run-length
columns (``encoded_exec``), its lanes and encodings chosen once per scan
group from the table's stats (``column_stats``, ``column_enc_stats``).

Serving (the query service, ``nds_tpu_torch/service``): statements
serialize on ``_sql_lock`` (``sql`` and ``service_run``, which returns a
result with its typed ``ExecStats`` atomically), while the service's
planner threads read the catalog and the column stats under ``_lock``;
``abandon_inflight`` swaps fresh locks in after a watchdog gives a
dispatch up, and the streamed path yields the device lane between scan
groups and between morsels to a preemption hook (``_maybe_preempt``).
Every statement's stats land in ``last_exec_stats_typed`` through
``_finish_exec_stats``; ``last_stats`` stays the dict view.

Not in this slice: sharded morsels and feedback-adapted schedules; the
result cache, system tables, DML and EXPLAIN ANALYZE.
"""
from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Callable, Optional

import numpy as np
import pyarrow as pa
import pyarrow.dataset as pa_dataset
import torch

from ..config import EngineConfig
from ..obs import metrics as _metrics
from ..obs.profile import DEVICE_MEM
from ..obs.stats import ExecStats
from ..obs.trace import TRACER
from ..sql import parse_sql
from . import arrow_bridge
from .column import Table
from .executor import Executor
from .planner import Catalog, Planner


def resolve_device(device: Optional[str]) -> torch.device:
    """The torch device for the device path: "cuda" unless asked otherwise.
    Raises when CUDA is asked for (or defaulted to) but absent: the engine
    never continues on the CPU silently."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the device "
            "path on the CPU (each kernel's plain version)")
    return dev


class Session:
    def __init__(self, config: Optional[EngineConfig] = None,
                 device: Optional[str] = None):
        self.config = config or EngineConfig()
        if self.config.verify_plans != "off":
            raise ValueError("the port supports verify_plans='off' only")
        self.device = resolve_device(device or self.config.device)
        # _sql_lock serializes whole statements (sql, service_run): the
        # executor, the streamed state and the last-statement views stay
        # single-writer under many calling threads. _lock guards the
        # caches that work outside a statement reads and fills (the query
        # service's planner threads plan and read column stats while the
        # device lane runs). Both are RLocks, taken _sql_lock -> _lock
        self._sql_lock = threading.RLock()
        self._lock = threading.RLock()
        self._loaders: dict[str, Callable] = {}
        # table -> callable(columns) yielding arrow tables/batches in order,
        # the morsel source of a streamed scan
        self._batch_sources: dict[str, Callable] = {}
        # table -> callable() giving {column: (lo, hi)} value ranges, and
        # table -> callable(column) giving its encoding stats; their
        # results cached per registration (column_stats, column_enc_stats)
        self._stats_sources: dict[str, Callable] = {}
        self._enc_stats_sources: dict[str, Callable] = {}
        self._col_stats: dict[str, dict] = {}
        self._enc_stats: dict[str, dict] = {}
        # streamed-path state per query: rewritten plans, scan groups, the
        # stream executor, compiled morsel programs and slots (None: the
        # query has no streaming job); valid for one _stream_config_key
        self._stream_cache: dict = {}
        self._stream_cache_cfg = None
        # query -> why a plan with streaming jobs ran in-core instead
        self._stream_refused: dict[str, str] = {}
        self._schemas: dict[str, tuple[list[str], list[str]]] = {}
        self._est_rows: dict[str, int] = {}
        self._unique_cols: dict[str, frozenset] = {}
        self._cache: dict = {}
        self._generation = 0
        self._exec = None
        self._exec_gen = -1
        # plan nodes of the last sql() call that fell back to the host
        self.last_fallbacks: list[str] = []
        # the last device sql() call's unit stats: mode ("record",
        # "compile+run", "compiled", "adopted" or "eager"), device_ms,
        # segments, nojit_reason
        self.last_stats: dict = {}
        # the typed record of the last statement (_finish_exec_stats)
        self.last_exec_stats_typed: Optional[ExecStats] = None
        # label of the statement in flight, and its query-log context
        self._active_label: str = ""
        self._stmt_t0: float = 0.0
        self._stmt_log: bool = True
        # the snapshot version of an attached warehouse: none in the port
        self._warehouse_version: Optional[int] = None
        # morsel-boundary preemption: the query service installs a hook
        # the streamed path calls between scan groups and morsels (None:
        # one attribute read); _in_preempt keeps a nested statement from
        # being preempted in turn
        self._preempt_hook = None
        self._in_preempt = False

    def _dec_as_int(self) -> bool:
        return self.config.decimal_physical == "i64"

    def _set_unique_cols(self, name: str, col_names, unique_cols) -> None:
        """Declared single-column unique keys (late-materialization
        legality); None consults schema.UNIQUE_KEYS."""
        if unique_cols is None:
            from ..schema import UNIQUE_KEYS
            unique_cols = UNIQUE_KEYS.get(name, ())
        have = set(col_names)
        self._unique_cols[name] = frozenset(
            c for c in unique_cols if c in have)

    def _registered(self, name: str, names, dtypes, est_rows: int,
                    unique_cols, loader: Callable, batches: Callable,
                    stats: Optional[Callable] = None,
                    enc_stats: Optional[Callable] = None) -> None:
        with self._lock:
            self._schemas[name] = (list(names), list(dtypes))
            self._set_unique_cols(name, names, unique_cols)
            self._est_rows[name] = est_rows
            self._loaders[name] = loader
            self._batch_sources[name] = batches
            for src, fn in ((self._stats_sources, stats),
                            (self._enc_stats_sources, enc_stats)):
                if fn is None:
                    src.pop(name, None)
                else:
                    src[name] = fn
            for k in [k for k in self._cache if k[0] == name]:
                del self._cache[k]
            self._col_stats.pop(name, None)
            self._enc_stats.pop(name, None)
            self._generation += 1

    # -- registration -------------------------------------------------------
    def register_arrow(self, name: str, table: pa.Table,
                       est_rows: Optional[int] = None,
                       unique_cols: Optional[tuple] = None) -> None:
        dec = self._dec_as_int()
        names, dtypes = arrow_bridge.engine_schema(table.schema, dec)

        def load(columns=None, t=table, dec=dec):
            return arrow_bridge.from_arrow(
                t.select(list(columns)) if columns else t, dec)

        def batches(columns, t=table):
            yield t.select(list(columns)) if columns else t
        self._registered(
            name, names, dtypes,
            est_rows if est_rows is not None else table.num_rows,
            unique_cols, load, batches,
            stats=lambda t=table, dec=dec:
            arrow_bridge.table_column_stats(t, dec),
            enc_stats=lambda col, t=table, dec=dec:
            arrow_bridge.column_enc_stat(t.column(col), dec))

    def register_parquet(self, name: str, path: str,
                         est_rows: Optional[int] = None,
                         unique_cols: Optional[tuple] = None) -> None:
        """Register a parquet file or partitioned directory as a table; the
        row estimate comes from its metadata (``count_rows``), and a
        streamed scan reads it batch by batch."""
        dataset = pa_dataset.dataset(path, format="parquet",
                                     partitioning="hive")
        # dictionary pass-through for the fully dictionary-encoded string
        # columns: a morsel then carries codes + dictionary
        fmt = arrow_bridge.parquet_dataset_format(list(dataset.files))
        if fmt is not None:
            dataset = pa_dataset.dataset(path, format=fmt,
                                         partitioning="hive")
        dec = self._dec_as_int()
        names, dtypes = arrow_bridge.engine_schema(dataset.schema, dec)
        if est_rows is None:
            est_rows = dataset.count_rows()

        def load(columns=None, ds=dataset, dec=dec):
            cols = list(columns) if columns is not None else None
            return arrow_bridge.from_arrow(ds.to_table(columns=cols), dec)

        def batches(columns, ds=dataset):
            cols = list(columns) if columns is not None else None
            yield from ds.to_batches(columns=cols)
        # value ranges from the row groups' metadata (no data read);
        # encoding stats need the values: one read of the column
        self._registered(
            name, names, dtypes, est_rows, unique_cols, load, batches,
            stats=lambda ds=dataset, dec=dec:
            arrow_bridge.parquet_column_stats(list(ds.files), dec),
            enc_stats=lambda col, ds=dataset, dec=dec:
            arrow_bridge.column_enc_stat(
                ds.to_table(columns=[col]).column(col), dec))

    def register_csv(self, name: str, path: str, schema: pa.Schema,
                     est_rows: Optional[int] = None, delimiter: str = "|",
                     unique_cols: Optional[tuple] = None) -> None:
        """Register a pipe-delimited file or directory of files lazily."""
        import pyarrow.csv as pa_csv

        files = ([os.path.join(path, f) for f in sorted(os.listdir(path))]
                 if os.path.isdir(path) else [path])
        dec = self._dec_as_int()
        names, dtypes = arrow_bridge.engine_schema(schema, dec)

        def batches(columns, files=tuple(files), schema=schema):
            """One Arrow table per non-empty file, in order."""
            convert = pa_csv.ConvertOptions(
                column_types={f.name: f.type for f in schema},
                null_values=[""], strings_can_be_null=True,
                include_columns=list(columns) if columns else None)
            read = pa_csv.ReadOptions(column_names=[f.name for f in schema])
            parse = pa_csv.ParseOptions(delimiter=delimiter)
            for f in files:
                if os.path.getsize(f) > 0:
                    yield pa_csv.read_csv(f, read_options=read,
                                          parse_options=parse,
                                          convert_options=convert)

        def load(columns=None, dec=dec):
            return arrow_bridge.from_arrow(
                pa.concat_tables(list(batches(columns))), dec)
        self._registered(name, names, dtypes,
                         est_rows if est_rows is not None else 10000,
                         unique_cols, load, batches)

    def column_stats(self, name: str) -> dict:
        """{column: (lo, hi)} value ranges of a registered table in engine
        units (scaled ints for decimals, epoch days for dates); {} where
        its registration has no stats source (CSV). Computed once per
        registration; a scan group's lanes come from them. Thread-safe:
        the service's planner threads read it while the lane runs."""
        with self._lock:
            if name not in self._col_stats:
                src = self._stats_sources.get(name)
                stats = {}
                if src is not None:
                    try:
                        stats = src() or {}
                    except Exception:
                        stats = {}  # an optimization, never a failure
                self._col_stats[name] = stats
            return self._col_stats[name]

    def column_enc_stats(self, name: str, columns=None) -> dict:
        """{column: {"distinct": sorted int64 array or None, "runs": int,
        "rows": int}} encoding stats of (some of) a registered table's
        columns in engine units; {} where its registration has no source.
        Computed once per column and registration, for the columns a scan
        group streams; a group's encodings come from them. Thread-safe
        like column_stats."""
        with self._lock:
            src = self._enc_stats_sources.get(name)
            if src is None:
                return {}
            if columns is None:
                columns = self._schemas.get(name, ([], []))[0]
            cache = self._enc_stats.setdefault(name, {})
            for c in columns:
                if c not in cache:
                    try:
                        cache[c] = src(c)
                    except Exception:
                        cache[c] = None  # an optimization, never fatal
            return {c: cache[c] for c in columns if cache.get(c)}

    def iter_morsels(self, name: str, columns: list[str], rows: int):
        """Yield host Tables of at most `rows` rows each, WITHOUT
        materializing the whole table (out-of-core scans). Parquet datasets
        stream record batches; arrow tables slice zero-copy; CSV falls back
        to per-file reads."""
        def flush(pending):
            # a single pending slice (aligned source batches, the common
            # parquet row-group case) passes through zero-copy — concat
            # would re-chunk and copy for nothing
            return pending[0] if len(pending) == 1 \
                else pa.concat_tables(pending)

        def emit(batches):
            """Re-chunk a stream of arrow tables into `rows`-sized morsels."""
            pending: list[pa.Table] = []
            count = 0
            for b in batches:
                t = pa.Table.from_batches([b]) if isinstance(
                    b, pa.RecordBatch) else b
                while t.num_rows:
                    take = min(rows - count, t.num_rows)
                    pending.append(t.slice(0, take))
                    t = t.slice(take)
                    count += take
                    if count == rows:
                        yield flush(pending)
                        pending, count = [], 0
            if pending:
                yield flush(pending)

        src = self._batch_sources.get(name)
        if src is not None:
            batches = src(columns)
        else:  # fallback: full load, sliced (correct, not memory-bounded)
            batches = [arrow_bridge.to_arrow(self.load_table(name, columns))]
        for part in emit(batches):
            yield arrow_bridge.from_arrow(part, self._dec_as_int())

    def load_table(self, name: str, columns=None) -> Table:
        """Load a table, optionally projected to `columns`; cached per
        projection, and a cached full table serves any subset.
        Thread-safe: the projection cache fills under the state lock."""
        with self._lock:
            key = (name, tuple(columns) if columns is not None else None)
            if key in self._cache:
                return self._cache[key]
            if columns is not None and (name, None) in self._cache:
                full = self._cache[(name, None)]
                idx = {n: i for i, n in enumerate(full.names)}
                sub = Table(list(columns),
                            [full.columns[idx[c]] for c in columns])
                self._cache[key] = sub
                return sub
            self._cache[key] = self._loaders[name](columns)
            return self._cache[key]

    # -- query --------------------------------------------------------------
    def _est_rows_for(self, name: str, default: int,
                      label: Optional[str] = None) -> int:
        """Planning-time row estimate of `name`: the registered estimate.
        (`label` scopes the reference's observed-row feedback, which the
        port has not: its planner threads pass it all the same.)"""
        with self._lock:
            return self._est_rows.get(name, default)

    def _catalog(self, label: Optional[str] = None) -> Catalog:
        with self._lock:
            tables = {name: (sch[0], sch[1],
                             self._est_rows_for(name, 1000, label))
                      for name, sch in self._schemas.items()}
            unique = dict(self._unique_cols)
        return Catalog(tables, dec_enabled=self._dec_as_int(),
                       unique_cols=unique,
                       late_mat=self.config.late_materialization,
                       late_mat_min_rows=self.config.late_mat_min_rows,
                       verify_plans="off")

    def _executor(self):
        """The session-held device executor: its device-resident scans
        persist across queries until a table (re-)registers."""
        if self._exec is None or self._exec_gen != self._generation:
            self._exec = self._new_executor(self.config.jit_plans)
            self._exec_gen = self._generation
        self._exec._jit_plans = self.config.jit_plans
        return self._exec

    def _new_executor(self, jit_plans: bool):
        from .torch_backend.executor import TorchExecutor
        cfg = self.config
        return TorchExecutor(
            self.load_table, self.device, gpu_kernels=cfg.gpu_kernels,
            jit_plans=jit_plans, segment_plan_nodes=cfg.segment_plan_nodes,
            segment_min_cte_nodes=cfg.segment_min_cte_nodes,
            segment_cache_entries=cfg.segment_cache_entries,
            scan_budget_bytes=int(cfg.scan_budget_gb * (1 << 30)))

    def plan(self, query: str):
        return Planner(self._catalog()).plan_query(parse_sql(query))

    def sql(self, query: str, backend: Optional[str] = None,
            label: Optional[str] = None) -> Table:
        """Run a query; backend "torch" (the device path, the default) or
        "numpy" (the host oracle). `label` names the statement in program
        labels, spans and the query log (a short hash of the text by
        default). Thread-safe: callers serialize on the statement lock,
        and last_stats describes the last statement of any caller (a
        caller that needs its own uses service_run)."""
        if "system." in query or "SYSTEM." in query:
            self._maybe_system_query(query)
        with self._sql_lock:
            return self._sql_locked(query, backend, label)

    def service_run(self, query: str, backend: Optional[str] = None,
                    label: Optional[str] = None, plan=None):
        """The query service's entry: as sql(), but returns (Table,
        ExecStats) atomically, and takes the plan the service's planner
        stage built (a first sighting then skips parsing and planning).
        The service cuts the statement's query-log row itself."""
        with self._sql_lock:
            table = self._sql_locked(query, backend, label, plan=plan,
                                     log_row=False)
            return table, self.last_exec_stats_typed

    def abandon_inflight(self) -> None:
        """A deadline just abandoned a worker thread mid-statement (python
        threads cannot be killed): the zombie may still hold this
        session's locks, so fresh ones go in and the next statement runs
        at once. The zombie may still be using the card and the executor
        then, as in the reference: bounded by its hang, its caller has
        already failed the query."""
        self._sql_lock = threading.RLock()
        self._lock = threading.RLock()

    # -- morsel-boundary preemption (the service's fair scheduler) -----------
    def _maybe_preempt(self) -> None:
        """Yield point of the streamed path, between scan groups and
        between morsels: with a hook installed, hand the device lane to
        short tickets now. Never re-entered from a preempting statement."""
        hook = self._preempt_hook
        if hook is not None and not self._in_preempt:
            hook()

    def preempt_scope(self):
        """Context for a statement nested at a yield point, on the thread
        that holds the statement lock (the RLock's re-entry makes it
        legal): the outer statement's views and its device-memory window
        are saved and restored, and the nested one cannot be preempted."""
        import contextlib

        @contextlib.contextmanager
        def _scope():
            saved = (self.last_fallbacks, self.last_stats,
                     self.last_exec_stats_typed, self._active_label,
                     self._stmt_t0, self._stmt_log)
            win = DEVICE_MEM.window_peak()
            self._in_preempt = True
            try:
                yield self
            finally:
                self._in_preempt = False
                (self.last_fallbacks, self.last_stats,
                 self.last_exec_stats_typed, self._active_label,
                 self._stmt_t0, self._stmt_log) = saved
                DEVICE_MEM.restore_window(win)
        return _scope()

    def attach_result_cache(self, cache) -> None:
        raise NotImplementedError(
            "the semantic result cache (engine/result_cache.py) is not "
            "ported yet: ROADMAP A.3's remainder, item 1")

    @staticmethod
    def _maybe_system_query(query: str) -> None:
        """Raise for a statement over ``system.*`` tables: the system
        catalog (obs/system_tables.py) is not ported yet. A statement that
        only mentions the prefix in a literal runs as usual."""
        from ..sql import ast_nodes as A
        names: set = set()
        seen: set = set()

        def walk(x):
            if x is None or id(x) in seen:
                return
            seen.add(id(x))
            if isinstance(x, A.TableRef):
                names.add(x.name)
            if isinstance(x, (list, tuple)):
                for item in x:
                    walk(item)
            elif hasattr(x, "__dict__"):
                for v in vars(x).values():
                    walk(v)
        walk(parse_sql(query))
        if any(n.lower().startswith("system.") for n in names):
            raise NotImplementedError(
                "system.* tables (obs/system_tables.py) are not ported "
                "yet: ROADMAP A.5")

    @staticmethod
    def _auto_label(query: str) -> str:
        return "q" + hashlib.sha1(query.encode()).hexdigest()[:8]

    def _sql_locked(self, query: str, backend: Optional[str],
                    label: Optional[str], plan=None,
                    log_row: bool = True) -> Table:
        backend = backend or "torch"
        if backend not in ("torch", "numpy"):
            raise ValueError(f"unknown backend {backend!r} "
                             "(expected 'torch' or 'numpy')")
        self.last_fallbacks = []
        self.last_exec_stats_typed = None
        # units are labelled "<label>/<unit>" in the executor's messages
        self._active_label = label or self._auto_label(query)
        self._stmt_t0 = time.perf_counter()
        self._stmt_log = log_row
        DEVICE_MEM.mark_window()
        _metrics.QUERIES_RUN.inc()
        with TRACER.span("query", label=self._active_label,
                         backend=backend):
            if backend == "numpy":
                return Executor(self.load_table).execute(
                    plan if plan is not None else self.plan(query))
            self.last_stats = {}
            refused = None
            if self.config.out_of_core:
                result = self._sql_streaming(query)
                if result is not None:
                    self._finish_exec_stats(
                        _typed_stats(self.last_stats, self.last_fallbacks),
                        rows=result.num_rows)
                    return result
                refused = self._stream_refused.get(query)
            from .torch_backend.device import to_host
            ex = self._executor()
            ex.query_label = self._active_label

            def factory():
                if plan is not None:
                    return plan
                with TRACER.span("plan", label=self._active_label):
                    return self.plan(query)
            with ex.on_stream():
                result = to_host(ex.run_query(("sql", query), factory))
            self.last_fallbacks = list(ex.fallback_nodes)
            self.last_stats = dict(ex.last_stats)
            if refused:
                self.last_stats["stream_refused"] = refused
            self._finish_exec_stats(
                _typed_stats(self.last_stats, self.last_fallbacks),
                rows=result.num_rows)
            return result

    def _finish_exec_stats(self, stats: ExecStats,
                           rows: Optional[int] = None,
                           log: Optional[bool] = None) -> None:
        """The one place a statement's typed stats land: the statement's
        device-memory window, ``last_exec_stats_typed``, the process
        registry's counters and, with the query log on, its row (``log``
        overrides the statement's flag: the service passes False for its
        last-dispatch view and logs per ticket)."""
        stats.mem_peak_bytes = DEVICE_MEM.window_peak()
        stats.mem_live_bytes = DEVICE_MEM.live
        if self.config.scan_budget_gb > 0:
            stats.mem_headroom_bytes = \
                int(self.config.scan_budget_gb * (1 << 30)) - \
                stats.mem_peak_bytes
        self.last_exec_stats_typed = stats
        from ..obs.query_log import QUERY_LOG
        if QUERY_LOG.enabled and (self._stmt_log if log is None else log):
            QUERY_LOG.record(
                stats, source="session", label=self._active_label,
                wall_ms=round((time.perf_counter() - self._stmt_t0)
                              * 1000.0, 3) if self._stmt_t0 else None,
                rows=rows)
        if stats.fallback_reasons:
            _metrics.HOST_FALLBACKS.inc(len(stats.fallback_reasons))
        if stats.prefetch_error_details:
            _metrics.PREFETCH_ERRORS.inc(len(stats.prefetch_error_details))
        if stats.scan_passes:
            _metrics.SCAN_PASSES.inc(stats.scan_passes)
        if stats.morsels:
            _metrics.MORSELS.inc(stats.morsels)
        if stats.bytes_uploaded:
            _metrics.BYTES_UPLOADED.inc(stats.bytes_uploaded)
        if stats.host_decode_ms:
            _metrics.HOST_DECODE_MS.inc(
                round(sum(stats.host_decode_ms.values()), 3))

    # -- the streamed (out-of-core) path -------------------------------------
    def _stream_config_key(self) -> tuple:
        """Streaming-state cache validity fingerprint: the cached rewritten
        plans, scan groups, compiled morsel programs, and not-streamable
        sentinels are all functions of the catalog generation AND these
        config fields — toggling any of them on a live session must not
        replay a stale entry."""
        cfg = self.config
        return (self._generation, cfg.out_of_core_min_rows, cfg.chunk_rows,
                cfg.stream_compact_rows, cfg.shared_scan,
                cfg.stream_fusion_max_branches, cfg.late_materialization,
                cfg.late_mat_min_rows, cfg.decimal_physical,
                cfg.narrow_lanes, cfg.encoded_exec,
                tuple(sorted(cfg.gpu_kernels)))

    def _drop_stream_cache(self) -> None:
        """Close every cached morsel slot and forget the streamed state."""
        for sent in self._stream_cache.values():
            for gstate in (sent or {}).get("gstates", ()):
                _close_group(gstate)
        self._stream_cache = {}
        self._stream_refused = {}

    def _sql_streaming(self, query: str) -> Optional[Table]:
        """Out-of-core execution: every MAXIMAL streamable aggregate
        subtree in the plan (top-level, below joins, inside CTE bodies,
        scalar subqueries, UNION ALL fact-channel branches, semi-join build
        sides) streams its big scan through the card in chunk_rows morsels.
        All branches of a query that scan the SAME big table form one
        ScanGroup (streaming.plan_scan_groups): the union of their columns
        is staged once per morsel into the group's slot, and the members'
        programs read it. Per-morsel partial aggregates merge on the host
        (compacted past stream_compact_rows), and a MaterializedNode
        replaces each aggregate subtree before the rest of the plan runs on
        the host numpy executor, as in the reference. Returns None when
        nothing streams (``last_stats["stream_refused"]`` says why, where
        jobs were found)."""
        from . import streaming
        from .plan import BCol, MaterializedNode
        from .torch_backend.device import (bucket, decode_stats, enc_tag,
                                           enc_lane_bytes, lane_bytes)

        cfg_key = self._stream_config_key()
        if self._stream_cache_cfg != cfg_key:
            self._drop_stream_cache()
            self._stream_cache_cfg = cfg_key
        sent = self._stream_cache.get(query, "miss")
        if sent is None:          # known not-streamable: skip the re-plan
            return None
        t_start = time.perf_counter()
        if sent == "miss":
            plan = self.plan(query)
            jobs = streaming.find_streaming_jobs(
                plan, lambda t: self._est_rows.get(t, 0),
                self.config.out_of_core_min_rows)
            if not jobs:
                self._stream_cache[query] = None
                return None
            groups = streaming.plan_scan_groups(jobs,
                                                self.config.shared_scan)
            if self.config.narrow_lanes and \
                    bucket(self.config.chunk_rows) % 64 == 0:
                # (a packed slot needs a capacity that is a multiple of
                # 64; a smaller morsel stays plain)
                self._plan_layouts(groups)
            # ONE executor serves every group of every job, kept across
            # repeated executions: groups run sequentially, its scan cache
            # uploads each small table once, and each group's slot enters
            # it under the group's morsel key while the group streams
            sent = {"plan": plan, "jobs": jobs, "groups": groups,
                    "exec": self._new_executor(jit_plans=True),
                    "gstates": [{"cqs": None, "ents": None, "fused": False,
                                 "slot": None, "dicts": None}
                                for _ in groups]}
            self._stream_cache[query] = sent

        plan, jobs, groups = sent["plan"], sent["jobs"], sent["groups"]
        dec0 = decode_stats()
        enc_bytes_saved = 0
        ex = sent["exec"]
        ex.query_label = self._active_label
        pstats = {"re_records": 0, "captures": 0, "bytes_uploaded": 0,
                  "upload_ms": 0.0, "stage_ms": 0.0, "stage_wait_ms": 0.0,
                  "graph_ms": 0.0, "captured_launches": {},
                  "graph_launches": {}}
        morsels_per_table: dict[str, int] = {}
        host_decode_ms: dict[str, float] = {}
        prefetch_errs: list[str] = []
        fused_groups = 0
        total_morsels = 0
        fallbacks: list[str] = []

        def refuse(reason: str) -> None:
            for gstate in sent["gstates"]:
                _close_group(gstate)
            self._stream_cache[query] = None
            self._stream_refused[query] = reason

        partials: list[list] = [[] for _ in jobs]
        with ex.on_stream():
            for ji, job in enumerate(jobs):
                for branch in job.branches:
                    if branch.big_table is None:
                        # no big scan in this branch: one-shot in-core
                        # partial on the card
                        partials[ji].append(arrow_bridge.to_arrow(
                            self._incore_partial(ex, branch)))
                        fallbacks += ex.fallback_nodes
            for group, gstate in zip(groups, sent["gstates"]):
                sinks = [(jobs[ji], partials[ji]) for ji, _bi in group.members]
                # scan-group boundary: yield the device lane to preempting
                # tickets (no hook installed: a no-op)
                self._maybe_preempt()
                out = self._stream_group(group, ex, gstate, sinks,
                                         prefetch_errs, pstats)
                if isinstance(out, str):
                    refuse(out)
                    return None     # not device-runnable: in-core path
                morsels_run, host_ms = out
                total_morsels += morsels_run
                fused_groups += 1 if gstate["fused"] else 0
                morsels_per_table[group.table] = \
                    morsels_per_table.get(group.table, 0) + morsels_run
                host_decode_ms[group.table] = round(
                    host_decode_ms.get(group.table, 0.0) + host_ms, 3)
                if group.encodings is not None:
                    cap = bucket(self.config.chunk_rows)
                    enc_bytes_saved += morsels_run * (
                        lane_bytes(group.plain_lanes, cap) -
                        enc_lane_bytes(group.lanes, cap, group.encodings))
        stream_s = time.perf_counter() - t_start
        f_t0 = time.perf_counter()
        mapping: dict = {}
        for ji, job in enumerate(jobs):
            merged = arrow_bridge.from_arrow(
                pa.concat_tables(partials[ji], promote_options="permissive"),
                self._dec_as_int())
            mat = MaterializedNode(table=merged, label="streamed-partials",
                                   out_names=list(job.partial_names),
                                   out_dtypes=list(job.partial_dtypes))
            sub_res = Executor(self.load_table).execute(job.build_final(mat))
            mat_node = MaterializedNode(
                table=sub_res, label="streamed-agg",
                out_names=list(job.agg.out_names),
                out_dtypes=list(job.agg.out_dtypes))
            if job.join_patch is not None:
                # semi/anti build side: probe the materialized key set
                keys = [BCol(job.agg.out_dtypes[i], i, job.agg.out_names[i])
                        for i in range(len(job.join_patch.right_keys))]
                mapping[id(job.join_patch)] = {"right": mat_node,
                                               "right_keys": keys}
            else:
                mapping[id(job.agg)] = mat_node
        final_plan = streaming.substitute_nodes(plan, mapping)
        result = Executor(self.load_table).execute(final_plan)
        finalize_ms = (time.perf_counter() - f_t0) * 1000
        wall_s = time.perf_counter() - t_start
        self.last_fallbacks = fallbacks
        stage_ms = pstats["stage_ms"]
        dec1 = decode_stats()
        self.last_stats = {
            "mode": "streamed",
            "jobs": len(jobs),
            "morsels": total_morsels,
            "morsel_rows": self.config.chunk_rows,
            "re_records": pstats["re_records"],
            "shared_scan": bool(self.config.shared_scan),
            "scan_passes": len(groups),
            "tables_streamed": len(morsels_per_table),
            "branches_served": sum(len(g.members) for g in groups),
            "fused_groups": fused_groups,
            "bytes_uploaded": pstats["bytes_uploaded"],
            "morsels_per_table": morsels_per_table,
            # the morsels' wire layout: each streamed column's lane and
            # encoding, the bytes the encodings saved over the lanes alone,
            # and the decode sites (and the column slots they decoded)
            # the pass's record passes and captures met
            "narrow_lanes": bool(self.config.narrow_lanes),
            "lane_spec": {g.table: dict(zip(g.columns, g.lanes))
                          for g in groups if g.lanes is not None},
            "encoded_exec": bool(self.config.encoded_exec
                                 and self.config.narrow_lanes),
            "enc_spec": {g.table: dict(zip(g.columns,
                                           map(enc_tag, g.encodings)))
                         for g in groups if g.encodings is not None}
            or None,
            "enc_bytes_saved": enc_bytes_saved or None,
            "decode_sites": dec1["sites"] - dec0["sites"],
            "decode_rows": dec1["rows"] - dec0["rows"],
            # codebooks uploaded to the card, and decode sites that found
            # theirs there already
            "dict_uploads": dec1["book_uploads"] - dec0["book_uploads"],
            "dict_uploads_saved": dec1["book_reuses"] - dec0["book_reuses"],
            "host_decode_ms": host_decode_ms,
            "prefetch_error_details": prefetch_errs,
            "fallbacks": list(fallbacks),
            # the port's own: graph captures in this pass, the host's merge
            # and finalize after the last morsel, the copies' time and the
            # share of staging (decode + copy) hidden under the runs
            "captures": pstats["captures"],
            "finalize_ms": round(finalize_ms, 3),
            "stream_ms": round(stream_s * 1000, 3),
            "upload_ms": round(pstats["upload_ms"], 3),
            "stage_ms": round(stage_ms, 3),
            "stage_hidden_share": (1.0 - pstats["stage_wait_ms"] / stage_ms)
            if stage_ms > 0 else None,
            "graph_ms": round(pstats["graph_ms"], 3),
            # CUDA kernel launches made while capturing this pass's graphs,
            # and those its graph replays ran (a replay calls no wrapper)
            "captured_launches": pstats["captured_launches"],
            "graph_launches": pstats["graph_launches"],
            # device busy share of the pass: CUDA-event time of the graph
            # replays over the wall (None on the CPU)
            "busy_share": pstats["graph_ms"] / 1000 / wall_s
            if self.device.type == "cuda" else None,
        }
        return result

    def _plan_layouts(self, groups: list) -> None:
        """Each group's lanes from the table's value ranges, and (with
        encoded_exec) its encodings from its cardinality and run stats,
        ONCE for every morsel of every pass (a per-morsel choice would
        change a program's layout mid-stream); recorded on the group and
        on its members' morsel scans."""
        from . import streaming
        from .torch_backend.device import (bucket, plan_encodings,
                                           plan_lanes)
        for g in groups:
            st = self.column_stats(g.table)
            streaming.set_group_lanes(g, plan_lanes(
                g.dtypes, [st.get(c) for c in g.columns]))
            if not self.config.encoded_exec or g.lanes is None:
                continue
            est = self.column_enc_stats(g.table, g.columns)
            planned = plan_encodings(
                g.dtypes, g.lanes, [est.get(c) for c in g.columns],
                bucket(self.config.chunk_rows))
            if planned is not None:
                streaming.set_group_encodings(g, *planned)

    def _incore_partial(self, ex, branch) -> Table:
        """One-shot partial aggregate for a branch without a big scan, on
        the card through the executor's unit lifecycle."""
        from .torch_backend.compiled import plan_fingerprint
        from .torch_backend.device import to_host
        key = ("stream-incore", plan_fingerprint(branch.partial_plan))
        return to_host(ex.run_query(key, lambda: branch.partial_plan))

    def _combine_partials(self, job, partials: list) -> pa.Table:
        """Re-aggregate accumulated partial tables into one (partial-schema
        preserving; associative, so repeatable)."""
        from .plan import MaterializedNode
        merged = arrow_bridge.from_arrow(
            pa.concat_tables(partials, promote_options="permissive"),
            self._dec_as_int())
        mat = MaterializedNode(table=merged, label="stream-compact",
                               out_names=list(job.partial_names),
                               out_dtypes=list(job.partial_dtypes))
        return arrow_bridge.to_arrow(
            Executor(self.load_table).execute(job.build_combine(mat)))

    def _stream_group(self, group, ex, state: dict, sinks: list,
                      prefetch_errs: list, pstats: dict):
        """Morsel loop for one shared-scan group. ONE morsel iterator and
        ONE staged copy per morsel serve EVERY member branch: a worker
        thread decodes morsel k+1 and copies it to the slot's staging
        buffer while the card runs morsel k from the slot. A group within
        the fusion budget records its member plans under one schedule
        (record_plans) and replays them as ONE CUDA graph per morsel;
        larger groups run per-member programs over the same slot. Every
        cap decision is inflated to the morsel bound
        (streaming.inflate_schedule), so one program serves every morsel;
        a morsel that outgrows it (ReplayMismatch) runs eagerly, counted in
        re_records. Before each replay the slot's string dictionaries are
        checked against the ones the programs were recorded with; a new
        dictionary records again (re_records), since a graph replays the
        lookup tables of its capture. `sinks[i]` is (job, partials_list)
        for member i; partials compact in the loop past
        stream_compact_rows. Staging-thread failures are recorded into
        `prefetch_errs` and the morsel restages synchronously. Returns
        (morsels, host decode ms), or a reason string when some member is
        not device-runnable."""
        from . import streaming
        from .torch_backend.compiled import CompiledQuery, ReplayMismatch
        from .torch_backend.device import MorselSlot, bucket, to_host

        morsel_rows = self.config.chunk_rows
        mkey = group.morsel_key
        fuse_max = self.config.stream_fusion_max_branches
        fuse = len(group.plans) > 1 and \
            (fuse_max <= 0 or len(group.plans) <= fuse_max)
        if state["slot"] is None:
            # packed when the group has lanes (its codebooks go to the
            # card here, once)
            state["slot"] = MorselSlot(group.columns, group.dtypes,
                                       bucket(morsel_rows), ex.device,
                                       lanes=group.lanes,
                                       encs=group.encodings,
                                       codebooks=group.codebooks)
        slot = state["slot"]
        label = f"{self._active_label}/morsel:{group.table}"
        str_dicts = slot.str_dicts

        def record_first():
            """Record the members' schedule on the slot's morsel and build
            their programs; a fallback reason when a member falls back."""
            ex.fallback_nodes = []
            if fuse:
                _outs, decisions, scan_keys = ex.record_plans(group.plans)
                if ex.fallback_nodes:
                    return f"host fallback: {ex.fallback_nodes}"
                state["cqs"] = [CompiledQuery(
                    list(group.plans),
                    streaming.inflate_schedule(decisions, morsel_rows),
                    scan_keys, ex, label=label)]
                state["ents"] = [{"scan_keys": scan_keys}]
            else:
                cqs, ents = [], []
                for bi, p in enumerate(group.plans):
                    _out, decisions, scan_keys = ex.record_plan(p)
                    if ex.fallback_nodes:
                        return f"host fallback: {ex.fallback_nodes}"
                    cqs.append(CompiledQuery(
                        p, streaming.inflate_schedule(decisions,
                                                      morsel_rows),
                        scan_keys, ex, label=f"{label}#{bi}"))
                    ents.append({"scan_keys": scan_keys})
                state["cqs"], state["ents"] = cqs, ents
            state["fused"] = fuse
            state["dicts"] = str_dicts()
            return None

        def run_one(cq, ent):
            st: dict = {}
            out = cq.run(ex._scans_for(ent), stats=st)
            pstats["captures"] += 1 if "capture_s" in st else 0
            _add(pstats["captured_launches"], st.get("captured_launches"))
            if "graph_ms" in st:        # a graph replay ran its kernels
                pstats["graph_ms"] += st["graph_ms"]
                _add(pstats["graph_launches"], cq.captured_launches)
            return out

        def run_members() -> list:
            """Every member program against the slot: one fused run, or
            per-member runs; member outputs in group.plans order."""
            try:
                if state["fused"]:
                    return list(run_one(state["cqs"][0], state["ents"][0]))
                return [run_one(cq, ent)
                        for cq, ent in zip(state["cqs"], state["ents"])]
            except ReplayMismatch:
                # the morsel outgrew the inflated schedule: run it eagerly
                pstats["re_records"] += 1
                if state["fused"]:
                    return ex.record_plans(group.plans)[0]
                return [ex.record_plan(p)[0] for p in group.plans]

        timing = {"host_ms": 0.0}

        def pull(it):
            """The next morsel: the host's Arrow->engine decode (IO,
            dictionaries, validity), timed."""
            t0 = time.perf_counter()
            m = next(it, None)
            timing["host_ms"] += (time.perf_counter() - t0) * 1000.0
            return m if m is None or m.names == list(group.columns) \
                else m.select(list(group.columns))

        def stage(m) -> None:
            t0 = time.perf_counter()
            pstats["upload_ms"] += slot.stage(m)
            pstats["bytes_uploaded"] += slot.bytes
            pstats["stage_ms"] += (time.perf_counter() - t0) * 1000.0

        staged: dict = {}
        worker = None
        count = 0
        done = False
        try:
            it = iter(self.iter_morsels(group.table, group.columns,
                                        morsel_rows))
            t0 = time.perf_counter()
            morsel = pull(it)
            pstats["stage_ms"] += (time.perf_counter() - t0) * 1000.0
            if morsel is not None:
                stage(morsel)
            # the first morsel's decode and copy are in no run's shadow
            pstats["stage_wait_ms"] += (time.perf_counter() - t0) * 1000.0
            while morsel is not None:
                # morsel boundary: the staging thread is joined and the
                # last morsel's partials are on the host
                self._maybe_preempt()
                ex._scan_cache[mkey] = slot.load()
                if state["cqs"] is not None and not _same_dicts(
                        state["dicts"], str_dicts()):
                    # a new string dictionary: record again on this morsel
                    pstats["re_records"] += 1
                    state["cqs"] = None
                if state["cqs"] is None:
                    reason = record_first()
                    if reason is not None:
                        return reason

                def work():
                    t_w = time.perf_counter()
                    try:
                        m = pull(it)
                    except BaseException as e:   # the source failed
                        staged["source_err"] = e
                        return
                    staged["morsel"] = m
                    staged["pull_ms"] = (time.perf_counter() - t_w) * 1000
                    if m is None:
                        return
                    try:
                        stage(m)
                    except BaseException as e:  # surfaced via prefetch_errs
                        staged["err"] = e
                # stage the NEXT morsel concurrently with this run
                worker = threading.Thread(target=work, daemon=True)
                worker.start()
                outs = run_members()
                for (job, plist), out in zip(sinks, outs):
                    plist.append(arrow_bridge.to_arrow(to_host(out)))
                    if sum(p.num_rows for p in plist) > \
                            self.config.stream_compact_rows:
                        plist[:] = [self._combine_partials(job, plist)]
                count += 1
                t_j = time.perf_counter()
                worker.join()
                worker = None
                pstats["stage_wait_ms"] += (time.perf_counter() - t_j) * 1000
                pstats["stage_ms"] += staged.pop("pull_ms", 0.0)
                if "source_err" in staged:
                    raise staged.pop("source_err")
                morsel = staged.pop("morsel")
                err = staged.pop("err", None)
                if err is not None:
                    prefetch_errs.append(f"{type(err).__name__}: {err}")
                    t_s = time.perf_counter()
                    stage(morsel)
                    pstats["stage_wait_ms"] += \
                        (time.perf_counter() - t_s) * 1000
            done = True
        finally:
            # free every morsel buffer even on a mid-stream failure: the
            # slot leaves the executor's scan cache, and on a failure the
            # slot itself and its programs go (a later run starts cold)
            if worker is not None:
                worker.join()
            ex._scan_cache.pop(mkey, None)
            if not done:
                _close_group(state)
        if count == 0:
            _close_group(state)
            return "empty source"   # the in-core path handles it
        return count, timing["host_ms"]


#: ExecStats fields a statement's stats dict fills by name
_STAT_FIELDS = frozenset(f for f in ExecStats.__dataclass_fields__
                         if f not in ("extra", "fallback_reasons",
                                      "prefetch_error_details",
                                      "node_stats"))


def _typed_stats(stats: dict, fallbacks: list) -> ExecStats:
    """The typed record of a statement's stats dict (the port's
    ``last_stats``): its keys with a field of their own fill it, the rest
    ride ``extra`` verbatim."""
    extra = {k: v for k, v in stats.items()
             if k not in _STAT_FIELDS and k not in (
                 "node_rows", "fallbacks", "prefetch_error_details")}
    return ExecStats(
        fallback_reasons=list(fallbacks or ()),
        prefetch_error_details=list(stats.get("prefetch_error_details")
                                    or ()),
        node_stats=stats.get("node_rows"), extra=extra,
        **{k: v for k, v in stats.items() if k in _STAT_FIELDS})


def _same_dicts(recorded: list, current: list) -> bool:
    """Whether the slot's string dictionaries are the ones a program was
    recorded with (the same object, or equal values)."""
    if len(recorded) != len(current):
        return False
    for a, b in zip(recorded, current):
        if a is b:
            continue
        if a is None or b is None or len(a) != len(b) or \
                not np.array_equal(np.asarray(a, dtype=object),
                                   np.asarray(b, dtype=object)):
            return False
    return True


def _add(total: dict, counts: Optional[dict]) -> None:
    for k, v in (counts or {}).items():
        total[k] = total.get(k, 0) + v


def _close_group(state: dict) -> None:
    """Drop a scan group's programs and close its morsel slot."""
    state["cqs"] = state["ents"] = None
    if state.get("slot") is not None:
        state["slot"].close()
        state["slot"] = None
