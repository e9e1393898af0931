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

Not in this slice: out-of-core (morsel-streamed) scans, which raise; the
result cache, query log, system tables, DML and EXPLAIN ANALYZE.
"""
from __future__ import annotations

import hashlib
import os
from typing import Callable, Optional

import pyarrow as pa
import torch

from ..config import EngineConfig
from ..sql import parse_sql
from . import arrow_bridge
from .column import Table
from .executor import Executor
from .plan import ScanNode, iter_plan_nodes
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
        self._loaders: dict[str, Callable] = {}
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
                    unique_cols, loader: Callable) -> None:
        self._schemas[name] = (list(names), list(dtypes))
        self._set_unique_cols(name, names, unique_cols)
        self._est_rows[name] = est_rows
        self._loaders[name] = loader
        for k in [k for k in self._cache if k[0] == name]:
            del self._cache[k]
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
        self._registered(name, names, dtypes,
                         est_rows if est_rows is not None else table.num_rows,
                         unique_cols, load)

    def register_csv(self, name: str, path: str, schema: pa.Schema,
                     est_rows: Optional[int] = None, delimiter: str = "|",
                     unique_cols: Optional[tuple] = None) -> None:
        """Register a pipe-delimited file or directory of files lazily."""
        import pyarrow.csv as pa_csv

        files = ([os.path.join(path, f) for f in sorted(os.listdir(path))]
                 if os.path.isdir(path) else [path])
        dec = self._dec_as_int()
        names, dtypes = arrow_bridge.engine_schema(schema, dec)

        def load(columns=None, files=tuple(files), schema=schema, dec=dec):
            convert = pa_csv.ConvertOptions(
                column_types={f.name: f.type for f in schema},
                null_values=[""], strings_can_be_null=True,
                include_columns=list(columns) if columns else None)
            read = pa_csv.ReadOptions(column_names=[f.name for f in schema])
            parse = pa_csv.ParseOptions(delimiter=delimiter)
            parts = [pa_csv.read_csv(f, read_options=read,
                                     parse_options=parse,
                                     convert_options=convert)
                     for f in files if os.path.getsize(f) > 0]
            return arrow_bridge.from_arrow(pa.concat_tables(parts), dec)
        self._registered(name, names, dtypes,
                         est_rows if est_rows is not None else 10000,
                         unique_cols, load)

    def load_table(self, name: str, columns=None) -> Table:
        """Load a table, optionally projected to `columns`; cached per
        projection, and a cached full table serves any subset."""
        key = (name, tuple(columns) if columns is not None else None)
        if key in self._cache:
            return self._cache[key]
        if columns is not None and (name, None) in self._cache:
            full = self._cache[(name, None)]
            idx = {n: i for i, n in enumerate(full.names)}
            sub = Table(list(columns), [full.columns[idx[c]] for c in columns])
            self._cache[key] = sub
            return sub
        self._cache[key] = self._loaders[name](columns)
        return self._cache[key]

    # -- query --------------------------------------------------------------
    def _catalog(self) -> Catalog:
        return Catalog({name: (sch[0], sch[1], self._est_rows.get(name, 1000))
                        for name, sch in self._schemas.items()},
                       dec_enabled=self._dec_as_int(),
                       unique_cols=dict(self._unique_cols),
                       late_mat=self.config.late_materialization,
                       late_mat_min_rows=self.config.late_mat_min_rows,
                       verify_plans="off")

    def _executor(self):
        """The session-held device executor: its device-resident scans
        persist across queries until a table (re-)registers."""
        cfg = self.config
        if self._exec is None or self._exec_gen != self._generation:
            from .torch_backend.executor import TorchExecutor
            self._exec = TorchExecutor(
                self.load_table, self.device, gpu_kernels=cfg.gpu_kernels,
                jit_plans=cfg.jit_plans,
                segment_plan_nodes=cfg.segment_plan_nodes,
                segment_min_cte_nodes=cfg.segment_min_cte_nodes,
                segment_cache_entries=cfg.segment_cache_entries,
                scan_budget_bytes=int(cfg.scan_budget_gb * (1 << 30)))
            self._exec_gen = self._generation
        self._exec._jit_plans = cfg.jit_plans
        return self._exec

    def plan(self, query: str):
        return Planner(self._catalog()).plan_query(parse_sql(query))

    def sql(self, query: str, backend: Optional[str] = None) -> Table:
        """Run a query; backend "torch" (the device path, the default) or
        "numpy" (the host oracle)."""
        backend = backend or "torch"
        if backend not in ("torch", "numpy"):
            raise ValueError(f"unknown backend {backend!r} "
                             "(expected 'torch' or 'numpy')")
        self.last_fallbacks = []
        if backend == "numpy":
            return Executor(self.load_table).execute(self.plan(query))
        self.last_stats = {}

        def factory():
            plan = self.plan(query)
            big = sorted({n.table for n in iter_plan_nodes(plan)
                          if isinstance(n, ScanNode) and self._est_rows.get(
                              n.table, 0) > self.config.out_of_core_min_rows})
            if big:
                raise NotImplementedError(
                    f"scans of {big} exceed out_of_core_min_rows and would "
                    "stream; the port runs in-core only")
            return plan
        from .torch_backend.device import to_host
        ex = self._executor()
        # units are labelled "<label>/<unit>" in the executor's messages
        ex.query_label = "q" + hashlib.sha1(query.encode()).hexdigest()[:8]
        with ex.on_stream():
            result = to_host(ex.run_query(("sql", query), factory))
        self.last_fallbacks = list(ex.fallback_nodes)
        self.last_stats = dict(ex.last_stats)
        return result
