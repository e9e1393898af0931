# Ported from nds_tpu/maintenance.py: the same function lists, delete-date
# substitution, staging registration, transactions, time log and JSON
# summaries, over the port's Session; see the module docstring.
"""Data Maintenance test: run the LF_*/DF_* refresh functions, timed.

    python -m nds_tpu_torch.maintenance WAREHOUSE REFRESH_DIR TIME_LOG
        [--maintenance_queries LF_SS,DF_SS] [--json_summary_folder DIR]
        [--backend torch|numpy] [--decimal f64|i64] [--property_file F]

Capability parity with the reference maintenance runner (reference
nds/nds_maintenance.py): the function lists (:45-58), delete-date tuples
read from the ``delete``/``inventory_delete`` tables (get_delete_date
:60-73), ordered DATE1/DATE2 substitution producing one statement set per
tuple (replace_date :75-96: 3 tuples give 3 copies of each delete),
staging CSVs registered as temp views (register_temp_views :267-271), and
per-function timing with a CSV time log and JSON summaries in the shape of
the power run's (run_query :204-265).

Each function runs as one warehouse transaction (``warehouse_transactions``
on, the default), after which the session moves to the version it
published. The INSERT bodies run on the card (``backend="torch"``, the
default) or on the host numpy executor (``"numpy"``); the DELETE
predicates run on the host numpy executor either way, as in the
reference. The session runs on "cuda" unless the property file or
``device`` asks for the CPU. The flight event of each function carries no
result-cache counters: the result cache is not ported.
"""
from __future__ import annotations

import argparse
import csv
import os
import sys
import time

from .config import EngineConfig, apply_decimal
from .engine.session import Session
from .report import BenchReport
from .schema import get_maintenance_schemas
from .warehouse import Warehouse

SQL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "data_maintenance")

INSERT_FUNCS = ["LF_CR", "LF_CS", "LF_I", "LF_SR", "LF_SS", "LF_WR", "LF_WS"]
DELETE_FUNCS = ["DF_CS", "DF_SS", "DF_WS"]
INVENTORY_DELETE_FUNCS = ["DF_I"]
MAINTENANCE_FUNCS = INSERT_FUNCS + DELETE_FUNCS + INVENTORY_DELETE_FUNCS


def get_delete_date(refresh_dir: str) -> tuple[list, list]:
    """Read DATE1/DATE2 tuples from the delete-date staging files."""
    import pyarrow.csv as pa_csv

    def read_pairs(table):
        path = os.path.join(refresh_dir, table)
        files = ([os.path.join(path, f) for f in sorted(os.listdir(path))]
                 if os.path.isdir(path) else [path])
        pairs = []
        for f in files:
            t = pa_csv.read_csv(
                f, read_options=pa_csv.ReadOptions(
                    column_names=["date1", "date2"]),
                parse_options=pa_csv.ParseOptions(delimiter="|"))
            pairs += list(zip(t.column("date1").to_pylist(),
                              t.column("date2").to_pylist()))
        return pairs

    return read_pairs("delete"), read_pairs("inventory_delete")


def replace_date(statements: str, pair: tuple[str, str]) -> str:
    """Substitute the ordered DATE1/DATE2 pair (reference :75-96)."""
    d1, d2 = sorted(str(d) for d in pair)
    return statements.replace("DATE1", d1).replace("DATE2", d2)


def load_function_sql(func: str) -> str:
    from .power import strip_sql_comments

    with open(os.path.join(SQL_DIR, f"{func}.sql")) as f:
        return strip_sql_comments(f.read())


def register_staging(session: Session, refresh_dir: str) -> None:
    """Register the refresh set's staging tables; their decimals read as
    doubles, as the reference reads them."""
    for name, sch in get_maintenance_schemas().items():
        if name in ("delete", "inventory_delete"):
            continue
        path = os.path.join(refresh_dir, name)
        if os.path.exists(path):
            session.register_csv(name, path,
                                 sch.arrow_schema(use_decimal=False))


def function_variants(func: str, delete_dates: list,
                      inventory_dates: list) -> list[str]:
    """The statement sets one refresh function runs: one for an LF_*
    function, one per delete-date tuple for a DF_* function."""
    sql = load_function_sql(func)
    if func in DELETE_FUNCS:
        return [replace_date(sql, p) for p in delete_dates]
    if func in INVENTORY_DELETE_FUNCS:
        return [replace_date(sql, p) for p in inventory_dates]
    return [sql]


def run_maintenance(warehouse_path: str, refresh_dir: str, time_log: str,
                    maintenance_queries: list[str] | None = None,
                    json_summary_folder: str | None = None,
                    backend: str | None = None,
                    decimal: str | None = None,
                    session: Session | None = None,
                    property_file: str | None = None,
                    device: str | None = None
                    ) -> list[tuple[str, int, int, int]]:
    """Run the refresh functions over the warehouse; returns the time
    log's rows (function, start, end, ms). ``session``: a caller-owned
    Session to run in (the warehouse is attached and the staging tables
    registered on it here); otherwise a new one from ``property_file``,
    ``decimal`` and ``device``."""
    if session is None:
        config = EngineConfig.from_property_file(property_file)
        apply_decimal(config, decimal)
        if device is not None:
            config.device = device
        session = Session(config)
    wh = Warehouse(warehouse_path)
    session.attach_warehouse(wh)
    register_staging(session, refresh_dir)
    dates = get_delete_date(refresh_dir)
    with wh.writing():
        rows, test_start, test_end = _run_functions(
            session, wh, maintenance_queries or MAINTENANCE_FUNCS, dates,
            backend, json_summary_folder)

    os.makedirs(os.path.dirname(time_log) or ".", exist_ok=True)
    with open(time_log, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["query", "start_time", "end_time", "time"])
        w.writerow(["Maintenance Start Time", test_start, "", ""])
        for r in rows:
            w.writerow(r)
        w.writerow(["Maintenance End Time", test_end, "", ""])
        w.writerow(["Maintenance Test Time", "", "", test_end - test_start])
    return rows


def _run_functions(session: Session, wh: Warehouse, funcs: list,
                   dates: tuple, backend: str | None,
                   json_summary_folder: str | None) -> tuple:
    """Each refresh function of `funcs` in turn; returns the time log's
    rows and the test's start and end (epoch ms)."""
    from .obs.flight import FLIGHT

    config = session.config
    use_txn = config.warehouse_transactions
    rows = []
    test_start = int(time.time() * 1000)
    for func in funcs:
        variants = function_variants(func, *dates)
        report = BenchReport(config, app_name=f"NDS-TPU maintenance {func}")
        start = int(time.time() * 1000)

        def run_all(variants=variants, func=func):
            # one atomic warehouse transaction per refresh function: a
            # kill between its table writes (DF_SS writes store_sales AND
            # store_returns) leaves the previous published version
            # current, and recovery discards the partial commit at the
            # next open
            if use_txn:
                with wh.transaction(committer=func):
                    for v in variants:
                        session.execute(v, backend=backend)
            else:
                for v in variants:
                    session.execute(v, backend=backend)
        report.report_on(run_all)
        if use_txn:
            # re-pin the writer session to the version it just published
            # (registrations inside a transaction are unpinned)
            session.refresh_warehouse()
        elapsed = report.summary["queryTimes"][-1]
        status = report.summary["queryStatus"][-1]
        rows.append((func, start, start + elapsed, elapsed))
        FLIGHT.record("maintenance", func=func, status=status, ms=elapsed,
                      variants=len(variants))
        print(f"{func}: {status} in {elapsed} ms", flush=True)
        if json_summary_folder:
            report.write_summary(
                func, prefix=os.path.join(json_summary_folder, "maintenance"))
    return rows, test_start, int(time.time() * 1000)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="nds_tpu_torch.maintenance")
    p.add_argument("warehouse_path")
    p.add_argument("refresh_dir", help="raw refresh (update-set) data dir")
    p.add_argument("time_log")
    p.add_argument("--maintenance_queries", default=None,
                   help="comma-separated subset of LF_*/DF_* functions")
    p.add_argument("--json_summary_folder", default=None)
    p.add_argument("--backend", default=None, choices=["torch", "numpy"])
    p.add_argument("--decimal", default=None, choices=["f64", "i64"])
    p.add_argument("--property_file", default=None,
                   help="nds.tpu.<field>=<value> lines (e.g. "
                   "nds.tpu.device=cpu)")
    a = p.parse_args(argv)
    funcs = (a.maintenance_queries.split(",") if a.maintenance_queries
             else None)
    run_maintenance(a.warehouse_path, a.refresh_dir, a.time_log, funcs,
                    a.json_summary_folder, a.backend, a.decimal,
                    property_file=a.property_file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
