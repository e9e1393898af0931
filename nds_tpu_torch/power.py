# Ported from nds_tpu/power.py: the same stream parsing, time log, JSON
# summaries and options, over the port's Session; see the module docstring.
"""Power-run workload: execute one query stream serially, timing each query.

    python -m nds_tpu_torch.power INPUT_PREFIX STREAM_FILE TIME_LOG
        [--input_format parquet|csv] [--warmup 2] [--strict]
        [--output_prefix DIR] [--json_summary_folder DIR] ...

Capability parity with the reference power runner (reference
nds/nds_power.py): stream parsing on ``-- start`` markers with the
two-statement splits (gen_sql_from_stream :49-76), table registration from
raw data, per-table Parquet directories or the Load Test's snapshot
warehouse (setup_tables :78-121), per-query
timing under a BenchReport with JSON summaries (run_one_query :124-134 +
PysparkBenchReport), output-column sanitization (ensure_valid_column_names
:136-173), a CSV time log with ``Power Start/End/Test Time`` sentinel rows
(:281-299), and a --sub_queries subset (:175-180).

Where the port differs from ``nds_tpu/power.py``:

- the session runs on the card ("cuda") and raises without CUDA; the CPU
  runs only when asked (``device="cpu"``, or ``nds.tpu.device=cpu`` in
  the property file);
- ``--backend`` takes ``torch`` (the device path, the default) or
  ``numpy`` (the host oracle);
- ``--profile_folder`` writes one ``torch.profiler`` Chrome trace a query;
- ``--gpu_kernels`` (``EngineConfig.gpu_kernels``) replaces
  ``--pallas_ops``;
- a JSON summary's ``execStats`` is the session's ``last_stats``;
- not ported yet, each raising before any query runs: ``--explain``
  and ``--verify_plans`` other than ``off`` (A.5), ``--mesh_shards``
  above 1 (A.4).

As in the reference, CSV decimals load as doubles; exact decimals come
from a warehouse transcoded with ``--use_decimal``
(``nds_tpu_torch.transcode``).
"""
from __future__ import annotations

import argparse
import csv
import glob
import os
import re
import sys
import time
from collections import OrderedDict

from .config import EngineConfig
from .engine.session import Session
from .report import BenchReport
from .resilience import FAULTS, FaultSpec, RetryPolicy, run_with_deadline
from .schema import get_maintenance_schemas, get_schemas
from .streams import SPECIAL_TEMPLATES, split_special_query

_START_RE = re.compile(
    r"^--\s*start query (\d+) using template query(\d+)\.tpl", re.IGNORECASE)


def gen_sql_from_stream(stream_text: str) -> "OrderedDict[str, str]":
    """Split a stream file into {query_name: sql} preserving order."""
    queries: "OrderedDict[str, str]" = OrderedDict()
    current: list[str] = []
    number = None
    for line in stream_text.splitlines():
        m = _START_RE.match(line.strip())
        if m:
            if number is not None:
                _emit(queries, number, current)
            number = int(m.group(2))
            current = []
        else:
            current.append(line)
    if number is not None:
        _emit(queries, number, current)
    return queries


def strip_sql_comments(sql: str) -> str:
    """Drop full '--' comment lines: a ';' inside a template header comment
    (query93) must never reach the naive statement split used by the
    runners and the bench."""
    return "\n".join(ln for ln in sql.splitlines()
                     if not ln.lstrip().startswith("--"))


def _emit(queries, number, lines):
    sql = strip_sql_comments("\n".join(lines)).strip()
    name = f"query{number}"
    if number in SPECIAL_TEMPLATES:
        for part_name, part_sql in split_special_query(name, sql):
            queries[part_name] = part_sql
    else:
        queries[name] = sql.rstrip(";")


def setup_tables(session: Session, input_prefix: str, input_format: str,
                 use_decimal: bool = True,
                 maintenance: bool = False) -> dict[str, float]:
    """Register the 24 source tables (and with ``maintenance`` the
    refresh set's staging tables) from per-table directories of CSV
    (pipe-delimited, decimals read as doubles) or Parquet files, or from a
    warehouse layout (a ``manifest.json`` under the prefix: the pinned
    snapshot, timed under "warehouse"). Returns per-table registration
    times (the reference times view creation, nds_power.py:94-104)."""
    times: dict[str, float] = {}
    if input_format == "parquet" and glob.glob(
            os.path.join(input_prefix, "*", "manifest.json")):
        # warehouse layout (snapshot manifests): register pinned snapshots,
        # the reference's warehouse-catalog path (nds_power.py:107-121)
        from .warehouse import Warehouse
        t0 = time.perf_counter()
        Warehouse(input_prefix).register_all(session)
        times["warehouse"] = time.perf_counter() - t0
        return times
    if input_format not in ("csv", "parquet"):
        raise ValueError(f"unsupported input format {input_format}")
    schemas = dict(get_schemas(use_decimal))
    if maintenance:
        schemas.update(get_maintenance_schemas(use_decimal))
    for name, sch in schemas.items():
        path = os.path.join(input_prefix, name)
        if not os.path.exists(path):
            continue
        t0 = time.perf_counter()
        if input_format == "csv":
            session.register_csv(name, path,
                                 sch.arrow_schema(use_decimal=False))
        else:
            session.register_parquet(name, path)
        times[name] = time.perf_counter() - t0
    return times


_VALID_COL = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def ensure_valid_column_names(names: list[str]) -> list[str]:
    """Sanitize/dedupe output column names for parquet writing (reference
    nds_power.py:136-173)."""
    out: list[str] = []
    seen: dict[str, int] = {}
    for i, n in enumerate(names):
        if not n or not _VALID_COL.match(n):
            n = f"column_{i}"
        base = n
        if base in seen:
            seen[base] += 1
            n = f"{base}_{seen[base]}"
        else:
            seen[base] = 0
        out.append(n)
    return out


def run_one_query(session: Session, sql: str, query_name: str,
                  output_prefix: str | None, output_format: str,
                  backend: str | None = None):
    """Run a unit's statements in order; the last one's result (a host
    Table: the device work has ended when it returns) is written under
    ``output_prefix/query_name/`` when a prefix is given."""
    sql = strip_sql_comments(sql)   # callers may pass raw template text
    statements = [s for s in sql.split(";") if s.strip()]
    result = None
    for stmt in statements:
        # the query name labels spans and per-program device-time
        # attribution (obs.device_time): "query9/root" etc.
        result = session.sql(stmt, backend=backend, label=query_name)
    if output_prefix and result is not None:
        write_output(result, output_prefix, query_name)
    return result


def write_output(result, output_prefix: str, query_name: str) -> None:
    """A unit's result as ``output_prefix/query_name/part-0.parquet``,
    its columns renamed for Parquet (ensure_valid_column_names)."""
    import pyarrow.parquet as pq
    from .engine.arrow_bridge import to_arrow
    table = to_arrow(result)
    table = table.rename_columns(
        ensure_valid_column_names(table.column_names))
    out_dir = os.path.join(output_prefix, query_name)
    os.makedirs(out_dir, exist_ok=True)
    pq.write_table(table, os.path.join(out_dir, "part-0.parquet"))


def _unported(explain: bool, verify_plans: str | None,
              mesh_shards: int | None) -> None:
    """Raise for an option the port has not yet, naming its ROADMAP item."""
    if explain:
        raise NotImplementedError(
            "--explain (EXPLAIN ANALYZE, obs/profile.py's plan profiles) is "
            "not ported yet: ROADMAP A.5")
    if verify_plans not in (None, "off"):
        raise NotImplementedError(
            f"--verify_plans {verify_plans} (the plan verifier, "
            "engine/verify.py) is not ported yet: ROADMAP A.5")
    if mesh_shards is not None and mesh_shards > 1:
        raise NotImplementedError(
            f"--mesh_shards {mesh_shards} (sharded morsels over several "
            "cards) is not ported yet: ROADMAP A.4")


def _profiled(profile_folder: str, name: str, device, fn) -> None:
    """Run fn under torch.profiler (the card's kernels too when the
    session runs there) and write its Chrome trace to
    profile_folder/<name>.json."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(profile_folder, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn()
    prof.export_chrome_trace(os.path.join(profile_folder, f"{name}.json"))


def run_query_stream(input_prefix: str, stream_path: str, time_log: str,
                     input_format: str = "parquet",
                     output_prefix: str | None = None,
                     output_format: str = "parquet",
                     json_summary_folder: str | None = None,
                     sub_queries: list[str] | None = None,
                     property_file: str | None = None,
                     backend: str | None = None,
                     warmup: int = 0,
                     strict: bool = False,
                     profile_folder: str | None = None,
                     fault_inject: list[str] | None = None,
                     keep_sc: bool = False,
                     decimal: str | None = None,
                     precompile: bool = True,
                     query_timeout: float | None = None,
                     query_attempts: int | None = None,
                     resume: bool = False,
                     late_mat: bool | None = None,
                     shared_scan: bool | None = None,
                     narrow_lanes: bool | None = None,
                     encoded_exec: bool | None = None,
                     verify_plans: str | None = None,
                     gpu_kernels: str | None = None,
                     mesh_shards: int | None = None,
                     trace: str | None = None,
                     explain: bool = False,
                     query_log: str | None = None,
                     device: str | None = None,
                     compile_report: dict | None = None
                     ) -> list[tuple[str, int, int, int]]:
    """Run every query in the stream; returns (name, start_ms, end_ms, ms).

    The CSV time log layout (query name, start, end, elapsed + the
    ``Power Start/End/Test Time`` sentinel rows) matches the reference's
    (nds_power.py:281-299) so the orchestrator can scrape either.

    warmup: untimed pre-runs per query before the timed run (2 reaches the
    engine's compiled steady state: record pass + CUDA graph capture).
    With warmup >= 1 (and ``precompile``) every query is recorded once,
    then every recorded unit is compiled ahead
    (TorchExecutor.precompile_parallel), then warmup - 1 more untimed runs
    precede each timed one.
    strict: raise at the end if any query fell back to the host oracle.
    profile_folder: write a torch.profiler Chrome trace per query under
    this folder (the Spark-UI job-group analog, reference
    nds_power.py:254).
    fault_inject: query names whose timed run raises an injected fault —
    sugar over the resilience FaultRegistry (``query.run`` raise-specs):
    the run records ``Failed`` with the exception in the JSON summary and
    keeps going, exactly like a genuine mid-stream query failure.
    Engine-level faults arm via EngineConfig.fault_points /
    nds.tpu.fault_points instead.
    query_timeout: per-query wall-clock budget in seconds (None = take
    EngineConfig.query_timeout_s; 0 = unbounded). An overrun abandons the
    query mid-flight (Session.abandon_inflight: its worker stops before
    its next device work, the next query runs on a fresh executor) and
    records ``Failed`` (DeadlineExceeded).
    query_attempts: timed attempts per query (None = take
    EngineConfig.query_attempts): transient failures retry with
    deterministic backoff; per-attempt statuses land in the JSON summary.
    resume: skip queries already recorded in an existing (flushed partial)
    time log, keeping the original Power Start Time.
    late_mat, shared_scan, narrow_lanes, encoded_exec: A/B overrides of
    the config fields of those names (None = config).
    gpu_kernels: comma list of {sort,groupby,gather}: the kernel families
    that run as the hand-written CUDA kernels (None = take
    EngineConfig.gpu_kernels; results are bit-identical either way).
    trace: enable the obs span tracer for the whole stream and write a
    Chrome trace-event file to this path at the end.
    query_log: enable the durable query log (obs/query_log.py) and append
    one flat row per completed statement to this JSONL path.
    device: the session's torch device (None = the config's, "cuda" by
    default).
    compile_report: a dict that receives what the cold start's compile
    pass returned ({unit key: "compiled"|"nojit"|"skipped: ..."}; left
    empty when no compile pass ran).
    explain, verify_plans other than "off" and mesh_shards above 1 raise
    NotImplementedError (not ported yet).
    """
    from .check import check_json_summary_folder, check_query_subset_exists
    from .config import apply_decimal
    from .obs.metrics import METRICS, QUERY_FAILURES
    from .obs.trace import TRACER

    _unported(explain, verify_plans, mesh_shards)
    if not resume:
        # a RESUMED run re-enters its own summary folder on purpose: the
        # already-written summaries belong to the very run being
        # continued, not to a stale previous one
        check_json_summary_folder(json_summary_folder)
    config = EngineConfig.from_property_file(property_file)
    apply_decimal(config, decimal)
    if late_mat is not None:     # --no_late_mat A/B override
        config.late_materialization = late_mat
    if shared_scan is not None:  # --no_shared_scan A/B override
        config.shared_scan = shared_scan
    if narrow_lanes is not None:  # --no_narrow_lanes A/B override
        config.narrow_lanes = narrow_lanes
    if encoded_exec is not None:  # --no_encoded_exec A/B override
        config.encoded_exec = encoded_exec
    if gpu_kernels is not None:  # --gpu_kernels A/B override
        config.gpu_kernels = tuple(
            x.strip() for x in gpu_kernels.split(",") if x.strip())
    if device is not None:
        config.device = device
    if trace:
        TRACER.configure(enabled=True)
    if query_log:
        from .obs.query_log import QUERY_LOG
        QUERY_LOG.configure(enabled=True, path=query_log, clear=False)
    session = Session(config)
    setup_tables(session, input_prefix, input_format,
                 use_decimal=True)

    with open(stream_path) as f:
        query_dict = gen_sql_from_stream(f.read())
    if sub_queries:
        check_query_subset_exists(query_dict, sub_queries)
        query_dict = OrderedDict(
            (k, v) for k, v in query_dict.items()
            if k in sub_queries
            or re.sub(r"_part[12]$", "", k) in sub_queries)

    timeout_s = config.query_timeout_s if query_timeout is None \
        else query_timeout
    attempts = config.query_attempts if query_attempts is None \
        else query_attempts
    retry = RetryPolicy(max_attempts=attempts,
                        backoff_s=config.retry_backoff_s) \
        if attempts and attempts > 1 else None

    rows: list[tuple[str, int, int, int]] = []
    done: set[str] = set()
    resumed_start: int | None = None
    resumed_end: int | None = None
    if resume and os.path.exists(time_log):
        rows, resumed_start, resumed_end = _read_partial_log(time_log)
        done = {r[0] for r in rows}
        if done:
            print(f"resume: {len(done)} queries already recorded in "
                  f"{time_log}; skipping them", flush=True)

    fallback_queries: dict[str, list[str]] = {}
    armed = [FAULTS.arm(FaultSpec(point="query.run", match=n))
             for n in (fault_inject or ())]

    def _injected(name: str) -> bool:
        base = re.sub(r"_part[12]$", "", name)
        return FAULTS.would_raise("query.run", name, aliases=(base,))

    try:
        # phase-structured cold start (warmup >= 1): record EVERY query
        # once, then compile every recorded unit ahead
        # (TorchExecutor.precompile_parallel: on the card, each unit's
        # first replay and graph capture) instead of at its second run
        eff_warmup = warmup
        failed_records: set[str] = set()
        use_device = (backend or "torch") == "torch"
        if precompile and warmup >= 1 and use_device:
            t0 = time.perf_counter()
            for name, sql in query_dict.items():
                if _injected(name) or name in done:
                    continue
                try:
                    run_one_query(session, sql, name, None, output_format,
                                  backend)
                except Exception:
                    # possibly transient: give this query its full
                    # per-query warmup back so the timed run is not a
                    # first-sighting eager outlier
                    failed_records.add(name)
                    continue
            t1 = time.perf_counter()
            res = session._executor().precompile_parallel()
            if compile_report is not None:
                compile_report.update(res)
            compiled = sum(1 for v in res.values() if v == "compiled")
            recorded = sum(1 for n in query_dict
                           if not _injected(n) and n not in failed_records
                           and n not in done)
            print(f"precompile: recorded {recorded} queries in "
                  f"{t1 - t0:.1f}s; compiled {compiled}/{len(res)} programs "
                  f"in {time.perf_counter() - t1:.1f}s", flush=True)
            eff_warmup = warmup - 1

        power_start = resumed_start if resumed_start is not None \
            else int(time.time() * 1000)
        executed = 0
        for name, sql in query_dict.items():
            if name in done:
                continue
            executed += 1
            report = BenchReport(config, app_name=f"NDS-TPU {name}")
            base = re.sub(r"_part[12]$", "", name)
            # a failed/injected/timed-out run never reaches the session;
            # clear observability state so the report isn't stale
            session.last_fallbacks = []
            session.last_stats = {}

            def run_fn(*a, _name=name, _base=base, **k):
                FAULTS.fire("query.run", _name, aliases=(_base,))
                return run_one_query(*a, **k)

            def attempt_fn(*a, _name=name, **k):
                from .obs.flight import FLIGHT
                from .resilience import DeadlineExceeded
                try:
                    return run_with_deadline(run_fn, timeout_s, *a,
                                             label=_name, **k)
                except DeadlineExceeded:
                    # the abandoned worker may still hold the session's
                    # statement lock (it cannot be killed): swap in fresh
                    # locks and executors so the NEXT query runs now
                    # instead of queueing behind the zombie — and
                    # flight-dump the moment
                    session.abandon_inflight()
                    FLIGHT.trip("query_watchdog", query=_name,
                                budget_s=timeout_s)
                    raise

            if not _injected(name):
                for _ in range(warmup if name in failed_records
                               else eff_warmup):
                    try:
                        run_one_query(session, sql, name, None,
                                      output_format, backend)
                    except Exception:
                        break  # the timed run reports the failure
            q_start = int(time.time() * 1000)
            metrics_before = METRICS.snapshot()

            def timed(report=report, sql=sql, name=name):
                report.report_on(attempt_fn, session, sql, name,
                                 output_prefix, output_format, backend,
                                 retry=retry)
            if profile_folder:
                _profiled(profile_folder, name, session.device, timed)
            else:
                timed()
            for fb in session.last_fallbacks:
                report.record_task_failure(f"device fallback: {fb}")
            if session.last_fallbacks:
                fallback_queries[name] = list(session.last_fallbacks)
            if session.last_stats:
                report.record_exec_stats(session.last_stats)
            # per-query engine-counter delta: the uniform metrics block in
            # every JSON summary (queries_run, retries, faults, bytes
            # uploaded... — obs.metrics glossary)
            report.record_metrics(METRICS.delta(metrics_before))
            elapsed = report.summary["queryTimes"][-1]
            # same latency family the service records into: top-K slow
            # templates rank live from the registry across runners
            METRICS.histogram("query_latency_ms",
                              template=name).observe(elapsed)
            rows.append((name, q_start, q_start + elapsed, elapsed))
            status = report.finalize_status()
            if status == "Failed":
                QUERY_FAILURES.inc()
            print(f"{name}: {status} in {elapsed} ms", flush=True)
            if json_summary_folder:
                report.write_summary(
                    name, prefix=os.path.join(json_summary_folder, "power"))
            # flush the partial log after every query: a multi-hour stream
            # interrupted mid-run keeps its measurements (sentinel rows are
            # appended only by the completed run below), and --resume
            # restarts from exactly this flushed state
            _write_time_log(time_log, power_start, rows, None)
        # resuming an already-complete log with nothing left to run keeps
        # the original Power End Time (rewriting it would inflate the
        # recorded Power Test Time)
        power_end = resumed_end if (executed == 0 and resumed_end is not None) \
            else int(time.time() * 1000)
        _write_time_log(time_log, power_start, rows, power_end)
    finally:
        for s in armed:
            FAULTS.disarm(s)
        if trace:
            TRACER.write_chrome_trace(trace)
            print(f"trace: {trace} (open in ui.perfetto.dev)", flush=True)
        if query_log:
            from .obs.query_log import QUERY_LOG
            QUERY_LOG.flush()
            print(f"query log: {query_log}", flush=True)
    if strict and fallback_queries:
        raise RuntimeError(
            "device fallbacks in strict mode: " + "; ".join(
                f"{q}: {fbs}" for q, fbs in fallback_queries.items()))
    return rows


def _read_partial_log(time_log: str) -> tuple[list, int | None, int | None]:
    """Parse a (possibly partial) power time log written by
    _write_time_log: per-query rows plus the Power Start/End sentinels
    (End present only if the run completed). The atomic
    flush-after-every-query contract means any existing log is a
    consistent prefix of the run — exactly what --resume needs."""
    rows: list[tuple[str, int, int, int]] = []
    power_start: int | None = None
    power_end: int | None = None
    with open(time_log) as f:
        for row in csv.reader(f):
            if not row or row[0] == "query":
                continue
            if row[0] == "Power Start Time":
                power_start = int(row[1])
            elif row[0] == "Power End Time":
                power_end = int(row[1])
            elif row[0] == "Power Test Time":
                continue
            else:
                rows.append((row[0], int(row[1]), int(row[2]), int(row[3])))
    return rows, power_start, power_end


def _write_time_log(time_log: str, power_start: int, rows, power_end) -> None:
    os.makedirs(os.path.dirname(time_log) or ".", exist_ok=True)
    tmp = time_log + ".tmp"
    with open(tmp, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["query", "start_time", "end_time", "time"])
        w.writerow(["Power Start Time", power_start, "", ""])
        for r in rows:
            w.writerow(r)
        if power_end is not None:
            w.writerow(["Power End Time", power_end, "", ""])
            w.writerow(["Power Test Time", "", "", power_end - power_start])
    os.replace(tmp, time_log)   # atomic: an interrupt never truncates


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="nds_tpu_torch.power")
    p.add_argument("input_prefix", help="data root (per-table dirs)")
    p.add_argument("query_stream_file")
    p.add_argument("time_log")
    p.add_argument("--input_format", default="parquet",
                   choices=["parquet", "csv"])
    p.add_argument("--output_prefix", default=None)
    p.add_argument("--output_format", default="parquet")
    p.add_argument("--json_summary_folder", default=None)
    p.add_argument("--sub_queries", default=None,
                   help="comma-separated query subset, e.g. query1,query3")
    p.add_argument("--property_file", default=None)
    p.add_argument("--backend", default=None, choices=["torch", "numpy"])
    p.add_argument("--warmup", type=int, default=0,
                   help="untimed pre-runs per query (2 = compiled steady state)")
    p.add_argument("--strict", action="store_true",
                   help="fail if any query fell back to the host oracle")
    p.add_argument("--profile_folder", default=None,
                   help="write a torch.profiler Chrome trace per query here")
    p.add_argument("--fault_inject", default=None,
                   help="comma-separated query names whose run raises an "
                        "injected fault (harness self-test)")
    p.add_argument("--decimal", default=None, choices=["f64", "i64"],
                   help="decimal physical type (i64 = exact scaled int64, "
                        "the default)")
    p.add_argument("--no_precompile", action="store_true",
                   help="disable the record-all-then-compile cold start "
                        "(compiles lazily at second execution)")
    p.add_argument("--query_timeout", type=float, default=None,
                   help="per-query wall-clock budget in seconds (overrun "
                        "records Failed and the stream continues); default "
                        "from nds.tpu.query_timeout_s, 0 = unbounded")
    p.add_argument("--retry", type=int, default=None,
                   help="timed attempts per query (transient failures "
                        "retry with backoff); default from "
                        "nds.tpu.query_attempts")
    p.add_argument("--resume", action="store_true",
                   help="skip queries already recorded in the existing "
                        "(partial) time log and keep its Power Start Time")
    p.add_argument("--no_late_mat", action="store_true",
                   help="disable the late-materialization planner rewrite "
                        "for A/B runs; property: "
                        "nds.tpu.late_materialization")
    p.add_argument("--verify_plans", default=None,
                   choices=["off", "final", "per-pass"],
                   help="static plan-IR verification: only off is ported "
                        "(ROADMAP A.5)")
    p.add_argument("--no_shared_scan", action="store_true",
                   help="disable shared-scan morsel fusion for A/B runs; "
                        "property: nds.tpu.shared_scan")
    p.add_argument("--no_narrow_lanes", action="store_true",
                   help="disable narrow-lane packed uploads for A/B runs "
                        "(bit-identical results); property: "
                        "nds.tpu.narrow_lanes")
    p.add_argument("--no_encoded_exec", action="store_true",
                   help="disable encoded execution for A/B runs "
                        "(bit-identical results); property: "
                        "nds.tpu.encoded_exec")
    p.add_argument("--gpu_kernels", default=None, metavar="OPS",
                   help="comma list of {sort,groupby,gather}: the kernel "
                        "families run as the hand-written CUDA kernels "
                        "(nds_tpu_torch/csrc/), bit-identical to their "
                        "plain versions; property: nds.tpu.gpu_kernels")
    p.add_argument("--mesh_shards", type=int, default=None, metavar="N",
                   help="sharded morsels over N cards: not ported "
                        "(ROADMAP A.4); 0/1 = one card")
    p.add_argument("--explain", action="store_true",
                   help="EXPLAIN ANALYZE: not ported (ROADMAP A.5)")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="enable engine span tracing for the whole stream "
                        "and write a Chrome trace-event file here")
    p.add_argument("--query_log", default=None, metavar="PATH",
                   help="enable the durable query log and append one "
                        "flat JSONL row per completed statement here")
    a = p.parse_args(argv)
    sub = a.sub_queries.split(",") if a.sub_queries else None
    inject = a.fault_inject.split(",") if a.fault_inject else None
    run_query_stream(a.input_prefix, a.query_stream_file, a.time_log,
                     a.input_format, a.output_prefix, a.output_format,
                     a.json_summary_folder, sub, a.property_file, a.backend,
                     warmup=a.warmup, strict=a.strict,
                     profile_folder=a.profile_folder, fault_inject=inject,
                     decimal=a.decimal, precompile=not a.no_precompile,
                     query_timeout=a.query_timeout, query_attempts=a.retry,
                     resume=a.resume,
                     late_mat=False if a.no_late_mat else None,
                     shared_scan=False if a.no_shared_scan else None,
                     narrow_lanes=False if a.no_narrow_lanes else None,
                     encoded_exec=False if a.no_encoded_exec else None,
                     verify_plans=a.verify_plans,
                     gpu_kernels=a.gpu_kernels,
                     mesh_shards=a.mesh_shards,
                     trace=a.trace,
                     explain=a.explain,
                     query_log=a.query_log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
