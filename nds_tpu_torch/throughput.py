# Ported from nds_tpu/throughput.py: the same supervisor, modes, time logs
# and elapsed; streams run the port's power runner and query service.
"""Throughput test: run N query streams concurrently, supervised.

Capability parity with the reference throughput harness (reference
nds/nds-throughput: xargs -P fans one full Spark app per stream;
nds/nds_bench.py:138-157 computes elapsed = max(stream end) - min(stream
start) by scraping the per-stream time logs). Here each stream is a full
power run; ``process`` mode launches one OS process per stream (the
reference's N-concurrent-apps shape — separate interpreters so the
streams contend only for the device, not the GIL), ``thread`` mode
multiplexes in-process sessions onto one device (cheap for tests and for
sharing a single compiled-query cache), and ``service`` mode submits
EVERY stream's queries through one shared admission-controlled
QueryService over a single Session (nds_tpu_torch/service): one table
registration, one cross-client program cache, compatible queries from
different streams coalescing into batched dispatches — the interactive
multi-tenant shape, measured with the same per-stream time logs.

    python -m nds_tpu_torch.throughput INPUT_PREFIX STREAM_DIR 1,2 LOG_DIR
        [--mode process|thread|service] [--property_file F]

On the card every mode shares one device: process mode gives each stream
its own CUDA context (``python -m nds_tpu_torch.power``; a killed stream's
context goes with its process), thread mode one Session (executor, CUDA
stream and graph pool) per stream thread, service mode one Session behind
the port's QueryService. The CPU runs only when asked: ``device="cpu"``,
or ``nds.tpu.device=cpu`` in the property file (the only way for process
mode's streams).

On top of the reference's detect-and-abort posture sits a supervisor
(resilience layer): each stream gets a wall-clock budget and up to N spawn
attempts — a crashed or hung stream is killed and restarted with
deterministic backoff instead of aborting the round; per-stream outcomes
land in a status CSV, and a round with permanently failed streams reports
the partial elapsed over the completed ones instead of a bare
RuntimeError.
"""
from __future__ import annotations

import argparse
import csv
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from .resilience import (DeadlineExceeded, FAULTS, RetryPolicy,
                         run_with_deadline)


def stream_log_path(time_log_dir: str, stream: int) -> str:
    return os.path.join(time_log_dir, f"throughput_{stream}.csv")


def status_csv_path(time_log_dir: str) -> str:
    return os.path.join(time_log_dir, "throughput_status.csv")


class IncompleteStreamLog(ValueError):
    """A stream time log is missing or lacks its sentinel rows (the stream
    was interrupted before completing)."""


class ThroughputError(RuntimeError):
    """Streams failed permanently. Carries the partial elapsed over the
    streams that DID complete plus the failed stream ids, so callers keep
    the round's measurements instead of losing everything."""

    def __init__(self, message: str, partial_elapsed: float | None = None,
                 failed: list[int] | None = None):
        super().__init__(message)
        self.partial_elapsed = partial_elapsed
        self.failed = failed or []


@dataclass
class StreamStatus:
    """One stream's supervised outcome (a row of the status CSV)."""
    stream: int
    attempts: int = 0
    status: str = "Pending"     # Pending|Running|Completed|Failed|TimedOut
    error: str = ""
    restart_at: float = field(default=0.0, repr=False)


def _run_stream_thread(input_prefix: str, stream_file: str, time_log: str,
                       **kwargs) -> None:
    from .power import run_query_stream
    run_query_stream(input_prefix, stream_file, time_log, **kwargs)


def _run_stream_service(service, stream_file: str, time_log: str,
                        sub_queries: list[str] | None = None,
                        warmup: int = 0,
                        backend: str | None = None,
                        tenant: str = "default",
                        output_prefix: str | None = None,
                        strict: bool = False) -> None:
    """One stream's queries through a shared QueryService: same time-log
    contract as a power run (per-query rows + Power Start/End sentinels),
    but execution interleaves with every other stream on one session —
    queries wait in the service queue instead of contending for the GIL
    at full-plan granularity, and compatible templates across streams
    batch into shared dispatches. With ``output_prefix`` each query's
    last result is written as the power runner writes it (after its
    time-log row: the write is not timed); with ``strict`` the stream
    raises at its end if any statement fell back to the host."""
    import re as _re
    import time as _time

    from .power import _write_time_log, gen_sql_from_stream, write_output

    with open(stream_file) as f:
        query_dict = gen_sql_from_stream(f.read())
    if sub_queries:
        query_dict = {
            k: v for k, v in query_dict.items()
            if k in sub_queries
            or _re.sub(r"_part[12]$", "", k) in sub_queries}
    rows: list[tuple[str, int, int, int]] = []
    fallbacks: dict[str, list[str]] = {}
    power_start = int(_time.time() * 1000)
    for name, sql in query_dict.items():
        statements = [s for s in sql.split(";") if s.strip()]
        for _ in range(warmup):
            for stmt in statements:
                service.sql(stmt, label=name, backend=backend,
                            tenant=tenant)
        q_start = int(_time.time() * 1000)
        tickets = []
        for stmt in statements:
            tickets.append(service.submit(stmt, label=name, backend=backend,
                                          tenant=tenant))
            tickets[-1].result()
        q_end = int(_time.time() * 1000)
        rows.append((name, q_start, q_end, q_end - q_start))
        _write_time_log(time_log, power_start, rows, None)
        for t in tickets:
            if t.stats is not None and t.stats.fallback_reasons:
                fallbacks[name] = list(t.stats.fallback_reasons)
        if output_prefix and tickets:
            write_output(tickets[-1].result(), output_prefix, name)
    _write_time_log(time_log, power_start, rows, int(_time.time() * 1000))
    if strict and fallbacks:
        raise RuntimeError(
            "device fallbacks in strict mode: " + "; ".join(
                f"{q}: {fbs}" for q, fbs in fallbacks.items()))


def _stream_cmd(input_prefix: str, stream_file: str, time_log: str,
                input_format: str, output_prefix: str | None,
                json_summary_folder: str | None,
                sub_queries: list[str] | None,
                property_file: str | None, backend: str | None,
                warmup: int = 0, decimal: str | None = None,
                strict: bool = False) -> list[str]:
    cmd = [sys.executable, "-m", "nds_tpu_torch.power", input_prefix,
           stream_file, time_log, "--input_format", input_format]
    if warmup:
        cmd += ["--warmup", str(warmup)]
    if strict:
        cmd += ["--strict"]
    if decimal:
        cmd += ["--decimal", decimal]
    if output_prefix:
        cmd += ["--output_prefix", output_prefix]
    if json_summary_folder:
        cmd += ["--json_summary_folder", json_summary_folder]
    if sub_queries:
        cmd += ["--sub_queries", ",".join(sub_queries)]
    if property_file:
        cmd += ["--property_file", property_file]
    if backend:
        cmd += ["--backend", backend]
    return cmd


def write_status_csv(path: str, statuses: list[StreamStatus]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["stream", "attempts", "status", "error"])
        for s in sorted(statuses, key=lambda s: s.stream):
            w.writerow([s.stream, s.attempts, s.status, s.error])
    os.replace(tmp, path)   # atomic, like the time logs


def supervise_processes(jobs: list[tuple[int, list[str]]],
                        max_attempts: int = 1,
                        stream_timeout: float | None = None,
                        backoff_s: float = 1.0,
                        poll_s: float = 0.1,
                        spawn=subprocess.Popen,
                        clock=time.monotonic) -> list[StreamStatus]:
    """Supervise one OS process per stream: spawn, watch, kill on budget
    overrun, restart crashed/killed streams up to ``max_attempts`` with
    exponential backoff. ``jobs`` is [(stream_id, argv)]. Always kills any
    surviving children on the way out — an abandoned round (exception,
    Ctrl-C) never leaks sibling processes.
    """
    policy = RetryPolicy(max_attempts=max_attempts, backoff_s=backoff_s)
    statuses = {sid: StreamStatus(sid) for sid, _ in jobs}
    cmds = dict(jobs)
    live: dict[int, tuple] = {}        # sid -> (proc, started_at)
    waiting: list[int] = [sid for sid, _ in jobs]   # ready/backing-off

    def _spawn(sid: int) -> None:
        st = statuses[sid]
        st.attempts += 1
        if st.attempts > 1:
            from .obs.metrics import STREAM_RESTARTS
            STREAM_RESTARTS.inc()
        FAULTS.fire("stream.spawn", str(sid))
        live[sid] = (spawn(cmds[sid]), clock())
        st.status = "Running"

    def _attempt_failed(sid: int, status: str, error: str) -> None:
        st = statuses[sid]
        st.error = error
        if st.attempts < max_attempts:
            st.status = "Pending"
            st.restart_at = clock() + policy.backoff(st.attempts)
            waiting.append(sid)
        else:
            st.status = status

    try:
        while waiting or live:
            for sid in [s for s in waiting
                        if clock() >= statuses[s].restart_at]:
                waiting.remove(sid)
                try:
                    _spawn(sid)
                except Exception as e:   # spawn itself failed (fault point)
                    _attempt_failed(sid, "Failed",
                                    f"spawn: {type(e).__name__}: {e}")
            for sid, (proc, started) in list(live.items()):
                rc = proc.poll()
                if rc is None:
                    if stream_timeout and clock() - started > stream_timeout:
                        proc.kill()
                        proc.wait()
                        del live[sid]
                        _attempt_failed(
                            sid, "TimedOut",
                            f"killed after {stream_timeout}s budget")
                    continue
                del live[sid]
                if rc == 0:
                    statuses[sid].status = "Completed"
                    statuses[sid].error = ""
                else:
                    _attempt_failed(sid, "Failed", f"exit code {rc}")
            if waiting or live:
                time.sleep(poll_s)
    finally:
        # abandoned round (exception/interrupt): never leak children
        for proc, _ in live.values():
            proc.kill()
        for proc, _ in live.values():
            proc.wait()
    return list(statuses.values())


def _supervised_thread_stream(sid: int, run, max_attempts: int,
                              stream_timeout: float | None,
                              backoff_s: float) -> StreamStatus:
    """Thread-mode supervision for one stream: retry crashed attempts with
    backoff; a budget overrun ABANDONS the worker (threads cannot be
    killed) and is terminal — a restart would race the zombie attempt on
    the same time log."""
    policy = RetryPolicy(max_attempts=max_attempts, backoff_s=backoff_s)
    st = StreamStatus(sid)
    while st.attempts < max_attempts:
        st.attempts += 1
        if st.attempts > 1:
            from .obs.metrics import STREAM_RESTARTS
            STREAM_RESTARTS.inc()
        try:
            FAULTS.fire("stream.spawn", str(sid))
            if stream_timeout:
                run_with_deadline(run, stream_timeout,
                                  label=f"stream {sid}")
            else:
                run()
            st.status, st.error = "Completed", ""
            return st
        except DeadlineExceeded as e:
            st.status, st.error = "TimedOut", str(e)
            return st
        except Exception as e:
            st.status = "Failed"
            st.error = f"{type(e).__name__}: {e}"
            if st.attempts < max_attempts:
                time.sleep(policy.backoff(st.attempts))
    return st


def _write_service_obs(time_log_dir: str) -> None:
    """Service-mode observability artifacts beside the time logs: the
    per-tenant/per-stream SLO view (service_slo.json — counts, p50/p95/
    p99 per series, straight from the registry histograms) and, when the
    flight recorder is on (NDS_TPU_FLIGHT=1), the round's lifecycle ring
    as flight.jsonl — the post-mortem record a chaos round asserts on."""
    import json

    from .obs.flight import FLIGHT
    from .obs.metrics import METRICS

    rows = METRICS.percentiles("service_latency_ms")
    if rows:
        path = os.path.join(time_log_dir, "service_slo.json")
        with open(path, "w") as f:
            json.dump({"service_latency_ms": rows,
                       "histograms": {
                           k: v for k, v in METRICS.histograms().items()
                           if v["name"].startswith("service_")}}, f,
                      indent=2)
    if FLIGHT.enabled and FLIGHT.events():
        FLIGHT.dump_jsonl(os.path.join(time_log_dir, "flight.jsonl"))


def run_throughput(input_prefix: str, stream_dir: str, streams: list[int],
                   time_log_dir: str,
                   input_format: str = "parquet",
                   output_prefix: str | None = None,
                   json_summary_folder: str | None = None,
                   sub_queries: list[str] | None = None,
                   property_file: str | None = None,
                   backend: str | None = None,
                   mode: str = "process",
                   warmup: int = 0, decimal: str | None = None,
                   max_attempts: int | None = None,
                   stream_timeout: float | None = None,
                   retry_backoff_s: float | None = None,
                   service_config=None,
                   on_service=None,
                   device: str | None = None,
                   strict: bool = False) -> float:
    """Run the given streams concurrently; returns elapsed seconds.

    Elapsed is max(stream Power End) - min(stream Power Start) over the
    written time logs, the reference's definition (nds_bench.py:138-157).

    mode "service" multiplexes every stream through ONE shared
    admission-controlled QueryService over a single Session (shared
    program cache + compatible-plan batching across streams); per-stream
    time logs keep the same contract, and ``output_prefix`` takes each
    query's result from its ticket, written after the query's time-log row.

    ``strict`` fails a stream whose statements fell back to the host (the
    power runner's ``--strict``, in every mode): it ends Failed, and the
    round raises ThroughputError.

    Streams run SUPERVISED: each gets ``max_attempts`` spawns (default
    EngineConfig.stream_attempts) and a ``stream_timeout`` wall budget
    (default EngineConfig.stream_timeout_s; 0 = none). A crashed or
    killed stream restarts with deterministic backoff; per-stream
    outcomes are written to ``throughput_status.csv`` in the log dir.
    Permanent failures raise ThroughputError carrying the partial elapsed
    over the completed streams.

    ``service_config`` (service mode only) overrides the round's
    ServiceConfig — the lifecycle's chaos rounds arm the self-healing
    knobs (circuit breaker, retry budget, lane watchdog) through it.
    ``on_service`` (service mode only) is called with the LIVE
    QueryService after start: the hook chaos/lifecycle instrumentation
    uses to observe or arm a round while its clients are in flight.

    ``device`` (thread and service modes) is the sessions' torch device
    (None = the property file's, else "cuda"); process mode's streams take
    theirs from the property file.
    """
    from .config import EngineConfig

    config = EngineConfig.from_property_file(property_file)
    if device is not None and mode == "process":
        raise ValueError("process mode's streams take their device from "
                         "the property file (nds.tpu.device)")
    if config.fault_points:
        # the supervisor's own fault points (stream.spawn) arm here: no
        # Session exists in the parent process to install them
        FAULTS.configure(config.fault_points)
    if max_attempts is None:
        max_attempts = max(1, config.stream_attempts)
    if stream_timeout is None:
        stream_timeout = config.stream_timeout_s or None
    if retry_backoff_s is None:
        retry_backoff_s = config.retry_backoff_s

    os.makedirs(time_log_dir, exist_ok=True)
    jobs = []
    for s in streams:
        stream_file = os.path.join(stream_dir, f"query_{s}.sql")
        log = stream_log_path(time_log_dir, s)
        out = os.path.join(output_prefix, f"stream_{s}") \
            if output_prefix else None
        jobs.append((s, stream_file, log, out))

    if mode == "process":
        proc_jobs = [(s, _stream_cmd(input_prefix, sf, log, input_format,
                                     out, json_summary_folder, sub_queries,
                                     property_file, backend, warmup, decimal,
                                     strict))
                     for s, sf, log, out in jobs]
        statuses = supervise_processes(proc_jobs, max_attempts=max_attempts,
                                       stream_timeout=stream_timeout,
                                       backoff_s=retry_backoff_s)
    elif mode == "service":
        # in-process multi-tenant mode: ONE session + warehouse
        # registration + program cache serves every stream through the
        # admission-controlled service; streams are client threads
        from .config import apply_decimal
        from .engine.session import Session
        from .service import QueryService, ServiceConfig

        apply_decimal(config, decimal)
        if device is not None:
            config.device = device
        session = Session(config)
        from .power import setup_tables
        setup_tables(session, input_prefix, input_format)
        svc_cfg = service_config if service_config is not None \
            else ServiceConfig(
                max_pending=max(256, 8 * len(jobs)),
                tenant_deadlines={}, default_deadline_s=0.0)
        with QueryService(session, svc_cfg) as service:
            if on_service is not None:
                on_service(service)
            def make_run(sid, sf, log, out):
                def run():
                    # one tenant per stream: the registry's per-tenant
                    # service_latency_ms series decompose the round
                    _run_stream_service(service, sf, log,
                                        sub_queries=sub_queries,
                                        warmup=warmup, backend=backend,
                                        tenant=f"stream{sid}",
                                        output_prefix=out, strict=strict)
                return run

            with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
                futures = [pool.submit(_supervised_thread_stream, s,
                                       make_run(s, sf, log, out),
                                       max_attempts,
                                       stream_timeout, retry_backoff_s)
                           for s, sf, log, out in jobs]
                statuses = [f.result() for f in futures]
        _write_service_obs(time_log_dir)
    else:
        def make_run(sf, log, out):
            def run():
                _run_stream_thread(
                    input_prefix, sf, log, input_format=input_format,
                    output_prefix=out,
                    json_summary_folder=json_summary_folder,
                    sub_queries=sub_queries, property_file=property_file,
                    backend=backend, warmup=warmup, decimal=decimal,
                    device=device, strict=strict)
            return run

        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            futures = [pool.submit(_supervised_thread_stream, s,
                                   make_run(sf, log, out), max_attempts,
                                   stream_timeout, retry_backoff_s)
                       for s, sf, log, out in jobs]
            statuses = [f.result() for f in futures]

    write_status_csv(status_csv_path(time_log_dir), statuses)
    failed = sorted(s.stream for s in statuses if s.status != "Completed")
    logs = [log for _, _, log, _ in jobs]
    if failed:
        ok_logs = [stream_log_path(time_log_dir, s.stream)
                   for s in statuses if s.status == "Completed"]
        partial = throughput_elapsed(ok_logs, allow_partial=True) \
            if ok_logs else None
        detail = "; ".join(
            f"stream {s.stream}: {s.status} after {s.attempts} attempt(s)"
            f" ({s.error})" for s in statuses if s.status != "Completed")
        msg = f"throughput streams failed permanently: {detail}"
        if partial is not None:
            msg += (f"; partial elapsed over {len(ok_logs)} completed "
                    f"stream(s): {partial:.3f}s")
        raise ThroughputError(msg, partial_elapsed=partial, failed=failed)
    return throughput_elapsed(logs)


def scrape_log(time_log: str, strict: bool = True) -> tuple[int, int] | None:
    """Return (power start ms, power end ms) from a power-run time log.

    strict=False returns None instead of raising when the log lacks its
    sentinel rows (an interrupted stream) — throughput_elapsed uses it to
    name every incomplete stream at once."""
    start = end = None
    with open(time_log) as f:
        for row in csv.reader(f):
            if not row:
                continue
            if row[0] == "Power Start Time":
                start = int(row[1])
            elif row[0] == "Power End Time":
                end = int(row[1])
    if start is None or end is None:
        if strict:
            raise IncompleteStreamLog(
                f"{time_log} is missing its Power Start/End sentinel rows "
                "— the stream was interrupted before completing")
        return None
    return start, end


def throughput_elapsed(time_logs: list[str],
                       allow_partial: bool = False) -> float:
    """max(end) - min(start) in seconds over the stream logs.

    Incomplete logs (missing file or missing sentinel rows) raise one
    IncompleteStreamLog naming every affected stream; allow_partial=True
    computes over the complete logs instead (partial-elapsed reporting for
    supervised rounds with failed streams)."""
    spans = []
    incomplete = []
    for p in time_logs:
        if not os.path.exists(p):
            incomplete.append(f"{p} (missing)")
            continue
        span = scrape_log(p, strict=False)
        if span is None:
            incomplete.append(f"{p} (no sentinel rows — interrupted)")
            continue
        spans.append(span)
    if incomplete and not allow_partial:
        raise IncompleteStreamLog(
            "incomplete stream logs: " + "; ".join(incomplete))
    if not spans:
        raise IncompleteStreamLog(
            "no complete stream logs to compute elapsed from: "
            + "; ".join(incomplete))
    return (max(e for _, e in spans) - min(s for s, _ in spans)) / 1000.0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="nds_tpu_torch.throughput")
    p.add_argument("input_prefix")
    p.add_argument("stream_dir")
    p.add_argument("streams", help="comma-separated stream ids, e.g. 1,2,3,4")
    p.add_argument("time_log_dir")
    p.add_argument("--input_format", default="parquet")
    p.add_argument("--output_prefix", default=None)
    p.add_argument("--json_summary_folder", default=None)
    p.add_argument("--sub_queries", default=None)
    p.add_argument("--property_file", default=None)
    p.add_argument("--backend", default=None, choices=["torch", "numpy"])
    p.add_argument("--mode", default="process",
                   choices=["process", "thread", "service"],
                   help="process = one OS process per stream (reference "
                        "shape); thread = in-process sessions; service = "
                        "all streams through one shared admission-"
                        "controlled QueryService (nds_tpu_torch/service)")
    p.add_argument("--warmup", type=int, default=0,
                   help="untimed pre-runs per query in each stream")
    p.add_argument("--decimal", default=None, choices=["f64", "i64"])
    p.add_argument("--max_attempts", type=int, default=None,
                   help="spawn attempts per stream (restart on crash/kill)")
    p.add_argument("--stream_timeout", type=float, default=None,
                   help="per-stream wall-clock budget in seconds")
    p.add_argument("--strict", action="store_true",
                   help="fail a stream whose statements fell back to the "
                        "host")
    a = p.parse_args(argv)
    ids = [int(s) for s in a.streams.split(",")]
    sub = a.sub_queries.split(",") if a.sub_queries else None
    elapsed = run_throughput(a.input_prefix, a.stream_dir, ids,
                             a.time_log_dir, a.input_format, a.output_prefix,
                             a.json_summary_folder, sub, a.property_file,
                             a.backend, a.mode, a.warmup, a.decimal,
                             max_attempts=a.max_attempts,
                             stream_timeout=a.stream_timeout,
                             strict=a.strict)
    print(f"Throughput Test Time: {elapsed:.3f} seconds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
