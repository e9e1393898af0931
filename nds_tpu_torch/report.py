# Copied from nds_tpu/report.py; _host_capture reports torch and the card
# in place of jax.
"""Per-query benchmark reports: status, timing, environment capture.

Capability parity with the reference's observability layer (reference
nds/PysparkBenchReport.py): wrap any callable, capture redacted env vars
(:71-72), engine configuration (the Spark-conf analog), wall time, a status
taxonomy — Completed / CompletedWithTaskFailures / Failed — and exceptions
(report_on :59-107); write ``{prefix}-{query}-{startTime}.json`` summaries
whose filename format downstream tooling depends on (write_summary
:109-122). The "task failure" analog on this engine is a device-backend
node falling back to the host oracle (collected per query), plus any
partial-shard errors once multi-host execution lands.

The host capture names torch, its CUDA version and the card in place of
the reference's jax keys.
"""
from __future__ import annotations

import json
import os
import time
import traceback
from dataclasses import asdict, is_dataclass
from typing import Any, Callable


#: summary-layout version: bump when keys change shape so downstream
#: tooling can compare BENCH_r*.json / power summaries across rounds.
#: v2: adds schemaVersion itself, env.host capture, metrics, spans.
SCHEMA_VERSION = 2

REDACT_MARKERS = ("TOKEN", "SECRET", "PASSWORD", "PASSWD", "CREDENTIAL",
                  "APIKEY", "API_KEY", "AUTH")


def _redacted_env() -> dict[str, str]:
    out = {}
    for k, v in os.environ.items():
        if any(m in k.upper() for m in REDACT_MARKERS):
            v = "*********(redacted)"
        out[k] = v
    return out


def _host_capture(device=None) -> dict:
    """Redacted host/runtime capture: enough to explain a cross-round
    performance delta (CPU/arch/python/torch/CUDA/card) without leaking
    the host identity — the hostname rides only as a short hash so runs
    from the same machine are groupable but the name never lands in
    artifacts. ``device`` is the session's device ("cuda" when None):
    the card's name is read only when the session runs on it, so a CPU
    run never initialises CUDA.
    """
    import hashlib
    import platform
    import socket

    out: dict = {
        "host_id": hashlib.sha1(
            socket.gethostname().encode()).hexdigest()[:10],
        "platform": platform.platform(),
        "machine": platform.machine(),
        "python": platform.python_version(),
        "cpu_count": os.cpu_count(),
    }
    try:
        import torch
        out["torch"] = torch.__version__
        out["torch_cuda"] = torch.version.cuda
        on_card = torch.device(device or "cuda").type == "cuda" \
            and torch.cuda.is_available()
        out["device_name"] = torch.cuda.get_device_name(0) if on_card \
            else "cpu"
        out["device_count"] = torch.cuda.device_count()
    except Exception:
        pass
    return out


class BenchReport:
    """Collects one benchmark run's summary (one query, one table load...)."""

    def __init__(self, engine_config: Any = None, app_name: str = ""):
        cfg = {}
        device = getattr(engine_config, "device", None)
        if is_dataclass(engine_config):
            cfg = {k: str(v) for k, v in asdict(engine_config).items()}
        elif isinstance(engine_config, dict):
            cfg = {k: str(v) for k, v in engine_config.items()}
        self.summary = {
            "schemaVersion": SCHEMA_VERSION,
            "env": {
                "envVars": _redacted_env(),
                "host": _host_capture(device),
                "engineConf": cfg,
                "appName": app_name,
            },
            "queryStatus": [],
            "exceptions": [],
            "startTime": None,
            "queryTimes": [],
            "taskFailures": [],
            # per-attempt records (resilience layer): attempts consumed per
            # report_on call, and the per-attempt status trail — a query
            # that failed transiently then completed reads
            # attempts=[2], retriedStatus=[["Failed", "Completed"]]
            "attempts": [],
            "retriedStatus": [],
        }

    def report_on(self, fn: Callable, *args, retry=None, **kwargs):
        """Run fn, recording wall time and status. Returns fn's result
        (or None on failure).

        retry: an optional resilience.RetryPolicy — transient failures
        re-run fn with deterministic backoff; every attempt's status lands
        in the summary (``attempts``/``retriedStatus``), and a retried-
        then-successful query records each failed attempt as a task
        failure, so finalize_status upgrades it to
        CompletedWithTaskFailures instead of a clean Completed.
        """
        self.summary["startTime"] = int(time.time() * 1000)
        start = time.perf_counter()
        result = None
        attempt_trail: list[str] = []
        while True:
            try:
                result = fn(*args, **kwargs)
                status = "Completed"
                attempt_trail.append(status)
                break
            except Exception as e:
                status = "Failed"
                attempt_trail.append(status)
                self.summary["exceptions"].append(traceback.format_exc())
                if retry is None or len(attempt_trail) >= retry.max_attempts \
                        or retry.classify(e) == "fatal":
                    break
                self.record_task_failure(
                    f"attempt {len(attempt_trail)} failed "
                    f"({type(e).__name__}); retrying")
                from .obs.metrics import RETRIES
                RETRIES.inc()
                time.sleep(retry.backoff(len(attempt_trail)))
        elapsed = int((time.perf_counter() - start) * 1000)
        if status == "Completed" and self.summary["taskFailures"]:
            status = "CompletedWithTaskFailures"
        self.summary["queryStatus"].append(status)
        self.summary["queryTimes"].append(elapsed)
        self.summary["attempts"].append(len(attempt_trail))
        self.summary["retriedStatus"].append(attempt_trail)
        return result

    def record_task_failure(self, detail: str) -> None:
        """Analog of the reference's Scala TaskFailureListener feed
        (reference nds/jvm_listener TaskFailureListener.scala): failures
        that did not abort the query but must surface in the status."""
        self.summary["taskFailures"].append(detail)

    def record_exec_stats(self, stats: dict) -> None:
        """Per-query device/host split (the Spark-UI job-group analog,
        reference nds_power.py:254): execution mode (record / compile+run /
        compiled / eager) and device milliseconds."""
        self.summary.setdefault("execStats", []).append(stats)

    def record_metrics(self, delta: dict) -> None:
        """Engine-metrics delta (obs.metrics.METRICS.delta over this unit
        of work): the uniform counters block every runner's JSON carries."""
        if delta:
            self.summary["metrics"] = delta

    def finalize_status(self) -> str:
        """Re-derive the last status after post-run failure recording (task
        failures land after report_on returns)."""
        if self.summary["queryStatus"] and self.summary["taskFailures"] \
                and self.summary["queryStatus"][-1] == "Completed":
            self.summary["queryStatus"][-1] = "CompletedWithTaskFailures"
        return self.summary["queryStatus"][-1] if \
            self.summary["queryStatus"] else "Failed"

    def write_summary(self, query_name: str, prefix: str = "") -> str | None:
        if not prefix:
            return None
        os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
        # filename format consumed by reporting pipelines
        # (reference PysparkBenchReport.py:116-118)
        path = f"{prefix}-{query_name}-{self.summary['startTime']}.json"
        with open(path, "w") as f:
            json.dump(self.summary, f, indent=2)
        return path
