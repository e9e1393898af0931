# Copied from nds_tpu/obs/metrics.py, verbatim.
"""Unified metrics registry: typed counters/gauges for the whole engine.

Before this module every layer grew its own ad-hoc numbers — bench JSON
keys per PR, ``last_exec_stats`` dict entries, stderr one-liners. One
registry gives every layer (session, device, executor, streaming,
resilience, throughput, runners) a single place to write and every report
a single place to read: ``METRICS.snapshot()`` lands verbatim in
``bench.py`` / ``power.py`` JSON and ``scripts/trace_report.py``.

Counters are monotonic per process; runners take a snapshot before a unit
of work and report the ``delta`` so per-query/per-phase numbers come out
of process-lifetime totals. Everything is lock-protected — staging
threads, deadline workers, and compile pools all write concurrently —
and every metric a registry creates shares that REGISTRY's value lock,
so ``snapshot()`` is one consistent cut across all metrics (no torn
multi-metric deltas in power/bench summaries).

Three metric types:

- :class:`Counter` — monotonic; per-unit views come from ``delta``.
- :class:`Gauge` — last-written value (queue depths, in-flight counts).
- :class:`Histogram` — a latency/size distribution over fixed log-spaced
  buckets with exact count/sum/min/max, a ``quantile(p)`` whose error is
  bounded by the bucket spacing (documented on the class), mergeable/
  diffable snapshots, and optional label sets (tenant, template) so
  per-tenant p50/p95/p99 are readable live from the registry.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Optional, Union

Number = Union[int, float]


class Counter:
    """Monotonic counter. ``inc`` only; never reset outside tests."""
    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name: str, help: str = "",
                 lock: Optional[threading.RLock] = None):
        self.name = name
        self.help = help
        self._value: Number = 0
        self._lock = lock if lock is not None else threading.RLock()

    def inc(self, n: Number = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> Number:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0


class Gauge:
    """Last-written value (queue depths, in-flight counts)."""
    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name: str, help: str = "",
                 lock: Optional[threading.RLock] = None):
        self.name = name
        self.help = help
        self._value: Number = 0
        self._lock = lock if lock is not None else threading.RLock()

    def set(self, v: Number) -> None:
        with self._lock:
            self._value = v

    def add(self, n: Number = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> Number:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0


# -- histograms ---------------------------------------------------------------

#: log-spaced bucket upper bounds (milliseconds): ratio 2^(1/3) per bucket
#: from 0.01 ms to ~21 million ms (~6 h) — 94 buckets plus an implicit
#: +Inf overflow. One fixed global ladder means every snapshot merges with
#: every other snapshot bucket-for-bucket (multi-process rollups, window
#: diffs) without negotiation.
BUCKET_RATIO = 2.0 ** (1.0 / 3.0)
BUCKET_BOUNDS = tuple(0.01 * 2.0 ** (i / 3.0) for i in range(94))


class Histogram:
    """A distribution over the fixed log-spaced bucket ladder.

    Exact ``count``/``sum``/``min``/``max`` ride beside the bucket counts,
    so means and extremes are precise; only interior quantiles pay the
    bucketing error.

    **Quantile error bound (documented contract):** ``quantile(p)``
    returns the geometric midpoint of the bucket containing the
    nearest-rank p-th sample (the same rank convention as
    ``exact_quantile``), clamped to the exact observed [min, max]. The
    true sample at that rank lies in the same bucket, so the returned
    value is within a factor of sqrt(BUCKET_RATIO) ≈ 1.123 of it — a
    relative error of at most ~12.3% in either direction (exactly 0 at
    the extremes p=0/p=1 and whenever the distribution collapses to one
    sample, thanks to the min/max clamp and exact extreme tracking).
    ``quantile_from_snapshot`` applies the same rule to exported
    snapshots.
    """
    __slots__ = ("name", "help", "labels", "_counts", "_overflow", "_count",
                 "_sum", "_min", "_max", "_lock")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[dict] = None,
                 lock: Optional[threading.RLock] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._counts = [0] * len(BUCKET_BOUNDS)
        self._overflow = 0
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self._lock = lock if lock is not None else threading.RLock()

    def observe(self, v: Number) -> None:
        v = float(v)
        i = bisect.bisect_left(BUCKET_BOUNDS, v)
        with self._lock:
            if i < len(self._counts):
                self._counts[i] += 1
            else:
                self._overflow += 1
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, p: float) -> Optional[float]:
        """p in [0, 1]; None on an empty histogram. Error bound: see the
        class docstring (within a factor sqrt(BUCKET_RATIO) of exact)."""
        with self._lock:
            return quantile_from_snapshot(self._snapshot_locked(), p)

    def snapshot(self) -> dict:
        """Mergeable/diffable export: exact count/sum/min/max plus the
        SPARSE nonzero buckets as [le_ms, count] pairs (le=None is the
        +Inf overflow). Merging two snapshots (``merge_snapshots``) gives
        exactly the histogram of the union of their samples."""
        with self._lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> dict:
        out = {"count": self._count, "sum": round(self._sum, 6),
               "min": self._min, "max": self._max,
               "buckets": [[BUCKET_BOUNDS[i], n]
                           for i, n in enumerate(self._counts) if n]}
        if self._overflow:
            out["buckets"].append([None, self._overflow])
        return out

    def _reset(self) -> None:
        with self._lock:
            self._counts = [0] * len(BUCKET_BOUNDS)
            self._overflow = 0
            self._count = 0
            self._sum = 0.0
            self._min = None
            self._max = None


def quantile_from_snapshot(snap: dict, p: float) -> Optional[float]:
    """The histogram quantile rule applied to an exported snapshot (same
    error bound as ``Histogram.quantile``): geometric bucket midpoint,
    clamped to the snapshot's exact [min, max]."""
    count = snap.get("count", 0)
    if not count:
        return None
    p = min(1.0, max(0.0, p))
    if p <= 0.0 and snap.get("min") is not None:
        return snap["min"]      # the extremes are tracked exactly
    if p >= 1.0 and snap.get("max") is not None:
        return snap["max"]
    # nearest-rank, the SAME convention as exact_quantile: the bucket
    # bound only holds when both sides talk about the same sample (at a
    # bimodal cliff, adjacent ranks can sit in different modes)
    rank = min(count, max(1, int(round(p * (count - 1))) + 1))
    seen = 0
    le = None
    for bound, n in snap.get("buckets", ()):
        seen += n
        if seen >= rank:
            le = bound
            break
    lo, hi = snap.get("min"), snap.get("max")
    if le is None:          # overflow bucket (or malformed): exact max
        return hi
    mid = le / (BUCKET_RATIO ** 0.5)    # geometric midpoint of (le/r, le]
    if lo is not None:
        mid = max(mid, lo)
    if hi is not None:
        mid = min(mid, hi)
    return mid


def merge_snapshots(a: dict, b: dict) -> dict:
    """Combine two histogram snapshots into the snapshot of the union of
    their samples. Associative and commutative (bucket counts add; exact
    count/sum add; min/max combine), so shard-level snapshots roll up in
    any order."""
    buckets: dict = {}
    for snap in (a, b):
        for le, n in snap.get("buckets", ()):
            buckets[le] = buckets.get(le, 0) + n
    mins = [s["min"] for s in (a, b) if s.get("min") is not None]
    maxs = [s["max"] for s in (a, b) if s.get("max") is not None]
    finite = sorted((le, n) for le, n in buckets.items() if le is not None)
    if None in buckets:
        finite.append((None, buckets[None]))
    return {"count": a.get("count", 0) + b.get("count", 0),
            "sum": round(a.get("sum", 0.0) + b.get("sum", 0.0), 6),
            "min": min(mins) if mins else None,
            "max": max(maxs) if maxs else None,
            "buckets": [[le, n] for le, n in finite]}


def diff_snapshot(now: dict, before: dict) -> dict:
    """Per-window view: ``now`` minus an earlier ``before`` of the same
    histogram (bucket counts are monotonic, so the difference is exactly
    the histogram of the samples observed in between). min/max cannot be
    un-merged, so the window inherits now's — quantiles stay inside the
    window's buckets regardless; only the clamp loosens."""
    buckets: dict = {le: n for le, n in now.get("buckets", ())}
    for le, n in before.get("buckets", ()):
        buckets[le] = buckets.get(le, 0) - n
    finite = sorted((le, n) for le, n in buckets.items()
                    if le is not None and n > 0)
    if buckets.get(None, 0) > 0:
        finite.append((None, buckets[None]))
    return {"count": now.get("count", 0) - before.get("count", 0),
            "sum": round(now.get("sum", 0.0) - before.get("sum", 0.0), 6),
            "min": now.get("min"), "max": now.get("max"),
            "buckets": [[le, n] for le, n in finite]}


def exact_quantile(sorted_vals: list, p: float) -> float:
    """Nearest-rank quantile over an already-sorted sample list — the
    exact reference the histogram quantile is checked against (and the
    helper service_bench/PERF cross-checks use instead of each script
    growing a private percentile())."""
    if not sorted_vals:
        return 0.0
    k = min(len(sorted_vals) - 1, int(round(p * (len(sorted_vals) - 1))))
    return sorted_vals[k]


#: labeled histogram series per family before new label sets collapse
#: into the base (unlabeled) series — an abusive tenant/template explosion
#: degrades per-label resolution instead of growing memory unboundedly
HISTOGRAM_MAX_SERIES = 4096

#: the cardinality-cap fold has been logged already (once per process;
#: the ``histogram_series_overflow`` counter keeps the full count)
_OVERFLOW_LOGGED = False


_LABEL_BAD = str.maketrans({c: "_" for c in '{}",=\\\n\r\t'})


def _clean_labels(labels: dict) -> dict:
    """Label values are caller-provided (tenant names come off the wire):
    normalize the characters that would make series names ambiguous or
    break the Prometheus text exposition (quotes, separators, newlines,
    control chars) to underscores, once, at ingestion."""
    return {k: str(v).translate(_LABEL_BAD) for k, v in labels.items()}


def _series_name(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Named metric store; get-or-create semantics so layers never race
    over registration order.

    Every metric this registry creates shares ONE registry-level value
    lock, so :meth:`snapshot` reads all of them as a single atomic cut:
    a delta computed from two snapshots can never show metric A's update
    from a unit of work without metric B's (the torn-read class power/
    bench summaries used to be exposed to). Multi-metric updates that
    must land atomically against snapshots run under :meth:`locked`.
    Histograms live in their own namespace (a distribution named like an
    existing counter is fine — e.g. the ``service_queue_wait_ms`` total
    counter and the distribution of the same name coexist)."""

    def __init__(self) -> None:
        # registration lock (the dicts); reentrant: the labeled-series
        # overflow path re-enters histogram() for the base series
        self._lock = threading.RLock()
        self._values = threading.RLock()       # every metric's value lock
        self._metrics: dict[str, Union[Counter, Gauge]] = {}
        self._hists: dict[str, Histogram] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Counter(name, help, lock=self._values)
                self._metrics[name] = m
            elif not isinstance(m, Counter):
                raise TypeError(f"metric {name!r} is a {type(m).__name__}")
            return m

    def gauge(self, name: str, help: str = "") -> Gauge:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Gauge(name, help, lock=self._values)
                self._metrics[name] = m
            elif not isinstance(m, Gauge):
                raise TypeError(f"metric {name!r} is a {type(m).__name__}")
            return m

    def histogram(self, name: str, help: str = "", **labels) -> Histogram:
        """Get-or-create one histogram series: the base series (no
        labels) or a labeled child (``histogram("service_latency_ms",
        tenant="dash", template="a1b2")``). Children inherit the family
        help; past HISTOGRAM_MAX_SERIES labeled series the base series
        absorbs new label sets (resolution degrades, memory does not) —
        the fold is counted in ``histogram_series_overflow`` and logged
        ONCE per process, so a tenant/template cardinality explosion is
        visible instead of silently flattening the per-label views.
        Label values are sanitized (quotes/separators/newlines ->
        underscore): tenant names are caller-provided."""
        labels = _clean_labels(labels) if labels else labels
        key = _series_name(name, labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                if labels and len(self._hists) >= HISTOGRAM_MAX_SERIES:
                    self._note_series_overflow(key)
                    return self.histogram(name, help)
                if not help:
                    base = self._hists.get(name)
                    help = base.help if base is not None else ""
                h = Histogram(name, help, labels, lock=self._values)
                self._hists[key] = h
            elif help and not h.help:
                h.help = help
            return h

    def _note_series_overflow(self, key: str) -> None:
        """A labeled series fell into the base series at the cardinality
        cap: count every fold (``histogram_series_overflow``) and log the
        first one — called under the registration lock, so the inc rides
        the reentrant path (the counter shares this registry's locks)."""
        global _OVERFLOW_LOGGED
        c = self._metrics.get("histogram_series_overflow")
        if isinstance(c, Counter):
            c.inc()
        if not _OVERFLOW_LOGGED:
            _OVERFLOW_LOGGED = True
            from .log import get_logger
            get_logger().warning(
                "histogram label cardinality cap reached "
                f"({HISTOGRAM_MAX_SERIES} series): new labeled series "
                f"(first: {key!r}) fold into their base series — "
                "per-label resolution degrades, memory does not")

    def locked(self):
        """The shared value lock, for callers that update several metrics
        as one logical event: ``with METRICS.locked(): a.inc(); b.inc()``
        guarantees no snapshot observes a without b."""
        return self._values

    def snapshot(self) -> dict[str, Number]:
        """{name: value} for every counter/gauge — the uniform block
        runners embed in their JSON output. One atomic cut: taken under
        the shared value lock, so concurrent updates are either fully in
        or fully out (histograms export via :meth:`histograms`)."""
        with self._lock:
            items = sorted(self._metrics.items())
        with self._values:
            return {name: m._value for name, m in items}

    def histograms(self) -> dict[str, dict]:
        """{series: snapshot} for every histogram series (base + labeled),
        one atomic cut like :meth:`snapshot`. Series names render labels
        Prometheus-style: ``service_latency_ms{tenant=dash,template=x}``;
        each snapshot carries its ``labels`` dict for structured
        consumers (obs_report, service_bench)."""
        with self._lock:
            items = sorted(self._hists.items())
        out = {}
        with self._values:
            for key, h in items:
                snap = h._snapshot_locked()
                if not snap["count"]:
                    continue
                snap["name"] = h.name
                if h.labels:
                    snap["labels"] = dict(h.labels)
                out[key] = snap
        return out

    def percentiles(self, name: str, ps: tuple = (0.5, 0.95, 0.99),
                    ) -> list[dict]:
        """Live SLO view of one histogram family: one row per series —
        the base (all-traffic) series first, then every label set sorted
        by the highest requested quantile so the slowest tenants/
        templates lead. Each row carries count/mean/min/max and the
        requested quantiles (``p50`` etc.)."""
        rows = []
        for key, snap in self.histograms().items():
            if snap["name"] != name:
                continue
            row = {"series": key, "labels": snap.get("labels", {}),
                   "count": snap["count"],
                   "mean": round(snap["sum"] / snap["count"], 3),
                   "min": snap["min"], "max": snap["max"]}
            for p in ps:
                q = quantile_from_snapshot(snap, p)
                row[f"p{int(p * 100)}"] = round(q, 3) if q is not None \
                    else None
            rows.append(row)
        top = f"p{int(max(ps) * 100)}"
        rows.sort(key=lambda r: (bool(r["labels"]), -(r[top] or 0)))
        return rows

    def rows(self) -> list[tuple]:
        """(name, kind, value, help) for every counter/gauge, one atomic
        cut under the shared value lock — the system.metrics snapshot
        source (typed kind beside the value, unlike :meth:`snapshot`)."""
        with self._lock:
            items = sorted(self._metrics.items())
        with self._values:
            return [(name,
                     "counter" if isinstance(m, Counter) else "gauge",
                     m._value, m.help) for name, m in items]

    def delta(self, before: dict[str, Number]) -> dict[str, Number]:
        """Per-unit-of-work view: current snapshot minus ``before``,
        dropping zero rows (counters are process-lifetime totals)."""
        now = self.snapshot()
        out = {}
        for name, v in now.items():
            d = v - before.get(name, 0)
            if d:
                out[name] = round(d, 3) if isinstance(d, float) else d
        return out

    def describe(self) -> dict[str, str]:
        """{name: help} metrics glossary (README / trace_report) —
        counters, gauges, and histogram FAMILIES (one row per family,
        not per labeled series)."""
        with self._lock:
            out = {name: m.help for name, m in self._metrics.items()}
            for h in self._hists.values():
                if not h.labels and h.name not in out:
                    out[h.name] = h.help
        return dict(sorted(out.items()))

    def export_prometheus(self) -> str:
        """Prometheus text exposition of the whole registry. Counters
        export as ``<name>_total``, gauges verbatim, histograms as the
        standard ``_bucket{le=...}/_sum/_count`` triplet (cumulative
        buckets over the fixed ladder, labels preserved) — so the name
        collision between a ``*_ms`` total counter and the distribution
        of the same name stays legal after suffixing."""
        with self._lock:
            scalars = sorted(self._metrics.items())
            hists = sorted(self._hists.items())
        lines: list[str] = []
        with self._values:
            for name, m in scalars:
                kind = "counter" if isinstance(m, Counter) else "gauge"
                out_name = f"{name}_total" if kind == "counter" else name
                if m.help:
                    lines.append(f"# HELP {out_name} {m.help}")
                lines.append(f"# TYPE {out_name} {kind}")
                lines.append(f"{out_name} {m._value}")
            seen_family = set()
            for _key, h in hists:
                if h.name not in seen_family:
                    seen_family.add(h.name)
                    if h.help:
                        lines.append(f"# HELP {h.name} {h.help}")
                    lines.append(f"# TYPE {h.name} histogram")
                base = ",".join(f'{k}="{h.labels[k]}"'
                                for k in sorted(h.labels))
                cum = 0
                for i, n in enumerate(h._counts):
                    cum += n
                    if n:
                        le = f"{BUCKET_BOUNDS[i]:.6g}"
                        sep = "," if base else ""
                        lines.append(f'{h.name}_bucket{{{base}{sep}le='
                                     f'"{le}"}} {cum}')
                sep = "," if base else ""
                lines.append(f'{h.name}_bucket{{{base}{sep}le="+Inf"}} '
                             f"{cum + h._overflow}")
                lab = f"{{{base}}}" if base else ""
                lines.append(f"{h.name}_sum{lab} {round(h._sum, 6)}")
                lines.append(f"{h.name}_count{lab} {h._count}")
        return "\n".join(lines) + "\n"

    def export_json(self) -> dict:
        """One structured export of everything: the scalar snapshot, the
        histogram snapshots, and the glossary — the artifact obs_report
        and the metrics gate read."""
        return {"metrics": self.snapshot(), "histograms": self.histograms(),
                "describe": self.describe()}

    def reset(self) -> None:
        """Zero every metric (tests only; counters are monotonic in
        production). Labeled histogram series unregister entirely —
        tests must not see a previous test's tenants."""
        with self._lock:
            metrics = list(self._metrics.values())
            hists = list(self._hists.values())
            self._hists = {k: h for k, h in self._hists.items()
                           if not h.labels}
        for m in metrics:
            m._reset()
        for h in hists:
            h._reset()


#: the process-global registry; every engine layer writes through it.
METRICS = MetricsRegistry()

# Pre-registered engine metrics: importing a layer must not be required
# before its counters appear in snapshots, and attribute-style access
# (``from ..obs.metrics import QUERIES_RUN``) is typo-safe at import time.
QUERIES_RUN = METRICS.counter(
    "queries_run", "sql() calls executed by any Session")
QUERY_FAILURES = METRICS.counter(
    "query_failures", "timed query runs that raised (power runner)")
RETRIES = METRICS.counter(
    "retries", "retry attempts consumed by any RetryPolicy/BenchReport")
FAULT_FIRINGS = METRICS.counter(
    "fault_point_firings", "armed fault specs triggered (FaultRegistry)")
PROGRAM_CACHE_HITS = METRICS.counter(
    "program_cache_hits", "compiled/recorded plan entries served from cache")
PROGRAM_CACHE_MISSES = METRICS.counter(
    "program_cache_misses", "plan entries recorded fresh (first sighting)")
PROGRAMS_ADOPTED = METRICS.counter(
    "programs_adopted", "cross-stream shared-program adoptions")
COMPILES = METRICS.counter(
    "compiles", "whole-plan XLA compilations (jit first-run + precompile)")
SCAN_PASSES = METRICS.counter(
    "scan_passes", "streamed morsel loops over a big table")
MORSELS = METRICS.counter(
    "morsels", "morsels executed across all streamed queries")
BYTES_UPLOADED = METRICS.counter(
    "bytes_uploaded", "host->device bytes staged for streamed morsels")
HOST_FALLBACKS = METRICS.counter(
    "host_fallbacks", "plan nodes served by the host oracle backend")
PREFETCH_ERRORS = METRICS.counter(
    "prefetch_errors", "staging-thread failures (morsel restaged sync)")
STREAM_RESTARTS = METRICS.counter(
    "stream_restarts", "throughput stream attempts beyond the first")
REPLAY_MISMATCHES = METRICS.counter(
    "replay_mismatches", "compiled schedules invalidated by capacity drift")
# Pallas kernel dispatches (pallas_kernels): counted at build time — once
# per kernel instantiation under a jit trace, once per call in eager record
PALLAS_SORT_CALLS = METRICS.counter(
    "pallas_sort_calls", "tiled bitonic sort_pairs dispatches (pallas)")
PALLAS_GROUPBY_CALLS = METRICS.counter(
    "pallas_groupby_calls", "fused seg_reduce partial-agg dispatches (pallas)")
PALLAS_GATHER_CALLS = METRICS.counter(
    "pallas_gather_calls", "VMEM-staged take_many dispatches (pallas)")
# Encoded execution (device.plan_encodings): dictionary/RLE wire encodings
DICT_UPLOADS_SAVED = METRICS.counter(
    "dict_uploads_saved", "device codebook uploads served from the "
    "per-group cache instead of re-uploading")
DECODE_SITES = METRICS.counter(
    "decode_sites", "encoded columns materialized to values (decode_col: "
    "arithmetic/aggregate/output sites)")
HOST_DECODE_MS = METRICS.counter(
    "host_decode_ms", "host-side Arrow->engine morsel decode wall (ms) "
    "summed over streamed tables — the staging-thread bottleneck "
    "ROADMAP item 2 (device-side page decode) exists to remove")
# Concurrent query service (nds_tpu/service): admission, queueing, batching
SERVICE_ADMITTED = METRICS.counter(
    "service_admitted", "queries accepted into the service queue")
SERVICE_REJECTED = METRICS.counter(
    "service_rejected", "queries refused at admission (queue full / "
    "service closed) — typed AdmissionRejected, never a pile-up")
SERVICE_DEADLINE_EXPIRED = METRICS.counter(
    "service_deadline_expired", "admitted queries whose per-tenant "
    "deadline expired before execution started (typed DeadlineExceeded)")
SERVICE_BATCHES = METRICS.counter(
    "service_batches", "batched dispatches: one compiled program served "
    "a stacked parameter matrix for several compatible queries")
SERVICE_BATCHED_QUERIES = METRICS.counter(
    "service_batched_queries", "queries served through a batched dispatch "
    "(including parameter-identical duplicates deduplicated in-batch)")
SERVICE_QUEUE_WAIT_MS = METRICS.counter(
    "service_queue_wait_ms", "total wall (ms) admitted queries spent "
    "waiting between admission and execution start")
SERVICE_QUEUE_DEPTH = METRICS.gauge(
    "service_queue_depth", "queries currently admitted but not finished "
    "(the admission-control pressure signal)")
# Self-healing service mechanisms (chaos-hardened serving): the breaker,
# retry budget, and program quarantine the chaos campaigns exercise —
# all exactly zero on a healthy run (the metrics gate pins the first
# two strict-zero on its clean workload)
CIRCUIT_TRIPS = METRICS.counter(
    "circuit_trips", "per-error-class circuit-breaker trips (incl. "
    "half-open probe failures re-opening): admission then refuses work "
    "with typed CircuitOpen until a probe succeeds")
RETRY_BUDGET_SPENT = METRICS.counter(
    "retry_budget_spent", "transient ticket failures re-dispatched off "
    "the device lane by the service's bounded retry budget")
QUARANTINED_PROGRAMS = METRICS.counter(
    "quarantined_programs", "shared compiled-program cache entries "
    "evicted after repeated faults/ReplayMismatches (re-recorded fresh "
    "on next use instead of poisoning every adopter)")
LIFECYCLE_PHASE_RETRIES = METRICS.counter(
    "lifecycle_phase_retries", "scored-lifecycle phases re-run after a "
    "failure (lifecycle.LifecycleRunner phase_attempts)")
# Semantic result cache (engine/result_cache.py): cross-client result
# reuse keyed by parameterized-plan fingerprint + parameter vector, with
# subsumption proofs and incremental view maintenance from LF_*/DF_*
# deltas — all opt-in, all exactly zero when the cache is disabled (the
# metrics gate pins result_cache_hits strict-zero on its clean workload)
RESULT_CACHE_HITS = METRICS.counter(
    "result_cache_hits", "queries answered from the semantic result "
    "cache's exact tier (no planning, no device dispatch)")
RESULT_CACHE_MISSES = METRICS.counter(
    "result_cache_misses", "result-cache lookups that fell through to "
    "normal execution (cold text, stale generation, expired TTL, or no "
    "provable subsumption)")
RESULT_CACHE_SUBSUMPTION_HITS = METRICS.counter(
    "result_cache_subsumption_hits", "queries answered by re-filtering a "
    "cached coarser aggregate after a containment proof (provably-"
    "narrower filter over the same group keys — no scan, no upload)")
RESULT_CACHE_IVM_UPDATES = METRICS.counter(
    "result_cache_ivm_updates", "cached aggregate entries updated in "
    "place from a maintenance insert/delete delta (mergeable partial "
    "state merged/recomputed instead of invalidated)")
RESULT_CACHE_INVALIDATIONS = METRICS.counter(
    "result_cache_invalidations", "result-cache entries dropped for "
    "staleness (table generation moved, TTL expired, or a delta the "
    "entry could not absorb)")
# EXPLAIN ANALYZE / per-plan-node runtime profiles (obs/profile.py): all
# exactly zero when profiling is off (the metrics gate pins both
# strict-zero on its clean, profiling-off workload)
PROFILED_QUERIES = METRICS.counter(
    "profiled_queries", "queries executed in profiled (EXPLAIN ANALYZE) "
    "mode: eager node-by-node walk with per-node wall/rows/bytes, "
    "bit-identical results (Session.explain_analyze / "
    "EngineConfig.profile_plans)")
CARDINALITY_MISESTIMATES = METRICS.counter(
    "cardinality_misestimates", "estimate-vs-actual cardinality audit "
    "findings above the misestimate ratio threshold (profiled runs only: "
    "planner static size assumption vs exact per-node row count)")
HISTOGRAM_SERIES_OVERFLOW = METRICS.counter(
    "histogram_series_overflow", "labeled histogram series folded into "
    "their base series at the HISTOGRAM_MAX_SERIES cardinality cap "
    "(per-label resolution degraded; logged once per process)")
# Device-memory watermark accounting (obs/profile.DEVICE_MEM): the live
# set of tracked device allocations (to_device/pack_table/stage_sharded
# uploads + the codebook cache) and its process-lifetime peak — compiled-
# program intermediates are NOT tracked (see DeviceMemTracker)
DEVICE_LIVE_BYTES = METRICS.gauge(
    "device_live_bytes", "tracked device-resident bytes currently live "
    "(uploads + codebook cache; freed buffers subtract)")
DEVICE_PEAK_BYTES = METRICS.gauge(
    "device_peak_bytes", "process-lifetime peak of device_live_bytes — "
    "the high-water mark headroom checks compare to the HBM budget")
# System tables + durable query log (obs/system_tables.py, obs/
# query_log.py): all exactly zero when the log is disabled and no
# system.* statement runs (the metrics gate pins all three strict-zero
# on its clean workload — the zero-cost contract for the disabled path)
SYSTEM_QUERIES = METRICS.counter(
    "system_queries", "system.* statements served through the host-only "
    "introspection path (Session.system_query / the service's admission "
    "bypass / the /query scrape endpoint) — never a device dispatch")
QUERY_LOG_ROWS = METRICS.counter(
    "query_log_rows", "statement rows appended to the durable query log "
    "(in-memory ring + optional JSONL sink; obs/query_log.py)")
QUERY_LOG_ROTATIONS = METRICS.counter(
    "query_log_rotations", "query-log JSONL files rolled by the "
    "size-capped rotation (oldest rotated file deleted past max_files)")
# Transactional warehouse (warehouse.py _snapshots log): atomic multi-
# table commits, aborts, and crash recovery — all exactly zero on a
# query-only workload (the metrics gate pins all three strict-zero on
# its clean, maintenance-free workload) and zero whenever
# EngineConfig.warehouse_transactions is off
TXN_COMMITS = METRICS.counter(
    "txn_commits", "warehouse transactions published atomically (one "
    "version record + CURRENT swing naming every table's manifest "
    "version — the cross-table commit point)")
TXN_ROLLBACKS = METRICS.counter(
    "txn_rollbacks", "warehouse transactions aborted (per-table "
    "manifests truncated back to the transaction's base versions) plus "
    "explicit rollback_to_version restores")
TXN_RECOVERIES = METRICS.counter(
    "txn_recoveries", "orphaned in-progress transactions discarded at "
    "warehouse open (crash recovery: each table back to max(base, "
    "published) — never a blend of pre- and post-commit state)")
# Adaptive execution (engine/feedback.py): the feedback stats store
# closing the loop from observed actuals to the next sighting's plans —
# all exactly zero when EngineConfig.adaptive_plans is off (no store is
# constructed; the metrics gate pins all three strict-zero on its clean,
# adaptation-off workload)
FEEDBACK_HITS = METRICS.counter(
    "feedback_hits", "streamed scan groups whose capacity schedule was "
    "right-sized from the feedback store's observed per-decision maxima "
    "instead of morsel-bound inflation (a ceiling hint: an "
    "under-observed actual re-records, never mis-answers)")
FEEDBACK_REFRESHES = METRICS.counter(
    "feedback_refreshes", "drift-sentinel refreshes: a template's "
    "observed profile diverged from its own history past the drift "
    "ratio, so the stale history was replaced and the generation bumped "
    "(the next sighting re-records instead of replaying stale caps)")
ADAPTIVE_REPLANS = METRICS.counter(
    "adaptive_replans", "streamed re-records driven by feedback: a "
    "cached schedule invalidated by a moved profile generation, or an "
    "adapted (right-sized) schedule overflowed by an under-observed "
    "actual (ReplayMismatch fallback — correctness preserved)")
# Distributed serving (service/frontdoor.py + fair scheduling in
# service/service.py): all exactly zero when the front door is not
# started and fair_queue/preemption/inflight_dedup are off (the
# defaults) — the metrics gate pins all six strict-zero on its clean
# in-process workload (the everything-opt-in contract)
FRONTDOOR_REQUESTS = METRICS.counter(
    "frontdoor_requests", "requests served by the Arrow-IPC front door "
    "(query/ping/cache_snapshot/cache_validate frames across all client "
    "connections; service/frontdoor.py)")
FRONTDOOR_ERRORS = METRICS.counter(
    "frontdoor_errors", "front-door requests answered with a typed error "
    "frame (the resilience class + fields reconstructed client-side) or "
    "dropped by an injected connection fault")
SERVICE_PREEMPTIONS = METRICS.counter(
    "service_preemptions", "interactive tickets served at a streamed "
    "query's morsel-boundary yield point (the batch scan paused between "
    "scan groups, the device lane ran the short query, the stream "
    "resumed its cached state — bit-identity preserved)")
SERVICE_INFLIGHT_DEDUP = METRICS.counter(
    "service_inflight_dedup", "admitted tickets that parked on an "
    "already-in-flight ticket with the same (fingerprint, params, "
    "snapshot) key instead of re-entering the planner queue — followers "
    "attach to the leader's shared result cell")
RESULT_CACHE_SNAPSHOTS = METRICS.counter(
    "result_cache_snapshots", "exact-tier result-cache exports served "
    "over the front door (Arrow-IPC snapshot frames warming a client "
    "process's local cache)")
FRONTDOOR_CLIENT_CACHE_HITS = METRICS.counter(
    "frontdoor_client_cache_hits", "client-side cache hits served from a "
    "snapshot-warmed local result set after the per-lookup validation "
    "handshake confirmed the entry's generations are still current")

# Service latency distributions (histogram families): the base series
# aggregates every query; the service also records per-(tenant, template)
# children, so per-tenant p50/p95/p99 and the top-K slow templates are
# readable LIVE from the registry (METRICS.percentiles) instead of being
# recomputed by each bench script. queue_wait + plan + exec + materialize
# decompose service_latency_ms end-to-end (materialize lands on the
# client thread AFTER completion, so it rides beside, not inside).
SERVICE_LATENCY_HIST = METRICS.histogram(
    "service_latency_ms", "per-query service latency distribution, "
    "admission -> completion (labeled by tenant + template fingerprint)")
SERVICE_QUEUE_WAIT_HIST = METRICS.histogram(
    "service_queue_wait_ms", "distribution of the wall between admission "
    "and execution start (the counter of the same name keeps the total)")
SERVICE_PLAN_HIST = METRICS.histogram(
    "service_plan_ms", "planner-stage wall distribution "
    "(parse/plan/parameterize on the planner worker threads)")
SERVICE_EXEC_HIST = METRICS.histogram(
    "service_exec_ms", "device-lane execution wall distribution "
    "(batched dispatch or serial session run)")
SERVICE_MATERIALIZE_HIST = METRICS.histogram(
    "service_materialize_ms", "deferred result-materialization wall "
    "distribution (client-thread Table conversion in Ticket.result)")
QUERY_LATENCY_HIST = METRICS.histogram(
    "query_latency_ms", "timed single-caller query latency distribution "
    "(bench timed runs / power stream, labeled by template)")
