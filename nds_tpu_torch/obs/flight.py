# Copied from nds_tpu/obs/flight.py, verbatim.
"""Flight recorder: a bounded ring of query-lifecycle events.

Metrics answer "how much"; traces answer "where did the time go" for runs
you thought to trace. The flight recorder answers the post-mortem
question — *what was the service doing right before it went wrong* —
without requiring anything to be enabled ahead of the failure window
being interesting: it is cheap enough to leave on for whole service runs
(a dict append into a fixed-size ring), keeps only the most recent
``capacity`` events, and dumps itself to JSONL when something trips it:

- **explicitly** (``FLIGHT.dump_jsonl(path)`` / ``scripts/obs_report.py``),
- **on a typed-rejection storm** — ``reject_storm`` rejections inside
  ``reject_window_s`` seconds auto-dump once per cooldown, so the record
  of the overload's onset survives the overload;
- **when a FaultRegistry point fires** — chaos runs (``nds_tpu/chaos``)
  arm ``device.put``/``jax.compile``/... specs mid-service and assert
  against the dumped artifact: the ring holds the admissions, dispatches,
  and batch compositions that surrounded the injected failure;
- **when a circuit breaker trips** — a per-error-class failure storm
  crossing its windowed rate dumps the window that tripped it
  (``resilience.CircuitBreaker``), once per class per cooldown.

Events are flat dicts: ``seq`` (total-order sequence number), ``t_ms``
(monotonic ms since recorder start — immune to wall-clock steps), an
``event`` tag (admit / plan / dispatch / batch / retry / fault / reject /
expire / complete / error / trip / probe / quarantine / lifecycle_phase /
maintenance), and whatever fields the recording site attaches (label,
tenant, template, latency_ms, ...). The self-healing vocabulary: ``trip``
marks a breaker/watchdog/fault-storm moment (reason field), ``probe`` a
half-open breaker admission or its closing outcome, ``quarantine`` a
shared compiled program evicted after repeated strikes, and
``lifecycle_phase``/``maintenance`` the scored-lifecycle runner's phase
transitions interleaving with live service traffic. The transactional
vocabulary (``nds_tpu/warehouse``): ``txn_commit`` an atomic cross-table
warehouse commit landing (committer, published version, tables touched),
``txn_rollback`` a transaction aborting back to its base snapshot
(``clean`` records whether the intent record was retired or left for
recovery), and ``txn_recover`` a reopened warehouse discarding a dead
writer's orphaned partial commit. The adaptive-execution vocabulary
(``engine/feedback.py``): ``feedback_hit`` a streamed group's capacity
schedule right-sized from observed actuals, ``feedback_refresh`` the
drift sentinel replacing a stale profile, and ``adaptive_replan`` a
feedback-driven re-record (moved profile generation, or an adapted
schedule overflowed by an under-observed actual).

Disabled (the default outside the service) a record() is one attribute
read — the same near-zero contract as the span tracer. Enable with
``FLIGHT.configure(enabled=True, dump_dir=...)``, ``NDS_TPU_FLIGHT=1``
(+ ``NDS_TPU_FLIGHT_DIR``), or ``QueryService`` knobs.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional


class FlightRecorder:
    """Process-wide lifecycle-event ring (one instance: ``FLIGHT``)."""

    def __init__(self, capacity: int = 4096):
        self.enabled = False
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._seq = 0
        self._epoch = time.monotonic()
        self.dump_dir: Optional[str] = None
        #: reject-storm trip wire: N rejects inside the window auto-dump
        self.reject_storm = 50
        self.reject_window_s = 10.0
        self._rejects: deque = deque()
        #: per-reason cooldown so a sustained storm/fault burst produces
        #: one artifact per window, not one per event
        self.trip_cooldown_s = 30.0
        self._last_trip: dict[str, float] = {}
        #: paths written by automatic trips (inspection/tests), oldest
        #: first — the retention caps below evict from the FRONT
        self.dumps: list[str] = []
        #: dump retention (a reject-storm or long chaos campaign must not
        #: grow the dump dir unboundedly): most dump files kept, and a
        #: total-bytes cap across them — oldest-first eviction, applied
        #: only to files THIS recorder wrote (self.dumps)
        self.max_dumps = 200
        self.max_dump_bytes = 256 << 20
        self._dump_bytes: dict[str, int] = {}
        #: monotonic dump index: filenames sort chronologically and stay
        #: stable under wall-clock steps (seq-stable naming)
        self._dump_seq = 0

    # -- control -------------------------------------------------------------
    def configure(self, enabled: bool = True,
                  capacity: Optional[int] = None,
                  dump_dir: Optional[str] = None,
                  reject_storm: Optional[int] = None,
                  reject_window_s: Optional[float] = None,
                  trip_cooldown_s: Optional[float] = None,
                  max_dumps: Optional[int] = None,
                  max_dump_bytes: Optional[int] = None,
                  clear: bool = True) -> "FlightRecorder":
        """``trip_cooldown_s`` 0 dumps on EVERY trip — chaos campaigns
        set it so an artifact exists per firing (the default 30s keeps a
        sustained production storm to one dump per window per reason).
        ``max_dumps``/``max_dump_bytes`` cap automatic-trip dump
        retention: past either cap the OLDEST dump files this recorder
        wrote are deleted first (a long campaign keeps its newest
        evidence; the dir stays bounded)."""
        with self._lock:
            if capacity is not None:
                self._ring = deque(self._ring, maxlen=capacity)
            if dump_dir is not None:
                self.dump_dir = dump_dir
            if reject_storm is not None:
                self.reject_storm = reject_storm
            if reject_window_s is not None:
                self.reject_window_s = reject_window_s
            if trip_cooldown_s is not None:
                self.trip_cooldown_s = trip_cooldown_s
            if max_dumps is not None:
                self.max_dumps = max_dumps
            if max_dump_bytes is not None:
                self.max_dump_bytes = max_dump_bytes
            if clear:
                self._ring.clear()
                self._rejects.clear()
                self._last_trip.clear()
                self.dumps = []
                self._dump_bytes = {}
                self._dump_seq = 0
                self._seq = 0
                self._epoch = time.monotonic()
            self.enabled = enabled
        return self

    def clear(self) -> None:
        self.configure(enabled=self.enabled, clear=True)

    # -- recording -----------------------------------------------------------
    def record(self, event: str, **fields) -> None:
        """Append one lifecycle event (no-op while disabled). A "reject"
        event also feeds the storm trip wire."""
        if not self.enabled:
            return
        now = time.monotonic()
        with self._lock:
            self._seq += 1
            e = {"seq": self._seq,
                 "t_ms": round((now - self._epoch) * 1000.0, 3),
                 "event": event}
            e.update(fields)
            self._ring.append(e)
            if event != "reject":
                return
            self._rejects.append(now)
            while self._rejects and \
                    now - self._rejects[0] > self.reject_window_s:
                self._rejects.popleft()
            storm = len(self._rejects) >= self.reject_storm
            count = len(self._rejects)
            if storm:
                # one trip per storm: the next trip needs a fresh window
                # of rejections (the dump cooldown additionally bounds
                # artifact volume under sustained overload)
                self._rejects.clear()
        if storm:
            self.trip("reject_storm", rejects=count,
                      window_s=self.reject_window_s)

    def trip(self, reason: str, **fields) -> Optional[str]:
        """Something post-mortem-worthy happened: record a "trip" event
        and, when a dump_dir is configured, write the ring to a JSONL
        artifact (rate-limited per reason by trip_cooldown_s). Returns
        the written path, or None when rate-limited / not dumping."""
        if not self.enabled:
            return None
        now = time.monotonic()
        with self._lock:
            last = self._last_trip.get(reason)
            limited = last is not None and \
                now - last < self.trip_cooldown_s
            if not limited:
                self._last_trip[reason] = now
        self.record("trip", reason=reason, dumped=not limited, **fields)
        if limited or not self.dump_dir:
            return None
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in reason)   # "circuit:FaultError" etc.
        with self._lock:
            # monotonic, seq-stable filename: sorting a dump dir by name
            # is chronological regardless of wall-clock steps, and two
            # trips inside one second never collide
            self._dump_seq += 1
            path = os.path.join(
                self.dump_dir,
                f"flight_{self._dump_seq:05d}_{safe}.jsonl")
        self.dump_jsonl(path)
        with self._lock:
            self.dumps.append(path)
            try:
                self._dump_bytes[path] = os.path.getsize(path)
            except OSError:
                self._dump_bytes[path] = 0
            evict = self._retention_evict_locked()
        for old in evict:
            try:
                os.remove(old)
            except OSError:
                pass
        return path

    def _retention_evict_locked(self) -> list[str]:
        """Oldest-first eviction past max_dumps/max_dump_bytes: returns
        the paths to delete (removed from the bookkeeping here, unlinked
        by the caller outside the lock). Only files this recorder wrote
        are ever candidates."""
        evict: list[str] = []
        total = sum(self._dump_bytes.values())
        while self.dumps and (
                len(self.dumps) > self.max_dumps
                or (total > self.max_dump_bytes and len(self.dumps) > 1)):
            old = self.dumps.pop(0)
            total -= self._dump_bytes.pop(old, 0)
            evict.append(old)
        return evict

    # -- inspection / export -------------------------------------------------
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def dump_jsonl(self, path: str) -> str:
        """Write the current ring, oldest first, one event per line —
        the artifact ``scripts/trace_report.py`` / ``obs_report.py``
        summarize and chaos runs assert against."""
        events = self.events()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")
        return path


#: the process-global recorder every lifecycle hook reports into.
FLIGHT = FlightRecorder()

if os.environ.get("NDS_TPU_FLIGHT", "").lower() in ("1", "true", "yes",
                                                    "on"):
    FLIGHT.configure(enabled=True,
                     dump_dir=os.environ.get("NDS_TPU_FLIGHT_DIR") or ".")
