# Ported from nds_tpu/service/service.py: the port's Session, executor and
# registry in place of the jax backend's; the result cache, scrape endpoint,
# system tables and EXPLAIN ANALYZE raise NotImplementedError.
"""The in-process concurrent query service, on the port's Session.

A port of ``nds_tpu/service/service.py``: the same admission control,
stages, batching and self-healing, over ``nds_tpu_torch``'s Session and
its torch executor.

- **Admission control** (``submit``): a bounded pending count; overload
  raises a typed :class:`~nds_tpu_torch.resilience.AdmissionRejected`.
  Per-tenant wall-clock budgets map onto
  :class:`~nds_tpu_torch.resilience.Deadline`; a query whose budget
  expires while queued fails typed (``DeadlineExceeded``) while its
  neighbours complete.
- **Pipelined scheduling**: planner threads parse, plan and parameterize
  queued queries (host-only Python, under the session's state lock for
  the catalog and column stats, never a CUDA call) while the one device
  lane runs earlier ones. A cross-client plan cache keyed by SQL text and
  the session's streaming configuration plans a repeated text once.
- **Shared programs**: execution reuses the session's executor and the
  process-wide registry of shared programs (``torch_backend/compiled.py``):
  a new text of a known template adopts its schedule and replays its
  program.
- **Compatible-plan batching**: ready queries that parameterize to one
  plan fingerprint run as one program over stacked parameter vectors
  (``compiled.BatchedQuery``: on the card one CUDA graph per (program,
  batch capacity), row i reading the views ``slot[i]``); parameter-
  identical duplicates share one row. Row i computes what the single
  program computes, so results are bit-identical to serial runs; any
  schedule drift serves the batch serially. Each batch failure's class
  rides its tickets' stats (``extra["batch_error"]``) and the flight ring.

The device lane is one thread, and the session serializes statements on
its ``_sql_lock``, so direct ``session.sql`` callers stay correct beside
the service. It captures its graphs in thread-local mode, so that a
planner thread's host work never invalidates a capture.

**Self-healing** (opt-in through ServiceConfig): a per-error-class
circuit breaker at admission, a bounded retry budget re-dispatching
transient failures off the lane, quarantine of shared programs that fail
repeatedly (on by default: evicted and recorded afresh), and a device-lane
watchdog that abandons a wedged dispatch and swaps fresh session locks.
Weighted-fair queueing, morsel-boundary preemption and in-flight dedup
are the reference's, off by default.

Not ported yet, each raising NotImplementedError: the semantic result
cache (``ServiceConfig.result_cache``), the metrics scrape endpoint
(``metrics_port``), ``system.*`` statements and ``explain_analyze``.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Optional

from ..obs import metrics as _metrics
from ..obs.flight import FLIGHT
from ..obs.stats import ExecStats
from ..obs.trace import TRACER
from ..resilience import (AdmissionRejected, CircuitBreaker,
                          CircuitBreakerConfig, CircuitOpen, Deadline,
                          DeadlineExceeded, RetryPolicy, run_with_deadline)


def _observe_phase(name: str, ms: float, tenant: str,
                   template: Optional[str]) -> None:
    """Record one phase wall into its histogram family: the base series
    (whole-service view) plus the (tenant, template) child, so per-tenant
    p50/p95/p99 and top-K slow templates read live from the registry."""
    _metrics.METRICS.histogram(name).observe(ms)
    if template:
        _metrics.METRICS.histogram(name, tenant=tenant,
                                   template=template).observe(ms)


class ServiceClosed(AdmissionRejected):
    """Submitted to a service that is not running (never started, closing,
    or closed) — a typed admission failure, retryable against a restarted
    service."""


@dataclass
class ServiceConfig:
    """Knobs of one QueryService instance (engine knobs stay on
    EngineConfig — the service composes a Session, it does not own one)."""
    #: admitted-but-unfinished queries the service holds before refusing
    #: new work (typed AdmissionRejected). The pressure valve: clients see
    #: overload immediately and back off instead of stacking latency.
    max_pending: int = 256
    #: planner worker threads (parse/plan/parameterize). Host-side Python:
    #: more than a few buys little under the GIL, but >= 2 keeps planning
    #: flowing while one worker waits on cold column-stats reads.
    plan_workers: int = 2
    #: default per-query wall budget in seconds (0 = unbounded), measured
    #: from ADMISSION — queue wait spends the budget, so an overloaded
    #: service sheds stale work instead of executing it late.
    default_deadline_s: float = 0.0
    #: per-tenant deadline overrides: {tenant: seconds}
    tenant_deadlines: dict = field(default_factory=dict)
    #: serve compatible parameterized plans through one batched dispatch
    batching: bool = True
    #: most queries coalesced into one batched dispatch (the port runs a
    #: batch as full rungs of the capacity ladder up to this count's
    #: bucket, so the knob also bounds the batched graphs' capacities)
    max_batch: int = 16
    #: after the first ready query is picked up, wait this long for more
    #: compatible arrivals before dispatching (0 = serve whatever is
    #: already queued; open-loop load keeps the queue nonempty by itself)
    batch_linger_ms: float = 0.0
    #: cross-client plan-cache entries (SQL text -> planned query); LRU
    plan_cache_entries: int = 512
    # -- self-healing (chaos-hardened serving; all off by default so a
    #    plain service behaves exactly as before) -------------------------
    #: per-error-class circuit breaker at admission: a failure class
    #: crossing its windowed rate trips, new submits fail typed
    #: CircuitOpen, half-open probes test recovery (None = disabled)
    breaker: Optional[CircuitBreakerConfig] = None
    #: service-lifetime budget of transient ticket failures re-dispatched
    #: off the device lane (requeued at the back of the ready queue)
    #: instead of failing the client; 0 disables
    retry_budget: int = 0
    #: dispatch attempts per ticket while the retry budget lasts
    ticket_attempts: int = 2
    #: device-lane watchdog: a serial dispatch exceeding this wall budget
    #: is ABANDONED mid-flight (fresh session locks swap in, the way
    #: power.py recovers from a deadline kill) and the ticket fails typed
    #: DeadlineExceeded while the lane serves its neighbors; 0 disables
    dispatch_timeout_s: float = 0.0
    #: strike shared compiled programs on batched-dispatch failures and
    #: evict them after executor.QUARANTINE_STRIKES (re-recorded fresh on
    #: next use instead of poisoning every adopter)
    quarantine: bool = True
    # -- weighted-fair scheduling + morsel-boundary preemption (all off
    #    by default: the plain service keeps the FIFO ready queue and
    #    never installs the session preemption hook — bit-identical to
    #    before these knobs existed) --------------------------------------
    #: replace the FIFO ready queue with per-tenant weighted-fair queues
    #: (virtual-time WFQ): each tenant accrues virtual time at
    #: cost/weight per second of device lane consumed, and the lane
    #: always serves the least-served active tenant next — a saturating
    #: batch tenant can no longer convoy an interactive tenant's queue
    fair_queue: bool = False
    #: relative service weights per tenant {tenant: weight}; unlisted
    #: tenants weigh 1.0 (higher weight = larger device-lane share)
    tenant_weights: dict = field(default_factory=dict)
    #: let streamed dispatches YIELD the device lane at morsel/scan-group
    #: boundaries: the session calls back into the service between scan
    #: groups, non-streamed ready tickets run right there on the lane
    #: thread (the stream's cached state resumes untouched — responses
    #: stay bit-identical to serial execution), then the scan continues
    preemption: bool = False
    #: most tickets served per yield point (bounds how long one morsel
    #: boundary can hold the stream)
    preempt_max: int = 2
    #: in-flight dedup at the planner stage: a ticket whose (fingerprint,
    #: params, catalog generation, snapshot version) matches an already-
    #: admitted in-flight ticket parks on that leader's shared result
    #: cell instead of re-entering the ready queue — the leader executes
    #: once, followers attach (service_inflight_dedup counts them)
    inflight_dedup: bool = False
    #: semantic result cache (the reference's engine/result_cache.py): not
    #: ported yet, anything but None raises NotImplementedError
    result_cache: Optional[object] = None
    #: live scrape endpoint (the reference's obs/scrape.py): not ported
    #: yet, anything but None raises NotImplementedError
    metrics_port: Optional[int] = None


class Ticket:
    """One submitted query's handle. The service hands the ticket through
    its stages (admission -> planner worker -> device lane); each stage is
    the ticket's sole owner while it holds it, and ``result()`` is the
    client-side rendezvous.

    The ticket is also the trace-context carrier: ``root`` is a detached
    ``service/ticket`` span opened at admission on the client thread and
    closed at completion on whichever thread finishes the ticket, and
    ``trace_id`` (= root span id, 0 when tracing is disabled) joins the
    ticket's :class:`ExecStats` to its span subtree in an export. Stage
    spans (queue/plan/lane_wait/dispatch/materialize) parent-link to it
    across the three thread hops."""

    def __init__(self, query: str, label: str, tenant: str,
                 deadline: Deadline, backend: Optional[str]):
        self.query = query
        self.label = label
        self.tenant = tenant
        self.deadline = deadline
        self.backend = backend
        self.submitted_at = time.perf_counter()
        #: wall between admission and execution start (ms); lands in stats
        self.queue_wait_ms: Optional[float] = None
        #: per-stage walls for the ticket's query-log row (obs/query_log)
        self.plan_ms: Optional[float] = None
        self.exec_ms: Optional[float] = None
        #: per-query ExecStats (queue_wait_ms/batched_with/trace_id incl.)
        self.stats: Optional[ExecStats] = None
        # trace context (set by the service at admission)
        self.root = None                    # detached service/ticket span
        self.trace_id: int = 0
        self._queue_span = None             # admission -> planner pickup
        self._wait_span = None              # planned -> execution start
        #: template identity for SLO labels: the parameterized-plan
        #: fingerprint when one exists (instantiations of one template
        #: collapse), else the stable query label
        self.template: Optional[str] = None
        # planner-stage products
        self.plan = None
        self.fp: Optional[str] = None
        self.pvalues: tuple = ()
        #: the device backend ("torch"), not the host oracle ("numpy")
        self.use_device = True
        #: the class of the batched dispatch that failed for this ticket
        #: (it was then served serially), or None
        self.batch_error: Optional[str] = None
        #: planner verdict: the plan takes the streamed morsel path —
        #: streamed tickets are never chosen as preemptors (they would
        #: hold the lane for a whole scan at the yield point) and carry
        #: the yield points themselves
        self.streams = False
        #: tickets served at THIS dispatch's morsel-boundary yield points
        #: (nonzero only for streamed dispatches under preemption; lands
        #: in the ticket's query-log row)
        self.preempted = 0
        #: in-flight dedup: the leader's registry key while it owns one,
        #: and the follower tickets parked on its result cell
        self._dedup_key = None
        self._dedup_followers: list = []
        #: serial dispatch attempts (the retry budget requeues transient
        #: failures until this reaches ServiceConfig.ticket_attempts)
        self.attempts = 0
        #: error-class name this ticket probes for a half-open breaker
        self._probe: Optional[str] = None
        self._done = threading.Event()
        self._result = None
        self._materialize = None
        self._mat_lock = threading.Lock()
        self._error: Optional[BaseException] = None

    # -- stage transitions (methods so stage loops stay lint-clean:
    #    single-owner handoff, no shared-state writes in thread targets) --
    def set_planned(self, plan, fp, pvalues, use_device,
                    streams: bool = False) -> None:
        self.plan = plan
        self.fp = fp
        self.pvalues = tuple(pvalues)
        self.use_device = use_device
        self.streams = streams
        self.template = fp[:12] if fp else self.label

    def picked_up(self) -> None:
        """A planner worker took the ticket: the admission-queue span
        ends here (single-owner handoff, so no lock needed)."""
        if self._queue_span is not None:
            self._queue_span.end()
            self._queue_span = None

    def begin_wait(self) -> None:
        """Planned; now waiting for the device lane (span ends at
        mark_started / expiry)."""
        self._wait_span = TRACER.span(
            "service/lane_wait", cat="service", parent=self.trace_id,
            label=self.label).begin()

    def mark_started(self) -> float:
        """Execution starts now: record + return the queue wait (ms)."""
        if self._wait_span is not None:
            self._wait_span.end()
            self._wait_span = None
        self.queue_wait_ms = round(
            (time.perf_counter() - self.submitted_at) * 1000.0, 3)
        _observe_phase("service_queue_wait_ms", self.queue_wait_ms,
                       self.tenant, self.template)
        return self.queue_wait_ms

    def close_stage_spans(self, error: Optional[str] = None) -> None:
        """End any stage span still open (expiry/failure can strike while
        queued or while waiting for the lane)."""
        for name in ("_queue_span", "_wait_span"):
            sp = getattr(self, name)
            if sp is not None:
                sp.end(error=error)
                setattr(self, name, None)

    def finish(self, result, stats: Optional[ExecStats],
               materialize=None) -> None:
        """materialize: optional deferred host-side conversion applied in
        result() on the CLIENT's thread — the device lane hands out raw
        per-row outputs and N clients materialize their Tables in
        parallel instead of serializing that work behind the lane."""
        self._result = result
        self._materialize = materialize
        self.stats = stats
        self._done.set()

    def fail(self, error: BaseException) -> None:
        self._error = error
        self._done.set()

    # -- client side ---------------------------------------------------------
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until the query finishes; returns its Table or raises the
        typed failure (AdmissionRejected subclasses are raised by submit()
        itself — here land DeadlineExceeded, parse/plan/execution errors).
        Tables are READ-ONLY: parameter-identical queries served by one
        batched row share the same materialized object."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"query {self.label!r} not finished within {timeout}s")
        if self._error is not None:
            raise self._error
        with self._mat_lock:
            if self._materialize is not None:
                t0 = time.perf_counter()
                with TRACER.span("service/materialize", cat="service",
                                 parent=self.trace_id, label=self.label):
                    self._result = self._materialize(self._result)
                self._materialize = None
                _observe_phase(
                    "service_materialize_ms",
                    (time.perf_counter() - t0) * 1000.0,
                    self.tenant, self.template)
        return self._result


class _PlannedQuery:
    """Cross-client plan-cache entry for one SQL text."""
    __slots__ = ("plan", "fp", "pvalues", "streams")

    def __init__(self, plan, fp, pvalues, streams):
        self.plan = plan
        self.fp = fp
        self.pvalues = tuple(pvalues)
        self.streams = streams


class _FairReadyQueue:
    """Per-tenant weighted-fair ready queue (virtual-time WFQ).

    Each tenant keeps a FIFO of its own tickets plus a virtual time that
    advances by ``cost / weight`` whenever the device lane charges it
    (``charge``); ``popleft`` always serves the head of the least-served
    active tenant, ties broken by activation order — so a tenant with
    weight 2 earns twice the lane share of a weight-1 tenant, and an
    interactive tenant that shows up mid-saturation is served after at
    most one in-flight dispatch instead of behind the whole backlog.

    A tenant REACTIVATING after idle resumes at the current virtual
    floor, never below it: sleeping earns no credit (no post-idle burst)
    and costs none (no starvation).

    Deque-compatible surface (append/popleft/clear/len/iter/bool): every
    existing consumer of the FIFO ready deque — the lane drain, requeue,
    close()'s drop sweep, the metrics-gate depth probe — works unchanged.
    All methods are called under the service's ``_cv`` lock."""

    def __init__(self, weights: Optional[dict] = None):
        self._weights = dict(weights or {})
        self._queues: "OrderedDict[str, deque]" = OrderedDict()
        self._vtime: dict = {}        # tenant -> accrued virtual time
        self._floor = 0.0             # vtime of the last tenant served

    def _weight(self, tenant: str) -> float:
        try:
            w = float(self._weights.get(tenant, 1.0))
        except (TypeError, ValueError):
            w = 1.0
        return w if w > 0 else 1e-6

    def append(self, ticket) -> None:
        q = self._queues.get(ticket.tenant)
        if q is None:
            q = self._queues[ticket.tenant] = deque()
        if not q:
            # (re)activation: join at the floor, keeping whatever debt
            # the tenant already accrued above it
            self._vtime[ticket.tenant] = max(
                self._vtime.get(ticket.tenant, 0.0), self._floor)
        q.append(ticket)

    def _pick(self) -> Optional[str]:
        best, best_v = None, None
        for tenant, q in self._queues.items():
            if not q:
                continue
            v = self._vtime.get(tenant, 0.0)
            if best is None or v < best_v:
                best, best_v = tenant, v
        return best

    def popleft(self):
        tenant = self._pick()
        if tenant is None:
            raise IndexError("pop from an empty ready queue")
        return self._take(tenant, 0)

    def pop_preemptable(self):
        """First NON-STREAMED ticket in fair order, or None: the yield
        point serves short in-core tickets only — a streamed preemptor
        would hold the paused stream for a whole scan."""
        for tenant in sorted(self._queues,
                             key=lambda t: self._vtime.get(t, 0.0)):
            for i, ticket in enumerate(self._queues[tenant]):
                if not ticket.streams:
                    return self._take(tenant, i)
        return None

    def _take(self, tenant: str, i: int):
        q = self._queues[tenant]
        ticket = q[i]
        del q[i]
        if not q:
            del self._queues[tenant]
        self._floor = max(self._floor, self._vtime.get(tenant, 0.0))
        return ticket

    def charge(self, tenant: str, cost_s: float) -> None:
        """Account ``cost_s`` seconds of device lane to ``tenant``."""
        self._vtime[tenant] = (self._vtime.get(tenant, 0.0)
                               + max(0.0, cost_s) / self._weight(tenant))

    def clear(self) -> None:
        self._queues.clear()

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def __bool__(self) -> bool:
        return any(self._queues.values())

    def __iter__(self):
        for q in self._queues.values():
            yield from q


class QueryService:
    """Long-lived async query service over one shared Session.

    Usage::

        svc = QueryService(session)           # or ServiceConfig(...)
        with svc:                             # start()/close()
            t = svc.submit("SELECT ...", tenant="dash", label="q1")
            table = t.result()
            # or synchronously:
            table = svc.sql("SELECT ...")

    Registrations should be quiesced while the service is running (the
    catalog generation invalidates caches correctly, but a registration
    racing an in-flight plan can produce a stale-plan failure the client
    must retry)."""

    def __init__(self, session, config: Optional[ServiceConfig] = None):
        self.session = session
        self.config = config or ServiceConfig()
        self._cv = threading.Condition()
        self._intake: deque = deque()     # admitted, awaiting planning
        # planned, awaiting the device lane: FIFO deque by default;
        # fair_queue swaps in the per-tenant weighted-fair queue (same
        # surface — every drain/requeue/probe site works on either)
        self._ready = _FairReadyQueue(self.config.tenant_weights) \
            if self.config.fair_queue else deque()
        self._pending = 0                 # admitted but unfinished
        #: in-flight dedup registry: dedup key -> leader ticket
        self._inflight: dict = {}
        #: tickets served at yield points since the CURRENT outer
        #: streamed dispatch began (single-writer: the thread running
        #: the outer dispatch is the thread its yield points run on)
        self._preempt_served = 0
        self._plan_cache: "OrderedDict" = OrderedDict()
        self._plan_cache_key = None       # config/generation fingerprint
        self._hold = False                # test/drain hook: park the lane
        self._running = False
        self._threads: list[threading.Thread] = []
        cfg = self.config
        self._breaker = CircuitBreaker(cfg.breaker) \
            if cfg.breaker is not None else None
        self._retry_budget_left = max(0, cfg.retry_budget)
        self._retry_policy = RetryPolicy()   # classification only
        if cfg.result_cache is not None:
            raise NotImplementedError(
                "the semantic result cache (engine/result_cache.py) is not "
                "ported yet: ROADMAP A.3's remainder, item 1")
        if cfg.metrics_port is not None:
            raise NotImplementedError(
                "the metrics scrape endpoint (obs/scrape.py) is not ported "
                "yet: ROADMAP A.3's remainder, item 2")

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "QueryService":
        with self._cv:
            if self._running:
                return self
            self._running = True
        n = max(1, self.config.plan_workers)
        self._threads = [
            threading.Thread(target=self._plan_worker, daemon=True,
                             name=f"svc-planner-{i}") for i in range(n)
        ] + [threading.Thread(target=self._device_loop, daemon=True,
                              name="svc-device-lane")]
        for t in self._threads:
            t.start()
        if self.config.preemption:
            # the streamed path's morsel-boundary yield points call back
            # into this service (Session._maybe_preempt); installing the
            # hook is what arms them — no hook, no behavior change
            self.session._preempt_hook = self._preempt_tick
        return self

    def close(self, drain: bool = True) -> None:
        """Stop the service. drain=True (default) finishes admitted work
        first; drain=False fails queued-but-unstarted tickets typed."""
        with self._cv:
            if not self._running:
                return
            if drain:
                while self._pending > 0:
                    self._cv.wait(0.05)
            self._running = False
            dropped = list(self._intake) + list(self._ready)
            self._intake.clear()
            self._ready.clear()
            self._cv.notify_all()
        for t in dropped:
            self._finish_ticket(t, error=ServiceClosed(
                f"service closed before {t.label!r} executed"))
        for t in self._threads:
            t.join(timeout=10)
        self._threads = []
        if self.session._preempt_hook == self._preempt_tick:
            self.session._preempt_hook = None

    def __enter__(self) -> "QueryService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close(drain=not any(exc))

    @contextlib.contextmanager
    def hold_dispatch(self):
        """Park the device lane (planning continues): deterministic batch
        accumulation for tests and drain windows."""
        with self._cv:
            self._hold = True
        try:
            yield
        finally:
            with self._cv:
                self._hold = False
                self._cv.notify_all()

    # -- admission -----------------------------------------------------------
    def submit(self, query: str, label: Optional[str] = None,
               tenant: str = "default",
               deadline_s: Optional[float] = None,
               backend: Optional[str] = None) -> Ticket:
        """Admit one query; returns its Ticket immediately.

        Raises AdmissionRejected (typed, with depth/limit) when the bounded
        pending set is full or the service is closed — overload is an
        immediate, classifiable signal, never a silent pile-up. The
        query's deadline (explicit > tenant override > default) starts
        NOW: queue wait spends it."""
        cfg = self.config
        if deadline_s is None:
            deadline_s = cfg.tenant_deadlines.get(
                tenant, cfg.default_deadline_s)
        ticket = Ticket(query, label or self._auto_label(query), tenant,
                        Deadline(deadline_s), backend)
        if "system." in query or "SYSTEM." in query:
            # system.* statements (obs/system_tables.py) are not ported:
            # raises NotImplementedError when the statement reads them
            self.session._maybe_system_query(query)
        if self._breaker is not None:
            # breaker gate BEFORE the pending set: a tripped class sheds
            # load at the door (typed, fatal-until-probe) so the queue
            # holds work that can actually succeed
            try:
                ticket._probe = self._breaker.admit(label=ticket.label)
            except CircuitOpen as e:
                _metrics.SERVICE_REJECTED.inc()
                FLIGHT.record("reject", label=ticket.label, tenant=tenant,
                              reason="circuit_open",
                              error_class=e.error_class)
                raise
        with self._cv:
            if not self._running:
                _metrics.SERVICE_REJECTED.inc()
                FLIGHT.record("reject", label=ticket.label, tenant=tenant,
                              reason="closed")
                if self._breaker is not None:
                    self._breaker.release(ticket._probe)
                raise ServiceClosed("query service is not running")
            if self._pending >= cfg.max_pending:
                _metrics.SERVICE_REJECTED.inc()
                FLIGHT.record("reject", label=ticket.label, tenant=tenant,
                              reason="queue_full", depth=self._pending,
                              limit=cfg.max_pending)
                if self._breaker is not None:
                    self._breaker.release(ticket._probe)
                raise AdmissionRejected(
                    f"admission queue full: {self._pending} pending >= "
                    f"max_pending {cfg.max_pending}",
                    depth=self._pending, limit=cfg.max_pending)
            self._pending += 1
            depth = self._pending
            _metrics.SERVICE_ADMITTED.inc()
            _metrics.SERVICE_QUEUE_DEPTH.set(self._pending)
            # the ticket's trace context: a detached root span the three
            # downstream thread hops (planner worker, device lane, client
            # materialization) parent-link their stage spans to
            ticket.root = TRACER.span("service/ticket", cat="service",
                                      label=ticket.label,
                                      tenant=tenant).begin()
            ticket.trace_id = ticket.root.sid
            ticket._queue_span = TRACER.span(
                "service/queue", cat="service", parent=ticket.trace_id,
                label=ticket.label).begin()
            self._intake.append(ticket)
            self._cv.notify_all()
        FLIGHT.record("admit", label=ticket.label, tenant=tenant,
                      depth=depth, trace_id=ticket.trace_id or None)
        return ticket

    def sql(self, query: str, label: Optional[str] = None,
            tenant: str = "default", deadline_s: Optional[float] = None,
            backend: Optional[str] = None,
            timeout: Optional[float] = None):
        """Synchronous convenience: submit + result."""
        return self.submit(query, label=label, tenant=tenant,
                           deadline_s=deadline_s,
                           backend=backend).result(timeout)

    def explain_analyze(self, query: str, label: Optional[str] = None,
                        backend: Optional[str] = None):
        """Live EXPLAIN ANALYZE: the port has no plan profiles yet."""
        raise NotImplementedError(
            "EXPLAIN ANALYZE (obs/profile.py's PlanProfile) is not ported "
            "yet: ROADMAP A.5")

    @staticmethod
    def _auto_label(query: str) -> str:
        import hashlib
        return "q" + hashlib.sha1(query.encode()).hexdigest()[:8]

    # -- planner stage -------------------------------------------------------
    def _plan_worker(self) -> None:
        while True:
            with self._cv:
                while self._running and not self._intake:
                    self._cv.wait(0.1)
                if not self._running:
                    return
                ticket = self._intake.popleft()
            ticket.picked_up()
            if self._expire_if_late(ticket, "queued"):
                continue
            t0 = time.perf_counter()
            try:
                # hop 1 (client thread -> planner worker): parent-linked
                # through the ticket's root span id
                with TRACER.span("service/plan", cat="service",
                                 parent=ticket.trace_id,
                                 label=ticket.label):
                    self._plan_ticket(ticket)
            except Exception as e:
                self._finish_ticket(ticket, error=e)
                continue
            plan_ms = (time.perf_counter() - t0) * 1000.0
            ticket.plan_ms = round(plan_ms, 3)
            _observe_phase("service_plan_ms", plan_ms, ticket.tenant,
                           ticket.template)
            FLIGHT.record("plan", label=ticket.label, tenant=ticket.tenant,
                          template=ticket.template,
                          ms=round(plan_ms, 3), batchable=bool(ticket.fp))
            if self.config.inflight_dedup and ticket.fp is not None \
                    and self._attach_inflight(ticket):
                continue
            ticket.begin_wait()
            with self._cv:
                self._ready.append(ticket)
                self._cv.notify_all()

    def _attach_inflight(self, ticket: Ticket) -> bool:
        """In-flight dedup: park ``ticket`` on an already-admitted
        in-flight leader computing the identical result. The key is the
        full result identity — parameterized-plan fingerprint, parameter
        vector, backend, catalog generation, warehouse snapshot — so a
        registration or commit between the two admissions makes distinct
        keys (never a stale share). Returns True when parked (the ticket
        must not enter the ready queue); the leader's ``_finish_ticket``
        drains followers on every terminal outcome."""
        session = self.session
        key = (ticket.fp, ticket.pvalues,
               "torch" if ticket.use_device else "numpy",
               session._generation, session._warehouse_version)
        with self._cv:
            leader = self._inflight.get(key)
            if leader is not None and not leader.done():
                leader._dedup_followers.append(ticket)
            else:
                self._inflight[key] = ticket
                ticket._dedup_key = key
                return False
        _metrics.SERVICE_INFLIGHT_DEDUP.inc()
        FLIGHT.record("dedup", label=ticket.label, tenant=ticket.tenant,
                      leader=leader.label, template=ticket.template)
        return True

    def _plan_ticket(self, ticket: Ticket) -> None:
        """Parse/plan/parameterize one query via the cross-client plan
        cache. Runs on planner threads: touches only the session's
        lock-protected read surfaces (catalog schemas, column stats) and
        no CUDA call (the device lane may be capturing)."""
        from ..sql import parse_sql
        from ..engine.planner import Planner
        from ..engine import streaming
        from ..engine.torch_backend import cuda_kernels as _ck
        from ..engine.torch_backend.compiled import shared_fingerprint
        from ..engine.plan import parameterize_plan

        session = self.session
        cfg = session.config
        use_device = (ticket.backend or "torch") != "numpy"
        cache_key = session._stream_config_key()
        with self._cv:
            if self._plan_cache_key != cache_key:
                self._plan_cache.clear()
                self._plan_cache_key = cache_key
            entry = self._plan_cache.get(ticket.query)
            if entry is not None:
                self._plan_cache.move_to_end(ticket.query)
        if entry is None:
            # label passed EXPLICITLY: planner threads run outside the
            # session's statement lock, so _active_label belongs to
            # whatever statement the device lane is executing (the
            # reference's adaptive catalog scopes observed rows by it)
            plan = Planner(session._catalog(ticket.label or "")).plan_query(
                parse_sql(ticket.query))
            streams = False
            if use_device and cfg.out_of_core:
                jobs = streaming.find_streaming_jobs(
                    plan,
                    lambda t: session._est_rows_for(t, 0,
                                                    ticket.label or ""),
                    cfg.out_of_core_min_rows)
                streams = bool(jobs)
            fp = None
            pvalues: tuple = ()
            if use_device and not streams and cfg.jit_plans:
                # the batching identity: two texts whose parameterized
                # plans share this fingerprint differ only in hoisted
                # literal VALUES — one compiled program serves both (an
                # in-core plan has no packed scan: no layout in the key)
                pplan, pvals, pdts = parameterize_plan(plan)
                if pdts:
                    fp = shared_fingerprint(
                        pplan, _ck.parse_ops(cfg.gpu_kernels))
                    pvalues = tuple(pvals)
            entry = _PlannedQuery(plan, fp, pvalues, streams)
            with self._cv:
                self._plan_cache[ticket.query] = entry
                while len(self._plan_cache) > self.config.plan_cache_entries:
                    self._plan_cache.popitem(last=False)
        ticket.set_planned(entry.plan, None if entry.streams else entry.fp,
                           entry.pvalues, use_device, streams=entry.streams)

    # -- device lane ---------------------------------------------------------
    def _device_loop(self) -> None:
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            if not batch:
                continue
            try:
                self._serve(batch)
            except BaseException as e:  # the lane outlives any failure
                for t in batch:
                    if not t.done():
                        self._finish_ticket(t, error=e)
                if isinstance(e, (KeyboardInterrupt, SystemExit)):
                    raise

    def _next_batch(self) -> Optional[list]:
        cfg = self.config
        with self._cv:
            while self._running and (self._hold or not self._ready):
                self._cv.wait(0.05)
            if not self._running:
                return None
        if cfg.batch_linger_ms > 0:
            time.sleep(cfg.batch_linger_ms / 1000.0)
        with self._cv:
            out = []
            while self._ready and len(out) < max(1, cfg.max_batch):
                out.append(self._ready.popleft())
            return out

    def _serve(self, batch: list) -> None:
        """Execute one drained window: expire late tickets, coalesce
        compatible parameterized plans into batched dispatches, serve the
        rest serially in arrival order."""
        live = []
        for t in batch:
            if not self._expire_if_late(t, "waiting for the device lane"):
                live.append(t)
        groups: "OrderedDict[str, list]" = OrderedDict()
        serial: list = []
        for t in live:
            if self.config.batching and t.fp is not None and t.use_device:
                groups.setdefault(t.fp, []).append(t)
            else:
                serial.append(t)
        for fp, members in groups.items():
            if len(members) < 2:
                serial.extend(members)
                continue
            if not self._serve_batched(fp, members):
                serial.extend(members)
        for t in serial:
            self._serve_serial(t)

    def _charge_tenant(self, tenant: str, cost_s: float) -> None:
        """Account one dispatch's device-lane wall to its tenant's
        weighted-fair virtual time (no-op under the FIFO queue)."""
        if not self.config.fair_queue:
            return
        with self._cv:
            self._ready.charge(tenant, cost_s)

    def _preempt_tick(self) -> None:
        """One morsel-boundary yield point (Session._maybe_preempt calls
        here between scan groups / morsels, ON the thread that holds the
        session's statement lock mid-stream): serve up to ``preempt_max``
        non-streamed ready tickets right now, then let the stream resume
        its cached state. Each nested dispatch runs inside
        ``session.preempt_scope()`` — statement-scoped session state is
        saved/restored and the RLock re-entry on this same thread is what
        makes the nested statement legal — and never under the lane
        watchdog (``run_with_deadline`` would move the dispatch to a
        thread that cannot re-enter this thread's RLock)."""
        served = 0
        while served < max(1, self.config.preempt_max):
            with self._cv:
                if not self._running or self._hold:
                    return
                ticket = self._pop_preemptable_locked()
            if ticket is None:
                return
            if self._expire_if_late(ticket, "preempting"):
                continue
            _metrics.SERVICE_PREEMPTIONS.inc()
            FLIGHT.record("preempt", label=ticket.label,
                          tenant=ticket.tenant, template=ticket.template)
            with self.session.preempt_scope():
                self._serve_serial(ticket, preempted=True)
            self._preempt_served += 1
            served += 1

    def _pop_preemptable_locked(self):
        """First non-streamed ready ticket (fair order under the WFQ,
        arrival order under the FIFO deque), or None. Caller holds _cv."""
        ready = self._ready
        if hasattr(ready, "pop_preemptable"):
            return ready.pop_preemptable()
        for ticket in ready:
            if not ticket.streams:
                ready.remove(ticket)
                return ticket
        return None

    def _serve_batched(self, fp: str, members: list) -> bool:
        """One compiled program over the group's stacked parameter vectors;
        parameter-identical members deduplicate to one row. Returns False
        when batching is unavailable/drifted — the caller serves the group
        serially (which also records/compiles the shared program the NEXT
        batch of this template will ride)."""
        from ..engine.torch_backend.compiled import (absolve_shared_program,
                                                     strike_shared_program)
        from ..engine.torch_backend.device import to_host

        session = self.session
        rows: list[tuple] = []
        index: dict[tuple, int] = {}
        member_rows = []
        for t in members:
            i = index.get(t.pvalues)
            if i is None:
                i = index[t.pvalues] = len(rows)
                rows.append(t.pvalues)
            member_rows.append(i)
        waits = [t.mark_started() for t in members]
        dedup = len(members) - len(rows)
        # hop 2 (planner worker -> device lane): every member gets its own
        # dispatch span covering the shared batched dispatch, parent-linked
        # to ITS ticket root and annotated with the batch composition —
        # one Chrome-trace export shows who co-rode which dispatch
        dspans = [TRACER.span("service/dispatch", cat="service",
                              parent=t.trace_id, label=t.label,
                              batch_leader=members[0].label,
                              batched_with=len(members) - 1,
                              batch_rows=len(rows), dedup=dedup).begin()
                  for t in members]
        t0 = time.perf_counter()
        with session._sql_lock:
            ex = session._executor()
            try:
                with ex.on_stream():
                    outs = ex.run_param_batch(fp, rows)
            except Exception as e:
                # schedule drift (ReplayMismatch), trace failure, transient
                # runtime error: the serial path both surfaces any genuine
                # per-query failure and repairs the shared entry
                outs = None
                batch_error = type(e).__name__
            else:
                batch_error = None if outs is not None else "unavailable"
            if outs is None:
                if batch_error != "unavailable" and self.config.quarantine:
                    # a genuine failure THROUGH the shared program is a
                    # quarantine strike: the same entry failing repeatedly
                    # is evicted (shared + this session's local copy) so
                    # the next sighting re-records fresh instead of every
                    # adopter replaying the poison
                    if strike_shared_program(fp, reason=batch_error):
                        ex.evict_fp(fp)
                for t, sp in zip(members, dspans):
                    sp.end(error=batch_error)
                    t.queue_wait_ms = None   # serial path re-measures
                    t.batch_error = batch_error
                FLIGHT.record("retry", label=members[0].label,
                              queries=len(members), reason=batch_error,
                              via="serial_fallback")
                return False
            exec_stats = dict(ex.last_stats)
            if self.config.quarantine:
                absolve_shared_program(fp)
        exec_ms = (time.perf_counter() - t0) * 1000.0
        for t, sp in zip(members, dspans):
            sp.end()
            t.exec_ms = round(exec_ms, 3)
            _observe_phase("service_exec_ms", exec_ms, t.tenant, t.template)
            # fair accounting: the batch's wall splits evenly across its
            # members — each tenant pays for the share it rode
            self._charge_tenant(t.tenant, exec_ms / 1000.0 / len(members))
        device_ms = exec_stats.pop("device_ms", None)
        exec_stats.pop("mode", None)
        # the dispatch's own figures (batch rows, the capacities of its
        # rungs, and each rung's graph ms and, where it was captured, the
        # capture's seconds, pool growth and launches) ride every
        # member's stats
        exec_stats.update(batch_leader=members[0].label, dedup=dedup)
        with _metrics.METRICS.locked():
            # one logical event, three counters: the shared value lock
            # keeps any concurrent snapshot from seeing a batch counted
            # without its member queries (consistent bench deltas)
            _metrics.SERVICE_BATCHES.inc()
            _metrics.SERVICE_BATCHED_QUERIES.inc(len(members))
            _metrics.QUERIES_RUN.inc(len(members))
        FLIGHT.record("batch", leader=members[0].label,
                      queries=len(members), rows=len(rows), dedup=dedup,
                      ms=round(exec_ms, 3))
        cells: dict[int, tuple] = {}

        def shared_cell(ri, rep):
            # parameter-identical tickets share ONE materialized Table:
            # the row was computed once, so it converts once too (first
            # result() call wins, the rest reuse) — and conversion happens
            # on client threads, not behind the device lane
            if ri not in cells:
                cell = {"dt": outs[ri], "table": None,
                        "lock": threading.Lock()}

                def mat(_cell=cell):
                    with _cell["lock"]:
                        if _cell["table"] is None:
                            _cell["table"] = to_host(_cell["dt"])
                            _cell["dt"] = None
                    return _cell["table"]
                cells[ri] = (cell, mat)
            return cells[ri]

        for t, ri, wait in zip(members, member_rows, waits):
            _metrics.SERVICE_QUEUE_WAIT_MS.inc(wait)
            stats = ExecStats(mode="batched", device_ms=device_ms,
                              queue_wait_ms=wait,
                              batched_with=len(members) - 1,
                              trace_id=t.trace_id or None,
                              extra=dict(exec_stats))
            cell, mat = shared_cell(ri, t)
            self._finish_ticket(t, result=cell, stats=stats,
                                materialize=lambda _c, _m=mat: _m(_c))
        with session._sql_lock:
            # the shared observability view mirrors direct sql() behavior:
            # last_exec_stats describes the most recent completed dispatch
            last = ExecStats(mode="batched", device_ms=device_ms,
                             queue_wait_ms=waits[-1],
                             batched_with=len(members) - 1)
            # log=False: every member ticket cuts its own query-log row
            # at _finish_ticket — this shared last-dispatch view must not
            # add an unattributed duplicate
            session._finish_exec_stats(last, log=False)
            session.last_stats = last.to_dict()
        return True

    def _serve_serial(self, ticket: Ticket,
                      preempted: bool = False) -> None:
        """The normal Session path (record/adopt/replay, streaming,
        segmentation, host fallback) with the service's pre-built plan —
        result + per-query stats captured atomically. Self-healing rides
        here: a dispatch outliving the lane watchdog is abandoned (fresh
        session locks, the power.py recovery move) and fails typed while
        neighbors proceed; a transient failure inside the retry budget
        requeues off the lane instead of failing the client; repeated
        failures through a shared program strike it toward quarantine.

        preempted=True: this dispatch runs NESTED at another dispatch's
        morsel-boundary yield point (same thread, inside preempt_scope) —
        the lane watchdog is bypassed (its worker thread could not
        re-enter this thread's session RLock) and the preemption counter
        attribution belongs to the OUTER dispatch."""
        ticket.attempts += 1
        wait = ticket.mark_started()
        _metrics.SERVICE_QUEUE_WAIT_MS.inc(wait)
        if not preempted:
            # fresh attribution window: yield points fired during THIS
            # dispatch accumulate here (same-thread single-writer)
            self._preempt_served = 0
        t0 = time.perf_counter()
        try:
            # hop 2, serial lane: the session's own "query" span tree
            # nests under this one via the lane thread's span stack, so
            # the ticket root reaches down to parse/plan/morsel spans
            with TRACER.span("service/dispatch", cat="service",
                             parent=ticket.trace_id, label=ticket.label):
                table, stats = self._dispatch_serial(ticket, preempted)
        except Exception as e:
            self._charge_tenant(ticket.tenant, time.perf_counter() - t0)
            if not preempted:
                ticket.preempted = self._preempt_served
            if self.config.quarantine and ticket.fp is not None:
                from ..engine.torch_backend.compiled import \
                    strike_shared_program
                if strike_shared_program(ticket.fp,
                                         reason=type(e).__name__):
                    with self.session._sql_lock:
                        self.session._executor().evict_fp(ticket.fp)
            if self._maybe_requeue(ticket, e):
                return
            self._finish_ticket(ticket, error=e)
            return
        if self.config.quarantine and ticket.fp is not None:
            from ..engine.torch_backend.compiled import \
                absolve_shared_program
            absolve_shared_program(ticket.fp)
        exec_s = time.perf_counter() - t0
        ticket.exec_ms = round(exec_s * 1000.0, 3)
        _observe_phase("service_exec_ms", ticket.exec_ms,
                       ticket.tenant, ticket.template)
        self._charge_tenant(ticket.tenant, exec_s)
        if not preempted:
            ticket.preempted = self._preempt_served
        if stats is None:
            stats = ExecStats(mode="host")
        stats.queue_wait_ms = wait
        stats.trace_id = ticket.trace_id or None
        if ticket.batch_error is not None:
            stats.extra["batch_error"] = ticket.batch_error
        self._finish_ticket(ticket, result=table, stats=stats)

    def _dispatch_serial(self, ticket: Ticket, preempted: bool = False):
        """One serial session dispatch, optionally under the device-lane
        watchdog (ServiceConfig.dispatch_timeout_s): on overrun the stuck
        worker is ABANDONED, the session swaps in fresh statement locks
        (power.py's deadline-kill recovery), the trip is flight-dumped,
        and typed DeadlineExceeded propagates — the lane moves on instead
        of wedging every queued neighbor behind one hung dispatch.

        Preempted dispatches NEVER take the watchdog: run_with_deadline
        executes on a worker thread, and the session's statement RLock —
        already held by the paused stream on THIS thread — is not
        reentrant across threads; the nested dispatch must stay here."""
        cfg = self.config

        def run():
            return self.session.service_run(
                ticket.query, backend=ticket.backend,
                label=ticket.label, plan=ticket.plan)

        if preempted or cfg.dispatch_timeout_s <= 0:
            return run()
        try:
            return run_with_deadline(run, cfg.dispatch_timeout_s,
                                     label=f"dispatch:{ticket.label}")
        except DeadlineExceeded:
            self.session.abandon_inflight()
            FLIGHT.trip("lane_watchdog", label=ticket.label,
                        tenant=ticket.tenant,
                        budget_s=cfg.dispatch_timeout_s)
            raise

    def _maybe_requeue(self, ticket: Ticket, error: BaseException) -> bool:
        """Transient-failure re-dispatch off the device lane: requeue the
        ticket at the back of the ready queue (no lane-blocking backoff)
        while the per-ticket attempt cap, the service-lifetime retry
        budget, and the ticket's own deadline all have room. Fatal classes
        (DeadlineExceeded, CircuitOpen — see the resilience classification
        table) never requeue."""
        cfg = self.config
        if cfg.retry_budget <= 0 or ticket.attempts >= cfg.ticket_attempts:
            return False
        if self._retry_policy.classify(error) != "transient":
            return False
        if ticket.deadline.expired():
            return False
        with self._cv:
            if not self._running or self._retry_budget_left <= 0:
                return False
            self._retry_budget_left -= 1
        _metrics.RETRY_BUDGET_SPENT.inc()
        FLIGHT.record("retry", label=ticket.label, tenant=ticket.tenant,
                      error=type(error).__name__, attempt=ticket.attempts,
                      via="requeue")
        ticket.queue_wait_ms = None   # the retried dispatch re-measures
        ticket.begin_wait()
        with self._cv:
            self._ready.append(ticket)
            self._cv.notify_all()
        return True

    # -- shared bookkeeping --------------------------------------------------
    def _expire_if_late(self, ticket: Ticket, where: str) -> bool:
        if not ticket.deadline.expired():
            return False
        _metrics.SERVICE_DEADLINE_EXPIRED.inc()
        FLIGHT.record("expire", label=ticket.label, tenant=ticket.tenant,
                      where=where, budget_s=ticket.deadline.seconds)
        self._finish_ticket(ticket, error=DeadlineExceeded(
            f"query {ticket.label!r} ({ticket.tenant}) exceeded its "
            f"{ticket.deadline.seconds}s budget while {where}"))
        return True

    def _finish_ticket(self, ticket: Ticket, result=None,
                       stats: Optional[ExecStats] = None,
                       error: Optional[BaseException] = None,
                       materialize=None) -> None:
        followers = None
        if ticket._dedup_key is not None:
            # release the in-flight leadership and take the follower list
            # atomically: a racing _attach_inflight either saw the leader
            # undone (parked here, drained below) or finds the registry
            # slot free and becomes the next leader
            with self._cv:
                self._inflight.pop(ticket._dedup_key, None)
                ticket._dedup_key = None
                followers = ticket._dedup_followers
                ticket._dedup_followers = []
        err_name = type(error).__name__ if error is not None else None
        ticket.close_stage_spans(error=err_name)
        latency_ms = round(
            (time.perf_counter() - ticket.submitted_at) * 1000.0, 3)
        from ..obs.query_log import QUERY_LOG
        if QUERY_LOG.enabled:
            # the ticket's durable query-log row: the service path logs
            # with full context (tenant/template/phase walls/error class)
            # — the session's own append is suppressed for service
            # statements, so this is the one row per ticket
            QUERY_LOG.record(
                stats, source="service", label=ticket.label,
                tenant=ticket.tenant, template=ticket.template,
                trace_id=ticket.trace_id or None, wall_ms=latency_ms,
                queue_ms=ticket.queue_wait_ms, plan_ms=ticket.plan_ms,
                exec_ms=ticket.exec_ms, status=err_name,
                error=error, preempted=ticket.preempted,
                rows=getattr(result, "num_rows", None))
        if error is not None:
            ticket.fail(error)
            FLIGHT.record("error", label=ticket.label,
                          tenant=ticket.tenant, error=err_name,
                          latency_ms=latency_ms)
        else:
            ticket.finish(result, stats, materialize=materialize)
            # the SLO distribution: admission -> completion (deferred
            # client-side materialization is measured separately)
            _observe_phase("service_latency_ms", latency_ms,
                           ticket.tenant, ticket.template)
            FLIGHT.record("complete", label=ticket.label,
                          tenant=ticket.tenant, template=ticket.template,
                          latency_ms=latency_ms,
                          queue_wait_ms=ticket.queue_wait_ms,
                          batched_with=stats.batched_with
                          if stats else None,
                          trace_id=ticket.trace_id or None)
        if ticket.root is not None:
            ticket.root.set(latency_ms=latency_ms)
            ticket.root.end(error=err_name)
            ticket.root = None
        if self._breaker is not None:
            # every terminal outcome teaches the breaker (probe slots are
            # released here too); requeued tickets report only their
            # final disposition
            self._breaker.record(err_name, probe=ticket._probe,
                                 label=ticket.label)
            ticket._probe = None
        with self._cv:
            self._pending -= 1
            _metrics.SERVICE_QUEUE_DEPTH.set(self._pending)
            self._cv.notify_all()
        if followers:
            # drain the parked followers on the leader's terminal
            # outcome: shared result cell (the batched-ticket contract —
            # read-only Table, one deferred materialization) or the same
            # typed error; a follower whose own deadline lapsed while
            # parked fails on ITS budget, not the leader's result
            for f in followers:
                if self._expire_if_late(f, "deduped on an in-flight "
                                           "leader"):
                    continue
                if error is not None:
                    self._finish_ticket(f, error=error)
                else:
                    fwait = f.mark_started()
                    _metrics.SERVICE_QUEUE_WAIT_MS.inc(fwait)
                    fstats = ExecStats(mode="deduped", queue_wait_ms=fwait,
                                       trace_id=f.trace_id or None)
                    self._finish_ticket(f, result=result, stats=fstats,
                                        materialize=materialize)
