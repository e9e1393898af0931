"""The port's query service, part 3 of 3: its batched program
(compiled.BatchedQuery) and the quarantine, the service's opt-in knobs
(watchdog, in-flight dedup, weighted-fair queue, preemption), the features
not ported yet, and the copied observability and resilience modules.

BatchedQuery's rows must equal the single program's runs bit for bit
(the same replay, row by row), pad a short batch, and raise ReplayMismatch
on a row that drifts past the schedule; the service then serves the batch
serially and says why. The histogram and registry cases of
tests/test_obs_service.py and a few cases of tests/test_resilience.py run
against the reference's modules and the port's copies alike."""
import threading
import time

import numpy as np
import pytest

import nds_tpu.obs.metrics as rmetrics
import nds_tpu.resilience as rres
import nds_tpu_torch.obs.metrics as pmetrics
import nds_tpu_torch.resilience as pres
from nds_tpu_torch.engine.plan import parameterize_plan
from nds_tpu_torch.engine.torch_backend import compiled
from nds_tpu_torch.engine.torch_backend.device import to_host
from nds_tpu_torch.obs.flight import FLIGHT
from nds_tpu_torch.service import QueryService, ServiceConfig
from torch_isolation import isolate_port_programs  # noqa: F401
from torch_service_cases import (PORT, REF, held_batch, make_data,
                                 make_session, q1, same, wait_ready, warm)


@pytest.fixture(scope="module")
def data():
    return make_data()


def fingerprint(session, sql: str):
    """(the service's batching fingerprint, the hoisted values) of sql."""
    pplan, values, _ = parameterize_plan(session.plan(sql))
    return (compiled.shared_fingerprint(pplan, session._executor().gpu_ops),
            tuple(values))


def warmed(data, sql: str):
    session = make_session(PORT, data)
    session.sql(sql)
    session.sql(sql)
    assert session.last_stats["mode"] == "compile+run"
    return session


# -- BatchedQuery -------------------------------------------------------------

def test_batched_rows_equal_single_program_runs(data):
    session = warmed(data, q1(5, 60))
    fp, _ = fingerprint(session, q1(5, 60))
    params = [(5, 60), (6, 61), (7, 62)]
    rows = [fingerprint(session, q1(a, b))[1] for a, b in params]
    ex = session._executor()
    outs = ex.run_param_batch(fp, rows)
    assert ex.last_stats["mode"] == "batched"
    # three rows ride the ladder's full rungs, two and one: no padding
    assert (ex.last_stats["batch_rows"],
            ex.last_stats["batch_caps"]) == (3, (2, 1))
    assert [g["cap"] for g in ex.last_stats["graphs"]] == [2, 1]
    assert len(outs) == 3
    cq = ex._plans[("sql", q1(5, 60))]["cq"]
    scans = ex._scans_for({"scan_keys": cq.scan_keys})
    ref = make_session(REF, data)
    for (a, b), row, out in zip(params, rows, outs):
        single = to_host(cq.run(scans, row))
        assert to_host(out).to_pylist() == single.to_pylist()
        same(to_host(out), ref.sql(q1(a, b)))
    # BatchedQuery itself pads a short batch with its last row (the
    # reference's padding) and returns one table per given row
    stats: dict = {}
    padded = compiled.BatchedQuery(cq, 4).run(scans, rows, stats=stats)
    assert len(padded) == 3 and stats["batch"] == 3
    assert [to_host(t).to_pylist() for t in padded] == \
        [to_host(t).to_pylist() for t in outs]
    # a warm batch of the same capacities makes no new program
    bqs = [ex._batched[(fp, c)] for c in (2, 1)]
    ex.run_param_batch(fp, rows[:2] + rows[:1])
    assert [ex._batched[(fp, c)] for c in (2, 1)] == bqs
    assert not any(bq._first for bq in bqs)


@pytest.mark.parametrize("n,rungs", [
    (1, [1]), (2, [2]), (3, [2, 1]), (5, [4, 1]), (7, [4, 2, 1]),
    (15, [8, 4, 2, 1]), (16, [16]),
    # above CAP_LADDER_MIN rows the ladder has 3 * 2^(k-1) midpoints
    (6 << 20, [6 << 20]), ((7 << 20) + 1, [6 << 20, 1 << 20, 1])])
def test_batch_rungs_cover_the_rows_with_ladder_rungs(n, rungs):
    from nds_tpu_torch.engine.torch_backend.device import bucket
    got = compiled.batch_rungs(n)
    assert got == rungs and sum(got) == n
    assert all(bucket(r, minimum=1) == r for r in got)


def test_a_batch_runs_over_its_own_executors_program(data):
    """Programs are owner-bound (a captured graph reads its executor's
    scans): where the published program is another session's, the batch
    builds its own from the shared schedule, as adoption does."""
    a = warmed(data, q1(5, 60))
    b = make_session(PORT, data)
    fp, _ = fingerprint(b, q1(5, 60))
    rows = [fingerprint(b, q1(6 + i, 61 + i))[1] for i in range(2)]
    ex = b._executor()
    outs = ex.run_param_batch(fp, rows)
    bq = ex._batched[(fp, 2)]
    assert bq.cq.owner is ex
    assert bq.cq is not a._executor()._plans[("sql", q1(5, 60))]["cq"]
    ref = make_session(REF, data)
    for i, out in enumerate(outs):
        same(to_host(out), ref.sql(q1(6 + i, 61 + i)))


def test_a_drifting_row_raises_replay_mismatch(data):
    session = warmed(data, q1(50, 51))
    fp, _ = fingerprint(session, q1(50, 51))
    rows = [fingerprint(session, q1(50, 51))[1],
            fingerprint(session, q1(1, 99))[1]]
    with pytest.raises(compiled.ReplayMismatch):
        session._executor().run_param_batch(fp, rows)


def test_a_drifting_batch_is_served_serially_and_says_why(data):
    """The service strikes the program, serves the batch serially (which
    records the wider schedule) and names the batch's failure."""
    texts = [q1(50, 51), q1(1, 99)]
    runs = {side: held_batch(side, data, texts, [q1(50, 51)])
            for side in (REF, PORT)}
    (want, rstats, _), (got, pstats, _) = runs[REF], runs[PORT]
    for g, w in zip(got, want):
        same(g, w)
    assert [st.mode for st in pstats] == [st.mode for st in rstats]
    assert all(st.mode != "batched" for st in pstats)
    assert {st.extra["batch_error"] for st in pstats} == {"ReplayMismatch"}


def test_no_batch_without_a_live_program(data):
    session = make_session(PORT, data)
    session.sql(q1(5, 60))                      # recorded, not compiled
    fp, row = fingerprint(session, q1(5, 60))
    ex = session._executor()
    assert ex.run_param_batch(fp, [row]) is None
    assert ex.run_param_batch(None, [row]) is None
    assert ex.run_param_batch(fp, []) is None


def test_quarantine_strikes_then_evict_fp(data):
    session = warmed(data, q1(5, 60))
    fp, row = fingerprint(session, q1(5, 60))
    ex = session._executor()
    assert ex.run_param_batch(fp, [row, row]) is not None
    snap = {r["fingerprint"]: r for r in compiled.shared_programs_snapshot()}
    assert snap[fp]["compiles"] == 1 and snap[fp]["strikes"] == 0
    for n in range(1, compiled.QUARANTINE_STRIKES):
        assert not compiled.strike_shared_program(fp, reason="test")
        snap = {r["fingerprint"]: r
                for r in compiled.shared_programs_snapshot()}
        assert snap[fp]["strikes"] == n
    before = pmetrics.METRICS.snapshot()
    assert compiled.strike_shared_program(fp, reason="test")
    assert pmetrics.METRICS.delta(before).get("quarantined_programs") == 1
    assert fp not in {r["fingerprint"]
                      for r in compiled.shared_programs_snapshot()}
    assert ex.evict_fp(fp) == 1
    assert not [k for k in ex._batched if k[0] == fp]
    # the next sighting records afresh
    session.sql(q1(5, 60))
    assert session.last_stats["mode"] == "record"


# -- the service's opt-in knobs -----------------------------------------------

def test_watchdog_abandons_a_wedged_dispatch_neighbors_complete(data):
    """A dispatch that hangs past dispatch_timeout_s is abandoned: fresh
    session locks go in (abandon_inflight), the ticket fails typed and the
    lane serves its neighbours, bit-identical."""
    session = make_session(PORT, data)
    for sql in (q1(5, 60), q1(5, 60), q1(6, 61), q1(6, 61)):
        session.sql(sql)                 # warm outside the watchdog
    want = session.sql(q1(6, 61))
    locks = (session._sql_lock, session._lock)
    FLIGHT.configure(enabled=True, clear=True)
    FLIGHT.dump_dir = None
    try:
        cfg = ServiceConfig(batching=False, dispatch_timeout_s=1.5)
        with QueryService(session, cfg) as svc:
            pres.FAULTS.arm(pres.FaultSpec(point="jax.execute",
                                           action="hang", seconds=4.0,
                                           times=1))
            with svc.hold_dispatch():
                # the hang ticket first in the ready queue (two planner
                # threads may otherwise reorder it behind a neighbour)
                t_hang = svc.submit(q1(5, 60), label="hang")
                wait_ready(svc, 1)
                neighbors = [svc.submit(q1(6, 61), label=f"n{i}")
                             for i in range(2)]
                wait_ready(svc, 3)
            with pytest.raises(pres.DeadlineExceeded):
                t_hang.result(timeout=30)
            for t in neighbors:
                assert t.result(timeout=30).to_pylist() == want.to_pylist()
    finally:
        FLIGHT.configure(enabled=False, clear=False)
        pres.FAULTS.clear()
    assert (session._sql_lock, session._lock) != locks
    assert len([e for e in FLIGHT.events() if e["event"] == "trip"
                and e.get("reason") == "lane_watchdog"]) == 1
    pres._drain_abandoned(10.0)   # join the woken zombie


def test_inflight_dedup_and_fair_queue(data):
    """Tickets identical to an in-flight leader park on it (mode
    "deduped"); the weighted-fair queue serves both tenants; every result
    equals the reference's."""
    ref = make_session(REF, data)
    session = make_session(PORT, data)
    cfg = ServiceConfig(inflight_dedup=True, fair_queue=True,
                        tenant_weights={"a": 2.0})
    with QueryService(session, cfg) as svc:
        warm(svc, q1(5, 60))
        with svc.hold_dispatch():
            tickets = [svc.submit(q1(5 + i % 2, 60), tenant="ab"[i % 2])
                       for i in range(6)]
            wait_ready(svc, 2)
            # every follower parked on its (held) leader before release
            deadline = time.time() + 10
            while sum(len(t._dedup_followers) for t in tickets) < 4 and \
                    time.time() < deadline:
                time.sleep(0.01)
        for i, t in enumerate(tickets):
            same(t.result(60), ref.sql(q1(5 + i % 2, 60)))
    assert sum(t.stats.mode == "deduped" for t in tickets) == 4


def test_preemption_serves_incore_tickets_between_morsels(data, tmp_path):
    """With preemption on, a streamed dispatch yields the lane between
    scan groups and morsels to in-core tickets queued behind it; both
    results equal the reference's."""
    import pyarrow.parquet as pq
    path = str(tmp_path / "fact.parquet")
    pq.write_table(data["fact"], path, row_group_size=4096)
    cfg = dict(out_of_core=True, out_of_core_min_rows=10_000,
               chunk_rows=1024)      # 20 morsels: 20 yield points
    sessions = {}
    for side in (REF, PORT):
        s = side.session(**cfg)
        s.register_parquet("fact", path)
        s.register_arrow("dim", data["dim"])
        sessions[side] = s
    small = "SELECT COUNT(*) AS c FROM dim WHERE grp < 3"
    with QueryService(sessions[PORT], ServiceConfig(preemption=True)) as svc:
        with svc.hold_dispatch():
            streamed = svc.submit(q1(10, 90), label="streamed")
            wait_ready(svc, 1)
        small_t = []
        while not streamed.done():
            small_t.append(svc.submit(small, label="small"))
            time.sleep(0.005)
        same(streamed.result(60), sessions[REF].sql(q1(10, 90)))
        for t in small_t:
            same(t.result(60), sessions[REF].sql(small))
    assert streamed.preempted >= 1
    assert streamed.stats.mode == "streamed"


# -- features not ported yet --------------------------------------------------

def test_features_not_ported_raise_naming_their_roadmap_item(data):
    session = make_session(PORT, data)
    for cfg, item in ((ServiceConfig(result_cache=object()),
                       "engine/result_cache.py"),
                      (ServiceConfig(metrics_port=0), "obs/scrape.py")):
        with pytest.raises(NotImplementedError, match=item):
            QueryService(session, cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        session.attach_result_cache(object())
    with QueryService(session) as svc:
        with pytest.raises(NotImplementedError,
                           match="obs/system_tables.py"):
            svc.submit("SELECT * FROM system.metrics")
        with pytest.raises(NotImplementedError, match="obs/profile.py"):
            svc.explain_analyze(q1(5, 60))
        # a literal naming the prefix is no system statement
        assert svc.sql("SELECT COUNT(*) AS c FROM dim "
                       "WHERE 'system.x' = 'system.x'").num_rows == 1
    with pytest.raises(NotImplementedError, match="ROADMAP A.5"):
        session.sql("SELECT name FROM system.query_log")


def test_service_run_returns_typed_stats_atomically(data):
    session = make_session(PORT, data)
    table, stats = session.service_run(q1(5, 60), label="direct")
    assert stats is session.last_exec_stats_typed
    assert stats.mode == session.last_stats["mode"] == "record"
    assert stats.to_dict()["mode"] == "record"
    assert table.num_rows == 7
    # the statement's device-memory window holds its resident scans
    assert stats.mem_peak_bytes > 0 and stats.mem_live_bytes > 0


def test_one_query_log_row_per_ticket(data):
    """With the query log on, every ticket cuts one row (the service's,
    with its tenant and batch), and the session logs none of its own for
    service statements; a direct statement logs one row."""
    from nds_tpu_torch.obs.query_log import QUERY_LOG
    session = make_session(PORT, data)
    QUERY_LOG.configure(enabled=True, clear=True)
    try:
        with QueryService(session) as svc:
            warm(svc, q1(5, 60))
            with svc.hold_dispatch():
                tickets = [svc.submit(q1(5 + i, 60), tenant="t",
                                      label=f"log{i}") for i in range(3)]
                wait_ready(svc, 3)
            for t in tickets:
                t.result(60)
        session.sql(q1(9, 60), label="direct")
        rows = QUERY_LOG.rows()
    finally:
        QUERY_LOG.configure(enabled=False, clear=True)
    svc_rows = [r for r in rows if r.get("label", "").startswith("log")]
    assert len(svc_rows) == 3
    assert {r["source"] for r in svc_rows} == {"service"}
    assert {r["tenant"] for r in svc_rows} == {"t"}
    assert [r["source"] for r in rows if r.get("label") == "direct"] == \
        ["session"]
    assert len(rows) == 3 + 2 + 1           # tickets, warm-ups, direct


# -- the copied observability and resilience modules --------------------------

METRICS_MODS = pytest.mark.parametrize("om", [rmetrics, pmetrics],
                                       ids=["ref", "port"])
RES_MODS = pytest.mark.parametrize("rs", [rres, pres], ids=["ref", "port"])


@pytest.fixture(autouse=True)
def _faults_clear():
    yield
    rres.FAULTS.clear()
    pres.FAULTS.clear()


@METRICS_MODS
@pytest.mark.parametrize("dist", ["lognormal", "uniform", "bimodal"])
def test_histogram_quantile_within_documented_bound(om, dist):
    bound = om.BUCKET_RATIO ** 0.5
    rng = np.random.default_rng({"lognormal": 1, "uniform": 2,
                                 "bimodal": 3}[dist])
    if dist == "lognormal":
        vals = np.exp(rng.normal(2.0, 1.5, 4000))
    elif dist == "uniform":
        vals = rng.uniform(0.05, 5000.0, 4000)
    else:
        vals = np.concatenate([rng.uniform(0.5, 2.0, 2000),
                               rng.uniform(800.0, 900.0, 2000)])
    h = om.Histogram("t")
    for v in vals:
        h.observe(float(v))
    sv = sorted(float(v) for v in vals)
    for p in (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
        q = h.quantile(p)
        exact = om.exact_quantile(sv, p)
        assert exact / bound - 1e-9 <= q <= exact * bound + 1e-9
    assert h.count == len(vals)
    assert h.quantile(0.0) == pytest.approx(min(sv))
    assert h.quantile(1.0) == pytest.approx(max(sv))
    assert h.sum == pytest.approx(sum(sv), rel=1e-9)


@METRICS_MODS
def test_histogram_empty_and_single_sample_edges(om):
    assert om.Histogram("e").quantile(0.5) is None
    assert om.Histogram("e").snapshot()["count"] == 0
    one = om.Histogram("o")
    one.observe(3.7)
    for p in (0.0, 0.01, 0.5, 0.99, 1.0):
        assert one.quantile(p) == 3.7
    big = om.Histogram("b")
    big.observe(1e9)
    assert big.quantile(0.5) == 1e9
    assert big.snapshot()["buckets"][-1][0] is None


@METRICS_MODS
def test_histogram_merge_and_diff(om):
    def mk(seed, n):
        h = om.Histogram("m")
        for v in np.random.default_rng(seed).uniform(0.001, 50_000.0, n):
            h.observe(float(v))
        return h
    a, b, c = (mk(s, n).snapshot() for s, n in ((1, 300), (2, 217), (3, 55)))
    m1 = om.merge_snapshots(om.merge_snapshots(a, b), c)
    assert m1 == om.merge_snapshots(a, om.merge_snapshots(b, c))
    assert om.merge_snapshots(a, b) == om.merge_snapshots(b, a)
    h = mk(4, 500)
    before = h.snapshot()
    for v in np.random.default_rng(5).uniform(50.0, 5000.0, 300):
        h.observe(float(v))
    win = om.diff_snapshot(h.snapshot(), before)
    only = mk(4, 0)
    for v in np.random.default_rng(5).uniform(50.0, 5000.0, 300):
        only.observe(float(v))
    assert win["count"] == 300
    assert win["buckets"] == only.snapshot()["buckets"]


@METRICS_MODS
def test_histogram_thread_safety_under_hammering(om):
    h = om.Histogram("conc")

    def work(seed):
        for v in np.random.default_rng(seed).uniform(0.1, 1000.0, 5_000):
            h.observe(float(v))
    ts = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    snap = h.snapshot()
    assert snap["count"] == 40_000
    assert sum(n for _le, n in snap["buckets"]) == 40_000


@METRICS_MODS
def test_registry_labels_cap_namespaces_and_export(om):
    reg = om.MetricsRegistry()
    reg.histogram("lat_ms", "family help")
    for tenant, vals in (("a", [10, 20, 30]), ("b", [500, 600, 700])):
        for v in vals:
            reg.histogram("lat_ms", tenant=tenant, template="t1").observe(v)
            reg.histogram("lat_ms").observe(v)
    hists = reg.histograms()
    assert hists["lat_ms{template=t1,tenant=a}"]["labels"] == \
        {"tenant": "a", "template": "t1"}
    assert reg.describe()["lat_ms"] == "family help"
    rows = reg.percentiles("lat_ms", ps=(0.5, 0.99))
    assert rows[0]["labels"] == {} and rows[0]["count"] == 6
    assert rows[1]["labels"].get("tenant") == "b"
    orig = om.HISTOGRAM_MAX_SERIES
    om.HISTOGRAM_MAX_SERIES = 4
    try:
        capped = om.MetricsRegistry()
        for i in range(10):
            capped.histogram("h", tenant=f"t{i}").observe(1.0)
    finally:
        om.HISTOGRAM_MAX_SERIES = orig
    labeled = [k for k in capped.histograms() if "{" in k]
    assert len(labeled) <= 4
    assert capped.histograms()["h"]["count"] == 10 - len(labeled)
    reg.counter("q_wait_ms", "total").inc(5)
    reg.histogram("q_wait_ms", "distribution").observe(5.0)
    assert reg.snapshot()["q_wait_ms"] == 5
    with pytest.raises(TypeError):
        reg.gauge("q_wait_ms")
    text = reg.export_prometheus()
    assert "# TYPE q_wait_ms_total counter" in text
    assert 'lat_ms_count{template="t1",tenant="a"} 3' in text


@METRICS_MODS
def test_snapshot_is_atomic_cut_across_metrics(om):
    reg = om.MetricsRegistry()
    a, b = reg.counter("a"), reg.counter("b")
    stop = threading.Event()
    torn = []

    def writer():
        while not stop.is_set():
            with reg.locked():
                a.inc()
                b.inc()
    w = threading.Thread(target=writer)
    w.start()
    for _ in range(2000):
        snap = reg.snapshot()
        if snap["a"] != snap["b"]:
            torn.append(snap)
    stop.set()
    w.join()
    assert torn == []


@RES_MODS
def test_retry_policy_classification_and_backoff(rs):
    p = rs.RetryPolicy(backoff_s=0.1, backoff_factor=2.0, max_backoff_s=0.35)
    assert [p.backoff(i) for i in (1, 2, 3)] == \
        [pytest.approx(0.1), pytest.approx(0.2), pytest.approx(0.35)]
    calls, sleeps = [], []
    flaky = rs.RetryPolicy(max_attempts=3, backoff_s=0.1)

    def fn():
        calls.append(1)
        if len(calls) < 3:
            raise rs.TransientError("hiccup")
        return "ok"
    assert flaky.call(fn, sleep=sleeps.append) == "ok" and len(calls) == 3
    assert p.classify(rs.DeadlineExceeded("x")) == "fatal"
    assert p.classify(rs.TransientError("x")) == "transient"
    assert p.classify(rs.FaultError("x")) == "transient"
    assert p.classify(rs.AdmissionRejected("x")) == "transient"


@RES_MODS
def test_deadlines(rs):
    now = [0.0]
    d = rs.Deadline(1.0, clock=lambda: now[0])
    assert not d.expired() and d.remaining() == pytest.approx(1.0)
    now[0] = 1.5
    assert d.expired()
    with pytest.raises(rs.DeadlineExceeded):
        d.check("query42")
    assert rs.run_with_deadline(lambda x: x + 1, None, 41) == 42
    t0 = time.monotonic()
    with pytest.raises(rs.DeadlineExceeded):
        rs.run_with_deadline(time.sleep, 0.2, 1.0, label="hung query")
    assert time.monotonic() - t0 < 3.0
    rs._drain_abandoned(10.0)


@RES_MODS
def test_fault_specs_and_registry(rs):
    s = rs.FaultSpec.parse("jax.execute:hang:5#1")
    assert (s.point, s.action, s.seconds, s.times) == \
        ("jax.execute", "hang", 5.0, 1)
    with pytest.raises(ValueError):
        rs.FaultSpec.parse("warp.core:raise")
    rs.FAULTS.arm("arrow.read:raise#1")
    with pytest.raises(rs.FaultError):
        rs.FAULTS.fire("arrow.read")
    rs.FAULTS.fire("arrow.read")                    # times=1: exhausted
    spec = rs.FAULTS.arm("query.run:raise/query5")
    rs.FAULTS.fire("query.run", "query7")
    assert rs.FAULTS.would_raise("query.run", "query5")
    rs.FAULTS.disarm(spec)
    rs.FAULTS.fire("query.run", "query5")


def test_port_fault_points_fire_at_its_seams(data):
    """jax.execute fires at a record pass and at every replay, jax.compile
    where a program is made: an armed raise fails the statement."""
    session = make_session(PORT, data)
    pres.FAULTS.arm("jax.execute:raise#1")
    with pytest.raises(pres.FaultError):
        session.sql(q1(5, 60))
    session.sql(q1(5, 60))                     # records
    pres.FAULTS.arm("jax.compile:raise#1")
    with pytest.raises(pres.FaultError):
        session.sql(q1(5, 60))                 # the program's first run
    assert session.sql(q1(5, 60)).num_rows == 7
