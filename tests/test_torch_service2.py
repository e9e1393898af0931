"""The port's query service against the reference's, part 2 of 3:
concurrent clients, live configuration changes, the streamed path,
admission control and deadlines, service-backed throughput streams and
100 open-loop clients (the other cases of tests/test_service.py, each
through both services over the same data; see
tests/torch_service_cases.py)."""
import threading
import time

import numpy as np
import pyarrow.parquet as pq
import pytest

from nds_tpu_torch.validate import table_mismatches
from torch_isolation import isolate_port_programs  # noqa: F401
from torch_service_cases import (PORT, REF, SIDES, concurrent, make_data,
                                 make_session, q1, q2, same, wait_ready,
                                 warm)


@pytest.fixture(scope="module")
def data():
    return make_data()


@pytest.fixture(scope="module")
def ref_results(data):
    """Each text's result on a fresh single-caller reference session."""
    session = make_session(REF, data)
    cache: dict = {}

    def ref(sql):
        if sql not in cache:
            cache[sql] = session.sql(sql, label="ref")
        return cache[sql]
    return ref


def test_concurrent_clients_bit_identical(data, ref_results):
    texts = [q1(5 + i % 4, 60 + i % 4) for i in range(8)] + \
        [q2(25 + i % 3) for i in range(4)]
    for side in SIDES:
        session = make_session(side, data)
        with side.QueryService(session, side.ServiceConfig(
                plan_workers=2)) as svc:
            warm(svc, q1(5, 60))
            results, errors = concurrent(svc, texts, "cl")
        assert not errors, (side, errors)
        assert len(results) == len(texts)
        for i, got in results.items():
            same(got, ref_results(texts[i]))


def test_live_config_toggle_races_inflight_queries(data, ref_results):
    """The kernel choice flipped while clients are in flight (the
    reference's pallas_ops, the port's gpu_kernels): every result stays
    exact (the kernels equal the plain versions bit for bit)."""
    texts = [q1(5 + i % 3, 60 + i % 3) for i in range(6)]
    flips = {REF: ("pallas_ops", (("gather",), (), ("gather", "groupby"),
                                  ())),
             PORT: ("gpu_kernels", (("gather",), (), ("gather", "groupby"),
                                    ("gather", "groupby", "sort")))}
    for side in SIDES:
        session = make_session(side, data)
        field, values = flips[side]
        with side.QueryService(session, side.ServiceConfig()) as svc:
            warm(svc, texts[0])
            out: dict = {}
            t = threading.Thread(target=lambda: out.update(
                zip(("results", "errors"), concurrent(svc, texts, "tog"))))
            t.start()
            for v in values:
                setattr(session.config, field, v)
                time.sleep(0.05)
            t.join(timeout=180)
        assert not out["errors"], (side, out["errors"])
        for i, got in out["results"].items():
            same(got, ref_results(texts[i]))


def test_streamed_query_through_service(data, tmp_path):
    """An out-of-core query takes the serial lane (the session's streamed
    path) and equals a fresh single-caller session under the same
    streaming configuration; the planner stage keeps it out of batching.
    A live encoded_exec toggle then streams plain, with the same result."""
    path = str(tmp_path / "fact.parquet")
    pq.write_table(data["fact"], path, row_group_size=4096)
    cfg = dict(out_of_core=True, out_of_core_min_rows=10_000,
               chunk_rows=4096)
    sql = q1(10, 90)
    got: dict = {}
    for side in SIDES:
        def streaming_session():
            s = side.session(**cfg)
            s.register_parquet("fact", path)
            s.register_arrow("dim", data["dim"])
            return s
        want = streaming_session().sql(sql, label="ref")
        session = streaming_session()
        with side.QueryService(session, side.ServiceConfig()) as svc:
            t = svc.submit(sql, label="streamed")
            got[side] = t.result(timeout=120)
            mode = t.stats.mode
            assert t.stats.queue_wait_ms is not None
            assert t.fp is None and t.streams
            session.config.encoded_exec = False
            t2 = svc.submit(sql, label="streamed-plain")
            plain = t2.result(timeout=120)
            assert t2.stats.mode == mode
        assert mode == ("streaming" if side is REF else "streamed")
        same(plain, got[side])
        same(got[side], want)
    same(got[PORT], got[REF])


@pytest.mark.parametrize("side", SIDES, ids=str)
def test_queue_full_typed_rejection(data, side):
    session = make_session(side, data)
    with side.QueryService(session, side.ServiceConfig(max_pending=2)) as svc:
        with svc.hold_dispatch():
            t1 = svc.submit(q1(5, 60))
            t2 = svc.submit(q1(6, 61))
            before = side.metrics.METRICS.snapshot()
            with pytest.raises(side.res.AdmissionRejected) as ei:
                svc.submit(q1(7, 62))
            assert ei.value.depth == 2 and ei.value.limit == 2
            assert side.metrics.METRICS.delta(before).get(
                "service_rejected") == 1
        assert t1.result(60) is not None
        assert t2.result(60) is not None


def test_deadline_expires_in_queue_neighbors_complete(data, ref_results):
    for side in SIDES:
        session = make_session(side, data)
        with side.QueryService(session, side.ServiceConfig()) as svc:
            warm(svc, q1(5, 60))
            with svc.hold_dispatch():
                doomed = svc.submit(q1(6, 61), deadline_s=0.05,
                                    tenant="t-low")
                neighbors = [svc.submit(q1(7 + i, 62 + i))
                             for i in range(2)]
                wait_ready(svc, 1)
                time.sleep(0.2)        # the doomed ticket's budget expires
            with pytest.raises(side.res.DeadlineExceeded) as ei:
                doomed.result(timeout=60)
            assert "t-low" in str(ei.value)
            for i, t in enumerate(neighbors):
                same(t.result(60), ref_results(q1(7 + i, 62 + i)))


@pytest.mark.parametrize("side", SIDES, ids=str)
def test_tenant_deadline_mapping(data, side):
    session = make_session(side, data)
    cfg = side.ServiceConfig(tenant_deadlines={"impatient": 0.01},
                             default_deadline_s=0.0)
    with side.QueryService(session, cfg) as svc:
        with svc.hold_dispatch():
            doomed = svc.submit(q1(5, 60), tenant="impatient")
            ok = svc.submit(q1(5, 60), tenant="patient")
            time.sleep(0.1)
        with pytest.raises(side.res.DeadlineExceeded):
            doomed.result(timeout=60)
        assert ok.result(60) is not None


@pytest.mark.parametrize("side", SIDES, ids=str)
def test_closed_service_rejects_typed(data, side):
    session = make_session(side, data)
    svc = side.QueryService(session, side.ServiceConfig())
    with pytest.raises(side.ServiceClosed):
        svc.submit(q1(5, 60))          # never started
    svc.start()
    svc.sql(q1(5, 60))
    svc.close()
    with pytest.raises(side.res.AdmissionRejected):
        svc.submit(q1(5, 60))


def test_throughput_service_streams(data, ref_results, tmp_path):
    """Two throughput streams through one shared service, driven by the
    reference's stream runner (the port has no throughput runner yet):
    each stream's time log keeps the power-run contract and the shared
    session served both, on each service."""
    from nds_tpu.throughput import (_run_stream_service, scrape_log,
                                    stream_log_path, throughput_elapsed)
    stream_text = "\n".join(
        f"-- start query {i + 1} using template query{i + 1}.tpl\n"
        + q1(5 + i, 60 + i) for i in range(2))
    sf = tmp_path / "stream.sql"
    sf.write_text(stream_text)
    for side in SIDES:
        session = make_session(side, data)
        logs = [stream_log_path(str(tmp_path / side.name), i)
                for i in range(2)]
        (tmp_path / side.name).mkdir()
        with side.QueryService(session, side.ServiceConfig()) as svc:
            threads = [threading.Thread(
                target=_run_stream_service, args=(svc, str(sf), log))
                for log in logs]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            for i in range(2):      # the session serves the same texts
                same(svc.sql(q1(5 + i, 60 + i)),
                     ref_results(q1(5 + i, 60 + i)))
        for log in logs:
            start, end = scrape_log(log)
            assert end >= start
        assert throughput_elapsed(logs) >= 0.0


def test_open_loop_100_clients(data, ref_results):
    """100 concurrent clients, mixed templates, literal pools shared
    across clients (the dashboard shape): every response equals the
    reference's serial result, no hangs, batching engaged, on each
    service."""
    pool = [q1(5 + i, 60 + i) for i in range(8)] + \
        [q2(20 + i) for i in range(4)]
    want = {s: ref_results(s) for s in pool}
    for side in SIDES:
        session = make_session(side, data)
        errors: list = []
        done = [0]
        lock = threading.Lock()
        with side.QueryService(session, side.ServiceConfig(
                max_pending=512, max_batch=32)) as svc:
            warm(svc, pool[0])
            warm(svc, pool[8])

            def client(cid):
                rng = np.random.default_rng(cid)
                for _ in range(3):
                    sql = pool[int(rng.integers(0, len(pool)))]
                    try:
                        got = svc.sql(sql, label=f"open{cid}", timeout=300)
                        bad = table_mismatches(got, want[sql])
                        if bad:
                            errors.append((cid, sql, bad))
                    except Exception as e:
                        errors.append((cid, sql, e))
                    with lock:
                        done[0] += 1

            before = side.metrics.METRICS.snapshot()
            threads = [threading.Thread(target=client, args=(cid,))
                       for cid in range(100)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
        assert not errors, (side, errors[:5])
        assert done[0] == 300
        delta = side.metrics.METRICS.delta(before)
        assert delta.get("service_batches", 0) >= 1, side
        assert delta.get("service_batched_queries", 0) >= 10, side
