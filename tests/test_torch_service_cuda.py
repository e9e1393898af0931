"""The query service's batched graphs on the card (marked ``cuda``; they
skip where there is no card).

Run on a machine with an NVIDIA card:

    python -m pytest --noconftest -m cuda tests/test_torch_service_cuda.py

A batch of four parameter rows runs as one CUDA graph whose rows equal
four replays of the single program's graph and the numpy executor; a
(program, batch capacity) is captured once, however many batches ride it;
a capture of sixteen rows holds about what one of two rows holds (row i
reuses row i-1's freed blocks); and a planner thread plans and reads
column stats while the device lane captures a batched graph. The data
are tests/test_service.py's, made here (these tests run where jax may be
missing, so tests/torch_service_cases.py, which imports the reference, is
not used)."""
import threading

import numpy as np
import pyarrow as pa
import pytest
import torch

import nds_tpu_torch as nt
from nds_tpu_torch.engine.plan import parameterize_plan
from nds_tpu_torch.engine.torch_backend import compiled
from nds_tpu_torch.engine.torch_backend import cuda_kernels as ck
from nds_tpu_torch.engine.torch_backend.device import to_host
from nds_tpu_torch.service import QueryService, ServiceConfig
from nds_tpu_torch.validate import table_mismatches
from torch_isolation import isolate_port_programs  # noqa: F401

pytestmark = pytest.mark.cuda

TPL = ("SELECT grp, COUNT(*) AS n, SUM(qty) AS tq, SUM(price) AS tp "
       "FROM fact JOIN dim ON fk = dk WHERE qty BETWEEN {a} AND {b} "
       "GROUP BY grp ORDER BY grp")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the batched graphs run there")
    ck.build()
    return torch.device("cuda")


def session_on(device):
    rng = np.random.default_rng(7)
    n_fact, n_dim = 200_000, 50
    fact = pa.table({
        "fk": pa.array(rng.integers(0, n_dim, n_fact), type=pa.int64()),
        "qty": pa.array(rng.integers(1, 100, n_fact), type=pa.int64()),
        "price": pa.array(np.round(rng.uniform(1, 50, n_fact), 2)),
    })
    dim = pa.table({"dk": pa.array(np.arange(n_dim), type=pa.int64()),
                    "grp": pa.array((np.arange(n_dim) % 7)
                                    .astype(np.int64))})
    s = nt.Session(nt.EngineConfig(), device=str(device))
    s.register_arrow("fact", fact)
    s.register_arrow("dim", dim)
    return s


def batch_inputs(session, params):
    """(the batching fingerprint, each text's hoisted values)."""
    rows = []
    fp = None
    for a, b in params:
        pplan, values, _ = parameterize_plan(session.plan(TPL.format(a=a,
                                                                     b=b)))
        fp = compiled.shared_fingerprint(pplan, session._executor().gpu_ops)
        rows.append(tuple(values))
    return fp, rows


def warmed(dev):
    s = session_on(dev)
    for _ in range(2):                    # record, then the capture
        s.sql(TPL.format(a=20, b=80))
    assert s.last_stats["mode"] == "compile+run"
    return s


def test_a_batched_graph_equals_serial_replays(dev):
    s = warmed(dev)
    params = [(20, 60), (25, 70), (30, 80), (21, 61)]
    fp, rows = batch_inputs(s, params)
    ex = s._executor()
    with ex.on_stream():
        outs = ex.run_param_batch(fp, rows)
    st = ex.last_stats
    assert st["mode"] == "batched" and st["batch_caps"] == (4,)
    g, = st["graphs"]
    assert g["graph_ms"] > 0 and "capture_s" in g
    # the rows' kernels were captured (a graph's replays call no wrapper)
    assert sum(g["captured_launches"].values()) > 0, g["captured_launches"]
    cq = ex._plans[("sql", TPL.format(a=20, b=80))]["cq"]
    for (a, b), row, out in zip(params, rows, outs):
        with ex.on_stream():
            single = to_host(cq.run(
                ex._scans_for({"scan_keys": cq.scan_keys}), row))
        got = to_host(out)
        assert got.to_pylist() == single.to_pylist()
        want = s.sql(TPL.format(a=a, b=b), backend="numpy")
        assert table_mismatches(got, want) == []


def test_one_capture_per_program_and_capacity(dev):
    s = warmed(dev)
    ex = s._executor()
    fp, rows = batch_inputs(s, [(20 + i, 60 + i) for i in range(8)])
    with ex.on_stream():
        first = [r.num_rows for r in map(to_host,
                                         ex.run_param_batch(fp, rows[:4]))]
        for k in (3, 4, 2, 1, 7):
            assert len(ex.run_param_batch(fp, rows[8 - k:])) == k
            assert ex.last_stats["batch_caps"] == \
                tuple(compiled.batch_rungs(k))
    assert first == [7] * 4
    assert {c: ex._batched[(fp, c)].captures for c in (4, 2, 1)} == \
        {4: 1, 2: 1, 1: 1}


def test_a_batched_capture_reuses_a_rows_blocks(dev):
    """Row i's intermediates are freed inside the capture and row i+1
    takes their blocks: the memory a capture of sixteen rows holds at its
    peak stays near a capture of two rows', far from eight times it. The
    peak is read on the card's allocator around each first batch (the
    capture, and the warm row before it)."""
    s = warmed(dev)
    ex = s._executor()
    fp, rows = batch_inputs(s, [(20 + i, 60 + i) for i in range(16)])
    peaks = {}
    with ex.on_stream():
        for k in (2, 16):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ex.run_param_batch(fp, rows[:k])
            torch.cuda.synchronize()
            assert "capture_s" in ex.last_stats["graphs"][0]
            # the graph's outputs stay allocated in its pool: allocations
            # into a graph's pool count in these statistics
            assert torch.cuda.memory_allocated() > base
            peaks[k] = torch.cuda.max_memory_allocated() - base
    assert 0 < peaks[2] and peaks[16] < 2 * peaks[2], peaks


def test_a_planner_thread_plans_while_the_lane_captures(dev):
    """The service's planner threads are host-only: planning and column
    stats on another thread leave the lane's thread-local capture
    valid, and the held batch is served as one dispatch."""
    s = warmed(dev)
    stop = threading.Event()
    planned = [0]
    errors: list = []

    def planner():
        try:
            while not stop.is_set():
                s.plan(TPL.format(a=30, b=90))
                s.column_stats("fact")
                s._est_rows_for("fact", 0, "planner")
                planned[0] += 1
        except Exception as e:          # reported below
            errors.append(e)
    th = threading.Thread(target=planner)
    th.start()
    try:
        with QueryService(s, ServiceConfig()) as svc:
            with svc.hold_dispatch():
                tickets = [svc.submit(TPL.format(a=20 + i, b=60 + i))
                           for i in range(8)]
                while len(svc._ready) < 8:
                    stop.wait(0.005)
            results = [t.result(timeout=120) for t in tickets]
    finally:
        stop.set()
        th.join()
    assert not errors and planned[0] > 0
    assert {t.stats.mode for t in tickets} == {"batched"}
    assert {t.stats.batched_with for t in tickets} == {7}
    assert "capture_s" in tickets[0].stats.extra["graphs"][0]
    for i, got in enumerate(results):
        want = s.sql(TPL.format(a=20 + i, b=60 + i), backend="numpy")
        assert table_mismatches(got, want) == []
