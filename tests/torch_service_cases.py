"""Shared inputs and runs of the port's query-service tests
(tests/test_torch_service{1,2,3}.py).

The data and templates are tests/test_service.py's: a 20,000-row fact
table and a 50-row dimension made with numpy from seed 7, one template
with integer and float aggregates over a join (``q1``) and a structurally
different one (``q2``). Each case runs the same scenario through two
service stacks, ``REF`` (``nds_tpu``'s Session and QueryService, jitted
on the CPU) and ``PORT`` (``nds_tpu_torch``'s, ``device="cpu"``), and the
test holds the port's results to the reference's (``validate.
table_mismatches``: integers bit-identical, floats to rtol 1e-9) and its
observations (modes, ``batched_with``, metric deltas) to the reference's.
"""
import threading
import time

import numpy as np
import pyarrow as pa

import nds_tpu.resilience
import nds_tpu.service.service
from nds_tpu.config import EngineConfig as RConfig
from nds_tpu.engine import Session as RSession
from nds_tpu.obs import metrics as rmetrics

import nds_tpu_torch as nt
import nds_tpu_torch.resilience
import nds_tpu_torch.service.service
from nds_tpu_torch.obs import metrics as pmetrics
from nds_tpu_torch.validate import table_mismatches

N_FACT, N_DIM = 20_000, 50

#: one parameterized template (int and float aggregates) instantiated with
#: other literal values per client
TPL = ("SELECT grp, COUNT(*) AS n, SUM(qty) AS tq, SUM(price) AS tp "
       "FROM fact JOIN dim ON fk = dk WHERE qty BETWEEN {a} AND {b} "
       "GROUP BY grp ORDER BY grp")
#: a second, structurally different template (another fingerprint)
TPL2 = ("SELECT fk, MAX(qty) AS mq FROM fact WHERE qty < {a} "
        "GROUP BY fk ORDER BY fk LIMIT 5")


def q1(a, b):
    return TPL.format(a=a, b=b)


def q2(a):
    return TPL2.format(a=a)


def make_data() -> dict:
    rng = np.random.default_rng(7)
    fact = pa.table({
        "fk": pa.array(rng.integers(0, N_DIM, N_FACT), type=pa.int64()),
        "qty": pa.array(rng.integers(1, 100, N_FACT), type=pa.int64()),
        "price": pa.array(np.round(rng.uniform(1, 50, N_FACT), 2)),
    })
    dim = pa.table({"dk": pa.array(np.arange(N_DIM), type=pa.int64()),
                    "grp": pa.array((np.arange(N_DIM) % 7)
                                    .astype(np.int64))})
    return {"fact": fact, "dim": dim}


class Side:
    """One engine's service stack: its Session, service and resilience
    modules and metrics registry."""

    def __init__(self, name: str, session, service_pkg, resilience,
                 metrics):
        self.name = name
        self._session = session
        self.QueryService = service_pkg.QueryService
        self.ServiceConfig = service_pkg.ServiceConfig
        self.ServiceClosed = service_pkg.service.ServiceClosed
        self.res = resilience
        self.metrics = metrics

    def session(self, **cfg):
        return self._session(**cfg)

    def __repr__(self) -> str:
        return self.name


REF = Side("ref", lambda **cfg: RSession(RConfig(**cfg)), nds_tpu.service,
           nds_tpu.resilience, rmetrics)
PORT = Side("port",
            lambda **cfg: nt.Session(nt.EngineConfig(**cfg), device="cpu"),
            nds_tpu_torch.service, nds_tpu_torch.resilience, pmetrics)
SIDES = (REF, PORT)


def make_session(side: Side, data: dict, **cfg):
    s = side.session(**cfg)
    s.register_arrow("fact", data["fact"])
    s.register_arrow("dim", data["dim"])
    return s


def wait_ready(svc, n: int, timeout: float = 10.0) -> None:
    """Block until the planner stage has n tickets parked at the (held)
    device lane."""
    t0 = time.time()
    while time.time() - t0 < timeout:
        with svc._cv:
            if len(svc._ready) >= n:
                return
        time.sleep(0.01)
    raise AssertionError(f"planner stage never readied {n} tickets")


def warm(svc, sql: str) -> None:
    """Two runs: record, then compile and publish the shared program."""
    svc.sql(sql, label="warm")
    svc.sql(sql, label="warm")


def held_batch(side: Side, data: dict, texts: list, warm_texts=(),
               cfg=None):
    """The texts submitted while the lane is held, after the warm-ups:
    (results, ticket stats, the metric delta over the batch)."""
    session = make_session(side, data)
    with side.QueryService(session, cfg or side.ServiceConfig()) as svc:
        for w in warm_texts:
            warm(svc, w)
        before = side.metrics.METRICS.snapshot()
        with svc.hold_dispatch():
            tickets = [svc.submit(sql, label=f"c{i}")
                       for i, sql in enumerate(texts)]
            wait_ready(svc, len(tickets))
        results = [t.result(timeout=120) for t in tickets]
        delta = side.metrics.METRICS.delta(before)
    return results, [t.stats for t in tickets], delta


def concurrent(svc, texts: list, label: str) -> tuple:
    """Each text from its own client thread: ({index: result}, errors)."""
    results: dict = {}
    errors: list = []

    def client(i, sql):
        try:
            results[i] = svc.sql(sql, label=f"{label}{i}", timeout=120)
        except Exception as e:      # surfaced by the caller
            errors.append((i, sql, e))

    threads = [threading.Thread(target=client, args=(i, s))
               for i, s in enumerate(texts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return results, errors


def same(got, want) -> None:
    """The port's result against the reference's."""
    assert table_mismatches(got, want) == []
