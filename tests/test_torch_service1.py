"""The port's query service against the reference's, part 1 of 3:
compatible-plan batching and the shared programs (the first five cases of
tests/test_service.py, each run through both services over the same data;
see tests/torch_service_cases.py)."""
import pytest

from nds_tpu_torch.engine.torch_backend import compiled
from torch_isolation import isolate_port_programs  # noqa: F401
from torch_service_cases import (PORT, REF, held_batch, make_data,
                                 make_session, q1, q2, same, warm)


@pytest.fixture(scope="module")
def data():
    return make_data()


def test_batched_dispatch_bit_identical(data):
    params = [(5 + i, 60 + i) for i in range(5)]
    texts = [q1(a, b) for a, b in params]
    runs = {side: held_batch(side, data, texts, [texts[0]],
                             side.ServiceConfig(max_batch=8))
            for side in (REF, PORT)}
    (want, rstats, _), (got, pstats, _) = runs[REF], runs[PORT]
    for g, w in zip(got, want):
        same(g, w)
    for stats in (rstats, pstats):
        for st in stats:
            assert st.mode == "batched"
            assert st.batched_with == len(params) - 1
            assert st.queue_wait_ms is not None and st.queue_wait_ms >= 0
            d = st.to_dict()
            assert d["batched_with"] == len(params) - 1
            assert "queue_wait_ms" in d
    for side, (_, _, delta) in runs.items():
        assert delta.get("service_batches", 0) >= 1, side
        assert delta.get("service_batched_queries", 0) == len(params), side
        # one batched program made for each capacity (the reference's
        # one, the port's one a rung of the ladder); the per-row programs
        # were not
        made = 1 if side is REF else len(compiled.batch_rungs(len(params)))
        assert delta.get("compiles", 0) <= made, side
    # the port's dispatch: five rows as full rungs of the ladder, four and
    # one (no padding row)
    assert {(st.extra["batch_rows"], st.extra["batch_caps"])
            for st in pstats} == {(5, (4, 1))}


def test_batch_dedups_identical_parameters(data):
    texts = [q1(3, 77)] * 4
    runs = {side: held_batch(side, data, texts, [q1(3, 77)])
            for side in (REF, PORT)}
    (want, rstats, _), (got, pstats, _) = runs[REF], runs[PORT]
    for g, w in zip(got, want):
        same(g, w)
    for stats in (rstats, pstats):
        assert [st.mode for st in stats] == ["batched"] * 4
        assert [st.batched_with for st in stats] == [3] * 4
    # parameter-identical tickets share one row and one materialized table
    assert {st.extra["dedup"] for st in pstats} == {3}
    assert {st.extra["batch_rows"] for st in pstats} == {1}
    assert all(g is got[0] for g in got)


def test_unwarmed_batch_falls_back_serial_and_correct(data):
    """No published program yet: the batched lookup misses, the group is
    served serially through the unit lifecycle, results stay exact."""
    params = [(2, 40), (3, 50), (4, 60)]
    texts = [q1(a, b) for a, b in params]
    runs = {side: held_batch(side, data, texts) for side in (REF, PORT)}
    (want, rstats, _), (got, pstats, _) = runs[REF], runs[PORT]
    for g, w in zip(got, want):
        same(g, w)
    for stats in (rstats, pstats):
        assert all(st.mode != "batched" for st in stats)
    # the port says why: no program to batch over yet
    assert {st.extra.get("batch_error") for st in pstats} == {"unavailable"}


def test_incompatible_templates_do_not_cobatch(data):
    texts = [q1(5 + i, 60 + i) for i in range(2)] + \
        [q2(30 + i) for i in range(2)]
    runs = {side: held_batch(side, data, texts, [q1(5, 60), q2(30)])
            for side in (REF, PORT)}
    (want, rstats, _), (got, pstats, _) = runs[REF], runs[PORT]
    for g, w in zip(got, want):
        same(g, w)
    for stats in (rstats, pstats):
        # each template batched only with its own kind
        assert all(st.batched_with == 1 for st in stats
                   if st.mode == "batched")
    assert [st.mode for st in pstats] == [st.mode for st in rstats]


@pytest.mark.parametrize("side", [REF, PORT], ids=str)
def test_cross_client_adoption_no_recompile(data, side):
    """The Nth client's new text of a warmed template records and compiles
    nothing: the shared schedule and program are adopted."""
    session = make_session(side, data)
    with side.QueryService(session, side.ServiceConfig()) as svc:
        warm(svc, q1(7, 70))
        before = side.metrics.METRICS.snapshot()
        got = [svc.sql(q1(8, 71), label="client2"),
               svc.sql(q1(9, 72), label="client3")]
        delta = side.metrics.METRICS.delta(before)
    assert delta.get("compiles", 0) == 0
    assert delta.get("programs_adopted", 0) >= 2
    if side is PORT:
        ref = make_session(REF, data)
        for g, sql in zip(got, (q1(8, 71), q1(9, 72))):
            same(g, ref.sql(sql))
