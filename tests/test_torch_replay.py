"""Compiled replay in the port, on the CPU, at SF0.01.

Each unit runs three times through ``Session.sql(backend="torch")``:
record (eager, the capacity schedule recorded), compile+run (the plan
replayed against the schedule; on the card the replay a CUDA graph
captures, here its plain form) and compiled. Every run is held against
nds_tpu's ``backend="numpy"`` result on the same data (integers, dates and
decimals exact, floats to rtol 1e-9: ``validate.table_mismatches``). The
units cover every decision seam, CTE and rollup segmentation, CONCAT,
scalar subqueries, windows and set operations; the other tests hold the
lifecycle's repairs to the reference's: a second stream adopting the first
stream's schedule, a literal that overflows the adopted schedule
(ReplayMismatch, then a new record), and a cast to string, which stays
eager ("nojit") for the reference's reason.

Schedules against the reference's record pass: test_torch_replay_schedule*.
"""
import os

import pytest

from nds_tpu.config import EngineConfig as RConfig
from nds_tpu.engine import Session as RSession
from nds_tpu.engine.planner import Planner as RPlanner
from nds_tpu.schema import get_schemas
from nds_tpu.sql import parse_sql as rparse_sql

import nds_tpu_torch as nt
from nds_tpu_torch import datagen, streams
from nds_tpu_torch.engine.torch_backend import compiled
from nds_tpu_torch.validate import table_mismatches
from torch_isolation import isolate_port_programs  # noqa: F401

SEED = 3
UNITS = dict(streams.template_units(stream=0, rngseed=SEED))

#: one plan for each decision the templates leave out: the null-aware
#: anti join (NOT IN) on both join paths, and the sorted aggregation over
#: a float key (its tier decision is then exact, not lazy)
KIND_SQL = {
    "not_in_sorted": "SELECT i_item_sk FROM item WHERE i_item_sk NOT IN "
                     "(SELECT ss_item_sk FROM store_sales "
                     "WHERE ss_quantity > 95)",
    "not_in_direct": "SELECT ss_item_sk, ss_quantity FROM store_sales "
                     "WHERE ss_item_sk NOT IN (SELECT i_item_sk FROM item "
                     "WHERE i_current_price > 50)",
    "float_key": "SELECT CAST(ss_quantity AS DOUBLE) AS q, COUNT(*) AS c "
                 "FROM store_sales GROUP BY CAST(ss_quantity AS DOUBLE)",
}

#: every decision seam (q3: branch, lazy tier, lazy direct-address probe,
#: caps), scalar subqueries (q9), CTE segmentation (q4, q14), a rollup
#: segmented per level (q67) and one that is not (q22), CONCAT (q5, q80),
#: windows and set operations (q47, q38, q87)
REPLAY_UNITS = ["query3", "query9", "query4", "query14_part1",
                "query14_part2", "query22", "query67", "query5", "query80",
                "query47", "query38", "query87"] + sorted(KIND_SQL)


def make_sessions(tmp_path_factory, name: str):
    """(nds_tpu session, port session) over one SF0.01 data set."""
    data = str(tmp_path_factory.mktemp(name) / "sf001")
    datagen.generate(data, 0.01, parallel=2)
    ref = RSession(RConfig(decimal_physical="i64"))
    for table, sch in get_schemas().items():
        ref.register_csv(table, os.path.join(data, table),
                         sch.arrow_schema(use_decimal=True))
    port = nt.Session(nt.EngineConfig(decimal_physical="i64"), device="cpu")
    assert len(datagen.setup_tables(port, data)) == 24
    return ref, port


def ref_plan(ref, sql: str):
    return RPlanner(ref._catalog()).plan_query(rparse_sql(sql))


def check_schedule(ref, port, sql: str) -> None:
    """The port's record pass over its parameterized plan makes the
    reference's decisions, kind and value, and touches the same scans in
    the same order."""
    from nds_tpu.engine.plan import parameterize_plan as rparam
    from nds_tpu_torch.engine.plan import parameterize_plan as pparam
    rplan, rvalues, _ = rparam(ref_plan(ref, sql))
    pplan, pvalues, _ = pparam(port.plan(sql))
    assert pvalues == rvalues
    _, rdec, rkeys = ref._jax_executor().record_plan(rplan, tuple(rvalues))
    _, pdec, pkeys = port._executor().record_plan(pplan, tuple(pvalues))
    assert pdec == rdec
    assert pkeys == rkeys


def check_modes(ref, port, sql: str) -> None:
    """Three runs go through the reference's modes (its compiled replay
    is XLA's, jit-compiled here on the CPU)."""
    want, got = [], []
    for _ in range(3):
        ref.sql(sql, backend="jax")
        want.append(ref.last_exec_stats["mode"])
        port.sql(sql, backend="torch")
        got.append(port.last_stats["mode"])
    assert got == want


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    return make_sessions(tmp_path_factory, "torch_replay")


def lifecycle(port, sql: str, want, runs: int = 3) -> list:
    """`runs` runs of sql, each against `want`; returns their stats."""
    stats = []
    for _ in range(runs):
        got = port.sql(sql, backend="torch")
        assert port.last_fallbacks == []
        assert table_mismatches(got, want) == []
        stats.append(dict(port.last_stats))
    return stats


@pytest.mark.parametrize("name", REPLAY_UNITS)
def test_unit_replays_to_the_oracle_result(sessions, name):
    ref, port = sessions
    sql = KIND_SQL.get(name) or UNITS[name]
    stats = lifecycle(port, sql, ref.sql(sql, backend="numpy"))
    modes = [st["mode"] for st in stats]
    # a query of several units compiles them all before its second run
    # executes any (the reference's precompile): then it says "compiled"
    assert modes[0] == "record"
    assert modes[1] in ("compile+run", "compiled")
    assert modes[2] == "compiled"
    assert "nojit_reason" not in stats[2]


@pytest.mark.parametrize("name", ["query4", "query14_part1", "query67"])
def test_segments_match_the_reference(sessions, name):
    from nds_tpu.engine.jax_backend.executor import JaxExecutor
    ref, port = sessions
    sql = UNITS[name]
    want = [k for k, _ in JaxExecutor(ref.load_table)._segment_plan(
        ref_plan(ref, sql))]
    got = [k for k, _ in port._executor()._segment_plan(port.plan(sql))]
    assert got == want and len(got) > 1


def test_a_second_stream_adopts_the_first_streams_schedule(sessions):
    ref, port = sessions
    sql0 = UNITS["query55"]
    sql1 = dict(streams.template_units(stream=1, rngseed=SEED))["query55"]
    assert sql0 != sql1
    lifecycle(port, sql0, ref.sql(sql0, backend="numpy"))
    want1 = ref.sql(sql1, backend="numpy")
    stats = lifecycle(port, sql1, want1, runs=2)
    assert stats[0]["mode"] == "adopted"
    assert stats[0]["adopted_run"] == "compiled"   # stream 0's program
    assert stats[1]["mode"] == "compiled"
    ex = port._executor()
    assert ex._plans[("sql", sql1)]["cq"] is ex._plans[("sql", sql0)]["cq"]


def test_a_literal_past_the_schedule_records_again(sessions):
    ref, port = sessions
    tpl = ("SELECT ss_store_sk, COUNT(*) AS c FROM store_sales "
           "WHERE ss_quantity < {} GROUP BY ss_store_sk "
           "ORDER BY ss_store_sk")
    narrow, wide = tpl.format(3), tpl.format(90)
    lifecycle(port, narrow, ref.sql(narrow, backend="numpy"))
    verified = []
    real_verify = compiled.verify_schedule

    def verify(decisions, checks):
        try:
            real_verify(decisions, checks)
        except compiled.ReplayMismatch as e:
            verified.append(str(e))
            raise
    compiled.verify_schedule = verify
    try:
        stats = lifecycle(port, wide, ref.sql(wide, backend="numpy"))
    finally:
        compiled.verify_schedule = real_verify
    # the adopted schedule overflowed inside the run: a new record serves it
    assert verified and "capacity overflow" in verified[0]
    assert [st["mode"] for st in stats] == ["record", "compile+run",
                                            "compiled"]


def test_cast_to_string_stays_eager_for_the_reference_reason(sessions):
    ref, port = sessions
    sql = ("SELECT CAST(d_year AS VARCHAR(10)) AS y, COUNT(*) AS c "
           "FROM date_dim WHERE d_year > 1990 "
           "GROUP BY CAST(d_year AS VARCHAR(10))")
    stats = lifecycle(port, sql, ref.sql(sql, backend="numpy"))
    assert [st["mode"] for st in stats] == ["record", "eager", "eager"]
    for _ in range(2):
        ref.sql(sql, backend="jax")
    assert ref.last_exec_stats["mode"] == "eager"
    assert stats[1]["nojit_reason"] == ref.last_exec_stats["nojit_reason"]


def test_concat_under_replay_gives_the_eager_strings():
    """CONCAT under replay codes rows into the cross product of its parts'
    dictionaries (device.CrossDict), nested concatenations flattened into
    one product as the reference's compound column; the host output
    holds the strings the eager form holds, NULL where a part is."""
    import numpy as np
    import torch

    from nds_tpu_torch.engine.plan import BCall, BCol, BLit
    from nds_tpu_torch.engine.torch_backend import exprs
    from nds_tpu_torch.engine.torch_backend.device import (CrossDict, DCol,
                                                           DTable, to_host)
    rng = np.random.default_rng(4)
    n = 64
    words = np.asarray(["ab", "", "c", "ab"], dtype=object)  # a duplicate

    def col(k):
        return DCol("str", torch.from_numpy(rng.integers(0, k, n)
                                            .astype(np.int32)),
                    torch.from_numpy(rng.random(n) < 0.8), words[:k])
    table = DTable(["a", "b"], [col(4), col(3)],
                   torch.ones(n, dtype=torch.bool))
    expr = BCall("str", "concat", [
        BCall("str", "concat", [BCol("str", 0, "a"), BLit("str", "-")]),
        BCol("str", 1, "b")])
    eager = exprs.evaluate(expr, table)
    replay = exprs.evaluate(expr, table, exprs.EvalCtx(replay=True))
    assert isinstance(replay.dictionary, CrossDict)
    assert len(replay.dictionary) == 5 * 2 * 4
    got = to_host(DTable(["s"], [replay], table.alive)).columns[0]
    want = to_host(DTable(["s"], [eager], table.alive)).columns[0]
    assert got.decode().tolist() == want.decode().tolist()
