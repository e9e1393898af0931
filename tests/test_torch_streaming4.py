"""The port's streamed path on the CPU, part 4 of 4: its hazards.

- A string column whose dictionary changes between Parquet row groups:
  the planner never streams a big scan's string column (the reference's
  rule, so nothing needs checking there); with that rule lifted in both
  engines, the port checks each morsel's dictionaries before a replay and
  records again where one changed (re_records), giving the reference's
  result.
- A source that fails on its third morsel frees the group's slot and
  programs, and the next query runs; a staging-thread failure is reported
  in prefetch_error_details and the morsel is staged again.
- The morsel slot stays at one address across morsels and passes, is kept
  out of the resident-scan budget, and the big table is never loaded
  whole.
- ROADMAP C.2: a schedule inflated above a sorted aggregation's input
  rows fails the replay in the reference (its shapes disagree) and in the
  port (ReplayMismatch, which the lifecycle answers by recording again).
See tests/torch_streaming_cases.py."""
import threading
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import torch_streaming_cases as C
from nds_tpu_torch.engine import streaming
from nds_tpu_torch.engine.torch_backend import device as tdevice
from nds_tpu_torch.validate import table_mismatches
from torch_isolation import isolate_port_programs  # noqa: F401


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_streaming4")
    fact = C.make_fact(5)
    return {"fact": (fact, C.write_fact(tmp, fact)),
            "dim": (C.make_dim(), None)}


def dict_fact(tmp) -> tuple:
    """A fact table with a string column `cat` whose values differ per
    8192-row row group (so each row group carries its own dictionary),
    and an exact decimal column."""
    rng = np.random.default_rng(17)
    groups = -(-C.N_FACT // 8192)
    cats = []
    for g in range(groups):
        n = min(8192, C.N_FACT - g * 8192)
        vals = np.array([f"c{g}", f"c{g + 1}", "shared"], dtype=object)
        cats.append(vals[rng.integers(0, 3, n)])
    cat = np.concatenate(cats)
    amt = rng.integers(-10 ** 6, 10 ** 6, C.N_FACT)
    t = pa.table({
        "cat": pa.array(cat.tolist(), type=pa.string()),
        "qty": pa.array(rng.integers(1, 50, C.N_FACT), type=pa.int32()),
        "amt": pa.array([None if i % 29 == 0 else Decimal(v).scaleb(-2)
                         for i, v in enumerate(amt.tolist())],
                        type=pa.decimal128(9, 2)),
    })
    path = str(tmp / "dict_fact.parquet")
    pq.write_table(t, path, row_group_size=8192)
    return t, path


DICT_SQL = ("SELECT cat, COUNT(*) AS n, SUM(qty) AS sq, SUM(amt) AS sa "
            "FROM fact WHERE qty > 3 GROUP BY cat ORDER BY cat")


def _lenient(P):
    """_contains_unsupported without its rule against the big scan's
    string columns."""
    def check(sub, big):
        return any(isinstance(n, (P.WindowNode, P.DistinctNode, P.SetOpNode,
                                  P.AggregateNode))
                   and any(m is big for m in P.iter_plan_nodes(n))
                   for n in P.iter_plan_nodes(sub))
    return check


def test_a_string_column_is_never_streamed_by_the_planner(tmp_path):
    t, path = dict_fact(tmp_path)
    trio = C.sessions({"fact": (t, path)}, decimal_physical="i64")
    C.check(*trio, DICT_SQL, streams=False)
    port = trio[1]
    plan = port.plan(DICT_SQL)
    assert streaming.find_streaming_jobs(
        plan, lambda n: port._est_rows.get(n, 0), C.MIN_ROWS) == []


def test_a_new_dictionary_records_again(tmp_path, monkeypatch):
    import nds_tpu.engine.plan as RP
    import nds_tpu.engine.streaming as rstreaming
    import nds_tpu_torch.engine.plan as PP
    monkeypatch.setattr(rstreaming, "_contains_unsupported", _lenient(RP))
    monkeypatch.setattr(streaming, "_contains_unsupported", _lenient(PP))
    t, path = dict_fact(tmp_path)
    ref, port, incore = C.sessions({"fact": (t, path)},
                                   decimal_physical="i64")
    want, rst = C.run_ref(ref, DICT_SQL)
    got, pst = C.run_port(port, DICT_SQL)
    assert rst["mode"] == "streaming" and pst["mode"] == "streamed"
    assert table_mismatches(got, want) == []
    assert table_mismatches(incore.sql(DICT_SQL), want) == []
    # each row group after the first brings a new dictionary
    assert pst["re_records"] == -(-C.N_FACT // 8192) - 1
    # a warm pass starts on the first row group's dictionary, while the
    # programs hold the last one's: it records again at every row group
    again = port.sql(DICT_SQL)
    assert port.last_stats["re_records"] == -(-C.N_FACT // 8192)
    assert table_mismatches(again, want) == []


def test_a_source_failing_mid_stream_frees_the_slot(tables):
    ref, port, incore = C.sessions(tables)
    orig = port._batch_sources["fact"]

    def failing(columns):
        for i, b in enumerate(orig(columns)):
            if i == 1:      # batches are 8192-row row groups: morsel 3
                raise OSError("source lost")
            yield b
    port._batch_sources["fact"] = failing
    slots = tdevice.open_slots()
    with pytest.raises(OSError, match="source lost"):
        port.sql(C.QUERY)
    assert tdevice.open_slots() == slots
    sent = port._stream_cache[C.QUERY]
    assert all(g["slot"] is None and g["cqs"] is None
               for g in sent["gstates"])
    assert not any(k.startswith(streaming.MORSEL_TABLE)
                   for k in sent["exec"]._scan_cache)
    port._batch_sources["fact"] = orig
    C.check(ref, port, incore, C.QUERY)
    C.check(ref, port, incore, C.GLOBAL)


def test_a_staging_thread_failure_is_reported(tables, monkeypatch):
    ref, port, incore = C.sessions(tables)
    real = tdevice.MorselSlot.stage
    hits = []

    def flaky(self, m):
        if threading.current_thread() is not threading.main_thread() \
                and not hits:
            hits.append(1)
            raise RuntimeError("injected staging failure")
        return real(self, m)
    monkeypatch.setattr(tdevice.MorselSlot, "stage", flaky)
    want, _ = C.run_ref(ref, C.QUERY)
    got, st = C.run_port(port, C.QUERY)
    assert table_mismatches(got, want) == []
    assert st["prefetch_error_details"] == [
        "RuntimeError: injected staging failure"]
    assert st["morsels"] == C.PER_PASS


def test_the_slot_is_fixed_and_out_of_the_scan_budget(tables):
    """The slot keeps its addresses across morsels and passes; with a
    budget too small for any scan, the small tables are evicted and
    loaded again, but the slot never counts against it and the big table
    is never loaded whole."""
    ref, port, incore = C.sessions(tables, scan_budget_gb=1e-7)
    loads = []
    real = port.load_table

    def load(name, columns=None):
        loads.append(name)
        return real(name, columns)
    port.load_table = load
    want, _ = C.run_ref(ref, C.SCALAR)
    got, st = C.run_port(port, C.SCALAR)
    assert table_mismatches(got, want) == []
    ex = port._stream_cache[C.SCALAR]["exec"]
    slot = port._stream_cache[C.SCALAR]["gstates"][0]["slot"]
    ptrs = [t.data_ptr() for t in [slot.table.alive] + [
        c.data for c in slot.table.cols]]
    assert not any(k.startswith(streaming.MORSEL_TABLE)
                   for k in ex._resident)
    port.sql(C.SCALAR)
    assert port._stream_cache[C.SCALAR]["gstates"][0]["slot"] is slot
    assert ptrs == [t.data_ptr() for t in [slot.table.alive] + [
        c.data for c in slot.table.cols]]
    assert port.last_stats["re_records"] == 0
    assert "fact" not in loads


def test_an_inflated_schedule_over_a_smaller_input_fails_the_replay():
    """ROADMAP C.2. inflate_schedule raises a sorted aggregation's cap
    decision to the morsel bound; over an input of fewer rows (a
    dimension-sized aggregate inside a morsel program, or an adopted
    schedule of a larger data set) the reference's replay fails (its
    output shapes disagree, TypeError), and so does the port's: it raises
    ReplayMismatch, where it used to clip the capacity silently. The
    lifecycle then records again, so the query's result is the eager
    one."""
    from nds_tpu.config import EngineConfig as RConfig
    from nds_tpu.engine import Session as RSession
    from nds_tpu.engine import streaming as rstreaming
    from nds_tpu.engine.jax_backend.executor import CompiledQuery as RCQ
    from nds_tpu.engine.jax_backend.executor import JaxExecutor
    from nds_tpu.engine.planner import Planner as RPlanner
    from nds_tpu.sql import parse_sql as rparse
    import nds_tpu_torch as nt
    from nds_tpu_torch.engine.torch_backend.compiled import (CompiledQuery,
                                                             ReplayMismatch)
    from nds_tpu_torch.engine.torch_backend.device import to_host

    rng = np.random.default_rng(1)
    n = 10_000              # capacity 16384: the sorted aggregation
    t = pa.table({"k": pa.array(rng.integers(0, 50, n), type=pa.int32()),
                  "v": pa.array(rng.integers(0, 100, n), type=pa.int64())})
    sql = "SELECT k, SUM(v) s, COUNT(*) c FROM t GROUP BY k ORDER BY k"
    bound = 1 << 20
    ref = RSession(RConfig(out_of_core=False))
    ref.register_arrow("t", t)
    rex = JaxExecutor(ref.load_table, jit_plans=True)
    rplan = RPlanner(ref._catalog()).plan_query(rparse(sql))
    _, rdec, rkeys = rex.record_plan(rplan)
    rinf = rstreaming.inflate_schedule(rdec, bound)
    assert any(k == "cap" and v == bound for k, v in rinf)
    with pytest.raises(TypeError, match="incompatible shapes"):
        RCQ(rplan, rinf, rkeys).run(rex._scans_for({"scan_keys": rkeys}))

    port = nt.Session(nt.EngineConfig(out_of_core=False), device="cpu")
    port.register_arrow("t", t)
    ex = port._executor()
    plan = port.plan(sql)
    eager, dec, keys = ex.record_plan(plan)
    assert dec == rdec
    inf = streaming.inflate_schedule(dec, bound)
    with pytest.raises(ReplayMismatch, match="groups over 16384 input"):
        CompiledQuery(plan, inf, keys, ex).run(ex._scans_for(
            {"scan_keys": keys}))
    # the recorded schedule itself replays to the eager result
    got = CompiledQuery(plan, dec, keys, ex).run(ex._scans_for(
        {"scan_keys": keys}))
    assert table_mismatches(to_host(got), to_host(eager)) == []
    assert table_mismatches(port.sql(sql), ref.sql(sql, backend="numpy")) \
        == []
