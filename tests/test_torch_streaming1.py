"""The port's streamed (out-of-core) path on the CPU, part 1 of 4: the
cases of tests/test_streaming.py over one fact table in ~13 morsels —
grouped and global aggregates, ROLLUP, a window above the aggregate, and
plans with no streaming job, which run in-core (ROADMAP C.1). The
planner's eligibility rules hold for the port's copy of the planner. The
packed-lane round trip (test_pack_table_roundtrip) is in
tests/test_torch_lanes1.py. See tests/torch_streaming_cases.py."""
import pytest

import torch_streaming_cases as C
from torch_isolation import isolate_port_programs  # noqa: F401


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_streaming1")
    fact = C.make_fact(5)
    return C.sessions({"fact": (fact, C.write_fact(tmp, fact)),
                       "dim": (C.make_dim(), None)})


@pytest.mark.parametrize("name", ["QUERY", "GLOBAL", "ROLLUP",
                                  "WINDOW_ABOVE"])
def test_streamed_matches_the_reference(trio, name):
    rst, pst = C.check(*trio, getattr(C, name))
    if name == "QUERY":
        assert pst["morsels"] == C.PER_PASS
    assert pst["re_records"] == 0


def test_ineligible_plans_run_incore(trio):
    """A big scan under a plan with no streaming job (a distinct
    aggregate) runs in-core on the port, as on the reference (C.1)."""
    C.check(*trio, C.DISTINCT, streams=False)
    port = trio[1]
    assert port.last_stats["mode"] in ("record", "compile+run", "compiled",
                                       "eager")


def test_a_big_scan_without_a_job_runs_incore_at_the_default_settings(
        tmp_path):
    """C.1 at the shipped defaults (out_of_core on, 48M rows): a scan
    whose table is registered above the threshold, under a plan that has
    no streaming job (a window over the big scan), no longer raises; it
    runs in-core and equals the reference."""
    fact = C.make_fact(5)
    path = C.write_fact(tmp_path, fact)
    sql = ("SELECT fk, day, RANK() OVER (PARTITION BY fk ORDER BY day) rk "
           "FROM fact WHERE fk < 3 ORDER BY fk, day, rk")
    from nds_tpu.config import EngineConfig as RConfig
    from nds_tpu.engine import Session as RSession
    import nds_tpu_torch as nt
    from nds_tpu_torch.validate import table_mismatches
    ref = RSession(RConfig(narrow_lanes=False))
    port = nt.Session(nt.EngineConfig(), device="cpu")
    assert port.config.out_of_core
    assert port.config.out_of_core_min_rows == 48_000_000
    for s in (ref, port):
        s.register_parquet("fact", path, est_rows=133_110_000)
        s.register_arrow("dim", C.make_dim())
    want = ref.sql(sql, backend="jax")
    got = port.sql(sql)
    assert ref.last_exec_stats["mode"] != "streaming"
    assert port.last_stats["mode"] == "record"
    assert "stream_refused" not in port.last_stats
    assert table_mismatches(got, want) == []


def test_eligibility_rules():
    """tests/test_streaming.py's eligibility rules, on the port's planner
    and streaming module."""
    from nds_tpu_torch.engine.planner import Catalog, Planner
    from nds_tpu_torch.engine.streaming import try_streaming_plan
    from nds_tpu_torch.sql import parse_sql

    catalog = Catalog({
        "big": (["k", "v"], ["int", "float"], 10_000_000),
        "small": (["k", "g"], ["int", "int"], 100),
    })
    est = {"big": 10_000_000, "small": 100}.get

    def plan(sql):
        return Planner(catalog).plan_query(parse_sql(sql))

    ok = try_streaming_plan(
        plan("SELECT g, SUM(v) FROM big JOIN small ON big.k = small.k "
             "GROUP BY g"), est, 1 << 20)
    assert ok is not None and ok.big_table == "big"
    rp = try_streaming_plan(
        plan("SELECT k, SUM(v) FROM big GROUP BY ROLLUP(k)"), est, 1 << 20)
    assert rp is not None and rp.partial_plan.rollup
    assert try_streaming_plan(
        plan("SELECT g, s, rank() OVER (ORDER BY s DESC) FROM "
             "(SELECT g, SUM(v) s FROM big JOIN small ON big.k = small.k "
             "GROUP BY g) t"), est, 1 << 20) is not None
    assert try_streaming_plan(
        plan("SELECT g, SUM(v) FROM big RIGHT JOIN small ON big.k = small.k "
             "GROUP BY g"), est, 1 << 20) is None
    catalog2 = Catalog({"a": (["k"], ["int"], 10_000_000),
                        "b": (["k"], ["int"], 10_000_000)})
    assert try_streaming_plan(
        Planner(catalog2).plan_query(
            parse_sql("SELECT COUNT(*) FROM a JOIN b ON a.k = b.k")),
        {"a": 10_000_000, "b": 10_000_000}.get, 1 << 20) is None


def test_warm_runs_reuse_the_programs(trio):
    """A second run of a streamed query records nothing again: the
    group's programs and its slot are kept (on the card, no capture)."""
    _ref, port, _incore = trio
    port.sql(C.QUERY)
    first = dict(port.last_stats)
    port.sql(C.QUERY)
    again = dict(port.last_stats)
    assert first["mode"] == again["mode"] == "streamed"
    assert again["re_records"] == 0 and again["captures"] == 0
    assert again["morsels"] == C.PER_PASS
    assert again["bytes_uploaded"] == first["bytes_uploaded"] > 0
