"""The port's power runner under failures, and its pieces, at SF0.001 on
the CPU.

An injected fault records Failed and the stream goes on; a transient one
is retried; ``resume`` keeps the Power Start Time; a query over its
deadline records Failed (DeadlineExceeded) while its abandoned worker
stops before its next device work and the next query runs, equal to the
numpy oracle. Also: every option the port has not yet raises naming its
ROADMAP item before any query runs (Data Maintenance's options, ported
since, are held against the reference in their place); without CUDA the runner raises unless
the CPU is asked for; ``precompile_parallel`` compiles every recorded
unit; the per-program device-time registry; the property file; the
datagen CLI; the report's host capture and the preflight checks.
"""
import json
import os
import threading
import time

import pytest
import torch

import nds_tpu_torch as nt
from nds_tpu_torch import check, datagen, power, resilience, transcode
from nds_tpu_torch.config import EngineConfig, apply_decimal
from nds_tpu_torch.engine.torch_backend.compiled import StatementAbandoned
from nds_tpu_torch.obs import device_time
from nds_tpu_torch.report import BenchReport
from nds_tpu_torch.validate import table_mismatches
from nds_tpu_torch.warehouse import Warehouse
from torch_drivers_cases import (log_rows, make_data, output_table,
                                 property_file, stream)
from torch_isolation import isolate_port_programs  # noqa: F401

SUB = ["query3", "query42"]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return make_data(str(tmp_path_factory.mktemp("drivers2")))


@pytest.fixture(autouse=True)
def disarm_faults():
    yield
    resilience.FAULTS.clear()


def _run(paths, tmp_path, tag, **kw):
    kw.setdefault("property_file", paths["cpu"])
    return power.run_query_stream(
        paths["csv"], stream(paths), str(tmp_path / f"time_{tag}.csv"),
        input_format="csv", sub_queries=kw.pop("sub_queries", SUB),
        json_summary_folder=str(tmp_path / f"json_{tag}"), **kw)


def _summary(tmp_path, tag, name) -> dict:
    folder = tmp_path / f"json_{tag}"
    [f] = [f for f in os.listdir(folder) if f.split("-")[1] == name]
    with open(folder / f) as fh:
        return json.load(fh)


def test_injected_fault_fails_the_query_and_the_stream_goes_on(paths,
                                                               tmp_path):
    rows = _run(paths, tmp_path, "fi", fault_inject=["query3"])
    assert [r[0] for r in rows] == SUB
    failed = _summary(tmp_path, "fi", "query3")
    assert failed["queryStatus"] == ["Failed"]
    assert "FaultError" in failed["exceptions"][0]
    assert _summary(tmp_path, "fi", "query42")["queryStatus"] == \
        ["Completed"]
    assert log_rows(str(tmp_path / "time_fi.csv"))[-1][0] == \
        "Power Test Time"


def test_a_transient_fault_is_retried(paths, tmp_path):
    resilience.FAULTS.arm(resilience.FaultSpec(point="query.run",
                                               match="query3", times=1))
    _run(paths, tmp_path, "retry", query_attempts=2)
    s = _summary(tmp_path, "retry", "query3")
    assert s["attempts"] == [2]
    assert s["retriedStatus"] == [["Failed", "Completed"]]
    assert s["queryStatus"] == ["CompletedWithTaskFailures"]


def test_resume_keeps_the_power_start_time(paths, tmp_path):
    """(The full run also writes a torch.profiler trace a query, the span
    trace and the query log.)"""
    from nds_tpu_torch.obs.query_log import QUERY_LOG
    from nds_tpu_torch.obs.trace import TRACER
    try:
        _run(paths, tmp_path, "full", profile_folder=str(tmp_path / "prof"),
             trace=str(tmp_path / "trace.json"),
             query_log=str(tmp_path / "qlog.jsonl"))
    finally:
        TRACER.configure(enabled=False)
        QUERY_LOG.configure(enabled=False, path="")
    assert sorted(os.listdir(tmp_path / "prof")) == \
        [f"{n}.json" for n in sorted(SUB)]
    with open(tmp_path / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    with open(tmp_path / "qlog.jsonl") as f:
        assert len(f.read().splitlines()) == len(SUB)
    log = str(tmp_path / "time_full.csv")
    rows = log_rows(log)
    # an interrupted run: the start sentinel and the first query only
    partial = str(tmp_path / "time_resume.csv")
    power._write_time_log(partial, int(rows[1][1]),
                          [tuple(int(x) if x.isdigit() else x
                                 for x in rows[2])], None)
    got = power.run_query_stream(
        paths["csv"], stream(paths), partial, input_format="csv",
        sub_queries=SUB, property_file=paths["cpu"], resume=True)
    assert [r[0] for r in got] == SUB
    resumed = log_rows(partial)
    assert resumed[1] == rows[1]                 # Power Start Time kept
    assert resumed[2] == rows[2]                 # query3 not run again
    assert resumed[3][0] == "query42"
    assert int(resumed[-1][3]) == int(resumed[-2][1]) - int(rows[1][1])


def test_a_query_over_its_deadline_fails_and_the_next_runs(paths, tmp_path):
    """query3's first device step sleeps 3 s past its 1 s budget: it
    records Failed (DeadlineExceeded), query42 runs at once on a fresh
    executor, equal to the numpy oracle, and the abandoned worker stops
    before its next device work."""
    props = property_file(str(tmp_path), "slow", device="cpu",
                          fault_points="jax.execute:delay:3#1")
    _run(paths, tmp_path, "np", backend="numpy", property_file=paths["cpu"],
         output_prefix=str(tmp_path / "out_np"))
    _run(paths, tmp_path, "slow", property_file=props, query_timeout=1.0,
         output_prefix=str(tmp_path / "out"))
    s = _summary(tmp_path, "slow", "query3")
    assert s["queryStatus"] == ["Failed"]
    assert "DeadlineExceeded" in s["exceptions"][0]
    assert _summary(tmp_path, "slow", "query42")["queryStatus"] == \
        ["Completed"]
    assert table_mismatches(output_table(str(tmp_path / "out"), "query42"),
                            output_table(str(tmp_path / "out_np"),
                                         "query42")) == []
    resilience._drain_abandoned(10.0)


def test_an_abandoned_statement_stops_before_its_next_device_work(paths):
    session = nt.Session(EngineConfig(), device="cpu")
    power.setup_tables(session, paths["csv"], "csv")
    sql = power.gen_sql_from_stream(open(stream(paths)).read())["query3"]
    want = session.sql(sql, backend="numpy")
    spec = resilience.FAULTS.arm(resilience.FaultSpec(
        point="jax.execute", action="delay", seconds=1.5, times=1))
    box = {}

    def work():
        try:
            box["out"] = session.sql(sql)
        except BaseException as e:
            box["error"] = e
    worker = threading.Thread(target=work)
    worker.start()
    while not spec.fired:             # the worker sleeps in its record pass
        time.sleep(0.01)
    old = session._executor()
    session.abandon_inflight()
    assert old.abandoned
    got = session.sql(sql)                # a fresh executor, at once
    assert session._exec is not old
    assert table_mismatches(got, want) == []
    worker.join(10)
    assert isinstance(box.get("error"), StatementAbandoned), box


#: the cases of Data Maintenance's options, ported since: each holds the
#: port against the reference (_ported_case)
PORTED = ("warehouse", "maintenance", "datagen_update")


def _ported_case(paths, tmp_path, case):
    """warehouse: DML through sql() raises as the reference's does and
    execute() of it commits one version, as the reference's; maintenance:
    setup_tables(maintenance=True) registers the staging tables the
    reference's registers, with the same rows; datagen_update: the
    datagen CLI's --update writes the reference's refresh set."""
    import filecmp

    from nds_tpu import datagen as rdatagen
    from nds_tpu import power as rpower
    from nds_tpu import transcode as rtranscode
    from nds_tpu.engine import Session as RSession
    from nds_tpu.sql.parser import SqlParseError as RSqlParseError
    from nds_tpu.warehouse import Warehouse as RWarehouse
    from nds_tpu_torch.sql.parser import SqlParseError
    sides = (("port", lambda: nt.Session(device="cpu"), transcode,
              Warehouse, SqlParseError, power, datagen),
             ("ref", RSession, rtranscode, RWarehouse, RSqlParseError,
              rpower, rdatagen))
    seen = {}
    for side, session, tc, wh_cls, err, pw, dg in sides:
        if case == "warehouse":
            wh = str(tmp_path / f"wh_{side}")
            tc.transcode(paths["csv"], wh, tables=["store"])
            s = session()
            s.attach_warehouse(wh_cls(wh))
            sql = "INSERT INTO store SELECT * FROM store"
            with pytest.raises(err, match="expected a SELECT query"):
                s.sql(sql)
            with s.warehouse.transaction(committer="dml"):
                s.execute(sql)
            s.refresh_warehouse()
            seen[side] = (s.warehouse.current_version(),
                          s.warehouse.table("store").read().num_rows)
        elif case == "maintenance":
            upd = str(tmp_path / "upd")
            if not os.path.exists(upd):
                datagen.generate(upd, 0.01, 1, update=1)
            s = session()
            names = sorted(pw.setup_tables(s, upd, "csv", maintenance=True))
            n = s.sql("SELECT COUNT(*) AS n FROM s_purchase_lineitem",
                      backend="numpy").columns[0].data.tolist()
            seen[side] = (names, n)
        else:
            out = str(tmp_path / f"upd_{side}")
            dg.main(["local", out, "--scale", "0.01", "--parallel", "1",
                     "--update", "1"])
            seen[side] = sorted(os.path.relpath(os.path.join(r, f), out)
                                for r, _, fs in os.walk(out) for f in fs)
    assert seen["port"] == seen["ref"]
    if case == "warehouse":
        assert seen["port"][0] == 1
    elif case == "maintenance":
        assert "s_purchase_lineitem" in seen["port"][0]
    else:
        assert len(seen["port"]) == len(datagen.MAINTENANCE_TABLES)
        for rel in seen["port"]:
            assert filecmp.cmp(str(tmp_path / "upd_port" / rel),
                               str(tmp_path / "upd_ref" / rel),
                               shallow=False), rel


@pytest.mark.parametrize("case", [
    "explain", "verify_plans", "mesh_shards", "warehouse", "maintenance",
    "datagen_hosts", "datagen_update"])
def test_unported_options_raise_naming_their_roadmap_item(paths, tmp_path,
                                                          case):
    """The options not ported yet raise naming their ROADMAP item before
    any query runs. Data Maintenance's (DML over the warehouse, the
    staging tables, datagen --update) are ported: their cases hold the
    port against the reference (_ported_case)."""
    log = str(tmp_path / "time.csv")
    if case in PORTED:
        _ported_case(paths, tmp_path, case)
        assert not os.path.exists(log)
        return
    item = {"explain": "A.5", "verify_plans": "A.5", "mesh_shards": "A.4",
            "datagen_hosts": "A.6"}[case]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        if case == "datagen_hosts":
            datagen.main(["hosts", str(tmp_path / "d"), "--update", "0"])
        else:
            kw = {"explain": {"explain": True},
                  "verify_plans": {"verify_plans": "final"},
                  "mesh_shards": {"mesh_shards": 2}}[case]
            power.run_query_stream(paths["csv"], stream(paths), log,
                                   input_format="csv", device="cpu", **kw)
    assert not os.path.exists(log)              # before any query ran


def test_without_cuda_the_runner_raises_unless_asked_for_the_cpu(
        paths, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    log = str(tmp_path / "time.csv")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        power.main([paths["csv"], stream(paths), log, "--input_format",
                    "csv", "--sub_queries", "query3"])
    assert not os.path.exists(log)
    assert power.main([paths["csv"], stream(paths), log, "--input_format",
                       "csv", "--sub_queries", "query3", "--property_file",
                       paths["cpu"]]) == 0


def test_precompile_parallel_compiles_every_recorded_unit(paths):
    session = nt.Session(EngineConfig(), device="cpu")
    power.setup_tables(session, paths["csv"], "csv")
    queries = power.gen_sql_from_stream(open(stream(paths)).read())
    ex = session._executor()
    assert ex.precompile_parallel() == {}
    for name in ("query3", "query14_part1"):
        session.sql(queries[name], label=name)
        assert session.last_stats["mode"] == "record"
    res = session._executor().precompile_parallel()
    assert len(res) >= 3 and set(res.values()) == {"compiled"}, res
    assert session._executor().precompile_parallel() == {}
    device_time.PROGRAMS.reset()
    for name in ("query3", "query14_part1"):
        session.sql(queries[name], label=name)
        assert session.last_stats["mode"] == "compiled"
    rows = device_time.PROGRAMS.table()
    labels = {r["program"] for r in rows}
    assert "query3" in labels and "query14_part1/root" in labels, labels
    assert all(r["runs"] == 1 and "roofline_frac" not in r for r in rows)
    assert "query14_part1/root" in device_time.format_table(rows)
    assert device_time.coverage(rows, sum(r["device_ms"] for r in rows)) \
        == pytest.approx(1.0)
    ms = device_time.measure_ms(lambda: torch.ones(4).sum(), iters=2,
                                label="probe")
    assert ms >= 0 and device_time.PROGRAMS.snapshot()["probe"].runs == 2


def test_property_file_sets_the_ports_fields(tmp_path):
    path = property_file(str(tmp_path), "p", device="cpu",
                         gpu_kernels="sort,gather", query_timeout_s="2.5",
                         fault_points="a:raise,b:hang", jit_plans="false",
                         not_a_field="1")
    with open(path, "a") as f:
        f.write("# a comment\nspark.other=x\n")
    cfg = EngineConfig.from_property_file(path)
    assert (cfg.device, cfg.gpu_kernels, cfg.query_timeout_s,
            cfg.fault_points, cfg.jit_plans) == \
        ("cpu", ("sort", "gather"), 2.5, ("a:raise", "b:hang"), False)
    assert EngineConfig.from_property_file(None) == EngineConfig()
    apply_decimal(cfg, "f64")
    assert cfg.decimal_physical == "f64"
    with pytest.raises(ValueError):
        apply_decimal(cfg, "f32")


def test_datagen_cli_ranges_and_overwrite(tmp_path):
    d = str(tmp_path / "d")
    for r in ("1,1", "2,2"):
        assert datagen.main(["local", d, "--scale", "0.001", "--parallel",
                             "2", "--range", r]) == 0
    assert sorted(f for f in os.listdir(os.path.join(d, "store_sales"))) \
        == ["store_sales_1_2.dat", "store_sales_2_2.dat"]
    with pytest.raises(FileExistsError):
        datagen.main(["local", d, "--scale", "0.001", "--parallel", "2"])
    assert datagen.main(["local", d, "--scale", "0.001", "--parallel", "1",
                         "--overwrite"]) == 0
    assert os.listdir(os.path.join(d, "store_sales")) == ["store_sales.dat"]
    with pytest.raises(ValueError):
        datagen.valid_range("2,1", 2)


def test_report_host_capture_and_preflight_checks(tmp_path):
    r = BenchReport(EngineConfig(device="cpu"), app_name="x")
    host = r.summary["env"]["host"]
    assert host["device_name"] == "cpu" and host["torch"] == torch.__version__
    if not torch.cuda.is_available():
        assert not torch.cuda.is_initialized()
    check.check_json_summary_folder(str(tmp_path / "none"))
    (tmp_path / "full").mkdir()
    (tmp_path / "full" / "x.json").write_text("{}")
    with pytest.raises(RuntimeError, match="not empty"):
        check.check_json_summary_folder(str(tmp_path / "full"))
    with pytest.raises(RuntimeError, match="query7"):
        check.check_query_subset_exists({"query1": ""}, ["query7"])
    assert check.check_query_subset_exists({"query14_part1": ""},
                                           ["query14"])
