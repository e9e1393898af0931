"""The port's throughput runner at SF0.001 on the CPU.

Streams 1 and 2 run in each of the three modes: ``thread`` (a Session per
stream thread), ``service`` (every stream through one QueryService over
one Session) and ``process`` (one ``python -m nds_tpu_torch.power`` a
stream, put on the CPU by a property file with ``nds.tpu.device=cpu``).
Each reports max(end) - min(start) over the streams' time logs; every
mode's outputs validate against the same streams' numpy runs. Strict, a
stream whose statements fall back to the host fails in every mode. A
stream that fails for good raises ThroughputError with the elapsed over
the streams that completed, and the supervisor kills a stream past its
budget.
"""
import csv
import os
import sys

import pytest

from nds_tpu_torch import resilience, throughput, validate
from nds_tpu_torch.power import gen_sql_from_stream
from nds_tpu_torch.validate import table_mismatches
from torch_drivers_cases import (log_rows, make_data, output_table,
                                 property_file, stream)
from torch_isolation import isolate_port_programs  # noqa: F401

SUB = ["query3", "query96"]
STREAMS = [1, 2]
#: a statement the device path does not cover (a window function over
#: strings): its node falls back to the host
FALLBACK_SQL = ("SELECT s_store_sk, COUNT(s_store_name) OVER "
                "(PARTITION BY s_state) AS m FROM store")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("drivers3")
    paths = make_data(str(root))
    # the numpy runs every mode's outputs are held against
    throughput.run_throughput(paths["csv"], paths["streams"], STREAMS,
                              str(root / "logs_np"), input_format="csv",
                              output_prefix=str(root / "out_np"),
                              sub_queries=SUB, backend="numpy",
                              mode="thread", device="cpu")
    paths["out_np"] = str(root / "out_np")
    return paths


def _span(log: str) -> tuple:
    rows = {r[0]: r for r in log_rows(log)}
    return int(rows["Power Start Time"][1]), int(rows["Power End Time"][1])


def _names(paths, s: int) -> list:
    with open(stream(paths, s)) as f:
        return [n for n in gen_sql_from_stream(f.read())
                if n in SUB]


@pytest.mark.parametrize("mode", ["thread", "service", "process"])
def test_throughput_modes_report_the_streams_span(paths, tmp_path, mode):
    logs = str(tmp_path / "logs")
    out = str(tmp_path / "out")
    kw = {"property_file": paths["cpu"]} if mode == "process" \
        else {"device": "cpu"}
    elapsed = throughput.run_throughput(
        paths["csv"], paths["streams"], STREAMS, logs, input_format="csv",
        output_prefix=out, sub_queries=SUB, mode=mode, strict=True, **kw)
    spans = [_span(throughput.stream_log_path(logs, s)) for s in STREAMS]
    assert elapsed == (max(e for _, e in spans)
                       - min(s for s, _ in spans)) / 1000.0
    assert elapsed == throughput.throughput_elapsed(
        [throughput.stream_log_path(logs, s) for s in STREAMS])
    with open(throughput.status_csv_path(logs)) as f:
        assert [r["status"] for r in csv.DictReader(f)] == \
            ["Completed"] * len(STREAMS)
    for s in STREAMS:
        names = _names(paths, s)
        rows = log_rows(throughput.stream_log_path(logs, s))
        assert [r[0] for r in rows[2:-2]] == names
        got = os.path.join(out, f"stream_{s}")
        want = os.path.join(paths["out_np"], f"stream_{s}")
        status = validate.iterate_queries(want, got, names)
        assert set(status.values()) == {"Pass"}, status
        for n in names:
            assert table_mismatches(output_table(got, n),
                                    output_table(want, n)) == [], n


@pytest.mark.parametrize("mode", ["thread", "service", "process"])
def test_strict_fails_a_stream_that_falls_back_to_the_host(paths, tmp_path,
                                                           mode):
    sdir = tmp_path / "streams"
    sdir.mkdir()
    for s in STREAMS:
        (sdir / f"query_{s}.sql").write_text(
            "-- start query 1 using template query96.tpl\n"
            f"{FALLBACK_SQL};\n")
    kw = {"property_file": paths["cpu"]} if mode == "process" \
        else {"device": "cpu"}
    with pytest.raises(throughput.ThroughputError) as err:
        throughput.run_throughput(
            paths["csv"], str(sdir), STREAMS, str(tmp_path / "strict"),
            input_format="csv", mode=mode, strict=True, max_attempts=1,
            **kw)
    assert err.value.failed == STREAMS
    # not strict, the same streams complete (their statements on the host)
    assert throughput.run_throughput(
        paths["csv"], str(sdir), STREAMS, str(tmp_path / "lenient"),
        input_format="csv", mode=mode, max_attempts=1, **kw) > 0


def test_a_failed_stream_raises_with_the_partial_elapsed(paths, tmp_path):
    props = property_file(str(tmp_path), "fail2", device="cpu",
                          fault_points="stream.spawn:raise/2")
    logs = str(tmp_path / "logs")
    try:
        with pytest.raises(throughput.ThroughputError) as err:
            throughput.run_throughput(
                paths["csv"], paths["streams"], STREAMS, logs,
                input_format="csv", sub_queries=SUB, property_file=props,
                mode="thread")
    finally:
        resilience.FAULTS.clear()
    assert err.value.failed == [2]
    start, end = _span(throughput.stream_log_path(logs, 1))
    assert err.value.partial_elapsed == (end - start) / 1000.0
    with open(throughput.status_csv_path(logs)) as f:
        rows = list(csv.DictReader(f))
    assert [(r["stream"], r["status"]) for r in rows] == \
        [("1", "Completed"), ("2", "Failed")]
    assert "spawn" in rows[1]["error"]


def test_the_supervisor_kills_a_stream_past_its_budget():
    st = throughput.supervise_processes(
        [(1, [sys.executable, "-c", "import time; time.sleep(60)"]),
         (2, [sys.executable, "-c", "pass"])], stream_timeout=1.0)
    assert [(s.stream, s.status) for s in st] == \
        [(1, "TimedOut"), (2, "Completed")]


def test_throughput_cli(paths, tmp_path, capsys):
    assert throughput.main([paths["csv"], paths["streams"], "1",
                            str(tmp_path / "logs"), "--input_format", "csv",
                            "--sub_queries", "query96", "--mode", "thread",
                            "--property_file", paths["cpu"]]) == 0
    assert "Throughput Test Time:" in capsys.readouterr().out
    with pytest.raises(ValueError, match="property file"):
        throughput.run_throughput(paths["csv"], paths["streams"], [1],
                                  str(tmp_path / "l2"), mode="process",
                                  device="cpu")
