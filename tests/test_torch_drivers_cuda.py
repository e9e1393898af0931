"""The port's benchmark drivers on the card (marked ``cuda``; they skip
where there is no card).

Run on a machine with an NVIDIA card:

    python -m pytest --noconftest -m cuda tests/test_torch_drivers_cuda.py

At SF0.01: a warm power run (warmup 2, strict) records every query, then
``precompile_parallel`` captures every recorded unit's CUDA graph (all
"compiled"), and every timed run replays one ("compiled"), equal to the
numpy power run; a query over its deadline on the card records Failed
while the next query runs, bit-identical to its run without the overrun
(over a warehouse transcoded with --use_decimal);
and two process-mode streams share the card, each process with a CUDA
context of its own, their outputs equal to numpy runs of the same streams.
At SF0.5, a warm power run of all 103 units after a cold one in the same
process (its schedules adopted from the cold run's, its graphs captured
at first sighting, among them graphs that grow the segment reduction's
scratch after earlier graphs were captured over it) replays a graph on
every timed run, its outputs equal to the cold run's.
"""
import json
import os

import pytest
import torch

from nds_tpu_torch import (datagen, power, resilience, streams, throughput,
                           transcode)
from nds_tpu_torch.engine.torch_backend import cuda_kernels as ck
from nds_tpu_torch.validate import table_mismatches
from torch_drivers_cases import RNGSEED, output_table, property_file
from torch_isolation import isolate_port_programs  # noqa: F401

pytestmark = pytest.mark.cuda

SUB = ["query3", "query7", "query14", "query42", "query96"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the drivers run there")
    ck.build()
    root = tmp_path_factory.mktemp("drivers_cuda")
    datagen.generate(str(root / "csv"), 0.01, parallel=4)
    streams.generate_query_streams(str(root / "streams"), 3, RNGSEED)
    return root


def _names(root, s: int = 0) -> list:
    with open(root / "streams" / f"query_{s}.sql") as f:
        return [n for n in power.gen_sql_from_stream(f.read())
                if n in SUB or n.split("_part")[0] in SUB]


def _numpy_run(root, tag: str, s: int = 0) -> str:
    out = str(root / f"out_np_{tag}")
    power.run_query_stream(str(root / "csv"),
                           str(root / "streams" / f"query_{s}.sql"),
                           str(root / f"time_np_{tag}.csv"),
                           input_format="csv", backend="numpy",
                           output_prefix=out, sub_queries=SUB, device="cpu")
    return out


def test_warm_power_run_replays_graphs_on_every_timed_run(data, capsys):
    ck.reset_launches()
    power.run_query_stream(str(data / "csv"),
                           str(data / "streams" / "query_0.sql"),
                           str(data / "time.csv"), input_format="csv",
                           output_prefix=str(data / "out"),
                           json_summary_folder=str(data / "json"),
                           sub_queries=SUB, warmup=2, strict=True)
    assert all(v > 0 for v in ck.LAUNCHES.values()), ck.LAUNCHES
    [line] = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("precompile:")]
    n = line.split("compiled ")[1].split(" programs")[0].split("/")
    assert n[0] == n[1] and int(n[0]) >= len(SUB), line
    names = _names(data)
    for f in os.listdir(data / "json"):
        with open(data / "json" / f) as fh:
            summary = json.load(fh)
        assert summary["queryStatus"] == ["Completed"], f
        assert [e["mode"] for e in summary["execStats"]] == ["compiled"], f
        assert summary["execStats"][0]["graph_ms"] > 0, f
        assert summary["env"]["host"]["device_name"] == \
            torch.cuda.get_device_name(0)
    want = _numpy_run(data, "power")
    for n in names:
        assert table_mismatches(output_table(str(data / "out"), n),
                                output_table(want, n)) == [], n


def test_a_deadline_overrun_on_the_card_leaves_the_next_query_running(
        data, tmp_path):
    """Over a --use_decimal warehouse, so that the two runs' results
    can be held bit for bit (a float sum's order on the card is not
    fixed, and the CSV's decimals read as doubles); unpartitioned, so
    that query42's first run loads one file a table, well inside its
    deadline."""
    wh = str(tmp_path / "wh")
    transcode.transcode(str(data / "csv"), wh, use_decimal=True,
                        tables=["date_dim", "item", "store_sales"],
                        partition=False)
    props = property_file(str(tmp_path), "slow",
                          fault_points="jax.execute:delay:3#1")
    sub = ["query3", "query42"]
    log = str(tmp_path / "time.csv")
    try:
        power.run_query_stream(wh, str(data / "streams" / "query_0.sql"),
                               log, sub_queries=sub,
                               property_file=props, query_timeout=1.0,
                               output_prefix=str(tmp_path / "out"),
                               json_summary_folder=str(tmp_path / "json"))
    finally:
        resilience.FAULTS.clear()
    statuses = {}
    for f in os.listdir(tmp_path / "json"):
        with open(tmp_path / "json" / f) as fh:
            statuses[f.split("-")[1]] = json.load(fh)
    assert statuses["query3"]["queryStatus"] == ["Failed"]
    assert "DeadlineExceeded" in statuses["query3"]["exceptions"][0]
    assert statuses["query42"]["queryStatus"] == ["Completed"]
    # the same query without the overrun, on a session of its own
    power.run_query_stream(wh, str(data / "streams" / "query_0.sql"),
                           str(tmp_path / "time_clean.csv"),
                           sub_queries=["query42"],
                           output_prefix=str(tmp_path / "clean"))
    got = output_table(str(tmp_path / "out"), "query42")
    want = output_table(str(tmp_path / "clean"), "query42")
    assert got.to_pylist() == want.to_pylist()
    assert table_mismatches(got, want, rtol=0.0) == []
    resilience._drain_abandoned(10.0)


def test_two_process_mode_streams_share_the_card(data, tmp_path):
    logs = str(tmp_path / "logs")
    elapsed = throughput.run_throughput(
        str(data / "csv"), str(data / "streams"), [1, 2], logs,
        input_format="csv", output_prefix=str(tmp_path / "out"),
        sub_queries=SUB, mode="process")
    assert elapsed > 0
    for s in (1, 2):
        want = _numpy_run(data, f"s{s}", s)
        got = str(tmp_path / "out" / f"stream_{s}")
        for n in _names(data, s):
            assert table_mismatches(output_table(got, n),
                                    output_table(want, n)) == [], (s, n)


def test_warm_power_run_over_adopted_schedules_replays_every_unit(tmp_path):
    """All 103 units at SF0.5, cold (warmup 0: every unit records and
    publishes its schedule), then warm in the same process (warmup 2:
    each unit adopts the cold run's schedule and captures its graph at
    first sighting, then replays it): every warm timed run is
    "compiled" (query8's among them), and every warm output equals the
    cold one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the drivers run there")
    ck.build()
    data = str(tmp_path / "csv")
    datagen.generate(data, 0.5, parallel=len(os.sched_getaffinity(0)))
    [stream0] = streams.generate_query_streams(str(tmp_path / "streams"),
                                               1, 3)
    modes = {}
    for tag, warmup in (("cold", 0), ("warm", 2)):
        power.run_query_stream(data, stream0, str(tmp_path / f"{tag}.csv"),
                               input_format="csv",
                               output_prefix=str(tmp_path / f"{tag}_out"),
                               json_summary_folder=str(tmp_path / tag),
                               warmup=warmup, strict=True)
        for f in os.listdir(tmp_path / tag):
            with open(tmp_path / tag / f) as fh:
                summary = json.load(fh)
            assert summary["queryStatus"] == ["Completed"], (tag, f)
            modes[tag, f.split("-")[1]] = [e.get("mode") for e in
                                           summary["execStats"]]
    names = sorted(n for t, n in modes if t == "warm")
    assert len(names) == 103
    assert modes["warm", "query8"] == ["compiled"]
    assert {n: modes["warm", n] for n in names
            if modes["warm", n] != ["compiled"]} == {}
    for n in names:
        assert table_mismatches(output_table(str(tmp_path / "warm_out"), n),
                                output_table(str(tmp_path / "cold_out"), n)
                                ) == [], n
