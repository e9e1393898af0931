"""The port's query streams and power runner against nds_tpu's, at SF0.001
on the CPU.

The stream files are byte-identical to the reference's, and so is their
parsing. The port's power run (``backend="torch"`` on the CPU, where each
CUDA kernel's plain version stands in) and the reference's (``backend=
"jax"``) write outputs that pass the reference's validator and are equal
under the port's rules, with the same Parquet schema: over plain per-table
Parquet with exact decimals (integers and decimals bit-identical), and over
CSV, whose decimals both read as doubles (integers bit-identical, floats
to rtol 1e-9). Their time logs have the same labels and sentinel rows, and
their JSON summaries the same keys but for the host capture's runtime
keys. A warm power run (record all, compile ahead, then compiled runs)
over CSV, and over a warehouse transcoded with ``--use_decimal``,
validates against the port's numpy power run over the same input.
"""
import json
import os

import pyarrow.parquet as pq
import pytest

from nds_tpu import power as rpower
from nds_tpu import streams as rstreams
from nds_tpu import validate as rvalidate
from nds_tpu_torch import power, streams, transcode, validate
from nds_tpu_torch.validate import table_mismatches
from test_e2e_power import SUBSET
from torch_drivers_cases import (RNGSEED, log_rows, make_data, output_table,
                                 stream)
from torch_isolation import isolate_port_programs  # noqa: F401

#: the tables SUBSET and query14 read, for a quicker Load Test
WAREHOUSE_TABLES = ["catalog_sales", "customer", "date_dim",
                    "household_demographics", "item", "store",
                    "store_returns", "store_sales", "time_dim",
                    "web_sales"]
#: the host capture's runtime keys (jax in the reference, torch and the
#: card in the port)
RUNTIME_KEYS = {"jax", "jax_backend", "torch", "torch_cuda", "device_name",
                "device_count"}


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return make_data(str(tmp_path_factory.mktemp("drivers1")))


def _runs(paths, root: str, input_format: str) -> dict:
    """The reference's and the port's power runs over the Parquet data
    (exact decimals) or the CSV data, each with outputs, a time log and
    JSON summaries."""
    out = {}
    for side, fn, backend in (("ref", rpower.run_query_stream, "jax"),
                              ("port", power.run_query_stream, "torch")):
        kw = {"device": "cpu"} if side == "port" else {}
        rows = fn(paths[input_format], stream(paths),
                  os.path.join(root, f"time_{side}.csv"),
                  input_format=input_format, backend=backend, decimal="i64",
                  output_prefix=os.path.join(root, f"out_{side}"),
                  json_summary_folder=os.path.join(root, f"json_{side}"),
                  sub_queries=SUBSET, **kw)
        out[side] = {"rows": rows,
                     "log": os.path.join(root, f"time_{side}.csv"),
                     "out": os.path.join(root, f"out_{side}"),
                     "json": os.path.join(root, f"json_{side}")}
    return out


@pytest.fixture(scope="module")
def runs(paths, tmp_path_factory):
    return _runs(paths, str(tmp_path_factory.mktemp("drivers1_runs")),
                 "parquet")


@pytest.fixture(scope="module")
def csv_runs(paths, tmp_path_factory):
    return _runs(paths, str(tmp_path_factory.mktemp("drivers1_csv_runs")),
                 "csv")


@pytest.mark.parametrize("template", [None, 14])
def test_stream_files_are_byte_identical_to_the_reference(tmp_path,
                                                          template):
    got = streams.generate_query_streams(str(tmp_path / "port"), 3, RNGSEED,
                                         template=template)
    want = rstreams.generate_query_streams(str(tmp_path / "ref"), 3,
                                           RNGSEED, template=template)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        with open(g, "rb") as fg, open(w, "rb") as fw:
            assert fg.read() == fw.read()


def test_streams_cli_writes_the_same_files(tmp_path, paths):
    assert streams.main([str(tmp_path), "--streams", "3", "--rngseed",
                         str(RNGSEED)]) == 0
    for i in range(3):
        with open(tmp_path / f"query_{i}.sql", "rb") as f, \
                open(stream(paths, i), "rb") as g:
            assert f.read() == g.read()


def test_stream_parsing_equals_the_reference(paths):
    for i in range(3):
        with open(stream(paths, i)) as f:
            text = f.read()
        got = power.gen_sql_from_stream(text)
        assert got == rpower.gen_sql_from_stream(text)
        assert len(got) == 103
    # stream 0 runs in template order with the same statements the
    # templates instantiate
    with open(stream(paths, 0)) as f:
        got = power.gen_sql_from_stream(f.read())
    want = streams.template_units(0, RNGSEED)
    assert list(got) == [n for n, _ in want]
    assert [power.strip_sql_comments(s).strip().rstrip(";")
            for s in got.values()] == \
        [power.strip_sql_comments(s).strip().rstrip(";") for _, s in want]


@pytest.mark.parametrize("input_format", ["csv", "parquet"])
def test_power_outputs_match_the_reference_power_run(request, input_format):
    """Over Parquet the decimals are exact on both sides and compare bit
    for bit; over CSV both read them as doubles (ROADMAP C.10), which
    compare to the port's float tolerance, rtol 1e-9."""
    runs = request.getfixturevalue(
        "runs" if input_format == "parquet" else "csv_runs")
    ref, port = runs["ref"], runs["port"]
    assert [r[0] for r in port["rows"]] == [r[0] for r in ref["rows"]] \
        == SUBSET
    status = rvalidate.iterate_queries(ref["out"], port["out"], SUBSET)
    assert set(status.values()) == {"Pass"}, status
    assert validate.iterate_queries(port["out"], ref["out"], SUBSET) == \
        status
    for name in SUBSET:
        assert table_mismatches(output_table(port["out"], name),
                                output_table(ref["out"], name)) == [], name
        # the same Parquet schema: decimals (exact, or doubles from CSV)
        # written as the reference writes them
        assert pq.read_schema(os.path.join(port["out"], name,
                                           "part-0.parquet")) == \
            pq.read_schema(os.path.join(ref["out"], name, "part-0.parquet"))


def test_time_log_has_the_reference_layout(runs):
    ref, port = log_rows(runs["ref"]["log"]), log_rows(runs["port"]["log"])
    assert [r[0] for r in port] == [r[0] for r in ref]
    assert port[0] == ref[0] == ["query", "start_time", "end_time", "time"]
    assert [r[0] for r in port[-2:]] == ["Power End Time", "Power Test Time"]
    start, end = int(port[1][1]), int(port[-2][1])
    assert int(port[-1][3]) == end - start
    for name, q0, q1, ms in port[2:-2]:
        assert start <= int(q0) <= int(q1) <= end
        assert int(q1) - int(q0) == int(ms)


def _summaries(folder: str) -> dict:
    out = {}
    for f in os.listdir(folder):
        with open(os.path.join(folder, f)) as fh:
            out[f.split("-")[1]] = json.load(fh)
    return out


def test_json_summaries_keep_the_reference_keys(runs):
    ref = _summaries(runs["ref"]["json"])
    port = _summaries(runs["port"]["json"])
    assert sorted(port) == sorted(ref) == sorted(SUBSET)
    for name in SUBSET:
        r, p = ref[name], port[name]
        assert set(p) == set(r), name
        assert p["schemaVersion"] == r["schemaVersion"]
        assert set(p["env"]) == set(r["env"])
        assert set(p["env"]["host"]) - RUNTIME_KEYS == \
            set(r["env"]["host"]) - RUNTIME_KEYS
        assert p["env"]["host"]["device_name"] == "cpu"
        assert p["queryStatus"] == ["Completed"]
        # the port's execStats are its last_stats: one record run here
        assert [e["mode"] for e in p["execStats"]] == ["record"]


@pytest.mark.parametrize("source", ["csv", "warehouse"])
def test_warm_power_run_over_csv_validates_against_numpy(paths, tmp_path,
                                                         capsys, source):
    """warmup=2, strict: every query recorded, every recorded unit
    compiled ahead, then every timed run compiled; the outputs Pass
    against the port's numpy power run over the same input and equal it
    under the port's rules: over a warehouse transcoded with
    --use_decimal, integers and decimals bit for bit; over CSV, whose
    decimals read as doubles (ROADMAP C.10), integers bit for bit and
    floats to rtol 1e-9."""
    sub = SUBSET + ["query14"]      # two statements, two units
    names = ["query1", "query3", "query14_part1", "query14_part2",
             "query42", "query96"]
    data, fmt = paths["csv"], "csv"
    if source == "warehouse":
        data, fmt = str(tmp_path / "wh"), "parquet"
        transcode.transcode(paths["csv"], data, use_decimal=True,
                            tables=WAREHOUSE_TABLES)
    power.run_query_stream(data, stream(paths),
                           str(tmp_path / "time.csv"), input_format=fmt,
                           output_prefix=str(tmp_path / "out"),
                           json_summary_folder=str(tmp_path / "json"),
                           sub_queries=sub, property_file=paths["cpu"],
                           warmup=2, strict=True)
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("precompile:")]
    assert len(line) == 1 and "recorded 6 queries" in line[0]
    n = line[0].split("compiled ")[1].split(" programs")[0].split("/")
    assert n[0] == n[1] and int(n[0]) >= 6, line
    for name, summary in _summaries(str(tmp_path / "json")).items():
        assert [e["mode"] for e in summary["execStats"]] == ["compiled"], \
            name
    power.run_query_stream(data, stream(paths),
                           str(tmp_path / "time_np.csv"),
                           input_format=fmt, backend="numpy",
                           output_prefix=str(tmp_path / "out_np"),
                           sub_queries=sub, property_file=paths["cpu"])
    status = validate.iterate_queries(str(tmp_path / "out_np"),
                                      str(tmp_path / "out"), names)
    assert set(status.values()) == {"Pass"}, status
    dtypes = set()
    for name in names:
        got = output_table(str(tmp_path / "out"), name)
        assert table_mismatches(
            got, output_table(str(tmp_path / "out_np"), name)) == [], name
        dtypes |= {c.dtype for c in got.columns}
    # exact decimals from the warehouse, doubles from CSV
    assert ("dec2" in dtypes) == (source == "warehouse"), dtypes
    # the CLI validator over the same trees: the stream's other queries
    # have no output and fail, and the summaries get their statuses
    assert validate.main([str(tmp_path / "out_np"), str(tmp_path / "out"),
                          stream(paths), "--json_summary_folder",
                          str(tmp_path / "json")]) == 1
    for name, summary in _summaries(str(tmp_path / "json")).items():
        assert summary["queryValidationStatus"] == ["Pass"], name
