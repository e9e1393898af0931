"""The port's Load Test (nds_tpu_torch.transcode over nds_tpu_torch.warehouse)
against nds_tpu's, at SF0.001 on the CPU.

From the same CSV, both transcoders write the same tables, partition
directories and row counts, the same per-file [min, max] and encoding
stats in the manifests (keyed by partition directory: file names are
random), and the same report lines apart from the times: with
``--use_decimal`` and at the default (decimals as doubles), for the source
tables and, with ``--update``, for the maintenance staging tables of a
refresh set. A partitioned table written by the port's writer processes
(``FileWriters``) has the manifest of one written in-process. A session
aggregates a warehouse table's stats from its manifest with no data read
(the port's counterparts of test_warehouse_manifest_stats_every_column and
test_warehouse_manifest_enc_stats).
"""
import decimal
import json
import os
import re

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import nds_tpu_torch as nt
from nds_tpu import datagen as rdatagen
from nds_tpu import transcode as rtranscode
from nds_tpu.warehouse import Warehouse as RWarehouse
from nds_tpu_torch import datagen, transcode, warehouse
from nds_tpu_torch.engine import arrow_bridge
from nds_tpu_torch.warehouse import Warehouse
from torch_drivers_cases import make_data

#: a source subset for the default (doubles) case: two fact tables, one
#: of them with a null partition, and dimensions
SUBSET = ["date_dim", "item", "store", "store_returns", "store_sales",
          "web_returns"]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return make_data(str(tmp_path_factory.mktemp("warehouse1")))


def _load_tests(csv: str, root: str, tag: str, **kw) -> dict:
    """Both Load Tests over `csv`: {side: (warehouse root, report path,
    returned times)}."""
    out = {}
    for side, mod in (("ref", rtranscode), ("port", transcode)):
        wh = os.path.join(root, f"{tag}_{side}")
        rep = os.path.join(root, f"{tag}_{side}.txt")
        out[side] = (wh, rep, mod.transcode(csv, wh, rep, **kw))
    return out


@pytest.fixture(scope="module")
def loads(paths, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("warehouse1_loads"))
    return {"decimal": _load_tests(paths["csv"], root, "decimal",
                                   use_decimal=True),
            "default": _load_tests(paths["csv"], root, "default",
                                   tables=SUBSET)}


def _by_partition(doc: dict, key: str) -> dict:
    """A manifest's per-file stats keyed by the file's directory (one
    file a partition, so the key is unique)."""
    out = {}
    for rel, stats in doc[key].items():
        d = os.path.dirname(rel)
        assert d not in out, rel
        out[d] = stats
    return out


def _layout(root: str) -> dict:
    """{table: {partition dir: rows}} of a warehouse's current snapshot,
    with its manifest's stats."""
    out = {}
    for name in Warehouse(root).table_names():
        tdir = os.path.join(root, name)
        with open(os.path.join(tdir, "manifest.json")) as f:
            doc = json.load(f)
        [snap] = doc["snapshots"]
        rows = {}
        for rel in snap["files"]:
            d = os.path.dirname(rel)
            assert d not in rows, rel
            rows[d] = pq.read_metadata(os.path.join(tdir, rel)).num_rows
        out[name] = {"rows": rows, "version": snap["version"],
                     "file_stats": _by_partition(doc, "file_stats"),
                     "enc_stats": _by_partition(doc, "enc_stats")}
    return out


def _report(path: str) -> list:
    """The report's lines with every time replaced by T."""
    with open(path) as f:
        lines = f.read().splitlines()
    return [re.sub(r"\d+\.\d{3}", "T", re.sub(r"RNGSEED used: \d+",
                                              "RNGSEED used: S", ln))
            for ln in lines]


@pytest.mark.parametrize("case", ["decimal", "default"])
def test_load_test_matches_the_reference(loads, case):
    ref, port = loads[case]["ref"], loads[case]["port"]
    got, want = _layout(port[0]), _layout(ref[0])
    assert sorted(got) == sorted(want)
    assert len(got) == (24 if case == "decimal" else len(SUBSET))
    for name in want:
        assert got[name] == want[name], name
    # the seven fact tables partition by date, one directory a date
    parts = list(got["store_sales"]["rows"])
    assert len(parts) > 100 and all(
        d.startswith("data/ss_sold_date_sk=") for d in parts)
    assert list(got["item"]["rows"]) == ["data"]
    # the same Parquet schema, decimals as decimal128 or doubles
    for name in want:
        f = Warehouse(port[0]).table(name).current_files()[0]
        g = RWarehouse(ref[0]).table(name).current_files()[0]
        assert pq.read_schema(f) == pq.read_schema(g), name
    assert _report(port[1]) == _report(ref[1])
    assert list(port[2]) == list(ref[2])
    rng = _report(port[1])
    assert rng[0] == "Load Test Time: T seconds"
    assert rng[-1] == "RNGSEED used: S"
    assert len(rng) == len(want) + 2


def test_update_transcodes_the_refresh_set_as_the_reference(tmp_path):
    """--update: the maintenance staging tables of a refresh set (made by
    the reference's datagen over the port's build of the same
    generator), the delete-date tables unpartitioned."""
    upd = str(tmp_path / "upd")
    rdatagen.generate_data_local(upd, 0.001, parallel=1, update=1,
                                 binary=datagen.build_generator())
    for side, mod in (("ref", rtranscode), ("port", transcode)):
        assert mod.main([upd, str(tmp_path / side),
                         str(tmp_path / f"{side}.txt"), "--update"]) == 0
    got, want = _layout(str(tmp_path / "port")), \
        _layout(str(tmp_path / "ref"))
    assert sorted(got) == sorted(want) == sorted(rdatagen.MAINTENANCE_TABLES)
    assert got == want
    assert list(got["delete"]["rows"]) == ["data"]
    assert _report(str(tmp_path / "port.txt")) == \
        _report(str(tmp_path / "ref.txt"))


def test_cli_options_match_the_reference(paths, tmp_path):
    """--tables, --no_partition and the report file's directory."""
    for side, mod in (("ref", rtranscode), ("port", transcode)):
        assert mod.main([paths["csv"], str(tmp_path / side),
                         str(tmp_path / side / "rep" / "load.txt"),
                         "--tables", "store_sales,item", "--no_partition",
                         "--use_decimal"]) == 0
    got, want = _layout(str(tmp_path / "port")), \
        _layout(str(tmp_path / "ref"))
    assert sorted(got) == ["item", "store_sales"] and got == want
    assert list(got["store_sales"]["rows"]) == ["data"]
    assert _report(str(tmp_path / "port" / "rep" / "load.txt")) == \
        _report(str(tmp_path / "ref" / "rep" / "load.txt"))


def test_writer_processes_give_the_in_process_manifest(loads, tmp_path):
    """A partitioned table written by FileWriters' processes has the same
    partitions, rows and stats as one written in-process."""
    src = Warehouse(loads["decimal"]["port"][0]).table("store_sales").read()
    with warehouse.FileWriters(procs=3, min_rows=0) as writers:
        Warehouse(str(tmp_path / "procs")).table("store_sales").create(
            src, writers=writers)
        assert writers.pool is not None
        assert min(writers.seconds.values()) > 0
        # the spill is gone once the files are written
        assert not [f for f in os.listdir(tmp_path / "procs" / "store_sales")
                    if f.startswith("_spill")]
    assert writers.pool is None
    Warehouse(str(tmp_path / "here")).table("store_sales").create(src)
    procs = _layout(str(tmp_path / "procs"))["store_sales"]
    assert procs == _layout(str(tmp_path / "here"))["store_sales"]
    assert procs == _layout(loads["decimal"]["port"][0])["store_sales"]


def _no_data_read(monkeypatch):
    """Make every way a stat could come from the data fail the test."""
    def fail(*a, **k):
        raise AssertionError("a stat was read from the data")
    for name in ("parquet_column_stats", "column_enc_stat"):
        monkeypatch.setattr(arrow_bridge, name, fail)
    monkeypatch.setattr(pq, "read_table", fail)


def test_warehouse_manifest_stats_every_column(tmp_path, monkeypatch):
    t = pa.table({
        "ss_ticket_number": pa.array([7, 3, 11], type=pa.int64()),
        "ss_sold_date_sk": pa.array([2_450_816, 2_450_820, 2_450_818],
                                    type=pa.int64()),
        "ss_sales_price": pa.array([decimal.Decimal("9.99"),
                                    decimal.Decimal("0.50"), None],
                                   type=pa.decimal128(7, 2)),
        "ss_date": pa.array([10_957, 10_958, 10_959], type=pa.date32()),
    })
    wt = Warehouse(str(tmp_path / "port")).table("demo")
    wt.create(t, partition=False)
    ref = RWarehouse(str(tmp_path / "ref")).table("demo")
    ref.create(t, partition=False)
    (per_file,) = wt.file_stats().values()
    assert per_file == next(iter(ref.file_stats().values()))
    # every integer/date/decimal column lands in the manifest (engine
    # units), not just the *_number delete-prune columns
    assert per_file["ss_ticket_number"] == [3, 11]
    assert per_file["ss_sold_date_sk"] == [2_450_816, 2_450_820]
    assert per_file["ss_sales_price"] == [50, 999]
    assert per_file["ss_date"] == [10_957, 10_959]
    s = nt.Session(nt.EngineConfig(decimal_physical="i64"), device="cpu")
    s.attach_warehouse(Warehouse(str(tmp_path / "port")))
    _no_data_read(monkeypatch)
    assert wt.column_stats(wt.current_files(), dec_as_int=True) == \
        ref.column_stats(ref.current_files(), dec_as_int=True)
    assert s.column_stats("demo") == {
        "ss_ticket_number": (3, 11), "ss_sold_date_sk": (2_450_816,
                                                         2_450_820),
        "ss_sales_price": (50, 999), "ss_date": (10_957, 10_959)}


def test_warehouse_manifest_enc_stats(tmp_path, monkeypatch):
    t1 = pa.table({"k": pa.array([7, 7, 7, 9], type=pa.int64()),
                   "hi": pa.array(np.arange(4) * 99991, type=pa.int64()),
                   "s": pa.array(["a", "b", "a", None])})
    t2 = pa.table({"k": pa.array([9, 11], type=pa.int64()),
                   "hi": pa.array([5, 6], type=pa.int64()),
                   "s": pa.array(["c", "c"])})
    wts = {}
    for side, cls in (("port", Warehouse), ("ref", RWarehouse)):
        wt = wts[side] = cls(str(tmp_path / side)).table("demo")
        wt.create(t1, partition=False)
        wt.insert(t2, partition=False)
    port, ref = wts["port"], wts["ref"]
    assert len(port.enc_stats()) == 2
    assert sorted(port.enc_stats().values(), key=json.dumps) == \
        sorted(ref.enc_stats().values(), key=json.dumps)
    s = nt.Session(nt.EngineConfig(decimal_physical="i64"), device="cpu")
    s.attach_warehouse(Warehouse(str(tmp_path / "port")))
    _no_data_read(monkeypatch)
    agg = port.column_enc_stats(port.current_files())
    want = ref.column_enc_stats(ref.current_files())
    assert sorted(agg) == sorted(want) == ["hi", "k"]
    for col in want:
        assert list(agg[col]["distinct"]) == list(want[col]["distinct"])
        assert (agg[col]["runs"], agg[col]["rows"]) == \
            (want[col]["runs"], want[col]["rows"])
    assert list(agg["k"]["distinct"]) == [7, 9, 11]
    assert agg["k"]["runs"] == 2 + 2     # per-file runs SUM (window bound)
    # the session's source: the manifest's aggregate, and no stats (and
    # no read) for a string column
    st = s.column_enc_stats("demo", ["k", "s"])
    assert list(st) == ["k"] and list(st["k"]["distinct"]) == [7, 9, 11]
