"""Reads over the port's warehouse against nds_tpu's, at SF0.001 on the CPU.

A port Session attached to the port's warehouse and a reference Session
attached to the reference's (both from the same CSV) give equal results:
integers and ``--use_decimal`` decimals bit-identical, floats to rtol
1e-9, in-core and streamed, the streamed scans planning the reference's
lanes and encodings from the manifest. Pinning and ``AS OF``: a second
warehouse version committed at the storage level (``Warehouse.transaction``
and ``WarehouseTable.insert``; no SQL DML) is seen by ``refresh_warehouse``
while ``attach_warehouse(at_version=1)`` keeps the first, with the
reference's ``warehouse_version`` and ``table_snapshot_version`` (the read
halves of tests/test_txn.py's pinning and AS OF cases, and its stray-temp,
corrupt-manifest and transactions-off cases). SQL DML through ``sql`` and
the query service raises as the reference's does, and ``execute`` of it
commits one version equal to the reference's. A port power run over the port's warehouse and
a reference power run over the reference's write outputs that pass both
validators both ways.
"""
import hashlib
import os

import numpy as np
import pyarrow as pa
import pytest

import nds_tpu_torch as nt
from nds_tpu import power as rpower
from nds_tpu import transcode as rtranscode
from nds_tpu import validate as rvalidate
from nds_tpu.config import EngineConfig as RConfig
from nds_tpu.config import apply_decimal as rapply_decimal
from nds_tpu.engine import Session as RSession
from nds_tpu.engine.arrow_bridge import to_arrow as rto_arrow
from nds_tpu.warehouse import Warehouse as RWarehouse
from nds_tpu_torch import power, transcode, validate
from nds_tpu_torch.engine.arrow_bridge import to_arrow
from nds_tpu_torch.obs.metrics import METRICS
from nds_tpu_torch.validate import table_mismatches
from nds_tpu_torch.warehouse import Warehouse
from test_e2e_power import SUBSET
from torch_drivers_cases import make_data, output_table, stream
from torch_isolation import isolate_port_programs  # noqa: F401

#: the tables SUBSET and QUERIES read
TABLES = ["customer", "date_dim", "household_demographics", "item", "store",
          "store_returns", "store_sales", "time_dim"]
#: a grouped decimal sum and average over a join, a global aggregate, and
#: a date-partitioned fact table's scan with a filter on its partition key
QUERIES = [
    "SELECT i_category, SUM(ss_ext_sales_price) AS s, "
    "AVG(ss_list_price) AS a, COUNT(*) AS n FROM store_sales, item "
    "WHERE ss_item_sk = i_item_sk GROUP BY i_category ORDER BY i_category",
    "SELECT COUNT(*) AS n, SUM(ss_quantity) AS q, MAX(ss_net_paid) AS m, "
    "MIN(ss_sold_date_sk) AS d FROM store_sales",
    "SELECT d_year, SUM(sr_return_amt) AS r, COUNT(*) AS n "
    "FROM store_returns, date_dim WHERE sr_returned_date_sk = d_date_sk "
    "AND d_year >= 2000 GROUP BY d_year ORDER BY d_year",
]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("warehouse2")
    paths = make_data(str(root))
    for tag, dec in (("decimal", True), ("default", False)):
        for side, mod in (("ref", rtranscode), ("port", transcode)):
            paths[f"{tag}_{side}"] = str(root / f"{tag}_{side}")
            mod.transcode(paths["csv"], paths[f"{tag}_{side}"],
                          use_decimal=dec, tables=TABLES)
    return paths


def _pair(paths, tag: str, **cfg):
    """(reference, port) sessions attached to their warehouses."""
    dec = "i64" if tag == "decimal" else "f64"
    rcfg = RConfig(**cfg)
    rapply_decimal(rcfg, dec)
    ref = RSession(rcfg)
    ref.attach_warehouse(RWarehouse(paths[f"{tag}_ref"]))
    port = nt.Session(nt.EngineConfig(decimal_physical=dec, **cfg),
                      device="cpu")
    port.attach_warehouse(Warehouse(paths[f"{tag}_port"]))
    return ref, port


@pytest.mark.parametrize("tag", ["decimal", "default"])
def test_attached_sessions_match_the_reference(paths, tag):
    ref, port = _pair(paths, tag)
    assert port._est_rows == ref._est_rows
    for sql in QUERIES:
        got = port.sql(sql)
        assert port.last_fallbacks == []
        want = ref.sql(sql, backend="jax")
        assert table_mismatches(got, want) == [], sql
        kinds = {c.dtype for c in got.columns}
        assert ("dec2" in kinds) == (tag == "decimal"), kinds


def test_streamed_scans_plan_from_the_manifest_as_the_reference(
        paths, monkeypatch):
    """store_sales streams (a lowered threshold) over its date partitions:
    the results, lanes and encodings are the reference's, and no stat is
    read from the data."""
    from nds_tpu_torch.engine import arrow_bridge
    ref, port = _pair(paths, "decimal", out_of_core_min_rows=1000,
                      chunk_rows=1024)

    def fail(*a, **k):
        raise AssertionError("a stat was read from the data")
    for name in ("parquet_column_stats", "column_enc_stat"):
        monkeypatch.setattr(arrow_bridge, name, fail)
    for sql in QUERIES[:2]:
        got = port.sql(sql)
        pst = dict(port.last_stats)
        want = ref.sql(sql, backend="jax")
        rst = dict(ref.last_exec_stats)
        assert table_mismatches(got, want) == [], sql
        assert (pst["mode"], rst["mode"]) == ("streamed", "streaming")
        assert pst["morsels"] == rst["morsels"] > 1
        assert pst["lane_spec"] == rst["lane_spec"]
        assert pst["enc_spec"] == rst.get("enc_spec")
        assert pst["enc_spec"]["store_sales"]
    # (the null partition's file has no [min, max] for its key)
    assert port.column_stats("store_sales") == \
        ref.column_stats("store_sales")


# -- pinning and AS OF (the read halves of tests/test_txn.py) ----------------

N_DIM = 20
JOIN_Q = ("SELECT grp, COUNT(*) AS n, SUM(qty) AS tq FROM fact "
          "JOIN dim ON fk = dk GROUP BY grp ORDER BY grp")


def _fact(n, seed):
    rng = np.random.default_rng(seed)
    return pa.table({
        "fk": pa.array(rng.integers(0, N_DIM, n), type=pa.int64()),
        "qty": pa.array(rng.integers(1, 100, n), type=pa.int64()),
    })


def _dim():
    return pa.table({
        "dk": pa.array(np.arange(N_DIM), type=pa.int64()),
        "grp": pa.array((np.arange(N_DIM) % 3).astype(np.int64)),
    })


def _hash(table) -> str:
    """A result's rows, hashed (either engine's Table)."""
    conv = to_arrow if type(table).__module__.startswith("nds_tpu_torch") \
        else rto_arrow
    return hashlib.sha1(repr(conv(table).to_pylist()).encode()).hexdigest()


def _seeded(root: str, cls):
    """A two-table warehouse at published version 1."""
    wh = cls(root)
    with wh.transaction(committer="seed"):
        wh.table("fact").create(_fact(800, 1), partition=False)
        wh.table("dim").create(_dim(), partition=False)
    return wh


def _both(tmp_path):
    return {"port": _seeded(str(tmp_path / "port"), Warehouse),
            "ref": _seeded(str(tmp_path / "ref"), RWarehouse)}


def _session(side: str, **cfg):
    if side == "ref":
        return RSession(RConfig(**cfg))
    return nt.Session(nt.EngineConfig(**cfg), device="cpu")


def test_reader_pins_the_published_version(tmp_path):
    """A pinned reader keeps version 1 while a transaction commits
    version 2 at the storage level, and refresh_warehouse moves it."""
    whs = _both(tmp_path)
    seen = {}
    for side, wh in whs.items():
        reader = _session(side)
        reader.attach_warehouse(type(wh)(wh.root))
        got = [(reader.warehouse_version(),
                reader.table_snapshot_version("fact"),
                _hash(reader.sql(JOIN_Q)))]
        with wh.transaction(committer="load"):
            wh.table("fact").insert(_fact(120, 7), partition=False)
            # mid-transaction, a refreshed reader still resolves v1
            reader.refresh_warehouse()
            got.append((reader.warehouse_version(),
                        reader.table_snapshot_version("fact"),
                        _hash(reader.sql(JOIN_Q))))
        reader.refresh_warehouse()
        got.append((reader.warehouse_version(),
                    reader.table_snapshot_version("fact"),
                    _hash(reader.sql(JOIN_Q))))
        seen[side] = got
    assert seen["port"] == seen["ref"]
    v1, mid, v2 = seen["port"]
    assert v1[:2] == mid[:2] == (1, 1) and v1[2] == mid[2]
    assert v2[:2] == (2, 2) and v2[2] != v1[2]


def test_as_of_reads_an_older_version(tmp_path):
    whs = _both(tmp_path)
    seen = {}
    for side, wh in whs.items():
        with wh.transaction(committer="load"):
            wh.table("fact").insert(_fact(120, 7), partition=False)
        old = _session(side)
        old.attach_warehouse(type(wh)(wh.root), at_version=1)
        new = _session(side)
        new.attach_warehouse(type(wh)(wh.root))
        seen[side] = (old.warehouse_version(),
                      old.table_snapshot_version("dim"),
                      _hash(old.sql(JOIN_Q)), new.warehouse_version(),
                      _hash(new.sql(JOIN_Q)))
        # AS OF is read-only: nothing was committed
        assert wh.current_version() == 2
    assert seen["port"] == seen["ref"]
    assert seen["port"][:2] == (1, 1) and seen["port"][3] == 2
    assert seen["port"][2] != seen["port"][4]


def test_stray_tmp_files_invisible_to_readers(tmp_path):
    """A half-written temp file (a crash between write and rename) is
    never part of the manifest contract: readers ignore it."""
    wt = Warehouse(str(tmp_path / "wh")).table("t")
    wt.create(_fact(50, 3), partition=False)
    files = wt.current_files()
    junk = wt.manifest_path + ".deadbeef.tmp"
    with open(junk, "w") as f:
        f.write('{"snapshots": [{"version"')     # torn mid-key
    assert wt.current_files() == files           # readers never look
    assert wt.manifest_version() == 1
    wt.insert(_fact(10, 4))
    assert wt.manifest_version() == 2
    leftover = [p for p in os.listdir(os.path.dirname(wt.manifest_path))
                if p.endswith(".tmp") and p != os.path.basename(junk)]
    assert leftover == []                        # rename consumed ours


@pytest.mark.parametrize("text", ['{"snapshots": [{',
                                  '{"table": "t", "snapshots": [], "fi'])
def test_corrupt_manifest_fails_loudly(tmp_path, text):
    """Real corruption (not a torn in-flight write) names the file, also
    where the snapshot list itself would decode."""
    wt = Warehouse(str(tmp_path / "wh")).table("t")
    wt.create(_fact(20, 5), partition=False)
    with open(wt.manifest_path, "w") as f:
        f.write(text)
    with pytest.raises(RuntimeError, match="corrupt warehouse manifest"):
        wt.current_files()


def test_transactions_disabled_is_bit_identical_legacy(tmp_path):
    """warehouse_transactions=False: no _snapshots directory, no pinning,
    no counter moves; the same with the flag on and no snapshot log."""
    before = METRICS.snapshot()
    seen = {}
    for side, cls in (("port", Warehouse), ("ref", RWarehouse)):
        wh = cls(str(tmp_path / side))
        wh.table("fact").create(_fact(800, 1), partition=False)
        wh.table("dim").create(_dim(), partition=False)
        s = _session(side, warehouse_transactions=False)
        s.attach_warehouse(wh)
        h0 = _hash(s.sql(JOIN_Q))
        wh.table("fact").insert(_fact(120, 7), partition=False)
        s.refresh_warehouse()
        seen[side] = (h0, _hash(s.sql(JOIN_Q)), s.warehouse_version(),
                      s.table_snapshot_version("fact"))
        assert not os.path.isdir(wh.snapshots_dir)
        s2 = _session(side)
        s2.attach_warehouse(cls(wh.root))
        assert s2.warehouse_version() is None
        assert not os.path.isdir(wh.snapshots_dir)
    assert seen["port"] == seen["ref"]
    assert seen["port"][0] != seen["port"][1]
    assert seen["port"][2:] == (None, None)
    d = METRICS.delta(before)
    for k in ("txn_commits", "txn_rollbacks", "txn_recoveries"):
        assert not d.get(k), k
    assert nt.EngineConfig.from_property_file(None).warehouse_transactions


@pytest.mark.parametrize("sql", [
    "INSERT INTO fact SELECT fk, qty FROM fact",
    "  -- a refresh function\n delete from fact WHERE fk = 3"])
def test_dml_raises_naming_data_maintenance(tmp_path, sql):
    """DML through Session.sql and through the query service raises as
    the reference's does (a query was expected) and moves no version;
    Session.execute of the same text in a transaction commits one
    version, whose rows are the reference's."""
    from nds_tpu.service import QueryService as RQueryService
    from nds_tpu.sql.parser import SqlParseError as RSqlParseError
    from nds_tpu_torch.service import QueryService
    from nds_tpu_torch.sql.parser import SqlParseError
    seen = {}
    for side, cls, svc_cls, err in (
            ("port", Warehouse, QueryService, SqlParseError),
            ("ref", RWarehouse, RQueryService, RSqlParseError)):
        s = _session(side)
        wh = _seeded(str(tmp_path / side), cls)
        s.attach_warehouse(wh)
        with pytest.raises(err, match="expected a SELECT query"):
            s.sql(sql)
        with svc_cls(s) as svc:
            with pytest.raises(err, match="expected a SELECT query"):
                svc.submit(sql).result(timeout=60)
        assert wh.current_version() == 1
        assert wh.table("fact").manifest_version() == 1
        with wh.transaction(committer="dml"):
            assert s.execute(sql) is None
        s.refresh_warehouse()
        assert (wh.current_version(), wh.table("fact").manifest_version(),
                wh.table("dim").manifest_version()) == (2, 2, 1)
        seen[side] = (_hash(s.sql(JOIN_Q, backend="numpy")),
                      wh.table("fact").read().num_rows)
    assert seen["port"] == seen["ref"]
    assert seen["port"][1] != 800


def test_power_run_over_the_warehouse_matches_the_reference(paths,
                                                            tmp_path):
    """warmup 0 on both sides over their --use_decimal warehouses: the
    outputs Pass both validators both ways and are equal under the port's
    rules (integers and decimals bit-identical)."""
    out = {}
    for side, fn, backend in (("ref", rpower.run_query_stream, "jax"),
                              ("port", power.run_query_stream, "torch")):
        kw = {"device": "cpu"} if side == "port" else {}
        out[side] = str(tmp_path / f"out_{side}")
        fn(paths[f"decimal_{side}"], stream(paths),
           str(tmp_path / f"time_{side}.csv"), input_format="parquet",
           backend=backend, decimal="i64", output_prefix=out[side],
           sub_queries=SUBSET, **kw)
    for a, b in ((out["ref"], out["port"]), (out["port"], out["ref"])):
        for mod in (rvalidate, validate):
            status = mod.iterate_queries(a, b, SUBSET)
            assert set(status.values()) == {"Pass"}, status
    for name in SUBSET:
        assert table_mismatches(output_table(out["port"], name),
                                output_table(out["ref"], name)) == [], name
    # setup_tables registers the pinned snapshot, timed as one
    s = nt.Session(device="cpu")
    times = power.setup_tables(s, paths["decimal_port"], "parquet")
    assert list(times) == ["warehouse"]
    assert sorted(s._schemas) == sorted(TABLES)
