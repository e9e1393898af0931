"""Data Maintenance through the port against nds_tpu's, on the CPU.

SF0.001 NDS data and refresh set 1 at SF0.01 (the smallest that carries
staging rows), the Load Test of each side into an unpartitioned
``--use_decimal`` warehouse, then all 11 refresh functions: the port's
``maintenance.run_maintenance`` on the torch path (``device="cpu"``) and
the reference's with ``backend="numpy"``, both with exact decimals and
transactions on. Afterwards every table holds the same rows, file for
file with the same Arrow types (an INSERT writes the staging tables'
doubles beside the Load Test's decimals, as the reference's does):
integers and decimals bit-identical, floats to rtol 1e-9. The version
records, the time log's rows and the refresh sets themselves match too;
every INSERT body ran on the device path with no fallback; a streamed
scan over the mixed double/decimal table equals the numpy executor, after
maintenance and ``AS OF`` the first version, and takes from the data only
the stats the manifest lacks, as the reference's session does.
"""
import filecmp
import os
import shutil

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import nds_tpu_torch as nt
from nds_tpu import datagen as rdatagen
from nds_tpu import maintenance as rmaintenance
from nds_tpu import transcode as rtranscode
from nds_tpu.warehouse import Warehouse as RWarehouse
from nds_tpu_torch import datagen, maintenance, transcode
from nds_tpu_torch.engine import arrow_bridge
from nds_tpu_torch.validate import table_mismatches
from nds_tpu_torch.warehouse import Warehouse
from torch_drivers_cases import file_faults, log_rows
from torch_isolation import isolate_port_programs  # noqa: F401

#: the tables the refresh functions write
FACTS = ["catalog_returns", "catalog_sales", "inventory", "store_returns",
         "store_sales", "web_returns", "web_sales"]
#: a grouped decimal sum over the table that LF_SS writes doubles into
STREAMED = ("SELECT ss_store_sk, SUM(ss_sales_price) AS p, "
            "SUM(ss_ext_sales_price) AS e, COUNT(*) AS n FROM store_sales "
            "GROUP BY ss_store_sk ORDER BY ss_store_sk")


@pytest.fixture(scope="module")
def maint(tmp_path_factory):
    """Both sides' warehouses after maintenance, their time logs, the
    refresh sets of both generators and the INSERT bodies' fallbacks."""
    root = tmp_path_factory.mktemp("torch_maint")
    base, upd, rupd = (str(root / n) for n in ("base", "upd", "rupd"))
    datagen.generate(base, 0.001, 1)
    datagen.generate(upd, 0.01, 1, update=1)
    rdatagen.generate_data_local(rupd, 0.01, 1, update=1)
    out = {"root": root, "upd": upd, "rupd": rupd, "bodies": []}
    for side, tc in (("port", transcode.transcode),
                     ("ref", rtranscode.transcode)):
        tc(base, str(root / f"pristine_{side}"), use_decimal=True,
           partition=False)
        wh = str(root / f"wh_{side}")
        shutil.copytree(root / f"pristine_{side}", wh)
        out[side] = wh
        out[f"{side}_log"] = str(root / f"{side}.csv")

    real = nt.Session._run_query_ast

    def spied(self, ast, backend):
        result = real(self, ast, backend)
        if (backend or "torch") == "torch":
            out["bodies"].append((result.num_rows, list(self.last_fallbacks),
                                  self.device.type))
        return result
    nt.Session._run_query_ast = spied
    try:
        out["rows"] = maintenance.run_maintenance(
            out["port"], upd, out["port_log"], decimal="i64", device="cpu")
    finally:
        nt.Session._run_query_ast = real
    rmaintenance.run_maintenance(out["ref"], upd, out["ref_log"],
                                 backend="numpy", decimal="i64")
    return out


def test_refresh_set_equals_the_reference_file_for_file(maint):
    tables = sorted(os.listdir(maint["rupd"]))
    assert tables == sorted(datagen.MAINTENANCE_TABLES)
    assert sorted(os.listdir(maint["upd"])) == tables
    for t in tables:
        files = sorted(os.listdir(os.path.join(maint["rupd"], t)))
        assert sorted(os.listdir(os.path.join(maint["upd"], t))) == files
        for f in files:
            assert filecmp.cmp(os.path.join(maint["upd"], t, f),
                               os.path.join(maint["rupd"], t, f),
                               shallow=False), (t, f)


@pytest.mark.parametrize("table", FACTS + ["dimensions"])
def test_every_table_equals_the_reference_after_maintenance(maint, table):
    """File for file in manifest order: the same rows and Arrow types."""
    port, ref = Warehouse(maint["port"]), RWarehouse(maint["ref"])
    assert sorted(port.table_names()) == sorted(ref.table_names())
    if table == "dimensions":
        # no function writes them: both sides keep the Load Test's files
        for name in set(ref.table_names()) - set(FACTS):
            assert port.table(name).manifest_version() == \
                ref.table(name).manifest_version() == 1, name
            assert port.version_record(11)["tables"][name] == 1
        return
    got = port.table(table).current_files()
    want = ref.table(table).current_files()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert file_faults(pq.read_table(g, partitioning=None),
                           pq.read_table(w, partitioning=None)) == [], \
            os.path.basename(g)
    # the functions wrote the table: inserted and deleted rows
    counts = [sum(pq.ParquetFile(f).metadata.num_rows
                  for f in port.table(table).files_at_version(v))
              for v in range(1, port.table(table).manifest_version() + 1)]
    assert len(set(counts)) > 2, counts


@pytest.mark.parametrize("table", FACTS)
def test_manifest_stats_equal_the_reference_after_maintenance(maint, table):
    """Each current file's [min, max] and encoding stats in the manifest
    are the per-file functions' over its rows as read back (an INSERT's
    files take theirs in one pass over all of them), and, file for file
    in manifest order, the reference's but for the run counts, which
    follow the order of an INSERT body's rows (no ORDER BY)."""
    from nds_tpu_torch import warehouse

    def stats(wt):
        fs, es = wt.file_stats(), wt.enc_stats()
        rels = [os.path.relpath(f, wt.dir) for f in wt.current_files()]
        return [(fs.get(r, {}), es.get(r, {})) for r in rels]

    def unordered(got):
        return [(st, {c: {k: v for k, v in e.items() if k != "runs"}
                      for c, e in enc.items()}) for st, enc in got]
    wt = Warehouse(maint["port"]).table(table)
    got = stats(wt)
    assert unordered(got) == unordered(stats(
        RWarehouse(maint["ref"]).table(table)))
    for f, (st, enc) in zip(wt.current_files(), got):
        t = pq.read_table(f, partitioning=None)
        assert st == warehouse._file_stats(t), f
        assert enc == warehouse._enc_file_stats(t), f
    assert all(st and enc for st, enc in got)


def test_inserted_files_hold_the_staging_doubles_beside_decimals(maint):
    """LF_SS appends a file whose prices are doubles (the staging CSV's
    type) to a table of decimal128 files, as the reference's does."""
    port = Warehouse(maint["port"]).table("store_sales")
    types = {pq.read_schema(f).field("ss_sales_price").type
             for f in port.current_files()}
    assert pa.float64() in types
    assert any(pa.types.is_decimal(t) for t in types)


def test_version_records_and_time_log_match_the_reference(maint):
    port, ref = Warehouse(maint["port"]), RWarehouse(maint["ref"])
    assert port.versions() == ref.versions() == list(range(1, 12))
    for v in port.versions():
        got, want = port.version_record(v), ref.version_record(v)
        assert got["committer"] == want["committer"] == \
            maintenance.MAINTENANCE_FUNCS[v - 1]
        assert got["tables"] == want["tables"]
    got, want = log_rows(maint["port_log"]), log_rows(maint["ref_log"])
    assert [r[0] for r in got] == [r[0] for r in want]
    assert [r[0] for r in got[2:-2]] == maintenance.MAINTENANCE_FUNCS
    assert [r[0] for r in maint["rows"]] == maintenance.MAINTENANCE_FUNCS
    assert got[-1][0] == "Maintenance Test Time" and int(got[-1][3]) >= 0


def test_insert_bodies_ran_on_the_device_path_with_no_fallback(maint):
    """Each LF_* function's view and INSERT body on the torch path (the
    CPU, as asked), none falling back to the host."""
    bodies = maint["bodies"]
    assert len(bodies) == 2 * len(maintenance.INSERT_FUNCS)
    assert all(fb == [] and dev == "cpu" for _, fb, dev in bodies), bodies
    assert all(n > 0 for n, _, _ in bodies)


@pytest.mark.parametrize("version", [None, 1])
def test_streamed_scan_over_the_maintained_table_equals_numpy(maint,
                                                              version):
    """store_sales streams in 1,024-row morsels over its decimal and
    double files alike; the port's session takes from the data exactly
    the encoding stats that the manifest lacks in some file (the
    reference's rule: nds_tpu's _manifest_enc_source)."""
    cfg = nt.EngineConfig(out_of_core_min_rows=1000, chunk_rows=1024)
    s = nt.Session(cfg, device="cpu")
    wh = Warehouse(maint["port"])
    s.attach_warehouse(wh, at_version=version)
    read = []
    real = arrow_bridge.column_enc_stat

    def counted(col, *a, **k):
        read.append(col)
        return real(col, *a, **k)
    arrow_bridge.column_enc_stat = counted
    try:
        got = s.sql(STREAMED)
    finally:
        arrow_bridge.column_enc_stat = real
    assert s.last_stats.get("mode") == "streamed", s.last_stats
    assert s.last_fallbacks == []
    assert table_mismatches(got, s.sql(STREAMED, backend="numpy")) == []
    wt = wh.table("store_sales")
    files = wt.files_at_version(s.table_snapshot_version("store_sales"))
    manifest = wt.column_enc_stats(files)
    assert len(read) == len([c for c in ("ss_store_sk", "ss_sales_price",
                                         "ss_ext_sales_price")
                             if c not in manifest])
    if version is None:
        assert read, "the double files carry no decimal stats"
    else:
        assert not read


def test_sessions_register_the_maintained_tables_as_the_reference(maint):
    """A table of decimal and double files registers with the types of
    its first file, in the port's session as in the reference's, and the
    same count of rows."""
    from nds_tpu.config import EngineConfig as RConfig
    from nds_tpu.config import apply_decimal as rapply_decimal
    from nds_tpu.engine import Session as RSession
    rcfg = RConfig()
    rapply_decimal(rcfg, "i64")
    ref = RSession(rcfg)
    ref.attach_warehouse(RWarehouse(maint["ref"]))
    port = nt.Session(device="cpu")
    port.attach_warehouse(Warehouse(maint["port"]))
    for table in FACTS:
        assert port._schemas[table] == ref._schemas[table], table
        assert port._est_rows[table] == ref._est_rows[table], table
