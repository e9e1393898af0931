"""The port's DML over the warehouse against nds_tpu's, on the CPU.

Counterparts of tests/test_warehouse_prune.py's six cases, each run on a
port Session over the port's warehouse and on a reference Session over
the reference's, built from the same rows: a DELETE reads the same
partitions (partition pruning by the key's IN subquery, BETWEEN, and none
where the key is not constrained; file-stats pruning of a ticket-number
IN subquery, whose stats survive a rollback) and leaves the same rows,
and pruned equals unpruned. A warehouse transaction around two
``execute`` statements, the second failing, leaves the warehouse at the
version before it (tests/test_txn.py's rollback, through SQL). CREATE
TEMP VIEW, DROP VIEW and a SELECT through ``execute``, and
``power.setup_tables(maintenance=True)`` registers the staging tables.
The manifests a Warehouse keeps decoded, and the footers kept a file,
follow what other writers change.
"""
import os
import time

import numpy as np
import pyarrow as pa
import pytest

import nds_tpu.warehouse as rwarehouse_mod
import nds_tpu_torch as nt
import nds_tpu_torch.warehouse as warehouse_mod
from nds_tpu.engine import Session as RSession
from nds_tpu.warehouse import Warehouse as RWarehouse
from nds_tpu_torch import datagen, power
from nds_tpu_torch.warehouse import Warehouse
from torch_isolation import isolate_port_programs  # noqa: F401

SIDES = (("port", Warehouse, warehouse_mod),
         ("ref", RWarehouse, rwarehouse_mod))

IN_SUBQUERY = ("DELETE FROM store_sales WHERE ss_sold_date_sk IN "
               "(SELECT d_date_sk FROM date_dim WHERE d_seq < 5)")
BETWEEN = ("DELETE FROM store_sales "
           "WHERE ss_sold_date_sk BETWEEN 110 AND 112 AND ss_qty > 0")
NOT_PARTITION = "DELETE FROM store_sales WHERE ss_qty = 7"
TICKETS = ("DELETE FROM store_returns WHERE sr_ticket_number IN "
           "(SELECT ss_ticket_number FROM store_sales WHERE "
           "ss_sold_date_sk IN (SELECT d_date_sk FROM date_dim "
           "WHERE d_seq BETWEEN 10 AND 12))")


def _session(side):
    return nt.Session(device="cpu") if side == "port" else RSession()


def _date_tables():
    """store_sales over 30 date partitions (some keys NULL) and a
    date_dim (tests/test_warehouse_prune.py's wh_session)."""
    rng = np.random.default_rng(9)
    n = 3000
    dates = rng.integers(100, 130, n)
    ss = pa.table({
        "ss_sold_date_sk": pa.array(
            [None if i % 97 == 0 else int(d) for i, d in enumerate(dates)],
            type=pa.int64()),
        "ss_ticket_number": pa.array(np.arange(n), type=pa.int64()),
        "ss_qty": pa.array(rng.integers(1, 50, n), type=pa.int64()),
    })
    dd = pa.table({
        "d_date_sk": pa.array(np.arange(100, 130), type=pa.int64()),
        "d_seq": pa.array(np.arange(30), type=pa.int64()),
    })
    return {"store_sales": ss, "date_dim": dd}


def _chrono_tables():
    """Ticket numbers that grow with the sold date, returns partitioned by
    their return date (tests/test_warehouse_prune.py's chrono_session)."""
    n = 6000
    rng = np.random.default_rng(4)
    ticket = np.arange(n)
    sold = 100 + (ticket * 30) // n
    ret_date = sold + 1 + rng.integers(0, 20, n)
    return {
        "store_returns": pa.table({
            "sr_returned_date_sk": pa.array(ret_date, type=pa.int64()),
            "sr_ticket_number": pa.array(ticket, type=pa.int64()),
            "sr_qty": pa.array(rng.integers(1, 9, n), type=pa.int64())}),
        "store_sales": pa.table({
            "ss_sold_date_sk": pa.array(sold, type=pa.int64()),
            "ss_ticket_number": pa.array(ticket, type=pa.int64())}),
        "date_dim": pa.table({
            "d_date_sk": pa.array(np.arange(100, 130), type=pa.int64()),
            "d_seq": pa.array(np.arange(30), type=pa.int64())})}


def _delete_both(tmp_path, monkeypatch, tables, sql, target,
                 prune=True) -> dict:
    """Run `sql` on both sides over warehouses of `tables`; per side the
    partition directories of the target's files the DELETE read, and the
    target's rows after it, sorted."""
    out = {}
    for side, cls, mod in SIDES:
        wh = cls(str(tmp_path / f"{side}_{prune}"))
        for name, t in tables.items():
            wh.table(name).create(t)
        s = _session(side)
        s.attach_warehouse(wh)
        if not prune:
            s._partition_prune = lambda *a, **k: None
        read = []
        real = mod.pq.read_table

        def spy(path, *a, _real=real, _read=read, **k):
            _read.append(path)
            return _real(path, *a, **k)
        monkeypatch.setattr(mod.pq, "read_table", spy)
        s.execute(sql)
        monkeypatch.setattr(mod.pq, "read_table", real)
        rows = wh.table(target).read()
        out[side] = {
            "reads": sorted(os.path.basename(os.path.dirname(p))
                            for p in read if f"{os.sep}{target}{os.sep}" in p),
            "rows": rows.sort_by([(c, "ascending")
                                  for c in rows.column_names]).to_pylist()}
    return out


def test_in_subquery_delete_prunes_partitions(tmp_path, monkeypatch):
    got = _delete_both(tmp_path, monkeypatch, _date_tables(), IN_SUBQUERY,
                       "store_sales")
    assert got["port"]["reads"] == got["ref"]["reads"]
    assert 0 < len(got["port"]["reads"]) <= 5
    assert got["port"]["rows"] == got["ref"]["rows"]
    left = [r["ss_sold_date_sk"] for r in got["port"]["rows"]]
    assert None in left                         # NULL never matches IN
    assert all(v >= 105 for v in left if v is not None)


def test_between_delete_prunes(tmp_path, monkeypatch):
    got = _delete_both(tmp_path, monkeypatch, _date_tables(), BETWEEN,
                       "store_sales")
    assert got["port"]["reads"] == got["ref"]["reads"]
    assert 0 < len(got["port"]["reads"]) <= 3
    assert got["port"]["rows"] == got["ref"]["rows"]
    assert not any(110 <= (r["ss_sold_date_sk"] or 0) <= 112
                   for r in got["port"]["rows"])


def test_non_partition_delete_not_pruned(tmp_path, monkeypatch):
    got = _delete_both(tmp_path, monkeypatch, _date_tables(), NOT_PARTITION,
                       "store_sales")
    assert got["port"]["reads"] == got["ref"]["reads"]
    assert len(got["port"]["reads"]) >= 30
    assert got["port"]["rows"] == got["ref"]["rows"]
    assert 7 not in [r["ss_qty"] for r in got["port"]["rows"]]


def test_pruned_delete_matches_unpruned(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    n = 1000
    tables = {
        "inventory": pa.table({
            "inv_date_sk": pa.array(rng.integers(50, 60, n),
                                    type=pa.int64()),
            "inv_qty": pa.array(rng.integers(0, 9, n), type=pa.int64())}),
        "date_dim": pa.table({"d_date_sk": pa.array([52, 53],
                                                    type=pa.int64())})}
    sql = ("DELETE FROM inventory WHERE inv_date_sk IN "
           "(SELECT d_date_sk FROM date_dim)")
    pruned = _delete_both(tmp_path, monkeypatch, tables, sql, "inventory")
    whole = _delete_both(tmp_path, monkeypatch, tables, sql, "inventory",
                         prune=False)
    assert pruned["port"]["rows"] == whole["port"]["rows"] == \
        pruned["ref"]["rows"] == whole["ref"]["rows"]
    assert pruned["port"]["reads"] == pruned["ref"]["reads"] == \
        ["inv_date_sk=52", "inv_date_sk=53"]
    assert whole["port"]["reads"] == whole["ref"]["reads"]
    assert len(whole["port"]["reads"]) == 10


def test_ticket_in_subquery_delete_stats_pruned(tmp_path, monkeypatch):
    got = _delete_both(tmp_path, monkeypatch, _chrono_tables(), TICKETS,
                       "store_returns")
    port, ref = got["port"], got["ref"]
    assert port["reads"] == ref["reads"]
    nfiles = len(_chrono_tables()["store_returns"].column(
        "sr_returned_date_sk").unique())
    assert 0 < len(port["reads"]) < nfiles * 0.6
    assert port["rows"] == ref["rows"]
    ss = _chrono_tables()["store_sales"]
    sold = np.asarray(ss.column("ss_sold_date_sk"))
    doomed = set(np.asarray(ss.column("ss_ticket_number"))[
        (sold >= 110) & (sold <= 112)].tolist())
    left = {r["sr_ticket_number"] for r in port["rows"]}
    assert not left & doomed and len(left) == 6000 - len(doomed)


def _reads_table(node, name: str) -> bool:
    import dataclasses

    from nds_tpu_torch.sql import ast_nodes as A
    stack = [node]
    while stack:
        x = stack.pop()
        if isinstance(x, A.TableRef) and x.name == name:
            return True
        if dataclasses.is_dataclass(x):
            stack.extend(getattr(x, f.name) for f in dataclasses.fields(x))
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return False


@pytest.mark.parametrize("null_tickets", [False, True])
def test_stats_pruned_delete_evaluates_its_subquery_once(
        tmp_path, monkeypatch, null_tickets):
    """The ticket-number subquery the stats pruner evaluates is not
    evaluated again by the keep filter, which reads its rows; the DELETE
    leaves the reference's rows, also where the subquery yields NULLs."""
    tables = _chrono_tables()
    if null_tickets:
        ss = tables["store_sales"]
        tickets = ss.column("ss_ticket_number").to_pylist()
        tables["store_sales"] = ss.set_column(
            1, "ss_ticket_number", pa.array(
                [None if i % 7 == 0 else t for i, t in enumerate(tickets)],
                type=pa.int64()))
    queries = []
    real = nt.Session._run_query_ast

    def spy(self, ast, backend):
        queries.append(_reads_table(ast, "store_sales"))
        return real(self, ast, backend)
    monkeypatch.setattr(nt.Session, "_run_query_ast", spy)
    got = _delete_both(tmp_path, monkeypatch, tables, TICKETS,
                       "store_returns")
    assert queries.count(True) == 1 and len(queries) >= 2
    assert got["port"]["reads"] == got["ref"]["reads"]
    assert got["port"]["rows"] == got["ref"]["rows"]
    assert 0 < len(got["port"]["rows"]) < 6000


@pytest.mark.parametrize("rows", ["ranges", "indices"])
def test_parts_stats_equal_the_per_file_stats(rows):
    """The stats an INSERT takes in one pass over all its partitions
    equal the per-file functions' on each partition's rows: nulls, an
    all-null part, dates, decimals, doubles and strings, and parts past
    the manifest's and the encoder's distinct-value caps."""
    import decimal

    rng = np.random.default_rng(5)
    sizes = [1, 3, 1500, 80_000, 7, 2]
    n = sum(sizes)
    ints = rng.integers(-5, 10**6, n)
    t = pa.table({
        "k": pa.array([None if i % 11 == 0 else int(v)
                       for i, v in enumerate(ints)], type=pa.int64()),
        "q": pa.array(rng.integers(0, 4, n), type=pa.int32()),
        "d": pa.array(rng.integers(0, 3000, n).astype("datetime64[D]")),
        "p": pa.array([None if i % 5 == 0 else
                       decimal.Decimal(int(v)).scaleb(-2)
                       for i, v in enumerate(rng.integers(-9999, 99999, n))],
                      type=pa.decimal128(7, 2)),
        "f": pa.array(rng.random(n)),
        "s": pa.array([f"x{i % 13}" for i in range(n)]),
        "z": pa.array([None] * n, type=pa.int64()),
    })
    bounds = np.cumsum([0] + sizes)
    perm = rng.permutation(n)
    if rows == "ranges":
        parts = [((int(a), int(b - a)), k)
                 for k, (a, b) in enumerate(zip(bounds[:-1], bounds[1:]))]
    else:
        parts = [(perm[a:b], k)
                 for k, (a, b) in enumerate(zip(bounds[:-1], bounds[1:]))]
    got = warehouse_mod._parts_stats(t, parts)
    want = [(warehouse_mod._file_stats(warehouse_mod._rows(t, r)),
             warehouse_mod._enc_file_stats(warehouse_mod._rows(t, r)))
            for r, _ in parts]
    assert got == want
    assert list(got[2][0]) == ["k", "q", "d", "p"]
    assert got[2][1]["z"] == {"runs": 1, "rows": 1500, "distinct_count": 0,
                              "distinct": []}
    assert got[3][1]["k"]["distinct_count"] is None
    assert "distinct" not in got[2][1]["k"]
    assert warehouse_mod._parts_stats(
        t.append_column("u", pa.array(np.arange(n, dtype=np.uint64))),
        parts) is None


def test_tables_stats_equal_the_per_file_stats():
    """A DELETE's rewritten files take their stats in one pass over each
    run of them that share a schema (here decimal and double prices)."""
    import decimal

    rng = np.random.default_rng(6)

    def table(n, double):
        prices = [None if i % 4 == 0 else
                  decimal.Decimal(int(v)).scaleb(-2)
                  for i, v in enumerate(rng.integers(0, 9999, n))]
        return pa.table({
            "k": pa.array(rng.integers(0, 50, n), type=pa.int64()),
            "p": pa.array([None if v is None else float(v) for v in prices])
            if double else pa.array(prices, type=pa.decimal128(7, 2))})
    tables = [table(n, d) for n, d in ((3, False), (40, False), (1, True),
                                       (7, True), (5, False))]
    assert warehouse_mod._tables_stats(tables) == [
        (warehouse_mod._file_stats(t), warehouse_mod._enc_file_stats(t))
        for t in tables]


def test_stats_survive_rollback(tmp_path, monkeypatch):
    """A rolled-back table's resurrected files keep their stats, and a
    second delete after the rollback prunes as the reference's does."""
    seen = {}
    for side, cls, _ in SIDES:
        wh = cls(str(tmp_path / side))
        for name, t in _chrono_tables().items():
            wh.table(name).create(t)
        s = _session(side)
        s.attach_warehouse(wh)
        ts = int(time.time() * 1000)
        time.sleep(0.005)           # the delete commits strictly after ts
        s.execute(TICKETS)
        wt = wh.table("store_returns")
        wt.rollback_to_timestamp(ts)
        stats = wt.file_stats()
        rels = [os.path.relpath(p, wt.dir) for p in wt.current_files()]
        assert all(r in stats for r in rels)
        s.refresh_warehouse()
        s.execute(TICKETS)
        seen[side] = (len(rels), wt.read().num_rows)
    assert seen["port"] == seen["ref"]


def test_transaction_around_two_statements_rolls_back_on_error(tmp_path):
    """DF_SS's two tables in one transaction: the second statement fails,
    and neither table's manifest nor the published version moves."""
    wh = Warehouse(str(tmp_path / "wh"))
    for name, t in _chrono_tables().items():
        wh.table(name).create(t)
    with wh.transaction(committer="seed"):
        pass
    s = nt.Session(device="cpu")
    s.attach_warehouse(wh)
    before = {n: wh.table(n).manifest_version() for n in wh.table_names()}
    with pytest.raises(Exception, match="no_such_column"):
        with wh.transaction(committer="DF_SS"):
            s.execute(TICKETS)
            s.execute("DELETE FROM store_sales WHERE no_such_column = 1")
    assert wh.current_version() == 1
    assert {n: wh.table(n).manifest_version()
            for n in wh.table_names()} == before
    assert not [p for p in os.listdir(wh.snapshots_dir)
                if p.endswith(".inprogress.json")]
    s.refresh_warehouse()
    assert s.sql("SELECT COUNT(*) AS n FROM store_returns").columns[0] \
        .data.tolist() == [6000]


def test_execute_views_and_selects(tmp_path):
    """CREATE TEMP VIEW registers a query's result, a SELECT returns the
    last result, DROP VIEW removes the view; the torch path and numpy
    agree."""
    wh = Warehouse(str(tmp_path / "wh"))
    for name, t in _chrono_tables().items():
        wh.table(name).create(t, partition=False)
    s = nt.Session(device="cpu")
    s.attach_warehouse(wh)
    sql = ("CREATE TEMP VIEW v AS SELECT ss_sold_date_sk AS d, "
           "COUNT(*) AS n FROM store_sales GROUP BY ss_sold_date_sk; "
           "SELECT SUM(n) AS t, COUNT(*) AS k FROM v")
    got = {b: s.execute(sql, backend=b) for b in ("torch", "numpy")}
    assert [c.data.tolist() for c in got["torch"].columns] == \
        [c.data.tolist() for c in got["numpy"].columns] == [[6000], [30]]
    assert "v" in s.table_names() and s.last_fallbacks == []
    assert s.execute("DROP VIEW v") is None
    assert "v" not in s.table_names()


def test_setup_tables_registers_the_staging_tables(tmp_path):
    upd = str(tmp_path / "upd")
    datagen.generate(upd, 0.01, 1, update=1)
    s = nt.Session(device="cpu")
    times = power.setup_tables(s, upd, "csv", maintenance=True)
    staging = [t for t in datagen.MAINTENANCE_TABLES
               if t not in ("delete", "inventory_delete")]
    assert sorted(times) == sorted(staging + ["delete", "inventory_delete"])
    n = s.sql("SELECT COUNT(*) AS n FROM s_purchase").columns[0].data
    assert int(n[0]) > 0


def test_manifest_cache_follows_other_writers(tmp_path):
    """A Warehouse keeps the manifests it read or wrote decoded while they
    stay unchanged on disk: what it wrote decodes to the same document
    and is encoded as a whole encoding would, and a manifest another
    Warehouse changed is read again."""
    import json
    root = str(tmp_path / "wh")
    writer, reader = Warehouse(root), Warehouse(root)
    tables = _chrono_tables()
    writer.table("store_sales").create(tables["store_sales"])
    time.sleep(0.06)        # past the file system clock's tick: cached
    assert reader.table("store_sales").manifest_version() == 1
    assert reader._manifests
    writer.table("store_sales").insert(tables["store_sales"].slice(0, 10))
    assert reader.table("store_sales").manifest_version() == 2
    assert reader.table("store_sales").current_files() == \
        writer.table("store_sales").current_files()
    wt = writer.table("store_sales")
    wt.insert(tables["store_sales"].slice(10, 10))
    time.sleep(0.06)
    reader.table("store_sales").insert(tables["store_sales"].slice(20, 10))
    with open(wt.manifest_path) as f:
        text = f.read()
    # (each write appended the stats of its files to the text its writer
    # wrote or read: the same bytes as a whole encoding)
    assert text == json.dumps(json.loads(text))
    assert reader.table("store_sales")._load_doc() == json.loads(text)
    assert writer.table("store_sales").manifest_version() == 4


def test_footers_are_read_once_a_file(tmp_path, monkeypatch):
    """A table's re-registration after a commit reads the footers of its
    new files only, and counts the same rows."""
    import pyarrow.parquet as pq

    from nds_tpu_torch.engine import arrow_bridge
    wh = Warehouse(str(tmp_path / "wh"))
    wh.table("store_sales").create(_chrono_tables()["store_sales"])
    files = wh.table("store_sales").current_files()
    want = arrow_bridge.parquet_footers(files)
    time.sleep(0.06)
    read = []
    real = pq.read_metadata

    def spy(path, *a, **k):
        read.append(path)
        return real(path, *a, **k)
    monkeypatch.setattr(pq, "read_metadata", spy)
    assert arrow_bridge.parquet_footers(files) in (want, tuple(want))
    cached = len(read)
    wh.table("store_sales").insert(_chrono_tables()["store_sales"].slice(
        0, 10))
    new = wh.table("store_sales").current_files()
    rows, _ = arrow_bridge.parquet_footers(new)
    assert rows == want[0] + 10
    assert len(read) - cached == len(set(new) - set(files))


def test_written_files_footers_are_kept_from_their_writer(tmp_path,
                                                         monkeypatch):
    """The files a load, an INSERT and a DELETE write keep their footer
    summaries from the writer's metadata, equal to a read of the footer,
    and a registration reads none of them again."""
    import pyarrow.parquet as pq

    from nds_tpu_torch.engine import arrow_bridge
    ss = _chrono_tables()["store_sales"]
    ss = ss.append_column("ss_note", pa.array(
        [f"n{i % 3}" if i % 5 else None for i in range(ss.num_rows)]))
    wh = Warehouse(str(tmp_path / "wh"))
    wh.table("store_sales").create(ss)
    wh.table("date_dim").create(_chrono_tables()["date_dim"])
    s = nt.Session(device="cpu")
    s.attach_warehouse(wh)
    s.execute("INSERT INTO store_sales SELECT * FROM store_sales "
              "WHERE ss_ticket_number < 500")
    s.execute("DELETE FROM store_sales WHERE ss_ticket_number % 7 = 0")
    files = wh.table("store_sales").current_files()
    for f in files:
        assert arrow_bridge._FOOTERS[(f,)] == \
            arrow_bridge._footer_summary(pq.read_metadata(f)), f
    assert any(arrow_bridge._FOOTERS[(f,)][1] == {"ss_note"} for f in files)
    read = []
    real = arrow_bridge._footer

    def spy(key):
        read.append(key)
        return real(key)
    monkeypatch.setattr(arrow_bridge, "_footer", spy)
    rows, cols = arrow_bridge.parquet_footers(files, immutable=True)
    assert read == [] and cols == ["ss_note"]
    assert rows == sum(pq.read_metadata(f).num_rows for f in files)


def test_loads_while_writing_read_only_new_files(tmp_path):
    """While a Warehouse is writing, a table's load after a DELETE reads
    only the files the DELETE wrote, and equals a load of every file,
    over decimal and double files alike (the first file's types)."""
    import decimal

    from nds_tpu_torch.validate import table_mismatches
    n = 600
    rng = np.random.default_rng(5)
    price = [decimal.Decimal(int(v)).scaleb(-2)
             for v in rng.integers(100, 9999, n)]
    base = pa.table({
        "ss_sold_date_sk": pa.array(100 + np.arange(n) % 20, type=pa.int64()),
        "ss_ticket_number": pa.array(np.arange(n), type=pa.int64()),
        "ss_sales_price": pa.array(price, type=pa.decimal128(7, 2))})
    wh = Warehouse(str(tmp_path / "wh"))
    wh.table("store_sales").create(base)
    wh.table("store_sales").insert(pa.table({
        "ss_sold_date_sk": pa.array([105, 130], type=pa.int64()),
        "ss_ticket_number": pa.array([n, n + 1], type=pa.int64()),
        "ss_sales_price": pa.array([1.25, 2.5])}))
    cols = ["ss_ticket_number", "ss_sales_price"]
    s = nt.Session(device="cpu")
    with wh.writing():
        s.attach_warehouse(wh)
        s.load_table("store_sales", cols)
        kept = set(wh._file_columns)
        before = set(wh.table("store_sales").current_files())
        s.execute("DELETE FROM store_sales WHERE ss_ticket_number < 30 "
                  "AND ss_sold_date_sk = 101")
        got = s.load_table("store_sales", cols)
        after = set(wh.table("store_sales").current_files())
        read = {f for f, *_ in set(wh._file_columns) - kept}
    assert wh._file_columns is None
    fresh = nt.Session(device="cpu")
    fresh.attach_warehouse(Warehouse(wh.root))
    assert table_mismatches(got, fresh.load_table("store_sales", cols)) == []
    assert got.num_rows == n + 2 - 2
    assert read == after - before and len(read) == 1
    assert fresh._schemas["store_sales"][1][2] == "dec2"
