# Copied from nds_tpu/warehouse.py; register_all is rewritten for the port's
# Session (one _registered call a table), a large partitioned table's
# files can be written by other processes (FileWriters), a reader decodes
# only a manifest's snapshot list, manifests are written as compact JSON,
# a file's distinct values convert to Python ints in one tolist(), and a
# data file dictionary-encodes only its strings and low-cardinality
# columns (_dictionary_columns), and a Warehouse keeps the manifests it
# read or wrote decoded while they stay unchanged on disk (_load_doc).
"""Parquet warehouse with snapshot manifests: insert/delete/time-travel.

The capability subset of Iceberg/Delta that the benchmark actually uses
(SURVEY.md §5 checkpoint/resume): ACID-ish table snapshots for the
maintenance test's INSERT/DELETE refresh functions (reference
nds/nds_maintenance.py) and timestamp rollback (reference
nds/nds_rollback.py:36-55 calls Iceberg's rollback_to_timestamp over the 6
fact tables maintenance touches).

Layout per table:
    <root>/<table>/manifest.json         (snapshot list, newest last)
    <root>/<table>/data/part-*.parquet   (immutable data files)
    <root>/<table>/data/<part_col>=<v>/part-*.parquet  (partitioned tables)

A snapshot is {"version", "timestamp_ms", "files": [...]} — files are
relative paths. Writers never mutate data files; insert appends files,
delete rewrites affected files into new ones. Readers pin a snapshot.

Warehouse-level transactions (``<root>/_snapshots/``): per-table
manifests give each table its own history, but a query racing
maintenance could still see table A at generation k and table B at
k+1. The snapshot log makes cross-table commits atomic:

    <root>/_snapshots/v<N>.json              (version record: every
                                              table's manifest version)
    <root>/_snapshots/CURRENT                (the published version —
                                              THE commit point)
    <root>/_snapshots/txn-<id>.inprogress.json  (write-ahead intent:
                                              the base versions an open
                                              transaction started from)

``Warehouse.transaction()`` writes the intent record, lets any number
of per-table commits land, then publishes one version record and swings
``CURRENT`` — all via fsync + atomic rename, so a kill at ANY byte
leaves either the previous or the next snapshot current, never a
blend. Recovery at open truncates per-table manifests back past any
orphaned in-progress transaction (``max(base, published)`` per table —
committed work and non-transactional commits are never touched).
``register_all`` pins reader sessions to the published version, so a
statement resolves every table against ONE warehouse snapshot.
"""
from __future__ import annotations

import contextlib
import glob
import json
import os
import re
import time
import uuid

import pyarrow as pa
import pyarrow.dataset as pa_dataset
import pyarrow.fs as pafs
import pyarrow.parquet as pq

from .resilience import FAULTS

# fact-table partition keys (reference nds_transcode.py:45-53)
TABLE_PARTITIONING = {
    "catalog_sales": "cs_sold_date_sk",
    "catalog_returns": "cr_returned_date_sk",
    "inventory": "inv_date_sk",
    "store_sales": "ss_sold_date_sk",
    "store_returns": "sr_returned_date_sk",
    "web_sales": "ws_sold_date_sk",
    "web_returns": "wr_returned_date_sk",
}


def _fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry survives power loss
    (best-effort: some filesystems refuse directory fds)."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write_json(path: str, doc: dict, text: str | None = None) -> None:
    """Crash-consistent JSON publication: unique temp file + flush +
    fsync(file) + atomic rename + fsync(dir). A reader opening ``path``
    sees either the previous complete document or this one — never a
    prefix; a crash at any byte leaves at worst an orphaned ``*.tmp``
    no reader ever opens. ``text``: ``json.dumps(doc)``, where the caller
    has it already."""
    tmp = f"{path}.{uuid.uuid4().hex[:8]}.tmp"
    with open(tmp, "w") as f:
        # compact, in one C-encoded string: an indented json.dump encodes
        # in Python, and a fact table's manifest holds thousands of files'
        # stats (most of the Load Test's time at SF1 went there)
        f.write(json.dumps(doc) if text is None else text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


def _identity(path: str):
    """A file's identity for the manifest cache: (inode, mtime, size), or
    None where it does not exist. Every manifest write is a new file
    renamed into place, so another write changes it, unless it lands in
    the same tick of the file system's clock: a file read within
    _SETTLE_NS of its mtime is not cached (_settled)."""
    try:
        st = os.stat(path)
    except FileNotFoundError:
        return None
    return st.st_ino, st.st_mtime_ns, st.st_size


#: how old a manifest's mtime must be for a read of it to be cached: past
#: the file system clock's tick, a later write has another mtime
_SETTLE_NS = 50_000_000


def _settled(ident) -> bool:
    return time.time_ns() - ident[1] > _SETTLE_NS


#: the local file system, which a dataset over known paths is given
_LOCAL_FS = pafs.LocalFileSystem()

#: the manifest keys whose encoded text a Warehouse keeps (_encode_doc)
_STATS_KEYS = ("file_stats", "enc_stats")


def _encode_doc(doc: dict, texts: dict) -> tuple:
    """(json.dumps(doc), {key: (map, its text)} of doc's stats maps). A
    stats map whose first entries are those of a map in ``texts`` (the
    same keys, the same value objects: commits only add files' stats)
    reuses that map's text and encodes only its new entries."""
    import itertools

    parts, out = [], {}
    for key, value in doc.items():
        if key in _STATS_KEYS and isinstance(value, dict):
            old, text = texts.get(key, ({}, None))
            n = len(old)
            if text is None or len(value) < n or not all(
                    k1 == k2 and v1 is v2 for (k1, v1), (k2, v2)
                    in zip(value.items(), old.items())):
                text = json.dumps(value)
            elif len(value) > n:
                new = json.dumps(dict(itertools.islice(value.items(), n,
                                                       None)))
                text = text[:-1] + (", " if n else "") + new[1:]
            out[key] = (value, text)
        else:
            text = json.dumps(value)
        parts.append(f"{json.dumps(key)}: {text}")
    return "{" + ", ".join(parts) + "}", out


def _stats_texts(text: str, doc: dict) -> dict:
    """_encode_doc's texts of a manifest read from `text`: its stats maps'
    spans, where `text` is json.dumps(doc) as this module writes it (keys
    in _encode_doc's order, no newline); {} otherwise."""
    head, tail = '"file_stats": ', ', "enc_stats": '
    if list(doc) != ["table", "snapshots", *_STATS_KEYS] or "\n" in text:
        return {}
    start, mid = text.find(head), text.rfind(tail)
    if start < 0 or mid < start or not text.endswith("}"):
        return {}
    file_stats = text[start + len(head):mid]
    enc_stats = text[mid + len(tail):-1]
    if not (file_stats[:1] == enc_stats[:1] == "{"
            and file_stats[-1:] == enc_stats[-1:] == "}"):
        return {}
    return {"file_stats": (doc["file_stats"], file_stats),
            "enc_stats": (doc["enc_stats"], enc_stats)}


def _doc_copy(doc: dict) -> dict:
    """A manifest document whose snapshot list and stats maps the caller
    may change (their entries are shared: no caller changes those)."""
    return {**doc, "snapshots": list(doc["snapshots"]),
            "file_stats": dict(doc.get("file_stats", {})),
            "enc_stats": dict(doc.get("enc_stats", {}))}


#: the manifest key whose value WarehouseTable._load decodes alone (the
#: first key after "table" in every manifest this module writes)
_SNAPSHOTS_KEY = '"snapshots":'
_DECODER = json.JSONDecoder()
_SPACE = re.compile(r"\s*")


def _read_file(path: str) -> pa.Table:
    """Read ONE data file by exact path. A bare pq.read_table infers hive
    partitioning from the `<col>=<val>` directory component and then
    refuses to merge the inferred dictionary field with the identical
    column KEPT in the file — warehouse files always carry their partition
    column, so partition inference must stay off."""
    return pq.read_table(path, partitioning=None, filesystem=_LOCAL_FS)


def _write_parquet(table: pa.Table, path: str, **options) -> None:
    """pq.write_table of `table` to the local `path` (given the file
    system: no URI to resolve, no stat), whose footer summary the next
    registration then finds kept (arrow_bridge.remember_footer): a
    maintenance statement writes hundreds of small files, and each would
    be read again."""
    from .engine import arrow_bridge

    meta: list = []
    pq.write_table(table, path, filesystem=_LOCAL_FS,
                   metadata_collector=meta, **options)
    arrow_bridge.remember_footer(path, meta[0])


def _read_ahead(paths: list, depth: int = 16):
    """_read_file of each of `paths`, in order, with up to `depth` reads
    in flight on threads (a Parquet read leaves the interpreter lock):
    a DELETE reads hundreds of small files."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(min(8, depth)) as pool:
        pending: deque = deque()
        for path in paths:
            pending.append(pool.submit(_read_file, path))
            if len(pending) > depth:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


def _partition_value(path: str):
    """Partition value from a file path's `<col>=<val>` directory component
    (None for unpartitioned files; the null partition yields "null")."""
    d = os.path.basename(os.path.dirname(path))
    if "=" not in d:
        return None
    return d.split("=", 1)[1]


# Per-file [min, max] column metrics land in the manifest at write time
# for EVERY integer/date/decimal column (decimals stored as exact SCALED
# ints — engine units under decimal_physical="i64", JSON-safe either way):
# ticket/order numbers drive metadata-pruned DF_* deletes (the original
# use; reference analog Iceberg column metrics, nds_maintenance.py:146-185),
# and the full-column coverage feeds narrow-lane upload planning
# (Session.column_stats -> device.plan_lanes) without touching data files.
STATS_COLUMN_SUFFIXES = ("_number",)   # kept: delete-prune probe columns


def _stats_value(t: pa.DataType, v):
    """Manifest-serializable engine-unit stat for one arrow scalar value."""
    if pa.types.is_date(t):
        import datetime
        return (v - datetime.date(1970, 1, 1)).days
    if pa.types.is_decimal(t):
        return int(v.scaleb(t.scale))
    return int(v)


def _file_stats(table: pa.Table) -> dict:
    import pyarrow.compute as pc
    out = {}
    for name in table.column_names:
        col = table.column(name)
        t = col.type
        if not (pa.types.is_integer(t) or pa.types.is_date(t)
                or pa.types.is_decimal(t)):
            continue
        mm = pc.min_max(col)
        mn, mx = mm["min"].as_py(), mm["max"].as_py()
        if mn is None:
            continue
        out[name] = [_stats_value(t, mn), _stats_value(t, mx)]
    return out


# Per-file encoding stats (cardinality + run counts, engine units) feed
# encoded-execution planning (Session.column_enc_stats ->
# device.plan_encodings) the way [min, max] feeds lane planning: computed
# once at write time with the data in hand, aggregated manifest-first at
# query time with no data read. Distinct-value lists are capped so the
# manifest stays small — a column past the cap records only the count
# (high cardinality: dictionary encoding would not pay anyway).
ENC_MANIFEST_MAX_DISTINCT = 1024

def _dictionary_columns(table: pa.Table, enc: dict) -> list:
    """The columns a data file dictionary-encodes: its strings (a reader
    passes their codes through, arrow_bridge.parquet_footers) and the
    columns whose encoding stats show at most one distinct value in
    eight rows. Dictionary-encoding every column, Parquet's default,
    spends most of a fact table's write on high-cardinality decimals
    whose dictionaries it then drops."""
    out = []
    for f in table.schema:
        n = (enc.get(f.name) or {}).get("distinct_count")
        if pa.types.is_string(f.type) or pa.types.is_large_string(f.type) \
                or (n is not None and n * 8 <= table.num_rows):
            out.append(f.name)
    return out


#: processes that write a partitioned table's files, and the table size
#: from which they do (a smaller table writes in the calling process)
WRITE_PROCS = min(8, len(os.sched_getaffinity(0)))
WRITE_PROCS_MIN_ROWS = 50_000


def _write_parts(job: tuple) -> list:
    """A writer process's task: a run of partitions of the table spilled
    to `spill` (Arrow IPC, memory-mapped: no copy), each given by its
    rows in partition order."""
    spill, root, name, parts = job
    with pa.memory_map(spill) as source:
        table = pa.ipc.open_file(source).read_all()
        wt = WarehouseTable(root, name)
        return [wt._write_one(_rows(table, rows), part_val)
                for rows, part_val in parts]


def _rows(table: pa.Table, rows) -> pa.Table:
    """The rows of `table` that `rows` names: a (start, length) range or
    an index array."""
    if isinstance(rows, tuple):
        return table.slice(*rows)
    return table.take(rows)


class FileWriters:
    """Processes that write a large partitioned table's data files and
    take their manifest stats (``WarehouseTable.create(writers=...)``).

    A fact table has one file per date (about 1,800), each a Parquet
    write and a few dozen small Arrow and numpy passes for its stats,
    mostly Python's per-call work, which threads do not overlap. Above
    ``min_rows`` rows, and with at least two files a process, the table
    is spilled beside its files as one Arrow IPC file, which ``procs``
    spawned processes memory-map, each gathering and writing runs of
    partitions; they start at the first such table and serve the tables
    after it. A smaller table writes in the calling process. ``seconds``
    sums the writes' and the stats' seconds over every file written
    through it, and the spills' seconds. A context manager: the processes
    end at its exit."""

    def __init__(self, procs: int = WRITE_PROCS,
                 min_rows: int = WRITE_PROCS_MIN_ROWS):
        self.procs, self.min_rows = procs, min_rows
        self.pool = None
        self.seconds = {"write": 0.0, "stats": 0.0, "spill": 0.0}

    def __enter__(self) -> "FileWriters":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.pool is not None:
            self.pool.shutdown(cancel_futures=exc_type is not None)
            self.pool = None
        return False

    def write(self, wt: "WarehouseTable", table: pa.Table,
              parts: list) -> list:
        """wt._write_one over each (rows, partition value) of `parts`, in
        order; `rows` is a (start, length) range of `table` or an index
        array into it."""
        if self.procs < 2 or len(parts) < 2 * self.procs or \
                table.num_rows < self.min_rows:
            t0 = time.perf_counter()
            pre = _parts_stats(table, parts) or [None] * len(parts)
            self.seconds["stats"] += time.perf_counter() - t0
            done = [wt._write_one(_rows(table, rows), v, st)
                    for (rows, v), st in zip(parts, pre)]
        else:
            done = self._spawned(wt, table, parts)
        for *_, (write_s, stats_s) in done:
            self.seconds["write"] += write_s
            self.seconds["stats"] += stats_s
        return done

    def _spawned(self, wt: "WarehouseTable", table: pa.Table,
                 parts: list) -> list:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        if self.pool is None:
            # (a process that dies raises BrokenProcessPool here, where a
            # multiprocessing.Pool would start another and wait for ever)
            self.pool = ProcessPoolExecutor(
                self.procs, mp_context=multiprocessing.get_context("spawn"))
        os.makedirs(wt.dir, exist_ok=True)
        spill = os.path.join(wt.dir, f"_spill-{uuid.uuid4().hex[:12]}.arrow")
        t0 = time.perf_counter()
        try:
            with pa.OSFile(spill, "wb") as sink, \
                    pa.ipc.new_file(sink, table.schema) as writer:
                writer.write_table(table)
            self.seconds["spill"] += time.perf_counter() - t0
            step = -(-len(parts) // (self.procs * 8))
            root = os.path.dirname(wt.dir)
            runs = list(self.pool.map(_write_parts, [
                (spill, root, wt.name, parts[i:i + step])
                for i in range(0, len(parts), step)]))
        finally:
            os.unlink(spill)
        return [w for run in runs for w in run]


def _enc_file_stats(table: pa.Table) -> dict:
    from .engine.arrow_bridge import column_enc_stat

    out = {}
    for name in table.column_names:
        st = None
        try:
            st = column_enc_stat(table.column(name), dec_as_int=True)
        except Exception:
            st = None       # stats are an optimization, never a failure
        if st is None:
            continue
        dv = st["distinct"]
        ent = {"runs": int(st["runs"]), "rows": int(st["rows"]),
               "distinct_count": None if dv is None else int(len(dv))}
        if dv is not None and len(dv) <= ENC_MANIFEST_MAX_DISTINCT:
            ent["distinct"] = dv.tolist()       # (int64: Python ints)
        out[name] = ent
    return out


def _vector_stats_type(t: pa.DataType) -> bool:
    """A column type whose stats _parts_stats takes in one pass: the
    stats types whose values convert exactly to int64."""
    return pa.types.is_signed_integer(t) or pa.types.is_date32(t) or \
        (pa.types.is_unsigned_integer(t) and t.bit_width <= 32) or \
        (pa.types.is_decimal128(t) and t.precision <= 18)


def _parts_stats(table: pa.Table, parts: list) -> list:
    """[(_file_stats, _enc_file_stats)] of each of `parts` ((rows,
    partition value), as FileWriters.write takes them), the same values,
    in a few numpy passes a column over all of them: an INSERT writes a
    file a date, a few rows each, and the per-file functions spend a few
    Arrow and numpy calls a column on each. None where a stats column has
    another type than _vector_stats_type's."""
    import numpy as np

    from .engine.arrow_bridge import ENC_MAX_CARD, from_arrow_column

    cols = [n for n, f in zip(table.column_names, table.schema)
            if pa.types.is_integer(f.type) or pa.types.is_date(f.type)
            or pa.types.is_decimal(f.type)]
    lens = np.array([rows[1] if isinstance(rows, tuple) else len(rows)
                     for rows, _ in parts], dtype=np.int64)
    if not all(_vector_stats_type(table.schema.field(n).type)
               for n in cols) or not lens.all():
        return None
    idx = np.concatenate([
        np.arange(rows[0], rows[0] + rows[1]) if isinstance(rows, tuple)
        else np.asarray(rows, dtype=np.int64) for rows, _ in parts]) \
        if parts else np.empty(0, np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    seg = np.repeat(np.arange(len(parts), dtype=np.int64), lens)
    out = [({}, {}) for _ in parts]
    if not len(idx):
        return out
    for name in cols:
        c = from_arrow_column(table.column(name), dec_as_int=True)
        data = np.asarray(c.data, dtype=np.int64)[idx]
        valid = np.asarray(c.validity, dtype=bool)[idx]
        # runs over the null-filled values, each part's first row a start
        filled = np.where(valid, data, 0)
        start = np.ones(len(filled), dtype=bool)
        start[1:] = filled[1:] != filled[:-1]
        start[starts] = True
        runs = np.add.reduceat(start, starts)
        # each part's sorted distinct valid values
        sv, dv = seg[valid], data[valid]
        order = np.lexsort((dv, sv))
        sv, dv = sv[order], dv[order]
        first = np.ones(len(dv), dtype=bool)
        first[1:] = (sv[1:] != sv[:-1]) | (dv[1:] != dv[:-1])
        us, ud = sv[first], dv[first]
        count = np.bincount(us, minlength=len(parts))
        at = np.concatenate([[0], np.cumsum(count)[:-1]])
        values = ud.tolist()            # (Python ints, as the manifest's)
        for (stats, enc), n, a, r, rows in zip(
                out, count.tolist(), at.tolist(), runs.tolist(),
                lens.tolist()):
            if n:
                stats[name] = [values[a], values[a + n - 1]]
            ent = {"runs": r, "rows": rows,
                   "distinct_count": n if n <= ENC_MAX_CARD else None}
            if n <= ENC_MANIFEST_MAX_DISTINCT:
                ent["distinct"] = values[a:a + n]
            enc[name] = ent
    return out


def _tables_stats(tables: list) -> list:
    """[(_file_stats, _enc_file_stats)] of each of `tables` (none empty),
    by _parts_stats over each run of them that share a schema."""
    import numpy as np

    out: list = []
    i = 0
    while i < len(tables):
        j = i + 1
        while j < len(tables) and tables[j].schema.equals(tables[i].schema):
            j += 1
        run = tables[i:j]
        sizes = [t.num_rows for t in run]
        starts = np.cumsum([0] + sizes[:-1]).tolist()
        got = _parts_stats(pa.concat_tables(run),
                           [((a, n), None) for a, n in zip(starts, sizes)])
        out += got or [(_file_stats(t), _enc_file_stats(t)) for t in run]
        i = j
    return out


class WarehouseTable:
    def __init__(self, root: str, name: str, warehouse=None):
        self.dir = os.path.join(root, name)
        self.name = name
        self.manifest_path = os.path.join(self.dir, "manifest.json")
        #: owning Warehouse (set by Warehouse.table): commits notify its
        #: open transaction; a bare WarehouseTable commits untracked
        self._warehouse = warehouse

    # -- manifest ------------------------------------------------------------
    def _cache(self) -> dict:
        """The owning Warehouse's decoded manifests, {path: (identity,
        document or None, snapshot list, {stats key: (map, its encoded
        text)})}; a bare table caches nothing."""
        return self._warehouse._manifests if self._warehouse is not None \
            else {}

    def _load_doc(self) -> dict:
        ident = _identity(self.manifest_path)
        if ident is None:
            return {"table": self.name, "snapshots": [], "file_stats": {},
                    "enc_stats": {}}
        cache = self._cache()
        hit = cache.get(self.manifest_path)
        if hit is not None and hit[0] == ident and hit[1] is not None:
            return _doc_copy(hit[1])
        # manifests are published fsync-atomically (_store_doc), so a
        # torn read is impossible by construction — a decode failure is
        # real corruption and fails loudly, naming the file
        try:
            with open(self.manifest_path) as f:
                text = f.read()
            doc = json.loads(text)
        except json.JSONDecodeError as e:
            raise RuntimeError(
                f"corrupt warehouse manifest {self.manifest_path}: "
                f"{e}") from e
        doc.setdefault("file_stats", {})
        doc.setdefault("enc_stats", {})
        if self._warehouse is not None and _settled(ident):
            # (the identity read before the file: a newer file read under
            # it is only ever a miss later)
            cache[self.manifest_path] = (ident, doc, doc["snapshots"],
                                         _stats_texts(text, doc))
        return _doc_copy(doc)

    def _load(self) -> list[dict]:
        """The snapshot list alone, decoded from its own span of the
        manifest: a fact table's manifest is mostly per-file stats (tens
        to hundreds of MB at SF10), which a reader of its files does not
        need. A document that does not end as written, or whose list does
        not decode, takes the whole parse (and its loud failure). A
        manifest unchanged since this Warehouse last read or wrote it is
        not read again."""
        ident = _identity(self.manifest_path)
        if ident is None:
            return []
        cache = self._cache()
        hit = cache.get(self.manifest_path)
        if hit is not None and hit[0] == ident:
            return list(hit[2])
        try:
            with open(self.manifest_path) as f:
                text = f.read()
        except FileNotFoundError:
            return []
        key = text.find(_SNAPSHOTS_KEY)
        if key >= 0 and text[-64:].rstrip().endswith("}"):
            at = _SPACE.match(text, key + len(_SNAPSHOTS_KEY)).end()
            try:
                snaps, _ = _DECODER.raw_decode(text, at)
            except json.JSONDecodeError:
                snaps = None
            if isinstance(snaps, list):
                if self._warehouse is not None and _settled(ident):
                    cache[self.manifest_path] = (ident, None, snaps, {})
                return list(snaps)
        return self._load_doc()["snapshots"]

    def _store_doc(self, doc: dict) -> None:
        """Write the manifest. The caller hands `doc` over: a Warehouse
        keeps it decoded, with its stats maps' text for the next write."""
        FAULTS.fire("manifest.write", self.name)
        if self._warehouse is None:
            _atomic_write_json(self.manifest_path, doc)
            return
        hit = self._cache().get(self.manifest_path)
        text, texts = _encode_doc(doc, hit[3] if hit is not None else {})
        _atomic_write_json(self.manifest_path, doc, text)
        # what was written, as a reader would decode it (a manifest holds
        # JSON types only: lists, str keys, ints). This Warehouse is the
        # table's one writer: another write that kept the identity would
        # have to land in the same clock tick on this file's inode, after
        # one more write had freed it
        self._cache()[self.manifest_path] = (
            _identity(self.manifest_path), doc, doc["snapshots"], texts)

    def _store(self, snapshots: list[dict]) -> None:
        doc = self._load_doc()
        doc["snapshots"] = snapshots
        self._store_doc(doc)

    def _commit(self, files: list[str]) -> dict:
        # an open warehouse transaction hears about the commit BEFORE any
        # byte lands (txn.between_tables fires here on the second
        # distinct table — a kill leaves table A committed-but-
        # unpublished and this table untouched; rollback/recovery
        # truncates A back to its base)
        if self._warehouse is not None:
            self._warehouse._txn_touch(self.name)
        doc = self._load_doc()
        snapshots = doc["snapshots"]
        snap = {"version": len(snapshots) + 1,
                "timestamp_ms": int(time.time() * 1000),
                "files": sorted(files)}
        snapshots.append(snap)
        # stats of files written since the last commit; never GC'd — a
        # rollback snapshot may resurrect any older file
        doc["file_stats"].update(getattr(self, "_new_stats", {}))
        self._new_stats = {}
        doc["enc_stats"].update(getattr(self, "_new_enc_stats", {}))
        self._new_enc_stats = {}
        self._store_doc(doc)
        return snap

    def manifest_version(self) -> int:
        """Number of committed snapshots (the table's manifest version;
        0 = no snapshot yet)."""
        return len(self._load())

    def files_at_version(self, version: int) -> list[str]:
        """Absolute data-file paths of manifest snapshot ``version``
        (1-based; snapshot versions are sequential by construction)."""
        snaps = self._load()
        if not 1 <= version <= len(snaps):
            raise ValueError(
                f"table {self.name} has no manifest version {version} "
                f"(have 1..{len(snaps)})")
        return [os.path.join(self.dir, f)
                for f in snaps[version - 1]["files"]]

    def file_stats(self) -> dict:
        """{relative file path: {column: [min, max]}} for files written
        with stats (older warehouses: empty — those files never prune)."""
        return self._load_doc()["file_stats"]

    def column_stats(self, files, dec_as_int: bool = False) -> dict:
        """Table-wide {column: (lo, hi)} over the given snapshot files, in
        engine units. Manifest-recorded per-file stats aggregate for free;
        columns some file lacks stats for (older warehouses, partial
        manifests) fall back to ONE parquet-metadata pass — still no data
        read. Feeds narrow-lane upload planning (device.plan_lanes)."""
        from .engine.arrow_bridge import parquet_column_stats

        rec = self.file_stats()
        per_file = [rec.get(os.path.relpath(f, self.dir)) for f in files]
        agg: dict = {}
        if per_file and all(p is not None for p in per_file):
            common = set(per_file[0])
            for p in per_file[1:]:
                common &= set(p)
            for col in common:
                agg[col] = (min(p[col][0] for p in per_file),
                            max(p[col][1] for p in per_file))
        if not agg and files:
            agg = parquet_column_stats(list(files), dec_as_int)
        return agg

    def enc_stats(self) -> dict:
        """{relative file path: {column: {distinct/distinct_count/runs/
        rows}}} for files written with encoding stats."""
        return self._load_doc()["enc_stats"]

    def column_enc_stats(self, files) -> dict:
        """Table-wide encoding stats over the given snapshot files in the
        Session.column_enc_stats shape: {column: {"distinct": sorted int64
        array or None, "runs": int}}. Manifest-first, no data read; a
        column missing stats in ANY file is omitted (no encoding — always
        safe). Distinct sets union (None when any file only recorded the
        count — high cardinality); run counts SUM, which bounds the runs
        of any morsel window under any file order."""
        import numpy as np

        rec = self.enc_stats()
        per_file = [rec.get(os.path.relpath(f, self.dir)) for f in files]
        if not per_file or any(p is None for p in per_file):
            return {}
        common = set(per_file[0])
        for p in per_file[1:]:
            common &= set(p)
        out: dict = {}
        for col in common:
            ents = [p[col] for p in per_file]
            distinct = None
            if all(e.get("distinct") is not None for e in ents):
                distinct = np.unique(np.concatenate(
                    [np.asarray(e["distinct"], dtype=np.int64)
                     for e in ents]))
            out[col] = {"distinct": distinct,
                        "runs": sum(int(e["runs"]) for e in ents),
                        "rows": sum(int(e.get("rows", 0)) for e in ents)}
        return out

    def exists(self) -> bool:
        return os.path.exists(self.manifest_path)

    def current_files(self) -> list[str]:
        snaps = self._load()
        if not snaps:
            return []
        return [os.path.join(self.dir, f) for f in snaps[-1]["files"]]

    # -- writes --------------------------------------------------------------
    def _write_file(self, table: pa.Table, partition_val=None) -> str:
        return self._record(self._write_one(table, partition_val))

    def _write_one(self, table: pa.Table, partition_val=None,
                   stats: tuple | None = None) -> tuple:
        """Write one data file; returns (relative path, [min, max] stats,
        encoding stats, (write seconds, stats seconds)) for _record (a
        writer process returns them to the caller). `stats`: the file's
        (stats, encoding stats), where the caller took them."""
        base = f"part-{uuid.uuid4().hex[:12]}.parquet"
        if partition_val is not None:
            part_col = TABLE_PARTITIONING[self.name]
            sub = f"{part_col}={partition_val}"
            os.makedirs(os.path.join(self.dir, "data", sub), exist_ok=True)
            rel = os.path.join("data", sub, base)
        else:
            os.makedirs(os.path.join(self.dir, "data"), exist_ok=True)
            rel = os.path.join("data", base)
        t0 = time.perf_counter()
        stats, enc = stats or (_file_stats(table), _enc_file_stats(table))
        t1 = time.perf_counter()
        _write_parquet(table, os.path.join(self.dir, rel),
                       use_dictionary=_dictionary_columns(table, enc))
        return rel, stats, enc, (time.perf_counter() - t1, t1 - t0)

    def _record(self, written: tuple) -> str:
        """Keep a written file's stats for the next _commit."""
        rel, stats, enc, _ = written
        if stats:
            if not hasattr(self, "_new_stats"):
                self._new_stats = {}
            self._new_stats[rel] = stats
        if enc:
            if not hasattr(self, "_new_enc_stats"):
                self._new_enc_stats = {}
            self._new_enc_stats[rel] = enc
        return rel

    def _partitioned_files(self, table: pa.Table,
                           writers: "FileWriters | None" = None
                           ) -> list[str]:
        """Write one file per partition value (partition column KEPT in the
        file so explicit-file reads need no hive discovery).

        Sort-then-slice: one sort by the partition key, then zero-copy
        contiguous slices per value — O(n log n), not O(values * n) repeated
        full-table filters (the reference's transcode repartitions by the
        same key before writing, nds_transcode.py:68-151). Only the key's
        permutation is computed here: each partition gathers its rows
        where its file is written (FileWriters).
        """
        part_col = TABLE_PARTITIONING.get(self.name)
        if part_col is None or part_col not in table.column_names:
            return [self._write_file(table)]
        import numpy as np
        import pyarrow.compute as pc
        col = table.column(part_col)
        null_mask = np.asarray(pc.is_null(col))
        n = len(null_mask)
        first_null = int(np.argmax(null_mask)) if null_mask.any() else n
        body = col.slice(0, first_null).to_numpy(zero_copy_only=False)
        order = None
        if not (null_mask[first_null:].all() and
                bool(np.all(body[1:] >= body[:-1]))):
            # the stable sort's permutation, nulls last (Table.sort_by's);
            # each partition's rows are gathered where its file is written
            # (inventory is generated by date, and moves not at all)
            order = pc.sort_indices(
                table, sort_keys=[(part_col, "ascending")]).to_numpy()
            col = col.take(order)
            # one chunk a column: a take over the CSV's thousands of
            # chunks would resolve every chunk on every call
            table = table.combine_chunks()
            null_mask = np.asarray(pc.is_null(col))
            first_null = int(np.argmax(null_mask)) if null_mask.any() else n
        vals = col.to_numpy(zero_copy_only=False)
        body = vals[:first_null]
        bounds = np.flatnonzero(np.concatenate(
            [[True], body[1:] != body[:-1]])) if first_null else np.empty(0, int)
        parts = []
        for i, start in enumerate(bounds):
            end = bounds[i + 1] if i + 1 < len(bounds) else first_null
            # name the partition from the arrow scalar: to_numpy turns a
            # nullable int column into float64, and "sk=2450815.0" would be
            # a different layout than the int path ever produced
            part_val = col[int(start)].as_py()
            parts.append(((int(start), int(end) - int(start)), part_val))
        if first_null < n:
            parts.append(((first_null, n - first_null), "null"))
        if order is not None:
            parts = [(order[a:a + k], v) for (a, k), v in parts]
        done = (writers or FileWriters(procs=1)).write(self, table, parts)
        return [self._record(w) for w in done]

    def create(self, table: pa.Table, partition: bool = True,
               writers: "FileWriters | None" = None) -> dict:
        """The table's first snapshot; `writers` (FileWriters) writes a
        large partitioned table's files in other processes."""
        os.makedirs(self.dir, exist_ok=True)
        files = (self._partitioned_files(table, writers) if partition
                 else [self._write_file(table)])
        return self._commit(files)

    def insert(self, table: pa.Table, partition: bool = True) -> dict:
        """Append rows as new files (Iceberg-style append snapshot)."""
        old = self._load()[-1]["files"] if self._load() else []
        files = (self._partitioned_files(table) if partition
                 else [self._write_file(table)])
        return self._commit(old + files)

    def delete_where(self, keep_filter, batch_rows: int = 4_000_000,
                     part_prune=None, stats_prune=None) -> dict:
        """Rewrite files keeping rows where keep_filter(table) is True.

        keep_filter: callable(pa.Table) -> pa.BooleanArray of rows to KEEP.
        Files are processed in BATCHES of at most `batch_rows` rows, so peak
        memory is bounded at benchmark scale (SF10k store_sales does not fit
        on one host) while per-call overhead stays amortized when a table is
        spread over thousands of small partition files. The predicate is
        row-wise, so batch boundaries cannot change results. Files with
        nothing deleted are reused untouched; the rest are rewritten from
        their kept slice.

        part_prune: optional callable(partition-value string or None) ->
        bool; False promises the file contains no rows to delete, so it is
        kept untouched WITHOUT being read. The DF_* date-window deletes
        touch a handful of the date partitions the fact tables are laid out
        by (reference analog: Iceberg metadata-pruned deletes,
        nds/nds_maintenance.py:146-185).

        stats_prune: optional callable(per-file stats dict or None) ->
        bool; False promises the file's column [min, max] ranges exclude
        every deletable row (ticket-number IN-subquery deletes — the other
        half of the reference's Iceberg metric pruning). Files without
        recorded stats always process.
        """
        import pyarrow.compute as pc

        paths = self.current_files()
        if not paths:
            return self._commit([])

        new_files: list[str] = []
        if part_prune is not None or stats_prune is not None:
            stats = self.file_stats() if stats_prune is not None else {}
            kept_paths = []
            for path in paths:
                rel = os.path.relpath(path, self.dir)
                process = True
                if part_prune is not None and \
                        not part_prune(_partition_value(path)):
                    process = False
                if process and stats_prune is not None and \
                        not stats_prune(stats.get(rel)):
                    process = False
                if process:
                    kept_paths.append(path)
                else:
                    new_files.append(rel)
            paths = kept_paths
            if not paths:
                return self._commit(new_files)

        def flush(batch_paths, batch_tables):
            whole = batch_tables[0] if len(batch_tables) == 1 else \
                pa.concat_tables(batch_tables, promote_options="permissive")
            keep = pa.array(keep_filter(whole), type=pa.bool_())
            offset = 0
            rewrite = []
            for path, t in zip(batch_paths, batch_tables):
                part = keep.slice(offset, t.num_rows)
                offset += t.num_rows
                n_keep = pc.sum(pc.cast(part, pa.int64())).as_py() or 0
                rel = os.path.relpath(path, self.dir)
                if n_keep == t.num_rows:
                    new_files.append(rel)
                    continue
                if n_keep == 0:
                    continue
                rewrite.append((rel, t.filter(part)))
            # (the rewritten files' stats in a few passes over all of them)
            for (rel, kept), (st, enc) in zip(
                    rewrite, _tables_stats([k for _, k in rewrite])):
                base = f"part-{uuid.uuid4().hex[:12]}.parquet"
                new_rel = os.path.join(os.path.dirname(rel), base)
                _write_parquet(kept, os.path.join(self.dir, new_rel))
                if st:
                    # rewritten files keep pruning on later delete rounds
                    if not hasattr(self, "_new_stats"):
                        self._new_stats = {}
                    self._new_stats[new_rel] = st
                if enc:
                    if not hasattr(self, "_new_enc_stats"):
                        self._new_enc_stats = {}
                    self._new_enc_stats[new_rel] = enc
                new_files.append(new_rel)

        batch_paths: list[str] = []
        batch_tables: list[pa.Table] = []
        rows = 0
        for path, t in zip(paths, _read_ahead(paths)):
            batch_paths.append(path)
            batch_tables.append(t)
            rows += t.num_rows
            if rows >= batch_rows:
                flush(batch_paths, batch_tables)
                batch_paths, batch_tables, rows = [], [], 0
        if batch_paths:
            flush(batch_paths, batch_tables)
        return self._commit(new_files)

    # -- time travel ---------------------------------------------------------
    def rollback_to_timestamp(self, ts_ms: int) -> dict:
        """New snapshot restoring the latest state at or before ts_ms
        (reference nds_rollback.py rolls the 6 maintenance-touched fact
        tables back to the pre-maintenance timestamp)."""
        snaps = self._load()
        target = None
        for s in snaps:
            if s["timestamp_ms"] <= ts_ms:
                target = s
        if target is None:
            raise ValueError(f"no snapshot at or before {ts_ms}")
        return self._commit(list(target["files"]))

    def read(self) -> pa.Table:
        files = self.current_files()
        if not files:
            raise FileNotFoundError(f"table {self.name} has no snapshot")
        return pa.concat_tables([_read_file(f) for f in files],
                                promote_options="permissive")


class WarehouseTransaction:
    """One atomic multi-table commit over a Warehouse (single writer).

    ``__enter__`` writes the fsync-atomic intent record
    (``txn-<id>.inprogress.json``) naming every table's base manifest
    version; per-table commits inside the body append manifests as
    usual; ``__exit__`` publishes ONE version record and swings
    ``CURRENT`` (the commit point), or — on any exception, including a
    fired ``txn.commit``/``txn.between_tables`` fault — truncates every
    touched manifest back to its base, so the previous snapshot stays
    current. A kill at any point is repaired by recovery at next open.
    """

    def __init__(self, warehouse: "Warehouse", committer: str = ""):
        self.wh = warehouse
        self.committer = committer
        self.txn_id = uuid.uuid4().hex[:12]
        self.base: dict[str, int] = {}
        self.touched: set[str] = set()
        self._path = os.path.join(warehouse.snapshots_dir,
                                  f"txn-{self.txn_id}.inprogress.json")

    def __enter__(self) -> "WarehouseTransaction":
        if self.wh._txn is not None:
            raise RuntimeError("warehouse transaction already open")
        os.makedirs(self.wh.snapshots_dir, exist_ok=True)
        self.base = {n: self.wh.table(n).manifest_version()
                     for n in self.wh.table_names()}
        _atomic_write_json(self._path, {
            "txn": self.txn_id, "committer": self.committer,
            "pid": os.getpid(),
            "started_ms": int(time.time() * 1000), "base": self.base})
        self.wh._txn = self
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self._rollback()
            return False
        try:
            self._commit()
        except BaseException:
            self._rollback()
            raise
        return False

    def _commit(self) -> None:
        from .obs.flight import FLIGHT
        from .obs.metrics import TXN_COMMITS

        FAULTS.fire("txn.commit", self.committer or self.txn_id)
        version = self.wh.current_version() + 1
        tables = {n: self.wh.table(n).manifest_version()
                  for n in self.wh.table_names()}
        tables = {n: v for n, v in tables.items() if v > 0}
        _atomic_write_json(
            os.path.join(self.wh.snapshots_dir, f"v{version}.json"),
            {"version": version, "timestamp_ms": int(time.time() * 1000),
             "committer": self.committer, "tables": tables})
        # THE commit point: everything before this rename rolls back on
        # recovery, everything after survives
        _atomic_write_json(self.wh.current_path, {"version": version})
        try:
            os.unlink(self._path)
        except FileNotFoundError:
            pass
        self.wh._txn = None
        TXN_COMMITS.inc()
        FLIGHT.record("txn_commit", committer=self.committer,
                      version=version, tables=len(self.touched))

    def _rollback(self) -> None:
        from .obs.flight import FLIGHT
        from .obs.metrics import TXN_ROLLBACKS

        clean = True
        for name in sorted(set(self.base) | set(self.wh.table_names())):
            wt = self.wh.table(name)
            if not wt.exists():
                continue
            try:
                doc = wt._load_doc()
                target = self.base.get(name, 0)
                if len(doc["snapshots"]) > target:
                    doc["snapshots"] = doc["snapshots"][:target]
                    wt._store_doc(doc)
            except BaseException:
                # a fault firing mid-rollback (manifest.write armed):
                # keep the intent record — recovery at next open
                # finishes the truncation from the same base map
                clean = False
        if clean:
            try:
                os.unlink(self._path)
            except FileNotFoundError:
                pass
        self.wh._txn = None
        TXN_ROLLBACKS.inc()
        FLIGHT.record("txn_rollback", committer=self.committer,
                      tables=len(self.touched), clean=clean)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    return True


class Warehouse:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.snapshots_dir = os.path.join(root, "_snapshots")
        self.current_path = os.path.join(self.snapshots_dir, "CURRENT")
        #: the open WarehouseTransaction (single writer per Warehouse)
        self._txn: WarehouseTransaction | None = None
        #: decoded manifests by path, each under the identity of the file
        #: it came from (WarehouseTable._load_doc, _load, _store_doc): a
        #: writer's statements re-read unchanged manifests for free
        self._manifests: dict = {}
        #: each data file's columns as loads read them, {(path, column,
        #: type): ChunkedArray}, while ``writing``; None: every load reads
        #: all its files
        self._file_columns: dict | None = None
        # warehouses that never opened a transaction have no _snapshots
        # directory and skip recovery entirely (bit-identical legacy path)
        if os.path.isdir(self.snapshots_dir):
            self._recover()

    def table(self, name: str) -> WarehouseTable:
        return WarehouseTable(self.root, name, warehouse=self)

    def table_names(self) -> list[str]:
        return sorted(
            os.path.basename(os.path.dirname(m)) for m in
            glob.glob(os.path.join(self.root, "*", "manifest.json")))

    @contextlib.contextmanager
    def writing(self):
        """While entered (a run of refresh functions), a table registered
        from this warehouse keeps each data file's columns as its loads
        read them. A statement's commit re-registers the table it wrote,
        and the next statement's load of it then reads only the files the
        commit wrote."""
        self._file_columns = {}
        try:
            yield self
        finally:
            self._file_columns = None

    def _scan(self, dataset, columns):
        """dataset.to_table(columns=columns), reading only the files whose
        columns ``writing`` has not kept (as the dataset's schema types
        them: the first file's)."""
        cache = self._file_columns
        if cache is None or columns is None:
            return dataset.to_table(columns=columns)
        from .engine import arrow_bridge

        schema = dataset.schema
        files = dataset.files
        keys = [[(f, c, schema.field(c).type) for c in columns]
                for f in files]
        todo = [f for f, ks in zip(files, keys)
                if any(k not in cache for k in ks)]
        if todo:
            got = pa_dataset.FileSystemDataset.from_paths(
                todo, schema=schema, format=dataset.format,
                filesystem=_LOCAL_FS).to_table(columns=columns)
            at = 0
            for f, n in zip(todo, arrow_bridge.parquet_file_rows(todo)):
                for c in columns:
                    cache[(f, c, schema.field(c).type)] = \
                        got.column(c).slice(at, n)
                at += n
        return pa.table(
            [pa.chunked_array([ch for ks in keys for ch in cache[ks[i]].chunks],
                              type=schema.field(c).type)
             for i, c in enumerate(columns)], names=list(columns))

    # -- warehouse-level snapshot log ---------------------------------------
    def transaction(self, committer: str = "") -> WarehouseTransaction:
        """Open one atomic cross-table commit (context manager)."""
        return WarehouseTransaction(self, committer)

    def _txn_touch(self, name: str) -> None:
        """A per-table commit is about to land: record it on the open
        transaction and fire ``txn.between_tables`` when a SECOND
        distinct table joins (the mid-commit kill window campaigns
        target). No-op without an open transaction."""
        txn = self._txn
        if txn is None:
            return
        if name not in txn.touched:
            if txn.touched:
                FAULTS.fire("txn.between_tables", name)
            txn.touched.add(name)

    def current_version(self) -> int:
        """The published warehouse version (0 = no snapshot log)."""
        try:
            with open(self.current_path) as f:
                return int(json.load(f)["version"])
        except (FileNotFoundError, json.JSONDecodeError, KeyError,
                ValueError):
            return 0

    def versions(self) -> list[int]:
        """Published warehouse versions, ascending (orphans excluded)."""
        cur = self.current_version()
        out = []
        for p in glob.glob(os.path.join(self.snapshots_dir, "v*.json")):
            try:
                v = int(os.path.basename(p)[1:-5])
            except ValueError:
                continue
            if 1 <= v <= cur:
                out.append(v)
        return sorted(out)

    def version_record(self, version: int) -> dict:
        """One version record: {"version", "timestamp_ms", "committer",
        "tables": {name: manifest version}}."""
        path = os.path.join(self.snapshots_dir, f"v{version}.json")
        with open(path) as f:
            return json.load(f)

    def snapshot_records(self) -> list[dict]:
        """Every published version record, ascending (system.snapshots
        and the rollback CLI's --list view)."""
        return [self.version_record(v) for v in self.versions()]

    def rollback_to_version(self, version: int,
                            committer: str = "") -> int:
        """Restore every table to its state at warehouse ``version`` via
        one new atomic commit (Iceberg-style: history only grows — the
        restored state becomes the NEXT published version). Tables
        created after ``version`` restore to empty."""
        from .obs.flight import FLIGHT
        from .obs.metrics import TXN_ROLLBACKS

        rec = self.version_record(version)
        with self.transaction(committer=committer
                              or f"rollback:v{version}"):
            for name in self.table_names():
                wt = self.table(name)
                target = rec["tables"].get(name, 0)
                files = (wt._load()[target - 1]["files"] if target
                         else [])
                wt._commit(list(files))
        TXN_ROLLBACKS.inc()
        FLIGHT.record("txn_rollback", committer=committer or "rollback",
                      to_version=version)
        return self.current_version()

    def _recover(self) -> None:
        """Discard orphaned partial commits left by a crash: for every
        leftover in-progress record (whose writer process is gone), each
        table truncates back to ``max(base, published)`` — uncommitted
        transactional work rolls back, anything a published version (or
        a non-transactional commit predating the transaction) names is
        never touched. Version records past CURRENT (a kill between the
        record write and the CURRENT swing) are deleted."""
        leftovers = sorted(glob.glob(os.path.join(
            self.snapshots_dir, "txn-*.inprogress.json")))
        cur = self.current_version()
        published: dict[str, int] = {}
        if cur:
            published = {str(k): int(v) for k, v in
                         self.version_record(cur)["tables"].items()}
        for path in leftovers:
            try:
                with open(path) as f:
                    rec = json.load(f)
                base = {str(k): int(v)
                        for k, v in rec.get("base", {}).items()}
            except (json.JSONDecodeError, ValueError, OSError):
                rec, base = {}, {}
            # a LIVE writer's open transaction is not a crash: skip it
            # (its own commit/rollback path owns the record)
            pid = rec.get("pid")
            if pid is not None and _pid_alive(int(pid)):
                continue
            for name in set(base) | set(self.table_names()):
                wt = self.table(name)
                if not wt.exists():
                    continue
                target = max(base.get(name, 0), published.get(name, 0))
                doc = wt._load_doc()
                if len(doc["snapshots"]) > target:
                    doc["snapshots"] = doc["snapshots"][:target]
                    wt._store_doc(doc)
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
            from .obs.flight import FLIGHT
            from .obs.metrics import TXN_RECOVERIES
            TXN_RECOVERIES.inc()
            FLIGHT.record("txn_recover", committer=rec.get("committer"),
                          txn=rec.get("txn"), base_tables=len(base))
        # orphaned version records past the commit point
        for p in glob.glob(os.path.join(self.snapshots_dir, "v*.json")):
            try:
                v = int(os.path.basename(p)[1:-5])
            except ValueError:
                continue
            if v > cur:
                try:
                    os.unlink(p)
                except FileNotFoundError:
                    pass

    def _pin_record(self, session, at_version: int | None):
        """The version record reader registrations resolve against, or
        None for manifest-latest (no snapshot log, pinning disabled, or
        this Warehouse owns the OPEN transaction — the writer session
        must see its own uncommitted state)."""
        if at_version is not None:
            return self.version_record(at_version)
        if self._txn is not None:
            return None
        if not getattr(session.config, "warehouse_transactions", True):
            return None
        cur = self.current_version()
        return self.version_record(cur) if cur else None


    def register_all(self, session, est_rows: dict[str, int] | None = None,
                     at_version: int | None = None):
        """Register every warehouse table on a port Session.

        With a published snapshot log (and warehouse_transactions on),
        registrations PIN to one warehouse version: every table's files
        come from the same version record, so a statement never sees
        table A at version k beside table B at k+1. ``at_version`` time-
        travels the whole warehouse to an older published version. A
        table's value ranges and encoding stats aggregate from its
        manifest's per-file stats, with no data read."""
        from .engine import arrow_bridge

        pin = self._pin_record(session, at_version)
        snap_versions = session._table_snapshot_versions
        dec = session._dec_as_int()
        for name in self.table_names():
            wt = self.table(name)
            if pin is not None:
                mv = pin["tables"].get(name, 0)
                if mv > 0:
                    snap_versions[name] = mv
                else:
                    snap_versions.pop(name, None)
                if mv <= 0:
                    continue        # table not in the pinned snapshot
                files = wt.files_at_version(mv)
            else:
                snap_versions.pop(name, None)
                files = wt.current_files()
            if not files:
                continue
            # skip tables whose snapshot is UNCHANGED since this session
            # registered them: the loaders still point at the same
            # immutable files, so re-registering would only bump the
            # generation and cold every cache keyed on it (device scans,
            # streamed state, compiled programs)
            src_key = (tuple(files), dec, (est_rows or {}).get(name))
            if name in session._schemas and \
                    session._source_files.get(name) == src_key:
                continue
            # one footer read a file gives the row count and the string
            # columns that pass through as codes + dictionary (a data file
            # never changes: one read before is not read again)
            rows, dict_cols = arrow_bridge.parquet_footers(files,
                                                          immutable=True)
            fmt = arrow_bridge.dictionary_format(dict_cols) or \
                pa_dataset.ParquetFileFormat()
            # the schema of the first file, as pa_dataset.dataset(files)
            # infers it, without a stat of every file
            dataset = pa_dataset.FileSystemDataset.from_paths(
                files, schema=pa_dataset.dataset(files[:1],
                                                 format=fmt).schema,
                format=fmt, filesystem=_LOCAL_FS)
            names, dtypes = arrow_bridge.engine_schema(dataset.schema, dec)
            if rows is None:
                rows = dataset.count_rows()

            def load(columns=None, ds=dataset, dec=dec):
                cols = list(columns) if columns is not None else None
                return arrow_bridge.from_arrow(self._scan(ds, cols), dec)

            def batches(columns, ds=dataset):
                cols = list(columns) if columns is not None else None
                yield from ds.to_batches(columns=cols)
            session._registered(
                name, names, dtypes,
                (est_rows or {}).get(name, rows), None,
                load, batches,
                stats=lambda wt=wt, files=tuple(files), dec=dec:
                wt.column_stats(files, dec),
                enc_stats=session._manifest_enc_source(
                    wt, tuple(files), dataset, dec))
            session._source_files[name] = src_key
        session._warehouse_version = pin["version"] if pin else None
