# Copied from nds_tpu/engine/arrow_bridge.py; only import paths changed,
# from_arrow drops the fault-injection hook of the reference's resilience
# layer, and three conversions are vectorized with the same values (an
# integer column's nulls fill in Arrow, and decimals pass between scaled
# int64 and decimal128 storage without a per-row Python loop): the
# streamed path decodes every morsel and merges every partial through here.
# A file's footer is read once for its row count and dictionary columns,
# and kept for the next registration of the same file (parquet_footers).
"""Arrow <-> engine Table conversion.

Arrow is the host-side interchange format (the `collect()` analog in the
reference pulls rows to the Spark driver, nds_power.py:131; here results
materialize as Arrow tables for reporting/validation/output writing).
"""
from __future__ import annotations

import os

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from .column import Column, Table, dec_dtype, dec_scale, is_dec


def engine_dtype(t: pa.DataType, dec_as_int: bool = False) -> str:
    if pa.types.is_integer(t):
        return "int"
    if pa.types.is_decimal(t):
        # dec_as_int: exact scaled-int64 decimals (decimal_physical="i64");
        # default keeps the f64 mapping (reference decimal toggle,
        # nds/nds_schema.py:43-47)
        return dec_dtype(t.scale) if dec_as_int else "float"
    if pa.types.is_floating(t):
        return "float"
    if pa.types.is_date(t):
        return "date"
    if pa.types.is_boolean(t):
        return "bool"
    if pa.types.is_string(t) or pa.types.is_large_string(t) or \
            pa.types.is_dictionary(t):
        return "str"
    raise TypeError(f"unsupported arrow type {t}")


def engine_schema(schema: pa.Schema,
                  dec_as_int: bool = False) -> tuple[list[str], list[str]]:
    names = list(schema.names)
    dtypes = [engine_dtype(f.type, dec_as_int) for f in schema]
    return names, dtypes


def _chunked_to_array(arr: pa.ChunkedArray | pa.Array) -> pa.Array:
    if isinstance(arr, pa.ChunkedArray):
        return arr.combine_chunks()
    return arr


def _decimal_to_scaled_i64(arr: pa.Array) -> np.ndarray:
    """Exact decimal128(p,s) -> value*10^s as int64 (no float round-trip)."""
    t = arr.type
    if pa.types.is_decimal128(t):
        # a decimal128's storage IS value*10^s as a 128-bit integer: where
        # every one fits int64 (its high word is its low word's sign; at
        # precision <= 18 always, 10^18 < 2^63), the low words are the
        # answer, read in one pass (null slots hold anything: zeroed)
        words = np.frombuffer(arr.buffers()[1], dtype=np.int64)[
            2 * arr.offset:2 * (arr.offset + len(arr))].reshape(-1, 2)
        lo = words[:, 0]
        valid = ~np.asarray(arr.is_null()) if arr.null_count else None
        if t.precision <= 18:
            fits = True
        else:
            fits = words[:, 1] == (lo >> 63)
            if valid is not None:
                fits |= ~valid
            fits = bool(fits.all())
        if fits:
            return lo.copy() if valid is None else np.where(valid, lo, 0)
    if t.precision <= 18:
        # (a decimal256): every scaled value fits int64, so the safe=False
        # cast cannot wrap
        mul = pa.scalar(10 ** t.scale, pa.decimal128(t.scale + 1, 0))
        ints = pc.cast(pc.multiply(arr, mul), pa.int64(), safe=False)
        ints = pc.fill_null(ints, 0)
        return ints.to_numpy(zero_copy_only=False)
    out = np.zeros(len(arr), dtype=np.int64)     # precision edge: exact loop
    for i, d in enumerate(arr.to_pylist()):
        if d is not None:
            out[i] = int(d.scaleb(t.scale))
    return out


def from_arrow_column(arr, dec_as_int: bool = False) -> Column:
    arr = _chunked_to_array(arr)
    t = arr.type
    dtype = engine_dtype(t, dec_as_int)
    null_count = arr.null_count
    if is_dec(dtype):
        valid = ~np.asarray(arr.is_null()) if null_count else None
        return Column(dtype, _decimal_to_scaled_i64(arr), valid)
    if dtype == "str":
        # encode at most ONCE (already-dictionary arrays pass through), and
        # null indices fill host-side — the old float-NaN round-trip turned
        # every null-bearing code array into a f64 copy
        if not pa.types.is_dictionary(t):
            arr = arr.dictionary_encode()
        codes = pc.fill_null(arr.indices, -1) \
            .to_numpy(zero_copy_only=False).astype(np.int32)
        valid = None
        if null_count:
            valid = ~np.asarray(arr.is_null())
            codes = np.where(valid, codes, -1)
        # to_numpy over the value buffer, NOT to_pylist: a wide dictionary
        # (100k+ distinct values) otherwise pays a Python-object loop per
        # morsel/load
        dictionary = arr.dictionary.to_numpy(zero_copy_only=False) \
            .astype(object)
        return Column("str", codes, valid, dictionary)
    if dtype == "date":
        valid = ~np.asarray(arr.is_null()) if null_count else None
        ints = arr.cast(pa.int32())
        if null_count:  # fill BEFORE to_numpy: nulls otherwise round-trip
            ints = pc.fill_null(ints, 0)  # through float NaN -> int garbage
        days = ints.to_numpy(zero_copy_only=False)
        return Column("date", np.asarray(days, dtype=np.int32), valid)
    if dtype == "float":
        if pa.types.is_decimal(t):
            arr = arr.cast(pa.float64())
        vals = arr.to_numpy(zero_copy_only=False).astype(np.float64)
        valid = ~np.asarray(arr.is_null()) if null_count else None
        if valid is not None:
            vals = np.where(valid, vals, 0.0)
        return Column("float", vals, valid)
    if dtype == "bool":
        valid = ~np.asarray(arr.is_null()) if null_count else None
        vals = arr.to_numpy(zero_copy_only=False)
        vals = np.asarray(vals, dtype=bool)
        return Column("bool", vals, valid)
    # int: nulls fill in Arrow, as for dates (to_numpy would otherwise
    # round-trip the whole column through float64)
    valid = ~np.asarray(arr.is_null()) if null_count else None
    if null_count:
        arr = pc.fill_null(arr, 0)
    vals = arr.to_numpy(zero_copy_only=False)
    return Column("int", np.asarray(vals, dtype=np.int64), valid)


def from_arrow(table: pa.Table, dec_as_int: bool = False) -> Table:
    return Table(list(table.schema.names),
                 [from_arrow_column(table.column(i), dec_as_int)
                  for i in range(table.num_columns)])


def to_arrow_column(col: Column) -> pa.Array:
    v = col.validity
    mask = None if col.valid is None else ~col.valid
    if is_dec(col.dtype):
        # the scaled int64 values are the decimal128 storage (low word, and
        # its sign as the high word); precision 20 covers any scaled int64
        # (<= 19 digits)
        data = np.where(v, np.asarray(col.data, dtype=np.int64), 0)
        words = np.empty((len(data), 2), dtype=np.int64)
        words[:, 0] = data
        words[:, 1] = data >> 63
        bitmap = None if mask is None else \
            pa.py_buffer(np.packbits(v, bitorder="little"))
        return pa.Array.from_buffers(
            pa.decimal128(min(38, 20 + dec_scale(col.dtype)),
                          dec_scale(col.dtype)),
            len(data), [bitmap, pa.py_buffer(words)],
            null_count=0 if mask is None else int(mask.sum()))
    if col.dtype == "str":
        codes = np.asarray(col.data)
        d = col.dictionary if col.dictionary is not None \
            else np.empty(0, dtype=object)
        null_mask = (codes < 0) | ~v
        safe = np.where(codes >= 0, codes, 0)
        values = pa.array(list(d), type=pa.string())
        indices = pa.array(safe.astype(np.int32),
                           mask=null_mask if null_mask.any() else None)
        return pa.DictionaryArray.from_arrays(indices, values).cast(pa.string())
    if col.dtype == "date":
        return pa.array(np.asarray(col.data, dtype=np.int32), type=pa.date32(),
                        mask=mask)
    if col.dtype == "float":
        return pa.array(np.asarray(col.data, dtype=np.float64), mask=mask)
    if col.dtype == "bool":
        return pa.array(np.asarray(col.data, dtype=bool), mask=mask)
    return pa.array(np.asarray(col.data, dtype=np.int64), mask=mask)


def to_arrow(table: Table) -> pa.Table:
    arrays = [to_arrow_column(c) for c in table.columns]
    return pa.table(dict(zip(_dedupe(table.names), arrays))) \
        if len(set(table.names)) != len(table.names) else \
        pa.Table.from_arrays(arrays, names=table.names)


# -- column value-range stats (narrow-lane planning) --------------------------
# (lo, hi) per column in ENGINE units: raw ints for "int", epoch days for
# "date", SCALED ints for decimals under decimal_physical="i64". Streaming
# chooses per-column upload lanes from these ONCE per scan group, so morsel
# widths are static per schedule (device.plan_lanes).

def _stat_pair(t: pa.DataType, mn, mx, dec_as_int: bool):
    """Convert an arrow min/max pair to engine units; None = no stats for
    this column (it then rides the widest legal lane)."""
    if mn is None or mx is None:
        return None
    if pa.types.is_integer(t):
        return int(mn), int(mx)
    if pa.types.is_date(t):
        import datetime
        epoch = datetime.date(1970, 1, 1)
        return (mn - epoch).days, (mx - epoch).days
    if pa.types.is_decimal(t) and dec_as_int:
        return int(mn.scaleb(t.scale)), int(mx.scaleb(t.scale))
    return None     # float/bool/str: lane is dtype-determined


def table_column_stats(table: pa.Table, dec_as_int: bool = False) -> dict:
    """{column: (lo, hi)} for the lane-relevant columns of an in-memory
    arrow table (one vectorized min_max pass per column)."""
    out: dict = {}
    for name in table.column_names:
        col = table.column(name)
        t = col.type
        if not (pa.types.is_integer(t) or pa.types.is_date(t)
                or (pa.types.is_decimal(t) and dec_as_int)):
            continue
        mm = pc.min_max(col)
        pair = _stat_pair(t, mm["min"].as_py(), mm["max"].as_py(),
                          dec_as_int)
        if pair is not None:
            out[name] = pair
    return out


def parquet_column_stats(paths, dec_as_int: bool = False) -> dict:
    """{column: (lo, hi)} aggregated over parquet files from row-group
    METADATA only (no data read). A column missing statistics in any row
    group of any file is omitted (unknown range -> widest lane)."""
    import pyarrow.parquet as pq

    agg: dict = {}
    bad: set = set()
    schema = None
    for path in paths:
        meta = pq.read_metadata(path)
        if schema is None:
            schema = pq.read_schema(path)
        names = meta.schema.names
        for rg in range(meta.num_row_groups):
            group = meta.row_group(rg)
            if group.num_rows == 0:
                continue
            for ci in range(group.num_columns):
                name = names[ci]
                if name in bad or name not in schema.names:
                    continue
                t = schema.field(name).type
                if not (pa.types.is_integer(t) or pa.types.is_date(t)
                        or (pa.types.is_decimal(t) and dec_as_int)):
                    bad.add(name)
                    continue
                st = group.column(ci).statistics
                pair = None if st is None or not st.has_min_max else \
                    _stat_pair(t, st.min, st.max, dec_as_int)
                if pair is None:
                    bad.add(name)
                    agg.pop(name, None)
                    continue
                old = agg.get(name)
                agg[name] = pair if old is None else \
                    (min(old[0], pair[0]), max(old[1], pair[1]))
    return agg


# -- column encoding stats (encoded-execution planning) -----------------------
# Cardinality (the sorted distinct-value set, capped) and total run count
# per column, in ENGINE units. device.plan_encodings chooses per-column
# dictionary/RLE wire encodings from these ONCE per scan group, exactly
# like plan_lanes does from the (lo, hi) range stats above. The run count
# is a BOUND for any contiguous morsel window of the same data in the same
# order, so the static per-morsel run capacity derived from it can never
# overflow while the stats hold.

#: distinct values above this are not collected (no dictionary encoding)
ENC_MAX_CARD = 1 << 16


def column_enc_stat(col, dec_as_int: bool = False,
                    max_card: int = ENC_MAX_CARD):
    """{"distinct": sorted int array or None, "runs": int, "rows": n} for
    one arrow column (int/date/decimal only; None otherwise). `distinct`
    covers VALID values (null slots ride canonical code 0); `runs` counts
    over null-filled-with-zero values — the exact canonicalization
    pack-time RLE runs over."""
    arr = _chunked_to_array(col)
    t = arr.type
    if not (pa.types.is_integer(t) or pa.types.is_date(t)
            or (pa.types.is_decimal(t) and dec_as_int)):
        return None
    c = from_arrow_column(arr, dec_as_int)   # engine units, nulls -> 0
    return column_enc_stat_values(np.asarray(c.data), c.validity, max_card)


def column_enc_stat_values(data: np.ndarray, valid: np.ndarray,
                           max_card: int = ENC_MAX_CARD) -> dict:
    """Encoding stats over an already-engine-unit value array."""
    filled = np.where(valid, data, np.zeros((), dtype=data.dtype))
    n = int(len(filled))
    runs = int(np.count_nonzero(filled[1:] != filled[:-1]) + 1) if n else 0
    distinct = None
    u = np.unique(data[valid])
    if len(u) <= max_card:
        distinct = u.astype(np.int64)
    return {"distinct": distinct, "runs": runs, "rows": n}


def merge_enc_stats(parts: list) -> "dict | None":
    """Combine per-source encoding stats (per warehouse file, per chunk):
    distinct = the union (None when any part lacks it), runs = the sum —
    a window spanning source boundaries holds at most the per-source run
    totals combined, under ANY source order."""
    if not parts or any(p is None for p in parts):
        return None
    distinct = None
    if all(p.get("distinct") is not None for p in parts):
        distinct = np.unique(np.concatenate(
            [np.asarray(p["distinct"], dtype=np.int64) for p in parts]))
        if len(distinct) > ENC_MAX_CARD:
            distinct = None
    return {"distinct": distinct,
            "runs": sum(int(p["runs"]) for p in parts),
            "rows": sum(int(p.get("rows", 0)) for p in parts)}


# -- parquet dictionary pass-through (staging-thread hot loop) ----------------

#: per-file footer summaries, {(path, size, mtime): (rows, the string
#: columns dictionary-encoded in every row group)}, or {(path,): ...} for
#: a file that never changes (a warehouse's data file): every statement
#: that commits re-registers its table's files, most of them read before
_FOOTERS: dict = {}
_FOOTERS_MAX = 1 << 18
#: a file read within this many ns of its mtime is not cached (a write
#: in the same tick of the file system's clock would keep its key)
_SETTLE_NS = 50_000_000
#: the last footer schema read, and its string columns
_LAST_SCHEMA: tuple = (None, frozenset())


def _footer_key(path: str, immutable: bool) -> tuple:
    if immutable:
        return (path,)
    st = os.stat(path)
    return path, st.st_size, st.st_mtime_ns


def _footer_summary(meta) -> tuple:
    """(rows, the string columns dictionary-encoded in every row group)
    of a parquet file's footer metadata."""
    global _LAST_SCHEMA
    last, strs = _LAST_SCHEMA
    if last is None or not meta.schema.equals(last):
        # (a table's files share their schema: converted once)
        strs = frozenset(f.name for f in meta.schema.to_arrow_schema()
                         if pa.types.is_string(f.type)
                         or pa.types.is_large_string(f.type))
        _LAST_SCHEMA = (meta.schema, strs)
    cand = set(strs)
    cols = [ci for ci, name in enumerate(meta.schema.names) if name in cand]
    for rg in range(meta.num_row_groups if cols else 0):
        group = meta.row_group(rg)
        for ci in cols:
            encs = set(group.column(ci).encodings)
            if not (encs & {"PLAIN_DICTIONARY", "RLE_DICTIONARY"}):
                cand.discard(meta.schema.names[ci])
    return meta.num_rows, frozenset(cand)


def _footer(key: tuple) -> tuple:
    """_footer_summary of one parquet file (`key`: _footer_key), from its
    footer."""
    import time

    import pyarrow.parquet as pq

    with pa.OSFile(key[0]) as f:        # (a local path: no URI resolved)
        hit = _footer_summary(pq.read_metadata(f))
    if len(key) == 1 or time.time_ns() - key[2] > _SETTLE_NS:
        if len(_FOOTERS) >= _FOOTERS_MAX:
            _FOOTERS.clear()
        _FOOTERS[key] = hit
    return hit


def remember_footer(path: str, meta) -> None:
    """Keep the footer summary of an immutable parquet file that this
    process has just written (`meta`: its writer's FileMetaData, the
    footer's content), as parquet_footers would read it."""
    if len(_FOOTERS) >= _FOOTERS_MAX:
        _FOOTERS.clear()
    _FOOTERS[(path,)] = _footer_summary(meta)


def _footer_parts(paths, immutable: bool) -> list:
    """_footer of each of `paths`, one read a file not read before, on a
    few threads; a footer that cannot be read raises."""
    from concurrent.futures import ThreadPoolExecutor

    keys = [_footer_key(p, immutable) for p in paths]
    parts = [_FOOTERS.get(k) for k in keys]
    todo = [k for k, part in zip(keys, parts) if part is None]
    # (threads overlap the opens and reads where the file system is slow
    # to answer; the parse holds the interpreter lock)
    with ThreadPoolExecutor(min(8, max(1, len(todo) // 64))) as pool:
        read = dict(zip(todo, pool.map(_footer, todo)))
    return [read[k] if part is None else part
            for k, part in zip(keys, parts)]


def parquet_footers(paths, immutable: bool = False) -> tuple:
    """(rows, dictionary columns) of parquet files from their footers
    alone, one read a file not read before, on a few threads. The
    dictionary columns are the string columns dictionary-encoded in EVERY
    column chunk of every row group of every file: reading these with
    ParquetReadOptions(dictionary_columns=...) hands the staging thread
    codes + dictionary directly, and from_arrow_column then skips its
    dictionary_encode() re-encoding pass, the hot loop of double-buffered
    morsel staging. (None, []) when a footer cannot be read.
    ``immutable``: the files never change once written (a warehouse's),
    so a file read before is known by its path alone, with no stat."""
    try:
        parts = _footer_parts(paths, immutable)
    except Exception:
        return None, []
    cand = frozenset.intersection(*(c for _, c in parts)) if parts \
        else frozenset()
    return sum(n for n, _ in parts), sorted(cand)


def parquet_file_rows(paths) -> list:
    """Each immutable parquet file's rows, from its footer (read once, as
    parquet_footers reads it); a footer that cannot be read raises."""
    return [n for n, _ in _footer_parts(paths, immutable=True)]


def dictionary_format(cols):
    """A pyarrow dataset format that reads the string columns `cols` as
    dictionary arrays (zero-copy code pass-through for the staging
    thread); None when `cols` is empty or the pyarrow version lacks the
    option."""
    import pyarrow.dataset as pa_dataset

    if not cols:
        return None
    try:
        return pa_dataset.ParquetFileFormat(
            read_options=pa_dataset.ParquetReadOptions(
                dictionary_columns=list(cols)))
    except Exception:
        return None


def parquet_dataset_format(paths):
    """dictionary_format of the fully dictionary-encoded string columns
    of `paths` (parquet_footers)."""
    return dictionary_format(parquet_footers(paths)[1])


def _dedupe(names: list[str]) -> list[str]:
    seen: dict[str, int] = {}
    out = []
    for n in names:
        if n in seen:
            seen[n] += 1
            out.append(f"{n}_{seen[n]}")
        else:
            seen[n] = 0
            out.append(n)
    return out
