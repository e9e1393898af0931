# table_mismatches is the port's own; the CLI validator below it (compare,
# row_equal, compare_results, iterate_queries, update_summary, main) is
# copied from nds_tpu/validate.py.
"""Result comparison for the port: the rules a query result is held to,
and the reference's validator of two query-output trees.

``table_mismatches``: integer, date, bool and decimal (scaled int64)
columns must be bit-identical; float columns agree to a relative
tolerance (1e-9 by default), because float sums and averages are taken in
another order on the card; string columns compare by value. Rows compare
in order.

The validator (reference nds/nds_validate.py) compares two output trees
query by query: a row-count gate, then row by row (sorted on the non-float
columns with --ignore_ordering), floats and decimals to an epsilon with
NaN == NaN, the query78 ratio-column carve-out of +-0.01001, the q65 skip
and the q67-under-floats skip; ``queryValidationStatus`` Pass/Fail/
NotAttempted goes back into the power run's JSON summaries.

    python -m nds_tpu_torch.validate EXPECTED ACTUAL STREAM_FILE
        [--ignore_ordering] [--json_summary_folder DIR] [--use_decimal]
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
import sys

import numpy as np
import pyarrow.parquet as pq

from .engine.column import Table

FLOAT_RTOL = 1e-9


def table_mismatches(got: Table, want: Table, rtol: float = FLOAT_RTOL
                     ) -> list[str]:
    """Human-readable differences between two results (empty when they
    match under the rules above)."""
    out = []
    if list(got.names) != list(want.names):
        out.append(f"names {got.names} != {want.names}")
    if got.num_rows != want.num_rows:
        return out + [f"rows {got.num_rows} != {want.num_rows}"]
    for name, a, b in zip(want.names, got.columns, want.columns):
        if a.dtype != b.dtype:
            out.append(f"{name}: dtype {a.dtype} != {b.dtype}")
            continue
        va, vb = a.validity, b.validity
        if not np.array_equal(va, vb):
            out.append(f"{name}: null positions differ")
            continue
        if a.dtype == "str":
            da = np.asarray(a.decode(), dtype=object)[va]
            db = np.asarray(b.decode(), dtype=object)[vb]
            same = bool(np.all(da == db))
        elif a.dtype == "float":
            da, db = np.asarray(a.data)[va], np.asarray(b.data)[vb]
            same = bool(np.allclose(da, db, rtol=rtol, atol=0.0,
                                    equal_nan=True))
        else:
            da, db = np.asarray(a.data)[va], np.asarray(b.data)[vb]
            same = np.array_equal(da, db)
        if not same:
            bad = np.flatnonzero(da != db)[:3]
            out.append(f"{name}: values differ at {bad.tolist()}: "
                       f"{da[bad].tolist()} != {db[bad].tolist()}")
    return out


DEFAULT_EPSILON = 0.0001
Q78_EPSILON = 0.01001

SKIP_ALWAYS = ("query65",)          # nondeterministic under ties (ref :231)
SKIP_WITH_FLOATS = ("query67",)     # rank over floats (ref :237)


def _is_float_type(t) -> bool:
    import pyarrow as pa
    return (pa.types.is_floating(t) or pa.types.is_decimal(t))


def _output_files(path: str):
    files = sorted(glob.glob(os.path.join(path, "*.parquet")))
    return files or None


def _output_rowcount(files: list[str]) -> int:
    """Row count from parquet metadata only (no data read)."""
    return sum(pq.ParquetFile(f).metadata.num_rows for f in files)


def _batch_rows(batch):
    cols = [batch.column(i).to_pylist() for i in range(batch.num_columns)]
    return list(zip(*cols)) if cols else []


def _sort_key_fn(schema):
    """Row sort key over non-float columns (reference collect_results
    :116-144 sorts on non-float columns before iterating)."""
    float_cols = {i for i, f in enumerate(schema)
                  if _is_float_type(f.type)}

    def key(row):
        return tuple((v is None, "" if v is None else str(v))
                     for i, v in enumerate(row) if i not in float_cols)
    return key


def iter_output_rows(files: list[str], ignore_ordering: bool,
                     batch_rows: int = 1 << 16, merge_batch: int = 4096):
    """Stream rows of an output tree with BOUNDED memory (the reference
    switches to toLocalIterator for large outputs, nds/nds_validate.py:
    116-144; here a no-LIMIT SF100 output must not materialize).

    ignore_ordering: external merge sort — each batch sorts in memory and
    spills as a run; runs k-way-merge (stable, so the total order matches
    the in-memory stable sort the small-output path used)."""
    import heapq
    import shutil
    import tempfile

    import pyarrow as pa

    if not ignore_ordering:
        for f in files:
            for batch in pq.ParquetFile(f).iter_batches(batch_rows):
                yield from _batch_rows(batch)
        return

    schema = pq.ParquetFile(files[0]).schema_arrow
    key = _sort_key_fn(schema)
    tmp = tempfile.mkdtemp(prefix="nds_validate_")
    try:
        runs: list[str] = []
        for f in files:
            for batch in pq.ParquetFile(f).iter_batches(batch_rows):
                rows = _batch_rows(batch)
                rows.sort(key=key)
                run = os.path.join(tmp, f"run-{len(runs)}.parquet")
                cols = list(zip(*rows)) if rows else [
                    [] for _ in schema.names]
                # from_arrays, not pa.table(dict): output column names can
                # legally repeat (two unaliased identical expressions) and a
                # dict would silently drop all but one
                pq.write_table(
                    pa.Table.from_arrays(
                        [pa.array(list(c), type=t.type)
                         for t, c in zip(schema, cols)],
                        schema=schema), run)
                runs.append(run)

        def run_iter(path):
            for batch in pq.ParquetFile(path).iter_batches(merge_batch):
                yield from _batch_rows(batch)

        yield from heapq.merge(*(run_iter(r) for r in runs), key=key)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def compare(expected, actual, epsilon: float = DEFAULT_EPSILON) -> bool:
    """Scalar compare with float epsilon and NaN == NaN (ref :194-215);
    Decimal (scaled-int64 decimal outputs) compares under the same epsilon
    as float, matching the reference's Decimal handling (ref :203-210)."""
    import decimal
    if expected is None or actual is None:
        return expected is None and actual is None
    if isinstance(expected, decimal.Decimal) or \
            isinstance(actual, decimal.Decimal):
        expected, actual = float(expected), float(actual)
    if isinstance(expected, float) or isinstance(actual, float):
        fe, fa = float(expected), float(actual)
        if math.isnan(fe) or math.isnan(fa):
            return math.isnan(fe) and math.isnan(fa)
        if fe == fa:
            return True
        denom = max(abs(fe), abs(fa), 1e-30)
        return abs(fe - fa) / denom < epsilon or abs(fe - fa) < epsilon
    return expected == actual


def _ratio_column_index(names: list[str]) -> int | None:
    for i, n in enumerate(names):
        if "ratio" in n.lower():
            return i
    return None


def row_equal(row_e, row_a, query_name: str, names: list[str],
              use_floats: bool = True) -> bool:
    # tolerance carve-outs match the reference validator exactly (q65 skip,
    # q67-float skip, q78 ratio +-0.01001; nds/nds_validate.py:146-164,
    # 231-244). In the exact-decimal configuration q49 needs none:
    # rank-feeding divisions order by exact rational keys on every backend
    # (planner._exact_rational_keys). The FLOAT configuration keeps a +-1
    # rank slack for q49 — there decimals bind as f64 and the rank keys
    # are emulated-f64 divisions whose exact ties can flip 1 ULP, the same
    # failure class the reference skips q67 floats for.
    ratio_idx = _ratio_column_index(names) if query_name.startswith("query78") \
        else None
    rank_cols = {i for i, n in enumerate(names) if n.lower().endswith("rank")} \
        if use_floats and query_name.startswith("query49") else set()
    for i, (e, a) in enumerate(zip(row_e, row_a)):
        if i in rank_cols and isinstance(e, int) and isinstance(a, int):
            if abs(e - a) > 1:
                return False
            continue
        eps = Q78_EPSILON if i == ratio_idx else DEFAULT_EPSILON
        if not compare(e, a, eps):
            return False
    return True


def compare_results(path_expected: str, path_actual: str, query_name: str,
                    ignore_ordering: bool = False,
                    epsilon: float = DEFAULT_EPSILON,
                    use_floats: bool = True) -> bool:
    fe = _output_files(os.path.join(path_expected, query_name))
    fa = _output_files(os.path.join(path_actual, query_name))
    if fe is None or fa is None:
        print(f"{query_name}: missing output "
              f"(expected={fe is not None}, actual={fa is not None})")
        return False
    ne, na = _output_rowcount(fe), _output_rowcount(fa)
    if ne != na:
        print(f"{query_name}: row count differs {ne} vs {na}")
        return False
    names = pq.ParquetFile(fe[0]).schema_arrow.names
    rows_e = iter_output_rows(fe, ignore_ordering)
    rows_a = iter_output_rows(fa, ignore_ordering)
    for i, (re_, ra) in enumerate(zip(rows_e, rows_a)):
        if not row_equal(re_, ra, query_name, names, use_floats):
            print(f"{query_name}: row {i} differs\n  e: {re_}\n  a: {ra}")
            return False
    return True


def iterate_queries(path_expected: str, path_actual: str,
                    query_names: list[str], ignore_ordering: bool = False,
                    use_floats: bool = True) -> dict[str, str]:
    """Compare every query; returns {name: Pass|Fail|NotAttempted}."""
    status: dict[str, str] = {}
    for name in query_names:
        base = name.split("_part")[0]
        if base in SKIP_ALWAYS or (use_floats and base in SKIP_WITH_FLOATS):
            status[name] = "NotAttempted"
            continue
        ok = compare_results(path_expected, path_actual, name,
                             ignore_ordering, use_floats=use_floats)
        status[name] = "Pass" if ok else "Fail"
    return status


def update_summary(json_summary_folder: str, status: dict[str, str]) -> None:
    """Write queryValidationStatus into the power-run JSON summaries
    (reference :262-296)."""
    for path in glob.glob(os.path.join(json_summary_folder, "power-*.json")):
        base = os.path.basename(path)
        parts = base.split("-")
        if len(parts) < 3:
            continue
        qname = "-".join(parts[1:-1])
        if qname not in status:
            continue
        with open(path) as f:
            summary = json.load(f)
        summary["queryValidationStatus"] = [status[qname]]
        with open(path, "w") as f:
            json.dump(summary, f, indent=2)


def main(argv: list[str] | None = None) -> int:
    from .power import gen_sql_from_stream

    p = argparse.ArgumentParser(prog="nds_tpu_torch.validate")
    p.add_argument("expected", help="output dir of the oracle run")
    p.add_argument("actual", help="output dir of the device run")
    p.add_argument("query_stream_file")
    p.add_argument("--ignore_ordering", action="store_true")
    p.add_argument("--json_summary_folder", default=None)
    p.add_argument("--use_decimal", action="store_true",
                   help="affects only the q67 skip policy")
    a = p.parse_args(argv)
    with open(a.query_stream_file) as f:
        names = list(gen_sql_from_stream(f.read()))
    status = iterate_queries(a.expected, a.actual, names, a.ignore_ordering,
                             use_floats=not a.use_decimal)
    if a.json_summary_folder:
        update_summary(a.json_summary_folder, status)
    failed = [n for n, s in status.items() if s == "Fail"]
    for n, s in status.items():
        print(f"{n}: {s}")
    print(f"{len([s for s in status.values() if s == 'Pass'])} passed, "
          f"{len(failed)} failed, "
          f"{len([s for s in status.values() if s == 'NotAttempted'])} skipped")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
