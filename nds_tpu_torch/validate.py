"""Result comparison for the port: the rules a query result is held to.

Integer, date, bool and decimal (scaled int64) columns must be
bit-identical; float columns agree to a relative tolerance (1e-9 by
default), because float sums and averages are taken in another order on
the card; string columns compare by value. Rows compare in order.
"""
from __future__ import annotations

import numpy as np

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
