"""Carry engine state across: build the port's tables from plain arrays.

This engine's state is its tables. ``tables_from_numpy`` takes, per table,
the arrays that an engine ``Table``/``Column`` holds (logical dtype string,
physical data, validity mask or None, string dictionary or None) and builds
the port's own Tables from them, so that a test can give the port and the
reference engine the same state without the port importing the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .column import Column, Table, phys_np


def column_from_numpy(dtype: str, data, validity: Optional[np.ndarray] = None,
                      dictionary: Optional[np.ndarray] = None) -> Column:
    """One port Column from a logical dtype and its arrays (data cast to the
    dtype's physical numpy type; dictionary as an object array)."""
    data = np.asarray(data).astype(phys_np(dtype), copy=True)
    valid = None if validity is None else \
        np.asarray(validity, dtype=bool).copy()
    d = None if dictionary is None else \
        np.asarray(dictionary, dtype=object).copy()
    return Column(dtype, data, valid, d)


def tables_from_numpy(spec: dict) -> dict:
    """{table: {column: (dtype, data, validity, dictionary)}} -> {table:
    Table}, columns in the mapping's order."""
    out = {}
    for name, cols in spec.items():
        out[name] = Table(list(cols),
                          [column_from_numpy(*c) for c in cols.values()])
    return out
