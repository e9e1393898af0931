# Copied from nds_tpu/engine/column.py; only import paths changed.
"""Columnar data representation.

A Column is a flat physical array plus an optional validity mask. Strings are
dictionary-encoded (int32 codes into a host-side value array) so device-side
relational compute never touches bytes — the TPU analog of the reference's
cuDF string columns on GPU.

Engine logical dtypes:
    "int"    int64 values
    "float"  float64 values (decimals map here under decimal_physical="f64")
    "decN"   scaled int64: value * 10^N stored exactly (decimal_physical=
             "i64"; the TPU-exact decimal story — XLA has no decimal type,
             so SUM/MIN/MAX/compare run on integers, divisions on float.
             Reference keeps DecimalType end-to-end, nds/nds_schema.py:43-47)
    "bool"   bool values
    "date"   int32 days since Unix epoch
    "str"    int32 dictionary codes, `dictionary` holds the values
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np

_NULL_CODE = -1  # dictionary code reserved for NULL strings

_PHYS_DTYPE = {
    "int": np.int64,
    "float": np.float64,
    "bool": np.bool_,
    "date": np.int32,
    "str": np.int32,
}


def is_dec(dtype: str) -> bool:
    """True for scaled-decimal logical dtypes ("dec0", "dec2", ...)."""
    return dtype.startswith("dec") and dtype[3:].isdigit()


def dec_scale(dtype: str) -> int:
    return int(dtype[3:])


def dec_dtype(scale: int) -> str:
    return f"dec{int(scale)}"


def phys_np(dtype: str):
    """Physical numpy dtype for a logical dtype (decN -> scaled int64)."""
    if is_dec(dtype):
        return np.int64
    return _PHYS_DTYPE[dtype]


@dataclass
class Column:
    dtype: str                      # logical dtype, see module docstring
    data: np.ndarray                # physical values
    valid: Optional[np.ndarray] = None   # bool mask, None == all valid
    dictionary: Optional[np.ndarray] = None  # object array of str, for dtype == "str"

    def __post_init__(self):
        assert self.dtype in _PHYS_DTYPE or is_dec(self.dtype), self.dtype

    def __len__(self) -> int:
        return len(self.data)

    @property
    def validity(self) -> np.ndarray:
        """Materialized validity mask."""
        if self.valid is None:
            return np.ones(len(self.data), dtype=bool)
        return self.valid

    def has_nulls(self) -> bool:
        return self.valid is not None and not bool(self.valid.all())

    def take(self, indices: np.ndarray) -> "Column":
        valid = None if self.valid is None else self.valid[indices]
        return Column(self.dtype, np.asarray(self.data)[indices], valid, self.dictionary)

    def with_valid(self, valid: Optional[np.ndarray]) -> "Column":
        if valid is not None and bool(valid.all()):
            valid = None
        return replace(self, valid=valid)

    def decode(self) -> np.ndarray:
        """Host object array with None for nulls (output materialization only)."""
        v = self.validity
        if is_dec(self.dtype):
            import decimal
            s = dec_scale(self.dtype)
            out = np.empty(len(self), dtype=object)
            data = np.asarray(self.data)
            for i in range(len(self)):
                out[i] = decimal.Decimal(int(data[i])).scaleb(-s) if v[i] \
                    else None
            return out
        if self.dtype == "str":
            out = np.empty(len(self), dtype=object)
            codes = np.asarray(self.data)
            ok = v & (codes >= 0)
            out[~ok] = None
            if self.dictionary is not None and ok.any():
                out[ok] = self.dictionary[codes[ok]]
            return out
        if self.dtype == "date":
            out = np.empty(len(self), dtype=object)
            days = np.asarray(self.data)
            dates = days.astype("datetime64[D]")
            for i in range(len(self)):
                out[i] = dates[i].item() if v[i] else None
            return out
        out = np.asarray(self.data).astype(object)
        out[~v] = None
        return out

    @staticmethod
    def from_values(dtype: str, values: np.ndarray,
                    valid: Optional[np.ndarray] = None,
                    dictionary: Optional[np.ndarray] = None) -> "Column":
        values = np.asarray(values, dtype=phys_np(dtype))
        if valid is not None and bool(valid.all()):
            valid = None
        return Column(dtype, values, valid, dictionary)

    @staticmethod
    def constant(dtype: str, value, n: int,
                 dictionary: Optional[np.ndarray] = None) -> "Column":
        if value is None:
            return Column(dtype, np.zeros(n, dtype=phys_np(dtype)),
                          np.zeros(n, dtype=bool), dictionary)
        if dtype == "str" and dictionary is None:
            dictionary = np.asarray([value], dtype=object)
            value = 0
        if is_dec(dtype) and not isinstance(value, (int, np.integer)):
            # python scalar (e.g. scalar-subquery Decimal result) -> scaled
            import decimal
            value = int(decimal.Decimal(str(value))
                        .scaleb(dec_scale(dtype)).to_integral_value(
                            rounding=decimal.ROUND_HALF_UP))
        return Column(dtype, np.full(n, value, dtype=phys_np(dtype)), None,
                      dictionary)


@dataclass
class Table:
    """A batch of rows: ordered named columns of equal length."""
    names: list[str]
    columns: list[Column]

    def __post_init__(self):
        assert len(self.names) == len(self.columns)

    @property
    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def column(self, i: int) -> Column:
        return self.columns[i]

    def take(self, indices: np.ndarray) -> "Table":
        return Table(self.names, [c.take(indices) for c in self.columns])

    def select(self, names: list[str]) -> "Table":
        idx = {n: i for i, n in enumerate(self.names)}
        return Table(list(names), [self.columns[idx[n]] for n in names])

    def slice(self, lo: int, hi: int) -> "Table":
        """Zero-copy row window [lo, hi) (numpy views; sharded morsel
        staging partitions each morsel into per-replica row blocks)."""
        return Table(self.names,
                     [Column(c.dtype, np.asarray(c.data)[lo:hi],
                             None if c.valid is None else c.valid[lo:hi],
                             c.dictionary)
                      for c in self.columns])

    def head(self, n: int) -> "Table":
        if self.num_rows <= n:
            return self
        return Table(self.names, [Column(c.dtype, np.asarray(c.data)[:n],
                                         None if c.valid is None else c.valid[:n],
                                         c.dictionary)
                                  for c in self.columns])

    def to_pylist(self) -> list[tuple]:
        decoded = [c.decode() for c in self.columns]
        return [tuple(d[i] for d in decoded) for i in range(self.num_rows)]

    @staticmethod
    def empty_like(names: list[str], columns: list[Column]) -> "Table":
        idx = np.empty(0, dtype=np.int64)
        return Table(list(names), [c.take(idx) for c in columns])


def concat_columns(cols: list[Column]) -> Column:
    """Concatenate columns of the same logical dtype (dictionary-merging strings)."""
    assert cols, "concat of zero columns"
    dtype = cols[0].dtype
    if dtype == "str":
        merged, remapped = merge_dictionaries(cols)
        data = np.concatenate(remapped)
    else:
        merged = None
        data = np.concatenate([np.asarray(c.data) for c in cols])
    if any(c.valid is not None for c in cols):
        valid = np.concatenate([c.validity for c in cols])
    else:
        valid = None
    return Column.from_values(dtype, data, valid, merged)


def merge_dictionaries(cols: list[Column]) -> tuple[np.ndarray, list[np.ndarray]]:
    """Build a common dictionary for string columns; returns (dict, per-col codes)."""
    value_to_code: dict[str, int] = {}
    remapped: list[np.ndarray] = []
    for c in cols:
        codes = np.asarray(c.data)
        d = c.dictionary if c.dictionary is not None else np.empty(0, dtype=object)
        lut = np.empty(len(d) + 1, dtype=np.int32)
        lut[-1] = _NULL_CODE
        for j, v in enumerate(d):
            if v not in value_to_code:
                value_to_code[v] = len(value_to_code)
            lut[j] = value_to_code[v]
        safe = np.where(codes >= 0, codes, len(d))
        remapped.append(lut[safe])
    merged = np.empty(len(value_to_code), dtype=object)
    for v, j in value_to_code.items():
        merged[j] = v
    return merged, remapped
