"""Device-resident columnar data for the torch backend.

Counterpart of ``nds_tpu/engine/jax_backend/device.py`` for in-core scans.
Every table lives in a padded buffer of ``capacity`` rows with an ``alive``
row mask; capacities follow the same ladder (``bucket``) as the reference,
so both engines plan identical shapes. Strings are dictionary codes (int32)
on the device; dictionaries stay on the host and string compute happens on
the dictionary (host lookup tables gathered on the device).

Not in this slice: the packed narrow-lane upload layout and encoded
(codebook) columns of the streamed path.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..column import Column, Table, is_dec, phys_np

_NULL_CODE = -1

# Below this row count capacities are powers of two; above it the ladder
# gains 3*2^(k-1) midpoints, bounding overshoot at 1.5x (the reference's
# ladder, kept so that both engines choose the same capacities).
CAP_LADDER_MIN = 4 << 20


def bucket(n: int, minimum: int = 8) -> int:
    """Round a row count up to the capacity ladder: powers of two, plus
    3*2^(k-1) midpoints above CAP_LADDER_MIN rows."""
    c = max(int(n), minimum)
    p = 1 << (c - 1).bit_length()
    if p > CAP_LADDER_MIN:
        mid = 3 * (p >> 2)          # 0.75 * p, the step between p/2 and p
        if c <= mid:
            return mid
    return p


_PHYS = {"int": torch.int64, "float": torch.float64, "bool": torch.bool,
         "date": torch.int32, "str": torch.int32}


def phys_dtype(logical: str) -> torch.dtype:
    """Device dtype of a logical dtype (decN: exact scaled int64)."""
    if is_dec(logical):
        return torch.int64
    return _PHYS[logical]


@dataclass
class DCol:
    """A device column: padded values + always-materialized validity mask.

    Invariant: slots that are null (or dead rows) hold canonical zeros so
    grouping/sorting kernels see deterministic payloads."""
    dtype: str                 # logical: int | float | bool | date | str | decN
    data: torch.Tensor
    valid: torch.Tensor        # bool, same length
    dictionary: Optional[np.ndarray] = None  # host object array for "str"

    def __len__(self) -> int:
        return int(self.data.shape[0])

    def canon(self) -> "DCol":
        zero = torch.zeros((), dtype=self.data.dtype, device=self.data.device)
        return replace(self, data=torch.where(self.valid, self.data, zero))


@dataclass
class DTable:
    names: list[str]
    cols: list[DCol]
    alive: torch.Tensor        # bool row mask, length == capacity

    @property
    def capacity(self) -> int:
        return int(self.alive.shape[0])

    def count(self) -> torch.Tensor:
        return self.alive.sum()


def to_device(table: Table, device, capacity: Optional[int] = None) -> DTable:
    """Upload a host Table into padded device buffers (capacity = bucket of
    the row count unless given)."""
    n = table.num_rows
    cap = capacity if capacity is not None else bucket(n)
    dev = torch.device(device)

    def put(arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(dev)

    cols = []
    for c in table.columns:
        data = np.asarray(c.data)
        buf = np.zeros(cap, dtype=phys_np(c.dtype))
        v = np.zeros(cap, dtype=bool)
        v[:n] = c.validity
        if c.dtype == "str":
            # canonical null slot for codes is 0 (valid=False marks them)
            buf[:n] = np.where(c.validity & (data >= 0), data, 0)
        else:
            buf[:n] = np.where(c.validity, data, 0)
        cols.append(DCol(c.dtype, put(buf), put(v), c.dictionary))
    alive = np.zeros(cap, dtype=bool)
    alive[:n] = True
    return DTable(list(table.names), cols, put(alive))


def to_host(dt: DTable) -> Table:
    """Materialize a device table back into a host Table (alive rows only,
    in physical order)."""
    alive = dt.alive.cpu().numpy()
    idx = np.flatnonzero(alive)
    cols = []
    for c in dt.cols:
        data = c.data.cpu().numpy()[idx]
        valid = c.valid.cpu().numpy()[idx]
        if c.dtype == "str":
            data = np.where(valid, data, _NULL_CODE).astype(np.int32)
        cols.append(Column(c.dtype, data.astype(phys_np(c.dtype)),
                           None if bool(valid.all()) else valid,
                           c.dictionary))
    return Table(list(dt.names), cols)


def string_rank_maps(dictionary: Optional[np.ndarray]
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Host LUTs for a string dictionary: (code -> dense lexicographic rank,
    dense rank -> representative code).

    Equal strings get EQUAL ranks (a dictionary may hold duplicates), so
    mapping an aggregated rank back to a code goes through the rank->code
    table, not through argsort position."""
    if dictionary is None or len(dictionary) == 0:
        return np.zeros(1, dtype=np.int32), np.zeros(1, dtype=np.int32)
    vals = dictionary.astype(str)
    order = np.argsort(vals, kind="stable")
    svals = vals[order]
    dense = np.cumsum(np.concatenate(
        [[0], (svals[1:] != svals[:-1]).astype(np.int32)])).astype(np.int32)
    ranks = np.empty(len(vals), dtype=np.int32)
    ranks[order] = dense
    rank_to_code = np.zeros(int(dense[-1]) + 1, dtype=np.int32)
    # reversed assignment => the FIRST occurrence in sorted order wins
    rank_to_code[dense[::-1]] = order[::-1].astype(np.int32)
    return ranks, rank_to_code


def string_rank_lut(dictionary: Optional[np.ndarray]) -> np.ndarray:
    """Host LUT: dictionary code -> dense lexicographic rank."""
    return string_rank_maps(dictionary)[0]


def lut_gather(codes: torch.Tensor, lut: np.ndarray) -> torch.Tensor:
    """Gather a host lookup table at device codes (codes clamp into the
    table, as the reference's gathers do)."""
    dlut = torch.from_numpy(np.ascontiguousarray(lut)).to(codes.device)
    if dlut.shape[0] == 0:
        return torch.zeros(codes.shape, dtype=dlut.dtype, device=codes.device)
    return dlut[codes.long().clamp(0, dlut.shape[0] - 1)]


def rank_key(c: DCol) -> torch.Tensor:
    """Device tensor usable as a grouping/ordering key for any logical
    dtype: strings rank lexicographically, bools become int32, and null
    slots hold 0."""
    if c.dtype == "str":
        ranks = lut_gather(c.data, string_rank_lut(c.dictionary))
        return torch.where(c.valid, ranks, torch.zeros_like(ranks))
    if c.dtype == "bool":
        return torch.where(c.valid, c.data, False).to(torch.int32)
    return torch.where(c.valid, c.data, torch.zeros_like(c.data))
