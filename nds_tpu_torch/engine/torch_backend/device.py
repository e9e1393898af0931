"""Device-resident columnar data for the torch backend.

Counterpart of ``nds_tpu/engine/jax_backend/device.py`` for in-core scans.
Every table lives in a padded buffer of ``capacity`` rows with an ``alive``
row mask; capacities follow the same ladder (``bucket``) as the reference,
so both engines plan identical shapes. Strings are dictionary codes (int32)
on the device; dictionaries stay on the host and string compute happens on
the dictionary (host lookup tables gathered on the device).

Under compiled replay a string concatenation's dictionary is the cross
product of its parts' (``CrossDict``), and host-to-device constants go
through the replayed program's ``Uploads``, so that a CUDA graph captures
no host copy.

The streamed path stages each morsel into a fixed device slot
(``MorselSlot``): pinned host buffers, a copy stream, and one staging
buffer from which the morsel is copied into the slot on the compute
stream, so that a CUDA graph captured over the slot replays every morsel.

Not in this slice: the packed narrow-lane upload layout and encoded
(codebook) columns of the streamed path.
"""
from __future__ import annotations

import threading
import weakref
from contextlib import contextmanager
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
        return upload(arr, dev)

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
        dictionary = c.dictionary
        if isinstance(dictionary, CrossDict):
            data, dictionary = dictionary.compact(data, valid)
        if c.dtype == "str":
            data = np.where(valid, data, _NULL_CODE).astype(np.int32)
        cols.append(Column(c.dtype, data.astype(phys_np(c.dtype)),
                           None if bool(valid.all()) else valid,
                           dictionary))
    return Table(list(dt.names), cols)


def device_bytes(dt: Optional[DTable]) -> int:
    """Device bytes held by a table (its alive mask, data and validity)."""
    if dt is None:
        return 0
    tensors = [dt.alive] + [x for c in dt.cols for x in (c.data, c.valid)]
    return sum(x.numel() * x.element_size() for x in tensors)


def free_dtable(dt: Optional[DTable]) -> None:
    """Release a table's buffers now: the table object gives up its
    tensors, so that a holder of the object no longer keeps them alive (the
    caching allocator takes a block back once its last tensor is gone)."""
    if dt is None:
        return
    dt.cols = []
    dt.alive = dt.alive.new_empty(0)


# -- the streamed path's morsel slot -------------------------------------------

#: slots not yet closed (MorselSlot.close); the streamed path closes a
#: group's slot with its programs, and on any failure mid-stream
_OPEN_SLOTS: "weakref.WeakSet" = weakref.WeakSet()


class MorselSlot:
    """A scan group's fixed device slot for its morsels.

    ``table`` is the DTable the group's programs read (its scan key in the
    executor's scan cache): ``capacity`` rows per column, at addresses that
    stay the same for every morsel, so that one CUDA graph captured over it
    replays every morsel. A morsel is staged in two steps:

    - ``stage`` (any thread): the host Table's columns go into pinned host
      buffers, padded to capacity with ``alive`` false past the morsel's
      rows (as ``to_device`` pads), and are copied on a copy stream of the
      slot's own into one device staging buffer. The copy waits on the
      event recorded after the last ``load``, so that it never overwrites
      the staging buffer before the slot has taken it;
    - ``load`` (the compute thread, on the executor's stream, after the
      previous morsel's run): staging buffer -> slot, device to device,
      and the morsel's string dictionaries go onto the slot's columns.

    On the CPU the staging buffer is host memory and no stream is used."""

    def __init__(self, names: list, dtypes: list, capacity: int, device):
        self.device = torch.device(device)
        self.capacity = capacity
        cuda = self.device.type == "cuda"

        def alloc(dev, pin=False):
            data = [torch.zeros(capacity, dtype=phys_dtype(d), device=dev,
                                pin_memory=pin) for d in dtypes]
            valid = [torch.zeros(capacity, dtype=torch.bool, device=dev,
                                 pin_memory=pin) for _ in dtypes]
            alive = torch.zeros(capacity, dtype=torch.bool, device=dev,
                                pin_memory=pin)
            return data + valid + [alive]
        self._slot = alloc(self.device)
        k = len(dtypes)
        self.table = DTable(list(names), [
            DCol(d, self._slot[i], self._slot[k + i], None)
            for i, d in enumerate(dtypes)], self._slot[-1])
        self._dtypes = list(dtypes)
        self._host = alloc("cpu", pin=cuda)
        self._staging = alloc(self.device) if cuda else self._host
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self._loaded = None         # event after the last load (CUDA)
        self._staged: Optional[tuple] = None   # (rows, dictionaries)
        self.bytes = device_bytes(self.table)
        _OPEN_SLOTS.add(self)

    def stage(self, morsel: Table) -> float:
        """Put a host morsel (at most ``capacity`` rows, the slot's
        columns in order) into the staging buffer; returns the milliseconds
        of its host-to-device copy (CUDA events; 0.0 on the CPU)."""
        n = morsel.num_rows
        if n > self.capacity:
            raise ValueError(f"morsel of {n} rows over the slot's "
                             f"{self.capacity}")
        k = len(self._dtypes)
        for i, c in enumerate(morsel.columns):
            data = np.asarray(c.data)
            hd = self._host[i].numpy()
            hv = self._host[k + i].numpy()
            if c.valid is None:
                hd[:n] = data
                hv[:n] = True
            else:
                valid = c.valid
                if c.dtype == "str":
                    # canonical null slot for codes is 0 (valid=False
                    # marks them)
                    valid = valid & (data >= 0)
                hd[:n] = np.where(valid, data, 0)
                hv[:n] = c.valid
            hd[n:] = 0
            hv[n:] = False
        ha = self._host[-1].numpy()
        ha[:n] = True
        ha[n:] = False
        ms = 0.0
        if self._copy_stream is not None:
            with torch.cuda.stream(self._copy_stream):
                if self._loaded is not None:
                    self._copy_stream.wait_event(self._loaded)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for d, h in zip(self._staging, self._host):
                    d.copy_(h, non_blocking=True)
                e1.record()
            # the pinned buffers are free again once the copy is done
            e1.synchronize()
            ms = e0.elapsed_time(e1)
        self._staged = (n, [c.dictionary for c in morsel.columns])
        return ms

    def load(self) -> DTable:
        """The staged morsel into the slot, on the current stream; returns
        the slot's table with the morsel's dictionaries."""
        if self._staged is None:
            raise RuntimeError("no morsel staged")
        _n, dicts = self._staged
        self._staged = None
        for d, s in zip(self._slot, self._staging):
            if d is not s:
                d.copy_(s, non_blocking=True)
        if self._copy_stream is not None:
            self._loaded = torch.cuda.Event()
            self._loaded.record()
        self.table = DTable(list(self.table.names), [
            replace(c, dictionary=dct)
            for c, dct in zip(self.table.cols, dicts)], self.table.alive)
        return self.table

    def close(self) -> None:
        """Give up every buffer (slot, staging, pinned host memory)."""
        free_dtable(self.table)
        self._slot = self._staging = self._host = []
        self._staged = self._loaded = None
        _OPEN_SLOTS.discard(self)


def open_slots() -> int:
    """Morsel slots not yet closed."""
    return len(_OPEN_SLOTS)


# -- compound string dictionaries (compiled replay) ---------------------------

#: the most entries a cross-product dictionary may materialize (the
#: reference's bound on its traced compound flatten)
CROSS_DICT_MAX = 1 << 20


class CrossDict:
    """The dictionary of a string concatenation under compiled replay: the
    mixed-radix cross product of the parts' dictionaries, each with a last
    slot "" for a NULL part, the last part varying fastest (the reference's
    ``_flatten_compound_traced``). Row codes are computed on the device, so
    the dictionary does not depend on the data. It materializes only where
    a consumer needs its strings (at most CROSS_DICT_MAX entries, as in the
    reference); the output (``to_host``) joins only the codes it holds."""

    def __init__(self, parts: list):
        self.parts = [np.concatenate([np.asarray(d, dtype=object),
                                      np.asarray([""], dtype=object)])
                      for d in parts]
        self.size = 1
        for d in self.parts:
            self.size *= len(d)
        self._values = None

    def __len__(self) -> int:
        return self.size

    def values(self) -> np.ndarray:
        if self._values is None:
            if self.size > CROSS_DICT_MAX:
                raise NotImplementedError(
                    f"compound string cross dictionary too large "
                    f"({self.size})")
            joined = np.asarray([""], dtype=object)
            for d in self.parts:
                joined = np.asarray([a + b for a in joined for b in d],
                                    dtype=object)
            self._values = joined
        return self._values

    def compact(self, codes: np.ndarray, valid: np.ndarray):
        """(codes, dictionary) of host rows: the strings of the codes held,
        as a sorted dictionary of their distinct values."""
        uniq, inverse = np.unique(np.where(valid, codes, 0),
                                  return_inverse=True)
        joined = np.full(len(uniq), "", dtype=object)
        rest = uniq.astype(np.int64)
        for d in reversed(self.parts):
            joined = d[rest % len(d)] + joined
            rest = rest // len(d)
        strs, remap = np.unique(joined.astype(str), return_inverse=True)
        return remap.astype(np.int32)[inverse.reshape(-1)], \
            strs.astype(object)


def dict_values(dictionary) -> Optional[np.ndarray]:
    """A column's dictionary as a host object array (a CrossDict
    materializes)."""
    if isinstance(dictionary, CrossDict):
        return dictionary.values()
    return dictionary


# -- host-to-device constants ------------------------------------------------

_tls = threading.local()


class Uploads:
    """The host-to-device constants of one compiled program (lookup tables,
    IN lists), in the order its replay makes them. The first replay
    uploads each one (pinned, without waiting on the device) and keeps it;
    every later replay, the one a CUDA graph captures among them, takes the
    kept tensor instead, after checking that the host computed the same
    array at the same point. A capture then holds no host copy."""

    def __init__(self):
        self.tensors: list = []
        self.hosts: list = []
        self.idx: Optional[int] = None      # None: still uploading

    def reuse(self) -> None:
        self.idx = 0

    def put(self, arr: np.ndarray, device: torch.device) -> torch.Tensor:
        if self.idx is None:
            t = torch.from_numpy(arr)
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            else:
                t = t.clone()
            self.tensors.append(t)
            self.hosts.append(arr)
            return t
        i = self.idx
        if i >= len(self.hosts) or self.hosts[i].dtype != arr.dtype or \
                not np.array_equal(self.hosts[i], arr):
            from .compiled import NotJittable
            raise NotJittable(f"constant upload {i} differs between replays")
        self.idx += 1
        return self.tensors[i]


@contextmanager
def uploads_active(uploads: Optional[Uploads]):
    """Route every ``upload`` of this thread through `uploads`."""
    prev = getattr(_tls, "uploads", None)
    _tls.uploads = uploads
    try:
        yield
    finally:
        _tls.uploads = prev


def upload(arr: np.ndarray, device) -> torch.Tensor:
    """A host array as a device tensor: through the active replay's
    Uploads where there is one, else a plain copy."""
    arr = np.ascontiguousarray(arr)
    uploads = getattr(_tls, "uploads", None)
    if uploads is not None:
        return uploads.put(arr, torch.device(device))
    return torch.from_numpy(arr).to(device)


def string_rank_maps(dictionary: Optional[np.ndarray]
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Host LUTs for a string dictionary: (code -> dense lexicographic rank,
    dense rank -> representative code).

    Equal strings get EQUAL ranks (a dictionary may hold duplicates), so
    mapping an aggregated rank back to a code goes through the rank->code
    table, not through argsort position."""
    if dictionary is None or len(dictionary) == 0:
        return np.zeros(1, dtype=np.int32), np.zeros(1, dtype=np.int32)
    vals = dict_values(dictionary).astype(str)
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
    dlut = upload(lut, codes.device)
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
