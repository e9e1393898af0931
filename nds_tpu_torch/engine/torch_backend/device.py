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
By default the slot is one packed byte buffer (``PackedTable``): each
column rides its narrow lane (u8/u16/u32/i32, bit-packed validity), a
dictionary code lane with a sorted host codebook, or run-length pairs,
chosen once per scan group (``plan_lanes``, ``plan_encodings``); the
programs unpack it inside the graph (``unpack_table``). The host packing
is byte for byte the reference's wire format.
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
    # encoded execution: `data` holds int32 codes into this sorted host
    # array of engine-unit values (a dictionary-encoded int/date/decN
    # column). Codes order as the values do, so filters, join and group
    # keys and sorts run on them; decode_col gives the values where
    # arithmetic, aggregates and outputs need them. A null slot holds
    # code 0 with valid False, as a plain column holds 0
    codebook: Optional[np.ndarray] = None

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
        if c.codebook is not None:
            # output materialization is a decode site: codes -> values
            book = c.codebook
            safe = np.clip(data, 0, max(len(book) - 1, 0))
            data = np.where(valid, book[safe] if len(book) else 0, 0)
        if isinstance(dictionary, CrossDict):
            data, dictionary = dictionary.compact(data, valid)
        if c.dtype == "str":
            data = np.where(valid, data, _NULL_CODE).astype(np.int32)
        cols.append(Column(c.dtype, data.astype(phys_np(c.dtype)),
                           None if bool(valid.all()) else valid,
                           dictionary))
    return Table(list(dt.names), cols)


def device_bytes(dt: "Optional[DTable | PackedTable]") -> int:
    """Device bytes held by a table (its alive mask, data and validity;
    a packed table's one buffer)."""
    if dt is None:
        return 0
    if isinstance(dt, PackedTable):
        return dt.data.numel()
    tensors = [dt.alive] + [x for c in dt.cols for x in (c.data, c.valid)]
    return sum(x.numel() * x.element_size() for x in tensors)


def free_dtable(dt: Optional[DTable]) -> None:
    """Release a table's buffers now: the table object gives up its
    tensors, so that a holder of the object no longer keeps them alive (the
    caching allocator takes a block back once its last tensor is gone)."""
    if dt is None:
        return
    if isinstance(dt, PackedTable):
        dt.data = dt.data.new_empty(0)
        return
    dt.cols = []
    dt.alive = dt.alive.new_empty(0)


# -- narrow-lane packed layout ------------------------------------------------
# Per-column lane on the wire (the reference's table, its x64 tier: the
# port's int and decimal columns are int64, its floats float64):
#
#   lane   wire bytes/row   device tensor     legal for
#   "b1"   1/8 (bit-packed) bool              bool
#   "u8"   1                int32             int, decN, date, str
#   "u16"  2                int32             int, decN, date, str
#   "u32"  4                int32             int, decN  (values < 2^31)
#   "i32"  4                int32             int, decN, date, str
#   "i64"  8                int64             int, decN
#   "f64"  8                float64           float
#
# Packing checks that the data fit their lane (LaneOverflowError, never a
# silent wrap). Narrow lanes come up as SIGNED int32, so sorts, compares
# and negations never meet unsigned wraparound; an int or decimal column
# whose range fits 32 bits executes on int32 and widens to int64 only at
# aggregate and arithmetic sites (widen_col).

_LANE_WIRE = {"b1": 0, "u8": 1, "u16": 2, "u32": 4, "i32": 4,
              "i64": 8, "f32": 4, "f64": 8}   # b1: special-cased, cap/8 B

# inclusive [lo, hi] value bounds per integer lane. i32 excludes INT32_MIN:
# a descending sort negates its key, and -INT32_MIN would wrap
_LANE_BOUNDS = {
    "u8": (0, (1 << 8) - 1),
    "u16": (0, (1 << 16) - 1),
    "u32": (0, (1 << 31) - 1),
    "i32": (-(1 << 31) + 1, (1 << 31) - 1),
    "i64": (-(1 << 63), (1 << 63) - 1),
}

_LANE_NP = {"u8": np.uint8, "u16": np.uint16, "u32": np.uint32,
            "i32": np.int32, "i64": np.int64, "f32": np.float32,
            "f64": np.float64}

# the torch dtype a lane's bytes are viewed as on the card (u16 through
# int16 and a mask; u32 values stay below 2^31, so int32 holds them)
_LANE_VIEW = {"u16": torch.int16, "u32": torch.int32, "i32": torch.int32,
              "i64": torch.int64, "f32": torch.float32,
              "f64": torch.float64}


def lane_legal(lane: str, dtype: str) -> bool:
    """May a column of logical `dtype` ride this lane at all? (Value
    ranges are checked against the data by pack_table.)"""
    if dtype == "float":
        return lane in ("f32", "f64")
    if dtype == "bool":
        return lane == "b1"
    if dtype in ("date", "str"):
        return lane in ("u8", "u16", "i32")
    if dtype == "int" or is_dec(dtype):
        return lane in ("u8", "u16", "u32", "i32", "i64")
    return False


def _lane_rows_bytes(lane: str, cap: int) -> int:
    if lane == "b1":
        return (cap + 7) // 8
    return _LANE_WIRE[lane] * cap


def lane_bytes(lanes: tuple, cap: int) -> int:
    """Wire bytes of a packed table: the columns' data sections plus
    (ncols + 1) bit-packed validity sections (the last: the alive mask)."""
    return sum(_lane_rows_bytes(ln, cap) for ln in lanes) + \
        (len(lanes) + 1) * ((cap + 7) // 8)


def _narrow_int_lane(lo: int, hi: int) -> str:
    if lo >= 0:
        for lane in ("u8", "u16", "u32"):
            if hi <= _LANE_BOUNDS[lane][1]:
                return lane
    if lo >= _LANE_BOUNDS["i32"][0] and hi <= _LANE_BOUNDS["i32"][1]:
        return "i32"
    return "i64"


def plan_lanes(dtypes: list, stats: Optional[list] = None,
               dict_sizes: Optional[list] = None,
               narrow: bool = True) -> Optional[tuple]:
    """A per-column lane spec from logical dtypes and optional value
    stats: stats[i] is (min, max) in engine units (scaled ints for decN,
    epoch days for date) or None (unknown: the widest legal lane);
    dict_sizes[i] the dictionary size of a "str" column.

    narrow=False gives the reference's wide layout (int/dec int64,
    date/str int32, float f64; None where a bool or str column cannot
    ride it). Returns None when some column cannot pack at all."""
    lanes = []
    for i, dt in enumerate(dtypes):
        st = stats[i] if stats is not None else None
        if dt == "float":
            lanes.append("f64")
        elif dt == "bool":
            if not narrow:
                return None
            lanes.append("b1")
        elif dt == "str":
            if not narrow:
                return None
            ds = dict_sizes[i] if dict_sizes is not None else None
            if ds is None:
                lanes.append("i32")
            elif ds <= _LANE_BOUNDS["u8"][1] + 1:
                lanes.append("u8")
            elif ds <= _LANE_BOUNDS["u16"][1] + 1:
                lanes.append("u16")
            else:
                lanes.append("i32")
        elif dt == "date":
            if not narrow or st is None:
                lanes.append("i32")
            else:
                lane = _narrow_int_lane(int(st[0]), int(st[1]))
                lanes.append(lane if lane in ("u8", "u16") else "i32")
        elif dt == "int" or is_dec(dt):
            if not narrow or st is None:
                lanes.append("i64")
            else:
                lanes.append(_narrow_int_lane(int(st[0]), int(st[1])))
        else:
            return None
    return tuple(lanes)


class LaneOverflowError(ValueError):
    """A column's values do not fit its lane (stats drift): raised
    instead of a silent wrap."""


class EncodingOverflowError(ValueError):
    """A column's data break its encoding: a value not in the planned
    dictionary, or more runs than the planned run capacity (stats
    drift): raised instead of a wrong morsel."""


# -- encoded execution: per-column wire encodings -----------------------------
#
#   enc              data section on the wire           on the card
#   "plain"          lane bytes * cap                   values
#   ("dict", card)   code-lane bytes * cap; the sorted  int32 codes + host
#                    codebook stays on the host, its    codebook (DCol.
#                    device copy made once per group    codebook)
#   ("rle", runs)    value-lane bytes * runs_cap +      values (expanded
#                    int32 run lengths * runs_cap       when unpacked)
#
# Chosen once per scan group from table-wide cardinality and run stats
# (Session.column_enc_stats), so every morsel of a pass has one layout.
# `runs` is the table's run count: no contiguous morsel window holds more.

def _runs_cap(runs_bound: int, cap: int) -> int:
    """An RLE column's run capacity a morsel: the table's run count (+1
    for the padding run) on the capacity ladder, at most cap."""
    return min(bucket(max(int(runs_bound) + 1, 8)), cap)


def enc_rows_bytes(lane: str, enc, cap: int) -> int:
    """Wire bytes of one column's data section under its encoding."""
    if isinstance(enc, tuple) and enc[0] == "rle":
        rc = _runs_cap(enc[1], cap)
        return _LANE_WIRE[lane] * rc + 4 * rc      # values + int32 lengths
    return _lane_rows_bytes(lane, cap)             # plain / dict codes


def _code_lane(card: int) -> Optional[str]:
    if card <= _LANE_BOUNDS["u8"][1] + 1:
        return "u8"
    if card <= _LANE_BOUNDS["u16"][1] + 1:
        return "u16"
    return None


def plan_encodings(dtypes: list, lanes: tuple, enc_stats: list,
                   cap_rows: int) -> Optional[tuple]:
    """Per-column encodings of a scan group from its lanes (plan_lanes)
    and encoding stats: enc_stats[i] is {"distinct": sorted engine-unit
    array or None, "runs": int or None} or None (plain). Returns (encs,
    wire lanes, codebooks), a dict column's lane being its code lane, or
    None when every column stays plain."""
    encs: list = []
    out_lanes: list = []
    books: list = []
    cap = bucket(max(int(cap_rows), 8))
    any_enc = False
    for dt, lane, st in zip(dtypes, lanes, enc_stats or [None] * len(lanes)):
        choice = ("plain", lane, None)
        if st and lane not in ("b1",) and dt not in ("str", "bool"):
            width = _LANE_WIRE[lane]
            best = width * cap                      # plain cost to beat
            dv = st.get("distinct")
            if dv is not None and dt != "float":
                dv = np.asarray(dv)
                book = dv.astype(np.int64 if lane == "i64" else np.int32)
                if len(book) == 0:
                    book = np.zeros(1, dtype=book.dtype)
                clane = _code_lane(len(book))
                if clane is not None and _LANE_WIRE[clane] < width:
                    cost = _LANE_WIRE[clane] * cap
                    if cost < best:
                        best = cost
                        choice = (("dict", len(book)), clane, book)
            runs = st.get("runs")
            if runs is not None:
                cost = enc_rows_bytes(lane, ("rle", int(runs)), cap)
                # rle must beat plain and the dict candidate by 2x
                if cost * 2 <= best:
                    choice = (("rle", int(runs)), lane, None)
        encs.append(choice[0])
        out_lanes.append(choice[1])
        books.append(choice[2])
        any_enc = any_enc or choice[0] != "plain"
    if not any_enc:
        return None
    return tuple(encs), tuple(out_lanes), tuple(books)


def enc_lane_bytes(lanes: tuple, cap: int, encs: Optional[tuple]) -> int:
    """lane_bytes over encodings (None: all plain)."""
    if not encs:
        return lane_bytes(lanes, cap)
    return sum(enc_rows_bytes(ln, e, cap) for ln, e in zip(lanes, encs)) + \
        (len(lanes) + 1) * ((cap + 7) // 8)


def enc_tag(enc) -> str:
    """An encoding as a stats string: "plain", "dict[300]", "rle[40]"."""
    if isinstance(enc, tuple):
        return f"{enc[0]}[{enc[1]}]"
    return str(enc)


# -- codebooks on the card ----------------------------------------------------
# A scan group's codebooks are the same objects for every morsel: the slot
# uploads them once when it is made (outside any capture) and holds them,
# and decode sites and join remaps find them here by identity.

_BOOK_CACHE: dict = {}          # (id(book), device) -> (book, tensor)
_BOOK_CACHE_MAX = 256

# decode sites (decode_col calls that decoded) and the column slots they
# decoded, and codebook uploads and reuses: the evidence that execution
# stays on codes (the reference's DECODE_SITES / DICT_UPLOADS_SAVED)
_DECODE_STATS = {"sites": 0, "rows": 0, "book_uploads": 0, "book_reuses": 0}


def decode_stats() -> dict:
    return dict(_DECODE_STATS)


def _device_key(device) -> str:
    """A device's cache key: "cuda" and "cuda:0" are one card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def codebook_device(book: np.ndarray, device) -> torch.Tensor:
    """The device copy of a codebook, uploaded at its first use."""
    dev = torch.device(device)
    key = (id(book), _device_key(dev))
    ent = _BOOK_CACHE.get(key)
    if ent is not None and ent[0] is book:
        _DECODE_STATS["book_reuses"] += 1
        return ent[1]
    if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
        # a capture cannot hold this copy: the slot uploads its group's
        # codebooks before any capture
        raise RuntimeError("a codebook reached the card inside a capture")
    if len(_BOOK_CACHE) >= _BOOK_CACHE_MAX:
        _BOOK_CACHE.clear()     # holders (slots) keep their tensors
    t = torch.from_numpy(np.ascontiguousarray(book)).to(dev)
    _BOOK_CACHE[key] = (book, t)
    _DECODE_STATS["book_uploads"] += 1
    return t


def release_codebooks(books, device) -> None:
    """Forget the device copies of `books` (a closing slot's)."""
    dev = _device_key(device)
    for b in books:
        if b is not None:
            ent = _BOOK_CACHE.get((id(b), dev))
            if ent is not None and ent[0] is b:
                del _BOOK_CACHE[(id(b), dev)]


def decode_col(c: DCol) -> DCol:
    """An encoded column's values: codes gather through the device
    codebook (clamped, as every gather is; null and dead slots stay
    canonical zeros). The sites that need values call it: arithmetic and
    aggregate arguments, compares across codebooks, outputs; filters on
    literals, join and group keys and sorts stay on the codes."""
    if c.codebook is None:
        return c
    book = codebook_device(c.codebook, c.data.device)
    safe = c.data.long().clamp(0, book.shape[0] - 1)
    data = torch.where(c.valid, book[safe],
                       torch.zeros((), dtype=book.dtype,
                                   device=book.device))
    _DECODE_STATS["sites"] += 1
    _DECODE_STATS["rows"] += int(c.data.shape[0])
    return replace(c, data=data, codebook=None)


def encode_against(book: np.ndarray, c: DCol) -> torch.Tensor:
    """A plain column's values in another column's code space: the code
    where the value is in the codebook, -1 (matches no code) elsewhere. A
    join key keeps the encoded side on its codes this way: the plain side
    pays one search instead of the encoded side a decode a row."""
    dev = codebook_device(book, c.data.device)
    vals = c.canon().data
    ct = torch.promote_types(dev.dtype, vals.dtype)
    bw, vw = dev.to(ct), vals.to(ct)
    idx = torch.searchsorted(bw, vw).clamp_(0, dev.shape[0] - 1)
    return torch.where(bw[idx] == vw, idx.to(torch.int32),
                       torch.full((), -1, dtype=torch.int32,
                                  device=vals.device))


def widen_col(c: DCol) -> DCol:
    """A column at its physical width: an encoded column decodes and a
    narrow-lane int32 tensor of an int or decimal column widens to int64.
    Aggregate and window arguments and decimal rescaling call it (an int32
    sum would wrap); filters, join and group keys and sorts stay narrow."""
    c = decode_col(c)
    if c.dtype in ("bool", "str", "date", "float"):
        return c
    pd = phys_dtype(c.dtype)
    if c.data.dtype == pd or c.data.dtype.is_floating_point or \
            c.data.dtype == torch.bool:
        return c
    return replace(c, data=c.data.to(pd))


@dataclass
class PackedTable:
    """A morsel as one packed byte buffer: the columns' data sections in
    order (each on its lane and encoding), then one bit-packed validity
    section a column, then the alive mask. The programs unpack it on the
    card (unpack_table) into views of the buffer, so one CUDA graph
    captured over a slot's buffer serves every morsel."""
    names: list[str]
    dtypes: list[str]           # logical dtypes
    lanes: tuple                # wire lanes (a dict column's code lane)
    cap: int                    # padded row capacity
    data: torch.Tensor          # uint8[enc_lane_bytes(lanes, cap, encs)]
    dictionaries: tuple = ()    # host dictionaries of "str" columns
    encs: tuple = ()            # per-column encodings; () = all plain
    codebooks: tuple = ()       # sorted host values of dict columns

    @property
    def capacity(self) -> int:
        return self.cap


def scan_layout(t) -> Optional[tuple]:
    """A scan table's wire layout, part of a program's key: a packed
    table's lanes, encodings and codebook identities (None: a plain
    table)."""
    if not isinstance(t, PackedTable):
        return None
    return (tuple(t.lanes), tuple(t.encs),
            tuple(None if b is None else id(b) for b in t.codebooks))


def pack_table(table: Table, device, capacity: Optional[int] = None,
               lanes: Optional[tuple] = None, encs: Optional[tuple] = None,
               codebooks: Optional[tuple] = None) -> Optional[PackedTable]:
    """A host table packed and uploaded as one buffer; None if it cannot
    pack under the lane spec (default: the wide layout, which rejects
    bool and str columns). The lanes are the scan group's, chosen once
    from table-wide stats; values that do not fit raise."""
    if lanes is None:
        lanes = plan_lanes([c.dtype for c in table.columns], narrow=False)
        if lanes is None:
            return None
    if len(lanes) != len(table.columns):
        raise ValueError(f"{len(lanes)} lanes for {len(table.columns)} "
                         "columns")
    n = table.num_rows
    cap = capacity if capacity is not None else bucket(n)
    payload, dicts = _pack_payload(table, lanes, n, cap, encs, codebooks)
    return PackedTable(list(table.names), [c.dtype for c in table.columns],
                       tuple(lanes), cap,
                       torch.from_numpy(payload).to(torch.device(device)),
                       tuple(dicts), tuple(encs) if encs else (),
                       tuple(codebooks) if codebooks else ())


def _pack_payload(table: Table, lanes: tuple, n: int, cap: int,
                  encs: Optional[tuple] = None,
                  codebooks: Optional[tuple] = None) -> tuple[np.ndarray,
                                                              list]:
    """The packed wire bytes of a table (the reference's format) and its
    columns' string dictionaries."""
    out = np.empty(enc_lane_bytes(tuple(lanes), cap, encs), dtype=np.uint8)
    dicts = pack_into(out, table, lanes, n, cap, encs, codebooks)
    return out, dicts


def _put_bits(sec: np.ndarray, bits: Optional[np.ndarray], n: int) -> None:
    """Bit-pack n row flags (None: all set) into `sec`, little bit order,
    zeros past them."""
    k = (n + 7) // 8
    if bits is None:
        sec[:n // 8] = 0xFF
        if n % 8:
            sec[n // 8] = (1 << (n % 8)) - 1
    elif n:
        sec[:k] = np.packbits(bits[:n], bitorder="little")
    sec[k:] = 0


def _pack_col_rle(name: str, buf: np.ndarray, lane: str, runs_bound: int,
                  cap: int, sec: np.ndarray) -> None:
    """(values, run lengths) of one canonical cap-padded column buffer
    into its section. The lengths sum to cap exactly (the padding rides
    the last run); more runs than planned is stats drift."""
    rc = _runs_cap(runs_bound, cap)
    w = _LANE_WIRE[lane]
    vbuf = sec[:w * rc].view(_LANE_NP[lane])
    lbuf = sec[w * rc:w * rc + 4 * rc].view(np.int32)
    vbuf[:] = 0
    lbuf[:] = 0
    if cap == 0:
        return
    starts = np.concatenate(
        [[0], np.flatnonzero(buf[1:] != buf[:-1]) + 1])
    if len(starts) > rc:
        raise EncodingOverflowError(
            f"column {name!r}: {len(starts)} runs overflow the planned "
            f"run capacity {rc} (runs bound {runs_bound})")
    vbuf[:len(starts)] = buf[starts]
    lbuf[:len(starts)] = np.diff(np.concatenate([starts, [cap]]))


def _dict_codes(name: str, data: np.ndarray, v: np.ndarray, n: int,
                book: np.ndarray) -> np.ndarray:
    """Row codes into a sorted codebook; a valid value missing from it is
    stats drift (null and dead slots ride code 0 like plain zeros)."""
    idx = np.searchsorted(book, data)
    safe = np.clip(idx, 0, max(len(book) - 1, 0))
    ok = (idx < len(book)) & (book[safe] == data) if len(book) else \
        np.zeros(len(data), dtype=bool)
    bad = ~ok & v
    if n and bad[:n].any():
        missing = data[:n][bad[:n]][0]
        raise EncodingOverflowError(
            f"column {name!r}: value {int(missing)} not in the planned "
            f"dictionary (card {len(book)})")
    return np.where(v, safe, 0).astype(np.int64)


def pack_into(out: np.ndarray, table: Table, lanes: tuple, n: int, cap: int,
              encs: Optional[tuple] = None,
              codebooks: Optional[tuple] = None) -> list:
    """Pack a host table (n rows, padded to cap) into the uint8 buffer
    `out` of enc_lane_bytes(lanes, cap, encs) bytes, in place (a slot's
    pinned buffer); returns the columns' string dictionaries. Raises
    LaneOverflowError / EncodingOverflowError where the data break their
    lane or encoding."""
    vbytes = (cap + 7) // 8
    off = 0
    voff = sum(enc_rows_bytes(ln, encs[i] if encs else "plain", cap)
               for i, ln in enumerate(lanes))
    dicts = []
    for ci, (c, lane) in enumerate(zip(table.columns, lanes)):
        name = table.names[ci]
        enc = encs[ci] if encs else "plain"
        dict_enc = isinstance(enc, tuple) and enc[0] == "dict"
        if not dict_enc and not lane_legal(lane, c.dtype):
            raise LaneOverflowError(
                f"column {name!r}: lane {lane!r} illegal for dtype "
                f"{c.dtype!r}")
        data = np.asarray(c.data)
        if c.dtype == "str":
            # canonical null slot for codes is 0 (valid=False marks them)
            data = np.where(c.validity & (data >= 0), data, 0)
            dicts.append(c.dictionary)
        else:
            dicts.append(None)
            if c.valid is not None:
                data = np.where(c.valid, data, np.zeros((), data.dtype))
        if dict_enc:
            data = _dict_codes(name, data, c.validity, n, codebooks[ci])
        sz = enc_rows_bytes(lane, enc, cap)
        sec = out[off:off + sz]
        if lane == "b1":
            _put_bits(sec, data[:n].astype(bool), n)
        else:
            lo, hi = _LANE_BOUNDS.get(lane, (None, None))
            if lo is not None and n and data.size:
                dmin, dmax = int(data[:n].min()), int(data[:n].max())
                if dmin < lo or dmax > hi:
                    raise LaneOverflowError(
                        f"column {name!r} values [{dmin}, {dmax}] "
                        f"overflow lane {lane!r}")
            if isinstance(enc, tuple) and enc[0] == "rle":
                buf = np.zeros(cap, dtype=_LANE_NP[lane])
                buf[:n] = data[:n]
                _pack_col_rle(name, buf, lane, enc[1], cap, sec)
            else:
                dst = sec.view(_LANE_NP[lane])
                dst[:n] = data[:n]
                dst[n:] = 0
        _put_bits(out[voff:voff + vbytes], c.valid, n)
        off += sz
        voff += vbytes
    _put_bits(out[voff:voff + vbytes], None, n)
    return dicts


def _unpack_bits(seg: torch.Tensor, cap: int) -> torch.Tensor:
    """Little-order bits of a uint8 section as a bool tensor of cap."""
    shifts = torch.arange(8, dtype=torch.uint8, device=seg.device)
    return ((seg.unsqueeze(1) >> shifts) & 1).reshape(-1)[:cap] \
        .to(torch.bool)


def _unpack_lane(seg: torch.Tensor, lane: str, cap: int) -> torch.Tensor:
    """One column's bytes as a tensor: a view of the buffer for the
    signed lanes (the section must start at a multiple of the lane width:
    every section does when cap is a multiple of 64), widened to int32
    for u8 and u16."""
    if lane == "b1":
        return _unpack_bits(seg, cap)
    if lane == "u8":
        return seg.to(torch.int32)
    width = _LANE_WIRE[lane]
    if seg.storage_offset() % width:
        raise AssertionError(f"lane {lane!r} section at byte "
                             f"{seg.storage_offset()} is not aligned")
    out = seg.view(_LANE_VIEW[lane])
    if lane == "u16":
        out = out.to(torch.int32) & 0xFFFF
    return out


def unpack_table(p: PackedTable) -> DTable:
    """A packed table's columns on the card, in torch ops a CUDA graph
    captures: data sections as views of the buffer, validity bits
    unpacked, a dict column as int32 codes with its host codebook
    attached, an RLE column expanded to rows (repeat_interleave with its
    output size given, so no host sync)."""
    vbytes = (p.cap + 7) // 8
    encs = p.encs or ("plain",) * len(p.dtypes)
    dicts = p.dictionaries or (None,) * len(p.dtypes)
    books = p.codebooks or (None,) * len(p.dtypes)
    off = 0
    voff = sum(enc_rows_bytes(ln, e, p.cap) for ln, e in zip(p.lanes, encs))
    cols = []
    for dtype, lane, dc, enc, book in zip(p.dtypes, p.lanes, dicts, encs,
                                          books):
        sz = enc_rows_bytes(lane, enc, p.cap)
        seg = p.data[off:off + sz]
        if isinstance(enc, tuple) and enc[0] == "rle":
            rc = _runs_cap(enc[1], p.cap)
            vsz = _LANE_WIRE[lane] * rc
            vals = _unpack_lane(seg[:vsz], lane, rc)
            lens = _unpack_lane(seg[vsz:vsz + 4 * rc], "i32", rc)
            d = torch.repeat_interleave(vals, lens.long(),
                                        output_size=p.cap)
            book = None
        else:
            d = _unpack_lane(seg, lane, p.cap)
            if not (isinstance(enc, tuple) and enc[0] == "dict"):
                book = None
        valid = _unpack_bits(p.data[voff:voff + vbytes], p.cap)
        cols.append(DCol(dtype, d, valid, dc, codebook=book))
        off += sz
        voff += vbytes
    alive = _unpack_bits(p.data[voff:voff + vbytes], p.cap)
    return DTable(list(p.names), cols, alive)


# -- the streamed path's morsel slot -------------------------------------------

#: slots not yet closed (MorselSlot.close); the streamed path closes a
#: group's slot with its programs, and on any failure mid-stream
_OPEN_SLOTS: "weakref.WeakSet" = weakref.WeakSet()


class MorselSlot:
    """A scan group's fixed device slot for its morsels.

    ``table`` is what the group's programs read (its scan key in the
    executor's scan cache), at addresses that stay the same for every
    morsel, so that one CUDA graph captured over it replays every morsel.
    With a lane spec (``lanes``, and ``encs``/``codebooks`` where the group
    is encoded) it is a PackedTable over one device byte buffer of
    enc_lane_bytes(lanes, capacity, encs) bytes, unpacked by the programs
    on the card; the group's codebooks go to the card once, here, outside
    any capture, and leave with the slot. Without one it is a DTable of
    ``capacity`` rows per column (int64 data, a byte of validity a row). A
    morsel is staged in two steps:

    - ``stage`` (any thread): the host Table's columns go into the pinned
      host buffers (packed in place, or padded column by column, ``alive``
      false past the morsel's rows as ``to_device`` pads), which are copied
      on a copy stream of the slot's own into the device staging buffers.
      The copy waits on the event recorded after the last ``load``, so that
      it never overwrites the staging buffers before the slot has taken
      them. A packed morsel whose data break the lanes or encodings raises
      LaneOverflowError or EncodingOverflowError;
    - ``load`` (the compute thread, on the executor's stream, after the
      previous morsel's run): staging buffers -> slot, device to device,
      and the morsel's string dictionaries go onto the slot's table.

    On the CPU the staging buffers are host memory and no stream is used."""

    def __init__(self, names: list, dtypes: list, capacity: int, device,
                 lanes: Optional[tuple] = None, encs: Optional[tuple] = None,
                 codebooks: Optional[tuple] = None):
        self.device = torch.device(device)
        self.capacity = capacity
        cuda = self.device.type == "cuda"
        self._dtypes = list(dtypes)
        self.lanes = tuple(lanes) if lanes is not None else None
        self._encs = tuple(encs) if encs else ()
        self._books = tuple(codebooks) if codebooks else ()
        self._dicts: list = [None] * len(dtypes)
        if self.lanes is not None:
            if capacity % 64:
                # then every section starts at a multiple of 8 bytes (a
                # bit-packed section is capacity/8 bytes long), as the
                # byte views of unpack_table need
                raise ValueError(f"a packed slot's capacity ({capacity}) "
                                 "must be a multiple of 64")
            nbytes = enc_lane_bytes(self.lanes, capacity, self._encs)

            def alloc(dev, pin=False):
                return [torch.zeros(nbytes, dtype=torch.uint8, device=dev,
                                    pin_memory=pin)]
            self._slot = alloc(self.device)
            # held by the slot: a graph replays the gathers of its capture
            self._book_tensors = [codebook_device(b, self.device)
                                  for b in self._books if b is not None]
            self.table = PackedTable(list(names), list(dtypes), self.lanes,
                                     capacity, self._slot[0],
                                     tuple(self._dicts), self._encs,
                                     self._books)
        else:
            def alloc(dev, pin=False):
                data = [torch.zeros(capacity, dtype=phys_dtype(d),
                                    device=dev, pin_memory=pin)
                        for d in dtypes]
                valid = [torch.zeros(capacity, dtype=torch.bool, device=dev,
                                     pin_memory=pin) for _ in dtypes]
                alive = torch.zeros(capacity, dtype=torch.bool, device=dev,
                                    pin_memory=pin)
                return data + valid + [alive]
            self._slot = alloc(self.device)
            self._book_tensors = []
            k = len(dtypes)
            self.table = DTable(list(names), [
                DCol(d, self._slot[i], self._slot[k + i], None)
                for i, d in enumerate(dtypes)], self._slot[-1])
        self._host = alloc("cpu", pin=cuda)
        self._staging = alloc(self.device) if cuda else self._host
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self._loaded = None         # event after the last load (CUDA)
        self._staged: Optional[tuple] = None   # (rows, dictionaries)
        self.bytes = device_bytes(self.table)
        _OPEN_SLOTS.add(self)

    def stage(self, morsel: Table) -> float:
        """Put a host morsel (at most ``capacity`` rows, the slot's
        columns in order) into the staging buffers; returns the
        milliseconds of its host-to-device copy (CUDA events; 0.0 on the
        CPU)."""
        n = morsel.num_rows
        if n > self.capacity:
            raise ValueError(f"morsel of {n} rows over the slot's "
                             f"{self.capacity}")
        if self.lanes is not None:
            dicts = pack_into(self._host[0].numpy(), morsel, self.lanes, n,
                              self.capacity, self._encs, self._books)
        else:
            dicts = [c.dictionary for c in morsel.columns]
            self._fill_plain(morsel, n)
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
        self._staged = (n, dicts)
        return ms

    def _fill_plain(self, morsel: Table, n: int) -> None:
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

    def load(self):
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
        self._dicts = list(dicts)
        if isinstance(self.table, PackedTable):
            self.table = replace(self.table, dictionaries=tuple(dicts))
        else:
            self.table = DTable(list(self.table.names), [
                replace(c, dictionary=dct)
                for c, dct in zip(self.table.cols, dicts)], self.table.alive)
        return self.table

    def str_dicts(self) -> list:
        """The loaded morsel's string dictionaries, column order."""
        return [d for d, t in zip(self._dicts, self._dtypes) if t == "str"]

    def close(self) -> None:
        """Give up every buffer (slot, staging, pinned host memory) and
        the codebooks' device copies."""
        free_dtable(self.table)
        release_codebooks(self._books, self.device)
        self._slot = self._staging = self._host = self._book_tensors = []
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
