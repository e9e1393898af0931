"""Bound-expression evaluation on device columns.

Counterpart of ``nds_tpu/engine/jax_backend/jexprs.py``: the Spark-SQL null
semantics of the numpy oracle (engine/exprs.py) as torch compute. String
work never touches the device: predicates, substrings and parses are
computed once over the host dictionary and become lookup tables that the
device gathers at the row codes.

Encoded columns (``DCol.codebook``, dictionary codes of a packed morsel)
stay on their codes where the answer allows: a compare with a literal and
an IN list remap the literal into code space on the host (a hoisted
literal, a device scalar under replay, is not remapped: the column
decodes, as the reference's traced values do). Every other handler takes
its arguments decoded (``_args``); arithmetic that must not wrap widens
narrow int32 lanes first (``widen_col``).

Under compiled replay (``EvalCtx.replay``) nothing here reads device data
back: hoisted literals (BParam) and scalar subqueries are device scalars,
CONCAT takes a dictionary that does not depend on the data (device.CrossDict),
and a cast to string, whose dictionary does, raises.

Raises NotImplementedError for host-only cases; the eager executor falls
back to the numpy backend for that plan node.
"""
from __future__ import annotations

import decimal
import re
from typing import Callable, Optional

import numpy as np
import torch

from ..column import dec_scale, is_dec
from ..exprs import _scaled_in_values, _sql_str
from ..plan import BCall, BCol, BExpr, BLit, BParam, BScalarSubquery
from .device import (CrossDict, DCol, DTable, decode_col, dict_values,
                     lut_gather, phys_dtype, string_rank_lut, upload,
                     widen_col)

SubqueryEval = Callable[[object], object]


class EvalCtx:
    """Evaluation callbacks, passed in the `subquery_eval` position:
    `subquery` resolves BScalarSubquery plans to (value, validity),
    `param` resolves BParam slots to columns, and `replay` marks compiled
    replay (no device data may come back to the host)."""
    __slots__ = ("subquery", "param", "replay")

    def __init__(self, subquery=None, param=None, replay: bool = False):
        self.subquery = subquery
        self.param = param
        self.replay = replay


def _replay(sq) -> bool:
    return isinstance(sq, EvalCtx) and sq.replay


_F64 = torch.float64


def evaluate(expr: BExpr, table: DTable,
             subquery_eval: Optional[SubqueryEval] = None) -> DCol:
    n = int(table.alive.shape[0])
    dev = table.alive.device
    if isinstance(expr, BCol):
        return table.cols[expr.index]
    if isinstance(expr, BLit):
        return constant(expr.dtype, expr.value, n, dev)
    if isinstance(expr, BParam):
        param = subquery_eval.param \
            if isinstance(subquery_eval, EvalCtx) else None
        if param is None:
            raise RuntimeError("parameter slot encountered without values")
        return param(expr, n)
    if isinstance(expr, BScalarSubquery):
        sq = subquery_eval.subquery \
            if isinstance(subquery_eval, EvalCtx) else subquery_eval
        if sq is None:
            raise RuntimeError("scalar subquery encountered without evaluator")
        value, valid = sq(expr.plan)
        if isinstance(valid, torch.Tensor):
            # compiled replay: a device scalar and its validity, broadcast
            pd = phys_dtype(expr.dtype)
            data = torch.where(valid, value.to(pd), torch.zeros((), dtype=pd,
                                                               device=dev))
            return DCol(expr.dtype, data.expand(n).contiguous(),
                        valid.expand(n).contiguous())
        return constant(expr.dtype, value, n, dev)
    if isinstance(expr, BCall):
        handler = _HANDLERS.get(expr.op)
        if handler is None:
            raise NotImplementedError(f"device expression op {expr.op!r}")
        return handler(expr, table, subquery_eval)
    raise NotImplementedError(f"device expression {type(expr).__name__}")


def constant(dtype: str, value, n: int, device) -> DCol:
    """Broadcast a host scalar to a column (None => all NULL)."""
    pd = phys_dtype(dtype)
    if value is None:
        return DCol(dtype, torch.zeros(n, dtype=pd, device=device),
                    torch.zeros(n, dtype=torch.bool, device=device))
    ones = torch.ones(n, dtype=torch.bool, device=device)
    if dtype == "str":
        return DCol("str", torch.zeros(n, dtype=torch.int32, device=device),
                    ones, np.asarray([value], dtype=object))
    if dtype == "bool":
        value = bool(value)
    return DCol(dtype, torch.full((n,), value, dtype=pd, device=device), ones)


def _args(expr: BCall, table: DTable, sq) -> list[DCol]:
    """Evaluated arguments, encoded columns decoded: the generic handlers
    compute on values (the compare and IN handlers evaluate raw)."""
    return [decode_col(evaluate(a, table, sq)) for a in expr.args]


def _to_float(c: DCol) -> torch.Tensor:
    """Numeric column as float64 (decN descales: scaled int -> value)."""
    out = c.data.to(_F64)
    if is_dec(c.dtype):
        out = out / 10.0 ** dec_scale(c.dtype)
    return out


def _promote(a: torch.Tensor, b: torch.Tensor):
    if a.dtype != b.dtype:
        ct = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(ct), b.to(ct)
    return a, b


# -- string dictionary helpers (host side) -----------------------------------

def _dict(c: DCol) -> np.ndarray:
    return dict_values(c.dictionary) if c.dictionary is not None \
        else np.empty(0, dtype=object)


def _merge_dicts(*dicts: np.ndarray) -> tuple[np.ndarray, list[np.ndarray]]:
    """Common dictionary + per-input code remap LUTs (host)."""
    seen: dict[str, int] = {}
    luts = []
    for d in dicts:
        lut = np.empty(len(d), dtype=np.int32)
        for i, v in enumerate(d):
            if v not in seen:
                seen[v] = len(seen)
            lut[i] = seen[v]
        luts.append(lut)
    merged = np.empty(len(seen), dtype=object)
    for v, i in seen.items():
        merged[i] = v
    return merged, luts


def string_pair_keys(a: DCol, b: DCol):
    """Comparable int keys for two string columns (merged lexicographic
    rank)."""
    merged, (la, lb) = _merge_dicts(_dict(a), _dict(b))
    ranks = string_rank_lut(merged)
    ka = lut_gather(lut_gather(a.data, la), ranks)
    kb = lut_gather(lut_gather(b.data, lb), ranks)
    return ka, kb


def merge_branch_strings(cols: list[DCol]):
    """Recode string columns into one shared dictionary (device codes)."""
    merged, luts = _merge_dicts(*[_dict(c) for c in cols])
    datas = [lut_gather(c.data, lut) if len(lut)
             else torch.zeros(len(c), dtype=torch.int32, device=c.data.device)
             for c, lut in zip(cols, luts)]
    return merged, datas


def _dict_map(a: DCol, values: np.ndarray) -> DCol:
    """A string column whose dictionary entries map to `values` (host
    strings): re-dictionary and re-gather the codes."""
    if len(values) == 0:
        return DCol("str", a.data, a.valid, np.empty(0, dtype=object))
    uniq, remap = np.unique(values.astype(str), return_inverse=True)
    codes = lut_gather(a.data, remap.astype(np.int32))
    return DCol("str", codes, a.valid, uniq.astype(object))


# -- arithmetic --------------------------------------------------------------

def _arith(op: str):
    def run(expr: BCall, table: DTable, sq) -> DCol:
        a, b = _args(expr, table, sq)
        valid = a.valid & b.valid
        if op == "div":
            da, db = _to_float(a), _to_float(b)
            zero = db == 0
            out = da / torch.where(zero, 1.0, db)
            return DCol("float", torch.where(valid & ~zero, out, 0.0),
                        valid & ~zero)
        fns = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
               "mod": torch.fmod}
        if a.dtype == "float" or b.dtype == "float" or expr.dtype == "float":
            out = fns[op](_to_float(a), _to_float(b))
            return DCol("float", torch.where(valid, out, 0.0), valid)
        pd = phys_dtype("int")
        da, db = a.data.to(pd), b.data.to(pd)
        if op == "mod":
            # the reference's integer remainder by zero yields 0
            zero = db == 0
            out = torch.where(zero, 0, torch.fmod(
                da, torch.where(zero, torch.ones_like(db), db)))
        else:
            out = fns[op](da, db)
        if is_dec(expr.dtype):
            # scale-aligned (add/sub) or raw scaled-int product (mul)
            return DCol(expr.dtype, torch.where(valid, out, 0), valid)
        dtype = expr.dtype if expr.dtype in ("int", "date") else "int"
        out = out.to(phys_dtype(dtype))
        return DCol(dtype, torch.where(valid, out, 0), valid)
    return run


def _neg(expr: BCall, table: DTable, sq) -> DCol:
    a = widen_col(evaluate(expr.args[0], table, sq))
    return DCol(a.dtype, -a.data, a.valid)


def _ratdiv(which: str):
    """Exact rational order key for num/den: "hi" = floor(p/q), "lo" = 56
    binary fraction digits, both by exact integer division. Decimal scales
    fold into p and q so the value is the true rational. Invalid where an
    input is null or den == 0, like the float `div`."""
    def run(expr: BCall, table: DTable, sq) -> DCol:
        a, b = _args(expr, table, sq)
        pd = phys_dtype("int")
        sa = dec_scale(a.dtype) if is_dec(a.dtype) else 0
        sb = dec_scale(b.dtype) if is_dec(b.dtype) else 0
        p = a.data.to(pd) * (10 ** sb)
        q = b.data.to(pd) * (10 ** sa)
        neg = q < 0
        p = torch.where(neg, -p, p)
        q = torch.where(neg, -q, q)
        valid = a.valid & b.valid & (q != 0)
        qs = torch.where(q == 0, torch.ones_like(q), q)
        hi = torch.div(p, qs, rounding_mode="floor")
        if which == "hi":
            return DCol("int", torch.where(valid, hi, 0), valid)
        r = p - hi * qs                       # in [0, q)
        lo = torch.zeros_like(r)
        for _ in range(8):
            r = r << 7
            d = torch.div(r, qs, rounding_mode="floor")
            r = r - d * qs
            lo = (lo << 7) | d
        return DCol("int", torch.where(valid, lo, 0), valid)
    return run


# -- comparisons -------------------------------------------------------------

_CMP = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "le": torch.le,
        "gt": torch.gt, "ge": torch.ge}


_FLIP = {"eq": "eq", "ne": "ne", "lt": "gt", "le": "ge", "gt": "lt",
         "ge": "le"}


def _code_space_compare(op: str, c: DCol, value) -> Optional[torch.Tensor]:
    """col <op> literal on codes: the sorted codebook orders as the values
    do, so the literal becomes a code threshold on the host (a value
    between entries lands on the search boundary; one absent from an
    eq/ne gives the constant answer). The raw compare (validity is the
    caller's), or None where the op cannot remap."""
    # int64 on the host: a literal outside int32 lands on the right
    # boundary instead of overflowing
    book = np.asarray(c.codebook, dtype=np.int64)
    value = np.int64(max(min(int(value), np.iinfo(np.int64).max),
                         np.iinfo(np.int64).min))
    i = int(np.searchsorted(book, value, side="left"))
    present = i < len(book) and book[i] == value
    codes = c.data
    if op == "eq":
        return (codes == i) if present else torch.zeros_like(codes,
                                                             dtype=torch.bool)
    if op == "ne":
        return (codes != i) if present else torch.ones_like(codes,
                                                            dtype=torch.bool)
    if op == "lt":
        return codes < i
    if op == "ge":
        return codes >= i
    hi = int(np.searchsorted(book, value, side="right"))
    if op == "le":
        return codes < hi
    if op == "gt":
        return codes >= hi
    return None


def _lit_value(e, dtype: str):
    """The engine-unit value of a literal comparable with a `dtype`
    column, or None where it is not one that remaps (a hoisted parameter
    slot among them)."""
    if not isinstance(e, BLit) or e.value is None:
        return None
    if e.dtype != dtype or dtype not in ("int", "date") and not is_dec(dtype):
        return None
    return int(e.value)


def _compare(op: str):
    def run(expr: BCall, table: DTable, sq) -> DCol:
        a, b = [evaluate(x, table, sq) for x in expr.args]
        # a column-vs-literal compare on an encoded column runs on codes
        out = None
        if a.codebook is not None and b.codebook is None:
            v = _lit_value(expr.args[1], a.dtype)
            if v is not None:
                out = _code_space_compare(op, a, v)
        elif b.codebook is not None and a.codebook is None:
            v = _lit_value(expr.args[0], b.dtype)
            if v is not None:
                out = _code_space_compare(_FLIP[op], b, v)
        if out is not None:
            valid = a.valid & b.valid
            return DCol("bool", out & valid, valid)
        a, b = decode_col(a), decode_col(b)
        valid = a.valid & b.valid
        if a.dtype == "str" or b.dtype == "str":
            ka, kb = string_pair_keys(a, b)
        else:
            ka, kb = _promote(a.data, b.data)
        out = _CMP[op](ka, kb)
        return DCol("bool", out & valid, valid)
    return run


# -- boolean -----------------------------------------------------------------

def _and(expr: BCall, table: DTable, sq) -> DCol:
    a, b = _args(expr, table, sq)
    da, db = a.data.to(torch.bool), b.data.to(torch.bool)
    out = (da & a.valid) & (db & b.valid)
    return DCol("bool", out, out | (~da & a.valid) | (~db & b.valid))


def _or(expr: BCall, table: DTable, sq) -> DCol:
    a, b = _args(expr, table, sq)
    da, db = a.data.to(torch.bool), b.data.to(torch.bool)
    out = (da & a.valid) | (db & b.valid)
    return DCol("bool", out, out | ((~da & a.valid) & (~db & b.valid)))


def _not(expr: BCall, table: DTable, sq) -> DCol:
    a = evaluate(expr.args[0], table, sq)
    return DCol("bool", ~a.data.to(torch.bool) & a.valid, a.valid)


def _isnull(expr: BCall, table: DTable, sq) -> DCol:
    a = evaluate(expr.args[0], table, sq)
    return DCol("bool", ~a.valid, torch.ones_like(a.valid))


def _isnotnull(expr: BCall, table: DTable, sq) -> DCol:
    a = evaluate(expr.args[0], table, sq)
    return DCol("bool", a.valid.clone(), torch.ones_like(a.valid))


# -- predicates --------------------------------------------------------------

def _in_list(expr: BCall, table: DTable, sq) -> DCol:
    a = evaluate(expr.args[0], table, sq)
    values = expr.extra
    has_null = any(v is None for v in values)
    dev = a.data.device
    params = [v for v in values if isinstance(v, BParam)]
    if a.codebook is not None and params:
        a = decode_col(a)    # device parameters cannot remap on the host
    if a.codebook is not None:
        # membership on codes: the items remap through the sorted
        # codebook on the host; an absent value gives no code
        if is_dec(a.dtype):
            vals = _scaled_in_values(values, dec_scale(a.dtype))
        else:
            vals = [int(v) for v in values if v is not None]
        book = np.asarray(a.codebook, dtype=np.int64)
        varr = np.asarray(vals, dtype=np.int64)
        idx = np.searchsorted(book, varr)
        safe = np.clip(idx, 0, max(len(book) - 1, 0))
        codes = safe[(idx < len(book)) & (book[safe] == varr)]
        out = _member(a.data, upload(codes.astype(np.int32), dev)) \
            if codes.size else torch.zeros(len(a), dtype=torch.bool,
                                           device=dev)
    elif a.dtype == "str":
        d = _dict(a)
        vset = {v for v in values if v is not None}
        hit = np.asarray([v in vset for v in d], dtype=bool)
        out = lut_gather(a.data, hit) if len(d) else \
            torch.zeros(len(a), dtype=torch.bool, device=dev)
    else:
        if is_dec(a.dtype):
            vals = _scaled_in_values(values, dec_scale(a.dtype))
            arr = upload(np.asarray(vals, dtype=np.int64), dev)
        else:
            vals = [v for v in values
                    if v is not None and not isinstance(v, BParam)]
            dt = torch.float64 if any(isinstance(v, float) for v in vals) \
                else torch.int64
            arr = upload(np.asarray(vals, dtype=np.float64 if dt == _F64
                                    else np.int64), dev) if vals else None
            if params:
                # hoisted int/date items: device scalars of their slots
                param = sq.param if isinstance(sq, EvalCtx) else None
                if param is None:
                    raise NotImplementedError("in_list params without values")
                pvals = torch.cat([param(v, 1).data.to(dt) for v in params])
                arr = pvals if arr is None else torch.cat([arr, pvals])
                vals = vals + params
        if not vals:
            out = torch.zeros(len(a), dtype=torch.bool, device=dev)
        else:
            da, arr = _promote(a.data, arr)
            out = _member(da, arr)
    valid = a.valid
    if has_null:
        valid = valid & out
    return DCol("bool", out & valid, valid)


def _member(x: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """x[i] in values, by a binary search in the sorted values (torch.isin
    may wait on the device to size a unique)."""
    sv = torch.sort(values).values
    pos = torch.searchsorted(sv, x).clamp_(max=sv.shape[0] - 1)
    return sv[pos] == x


def _like_to_regex(pattern: str) -> re.Pattern:
    out = []
    for ch in pattern:
        out.append(".*" if ch == "%" else "." if ch == "_" else re.escape(ch))
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


def _like(expr: BCall, table: DTable, sq) -> DCol:
    a = evaluate(expr.args[0], table, sq)
    if a.dtype != "str":
        raise NotImplementedError("LIKE on non-string column")
    pattern = _like_to_regex(str(expr.extra))
    d = _dict(a)
    hit = np.asarray([bool(pattern.match(v)) for v in d], dtype=bool)
    out = lut_gather(a.data, hit) if len(d) else \
        torch.zeros(len(a), dtype=torch.bool, device=a.data.device)
    return DCol("bool", out & a.valid, a.valid)


# -- conditional -------------------------------------------------------------

def _case(expr: BCall, table: DTable, sq) -> DCol:
    pairs = expr.args[:-1]
    # first, as the reference
    else_col = decode_col(evaluate(expr.args[-1], table, sq))
    branch_cols = [decode_col(evaluate(pairs[i + 1], table, sq))
                   for i in range(0, len(pairs), 2)]
    branch_cols.append(else_col)
    dictionary = None
    if expr.dtype == "str":
        dictionary, datas = merge_branch_strings(branch_cols)
    else:
        pd = phys_dtype(expr.dtype)
        datas = [c.data.to(pd) for c in branch_cols]
    out = datas[-1]
    valid = branch_cols[-1].valid
    # fold branches in reverse so earlier WHENs win
    for i in range(len(pairs) - 2, -1, -2):
        cond = evaluate(pairs[i], table, sq)
        fire = cond.data.to(torch.bool) & cond.valid
        bi = i // 2
        out = torch.where(fire, datas[bi], out)
        valid = torch.where(fire, branch_cols[bi].valid, valid)
    return DCol(expr.dtype, out, valid, dictionary)


def _coalesce(expr: BCall, table: DTable, sq) -> DCol:
    cols = _args(expr, table, sq)
    dictionary = None
    if expr.dtype == "str":
        dictionary, datas = merge_branch_strings(cols)
    else:
        pd = phys_dtype(expr.dtype)
        datas = [c.data.to(pd) for c in cols]
    out = datas[-1]
    valid = cols[-1].valid
    for i in range(len(cols) - 2, -1, -1):
        out = torch.where(cols[i].valid, datas[i], out)
        valid = cols[i].valid | valid
    return DCol(expr.dtype, out, valid, dictionary)


def _nullif(expr: BCall, table: DTable, sq) -> DCol:
    a, b = _args(expr, table, sq)
    if a.dtype == "str" or b.dtype == "str":
        ka, kb = string_pair_keys(a, b)
    else:
        ka, kb = _promote(a.data, b.data)
    same = (ka == kb) & a.valid & b.valid
    return DCol(a.dtype, a.data, a.valid & ~same, a.dictionary)


# -- casts & scalar functions ------------------------------------------------

def _sign(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x)


def _halfup_rescale(data: torch.Tensor, from_scale: int,
                    to_scale: int) -> torch.Tensor:
    if to_scale >= from_scale:
        return data * 10 ** (to_scale - from_scale)
    factor = 10 ** (from_scale - to_scale)
    return _sign(data) * torch.div(torch.abs(data) + factor // 2, factor,
                                   rounding_mode="floor")


def _cast(expr: BCall, table: DTable, sq) -> DCol:
    # rescaling multiplies by 10^k: narrow lanes widen first
    a = widen_col(evaluate(expr.args[0], table, sq))
    target = expr.dtype
    if target == a.dtype:
        return a
    if a.dtype == "str":
        return _cast_from_str(a, target)
    if target == "str":
        if _replay(sq):
            # as the reference's traced cast: the output dictionary holds
            # the distinct values, which the host cannot read under replay
            raise NotImplementedError(
                "cast to string needs a data-dependent dictionary (host)")
        return _cast_to_str(a)
    if is_dec(target):
        s = dec_scale(target)
        if is_dec(a.dtype):
            out = _halfup_rescale(a.data, dec_scale(a.dtype), s)
        elif a.dtype == "float":
            d = a.data.to(_F64) * 10.0 ** s
            out = (torch.floor(torch.abs(d) + 0.5) * _sign(d)) \
                .to(phys_dtype(target))
        else:   # int/bool
            out = a.data.to(phys_dtype(target)) * 10 ** s
        return DCol(target, out, a.valid)
    if is_dec(a.dtype):
        s = dec_scale(a.dtype)
        if target == "float":
            return DCol("float", a.data.to(_F64) / 10.0 ** s, a.valid)
        if target == "int":   # truncate toward zero (Spark decimal -> int)
            out = _sign(a.data) * torch.div(torch.abs(a.data), 10 ** s,
                                            rounding_mode="floor")
            return DCol("int", out.to(phys_dtype("int")), a.valid)
        raise NotImplementedError(f"cast {a.dtype} -> {target}")
    if target in ("int", "float", "date"):
        return DCol(target, a.data.to(phys_dtype(target)), a.valid)
    raise NotImplementedError(f"cast to {target}")


def _cast_to_str(a: DCol) -> DCol:
    """Numeric/date -> string: dictionary-encode the distinct values on the
    host."""
    data = a.data.cpu().numpy()
    uniq_raw, inverse = np.unique(data, return_inverse=True)
    if a.dtype == "date":
        strs = [str(np.datetime64(int(v), "D").item()) for v in uniq_raw]
    elif is_dec(a.dtype):
        strs = [_sql_str(decimal.Decimal(int(v)).scaleb(-dec_scale(a.dtype)))
                for v in uniq_raw]
    else:
        strs = [_sql_str(v) for v in uniq_raw]
    uniq, remap = np.unique(np.asarray(strs, dtype=object).astype(str),
                            return_inverse=True)
    codes = remap.astype(np.int32)[inverse]
    return DCol("str", torch.from_numpy(codes).to(a.data.device), a.valid,
                uniq.astype(object))


def _cast_from_str(a: DCol, target: str) -> DCol:
    """Parse the dictionary on the host; codes gather the parsed values."""
    d = _dict(a)
    vals = np.zeros(max(len(d), 1),
                    dtype=np.int64 if is_dec(target) else
                    {"int": np.int64, "float": np.float64,
                     "date": np.int32}[target])
    ok = np.zeros(max(len(d), 1), dtype=bool)
    for i, v in enumerate(d):
        try:
            if target == "date":
                vals[i] = np.datetime64(v, "D").astype(np.int32)
            elif target == "int":
                vals[i] = int(float(v))
            elif is_dec(target):
                vals[i] = int(decimal.Decimal(v).scaleb(dec_scale(target))
                              .to_integral_value(decimal.ROUND_HALF_UP))
            else:
                vals[i] = float(v)
            ok[i] = True
        except (ValueError, TypeError, decimal.InvalidOperation):
            pass
    out = lut_gather(a.data, vals).to(phys_dtype(target))
    valid = a.valid & lut_gather(a.data, ok)
    return DCol(target, torch.where(valid, out, torch.zeros_like(out)), valid)


def _substr(expr: BCall, table: DTable, sq) -> DCol:
    a = evaluate(expr.args[0], table, sq)
    start, length = expr.extra
    lo = start - 1 if start > 0 else 0
    hi = None if length is None else lo + length
    newd = np.asarray([v[lo:hi] for v in _dict(a).astype(str)], dtype=object)
    return _dict_map(a, newd)


def _case_map(fn):
    """Row-wise string transform as a dictionary transform."""
    def run(expr: BCall, table: DTable, sq) -> DCol:
        a = evaluate(expr.args[0], table, sq)
        if a.dtype != "str":
            raise NotImplementedError("string transform on non-string")
        newd = np.asarray([fn(v) for v in _dict(a).astype(str)],
                          dtype=object)
        return _dict_map(a, newd)
    return run


def _concat(expr: BCall, table: DTable, sq) -> DCol:
    """String concatenation as a dictionary column. The reference builds a
    lazy compound column and flattens it where it is consumed; its
    concrete flatten is done here at once: the distinct tuples of part
    codes (a null part contributes "") are joined on the host, and the
    rows gather their code in the sorted dictionary of the results. The
    result is NULL where any part is."""
    if _replay(sq):
        return _concat_cross(_concat_parts(expr, table, sq))
    cols = _args(expr, table, sq)
    if any(c.dtype != "str" for c in cols):
        raise NotImplementedError("device concat of non-string")
    valid = cols[0].valid
    for c in cols[1:]:
        valid = valid & c.valid
    codes = torch.stack([torch.where(c.valid, c.data, -1) for c in cols], 1)
    tuples, inverse = torch.unique(codes, dim=0, return_inverse=True)
    tuples = tuples.cpu().numpy()
    joined = np.full(len(tuples), "", dtype=object)
    for j, c in enumerate(cols):
        d = _dict(c)
        part = tuples[:, j]
        vals = np.where(part >= 0, d[np.clip(part, 0, max(len(d) - 1, 0))]
                        if len(d) else "", "")
        joined = joined + vals
    uniq, remap = np.unique(joined.astype(str), return_inverse=True)
    return DCol("str", lut_gather(inverse, remap.astype(np.int32)), valid,
                uniq.astype(object))


def _concat_parts(expr: BCall, table: DTable, sq) -> list[DCol]:
    """The leaf part columns of a (nested) concatenation: the reference's
    compound column keeps its parts flat."""
    parts: list[DCol] = []
    for arg in expr.args:
        if isinstance(arg, BCall) and arg.op == "concat":
            parts.extend(_concat_parts(arg, table, sq))
            continue
        c = evaluate(arg, table, sq)
        if c.dtype != "str":
            raise NotImplementedError("device concat of non-string")
        parts.append(c)
    return parts


def _concat_cross(parts: list[DCol]) -> DCol:
    """Concatenation under compiled replay: each row's mixed-radix code in
    the cross product of the parts' dictionaries (device.CrossDict), the
    slot past a part's dictionary standing for a NULL part; NULL where any
    part is."""
    cross = CrossDict([_dict(p) for p in parts])
    if cross.size >= 1 << 31:
        raise NotImplementedError(
            f"compound string cross dictionary too large ({cross.size})")
    code = torch.zeros_like(parts[0].data, dtype=torch.int32)
    valid = parts[0].valid
    for p, d in zip(parts, cross.parts):
        n = len(d)
        eff = torch.where(p.valid & (p.data >= 0),
                          p.data.clamp(0, max(n - 2, 0)), n - 1)
        code = code * n + eff.to(torch.int32)
        valid = valid & p.valid
    return DCol("str", code, valid, cross)


def _abs(expr: BCall, table: DTable, sq) -> DCol:
    a = widen_col(evaluate(expr.args[0], table, sq))
    return DCol(a.dtype, torch.abs(a.data), a.valid)


def _round(expr: BCall, table: DTable, sq) -> DCol:
    a = widen_col(evaluate(expr.args[0], table, sq))
    digits = expr.extra if expr.extra is not None else 0
    if is_dec(a.dtype) and is_dec(expr.dtype):
        # negative digits: round to tens/hundreds, then restore the scale
        out = _halfup_rescale(a.data, dec_scale(a.dtype), int(digits))
        out = out * 10 ** (dec_scale(expr.dtype) - int(digits))
        return DCol(expr.dtype, out, a.valid)
    data = _to_float(a)
    scale = 10.0 ** digits
    out = torch.floor(torch.abs(data) * scale + 0.5) / scale * _sign(data)
    if expr.dtype == "int":
        return DCol("int", out.to(phys_dtype("int")), a.valid)
    return DCol("float", out, a.valid)


def _grouping_bit(expr: BCall, table: DTable, sq) -> DCol:
    a = decode_col(evaluate(expr.args[0], table, sq))
    bit = int(expr.extra)
    out = (a.data.to(phys_dtype("int")) >> bit) & 1
    return DCol("int", out, a.valid)


_HANDLERS = {
    "add": _arith("add"), "sub": _arith("sub"), "mul": _arith("mul"),
    "div": _arith("div"), "mod": _arith("mod"), "neg": _neg,
    "ratdiv_hi": _ratdiv("hi"), "ratdiv_lo": _ratdiv("lo"),
    "eq": _compare("eq"), "ne": _compare("ne"), "lt": _compare("lt"),
    "le": _compare("le"), "gt": _compare("gt"), "ge": _compare("ge"),
    "and": _and, "or": _or, "not": _not,
    "isnull": _isnull, "isnotnull": _isnotnull,
    "in_list": _in_list, "like": _like,
    "case": _case, "coalesce": _coalesce, "cast": _cast,
    "substr": _substr, "concat": _concat, "abs": _abs, "round": _round,
    "upper": _case_map(str.upper), "lower": _case_map(str.lower),
    "nullif": _nullif, "grouping_bit": _grouping_bit,
}
