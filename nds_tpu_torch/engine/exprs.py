# Copied from nds_tpu/engine/exprs.py; only import paths changed.
"""Vectorized evaluation of bound expressions over a Table.

Null semantics follow Spark SQL: three-valued AND/OR, null-propagating
arithmetic/comparisons, divide-by-zero yields NULL. String predicates
(equality, LIKE, IN) are evaluated against the column dictionary on the host
and applied to device-side codes — strings never reach the accelerator.
"""
from __future__ import annotations

import re
from typing import Callable, Optional

import numpy as np

from .column import (_NULL_CODE, Column, Table, dec_dtype, dec_scale, is_dec,
                     merge_dictionaries, phys_np)
from .plan import BCall, BCol, BExpr, BLit, BScalarSubquery

# signature: subquery_eval(plan) -> python scalar (or None)
SubqueryEval = Callable[[object], object]


def evaluate(expr: BExpr, table: Table,
             subquery_eval: Optional[SubqueryEval] = None) -> Column:
    n = table.num_rows
    if isinstance(expr, BCol):
        return table.columns[expr.index]
    if isinstance(expr, BLit):
        return Column.constant(expr.dtype, expr.value, n)
    if isinstance(expr, BScalarSubquery):
        if subquery_eval is None:
            raise RuntimeError("scalar subquery encountered without evaluator")
        value = subquery_eval(expr.plan)
        return Column.constant(expr.dtype, value, n)
    if isinstance(expr, BCall):
        return _call(expr, table, subquery_eval)
    raise TypeError(f"cannot evaluate {type(expr).__name__}")


def _eval_args(expr: BCall, table: Table, sq) -> list[Column]:
    return [evaluate(a, table, sq) for a in expr.args]


def _call(expr: BCall, table: Table, sq) -> Column:
    op = expr.op
    handler = _HANDLERS.get(op)
    if handler is None:
        raise NotImplementedError(f"expression op {op!r}")
    return handler(expr, table, sq)


# -- helpers ----------------------------------------------------------------

def _both_valid(a: Column, b: Column) -> Optional[np.ndarray]:
    if a.valid is None and b.valid is None:
        return None
    return a.validity & b.validity


def _numeric(col: Column) -> np.ndarray:
    return np.asarray(col.data)


def _result_num_dtype(a: Column, b: Column) -> str:
    if a.dtype == "float" or b.dtype == "float":
        return "float"
    if a.dtype == "date" or b.dtype == "date":
        return "date"
    return "int"


def _as_float(col: Column) -> np.ndarray:
    out = np.asarray(col.data, dtype=np.float64)
    if is_dec(col.dtype):
        return out / 10.0 ** dec_scale(col.dtype)
    return out


def _align_strings(a: Column, b: Column) -> tuple[np.ndarray, np.ndarray]:
    """Remap two string columns onto a common dictionary; returns code arrays."""
    _, (ca, cb) = merge_dictionaries([a, b])
    return ca, cb


# -- arithmetic -------------------------------------------------------------

def _arith(op):
    def run(expr: BCall, table: Table, sq) -> Column:
        a, b = _eval_args(expr, table, sq)
        valid = _both_valid(a, b)
        if op == "div":
            da, db = _as_float(a), _as_float(b)
            zero = db == 0
            with np.errstate(divide="ignore", invalid="ignore"):
                out = np.where(zero, np.nan, da / np.where(zero, 1.0, db))
            v = valid if valid is not None else np.ones(len(out), dtype=bool)
            return Column.from_values("float", out, v & ~zero)
        if a.dtype == "float" or b.dtype == "float" or expr.dtype == "float":
            da, db = _as_float(a), _as_float(b)
            out = {"add": np.add, "sub": np.subtract, "mul": np.multiply,
                   "mod": np.fmod}[op](da, db)
            return Column.from_values("float", out, valid)
        da, db = _numeric(a), _numeric(b)
        out = {"add": np.add, "sub": np.subtract, "mul": np.multiply,
               "mod": np.fmod}[op](da.astype(np.int64), db.astype(np.int64))
        if is_dec(expr.dtype):
            # operands arrive scale-aligned (add/sub) or raw (mul: scales
            # add); the scaled-int result is already in the output scale
            return Column.from_values(expr.dtype, out, valid)
        dtype = expr.dtype if expr.dtype in ("int", "date") else "int"
        return Column.from_values(dtype, out, valid)
    return run


def _neg(expr: BCall, table: Table, sq) -> Column:
    a = evaluate(expr.args[0], table, sq)
    return Column.from_values(a.dtype, -np.asarray(a.data), a.valid)


def _ratdiv(which: str):
    """Exact rational order key (planner._exact_rational_keys): "hi" =
    floor(p/q), "lo" = 56 binary fraction digits, matching the jax backend's
    jexprs._ratdiv bit-for-bit so rank ties agree across backends."""
    def run(expr: BCall, table: Table, sq) -> Column:
        a, b = _eval_args(expr, table, sq)
        sa = dec_scale(a.dtype) if is_dec(a.dtype) else 0
        sb = dec_scale(b.dtype) if is_dec(b.dtype) else 0
        p = np.asarray(a.data, dtype=np.int64) * (10 ** sb)
        q = np.asarray(b.data, dtype=np.int64) * (10 ** sa)
        neg = q < 0
        p = np.where(neg, -p, p)
        q = np.where(neg, -q, q)
        bv = _both_valid(a, b)
        valid = (np.ones(len(p), bool) if bv is None else np.asarray(bv)) \
            & (q != 0)
        qs = np.where(q == 0, 1, q)
        hi = p // qs
        if which == "hi":
            return Column.from_values("int", np.where(valid, hi, 0), valid)
        r = p - hi * qs
        lo = np.zeros_like(r)
        for _ in range(8):
            r = r << 7
            d = r // qs
            r = r - d * qs
            lo = (lo << 7) | d
        return Column.from_values("int", np.where(valid, lo, 0), valid)
    return run


# -- comparisons ------------------------------------------------------------

_CMP_FN = {
    "eq": np.equal, "ne": np.not_equal, "lt": np.less,
    "le": np.less_equal, "gt": np.greater, "ge": np.greater_equal,
}


def _compare(op):
    def run(expr: BCall, table: Table, sq) -> Column:
        a, b = _eval_args(expr, table, sq)
        valid = _both_valid(a, b)
        if a.dtype == "str" or b.dtype == "str":
            if op in ("eq", "ne"):
                ca, cb = _align_strings(a, b)
                out = _CMP_FN[op](ca, cb)
            else:
                # inequality: compare decoded values (rank spaces differ per column)
                da, db = a.decode(), b.decode()
                da = np.asarray([x if x is not None else "" for x in da], dtype=str)
                db = np.asarray([x if x is not None else "" for x in db], dtype=str)
                out = _CMP_FN[op](da, db)
            return Column.from_values("bool", out, valid)
        da, db = _numeric(a), _numeric(b)
        out = _CMP_FN[op](da, db)
        return Column.from_values("bool", out, valid)
    return run


# -- boolean ----------------------------------------------------------------

def _and(expr: BCall, table: Table, sq) -> Column:
    a, b = _eval_args(expr, table, sq)
    da = np.asarray(a.data, dtype=bool) & a.validity
    db = np.asarray(b.data, dtype=bool) & b.validity
    false_a = ~np.asarray(a.data, dtype=bool) & a.validity
    false_b = ~np.asarray(b.data, dtype=bool) & b.validity
    out = da & db
    valid = out | false_a | false_b  # definite true or definite false
    return Column.from_values("bool", out, valid)


def _or(expr: BCall, table: Table, sq) -> Column:
    a, b = _eval_args(expr, table, sq)
    true_a = np.asarray(a.data, dtype=bool) & a.validity
    true_b = np.asarray(b.data, dtype=bool) & b.validity
    false_a = ~np.asarray(a.data, dtype=bool) & a.validity
    false_b = ~np.asarray(b.data, dtype=bool) & b.validity
    out = true_a | true_b
    valid = out | (false_a & false_b)
    return Column.from_values("bool", out, valid)


def _not(expr: BCall, table: Table, sq) -> Column:
    a = evaluate(expr.args[0], table, sq)
    return Column.from_values("bool", ~np.asarray(a.data, dtype=bool), a.valid)


def _isnull(expr: BCall, table: Table, sq) -> Column:
    a = evaluate(expr.args[0], table, sq)
    return Column.from_values("bool", ~a.validity, None)


def _isnotnull(expr: BCall, table: Table, sq) -> Column:
    a = evaluate(expr.args[0], table, sq)
    return Column.from_values("bool", a.validity, None)


# -- predicates -------------------------------------------------------------

def _scaled_in_values(values, s: int) -> list[int]:
    """Exact scaled-int IN-list values; literals not representable at scale
    s can never equal a decN column value, so they drop out. Decimal-exact
    (float(v)*10**s carries binary noise: 1.1*100 == 110.00000000000001)."""
    import decimal
    out = []
    for v in values:
        if v is None:
            continue
        d = decimal.Decimal(str(v)).scaleb(s)
        if d == d.to_integral_value():
            out.append(int(d))
    return out


def _in_list(expr: BCall, table: Table, sq) -> Column:
    a = evaluate(expr.args[0], table, sq)
    values = expr.extra  # list of python literals
    has_null = any(v is None for v in values)
    if a.dtype == "str":
        d = a.dictionary if a.dictionary is not None else np.empty(0, dtype=object)
        vset = {v for v in values if v is not None}
        hit = np.asarray([val in vset for val in d], dtype=bool)
        codes = np.asarray(a.data)
        safe = np.where(codes >= 0, codes, 0)
        out = np.where(codes >= 0, hit[safe] if len(hit) else False, False)
    elif is_dec(a.dtype):
        vals = _scaled_in_values(values, dec_scale(a.dtype))
        out = np.isin(np.asarray(a.data), np.asarray(vals, dtype=np.int64))
    else:
        vals = [v for v in values if v is not None]
        out = np.isin(np.asarray(a.data), np.asarray(vals))
    valid = a.validity
    if has_null:
        # x IN (..., NULL): TRUE on match, else NULL (so NOT IN never fires)
        valid = valid & out
    return Column.from_values("bool", out, valid)


def _like_to_regex(pattern: str) -> re.Pattern:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


def _like(expr: BCall, table: Table, sq) -> Column:
    a = evaluate(expr.args[0], table, sq)
    pattern = _like_to_regex(str(expr.extra))
    if a.dtype != "str":
        raise NotImplementedError("LIKE on non-string column")
    d = a.dictionary if a.dictionary is not None else np.empty(0, dtype=object)
    hit = np.asarray([bool(pattern.match(v)) for v in d], dtype=bool)
    codes = np.asarray(a.data)
    safe = np.where(codes >= 0, codes, 0)
    out = np.where(codes >= 0, hit[safe] if len(hit) else False, False)
    return Column.from_values("bool", out, a.valid)


# -- conditional ------------------------------------------------------------

def _case(expr: BCall, table: Table, sq) -> Column:
    """args: cond1, val1, cond2, val2, ..., else_val (always present)."""
    n = table.num_rows
    pairs = expr.args[:-1]
    else_col = evaluate(expr.args[-1], table, sq)
    result_dtype = expr.dtype
    out = np.array(np.zeros(n), dtype=_phys(result_dtype))
    valid = np.zeros(n, dtype=bool)
    decided = np.zeros(n, dtype=bool)
    dictionary = None
    branch_cols = []
    for i in range(0, len(pairs), 2):
        branch_cols.append(evaluate(pairs[i + 1], table, sq))
    branch_cols.append(else_col)
    if result_dtype == "str":
        merged, codes_list = merge_dictionaries(branch_cols)
        dictionary = merged
        branch_data = codes_list
    else:
        branch_data = [np.asarray(c.data, dtype=_phys(result_dtype)) for c in branch_cols]
    for i in range(0, len(pairs), 2):
        cond = evaluate(pairs[i], table, sq)
        fire = np.asarray(cond.data, dtype=bool) & cond.validity & ~decided
        bi = i // 2
        out[fire] = branch_data[bi][fire]
        valid[fire] = branch_cols[bi].validity[fire]
        decided |= fire
    rest = ~decided
    out[rest] = branch_data[-1][rest]
    valid[rest] = else_col.validity[rest]
    return Column.from_values(result_dtype, out, valid, dictionary)


def _coalesce(expr: BCall, table: Table, sq) -> Column:
    cols = _eval_args(expr, table, sq)
    result_dtype = expr.dtype
    n = table.num_rows
    dictionary = None
    if result_dtype == "str":
        dictionary, datas = merge_dictionaries(cols)
    else:
        datas = [np.asarray(c.data, dtype=_phys(result_dtype)) for c in cols]
    out = np.zeros(n, dtype=_phys(result_dtype))
    valid = np.zeros(n, dtype=bool)
    decided = np.zeros(n, dtype=bool)
    for c, d in zip(cols, datas):
        fire = c.validity & ~decided
        out[fire] = d[fire]
        valid[fire] = True
        decided |= fire
    return Column.from_values(result_dtype, out, valid, dictionary)


# -- casts & scalar functions ----------------------------------------------

def _phys(dtype: str):
    return phys_np(dtype)


def _halfup_rescale(data: np.ndarray, from_scale: int,
                    to_scale: int) -> np.ndarray:
    """Rescale scaled ints, SQL half-up on downscale (sign-symmetric)."""
    if to_scale >= from_scale:
        return data * 10 ** (to_scale - from_scale)
    factor = 10 ** (from_scale - to_scale)
    return np.sign(data) * ((np.abs(data) + factor // 2) // factor)


def _cast(expr: BCall, table: Table, sq) -> Column:
    a = evaluate(expr.args[0], table, sq)
    target = expr.dtype
    if target == a.dtype:
        return a
    if is_dec(target):
        s = dec_scale(target)
        if is_dec(a.dtype):
            out = _halfup_rescale(np.asarray(a.data), dec_scale(a.dtype), s)
            return Column.from_values(target, out, a.valid)
        if a.dtype in ("int", "bool"):
            return Column.from_values(
                target, np.asarray(a.data, dtype=np.int64) * 10 ** s, a.valid)
        if a.dtype == "float":
            d = np.asarray(a.data, dtype=np.float64) * 10.0 ** s
            out = (np.floor(np.abs(d) + 0.5) * np.sign(d)).astype(np.int64)
            return Column.from_values(target, out, a.valid)
        if a.dtype == "str":
            import decimal
            vals = a.decode()
            out = np.zeros(len(a), dtype=np.int64)
            valid = a.validity.copy()
            for i, v in enumerate(vals):
                if v is None:
                    continue
                try:
                    out[i] = int(decimal.Decimal(v).scaleb(s)
                                 .to_integral_value(decimal.ROUND_HALF_UP))
                except decimal.InvalidOperation:
                    valid[i] = False
            return Column.from_values(target, out, valid)
        raise NotImplementedError(f"cast {a.dtype} -> {target}")
    if is_dec(a.dtype):
        s = dec_scale(a.dtype)
        data = np.asarray(a.data)
        if target == "float":
            return Column.from_values(
                "float", data.astype(np.float64) / 10.0 ** s, a.valid)
        if target == "int":  # Spark truncates decimal -> int toward zero
            out = np.sign(data) * (np.abs(data) // 10 ** s)
            return Column.from_values("int", out, a.valid)
        # fall through for "str": decode() yields Decimal objects below
    if target in ("int", "float"):
        if a.dtype == "str":
            vals = a.decode()
            out = np.zeros(len(a), dtype=_phys(target))
            valid = a.validity.copy()
            for i, v in enumerate(vals):
                if v is None:
                    continue
                try:
                    out[i] = int(float(v)) if target == "int" else float(v)
                except ValueError:
                    valid[i] = False
            return Column.from_values(target, out, valid)
        return Column.from_values(target, np.asarray(a.data, dtype=_phys(target)), a.valid)
    if target == "date":
        if a.dtype == "str":
            vals = a.decode()
            out = np.zeros(len(a), dtype=np.int32)
            valid = a.validity.copy()
            for i, v in enumerate(vals):
                if v is None:
                    continue
                try:
                    out[i] = np.datetime64(v, "D").astype(np.int32)
                except ValueError:
                    valid[i] = False
            return Column.from_values("date", out, valid)
        return Column.from_values("date", np.asarray(a.data, dtype=np.int32), a.valid)
    if target == "str":
        vals = a.decode()
        strs = np.asarray([None if v is None else _sql_str(v) for v in vals],
                          dtype=object)
        uniq, codes = np.unique(
            np.asarray([s if s is not None else "" for s in strs]), return_inverse=True)
        return Column.from_values("str", codes.astype(np.int32), a.validity.copy(),
                                  uniq.astype(object))
    raise NotImplementedError(f"cast to {target}")


def _sql_str(v) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    import decimal
    if isinstance(v, decimal.Decimal):
        return format(v, "f")    # no scientific notation (Spark cast format)
    return str(v)


def _substr(expr: BCall, table: Table, sq) -> Column:
    a = evaluate(expr.args[0], table, sq)
    start = expr.extra[0]
    length = expr.extra[1]
    d = a.dictionary if a.dictionary is not None else np.empty(0, dtype=object)
    lo = start - 1 if start > 0 else 0
    hi = None if length is None else lo + length
    newd = np.asarray([v[lo:hi] for v in d.astype(str)], dtype=object)
    uniq, remap = np.unique(newd.astype(str), return_inverse=True)
    codes = np.asarray(a.data)
    safe = np.where(codes >= 0, codes, 0)
    out = np.where(codes >= 0,
                   remap[safe] if len(remap) else 0, _NULL_CODE).astype(np.int32)
    return Column.from_values("str", out, a.valid, uniq.astype(object))


def _case_map_str(a: Column, fn) -> Column:
    """Apply a python string transform over the dictionary only."""
    d = a.dictionary if a.dictionary is not None else np.empty(0, dtype=object)
    newd = np.asarray([fn(v) for v in d.astype(str)], dtype=object)
    uniq, remap = np.unique(newd.astype(str), return_inverse=True)
    codes = np.asarray(a.data)
    safe = np.where(codes >= 0, codes, 0)
    out = np.where(codes >= 0,
                   remap[safe] if len(remap) else 0, _NULL_CODE).astype(np.int32)
    return Column.from_values("str", out, a.valid, uniq.astype(object))


def _upper(expr: BCall, table: Table, sq) -> Column:
    return _case_map_str(evaluate(expr.args[0], table, sq), str.upper)


def _lower(expr: BCall, table: Table, sq) -> Column:
    return _case_map_str(evaluate(expr.args[0], table, sq), str.lower)


def _concat(expr: BCall, table: Table, sq) -> Column:
    cols = _eval_args(expr, table, sq)
    parts = []
    valid = None
    for c in cols:
        v = c.validity
        valid = v if valid is None else (valid & v)
        dec = c.decode()
        parts.append(np.asarray(
            ["" if x is None else _sql_str(x) for x in dec], dtype=object))
    joined = parts[0]
    for p in parts[1:]:
        joined = np.asarray([a + b for a, b in zip(joined, p)], dtype=object)
    uniq, codes = np.unique(joined.astype(str), return_inverse=True)
    return Column.from_values("str", codes.astype(np.int32), valid,
                              uniq.astype(object))


def _abs(expr: BCall, table: Table, sq) -> Column:
    a = evaluate(expr.args[0], table, sq)
    return Column.from_values(a.dtype, np.abs(np.asarray(a.data)), a.valid)


def _round(expr: BCall, table: Table, sq) -> Column:
    a = evaluate(expr.args[0], table, sq)
    digits = expr.extra if expr.extra is not None else 0
    if is_dec(a.dtype) and is_dec(expr.dtype):
        # round to `digits` (may be negative: round-to-hundreds), then
        # restore the output scale (clamped at 0 — decN has no negative
        # scale, so round(x,-2) yields dec0 values like 12300)
        out = _halfup_rescale(np.asarray(a.data), dec_scale(a.dtype),
                              int(digits))
        out = out * 10 ** (dec_scale(expr.dtype) - int(digits))
        return Column.from_values(expr.dtype, out, a.valid)
    data = _as_float(a)
    # SQL half-up rounding (numpy rounds half-to-even)
    scale = 10.0 ** digits
    out = np.floor(np.abs(data) * scale + 0.5) / scale * np.sign(data)
    if expr.dtype == "int":
        return Column.from_values("int", out.astype(np.int64), a.valid)
    return Column.from_values("float", out, a.valid)


def _grouping_bit(expr: BCall, table: Table, sq) -> Column:
    a = evaluate(expr.args[0], table, sq)
    bit = int(expr.extra)
    out = (np.asarray(a.data, dtype=np.int64) >> bit) & 1
    return Column.from_values("int", out, a.valid)


def _nullif(expr: BCall, table: Table, sq) -> Column:
    a, b = _eval_args(expr, table, sq)
    # equal and both valid -> null
    if a.dtype == "str" or b.dtype == "str":
        ca, cb = _align_strings(a, b)
        same = ca == cb
    else:
        same = _numeric(a) == _numeric(b)
    same = same & a.validity & b.validity
    return a.with_valid(a.validity & ~same)


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
    "upper": _upper, "lower": _lower,
    "nullif": _nullif, "grouping_bit": _grouping_bit,
}
