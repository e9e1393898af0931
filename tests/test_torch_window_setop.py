"""The port's window functions, set operations and string concatenation
against nds_tpu's, on the same inputs made with numpy from a seed.

Kernels: ``window_ordered_core`` against the reference's for every window
function (ties, null order keys, one and many partitions, dead rows);
``run_bounds`` against the reference's running-max and segment-max forms;
``first_row_per_gid`` against the reference's min scatter. Plans:
windows, UNION [ALL], INTERSECT, EXCEPT and CONCAT through the port's
``Session.sql(backend="torch")`` on the CPU with no host fallback, held
against nds_tpu's ``backend="jax"`` and ``backend="numpy"`` results.
Integer and decimal results are bit-identical; floats agree to rtol 1e-9.
"""
import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax
import jax.numpy as jnp

from nds_tpu.config import EngineConfig as RConfig
from nds_tpu.engine import Session as RSession
from nds_tpu.engine import plan as RP
from nds_tpu.engine.jax_backend import device as rdev
from nds_tpu.engine.jax_backend import jexprs as rexprs
from nds_tpu.engine.jax_backend import kernels as rk

import nds_tpu_torch as nt
from nds_tpu_torch.engine import plan as PP
from nds_tpu_torch.engine.torch_backend import cuda_kernels as ck
from nds_tpu_torch.engine.torch_backend import device as pdev
from nds_tpu_torch.engine.torch_backend import exprs as pexprs
from nds_tpu_torch.engine.torch_backend import kernels as pk
from nds_tpu_torch.validate import table_mismatches
from test_torch_modules import _both_tables, _eq, _j, _spec, _t

RTOL = 1e-9


@pytest.fixture(autouse=True)
def _kernels_off_after():
    yield
    ck.set_active(frozenset())


# ---------------------------------------------------------------------------
# window_ordered_core
# ---------------------------------------------------------------------------

def _window_inputs(n, parts, seed, arg_dtype):
    """Rows sorted by (partition, order keys), the reference's sort_perm
    making the order: partition ids with dead rows last under the sentinel
    id n, two order keys with ties and nulls, and an argument column with
    nulls."""
    rng = np.random.default_rng(seed)
    alive = rng.random(n) > 0.2
    gid = np.where(alive, rng.integers(0, parts, n), n).astype(np.int32)
    k1 = rng.integers(0, 6, n).astype(np.int64)
    v1 = rng.random(n) > 0.15
    k2 = rng.integers(-3, 3, n).astype(np.int32)
    v2 = rng.random(n) > 0.1
    if arg_dtype == np.float64:
        data = rng.normal(size=n) * 1e3
    else:
        data = rng.integers(-10 ** 9, 10 ** 9, n).astype(arg_dtype)
    valid = rng.random(n) > 0.2
    data = np.where(valid, data, 0).astype(arg_dtype)
    perm = np.asarray(rk.sort_perm(
        [_j(gid), _j(k1), _j(k2)], [_j(np.ones(n, bool)), _j(v1), _j(v2)],
        ((True, None), (True, None), (False, True)), _j(alive)))
    return (gid[perm], [np.where(v1, k1, 0)[perm], np.where(v2, k2, 0)[perm]],
            [v1[perm], v2[perm]], (data[perm], valid[perm]))


_WINDOW_FUNCS = ["row_number", "rank", "dense_rank", "count_star", "count",
                 "sum", "avg", "min", "max"]


@pytest.mark.parametrize("func", _WINDOW_FUNCS)
@pytest.mark.parametrize("parts", [1, 37])
@pytest.mark.parametrize("arg_dtype", [np.int64, np.float64])
def test_window_ordered_core_matches_reference(func, parts, arg_dtype):
    n = 3000
    sgid, td, tv, (data, valid) = _window_inputs(n, parts, parts + n,
                                                 arg_dtype)
    with_arg = func not in ("row_number", "rank", "dense_rank",
                            "count_star")
    rv, rvalid = rk.window_ordered_core(
        _j(sgid), [_j(d) for d in td], [_j(v) for v in tv],
        (_j(data), _j(valid)) if with_arg else None, func)
    pv, pvalid = pk.window_ordered_core(
        _t(sgid), [_t(d) for d in td], [_t(v) for v in tv],
        (_t(data), _t(valid)) if with_arg else None, func)
    _eq(pvalid, rvalid)
    # the reference's float sums take another order: rtol there, bits
    # everywhere else (integer sums and averages of integers included)
    float_sum = arg_dtype == np.float64 and func in ("sum", "avg")
    _eq(pv, rv, rtol=RTOL if float_sum else None)


def test_window_ordered_core_without_order_keys_is_one_tie_run():
    """No order keys: every row of a partition ties, so each takes the
    partition's total (count, sum)."""
    sgid = np.array([0, 0, 0, 1, 1, 9, 9], np.int32)
    data = np.array([5, 7, 1, 2, 3, 0, 0], np.int64)
    valid = np.array([1, 1, 0, 1, 1, 0, 0], bool)
    for func in ("count", "sum", "min", "dense_rank", "row_number"):
        args = (data, valid) if func in ("count", "sum", "min") else None
        rv, _ = rk.window_ordered_core(
            _j(sgid), [], [], None if args is None else tuple(map(_j, args)),
            func)
        pv, _ = pk.window_ordered_core(
            _t(sgid), [], [], None if args is None else tuple(map(_t, args)),
            func)
        _eq(pv, rv)


@pytest.mark.parametrize("kind", ["runs", "one", "distinct"])
def test_run_bounds_match_running_max_and_segment_max(kind):
    """The reference reads a run's first row as a running max of flagged
    starts (lax.cummax) and its last row as a segment max of the row index
    (segment_max); on a non-decreasing id the port's two binary searches
    give the same bits."""
    rng = np.random.default_rng(5)
    n = 5000
    new = {"runs": rng.random(n) < 0.1, "one": np.zeros(n, bool),
           "distinct": np.ones(n, bool)}[kind]
    new[0] = True
    run_id = (np.cumsum(new) - 1).astype(np.int32)
    iota = jnp.arange(n, dtype=jnp.int32)
    want_first = jax.lax.cummax(jnp.where(_j(new), iota, 0))
    want_last = jax.ops.segment_max(iota, _j(run_id), num_segments=n)[
        _j(run_id)]
    first, last = pk.run_bounds(_t(run_id))
    _eq(first, want_first)
    _eq(last, want_last)


@pytest.mark.parametrize("kind", ["runs", "unflagged_head", "one",
                                  "distinct"])
@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_sorted_agg_scan_integer_sum_matches_reference(kind, dtype):
    """An integer sum over key-sorted rows is one cumulative sum less its
    value before the group's first row, which run_bounds finds; it keeps
    the bits of the reference's segmented scan, on rows before the first
    group flag and on sums that wrap too."""
    rng = np.random.default_rng(8)
    n = 5000
    new = {"runs": rng.random(n) < 0.1, "unflagged_head": rng.random(n) < 0.1,
           "one": np.zeros(n, bool), "distinct": np.ones(n, bool)}[kind]
    new[0] = kind != "unflagged_head"
    new[1:40] &= kind != "unflagged_head"
    info = np.iinfo(dtype)
    vals = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    want = rk.sorted_agg_scan(_j(vals), _j(new), jnp.add)
    _eq(pk.sorted_agg_scan(_t(vals), _t(new), "add"), want)


@pytest.mark.parametrize("mask_share", [0.0, 0.5, 1.0])
def test_first_row_per_gid_matches_reference_min_scatter(mask_share):
    """Each row outside the mask takes a slot of its own past n in the
    port (one shared slot would serialise a CUDA min scatter); the result,
    slot n included, keeps the reference's bits."""
    rng = np.random.default_rng(11)
    n = 4000
    gid = rng.integers(0, 300, n).astype(np.int32)
    mask = rng.random(n) >= mask_share
    gid = np.where(rng.random(n) < 0.1, n, gid).astype(np.int32)
    iota = jnp.arange(n, dtype=jnp.int32)
    want = jnp.full(n + 1, n, dtype=jnp.int32).at[
        jnp.where(_j(mask), _j(gid), n)].min(iota)
    _eq(pk.first_row_per_gid(_t(gid), _t(mask)), want)


# ---------------------------------------------------------------------------
# concat
# ---------------------------------------------------------------------------

def _concat_exprs(P):
    s = P.BCol("str", 5)
    return {
        "two": P.BCall("str", "concat", [s, P.BLit("str", "-x")]),
        "three_null_parts": P.BCall("str", "concat", [
            P.BLit("str", "id:"), s, P.BCall("str", "upper", [s])]),
        "null_literal": P.BCall("str", "concat", [s, P.BLit("str", None)]),
        "nested": P.BCall("str", "concat", [
            P.BCall("str", "concat", [s, P.BLit("str", "/")]), s]),
    }


@pytest.mark.parametrize("name", sorted(_concat_exprs(PP)))
def test_concat_matches_reference_flattened(name):
    ref, port = _both_tables(_spec(n=300, seed=6))
    rt = rdev.to_device(ref["t"])
    pt = pdev.to_device(port["t"], "cpu")
    r = rdev._flatten_compound(rexprs.evaluate(_concat_exprs(RP)[name], rt))
    p = pexprs.evaluate(_concat_exprs(PP)[name], pt)
    assert p.dtype == r.dtype == "str"
    rvalid = np.asarray(r.valid)
    _eq(p.valid, rvalid)
    assert [p.dictionary[k] for k in p.data.numpy()[rvalid]] == \
        [r.dictionary[k] for k in np.asarray(r.data)[rvalid]]


# ---------------------------------------------------------------------------
# whole plans
# ---------------------------------------------------------------------------

def _tables(n, seed):
    rng = np.random.default_rng(seed)
    words = np.asarray(["ant", "bee", "cat", "dog", "eel"], dtype=object)

    def nulls(a, share):
        return pa.array(a, mask=rng.random(n) < share)
    price = [decimal.Decimal(int(v)).scaleb(-2)
             for v in rng.integers(-5000, 5000, n)]
    return pa.table({
        "k": nulls(rng.integers(0, 4, n), 0.1),
        "o": nulls(rng.integers(0, 9, n), 0.1),
        "v": nulls(rng.integers(-1000, 1000, n), 0.15),
        "p": pa.array(price, type=pa.decimal128(7, 2),
                      mask=rng.random(n) < 0.1),
        # positive floats: the numpy oracle's running sums are differences
        # of one global cumulative sum, which would cancel near zero
        "f": nulls(rng.uniform(1.0, 100.0, n), 0.1),
        "s": nulls(words[rng.integers(0, len(words), n)].astype(str), 0.1),
    })


@pytest.fixture(scope="module")
def sessions():
    ref = RSession(RConfig(decimal_physical="i64"))
    port = nt.Session(nt.EngineConfig(decimal_physical="i64"), device="cpu")
    for name, seed in (("t1", 1), ("t2", 2)):
        t = _tables(400 if name == "t1" else 150, seed)
        ref.register_arrow(name, t)
        port.register_arrow(name, t)
    return ref, port


def _check(sessions, sql, backends=("jax", "numpy")):
    ref, port = sessions
    got = port.sql(sql, backend="torch")
    assert port.last_fallbacks == []
    for backend in backends:
        want = ref.sql(sql, backend=backend)
        assert table_mismatches(got, want) == [], backend
    return got


_WINDOW_SQL = {
    "rank_family": "RANK() OVER (PARTITION BY k ORDER BY o DESC) AS r, "
                   "DENSE_RANK() OVER (PARTITION BY k ORDER BY o) AS dr, "
                   "ROW_NUMBER() OVER (ORDER BY v, o) AS rn",
    "cumulative": "SUM(v) OVER (PARTITION BY k ORDER BY o) AS sv, "
                  "SUM(p) OVER (PARTITION BY s ORDER BY o) AS sp, "
                  "COUNT(*) OVER (ORDER BY o) AS cs",
    # the numpy oracle has no ordered COUNT(x): held to the JAX engine only
    "cumulative_count": "COUNT(v) OVER (PARTITION BY k ORDER BY o) AS cv, "
                        "COUNT(p) OVER (ORDER BY o, v) AS cp",
    "cumulative_avg_min_max": "AVG(p) OVER (PARTITION BY k ORDER BY o) AS ap, "
                              "AVG(f) OVER (PARTITION BY k ORDER BY s) AS af, "
                              "MIN(v) OVER (PARTITION BY s ORDER BY o) AS mn, "
                              "MAX(p) OVER (ORDER BY o) AS mx",
    "whole_partition": "SUM(p) OVER (PARTITION BY k) AS sp, "
                       "AVG(v) OVER (PARTITION BY k, s) AS av, "
                       "MAX(f) OVER () AS mf, COUNT(*) OVER (PARTITION BY s) "
                       "AS c",
}


@pytest.mark.parametrize("name", sorted(_WINDOW_SQL))
def test_window_functions_match_reference(sessions, name):
    got = _check(sessions, f"SELECT k, o, v, p, s, {_WINDOW_SQL[name]} "
                 "FROM t1 WHERE v > -900 ORDER BY k, o, v, p, s",
                 ("jax",) if name == "cumulative_count" else ("jax", "numpy"))
    assert got.num_rows > 300


_SETOP_SQL = {
    "union": "SELECT k, s, p FROM t1 UNION SELECT k, s, p FROM t2",
    "union_all": "SELECT k, s FROM t1 UNION ALL SELECT o, s FROM t2",
    "intersect": "SELECT k, s FROM t1 INTERSECT SELECT k, s FROM t2",
    "except": "SELECT k, s FROM t1 EXCEPT SELECT k, s FROM t2 WHERE o < 3",
    "intersect_three": "SELECT o, s FROM t1 INTERSECT SELECT o, s FROM t2 "
                       "INTERSECT SELECT o, s FROM t1 WHERE v > 0",
}


@pytest.mark.parametrize("name", sorted(_SETOP_SQL))
@pytest.mark.parametrize("ordered", [False, True])
def test_set_operations_match_reference(sessions, name, ordered):
    """Unordered, the port must give the reference's rows in the
    reference's order; ordered, the numpy oracle's too."""
    sql = _SETOP_SQL[name]
    if ordered:
        sql = f"SELECT * FROM ({sql}) x ORDER BY 1, 2"
        got = _check(sessions, sql)
    else:
        ref, port = sessions
        got = port.sql(sql, backend="torch")
        assert port.last_fallbacks == []
        assert table_mismatches(got, ref.sql(sql, backend="jax")) == []
    assert got.num_rows > 0


def test_concat_in_a_projection_matches_reference(sessions):
    _check(sessions, "SELECT k, CONCAT('k=', s, '/', s) AS a, s || '!' AS b, "
           "'x' || CAST(k AS VARCHAR(4)) AS c FROM t1 ORDER BY k, a, b")
