"""The port's device modules against their nds_tpu.engine.jax_backend
counterparts, on the same numpy arrays.

Both engines get one state: the arrays of a table spec, built into the
reference's Table and, through ``nds_tpu_torch.engine.carry``, into the
port's. Every port call runs on the CPU (``device="cpu"``), where each
CUDA kernel's plain version stands in. Integer and decimal outputs must
be bit-identical; float outputs agree to rtol 1e-9 (float sums are taken
in another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nds_tpu.engine import plan as RP
from nds_tpu.engine.column import Column as RColumn
from nds_tpu.engine.column import Table as RTable
from nds_tpu.engine.jax_backend import device as rdev
from nds_tpu.engine.jax_backend import jexprs as rexprs
from nds_tpu.engine.jax_backend import kernels as rk
from nds_tpu_torch.engine import carry
from nds_tpu_torch.engine import plan as PP
from nds_tpu_torch.engine.torch_backend import cuda_kernels as ck
from nds_tpu_torch.engine.torch_backend import device as pdev
from nds_tpu_torch.engine.torch_backend import exprs as pexprs
from nds_tpu_torch.engine.torch_backend import kernels as pk

RTOL = 1e-9


@pytest.fixture(autouse=True)
def _kernels_off_after():
    yield
    ck.set_active(frozenset())


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _j(a) -> jnp.ndarray:
    return jnp.asarray(np.array(a))


def _eq(got, want, rtol=None) -> None:
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if rtol is not None and w.dtype.kind == "f":
        assert np.allclose(g, w, rtol=rtol, atol=0.0, equal_nan=True)
    else:
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        assert np.array_equal(g, w)


# ---------------------------------------------------------------------------
# device: capacity ladder, upload/download
# ---------------------------------------------------------------------------

def test_bucket_matches_reference_ladder():
    ns = list(range(0, 70)) + [2 ** k + d for k in range(3, 27)
                               for d in (-1, 0, 1)]
    ns += [3 * 2 ** 21, 3 * 2 ** 21 + 1, 28_800_991, 48_000_000]
    for n in ns:
        assert pdev.bucket(n) == rdev.bucket(n), n
        assert pdev.bucket(n, minimum=1) == rdev.bucket(n, minimum=1), n


def _spec(n=200, seed=0):
    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.2
    words = np.asarray(["apple", "pear", "fig", "kiwi", "lime", "plum"],
                       dtype=object)
    return {"t": {
        "i": ("int", rng.integers(-50, 50, n), None, None),
        "j": ("int", rng.integers(-4, 5, n), valid, None),
        "d": ("dec2", rng.integers(-10_000, 10_000, n), None, None),
        "e": ("dec2", rng.integers(-500, 500, n), valid[::-1].copy(), None),
        "f": ("float", rng.normal(size=n) * 100, valid, None),
        "s": ("str", rng.integers(0, len(words), n).astype(np.int32),
              valid, words),
        "dt": ("date", rng.integers(10_000, 12_000, n).astype(np.int32),
               None, None),
        "b": ("bool", rng.random(n) > 0.5, valid, None),
    }}


def _both_tables(spec):
    port = carry.tables_from_numpy(spec)
    ref = {name: RTable(list(cols), [
        RColumn(dt, np.asarray(d).astype(carry.phys_np(dt)),
                None if v is None else np.asarray(v, bool),
                None if dic is None else np.asarray(dic, dtype=object))
        for dt, d, v, dic in cols.values()]) for name, cols in spec.items()}
    return ref, port


def test_to_device_matches_reference_and_round_trips():
    ref, port = _both_tables(_spec())
    rt = rdev.to_device(ref["t"])
    pt = pdev.to_device(port["t"], "cpu")
    assert pt.capacity == rt.capacity == 256
    _eq(pt.alive, rt.alive)
    for rc, pc in zip(rt.cols, pt.cols):
        assert pc.dtype == rc.dtype
        _eq(pc.data, rc.data)
        _eq(pc.valid, rc.valid)
    back = pdev.to_host(pt)
    for a, b in zip(back.columns, port["t"].columns):
        assert a.dtype == b.dtype
        _eq(_t(a.validity), b.validity)
        if a.dtype == "str":
            assert list(a.decode()) == list(b.decode())
        else:
            _eq(_t(a.data[a.validity]), b.data[b.validity])


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _group_inputs(n, seed):
    rng = np.random.default_rng(seed)
    k1 = rng.integers(0, 30, n).astype(np.int64)
    k2 = rng.integers(-5, 5, n).astype(np.int32)
    v1 = rng.random(n) > 0.1
    v2 = rng.random(n) > 0.1
    alive = rng.random(n) > 0.25
    return [k1, k2], [v1, v2], alive


@pytest.mark.parametrize("n,kernels_on", [(1000, False), (8192, True),
                                          (16384, False)])
def test_dense_rank_tiers_match_reference(n, kernels_on):
    keys, valids, alive = _group_inputs(n, n)
    if kernels_on:
        ck.set_active(ck.VALID_OPS)
    for p_fn, r_fn in ((pk.dense_rank, rk.dense_rank),
                       (pk.dense_rank_packsort, rk.dense_rank_packsort)):
        pg, png = p_fn([_t(k) for k in keys], [_t(v) for v in valids],
                       _t(alive))
        rg, rng_ = r_fn([_j(k) for k in keys], [_j(v) for v in valids],
                        _j(alive))
        _eq(pg, rg)
        assert int(png) == int(rng_)
    assert int(pk.group_tier([_t(k) for k in keys], [_t(v) for v in valids],
                             _t(alive))) == \
        int(rk.group_tier([_j(k) for k in keys], [_j(v) for v in valids],
                          _j(alive)))


@pytest.mark.parametrize("n", [100, 9000])
def test_compaction_perm_matches_reference(n):
    alive = np.random.default_rng(n).random(n) > 0.6
    ck.set_active(ck.VALID_OPS)
    pp, pc = pk.compaction_perm(_t(alive))
    rp, rc = rk.compaction_perm(_j(alive))
    _eq(pp, rp)
    assert int(pc) == int(rc)


_AGG_FUNCS = ["count_star", "count", "sum", "min", "max", "avg",
              "stddev_samp"]


@pytest.mark.parametrize("func", _AGG_FUNCS)
@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_agg_apply_matches_reference(func, dtype):
    n, seed = 5000, 11
    keys, valids, alive = _group_inputs(n, seed)
    rng = np.random.default_rng(seed + 1)
    data = (rng.integers(-10**6, 10**6, n) if dtype == np.int64
            else rng.normal(size=n) * 1e3).astype(dtype)
    valid = rng.random(n) > 0.15
    ck.set_active(ck.VALID_OPS)          # the groupby kernel's plain version
    gid, ng = rk.dense_rank([_j(k) for k in keys], [_j(v) for v in valids],
                            _j(alive))
    cap = rdev.bucket(int(ng))
    gid = np.asarray(gid)
    arg_r = None if func == "count_star" else (_j(data), _j(valid))
    arg_p = None if func == "count_star" else (_t(data), _t(valid))
    rv, rvalid = rk.agg_apply(_j(gid), _j(alive), func, arg_r, cap)
    pv, pvalid = pk.agg_apply(_t(gid), _t(alive), func, arg_p, cap)
    _eq(pvalid, rvalid)
    _eq(pv, rv, rtol=RTOL)


def test_group_representatives_drops_out_of_range_gids():
    """The reference's .at[].set drops an out-of-range gid; the port masks
    it explicitly (torch would fault)."""
    n, cap = 300, 128           # above the masked-reduce cutoff
    rng = np.random.default_rng(3)
    gid = rng.integers(0, cap + 40, n).astype(np.int32)
    alive = rng.random(n) > 0.2
    data = (gid.astype(np.int64) * 7)
    valid = np.ones(n, bool)
    rv, rvalid = rk.group_representatives(_j(gid), _j(alive), _j(data),
                                          _j(valid), cap)
    pv, pvalid = pk.group_representatives(_t(gid), _t(alive), _t(data),
                                          _t(valid), cap)
    _eq(pv, rv)
    _eq(pvalid, rvalid)


def test_expand_join_matches_reference():
    rng = np.random.default_rng(8)
    n = 700
    cnt = rng.integers(0, 4, n).astype(np.int32)
    alive = rng.random(n) > 0.2
    cnt = np.where(alive, cnt, 0).astype(np.int32)
    lo = rng.integers(0, 50, n).astype(np.int32)
    cap = rdev.bucket(int(cnt.sum()))
    r = rk.expand_join(_j(lo), _j(cnt), _j(alive), cap)
    p = pk.expand_join(_t(lo), _t(cnt), _t(alive), cap)
    for a, b in zip(p, r):
        _eq(a, b)


def test_probe_counts_by_gid_matches_reference():
    rng = np.random.default_rng(9)
    bg = rng.integers(0, 40, 300).astype(np.int32)
    ba = rng.random(300) > 0.3
    pg = rng.integers(-3, 70, 500).astype(np.int32)
    pa = rng.random(500) > 0.3
    r = rk.probe_counts_by_gid(_j(bg), _j(ba), _j(pg), _j(pa), 64)
    p = pk.probe_counts_by_gid(_t(bg), _t(ba), _t(pg), _t(pa), 64)
    for a, b in zip(p, r):
        _eq(a, b)


@pytest.mark.parametrize("specs", [((True, None),), ((False, None),
                                                     (True, True))])
def test_sort_perm_matches_reference(specs):
    keys, valids, alive = _group_inputs(3000, 4)
    keys, valids = keys[:len(specs)], valids[:len(specs)]
    p = pk.sort_perm([_t(k) for k in keys], [_t(v) for v in valids], specs,
                     _t(alive))
    r = rk.sort_perm([_j(k) for k in keys], [_j(v) for v in valids], specs,
                     _j(alive))
    _eq(p, r)


# ---------------------------------------------------------------------------
# exprs.evaluate
# ---------------------------------------------------------------------------

# columns of _spec: 0 i, 1 j, 2 d (dec2), 3 e (dec2), 4 f, 5 s, 6 dt, 7 b
def _exprs(P):
    c = {"i": P.BCol("int", 0), "j": P.BCol("int", 1),
         "d": P.BCol("dec2", 2), "e": P.BCol("dec2", 3),
         "f": P.BCol("float", 4), "s": P.BCol("str", 5),
         "dt": P.BCol("date", 6), "b": P.BCol("bool", 7)}

    def call(dtype, op, *args, extra=None):
        return P.BCall(dtype, op, list(args), extra)

    def lit(dtype, v):
        return P.BLit(dtype, v)
    return {
        "add": call("int", "add", c["i"], c["j"]),
        "sub_dec": call("dec2", "sub", c["d"], c["e"]),
        "mul_dec": call("dec4", "mul", c["d"], c["e"]),
        "mod": call("int", "mod", c["i"], c["j"]),
        "div": call("float", "div", c["d"], c["j"]),
        "add_float": call("float", "add", c["f"], c["i"]),
        "neg": call("int", "neg", c["i"]),
        "ratdiv_hi": call("int", "ratdiv_hi", c["d"], c["e"]),
        "ratdiv_lo": call("int", "ratdiv_lo", c["d"], c["e"]),
        "lt": call("bool", "lt", c["i"], lit("int", 3)),
        "ge_dec": call("bool", "ge", c["d"], c["e"]),
        "eq_str": call("bool", "eq", c["s"], lit("str", "fig")),
        "lt_str": call("bool", "lt", c["s"], lit("str", "lime")),
        "and_or": call("bool", "or", call("bool", "and", c["b"],
                                          call("bool", "gt", c["j"],
                                               lit("int", 0))),
                       call("bool", "isnull", c["f"])),
        "not": call("bool", "not", c["b"]),
        "in_int": call("bool", "in_list", c["j"], extra=[1, 2, 3]),
        "in_null": call("bool", "in_list", c["j"], extra=[1, None]),
        "in_str": call("bool", "in_list", c["s"], extra=["pear", "kiwi"]),
        "in_dec": call("bool", "in_list", c["d"], extra=[12.5, -3.25]),
        "like": call("bool", "like", c["s"], extra="%i%"),
        "like_us": call("bool", "like", c["s"], extra="_i__"),
        "case": call("float", "case",
                     call("bool", "gt", c["i"], lit("int", 10)), c["f"],
                     call("bool", "lt", c["i"], lit("int", -10)),
                     call("float", "cast", c["j"]),
                     lit("float", None)),
        "case_str": call("str", "case",
                         call("bool", "gt", c["i"], lit("int", 0)), c["s"],
                         lit("str", "none")),
        "coalesce": call("int", "coalesce", c["j"], c["i"]),
        "cast_dec_int": call("int", "cast", c["d"]),
        "cast_dec_float": call("float", "cast", c["e"]),
        "cast_float_dec": call("dec2", "cast", c["f"]),
        "cast_int_dec": call("dec2", "cast", c["i"]),
        "cast_dec_dec": call("dec1", "cast", c["d"]),
        "round_dec": call("dec2", "round", c["d"], extra=1),
        "round_float": call("float", "round", c["f"], extra=2),
        "abs": call("dec2", "abs", c["e"]),
        "nullif": call("int", "nullif", c["i"], c["j"]),
        "substr": call("str", "substr", c["s"], extra=(2, 2)),
        "upper": call("str", "upper", c["s"]),
        "date_add": call("date", "add", c["dt"], lit("int", 30)),
    }


@pytest.mark.parametrize("name", sorted(_exprs(PP)))
def test_evaluate_matches_jexprs(name):
    ref, port = _both_tables(_spec(n=300, seed=5))
    rt = rdev.to_device(ref["t"])
    pt = pdev.to_device(port["t"], "cpu")
    r = rexprs.evaluate(_exprs(RP)[name], rt)
    p = pexprs.evaluate(_exprs(PP)[name], pt)
    assert p.dtype == r.dtype
    rvalid = np.asarray(r.valid)
    _eq(p.valid, rvalid)
    if p.dtype == "str":
        pd, rd = p.data.numpy(), np.asarray(r.data)
        assert [p.dictionary[k] for k in pd[rvalid]] == \
            [r.dictionary[k] for k in rd[rvalid]]
    else:
        _eq(p.data[_t(rvalid)], np.asarray(r.data)[rvalid], rtol=RTOL)
