"""The port's kernels against the TPU kernels they replace.

Each CUDA kernel of ``nds_tpu_torch`` has a plain PyTorch version, which
is what runs on CPU tensors. Here every plain version must be
BIT-IDENTICAL to its Pallas kernel, run in interpret mode exactly as
tests/test_pallas_kernels.py runs it, on the same numpy inputs: sort
pairs with ties, sentinel blocks, non-power-of-two lengths, int32/int64
keys and non-iota payloads, keys all equal, only sentinels, 0/1 keys, keys
that differ in the high byte only and keys over the whole type; segment
reductions with out-of-range gids, empty segments, S = 1, 8 and 2048, one
live segment, alternating, sorted and all-dead gids, int8..int64 and
float min/max with NaN and signed zeros; gathers of every dtype with
JAX's clamped and wrapped indices. The CUDA kernels themselves are held
to the same plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nds_tpu.engine.jax_backend import pallas_kernels as pk
from nds_tpu_torch.engine.torch_backend import cuda_kernels as ck
from torch_inputs import seg_gids, sort_keys

ALL_OPS = frozenset({"sort", "groupby", "gather"})


@pytest.fixture(autouse=True)
def _ops_off_after():
    """Leave both engines' thread-local kernel sets empty."""
    yield
    pk.set_active(frozenset())
    ck.set_active(frozenset())


def _bits(a: np.ndarray) -> np.ndarray:
    """Raw bit pattern view (NaN payloads and signed zeros compare)."""
    a = np.ascontiguousarray(a)
    if a.dtype.kind == "f":
        return a.view(np.int64 if a.dtype.itemsize == 8 else np.int32)
    return a


def _same(got: torch.Tensor, want) -> None:
    w = np.asarray(want)
    g = got.numpy()
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    assert np.array_equal(_bits(g), _bits(w))


# ---------------------------------------------------------------------------
# sort_pairs
# ---------------------------------------------------------------------------

def _p(*values):
    """A parametrised case whose id joins its values, leaving out the
    original input kind ("ties", "random") so the original cases keep
    their ids."""
    shown = values[:-1] if values[-1] in ("ties", "random") else values
    return pytest.param(*values, id="-".join(
        getattr(v, "__name__", str(v)) for v in shown))


@pytest.mark.parametrize("n,dtype,payload,keys", [
    _p(2, np.int64, "iota", "ties"), _p(5, np.int32, "perm", "ties"),
    _p(1000, np.int32, "iota", "ties"), _p(3001, np.int64, "perm", "ties"),
    _p(4096, np.int64, "perm", "ties"), _p(6144, np.int32, "perm", "ties"),
    _p(9000, np.int64, "iota", "ties"),
    # the range remap's edges: no key pass, one pass, all eight passes,
    # and the CUDA kernel's tile of 4096 pairs -1, +0, +1
    _p(4095, np.int64, "iota", "equal"),
    _p(3000, np.int32, "perm", "equal"),
    _p(4096, np.int64, "perm", "sentinels"),
    _p(4097, np.int32, "iota", "01"),
    _p(5000, np.int64, "perm", "highbyte"),
    _p(2500, np.int32, "iota", "highbyte"),
    _p(6000, np.int64, "perm", "fullrange"),
    _p(3001, np.int32, "iota", "fullrange")])
def test_sort_pairs_plain_matches_pallas(n, dtype, payload, keys):
    rng = np.random.default_rng(n)
    key = sort_keys(keys, n, dtype, rng)
    idx = (np.arange(n) if payload == "iota" else rng.permutation(n)) \
        .astype(np.int32)
    pk.set_active(ALL_OPS)
    want_k, want_i = pk.sort_pairs(jnp.asarray(key), jnp.asarray(idx))
    got_k, got_i = ck.sort_pairs(torch.from_numpy(key),
                                 torch.from_numpy(idx),
                                 idx_ascending=payload == "iota")
    _same(got_k, want_k)
    _same(got_i, want_i)


def test_sort_pairs_plain_orders_by_idx_within_ties():
    """The order is the total order (key, idx), whatever idx holds: a
    descending idx under all-equal keys comes out ascending."""
    n = 700
    key = np.zeros(n, np.int64)
    idx = np.arange(n, 0, -1).astype(np.int32)
    want_k, want_i = pk.sort_pairs(jnp.asarray(key), jnp.asarray(idx))
    got_k, got_i = ck.sort_pairs(torch.from_numpy(key),
                                 torch.from_numpy(idx))
    _same(got_i, want_i)
    assert np.array_equal(got_i.numpy(), np.arange(1, n + 1))


# ---------------------------------------------------------------------------
# seg_reduce_multi
# ---------------------------------------------------------------------------

_INT_DTYPES = [np.int8, np.int16, np.int32, np.int64, np.uint8]


def _float_operand(rng, n, dtype):
    x = rng.normal(size=n).astype(dtype)
    x[::97] = np.nan
    x[1::89] = 0.0
    x[2::89] = -0.0
    return x


@pytest.mark.parametrize("S,n,gids", [
    _p(1, 5000, "random"), _p(37, 5000, "random"), _p(2048, 3000, "random"),
    # a global aggregate's shape (every live row in segment 0 of S = 8),
    # runs of one row, long runs, and no live row at all
    _p(8, 6000, "segment0"),
    _p(8, 5001, "alternating"),
    _p(37, 5003, "sorted"),
    _p(8, 4099, "dead"),
    # the query path's grouped shape
    _p(1024, 4096, "random")])
def test_seg_reduce_multi_plain_matches_pallas(S, n, gids):
    rng = np.random.default_rng(S)
    gid = seg_gids(gids, S, n, rng)
    ops = []
    for dt in _INT_DTYPES:
        info = np.iinfo(dt)
        x = rng.integers(info.min, int(info.max) + 1, n, dtype=np.int64) \
            .astype(dt)
        ops += [(x, "sum"), (x, "min"), (x, "max")]
    for dt in (np.float64, np.float32):
        x = _float_operand(rng, n, dt)
        ops += [(x, "min"), (x, "max")]
    pk.set_active(ALL_OPS)
    want = pk.seg_reduce_multi([(jnp.asarray(x), op) for x, op in ops],
                               jnp.asarray(gid), S)
    got = ck.seg_reduce_multi([(torch.from_numpy(x), op) for x, op in ops],
                              torch.from_numpy(gid), S)
    assert len(got) == len(want)
    for (x, op), g, w in zip(ops, got, want):
        _same(g, w)


def test_seg_reduce_int32_sum_wraps_in_its_dtype():
    """The Pallas sum pins the operand dtype (no promotion to int64): an
    int32 segment sum past 2^31 wraps, and the plain version wraps alike."""
    n = 4096
    x = np.full(n, 2 ** 30, np.int32)
    gid = (np.arange(n) % 3).astype(np.int32)
    want = pk.seg_reduce(jnp.asarray(x), jnp.asarray(gid), 3, "sum")
    got = ck.seg_reduce_multi([(torch.from_numpy(x), "sum")],
                              torch.from_numpy(gid), 3)[0]
    _same(got, want)
    assert got.dtype == torch.int32


def test_seg_supported_rules_match_pallas():
    for dt in (np.int8, np.int32, np.int64, np.float32, np.float64, np.bool_):
        x = np.zeros(8, dt)
        for op in ("sum", "min", "max"):
            for S in (0, 1, 2048, 2049):
                assert ck.seg_supported(torch.from_numpy(x), S, op) == \
                    pk.seg_supported(jnp.asarray(x), S, op), (dt, op, S)


# ---------------------------------------------------------------------------
# take_many
# ---------------------------------------------------------------------------

def test_take_many_plain_matches_pallas_with_clamped_indices():
    rng = np.random.default_rng(5)
    m, n = 3000, 5000
    srcs = [rng.integers(0, 2, m).astype(np.bool_)]
    srcs += [rng.integers(-100, 100, m).astype(dt)
             for dt in (np.int8, np.int16, np.int32, np.int64, np.uint8)]
    srcs += [rng.normal(size=m).astype(dt) for dt in (np.float32, np.float64)]
    # negatives wrap once from the end, then everything clamps into range
    idx = rng.integers(-m - 40, m + 40, n).astype(np.int32)
    pk.set_active(ALL_OPS)
    want = pk.take_many([jnp.asarray(s) for s in srcs], jnp.asarray(idx))
    got = ck.take_many([torch.from_numpy(s) for s in srcs],
                       torch.from_numpy(idx))
    for g, w in zip(got, want):
        _same(g, w)


def test_take_plain_follows_jax_index_semantics():
    src = torch.arange(10, dtype=torch.int64) * 10
    idx = torch.tensor([-1, -10, -11, -100, 0, 9, 10, 1000], dtype=torch.int32)
    want = np.asarray(jnp.asarray(src.numpy())[jnp.asarray(idx.numpy())])
    assert np.array_equal(ck.take_plain(src, idx).numpy(), want)
    assert ck.take_plain(src, idx).tolist() == [90, 0, 0, 0, 0, 90, 90, 90]


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def test_parse_ops_rejects_unknown_names():
    assert ck.parse_ops("sort, gather") == frozenset({"sort", "gather"})
    assert ck.parse_ops(None) == frozenset()
    with pytest.raises(ValueError):
        ck.parse_ops("sort,bogus")


def test_row_gates_match_pallas():
    assert (ck.SORT_MIN_ROWS, ck.GATHER_MIN_ROWS, ck.GROUPBY_MIN_ROWS,
            ck.GROUPBY_MAX_SEGMENTS) == (pk.SORT_MIN_ROWS, pk.GATHER_MIN_ROWS,
                                         pk.GROUPBY_MIN_ROWS,
                                         pk.GROUPBY_MAX_SEGMENTS)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ck.reset_launches()
    key = torch.arange(100, 0, -1, dtype=torch.int64)
    idx = torch.arange(100, dtype=torch.int32)
    ck.sort_pairs(key, idx)
    ck.take_many([key], idx)
    ck.seg_reduce_multi([(key, "sum")], idx, 100)
    assert ck.LAUNCHES == {"sort_pairs": 0, "seg_reduce_multi": 0,
                           "take_many": 0}
