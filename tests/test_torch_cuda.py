"""The port's CUDA kernels on the card (marked ``cuda``; they skip where
there is no card, since a CUDA kernel has no CPU mode).

Run on a machine with an NVIDIA card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the repository's conftest imports jax, which the port
does not need.)

Each kernel builds from nds_tpu_torch/csrc/ and must be bit-identical to
its plain version on the same CUDA tensors, and the star query must give
on the card what it gives on the CPU.
"""
import numpy as np
import pytest
import torch

from nds_tpu_torch.engine.torch_backend import cuda_kernels as ck

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    ck.build()
    return torch.device("cuda")


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype.is_floating_point:
            bits = torch.int64 if g.element_size() == 8 else torch.int32
            g, w = g.view(bits), w.view(bits)
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,dtype", [(2, torch.int64), (777, torch.int32),
                                     (8192, torch.int64),
                                     (70001, torch.int32)])
def test_sort_pairs_kernel_matches_plain(dev, n, dtype):
    g = torch.Generator().manual_seed(n)
    key = torch.randint(-9, 9, (n,), generator=g).to(dtype)
    key[: n // 3] = torch.iinfo(dtype).max
    idx = torch.randperm(n, generator=g).to(torch.int32)
    key, idx = key.to(dev), idx.to(dev)
    before = ck.LAUNCHES["sort_pairs"]
    got = ck.sort_pairs(key, idx)
    assert ck.LAUNCHES["sort_pairs"] == before + 1
    _same(got, ck.sort_pairs_plain(key, idx))
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    _same(ck.sort_pairs(key, iota, idx_ascending=True),
          ck.sort_pairs_plain(key, iota))


@pytest.mark.parametrize("S", [1, 100, 2048])
def test_seg_reduce_multi_kernel_matches_plain(dev, S):
    g = torch.Generator().manual_seed(S)
    n = 30000
    gid = torch.randint(-2, S + 2, (n,), generator=g, dtype=torch.int32)
    ops = []
    for dt in (torch.int8, torch.int16, torch.int32, torch.int64,
               torch.uint8):
        x = torch.randint(0, 120, (n,), generator=g).to(dt)
        ops += [(x, "sum"), (x, "min"), (x, "max")]
    x = torch.randn(n, generator=g, dtype=torch.float64)
    x[::31] = float("nan")
    x[1::29] = -0.0
    ops += [(x, "min"), (x, "max"), (x.float(), "min"), (x.float(), "max")]
    ops = [(d.to(dev), op) for d, op in ops]
    gid = gid.to(dev)
    _same(ck.seg_reduce_multi(ops, gid, S),
          ck.seg_reduce_multi_plain(ops, gid, S))


def test_take_many_kernel_matches_plain(dev):
    g = torch.Generator().manual_seed(1)
    m, n = 5000, 20000
    srcs = [torch.randint(0, 2, (m,), generator=g).bool()]
    srcs += [torch.randint(-100, 100, (m,), generator=g).to(dt)
             for dt in (torch.int8, torch.int16, torch.int32, torch.int64)]
    srcs += [torch.randn(m, generator=g, dtype=dt)
             for dt in (torch.float32, torch.float64)]
    idx = torch.randint(-m - 9, m + 9, (n,), generator=g, dtype=torch.int32)
    srcs, idx = [s.to(dev) for s in srcs], idx.to(dev)
    _same(ck.take_many(srcs, idx), [ck.take_plain(s, idx) for s in srcs])


def test_star_query_on_the_card_matches_the_cpu(dev):
    import pyarrow as pa

    import nds_tpu_torch as nt
    from nds_tpu_torch.validate import table_mismatches
    rng = np.random.default_rng(17)
    n = 100_000
    fact = pa.table({"fk": pa.array(rng.integers(0, 520, n), pa.int32()),
                     "qty": pa.array(rng.integers(1, 100, n), pa.int32()),
                     "price": pa.array(rng.uniform(0.5, 999.0, n)),
                     "day": pa.array(rng.integers(0, 365, n), pa.int32())})
    dim = pa.table({"dk": pa.array(np.arange(512), pa.int32()),
                    "grp": pa.array((np.arange(512) % 17).astype(np.int32))})
    sql = ("SELECT d.grp, COUNT(*) AS cnt, SUM(f.qty) AS q, "
           "MAX(f.price) AS mx FROM fact f JOIN dim d ON f.fk = d.dk "
           "WHERE f.qty > 5 GROUP BY d.grp ORDER BY d.grp")
    out = {}
    for device in ("cuda", "cpu"):
        s = nt.Session(device=device)
        s.register_arrow("fact", fact)
        s.register_arrow("dim", dim)
        out[device] = s.sql(sql)
        assert s.last_fallbacks == []
    assert table_mismatches(out["cuda"], out["cpu"]) == []
