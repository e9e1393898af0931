"""The port's CUDA kernels on the card (marked ``cuda``; they skip where
there is no card, since a CUDA kernel has no CPU mode).

Run on a machine with an NVIDIA card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the repository's conftest imports jax, which the port
does not need.)

Each kernel builds from nds_tpu_torch/csrc/ and must be bit-identical to
its plain version on the same CUDA tensors, also when a CUDA graph
captured it and replays it, and the star query must give on the card what
it gives on the CPU. A query's units on the card go record, compile+run
(the capture) and compiled (graph replays).
"""
import numpy as np
import pytest
import torch

from nds_tpu_torch.engine.torch_backend import cuda_kernels as ck
from torch_inputs import seg_gids, sort_keys
from torch_isolation import isolate_port_programs  # noqa: F401

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


#: (keys, key dtype) -> the key digit passes the range remap leaves
_PASSES = {("equal", np.int64): 0, ("sentinels", np.int32): 0,
           ("01", np.int32): 1, ("ties", np.int64): 1,
           ("highbyte", np.int64): 8, ("highbyte", np.int32): 4,
           ("fullrange", np.int64): 8, ("fullrange", np.int32): 4}


@pytest.mark.parametrize("repeat", [0, 1])
@pytest.mark.parametrize("n", [4095, 4096, 4097, 10_000_019])
@pytest.mark.parametrize("keys,dtype", list(_PASSES))
def test_sort_pairs_kernel_edges_match_plain(dev, keys, dtype, n, repeat):
    """The range remap's pass counts (0, 1, 4, 8; odd and even), the tile
    of 4096 pairs -1, +0, +1, and thousands of tiles for the look-back
    between them, twice (a look-back race would show intermittently)."""
    rng = np.random.default_rng(n + repeat)
    key = torch.from_numpy(sort_keys(keys, n, dtype, rng)).to(dev)
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32))
    for idx, ascending in ((perm, False),
                           (torch.arange(n, dtype=torch.int32), True)):
        idx = idx.to(dev)
        *got, passes = ck.sort_pairs_with_passes(key, idx,
                                                 idx_ascending=ascending)
        assert passes == _PASSES[keys, dtype]
        _same(got, ck.sort_pairs_plain(key, idx))


@pytest.mark.parametrize("S", [1, 100, 2048])
def test_seg_reduce_multi_kernel_matches_plain(dev, S):
    g = torch.Generator().manual_seed(S)
    n = 30000
    gid = torch.randint(-2, S + 2, (n,), generator=g, dtype=torch.int32)
    ops = _seg_operands(g, n)
    ops = [(d.to(dev), op) for d, op in ops]
    gid = gid.to(dev)
    _same(ck.seg_reduce_multi(ops, gid, S),
          ck.seg_reduce_multi_plain(ops, gid, S))


def _seg_operands(g, n):
    """19 operands: integer sums, min and max of every width, and float
    min/max with NaN and signed zeros."""
    ops = []
    for dt in (torch.int8, torch.int16, torch.int32, torch.int64,
               torch.uint8):
        x = torch.randint(0, 120, (n,), generator=g).to(dt)
        ops += [(x, "sum"), (x, "min"), (x, "max")]
    x = torch.randn(n, generator=g, dtype=torch.float64)
    x[::31] = float("nan")
    x[1::29] = -0.0
    ops += [(x, "min"), (x, "max"), (x.float(), "min"), (x.float(), "max")]
    return ops


@pytest.mark.parametrize("repeat", [0, 1])
@pytest.mark.parametrize("S,n,gids", [
    (8, 6_291_459, "segment0"), (8, 100_003, "alternating"),
    (37, 100_003, "sorted"), (8, 4099, "dead"), (2048, 500_001, "random"),
    # the query path's grouped shape; 4 rows a thread in row mode
    (1024, 4096, "random"), (8, 1_000_003, "alternating"),
    (37, 1_000_003, "random")])
@pytest.mark.parametrize("nops", [2, 16])
def test_seg_reduce_multi_kernel_edges_match_plain(dev, S, n, gids, nops,
                                                   repeat):
    """A global aggregate's shape (one live segment of S = 8), runs of one
    row, long runs, no live row, many random segments, the query path's
    grouped call (4096 rows), and rows enough for 4 rows a thread; two int64
    sums (q9's shape) and 16 operands of every kind; unaligned operands
    (a slice one row in) take the scalar loads."""
    rng = np.random.default_rng(n + repeat)
    g = torch.Generator().manual_seed(n + repeat)
    gid = torch.from_numpy(seg_gids(gids, S, n, rng)).to(dev)
    if nops == 2:
        ops = [(torch.randint(-10 ** 12, 10 ** 12, (n,), generator=g), "sum")
               for _ in range(2)]
    else:
        ops = _seg_operands(g, n)[3:]
    ops = [(d.to(dev), op) for d, op in ops]
    if repeat:
        gid = torch.cat([gid[:1], gid])[1:]
        ops = [(torch.cat([d[:1], d])[1:], op) for d, op in ops]
    _same(ck.seg_reduce_multi(ops, gid, S),
          ck.seg_reduce_multi_plain(ops, gid, S))


def test_seg_reduce_multi_scratch_is_left_clear(dev):
    """The kernel clears the device words it used, which the wrapper keeps
    for the next call on the stream: calls of other shapes in turn (float
    operands with NaN words and without, S = 8 and 1024, one launch and a
    grid of blocks) each match the plain version."""
    g = torch.Generator().manual_seed(5)
    floats = _seg_operands(g, 70_000)[15:]
    ints = [(torch.randint(-10 ** 12, 10 ** 12, (70_000,), generator=g),
             "sum")]
    for ops, S, n in ((floats, 8, 70_000), (ints, 1024, 4096),
                      (floats, 8, 300), (ints, 1024, 70_000),
                      (floats, 8, 70_000)):
        gid = torch.randint(-1, S + 1, (n,), generator=g,
                            dtype=torch.int32).to(dev)
        part = [(d[:n].to(dev), op) for d, op in ops]
        _same(ck.seg_reduce_multi(part, gid, S),
              ck.seg_reduce_multi_plain(part, gid, S))


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


@pytest.fixture(scope="module")
def sf001(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    from nds_tpu_torch import datagen
    data = str(tmp_path_factory.mktemp("cuda_units") / "sf001")
    datagen.generate(data, 0.01, parallel=2)
    return data


@pytest.mark.parametrize("name", ["query47", "query87", "query84"])
def test_template_units_on_the_card_match_the_cpu(dev, sf001, name):
    """One unit of each of the device paths that came last: window
    functions (RANK and AVG over a self-joined CTE), a set operation
    (EXCEPT) and string concatenation, strict on the card and equal to the
    port's result on the CPU."""
    import nds_tpu_torch as nt
    from nds_tpu_torch import datagen, streams
    from nds_tpu_torch.validate import table_mismatches
    sql = dict(streams.template_units(stream=0, rngseed=3))[name]
    out = {}
    for device in ("cuda", "cpu"):
        s = nt.Session(nt.EngineConfig(decimal_physical="i64"),
                       device=device)
        datagen.setup_tables(s, sf001)
        out[device] = s.sql(sql)
        assert s.last_fallbacks == []
    assert table_mismatches(out["cuda"], out["cpu"]) == []


def _kernel_calls(dev):
    """One call of each kernel, at shapes that take it: (name, fn)."""
    g = torch.Generator().manual_seed(11)
    n = 50_001
    key = torch.randint(-9, 9, (n,), generator=g).to(dev)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    gid = torch.randint(-2, 40, (n,), generator=g, dtype=torch.int32).to(dev)
    ops = [(d.to(dev), op) for d, op in _seg_operands(g, n)]
    srcs = [torch.randint(-99, 99, (n,), generator=g).to(dt).to(dev)
            for dt in (torch.int8, torch.int32, torch.int64)]
    idx = torch.randint(-n, n, (n,), generator=g, dtype=torch.int32).to(dev)
    return [
        ("sort_pairs", lambda: ck.sort_pairs(key, iota, idx_ascending=True),
         lambda: ck.sort_pairs_plain(key, iota)),
        ("seg_reduce_multi", lambda: ck.seg_reduce_multi(ops, gid, 37),
         lambda: ck.seg_reduce_multi_plain(ops, gid, 37)),
        ("take_many", lambda: ck.take_many(srcs, idx),
         lambda: [ck.take_plain(x, idx) for x in srcs])]


def _capture(fn, stream, pool=None):
    """fn captured in a CUDA graph on `stream`, after one launch there
    (which sizes the kernel's scratch): (graph, its static outputs)."""
    with torch.cuda.stream(stream):
        fn()
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=pool)
        out = list(fn())
        graph.capture_end()
    return graph, out


@pytest.mark.parametrize("which", [0, 1, 2])
def test_kernel_replayed_in_a_graph_matches_eager_and_plain(dev, which):
    name, fn, plain = _kernel_calls(dev)[which]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    before = ck.LAUNCHES[name]
    eager = list(fn())
    per_call = ck.LAUNCHES[name] - before
    graph, out = _capture(fn, stream)
    # a first call on the stream and the capture; replays call no wrapper
    assert ck.LAUNCHES[name] == before + 3 * per_call
    for _ in range(3):
        with torch.cuda.stream(stream):
            graph.replay()
        stream.synchronize()
        _same(out, eager)
        _same(out, list(plain()))
    assert ck.LAUNCHES[name] == before + 3 * per_call


def test_seg_reduce_multi_scratch_is_clear_after_graph_replays(dev):
    _, fn, plain = _kernel_calls(dev)[1]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph, out = _capture(fn, stream)
    for _ in range(5):
        with torch.cuda.stream(stream):
            graph.replay()
    stream.synchronize()
    _same(out, list(plain()))
    words = [w for (_, st), w in ck._SEG_SCRATCH.items()
             if st == stream.cuda_stream]
    assert len(words) == 1 and int(torch.count_nonzero(words[0])) == 0


def test_graphs_sharing_a_pool_replay_alternately(dev):
    """Two graphs in one memory pool, replayed A, B, A, B on one stream,
    each output consumed (copied) before the next replay: the eager bits
    every time."""
    calls = _kernel_calls(dev)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    pool = torch.cuda.graph_pool_handle()
    graphs = []
    for _, fn, plain in (calls[0], calls[2]):
        graphs.append((_capture(fn, stream, pool), list(plain())))
    for (graph, out), want in graphs + graphs:
        with torch.cuda.stream(stream):
            graph.replay()
            got = [t.clone() for t in out]
        stream.synchronize()
        _same(got, want)


@pytest.mark.parametrize("name", ["query3", "query5", "query67", "query87"])
def test_session_on_the_card_follows_the_lifecycle(dev, sf001, name):
    """record, then compile+run (a query of several units compiles them
    all before its second run: compiled), then compiled: graph replays,
    each equal to the numpy oracle."""
    import nds_tpu_torch as nt
    from nds_tpu_torch import datagen, streams
    from nds_tpu_torch.engine.torch_backend.compiled import \
        clear_shared_programs
    from nds_tpu_torch.validate import table_mismatches
    sql = dict(streams.template_units(stream=0, rngseed=3))[name]
    # a template an earlier test ran would be adopted from the shared
    # registry ("adopted"), not recorded
    clear_shared_programs()
    s = nt.Session(nt.EngineConfig(decimal_physical="i64"), device="cuda")
    datagen.setup_tables(s, sf001)
    want = s.sql(sql, backend="numpy")
    modes = []
    for _ in range(4):
        got = s.sql(sql)
        assert s.last_fallbacks == []
        assert table_mismatches(got, want) == []
        modes.append(s.last_stats["mode"])
    assert modes[0] == "record" and modes[1] in ("compile+run", "compiled")
    assert modes[2:] == ["compiled", "compiled"]
    assert s.last_stats["graph_ms"] > 0
