"""The packed narrow-lane layout on the card (marked ``cuda``; they skip
where there is no card).

Run on a machine with an NVIDIA card:

    python -m pytest --noconftest -m cuda tests/test_torch_lanes_cuda.py

A packed buffer on the card unpacks to the columns to_device gives for
the same table (every lane, dictionary and run-length sections), also
inside a CUDA graph whose buffer takes another morsel's bytes before each
replay; and a streamed session with lanes and encodings on runs packed,
captures its morsel program once and equals the numpy executor cold and
warm."""
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import nds_tpu_torch as nt
from nds_tpu_torch.engine.column import Column, Table
from nds_tpu_torch.engine.torch_backend import cuda_kernels as ck
from nds_tpu_torch.engine.torch_backend import device as tdevice
from nds_tpu_torch.validate import table_mismatches
from torch_isolation import isolate_port_programs  # noqa: F401

pytestmark = pytest.mark.cuda

CAP = 4096
LANES = ("u8", "u16", "u32", "i32", "i64", "f64", "b1", "u16", "u32")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the layout's graphs run there")
    ck.build()
    return torch.device("cuda")


def morsel(seed: int, n: int = 3000):
    """A table on every lane, a dictionary column and a run-length one:
    (table, lanes, encodings, codebooks)."""
    rng = np.random.default_rng(seed)
    valid = rng.random(n) < 0.8
    book = np.arange(0, 3_000_000, 9973).astype(np.int32)
    cols = [("int", rng.integers(0, 256, n)),
            ("int", rng.integers(0, 65_536, n)),
            ("int", rng.integers(0, 2 ** 31 - 1, n)),
            ("date", rng.integers(-10_000, 80_000, n)),
            ("int", rng.integers(-2 ** 40, 2 ** 40, n)),
            ("float", rng.normal(size=n)),
            ("bool", rng.integers(0, 2, n).astype(bool)),
            ("int", rng.choice(book, n)),
            ("int", np.sort(rng.integers(0, 30, n)) * 1_000_003)]
    table = Table([f"c{i}" for i in range(len(cols))], [
        Column.from_values(d, np.asarray(x), valid if i % 2 else None)
        for i, (d, x) in enumerate(cols)])
    encs = ("plain",) * 7 + (("dict", len(book)), ("rle", 40))
    return table, LANES, encs, (None,) * 7 + (book, None)


def test_unpack_on_the_card_matches_to_device(dev):
    table, lanes, encs, books = morsel(1)
    packed = tdevice.pack_table(table, dev, CAP, lanes, encs, books)
    assert packed.data.device.type == "cuda"
    got = tdevice.to_host(tdevice.unpack_table(packed))
    want = tdevice.to_host(tdevice.to_device(table, "cpu", CAP))
    assert table_mismatches(got, want) == []
    for a, b in zip(got.columns, want.columns):
        np.testing.assert_array_equal(np.asarray(a.data), np.asarray(b.data))


def test_unpack_captured_in_a_graph_serves_every_morsel(dev):
    """One capture over a fixed buffer: unpack, decode and widen replay
    on whatever morsel the buffer holds, without a host sync."""
    tables = [morsel(s) for s in (2, 3, 4)]
    table, lanes, encs, books = tables[0]
    slot = tdevice.pack_table(table, dev, CAP, lanes, encs, books)
    for b in books:
        if b is not None:
            tdevice.codebook_device(b, dev)     # before the capture

    def program():
        t = tdevice.unpack_table(slot)
        return [tdevice.widen_col(c).data for c in t.cols] + \
            [c.valid for c in t.cols] + [t.alive]
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        program()                               # warm-up
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            outs = program()
    for table, *_ in tables:
        host, _ = tdevice._pack_payload(table, lanes, table.num_rows, CAP,
                                        encs, books)
        slot.data.copy_(torch.from_numpy(host))
        graph.replay()
        torch.cuda.synchronize()
        want = program()
        for g, w in zip(outs, want):
            assert torch.equal(g, w)


def test_streamed_session_packs_and_replays_on_the_card(dev, tmp_path):
    rng = np.random.default_rng(5)
    n = 60_000
    fact = pa.table({
        "fk": pa.array(rng.choice(np.arange(0, 3_000_000, 9973), n),
                       type=pa.int64()),
        "qty": pa.array(rng.integers(1, 50, n), type=pa.int32()),
        "day": pa.array(np.sort(rng.integers(0, 200, n)), type=pa.int64()),
        "price": pa.array(np.round(rng.uniform(1, 100, n), 2)),
    })
    path = os.path.join(str(tmp_path), "fact.parquet")
    pq.write_table(fact, path, row_group_size=8192)
    dim = pa.table({"dk": pa.array(np.arange(0, 3_000_000, 9973),
                                   type=pa.int64()),
                    "grp": pa.array(np.arange(301) % 7, type=pa.int32())})
    s = nt.Session(nt.EngineConfig(out_of_core_min_rows=10_000,
                                   chunk_rows=8192))
    s.register_parquet("fact", path)
    s.register_arrow("dim", dim)
    sql = ("SELECT d.grp, SUM(f.qty) s, COUNT(*) c, MAX(f.day) md, "
           "SUM(f.price) sp FROM fact f JOIN dim d ON f.fk = d.dk "
           "WHERE f.day < 150 AND f.fk IN (9973, 19946, 29919, 1) "
           "OR f.qty > 40 GROUP BY d.grp ORDER BY d.grp")
    want = s.sql(sql, backend="numpy")
    for run in range(3):
        got = s.sql(sql)
        st = s.last_stats
        assert st["mode"] == "streamed" and st["fallbacks"] == []
        assert st["enc_spec"]["fact"]["fk"].startswith("dict[")
        assert st["enc_spec"]["fact"]["day"].startswith("rle[")
        assert st["captures"] == (1 if run == 0 else 0)
        assert st["re_records"] == 0
        assert table_mismatches(got, want) == []
