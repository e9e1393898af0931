"""The port's narrow-lane packed layout on the CPU, part 2: the streamed
path with lanes on and off (tests/test_narrow_lanes.py's streamed cases),
held against nds_tpu on the same seeded data.

- Lanes on and off give the same result, the reference's, at about half
  the bytes; the lane spec is the reference's.
- narrow_lanes is part of the stream cache's key: a live toggle plans
  again.
- Lanes come from table-wide stats, not from a morsel's.
- Stats sources: Arrow tables and Parquet metadata, invalidated on
  re-registration.
- Stats that lie make the packing raise LaneOverflowError on the calling
  thread, and the group's slot is freed.
- Dictionary arrays load without a Python loop (arrow_bridge)."""
import decimal
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from nds_tpu.config import EngineConfig as RConfig
from nds_tpu.engine import Session as RSession

import nds_tpu_torch as nt
from nds_tpu_torch.engine import arrow_bridge
from nds_tpu_torch.engine.torch_backend import device as tdevice
from nds_tpu_torch.validate import table_mismatches

N_FACT, N_DIM = 50_000, 300
CHUNK = 4_096


@pytest.fixture(scope="module")
def bench_shape(tmp_path_factory):
    """tests/test_narrow_lanes.py's NDS-fact shape (seed 23): int64 keys
    with small ranges, a small-int quantity, an f64 price, a date-like
    key and a flag."""
    tmp = tmp_path_factory.mktemp("torch_lanes2")
    rng = np.random.default_rng(23)
    qty = rng.integers(1, 100, N_FACT).astype(object)
    qty[rng.random(N_FACT) < 0.05] = None
    fact = pa.table({
        "fk": pa.array(rng.integers(0, N_DIM + 5, N_FACT), type=pa.int64()),
        "qty": pa.array(list(qty), type=pa.int32()),
        "price": pa.array(np.round(rng.uniform(1, 100, N_FACT), 2)),
        "day": pa.array(rng.integers(2_450_000, 2_453_000, N_FACT),
                        type=pa.int64()),
        "flag": pa.array(rng.integers(0, 2, N_FACT).astype(bool)),
    })
    path = os.path.join(str(tmp), "fact.parquet")
    pq.write_table(fact, path, row_group_size=8192)
    dim = pa.table({"dk": pa.array(np.arange(N_DIM), type=pa.int32()),
                    "grp": pa.array((np.arange(N_DIM) % 13)
                                    .astype(np.int32))})
    return {"fact_path": path, "dim": dim}


Q_BENCH = """
SELECT d.grp, SUM(f.qty) AS s, COUNT(*) AS c, MIN(f.day) AS md,
       SUM(f.price) AS sp
FROM fact f JOIN dim d ON f.fk = d.dk
WHERE f.day < 2452500 AND f.flag
GROUP BY d.grp ORDER BY d.grp
"""


def _sessions(data, narrow, **kw):
    """(reference, port) with lanes on or off; encoded_exec off, as the
    reference's suite pins the lanes alone."""
    kw.setdefault("encoded_exec", False)
    kw.update(out_of_core_min_rows=10_000, chunk_rows=CHUNK,
              narrow_lanes=narrow)
    ref = RSession(RConfig(out_of_core=True, **kw))
    port = nt.Session(nt.EngineConfig(**kw), device="cpu")
    for s in (ref, port):
        s.register_parquet("fact", data["fact_path"])
        s.register_arrow("dim", data["dim"])
    return ref, port


def test_narrow_off_bit_identical_and_2x_bytes(bench_shape):
    """Lanes on and off give the reference's result bit for bit, and the
    packed morsels take at most half the bytes of the plain slot."""
    out = {}
    for narrow in (True, False):
        ref, port = _sessions(bench_shape, narrow)
        want = ref.sql(Q_BENCH, backend="jax")
        got = port.sql(Q_BENCH)
        assert table_mismatches(got, want) == []
        out[narrow] = (got, dict(port.last_stats), dict(ref.last_exec_stats))
    (on, st_on, rst_on), (off, st_off, _) = out[True], out[False]
    assert st_on["mode"] == st_off["mode"] == "streamed"
    assert table_mismatches(on, off) == []
    assert st_on["narrow_lanes"] and not st_off["narrow_lanes"]
    assert st_on["bytes_uploaded"] * 2 <= st_off["bytes_uploaded"]
    assert st_on["lane_spec"] == rst_on["lane_spec"]
    lanes = st_on["lane_spec"]["fact"]
    assert lanes["fk"] == "u16" and lanes["day"] == "u32"
    assert lanes["flag"] == "b1" and lanes["price"] == "f64"
    assert st_off["lane_spec"] == {}
    # a packed pass uploads its slot's wire bytes a morsel
    cap = tdevice.bucket(CHUNK)
    spec = st_on["lane_spec"]["fact"]
    assert st_on["bytes_uploaded"] == st_on["morsels"] * tdevice.lane_bytes(
        tuple(spec.values()), cap)
    assert table_mismatches(on, _sessions(bench_shape, True)[1].sql(
        Q_BENCH, backend="numpy")) == []


def test_live_toggle_invalidates_stream_cache(bench_shape):
    """narrow_lanes is part of the stream cache's key: a live toggle plans
    the groups, lanes, slots and programs again."""
    _ref, s = _sessions(bench_shape, True)
    a = s.sql(Q_BENCH)
    assert s.last_stats["narrow_lanes"]
    slot = s._stream_cache[Q_BENCH]["gstates"][0]["slot"]
    assert isinstance(slot.table, tdevice.PackedTable)
    s.config.narrow_lanes = False
    b = s.sql(Q_BENCH)
    assert not s.last_stats["narrow_lanes"]
    assert s.last_stats["lane_spec"] == {}
    assert isinstance(s._stream_cache[Q_BENCH]["gstates"][0]["slot"].table,
                      tdevice.DTable)
    assert slot._slot == []          # the packed slot was closed
    assert table_mismatches(a, b) == []


def test_lanes_static_across_skewed_morsels(tmp_path):
    """A group's lanes come from table-wide stats: a first morsel whose
    own range would fit a narrower lane still rides the table's lane (no
    change mid-stream, no re-record)."""
    n = 40_000
    vals = np.concatenate([np.zeros(n - 100, dtype=np.int64),
                           np.full(100, 60_000, dtype=np.int64)])
    t = pa.table({"k": pa.array(np.arange(n) % N_DIM, type=pa.int64()),
                  "v": pa.array(vals)})
    path = os.path.join(str(tmp_path), "skew.parquet")
    pq.write_table(t, path, row_group_size=8192)
    sql = "SELECT SUM(v) s, MAX(v) m, COUNT(*) c FROM skew"
    kw = dict(out_of_core_min_rows=10_000, chunk_rows=CHUNK)
    ref = RSession(RConfig(out_of_core=True, **kw))
    port = nt.Session(nt.EngineConfig(**kw), device="cpu")
    for s in (ref, port):
        s.register_parquet("skew", path)
    want = ref.sql(sql, backend="jax")
    got = port.sql(sql)
    st = port.last_stats
    assert st["mode"] == "streamed"
    assert st["lane_spec"] == ref.last_exec_stats["lane_spec"]
    assert st["enc_spec"] == ref.last_exec_stats.get("enc_spec")
    assert st["re_records"] == 0
    assert [tuple(r) for r in got.to_pylist()] == \
        [(100 * 60_000, 60_000, n)]
    assert table_mismatches(got, want) == []
    # without encodings the table-wide lane is u16, not the first
    # morsel's u8
    port.config.encoded_exec = False
    port.sql(sql)
    assert port.last_stats["lane_spec"]["skew"]["v"] == "u16"
    assert port.last_stats["re_records"] == 0


def test_stats_sources_arrow_and_parquet(tmp_path):
    t = pa.table({
        "i": pa.array([3, None, 999_999], type=pa.int64()),
        "d": pa.array([10_957, 11_000, 10_958], type=pa.date32()),
        "dec": pa.array([decimal.Decimal("1.25"), None,
                         decimal.Decimal("-3.50")],
                        type=pa.decimal128(10, 2)),
        "s": pa.array(["x", "y", "z"]),
    })
    path = os.path.join(str(tmp_path), "t.parquet")
    pq.write_table(t, path)
    ref = RSession(RConfig(decimal_physical="i64"))
    port = nt.Session(nt.EngineConfig(decimal_physical="i64"), device="cpu")
    for s in (ref, port):
        s.register_arrow("mem", t)
        s.register_parquet("disk", path)
    for name in ("mem", "disk"):
        st = port.column_stats(name)
        assert st == ref.column_stats(name)
        assert st["i"] == (3, 999_999)
        assert st["d"] == (10_957, 11_000)
        assert st["dec"] == (-350, 125)      # engine units: scaled ints
        assert "s" not in st
    # re-registration invalidates the cache; CSV has no stats source
    port.register_arrow("mem", t.slice(0, 1))
    assert port.column_stats("mem")["i"] == (3, 3)
    csv = os.path.join(str(tmp_path), "t.csv")
    with open(csv, "w") as f:
        f.write("1|2\n")
    port.register_csv("c", csv, pa.schema([("a", pa.int64()),
                                           ("b", pa.int64())]))
    assert port.column_stats("c") == {} and port.column_enc_stats("c") == {}


def _track_slots(monkeypatch) -> tuple:
    """Lists of the morsel slots made and closed from now on."""
    made, closed = [], []
    init, close = tdevice.MorselSlot.__init__, tdevice.MorselSlot.close

    def track_init(self, *a, **kw):
        made.append(self)
        init(self, *a, **kw)

    def track_close(self):
        closed.append(self)
        close(self)
    monkeypatch.setattr(tdevice.MorselSlot, "__init__", track_init)
    monkeypatch.setattr(tdevice.MorselSlot, "close", track_close)
    return made, closed


def test_lying_stats_raise_on_the_calling_thread_and_free_the_slot(
        bench_shape, monkeypatch):
    """Stats that say a column fits a narrower lane than its data need:
    the packing raises LaneOverflowError (never a wrap) on the caller's
    thread, and the group's slot is closed; the next run, with honest
    stats, is right."""
    _ref, s = _sessions(bench_shape, True)
    want = s.sql(Q_BENCH, backend="numpy")
    honest = s.column_stats("fact")
    s._col_stats["fact"] = dict(honest, fk=(0, 200))   # fk reaches 304
    made, closed = _track_slots(monkeypatch)
    with pytest.raises(tdevice.LaneOverflowError, match="'fk'"):
        s.sql(Q_BENCH)
    assert len(made) == 1 and closed == made
    gstate = s._stream_cache[Q_BENCH]["gstates"][0]
    assert gstate["slot"] is None and gstate["cqs"] is None
    s._col_stats["fact"] = honest
    s._drop_stream_cache()
    assert table_mismatches(s.sql(Q_BENCH), want) == []
    assert s.last_stats["lane_spec"]["fact"]["fk"] == "u16"
    assert s.last_stats["prefetch_error_details"] == []


def test_a_lane_overflow_on_the_staging_thread_is_reported(
        bench_shape, monkeypatch):
    """An overflow met by the staging thread (a later morsel) is recorded
    as a prefetch error, and raised on the calling thread when that
    morsel is staged again there; the slot is closed."""
    _ref, s = _sessions(bench_shape, True)
    real = tdevice.pack_into
    calls = []

    def pack_into(out, table, lanes, n, cap, encs=None, books=None):
        calls.append(n)
        if len(calls) >= 2:
            raise tdevice.LaneOverflowError("column 'qty' injected")
        return real(out, table, lanes, n, cap, encs, books)
    monkeypatch.setattr(tdevice, "pack_into", pack_into)
    made, closed = _track_slots(monkeypatch)
    with pytest.raises(tdevice.LaneOverflowError, match="injected"):
        s.sql(Q_BENCH)
    assert len(calls) == 3      # first morsel, staging thread, restage
    assert len(made) == 1 and closed == made


def test_dictionary_column_fast_path():
    vals = [f"cat{i}" for i in range(1000)]
    arr = pa.array(vals + [None, "cat0"]).dictionary_encode()
    chunked = pa.chunked_array([arr.slice(0, 500), arr.slice(500)])
    for a in (arr, chunked):
        col = arrow_bridge.from_arrow_column(a)
        assert col.dtype == "str"
        assert list(col.decode()) == vals + [None, "cat0"]
        assert col.data.dtype == np.int32
    plain = pa.array(["b", None, "a", "b"])
    col = arrow_bridge.from_arrow_column(plain)
    assert list(col.decode()) == ["b", None, "a", "b"]
