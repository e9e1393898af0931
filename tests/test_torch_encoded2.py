"""The port's encoded execution on the CPU, part 2: the streamed path
with encodings on and off (tests/test_encoded_exec.py's streamed cases),
held against nds_tpu on the same seeded data: a wide-range
low-cardinality join key and price (dictionary codes), a clustered day
(run lengths), a quantity already on u8, and a float.

- On and off give the reference's result bit for bit (floats to rtol
  1e-9), at fewer bytes; enc_spec and lane_spec are the reference's.
- Join keys and group keys stay on codes: the record pass decodes the
  aggregate arguments and group-sized outputs only.
- Literal compares and IN lists remap into code space, literals absent
  from the dictionary included; sorts ride the sorted codebook; a cold
  run (eager record) and the warm ones (replay) agree.
- encoded_exec is part of the stream cache's key; a group's codebooks go
  to the device once, when its slot is made, and leave with it.
- Stats that lie raise EncodingOverflowError on the calling thread and
  free the slot."""
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from nds_tpu.config import EngineConfig as RConfig
from nds_tpu.engine import Session as RSession

import nds_tpu_torch as nt
from nds_tpu_torch.engine.torch_backend import device as tdevice
from nds_tpu_torch.validate import table_mismatches
from torch_isolation import isolate_port_programs  # noqa: F401

N_FACT, N_DIM = 50_000, 300
CHUNK = 4_096


@pytest.fixture(scope="module")
def bench_shape(tmp_path_factory):
    """tests/test_encoded_exec.py's shape (seed 29)."""
    tmp = tmp_path_factory.mktemp("torch_encoded2")
    rng = np.random.default_rng(29)
    days = np.sort(rng.integers(2_450_000, 2_450_200, N_FACT))
    fk_domain = np.arange(0, 3_000_000, 9973)       # 301 wide-spread keys
    price_domain = np.arange(100, 3_000_000, 7919)  # 379 distinct prices
    qty = rng.integers(1, 100, N_FACT).astype(object)
    qty[rng.random(N_FACT) < 0.05] = None
    fact = pa.table({
        "fk": pa.array(rng.choice(fk_domain, N_FACT), type=pa.int64()),
        "qty": pa.array(list(qty), type=pa.int32()),
        "price": pa.array(rng.choice(price_domain, N_FACT),
                          type=pa.int64()),
        "day": pa.array(days, type=pa.int64()),
        "f": pa.array(np.round(rng.uniform(0, 10, N_FACT), 3)),
    })
    path = os.path.join(str(tmp), "fact.parquet")
    pq.write_table(fact, path, row_group_size=8192)
    dim = pa.table({"dk": pa.array(fk_domain, type=pa.int64()),
                    "grp": pa.array((np.arange(len(fk_domain)) % 13)
                                    .astype(np.int32))})
    return {"fact_path": path, "dim": dim}


Q_BENCH = """
SELECT d.grp, SUM(f.qty) AS s, COUNT(*) AS c, MIN(f.price) AS mp,
       MAX(f.day) AS md, SUM(f.f) AS sf
FROM fact f JOIN dim d ON f.fk = d.dk
WHERE f.day < 2450150 AND f.price > 5000
GROUP BY d.grp ORDER BY d.grp
"""


def _sessions(data, encoded, **kw):
    kw.update(out_of_core_min_rows=10_000, chunk_rows=CHUNK,
              encoded_exec=encoded)
    ref = RSession(RConfig(out_of_core=True, **kw))
    port = nt.Session(nt.EngineConfig(**kw), device="cpu")
    for s in (ref, port):
        s.register_parquet("fact", data["fact_path"])
        s.register_arrow("dim", data["dim"])
    return ref, port


@pytest.fixture(scope="module")
def pair(bench_shape):
    """(reference, port) with encodings on, and the same off."""
    return {True: _sessions(bench_shape, True),
            False: _sessions(bench_shape, False)}


def check(pair, sql: str, ref_off: bool = False) -> list:
    """`sql` through the port with encodings on (cold, which records
    eagerly, then warm, which replays) and off: every run equals the
    reference's result with encodings on (and off, where `ref_off`), and
    the port's layout is the reference's. Returns the port's stats [on,
    off] of their last runs."""
    ref, port = pair[True]
    want = ref.sql(sql, backend="jax")
    out = []
    for encoded, runs in ((True, 2), (False, 1)):
        port = pair[encoded][1]
        for _ in range(runs):
            got = port.sql(sql)
            assert table_mismatches(got, want) == [], (sql, encoded)
        st = dict(port.last_stats)
        assert st["mode"] == "streamed"
        assert st["re_records"] == 0
        out.append(st)
    rst = [dict(ref.last_exec_stats)]
    if ref_off:
        roff = pair[False][0]
        assert table_mismatches(got, roff.sql(sql, backend="jax")) == []
        rst.append(dict(roff.last_exec_stats))
    for st, r in zip(out, rst):
        assert st["lane_spec"] == r["lane_spec"]
        assert st["enc_spec"] == r.get("enc_spec")
    return out


def test_encoded_off_bit_identical_and_bytes(pair):
    st_on, st_off = check(pair, Q_BENCH, ref_off=True)
    assert st_on["encoded_exec"] and not st_off["encoded_exec"]
    assert st_on["bytes_uploaded"] * 1.5 <= st_off["bytes_uploaded"]
    spec = st_on["enc_spec"]["fact"]
    assert spec["fk"].startswith("dict[") and spec["price"].startswith(
        "dict[")
    assert spec["day"].startswith("rle[")
    assert spec["qty"] == "plain" and spec["f"] == "plain"
    assert st_on["lane_spec"]["fact"]["fk"] == "u16"   # the code lane
    assert st_on["enc_bytes_saved"] > 0
    assert st_on["enc_bytes_saved"] == st_off["bytes_uploaded"] - \
        st_on["bytes_uploaded"]
    assert st_off["enc_spec"] is None and st_off["enc_bytes_saved"] is None
    assert st_on["host_decode_ms"]["fact"] > 0


def test_join_and_groupby_run_on_codes(bench_shape):
    """The dictionary-coded join key (fk) and the run-length day filter
    never decode: each execution of the morsel program decodes one
    column at morsel scale, MIN(price)'s argument. A cold pass executes
    it once a morsel and once more for the record on the first one (on
    the CPU a replay runs the plan; on the card a graph replay runs no
    Python and decodes nothing)."""
    _ref, s = _sessions(bench_shape, True)
    s.sql(Q_BENCH)
    st = s.last_stats
    assert st["decode_sites"] == st["morsels"] + 1
    assert st["decode_rows"] == (st["morsels"] + 1) * CHUNK
    assert st["dict_uploads"] == 2      # fk and price, by the slot


def test_filter_literal_remap(pair):
    """Literal compares and IN lists on coded columns remap into code
    space, literals absent from the dictionary included (eq -> empty, ne
    -> every valid row, ranges -> the boundary)."""
    queries = [
        "SELECT COUNT(*) c FROM fact WHERE fk = 69811",     # 9973 * 7
        "SELECT COUNT(*) c FROM fact WHERE fk = 9974",      # absent
        "SELECT COUNT(*) c FROM fact WHERE fk <> 9974",
        "SELECT COUNT(*) c FROM fact WHERE 69811 <= fk AND fk < 99730",
        "SELECT COUNT(*) c FROM fact WHERE price > 5000 AND price <= 100000",
        "SELECT COUNT(*) c FROM fact WHERE fk IN (69811, 9974, 19946)",
        "SELECT COUNT(*) c FROM fact WHERE fk IN (9974, 1)",
        "SELECT COUNT(*) c, SUM(qty) s FROM fact WHERE day >= 2450100",
    ]
    for q in queries:
        check(pair, q)
        assert table_mismatches(pair[True][1].sql(q),
                                pair[True][1].sql(q, backend="numpy")) == []


def test_sort_rides_order_preserving_dictionary(pair):
    q = ("SELECT price, COUNT(*) c FROM fact WHERE day < 2450100 "
         "GROUP BY price ORDER BY price DESC LIMIT 50")
    check(pair, q)
    assert pair[True][1].sql(q).num_rows == 50


def test_live_toggle_invalidates_stream_cache(bench_shape):
    _ref, s = _sessions(bench_shape, True)
    a = s.sql(Q_BENCH)
    assert s.last_stats["enc_spec"]
    s.config.encoded_exec = False
    b = s.sql(Q_BENCH)
    assert s.last_stats["enc_spec"] is None
    assert s.last_stats["lane_spec"]["fact"]["fk"] == "u32"
    assert table_mismatches(a, b) == []


def test_codebooks_upload_once_per_group(bench_shape):
    """A group's codebooks go to the device when its slot is made (one
    upload each), every decode and join remap of every morsel and run
    finds them there, and they leave with the slot."""
    _ref, s = _sessions(bench_shape, True)
    before = tdevice.decode_stats()
    s.sql(Q_BENCH)
    s.sql(Q_BENCH)
    after = tdevice.decode_stats()
    group = s._stream_cache[Q_BENCH]["groups"][0]
    books = [b for b in group.codebooks if b is not None]
    assert len(books) == 2      # fk, price
    assert after["book_uploads"] - before["book_uploads"] == len(books)
    assert s.last_stats["dict_uploads"] == 0
    assert after["book_reuses"] > before["book_reuses"]
    slot = s._stream_cache[Q_BENCH]["gstates"][0]["slot"]
    assert all((id(b), "cpu") in tdevice._BOOK_CACHE for b in books)
    slot.close()
    assert not any((id(b), "cpu") in tdevice._BOOK_CACHE for b in books)


_SHAPES = [
    ("scalar_subquery",
     "SELECT COUNT(*) c FROM fact WHERE price > "
     "(SELECT AVG(price) FROM fact)"),
    ("semi_join",
     "SELECT COUNT(*) c FROM dim d WHERE d.dk IN "
     "(SELECT f.fk FROM fact f WHERE f.day < 2450100)"),
    ("case_over_encoded",
     "SELECT SUM(CASE WHEN price > 100000 THEN qty ELSE 0 END) s, "
     "MIN(day) md FROM fact"),
    ("group_by_encoded_key",
     "SELECT price, COUNT(*) c FROM fact GROUP BY price "
     "ORDER BY c DESC, price LIMIT 20"),
    ("arith_on_encoded",
     "SELECT SUM(price * qty) s, AVG(price) a FROM fact "
     "WHERE day BETWEEN 2450050 AND 2450150"),
    ("rollup_on_codes",
     "SELECT d.grp, f.price, SUM(f.qty) s FROM fact f JOIN dim d "
     "ON f.fk = d.dk WHERE f.price < 60000 "
     "GROUP BY ROLLUP(d.grp, f.price) ORDER BY d.grp, f.price"),
]


@pytest.mark.parametrize("name,q", _SHAPES, ids=[s[0] for s in _SHAPES])
def test_shape_differentials(pair, name, q):
    check(pair, q)


def test_lying_enc_stats_raise_and_free_the_slot(bench_shape, monkeypatch):
    """A dictionary that misses values of the data (stats drift): packing
    raises EncodingOverflowError on the calling thread, never a wrong
    morsel, and the slot is closed."""
    _ref, s = _sessions(bench_shape, True)
    est = s.column_enc_stats("fact", ["fk"])["fk"]
    s._enc_stats["fact"]["fk"] = dict(est, distinct=est["distinct"][:-3])
    closed = []
    close = tdevice.MorselSlot.close

    def track(self):
        closed.append(self)
        close(self)
    monkeypatch.setattr(tdevice.MorselSlot, "close", track)
    with pytest.raises(tdevice.EncodingOverflowError, match="'fk'"):
        s.sql(Q_BENCH)
    assert len(closed) == 1
    assert s._stream_cache[Q_BENCH]["gstates"][0]["slot"] is None
