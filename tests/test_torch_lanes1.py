"""The port's narrow-lane packed layout on the CPU, part 1: packing and
unpacking (nds_tpu_torch.engine.torch_backend.device), held against
nds_tpu's jax_backend.device on the same seeded inputs.

The cases of tests/test_narrow_lanes.py and tests/test_streaming.py's
test_pack_table_roundtrip: the host payload is byte for byte the
reference's (``_pack_payload``), and ``unpack_table`` gives the columns
``to_device`` gives for the same table. Beside them: lane planning and
byte accounting as the reference's, out-of-range values rejected, the
byte-view alignment every section keeps, and a SUM over a u32 and a u16
lane that passes 2^31 (the int32 lane widens before it sums)."""
import numpy as np
import pyarrow as pa
import pytest
import torch

from nds_tpu.engine import arrow_bridge as rbridge
from nds_tpu.engine.jax_backend import device as rdevice

import nds_tpu_torch as nt
from nds_tpu_torch.engine import arrow_bridge
from nds_tpu_torch.engine.torch_backend import device as tdevice
from nds_tpu_torch.validate import table_mismatches
from torch_lanes_inputs import assert_roundtrip, tables, validity
from torch_isolation import isolate_port_programs  # noqa: F401

CAP = 1024


_CASES = [
    # (name, dtype, value range, stats, expected lane): the reference's
    ("int_u8", "int", (0, 255), (0, 255), "u8"),
    ("int_u16", "int", (0, 60_000), (0, 65_535), "u16"),
    ("int_u32", "int", (0, 2 ** 30), (0, 2 ** 31 - 1), "u32"),
    ("int_i32_neg", "int", (-1000, 1000), (-1000, 1000), "i32"),
    ("int_i64", "int", (-2 ** 40, 2 ** 40), (-2 ** 40, 2 ** 40), "i64"),
    ("dec2_u16", "dec2", (0, 50_000), (0, 65_535), "u16"),
    ("dec2_i64", "dec2", (-10 ** 12, 10 ** 12), (-10 ** 12, 10 ** 12),
     "i64"),
    ("date_u16", "date", (0, 40_000), (0, 40_000), "u16"),
    ("date_i32", "date", (0, 80_000), (0, 80_000), "i32"),
]


@pytest.mark.parametrize("pattern", ["none_null", "mixed", "all_null"])
@pytest.mark.parametrize("name,dtype,rng_range,stats,want_lane",
                         _CASES, ids=[c[0] for c in _CASES])
def test_roundtrip_int_family(name, dtype, rng_range, stats, want_lane,
                              pattern):
    rng = np.random.default_rng(sum(map(ord, name + pattern)))
    n = 700
    data = rng.integers(rng_range[0], rng_range[1] + 1, n)
    valid = validity(pattern, n, rng)
    port, ref = tables([name], [(dtype, data, valid, None)])
    lanes = tdevice.plan_lanes([dtype], [stats])
    assert lanes == rdevice.plan_lanes([dtype], [stats]) == (want_lane,)
    packed = assert_roundtrip(port, ref, lanes)
    col = tdevice.unpack_table(packed).cols[0]
    # narrow lanes come up as int32, i64 as int64
    assert col.data.dtype == (torch.int64 if want_lane == "i64"
                              else torch.int32)


@pytest.mark.parametrize("pattern", ["none_null", "mixed", "all_null"])
def test_roundtrip_float_bool_str(pattern):
    rng = np.random.default_rng(sum(map(ord, pattern)))
    n = 700
    # every code of a full u8-sized dictionary occurs
    dict256 = np.asarray([f"v{i}" for i in range(256)], dtype=object)
    codes = rng.integers(0, 256, n).astype(np.int32)
    codes[:256] = np.arange(256)
    valid = validity(pattern, n, rng)
    port, ref = tables(["f", "b", "s"], [
        ("float", rng.normal(size=n), valid, None),
        ("bool", rng.integers(0, 2, n).astype(bool), valid, None),
        ("str", codes, valid, dict256)])
    lanes = tdevice.plan_lanes(["float", "bool", "str"], [None] * 3,
                               dict_sizes=[None, None, 256])
    assert lanes == ("f64", "b1", "u8")
    packed = assert_roundtrip(port, ref, lanes)
    got = tdevice.to_host(tdevice.unpack_table(packed))
    want = tdevice.to_host(tdevice.to_device(port, "cpu", CAP))
    assert list(got.columns[2].decode()) == list(want.columns[2].decode())


def test_pack_table_roundtrip():
    """tests/test_streaming.py's case: nulls, f64, int32 widening, dates
    and the alive mask, on the wide layout (pack_table's default) and on
    the narrow lanes of the same table's stats."""
    rng = np.random.default_rng(4)
    n = 1000
    arrow = pa.table({
        "i": pa.array([None if k % 13 == 0 else int(v) for k, v in
                       enumerate(rng.integers(-5, 5, n))], type=pa.int64()),
        "f": pa.array(rng.normal(size=n)),
        "d": pa.array(rng.integers(0, 30, n), type=pa.int32()),
        "dt": pa.array([None if k % 17 == 0 else int(v) for k, v in
                        enumerate(rng.integers(10000, 11000, n))],
                       type=pa.date32()),
    })
    port = arrow_bridge.from_arrow(arrow, dec_as_int=True)
    ref = rbridge.from_arrow(arrow, dec_as_int=True)
    wide = tdevice.plan_lanes([c.dtype for c in port.columns], narrow=False)
    assert wide == ("i64", "f64", "i64", "i32")
    assert_roundtrip(port, ref, wide, cap=2048)
    default = tdevice.pack_table(port, "cpu", 2048)
    assert default.lanes == wide
    stats = arrow_bridge.table_column_stats(arrow, True)
    narrow = tdevice.plan_lanes([c.dtype for c in port.columns],
                                [stats.get(c) for c in arrow.column_names])
    assert narrow == ("i32", "f64", "u8", "u16")
    assert_roundtrip(port, ref, narrow, cap=2048)


def test_narrow_lanes_reject_out_of_range_values():
    """Negative or oversized values reject a narrow lane loudly, as in
    the reference: a silent wrap would alias unrelated rows."""
    for data, lane in (([-3, 1, 2], "u8"), ([0, 70_000], "u16"),
                       ([0, 2 ** 31], "u32"), ([-2 ** 31, 0], "i32")):
        port, ref = tables(["x"], [("int", np.asarray(data), None, None)])
        with pytest.raises(tdevice.LaneOverflowError):
            tdevice.pack_table(port, "cpu", 8, (lane,))
        with pytest.raises(rdevice.LaneOverflowError):
            rdevice.pack_table(ref, capacity=8, lanes=(lane,))
    port, _ = tables(["x"], [("float", np.asarray([0.5]), None, None)])
    with pytest.raises(tdevice.LaneOverflowError):
        tdevice.pack_table(port, "cpu", 8, ("u8",))


def test_lane_planning_rules():
    """plan_lanes, lane_legal and the lane tables equal the reference's
    x64 tier."""
    cases = [(["int"], [(-5, 5)]), (["int"], [(0, 200)]),
             (["int"], [(0, 2 ** 31 - 1)]), (["int"], [(0, 2 ** 31)]),
             (["int"], [None]), (["date"], [None]), (["date"], [(0, 900)]),
             (["dec2"], [(-10, 10 ** 10)]), (["float", "bool", "str"], None)]
    for dtypes, stats in cases:
        assert tdevice.plan_lanes(dtypes, stats) == \
            rdevice.plan_lanes(dtypes, stats)
    assert tdevice.plan_lanes(["int"], [(-5, 5)]) == ("i32",)
    assert tdevice.plan_lanes(["int"], [(0, 2 ** 31)]) == ("i64",)
    assert tdevice.plan_lanes(["int", "date", "float"], narrow=False) == \
        ("i64", "i32", "f64")
    assert tdevice.plan_lanes(["bool"], narrow=False) is None
    assert tdevice.plan_lanes(["str"], narrow=False) is None
    assert tdevice.plan_lanes(["str"], dict_sizes=[70_000]) == ("i32",)
    for lane in tdevice._LANE_WIRE:
        for dt in ("int", "dec2", "date", "str", "bool", "float"):
            assert tdevice.lane_legal(lane, dt) == \
                rdevice.lane_legal(lane, dt)
    assert tdevice._LANE_WIRE == rdevice._LANE_WIRE
    assert tdevice._LANE_BOUNDS == rdevice._LANE_BOUNDS


def test_packed_bytes_accounting():
    port, ref = tables(["a", "b"], [
        ("int", np.arange(100), None, None),
        ("bool", np.zeros(100, dtype=bool), None, None)])
    lanes = tdevice.plan_lanes(["int", "bool"], [(0, 99), None])
    packed = assert_roundtrip(port, ref, lanes, cap=128)
    # u8 data (128) + b1 data (16) + 3 bit-packed masks (16 each)
    assert tdevice.device_bytes(packed) == tdevice.lane_bytes(lanes, 128) \
        == rdevice.lane_bytes(lanes, 128) == 128 + 16 + 48


@pytest.mark.parametrize("cap", [64, 4096, 6144, 1 << 22])
def test_every_section_starts_aligned(cap):
    """Byte views need each section to start at a multiple of its lane's
    width. Every data section is a multiple of 8 bytes long when the
    capacity is a multiple of 64 (a b1 section is cap/8 bytes, an RLE
    section's run capacity a multiple of 8), so every section starts
    aligned; a slot's capacity is one. An unaligned section raises, and a
    view is never a copy."""
    lanes = ("u8", "b1", "u16", "i64", "u16", "u32", "i32", "f64")
    encs = ("plain", "plain", ("rle", 3), "plain", ("dict", 300),
            ("rle", 5), "plain", "plain")
    off = 0
    for lane, enc in zip(lanes, encs):
        if lane != "b1":
            assert off % tdevice._LANE_WIRE[lane] == 0
        if isinstance(enc, tuple) and enc[0] == "rle":
            rc = tdevice._runs_cap(enc[1], cap)
            assert (off + tdevice._LANE_WIRE[lane] * rc) % 4 == 0
        off += tdevice.enc_rows_bytes(lane, enc, cap)
        assert off % 8 == 0
    buf = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(AssertionError, match="not aligned"):
        tdevice._unpack_lane(buf[2:34], "i64", 4)
    assert tdevice._unpack_lane(buf[8:40], "i64", 4).data_ptr() == \
        buf.data_ptr() + 8     # a view, not a copy
    # at a capacity of 8 a bool column's section is one byte: the next
    # wide lane would start unaligned, so a packed slot refuses it
    with pytest.raises(ValueError, match="multiple of 64"):
        tdevice.MorselSlot(["b", "x"], ["bool", "int"], 8, "cpu",
                           lanes=("b1", "i64"))


@pytest.mark.parametrize("encoded", [False, True])
@pytest.mark.parametrize("lane,value,n,groups", [
    ("u32", 2 ** 31 - 1, 9000, 2), ("u16", 65_535, 40_000, 1)])
def test_sum_over_a_narrow_lane_passes_int32(lane, value, n, groups,
                                             encoded):
    """A SUM whose total passes 2^31 over a column on a u32 or u16 lane
    (int32 on the card), or on its dictionary codes (an int32 codebook),
    widens before it sums: grouped (the sorted aggregation: a morsel of
    at least 8,192 rows, each group's total past 2^31), global, and AVG,
    each run cold (record) and warm (replay),
    equal to nds_tpu's numpy result; the lanes and encodings are the
    ones nds_tpu plans from the same stats."""
    from nds_tpu.config import EngineConfig as RConfig
    from nds_tpu.engine import Session as RSession

    rng = np.random.default_rng(7)
    vals = rng.integers(value - 5, value + 1, n)
    t = pa.table({"k": pa.array(rng.integers(0, groups, n),
                                type=pa.int64()),
                  "v": pa.array(vals, type=pa.int64())})
    assert min(vals[t.column("k").to_numpy() == g].sum()
               for g in range(groups)) > 2 ** 31
    kw = dict(out_of_core_min_rows=1000, chunk_rows=n, encoded_exec=encoded)
    port = nt.Session(nt.EngineConfig(**kw), device="cpu")
    ref = RSession(RConfig(out_of_core=True, **kw))
    for s in (port, ref):
        s.register_arrow("t", t)
    rlanes = rdevice.plan_lanes(["int", "int"], [ref.column_stats("t")[c]
                                                 for c in ("k", "v")])
    est = ref.column_enc_stats("t", ["k", "v"])
    rplanned = rdevice.plan_encodings(["int", "int"], rlanes,
                                      [est["k"], est["v"]],
                                      rdevice.bucket(n)) if encoded else None
    for q in ("SELECT k, SUM(v) s, AVG(v) a, MIN(v) lo, COUNT(*) c FROM t "
              "GROUP BY k ORDER BY k",
              "SELECT SUM(v) s, MAX(v) hi FROM t WHERE k >= 0"):
        want = ref.sql(q, backend="numpy")
        for _run in range(2):
            got = port.sql(q)
            assert table_mismatches(got, want) == []
        st = port.last_stats
        assert st["mode"] == "streamed"
        if rplanned is None:
            assert st["enc_spec"] is None
            assert st["lane_spec"]["t"] == dict(zip(("k", "v"), rlanes))
            assert st["lane_spec"]["t"]["v"] == lane
        else:
            assert st["lane_spec"]["t"] == dict(zip(("k", "v"),
                                                    rplanned[1]))
            assert st["enc_spec"]["t"]["v"] == "dict[6]"
