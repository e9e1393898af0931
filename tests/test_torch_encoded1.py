"""The port's encoded execution on the CPU, part 1: dictionary and
run-length sections of the packed layout (nds_tpu_torch.engine.
torch_backend.device), held against nds_tpu's jax_backend.device on the
same seeded inputs.

The cases of tests/test_encoded_exec.py: dict and RLE round trips over
dtypes and validity patterns (payload byte for byte the reference's,
unpacked columns equal to to_device's), overflow rejection, the
plan_encodings policy and its byte accounting; beside them, decode_col,
encode_against and widen_col on the device columns, and a program's key
holding its scans' layout (codebook identity included)."""
import numpy as np
import pytest
import torch

from nds_tpu.engine import arrow_bridge as rbridge
from nds_tpu.engine.jax_backend import device as rdevice

from nds_tpu_torch.engine import arrow_bridge
from nds_tpu_torch.engine.torch_backend import device as tdevice
from torch_lanes_inputs import assert_roundtrip, tables, validity
from torch_isolation import isolate_port_programs  # noqa: F401

CAP = 1024

# (name, dtype, value domain, expected encoding): the reference's
_DICT_CASES = [
    ("int_wide_lowcard", "int", np.arange(0, 3_000_000, 9973), "dict"),
    ("dec2_lowcard", "dec2", np.arange(-500_000, 500_000, 7919), "dict"),
    ("date_lowcard", "date", np.arange(2_450_000, 2_453_000, 7), "dict"),
    ("int_single_value", "int", np.asarray([1_234_567]), "dict"),
    # the most values a u8 code lane holds: exactly 256
    ("int_u8_boundary", "int", np.arange(0, 256_000, 1000), "dict"),
]


@pytest.mark.parametrize("pattern", ["none_null", "mixed", "all_null"])
@pytest.mark.parametrize("name,dtype,domain,kind", _DICT_CASES,
                         ids=[c[0] for c in _DICT_CASES])
def test_roundtrip_dict(name, dtype, domain, kind, pattern):
    rng = np.random.default_rng(sum(map(ord, name + pattern)))
    n = 700
    data = rng.choice(domain, n)
    valid = validity(pattern, n, rng)
    port, ref = tables([name], [(dtype, data, valid, None)])
    lanes = tdevice.plan_lanes([dtype], [(int(domain.min()),
                                          int(domain.max()))])
    st = arrow_bridge.column_enc_stat_values(
        np.asarray(port.columns[0].data), port.columns[0].validity)
    st["runs"] = None    # the dict candidate alone
    planned = tdevice.plan_encodings([dtype], lanes, [st], CAP)
    rplanned = rdevice.plan_encodings([dtype], lanes, [st], CAP)
    encs, wire, books = planned
    assert (encs, wire) == rplanned[:2]
    np.testing.assert_array_equal(books[0], rplanned[2][0])
    assert books[0].dtype == rplanned[2][0].dtype
    assert encs[0][0] == kind
    packed = assert_roundtrip(port, ref, wire, encs, books, CAP)
    col = tdevice.unpack_table(packed).cols[0]
    assert col.codebook is books[0] and col.data.dtype == torch.int32


@pytest.mark.parametrize("pattern", ["none_null", "mixed", "all_null"])
@pytest.mark.parametrize("shape", ["sorted_runs", "single_run", "run_len_1"])
def test_roundtrip_rle(shape, pattern):
    rng = np.random.default_rng(sum(map(ord, shape + pattern)))
    n = 700
    if shape == "sorted_runs":
        data = np.sort(rng.integers(0, 40, n)) * 1_000_003
    elif shape == "single_run":
        data = np.full(n, 77)
    else:  # every row its own run (the worst case, still exact)
        data = np.arange(n) * 3 + 1
    valid = validity(pattern, n, rng)
    port, ref = tables(["r"], [("int", data, valid, None)])
    lanes = tdevice.plan_lanes(["int"], [(int(data.min()), int(data.max()))])
    st = arrow_bridge.column_enc_stat_values(
        np.asarray(port.columns[0].data), port.columns[0].validity)
    encs = (("rle", st["runs"]),)
    packed = assert_roundtrip(port, ref, lanes, encs, (None,), CAP)
    assert tdevice.unpack_table(packed).cols[0].codebook is None


def test_encoding_overflow_rejects():
    """Data breaking their encoding fail loudly, as in the reference: a
    value outside the dictionary, or more runs than planned."""
    book = np.asarray([10, 20, 30], dtype=np.int32)
    port, ref = tables(["x"], [("int", np.asarray([10, 25]), None, None)])
    with pytest.raises(tdevice.EncodingOverflowError, match="25"):
        tdevice.pack_table(port, "cpu", 8, ("u8",), (("dict", 3),), (book,))
    with pytest.raises(rdevice.EncodingOverflowError):
        rdevice.pack_table(ref, capacity=8, lanes=("u8",),
                           encs=(("dict", 3),), codebooks=(book,))
    # nulls ride code 0 without being dictionary members
    port, ref = tables(["x"], [("int", np.asarray([10, 99]),
                                np.asarray([True, False]), None)])
    assert_roundtrip(port, ref, ("u8",), (("dict", 3),), (book,), 8)
    port, _ = tables(["x"], [("int", np.arange(100) % 7, None, None)])
    with pytest.raises(tdevice.EncodingOverflowError, match="runs"):
        tdevice.pack_table(port, "cpu", 128, ("u8",), (("rle", 4),),
                           (None,))


def test_plan_encodings_selection():
    """The reference's policy: dict only where the code lane is narrower
    than the value lane, rle only on a 2x win, plain otherwise; no stats,
    no encoding."""
    st = {"distinct": np.arange(0, 3_000_000, 9973), "runs": None}
    cases = [(["int"], ("u32",), [st]),
             (["int"], ("u8",), [{"distinct": np.arange(200), "runs": None}]),
             (["int"], ("u32",), [{"distinct": None, "runs": 50}]),
             (["int"], ("u32",), [{"distinct": None, "runs": 4096}]),
             (["int"], ("u32",), [None]),
             (["float"], ("f64",), [{"distinct": np.arange(3), "runs": 1}]),
             (["int", "date"], ("i64", "i32"),
              [{"distinct": np.arange(70_000), "runs": 9},
               {"distinct": np.arange(300), "runs": 4000}])]
    for dtypes, lanes, stats in cases:
        got = tdevice.plan_encodings(dtypes, lanes, stats, 4096)
        want = rdevice.plan_encodings(dtypes, lanes, stats, 4096)
        if want is None:
            assert got is None
            continue
        assert got[:2] == want[:2]
        for a, b in zip(got[2], want[2]):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
    encs, wlanes, books = tdevice.plan_encodings(["int"], ("u32",), [st],
                                                 4096)
    assert encs[0][0] == "dict" and wlanes == ("u16",)
    port, _ = tables(["x"], [("int", st["distinct"][:100], None, None)])
    p = tdevice.pack_table(port, "cpu", 4096, wlanes, encs, books)
    assert tdevice.device_bytes(p) == tdevice.enc_lane_bytes(
        wlanes, 4096, encs) == rdevice.enc_lane_bytes(wlanes, 4096, encs) \
        < tdevice.lane_bytes(("u32",), 4096)
    assert [tdevice.enc_tag(e) for e in (("dict", 300), ("rle", 40),
                                         "plain")] == \
        ["dict[300]", "rle[40]", "plain"]


def test_enc_stats_match_the_reference():
    """arrow_bridge.column_enc_stat (the port's copy) gives the
    reference's stats on the same column."""
    import pyarrow as pa
    arr = pa.array([5, 5, None, 900_000, 5], type=pa.int64())
    got = arrow_bridge.column_enc_stat(arr)
    want = rbridge.column_enc_stat(arr)
    assert got["runs"] == want["runs"] == 4
    np.testing.assert_array_equal(got["distinct"], want["distinct"])


def test_enc_stats_sources(tmp_path):
    """Session.column_enc_stats from Arrow tables and Parquet files
    equals the reference's, per column, and a re-registration drops the
    cache."""
    import decimal
    import os

    import pyarrow as pa
    import pyarrow.parquet as pq

    from nds_tpu.config import EngineConfig as RConfig
    from nds_tpu.engine import Session as RSession

    import nds_tpu_torch as nt
    t = pa.table({
        "i": pa.array([5, 5, None, 900_000, 5], type=pa.int64()),
        "d": pa.array([10_957, 10_957, 10_958, 10_958, 10_958],
                      type=pa.date32()),
        "dec": pa.array([decimal.Decimal("1.25")] * 5,
                        type=pa.decimal128(10, 2)),
        "s": pa.array(["x"] * 5),
    })
    path = os.path.join(str(tmp_path), "t.parquet")
    pq.write_table(t, path)
    ref = RSession(RConfig(decimal_physical="i64"))
    port = nt.Session(nt.EngineConfig(decimal_physical="i64"), device="cpu")
    for s in (ref, port):
        s.register_arrow("mem", t)
        s.register_parquet("disk", path)
    cols = ["i", "d", "dec", "s"]
    for name in ("mem", "disk"):
        got = port.column_enc_stats(name, cols)
        want = ref.column_enc_stats(name, cols)
        assert sorted(got) == sorted(want) == ["d", "dec", "i"]
        for c in got:
            assert got[c]["runs"] == want[c]["runs"]
            np.testing.assert_array_equal(got[c]["distinct"],
                                          want[c]["distinct"])
        assert list(got["i"]["distinct"]) == [5, 900_000]
        assert got["i"]["runs"] == 4 and got["d"]["runs"] == 2
    port.register_arrow("mem", t.slice(0, 2))
    assert list(port.column_enc_stats("mem", ["i"])["i"]["distinct"]) == [5]


def _dcol(vals, valid=None, book=None):
    data = torch.as_tensor(np.asarray(vals))
    v = torch.ones(len(data), dtype=torch.bool) if valid is None \
        else torch.as_tensor(np.asarray(valid))
    return tdevice.DCol("int", data, v, None, codebook=book)


def test_decode_encode_and_widen():
    """decode_col gathers through the codebook (clamped, nulls canonical
    zero) and counts its site; encode_against puts a plain column into a
    code space (-1 where absent); widen_col decodes and widens int32."""
    book = np.asarray([3, 70_000, 2 ** 31 - 1], dtype=np.int32)
    before = tdevice.decode_stats()
    c = _dcol(np.asarray([2, 0, 1, 7], dtype=np.int32),
              [True, True, False, True], book)
    d = tdevice.decode_col(c)
    assert d.codebook is None
    assert d.data.tolist() == [2 ** 31 - 1, 3, 0, 2 ** 31 - 1]   # clamped
    after = tdevice.decode_stats()
    assert after["sites"] == before["sites"] + 1
    assert after["rows"] == before["rows"] + 4
    plain = _dcol(np.asarray([70_000, 5, 3, 2 ** 40], dtype=np.int64),
                  [True, True, True, False])
    assert tdevice.encode_against(book, plain).tolist() == [1, -1, 0, -1]
    w = tdevice.widen_col(c)
    assert w.data.dtype == torch.int64 and w.codebook is None
    assert int(w.data.sum()) == 2 * (2 ** 31 - 1) + 3
    narrow = _dcol(np.asarray([2 ** 31 - 1] * 3, dtype=np.int32))
    assert tdevice.widen_col(narrow).data.sum().item() == 3 * (2 ** 31 - 1)
    assert tdevice.decode_col(narrow) is narrow


def test_a_program_key_holds_the_scan_layout():
    """Lanes and encodings are morsel ScanNode fields, so the plan
    fingerprint holds them; the codebooks' identity joins the shared
    registry's key (shared_fingerprint) and binds a compiled program,
    which raises ReplayMismatch over another layout (then the caller
    records again)."""
    import nds_tpu_torch as nt
    from nds_tpu_torch.engine.plan import ScanNode
    from nds_tpu_torch.engine.streaming import MORSEL_TABLE
    from nds_tpu_torch.engine.torch_backend import compiled

    scan = ScanNode(MORSEL_TABLE, ["a"], out_names=["a"], out_dtypes=["int"])
    fps = {compiled.plan_fingerprint(scan)}
    for lanes, encs in ((("u8",), None), (("u16",), None),
                        (("u8",), (("dict", 3),))):
        fps.add(compiled.plan_fingerprint(
            ScanNode(MORSEL_TABLE, ["a"], lanes=lanes, encodings=encs,
                     out_names=["a"], out_dtypes=["int"])))
    assert len(fps) == 4
    b1 = np.asarray([1, 2, 3], dtype=np.int32)
    b2 = b1.copy()
    port, _ = tables(["a"], [("int", np.asarray([1, 2, 3, 2]), None, None)])
    packs = [tdevice.pack_table(port, "cpu", 64, ("u8",), (("dict", 3),),
                                (b,)) for b in (b1, b2)]
    lay = [tdevice.scan_layout(p) for p in packs]
    assert lay[0] != lay[1] and tdevice.scan_layout(
        tdevice.unpack_table(packs[0])) is None
    ops = frozenset({"sort"})
    assert compiled.shared_fingerprint(scan, ops, (lay[0],)) != \
        compiled.shared_fingerprint(scan, ops, (lay[1],))
    assert compiled.shared_fingerprint(scan, ops) == \
        compiled.shared_fingerprint(scan, ops, (None,))
    # a program recorded over one layout does not replay another
    s = nt.Session(nt.EngineConfig(), device="cpu")
    ex = s._new_executor(jit_plans=True)
    key = MORSEL_TABLE + "//a"
    plan = ScanNode(MORSEL_TABLE, ["a"], lanes=("u8",),
                    encodings=(("dict", 3),), out_names=["a"],
                    out_dtypes=["int"])
    ex._scan_cache[key] = packs[0]
    out, dec, keys = ex.record_plan(plan)
    cq = compiled.CompiledQuery(plan, dec, keys, ex)
    got = cq.run({key: packs[0]})
    assert tdevice.to_host(got).columns[0].data.tolist() == [1, 2, 3, 2]
    with pytest.raises(compiled.ReplayMismatch, match="layout"):
        cq.run({key: packs[1]})
