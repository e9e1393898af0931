"""Shared inputs and checks of the port's packed-layout tests
(tests/test_torch_lanes*.py, tests/test_torch_encoded*.py): the same
columns as a port Table and an nds_tpu Table, and the round trip that
holds the port's packing to the reference's."""
import numpy as np

from nds_tpu.engine.column import Column as RColumn
from nds_tpu.engine.column import Table as RTable
from nds_tpu.engine.jax_backend import device as rdevice

from nds_tpu_torch.engine.column import Column, Table
from nds_tpu_torch.engine.torch_backend import device as tdevice

CAP = 1024


def validity(pattern, n, rng):
    if pattern == "none_null":
        return None
    if pattern == "all_null":
        return np.zeros(n, dtype=bool)
    return rng.random(n) < 0.7


def tables(names, cols) -> tuple:
    """The same columns as a port Table and a reference Table:
    [(dtype, data, valid, dictionary)]."""
    port = Table(list(names), [
        Column.from_values(d, np.asarray(x), v, dc) if dc is None
        else Column(d, np.asarray(x), v, dc) for d, x, v, dc in cols])
    ref = RTable(list(names), [
        RColumn.from_values(d, np.asarray(x), v, dc) if dc is None
        else RColumn(d, np.asarray(x), v, dc) for d, x, v, dc in cols])
    return port, ref


def assert_roundtrip(port: Table, ref: RTable, lanes, encs=None,
                     books=None, cap: int = CAP) -> tdevice.PackedTable:
    """The port's payload equals the reference's byte for byte, and the
    unpacked table equals to_device's."""
    n = port.num_rows
    got, gdicts = tdevice._pack_payload(port, lanes, n, cap, encs, books)
    want, wdicts = rdevice._pack_payload(ref, lanes, n, cap, encs, books)
    assert got.dtype == want.dtype == np.uint8
    assert got.tobytes() == want.tobytes()
    assert [d is None for d in gdicts] == [d is None for d in wdicts]
    packed = tdevice.pack_table(port, "cpu", cap, lanes, encs, books)
    assert tdevice.device_bytes(packed) == \
        tdevice.enc_lane_bytes(tuple(lanes), cap, encs) == len(want)
    out = tdevice.to_host(tdevice.unpack_table(packed))
    base = tdevice.to_host(tdevice.to_device(port, "cpu", cap))
    for a, b in zip(out.columns, base.columns):
        np.testing.assert_array_equal(np.asarray(a.data), np.asarray(b.data))
        np.testing.assert_array_equal(a.validity, b.validity)
    return packed
