"""The port's streamed path at both engines' defaults, part 1: packed
narrow lanes with dictionary and run-length encodings
(``narrow_lanes=True``, ``encoded_exec=True``) on the port and on nds_tpu.
The cases of tests/test_torch_streaming1.py and 2 over one fact table in
~13 morsels, each cold and warm: results equal the reference's (and the
port's in-core result), and the structural stats and the wire layout
(``lane_spec``, ``enc_spec``) equal the reference's. The comparisons with
lanes off on both sides stay in tests/test_torch_streaming*.py. See
tests/torch_streaming_cases.py."""
import pytest

import torch_streaming_cases as C


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_lanes_streaming1")
    fact = C.make_fact(5)
    return C.sessions({"fact": (fact, C.write_fact(tmp, fact)),
                       "dim": (C.make_dim(), None)}, lanes=True)


@pytest.mark.parametrize("name", ["QUERY", "GLOBAL", "ROLLUP",
                                  "WINDOW_ABOVE", "BELOW_JOIN", "SMALL_SIDE",
                                  "SCALAR", "SEMI_BIG", "NOT_IN_BIG",
                                  "COMPACT"])
def test_streamed_at_the_defaults_matches_the_reference(trio, name):
    _ref, port, _incore = trio
    assert port.config.narrow_lanes and port.config.encoded_exec
    # cold (record), then warm (replay)
    rst, pst = C.check(*trio, getattr(C, name), runs=2)
    assert pst["re_records"] == 0
    assert pst["narrow_lanes"] and rst["narrow_lanes"]
    lanes = pst["lane_spec"]["fact"]
    # the fact table's columns ride narrow lanes
    assert set(lanes.values()) <= {"u8", "u16", "f64"}
    assert pst["bytes_uploaded"] == pst["morsels"] * C.packed_bytes(lanes)


def test_ineligible_plans_run_incore(trio):
    C.check(*trio, C.DISTINCT, streams=False)
