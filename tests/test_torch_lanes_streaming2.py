"""The port's streamed path at both engines' defaults, part 2: the
cases of tests/test_torch_streaming2.py's UNION ALL channels and of
tests/test_torch_streaming3.py's shared scans (q9-class scalar-subquery
groups, semi-join build sides, the three fusion modes), with packed narrow
lanes and encodings on the port and on nds_tpu, cold and warm. See
tests/torch_streaming_cases.py."""
import pytest

import torch_streaming_cases as C


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_lanes_streaming2")
    fact = C.make_fact(11)
    return {"fact": (fact, C.write_fact(tmp, fact)),
            "dim": (C.make_dim(), None)}


@pytest.mark.parametrize("name,mode", [
    ("Q9", (True, 16)), ("Q9", (True, 1)), ("Q9", (False, 16)),
    ("SEMI", (True, 16))],
    ids=["Q9-fused", "Q9-per_member", "Q9-per_branch", "SEMI-fused"])
def test_shared_scan_modes_at_the_defaults(shared, name, mode):
    shared_scan, fuse_max = mode
    trio = C.sessions(shared, lanes=True, shared_scan=shared_scan,
                      stream_fusion_max_branches=fuse_max)
    _rst, pst = C.check(*trio, getattr(C, name), runs=2)
    assert pst["re_records"] == 0
    assert pst["lane_spec"]["fact"]


def test_union_channels_at_the_defaults(tmp_path):
    """Two big channels streamed, one small partial; the int64 amount
    column of each channel rides a narrow lane."""
    tables = C.make_channels(tmp_path)
    tables["dim"] = (C.make_dim(7), None)
    trio = C.sessions(tables, lanes=True)
    for sql in (C.UNION_AGG, C.UNION2):
        _rst, pst = C.check(*trio, sql, runs=2)
        assert pst["tables_streamed"] == 2
        assert set(pst["lane_spec"]) == {"ch_a", "ch_b"}
        assert pst["lane_spec"]["ch_a"]["amt"] == "u16"
