"""The port's streamed path on the CPU, part 2 of 4: the rest of
tests/test_streaming.py's cases — UNION ALL channels, aggregates below a
join, small-side subqueries, in-loop partial compaction, scalar
subqueries, and semi/anti joins whose build side streams. See
tests/torch_streaming_cases.py."""
import pytest

import torch_streaming_cases as C
from torch_isolation import isolate_port_programs  # noqa: F401


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_streaming2")
    fact = C.make_fact(5)
    return C.sessions({"fact": (fact, C.write_fact(tmp, fact)),
                       "dim": (C.make_dim(), None)})


@pytest.mark.parametrize("name", ["BELOW_JOIN", "SMALL_SIDE", "SCALAR",
                                  "SEMI_BIG", "NOT_IN_BIG"])
def test_streamed_matches_the_reference(trio, name):
    rst, pst = C.check(*trio, getattr(C, name))
    if name == "BELOW_JOIN":
        assert pst["jobs"] == 2
    if name == "SCALAR":
        assert pst["jobs"] == 3
    if name == "SEMI_BIG":
        assert pst["jobs"] == 1


def test_union_branch_streaming(tmp_path):
    """q2/q4/q5-class multi-fact-channel aggregate: each UNION ALL branch
    over a big channel streams; the small channel's partial runs once."""
    tables = C.make_channels(tmp_path)
    tables["dim"] = (C.make_dim(7), None)
    _rst, pst = C.check(*C.sessions(tables), C.UNION_AGG)
    assert pst["morsels"] == -(-30_000 // C.CHUNK) + -(-25_000 // C.CHUNK)
    assert pst["tables_streamed"] == 2


def test_partial_compaction_bounds_memory(trio):
    """High-cardinality groups with a tiny compaction bound: results stay
    exact through repeated combine passes in the morsel loop."""
    ref, port, incore = trio
    for s in (ref, port):
        s.config.stream_compact_rows = 2_000
    try:
        C.check(ref, port, incore, C.COMPACT)
    finally:
        for s in (ref, port):
            s.config.stream_compact_rows = 8_000_000
