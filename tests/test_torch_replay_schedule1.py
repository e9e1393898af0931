"""The port's capacity schedules against the reference's record pass, part
1 of 4: q3, q9, q5 and one plan for each decision the templates leave out;
the modes of q3 and q9.
See tests/test_torch_replay.py."""
import pytest

from test_torch_replay import UNITS, KIND_SQL, check_modes, check_schedule, \
    make_sessions
from test_torch_replay import _isolate_shared_programs  # noqa: F401


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    return make_sessions(tmp_path_factory, "torch_replay_schedule1")


@pytest.mark.parametrize("name", ["query3", "query9", "query5"]
                         + sorted(KIND_SQL))
def test_schedule_matches_the_reference(sessions, name):
    check_schedule(*sessions, KIND_SQL.get(name) or UNITS[name])


@pytest.mark.parametrize("name", ["query3", "query9"])
def test_modes_match_the_reference(sessions, name):
    check_modes(*sessions, UNITS[name])
