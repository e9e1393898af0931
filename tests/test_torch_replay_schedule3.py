"""The port's capacity schedules against the reference's record pass, part
3 of 4: the schedules of q23_part1 and q47.
See tests/test_torch_replay.py."""
import pytest

from test_torch_replay import UNITS, check_modes, check_schedule, \
    make_sessions
from torch_isolation import isolate_port_programs  # noqa: F401


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    return make_sessions(tmp_path_factory, "torch_replay_schedule3")


@pytest.mark.parametrize("name", ["query23_part1", "query47"])
def test_schedule_matches_the_reference(sessions, name):
    check_schedule(*sessions, UNITS[name])
