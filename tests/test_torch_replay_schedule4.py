"""The port's capacity schedules against the reference's record pass, part
4 of 4: q67, its schedule and its modes.
See tests/test_torch_replay.py."""
import pytest

from test_torch_replay import UNITS, check_modes, check_schedule, \
    make_sessions
from torch_isolation import isolate_port_programs  # noqa: F401


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    return make_sessions(tmp_path_factory, "torch_replay_schedule4")


def test_schedule_matches_the_reference(sessions):
    check_schedule(*sessions, UNITS["query67"])


def test_modes_match_the_reference(sessions):
    check_modes(*sessions, UNITS["query67"])
