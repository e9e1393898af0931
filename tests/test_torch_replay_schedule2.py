"""The port's capacity schedules against the reference's record pass, part
2 of 4: q14_part1, its schedule and its modes.
See tests/test_torch_replay.py."""
import pytest

from test_torch_replay import UNITS, check_modes, check_schedule, \
    make_sessions
from test_torch_replay import _isolate_shared_programs  # noqa: F401


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    return make_sessions(tmp_path_factory, "torch_replay_schedule2")


def test_schedule_matches_the_reference(sessions):
    check_schedule(*sessions, UNITS["query14_part1"])


def test_modes_match_the_reference(sessions):
    check_modes(*sessions, UNITS["query14_part1"])
