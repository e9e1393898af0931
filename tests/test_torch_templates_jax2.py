"""The template units of the port's new device paths (window functions,
set operations, string concatenation) against nds_tpu's ``backend="jax"``
result: part 2 of 3 of ``test_torch_templates.GAP_UNITS`` (see
tests/test_torch_templates.py)."""
import pytest

from test_torch_templates import GAP_UNITS, check_unit
from test_torch_templates import sessions  # noqa: F401 (module fixture)
from torch_isolation import isolate_port_programs  # noqa: F401


@pytest.mark.parametrize("name", GAP_UNITS[1::3])
def test_template_unit_matches_jax_reference(sessions, name):
    check_unit(*sessions, name, ("jax",))
