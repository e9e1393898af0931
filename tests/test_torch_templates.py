"""Every NDS template unit through the port, at SF0.01 on the CPU.

All 99 templates of stream 0 (template seed 3), the four two-statement
templates split in two: 103 units. Each runs through the port's
``Session.sql(backend="torch")`` on the CPU, where each CUDA kernel's plain
version stands in, with no plan node falling back to the host, and is held
against nds_tpu's ``backend="numpy"`` result on the same data (the port's
generator, decimals as exact int64): integer, date and decimal columns
bit-identical, float columns to rtol 1e-9.

The units that need window functions, set operations or string
concatenation on the device (``GAP_UNITS``) are also held against
nds_tpu's ``backend="jax"`` result, in ``test_torch_templates_jax*.py``:
the JAX engine's eager pass compiles each new operation shape, so those
units are split over three files for the test workers.
"""
import os

import pytest

from nds_tpu.config import EngineConfig as RConfig
from nds_tpu.engine import Session as RSession
from nds_tpu.schema import get_schemas

import nds_tpu_torch as nt
from nds_tpu_torch import datagen, streams
from nds_tpu_torch.validate import table_mismatches

SEED = 3
UNITS = dict(streams.template_units(stream=0, rngseed=SEED))

#: the units whose plans hold a set operation, a window function or a
#: string concatenation, in template order
GAP_UNITS = [f"query{u}" for u in (
    "2 4 5 8 11 12 14_part1 14_part2 20 23_part1 23_part2 33 36 38 44 47 49 "
    "51 53 54 56 57 60 63 66 67 70 71 74 75 76 77 80 84 86 87 89 98").split()]


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """(nds_tpu session, port session) over one SF0.01 data set."""
    data = str(tmp_path_factory.mktemp("torch_templates") / "sf001")
    datagen.generate(data, 0.01, parallel=2)
    ref = RSession(RConfig(decimal_physical="i64"))
    for name, sch in get_schemas().items():
        ref.register_csv(name, os.path.join(data, name),
                         sch.arrow_schema(use_decimal=True))
    port = nt.Session(nt.EngineConfig(decimal_physical="i64"), device="cpu")
    assert len(datagen.setup_tables(port, data)) == 24
    return ref, port


def check_unit(ref, port, name: str, backends) -> None:
    sql = UNITS[name]
    got = port.sql(sql, backend="torch")
    assert port.last_fallbacks == [], port.last_fallbacks
    for backend in backends:
        want = ref.sql(sql, backend=backend)
        assert table_mismatches(got, want) == [], backend


def test_the_units_are_every_template():
    assert len(UNITS) == 103
    assert sorted({int(n[5:].split("_")[0]) for n in UNITS}) == \
        list(range(1, 100))
    assert set(GAP_UNITS) <= set(UNITS) and len(GAP_UNITS) == 38


@pytest.mark.parametrize("name", list(UNITS))
def test_template_unit_matches_numpy_reference(sessions, name):
    check_unit(*sessions, name, ("numpy",))
