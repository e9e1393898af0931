"""The port end to end against nds_tpu, at SF0.01 on the CPU.

The __graft_entry__ star query and NDS queries 3, 9 and 96 (stream 0,
template seed 3, decimals as exact int64) run through the port's
``Session.sql(backend="torch")`` on the CPU, where each CUDA kernel's
plain version stands in, with no node falling back to the host. Each
result is held against nds_tpu's ``backend="jax"`` result (Pallas off;
the XLA lowering is bit-identical to it) and its ``backend="numpy"``
result: integer, date and decimal columns bit-identical, float columns to
rtol 1e-9. Also here: the port imports neither jax nor nds_tpu (while
it runs the star query in-core, streamed and streamed over an attached
warehouse, a window query and a set operation, and the query service's
batched dispatch, and imports the benchmark drivers), and it never runs
on the CPU unless asked to.
"""
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest

from nds_tpu.config import EngineConfig as RConfig
from nds_tpu.engine import Session as RSession
from nds_tpu.schema import get_schemas

import nds_tpu_torch as nt
from nds_tpu_torch import datagen, streams
from nds_tpu_torch.validate import table_mismatches
from torch_isolation import isolate_port_programs  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 3


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("torch_slice") / "sf001")
    datagen.generate(data, 0.01, parallel=2)
    ref = RSession(RConfig(decimal_physical="i64"))
    for name, sch in get_schemas().items():
        ref.register_csv(name, os.path.join(data, name),
                         sch.arrow_schema(use_decimal=True))
    port = nt.Session(nt.EngineConfig(decimal_physical="i64"), device="cpu")
    assert len(datagen.setup_tables(port, data)) == 24
    return ref, port


def _check(ref, port, sql):
    got = port.sql(sql, backend="torch")
    assert port.last_fallbacks == []
    for backend in ("jax", "numpy"):
        want = ref.sql(sql, backend=backend)
        assert table_mismatches(got, want) == [], backend
    return got


@pytest.mark.parametrize("number", [3, 9, 96])
def test_nds_query_matches_reference(sessions, number):
    ref, port = sessions
    got = _check(ref, port, streams.instantiate(number, stream=0,
                                                rngseed=SEED))
    assert got.num_rows > 0


def _star_tables():
    """The arrays of __graft_entry__._star_session, as Arrow tables."""
    rng = np.random.default_rng(17)
    n_fact, n_dim = 8192, 512
    fact = pa.table({
        "fk": pa.array(rng.integers(0, n_dim + 8, n_fact), type=pa.int32()),
        "qty": pa.array(rng.integers(1, 100, n_fact), type=pa.int32()),
        "price": pa.array(rng.uniform(0.5, 999.0, n_fact)
                          .astype(np.float32)),
        "day": pa.array(rng.integers(0, 365, n_fact), type=pa.int32()),
    })
    dim = pa.table({
        "dk": pa.array(np.arange(n_dim), type=pa.int32()),
        "grp": pa.array((np.arange(n_dim) % 17).astype(np.int32)),
    })
    return fact, dim


def test_star_query_matches_reference():
    sys.path.insert(0, REPO)
    import __graft_entry__ as graft
    ref = graft._star_session()
    fact, dim = _star_tables()
    port = nt.Session(device="cpu")
    port.register_arrow("fact", fact)
    port.register_arrow("dim", dim)
    got = _check(ref, port, graft._STAR_QUERY)
    assert got.num_rows == 17


_GUARD = """
import sys
sys.modules["jax"] = None
sys.modules["nds_tpu"] = None
import importlib, pkgutil
import numpy as np, pyarrow as pa
import nds_tpu_torch as nt
for m in pkgutil.walk_packages(nt.__path__, "nds_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
# the benchmark drivers: streams, power, throughput, validator, reports
import tempfile
from nds_tpu_torch import check, power, report, streams, throughput, validate
from nds_tpu_torch.obs import device_time
[path] = streams.generate_query_streams(tempfile.mkdtemp(), 1, 3)
assert len(power.gen_sql_from_stream(open(path).read())) == 103
assert report.BenchReport(nt.EngineConfig(device="cpu")).summary[
    "env"]["host"]["device_name"] == "cpu"
assert callable(throughput.run_throughput) and callable(validate.main)
assert callable(check.check_json_summary_folder)
assert device_time.PROGRAMS is nt.obs.PROGRAMS
rng = np.random.default_rng(17)
fact = pa.table({"fk": pa.array(rng.integers(0, 520, 8192), type=pa.int32()),
                 "qty": pa.array(rng.integers(1, 100, 8192), type=pa.int32()),
                 "price": pa.array(rng.uniform(0.5, 999.0, 8192)),
                 "day": pa.array(rng.integers(0, 365, 8192), type=pa.int32())})
dim = pa.table({"dk": pa.array(np.arange(512), type=pa.int32()),
                "grp": pa.array((np.arange(512) % 17).astype(np.int32))})
s = nt.Session(device="cpu")
s.register_arrow("fact", fact)
s.register_arrow("dim", dim)
t = s.sql(sys.argv[1])
assert t.num_rows == 17 and not s.last_fallbacks
star, star_table = t.to_pylist(), t
# the compiled path too: compile+run, then a replay
for mode in ("compile+run", "compiled"):
    assert s.sql(sys.argv[1]).to_pylist() == star
    assert s.last_stats["mode"] == mode and not s.last_fallbacks
# the query service over the same session: a held pair of the star query
# runs as one batched dispatch
import time
from nds_tpu_torch.service import QueryService
with QueryService(s) as svc:
    with svc.hold_dispatch():
        tickets = [svc.submit(sys.argv[1]) for _ in range(2)]
        while len(svc._ready) < 2:
            time.sleep(0.01)
    for ticket in tickets:
        assert ticket.result(60).to_pylist() == star
        assert ticket.stats.mode == "batched"
# a window function and a set operation on the device path as well
t = s.sql("SELECT fk, day, RANK() OVER (PARTITION BY fk ORDER BY qty) AS r, "
          "SUM(qty) OVER (PARTITION BY day) AS q FROM fact")
assert t.num_rows == 8192 and not s.last_fallbacks
t = s.sql("SELECT fk FROM fact WHERE qty > 50 INTERSECT SELECT dk FROM dim")
assert 0 < t.num_rows <= 512 and not s.last_fallbacks
# the streamed path: the fact table from Parquet, in 2048-row morsels
import os, tempfile
import pyarrow.parquet as pq
path = os.path.join(tempfile.mkdtemp(), "fact.parquet")
pq.write_table(fact, path, row_group_size=2048)
s = nt.Session(nt.EngineConfig(out_of_core_min_rows=4096, chunk_rows=2048),
               device="cpu")
s.register_parquet("fact", path)
s.register_arrow("dim", dim)
from nds_tpu_torch.validate import table_mismatches
for _ in range(2):
    assert table_mismatches(s.sql(sys.argv[1]), star_table) == []
    assert s.last_stats["mode"] == "streamed" and not s.last_fallbacks
    assert s.last_stats["morsels"] == 4
# the same over the Load Test's warehouse, attached (manifest stats)
from nds_tpu_torch import transcode
from nds_tpu_torch.warehouse import Warehouse
wh = Warehouse(tempfile.mkdtemp())
wh.table("fact").create(fact, partition=False)
wh.table("dim").create(dim, partition=False)
s = nt.Session(nt.EngineConfig(out_of_core_min_rows=4096, chunk_rows=2048),
               device="cpu")
s.attach_warehouse(Warehouse(wh.root))
assert table_mismatches(s.sql(sys.argv[1]), star_table) == []
assert s.last_stats["mode"] == "streamed" and s.last_stats["lane_spec"]
assert callable(transcode.main)
print("GUARD_OK", sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "jaxlib", "nds_tpu")
                         and sys.modules[m] is not None))
"""


def test_port_imports_neither_jax_nor_nds_tpu():
    sys.path.insert(0, REPO)
    import __graft_entry__ as graft
    out = subprocess.run([sys.executable, "-c", _GUARD, graft._STAR_QUERY],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "GUARD_OK []" in out.stdout


def test_session_without_device_never_runs_on_the_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nt.Session()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nt.Session(device="cuda")
    assert nt.Session(device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py", "--sf", "0.01"],
                         cwd=REPO, capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
