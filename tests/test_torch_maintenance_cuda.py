"""Data Maintenance on the card (marked ``cuda``; it skips where there is
no card).

Run on a machine with an NVIDIA card:

    python -m pytest --noconftest -m cuda tests/test_torch_maintenance_cuda.py

SF0.001 data and refresh set 1 at SF0.01, loaded into a partitioned
``--use_decimal`` warehouse: LF_SS and DF_SS through
``maintenance.run_maintenance`` with the INSERT bodies on the card leave
store_sales and store_returns equal, file for file, to a run with
``backend="numpy"``. A query compiled and replayed as a CUDA graph before
an INSERT, run again after it on the session that published it, adopts
the earlier program or records again, and equals the numpy executor.
"""
import shutil

import pyarrow.parquet as pq
import pytest
import torch

import nds_tpu_torch as nt
from nds_tpu_torch import datagen, maintenance, transcode
from nds_tpu_torch.engine.torch_backend import cuda_kernels as ck
from nds_tpu_torch.validate import table_mismatches
from nds_tpu_torch.warehouse import Warehouse
from torch_drivers_cases import file_faults
from torch_isolation import isolate_port_programs  # noqa: F401

pytestmark = pytest.mark.cuda

FUNCS = ["LF_SS", "DF_SS"]
Q = ("SELECT ss_store_sk, COUNT(*) AS n, SUM(ss_quantity) AS q, "
     "SUM(ss_net_paid) AS p FROM store_sales, item "
     "WHERE ss_item_sk = i_item_sk AND i_category IS NOT NULL "
     "GROUP BY ss_store_sk ORDER BY ss_store_sk")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the INSERT bodies run there")
    ck.build()
    root = tmp_path_factory.mktemp("maint_cuda")
    datagen.generate(str(root / "base"), 0.001, 1)
    datagen.generate(str(root / "upd"), 0.01, 1, update=1)
    transcode.transcode(str(root / "base"), str(root / "pristine"),
                        use_decimal=True)
    return root


def test_lf_ss_and_df_ss_on_the_card_equal_numpy(inputs, tmp_path):
    whs = {}
    for backend in ("torch", "numpy"):
        wh = str(tmp_path / backend)
        shutil.copytree(inputs / "pristine", wh)
        rows = maintenance.run_maintenance(
            wh, str(inputs / "upd"), str(tmp_path / f"{backend}.csv"),
            FUNCS, backend=backend)
        assert [r[0] for r in rows] == FUNCS
        whs[backend] = Warehouse(wh)
    assert whs["torch"].versions() == whs["numpy"].versions() == [1, 2]
    for table in ("store_sales", "store_returns"):
        got = whs["torch"].table(table).current_files()
        want = whs["numpy"].table(table).current_files()
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            assert file_faults(pq.read_table(g, partitioning=None),
                               pq.read_table(w, partitioning=None)) == [], \
                (table, g)


def test_a_program_recorded_before_an_insert_is_safe_after_it(inputs,
                                                              tmp_path):
    wh = str(tmp_path / "wh")
    shutil.copytree(inputs / "pristine", wh)
    s = nt.Session()
    s.attach_warehouse(Warehouse(wh))
    modes = []
    for _ in range(3):
        got = s.sql(Q)
        modes.append(s.last_stats.get("mode"))
    assert modes[-1] == "compiled", modes
    assert table_mismatches(got, s.sql(Q, backend="numpy")) == []
    before = got.num_rows
    maintenance.run_maintenance(wh, str(inputs / "upd"),
                                str(tmp_path / "m.csv"), ["LF_SS"],
                                session=s)
    assert s.warehouse_version() == 1
    after = []
    for _ in range(3):
        after.append(s.sql(Q))
        modes.append(s.last_stats.get("mode"))
        assert s.last_fallbacks == []
    want = s.sql(Q, backend="numpy")
    for got in after:
        assert table_mismatches(got, want) == []
    assert modes[3] in ("record", "adopted"), modes
    assert before > 0
