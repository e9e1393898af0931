"""A streamed scan over a partitioned warehouse table on the card (marked
``cuda``; it skips where there is no card).

Run on a machine with an NVIDIA card:

    python -m pytest --noconftest -m cuda tests/test_torch_warehouse_cuda.py

A fact table written by the port's warehouse, one file a date, streams
through a session attached to the warehouse: its lanes and encodings are
planned from the manifest's per-file stats with no stat read from the
data, its results equal the numpy executor's cold and warm, and a warm
pass captures no graph."""
import numpy as np
import pyarrow as pa
import pytest
import torch

import nds_tpu_torch as nt
from nds_tpu_torch.engine import arrow_bridge
from nds_tpu_torch.engine.torch_backend import cuda_kernels as ck
from nds_tpu_torch.validate import table_mismatches
from nds_tpu_torch.warehouse import Warehouse
from torch_isolation import isolate_port_programs  # noqa: F401

pytestmark = pytest.mark.cuda

DAYS = 40


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the streamed graphs run there")
    ck.build()
    return torch.device("cuda")


def test_streamed_scan_plans_from_the_manifest(dev, tmp_path, monkeypatch):
    rng = np.random.default_rng(11)
    n = 80_000
    fact = pa.table({
        # one partition a date, in the generator's order (by date)
        "inv_date_sk": pa.array(np.sort(rng.integers(0, DAYS, n)) + 2_450_815,
                                type=pa.int64()),
        "inv_item_sk": pa.array(rng.integers(1, 20_000, n), type=pa.int64()),
        "inv_warehouse_sk": pa.array(rng.integers(1, 6, n), type=pa.int64()),
        "inv_quantity_on_hand": pa.array(
            np.where(rng.random(n) < 0.05, None, rng.integers(0, 1000, n)),
            type=pa.int64()),
    })
    dim = pa.table({"w_warehouse_sk": pa.array(np.arange(1, 6),
                                               type=pa.int64()),
                    "w_state": pa.array(["TN", "GA", "TN", "SD", "GA"])})
    wh = Warehouse(str(tmp_path / "wh"))
    with wh.transaction(committer="load"):
        wh.table("inventory").create(fact)
        wh.table("warehouse").create(dim, partition=False)
    assert len(wh.table("inventory").current_files()) == DAYS
    s = nt.Session(nt.EngineConfig(out_of_core_min_rows=10_000,
                                   chunk_rows=8192))
    s.attach_warehouse(Warehouse(wh.root))
    assert s.warehouse_version() == 1
    sql = ("SELECT w_state, COUNT(*) c, SUM(inv_quantity_on_hand) q, "
           "MAX(inv_date_sk) d FROM inventory, warehouse "
           "WHERE inv_warehouse_sk = w_warehouse_sk AND inv_date_sk < "
           "2450845 GROUP BY w_state ORDER BY w_state")
    want = s.sql(sql, backend="numpy")

    def fail(*a, **k):
        raise AssertionError("a stat was read from the data")
    for name in ("parquet_column_stats", "column_enc_stat"):
        monkeypatch.setattr(arrow_bridge, name, fail)
    for run in range(3):
        got = s.sql(sql)
        st = s.last_stats
        assert st["mode"] == "streamed" and st["fallbacks"] == []
        assert st["morsels_per_table"] == {"inventory": -(-n // 8192)}
        # one run a file: the manifest's run counts sum to the partitions
        assert st["enc_spec"]["inventory"]["inv_date_sk"] == f"rle[{DAYS}]"
        assert st["lane_spec"]["inventory"]["inv_warehouse_sk"] == "u8"
        assert st["captures"] == (1 if run == 0 else 0)
        assert st["re_records"] == 0
        assert table_mismatches(got, want) == []
