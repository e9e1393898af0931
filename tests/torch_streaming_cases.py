"""Shared inputs and checks of the port's streamed-path tests
(tests/test_torch_streaming*.py).

The data are the reference's own streaming-test tables, made with numpy
from the same seeds: a 50,000-row fact table written to Parquet in 8192-row
row groups, a 300-row dimension, and two fact channels for the UNION ALL
shapes. Every case runs the same SQL three ways over the same tables:

- the reference, ``nds_tpu.Session`` with ``out_of_core=True``,
  ``chunk_rows=4096`` and ``out_of_core_min_rows=10_000``, jit-compiled on
  the CPU;
- the port streamed, ``nds_tpu_torch.Session(..., device="cpu")`` with the
  same settings;
- the port in-core (``out_of_core=False``).

``sessions(lanes=False)`` (the streaming tests' comparisons) sets
``narrow_lanes=False`` on both sides: plain morsel uploads.
``sessions(lanes=True)`` keeps both engines' defaults, packed narrow lanes
with dictionary and run-length encodings (tests/test_torch_lanes_streaming
*.py).

Both port results must equal the reference's streamed result (integers and
i64 decimals bit-identical, floats to rtol 1e-9: ``validate.
table_mismatches``), and the structural stats of a streamed run
(STRUCTURAL) and its wire layout (``lane_spec``, ``enc_spec``) must equal
the reference's ``last_exec_stats``.
"""
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from nds_tpu.config import EngineConfig as RConfig
from nds_tpu.engine import Session as RSession

import nds_tpu_torch as nt
from nds_tpu_torch.validate import table_mismatches

N_FACT, N_DIM = 50_000, 300
CHUNK = 4_096                           # ~13 morsels per fact pass
PER_PASS = -(-N_FACT // CHUNK)
MIN_ROWS = 10_000

#: the streamed-run stats that follow from the plan and the data alone
STRUCTURAL = ("jobs", "morsels", "scan_passes", "branches_served",
              "fused_groups", "re_records")


def make_fact(seed: int = 5) -> pa.Table:
    """tests/test_streaming.py's fact table (seed 5) or
    tests/test_shared_scan.py's (seed 11): about 5 % of qty NULL."""
    rng = np.random.default_rng(seed)
    if seed == 11:
        qty = rng.integers(1, 50, N_FACT).astype(object)
        qty[rng.random(N_FACT) < 0.05] = None
        return pa.table({
            "fk": pa.array(rng.integers(0, N_DIM + 9, N_FACT),
                           type=pa.int32()),
            "qty": pa.array(list(qty), type=pa.int32()),
            "price": pa.array(np.round(rng.uniform(1, 100, N_FACT), 2)),
            "day": pa.array(rng.integers(0, 365, N_FACT), type=pa.int32()),
        })
    fact = pa.table({
        "fk": pa.array(rng.integers(0, N_DIM + 9, N_FACT), type=pa.int32()),
        "qty": pa.array(rng.integers(1, 50, N_FACT), type=pa.int32()),
        "price": pa.array(np.round(rng.uniform(1, 100, N_FACT), 2)),
        "day": pa.array(rng.integers(0, 365, N_FACT), type=pa.int32()),
    })
    mask = rng.random(N_FACT) < 0.05
    qty = fact.column("qty").to_numpy(zero_copy_only=False).astype(object)
    qty[mask] = None
    return fact.set_column(1, "qty", pa.array(list(qty), type=pa.int32()))


def make_dim(mod: int = 13) -> pa.Table:
    return pa.table({"dk": pa.array(np.arange(N_DIM), type=pa.int32()),
                     "grp": pa.array((np.arange(N_DIM) % mod)
                                     .astype(np.int32))})


def make_channels(tmp) -> dict:
    """Two fact channels over the threshold (Parquet) and one under it
    (Arrow), tests/test_streaming.py's UNION ALL shape (seed 9)."""
    rng = np.random.default_rng(9)
    out = {}
    for name, n in (("ch_a", 30_000), ("ch_b", 25_000)):
        t = pa.table({
            "fk": pa.array(rng.integers(0, N_DIM, n), type=pa.int32()),
            "amt": pa.array(rng.integers(1, 500, n), type=pa.int64()),
        })
        path = os.path.join(str(tmp), f"{name}.parquet")
        pq.write_table(t, path, row_group_size=8192)
        out[name] = (t, path)
    out["ch_small"] = (pa.table({
        "fk": pa.array(rng.integers(0, N_DIM, 400), type=pa.int32()),
        "amt": pa.array(rng.integers(1, 500, 400), type=pa.int64()),
    }), None)
    return out


def write_fact(tmp, fact: pa.Table, name: str = "fact.parquet") -> str:
    path = os.path.join(str(tmp), name)
    pq.write_table(fact, path, row_group_size=8192)
    return path


def register(session, tables: dict) -> None:
    """{name: (arrow table, parquet path or None)}: Parquet where there is
    a path (row counts from its metadata), else Arrow."""
    for name, (t, path) in tables.items():
        if path is not None:
            session.register_parquet(name, path)
        else:
            session.register_arrow(name, t)


def sessions(tables: dict, lanes: bool = False, **cfg):
    """(reference streamed, port streamed, port in-core) over `tables`,
    with narrow_lanes (and so encoded_exec) on or off on both sides."""
    kw = dict(chunk_rows=CHUNK, out_of_core_min_rows=MIN_ROWS,
              narrow_lanes=lanes)
    kw.update(cfg)
    ref = RSession(RConfig(out_of_core=True, **kw))
    port = nt.Session(nt.EngineConfig(**kw), device="cpu")
    incore = nt.Session(nt.EngineConfig(out_of_core=False, **kw),
                        device="cpu")
    for s in (ref, port, incore):
        register(s, tables)
    return ref, port, incore


def packed_bytes(lane_spec: dict) -> int:
    """The wire bytes of one morsel with these lanes (all plain)."""
    from nds_tpu_torch.engine.torch_backend.device import bucket, lane_bytes
    return lane_bytes(tuple(lane_spec.values()), bucket(CHUNK))


def run_ref(ref, sql: str):
    got = ref.sql(sql, backend="jax")
    return got, dict(ref.last_exec_stats)


def run_port(port, sql: str):
    got = port.sql(sql, backend="torch")
    return got, dict(port.last_stats)


def check(ref, port, incore, sql: str, streams: bool = True,
          runs: int = 1) -> tuple:
    """The three runs of `sql` (the port's streamed one `runs` times: a
    cold record, then warm replays): every port result equals the
    reference's, and a streamed run's structural stats equal the
    reference's. Returns (reference stats, the last port stats)."""
    want, rst = run_ref(ref, sql)
    for _ in range(runs):
        got, pst = run_port(port, sql)
        assert table_mismatches(got, want) == []
        assert port.last_fallbacks == []
    base = incore.sql(sql, backend="torch")
    assert incore.last_stats.get("mode") != "streamed"
    assert table_mismatches(base, want) == []
    if streams:
        assert rst["mode"] == "streaming"
        assert pst["mode"] == "streamed"
        assert {k: pst[k] for k in STRUCTURAL} == \
            {k: rst.get(k, 0) for k in STRUCTURAL}
        assert pst["lane_spec"] == rst["lane_spec"]
        assert pst["enc_spec"] == rst.get("enc_spec")
        assert pst["prefetch_error_details"] == []
    else:
        assert rst.get("mode") != "streaming"
        assert pst.get("mode") != "streamed"
    return rst, pst


# -- the SQL of tests/test_streaming.py and tests/test_shared_scan.py --------

QUERY = """
SELECT d.grp, COUNT(*) AS cnt, COUNT(f.qty) AS cq, SUM(f.qty) AS sq,
       AVG(f.price) AS ap, MIN(f.price) AS lo, MAX(f.price) AS hi
FROM fact f JOIN dim d ON f.fk = d.dk
WHERE f.day < 200
GROUP BY d.grp
ORDER BY d.grp
"""

GLOBAL = "SELECT COUNT(*), SUM(qty), AVG(price) FROM fact WHERE day >= 100"

DISTINCT = "SELECT COUNT(DISTINCT fk) FROM fact"

ROLLUP = ("SELECT d.grp, f.day % 2 AS parity, SUM(f.qty) AS sq, "
          "COUNT(*) AS cnt FROM fact f JOIN dim d ON f.fk = d.dk "
          "WHERE f.day < 120 GROUP BY ROLLUP(d.grp, f.day % 2) "
          "ORDER BY d.grp, parity")

WINDOW_ABOVE = ("SELECT grp, sq, RANK() OVER (ORDER BY sq DESC) rk FROM "
                "(SELECT d.grp AS grp, SUM(f.qty) AS sq FROM fact f "
                "JOIN dim d ON f.fk = d.dk GROUP BY d.grp) t "
                "ORDER BY rk, grp")

UNION_AGG = """
SELECT d.grp, COUNT(*) AS cnt, SUM(u.amt) AS total
FROM (SELECT fk, amt FROM ch_a
      UNION ALL SELECT fk, amt FROM ch_b
      UNION ALL SELECT fk, amt FROM ch_small) u
JOIN dim d ON u.fk = d.dk
GROUP BY d.grp
ORDER BY d.grp
"""

BELOW_JOIN = """
SELECT a.grp, a.sq, b.sq
FROM (SELECT d.grp, SUM(f.qty) sq FROM fact f JOIN dim d ON f.fk = d.dk
      WHERE f.day < 180 GROUP BY d.grp) a
JOIN (SELECT d.grp, SUM(f.qty) sq FROM fact f JOIN dim d ON f.fk = d.dk
      WHERE f.day >= 180 GROUP BY d.grp) b
ON a.grp = b.grp
ORDER BY a.grp
"""

SMALL_SIDE = """
SELECT d.grp, COUNT(*) FROM fact f JOIN dim d ON f.fk = d.dk
WHERE f.price > (SELECT AVG(price) FROM fact WHERE day < 0) + 0
  AND f.fk IN (SELECT dk FROM dim WHERE grp < 20)
GROUP BY d.grp ORDER BY d.grp
"""

COMPACT = ("SELECT fk, day, COUNT(*) c, SUM(qty) sq, AVG(price) ap "
           "FROM fact GROUP BY fk, day ORDER BY fk, day LIMIT 500")

SCALAR = """
SELECT d.grp,
       CASE WHEN (SELECT COUNT(*) FROM fact WHERE day < 100) > 10
            THEN (SELECT AVG(price) FROM fact WHERE day < 100)
            ELSE (SELECT AVG(price) FROM fact WHERE day >= 100) END AS v
FROM dim d WHERE d.dk < 3
"""

SEMI_BIG = """
SELECT d.grp, COUNT(*) FROM dim d
WHERE EXISTS (SELECT 1 FROM fact f WHERE f.fk = d.dk AND f.day < 50)
GROUP BY d.grp ORDER BY d.grp
"""

NOT_IN_BIG = ("SELECT COUNT(*) FROM dim "
              "WHERE dk NOT IN (SELECT fk FROM fact WHERE day < 30)")

# q9-class: scalar-subquery aggregates over the big table, each pruning a
# different column subset (the union exercises fuse_group)
Q9 = """
SELECT d.grp,
       CASE WHEN (SELECT COUNT(*) FROM fact WHERE day < 100) > 10
            THEN (SELECT AVG(price) FROM fact WHERE day < 100)
            ELSE (SELECT AVG(qty) FROM fact WHERE day >= 100) END AS v,
       (SELECT SUM(qty) FROM fact WHERE day >= 200) AS s
FROM dim d WHERE d.dk < 3
"""
Q9_JOBS = 4

# q2/q5-class: two aggregate jobs, each a UNION ALL over the same two fact
# channels
UNION2 = """
SELECT a.grp, a.total, b.total
FROM (SELECT d.grp AS grp, SUM(u.amt) AS total
      FROM (SELECT fk, amt FROM ch_a UNION ALL SELECT fk, amt FROM ch_b) u
      JOIN dim d ON u.fk = d.dk WHERE u.amt < 400 GROUP BY d.grp) a
JOIN (SELECT d.grp AS grp, SUM(u.amt) AS total
      FROM (SELECT fk, amt FROM ch_a UNION ALL SELECT fk, amt FROM ch_b) u
      JOIN dim d ON u.fk = d.dk WHERE u.amt >= 400 GROUP BY d.grp) b
ON a.grp = b.grp ORDER BY a.grp
"""

# q10-class: a semi-join build side AND a scalar subquery over one table
SEMI = """
SELECT d.grp, COUNT(*) AS cnt FROM dim d
WHERE EXISTS (SELECT 1 FROM fact f WHERE f.fk = d.dk AND f.day < 50)
  AND d.dk < (SELECT AVG(fk) FROM fact) + 100
GROUP BY d.grp ORDER BY d.grp
"""
