"""The port's streamed path on the CPU, part 3 of 4: the cases of
tests/test_shared_scan.py. All streaming branches of one query over the
same big table share ONE morsel pass (the union of their columns staged
once per morsel into the group's slot); a group within the fusion budget
runs as one multi-plan program. The three modes (shared and fused, shared
per member, per branch) give identical results, equal to the reference's
and to SQLite's. See tests/torch_streaming_cases.py."""
import gc
import math
import sqlite3

import pyarrow as pa
import pytest

import torch_streaming_cases as C
from nds_tpu_torch.engine import streaming
from nds_tpu_torch.validate import table_mismatches
from torch_isolation import isolate_port_programs  # noqa: F401


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_streaming3")
    fact = C.make_fact(11)
    return {"tmp": tmp, "tables": {"fact": (fact, C.write_fact(tmp, fact)),
                                   "dim": (C.make_dim(), None)}}


def sqlite_rows(tables: dict, sql: str) -> list:
    conn = sqlite3.connect(":memory:")
    for name, (t, _path) in tables.items():
        cols = ", ".join(f'"{c}"' for c in t.column_names)
        conn.execute(f"CREATE TABLE {name} ({cols})")
        conn.executemany(
            f"INSERT INTO {name} VALUES "
            f"({','.join('?' * len(t.column_names))})",
            list(zip(*[t.column(c).to_pylist() for c in t.column_names])))
    return conn.execute(sql).fetchall()


def rows_close(got, want, rel=1e-9) -> bool:
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                if (a is None) != (b is None):
                    return False
                if a is not None and not math.isclose(
                        float(a), float(b), rel_tol=rel, abs_tol=1e-12):
                    return False
            elif a != b:
                return False
    return True


MODES = ((True, 16), (True, 1), (False, 16))


def run_modes(data, sql: str) -> list:
    """The three streaming modes, each held to the reference's run in the
    same mode; returns [(port result, port stats)] per mode."""
    out = []
    for shared, fuse_max in MODES:
        trio = C.sessions(data["tables"], shared_scan=shared,
                          stream_fusion_max_branches=fuse_max)
        C.check(*trio, sql)
        out.append((trio[1].sql(sql), dict(trio[1].last_stats)))
    return out


def test_q9_single_pass_pinned(data):
    """A q9-class query streams the big table EXACTLY once — one scan
    pass, one full-pass morsel count — while serving every job."""
    _rst, st = C.check(*C.sessions(data["tables"]), C.Q9)
    assert st["jobs"] == C.Q9_JOBS
    assert st["scan_passes"] == 1
    assert st["tables_streamed"] == 1
    assert st["branches_served"] == C.Q9_JOBS
    assert st["morsels"] == C.PER_PASS
    assert st["morsels_per_table"] == {"fact": C.PER_PASS}
    assert st["fused_groups"] == 1
    assert st["bytes_uploaded"] > 0
    assert st["re_records"] == 0


def test_q9_differential_sqlite_and_modes(data):
    (fused, st_f), (unfused, st_u), (per, st_p) = run_modes(data, C.Q9)
    assert table_mismatches(unfused, fused) == []
    assert table_mismatches(per, fused) == []
    assert st_f["scan_passes"] == 1 and st_u["scan_passes"] == 1
    assert st_u["fused_groups"] == 0
    assert st_p["scan_passes"] == C.Q9_JOBS
    assert st_p["morsels"] == C.Q9_JOBS * C.PER_PASS
    assert rows_close(fused.to_pylist(), sqlite_rows(data["tables"], C.Q9))


def test_union_channels_share_per_table_pass(data):
    """Two union-channel jobs over the same two fact tables: the shared
    scan collapses 4 streamed branches into one pass per channel."""
    chans = C.make_channels(data["tmp"])
    tables = {"fact": data["tables"]["fact"], "dim": data["tables"]["dim"],
              "ch_a": chans["ch_a"], "ch_b": chans["ch_b"]}
    res, stats = [], []
    for shared in (True, False):
        trio = C.sessions(tables, shared_scan=shared)
        C.check(*trio, C.UNION2)
        res.append(trio[1].sql(C.UNION2))
        stats.append(dict(trio[1].last_stats))
    st_shared, st_per = stats
    assert table_mismatches(res[1], res[0]) == []
    assert st_shared["jobs"] == 2
    assert st_shared["branches_served"] == 4
    assert st_shared["scan_passes"] == 2
    assert st_shared["tables_streamed"] == 2
    per_pass = -(-30_000 // C.CHUNK) + -(-25_000 // C.CHUNK)
    assert st_shared["morsels"] == per_pass
    assert st_per["scan_passes"] == 4
    assert st_per["morsels"] == 2 * per_pass
    assert rows_close(res[0].to_pylist(),
                      sqlite_rows({k: tables[k] for k in
                                   ("dim", "ch_a", "ch_b")}, C.UNION2))


def test_semi_join_build_side_shares_pass(data):
    (fused, st_f), (unfused, _su), (per, st_p) = run_modes(data, C.SEMI)
    assert table_mismatches(unfused, fused) == []
    assert table_mismatches(per, fused) == []
    assert st_f["jobs"] == 2
    assert st_f["scan_passes"] == 1
    assert st_f["branches_served"] == 2
    assert st_f["morsels"] == C.PER_PASS
    assert st_p["morsels"] == 2 * C.PER_PASS
    assert rows_close(fused.to_pylist(), sqlite_rows(data["tables"], C.SEMI))


def test_fuse_group_unions_columns(data):
    """One group per big table, the union column set, and each member
    plan reading its subset through the shared morsel scan; the same
    groups as the reference's planner makes."""
    import nds_tpu_torch.engine.plan as P
    from nds_tpu.engine import streaming as rstreaming
    from nds_tpu.engine.planner import Planner as RPlanner
    from nds_tpu.sql import parse_sql as rparse

    ref, port, _ = C.sessions(data["tables"])
    jobs = streaming.find_streaming_jobs(
        port.plan(C.Q9), lambda t: port._est_rows.get(t, 0),
        port.config.out_of_core_min_rows)
    assert len(jobs) == C.Q9_JOBS
    groups = streaming.plan_scan_groups(jobs, shared=True)
    assert len(groups) == 1
    g = groups[0]
    assert g.table == "fact"
    assert set(g.columns) == {c for j in jobs for b in j.branches
                              for c in b.big_columns}
    assert {"day", "price", "qty"} <= set(g.columns)
    assert g.morsel_key == \
        streaming.MORSEL_TABLE + "//" + ",".join(g.columns)
    for member_plan in g.plans:
        scans = [n for n in P.iter_plan_nodes(member_plan)
                 if isinstance(n, P.ScanNode)
                 and n.table == streaming.MORSEL_TABLE]
        assert len(scans) == 1
        assert list(scans[0].columns) == list(g.columns)
    per = streaming.plan_scan_groups(jobs, shared=False)
    assert len(per) == C.Q9_JOBS
    assert all(len(p.members) == 1 for p in per)
    rjobs = rstreaming.find_streaming_jobs(
        RPlanner(ref._catalog()).plan_query(rparse(C.Q9)),
        lambda t: ref._est_rows.get(t, 0), ref.config.out_of_core_min_rows)
    rg = rstreaming.plan_scan_groups(rjobs, shared=True)
    assert [(x.table, x.columns, x.dtypes, x.members) for x in rg] == \
        [(x.table, x.columns, x.dtypes, x.members) for x in groups]


def test_upload_volume_shared_below_per_branch(data):
    port = C.sessions(data["tables"], shared_scan=True)[1]
    port.sql(C.Q9)
    shared_bytes = port.last_stats["bytes_uploaded"]
    port2 = C.sessions(data["tables"], shared_scan=False)[1]
    port2.sql(C.Q9)
    assert 0 < shared_bytes < port2.last_stats["bytes_uploaded"]


def test_live_config_toggle_invalidates_stream_cache(data):
    """The stream cache keys on a config fingerprint: toggling shared_scan,
    chunk_rows or the threshold on a live session replays no stale groups,
    programs or not-streamable sentinels, and closes the old slots."""
    from nds_tpu_torch.engine.torch_backend.device import open_slots
    s = C.sessions(data["tables"])[1]
    a = s.sql(C.Q9)
    assert s.last_stats["scan_passes"] == 1
    s.config.shared_scan = False
    b = s.sql(C.Q9)
    assert s.last_stats["scan_passes"] == C.Q9_JOBS
    assert table_mismatches(b, a) == []
    s.config.shared_scan = True
    s.config.chunk_rows = C.CHUNK * 2
    c = s.sql(C.Q9)
    assert s.last_stats["morsels"] == -(-C.N_FACT // (C.CHUNK * 2))
    assert table_mismatches(c, a) == []
    gc.collect()        # earlier tests' unreachable slots go first
    slots = open_slots()
    s.config.out_of_core_min_rows = C.N_FACT * 10
    s.sql(C.Q9)
    assert s.last_stats.get("mode") != "streamed"
    assert open_slots() == slots - 1
    s.config.out_of_core_min_rows = C.MIN_ROWS
    s.sql(C.Q9)
    assert s.last_stats["mode"] == "streamed"


def test_iter_morsels_single_slice_zero_copy(data, monkeypatch):
    """A morsel assembled from ONE pending slice passes through without
    pa.concat_tables (the aligned-batch common case)."""
    calls = {"n": 0}
    real = pa.concat_tables

    def counting(tables, *a, **k):
        calls["n"] += 1
        return real(tables, *a, **k)

    s = C.sessions(data["tables"])[1]
    monkeypatch.setattr(pa, "concat_tables", counting)
    morsels = list(s.iter_morsels("fact", ["fk", "day"], C.CHUNK))
    assert calls["n"] == 0
    assert sum(m.num_rows for m in morsels) == C.N_FACT
    assert max(m.num_rows for m in morsels) <= C.CHUNK
    morsels = list(s.iter_morsels("fact", ["fk"], 5_000))
    assert calls["n"] > 0
    assert sum(m.num_rows for m in morsels) == C.N_FACT
