#!/usr/bin/env python3
"""Smoke run of nds_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--sf 10] [--templates_sf 0.5] [--profile]
                          [--parent TREE] [--service_loop]

Phases, one JSON line each:

1. card and build: the card's name and power limit (nvidia-smi), and the
   three CUDA kernels compiled from nds_tpu_torch/csrc/ with nvcc;
2. data: NDS tables generated at --sf by the native generator into a
   temporary directory and registered from CSV, decimals as exact int64;
3. queries: NDS queries 3, 7, 9, 42, 55 and 96, and the queries of the
   window, set-operation and concatenation paths, 2, 5, 12, 38, 47, 51,
   67 and 87 (stream 0, template seed 3), through
   Session.sql(backend="torch") on the card, eager (``jit_plans=False``),
   strict (a node that falls back to the host fails the run), cold and
   warm, held against the port's numpy executor on the same session.
   The launch counters are zeroed just before and read just after, and
   every kernel must have launched;
3b. replay: the same queries on the same session through the compiled
   lifecycle (the default): one more eager warm run, then record,
   compile+run (the CUDA graph's capture) and three graph replays, every
   run held against the query phase's oracle results; the modes must
   follow the lifecycle, a unit may fall back to eager ("nojit") only for
   a reason the reference's traced program shares (NOJIT_SHARED), and
   every kernel must have been launched inside a capture. Per query: the
   walls, the replay's device time by CUDA events around the graph
   replays and its busy share, the graph pool's growth, peak memory and
   the kernels each capture launched. Counters zeroed just before, read
   just after;
3b'. service: on the same session, the concurrent query service
   (nds_tpu_torch.service) over the three dashboard templates of
   scripts/service_bench.py (store_qty, year_sales, category_rev over
   store_sales), a literal pool of 8 a template and one covering warm-up
   text a template, run twice: the first 96 of 480 queries drawn
   round-robin from the pool serially through Session.sql; then each
   template's held batches of 16, 2 and 13 distinct-literal tickets,
   each released at once and served as one batched dispatch over the
   rungs of the capacity ladder (16; 2; 8, 4 and 1), so that every
   batched graph is captured before the clients come, with the card's
   allocation peak of each (a capture of 16 rows beside one of 2); a
   kernel-coverage probe apart from the measured runs (a held batch of 4
   of a global aggregate of the same filter, the only shape here that
   reaches seg_reduce_multi); then 100 client threads on one QueryService
   at the reference's defaults submitting all 480 queries
   (``--service_loop``: then again with every distinct row of a batch
   its own replay of the single program's graph, then with the batched
   graphs again). Every result equals the serial result of its text bit
   for bit and one result of each distinct text the numpy oracle; the
   phase fails on a host fallback, a batch failure of another class than
   ReplayMismatch or "unavailable", no batched dispatch at 100 clients, a
   held batch not served as one dispatch over its rungs, a second capture
   of one (program, batch capacity), and a kernel never launched inside
   a batched capture. It reports the serial and service QPS with p50 and
   p99, queue waits, the batched dispatches and their sizes, dedup, the
   rows run, per (program, batch capacity) the capture's seconds and
   pool growth and the batched graph's ms, the busy share and peak
   memory. Counters zeroed just before, read just after;
3c. transcode: store_sales, catalog_sales and inventory from the CSV to
   Parquet (pyarrow on the host) in the temporary directory, registered
   with register_parquet on a new session (their row counts then come
   from the Parquet metadata; the other tables stay CSV);
3d. stream_default: at the reference's defaults (48M-row threshold,
   4,194,304-row morsels, packed narrow lanes with dictionary and
   run-length encodings) the SF10 units that scan inventory (133.1M
   rows): q21, q22, q37, q72 and q82 must stream it, 32 morsels a pass,
   and q39's two parts (no streaming job) run in-core over the whole
   table; each unit cold and three times warm, held against the numpy
   executor, which runs in two forked workers beside this phase and the
   ones after (q72's alone takes about 6 minutes), the checks at the end;
3e. stream_plain: q22 and q82 as in 3d but with ``narrow_lanes=False``
   (the plain slot: int64 data, a byte of validity a row), cold and once
   warm, then packed again the same way (beside the same host load),
   held against 3d's oracle results; a line sets their bytes uploaded,
   staging and decode times and warm walls beside both packed runs', and
   the plain runs must upload more bytes;
3f. stream_lowered: phase query's queries with the threshold at 10M rows:
   all but 12, 38 and 87 stream store_sales (7 morsels) or catalog_sales
   (4), cold and once warm, held against phase query's oracle
   results and phase replay's in-core results. Both streamed phases fail
   on a fallback, a prefetch error, a query expected to stream that ran
   in-core (or the reverse), and a graph capture on a warm pass, and
   report per unit the walls, morsels, bytes uploaded and the upload
   rate, the share of staging hidden under the runs, the host's decode
   and finalize, the device's busy share, re-records, captures and peak
   memory, and the wire layout (lane_spec, enc_spec, enc_bytes_saved,
   decode sites). With narrow_lanes on, every streamed table must ride
   packed lanes. Launch counters zeroed just before each, read just
   after;
4. spare slot: the first-row-per-group scatter at the largest call that
   queries 38 and 87 made, beside the reference's form of it (every row
   outside the mask on one spare slot), bit-identical;
5. kernels: each kernel on the largest inputs the query phase gave it in
   each regime (the sort with an int32 and an int64 key, the segment
   reduction as a global aggregate and grouped), and on edge cases, held
   bit-identical against its plain PyTorch version on the card, and timed
   beside the plain version, one PyTorch library call and the least time
   the card's memory rate allows, each on the device alone (``ms``) and
   with the host's enqueueing (``host_ms``); the largest call also
   captured alone in a CUDA graph, its replays bit-identical to the eager
   launch and timed (``graph_ms``). ``--parent TREE`` (repeatable) also
   times the kernels of other checkouts on the same inputs, in turns;
6. templates: every unit of the 99 NDS templates (103: four templates
   hold two statements) at --templates_sf (0.5 by default, to keep the
   smoke near 15 minutes beside the streamed phases), generated into the
   same temporary directory, eager cold and warm, then through the
   compiled lifecycle as in phase 3b, strict, held against the numpy
   executor, with the launch counters zeroed just before and read just
   after; the power run both ways (the eager warm walls, the replays'
   medians).

Then the deferred oracle checks of phase stream_default, the kernel table
as one JSON line (a row's launches: phase query's and the streamed
phases') and, last, the device line. Any
failure raises and exits non-zero; without CUDA the run stops at once.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

REPLACES = {
    "sort_pairs": "nds_tpu/engine/jax_backend/pallas_kernels.py:278",
    "seg_reduce_multi": "nds_tpu/engine/jax_backend/pallas_kernels.py:382",
    "take_many": "nds_tpu/engine/jax_backend/pallas_kernels.py:461",
}
#: the kernels redesigned for the card after their first port: their
#: edge cases are timed too, and their launches broken down by kernel
REDESIGNED = ("sort_pairs", "seg_reduce_multi")
#: the first slice's six queries, then the window (12, 47, 51, 67),
#: set-operation (2, 5, 38, 87) and concatenation (5) paths at full scale;
#: q67 runs first, so that its numpy oracle (two to three minutes at SF10,
#: the longest) starts while the others run (OracleForks)
QUERIES = (67, 3, 7, 9, 42, 55, 96, 2, 5, 12, 38, 47, 51, 87)
#: the queries whose largest first-row scatter the spare-slot phase times
SPARE_SLOT_QUERIES = (38, 87)
SEED = 3
#: graph replays after a unit's record and compile+run runs
REPLAYS = 3
#: why a unit may stay eager under replay: the reasons the reference's
#: traced program raises too (its dictionary would depend on the data)
NOJIT_SHARED = ("cast to string needs a data-dependent dictionary",
                "string scalar subquery under trace")
#: the card the bounds are computed for, and its memory rate (NVIDIA data
#: sheet), bytes/s
CARD = "H100 80GB HBM3"
MEM_RATE = 3.35e12


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line; ``t_s`` is the seconds since the smoke started."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": time.perf_counter() - _T0}), flush=True)


# ---------------------------------------------------------------------------
# recording the inputs the main path gives each kernel
# ---------------------------------------------------------------------------

class Recorder:
    """Wraps each kernel wrapper of cuda_kernels, and any other function
    given to ``wrap``, and keeps (a copy of) the inputs of its largest call
    in each regime, and the frames of the port that made it; the function
    itself runs unchanged. A sort's regime is its key type; a segment
    reduction's is decided after the run (``regimes``), since telling a
    global aggregate from a grouped one reads the gids back. ``label`` is
    the unit being run (set by run_units), for a regime keyed by it; a
    call whose regime is None is not kept."""

    def __init__(self, ck):
        self.ck = ck
        self.label = None
        self.largest: dict = {}
        self.calls: dict = {}
        self.orig: dict = {}
        self.mods: dict = {}
        for name, size, regime in (
                ("sort_pairs",
                 lambda k, i: int(k.shape[0]) * (k.element_size() + 4),
                 lambda k, i: f"{str(k.dtype)[6:]} key"),
                ("seg_reduce_multi",
                 lambda ops, g, s: int(g.shape[0]) * len(ops),
                 lambda ops, g, s: (s, int(g.shape[0]), len(ops))),
                ("take_many", lambda srcs, i: int(i.shape[0]) * len(srcs),
                 lambda srcs, i: "gather")):
            self.wrap(ck, name, size, regime)

    def wrap(self, mod, name, size, regime):
        orig = self.orig[name] = getattr(mod, name)
        self.mods[name] = mod

        def wrapped(*args, **kwargs):
            n = size(*args)
            key = (name, regime(*args))
            self.calls[name] = self.calls.get(name, 0) + 1
            if key[1] is not None and n > self.largest.get(key, (-1,))[0]:
                self.largest[key] = (n, _clone(args), kwargs, _callers())
            return orig(*args, **kwargs)
        setattr(mod, name, wrapped)

    def unwrap(self) -> None:
        """Put the wrapped functions back (a CUDA graph capture must not
        copy their inputs: a capture runs no kernel)."""
        for name, mod in self.mods.items():
            setattr(mod, name, self.orig[name])

    def regimes(self) -> dict:
        """{kernel: [(regime, args, kwargs, callers), ...]}, the largest call
        of each regime, largest first. A segment reduction is a global
        aggregate when its live rows (gid in [0, S)) all hold one gid."""
        best: dict = {}
        for (name, reg), (n, args, kwargs, callers) in self.largest.items():
            if name not in REPLACES:
                continue
            if name == "seg_reduce_multi":
                _, gid, S = args
                live = gid[(gid >= 0) & (gid < S)]
                one = live.numel() == 0 or bool((live == live[0]).all())
                reg = "global aggregate" if one else "grouped"
            if n > best.get((name, reg), (-1,))[0]:
                best[name, reg] = (n, args, kwargs, callers)
        out: dict = {}
        for (name, reg), (n, *call) in sorted(
                best.items(), key=lambda kv: -kv[1][0]):
            out.setdefault(name, []).append((reg, *call))
        return out


def _callers(depth: int = 3) -> str:
    """The innermost frames that led to the wrapped kernel call, as
    'file:line function < ...' (the recorder's own frame left out)."""
    frames = traceback.StackSummary.extract(
        traceback.walk_stack(sys._getframe(2)), limit=depth,
        lookup_lines=False)
    return " < ".join(f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                      for f in frames)


def _clone(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    return x


# ---------------------------------------------------------------------------
# timing and comparison
# ---------------------------------------------------------------------------

#: GPU clock cycles of the sleep that each timed call is enqueued behind
SLEEP_CYCLES = 5_000_000


def time_ms(fn, reps: int = 5, warm: int = 2) -> tuple[float, float]:
    """Median time of one call by CUDA events, two ways: (device, host).
    device: each call is enqueued while the device sleeps, so the events
    time its work on the device and not the host's enqueueing (a call that
    waits on the device itself, as the plain segment reduction does for
    NaNs, still counts its host time). host: the events bracket the call
    on an idle device, so where enqueueing outlasts the device's work the
    host's time counts, as a query's eager executor feels it."""
    import torch
    for _ in range(warm):
        fn()
    times: dict = {True: [], False: []}
    for sleep in (True, False):
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            if sleep:
                torch.cuda._sleep(SLEEP_CYCLES)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times[sleep].append(a.elapsed_time(b))
    return statistics.median(times[True]), statistics.median(times[False])


def same_bits(got, want) -> tuple[bool, float]:
    """(bit-identical, max abs difference) of two lists of tensors."""
    import torch
    ok, err = True, 0.0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            return False, float("inf")
        if g.dtype.is_floating_point:
            bits = torch.int64 if g.element_size() == 8 else torch.int32
            ok &= bool(torch.equal(g.view(bits), w.view(bits)))
            fin = torch.isfinite(g) & torch.isfinite(w)
            if bool(fin.any()):
                err = max(err, float((g[fin] - w[fin]).abs().max()))
        else:
            ok &= bool(torch.equal(g, w))
            if g.numel() and g.dtype != torch.bool:
                err = max(err, float((g.to(torch.float64) -
                                      w.to(torch.float64)).abs().max()))
    return ok, err


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card_build(ck) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    secs = ck.build()
    emit("build", seconds=time.perf_counter() - t0, per_source=secs,
         nvcc_flags=ck.NVCC_FLAGS)
    return smi


def phase_data(nt, sf: float, tmp: str, device: str = "cuda",
               name: str = "data"):
    from nds_tpu_torch import datagen
    data = os.path.join(tmp, name)
    t0 = time.perf_counter()
    datagen.generate(data, sf, parallel=len(os.sched_getaffinity(0)))
    gen_s = time.perf_counter() - t0
    session = nt.Session(nt.EngineConfig(decimal_physical="i64"),
                         device=device)
    names = datagen.setup_tables(session, data, use_decimal=True)
    emit(name, sf=sf, generate_s=gen_s, tables=len(names),
         csv_bytes=sum(os.path.getsize(os.path.join(r, f))
                       for r, _, fs in os.walk(data) for f in fs))
    return session


_FORKED: dict = {}


def _oracle(sql: str):
    t0 = time.perf_counter()
    want = _FORKED["session"].sql(sql, backend="numpy")
    return want, time.perf_counter() - t0


class OracleForks:
    """The numpy oracle of each unit in a process forked from this one
    as soon as the unit has run (so that it shares the host tables the
    unit loaded, and never touches the card), at most `workers` at a time,
    while the caller goes on; results() waits for all of them."""

    def __init__(self, session, workers: int):
        self.session, self.workers = session, workers
        self.queued: list = []          # (index, sql) not forked yet
        self.running: dict = {}         # connection -> (index, process)
        self.done: dict = {}            # index -> (result, seconds)

    def submit(self, sql: str) -> None:
        self.queued.append((len(self.queued) + len(self.running)
                            + len(self.done), sql))
        self._pump(block=False)

    def _fork(self, i: int, sql: str) -> None:
        import multiprocessing
        ctx = multiprocessing.get_context("fork")
        recv, send = ctx.Pipe(duplex=False)
        _FORKED["session"] = self.session
        try:
            proc = ctx.Process(target=_oracle_to, args=(sql, send))
            proc.start()
        finally:
            _FORKED.clear()
        send.close()
        self.running[recv] = (i, proc)

    def _pump(self, block: bool) -> None:
        from multiprocessing.connection import wait
        while self.queued or (block and self.running):
            while self.queued and len(self.running) < self.workers:
                self._fork(*self.queued.pop(0))
            ready = wait(list(self.running), timeout=None if block else 0)
            if not ready and not block:
                return
            for conn in ready:
                i, proc = self.running.pop(conn)
                out = conn.recv()
                proc.join()
                if isinstance(out, str):
                    raise SystemExit(f"oracle failed: {out}")
                self.done[i] = out

    def results(self) -> list:
        """[(the numpy executor's result, seconds)] in submission order."""
        self._pump(block=True)
        return [self.done[i] for i in sorted(self.done)]


def _oracle_to(sql: str, conn) -> None:
    try:
        conn.send(_oracle(sql))
    except BaseException:
        conn.send(traceback.format_exc())


def oracle_results(session, sqls: list) -> list:
    """[(the numpy executor's result, seconds)] for each query of `sqls`
    on `session`, in worker processes forked from this one: they share the
    host tables the session has loaded so far and never touch the card."""
    import multiprocessing
    _FORKED["session"] = session
    workers = min(len(sqls), max(1, len(os.sched_getaffinity(0)) - 2))
    try:
        with multiprocessing.get_context("fork").Pool(workers) as pool:
            return pool.map(_oracle, sqls, chunksize=1)
    finally:
        _FORKED.clear()         # the caller may free the session


def _sql_run(session, sql: str, jit: bool):
    """One Session.sql(backend="torch") on the card: (result, wall seconds
    ending in a synchronise, the session's stats, peak device GiB)."""
    import torch
    session.config.jit_plans = jit
    on_card = session.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = session.sql(sql, backend="torch")
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mem = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0.0
    return got, wall, dict(session.last_stats,
                           fallbacks=list(session.last_fallbacks)), mem


def _lifecycle_faults(name: str, stats: list) -> list:
    """Faults of one unit's compiled runs (their stats, in order): the
    modes must go record, compile+run (or compiled, when its units were
    compiled ahead), compiled...; a unit left eager must have a reason
    the reference shares."""
    faults = []
    modes = [st.get("mode") for st in stats]
    reasons = {st["nojit_reason"] for st in stats if st.get("nojit_reason")}
    for r in reasons:
        if not any(ok in r for ok in NOJIT_SHARED):
            faults.append(f"{name}: nojit for a reason the reference does "
                          f"not share: {r}")
    if reasons:
        return faults
    if modes[0] != "record" or modes[1] not in ("compile+run", "compiled") \
            or any(m != "compiled" for m in modes[2:]):
        faults.append(f"{name}: modes {modes} do not follow the lifecycle")
    return faults


def run_units(session, ck, units: list, phase: str, recorder=None,
              replay: bool = False, oracle=None,
              results: dict | None = None) -> dict:
    """Each (name, sql) of `units` through Session.sql(backend="torch"):
    eager (jit_plans=False) cold (loads and uploads included) and warm, or
    warm only when `oracle` holds the results (another phase ran them
    cold); with
    `replay`, then through the compiled lifecycle: record, compile+run and
    REPLAYS graph replays. The launch counters are zeroed just before the
    first run and read just after the last; then every result is held
    against the numpy executor (`oracle`, [(result, seconds)] in unit
    order, or oracle_results). One `phase` line per unit; fails after the
    last line if any unit fell back to the host, disagreed, or strayed
    from the lifecycle. Sets ``recorder.label`` to each unit's name while
    it runs; ``results`` ({unit: result}) receives each unit's last
    result. ``oracle`` may also be an OracleForks, given each unit's
    statement as soon as the unit has run. Returns (counter totals, the
    oracle results, the lines)."""
    from nds_tpu_torch.validate import table_mismatches
    runs, failed = [], []
    cold = oracle is None or isinstance(oracle, OracleForks)
    ck.reset_launches()                 # the path starts here
    for name, sql in units:
        if recorder is not None:
            recorder.label = name
        before = dict(ck.LAUNCHES)
        eager = [_sql_run(session, sql, False)
                 for _ in range(2 if cold else 1)]
        compiled = [_sql_run(session, sql, True)
                    for _ in range(2 + REPLAYS)] if replay else []
        for _, _, st, _ in eager + compiled:
            if st["fallbacks"]:
                failed.append(f"{name}: host fallback {st['fallbacks']}")
        if replay:
            failed += _lifecycle_faults(name, [r[2] for r in compiled])
        runs.append((eager, compiled, {k: ck.LAUNCHES[k] - before[k]
                                       for k in ck.LAUNCHES}))
        if results is not None:
            results[name] = (eager + compiled)[-1][0]
        if isinstance(oracle, OracleForks):
            oracle.submit(sql)
    totals = dict(ck.LAUNCHES)          # read just after the path
    if recorder is not None:
        recorder.label = None
    if isinstance(oracle, OracleForks):
        oracle = oracle.results()
    elif oracle is None:
        oracle = oracle_results(session, [sql for _, sql in units])
    lines = []
    for (name, _), (eager, compiled, launches), (want, oracle_s) in zip(
            units, runs, oracle):
        for i, (got, *_rest) in enumerate(eager + compiled):
            bad = table_mismatches(got, want)
            if bad:
                failed.append(f"{name} (run {i}) disagrees with the numpy "
                              f"oracle: {bad}")
        line = {"unit": name, "warm_s": eager[-1][1], "oracle_s": oracle_s,
                "rows": eager[-1][0].num_rows, "launches": launches,
                "peak_mem_gb": max(r[3] for r in eager + compiled)}
        if len(eager) == 2:
            line["cold_s"] = eager[0][1]
        if compiled:
            line.update(_replay_fields(compiled))
        emit(phase, **line)
        lines.append(line)
    if failed:
        raise SystemExit(f"{phase}: " + "\n".join(failed))
    missing = [k for k, v in totals.items() if v == 0]
    if missing:
        raise SystemExit(f"{phase}: kernels never launched: {missing}")
    if replay:
        captured = {k: sum(ln.get("captured_launches", {}).get(k, 0)
                           for ln in lines) for k in ck.LAUNCHES}
        missing = [k for k, v in captured.items() if v == 0]
        if missing:
            raise SystemExit(f"{phase}: kernels never launched inside a "
                             f"CUDA graph capture: {missing}")
    return totals, oracle, lines


def _replay_fields(compiled: list) -> dict:
    """One unit's compiled-lifecycle figures: the walls of record,
    compile+run and the replays (median), the replays' device time by
    CUDA events around each graph replay and its share of their wall, the
    capture's pool growth and the kernels it launched (a graph replays
    them without calling their wrappers)."""
    replays = compiled[2:]
    replay_s = statistics.median(r[1] for r in replays)
    graph_ms = statistics.median(r[2].get("graph_ms", 0.0) for r in replays)
    cap = compiled[1][2]
    return {"record_s": compiled[0][1], "compile_run_s": compiled[1][1],
            "capture_s": cap.get("capture_s"), "replay_s": replay_s,
            "replay_walls_s": [r[1] for r in replays],
            "graph_ms": graph_ms, "busy_share": graph_ms / 1e3 / replay_s,
            "pool_growth_gb": cap.get("pool_growth_bytes", 0) / 2 ** 30,
            "reserved_gb": _reserved_gb(),
            "modes": [r[2].get("mode") for r in compiled],
            "unit_modes": [r[2].get("unit_modes") for r in compiled[:2]],
            "nojit": sorted({r[2]["nojit_reason"] for r in compiled
                             if r[2].get("nojit_reason")}),
            "captured_launches": cap.get("captured_launches", {})}


def _reserved_gb() -> float:
    import torch
    return torch.cuda.memory_reserved() / 2 ** 30 \
        if torch.cuda.is_available() else 0.0


def query_units() -> list:
    from nds_tpu_torch import streams
    return [(f"query{q}", streams.instantiate(q, stream=0, rngseed=SEED))
            for q in QUERIES]


def phase_queries(session, ck, recorder=None):
    """QUERIES at the session's scale, eager: the main path of the kernel
    phase's inputs. The numpy oracle of each query runs in a process
    forked as soon as the query has run (three at a time), beside the
    later queries. Returns (counter totals, oracle results)."""
    totals, oracle, _ = run_units(session, ck, query_units(), "query",
                                  recorder, oracle=OracleForks(session, 3))
    emit("launches", totals=totals)
    return totals, oracle


def phase_replay(session, ck, oracle) -> dict:
    """QUERIES through the compiled lifecycle on the query phase's session
    (its scans resident), against its oracle results. Returns the counter
    totals with the capture launches summed over the queries, each
    query's replay wall (``walls``) and last result (``results``)."""
    results: dict = {}
    totals, _, lines = run_units(session, ck, query_units(), "replay",
                                 replay=True, oracle=oracle, results=results)
    captured = {k: sum(ln["captured_launches"].get(k, 0) for ln in lines)
                for k in ck.LAUNCHES}
    emit("replay_launches", totals=totals, captured=captured,
         eager_warm_s=sum(ln["warm_s"] for ln in lines),
         replay_s=sum(ln["replay_s"] for ln in lines))
    return {"totals": totals, "captured": captured, "results": results,
            "walls": {ln["unit"]: ln["replay_s"] for ln in lines}}


# ---------------------------------------------------------------------------
# the concurrent query service
# ---------------------------------------------------------------------------

#: the dashboard templates of scripts/service_bench.py (TEMPLATES), copied:
#: every hoistable literal varies per text, so the texts of a template
#: parameterize to one plan fingerprint
SERVICE_TEMPLATES = {
    "store_qty": (
        "SELECT ss_store_sk, COUNT(*) AS n, SUM(ss_quantity) AS q "
        "FROM store_sales WHERE ss_quantity BETWEEN {a} AND {b} "
        "GROUP BY ss_store_sk ORDER BY ss_store_sk"),
    "year_sales": (
        "SELECT d_year, COUNT(*) AS n, SUM(ss_quantity) AS q "
        "FROM store_sales JOIN date_dim ON ss_sold_date_sk = d_date_sk "
        "WHERE ss_quantity < {a} GROUP BY d_year ORDER BY d_year"),
    "category_rev": (
        "SELECT i_category, COUNT(*) AS n, "
        "SUM(ss_ext_sales_price) AS rev "
        "FROM store_sales JOIN item ON ss_item_sk = i_item_sk "
        "WHERE ss_quantity BETWEEN {a} AND {b} "
        "GROUP BY i_category ORDER BY i_category"),
}
#: a kernel-coverage probe, not traffic: the port aggregates the three
#: templates' groups over sorted keys with a scan, so none of them reaches
#: seg_reduce_multi, which a global aggregate of the same filter does. Its
#: own held batch runs apart from every measured run, and counts only
#: toward the launches made inside batched captures
COVERAGE_PROBE = (
    "SELECT COUNT(*) AS n, SUM(ss_quantity) AS q, "
    "SUM(ss_ext_sales_price) AS rev "
    "FROM store_sales WHERE ss_quantity BETWEEN {a} AND {b}")
COVERAGE_ROWS = 4
#: texts of each template in the literal pool (service_bench's
#: POOL_PER_TEMPLATE), queries drawn from it, the first of them run
#: serially (four of each pool text: the baseline's QPS), and client threads
SERVICE_POOL = 8
SERVICE_QUERIES = 480
SERVICE_SERIAL = 96
SERVICE_CLIENTS = 100
#: each template's held batches, in turn: ServiceConfig.max_batch (one
#: graph of 16 rows), 2, and 13 (graphs of 8, 4 and 1), so that every
#: rung's batched graph is captured before the clients come, and the
#: capture of 16 rows stands beside that of 2 rows for its memory
SERVICE_HELD = (16, 2, 13)
#: batch failures that are the service's normal life: no program yet, and a
#: row past the schedule (both then served serially)
BATCH_ERRORS_OK = ("unavailable", "ReplayMismatch")


def service_pool() -> list:
    """[(label, sql)] as service_bench.build_pool makes it: a = 20 + i,
    b = 60 + 2i."""
    return [(f"{name}#{i}", tpl.format(a=20 + i, b=60 + 2 * i))
            for name, tpl in SERVICE_TEMPLATES.items()
            for i in range(SERVICE_POOL)]


def service_warm() -> list:
    """service_bench.warm_texts: one text a template whose filter holds
    every pool text's, so its schedule covers the pool."""
    a_min, a_max = 20, 20 + SERVICE_POOL - 1
    b_max = 60 + 2 * (SERVICE_POOL - 1)
    cover = {"store_qty": dict(a=a_min, b=b_max),
             "year_sales": dict(a=a_max, b=b_max),
             "category_rev": dict(a=a_min, b=b_max)}
    return [(f"warm-{name}", tpl.format(**cover[name]))
            for name, tpl in SERVICE_TEMPLATES.items()]


def service_held() -> dict:
    """{template: max(SERVICE_HELD) distinct texts}: the pool's, then as
    many again inside the warm-up's filter (so no row outgrows the
    covering schedule): b one lower, or (year_sales) a below the pool's.
    A held batch of k takes the first k."""
    out = {}
    for name, tpl in SERVICE_TEMPLATES.items():
        more = max(SERVICE_HELD) - SERVICE_POOL
        lits = [dict(a=20 + i, b=60 + 2 * i) for i in range(SERVICE_POOL)]
        if name == "year_sales":
            lits += [dict(a=20 - more + i) for i in range(more)]
        else:
            lits += [dict(a=20 + i, b=59 + 2 * i) for i in range(more)]
        out[name] = [tpl.format(**kw) for kw in lits]
    return out


def _pct(vals: list, p: float):
    if not vals:
        return None
    v = sorted(vals)
    return v[min(len(v) - 1, int(p * len(v)))]


def loop_param_batch(ex, fp, rows):
    """The alternative to batched graphs that ``--service_loop`` measures
    (TorchExecutor.run_param_batch's signature): the executor's own single
    program, its CUDA graph, replayed once per distinct row, each row
    fetched and checked on its own."""
    from nds_tpu_torch.engine.torch_backend import compiled
    with compiled._SHARED_LOCK:
        sh = compiled._SHARED_PROGRAMS.get(fp)
        cq = compiled.shared_program(sh, ex) if sh is not None else None
    if cq is None or not ex._jit_plans:
        return None
    scans = ex._scans_for({"scan_keys": cq.scan_keys})
    outs, graph_ms = [], 0.0
    for row in rows:
        st: dict = {}
        outs.append(cq.run(scans, row, stats=st))
        graph_ms += st.get("graph_ms", 0.0)
    ex.fallback_nodes = []
    ex.last_stats = {"mode": "batched", "batch_rows": len(rows),
                     "batch_caps": (), "graphs": [], "graph_ms": graph_ms}
    return outs


def _held_dispatch(svc, texts: list, label: str, on_card: bool):
    """Submit `texts` while the device lane is held, release them at once
    and wait for every result: (tickets, the bytes allocated on the card
    at the dispatch's peak above those allocated before it, the peak
    before it)."""
    import torch
    with svc.hold_dispatch():
        ts = [svc.submit(sql, label=f"{label}-{i}")
              for i, sql in enumerate(texts)]
        deadline = time.time() + 60
        while time.time() < deadline:
            with svc._cv:
                if len(svc._ready) >= len(ts):
                    break
            time.sleep(0.005)
        base = peak0 = 0
        if on_card:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            peak0 = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
    for t in ts:
        t.result(timeout=300)
    grown = torch.cuda.max_memory_allocated() - base if on_card else 0
    return ts, grown, peak0


def _client_run(svc, workload: list, tag: str):
    """SERVICE_CLIENTS client threads, each submitting its share of
    `workload` one query at a time: (tickets, client walls, wall, errors)."""
    import threading
    shares = [workload[c::SERVICE_CLIENTS] for c in range(SERVICE_CLIENTS)]
    tickets: list = []
    lat: list = []
    errors: list = []
    lock = threading.Lock()

    def client(cid):
        for i, sql in enumerate(shares[cid]):
            q0 = time.perf_counter()
            try:
                t = svc.submit(sql, label=f"{tag}{cid}-{i}")
                t.result(timeout=600)
            except Exception as e:          # reported by the caller
                errors.append(f"{tag} client {cid}: {type(e).__name__}: {e}")
                continue
            with lock:
                tickets.append(t)
                lat.append(time.perf_counter() - q0)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVICE_CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return tickets, lat, time.perf_counter() - t0, errors


def _run_fields(tickets: list, lat: list, wall: float) -> dict:
    """One run of the clients' figures: QPS, client walls and queue waits,
    modes, batched dispatches and their sizes, rows run, busy share (the
    device time of the graphs the run replayed over its wall)."""
    leaders: dict = {}
    for t in tickets:
        if t.stats.mode == "batched":
            leaders.setdefault(t.stats.extra["batch_leader"], t)
    sizes: dict = {}
    for t in leaders.values():
        n = t.stats.batched_with + 1
        sizes[n] = sizes.get(n, 0) + 1
    graph_s = (sum(t.stats.extra.get("graph_ms", 0.0)
                   for t in leaders.values())
               + sum(t.stats.extra.get("graph_ms", 0.0) for t in tickets
                     if t.stats.mode != "batched")) / 1e3
    waits = [t.stats.queue_wait_ms for t in tickets
             if t.stats.queue_wait_ms is not None]
    return {
        "wall_s": wall, "qps": len(tickets) / wall,
        "p50_ms": _pct(lat, 0.5) * 1e3, "p99_ms": _pct(lat, 0.99) * 1e3,
        "queue_wait_p50_ms": _pct(waits, 0.5),
        "queue_wait_p99_ms": _pct(waits, 0.99),
        "modes": {m: sum(t.stats.mode == m for t in tickets)
                  for m in sorted({t.stats.mode for t in tickets})},
        "batched_dispatches": len(leaders),
        "batch_sizes": dict(sorted(sizes.items())),
        "distinct_rows": sum(t.stats.extra["batch_rows"]
                             for t in leaders.values()),
        "dedup": sum(t.stats.extra["dedup"] for t in leaders.values()),
        "graphs_replayed": sum(len(t.stats.extra["graphs"])
                               for t in leaders.values()),
        "busy_share": graph_s / wall}


def phase_service(session, ck, loop: bool = False) -> dict:
    """The query service on the replay phase's SF10 session: the three
    dashboard templates' covering warm-up texts twice each, the first
    SERVICE_SERIAL of SERVICE_QUERIES queries drawn round-robin from the
    pool serially through Session.sql, then each template's held batches
    (SERVICE_HELD: every rung's batched graph captured, the batch of 16
    one graph, batched_with 15), the coverage probe's held batch, then
    SERVICE_CLIENTS client threads on one QueryService at the reference's
    defaults submitting all SERVICE_QUERIES. With ``loop`` the clients run
    twice more, with the loop form of batching (loop_param_batch) and
    then the batched graphs again. Every result must equal the serial
    result of its text bit for bit, and one result of each distinct text
    the numpy oracle. Fails on a host fallback, a batch failure of another
    class than BATCH_ERRORS_OK, no batched dispatch at SERVICE_CLIENTS
    clients, a held batch not served as one batched dispatch over the
    rungs batch_rungs gives, a second capture of one (program, batch
    capacity), and a kernel never launched inside a batched capture.
    Launch counters zeroed just before, read just after. Returns the
    counter totals and the launches made inside batched captures."""
    import torch
    from nds_tpu_torch.engine.torch_backend import compiled
    from nds_tpu_torch.engine.torch_backend.executor import TorchExecutor
    from nds_tpu_torch.service import QueryService, ServiceConfig
    from nds_tpu_torch.validate import table_mismatches
    on_card = session.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    ck.reset_launches()                 # the path starts here
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    session.config.jit_plans = True
    failed: list = []
    pool, held = service_pool(), service_held()
    probe = [COVERAGE_PROBE.format(a=20 + i, b=60 + 2 * i)
             for i in range(COVERAGE_ROWS)]
    workload = [pool[i % len(pool)][1] for i in range(SERVICE_QUERIES)]
    t0 = time.perf_counter()
    warm = [sql for _l, sql in service_warm()] + [
        COVERAGE_PROBE.format(a=20, b=60 + 2 * (COVERAGE_ROWS - 1))]
    for sql in warm:
        for _ in range(2):              # record, then compile+run
            session.sql(sql)
            failed += [f"warm-up: host fallback {session.last_fallbacks}"] \
                if session.last_fallbacks else []
    warm_s = time.perf_counter() - t0
    # serial: one query at a time on the session
    serial: dict = {}
    lat = []
    t0 = time.perf_counter()
    for sql in workload[:SERVICE_SERIAL]:
        q0 = time.perf_counter()
        got = session.sql(sql)
        sync()
        lat.append(time.perf_counter() - q0)
        if session.last_fallbacks:
            failed.append(f"serial: host fallback {session.last_fallbacks}")
        if sql not in serial:
            serial[sql] = got
        elif got.to_pylist() != serial[sql].to_pylist():
            failed.append(f"serial repeats differ: {sql}")
    serial_s = time.perf_counter() - t0
    tickets: list = []
    names: dict = {}
    held_peaks: dict = {}
    phase_peak = 0
    runs: dict = {}
    svc = QueryService(session, ServiceConfig())
    with svc:
        # the held batches: each released at once, one batched dispatch
        for name, texts in list(held.items()) + [("kpi (probe)", probe)]:
            sizes = SERVICE_HELD if name in held else (len(texts),)
            for k in sizes:
                ts, grown, peak0 = _held_dispatch(
                    svc, texts[:k], f"held-{name}-{k}", on_card)
                phase_peak = max(phase_peak, peak0)
                tickets += ts
                names[ts[0].fp] = name
                caps = {t.stats.extra.get("batch_caps") for t in ts}
                held_peaks[f"{name} held {k}"] = {
                    "caps": ts[0].stats.extra.get("batch_caps"),
                    "peak_gb": grown / 2 ** 30}
                bw = sorted({t.stats.batched_with for t in ts})
                if any(t.stats.mode != "batched" for t in ts) or \
                        bw != [k - 1] or \
                        caps != {tuple(compiled.batch_rungs(k))}:
                    failed.append(
                        f"held {name} {k}: modes "
                        f"{sorted({t.stats.mode for t in ts})}, batched_with "
                        f"{bw}, capacities {caps}")
        # SERVICE_CLIENTS clients submitting the whole workload
        batched = TorchExecutor.run_param_batch
        for tag in ["graphs"] + (["loop", "graphs again"] if loop else []):
            if tag == "loop":
                TorchExecutor.run_param_batch = loop_param_batch
            try:
                ts, lat_c, wall, errors = _client_run(svc, workload,
                                                      tag[0])
            finally:
                TorchExecutor.run_param_batch = batched
            runs[tag] = (ts, lat_c, wall)
            failed += errors
            tickets += ts
    totals = dict(ck.LAUNCHES)          # read just after the path
    peak_gb = max(phase_peak, torch.cuda.max_memory_allocated()) / 2 ** 30 \
        if on_card else 0.0
    # bit-identical to serial (a text the serial run did not have runs
    # serially now); then each distinct text against the oracle
    for t in tickets:
        if t.query not in serial:
            serial[t.query] = session.sql(t.query)
        if t.result().to_pylist() != serial[t.query].to_pylist():
            failed.append(f"{t.label} differs from serial: {t.query}")
    firsts: dict = {}
    for t in tickets:
        firsts.setdefault(t.query, t.result())
    for st in [t.stats for t in tickets]:
        if st.fallback_reasons:
            failed.append(f"service: host fallback {st.fallback_reasons}")
    errs: dict = {}
    for t in tickets:
        e = t.stats.extra.get("batch_error")
        if e is not None:
            errs[e] = errs.get(e, 0) + 1
    bad = {e: n for e, n in errs.items() if e not in BATCH_ERRORS_OK}
    if bad:
        failed.append(f"batch failures {bad}")
    for tag in ("graphs", "graphs again"):
        if tag in runs and not any(t.stats.mode == "batched"
                                   for t in runs[tag][0]):
            failed.append(f"no batched dispatch at {SERVICE_CLIENTS} "
                          f"clients ({tag})")
    # per (program, capacity): its captures and its graph's ms
    leaders: dict = {}
    for t in tickets:
        if t.stats.mode == "batched":
            leaders.setdefault(t.stats.extra["batch_leader"], t)
    programs: dict = {}
    captured = {k: 0 for k in ck.LAUNCHES}
    for lead in leaders.values():
        for g in lead.stats.extra["graphs"]:
            key = f"{names.get(lead.fp, lead.fp[:12])}@{g['cap']}"
            pr = programs.setdefault(key, {"graphs": 0, "captures": 0,
                                           "graph_ms": []})
            pr["graphs"] += 1
            pr["graph_ms"].append(g.get("graph_ms", 0.0))
            if "capture_s" in g:
                pr["captures"] += 1
                pr["capture_s"] = g["capture_s"]
                pr["pool_growth_gb"] = g["pool_growth_bytes"] / 2 ** 30
                for k, v in g["captured_launches"].items():
                    captured[k] += v
    for key, pr in programs.items():
        if pr["captures"] > 1:
            failed.append(f"{key}: captured {pr['captures']} times")
        pr["graph_ms"] = statistics.median(pr["graph_ms"])
    missing = [k for k, v in captured.items() if v == 0]
    if missing:
        failed.append(f"kernels never launched inside a batched capture: "
                      f"{missing}")
    t0 = time.perf_counter()
    texts = sorted(firsts)
    oracle = oracle_results(session, texts)
    for sql, (want, _s) in zip(texts, oracle):
        mism = table_mismatches(firsts[sql], want)
        if mism:
            failed.append(f"disagrees with the numpy oracle: {sql}: {mism}")
    line = {
        "queries": SERVICE_QUERIES, "clients": SERVICE_CLIENTS,
        "distinct_texts": len(texts), "warm_s": warm_s,
        "serial_queries": SERVICE_SERIAL,
        "serial_s": serial_s, "serial_qps": SERVICE_SERIAL / serial_s,
        "serial_p50_ms": _pct(lat, 0.5) * 1e3,
        "serial_p99_ms": _pct(lat, 0.99) * 1e3,
        "service": {tag: _run_fields(*runs[tag]) for tag in runs},
        "batch_errors": errs, "programs": programs,
        "held_peaks": held_peaks, "peak_mem_gb": peak_gb,
        "launches": totals, "batched_captured_launches": captured,
        "oracle_s": time.perf_counter() - t0}
    emit("service", **line)
    if failed:
        raise SystemExit("service: " + "\n".join(failed[:20]))
    return {"totals": totals, "captured": captured}


# ---------------------------------------------------------------------------
# the streamed (out-of-core) path
# ---------------------------------------------------------------------------

#: the tables the streamed phases read from Parquet (their row counts then
#: come from its metadata), transcoded from the generated CSV
STREAMED_TABLES = ("store_sales", "catalog_sales", "inventory")
#: Parquet row groups of the transcode: one per default morsel
ROW_GROUP_ROWS = 1 << 22
#: the SF10 units that scan inventory: five stream it at the default
#: settings, and q39's two parts find no streaming job and run in-core
STREAM_DEFAULT = ("query21", "query22", "query37", "query72", "query82")
#: the units phase stream_plain runs again with narrow_lanes off
STREAM_PLAIN = ("query22", "query82")
INCORE_DEFAULT = ("query39_part1", "query39_part2")
#: the threshold of phase stream_lowered, over which store_sales (28.8M
#: rows at SF10) and catalog_sales (14.4M) stream too, but not web_sales
#: (7.2M); of QUERIES, 12 (web_sales only), 38 and 87 find no streaming
#: job and run in-core
LOWERED_MIN_ROWS = 10_000_000
INCORE_LOWERED = ("query12", "query38", "query87")
#: warm runs of each unit after its cold run: three in stream_default,
#: one in stream_lowered (its 14 queries replay in phase replay already)
WARM_PASSES = 3
WARM_PASSES_LOWERED = 1


def phase_transcode(tmp: str, name: str = "data") -> dict:
    """STREAMED_TABLES from the generated CSV to Parquet (pyarrow on the
    host, four files at a time), one file for each CSV file. Returns
    {table: directory}."""
    from concurrent.futures import ThreadPoolExecutor

    import pyarrow.csv as pa_csv
    import pyarrow.parquet as pq
    from nds_tpu_torch.schema import get_schemas

    def one(job):
        schema, src, target = job
        t = pa_csv.read_csv(
            src,
            read_options=pa_csv.ReadOptions(
                column_names=[c.name for c in schema]),
            parse_options=pa_csv.ParseOptions(delimiter="|"),
            convert_options=pa_csv.ConvertOptions(
                column_types={c.name: c.type for c in schema},
                null_values=[""], strings_can_be_null=True))
        pq.write_table(t, target, row_group_size=ROW_GROUP_ROWS)
        return t.num_rows, os.path.getsize(target)

    t0 = time.perf_counter()
    out, jobs = {}, []
    for table in STREAMED_TABLES:
        schema = get_schemas(True)[table].arrow_schema(use_decimal=True)
        src = os.path.join(tmp, name, table)
        out[table] = os.path.join(tmp, "parquet", table)
        os.makedirs(out[table])
        jobs += [(table, (schema, os.path.join(src, f),
                          os.path.join(out[table], f + ".parquet")))
                 for f in sorted(os.listdir(src))
                 if os.path.getsize(os.path.join(src, f)) > 0]
    with ThreadPoolExecutor(4) as pool:
        done = list(pool.map(one, [job for _, job in jobs]))
    rows = {t: sum(n for (tt, _), (n, _) in zip(jobs, done) if tt == t)
            for t in STREAMED_TABLES}
    emit("transcode", seconds=time.perf_counter() - t0, rows=rows,
         parquet_bytes=sum(b for _, b in done))
    return out


def stream_session(nt, tmp: str, parquet: dict, device: str = "cuda",
                   name: str = "data"):
    """A session over the generated data, STREAMED_TABLES from Parquet."""
    from nds_tpu_torch import datagen
    session = nt.Session(nt.EngineConfig(decimal_physical="i64"),
                         device=device)
    datagen.setup_tables(session, os.path.join(tmp, name), use_decimal=True)
    for table, path in parquet.items():
        session.register_parquet(table, path)
    return session


def oracle_async(session, sqls: list, workers: int):
    """oracle_results for `sqls`, started now in `workers` processes
    forked from this one, which goes on meanwhile; returns (pool,
    AsyncResult)."""
    import multiprocessing
    _FORKED["session"] = session
    try:
        pool = multiprocessing.get_context("fork").Pool(workers)
    finally:
        _FORKED.clear()
    return pool, pool.map_async(_oracle, sqls, chunksize=1)


def _streamed_fields(runs: list) -> dict:
    """One streamed unit's figures: the cold run and the median of the
    warm ones."""
    def med(key):
        vals = [r[2][key] for r in runs[1:] if r[2].get(key) is not None]
        return statistics.median(vals) if vals else None
    cold = runs[0][2]
    gbps = [r[2]["bytes_uploaded"] / r[2]["upload_ms"] / 1e6
            for r in runs[1:] if r[2].get("upload_ms")]
    return {"warm_s": statistics.median(r[1] for r in runs[1:]),
            "morsels": cold["morsels"],
            "morsels_per_table": cold["morsels_per_table"],
            "jobs": cold["jobs"], "scan_passes": cold["scan_passes"],
            "fused_groups": cold["fused_groups"],
            "bytes_uploaded": cold["bytes_uploaded"],
            "upload_gb_s": statistics.median(gbps) if gbps else None,
            "stage_hidden_share": med("stage_hidden_share"),
            "host_decode_ms": statistics.median(
                sum(r[2]["host_decode_ms"].values()) for r in runs[1:]),
            "stage_ms": med("stage_ms"), "finalize_ms": med("finalize_ms"),
            "busy_share": med("busy_share"), "graph_ms": med("graph_ms"),
            "cold_busy_share": cold.get("busy_share"),
            "re_records": [r[2]["re_records"] for r in runs],
            "captures": [r[2]["captures"] for r in runs],
            "captured_launches": cold.get("captured_launches", {}),
            "graph_launches": runs[-1][2].get("graph_launches", {}),
            "narrow_lanes": cold.get("narrow_lanes"),
            "lane_spec": cold.get("lane_spec"),
            "enc_spec": cold.get("enc_spec"),
            "enc_bytes_saved": cold.get("enc_bytes_saved"),
            "decode_sites": [r[2].get("decode_sites") for r in runs],
            "decode_rows": [r[2].get("decode_rows") for r in runs],
            "dict_uploads": [r[2].get("dict_uploads") for r in runs]}


def run_stream_units(session, ck, units: list, phase: str, streamed: tuple,
                     oracle=None, incore: dict | None = None,
                     incore_walls: dict | None = None,
                     preload: tuple = (), deferred: tuple = (),
                     warm: int = WARM_PASSES,
                     oracle_from: dict | None = None,
                     every_kernel: bool = True):
    """Each (name, sql) of `units` through Session.sql(backend="torch"),
    cold and then `warm` times warm, with the launch counters zeroed
    just before the first run and read just after the last. A unit of
    `streamed` must stream on every run, with no fallback, no prefetch
    error and no CUDA graph capture after its cold run; any other must run
    in-core. Every result is held against the numpy executor (`oracle`,
    [(result, seconds)] in unit order, or oracle_results after the runs)
    and, where `incore` ({unit: result}) has the unit, against its in-core
    result. One `phase` line per unit, beside its in-core replay wall
    where `incore_walls` has it. The tables of `preload` are loaded whole
    on the host first, so that the oracle's workers share them; the
    oracle of the units of `deferred` (in that order) starts then, in two
    workers that run beside everything after, and their lines wait for
    it; with `oracle_from` ({unit: (result, seconds)}, which another
    phase's finish fills) no workers start and the deferred units are
    checked against it. With narrow_lanes on, every table a streamed run
    streams must ride packed lanes. Each kernel must have launched in the
    phase where `every_kernel`. Returns (counter totals, captured
    launches, a function that checks and emits the deferred units, fills
    the oracle store and returns their lines, the oracle store, and
    {unit: _streamed_fields} of the streamed units)."""
    from nds_tpu_torch.validate import table_mismatches
    t0 = time.perf_counter()
    for table in preload:
        session.load_table(table)
    sqls = dict(units)
    later = [(n, sqls[n]) for n in deferred]
    pending = oracle_async(session, [sql for _, sql in later], 2) \
        if later and oracle_from is None else None
    store: dict = {}
    emit(f"{phase}_oracle_start", preload=list(preload),
         seconds=time.perf_counter() - t0, deferred=[n for n, _ in later])
    runs, failed = {}, []
    ck.reset_launches()                 # the path starts here
    for name, sql in units:
        before = dict(ck.LAUNCHES)
        rr = [_sql_run(session, sql, True) for _ in range(1 + warm)]
        runs[name] = (rr, {k: ck.LAUNCHES[k] - before[k]
                           for k in ck.LAUNCHES})
        for i, (_, _, st, _) in enumerate(rr):
            mode = st.get("mode")
            if st["fallbacks"]:
                failed.append(f"{name} (run {i}): host fallback "
                              f"{st['fallbacks']}")
            if name not in streamed:
                if mode == "streamed":
                    failed.append(f"{name} (run {i}) streamed, expected "
                                  "in-core")
                continue
            if mode != "streamed":
                failed.append(f"{name} (run {i}) ran {mode}, not streamed"
                              f" ({st.get('stream_refused')})")
                continue
            if st["prefetch_error_details"]:
                failed.append(f"{name} (run {i}): prefetch errors "
                              f"{st['prefetch_error_details']}")
            if i > 0 and st["captures"]:
                failed.append(f"{name} (run {i}): {st['captures']} "
                              "captures on a warm pass")
            if session.config.narrow_lanes and \
                    set(st["lane_spec"]) != set(st["morsels_per_table"]):
                failed.append(f"{name} (run {i}): streamed tables "
                              f"{sorted(st['morsels_per_table'])} but packed "
                              f"{sorted(st['lane_spec'])}")
    totals = dict(ck.LAUNCHES)          # read just after the path
    fields = {n: _streamed_fields(runs[n][0]) for n in runs
              if n in streamed and runs[n][0][0][2].get("mode") == "streamed"}

    def check(name: str, want, oracle_s: float) -> dict:
        rr, launches = runs[name]
        bad = []
        for i, (got, *_rest) in enumerate(rr):
            mm = table_mismatches(got, want)
            if mm:
                bad.append(f"{name} (run {i}) disagrees with the numpy "
                           f"oracle: {mm}")
            if incore is not None and name in incore:
                mm = table_mismatches(got, incore[name])
                if mm:
                    bad.append(f"{name} (run {i}) disagrees with its "
                               f"in-core result: {mm}")
        store[name] = (want, oracle_s)
        line = {"unit": name, "mode": rr[0][2].get("mode"),
                "cold_s": rr[0][1],
                "warm_s": statistics.median(r[1] for r in rr[1:]),
                "warm_walls_s": [r[1] for r in rr[1:]],
                "incore_replay_s": (incore_walls or {}).get(name),
                "rows": rr[-1][0].num_rows, "oracle_s": oracle_s,
                "peak_mem_gb": max(r[3] for r in rr), "launches": launches}
        if name in fields:
            line.update(fields[name])
        else:
            line["modes"] = [r[2].get("mode") for r in rr]
        emit(phase, **line)
        failed.extend(bad)
        return line

    now = [(n, sql) for n, sql in units if n not in deferred]
    if oracle is None and now:
        oracle = oracle_results(session, [sql for _, sql in now])
    lines = [check(name, *o) for (name, _), o in zip(now, oracle or [])]
    if failed:
        raise SystemExit(f"{phase}: " + "\n".join(failed))
    missing = [k for k, v in totals.items() if v == 0]
    if missing and every_kernel:
        raise SystemExit(f"{phase}: kernels never launched: {missing}")
    captured = {k: sum(ln.get("captured_launches", {}).get(k, 0)
                       for ln in lines) for k in ck.LAUNCHES}

    def finish() -> list:
        if not later:
            return []
        t1 = time.perf_counter()
        if pending is None:
            got = [oracle_from[name] for name, _ in later]
        else:
            pool, res = pending
            got = res.get()
            pool.close()
            pool.join()
        out = [check(name, *o) for (name, _), o in zip(later, got)]
        emit(f"{phase}_deferred_oracle", units=[n for n, _ in later],
             waited_s=time.perf_counter() - t1)
        if failed:
            raise SystemExit(f"{phase}: " + "\n".join(failed))
        for ln in out:
            for k in captured:
                captured[k] += ln.get("captured_launches", {}).get(k, 0)
        return out
    return totals, captured, finish, store, fields


def phase_stream_default(session, ck, scale: float = 1.0) -> dict:
    """The SF10 units that scan inventory (stream 0) at the reference's
    defaults (``scale`` < 1 scales the threshold and the morsel with a
    smaller --sf): STREAM_DEFAULT stream it, INCORE_DEFAULT run in-core
    over the whole table. Their numpy oracle (q72's alone about 370 s at
    SF10, the others 10-100 s each) runs in two workers beside this
    phase's runs and the phases that follow; ``finish`` checks the units
    against it."""
    from nds_tpu_torch import streams
    cfg = session.config
    cfg.out_of_core_min_rows = int(48_000_000 * scale)
    cfg.chunk_rows = max(1024, int((1 << 22) * scale))
    names = STREAM_DEFAULT + INCORE_DEFAULT
    units = [(n, sql) for n, sql in streams.template_units(
        stream=0, rngseed=SEED) if n in names]
    totals, captured, finish, store, fields = run_stream_units(
        session, ck, units, "stream_default", STREAM_DEFAULT,
        preload=("inventory",),
        # the longest first: q72 takes one worker, the rest the other
        deferred=("query72", "query22", "query39_part1", "query39_part2",
                  "query21", "query37", "query82"))
    emit("stream_default_launches", totals=totals)
    return {"totals": totals, "captured": captured, "finish": finish,
            "oracle": store, "fields": fields, "units": units}


def phase_stream_plain(session, ck, default: dict) -> dict:
    """STREAM_PLAIN as phase stream_default ran them, but with
    narrow_lanes off (the plain slot), cold and once warm, then packed
    again (cold, once warm) right after, so that one packed run and the
    plain run share the host's load (the oracle's workers run beside);
    each held against stream_default's oracle results when its finish
    has run. One line sets the plain figures beside both packed runs',
    and the plain runs must upload more bytes."""
    units = [(n, sql) for n, sql in default["units"] if n in STREAM_PLAIN]
    out = {}
    for phase, narrow in (("stream_plain", False),
                          ("stream_plain_packed", True)):
        session.config.narrow_lanes = narrow
        try:
            out[phase] = run_stream_units(
                session, ck, units, phase, STREAM_PLAIN,
                deferred=STREAM_PLAIN, warm=1,
                oracle_from=default["oracle"], every_kernel=False)
        finally:
            session.config.narrow_lanes = True
    keys = ("bytes_uploaded", "warm_s", "stage_ms", "host_decode_ms",
            "upload_gb_s", "stage_hidden_share", "busy_share", "graph_ms")
    fields = {"stream_default": default["fields"],
              "stream_plain": out["stream_plain"][4],
              "stream_plain_packed": out["stream_plain_packed"][4]}
    compare = {}
    for name in STREAM_PLAIN:
        compare[name] = {ph: {k: f[name].get(k) for k in keys}
                         for ph, f in fields.items()}
        compare[name]["packed_lane_spec"] = default["fields"][name][
            "lane_spec"]
        compare[name]["packed_enc_spec"] = default["fields"][name][
            "enc_spec"]
        plain = fields["stream_plain"][name]["bytes_uploaded"]
        packed = fields["stream_default"][name]["bytes_uploaded"]
        if plain <= packed:
            raise SystemExit(f"stream_plain: {name} uploaded {plain} bytes "
                             f"plain, not more than {packed} packed")
    emit("stream_plain_vs_packed", **compare)
    (t1, c1, f1, *_), (t2, c2, f2, *_) = out.values()
    totals = {k: t1[k] + t2[k] for k in t1}
    emit("stream_plain_launches", totals=totals)

    def finish() -> list:
        return f1() + f2()
    return {"totals": totals, "captured": {k: c1[k] + c2[k] for k in c1},
            "finish": finish}


def phase_stream_lowered(session, ck, oracle, replay: dict,
                         scale: float = 1.0) -> dict:
    """QUERIES with the threshold at LOWERED_MIN_ROWS: every one but
    INCORE_LOWERED streams store_sales or catalog_sales, held against
    phase query's oracle and phase replay's in-core results."""
    cfg = session.config
    cfg.out_of_core_min_rows = int(LOWERED_MIN_ROWS * scale)
    cfg.chunk_rows = max(1024, int((1 << 22) * scale))
    units = query_units()
    streamed = tuple(n for n, _ in units if n not in INCORE_LOWERED)
    totals, captured, *_ = run_stream_units(
        session, ck, units, "stream_lowered", streamed, oracle=oracle,
        incore=replay["results"], incore_walls=replay["walls"],
        warm=WARM_PASSES_LOWERED)
    emit("stream_lowered_launches", totals=totals, captured=captured)
    return {"totals": totals, "captured": captured}


def finish_streamed(streamed: dict) -> None:
    """The deferred oracle checks of the streamed phases, and the kernel
    launches their graph captures made. (A morsel schedule inflates a
    global aggregate's segment count to the morsel bound, past
    GROUPBY_MAX_SEGMENTS, so the segment reduction runs only in record
    passes there: its graphs take the plain scatter, as the reference's
    inflated programs take XLA's.)"""
    for st in streamed.values():
        if "finish" in st:
            st.pop("finish")()
    emit("streamed_captured_launches", **{
        ph: st["captured"] for ph, st in streamed.items()})


def first_row_one_slot(gid, mask):
    """The reference's form of kernels.first_row_per_gid: every row outside
    the mask lands on the one spare slot n of a min scatter."""
    import torch
    n = int(gid.shape[0])
    first = torch.full((n + 1,), n, dtype=torch.int32, device=gid.device)
    target = torch.where(mask, gid, n).long().clamp(0, n)
    return first.scatter_reduce_(
        0, target, torch.arange(n, dtype=torch.int32, device=gid.device),
        "amin")


def phase_spare_slot(recorder) -> None:
    """kernels.first_row_per_gid (a slot of its own for each row outside
    the mask) beside the reference's one-spare-slot form, at the largest
    call that SPARE_SLOT_QUERIES made (``recorder`` wraps it, keyed by
    query); the two must be bit-identical."""
    first_row = recorder.orig["first_row_per_gid"]
    calls = [(recorder.largest[key], key[1]) for key in (
        ("first_row_per_gid", f"query{q}") for q in SPARE_SLOT_QUERIES)
        if key in recorder.largest]
    if not calls:
        raise SystemExit(f"queries {SPARE_SLOT_QUERIES} made no first-row "
                         "scatter")
    (n, (gid, mask), _, callers), q = max(calls, key=lambda c: c[0][0])
    ok, _ = same_bits([first_row(gid, mask)], [first_row_one_slot(gid, mask)])
    if not ok:
        raise SystemExit("first_row_per_gid differs from its one-slot form")
    emit("spare_slot", query=q, n=n,
         outside_mask=int((~mask).sum()), callers=callers,
         bit_identical=True,
         **_times("", [time_ms(lambda: first_row(gid, mask))]),
         **_times("one_slot_", [time_ms(
             lambda: first_row_one_slot(gid, mask))]))


def phase_templates(nt, ck, sf: float, tmp: str, device: str = "cuda"):
    """Every unit of every template at `sf`, on a session of its own."""
    from nds_tpu_torch import streams
    from nds_tpu_torch.engine.torch_backend import compiled
    session = phase_data(nt, sf, tmp, device, name="templates_data")
    # another data set: no schedule recorded on the other adopts here
    compiled.clear_shared_programs()
    units = streams.template_units(stream=0, rngseed=SEED)
    t0 = time.perf_counter()
    totals, _, lines = run_units(session, ck, units, "template",
                                 replay=True)
    emit("templates", sf=sf, units=len(units),
         seconds=time.perf_counter() - t0, launches=totals,
         power_eager_s=sum(ln["warm_s"] for ln in lines),
         power_replay_s=sum(ln["replay_s"] for ln in lines),
         nojit={ln["unit"]: ln["nojit"] for ln in lines if ln["nojit"]})


def dev_us(e) -> float:
    """A profiler entry's own device time, microseconds."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def device_parts(fn) -> list:
    """[[kernel, device ms, launches], ...] of one call under
    torch.profiler: how a wrapper's launches share its time."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [[(re.findall(r"(\w+)[<(]", e.key) or [e.key])[0],
             dev_us(e) / 1e3, e.count]
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def phase_profile(session) -> None:
    """One more warm run of each query under torch.profiler (device time
    by kernel, the device's busy share of the wall) and one under
    cProfile (host time by function, host syncs included)."""
    import cProfile
    import pstats

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from nds_tpu_torch import streams

    for q in QUERIES:
        sql = streams.instantiate(q, stream=0, rngseed=SEED)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            session.sql(sql, backend="torch")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # kernels only: an operator's entry repeats its kernels' time
        ka = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
        device_ms = sum(dev_us(e) for e in ka) / 1e3
        top = sorted(ka, key=dev_us, reverse=True)[:8]
        pr = cProfile.Profile()
        pr.enable()
        session.sql(sql, backend="torch")
        torch.cuda.synchronize()
        pr.disable()
        stats = pstats.Stats(pr).stats
        host = sorted(((v[3], f"{k[0].split('/')[-1]}:{k[1]}:{k[2]}")
                       for k, v in stats.items()), reverse=True)[:12]
        emit("profile", query=f"query{q}", wall_s=wall, device_ms=device_ms,
             busy_share=device_ms / 1e3 / wall,
             top_device=[[e.key[:60], dev_us(e) / 1e3, e.count]
                         for e in top],
             host_cumulative_s=[[name, round(t, 4)] for t, name in host])


def _test_inputs():
    """tests/torch_inputs.py, the input makers the tests share, loaded by
    its path (a package named ``tests`` elsewhere on sys.path may shadow
    this repository's)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_inputs.py")
    spec = importlib.util.spec_from_file_location("torch_inputs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: the sort's tile (csrc/sort_pairs.cu kTile)
SORT_TILE = 4096


def _edge_cases(torch, dev):
    """Inputs beyond what the queries gave: ties, sentinels, non-power-of-
    two lengths, int32 keys, non-iota and iota idx; the sort's range remap
    at 0, 1, 4 and 8 key passes (keys all equal, only sentinels, 0/1, the
    high byte only, TYPE_MIN .. TYPE_MAX - 1 with sentinels), its tile -1,
    +0, +1 and about 10M pairs (thousands of tiles for the look-back);
    out-of-range gids, S = 1 and 2048, narrow ints, float min/max with NaN
    and signed zeros, every live row in segment 0 of S = 8 (with 2 int64
    sums and with 16 operands), alternating, sorted, random and all-dead
    gids, and the query path's grouped shape (4096 rows of 2 sums over
    S = 1024); bool and float gathers with clamped and wrapped indices."""
    import numpy as np
    sort_keys = _test_inputs().sort_keys
    g = torch.Generator(device="cpu").manual_seed(7)
    rng = np.random.default_rng(7)

    def ri(lo, hi, n, dt):
        return torch.randint(lo, hi, (n,), generator=g).to(dt).to(dev)
    cases = []
    for n, dt in ((5, torch.int32), (3000, torch.int64),
                  (12289, torch.int32), (100003, torch.int64)):
        key = ri(-9, 9, n, dt)
        key[: n // 3] = torch.iinfo(dt).max
        idx = torch.randperm(n, generator=g).to(torch.int32).to(dev)
        cases.append(("sort_pairs", (key, idx), {}))
        iota = torch.arange(n, dtype=torch.int32, device=dev)
        cases.append(("sort_pairs", (key, iota), {"idx_ascending": True}))
    def operands(n):
        """16 operands: the sum, min and max of every integer width, and
        float min/max with NaN and signed zeros."""
        ops = [(ri(-100, 100, n, dt), op)
               for dt in (torch.int8, torch.int16, torch.int32, torch.int64)
               for op in ("sum", "min", "max")]
        x = torch.randn(n, generator=g, dtype=torch.float64).to(dev)
        x[::97] = float("nan")
        x[1::89] = 0.0
        x[2::89] = -0.0
        return ops + [(x, "min"), (x, "max"), (x.float(), "min"),
                      (x.float(), "max")]
    n = 50001
    for S in (1, 37, 2048):
        gid = ri(-3, S + 3, n, torch.int32)
        cases.append(("seg_reduce_multi", (operands(n), gid, S), {}))
    n = 4096
    cases.append(("seg_reduce_multi", (
        [(ri(-10 ** 12, 10 ** 12, n, torch.int64), "sum") for _ in range(2)],
        ri(0, 1024, n, torch.int32), 1024), {}))
    for n, dt, kind, ascending in (
            (SORT_TILE - 1, np.int64, "equal", True),
            (SORT_TILE, np.int32, "sentinels", False),
            (SORT_TILE + 1, np.int32, "01", True),
            (100_003, np.int64, "highbyte", False),
            (100_003, np.int64, "fullrange", True),
            (10_000_019, np.int64, "fullrange", False),
            (10_000_019, np.int32, "01", True)):
        key = torch.from_numpy(sort_keys(kind, n, dt, rng)).to(dev)
        idx = torch.arange(n, dtype=torch.int32) if ascending else \
            torch.from_numpy(rng.permutation(n).astype(np.int32))
        cases.append(("sort_pairs", (key, idx.to(dev)),
                      {"idx_ascending": ascending}))
    n = 6_291_459
    live0 = torch.where(torch.rand(n, generator=g) < 1 / 3, n, 0) \
        .to(torch.int32).to(dev)
    sums = [(ri(-10 ** 12, 10 ** 12, n, torch.int64), "sum")
            for _ in range(2)]
    cases.append(("seg_reduce_multi", (sums, live0, 8), {}))
    n = 1_000_003
    big = operands(n)
    for S, gid in ((8, torch.zeros(n, dtype=torch.int32)),
                   (8, torch.arange(n, dtype=torch.int32) % 2),
                   (37, torch.randint(0, 37, (n,), generator=g).sort()[0]),
                   (8, torch.full((n,), n)),
                   (8, torch.randint(0, 8, (n,), generator=g)),
                   (2048, torch.randint(-3, 2051, (n,), generator=g))):
        cases.append(("seg_reduce_multi",
                      (big, gid.to(torch.int32).to(dev), S), {}))
    m = 40000
    srcs = [ri(0, 2, m, torch.bool), ri(-128, 127, m, torch.int8),
            ri(-999, 999, m, torch.int16), ri(-999, 999, m, torch.int32),
            ri(-999, 999, m, torch.int64),
            torch.randn(m, generator=g).to(dev),
            torch.randn(m, generator=g, dtype=torch.float64).to(dev)]
    cases.append(("take_many", (srcs, ri(-m - 50, m + 50, 90001,
                                         torch.int32)), {}))
    return cases


def _plain(ck, name):
    return {"sort_pairs": ck.sort_pairs_plain,
            "seg_reduce_multi": ck.seg_reduce_multi_plain,
            "take_many": lambda srcs, idx: [ck.take_plain(s, idx)
                                            for s in srcs]}[name]


def _library(torch, name, args):
    """One PyTorch call (per operand or column) computing the same
    function; timed as a yardstick, never called by the port."""
    if name == "sort_pairs":
        key, _ = args
        return lambda: torch.sort(key, stable=True)
    if name == "seg_reduce_multi":
        ops, gid, S = args
        tgt = torch.where((gid >= 0) & (gid < S), gid, S).long()
        red = {"sum": "sum", "min": "amin", "max": "amax"}

        def run():
            for d, op in ops:
                torch.zeros(S + 1, dtype=d.dtype, device=d.device) \
                    .scatter_reduce_(0, tgt, d, red[op], include_self=False)
        return run
    srcs, idx = args
    li = idx.long()
    return lambda: [torch.index_select(s, 0, li) for s in srcs]


def _bytes(name, args) -> int:
    """Bytes the function must move: each input read once, each output
    written once."""
    if name == "sort_pairs":
        key, idx = args
        return 2 * key.shape[0] * (key.element_size() + 4)
    if name == "seg_reduce_multi":
        ops, gid, S = args
        return gid.shape[0] * 4 + sum(d.shape[0] * d.element_size() +
                                      S * d.element_size() for d, _ in ops)
    # a gather reads each distinct source row it touches once (indices
    # repeat, e.g. clamped dead rows), and writes every output row
    import torch
    srcs, idx = args
    n = idx.shape[0]
    total = n * 4
    for s in srcs:
        m = s.shape[0]
        i = idx.long()
        i = torch.where(i < 0, i + m, i).clamp_(0, m - 1)
        total += (torch.unique(i).numel() + n) * s.element_size()
    return total


def _shape(name, args) -> str:
    if name == "sort_pairs":
        return f"n={args[0].shape[0]} key={args[0].dtype}"
    if name == "seg_reduce_multi":
        ops, gid, S = args
        return (f"n={gid.shape[0]} S={S} ops="
                + ",".join(f"{str(d.dtype)[6:]}:{op}" for d, op in ops))
    srcs, idx = args
    return f"n={idx.shape[0]} cols={len(srcs)}"


def _times(prefix: str, runs: list) -> dict:
    """{prefix + "ms": device, prefix + "host_ms": host}, the medians of
    time_ms pairs."""
    return {f"{prefix}ms": statistics.median(d for d, _ in runs),
            f"{prefix}host_ms": statistics.median(h for _, h in runs)}


def _timed(kern, parents: dict, args, kwargs) -> dict:
    """The kernel's times and, with other trees' versions of the kernel
    given ({tree: function}), theirs in the same call, in turns: each
    parent, the kernel twice, each parent again in reverse order."""
    if not parents:
        return _times("", [time_ms(lambda: kern(*args, **kwargs))])
    runs: dict = {tree: [] for tree in parents}
    for tree, fn in parents.items():
        runs[tree].append(time_ms(lambda: fn(*args, **kwargs)))
    m = _times("", [time_ms(lambda: kern(*args, **kwargs)) for _ in range(2)])
    for tree, fn in reversed(parents.items()):
        runs[tree].append(time_ms(lambda: fn(*args, **kwargs)))
    for key in ("ms", "host_ms"):
        m[f"parent_{key}"] = {tree: _times("", r)[key]
                              for tree, r in runs.items()}
    return m


def _check(ck, recorder, name, args, kwargs) -> tuple:
    """Runs the kernel and its plain version on the same inputs; raises
    unless they are bit-identical. Returns (max abs err, the sort's key
    passes or None)."""
    import torch
    passes = None
    if name == "sort_pairs":
        *got, passes = ck.sort_pairs_with_passes(*args, **kwargs)
    else:
        got = list(recorder.orig[name](*args, **kwargs))
    want = list(_plain(ck, name)(*args))
    torch.cuda.synchronize()
    ok, err = same_bits(got, want)
    if not ok:
        raise SystemExit(f"{name} ({_shape(name, args)}) differs from "
                         f"its plain version (max abs err {err})")
    return err, passes


def _parents(parents: dict, name: str) -> dict:
    """{tree: that tree's wrapper of kernel `name`}, for the trees that
    have it."""
    return {tree: getattr(mod, name) for tree, mod in parents.items()
            if hasattr(mod, name)}


def graph_timed(kern, args, kwargs) -> dict:
    """The call captured alone in a CUDA graph (after one launch on the
    capture stream, which sizes the kernel's scratch): its replays must
    give the eager launch's bits; ``graph_ms`` times a replay as
    time_ms times a call."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        want = list(kern(*args, **kwargs))
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        got = list(kern(*args, **kwargs))
        graph.capture_end()
        for _ in range(3):
            graph.replay()
        stream.synchronize()
        ok, _ = same_bits(got, want)
        if not ok:
            raise SystemExit("a kernel's graph replay differs from its "
                             "eager launch")
        dev_ms, host_ms = time_ms(graph.replay)
    return {"graph_ms": dev_ms, "graph_host_ms": host_ms}


def phase_kernels(ck, recorder, launches, replay, streamed: dict,
                  service: dict, device: str = "cuda",
                  parents: dict | None = None) -> list:
    """Each kernel at the largest call of each regime the query phase gave
    it (the largest of all is the kernel's row, also timed as a graph
    replay), then on the edge cases; every call bit-identical to the plain
    version. The redesigned kernels are timed on the edge cases too, and
    beside ``parents``' ({tree: cuda_kernels module of another tree}) when
    they are given. ``launches`` are the eager query phase's counts;
    ``replay`` the replay phase's (``captured``: launches made while a
    graph was captured; a graph's replays call no wrapper and count
    nothing); ``streamed`` the streamed phases', by phase. A row's
    ``launches`` sums the query phase's, the streamed phases' and the
    service phase's (``service``: its totals, and the launches made while
    its batched graphs were captured)."""
    import torch
    dev = torch.device(device)
    parents = parents or {}
    rows = []
    for name, regimes in recorder.regimes().items():
        kern = recorder.orig[name]
        for i, (regime, args, kwargs, callers) in enumerate(regimes):
            err, passes = _check(ck, recorder, name, args, kwargs)
            m = _timed(kern, _parents(parents, name), args, kwargs)
            m.update(_times("plain_", [time_ms(
                lambda: _plain(ck, name)(*args))]))
            m.update(_times("library_", [time_ms(
                _library(torch, name, args))]))
            m["bound_ms"] = _bytes(name, args) / MEM_RATE * 1e3
            if passes is not None:
                m["key_passes"] = passes
            if name in REDESIGNED:
                m["device_parts"] = device_parts(
                    lambda: kern(*args, **kwargs))
            if i == 0:
                m.update(graph_timed(kern, args, kwargs))
            emit("kernel_regime", kernel=name, regime=regime,
                 shape=_shape(name, args), callers=callers,
                 bit_identical=True, max_abs_err=err, **m)
            if i == 0:  # the largest call of all is the kernel's row
                rows.append({
                    "name": name, "route": "cuda",
                    "source": f"nds_tpu_torch/csrc/{ck.SOURCES[name]}",
                    "replaces": REPLACES[name],
                    "launches": launches[name] + sum(
                        st["totals"][name] for st in streamed.values())
                    + service["totals"][name],
                    "query_launches": launches[name],
                    "stream_launches": {ph: st["totals"][name]
                                        for ph, st in streamed.items()},
                    "service_launches": service["totals"][name],
                    "service_captured_launches":
                    service["captured"][name],
                    "max_abs_err": err, "ms": m["ms"],
                    "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                    "bound_by": "bytes", "library_ms": m["library_ms"],
                    "host_ms": m["host_ms"],
                    "plain_host_ms": m["plain_host_ms"],
                    "library_host_ms": m["library_host_ms"],
                    "graph_ms": m["graph_ms"],
                    "replay_launches": replay["totals"][name],
                    "captured_launches": replay["captured"][name],
                    "shape": _shape(name, args)})
            else:
                rows[-1]["max_abs_err"] = max(rows[-1]["max_abs_err"], err)
    for name, args, kwargs in _edge_cases(torch, dev):
        err, passes = _check(ck, recorder, name, args, kwargs)
        m = {} if name not in REDESIGNED else _timed(
            recorder.orig[name], _parents(parents, name), args, kwargs)
        if passes is not None:
            m["key_passes"] = passes
        emit("kernel_edge", kernel=name, shape=_shape(name, args),
             bit_identical=True, **kwargs, **m)
    return rows


def load_parent(tree: str, k: int):
    """The cuda_kernels module of another checkout (its kernels build into
    that tree's own nds_tpu_torch/_build/), loaded under a name of its
    own, the k-th."""
    import importlib.util
    path = os.path.join(os.path.abspath(tree), "nds_tpu_torch", "engine",
                        "torch_backend", "cuda_kernels.py")
    spec = importlib.util.spec_from_file_location(f"parent{k}_cuda_kernels",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--templates_sf", type=float, default=0.5,
                    help="scale of the phase that runs every template")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more warm run of each query")
    ap.add_argument("--parent", metavar="TREE", action="append", default=[],
                    help="also time the kernels of another checkout (e.g. "
                    "the parent commit, unpacked by git archive) on the "
                    "same inputs, in turns with this tree's; repeatable")
    ap.add_argument("--service_loop", action="store_true",
                    help="in phase service, also run the clients with the "
                    "loop form of batching (each distinct row its own "
                    "replay of the single program), then with the batched "
                    "graphs again")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import nds_tpu_torch as nt
    from nds_tpu_torch.engine.torch_backend import cuda_kernels as ck
    from nds_tpu_torch.engine.torch_backend import kernels

    t_start = time.perf_counter()
    smi = phase_card_build(ck)
    parents = {}
    for k, tree in enumerate(args.parent):
        parents[tree] = load_parent(tree, k)
        emit("parent_build", tree=tree, per_source=parents[tree].build(
            list(REDESIGNED)))
    if torch.cuda.get_device_name(0) != f"NVIDIA {CARD}":
        raise SystemExit(f"the bounds are for the {CARD}, not "
                         f"{torch.cuda.get_device_name(0)}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        session = phase_data(nt, args.sf, tmp)
        recorder = Recorder(ck)
        spare_labels = {f"query{q}" for q in SPARE_SLOT_QUERIES}
        recorder.wrap(kernels, "first_row_per_gid",
                      lambda gid, mask: int(gid.shape[0]),
                      lambda gid, mask: recorder.label
                      if recorder.label in spare_labels else None)
        launches, oracle = phase_queries(session, ck, recorder)
        if args.profile:
            phase_profile(session)
        recorder.unwrap()
        replay = phase_replay(session, ck, oracle)
        service = phase_service(session, ck, loop=args.service_loop)
        del session             # its tables, host and device, are done
        gc.collect()
        torch.cuda.empty_cache()
        scale = args.sf / 10
        ssession = stream_session(nt, tmp, phase_transcode(tmp))
        streamed = {
            "stream_default": phase_stream_default(ssession, ck, scale)}
        streamed["stream_plain"] = phase_stream_plain(
            ssession, ck, streamed["stream_default"])
        streamed["stream_lowered"] = phase_stream_lowered(
            ssession, ck, oracle, replay, scale)
        del ssession, oracle
        replay.pop("results")
        gc.collect()
        torch.cuda.empty_cache()
        phase_spare_slot(recorder)
        emit("largest_inputs", calls=recorder.calls, **{
            k: {reg: f"{_shape(k, a)} from {callers}"
                for reg, a, _, callers in v}
            for k, v in recorder.regimes().items()})
        rows = phase_kernels(ck, recorder, launches, replay, streamed,
                             service, parents=parents)
        phase_templates(nt, ck, args.templates_sf, tmp)
        finish_streamed(streamed)
        for row in rows:
            row["stream_captured_launches"] = {
                ph: st["captured"][row["name"]]
                for ph, st in streamed.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    # each row's "launches" counts the calls into the kernel's launch
    # entry in the main paths: the eager query phase, the streamed phases
    # and the service phase (apart in "query_launches", "stream_launches"
    # and "service_launches");
    # "replay_launches" the replay phase's, and "captured_launches" those
    # of them made while a CUDA graph was captured: a graph's replays run
    # the kernel without calling its wrapper, so they add to no count
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
