#!/usr/bin/env python3
"""Smoke run of nds_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--sf 10] [--templates_sf 0.5] [--profile]
                          [--parent TREE] [--service_loop]

Phases, one JSON line each:

1. card and build: the card's name and power limit (nvidia-smi), and the
   three CUDA kernels compiled from nds_tpu_torch/csrc/ with nvcc (the
   native data generator built beside them);
2. data: NDS tables generated at --sf by the native generator into a
   temporary directory and registered from CSV, decimals as exact int64;
   refresh set 1 at --sf beside them, timed apart;
2b. load: the Load Test, nds_tpu_torch.transcode.transcode over every
   SF10 table, before any other work runs beside it: the generated CSV
   into the snapshot warehouse in the temporary directory, decimals
   exact (``use_decimal``), the seven fact tables partitioned by date
   (about 1,800 files each). Reports the Load Test Time and each table's
   seconds from its report, each table's files and Parquet bytes, the
   RNGSEED line, each table's CSV parse and manifest commit, and the
   seconds the writer processes spent in the manifests' per-file stats,
   apart;
3. queries: NDS queries 3, 7, 9, 42, 55 and 96, and the queries of the
   window, set-operation and concatenation paths, 2, 5, 12, 38, 47, 51,
   67 and 87 (stream 0, template seed 3), through
   Session.sql(backend="torch") on the card, eager (``jit_plans=False``),
   strict (a node that falls back to the host fails the run), cold and
   warm, held against the port's numpy executor on the same session
   (each query's numpy oracle runs in forked processes beside this phase
   and the ones after; the results are checked after phase power).
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
3b''. power: the same 14 queries as a user's power run takes them, after
   the service's session is freed: stream 0 of the port's streams
   (nds_tpu_torch.streams, seed SEED: the query phase's statements)
   through nds_tpu_torch.power.run_query_stream over the warehouse
   (setup_tables registers its pinned snapshot), warmup 2
   (every query recorded, every recorded unit compiled ahead by
   precompile_parallel, then one compiled run), strict, with Parquet
   outputs and JSON summaries, the shared programs cleared first as in a
   fresh process. Every output equals the query phase's oracle result
   (integers and decimals bit-identical, floats to rtol 1e-9), every
   timed run replays a CUDA graph ("compiled"), the compile pass compiles
   every unit. Reports the Power Test Time and each query's ms from the
   time log, the record pass's seconds, the statuses, the graphs' ms, the
   launches and the top programs by device time (obs.device_time).
   Counters zeroed just before, read just after;
3c. the streamed phases' session attaches the warehouse
   (Session.attach_warehouse): every table registers from its pinned
   snapshot, and a streamed scan plans its lanes and encodings from the
   manifest's per-file stats; a stat read from the data fails the phase;
3d. stream_default: at the reference's defaults (48M-row threshold,
   4,194,304-row morsels, packed narrow lanes with dictionary and
   run-length encodings) the SF10 units that scan inventory (133.1M
   rows, 261 date partitions): q21, q22, q37, q72 and q82 must stream it,
   32 morsels a pass,
   and q39's two parts (no streaming job) run in-core over the whole
   table; each unit cold and once warm (a second and a third warm pass
   are cut), held against the numpy
   executor, which runs in two forked workers beside this phase and the
   ones after (q72's alone takes about 6 minutes), the checks at the end;
3e. stream_plain: q22 (q82 is cut) as in 3d but with
   ``narrow_lanes=False``
   (the plain slot: int64 data, a byte of validity a row), cold and once
   warm, then packed again the same way (beside the same host load),
   held against 3d's oracle results; a line sets their bytes uploaded,
   staging and decode times and warm walls beside both packed runs', and
   the plain runs must upload more bytes;
3f. stream_lowered: phase query's queries but 12, 38 and 87 (which run
   in-core there: cut) with the threshold at 10M rows: each streams
   store_sales (7 morsels a pass, from about 1,800 files) or
   catalog_sales (4), cold only (its warm pass is
   cut: the phase's queries replay in phase replay already), held
   against phase query's oracle results and phase replay's in-core
   results. Both streamed phases fail
   on a fallback, a prefetch error, a query expected to stream that ran
   in-core (or the reverse), and a graph capture on a warm pass, and
   report per unit the walls, morsels, bytes uploaded and the upload
   rate, the share of staging hidden under the runs, the host's decode
   and finalize, the device's busy share, re-records, captures and peak
   memory, and the wire layout (lane_spec, enc_spec, enc_bytes_saved,
   decode sites). With narrow_lanes on, every streamed table must ride
   packed lanes. Launch counters zeroed just before each, read just
   after;
3g. maintenance: the Data Maintenance Test over the Load Test's
   warehouse, on the card. The Load Test's state is published as a
   version first (the AS OF point); then, in a new session,
   nds_tpu_torch.maintenance.run_maintenance runs the 11 refresh
   functions over refresh set 1 (generated in phase data at --sf), the
   LF_* then the DF_* (three delete-date windows each), one warehouse
   transaction each: the INSERT bodies on the card, the DELETE
   predicates on the host numpy executor. It reports the Maintenance
   Test Time and each function's ms and variants; per table the rows
   inserted and deleted, the files read, written, dropped and pruned (by
   partition and by stats), the manifests' bytes and seconds written and
   the seconds in register_all and in the warehouse's steps; each
   INSERT body's device time (CUDA events on its executor's stream, from
   its first work to its last) and wall; the versions before and after.
   Then, on
   the same session, pinned to the new version: queries 3, 42, 55 and 96
   cold (eager), then recorded, or adopted from phase power's shared
   programs (a ReplayMismatch is reported), and replayed as graphs; and
   q42 streamed at the 10M-row threshold, its lane_spec and enc_spec
   beside stream_lowered's and the stats taken from the data named.
   Forked processes compute the numpy side beside the reads and the
   phases after (none beside the timed functions), and the checks against
   it run at the end. The phase fails on
   a host fallback, an LF_* function's inserted rows other than numpy's
   for its query over the staging tables AS OF the Load Test's version
   (as multisets: integers and decimals bit-identical, floats to rtol
   1e-9; and all of them in its new files), a fact table whose rows
   after are not its rows before plus the
   rows inserted less the rows the DF_* predicates match (numpy, AS OF
   the version before each function), a published version count other
   than one a function, an AS OF row count other than phase load's, a
   read other than numpy's over the new version, a lifecycle fault, and
   a column stat read from the data where the manifest holds it (the
   reference's rule), and on a join kernel (sort_pairs, take_many) that
   the functions or the reads never launched. Launch counters zeroed
   just before the functions and again before the reads, read just after
   each;
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
   hold two statements) at --templates_sf (0.5 by default) through the
   drivers over the generated CSV, whose decimals the drivers read as
   doubles, as the reference's do: stream files 0-2 from the port's
   streams; a cold power run of stream 0 (warmup 0: every unit records)
   and a warm one (warmup 2: the compile pass, then compiled runs),
   strict, each output Pass by the port's validator in its float mode and
   equal under the port's rules (floats to rtol 1e-9) to a numpy power run
   of stream 0 (forked in three workers beside them); then the throughput
   runner over streams 1 and 2 and the 14 queries, strict, in process
   mode (one ``python -m nds_tpu_torch.power`` a stream on the card) and
   in service mode (every query through one QueryService), the outputs of
   both held against numpy runs of the same streams, with both Power Test
   Times and both elapsed times. Counters zeroed just before the cold
   run, read just after the warm one.

Then the deferred oracle checks of phases stream_default and maintenance,
the kernel table
as one JSON line (a row's launches: the phases query, service, power,
maintenance, templates and the streamed phases') and, last, the device
line. Any
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
    import threading
    from nds_tpu_torch import datagen
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    # the data generator (host C++) builds beside the kernels
    gen = threading.Thread(target=datagen.build_generator)
    gen.start()
    secs = ck.build()
    gen.join()
    emit("build", seconds=time.perf_counter() - t0, per_source=secs,
         nvcc_flags=ck.NVCC_FLAGS)
    return smi


def phase_data(nt, sf: float, tmp: str, device: str = "cuda",
               name: str = "data", refresh: bool = False):
    """The NDS tables at `sf` under tmp/<name>, registered from CSV on a
    new session; with `refresh`, refresh set 1 at `sf` too, under
    tmp/refresh, timed apart (one generator process: each writes the
    set's three delete-date tuples)."""
    from nds_tpu_torch import datagen
    data = os.path.join(tmp, name)
    t0 = time.perf_counter()
    datagen.generate(data, sf, parallel=len(os.sched_getaffinity(0)))
    gen_s = time.perf_counter() - t0
    extra = {}
    if refresh:
        upd = os.path.join(tmp, "refresh")
        t0 = time.perf_counter()
        datagen.generate(upd, sf, parallel=1, update=1)
        extra = {"refresh_generate_s": time.perf_counter() - t0,
                 "refresh_csv_bytes": _tree_bytes(upd)}
    session = nt.Session(nt.EngineConfig(decimal_physical="i64"),
                         device=device)
    names = datagen.setup_tables(session, data, use_decimal=True)
    emit(name, sf=sf, generate_s=gen_s, tables=len(names),
         csv_bytes=_tree_bytes(data), **extra)
    return session


def _tree_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(root) for f in fs)


_FORKED: dict = {}


def _oracle(sql: str):
    t0 = time.perf_counter()
    want = _FORKED["session"].sql(sql, backend="numpy")
    return want, time.perf_counter() - t0


class OracleForks:
    """The numpy oracle of each unit in a process forked from this one
    as soon as the unit has run (so that it shares the host tables the
    unit loaded, and never touches the card), at most `workers` at a time,
    while the caller goes on. detach() hands the units not forked yet to
    one process forked now, which runs them in `workers` processes of its
    own, beside the phases after this one; results() waits for all of
    them. Forks are made from this thread only, between statements."""

    def __init__(self, session, workers: int):
        self.session, self.workers = session, workers
        self.queued: list = []          # (index, sql) not forked yet
        self.running: dict = {}         # connection -> (indexes, process)
        self.done: dict = {}            # index -> (result, seconds)
        self._n = 0

    def submit(self, sql: str) -> None:
        self.queued.append((self._n, sql))
        self._n += 1
        self._pump(block=False)

    def _fork(self, target, idx: list, *args) -> None:
        import multiprocessing
        ctx = multiprocessing.get_context("fork")
        recv, send = ctx.Pipe(duplex=False)
        # (forked, not pickled: the child inherits the session)
        proc = ctx.Process(target=target, args=(self.session, *args, send))
        proc.start()
        send.close()
        self.running[recv] = (idx, proc)

    def detach(self) -> None:
        """Fork one process for every unit not forked yet, and let the
        session go."""
        if self.queued:
            self._fork(_oracle_many, [i for i, _ in self.queued],
                       [sql for _, sql in self.queued], self.workers)
            self.queued = []
        self.session = None

    def _pump(self, block: bool) -> None:
        from multiprocessing.connection import wait
        while self.queued or (block and self.running):
            while self.queued and len(self.running) < self.workers:
                i, sql = self.queued.pop(0)
                self._fork(_oracle_to, [i], sql)
            ready = wait(list(self.running), timeout=None if block else 0)
            if not ready and not block:
                return
            for conn in ready:
                idx, proc = self.running.pop(conn)
                out = conn.recv()
                proc.join()
                if isinstance(out, str):
                    raise SystemExit(f"oracle failed: {out}")
                for i, o in zip(idx, out):
                    self.done[i] = o

    def results(self) -> list:
        """[(the numpy executor's result, seconds)] in submission order."""
        self._pump(block=True)
        return [self.done[i] for i in sorted(self.done)]


def _oracle_to(session, sql: str, conn) -> None:
    try:
        t0 = time.perf_counter()
        want = session.sql(sql, backend="numpy")
        conn.send([(want, time.perf_counter() - t0)])
    except BaseException:
        conn.send(traceback.format_exc())


def _oracle_many(session, sqls: list, workers: int, conn) -> None:
    """The oracle of each of `sqls`, in `workers` processes forked from
    this one (a forked process of one thread)."""
    import multiprocessing
    try:
        _FORKED["session"] = session
        with multiprocessing.get_context("fork").Pool(workers) as pool:
            conn.send(pool.map(_oracle, sqls, chunksize=1))
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
              replay: bool = False, oracle=None, cold: bool = True,
              results: dict | None = None):
    """Each (name, sql) of `units` through Session.sql(backend="torch"):
    eager (jit_plans=False), cold (loads and uploads included) and warm
    where `cold`, else warm only (another phase ran them cold); with
    `replay`, then through the compiled lifecycle: record, compile+run and
    REPLAYS graph replays. The launch counters are zeroed just before the
    first run and read just after the last; a unit that fell back to the
    host or strayed from the lifecycle, or a kernel never launched (with
    `replay`, never inside a capture), fails the phase at once. Sets
    ``recorder.label`` to each unit's name while it runs; ``results``
    ({unit: result}) receives each unit's last result. `oracle` is an
    OracleForks, given each unit's statement as soon as the unit has run
    where `cold`. Returns
    (counter totals, the lines, check): check() holds every result
    against the numpy executor's, waiting for the oracle where it still
    runs, emits one `phase` line per unit, fails if any unit disagreed
    and returns the oracle results ([(result, seconds)] in unit order).
    The caller may call it later, so that the phases after this one run
    beside the oracle."""
    runs, failed = [], []
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
        if cold and isinstance(oracle, OracleForks):
            oracle.submit(sql)
    totals = dict(ck.LAUNCHES)          # read just after the path
    if recorder is not None:
        recorder.label = None
    lines = []
    for (name, _), (eager, compiled, launches) in zip(units, runs):
        line = {"unit": name, "warm_s": eager[-1][1],
                "rows": eager[-1][0].num_rows, "launches": launches,
                "peak_mem_gb": max(r[3] for r in eager + compiled)}
        if len(eager) == 2:
            line["cold_s"] = eager[0][1]
        if compiled:
            line.update(_replay_fields(compiled))
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

    def check() -> list:
        from nds_tpu_torch.validate import table_mismatches
        t0 = time.perf_counter()
        want_all = oracle.results()
        waited_s = time.perf_counter() - t0
        bad = []
        for (name, _), (eager, compiled, _l), (want, oracle_s), line in \
                zip(units, runs, want_all, lines):
            for i, (got, *_rest) in enumerate(eager + compiled):
                mm = table_mismatches(got, want)
                if mm:
                    bad.append(f"{name} (run {i}) disagrees with the numpy "
                               f"oracle: {mm}")
            emit(phase, **line, oracle_s=oracle_s)
        emit(f"{phase}_oracle", waited_s=waited_s)
        if bad:
            raise SystemExit(f"{phase}: " + "\n".join(bad))
        return want_all
    return totals, lines, check


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
    later queries and the phases after this one. Returns (counter totals,
    the OracleForks, the check of the results against it)."""
    oracle = OracleForks(session, 3)
    totals, _, check = run_units(session, ck, query_units(), "query",
                                 recorder, oracle=oracle)
    oracle.detach()
    emit("launches", totals=totals)
    return totals, oracle, check


def phase_replay(session, ck, oracle) -> dict:
    """QUERIES through the compiled lifecycle on the query phase's session
    (its scans resident), against the query phase's oracle (an
    OracleForks, perhaps still running: ``check`` holds the results
    against it). Returns the counter totals with the capture launches
    summed over the queries, each query's replay wall (``walls``) and
    last result (``results``), and ``check``."""
    results: dict = {}
    totals, lines, check = run_units(session, ck, query_units(), "replay",
                                     replay=True, oracle=oracle, cold=False,
                                     results=results)
    captured = {k: sum(ln["captured_launches"].get(k, 0) for ln in lines)
                for k in ck.LAUNCHES}
    emit("replay_launches", totals=totals, captured=captured,
         eager_warm_s=sum(ln["warm_s"] for ln in lines),
         replay_s=sum(ln["replay_s"] for ln in lines))
    return {"totals": totals, "captured": captured, "results": results,
            "walls": {ln["unit"]: ln["replay_s"] for ln in lines},
            "check": check}


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
    the numpy oracle (forked at the end, beside the phases after this one:
    ``check`` holds the results against it). Fails on a host fallback, a
    batch failure of another class than BATCH_ERRORS_OK, no batched
    dispatch at SERVICE_CLIENTS clients, a held batch not served as one
    batched dispatch over the rungs batch_rungs gives, a second capture
    of one (program, batch capacity), and a kernel never launched inside
    a batched capture.
    Launch counters zeroed just before, read just after. Returns the
    counter totals, the launches made inside batched captures and
    ``check``."""
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
    # the oracle of each distinct text, in workers forked now, beside the
    # phases after this one; ``check`` holds the results against it
    texts = sorted(firsts)
    pending = oracle_async(session, texts, 3)
    t_oracle = time.perf_counter()

    def check() -> None:
        t0 = time.perf_counter()
        pool, res = pending
        oracle = res.get()
        pool.close()
        pool.join()
        bad = []
        for sql, (want, _s) in zip(texts, oracle):
            mism = table_mismatches(firsts[sql], want)
            if mism:
                bad.append(f"disagrees with the numpy oracle: {sql}: {mism}")
        emit("service_oracle", texts=len(texts),
             waited_s=time.perf_counter() - t0,
             oracle_s=time.perf_counter() - t_oracle)
        if bad:
            raise SystemExit("service: " + "\n".join(bad[:20]))
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
        "launches": totals, "batched_captured_launches": captured}
    emit("service", **line)
    if failed:
        pending[0].terminate()
        raise SystemExit("service: " + "\n".join(failed[:20]))
    return {"totals": totals, "captured": captured, "check": check}


# ---------------------------------------------------------------------------
# the streamed (out-of-core) path
# ---------------------------------------------------------------------------

#: each streamed table's morsels a pass at SF10 (its rows over the
#: default 4,194,304-row morsel), whatever its files
MORSELS = {"inventory": 32, "store_sales": 7, "catalog_sales": 4}
#: the SF10 units that scan inventory: five stream it at the default
#: settings, and q39's two parts find no streaming job and run in-core
STREAM_DEFAULT = ("query21", "query22", "query37", "query72", "query82")
#: the units phase stream_plain runs again with narrow_lanes off (q82 is
#: cut, the smoke's fourth cut, for phase maintenance)
STREAM_PLAIN = ("query22",)
INCORE_DEFAULT = ("query39_part1", "query39_part2")
#: the threshold of phase stream_lowered, over which store_sales (28.8M
#: rows at SF10) and catalog_sales (14.4M) stream too, but not web_sales
#: (7.2M); of QUERIES, 12 (web_sales only), 38 and 87 find no streaming
#: job and run in-core, and are left out (the smoke's fifth cut, for
#: phase maintenance): the phase keeps the units that stream store_sales
#: and q2, which streams catalog_sales
LOWERED_MIN_ROWS = 10_000_000
INCORE_LOWERED = ("query12", "query38", "query87")
#: warm runs of each unit after its cold run: one in stream_default,
#: none in stream_lowered (the smoke's cuts, in this order: for the Load
#: Test, stream_lowered's warm pass, whose 14 queries replay in phase
#: replay already, and stream_default's third warm pass, which repeated
#: the second; for phase maintenance, stream_default's second)
WARM_PASSES = 1
WARM_PASSES_LOWERED = 0


def phase_load(tmp: str, name: str = "data") -> tuple:
    """The Load Test: nds_tpu_torch.transcode over every table of the
    generated CSV into a warehouse, decimals exact, fact tables
    partitioned. Returns the warehouse's root and each table's rows (as
    parsed)."""
    from nds_tpu_torch import transcode, warehouse
    wh = os.path.join(tmp, "warehouse")
    report = os.path.join(tmp, "load_report.txt")
    # each table's CSV parse and manifest commit, timed apart
    parts: dict = {"csv_s": {}, "commit_s": {}}
    rows: dict = {}
    load_csv, commit = transcode.load_csv, warehouse.WarehouseTable._commit

    def timed_load(path, schema):
        t = time.perf_counter()
        out = load_csv(path, schema)
        parts["csv_s"][os.path.basename(path)] = time.perf_counter() - t
        rows[os.path.basename(path)] = out.num_rows
        return out

    def timed_commit(wt, files):
        t = time.perf_counter()
        out = commit(wt, files)
        parts["commit_s"][wt.name] = time.perf_counter() - t
        return out
    transcode.load_csv, warehouse.WarehouseTable._commit = \
        timed_load, timed_commit
    t0 = time.perf_counter()
    try:
        with warehouse.FileWriters() as writers:
            times = transcode.transcode(os.path.join(tmp, name), wh, report,
                                        use_decimal=True, writers=writers)
    finally:
        transcode.load_csv, warehouse.WarehouseTable._commit = \
            load_csv, commit
    wall = time.perf_counter() - t0
    with open(report) as f:
        lines = f.read().splitlines()
    files, nbytes = {}, {}
    for table in times:
        paths = warehouse.Warehouse(wh).table(table).current_files()
        files[table] = len(paths)
        nbytes[table] = sum(os.path.getsize(p) for p in paths)
    emit("load", seconds=wall, load_test_time=lines[0], table_s=times,
         rngseed=lines[-1], files=files, parquet_bytes=nbytes,
         manifest_bytes=sum(os.path.getsize(os.path.join(
             wh, t, "manifest.json")) for t in times),
         # the partitioned tables' files, summed over the files in
         # whichever writer process took them; the spills' seconds
         stats_s=writers.seconds["stats"], write_s=writers.seconds["write"],
         spill_s=writers.seconds["spill"], write_procs=writers.procs,
         rows=rows, **parts)
    if len(times) != 24:
        raise SystemExit(f"load: {len(times)} tables, not 24")
    return wh, rows


class StatsReads:
    """Counts the column stats taken from the data rather than a
    manifest, while it is entered: Parquet row-group metadata passes
    (arrow_bridge.parquet_column_stats) and column reads for encoding
    stats (arrow_bridge.column_enc_stat)."""

    NAMES = ("parquet_column_stats", "column_enc_stat")

    def __init__(self):
        self.calls = {n: 0 for n in self.NAMES}

    def __enter__(self):
        from nds_tpu_torch.engine import arrow_bridge
        self.orig = {n: getattr(arrow_bridge, n) for n in self.NAMES}
        for n, fn in self.orig.items():
            def counted(*a, _n=n, _fn=fn, **k):
                self.calls[_n] += 1
                return _fn(*a, **k)
            setattr(arrow_bridge, n, counted)
        return self

    def __exit__(self, *exc):
        from nds_tpu_torch.engine import arrow_bridge
        for n, fn in self.orig.items():
            setattr(arrow_bridge, n, fn)
        return False


def stream_session(nt, wh: str, device: str = "cuda"):
    """A session over the warehouse (its pinned snapshot)."""
    from nds_tpu_torch.warehouse import Warehouse
    session = nt.Session(nt.EngineConfig(decimal_physical="i64"),
                         device=device)
    t0 = time.perf_counter()
    session.attach_warehouse(Warehouse(wh))
    emit("stream_session", attach_s=time.perf_counter() - t0,
         warehouse_version=session.warehouse_version(),
         tables=len(session._schemas))
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


def _median(vals):
    vals = list(vals)
    return statistics.median(vals) if vals else None


def _streamed_fields(runs: list) -> dict:
    """One streamed unit's figures: the cold run and the median of the
    warm ones (None where there is no warm run)."""
    def med(key):
        return _median(r[2][key] for r in runs[1:]
                       if r[2].get(key) is not None)
    cold = runs[0][2]
    gbps = [r[2]["bytes_uploaded"] / r[2]["upload_ms"] / 1e6
            for r in runs[1:] if r[2].get("upload_ms")]
    return {"warm_s": _median(r[1] for r in runs[1:]),
            "morsels": cold["morsels"],
            "morsels_per_table": cold["morsels_per_table"],
            "jobs": cold["jobs"], "scan_passes": cold["scan_passes"],
            "fused_groups": cold["fused_groups"],
            "bytes_uploaded": cold["bytes_uploaded"],
            "upload_gb_s": statistics.median(gbps) if gbps else None,
            "stage_hidden_share": med("stage_hidden_share"),
            "host_decode_ms": _median(
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
                     every_kernel: bool = True,
                     morsels: dict | None = None):
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
    streams must ride packed lanes. A streamed table of `morsels`
    ({table: morsels a pass}) must stream in that many. No column stat
    may come from the data (StatsReads): the warehouse's manifests have
    them all. Each kernel must have launched in the phase where
    `every_kernel`. Returns (counter totals, captured
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
    reads = StatsReads()
    ck.reset_launches()                 # the path starts here
    for name, sql in units:
        before = dict(ck.LAUNCHES)
        with reads:
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
            for table, n in st["morsels_per_table"].items():
                if morsels is not None and n != morsels.get(table, n):
                    failed.append(f"{name} (run {i}): {n} morsels of "
                                  f"{table}, not {morsels[table]}")
    totals = dict(ck.LAUNCHES)          # read just after the path
    if any(reads.calls.values()):
        failed.append(f"{phase}: column stats read from the data, not the "
                      f"manifests: {reads.calls}")
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
                "warm_s": _median(r[1] for r in rr[1:]),
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
        preload=("inventory",), morsels=MORSELS if scale == 1 else None,
        # the longest first: q72 takes one worker, the rest the other
        deferred=("query72", "query22", "query39_part1", "query39_part2",
                  "query21", "query37", "query82"))
    emit("stream_default_launches", totals=totals)
    return {"totals": totals, "captured": captured, "finish": finish,
            "oracle": store, "fields": fields, "units": units,
            "morsels": MORSELS if scale == 1 else None}


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
                oracle_from=default["oracle"], every_kernel=False,
                morsels=default["morsels"])
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
    """QUERIES but INCORE_LOWERED with the threshold at LOWERED_MIN_ROWS:
    each streams store_sales or catalog_sales, held against phase
    query's oracle and phase replay's in-core results."""
    cfg = session.config
    cfg.out_of_core_min_rows = int(LOWERED_MIN_ROWS * scale)
    cfg.chunk_rows = max(1024, int((1 << 22) * scale))
    units, oracle = zip(*[(u, o) for u, o in zip(query_units(), oracle)
                          if u[0] not in INCORE_LOWERED])
    streamed = tuple(n for n, _ in units)
    totals, captured, _, _, fields = run_stream_units(
        session, ck, list(units), "stream_lowered", streamed,
        oracle=list(oracle),
        incore=replay["results"], incore_walls=replay["walls"],
        warm=WARM_PASSES_LOWERED, morsels=MORSELS if scale == 1 else None)
    emit("stream_lowered_launches", totals=totals, captured=captured)
    return {"totals": totals, "captured": captured, "fields": fields}


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


# ---------------------------------------------------------------------------
# Data Maintenance over the Load Test's warehouse
# ---------------------------------------------------------------------------

#: the queries read over the warehouse after maintenance: cold, then
#: recorded (or adopted) and replayed; MAINT_STREAMED streams at
#: LOWERED_MIN_ROWS too
MAINT_QUERIES = (3, 42, 55, 96)
#: the tables the refresh functions write
FACT_TABLES = ("catalog_returns", "catalog_sales", "inventory",
               "store_returns", "store_sales", "web_returns", "web_sales")
MAINT_STREAMED = "query42"
#: the kernels the INSERT bodies (joins, no aggregate) and the reads after
#: maintenance (joins and group-by sorts; no global aggregate, where the
#: segment reduction runs) must launch
MAINT_KERNELS = ("sort_pairs", "take_many")


class MaintenanceProbe:
    """While entered, counts per table what the refresh functions did to
    the warehouse: rows inserted and deleted (each DELETE batch's rows
    and the rows its keep filter dropped), files read, written and
    dropped, files pruned by partition and by stats, the bytes and
    seconds of every JSON written (manifests, and under "_snapshots" the
    transactions' records), the seconds in ``register_all`` and in the
    steps of ``seconds``, and each statement query on the device path
    (rows, wall, fallbacks). The functions run unchanged."""

    def __init__(self, root: str):
        self.root = root
        self.tables: dict = {}
        self.json: dict = {}
        self.register_all = {"calls": 0, "s": 0.0}
        self.bodies: list = []
        #: (table, the Arrow table) of each INSERT, in order
        self.inserts: list = []
        #: seconds in the warehouse's and the session's steps (__enter__)
        self.seconds: dict = {}
        self.restore: list = []

    def _t(self, name: str) -> dict:
        return self.tables.setdefault(name, {
            "rows_inserted": 0, "rows_deleted": 0, "rows_read": 0,
            "files_read": 0, "files_written": 0, "files_dropped": 0,
            "pruned_partition": 0, "pruned_stats": 0})

    def __enter__(self):
        import threading

        import pyarrow as pa
        import pyarrow.compute as pc

        from nds_tpu_torch import warehouse as W
        from nds_tpu_torch.engine.session import Session
        probe = self
        lock = threading.Lock()
        self.orig = {"insert": W.WarehouseTable.insert,
                     "delete_where": W.WarehouseTable.delete_where,
                     "_read_file": W._read_file,
                     "_atomic_write_json": W._atomic_write_json,
                     "register_all": W.Warehouse.register_all,
                     "_run_query_ast": Session._run_query_ast}
        o = self.orig

        def insert(wt, table, partition=True):
            before = set(wt.current_files())
            out = o["insert"](wt, table, partition)
            probe.inserts.append((wt.name, table))
            t = probe._t(wt.name)
            t["rows_inserted"] += table.num_rows
            t["files_written"] += len(set(wt.current_files()) - before)
            return out

        def delete_where(wt, keep_filter, batch_rows=4_000_000,
                         part_prune=None, stats_prune=None):
            t = probe._t(wt.name)
            before = set(wt.current_files())

            def keep(batch):
                kept = pa.array(keep_filter(batch), type=pa.bool_())
                t["rows_read"] += batch.num_rows
                t["rows_deleted"] += batch.num_rows - (
                    pc.sum(kept).as_py() or 0)
                return kept

            def counted(rule, key):
                if rule is None:
                    return None

                def ask(arg):
                    go = rule(arg)
                    t[key] += not go
                    return go
                return ask
            out = o["delete_where"](
                wt, keep, batch_rows=batch_rows,
                part_prune=counted(part_prune, "pruned_partition"),
                stats_prune=counted(stats_prune, "pruned_stats"))
            after = set(wt.current_files())
            t["files_written"] += len(after - before)
            t["files_dropped"] += len(before - after)
            return out

        def read_file(path):
            rel = os.path.relpath(path, probe.root)
            with lock:                  # (files are read on threads)
                probe._t(rel.split(os.sep)[0])["files_read"] += 1
            return o["_read_file"](path)

        def write_json(path, doc, *text):
            t0 = time.perf_counter()
            out = o["_atomic_write_json"](path, doc, *text)
            key = (os.path.basename(os.path.dirname(path))
                   if os.path.basename(path) == "manifest.json"
                   else "_snapshots")
            j = probe.json.setdefault(key, {"writes": 0, "bytes": 0,
                                            "s": 0.0})
            j["writes"] += 1
            j["bytes"] += os.path.getsize(path)
            j["s"] += time.perf_counter() - t0
            return out

        def register_all(wh, session, *a, **k):
            t0 = time.perf_counter()
            out = o["register_all"](wh, session, *a, **k)
            probe.register_all["calls"] += 1
            probe.register_all["s"] += time.perf_counter() - t0
            return out

        def run_query_ast(session, ast, backend):
            on_device = (backend or "torch") == "torch"
            events = None
            if on_device and session.device.type == "cuda":
                # events on the executor's stream around the body: the
                # device time from its first work to its last
                import torch
                stream = session._executor().stream
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                events[0].record(stream)
            t0 = time.perf_counter()
            out = o["_run_query_ast"](session, ast, backend)
            if on_device:
                span = None
                if events is not None:
                    events[1].record(stream)
                    events[1].synchronize()
                    span = events[0].elapsed_time(events[1])
                probe.bodies.append({
                    "rows": out.num_rows,
                    "wall_s": time.perf_counter() - t0,
                    "device_span_ms": span,
                    "fallbacks": list(session.last_fallbacks)})
            return out
        for owner, attr, fn in (
                (W.WarehouseTable, "insert", insert),
                (W.WarehouseTable, "delete_where", delete_where),
                (W, "_read_file", read_file),
                (W, "_atomic_write_json", write_json),
                (W.Warehouse, "register_all", register_all),
                (Session, "_run_query_ast", run_query_ast)):
            self._patch(owner, attr, fn)
        # the seconds spent in each of these, summed (nested ones apart)
        for owner, attr in ((W.WarehouseTable, "insert"),
                            (W.FileWriters, "write"),
                            (W.WarehouseTable, "delete_where"),
                            (W.WarehouseTable, "_load_doc"),
                            (W.WarehouseTable, "_commit"),
                            (Session, "_stats_prune"),
                            (Session, "_partition_prune")):
            self._patch(owner, attr, self._timed(attr, getattr(owner, attr)))
        return self

    def _patch(self, owner, attr, fn) -> None:
        self.restore.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, fn)

    def _timed(self, key: str, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.seconds[key] = self.seconds.get(key, 0.0) + \
                    time.perf_counter() - t0
        return timed

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self.restore):
            setattr(owner, attr, fn)
        return False


def fork_call(fn, *args):
    """fn(*args) in a process forked from this one, which goes on
    meanwhile (the child never touches the card); returns a function that
    waits for the child and returns fn's result."""
    import multiprocessing
    ctx = multiprocessing.get_context("fork")
    recv, send = ctx.Pipe(duplex=False)

    def child():
        try:
            send.send((True, fn(*args)))
        except BaseException:
            send.send((False, traceback.format_exc()))
    proc = ctx.Process(target=child)
    proc.start()
    send.close()

    def wait():
        ok, out = recv.recv()
        proc.join()
        if not ok:
            raise SystemExit(f"{fn.__name__} failed: {out}")
        return out
    return wait


def _pinned(nt, wh: str, version: int):
    """A host session (numpy only) over the warehouse AS OF `version`."""
    from nds_tpu_torch.warehouse import Warehouse
    s = nt.Session(nt.EngineConfig(decimal_physical="i64"), device="cpu")
    s.attach_warehouse(Warehouse(wh), at_version=version)
    return s


def _insert_query(sql: str) -> tuple:
    """(target table, the function's statements with its INSERT replaced
    by the INSERT's query): what the function would append."""
    import re
    m = re.search(r"INSERT\s+INTO\s+(\w+)\s+", sql, re.IGNORECASE)
    return m.group(1), sql[:m.start()] + sql[m.end():]


def _lf_oracle(nt, wh: str, upd: str, version: int) -> dict:
    """In a forked process, AS OF `version` (the Load Test's): each
    table's rows (the footers of its files there), store_sales' COUNT(*)
    by the numpy executor, and each LF_* function's rows as the numpy
    executor computes them over the staging tables, as Arrow tables in
    the target's names."""
    from nds_tpu_torch import maintenance
    from nds_tpu_torch.engine.arrow_bridge import to_arrow
    s = _pinned(nt, wh, version)
    rows = dict(s._est_rows)
    count = s.sql("SELECT COUNT(*) AS n FROM store_sales",
                  backend="numpy").columns[0].data.tolist()[0]
    maintenance.register_staging(s, upd)
    out = {}
    for func in maintenance.INSERT_FUNCS:
        target, sql = _insert_query(maintenance.load_function_sql(func))
        got = s.execute(sql, backend="numpy")
        out[func] = (target, to_arrow(got).rename_columns(
            s._schemas[target][0]))
    return {"rows": rows, "store_sales_count": int(count), "lf": out}


def _df_counts(nt, wh: str, jobs: list) -> dict:
    """In a forked process, for each (DF_* function, the version before
    it, its statement sets) of `jobs`, AS OF that version: per target
    table, the rows each of the function's DELETE predicates matches by
    the numpy executor, summed over the variants (their date windows are
    disjoint)."""
    import re
    out: dict = {}
    for func, version, variants in jobs:
        s = _pinned(nt, wh, version)
        matched = out[func] = {}
        for stmt in dict.fromkeys(st for text in variants
                                  for st in text.split(";")):
            m = re.match(r"\s*DELETE\s+FROM\s+(\w+)\s+WHERE\s+(.*)$",
                         stmt, re.IGNORECASE | re.DOTALL)
            if m is None:
                continue
            n = s.sql(f"SELECT COUNT(*) AS n FROM {m.group(1)} WHERE "
                      f"{m.group(2)}", backend="numpy")
            matched[m.group(1)] = matched.get(m.group(1), 0) + \
                int(n.columns[0].data.tolist()[0])
    return out


def _numpy_results(session, sqls: list) -> list:
    """In a forked process: [(the numpy executor's result, seconds)] of
    each of `sqls` on `session`."""
    _FORKED["session"] = session
    return [_oracle(sql) for sql in sqls]


def _test_module(name: str):
    """tests/<name>.py, the helpers the tests share, loaded by its path (a
    package named ``tests`` elsewhere on sys.path may shadow this
    repository's)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _maint_read_faults(name: str, stats: list) -> list:
    """A read's compiled runs after maintenance: the first records, or
    adopts a program recorded before it (then every later run replays);
    a recorded one goes compile+run (or compiled), compiled..."""
    modes = [st.get("mode") for st in stats]
    if modes[0] == "adopted":
        ok = all(m == "compiled" for m in modes[1:])
    else:
        ok = modes[0] == "record" and \
            modes[1] in ("compile+run", "compiled") and \
            all(m == "compiled" for m in modes[2:])
    return [] if ok else [f"{name}: modes {modes} follow no lifecycle"]


def phase_maintenance(nt, ck, wh: str, upd: str, load_rows: dict,
                      lowered: dict, scale: float = 1.0,
                      device: str = "cuda") -> dict:
    """The Maintenance Test over the Load Test's warehouse, on the card:
    the Load Test's state is published as a version first (its AS OF
    point), then maintenance.run_maintenance runs the 11 refresh
    functions in the reference's order, one transaction each, in a new
    session (the INSERT bodies on the card, the DELETE predicates on the
    host). Then, on the same session, pinned to the new version: queries
    MAINT_QUERIES cold (eager), then recorded or adopted (the shared
    programs as phase power left them: a schedule recorded over the old
    version may be offered) and replayed as graphs; and MAINT_STREAMED
    streamed at LOWERED_MIN_ROWS over the inserted files too. Forked
    processes compute the numpy side beside the reads and the phases
    after this one (none runs beside the timed functions): each LF_*
    function's rows and every table's rows AS OF the Load Test's version,
    each DF_* function's matched rows AS OF the version before it, and the
    reads' oracle over the new version; the returned ``finish`` holds the
    phase's results against them. Fails on a host fallback, an INSERT's rows other than
    numpy's or not all in its new files, a row count that does not add
    up, a published
    version count other than one a function, an AS OF count other than
    phase load's, a read other than numpy's, a lifecycle fault, a
    column stat read from the data where the manifest has it, and a
    kernel of MAINT_KERNELS either path never launched. Launch counters
    zeroed just before each of the two paths (the functions; the reads),
    read just after."""
    import torch

    from nds_tpu_torch import maintenance, streams
    from nds_tpu_torch.engine import arrow_bridge
    from nds_tpu_torch.validate import table_mismatches
    from nds_tpu_torch.warehouse import Warehouse
    t_phase = time.perf_counter()
    setup: dict = {}
    W = Warehouse(wh)
    with W.transaction(committer="load"):
        pass                    # the Load Test's state, published
    v_before = W.current_version()
    setup["publish_s"] = time.perf_counter() - t_phase
    session = nt.Session(nt.EngineConfig(decimal_physical="i64"),
                         device=device)
    probe = MaintenanceProbe(wh)
    log = os.path.join(os.path.dirname(wh), "maintenance.csv")
    on_card = device == "cuda"
    ck.reset_launches()                 # the path starts here
    with probe:
        t0 = time.perf_counter()
        rows = maintenance.run_maintenance(wh, upd, log, session=session)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    insert_totals = dict(ck.LAUNCHES)   # read just after the path
    with open(log) as f:
        test_ms = [ln.split(",") for ln in f.read().splitlines()][-1][3]
    # (the session's own Warehouse keeps the manifests it wrote decoded)
    W = session.warehouse
    v_after = W.current_version()
    failed = []
    records = [W.version_record(v) for v in range(v_before + 1,
                                                  v_after + 1)]
    if [r["committer"] for r in records] != maintenance.MAINTENANCE_FUNCS:
        failed.append(f"maintenance: versions {v_before}..{v_after} "
                      f"published by {[r['committer'] for r in records]}")
    ran = session.warehouse_version(), [r[0] for r in rows]
    if ran != (v_after, maintenance.MAINTENANCE_FUNCS):
        failed.append(f"maintenance: session at version {ran[0]} after "
                      f"{ran[1]}")
    for b in probe.bodies:
        if b["fallbacks"]:
            failed.append(f"maintenance: an INSERT body fell back to the "
                          f"host: {b['fallbacks']}")
    missing = [k for k in MAINT_KERNELS if insert_totals[k] == 0]
    if missing and on_card:            # (the CPU launches no kernel)
        failed.append(f"maintenance: kernels never launched: {missing}")
    emit("maintenance", maintenance_test_ms=int(test_ms), wall_s=wall,
         function_ms={r[0]: r[3] for r in rows},
         variants={f: len(maintenance.function_variants(
             f, *maintenance.get_delete_date(upd)))
             for f in maintenance.MAINTENANCE_FUNCS},
         tables=probe.tables, json_writes=probe.json,
         register_all=probe.register_all, step_s=probe.seconds,
         insert_bodies=probe.bodies,
         insert_device_span_ms=sum(b["device_span_ms"] or 0.0
                                   for b in probe.bodies),
         versions=[v_before, v_after], launches=insert_totals,
         setup_s=setup)

    # the numpy side, forked beside the reads (none beside the timed
    # functions): the LF_* functions' rows, each DF_* function's matched
    # rows, then the reads' oracle after their cold runs
    dates = maintenance.get_delete_date(upd)
    jobs = [(f, v_before + maintenance.MAINTENANCE_FUNCS.index(f),
             maintenance.function_variants(f, *dates))
            for f in ("DF_SS", "DF_WS", "DF_CS", "DF_I")]
    t0 = time.perf_counter()
    lf = fork_call(_lf_oracle, nt, wh, upd, v_before)
    df = [fork_call(_df_counts, nt, wh, [job]) for job in jobs]
    setup["reads_fork_s"] = time.perf_counter() - t0
    # the reads over the new version, on the maintenance session
    units = [(f"query{q}", streams.instantiate(q, stream=0, rngseed=SEED))
             for q in MAINT_QUERIES]
    reads, reads_failed = {}, []
    reads_t0 = time.perf_counter()
    ck.reset_launches()                 # the path starts here
    for name, sql in units:
        reads[name] = [_sql_run(session, sql, False)]
    oracle = fork_call(_numpy_results, session, [sql for _, sql in units])
    for name, sql in units:
        comp = [_sql_run(session, sql, True) for _ in range(2 + REPLAYS)]
        reads[name] += comp
        reads_failed += _maint_read_faults(name, [r[2] for r in comp])
    cfg, default = session.config, nt.EngineConfig()
    cfg.out_of_core_min_rows = int(LOWERED_MIN_ROWS * scale)
    cfg.chunk_rows = max(1024, int((1 << 22) * scale))
    stats = StatsReads()
    try:
        with stats:
            streamed = _sql_run(session, dict(units)[MAINT_STREAMED], True)
    finally:
        cfg.out_of_core_min_rows = default.out_of_core_min_rows
        cfg.chunk_rows = default.chunk_rows
    read_totals = dict(ck.LAUNCHES)     # read just after the path
    reads_s = time.perf_counter() - reads_t0
    for name, runs in reads.items():
        for r in runs:
            if r[2]["fallbacks"]:
                reads_failed.append(f"{name}: host fallback "
                                    f"{r[2]['fallbacks']}")
    st = streamed[2]
    if st.get("mode") != "streamed" or st["fallbacks"] or \
            st.get("prefetch_error_details"):
        reads_failed.append(f"{MAINT_STREAMED} at the lowered threshold: "
                            f"{st.get('mode')}, fallbacks {st['fallbacks']}"
                            f", {st.get('stream_refused')}")
    elif scale == 1 and st["morsels_per_table"] != {
            "store_sales": MORSELS["store_sales"]}:
        reads_failed.append(f"{MAINT_STREAMED}: morsels "
                            f"{st['morsels_per_table']}")
    missing = [k for k in MAINT_KERNELS if read_totals[k] == 0]
    if missing and on_card:
        reads_failed.append(f"reads: kernels never launched: {missing}")
    # which encoding stats of store_sales came from the data: the reference
    # takes from the data exactly those a file's manifest entry lacks
    wt = W.table("store_sales")
    files = wt.files_at_version(session.table_snapshot_version(
        "store_sales"))
    manifest = wt.column_enc_stats(files)
    schema = session._schemas["store_sales"]
    enc_types = {n for n, d in zip(*schema)
                 if d in ("int", "date") or d.startswith("dec")}
    from_data = sorted(c for c in session._enc_stats.get("store_sales", {})
                       if c not in manifest and c in enc_types)
    if stats.calls["column_enc_stat"] > len(from_data) or \
            stats.calls["parquet_column_stats"]:
        reads_failed.append(f"{MAINT_STREAMED}: stats read from the data "
                            f"{stats.calls}, where the manifest lacks only "
                            f"{from_data}")

    low = lowered.get("fields", {}).get(MAINT_STREAMED, {})
    emit("maintenance_reads", seconds=reads_s,
         fork_s=setup["reads_fork_s"],
         units={name: {
             "cold_s": runs[0][1],
             "modes": [r[2].get("mode") for r in runs[1:]],
             "replay_mismatch": [r[2].get("replay_mismatch")
                                 for r in runs[1:]
                                 if r[2].get("replay_mismatch")],
             "record_s": runs[1][1],
             "replay_s": _median(r[1] for r in runs[3:]),
             "graph_ms": _median(r[2].get("graph_ms", 0.0)
                                 for r in runs[3:]),
             "rows": runs[-1][0].num_rows}
             for name, runs in reads.items()},
         streamed={"unit": MAINT_STREAMED, "s": streamed[1],
                   "morsels_per_table": st.get("morsels_per_table"),
                   "lane_spec": st.get("lane_spec"),
                   "enc_spec": st.get("enc_spec"),
                   "stream_lowered_lane_spec": low.get("lane_spec"),
                   "stream_lowered_enc_spec": low.get("enc_spec"),
                   "stats_from_data": from_data,
                   "stats_reads": stats.calls},
         launches=read_totals)
    failed += reads_failed
    if failed:
        raise SystemExit("maintenance: " + "\n".join(failed))
    del session
    inserts = probe.inserts

    def finish() -> None:
        """The checks against the numpy side, whose processes run beside
        the phases after this one."""
        t_wait = time.perf_counter()
        want = oracle()
        lfo = lf()
        dfo = {f: n for wait in df for f, n in wait().items()}
        waited_s = time.perf_counter() - t_wait
        bad = []
        for (name, _), (w, _s) in zip(units, want):
            for i, r in enumerate(reads[name]):
                mm = table_mismatches(r[0], w)
                if mm:
                    bad.append(f"{name} (run {i}) disagrees with numpy "
                               f"over the new version: {mm}")
            if name == MAINT_STREAMED:
                mm = table_mismatches(streamed[0], w)
                if mm:
                    bad.append(f"{name} streamed disagrees with numpy over "
                               f"the new version: {mm}")
        # AS OF the Load Test's version: phase load's counts
        asof = {t: n for t, n in lfo["rows"].items()
                if load_rows.get(t) != n}
        if asof or lfo["store_sales_count"] != load_rows["store_sales"]:
            bad.append(f"AS OF version {v_before}: rows {asof}, store_sales"
                       f" COUNT(*) {lfo['store_sales_count']}, not phase "
                       "load's")
        # the inserted rows: numpy's, as multisets, and all in the new files
        faults = _test_module("torch_drivers_cases").file_faults
        inserted = {}
        got_rows = iter(inserts)
        for k, func in enumerate(maintenance.MAINTENANCE_FUNCS):
            if func not in maintenance.INSERT_FUNCS:
                continue
            target, want_rows = lfo["lf"][func]
            table, got = next(got_rows, (None, None))
            t = W.table(target)
            # the function published version v_before + k + 1
            before = W.version_record(v_before + k)["tables"][target]
            after = W.version_record(v_before + k + 1)["tables"][target]
            new = sorted(set(t.files_at_version(after))
                         - set(t.files_at_version(before)))
            in_files = arrow_bridge.parquet_footers(new, immutable=True)[0]
            inserted[func] = {"table": target, "rows": want_rows.num_rows,
                              "files": len(new)}
            faults_of = [f"inserted into {table}"] if table != target \
                else faults(got, want_rows)
            if in_files != want_rows.num_rows:
                faults_of.append(f"{in_files} rows in its {len(new)} new "
                                 "files")
            if faults_of:
                bad.append(f"{func}: inserted rows differ from numpy's: "
                           f"{faults_of}")
        # every table: its rows before, plus numpy's inserted, less
        # numpy's matched, are its rows after
        last = W.version_record(v_after)["tables"]
        final = {name: arrow_bridge.parquet_footers(
            W.table(name).files_at_version(last[name]), immutable=True)[0]
            for name in FACT_TABLES}
        expect = dict(load_rows)
        for ins in inserted.values():
            expect[ins["table"]] += ins["rows"]
        matched: dict = {}
        for func, out in dfo.items():
            for table, n in out.items():
                expect[table] -= n
                matched.setdefault(table, {})[func] = n
        wrong = {t: (final[t], expect[t]) for t in FACT_TABLES
                 if final[t] != expect[t]}
        if wrong:
            bad.append(f"rows after != before + inserted - matched: "
                       f"{wrong}")
        emit("maintenance_checks", waited_s=waited_s,
             oracle_s={name: w[1] for (name, _), w in zip(units, want)},
             inserted=inserted, matched=matched, rows_after=final)
        if bad:
            raise SystemExit("maintenance: " + "\n".join(bad))
    emit("maintenance_phase", seconds=time.perf_counter() - t_phase)
    return {"totals": {k: insert_totals[k] + read_totals[k]
                       for k in insert_totals},
            "insert": insert_totals, "reads": read_totals, "finish": finish}


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


# ---------------------------------------------------------------------------
# the benchmark drivers: power and throughput runs
# ---------------------------------------------------------------------------

#: the power phase's untimed runs a query: record (all queries, then every
#: recorded unit compiled ahead), then one compiled run
POWER_WARMUP = 2
#: the throughput runs' streams (stream 0 is the power run's)
THROUGHPUT_STREAMS = (1, 2)
#: forked numpy power runs of the templates phase's stream 0, at a time
NUMPY_CHUNKS = 3


def _as_written(table):
    """A result as the power runner writes it: columns renamed for
    Parquet (power.ensure_valid_column_names)."""
    from nds_tpu_torch.engine.column import Table
    from nds_tpu_torch.power import ensure_valid_column_names
    return Table(ensure_valid_column_names(list(table.names)),
                 list(table.columns))


def _read_output(prefix: str, name: str):
    """A unit's Parquet output as a port Table (decimals exact)."""
    import pyarrow.parquet as pq
    from nds_tpu_torch.engine import arrow_bridge
    return arrow_bridge.from_arrow(pq.read_table(
        os.path.join(prefix, name, "part-0.parquet")), True)


class _Lines:
    """A stdout that passes everything on and keeps the lines starting
    with `prefix`."""

    def __init__(self, out, prefix: str):
        self.out, self.prefix, self.kept, self.buf = out, prefix, [], ""

    def write(self, text: str) -> int:
        self.buf += text
        *done, self.buf = self.buf.split("\n")
        self.kept += [ln for ln in done if ln.startswith(self.prefix)]
        return self.out.write(text)

    def flush(self) -> None:
        self.out.flush()


def power_run(data: str, stream_file: str, root: str, tag: str,
              input_format: str = "csv", **kw) -> dict:
    """One power run (nds_tpu_torch.power.run_query_stream) over the CSV
    tables or a warehouse, with outputs and JSON summaries under
    root/<tag>_*; returns its wall, the Power Test Time and each unit's ms
    from its time log, each unit's status and execStats modes from its
    summary, what its compile pass returned and the record pass's seconds
    (the runner's "precompile:" line)."""
    import csv as _csv
    from nds_tpu_torch import power
    out = os.path.join(root, f"{tag}_out")
    js = os.path.join(root, f"{tag}_json")
    log = os.path.join(root, f"{tag}_time.csv")
    t0 = time.perf_counter()
    compile_report: dict = {}
    lines = _Lines(sys.stdout, "precompile:")
    sys.stdout = lines
    try:
        power.run_query_stream(data, stream_file, log,
                               input_format=input_format, output_prefix=out,
                               json_summary_folder=js,
                               compile_report=compile_report, **kw)
    finally:
        sys.stdout = lines.out
    wall = time.perf_counter() - t0
    record_s = [float(ln.split(" in ")[1].split("s;")[0])
                for ln in lines.kept]
    with open(log) as f:
        rows = [r for r in _csv.reader(f) if r]
    summaries = {}
    for fn in os.listdir(js):
        with open(os.path.join(js, fn)) as f:
            summaries[fn.split("-")[1]] = json.load(f)
    return {
        "wall_s": wall, "out": out,
        "power_test_ms": int(rows[-1][3]),
        "query_ms": {r[0]: int(r[3]) for r in rows[2:-2]},
        "status": {n: s["queryStatus"][-1] for n, s in summaries.items()},
        "modes": {n: [e.get("mode") for e in s.get("execStats", [])]
                  for n, s in summaries.items()},
        "nojit": {n: e["nojit_reason"] for n, s in summaries.items()
                  for e in s.get("execStats", []) if e.get("nojit_reason")},
        "graph_ms": {n: s["execStats"][-1].get("graph_ms")
                     for n, s in summaries.items() if s.get("execStats")},
        "precompile": list(compile_report.values()),
        "record_s": record_s[0] if record_s else None,
    }


def _run_faults(run: dict, tag: str, mode: str) -> list:
    """A power run's faults: a unit not Completed, or its timed run not in
    `mode` (a unit left eager must have a reason the reference shares)."""
    faults = [f"{tag}: {n} {s}" for n, s in run["status"].items()
              if s != "Completed"]
    for n, modes in run["modes"].items():
        reason = run["nojit"].get(n)
        if reason is not None:
            if not any(ok in reason for ok in NOJIT_SHARED):
                faults.append(f"{tag}: {n} nojit for a reason the "
                              f"reference does not share: {reason}")
        elif modes != [mode]:
            faults.append(f"{tag}: {n} timed run in mode {modes}, not "
                          f"{mode}")
    return faults


def phase_power(ck, data: str, oracle, tmp: str,
                device: str = "cuda") -> dict:
    """QUERIES as a user's power run takes them: stream 0 of the port's
    streams (seed SEED) over the SF10 warehouse `data` (phase load)
    through nds_tpu_torch.power.run_query_stream, warmup 2, strict, in a
    process
    whose shared programs are cleared (as a fresh process's). Every
    output equals the query phase's oracle result (`oracle`, the
    OracleForks, waited for after the run), every timed run replays a
    CUDA graph ("compiled") and the compile pass compiles every recorded
    unit. Counters zeroed just before, read just after. Returns the
    counter totals."""
    from nds_tpu_torch import power, streams
    from nds_tpu_torch.engine.torch_backend import compiled
    from nds_tpu_torch.obs import device_time
    from nds_tpu_torch.validate import table_mismatches
    root = os.path.join(tmp, "power")
    [stream0] = streams.generate_query_streams(
        os.path.join(root, "streams"), 1, SEED)
    with open(stream0) as f:
        stream_sql = power.gen_sql_from_stream(f.read())
    units = query_units()
    failed = [f"{n}: the stream's statement is not the query phase's"
              for n, sql in units
              if power.strip_sql_comments(sql).strip().rstrip(";")
              != stream_sql[n]]
    compiled.clear_shared_programs()
    device_time.PROGRAMS.reset()
    ck.reset_launches()                 # the path starts here
    run = power_run(data, stream0, root, "power", input_format="parquet",
                    warmup=POWER_WARMUP, strict=True,
                    sub_queries=[n for n, _ in units], device=device)
    totals = dict(ck.LAUNCHES)          # read just after the path
    failed += _run_faults(run, "power", "compiled")
    if not run["precompile"] or set(run["precompile"]) != {"compiled"}:
        failed.append(f"power: the compile pass gave {run['precompile']}")
    for (name, _), (want, _) in zip(units, oracle.results()):
        bad = table_mismatches(_read_output(run["out"], name),
                               _as_written(want))
        if bad:
            failed.append(f"power: {name} disagrees with the oracle: {bad}")
    top = device_time.PROGRAMS.table(top=10)
    emit("power", units=len(units), wall_s=run["wall_s"],
         record_s=run["record_s"],
         power_test_ms=run["power_test_ms"], query_ms=run["query_ms"],
         status=run["status"], graph_ms=run["graph_ms"],
         precompile={"units": len(run["precompile"]),
                     "compiled": run["precompile"].count("compiled")},
         launches=totals, top_programs=top,
         device_time_ms=device_time.PROGRAMS.total_ms())
    print(device_time.format_table(top), flush=True)
    if failed:
        raise SystemExit("power: " + "\n".join(failed))
    missing = [k for k, v in totals.items() if v == 0]
    if missing and device == "cuda":    # (the CPU launches no kernel)
        raise SystemExit(f"power: kernels never launched: {missing}")
    return {"totals": totals}


def _numpy_power(data: str, stream_file: str, out: str, log: str,
                 sub) -> None:
    """A numpy power run in a forked worker (never touches the card)."""
    from nds_tpu_torch import power
    with open(os.devnull, "w") as null:
        sys.stdout = null
        power.run_query_stream(data, stream_file, log, input_format="csv",
                               backend="numpy", output_prefix=out,
                               sub_queries=sub, device="cpu")


def _numpy_throughput(data: str, stream_dir: str, logs: str, out: str,
                      sub) -> None:
    from nds_tpu_torch import throughput
    with open(os.devnull, "w") as null:
        sys.stdout = null
        throughput.run_throughput(data, stream_dir, list(THROUGHPUT_STREAMS),
                                  logs, input_format="csv",
                                  output_prefix=out, sub_queries=sub,
                                  backend="numpy", mode="thread",
                                  device="cpu")


def _outputs_faults(want: str, got: str, names: list, tag: str) -> list:
    """`got`'s outputs against `want`'s, both read from CSV (decimals as
    doubles): Pass by the port's validator in its float mode (query65 and
    query67 are NotAttempted there) and equal under the port's rules
    (floats to rtol 1e-9)."""
    from nds_tpu_torch import validate
    faults = []
    status = validate.iterate_queries(want, got, names, use_floats=True)
    for n, st in status.items():
        if st == "Fail" or (st != "Pass" and n.split("_part")[0] not in
                            validate.SKIP_ALWAYS + validate.SKIP_WITH_FLOATS):
            faults.append(f"{tag}: {n} {st}")
        bad = validate.table_mismatches(_read_output(got, n),
                                        _read_output(want, n))
        if bad:
            faults.append(f"{tag}: {n} disagrees with numpy: {bad}")
    return faults


def phase_templates(nt, ck, sf: float, tmp: str, device: str = "cuda"):
    """Every unit of every template at `sf` through the drivers: stream
    files 0-2 from the port's streams (seed SEED); a cold power run of
    stream 0 (warmup 0: every unit records) and a warm one (warmup 2: the
    compile pass, then compiled runs), strict, their outputs held against
    a numpy power run of stream 0 (forked, beside them); then throughput
    over streams 1 and 2 and QUERIES, strict (a stream whose statements
    fell back to the host fails), in process mode (one power process a
    stream) and in service mode (every query through one QueryService),
    the outputs of both held against numpy runs of the same streams.
    Counters zeroed just before the cold run, read just after the warm
    one. Returns the counter totals."""
    import multiprocessing
    from nds_tpu_torch import datagen, power, streams, throughput
    from nds_tpu_torch.engine.torch_backend import compiled
    data = os.path.join(tmp, "templates_data")
    root = os.path.join(tmp, "templates")
    t0 = time.perf_counter()
    datagen.generate(data, sf, parallel=len(os.sched_getaffinity(0)))
    emit("templates_data", sf=sf, generate_s=time.perf_counter() - t0,
         csv_bytes=sum(os.path.getsize(os.path.join(r, f))
                       for r, _, fs in os.walk(data) for f in fs))
    sdir = os.path.join(root, "streams")
    paths = streams.generate_query_streams(sdir, 3, SEED)
    with open(paths[0]) as f:
        names = list(power.gen_sql_from_stream(f.read()))
    subset = [f"query{q}" for q in QUERIES]
    # the numpy runs, forked now, beside the device runs
    ctx = multiprocessing.get_context("fork")
    bases = sorted({n.split("_part")[0] for n in names})
    np_out, np_tp = os.path.join(root, "numpy_out"), \
        os.path.join(root, "numpy_tp_out")
    forks = [ctx.Process(target=_numpy_power, args=(
        data, paths[0], np_out, os.path.join(root, f"numpy_{i}.csv"),
        bases[i::NUMPY_CHUNKS])) for i in range(NUMPY_CHUNKS)]
    forks.append(ctx.Process(target=_numpy_throughput, args=(
        data, sdir, os.path.join(root, "numpy_tp_logs"), np_tp, subset)))
    t_np = time.perf_counter()
    for p in forks:
        p.start()
    compiled.clear_shared_programs()    # another data set
    ck.reset_launches()                 # the path starts here
    t1 = time.perf_counter()
    cold = power_run(data, paths[0], root, "cold", warmup=0, strict=True,
                     device=device)
    warm = power_run(data, paths[0], root, "warm", warmup=POWER_WARMUP,
                     strict=True, device=device)
    totals = dict(ck.LAUNCHES)          # read just after the path
    power_s = time.perf_counter() - t1
    failed = _run_faults(cold, "cold", "record") + \
        _run_faults(warm, "warm", "compiled")
    if sorted(cold["status"]) != sorted(names):
        failed.append(f"cold: {len(cold['status'])} units, not "
                      f"{len(names)}")
    # throughput over streams 1 and 2: process mode, then service mode
    tps = {}
    props = None
    if device == "cpu":
        props = os.path.join(root, "cpu.properties")
        with open(props, "w") as f:
            f.write("nds.tpu.device=cpu\n")
    for mode in ("process", "service"):
        t2 = time.perf_counter()
        logs = os.path.join(root, f"tp_{mode}_logs")
        elapsed = throughput.run_throughput(
            data, sdir, list(THROUGHPUT_STREAMS), logs, input_format="csv",
            output_prefix=os.path.join(root, f"tp_{mode}_out"),
            sub_queries=subset, mode=mode, strict=True,
            **({"property_file": props} if mode == "process"
               else {"device": device}))
        runs = {}
        for s in THROUGHPUT_STREAMS:
            with open(throughput.stream_log_path(logs, s)) as f:
                rows = [r for r in f.read().splitlines() if r]
            runs[s] = [r.split(",")[0] for r in rows[2:-2]]
            if sorted(n.split("_part")[0] for n in runs[s]) != \
                    sorted(n.split("_part")[0] for n in names
                           if n.split("_part")[0] in subset):
                failed.append(f"throughput {mode}: stream {s} ran "
                              f"{runs[s]}")
        tps[mode] = {"elapsed_s": elapsed,
                     "wall_s": time.perf_counter() - t2,
                     "units": {s: len(r) for s, r in runs.items()}}
    for p in forks:
        p.join()
        if p.exitcode != 0:
            failed.append(f"a numpy run failed (exit {p.exitcode})")
    numpy_s = time.perf_counter() - t_np
    if not failed:
        for run, tag in ((cold, "cold"), (warm, "warm")):
            failed += _outputs_faults(np_out, run["out"], names, tag)
        for s in THROUGHPUT_STREAMS:
            with open(paths[s]) as f:
                tp_names = [n for n in power.gen_sql_from_stream(f.read())
                            if n.split("_part")[0] in subset]
            for mode in tps:
                failed += _outputs_faults(
                    os.path.join(np_tp, f"stream_{s}"),
                    os.path.join(root, f"tp_{mode}_out", f"stream_{s}"),
                    tp_names, f"throughput {mode} stream {s}")
    emit("templates", sf=sf, units=len(names), seconds=time.perf_counter()
         - t0, power_s=power_s, numpy_s=numpy_s, launches=totals,
         cold_power_test_ms=cold["power_test_ms"],
         warm_power_test_ms=warm["power_test_ms"],
         cold_wall_s=cold["wall_s"], warm_wall_s=warm["wall_s"],
         warm_precompile={"units": len(warm["precompile"]),
                          "compiled": warm["precompile"].count("compiled")},
         cold_query_ms=cold["query_ms"], warm_query_ms=warm["query_ms"],
         throughput=tps,
         nojit=dict(sorted({**cold["nojit"], **warm["nojit"]}.items())))
    if failed:
        raise SystemExit("templates: " + "\n".join(failed))
    missing = [k for k, v in totals.items() if v == 0]
    if missing and device == "cuda":    # (the CPU launches no kernel)
        raise SystemExit(f"templates: kernels never launched: {missing}")
    return {"totals": totals}


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
    sort_keys = _test_module("torch_inputs").sort_keys
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
        session = phase_data(nt, args.sf, tmp, refresh=True)
        wh, load_rows = phase_load(tmp)
        recorder = Recorder(ck)
        spare_labels = {f"query{q}" for q in SPARE_SLOT_QUERIES}
        recorder.wrap(kernels, "first_row_per_gid",
                      lambda gid, mask: int(gid.shape[0]),
                      lambda gid, mask: recorder.label
                      if recorder.label in spare_labels else None)
        launches, oracle, query_check = phase_queries(session, ck,
                                                      recorder)
        if args.profile:
            phase_profile(session)
        recorder.unwrap()
        replay = phase_replay(session, ck, oracle)
        service = phase_service(session, ck, loop=args.service_loop)
        del session             # its tables, host and device, are done
        gc.collect()
        torch.cuda.empty_cache()
        power = phase_power(ck, wh, oracle, tmp)
        # the query and replay phases' results against the oracle, which
        # ran beside them and the phases since
        query_check()
        replay.pop("check")()
        service.pop("check")()
        oracle = oracle.results()
        gc.collect()
        torch.cuda.empty_cache()
        scale = args.sf / 10
        ssession = stream_session(nt, wh)
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
        maint = phase_maintenance(nt, ck, wh, os.path.join(tmp, "refresh"),
                                  load_rows, streamed["stream_lowered"],
                                  scale)
        gc.collect()
        torch.cuda.empty_cache()
        phase_spare_slot(recorder)
        emit("largest_inputs", calls=recorder.calls, **{
            k: {reg: f"{_shape(k, a)} from {callers}"
                for reg, a, _, callers in v}
            for k, v in recorder.regimes().items()})
        rows = phase_kernels(ck, recorder, launches, replay, streamed,
                             service, parents=parents)
        templates = phase_templates(nt, ck, args.templates_sf, tmp)
        finish_streamed(streamed)
        maint.pop("finish")()
        for row in rows:
            row["stream_captured_launches"] = {
                ph: st["captured"][row["name"]]
                for ph, st in streamed.items()}
            row["power_launches"] = power["totals"][row["name"]]
            row["maintenance_launches"] = maint["totals"][row["name"]]
            row["templates_launches"] = templates["totals"][row["name"]]
            row["launches"] += row["power_launches"] + \
                row["maintenance_launches"] + row["templates_launches"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    # each row's "launches" counts the calls into the kernel's launch
    # entry in the main paths: the eager query phase, the streamed phases,
    # the service phase, the drivers' phases power and templates and the
    # maintenance phase (apart in "query_launches", "stream_launches",
    # "service_launches", "power_launches", "templates_launches" and
    # "maintenance_launches");
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
