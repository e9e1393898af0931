#!/usr/bin/env python3
"""Smoke run of nds_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--sf 10] [--profile]

Phases, one JSON line each:

1. card and build: the card's name and power limit (nvidia-smi), and the
   three CUDA kernels compiled from nds_tpu_torch/csrc/ with nvcc;
2. data: NDS tables generated at --sf by the native generator into a
   temporary directory and registered from CSV, decimals as exact int64;
3. queries: NDS queries 3, 7, 9, 42, 55 and 96 (stream 0, template
   seed 3) through Session.sql(backend="torch") on the card, strict (a
   node that falls back to the host fails the run), cold and warm, held
   against the port's numpy executor on the same session.
   The launch counters are zeroed just before and read just after, and
   every kernel must have launched;
4. kernels: each kernel on the largest inputs the query phase gave it,
   and on edge cases, held bit-identical against its plain PyTorch
   version on the card, and timed beside the plain version, one PyTorch
   library call and the least time the card's memory rate allows.

Then the kernel table as one JSON line and, last, the device line. Any
failure raises and exits non-zero; without CUDA the run stops at once.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPLACES = {
    "sort_pairs": "nds_tpu/engine/jax_backend/pallas_kernels.py:278",
    "seg_reduce_multi": "nds_tpu/engine/jax_backend/pallas_kernels.py:382",
    "take_many": "nds_tpu/engine/jax_backend/pallas_kernels.py:461",
}
QUERIES = (3, 7, 9, 42, 55, 96)
SEED = 3
#: the card the bounds are computed for, and its memory rate (NVIDIA data
#: sheet), bytes/s
CARD = "H100 80GB HBM3"
MEM_RATE = 3.35e12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# ---------------------------------------------------------------------------
# recording the inputs the main path gives each kernel
# ---------------------------------------------------------------------------

class Recorder:
    """Wraps each kernel wrapper of cuda_kernels and keeps (a copy of) the
    inputs of its largest call; the wrapper itself runs unchanged."""

    def __init__(self, ck):
        self.ck = ck
        self.largest: dict = {}
        self.calls: dict = {}
        self.orig: dict = {}
        for name, size in (("sort_pairs", lambda k, i: int(k.shape[0])),
                           ("seg_reduce_multi",
                            lambda ops, g, s: int(g.shape[0]) * len(ops)),
                           ("take_many",
                            lambda srcs, i: int(i.shape[0]) * len(srcs))):
            self._wrap(name, size)

    def _wrap(self, name, size):
        orig = self.orig[name] = getattr(self.ck, name)

        def wrapped(*args, **kwargs):
            n = size(*args)
            self.calls[name] = self.calls.get(name, 0) + 1
            if n > self.largest.get(name, (-1, None))[0]:
                self.largest[name] = (n, _clone(args), kwargs)
            return orig(*args, **kwargs)
        setattr(self.ck, name, wrapped)


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

def time_ms(fn, reps: int = 5, warm: int = 2) -> float:
    """Median device time of one call, by CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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


def phase_data(nt, sf: float, tmp: str, device: str = "cuda"):
    from nds_tpu_torch import datagen
    data = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    datagen.generate(data, sf, parallel=len(os.sched_getaffinity(0)))
    gen_s = time.perf_counter() - t0
    session = nt.Session(nt.EngineConfig(decimal_physical="i64"),
                         device=device)
    names = datagen.setup_tables(session, data, use_decimal=True)
    emit("data", sf=sf, generate_s=gen_s, tables=len(names),
         csv_bytes=sum(os.path.getsize(os.path.join(r, f))
                       for r, _, fs in os.walk(data) for f in fs))
    return session


def phase_queries(session, ck) -> dict:
    import torch
    from nds_tpu_torch import streams
    from nds_tpu_torch.validate import table_mismatches
    per_query = {}
    ck.reset_launches()                 # the main path starts here
    for q in QUERIES:
        sql = streams.instantiate(q, stream=0, rngseed=SEED)
        before = dict(ck.LAUNCHES)
        walls = []
        for _ in range(2):              # cold (loads + uploads), warm
            t0 = time.perf_counter()
            got = session.sql(sql, backend="torch")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if session.last_fallbacks:
                raise SystemExit(f"query{q}: host fallback "
                                 f"{session.last_fallbacks}")
        launches = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}
        t0 = time.perf_counter()
        want = session.sql(sql, backend="numpy")
        oracle_s = time.perf_counter() - t0
        bad = table_mismatches(got, want)
        if bad:
            raise SystemExit(f"query{q} disagrees with the numpy oracle: "
                             f"{bad}")
        per_query[q] = launches
        emit("query", query=f"query{q}", cold_s=walls[0], warm_s=walls[1],
             oracle_s=oracle_s, rows=got.num_rows, launches=launches,
             peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    totals = dict(ck.LAUNCHES)          # read just after the main path
    missing = [k for k, v in totals.items() if v == 0]
    if missing:
        raise SystemExit(f"kernels never launched on the main path: "
                         f"{missing}")
    emit("launches", totals=totals)
    return totals


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

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
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


def _edge_cases(torch, dev):
    """Inputs beyond what the queries gave: ties, sentinels, non-power-of-
    two lengths, int32 keys, non-iota and iota idx; out-of-range gids, S = 1 and
    2048, narrow ints, float min/max with NaN and signed zeros; bool and
    float gathers with clamped and wrapped indices."""
    g = torch.Generator(device="cpu").manual_seed(7)

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
    n = 50001
    for S in (1, 37, 2048):
        gid = ri(-3, S + 3, n, torch.int32)
        ops = [(ri(-100, 100, n, dt), op)
               for dt in (torch.int8, torch.int16, torch.int32, torch.int64)
               for op in ("sum", "min", "max")]
        x = torch.randn(n, generator=g, dtype=torch.float64).to(dev)
        x[::97] = float("nan")
        x[1::89] = 0.0
        x[2::89] = -0.0
        ops += [(x, "min"), (x, "max"), (x.float(), "min"),
                (x.float(), "max")]
        cases.append(("seg_reduce_multi", (ops, gid, S), {}))
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


def phase_kernels(ck, recorder, launches, device: str = "cuda") -> list:
    import torch
    dev = torch.device(device)
    rows = []
    checks = [(n, *recorder.largest[n][1:], True) for n in ck.LAUNCHES] + \
        [(n, a, kw, False) for n, a, kw in _edge_cases(torch, dev)]
    for name, args, kwargs, main in checks:
        kern = recorder.orig[name]
        plain = _plain(ck, name)
        got = kern(*args, **kwargs)
        want = plain(*args)
        torch.cuda.synchronize()
        got = list(got)
        want = list(want)
        ok, err = same_bits(got, want)
        if not ok:
            raise SystemExit(f"{name} ({_shape(name, args)}) differs from "
                             f"its plain version (max abs err {err})")
        if not main:
            emit("kernel_edge", kernel=name, shape=_shape(name, args),
                 bit_identical=True)
            continue
        ms = time_ms(lambda: kern(*args, **kwargs))
        plain_ms = time_ms(lambda: plain(*args))
        library_ms = time_ms(_library(torch, name, args))
        bound_ms = _bytes(name, args) / MEM_RATE * 1e3
        row = {"name": name, "route": "cuda",
               "source": f"nds_tpu_torch/csrc/{ck.SOURCES[name]}",
               "replaces": REPLACES[name], "launches": launches[name],
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": "bytes",
               "library_ms": library_ms}
        emit("kernel", shape=_shape(name, args), bit_identical=True, **row)
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--profile", action="store_true",
                    help="profile one more warm run of each query")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import nds_tpu_torch as nt
    from nds_tpu_torch.engine.torch_backend import cuda_kernels as ck

    t_start = time.perf_counter()
    smi = phase_card_build(ck)
    if torch.cuda.get_device_name(0) != f"NVIDIA {CARD}":
        raise SystemExit(f"the bounds are for the {CARD}, not "
                         f"{torch.cuda.get_device_name(0)}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        session = phase_data(nt, args.sf, tmp)
        recorder = Recorder(ck)
        launches = phase_queries(session, ck)
        if args.profile:
            phase_profile(session)
        emit("largest_inputs", **{k: _shape(k, v[1])
                                  for k, v in recorder.largest.items()},
             calls=recorder.calls)
        rows = phase_kernels(ck, recorder, launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
