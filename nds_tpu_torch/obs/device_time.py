# Copied from nds_tpu/obs/device_time.py; completion is a
# torch.cuda.synchronize() where the reference fetches a JAX result, and the
# port's CompiledQuery reports a replay's graph time (CUDA events).
"""Per-program device-time attribution.

The engine's compiled-program boundary (``CompiledQuery.run``) is where
instrumentation must live (the Flare lesson, PAPERS.md): each dispatch is
one program — a whole query, a CTE/rollup segment, or a fused morsel
group. Every run reports its measured time here under the program's
label ("query9/root"), so the registry can rank programs by device time
in a sorted "top programs by device time" table.

On the card a run reports its CUDA graph's time (CUDA events around the
replay, ``graph_ms``); on the CPU, and for a batched program, the wall of
the run including the result's copy to the host. ``record_cost`` takes a
cost analysis of bytes and operations; the port has none yet (ROADMAP
A.6, "Compiling ahead"), so ``roofline_frac`` stays unset.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ProgramStat:
    """Accumulated execution record of one compiled program."""
    label: str
    runs: int = 0
    device_ms: float = 0.0          # summed measured dispatch+fetch wall
    max_ms: float = 0.0
    #: the program's first (compile+run) dispatch, kept separate so
    #: steady-state means — and the rooflines derived from them — are not
    #: diluted by one-time compile cost
    first_ms: Optional[float] = None
    flops: Optional[float] = None           # per-execution, cost_analysis
    bytes_accessed: Optional[float] = None  # per-execution, cost_analysis
    extra: dict = field(default_factory=dict)

    def steady_mean_ms(self) -> float:
        """Mean over steady-state (post-first) runs; falls back to the
        overall mean when only the first run exists."""
        if self.first_ms is not None and self.runs > 1:
            return (self.device_ms - self.first_ms) / (self.runs - 1)
        return self.device_ms / self.runs if self.runs else 0.0


class ProgramRegistry:
    """Thread-safe label -> ProgramStat accumulator (compile pools and
    concurrent streams report simultaneously)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._programs: dict[str, ProgramStat] = {}

    def record_run(self, label: str, device_ms: float,
                   first: bool = False) -> None:
        with self._lock:
            st = self._programs.get(label)
            if st is None:
                st = ProgramStat(label)
                self._programs[label] = st
            st.runs += 1
            st.device_ms += device_ms
            st.max_ms = max(st.max_ms, device_ms)
            if first and st.first_ms is None:
                st.first_ms = device_ms

    def record_cost(self, label: str, cost) -> None:
        """Attach a cost analysis ({"flops": ..., "bytes accessed": ...},
        or a list of such dicts). Unknown shapes are ignored — cost data
        enriches the table, it never fails a run. Nothing in the port
        feeds it yet."""
        entry = None
        if isinstance(cost, dict):
            entry = cost
        elif isinstance(cost, (list, tuple)) and cost and \
                isinstance(cost[0], dict):
            entry = cost[0]
        if entry is None:
            return
        flops = entry.get("flops")
        bytes_accessed = entry.get("bytes accessed")
        with self._lock:
            st = self._programs.get(label)
            if st is None:
                st = ProgramStat(label)
                self._programs[label] = st
            if flops is not None:
                st.flops = float(flops)
            if bytes_accessed is not None:
                st.bytes_accessed = float(bytes_accessed)

    def total_ms(self) -> float:
        with self._lock:
            return sum(s.device_ms for s in self._programs.values())

    def table(self, bw_gbps: float = 100.0, top: Optional[int] = None
              ) -> list[dict]:
        """Sorted (desc by total device time) per-program rows.

        ``roofline_frac`` is per program: the fraction of the wire/HBM
        bandwidth `bw_gbps` the program's cost-analysis bytes would
        saturate over its mean measured run — the program-local version of
        the bench's global number, so the slowest-and-least-bound programs
        (the kernel targets) sort to the top with their own utilization
        attached."""
        with self._lock:
            stats = sorted(self._programs.values(),
                           key=lambda s: s.device_ms, reverse=True)
        rows = []
        for s in stats[:top] if top else stats:
            mean_ms = s.steady_mean_ms()
            row = {
                "program": s.label,
                "runs": s.runs,
                "device_ms": round(s.device_ms, 3),
                "mean_ms": round(mean_ms, 3),
                "max_ms": round(s.max_ms, 3),
            }
            if s.first_ms is not None:
                row["first_ms"] = round(s.first_ms, 3)
            if s.flops is not None:
                row["flops"] = s.flops
            if s.bytes_accessed is not None:
                row["bytes_accessed"] = s.bytes_accessed
                if mean_ms > 0:
                    ideal_s = s.bytes_accessed / (bw_gbps * 1e9)
                    row["roofline_frac"] = round(
                        ideal_s / (mean_ms / 1e3), 5)
            rows.append(row)
        return rows

    def snapshot(self) -> dict[str, ProgramStat]:
        with self._lock:
            return dict(self._programs)

    def reset(self) -> None:
        with self._lock:
            self._programs = {}


#: process-global registry; CompiledQuery.run reports into it.
PROGRAMS = ProgramRegistry()


def timed_call(fn, *args) -> tuple[float, object]:
    """One measured call of ``fn(*args)``: returns (wall ms, result).

    The completion barrier is ``torch.cuda.synchronize()`` when CUDA is
    initialised (the call may have queued work on the card); on the CPU
    the call has finished when it returns."""
    import time as _time

    import torch
    t0 = _time.perf_counter()
    out = fn(*args)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return (_time.perf_counter() - t0) * 1000.0, out


def measure_ms(fn, *args, iters: int = 3, warmup: int = 1,
               label: Optional[str] = None) -> float:
    """Best-of-`iters` synchronised wall ms of ``fn(*args)`` after `warmup`
    untimed calls (compile excluded). With `label`, every timed run also
    reports into ``PROGRAMS`` so kernel microbenches surface in the same
    per-program attribution table as the engine's compiled queries."""
    for _ in range(max(0, warmup)):
        timed_call(fn, *args)
    best = float("inf")
    for _ in range(max(1, iters)):
        ms, _ = timed_call(fn, *args)
        best = min(best, ms)
        if label is not None:
            PROGRAMS.record_run(label, ms)
    return best


def coverage(table_rows: list[dict], measured_wall_ms: float) -> float:
    """Fraction of a measured wall-clock interval the per-program device
    times account for (the >=90% attribution acceptance check)."""
    if measured_wall_ms <= 0:
        return 0.0
    return sum(r["device_ms"] for r in table_rows) / measured_wall_ms


def format_table(rows: list[dict]) -> str:
    """Fixed-width text rendering of ``ProgramRegistry.table`` rows for
    stderr diagnostics / trace_report."""
    if not rows:
        return "(no programs recorded)"
    head = (f"{'program':<40} {'runs':>5} {'total_ms':>10} {'mean_ms':>9} "
            f"{'roofline':>9}")
    lines = [head, "-" * len(head)]
    for r in rows:
        rf = r.get("roofline_frac")
        lines.append(
            f"{r['program'][:40]:<40} {r['runs']:>5} {r['device_ms']:>10.1f} "
            f"{r['mean_ms']:>9.2f} "
            f"{(f'{rf:.4f}' if rf is not None else '-'):>9}")
    return "\n".join(lines)
