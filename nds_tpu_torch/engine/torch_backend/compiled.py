"""Compiled replay: a plan's capacity schedule recorded once, then replayed.

Counterpart of the compiled half of ``nds_tpu/engine/jax_backend/executor.py``
(``CompiledQuery``, the decision recorder, the shared-program registry).
The eager pass records every host decision of a plan (the capacity
schedule); a replay executes the plan again with the recorded values in
place of the host syncs, and returns one check scalar per decision so that
the caller can verify the schedule still fits the data (a failed check
raises ReplayMismatch, and the caller records again).

On a CUDA device a compiled program is a ``torch.cuda.CUDAGraph``: its
first run replays the plan once on the executor's stream (which uploads the
program's constants and sizes kernel scratch), then captures a second
replay as a graph, with hoisted literals in static parameter slots. Every
later run fills the slots, replays the graph and fetches the result and the
checks in one synchronise. On the CPU the replay runs without a capture,
its plain form. XLA's ahead-of-time compile and cost analysis have no
counterpart here.

``BatchedQuery`` replays one unit program over a stacked batch of
parameter vectors, the query service's compatible-plan batching: on CUDA
one graph per (program, batch capacity) runs the unit's replay once a row.
A batch splits into rungs of the capacity ladder (``batch_rungs``), so
that no graph runs a padding row.

A program is bound to its scans' wire layout (device.scan_layout: a
packed morsel slot's lanes, encodings and codebook identities), as the
reference's pytree aux binds its jit cache entry: a run over another
layout raises ReplayMismatch, so that the caller records and captures
again, and the shared-program key includes it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time
import warnings
import weakref
from typing import Optional

import numpy as np
import torch

from ...obs import metrics as _metrics
from ...obs.device_time import PROGRAMS
from ...obs.flight import FLIGHT
from ...resilience import FAULTS
from ..plan import MaterializedNode, iter_plan_nodes
from . import cuda_kernels as _ck
from .device import (DTable, PackedTable, Uploads, bucket, phys_dtype,
                     scan_layout, uploads_active)


class NotJittable(Exception):
    """Raised under replay when a plan needs host-side data-dependent
    work."""


class ReplayMismatch(Exception):
    """A compiled plan's capacity schedule no longer fits the data."""


class ArgSpecMismatch(ValueError):
    """Arguments do not fit a compiled program's input contract; the
    message names each argument that drifted."""


class StatementAbandoned(RuntimeError):
    """The executor running this statement was abandoned (a deadline gave
    the statement up, Session.abandon_inflight): the worker stops at its
    next program run or plan node instead of racing the next statement
    on the card."""


#: errors that mark a unit "nojit": it runs eager from then on
NOJIT_ERRORS = (NotJittable, NotImplementedError)

#: one capture at a time in a process: a capture empties the allocator's
#: cache first, which must not run beside another thread's capture (one
#: Session per stream thread shares the card in the throughput's thread
#: mode)
_CAPTURE_LOCK = threading.Lock()


def check_abandoned(owner) -> None:
    """Raise StatementAbandoned when `owner` (an executor) was abandoned."""
    if owner is not None and owner.abandoned:
        raise StatementAbandoned(
            "statement abandoned (its deadline passed); stopping before "
            "the next device work")


class Recorder:
    """Capacity-decision schedule: recorded eagerly, consumed by replay."""
    __slots__ = ("mode", "decisions", "idx", "checks", "nodes")

    def __init__(self, mode: str, decisions: Optional[list] = None):
        self.mode = mode                    # "record" | "replay"
        self.decisions = decisions if decisions is not None else []
        self.idx = 0
        self.checks: list = []              # device actuals (replay only)
        # record mode: the plan node whose execution made each decision
        # (None: a decision with no row semantics)
        self.nodes: list = []


# Cross-stream/-session program registry: stream variants of one template
# parameterize to the same plan (parameterize_plan), so the first stream's
# recorded schedule serves every later stream with other parameter values.
# Keyed by a structural plan fingerprint; capacity drift between streams is
# caught by verify_schedule and repaired by recording again with per-slot
# max-merged caps; exact-decision drift marks the entry volatile. A
# captured CUDA graph reads its own executor's scans, so another executor
# adopts the schedule and captures its own graph; the registry keeps a
# program by weak reference (its graph holds device memory).
_SHARED_PROGRAMS: dict = {}
_SHARED_LOCK = threading.Lock()

#: ReplayMismatch strikes per shared fingerprint (quarantine below)
_PROGRAM_STRIKES: dict = {}
#: strikes before a shared entry is quarantined (evicted, recorded again
#: on next use): one drift is normal life, the same entry failing again
#: and again means its schedule is poisoned
QUARANTINE_STRIKES = 3


def shared_program(entry: dict, owner) -> Optional["CompiledQuery"]:
    """A registry entry's program, where `owner` captured it and it is
    still alive."""
    ref = entry.get("cq")
    cq = ref() if ref is not None else None
    return cq if cq is not None and cq.owner is owner else None


def clear_shared_programs() -> None:
    """Test hook: drop all cross-session shared programs."""
    with _SHARED_LOCK:
        _SHARED_PROGRAMS.clear()
        _PROGRAM_STRIKES.clear()


def strike_shared_program(fp: Optional[str], reason: str = "") -> bool:
    """Record one fault or ReplayMismatch strike against a shared program.

    At QUARANTINE_STRIKES the entry is quarantined: evicted from the
    registry (its strike history cleared), so that the next use records
    and publishes a fresh schedule instead of every adopter replaying the
    poisoned one. Returns True when this strike evicted the entry; counted
    in ``quarantined_programs`` and recorded as a flight ``quarantine``
    event with `reason`."""
    if fp is None:
        return False
    with _SHARED_LOCK:
        n = _PROGRAM_STRIKES.get(fp, 0) + 1
        _PROGRAM_STRIKES[fp] = n
        if n < QUARANTINE_STRIKES:
            return False
        _PROGRAM_STRIKES.pop(fp, None)
        if _SHARED_PROGRAMS.pop(fp, None) is None:
            return False
    FLIGHT.record("quarantine", fp=fp[:12], strikes=n,
                  reason=reason or "repeated failures")
    _metrics.QUARANTINED_PROGRAMS.inc()
    return True


def shared_programs_snapshot() -> list:
    """One row per shared registry entry, cut atomically under the
    registry lock: ``hits`` counts adoptions, ``compiles`` the programs
    published under the fingerprint, ``strikes`` the live quarantine
    strikes (an entry at QUARANTINE_STRIKES is already evicted)."""
    with _SHARED_LOCK:
        return [{"fingerprint": fp,
                 "hits": sh.get("adoptions", 0),
                 "compiles": sh.get("compiles", 0),
                 "strikes": _PROGRAM_STRIKES.get(fp, 0),
                 "volatile": bool(sh.get("volatile")),
                 "nojit": bool(sh.get("nojit")),
                 "decisions": len(sh.get("decisions", ()))}
                for fp, sh in sorted(_SHARED_PROGRAMS.items())]


def absolve_shared_program(fp: Optional[str]) -> None:
    """A successful run through the shared entry clears its strikes."""
    if fp is None:
        return
    with _SHARED_LOCK:
        _PROGRAM_STRIKES.pop(fp, None)


def shared_fingerprint(pplan, gpu_ops: frozenset,
                       layouts: tuple = ()) -> str:
    """Registry key of a parameterized unit plan: its structure (a morsel
    scan's lanes and encodings are ScanNode fields), the kernel choice
    (replay must take the kernels the record pass took) and its packed
    scans' layouts (scan_layout: the codebooks' identities too)."""
    body = plan_fingerprint(pplan)
    ops = ",".join(sorted(gpu_ops))
    key = f"{body}|gpu={ops}"
    if any(lay is not None for lay in layouts):
        key += f"|layout={layouts!r}"
    return hashlib.sha1(key.encode()).hexdigest()


def plan_fingerprint(node) -> str:
    """Stable structural hash of a plan subtree, literals included, so that
    stream-parameterized plans never collide. MaterializedNodes hash by
    identity."""
    parts: list[str] = []

    def rec(x):
        if isinstance(x, MaterializedNode):
            parts.append(f"mat:{id(x)}")
            return
        if isinstance(x, np.ndarray):
            # repr truncates long arrays: hash the content
            parts.append(f"nd{x.dtype}{x.shape}:" + (
                repr(x.tolist()) if x.dtype == object
                else hashlib.sha1(x.tobytes()).hexdigest()))
            return
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            parts.append(type(x).__name__ + "(")
            for f in dataclasses.fields(x):
                parts.append(f.name + "=")
                rec(getattr(x, f.name))
                parts.append(",")
            parts.append(")")
        elif isinstance(x, (list, tuple)):
            parts.append("[")
            for v in x:
                rec(v)
                parts.append(",")
            parts.append("]")
        else:
            parts.append(repr(x))

    rec(node)
    return hashlib.sha1("".join(parts).encode()).hexdigest()[:16]


def node_labels(root) -> dict[int, str]:
    """Stable preorder labels 'TypeName#k' for every distinct plan node."""
    labels: dict[int, str] = {}
    counts: dict[str, int] = {}
    for n in iter_plan_nodes(root):
        t = type(n).__name__
        counts[t] = counts.get(t, 0) + 1
        labels[id(n)] = f"{t}#{counts[t] - 1}"
    return labels


def node_rows(decisions: list, labels: tuple, actuals: list) -> dict:
    """{TypeName#k: actual rows} from index-aligned (decision, label,
    actual) triples; a node with several decisions keeps its largest."""
    rows: dict = {}
    for (kind, _planned), lbl, actual in zip(decisions, labels, actuals):
        if lbl is None or kind not in ("cap", "exact"):
            continue
        a = int(actual)
        if lbl not in rows or a > rows[lbl]:
            rows[lbl] = a
    return rows


def verify_schedule(decisions: list, checks_host: list) -> None:
    for (kind, planned), actual in zip(decisions, checks_host):
        a = int(actual)
        if kind == "cap":
            if a > bucket(max(int(planned), 1)):
                raise ReplayMismatch(f"capacity overflow: {a} > planned "
                                     f"{planned}")
        elif a != int(planned):
            raise ReplayMismatch(f"exact decision drift: {a} != {planned}")


def _no_load(name: str, columns=None):
    raise NotJittable(f"table load of {name!r} under replay")


def _replay_without_syncs(label: str, replay) -> None:
    """A capture's first replay, under the sync debug mode: it uploads the
    program's constants, sizes kernel scratch and runs each kernel's
    one-time setup, and fails naming every host sync it meets (a capture
    would fail on them)."""
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            replay()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    syncs = sorted({f"{os.path.basename(w.filename)}:{w.lineno}"
                    for w in caught if "called a synchronizing"
                    in str(w.message)})
    if syncs:
        raise RuntimeError(f"{label}: the replay waits on the device at "
                           f"{syncs}")


def _program_made() -> None:
    """A program is made (a CUDA graph captured, or a program's first run
    on the CPU): the reference's compile seam, its fault point and its
    ``compiles`` counter."""
    FAULTS.fire("jax.compile")
    _metrics.COMPILES.inc()


def _flat(t: DTable) -> list:
    """A table's tensors in a fixed order: alive, then each column's data
    and validity (a packed table: its one buffer)."""
    if isinstance(t, PackedTable):
        return [t.data]
    out = [t.alive]
    for c in t.cols:
        out += [c.data, c.valid]
    return out


def _unflat(t: DTable, flat: list) -> DTable:
    cols = [dataclasses.replace(c, data=flat[1 + 2 * i],
                                valid=flat[2 + 2 * i])
            for i, c in enumerate(t.cols)]
    return DTable(list(t.names), cols, flat[0])


def _flat_out(out) -> list:
    """The tensors of a program's output: one DTable, or a tuple of them
    (a multi-plan program), in order."""
    if isinstance(out, tuple):
        return [x for t in out for x in _flat(t)]
    return _flat(out)


def _unflat_out(out, flat: list):
    if not isinstance(out, tuple):
        return _unflat(out, flat)
    tables, i = [], 0
    for t in out:
        n = 1 + 2 * len(t.cols)
        tables.append(_unflat(t, flat[i:i + n]))
        i += n
    return tuple(tables)


class CompiledQuery:
    """One unit plan replayed from its recorded capacity schedule.

    Scans enter as a dict keyed by scan key (first-touch order in
    ``scan_keys``) and hoisted literals as a parameter vector, so every
    stream of a template replays the same program. ``owner`` is the
    executor whose scans, stream and graph pool a capture uses.

    ``plan`` may be a LIST of plans (a shared-scan morsel group, recorded
    by TorchExecutor.record_plans): the plans replay in order under one
    schedule, with the memo reset between them as in the record pass, into
    one CUDA graph; run() then returns a tuple of DTables."""

    def __init__(self, plan, decisions: list, scan_keys: tuple, owner,
                 param_dtypes: tuple = (), label: str = "",
                 decision_nodes: Optional[tuple] = None):
        self.plan = plan
        self.decisions = decisions
        self.scan_keys = scan_keys
        # weak: the owner's unit entries hold the program, and the shared
        # registry must not keep a dropped executor's graphs alive
        self._owner = weakref.ref(owner)
        self.param_dtypes = param_dtypes
        self.label = label or "program"
        self.decision_nodes = decision_nodes
        self.gpu_ops = owner.gpu_ops
        self.device = owner.device
        self._first = True
        self._uploads: Optional[Uploads] = None
        # CUDA: the graph, its static parameter slots and outputs, and the
        # scans' addresses it was captured against
        self._graph = None
        self._slots: tuple = ()
        self._out = None
        self._checks = None
        self._ptrs = None
        self._specs_at_capture = None
        self.captured_launches: dict = {}
        self._prepared: dict = {}        # stats of prepare(), for the run
        # the wire layouts of the scans the schedule was recorded over
        # (the owner's scan cache holds them when the program is made)
        self.layouts = tuple(scan_layout(owner._scan_cache.get(k))
                             for k in scan_keys)

    @property
    def owner(self):
        return self._owner()

    def _replay(self, scans: dict, params: tuple):
        """Execute the plan under the recorded schedule: (output DTable,
        int64 check vector)."""
        from .executor import TorchExecutor
        rec = Recorder("replay", self.decisions)
        ex = TorchExecutor(_no_load, self.device, gpu_kernels=self.gpu_ops,
                           recorder=rec, scan_tables=scans, params=params)
        if isinstance(self.plan, (list, tuple)):
            outs = []
            for p in self.plan:
                ex._memo = {}
                outs.append(ex.execute(p))
            out = tuple(outs)
        else:
            out = ex.execute(self.plan)
        if rec.idx != len(rec.decisions):
            raise NotJittable("decision schedule length drift")
        if ex.fallback_nodes:
            raise NotJittable(f"fallback under replay: {ex.fallback_nodes}")
        checks = torch.stack(rec.checks) if rec.checks else \
            torch.zeros(0, dtype=torch.int64, device=self.device)
        return out, checks

    def _args(self, scans: dict, values: tuple) -> dict:
        missing = [k for k in self.scan_keys if k not in scans]
        if missing:
            raise ArgSpecMismatch(
                f"missing scan argument(s) {missing} (program takes "
                f"{len(self.scan_keys)} scan(s): {list(self.scan_keys)})")
        if len(values) != len(self.param_dtypes):
            raise ArgSpecMismatch(
                f"parameter vector length mismatch: program expects "
                f"{len(self.param_dtypes)} hoisted parameter(s) with dtypes "
                f"{list(self.param_dtypes)}, got {len(values)} value(s)")
        layouts = tuple(scan_layout(scans[k]) for k in self.scan_keys)
        if layouts != self.layouts:
            # another wire layout is another program: record again
            raise ReplayMismatch(f"scan layout changed: {layouts} != "
                                 f"recorded {self.layouts}")
        return {k: scans[k] for k in self.scan_keys}

    def _specs(self, scans: dict) -> list:
        return [(k, [(tuple(t.shape), t.dtype) for t in _flat(scans[k])])
                for k in self.scan_keys]

    def prepare(self, scans: dict, values: tuple = ()) -> None:
        """Compile ahead of the first run (the reference's precompile at
        the second sighting of a multi-unit query, serial here): on CUDA
        the first replay and the capture, on the CPU the replay that makes
        the constant uploads. The next run() is then "compiled"."""
        scans = self._args(scans, values)
        if self.device.type == "cuda":
            with torch.cuda.stream(self.owner.stream):
                self._prepared = self._capture(scans, values)
        else:
            _program_made()
            self._run_plain(scans, values)
        self._first = False

    def run(self, scans: dict, values: tuple = (),
            stats: Optional[dict] = None,
            keep_device: bool = False):
        """One run; returns the output DTable (a tuple of them for a list of
        plans), on the host (CPU tensors) unless ``keep_device``. Raises
        ReplayMismatch when a check fails."""
        scans = self._args(scans, values)
        first = self._first
        FAULTS.fire("jax.execute")
        check_abandoned(self.owner)
        t1 = time.perf_counter()
        if self.device.type == "cuda":
            out, checks_host, extra = self._run_graph(scans, values,
                                                      keep_device)
        else:
            if first:
                _program_made()
            out, checks_host, extra = self._run_plain(scans, values)
        t2 = time.perf_counter()
        self._first = False
        verify_schedule(self.decisions, checks_host)
        # the graph's own time on the card, the run's wall on the CPU
        PROGRAMS.record_run(self.label, round(extra.get(
            "graph_ms", (t2 - t1) * 1000), 3), first=first)
        if stats is not None:
            stats.update(self._prepared)
            self._prepared = {}
            stats.update(extra)
            if self.decision_nodes:
                rows = node_rows(self.decisions, self.decision_nodes,
                                 checks_host)
                if rows:
                    stats["node_rows"] = rows
            stats.update(mode="compile+run" if first else "compiled",
                         device_ms=round((t2 - t1) * 1000, 3))
        return out

    # -- the plain form (CPU) -------------------------------------------------
    def _run_plain(self, scans: dict, values: tuple):
        params = tuple(torch.full((), v, dtype=phys_dtype(d),
                                  device=self.device)
                       for v, d in zip(values, self.param_dtypes))
        if self._uploads is None:
            self._uploads = Uploads()
        else:
            self._uploads.reuse()
        with uploads_active(self._uploads):
            out, checks = self._replay(scans, params)
        self._check_uploads_used()
        return out, checks.tolist(), {}

    def _check_uploads_used(self) -> None:
        u = self._uploads
        if u.idx is not None and u.idx != len(u.tensors):
            raise NotJittable(f"replay made {u.idx} of its "
                              f"{len(u.tensors)} constant uploads")

    # -- the CUDA graph -------------------------------------------------------
    def _capture(self, scans: dict, values: tuple) -> dict:
        """A first replay on the executor's stream (uploads the constants,
        sizes kernel scratch, runs each kernel's one-time setup, and fails
        on any host sync), then the capture of a second one."""
        _program_made()
        check_abandoned(self.owner)
        with _CAPTURE_LOCK:
            return self._capture_locked(scans, values)

    def _capture_locked(self, scans: dict, values: tuple) -> dict:
        stream = self.owner.stream
        self._graph = self._out = self._checks = None
        t0 = time.perf_counter()
        self._slots = tuple(torch.full((), v, dtype=phys_dtype(d),
                                       device=self.device)
                            for v, d in zip(values, self.param_dtypes))
        self._uploads = Uploads()
        with uploads_active(self._uploads):
            _replay_without_syncs(self.label,
                                  lambda: self._replay(scans, self._slots))
        self._uploads.reuse()
        stream.synchronize()
        # the first replay's intermediates go back to the device, so that
        # the graph's pool does not stand beside them
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(self.device)
        before = dict(_ck.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        # thread-local: another thread's CUDA calls (the streamed path's
        # staging thread copies and waits on its own stream) must not
        # invalidate this capture
        graph.capture_begin(pool=self.owner.graph_pool(),
                            capture_error_mode="thread_local")
        try:
            with uploads_active(self._uploads):
                out, checks = self._replay(scans, self._slots)
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass                  # the capture is invalid already
            raise
        graph.capture_end()
        self._check_uploads_used()
        self._graph, self._out, self._checks = graph, out, checks
        # a graph's replays call no wrapper: the capture's calls are the
        # launches every replay makes
        self.captured_launches = {k: _ck.LAUNCHES[k] - before[k]
                                  for k in _ck.LAUNCHES}
        self._ptrs = [t.data_ptr() for k in self.scan_keys
                      for t in _flat(scans[k])]
        self._specs_at_capture = self._specs(scans)
        return {"capture_s": round(time.perf_counter() - t0, 4),
                "pool_growth_bytes": torch.cuda.memory_reserved(self.device)
                - reserved0,
                "captured_launches": dict(self.captured_launches)}

    def _run_graph(self, scans: dict, values: tuple, keep_device: bool):
        stream = self.owner.stream
        extra: dict = {}
        if self._graph is not None:
            specs = self._specs(scans)
            if specs != self._specs_at_capture:
                bad = [f"scan {k!r}: expected {e}, got {g}"
                       for (k, e), (_, g) in zip(self._specs_at_capture,
                                                 specs) if e != g]
                raise ArgSpecMismatch("compiled program argument mismatch:\n"
                                      + "\n".join(bad))
        ptrs = [t.data_ptr() for k in self.scan_keys
                for t in _flat(scans[k])]
        with torch.cuda.stream(stream):
            if self._graph is None or ptrs != self._ptrs:
                # a graph reads its inputs where they were at capture: a
                # scan evicted and uploaded again needs a new capture
                extra = self._capture(scans, values)
            for slot, v in zip(self._slots, values):
                slot.fill_(v)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            self._graph.replay()
            e1.record()
            flat = _flat_out(self._out)
            if keep_device:
                # segment outputs leave the shared graph pool, which the
                # next replay of any graph may overwrite
                out = _unflat_out(self._out, [t.clone() for t in flat])
                checks_host = self._checks.cpu().tolist()
            else:
                hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for t in flat + [self._checks]]
                for h, t in zip(hosts, flat + [self._checks]):
                    h.copy_(t, non_blocking=True)
                stream.synchronize()        # the run's one host sync
                out = _unflat_out(self._out, hosts[:-1])
                checks_host = hosts[-1].tolist()
        extra["graph_ms"] = e0.elapsed_time(e1)
        return out, checks_host, extra


def _byte_layout(tensors: list) -> tuple:
    """[(offset, dtype, shape)] of `tensors` laid end to end in one byte
    buffer, each section starting at a multiple of 8 bytes (a byte view
    of another dtype needs its section aligned), and the buffer's size."""
    layout, off = [], 0
    for t in tensors:
        layout.append((off, t.dtype, tuple(t.shape)))
        off += -(-t.numel() * t.element_size() // 8) * 8
    return layout, max(off, 8)


def _section(buf: torch.Tensor, off: int, dtype, shape) -> torch.Tensor:
    """The tensor a byte buffer holds at `off` (a view)."""
    n = int(np.prod(shape, dtype=np.int64))
    size = torch.empty((), dtype=dtype).element_size()
    return buf[off:off + n * size].view(dtype).view(shape)


def batch_rungs(n: int) -> list:
    """The capacities a batch of `n` rows runs as, largest first: each the
    largest rung of the row ladder (``bucket(.., minimum=1)``) left within
    the rows, so that they sum to `n`. A graph's rows run one after
    another, so a padding row would cost a whole row's device time; with
    a ladder of powers of two a program has at most log2(max_batch) + 1
    batched graphs."""
    out = []
    while n > 0:
        p = 1 << (n.bit_length() - 1)
        mid = 3 * p // 2                # the ladder's midpoint above p
        r = mid if mid <= n and bucket(mid, minimum=1) == mid else p
        out.append(r)
        n -= r
    return out


class BatchedQuery:
    """One unit program replayed over a stacked batch of parameter vectors:
    the query service's compatible-plan batching unit (the reference's
    ``BatchedQuery``, ``lax.map`` over the stacked parameters).

    K queries that parameterize to one plan fingerprint (same structure,
    schedule and scans, other hoisted literal values) run as one dispatch
    over ``cap`` rows, ``cap`` a rung of the row ladder
    (``bucket(len(rows), minimum=1)``); a short batch pads with its last
    row (TorchExecutor.run_param_batch sends none: it splits a batch into
    full rungs, ``batch_rungs``). Each row replays the program's plan
    (``CompiledQuery._replay``), so its result is the single program's,
    bit for bit.

    On CUDA one graph per (program, cap) holds the ``cap`` replays: row i
    reads its parameters as the views ``slot[i]`` of ``(cap,)`` stacked
    slots, which are sections of one device byte buffer that a run fills
    with one copy from a pinned host buffer; the graph also lays every
    row's outputs and checks into one byte buffer, fetched with one copy
    and one synchronise. Row i's intermediates are freed inside the
    capture, so row i+1 reuses their blocks: the graph's pool holds about
    one row's working set and the ``cap`` rows' outputs. A warm run of a
    known (program, cap) captures nothing (``captures`` counts). On the
    CPU the rows replay in their plain form.

    Checks come back per row: a cap decision holds when its maximum over
    the rows is within the bucket of the planned value, an exact one when
    every row equals it; any other raises ReplayMismatch and the caller
    serves the batch serially."""

    def __init__(self, cq: CompiledQuery, cap: int):
        self.cq = cq
        self.cap = cap
        self.label = f"{cq.label}@batch{cap}"
        self.captures = 0
        self.captured_launches: dict = {}
        self._first = True
        self._uploads: Optional[Uploads] = None
        self._graph = None
        self._pbuf = None            # the stacked slots' device bytes
        self._playout: list = []
        self._slots: tuple = ()
        self._obuf = None            # every row's outputs and checks
        self._olayout: list = []
        self._rows_out = None        # the captured rows' (out, checks)
        self._ptrs = None
        self._specs_at_capture = None

    def run(self, scans: dict, rows: list,
            stats: Optional[dict] = None) -> list:
        """Run `rows` (parameter-value tuples, at most ``cap``) in one
        dispatch; returns one host DTable per row. Raises ReplayMismatch
        when a row's data drift past the recorded schedule."""
        if not rows or len(rows) > self.cap:
            raise ValueError(f"{len(rows)} rows for a batch of {self.cap}")
        full = list(rows) + [rows[-1]] * (self.cap - len(rows))
        for r in full:
            if len(r) != len(self.cq.param_dtypes):
                raise ArgSpecMismatch(
                    f"parameter vector length mismatch: the program "
                    f"expects {len(self.cq.param_dtypes)} parameter(s), a "
                    f"row has {len(r)}")
        scans = self.cq._args(scans, full[0])
        first = self._first
        FAULTS.fire("jax.execute")
        check_abandoned(self.cq.owner)
        t1 = time.perf_counter()
        if self.cq.device.type == "cuda":
            outs, checks, extra = self._run_graph(scans, full)
        else:
            if first:
                _program_made()
            outs, checks, extra = self._run_plain(scans, full)
        t2 = time.perf_counter()
        self._first = False
        for j, (kind, planned) in enumerate(self.cq.decisions):
            col = [int(c[j]) for c in checks]
            if kind == "cap":
                if max(col) > bucket(max(int(planned), 1)):
                    raise ReplayMismatch(
                        f"batched capacity overflow: {max(col)} > planned "
                        f"{planned}")
            elif any(a != int(planned) for a in col):
                raise ReplayMismatch(f"batched exact decision drift: {col} "
                                     f"!= {planned}")
        # the graph's own time on the card, the run's wall on the CPU
        PROGRAMS.record_run(self.label, round(extra.get(
            "graph_ms", (t2 - t1) * 1000), 3), first=first)
        if stats is not None:
            stats.update(extra)
            stats.update(mode="batched", batch=len(rows),
                         device_ms=round((t2 - t1) * 1000, 3))
        return outs[:len(rows)]

    # -- the plain form (CPU) -------------------------------------------------
    def _stacked(self, full: list) -> list:
        """Each parameter's (cap,) values, each made as the single program
        makes its slot (torch.full of the value in the slot's dtype)."""
        return [torch.stack([torch.full((), r[j], dtype=phys_dtype(d))
                             for r in full])
                for j, d in enumerate(self.cq.param_dtypes)]

    def _replay_rows(self, scans: dict, slots) -> list:
        """The cap replays, row i over the views slot[i]; every row takes
        the constants the first replay uploaded."""
        u = self._uploads
        out = []
        for i in range(self.cap):
            if i or u.idx is not None:
                u.reuse()
            with uploads_active(u):
                out.append(self.cq._replay(
                    scans, tuple(s[i] for s in slots)))
            if u.idx is not None and u.idx != len(u.tensors):
                raise NotJittable(f"row {i} made {u.idx} of its "
                                  f"{len(u.tensors)} constant uploads")
        return out

    def _run_plain(self, scans: dict, full: list):
        slots = [s.to(self.cq.device) for s in self._stacked(full)]
        if self._uploads is None:
            self._uploads = Uploads()
        rows = self._replay_rows(scans, slots)
        return ([out for out, _ in rows],
                [checks.tolist() for _, checks in rows], {})

    # -- the CUDA graph -------------------------------------------------------
    def _capture(self, scans: dict, full: list) -> dict:
        """Row 0 replayed once under the sync debug mode (constants,
        scratch, one-time setup), then the cap rows captured in one
        graph."""
        _program_made()
        check_abandoned(self.cq.owner)
        with _CAPTURE_LOCK:
            return self._capture_locked(scans, full)

    def _capture_locked(self, scans: dict, full: list) -> dict:
        cq = self.cq
        stream = cq.owner.stream
        self._graph = self._obuf = self._rows_out = None
        t0 = time.perf_counter()
        host = self._stacked(full)
        self._playout, size = _byte_layout(host)
        self._pbuf = torch.zeros(size, dtype=torch.uint8, device=cq.device)
        self._slots = tuple(_section(self._pbuf, *lay)
                            for lay in self._playout)
        for slot, h in zip(self._slots, host):
            slot.copy_(h)
        self._uploads = Uploads()
        with uploads_active(self._uploads):
            _replay_without_syncs(
                self.label,
                lambda: cq._replay(scans, tuple(s[0] for s in self._slots)))
        self._uploads.reuse()
        stream.synchronize()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(cq.device)
        before = dict(_ck.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=cq.owner.graph_pool(),
                            capture_error_mode="thread_local")
        try:
            rows = self._replay_rows(scans, self._slots)
            flat = [t for out, checks in rows
                    for t in _flat_out(out) + [checks]]
            self._olayout, size = _byte_layout(flat)
            obuf = torch.empty(size, dtype=torch.uint8, device=cq.device)
            for lay, t in zip(self._olayout, flat):
                if t.numel():
                    _section(obuf, *lay).copy_(t)
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass                  # the capture is invalid already
            raise
        graph.capture_end()
        self._graph, self._obuf, self._rows_out = graph, obuf, rows
        self.captures += 1
        self.captured_launches = {k: _ck.LAUNCHES[k] - before[k]
                                  for k in _ck.LAUNCHES}
        self._ptrs = [t.data_ptr() for k in cq.scan_keys
                      for t in _flat(scans[k])]
        self._specs_at_capture = cq._specs(scans)
        return {"capture_s": round(time.perf_counter() - t0, 4),
                "pool_growth_bytes": torch.cuda.memory_reserved(cq.device)
                - reserved0,
                "captured_launches": dict(self.captured_launches)}

    def _run_graph(self, scans: dict, full: list):
        cq = self.cq
        stream = cq.owner.stream
        extra: dict = {}
        if self._graph is not None:
            specs = cq._specs(scans)
            if specs != self._specs_at_capture:
                raise ArgSpecMismatch(
                    f"batched program argument mismatch: {specs} != "
                    f"{self._specs_at_capture}")
        ptrs = [t.data_ptr() for k in cq.scan_keys for t in _flat(scans[k])]
        with torch.cuda.stream(stream):
            if self._graph is None or ptrs != self._ptrs:
                # a graph reads its scans where they were at capture
                extra = self._capture(scans, full)
            phost = torch.empty(self._pbuf.numel(), dtype=torch.uint8,
                                pin_memory=True)
            for lay, h in zip(self._playout, self._stacked(full)):
                _section(phost, *lay).copy_(h)
            self._pbuf.copy_(phost, non_blocking=True)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            self._graph.replay()
            e1.record()
            ohost = torch.empty(self._obuf.numel(), dtype=torch.uint8,
                                pin_memory=True)
            ohost.copy_(self._obuf, non_blocking=True)
            stream.synchronize()        # the run's one host sync
        views = [_section(ohost, *lay) for lay in self._olayout]
        outs, checks, i = [], [], 0
        for out, _ in self._rows_out:
            n = len(_flat_out(out))
            outs.append(_unflat_out(out, views[i:i + n]))
            checks.append(views[i + n].tolist())
            i += n + 1
        extra["graph_ms"] = e0.elapsed_time(e1)
        return outs, checks, extra
