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


#: errors that mark a unit "nojit": it runs eager from then on
NOJIT_ERRORS = (NotJittable, NotImplementedError)


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


def strike_shared_program(fp: Optional[str]) -> bool:
    """Record one strike against a shared program; at QUARANTINE_STRIKES
    the entry is evicted. Returns True when this strike evicted it."""
    if fp is None:
        return False
    with _SHARED_LOCK:
        n = _PROGRAM_STRIKES.get(fp, 0) + 1
        _PROGRAM_STRIKES[fp] = n
        if n < QUARANTINE_STRIKES:
            return False
        _PROGRAM_STRIKES.pop(fp, None)
        return _SHARED_PROGRAMS.pop(fp, None) is not None


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
        t1 = time.perf_counter()
        if self.device.type == "cuda":
            out, checks_host, extra = self._run_graph(scans, values,
                                                      keep_device)
        else:
            out, checks_host, extra = self._run_plain(scans, values)
        t2 = time.perf_counter()
        self._first = False
        verify_schedule(self.decisions, checks_host)
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
        stream = self.owner.stream
        self._graph = self._out = self._checks = None
        t0 = time.perf_counter()
        self._slots = tuple(torch.full((), v, dtype=phys_dtype(d),
                                       device=self.device)
                            for v, d in zip(values, self.param_dtypes))
        self._uploads = Uploads()
        prev = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with uploads_active(self._uploads):
                    self._replay(scans, self._slots)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        syncs = sorted({f"{os.path.basename(w.filename)}:{w.lineno}"
                        for w in caught if "called a synchronizing"
                        in str(w.message)})
        if syncs:
            # a capture would fail on them: name every one at once
            raise RuntimeError(f"{self.label}: the replay waits on the "
                               f"device at {syncs}")
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
