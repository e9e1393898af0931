# Copied from nds_tpu/obs/trace.py, verbatim.
"""Span tracer: the query lifecycle as a tree of timed spans.

The engine's remaining orders of magnitude hide inside phases no single
number names: `roofline_frac` says the chip is 0.35% busy but not which
operator of which query burns the time. Interactive engines treat
per-operator runtime stats as the foundation of every optimization
decision ("Accelerating Presto with GPUs", PAPERS.md); Flare instruments
at the compiled-program boundary, not the interpreter loop ("Flare",
PAPERS.md). This tracer does both: parse -> plan (per rewrite pass, incl.
verification) -> compile -> lane-pack/upload -> per-morsel device exec ->
merge/finalize, each a span with parent/child structure and attributes
(rows, bytes, table, plan fingerprint).

Design constraints, in order:

1. **Near-zero cost disabled.** Every hook is `TRACER.span(...)`; when
   disabled that is one attribute read plus returning a shared no-op
   context manager — no allocation, no lock, no clock read. The engine is
   instrumented unconditionally and pays nothing in production
   (acceptance: <2% bench-slice overhead with tracing off).
2. **Thread-safe.** The staging thread, deadline workers, and parallel
   compile pools all open spans; the parent stack is thread-local and the
   event sink is lock-protected.
3. **Standard export formats.** Chrome trace-event JSON (opens directly
   in Perfetto / chrome://tracing), JSONL event logs for ad-hoc grep, and
   an aggregated per-name table embedded in bench reports.

Enable per-process with ``configure(enabled=True)`` (runners expose
``--trace``) or by exporting ``NDS_TPU_TRACE=1``.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Optional


class _NullSpan:
    """Shared do-nothing span returned while tracing is disabled."""
    __slots__ = ()
    sid = 0     # detached-span protocol: a disabled span has no identity

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self

    def begin(self) -> "_NullSpan":
        return self

    def end(self, error: Optional[str] = None) -> None:
        return None


NULL_SPAN = _NullSpan()


class Span:
    """One live span; becomes an event dict when closed.

    Event layout is the Chrome trace-event "complete" form (ph="X", ts/dur
    in microseconds) extended with ``sid``/``parent`` so the span tree is
    reconstructible from the flat event list (Perfetto ignores the extra
    keys).

    Two lifetimes: the context-manager form nests via the thread-local
    parent stack (same-thread children), and the DETACHED form
    (``begin()``/``end()``) lives across thread hops — a service ticket's
    root span opens on the client thread at admission and closes on the
    device lane at completion, with every stage span parent-linked to it
    through the explicit ``parent=`` override."""
    __slots__ = ("name", "cat", "attrs", "sid", "parent", "tid", "_t0",
                 "_tracer", "_parent_override", "_detached")

    def __init__(self, tracer: "Tracer", name: str, cat: str, attrs: dict,
                 parent: Optional[int] = None):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self.sid = 0
        self.parent = 0
        self.tid = 0
        self._t0 = 0.0
        self._parent_override = parent
        self._detached = False

    def set(self, **attrs) -> "Span":
        """Attach attributes discovered mid-span (rows, bytes, mode...)."""
        self.attrs.update(attrs)
        return self

    def _open(self) -> None:
        tr = self._tracer
        self.sid = next(tr._ids)
        self.tid = threading.get_ident()
        with tr._lock:
            tr._open[self.sid] = self
        self._t0 = time.perf_counter()

    def __enter__(self) -> "Span":
        tr = self._tracer
        stack = tr._stack()
        self.parent = self._parent_override if self._parent_override \
            is not None else (stack[-1] if stack else 0)
        self._open()
        stack.append(self.sid)
        return self

    def begin(self) -> "Span":
        """Open DETACHED: not pushed on any thread's parent stack, so it
        may be closed (``end()``) from a different thread. Parent comes
        only from the explicit ``parent=`` override (0 = root)."""
        self._detached = True
        self.parent = self._parent_override or 0
        self._open()
        return self

    def end(self, error: Optional[str] = None) -> None:
        """Close a detached span (thread-agnostic counterpart of
        ``__exit__``)."""
        self._close(error)

    def _close(self, error: Optional[str]) -> None:
        t1 = time.perf_counter()
        tr = self._tracer
        if error is not None:
            self.attrs["error"] = error
        event = {
            "name": self.name, "cat": self.cat, "ph": "X",
            "ts": round((self._t0 - tr._epoch) * 1e6, 1),
            "dur": round((t1 - self._t0) * 1e6, 1),
            "pid": os.getpid(), "tid": self.tid,
            "sid": self.sid, "parent": self.parent,
        }
        if self.attrs:
            event["args"] = self.attrs
        with tr._lock:
            tr._open.pop(self.sid, None)
            tr._events.append(event)

    def __exit__(self, exc_type, exc, tb) -> bool:
        stack = self._tracer._stack()
        if stack and stack[-1] == self.sid:
            stack.pop()
        self._close(exc_type.__name__ if exc_type is not None else None)
        return False


class Tracer:
    """Process-wide span collector (one instance: ``TRACER``)."""

    def __init__(self) -> None:
        self.enabled = False
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._open: dict[int, Span] = {}
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self._epoch = time.perf_counter()

    # -- recording -----------------------------------------------------------
    def span(self, name: str, cat: str = "engine",
             parent: Optional[int] = None, **attrs):
        """Open a span; use as a context manager. The ONLY hook call sites
        need — a plain no-op while disabled.

        ``parent``: explicit parent span id, overriding the thread-local
        stack — how the query service parent-links a ticket's stage spans
        (planner thread, device lane, client materialization) back to the
        ``service/ticket`` root opened on the submitting thread. Use
        ``.begin()``/``.end()`` instead of ``with`` for a span that opens
        and closes on different threads."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, cat, attrs, parent=parent)

    def instant(self, name: str, cat: str = "engine", **attrs) -> None:
        """Record a zero-duration marker event (ph="i")."""
        if not self.enabled:
            return
        event = {"name": name, "cat": cat, "ph": "i", "s": "t",
                 "ts": round((time.perf_counter() - self._epoch) * 1e6, 1),
                 "pid": os.getpid(), "tid": threading.get_ident()}
        if attrs:
            event["args"] = attrs
        with self._lock:
            self._events.append(event)

    def _stack(self) -> list[int]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    # -- control -------------------------------------------------------------
    def configure(self, enabled: bool = True, clear: bool = True) -> None:
        if clear:
            self.clear()
        self.enabled = enabled

    def clear(self) -> None:
        with self._lock:
            self._events = []
            self._open = {}
        self._epoch = time.perf_counter()

    # -- inspection ----------------------------------------------------------
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def open_spans(self) -> list[str]:
        """Names of spans entered but not yet exited (well-formedness:
        empty at every quiescent point)."""
        with self._lock:
            return [s.name for s in self._open.values()]

    def aggregate(self) -> dict[str, dict]:
        """Per-span-name rollup: {name: {count, total_ms, max_ms}} — the
        compact per-query table bench reports embed."""
        out: dict[str, dict] = {}
        for e in self.events():
            if e.get("ph") != "X":
                continue
            row = out.setdefault(e["name"],
                                 {"count": 0, "total_ms": 0.0, "max_ms": 0.0})
            ms = e["dur"] / 1000.0
            row["count"] += 1
            row["total_ms"] = round(row["total_ms"] + ms, 3)
            row["max_ms"] = round(max(row["max_ms"], ms), 3)
        return out

    # -- export --------------------------------------------------------------
    def write_chrome_trace(self, path: str) -> str:
        """Chrome trace-event JSON: open the file in Perfetto
        (ui.perfetto.dev) or chrome://tracing."""
        payload = {"traceEvents": self.events(), "displayTimeUnit": "ms"}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f)
        return path

    def write_jsonl(self, path: str) -> str:
        """One event per line — greppable / streamable log form."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for e in self.events():
                f.write(json.dumps(e) + "\n")
        return path


#: the process-global tracer every engine hook reports into.
TRACER = Tracer()

if os.environ.get("NDS_TPU_TRACE", "").lower() in ("1", "true", "yes", "on"):
    TRACER.configure(enabled=True)


def span(name: str, cat: str = "engine", **attrs):
    """Module-level convenience: ``with obs.trace.span("parse"): ...``"""
    return TRACER.span(name, cat, **attrs)


def validate_chrome_trace(path: str) -> int:
    """Structural check of an exported Chrome trace file; returns the event
    count, raising ValueError on malformed content (test + CLI helper)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        raise ValueError("traceEvents is not a list")
    for e in events:
        for k in ("name", "ph", "ts", "pid", "tid"):
            if k not in e:
                raise ValueError(f"event missing {k!r}: {e}")
        if e["ph"] == "X" and "dur" not in e:
            raise ValueError(f"complete event missing dur: {e}")
    return len(events)


def span_tree(events: list[dict]) -> dict[int, list[int]]:
    """parent sid -> [child sids] from an event list (0 = roots). Raises
    ValueError when a non-root parent id never appears as a span — the
    well-formedness test's backbone."""
    sids = {e["sid"] for e in events if e.get("ph") == "X"}
    tree: dict[int, list[int]] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        parent = e.get("parent", 0)
        if parent and parent not in sids:
            raise ValueError(f"span {e['sid']} ({e['name']}) has unknown "
                             f"parent {parent}")
        tree.setdefault(parent, []).append(e["sid"])
    return tree
