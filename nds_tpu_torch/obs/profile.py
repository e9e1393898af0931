# Copied from nds_tpu/obs/profile.py, lines 46-134 (DeviceMemTracker and
# DEVICE_MEM) verbatim; the rest of that module (PlanProfile, EXPLAIN
# ANALYZE) is not ported yet.
"""Device-memory watermark accounting.

The port writes through it where its executor accounts device-resident
scans and segment outputs against the scan budget
(``TorchExecutor._account_resident``): the live set the budget's eviction
operates on. Graph pools and intermediates are the caching allocator's
and are not tracked here.
"""
from __future__ import annotations

import threading


class DeviceMemTracker:
    """Accounting of TRACKED device allocations, not a full HBM profiler.

    Tracked: every upload through ``device.to_device`` / ``pack_table`` /
    ``shard_exec.stage_sharded`` and the device codebook cache; frees
    through ``device.free_dtable`` (and codebook-cache resets) subtract.
    NOT tracked: compiled-program intermediates and outputs — XLA owns
    those, and the engine's memory lever is the upload/scan live set this
    tracker watches (the scan-budget eviction operates on exactly it).

    Buffers are tracked by leaf-array identity, so a double add or a free
    of an untracked tree (segment outputs, device-computed tables) never
    corrupts the balance; buffers dropped to the GC without an explicit
    ``free_dtable`` stay counted until process end (documented drift —
    the engine frees every hot-loop buffer explicitly).

    ``mark_window()``/``window_peak()`` give per-query peaks: the session
    marks at statement start (under its statement lock, so windows never
    interleave) and reads the window's high-water mark into
    ``ExecStats.mem_peak_bytes`` at finish.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._leaves: dict[int, int] = {}   # id(device array) -> bytes
        self.live = 0
        self.peak = 0
        self._win_peak = 0

    def _gauges(self, live: int, peak: int) -> None:
        from . import metrics as _m
        _m.DEVICE_LIVE_BYTES.set(live)
        _m.DEVICE_PEAK_BYTES.set(peak)

    def add(self, leaves) -> None:
        """Track [(id, nbytes)] device-array leaves (untracked ids only)."""
        with self._lock:
            for i, b in leaves:
                if i not in self._leaves:
                    self._leaves[i] = b
                    self.live += b
            if self.live > self.peak:
                self.peak = self.live
            if self.live > self._win_peak:
                self._win_peak = self.live
            live, peak = self.live, self.peak
        self._gauges(live, peak)

    def free(self, leaves) -> None:
        """Untrack [(id, nbytes)] leaves; ids never tracked are ignored."""
        with self._lock:
            for i, _b in leaves:
                b = self._leaves.pop(i, None)
                if b is not None:
                    self.live -= b
            live, peak = self.live, self.peak
        self._gauges(live, peak)

    def mark_window(self) -> None:
        """Open a per-query peak window (statement start)."""
        with self._lock:
            self._win_peak = self.live

    def window_peak(self) -> int:
        """High-water mark of the live set since ``mark_window``."""
        with self._lock:
            return self._win_peak

    def restore_window(self, saved_peak: int) -> None:
        """Re-open a suspended statement's peak window (the service's
        morsel-boundary preemption nests a statement inside another):
        the resumed window's peak is the max of what the outer statement
        had already seen and everything since — the outer statement's
        mem_peak_bytes keeps covering its whole wall."""
        with self._lock:
            self._win_peak = max(saved_peak, self._win_peak)

    def reset(self) -> None:
        """Zero all accounting (tests only)."""
        with self._lock:
            self._leaves.clear()
            self.live = 0
            self.peak = 0
            self._win_peak = 0
        self._gauges(0, 0)


#: the process-global device-memory accountant (device.py writes through)
DEVICE_MEM = DeviceMemTracker()
