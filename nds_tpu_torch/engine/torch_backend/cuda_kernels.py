"""Hand-written CUDA kernels for the relational hot loops, with their plain
PyTorch versions, their build, and their launch counters.

Counterpart of ``nds_tpu/engine/jax_backend/pallas_kernels.py``; each kernel
computes what its TPU kernel computes (sources and design notes in
``nds_tpu_torch/csrc/``):

- ``sort_pairs``        (csrc/sort_pairs.cu) least-significant-digit radix
                        sort of (key, idx) pairs by the total order
                        (key, idx), over the digits of the keys' range
                        only, one kernel per pass;
- ``seg_reduce_multi``  (csrc/seg_reduce.cu) fused per-segment integer SUM
                        and any-dtype MIN/MAX of several operands over one
                        gid vector, runs folded in registers;
- ``take_many``         (csrc/take_many.cu) batched multi-column gather with
                        JAX's clamp/wrap index semantics.

A wrapper takes its plain version only for tensors that lie on the CPU (the
tests); for a CUDA tensor it launches its kernel or raises. The kernels are
built with ``nvcc`` for ``sm_90a`` into ``nds_tpu_torch/_build/`` at first
use, each into a shared library with a plain C interface loaded through
``ctypes``. ``LAUNCHES`` counts the calls into each library's launch entry
(one ``sort_pairs_launch`` runs all the passes of one sort). No wrapper
waits on the device.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

#: the kernel families a config may enable (EngineConfig.gpu_kernels)
VALID_OPS = frozenset({"sort", "groupby", "gather"})

# Row gates, identical to the TPU kernels' so both engines dispatch alike.
SORT_MIN_ROWS = 1 << 13
GATHER_MIN_ROWS = 1 << 12
GROUPBY_MIN_ROWS = 1 << 12
#: seg_reduce_multi eligibility cap on the segment count
GROUPBY_MAX_SEGMENTS = 1 << 11

#: kernel name -> number of calls into its library's launch entry
LAUNCHES = {"sort_pairs": 0, "seg_reduce_multi": 0, "take_many": 0}

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
_BUILD = os.path.join(os.path.dirname(_CSRC), "_build")
#: kernel name -> CUDA source file in csrc/
SOURCES = {"sort_pairs": "sort_pairs.cu", "seg_reduce_multi": "seg_reduce.cu",
           "take_many": "take_many.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict = {}
_LIB_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# per-executor op activation (the counterpart of pallas_kernels.set_active)
# ---------------------------------------------------------------------------

_tls = threading.local()


def parse_ops(spec) -> frozenset:
    """Validated op set from a tuple or a comma string; unknown names raise."""
    if spec is None:
        return frozenset()
    if isinstance(spec, str):
        spec = spec.split(",")
    ops = frozenset(s.strip() for s in spec if s and s.strip())
    bad = ops - VALID_OPS
    if bad:
        raise ValueError(f"unknown gpu_kernels {sorted(bad)} "
                         f"(valid: {sorted(VALID_OPS)})")
    return ops


def set_active(ops: frozenset) -> None:
    """Install the executing plan's kernel set (thread-local)."""
    _tls.ops = ops


def op_active(op: str) -> bool:
    return op in getattr(_tls, "ops", frozenset())


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> str:
    src = os.path.join(_CSRC, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD, f"{name}-{digest.hexdigest()[:12]}.so")


def _bind(name: str, lib) -> None:
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    symbols = {
        "sort_pairs": [
            ("sort_pairs_launch",
             [vp, vp, vp, vp, vp, vp, i64, i32, i32, vp, vp, vp], i32),
            ("sort_pairs_scratch_bytes", [i64], i64)],
        "seg_reduce_multi": [
            ("seg_reduce_launch",
             [vp, i64, i32, i32, vp, vp, vp, vp, vp, vp], i32)],
        "take_many": [
            ("take_many_launch", [vp, i64, i32, vp, vp, vp, vp, vp], i32)],
    }[name]
    for symbol, argtypes, restype in symbols:
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = restype


def build(names=None) -> dict:
    """Compile (if not yet built) and load the kernels' libraries: one
    ``nvcc`` process per source, all started together. Returns
    {name: build seconds} (0.0 for a library already built and loaded)."""
    names = list(names or SOURCES)
    with _LIB_LOCK:
        todo = [n for n in names if n not in _LIBS]
        os.makedirs(_BUILD, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for n in todo:
            out = _lib_path(n)
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp,
                                            os.path.join(_CSRC, SOURCES[n])]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT), tmp, out)
        secs = {n: 0.0 for n in names}
        for n, (p, tmp, out) in procs.items():
            log = p.communicate()[0].decode(errors="replace")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed for {SOURCES[n]}:\n{log}")
            os.replace(tmp, out)
            secs[n] = time.perf_counter() - t0
        for n in todo:
            lib = ctypes.CDLL(_lib_path(n))
            _bind(n, lib)
            _LIBS[n] = lib
        return secs


def _lib(name: str):
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name]
    return lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _on_cuda(*tensors) -> bool:
    """True when every tensor lies on one CUDA device, False when every one
    lies on the CPU; a mix raises."""
    kinds = {t.device.type for t in tensors}
    _require(len(kinds) == 1 and kinds <= {"cpu", "cuda"},
             f"tensors on mixed or unsupported devices {sorted(kinds)}")
    if "cuda" in kinds:
        _require(len({t.device for t in tensors}) == 1,
                 "tensors on different CUDA devices")
        return True
    return False


# ---------------------------------------------------------------------------
# (a) sort_pairs
# ---------------------------------------------------------------------------

def sort_pairs_plain(key: torch.Tensor, idx: torch.Tensor):
    """(key, idx) pairs sorted ascending by (key, idx): sort by idx, then
    stable-sort by key."""
    o1 = torch.argsort(idx, stable=True)
    k1, i1 = key[o1], idx[o1]
    o2 = torch.argsort(k1, stable=True)
    return k1[o2], i1[o2].to(torch.int32)


def sort_pairs(key: torch.Tensor, idx: torch.Tensor,
               idx_ascending: bool = False):
    """Sort (key, idx) pairs ascending by the total order (key, idx): the
    stable sort by key when `idx` holds distinct values (the engine passes
    an iota or a permutation). Keys are int32 or int64; idx is returned as
    int32. The inputs are not modified. ``idx_ascending=True`` is the
    caller's promise that idx is already ascending (an iota), which skips
    the idx digit passes; a false promise gives a wrong order."""
    if int(key.shape[0]) <= 1:
        return key, idx
    if not _on_cuda(key, idx):
        return sort_pairs_plain(key, idx)
    return _sort_pairs_cuda(key, idx, idx_ascending)[:2]


def sort_pairs_with_passes(key: torch.Tensor, idx: torch.Tensor,
                           idx_ascending: bool = False):
    """``sort_pairs`` of CUDA tensors of two or more pairs, and the key
    digit passes it made (0 to 8): a diagnostic that waits on the device,
    never called on the query path."""
    _require(int(key.shape[0]) > 1 and _on_cuda(key, idx),
             "sort_pairs_with_passes takes CUDA tensors of two or more pairs")
    k, i, info = _sort_pairs_cuda(key, idx, idx_ascending)
    return k, i, int(info[2])


def _sort_pairs_cuda(key, idx, idx_ascending):
    """Launches the sort; returns the sorted key and idx and the sort's
    device info words (min key, the sentinels' remapped key, key passes,
    spare)."""
    n = int(key.shape[0])
    _require(key.dtype in (torch.int32, torch.int64),
             f"sort_pairs keys must be int32 or int64, not {key.dtype}")
    _require(key.dim() == 1 and idx.shape == key.shape,
             "sort_pairs takes two 1-D tensors of one length")
    _require(n < 1 << 31, "sort_pairs takes fewer than 2^31 pairs")
    lib = _lib("sort_pairs")
    dev = key.device
    k = key.contiguous()
    i = idx.to(torch.int32).contiguous()
    scratch = torch.empty(lib.sort_pairs_scratch_bytes(n), dtype=torch.uint8,
                          device=dev)
    info = torch.empty(4, dtype=torch.int64, device=dev)
    k_out, i_out = torch.empty_like(k), torch.empty_like(i)
    k_tmp, i_tmp = torch.empty_like(k), torch.empty_like(i)
    _check(lib.sort_pairs_launch(
        k.data_ptr(), i.data_ptr(), k_out.data_ptr(), i_out.data_ptr(),
        k_tmp.data_ptr(), i_tmp.data_ptr(), n, k.element_size(),
        0 if idx_ascending else 1, scratch.data_ptr(), info.data_ptr(),
        _stream()), "sort_pairs")
    LAUNCHES["sort_pairs"] += 1
    return k_out, i_out, info


# ---------------------------------------------------------------------------
# (b) seg_reduce_multi
# ---------------------------------------------------------------------------

_SEG_DTYPES = {torch.int8: 0, torch.int16: 1, torch.int32: 2, torch.int64: 3,
               torch.uint8: 4, torch.float32: 5, torch.float64: 6}
_SEG_OPS = {"sum": 0, "min": 1, "max": 2}
_INT64_MIN = -(1 << 63)
_FLIP = (1 << 63) - 1
#: shared-memory bytes one launch may use for its per-segment partials
_SEG_SMEM = 200 * 1024


def seg_supported(data: torch.Tensor, num_segments: int, op: str) -> bool:
    """Eligibility of one operand: bounded segment count and order-
    independent math only (integer sums, any-dtype min/max; no float sums,
    no bool)."""
    if not 1 <= num_segments <= GROUPBY_MAX_SEGMENTS:
        return False
    if data.dim() != 1 or data.dtype not in _SEG_DTYPES:
        return False
    if op == "sum":
        return not data.dtype.is_floating_point
    return op in ("min", "max")


def _float_key(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving int64 key of a float tensor (widened exactly to
    float64): -0.0 sorts below +0.0."""
    b = x.to(torch.float64).view(torch.int64)
    return torch.where(b >= 0, b, b ^ _FLIP)


def _key_float(k: torch.Tensor, dtype) -> torch.Tensor:
    b = torch.where(k >= 0, k, k ^ _FLIP)
    return b.view(torch.float64).to(dtype)


def _identity(dtype, op: str):
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def seg_reduce_plain(data: torch.Tensor, gid: torch.Tensor,
                     num_segments: int, op: str) -> torch.Tensor:
    """One segment reduction with the TPU engine's semantics (its
    ``jax.ops.segment_*``): gid outside [0, num_segments) contributes
    nothing; empty segments hold 0 (sum), the dtype's extreme, or +-inf;
    integer sums wrap in the operand's dtype; float min/max order -0.0
    below +0.0 and propagate NaN. Float sums accumulate in index order.
    Rows outside the segments (and, for float min/max, NaN rows on one
    side) land on a spare slot S that is cut off, so the reduction never
    waits on the device and a CUDA graph can capture it."""
    S = num_segments
    keep = (gid >= 0) & (gid < S)
    g = torch.where(keep, gid.long(), S)
    dev, dt = data.device, data.dtype
    if op == "sum":
        if dt.is_floating_point:
            return torch.zeros(S + 1, dtype=dt, device=dev) \
                .index_add_(0, g, data)[:S]
        acc = torch.zeros(S + 1, dtype=torch.int64, device=dev)
        return acc.index_add_(0, g, data.to(torch.int64))[:S].to(dt)
    red = "amin" if op == "min" else "amax"
    if not dt.is_floating_point:
        src = data.to(torch.int64) if dt == torch.bool else data
        out = torch.full((S + 1,), _identity(dt, op), dtype=src.dtype,
                         device=dev)
        return out.scatter_reduce_(0, g, src, red)[:S].to(dt)
    nan = torch.isnan(data)
    key = _float_key(torch.full((S + 1,), _identity(dt, op),
                                dtype=torch.float64, device=dev))
    key.scatter_reduce_(0, torch.where(nan, S, g), _float_key(data), red)
    out = _key_float(key[:S], dt)
    # the largest NaN bit pattern (as unsigned) of each segment wins
    if dt == torch.float64:
        bits = data.view(torch.int64)
    else:
        bits = data.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    nb = torch.full((S + 1,), _INT64_MIN, dtype=torch.int64, device=dev)
    nb.scatter_reduce_(0, torch.where(nan, g, S), bits ^ _INT64_MIN, "amax")
    raw = nb[:S] ^ _INT64_MIN
    has = raw != 0
    if dt == torch.float64:
        nan_vals = raw.view(torch.float64)
    else:
        nan_vals = (raw & 0xFFFFFFFF).to(torch.int32).view(torch.float32)
    return torch.where(has, nan_vals, out)


def seg_reduce_multi_plain(operands: list, gid: torch.Tensor,
                           num_segments: int) -> list:
    return [seg_reduce_plain(d, gid, num_segments, op) for d, op in operands]


#: {(device, stream): int64 device words}: the kernel finds the words it
#: uses zero and leaves them zero (its last block clears them), so they are
#: kept per stream, where calls run in order, and no call clears them
_SEG_SCRATCH: dict = {}
#: the words a grown buffer replaced: a CUDA graph captured over them
#: replays on them later, so they stay allocated (freed, another tensor
#: would take them and the graph would read and write its data). Growth
#: doubles, so they hold at most as many words as the buffers in use
_SEG_SCRATCH_RETIRED: list = []


def _seg_scratch(dev: torch.device, words: int) -> torch.Tensor:
    key = (dev, torch.cuda.current_stream().cuda_stream)  # as _stream()
    buf = _SEG_SCRATCH.get(key)
    if buf is None or buf.numel() < words:
        # under a CUDA graph capture the words would come from the graph's
        # pool and hold another graph's data later: a compiled replay's
        # first (uncaptured) pass on the capture stream sizes them
        _require(not torch.cuda.is_current_stream_capturing(),
                 "seg_reduce_multi scratch must be sized before a capture")
        if buf is not None:
            _SEG_SCRATCH_RETIRED.append(buf)
            words = max(words, 2 * buf.numel())
        buf = _SEG_SCRATCH[key] = torch.zeros(words, dtype=torch.int64,
                                              device=dev)
    return buf


def seg_reduce_multi(operands: list, gid: torch.Tensor,
                     num_segments: int) -> list:
    """Fused segment reductions: ``operands`` is [(data, op)], each
    ``seg_supported``; one kernel pass serves them all (operands split
    across launches only when their partials outgrow shared memory)."""
    tensors = [gid] + [d for d, _ in operands]
    if not _on_cuda(*tensors):
        return seg_reduce_multi_plain(operands, gid, num_segments)
    S = int(num_segments)
    n = int(gid.shape[0])
    _require(gid.dtype == torch.int32 and gid.dim() == 1,
             "seg_reduce_multi gid must be a 1-D int32 tensor")
    for d, op in operands:
        _require(seg_supported(d, S, op) and d.shape[0] == n,
                 f"seg_reduce_multi: unsupported operand {d.dtype} {op} "
                 f"over {S} segments")
    lib = _lib("seg_reduce_multi")
    dev = gid.device
    gid = gid.contiguous()
    datas = [d.contiguous() for d, _ in operands]
    outs = [torch.empty(S, dtype=d.dtype, device=dev) for d in datas]
    per_launch = max(1, min(16, _SEG_SMEM // (16 * S)))
    for lo in range(0, len(datas), per_launch):
        part = range(lo, min(len(datas), lo + per_launch))
        k = len(part)
        scratch = _seg_scratch(dev, 2 * k * S + 1)
        dtypes = (ctypes.c_int * k)(*[_SEG_DTYPES[datas[j].dtype]
                                      for j in part])
        ops = (ctypes.c_int * k)(*[_SEG_OPS[operands[j][1]] for j in part])
        _check(lib.seg_reduce_launch(
            gid.data_ptr(), n, S, k, _ptrs([datas[j] for j in part]),
            _ptrs([outs[j] for j in part]), dtypes, ops, scratch.data_ptr(),
            _stream()), "seg_reduce_multi")
        LAUNCHES["seg_reduce_multi"] += 1
    return outs


# ---------------------------------------------------------------------------
# (c) take_many
# ---------------------------------------------------------------------------

_GATHER_BATCH = 16


def take_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]`` with JAX's gather semantics: a negative index counts
    from the end, then the index clamps into [0, len - 1]."""
    n = int(src.shape[0])
    i = idx.long()
    i = torch.where(i < 0, i + n, i).clamp_(0, max(n - 1, 0))
    return src[i]


def take_many(srcs: list, idx: torch.Tensor) -> list:
    """Gather ``[src[idx] for src in srcs]`` (JAX index semantics) in one
    kernel launch per batch of up to 16 columns; bool columns ride as
    uint8."""
    if not _on_cuda(idx, *srcs):
        return [take_plain(s, idx) for s in srcs]
    _require(idx.dtype == torch.int32 and idx.dim() == 1,
             "take_many idx must be a 1-D int32 tensor")
    for s in srcs:
        _require(s.dim() == 1 and s.shape[0] >= 1 and
                 s.element_size() in (1, 2, 4, 8),
                 f"take_many: unsupported source {s.dtype} {tuple(s.shape)}")
    if not srcs:
        return []
    lib = _lib("take_many")
    n = int(idx.shape[0])
    idx = idx.contiguous()
    srcs = [s.contiguous() for s in srcs]
    outs = [torch.empty(n, dtype=s.dtype, device=s.device) for s in srcs]
    for lo in range(0, len(srcs), _GATHER_BATCH):
        b_src = srcs[lo:lo + _GATHER_BATCH]
        b_out = outs[lo:lo + _GATHER_BATCH]
        k = len(b_src)
        lens = (ctypes.c_int64 * k)(*[int(s.shape[0]) for s in b_src])
        widths = (ctypes.c_int * k)(*[s.element_size() for s in b_src])
        _check(lib.take_many_launch(idx.data_ptr(), n, k, _ptrs(b_src),
                                    _ptrs(b_out), lens, widths, _stream()),
               "take_many")
        LAUNCHES["take_many"] += 1
    return outs
