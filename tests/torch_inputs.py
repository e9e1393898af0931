"""Inputs of the port's kernel tests, made with numpy from a seed, shared by
the CPU tests (tests/test_torch_kernels.py), the card's tests
(tests/test_torch_cuda.py) and chip_smoke.py's edge cases. Imports neither
jax nor torch."""
import numpy as np


def sort_keys(kind: str, n: int, dtype, rng) -> np.ndarray:
    """Sort keys of one kind: heavy ties under a block of TYPE_MAX
    sentinels, all equal, only sentinels, 0/1, differing in the high byte
    only, or spread over the whole type (TYPE_MIN .. TYPE_MAX - 1 and
    sentinels)."""
    info = np.iinfo(dtype)
    bits = 8 * np.dtype(dtype).itemsize
    if kind == "ties":
        key = rng.integers(-9, 9, n).astype(dtype)
        key[: n // 3] = info.max
    elif kind == "equal":
        key = np.full(n, 42, dtype)
    elif kind == "sentinels":
        key = np.full(n, info.max, dtype)
    elif kind == "01":
        key = rng.integers(0, 2, n).astype(dtype)
    elif kind == "highbyte":
        unsigned = np.uint64 if bits == 64 else np.uint32
        high = rng.integers(0, 256, n).astype(unsigned)
        key = (high << unsigned(bits - 8)).view(dtype)
    else:
        assert kind == "fullrange", kind
        key = rng.integers(info.min, info.max, n, dtype=np.int64).astype(dtype)
        key[:2] = info.min, info.max - 1
        key[2::5] = info.max
    return key


def seg_gids(kind: str, S: int, n: int, rng) -> np.ndarray:
    """int32 gids of one kind: random with out-of-range rows, every live
    row in segment 0 (a global aggregate; a third of the rows dead at the
    engine's sentinel n), alternating 0/1, sorted, or every row dead."""
    if kind == "random":
        gid = rng.integers(-3, S + 3, n)
    elif kind == "segment0":
        gid = np.where(rng.random(n) < 1 / 3, n, 0)
    elif kind == "alternating":
        gid = np.arange(n) % 2
    elif kind == "sorted":
        gid = np.sort(rng.integers(0, S, n))
    else:
        assert kind == "dead", kind
        gid = np.full(n, n)
    return gid.astype(np.int32)
