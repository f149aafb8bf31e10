"""Shared utilities: hashing, shape helpers, timing, device resolution.

Hashing and the shape helpers are numpy / pure Python and bit-identical to
``repro.common.utils``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

# splitmix64 is the cheap 64-bit mixer behind the level-1 hash sharding
# (paper §4.1): deterministic across hosts and well mixed, so shards balance.
_SM64_C1 = np.uint64(0xBF58476D1CE4E5B9)
_SM64_C2 = np.uint64(0x94D049BB133111EB)
_SM64_GAMMA = np.uint64(0x9E3779B97F4A7C15)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer over uint64 arrays."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = x + _SM64_GAMMA
        z = (z ^ (z >> np.uint64(30))) * _SM64_C1
        z = (z ^ (z >> np.uint64(27))) * _SM64_C2
        z = z ^ (z >> np.uint64(31))
    return z


def stable_hash_u64(keys: np.ndarray, salt: int = 0) -> np.ndarray:
    """Deterministic 64-bit hash of integer keys (any integer dtype)."""
    k = np.asarray(keys).astype(np.uint64, copy=False)
    return splitmix64(k ^ np.uint64(salt))


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (and >= 1)."""
    return 1 << max(n - 1, 1).bit_length() if n & (n - 1) else max(n, 1)


def next_pow2_quarter(n: int) -> int:
    """Smallest v >= n on the quarter-pow2 grid {4,5,6,7} * 2^e (plus the
    exact small values 1..4)."""
    n = max(int(n), 1)
    if n <= 4:
        return n
    step = 1 << ((n - 1).bit_length() - 3)
    return -(-n // step) * step


def pad_to(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    """Pad axis 0 of ``a`` up to length ``n`` with ``fill``."""
    if a.shape[0] == n:
        return a
    if a.shape[0] > n:
        raise ValueError(f"cannot pad {a.shape[0]} down to {n}")
    pad_width = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad_width, constant_values=fill)


def pad_axis_to(a: np.ndarray, axis: int, n: int, fill=0) -> np.ndarray:
    """Pad ``axis`` of ``a`` up to length ``n`` with ``fill``."""
    if a.shape[axis] == n:
        return a
    pad_width = [(0, 0)] * a.ndim
    pad_width[axis] = (0, n - a.shape[axis])
    return np.pad(a, pad_width, constant_values=fill)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    A CUDA device comes back with an explicit index (the calling thread's
    current device when the caller names none), because the current device
    is per thread: a serving thread other than the one that built the index
    must find the same card.  Raises when CUDA is asked for (explicitly or
    by default) and missing — the port never falls back to the CPU on its
    own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device={device!r} — expected a cuda or cpu device")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Timer:
    """Context-manager wall timer. ``with Timer() as t: ...; t.seconds``."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        return False
