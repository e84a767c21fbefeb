"""Buffer objects: sliding window, circular buffer, fixed delay line,
host numpy as in the JAX package (`liquid_dsp_tpu/utils/buffer.py`).

Reference analog (studied, not copied): reference src/buffer/src/
window.c:33 (sliding window, power-of-two wrap), cbuffer.c:37 (circular
buffer), wdelay.c:33 (fixed delay).

In the block/carry architecture these are mostly subsumed by explicit
carries, but the host-side utility objects are provided for parity and
for porting code written against the reference API.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Window", "CBuffer", "WDelay"]


class Window:
    """Sliding window of the last n values (reference window.c)."""

    def __init__(self, n: int, dtype=np.complex64):
        if n == 0:
            raise ValueError("window length must be positive")
        self.n = n
        self.v = np.zeros(n, dtype)

    def push(self, x):
        self.v = np.roll(self.v, -1)
        self.v[-1] = x

    def write(self, xs):
        xs = np.asarray(xs)
        if len(xs) >= self.n:
            self.v = xs[-self.n:].astype(self.v.dtype).copy()
        else:
            self.v = np.concatenate([self.v[len(xs):], xs]).astype(
                self.v.dtype)

    def read(self) -> np.ndarray:
        """Oldest-first contents."""
        return self.v.copy()

    def index(self, i: int):
        """i-th element, 0 = oldest (reference window_index)."""
        if not (0 <= i < self.n):
            raise IndexError("window index out of range")
        return self.v[i]

    def reset(self):
        self.v[:] = 0


class CBuffer:
    """Circular buffer with explicit produce/consume (reference
    cbuffer.c)."""

    def __init__(self, max_size: int, dtype=np.complex64):
        if max_size == 0:
            raise ValueError("cbuffer size must be positive")
        self.max_size = max_size
        self.data: list = []
        self.dtype = dtype

    def size(self) -> int:
        return len(self.data)

    def space_available(self) -> int:
        return self.max_size - len(self.data)

    def is_full(self) -> bool:
        return len(self.data) >= self.max_size

    def push(self, x):
        if self.is_full():
            raise OverflowError("cbuffer full")
        self.data.append(x)

    def write(self, xs):
        xs = list(np.asarray(xs))
        if len(xs) > self.space_available():
            raise OverflowError("cbuffer write exceeds available space")
        self.data.extend(xs)

    def pop(self):
        if not self.data:
            raise IndexError("cbuffer empty")
        return self.data.pop(0)

    def read(self, n: int) -> np.ndarray:
        return np.asarray(self.data[:n], self.dtype)

    def release(self, n: int):
        if n > len(self.data):
            raise IndexError("cbuffer release exceeds size")
        del self.data[:n]

    def reset(self):
        self.data.clear()


class WDelay:
    """Fixed n-sample delay line (reference wdelay.c)."""

    def __init__(self, delay: int, dtype=np.complex64):
        self.delay = delay
        self.v = np.zeros(max(delay, 1), dtype)

    def push(self, x):
        out = self.v[0]
        if self.delay > 0:
            self.v = np.roll(self.v, -1)
            self.v[-1] = x
            return out
        return x

    def reset(self):
        self.v[:] = 0
