"""Block interleaver, bit-exact with the reference, as host numpy
(`liquid_dsp_tpu/fec/interleave.py`).

Reference analog: src/fec/src/interleaver.c:68-283 — M = 1+floor(sqrt(n)),
N minimal with M*N > n; depth-4 cascade of index-swap permutations, three
of them with bit masks (0x0f, 0x55, 0x33) that swap bit subsets between
byte pairs.  Each pass's swap pairs are disjoint, so a pass is one
vectorized exchange, and an involution: decode replays the passes in
reverse stage order.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["interleaver_dims", "interleave", "deinterleave",
           "interleave_soft", "deinterleave_soft"]


def interleaver_dims(n: int):
    """(M, N) block dimensions (reference interleaver.c:89-92)."""
    M = 1 + int(np.floor(np.sqrt(n)))
    N = n // M
    while n >= M * N:
        N += 1
    return M, N


@lru_cache(maxsize=None)
def _perm_index(n: int, M: int, N: int):
    """Even slots 2i and odd slots 2j+1 swapped by one permutation pass
    (reference interleaver.c interleaver_permute:196-219)."""
    ie, io = [], []
    m = 0
    nn = n // 3
    n2 = n // 2
    for i in range(n2):
        while True:
            j = m * N + nn
            m += 1
            if m == M:
                nn = (nn + 1) % N
                m = 0
            if j < n2:
                break
        ie.append(2 * i)
        io.append(2 * j + 1)
    return np.asarray(ie, np.int64), np.asarray(io, np.int64)


def _permute(x: np.ndarray, n: int, M: int, N: int, mask: int | None):
    ie, io = _perm_index(n, M, N)
    a, b = x[ie].copy(), x[io].copy()
    if mask is None:
        x[ie], x[io] = b, a
    else:
        inv = (~mask) & 0xFF
        x[ie] = (a & inv) | (b & mask)
        x[io] = (a & mask) | (b & inv)


_STAGES = ((0, None), (2, 0x0F), (4, 0x55), (8, 0x33))


def interleave(msg, depth: int = 4) -> np.ndarray:
    """Forward interleave a byte array (reference interleaver_encode)."""
    x = np.array(msg, np.uint8, copy=True)
    n = len(x)
    if n == 0:
        return x
    M, N = interleaver_dims(n)
    for dn, mask in _STAGES[:max(0, min(depth, 4))]:
        _permute(x, n, M, N + dn, mask)
    return x


def deinterleave(msg, depth: int = 4) -> np.ndarray:
    """Inverse interleave (reference interleaver_decode)."""
    x = np.array(msg, np.uint8, copy=True)
    n = len(x)
    if n == 0:
        return x
    M, N = interleaver_dims(n)
    for d in range(min(depth, 4) - 1, -1, -1):
        dn, mask = _STAGES[d]
        _permute(x, n, M, N + dn, mask)
    return x


def _soft_pass(xb: np.ndarray, n: int, M: int, N: int, mask: int | None):
    """One permutation pass on per-bit soft values xb [n, 8]
    (reference interleaver_permute_soft / _mask_soft)."""
    ie, io = _perm_index(n, M, N)
    a, b = xb[ie].copy(), xb[io].copy()
    if mask is None:
        xb[ie], xb[io] = b, a
    else:
        sel = np.asarray([(mask >> (7 - k)) & 1 for k in range(8)], bool)
        xb[ie] = np.where(sel[None, :], b, a)
        xb[io] = np.where(sel[None, :], a, b)


def interleave_soft(bits: np.ndarray, depth: int = 4) -> np.ndarray:
    """Forward interleave per-bit soft values [8*n] (reference
    interleaver_encode_soft)."""
    x = np.array(bits, copy=True)
    n = len(x) // 8
    if n == 0:
        return x
    xb = x.reshape(n, 8)
    M, N = interleaver_dims(n)
    for dn, mask in _STAGES[:max(0, min(depth, 4))]:
        _soft_pass(xb, n, M, N + dn, mask)
    return xb.reshape(-1)


def deinterleave_soft(bits: np.ndarray, depth: int = 4) -> np.ndarray:
    """Inverse (reference interleaver_decode_soft)."""
    x = np.array(bits, copy=True)
    n = len(x) // 8
    if n == 0:
        return x
    xb = x.reshape(n, 8)
    M, N = interleaver_dims(n)
    for d in range(min(depth, 4) - 1, -1, -1):
        dn, mask = _STAGES[d]
        _soft_pass(xb, n, M, N + dn, mask)
    return xb.reshape(-1)
