"""Window functions (host-side NumPy, float64), ported from
`liquid_dsp_tpu.design.windows` (reference src/math/src/math.c:198-365:
kaiser, kbd, hamming, hann, blackman-harris, raised-cosine taper).  All
functions return full length-N windows as arrays."""
from __future__ import annotations

import numpy as np

from .special import besseli0

__all__ = ["kaiser", "kaiser_beta_as", "hamming", "hann", "blackmanharris",
           "kbd", "rcostaper", "window"]


def kaiser(n: int, beta: float, mu: float = 0.0) -> np.ndarray:
    """Kaiser window of length n (reference math.c:289-311 convention:
    r = 2*t/n with t = i - (n-1)/2 + mu; note divisor n, not n-1)."""
    i = np.arange(n, dtype=np.float64)
    t = i - (n - 1) / 2.0 + mu
    r = 2.0 * t / n
    r2 = np.clip(1.0 - r * r, 0.0, None)
    return besseli0(beta * np.sqrt(r2)) / besseli0(beta)


def kaiser_beta_as(as_db: float) -> float:
    """Kaiser beta from stop-band attenuation in dB
    (reference src/filter/src/firdes.c kaiser_beta_As; standard Kaiser fit)."""
    a = abs(as_db)
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a > 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def hamming(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return 0.53836 - 0.46164 * np.cos(2 * np.pi * i / (n - 1))


def hann(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2 * np.pi * i / (n - 1))


def blackmanharris(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    t = 2 * np.pi * i / (n - 1)
    return (0.35875 - 0.48829 * np.cos(t) + 0.14128 * np.cos(2 * t)
            - 0.01168 * np.cos(3 * t))


def kbd(n: int, beta: float) -> np.ndarray:
    """Kaiser-Bessel derived window, even length (reference math.c:239-281)."""
    if n % 2:
        raise ValueError("kbd window length must be even")
    m = n // 2
    wk = kaiser(m + 1, beta)
    csum = np.cumsum(wk)
    half = np.sqrt(csum[:m] / csum[m])
    return np.concatenate([half, half[::-1]])


def rcostaper(n: int, t: int) -> np.ndarray:
    """Flat window with raised-cosine tapered edges (math.c:346-365)."""
    if t > n // 2:
        raise ValueError("taper length cannot exceed half window length")
    i = np.arange(n)
    j = np.where(i > n - t - 1, n - i - 1, i)
    return np.where(j < t, 0.5 - 0.5 * np.cos(np.pi * (j + 0.5) / max(t, 1)),
                    1.0)


_WINDOWS = {
    "kaiser": lambda n, arg: kaiser(n, arg),
    "hamming": lambda n, arg: hamming(n),
    "hann": lambda n, arg: hann(n),
    "blackmanharris": lambda n, arg: blackmanharris(n),
    "kbd": lambda n, arg: kbd(n, arg),
    "rcostaper": lambda n, arg: rcostaper(n, int(arg)),
    "rect": lambda n, arg: np.ones(n, dtype=np.float64),
}


def window(kind: str, n: int, arg: float = 0.0) -> np.ndarray:
    """Window by name (analog of reference's window-type enum dispatch)."""
    if kind not in _WINDOWS:
        raise ValueError(f"unknown window {kind!r}; have {sorted(_WINDOWS)}")
    return _WINDOWS[kind](n, arg)
