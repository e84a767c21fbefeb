"""Filter designs of the benchmark's configurations, frozen: the
Kaiser-windowed sinc lowpass and the halfband prototype of liquid-dsp's
resamp2.

Plain numpy in float64, copied from the designs of liquid-dsp
(src/filter/src/firdes.c, resamp2.c; src/math/src/math.c and
math.bessel.c) as the port states them, so that the program's changes
never move the yardstick.  Nothing here imports the program.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["kaiser_beta_as", "kaiser_window", "firdes_kaiser",
           "halfband_taps", "msresamp_decim_stages", "estimate_req_filter_len"]


def _besseli0(z):
    """I_0(z) by the ascending series in log space (math.bessel.c:41)."""
    z = np.asarray(z, dtype=np.float64)
    nz = z != 0
    half = 0.5 * (float(np.max(np.abs(z))) if z.size else 0.0)
    iterations = max(64, int(half + 9.0 * math.sqrt(half + 1.0)) + 8)
    zl = np.log(0.5 * np.where(nz, z, 1.0))
    ks = np.arange(iterations, dtype=np.float64)
    lg = np.array([2.0 * math.lgamma(k + 1.0) for k in range(iterations)])
    t = 2.0 * ks[:, None] * zl.reshape(1, -1) - lg[:, None]
    tmax = np.max(t, axis=0)
    lse = tmax + np.log(np.sum(np.exp(t - tmax), axis=0))
    return np.exp(np.where(nz, lse.reshape(z.shape), 0.0))


def kaiser_beta_as(as_db: float) -> float:
    """Kaiser beta from the stop-band attenuation in dB."""
    a = abs(as_db)
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a > 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def kaiser_window(n: int, beta: float, mu: float = 0.0) -> np.ndarray:
    """Kaiser window, liquid's convention r = 2 t / n, t = i - (n-1)/2 + mu."""
    t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0 + mu
    r = 2.0 * t / n
    r2 = np.clip(1.0 - r * r, 0.0, None)
    return _besseli0(beta * np.sqrt(r2)) / _besseli0(beta)


def firdes_kaiser(n: int, fc: float, as_db: float,
                  mu: float = 0.0) -> np.ndarray:
    """Kaiser-windowed sinc lowpass h[i] = sinc(2 fc t) w[i]."""
    t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0 + mu
    return np.sinc(2.0 * fc * t) * kaiser_window(n, kaiser_beta_as(as_db),
                                                 mu)


def estimate_req_filter_len(df: float, as_db: float) -> int:
    """Kaiser's length estimate for transition band df and attenuation."""
    return max(int((as_db - 7.95) / (14.26 * df)), 1)


def halfband_taps(m: int, as_db: float) -> np.ndarray:
    """resamp2's halfband prototype, 4m+1 taps: sinc(t/2) w[i], t = i - 2m."""
    n = 4 * m + 1
    t = np.arange(n) - (n - 1) / 2.0
    return np.sinc(t / 2.0) * kaiser_window(n, kaiser_beta_as(as_db))


def msresamp_decim_stages(rate: float, as_db: float):
    """The decimating halfband stages of msresamp at a rate 2^-k: a list
    of (taps, down 2, output phase 1) per stage and the gain 2^-k that
    offsets each stage's DC gain of 2 (msresamp.c, msresamp2.c)."""
    k = round(-math.log2(rate))
    if k < 1 or 2.0 ** -k != rate:
        raise ValueError(f"only power-of-two decimations, got rate {rate}")
    stages, fc = [], 0.4
    for _ in range(k):
        fc *= 0.5
        h_len = estimate_req_filter_len((0.5 - fc) / 2.0, as_db)
        m = max(2, int(np.ceil((h_len - 1) / 4.0)))
        stages.append((halfband_taps(m, as_db), 2, 1))
    return stages, 0.5 ** k

