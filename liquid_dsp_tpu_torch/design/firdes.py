"""Kaiser lowpass design, the Kaiser length estimates, the root-Kaiser
family, the root-raised-cosine pulse and the (root-)Nyquist prototype
dispatch (host-side NumPy, float64) and the GMSK transmit and receive
pulses, ported from `liquid_dsp_tpu.design.firdes` (reference
src/filter/src/firdes.c:52-160, 244-375; rkaiser.c; rrcos.c; gmsk.c)."""
from __future__ import annotations

import numpy as np

from .special import qfunction, sinc
from .windows import kaiser as kaiser_window
from .windows import kaiser_beta_as

__all__ = ["firdes_kaiser", "estimate_req_filter_len",
           "estimate_req_filter_as", "firdes_rkaiser", "firdes_arkaiser",
           "firdes_rrcos", "firdes_gmsktx", "firdes_gmskrx",
           "firdes_prototype", "filter_autocorr",
           "filter_isi"]


def _len_kaiser(df: float, as_db: float) -> float:
    return (as_db - 7.95) / (14.26 * df)


def estimate_req_filter_as(df: float, n: int) -> float:
    """Stop-band attenuation achievable with length n at transition df
    (bisection inverse of the Kaiser length formula, firdes.c:80-115)."""
    as0, as1 = 0.01, 200.0
    as_hat = 0.0
    for _ in range(20):
        as_hat = 0.5 * (as0 + as1)
        if _len_kaiser(df, as_hat) < float(n):
            as0 = as_hat
        else:
            as1 = as_hat
    return as_hat


def filter_autocorr(h: np.ndarray, lag: int) -> float:
    h = np.asarray(h, dtype=np.float64)
    lag = abs(int(lag))
    if lag >= len(h):
        return 0.0
    return float(np.dot(h[lag:], h[: len(h) - lag]))


def filter_isi(h: np.ndarray, k: int, m: int):
    """RMS / max inter-symbol interference of a root-Nyquist filter."""
    rxx0 = filter_autocorr(h, 0)
    e = np.array([abs(filter_autocorr(h, i * k) / rxx0)
                  for i in range(1, 2 * m + 1)])
    return float(np.sqrt(np.mean(e ** 2))), float(np.max(e))


def _check_kmb(k, m, beta):
    if k < 1 or m < 1:
        raise ValueError("k and m must be >= 1")
    if not (0.0 <= beta <= 1.0):
        raise ValueError("beta must be in [0,1]")


def _rkaiser_rho_approx(m: int, beta: float) -> float:
    """Closed-form seed for the bandwidth-correction factor (the
    reference's fit, rkaiser.c:82-128)."""
    c0 = 0.762886 + 0.067663 * np.log(m)
    c1 = 0.065515
    c2 = np.log(max(1 - 0.088 * m ** -1.6, 1e-12))
    lb = np.log(beta)
    rho = c0 + c1 * lb + c2 * lb * lb
    return float(np.clip(rho, 0.05, 0.95))


def _rkaiser_taps(k: int, m: int, beta: float, dt: float,
                  rho: float) -> np.ndarray:
    n = 2 * k * m + 1
    kf = float(k)
    delta = beta * rho / kf
    as_db = estimate_req_filter_as(delta, n)
    fc = 0.5 * (1 + beta * (1.0 - rho)) / kf
    return firdes_kaiser(n, fc, as_db, dt)


def _rkaiser_isi(k: int, m: int, beta: float, dt: float, rho: float) -> float:
    rms, _ = filter_isi(_rkaiser_taps(k, m, beta, dt, rho), k, m)
    return rms


def firdes_rkaiser(k: int, m: int, beta: float, dt: float = 0.0) -> np.ndarray:
    """Root-Nyquist Kaiser filter via ternary search of ISI over rho
    (the reference's rkaiser.c:219 search)."""
    _check_kmb(k, m, beta)
    rho_hat = _rkaiser_rho_approx(m, beta)
    x0, x2 = 0.5 * rho_hat, 1.0
    x1 = rho_hat
    y0 = _rkaiser_isi(k, m, beta, dt, x0)
    y1 = _rkaiser_isi(k, m, beta, dt, x1)
    y2 = _rkaiser_isi(k, m, beta, dt, x2)
    for _ in range(20):
        xa, xb = 0.5 * (x0 + x1), 0.5 * (x1 + x2)
        ya = _rkaiser_isi(k, m, beta, dt, xa)
        yb = _rkaiser_isi(k, m, beta, dt, xb)
        if y1 < ya and y1 < yb:
            x0, y0, x2, y2 = xa, ya, xb, yb
        elif ya < yb:
            x2, y2, x1, y1 = x1, y1, xa, ya
        else:
            x0, y0, x1, y1 = x1, y1, xb, yb
    h = _rkaiser_taps(k, m, beta, dt, x1)
    return h * np.sqrt(k / np.sum(h * h))


def firdes_arkaiser(k: int, m: int, beta: float, dt: float = 0.0) -> np.ndarray:
    """Approximate root-Kaiser: closed-form rho estimate, no search
    (rkaiser.c:82-148).  The frame64 pulse shape."""
    _check_kmb(k, m, beta)
    if k < 2:
        raise ValueError("arkaiser requires k >= 2")
    rho = _rkaiser_rho_approx(m, beta)
    h = _rkaiser_taps(k, m, beta, dt, rho)
    return h * np.sqrt(k / np.sum(h * h))


def estimate_req_filter_len(df: float, as_db: float) -> int:
    """Estimated filter length for transition bw ``df`` and stop-band ``As``."""
    if not (0.0 < df <= 0.5):
        raise ValueError(f"invalid transition bandwidth {df}")
    if as_db <= 0:
        raise ValueError(f"invalid stop-band attenuation {as_db}")
    n = (as_db - 7.95) / (14.26 * df)
    return max(int(n), 1)


def firdes_kaiser(n: int, fc: float, as_db: float, mu: float = 0.0) -> np.ndarray:
    """Kaiser-windowed sinc lowpass: h[i] = sinc(2 fc t) * kaiser(i)."""
    if not (-0.5 <= mu <= 0.5):
        raise ValueError("mu out of range [-0.5, 0.5]")
    if not (0.0 < fc <= 0.5):
        raise ValueError("cutoff out of range (0, 0.5]")
    beta = kaiser_beta_as(as_db)
    i = np.arange(n, dtype=np.float64)
    t = i - (n - 1) / 2.0 + mu
    return (sinc(2.0 * fc * t) * kaiser_window(n, beta, mu)).astype(np.float64)


def firdes_rrcos(k: int, m: int, beta: float, dt: float = 0.0) -> np.ndarray:
    """Root-raised-cosine pulse, length 2km+1 (rrcos.c)."""
    _check_kmb(k, m, beta)
    n = np.arange(2 * k * m + 1, dtype=np.float64)
    z = (n + dt) / k - m
    t1 = np.cos((1 + beta) * np.pi * z)
    t2 = np.sin((1 - beta) * np.pi * z)
    with np.errstate(divide="ignore", invalid="ignore"):
        t3 = 1.0 / (4.0 * beta * z)
        g = (1.0 - 16.0 * beta * beta * z * z) ** 2
        t4 = 4.0 * beta / (np.pi * (1.0 - 16.0 * beta * beta * z * z))
        h = t4 * (t1 + t2 * t3)
    # z == 0 singularity
    h = np.where(np.abs(z) < 1e-5, 1.0 - beta + 4.0 * beta / np.pi, h)
    # 16 b^2 z^2 == 1 singularity
    g1 = 1.0 + 2.0 / np.pi
    g2 = np.sin(0.25 * np.pi / beta) if beta > 0 else 0.0
    g3 = 1.0 - 2.0 / np.pi
    g4 = np.cos(0.25 * np.pi / beta) if beta > 0 else 0.0
    hs = beta / np.sqrt(2.0) * (g1 * g2 + g3 * g4)
    h = np.where((g < 1e-5) & (np.abs(z) >= 1e-5), hs, h)
    return h


def firdes_gmsktx(k: int, m: int, beta: float, dt: float = 0.0) -> np.ndarray:
    """Gaussian transmit pulse (gmsk.c:40-81): a difference of Q
    functions, normalized so that the integral is (pi/2) * k."""
    _check_kmb(k, m, beta)
    n = 2 * k * m + 1
    t = np.arange(n, dtype=np.float64) / k - m + dt
    c0 = 1.0 / np.sqrt(np.log(2.0))
    h = qfunction(2 * np.pi * beta * (t - 0.5) * c0) - \
        qfunction(2 * np.pi * beta * (t + 0.5) * c0)
    h *= np.pi / (2.0 * np.sum(h))
    return h * k


def firdes_gmskrx(k: int, m: int, beta: float, dt: float = 0.0) -> np.ndarray:
    """GMSK receive filter (gmsk.c:89-193): the frequency-domain
    deconvolution of the transmit pulse against a Kaiser Nyquist
    prototype, with extra stop-band shaping."""
    _check_kmb(k, m, beta)
    n = 2 * k * m + 1
    delta = 1e-3
    ht = firdes_gmsktx(k, m, beta, 0.0)
    h_prime = firdes_prototype("kaiser", k, m, beta, 0.0)
    g_prime = firdes_kaiser(n, (0.7 + 0.1 * beta) / k, 60.0, 0.0)

    def spectrum(v):
        return np.real(np.fft.fft(np.roll(v, -(k * m))))

    H_tx, H_p, G_p = spectrum(ht), spectrum(h_prime), spectrum(g_prime)
    H_hat = (H_p - H_p.min() + delta) / (H_tx - H_tx.min() + delta)
    H_hat *= (G_p - G_p.min()) / G_p[0]
    h_hat = np.fft.ifft(H_hat) * n   # the reference's unnormalized inverse
    return np.real(np.roll(h_hat, -(k * m + 1))) / (k * n) * k * k


_PROTOTYPES = {"arkaiser": firdes_arkaiser, "rkaiser": firdes_rkaiser,
               "rrcos": firdes_rrcos, "rrc": firdes_rrcos,
               "gmsktx": firdes_gmsktx, "gmskrx": firdes_gmskrx}


def firdes_prototype(ftype: str, k: int, m: int, beta: float,
                     dt: float = 0.0) -> np.ndarray:
    """(Root-)Nyquist prototype dispatch, length 2km+1 (firdes.c:290-375):
    the Nyquist ``kaiser`` and the root-Nyquist ``arkaiser``, ``rkaiser``,
    ``rrcos``/``rrc``, ``gmsktx`` and ``gmskrx``.  The other prototypes of the reference are not
    ported yet (ROADMAP queue 1 item 5) and raise NotImplementedError."""
    ftype = ftype.lower()
    if ftype == "kaiser":
        n = 2 * k * m + 1
        as_db = estimate_req_filter_as(beta / k, n)
        return firdes_kaiser(n, 0.5 / k, as_db, dt)
    if ftype not in _PROTOTYPES:
        raise NotImplementedError(
            f"prototype {ftype!r} is not ported yet (ROADMAP queue 1 item 5)")
    return _PROTOTYPES[ftype](k, m, beta, dt)
