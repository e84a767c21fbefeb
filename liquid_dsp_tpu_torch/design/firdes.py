"""FIR filter design (host-side NumPy, float64), ported from
`liquid_dsp_tpu.design.firdes`: the Kaiser lowpass and its length,
attenuation and transition estimates, notch and Doppler filters, the
(root-)raised-cosine, root-Kaiser, GMSK, flipped-Nyquist and hM3 pulses,
the (root-)Nyquist prototype dispatch and the filter analysis helpers
(reference src/filter/src/firdes.c, rcos.c, rrcos.c, rkaiser.c, gmsk.c,
fnyquist.c, hM3.c, group_delay.c)."""
from __future__ import annotations

import numpy as np

from .special import besselj0, qfunction, sinc
from .windows import kaiser as kaiser_window
from .windows import kaiser_beta_as

__all__ = [
    "firdes_kaiser", "firdes_notch", "firdes_doppler",
    "firdes_rcos", "firdes_rrcos", "firdes_rkaiser", "firdes_arkaiser",
    "firdes_gmsktx", "firdes_gmskrx",
    "firdes_fexp", "firdes_rfexp", "firdes_fsech", "firdes_rfsech",
    "firdes_farcsech", "firdes_rfarcsech",
    "firdes_prototype", "firdes_hm3",
    "estimate_req_filter_len", "estimate_req_filter_as",
    "estimate_req_filter_df",
    "filter_autocorr", "filter_crosscorr", "filter_isi", "filter_energy",
    "fir_group_delay",
]


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


def estimate_req_filter_df(as_db: float, n: int) -> float:
    """Transition bandwidth achievable with length n at attenuation As."""
    df0, df1 = 1e-3, 0.499
    df_hat = 0.0
    for _ in range(20):
        df_hat = 0.5 * (df0 + df1)
        if _len_kaiser(df_hat, as_db) < float(n):
            df1 = df_hat
        else:
            df0 = df_hat
    return df_hat


def firdes_notch(m: int, f0: float, as_db: float) -> np.ndarray:
    """Notch filter: unit impulse minus windowed cosine at f0
    (reference firdes.c liquid_firdes_notch semantics); length 2m+1."""
    n = 2 * m + 1
    beta = kaiser_beta_as(as_db)
    i = np.arange(n, dtype=np.float64)
    t = i - m
    w = kaiser_window(n, beta)
    h = -np.cos(2.0 * np.pi * f0 * t) * w
    # scale so h sums to zero at f0 and center tap makes it all-pass elsewhere
    scale = -1.0 / np.sum(h * np.cos(2.0 * np.pi * f0 * t))
    h = h * scale
    h[m] += 1.0
    return h


def firdes_doppler(n: int, fd: float, k_rice: float, theta: float) -> np.ndarray:
    """Jakes Doppler filter (firdes.c:379-407): Bessel + Rice-K, Kaiser win."""
    i = np.arange(n, dtype=np.float64)
    t = i - (n - 1) / 2.0
    j = 1.5 * besselj0(np.abs(2 * np.pi * fd * t))
    r = 1.5 * k_rice / (k_rice + 1) * np.cos(2 * np.pi * fd * t * np.cos(theta))
    w = kaiser_window(n, 4.0)
    return (j + r) * w


def firdes_rcos(k: int, m: int, beta: float, dt: float = 0.0) -> np.ndarray:
    """Raised-cosine pulse, length 2km+1, gain k at center."""
    _check_kmb(k, m, beta)
    n = np.arange(2 * k * m + 1, dtype=np.float64)
    z = (n + dt) / k - m
    t1 = np.cos(beta * np.pi * z)
    t2 = sinc(z)
    t3 = 1.0 - 4.0 * beta * beta * z * z
    singular = np.abs(t3) < 1e-3
    safe = np.where(singular, 1.0, t3)
    h = t1 * t2 / safe
    if beta > 0:
        h = np.where(singular, np.sin(np.pi / (2 * beta)) * beta * 0.5, h)
    return h


def _fnyquist(freq_fn, root: bool, k: int, m: int, beta: float, dt: float) -> np.ndarray:
    _check_kmb(k, m, beta)
    n = 2 * k * m + 1
    f = np.arange(n, dtype=np.float64) / n
    f = np.abs(np.where(f > 0.5, f - 1.0, f))
    H = freq_fn(f, k, beta)
    if root:
        H = np.sqrt(np.clip(H, 0.0, None))
    h = np.fft.ifft(H) * n  # reference uses unnormalized inverse FFT
    return np.real(np.roll(h, -(k * m + 1))) * k / n


def _fexp_response(f, k, beta):
    f0 = 0.5 * (1 - beta) / k
    f2 = 0.5 * (1 + beta) / k
    f1 = 0.5 / k
    B = 0.5 / k
    gamma = np.log(2.0) / (beta * B) if beta > 0 else np.inf
    lo = np.exp(gamma * (B * (1 - beta) - f))
    hi = 1.0 - np.exp(gamma * (f - (1 + beta) * B))
    H = np.where(f < f1, lo, hi)
    H = np.where(f < f0, 1.0, np.where(f > f2, 0.0, H))
    return H


def _fsech_response(f, k, beta):
    f0 = 0.5 * (1 - beta) / k
    f2 = 0.5 * (1 + beta) / k
    f1 = 0.5 / k
    B = 0.5 / k
    gamma = np.log(np.sqrt(3.0) + 2.0) / (beta * B) if beta > 0 else np.inf
    lo = 1.0 / np.cosh(np.minimum(gamma * (f - B * (1 - beta)), 700))
    hi = 1.0 - 1.0 / np.cosh(np.minimum(gamma * (B * (1 + beta) - f), 700))
    H = np.where(f < f1, lo, hi)
    return np.where(f < f0, 1.0, np.where(f > f2, 0.0, H))


def _asech(x):
    x = np.clip(x, 1e-12, 1.0)
    return np.log((1.0 + np.sqrt(1.0 - x * x)) / x)


def _farcsech_response(f, k, beta):
    f0 = 0.5 * (1 - beta) / k
    f2 = 0.5 * (1 + beta) / k
    f1 = 0.5 / k
    B = 0.5 / k
    gamma = np.log(np.sqrt(3.0) + 2.0) / (beta * B) if beta > 0 else np.inf
    zeta = 1.0 / (2.0 * beta * B) if beta > 0 else np.inf
    lo = 1.0 - (zeta / gamma) * _asech(zeta * (B * (1 + beta) - f))
    hi = (zeta / gamma) * _asech(zeta * (f - B * (1 - beta)))
    H = np.where(f < f1, lo, hi)
    return np.where(f < f0, 1.0, np.where(f > f2, 0.0, H))


def firdes_fexp(k, m, beta, dt=0.0):
    return _fnyquist(_fexp_response, False, k, m, beta, dt)


def firdes_rfexp(k, m, beta, dt=0.0):
    return _fnyquist(_fexp_response, True, k, m, beta, dt)


def firdes_fsech(k, m, beta, dt=0.0):
    return _fnyquist(_fsech_response, False, k, m, beta, dt)


def firdes_rfsech(k, m, beta, dt=0.0):
    return _fnyquist(_fsech_response, True, k, m, beta, dt)


def firdes_farcsech(k, m, beta, dt=0.0):
    return _fnyquist(_farcsech_response, False, k, m, beta, dt)


def firdes_rfarcsech(k, m, beta, dt=0.0):
    return _fnyquist(_farcsech_response, True, k, m, beta, dt)


def firdes_hm3(k: int, m: int, beta: float, dt: float = 0.0) -> np.ndarray:
    """hM3 root-Nyquist: Remez design iterated to minimize ISI (hM3.c:35+)."""
    from .firdespm import firdespm  # lazy import to avoid cycle

    if k < 2:
        raise ValueError("hM3 requires k >= 2")
    n = 2 * k * m + 1
    fc = 1.0 / (2 * k)
    fs = fc * (1 + beta)

    def design(fp):
        bands = [(0.0, fp), (fc, fc), (fs, 0.5)]
        des = [1.0, 1.0 / np.sqrt(2.0), 0.0]
        weights = [1.0, 1.0, 1.0]
        return firdespm(n, bands, des, weights,
                        wtype=["flat", "flat", "exp"])

    best = design(fc * (1 - beta))
    isi_min, _ = filter_isi(best, k, m)
    pmax = 100
    for p in range(pmax):
        fp = fc * (1.0 - beta * p / pmax)
        h = design(fp)
        isi_rms, _ = filter_isi(h, k, m)
        if isi_rms > isi_min:
            break
        isi_min, best = isi_rms, h
    return best * np.sqrt(k / np.sum(best * best))


def filter_crosscorr(h: np.ndarray, g: np.ndarray, lag: int) -> float:
    """Cross-correlation of two real filters at a given lag."""
    h = np.asarray(h, dtype=np.float64)
    g = np.asarray(g, dtype=np.float64)
    full = np.correlate(h, g, mode="full")  # lags -len(g)+1 .. len(h)-1
    idx = lag + len(g) - 1
    if idx < 0 or idx >= len(full):
        return 0.0
    return float(full[idx])


def filter_energy(h: np.ndarray, fc: float, nfft: int = 1024) -> float:
    """Fraction of signal energy in band [-fc, fc]."""
    h = np.asarray(h, dtype=np.float64)
    f = np.fft.fftfreq(nfft)
    H2 = np.abs(np.fft.fft(h, nfft)) ** 2
    return float(np.sum(H2[np.abs(f) <= fc]) / np.sum(H2))


def fir_group_delay(h: np.ndarray, fc: float) -> float:
    """Group delay of an FIR filter at frequency fc (group_delay.c)."""
    h = np.asarray(h, dtype=np.float64)
    n = np.arange(len(h))
    w = 2 * np.pi * fc
    e = np.exp(-1j * w * n)
    num = np.sum(n * h * e)
    den = np.sum(h * e)
    return float(np.real(num / den))


_PROTOTYPES = {
    "rcos": firdes_rcos, "fexp": firdes_fexp, "fsech": firdes_fsech,
    "farcsech": firdes_farcsech, "arkaiser": firdes_arkaiser,
    "rkaiser": firdes_rkaiser, "rrcos": firdes_rrcos, "rrc": firdes_rrcos,
    "hm3": firdes_hm3, "gmsktx": firdes_gmsktx, "gmskrx": firdes_gmskrx,
    "rfexp": firdes_rfexp, "rfsech": firdes_rfsech,
    "rfarcsech": firdes_rfarcsech,
}


def firdes_prototype(ftype: str, k: int, m: int, beta: float,
                     dt: float = 0.0) -> np.ndarray:
    """(Root-)Nyquist prototype dispatch, length 2km+1 (firdes.c:290-375).

    Nyquist: kaiser, rcos, fexp, fsech, farcsech
    root-Nyquist: arkaiser, rkaiser, rrcos (rrc), hm3, gmsktx, gmskrx,
                  rfexp, rfsech, rfarcsech

    ``pm`` raises NotImplementedError: the JAX package's route for it
    (liquid_dsp_tpu/design/firdes.py:423) imports a ``firdespm_run`` that
    its firdespm module does not define, so it has no behaviour to match
    (ROADMAP queue 3)."""
    ftype = ftype.lower()
    if ftype == "kaiser":
        n = 2 * k * m + 1
        as_db = estimate_req_filter_as(beta / k, n)
        return firdes_kaiser(n, 0.5 / k, as_db, dt)
    if ftype == "pm":
        raise NotImplementedError(
            "prototype 'pm': the JAX reference's route "
            "(liquid_dsp_tpu/design/firdes.py:423) imports firdespm_run, "
            "which liquid_dsp_tpu/design/firdespm.py does not define, so "
            "there is no reference behaviour to port (ROADMAP queue 3)")
    if ftype not in _PROTOTYPES:
        raise ValueError(f"unknown prototype {ftype!r}")
    return _PROTOTYPES[ftype](k, m, beta, dt)
