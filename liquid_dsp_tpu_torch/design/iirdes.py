"""IIR filter design: analog prototypes -> bilinear transform -> TF/SOS
(host-side NumPy, float64), ported line for line from
`liquid_dsp_tpu.design.iirdes`.

Reference analog: liquid_iirdes (reference src/filter/src/iirdes.c:
470-660) with the analog prototypes butter_azpkf (butter.c:44),
cheby1_azpkf (cheby1.c:47), cheby2_azpkf (cheby2.c), ellip_azpkf
(ellip.c:271), bessel_azpkf (bessel.c:67); bilinear_zpkf (iirdes.c:232);
the digital LP->HP (negate z/p) and LP->BP (quadratic pair) transforms;
SOS pairing (iirdes.c dzpk2sosf); PLL loop filters (iirdes.pll.c).

The elliptic prototype uses Landen-iteration Jacobi elliptic functions
(the Orfanidis recipe) rather than the reference's tables.

Gain convention: the digital filter is normalized so the passband
reference frequency (DC for lowpass/bandstop, Nyquist for highpass, f0
for bandpass) has gain k0 = 1, except even-order cheby1/ellip where
k0 = 1/sqrt(1+eps_p^2) (reference iirdes.c:528,546).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "butter_prototype", "cheby1_prototype", "cheby2_prototype",
    "ellip_prototype", "bessel_prototype",
    "iirdes", "iirdes_sos", "bilinear_zpk", "zpk2tf", "zpk2sos",
    "iirdes_pll_active_lag", "iirdes_pll_active_pi",
    "iirdes_isstable",
]


# ---------------------------------------------------------------------------
# analog prototypes (normalized lowpass, zeros/poles/gain)


def butter_prototype(n: int):
    """Butterworth: n poles on the unit circle LHP (reference butter.c:44)."""
    k = np.arange(1, n // 2 + 1)
    theta = (2 * k + n - 1) * np.pi / (2 * n)
    p = np.concatenate([np.exp(1j * theta), np.exp(-1j * theta)])
    if n % 2:
        p = np.append(p, -1.0)
    return np.array([]), p, 1.0


def cheby1_prototype(n: int, ap_db: float):
    """Chebyshev type I: poles on an ellipse; passband ripple Ap dB."""
    eps = np.sqrt(10.0 ** (ap_db / 10.0) - 1.0)
    a = np.arcsinh(1.0 / eps) / n
    k = np.arange(n)
    theta = np.pi * (2 * k + 1) / (2 * n)
    p = -np.sinh(a) * np.sin(theta) + 1j * np.cosh(a) * np.cos(theta)
    return np.array([]), p, 1.0


def cheby2_prototype(n: int, as_db: float):
    """Chebyshev type II (inverse): equiripple stopband As dB."""
    eps = 10.0 ** (-as_db / 20.0)
    eps = eps / np.sqrt(1.0 - eps * eps)  # = 1/sqrt(10^(As/10)-1)
    a = np.arcsinh(1.0 / eps) / n
    k = np.arange(n)
    theta = np.pi * (2 * k + 1) / (2 * n)
    # poles: reciprocal of cheby1-style poles
    p1 = -np.sinh(a) * np.sin(theta) + 1j * np.cosh(a) * np.cos(theta)
    p = 1.0 / p1
    # zeros on the imaginary axis (skip theta = pi/2 for odd order)
    zt = theta[np.abs(np.cos(theta)) > 1e-9]
    z = 1j / np.cos(zt)
    return z, p, 1.0


# -- Jacobi elliptic helpers (Landen iteration) -----------------------------


def _landen(k: float, tol: float = 1e-14):
    vs = []
    while k > tol:
        k = (k / (1.0 + np.sqrt(1.0 - k * k))) ** 2
        vs.append(k)
        if len(vs) > 64:
            break
    return vs


def _ellipk(k: float) -> float:
    return float(np.prod([1.0 + v for v in _landen(k)]) * np.pi / 2)


def _ellipdeg(n: int, k1: float) -> float:
    """Solve the degree equation for the elliptic modulus k."""
    K1 = _ellipk(k1)
    K1p = _ellipk(np.sqrt(1.0 - k1 * k1))
    q1 = np.exp(-np.pi * K1p / K1)
    q = q1 ** (1.0 / n)
    m = np.arange(1, 10)
    num = np.sum(q ** (m * (m + 1)))
    den = 1.0 + 2.0 * np.sum(q ** (m * m))
    return float(4.0 * np.sqrt(q) * ((1.0 + num) / den) ** 2)


def _cde(u, k: float):
    """Jacobi cd(u*K, k) for (possibly complex) normalized argument u."""
    vs = _landen(k)
    w = np.cos(np.asarray(u) * np.pi / 2)
    for v in reversed(vs):
        w = (1.0 + v) * w / (1.0 + v * w * w)
    return w


def _sne(u, k: float):
    vs = _landen(k)
    w = np.sin(np.asarray(u) * np.pi / 2)
    for v in reversed(vs):
        w = (1.0 + v) * w / (1.0 + v * w * w)
    return w


def _asne(w, k: float):
    """Inverse sn: u with sn(u*K, k) = w (normalized units)."""
    vs = _landen(k)
    kp = k
    w = np.asarray(w, np.complex128)
    for v in vs:
        w = 2.0 * w / ((1.0 + v) * (1.0 + np.sqrt(1.0 - kp * kp * w * w)))
        kp = v
    return 2.0 / np.pi * np.arcsin(w)


def ellip_prototype(n: int, ap_db: float, as_db: float):
    """Elliptic (Cauer): equiripple passband and stopband
    (reference ellip.c:271 ellip_azpkf; Landen/Jacobi recipe)."""
    ep = np.sqrt(10.0 ** (ap_db / 10.0) - 1.0)
    es = np.sqrt(10.0 ** (as_db / 10.0) - 1.0)
    k1 = ep / es
    k = _ellipdeg(n, k1)
    L = n // 2
    r = n % 2
    ui = (2.0 * np.arange(1, L + 1) - 1.0) / n
    # zeros: j / (k * cd(u_i))
    zeta = _cde(ui, k)
    z_half = 1j / (k * zeta)
    z = np.concatenate([z_half, np.conj(z_half)])
    # poles: j * cd(u_i - j*v0)
    v0 = -1j * _asne(1j / ep, k1) / n
    p_half = 1j * _cde(ui - 1j * v0, k)
    p = np.concatenate([p_half, np.conj(p_half)])
    if r:
        p0 = 1j * _sne(1j * v0, k)
        p = np.append(p, np.real(p0))
    return z, p, 1.0


def bessel_prototype(n: int):
    """Bessel: roots of the reverse Bessel polynomial, renormalized by the
    approximate 3-dB frequency sqrt((2n-1) ln 2) (reference bessel.c:67-90,
    citing [Bianchi:2007] (1.67))."""
    # reverse Bessel polynomial coefficients via lngamma (bessel.c fpoly_bessel)
    from math import lgamma, log
    N = n
    logc = np.array([lgamma(2 * N - kk + 1) - lgamma(kk + 1)
                     - lgamma(N - kk + 1) - (N - kk) * log(2.0)
                     for kk in range(N + 1)])
    c = np.exp(logc)  # coefficient of s^k
    p = np.roots(c[::-1])
    w3db = np.sqrt((2 * n - 1) * np.log(2.0))
    p = p / w3db
    return np.array([]), p, 1.0


# ---------------------------------------------------------------------------
# bilinear transform + band transforms + expansion


def _freqprewarp(btype: str, fc: float, f0: float) -> float:
    """Reference iirdes.c:200-216."""
    if btype == "lowpass":
        m = np.tan(np.pi * fc)
    elif btype == "highpass":
        m = -np.cos(np.pi * fc) / np.sin(np.pi * fc)
    elif btype == "bandpass":
        m = (np.cos(2 * np.pi * fc) - np.cos(2 * np.pi * f0)) / \
            np.sin(2 * np.pi * fc)
    elif btype == "bandstop":
        m = np.sin(2 * np.pi * fc) / \
            (np.cos(2 * np.pi * fc) - np.cos(2 * np.pi * f0))
    else:
        raise ValueError(f"unknown band type {btype!r}")
    return abs(float(m))


def bilinear_zpk(z, p, m: float):
    """Analog z/p -> digital z/p with prewarp factor m
    (reference iirdes.c:232 bilinear_zpkf).  Missing zeros map to -1."""
    n = len(p)
    zm = np.asarray(z) * m
    pm = np.asarray(p) * m
    zd = (1.0 + zm) / (1.0 - zm)
    zd = np.concatenate([zd, -np.ones(n - len(zd))])
    pd = (1.0 + pm) / (1.0 - pm)
    return zd, pd


def _lp2hp(z, p):
    return -z, -p


def _lp2bp(z, p, f0: float):
    """Digital LP->BP via the quadratic pair transform
    (reference iirdes.c dzpk_lp2bp); doubles the order."""
    c0 = np.cos(2 * np.pi * f0)

    def xf(v):
        t0 = 1.0 + v
        s = np.sqrt((c0 * t0) ** 2 - 4.0 * v + 0j)
        return np.concatenate([0.5 * (c0 * t0 + s), 0.5 * (c0 * t0 - s)])

    return xf(np.asarray(z, complex)), xf(np.asarray(p, complex))


def zpk2tf(z, p, k=1.0):
    """Expand zeros/poles to transfer-function coefficients
    (ascending powers of z^-1)."""
    b = np.real(np.poly(z)) * k
    a = np.real(np.poly(p))
    return b, a


def _cplxpair(v, tol=1e-6):
    """Sort into conjugate pairs then reals (reference liquid_cplxpair)."""
    v = np.asarray(v, complex)
    cplx = sorted(v[np.abs(v.imag) > tol], key=lambda x: (x.real, abs(x.imag)))
    reals = sorted(v[np.abs(v.imag) <= tol].real)
    out = []
    used = [False] * len(cplx)
    for i, x in enumerate(cplx):
        if used[i] or x.imag < 0:
            continue
        # find conjugate
        for j, y in enumerate(cplx):
            if not used[j] and j != i and abs(y - np.conj(x)) < 1e-3 * max(1, abs(x)):
                out.extend([np.conj(x), x])
                used[i] = used[j] = True
                break
    out.extend(reals)
    return np.asarray(out)


def zpk2sos(z, p, k=1.0):
    """Group conjugate pairs into biquads: returns (B, A) of shape [ns, 3]
    (reference iirdes.c dzpk2sosf).  Gain k folds into the first section."""
    n = len(p)
    zp = _cplxpair(z)
    pp = _cplxpair(p)
    r = n % 2
    L = (n - r) // 2
    B = np.zeros((L + r, 3))
    A = np.zeros((L + r, 3))
    for i in range(L):
        z0, z1 = -zp[2 * i], -zp[2 * i + 1]
        p0, p1 = -pp[2 * i], -pp[2 * i + 1]
        B[i] = [1.0, np.real(z0 + z1), np.real(z0 * z1)]
        A[i] = [1.0, np.real(p0 + p1), np.real(p0 * p1)]
    if r:
        B[L] = [1.0, np.real(-zp[-1]), 0.0]
        A[L] = [1.0, np.real(-pp[-1]), 0.0]
    B[0] *= k
    return B, A


_PROTOTYPES = {
    "butter": lambda n, ap, as_: butter_prototype(n),
    "cheby1": lambda n, ap, as_: cheby1_prototype(n, ap),
    "cheby2": lambda n, ap, as_: cheby2_prototype(n, as_),
    "ellip": lambda n, ap, as_: ellip_prototype(n, ap, as_),
    "bessel": lambda n, ap, as_: bessel_prototype(n),
}


def _design_zpk(ftype, btype, n, fc, f0, ap_db, as_db):
    if not (0 < fc < 0.5):
        raise ValueError("cutoff frequency must be in (0, 0.5)")
    if ftype not in _PROTOTYPES:
        raise ValueError(f"unknown filter type {ftype!r}; "
                         f"choose from {sorted(_PROTOTYPES)}")
    z, p, _ = _PROTOTYPES[ftype](n, ap_db, as_db)
    m = _freqprewarp(btype, fc, f0)
    zd, pd = bilinear_zpk(z, p, m)
    if btype in ("highpass", "bandstop"):
        zd, pd = _lp2hp(zd, pd)
    if btype in ("bandpass", "bandstop"):
        zd, pd = _lp2bp(zd, pd, f0)
    # passband gain target (reference iirdes.c:520-547 k0 logic)
    k0 = 1.0
    if ftype in ("cheby1", "ellip") and n % 2 == 0:
        k0 = 1.0 / np.sqrt(1.0 + (10.0 ** (ap_db / 10.0) - 1.0))
    # normalization frequency: where the passband lives
    fref = {"lowpass": 0.0, "highpass": 0.5,
            "bandpass": f0, "bandstop": 0.0}[btype]
    return zd, pd, k0, fref


def _gain_at(b, a, f):
    zi = np.exp(-2j * np.pi * f)
    num = sum(bk * zi ** i for i, bk in enumerate(b))
    den = sum(ak * zi ** i for i, ak in enumerate(a))
    return num / den


def iirdes(ftype: str, n: int, fc: float, f0: float = 0.0,
           ap_db: float = 1.0, as_db: float = 60.0,
           btype: str = "lowpass"):
    """Design an IIR digital filter; returns (b, a) transfer function
    (reference liquid_iirdes with LIQUID_IIRDES_TF)."""
    zd, pd, k0, fref = _design_zpk(ftype, btype, n, fc, f0, ap_db, as_db)
    b, a = zpk2tf(zd, pd)
    g = _gain_at(b, a, fref)
    b = b * (k0 / abs(g))
    return b.astype(np.float64), a.astype(np.float64)


def iirdes_sos(ftype: str, n: int, fc: float, f0: float = 0.0,
               ap_db: float = 1.0, as_db: float = 60.0,
               btype: str = "lowpass"):
    """Design an IIR digital filter in second-order sections; returns
    (B, A) [ns, 3] (reference liquid_iirdes with LIQUID_IIRDES_SOS)."""
    zd, pd, k0, fref = _design_zpk(ftype, btype, n, fc, f0, ap_db, as_db)
    B, A = zpk2sos(zd, pd)
    # normalize composite gain at the reference frequency
    g = 1.0 + 0j
    for i in range(B.shape[0]):
        g = g * _gain_at(B[i], A[i], fref)
    B[0] = B[0] / abs(g) * k0
    return B, A


# ---------------------------------------------------------------------------
# PLL loop filters (reference iirdes.pll.c)


def iirdes_pll_active_lag(w: float, zeta: float, K: float):
    """2nd-order active-lag PLL loop filter (reference iirdes.pll.c:38-67)."""
    if w <= 0 or zeta <= 0 or K <= 0:
        raise ValueError("PLL parameters must be positive")
    t1 = K / (w * w)
    t2 = 2 * zeta / w - 1.0 / K
    b = np.array([2 * K * (1 + t2 / 2), 4 * K, 2 * K * (1 - t2 / 2)])
    a = np.array([1 + t1 / 2, -t1, -1 + t1 / 2])
    return b, a


def iirdes_pll_active_pi(w: float, zeta: float, K: float):
    """2nd-order active proportional-integral PLL loop filter
    (reference iirdes.pll.c:69-100)."""
    if w <= 0 or zeta <= 0 or K <= 0:
        raise ValueError("PLL parameters must be positive")
    t1 = K / (w * w)
    t2 = 2 * zeta / w
    b = np.array([2 * K * (1 + t2 / 2), 4 * K, 2 * K * (1 - t2 / 2)])
    a = np.array([t1 / 2, -t1, t1 / 2])
    return b, a


def iirdes_isstable(b, a) -> bool:
    """True when every pole (root of the denominator) lies strictly
    inside the unit circle (reference iirdes.c:669-703
    iirdes_isstable: Bairstow root-finding on the flipped denominator;
    numpy's companion-matrix roots are the equivalent here)."""
    a = np.asarray(a, np.float64)
    if a.size < 2:
        raise ValueError("filter order too low")
    roots = np.roots(a)
    return bool(np.all(np.abs(roots) < 1.0))
