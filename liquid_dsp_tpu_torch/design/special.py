"""Special math functions used by filter design (host-side NumPy, float64).

The subset of `liquid_dsp_tpu.design.special` that the Kaiser and GMSK
designs and `utils/random.py`'s densities need, ported line for line so both packages produce the same taps to the
last bit (reference src/math/src/math.bessel.c, src/math/src/math.c).
Design code stays numpy: coefficients are made once on the host and only
the final taps become tensors.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["lngamma", "lnlowergamma", "marcumq1", "lnbesseli", "besseli",
           "besseli0", "sinc", "qfunction"]


def lngamma(z):
    return np.vectorize(math.lgamma)(np.asarray(z, dtype=np.float64))


def lnlowergamma(z, alpha):
    """log of the lower incomplete gamma function ln(gamma(z, alpha))
    (reference src/math/src/math.gamma.c liquid_lnlowergammaf): series
    gamma(z,a) = a^z Gamma(z) e^-a sum_k a^k / Gamma(z+k+1)."""
    z = np.asarray(z, dtype=np.float64)
    alpha = np.asarray(alpha, dtype=np.float64)

    def _one(zz, aa):
        if aa <= 0.0:
            return -np.inf
        la = math.log(aa)
        # accumulate the series in LOG space (running logsumexp): the
        # terms reach exp(~aa), which overflows linear float64 for
        # alpha >~ 710 well inside the CDF callers' domains
        ls = -np.inf
        tmax = -np.inf
        tprev = -np.inf
        for k in range(4096):
            t = k * la - math.lgamma(zz + k + 1.0)
            if ls == -np.inf:
                ls = t
            elif t > ls:
                ls = t + math.log1p(math.exp(ls - t))
            else:
                ls = ls + math.log1p(math.exp(t - ls))
            tmax = max(tmax, t)
            if k > 50 and tprev > t and (tmax - t) > 40.0:
                break
            tprev = t
        return zz * la + math.lgamma(zz) - aa + ls

    return np.vectorize(_one)(z, alpha)


def marcumq1(alpha, beta, iterations: int | None = None):
    """Marcum Q_1(alpha, beta) via the Bessel series
    Q_1(a,b) = exp(-(a^2+b^2)/2) sum_k (a/b)^k I_k(ab)
    (reference liquid_MarcumQ1f, src/math/src/math.c:95-123)."""
    alpha = np.asarray(alpha, dtype=np.float64)
    beta = np.asarray(beta, dtype=np.float64)
    # series in LOG space: term_k = k*ln(a/b) + ln I_k(ab); the
    # reference accumulates linearly in float32 (math.c:95-123), which
    # overflows for a >> b — the log form is the same sum, stable
    t0 = -0.5 * (alpha * alpha + beta * beta)
    beta_safe = np.where(beta > 0, beta, 1.0)
    with np.errstate(divide="ignore"):
        ln_ab_ratio = np.log(alpha) - np.log(beta_safe)
    a_mul_b = alpha * beta_safe
    if iterations is None:
        # I_k(ab) stays significant up to order k ~ ab; a fixed 64-term
        # cut gave percent-level CDF error for ab > ~400 (ADVICE r3)
        ab_max = float(np.max(a_mul_b)) if a_mul_b.size else 0.0
        iterations = max(64, int(ab_max + 10.0 * math.sqrt(ab_max + 1.0)) + 1)
    # ln I_k over ALL orders k with ONE shared log-factorial table:
    # calling lnbesseli per order rebuilds its own lgamma table per
    # call, which makes the host cost O((ab)^2) lgamma evaluations
    # (3.3 s at ab ~ 3500); the shared-table form is the identical sum.
    half = 0.5 * (float(np.max(a_mul_b)) if a_mul_b.size else 0.0)
    J = max(64, int(half + 9.0 * math.sqrt(half + 1.0)) + 8)
    # lgamma(n + 1) for n = 0 .. iterations + J via cumulative log sums
    lgt = np.concatenate([[0.0], np.cumsum(
        np.log(np.arange(1.0, iterations + J + 1.0)))])
    ab_safe = np.where(a_mul_b > 0, a_mul_b, 1.0)
    zl = np.log(0.5 * ab_safe).reshape(-1)          # [Z]
    js = np.arange(J, dtype=np.float64)[:, None]    # [J, 1]
    lnI = np.empty((iterations,) + zl.shape, np.float64)
    for k in range(iterations):
        t = (2.0 * js + k) * zl[None, :] - lgt[:J, None] \
            - lgt[k: k + J, None]
        tm = np.max(t, axis=0)
        lnI[k] = tm + np.log(np.sum(np.exp(t - tm), axis=0))
    lnI = lnI.reshape((iterations,) + a_mul_b.shape)
    lnI = np.where((a_mul_b == 0)[None],
                   np.where(np.arange(iterations).reshape(
                       (-1,) + (1,) * a_mul_b.ndim) == 0, 0.0, -np.inf),
                   lnI)                              # I_0(0)=1, I_k(0)=0
    ks_col = np.arange(iterations, dtype=np.float64).reshape(
        (-1,) + (1,) * ln_ab_ratio.ndim)
    with np.errstate(invalid="ignore"):
        kterm = np.where(ks_col == 0, 0.0, ks_col * ln_ab_ratio[None])
    terms = kterm + lnI
    terms = np.where(np.isnan(terms), -np.inf, terms)
    tmax = np.max(terms, axis=0)
    y = np.exp(tmax + np.log(np.sum(np.exp(terms - tmax), axis=0)) + t0)
    # Q1(a, 0) = 1 exactly (integral over an empty lower tail)
    return np.where(beta <= 0, 1.0, np.clip(y, 0.0, 1.0))


def lnbesseli(nu: float, z, iterations: int | None = None):
    """log I_nu(z) via the ascending series (reference math.bessel.c:41).
    Term count scales with the argument: the series' largest term sits
    near k ~ z/2, so a fixed cut silently truncates for large z."""
    z = np.asarray(z, dtype=np.float64)
    nz = z != 0
    if iterations is None:
        zmax = float(np.max(np.abs(z))) if z.size else 0.0
        half = 0.5 * zmax
        iterations = max(64, int(half + 9.0 * math.sqrt(half + 1.0)) + 8)
    zl = np.log(0.5 * np.where(nz, z, 1.0))
    # log-sum-exp over the series: linear accumulation of exp(t)
    # underflows for large order and overflows for z > ~1400
    ks = np.arange(iterations, dtype=np.float64)
    lg = np.array([math.lgamma(k + 1.0) + math.lgamma(nu + k + 1.0)
                   for k in range(iterations)])
    t = (2.0 * ks[:, None] * zl.reshape(1, -1)
         - lg[:, None])                       # [iterations, z.size]
    tmax = np.max(t, axis=0)
    lse = tmax + np.log(np.sum(np.exp(t - tmax), axis=0))
    out = np.where(nz, nu * zl + lse.reshape(z.shape), 0.0)
    if nu == 0.0:
        out = np.where(nz, out, 0.0)  # ln I_0(0) = 0
    return out


def besseli(nu: float, z):
    return np.exp(lnbesseli(nu, z))


def besseli0(z):
    """I_0(z), modified Bessel first kind order 0 (math.bessel.c:86)."""
    return besseli(0.0, z)


def sinc(x):
    """Normalized sinc sin(pi x)/(pi x) (matches reference sincf)."""
    return np.sinc(np.asarray(x, dtype=np.float64))


def qfunction(x):
    """Gaussian tail Q(x) = 0.5 erfc(x/sqrt 2) (reference math.c)."""
    return 0.5 * np.vectorize(math.erfc)(np.asarray(x, dtype=np.float64)
                                         / math.sqrt(2))
