"""The remaining filter components (`liquid_dsp_tpu/ops/misc_filters.py`):
Farrow fractional delay, the IIR decimator and interpolator, linear
prediction.

Reference analogs:
  * firfarrow — src/filter/src/firfarrow.c:45+ (windowed-sinc fractional
    delay with polynomial-in-mu coefficients; the taps are evaluated for
    one mu, the filter the polynomial fit approximates).
  * iirdecim/iirinterp — src/filter/src/iirdecim.c / iirinterp.c (an IIR
    filter and down/up-sampling), on `ops/iir.py`'s filters and so on its
    kernels on the card.
  * lpc — src/filter/src/lpc.c (Levinson-Durbin recursion over the
    autocorrelation; host numpy).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import Proc
from .fir import firfilt
from .iir import iirfilt, iirfilt_sos

__all__ = ["firfarrow_taps", "firfarrow", "iirdecim", "iirinterp",
           "IIRDecim", "IIRInterp", "lpc", "autocorr_estimate"]


def firfarrow_taps(h_len: int, mu: float, fc: float = 0.45,
                   as_db: float = 60.0, npoly: int = 5) -> np.ndarray:
    """Fractional-delay filter taps of the reference Farrow structure
    (reference firfarrow.c genpoly/set_delay): each tap is a degree-npoly
    polynomial in mu least-squares fitted to windowed sinc samples at
    npoly+1 offsets, evaluated at -mu with the highest coefficient dropped
    (the reference's poly_val receives k=Q), then normalized by the DC
    response at mu=0."""
    if not (-1.0 <= mu <= 1.0):
        raise ValueError("fractional delay mu must be in [-1, 1]")
    from ..design.special import besseli0
    from ..design.windows import kaiser_beta_as

    Q = npoly
    beta = kaiser_beta_as(as_db)
    mu_vect = (np.arange(Q + 1) - Q) / Q + 0.5

    def kaiser_shift(n, N, mu_):
        t = n - (N - 1) / 2.0 + mu_
        r = 2.0 * t / N
        return besseli0(beta * np.sqrt(np.maximum(1 - r * r, 0.0))) / \
            besseli0(beta)

    P = np.zeros((h_len, Q + 1))
    for i in range(h_len):
        x = i - (h_len - 1) / 2.0
        hp = np.sinc(2.0 * fc * (x + mu_vect)) * \
            np.asarray([kaiser_shift(i, h_len, mv) for mv in mu_vect])
        P[i] = np.polynomial.polynomial.polyfit(mu_vect, hp, Q)

    def taps_at(mu_):
        # the reference's poly_val uses only the first Q coefficients
        powers = (-mu_) ** np.arange(Q)
        return P[:, :Q] @ powers

    gamma = 1.0 / np.sum(taps_at(0.0))
    return (gamma * taps_at(mu)).astype(np.float32)


def firfarrow(h_len: int = 19, mu: float = 0.0, fc: float = 0.45,
              as_db: float = 60.0, name: str = "firfarrow"):
    """Fractional-delay FIR Proc (a static mu per instance)."""
    return firfilt(firfarrow_taps(h_len, mu, fc, as_db), name=name)


def _prototype(m: int, b, a, order: int):
    """The reference's default prototype (an SOS Butterworth lowpass of
    the given order at fc = 0.5/m, iirdecim.c create_default) or b/a."""
    if b is None:
        from ..design.iirdes import iirdes_sos
        B, A = iirdes_sos("butter", order, 0.5 / m, ap_db=0.1, as_db=60.0)
        return iirfilt_sos(B, A)
    return iirfilt(b, a)


class _Resampled(Proc):
    """An IIR filter held as ``filt``; its params are the JAX package's
    (the filter's, under the same names)."""

    def __init__(self, m: int, b, a, order: int, name: str):
        super().__init__(name)
        self.m = int(m)
        self.filt = _prototype(self.m, b, a, order)
        self.param_spec = {k: "filt." + v
                           for k, v in self.filt.param_spec.items()}

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return self.filt.init(batch_shape=batch_shape, dtype=dtype,
                              device=device)


class IIRDecim(_Resampled):
    """IIR anti-alias filter then M:1 downsampling (reference iirdecim.c);
    the block length must be a multiple of M."""

    def __init__(self, m, b=None, a=None, order=4, name="iirdecim"):
        super().__init__(m, b, a, order, name)
        self.rate = (1, self.m)

    def forward(self, carry, x):
        T = x.shape[-1]
        if T % self.m:
            raise ValueError(f"iirdecim block length {T} not a multiple "
                             f"of {self.m}")
        y, c = self.filt(carry, x)
        return y[..., ::self.m], c


class IIRInterp(_Resampled):
    """1:M upsampling then an IIR image-reject filter (reference
    iirinterp.c, which applies no gain compensation)."""

    def __init__(self, m, b=None, a=None, order=4, name="iirinterp"):
        super().__init__(m, b, a, order, name)
        self.rate = (self.m, 1)

    def forward(self, carry, x):
        T = x.shape[-1]
        up = x.new_zeros(x.shape[:-1] + (T * self.m,))
        up[..., ::self.m] = x
        return self.filt(carry, up)


def iirdecim(m: int, b=None, a=None, order: int = 4,
             name: str = "iirdecim") -> IIRDecim:
    """IIR decimator by m (see `IIRDecim`); with b/a omitted, the
    reference's default SOS Butterworth prototype at fc = 0.5/m."""
    return IIRDecim(m, b, a, order, name)


def iirinterp(m: int, b=None, a=None, order: int = 4,
              name: str = "iirinterp") -> IIRInterp:
    """IIR interpolator by m (see `IIRInterp`); with b/a omitted, the
    reference's default SOS Butterworth prototype at fc = 0.5/m."""
    return IIRInterp(m, b, a, order, name)


def autocorr_estimate(x, p: int) -> np.ndarray:
    """Biased autocorrelation r[0..p]."""
    x = np.asarray(x)
    n = len(x)
    return np.asarray([np.sum(x[k:] * np.conj(x[: n - k])) / n
                       for k in range(p + 1)])


def lpc(x, p: int, return_reflection: bool = False):
    """Linear prediction via Levinson-Durbin (reference lpc.c
    liquid_lpc/levinson): returns (a, e) with a[0] = 1 and e the
    prediction error variance per order [p+1], from the UNNORMALIZED
    autocorrelation, as the reference.  return_reflection=True returns
    the reflection coefficients instead of the error variances."""
    x = np.asarray(x)
    n = len(x)
    # reference liquid_lpc: unnormalized autocorrelation (lpc.c:59-66)
    r = np.asarray([np.sum(x[k:] * np.conj(x[: n - k]))
                    for k in range(p + 1)]).real
    a = np.zeros(p + 1)
    g = np.zeros(p)
    e = np.zeros(p + 1)
    a[0] = 1.0
    err = r[0]
    e[0] = err
    if err <= 0:
        raise ValueError("lpc: signal has no energy")
    for i in range(1, p + 1):
        acc = r[i] + np.dot(a[1:i], r[1:i][::-1])
        k = -acc / err
        g[i - 1] = k
        # Levinson update: a'[j] = a[j] + k*a[i-j]
        a_new = a.copy()
        for j in range(1, i + 1):
            a_new[j] = a[j] + k * a[i - j]
        a = a_new
        err *= (1.0 - k * k)
        e[i] = err
    return (a, g) if return_reflection else (a, e)
