"""Random distributions and the data scrambler
(`liquid_dsp_tpu/utils/random.py`).

Reference analogs: src/random/src/ (randf/randnf/randexpf/randweibf/
randgammaf/randnakmf/randricekf with their pdf/cdf; API
include/liquid.h:6296-6348) and scramble.c:33-59 (a fixed 4-byte xor
mask cycle).

The samplers and densities are host numpy (test and data generation);
`crandn` and `awgn` draw on a tensor's device from an explicit
``torch.Generator`` (the JAX package's jax_crandn / jax_awgn take a key).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "randf", "randnf", "crandnf", "randexpf", "randweibf", "randgammaf",
    "randnakmf", "randricekf",
    "randf_pdf", "randf_cdf", "randnf_pdf", "randnf_cdf",
    "randexpf_pdf", "randexpf_cdf", "randweibf_pdf", "randweibf_cdf",
    "randgammaf_pdf", "randgammaf_cdf", "randnakmf_pdf", "randnakmf_cdf",
    "randricekf_pdf", "randricekf_cdf",
    "scramble_data", "unscramble_data", "unscramble_data_soft",
    "awgn", "crandn",
]

_MASKS = np.asarray([0xB4, 0x6A, 0x8B, 0xC5], np.uint8)  # scramble.c masks


def scramble_data(data) -> np.ndarray:
    """XOR with the cyclic 4-byte mask (reference scramble_data)."""
    data = np.asarray(data, np.uint8)
    mask = np.resize(_MASKS, data.shape)
    return data ^ mask


def unscramble_data(data) -> np.ndarray:
    """Self-inverse (reference unscramble_data calls scramble_data)."""
    return scramble_data(data)


def unscramble_data_soft(soft_bits) -> np.ndarray:
    """Soft-bit descrambler (reference scramble.c unscramble_data_soft):
    input is one soft bit (0..255 LLR byte) per data bit; wherever the
    cyclic mask has a 1 bit, the soft bit is flipped as 255 - x."""
    x = np.asarray(soft_bits, np.uint8).copy()
    n_bytes = x.shape[-1] // 8
    masks = np.resize(_MASKS, n_bytes)
    flip = np.unpackbits(masks).astype(bool)
    x[..., :n_bytes * 8][..., flip] = 255 - x[..., :n_bytes * 8][..., flip]
    return x


# --- numpy samplers (Box-Muller etc., matching reference definitions) ---


def randf(rng=None, size=None):
    """Uniform [0, 1) (reference randf)."""
    rng = rng or np.random.default_rng()
    return rng.random(size).astype(np.float32)


def randnf(rng=None, size=None):
    rng = rng or np.random.default_rng()
    return rng.standard_normal(size).astype(np.float32)


def crandnf(rng=None, size=None):
    rng = rng or np.random.default_rng()
    return (rng.standard_normal(size) + 1j * rng.standard_normal(size)
            ).astype(np.complex64)


def randexpf(lam: float, rng=None, size=None):
    """Exponential(lambda) (reference randexpf: -ln(1-u)/lambda)."""
    if lam <= 0:
        raise ValueError("exponential rate must be positive")
    rng = rng or np.random.default_rng()
    return (-np.log(1 - rng.uniform(size=size)) / lam).astype(np.float32)


def randweibf(alpha: float, beta: float, gamma: float = 0.0,
              rng=None, size=None):
    """Weibull (reference randweibf parameterization)."""
    rng = rng or np.random.default_rng()
    u = rng.uniform(size=size)
    return (gamma + beta * (-np.log(1 - u)) ** (1.0 / alpha)
            ).astype(np.float32)


def randgammaf(alpha: float, beta: float, rng=None, size=None):
    rng = rng or np.random.default_rng()
    return (rng.gamma(alpha, beta, size=size)).astype(np.float32)


def randnakmf(m: float, omega: float, rng=None, size=None):
    """Nakagami-m (reference randnakmf: sqrt of gamma variate)."""
    rng = rng or np.random.default_rng()
    g = rng.gamma(m, omega / m, size=size)
    return np.sqrt(g).astype(np.float32)


def randricekf(K: float, omega: float, rng=None, size=None):
    """Rice-K fading amplitude (reference randricekf)."""
    rng = rng or np.random.default_rng()
    s = np.sqrt(K * omega / (K + 1))
    sig = np.sqrt(0.5 * omega / (K + 1))
    x = sig * rng.standard_normal(size) + s
    y = sig * rng.standard_normal(size)
    return np.sqrt(x * x + y * y).astype(np.float32)


def randnf_pdf(x, eta=0.0, sig=1.0):
    return (np.exp(-((x - eta) ** 2) / (2 * sig ** 2)) /
            (sig * np.sqrt(2 * np.pi)))


def randexpf_pdf(x, lam):
    x = np.asarray(x)
    return np.where(x < 0, 0.0, lam * np.exp(-lam * x))


def randweibf_pdf(x, alpha, beta, gamma=0.0):
    x = np.asarray(x)
    t = x - gamma
    return np.where(
        t < 0, 0.0,
        (alpha / beta) * (t / beta) ** (alpha - 1) *
        np.exp(-((t / beta) ** alpha)))


# --- cumulative distributions (reference rand*.c *_cdf functions) ---


def randf_pdf(x):
    """Uniform [0,1] density (reference randf_pdf)."""
    x = np.asarray(x)
    return np.where((x < 0) | (x > 1), 0.0, 1.0)


def randf_cdf(x):
    return np.clip(np.asarray(x, np.float64), 0.0, 1.0)


def randnf_cdf(x, eta=0.0, sig=1.0):
    """Gaussian CDF (reference randn.c:101: 0.5 + 0.5 erf(x'/sqrt2))."""
    import math as _m
    x = np.asarray(x, np.float64)
    return 0.5 + 0.5 * np.vectorize(_m.erf)((x - eta) / (sig * np.sqrt(2.0)))


def randexpf_cdf(x, lam):
    x = np.asarray(x, np.float64)
    return np.where(x < 0, 0.0, 1.0 - np.exp(-lam * x))


def randweibf_cdf(x, alpha, beta, gamma=0.0):
    t = np.asarray(x, np.float64) - gamma
    return np.where(t < 0, 0.0, 1.0 - np.exp(-((t / beta) ** alpha)))


def randgammaf_pdf(x, alpha, beta):
    """Gamma density (reference randgamma.c:74-104: lgamma form)."""
    from ..design.special import lngamma
    x = np.asarray(x, np.float64)
    xp = np.where(x > 0, x, 1.0)
    val = np.exp((alpha - 1) * np.log(xp) - xp / beta -
                 lngamma(alpha) - alpha * np.log(beta))
    return np.where(x <= 0, 0.0, val)


def randgammaf_cdf(x, alpha, beta):
    """Gamma CDF = lowergamma(alpha, x/beta)/Gamma(alpha)
    (reference randgamma.c:106-123)."""
    from ..design.special import lnlowergamma, lngamma
    x = np.asarray(x, np.float64)
    xp = np.where(x > 0, x, 1.0)
    val = np.exp(lnlowergamma(alpha, xp / beta) - lngamma(alpha))
    return np.clip(np.where(x <= 0, 0.0, val), 0.0, 1.0)


def randnakmf_pdf(x, m, omega):
    """Nakagami-m density (reference randnakm.c:62-89)."""
    from ..design.special import lngamma
    if m < 0.5 or omega <= 0:
        raise ValueError("m >= 0.5 and omega > 0 required")
    x = np.asarray(x, np.float64)
    xp = np.where(x > 0, x, 1.0)
    val = 2.0 * np.exp(-lngamma(m) + m * np.log(m / omega) +
                       (2 * m - 1) * np.log(xp) - (m / omega) * xp * xp)
    return np.where(x <= 0, 0.0, val)


def randnakmf_cdf(x, m, omega):
    """Nakagami-m CDF (reference randnakm.c:92-110: incomplete gamma)."""
    from ..design.special import lngamma, lnlowergamma
    if m < 0.5 or omega <= 0:
        raise ValueError("m >= 0.5 and omega > 0 required")
    x = np.asarray(x, np.float64)
    xp = np.where(x > 0, x, 1.0)
    val = np.exp(lnlowergamma(m, xp * xp * m / omega) - lngamma(m))
    return np.clip(np.where(x <= 0, 0.0, val), 0.0, 1.0)


def randricekf_pdf(x, K, omega):
    """Rice-K density (reference randricek.c:56-81: log-Bessel form)."""
    from ..design.special import lnbesseli
    x = np.asarray(x, np.float64)
    s = np.sqrt(omega * K / (K + 1))
    sig2 = 0.5 * omega / (K + 1)
    xp = np.where(x > 0, x, 1.0)
    t = xp * xp + s * s
    val = np.exp(np.log(xp) - np.log(sig2) - t / (2 * sig2) +
                 lnbesseli(0.0, xp * s / sig2))
    # reference zeroes the extreme tail (x*s/sig2 > 80) to avoid overflow
    return np.where((x <= 0) | (xp * s / sig2 > 80.0), 0.0, val)


def randricekf_cdf(x, K, omega):
    """Rice-K CDF = 1 - MarcumQ1(s/sig, x/sig)
    (reference randricek.c:83-113 incl. the alpha/beta guard bands)."""
    from ..design.special import marcumq1
    x = np.asarray(x, np.float64)
    s = np.sqrt(omega * K / (K + 1))
    sig = np.sqrt(0.5 * omega / (K + 1))
    xp = np.where(x > 0, x, 1.0)
    alpha = s / sig
    beta = xp / sig
    F = np.clip(1.0 - marcumq1(alpha, beta), 0.0, 1.0)
    F = np.where(alpha / beta > 3.0, 0.0, F)
    F = np.where(beta / alpha > 3.0, 1.0, F)
    return np.where(x <= 0, 0.0, F)


# --- torch samplers for channel models on the device ---


def crandn(generator: torch.Generator, shape, device=None) -> torch.Tensor:
    """Complex64 standard normal per component (real, then imaginary
    draws from `generator`), on `generator`'s device unless given."""
    dev = generator.device if device is None else device
    re = torch.randn(shape, generator=generator, device=dev)
    im = torch.randn(shape, generator=generator, device=dev)
    return torch.complex(re, im)


def awgn(generator: torch.Generator, x: torch.Tensor,
         nstd: float) -> torch.Tensor:
    """x plus complex white noise of total standard deviation `nstd`."""
    return x + (nstd / np.sqrt(2)) * crandn(generator, x.shape, x.device)
