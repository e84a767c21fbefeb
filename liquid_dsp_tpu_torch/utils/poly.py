"""Polynomial operations, host numpy as in the JAX package
(`liquid_dsp_tpu/utils/poly.py`).

Reference analog (studied, not copied): reference src/math/src/poly.*.c —
evaluation, least-squares fit, Lagrange interpolation, root finding
(Bairstow in the reference; companion-matrix eigenvalues here), and
binomial expansion helpers.

Convention: coefficients ascending, p(x) = sum_k c[k] x^k (matches the
reference's polyf_val ordering).
"""
from __future__ import annotations

import numpy as np

__all__ = ["poly_val", "poly_fit", "poly_fit_lagrange", "poly_interp_lagrange",
           "poly_expandroots", "poly_findroots", "poly_mul"]


def poly_val(c, x):
    """p(x) with ascending coefficients (reference polyf_val)."""
    c = np.asarray(c)
    return np.polyval(c[::-1], np.asarray(x))


def poly_fit(x, y, order: int):
    """Least-squares fit; ascending coefficients (reference polyf_fit)."""
    return np.polyfit(np.asarray(x), np.asarray(y), order)[::-1].copy()


def poly_fit_lagrange(x, y):
    """Exact interpolating polynomial, ascending coefficients
    (reference polyf_fit_lagrange)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = len(x)
    c = np.zeros(n)
    for k in range(n):
        # basis polynomial prod_{j!=k} (t - x_j)/(x_k - x_j)
        basis = np.asarray([1.0])
        denom = 1.0
        for j in range(n):
            if j == k:
                continue
            basis = np.convolve(basis, [-x[j], 1.0])
            denom *= (x[k] - x[j])
        c[: len(basis)] += y[k] * basis / denom
    return c


def poly_interp_lagrange(x, y, x0):
    """Direct Lagrange interpolation at x0 (reference
    polyf_interp_lagrange)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    total = 0.0
    for k in range(len(x)):
        w = np.prod([(x0 - x[j]) / (x[k] - x[j])
                     for j in range(len(x)) if j != k])
        total += y[k] * w
    return total


def poly_expandroots(roots):
    """prod (x - r_k) -> ascending coefficients (reference
    polyf_expandroots)."""
    c = np.poly(np.asarray(roots))  # descending
    return c[::-1].copy()


def poly_findroots(c):
    """Roots of p(x) = sum c[k] x^k (reference polyf_findroots; uses the
    companion matrix rather than Bairstow iteration)."""
    c = np.asarray(c)
    return np.roots(c[::-1])


def poly_mul(a, b):
    """Polynomial product, ascending coefficients."""
    return np.convolve(np.asarray(a), np.asarray(b))
