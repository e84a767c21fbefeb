"""Vector primitives (`liquid_dsp_tpu/ops/dotprod.py`): dot products,
sums of squares, the ``vec_*`` element-wise helpers (reference
src/dotprod/src/dotprod.c, sumsq.c, src/vector/src/vector_*.c), and
valid-mode 1-D convolution on ``torch.nn.functional.conv1d``.

Torch's conv1d has no complex dtype, so complex operands are split into
real planes (3-mult Karatsuba for complex x complex), as the JAX package
does for XLA's real convolutions.  On a CUDA tensor conv1d goes through
cuDNN, which computes float32 in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False: set it False where the
result feeds an accuracy contract.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["dotprod", "sumsq", "vec_add", "vec_mul", "vec_norm", "vec_cexpj",
           "vec_init", "vec_addscalar", "vec_mulscalar", "vec_carg",
           "vec_abs", "vec_normalize", "conv1d_real", "conv1d"]


def dotprod(h, x):
    """y = sum_i h[i] * x[i] over the last axis (broadcasts leading axes;
    reference dotprod_{rrrf,crcf,cccf})."""
    return torch.sum(h * x, dim=-1)


def sumsq(x):
    """Sum of squared magnitudes, sum |x|^2 (reference sumsq.c)."""
    if x.is_complex():
        return torch.sum(x.real * x.real + x.imag * x.imag, dim=-1)
    return torch.sum(x * x, dim=-1)


def vec_add(x, y):
    return x + y


def vec_mul(x, y):
    return x * y


def vec_norm(x):
    """L2 norm over the last axis (reference vector_norm.c)."""
    return torch.sqrt(sumsq(x))


def vec_cexpj(theta):
    """exp(j*theta) elementwise (reference vector_trig.c)."""
    return torch.complex(torch.cos(theta), torch.sin(theta))


def vec_init(c, n: int, device=None):
    """Constant-filled vector (reference vector_init)."""
    return torch.full((n,), c, device=device)


def vec_addscalar(x, c):
    """x + c elementwise (reference vector_addscalar)."""
    return x + c


def vec_mulscalar(x, c):
    """x * c elementwise (reference vector_mulscalar)."""
    return x * c


def vec_carg(x):
    """Complex phase elementwise (reference vector_trig.c carg)."""
    return torch.angle(x)


def vec_abs(x):
    """Magnitude elementwise (reference vector_abs)."""
    return torch.abs(x)


def vec_normalize(x):
    """Scale to unit L2 norm over the last axis (reference
    vector_normalize)."""
    return x / torch.clamp(vec_norm(x), min=1e-30)[..., None]


def conv1d_real(x, h, stride: int = 1, lhs_dilation: int = 1):
    """Valid-mode real 1-D convolution over the last axis.

    x: [..., T] float; h: [L] float (convolution kernel, flipped here so
    y[t] = sum_j h[j] * x[t*stride - j + L - 1]).
    Returns [..., (T - L)//stride + 1].

    ``lhs_dilation`` is the JAX package's parameter; 1 is the only value
    it runs (its VALID padding has no transposed form), so any other
    value raises ValueError here too.
    """
    if lhs_dilation != 1:
        raise ValueError(
            f"lhs_dilation={lhs_dilation!r}: only 1 is supported; the JAX "
            "package refuses any other value too (lax.conv_general_dilated "
            "has no VALID padding for a transposed convolution)")
    batch_shape = x.shape[:-1]
    lhs = x.reshape(-1, 1, x.shape[-1])
    rhs = torch.flip(h, (-1,)).reshape(1, 1, -1).to(lhs.dtype)
    out = F.conv1d(lhs, rhs, stride=stride)
    return out.reshape(batch_shape + (out.shape[-1],))


def conv1d(x, h, stride: int = 1, lhs_dilation: int = 1):
    """Valid-mode 1-D convolution supporting any real/complex combination
    of input x and taps h, decomposed into real convolutions."""
    xc, hc = x.is_complex(), h.is_complex()
    if not xc and not hc:
        return conv1d_real(x, h, stride, lhs_dilation)
    if xc and not hc:
        return torch.complex(conv1d_real(x.real, h, stride, lhs_dilation),
                             conv1d_real(x.imag, h, stride, lhs_dilation))
    if not xc and hc:
        return torch.complex(conv1d_real(x, h.real, stride, lhs_dilation),
                             conv1d_real(x, h.imag, stride, lhs_dilation))
    # complex * complex: Karatsuba — 3 real convolutions instead of 4
    k1 = conv1d_real(x.real + x.imag, h.real, stride, lhs_dilation)
    k2 = conv1d_real(x.real, h.imag - h.real, stride, lhs_dilation)
    k3 = conv1d_real(x.imag, h.imag + h.real, stride, lhs_dilation)
    return torch.complex(k1 - k3, k1 + k2)
