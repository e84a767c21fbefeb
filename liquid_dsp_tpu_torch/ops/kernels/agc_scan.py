"""The AGC gain recurrence over instantaneous power: a Hopper kernel for
the JAX package's ``lax.scan`` in `liquid_dsp_tpu/ops/agc.py:39-50`
(`agc_scan` and the agc Proc's `planar_apply`).  The JAX package has no
Pallas kernel here; PyTorch has no device-side scan, and a Python loop
would launch a few hundred ops per sample.

`agc_scan` launches the CUDA kernel ``csrc/agc_scan.cu`` on a CUDA tensor
and runs `agc_scan_reference`, the same loop in plain PyTorch, on a CPU
tensor; any other device raises.  Per channel and sample, in the JAX
package's order (the scaling x * g stays outside, as there):

    y2p = (1-alpha)*y2p + (alpha*(g*g))*p
    g_out[t] = g
    g = y2p > 1e-6 ? g * exp((-alpha/2) * log(y2p)) : g;  g = min(g, 1e6)

(the gain update skipped when locked).  The constants 1-alpha, alpha and
-alpha/2 are formed in double and rounded to float32 once, as the JAX
package's weak-typed Python constants are.

The kernel is one dependent chain per channel, and the log and the exp
are most of it, so both are this module's own: `agc_log` and `agc_exp`,
branch-free float32 polynomials (Estrin's scheme) written for the loop's
domain, each below 1 ulp of float32 against float64
(tests/test_torch_agc_codebook_identities.py).  The kernel and the plain
version take the same operations in the same order, each rounded once:
`*` and `+` where the kernel takes ``__fmul_rn`` / ``__fadd_rn``,
`fma32` (exact) where it takes ``__fmaf_rn``, integer operations on the
float's bits elsewhere.  So on the card the kernel equals the plain
version bit for bit, and the plain version stays within 1e-5 of the JAX
package, whose exp and log are the library's.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .symsync_scan import fma32

__all__ = ["agc_consts", "agc_log", "agc_exp", "agc_scan",
           "agc_scan_reference"]


def _f32(v) -> float:
    return float(np.float32(v))


# log(1+f) = f + f^2 P(f) on f in [-1/3, 1/3): P's coefficients, low order
# first (Chebyshev interpolation of (log1p(f) - f)/f^2, rounded to float32)
LOG_C = tuple(_f32(v) for v in (
    -0.5, 0.33333272, -0.24999945, 0.20007233, -0.16673316, 0.14055812,
    -0.12288722, 0.13748309, -0.124222))
# exp(r) = 1 + r + r^2 Q(r) on |r| <= ln(2)/2: Q's coefficients
EXP_C = tuple(_f32(v) for v in (
    5.0000000e-01, 1.6666667e-01, 4.1666456e-02, 8.3333105e-03,
    1.3934541e-03, 1.9891981e-04))
TWO_THIRDS_BITS = 0x3F2AAAAB     # float32 2/3: mantissas land in [2/3, 4/3)
LN2 = _f32(np.log(2.0))
LOG2E = _f32(1.0 / np.log(2.0))
LN2_HI = 0.693145751953125       # 0x3F317200: j * LN2_HI is exact, |j| < 2^8
LN2_LO = _f32(np.log(2.0) - LN2_HI)
ROUND_MAGIC = 12582912.0         # 1.5 * 2^23: x + MAGIC - MAGIC = rint(x)


def agc_consts(alpha: float):
    """(1-alpha, alpha, -alpha/2) rounded to float32 once."""
    return (_f32(1.0 - alpha), _f32(alpha), _f32(-0.5 * alpha))


@functools.lru_cache(maxsize=None)
def _const_on(v: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """v as a 0-dim float32 tensor on `like`'s device, made once per value
    and device (the loop asks for a dozen per sample); never written to."""
    return _const_on(v, like.device)


def agc_log(y: torch.Tensor) -> torch.Tensor:
    """Natural log of positive normal float32 y, the kernel's operations
    one by one: y = 2^e m with m in [2/3, 4/3) from the float's bits,
    f = m - 1 (exact), log(y) = e ln2 + f + f^2 P(f).  Below 1 ulp against
    float64; whatever comes out for zero, subnormal or negative y is not
    used by the loop."""
    ix = y.view(torch.int32)
    e = (ix - TWO_THIRDS_BITS) >> 23
    f = (ix - e * (1 << 23)).view(torch.float32) - 1.0
    c = LOG_C
    f2 = f * f
    f4 = f2 * f2
    a0 = c[0] + c[1] * f
    a1 = c[2] + c[3] * f
    a2 = c[4] + c[5] * f
    a3 = fma32(f2, _const(c[8], y), c[6] + c[7] * f)
    b0 = fma32(f2, a1, a0)
    b1 = fma32(f2, a3, a2)
    r = fma32(f2, fma32(f4, b1, b0), f)
    return fma32(e.to(torch.float32), _const(LN2, y), r)


def agc_exp(x: torch.Tensor, t: torch.Tensor | None = None) -> torch.Tensor:
    """exp of float32 x with |x| < 87, the kernel's operations one by
    one: j = rint(x log2(e)) by the magic-number add, r = x - j ln2 in two
    steps, exp(x) = 2^j (1 + r + r^2 Q(r)).  Below 1 ulp against float64.
    t is x log2(e) + ROUND_MAGIC rounded once; the loop forms it from the
    log, beside x."""
    if t is None:
        t = fma32(x, _const(LOG2E, x), _const(ROUND_MAGIC, x))
    jf = t - ROUND_MAGIC
    r = fma32(jf, _const(-LN2_HI, x), x)
    r = fma32(jf, _const(-LN2_LO, x), r)
    d = EXP_C
    r2 = r * r
    r4 = r2 * r2
    q0 = d[0] + d[1] * r
    q1 = d[2] + d[3] * r
    q2 = d[4] + d[5] * r
    s = fma32(r2, fma32(r4, q2, fma32(r2, q1, q0)), r)
    scale = ((jf.to(torch.int32) + 127) << 23).view(torch.float32)
    return (1.0 + s) * scale


def agc_scan_reference(p, g, y2p, *, alpha: float, locked: bool = False):
    """Plain PyTorch version: a loop over the T samples on [B] tensors.
    p [B, T] f32, g and y2p [B] f32 -> (gains [B, T], g', y2p').  The guard
    y2p > 1e-6 picks the exponent's factor, -alpha/2 or 0: with 0 the exp
    is exactly 1 and g stays, as in the kernel."""
    c1, ca, ch = agc_consts(alpha)
    chl = float(np.float32(ch) * np.float32(LOG2E))
    zero, magic = _const(0.0, p), _const(ROUND_MAGIC, p)
    ch_t, chl_t = _const(ch, p), _const(chl, p)
    gains = []
    for t in range(p.shape[-1]):
        y2p = c1 * y2p + (ca * (g * g)) * p[:, t]
        gains.append(g)
        if not locked:
            on = y2p > 1e-6
            lg = agc_log(y2p)
            x = lg * torch.where(on, ch_t, zero)
            g = g * agc_exp(x, fma32(lg, torch.where(on, chl_t, zero), magic))
            g = g.clamp(max=1e6)
    if not gains:
        return p.new_zeros(p.shape), g, y2p
    return torch.stack(gains, dim=-1), g, y2p


def _check(p, g, y2p):
    if p.dim() != 2 or g.shape != (p.shape[0],) or y2p.shape != g.shape:
        raise ValueError(f"agc_scan takes p [B, T], g [B] and y2p [B], got "
                         f"{tuple(p.shape)}, {tuple(g.shape)} and "
                         f"{tuple(y2p.shape)}")
    if any(t.dtype != torch.float32 for t in (p, g, y2p)):
        raise ValueError(f"agc_scan takes float32 tensors, got {p.dtype}, "
                         f"{g.dtype} and {y2p.dtype}")
    if g.device != p.device or y2p.device != p.device:
        raise ValueError(f"agc_scan: all tensors must be on one device, got "
                         f"{p.device}, {g.device} and {y2p.device}")
    if not p.is_contiguous():
        raise ValueError("agc_scan takes a contiguous p")


def agc_scan(p, g, y2p, *, alpha: float, locked: bool = False):
    """Per-sample gains of the AGC loop over power p [B, T] from the
    carry (g, y2p) [B]: returns (gains [B, T] f32, g', y2p').

    A CUDA tensor launches the kernel (and counts the launch in
    ``agc_scan.launches``); a CPU tensor runs the plain version.
    """
    _check(p, g, y2p)
    if p.device.type == "cpu":
        return agc_scan_reference(p, g, y2p, alpha=alpha, locked=locked)
    if p.device.type != "cuda":
        raise ValueError(f"agc_scan runs on CUDA (kernel) or CPU (plain "
                         f"version) tensors, got device {p.device}")
    B, T = p.shape
    gains = torch.empty_like(p)
    g2 = g.clone(memory_format=torch.contiguous_format)
    y2 = y2p.clone(memory_format=torch.contiguous_format)
    if B == 0 or T == 0:
        return gains, g2, y2
    from .build import load_library
    lib = load_library()
    c1, ca, ch = agc_consts(alpha)
    with torch.cuda.device(p.device):
        rc = lib.agc_scan_launch(
            p.data_ptr(), g2.data_ptr(), y2.data_ptr(), gains.data_ptr(), B,
            T, int(bool(locked)), c1, ca, ch,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"agc_scan kernel launch failed: CUDA error {rc}")
    agc_scan.launches += 1
    return gains, g2, y2


agc_scan.launches = 0
