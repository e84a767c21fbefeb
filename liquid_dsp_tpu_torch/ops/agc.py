"""Automatic gain control (`liquid_dsp_tpu/ops/agc.py`).

Reference analog: agc_crcf/rrrf (reference src/agc/src/agc.c:37-123):
log-domain gain loop — one-pole smoothing of |y|^2, g *= exp(-alpha/2 *
log(y2')), clamp at 1e6, lock, rssi.

The per-sample feedback is sequential in time.  The loop needs only the
instantaneous power p = |x|^2 (y2 = g^2 p), so the per-sample gains come
from a real recurrence (`ops/kernels/agc_scan`: a CUDA kernel on the
card, its plain per-sample loop on the CPU), and the signal is scaled
elementwise outside it.  The JAX package's ``debug.tap("agc.gain")`` is
not carried over: `debug.py` is not ported yet (ROADMAP queue 1 item 5).
"""
from __future__ import annotations

import torch

from ..core import Proc
from .kernels.agc_scan import agc_scan as _gain_scan

__all__ = ["agc", "AGC", "agc_scan", "rssi_from_carry"]

AGC_DEFAULT_BW = 1e-2


def _gains(alpha: float, carry, p, locked: bool):
    """Gains [..., T] over power p [..., T] and the carry after them."""
    lead, T = p.shape[:-1], p.shape[-1]
    gains, g, y2p = _gain_scan(
        p.reshape(-1, T).to(torch.float32).contiguous(),
        carry["g"].reshape(-1).to(torch.float32),
        carry["y2_prime"].reshape(-1).to(torch.float32),
        alpha=alpha, locked=locked)
    shape = carry["g"].shape
    return (gains.reshape(lead + (T,)),
            {"g": g.reshape(shape), "y2_prime": y2p.reshape(shape)})


def agc_scan(alpha, carry, x, locked: bool = False):
    """Run the AGC over a block of x [..., T] (real or complex) with carry
    {g, y2_prime}; returns (x * gains, carry')."""
    p = x.real * x.real + x.imag * x.imag if x.is_complex() else x * x
    s, c = _gains(float(alpha), carry, p, locked)
    return x * s.to(x.dtype), c


class AGC(Proc):
    """Streaming AGC: output normalized to unit energy.  carry: {g: gain,
    y2_prime: smoothed output energy} (reference agc.c:37-51).  Runs on
    (re, im) planes too (`planar`)."""

    def __init__(self, bandwidth: float, locked: bool, name: str):
        super().__init__(name)
        if bandwidth < 0:
            raise ValueError("agc bandwidth must be positive")
        self.alpha = float(bandwidth)
        self.locked = bool(locked)

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return {"g": torch.ones(batch_shape, dtype=torch.float32,
                                device=device),
                "y2_prime": torch.ones(batch_shape, dtype=torch.float32,
                                       device=device)}

    def init_planar(self, batch_shape=(), dtype=torch.float32, device=None):
        return self.init(batch_shape=batch_shape, device=device)

    def forward(self, carry, x):
        return agc_scan(self.alpha, carry, x, locked=self.locked)

    def forward_planar(self, carry, x):
        r, i = x
        s, c = _gains(self.alpha, carry, r * r + i * i, self.locked)
        return (r * s, i * s), c


def agc(bandwidth: float = AGC_DEFAULT_BW, locked: bool = False,
        name: str = "agc") -> AGC:
    """Streaming AGC Proc (see `AGC`)."""
    return AGC(bandwidth, locked, name)


def rssi_from_carry(carry):
    """Received signal strength [dB] (reference agc_crcf_get_rssi):
    rssi = -20 log10(g)."""
    return -20.0 * torch.log10(carry["g"].clamp(min=1e-16))
