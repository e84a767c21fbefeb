"""Numerically-controlled oscillator: block mixing with explicit phase
carry (`liquid_dsp_tpu/ops/nco.py`).

Reference analog: src/nco/src/nco.c — per-sample phase accumulator with a
256-entry sine table (LIQUID_NCO) or direct sinf/cosf (LIQUID_VCO).  The
phase recurrence theta[t] = theta0 + t*dphi is affine in the sample
index, so a whole block's oscillator is one closed-form vector; the
phase is wrapped to [-pi, pi) every block to keep float32 accuracy over
unbounded streams.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import Proc

__all__ = ["nco", "NCO", "mix_up", "mix_down", "nco_block_phases",
           "pll_step", "unwrap_phase", "unwrap_phase2"]

TWO_PI = 2.0 * math.pi


def _wrap(theta):
    return torch.remainder(theta + math.pi, TWO_PI) - math.pi


def nco_block_phases(theta0, dphi, T: int):
    """Phases for one block: theta0 + [0..T)*dphi (wrapped elementwise for
    f32 accuracy), plus the next theta0."""
    t = torch.arange(T, dtype=torch.float32, device=theta0.device)
    ph = theta0[..., None] + t * dphi if theta0.ndim else theta0 + t * dphi
    return _wrap(ph), _wrap(theta0 + T * dphi)


class NCO(Proc):
    """Block mixer: y = x * exp(-+j theta[t]) ('down' negates).

    carry: {'theta': phase per batch element, float32}.  table=True
    reproduces the reference's LIQUID_NCO 256-entry sine table (index =
    theta*256/(2 pi) + 512.5 masked to 8 bits, cos from index+64;
    reference nco.c compute_sincos_nco); table=False is LIQUID_VCO.
    """

    param_spec = {"dphi": "dphi", "sintab": "sintab"}

    def __init__(self, dphi: float, theta0: float = 0.0,
                 direction: str = "down", table: bool = False,
                 name: str = "nco"):
        super().__init__(name)
        self.theta0 = float(theta0)
        self.table = bool(table)
        self.sgn = -1.0 if direction == "down" else 1.0
        self._buffer("dphi", np.float32(dphi))
        self._buffer("sintab", np.sin(2.0 * np.pi * np.arange(256) / 256.0
                                      ).astype(np.float32))
        self.meta = {"kind": "nco", "dphi": float(dphi),
                     "theta0": self.theta0, "sgn": self.sgn,
                     "table": self.table}

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return {"theta": torch.full(batch_shape, self.theta0,
                                    dtype=torch.float32, device=device)}

    init_planar = init

    def _table_cos_sin(self, ph):
        phw = torch.remainder(ph + math.pi, TWO_PI) - math.pi
        idx = (phw * np.float32(40.743665).item() + 512.5
               ).to(torch.int32) & 0xFF
        return self.sintab[(idx + 64) & 0xFF], self.sintab[idx]

    def forward(self, carry, x):
        ph, theta_next = nco_block_phases(carry["theta"], self.dphi,
                                          x.shape[-1])
        if self.table:
            osc = torch.complex(*self._table_cos_sin(ph))
        else:
            osc = torch.complex(torch.cos(ph), torch.sin(ph))
        if self.sgn < 0:
            osc = torch.conj(osc)
        return x * osc, {"theta": theta_next}

    def advance(self, carry, n: int):
        """Closed-form carry after consuming n samples (time-shard support)."""
        return {"theta": _wrap(carry["theta"] + n * self.dphi)}

    def forward_planar(self, carry, x):
        # plane-native mix: 4 mult + 2 add on contiguous float planes;
        # 'down' folds into negating the sine
        r, i = x
        T = r.shape[-1]
        theta = carry["theta"]
        if self.table:
            ph, theta_next = nco_block_phases(theta, self.dphi, T)
            c_, s_ = self._table_cos_sin(ph)
        else:
            # angle addition: cos/sin of the [T] time ramp and of the
            # [batch] phase offsets separately, combined with 4 mults
            t = torch.arange(T, dtype=torch.float32, device=r.device)
            phit = _wrap(t * self.dphi)
            ct, st = torch.cos(phit), torch.sin(phit)
            cb, sb = torch.cos(theta), torch.sin(theta)
            if theta.ndim:
                cb, sb = cb[..., None], sb[..., None]
            c_ = cb * ct - sb * st
            s_ = sb * ct + cb * st
            theta_next = _wrap(theta + T * self.dphi)
        if self.sgn < 0:
            s_ = -s_
        return (r * c_ - i * s_, r * s_ + i * c_), {"theta": theta_next}


def nco(dphi: float, theta0: float = 0.0, direction: str = "down",
        table: bool = False, name: str = "nco") -> NCO:
    """Block mixer Proc (see `NCO`)."""
    return NCO(dphi, theta0, direction, table, name)


def _osc(x, dphi, theta0, sign):
    t = torch.arange(x.shape[-1], dtype=torch.float32, device=x.device)
    ph = theta0 + t * dphi
    return x * torch.complex(torch.cos(ph), sign * torch.sin(ph))


def mix_down(x, dphi, theta0=0.0):
    """One-shot block mix-down: y[t] = x[t] * exp(-j(theta0 + t*dphi))
    (reference nco_crcf_mix_block_down, nco.c:311)."""
    return _osc(x, dphi, theta0, -1.0)


def mix_up(x, dphi, theta0=0.0):
    """y[t] = x[t] * exp(+j(theta0 + t*dphi)) (nco.c:274)."""
    return _osc(x, dphi, theta0, 1.0)


def pll_step(theta, dphi, phase_error, bandwidth: float = 0.1):
    """Second-order PLL update (reference nco_crcf_pll_step, nco.c:220):
    frequency by alpha = bandwidth, phase by beta = sqrt(bandwidth), the
    square root taken in float32 as the JAX package takes it."""
    beta = float(torch.sqrt(torch.tensor(bandwidth, dtype=torch.float32)))
    dphi = dphi + bandwidth * phase_error
    theta = theta + beta * phase_error
    return theta, dphi


def unwrap_phase(theta):
    """Unwrap a phase array along the last axis so that successive samples
    never jump by more than pi (reference liquid_unwrap_phase,
    src/nco/src/nco.utilities.c:34-43), in closed form: the first
    differences wrapped into [-pi, pi), then one cumulative sum from
    theta[0]."""
    d = torch.diff(theta, dim=-1)
    d = torch.remainder(d + math.pi, TWO_PI) - math.pi
    return torch.cat([theta[..., :1],
                      theta[..., :1] + torch.cumsum(d, dim=-1)], dim=-1)


def unwrap_phase2(theta):
    """Bias-aware phase unwrap (reference liquid_unwrap_phase2,
    src/nco/src/nco.utilities.c:45-70): with dphi the mean first
    difference, each step's count of 2*pi corrections is
    floor((d - dphi + pi) / 2pi) of the raw difference, so one floor and
    one cumulative sum."""
    d = torch.diff(theta, dim=-1)
    n = theta.shape[-1]
    dphi = (theta[..., -1] - theta[..., 0])[..., None] / (n - 1)
    k = torch.floor((d - dphi + math.pi) / TWO_PI)
    return torch.cat([theta[..., :1],
                      theta[..., 1:] - TWO_PI * torch.cumsum(k, dim=-1)],
                     dim=-1)
