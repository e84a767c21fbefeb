"""The digital down-converter of the `ddc` configurations in float64,
plain PyTorch: an NCO mix at dphi rad/sample, then each FIR of the
configuration in turn, then msresamp's halfband decimators (each keeps
the odd samples of its input, as resamp2 does) and their gain of 2^-k.
Unfused: the cascade as the configuration states it, with its designs
recomputed from the frozen copies in `designs`.  It imports nothing of
the program and runs on any device.

With `tf32=True` every FIR's operands, signal and taps, are rounded to
TF32 (10 mantissa bits, to nearest) before a float32 convolution: what a
tensor-core FIR computes with TF32 on, the benchmark's control for a
configuration that states float32 with TF32 off.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .designs import firdes_kaiser, msresamp_decim_stages

__all__ = ["DDCReference", "round_tf32"]


def round_tf32(t):
    """float32 `t` rounded to TF32's 10 mantissa bits (to nearest, ties
    away from zero), as float32."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class DDCReference:
    """The down-converter of one configuration (its "nco", "fir" and
    "msresamp" entries).  `halo`: the input samples before a block that
    its outputs depend on; `down`: the decimation."""

    def __init__(self, cfg: dict, tf32: bool = False):
        self.tf32 = tf32
        self.dphi = float(cfg["nco"]["dphi"])
        self.sign = -1.0 if cfg["nco"]["direction"] == "down" else 1.0
        self.firs = [firdes_kaiser(f["n"], f["fc"], f["as_db"])
                     for f in cfg["fir"]]
        self.decims, self.gain = msresamp_decim_stages(
            cfg["msresamp"]["rate"], cfg["msresamp"]["as_db"])
        self.down = 2 ** len(self.decims)
        self.halo = sum(len(h) - 1 for h in self.firs) + sum(
            (len(h) - 1) * 2 ** i for i, (h, _, _) in enumerate(self.decims))

    def __call__(self, xr, xi, start: int, T: int, dtype=torch.float64):
        """Output planes [B, T // down] of the T-sample block that starts
        at the absolute sample `start` (a multiple of `down`): xr, xi
        [B, H + T] hold the H >= halo samples before it (zeros before
        the stream's start), then the block.  Arithmetic in `dtype`."""
        N = xr.shape[-1]
        first = start - (N - T)
        n = torch.arange(N, device=xr.device, dtype=torch.float64) + first
        # the mixer's phase at each absolute sample, reduced in float64
        ph = torch.remainder(self.dphi * n, 2 * np.pi)
        c = torch.cos(ph).to(dtype)
        s = (self.sign * torch.sin(ph)).to(dtype)
        xr, xi = xr.to(dtype), xi.to(dtype)
        z = torch.stack([xr * c - xi * s, xr * s + xi * c])   # [2, B, N]
        for h in self.firs:
            z, first = self._fir(z, h, dtype), first + len(h) - 1
        for h, down, phase in self.decims:
            z, first = self._fir(z, h, dtype), first + len(h) - 1
            off = (phase - first) % down
            z, first = z[..., off::down], (first + off - phase) // down
        lo = start // self.down - first
        z = z[..., lo:lo + T // self.down] * self.gain
        return z[0], z[1]

    def _fir(self, z, h, dtype):
        """Causal FIR over [2, B, N] planes, its 'valid' outputs only."""
        w = torch.as_tensor(np.ascontiguousarray(h[::-1]), dtype=dtype,
                            device=z.device).view(1, 1, -1)
        if self.tf32:
            z, w = round_tf32(z), round_tf32(w)
        y = F.conv1d(z.reshape(-1, 1, z.shape[-1]), w)
        return y.view(z.shape[0], z.shape[1], -1)
