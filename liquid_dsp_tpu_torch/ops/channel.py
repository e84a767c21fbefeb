"""Channel impairment model (`liquid_dsp_tpu/ops/channel.py`): AWGN,
carrier offset, multipath, shadowing.

Reference analog: channel_cccf (reference src/channel/src/channel.c:
33-296): composable impairments — AWGN (noise floor + SNR), carrier
frequency/phase offset, a multipath FIR, log-normal shadowing through a
one-pole lowpass.

One Proc applies the whole block of impairments at once.  Its carry holds
the mixer phase ``theta``, the multipath filter's input tail ``mp_tail``
and the shadowing filter's output ``sh_state``, with the JAX package's
shapes, and ``key``: the state of the ``torch.Generator`` that draws the
block's randomness (a uint8 tensor on the host, `Generator.get_state`),
where the JAX package keeps its PRNG key.  Each call makes a generator on
the input's device, sets that state, draws the shadowing's white noise
and then the AWGN (`utils/random.py`'s ``crandn``), and returns the
generator's new state; ``init`` seeds it from ``seed``.  So a stream is
reproducible from its seed and block to block, on one device type (CPU
and CUDA generators draw different numbers; tests hand both packages the
same noise through numpy).

The shadowing recurrence s = beta*s + sqrt(1-beta^2)*w is the one-section
filter b = [sqrt(1-beta^2), 0], a = [1, -beta] on `ops/kernels/iir_scan`
(the kernel on the card): its DF2T state is beta*s, and its output s.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import Proc
from ..utils.random import crandn
from .fir import fir_apply_auto
from .kernels.iir_scan import iir_scan

__all__ = ["channel", "Channel"]


class Channel(Proc):
    """Channel Proc (reference channel_cccf_create + add_*); see `channel`.
    The multipath taps are the buffer "h" (the JAX package's params)."""

    def __init__(self, snr_db=None, noise_floor_db=-60.0, dphi=0.0, phi=0.0,
                 multipath_taps=None, shadowing_std=0.0, shadowing_fd=0.1,
                 seed=0, name="channel"):
        super().__init__(name)
        self.has_h = multipath_taps is not None
        if self.has_h:
            self._buffer("h", np.asarray(multipath_taps, np.complex64))
            self.param_spec = {"h": "h"}
        else:
            self.param_spec = {}
        self.snr_db, self.dphi, self.phi = snr_db, float(dphi), float(phi)
        self.nstd = 10.0 ** (noise_floor_db / 20.0)
        self.gamma = (10.0 ** ((noise_floor_db + snr_db) / 20.0)
                      if snr_db is not None else 1.0)
        self.shadowing_std = float(shadowing_std)
        self.seed = int(seed)
        # one-pole shadowing filter coefficient from the Doppler (channel.c)
        self.beta_sh = (float(np.exp(-2 * np.pi * shadowing_fd))
                        if shadowing_std else 0.0)
        g = np.sqrt(1 - self.beta_sh ** 2)
        self.register_buffer("sh_b", torch.tensor(
            [[g, 0.0]], dtype=torch.float32), persistent=False)
        self.register_buffer("sh_a", torch.tensor(
            [[1.0, -self.beta_sh]], dtype=torch.float32), persistent=False)

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        batch = tuple(batch_shape)
        gen = torch.Generator(device=device or "cpu").manual_seed(self.seed)
        c = {"key": gen.get_state(),
             "theta": torch.zeros(batch, dtype=torch.float32, device=device)}
        if self.has_h:
            c["mp_tail"] = torch.zeros(batch + (self.h.shape[-1] - 1,),
                                       dtype=dtype, device=device)
        if self.shadowing_std:
            c["sh_state"] = torch.zeros(batch, dtype=torch.float32,
                                        device=device)
        return c

    def shadow(self, sh_state, w):
        """The shadowing filter's outputs s [..., T] over white noise w
        [..., T] from the last output sh_state [...]: returns (s, s[..., -1])."""
        batch, T = w.shape[:-1], w.shape[-1]
        st = (sh_state * np.float32(self.beta_sh)).reshape(-1, 1, 1)
        s, _ = iir_scan(w.reshape(-1, T).contiguous(), self.sh_b, self.sh_a,
                        st)
        s = s.reshape(batch + (T,))
        return s, s[..., -1]

    def forward(self, carry, x):
        T = x.shape[-1]
        y = x.to(torch.complex64)
        new = dict(carry)
        gen = torch.Generator(device=x.device)
        gen.set_state(carry["key"])
        if self.has_h:
            y, new["mp_tail"] = fir_apply_auto(
                self.h, carry["mp_tail"].to(y.dtype), y)
        # shadowing: a slow log-normal gain fluctuation
        if self.shadowing_std:
            w = torch.randn(y.shape, generator=gen, device=x.device)
            s, new["sh_state"] = self.shadow(carry["sh_state"], w)
            y = y * (10.0 ** (self.shadowing_std * s / 20.0)).to(y.dtype)
        # carrier offset
        if self.dphi != 0.0 or self.phi != 0.0:
            t = torch.arange(T, dtype=torch.float32, device=x.device)
            th = carry["theta"][..., None] + self.dphi * t + self.phi
            y = y * torch.complex(torch.cos(th), torch.sin(th))
            new["theta"] = torch.remainder(carry["theta"] + self.dphi * T,
                                           2 * np.pi)
        # signal gain + AWGN: noise power nstd^2 in all (reference cawgn:
        # nstd*crandn/sqrt2)
        if self.snr_db is not None:
            y = self.gamma * y + (self.nstd / np.sqrt(2)) * crandn(
                gen, y.shape, x.device)
        new["key"] = gen.get_state()
        return y, new


def channel(snr_db: float | None = None, noise_floor_db: float = -60.0,
            dphi: float = 0.0, phi: float = 0.0,
            multipath_taps=None, shadowing_std: float = 0.0,
            shadowing_fd: float = 0.1, seed: int = 0,
            name: str = "channel") -> Channel:
    """Build a channel Proc (reference channel_cccf_create + add_*).

    snr_db: if set, adds AWGN with gain gamma = 10^((noise_floor+snr)/20)
    applied to the signal and noise at the floor level (reference
    channel.c _add_awgn:136)."""
    return Channel(snr_db, noise_floor_db, dphi, phi, multipath_taps,
                   shadowing_std, shadowing_fd, seed, name)
