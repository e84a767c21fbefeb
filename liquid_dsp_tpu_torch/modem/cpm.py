"""Continuous-phase modems: M-ary FSK, GMSK, CPFSK
(`liquid_dsp_tpu/modem/cpm.py`).

Reference analogs:
  * fskmod/fskdem   — src/modem/src/fskmod.c:130-145 (a phase-continuous
                      tone per symbol), fskdem.c:160-210 (K-point FFT, the
                      peak over the tones' bins; K in [k, max(16, 4k)]
                      with the least fractional bin error, fskdem.c:93-118).
  * gmskmod/gmskdem — gmskmod.c:75-140 (NRZ +-1/k -> GMSK pulse, phase
                      integration, exp), gmskdem.c:196-247 (phase
                      derivative, matched filter, k:1 decimation, slice).
  * cpfskmod/cpfskdem — cpfskmod.c:104-250 (square / rcos-full /
                      rcos-partial / gmsk pulses, area-normalized and
                      scaled by pi*h; NRZ v = 2s-M+1), cpfskdem.c.

Every modem is a `Proc`: symbols [..., N] in a block, pulse shaping one
FIR over the zero-stuffed symbols (`fir_apply_auto`: the banded matmul on
the card), phase integration one float32 cumsum, the carrier one
exponential; the carries (phase, filter tail, last sample) have the JAX
package's keys, shapes and dtypes.  The FSK demodulator takes one
batched ``torch.fft`` of every symbol's k samples.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import Proc
from ..design.firdes import firdes_gmskrx, firdes_gmsktx
from ..ops.fir import fir_apply_auto

__all__ = ["fsk_modulator", "fsk_demodulator", "fsk_fft_size",
           "fsk_frequency_error", "gmsk_modulator", "gmsk_demodulator",
           "cpfsk_pulse", "cpfsk_modulator", "cpfsk_demodulator"]

_TWO_PI = 2 * np.pi


def _cexp(theta: torch.Tensor) -> torch.Tensor:
    """exp(j*theta) as complex64."""
    return torch.complex(torch.cos(theta), torch.sin(theta))


def _phase_diff(prev_last: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """angle(conj(x[t-1]) * x[t] + 1e-20) with x[-1] = prev_last: the
    per-sample instantaneous frequency of the phase-derivative demods."""
    prev = torch.cat([prev_last[..., None], x[..., :-1]], dim=-1)
    return torch.angle(prev.conj() * x + 1e-20)


# ---------------------------------------------------------------------------
# M-ary FSK


def fsk_fft_size(m: int, k: int, bandwidth: float) -> int:
    """FFT size whose bin grid best matches the tone spacing
    (reference fskdem.c:93-118)."""
    M2 = 0.5 * ((1 << m) - 1)
    df = bandwidth / M2
    best_K, err_min = k, np.inf
    for K_hat in range(k, max(16, 4 * k) + 1):
        v = 0.5 * df * K_hat
        err = abs(round(v) - v)
        if err < err_min:
            best_K, err_min = K_hat, err
        if err < 1e-6:
            break
    return best_K


def _fsk_maps(m: int, k: int, bandwidth: float):
    """(K, each tone's FFT bin [M] int64; reference fskdem.c:120-134)."""
    M = 1 << m
    M2 = 0.5 * (M - 1)
    K = fsk_fft_size(m, k, bandwidth)
    idx = np.round((np.arange(M) - M2) * bandwidth / M2 * K)
    return K, (np.where(idx < 0, idx + K, idx) % K).astype(np.int64)


class FSKModulator(Proc):
    """See `fsk_modulator`."""

    param_spec = {"dphi": "dphi"}

    def __init__(self, m, k, bandwidth, name):
        super().__init__(name)
        if not 0.0 < bandwidth < 0.5:
            raise ValueError("fsk bandwidth must be in (0, 0.5)")
        M = 1 << m
        M2 = 0.5 * (M - 1)
        # per-symbol phase increment per sample (fskmod.c:130-131)
        self._buffer("dphi", ((np.arange(M) - M2) * 2.0 * np.pi * bandwidth
                              / M2).astype(np.float32))
        self.k = int(k)
        self.rate = (self.k, 1)

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return torch.zeros(tuple(batch_shape), dtype=torch.float32,
                           device=device)

    def forward(self, carry, s):
        dphi = self.dphi[s.long()]
        per_sample = torch.repeat_interleave(dphi, self.k, dim=-1)
        # the tone's phase BEFORE stepping (the reference takes cexp, then
        # steps)
        theta = carry[..., None] + torch.cumsum(per_sample, dim=-1) \
            - per_sample
        new_phase = torch.remainder(theta[..., -1] + per_sample[..., -1],
                                    _TWO_PI)
        return _cexp(theta), new_phase


def fsk_modulator(m: int, k: int, bandwidth: float = 0.25,
                  name: str = "fskmod") -> FSKModulator:
    """M-ary FSK modulator: symbols [..., N] -> samples [..., N*k],
    phase-continuous across symbols and blocks (carry: the phase)."""
    return FSKModulator(m, k, bandwidth, name)


class FSKDemodulator(Proc):
    """See `fsk_demodulator`."""

    param_spec = {"map": "map"}

    def __init__(self, m, k, bandwidth, name):
        super().__init__(name)
        self.K, demod_map = _fsk_maps(m, k, bandwidth)
        self._buffer("map", demod_map.astype(np.int32))
        self.k = int(k)
        self.rate = (1, self.k)

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return ()

    def forward(self, carry, y):
        T = y.shape[-1]
        if T % self.k:
            raise ValueError(f"fskdem block length {T} not a multiple of "
                             f"k={self.k}")
        blocks = y.reshape(y.shape[:-1] + (T // self.k, self.k))
        spec = torch.fft.fft(blocks, n=self.K, dim=-1)
        return spec[..., self.map.long()].abs().argmax(dim=-1), carry


def fsk_demodulator(m: int, k: int, bandwidth: float = 0.25,
                    name: str = "fskdem") -> FSKDemodulator:
    """M-ary FSK demodulator: samples [..., N*k] -> symbols [..., N]: a
    K-point DFT of each symbol's k samples, the peak over the M tone
    bins (reference fskdem.c:160-210)."""
    return FSKDemodulator(m, k, bandwidth, name)


def fsk_frequency_error(y, m: int, k: int, bandwidth: float = 0.25):
    """Per-symbol frequency error from the spectrum's slope around the
    winning tone, (|V[b+1]| - |V[b-1]|) / |V[b]| (the intent of reference
    fskdem_get_frequency_error, fskdem.c:224-238, which as shipped takes
    the magnitude of the bin INDEX).  Returns (symbols, ferr), both
    [..., N]."""
    K, map0 = _fsk_maps(m, k, bandwidth)
    T = y.shape[-1]
    if T % k:
        raise ValueError(f"block length {T} not a multiple of k={k}")
    dev = y.device
    blocks = y.reshape(y.shape[:-1] + (T // k, k))
    mag = torch.fft.fft(blocks, n=K, dim=-1).abs()
    m0 = torch.from_numpy(map0).to(dev)
    tone = mag[..., m0]
    syms = tone.argmax(dim=-1)
    pick = syms[..., None]
    v0 = torch.gather(tone, -1, pick)[..., 0]
    vm = torch.gather(mag[..., torch.remainder(m0 - 1, K)], -1, pick)[..., 0]
    vp = torch.gather(mag[..., torch.remainder(m0 + 1, K)], -1, pick)[..., 0]
    return syms, (vp - vm) / torch.clamp(v0, min=1e-12)


# ---------------------------------------------------------------------------
# GMSK and CPFSK: pulse-shaped phase increments


def _interp_phase(ht, carry, x, k: int):
    """Zero-stuff x by k, filter with ht: the phase increments and the
    filter's new tail."""
    up = torch.zeros(x.shape[:-1] + (x.shape[-1] * k,), dtype=x.dtype,
                     device=x.device)
    up[..., ::k] = x
    return fir_apply_auto(ht, carry, up)


class _PhaseModulator(Proc):
    """Pulse-shaped phase modulation (GMSK and CPFSK): carry {"tail":
    the pulse filter's input tail, "theta": the carrier phase}."""

    param_spec = {"ht": "ht"}

    def __init__(self, ht, k, name):
        super().__init__(name)
        self._buffer("ht", np.asarray(ht, np.float32))
        self.k = int(k)
        self.L = int(self.ht.shape[-1])
        self.rate = (self.k, 1)

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        batch_shape = tuple(batch_shape)
        return {"tail": torch.zeros(batch_shape + (self.L - 1,),
                                    dtype=torch.float32, device=device),
                "theta": torch.zeros(batch_shape, dtype=torch.float32,
                                     device=device)}

    def _wrap(self, theta_end):
        return torch.remainder(theta_end + np.pi, _TWO_PI) - np.pi


class GMSKModulator(_PhaseModulator):
    """See `gmsk_modulator`."""

    def forward(self, carry, bits):
        x = torch.where(bits > 0, 1.0, -1.0).to(torch.float32) / self.k
        phi, tail = _interp_phase(self.ht, carry["tail"], x, self.k)
        theta = carry["theta"][..., None] + torch.cumsum(phi, dim=-1)
        return _cexp(theta), {"tail": tail,
                              "theta": self._wrap(theta[..., -1])}


def gmsk_modulator(k: int = 2, m: int = 3, bt: float = 0.3,
                   name: str = "gmskmod") -> GMSKModulator:
    """GMSK modulator: bits [..., N] -> samples [..., N*k]
    (reference gmskmod.c:75-140)."""
    return GMSKModulator(firdes_gmsktx(k, m, bt).astype(np.float32), k, name)


class _PhaseDemodulator(Proc):
    """Phase-derivative demodulation: carry {"x_prime": the last sample,
    "tail": the matched filter's input tail}."""

    param_spec = {"hr": "hr"}

    def __init__(self, hr, k, name):
        super().__init__(name)
        self._buffer("hr", np.asarray(hr, np.float32))
        self.k = int(k)
        self.L = int(self.hr.shape[-1])
        self.rate = (1, self.k)

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        batch_shape = tuple(batch_shape)
        return {"x_prime": torch.zeros(batch_shape, dtype=torch.complex64,
                                       device=device),
                "tail": torch.zeros(batch_shape + (self.L - 1,),
                                    dtype=torch.float32, device=device)}

    def _filtered(self, carry, x):
        d, tail = fir_apply_auto(self.hr, carry["tail"],
                                 _phase_diff(carry["x_prime"], x))
        return d, {"x_prime": x[..., -1], "tail": tail}


class GMSKDemodulator(_PhaseDemodulator):
    """See `gmsk_demodulator`."""

    def __init__(self, hr, k, soft, name):
        super().__init__(hr, k, name)
        self.soft = bool(soft)

    def forward(self, carry, x):
        d, new_carry = self._filtered(carry, x)
        d = d[..., ::self.k]
        return (d if self.soft else (d > 0).to(torch.int32)), new_carry


def gmsk_demodulator(k: int = 2, m: int = 3, bt: float = 0.3,
                     soft: bool = False,
                     name: str = "gmskdem") -> GMSKDemodulator:
    """GMSK demodulator: samples [..., N*k] -> bits [..., N] (reference
    gmskdem.c:196-247: phase derivative, matched filter, k:1 decimation,
    sign slice).  ``soft=True`` returns the matched filter's output
    before the slice (float, positive = bit 1): the soft metric that
    feeds the device decoders (fec/device.py)."""
    hr = firdes_gmskrx(k, m, bt).astype(np.float32)
    return GMSKDemodulator(hr / np.sum(np.abs(hr)), k, soft, name)


def cpfsk_pulse(k: int, m: int, beta: float, kind: str) -> np.ndarray:
    """Phase pulse, area-normalized to 1 (reference cpfskmod.c)."""
    if kind == "square":
        ht = np.ones(k)
    elif kind == "rcos_full":
        ht = 1.0 - np.cos(2 * np.pi * np.arange(k) / k)
    elif kind == "rcos_partial":
        ht = np.zeros(3 * k)
        i = np.arange(2 * k)
        ht[i + k // 2] = 1.0 - np.cos(2 * np.pi * i / (2 * k))
    elif kind == "gmsk":
        ht = np.zeros(2 * k * m + k + 1)
        g = firdes_gmsktx(k, m, beta)
        ht[k // 2: k // 2 + len(g)] = g
    else:
        raise ValueError(f"unknown cpfsk pulse type {kind!r}")
    return (ht / np.sum(ht)).astype(np.float32)


class CPFSKModulator(_PhaseModulator):
    """See `cpfsk_modulator`."""

    def __init__(self, ht, k, M, name):
        super().__init__(ht, k, name)
        self.M = int(M)

    def forward(self, carry, s):
        v = (2.0 * s - (self.M - 1)).to(torch.float32)
        phi, tail = _interp_phase(self.ht, carry["tail"], v, self.k)
        # exclusive phase: the reference emits exp(j*theta) BEFORE it
        # integrates the step
        csum = torch.cumsum(phi, dim=-1)
        theta = carry["theta"][..., None] + (csum - phi)
        t_end = carry["theta"] + csum[..., -1]
        return _cexp(theta), {"tail": tail, "theta": self._wrap(t_end)}


def cpfsk_modulator(bps: int, h: float, k: int, m: int = 3,
                    beta: float = 0.35, kind: str = "square",
                    name: str = "cpfskmod") -> CPFSKModulator:
    """CPFSK modulator: symbols [..., N] -> samples [..., N*k]; phase
    increments NRZ v = 2s-M+1 (reference cpfskmod.c:226) shaped by the
    phase pulse scaled by pi*h (cpfskmod.c:147-149)."""
    return CPFSKModulator(cpfsk_pulse(k, m, beta, kind) * np.pi * h, k,
                          1 << bps, name)


class CPFSKDemodulator(_PhaseDemodulator):
    """See `cpfsk_demodulator`."""

    def __init__(self, hr, k, M, h, name):
        super().__init__(hr, k, name)
        self.M, self.h = int(M), float(h)
        # the pulse's and the matched filter's centroid delays add up to
        # L-1 samples: decide where the filtered frequency plateaus
        self.offset = (self.L - 1) % self.k

    def forward(self, carry, x):
        d, new_carry = self._filtered(carry, x)
        v_hat = d[..., self.offset::self.k] * (self.k / (np.pi * self.h))
        s = torch.clamp(torch.round((v_hat + (self.M - 1)) / 2.0), 0,
                        self.M - 1)
        return s.to(torch.int32), new_carry


def cpfsk_demodulator(bps: int, h: float, k: int, m: int = 3,
                      beta: float = 0.35, kind: str = "square",
                      name: str = "cpfskdem") -> CPFSKDemodulator:
    """CPFSK demodulator (non-coherent, phase derivative; reference
    cpfskdem.c): per-sample frequency, the matched filter (the
    time-reversed pulse), the slice to the nearest NRZ level."""
    ht = cpfsk_pulse(k, m, beta, kind)
    return CPFSKDemodulator(ht[::-1].copy(), k, 1 << bps, h, name)
