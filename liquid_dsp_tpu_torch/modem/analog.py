"""Analog modems (`liquid_dsp_tpu/modem/analog.py`): FM (freqmod /
freqdem) and AM (ampmodem).

Reference analogs:
  * freqmod  — src/modem/src/freqmod.c:36-60: s(t) = exp(j*2*pi*kf*sum(m)),
               the phase accumulated in 16-bit units and looked up in a
               1024-entry sincos table; sample-exact here too.
  * freqdem  — src/modem/src/freqdem.c: m(t) = arg(r[n-1]* . r[n]) / (2*pi*kf).
  * ampmodem — src/modem/src/ampmodem.c:153-256: DSB/USB/LSB with optional
               carrier suppression; SSB through a Hilbert transform; the
               demodulator is an envelope detector (carrier kept) or
               coherent (suppressed DSB).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import Proc
from ..ops.fir import fir_apply_auto

__all__ = ["freq_modulator", "freq_demodulator", "amp_modulator",
           "amp_demodulator", "FreqMod", "FreqDem", "AmpMod", "AmpDem"]


class FreqMod(Proc):
    """FM modulator: real message [..., T] -> complex baseband [..., T],
    sample-exact against the reference (freqmod.c:106-121): the phase
    accumulates in 16-bit integer steps round(kf*2^16*m) and the output
    is the 1024-entry sincos table at the 10-bit rounded phase (a gather
    on every device).  Carry: the 16-bit integer phase, int32."""

    param_spec = {}

    def __init__(self, kf: float, name: str = "freqmod"):
        super().__init__(name)
        if not (0.0 < kf <= 1.0):
            raise ValueError("FM modulation factor must be in (0, 1]")
        self.ref = kf * (1 << 16)
        self._buffer("table", np.exp(
            2j * np.pi * np.arange(1024, dtype=np.float64) / 1024.0
        ).astype(np.complex64))

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return torch.zeros(tuple(batch_shape), dtype=torch.int32,
                           device=device)

    def forward(self, carry, m):
        x = m.to(torch.float32) * self.ref
        # C roundf: round half away from zero, in float32
        steps = torch.trunc(x + torch.sign(x) * 0.5).to(torch.int32)
        # the int64 cumsum equals the int32 one mod 2^32, so mod 2^16 too
        ph = (carry[..., None] + torch.cumsum(steps, dim=-1)) & 0xFFFF
        idx = ((ph + 0x0020) >> 6) & 0x03FF
        return self.table[idx], ph[..., -1].to(torch.int32)


class FreqDem(Proc):
    """FM demodulator: m[n] = arg(conj(r[n-1]) r[n]) / (2 pi kf).  Carry:
    the previous sample (reference freqdem.c)."""

    param_spec = {}

    def __init__(self, kf: float, name: str = "freqdem"):
        super().__init__(name)
        self.kf = float(kf)

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return torch.zeros(tuple(batch_shape), dtype=torch.complex64,
                           device=device)

    def forward(self, carry, r):
        prev = torch.cat([carry[..., None].to(r.dtype), r[..., :-1]], dim=-1)
        m = torch.angle(torch.conj(prev) * r + 1e-20) / (
            2.0 * np.pi * self.kf)
        return m.to(torch.float32), r[..., -1]


def freq_modulator(kf: float, name: str = "freqmod") -> FreqMod:
    """FM modulator Proc (see `FreqMod`)."""
    return FreqMod(kf, name)


def freq_demodulator(kf: float, name: str = "freqdem") -> FreqDem:
    """FM demodulator Proc (see `FreqDem`)."""
    return FreqDem(kf, name)


def _hilbert_taps(m: int = 25, as_db: float = 60.0) -> np.ndarray:
    """Type-III FIR Hilbert transformer taps, length 4m+1."""
    n = 4 * m + 1
    t = np.arange(n) - (n - 1) / 2.0
    with np.errstate(divide="ignore", invalid="ignore"):
        h = np.where(t == 0, 0.0, (1 - np.cos(np.pi * t)) / (np.pi * t))
    from ..design.windows import kaiser, kaiser_beta_as
    return (h * kaiser(n, kaiser_beta_as(as_db))).astype(np.float32)


class AmpMod(Proc):
    """AM modulator: real message [..., T] -> complex baseband.

    kind: 'dsb' | 'usb' | 'lsb' (reference liquid.h LIQUID_AMPMODEM_*).
    The SSB analytic signal comes from the reference's split Hilbert form
    (firhilb r2c_execute with m = 9, ampmodem.c:95): in-phase = x delayed
    2m samples, quadrature = the odd-sampled imaginary branch one sample
    back, folded into ONE complex-tap FIR "hh": c[2m] = 1 (real),
    c[1+2l] = j*him[2l+1]."""

    param_spec = {"hh": "hh"}

    def __init__(self, mod_index=0.1, kind="dsb", suppressed_carrier=False,
                 name="ampmod"):
        super().__init__(name)
        kind = kind.lower()
        if kind not in ("dsb", "usb", "lsb"):
            raise ValueError(f"unknown AM type {kind!r}")
        self.kind, self.suppressed_carrier = kind, bool(suppressed_carrier)
        m_h = 9
        from ..design.firdes import firdes_kaiser
        h_len = 4 * m_h + 1
        hk = firdes_kaiser(h_len, 0.25, 60.0, 0.0)
        t = np.arange(h_len, dtype=np.float64) - (h_len - 1) / 2.0
        him = np.imag(hk * np.exp(1j * 0.5 * np.pi * t))
        c = np.zeros(4 * m_h, np.complex64)
        c[2 * m_h] += 1.0
        c[1 + 2 * np.arange(2 * m_h)] += 1j * him[1::2]
        self._buffer("hh", c)

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        if self.kind == "dsb":
            return ()
        return {"tail_h": torch.zeros(
            tuple(batch_shape) + (self.hh.shape[-1] - 1,),
            dtype=torch.float32, device=device)}

    def forward(self, carry, x):
        if self.kind == "dsb":
            x_hat, new = x.to(torch.complex64), carry
        else:
            x_hat, tail = fir_apply_auto(self.hh, carry["tail_h"].to(x.dtype),
                                         x)
            new = {"tail_h": tail}
            if self.kind == "lsb":
                x_hat = torch.conj(x_hat)
        if not self.suppressed_carrier:
            x_hat = 0.5 * (x_hat + 1.0)
        return x_hat.to(torch.complex64).resolve_conj(), new


class AmpDem(Proc):
    """AM demodulator (reference ampmodem.c:199-256): envelope detector
    x = 2|y| - 1 with the carrier kept; with a suppressed carrier the real
    part (SSB, or DSB after an upstream NCO/PLL removed the carrier)."""

    param_spec = {}

    def __init__(self, mod_index=0.1, kind="dsb", suppressed_carrier=False,
                 name="ampdem"):
        super().__init__(name)
        self.kind, self.suppressed_carrier = kind.lower(), suppressed_carrier

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return ()

    def forward(self, carry, y):
        x = y.real if self.suppressed_carrier else 2.0 * torch.abs(y) - 1.0
        return x.to(torch.float32), carry


def amp_modulator(mod_index: float = 0.1, kind: str = "dsb",
                  suppressed_carrier: bool = False,
                  name: str = "ampmod") -> AmpMod:
    """AM modulator Proc (see `AmpMod`)."""
    return AmpMod(mod_index, kind, suppressed_carrier, name)


def amp_demodulator(mod_index: float = 0.1, kind: str = "dsb",
                    suppressed_carrier: bool = False,
                    name: str = "ampdem") -> AmpDem:
    """AM demodulator Proc (see `AmpDem`)."""
    return AmpDem(mod_index, kind, suppressed_carrier, name)
