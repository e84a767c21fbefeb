"""Quantization: mu-law companding and fixed-point ADC/DAC on torch
(`liquid_dsp_tpu/utils/quantization.py`).

Reference analog (studied, not copied): reference src/quantization/src/
compand.c:35-60 (mu-law compress/expand, complex variant) and
quantizer.c (quantize_adc/dac with b-bit resolution).

A tensor is processed where it lies; a host array goes to ``device``, the
card unless the caller names another (`core.entry_tensor`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import entry_tensor

__all__ = ["compress_mulaw", "expand_mulaw", "compress_cf_mulaw",
           "expand_cf_mulaw", "quantize_adc", "quantize_dac"]


def compress_mulaw(x, mu: float = 255.0, device="cuda"):
    """y = sign(x) log(1+mu|x|)/log(1+mu) (reference compand.c:35)."""
    if mu <= 0:
        raise ValueError("mu must be positive")
    x = entry_tensor(x, device)
    return torch.sign(x) * torch.log1p(mu * x.abs()) / float(
        np.float32(np.log1p(mu)))


def expand_mulaw(y, mu: float = 255.0, device="cuda"):
    """Inverse companding (reference compand.c:47)."""
    if mu <= 0:
        raise ValueError("mu must be positive")
    y = entry_tensor(y, device)
    return torch.sign(y) * (torch.pow(1 + mu, y.abs()) - 1) / mu


def _cf(x, f, mu, device):
    x = entry_tensor(x, device)
    r = x.abs()
    return torch.where(r > 0, x / torch.clamp(r, min=1e-30) * f(r, mu),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def compress_cf_mulaw(x, mu: float = 255.0, device="cuda"):
    """Complex variant: compand the magnitude (reference compand.c:59)."""
    return _cf(x, compress_mulaw, mu, device)


def expand_cf_mulaw(y, mu: float = 255.0, device="cuda"):
    return _cf(y, expand_mulaw, mu, device)


def quantize_adc(x, bits: int, device="cuda"):
    """Quantize x in [-1,1) to signed b-bit integers (reference
    quantizer.c quantize_adc)."""
    if not (1 <= bits <= 32):
        raise ValueError("bits must be in [1, 32]")
    scale = 1 << (bits - 1)
    q = torch.clamp(torch.floor(entry_tensor(x, device) * scale),
                    -scale, scale - 1)
    return q.to(torch.int32)


def quantize_dac(q, bits: int, device="cuda"):
    """Inverse: integers -> midpoint float values."""
    if not (1 <= bits <= 32):
        raise ValueError("bits must be in [1, 32]")
    scale = 1 << (bits - 1)
    return (entry_tensor(q, device).to(torch.float32) + 0.5) / scale
