"""Audio codec: continuously variable slope delta (CVSD) modulation
(`liquid_dsp_tpu/utils/audio.py`).

Reference analog (studied, not copied): reference src/audio/src/cvsd.c —
1-bit delta modulator with adaptive step: if the last `num_bits` output
bits agree, multiply the step by zeta, else divide (delta clipped to
[0.01, 1.0]); tracker clipped to [-1, 1].  Signal conditioning is
enabled as in the reference build (cvsd.c:33): a pre-emphasis FIR
y[n] = x[n] - alpha x[n-1] before encoding, and a post-emphasis
DC-blocking IIR (b=[1,-1,0], a=[1,-(alpha+beta), alpha beta], beta=0.99)
after decoding.

The per-sample recurrence is the `cvsd_scan` kernel
(`ops/kernels/cvsd_scan.py`): one launch per call on the card, its plain
version on the CPU.  A tensor is coded where it lies; a host array goes
to ``device``, the card unless the caller names another.  Both return
numpy, as the JAX package's do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import entry_tensor
from ..ops.kernels.cvsd_scan import cvsd_consts, cvsd_scan

__all__ = ["cvsd_encode", "cvsd_decode"]

_DTYPES = {np.float32: torch.float32, np.uint8: torch.uint8}


def _one_row(x, np_dtype, device, what: str) -> torch.Tensor:
    """x as a [1, T] tensor of np_dtype: a tensor stays where it lies, a
    host array goes to ``device``."""
    if not torch.is_tensor(x):
        x = np.asarray(x, np_dtype)
    t = entry_tensor(x, device).to(_DTYPES[np_dtype])
    if t.dim() != 1:
        raise ValueError(f"{what} takes a 1-D signal, got shape "
                         f"{tuple(t.shape)}")
    return t.reshape(1, -1)


def cvsd_encode(audio, num_bits: int = 3, zeta: float = 1.5,
                alpha: float = 0.95, device="cuda") -> np.ndarray:
    """Encode float samples [-1,1] -> bits [T] uint8 (reference
    cvsd_encode)."""
    cvsd_consts(num_bits, zeta, alpha)
    x = _one_row(audio, np.float32, device, "cvsd_encode")
    return cvsd_scan(x, True, num_bits, zeta, alpha)[0].cpu().numpy()


def cvsd_decode(bits, num_bits: int = 3, zeta: float = 1.5,
                alpha: float = 0.95, device="cuda") -> np.ndarray:
    """Decode bits -> float32 samples (reference cvsd_decode).  The bits
    are taken as uint8, the reference's unsigned char."""
    cvsd_consts(num_bits, zeta, alpha)
    b = _one_row(bits, np.uint8, device, "cvsd_decode")
    return cvsd_scan(b, False, num_bits, zeta, alpha)[0].cpu().numpy()
