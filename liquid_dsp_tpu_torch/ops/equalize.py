"""Adaptive equalizers: normalized LMS and RLS
(`liquid_dsp_tpu/ops/equalize.py`).

Reference analogs: eqlms (src/equalization/src/eqlms.c:34-49, 248-330),
normalized LMS w += mu * conj(e) * x / sum|x|^2; eqrls
(src/equalization/src/eqrls.c:33+), recursive least squares with a
P-matrix update.

The weight update is sequential in time.  `eqlms_run` runs on the
`ops/kernels/eqlms_scan` kernel and `eqrls_run` on
`ops/kernels/eqrls_scan`: on a CUDA tensor each launches its kernel (1 to
32 taps), on a CPU tensor each runs its plain PyTorch version (any
length), and any other device raises.  The card runs trained mode and
the two default slicers (unit-energy QPSK on a complex stream, sign on a
real one); a caller's own slicer is a Python callable that cannot run
inside the recurrence, so it raises NotImplementedError on the card and
runs once per sample in the plain version on the CPU.  (symtrack's
decision-directed LMS steps beside its PLL on its own kernel,
`ops/kernels/pll_lms`.)

Weight convention: the window holds the last h_len inputs oldest first;
y = sum_i conj(w[i]) * buf[i] (reference eqlms.c _execute).  Training
with a known sequence d, or decision-directed through a slicer.  A real
stream with a complex carry is taken as complex; a real carry takes a
real stream.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core import Proc
from ..design.firdes import firdes_kaiser
from .kernels.eqlms_scan import eqlms_scan
from .kernels.eqrls_scan import eqrls_scan

__all__ = ["eqlms_init_weights", "eqlms_lowpass_weights", "eqlms_run",
           "eqlms", "EQLMS", "eqrls_run", "eqrls", "EQRLS"]


def eqlms_init_weights(h_len: int, h=None) -> np.ndarray:
    """Default initial weights: a delta at the FIRST index (the oldest
    window slot), as reference eqlms.c create with NULL h."""
    if h is not None:
        return np.asarray(h)
    w = np.zeros(h_len, np.complex64)
    w[0] = 1.0
    return w


def eqlms_lowpass_weights(h_len: int, fc: float = 0.45) -> np.ndarray:
    """Kaiser lowpass initial weights (reference eqlms_create_lowpass:
    liquid_firdes_kaiser(h_len, fc, 40dB))."""
    return firdes_kaiser(h_len, fc, 40.0).astype(np.complex64)


def _weights(w_init, dtype, device):
    """The initial weights as `dtype` (their real part for a real carry,
    as the JAX package's cast takes it)."""
    w = torch.as_tensor(np.asarray(w_init), device=device)
    if w.is_complex() and not dtype.is_complex:
        w = w.real
    return w.to(dtype)


def _stream(t, w):
    """A real block as complex where the carry is complex."""
    return t.to(w.dtype) if w.is_complex() and not t.is_complex() else t


def eqlms_run(w0, mu: float, carry, x, d=None,
              slicer: Optional[Callable] = None):
    """Run LMS over a block.

    carry: {w: [..., L], buf: [..., L], x2_sum: [...], n: [...]}; x [..., T]
    input samples; d [..., T] desired outputs (training), or None for
    decision-directed operation through `slicer` (None: the default
    slicer of the stream's type).  Returns (y, carry')."""
    w = carry["w"]
    y, w, buf, x2_sum, n = eqlms_scan(
        _stream(x, w), w, carry["buf"], carry["x2_sum"], carry["n"], mu,
        d=None if d is None else _stream(d, w), slicer=slicer)
    return y, {"w": w, "buf": buf, "x2_sum": x2_sum, "n": n}


class EQLMS(Proc):
    """Streaming LMS equalizer: trained with an (x, d) tuple input,
    decision-directed on a plain input (see `eqlms`)."""

    def __init__(self, h_len, mu, h, slicer, name):
        super().__init__(name)
        self.h_len, self.mu = int(h_len), float(mu)
        self.w_init = eqlms_init_weights(h_len, h)
        # None: the default decision device, unit-energy QPSK points
        # (+-sqrt(1/2) per rail, the framework's modem normalization) on a
        # complex stream and sign on a real one, inside the recurrence
        self.slicer = slicer

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        w = _weights(self.w_init, dtype, device)
        return {"w": w.expand(batch_shape + (self.h_len,)).clone(),
                "buf": torch.zeros(batch_shape + (self.h_len,), dtype=dtype,
                                   device=device),
                "x2_sum": torch.zeros(batch_shape, dtype=torch.float32,
                                      device=device),
                "n": torch.zeros(batch_shape, dtype=torch.int32,
                                 device=device)}

    def forward(self, carry, x):
        if isinstance(x, tuple):
            xb, db = x
            return eqlms_run(None, self.mu, carry, xb, d=db)
        return eqlms_run(None, self.mu, carry, x, slicer=self.slicer)


def eqlms(h_len: int = 5, mu: float = 0.5, h=None,
          slicer: Optional[Callable] = None, name: str = "eqlms") -> EQLMS:
    """Streaming LMS equalizer Proc (see `EQLMS`)."""
    return EQLMS(h_len, mu, h, slicer, name)


def eqrls_run(lam: float, delta: float, carry, x, d):
    """Recursive least squares over a block (trained).

    carry: {w: [..., L], buf: [..., L], P: [..., L, L]}.  Standard RLS:
    k = P x / (lam + x^H P x); w += k conj(e); P = (P - k x^H P) / lam
    (reference eqrls.c:252+).  `delta` sets P's start (`EQRLS.init`)."""
    w = carry["w"]
    y, w, buf, P = eqrls_scan(_stream(x, w), _stream(d, w), w, carry["buf"],
                              carry["P"], lam)
    return y, {"w": w, "buf": buf, "P": P}


class EQRLS(Proc):
    """Streaming RLS equalizer (trained: the input is an (x, d) tuple)."""

    def __init__(self, h_len, lam, delta, h, name):
        super().__init__(name)
        self.h_len, self.lam, self.delta = int(h_len), float(lam), float(delta)
        self.w_init = eqlms_init_weights(h_len, h)

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        L = self.h_len
        eye = torch.eye(L, dtype=dtype, device=device) / self.delta
        w = _weights(self.w_init, dtype, device)
        return {"w": w.expand(batch_shape + (L,)).clone(),
                "buf": torch.zeros(batch_shape + (L,), dtype=dtype,
                                   device=device),
                "P": eye.expand(batch_shape + (L, L)).clone()}

    def forward(self, carry, x):
        xb, db = x
        return eqrls_run(self.lam, self.delta, carry, xb, db)


def eqrls(h_len: int = 5, lam: float = 0.99, delta: float = 0.1, h=None,
          name: str = "eqrls") -> EQRLS:
    """Streaming RLS equalizer Proc (see `EQRLS`)."""
    return EQRLS(h_len, lam, delta, h, name)
