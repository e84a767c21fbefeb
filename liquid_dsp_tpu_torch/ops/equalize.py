"""Adaptive equalizers: normalized LMS and RLS as per-sample loops
(`liquid_dsp_tpu/ops/equalize.py`).

Reference analogs: eqlms (src/equalization/src/eqlms.c:34-49, 248-330),
normalized LMS w += mu * conj(e) * x / sum|x|^2; eqrls
(src/equalization/src/eqrls.c:33+), recursive least squares with a
P-matrix update.

The weight update is sequential in time: each loop here runs the JAX
package's ``lax.scan`` body once per sample on the batch.  They have no
kernel yet and raise on CUDA tensors (symtrack's decision-directed LMS
has its own kernel, `ops/kernels/pll_lms`).

Weight convention: the window holds the last h_len inputs oldest first;
y = sum_i conj(w[i]) * buf[i] (reference eqlms.c _execute).  Training
with a known sequence d, or decision-directed through a slicer.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core import Proc
from ..design.firdes import firdes_kaiser

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


def _push(buf, xt):
    return torch.cat([buf[..., 1:], xt[..., None]], dim=-1)


def _host_only(x, name: str):
    if x.device.type == "cuda":
        raise NotImplementedError(
            f"{name} is a per-sample loop with no kernel on the card "
            "(ROADMAP, later kernel work: recurrence kernels for the "
            "equalizers); run it on the CPU")


def eqlms_run(w0, mu: float, carry, x, d=None,
              slicer: Optional[Callable] = None):
    """Run LMS over a block.

    carry: {w: [..., L], buf: [..., L], x2_sum: [...], n: [...]}; x [..., T]
    input samples; d [..., T] desired outputs (training), or None with a
    slicer for decision-directed operation.  Returns (y, carry')."""
    _host_only(x, "eqlms")
    L = carry["w"].shape[-1]
    c = dict(carry)
    ys = []
    for t in range(x.shape[-1]):
        xt = x[..., t]
        buf = _push(c["buf"], xt)
        x2 = (xt * torch.conj(xt)).real
        b0 = c["buf"][..., 0]
        x2_sum = c["x2_sum"] + x2 - (b0 * torch.conj(b0)).real
        y = torch.sum(torch.conj(c["w"]) * buf, dim=-1)
        target = d[..., t] if d is not None else slicer(y)
        e = target - y
        denom = torch.clamp(x2_sum, min=1e-12)
        # the reference skips weight updates until h_len samples have been
        # pushed (eqlms.c _step buf_full gating)
        n = c["n"] + 1
        gate = (n >= L).to(denom.dtype)
        w = c["w"] + gate[..., None] * mu * torch.conj(e)[..., None] * \
            buf / denom[..., None]
        c = {"w": w, "buf": buf, "x2_sum": x2_sum, "n": n}
        ys.append(y)
    if not ys:
        return torch.zeros_like(x), c
    return torch.stack(ys, dim=-1), c


class EQLMS(Proc):
    """Streaming LMS equalizer: trained with an (x, d) tuple input,
    decision-directed on a plain input (see `eqlms`)."""

    def __init__(self, h_len, mu, h, slicer, name):
        super().__init__(name)
        self.h_len, self.mu = int(h_len), float(mu)
        self.w_init = eqlms_init_weights(h_len, h)
        # default decision device: unit-energy QPSK points (+-sqrt(1/2)
        # per rail), the framework's modem normalization
        s2 = float(np.float32(np.sqrt(0.5)))
        self.slicer = slicer or (
            lambda y: torch.complex(torch.sign(y.real) * s2,
                                    torch.sign(y.imag) * s2)
            if y.is_complex() else torch.sign(y))

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        w = torch.as_tensor(np.asarray(self.w_init), device=device).to(dtype)
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
    (reference eqrls.c:252+)."""
    _host_only(x, "eqrls")
    c = dict(carry)
    ys = []
    for t in range(x.shape[-1]):
        buf = _push(c["buf"], x[..., t])
        y = torch.sum(torch.conj(c["w"]) * buf, dim=-1)
        e = d[..., t] - y
        Px = torch.einsum("...ij,...j->...i", c["P"], buf)
        denom = lam + torch.einsum("...i,...i->...", torch.conj(buf),
                                   Px).real
        k = Px / denom[..., None]
        w = c["w"] + k * torch.conj(e)[..., None]
        P = (c["P"] - torch.einsum("...i,...j,...jl->...il", k,
                                   torch.conj(buf), c["P"])) / lam
        c = {"w": w, "buf": buf, "P": P}
        ys.append(y)
    if not ys:
        return torch.zeros_like(x), c
    return torch.stack(ys, dim=-1), c


class EQRLS(Proc):
    """Streaming RLS equalizer (trained: the input is an (x, d) tuple)."""

    def __init__(self, h_len, lam, delta, h, name):
        super().__init__(name)
        self.h_len, self.lam, self.delta = int(h_len), float(lam), float(delta)
        self.w_init = eqlms_init_weights(h_len, h)

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        L = self.h_len
        eye = torch.eye(L, dtype=dtype, device=device) / self.delta
        w = torch.as_tensor(np.asarray(self.w_init), device=device).to(dtype)
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
