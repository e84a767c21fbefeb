"""FIR filtering as block processors with explicit carry
(`liquid_dsp_tpu/ops/fir.py`).

Reference analog: src/filter/src/firfilt.c:297-360 (per-sample ring
buffer + dotprod).  Here: one valid convolution over the whole block;
carry = last (L-1) input samples, exactly the overlap-save halo.

All ops accept [..., T] blocks (time last, leading axes batched).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import LTI, Proc, planar_per_plane
from .dotprod import conv1d
from .fftfilt import fftfilt_apply
from .kernels.fir_real import LMAX as fir_real_lmax
from .kernels.fir_real import fir_apply_pallas

__all__ = ["firfilt", "FIRFilt", "fir_apply", "fir_apply_auto",
           "fir_apply_matmul", "banded_blocks_apply"]


def _np_taps(h, scale=1.0):
    """Coefficient prep on the host: scale, then narrow float64/complex128
    to float32/complex64 (the tap dtypes of the JAX package)."""
    h = np.asarray(h)
    if scale != 1.0:
        h = h * scale
    if h.dtype == np.float64:
        h = h.astype(np.float32)
    elif h.dtype == np.complex128:
        h = h.astype(np.complex64)
    return h


def _coerce(carry, dtype):
    """Carry stores input samples; follow the input stream's dtype (a fresh
    complex-initialized carry feeding a real stream drops the zero imag)."""
    if carry.is_complex() and not dtype.is_complex:
        carry = carry.real
    return carry.to(dtype)


def fir_apply(h, carry, x, stride: int = 1):
    """One block of FIR filtering: returns (y, carry').

    carry is the last (len(h)-1) input samples (zeros initially).
    y[t] = sum_j h[j] * xp[t*stride - j] with xp = [carry | x], evaluated at
    output sample times aligned so y[0] corresponds to input x[0].
    """
    L = h.shape[-1]
    xp = torch.cat([carry, x], dim=-1) if L > 1 else x
    y = conv1d(xp, h, stride=stride)
    new_carry = xp[..., xp.shape[-1] - (L - 1):] if L > 1 else carry
    return y, new_carry


def banded_blocks_apply(band, xp, T_out, tile_in, tile_out):
    """Shared banded-matmul skeleton: pad xp to (nt+nb-1)*tile_in,
    reshape into non-overlapping input tiles, and accumulate the
    per-block ``[.., nt, tile_in] @ [tile_in, tile_out]`` matmuls;
    returns [.., nt*tile_out][..., :T_out].

    band: [rows, tile_out] tensor on xp's device.  Complex input x real
    band splits into planes (2 real matmuls); real input x complex band
    upcasts the input so the band's imaginary part is kept.  torch.matmul
    is full float32 unless ``torch.backends.cuda.matmul.allow_tf32``."""
    rows = int(band.shape[0])
    nt = -(-T_out // tile_out)
    nb = -(-rows // tile_in)
    tot = (nt + nb - 1) * tile_in
    pad_r = tot - xp.shape[-1]
    if pad_r > 0:
        xp = torch.nn.functional.pad(xp, (0, pad_r))
    elif pad_r < 0:
        xp = xp[..., :tot]
    if band.is_complex() and not xp.is_complex():
        xp = xp.to(band.dtype)
    if xp.is_complex() and not band.is_complex():
        planes = torch.stack([xp.real, xp.imag], dim=0)
        y2 = banded_blocks_apply(band, planes, T_out, tile_in, tile_out)
        return torch.complex(y2[0], y2[1])
    xpt = xp.reshape(xp.shape[:-1] + (nt + nb - 1, tile_in))
    y = None
    for b in range(nb):
        blk = band[b * tile_in:(b + 1) * tile_in]
        if blk.shape[0] < tile_in:
            blk = torch.nn.functional.pad(blk, (0, 0, 0, tile_in - blk.shape[0]))
        seg = xpt[..., b:b + nt, :]
        contrib = torch.matmul(seg, blk.to(seg.dtype))
        y = contrib if y is None else y + contrib
    return y.reshape(y.shape[:-2] + (nt * tile_out,))[..., :T_out]


def _banded_matmul(h, xp, T, tile, stride: int = 1):
    """[.., Tp] -> [.., T] banded-tap matmul (T OUTPUT samples, one per
    `stride` inputs); xp already carries the L-1 history prefix.  The
    [S*tile+L-1, tile] band matrix band[f, k] = h[k*S + L-1 - f] is split
    into [S*tile, tile] blocks over non-overlapping input tiles."""
    L = int(h.shape[-1])
    S = int(stride)
    tile_in = tile * S
    rows = tile_in + L - 1
    j = (np.arange(tile)[None, :] * S + (L - 1)
         - np.arange(rows)[:, None])
    mask = torch.as_tensor((j >= 0) & (j < L), device=h.device)
    idx = torch.as_tensor(np.clip(j, 0, L - 1), device=h.device)
    band = torch.where(mask, h[idx], torch.zeros((), dtype=h.dtype,
                                                 device=h.device))
    return banded_blocks_apply(band, xp, T, tile_in, tile)


def fir_apply_matmul(h, carry, x, tile: int = 256, stride: int = 1):
    """FIR as a banded-tap matmul: frames [.., nt, tile+L-1] times band
    [tile+L-1, tile].  Identical output to fir_apply up to float32
    summation order."""
    L = int(h.shape[-1])
    T = int(x.shape[-1]) // int(stride)
    xp = torch.cat([carry.to(x.dtype), x], dim=-1)
    new_carry = xp[..., xp.shape[-1] - (L - 1):] if L > 1 else carry
    if h.is_complex() and not xp.is_complex():
        xp = xp.to(h.dtype)  # the band cast below must not drop imag
    if xp.is_complex() and not h.is_complex():
        planes = torch.stack([xp.real, xp.imag], dim=0)
        y2 = _banded_matmul(h, planes, T, tile, stride)
        return torch.complex(y2[0], y2[1]), new_carry
    return _banded_matmul(h, xp, T, tile, stride), new_carry


def fir_apply_auto(h, carry, x, stride: int = 1):
    """fir_apply with a per-call backend pick: the banded matmul on CUDA
    tensors (torch.matmul is full float32 by default there, cuDNN's
    conv1d is TF32 by default), the conv form on the CPU."""
    if x.device.type == "cuda" and x.shape[-1] % stride == 0:
        return fir_apply_matmul(h, carry, x, stride=stride)
    return fir_apply(h, carry, x, stride)


class FIRFilt(Proc):
    """Direct-form FIR filter over blocks (reference firfilt_crcf).

    Block length T in -> T out; carry: [..., L-1] input tail.
    backend: 'xla' (the conv form, `fir_apply`; the name is the JAX
    package's), 'matmul' (banded-tap matrix, `fir_apply_matmul`), 'fft'
    (overlap-save `fftfilt` with the SAME carry), 'pallas' (the
    hand-written CUDA kernel `ops/kernels/fir_real.py`, the port of the
    JAX package's Pallas kernel: real taps, L <= 4096; on the CPU its
    plain version), or 'auto' (the `fir_apply_auto` pick per call: matmul
    on CUDA, conv on CPU).
    """

    param_spec = {"h": "h"}

    def __init__(self, h, scale=1.0, name: str = "firfilt",
                 backend: str = "auto"):
        super().__init__(name)
        h_np = _np_taps(h, scale)
        L = int(h_np.shape[-1])
        if backend == "pallas":
            if np.iscomplexobj(h_np):
                raise ValueError("pallas firfilt backend supports real taps")
            if L > fir_real_lmax:
                raise ValueError(f"pallas firfilt backend takes up to "
                                 f"{fir_real_lmax} taps, got {L}")
        if backend not in ("auto", "xla", "matmul", "fft", "pallas"):
            raise ValueError(f"unknown firfilt backend {backend!r}")
        self.backend = backend
        self._buffer("h", h_np)
        self.L = L
        self.halo = L - 1
        self.lti = LTI(h_np, 1, 0)
        # real taps filter each float plane independently (planar.py)
        self.forward_planar, self.init_planar = planar_per_plane(
            self.forward, self.init)
        if np.iscomplexobj(h_np):
            self.forward_planar = self._forward_karatsuba

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return torch.zeros(batch_shape + (self.L - 1,), dtype=dtype,
                           device=device)

    def forward(self, carry, x):
        h, carry = self.h, _coerce(carry, x.dtype)
        if self.backend == "fft":
            return fftfilt_apply(h, carry, x)
        if self.backend == "matmul":
            return fir_apply_matmul(h, carry, x)
        if self.backend == "xla":
            return fir_apply(h, carry, x)
        if self.backend == "pallas":
            return fir_apply_pallas(h, carry, x)
        return fir_apply_auto(h, carry, x)

    def _forward_karatsuba(self, carry, x):
        # complex taps on float planes: m1 = r*hr, m2 = i*hi,
        # m3 = (r+i)*(hr+hi); yr = m1 - m2, yi = m3 - m1 - m2
        hr, hi = self.h.real, self.h.imag
        (r, i), (cr, ci) = x, carry
        m1, cr2 = fir_apply_auto(hr, cr, r)
        m2, ci2 = fir_apply_auto(hi, ci, i)
        m3, _ = fir_apply_auto(hr + hi, cr + ci, r + i)
        return (m1 - m2, m3 - m1 - m2), (cr2, ci2)


def firfilt(h, scale: float | complex = 1.0, name: str = "firfilt",
            backend: str = "auto") -> FIRFilt:
    """Direct-form FIR filter Proc (see `FIRFilt`)."""
    return FIRFilt(h, scale, name, backend)
