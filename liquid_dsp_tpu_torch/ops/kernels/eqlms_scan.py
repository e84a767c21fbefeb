"""The normalized LMS equalizer's per-sample recurrence: a Hopper kernel for
the JAX package's ``lax.scan`` in `liquid_dsp_tpu/ops/equalize.py:48-86`
(`eqlms_run`).  The JAX package has no Pallas kernel here; PyTorch has no
device-side scan, and a Python loop would launch a few dozen kernels per
sample.

`eqlms_scan` launches the CUDA kernel ``csrc/eqlms_scan.cu`` on a CUDA
tensor and runs `eqlms_scan_reference`, the same loop in plain PyTorch,
on a CPU tensor; any other device raises.  Per channel and sample, with
the window of the last L inputs oldest first:

    buf    <- [buf[1:], x]
    x2_sum <- (x2_sum + |x|^2) - |oldest|^2     (|v|^2 = fma(re, re, im*im))
    n      <- n + 1
    g       = (n >= L ? mu : 0) / max(x2_sum, 1e-12)
    y       = tree_j conj(w_j) buf_j
    e       = target - y
    w_j    <- w_j + (g e) conj-times buf_j:
              re += g e_re b_re + g e_im b_im,  im += g e_re b_im - g e_im b_re

The target is d (trained), or the default slicer of the stream's type
(`sign(re) s + j sign(im) s`, s = float32(sqrt(1/2)) on a complex stream,
`sign` on a real one; ``sign(0) = 0``).  A real stream runs as a complex
one with zero imaginary parts, so both versions take one arithmetic.

tree_j is the kernel's butterfly over LM lanes (LM = `lanes(L)`, the taps
padded with zeros): at each level element j takes v[j] + v[j + o], o
halving from LM/2 (`lane_tree`).  |v|^2 is one fused multiply-add, as
XLA's CPU build forms it (the JAX package's x2_sum, bit for bit; at L = 1
the running sum cancels down to |x|^2 and its rounding sets the gain);
every other operation is rounded once in the order written here, so on
the card the kernel equals the plain version bit for bit.  Against the JAX package (which sums the dot in its
own order and forms g conj(e) buf otherwise) the two agree to 1e-5.

The kernel holds 1 <= L <= 32 taps (a lane each); the wrapper raises on
more.  The plain version takes any L, and a custom slicer (a Python
callable, called once per sample on y with the carry's batch shape).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .symsync_scan import fma32

__all__ = ["LMAX", "QPSK_SCALE", "lanes", "lane_tree", "eqlms_scan",
           "eqlms_scan_reference"]

LMAX = 32                 # taps the kernels take
QPSK_SCALE = float(np.float32(np.sqrt(0.5)))   # unit-energy QPSK rail


def lanes(L: int) -> int:
    """LM, the width the kernels pad L taps (or RLS's rows) to (8, 16,
    32, ...): the width over which `lane_tree` sums."""
    return max(8, 1 << (L - 1).bit_length())


def lane_tree(v, dim: int = -1):
    """The warp's butterfly sum over `dim` (a power of two long): at each
    level element j takes v[j] + v[j + o], o halving.  A lane of the
    butterfly adds v[j] and v[j ^ o]; the sum is commutative, so every
    lane ends with these bits."""
    n = v.shape[dim]
    while n > 1:
        n //= 2
        v = v.narrow(dim, 0, n) + v.narrow(dim, n, n)
    return v.squeeze(dim)


def _planes(t):
    """(re, im) float32 planes; a real tensor has a zero imaginary plane."""
    if t.is_complex():
        return t.real, t.imag
    return t, torch.zeros_like(t)


def _pad(t, LM):
    return torch.nn.functional.pad(t, (0, LM - t.shape[-1]))


def _join(re, im, cplx):
    return torch.complex(re, im) if cplx else re


def eqlms_scan_reference(x, w, buf, x2_sum, n, mu: float, d=None,
                         slicer=None):
    """Plain PyTorch version: a loop over the T samples on [..., LM] lane
    planes.  x [..., T], w and buf [..., L] (all complex64 or all
    float32), x2_sum [...] float32, n [...] int32; d [..., T] for trained
    mode, else `slicer` (None: the default) -> (y [..., T], w', buf',
    x2_sum', n')."""
    cplx = w.is_complex()
    L, T = w.shape[-1], x.shape[-1]
    LM = lanes(L)
    dev = x.device
    wr, wi = (_pad(p, LM) for p in _planes(w))
    br, bi = (_pad(p, LM) for p in _planes(buf))
    xr, xi = _planes(x)
    dr, di = _planes(d) if d is not None else (None, None)
    mu_t = torch.tensor(float(np.float32(mu)), device=dev)
    zero = torch.zeros((), device=dev)
    sc = QPSK_SCALE if cplx else 1.0
    pad = torch.zeros(w.shape[:-1] + (LM - L,), device=dev)
    x2s, cnt = x2_sum, n
    yr_t, yi_t = [], []
    for t in range(T):
        xtr, xti = xr[..., t], xi[..., t]
        orr, oi = br[..., 0], bi[..., 0]
        br = torch.cat([br[..., 1:L], xtr[..., None], pad], -1)
        bi = torch.cat([bi[..., 1:L], xti[..., None], pad], -1)
        x2s = (x2s + fma32(xtr, xtr, xti * xti)) - fma32(orr, orr, oi * oi)
        cnt = cnt + 1
        g = torch.where(cnt >= L, mu_t, zero) / torch.clamp(x2s, min=1e-12)
        yr = lane_tree(wr * br + wi * bi)
        yi = lane_tree(wr * bi - wi * br)
        if d is not None:
            tr, ti = dr[..., t], di[..., t]
        elif slicer is not None:
            tr, ti = (p.to(torch.float32)
                      for p in _planes(slicer(_join(yr, yi, cplx))))
        else:
            tr, ti = torch.sign(yr) * sc, torch.sign(yi) * sc
        ger, gei = g * (tr - yr), g * (ti - yi)
        ger, gei = ger[..., None], gei[..., None]
        wr = wr + (ger * br + gei * bi)
        wi = wi + (ger * bi - gei * br)
        yr_t.append(yr)
        yi_t.append(yi)
    if T == 0:
        y = torch.zeros(x.shape, dtype=w.dtype, device=dev)
    else:
        y = _join(torch.stack(yr_t, -1), torch.stack(yi_t, -1), cplx)
    return (y, _join(wr[..., :L], wi[..., :L], cplx),
            _join(br[..., :L], bi[..., :L], cplx), x2s.clone(), cnt.clone())


def _check(x, w, buf, x2_sum, n, d):
    if w.dim() < 1 or w.shape[-1] < 1 or buf.shape != w.shape:
        raise ValueError(f"eqlms_scan takes w and buf [..., L], L >= 1, got "
                         f"{tuple(w.shape)} and {tuple(buf.shape)}")
    batch = w.shape[:-1]
    if x.shape[:-1] != batch or x2_sum.shape != batch or \
            n.shape != batch or (d is not None and d.shape != x.shape):
        raise ValueError(
            f"eqlms_scan: x [..., T] (and d) on the carry's batch shape "
            f"{tuple(batch)}, got x {tuple(x.shape)}, x2_sum "
            f"{tuple(x2_sum.shape)}, n {tuple(n.shape)}"
            + (f", d {tuple(d.shape)}" if d is not None else ""))
    if w.dtype not in (torch.complex64, torch.float32) or \
            buf.dtype != w.dtype or x.dtype != w.dtype or \
            (d is not None and d.dtype != w.dtype):
        raise ValueError(f"eqlms_scan takes w, buf, x and d all complex64 or "
                         f"all float32, got {w.dtype}, {buf.dtype}, {x.dtype}"
                         + (f", {d.dtype}" if d is not None else ""))
    if x2_sum.dtype != torch.float32 or n.dtype != torch.int32:
        raise ValueError(f"eqlms_scan takes x2_sum float32 and n int32, got "
                         f"{x2_sum.dtype} and {n.dtype}")
    ts = [x, w, buf, x2_sum, n] + ([d] if d is not None else [])
    if any(t.device != x.device for t in ts):
        raise ValueError(f"eqlms_scan: all tensors must be on one device, "
                         f"got {[str(t.device) for t in ts]}")


def eqlms_scan(x, w, buf, x2_sum, n, mu: float, d=None, slicer=None):
    """LMS over a block: the outputs y [..., T] and the carry (w, buf,
    x2_sum, n) after it (new tensors; the inputs are not changed).
    Trained with d [..., T], else decision-directed through the default
    slicer (`slicer` None) or the caller's.

    A CUDA tensor launches the kernel (and counts the launch in
    ``eqlms_scan.launches``); a CPU tensor runs the plain version.  On
    the card a custom slicer raises NotImplementedError.
    """
    _check(x, w, buf, x2_sum, n, d)
    if x.device.type == "cpu":
        return eqlms_scan_reference(x, w, buf, x2_sum, n, mu, d, slicer)
    if x.device.type != "cuda":
        raise ValueError(f"eqlms_scan runs on CUDA (kernel) or CPU (plain "
                         f"version) tensors, got device {x.device}")
    if slicer is not None:
        raise NotImplementedError(
            "eqlms on the card runs trained mode and the default slicers "
            "(unit-energy QPSK on a complex stream, sign on a real one); a "
            "custom slicer is a Python callable and cannot run inside the "
            "recurrence: run it on the CPU (ROADMAP, \"Not carried over, "
            "by decision\": custom slicers on the card)")
    L, T = w.shape[-1], x.shape[-1]
    if L > LMAX:
        raise ValueError(f"eqlms_scan's kernel takes 1 to {LMAX} taps, got "
                         f"{L}")
    batch = w.shape[:-1]
    B = math.prod(batch)
    w2 = w.reshape(B, L).clone(memory_format=torch.contiguous_format)
    b2 = buf.reshape(B, L).clone(memory_format=torch.contiguous_format)
    x22 = x2_sum.reshape(B).clone(memory_format=torch.contiguous_format)
    n2 = n.reshape(B).clone(memory_format=torch.contiguous_format)
    y = torch.empty((B, T), dtype=w.dtype, device=x.device)
    if B and T:
        xc = x.reshape(B, T).contiguous()
        dc = d.reshape(B, T).contiguous() if d is not None else None
        cplx = w.is_complex()
        from .build import load_library
        lib = load_library()
        with torch.cuda.device(x.device):
            rc = lib.eqlms_scan_launch(
                xc.data_ptr(), dc.data_ptr() if dc is not None else None,
                y.data_ptr(), w2.data_ptr(), b2.data_ptr(), x22.data_ptr(),
                n2.data_ptr(), B, T, L, int(cplx), int(d is not None),
                float(np.float32(mu)), QPSK_SCALE if cplx else 1.0,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"eqlms_scan kernel launch failed: CUDA error "
                               f"{rc}")
        eqlms_scan.launches += 1
    return (y.reshape(x.shape), w2.reshape(w.shape), b2.reshape(w.shape),
            x22.reshape(batch), n2.reshape(batch))


eqlms_scan.launches = 0
