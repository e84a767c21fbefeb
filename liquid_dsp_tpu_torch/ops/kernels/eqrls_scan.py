"""The RLS equalizer's per-sample recurrence: a Hopper kernel for the JAX
package's ``lax.scan`` in `liquid_dsp_tpu/ops/equalize.py:125-151`
(`eqrls_run`, trained).  The JAX package has no Pallas kernel here.

`eqrls_scan` launches the CUDA kernel ``csrc/eqrls_scan.cu`` on a CUDA
tensor and runs `eqrls_scan_reference`, the same loop in plain PyTorch,
on a CPU tensor; any other device raises.  Per channel and sample, with
the window of the last L inputs oldest first and P the L x L matrix:

    buf  <- [buf[1:], x]
    y     = tree_i conj(w_i) buf_i;            e = d - y
    Px_i  = live_j P_ij buf_j
    den   = lam + tree_i Re(conj(buf_i) Px_i);  rden = 1 / den
    k_i   = Px_i * rden
    w_i  <- w_i + k_i conj(e)
    r_l   = live_i conj(buf_i) P_il             (the column product buf^H P)
    P_il <- (P_il - k_i r_l) * (1/lam)          (1/lam: float32 of 1/f32(lam))

tree is the warp's butterfly over LM = `lanes(L)` row lanes (the eqlms
kernel's `lane_tree`, the terms padded with zeros); live is `live_tree`,
the same levels over the L live columns (or rows) only, as the kernel sums
them in registers.  The column product is taken as written, never as (P
buf)^H: P does not stay exactly Hermitian under this update
(tests/test_torch_eq_identities.py), so the shortcut is another function.
Every operation is rounded once in the order written (complex products on
the planes: (a, b)(c, d) = (ac - bd, ad + bc), conj(a, b)(c, d) = (ac +
bd, ad - bc)), so on the card the kernel equals the plain version bit for
bit.  Against the JAX package, which divides by den and by lam and
contracts its einsums in its own order, the two agree to 1e-5 (y, w) and
1e-4 (P).

The kernel holds 1 <= L <= 32 taps (a row of P on one lane, or on two at
2 <= L <= 16); the wrapper raises on more.  The plain version takes any
L.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .eqlms_scan import LMAX, _join, _pad, _planes, lane_tree, lanes

__all__ = ["live_tree", "rls_consts", "eqrls_scan", "eqrls_scan_reference"]


def live_tree(v, dim: int = -1):
    """The butterfly's levels over the live entries of `dim` only: at each
    level o (halving from half the power of two >= n) entry j takes v[j] +
    v[j + o] while j + o is still live, else keeps v[j].  For n a power of
    two it is `lane_tree`; the tree over all n equals the even entries'
    tree plus the odd entries' (the kernel's two lanes a row)."""
    n = v.shape[dim]
    o = (1 << (n - 1).bit_length()) // 2 if n > 1 else 0
    while o:
        if n > o:
            v = torch.cat([v.narrow(dim, 0, n - o) + v.narrow(dim, o, n - o),
                           v.narrow(dim, n - o, 2 * o - n)], dim)
            n = o
        o //= 2
    return v.squeeze(dim)


def rls_consts(lam: float):
    """(lam, 1/lam) as the recurrence sees them: the float32 lam and its
    float32 reciprocal."""
    lf = np.float32(lam)
    return float(lf), float(np.float32(1) / lf)


def eqrls_scan_reference(x, d, w, buf, P, lam: float):
    """Plain PyTorch version: a loop over the T samples on the (re, im)
    planes, the sums over rows of y and den padded to LM lanes.  x, d
    [..., T]; w, buf [..., L]; P [..., L, L] (all complex64 or all
    float32) -> (y [..., T], w', buf', P')."""
    cplx = w.is_complex()
    L, T = w.shape[-1], x.shape[-1]
    LM = lanes(L)
    dev = x.device
    lf, il = rls_consts(lam)
    wr, wi = _planes(w)
    br, bi = _planes(buf)
    Pr, Pi = _planes(P)
    xr, xi = _planes(x)
    dr, di = _planes(d)
    one = torch.ones((), device=dev)
    yr_t, yi_t = [], []
    for t in range(T):
        br = torch.cat([br[..., 1:], xr[..., t, None]], -1)
        bi = torch.cat([bi[..., 1:], xi[..., t, None]], -1)
        yr = lane_tree(_pad(wr * br + wi * bi, LM))
        yi = lane_tree(_pad(wr * bi - wi * br, LM))
        er, ei = dr[..., t] - yr, di[..., t] - yi
        cr, ci = br[..., None, :], bi[..., None, :]
        pxr = live_tree(Pr * cr - Pi * ci)
        pxi = live_tree(Pr * ci + Pi * cr)
        rden = one / (lane_tree(_pad(br * pxr + bi * pxi, LM)) + lf)
        kr, ki = pxr * rden[..., None], pxi * rden[..., None]
        er, ei = er[..., None], ei[..., None]
        wr = wr + (kr * er + ki * ei)
        wi = wi + (ki * er - kr * ei)
        cr, ci = br[..., :, None], bi[..., :, None]
        rr = live_tree(cr * Pr + ci * Pi, dim=-2)[..., None, :]
        ri = live_tree(cr * Pi - ci * Pr, dim=-2)[..., None, :]
        kr, ki = kr[..., :, None], ki[..., :, None]
        Pr = (Pr - (kr * rr - ki * ri)) * il
        Pi = (Pi - (kr * ri + ki * rr)) * il
        yr_t.append(yr)
        yi_t.append(yi)
    if T == 0:
        y = torch.zeros(x.shape, dtype=w.dtype, device=dev)
    else:
        y = _join(torch.stack(yr_t, -1), torch.stack(yi_t, -1), cplx)
    return (y, *(_join(re, im, cplx).clone()
                 for re, im in ((wr, wi), (br, bi), (Pr, Pi))))


def _check(x, d, w, buf, P):
    if w.dim() < 1 or w.shape[-1] < 1 or buf.shape != w.shape or \
            P.shape != w.shape + w.shape[-1:]:
        raise ValueError(f"eqrls_scan takes w and buf [..., L], L >= 1, and "
                         f"P [..., L, L], got {tuple(w.shape)}, "
                         f"{tuple(buf.shape)} and {tuple(P.shape)}")
    if x.shape[:-1] != w.shape[:-1] or d.shape != x.shape:
        raise ValueError(f"eqrls_scan: x and d [..., T] on the carry's batch "
                         f"shape {tuple(w.shape[:-1])}, got {tuple(x.shape)} "
                         f"and {tuple(d.shape)}")
    ts = [x, d, w, buf, P]
    if w.dtype not in (torch.complex64, torch.float32) or \
            any(t.dtype != w.dtype for t in ts):
        raise ValueError(f"eqrls_scan takes x, d, w, buf and P all complex64 "
                         f"or all float32, got {[t.dtype for t in ts]}")
    if any(t.device != x.device for t in ts):
        raise ValueError(f"eqrls_scan: all tensors must be on one device, "
                         f"got {[str(t.device) for t in ts]}")


def eqrls_scan(x, d, w, buf, P, lam: float):
    """Trained RLS over a block: the outputs y [..., T] and the carry (w,
    buf, P) after it (new tensors; the inputs are not changed).

    A CUDA tensor launches the kernel (and counts the launch in
    ``eqrls_scan.launches``); a CPU tensor runs the plain version.
    """
    _check(x, d, w, buf, P)
    if x.device.type == "cpu":
        return eqrls_scan_reference(x, d, w, buf, P, lam)
    if x.device.type != "cuda":
        raise ValueError(f"eqrls_scan runs on CUDA (kernel) or CPU (plain "
                         f"version) tensors, got device {x.device}")
    L, T = w.shape[-1], x.shape[-1]
    if L > LMAX:
        raise ValueError(f"eqrls_scan's kernel takes 1 to {LMAX} taps, got "
                         f"{L}")
    batch = w.shape[:-1]
    B = math.prod(batch)
    w2 = w.reshape(B, L).clone(memory_format=torch.contiguous_format)
    b2 = buf.reshape(B, L).clone(memory_format=torch.contiguous_format)
    P2 = P.reshape(B, L, L).clone(memory_format=torch.contiguous_format)
    y = torch.empty((B, T), dtype=w.dtype, device=x.device)
    if B and T:
        xc = x.reshape(B, T).contiguous()
        dc = d.reshape(B, T).contiguous()
        lf, il = rls_consts(lam)
        from .build import load_library
        lib = load_library()
        with torch.cuda.device(x.device):
            rc = lib.eqrls_scan_launch(
                xc.data_ptr(), dc.data_ptr(), y.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), P2.data_ptr(), B, T, L, int(w.is_complex()),
                lf, il, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"eqrls_scan kernel launch failed: CUDA error "
                               f"{rc}")
        eqrls_scan.launches += 1
    return (y.reshape(x.shape), w2.reshape(w.shape), b2.reshape(w.shape),
            P2.reshape(P.shape))


eqrls_scan.launches = 0
