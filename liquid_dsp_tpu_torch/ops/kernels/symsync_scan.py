"""The symsync timing loop over precomputed branch outputs: the Hopper
port of `liquid_dsp_tpu/ops/kernels/pallas_symsync.py:symsync_scan_pallas`,
behind the hoisted symsync path (`ops/symsync._symsync_run_hoisted`).

`symsync_scan` launches the CUDA kernel ``csrc/symsync_scan.cu`` on a
CUDA tensor and runs `symsync_scan_reference`, the same loop in plain
PyTorch, on a CPU tensor; any other device raises.  The kernel runs one
warp per channel: lane 0 carries the loop with its state in registers and
runs only the emits that do something (an inactive emit after a freshly
computed bi >= npfb is a no-op; see the source's note and
tests/test_torch_kernel_identities.py), the other lanes stage the branch
rows around the current branch in shared memory one tile ahead and write
the outputs in full lines.  The loop is bound by the latency of its
dependent steps.

Layout: the branch outputs come as conv1d leaves them, ``ma [P, B,
2*npfb, Tc]`` (P = 1 plane for a real stream, 2 for re and im; rows
0..npfb-1 the matched filter, npfb..2*npfb-1 its derivative), so each
channel walks its own contiguous time axis and no [Tc, B, G*npfb]
transpose is made.  The TPU kernel's ``ma[t, b, g*npfb + j]`` is
``ma[g // 2, b, (g % 2)*npfb + j, t]`` here.  The state keeps the TPU
kernel's form: fstate [6, B] f32 (tau, rate, del, v0, bf, ran-any) and
istate [2, B] int32 (b, decim).

Both versions follow the TPU kernel's expressions in order, with the
loop constants rounded to float32 once from Python doubles, and read the
selected branch values directly (the TPU kernel's one-hot lane sum gives
the same number on finite inputs).  XLA compiles that kernel (and the
JAX scan it equals) with three of its products contracted into fused
multiply-adds, each rounded once:

    q_raw = fma(mf_re, dmf_re, mf_im * dmf_im)
    q_hat = fma(B0/A0, q, v0)
    rate' = fma(rate_adj, q_hat, rate)

Both versions take an FMA at exactly these three places and round every
other operation on its own (`fma32` computes it exactly in float64), and
scale the output by 1/k rounded in float32, as XLA folds the division by
k; so they agree bit for bit with each other and with the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["loop_consts", "inverse_k", "fma32", "symsync_scan",
           "symsync_scan_reference"]


def loop_consts(bw: float):
    """(B0/A0, -A1/A0, rate_adj) of the loop filter (reference symsync.c
    set_lf_bw:380-407: B0 = 0.22 bw, A0 = 1 - 0.5 (1-bw), A1 = -0.495
    (1-bw)), formed in double and rounded to float32 once, as the JAX
    package's weak-typed Python constants are."""
    b0 = 0.22 * bw
    a0 = 1.0 - 0.5 * (1.0 - bw)
    a1 = -0.495 * (1.0 - bw)
    return (float(np.float32(b0 / a0)), float(np.float32(-(a1 / a0))),
            float(np.float32(0.5 * bw)))


def inverse_k(k: int) -> float:
    """1/k rounded in float32: XLA turns the JAX kernel's division by the
    constant k into a multiply by it (the same number as mf / k for
    k = 2)."""
    return float(np.float32(1.0) / np.float32(k))


def fma32(a, b, c):
    """a*b + c for float32 tensors with one rounding, as CUDA's fmaf: the
    product is exact in float64, TwoSum gives the sum's float64 rounding
    error, and a sum that lands exactly between two floats is rounded
    toward the side the error points to."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    z = s - p
    err = (p - (s - z)) + (cd - z)          # s + err == a*b + c exactly
    r = s.float()
    d = s - r.double()
    other = torch.nextafter(r, torch.where(d > 0, torch.inf, -torch.inf))
    tie = (d != 0) & (r.double() + other.double() == 2.0 * s)
    return torch.where(tie & (err * d > 0), other, r)


def symsync_scan_reference(ma, fstate, istate, *, npfb: int, max_out: int,
                           k: int, k_out: int, bw: float, locked: bool,
                           post=None, post_carry=None):
    """Plain PyTorch version: a loop over the Tc steps, `max_out` emits
    each, on [B] tensors.  Returns (y_re, y_im [B, Tc*max_out] f32, valid
    [B, Tc*max_out] bool, fstate', istate'); y_im is zero for P = 1.

    post(pc, y_re, y_im, active) -> (pc', extras) runs after every emit
    (symtrack's fused PLL + LMS); with it the return gains (extras
    stacked to [B, Tc*max_out] each, pc')."""
    P, B, _, Tc = ma.shape
    c_q, c_v, c_r = loop_consts(bw)
    cq = torch.full((B,), c_q, dtype=torch.float32, device=ma.device)
    cr = torch.full((B,), c_r, dtype=torch.float32, device=ma.device)
    rows = ma.permute(3, 1, 0, 2).reshape(Tc, B, 2 * P, npfb)
    tau, rate, dl, v0, bf, ran = fstate.clone().unbind(0)
    b, decim = istate.clone().unbind(0)
    ys_re, ys_im, vals, extras = [], [], [], []
    zero = torch.zeros((), dtype=torch.float32, device=ma.device)
    inv_k = inverse_k(k)
    pc = post_carry
    for t in range(Tc):
        row = rows[t]
        for _ in range(max_out):
            active = b < npfb
            bc = b.clamp(0, npfb - 1).long()
            sel = row.gather(2, bc.view(B, 1, 1).expand(B, 2 * P, 1))[..., 0]
            mf_re, dmf_re = sel[:, 0], sel[:, 1]
            if P == 2:
                mf_im, dmf_im = sel[:, 2], sel[:, 3]
                q_raw = fma32(mf_re, dmf_re, mf_im * dmf_im)
            else:
                mf_im = torch.zeros_like(mf_re)
                q_raw = mf_re * dmf_re
            run = (decim == k_out) & active & (not locked)
            q = q_raw.clamp(-1.0, 1.0)
            q_hat = fma32(cq, q, v0)
            v0n = c_v * q_hat
            rn = fma32(cr, q_hat, rate)
            dn = rn + q_hat
            tau = tau + torch.where(active, dl, zero)
            rate = torch.where(run, rn, rate)
            dl = torch.where(run, dn, dl)
            v0 = torch.where(run, v0n, v0)
            decim = torch.where(active, torch.where(decim == k_out, 1,
                                                    decim + 1), decim)
            bf = tau * npfb
            b = torch.round(bf).to(torch.int32)
            y_re = torch.where(active, mf_re * inv_k, zero)
            y_im = torch.where(active, mf_im * inv_k, zero)
            ran = torch.maximum(ran, run.to(torch.float32))
            ys_re.append(y_re)
            ys_im.append(y_im)
            vals.append(active)
            if post is not None:
                pc, ex = post(pc, y_re, y_im, active)
                extras.append(ex)
        tau = tau - 1.0
        bf = bf - npfb
        b = b - npfb
    fs = torch.stack([tau, rate, dl, v0, bf, ran])
    is_ = torch.stack([b, decim])
    out = (_stack(ys_re, B, ma.device), _stack(ys_im, B, ma.device),
           _stack(vals, B, ma.device, torch.bool), fs, is_)
    if post is None:
        return out
    ex = tuple(_stack([e[j] for e in extras], B, ma.device) for j in range(
        len(extras[0]))) if extras else ()
    return out + (ex, pc)


def _stack(xs, B, device, dtype=torch.float32):
    if not xs:
        return torch.zeros(B, 0, dtype=dtype, device=device)
    return torch.stack(xs, dim=-1)


def _check(ma, fstate, istate, npfb, max_out):
    if ma.dim() != 4 or ma.shape[0] not in (1, 2) or ma.shape[2] != 2 * npfb:
        raise ValueError(f"symsync_scan takes ma [P in (1, 2), B, 2*npfb="
                         f"{2 * npfb}, Tc], got {tuple(ma.shape)}")
    B = ma.shape[1]
    if fstate.shape != (6, B) or istate.shape != (2, B):
        raise ValueError(f"symsync_scan takes fstate [6, {B}] and istate "
                         f"[2, {B}], got {tuple(fstate.shape)} and "
                         f"{tuple(istate.shape)}")
    if (ma.dtype != torch.float32 or fstate.dtype != torch.float32
            or istate.dtype != torch.int32):
        raise ValueError(f"symsync_scan takes float32 ma and fstate and "
                         f"int32 istate, got {ma.dtype}, {fstate.dtype} and "
                         f"{istate.dtype}")
    if fstate.device != ma.device or istate.device != ma.device:
        raise ValueError(f"symsync_scan: all tensors must be on one device, "
                         f"got {ma.device}, {fstate.device} and "
                         f"{istate.device}")
    if not ma.is_contiguous():
        raise ValueError("symsync_scan takes a contiguous ma")
    if not (1 <= npfb and 1 <= max_out):
        raise ValueError(f"symsync_scan: npfb={npfb}, max_out={max_out}")


def symsync_scan(ma, fstate, istate, *, npfb: int, max_out: int, k: int,
                 k_out: int, bw: float, locked: bool):
    """Run the timing loop over one chunk of branch outputs.

    ma [P, B, 2*npfb, Tc] f32; fstate [6, B] f32; istate [2, B] int32.
    Returns (y_re, y_im [B, Tc*max_out] f32, valid [B, Tc*max_out] bool,
    fstate', istate'), slot t*max_out + e for emit e of step t.

    A CUDA tensor launches the kernel (and counts the launch in
    ``symsync_scan.launches``); a CPU tensor runs the plain version.
    """
    _check(ma, fstate, istate, npfb, max_out)
    kw = dict(npfb=npfb, max_out=max_out, k=k, k_out=k_out, bw=bw,
              locked=locked)
    if ma.device.type == "cpu":
        return symsync_scan_reference(ma, fstate, istate, **kw)
    if ma.device.type != "cuda":
        raise ValueError(f"symsync_scan runs on CUDA (kernel) or CPU (plain "
                         f"version) tensors, got device {ma.device}")
    P, B, _, Tc = ma.shape
    dev = ma.device
    y_re = torch.empty(B, Tc * max_out, dtype=torch.float32, device=dev)
    y_im = torch.empty_like(y_re)
    valid = torch.empty(B, Tc * max_out, dtype=torch.bool, device=dev)
    fs = fstate.clone(memory_format=torch.contiguous_format)
    is_ = istate.clone(memory_format=torch.contiguous_format)
    if B == 0 or Tc == 0:
        return y_re, y_im, valid, fs, is_
    from .build import load_library
    lib = load_library()
    c_q, c_v, c_r = loop_consts(bw)
    with torch.cuda.device(dev):
        rc = lib.symsync_scan_launch(
            ma.data_ptr(), fs.data_ptr(), is_.data_ptr(), y_re.data_ptr(),
            y_im.data_ptr(), valid.data_ptr(), B, Tc, npfb, P, max_out,
            k_out, int(bool(locked)), inverse_k(k), c_q, c_v, c_r,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"symsync_scan kernel launch failed: CUDA error "
                           f"{rc}")
    symsync_scan.launches += 1
    return y_re, y_im, valid, fs, is_


symsync_scan.launches = 0
