"""symtrack's carrier PLL + decision-directed LMS over the symsync slots:
a Hopper kernel for the JAX package's ``lax.scan`` of the ``post`` step
(`liquid_dsp_tpu/framing/symtrack.py:218-267`, driven at `:301-306` on
the sequential route).  The JAX package has no Pallas kernel here;
PyTorch has no device-side scan, and a Python loop would launch about
seventy ops per slot.

`pll_lms` launches the CUDA kernel ``csrc/pll_lms.cu`` on a CUDA tensor
and runs `pll_lms_reference`, the same loop in plain PyTorch, on a CPU
tensor; any other device raises.  Per slot s of channel b (all-real, on
re/im planes):

    v = sym * exp(-j theta);  r = nearest(v);  e = angle(v conj(r))
    dtheta += beta2 e;  theta += dtheta + alpha e
    buf <- [buf[1:], v];  x2 += |v|^2 - |buf_oldest|^2
    y = sum(conj(w) buf);  d = nearest(y)
    w += (n+1 >= L) mu / max(x2, 1e-12) * conj(d - y) buf

with every state update gated by the slot's valid flag, and outputs (y,
the index of d) on every slot.  `nearest` is the JAX package's: the
quadrant sign slicer for a QPSK-like table (`slicer_config`), else the
first argmin of |v - t|^2 over the table.

The kernel runs one warp per channel and walks the valid slots only (the
state changes nowhere else); an invalid slot's output is the same dot
with the state frozen at the last valid slot before it, computed off the
chain.  tests/test_torch_kernel_identities.py shows both identities, and
the kernel's way to the next partial dot, on this plain version.

The two versions compute in float32, the plain one with libm's cos, sin
and atan2, the kernel with sincosf, a polynomial atan2 (7e-8 rad) and a
fast division for the gain, and they sum the length-L dot in another
order and association; so they agree to the stream tolerance of the
reference's own tests (2e-4, decisions equal), not bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["LMAX", "STATE_KEYS", "slicer_config", "nearest", "pll_lms_step",
           "pll_lms", "pll_lms_reference"]

LMAX = 32          # largest equalizer length the kernel holds in registers
STATE_KEYS = ("theta", "dtheta", "ew_re", "ew_im", "eb_re", "eb_im",
              "eq_x2", "eq_n")


def slicer_config(table):
    """The QPSK sign-slicer parameters (s, (k00, k01, k10, k11)) of a
    table whose 4 points sit at (+-s, +-s), else None (argmin slicer).
    k_ab is the index of the point at ((-1)^a s, (-1)^b s)."""
    table = np.asarray(table).astype(np.complex64)
    tr, ti = table.real, table.imag
    s2v = float(np.abs(tr[0]))
    if not (len(tr) == 4 and np.allclose(np.abs(tr), s2v)
            and np.allclose(np.abs(ti), s2v)):
        return None
    qmap = np.zeros(4, np.int32)            # [2*(re<0) + (im<0)] -> index
    for a in (0, 1):
        for b in (0, 1):
            pt = ((-1 if a else 1) * s2v, (-1 if b else 1) * s2v)
            qmap[2 * a + b] = int(np.argmin((tr - pt[0]) ** 2
                                            + (ti - pt[1]) ** 2))
    return s2v, tuple(int(q) for q in qmap)


def nearest(v_re, v_im, tab_re, tab_im, qpsk):
    """(index int32, point re, point im) of the nearest table point."""
    if qpsk is not None:
        s2v, (k00, k01, k10, k11) = qpsk
        a = (v_re < 0).to(torch.int32)
        b = (v_im < 0).to(torch.int32)
        idx = (k00 + (k10 - k00) * a + (k01 - k00) * b
               + (k11 - k10 - k01 + k00) * a * b)
        r_re = torch.where(v_re < 0, -s2v, s2v).to(torch.float32)
        r_im = torch.where(v_im < 0, -s2v, s2v).to(torch.float32)
        return idx, r_re, r_im
    dr = v_re[..., None] - tab_re
    di = v_im[..., None] - tab_im
    idx = torch.argmin(dr * dr + di * di, dim=-1)
    return idx.to(torch.int32), tab_re[idx], tab_im[idx]


def pll_lms_step(c, s_re, s_im, vm, tab_re, tab_im, *, alpha: float,
                 beta2: float, mu: float, qpsk):
    """One slot of the PLL + LMS on [B] planes; c holds STATE_KEYS.
    Returns (c', (y_re, y_im, decision))."""
    L = c["ew_re"].shape[-1]
    cth = torch.cos(c["theta"])
    sth = torch.sin(c["theta"])
    v_re = s_re * cth + s_im * sth
    v_im = s_im * cth - s_re * sth
    _, r_re, r_im = nearest(v_re, v_im, tab_re, tab_im, qpsk)
    e = torch.atan2(v_im * r_re - v_re * r_im, v_re * r_re + v_im * r_im)
    dtheta_n = c["dtheta"] + beta2 * e
    theta_n = c["theta"] + dtheta_n + alpha * e
    b_re = torch.cat([c["eb_re"][..., 1:], v_re[..., None]], dim=-1)
    b_im = torch.cat([c["eb_im"][..., 1:], v_im[..., None]], dim=-1)
    x2 = v_re * v_re + v_im * v_im
    x2_sum = c["eq_x2"] + x2 - (c["eb_re"][..., 0] ** 2
                                + c["eb_im"][..., 0] ** 2)
    w_re, w_im = c["ew_re"], c["ew_im"]
    y_re = torch.sum(w_re * b_re + w_im * b_im, dim=-1)
    y_im = torch.sum(w_re * b_im - w_im * b_re, dim=-1)
    dec, d_re, d_im = nearest(y_re, y_im, tab_re, tab_im, qpsk)
    e_re = d_re - y_re
    e_im = d_im - y_im
    n = c["eq_n"] + 1
    gate = (n >= L).to(torch.float32)
    g = ((gate * mu) / torch.clamp(x2_sum, min=1e-12))[..., None]
    w_re = w_re + g * (e_re[..., None] * b_re + e_im[..., None] * b_im)
    w_im = w_im + g * (e_re[..., None] * b_im - e_im[..., None] * b_re)
    vme = vm[..., None]
    new = {"theta": torch.where(vm, theta_n, c["theta"]),
           "dtheta": torch.where(vm, dtheta_n, c["dtheta"]),
           "ew_re": torch.where(vme, w_re, c["ew_re"]),
           "ew_im": torch.where(vme, w_im, c["ew_im"]),
           "eb_re": torch.where(vme, b_re, c["eb_re"]),
           "eb_im": torch.where(vme, b_im, c["eb_im"]),
           "eq_x2": torch.where(vm, x2_sum, c["eq_x2"]),
           "eq_n": torch.where(vm, n, c["eq_n"])}
    return new, (y_re, y_im, dec)


def pll_lms_reference(s_re, s_im, valid, state, tab_re, tab_im, *,
                      alpha: float, beta2: float, mu: float, qpsk):
    """Plain PyTorch version: a loop over the S slots on [B] tensors.
    s_re, s_im [B, S] f32, valid [B, S] bool, state {STATE_KEYS} ([B] or
    [B, L]) -> (y_re, y_im [B, S] f32, decisions [B, S] int32, state')."""
    c = dict(state)
    ys_re, ys_im, decs = [], [], []
    for s in range(s_re.shape[-1]):
        c, (y_re, y_im, dec) = pll_lms_step(
            c, s_re[:, s], s_im[:, s], valid[:, s], tab_re, tab_im,
            alpha=alpha, beta2=beta2, mu=mu, qpsk=qpsk)
        ys_re.append(y_re)
        ys_im.append(y_im)
        decs.append(dec)
    if not decs:
        z = s_re.new_zeros(s_re.shape)
        return z, z.clone(), z.to(torch.int32), c
    return (torch.stack(ys_re, -1), torch.stack(ys_im, -1),
            torch.stack(decs, -1), c)


def _check(s_re, s_im, valid, state, tab_re, tab_im):
    if s_re.dim() != 2 or s_im.shape != s_re.shape or \
            valid.shape != s_re.shape:
        raise ValueError(f"pll_lms takes s_re, s_im and valid [B, S], got "
                         f"{tuple(s_re.shape)}, {tuple(s_im.shape)} and "
                         f"{tuple(valid.shape)}")
    B = s_re.shape[0]
    L = state["ew_re"].shape[-1]
    for key in STATE_KEYS:
        want = (B, L) if key[:3] in ("ew_", "eb_") else (B,)
        if tuple(state[key].shape) != want:
            raise ValueError(f"pll_lms state {key!r} must be {want}, got "
                             f"{tuple(state[key].shape)}")
    tensors = [s_re, s_im, valid, tab_re, tab_im] + [state[k] for k in
                                                     STATE_KEYS]
    if any(t.device != s_re.device for t in tensors):
        raise ValueError("pll_lms: all tensors must be on one device")
    if (valid.dtype != torch.bool or state["eq_n"].dtype != torch.int32
            or any(t.dtype != torch.float32 for t in tensors
                   if t is not valid and t is not state["eq_n"])):
        raise ValueError("pll_lms takes float32 planes, table and state, a "
                         "bool valid mask and an int32 eq_n")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("pll_lms takes contiguous tensors")
    if tab_re.shape != tab_im.shape or tab_re.dim() != 1:
        raise ValueError(f"pll_lms takes a table [M] as re and im, got "
                         f"{tuple(tab_re.shape)} and {tuple(tab_im.shape)}")


def pll_lms(s_re, s_im, valid, state, tab_re, tab_im, *, alpha: float,
            beta2: float, mu: float, qpsk):
    """Carrier PLL + decision-directed LMS over the slots of a block.

    s_re, s_im [B, S] f32 symsync outputs, valid [B, S] bool, state
    {STATE_KEYS}: theta, dtheta, eq_x2 [B] f32, eq_n [B] int32, ew_re,
    ew_im, eb_re, eb_im [B, L] f32; tab_re, tab_im [M] the constellation;
    qpsk from `slicer_config`.  Returns (y_re, y_im [B, S] f32,
    decisions [B, S] int32, state').

    A CUDA tensor launches the kernel (and counts the launch in
    ``pll_lms.launches``; L <= LMAX there, else ValueError);
    a CPU tensor runs the plain version.
    """
    _check(s_re, s_im, valid, state, tab_re, tab_im)
    kw = dict(alpha=alpha, beta2=beta2, mu=mu, qpsk=qpsk)
    if s_re.device.type == "cpu":
        return pll_lms_reference(s_re, s_im, valid, state, tab_re, tab_im,
                                 **kw)
    if s_re.device.type != "cuda":
        raise ValueError(f"pll_lms runs on CUDA (kernel) or CPU (plain "
                         f"version) tensors, got device {s_re.device}")
    B, S = s_re.shape
    L, M = state["ew_re"].shape[-1], tab_re.shape[0]
    if not 1 <= L <= LMAX:
        raise ValueError(f"pll_lms kernel takes 1 <= L <= {LMAX} equalizer "
                         f"taps, got {L}")
    dev = s_re.device
    st = {key: state[key].clone(memory_format=torch.contiguous_format)
          for key in STATE_KEYS}
    y_re = torch.empty(B, S, dtype=torch.float32, device=dev)
    y_im = torch.empty_like(y_re)
    dec = torch.empty(B, S, dtype=torch.int32, device=dev)
    if B == 0 or S == 0:
        return y_re, y_im, dec, st
    from .build import load_library
    lib = load_library()
    s2v, kq = qpsk if qpsk is not None else (0.0, (0, 0, 0, 0))
    with torch.cuda.device(dev):
        rc = lib.pll_lms_launch(
            s_re.data_ptr(), s_im.data_ptr(), valid.data_ptr(),
            *(st[key].data_ptr() for key in STATE_KEYS),
            tab_re.data_ptr(), tab_im.data_ptr(), y_re.data_ptr(),
            y_im.data_ptr(), dec.data_ptr(), B, S, L, M,
            int(qpsk is not None), *kq, float(alpha), float(beta2),
            float(mu), float(s2v), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pll_lms kernel launch failed: CUDA error {rc}")
    pll_lms.launches += 1
    return y_re, y_im, dec, st


pll_lms.launches = 0
