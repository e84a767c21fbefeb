"""The AGC gain recurrence over instantaneous power: a Hopper kernel for
the JAX package's ``lax.scan`` in `liquid_dsp_tpu/ops/agc.py:39-50`
(`agc_scan` and the agc Proc's `planar_apply`).  The JAX package has no
Pallas kernel here; PyTorch has no device-side scan, and a Python loop
would launch about ten ops per sample.

`agc_scan` launches the CUDA kernel ``csrc/agc_scan.cu`` on a CUDA tensor
and runs `agc_scan_reference`, the same loop in plain PyTorch, on a CPU
tensor; any other device raises.  Per channel and sample, in the JAX
package's order (the scaling x * g stays outside, as there):

    y2p = (1-alpha)*y2p + (alpha*(g*g))*p
    g_out[t] = g
    g = y2p > 1e-6 ? g * exp((-alpha/2) * log(y2p)) : g;  g = min(g, 1e6)

(the gain update skipped when locked).  The constants 1-alpha, alpha and
-alpha/2 are formed in double and rounded to float32 once, as the JAX
package's weak-typed Python constants are.  Neither version fuses a
multiply into an add, so on the card the kernel equals the plain version
bit for bit where expf/logf agree with PyTorch's exp/log.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["agc_consts", "agc_scan", "agc_scan_reference"]


def agc_consts(alpha: float):
    """(1-alpha, alpha, -alpha/2) rounded to float32 once."""
    return (float(np.float32(1.0 - alpha)), float(np.float32(alpha)),
            float(np.float32(-0.5 * alpha)))


def agc_scan_reference(p, g, y2p, *, alpha: float, locked: bool = False):
    """Plain PyTorch version: a loop over the T samples on [B] tensors.
    p [B, T] f32, g and y2p [B] f32 -> (gains [B, T], g', y2p')."""
    c1, ca, ch = agc_consts(alpha)
    gains = []
    for t in range(p.shape[-1]):
        y2p = c1 * y2p + (ca * (g * g)) * p[:, t]
        gains.append(g)
        if not locked:
            g = torch.where(y2p > 1e-6, g * torch.exp(ch * torch.log(y2p)), g)
            g = g.clamp(max=1e6)
    if not gains:
        return p.new_zeros(p.shape), g, y2p
    return torch.stack(gains, dim=-1), g, y2p


def _check(p, g, y2p):
    if p.dim() != 2 or g.shape != (p.shape[0],) or y2p.shape != g.shape:
        raise ValueError(f"agc_scan takes p [B, T], g [B] and y2p [B], got "
                         f"{tuple(p.shape)}, {tuple(g.shape)} and "
                         f"{tuple(y2p.shape)}")
    if any(t.dtype != torch.float32 for t in (p, g, y2p)):
        raise ValueError(f"agc_scan takes float32 tensors, got {p.dtype}, "
                         f"{g.dtype} and {y2p.dtype}")
    if g.device != p.device or y2p.device != p.device:
        raise ValueError(f"agc_scan: all tensors must be on one device, got "
                         f"{p.device}, {g.device} and {y2p.device}")
    if not p.is_contiguous():
        raise ValueError("agc_scan takes a contiguous p")


def agc_scan(p, g, y2p, *, alpha: float, locked: bool = False):
    """Per-sample gains of the AGC loop over power p [B, T] from the
    carry (g, y2p) [B]: returns (gains [B, T] f32, g', y2p').

    A CUDA tensor launches the kernel (and counts the launch in
    ``agc_scan.launches``); a CPU tensor runs the plain version.
    """
    _check(p, g, y2p)
    if p.device.type == "cpu":
        return agc_scan_reference(p, g, y2p, alpha=alpha, locked=locked)
    if p.device.type != "cuda":
        raise ValueError(f"agc_scan runs on CUDA (kernel) or CPU (plain "
                         f"version) tensors, got device {p.device}")
    B, T = p.shape
    gains = torch.empty_like(p)
    g2 = g.clone(memory_format=torch.contiguous_format)
    y2 = y2p.clone(memory_format=torch.contiguous_format)
    if B == 0 or T == 0:
        return gains, g2, y2
    from .build import load_library
    lib = load_library()
    c1, ca, ch = agc_consts(alpha)
    with torch.cuda.device(p.device):
        rc = lib.agc_scan_launch(
            p.data_ptr(), g2.data_ptr(), y2.data_ptr(), gains.data_ptr(), B,
            T, int(bool(locked)), c1, ca, ch,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"agc_scan kernel launch failed: CUDA error {rc}")
    agc_scan.launches += 1
    return gains, g2, y2


agc_scan.launches = 0
