"""Mixer + fused FIR + decimation in one pass: the Hopper port of
`liquid_dsp_tpu/ops/kernels/pallas_chain.py:mix_fir_decim`.

`mix_fir_decim` launches the CUDA kernel ``csrc/mix_fir_decim.cu`` on a
CUDA tensor and runs `mix_fir_decim_reference`, the same computation in
plain PyTorch, on a CPU tensor; any other device raises.  On the card the
kernel is bound by the FIR's float32 multiply-adds, not by device-memory
bytes (bf16 planes take the same time as f32): a block walks a few tiles
of a channel, the next tile's raw window in flight while this tile's FIR
runs out of shared memory (see the source's note).

Both versions cut a block into tiles of TILE input samples.  Tile t's
window is the (L-1) samples before it plus its own TILE samples (the
samples before the block come from the carry, the last SUB raw pre-mix
samples of the previous block), mixed by angle addition: the per-tile
phase's (cos, sin) times the host ramp cos/sin(dphi*(k-(L-1))).  The FIR
is the direct form ``y[o] = sum_j h'[j] w[down*o + (L-1) - j]`` with the
strided-output offset folded into the taps (`fold_offset`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..dotprod import conv1d_real

__all__ = ["SUB", "TILE", "fold_offset", "make_ramp", "tile_step",
           "tile_phases",
           "mix_fir_decim", "mix_fir_decim_reference"]

SUB = 256     # carry: raw pre-mix samples kept per channel; taps L <= SUB + 1
TILE = 2048   # input samples per tile (one CUDA block); divides every legal T


def fold_offset(h: np.ndarray, d: int) -> np.ndarray:
    """Fold the strided-output offset d into the taps:
    y[i] = sum_j h[j] x[down*i + d - j] = sum_j h'[j] x[down*i - j]."""
    h = np.asarray(h)
    return np.concatenate([h[d:], np.zeros(d, h.dtype)]) if d else h


def make_ramp(h_len: int, dphi: float):
    """Host (f64 -> f32) mixer ramp in window coordinates:
    cos/sin(dphi*(k - (h_len-1))) for k in [0, TILE + SUB)."""
    k = np.arange(TILE + SUB) - (h_len - 1)
    ramp = dphi * np.asarray(k, np.float64)
    return np.cos(ramp).astype(np.float32), np.sin(ramp).astype(np.float32)


def tile_step(dphi: float) -> float:
    """The phase step from tile to tile, dphi * TILE wrapped, as a float32
    value."""
    return float(np.float32(np.mod(dphi * TILE, 2 * np.pi)))


def tile_phases(theta, dphi: float, T: int):
    """(cos, sin) of each tile's starting phase, wrapped in f32 exactly as
    the TPU kernel's wrapper does (pallas_chain.py:183-187).  The CUDA
    kernel forms the same phases itself, with the same roundings."""
    step = tile_step(dphi)
    ph = theta + step * torch.arange(T // TILE, dtype=torch.float32,
                                     device=theta.device)
    ph = torch.remainder(ph + math.pi, 2 * math.pi) - math.pi
    return torch.cos(ph), torch.sin(ph)


def mix_fir_decim_reference(xr, xi, carry_r, carry_i, theta, ramp_c, ramp_s,
                            taps, *, down: int, sgn: float, dphi: float,
                            out_dtype=torch.float32):
    """Plain PyTorch version of the kernel, vectorised over tiles: same
    per-tile phase, same halo rule, same folded taps.  Runs on any
    device; float32 arithmetic (on CUDA, conv1d follows
    ``torch.backends.cudnn.allow_tf32``)."""
    B, T = xr.shape
    L = int(taps.shape[-1])
    W = TILE + L - 1
    tc, ts = tile_phases(theta, dphi, T)
    ct, st = ramp_c[:W], ramp_s[:W]
    c = tc[:, None] * ct - ts[:, None] * st              # [nt, W]
    s = ts[:, None] * ct + tc[:, None] * st
    if sgn < 0:
        s = -s

    def windows(x, carry):
        xp = torch.cat([carry[:, SUB - (L - 1):], x.float()], dim=-1)
        return xp.unfold(-1, W, TILE)                   # [B, nt, W]

    wr, wi = windows(xr, carry_r), windows(xi, carry_i)
    mr = wr * c - wi * s
    mi = wr * s + wi * c
    yr = conv1d_real(mr, taps, stride=down).reshape(B, T // down)
    yi = conv1d_real(mi, taps, stride=down).reshape(B, T // down)
    return yr.to(out_dtype), yi.to(out_dtype)


def _check(xr, xi, carry_r, carry_i, theta, ramp_c, ramp_s, taps, down,
           out_dtype):
    if xr.dim() != 2 or xi.shape != xr.shape:
        raise ValueError(f"xr/xi must be equal [B, T] planes, got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    B, T = xr.shape
    if xr.dtype not in (torch.float32, torch.bfloat16) or xi.dtype != xr.dtype:
        raise ValueError(f"input planes must both be float32 or bfloat16, "
                         f"got {xr.dtype} and {xi.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, "
                         f"got {out_dtype}")
    if taps.dim() != 1 or taps.dtype != torch.float32:
        raise ValueError("taps must be 1-D real float32")
    L = int(taps.shape[0])
    # the reference's guards (pallas_mix_fir_supported, kernel_fuse)
    if not (L <= SUB + 1 and T % TILE == 0 and SUB % down == 0
            and B % 8 == 0 and theta.dim() == 0):
        raise ValueError(
            f"mix_fir_decim takes L <= {SUB + 1} taps, T % {TILE} == 0, "
            f"{SUB} % down == 0, B % 8 == 0 and a scalar theta; got L={L}, "
            f"T={T}, down={down}, B={B}, theta {tuple(theta.shape)}")
    for name, cr in (("carry_r", carry_r), ("carry_i", carry_i)):
        if cr.shape != (B, SUB) or cr.dtype != torch.float32:
            raise ValueError(f"{name} must be [B, {SUB}] float32, got "
                             f"{tuple(cr.shape)} {cr.dtype}")
    for name, r in (("ramp_c", ramp_c), ("ramp_s", ramp_s)):
        if r.dim() != 1 or r.shape[0] < TILE + L - 1 or r.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 of length >= "
                             f"{TILE + L - 1}")
    if theta.dtype != torch.float32:
        raise ValueError("theta must be float32")
    tensors = (xr, xi, carry_r, carry_i, theta, ramp_c, ramp_s, taps)
    if any(t.device != xr.device for t in tensors):
        raise ValueError("mix_fir_decim: all tensors must be on one device, "
                         f"got {sorted({str(t.device) for t in tensors})}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mix_fir_decim takes contiguous tensors")
    if xr.data_ptr() % 16 or xi.data_ptr() % 16:
        raise ValueError("mix_fir_decim takes input planes that start on a "
                         "16-byte boundary")


def mix_fir_decim(xr, xi, carry_r, carry_i, theta, ramp_c, ramp_s, taps, *,
                  down: int, sgn: float, dphi: float, out_dtype=torch.float32):
    """One streaming block through the fused mixer + FIR + decimator.

    xr/xi [B, T] float32 or bfloat16 input planes; carry_[ri] [B, SUB]
    float32: the last SUB pre-mix input samples of the previous block
    (zeros initially); theta: scalar float32 NCO phase at the first
    sample; ramp_c/s from `make_ramp`; taps: the folded float32 taps.
    Arithmetic is float32 throughout.  Returns (yr, yi) [B, T//down]
    out_dtype.  The caller advances theta by dphi*T (wrapped) and keeps
    x[..., -SUB:] as the next carry.

    A CUDA tensor launches the kernel (and counts the launch in
    ``mix_fir_decim.launches``); a CPU tensor runs the plain version.
    """
    _check(xr, xi, carry_r, carry_i, theta, ramp_c, ramp_s, taps, down,
           out_dtype)
    if xr.device.type == "cpu":
        return mix_fir_decim_reference(
            xr, xi, carry_r, carry_i, theta, ramp_c, ramp_s, taps,
            down=down, sgn=sgn, dphi=dphi, out_dtype=out_dtype)
    if xr.device.type != "cuda":
        raise ValueError(f"mix_fir_decim runs on CUDA (kernel) or CPU (plain "
                         f"version) tensors, got device {xr.device}")
    from .build import load_library
    lib = load_library()
    B, T = xr.shape
    yr = torch.empty((B, T // down), dtype=out_dtype, device=xr.device)
    yi = torch.empty_like(yr)
    with torch.cuda.device(xr.device):
        rc = lib.mix_fir_decim_launch(
            xr.data_ptr(), xi.data_ptr(), carry_r.data_ptr(),
            carry_i.data_ptr(), theta.data_ptr(), ramp_c.data_ptr(),
            ramp_s.data_ptr(), taps.data_ptr(), yr.data_ptr(),
            yi.data_ptr(), B, T, int(taps.shape[-1]), down,
            -1 if sgn < 0 else 1, int(xr.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), tile_step(dphi),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mix_fir_decim kernel launch failed: CUDA error "
                           f"{rc}")
    mix_fir_decim.launches += 1
    return yr, yi


mix_fir_decim.launches = 0
