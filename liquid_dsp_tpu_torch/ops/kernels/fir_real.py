"""Stride-1 real-tap FIR over float32 rows: the Hopper port of
`liquid_dsp_tpu/ops/kernels/pallas_fir.py` (`fir_pallas_real` and its
block step `fir_apply_pallas`), behind ``firfilt(backend="pallas")``.

`fir_real` launches the CUDA kernel ``csrc/fir_real.cu`` on a CUDA tensor
and runs `fir_real_reference`, the same filter in plain PyTorch, on a CPU
tensor; any other device raises.  The kernel takes the carry as its own
argument and each block loads its halo from it, so the wrapper never
concatenates [carry | x]; it is bound by the float32 FMAs (see the
source's note).  The plain version takes any number of taps; the kernel
takes up to LMAX (its taps and a tile's window in the 227 KB of shared
memory a block may have), and a CUDA tensor with more raises ValueError.
"""
from __future__ import annotations

import torch

from ..dotprod import conv1d_real

__all__ = ["LMAX", "fir_real", "fir_real_reference", "fir_apply_pallas"]

LMAX = 24576   # largest tap count the kernel takes (shared memory 226 KB)


def fir_real_reference(x: torch.Tensor, carry: torch.Tensor,
                       h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: y[r, t] = sum_j h[j] xp[r, t + L-1 - j] with
    xp = [carry | x] (on CUDA, conv1d follows
    ``torch.backends.cudnn.allow_tf32``)."""
    return conv1d_real(torch.cat([carry, x], dim=-1), h)


def _check(x, carry, h):
    if x.dim() != 2 or carry.dim() != 2 or h.dim() != 1:
        raise ValueError(f"fir_real takes x [rows, T], carry [rows, L-1] and "
                         f"h [L], got {tuple(x.shape)}, {tuple(carry.shape)} "
                         f"and {tuple(h.shape)}")
    L = h.shape[0]
    if L < 1:
        raise ValueError(f"fir_real takes at least one tap, got {L}")
    if carry.shape != (x.shape[0], L - 1):
        raise ValueError(f"carry must be [{x.shape[0]}, {L - 1}], got "
                         f"{tuple(carry.shape)}")
    if any(t.dtype != torch.float32 for t in (x, carry, h)):
        raise ValueError(f"fir_real takes float32 tensors, got {x.dtype}, "
                         f"{carry.dtype} and {h.dtype}")
    if carry.device != x.device or h.device != x.device:
        raise ValueError(f"fir_real: all tensors must be on one device, got "
                         f"{x.device}, {carry.device} and {h.device}")
    if not (x.is_contiguous() and carry.is_contiguous()
            and h.is_contiguous()):
        raise ValueError("fir_real takes contiguous tensors")


def fir_real(x: torch.Tensor, carry: torch.Tensor,
             h: torch.Tensor) -> torch.Tensor:
    """Filter float32 rows: x [rows, T], carry [rows, L-1] (the previous
    block's last L-1 inputs), h [L] real taps -> y [rows, T].

    A CUDA tensor launches the kernel (and counts the launch in
    ``fir_real.launches``; L <= LMAX there, else ValueError); a CPU tensor
    runs the plain version.
    """
    _check(x, carry, h)
    if x.device.type == "cpu":
        return fir_real_reference(x, carry, h)
    if x.device.type != "cuda":
        raise ValueError(f"fir_real runs on CUDA (kernel) or CPU (plain "
                         f"version) tensors, got device {x.device}")
    if h.shape[0] > LMAX:
        raise ValueError(f"fir_real's kernel takes 1 to {LMAX} taps on CUDA "
                         f"tensors, got {h.shape[0]}")
    rows, T = x.shape
    y = torch.empty_like(x)
    if rows == 0 or T == 0:
        return y
    from .build import load_library
    lib = load_library()
    with torch.cuda.device(x.device):
        rc = lib.fir_real_launch(
            x.data_ptr(), carry.data_ptr(), h.data_ptr(), y.data_ptr(), rows,
            T, h.shape[0], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fir_real kernel launch failed: CUDA error {rc}")
    fir_real.launches += 1
    return y


fir_real.launches = 0


def fir_apply_pallas(h: torch.Tensor, carry: torch.Tensor, x: torch.Tensor):
    """FIR block step with real taps on `fir_real`, the semantics of
    `ops.fir.fir_apply` (stride 1): x [..., T] real or complex, carry
    [..., L-1] input tail -> (y, carry').  A complex stream goes through
    as its re and im planes stacked as rows."""
    L = h.shape[-1]
    lead, T = x.shape[:-1], x.shape[-1]
    carry = carry.to(x.dtype)
    # the last L-1 samples of [carry | x], without concatenating it all
    if L == 1:
        new_carry = carry
    elif T >= L - 1:
        new_carry = x[..., T - (L - 1):].clone()
    else:
        new_carry = torch.cat([carry[..., T:], x], dim=-1)
    xf = x.reshape(-1, T)
    cf = carry.reshape(xf.shape[0], L - 1)
    h = h.to(torch.float32)
    if x.is_complex():
        rows = torch.cat([xf.real, xf.imag]).to(torch.float32).contiguous()
        crow = torch.cat([cf.real, cf.imag]).to(torch.float32).contiguous()
        y = fir_real(rows, crow, h)
        n = xf.shape[0]
        out = torch.complex(y[:n], y[n:]).to(x.dtype)
    else:
        out = fir_real(xf.to(torch.float32).contiguous(),
                       cf.to(torch.float32).contiguous(), h).to(x.dtype)
    return out.reshape(lead + (T,)), new_carry
