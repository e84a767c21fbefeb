"""Every branch output of symsync's polyphase matched-filter pair over a
chunk: the input of the hoisted symsync path (`ops/symsync.py`,
`_symsync_run_hoisted`: symsync alone and the tracker's sequential route).

`branch_bank` launches the CUDA kernel ``csrc/branch_bank.cu`` on a CUDA
tensor and runs `branch_bank_reference`, the same sums in plain PyTorch,
on a CPU tensor; any other device raises.  It replaces no Pallas kernel:
the JAX package takes these outputs from ``lax.conv_general_dilated``
(`liquid_dsp_tpu/ops/symsync.py:153-166`).  It is written by hand so that
both tracker routes read their branch rows from one arithmetic
(``csrc/branch_dot.cuh``): the fused kernel `symsync_pll_lms` filters the
rows its timing chain reads with the same code.

    ma[p, b, r, t] = sum_{j < Lb} planes[p, b, t + j] * kern[r, j]

summed in the order j = 0, 1, ..., Lb-1: the first product rounded on its
own, then one fused multiply-add a tap (`fma32` here, ``__fmaf_rn`` in the
kernel), so the kernel equals its plain version bit for bit.  Against
cuDNN's full-float32 conv1d (another summation order) the outputs agree
to a few float32 roundings of the sum's magnitude.

The plain version takes any bank; the kernel takes up to LB_MAX taps and a
bank of up to BANK_MAX floats (shared memory), and a CUDA tensor beyond
either raises ValueError.
"""
from __future__ import annotations

import torch

from .symsync_scan import fma32

__all__ = ["LB_MAX", "BANK_MAX", "branch_bank", "branch_bank_reference",
           "tap_pitch"]

LB_MAX = 64           # taps a branch takes in the kernels (branch_dot.cuh)
BANK_MAX = 48 * 1024  # floats of the padded bank in shared memory (192 KB)


def tap_pitch(Lb: int) -> int:
    """Floats a row of taps takes in the kernels' shared memory."""
    return (Lb + 3) // 4 * 4


def branch_bank_reference(planes: torch.Tensor,
                          kern: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: planes [P, B, Tc + Lb - 1] and kern [R, Lb]
    float32 -> ma [P, B, R, Tc], each output summed over j in order, the
    first product rounded, then `fma32` a tap."""
    P, B, n = planes.shape
    R, Lb = kern.shape
    Tc = n - Lb + 1
    x = planes[:, :, None, :]              # [P, B, 1, n]
    k = kern[:, :, None]                   # [R, Lb, 1]
    acc = x[..., :Tc] * k[:, 0]
    for j in range(1, Lb):
        acc = fma32(x[..., j:j + Tc], k[:, j], acc)
    return acc.contiguous()


def _check(planes, kern):
    if planes.dim() != 3 or kern.dim() != 2:
        raise ValueError(f"branch_bank takes planes [P, B, Tc + Lb - 1] and "
                         f"kern [R, Lb], got {tuple(planes.shape)} and "
                         f"{tuple(kern.shape)}")
    R, Lb = kern.shape
    if R < 1 or Lb < 1 or planes.shape[-1] < Lb - 1:
        raise ValueError(f"branch_bank: {planes.shape[-1]} samples a row for "
                         f"a bank of {R} x {Lb}")
    if planes.dtype != torch.float32 or kern.dtype != torch.float32:
        raise ValueError(f"branch_bank takes float32 tensors, got "
                         f"{planes.dtype} and {kern.dtype}")
    if kern.device != planes.device:
        raise ValueError(f"branch_bank: both tensors must be on one device, "
                         f"got {planes.device} and {kern.device}")
    if planes.stride(-1) != 1 or not kern.is_contiguous():
        raise ValueError("branch_bank takes rows of contiguous samples and a "
                         "contiguous bank")


def branch_bank(planes: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """Every branch output of a chunk: planes [P, B, Tc + Lb - 1] float32
    (a view with contiguous rows will do), kern [R, Lb] -> ma [P, B, R,
    Tc], the layout `symsync_scan` reads.

    A CUDA tensor launches the kernel (and counts the launch in
    ``branch_bank.launches``; Lb <= LB_MAX and R * tap_pitch(Lb) <=
    BANK_MAX there, else ValueError); a CPU tensor runs the plain version.
    """
    _check(planes, kern)
    if planes.device.type == "cpu":
        return branch_bank_reference(planes, kern)
    if planes.device.type != "cuda":
        raise ValueError(f"branch_bank runs on CUDA (kernel) or CPU (plain "
                         f"version) tensors, got device {planes.device}")
    P, B, n = planes.shape
    R, Lb = kern.shape
    if Lb > LB_MAX or R * tap_pitch(Lb) > BANK_MAX:
        raise ValueError(f"branch_bank's kernel takes up to {LB_MAX} taps and "
                         f"{BANK_MAX} floats of bank on CUDA tensors, got "
                         f"{R} x {Lb}")
    Tc = n - Lb + 1
    ma = torch.empty(P, B, R, Tc, dtype=torch.float32, device=planes.device)
    if P == 0 or B == 0 or Tc == 0:
        return ma
    from .build import load_library
    lib = load_library()
    with torch.cuda.device(planes.device):
        rc = lib.branch_bank_launch(
            planes.data_ptr(), kern.data_ptr(), ma.data_ptr(), P, B, Tc, Lb,
            R, planes.stride(0), planes.stride(1),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"branch_bank kernel launch failed: CUDA error "
                           f"{rc}")
    branch_bank.launches += 1
    return ma


branch_bank.launches = 0
