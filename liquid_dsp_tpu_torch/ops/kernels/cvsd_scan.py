"""The CVSD codec's per-sample recurrence: a Hopper kernel for the JAX
package's ``lax.scan``s in `liquid_dsp_tpu/utils/audio.py:41-52`
(`cvsd_encode`) and `:62-84` (`cvsd_decode` and its post-emphasis).  The
JAX package has no Pallas kernel here; PyTorch has no device-side scan,
and a Python loop would launch a dozen kernels per sample.

`cvsd_scan` launches the CUDA kernel ``csrc/cvsd_scan.cu`` on a CUDA
tensor and runs `cvsd_scan_reference`, the same loop in plain PyTorch, on
a CPU tensor; any other device raises.  Per row (one stream) and sample,
from ref = 0, delta = 0.01, bitref = 0:

    encode: y = x[t] - alpha*x[t-1];  bit = ref <= y
    decode: bit = bits[t]
    both:   bitref = ((bitref << 1) | bit) & mask
            delta  = clip(bitref in {0, mask} ? delta*zeta
                                              : delta*(1/zeta), 0.01, 1)
            ref    = clip(ref + (bit == 1 ? delta : -delta), -1, 1)
    decode: yt = ref + v0;  v0 = fma(-a1, yt, -ref) + v1;  v1 = (-a2)*yt

with a1 = -(alpha + 0.99), a2 = 0.99 alpha (the post-emphasis, audio.py:
77-84).  These are the roundings of XLA's CPU build of the JAX scans: the
division by zeta is a product by the float32 1/zeta, and -xt - a1*yt is
one fused multiply-add (``fma32``, exact here); every other operation is
rounded once.  The kernel writes them out as ``__fmul_rn`` /
``__fadd_rn`` / ``__fmaf_rn``, so on the card it equals the plain version
bit for bit, and both equal the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .symsync_scan import fma32

__all__ = ["BETA", "cvsd_consts", "cvsd_scan", "cvsd_scan_reference"]

BETA = 0.99     # post-emphasis DC-blocking parameter (reference cvsd.c:98)


def cvsd_consts(num_bits: int, zeta: float, alpha: float):
    """(mask, zeta, 1/zeta, alpha, -a1, -a2) as the scans see them: the
    float32 zeta and its float32 reciprocal, the post-emphasis
    coefficients formed in double and rounded to float32 once.  Raises
    as the JAX package's parameter check does."""
    if num_bits < 1:
        raise ValueError("cvsd num_bits must be positive")
    if zeta <= 1.0:
        raise ValueError("cvsd zeta must be greater than 1")
    z = np.float32(zeta)
    return ((1 << num_bits) - 1, float(z), float(np.float32(1) / z),
            float(np.float32(alpha)), float(np.float32(alpha + BETA)),
            float(-np.float32(alpha * BETA)))


def cvsd_scan_reference(x, encode: bool, num_bits: int = 3,
                        zeta: float = 1.5, alpha: float = 0.95):
    """Plain PyTorch version: a loop over the T samples on [rows] tensors.
    encode: x float32 [R, T] -> bits uint8 [R, T]; decode: x uint8 bits
    [R, T] -> audio float32 [R, T]."""
    mask, z, rz, al, na1, na2 = cvsd_consts(num_bits, zeta, alpha)
    R, T = x.shape
    dev = x.device
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa
    z, rz, al, na1, na2 = f(z), f(rz), f(al), f(na1), f(na2)
    dmin, dmax, one = f(0.01), f(1.0), f(1.0)
    ref = torch.zeros(R, dtype=torch.float32, device=dev)
    delta = torch.full((R,), 0.01, dtype=torch.float32, device=dev)
    bitref = torch.zeros(R, dtype=torch.int64, device=dev)
    v0, v1, prev = ref.clone(), ref.clone(), ref.clone()
    outs = []
    for t in range(T):
        if encode:
            y = x[:, t] - al * prev
            prev = x[:, t]
            bit = (ref <= y).to(torch.int64)
        else:
            bit = x[:, t].to(torch.int64)
        bitref = ((bitref << 1) | bit) & mask
        agree = (bitref == 0) | (bitref == mask)
        delta = torch.minimum(torch.maximum(
            delta * torch.where(agree, z, rz), dmin), dmax)
        ref = torch.minimum(torch.maximum(
            ref + torch.where(bit == 1, delta, -delta), -one), one)
        if encode:
            outs.append(bit.to(torch.uint8))
            continue
        yt = ref + v0
        v0, v1 = fma32(na1.expand(R), yt, -ref) + v1, na2 * yt
        outs.append(yt)
    if not outs:
        return torch.empty(R, T, dtype=torch.uint8 if encode
                           else torch.float32, device=dev)
    return torch.stack(outs, dim=-1)


def cvsd_scan(x, encode: bool, num_bits: int = 3, zeta: float = 1.5,
              alpha: float = 0.95):
    """CVSD over rows: encode float32 audio x [R, T] to uint8 bits, or
    decode bits x [R, T] to float32 audio.  Decode runs on uint8 bits (the
    reference's unsigned char); an int32 tensor is cast to uint8 once.

    A CUDA tensor launches the kernel (and counts the launch in
    ``cvsd_scan.launches``); a CPU tensor runs the plain version.
    """
    want = (torch.float32,) if encode else (torch.uint8, torch.int32)
    if x.dim() != 2 or x.dtype not in want:
        raise ValueError(f"cvsd_scan {'encode' if encode else 'decode'} "
                         f"takes [R, T] {' or '.join(map(str, want))}, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not encode:
        x = x.to(torch.uint8)
    if x.device.type == "cpu":
        return cvsd_scan_reference(x, encode, num_bits, zeta, alpha)
    if x.device.type != "cuda":
        raise ValueError(f"cvsd_scan runs on CUDA (kernel) or CPU (plain "
                         f"version) tensors, got device {x.device}")
    mask, z, rz, al, na1, na2 = cvsd_consts(num_bits, zeta, alpha)
    if mask > 0x7FFFFFFF:
        raise ValueError(f"cvsd_scan: num_bits {num_bits} above 31")
    x = x.contiguous()
    R, T = x.shape
    y = torch.empty(R, T, dtype=torch.uint8 if encode else torch.float32,
                    device=x.device)
    from .build import load_library
    lib = load_library()
    with torch.cuda.device(x.device):
        rc = lib.cvsd_scan_launch(
            x.data_ptr(), y.data_ptr(), R, T, 0 if encode else 1, mask, z,
            rz, al if encode else na1, na2,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cvsd_scan kernel launch failed: CUDA error {rc}")
    cvsd_scan.launches += 1
    return y


cvsd_scan.launches = 0
