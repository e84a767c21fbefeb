"""The preamble receivers' greedy in-order suppression fold: a Hopper
kernel for the JAX package's ``lax.scan``s in `liquid_dsp_tpu/framing/
stream_rx.py:311-324` (`_detect_refine`), `liquid_dsp_tpu/multichannel/
ofdm.py:497-502` (`s0_detect_block`) and `liquid_dsp_tpu/parallel/rx.py:
127-135` (the time-sharded receiver).  The JAX package has no Pallas
kernel here; on torch the fold was two launches a segment.

Once a frame fires, nothing fires again for `span` samples.  Per row,
from the watermark ``le = last_end``, over the segments in order:

    keep = (cand ? pos : -2^40) >= le;   le = keep ? pos + span : le

in int64 whatever the inputs' integer types: a non-candidate carries a
position below any watermark.  `suppress_scan` launches the CUDA kernel
``csrc/suppress_scan.cu`` (a warp a row) on CUDA tensors and runs
`suppress_scan_reference`, the same loop on [B] tensors, on CPU tensors;
any other device raises.  Integer compares and selects only, so the two
are equal bit for bit.
"""
from __future__ import annotations

import torch

__all__ = ["NONCAND", "suppress_scan", "suppress_scan_reference"]

NONCAND = -(1 << 40)    # a non-candidate's position: below any watermark

_INTS = (torch.int32, torch.int64)


def suppress_scan_reference(last_end, cand, pos, span: int):
    """Plain PyTorch version: a compare and a select a segment on [B]
    tensors.  last_end [B], cand [B, S] bool, pos [B, S] (int32 or
    int64) -> keep [B, S] bool."""
    pos = pos.to(torch.int64)
    pos_cand = torch.where(cand, pos, torch.full_like(pos, NONCAND))
    pos_span = pos + span
    le = last_end.to(torch.int64)
    keeps = []
    for i in range(cand.shape[1]):
        keep = pos_cand[:, i] >= le
        le = torch.where(keep, pos_span[:, i], le)
        keeps.append(keep)
    if not keeps:
        return torch.zeros_like(cand)
    return torch.stack(keeps, dim=1)


def suppress_scan(last_end, cand, pos, span: int):
    """The greedy fold over rows: last_end [B] int32 or int64 watermarks,
    cand [B, S] bool, pos [B, S] int32 or int64 positions (in the
    watermark's coordinates), span an int -> keep [B, S] bool.

    A CUDA tensor launches the kernel (and counts the launch in
    ``suppress_scan.launches``); a CPU tensor runs the plain version.
    """
    B = last_end.shape[0] if last_end.dim() == 1 else -1
    if (last_end.dim() != 1 or cand.dim() != 2 or cand.shape[0] != B
            or pos.shape != cand.shape or cand.dtype != torch.bool
            or last_end.dtype not in _INTS or pos.dtype not in _INTS):
        raise ValueError(
            f"suppress_scan takes last_end [B] int32/int64, cand [B, S] "
            f"bool and pos [B, S] int32/int64, got {tuple(last_end.shape)} "
            f"{last_end.dtype}, {tuple(cand.shape)} {cand.dtype}, "
            f"{tuple(pos.shape)} {pos.dtype}")
    devs = {last_end.device, cand.device, pos.device}
    if len(devs) != 1:
        raise ValueError(f"suppress_scan: tensors on {sorted(map(str, devs))}")
    dev = cand.device
    if dev.type == "cpu":
        return suppress_scan_reference(last_end, cand, pos, span)
    if dev.type != "cuda":
        raise ValueError(f"suppress_scan runs on CUDA (kernel) or CPU (plain "
                         f"version) tensors, got device {dev}")
    S = cand.shape[1]
    if B == 0 or S == 0:
        return torch.zeros_like(cand)
    last_end, cand, pos = (t.contiguous() for t in (last_end, cand, pos))
    keep = torch.empty_like(cand)
    from .build import load_library
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.suppress_scan_launch(
            last_end.data_ptr(), cand.data_ptr(), pos.data_ptr(),
            keep.data_ptr(), B, S, int(last_end.dtype == torch.int64),
            int(pos.dtype == torch.int64), int(span),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"suppress_scan kernel launch failed: CUDA error "
                           f"{rc}")
    suppress_scan.launches += 1
    return keep


suppress_scan.launches = 0
