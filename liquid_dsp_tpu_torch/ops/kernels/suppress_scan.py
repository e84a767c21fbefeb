"""The preamble receivers' greedy in-order suppression fold: a Hopper
kernel for the JAX package's ``lax.scan``s in `liquid_dsp_tpu/framing/
stream_rx.py:311-324` (`_detect_refine`), `liquid_dsp_tpu/multichannel/
ofdm.py:497-502` (`s0_detect_block`) and `liquid_dsp_tpu/parallel/rx.py:
127-135` (the time-sharded receiver), and for the ranking of the first P
kept segments after the first two (``jnp.nonzero(keep, size=P,
fill_value=0)``, `stream_rx.py:328`, `ofdm.py:505`).  The JAX package has
no Pallas kernel here; on torch the fold was two launches a segment and
the ranking about nine launches.

Once a frame fires, nothing fires again for `span` samples.  Per row,
from the watermark ``le = last_end``, over the segments in order:

    keep = (cand ? pos : -2^40) >= le;   le = keep ? pos + span : le

in int64 whatever the inputs' integer types: a non-candidate carries a
position below any watermark.  `suppress_scan` launches the CUDA kernel
``csrc/suppress_scan.cu`` (a warp a row, its loads ahead of the chain,
the ranking by ballots in the same launch) on CUDA tensors and runs
`suppress_scan_reference`, the same loop on [B] tensors, and
`rank_reference`, a cumsum and a scatter, on CPU tensors; any other
device raises.  Integer compares, selects and counts only, so the two
are equal bit for bit.
"""
from __future__ import annotations

import torch

__all__ = ["NONCAND", "rank_reference", "suppress_scan",
           "suppress_scan_reference"]

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


def rank_reference(keep, P: int):
    """The first P kept segments of each row, in order, without a host
    sync: keep [B, S] bool -> (sel [B, P] int64, the r-th kept segment's
    index in slot r and 0 in the slots past the count; n_cand [B] int64,
    the count).  A cumsum ranks, a scatter places (slot P takes the rest
    and is dropped)."""
    B, S = keep.shape
    n_cand = keep.sum(dim=1)
    rank = torch.cumsum(keep, dim=1) - 1
    slot = torch.where(keep & (rank < P), rank, torch.full_like(rank, P))
    sel = torch.zeros(B, P + 1, dtype=torch.int64, device=keep.device)
    sel.scatter_(1, slot, torch.arange(S, device=keep.device).expand(B, S))
    return sel[:, :P], n_cand


def suppress_scan(last_end, cand, pos, span: int, P: int | None = None):
    """The greedy fold over rows: last_end [B] int32 or int64 watermarks,
    cand [B, S] bool, pos [B, S] int32 or int64 positions (in the
    watermark's coordinates), span an int -> keep [B, S] bool.  With `P`
    the same launch also ranks the kept segments: (keep, sel [B, P]
    int64, n_cand [B] int64) as `rank_reference` gives them.

    A CUDA tensor launches the kernel (and counts the launch in
    ``suppress_scan.launches``); a CPU tensor runs the plain version.
    """
    B = last_end.shape[0] if last_end.dim() == 1 else -1
    if (last_end.dim() != 1 or cand.dim() != 2 or cand.shape[0] != B
            or pos.shape != cand.shape or cand.dtype != torch.bool
            or last_end.dtype not in _INTS or pos.dtype not in _INTS
            or (P is not None and P < 0)):
        raise ValueError(
            f"suppress_scan takes last_end [B] int32/int64, cand [B, S] "
            f"bool, pos [B, S] int32/int64 and P >= 0, got "
            f"{tuple(last_end.shape)} {last_end.dtype}, {tuple(cand.shape)} "
            f"{cand.dtype}, {tuple(pos.shape)} {pos.dtype}, {P}")
    devs = {last_end.device, cand.device, pos.device}
    if len(devs) != 1:
        raise ValueError(f"suppress_scan: tensors on {sorted(map(str, devs))}")
    dev = cand.device
    if dev.type == "cpu":
        keep = suppress_scan_reference(last_end, cand, pos, span)
        return keep if P is None else (keep, *rank_reference(keep, P))
    if dev.type != "cuda":
        raise ValueError(f"suppress_scan runs on CUDA (kernel) or CPU (plain "
                         f"version) tensors, got device {dev}")
    S = cand.shape[1]
    if B == 0 or S == 0:
        keep = torch.zeros_like(cand)
        return keep if P is None else (keep, *rank_reference(keep, P))
    last_end, cand, pos = (t.contiguous() for t in (last_end, cand, pos))
    keep = torch.empty_like(cand)
    sel = n_cand = None
    if P is not None:
        sel = torch.empty(B, P, dtype=torch.int64, device=dev)
        n_cand = torch.empty(B, dtype=torch.int64, device=dev)
    from .build import load_library
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.suppress_scan_launch(
            last_end.data_ptr(), cand.data_ptr(), pos.data_ptr(),
            keep.data_ptr(), 0 if sel is None else sel.data_ptr(),
            0 if n_cand is None else n_cand.data_ptr(), B, S,
            0 if P is None else int(P), int(P is not None),
            int(last_end.dtype == torch.int64),
            int(pos.dtype == torch.int64), int(span),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"suppress_scan kernel launch failed: CUDA error "
                           f"{rc}")
    suppress_scan.launches += 1
    return keep if P is None else (keep, sel, n_cand)


suppress_scan.launches = 0
