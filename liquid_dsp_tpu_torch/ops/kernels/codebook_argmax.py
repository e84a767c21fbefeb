"""Fused codebook correlation + argmax: the Hopper port of
`liquid_dsp_tpu/ops/kernels/pallas_codebook.py:codebook_argmax`.

`codebook_argmax` launches the CUDA kernel ``csrc/codebook_argmax.cu`` on
a CUDA tensor and runs `codebook_argmax_reference`, the same computation
in plain PyTorch, on a CPU tensor; any other device raises.  The kernel
never writes the [M, K] scores to device memory.  It is bound by the
instruction rate of its float32 adds: one multiply-add by +-1.0 per add (the signs
of a thread's 4 columns unpacked into registers once per pass and used
for 32 rows), the soft bits broadcast from shared memory as float4, and
the leading positions that a thread's columns share summed once.  So that
neighbouring columns share what they can, the kernel takes the columns
sorted by their sign masks (`sorted_masks`, made once per codebook
tensor) with each column's own index beside it, which also breaks ties
(see the source's note for the card's multiply-add rate and what holds
the kernel below it).

Both versions score a row as the f32 sum ``acc = acc + cw[i]*bip[i, k]``
taken in the order i = 0..n-1 from zero.  Every product is exact (bip is
+-1), so kernel and plain version give bit-identical scores, and both
take the first index among equal maxima.
"""
from __future__ import annotations

import weakref

import torch

__all__ = ["NMAX", "pack_codebook", "sort_codebook", "sorted_masks",
           "codebook_argmax", "codebook_argmax_reference"]

NMAX = 32          # soft bits per row the kernel takes (one 32-bit mask)
CHUNK = 8192       # rows per chunk of the plain version's [rows, K] scores


def pack_codebook(bip: torch.Tensor) -> torch.Tensor:
    """[n, K] +-1 codebook -> [K] int32 masks, bit (31 - i) set where
    bip[i, k] < 0 (the kernel's sign-flip form)."""
    n = bip.shape[0]
    w = torch.tensor([1 << (31 - i) for i in range(n)], dtype=torch.int64,
                     device=bip.device)
    m = ((bip < 0).to(torch.int64) * w[:, None]).sum(dim=0)
    return torch.where(m >= 1 << 31, m - (1 << 32), m).to(torch.int32)


def sort_codebook(bip: torch.Tensor):
    """(masks [K] int32, order [K] int32): `pack_codebook(bip)` sorted
    ascending as unsigned numbers, equal masks in their own order, and the
    column of bip that each sorted mask packs."""
    m = pack_codebook(bip)
    order = torch.argsort(m.to(torch.int64) & 0xFFFFFFFF, stable=True)
    return m[order].contiguous(), order.to(torch.int32)


# id(bip) -> (weak reference to bip, its version, its sorted masks and
# order): the receiver hands the same codebook tensor to every block, and
# packing it anew costs a dozen small launches (0.17 ms on an H100 for the
# packing alone, a fifth of the kernel)
_SORTED = {}


def sorted_masks(bip: torch.Tensor):
    """`sort_codebook(bip)`, kept for as long as this tensor object lives
    and is not written to in place."""
    if bip.is_inference():        # no version counter: nothing to go by
        return sort_codebook(bip)
    key = id(bip)
    hit = _SORTED.get(key)
    if hit is not None and hit[0]() is bip and hit[1] == bip._version:
        return hit[2]
    pair = sort_codebook(bip)
    _SORTED[key] = (weakref.ref(bip, lambda _, key=key: _SORTED.pop(key, None)),
                    bip._version, pair)
    return pair


def codebook_argmax_reference(cw: torch.Tensor, bip: torch.Tensor,
                              chunk: int = CHUNK) -> torch.Tensor:
    """Plain PyTorch version: [M, n] x [n, K] -> [M] int32, the scores
    summed in the kernel's order, in row chunks so that [chunk, K] f32
    scores are all that is held at once."""
    M = cw.shape[0]
    K = bip.shape[1]
    out = torch.empty(M, dtype=torch.int32, device=cw.device)
    for s in range(0, M, chunk):
        c = cw[s:s + chunk]
        acc = torch.zeros(c.shape[0], K, dtype=torch.float32, device=cw.device)
        for i in range(cw.shape[1]):
            acc.add_(c[:, i:i + 1] * bip[i])
        out[s:s + chunk] = acc.argmax(dim=-1).to(torch.int32)
    return out


def _check(cw, bip):
    if cw.dim() < 1 or bip.dim() != 2 or cw.shape[-1] != bip.shape[0]:
        raise ValueError(f"codebook_argmax takes cw [..., n] and bip [n, K], "
                         f"got {tuple(cw.shape)} and {tuple(bip.shape)}")
    if cw.dtype != torch.float32 or bip.dtype != torch.float32:
        raise ValueError(f"cw and bip must be float32, got {cw.dtype} and "
                         f"{bip.dtype}")
    n, K = bip.shape
    if not (1 <= n <= NMAX and 1 <= K <= 1 << 24):
        raise ValueError(f"codebook_argmax takes 1 <= n <= {NMAX} and "
                         f"1 <= K <= 2^24, got n={n}, K={K}")
    if cw.device != bip.device:
        raise ValueError(f"codebook_argmax: cw and bip must be on one "
                         f"device, got {cw.device} and {bip.device}")
    if not (cw.is_contiguous() and bip.is_contiguous()):
        raise ValueError("codebook_argmax takes contiguous tensors")


def codebook_argmax(cw: torch.Tensor, bip: torch.Tensor) -> torch.Tensor:
    """argmax(cw @ bip, axis=-1) without materialising the scores.

    cw: [..., n] float32 soft bits; bip: [n, K] float32 +-1 codebook.
    Returns [...] int32, the first index among equal maxima.

    A CUDA tensor launches the kernel (and counts the launch in
    ``codebook_argmax.launches``); a CPU tensor runs the plain version.
    """
    _check(cw, bip)
    lead = cw.shape[:-1]
    n = cw.shape[-1]
    cwf = cw.reshape(-1, n)
    M = cwf.shape[0]
    if cw.device.type == "cpu":
        return codebook_argmax_reference(cwf, bip).reshape(lead)
    if cw.device.type != "cuda":
        raise ValueError(f"codebook_argmax runs on CUDA (kernel) or CPU "
                         f"(plain version) tensors, got device {cw.device}")
    out = torch.empty(M, dtype=torch.int32, device=cw.device)
    if M == 0:
        return out.reshape(lead)
    from .build import load_library
    lib = load_library()
    masks, order = sorted_masks(bip)
    with torch.cuda.device(cw.device):
        rc = lib.codebook_argmax_launch(
            cwf.data_ptr(), masks.data_ptr(), order.data_ptr(),
            out.data_ptr(), M, n, bip.shape[1],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"codebook_argmax kernel launch failed: CUDA "
                           f"error {rc}")
    codebook_argmax.launches += 1
    return out.reshape(lead)


codebook_argmax.launches = 0
