"""LDPC belief propagation's iteration loop: a Hopper kernel for the JAX
package's ``lax.scan`` in `liquid_dsp_tpu/fec/ldpc.py:225-241` (the
batched decoder's `step`, `max_iters` times over the messages Rv).  The
JAX package has no Pallas kernel here; on torch an iteration was about 36
launches.

`ldpc_bp` takes the LLRs [R, n] and the slot maps of `fec/ldpc.py`'s
`_slot_maps` (check slot -> variable slot `c2v`, variable slot -> check
slot `v2c`, check slot -> variable `cvar`; pads point one past the end)
and returns the final variable-side messages Rv [R, n*wc + 1] (the last
column the pad, 0).  A CUDA tensor launches ``csrc/ldpc_bp.cu`` (a block
per codeword, every iteration in one launch); a CPU tensor runs
`ldpc_bp_reference`, the decoder's loop in plain PyTorch; any other device
raises.  An iteration: Q = posterior - own message at each check slot
(pads neutral: 38.0 for sum-product, where tanh(19) is 1 in float32, inf
for min-sum), the check update (`check_update`), the messages gathered
back to the variables (pads 0).

Both add each sum in slot order (`slot_sum`: the posterior over a
variable's wc messages, the log-magnitudes over a check's wr slots) and
round every operation once, with the same float32 functions, so the
kernel can equal the plain version bit for bit on the card.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["SAT", "TINY", "CAP", "NEUTRAL_SP", "check_update", "ldpc_bp",
           "ldpc_bp_reference", "posterior", "slot_sum"]

SAT = float(np.float32(1.0 - 1e-7))    # the largest float32 below 1
TINY = float(np.float32(1e-30))
CAP = 1e6                              # a weight-1 check's min-sum message
NEUTRAL_SP = 38.0                      # tanh(19) is 1 in float32


def slot_sum(v):
    """The sum over the last axis in slot order, ((v0 + v1) + v2) + ...:
    the kernel's order.  (A PyTorch reduction on the card splits a short
    axis over threads and adds in another order.)"""
    s = v[..., 0]
    for j in range(1, v.shape[-1]):
        s = s + v[..., j]
    return s


def posterior(llr, Rv, n: int, wc: int):
    """llr [R, n] plus each variable's wc messages of Rv [R, n*wc + 1],
    added in slot order."""
    return llr + slot_sum(Rv[:, :n * wc].reshape(-1, n, wc))


def _excl_sign(neg):
    # the sign of the product over the other slots, from the parity of
    # negative counts (the JAX decoder's adds-only form, kept so that both
    # round alike)
    tot = neg.sum(dim=-1, keepdim=True)
    return 1.0 - 2.0 * torch.remainder(tot - neg, 2.0)


def check_update(Q, min_sum: bool):
    """Check-node messages from the incoming Q [..., m, wr] (pads neutral):
    `liquid_dsp_tpu/fec/ldpc.py:176-216` on torch."""
    if min_sum:
        neg = (Q < 0).to(Q.dtype)
        mag = Q.abs()
        m1 = mag.amin(dim=-1, keepdim=True)
        # the first slot holding the minimum (the JAX decoder's cumsum of
        # the ties; argmin returns the first, and a scan over a short
        # innermost axis is slow on the card)
        only_first = torch.arange(Q.shape[-1], device=Q.device) == \
            mag.argmin(dim=-1, keepdim=True)
        m2 = torch.where(only_first, torch.inf, mag).amin(dim=-1,
                                                          keepdim=True)
        # a weight-1 check sends a large finite certainty, never inf
        return _excl_sign(neg) * torch.clamp(
            torch.where(only_first, m2, m1), max=CAP)
    # saturated BP in the log domain: the sum of log|tanh| and the sign
    # parity; |messages| stay below 2 atanh(SAT) ~ 17.3
    t = torch.clamp(torch.tanh(Q / 2), -SAT, SAT)
    neg = (t < 0).to(Q.dtype)
    lt = torch.log(torch.clamp(t.abs(), min=TINY))
    mag = torch.exp(slot_sum(lt)[..., None] - lt)
    return 2 * torch.atanh(torch.clamp(_excl_sign(neg) * mag, -SAT, SAT))


def ldpc_bp_reference(llr, c2v, v2c, cvar, m: int, n: int, wr: int,
                      wc: int, max_iters: int, min_sum: bool):
    """Plain PyTorch version: the decoder's loop, about 36 launches an
    iteration.  llr [R, n] float32; maps as `ldpc_bp` -> Rv [R, n*wc+1]."""
    neutral = torch.inf if min_sum else NEUTRAL_SP
    c2v_pad = (c2v == n * wc)
    v2c_pad = (v2c == m * wr)
    pad1 = torch.nn.functional.pad
    Rv = llr.new_zeros(llr.shape[0], n * wc + 1)
    for _ in range(max_iters):
        post = posterior(llr, Rv, n, wc)
        Qv = pad1(post, (0, 1)).index_select(1, cvar) - \
            Rv.index_select(1, c2v)
        Qv = torch.where(c2v_pad, neutral, Qv)
        R = check_update(Qv.reshape(-1, m, wr), min_sum)
        Rflat = pad1(R.reshape(-1, m * wr), (0, 1))
        Rv2 = torch.where(v2c_pad, 0.0, Rflat.index_select(1, v2c))
        Rv = pad1(Rv2, (0, 1))
    return Rv


def ldpc_bp(llr, c2v, v2c, cvar, m: int, n: int, wr: int, wc: int,
            max_iters: int, min_sum: bool):
    """All `max_iters` belief-propagation iterations over the rows of llr
    [R, n] float32 (> 0 means bit 0): the messages Rv [R, n*wc + 1]
    float32 that the posterior (`posterior`) is formed from.  c2v, cvar [m*wr] and v2c [n*wc] are `_slot_maps`'s
    maps on llr's device, int32 (the plain version takes int64 too).

    A CUDA tensor launches the kernel (and counts the launch in
    ``ldpc_bp.launches``); a CPU tensor runs the plain version.  Any H
    runs on the card: a codeword's messages sit in shared memory where
    they fit, otherwise in a global scratch.
    """
    if (llr.dim() != 2 or llr.dtype != torch.float32 or llr.shape[1] != n
            or c2v.shape != (m * wr,) or cvar.shape != (m * wr,)
            or v2c.shape != (n * wc,) or max_iters < 0):
        raise ValueError(
            f"ldpc_bp takes llr [R, {n}] float32, c2v and cvar [{m * wr}], "
            f"v2c [{n * wc}] and max_iters >= 0, got {tuple(llr.shape)} "
            f"{llr.dtype}, {tuple(c2v.shape)}, {tuple(cvar.shape)}, "
            f"{tuple(v2c.shape)}, {max_iters}")
    devs = {t.device for t in (llr, c2v, v2c, cvar)}
    if len(devs) != 1:
        raise ValueError(f"ldpc_bp: tensors on {sorted(map(str, devs))}")
    dev = llr.device
    if dev.type == "cpu":
        return ldpc_bp_reference(llr, c2v, v2c, cvar, m, n, wr, wc,
                                 max_iters, min_sum)
    if dev.type != "cuda":
        raise ValueError(f"ldpc_bp runs on CUDA (kernel) or CPU (plain "
                         f"version) tensors, got device {dev}")
    R = llr.shape[0]
    rv = torch.empty(R, n * wc + 1, dtype=torch.float32, device=dev)
    if R == 0:
        return rv
    if c2v.dtype != torch.int32 or v2c.dtype != torch.int32 or \
            cvar.dtype != torch.int32:
        raise ValueError(f"ldpc_bp on the card takes int32 maps, got "
                         f"{c2v.dtype}, {v2c.dtype}, {cvar.dtype}")
    llr, c2v, v2c, cvar = (t.contiguous() for t in (llr, c2v, v2c, cvar))
    from .build import load_library
    lib = load_library()
    with torch.cuda.device(dev):
        in_smem = lib.ldpc_bp_smem_bytes(m, n, wr, wc) <= \
            lib.ldpc_bp_smem_max()
        scratch = rv if in_smem else torch.empty(
            R, m * wr + n, dtype=torch.float32, device=dev)
        rc = lib.ldpc_bp_launch(
            llr.data_ptr(), rv.data_ptr(), scratch.data_ptr(),
            c2v.data_ptr(), v2c.data_ptr(), cvar.data_ptr(), R, m, n, wr,
            wc, int(max_iters), int(bool(min_sum)), int(in_smem), SAT, TINY,
            float("inf") if min_sum else NEUTRAL_SP, CAP,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ldpc_bp kernel launch failed: CUDA error {rc}")
    ldpc_bp.launches += 1
    return rv


ldpc_bp.launches = 0
