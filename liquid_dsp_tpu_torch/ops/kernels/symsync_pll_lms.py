"""symtrack's fused route: the symsync timing loop with the tracker's
carrier PLL + decision-directed LMS step after every emit, in one kernel
that filters the branch outputs it reads itself.  The Hopper port of the
JAX package's fused route, the ``lax.scan`` of
`liquid_dsp_tpu/ops/symsync.py:187-206` (`_symsync_run_hoisted` with a
``post`` hook) driven by `liquid_dsp_tpu/framing/symtrack.py:284-296`
with the step of `:218-267`; the Pallas timing kernel there cannot carry
the hook, so on the TPU this route has no kernel of its own.

`symsync_pll_lms` launches the CUDA kernel ``csrc/symsync_pll_lms.cu`` on
a CUDA tensor and runs `symsync_pll_lms_reference` on a CPU tensor; any
other device raises.  It takes the input planes [P, B, Tc + Lb - 1] and
the bank (as `branch_bank` does), not the branch outputs.  The plain
version is `branch_bank_reference`, then `symsync_scan_reference` with
`PllLmsPost` as its post hook: the branch outputs and the timing loop's
arithmetic bit for bit, the PLL + LMS as `pll_lms_reference` computes it.
The timing loop's own slots stay inside the kernel; only the slot mask
comes out.  The kernel runs three warps a channel: a filter warp computes
the branch rows the timing chain will read with `branch_bank`'s code
(``csrc/branch_dot.cuh``), a tile ahead; symsync_scan's warp runs the
timing chain and hands each 32-step tile of slots through a ring in
shared memory to pll_lms's warp, so the chains run side by side; the
warps run the sequential kernels' own device code (``csrc/symsync_step.
cuh``, ``csrc/pll_lms_step.cuh``).  So the kernel's slot mask and loop
state equal `branch_bank` + `symsync_scan`'s bit for bit, its outputs
`pll_lms`'s on those slots, and its PLL + LMS agree with the plain
version to the reference's stream tolerance (2e-4, decisions equal), as
`pll_lms` does.

``win`` rows around the chain's branch are filtered a step (per plane and
filter; FILTER_WIN unless given, the full bank at ``win = npfb``); a
branch outside them is filtered on the chain from the staged input, by
the same sums (a miss, counted per channel in ``FusedOut.misses``).

The dot over the equalizer's shifted window, which the kernel carries
from slot to slot, is summed anew where a call starts unless the state
holds it under ``"dot"`` ([2, B]: re, im), as the kernel returns it: a
block run in pieces with the dot handed on (and none at its first piece)
equals `pll_lms` over the whole block's slots bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .branch_bank import BANK_MAX, LB_MAX, branch_bank_reference, tap_pitch
from .pll_lms import LMAX, STATE_KEYS, pll_lms_step, slicer_config
from .symsync_scan import inverse_k, loop_consts, symsync_scan_reference

__all__ = ["PllLmsPost", "FusedOut", "FILTER_WIN", "symsync_pll_lms",
           "symsync_pll_lms_reference"]

# branch rows the filter warp computes a step, per plane and filter (None:
# the full bank, npfb rows, no misses).  8 by measurement on an H100 at
# 256 x 32768 (chip_kernel_bench.py --fused): a block took 4.95 ms at 8
# rows (10 misses), 5.13 at 4 (20,248), 8.58 at 2 (752,360) and 7.22 at
# the full bank, the filter warp's issue slots taken from the chains
FILTER_WIN = 8


class PllLmsPost(torch.nn.Module):
    """symtrack's PLL + DD-LMS step as a symsync post hook:
    post(pc, y_re, y_im, valid) -> (pc', (y_re, y_im, decision)) on [B]
    planes (`pll_lms_step`).  Holds the constellation as (non-persistent)
    buffers ``tab_re``, ``tab_im``, which follow ``.to(device)``, and the
    loop constants; the card's fused kernel takes its hook only in this
    form."""

    def __init__(self, table, *, alpha: float, beta2: float, mu: float):
        super().__init__()
        table = np.asarray(table).astype(np.complex64)
        self.register_buffer("tab_re", torch.tensor(table.real.copy()),
                             persistent=False)
        self.register_buffer("tab_im", torch.tensor(table.imag.copy()),
                             persistent=False)
        self.qpsk = slicer_config(table)
        self.alpha, self.beta2, self.mu = float(alpha), float(beta2), float(mu)

    def kwargs(self):
        """`pll_lms`'s loop constants and slicer."""
        return dict(alpha=self.alpha, beta2=self.beta2, mu=self.mu,
                    qpsk=self.qpsk)

    def forward(self, pc, y_re, y_im, vm):
        return pll_lms_step(pc, y_re, y_im, vm, self.tab_re, self.tab_im,
                            **self.kwargs())


class FusedOut(NamedTuple):
    valid: torch.Tensor          # [B, S] bool, the symsync slot mask
    y_re: torch.Tensor           # [B, S] f32, the tracker's symbols
    y_im: torch.Tensor
    dec: torch.Tensor            # [B, S] int32, the decisions
    fstate: torch.Tensor         # [6, B] f32, symsync_scan's
    istate: torch.Tensor         # [2, B] int32
    pll_state: dict              # STATE_KEYS (and "dot" from the kernel)
    misses: torch.Tensor | None = None   # [B] int32 from the kernel: the
    #                              branches filtered on the timing chain


def symsync_pll_lms_reference(planes, kern, fstate, istate, pll_state,
                              post, *, npfb: int, max_out: int, k: int,
                              k_out: int, bw: float, locked: bool,
                              win=None) -> FusedOut:
    """Plain PyTorch version: `branch_bank_reference`, then
    `symsync_scan_reference` with `post` after every emit (a ``"dot"`` in
    the state is not read; the returned state has STATE_KEYS only; `win`
    changes nothing here, and no misses are counted)."""
    ma = branch_bank_reference(planes, kern)
    pc = {key: pll_state[key] for key in STATE_KEYS}
    y_re, _, valid, fs, is_, ex, pc = symsync_scan_reference(
        ma, fstate, istate, npfb=npfb, max_out=max_out, k=k, k_out=k_out,
        bw=bw, locked=locked, post=post, post_carry=pc)
    if not ex:                                   # no step: no slot
        ex = (y_re.clone(), y_re.clone(), y_re.to(torch.int32))
    return FusedOut(valid, *ex, fs, is_, pc)


def _check(planes, kern, fstate, istate, pll_state, post, npfb, max_out,
           win):
    if not isinstance(post, PllLmsPost):
        raise TypeError(f"symsync_pll_lms takes its post step as a "
                        f"PllLmsPost, got {type(post).__name__}")
    if planes.dim() != 3 or planes.shape[0] not in (1, 2):
        raise ValueError(f"symsync_pll_lms takes planes [P in (1, 2), B, "
                         f"Tc + Lb - 1], got {tuple(planes.shape)}")
    if kern.dim() != 2 or kern.shape[0] != 2 * npfb or (
            planes.shape[-1] < kern.shape[1] - 1):
        raise ValueError(f"symsync_pll_lms takes kern [2*npfb={2 * npfb}, "
                         f"Lb] with Lb - 1 <= {planes.shape[-1]} samples, "
                         f"got {tuple(kern.shape)}")
    B = planes.shape[1]
    if fstate.shape != (6, B) or istate.shape != (2, B):
        raise ValueError(f"symsync_pll_lms takes fstate [6, {B}] and istate "
                         f"[2, {B}], got {tuple(fstate.shape)} and "
                         f"{tuple(istate.shape)}")
    if any(key not in pll_state for key in STATE_KEYS):
        raise ValueError(f"symsync_pll_lms: the PLL state needs "
                         f"{STATE_KEYS}, got {tuple(pll_state)}")
    L = pll_state["ew_re"].shape[-1]
    for key in STATE_KEYS:
        want = (B, L) if key[:3] in ("ew_", "eb_") else (B,)
        if tuple(pll_state[key].shape) != want:
            raise ValueError(f"symsync_pll_lms: PLL state {key!r} must be "
                             f"{want}, got {tuple(pll_state[key].shape)}")
    dot = pll_state.get("dot")
    if dot is not None and tuple(dot.shape) != (2, B):
        raise ValueError(f"symsync_pll_lms: PLL state 'dot' must be (2, {B}),"
                         f" got {tuple(dot.shape)}")
    floats = [planes, kern, fstate, post.tab_re, post.tab_im] + [
        pll_state[key] for key in STATE_KEYS if key != "eq_n"] + (
        [dot] if dot is not None else [])
    tensors = floats + [istate, pll_state["eq_n"]]
    if any(t.device != planes.device for t in tensors):
        raise ValueError(f"symsync_pll_lms: all tensors must be on one "
                         f"device (the post's table too), got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if (any(t.dtype != torch.float32 for t in floats)
            or istate.dtype != torch.int32
            or pll_state["eq_n"].dtype != torch.int32):
        raise ValueError("symsync_pll_lms takes float32 planes, bank, "
                         "fstate, table and PLL state, an int32 istate and "
                         "eq_n")
    if planes.stride(-1) != 1 or not all(
            t.is_contiguous() for t in tensors[1:]):
        raise ValueError("symsync_pll_lms takes rows of contiguous samples "
                         "and contiguous states")
    if not (1 <= npfb and 1 <= max_out):
        raise ValueError(f"symsync_pll_lms: npfb={npfb}, max_out={max_out}")
    if win is not None and not 1 <= win <= npfb:
        raise ValueError(f"symsync_pll_lms: win={win} outside 1..{npfb}")


def symsync_pll_lms(planes, kern, fstate, istate, pll_state, post, *,
                    npfb: int, max_out: int, k: int, k_out: int, bw: float,
                    locked: bool, win=None) -> FusedOut:
    """Run the branch filters, the timing loop and the PLL + LMS over one
    block of input.

    planes [P, B, Tc + Lb - 1] f32 (the window's last Lb - 1 samples, then
    Tc steps, per float plane; rows of contiguous samples) and kern
    [2*npfb, Lb] (`ops.symsync.branch_kernel`); fstate [6, B] f32 and
    istate [2, B] int32 (`symsync_scan`'s); pll_state {STATE_KEYS}
    (`pll_lms`'s, optionally with "dot"); post the tracker's `PllLmsPost`;
    win the filter warp's rows a step (None: FILTER_WIN, at most npfb).
    Returns a `FusedOut`: the slot mask, the tracker's outputs and
    decisions on every slot t*max_out + e, both states and, from the
    kernel, the misses.

    A CUDA tensor launches the kernel (and counts the launch in
    ``symsync_pll_lms.launches``; L <= LMAX, Lb <= LB_MAX and the bank
    within BANK_MAX floats there, else ValueError); a CPU tensor runs the
    plain version.
    """
    _check(planes, kern, fstate, istate, pll_state, post, npfb, max_out,
           win)
    kw = dict(npfb=npfb, max_out=max_out, k=k, k_out=k_out, bw=bw,
              locked=locked)
    if planes.device.type == "cpu":
        return symsync_pll_lms_reference(planes, kern, fstate, istate,
                                         pll_state, post, **kw)
    if planes.device.type != "cuda":
        raise ValueError(f"symsync_pll_lms runs on CUDA (kernel) or CPU "
                         f"(plain version) tensors, got device "
                         f"{planes.device}")
    P, B, n = planes.shape
    Lb = kern.shape[1]
    Tc = n - Lb + 1
    L, M = pll_state["ew_re"].shape[-1], post.tab_re.shape[0]
    if not 1 <= L <= LMAX:
        raise ValueError(f"symsync_pll_lms kernel takes 1 <= L <= {LMAX} "
                         f"equalizer taps, got {L}")
    if Lb > LB_MAX or 2 * npfb * tap_pitch(Lb) > BANK_MAX:
        raise ValueError(f"symsync_pll_lms kernel takes up to {LB_MAX} taps "
                         f"a branch and {BANK_MAX} floats of bank, got "
                         f"{2 * npfb} x {Lb}")
    win = win or min(FILTER_WIN or npfb, npfb)
    dev = planes.device
    S = Tc * max_out
    fs = fstate.clone()
    is_ = istate.clone()
    st = {key: pll_state[key].clone() for key in STATE_KEYS}
    dot_in = pll_state.get("dot") is not None
    st["dot"] = (pll_state["dot"].clone() if dot_in else
                 torch.zeros(2, B, dtype=torch.float32, device=dev))
    y_re = torch.empty(B, S, dtype=torch.float32, device=dev)
    y_im = torch.empty_like(y_re)
    dec = torch.empty(B, S, dtype=torch.int32, device=dev)
    valid = torch.empty(B, S, dtype=torch.bool, device=dev)
    misses = torch.zeros(B, dtype=torch.int32, device=dev)
    if B == 0 or Tc == 0:
        return FusedOut(valid, y_re, y_im, dec, fs, is_, st, misses)
    from .build import load_library
    lib = load_library()
    c_q, c_v, c_r = loop_consts(bw)
    s2v, kq = post.qpsk if post.qpsk is not None else (0.0, (0, 0, 0, 0))
    with torch.cuda.device(dev):
        rc = lib.symsync_pll_lms_launch(
            planes.data_ptr(), planes.stride(0), planes.stride(1),
            kern.data_ptr(), Lb, win, fs.data_ptr(), is_.data_ptr(),
            *(st[key].data_ptr() for key in STATE_KEYS), st["dot"].data_ptr(),
            post.tab_re.data_ptr(), post.tab_im.data_ptr(), y_re.data_ptr(),
            y_im.data_ptr(), dec.data_ptr(), valid.data_ptr(),
            misses.data_ptr(), B, Tc, npfb, P, max_out, k_out,
            int(bool(locked)), L, M, int(post.qpsk is not None), *kq,
            int(dot_in), inverse_k(k), c_q, c_v, c_r, post.alpha, post.beta2,
            post.mu, float(s2v), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"symsync_pll_lms kernel launch failed: CUDA "
                           f"error {rc}")
    symsync_pll_lms.launches += 1
    return FusedOut(valid, y_re, y_im, dec, fs, is_, st, misses)


symsync_pll_lms.launches = 0
