"""symtrack: streaming symbol tracker (AGC -> symbol sync -> carrier PLL
-> LMS equalizer -> decisions), ported from
`liquid_dsp_tpu/framing/symtrack.py`.

Reference analog: symtrack_cccf (src/framing/src/symtrack.c:42-124):
agc_crcf -> symsync (2 samples/symbol, root-Nyquist) -> eqlms_cccf -> an
NCO PLL driven by the demodulator's phase error -> symbol decisions.

Two routes, as in the JAX package.  The sequential route runs, on the
card, three hand-written kernels a block: the AGC's gain recurrence
(`ops/kernels/agc_scan`), the symsync timing loop
(`ops/kernels/symsync_scan`, after one conv1d per chunk) and the PLL +
decision-directed LMS over the symsync slots (`ops/kernels/pll_lms`;
the standalone `eqlms`/`eqrls` Procs run on `ops/kernels/eqlms_scan` and
`eqrls_scan` instead).  The fused route runs the PLL + LMS step inside
the timing loop: on the card `agc_scan`, then per chunk the conv1d and
one launch of `ops/kernels/symsync_pll_lms` (both chains side by side);
on the CPU the hoisted loop's plain version with the step as its post
hook.  `_use_fused` picks the route.  `symtrack` and `Symtrack`, which
take host arrays, run on the card unless the caller passes
``device="cpu"``, and raise without a card.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..core import Proc, entry_device
from ..modem import constellation, demodulate
from ..ops.agc import agc
from ..ops.equalize import eqlms_lowpass_weights
from ..ops.kernels.pll_lms import pll_lms
from ..ops.kernels.symsync_pll_lms import PllLmsPost
from ..ops.symsync import _hoist_chunk, _symsync_run_hoisted, symsync

__all__ = ["SymtrackResult", "symtrack", "symtrack_stream", "SymtrackStream",
           "Symtrack"]


def _use_fused(batch=(), device="cpu") -> bool:
    """The fused route (PLL + LMS inside the timing loop) or the
    sequential one (timing loop, then PLL + LMS over its slots), for a
    block of channel shape `batch` on `device`.  LIQUID_SYMTRACK_FUSED=0/1
    overrides, as in the JAX package.  Otherwise the CPU takes the
    sequential route (the JAX package's CPU default) and the card the fused
    one at every channel count: on an H100 at 32768 samples the fused step
    took 7.05 against 12.17 ms at 1 channel and 13.21 against 18.51 ms at
    256 (chip_smoke.py phase 41, PERF.md), both routes' chains being
    latency-bound and flat in the count, so `batch` (the JAX package's
    B > 32, a TPU measurement) does not decide here."""
    ov = os.environ.get("LIQUID_SYMTRACK_FUSED")
    if ov is not None:
        return ov == "1"
    return torch.device(device).type == "cuda"


class SymtrackResult(NamedTuple):
    symbols: np.ndarray    # recovered (equalized, derotated) symbols
    decisions: np.ndarray  # hard decisions (indices)


def symtrack(x, ftype: str = "arkaiser", k: int = 2, m: int = 7,
             beta: float = 0.3, ms: str = "qpsk", eq_len: int = 13,
             eq_mu: float = 0.05, pll_bw: float = 0.05,
             bandwidth: float = 0.9, device="cuda") -> SymtrackResult:
    """Track a continuous stream of modulated samples and return the
    recovered symbols (reference symtrack_cccf_execute_block).  ``device``
    is the card unless given.  The capture runs as one block of
    `symtrack_stream` from its initial state: the same AGC, symsync, PLL
    and LMS as the JAX package's one-shot (its PLL does not see the
    equalizer, so stepping both per slot equals the PLL over all symbols
    followed by the LMS), on the card's route (`_use_fused`).
    Decisions by `demodulate` on the compacted symbols."""
    dev = entry_device(device)
    x = torch.from_numpy(np.asarray(x, np.complex64)).to(dev)
    proc = symtrack_stream(ftype, k, m, beta, ms, eq_len, eq_mu,
                           pll_bw).to(dev)
    (sy, _, sv), _ = proc(proc.init(device=dev), x)
    syms = sy[sv]
    dec = demodulate(constellation(ms), syms)
    return SymtrackResult(syms.cpu().numpy(), dec.cpu().numpy())


class SymtrackStream(Proc):
    """Streaming symbol tracker (see `symtrack_stream`).  Buffers: the
    constellation as ``tab_re``/``tab_im`` and the equalizer's initial
    weights as ``w0_re``/``w0_im``; the AGC and symsync stages are
    submodules."""

    def __init__(self, ftype, k, m, beta, ms, eq_len, eq_mu, pll_bw, agc_bw,
                 sync_bw, name):
        super().__init__(name)
        self.ag = agc(bandwidth=agc_bw)
        self.ss = symsync(ftype, k, m, beta, bw=sync_bw)
        self.k, self.sync_bw = int(k), float(sync_bw)
        self.rate = (1, self.k)
        table = np.asarray(constellation(ms)).astype(np.complex64)
        self._buffer("tab_re", table.real.copy())
        self._buffer("tab_im", table.imag.copy())
        self.L = int(eq_len)
        # the PLL + LMS step, a submodule so that its table follows .to()
        self.post = PllLmsPost(table, alpha=float(pll_bw),
                               beta2=0.5 * float(pll_bw) ** 2,
                               mu=float(eq_mu))
        w0 = eqlms_lowpass_weights(self.L).astype(np.complex64)
        self._buffer("w0_re", w0.real.copy())
        self._buffer("w0_im", w0.imag.copy())

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        w = torch.complex(self.w0_re, self.w0_im).to(device=device,
                                                      dtype=dtype)
        L = self.L

        def full(v, dt=torch.float32):
            return torch.full(batch_shape, v, dtype=dt, device=device)

        return {"agc": self.ag.init(batch_shape, dtype, device),
                "ss": self.ss.init(batch_shape, dtype, device),
                "theta": full(0.0), "dtheta": full(0.0),
                "eq_w": w.expand(batch_shape + (L,)).clone(),
                "eq_buf": torch.zeros(batch_shape + (L,), dtype=dtype,
                                      device=device),
                # x2_sum/n primed at L: the window counts as full
                # (reference symtrack.c:122 eqlms_create_lowpass init)
                "eq_x2": full(float(L)), "eq_n": full(L, torch.int32)}

    def pll_state(self, carry, Bf: int):
        """The carry's PLL + LMS state on planes, channels flattened to
        [Bf] (the form `pll_lms` takes)."""
        L = self.L
        w, buf = carry["eq_w"], carry["eq_buf"]
        return {"theta": carry["theta"].reshape(Bf),
                "dtheta": carry["dtheta"].reshape(Bf),
                "ew_re": w.real.reshape(Bf, L).contiguous(),
                "ew_im": w.imag.reshape(Bf, L).contiguous(),
                "eb_re": buf.real.reshape(Bf, L).contiguous(),
                "eb_im": buf.imag.reshape(Bf, L).contiguous(),
                "eq_x2": carry["eq_x2"].reshape(Bf),
                "eq_n": carry["eq_n"].reshape(Bf)}

    def pll_kwargs(self):
        """`pll_lms`'s loop constants and slicer."""
        return self.post.kwargs()

    def forward(self, carry, x):
        batch = tuple(x.shape[:-1])
        Bf = int(np.prod(batch)) if batch else 1
        L = self.L
        y, agc_c = self.ag(carry["agc"], x)
        pc = self.pll_state(carry, Bf)
        # the CPU keeps the JAX package's guard against chunks that would
        # hold the whole block; the card's chunks are bounded and ragged
        if _use_fused(batch, x.device) and (
                x.device.type == "cuda"
                or _hoist_chunk(int(x.shape[-1])) <= 4096):
            _, sv, ss_c, (yr, yi, dt), pc = _symsync_run_hoisted(
                self.ss.mf, self.ss.dmf, carry["ss"], y, self.k, 1,
                self.sync_bw, post=self.post, post_carry=pc)
        else:
            (sy, sv), ss_c = self.ss(carry["ss"], y)
            S = sy.shape[-1]
            yr, yi, dt, pc = pll_lms(
                sy.real.reshape(Bf, S).contiguous(),
                sy.imag.reshape(Bf, S).contiguous(),
                sv.reshape(Bf, S).contiguous(), pc, self.tab_re, self.tab_im,
                **self.pll_kwargs())
        S = sv.shape[-1]
        out = (torch.complex(yr, yi).reshape(batch + (S,)),
               dt.reshape(batch + (S,)), sv)
        new = {"agc": agc_c, "ss": ss_c,
               "theta": pc["theta"].reshape(batch),
               "dtheta": pc["dtheta"].reshape(batch),
               "eq_w": torch.complex(pc["ew_re"], pc["ew_im"]).reshape(
                   batch + (L,)),
               "eq_buf": torch.complex(pc["eb_re"], pc["eb_im"]).reshape(
                   batch + (L,)),
               "eq_x2": pc["eq_x2"].reshape(batch),
               "eq_n": pc["eq_n"].reshape(batch)}
        return out, new


def symtrack_stream(ftype: str = "arkaiser", k: int = 2, m: int = 7,
                    beta: float = 0.3, ms: str = "qpsk", eq_len: int = 13,
                    eq_mu: float = 0.05, pll_bw: float = 0.05,
                    agc_bw: float = 0.02, sync_bw: float = 0.02,
                    name: str = "symtrack_stream") -> SymtrackStream:
    """Streaming symbol tracker Proc.

    proc(carry, x[..., T]) -> ((syms, decisions, valid), carry'): outputs
    at the symsync slot rate with a validity mask (compact with the
    mask); every stage's state persists in the carry, which has the JAX
    package's keys, shapes and dtypes."""
    return SymtrackStream(ftype, k, m, beta, ms, eq_len, eq_mu, pll_bw,
                          agc_bw, sync_bw, name)


class Symtrack:
    """Persistent symbol-tracker object (the reference symtrack_cccf
    create / execute / reset contract).  Feed sample arrays of any length;
    execute returns (symbols, decisions) recovered in that call.  State
    survives across calls; reset() re-arms everything.  device: where the
    tracker runs (the card unless given; without one a CUDA device
    raises)."""

    def __init__(self, ftype: str = "arkaiser", k: int = 2, m: int = 7,
                 beta: float = 0.3, ms: str = "qpsk", eq_len: int = 13,
                 eq_mu: float = 0.05, pll_bw: float = 0.05,
                 block_len: int = 4096, device="cuda"):
        self.device = entry_device(device)
        self._proc = symtrack_stream(ftype, k, m, beta, ms, eq_len, eq_mu,
                                     pll_bw).to(self.device)
        self.block_len = int(block_len) // k * k
        self.reset()

    def reset(self):
        self._carry = self._proc.init(device=self.device)
        self._pending = np.zeros(0, np.complex64)

    def execute(self, x):
        self._pending = np.concatenate(
            [self._pending, np.asarray(x, np.complex64)])
        syms, decs = [], []
        while len(self._pending) >= self.block_len:
            blk = torch.from_numpy(self._pending[:self.block_len].copy())
            self._pending = self._pending[self.block_len:]
            (sy, dec, sv), self._carry = self._proc(self._carry,
                                                    blk.to(self.device))
            syms.append(sy[sv].cpu().numpy())
            decs.append(dec[sv].cpu().numpy())
        if syms:
            return np.concatenate(syms), np.concatenate(decs)
        return np.zeros(0, np.complex64), np.zeros(0, np.int64)
