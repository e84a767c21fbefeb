"""Symbol timing recovery (symsync): polyphase matched-filter pair with a
timing-error feedback loop (`liquid_dsp_tpu/ops/symsync.py`).

Reference analog: src/filter/src/symsync.c:76-607 — matched + derivative
matched firpfb pair; timing error q = Re(conj(mf)*dmf), a 2nd-order loop
filter (set_lf_bw), the timing phase tau advancing by `del` per output.

Two formulations, as in the JAX package:

* the scan body (`symsync_run` with ``hoist=False``, the CPU default and
  CPU only, kept for bit-compatibility with the goldens): a per-sample
  loop that keeps
  the filter window and dots the selected branch's taps each emit;
* the hoisted form (`_symsync_run_hoisted`, the CUDA default): every
  branch output is computed up front per chunk (`ops/kernels/branch_bank`,
  where the JAX package takes a conv), and the timing loop only picks
  which branch to read.  On CUDA the loop is the hand-written kernel
  `ops/kernels/symsync_scan` (the port of the TPU kernel
  `pallas_symsync.symsync_scan_pallas`); with symtrack's PLL + LMS as its
  post hook the whole block is one launch of `ops/kernels/symsync_pll_lms`,
  which filters the branches it reads itself with branch_bank's
  arithmetic.  On the CPU their plain versions run.

Each input step emits at most ceil(k/k_out)+1 outputs; outputs come
padded with a validity mask (variable-rate output).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core import Proc
from ..design.firdes import firdes_kaiser, firdes_prototype
from .kernels.branch_bank import branch_bank
from .kernels.symsync_pll_lms import PllLmsPost, symsync_pll_lms
from .kernels.symsync_scan import (fma32, inverse_k, loop_consts,
                                   symsync_scan, symsync_scan_reference)

__all__ = ["symsync", "symsync_run", "symsync_banks", "symsync_kaiser_banks",
           "symsync_kaiser", "Symsync"]

CUDA_CHUNK = 4096    # steps per branch-output chunk on the card


def symsync_banks(ftype: str, k: int, m: int, beta: float, npfb: int):
    """(MF, dMF) polyphase banks [npfb, 2*k*m] float32 (reference
    firpfb_create_rnyquist / _create_drnyquist, firpfb.c:188-213)."""
    H = firdes_prototype(ftype, k * npfb, m, beta).astype(np.float64)
    return _derivative_bank(H, npfb)


def _derivative_bank(H: np.ndarray, npfb: int):
    """Central-difference derivative prototype, normalized like the
    reference's firpfb _create_drnyquist."""
    dH = np.empty_like(H)
    dH[1:-1] = H[2:] - H[:-2]
    dH[0] = H[1] - H[-1]
    dH[-1] = H[0] - H[-2]
    dH *= 0.06 / np.max(np.abs(H * dH))
    Lb = (len(H) - 1) // npfb
    mf = np.stack([H[b + np.arange(Lb) * npfb] for b in range(npfb)])
    dmf = np.stack([dH[b + np.arange(Lb) * npfb] for b in range(npfb)])
    return mf.astype(np.float32), dmf.astype(np.float32)


def symsync_kaiser_banks(k: int, m: int, npfb: int):
    """Wideband Kaiser interpolating banks for already Nyquist-shaped
    input (reference symsync.c:252-289 _create_kaiser: fc = 0.75, 40 dB)."""
    n = 2 * npfb * k * m + 1
    H = firdes_kaiser(n, 0.75 / (k * npfb), 40.0).astype(np.float64)
    H *= (k * npfb) / H.sum()
    return _derivative_bank(H, npfb)


def _timing_update(st, q_raw, active, k_out: int, locked: bool, bw: float,
                   npfb: int):
    """One emit's timing-loop state update, in the arithmetic of the
    hoisted loop (`ops/kernels/symsync_scan.py`: the loop filter's
    constants from `loop_consts`, FMAs where XLA takes them), so both
    formulations have the same loop dynamics."""
    c_q, c_v, c_r = loop_consts(bw)
    zero = torch.zeros((), dtype=torch.float32, device=q_raw.device)
    run = (st["decim"] == k_out) & active & (not locked)
    q = q_raw.clamp(-1.0, 1.0)
    q_hat = fma32(torch.full_like(q, c_q), q, st["v0"])
    v0 = c_v * q_hat
    rate = fma32(torch.full_like(q, c_r), q_hat, st["rate"])
    dl = rate + q_hat
    tau = st["tau"] + torch.where(active, st["del"], zero)
    new = {
        "tau": tau,
        "rate": torch.where(run, rate, st["rate"]),
        "del": torch.where(run, dl, st["del"]),
        "v0": torch.where(run, v0, st["v0"]),
        "v1": torch.where(run, zero, st["v1"]),
        "decim": torch.where(active, torch.where(
            st["decim"] == k_out, 1, st["decim"] + 1), st["decim"]),
    }
    new["bf"] = tau * npfb
    new["b"] = torch.round(new["bf"]).to(torch.int32)
    return {**st, **new}


def _fused_kernel(post, device: torch.device) -> bool:
    """Whether the post hook runs inside the fused timing + PLL/LMS kernel
    (`ops/kernels/symsync_pll_lms`): on CUDA symtrack's `PllLmsPost` does,
    and any other callable raises NotImplementedError there (not carried
    over, by decision: a Python callable cannot run inside the kernel's
    recurrence, and a per-emit loop on the card would be the plain version
    on the main path).  On the CPU every hook runs in the plain loop."""
    if post is None or device.type != "cuda":
        return False
    if isinstance(post, PllLmsPost):
        return True
    raise NotImplementedError(
        f"symsync with a post hook on CUDA runs symtrack's PLL + LMS "
        f"(PllLmsPost) in the fused kernel only, got "
        f"{type(post).__name__}: a Python callable cannot run inside the "
        f"kernel's recurrence (Not carried over, by decision); run it on "
        f"the CPU")


def _use_scan_kernel(device: torch.device, post) -> bool:
    """The timing-loop kernel replaces the per-step loop when no post hook
    rides along.  On CUDA that is always (at any batch and chunk length:
    the JAX package's B <= 32 and 32-step conditions are TPU
    measurements); on the CPU, as in the JAX package, only when
    LIQUID_SYMSYNC_KERNEL=1, and then its plain version runs (the same
    values)."""
    if post is not None:
        return False
    if device.type == "cuda":
        return True
    return os.environ.get("LIQUID_SYMSYNC_KERNEL") == "1"


def _hoist_chunk(T: int) -> int:
    """Largest divisor of T in [256, 4096] (the JAX package's equal
    chunks; the CPU path keeps them)."""
    for cand in range(min(T, 4096), 255, -1):
        if T % cand == 0:
            return cand
    return T


def _chunks(T: int, cuda: bool):
    """(start, length) of the branch-output chunks: on the card at most
    CUDA_CHUNK steps with a ragged last chunk (the [P, B, 2*npfb, Tc]
    buffer stays bounded at any T), on the CPU the JAX package's."""
    Tc = min(T, CUDA_CHUNK) if cuda else _hoist_chunk(T)
    return [(s, min(Tc, T - s)) for s in range(0, T, Tc)]


def branch_kernel(mf_bank, dmf_bank, device) -> torch.Tensor:
    """The bank [2*npfb, Lb] of the hoisted form: the banks flipped
    (out[t] = sum_j xp[t+j] * bank[b, ::-1][j]); rows 0..npfb-1 the MF,
    the rest the dMF."""
    mf = torch.as_tensor(mf_bank, dtype=torch.float32, device=device)
    dmf = torch.as_tensor(dmf_bank, dtype=torch.float32, device=device)
    return torch.cat([mf.flip(1), dmf.flip(1)], 0).contiguous()


def loop_state(carry, Bf: int):
    """A symsync carry's loop state in `symsync_scan`'s form: fstate
    [6, Bf] (tau, rate, del, v0, bf, ran-any = 0) and istate [2, Bf]
    (b, decim)."""
    fs = torch.stack([carry[key].reshape(Bf).to(torch.float32) for key in
                      ("tau", "rate", "del", "v0", "bf")]
                     + [torch.zeros(Bf, dtype=torch.float32,
                                    device=carry["tau"].device)])
    is_ = torch.stack([carry["b"].reshape(Bf), carry["decim"].reshape(Bf)]
                      ).to(torch.int32)
    return fs, is_


def _join(parts, empty):
    """The chunks' [B, n] pieces along time (one piece as it is)."""
    if not parts:
        return empty
    return parts[0] if len(parts) == 1 else torch.cat(parts, -1)


def _symsync_run_hoisted(mf_bank, dmf_bank, carry, x, k: int,
                         k_out: int = 1, bw: float = 0.01,
                         locked: bool = False, post=None, post_carry=None):
    """Hoisted-MF formulation: all branch matched-filter outputs of a
    chunk come from `branch_bank` (the kernel on CUDA, its plain version
    on the CPU; each output summed tap by tap in one fixed order), and the
    timing loop runs over them (`symsync_scan`: likewise).
    Value-equivalent to the scan body (the same loop arithmetic; the MF
    dots reassociated).

    post(pc, y_re, y_im, valid) -> (pc', extras) runs after every emit
    (symtrack's fused PLL + LMS).  On CUDA the post must be a `PllLmsPost`
    and the block is one launch of the fused kernel `symsync_pll_lms`,
    which takes the input planes and filters its branches itself
    (`_fused_kernel` decides); on the CPU any post runs in the plain loop,
    chunk by chunk.  Returns (y, valid, carry') or, with post, (None,
    valid, carry', extras, pc'): the fused kernel keeps the timing loop's
    slots to itself, and the CPU returns what the card returns."""
    cuda = x.device.type == "cuda"
    fused = _fused_kernel(post, x.device)
    dev = x.device
    kern = branch_kernel(mf_bank, dmf_bank, dev)
    npfb, Lb = kern.shape[0] // 2, kern.shape[-1]
    max_out = int(np.ceil(k / k_out)) + 1
    batch = tuple(x.shape[:-1])
    T = int(x.shape[-1])
    Bf = int(np.prod(batch)) if batch else 1
    cplx = x.is_complex()
    prefix = carry["win"][..., 1:].to(x.dtype)
    xp = torch.cat([prefix, x], dim=-1).reshape(Bf, T + Lb - 1)
    planes = torch.stack([xp.real, xp.imag]) if cplx else xp[None]
    planes = planes.to(torch.float32).contiguous()
    fs, is_ = loop_state(carry, Bf)
    use_kernel = _use_scan_kernel(dev, post)
    kw = dict(npfb=npfb, max_out=max_out, k=k, k_out=k_out, bw=bw,
              locked=locked)
    v1 = carry["v1"].reshape(Bf)
    ys_re, ys_im, vs, exs = [], [], [], []
    pc = post_carry
    if fused and T:
        # one launch for the block: no branch outputs to bound
        fs[5] = 0.0
        out = symsync_pll_lms(planes, kern, fs, is_, pc, post, **kw)
        fs, is_, pc = out.fstate, out.istate, out.pll_state
        v1 = torch.where(fs[5] > 0.5, torch.zeros_like(v1), v1)
        vs.append(out.valid)
        exs.append((out.y_re, out.y_im, out.dec))
    for s, Tc in [] if fused else _chunks(T, cuda):
        fs[5] = 0.0
        ma = branch_bank(planes[..., s:s + Tc + Lb - 1], kern)
        if use_kernel:
            y_re, y_im, val, fs, is_ = symsync_scan(ma, fs, is_, **kw)
        else:
            out = symsync_scan_reference(ma, fs, is_, **kw, post=post,
                                         post_carry=pc)
            y_re, y_im, val, fs, is_ = out[:5]
            if post is not None:
                exs.append(out[5])
                pc = out[6]
        v1 = torch.where(fs[5] > 0.5, torch.zeros_like(v1), v1)
        if post is None:
            ys_re.append(y_re)
            ys_im.append(y_im)
        vs.append(val)
    shape = batch + (T * max_out,)
    valid = _join(vs, torch.zeros(Bf, 0, dtype=torch.bool,
                                  device=dev)).reshape(shape)
    win = (torch.cat([prefix, x], dim=-1)[..., -Lb:] if T >= 1
           else carry["win"])
    new_carry = {
        "win": win, "tau": fs[0].reshape(batch), "bf": fs[4].reshape(batch),
        "b": is_[0].reshape(batch), "rate": fs[1].reshape(batch),
        "del": fs[2].reshape(batch), "v0": fs[3].reshape(batch),
        "v1": v1.reshape(batch), "decim": is_[1].reshape(batch)}
    if post is None:
        y_re = _join(ys_re, fs.new_zeros(Bf, 0))
        if cplx:
            y = torch.complex(y_re, _join(ys_im, fs.new_zeros(Bf, 0)))
            y = y.reshape(shape)
        else:
            y = y_re.reshape(shape)
        return y, valid, new_carry
    ex = tuple(_join([e[j] for e in exs], None).reshape(shape)
               for j in range(len(exs[0]))) if exs else ()
    if fused:
        pc = {key: v for key, v in pc.items() if key != "dot"}
    return None, valid, new_carry, ex, pc


def symsync_run(mf_bank, dmf_bank, carry, x, k: int, k_out: int = 1,
                bw: float = 0.01, locked: bool = False, hoist=None):
    """Run the synchronizer over a block; returns (y, valid, carry').

    hoist=None takes the hoisted form on CUDA (the kernel) and the scan
    body on the CPU (golden bit-compatibility), as the JAX package takes
    it off and on its CPU.  The scan body is a per-step loop: on CUDA
    hoist=False raises."""
    cuda = x.device.type == "cuda"
    if hoist is None:
        hoist = cuda
    if not hoist and cuda:
        raise ValueError(
            "symsync_run(hoist=False) is the per-step scan body, kept for "
            "the CPU's goldens; on CUDA symsync runs the hoisted form "
            "(hoist=None or True)")
    if hoist:
        return _symsync_run_hoisted(mf_bank, dmf_bank, carry, x, k, k_out,
                                    bw, locked)
    dev = x.device
    mf = torch.as_tensor(mf_bank, dtype=torch.float32, device=dev)
    dmf = torch.as_tensor(dmf_bank, dtype=torch.float32, device=dev)
    npfb, Lb = mf.shape
    max_out = int(np.ceil(k / k_out)) + 1
    # one stacked bank [npfb, 2*Lb]: a single branch selection gives both
    # the MF and the dMF taps
    both = torch.cat([mf.flip(1), dmf.flip(1)], dim=1)
    inv_k = inverse_k(k)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    cplx = x.is_complex()
    state = dict(carry)
    win = state["win"].to(x.dtype)
    ys, vs = [], []
    for t in range(x.shape[-1]):
        win = torch.cat([win[..., 1:], x[..., t:t + 1]], dim=-1)
        planes = (torch.stack([win.real, win.imag], -2) if cplx
                  else win[..., None, :])
        for _ in range(max_out):
            active = state["b"] < npfb
            taps = both[state["b"].clamp(0, npfb - 1).long()]
            # [.., P, Lb] window planes x [.., Lb, 2] (MF, dMF) taps
            dots = torch.matmul(planes, taps.unflatten(-1, (2, Lb)).transpose(
                -1, -2))
            mf_re, dmf_re = dots[..., 0, 0], dots[..., 0, 1]
            if cplx:
                mf_im, dmf_im = dots[..., 1, 0], dots[..., 1, 1]
                q_raw = fma32(mf_re, dmf_re, mf_im * dmf_im)
                out = torch.complex(torch.where(active, mf_re * inv_k, zero),
                                    torch.where(active, mf_im * inv_k, zero))
            else:
                q_raw = mf_re * dmf_re
                out = torch.where(active, mf_re * inv_k, zero)
            state = _timing_update(state, q_raw, active, k_out, locked, bw,
                                   npfb)
            ys.append(out)
            vs.append(active)
        state["tau"] = state["tau"] - 1.0
        state["bf"] = state["bf"] - npfb
        state["b"] = state["b"] - npfb
    state["win"] = win
    shape = tuple(x.shape[:-1]) + (x.shape[-1] * max_out,)
    if not ys:
        return (torch.zeros(shape, dtype=x.dtype, device=dev),
                torch.zeros(shape, dtype=torch.bool, device=dev), state)
    return (torch.stack(ys, -1).reshape(shape),
            torch.stack(vs, -1).reshape(shape), state)


class Symsync(Proc):
    """Streaming symbol synchronizer: proc(carry, x[..., T]) ->
    ((y_padded, valid_mask), carry'); compact downstream with the mask.
    The banks are buffers ``mf`` and ``dmf`` [npfb, Lb]; `symsync_run`
    picks the formulation by device."""

    param_spec = {"mf": "mf", "dmf": "dmf"}

    def __init__(self, mf, dmf, k: int, k_out: int, bw: float, name: str):
        super().__init__(name)
        self._buffer("mf", mf)
        self._buffer("dmf", dmf)
        self.k, self.k_out, self.bw = int(k), int(k_out), float(bw)
        self.Lb = int(mf.shape[1])
        self.rate = (self.k_out, self.k)

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        kk = float(self.k) / self.k_out

        def full(v, dt=torch.float32):
            return torch.full(batch_shape, v, dtype=dt, device=device)

        return {"win": torch.zeros(batch_shape + (self.Lb,), dtype=dtype,
                                   device=device),
                "tau": full(0.0), "bf": full(0.0),
                "b": full(0, torch.int32), "rate": full(kk),
                "del": full(kk), "v0": full(0.0), "v1": full(0.0),
                "decim": full(self.k_out, torch.int32)}

    def forward(self, carry, x):
        y, v, c = symsync_run(self.mf, self.dmf, carry, x, self.k,
                              self.k_out, self.bw)
        return (y, v), c


def symsync(ftype: str = "arkaiser", k: int = 2, m: int = 5,
            beta: float = 0.3, npfb: int = 32, k_out: int = 1,
            bw: float = 0.01, name: str = "symsync") -> Symsync:
    """Streaming symbol synchronizer Proc (see `Symsync`)."""
    mf, dmf = symsync_banks(ftype, k, m, beta, npfb)
    return Symsync(mf, dmf, k, k_out, bw, name)


def symsync_kaiser(k: int = 2, m: int = 5, npfb: int = 32, k_out: int = 1,
                   bw: float = 0.01, name: str = "symsync_kaiser") -> Symsync:
    """Symbol synchronizer with the wideband Kaiser interpolating bank for
    already Nyquist-shaped input (reference symsync_crcf_create_kaiser,
    symsync.c:252-289).  Same streaming contract as `symsync`."""
    mf, dmf = symsync_kaiser_banks(k, m, npfb)
    return Symsync(mf, dmf, k, k_out, bw, name)
