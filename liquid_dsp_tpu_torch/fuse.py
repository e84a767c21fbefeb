"""LTI chain fusion: collapse adjacent FIR/decimator stages into ONE
strided FIR, and a (mixer -> fused FIR) pair into one kernel
(`liquid_dsp_tpu/fuse.py`).

Adjacent LTI stages ``y[i] = sum_j h[j] * x[down*i + d - j]`` compose
into a single stage with

    taps' = conv(h1, upsample(h2, down1))
    down' = down1 * down2
    d'    = d1 + down1 * d2

The composition runs on the host in numpy float64/complex128 and only
the final taps become float32/complex64, so the port's fused taps equal
the JAX package's bit for bit.  Stages advertise their LTI description
via `Proc.lti`; anything without it (NCO mixers, nonlinear ops) is left
in place and only maximal LTI runs between them are fused.
"""
from __future__ import annotations

import numpy as np
import torch

from . import trace
from .core import LTI, Chain, Proc, chain, planar_per_plane
from .ops.dotprod import conv1d
from .ops.fir import _coerce, _np_taps, fir_apply_matmul
from .ops.kernels.mix_fir_decim import (SUB, fold_offset, make_ramp,
                                        mix_fir_decim)

__all__ = ["fuse", "fused_fir", "kernel_fuse", "FusedFIR", "MixFIRDecim"]


def _flatten(proc: Proc):
    if not isinstance(proc, Chain):
        return [proc]
    out = []
    for c in proc.stages:
        out.extend(_flatten(c))
    return out


def _upsample(h: np.ndarray, k: int) -> np.ndarray:
    if k == 1 or h.shape[-1] == 1:
        return h
    z = np.zeros((h.shape[-1] - 1) * k + 1, dtype=h.dtype)
    z[::k] = h
    return z


def _compose(a: LTI, b: LTI) -> LTI:
    """LTI composition: stage a THEN stage b."""
    ha = np.atleast_1d(np.asarray(a.taps, dtype=np.complex128 if
                                  (np.iscomplexobj(a.taps) or
                                   np.iscomplexobj(b.taps)) else np.float64))
    hb = np.atleast_1d(np.asarray(b.taps, dtype=ha.dtype))
    taps = np.convolve(ha, _upsample(hb, a.down))
    return LTI(taps=taps, down=a.down * b.down, d=a.d + a.down * b.d)


class FusedFIR(Proc):
    """``y[i] = sum_j taps[j] x[down*i + d - j]`` as one pass: the strided
    conv on the CPU, the banded-tap matmul at full rate + strided slice
    on CUDA (torch.matmul is full float32 there by default).  Carry: the
    last L-1 raw input samples."""

    param_spec = {"h": "h"}

    def __init__(self, meta: LTI, name: str = "fused_fir"):
        super().__init__(name)
        h_np = _np_taps(np.asarray(meta.taps))
        self.down, self.d = int(meta.down), int(meta.d)
        if self.d < 0 or self.d >= self.down:
            raise ValueError(f"fused offset d={self.d} must satisfy "
                             f"0 <= d < down")
        self.L = int(h_np.shape[-1])
        self._buffer("h", h_np)
        self.rate = (1, self.down)
        self.halo = self.L - 1
        self.lti = LTI(h_np, self.down, self.d)
        if not np.iscomplexobj(h_np):
            # real taps filter each plane independently (planar.py)
            self.forward_planar, self.init_planar = planar_per_plane(
                self.forward, self.init)

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return torch.zeros(batch_shape + (self.L - 1,), dtype=dtype,
                           device=device)

    def _apply_one(self, c, x):
        L, d, down = self.L, self.d, self.down
        if x.device.type == "cuda":
            yf, c2 = fir_apply_matmul(self.h, c, x, tile=256)
            return (yf[..., d::down] if (down > 1 or d) else yf), c2
        xp = torch.cat([c, x], dim=-1) if L > 1 else x
        c2 = xp[..., xp.shape[-1] - (L - 1):] if L > 1 else c
        return conv1d(xp[..., d:] if d else xp, self.h, stride=down), c2

    def forward(self, carry, x):
        return self._apply_one(_coerce(carry, x.dtype), x)


def fused_fir(meta: LTI, name: str = "fused_fir") -> FusedFIR:
    """A Proc computing ``y[i] = sum_j taps[j] x[down*i + d - j]`` in one
    pass (see `FusedFIR`)."""
    return FusedFIR(meta, name)


class MixFIRDecim(Proc):
    """Mixer + fused FIR + decimation as ONE kernel (`kernel_fuse`).

    Planar carry: {"tr", "ti": [B, SUB] float32 raw pre-mix samples,
    "theta": scalar float32 NCO phase}, the JAX package's keys, shapes
    and dtypes.  Buffers: the folded taps and the mixer ramp."""

    def __init__(self, name, taps, down, dphi, theta0, sgn, out_dtype):
        super().__init__(name)
        L = int(taps.shape[-1])
        self._buffer("taps", taps)
        ramp_c, ramp_s = make_ramp(L, dphi)
        self._buffer("ramp_c", ramp_c)
        self._buffer("ramp_s", ramp_s)
        self.down, self.dphi, self.theta0, self.sgn = down, dphi, theta0, sgn
        self.out_dtype = out_dtype
        self.rate = (1, down)
        self.halo = L - 1

    def init_planar(self, batch_shape=(), dtype=torch.float32, device=None):
        if len(batch_shape) > 1:
            raise ValueError("kernel_fuse supports rank<=1 batch shapes")
        B = batch_shape[0] if batch_shape else 1
        z = torch.zeros((B, SUB), dtype=torch.float32, device=device)
        return {"tr": z, "ti": z,
                "theta": torch.tensor(self.theta0, dtype=torch.float32,
                                      device=device)}

    def forward_planar(self, carry, x):
        r, i = x
        flat = r.dim() == 1
        if flat:
            r, i = r[None], i[None]
        # bfloat16 planes pass straight through to the kernel (exact for
        # 8-bit captures); the OUTPUT dtype is the explicit out_dtype
        # policy: float32 unless the caller opted into narrowing
        od = (r.dtype if self.out_dtype == "input"
              else torch.float32 if self.out_dtype is None
              else self.out_dtype)
        with trace.span("mix_fir_decim.launch"):
            yr, yi = mix_fir_decim(
                r, i, carry["tr"], carry["ti"], carry["theta"],
                self.ramp_c, self.ramp_s, self.taps, down=self.down,
                sgn=self.sgn, dphi=self.dphi, out_dtype=od)
        with trace.span("mix_fir_decim.carry"):
            step = float(np.float32(np.mod(self.dphi * r.shape[-1],
                                           2 * np.pi)))
            theta = torch.remainder(carry["theta"] + step + np.pi,
                                    2 * np.pi) - np.pi
            new_carry = {"tr": r[:, -SUB:].float().contiguous(),
                         "ti": i[:, -SUB:].float().contiguous(),
                         "theta": theta}
        if flat:
            yr, yi = yr[0], yi[0]
        return (yr, yi), new_carry

    init = init_planar

    def forward(self, carry, x):
        (yr, yi), c2 = self.forward_planar(
            carry, (x.real.contiguous(), x.imag.contiguous()))
        return torch.complex(yr, yi), c2


def kernel_fuse(proc: Proc, out_dtype=None) -> Proc:
    """Collapse a (mixer -> fused-FIR) pair into ONE kernel
    (ops/kernels/mix_fir_decim.py: a CUDA kernel on the card, its plain
    PyTorch version on the CPU).

    Pattern-matches a chain whose flattened stages are exactly
    [nco (VCO mode, scalar phase), LTI stage (real taps, L <= 257)] —
    the shape `fuse()` leaves the headline chain in.  Anything that
    doesn't match is returned unchanged, so `kernel_fuse(fuse(p))` is
    always safe.

    ``out_dtype``: None (default) emits float32 regardless of input
    dtype; ``"input"`` follows the input planes' dtype; a torch dtype
    forces that.  Arithmetic and the carry are float32 in all cases.

    Constraints at run time: block length a multiple of 2048, batch a
    multiple of 8, batch_shape of rank 1 (or scalar), phase shared
    across the batch."""
    stages = _flatten(proc)
    if len(stages) != 2:
        return proc
    mix, fir = stages
    m = mix.meta or {}
    if (m.get("kind") != "nco" or m.get("table") or fir.lti is None
            or np.iscomplexobj(fir.lti.taps)
            or np.atleast_1d(fir.lti.taps).shape[-1] > SUB + 1):
        return proc
    down = int(fir.lti.down)
    if SUB % down:
        return proc
    taps = fold_offset(np.asarray(fir.lti.taps, np.float32), fir.lti.d)
    return MixFIRDecim(proc.name + "_kernel", taps, down, m["dphi"],
                       m["theta0"], m["sgn"], out_dtype)


def fuse(proc: Proc, min_run: int = 2) -> Proc:
    """Return an equivalent Proc with maximal runs of adjacent LTI stages
    collapsed into single strided FIRs.

    Nested chains are flattened first (composition is associative); the
    returned Proc has a FRESH carry structure — fuse before `init`, not
    mid-stream.  Stages without `Proc.lti` are kept verbatim.  A run
    shorter than `min_run` is left alone."""
    stages = _flatten(proc)
    if not any(s.lti is not None for s in stages):
        return proc
    out = []
    run = []

    def close_run():
        if len(run) >= min_run:
            meta = run[0].lti
            for s in run[1:]:
                meta = _compose(meta, s.lti)
            out.append(fused_fir(
                meta, name="fused(" + "+".join(s.name for s in run) + ")"))
        else:
            out.extend(run)
        run.clear()

    for s in stages:
        if s.lti is not None and np.asarray(s.lti.taps).ndim == 1:
            run.append(s)
        else:
            close_run()
            out.append(s)
    close_run()
    if len(out) == 1:
        return out[0]
    return chain(*out, name=proc.name + "_fused")
