"""Rate conversion (`liquid_dsp_tpu/ops/resample.py`): halfband
(resamp2: decimator, interpolator, QMF analyzer and synthesizer), the
dyadic cascade (msresamp2), the arbitrary polyphase resampler (resamp)
and the multi-stage arbitrary resampler (msresamp).

Reference analogs: src/filter/src/resamp2.c:60-124 (4m+1-tap halfband
Kaiser prototype), src/filter/src/msresamp2.c (cascade of resamp2
stages), src/filter/src/resamp.c:45-308 (per-sample loop over a timing
phase and a firpfb branch pair, linearly interpolated),
src/filter/src/msresamp.c:95-135 (halfband cascade + arbitrary
remainder).

Rates are exact rationals (num, den).  A block of T input samples
(T % den == 0) emits exactly T*num/den outputs, and resamp's timing
phase returns to the same value after every block, so its branch
schedule is static: one banded matmul on CUDA, num strided convolutions
on the CPU, a gather for num > 64.
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..core import LTI, Proc, chain, planar_per_plane
from ..design.windows import kaiser, kaiser_beta_as
from .dotprod import conv1d
from .fir import _np_taps, banded_blocks_apply, fir_apply_auto, firinterp

__all__ = ["halfband_taps", "resamp2_decim", "resamp2_interp",
           "resamp2_analyzer", "resamp2_synthesizer", "msresamp2",
           "resamp", "Resamp", "msresamp", "as_rational"]


def halfband_taps(m: int, f0: float = 0.0, as_db: float = 60.0) -> np.ndarray:
    """Kaiser-windowed halfband prototype, length 4m+1.

    Matches the construction in reference resamp2.c:95-106:
    h[i] = sinc(t/2) * kaiser(i; beta(As)) * exp(j*2*pi*t*f0), t = i - 2m.
    """
    if m < 2:
        raise ValueError("resamp2 filter semi-length must be at least 2")
    n = 4 * m + 1
    t = np.arange(n) - (n - 1) / 2.0
    h = np.sinc(t / 2.0) * kaiser(n, kaiser_beta_as(as_db))
    if f0 != 0.0:
        h = h * np.exp(2j * np.pi * t * f0)
    return h.astype(np.complex64 if f0 != 0.0 else np.float32)


class Resamp2Decim(Proc):
    """Halfband 2:1 decimator, sample-exact vs the reference
    (resamp2_crcf_decim_execute): y[i] = x_odd[i-m] + (h_odd * x_even)[i].
    DC gain 2, matching the reference decimator form.

    carry = last 4m-2 RAW input samples (even, so phase parity is
    preserved): the even-phase FIR needs 2m-1 past even samples and the
    delayed odd phase m past odd samples."""

    param_spec = ("h1",)

    def __init__(self, m: int = 7, f0: float = 0.0, as_db: float = 60.0,
                 name: str = "resamp2_decim"):
        super().__init__(name)
        full = halfband_taps(m, f0, as_db)
        h1 = np.ascontiguousarray(full[1::2])       # [2m] odd-position taps
        self._buffer("h1", _np_taps(h1))
        self.m = m
        self.rate = (1, 2)
        self.halo = 4 * m - 2
        # LTI view for chain fusion: y[i] = sum_j full[j] x[2i + 1 - j]
        self.lti = LTI(_np_taps(full), 2, 1)
        if not np.iscomplexobj(h1):
            self.forward_planar, self.init_planar = planar_per_plane(
                self.forward, self.init)

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return torch.zeros(batch_shape + (self.halo,), dtype=dtype,
                           device=device)

    def forward(self, carry, x):
        m, L = self.m, 2 * self.m
        xa = torch.cat([carry.to(x.dtype), x], dim=-1)
        xe = xa[..., 0::2]                      # [..., (L-1) + T/2]
        xo = xa[..., 1::2]
        y1, _ = fir_apply_auto(self.h1, xe[..., : L - 1], xe[..., L - 1:])
        y0 = xo[..., m - 1: xo.shape[-1] - m]   # odd phase delayed by m
        return y0 + y1, xa[..., xa.shape[-1] - self.halo:]


def resamp2_decim(m: int = 7, f0: float = 0.0, as_db: float = 60.0,
                  name: str = "resamp2_decim") -> Resamp2Decim:
    """Halfband 2:1 decimator Proc (see `Resamp2Decim`)."""
    return Resamp2Decim(m, f0, as_db, name)


def resamp2_interp(m: int = 7, f0: float = 0.0, as_db: float = 60.0,
                   name: str = "resamp2_interp"):
    """Halfband 1:2 interpolator (reference resamp2_crcf_interp,
    resamp2.c:345): zero-stuff, then the halfband filter (unity passband
    gain), as a `firinterp`."""
    return firinterp(2, halfband_taps(m, f0, as_db), name=name)


def _halfband_branch(m: int, as_db: float) -> np.ndarray:
    """The 2m-tap odd-sample branch of the QMF forms: the prototype's odd
    taps, reversed (reference resamp2.c:108-116)."""
    return _np_taps(halfband_taps(m, 0.0, as_db)[::-1][1::2].copy())


class _QMF(Proc):
    """Shared shape of the quadrature-mirror analyzer and synthesizer:
    the odd-sample branch h1 [2m] as a buffer, and the carry {"w0": the
    delay branch's last m samples, "w1": the filter branch's last 2m-1}."""

    param_spec = ("h1",)

    def __init__(self, m: int, as_db: float, name: str):
        super().__init__(name)
        self._buffer("h1", _halfband_branch(m, as_db))
        self.m = m

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return {"w0": torch.zeros(batch_shape + (self.m,), dtype=dtype,
                                  device=device),
                "w1": torch.zeros(batch_shape + (2 * self.m - 1,),
                                  dtype=dtype, device=device)}


class Resamp2Analyzer(_QMF):
    """Quadrature-mirror analysis bank, [..., T] -> [..., 2, T//2] (low
    band, high band; reference resamp2.c:271-292): inputs halved, the
    even samples through h1, the odd ones delayed; lo = filter + delay,
    hi = filter - delay."""

    def forward(self, carry, x):
        x = 0.5 * x
        x1, x0 = x[..., 0::2], x[..., 1::2]
        n = x0.shape[-1]
        xp0 = torch.cat([carry["w0"].to(x.dtype), x0], dim=-1)
        yd = xp0[..., :n]
        yf, w1 = fir_apply_auto(self.h1, carry["w1"].to(x.dtype), x1)
        return (torch.stack([yf + yd, yf - yd], dim=-2),
                {"w0": xp0[..., n:], "w1": w1})


def resamp2_analyzer(m: int = 7, as_db: float = 60.0,
                     name: str = "resamp2_analyzer") -> Resamp2Analyzer:
    """Quadrature-mirror analysis bank Proc (see `Resamp2Analyzer`)."""
    return Resamp2Analyzer(m, as_db, name)


class Resamp2Synthesizer(_QMF):
    """Quadrature-mirror synthesis bank, [..., 2, T//2] -> [..., T] (the
    dual of the analyzer, reference resamp2.c:296+): lo + hi feeds the
    delay branch (the even outputs), lo - hi the filter branch (the odd
    ones)."""

    def forward(self, carry, x):
        lo, hi = x[..., 0, :], x[..., 1, :]
        s, d = lo + hi, lo - hi
        n = s.shape[-1]
        xps = torch.cat([carry["w0"].to(s.dtype), s], dim=-1)
        yd = xps[..., :n]
        yf, w1 = fir_apply_auto(self.h1, carry["w1"].to(d.dtype), d)
        y = torch.stack([yd, yf], dim=-1)
        return (y.reshape(y.shape[:-2] + (2 * n,)),
                {"w0": xps[..., n:], "w1": w1})


def resamp2_synthesizer(m: int = 7, as_db: float = 60.0,
                        name: str = "resamp2_synth") -> Resamp2Synthesizer:
    """Quadrature-mirror synthesis bank Proc (see `Resamp2Synthesizer`)."""
    return Resamp2Synthesizer(m, as_db, name)


class _Gain(Proc):
    """Scalar gain stage (msresamp2's zeta compensation); stateless."""

    def __init__(self, gain: float, name: str):
        super().__init__(name)
        self.gain = float(gain)
        self.halo = 0
        self.lti = LTI(np.array([gain], np.float32), 1, 0)

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return ()

    def forward(self, carry, x):
        return self.gain * x, carry


class _Identity(Proc):
    """msresamp2 with no stages; stateless."""

    halo = 0

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return ()

    def forward(self, carry, x):
        return x, carry


def msresamp2(direction: str, num_stages: int, fc: float = 0.4,
              f0: float = 0.0, as_db: float = 60.0,
              name: str = "msresamp2") -> Proc:
    """Dyadic 2^k resampler: a cascade of halfband stages (reference
    msresamp2.c:38).  direction: 'interp' | 'decim'."""
    if direction not in ("interp", "decim"):
        raise ValueError(f"unknown direction {direction!r}")
    if num_stages == 0:
        return _Identity(name)
    # reference stage design (msresamp2.c create): fc halves per stage,
    # each stage's semi-length from the transition band ft = (0.5-fc)/2
    # via the Kaiser length estimate, m = ceil((h_len-1)/4)
    from ..design.firdes import estimate_req_filter_len
    make = resamp2_decim if direction == "decim" else resamp2_interp
    stages = []
    fc_i = fc
    for s in range(num_stages):
        fc_i = 0.5 * fc_i
        ft = (0.5 - fc_i) / 2.0
        h_len = estimate_req_filter_len(ft, as_db)
        m_stage = max(2, int(np.ceil((h_len - 1) / 4.0)))
        stages.append(make(m_stage, f0, as_db, name=f"{name}_hb{s}"))
    if direction == "interp":
        return chain(*stages[::-1], name=name)
    # each halfband decim stage has DC gain 2 (reference decimator form);
    # msresamp2 compensates with zeta = 2^-num_stages
    # (reference msresamp2.c:125,352)
    stages.append(_Gain(np.float32(0.5 ** num_stages), f"{name}_zeta"))
    return chain(*stages, name=name)


def as_rational(rate, max_den: int = 1 << 12):
    """Normalize a rate spec to an exact (num, den) pair."""
    if isinstance(rate, tuple):
        fr = Fraction(rate[0], rate[1])
    else:
        fr = Fraction(rate).limit_denominator(max_den)
    if fr <= 0:
        raise ValueError("resampling rate must be positive")
    return fr.numerator, fr.denominator


def _pfb_taps(npfb: int, m: int, fc: float, as_db: float) -> np.ndarray:
    """Polyphase bank coefficient matrix [npfb, 2m]: a length 2*m*npfb+1
    Kaiser lowpass at fc/npfb normalized to DC gain npfb (reference
    resamp.c:117-131); branch b's taps are h[j*npfb + b]."""
    from ..design.firdes import firdes_kaiser
    n = 2 * m * npfb + 1
    hf = firdes_kaiser(n, fc / npfb, as_db)
    hf = hf * (npfb / np.sum(hf))
    return hf[: n - 1].reshape(2 * m, npfb).T.astype(np.float32).copy()


class Resamp(Proc):
    """Arbitrary-rate polyphase resampler (reference resamp.c).

    Output k of a block lies at input position t_k = phi + k*den/num:
    base sample i_k = floor(t_k), soft bank index bf = frac(t_k)*npfb,
    branches b and b+1 linearly interpolated (resamp.c:275-289).  The
    indices are affine in k (the resamp.c:305-307 recurrence in closed
    form), and since den | T the outputs k = num*j + c share one branch
    pair per class c, whose combined taps are Hc[c].  Three routes,
    picked per call: ``backend="auto"`` takes the banded matmul on CUDA
    (one band maps each input tile straight to interleaved outputs,
    num <= 64) and the class form on the CPU (num strided convolutions);
    "matmul" and "conv" force one; for num > 64 every backend takes the
    gather form (two [.., n_out, 2m] windows a block: keep such blocks
    small).  Carry: {"tail": the last 2m input samples, "phi": the
    float32 timing phase, which stays at its initial 0}."""

    param_spec = ("H", "Hc")

    def __init__(self, rate, m: int = 7, fc: float = 0.25,
                 as_db: float = 60.0, npfb: int = 64, name: str = "resamp",
                 backend: str = "auto"):
        super().__init__(name)
        if backend not in ("auto", "matmul", "conv"):
            raise ValueError(f"unknown resamp backend {backend!r}")
        num, den = as_rational(rate)
        self.rate, self.npfb, self.backend = (num, den), npfb, backend
        self.L = L = 2 * m
        H = _pfb_taps(npfb, m, fc, as_db)               # [npfb, 2m]
        # per-class combined taps, support L+1 for the branch-wrap case
        # (the reference's boundary state evaluates branch 0 one sample
        # later); H rows index the n-th NEWEST sample, so flip
        Hc = np.zeros((num, L + 1), np.float32)
        self.qc = [(c * den) // num for c in range(num)]
        for c in range(num):
            bf = (((c * den) % num) / num) * npfb
            b = min(int(bf), npfb - 1)
            mu = bf - b
            if b + 1 < npfb:
                Hc[c, :L] = ((1 - mu) * H[b] + mu * H[b + 1])[::-1]
            else:
                Hc[c, :L] = ((1 - mu) * H[b])[::-1]
                Hc[c, 1:] += (mu * H[0])[::-1]
        self._buffer("H", H)
        self._buffer("Hc", Hc)
        # the banded matmul: column p*num + c holds class c's taps at row
        # offset p*den + qc[c] + 1, so a tile of tile_in inputs emits
        # tile_in*num/den outputs in one matmul
        self.tile_in = -(-192 // den) * den
        P_t = self.tile_in // den
        self.tile_out = P_t * num
        if num <= 64:
            band = np.zeros((self.tile_in + L + 1, self.tile_out), np.float32)
            for p in range(P_t):
                for c in range(num):
                    r0 = p * den + self.qc[c] + 1
                    band[r0:r0 + L + 1, p * num + c] = Hc[c]
            self.register_buffer("band", torch.from_numpy(band),
                                 persistent=False)

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return {"tail": torch.zeros(batch_shape + (self.L,), dtype=dtype,
                                    device=device),
                "phi": torch.zeros((), dtype=torch.float32, device=device)}

    def forward(self, carry, x):
        num, den = self.rate
        T = x.shape[-1]
        if T % den:
            raise ValueError(f"resamp rate {num}/{den}: block length {T} "
                             f"must be a multiple of {den}")
        n_out = T * num // den
        xp = torch.cat([carry["tail"].to(x.dtype), x], dim=-1)
        new_carry = {"tail": xp[..., xp.shape[-1] - self.L:],
                     "phi": carry["phi"]}
        if num > 64:
            return self._gather(xp, carry["phi"], T, n_out), new_carry
        if self.backend == "matmul" or (self.backend == "auto"
                                        and x.device.type == "cuda"):
            return (banded_blocks_apply(self.band, xp, n_out, self.tile_in,
                                        self.tile_out), new_carry)
        return self._classes(xp, T, n_out), new_carry

    def _classes(self, xp, T, n_out):
        """Class c is one stride-den correlation with Hc[c] over the
        padded input from qc[c] + 1 on."""
        num, den = self.rate
        J = T // den
        n_seg = (J - 1) * den + self.L + 1
        xpad = torch.cat([xp, torch.zeros(xp.shape[:-1] + (1,),
                                          dtype=xp.dtype, device=xp.device)],
                         dim=-1)
        # conv1d convolves (flips its taps): flip Hc[c] to correlate
        ys = [conv1d(xpad[..., q + 1:q + 1 + n_seg],
                     torch.flip(self.Hc[c], (-1,)), stride=den)
              for c, q in enumerate(self.qc)]
        return torch.stack(ys, dim=-1).reshape(xp.shape[:-1] + (n_out,))

    def _gather(self, xp, phi, T, n_out):
        """num > 64: per output its two branch windows, gathered."""
        num, den = self.rate
        npfb, L = self.npfb, self.L
        dev = xp.device
        k = torch.arange(n_out, device=dev)
        # exact integer split of t_k = phi + k*den/num:
        #   k*den = q*num + r  ->  t_k = phi + q + r/num
        q, r = torch.div(k * den, num, rounding_mode="floor"), (k * den) % num
        frac = phi + r.to(torch.float32) / num
        i = q + frac.to(torch.int64)            # phi in [0, 1)
        frac = frac - torch.floor(frac)
        bf = frac * npfb
        b = torch.clamp(bf.to(torch.int64), max=npfb - 1)
        mu = bf - b
        # branch b+1 may wrap to branch 0 of the NEXT sample (reference
        # resamp.c boundary state, resamp.c:252-262)
        b1 = b + 1
        i1 = i + torch.div(b1, npfb, rounding_mode="floor")
        b1 = torch.remainder(b1, npfb)
        self._check_gather_range(T, n_out)
        # output at base index i uses the window ENDING at x[i] (the
        # reference pushes x[i] before emitting, resamp.c:246): with the
        # L-sample tail prefix that is xp[i+1 .. i+L]
        j = torch.arange(L, device=dev)
        w0 = xp[..., i[:, None] + 1 + j[None, :]]       # [..., n_out, L]
        w1 = xp[..., i1[:, None] + 1 + j[None, :]]
        t0 = torch.flip(self.H[b], (-1,)).to(xp.dtype)  # [n_out, L]
        t1 = torch.flip(self.H[b1], (-1,)).to(xp.dtype)
        y0 = torch.einsum("...kj,kj->...k", w0, t0)
        y1 = torch.einsum("...kj,kj->...k", w1, t1)
        return y0 + mu.to(y0.dtype) * (y1 - y0)

    def _check_gather_range(self, T, n_out):
        """The gather reads xp[i1 + L] at most: the same schedule on the
        host (phi = 0) must stay inside the block, as it does by
        construction for the rates the reference supports.  Indices are
        never clamped."""
        num, den = self.rate
        kd = np.arange(n_out, dtype=np.int64) * den
        frac = (kd % num).astype(np.float32) / np.float32(num)
        i = kd // num + frac.astype(np.int64)
        b = np.minimum((frac * np.float32(self.npfb)).astype(np.int64),
                       self.npfb - 1)
        i1 = i + (b + 1) // self.npfb
        if n_out and int(i1.max()) > T - 1:
            raise ValueError(
                f"resamp rate {num}/{den}: the branch schedule reads past "
                f"the block (input {int(i1.max())} of {T})")


def resamp(rate, m: int = 7, fc: float = 0.25, as_db: float = 60.0,
           npfb: int = 64, name: str = "resamp",
           backend: str = "auto") -> Resamp:
    """Arbitrary-rate polyphase resampler Proc (see `Resamp`); rate is a
    float (rationalized) or an exact (num, den) tuple."""
    return Resamp(rate, m, fc, as_db, npfb, name, backend)


def msresamp(rate, as_db: float = 60.0, name: str = "msresamp") -> Proc:
    """Multi-stage arbitrary resampler (reference msresamp.c:95-135): a
    halfband cascade brings the rate into (0.5, 2], an arbitrary
    polyphase resampler takes the remainder (m=7, fc=0.4, npfb=64,
    reference msresamp.c:134).  Interpolating: the resampler first, then
    the halfband interpolators; an exact power of two is halfbands only."""
    num, den = as_rational(rate)
    arb = Fraction(num, den)
    n_hb = 0
    stages = []
    if arb > 1:
        while arb >= 2:
            n_hb += 1
            arb = arb / 2
        if arb != 1:
            stages.append(resamp((arb.numerator, arb.denominator), m=7,
                                 fc=0.4, as_db=as_db, npfb=64,
                                 name=f"{name}_arb"))
        if n_hb:
            stages.append(msresamp2("interp", n_hb, 0.4, 0.0, as_db,
                                    name=f"{name}_hb"))
        return chain(*stages, name=name)
    while arb <= Fraction(1, 2):
        n_hb += 1
        arb = arb * 2
    if n_hb:
        stages.append(msresamp2("decim", n_hb, 0.4, 0.0, as_db,
                                name=f"{name}_hb"))
    if arb != 1:
        stages.append(resamp((arb.numerator, arb.denominator), m=7, fc=0.4,
                             as_db=as_db, npfb=64, name=f"{name}_arb"))
    return chain(*stages, name=name)
