"""FIR filtering as block processors with explicit carry
(`liquid_dsp_tpu/ops/fir.py`).

Reference analogs:
  * firfilt   — src/filter/src/firfilt.c:297-360 (per-sample ring buffer +
                dotprod).  Here: one valid convolution over the whole
                block; carry = last (L-1) input samples, the overlap-save
                halo.
  * firdecim  — src/filter/src/firdecim.c: a strided convolution.
  * firinterp — src/filter/src/firinterp.c: one convolution per polyphase
                branch, interleaved.
  * firpfb    — src/filter/src/firpfb.c: every branch at once, one einsum.
  * firhilb   — src/filter/src/firhilb.c: Hilbert real <-> complex.
  * autocorr  — src/filter/src/autocorr.c: windowed autocorrelation.

Every filter picks its form per call as `fir_apply_auto` does: a banded
matmul on CUDA tensors, the conv form on the CPU.  All ops accept
[..., T] blocks (time last, leading axes batched).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import LTI, Proc, planar_per_plane
from .dotprod import conv1d
from .fftfilt import fftfilt_apply
from .kernels.fir_real import fir_apply_pallas

__all__ = ["firfilt", "FIRFilt", "firfilt_rect", "firdecim", "FIRDecim",
           "firinterp", "FIRInterp", "firpfb_execute", "firhilb",
           "firhilb_interp", "firhilb_r2c", "firhilb_c2r", "autocorr",
           "fir_freqresponse", "fir_apply", "fir_apply_auto",
           "fir_apply_matmul", "banded_blocks_apply"]


def _np_taps(h, scale=1.0):
    """Coefficient prep on the host: scale, then narrow float64/complex128
    to float32/complex64 (the tap dtypes of the JAX package)."""
    h = np.asarray(h)
    if scale != 1.0:
        h = h * scale
    if h.dtype == np.float64:
        h = h.astype(np.float32)
    elif h.dtype == np.complex128:
        h = h.astype(np.complex64)
    return h


def _coerce(carry, dtype):
    """Carry stores input samples; follow the input stream's dtype (a fresh
    complex-initialized carry feeding a real stream drops the zero imag)."""
    if carry.is_complex() and not dtype.is_complex:
        carry = carry.real
    return carry.to(dtype)


def fir_apply(h, carry, x, stride: int = 1):
    """One block of FIR filtering: returns (y, carry').

    carry is the last (len(h)-1) input samples (zeros initially).
    y[t] = sum_j h[j] * xp[t*stride - j] with xp = [carry | x], evaluated at
    output sample times aligned so y[0] corresponds to input x[0].
    """
    L = h.shape[-1]
    xp = torch.cat([carry, x], dim=-1) if L > 1 else x
    y = conv1d(xp, h, stride=stride)
    new_carry = xp[..., xp.shape[-1] - (L - 1):] if L > 1 else carry
    return y, new_carry


def banded_blocks_apply(band, xp, T_out, tile_in, tile_out):
    """Shared banded-matmul skeleton: pad xp to (nt+nb-1)*tile_in,
    reshape into non-overlapping input tiles, and accumulate the
    per-block ``[.., nt, tile_in] @ [tile_in, tile_out]`` matmuls;
    returns [.., nt*tile_out][..., :T_out].

    band: [rows, tile_out] tensor on xp's device.  Complex input x real
    band splits into planes (2 real matmuls); real input x complex band
    upcasts the input so the band's imaginary part is kept.  torch.matmul
    is full float32 unless ``torch.backends.cuda.matmul.allow_tf32``."""
    rows = int(band.shape[0])
    nt = -(-T_out // tile_out)
    nb = -(-rows // tile_in)
    tot = (nt + nb - 1) * tile_in
    pad_r = tot - xp.shape[-1]
    if pad_r > 0:
        xp = torch.nn.functional.pad(xp, (0, pad_r))
    elif pad_r < 0:
        xp = xp[..., :tot]
    if band.is_complex() and not xp.is_complex():
        xp = xp.to(band.dtype)
    if xp.is_complex() and not band.is_complex():
        planes = torch.stack([xp.real, xp.imag], dim=0)
        y2 = banded_blocks_apply(band, planes, T_out, tile_in, tile_out)
        return torch.complex(y2[0], y2[1])
    xpt = xp.reshape(xp.shape[:-1] + (nt + nb - 1, tile_in))
    y = None
    for b in range(nb):
        blk = band[b * tile_in:(b + 1) * tile_in]
        if blk.shape[0] < tile_in:
            blk = torch.nn.functional.pad(blk, (0, 0, 0, tile_in - blk.shape[0]))
        seg = xpt[..., b:b + nt, :]
        contrib = torch.matmul(seg, blk.to(seg.dtype))
        y = contrib if y is None else y + contrib
    return y.reshape(y.shape[:-2] + (nt * tile_out,))[..., :T_out]


def _banded_matmul(h, xp, T, tile, stride: int = 1):
    """[.., Tp] -> [.., T] banded-tap matmul (T OUTPUT samples, one per
    `stride` inputs); xp already carries the L-1 history prefix.  The
    [S*tile+L-1, tile] band matrix band[f, k] = h[k*S + L-1 - f] is split
    into [S*tile, tile] blocks over non-overlapping input tiles."""
    L = int(h.shape[-1])
    S = int(stride)
    tile_in = tile * S
    rows = tile_in + L - 1
    # indices made on the taps' device: a host array copied per call
    # would wait for the stream
    j = (torch.arange(tile, device=h.device)[None, :] * S + (L - 1)
         - torch.arange(rows, device=h.device)[:, None])
    band = torch.where((j >= 0) & (j < L), h[j.clamp(0, L - 1)],
                       torch.zeros((), dtype=h.dtype, device=h.device))
    return banded_blocks_apply(band, xp, T, tile_in, tile)


def fir_apply_matmul(h, carry, x, tile: int = 256, stride: int = 1):
    """FIR as a banded-tap matmul: frames [.., nt, tile+L-1] times band
    [tile+L-1, tile].  Identical output to fir_apply up to float32
    summation order."""
    L = int(h.shape[-1])
    T = int(x.shape[-1]) // int(stride)
    xp = torch.cat([carry.to(x.dtype), x], dim=-1)
    new_carry = xp[..., xp.shape[-1] - (L - 1):] if L > 1 else carry
    if h.is_complex() and not xp.is_complex():
        xp = xp.to(h.dtype)  # the band cast below must not drop imag
    if xp.is_complex() and not h.is_complex():
        planes = torch.stack([xp.real, xp.imag], dim=0)
        y2 = _banded_matmul(h, planes, T, tile, stride)
        return torch.complex(y2[0], y2[1]), new_carry
    return _banded_matmul(h, xp, T, tile, stride), new_carry


def fir_apply_auto(h, carry, x, stride: int = 1):
    """fir_apply with a per-call backend pick: the banded matmul on CUDA
    tensors (torch.matmul is full float32 by default there, cuDNN's
    conv1d is TF32 by default), the conv form on the CPU."""
    if x.device.type == "cuda" and x.shape[-1] % stride == 0:
        return fir_apply_matmul(h, carry, x, stride=stride)
    return fir_apply(h, carry, x, stride)


class FIRFilt(Proc):
    """Direct-form FIR filter over blocks (reference firfilt_crcf).

    Block length T in -> T out; carry: [..., L-1] input tail.
    backend: 'xla' (the conv form, `fir_apply`; the name is the JAX
    package's), 'matmul' (banded-tap matrix, `fir_apply_matmul`), 'fft'
    (overlap-save `fftfilt` with the SAME carry), 'pallas' (the
    hand-written CUDA kernel `ops/kernels/fir_real.py`, the port of the
    JAX package's Pallas kernel: real taps, any L on the CPU (its plain
    version), L <= 24576 on the card), or 'auto' (the `fir_apply_auto`
    pick per call: matmul on CUDA, conv on CPU).
    """

    param_spec = {"h": "h"}

    def __init__(self, h, scale=1.0, name: str = "firfilt",
                 backend: str = "auto"):
        super().__init__(name)
        h_np = _np_taps(h, scale)
        L = int(h_np.shape[-1])
        if backend == "pallas" and np.iscomplexobj(h_np):
            raise ValueError("pallas firfilt backend supports real taps")
        if backend not in ("auto", "xla", "matmul", "fft", "pallas"):
            raise ValueError(f"unknown firfilt backend {backend!r}")
        self.backend = backend
        self._buffer("h", h_np)
        self.L = L
        self.halo = L - 1
        self.lti = LTI(h_np, 1, 0)
        # real taps filter each float plane independently (planar.py)
        self.forward_planar, self.init_planar = planar_per_plane(
            self.forward, self.init)
        if np.iscomplexobj(h_np):
            self.forward_planar = self._forward_karatsuba

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return torch.zeros(batch_shape + (self.L - 1,), dtype=dtype,
                           device=device)

    def forward(self, carry, x):
        h, carry = self.h, _coerce(carry, x.dtype)
        if self.backend == "fft":
            return fftfilt_apply(h, carry, x)
        if self.backend == "matmul":
            return fir_apply_matmul(h, carry, x)
        if self.backend == "xla":
            return fir_apply(h, carry, x)
        if self.backend == "pallas":
            return fir_apply_pallas(h, carry, x)
        return fir_apply_auto(h, carry, x)

    def _forward_karatsuba(self, carry, x):
        # complex taps on float planes: m1 = r*hr, m2 = i*hi,
        # m3 = (r+i)*(hr+hi); yr = m1 - m2, yi = m3 - m1 - m2
        hr, hi = self.h.real, self.h.imag
        (r, i), (cr, ci) = x, carry
        m1, cr2 = fir_apply_auto(hr, cr, r)
        m2, ci2 = fir_apply_auto(hi, ci, i)
        m3, _ = fir_apply_auto(hr + hi, cr + ci, r + i)
        return (m1 - m2, m3 - m1 - m2), (cr2, ci2)


def firfilt(h, scale: float | complex = 1.0, name: str = "firfilt",
            backend: str = "auto") -> FIRFilt:
    """Direct-form FIR filter Proc (see `FIRFilt`)."""
    return FIRFilt(h, scale, name, backend)


def firfilt_rect(n: int, name: str = "firfilt_rect") -> FIRFilt:
    """Length-n moving-sum (rectangular) FIR filter (reference
    firfilt_xxx_create_rect, src/filter/src/firfilt.c:174-195)."""
    if not (1 <= n <= 1024):
        raise ValueError("filter length must be in [1, 1024]")
    return firfilt(np.ones(n, np.float32), name=name)


def _valid_conv_auto(x, h):
    """Valid-mode ``conv1d(x, h)`` with `fir_apply_auto`'s per-call pick
    (the first L-1 samples of x are the history)."""
    L = int(h.shape[-1])
    return fir_apply_auto(h, x[..., :L - 1], x[..., L - 1:])[0]


class FIRDecim(Proc):
    """M:1 decimating FIR (reference firdecim.c): a strided FIR, T in ->
    T // m out (block length a multiple of m).  Carry: [..., L-1] input
    tail; the LTI view lets `fuse` and `kernel_fuse` take it."""

    param_spec = {"h": "h"}

    def __init__(self, m: int, h, scale=1.0, name: str = "firdecim"):
        super().__init__(name)
        h_np = _np_taps(h, scale)
        self.m = int(m)
        self.L = int(h_np.shape[-1])
        self._buffer("h", h_np)
        self.rate = (1, self.m)
        self.halo = self.L - 1
        self.lti = LTI(h_np, self.m, 0)
        if not np.iscomplexobj(h_np):
            self.forward_planar, self.init_planar = planar_per_plane(
                self.forward, self.init)

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return torch.zeros(batch_shape + (self.L - 1,), dtype=dtype,
                           device=device)

    def forward(self, carry, x):
        return fir_apply_auto(self.h, _coerce(carry, x.dtype), x,
                              stride=self.m)


def firdecim(m: int, h, scale=1.0, name: str = "firdecim") -> FIRDecim:
    """M:1 decimating FIR Proc (see `FIRDecim`)."""
    return FIRDecim(m, h, scale, name)


def _interp_banded(hp, xp, T, k, Lp, tile: int = 512):
    """Interpolating banded matmul that emits the interleaved stream: an
    output tile of `tile` samples covers tile/k input samples x k phases,
    so column c of the band is phase c%k at input offset c//k,
    band[f, c] = hp[c%k, c//k + Lp-1 - f], and
    y[i*k + p] = sum_m hp[p, m] * xp[i + Lp-1 - m]."""
    if tile % k:
        tile = k * (-(-tile // k))
    ti = tile // k                              # input samples per tile
    rows = ti + Lp - 1
    # indices made on the taps' device: a host array copied per call
    # would wait for the stream
    c = torch.arange(tile, device=hp.device)[None, :]
    f = torch.arange(rows, device=hp.device)[:, None]
    j = (c // k) + (Lp - 1) - f
    idx = (c % k) * Lp + j.clamp(0, Lp - 1)
    band = torch.where((j >= 0) & (j < Lp), hp.reshape(-1)[idx],
                       torch.zeros((), dtype=hp.dtype, device=hp.device))
    return banded_blocks_apply(band, xp, T * k, ti, tile)


class FIRInterp(Proc):
    """1:K interpolating FIR (reference firinterp.c): zero-stuff by k, then
    filter; T in -> T*k out.  Polyphase: y[i*k + p] = sum_m hp[p, m]
    x[i - m] with hp[p, m] = h[m*k + p].  On CUDA one banded matmul for
    all k phases (`_interp_banded`), on the CPU one convolution per phase.
    Carry: the last Lp-1 input samples (an empty [..., 0] tensor when
    Lp = 1)."""

    param_spec = {"hp": "hp"}

    def __init__(self, k: int, h, scale=1.0, name: str = "firinterp"):
        super().__init__(name)
        h_np = _np_taps(h, scale)
        L = int(h_np.shape[-1])
        self.k = int(k)
        self.Lp = -(-L // self.k)
        h_pad = np.pad(h_np, (0, self.Lp * self.k - L))
        self._buffer("hp", h_pad.reshape(self.Lp, self.k).T.copy())
        self.rate = (self.k, 1)
        if not np.iscomplexobj(h_np):
            self.forward_planar, self.init_planar = planar_per_plane(
                self.forward, self.init)

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return torch.zeros(batch_shape + (self.Lp - 1,), dtype=dtype,
                           device=device)

    def forward(self, carry, x):
        k, Lp = self.k, self.Lp
        xp = torch.cat([carry, x], dim=-1) if Lp > 1 else x
        new_carry = xp[..., xp.shape[-1] - (Lp - 1):] if Lp > 1 else carry
        if x.device.type == "cuda":
            return _interp_banded(self.hp, xp, x.shape[-1], k, Lp), new_carry
        y = torch.stack([conv1d(xp, self.hp[p]) for p in range(k)], dim=-1)
        return y.reshape(y.shape[:-2] + (y.shape[-2] * k,)), new_carry


def firinterp(k: int, h, scale=1.0, name: str = "firinterp") -> FIRInterp:
    """1:K interpolating FIR Proc (see `FIRInterp`)."""
    return FIRInterp(k, h, scale, name)


def firpfb_execute(hp, x_window):
    """Every branch of a polyphase filter bank at once (reference
    firpfb.c computes one per call): hp [npfb, Lp] branch taps, x_window
    [..., Lp] the most recent samples (oldest first) -> [..., npfb]."""
    if x_window.is_complex() and not hp.is_complex():
        hp = hp.to(x_window.real.dtype)
        return torch.complex(
            torch.einsum("bm,...m->...b", hp, x_window.real),
            torch.einsum("bm,...m->...b", hp, x_window.imag))
    dt = torch.promote_types(hp.dtype, x_window.dtype)
    return torch.einsum("bm,...m->...b", hp.to(dt), x_window.to(dt))


def _hilbert_branches(m: int, as_db: float):
    """(him, heff): the full 4m+1-tap imaginary branch of the Hilbert
    prototype and its 2m odd-sample taps (reference firhilb.c:90-101)."""
    from ..design.firdes import firdes_kaiser
    h_len = 4 * m + 1
    h = firdes_kaiser(h_len, 0.25, as_db, 0.0)
    t = np.arange(h_len, dtype=np.float64) - (h_len - 1) / 2.0
    him = np.imag(h * np.exp(1j * 0.5 * np.pi * t))
    return him.astype(np.float32), him[1::2].astype(np.float32)


class FIRHilbDecim(Proc):
    """Hilbert transform 2:1 decimator, real [..., 2T] -> complex [..., T]
    (reference firhilb.c decim_execute): quadrature = the even samples
    through the 2m-tap odd-sampled imaginary branch, in-phase = the odd
    samples delayed m.  Carry: {"x": the last 4m raw samples}."""

    param_spec = {"hq": "hq"}

    def __init__(self, m: int = 5, as_db: float = 60.0,
                 name: str = "firhilb"):
        super().__init__(name + "_r2c")
        self._buffer("hq", _hilbert_branches(m, as_db)[1])
        self.m = m
        self.rate = (1, 2)

    def init(self, batch_shape=(), dtype=torch.float32, device=None):
        return {"x": torch.zeros(batch_shape + (4 * self.m,),
                                 dtype=torch.float32, device=device)}

    def forward(self, carry, x):
        m = self.m
        xp = torch.cat([carry["x"], x], dim=-1)
        T = x.shape[-1] // 2
        e, o = xp[..., 0::2], xp[..., 1::2]
        # the valid conv's index t ends at e[t + 2m - 1]; output i ends at
        # e[2m + i], so t = i + 1
        yq = _valid_conv_auto(e, self.hq)[..., 1:T + 1]
        yi = o[..., m:m + T]
        return (torch.complex(yi, yq),
                {"x": xp[..., xp.shape[-1] - 4 * m:]})


def firhilb(m: int = 5, as_db: float = 60.0,
            name: str = "firhilb") -> FIRHilbDecim:
    """Hilbert transform 2:1 decimator Proc (see `FIRHilbDecim`)."""
    return FIRHilbDecim(m, as_db, name)


class FIRHilbInterp(Proc):
    """Hilbert 1:2 interpolator, complex [..., T] -> real [..., 2T]
    (reference firhilb.c:269-284 interp_execute): even outputs are the
    imaginary part delayed m input samples, odd outputs the real part
    through the 2m-tap quadrature branch.  Carry: {"x": the last 2m
    complex inputs}."""

    param_spec = ("hq",)

    def __init__(self, m: int = 5, as_db: float = 60.0,
                 name: str = "firhilb_interp"):
        super().__init__(name)
        self._buffer("hq", _hilbert_branches(m, as_db)[1])
        self.m = m
        self.rate = (2, 1)

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return {"x": torch.zeros(batch_shape + (2 * self.m,),
                                 dtype=torch.complex64, device=device)}

    def forward(self, carry, x):
        m = self.m
        xp = torch.cat([carry["x"].to(x.dtype), x], dim=-1)
        T = x.shape[-1]
        y_even = xp[..., m:m + T].imag
        y_odd = _valid_conv_auto(xp.real, self.hq)[..., 1:T + 1]
        y = torch.stack([y_even, y_odd], dim=-1)
        return (y.reshape(y.shape[:-2] + (2 * T,)),
                {"x": xp[..., xp.shape[-1] - 2 * m:]})


def firhilb_interp(m: int = 5, as_db: float = 60.0,
                   name: str = "firhilb_interp") -> FIRHilbInterp:
    """Hilbert 1:2 interpolator Proc (see `FIRHilbInterp`)."""
    return FIRHilbInterp(m, as_db, name)


class FIRHilbR2C(Proc):
    """Single-rate Hilbert transform, real [..., T] -> analytic complex
    [..., T] (reference firhilb.c:172-210 r2c_execute): in-phase = x
    delayed 2m samples, quadrature = x through the 4m+1-tap imaginary
    branch.  Carry: {"x": the last 4m samples}."""

    param_spec = ("h",)

    def __init__(self, m: int = 5, as_db: float = 60.0,
                 name: str = "firhilb_r2c"):
        super().__init__(name)
        self._buffer("h", _hilbert_branches(m, as_db)[0])
        self.m = m

    def init(self, batch_shape=(), dtype=torch.float32, device=None):
        return {"x": torch.zeros(batch_shape + (4 * self.m,),
                                 dtype=torch.float32, device=device)}

    def forward(self, carry, x):
        m = self.m
        xp = torch.cat([carry["x"].to(x.dtype), x], dim=-1)
        T = x.shape[-1]
        yi = xp[..., 2 * m:2 * m + T]
        yq = _valid_conv_auto(xp, self.h)[..., :T]
        return (torch.complex(yi, yq),
                {"x": xp[..., xp.shape[-1] - 4 * m:]})


def firhilb_r2c(m: int = 5, as_db: float = 60.0,
                name: str = "firhilb_r2c") -> FIRHilbR2C:
    """Single-rate real -> analytic Hilbert Proc (see `FIRHilbR2C`)."""
    return FIRHilbR2C(m, as_db, name)


class FIRHilbC2R(Proc):
    """Single-rate complex -> real: the real part (reference
    firhilb.c:217-222 c2r_execute is exactly crealf).  Stateless."""

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return ()

    def forward(self, carry, x):
        return x.real, carry


def firhilb_c2r(name: str = "firhilb_c2r") -> FIRHilbC2R:
    """Single-rate complex -> real Proc (see `FIRHilbC2R`)."""
    return FIRHilbC2R(name)


class Autocorr(Proc):
    """Windowed autocorrelation r[t] = sum_{i<W} x[t-i] conj(x[t-i-d])
    (reference autocorr.c); the window sum is a ones-tap banded matmul on
    either device, as in the JAX package.  Carry: the last W+d-1
    samples."""

    param_spec = {}

    def __init__(self, window_size: int, delay: int,
                 name: str = "autocorr"):
        super().__init__(name)
        self.W, self.d = int(window_size), int(delay)
        self.hist = self.W + self.d - 1

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return torch.zeros(batch_shape + (self.hist,), dtype=dtype,
                           device=device)

    def forward(self, carry, x):
        W, d = self.W, self.d
        xp = torch.cat([carry, x], dim=-1)
        prod = xp[..., d:] * torch.conj(xp[..., :xp.shape[-1] - d])
        ones = torch.ones(W, dtype=torch.float32, device=x.device)
        pr, _ = fir_apply_matmul(
            ones, torch.zeros(prod.shape[:-1] + (W - 1,), dtype=prod.dtype,
                              device=x.device), prod)
        return pr[..., W - 1:], xp[..., xp.shape[-1] - self.hist:]


def autocorr(window_size: int, delay: int,
             name: str = "autocorr") -> Autocorr:
    """Windowed autocorrelation Proc (see `Autocorr`)."""
    return Autocorr(window_size, delay, name)


def fir_freqresponse(h, fc):
    """Complex frequency response H(e^{j 2 pi fc}) (firfilt.c:371); host
    taps are narrowed to float32/complex64 first, as the JAX package's
    are."""
    if not torch.is_tensor(h):
        h = torch.from_numpy(np.ascontiguousarray(_np_taps(h)))
    n = torch.arange(h.shape[-1], device=h.device)
    e = torch.exp(-1j * 2 * np.pi * fc * n)
    return torch.sum(h * e, dim=-1)
