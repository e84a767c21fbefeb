"""FFT plans, arbitrary-length transforms, DCT/DST, and streaming spectral
analysis on ``torch.fft`` (`liquid_dsp_tpu/ops/fft.py`).

Reference analogs: the plan framework (src/fft/src/fft_common.c:109-145),
r2r DCT/DST (src/fft/src/fft_r2r_1d.c), spgram (src/fft/src/spgram.c,
streaming Welch periodogram) and asgram (src/fft/src/asgram.c).

cuFFT on the card and pocketfft on the CPU take every length, so the
JAX package's size chooser (four-step mixed radix, matmul DFT, Rader,
Bluestein: formulations around the TPU's FFT) has no counterpart here.
The backward transform is UNNORMALIZED, as the reference's: callers
divide by N.  All transforms act on the LAST axis and broadcast leading
batch axes.  A tensor is transformed where it lies; a host array goes to
``device``, the card unless the caller names another (without one a CUDA
device raises, `core.entry_device`).
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from ..core import Proc, entry_tensor
from ..design.windows import window as make_window

__all__ = ["fft", "ifft", "fft_plan", "fft_shift", "dct", "dst", "r2r",
           "spgram", "Spgram", "spgram_psd_oneshot", "spgram_estimate",
           "asgram_render"]

FFT_FORWARD = -1
FFT_BACKWARD = +1


def _complex_len(x, n: int | None, device) -> torch.Tensor:
    """complex64 tensor, zero-padded or cut to n along the last axis."""
    x = entry_tensor(x, device).to(torch.complex64)
    if n is not None and n != x.shape[-1]:
        if n > x.shape[-1]:
            x = torch.nn.functional.pad(x, (0, n - x.shape[-1]))
        else:
            x = x[..., :n]
    return x


def fft(x, n: int | None = None, device="cuda") -> torch.Tensor:
    """Forward DFT over the last axis, unnormalized:
    y[k] = sum_t x[t] exp(-j 2 pi k t / N).  Any length N."""
    return torch.fft.fft(_complex_len(x, n, device), dim=-1)


def ifft(x, n: int | None = None, normalize: bool = False,
         device="cuda") -> torch.Tensor:
    """Inverse DFT over the last axis.  UNNORMALIZED (the reference's raw
    backward transform, fft_common.c) unless ``normalize``."""
    return torch.fft.ifft(_complex_len(x, n, device), dim=-1,
                          norm="backward" if normalize else "forward")


def fft_plan(n: int, direction: int = FFT_FORWARD,
             device="cuda") -> Callable:
    """FFTW-style plan: a callable specialized to size n (the analog of
    fft_create_plan/fft_execute, fft_common.c:109/285)."""
    if direction == FFT_FORWARD:
        return lambda x: fft(x, n, device)
    return lambda x: ifft(x, n, device=device)


def fft_shift(x, device="cuda") -> torch.Tensor:
    return torch.fft.fftshift(entry_tensor(x, device), dim=-1)


# ---------------------------------------------------------------------------
# real-to-real transforms (DCT/DST families, fft_r2r_1d.c)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dct_matrix(n: int, type: int) -> np.ndarray:
    """FFTW REDFT basis matrix m[j, k] so that y[k] = sum_j x[j] m[j, k]
    (exact FFTW conventions, unnormalized), host float32."""
    j = np.arange(n, dtype=np.float64)[:, None]
    k = np.arange(n, dtype=np.float64)[None, :]
    if type == 1:    # REDFT00: y_k = x_0 + (-1)^k x_{n-1} + 2 sum cos(pi j k/(n-1))
        m = 2.0 * np.cos(np.pi * j * k / (n - 1))
        m[0, :] = 1.0
        m[-1, :] = (-1.0) ** k.ravel()
    elif type == 2:  # REDFT10
        m = 2.0 * np.cos(np.pi * (j + 0.5) * k / n)
    elif type == 3:  # REDFT01
        m = 2.0 * np.cos(np.pi * j * (k + 0.5) / n)
        m[0, :] = 1.0
    elif type == 4:  # REDFT11
        m = 2.0 * np.cos(np.pi * (j + 0.5) * (k + 0.5) / n)
    else:
        raise ValueError(f"unsupported DCT type {type}")
    return m.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dst_matrix(n: int, type: int) -> np.ndarray:
    """FFTW RODFT basis matrix (same layout as _dct_matrix)."""
    j = np.arange(n, dtype=np.float64)[:, None]
    k = np.arange(n, dtype=np.float64)[None, :]
    if type == 1:    # RODFT00
        m = 2.0 * np.sin(np.pi * (j + 1) * (k + 1) / (n + 1))
    elif type == 2:  # RODFT10
        m = 2.0 * np.sin(np.pi * (j + 0.5) * (k + 1) / n)
    elif type == 3:  # RODFT01: y_k = (-1)^k x_{n-1} + 2 sum_{j<n-1} sin(pi(j+1)(k+.5)/n)
        m = 2.0 * np.sin(np.pi * (j + 1) * (k + 0.5) / n)
        m[-1, :] = (-1.0) ** k.ravel()
    elif type == 4:  # RODFT11
        m = 2.0 * np.sin(np.pi * (j + 0.5) * (k + 0.5) / n)
    else:
        raise ValueError(f"unsupported DST type {type}")
    return m.astype(np.float32)


def _basis_matmul(x, basis, device) -> torch.Tensor:
    """x [..., n] float32 times a cached host basis [n, n], moved to x's
    device (full float32 unless the caller turned TF32 on)."""
    x = entry_tensor(x, device).to(torch.float32)
    m = basis(x.shape[-1])
    return torch.matmul(x, torch.from_numpy(m).to(x.device))


def dct(x, type: int = 2, device="cuda") -> torch.Tensor:
    """DCT-I..IV (FFTW REDFT00/10/01/11 conventions, unnormalized)."""
    return _basis_matmul(x, lambda n: _dct_matrix(n, type), device)


def dst(x, type: int = 1, device="cuda") -> torch.Tensor:
    """DST-I..IV (FFTW RODFT00/10/01/11 conventions, unnormalized)."""
    return _basis_matmul(x, lambda n: _dst_matrix(n, type), device)


_R2R = {"REDFT00": (dct, 1), "REDFT10": (dct, 2), "REDFT01": (dct, 3),
        "REDFT11": (dct, 4), "RODFT00": (dst, 1), "RODFT10": (dst, 2),
        "RODFT01": (dst, 3), "RODFT11": (dst, 4)}


def r2r(x, kind: str, device="cuda") -> torch.Tensor:
    """FFTW-style real-to-real transform dispatch (fft_r2r_1d.c)."""
    if kind not in _R2R:
        raise ValueError(f"unknown r2r kind {kind!r}")
    f, type_ = _R2R[kind]
    return f(x, type_, device)


# ---------------------------------------------------------------------------
# streaming spectral periodogram (spgram.c)
# ---------------------------------------------------------------------------

class Spgram(Proc):
    """Streaming Welch periodogram (see `spgram`)."""

    param_spec = {"w": "w"}

    def __init__(self, nfft: int, window: str, window_len, delay, alpha,
                 name: str):
        super().__init__(name)
        window_len = window_len or nfft // 2
        delay = delay or nfft // 4
        if window_len > nfft:
            raise ValueError("window length cannot exceed nfft")
        w = make_window(window, window_len, 10.0 if window == "kaiser" else 0.0)
        # normalize so sum(w^2) = 1 per transform (reference spgram energy)
        self._buffer("w", (w / np.sqrt(np.sum(w * w))).astype(np.float32))
        self.nfft, self.window_len, self.delay = nfft, window_len, delay
        self.alpha = float(alpha)

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        batch_shape = tuple(batch_shape)
        return {
            "buf": torch.zeros(batch_shape + (self.window_len,),
                               dtype=torch.complex64, device=device),
            "psd": torch.zeros(batch_shape + (self.nfft,),
                               dtype=torch.float32, device=device),
            "count": torch.zeros(batch_shape, dtype=torch.int32,
                                 device=device)}

    def forward(self, carry, x):
        wlen, delay, alpha = self.window_len, self.delay, self.alpha
        buf = torch.cat([carry["buf"], x.to(torch.complex64)], dim=-1)
        n_xf = max((buf.shape[-1] - wlen) // delay + 1, 0)
        psd, count = carry["psd"], carry["count"]
        if n_xf > 0:
            # every window at once: [.., n_xf, wlen] by unfold, one batched
            # FFT, then a closed-form fold of the running average
            frames = buf.unfold(-1, wlen, delay)[..., :n_xf, :]
            X = fft(frames * self.w, self.nfft)
            p = X.real * X.real + X.imag * X.imag       # [.., n_xf, nfft]
            if alpha < 0:
                # the uniform mean is associative: fold all n_xf at once
                cf = count.to(torch.float32)[..., None]
                psd = (psd * cf + p.sum(dim=-2)) / (cf + n_xf)
            else:
                # EWMA psd' = (1-a)psd + a*p unrolled n_xf steps:
                # psd_n = (1-a)^n * psd_or_p0 + sum_i a(1-a)^(n-1-i) p_i,
                # where a fresh accumulator (count==0) seeds from p_0
                wts = torch.from_numpy((alpha * (1 - alpha) ** np.arange(
                    n_xf - 1, -1, -1)).astype(np.float32)).to(p.device)
                base = torch.einsum("...kf,k->...f", p, wts)
                seed = torch.where((count == 0)[..., None], p[..., 0, :],
                                   psd)
                psd = (1 - alpha) ** n_xf * seed + base
            count = count + n_xf
        new_buf = buf[..., n_xf * delay:][..., -wlen:]
        if new_buf.shape[-1] < wlen:
            new_buf = torch.nn.functional.pad(
                new_buf, (wlen - new_buf.shape[-1], 0))
        return psd, {"buf": new_buf, "psd": psd, "count": count}


def spgram(nfft: int, window: str = "hamming", window_len: int | None = None,
           delay: int | None = None, alpha: float = -1.0,
           name: str = "spgram") -> Spgram:
    """Streaming Welch periodogram Proc (reference spgram.c:36-240).

    proc(carry, x[..., T]) -> (psd, carry'): the running averaged PSD
    accumulator, also in the carry (``{"buf", "psd", "count"}``); use
    `spgram_estimate` for the dB PSD.  alpha < 0 means uniform averaging
    over all transforms (the reference's default)."""
    return Spgram(nfft, window, window_len, delay, alpha, name)


def spgram_psd_oneshot(x, nfft: int, window: str = "kaiser",
                       window_len: int | None = None,
                       beta: float = 10.0, device="cuda") -> torch.Tensor:
    """One-shot PSD with the reference's exact semantics
    (spgramcf_execute_psd): window the LAST window_len samples with the
    reference scale sqrt(2)/(sqrt(sum(w^2)/wlen)*sqrt(nfft)), FFT, and
    return the fftshifted spectrum in dB."""
    window_len = window_len or nfft // 2
    w = make_window(window, window_len, beta)
    g = np.sqrt(2.0) / (np.sqrt(np.sum(w * w) / window_len) * np.sqrt(nfft))
    x = entry_tensor(x, device)
    wt = torch.from_numpy((w * g).astype(np.float32)).to(x.device)
    X = fft(x[..., -window_len:] * wt, nfft)
    mag = fft_shift(X).abs()
    return 20.0 * torch.log10(torch.clamp(mag, min=1e-16))


def spgram_estimate(psd, fs: float = 1.0, device="cuda") -> torch.Tensor:
    """PSD accumulator -> dB, fftshifted (spgram_get_psd semantics)."""
    return 10.0 * torch.log10(torch.clamp(fft_shift(psd, device), min=1e-20))


def asgram_render(psd_db, height: int = 1, levels: str = " .,-+*&NM#") -> str:
    """ASCII spectrogram line (reference asgram.c): quantize PSD into glyphs."""
    if torch.is_tensor(psd_db):
        psd_db = psd_db.detach().cpu().numpy()
    p = np.asarray(psd_db, dtype=np.float64)
    lo, hi = p.min(), p.max()
    idx = np.clip(((p - lo) / max(hi - lo, 1e-12)) * (len(levels) - 1), 0,
                  len(levels) - 1).astype(int)
    return "".join(levels[i] for i in idx)
