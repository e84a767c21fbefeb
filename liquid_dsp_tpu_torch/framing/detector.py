"""qdetector: FFT-based preamble detection with a carrier-offset sweep
(`liquid_dsp_tpu/framing/detector.py`).

Reference analog: src/framing/src/qdetector_cccf.c:48-441 — nfft-point
FFT of the capture, cross-correlation against the frequency-domain
template over +-range frequency-bin offsets, peak -> (timing tau,
carrier dphi / phi, gain gamma).  The whole capture is one batch of
half-overlapped segments: one batched FFT, one batched conjugate
multiply per offset, one batched IFFT (torch, on the capture's device);
the decision and the refinement on the aligned window run in host numpy,
as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import entry_device

__all__ = ["DetectorResult", "make_template", "qdetector_detect"]


class DetectorResult(NamedTuple):
    detected: bool
    sample_index: int     # integer sample index of sequence start
    tau_hat: float        # fractional timing offset [-0.5, 0.5]
    dphi_hat: float       # carrier frequency offset [rad/sample]
    phi_hat: float        # carrier phase offset [rad]
    gamma_hat: float      # channel gain estimate
    rxy: float            # peak normalized correlation


def make_template(sequence, interp_proc=None) -> np.ndarray:
    """Time-domain detection template (reference
    qdetector_cccf_create_linear): the sequence, or the sequence through
    an interpolator (a `firinterp` Proc) followed by its filter tail
    (2(Lp-1) zeros pushed after it), run where the Proc's taps lie."""
    if interp_proc is None:
        return np.asarray(sequence, np.complex64)
    dev = interp_proc.hp.device
    x = torch.from_numpy(np.asarray(sequence, np.complex64)).to(dev)
    y, carry = interp_proc(interp_proc.init(device=dev), x)
    flush = torch.zeros(2 * (interp_proc.Lp - 1), dtype=torch.complex64,
                        device=dev)
    tail, _ = interp_proc(carry, flush)
    return np.concatenate([y.cpu().numpy(), tail.cpu().numpy()])


def qdetector_detect(x, s, threshold: float = 0.5, range_bins: int = 2,
                     device="cuda") -> DetectorResult:
    """Detect template s in capture x; returns DetectorResult (the
    block-native form of reference qdetector_cccf_execute_seek :373-441
    + execute_align).  The FFT correlation runs where a tensor x lies; a
    host array goes to ``device``, the card unless given (without one a
    CUDA device raises)."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.asarray(x, np.complex64)).to(
            entry_device(device))
    x = x.to(torch.complex64)
    s = np.asarray(s, np.complex64)
    s_len = len(s)
    nfft = 1 << int(np.ceil(np.log2(2 * s_len)))
    hop = nfft // 2
    T = x.shape[-1]
    n_seg = max(1, (T - nfft) // hop + 1)
    starts = np.arange(n_seg) * hop
    idx = starts[:, None] + np.arange(nfft)[None, :]
    xpad = torch.cat([x, torch.zeros(max(0, int(idx.max()) + 1 - T),
                                     dtype=x.dtype, device=x.device)])
    segs = xpad[torch.as_tensor(idx, device=x.device)]   # [n_seg, nfft]
    Xf = torch.fft.fft(segs, dim=-1)
    S = np.fft.fft(s, nfft)
    s2_sum = float(np.sum(np.abs(s) ** 2))
    # per-segment normalization (reference g0/g computation :392-394)
    x2 = torch.sum(segs.abs() ** 2, dim=-1)
    g0 = torch.sqrt(x2) * np.sqrt(s_len / nfft)
    g = 1.0 / (nfft * torch.clamp(g0, min=1e-12) * np.sqrt(s2_sum))
    offsets = np.arange(-range_bins, range_bins + 1)
    So = np.stack([np.roll(S, off) for off in offsets]).astype(np.complex64)
    R = torch.fft.ifft(
        Xf[:, None, :] * torch.as_tensor(So, device=x.device).conj()[None],
        dim=-1) * nfft                                   # [n_seg, n_off, nfft]
    rxy_np = (R.abs() * g[:, None, None]).cpu().numpy()
    # earliest segment over the threshold: the reference's sequential
    # seek (the first frame wins, not the loudest)
    seg_peaks = rxy_np.max(axis=(1, 2))
    hits = np.nonzero(seg_peaks > threshold)[0]
    if len(hits) == 0:
        return DetectorResult(False, 0, 0.0, 0.0, 0.0, 0.0,
                              float(seg_peaks.max()))
    seg_i = int(hits[0])
    # the peak may straddle the hop boundary: take the next segment if it
    # correlates better (same frame, later window)
    if seg_i + 1 < n_seg and seg_peaks[seg_i + 1] > seg_peaks[seg_i]:
        seg_i += 1
    off_i, lag_i = np.unravel_index(np.argmax(rxy_np[seg_i]),
                                    rxy_np[seg_i].shape)
    peak = float(rxy_np[seg_i, off_i, lag_i])
    n0 = int(starts[seg_i] + lag_i)
    offset = int(offsets[off_i])

    # --- refinement on the aligned window (reference execute_align) ---
    xa = xpad[n0: n0 + nfft].cpu().numpy()
    if len(xa) < nfft:
        xa = np.concatenate([xa, np.zeros(nfft - len(xa), xa.dtype)])
    Ra = np.fft.ifft(np.fft.fft(xa) * np.conj(np.roll(S, offset))) * nfft
    yneg = np.sqrt(np.abs(Ra[-1]))
    y0 = np.sqrt(np.abs(Ra[0]))
    ypos = np.sqrt(np.abs(Ra[1]))
    a = 0.5 * (ypos + yneg) - y0
    b = 0.5 * (ypos - yneg)
    tau_hat = float(-b / (2 * a)) if a != 0 else 0.0
    g_hat = a * tau_hat ** 2 + b * tau_hat + y0
    gamma_hat = float(g_hat * g_hat / (nfft * s2_sum))

    # fine carrier estimate: FFT of aligned window times conj(template)
    w = xa.copy()
    w[:s_len] *= np.conj(s)
    w[s_len:] = 0
    W = np.fft.fft(w)
    i0 = int(np.argmax(np.abs(W)))
    vneg = np.abs(W[(i0 - 1) % nfft])
    v0 = np.abs(W[i0])
    vpos = np.abs(W[(i0 + 1) % nfft])
    a2 = 0.5 * (vpos + vneg) - v0
    b2 = 0.5 * (vpos - vneg)
    index = i0 + (float(-b2 / (2 * a2)) if a2 != 0 else 0.0)
    if i0 > nfft / 2:
        index -= nfft
    return DetectorResult(True, n0, tau_hat, float(index * 2 * np.pi / nfft),
                          float(np.angle(W[i0])), gamma_hat, peak)
