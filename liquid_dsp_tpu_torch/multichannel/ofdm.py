"""OFDM frame PHY: generator and block-native synchronizer
(`liquid_dsp_tpu/multichannel/ofdm.py`).

Reference analogs (studied, not copied):
  * ofdmframe common — src/multichannel/src/ofdmframe.common.c:41-224:
    default subcarrier allocation (guards M/10, pilots every 4 or 8
    bins), S0 (even data/pilot bins, +-1 from the default m-sequence,
    nextpow2(M) clipped to [4,8]), S1 (all enabled bins, order m+1),
    time-domain forms scaled by 1/sqrt(M_Sx).
  * ofdmframegen — src/multichannel/src/ofdmframegen.c:84-345: pilots
    +-1 from msequence(8), data scaled by 1/sqrt(M_pilot+M_data),
    centered-bin mapping k=(i+M/2)%M, IFFT, cyclic prefix.
  * ofdmframesync — src/multichannel/src/ofdmframesync.c:241-1100:
    S0 autocorrelation -> carrier/timing from S0/S1 -> per-subcarrier
    gain EQ -> pilot-tracked payload demod.

The generator and the allocation are host numpy.  The receivers are
whole-capture tensor operations (no per-sample state machine), batched
over any leading axes:
  * `ofdm_frame_sync`, one frame from one capture (an entry point: host
    array in, on the card unless ``device="cpu"``);
  * `ofdm_s1_search` / `ofdm_demod_body` / `ofdm_demod_window`, the
    per-candidate demodulator that the streaming receivers share, with
    its constants (`ofdm_demod_consts`) as buffers of a `DemodConsts`;
  * `s0_detect_block` and the `ofdm_detector_stream` Proc, the streaming
    Schmidl-Cox detector (the carry keys, shapes and dtypes are the JAX
    package's: ``convert.carry_from_numpy`` hands a stream across).

Window sums are banded ones-tap matmuls (`ops.fir.fir_apply_matmul`),
the S1 correlation a matmul over unfolded windows (so cuDNN's TF32
default does not reach it; torch's matmul keeps full float32 unless
``torch.backends.cuda.matmul.allow_tf32``), the FFTs cuFFT.  Every
window is sliced by an index that its buffer's padding covers (the
bounds are stated where the windows are cut): nothing is clamped the way
``lax.dynamic_slice`` clamps.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from .. import debug
from ..core import Proc, entry_device
from ..ops.fir import fir_apply_matmul
from ..utils.sequence import MSequence

__all__ = ["OFDMParams", "ofdm_params", "ofdm_generate_frame",
           "ofdm_frame_sync", "OFDMSyncResult", "default_sctype",
           "ofdm_demod_consts", "DemodConsts", "ofdm_s1_search",
           "ofdm_demod_body", "ofdm_demod_window", "frame_demod_core",
           "s0_detect_block", "ofdm_detector_stream", "OFDMDetBlock",
           "SCTYPE_NULL", "SCTYPE_PILOT", "SCTYPE_DATA"]

SCTYPE_NULL, SCTYPE_PILOT, SCTYPE_DATA = 0, 1, 2
_NEG = -(1 << 30)             # the watermark's "never" (int32)


class OFDMParams(NamedTuple):
    M: int
    cp_len: int
    taper_len: int
    p: np.ndarray          # subcarrier types [M]
    S0: np.ndarray         # freq-domain S0 [M]
    s0: np.ndarray         # time-domain S0 [M]
    S1: np.ndarray
    s1: np.ndarray
    M_null: int
    M_pilot: int
    M_data: int


def default_sctype(M: int) -> np.ndarray:
    """Reference ofdmframe_init_default_sctype (ofdmframe.common.c:176)."""
    p = np.zeros(M, np.uint8)
    M2 = M // 2
    G = max(M // 10, 2)
    P = 8 if M > 34 else 4
    P2 = P // 2
    for i in range(1, M2 - G):
        t = SCTYPE_PILOT if ((i + P2) % P) == 0 else SCTYPE_DATA
        p[i] = t
        p[M - i] = t
    return p


def _init_S(p: np.ndarray, M: int, order: int, even_only: bool):
    ms = MSequence(order)
    S = np.zeros(M, np.complex64)
    count = 0
    for i in range(M):
        s = ms.generate_symbol(3) & 0x01
        if p[i] == SCTYPE_NULL:
            continue
        if even_only and (i % 2) != 0:
            continue
        S[i] = 1.0 if s else -1.0
        count += 1
    if count == 0:
        raise ValueError("ofdm frame: no subcarriers enabled; check "
                         "allocation")
    # time domain: unnormalized inverse FFT scaled by 1/sqrt(count)
    s_t = np.fft.ifft(S) * M / np.sqrt(count)
    return S, s_t.astype(np.complex64), count


def ofdm_params(M: int = 64, cp_len: int = 16,
                taper_len: int = 0, p=None) -> OFDMParams:
    if p is None:
        p = default_sctype(M)
    p = np.asarray(p, np.uint8)
    m = int(np.ceil(np.log2(M)))
    m = min(max(m, 4), 8)
    S0, s0, _ = _init_S(p, M, m, even_only=True)
    S1, s1, _ = _init_S(p, M, m + 1, even_only=False)
    M_null = int(np.sum(p == SCTYPE_NULL))
    M_pilot = int(np.sum(p == SCTYPE_PILOT))
    M_data = int(np.sum(p == SCTYPE_DATA))
    if M_pilot < 2:
        raise ValueError("ofdm frame requires at least two pilot "
                         "subcarriers")
    return OFDMParams(M, cp_len, taper_len, p, S0, s0, S1, s1,
                      M_null, M_pilot, M_data)


def _pilot_order(params: OFDMParams) -> np.ndarray:
    """Pilot bins in the reference's traversal order: the writesymbol
    loop visits bins k=(i+M/2)%M for i ascending (ofdmframegen.c:290),
    so the pilot msequence is consumed in fftshifted bin order."""
    M = params.M
    k = (np.arange(M) + M // 2) % M
    return k[np.asarray(params.p)[k] == SCTYPE_PILOT]


def _pilot_sequence(n_pilots: int, n_syms: int) -> np.ndarray:
    """Per-symbol pilot values [n_syms, n_pilots] from msequence(8)
    (reference ofdmframegen.c:168, one advance per pilot per symbol),
    ordered as _pilot_order traverses the bins."""
    ms = MSequence(8)
    out = np.zeros((n_syms, n_pilots), np.float32)
    for s in range(n_syms):
        for j in range(n_pilots):
            out[s, j] = 1.0 if ms.advance() else -1.0
    return out


def _symbolize(params: OFDMParams, X: np.ndarray) -> np.ndarray:
    """Freq symbol [.., M] -> time samples [.., cp+M] (no taper)."""
    x = np.fft.ifft(X, axis=-1) * params.M
    return np.concatenate([x[..., params.M - params.cp_len:], x], axis=-1)


def ofdm_generate_frame(params: OFDMParams, data_syms) -> np.ndarray:
    """Assemble a frame: [S0, S0, S1, payload symbols] (host numpy).

    data_syms: [n_syms, M_data] modulated data points.
    Returns time samples [(3 + n_syms) * (M + cp_len)].
    """
    M, cp = params.M, params.cp_len
    data_syms = np.atleast_2d(np.asarray(data_syms))
    n_syms = data_syms.shape[0]
    if data_syms.shape[1] != params.M_data:
        raise ValueError(f"expected {params.M_data} data symbols per OFDM "
                         f"symbol, got {data_syms.shape[1]}")
    g = 1.0 / np.sqrt(params.M_pilot + params.M_data)
    pilots = _pilot_sequence(params.M_pilot, n_syms)
    pil_idx = _pilot_order(params)
    dat_idx = np.nonzero(params.p == SCTYPE_DATA)[0]
    X = np.zeros((n_syms, M), np.complex64)
    X[:, pil_idx] = pilots * g
    X[:, dat_idx] = data_syms * g
    payload = _symbolize(params, X).reshape(-1)
    # preamble: S0 twice + S1.  The first S0 symbol is rotated by TWO
    # cp lengths, the second by one (reference ofdmframegen_write_S0a/b)
    # so the pair is contiguous in the s0 sequence's own period.
    idx_a = (np.arange(M + cp) + M - 2 * cp) % M
    idx_b = (np.arange(M + cp) + M - cp) % M
    s1_sym = np.concatenate([params.s1[M - cp:], params.s1])
    return np.concatenate([params.s0[idx_a], params.s0[idx_b], s1_sym,
                           payload]).astype(np.complex64)


class OFDMSyncResult(NamedTuple):
    detected: bool
    sample_index: int
    cfo_hat: float
    data_syms: Optional[np.ndarray]   # [n_syms, M_data]
    evm_db: float


# ---------------------------------------------------------------------------
# the per-candidate demodulator
# ---------------------------------------------------------------------------


def ofdm_demod_consts(params: OFDMParams, n_syms: int) -> dict:
    """Numpy constants of the per-candidate frame demodulator (float
    planes, as the JAX package keeps them); `DemodConsts` holds them as
    buffers.  Shared by `frame_demod_core`, `ofdm_frame_sync` and the
    streaming receiver (framing/ofdmflex_stream.py)."""
    M, cp = params.M, params.cp_len
    M2 = M // 2
    W1 = 3 * (M + cp) + M
    body_len = n_syms * (M + cp)
    s1 = params.s1.astype(np.complex64)
    on_idx = np.nonzero(params.p != SCTYPE_NULL)[0].astype(np.int32)
    S1_on = params.S1[on_idx] * np.sqrt(params.M_pilot + params.M_data)
    pil_idx = _pilot_order(params).astype(np.int32)
    k_signed = (((np.arange(M) + M2) % M) - M2).astype(np.float32)
    order = np.argsort(k_signed[pil_idx], kind="stable")
    kk = k_signed[pil_idx][order]
    return {
        "M": M, "cp": cp, "n_syms": int(n_syms),
        "W1": W1, "body_len": body_len, "WIN": W1 + M + body_len,
        "s1c_re": s1.conj().real.astype(np.float32),
        "s1c_im": s1.conj().imag.astype(np.float32),
        "s1_e": float(np.sum(np.abs(s1) ** 2)),
        "on_idx": on_idx,
        "S1i_re": (1.0 / S1_on).real.astype(np.float32),
        "S1i_im": (1.0 / S1_on).imag.astype(np.float32),
        "pil_idx": pil_idx,
        "dat_idx": np.nonzero(params.p == SCTYPE_DATA)[0].astype(np.int32),
        "pilots": _pilot_sequence(params.M_pilot, n_syms),
        "k_signed": k_signed, "order": order, "kk": kk,
        "dk": np.diff(kk),
        "scale": float(np.sqrt(params.M_pilot + params.M_data)),
    }


class DemodConsts(nn.Module):
    """`ofdm_demod_consts` with its arrays as buffers (``.to(device)``;
    index arrays as int64) and ``dk2``, the pilot slope fit's
    normalization; ``dc[key]`` reads a buffer or a scalar, like the
    numpy dict."""

    def __init__(self, dc: dict):
        super().__init__()
        self.scalars = {"dk2": float(np.sum(dc["dk"] ** 2))}
        for k, v in dc.items():
            if isinstance(v, np.ndarray):
                v = v.astype(np.int64) if v.dtype.kind in "iu" else v.copy()
                self.register_buffer(k, torch.from_numpy(v))
            else:
                self.scalars[k] = v

    def __getitem__(self, key):
        if key in self.scalars:
            return self.scalars[key]
        return getattr(self, key)


def _consts(dc, like: torch.Tensor) -> DemodConsts:
    """dc as buffers on `like`'s device: a `DemodConsts` is taken as it
    is, a numpy dict (`ofdm_demod_consts`) is copied there."""
    if isinstance(dc, DemodConsts):
        return dc
    return DemodConsts(dc).to(like.device)


def _cexp_neg(ph):
    """e^{-j ph} for real ph."""
    return torch.complex(torch.cos(ph), -torch.sin(ph))


def _smooth3(vals):
    """jnp.convolve(vals, ones(3)/3, mode="same") with both ends kept
    (`ofdm.py:253-254` of the JAX package): the three products by 1/3
    summed left to right, over the last axis."""
    third = 1.0 / 3.0
    z = torch.zeros_like(vals[..., :1])
    left = torch.cat([z, vals[..., :-1]], dim=-1)
    right = torch.cat([vals[..., 1:], z], dim=-1)
    sm = left * third + vals * third + right * third
    return torch.cat([vals[..., :1], sm[..., 1:-1], vals[..., -1:]], dim=-1)


def ofdm_s1_search(dc, wa, cfo0):
    """Batched S1 timing search over candidate slots (stage A of the
    frame demod).

    wa: [..., 2, WA] float planes of the RAW window at the S0 plateau
    (WA = W1 + M - 1); cfo0: [...] coarse CFO.  Returns best [...]
    int64, the S1 offset in [0, W1): the argmax of |V|^2 over the
    correlation of the de-rotated window with conj(s1).  The four real
    correlations are one matmul of the unfolded [W1, 2M] windows with a
    [2M, 2] kernel (full float32 by torch's matmul default)."""
    dc = _consts(dc, wa)
    M, W1 = dc["M"], dc["W1"]
    WA = W1 + M - 1
    t = torch.arange(WA, dtype=torch.float32, device=wa.device)
    ph = cfo0[..., None] * t
    c, s = torch.cos(ph), torch.sin(ph)
    xr = wa[..., 0, :] * c + wa[..., 1, :] * s
    xi = wa[..., 1, :] * c - wa[..., 0, :] * s
    sr, si = dc["s1c_re"], dc["s1c_im"]
    # V0 = sum xr sr - xi si, V1 = sum xr si + xi sr (the JAX package's
    # feature-grouped conv, kern = [[sr, -si], [si, sr]])
    kern = torch.stack([torch.cat([sr, -si]), torch.cat([si, sr])], dim=1)
    win = torch.cat([xr.unfold(-1, M, 1), xi.unfold(-1, M, 1)], dim=-1)
    V = win @ kern                                       # [..., W1, 2]
    mag = V[..., 0] ** 2 + V[..., 1] ** 2
    return torch.argmax(mag, dim=-1)


def ofdm_demod_body(dc, wb, cfo, best):
    """Stage B of the frame demod: channel estimate + CP-strip FFT +
    EQ + pilot phase and timing-slope tracking from an S1-aligned raw
    window, batched over the leading axes.

    wb: [..., 2, M + body_len] float planes sliced at (plateau + best);
    cfo [...]; best [...] integer (the de-rotation phase index starts at
    `best`).  Returns (data [..., n_syms, M_data], perr [..., n_syms,
    n_pil], cfo_out [...]).  An all-zero window gives zeros, -1 pilot
    errors and cfo_out = cfo: nothing non-finite."""
    dc = _consts(dc, wb)
    M, cp = dc["M"], dc["cp"]
    body_len, n_syms = dc["body_len"], dc["n_syms"]
    t = best.to(torch.float32)[..., None] + torch.arange(
        M + body_len, dtype=torch.float32, device=wb.device)
    xc = torch.complex(wb[..., 0, :], wb[..., 1, :]) * \
        _cexp_neg(cfo[..., None] * t)
    S1_rx = torch.fft.fft(xc[..., :M], dim=-1)
    S1inv = torch.complex(dc["S1i_re"], dc["S1i_im"])
    vals = S1_rx[..., dc["on_idx"]] * S1inv
    Gs = torch.zeros(xc.shape[:-1] + (M,), dtype=xc.dtype, device=xc.device)
    Gs[..., dc["on_idx"]] = _smooth3(vals)
    body = xc[..., M:].reshape(xc.shape[:-1] + (n_syms, M + cp))[..., cp:]
    Xr = torch.fft.fft(body, dim=-1) / dc["scale"]
    nz = Gs.abs() > 1e-9
    one = torch.ones((), dtype=Gs.dtype, device=Gs.device)
    inv = torch.where(nz, 1.0 / torch.where(nz, Gs, one),
                      torch.zeros_like(Gs))
    Xeq = Xr * inv[..., None, :]
    pilots = dc["pilots"]
    q = (Xeq[..., dc["pil_idx"]] * pilots)[..., dc["order"]]
    dphi_n = torch.angle(q[..., 1:] * torch.conj(q[..., :-1]))
    b_s = torch.sum(dphi_n * dc["dk"], dim=-1) / dc["dk2"]
    a_s = torch.angle(torch.sum(q * _cexp_neg(b_s[..., None] * dc["kk"]),
                                dim=-1))
    ph_all = a_s[..., None] + b_s[..., None] * dc["k_signed"]
    Xeq = Xeq * _cexp_neg(ph_all)
    data = Xeq[..., dc["dat_idx"]]
    perr = Xeq[..., dc["pil_idx"]] * pilots - 1.0
    if n_syms > 1:
        da = torch.angle(torch.mean(torch.exp(1j * (a_s[..., 1:] -
                                                    a_s[..., :-1])), dim=-1))
    else:
        da = torch.zeros_like(cfo)
    return data, perr, cfo + da / (M + cp)


def _gather_planes(planes, start, n):
    """planes [..., 2, L] -> [..., 2, n] from `start` [...] (the caller
    has checked start + n <= L)."""
    idx = start[..., None, None] + torch.arange(n, device=planes.device)
    return torch.gather(planes, -1, idx.expand(planes.shape[:-1] + (n,)))


def ofdm_demod_window(dc, win, cfo):
    """Demodulate frames from raw windows [..., WIN] complex (position
    0 = the coarse S0 plateau index) at coarse CFO `cfo` [...]: S1
    timing (`ofdm_s1_search`), then `ofdm_demod_body` from the aligned
    slice.  Returns (s1_off [...], data, perr, cfo_out).  The slice
    starts at best <= W1 - 1 and ends at best + M + body_len <= WIN - 1,
    inside the window."""
    dc = _consts(dc, win)
    M = dc["M"]
    W1, body_len = dc["W1"], dc["body_len"]
    planes = torch.stack([win.real, win.imag], dim=-2)      # [..., 2, WIN]
    best = ofdm_s1_search(dc, planes[..., :W1 + M - 1], cfo)
    wb = _gather_planes(planes, best, M + body_len)
    data, perr, cfo_out = ofdm_demod_body(dc, wb, cfo, best)
    return best, data, perr, cfo_out


class FrameDemod(nn.Module):
    """The per-candidate frame demodulator for one geometry (see
    `frame_demod_core`): forward(win [..., WIN], cfo [...]) ->
    (s1_off, data, perr, cfo_out)."""

    def __init__(self, dc: dict):
        super().__init__()
        self.dc = DemodConsts(dc)

    def forward(self, win, cfo):
        return ofdm_demod_window(self.dc, win, cfo)


_DEMOD_CACHE: dict = {}


def frame_demod_core(params: OFDMParams, n_syms: int, device=None):
    """Cached per-candidate frame demodulator for streaming receivers,
    on `device` (the CPU unless given): returns (fn, win_len) with
    fn(win [..., win_len], cfo [...]) -> (s1_off, data [..., n_syms,
    M_data], perr [..., n_syms, n_pil], cfo_out).  See
    ofdm_demod_window."""
    dev = torch.device("cpu" if device is None else device)
    key = (params.M, params.cp_len, params.taper_len, params.p.tobytes(),
           int(n_syms), str(dev))
    hit = _DEMOD_CACHE.get(key)
    if hit is None:
        dc = ofdm_demod_consts(params, int(n_syms))
        hit = _DEMOD_CACHE[key] = (FrameDemod(dc).to(dev), dc["WIN"])
    return hit


# ---------------------------------------------------------------------------
# one-shot synchronizer
# ---------------------------------------------------------------------------


def _window_sums(x, M: int):
    """(P, R): the Schmidl-Cox window-M/2 autocorrelation sums P[t] =
    sum x[t+M/2+i] conj(x[t+i]) and window-M energies R[t], both as
    ones-tap banded matmuls over the last axis (P is the box sum shifted
    by M/2 - 1, R by M - 1)."""
    M2 = M // 2
    lead = x.shape[:-1]
    prod = x[..., M2:] * torch.conj(x[..., :-M2])
    ones2 = torch.ones(M2, dtype=torch.float32, device=x.device)
    pr, _ = fir_apply_matmul(ones2, torch.zeros(
        lead + (M2 - 1,), dtype=prod.dtype, device=x.device), prod)
    en = x.abs().to(torch.float32) ** 2
    ones = torch.ones(M, dtype=torch.float32, device=x.device)
    er, _ = fir_apply_matmul(ones, torch.zeros(
        lead + (M - 1,), dtype=torch.float32, device=x.device), en)
    return pr[..., M2 - 1:], er[..., M - 1:]


_CORE_CACHE: dict = {}


def _sync_consts(params: OFDMParams, n_syms: int, dev) -> DemodConsts:
    key = (params.M, params.cp_len, params.taper_len, params.p.tobytes(),
           int(n_syms), str(dev))
    dc = _CORE_CACHE.get(key)
    if dc is None:
        dc = _CORE_CACHE[key] = DemodConsts(
            ofdm_demod_consts(params, int(n_syms))).to(dev)
    return dc


def _sync_core(dc: DemodConsts, x, threshold: float):
    """x [T] complex64 -> (detected, best_idx, cfo, data, evm_db) as
    tensors (`_sync_core` of the JAX package, steps 1-6)."""
    M, cp, n_syms = dc["M"], dc["cp"], dc["n_syms"]
    M2 = M // 2
    W0 = M + cp                       # plateau window
    W1 = dc["W1"]                     # S1 search window
    body_len = dc["body_len"]
    dev = x.device
    T = x.shape[0]
    # --- 1. Schmidl-Cox autocorrelation over the whole capture ---
    P, R = _window_sums(x, M)
    L = min(int(P.shape[0]), int(R.shape[0]))
    metric = P[:L].abs() / torch.clamp(R[:L], min=1e-12) * 2.0
    debug.tap("ofdm.metric", metric)    # Schmidl-Cox trajectory
    hit = metric > threshold
    detected = hit.any()
    d0 = torch.argmax(hit.to(torch.uint8))                  # first True
    # plateau: advance to the local max within one symbol; the -inf pad
    # keeps d0 <= L - 1 (seg[0] is finite)
    mpad = torch.cat([metric, torch.full((W0,), float("-inf"), device=dev)])
    d0 = d0 + torch.argmax(mpad[d0 + torch.arange(W0, device=dev)])
    cfo = torch.angle(P[torch.clamp(d0, max=L - 1)]) / M2
    # --- 2. de-rotate; S1 by one matmul cross-correlation ---
    t32 = torch.arange(T, dtype=torch.float32, device=dev)
    xc = x * _cexp_neg(cfo * t32)
    # d0 <= L - 1 <= T - M, best <= W1 - 1: every slice below ends at
    # most at T - M + W1 + M + body_len - 1, inside xpad
    xpad = torch.cat([xc, torch.zeros(W1 + M + body_len, dtype=xc.dtype,
                                      device=dev)])
    win = xpad[d0 + torch.arange(W1, device=dev)[:, None]
               + torch.arange(M, device=dev)[None, :]]
    s1c = torch.complex(dc["s1c_re"], dc["s1c_im"])
    V = win @ s1c
    m1 = V.abs() / dc["s1_e"]
    best = torch.argmax(m1)
    best_idx = d0 + best
    # --- 3. per-subcarrier channel estimate from S1 ---
    S1_rx = torch.fft.fft(xpad[best_idx + torch.arange(M, device=dev)])
    S1inv = torch.complex(dc["S1i_re"], dc["S1i_im"])
    vals = S1_rx[dc["on_idx"]] * S1inv
    Gs = torch.zeros(M, dtype=xc.dtype, device=dev)
    Gs[dc["on_idx"]] = _smooth3(vals)
    # --- 4. batched payload FFT + EQ ---
    payload_start = best_idx + M
    detected = detected & (payload_start + body_len <= T)
    body = xpad[payload_start + torch.arange(body_len, device=dev)]
    body = body.reshape(n_syms, M + cp)[:, cp:]
    Xr = torch.fft.fft(body, dim=-1) / dc["scale"]
    nz = Gs.abs() > 1e-9
    one = torch.ones((), dtype=Gs.dtype, device=dev)
    inv = torch.where(nz, 1.0 / torch.where(nz, Gs, one),
                      torch.zeros_like(Gs))
    Xeq = Xr * inv[None, :]
    # --- 5. per-symbol pilot tracking: residual phase AND timing slope
    # (reference ofdmframesync.c:876+) ---
    q = (Xeq[:, dc["pil_idx"]] * dc["pilots"])[:, dc["order"]]
    dphi_n = torch.angle(q[:, 1:] * torch.conj(q[:, :-1]))
    b_s = torch.sum(dphi_n * dc["dk"], dim=1) / dc["dk2"]
    a_s = torch.angle(torch.sum(q * _cexp_neg(b_s[:, None] * dc["kk"]),
                                dim=1))
    ph_all = a_s[:, None] + b_s[:, None] * dc["k_signed"]
    Xeq = Xeq * _cexp_neg(ph_all)
    data = Xeq[:, dc["dat_idx"]]
    # --- 6. pilot-referenced stats ---
    perr = Xeq[:, dc["pil_idx"]] * dc["pilots"] - 1.0
    evm_db = 20.0 * torch.log10(
        torch.sqrt(torch.mean(perr.abs() ** 2)) + 1e-12)
    # residual CFO from the symbol-to-symbol pilot phase advance
    if n_syms > 1:
        da = torch.angle(torch.mean(torch.exp(1j * (a_s[1:] - a_s[:-1]))))
    else:
        da = torch.zeros((), device=dev)
    return detected, best_idx, cfo + da / (M + cp), data, evm_db


def ofdm_frame_sync(params: OFDMParams, x, n_syms: int,
                    threshold: float = 0.7, device="cuda") -> OFDMSyncResult:
    """Block-native OFDM synchronizer over one capture, on ``device``
    (the card unless given; without one a CUDA device raises).

    1. Schmidl-Cox autocorrelation on the half-symbol-periodic S0
       (coarse timing + carrier offset; reference execute_seekplcp).
    2. S1 timing by one matmul cross-correlation.
    3. Per-subcarrier channel estimate from S1 (reference _S1 EQ init).
    4. Batched payload FFT + EQ + per-symbol pilot phase AND timing-
       slope tracking (reference ofdmframesync.c:876+).

    evm_db is pilot-referenced: rms error of the equalized, corrected
    pilot bins against their known +-1 values (modulation-independent).
    """
    dev = entry_device(device)
    x = np.asarray(x.cpu() if torch.is_tensor(x) else x, np.complex64)
    dc = _sync_consts(params, int(n_syms), dev)
    det, best_idx, cfo, data, evm_db = _sync_core(
        dc, torch.from_numpy(x).to(dev), float(threshold))
    if not bool(det):
        return OFDMSyncResult(False, int(best_idx), float(cfo), None, 0.0)
    return OFDMSyncResult(True, int(best_idx), float(cfo),
                          data.cpu().numpy(), float(evm_db))


# ---------------------------------------------------------------------------
# streaming detection
# ---------------------------------------------------------------------------


def s0_detect_block(buf, last_end, M: int, threshold: float, span: int,
                    T: int, n_chunk: int, P_: int, CH: int = 256):
    """Streaming Schmidl-Cox S0 detection over buffers buf [B, hist+T]:
    plateau metric + per-chunk local max + in-order suppression from the
    watermarks last_end [B].  Returns (valid [B, P], d0 [B, P] buffer
    coords, cfo [B, P], peak [B, P], cand [B, n_chunk], pos [B,
    n_chunk], n_cand [B]), the detection half shared by
    `ofdm_detector_stream` and the full ofdmflex receiver.

    The greedy suppression is a loop over the chunks on [B] tensors (a
    compare and a select each); the first P candidates of each row are
    ranked by a cumsum and scattered into slots with no host sync.
    Invalid slots take chunk 0, as the JAX package's
    ``jnp.nonzero(..., fill_value=0)`` leaves them."""
    dev = buf.device
    B = buf.shape[0]
    M2 = M // 2
    Pm, R = _window_sums(buf, M)
    Lm = n_chunk * CH
    metric = Pm[:, :Lm].abs() / torch.clamp(R[:, :Lm], min=1e-12) * 2.0
    mc = metric.reshape(B, n_chunk, CH)
    pk, arg = torch.max(mc, dim=-1)
    pos = torch.arange(n_chunk, device=dev) * CH + arg           # int64
    neg = torch.full((B, 1), float("-inf"), device=dev)
    local = (pk > torch.cat([neg, pk[:, :-1]], dim=1)) & \
        (pk >= torch.cat([pk[:, 1:], neg], dim=1))
    cand = (pk > threshold) & (pos < T) & local
    # a non-candidate chunk carries a position below any watermark
    pos_cand = torch.where(cand, pos, torch.full_like(pos, -(1 << 40)))
    pos_span = pos + span
    le = last_end.to(torch.int64)
    keeps = []
    for i in range(n_chunk):
        keep = pos_cand[:, i] >= le
        le = torch.where(keep, pos_span[:, i], le)
        keeps.append(keep)
    cand = torch.stack(keeps, dim=1)
    n_cand = cand.sum(dim=1)
    rank = torch.cumsum(cand, dim=1) - 1
    slot = torch.where(cand & (rank < P_), rank, torch.full_like(rank, P_))
    sel = torch.zeros(B, P_ + 1, dtype=torch.int64, device=dev)
    sel.scatter_(1, slot, torch.arange(n_chunk, device=dev).expand(B, n_chunk))
    sel = sel[:, :P_]
    valid = torch.arange(P_, device=dev) < n_cand[:, None]
    d0 = torch.gather(pos, 1, sel)
    peak = torch.gather(pk, 1, sel)
    cfo = torch.angle(torch.gather(Pm, 1, torch.clamp(d0, max=Lm - 1))) / M2
    return valid, d0, cfo, peak, cand, pos, n_cand


class OFDMDetBlock(NamedTuple):
    """Streaming S0 detector output, per candidate slot (the JAX
    package's (valid, sample_index, cfo, metric) tuple)."""
    valid: torch.Tensor         # [..., P] bool
    sample_index: torch.Tensor  # [..., P] int32, absolute plateau index
    cfo: torch.Tensor           # [..., P] coarse CFO, rad/sample
    rxy: torch.Tensor           # [..., P] plateau metric


class OFDMDetectorStream(Proc):
    """Streaming Schmidl-Cox S0 detector (see `ofdm_detector_stream`)."""

    CH = 256
    HIST = 1536

    def __init__(self, block_len, params, threshold, max_frames,
                 suppress_span, name):
        super().__init__(name)
        # framing/ imports this module: its stream core comes in late
        from ..framing.stream_rx import _advance_watermark, batched_apply
        self._watermark = _advance_watermark
        T = int(block_len)
        if T % self.CH != 0:
            raise ValueError("block_len must be a multiple of %d" % self.CH)
        self.M = params.M
        self.T, self.P = T, int(max_frames)
        self.threshold = float(threshold)
        self.hist = self.HIST
        self.span = int(suppress_span if suppress_span is not None
                        else 3 * (params.M + params.cp_len) + params.M)
        self.n_chunk = (self.hist + T - self.M) // self.CH
        self._step = batched_apply(self._step_2d, T)

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        batch_shape = tuple(batch_shape)
        return {"buf": torch.zeros(batch_shape + (self.hist,),
                                   dtype=torch.complex64, device=device),
                "base": torch.full(batch_shape, -self.hist,
                                   dtype=torch.int32, device=device),
                "last_end": torch.full(batch_shape, _NEG,
                                       dtype=torch.int32, device=device)}

    def _step_2d(self, carry, x):
        buf = torch.cat([carry["buf"], x.to(torch.complex64)], dim=-1)
        valid, d0, cfo, peak, cand, pos, _ = s0_detect_block(
            buf, carry["last_end"], self.M, self.threshold, self.span,
            self.T, self.n_chunk, self.P, self.CH)
        out = OFDMDetBlock(valid, carry["base"][:, None] + d0.to(torch.int32),
                           cfo, peak)
        return out, {"buf": buf[..., self.T:].contiguous(),
                     "base": carry["base"] + self.T,
                     "last_end": self._watermark(
                         carry["last_end"], {"cand": cand, "n0_seg": pos},
                         self.span, self.T)}

    def forward(self, carry, x):
        return self._step(carry, x)


def ofdm_detector_stream(block_len: int, params: OFDMParams,
                         threshold: float = 0.7, max_frames: int = 4,
                         suppress_span: int | None = None,
                         name: str = "ofdm_detector_stream"):
    """Streaming Schmidl-Cox S0 detector Proc.

    proc(carry, x[..., block_len]) -> (OFDMDetBlock(valid, sample_index,
    cfo, rxy), carry').  sample_index is the absolute coarse plateau
    position (feed `frame_demod_core` a window starting there); the
    suppression watermark re-arms after `suppress_span` samples
    (reference ofdmframesync re-arms after consuming the frame).
    Detection math: the plateau metric of the one-shot sync, segmented
    into 256-sample chunks with per-chunk local-max selection (the chunk
    grid is absolute-aligned because block_len % 256 == 0)."""
    return OFDMDetectorStream(block_len, params, threshold, max_frames,
                              suppress_span, name)
