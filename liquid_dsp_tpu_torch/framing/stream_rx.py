"""Generic streaming preamble-synchronized receiver core
(`liquid_dsp_tpu/framing/stream_rx.py`).

All of liquid's single-carrier framers share one receiver skeleton
(reference src/framing/src/framesync64.c:241-269): find a known
interpolated preamble in an unbounded stream, estimate timing, carrier
and gain, matched-filter at 2 samples/symbol, pilot-sync a fixed region,
hand the symbols to byte-domain decoding.  Every frame decodes exactly
once, in order, with no per-sample state machine: each block runs one
batched detect-everywhere pipeline, and the only state between blocks is
a sample history plus a re-arm watermark.

  * carry: ``buf`` [..., hist] complex64, the last `hist` samples;
    ``base`` int32, the absolute index of the buffer head; ``last_end``
    int32, the suppression watermark in buffer coordinates.  The keys,
    shapes and dtypes are the JAX package's, so a stream can change
    package mid-way (`convert.carry_from_numpy`).
  * detection: half-overlapped 512-point segments over the buffer,
    correlated against the template for 2*range_bins+1 carrier-bin
    hypotheses as banded matmuls (the math of qdetector_cccf seek,
    reference qdetector_cccf.c:373-441).  Each position belongs to ONE
    segment (lags [0, hop)), and the segment grid advances by exactly the
    block length, so detection is the same across block boundaries.
  * emission: candidates starting in the first T buffer positions, a
    window that advances by T per block: each frame fires once.
  * decode: up to `max_frames` candidate slots per channel are refined,
    mixed, matched-filtered at their polyphase branch and pilot-synced
    in one batched computation; `valid` masks live slots.

Batching is native: every step works on [B, ...] with the leading axes
flattened into B (`batched_apply`).  Two steps depend on the data and
stay sequential or fixed-size:
  * the greedy in-order suppression walks the T/256+1 segments in turn,
    and the first P kept segments of each row are ranked into [B, P]
    slots with no host sync (invalid slots take index 0 and zero windows,
    as the JAX package leaves them): one `suppress_scan` launch on the
    card (a warp a row, the ranking by ballots), a loop on [B] tensors
    and a cumsum and scatter on the CPU.

A time-sharded receiver (`parallel/rx.py`) runs the three steps of
`_detect_refine` itself: every shard's segment detection (with its left
neighbour's last segment peak, ``prev_peak``), one fold over all shards'
candidates in shard order, then every shard's refinement (with its left
neighbour's samples before the buffer head, ``left_ext``).  The JAX
package's ``suppress_fn`` hook gathered the candidates inside the fold;
here the host holds them between the steps.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import debug
from ..core import Proc
from ..ops.kernels.suppress_scan import rank_reference, suppress_scan

__all__ = ["StreamRxBlock", "StreamRxConfig", "DetStreamBlock",
           "preamble_stream", "detector_stream", "quad_peak", "cexp_ramp",
           "mf_symbol_gather", "STREAM_HIST", "batched_apply"]

STREAM_HIST = 1536            # history samples carried between blocks
_DET_NFFT = 512               # detection segment size (2*next_pow2(s_len))
_DET_HOP = _DET_NFFT // 2
_RANGE_BINS = 2
_NEG = -(1 << 30)             # the watermark's "never" (int32)


def cexp_ramp(dphi, phi, n: int, sign: float = -1.0):
    """(cos, sin) float planes [..., n] of e^{j*sign*(dphi*t + phi)},
    t = 0..n-1, batched over the leading axes of dphi / phi.

    Factored by angle addition, t = b*C + a with C ~ sqrt(n), so only
    C + ceil(n/C) (cos, sin) pairs are evaluated per candidate."""
    C = 1 << max(1, (int(np.ceil(np.sqrt(n))) - 1).bit_length())
    nb = -(-n // C)
    a = torch.arange(C, dtype=torch.float32, device=dphi.device)
    b = torch.arange(nb, dtype=torch.float32, device=dphi.device) * C
    pa = (sign * dphi)[..., None] * a                         # [..., C]
    pb = sign * (dphi[..., None] * b + phi[..., None])        # [..., nb]
    ca, sa = torch.cos(pa), torch.sin(pa)
    cb, sb = torch.cos(pb), torch.sin(pb)
    cr = cb[..., :, None] * ca[..., None, :] - sb[..., :, None] * sa[..., None, :]
    ci = sb[..., :, None] * ca[..., None, :] + cb[..., :, None] * sa[..., None, :]
    lead = dphi.shape
    return (cr.reshape(lead + (nb * C,))[..., :n],
            ci.reshape(lead + (nb * C,))[..., :n])


def quad_peak(ym1, y0, yp1):
    """Quadratic interpolation of a 3-point peak -> (frac offset, value)."""
    a = 0.5 * (yp1 + ym1) - y0
    b = 0.5 * (yp1 - ym1)
    big = a.abs() > 1e-20
    frac = torch.where(big, -b / (2 * torch.where(big, a, torch.ones_like(a))),
                       torch.zeros_like(a))
    return frac, a * frac * frac + b * frac + y0


def _take(x, idx):
    """x[..., idx] per row: torch.gather over the last axis."""
    return torch.gather(x, -1, idx)


class StreamRxConfig(NamedTuple):
    """Static per-framer receiver geometry (host numpy)."""
    template: np.ndarray      # interpolated preamble + tail [s_len] c64
    bank: np.ndarray          # polyphase MF bank [npfb, Lb] (branch order)
    region_start: int         # first MF symbol of the pilot region
    region_len: int           # pilot-region length (symbols, incl pilots)
    pilots: np.ndarray        # pilot symbols [npil] c64
    pilot_spacing: int
    pilot_nfft: int           # qpilotsync FFT size for this npil
    suppress_span: int        # samples suppressed after a detection
    k: int = 2                # samples/symbol


class StreamRxBlock(NamedTuple):
    """Per-block batched detection + sync result: the last axis before
    any per-slot data is the candidate slot (fixed max_frames); `valid`
    masks live slots."""
    valid: torch.Tensor        # [..., P] bool
    sample_index: torch.Tensor  # [..., P] int32, absolute stream index
    rxy: torch.Tensor          # [..., P] detection correlation
    gamma: torch.Tensor        # [..., P] channel gain
    dphi: torch.Tensor         # [..., P] coarse CFO, rad/sample
    phi: torch.Tensor          # [..., P] carrier phase at frame start
    tau: torch.Tensor          # [..., P] fractional timing offset
    b_idx: torch.Tensor        # [..., P] int32 polyphase branch
    off_s: torch.Tensor        # [..., P] int32 integer sample offset
    dphi2: torch.Tensor        # [..., P] pilot residual CFO, rad/symbol
    phi2: torch.Tensor         # [..., P] pilot phase
    g2: torch.Tensor           # [..., P] pilot gain
    region_syms: torch.Tensor  # [..., P, region_len] corrected symbols


class DetStreamBlock(NamedTuple):
    """Streaming detector output: candidate-slot batched estimates."""
    valid: torch.Tensor
    sample_index: torch.Tensor
    rxy: torch.Tensor
    gamma: torch.Tensor
    dphi: torch.Tensor
    phi: torch.Tensor
    tau: torch.Tensor


def mf_symbol_gather(buf, n0, off_s, dphi, phi, gamma, bank, b_idx,
                     n_sym, *, start_sym=0, k=2, win=None):
    """Batched mix + polyphase matched filter + k:1 symbol sampling.

    buf [B, L] complex; n0 / off_s / dphi / phi / gamma / b_idx [B, P];
    bank [npfb, Lb] float32 (newest-first taps).  Returns [B, P, n_sym]
    symbols for symbol indices [start_sym, start_sym + n_sym) relative to
    the frame start; the mixer phase is referenced to the template start
    (sample n0), as in the one-shot receiver.  With ``win`` [B, P, 2, U]
    (the windows `_detect_refine` cut, Lb samples of front pad) the
    spans come from it; otherwise they are gathered from a zero-padded
    buf (a clamped index would shift a window near the buffer edge).
    The matched filter is one grouped conv1d over all candidates (on the
    card cuDNN: TF32 must be off for the stated tolerances)."""
    Lb = int(bank.shape[1])
    span = k * (n_sym - 1) + Lb
    B, P = n0.shape
    if win is not None and start_sym == 0:
        assert win.shape[-1] >= span + 1, "union window too short"
        sel = (off_s == 0)[..., None, None]
        spans2 = torch.where(sel, win[..., 1:span + 1], win[..., :span])
        spans = torch.complex(spans2[..., 0, :], spans2[..., 1, :])
        t0 = (off_s - (Lb - 1)).to(torch.float32)
    else:
        pad = Lb
        bufp = F.pad(buf, (pad, k * start_sym + span))
        start = pad + n0 + off_s + k * start_sym - (Lb - 1)       # [B, P]
        idx = start[..., None] + torch.arange(span, device=buf.device)
        spans = torch.gather(bufp, 1, idx.reshape(B, -1)).reshape(B, P, span)
        t0 = (start - pad - n0).to(torch.float32)
    mr, mi = cexp_ramp(dphi, phi + dphi * t0, span)
    vmix = spans * torch.complex(mr, mi)
    taps = bank[b_idx.long()]                                   # [B, P, Lb]
    xp2 = torch.stack([vmix.real, vmix.imag]).reshape(2, B * P, span)
    y2 = F.conv1d(xp2, taps.reshape(B * P, 1, Lb), stride=k, groups=B * P)
    sym = torch.complex(y2[0], y2[1]).reshape(B, P, -1)
    return sym * (0.5 / torch.clamp(gamma, min=1e-12))[..., None]


def _detect_consts(template: np.ndarray) -> dict:
    """Numpy constants of the detect-everywhere correlator."""
    s = template.astype(np.complex64)
    S = np.fft.fft(s, _DET_NFFT)
    offsets = np.arange(-_RANGE_BINS, _RANGE_BINS + 1)
    So_np = np.stack([np.roll(S, off) for off in offsets])
    # banded correlation matrices: column (o, l) holds
    # s_o = s * e^{2j pi off_o n / NFFT} (unconjugated; the Rr/Ri
    # combination in _detect_refine conjugates) at rows l..l+s_len-1
    n_off = len(offsets)
    n = np.arange(len(s))
    Br = np.zeros((_DET_NFFT, n_off * _DET_HOP), np.float32)
    Bi = np.zeros_like(Br)
    for o, off in enumerate(offsets):
        so = s * np.exp(2j * np.pi * off * n / _DET_NFFT)
        for l in range(_DET_HOP):
            Br[l:l + len(s), o * _DET_HOP + l] = so.real
            Bi[l:l + len(s), o * _DET_HOP + l] = so.imag
    return {
        "So_re": So_np.real.astype(np.float32),
        "So_im": So_np.imag.astype(np.float32),
        "band_re": Br,
        "band_im": Bi,
        "sconj_re": s.conj().real.astype(np.float32),
        "sconj_im": s.conj().imag.astype(np.float32),
        "s_len": len(s),
        "s2_sum": float(np.sum(np.abs(s) ** 2)),
    }


def _detect_segments(buf, dc: dict, threshold: float, T: int, starts,
                     prev_peak=None):
    """Detect everywhere, the first step of `_detect_refine`: the
    correlation peak of every segment over [B] buffers, and which segments
    are candidates (above threshold, starting in the emit window [0, T),
    and a local peak) before the suppression fold.

    buf [B, H+T] complex64; starts [n_seg] int64.  prev_peak [B] (a time
    shard's hook) stands for the -inf before the first segment: the left
    neighbour's last owned segment peak.  Returns a dict of [B, n_seg]
    tensors: "peak", "off" (carrier-bin index), "n0_seg" (buffer
    position), "cand"."""
    dev = buf.device
    B = buf.shape[0]
    seg_idx = starts[:, None] + torch.arange(_DET_NFFT, device=dev)
    segs = buf[:, seg_idx]                               # [B, n_seg, NFFT]
    seg_peak, seg_arg = _seg_peaks(segs, dc)
    seg_off = seg_arg // _DET_HOP
    n0_seg = starts + seg_arg % _DET_HOP                 # buffer position
    debug.tap("stream_rx.seg_peak", seg_peak)           # per-segment rxy
    # a peak at p % hop == hop-1 has a +-1-sample twin in the NEXT
    # segment: keep only segments that beat both neighbours
    neg = torch.full((B, 1), float("-inf"), device=dev)
    first = neg if prev_peak is None else prev_peak.reshape(B, 1).to(
        seg_peak.dtype)
    pk_prev = torch.cat([first, seg_peak[:, :-1]], dim=1)
    pk_next = torch.cat([seg_peak[:, 1:], neg], dim=1)
    local = (seg_peak > pk_prev) & (seg_peak >= pk_next)
    cand = (seg_peak > threshold) & (n0_seg < T) & local
    return {"peak": seg_peak, "off": seg_off, "n0_seg": n0_seg,
            "cand": cand}


def _seg_peaks(segs, dc: dict):
    """(peak, argmax) of the detection metric of segments [B, S, NFFT]
    over the 5 carrier bins x hop lags (qdetector seek as banded
    matmuls)."""
    Fr, Fi = segs.real, segs.imag
    Br, Bi = dc["band_re"], dc["band_im"]
    Rr = Fr @ Br + Fi @ Bi                               # [B, S, 5*hop]
    Ri = Fi @ Br - Fr @ Bi
    x2 = torch.sum(Fr ** 2 + Fi ** 2, dim=-1)
    g0 = torch.sqrt(torch.clamp(x2, min=1e-20) * (dc["s_len"] / _DET_NFFT))
    g = 1.0 / (g0 * np.sqrt(dc["s2_sum"]))
    rxy_flat = torch.sqrt(Rr ** 2 + Ri ** 2) * g[..., None]
    arg = torch.argmax(rxy_flat, dim=-1)
    return _take(rxy_flat, arg[..., None])[..., 0], arg


def _seg_peak_at(buf, dc: dict, start: int):
    """Detection peak [B] of the ONE segment at static buffer position
    `start`: the metric `_detect_segments` computes in its grid.  A time
    shard computes its last owned segment's peak from its own buffer and
    hands it to its right neighbour as ``prev_peak`` (parallel/rx.py)."""
    return _seg_peaks(buf[:, None, start:start + _DET_NFFT], dc)[0][:, 0]


def _suppress(last_end, cand, n0_seg, span: int, P: int | None = None):
    """The greedy in-order fold, the second step of `_detect_refine`: once
    a frame is detected nothing fires again until `span` samples have
    passed (the reference's re-arm).  Sequential over the segments,
    batched over rows; a non-candidate segment carries a position below
    any watermark.  last_end [B]; cand, n0_seg [B, S] in order (a
    time-sharded receiver passes every shard's segments, in shard order,
    in one buffer's coordinates).  Returns the [B, S] keep mask, and with
    `P` also the first P kept segments' ranking (sel [B, P], n_cand
    [B]): one `suppress_scan` launch on the card."""
    return suppress_scan(last_end, cand, n0_seg, span, P=P)


def _detect_refine(buf, last_end, dc: dict, threshold: float, P: int,
                   T: int, starts, span: int, front_pad: int = 0,
                   win_len: int | None = None):
    """Detect-everywhere + per-candidate refinement over [B] buffers:
    `_detect_segments`, `_suppress` and `_refine` in sequence.

    buf [B, H+T] complex64; last_end [B] int32 watermark (buffer coords);
    dc: `_detect_consts` as tensors on buf's device ("So", "band_re",
    "band_im", "sconj") plus "s_len" and "s2_sum"; starts [n_seg] int64.
    Returns a dict of [B, P] candidate estimates plus the [B, n_seg]
    keep mask and segment positions the watermark folds.  With
    front_pad / win_len, ONE [2, win_len] window per candidate is cut
    starting front_pad samples before n0 and returned as "win" for
    `mf_symbol_gather`.  A time shard runs the three steps itself, with
    its hooks (`parallel/rx.py`).
    """
    seg = _detect_segments(buf, dc, threshold, T, starts)
    keep, sel, n_cand = _suppress(last_end, seg["cand"], seg["n0_seg"],
                                  span, P)
    return _refine(buf, seg, keep, dc, P, T, front_pad, win_len,
                   rank=(sel, n_cand))


def _refine(buf, seg: dict, keep, dc: dict, P: int, T: int,
            front_pad: int = 0, win_len: int | None = None, left_ext=None,
            rank=None):
    """Per-candidate refinement, the third step of `_detect_refine`: the
    first P kept segments of each row (qdetector align, batched).

    seg: `_detect_segments`'s dict; keep [B, n_seg]: the fold's mask.
    left_ext [B, 2, front_pad] float planes (a time shard's hook) stand
    for the zero front pad: REAL neighbour samples before the buffer head
    (shard 0 keeps zeros, the stream head).  rank: (sel [B, P], n_cand
    [B]), the first P kept segments as the fold's launch ranked them;
    without it they are ranked here (`rank_reference`).  "cand" and
    "n0_seg" of the result are what the watermark folds: the keep mask
    and positions."""
    dev = buf.device
    B = buf.shape[0]
    n_seg = keep.shape[1]
    s_len, s2_sum = dc["s_len"], dc["s2_sum"]
    n0_seg, seg_off, seg_peak = seg["n0_seg"], seg["off"], seg["peak"]
    cand = keep

    # the first P candidates of each row, in order, without a host sync
    # (invalid slots: 0)
    sel, n_cand = rank_reference(cand, P) if rank is None else rank
    valid = torch.arange(P, device=dev) < n_cand[:, None]
    n0 = _take(n0_seg, sel)                              # [B, P]
    off_i = _take(seg_off, sel)
    peak = _take(seg_peak, sel)

    # ---- per-candidate refinement (qdetector align, batched) ----
    U = int(win_len) if win_len is not None else _DET_NFFT
    fp = int(front_pad)
    buf2 = torch.stack([buf.real, buf.imag], dim=1)      # [B, 2, H+T]
    if fp or U > _DET_NFFT:
        # zero padding keeps the edge semantics; the end pad lets n0 = T-1
        # take a whole window
        need_end = max(0, (T - 1 - fp + U) - buf2.shape[-1])
        if left_ext is not None and fp:
            buf2 = F.pad(torch.cat([left_ext.to(buf2.dtype), buf2], dim=-1),
                         (0, need_end))
        else:
            buf2 = F.pad(buf2, (fp, need_end))
    idx = (n0[..., None] + torch.arange(U, device=dev)).reshape(B, 1, P * U)
    win = torch.gather(buf2, 2, idx.expand(B, 2, P * U))
    win = win.reshape(B, 2, P, U).permute(0, 2, 1, 3)    # [B, P, 2, U]
    win = torch.where(valid[..., None, None], win, torch.zeros((), device=dev))
    xa = torch.complex(win[..., 0, fp:fp + _DET_NFFT],
                       win[..., 1, fp:fp + _DET_NFFT])   # [B, P, NFFT]
    Xa = torch.fft.fft(xa, dim=-1)
    Ra = torch.fft.ifft(Xa * dc["So"].conj()[off_i], dim=-1) * _DET_NFFT
    tau, g_pk = quad_peak(torch.sqrt(Ra[..., -1].abs()),
                          torch.sqrt(Ra[..., 0].abs()),
                          torch.sqrt(Ra[..., 1].abs()))
    gamma = g_pk * g_pk / (_DET_NFFT * s2_sum)
    # fine carrier: FFT of the aligned window times conj(template)
    W = torch.fft.fft(xa[..., :s_len] * dc["sconj"], n=_DET_NFFT, dim=-1)
    Wm = W.abs()
    i0 = torch.argmax(Wm, dim=-1)
    vm1 = _take(Wm, torch.remainder(i0 - 1, _DET_NFFT)[..., None])[..., 0]
    v0 = _take(Wm, i0[..., None])[..., 0]
    vp1 = _take(Wm, torch.remainder(i0 + 1, _DET_NFFT)[..., None])[..., 0]
    frac, _ = quad_peak(vm1, v0, vp1)
    index = i0 + frac - torch.where(i0 > _DET_NFFT // 2, _DET_NFFT, 0)
    dphi = index * (2 * np.pi / _DET_NFFT)
    phi = torch.angle(_take(W, i0[..., None])[..., 0])
    return {"valid": valid, "n_cand": n_cand, "n0": n0, "off_i": off_i,
            "peak": peak, "tau": tau, "gamma": gamma, "dphi": dphi,
            "phi": phi, "cand": cand, "n0_seg": n0_seg, "win": win}


def _advance_watermark(last_end, det, span: int, T: int):
    """Fold this block's detections into the next block's suppression
    watermark, shifted into the next block's buffer coordinates."""
    cand, n0_seg = det["cand"], det["n0_seg"]
    last_n0 = torch.where(cand, n0_seg,
                          torch.full_like(n0_seg, _NEG)).amax(dim=1)
    fired = torch.where(cand.any(dim=1), last_n0 + span,
                        torch.full_like(last_n0, _NEG))
    new_last = torch.maximum(last_end.to(torch.int64), fired) - T
    return torch.clamp(new_last, min=_NEG).to(torch.int32)


def batched_apply(apply_2d, T: int):
    """Wrap ``apply_2d(carry, x[B, T])`` (carry leaves [B, ...]) into the
    Proc step with arbitrary leading batch axes: flatten them into B,
    run, reshape every output and carry leaf back."""

    def reshape(tree, lead):
        if isinstance(tree, dict):
            return {k: reshape(v, lead) for k, v in tree.items()}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(reshape(v, lead) for v in tree))
        return tree.reshape(lead + tree.shape[1:])

    def apply(carry, x):
        if x.shape[-1] != T:
            raise ValueError(f"block length {x.shape[-1]}, this receiver "
                             f"was built for {T}")
        batch = tuple(x.shape[:-1])
        B = int(np.prod(batch)) if batch else 1
        cf = {k: v.reshape((B,) + v.shape[len(batch):])
              for k, v in carry.items()}
        out, nc = apply_2d(cf, x.reshape(B, T))
        return reshape(out, batch), reshape(nc, batch)

    return apply


def _check_len(T: int, hist, floor: int) -> int:
    if T % _DET_HOP != 0:
        raise ValueError("block_len must be a multiple of %d" % _DET_HOP)
    hist = STREAM_HIST if hist is None else hist
    hist = -(-int(hist) // _DET_HOP) * _DET_HOP
    if hist < floor or hist < _DET_NFFT:
        # a shorter history would cut segment or refine windows at the
        # buffer edge and shift them near the block tail
        raise ValueError("history window too short for this frame region")
    return hist


class _DetectBase(Proc):
    """The carry and the detection constants (as buffers) of both stream
    receivers."""

    hist: int

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        batch_shape = tuple(batch_shape)
        return {"buf": torch.zeros(batch_shape + (self.hist,),
                                   dtype=torch.complex64, device=device),
                "base": torch.full(batch_shape, -self.hist,
                                   dtype=torch.int32, device=device),
                # buffer-relative position before which detections are
                # suppressed: the reference's re-arm after a frame
                "last_end": torch.full(batch_shape, _NEG, dtype=torch.int32,
                                       device=device)}

    def _register_detect(self, template, T: int, P: int, span: int):
        dc = _detect_consts(np.asarray(template))
        self.register_buffer("So", torch.complex(
            torch.from_numpy(dc["So_re"]), torch.from_numpy(dc["So_im"])))
        self.register_buffer("band_re", torch.from_numpy(dc["band_re"]))
        self.register_buffer("band_im", torch.from_numpy(dc["band_im"]))
        self.register_buffer("sconj", torch.complex(
            torch.from_numpy(dc["sconj_re"]),
            torch.from_numpy(dc["sconj_im"])))
        # segment grid restricted to the emit region, plus one segment
        # past T for the local-peak comparison
        self.register_buffer("starts", torch.arange(T // _DET_HOP + 1) *
                             _DET_HOP)
        self.s_len, self.s2_sum = dc["s_len"], dc["s2_sum"]
        self.T, self.P, self.span = T, P, span

    def _dc(self):
        return {"So": self.So, "band_re": self.band_re,
                "band_im": self.band_im, "sconj": self.sconj,
                "s_len": self.s_len, "s2_sum": self.s2_sum}

    def _detect(self, carry, x, **kw):
        buf = torch.cat([carry["buf"], x.to(torch.complex64)], dim=-1)
        det = _detect_refine(buf, carry["last_end"], self._dc(),
                             self.threshold, self.P, self.T, self.starts,
                             self.span, **kw)
        new_carry = {"buf": buf[..., self.T:].contiguous(),
                     "base": carry["base"] + self.T,
                     "last_end": _advance_watermark(carry["last_end"], det,
                                                    self.span, self.T)}
        return buf, det, new_carry


class DetectorStream(_DetectBase):
    """Streaming preamble DETECTOR (see `detector_stream`)."""

    def __init__(self, block_len, template, threshold, max_frames,
                 suppress_span, name, hist):
        super().__init__(name)
        T = int(block_len)
        self.hist = _check_len(T, hist, _DET_NFFT)
        span = int(suppress_span if suppress_span is not None
                   else len(template))
        self._register_detect(template, T, int(max_frames), span)
        self.threshold = float(threshold)
        self._step = batched_apply(self._step_2d, T)

    def _step_2d(self, carry, x):
        _, det, new_carry = self._detect(carry, x)
        out = DetStreamBlock(
            valid=det["valid"],
            sample_index=carry["base"][:, None] + det["n0"].to(torch.int32),
            rxy=det["peak"], gamma=det["gamma"], dphi=det["dphi"],
            phi=det["phi"], tau=det["tau"])
        return out, new_carry

    def forward(self, carry, x):
        return self._step(carry, x)


def detector_stream(block_len: int, template: np.ndarray,
                    threshold: float = 0.5, max_frames: int = 4,
                    suppress_span: int | None = None,
                    name: str = "detector_stream",
                    hist: int | None = None) -> DetectorStream:
    """Streaming preamble detector Proc: the detect-everywhere + refine
    front half of `preamble_stream`, without a matched-filter / pilot
    back end.  proc(carry, x[..., block_len]) -> (DetStreamBlock, carry').
    hist overrides STREAM_HIST (detections lag the newest sample by at
    least `hist`).  Reference analog: qdetector_cccf run persistently over
    a stream (qdetector_cccf.c:373-441) with re-arm semantics."""
    return DetectorStream(block_len, template, threshold, max_frames,
                          suppress_span, name, hist)


class PreambleStream(_DetectBase):
    """Streaming preamble-sync receiver (see `preamble_stream`)."""

    def __init__(self, block_len, cfg: StreamRxConfig, threshold,
                 max_frames, name, hist):
        super().__init__(name)
        T = int(block_len)
        self.n_sym_tot = cfg.region_start + cfg.region_len
        self.hist = _check_len(T, hist, cfg.k * self.n_sym_tot + 2)
        self._register_detect(cfg.template, T, int(max_frames),
                              int(cfg.suppress_span))
        self.threshold = float(threshold)
        self.register_buffer("bank", torch.from_numpy(
            cfg.bank[:, ::-1].astype(np.float32).copy()))   # newest-first
        self.register_buffer("pilots", torch.from_numpy(
            np.asarray(cfg.pilots, np.complex64)))
        self.npfb = int(cfg.bank.shape[0])
        self.Lb = int(cfg.bank.shape[1])
        self.k = int(cfg.k)
        self.spacing, self.pfft = int(cfg.pilot_spacing), int(cfg.pilot_nfft)
        self.region_start = int(cfg.region_start)
        self.region_len = int(cfg.region_len)
        self.mf_span = self.k * (self.n_sym_tot - 1) + self.Lb
        self.win_len = max(self.Lb + _DET_NFFT, self.mf_span + 1)
        pil_idx = np.nonzero(np.arange(self.region_len) % self.spacing == 0)[0]
        self.register_buffer("pil_idx", torch.from_numpy(
            pil_idx[:len(cfg.pilots)].astype(np.int64)))
        self._step = batched_apply(self._step_2d, T)

    def _step_2d(self, carry, x):
        buf, det, new_carry = self._detect(carry, x, front_pad=self.Lb,
                                           win_len=self.win_len)
        return self._sync(buf, det, carry["base"]), new_carry

    def forward(self, carry, x):
        return self._step(carry, x)

    def _sync(self, buf, det, base):
        """Mix + polyphase MF + pilot sync over the refined candidates
        (the JAX package's _rx_sync_block)."""
        tau, gamma = det["tau"], det["gamma"]
        dphi, phi = det["dphi"], det["phi"]
        npfb, spacing, pfft = self.npfb, self.spacing, self.pfft
        npil = int(self.pilots.shape[0])
        b_idx = torch.remainder(torch.where(
            tau > 0, torch.floor(tau * npfb), torch.floor((1.0 + tau) * npfb)
        ).to(torch.int32), npfb)
        off_s = torch.where(tau > 0, 0, -1).to(torch.int32)
        sym = mf_symbol_gather(buf, det["n0"], off_s, dphi, phi, gamma,
                               self.bank, b_idx, self.n_sym_tot, k=self.k,
                               win=det["win"])
        region_rx = sym[..., self.region_start:]          # [B, P, region]

        # ---- pilot sync (qpilotsync_execute, batched) ----
        v = region_rx[..., self.pil_idx] * self.pilots.conj()
        V = torch.fft.fft(v, n=pfft, dim=-1)
        Vm = V.abs()
        j0 = torch.argmax(Vm, dim=-1)
        um1 = _take(Vm, torch.remainder(j0 - 1, pfft)[..., None])[..., 0]
        u0 = _take(Vm, j0[..., None])[..., 0]
        up1 = _take(Vm, torch.remainder(j0 + 1, pfft)[..., None])[..., 0]
        frac2, _ = quad_peak(um1, u0, up1)
        jdx = j0 + frac2 - torch.where(j0 > pfft // 2, pfft, 0)
        dphi2 = jdx * (2 * np.pi / (pfft * spacing))
        rot = dphi2[..., None] * torch.arange(
            0, npil * spacing, spacing, device=buf.device).to(torch.float32)
        metric = torch.sum(v * torch.complex(torch.cos(rot), -torch.sin(rot)),
                           dim=-1)
        phi2 = torch.angle(metric)
        g2 = metric.abs() / npil
        c2r, c2i = cexp_ramp(dphi2, phi2, self.region_len)
        corr = torch.complex(c2r, c2i) / torch.clamp(g2, min=1e-12)[..., None]
        region_syms = region_rx * corr
        debug.tap("stream_rx.dphi", dphi)
        debug.tap("stream_rx.region_syms", region_syms)
        return StreamRxBlock(
            valid=det["valid"],
            sample_index=base[:, None] + det["n0"].to(torch.int32),
            rxy=det["peak"], gamma=gamma, dphi=dphi, phi=phi, tau=tau,
            b_idx=b_idx, off_s=off_s, dphi2=dphi2, phi2=phi2, g2=g2,
            region_syms=region_syms)


def preamble_stream(block_len: int, cfg: StreamRxConfig,
                    threshold: float = 0.5, max_frames: int = 4,
                    name: str = "preamble_stream",
                    hist: int | None = None) -> PreambleStream:
    """Streaming preamble-sync receiver Proc.

    proc(carry, x[..., block_len]) -> (StreamRxBlock, carry').
    block_len must be a multiple of the detection hop (256) so the
    absolute segment grid is block-invariant; hist overrides STREAM_HIST
    and is rounded up to a multiple of the hop.
    """
    return PreambleStream(block_len, cfg, threshold, max_frames, name, hist)
