"""gmskframegen / gmskframesync: GMSK-modulated frames, their host-loop
streaming receiver and the full streaming receiver
(`liquid_dsp_tpu/framing/gmskframe.py`).

Reference analogs: src/framing/src/gmskframegen.c:40-360 (the 63-bit
msequence(6, 0x6d, 1) preamble, a 13-byte header of 8 user bytes plus
version, length, crc and fec fields coded CRC-32 + Hamming(12,8) and
scrambled, the payload per its own FEC; k samples per bit) and
gmskframesync.c (preamble correlator, phase-derivative demodulation).

  * `gmskframegen` assembles a frame on the host (returns numpy);
  * `gmskframesync` recovers one frame from a capture: detection and
    demodulation on ``device`` (the card unless given), the byte decode on
    the host;
  * `GMSKFrameSync`, the callback object (create / execute / callback per
    frame): the streaming detector (`stream_rx.detector_stream`) on the
    device, per frame the header and payload demodulated there from the
    raw samples it keeps, a block-coded payload decoded soft there too;
  * `gmskframe_rx_stream`, the FULL receiver of one payload configuration
    in one block step on the device: detect, refine, mix, the phase
    derivative and its matched filter for every candidate, the
    descrambled header (hamming128 codebook), the payload (the block
    decoder, or for a convolutional payload the `viterbi_acs` kernel),
    byte pack and both CRCs.
The GMSK demodulator is CFO-tolerant: a carrier offset is a constant
bias of the instantaneous frequency, and the detector's estimate is
mixed out first.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..core import entry_device
from ..design.firdes import firdes_gmskrx
from ..design.windows import hamming
from ..fec.block import pack_bits, unpack_bits
from ..fec.device import (conv_packet_soft_decoder, device_packet_finish,
                          packetizer_soft_decoder)
from ..fec.packetizer import (packetizer_compute_enc_msg_len,
                              packetizer_decode, packetizer_encode)
from ..modem.cpm import _phase_diff, gmsk_demodulator, gmsk_modulator
from ..ops.fir import fir_apply_auto
from ..utils.random import _MASKS, scramble_data, unscramble_data
from ..utils.sequence import MSequence
from .detector import qdetector_detect
from .stream_rx import (STREAM_HIST, DetStreamBlock, _check_len, _DET_NFFT,
                        _DetectBase, batched_apply, detector_stream)
from .wire import crc_from_wire, crc_to_wire, fec_from_wire, fec_to_wire

__all__ = ["gmskframegen", "gmskframesync", "GMSKFrameResult",
           "GMSKFrameSync", "GMSKFRAME_H_USER", "gmskframe_rx_stream",
           "GMSKStreamBlock"]

GMSKFRAME_H_USER = 8
_H_CRC, _H_FEC = "crc32", "hamming128"
_VERSION = 3
_N_PRE = 63                  # preamble bits
_PAD = 64                    # raw-window margin after a frame's last bit


def _preamble_bits(n: int = _N_PRE) -> np.ndarray:
    ms = MSequence(6, 0x6D, 1)
    return np.asarray([ms.advance() for _ in range(n)], np.uint8)


def _h_enc_len() -> int:
    return packetizer_compute_enc_msg_len(GMSKFRAME_H_USER + 5, _H_CRC,
                                          _H_FEC, "none")


def _modulate_host(bits: np.ndarray, k: int, m: int, bt: float):
    mod = gmsk_modulator(k, m, bt)
    y, _ = mod(mod.init(), torch.from_numpy(bits.astype(np.int32)))
    return y.numpy().astype(np.complex64)


def _wire_fields(n: int, crc: str, fec0: str, fec1: str) -> dict:
    """Header bytes 8..12 (gmskframegen.c:317-345): version, the 16-bit
    payload length, crc(3 bits) << 5 | fec0(5 bits), fec1(5 bits)."""
    q = GMSKFRAME_H_USER
    return {q + 0: _VERSION, q + 1: (n >> 8) & 0xFF, q + 2: n & 0xFF,
            q + 3: ((crc_to_wire(crc) & 0x07) << 5) |
            (fec_to_wire(fec0) & 0x1F),
            q + 4: fec_to_wire(fec1) & 0x1F}


def _frame_bits(header, payload, m: int = 3, crc: str = "crc32",
                fec0: str = "none", fec1: str = "none") -> np.ndarray:
    """A frame's bits before the modulator: the preamble, the scrambled
    header, the payload and 2m flush bits."""
    header = np.asarray(header, np.uint8)
    payload = np.asarray(payload, np.uint8)
    if header.shape != (GMSKFRAME_H_USER,):
        raise ValueError(f"gmskframe header must be {GMSKFRAME_H_USER} "
                         f"bytes")
    hdr = np.zeros(GMSKFRAME_H_USER + 5, np.uint8)
    hdr[:GMSKFRAME_H_USER] = header
    for i, v in _wire_fields(len(payload), crc, fec0, fec1).items():
        hdr[i] = v
    h_enc = scramble_data(packetizer_encode(hdr, _H_CRC, _H_FEC, "none"))
    p_enc = packetizer_encode(payload, crc, fec0, fec1)
    return np.concatenate([_preamble_bits(), unpack_bits(h_enc),
                           unpack_bits(p_enc), np.zeros(2 * m, np.uint8)])


def _ramp(k: int, m: int) -> np.ndarray:
    """The amplitude ramp over a frame's first and last m symbols
    (gmskframegen.c:360): [2mk] float32, the first mk for the head."""
    return hamming(2 * m * k).astype(np.float32)


def gmskframegen(header, payload, k: int = 2, m: int = 3, bt: float = 0.5,
                 crc: str = "crc32", fec0: str = "none",
                 fec1: str = "none") -> np.ndarray:
    """Assemble a GMSK frame; returns complex64 samples (k per bit)."""
    y = _modulate_host(_frame_bits(header, payload, m, crc, fec0, fec1),
                       k, m, bt)
    w = _ramp(k, m)
    y[: m * k] *= w[: m * k]
    y[-m * k:] *= w[m * k:]
    return y


class GMSKFrameResult(NamedTuple):
    detected: bool
    header_ok: bool
    crc_ok: bool
    header: Optional[np.ndarray]
    payload: Optional[np.ndarray]
    payload_len: int


@functools.lru_cache(maxsize=8)
def _template(k: int, m: int, bt: float) -> np.ndarray:
    """The modulated preamble plus 2m flush bits: the detector's
    template."""
    bits = np.concatenate([_preamble_bits(), np.zeros(2 * m, np.uint8)])
    return _modulate_host(bits, k, m, bt)


def _header_geometry(hdr):
    """(n_payload, crc, fec0, fec1, p_enc_len) from a decoded header's
    fields; ValueError or KeyError for a wire value with no scheme."""
    q = GMSKFRAME_H_USER
    n_payload = (int(hdr[q + 1]) << 8) | int(hdr[q + 2])
    crc = crc_from_wire((int(hdr[q + 3]) >> 5) & 0x07)
    fec0 = fec_from_wire(int(hdr[q + 3]) & 0x1F)
    fec1 = fec_from_wire(int(hdr[q + 4]) & 0x1F)
    return (n_payload, crc, fec0, fec1,
            packetizer_compute_enc_msg_len(n_payload, crc, fec0, fec1))


def _mix(win: torch.Tensor, dphi, phi) -> torch.Tensor:
    """win [..., n] * exp(-j(dphi*t + phi)), t = 0..n-1 (float32 phase)."""
    t = torch.arange(win.shape[-1], dtype=torch.float32, device=win.device)
    ph = dphi[..., None] * t + phi[..., None]
    return win * torch.complex(torch.cos(ph), -torch.sin(ph))


def gmskframesync(x, k: int = 2, m: int = 3, bt: float = 0.5,
                  threshold: float = 0.5, device="cuda") -> GMSKFrameResult:
    """Recover a GMSK frame from a capture buffer: detection and the
    demodulator on ``device`` (the card unless given), the header and
    payload decode on the host (hard decisions)."""
    device = entry_device(device)
    x = np.asarray(x.cpu() if torch.is_tensor(x) else x, np.complex64)
    det = qdetector_detect(x, _template(k, m, bt), threshold=threshold,
                           range_bins=2, device=device)
    nores = GMSKFrameResult(False, False, False, None, None, 0)
    if not det.detected:
        return nores
    n0 = det.sample_index
    t = np.arange(len(x) - n0)
    xa = (x[n0:] * np.exp(-1j * (det.dphi_hat * t + det.phi_hat))
          ).astype(np.complex64)
    dem = gmsk_demodulator(k, m, bt).to(device)
    bits, _ = dem(dem.init(device=device), torch.from_numpy(xa).to(device))
    bits = bits.cpu().numpy()[2 * m:]           # the demodulator's delay
    h_enc_len = _h_enc_len()
    h_bits = 8 * h_enc_len
    if len(bits) < _N_PRE + h_bits:
        return nores
    h_enc = unscramble_data(
        pack_bits(bits[_N_PRE: _N_PRE + h_bits])[:h_enc_len])
    hdr, h_ok = packetizer_decode(h_enc, GMSKFRAME_H_USER + 5, _H_CRC,
                                  _H_FEC, "none")
    q = GMSKFRAME_H_USER
    if not h_ok or hdr[q] != _VERSION:
        return GMSKFrameResult(True, False, False, None, None, 0)
    try:
        n_payload, crc, fec0, fec1, p_enc_len = _header_geometry(hdr)
    except (ValueError, KeyError):
        return GMSKFrameResult(True, False, False, None, None, 0)
    p_bits = 8 * p_enc_len
    if len(bits) < _N_PRE + h_bits + p_bits:
        return GMSKFrameResult(True, True, False, hdr[:q], None, n_payload)
    p_enc = pack_bits(bits[_N_PRE + h_bits:
                           _N_PRE + h_bits + p_bits])[:p_enc_len]
    payload, ok = packetizer_decode(p_enc, n_payload, crc, fec0, fec1)
    return GMSKFrameResult(True, True, bool(ok), hdr[:q], payload,
                           n_payload)


# ---------------------------------------------------------------------------
# the host-loop streaming receiver
# ---------------------------------------------------------------------------


class GMSKFrameSync:
    """Streaming multi-frame GMSK receiver with the callback contract (the
    reference gmskframesync object: create / execute / callback,
    gmskframesync.c:72-113).  execute() takes any number of samples; the
    callback fires once per decoded frame with (header, header_ok,
    payload, payload_ok, stats).

    device: where the receiver runs (the card unless given; without one a
    CUDA device raises).  Per block the streaming detector runs there;
    per frame the header and the payload are demodulated there from the
    raw samples this object keeps, the header decodes on the host, and a
    payload whose outer code is a block code (inner 'none') decodes soft
    on the device from the matched filter's metrics; other payloads
    decode on the host by hard decisions, as in the JAX package."""

    def __init__(self, callback: Optional[Callable] = None,
                 k: int = 2, m: int = 3, bt: float = 0.5,
                 block_len: int = 4096, threshold: float = 0.5,
                 max_frames: int = 4, device="cuda"):
        self.callback = callback
        self._k, self._m, self._bt = int(k), int(m), float(bt)
        self.block_len = int(block_len)
        self.device = entry_device(device)
        tpl = _template(k, m, bt)
        self._proc = detector_stream(self.block_len, tpl,
                                     threshold=threshold,
                                     max_frames=max_frames,
                                     suppress_span=len(tpl) - 8
                                     ).to(self.device)
        self._carry = self._proc.init(device=self.device)
        self._dems = {s: gmsk_demodulator(k, m, bt, soft=s).to(self.device)
                      for s in (False, True)}
        self._h_enc_len = _h_enc_len()
        self._h_bits = 8 * self._h_enc_len
        self._pending = np.zeros(0, np.complex64)
        self._ring = np.zeros(0, np.complex64)
        self._ring_base = 0
        self._abs_fed = 0
        self._cands: list = []
        self._armed_until = -(1 << 60)
        self.frames: list = []
        self.num_frames_detected = 0
        self._dev_fec_cache: dict = {}

    def _device_decoder(self, n_payload, crc, fec0, fec1):
        """Cached device soft decoder (metrics -> bytes, crc_ok) for a
        payload whose outer code is a block scheme and inner code 'none';
        None for other configs.  GMSK feeds the matched filter's metrics,
        so this is the LLR-input decoder (no modem stage)."""
        key = (n_payload, crc, fec0, fec1)
        if key not in self._dev_fec_cache:
            try:
                dec, _ = packetizer_soft_decoder(n_payload, crc, fec0, fec1)
                self._dev_fec_cache[key] = nn.Sequential(
                    dec, device_packet_finish(n_payload, crc, fec0, fec1)
                ).to(self.device)
            except ValueError:
                self._dev_fec_cache[key] = None
        return self._dev_fec_cache[key]

    def execute(self, x):
        """Consume samples; fire the callback per decoded frame.  Any
        remainder shorter than block_len is buffered for the next call."""
        self._pending = np.concatenate(
            [self._pending, np.asarray(x, np.complex64)])
        results = []
        while len(self._pending) >= self.block_len:
            blk = self._pending[:self.block_len]
            self._pending = self._pending[self.block_len:]
            self._ring = np.concatenate([self._ring, blk])
            self._abs_fed += self.block_len
            out, self._carry = self._proc(
                self._carry, torch.from_numpy(blk.copy()).to(self.device))
            self._collect(out)
            results.extend(self._drain())
            self._trim()
        return results

    def flush(self):
        """Process buffered samples (zero-padded) plus enough zero blocks
        to flush frames still inside the history window."""
        tail = int(np.ceil((STREAM_HIST + self.block_len) / self.block_len))
        pad = (-len(self._pending)) % self.block_len + tail * self.block_len
        out = self.execute(np.zeros(pad, np.complex64))
        out.extend(self._drain(final=True))
        return out

    # ---- internals ----

    def _collect(self, out: DetStreamBlock):
        o = DetStreamBlock(*(t.cpu().numpy() for t in out))
        for p in np.nonzero(o.valid)[0]:
            self._cands.append({
                "n0": int(o.sample_index[p]), "rxy": float(o.rxy[p]),
                "gamma": float(o.gamma[p]), "dphi": float(o.dphi[p]),
                "phi": float(o.phi[p]), "hdr": None})
        self._cands.sort(key=lambda c: c["n0"])

    def _demod_bits(self, c, n_bits: int, soft: bool = False) -> np.ndarray:
        """Demodulate frame bits [0, n_bits) of a candidate from the raw
        ring on the device (soft: the matched filter's metrics)."""
        k, m = self._k, self._m
        n_win = k * (n_bits + 2 * m) + _PAD
        i0 = c["n0"] - self._ring_base
        win = np.zeros(n_win, np.complex64)
        s0, s1 = max(i0, 0), min(i0 + n_win, len(self._ring))
        if s1 > s0:
            win[s0 - i0: s1 - i0] = self._ring[s0:s1]
        dev = self.device
        f32 = torch.float32
        xa = _mix(torch.from_numpy(win).to(dev),
                  torch.tensor(c["dphi"], dtype=f32, device=dev),
                  torch.tensor(c["phi"], dtype=f32, device=dev))
        dem = self._dems[soft]
        bits, _ = dem(dem.init(device=dev), xa)
        return bits[2 * m: 2 * m + n_bits].cpu().numpy()

    def _header_decode(self, c):
        bits = self._demod_bits(c, _N_PRE + self._h_bits)
        h_enc = unscramble_data(pack_bits(
            bits[_N_PRE: _N_PRE + self._h_bits])[: self._h_enc_len])
        hdr, h_ok = packetizer_decode(h_enc, GMSKFRAME_H_USER + 5,
                                      _H_CRC, _H_FEC, "none")
        geom = None
        if h_ok and hdr[GMSKFRAME_H_USER] == _VERSION:
            try:
                geom = _header_geometry(hdr)
            except (ValueError, KeyError):
                h_ok = False
        else:
            h_ok = False
        c["hdr"] = (hdr, h_ok, geom)

    def _drain(self, final: bool = False):
        k, m = self._k, self._m
        res = []
        while self._cands:
            c = self._cands[0]
            if c["n0"] < self._armed_until:       # inside a decoded frame
                self._cands.pop(0)
                continue
            hdr_end = c["n0"] + k * (_N_PRE + self._h_bits + 4 * m) + _PAD
            if hdr_end > self._abs_fed and not final:
                break
            if c["hdr"] is None:
                self._header_decode(c)
            hdr, h_ok, geom = c["hdr"]
            if not h_ok:
                self._cands.pop(0)
                self.num_frames_detected += 1
                self._armed_until = c["n0"] + k * (_N_PRE + self._h_bits)
                frame = (None if hdr is None else hdr[:GMSKFRAME_H_USER],
                         False, None, False, self._stats(c, 0))
                self._emit(frame)
                res.append(frame)
                continue
            n_payload, crc, fec0, fec1, p_enc_len = geom
            total_bits = _N_PRE + self._h_bits + 8 * p_enc_len
            end_abs = c["n0"] + k * (total_bits + 4 * m) + _PAD
            if end_abs > self._abs_fed and not final:
                break                              # wait for more samples
            self._cands.pop(0)
            self.num_frames_detected += 1
            dev = self._device_decoder(n_payload, crc, fec0, fec1)
            if dev is not None:
                # the matched filter's metrics straight into the device
                # block decoder: the payload is not scrambled
                soft = self._demod_bits(c, total_bits, soft=True)
                b, ok = dev(torch.from_numpy(
                    soft[_N_PRE + self._h_bits:]).to(self.device))
                payload = b.cpu().numpy().astype(np.uint8)[:n_payload]
            else:
                bits = self._demod_bits(c, total_bits)
                p_enc = pack_bits(bits[_N_PRE + self._h_bits:])[:p_enc_len]
                payload, ok = packetizer_decode(p_enc, n_payload, crc,
                                                fec0, fec1)
            self._armed_until = c["n0"] + k * total_bits - 8
            frame = (hdr[:GMSKFRAME_H_USER].copy(), True, payload,
                     bool(ok), self._stats(c, n_payload))
            self._emit(frame)
            res.append(frame)
        return res

    def _stats(self, c, n_payload):
        return {"rxy": c["rxy"],
                "rssi_db": float(20 * np.log10(max(c["gamma"], 1e-12))),
                "cfo": c["dphi"], "sample_index": c["n0"],
                "payload_len": n_payload}

    def _emit(self, frame):
        self.frames.append(frame)
        if self.callback is not None:
            self.callback(*frame)

    def _trim(self):
        """Drop ring samples no candidate can still reference."""
        keep_from = self._abs_fed - STREAM_HIST - self.block_len
        if self._cands:
            keep_from = min(keep_from, self._cands[0]["n0"] - _PAD)
        cut = keep_from - self._ring_base
        if cut > 0:
            self._ring = self._ring[cut:]
            self._ring_base += cut


# ---------------------------------------------------------------------------
# the full streaming receiver
# ---------------------------------------------------------------------------


class GMSKStreamBlock(NamedTuple):
    """Full-device fixed-config GMSK RX result per block; the last axis
    before any per-slot data is the candidate slot."""
    valid: torch.Tensor         # [..., P] bool
    sample_index: torch.Tensor  # [..., P] int32
    rxy: torch.Tensor           # [..., P] detection correlation
    hdr_bytes: torch.Tensor     # [..., P, 13] int32 decoded header
    hdr_ok: torch.Tensor        # [..., P] bool CRC + config field check
    pay_bytes: torch.Tensor     # [..., P, payload_len] int32
    pay_ok: torch.Tensor        # [..., P] bool payload CRC


class GMSKRxStream(_DetectBase):
    """Full GMSK receiver for one payload configuration (see
    `gmskframe_rx_stream`)."""

    def __init__(self, block_len, payload_len, crc, fec0, fec1, k, m, bt,
                 threshold, max_frames):
        super().__init__("gmskframe_rx_stream")
        T = int(block_len)
        self.k, self.m = int(k), int(m)
        self.h_bits = 8 * _h_enc_len()
        p_enc_len = packetizer_compute_enc_msg_len(payload_len, crc, fec0,
                                                   fec1)
        self.total_bits = _N_PRE + self.h_bits + 8 * p_enc_len
        self.n_win = self.k * (self.total_bits + 2 * self.m) + _PAD
        self.hist = _check_len(T, max(STREAM_HIST, self.n_win + 64),
                               _DET_NFFT)
        tpl = _template(k, m, bt)
        self._register_detect(tpl, T, int(max_frames),
                              self.k * self.total_bits - 8)
        self.threshold = float(threshold)
        self.hdr_dec, _ = packetizer_soft_decoder(GMSKFRAME_H_USER + 5,
                                                  _H_CRC, "none", _H_FEC)
        self.hdr_fin = device_packet_finish(GMSKFRAME_H_USER + 5, _H_CRC,
                                            "none", _H_FEC)
        try:
            self.pay_dec, _ = packetizer_soft_decoder(payload_len, crc, fec0,
                                                      fec1)
        except ValueError:
            self.pay_dec, _ = conv_packet_soft_decoder(payload_len, crc,
                                                       fec0, fec1)
        self.pay_fin = device_packet_finish(payload_len, crc, fec0, fec1)
        # the header's scrambler as signs on its soft bits
        self._buffer("scr_sign", 1.0 - 2.0 * np.unpackbits(np.resize(
            _MASKS, self.h_bits // 8)).astype(np.float32))
        exp = _wire_fields(payload_len, crc, fec0, fec1)
        self._buffer("exp_idx", np.asarray(sorted(exp), np.int64))
        self._buffer("exp_val", np.asarray([exp[i] for i in sorted(exp)],
                                           np.int32))
        hr = firdes_gmskrx(k, m, bt).astype(np.float32)
        self._buffer("hr", hr / np.sum(np.abs(hr)))  # gmsk_demodulator's
        self._buffer("pre_sign", 2.0 * _preamble_bits().astype(np.float32)
                     - 1.0)
        self._step = batched_apply(self._step_2d, T)

    def soft_metrics(self, carry, x):
        """One block [B, T] of a 2-D stream: (the detections, the frame
        metrics [B, P, total_bits] (positive = bit 1), the new carry)."""
        _, det, new_carry = self._detect(carry, x, front_pad=0,
                                         win_len=self.n_win)
        win = det["win"]                                   # [B, P, 2, n_win]
        xa = _mix(torch.complex(win[..., 0, :], win[..., 1, :]),
                  det["dphi"], det["phi"])
        # the phase derivative and its matched filter over every window;
        # BOTH k=2 decimation phases come from the one filter run: the
        # detector's integer n0 can land a sample early at tau ~ 0.5,
        # which garbles a fixed phase, so each candidate takes the phase
        # whose preamble correlates best with the known sequence
        phi_d = _phase_diff(torch.zeros_like(xa[..., 0]), xa)
        zeros = torch.zeros(phi_d.shape[:-1] + (self.hr.shape[0] - 1,),
                            dtype=torch.float32, device=xa.device)
        d, _ = fir_apply_auto(self.hr, zeros, phi_d)
        k, m = self.k, self.m
        nb2 = self.n_win // k
        ph0, ph1 = d[..., 0::k][..., :nb2], d[..., 1::k][..., :nb2]
        pre = slice(2 * m, 2 * m + _N_PRE)
        s0 = ph0[..., pre] @ self.pre_sign
        s1 = ph1[..., pre] @ self.pre_sign
        soft = torch.where((s1 > s0)[..., None], ph1, ph0)
        return det, soft[..., 2 * m: 2 * m + self.total_bits], new_carry

    def _step_2d(self, carry, x):
        det, soft, new_carry = self.soft_metrics(carry, x)
        h0 = _N_PRE
        llr_h = soft[..., h0:h0 + self.h_bits] * self.scr_sign
        hdr_bytes, h_crc_ok = self.hdr_fin(self.hdr_dec(llr_h))
        hdr_ok = h_crc_ok & (hdr_bytes[..., self.exp_idx] ==
                             self.exp_val).all(dim=-1)
        pay_bytes, pay_ok = self.pay_fin(self.pay_dec(
            soft[..., h0 + self.h_bits:]))
        out = GMSKStreamBlock(
            valid=det["valid"],
            sample_index=carry["base"][:, None] + det["n0"].to(torch.int32),
            rxy=det["peak"], hdr_bytes=hdr_bytes, hdr_ok=hdr_ok,
            pay_bytes=pay_bytes, pay_ok=pay_ok)
        return out, new_carry

    def forward(self, carry, x):
        return self._step(carry, x)


def gmskframe_rx_stream(block_len: int, payload_len: int,
                        crc: str = "crc32", fec0: str = "none",
                        fec1: str = "golay2412",
                        k: int = 2, m: int = 3, bt: float = 0.5,
                        threshold: float = 0.5,
                        max_frames: int = 4) -> GMSKRxStream:
    """FULL streaming GMSK receiver for one payload configuration:
    proc(carry, x[..., block_len]) -> (GMSKStreamBlock, carry').  One
    block step runs detect-everywhere + refine, a window per candidate,
    the carrier mix, the phase derivative and its matched filter (soft
    metrics), the descrambled header decode (hamming128 codebook), the
    payload soft decode (a block code's codebook, `codebook_argmax` for
    golay2412 on the card; a convolutional code's `viterbi_acs`), byte
    pack and CRC; only the caller's use of the frames is host work.
    Frames of other configurations come back ``hdr_ok`` False; arbitrary
    per-frame configurations stay with `GMSKFrameSync`.  block_len must be
    a multiple of 256.  Detections lag the newest input by the frame
    span, so every emitted candidate's window is in the buffer.
    Reference analog: gmskframesync.c:72-113 runs the same stages per
    sample on the CPU."""
    return GMSKRxStream(block_len, payload_len, crc, fec0, fec1, k, m, bt,
                        threshold, max_frames)
