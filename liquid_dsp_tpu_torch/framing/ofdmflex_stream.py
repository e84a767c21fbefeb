"""Full streaming OFDM flexframe receiver for one payload configuration
(`liquid_dsp_tpu/framing/ofdmflex_stream.py`).

The reference's `ofdmflexframesync` runs its whole pipeline in-stream —
S0 seek, S1 sync, per-symbol EQ, header decode, payload decode, callback
(reference src/framing/src/ofdmflexframesync.c:63-93).  The host-looped
`OFDMFlexFrameSync` keeps that contract for arbitrary per-frame
configurations; this module is the device pipeline for a known payload
configuration (the deployed-link case): every stage from raw samples to
bytes and CRC verdicts runs in one block step, batched over channels:

    samples [B, T]
      -> Schmidl-Cox S0 detect-everywhere (`s0_detect_block`: banded
         matmul window sums, per-chunk local max, in-order suppression)
      -> per-candidate S1 search windows [B, P, 2, W1 + M - 1] (one
         gather, invalid slots zeroed) and the S1 timing search
      -> the S1-aligned windows [B, P, 2, M + body_len] and the batched
         demod: channel EQ, CP-strip FFT, pilot phase/timing tracking
      -> header: BPSK max-log LLRs, the static descramble sign mask, the
         deinterleave gather and the Golay codebook (`codebook_argmax`)
      -> payload: the modem's max-log LLRs and the same block-FEC decode
         (`codebook_argmax` for golay2412)
      -> byte pack + CRC + the header's config fields, on the device
         (`fec.device.device_packet_finish`).

Only the user callback stays on the host (`OFDMFlexStreamRX`).

The header is 14 bytes coded crc32 + Golay(24,12), scrambled, BPSK
(reference ofdmflexframegen.c:495-523).  Its packetizer configuration
(crc32, fec0=golay2412, fec1=none) produces byte-identical output to
(crc32, none, golay2412) — both reduce to interleave4(golay(buf)) — so
the device block-FEC decoder applies to the header too; the scramble is
a fixed bit mask, i.e. a static +-1 sign flip in the LLR domain.

The carry is the JAX package's: ``buf`` [..., hist] complex64, ``base``
and ``last_end`` int32, so a stream can change package mid-way
(`convert.carry_from_numpy`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import Proc, entry_device
from ..fec.device import (device_packet_finish, packetizer_soft_decoder,
                          qpacket_soft_decoder)
from ..fec.packetizer import packetizer_compute_enc_msg_len
from ..modem.linear import bits_per_symbol, constellation, demodulate_soft
from ..multichannel.ofdm import (OFDMParams, DemodConsts, ofdm_params,
                                 ofdm_demod_consts, ofdm_s1_search,
                                 ofdm_demod_body, s0_detect_block)
from ..utils.random import _MASKS
from .ofdmflexframe import (OFDMFLEXFRAME_H_USER, _H_CRC, _H_FEC,
                            _header_fields)
from .stream_rx import _advance_watermark, batched_apply

__all__ = ["ofdmflex_rx_stream", "OFDMFlexStreamBlock", "OFDMFlexStreamRX"]

_CH = 256                     # detection chunk size (must divide block)


class OFDMFlexStreamBlock(NamedTuple):
    """Per-block batched full-RX result; the last axis before any
    per-slot data is the candidate slot."""
    valid: torch.Tensor         # [..., P] bool
    sample_index: torch.Tensor  # [..., P] int32, absolute stream index
    rxy: torch.Tensor           # [..., P] S0 plateau metric
    cfo: torch.Tensor           # [..., P] refined CFO, rad/sample
    evm_db: torch.Tensor        # [..., P] pilot-referenced EVM
    hdr_msgs: torch.Tensor      # [..., P, ncw_h] int32 Golay message idx
    pay_msgs: torch.Tensor      # [..., P, ncw_p] int32 FEC message idx
    hdr_bytes: torch.Tensor     # [..., P, hdr_len] int32 decoded header
    hdr_ok: torch.Tensor        # [..., P] bool CRC + expected-config check
    pay_bytes: torch.Tensor     # [..., P, payload_len] int32
    pay_ok: torch.Tensor        # [..., P] bool payload CRC


def _geometry(params: OFDMParams, payload_len: int, crc: str, fec0: str,
              fec1: str, ms: str):
    h_enc_len = packetizer_compute_enc_msg_len(
        OFDMFLEXFRAME_H_USER + 6, _H_CRC, _H_FEC, "none")
    h_syms_n = 8 * h_enc_len
    p_enc_len = packetizer_compute_enc_msg_len(payload_len, crc, fec0, fec1)
    bps = bits_per_symbol(ms)
    p_syms = -(-(8 * p_enc_len) // bps)
    nh = -(-h_syms_n // params.M_data)
    npd = -(-p_syms // params.M_data)
    return h_enc_len, h_syms_n, p_syms, nh, npd


def _cut(planes, start, valid, n: int):
    """Windows [B, P, 2, n] of planes [B, 2, L] from start [B, P]; slots
    that are not valid come back zero (the JAX package's fori_loop fills
    only the valid ones).  The caller's padding keeps every start + n
    within L."""
    B, P = start.shape
    idx = (start[..., None] + torch.arange(n, device=planes.device))
    win = torch.gather(planes, 2, idx.reshape(B, 1, P * n).expand(B, 2, P * n))
    win = win.reshape(B, 2, P, n).permute(0, 2, 1, 3)
    return torch.where(valid[..., None, None], win,
                       torch.zeros((), device=planes.device))


class OFDMFlexRxStream(Proc):
    """Full OFDM flexframe receiver (see `ofdmflex_rx_stream`)."""

    def __init__(self, block_len, payload_len, crc, fec0, fec1, ms,
                 params, threshold, max_frames):
        super().__init__("ofdmflex_rx_stream")
        T = int(block_len)
        if T % _CH != 0:
            raise ValueError(f"block_len must be a multiple of {_CH}")
        self.T, self.P = T, int(max_frames)
        self.M = params.M
        self.threshold = float(threshold)
        h_enc_len, self.h_syms_n, self.p_syms, self.nh, self.npd = _geometry(
            params, payload_len, crc, fec0, fec1, ms)
        n_syms = self.nh + self.npd
        dc = ofdm_demod_consts(params, n_syms)
        self.dc = DemodConsts(dc)
        self.WA = dc["W1"] + params.M - 1
        self.WB = params.M + dc["body_len"]
        self.span = (3 + n_syms) * (params.M + params.cp_len)  # frame length
        self.hist = -(-dc["WIN"] // _CH) * _CH        # lookahead >= WIN
        self.n_chunk = (self.hist + T - params.M) // _CH
        # a candidate starts at pos < T; its windows end before
        # T - 1 + WIN, which the end pad brings inside the buffer
        self.need_end = max(0, (T - 1 + dc["WIN"]) - (self.hist + T))
        self.Md = params.M_data
        # header: BPSK LLR -> static descramble sign -> the packetizer's
        # block decoder (deinterleave gather + Golay codebook argmax);
        # the scramble XOR is a sign flip of the LLR (positive = bit 1)
        self.hdr_dec, _ = packetizer_soft_decoder(
            OFDMFLEXFRAME_H_USER + 6, _H_CRC, "none", _H_FEC)
        scr_bits = np.unpackbits(np.resize(_MASKS, h_enc_len))
        self.register_buffer("scr_sign", torch.from_numpy(
            (1.0 - 2.0 * scr_bits).astype(np.float32)))
        self.register_buffer("bpsk", torch.from_numpy(
            np.asarray(constellation("bpsk"), np.complex64)))
        self.pay_dec, _ = qpacket_soft_decoder(payload_len, crc, fec0, fec1,
                                               ms)
        self.hdr_fin = device_packet_finish(OFDMFLEXFRAME_H_USER + 6, _H_CRC,
                                            "none", _H_FEC)
        self.pay_fin = device_packet_finish(payload_len, crc, fec0, fec1)
        # the deployed-link receiver accepts only headers announcing ITS
        # config: a static compare of 6 header byte positions
        exp = _header_fields(payload_len, crc, fec0, fec1, ms)
        self.register_buffer("exp_idx", torch.tensor(sorted(exp)))
        self.register_buffer("exp_val", torch.tensor(
            [exp[i] for i in sorted(exp)], dtype=torch.int32))
        self._step = batched_apply(self._step_2d, T)

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        batch_shape = tuple(batch_shape)
        return {"buf": torch.zeros(batch_shape + (self.hist,),
                                   dtype=torch.complex64, device=device),
                "base": torch.full(batch_shape, -self.hist,
                                   dtype=torch.int32, device=device),
                "last_end": torch.full(batch_shape, -(1 << 30),
                                       dtype=torch.int32, device=device)}

    def forward(self, carry, x):
        return self._step(carry, x)

    def detect_demod(self, carry, x):
        """The detection and demodulation half of a step on [B, T]:
        (buf, det tuple of `s0_detect_block`, best [B, P] the S1 offset
        from the plateau index, data [B, P, n_syms, M_data], perr,
        cfo_out)."""
        buf = torch.cat([carry["buf"], x.to(torch.complex64)], dim=-1)
        det = s0_detect_block(buf, carry["last_end"], self.M,
                              self.threshold, self.span, self.T,
                              self.n_chunk, self.P, _CH)
        valid, d0, cfo0 = det[:3]
        planes = F.pad(torch.stack([buf.real, buf.imag], dim=1),
                       (0, self.need_end))
        wa = _cut(planes, d0, valid, self.WA)
        best = ofdm_s1_search(self.dc, wa, cfo0)                # [B, P]
        wb = _cut(planes, d0 + best, valid, self.WB)
        data, perr, cfo_out = ofdm_demod_body(self.dc, wb, cfo0, best)
        return buf, det, best, data, perr, cfo_out

    def header_llr(self, data):
        """The header's descrambled BPSK LLRs [..., h_syms_n]."""
        lead = data.shape[:-2]
        h = data[..., :self.nh, :].reshape(lead + (self.nh * self.Md,))
        llr = demodulate_soft(self.bpsk, h[..., :self.h_syms_n])[..., 0]
        return llr * self.scr_sign

    def payload_syms(self, data):
        """The payload's equalized symbols [..., p_syms]."""
        lead = data.shape[:-2]
        p = data[..., self.nh:, :].reshape(lead + (self.npd * self.Md,))
        return p[..., :self.p_syms]

    def _step_2d(self, carry, x):
        buf, det, _, data, perr, cfo_out = self.detect_demod(carry, x)
        valid, d0, _, peak, cand, pos, _ = det
        evm_db = 20.0 * torch.log10(torch.sqrt(
            torch.mean(perr.abs() ** 2, dim=(-2, -1))) + 1e-12)
        hdr_msgs = self.hdr_dec(self.header_llr(data))        # [B, P, ncw]
        pay_msgs = self.pay_dec(self.payload_syms(data))
        hdr_bytes, h_crc_ok = self.hdr_fin(hdr_msgs)
        hdr_ok = h_crc_ok & (hdr_bytes[..., self.exp_idx] ==
                             self.exp_val).all(dim=-1)
        pay_bytes, pay_ok = self.pay_fin(pay_msgs)
        out = OFDMFlexStreamBlock(
            valid=valid,
            sample_index=carry["base"][:, None] + d0.to(torch.int32),
            rxy=peak, cfo=cfo_out, evm_db=evm_db,
            hdr_msgs=hdr_msgs, pay_msgs=pay_msgs,
            hdr_bytes=hdr_bytes, hdr_ok=hdr_ok,
            pay_bytes=pay_bytes, pay_ok=pay_ok)
        new_carry = {"buf": buf[..., self.T:].contiguous(),
                     "base": carry["base"] + self.T,
                     "last_end": _advance_watermark(
                         carry["last_end"], {"cand": cand, "n0_seg": pos},
                         self.span, self.T)}
        return out, new_carry


def ofdmflex_rx_stream(block_len: int, payload_len: int,
                       crc: str = "crc32", fec0: str = "none",
                       fec1: str = "golay2412", ms: str = "qpsk",
                       M: int = 64, cp_len: int = 16,
                       params: OFDMParams | None = None,
                       threshold: float = 0.7,
                       max_frames: int = 4) -> OFDMFlexRxStream:
    """Full streaming OFDM flexframe receiver for one payload
    configuration (an outer block code with inner 'none').
    proc(carry, x[..., block_len]) -> (OFDMFlexStreamBlock, carry').
    Runs where ``.to(device)`` puts it; use OFDMFlexStreamRX for the
    callback contract."""
    if params is None:
        params = ofdm_params(M, cp_len)
    return OFDMFlexRxStream(block_len, payload_len, crc, fec0, fec1, ms,
                            params, threshold, max_frames)


class OFDMFlexStreamRX:
    """Host wrapper: feeds blocks through the device pipeline and reports
    each valid slot with the reference callback contract (header,
    header_ok, payload, payload_ok, stats).  Fixed payload configuration;
    frames whose decoded header disagrees with it are reported
    header_ok=False (the deployed-link receiver semantics).

    device: where the pipeline runs (the card unless given; without one a
    CUDA device raises)."""

    def __init__(self, payload_len: int, callback=None, crc: str = "crc32",
                 fec0: str = "none", fec1: str = "golay2412",
                 ms: str = "qpsk", M: int = 64, cp_len: int = 16,
                 params: OFDMParams | None = None, block_len: int = 4096,
                 threshold: float = 0.7, max_frames: int = 4,
                 device="cuda"):
        self.callback = callback
        self.device = entry_device(device)
        self.cfg = (payload_len, crc, fec0, fec1, ms)
        self.params = params if params is not None else ofdm_params(M, cp_len)
        self.block_len = int(block_len)
        self._proc = ofdmflex_rx_stream(
            block_len, payload_len, crc, fec0, fec1, ms,
            params=self.params, threshold=threshold,
            max_frames=max_frames).to(self.device)
        self._carry = self._proc.init(device=self.device)
        self._pending = np.zeros(0, np.complex64)
        self.frames: list = []
        self.num_frames_detected = 0

    def execute(self, x):
        self._pending = np.concatenate(
            [self._pending, np.asarray(x, np.complex64)])
        results = []
        while len(self._pending) >= self.block_len:
            blk = self._pending[:self.block_len]
            self._pending = self._pending[self.block_len:]
            out, self._carry = self._proc(
                self._carry, torch.from_numpy(blk.copy()).to(self.device))
            results.extend(self._finish(out))
        return results

    def flush(self):
        # enough zeros that any in-flight frame's full window is fed
        hist = self._proc.hist
        pad = (-len(self._pending)) % self.block_len + \
            -(-(hist + self.block_len) // self.block_len) * self.block_len
        return self.execute(np.zeros(pad, np.complex64))

    def _finish(self, out):
        # every decode product (bytes, CRC, header config check) came
        # from the device; the host only formats frames and fires
        # callbacks, one transfer per array
        o = OFDMFlexStreamBlock(*(t.cpu().numpy() for t in out))
        res = []
        for p in np.nonzero(o.valid)[0]:
            self.num_frames_detected += 1
            header = o.hdr_bytes[p, :OFDMFLEXFRAME_H_USER].astype(np.uint8)
            stats = {"rxy": float(o.rxy[p]), "cfo": float(o.cfo[p]),
                     "evm_db": float(o.evm_db[p]),
                     "sample_index": int(o.sample_index[p]),
                     "payload_len": self.cfg[0], "ms": self.cfg[4]}
            if not o.hdr_ok[p]:
                frame = (header, False, None, False, stats)
            else:
                frame = (header, True, o.pay_bytes[p].astype(np.uint8),
                         bool(o.pay_ok[p]), stats)
            self.frames.append(frame)
            if self.callback is not None:
                self.callback(*frame)
            res.append(frame)
        return res
