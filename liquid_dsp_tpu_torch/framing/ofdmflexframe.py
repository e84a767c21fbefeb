"""ofdmflexframegen / ofdmflexframesync: OFDM frames with per-frame
runtime modulation and FEC, signalled in a protected header
(`liquid_dsp_tpu/framing/ofdmflexframe.py`).

Reference analogs (studied, not copied): src/framing/src/
ofdmflexframegen.c:108-560 and ofdmflexframesync.c — S0/S0/S1 OFDM
preamble, 14-byte header (8 user + protocol/length/mod/fec,
:495-523) coded CRC-32 + Golay(24,12) on BPSK (36 encoded bytes = 288
header symbols, liquid.internal.h:1153-1163), scrambled; payload coded
per runtime properties and mapped onto the data subcarriers.

The generator is host numpy.  The receivers:
  * `ofdmflexframesync`, one frame from one capture (`ofdm_frame_sync`
    on the given device, the byte decode on the host);
  * `OFDMFlexFrameSync`, the streaming callback receiver for arbitrary
    per-frame configurations: the S0 detector Proc runs per block on the
    device, each candidate's OFDM symbols are demodulated there from a
    raw-sample window (`frame_demod_core`, header geometry first, then
    the payload bucketed to the next power of two of OFDM symbols), the
    header decodes on the host, and a payload config with a device
    decoder (an outer block code with inner 'none': `codebook_argmax`
    for golay2412; one convolutional stage up to K = 9: `viterbi_acs`)
    decodes on the device, soft; others on the host by hard decisions.
Both take host arrays and run on the card unless ``device="cpu"``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import entry_device
from ..fec.block import pack_bits, unpack_bits
from ..fec.packetizer import (packetizer_compute_enc_msg_len,
                              packetizer_decode, packetizer_encode)
from ..modem.linear import bits_per_symbol, constellation, demodulate
from ..multichannel.ofdm import (OFDMParams, frame_demod_core,
                                 ofdm_detector_stream, ofdm_frame_sync,
                                 ofdm_generate_frame, ofdm_params)
from ..utils.random import scramble_data, unscramble_data
from .wire import (crc_from_wire, crc_to_wire, fec_from_wire, fec_to_wire,
                   modem_from_wire, modem_to_wire)

__all__ = ["ofdmflexframegen", "ofdmflexframesync", "OFDMFlexResult",
           "OFDMFlexFrameSync", "OFDMFLEXFRAME_H_USER"]

OFDMFLEXFRAME_H_USER = 8
_H_CRC, _H_FEC = "crc32", "golay2412"
_H_MOD = "bpsk"
_PROTOCOL = 104


def _syms_from_bytes(data: np.ndarray, ms: str) -> np.ndarray:
    bps = bits_per_symbol(ms)
    bits = unpack_bits(data)
    nsym = -(-len(bits) // bps)
    bits = np.concatenate([bits, np.zeros(nsym * bps - len(bits),
                                          np.uint8)])
    idx = bits.reshape(nsym, bps) @ (1 << np.arange(bps - 1, -1, -1))
    return np.asarray(constellation(ms), np.complex64)[idx]


def _bytes_from_syms(syms: np.ndarray, ms: str, n_bytes: int) -> np.ndarray:
    bps = bits_per_symbol(ms)
    s = demodulate(constellation(ms), torch.from_numpy(
        np.ascontiguousarray(syms, np.complex64))).numpy()
    bits = ((s[:, None] >> np.arange(bps - 1, -1, -1)) & 1).astype(np.uint8)
    return pack_bits(bits.reshape(-1))[:n_bytes]


def _frame_geometry(params: OFDMParams, payload_len: int, crc, fec0, fec1,
                    ms):
    """Header and payload each occupy whole OFDM symbols (reference
    ofdmflexframegen.c:192-194, :489-492); unused data slots in the last
    symbol of each block are pad."""
    h_enc_len = packetizer_compute_enc_msg_len(
        OFDMFLEXFRAME_H_USER + 6, _H_CRC, _H_FEC, "none")
    h_syms = 8 * h_enc_len  # BPSK
    p_enc_len = packetizer_compute_enc_msg_len(payload_len, crc, fec0, fec1)
    bps = bits_per_symbol(ms)
    p_syms = -(-(8 * p_enc_len) // bps)
    nh = -(-h_syms // params.M_data)
    np_ = -(-p_syms // params.M_data)
    return h_syms, p_syms, nh, np_


def _header_fields(payload_len: int, crc: str, fec0: str, fec1: str,
                   ms: str) -> dict:
    """The wire header's control bytes (ofdmflexframegen.c:496-523) by
    position: protocol, 16-bit length, mod scheme enum,
    crc(3b)<<5|fec0(5b), fec1(5b)."""
    k = OFDMFLEXFRAME_H_USER
    return {k + 0: _PROTOCOL,
            k + 1: (payload_len >> 8) & 0xFF,
            k + 2: payload_len & 0xFF,
            k + 3: modem_to_wire(ms),
            k + 4: ((crc_to_wire(crc) & 0x07) << 5) |
                   (fec_to_wire(fec0) & 0x1F),
            k + 5: fec_to_wire(fec1) & 0x1F}


def ofdmflexframegen(header, payload, M: int = 64, cp_len: int = 16,
                     crc: str = "crc32", fec0: str = "none",
                     fec1: str = "golay2412", ms: str = "qpsk",
                     params: OFDMParams | None = None) -> np.ndarray:
    """Assemble an OFDM flexframe; returns complex64 time samples."""
    if params is None:
        params = ofdm_params(M, cp_len)
    return ofdm_generate_frame(params, _frame_grid(header, payload, params,
                                                   crc, fec0, fec1, ms))


def _frame_grid(header, payload, params: OFDMParams, crc: str = "crc32",
                fec0: str = "none", fec1: str = "golay2412",
                ms: str = "qpsk") -> np.ndarray:
    """The frame's data-subcarrier grid [nh + npd, M_data]: the coded,
    scrambled header on BPSK, then the coded payload, each block padded
    to whole OFDM symbols (what `ofdm_generate_frame` modulates)."""
    header = np.asarray(header, np.uint8)
    payload = np.asarray(payload, np.uint8)
    if header.shape != (OFDMFLEXFRAME_H_USER,):
        raise ValueError(f"ofdmflexframe header must be "
                         f"{OFDMFLEXFRAME_H_USER} bytes")
    hdr = np.zeros(OFDMFLEXFRAME_H_USER + 6, np.uint8)
    hdr[:OFDMFLEXFRAME_H_USER] = header
    for i, v in _header_fields(len(payload), crc, fec0, fec1, ms).items():
        hdr[i] = v
    # header coded crc32 + golay2412 then scrambled, BPSK on data bins
    h_enc = scramble_data(packetizer_encode(hdr, _H_CRC, _H_FEC, "none"))
    h_syms = _syms_from_bytes(h_enc, _H_MOD)
    p_syms = _syms_from_bytes(packetizer_encode(payload, crc, fec0, fec1),
                              ms)
    # header and payload each fill whole OFDM symbols; pad slots carry
    # zeros here (the reference pads with random modem symbols, which
    # receivers ignore — ofdmflexframegen.c:620-626)
    Md = params.M_data
    nh = -(-len(h_syms) // Md)
    npd = -(-len(p_syms) // Md)
    grid = np.zeros((nh + npd, Md), np.complex64)
    grid.reshape(-1)[: len(h_syms)] = h_syms
    grid[nh:].reshape(-1)[: len(p_syms)] = p_syms
    return grid


class OFDMFlexResult(NamedTuple):
    detected: bool
    header_ok: bool
    crc_ok: bool
    header: Optional[np.ndarray]
    payload: Optional[np.ndarray]
    ms: str
    payload_len: int


def _header_enc_len() -> int:
    return packetizer_compute_enc_msg_len(OFDMFLEXFRAME_H_USER + 6, _H_CRC,
                                          _H_FEC, "none")


def _decode_header(h_stream: np.ndarray):
    """(header bytes, ok, geometry or None) from the header's BPSK
    symbols: hard decisions, descramble, the packetizer's decode, the
    protocol byte and the announced payload config (a wire value with no
    scheme fails the header, as in the reference)."""
    h_enc_len = _header_enc_len()
    h_enc = unscramble_data(_bytes_from_syms(h_stream, _H_MOD, h_enc_len))
    hdr, h_ok = packetizer_decode(h_enc, OFDMFLEXFRAME_H_USER + 6, _H_CRC,
                                  _H_FEC, "none")
    k = OFDMFLEXFRAME_H_USER
    if not h_ok or hdr[k] != _PROTOCOL:
        return hdr, False, None
    n_payload = (int(hdr[k + 1]) << 8) | int(hdr[k + 2])
    try:
        ms = modem_from_wire(int(hdr[k + 3]))
        crc = crc_from_wire((int(hdr[k + 4]) >> 5) & 0x07)
        fec0 = fec_from_wire(int(hdr[k + 4]) & 0x1F)
        fec1 = fec_from_wire(int(hdr[k + 5]) & 0x1F)
    except (ValueError, KeyError):
        return hdr, False, None
    return hdr, True, (n_payload, ms, crc, fec0, fec1)


def ofdmflexframesync(x, M: int = 64, cp_len: int = 16,
                      params: OFDMParams | None = None,
                      threshold: float = 0.7,
                      device="cuda") -> OFDMFlexResult:
    """Recover an OFDM flexframe from a capture: `ofdm_frame_sync` on
    ``device`` (the card unless given), first over the header's OFDM
    symbols, then over header + payload; bytes decode on the host."""
    device = entry_device(device)
    if params is None:
        params = ofdm_params(M, cp_len)
    x = np.asarray(x.cpu() if torch.is_tensor(x) else x, np.complex64)
    nores = OFDMFlexResult(False, False, False, None, None, "", 0)
    failed = OFDMFlexResult(True, False, False, None, None, "", 0)
    h_syms_n = 8 * _header_enc_len()
    n_hdr_ofdm = -(-h_syms_n // params.M_data)
    r = ofdm_frame_sync(params, x, n_hdr_ofdm, threshold=threshold,
                        device=device)
    if not r.detected or r.data_syms is None:
        return nores
    hdr, h_ok, cfg = _decode_header(r.data_syms.reshape(-1)[:h_syms_n])
    if not h_ok:
        return failed
    n_payload, ms, crc, fec0, fec1 = cfg
    k = OFDMFLEXFRAME_H_USER
    try:
        # raises for wire-valid but unimplemented schemes (e.g.
        # user-defined 'arb' constellations): a failed header
        _, p_syms, nh, npd = _frame_geometry(params, n_payload, crc, fec0,
                                             fec1, ms)
    except (ValueError, KeyError):
        return failed
    r2 = ofdm_frame_sync(params, x, nh + npd, threshold=threshold,
                         device=device)
    if not r2.detected or r2.data_syms is None:
        return OFDMFlexResult(True, True, False, hdr[:k], None, ms,
                              n_payload)
    # payload starts on a fresh OFDM symbol after the header block
    p_stream = r2.data_syms[nh:].reshape(-1)[:p_syms]
    p_enc_len = packetizer_compute_enc_msg_len(n_payload, crc, fec0, fec1)
    p_enc = _bytes_from_syms(p_stream, ms, p_enc_len)
    payload, ok = packetizer_decode(p_enc, n_payload, crc, fec0, fec1)
    return OFDMFlexResult(True, True, bool(ok), hdr[:k], payload, ms,
                          n_payload)


# ---------------------------------------------------------------------------
# Streaming multi-frame receiver
# ---------------------------------------------------------------------------


class OFDMFlexFrameSync:
    """Streaming multi-frame OFDM flexframe receiver (the reference
    ofdmflexframesync object contract: create/execute/callback).  Feed
    arbitrary-length sample arrays via execute(); the callback fires
    once per decoded frame with (header, header_ok, payload,
    payload_ok, stats).

    device: where the detector, the demodulator and the device payload
    decoders run (the card unless given; without one a CUDA device
    raises)."""

    _PAD = 64

    def __init__(self, callback=None, M: int = 64, cp_len: int = 16,
                 params: OFDMParams | None = None, block_len: int = 4096,
                 threshold: float = 0.7, max_frames: int = 4,
                 device="cuda"):
        self.callback = callback
        self.device = entry_device(device)
        self.params = params if params is not None else ofdm_params(M, cp_len)
        self.block_len = int(block_len)
        self._proc = ofdm_detector_stream(
            self.block_len, self.params, threshold=threshold,
            max_frames=max_frames).to(self.device)
        self._carry = self._proc.init(device=self.device)
        self._h_enc_len = _header_enc_len()
        self._h_syms_n = 8 * self._h_enc_len
        self._nh = -(-self._h_syms_n // self.params.M_data)
        self._pending = np.zeros(0, np.complex64)
        self._ring = np.zeros(0, np.complex64)
        self._ring_base = 0
        self._abs_fed = 0
        self._cands: list = []
        self._armed_until = -(1 << 60)
        self.frames: list = []
        self.num_frames_detected = 0
        self._dev_fec_cache: dict = {}

    def _device_decoder(self, n_payload, crc, fec0, fec1, ms):
        """Cached device soft decoder (device_fn module, host finish) for
        a qualifying payload config: an outer block code with inner
        'none' (codebook correlation), or one conv stage (`viterbi_acs`)
        — fec/device.py; None otherwise."""
        key = (n_payload, crc, fec0, fec1, ms)
        if key not in self._dev_fec_cache:
            from ..fec.device import (qpacket_conv_soft_decoder,
                                      qpacket_soft_decoder)
            self._dev_fec_cache[key] = None
            for builder in (qpacket_soft_decoder,
                            qpacket_conv_soft_decoder):
                try:
                    dfn, fin = builder(n_payload, crc, fec0, fec1, ms)
                except ValueError:
                    continue
                self._dev_fec_cache[key] = (dfn.to(self.device), fin)
                break
        return self._dev_fec_cache[key]

    # -- sample ingestion ----------------------------------------------
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
        tail = int(np.ceil((self._proc.hist + self.block_len)
                           / self.block_len))
        pad = (-len(self._pending)) % self.block_len + tail * self.block_len
        out = self.execute(np.zeros(pad, np.complex64))
        out.extend(self._drain(final=True))
        return out

    # -- internals ------------------------------------------------------
    def _collect(self, out):
        valid, idx, cfo, peak = (t.cpu().numpy() for t in out)
        for p in np.nonzero(valid)[0]:
            self._cands.append({"d0": int(idx[p]), "cfo": float(cfo[p]),
                                "rxy": float(peak[p]), "hdr": None})
        self._cands.sort(key=lambda c: c["d0"])

    def _demod(self, c, n_syms: int):
        """Run the frame demodulator over a raw window at the candidate."""
        fn, win_len = frame_demod_core(self.params, n_syms, self.device)
        i0 = c["d0"] - self._ring_base
        win = np.zeros(win_len, np.complex64)
        s0, s1 = max(i0, 0), min(i0 + win_len, len(self._ring))
        if s1 > s0:
            win[s0 - i0: s1 - i0] = self._ring[s0:s1]
        _, data, perr, cfo_out = fn(
            torch.from_numpy(win).to(self.device),
            torch.tensor(c["cfo"], dtype=torch.float32, device=self.device))
        return data, perr.cpu().numpy(), float(cfo_out)

    def _win_len(self, n_syms: int) -> int:
        return frame_demod_core(self.params, n_syms, self.device)[1]

    def _header_decode(self, c):
        data = self._demod(c, self._nh)[0].cpu().numpy()
        hdr, h_ok, cfg = _decode_header(data.reshape(-1)[: self._h_syms_n])
        geom = None
        if h_ok:
            n_payload, ms, crc, fec0, fec1 = cfg
            try:
                _, p_syms, _, npd = _frame_geometry(
                    self.params, n_payload, crc, fec0, fec1, ms)
                geom = (n_payload, ms, crc, fec0, fec1, p_syms, npd)
            except (ValueError, KeyError):
                h_ok = False
        c["hdr"] = (hdr, h_ok, geom)

    def _drain(self, final: bool = False):
        Msym = self.params.M + self.params.cp_len
        res = []
        while self._cands:
            c = self._cands[0]
            if c["d0"] < self._armed_until:
                self._cands.pop(0)
                continue
            if c["d0"] + self._win_len(self._nh) > self._abs_fed \
                    and not final:
                break
            if c["hdr"] is None:
                self._header_decode(c)
            hdr, h_ok, geom = c["hdr"]
            if not h_ok:
                self._cands.pop(0)
                self.num_frames_detected += 1
                self._armed_until = c["d0"] + (3 + self._nh) * Msym
                frame = (hdr[:OFDMFLEXFRAME_H_USER], False, None, False,
                         self._stats(c, 0, ""))
                self._emit(frame)
                res.append(frame)
                continue
            n_payload, ms, crc, fec0, fec1, p_syms, npd = geom
            # payload bucketed to the next power of two of OFDM symbols
            bucket = self._nh + max(
                1, 1 << int(np.ceil(np.log2(max(npd, 1)))))
            if c["d0"] + self._win_len(bucket) > self._abs_fed and not final:
                break
            self._cands.pop(0)
            self.num_frames_detected += 1
            data, perr, cfo_out = self._demod(c, bucket)
            real = self._nh + npd
            p_stream = data[self._nh: real].reshape(-1)[:p_syms]
            dev = self._device_decoder(n_payload, crc, fec0, fec1, ms)
            if dev is not None:
                # equalized subcarrier symbols straight into the device
                # soft decoder (fec/device.py): LLRs, deinterleave
                # gather, codebook argmax or Viterbi; the host packs the
                # bytes and checks the CRC
                dfn, fin = dev
                payload_full, ok = fin(dfn(p_stream).cpu().numpy())
                payload, ok = payload_full[:n_payload], bool(ok)
            else:
                p_enc_len = packetizer_compute_enc_msg_len(n_payload, crc,
                                                           fec0, fec1)
                p_enc = _bytes_from_syms(p_stream.cpu().numpy(), ms,
                                         p_enc_len)
                payload, ok = packetizer_decode(p_enc, n_payload, crc,
                                                fec0, fec1)
            self._armed_until = c["d0"] + (3 + real) * Msym - 8
            st = self._stats(c, n_payload, ms)
            st["cfo"] = cfo_out
            st["evm_db"] = float(20 * np.log10(np.sqrt(np.mean(
                np.abs(perr[:real]) ** 2)) + 1e-12))
            frame = (hdr[:OFDMFLEXFRAME_H_USER].copy(), True, payload,
                     bool(ok), st)
            self._emit(frame)
            res.append(frame)
        return res

    def _stats(self, c, n_payload, ms):
        return {"rxy": c["rxy"], "cfo": c["cfo"],
                "sample_index": c["d0"], "payload_len": n_payload,
                "ms": ms, "evm_db": 0.0}

    def _emit(self, frame):
        self.frames.append(frame)
        if self.callback is not None:
            self.callback(*frame)

    def _trim(self):
        """Drop ring samples no candidate can still reference."""
        keep_from = self._abs_fed - self._proc.hist - self.block_len
        if self._cands:
            keep_from = min(keep_from, self._cands[0]["d0"] - self._PAD)
        cut = keep_from - self._ring_base
        if cut > 0:
            self._ring = self._ring[cut:]
            self._ring_base += cut
