"""Byte-level packet framing: bpacketgen/bpacketsync, binary sync
correlators (bsync, bpresync), and the time-domain detector, as host
numpy (`liquid_dsp_tpu/framing/bpacket.py`).

Reference analogs (studied, not copied):
  * bpacketgen/bpacketsync — src/framing/src/bpacketgen.c:30-290,
    bpacketsync.c: 8-byte p/n sequence from msequence(6), 6-byte header
    (version, crc/fec schemes, length) coded CRC-16 + Hamming(12,8),
    payload coded per packet properties.
  * bsync — src/framing/src/bsync.c: binary correlator against a sync
    word (soft correlation over +-1 bits).
  * bpresync — src/framing/src/bpresync_cccf.c: pre-demod correlator
    over multiple carrier-offset hypotheses.
  * detector_cccf — src/framing/src/detector_cccf.c: time-domain
    cross-correlation burst detector.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from ..fec.packetizer import (packetizer_encode, packetizer_decode,
                              packetizer_compute_enc_msg_len)
from ..fec.block import unpack_bits, pack_bits
from ..utils.sequence import MSequence
from .wire import (crc_to_wire, fec_to_wire, crc_from_wire,
                   fec_from_wire)

__all__ = ["bpacketgen", "bpacketsync", "BPacketResult",
           "bsync_correlate", "bpresync_detect", "detector_cccf_detect"]

_VERSION = 101
_PN_LEN = 8  # bytes


def _pn_bytes() -> np.ndarray:
    ms = MSequence(6)
    bits = np.asarray([ms.advance() for _ in range(8 * _PN_LEN)], np.uint8)
    return pack_bits(bits)


def bpacketgen(payload, crc: str = "crc32", fec0: str = "none",
               fec1: str = "none") -> np.ndarray:
    """Assemble a byte packet: [pn(8) | header(12) | payload_enc]
    (reference bpacketgen_encode)."""
    payload = np.asarray(payload, np.uint8)
    n = len(payload)
    hdr = np.zeros(6, np.uint8)
    # header bytes carry the reference's raw enum values
    # (reference bpacketgen.c assemble_header)
    hdr[0] = _VERSION
    hdr[1] = crc_to_wire(crc)
    hdr[2] = fec_to_wire(fec0)
    hdr[3] = fec_to_wire(fec1)
    hdr[4] = (n >> 8) & 0xFF
    hdr[5] = n & 0xFF
    h_enc = packetizer_encode(hdr, "crc16", "none", "hamming128")
    p_enc = packetizer_encode(payload, crc, fec0, fec1)
    return np.concatenate([_pn_bytes(), h_enc, p_enc])


class BPacketResult(NamedTuple):
    found: bool
    header_ok: bool
    crc_ok: bool
    payload: Optional[np.ndarray]
    bit_offset: int


def bpacketsync(data, max_bit_errors: int = 4) -> BPacketResult:
    """Find and decode a bpacket in a byte stream, searching all bit
    offsets (reference bpacketsync per-bit scan)."""
    bits = unpack_bits(np.asarray(data, np.uint8))
    pn_bits = unpack_bits(_pn_bytes()).astype(np.int8)
    n_pn = len(pn_bits)
    if len(bits) < n_pn:
        return BPacketResult(False, False, False, None, -1)
    # correlate: count mismatches at every offset (vectorized)
    w = np.lib.stride_tricks.sliding_window_view(bits, n_pn)
    errs = np.sum(w != pn_bits[None, :], axis=1)
    cands = np.nonzero(errs <= max_bit_errors)[0]
    h_len = packetizer_compute_enc_msg_len(6, "crc16", "none",
                                           "hamming128")
    for off in cands:
        rest = bits[off + n_pn:]
        if len(rest) < 8 * h_len:
            continue
        h_enc = pack_bits(rest[: 8 * h_len])[:h_len]
        hdr, ok = packetizer_decode(h_enc, 6, "crc16", "none",
                                    "hamming128")
        if not ok or hdr[0] != _VERSION:
            continue
        try:
            crc = crc_from_wire(int(hdr[1]))
            fec0 = fec_from_wire(int(hdr[2]))
            fec1 = fec_from_wire(int(hdr[3]))
        except ValueError:
            continue
        n = (int(hdr[4]) << 8) | int(hdr[5])
        p_len = packetizer_compute_enc_msg_len(n, crc, fec0, fec1)
        p_bits = rest[8 * h_len: 8 * (h_len + p_len)]
        if len(p_bits) < 8 * p_len:
            return BPacketResult(True, True, False, None, int(off))
        p_enc = pack_bits(p_bits)[:p_len]
        payload, pok = packetizer_decode(p_enc, n, crc, fec0, fec1)
        return BPacketResult(True, True, bool(pok), payload, int(off))
    return BPacketResult(False, False, False, None, -1)


def bsync_correlate(bits, sync_word) -> np.ndarray:
    """Soft correlation of a +-1-mapped bit stream against a sync word at
    every offset (reference bsync_rrrf semantics)."""
    b = 2.0 * np.asarray(bits, np.float32) - 1.0
    s = 2.0 * np.asarray(sync_word, np.float32) - 1.0
    if len(b) < len(s):
        return np.zeros(0, np.float32)
    w = np.lib.stride_tricks.sliding_window_view(b, len(s))
    return (w @ s) / len(s)


def bpresync_detect(x, template, dphi_range: float = 0.02,
                    n_dphi: int = 5, threshold: float = 0.6):
    """Pre-demod correlator over multiple carrier-offset hypotheses
    (reference bpresync_cccf).  Returns (found, index, dphi, rxy)."""
    x = np.asarray(x, np.complex64)
    s = np.asarray(template, np.complex64)
    n = len(s)
    e_s = np.sqrt(np.sum(np.abs(s) ** 2))
    best = (0.0, -1, 0.0)
    t = np.arange(n)
    for dphi in np.linspace(-dphi_range, dphi_range, n_dphi):
        sd = s * np.exp(1j * dphi * t)
        c = np.correlate(x, sd, mode="valid")
        w = np.lib.stride_tricks.sliding_window_view(np.abs(x) ** 2, n)
        e_x = np.sqrt(np.maximum(w.sum(axis=1), 1e-12))
        rxy = np.abs(c) / (e_x * e_s)
        i = int(np.argmax(rxy))
        if rxy[i] > best[0]:
            best = (float(rxy[i]), i, float(dphi))
    found = best[0] > threshold
    return found, best[1], best[2], best[0]


def detector_cccf_detect(x, template, threshold: float = 0.6):
    """Time-domain cross-correlation burst detector (reference
    detector_cccf.c).  Returns (found, index, rxy)."""
    found, idx, _, rxy = bpresync_detect(x, template, dphi_range=0.0,
                                         n_dphi=1, threshold=threshold)
    return found, idx, rxy
