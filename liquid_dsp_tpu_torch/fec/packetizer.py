"""Packetizer: CRC + two FEC stages + interleaving, byte-exact with the
reference pipeline, as host numpy (`liquid_dsp_tpu/fec/packetizer.py`).

Reference analog: src/fec/src/packetizer.c:39-80 (lengths),
packetizer_encode: msg -> append CRC -> fec0 encode -> interleave ->
fec1 encode -> interleave; decode runs the plan in reverse.  The
interleaver depth is 0 (pass-through) for a 'none' stage
(packetizer.c:132-133).  Every scheme of the FEC dispatch
(fec/dispatch.py) may fill either stage.
"""
from __future__ import annotations

import numpy as np

from . import dispatch as _fec
from .block import pack_bits
from .crc import crc_generate_key, crc_sizeof_key, crc_validate_message
from .interleave import deinterleave, deinterleave_soft, interleave

__all__ = ["packetizer_compute_enc_msg_len", "packetizer_compute_dec_msg_len",
           "packetizer_encode", "packetizer_decode",
           "packetizer_decode_soft", "pack_bits_arr"]


def _plan(msg_len: int, crc: str, fec0: str, fec1: str):
    k = msg_len + crc_sizeof_key(crc)
    stages = []
    n0 = k
    for fs in (fec0, fec1):
        enc_len = _fec.fec_get_enc_msg_length(fs, n0)
        stages.append((fs, n0, enc_len, 0 if fs == "none" else 4))
        n0 = enc_len
    return k, stages


def packetizer_compute_enc_msg_len(msg_len: int, crc: str,
                                   fec0: str, fec1: str) -> int:
    return _plan(msg_len, crc, fec0, fec1)[1][-1][2]


def packetizer_compute_dec_msg_len(enc_len: int, crc: str,
                                   fec0: str, fec1: str) -> int:
    """Largest msg_len whose encoded length fits enc_len
    (reference packetizer.c:58-80)."""
    n_hat = 0
    while packetizer_compute_enc_msg_len(n_hat, crc, fec0, fec1) < enc_len:
        n_hat += 1
    return n_hat


def _check_crc(buf, msg_len: int, crc: str):
    msg = buf[:msg_len]
    key = 0
    for b in buf[msg_len: msg_len + crc_sizeof_key(crc)].tolist():
        key = (key << 8) | int(b)
    return msg, crc_validate_message(crc, msg, key)


def packetizer_encode(msg, crc: str = "crc32", fec0: str = "none",
                      fec1: str = "none") -> np.ndarray:
    msg = np.asarray(msg, np.uint8)
    _, stages = _plan(len(msg), crc, fec0, fec1)
    key = crc_generate_key(crc, msg)
    nk = crc_sizeof_key(crc)
    buf = np.concatenate([msg, np.asarray(
        [(key >> (8 * (nk - 1 - i))) & 0xFF for i in range(nk)], np.uint8)])
    for fs, dec_len, _, depth in stages:
        buf = interleave(_fec.fec_encode(fs, buf[:dec_len]), depth=depth)
    return buf


def packetizer_decode(pkt, msg_len: int, crc: str = "crc32",
                      fec0: str = "none", fec1: str = "none"):
    """Returns (msg, crc_ok)."""
    buf = np.asarray(pkt, np.uint8)
    _, stages = _plan(msg_len, crc, fec0, fec1)
    for fs, dec_len, enc_len, depth in reversed(stages):
        buf = _fec.fec_decode(fs, deinterleave(buf[:enc_len], depth=depth),
                              dec_len)
    return _check_crc(buf, msg_len, crc)


def packetizer_decode_soft(llr_bits, msg_len: int, crc: str = "crc32",
                           fec0: str = "none", fec1: str = "none"):
    """Soft-decision decode: llr_bits is 8*enc_len per-bit metrics
    (positive = bit 1).  The outer stage decodes soft, the inner hard
    (reference packetizer.c:336-390); when the outer stage is 'none' the
    metrics pass through intact and the inner stage decodes soft.
    Returns (msg, crc_ok)."""
    llr_bits = np.asarray(llr_bits, np.float32)
    _, stages = _plan(msg_len, crc, fec0, fec1)
    (fs0, dec0, enc0, depth0), (fs1, dec1, enc1, depth1) = stages
    if len(llr_bits) < 8 * enc1:
        raise ValueError(f"expected {8*enc1} soft bits, got {len(llr_bits)}")
    if fs1 == "none":
        soft = deinterleave_soft(llr_bits[: 8 * enc0], depth=depth0)
        buf = _fec.fec_decode_soft(fs0, soft, dec0)
    else:
        soft = deinterleave_soft(llr_bits[: 8 * enc1], depth=depth1)
        buf = _fec.fec_decode_soft(fs1, soft, dec1)
        buf = _fec.fec_decode(fs0, deinterleave(buf[:enc0], depth=depth0),
                              dec0)
    return _check_crc(buf, msg_len, crc)


def pack_bits_arr(bits) -> np.ndarray:
    """Bits (one per element, MSB first) -> bytes: `block.pack_bits`
    under the JAX package's packetizer name."""
    return pack_bits(bits)
