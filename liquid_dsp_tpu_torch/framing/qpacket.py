"""qpacketmodem (bytes <-> modulated symbols) and qpilotgen / qpilotsync
(pilot insertion / carrier recovery), `liquid_dsp_tpu/framing/qpacket.py`.

Reference analogs: src/framing/src/qpacketmodem.c:38-300 (packetizer ->
MSB-first bits -> modem symbols), qpilotgen.c:40-140 (a pilot every
`spacing` symbols, QPSK points from a default m-sequence),
qpilotsync.c:104-243 (FFT of the pilot-derotated sequence -> quadratic
peak -> carrier frequency, phase and gain).  The host math is numpy; the
modulation and demodulation are the port's torch modem, run on the CPU
for numpy input.
"""
from __future__ import annotations

import numpy as np
import torch

from ..fec.block import pack_bits, unpack_bits
from ..fec.packetizer import (packetizer_compute_enc_msg_len,
                              packetizer_decode, packetizer_decode_soft,
                              packetizer_encode)
from ..modem.linear import (bits_per_symbol, constellation, demodulate,
                            demodulate_soft, modulate)
from ..utils.sequence import MSequence

__all__ = ["qpacketmodem_frame_len", "qpacketmodem_encode",
           "qpacketmodem_decode", "qpacketmodem_decode_soft",
           "qpilot_pilots", "qpilot_frame_len", "qpilotgen", "qpilotsync"]


def _tensor(symbols) -> torch.Tensor:
    return (symbols if torch.is_tensor(symbols)
            else torch.from_numpy(np.ascontiguousarray(symbols, np.complex64)))


def qpacketmodem_frame_len(payload_len: int, crc: str, fec0: str,
                           fec1: str, ms: str) -> int:
    """Number of modulated symbols for a payload (reference
    qpacketmodem.c:144-160)."""
    enc_len = packetizer_compute_enc_msg_len(payload_len, crc, fec0, fec1)
    return -(-(8 * enc_len) // bits_per_symbol(ms))


def qpacketmodem_encode(payload, crc: str = "crc24", fec0: str = "none",
                        fec1: str = "golay2412", ms: str = "qpsk"):
    """bytes -> complex64 symbols, a CPU tensor (reference
    qpacketmodem_encode)."""
    enc = packetizer_encode(np.asarray(payload, np.uint8), crc, fec0, fec1)
    bps = bits_per_symbol(ms)
    bits = unpack_bits(enc)
    nsym = -(-len(bits) // bps)
    bits = np.concatenate([bits, np.zeros(nsym * bps - len(bits), np.uint8)])
    syms = bits.reshape(nsym, bps) @ (1 << np.arange(bps - 1, -1, -1))
    return modulate(constellation(ms), torch.from_numpy(syms))


def qpacketmodem_decode_soft(symbols, payload_len: int, crc: str = "crc24",
                             fec0: str = "none", fec1: str = "golay2412",
                             ms: str = "qpsk"):
    """Soft-decision decode: the modem's exact max-log LLRs feed the
    packetizer's soft path (reference qpacketmodem_decode_soft,
    qpacketmodem.c:297-316).  Returns (payload bytes, crc_ok)."""
    llrs = demodulate_soft(constellation(ms), _tensor(symbols))
    bits = llrs.reshape(-1).cpu().numpy()
    need = 8 * packetizer_compute_enc_msg_len(payload_len, crc, fec0, fec1)
    if len(bits) < need:
        bits = np.concatenate([bits, np.zeros(need - len(bits), np.float32)])
    return packetizer_decode_soft(bits[:need], payload_len, crc, fec0, fec1)


def qpacketmodem_decode(symbols, payload_len: int, crc: str = "crc24",
                        fec0: str = "none", fec1: str = "golay2412",
                        ms: str = "qpsk"):
    """complex symbols -> (payload bytes, crc_ok) by hard decisions
    (reference qpacketmodem_decode)."""
    bps = bits_per_symbol(ms)
    s = demodulate(constellation(ms), _tensor(symbols)).cpu().numpy()
    bits = ((s[:, None] >> np.arange(bps - 1, -1, -1)) & 1).astype(np.uint8)
    enc_len = packetizer_compute_enc_msg_len(payload_len, crc, fec0, fec1)
    enc = pack_bits(bits.reshape(-1))[:enc_len]
    return packetizer_decode(enc, payload_len, crc, fec0, fec1)


def _num_pilots(payload_len: int, spacing: int) -> int:
    q, r = divmod(payload_len, spacing - 1)
    return q + (1 if r else 0)


def qpilot_frame_len(payload_len: int, spacing: int) -> int:
    return payload_len + _num_pilots(payload_len, spacing)


def qpilot_pilots(payload_len: int, spacing: int) -> np.ndarray:
    """Pilot sequence: QPSK points from the default m-sequence of order
    nextpow2(num_pilots) (reference qpilotgen.c:96-112)."""
    npil = _num_pilots(payload_len, spacing)
    seq = MSequence(max(2, int(np.ceil(np.log2(npil)))))
    s = np.asarray([seq.generate_symbol(2) for _ in range(npil)])
    return np.exp(1j * (2 * np.pi * s / 4.0 + np.pi / 4.0)
                  ).astype(np.complex64)


def qpilotgen(payload_syms, spacing: int = 21):
    """Insert pilots every `spacing` symbols (reference qpilotgen_execute)."""
    payload_syms = np.asarray(payload_syms)
    n = len(payload_syms)
    pilots = qpilot_pilots(n, spacing)
    out = np.zeros(n + len(pilots), np.complex64)
    mask = np.arange(len(out)) % spacing == 0
    out[mask] = pilots
    out[~mask] = payload_syms
    return out


def qpilotsync(frame_syms, payload_len: int, spacing: int = 21):
    """Estimate and remove carrier offset / phase / gain from the pilots;
    returns (payload_syms, dphi_hat, phi_hat, gain_hat)
    (reference qpilotsync_execute:175-243)."""
    frame_syms = np.asarray(frame_syms)
    frame_len = len(frame_syms)
    pilots = qpilot_pilots(payload_len, spacing)
    npil = len(pilots)
    mask = np.arange(frame_len) % spacing == 0
    v = frame_syms[mask][:npil] * np.conj(pilots)
    nfft = 1 << int(np.ceil(np.log2(npil + (npil >> 1))))
    mag = np.abs(np.fft.fft(v, nfft))
    i0 = int(np.argmax(mag))
    y0, ypos, yneg = mag[i0], mag[(i0 + 1) % nfft], mag[(i0 - 1) % nfft]
    a = 0.5 * (ypos + yneg) - y0
    b = 0.5 * (ypos - yneg)
    index = i0 + (-b / (2 * a) if a != 0 else 0.0)
    if i0 > nfft / 2:
        index -= nfft
    dphi_hat = index * 2 * np.pi / (nfft * spacing)
    # phase and gain: de-rotate the pilots and average (reference METHOD 2)
    metric = np.sum(v * np.exp(-1j * dphi_hat * np.arange(npil) * spacing))
    phi_hat = float(np.angle(metric))
    g_hat = float(np.abs(metric)) / npil
    corr = np.exp(-1j * (dphi_hat * np.arange(frame_len) + phi_hat)) / g_hat
    payload = (frame_syms * corr)[~mask][:payload_len]
    return payload.astype(np.complex64), float(dphi_hat), phi_hat, g_hat
