"""flexframegen / flexframesync: variable-length single-carrier frames
with runtime-configurable payload modulation and FEC
(`liquid_dsp_tpu/framing/flexframe.py`).

Reference analogs: src/framing/src/flexframegen.c:43-400 and
flexframesync.c — the 64-symbol p/n preamble of frame64, a 20-byte
header (14 user bytes + protocol/length/mod/fec control bytes,
flexframegen.c:300-323) coded with CRC-32 + SEC-DED(72,64) +
Hamming(8,4) on QPSK with a pilot every 16 symbols, the payload coded
per its header, ARKAISER k=2 m=7 beta=0.25 pulse shaping.

The transmitter is host numpy.  The receivers:
  * `flexframesync`, one frame from one capture (detector FFTs on the
    given device, the rest on the host);
  * `flexframesync_stream`, the streaming header-stage receiver Proc on
    stream_rx.py's core;
  * `flexframe_rx_stream`, the FULL receiver for one payload
    configuration in one block step: detect, sync, the two-stage header
    decode (`packetizer2_soft_decoder`), the payload decode (soft Golay
    through the `codebook_argmax` kernel for golay2412, a convolutional
    payload through the `viterbi_acs` kernel), byte pack and both CRCs;
    `flexframe_rx_stream_multi` for a registered set;
  * `FlexFrameSync`, the callback wrapper (the reference's
    create/execute/callback object) with header-dependent payload
    geometry resolved on the host.
The Procs run where the caller moves them (``.to(device)``);
`flexframesync` and `FlexFrameSync`, which take host arrays, run on the
card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..core import Proc, entry_device
from ..design.firdes import firdes_arkaiser
from ..fec.device import (device_packet_finish, packetizer2_soft_decoder,
                          qpacket_conv_soft_decoder, qpacket_soft_decoder)
from ..fec.packetizer import packetizer_compute_enc_msg_len
from ..modem.linear import (bits_per_symbol, constellation, demodulate,
                            demodulate_soft, modulate)
from .detector import qdetector_detect
from .frame64 import frame64_preamble, np_interp2
from .qpacket import (qpacketmodem_decode, qpacketmodem_encode,
                      qpacketmodem_frame_len, qpilot_frame_len,
                      qpilot_pilots, qpilotgen, qpilotsync)
from .stream_rx import (STREAM_HIST, StreamRxBlock, StreamRxConfig,
                        mf_symbol_gather, preamble_stream)
from .wire import (crc_from_wire, crc_to_wire, fec_from_wire, fec_to_wire,
                   modem_from_wire, modem_to_wire)

__all__ = ["flexframegen", "flexframesync", "FlexFrameResult",
           "FLEXFRAME_H_USER", "flexframesync_stream", "FlexFrameSync",
           "flexframe_rx_stream", "flexframe_rx_stream_multi",
           "FlexStreamBlock", "FlexMultiStreamBlock"]

_K = 2
_M = 7
_BETA = 0.25
_NPFB = 32
FLEXFRAME_H_USER = 14
_H_CRC, _H_FEC0, _H_FEC1, _H_MOD = "crc32", "secded7264", "hamming84", "qpsk"
_PROTOCOL = 101
_N_LEAD = 64 + 2 * _M          # preamble + filter delay, in symbols


def _header_syms_len():
    n_mod = qpacketmodem_frame_len(FLEXFRAME_H_USER + 6, _H_CRC, _H_FEC0,
                                   _H_FEC1, _H_MOD)
    return qpilot_frame_len(n_mod, 16), n_mod


def _interp_taps():
    return firdes_arkaiser(_K, _M, _BETA).astype(np.float32)


def flexframegen(header, payload, crc: str = "crc32", fec0: str = "none",
                 fec1: str = "golay2412", ms: str = "qpsk") -> np.ndarray:
    """Assemble a frame; returns complex64 samples at 2 samples/symbol."""
    header = np.asarray(header, np.uint8)
    payload = np.asarray(payload, np.uint8)
    if header.shape != (FLEXFRAME_H_USER,):
        raise ValueError(f"flexframe header must be {FLEXFRAME_H_USER} "
                         f"bytes")
    n = len(payload)
    hdr = np.zeros(FLEXFRAME_H_USER + 6, np.uint8)
    hdr[:FLEXFRAME_H_USER] = header
    # reference wire format (flexframegen.c:300-323): protocol byte,
    # 16-bit payload length, then the reference enum values — mod scheme
    # in one byte, CRC(3 bits)<<5|fec0(5 bits), fec1(5 bits)
    hdr[FLEXFRAME_H_USER + 0] = _PROTOCOL
    hdr[FLEXFRAME_H_USER + 1] = (n >> 8) & 0xFF
    hdr[FLEXFRAME_H_USER + 2] = n & 0xFF
    hdr[FLEXFRAME_H_USER + 3] = modem_to_wire(ms)
    hdr[FLEXFRAME_H_USER + 4] = ((crc_to_wire(crc) & 0x07) << 5) | \
        (fec_to_wire(fec0) & 0x1F)
    hdr[FLEXFRAME_H_USER + 5] = fec_to_wire(fec1) & 0x1F

    h_mod = qpacketmodem_encode(hdr, _H_CRC, _H_FEC0, _H_FEC1,
                                _H_MOD).numpy()
    h_sym = qpilotgen(h_mod, 16)
    p_sym = qpacketmodem_encode(payload, crc, fec0, fec1, ms).numpy()
    settle = 2 * _M  # reference tail: 2m zero symbols (flexframegen.c:457)
    stream = np.concatenate([frame64_preamble(), h_sym, p_sym,
                             np.zeros(settle, np.complex64)])
    return np_interp2(stream.astype(np.complex64), _interp_taps())


class FlexFrameResult(NamedTuple):
    detected: bool
    header_ok: bool
    crc_ok: bool
    header: Optional[np.ndarray]
    payload: Optional[np.ndarray]
    ms: str
    payload_len: int
    evm_db: float


@functools.lru_cache(maxsize=1)
def _detector_template() -> np.ndarray:
    seq = np.concatenate([frame64_preamble(), np.zeros(2 * _M, np.complex64)])
    return np_interp2(seq, _interp_taps())


@functools.lru_cache(maxsize=1)
def _mf_bank() -> np.ndarray:
    """Polyphase matched-filter bank [npfb, Lb] (branch order)."""
    h = firdes_arkaiser(_K * _NPFB, _M, _BETA).astype(np.float32)
    Lb = (len(h) - 1) // _NPFB
    return np.stack([h[b + np.arange(Lb) * _NPFB] for b in range(_NPFB)])


def _mf_symbols(x, det, n_sym):
    """Matched-filter symbol stream from the aligned capture (host numpy,
    the one-shot framesync64's gather)."""
    bank = _mf_bank()
    tau = det.tau_hat
    if tau > 0:
        b, off = int(tau * _NPFB) % _NPFB, 0
    else:
        b, off = int((1.0 + tau) * _NPFB) % _NPFB, -1
    n0 = det.sample_index
    Lb = bank.shape[1]
    taps = bank[b][::-1].astype(np.complex64)
    base = n0 + off + 2 * np.arange(n_sym)
    idx = base[:, None] + np.arange(Lb)[None, :] - (Lb - 1)
    xp = np.concatenate([np.zeros(Lb, np.complex64), x,
                         np.zeros(2 * n_sym + Lb, np.complex64)])
    win = xp[idx + Lb]
    tt = (idx - n0).astype(np.float32)
    win = win * np.exp(-1j * (det.dphi_hat * tt + det.phi_hat)
                       ).astype(np.complex64)
    sym = win @ taps
    return sym * (0.5 / max(det.gamma_hat, 1e-12))


def _evm_db(p_rx, ms) -> float:
    """EVM of symbols against their nearest constellation points, dB."""
    table = constellation(ms)
    ref = modulate(table, demodulate(table, torch.from_numpy(
        np.ascontiguousarray(p_rx, np.complex64)))).numpy()
    return float(20 * np.log10(np.sqrt(np.mean(np.abs(p_rx - ref) ** 2))
                               + 1e-12))


def _payload_geometry(hdr):
    """(n_payload, ms, crc, fec0, fec1, p_sym_len) from a decoded header's
    control bytes; ValueError or KeyError for a wire value with no scheme
    (a failed header, as in the reference)."""
    ku = FLEXFRAME_H_USER
    n_payload = (int(hdr[ku + 1]) << 8) | int(hdr[ku + 2])
    ms = modem_from_wire(int(hdr[ku + 3]))
    crc = crc_from_wire((int(hdr[ku + 4]) >> 5) & 0x07)
    fec0 = fec_from_wire(int(hdr[ku + 4]) & 0x1F)
    fec1 = fec_from_wire(int(hdr[ku + 5]) & 0x1F)
    p_sym_len = qpacketmodem_frame_len(n_payload, crc, fec0, fec1, ms)
    return n_payload, ms, crc, fec0, fec1, p_sym_len


def flexframesync(x, threshold: float = 0.5,
                  device="cuda") -> FlexFrameResult:
    """Recover a flexframe from a capture buffer: detect (FFTs on
    ``device``, the card unless given; the rest on the host), decode the
    header, then the payload it announces (hard decisions)."""
    device = entry_device(device)
    x = np.asarray(x.cpu() if torch.is_tensor(x) else x, np.complex64)
    det = qdetector_detect(x, _detector_template(), threshold=threshold,
                           range_bins=2, device=device)
    if not det.detected:
        return FlexFrameResult(False, False, False, None, None, "", 0, 0.0)
    failed = FlexFrameResult(True, False, False, None, None, "", 0, 0.0)
    h_sym_len, h_mod_len = _header_syms_len()
    n_first = _N_LEAD + h_sym_len
    sym = _mf_symbols(x, det, n_first)
    h_mod, dphi2, phi2, g2 = qpilotsync(sym[_N_LEAD:n_first], h_mod_len, 16)
    hdr, h_ok = qpacketmodem_decode(h_mod, FLEXFRAME_H_USER + 6, _H_CRC,
                                    _H_FEC0, _H_FEC1, _H_MOD)
    if not h_ok or hdr[FLEXFRAME_H_USER] != _PROTOCOL:
        return failed
    try:
        n_payload, ms, crc, fec0, fec1, p_sym_len = _payload_geometry(hdr)
    except (ValueError, KeyError):
        return failed
    n_total = n_first + p_sym_len
    sym = _mf_symbols(x, det, n_total)
    # the header pilots' residual carrier extends over the payload
    i_all = np.arange(p_sym_len) + h_sym_len
    p_rx = sym[n_first:n_total] * np.exp(
        -1j * (dphi2 * i_all + phi2)) / max(g2, 1e-12)
    payload, ok = qpacketmodem_decode(p_rx, n_payload, crc, fec0, fec1, ms)
    return FlexFrameResult(True, True, bool(ok), hdr[:FLEXFRAME_H_USER],
                           payload, ms, n_payload, _evm_db(p_rx, ms))


# ---------------------------------------------------------------------------
# streaming receivers
# ---------------------------------------------------------------------------
#
# The same detect-everywhere streaming core as framesync64 (stream_rx.py),
# but the payload length is only known after the header decodes
# (reference flexframesync.c computes the payload geometry at run time):
# the header-stage Proc syncs the fixed header region; FlexFrameSync
# decodes the header on the host and gathers the payload from the raw
# samples it keeps.  The full receivers fix the payload configuration
# (or a registered set) so that the whole frame decodes in the step.


def _pilot_nfft(npil: int) -> int:
    """qpilotsync FFT sizing (reference qpilotsync.c:127)."""
    return 1 << int(np.ceil(np.log2(npil + (npil >> 1))))


def _stream_cfg(region: int, suppress_region_syms: int) -> StreamRxConfig:
    """Receiver geometry: the sync region starts after the preamble and
    spans `region` symbols; detection re-arms after
    `suppress_region_syms` symbols of region."""
    _, h_mod_len = _header_syms_len()
    pilots = qpilot_pilots(h_mod_len, 16)
    return StreamRxConfig(
        template=_detector_template(), bank=_mf_bank(),
        region_start=_N_LEAD, region_len=region, pilots=pilots,
        pilot_spacing=16, pilot_nfft=_pilot_nfft(len(pilots)),
        suppress_span=_K * (64 + suppress_region_syms) - 8, k=_K)


def flexframesync_stream(block_len: int, threshold: float = 0.5,
                         max_frames: int = 6,
                         name: str = "flexframesync_stream"):
    """Streaming flexframe HEADER-stage receiver Proc.

    proc(carry, x[..., block_len]) -> (StreamRxBlock, carry').
    region_syms holds the pilot-corrected header region (pilots still in
    place); its non-pilot symbols decode to the header, after which the
    payload is gathered from the raw samples (`FlexFrameSync`).
    block_len must be a multiple of 256."""
    h_sym_len, _ = _header_syms_len()
    # minimum preamble spacing: preamble + header (payload >= 1 symbol)
    return preamble_stream(int(block_len), _stream_cfg(h_sym_len, h_sym_len),
                           threshold=threshold, max_frames=max_frames,
                           name=name)


def _exp_header_fields(pl: int, crc: str, fec0: str, fec1: str, ms: str):
    """Expected wire header bytes for one payload config (the static
    compare the full receivers apply after the header CRC)."""
    ku = FLEXFRAME_H_USER
    exp = {ku + 0: _PROTOCOL,
           ku + 1: (pl >> 8) & 0xFF,
           ku + 2: pl & 0xFF,
           ku + 3: modem_to_wire(ms),
           ku + 4: ((crc_to_wire(crc) & 0x07) << 5) |
                   (fec_to_wire(fec0) & 0x1F),
           ku + 5: fec_to_wire(fec1) & 0x1F}
    idx = sorted(exp)
    return (np.asarray(idx, np.int64), np.asarray([exp[i] for i in idx],
                                                  np.int32))


def _payload_decoder(pl, crc, fec0, fec1, ms):
    """(symbols -> message indices or bits, -> (bytes, crc_ok)) modules
    for one payload config: the block decoder, else the conv decoder (a
    ValueError from both means the config has no device decoder)."""
    try:
        dec, _ = qpacket_soft_decoder(pl, crc, fec0, fec1, ms)
    except ValueError:
        dec, _ = qpacket_conv_soft_decoder(pl, crc, fec0, fec1, ms)
    return dec, device_packet_finish(pl, crc, fec0, fec1)


def _payload_syms(pl, crc, fec0, fec1, ms) -> int:
    enc = packetizer_compute_enc_msg_len(pl, crc, fec0, fec1)
    return -(-8 * enc // bits_per_symbol(ms))


class FlexStreamBlock(NamedTuple):
    """Full-device fixed-config flexframe RX result per block; the last
    axis before any per-slot data is the candidate slot."""
    valid: torch.Tensor         # [..., P] bool
    sample_index: torch.Tensor  # [..., P] int32
    rxy: torch.Tensor           # [..., P] detection correlation
    evm_db: torch.Tensor        # [..., P] pilot-referenced gain proxy
    hdr_bytes: torch.Tensor     # [..., P, 20] int32 decoded header
    hdr_ok: torch.Tensor        # [..., P] bool CRC + config field check
    pay_bytes: torch.Tensor     # [..., P, payload_len] int32
    pay_ok: torch.Tensor        # [..., P] bool payload CRC


class FlexMultiStreamBlock(NamedTuple):
    """Header-adaptive full-device RX result (registered config set).
    pay_bytes is padded to the LONGEST registered payload; cfg_idx is the
    matched config (-1: header valid but unregistered, or CRC failed)."""
    valid: torch.Tensor         # [..., P] bool
    sample_index: torch.Tensor  # [..., P] int32
    rxy: torch.Tensor           # [..., P] detection correlation
    evm_db: torch.Tensor        # [..., P]
    hdr_bytes: torch.Tensor     # [..., P, 20] int32 decoded header
    hdr_ok: torch.Tensor        # [..., P] bool CRC + registered config
    cfg_idx: torch.Tensor       # [..., P] int32 matched config index
    pay_bytes: torch.Tensor     # [..., P, max_payload_len] int32
    pay_ok: torch.Tensor        # [..., P] bool payload CRC


class _FlexRxBase(Proc):
    """Shared part of the full receivers: the stream core over header +
    `p_syms_max` payload symbols (re-arming after `p_syms_rearm`), and
    the header decode."""

    def __init__(self, block_len, threshold, max_frames, p_syms_max,
                 p_syms_rearm, name):
        super().__init__(name)
        h_sym_len, h_mod_len = _header_syms_len()
        region = h_sym_len + p_syms_max
        self.h_sym_len = h_sym_len
        self.core = preamble_stream(
            int(block_len), _stream_cfg(region, h_sym_len + p_syms_rearm),
            threshold=threshold, max_frames=max_frames, name=name,
            hist=max(STREAM_HIST, _K * (_N_LEAD + region) + 2))
        nonpil = np.nonzero(np.arange(h_sym_len) % 16 != 0)[0]
        assert len(nonpil) == h_mod_len, (len(nonpil), h_mod_len)
        self.register_buffer("nonpil_idx", torch.from_numpy(nonpil))
        self.register_buffer("hdr_tab", torch.from_numpy(
            constellation(_H_MOD).astype(np.complex64)))
        self.hdr_dec = packetizer2_soft_decoder(FLEXFRAME_H_USER + 6, _H_CRC,
                                                _H_FEC0, _H_FEC1)

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return self.core.init(batch_shape, dtype, device)

    def _header(self, out: StreamRxBlock):
        """(header bytes [..., P, 20], header CRC ok [..., P], evm_db)."""
        hdr_syms = out.region_syms[..., :self.h_sym_len][..., self.nonpil_idx]
        llr = demodulate_soft(self.hdr_tab, hdr_syms)
        hdr_bytes, crc_ok = self.hdr_dec(llr.reshape(llr.shape[:-2] + (-1,)))
        evm_db = 20.0 * torch.log10(torch.clamp(out.g2, min=1e-12))
        return hdr_bytes[..., :FLEXFRAME_H_USER + 6], crc_ok, evm_db


def _match(hdr_bytes, crc_ok, idx, val):
    return crc_ok & (hdr_bytes[..., idx] == val).all(dim=-1)


class FlexframeRxStream(_FlexRxBase):
    """Full receiver for one payload configuration (see
    `flexframe_rx_stream`)."""

    def __init__(self, block_len, payload_len, crc, fec0, fec1, ms,
                 threshold, max_frames):
        p_syms = _payload_syms(payload_len, crc, fec0, fec1, ms)
        super().__init__(block_len, threshold, max_frames, p_syms, p_syms,
                         "flexframe_rx_stream")
        self.pay_dec, self.pay_fin = _payload_decoder(payload_len, crc, fec0,
                                                      fec1, ms)
        idx, val = _exp_header_fields(payload_len, crc, fec0, fec1, ms)
        self.register_buffer("exp_idx", torch.from_numpy(idx))
        self.register_buffer("exp_val", torch.from_numpy(val))

    def forward(self, carry, x):
        out, carry = self.core(carry, x)
        hdr_bytes, crc_ok, evm_db = self._header(out)
        pay_bytes, pay_ok = self.pay_fin(self.pay_dec(
            out.region_syms[..., self.h_sym_len:]))
        return FlexStreamBlock(
            valid=out.valid, sample_index=out.sample_index, rxy=out.rxy,
            evm_db=evm_db, hdr_bytes=hdr_bytes,
            hdr_ok=_match(hdr_bytes, crc_ok, self.exp_idx, self.exp_val),
            pay_bytes=pay_bytes, pay_ok=pay_ok), carry


def flexframe_rx_stream(block_len: int, payload_len: int,
                        crc: str = "crc32", fec0: str = "none",
                        fec1: str = "golay2412", ms: str = "qpsk",
                        threshold: float = 0.5,
                        max_frames: int = 4) -> FlexframeRxStream:
    """FULL streaming flexframe receiver for one payload configuration
    (the deployed-link case; arbitrary per-frame configs stay with the
    host-loop FlexFrameSync).  proc(carry, x[..., block_len]) ->
    (FlexStreamBlock, carry'): detect-everywhere, refine, mix +
    polyphase MF, pilot sync, the TWO-stage header decode (hamming84
    codebook + SECDED syndrome matmuls, `packetizer2_soft_decoder`), the
    payload soft decode (the `codebook_argmax` kernel for golay2412, the
    `viterbi_acs` kernel for a convolutional code), byte pack and CRC.  A frame announcing another config
    comes back ``hdr_ok`` False.  The sync region covers header +
    payload: the header pilots' carrier correction extends across the
    payload as a linear phase ramp.  Reference analog: flexframesync.c
    runs the same stages per sample on the CPU."""
    return FlexframeRxStream(block_len, payload_len, crc, fec0, fec1, ms,
                             threshold, max_frames)


class FlexframeRxStreamMulti(_FlexRxBase):
    """Full receiver for a registered set of payload configurations (see
    `flexframe_rx_stream_multi`)."""

    def __init__(self, block_len, configs, threshold, max_frames):
        configs = [tuple(c) for c in configs]
        if not configs:
            raise ValueError("need at least one registered config")
        p_syms = [_payload_syms(*c) for c in configs]
        # re-arm after the SHORTEST registered frame: a longer frame's
        # interior may then admit spurious candidates, which fail the
        # header CRC and only occupy a slot (the reference's re-arm is
        # per-frame exact because it consumes serially)
        super().__init__(block_len, threshold, max_frames, max(p_syms),
                         min(p_syms), "flexframe_rx_stream_multi")
        self.p_syms = p_syms
        self.pay_lens = [c[0] for c in configs]
        decs, fins = zip(*(_payload_decoder(*c) for c in configs))
        self.pay_decs, self.pay_fins = nn.ModuleList(decs), nn.ModuleList(fins)
        for j, c in enumerate(configs):
            idx, val = _exp_header_fields(*c)
            self.register_buffer(f"exp_idx{j}", torch.from_numpy(idx))
            self.register_buffer(f"exp_val{j}", torch.from_numpy(val))

    def forward(self, carry, x):
        out, carry = self.core(carry, x)
        hdr_bytes, crc_ok, evm_db = self._header(out)
        lead = hdr_bytes.shape[:-1]
        dev = hdr_bytes.device
        max_pl = max(self.pay_lens)
        pay_all = torch.zeros(lead + (max_pl,), dtype=torch.int32, device=dev)
        ok_all = torch.zeros(lead, dtype=torch.bool, device=dev)
        cfg_idx = torch.full(lead, -1, dtype=torch.int32, device=dev)
        h = self.h_sym_len
        for j, (dec, fin, psy, pl) in enumerate(zip(
                self.pay_decs, self.pay_fins, self.p_syms, self.pay_lens)):
            match = _match(hdr_bytes, crc_ok, getattr(self, f"exp_idx{j}"),
                           getattr(self, f"exp_val{j}"))
            pj, okj = fin(dec(out.region_syms[..., h:h + psy]))
            pj = torch.nn.functional.pad(pj, (0, max_pl - pl))
            pay_all = torch.where(match[..., None], pj, pay_all)
            ok_all = torch.where(match, okj, ok_all)
            cfg_idx = torch.where(match, j, cfg_idx)
        return FlexMultiStreamBlock(
            valid=out.valid, sample_index=out.sample_index, rxy=out.rxy,
            evm_db=evm_db, hdr_bytes=hdr_bytes, hdr_ok=cfg_idx >= 0,
            cfg_idx=cfg_idx, pay_bytes=pay_all, pay_ok=ok_all), carry


def flexframe_rx_stream_multi(block_len: int, configs,
                              threshold: float = 0.5,
                              max_frames: int = 4) -> FlexframeRxStreamMulti:
    """HEADER-ADAPTIVE full streaming flexframe receiver: decodes a
    REGISTERED SET of payload configurations in one stream.  The header
    decodes as in flexframe_rx_stream; every registered config's decoder
    then runs over the shared synced region and the header-announced
    config selects the result.  Frames announcing an unregistered config
    report ``hdr_ok`` False (``cfg_idx`` -1).

    configs: sequence of (payload_len, crc, fec0, fec1, ms) tuples.
    Reference analog: flexframesync.c reconfigures its payload demod/FEC
    from each header at run time on the host CPU."""
    return FlexframeRxStreamMulti(block_len, configs, threshold, max_frames)


class FlexFrameSync:
    """Callback-contract wrapper over the streaming header-stage Proc:
    the analog of the reference flexframesync object (create / execute /
    callback per frame, reference flexframesync.c).  execute() takes any
    number of samples; the callback fires once per frame with (header
    bytes, header_ok, payload bytes, payload_ok, stats dict).

    device: where the receiver runs (the card unless given; without one a
    CUDA device raises).  Per block the header stage runs there; per
    frame the header decodes on the host, the payload symbols are
    gathered on the device from the raw samples this object keeps, and a
    payload config with a device decoder (an outer block code with inner
    'none', or one convolutional stage up to K = 9) decodes there too,
    soft; others decode on the host by hard decisions."""

    _PAD = 64   # raw-window margin around the MF gather (>= Lb)

    def __init__(self, callback: Optional[Callable] = None,
                 block_len: int = 4096, threshold: float = 0.5,
                 max_frames: int = 6, device="cuda"):
        self.callback = callback
        self.block_len = int(block_len)
        self.device = entry_device(device)
        self._proc = flexframesync_stream(self.block_len, threshold,
                                          max_frames).to(self.device)
        self._carry = self._proc.init(device=self.device)
        self._pending = np.zeros(0, np.complex64)
        self._h_sym_len, self._h_mod_len = _header_syms_len()
        self._n_first = _N_LEAD + self._h_sym_len
        self._bank = torch.from_numpy(np.ascontiguousarray(
            _mf_bank()[:, ::-1], np.float32)).to(self.device)
        # raw-sample retention for the payload: ring with absolute base
        self._ring = np.zeros(0, np.complex64)
        self._ring_base = 0
        self._abs_fed = 0
        self._cands: list = []     # undecoded candidates (dict of meta)
        self._armed_until = -(1 << 60)
        self.frames: list = []
        self.num_frames_detected = 0
        self._dev_fec_cache: dict = {}

    def _device_decoder(self, n_payload, crc, fec0, fec1, ms):
        """Cached device soft decoder (symbols -> bytes, crc_ok) for a
        payload config whose outer code is a block scheme and inner code
        'none', or whose one stage is a convolutional code up to K = 9
        (the `viterbi_acs` kernel); None for other configs."""
        key = (n_payload, crc, fec0, fec1, ms)
        if key not in self._dev_fec_cache:
            try:
                dec, fin = _payload_decoder(*key)
                self._dev_fec_cache[key] = nn.Sequential(dec, fin).to(
                    self.device)
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
        # stream over: finish any pending candidate with zero-padding
        out.extend(self._drain(final=True))
        return out

    # ---- internals ----

    def _collect(self, out: StreamRxBlock):
        o = StreamRxBlock(*(t.cpu().numpy() for t in out))
        for p in np.nonzero(o.valid)[0]:
            self._cands.append({
                "n0": int(o.sample_index[p]), "rxy": float(o.rxy[p]),
                "gamma": float(o.gamma[p]), "dphi": float(o.dphi[p]),
                "phi": float(o.phi[p]), "b_idx": int(o.b_idx[p]),
                "off_s": int(o.off_s[p]), "dphi2": float(o.dphi2[p]),
                "phi2": float(o.phi2[p]), "g2": float(o.g2[p]),
                "region": o.region_syms[p], "hdr": None})
        self._cands.sort(key=lambda c: c["n0"])

    def _header_decode(self, c):
        mask = np.arange(self._h_sym_len) % 16 == 0
        h_mod = c["region"][~mask][: self._h_mod_len]
        hdr, h_ok = qpacketmodem_decode(h_mod, FLEXFRAME_H_USER + 6,
                                        _H_CRC, _H_FEC0, _H_FEC1, _H_MOD)
        geom = None
        if h_ok and hdr[FLEXFRAME_H_USER] == _PROTOCOL:
            try:
                geom = _payload_geometry(hdr)
            except (ValueError, KeyError):
                h_ok = False
        else:
            h_ok = False
        c["hdr"] = (hdr, h_ok, geom)

    def _drain(self, final: bool = False):
        res = []
        while self._cands:
            c = self._cands[0]
            if c["n0"] < self._armed_until:       # inside a decoded frame
                self._cands.pop(0)
                continue
            if c["hdr"] is None:
                self._header_decode(c)
            hdr, h_ok, geom = c["hdr"]
            if not h_ok:
                self._cands.pop(0)
                self.num_frames_detected += 1
                self._armed_until = c["n0"] + _K * (64 + self._h_sym_len)
                frame = (None if hdr is None else hdr[:FLEXFRAME_H_USER],
                         False, None, False, self._stats(c, 0, ""))
                self._emit(frame)
                res.append(frame)
                continue
            n_payload, ms, crc, fec0, fec1, p_sym_len = geom
            end_abs = c["n0"] + _K * (self._n_first + p_sym_len) + self._PAD
            if end_abs > self._abs_fed and not final:
                break                              # wait for more samples
            self._cands.pop(0)
            self.num_frames_detected += 1
            p_rx = self._gather_payload(c, p_sym_len)
            dev = self._device_decoder(n_payload, crc, fec0, fec1, ms)
            if dev is not None:
                # soft decode on the device: LLRs, deinterleave gather,
                # codebook argmax, byte pack and the CRC parity matmul
                b, ok = dev(torch.from_numpy(p_rx).to(self.device))
                payload = b.cpu().numpy().astype(np.uint8)[:n_payload]
                ok = bool(ok)
            else:
                payload, ok = qpacketmodem_decode(p_rx, n_payload, crc,
                                                  fec0, fec1, ms)
            self._armed_until = c["n0"] + _K * (self._n_first + p_sym_len) - 8
            frame = (hdr[:FLEXFRAME_H_USER].copy(), True, payload, bool(ok),
                     self._stats(c, n_payload, ms, p_rx))
            self._emit(frame)
            res.append(frame)
        return res

    def _gather_payload(self, c, p_sym_len):
        """Mix/MF/sample the payload's symbols from the raw-sample window
        on the device, then extend the header pilots' carrier correction
        across them (the one-shot flexframesync's payload step)."""
        a0 = c["n0"] - self._PAD
        a1 = c["n0"] + _K * (self._n_first + p_sym_len) + self._PAD
        i0, i1 = a0 - self._ring_base, a1 - self._ring_base
        win = np.zeros(i1 - i0, np.complex64)
        s0, s1 = max(i0, 0), min(i1, len(self._ring))
        if s1 > s0:
            win[s0 - i0: s1 - i0] = self._ring[s0:s1]
        dev = self.device

        def scalar(v, dtype):
            return torch.tensor([[v]], dtype=dtype, device=dev)

        f32 = torch.float32
        sym = mf_symbol_gather(
            torch.from_numpy(win)[None].to(dev), scalar(self._PAD,
                                                        torch.int64),
            scalar(c["off_s"], torch.int32), scalar(c["dphi"], f32),
            scalar(c["phi"], f32), scalar(c["gamma"], f32), self._bank,
            scalar(c["b_idx"], torch.int32), p_sym_len,
            start_sym=self._n_first)[0, 0]
        i_all = torch.arange(p_sym_len, dtype=f32, device=dev) + \
            float(self._h_sym_len)
        ph2 = torch.tensor(c["dphi2"], dtype=f32, device=dev) * i_all + \
            c["phi2"]
        corr = torch.complex(torch.cos(ph2), -torch.sin(ph2)) / max(
            c["g2"], 1e-12)
        return (sym * corr).cpu().numpy()

    def _stats(self, c, n_payload, ms, p_rx=None):
        st = {"rxy": c["rxy"],
              "rssi_db": float(20 * np.log10(max(c["gamma"], 1e-12))),
              "cfo": c["dphi"] + c["dphi2"] / _K,
              "sample_index": c["n0"], "payload_len": n_payload, "ms": ms,
              "evm_db": 0.0}
        if p_rx is not None and len(p_rx) and ms:
            st["evm_db"] = _evm_db(p_rx, ms)
        return st

    def _emit(self, frame):
        self.frames.append(frame)
        if self.callback is not None:
            self.callback(*frame)

    def _trim(self):
        """Drop ring samples no candidate can still reference."""
        keep_from = self._abs_fed - STREAM_HIST - self.block_len
        if self._cands:
            keep_from = min(keep_from, self._cands[0]["n0"] - self._PAD)
        cut = keep_from - self._ring_base
        if cut > 0:
            self._ring = self._ring[cut:]
            self._ring_base += cut
