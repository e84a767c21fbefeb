"""framegen64 / framesync64: the fixed 8+64-byte frame PHY pair
(`liquid_dsp_tpu/framing/frame64.py`).

Reference analogs:
  * framegen64  — src/framing/src/framegen64.c:38-172: 64-symbol
    m-sequence preamble (msequence(7,0x0089,1)), qpacketmodem (72 bytes
    -> 600 QPSK symbols via CRC-24 + Golay(24,12)), qpilotgen (600 ->
    630 symbols, spacing 21), ARKAISER k=2 m=7 beta=0.3 interpolation ->
    exactly LIQUID_FRAME64_LEN = 1440 samples.
  * framesync64 — src/framing/src/framesync64.c:66-430: qdetector ->
    mixer / matched filter / decimate -> qpilotsync -> qpacketmodem
    decode.

The transmitter is host numpy.  The receivers:
  * `framesync64`, one frame from one capture (detector FFTs on the
    given device, the rest on the host);
  * `framesync64_stream`, the streaming multi-frame receiver Proc on the
    generic core of stream_rx.py, batched over channels;
  * `framesync64_stream_full`, the same with the payload FEC (soft Golay
    decode through the `codebook_argmax` kernel, byte pack, CRC) in the
    block step;
  * `Framesync64`, the callback wrapper (the reference's
    create/execute/callback object).
The Procs run where the caller moves them (``.to(device)``);
`framesync64` and `Framesync64`, which take host arrays, run on the card
unless the caller passes ``device="cpu"``, and raise without a card.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..core import Proc, entry_device
from ..design.firdes import firdes_arkaiser
from ..fec.device import device_packet_finish, qpacket_soft_decoder
from ..modem.linear import constellation, demodulate, modulate
from ..utils.sequence import MSequence
from .detector import qdetector_detect
from .qpacket import (qpacketmodem_decode, qpacketmodem_encode,
                      qpilot_pilots, qpilotgen, qpilotsync)
from .stream_rx import (STREAM_HIST, StreamRxBlock, StreamRxConfig,
                        preamble_stream)

__all__ = ["FRAME64_LEN", "framegen64", "framesync64", "Frame64Result",
           "frame64_preamble", "np_interp2", "framesync64_stream",
           "framesync64_stream_full", "Framesync64", "Frame64Block",
           "Frame64FullBlock"]

FRAME64_LEN = 1440
_K = 2          # samples/symbol
_M = 7          # filter semi-length (symbols)
_BETA = 0.3     # excess bandwidth
_NPFB = 32      # matched-filter bank resolution
_HIST = STREAM_HIST
_PFFT = 64      # pilot carrier-estimate FFT (qpilotsync nfft)


def frame64_preamble() -> np.ndarray:
    """64-symbol p/n preamble (reference framegen64.c:60-66)."""
    ms = MSequence(7, 0x0089, 1)
    out = np.zeros(64, np.complex64)
    s2 = np.sqrt(0.5)
    for i in range(64):
        # the reference's two msequence_advance() calls sit in one C
        # expression (framegen64.c:62-63); the shipped builds evaluate
        # the imaginary operand first
        im = s2 if ms.advance() else -s2
        re = s2 if ms.advance() else -s2
        out[i] = re + 1j * im
    return out


def _interp_taps() -> np.ndarray:
    return firdes_arkaiser(_K, _M, _BETA).astype(np.float32)


def np_interp2(stream: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """1:2 pulse-shape interpolation in numpy (the firinterp Proc from
    zero state)."""
    xz = np.zeros(len(stream) * 2, np.complex64)
    xz[::2] = stream
    return np.convolve(xz, taps)[: len(stream) * 2].astype(np.complex64)


def framegen64(header, payload) -> np.ndarray:
    """One frame: 8-byte header + 64-byte payload -> 1440 complex64
    samples (reference framegen64_execute:130-172)."""
    header = np.asarray(header, np.uint8)
    payload = np.asarray(payload, np.uint8)
    if header.shape != (8,) or payload.shape != (64,):
        raise ValueError("framegen64 takes an 8-byte header and a "
                         "64-byte payload")
    syms = qpacketmodem_encode(np.concatenate([header, payload]),
                               "crc24", "none", "golay2412", "qpsk").numpy()
    assert len(syms) == 600
    frame_syms = qpilotgen(syms, 21)
    assert len(frame_syms) == 630
    settle = 2 * _M + 2 + 10
    stream = np.concatenate([frame64_preamble(), frame_syms,
                             np.zeros(settle, np.complex64)])
    y = np_interp2(stream, _interp_taps())
    assert len(y) == FRAME64_LEN
    return y


def _detector_template() -> np.ndarray:
    """Interpolated preamble + filter tail (reference
    qdetector_cccf_create_linear: s_len = k*(64 + 2m))."""
    seq = np.concatenate([frame64_preamble(), np.zeros(2 * _M, np.complex64)])
    return np_interp2(seq, _interp_taps())


def _mf_bank() -> np.ndarray:
    """Polyphase matched-filter bank [npfb, Lb] (reference
    framesync64.c:144: firpfb_crcf_create_rnyquist(ARKAISER, 32, 2, 7))."""
    h = firdes_arkaiser(_K * _NPFB, _M, _BETA).astype(np.float32)
    Lb = (len(h) - 1) // _NPFB      # branch length = 2*k*m
    return np.stack([h[b + np.arange(Lb) * _NPFB] for b in range(_NPFB)])


class Frame64Result(NamedTuple):
    detected: bool
    crc_ok: bool
    header: Optional[np.ndarray]
    payload: Optional[np.ndarray]
    evm_db: float
    rssi_db: float
    cfo: float          # radians/sample
    sample_index: int


def framesync64(x, threshold: float = 0.5, device="cuda") -> Frame64Result:
    """Recover one frame64 from a capture [T]: detect (FFTs on
    ``device``, the card unless given; the rest on the host) -> mix down
    -> polyphase matched filter at the estimated timing phase, decimated
    2:1 -> pilot sync -> packet decode."""
    device = entry_device(device)
    x = np.asarray(x.cpu() if torch.is_tensor(x) else x, np.complex64)
    det = qdetector_detect(x, _detector_template(), threshold=threshold,
                           range_bins=2, device=device)
    if not det.detected:
        return Frame64Result(False, False, None, None, 0.0, 0.0, 0.0, -1)
    bank = _mf_bank()
    # timing: filterbank index + base offset (framesync64.c:299-306)
    tau = det.tau_hat
    if tau > 0:
        b, off = int(tau * _NPFB) % _NPFB, 0
    else:
        b, off = int((1.0 + tau) * _NPFB) % _NPFB, -1
    n0 = det.sample_index
    # 64 preamble + 2m delay + 630 payload matched-filter outputs
    n_sym = 64 + 2 * _M + 630
    Lb = bank.shape[1]
    taps = bank[b][::-1].copy()          # newest-first for the window dot
    base = n0 + off + 2 * np.arange(n_sym)
    idx = base[:, None] + np.arange(Lb)[None, :] - (Lb - 1)
    xp = np.concatenate([np.zeros(Lb, np.complex64), x,
                         np.zeros(2 * n_sym + Lb, np.complex64)])
    win = xp[idx + Lb]                   # [n_sym, Lb]
    # mix down with the detector's estimates (phase referenced to n0)
    tt = (idx - n0).astype(np.float32)
    win = win * np.exp(-1j * (det.dphi_hat * tt + det.phi_hat)
                       ).astype(np.complex64)
    sym = (win @ taps.astype(np.complex64)) * (0.5 / max(det.gamma_hat,
                                                         1e-12))
    payload_sym, dphi2, _, _ = qpilotsync(
        sym[64 + 2 * _M: 64 + 2 * _M + 630], 600, 21)
    payload_bytes, ok = qpacketmodem_decode(
        payload_sym, 72, "crc24", "none", "golay2412", "qpsk")
    # stats: EVM against the nearest QPSK point
    table = constellation("qpsk")
    ps = torch.from_numpy(payload_sym)
    ref = modulate(table, demodulate(table, ps)).numpy()
    evm = np.sqrt(np.mean(np.abs(payload_sym - ref) ** 2))
    # cfo in radians/SAMPLE; qpilotsync's dphi2 is per payload symbol
    return Frame64Result(True, bool(ok),
                         payload_bytes[:8].copy(), payload_bytes[8:].copy(),
                         float(20 * np.log10(evm + 1e-12)),
                         float(20 * np.log10(max(det.gamma_hat, 1e-12))),
                         float(det.dphi_hat + dphi2 / _K), n0)


class Frame64Block(NamedTuple):
    """Per-block batched detection result: the slot axis (max_frames)
    follows the channel axes; `valid` masks live slots."""
    valid: torch.Tensor         # [..., P] bool
    sample_index: torch.Tensor  # [..., P] int32, absolute stream index
    rxy: torch.Tensor           # [..., P] detection correlation
    cfo: torch.Tensor           # [..., P] rad/sample (coarse + pilot)
    gamma: torch.Tensor         # [..., P] channel gain
    evm_db: torch.Tensor        # [..., P] pilot-referenced QPSK EVM (dB)
    symbols: torch.Tensor       # [..., P, 600] corrected payload symbols


class Frame64FullBlock(NamedTuple):
    """framesync64_stream_full result: detection + in-stream decode."""
    valid: torch.Tensor         # [..., P] bool
    sample_index: torch.Tensor  # [..., P] int32
    rxy: torch.Tensor
    cfo: torch.Tensor
    gamma: torch.Tensor
    evm_db: torch.Tensor
    hdr_bytes: torch.Tensor     # [..., P, 8] int32 decoded header
    pay_bytes: torch.Tensor     # [..., P, 64] int32 decoded payload
    crc_ok: torch.Tensor        # [..., P] bool


def _stream_cfg() -> StreamRxConfig:
    """The frame64 receiver geometry as a StreamRxConfig."""
    return StreamRxConfig(
        template=_detector_template(), bank=_mf_bank(),
        region_start=64 + 2 * _M, region_len=630,
        pilots=qpilot_pilots(600, 21), pilot_spacing=21, pilot_nfft=_PFFT,
        suppress_span=FRAME64_LEN - 8,   # slack for +-1 peak quantization
        k=_K)


class Framesync64Stream(Proc):
    """Streaming multi-frame frame64 receiver (see `framesync64_stream`)."""

    def __init__(self, block_len, threshold, max_frames, name):
        super().__init__(name)
        T = int(block_len)
        P = max_frames if max_frames is not None else T // FRAME64_LEN + 2
        self.core = preamble_stream(T, _stream_cfg(), threshold=threshold,
                                    max_frames=P, name=name)
        self.register_buffer("data_idx", torch.from_numpy(
            np.nonzero(np.arange(630) % 21 != 0)[0].astype(np.int64)))

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return self.core.init(batch_shape, dtype, device)

    def forward(self, carry, x):
        out, carry = self.core(carry, x)
        return _frame64_block(out, self.data_idx), carry


def _frame64_block(out: StreamRxBlock, data_idx) -> Frame64Block:
    """The frame64 result of a preamble-sync block: the payload symbols
    (data_idx: the 600 non-pilot positions of the 630-symbol region, on
    out's device), the coarse + pilot CFO and the pilot-referenced EVM."""
    syms = out.region_syms[..., data_idx]
    # pilot-referenced stats: EVM against the nearest QPSK point
    s2 = float(np.float32(np.sqrt(0.5)))
    near = torch.complex(torch.sign(syms.real) * s2,
                         torch.sign(syms.imag) * s2)
    evm = torch.sqrt(torch.mean((syms - near).abs() ** 2, dim=-1))
    return Frame64Block(
        valid=out.valid, sample_index=out.sample_index, rxy=out.rxy,
        cfo=out.dphi + out.dphi2 / _K, gamma=out.gamma,
        evm_db=20.0 * torch.log10(evm + 1e-12), symbols=syms)


def framesync64_stream(block_len: int, threshold: float = 0.5,
                       max_frames: int | None = None,
                       name: str = "framesync64_stream") -> Framesync64Stream:
    """Streaming multi-frame frame64 receiver Proc.

    proc(carry, x[..., block_len]) -> (Frame64Block, carry').  Every frame
    whose first sample enters the stream is decoded exactly once, in
    arrival order along each channel's slot axis; leading axes are
    independent channels.  block_len must be a multiple of 256.
    """
    return Framesync64Stream(block_len, threshold, max_frames, name)


class Framesync64StreamFull(Proc):
    """framesync64_stream with the payload FEC in the block step."""

    def __init__(self, block_len, threshold, max_frames, name):
        super().__init__(name)
        self.core = framesync64_stream(block_len, threshold, max_frames, name)
        self.decode, _ = qpacket_soft_decoder(72, "crc24", "none",
                                              "golay2412", "qpsk")
        self.finish = device_packet_finish(72, "crc24", "none", "golay2412")

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return self.core.init(batch_shape, dtype, device)

    def forward(self, carry, x):
        out, carry = self.core(carry, x)
        buf, ok = self.finish(self.decode(out.symbols))
        return Frame64FullBlock(
            valid=out.valid, sample_index=out.sample_index, rxy=out.rxy,
            cfo=out.cfo, gamma=out.gamma, evm_db=out.evm_db,
            hdr_bytes=buf[..., :8], pay_bytes=buf[..., 8:],
            crc_ok=ok), carry


def framesync64_stream_full(block_len: int, threshold: float = 0.5,
                            max_frames: int | None = None,
                            name: str = "framesync64_full"
                            ) -> Framesync64StreamFull:
    """framesync64_stream with the payload FEC IN the block step: soft
    Golay codebook decode (the `codebook_argmax` kernel on the card),
    byte pack and CRC on the device (fec/device.py).  Reference analog:
    framesync64.c:411+ decodes the payload inline."""
    return Framesync64StreamFull(block_len, threshold, max_frames, name)


class Framesync64:
    """Callback-contract wrapper over the streaming Proc, the analog of
    the reference framesync64 object (create / execute / callback per
    frame, reference framesync64.c:66-120).  execute() takes any number
    of samples; the callback fires once per decoded frame with (header
    bytes, header_ok, payload bytes, payload_ok, stats dict).

    device: where the receiver runs (the card unless given; without one
    a CUDA device raises).  device_fec:
    the soft Golay decode, byte pack and CRC on that device over every
    candidate slot (the reference's soft criterion); False decodes each
    frame on the host by hard decisions."""

    def __init__(self, callback: Optional[Callable] = None,
                 block_len: int = 4096, threshold: float = 0.5,
                 device_fec: bool = True, device="cuda"):
        self.callback = callback
        self.block_len = int(block_len)
        self.device = entry_device(device)
        self._proc = framesync64_stream(self.block_len, threshold).to(
            self.device)
        self._carry = self._proc.init(device=self.device)
        self._pending = np.zeros(0, np.complex64)
        self.frames: list = []
        self.num_frames_detected = 0
        self._device_fec = device_fec
        if device_fec:
            dev, _ = qpacket_soft_decoder(72, "crc24", "none", "golay2412",
                                          "qpsk")
            self._fec = nn.Sequential(
                dev, device_packet_finish(72, "crc24", "none", "golay2412")
            ).to(self.device)

    def execute(self, x):
        """Consume samples; fire the callback per decoded frame.  A
        remainder shorter than block_len waits for the next call."""
        self._pending = np.concatenate(
            [self._pending, np.asarray(x, np.complex64)])
        results = []
        while len(self._pending) >= self.block_len:
            blk = torch.from_numpy(self._pending[:self.block_len].copy())
            self._pending = self._pending[self.block_len:]
            out, self._carry = self._proc(self._carry, blk.to(self.device))
            results.extend(self._drain(out))
        return results

    def flush(self):
        """Process buffered samples (zero-padded) plus enough zero blocks
        to flush frames still inside the history window."""
        tail = int(np.ceil((_HIST + self.block_len) / self.block_len))
        pad = (-len(self._pending)) % self.block_len + tail * self.block_len
        return self.execute(np.zeros(pad, np.complex64))

    def _drain(self, out: Frame64Block):
        o = Frame64Block(*(t.cpu().numpy() for t in out))
        res = []
        if self._device_fec and o.valid.any():
            # one batched decode over every candidate slot (invalid ones
            # are zeros in, masked out below)
            dec_all, ok_all = self._fec(out.symbols)
            dec_all = dec_all.cpu().numpy().astype(np.uint8)
            ok_all = ok_all.cpu().numpy()
        for p in range(len(o.valid)):
            if not o.valid[p]:
                continue
            self.num_frames_detected += 1
            if self._device_fec:
                payload_bytes, ok = dec_all[p], ok_all[p]
            else:
                payload_bytes, ok = qpacketmodem_decode(
                    o.symbols[p], 72, "crc24", "none", "golay2412", "qpsk")
            stats = {"rxy": float(o.rxy[p]),
                     "evm_db": float(o.evm_db[p]),
                     "rssi_db": float(20 * np.log10(max(o.gamma[p], 1e-12))),
                     "cfo": float(o.cfo[p]),
                     "sample_index": int(o.sample_index[p])}
            frame = (payload_bytes[:8].copy(), bool(ok),
                     payload_bytes[8:].copy(), bool(ok), stats)
            self.frames.append(frame)
            if self.callback is not None:
                self.callback(*frame)
            res.append(frame)
        return res
