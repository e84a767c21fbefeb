"""Signal sources: symstream (shaped modem symbol stream) and msource
(multi-signal mixer), plus frame statistics containers
(`liquid_dsp_tpu/framing/sources.py`), as host numpy.

Reference analogs (studied, not copied):
  * symstream — src/framing/src/symstream.c:33+: random modem symbols
    pulse-shaped by an interpolating rnyquist filter at k samples/symbol.
  * msource — src/framing/src/msource.c:57-182: mixer of independent
    sources (tone, noise, modem symstream), each with its own gain and
    center frequency.
  * framesyncstats / framedatastats — src/framing/src/framesyncstats.c:
    per-frame EVM/RSSI/CFO record and aggregate counters.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..design.firdes import firdes_kaiser, firdes_prototype
from ..modem.linear import constellation

__all__ = ["symstream", "msource", "Symstream", "Msource",
           "FrameSyncStats", "FrameDataStats"]


class Symstream:
    """Streaming pulse-shaped symbol source (the reference symstreamcf
    object contract: create once, generate() indefinitely, state —
    interpolator tail + RNG — survives across calls).

    Reference analog (studied, not copied): symstreamcf
    src/framing/src/symstream.c:33+ (_write_samples fills any request
    length from an internal symbol-rate buffer).

    Generation is host numpy: sources feed test and benchmark pipelines,
    which move the samples to the device themselves."""

    def __init__(self, ftype: str = "arkaiser", k: int = 2, m: int = 7,
                 beta: float = 0.3, ms: str = "qpsk", gain_db: float = 0.0,
                 seed: int = 0):
        self._k = int(k)
        self._taps = firdes_prototype(ftype, k, m, beta).astype(np.float32)
        self._table = np.asarray(constellation(ms)).astype(np.complex64)
        self._rng = np.random.default_rng(seed)
        self.set_gain(gain_db)
        self.reset()

    def reset(self):
        self._tail = np.zeros(len(self._taps) - 1, np.complex64)
        self._pending = np.zeros(0, np.complex64)

    def set_gain(self, gain_db: float):
        self._gain = float(10.0 ** (gain_db / 20.0))

    def get_gain(self) -> float:
        return 20.0 * np.log10(self._gain)

    def _fill(self, n_sym: int):
        """Shape n_sym fresh random symbols through the interpolator,
        carrying the convolution tail (overlap-add) across calls."""
        idx = self._rng.integers(0, len(self._table), n_sym)
        xz = np.zeros(n_sym * self._k, np.complex64)
        xz[:: self._k] = self._table[idx]
        y = np.convolve(xz, self._taps).astype(np.complex64)
        y[: len(self._tail)] += self._tail
        self._tail = y[len(xz):]
        self._pending = np.concatenate([self._pending, y[: len(xz)]])

    def generate(self, n_samples: int) -> np.ndarray:
        """Produce exactly n_samples (any length; reference
        symstreamcf_write_samples).  Internal generation always happens
        in fixed 512-symbol blocks so the sample stream is BIT-EXACT
        regardless of how requests are chunked."""
        while len(self._pending) < n_samples:
            self._fill(512)
        out, self._pending = (self._pending[:n_samples],
                              self._pending[n_samples:])
        return (self._gain * out).astype(np.complex64)


def symstream(n_samples: int, ftype: str = "arkaiser", k: int = 2,
              m: int = 7, beta: float = 0.3, ms: str = "qpsk",
              seed: int = 0) -> np.ndarray:
    """One-shot convenience wrapper over Symstream (reference
    symstreamcf_create_linear + _write_samples)."""
    if n_samples % k:
        raise ValueError(f"symstream length {n_samples} must be a "
                         f"multiple of k={k}")
    return Symstream(ftype, k, m, beta, ms, seed=seed).generate(n_samples)


class _MSrc:
    """One msource slot: generator + mixer state (phase-continuous)."""

    def __init__(self, kind, gen, fc, gain_db):
        self.kind = kind
        self.gen = gen            # callable(n) -> complex64[n]
        self.fc = float(fc)       # cycles/sample
        self.gain = float(10.0 ** (gain_db / 20.0))
        self.phase = 0.0          # mixer phase accumulator (radians)
        self.enabled = True


class Msource:
    """Streaming multi-signal source: add/remove sources at runtime,
    per-source gain/frequency/enable control, indefinite block
    generation.

    Reference analog (studied, not copied): msourcecf
    src/framing/src/msource.c:57-182 (add_tone/add_noise/add_modem/
    add_user, remove_source, set_gain, set_frequency, enable/disable,
    write_samples).  Frequencies are cycles/sample (the reference uses
    radians/sample; multiply by 2*pi to convert).  Each source carries
    its own mixer phase accumulator, so generation is phase-continuous
    across calls and across set_frequency updates."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._next_id = 0
        self._srcs: dict = {}

    # -- source management (reference msource.c:57-182) ----------------
    def _add(self, src: "_MSrc") -> int:
        sid = self._next_id
        self._next_id += 1
        self._srcs[sid] = src
        return sid

    def add_tone(self, fc: float = 0.0, gain_db: float = 0.0) -> int:
        return self._add(_MSrc(
            "tone", lambda n: np.ones(n, np.complex64), fc, gain_db))

    def add_noise(self, fc: float = 0.0, bandwidth: float = 1.0,
                  gain_db: float = 0.0) -> int:
        """Complex white noise, optionally bandlimited (reference
        msourcecf_add_noise shapes noise with an interp filter)."""
        rng = np.random.default_rng(self._seed + 17 * self._next_id)
        if bandwidth >= 1.0:
            def gen(n, rng=rng):
                return ((rng.standard_normal(n) + 1j *
                         rng.standard_normal(n)) / np.sqrt(2)
                        ).astype(np.complex64)
        else:
            h = firdes_kaiser(max(4 * int(4 / bandwidth) + 1, 33),
                              bandwidth / 2, 60.0).astype(np.float32)
            h = h / np.sqrt(np.sum(h ** 2))   # unit noise power out
            tail = np.zeros(len(h) - 1, np.complex64)

            def gen(n, rng=rng, h=h, box=[tail]):
                w = ((rng.standard_normal(n) + 1j *
                      rng.standard_normal(n)) / np.sqrt(2))
                y = np.convolve(w, h).astype(np.complex64)
                y[: len(box[0])] += box[0]
                box[0] = y[n:]
                return y[:n]
        return self._add(_MSrc("noise", gen, fc, gain_db))

    def add_modem(self, fc: float = 0.0, gain_db: float = 0.0,
                  ms: str = "qpsk", k: int = 2, m: int = 7,
                  beta: float = 0.3, ftype: str = "arkaiser") -> int:
        st = Symstream(ftype, k, m, beta, ms,
                       seed=self._seed + 17 * self._next_id)
        return self._add(_MSrc("modem", st.generate, fc, gain_db))

    def add_user(self, gen, fc: float = 0.0, gain_db: float = 0.0) -> int:
        """gen: callable(n) -> complex samples (reference add_user)."""
        return self._add(_MSrc("user", gen, fc, gain_db))

    def remove(self, sid: int):
        del self._srcs[sid]

    @property
    def num_sources(self) -> int:
        return len(self._srcs)

    # -- per-source control --------------------------------------------
    def enable(self, sid: int):
        self._srcs[sid].enabled = True

    def disable(self, sid: int):
        self._srcs[sid].enabled = False

    def set_gain(self, sid: int, gain_db: float):
        self._srcs[sid].gain = float(10.0 ** (gain_db / 20.0))

    def get_gain(self, sid: int) -> float:
        return 20.0 * np.log10(self._srcs[sid].gain)

    def set_frequency(self, sid: int, fc: float):
        """New center frequency takes effect at the next sample; the
        phase accumulator keeps the waveform continuous."""
        self._srcs[sid].fc = float(fc)

    def get_frequency(self, sid: int) -> float:
        return self._srcs[sid].fc

    # -- generation -----------------------------------------------------
    def generate(self, n_samples: int) -> np.ndarray:
        """Mix all enabled sources for the next n_samples (reference
        msourcecf_write_samples)."""
        n = int(n_samples)
        out = np.zeros(n, np.complex64)
        for src in self._srcs.values():
            if not src.enabled:
                continue
            sig = np.asarray(src.gen(n), np.complex64)
            ph = src.phase + 2 * np.pi * src.fc * np.arange(n)
            out += (src.gain * sig * np.exp(1j * ph)).astype(np.complex64)
            src.phase = float((src.phase + 2 * np.pi * src.fc * n)
                              % (2 * np.pi))
        return out


def msource(n_samples: int, sources=(), seed: int = 0) -> np.ndarray:
    """One-shot convenience wrapper over Msource (reference msourcecf):

    sources: list of dicts with key 'kind' in {'tone','noise','modem'},
    and optional 'gain_db' (default 0), 'fc' (center frequency,
    cycles/sample, default 0), 'bandwidth' (noise), plus modem kwargs
    (ms, k, m, beta, ftype).
    """
    q = Msource(seed=seed)
    for src in sources:
        kind = src["kind"]
        g = src.get("gain_db", 0.0)
        fc = src.get("fc", 0.0)
        if kind == "tone":
            q.add_tone(fc, g)
        elif kind == "noise":
            q.add_noise(fc, src.get("bandwidth", 1.0), g)
        elif kind == "modem":
            q.add_modem(fc, g, src.get("ms", "qpsk"), src.get("k", 2),
                        src.get("m", 7), src.get("beta", 0.3),
                        src.get("ftype", "arkaiser"))
        else:
            raise ValueError(f"unknown msource kind {kind!r}")
    return q.generate(n_samples)


@dataclass
class FrameSyncStats:
    """Per-frame statistics (reference framesyncstats_s)."""
    evm: float = 0.0          # error vector magnitude [dB]
    rssi: float = 0.0         # received signal strength [dB]
    cfo: float = 0.0          # carrier frequency offset [rad/sample]
    mod_scheme: str = ""      # modulation scheme
    check: str = ""           # CRC scheme
    fec0: str = ""
    fec1: str = ""


@dataclass
class FrameDataStats:
    """Aggregate frame counters (reference framedatastats_s)."""
    num_frames_detected: int = 0
    num_headers_valid: int = 0
    num_payloads_valid: int = 0
    num_bytes_received: int = 0

    def update(self, header_ok: bool, payload_ok: bool, n_bytes: int):
        self.num_frames_detected += 1
        self.num_headers_valid += int(header_ok)
        self.num_payloads_valid += int(payload_ok)
        if payload_ok:
            self.num_bytes_received += n_bytes

    def reset(self):
        self.num_frames_detected = 0
        self.num_headers_valid = 0
        self.num_payloads_valid = 0
        self.num_bytes_received = 0
