"""Linear modems (`liquid_dsp_tpu/modem/linear.py`): constellation tables
as host numpy, modulation and (soft) demodulation as torch ops.

Reference analog: the ``modem`` object (src/modem/src/modem_common.c),
which maps one symbol at a time through per-scheme functions.  Here
every scheme is a dense constellation TABLE indexed by the symbol:
modulation is a plain index into it (on the card a gather is fine; the
JAX package's one-hot matmul was a TPU workaround), hard demodulation a
nearest-point search, soft demodulation exact max-log LLRs over the
table.  The APSK, SQAM and arbitrary tables are read from the JAX
package's data file ``liquid_dsp_tpu/modem/_tables.npz`` by path.

The streaming Procs: `modem_modulator` and `modem_demodulator` (hard or
soft) around a table, and differential PSK (`dpsk_modulator` with an
integer phase accumulator, so that blocked streaming equals one shot;
`dpsk_demodulator` on the phase difference of consecutive samples).
"""
from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

from ..core import Proc

__all__ = ["MODEM_SCHEMES", "constellation", "bits_per_symbol",
           "gray_encode", "gray_decode", "modulate", "demodulate",
           "demodulate_soft", "soft_to_hard", "phase_error",
           "modem_modulator", "modem_demodulator", "dpsk_modulator",
           "dpsk_demodulator"]

_TABLES_NPZ = (pathlib.Path(__file__).resolve().parents[2]
               / "liquid_dsp_tpu" / "modem" / "_tables.npz")


@functools.lru_cache(maxsize=None)
def _tables():
    return dict(np.load(_TABLES_NPZ))


def gray_encode(x):
    """Binary -> Gray (reference modem_utilities.c:244)."""
    x = np.asarray(x)
    return x ^ (x >> 1)


def gray_decode(x):
    """Gray -> binary via prefix-xor (reference modem_utilities.c:250)."""
    out = np.asarray(x).copy()
    s = 1
    while True:
        shifted = out >> s
        if not shifted.any():
            break
        out = out ^ shifted
        s <<= 1
    return out


def _psk_table(m: int) -> np.ndarray:
    M = 1 << m
    return np.exp(2j * np.pi * gray_decode(np.arange(M)) / M
                  ).astype(np.complex64)


def _ask_table(m: int) -> np.ndarray:
    M = 1 << m
    alpha = np.sqrt(3.0 / (M * M - 1))
    return ((2 * gray_decode(np.arange(M)) - M + 1) * alpha
            ).astype(np.complex64)


def _qam_table(m: int) -> np.ndarray:
    M = 1 << m
    mi, mq = ((m + 1) >> 1, (m - 1) >> 1) if m % 2 else (m >> 1, m >> 1)
    Mi, Mq = 1 << mi, 1 << mq
    alpha = np.sqrt(3.0 / ((Mi * Mi - 1) + (Mq * Mq - 1)))
    s = np.arange(M)
    si = gray_decode(s >> mq)
    sq = gray_decode(s & (Mq - 1))
    return ((2 * si - Mi + 1) * alpha +
            1j * (2 * sq - Mq + 1) * alpha).astype(np.complex64)


def _apsk_table(m: int) -> np.ndarray:
    M = 1 << m
    t = _tables()
    p, r = t[f"apsk{M}_p"], t[f"apsk{M}_r"]
    phi, smap = t[f"apsk{M}_phi"], t[f"apsk{M}_map"]
    # point for ring-ordinal index s (reference modem_apsk.c:108-131)
    pts = np.zeros(M, np.complex64)
    edges = np.concatenate([[0], np.cumsum(p)])
    for level in range(len(p)):
        for k in range(p[level]):
            pts[edges[level] + k] = r[level] * np.exp(
                1j * (phi[level] + 2 * np.pi * k / p[level]))
    return pts[smap].astype(np.complex64)


def _sqam_table(quarter: np.ndarray, m: int) -> np.ndarray:
    s = np.arange(1 << m)
    quad = (s >> (m - 2)) & 0x3
    p = quarter[s & ((1 << (m - 2)) - 1)]
    out = np.where(quad == 0, p,
                   np.where(quad == 1, np.conj(p),
                            np.where(quad == 2, -np.conj(p), -p)))
    return out.astype(np.complex64)


def _arb_table(name: str) -> np.ndarray:
    pts = _tables()[name].astype(np.complex64)
    # I/Q balance then unity energy, both applied to every arbitrary table
    # (reference modem_arb.c:54,205-210)
    pts = pts - np.mean(pts)
    return pts / np.sqrt(np.mean(np.abs(pts) ** 2))


def _build_schemes():
    schemes = {}
    for m in range(1, 9):
        M = 1 << m
        schemes[f"psk{M}"] = (m, functools.partial(_psk_table, m))
        schemes[f"dpsk{M}"] = (m, functools.partial(_psk_table, m))
        schemes[f"ask{M}"] = (m, functools.partial(_ask_table, m))
        if M >= 4:
            schemes[f"qam{M}"] = (m, functools.partial(_qam_table, m))
            schemes[f"apsk{M}"] = (m, functools.partial(_apsk_table, m))
    schemes["bpsk"] = (1, lambda: np.array([1, -1], np.complex64))
    # bit0 -> real sign, bit1 -> imag sign (reference modem_qpsk.c:58-59)
    schemes["qpsk"] = (2, lambda: np.array(
        [1 + 1j, -1 + 1j, 1 - 1j, -1 - 1j], np.complex64)
        / np.float32(np.sqrt(2)))
    schemes["ook"] = (1, lambda: np.array([np.sqrt(2), 0], np.complex64))
    schemes["sqam32"] = (5, lambda: _sqam_table(
        _tables()["modem_arb_sqam32"], 5))
    schemes["sqam128"] = (7, lambda: _sqam_table(
        _tables()["modem_arb_sqam128"], 7))
    for name, m, key in (("v29", 4, "modem_arb_V29"),
                         ("arb16opt", 4, "modem_arb16opt"),
                         ("arb32opt", 5, "modem_arb32opt"),
                         ("arb64opt", 6, "modem_arb64opt"),
                         ("arb128opt", 7, "modem_arb128opt"),
                         ("arb256opt", 8, "modem_arb256opt"),
                         ("arb64vt", 6, "modem_arb_vt64")):
        schemes[name] = (m, functools.partial(_arb_table, key))
    return schemes


_SCHEMES = _build_schemes()
MODEM_SCHEMES = tuple(sorted(_SCHEMES))


def bits_per_symbol(scheme: str) -> int:
    return _SCHEMES[scheme.lower()][0]


@functools.lru_cache(maxsize=None)
def constellation(scheme: str) -> np.ndarray:
    """Constellation table [M] (host numpy): index = input symbol,
    value = TX point."""
    scheme = scheme.lower()
    if scheme.startswith("arb:"):
        raise ValueError("custom tables go to modulate/demodulate directly")
    m, build = _SCHEMES[scheme]
    table = build()
    assert len(table) == (1 << m)
    return table


def _table_on(table, like: torch.Tensor) -> torch.Tensor:
    """The table as a complex64 tensor on `like`'s device."""
    return torch.as_tensor(np.asarray(table, np.complex64)
                           if not torch.is_tensor(table) else table,
                           device=like.device).to(torch.complex64)


def modulate(table, syms: torch.Tensor) -> torch.Tensor:
    """Integer symbols [..., T] -> constellation points (a plain index)."""
    return _table_on(table, syms)[syms.long()]


def demodulate(table, y: torch.Tensor) -> torch.Tensor:
    """Nearest-point hard demodulation [..., T] -> int64 symbols: one
    |y - s|^2 metric over the whole table (exact ML slicing; the
    reference's per-scheme decision regions decide the same)."""
    tab = _table_on(table, y)
    # |y - s|^2 = |y|^2 - 2 Re(y conj(s)) + |s|^2; argmin drops |y|^2
    metric = (-2.0 * (y[..., None] * tab.conj()).real + tab.abs() ** 2)
    return torch.argmin(metric, dim=-1)


def demodulate_soft(table, y: torch.Tensor,
                    noise_var: float = 1.0) -> torch.Tensor:
    """Exact max-log LLR per bit: [..., T] -> [..., T, m] float32, MSB
    first; positive LLR -> bit 1:
    llr[b] = (min_{s: bit b=0} |y-s|^2 - min_{s: bit b=1} |y-s|^2) / N0."""
    tab = _table_on(table, y)
    M = tab.shape[0]
    m = int(np.log2(M))
    d2 = (y[..., None] - tab).abs() ** 2                 # [..., T, M]
    sym = np.arange(M)
    llrs = []
    for b in range(m - 1, -1, -1):
        one = torch.as_tensor((sym >> b) & 1 == 1, device=y.device)
        d0 = d2.masked_fill(one, float("inf")).amin(dim=-1)
        d1 = d2.masked_fill(~one, float("inf")).amin(dim=-1)
        llrs.append((d0 - d1) / noise_var)
    return torch.stack(llrs, dim=-1)


def soft_to_hard(llrs: torch.Tensor) -> torch.Tensor:
    """Pack per-bit LLRs [..., T, m] back into int32 symbols."""
    m = llrs.shape[-1]
    w = torch.tensor([1 << (m - 1 - i) for i in range(m)], dtype=torch.int32,
                     device=llrs.device)
    return ((llrs > 0).to(torch.int32) * w).sum(dim=-1, dtype=torch.int32)


def phase_error(table, y: torch.Tensor, syms: torch.Tensor) -> torch.Tensor:
    """The residual phase of y against its decided constellation point
    (what a PLL tracks; reference demod_phase_error)."""
    return torch.angle(y * modulate(table, syms).conj() + 1e-12)


class ModemModulator(Proc):
    """See `modem_modulator`."""

    param_spec = {"table": "table"}

    def __init__(self, table, name):
        super().__init__(name)
        self._buffer("table", np.asarray(table, np.complex64))

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return ()

    def forward(self, carry, s):
        return modulate(self.table, s), carry


def modem_modulator(scheme: str = None, table=None,
                    name: str = "modem_mod") -> ModemModulator:
    """Streaming modulator Proc: integer symbols [..., T] -> complex64."""
    return ModemModulator(constellation(scheme) if table is None else table,
                          name)


class ModemDemodulator(Proc):
    """See `modem_demodulator`."""

    param_spec = {"table": "table"}

    def __init__(self, table, soft, noise_var, name):
        super().__init__(name)
        self._buffer("table", np.asarray(table, np.complex64))
        self.soft, self.noise_var = bool(soft), float(noise_var)

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return ()

    def forward(self, carry, y):
        if self.soft:
            return demodulate_soft(self.table, y, self.noise_var), carry
        return demodulate(self.table, y), carry


def modem_demodulator(scheme: str = None, table=None, soft: bool = False,
                      noise_var: float = 1.0,
                      name: str = "modem_demod") -> ModemDemodulator:
    """Streaming hard (symbols) or soft (max-log LLRs [..., T, m])
    demodulator Proc."""
    return ModemDemodulator(constellation(scheme) if table is None
                            else table, soft, noise_var, name)


class DPSKModulator(Proc):
    """See `dpsk_modulator`."""

    def __init__(self, m, name):
        super().__init__(name)
        self.M = 1 << m
        self._buffer("lin", gray_decode(np.arange(self.M)).astype(np.int64))

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        # integer phase accumulator in units of 2*pi/M: exact, so blocked
        # streaming is bit-identical to one shot
        return torch.zeros(tuple(batch_shape), dtype=torch.int32,
                           device=device)

    def forward(self, carry, s):
        acc = torch.remainder(carry[..., None].to(torch.int64)
                              + torch.cumsum(self.lin[s.long()], dim=-1),
                              self.M)
        ph = (2 * np.pi / self.M) * acc.to(torch.float32)
        return (torch.complex(torch.cos(ph), torch.sin(ph)),
                acc[..., -1].to(torch.int32))


def dpsk_modulator(m: int, name: str = "dpsk_mod") -> DPSKModulator:
    """Differential PSK modulator: the phase accumulates per symbol
    (reference modem_dpsk.c:66-80).  Carry: the integer phase."""
    return DPSKModulator(m, name)


class DPSKDemodulator(Proc):
    """See `dpsk_demodulator`."""

    def __init__(self, m, name):
        super().__init__(name)
        self.M = 1 << m
        self._buffer("genc", gray_encode(np.arange(self.M)).astype(np.int64))

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return torch.zeros(tuple(batch_shape), dtype=torch.float32,
                           device=device)

    def forward(self, carry, y):
        theta = torch.angle(y)
        prev = torch.cat([carry[..., None], theta[..., :-1]], dim=-1)
        lin = torch.remainder(torch.round((theta - prev) * self.M
                                          / (2 * np.pi)), self.M)
        return self.genc[lin.long()].to(torch.int32), theta[..., -1]


def dpsk_demodulator(m: int, name: str = "dpsk_demod") -> DPSKDemodulator:
    """Differential PSK demodulator: the phase difference of consecutive
    samples sliced on the PSK grid (reference modem_dpsk.c:82-115).
    Carry: the last sample's phase."""
    return DPSKDemodulator(m, name)
