"""Binary sequences: maximal-length (m-sequences / LFSR) and bit
sequences, as host numpy (`liquid_dsp_tpu/utils/sequence.py`).

Reference analog: src/sequence/src/msequence.c:41-196 (Fibonacci LFSR
with generator polynomial g stored without the implied leading bit,
default polynomials for m = 2..15) and bsequence.c.  Sequences are
design-time data (preambles, pilots, scramblers).
"""
from __future__ import annotations

import numpy as np

__all__ = ["MSEQUENCE_DEFAULT_POLY", "msequence_bits", "msequence_symbols",
           "bsequence_create_ccodes", "msequence_create_genpoly",
           "MSequence", "bsequence_correlate"]

# default generator polynomials / initial states per m
# (reference msequence.c:41-60 table: m, g, a)
MSEQUENCE_DEFAULT_POLY = {
    2: (0x0003, 0x0002),
    3: (0x0005, 0x0004),
    4: (0x0009, 0x0008),
    5: (0x0012, 0x0010),
    6: (0x0021, 0x0020),
    7: (0x0044, 0x0040),
    8: (0x008E, 0x0080),
    9: (0x0108, 0x0100),
    10: (0x0204, 0x0200),
    11: (0x0402, 0x0400),
    12: (0x0829, 0x0800),
    13: (0x100D, 0x1000),
    14: (0x2015, 0x2000),
    15: (0x4001, 0x4000),
}


class MSequence:
    """LFSR m-sequence generator (reference msequence_advance:166-177)."""

    def __init__(self, m: int, g: int | None = None, a: int | None = None):
        if g is None and a is None:
            if m not in MSEQUENCE_DEFAULT_POLY:
                raise ValueError(f"no default m-sequence for m={m}")
            g, a = MSEQUENCE_DEFAULT_POLY[m]     # already internal form
        else:
            # create semantics (reference msequence.c:133-151): clip the
            # implied MSB off g, bit-reverse the seed over m bits
            g = (g if g is not None else
                 (MSEQUENCE_DEFAULT_POLY[m][0] << 1) | 1) >> 1
            a_in = a if a is not None else 1
            a = 0
            for _ in range(m):
                a = (a << 1) | (a_in & 1)
                a_in >>= 1
        self.m = m
        self.g = g
        self.a = a
        self.n = (1 << m) - 1
        self.v = a

    def reset(self):
        self.v = self.a

    def advance(self) -> int:
        b = bin(self.v & self.g).count("1") & 1
        self.v = ((self.v << 1) | b) & self.n
        return b

    def generate_symbol(self, bps: int) -> int:
        s = 0
        for _ in range(bps):
            s = (s << 1) | self.advance()
        return s

    def get_state(self) -> int:
        """Shift-register state (reference msequence_get_state)."""
        return self.v

    def set_state(self, v: int):
        """Overwrite the shift register (reference msequence_set_state;
        state 0 locks the LFSR at zero, as there)."""
        self.v = v & self.n


def msequence_create_genpoly(g: int) -> MSequence:
    """An m-sequence from its full generator polynomial (reference
    msequence_create_genpoly): the polynomial's MSB sets m, the initial
    state is 1."""
    t = g.bit_length()
    if t < 2:
        raise ValueError(f"invalid generator polynomial: {g:#x}")
    return MSequence(t - 1, g=g, a=1)


def msequence_bits(m: int, n: int | None = None, g: int | None = None,
                   a: int | None = None) -> np.ndarray:
    """First n bits of the m-sequence (full period by default)."""
    seq = MSequence(m, g, a)
    n = seq.n if n is None else n
    return np.asarray([seq.advance() for _ in range(n)], np.uint8)


def msequence_symbols(m: int, count: int, bps: int) -> np.ndarray:
    """count symbols of bps bits each (reference
    msequence_generate_symbol)."""
    seq = MSequence(m)
    return np.asarray([seq.generate_symbol(bps) for _ in range(count)],
                      np.int64)


def bsequence_correlate(a, b) -> int:
    """Agreeing bits minus disagreeing bits (+-1 mapping)."""
    a = np.asarray(a, np.int8)
    b = np.asarray(b, np.int8)
    return int(np.sum((2 * a - 1) * (2 * b - 1)))


def bsequence_create_ccodes(num_bits: int):
    """Complementary (Golay) code pair of num_bits each (reference
    bsequence_create_ccodes, bsequence.c:284): byte-level doubling
    a -> [a b], b -> [a ~b] from the seeds 0xb8/0xb7, right-aligned.
    Returns (a_bits, b_bits) uint8 arrays."""
    if num_bits < 8 or num_bits % 8:
        raise ValueError("ccodes length must be a multiple of 8, >= 8")
    nb = num_bits // 8
    a = np.zeros(nb, np.uint8)
    b = np.zeros(nb, np.uint8)
    a[-1], b[-1] = 0xB8, 0xB7
    n = 1
    while n < nb:
        top = a[nb - n:].copy()
        bot = b[nb - n:].copy()
        a[nb - 2 * n: nb - n] = top
        a[nb - n:] = bot
        b[nb - 2 * n: nb - n] = top
        b[nb - n:] = bot ^ 0xFF
        n *= 2
    return np.unpackbits(a), np.unpackbits(b)
