"""Bit-manipulation utilities, host numpy as in the JAX package
(`liquid_dsp_tpu/utils/bits.py`; reference src/utility/: pack_bytes.c,
bshift_array.c, count_bits.c, msb_index.c).

These are host-side byte wrangling — numpy vectorized where the shape
allows, plain loops where the reference semantics are inherently
sequential (sub-byte packing at arbitrary offsets).
"""
from __future__ import annotations

import numpy as np

__all__ = ["repack_bytes", "pack_array", "unpack_array",
           "unpack_soft_bits", "count_ones", "count_ones_mod2",
           "msb_index", "lbshift", "rbshift", "lbcircshift", "rbcircshift",
           "bdotprod", "count_leading_zeros", "print_bitstring",
           "count_bit_errors", "count_bit_errors_array",
           "reverse_byte", "reverse_uint16", "reverse_uint24",
           "reverse_uint32", "lshift", "rshift", "lcircshift",
           "rcircshift"]


def repack_bytes(sym_in, bps_in: int, bps_out: int) -> np.ndarray:
    """Repack symbols of bps_in bits into symbols of bps_out bits,
    MSB-first across the concatenated bit stream (reference
    liquid_repack_bytes; the final output symbol is left-aligned with
    zero padding, pack_bytes.c tail handling)."""
    sym_in = np.asarray(sym_in, np.uint8)
    bits = ((sym_in[:, None] >> np.arange(bps_in - 1, -1, -1)) & 1
            ).reshape(-1)
    n_out = -(-len(bits) // bps_out)
    bits = np.concatenate([bits,
                           np.zeros(n_out * bps_out - len(bits), np.uint8)])
    w = (1 << np.arange(bps_out - 1, -1, -1)).astype(np.uint32)
    return (bits.reshape(n_out, bps_out) @ w).astype(np.uint8)


def pack_array(dst: np.ndarray, k: int, b: int, sym: int) -> None:
    """Pack a b-bit symbol into byte array dst at bit index k, in place
    (reference liquid_pack_array)."""
    dst = np.asarray(dst)
    n = len(dst) * 8
    if k >= n:
        raise ValueError("bit index exceeds array length")
    if b > 8:
        raise ValueError("symbol size cannot exceed 8 bits")
    b_eff = min(b, n - k)
    for j in range(b_eff):
        bit = (sym >> (b_eff - 1 - j)) & 1
        idx = k + j
        byte, off = divmod(idx, 8)
        mask = 1 << (7 - off)
        if bit:
            dst[byte] |= mask
        else:
            dst[byte] &= 0xFF ^ mask


def unpack_array(src, k: int, b: int) -> int:
    """Extract a b-bit symbol from byte array src at bit index k
    (reference liquid_unpack_array)."""
    src = np.asarray(src, np.uint8)
    n = len(src) * 8
    if k >= n:
        raise ValueError("bit index exceeds array length")
    b_eff = min(b, n - k)
    sym = 0
    for j in range(b_eff):
        idx = k + j
        byte, off = divmod(idx, 8)
        sym = (sym << 1) | ((int(src[byte]) >> (7 - off)) & 1)
    return sym


def unpack_soft_bits(sym: int, bps: int) -> np.ndarray:
    """Hard symbol -> soft bit bytes 0x00/0xFF, MSB first (reference
    liquid_unpack_soft_bits)."""
    return np.asarray([(0xFF if (sym >> (bps - 1 - i)) & 1 else 0x00)
                       for i in range(bps)], np.uint8)


def count_ones(x: int) -> int:
    """Population count (reference liquid_count_ones)."""
    return bin(int(x) & 0xFFFFFFFF).count("1")


def count_ones_mod2(x: int) -> int:
    """Parity (reference liquid_count_ones_mod2)."""
    return count_ones(x) & 1


def msb_index(x: int) -> int:
    """Index of the most significant set bit, 1-based; 0 for x == 0
    (reference liquid_msb_index)."""
    return int(x).bit_length()


def _bytes_to_bits(src) -> np.ndarray:
    return np.unpackbits(np.asarray(src, np.uint8))


def _bits_to_bytes(bits) -> np.ndarray:
    return np.packbits(np.asarray(bits, np.uint8))


def lbshift(src, b: int) -> np.ndarray:
    """Left bit-shift of a byte array by b bits, zero-filled (reference
    liquid_lbshift)."""
    bits = _bytes_to_bits(src)
    out = np.concatenate([bits[b:], np.zeros(b, np.uint8)])
    return _bits_to_bytes(out)


def rbshift(src, b: int) -> np.ndarray:
    """Right bit-shift of a byte array by b bits, zero-filled (reference
    liquid_rbshift)."""
    bits = _bytes_to_bits(src)
    out = np.concatenate([np.zeros(b, np.uint8), bits[: len(bits) - b]])
    return _bits_to_bytes(out)


def lbcircshift(src, b: int) -> np.ndarray:
    """Left circular bit-shift (reference liquid_lbcircshift)."""
    bits = _bytes_to_bits(src)
    return _bits_to_bytes(np.roll(bits, -b))


def rbcircshift(src, b: int) -> np.ndarray:
    """Right circular bit-shift (reference liquid_rbcircshift)."""
    bits = _bytes_to_bits(src)
    return _bits_to_bytes(np.roll(bits, b))


def bdotprod(x: int, y: int) -> int:
    """Binary dot product: parity of x & y (reference liquid_bdotprod)."""
    return count_ones_mod2(int(x) & int(y))


def count_leading_zeros(x: int) -> int:
    """Leading zeros in a 32-bit word (reference
    liquid_count_leading_zeros)."""
    return 32 - int(x).bit_length() if x else 32


def print_bitstring(x: int, n: int) -> str:
    """n-bit binary string, MSB first (reference liquid_print_bitstring
    prints; here the string is returned)."""
    return format(int(x) & ((1 << n) - 1), f"0{n}b")


def reverse_byte(x: int) -> int:
    """Bit-reverse one byte (reference liquid_reverse_byte table)."""
    return int(f"{int(x) & 0xFF:08b}"[::-1], 2)


def _reverse_uint(x: int, bits: int) -> int:
    return int(format(int(x) & ((1 << bits) - 1), f"0{bits}b")[::-1], 2)


def reverse_uint16(x: int) -> int:
    """Bit-reverse a 16-bit word (reference liquid_reverse_uint16)."""
    return _reverse_uint(x, 16)


def reverse_uint24(x: int) -> int:
    """Bit-reverse a 24-bit word (reference liquid_reverse_uint24)."""
    return _reverse_uint(x, 24)


def reverse_uint32(x: int) -> int:
    """Bit-reverse a 32-bit word (reference liquid_reverse_uint32)."""
    return _reverse_uint(x, 32)


def lshift(src, n: int) -> np.ndarray:
    """Byte-level left shift by n bytes, zero-filled (reference
    liquid_lshift)."""
    src = np.asarray(src, np.uint8)
    out = np.zeros_like(src)
    if n < len(src):
        out[: len(src) - n] = src[n:]
    return out


def rshift(src, n: int) -> np.ndarray:
    """Byte-level right shift by n bytes, zero-filled (reference
    liquid_rshift)."""
    src = np.asarray(src, np.uint8)
    out = np.zeros_like(src)
    if n < len(src):
        out[n:] = src[: len(src) - n]
    return out


def lcircshift(src, n: int) -> np.ndarray:
    """Byte-level left circular shift (reference liquid_lcircshift)."""
    return np.roll(np.asarray(src, np.uint8), -int(n))


def rcircshift(src, n: int) -> np.ndarray:
    """Byte-level right circular shift (reference liquid_rcircshift)."""
    return np.roll(np.asarray(src, np.uint8), int(n))


def count_bit_errors(a: int, b: int) -> int:
    """Hamming distance between two words (reference
    src/utility/src/utility.c count_bit_errors)."""
    return count_ones(a ^ b)


def count_bit_errors_array(a, b) -> int:
    """Total bit errors between two byte arrays (reference
    count_bit_errors_array)."""
    a = np.asarray(a, np.uint8)
    b = np.asarray(b, np.uint8)
    if a.shape != b.shape:
        raise ValueError("arrays must have the same shape")
    return int(np.unpackbits(a ^ b).sum())
