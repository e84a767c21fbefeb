"""Error-detection codes: 8-bit checksum and CRC-8/16/24/32, as host
numpy (`liquid_dsp_tpu/fec/crc.py`).

Reference analog: src/fec/src/crc.c — checksum (two's-complement byte
sum), reflected CRCs with init ~0 / final ~, polynomials CRC8 0x07,
CRC16 0x8005, CRC24 0x5D6DCB, CRC32 0x04C11DB7.  Byte-level outputs
match the reference exactly (tests/golden/fec_golden.npz).  The CRC runs
a byte at a time through a 256-entry table: the same register updates as
the reference's bit loop, eight at once.
"""
from __future__ import annotations

import functools

import numpy as np

__all__ = ["CRC_SCHEMES", "crc_sizeof_key", "crc_generate_key",
           "crc_append_key", "crc_check_key", "crc_validate_message"]


def _reflect(v: int, width: int) -> int:
    out = 0
    for i in range(width):
        if v >> i & 1:
            out |= 1 << (width - 1 - i)
    return out


_PARAMS = {
    "crc8": (0x07, 8),
    "crc16": (0x8005, 16),
    "crc24": (0x5D6DCB, 24),
    "crc32": (0x04C11DB7, 32),
}

CRC_SCHEMES = ("none", "checksum") + tuple(_PARAMS)


def crc_sizeof_key(scheme: str) -> int:
    """Key length in bytes (reference crc.c crc_get_length)."""
    scheme = scheme.lower()
    if scheme == "none":
        return 0
    if scheme == "checksum":
        return 1
    return _PARAMS[scheme][1] // 8


@functools.lru_cache(maxsize=None)
def _table(rpoly: int):
    """T[i]: eight reflected shift/xor steps applied to the byte i."""
    out = []
    for i in range(256):
        key = i
        for _ in range(8):
            key = (key >> 1) ^ (rpoly if key & 1 else 0)
        out.append(key)
    return tuple(out)


def crc_generate_key(scheme: str, msg) -> int:
    """Compute the error-detection key over a byte array."""
    scheme = scheme.lower()
    msg = np.asarray(msg, np.uint8)
    if scheme == "none":
        return 0
    if scheme == "checksum":
        s = int(msg.astype(np.uint64).sum())
        return (~(s & 0xFF) + 1) & 0xFF
    poly, width = _PARAMS[scheme]
    table = _table(_reflect(poly, width))
    # init is a full 32-bit ~0 whose high ones shift down through the
    # register during the first bytes, as in the reference (crc.c:
    # `key=~0` in unsigned int arithmetic)
    key = 0xFFFFFFFF
    for b in msg.tolist():
        key = (key >> 8) ^ table[(key ^ b) & 0xFF]
    return (~key) & ((1 << width) - 1)


def crc_append_key(scheme: str, msg) -> np.ndarray:
    """Append the key (big-endian bytes) to the message
    (reference crc.c crc_append_key)."""
    key = crc_generate_key(scheme, msg)
    n = crc_sizeof_key(scheme)
    tail = [(key >> (8 * (n - 1 - i))) & 0xFF for i in range(n)]
    return np.concatenate([np.asarray(msg, np.uint8),
                           np.asarray(tail, np.uint8)])


def crc_validate_message(scheme: str, msg, key: int) -> bool:
    return crc_generate_key(scheme, msg) == key


def crc_check_key(scheme: str, msg_with_key) -> bool:
    """Validate a message with the key appended (reference crc_check_key)."""
    n = crc_sizeof_key(scheme)
    msg_with_key = np.asarray(msg_with_key, np.uint8)
    if n == 0:
        return True
    msg, tail = msg_with_key[:-n], msg_with_key[-n:]
    key = 0
    for b in tail.tolist():
        key = (key << 8) | int(b)
    return crc_validate_message(scheme, msg, key)
