"""Reed-Solomon RS(255,223) over GF(2^8), host numpy as in the JAX
package (`liquid_dsp_tpu/fec/rs.py`).

Reference analog (studied, not copied): reference src/fec/src/fec_rs.c
:280-284 — symsize 8, generator poly 0x11d, fcr=1, prim=1, nroots=32
(delegated to external libfec in the reference; implemented natively
here).  Block framing mirrors fec_rs.c:192-239: a message of n bytes is
split into ceil(n/223) blocks padded at the front of each block.

Encode: polynomial LFSR division (vectorized over blocks).
Decode: syndromes -> Berlekamp-Massey -> Chien search -> Forney.
Host-side numpy (packet-scale data).
"""
from __future__ import annotations

import numpy as np

__all__ = ["rs_get_enc_msg_length", "rs_encode", "rs_decode",
           "GF_EXP", "GF_LOG"]

_PRIM_POLY = 0x11D
_NROOTS = 32
_NN = 255
_KK = _NN - _NROOTS  # 223
_FCR = 1

# GF(256) log/antilog tables
GF_EXP = np.zeros(512, np.int32)
GF_LOG = np.zeros(256, np.int32)
_x = 1
for _i in range(255):
    GF_EXP[_i] = _x
    GF_LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= _PRIM_POLY
GF_EXP[255:510] = GF_EXP[:255]


def _gf_mul(a, b):
    a = np.asarray(a, np.int32)
    b = np.asarray(b, np.int32)
    out = GF_EXP[(GF_LOG[a] + GF_LOG[b]) % 255]
    return np.where((a == 0) | (b == 0), 0, out)


def _gf_pow(a: int, n: int) -> int:
    if a == 0:
        return 0
    return int(GF_EXP[(GF_LOG[a] * n) % 255])


def _gf_inv(a):
    return GF_EXP[(255 - GF_LOG[np.asarray(a, np.int32)]) % 255]


def _gen_poly():
    """Generator polynomial prod (x - alpha^(fcr+i))."""
    g = np.array([1], np.int32)
    for i in range(_NROOTS):
        root = GF_EXP[(_FCR + i) % 255]
        g2 = np.zeros(len(g) + 1, np.int32)
        g2[:-1] ^= _gf_mul(g, root)
        g2[1:] ^= g
        g = g2
    return g[::-1].copy()  # descending: g[0] = 1 (monic leading)


_GPOLY = _gen_poly()
assert _GPOLY[0] == 1


def rs_get_enc_msg_length(dec_len: int) -> int:
    """ceil(n/223) blocks, each adding 32 parity bytes
    (reference fec_rs.c:192-239)."""
    nblk = -(-dec_len // _KK)
    return dec_len + nblk * _NROOTS


def _encode_block(msg: np.ndarray) -> np.ndarray:
    """Systematic encode: parity = remainder of msg * x^32 / g(x)."""
    k = len(msg)
    rem = np.zeros(_NROOTS, np.int32)
    for b in msg.astype(np.int32).tolist():
        fb = b ^ int(rem[0])
        rem = np.roll(rem, -1)
        rem[-1] = 0
        if fb:
            rem ^= _gf_mul(_GPOLY[1:], fb)
    return rem.astype(np.uint8)


def rs_encode(msg) -> np.ndarray:
    """Encode bytes; blocks of <=223 with 32 parity bytes each appended
    per block (short blocks = implicitly zero-padded at front)."""
    msg = np.asarray(msg, np.uint8)
    n = len(msg)
    nblk = -(-n // _KK)
    out = []
    # distribute message across blocks as evenly as the reference does:
    # each block gets dec_block_len = ceil(remaining/blocks) bytes
    start = 0
    for b in range(nblk):
        blk_len = -(-(n - start) // (nblk - b))
        blk = msg[start:start + blk_len]
        start += blk_len
        parity = _encode_block(blk)
        out.append(blk)
        out.append(parity)
    return np.concatenate(out) if out else msg.copy()


def _decode_block(code: np.ndarray) -> tuple:
    """Decode one block (data || parity); returns (data, ok)."""
    n = len(code)
    k = n - _NROOTS
    pad = _NN - n
    c = code.astype(np.int32)
    # syndromes S_i = C(alpha^(fcr+i)) with implicit front padding
    powers = np.arange(n - 1, -1, -1) + pad  # exponent of x per byte pos
    S = np.zeros(_NROOTS, np.int32)
    for i in range(_NROOTS):
        root_log = (_FCR + i) % 255
        expo = (powers * root_log) % 255
        terms = np.where(c == 0, 0, GF_EXP[(GF_LOG[c] + expo) % 255])
        S[i] = np.bitwise_xor.reduce(terms)
    if not S.any():
        return code[:k].astype(np.uint8), True

    # Berlekamp-Massey
    C = np.zeros(_NROOTS + 1, np.int32)
    B = np.zeros(_NROOTS + 1, np.int32)
    C[0] = B[0] = 1
    L, m, bb = 0, 1, 1
    for i in range(_NROOTS):
        d = S[i]
        for j in range(1, L + 1):
            d ^= int(_gf_mul(C[j], S[i - j]))
        if d == 0:
            m += 1
        elif 2 * L <= i:
            T = C.copy()
            coef = _gf_mul(d, _gf_inv(bb))
            C[m:] ^= _gf_mul(B[: _NROOTS + 1 - m], coef)
            L = i + 1 - L
            B = T
            bb = d
            m = 1
        else:
            coef = _gf_mul(d, _gf_inv(bb))
            C[m:] ^= _gf_mul(B[: _NROOTS + 1 - m], coef)
            m += 1
    if L > _NROOTS // 2:
        return code[:k].astype(np.uint8), False

    # Chien search over valid positions
    err_pos = []
    for pos in range(n):  # position in code array
        x_log = (255 - ((n - 1 - pos + pad) % 255)) % 255  # alpha^{-j}
        # evaluate C at alpha^{-j}
        val = 0
        for deg in range(L + 1):
            if C[deg]:
                val ^= int(GF_EXP[(GF_LOG[C[deg]] + deg * x_log) % 255])
        if val == 0:
            err_pos.append(pos)
    if len(err_pos) != L:
        return code[:k].astype(np.uint8), False

    # Forney: error magnitudes
    # Omega = S(x) * C(x) mod x^nroots
    Sx = S
    Om = np.zeros(_NROOTS, np.int32)
    for i in range(_NROOTS):
        acc = 0
        for j in range(min(i + 1, L + 1)):
            acc ^= int(_gf_mul(C[j], Sx[i - j]))
        Om[i] = acc
    c_fixed = c.copy()
    for pos in err_pos:
        j = (n - 1 - pos + pad) % 255          # exponent of the position
        xj_inv_log = (255 - j) % 255
        # Omega(x^-1_j)
        om = 0
        for deg in range(_NROOTS):
            if Om[deg]:
                om ^= int(GF_EXP[(GF_LOG[Om[deg]] + deg * xj_inv_log) % 255])
        # C'(x^-1_j) (formal derivative: odd-degree terms)
        cp = 0
        for deg in range(1, L + 1, 2):
            if C[deg]:
                cp ^= int(GF_EXP[(GF_LOG[C[deg]] +
                                  (deg - 1) * xj_inv_log) % 255])
        if cp == 0:
            return code[:k].astype(np.uint8), False
        mag = _gf_mul(om, _gf_inv(cp))
        # scale by x_j^(1-fcr): fcr=1 -> no extra factor
        c_fixed[pos] ^= int(mag)
    return c_fixed[:k].astype(np.uint8), True


def rs_decode(enc, dec_len: int):
    """Decode bytes; returns (msg, ok)."""
    enc = np.asarray(enc, np.uint8)
    nblk = -(-dec_len // _KK)
    out = []
    ok = True
    start_d = 0
    start_e = 0
    for b in range(nblk):
        blk_len = -(-(dec_len - start_d) // (nblk - b))
        code = enc[start_e: start_e + blk_len + _NROOTS]
        data, good = _decode_block(code)
        out.append(data)
        ok = ok and good
        start_d += blk_len
        start_e += blk_len + _NROOTS
    return (np.concatenate(out) if out else enc[:0]), ok
