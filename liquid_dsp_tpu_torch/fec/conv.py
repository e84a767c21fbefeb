"""Convolutional codes: the v27/v29/v39/v615 encoders with Viterbi
decoding and the punctured rate-1/2 variants, as host numpy
(`liquid_dsp_tpu/fec/conv.py`).

Reference analog: src/fec/src/fec_conv.c (encode shift-register loop
:76-118 with K-1 flush bits; decode delegates to libfec's Viterbi),
puncture matrices fec_conv_pmatrix.c:26-98, byte lengths fec.c:225-241
(unpunctured: r*n + ceil((K-1)*r/8) bytes; punctured: nn + ceil(nn/p)
bits, nn = 8n+K-1).

Polynomials are libfec's generators in the left-shift register
convention (sr = (sr << 1) | bit; output = parity(sr & poly)):
  v27  K=7  r=1/2: 0x6D, 0x4F
  v29  K=9  r=1/2: 0x1AF, 0x11D
  v39  K=9  r=1/3: 0x1ED, 0x19B, 0x127
  v615 K=15 r=1/6: octal 42631, 47245, 56507, 73363, 77267, 64537
MSB-first packing throughout.

`conv_decode` is the host Viterbi: a loop over time, vectorized over the
2^(K-1) states, with the JAX package's rules (its scatter-max scan):
path metrics start at -1e9 except state 0, are never normalized, a next
state's metric is at least -1e9, and on a tie the smaller flat branch
index (predecessor * 2 + bit) wins.  The batched device decoder with
the `viterbi_acs` kernel is `fec/device.py:conv_soft_decoder`.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from .block import pack_bits, unpack_bits

__all__ = ["CONV_SCHEMES", "conv_get_enc_msg_length", "conv_encode",
           "conv_decode", "conv_depuncture_index", "PUNCTURE_MATRICES"]

_POLYS = {
    "v27": (7, (0x6D, 0x4F)),
    "v29": (9, (0x1AF, 0x11D)),
    "v39": (9, (0x1ED, 0x19B, 0x127)),
    "v615": (15, (0o42631, 0o47245, 0o56507, 0o73363, 0o77267, 0o64537)),
}
_PUNCTURABLE = ("v27", "v29")  # the reference punctures the r=1/2 codes

# puncture matrices (reference fec_conv_pmatrix.c:26-98), row-major
# [rate_num rows of output streams x period columns]
PUNCTURE_MATRICES = {
    "p23": [[1, 1], [1, 0]],
    "p34": [[1, 1, 0], [1, 0, 1]],
    "p45": [[1, 1, 1, 1], [1, 0, 0, 0]],
    "p56": [[1, 1, 0, 1, 0], [1, 0, 1, 0, 1]],
    "p67": [[1, 1, 1, 0, 1, 0], [1, 0, 0, 1, 0, 1]],
    "p78": [[1, 1, 1, 1, 0, 1, 0], [1, 0, 0, 0, 1, 0, 1]],
}
_P29 = {  # the K=9 variants differ (fec_conv_pmatrix.c:63-98)
    "p23": [[1, 1], [1, 0]],
    "p34": [[1, 1, 1], [1, 0, 0]],
    "p45": [[1, 1, 0, 1], [1, 0, 1, 0]],
    "p56": [[1, 0, 1, 1, 0], [1, 1, 0, 0, 1]],
    "p67": [[1, 1, 0, 1, 1, 0], [1, 0, 1, 0, 0, 1]],
    "p78": [[1, 1, 0, 1, 0, 1, 1], [1, 0, 1, 0, 1, 0, 0]],
}

CONV_SCHEMES = tuple(
    [b for b in _POLYS] +
    [f"{b}{p}" for b in _PUNCTURABLE for p in PUNCTURE_MATRICES])

_NEG = np.float32(-1e9)       # the start metric of every state but 0


def _parse(scheme: str):
    scheme = scheme.lower()
    base = next((b for b in ("v615", "v39", "v29", "v27")
                 if scheme.startswith(b)), None)
    if base is None:
        raise ValueError(f"unknown convolutional scheme {scheme!r}")
    K, polys = _POLYS[base]
    pmat = None
    if len(scheme) > len(base):
        tag = scheme[len(base):]
        table = _P29 if base == "v29" else PUNCTURE_MATRICES
        if base not in _PUNCTURABLE or tag not in table:
            raise ValueError(f"unknown puncturing {tag!r}")
        pmat = np.asarray(table[tag], np.uint8)
    return K, polys, pmat


def _parity_bits(v: np.ndarray) -> np.ndarray:
    """Bitwise parity of each element (vectorized popcount & 1)."""
    v = v.astype(np.uint32)
    v ^= v >> 16
    v ^= v >> 8
    v ^= v >> 4
    v ^= v >> 2
    v ^= v >> 1
    return (v & 1).astype(np.uint8)


def conv_get_enc_msg_length(scheme: str, dec_len: int) -> int:
    """Encoded bytes, the reference's formulas: unpunctured
    ceil(r*(8n+K-1)/8) (fec.c:225-228, e.g. v27 -> 2n+2, v615 -> 6n+11);
    punctured nn + ceil(nn/p) bits with nn = 8n+K-1 (fec.c:324-331)."""
    K, polys, pmat = _parse(scheme)
    nn = 8 * dec_len + K - 1
    if pmat is None:
        nbits_out = len(polys) * nn
    else:
        nbits_out = nn + -(-nn // pmat.shape[1])
    return -(-nbits_out // 8)


def _keep_mask(pmat: np.ndarray, n: int) -> np.ndarray:
    """[n, r] bool: which encoder outputs survive the puncturing, the
    matrix's columns repeated along time (column-major in time)."""
    period, r = pmat.shape[1], pmat.shape[0]
    return np.resize(pmat.T, ((-(-n // period)) * period, r))[:n] \
        .astype(bool)


def conv_encode(scheme: str, msg) -> np.ndarray:
    """Encode a byte array; returns encoded bytes (MSB-first packing)."""
    K, polys, pmat = _parse(scheme)
    bits = unpack_bits(np.asarray(msg, np.uint8))
    # K-1 flush bits, like the reference (fec_conv.c tail loop :107-118)
    bits = np.concatenate([bits, np.zeros(K - 1, np.uint8)])
    n = len(bits)
    # the shift register's history: a sliding window of the last K bits
    padded = np.concatenate([np.zeros(K - 1, np.uint8), bits])
    win = np.lib.stride_tricks.sliding_window_view(padded, K)  # [n, K]
    weights = 1 << np.arange(K - 1, -1, -1)
    sr = (win * weights).sum(axis=1).astype(np.uint32)
    enc = np.stack([_parity_bits(sr & p) for p in polys], axis=1)  # [n, r]
    if pmat is not None:
        enc = enc.reshape(-1)[_keep_mask(pmat, n).reshape(-1)]
    return pack_bits(enc.reshape(-1))


def conv_depuncture_index(scheme: str, dec_len: int) -> np.ndarray:
    """The flat (t * r + stream) position of every transmitted encoder
    output, in order: the static scatter that depunctures the received
    metrics into [8*dec_len + K - 1, r] with zeros (erasures) elsewhere."""
    K, polys, pmat = _parse(scheme)
    nbits_in = 8 * dec_len + K - 1
    if pmat is None:
        return np.arange(nbits_in * len(polys), dtype=np.int64)
    return np.nonzero(_keep_mask(pmat, nbits_in).reshape(-1))[0]


@lru_cache(maxsize=None)
def _trellis(K: int, polys):
    """Branch output bits per (state, input): state = previous K-1 bits.
    Returns (out [ns, 2, r] uint8, next state [ns, 2] int32)."""
    ns = 1 << (K - 1)
    s = np.arange(ns, dtype=np.uint32)
    out = np.zeros((ns, 2, len(polys)), np.uint8)
    nxt = np.zeros((ns, 2), np.int32)
    for b in (0, 1):
        sr = (s << 1) | b  # K-bit register
        for r, p in enumerate(polys):
            out[:, b, r] = _parity_bits(sr & p)
        nxt[:, b] = (sr & (ns - 1)).astype(np.int32)
    return out, nxt


def conv_decode(scheme: str, enc, dec_len: int, soft=None) -> np.ndarray:
    """Viterbi decode to dec_len bytes.

    soft: optional float metrics per encoded bit (positive = bit 1); when
    given, `enc` is ignored.  Punctured bits are depunctured as erasures
    (zero metric).
    """
    K, polys, pmat = _parse(scheme)
    r = len(polys)
    nbits_in = 8 * dec_len + K - 1  # payload + flush (matches encode)
    if soft is None:
        ebits = unpack_bits(np.asarray(enc, np.uint8))
        metrics = 2.0 * ebits.astype(np.float32) - 1.0  # +-1, + = bit 1
    else:
        metrics = np.asarray(soft, np.float32)
    idx = conv_depuncture_index(scheme, dec_len)
    k = min(len(idx), len(metrics))
    flat = np.zeros(nbits_in * r, np.float32)
    flat[idx[:k]] = metrics[:k]
    obs = flat.reshape(nbits_in, r)

    out, _ = _trellis(K, tuple(polys))
    ns = out.shape[0]
    half = ns >> 1
    exp = (2.0 * out.astype(np.float32) - 1.0)          # [ns, 2, r]
    nxt = np.arange(ns)
    p0 = nxt >> 1                   # predecessors of next state s':
    p1 = p0 + half                  # flat branches s' and s' + ns
    b = nxt & 1
    e0, e1 = exp[p0, b], exp[p1, b]                     # [ns, r]
    pm = np.full(ns, _NEG, np.float32)
    pm[0] = 0.0
    decisions = np.empty((nbits_in, ns), np.int64)
    for t in range(nbits_in):
        # branch metric: the correlation of the observed metrics with the
        # expected +-1 outputs, summed over the streams in index order
        bm0, bm1 = e0[:, 0] * obs[t, 0], e1[:, 0] * obs[t, 0]
        for i in range(1, r):
            bm0 = bm0 + e0[:, i] * obs[t, i]
            bm1 = bm1 + e1[:, i] * obs[t, i]
        c0, c1 = pm[p0] + bm0, pm[p1] + bm1
        # scatter-max into a -1e9 floor; the first (smallest flat index)
        # winner, or the sentinel 2*ns when the floor won
        new = np.maximum(np.maximum(c0, c1), _NEG)
        decisions[t] = np.where(c0 == new, nxt,
                                np.where(c1 == new, nxt + ns, 2 * ns))
        pm = new.astype(np.float32)

    # traceback from state 0 (flushed); an out-of-range state indexes the
    # last one, as the JAX gather clamps
    bits = np.empty(nbits_in, np.uint8)
    state = 0
    for t in range(nbits_in - 1, -1, -1):
        fl = int(decisions[t, min(state, ns - 1)])
        bits[t] = fl & 1
        state = fl >> 1
    return pack_bits(bits[: 8 * dec_len])[:dec_len]
