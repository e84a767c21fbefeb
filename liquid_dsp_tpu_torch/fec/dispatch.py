"""FEC dispatch across scheme families (`liquid_dsp_tpu/fec/dispatch.py`;
reference src/fec/src/fec.c fec_create/encode/decode dispatch).

Three families, all host numpy: the block codes (`block.py`), the
convolutional codes (`conv.py`) and Reed-Solomon (`rs.py`, scheme
``rs8``).
"""
from __future__ import annotations

import numpy as np

from . import block as _block
from . import conv as _conv
from . import rs as _rs
from .conv import CONV_SCHEMES

__all__ = ["FEC_SCHEMES", "CONV_SCHEMES", "fec_get_enc_msg_length",
           "fec_encode", "fec_decode", "fec_decode_soft", "fec_get_rate"]

FEC_SCHEMES = _block.FEC_SCHEMES + CONV_SCHEMES + ("rs8",)


def fec_get_enc_msg_length(scheme: str, dec_len: int) -> int:
    scheme = scheme.lower()
    if scheme in CONV_SCHEMES:
        return _conv.conv_get_enc_msg_length(scheme, dec_len)
    if scheme == "rs8":
        return _rs.rs_get_enc_msg_length(dec_len)
    return _block.fec_get_enc_msg_length(scheme, dec_len)


def fec_encode(scheme: str, msg) -> np.ndarray:
    scheme = scheme.lower()
    if scheme in CONV_SCHEMES:
        return _conv.conv_encode(scheme, msg)
    if scheme == "rs8":
        return _rs.rs_encode(msg)
    return _block.fec_encode(scheme, msg)


def fec_decode(scheme: str, enc, dec_len: int) -> np.ndarray:
    scheme = scheme.lower()
    if scheme in CONV_SCHEMES:
        return _conv.conv_decode(scheme, enc, dec_len)
    if scheme == "rs8":
        return _rs.rs_decode(enc, dec_len)[0]
    return _block.fec_decode(scheme, enc, dec_len)


def fec_decode_soft(scheme: str, llr, dec_len: int) -> np.ndarray:
    """Soft-decision decode where the scheme supports it (reference
    fec_decode_soft, fec.c): convolutional codes run the soft Viterbi,
    Hamming/Golay the maximum-correlation codeword search, repetition
    codes sum the metrics, other schemes slice hard.  llr: metrics of the
    ENCODED bits (positive = 1)."""
    scheme = scheme.lower()
    llr = np.asarray(llr, np.float32)
    if scheme in CONV_SCHEMES:
        return _conv.conv_decode(scheme, None, dec_len, soft=llr)
    if scheme in _block._GCOLS:
        return _block._block_decode_soft(scheme, llr, dec_len)
    if scheme in ("rep3", "rep5"):
        return _block._rep_decode_soft(int(scheme[3]), llr, dec_len)
    hard = _block.pack_bits((llr > 0).astype(np.uint8))
    n_enc = fec_get_enc_msg_length(scheme, dec_len)
    return fec_decode(scheme, hard[:n_enc], dec_len)


def fec_get_rate(scheme: str) -> float:
    return 1024 / fec_get_enc_msg_length(scheme, 1024)
