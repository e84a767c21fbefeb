"""FEC dispatch across scheme families (`liquid_dsp_tpu/fec/dispatch.py`;
reference src/fec/src/fec.c fec_create/encode/decode dispatch).

The port has the block family (`block.py`).  Convolutional codes and
Reed-Solomon raise NotImplementedError: they are ROADMAP queue 1 items 4b
(`fec/conv.py`) and 5c (`fec/rs.py`).  Their scheme names are known, so
every length query on them says so too.
"""
from __future__ import annotations

import numpy as np

from . import block as _block

__all__ = ["FEC_SCHEMES", "CONV_SCHEMES", "fec_get_enc_msg_length",
           "fec_encode", "fec_decode", "fec_decode_soft", "fec_get_rate"]

# the reference's convolutional scheme names (liquid_dsp_tpu/fec/conv.py)
_CONV_BASES = ("v27", "v29", "v39", "v615")
_PUNCTURE = ("p23", "p34", "p45", "p56", "p67", "p78")
CONV_SCHEMES = _CONV_BASES + tuple(f"{b}{p}" for b in ("v27", "v29")
                                   for p in _PUNCTURE)
FEC_SCHEMES = _block.FEC_SCHEMES + CONV_SCHEMES + ("rs8",)


def _unported(scheme: str):
    if scheme in CONV_SCHEMES:
        return NotImplementedError(
            f"{scheme!r}: convolutional codes are not ported yet "
            "(ROADMAP queue 1 item 4b, fec/conv.py)")
    if scheme == "rs8":
        return NotImplementedError(
            "'rs8': Reed-Solomon is not ported yet (ROADMAP queue 1 "
            "item 5c, fec/rs.py)")
    return None


def fec_get_enc_msg_length(scheme: str, dec_len: int) -> int:
    scheme = scheme.lower()
    err = _unported(scheme)
    if err is not None:
        raise err
    return _block.fec_get_enc_msg_length(scheme, dec_len)


def fec_encode(scheme: str, msg) -> np.ndarray:
    scheme = scheme.lower()
    err = _unported(scheme)
    if err is not None:
        raise err
    return _block.fec_encode(scheme, msg)


def fec_decode(scheme: str, enc, dec_len: int) -> np.ndarray:
    scheme = scheme.lower()
    err = _unported(scheme)
    if err is not None:
        raise err
    return _block.fec_decode(scheme, enc, dec_len)


def fec_decode_soft(scheme: str, llr, dec_len: int) -> np.ndarray:
    """Soft-decision decode where the scheme supports it (reference
    fec_decode_soft, fec.c): Hamming/Golay run the maximum-correlation
    codeword search, repetition codes sum the metrics, other schemes
    slice hard.  llr: metrics of the ENCODED bits (positive = 1)."""
    scheme = scheme.lower()
    err = _unported(scheme)
    if err is not None:
        raise err
    llr = np.asarray(llr, np.float32)
    if scheme in _block._GCOLS:
        return _block._block_decode_soft(scheme, llr, dec_len)
    if scheme in ("rep3", "rep5"):
        return _block._rep_decode_soft(int(scheme[3]), llr, dec_len)
    hard = _block.pack_bits((llr > 0).astype(np.uint8))
    n_enc = fec_get_enc_msg_length(scheme, dec_len)
    return fec_decode(scheme, hard[:n_enc], dec_len)


def fec_get_rate(scheme: str) -> float:
    return 1024 / fec_get_enc_msg_length(scheme, 1024)
