"""Modems, ported from `liquid_dsp_tpu.modem`: the linear family's tables
(numpy) and its modulate / demodulate ops (torch)."""
from .linear import (  # noqa: F401
    MODEM_SCHEMES, constellation, bits_per_symbol, gray_encode, gray_decode,
    modulate, demodulate, demodulate_soft, soft_to_hard,
)
