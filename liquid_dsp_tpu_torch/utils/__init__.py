"""Host-side utilities, ported from `liquid_dsp_tpu.utils`: sequences
(numpy), random draws and the scrambler (numpy; `awgn` and `crandn` on
a torch generator)."""
from .sequence import (  # noqa: F401
    MSequence, msequence_bits, msequence_symbols, MSEQUENCE_DEFAULT_POLY,
    bsequence_correlate,
)
from .random import (  # noqa: F401
    randnf, crandnf, randexpf, randweibf, randgammaf, randnakmf,
    randricekf, scramble_data, unscramble_data, awgn, crandn,
)
