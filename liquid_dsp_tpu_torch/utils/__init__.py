"""Support utilities, ported from `liquid_dsp_tpu.utils`: sequences, random
draws and the scrambler, bits, polynomials, buffers and optimization as
host numpy (`awgn` and `crandn` on a torch generator); matrices,
quantization and the CVSD codec on torch (the codec's recurrence is the
`cvsd_scan` kernel); carry checkpoints for either package."""
from .sequence import (  # noqa: F401
    MSequence, msequence_bits, msequence_symbols, MSEQUENCE_DEFAULT_POLY,
    bsequence_correlate,
)
from .random import (  # noqa: F401
    randnf, crandnf, randexpf, randweibf, randgammaf, randnakmf,
    randricekf, scramble_data, unscramble_data, awgn, crandn,
)
from .matrix import (  # noqa: F401
    matrix_add, matrix_sub, matrix_mul, matrix_aug, matrix_trans,
    matrix_hermitian, matrix_transmul, matrix_multrans, matrix_inv,
    matrix_linsolve, matrix_cgsolve, matrix_ludecomp, matrix_qrdecomp,
    matrix_chol, matrix_gramschmidt, SMatrix,
)
from .poly import (  # noqa: F401
    poly_val, poly_fit, poly_fit_lagrange, poly_interp_lagrange,
    poly_expandroots, poly_findroots, poly_mul,
)
from .quantization import (  # noqa: F401
    compress_mulaw, expand_mulaw, compress_cf_mulaw, expand_cf_mulaw,
    quantize_adc, quantize_dac,
)
from .audio import cvsd_encode, cvsd_decode  # noqa: F401
from .optim import gradsearch, qnsearch, gasearch  # noqa: F401
from .buffer import Window, CBuffer, WDelay  # noqa: F401
from .checkpoint import save_carry, load_carry  # noqa: F401
