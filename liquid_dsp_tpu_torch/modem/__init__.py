"""Modems, ported from `liquid_dsp_tpu.modem`: the linear family's tables
(numpy), its modulate / demodulate ops and Procs, DPSK, the
continuous-phase family (FSK, GMSK, CPFSK) and the analog modems (FM,
AM)."""
from .linear import (  # noqa: F401
    MODEM_SCHEMES, constellation, bits_per_symbol, gray_encode, gray_decode,
    modulate, demodulate, demodulate_soft, soft_to_hard, phase_error,
    modem_modulator, modem_demodulator, dpsk_modulator, dpsk_demodulator,
)
from .cpm import (  # noqa: F401
    fsk_modulator, fsk_demodulator, fsk_fft_size, fsk_frequency_error,
    gmsk_modulator, gmsk_demodulator, cpfsk_pulse, cpfsk_modulator,
    cpfsk_demodulator,
)
from .analog import (  # noqa: F401
    freq_modulator, freq_demodulator, amp_modulator, amp_demodulator,
)
