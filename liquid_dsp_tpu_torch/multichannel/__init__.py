"""Multichannel, ported from `liquid_dsp_tpu.multichannel`: the polyphase
filterbank channelizers (firpfbch, firpfbch2) and the OFDM PHY (frame
generator, one-shot synchronizer, streaming S0 detector and the
per-candidate demodulator)."""
from .channelizer import (  # noqa: F401
    firpfbch_kaiser_taps, firpfbch_analyzer, firpfbch_synthesizer,
    firpfbch2_analyzer, firpfbch2_synthesizer,
)
from .ofdm import (  # noqa: F401
    OFDMParams, ofdm_params, ofdm_generate_frame, ofdm_frame_sync,
    OFDMSyncResult, default_sctype,
)
