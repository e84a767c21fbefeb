"""Multichannel, ported from `liquid_dsp_tpu.multichannel`: the polyphase
filterbank channelizers (firpfbch, firpfbch2).  OFDM is ROADMAP queue 1
item 4d."""
from .channelizer import (  # noqa: F401
    firpfbch_kaiser_taps, firpfbch_analyzer, firpfbch_synthesizer,
    firpfbch2_analyzer, firpfbch2_synthesizer,
)
