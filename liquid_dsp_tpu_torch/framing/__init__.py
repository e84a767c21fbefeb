"""Framing, ported from `liquid_dsp_tpu.framing`: packet modem and pilot
sync, preamble detection, the frame64 PHY pair, the streaming
preamble-sync receivers and the symbol tracker."""
from .qpacket import (  # noqa: F401
    qpacketmodem_frame_len, qpacketmodem_encode, qpacketmodem_decode,
    qpacketmodem_decode_soft, qpilot_pilots, qpilot_frame_len, qpilotgen,
    qpilotsync,
)
from .detector import qdetector_detect, make_template, DetectorResult  # noqa: F401
from .frame64 import (  # noqa: F401
    FRAME64_LEN, framegen64, framesync64, Frame64Result, frame64_preamble,
    framesync64_stream, framesync64_stream_full, Framesync64,
)
from .stream_rx import preamble_stream, detector_stream  # noqa: F401
from .symtrack import symtrack, SymtrackResult  # noqa: F401
from .symtrack import symtrack_stream, Symtrack  # noqa: F401
