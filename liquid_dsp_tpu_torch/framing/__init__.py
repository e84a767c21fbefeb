"""Framing, ported from `liquid_dsp_tpu.framing`: packet modem and pilot
sync, preamble detection, the frame64, flexframe, GMSK and OFDM flexframe
PHY pairs with their streaming receivers, byte packets (bpacket), the
reference's header wire format, the symbol tracker and the signal
sources."""
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
from .flexframe import (  # noqa: F401
    FLEXFRAME_H_USER, flexframegen, flexframesync, FlexFrameResult,
    flexframesync_stream, flexframe_rx_stream, flexframe_rx_stream_multi,
    FlexStreamBlock, FlexMultiStreamBlock, FlexFrameSync,
)
from .wire import (  # noqa: F401
    crc_to_wire, fec_to_wire, modem_to_wire, crc_from_wire, fec_from_wire,
    modem_from_wire,
)
from .gmskframe import (  # noqa: F401
    GMSKFRAME_H_USER, gmskframegen, gmskframesync, GMSKFrameResult,
    GMSKFrameSync, gmskframe_rx_stream, GMSKStreamBlock,
)
from .bpacket import (  # noqa: F401
    bpacketgen, bpacketsync, BPacketResult, bsync_correlate,
    bpresync_detect, detector_cccf_detect,
)
from .ofdmflexframe import (  # noqa: F401
    ofdmflexframegen, ofdmflexframesync, OFDMFlexResult, OFDMFlexFrameSync,
    OFDMFLEXFRAME_H_USER,
)
from .ofdmflex_stream import (  # noqa: F401
    ofdmflex_rx_stream, OFDMFlexStreamBlock, OFDMFlexStreamRX,
)
from .sources import (  # noqa: F401
    symstream, msource, Symstream, Msource, FrameSyncStats, FrameDataStats,
)
