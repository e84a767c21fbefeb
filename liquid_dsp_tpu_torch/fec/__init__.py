"""Forward error correction, ported from `liquid_dsp_tpu.fec`: CRC, block
and convolutional codes, Reed-Solomon, interleaver and packetizer as host
numpy; the device soft decode (`device.py`) and the batched LDPC decoder
(`ldpc.py`) on torch."""
from .crc import (  # noqa: F401
    CRC_SCHEMES, crc_sizeof_key, crc_generate_key, crc_append_key,
    crc_check_key, crc_validate_message,
)
from .dispatch import (  # noqa: F401
    FEC_SCHEMES, CONV_SCHEMES, fec_get_enc_msg_length, fec_encode,
    fec_decode, fec_get_rate,
)
from .block import unpack_bits, pack_bits  # noqa: F401
from .conv import PUNCTURE_MATRICES  # noqa: F401
from .rs import rs_encode, rs_decode, rs_get_enc_msg_length  # noqa: F401
from .interleave import (  # noqa: F401
    interleave, deinterleave, interleave_soft, deinterleave_soft,
    interleaver_dims,
)
from .packetizer import (  # noqa: F401
    packetizer_compute_enc_msg_len, packetizer_compute_dec_msg_len,
    packetizer_encode, packetizer_decode, packetizer_decode_soft,
)
