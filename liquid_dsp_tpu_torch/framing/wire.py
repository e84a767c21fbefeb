"""Reference wire-format enum values, for byte-compatible frame headers
(a copy of `liquid_dsp_tpu/framing/wire.py`, numpy-free).

The flexframe (and ofdmflexframe) header control bytes carry the
reference library's enum values for the CRC / FEC / modulation schemes
(reference include/liquid.h:785-791 crc_scheme, :847-883 fec_scheme,
:5094-5142 modulation_scheme; packing at src/framing/src/
flexframegen.c:300-323).  These tables map those on-the-wire numbers to
our scheme names so frames interoperate with reference-built modems.
"""
from __future__ import annotations

__all__ = ["CRC_WIRE", "FEC_WIRE", "MODEM_WIRE",
           "crc_to_wire", "fec_to_wire", "modem_to_wire",
           "crc_from_wire", "fec_from_wire", "modem_from_wire"]

# index == reference enum value; None == reserved/unsupported slot
CRC_WIRE = [None, "none", "checksum", "crc8", "crc16", "crc24", "crc32"]

FEC_WIRE = [None, "none", "rep3", "rep5",
            "hamming74", "hamming84", "hamming128",
            "golay2412", "secded2216", "secded3932", "secded7264",
            "v27", "v29", "v39", "v615",
            "v27p23", "v27p34", "v27p45", "v27p56", "v27p67", "v27p78",
            "v29p23", "v29p34", "v29p45", "v29p56", "v29p67", "v29p78",
            "rs8"]

MODEM_WIRE = ([None] +
              [f"psk{1 << b}" for b in range(1, 9)] +
              [f"dpsk{1 << b}" for b in range(1, 9)] +
              [f"ask{1 << b}" for b in range(1, 9)] +
              [f"qam{1 << b}" for b in range(2, 9)] +
              [f"apsk{1 << b}" for b in range(2, 9)] +
              ["bpsk", "qpsk", "ook", "sqam32", "sqam128", "v29",
               "arb16opt", "arb32opt", "arb64opt", "arb128opt",
               "arb256opt", "arb64vt", "arb"])


def _to_wire(table, name, kind):
    try:
        return table.index(name.lower())
    except ValueError:
        raise ValueError(f"{kind} scheme {name!r} has no wire value")


def _from_wire(table, idx, kind):
    if 0 < idx < len(table) and table[idx] is not None:
        return table[idx]
    raise ValueError(f"invalid {kind} wire value {idx}")


def crc_to_wire(name):
    return _to_wire(CRC_WIRE, name, "crc")


def fec_to_wire(name):
    return _to_wire(FEC_WIRE, name, "fec")


def modem_to_wire(name):
    return _to_wire(MODEM_WIRE, name, "modulation")


def crc_from_wire(idx):
    return _from_wire(CRC_WIRE, idx, "crc")


def fec_from_wire(idx):
    return _from_wire(FEC_WIRE, idx, "fec")


def modem_from_wire(idx):
    return _from_wire(MODEM_WIRE, idx, "modulation")
