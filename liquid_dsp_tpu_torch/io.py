"""SDR sample IO: byte-stream IQ formats <-> float32 planes / complex64.

The capture formats of common SDR front-ends (reference liquid-dsp users
feed these through sox/rtl_sdr pipes; here they are first-class):

==========  =====================================  ==================
format      wire layout                            scale
==========  =====================================  ==================
``cu8``     uint8 I,Q interleaved (RTL-SDR)        (b - 127.5)/127.5
``cs8``     int8 I,Q interleaved (HackRF)          b/127
``cs16``    int16 I,Q interleaved (UHD sc16)       b/32767
``cf32``    float32 I,Q interleaved                1
==========  =====================================  ==================

The port takes the JAX package's numpy paths (`liquid_dsp_tpu/io.py`)
and equals them bit for bit; it has no native helper.  The JAX
package's native C helper (`liquid_dsp_tpu/native/iokit.c`) multiplies
by a float32 reciprocal where numpy divides, so the planes it reads
differ from these by up to 1 ulp (tests/test_torch_io_runtime.py).
Everything here is host numpy.  `iq_to_complex` / `complex_to_iq`
convert whole buffers; `iq_stream` yields fixed-size blocks shaped for
the streaming Proc pipeline (`runtime.StreamRunner` moves them to the
device).
"""
from __future__ import annotations

import pathlib
from typing import Iterator

import numpy as np

__all__ = ["IQ_FORMATS", "iq_to_planes", "planes_to_iq", "iq_to_complex",
           "complex_to_iq", "read_iq", "write_iq", "iq_stream"]

IQ_FORMATS = ("cu8", "cs8", "cs16", "cf32")

_DTYPES = {"cu8": np.uint8, "cs8": np.int8,
           "cs16": np.int16, "cf32": np.float32}


def _np_to_planes(raw: np.ndarray, fmt: str):
    i, q = raw[0::2].astype(np.float32), raw[1::2].astype(np.float32)
    if fmt == "cu8":
        return (i - 127.5) / 127.5, (q - 127.5) / 127.5
    if fmt == "cs8":
        return i / 127.0, q / 127.0
    if fmt == "cs16":
        return i / 32767.0, q / 32767.0
    return i, q


def _round_half_up(x):
    # iokit.c's unsigned path: (uint8)(x + 0.5f)
    return np.floor(np.asarray(x, np.float32) + np.float32(0.5))


def _round_half_away(x):
    # iokit.c's signed paths: trunc(x + (x>=0 ? 0.5 : -0.5))
    x = np.asarray(x, np.float32)
    return np.trunc(x + np.where(x >= 0, np.float32(0.5), np.float32(-0.5)))


def _np_from_planes(re: np.ndarray, im: np.ndarray, fmt: str):
    out = np.empty(2 * len(re), _DTYPES[fmt])
    if fmt == "cu8":
        out[0::2] = _round_half_up(np.clip(re * 127.5 + 127.5, 0, 255))
        out[1::2] = _round_half_up(np.clip(im * 127.5 + 127.5, 0, 255))
    elif fmt == "cs8":
        out[0::2] = _round_half_away(np.clip(re * 127.0, -127, 127))
        out[1::2] = _round_half_away(np.clip(im * 127.0, -127, 127))
    elif fmt == "cs16":
        out[0::2] = _round_half_away(np.clip(re * 32767.0, -32767, 32767))
        out[1::2] = _round_half_away(np.clip(im * 32767.0, -32767, 32767))
    else:
        out[0::2] = re
        out[1::2] = im
    return out


def iq_to_planes(data, fmt: str):
    """Raw IQ bytes/array -> (re, im) float32 planes."""
    if fmt not in IQ_FORMATS:
        raise ValueError(f"unknown IQ format {fmt!r}; expected one of "
                         f"{IQ_FORMATS}")
    raw = np.frombuffer(data, _DTYPES[fmt]) if isinstance(
        data, (bytes, bytearray, memoryview)) else \
        np.ascontiguousarray(data, _DTYPES[fmt]).reshape(-1)
    if len(raw) % 2:
        raise ValueError("IQ stream must have an even sample count")
    return _np_to_planes(raw, fmt)


def planes_to_iq(re, im, fmt: str) -> np.ndarray:
    """(re, im) float32 planes -> raw IQ sample array."""
    if fmt not in IQ_FORMATS:
        raise ValueError(f"unknown IQ format {fmt!r}; expected one of "
                         f"{IQ_FORMATS}")
    re = np.ascontiguousarray(re, np.float32)
    im = np.ascontiguousarray(im, np.float32)
    if re.shape != im.shape:
        raise ValueError("re/im plane shapes differ")
    return _np_from_planes(re, im, fmt)


def iq_to_complex(data, fmt: str) -> np.ndarray:
    re, im = iq_to_planes(data, fmt)
    return (re + 1j * im).astype(np.complex64)


def complex_to_iq(x, fmt: str) -> np.ndarray:
    x = np.asarray(x, np.complex64)
    return planes_to_iq(x.real, x.imag, fmt)


def read_iq(path, fmt: str, count: int = -1, offset: int = 0) -> np.ndarray:
    """Read complex64 samples from a raw capture file."""
    itemsize = np.dtype(_DTYPES[fmt]).itemsize
    raw = np.fromfile(str(path), _DTYPES[fmt], count=-1 if count < 0
                      else 2 * count, offset=2 * offset * itemsize)
    return iq_to_complex(raw, fmt)


def write_iq(path, x, fmt: str) -> None:
    """Write complex samples to a raw capture file."""
    complex_to_iq(x, fmt).tofile(str(path))


def iq_stream(path, fmt: str, block: int = 65536,
              pad_last: bool = True) -> Iterator[np.ndarray]:
    """Yield complex64 blocks of exactly `block` samples from a capture
    (last block zero-padded unless pad_last=False drops it) — sized for
    the fixed-shape streaming pipeline."""
    itemsize = np.dtype(_DTYPES[fmt]).itemsize
    path = pathlib.Path(path)
    with open(path, "rb") as f:
        while True:
            raw = f.read(2 * block * itemsize)
            if not raw:
                return
            n = len(raw) // (2 * itemsize)
            x = iq_to_complex(raw[: n * 2 * itemsize], fmt)
            if n < block:
                if not pad_last:
                    return
                x = np.concatenate([x, np.zeros(block - n, np.complex64)])
            yield x
