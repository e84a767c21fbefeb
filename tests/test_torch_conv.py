"""Port parity: the convolutional codes of liquid_dsp_tpu_torch
(fec/conv.py, the conv half of fec/dispatch.py and the packetizer, the
device decoders of fec/device.py on `viterbi_acs`'s plain version)
against the JAX package, on the same seeded inputs.

Tolerance: equal bytes and equal bits everywhere.  The host Viterbi keeps
the JAX package's scan rules (no normalization, a -1e9 floor, the
smallest flat branch index on ties) and the device decoder its device
rules (the max subtracted each step, the strict compare), so both decode
what the JAX package decodes, also on erasures and all-zero metrics,
where every early step is a tie."""
import zlib

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (torch thread cap)
import jax
import jax.numpy as jnp
from liquid_dsp_tpu.fec import conv as jconv
from liquid_dsp_tpu.fec import device as jdevice
from liquid_dsp_tpu.fec import dispatch as jdispatch
from liquid_dsp_tpu.fec import packetizer as jpkt
from liquid_dsp_tpu_torch.fec import conv, device, dispatch, packetizer

SCHEMES = list(jconv.CONV_SCHEMES)
DEVICE_SCHEMES = [s for s in SCHEMES if not s.startswith("v615")]


def _seed(*parts) -> int:
    return zlib.crc32("-".join(map(str, parts)).encode())


def _llr(rng, bits, sigma):
    """+-4 metrics of the bits plus noise of std `sigma`; all zeros for
    sigma None (every branch metric 0, every step a tie)."""
    bits = np.asarray(bits, np.float32)
    if sigma is None:
        return np.zeros_like(bits)
    return ((2 * bits - 1) * 4.0 + sigma * rng.standard_normal(bits.shape)
            ).astype(np.float32)


def test_scheme_names_equal():
    assert conv.CONV_SCHEMES == jconv.CONV_SCHEMES
    assert dispatch.CONV_SCHEMES == jconv.CONV_SCHEMES
    assert dispatch.FEC_SCHEMES == jdispatch.FEC_SCHEMES


@pytest.mark.parametrize("scheme", SCHEMES)
def test_encode_and_length_match_jax(scheme):
    rng = np.random.default_rng(_seed("enc", scheme))
    for n in (1, 7, 32):
        msg = rng.integers(0, 256, n).astype(np.uint8)
        np.testing.assert_array_equal(conv.conv_encode(scheme, msg),
                                      jconv.conv_encode(scheme, msg))
        assert conv.conv_get_enc_msg_length(scheme, n) == \
            jconv.conv_get_enc_msg_length(scheme, n)
        assert dispatch.fec_get_rate(scheme) == jdispatch.fec_get_rate(scheme)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_host_decode_matches_jax(scheme):
    # hard and soft at two noise levels and on all-zero metrics; v615 at
    # dec_len 6 (tests/test_fec.py decodes it at 8)
    rng = np.random.default_rng(_seed("dec", scheme))
    n = 6 if scheme.startswith("v615") else 12
    msg = rng.integers(0, 256, n).astype(np.uint8)
    enc = conv.conv_encode(scheme, msg)
    bits = np.unpackbits(enc)
    noisy = bits.copy()
    noisy[np.arange(3, len(bits), 97)] ^= 1
    hard = np.packbits(noisy)[:len(enc)]
    got = dispatch.fec_decode(scheme, hard, n)
    np.testing.assert_array_equal(got, jdispatch.fec_decode(scheme, hard, n))
    if "p" not in scheme:       # sparse errors: the unpunctured codes fix them
        np.testing.assert_array_equal(got, msg)
    for sigma in (0.8, 3.0, None):
        llr = _llr(rng, bits, sigma)
        got = dispatch.fec_decode_soft(scheme, llr, n)
        np.testing.assert_array_equal(
            got, jdispatch.fec_decode_soft(scheme, llr, n))
        if sigma == 0.8:
            np.testing.assert_array_equal(got, msg)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_depuncture_index_matches_jax(scheme):
    # the JAX package's static scatter (fec/device.py:204-211, the same
    # indices as its host decode's depuncture)
    K, polys, pmat = jconv._parse(scheme)
    for dec_len in (1, 5, 68):
        nbits_in = 8 * dec_len + K - 1
        if pmat is None:
            want = np.arange(nbits_in * len(polys))
        else:
            period = pmat.shape[1]
            keep = np.resize(pmat.T, ((-(-nbits_in // period)) * period,
                                      len(polys)))[:nbits_in]
            want = np.nonzero(keep.astype(bool).reshape(-1))[0]
        got = conv.conv_depuncture_index(scheme, dec_len)
        np.testing.assert_array_equal(got, want)
        assert len(got) <= 8 * conv.conv_get_enc_msg_length(scheme, dec_len)


@pytest.mark.parametrize("cfg", [("crc32", "v27", "none"),
                                 ("crc16", "none", "v29p34"),
                                 ("checksum", "v39", "none"),
                                 ("crc24", "v27p78", "hamming74"),
                                 ("crc8", "golay2412", "v29")])
def test_packetizer_with_a_conv_stage_matches_jax(cfg):
    rng = np.random.default_rng(_seed("pkt", *cfg))
    msg = rng.integers(0, 256, 19).astype(np.uint8)
    enc = packetizer.packetizer_encode(msg, *cfg)
    np.testing.assert_array_equal(enc, jpkt.packetizer_encode(msg, *cfg))
    assert packetizer.packetizer_compute_enc_msg_len(19, *cfg) == len(enc)
    got = packetizer.packetizer_decode(enc, 19, *cfg)
    np.testing.assert_array_equal(got[0], msg)
    assert got[1]
    llr = _llr(rng, np.unpackbits(enc), 1.5)
    got = packetizer.packetizer_decode_soft(llr, 19, *cfg)
    want = jpkt.packetizer_decode_soft(llr, 19, *cfg)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.parametrize("scheme", DEVICE_SCHEMES)
def test_conv_soft_decoder_matches_jax_device_fn(scheme):
    # N = 6 codewords: three noise levels, all-zero metrics and, for the
    # last two rows, erasures (zero metrics) over a stretch of bits
    rng = np.random.default_rng(_seed("dev", scheme))
    n = 9
    jfn, enc_len = jdevice.conv_soft_decoder(scheme, n)
    fn, enc_len2 = device.conv_soft_decoder(scheme, n)
    assert enc_len == enc_len2
    msgs = rng.integers(0, 256, (6, n)).astype(np.uint8)
    bits = np.stack([np.unpackbits(conv.conv_encode(scheme, m))
                     for m in msgs])
    llr = np.stack([_llr(rng, bits[0], 0.8), _llr(rng, bits[1], 2.0),
                    _llr(rng, bits[2], 4.0), _llr(rng, bits[3], None),
                    _llr(rng, bits[4], 1.0), _llr(rng, bits[5], 1.0)])
    llr[4:, 20:44] = 0.0
    got = fn(torch.from_numpy(llr)).numpy()
    want = np.asarray(jax.jit(jfn)(jnp.asarray(llr)))
    assert got.shape == (6, 8 * n) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.packbits(got[0].astype(np.uint8)),
                                  msgs[0])


@pytest.mark.parametrize("crc,fec0,fec1,ms", [
    ("crc32", "v27", "none", None), ("crc16", "none", "v29p34", None),
    ("checksum", "v27p78", "none", None), ("crc32", "v39", "none", "qpsk"),
    ("crc24", "v29", "none", "qam16")])
def test_conv_packet_decoders_match_jax(crc, fec0, fec1, ms):
    # the packet decoders (deinterleave gather + Viterbi; with `ms` the
    # soft demodulator in front) through device_packet_finish and through
    # the host finish: the JAX package's bits, payloads and CRC verdicts
    rng = np.random.default_rng(_seed("pkt-dev", crc, fec0, fec1, ms))
    pl = 21
    payloads = rng.integers(0, 256, (3, pl)).astype(np.uint8)
    bits = np.stack([np.unpackbits(jpkt.packetizer_encode(p, crc, fec0,
                                                          fec1))
                     for p in payloads])
    if ms is None:
        x = np.stack([_llr(rng, bits[0], 1.0), _llr(rng, bits[1], 2.5),
                      _llr(rng, bits[2], 8.0)])
        jfn, jfin = jdevice.conv_packet_soft_decoder(pl, crc, fec0, fec1)
        fn, fin = device.conv_packet_soft_decoder(pl, crc, fec0, fec1)
    else:
        from liquid_dsp_tpu_torch.modem.linear import (bits_per_symbol,
                                                       constellation)
        bps = bits_per_symbol(ms)
        pad = (-bits.shape[1]) % bps
        sym = np.pad(bits, ((0, 0), (0, pad))).reshape(3, -1, bps)
        idx = (sym * (1 << np.arange(bps - 1, -1, -1))).sum(-1)
        x = constellation(ms)[idx]
        x = (x + 0.25 * (rng.standard_normal(x.shape)
                         + 1j * rng.standard_normal(x.shape))
             ).astype(np.complex64)
        jfn, jfin = jdevice.qpacket_conv_soft_decoder(pl, crc, fec0, fec1,
                                                      ms)
        fn, fin = device.qpacket_conv_soft_decoder(pl, crc, fec0, fec1, ms)
    want = np.asarray(jax.jit(jfn)(jnp.asarray(x)))
    got = fn(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    pay, ok = device.device_packet_finish(pl, crc, fec0, fec1)(got)
    jpay, jok = jdevice.device_packet_finish(pl, crc, fec0, fec1)(
        jnp.asarray(want))
    np.testing.assert_array_equal(pay.numpy(), np.asarray(jpay))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    hp, hok = fin(got.numpy())
    jhp, jhok = jfin(want)
    np.testing.assert_array_equal(hp, jhp)
    np.testing.assert_array_equal(hok, jhok)
    clean = 1 if ms is None else 3      # the rows at low noise
    assert hok[:clean].all()
    np.testing.assert_array_equal(hp[:clean], payloads[:clean])
