"""Port parity: byte packets (framing/bpacket.py) and utils/random.py of
liquid_dsp_tpu_torch against the reference C library's packets
(tests/golden/flexframe_golden.npz, bpkt_0 and bpkt_1) and the JAX
package.  All host numpy: packets byte-equal; the scrambler equal; the
samplers equal for the same numpy generator; the densities and
distributions within 1e-12 (the same float64 formulas)."""
import pathlib

import numpy as np
import pytest
import torch

import _torch_port as tp
from _golden_frames import lcg_bytes
from liquid_dsp_tpu.framing import bpacket as jbp
from liquid_dsp_tpu.utils import random as jrandom
from liquid_dsp_tpu_torch.fec.block import pack_bits, unpack_bits
from liquid_dsp_tpu_torch.framing import bpacket
from liquid_dsp_tpu_torch.utils import random

GOLDEN = pathlib.Path(__file__).parent / "golden" / "flexframe_golden.npz"
CASES = [(0, 32, "crc32", "none", "none"),
         (1, 50, "crc16", "hamming74", "rep3")]


@pytest.fixture(scope="module")
def fg():
    return dict(np.load(GOLDEN))


@pytest.mark.parametrize("ci,n,crc,fec0,fec1", CASES)
def test_bpacketgen_byte_exact(fg, ci, n, crc, fec0, fec1):
    payload = lcg_bytes(n, 131 + ci)
    mine = bpacket.bpacketgen(payload, crc=crc, fec0=fec0, fec1=fec1)
    np.testing.assert_array_equal(mine,
                                  np.real(fg[f"bpkt_{ci}"]).astype(np.uint8))
    np.testing.assert_array_equal(
        mine, jbp.bpacketgen(payload, crc=crc, fec0=fec0, fec1=fec1))


@pytest.mark.parametrize("ci,n,crc,fec0,fec1", CASES)
@pytest.mark.parametrize("shift", [0, 3, 7])
def test_bpacketsync_at_bit_offsets(fg, ci, n, crc, fec0, fec1, shift):
    payload = lcg_bytes(n, 131 + ci)
    ref = np.real(fg[f"bpkt_{ci}"]).astype(np.uint8)
    bits = np.concatenate([np.zeros(shift, np.uint8), unpack_bits(ref),
                           np.zeros((8 - shift) % 8 + 8, np.uint8)])
    data = pack_bits(bits)
    res = bpacket.bpacketsync(data)
    assert res.found and res.header_ok and res.crc_ok
    np.testing.assert_array_equal(res.payload, payload)
    want = jbp.bpacketsync(data)
    assert res[:3] == want[:3] and res.bit_offset == want.bit_offset
    np.testing.assert_array_equal(res.payload, want.payload)


def test_bpacket_conv_payload_and_misses():
    rng = np.random.default_rng(4)
    p = rng.integers(0, 256, 20).astype(np.uint8)
    pkt = bpacket.bpacketgen(p, "crc32", "v27", "none")
    np.testing.assert_array_equal(pkt, jbp.bpacketgen(p, "crc32", "v27",
                                                      "none"))
    res = bpacket.bpacketsync(np.concatenate([rng.integers(
        0, 256, 5).astype(np.uint8), pkt]))
    assert res.crc_ok and np.array_equal(res.payload, p)
    assert not bpacket.bpacketsync(np.zeros(40, np.uint8)).found


def test_correlators_and_detector_match_jax():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, 300)
    word = bits[100:140]
    np.testing.assert_allclose(bpacket.bsync_correlate(bits, word),
                               jbp.bsync_correlate(bits, word), atol=1e-6)
    s = tp.cnoise(rng, 64)
    x = (0.05 * tp.cnoise(rng, 1000)).astype(np.complex64)
    x[400:464] += s * np.exp(1j * 0.01 * np.arange(64))
    got = bpacket.bpresync_detect(x, s)
    want = jbp.bpresync_detect(x, s)
    assert got[:3] == want[:3] and abs(got[3] - want[3]) < 1e-6
    assert got[0] and got[1] == 400
    got = bpacket.detector_cccf_detect(x, s)
    want = jbp.detector_cccf_detect(x, s)
    assert got[:2] == want[:2] and abs(got[2] - want[2]) < 1e-6


def test_scrambler_matches_jax():
    rng = np.random.default_rng(1)
    d = rng.integers(0, 256, 37).astype(np.uint8)
    np.testing.assert_array_equal(random.scramble_data(d),
                                  jrandom.scramble_data(d))
    np.testing.assert_array_equal(random.unscramble_data(
        random.scramble_data(d)), d)
    soft = rng.integers(0, 256, (3, 8 * 9 + 5)).astype(np.uint8)
    np.testing.assert_array_equal(random.unscramble_data_soft(soft),
                                  jrandom.unscramble_data_soft(soft))
    np.testing.assert_array_equal(random._MASKS, jrandom._MASKS)


@pytest.mark.parametrize("name,args", [
    ("randf", ()), ("randnf", ()), ("crandnf", ()), ("randexpf", (1.5,)),
    ("randweibf", (1.2, 0.7, 0.1)), ("randgammaf", (2.0, 1.5)),
    ("randnakmf", (1.5, 2.0)), ("randricekf", (3.0, 1.0))])
def test_samplers_match_jax(name, args):
    got = getattr(random, name)(*args, rng=np.random.default_rng(5),
                                size=(4, 9))
    want = getattr(jrandom, name)(*args, rng=np.random.default_rng(5),
                                  size=(4, 9))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,args", [
    ("randf_pdf", ()), ("randf_cdf", ()), ("randnf_pdf", (0.3, 1.2)),
    ("randnf_cdf", (0.3, 1.2)), ("randexpf_pdf", (1.5,)),
    ("randexpf_cdf", (1.5,)), ("randweibf_pdf", (1.2, 0.7, 0.1)),
    ("randweibf_cdf", (1.2, 0.7, 0.1)), ("randgammaf_pdf", (2.0, 1.5)),
    ("randgammaf_cdf", (2.0, 1.5)), ("randnakmf_pdf", (1.5, 2.0)),
    ("randnakmf_cdf", (1.5, 2.0)), ("randricekf_pdf", (3.0, 1.0)),
    ("randricekf_cdf", (3.0, 1.0))])
def test_densities_match_jax(name, args):
    x = np.linspace(-0.5, 4.0, 37)
    got = np.asarray(getattr(random, name)(x, *args), np.float64)
    want = np.asarray(getattr(jrandom, name)(x, *args), np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_awgn_on_a_generator():
    g = torch.Generator().manual_seed(3)
    x = torch.ones(20000, dtype=torch.complex64)
    y = random.awgn(g, x, 0.2)
    assert y.dtype == torch.complex64
    assert abs(float((y - x).abs().pow(2).mean()) - 0.04) < 2e-3
    g2 = torch.Generator().manual_seed(3)
    assert torch.equal(random.crandn(g2, (5,)),
                       random.crandn(torch.Generator().manual_seed(3), (5,)))
