"""Port parity: the host FEC of liquid_dsp_tpu_torch (CRC, interleaver,
block codes, packetizer) is byte-exact against the reference C library's
goldens (tests/golden/fec_golden.npz) and the JAX package, and the device
soft decode (fec/device.py) gives the JAX package's message indices,
bytes and CRC verdicts exactly."""
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (torch thread cap)
import jax
import jax.numpy as jnp
from liquid_dsp_tpu.fec import block as jblock
from liquid_dsp_tpu.fec import crc as jcrc
from liquid_dsp_tpu.fec import device as jdevice
from liquid_dsp_tpu.fec import dispatch as jdispatch
from liquid_dsp_tpu.fec import packetizer as jpkt
from liquid_dsp_tpu.fec.conv import CONV_SCHEMES as J_CONV_SCHEMES
from liquid_dsp_tpu.fec.interleave import (deinterleave_soft as
                                           j_deinterleave_soft)
from liquid_dsp_tpu_torch.fec import (crc_append_key, crc_check_key,
                                      crc_generate_key, deinterleave,
                                      deinterleave_soft, fec_decode,
                                      fec_encode, fec_get_enc_msg_length,
                                      interleave, interleave_soft,
                                      packetizer_compute_dec_msg_len,
                                      packetizer_compute_enc_msg_len,
                                      packetizer_decode,
                                      packetizer_decode_soft,
                                      packetizer_encode)
from liquid_dsp_tpu_torch.fec import block, device, dispatch

from test_fec import GOLDEN_SCHEMES, _mask_tail, ref_msg


@pytest.fixture(scope="module")
def fg():
    import pathlib
    return dict(np.load(pathlib.Path(__file__).parent
                        / "golden/fec_golden.npz"))


def test_crc_golden_keys(fg):
    msg = ref_msg(16)
    for i, scheme in enumerate(["checksum", "crc8", "crc16", "crc24",
                                "crc32"]):
        assert crc_generate_key(scheme, msg) == fg["crckeys"][i], scheme


@pytest.mark.parametrize("scheme", ["checksum", "crc8", "crc16", "crc24",
                                    "crc32"])
def test_crc_append_check(scheme):
    rng = np.random.default_rng(3)
    for n in (0, 1, 7, 72):
        msg = rng.integers(0, 256, n).astype(np.uint8)
        full = crc_append_key(scheme, msg)
        np.testing.assert_array_equal(full, jcrc.crc_append_key(scheme, msg))
        assert crc_check_key(scheme, full)
        if n:
            bad = full.copy()
            bad[n // 2] ^= 0x40
            assert not crc_check_key(scheme, bad)


@pytest.mark.parametrize("scheme", GOLDEN_SCHEMES)
@pytest.mark.parametrize("n", [1, 5, 16, 33])
def test_block_golden(fg, scheme, n):
    enc = fec_encode(scheme, ref_msg(n))
    gold = fg[f"enc_{scheme}_{n}"].astype(np.uint8)
    assert len(enc) == fec_get_enc_msg_length(scheme, n)
    np.testing.assert_array_equal(_mask_tail(enc, scheme, n),
                                  _mask_tail(gold, scheme, n))
    np.testing.assert_array_equal(enc, jdispatch.fec_encode(scheme,
                                                            ref_msg(n)))
    bad = gold.copy()
    bad[len(bad) // 2] ^= 0x10
    np.testing.assert_array_equal(fec_decode(scheme, bad, n),
                                  fg[f"dec1_{scheme}_{n}"].astype(np.uint8))


@pytest.mark.parametrize("scheme", ["hamming1511", "hamming3126", "none",
                                    "golay2412"])
def test_block_roundtrip_matches_jax(scheme):
    rng = np.random.default_rng(4)
    msg = rng.integers(0, 256, 32).astype(np.uint8)
    enc = fec_encode(scheme, msg)
    np.testing.assert_array_equal(enc, jdispatch.fec_encode(scheme, msg))
    enc2 = enc.copy()
    enc2[7] ^= 0x08
    dec = fec_decode(scheme, enc2, len(msg))
    np.testing.assert_array_equal(dec, jdispatch.fec_decode(scheme, enc2,
                                                            len(msg)))
    if scheme != "none":
        np.testing.assert_array_equal(dec, msg)


@pytest.mark.parametrize("scheme", ["hamming74", "golay2412", "rep3",
                                    "secded2216"])
def test_decode_soft_matches_jax(scheme):
    rng = np.random.default_rng(5)
    msg = rng.integers(0, 256, 11).astype(np.uint8)
    bits = np.unpackbits(fec_encode(scheme, msg)).astype(np.float32)
    llr = (2 * bits - 1) + 0.8 * rng.standard_normal(len(bits)).astype(
        np.float32)
    np.testing.assert_array_equal(
        dispatch.fec_decode_soft(scheme, llr, 11),
        jdispatch.fec_decode_soft(scheme, llr, 11))


def test_code_matrices_match_jax():
    for scheme in jblock._GCOLS:
        for a, b in zip(block._code_matrices(scheme),
                        jblock._code_matrices(scheme)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [4, 8, 16, 64, 100])
def test_interleave_golden(fg, n):
    x = fg[f"intlv_in_{n}"].astype(np.uint8)
    y = interleave(x)
    np.testing.assert_array_equal(y, fg[f"intlv_out_{n}"].astype(np.uint8))
    np.testing.assert_array_equal(deinterleave(y), x)


@pytest.mark.parametrize("n", [1, 3, 17, 150, 255])
@pytest.mark.parametrize("depth", [1, 4])
def test_interleave_soft_matches_jax(n, depth):
    rng = np.random.default_rng(n)
    v = rng.standard_normal(8 * n).astype(np.float32)
    w = interleave_soft(v, depth)
    np.testing.assert_array_equal(deinterleave_soft(w, depth), v)
    np.testing.assert_array_equal(deinterleave_soft(v, depth),
                                  j_deinterleave_soft(v, depth))


def test_packetizer_golden(fg):
    msg = fg["pkt_msg"].astype(np.uint8)
    enc = packetizer_encode(msg, "crc32", "hamming128", "none")
    assert len(enc) == packetizer_compute_enc_msg_len(
        len(msg), "crc32", "hamming128", "none")
    np.testing.assert_array_equal(enc, fg["pkt_enc"].astype(np.uint8))
    np.testing.assert_array_equal(
        packetizer_encode(msg, "crc16", "secded7264", "golay2412"),
        fg["pkt2_enc"].astype(np.uint8))
    enc[5] ^= 0x04
    dec, ok = packetizer_decode(enc, len(msg), "crc32", "hamming128", "none")
    assert ok == bool(fg["pkt_dec_ok"][0])
    np.testing.assert_array_equal(dec, fg["pkt_dec"].astype(np.uint8))


@pytest.mark.parametrize("cfg", [("crc24", "none", "golay2412"),
                                 ("crc32", "secded7264", "hamming84"),
                                 ("crc16", "hamming74", "none"),
                                 ("checksum", "none", "rep3")])
def test_packetizer_soft_matches_jax(cfg):
    rng = np.random.default_rng(6)
    msg = rng.integers(0, 256, 72).astype(np.uint8)
    enc = packetizer_encode(msg, *cfg)
    np.testing.assert_array_equal(enc, jpkt.packetizer_encode(msg, *cfg))
    assert packetizer_compute_dec_msg_len(len(enc), *cfg) == \
        jpkt.packetizer_compute_dec_msg_len(len(enc), *cfg)
    llr = 2.0 * np.unpackbits(enc).astype(np.float32) - 1.0
    llr += 0.9 * rng.standard_normal(len(llr)).astype(np.float32)
    got = packetizer_decode_soft(llr, 72, *cfg)
    want = jpkt.packetizer_decode_soft(llr, 72, *cfg)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_conv_and_rs_not_ported():
    # (named when the convolutional codes and Reed-Solomon still raised; a
    # test whose check changes keeps its name) both families are ported:
    # their encoders and decoders work (their parity is
    # tests/test_torch_conv.py and tests/test_torch_rs_ldpc.py)
    assert dispatch.CONV_SCHEMES == J_CONV_SCHEMES
    np.testing.assert_array_equal(
        fec_decode("rs8", fec_encode("rs8", ref_msg(4)), 4), ref_msg(4))
    assert fec_get_enc_msg_length("rs8", 4) == 4 + 32
    for scheme in ("v27", "v29p34"):
        np.testing.assert_array_equal(
            fec_decode(scheme, fec_encode(scheme, ref_msg(4)), 4),
            ref_msg(4))
    for make in (lambda: device.conv_soft_decoder("v27", 8),
                 lambda: device.conv_packet_soft_decoder(8),
                 lambda: device.qpacket_conv_soft_decoder(8),
                 lambda: device.qpacket_conv_soft_decoder(8, "crc16", "none",
                                                          "v29p34", "qam16")):
        assert isinstance(make()[0], torch.nn.Module)


@pytest.mark.parametrize("args", [
    (40, "crc16", "hamming128", "none", "qam16"),     # ffg_b's payload
    (100, "crc32", "secded7264", "hamming84", "psk8"),  # ffg_c's payload
    (64, "crc32", "none", "golay2412", "qpsk"),
    (20, "crc32", "none", "none", "qpsk"),
    (20, "crc32", "v27", "v29", "qpsk")])
def test_conv_decoders_reject_non_conv_configs_like_jax(args):
    # the flexframe receivers fall back on this ValueError (a config that
    # is not one conv stage plus 'none'); the port raised
    # NotImplementedError before its check
    with pytest.raises(ValueError) as want:
        jdevice.qpacket_conv_soft_decoder(*args)
    with pytest.raises(ValueError) as got:
        device.qpacket_conv_soft_decoder(*args)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        device.conv_packet_soft_decoder(*args[:4])
    for scheme in ("v615", "nope"):
        with pytest.raises(ValueError):
            jdevice.conv_soft_decoder(scheme, 8)
        with pytest.raises(ValueError):
            device.conv_soft_decoder(scheme, 8)


def test_packetizer2_soft_decoder_matches_jax():
    # the flexframe header code (crc32, secded7264, hamming84) on clean,
    # noisy and bit-flipped LLRs, batched: equal bytes and CRC verdicts
    rng = np.random.default_rng(20)
    msgs = rng.integers(0, 256, (3, 4, 20), dtype=np.uint8)
    bits = np.stack([[np.unpackbits(packetizer_encode(
        m, "crc32", "secded7264", "hamming84")) for m in row] for row in msgs])
    clean = 2.0 * bits.astype(np.float32) - 1.0
    noisy = clean + 0.8 * rng.standard_normal(clean.shape).astype(np.float32)
    flipped = clean.copy()
    for r in range(3):
        for c in range(4):
            # 1 flip: corrected by hamming84; 3 in one codeword: not
            n_flip = (0, 1, 2, 3)[c]
            pos = rng.choice(bits.shape[-1], n_flip, replace=False)
            flipped[r, c, pos] *= -0.7
    dec = device.packetizer2_soft_decoder(20)
    jdec = jdevice.packetizer2_soft_decoder(20)
    for llr in (clean, noisy, flipped, clean[0, 0, :300]):
        b, ok = dec(torch.from_numpy(np.ascontiguousarray(llr)))
        jb, jok = jdec(jnp.asarray(llr))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        assert b.dtype == torch.int32 and ok.dtype == torch.bool
    b, ok = dec(torch.from_numpy(clean))
    assert ok.all() and (b.numpy() == msgs).all()
    for bad in (("secded2216x", "hamming84"), ("secded7264", "golay2412x"),
                ("secded7264", "hamming3126")):
        with pytest.raises(ValueError):
            device.packetizer2_soft_decoder(20, "crc32", *bad)


def test_deint_perm_and_crc_affine_match_jax():
    np.testing.assert_array_equal(device._deint_perm(150),
                                  jdevice._deint_perm(150))
    for scheme in ("crc8", "crc24", "crc32"):
        for a, b in zip(device._crc_affine(scheme, 9),
                        jdevice._crc_affine(scheme, 9)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fec1,pl", [("golay2412", 72), ("hamming1511", 21),
                                     ("hamming74", 16)])
def test_packetizer_soft_decoder_matches_jax(fec1, pl):
    # noisy LLRs of real packets: the same message indices, then the same
    # bytes and CRC verdicts from the host finish and the device finish
    rng = np.random.default_rng(len(fec1) + pl)
    payloads = rng.integers(0, 256, (2, 3, pl), dtype=np.uint8)
    llr = np.stack([[
        2.0 * np.unpackbits(packetizer_encode(p, "crc24", "none", fec1))
        .astype(np.float32) - 1.0 for p in row] for row in payloads])
    llr += 1.1 * rng.standard_normal(llr.shape).astype(np.float32)
    dev_fn, fin = device.packetizer_soft_decoder(pl, "crc24", "none", fec1)
    jdev, jfin = jdevice.packetizer_soft_decoder(pl, "crc24", "none", fec1)
    msgs = dev_fn(torch.from_numpy(llr))
    want = np.asarray(jdev(jnp.asarray(llr)))
    assert msgs.dtype == torch.int32
    np.testing.assert_array_equal(msgs.numpy(), want)
    pay, ok = fin(msgs.numpy())
    jpay, jok = jfin(want)
    np.testing.assert_array_equal(pay, jpay)
    np.testing.assert_array_equal(ok, jok)
    dpay, dok = device.device_packet_finish(pl, "crc24", "none", fec1)(msgs)
    np.testing.assert_array_equal(dpay.numpy(), pay)
    np.testing.assert_array_equal(dok.numpy(), ok)


def test_qpacket_soft_decoder_and_finish_match_jax():
    # frame64's payload: 600 QPSK symbols -> 50 Golay codewords -> 72 bytes
    rng = np.random.default_rng(8)
    from liquid_dsp_tpu_torch.framing.qpacket import qpacketmodem_encode
    syms = np.stack([qpacketmodem_encode(
        rng.integers(0, 256, 72, dtype=np.uint8)).numpy() for _ in range(4)])
    syms = syms + (0.45 * (rng.standard_normal(syms.shape) + 1j *
                           rng.standard_normal(syms.shape))).astype(
        np.complex64)
    syms[3] = 0.1 * syms[3, ::-1]          # a slot that fails its CRC
    dev_fn, _ = device.qpacket_soft_decoder(72)
    jdev, _ = jdevice.qpacket_soft_decoder(72)
    msgs = dev_fn(torch.from_numpy(syms))
    jmsgs = np.asarray(jdev(jnp.asarray(syms)))
    np.testing.assert_array_equal(msgs.numpy(), jmsgs)
    pay, ok = device.device_packet_finish(72)(msgs)
    jpay, jok = jax.jit(jdevice.device_packet_finish(72))(jnp.asarray(jmsgs))
    np.testing.assert_array_equal(pay.numpy(), np.asarray(jpay))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.numpy().tolist() == [True, True, True, False]


@pytest.mark.parametrize("crc", ["none", "checksum", "crc8", "crc16",
                                 "crc32"])
@pytest.mark.parametrize("fec0,fec1", [("none", "none"), ("none", "hamming84"),
                                       ("v27", "none")])
def test_device_packet_finish_matches_jax(crc, fec0, fec1):
    rng = np.random.default_rng(9)
    pl = 13
    fin = device.device_packet_finish(pl, crc, fec0, fec1)
    jfin = jdevice.device_packet_finish(pl, crc, fec0, fec1)
    if fec1 == "hamming84":
        dec = rng.integers(0, 16, (3, fin.nsrc // 4)).astype(np.int32)
    else:
        dec = rng.integers(0, 2, (3, fin.nsrc)).astype(np.int32)
        # one valid packet: the message bits followed by its key
        msg = rng.integers(0, 256, pl).astype(np.uint8)
        dec[0] = np.unpackbits(crc_append_key(crc, msg))
    pay, ok = fin(torch.from_numpy(dec))
    jpay, jok = jfin(jnp.asarray(dec))
    np.testing.assert_array_equal(pay.numpy(), np.asarray(jpay))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


def test_device_packet_finish_rejects_unknown_config():
    with pytest.raises(ValueError):
        device.device_packet_finish(16, "crc16", "golay2412", "golay2412")
