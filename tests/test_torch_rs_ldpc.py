"""Reed-Solomon, the rs8 FEC scheme and LDPC of the PyTorch port against
the JAX package, on the same numpy inputs.

Tolerances: RS, the FEC dispatch, the packetizer and the LDPC host
functions are host numpy in both packages: bit-equal.  The batched LDPC
decoder runs float32 on torch and XLA (tanh, log, exp and atanh from two
libraries, sums in each one's order): its hard decisions and parity
verdicts must be equal, row for row.
"""
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (torch thread cap)
import jax
import jax.numpy as jnp

from _golden_frames import lcg_bytes
from liquid_dsp_tpu.fec import dispatch as jdisp
from liquid_dsp_tpu.fec import ldpc as jldpc
from liquid_dsp_tpu.fec import packetizer as jpkt
from liquid_dsp_tpu.fec import rs as jrs
from liquid_dsp_tpu.framing import flexframe as jff
from liquid_dsp_tpu_torch.fec import dispatch, ldpc, packetizer, rs
from liquid_dsp_tpu_torch.framing.flexframe import (FlexFrameSync,
                                                    flexframegen,
                                                    flexframesync)


# --- Reed-Solomon ------------------------------------------------------------

def test_gf_tables_and_generator_equal():
    np.testing.assert_array_equal(rs.GF_EXP, jrs.GF_EXP)
    np.testing.assert_array_equal(rs.GF_LOG, jrs.GF_LOG)
    np.testing.assert_array_equal(rs._GPOLY, jrs._GPOLY)


@pytest.mark.parametrize("n", [1, 17, 223, 224, 500, 1000])
def test_rs_encode_bit_equal(n):
    msg = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    assert rs.rs_get_enc_msg_length(n) == jrs.rs_get_enc_msg_length(n)
    np.testing.assert_array_equal(rs.rs_encode(msg), jrs.rs_encode(msg))


@pytest.mark.parametrize("n_err", [0, 1, 8, 15, 16, 17, 20, 40])
@pytest.mark.parametrize("n", [100, 223, 300])
def test_rs_decode_bit_equal_up_to_and_past_t(n, n_err):
    # t = 16 symbol errors a block are corrected; past it the decoder's
    # verdict and bytes must still be the JAX package's
    rng = np.random.default_rng(1000 * n + n_err)
    msg = rng.integers(0, 256, n).astype(np.uint8)
    enc = jrs.rs_encode(msg)
    bad = enc.copy()
    pos = rng.choice(min(len(enc), n // (-(-n // 223)) + 32), n_err,
                     replace=False)
    bad[pos] ^= rng.integers(1, 256, n_err).astype(np.uint8)
    got, ok = rs.rs_decode(bad, n)
    want, jok = jrs.rs_decode(bad, n)
    np.testing.assert_array_equal(got, want)
    assert ok == jok
    if n_err <= 16:
        assert ok and np.array_equal(got, msg)


def test_rs8_through_fec_dispatch():
    rng = np.random.default_rng(3)
    msg = rng.integers(0, 256, 250).astype(np.uint8)
    assert "rs8" in dispatch.FEC_SCHEMES
    assert dispatch.fec_get_enc_msg_length("rs8", 250) == \
        jdisp.fec_get_enc_msg_length("rs8", 250)
    assert dispatch.fec_get_rate("rs8") == jdisp.fec_get_rate("rs8")
    enc = dispatch.fec_encode("RS8", msg)
    np.testing.assert_array_equal(enc, jdisp.fec_encode("rs8", msg))
    bad = enc.copy()
    bad[[3, 90, 260, 300]] ^= 0x5A
    np.testing.assert_array_equal(dispatch.fec_decode("rs8", bad, 250), msg)
    np.testing.assert_array_equal(dispatch.fec_decode("rs8", bad, 250),
                                  jdisp.fec_decode("rs8", bad, 250))
    # soft: sliced hard, then decoded (positive = bit 1)
    llr = 2.0 * np.unpackbits(bad).astype(np.float32) - 1.0
    llr += 0.3 * rng.standard_normal(len(llr)).astype(np.float32)
    np.testing.assert_array_equal(dispatch.fec_decode_soft("rs8", llr, 250),
                                  jdisp.fec_decode_soft("rs8", llr, 250))


@pytest.mark.parametrize("cfg", [("crc32", "rs8", "none"),
                                 ("crc16", "hamming74", "rs8"),
                                 ("crc32", "rs8", "v27")])
def test_rs8_packetizer_bit_equal(cfg):
    rng = np.random.default_rng(4)
    msg = rng.integers(0, 256, 60).astype(np.uint8)
    enc = packetizer.packetizer_encode(msg, *cfg)
    np.testing.assert_array_equal(enc, jpkt.packetizer_encode(msg, *cfg))
    assert packetizer.packetizer_compute_enc_msg_len(60, *cfg) == \
        jpkt.packetizer_compute_enc_msg_len(60, *cfg)
    got = packetizer.packetizer_decode(enc, 60, *cfg)
    assert got[1] and np.array_equal(got[0], msg)
    llr = 2.0 * np.unpackbits(enc).astype(np.float32) - 1.0
    llr += 0.5 * rng.standard_normal(len(llr)).astype(np.float32)
    got = packetizer.packetizer_decode_soft(llr, 60, *cfg)
    want = jpkt.packetizer_decode_soft(llr, 60, *cfg)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_pack_bits_arr_equal():
    bits = np.random.default_rng(5).integers(0, 2, 83).astype(np.uint8)
    np.testing.assert_array_equal(packetizer.pack_bits_arr(bits),
                                  jpkt.pack_bits_arr(bits))


@pytest.mark.parametrize("fec0,fec1", [("rs8", "none"), ("rs8", "v27")])
def test_flexframe_on_an_rs8_payload(fec0, fec1):
    # the payload of no device decoder decodes on the host: now rs8 too
    hdr, pl = lcg_bytes(14, 21), lcg_bytes(100, 22)
    f = flexframegen(hdr, pl, "crc32", fec0, fec1, "qpsk")
    np.testing.assert_array_equal(
        f, np.asarray(jff.flexframegen(hdr, pl, "crc32", fec0, fec1,
                                       "qpsk")))
    x = np.concatenate([np.zeros(60, np.complex64), f,
                        np.zeros(60, np.complex64)])
    r = flexframesync(x, device="cpu")
    assert r.detected and r.header_ok and r.crc_ok
    np.testing.assert_array_equal(r.header, hdr)
    np.testing.assert_array_equal(r.payload, pl)
    fs = FlexFrameSync(block_len=4096, device="cpu")
    frames = fs.execute(np.concatenate([x, np.zeros(3000, np.complex64)]))
    frames += fs.flush()
    assert len(frames) == 1
    h, h_ok, p, p_ok, _ = frames[0]
    assert h_ok and p_ok
    np.testing.assert_array_equal(p, pl)


# --- LDPC --------------------------------------------------------------------

@pytest.mark.parametrize("n,k,cw_w,seed", [(96, 48, 3, 1), (64, 32, 3, 3),
                                           (40, 20, 2, 0)])
def test_ldpc_host_functions_equal(n, k, cw_w, seed):
    H = ldpc.make_regular_ldpc(n, k, col_weight=cw_w, seed=seed)
    np.testing.assert_array_equal(
        H, jldpc.make_regular_ldpc(n, k, col_weight=cw_w, seed=seed))
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 2, k).astype(np.uint8)
    try:
        want = jldpc.ldpc_encode_systematic(H, msg)
    except ValueError:
        with pytest.raises(ValueError, match="rank deficient"):
            ldpc.ldpc_encode_systematic(H, msg)
        return
    cw, perm = ldpc.ldpc_encode_systematic(H, msg)
    np.testing.assert_array_equal(cw, want[0])
    np.testing.assert_array_equal(perm, want[1])
    for min_sum in (False, True):
        llr = 2 * (1.0 - 2.0 * cw + 0.7 * rng.standard_normal(n)) / 0.49
        got = ldpc.ldpc_sumproduct_decode(H, llr, 20, min_sum)
        ref = jldpc.ldpc_sumproduct_decode(H, llr, 20, min_sum)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1:] == ref[1:]


def _fec_cases(H, n, k, sigma, count, seed):
    rng = np.random.default_rng(seed)
    llrs, cws = [], []
    for _ in range(count):
        cw, _ = jldpc.ldpc_encode_systematic(
            H, rng.integers(0, 2, k).astype(np.uint8))
        y = 1.0 - 2.0 * cw + sigma * rng.standard_normal(n)
        llrs.append((2 * y / sigma ** 2).astype(np.float32))
        cws.append(cw)
    return np.stack(llrs), np.stack(cws)


def _both(H, llr, iters, min_sum):
    jh, jok = jax.jit(jldpc.ldpc_decoder_device(H, iters, min_sum))(
        jnp.asarray(llr))
    th, tok = ldpc.ldpc_decoder_device(H, iters, min_sum, device="cpu")(llr)
    assert th.dtype == torch.int32 and tok.dtype == torch.bool
    assert th.shape == llr.shape and tok.shape == llr.shape[:-1]
    return np.asarray(jh), np.asarray(jok), th.numpy(), tok.numpy()


@pytest.mark.parametrize("min_sum", [False, True])
def test_ldpc_decoder_matches_jax_on_the_reference_cases(min_sum):
    # tests/test_fec.py's TestLdpcDevice case: 8 rows at sigma 0.6
    H = jldpc.make_regular_ldpc(96, 48, col_weight=3, seed=1)
    llr, cws = _fec_cases(H, 96, 48, 0.6, 8, 7)
    jh, jok, th, tok = _both(H, llr, 30, min_sum)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(tok, jok)
    assert tok.all() and (th == cws).all()


@pytest.mark.parametrize("min_sum", [False, True])
def test_ldpc_decoder_matches_jax_where_rows_fail(min_sum):
    # noisy enough that some rows do not converge: hard and ok still equal
    H = jldpc.make_regular_ldpc(96, 48, col_weight=3, seed=1)
    llr, cws = _fec_cases(H, 96, 48, 0.85, 24, 8)
    jh, jok, th, tok = _both(H, llr.reshape(4, 6, 96), 20, min_sum)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(tok, jok)
    assert 0 < tok.sum() < tok.size
    ok = tok.reshape(-1)
    assert (th.reshape(-1, 96)[ok] == cws[ok]).all()


@pytest.mark.parametrize("min_sum", [False, True])
def test_ldpc_decoder_irregular_and_weight_one_checks(min_sum):
    # row weights 3, 2, 4 and 1: the pads' neutral values, and the min-sum
    # message of a weight-1 check capped at 1e6 (never inf - inf)
    H = np.array([[1, 1, 0, 1, 0, 0],
                  [0, 0, 1, 0, 1, 0],
                  [1, 0, 1, 0, 1, 1],
                  [0, 1, 0, 0, 0, 0]], np.uint8)
    llr = (4 * np.random.default_rng(3).standard_normal((5, 6))).astype(
        np.float32)
    jh, jok, th, tok = _both(H, llr, 10, min_sum)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(tok, jok)
    # a row's verdict is its syndrome (the host decoder may stop at an
    # earlier codeword: it exits at the first satisfied parity)
    np.testing.assert_array_equal(tok, ~((th @ H.T) % 2).any(axis=-1))


def test_ldpc_decoder_maps_are_made_once_and_a_tensor_stays():
    H = jldpc.make_regular_ldpc(40, 20, col_weight=2, seed=0)
    dec = ldpc.ldpc_decoder_device(H, 5, device="cpu")
    maps = dec._maps["cpu"]
    llr = torch.randn(3, 40)
    hard, ok = dec(llr)
    assert hard.device == llr.device and dec._maps["cpu"] is maps
    with pytest.raises(ValueError, match=r"llr \[\.\.\., 40\]"):
        dec(np.zeros((2, 41), np.float32))
    with pytest.raises(RuntimeError, match="CUDA card"):
        ldpc.ldpc_decoder_device(H, 5)
