"""Port parity: the frame64 PHY pair and the streaming receivers of
liquid_dsp_tpu_torch against the JAX package, on the same seeded inputs.

Tolerances: framegen64 within 1e-6 (the same numpy TX math); per receiver
block `valid`, `sample_index`, the carry, decoded bytes and `crc_ok`
exactly; `rxy`, `gamma` and `evm_db` within 1e-4 relative, `cfo` within
1e-4 of one detection FFT bin (2*pi/512 rad/sample) since it is near 0;
the symbols of valid slots within 1e-4 of their rms.  Both sides compute
in float32 with their own FFT and matmul libraries, so the last bits
differ.  The stream cases of tests/test_frame64_stream.py are mirrored on
the port at T <= 4096 and at most two channels."""
import pathlib

import numpy as np
import pytest
import torch

import _torch_port as tp
import jax
import jax.numpy as jnp
from liquid_dsp_tpu.design import firdes as jfirdes
from liquid_dsp_tpu.framing import frame64 as jf
from liquid_dsp_tpu.framing import qpacket as jq
from liquid_dsp_tpu.framing import stream_rx as jrx
from liquid_dsp_tpu.utils import sequence as jseq
from liquid_dsp_tpu_torch.convert import carry_from_numpy, carry_to_numpy
from liquid_dsp_tpu_torch.design import firdes
from liquid_dsp_tpu_torch.framing import detector, qpacket, stream_rx
from liquid_dsp_tpu_torch.framing.frame64 import (
    FRAME64_LEN, Framesync64, framegen64, framesync64, framesync64_stream,
    framesync64_stream_full)
from liquid_dsp_tpu_torch.utils import sequence

GOLDEN = pathlib.Path(__file__).parent / "golden" / "frame64_golden.npz"
T = 4096
BIN = 2 * np.pi / 512


def _mkframe(rng):
    h = rng.integers(0, 256, 8).astype(np.uint8)
    p = rng.integers(0, 256, 64).astype(np.uint8)
    return h, p, framegen64(h, p)


def _stream(rng, frames, gaps, tail=2000, noise=0.005):
    parts, starts, pos = [], [], 0
    for (h, p, f), gap in zip(frames, gaps):
        parts.append(np.zeros(gap, np.complex64))
        pos += gap
        starts.append(pos)
        parts.append(f)
        pos += FRAME64_LEN
    parts.append(np.zeros(tail, np.complex64))
    x = np.concatenate(parts)
    x = x + noise * tp.cnoise(rng, len(x))
    return x.astype(np.complex64), starts


def _run(x, block_len=T, **kw):
    fs = Framesync64(block_len=block_len, device="cpu", **kw)
    return fs.execute(x) + fs.flush()


# --- transmitter and host pieces --------------------------------------------

def test_design_and_sequences_match_jax():
    for k, m, beta in [(2, 7, 0.3), (64, 7, 0.3), (4, 3, 0.5)]:
        np.testing.assert_allclose(firdes.firdes_arkaiser(k, m, beta),
                                   jfirdes.firdes_arkaiser(k, m, beta),
                                   rtol=0, atol=1e-12)
    np.testing.assert_allclose(firdes.firdes_rkaiser(2, 5, 0.35),
                               jfirdes.firdes_rkaiser(2, 5, 0.35),
                               rtol=0, atol=1e-12)
    for m in (2, 5, 7, 10):
        np.testing.assert_array_equal(sequence.msequence_bits(m),
                                      jseq.msequence_bits(m))
    np.testing.assert_array_equal(sequence.msequence_symbols(6, 40, 2),
                                  jseq.msequence_symbols(6, 40, 2))
    for a, b in zip(sequence.bsequence_create_ccodes(64),
                    jseq.bsequence_create_ccodes(64)):
        np.testing.assert_array_equal(a, b)
    g = sequence.msequence_create_genpoly(0x0089)
    gj = jseq.msequence_create_genpoly(0x0089)
    assert [g.advance() for _ in range(40)] == [gj.advance()
                                               for _ in range(40)]


def test_framegen64_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(3):
        h, p, f = _mkframe(rng)
        ref = jf.framegen64(h, p)
        assert f.dtype == np.complex64 and f.shape == (FRAME64_LEN,)
        assert np.abs(f - ref).max() < 1e-6
    np.testing.assert_array_equal(jf.frame64_preamble(),
                                  __import__("liquid_dsp_tpu_torch.framing."
                                             "frame64", fromlist=["x"])
                                  .frame64_preamble())


def test_qpacket_and_pilots_match_jax():
    rng = np.random.default_rng(2)
    msg = rng.integers(0, 256, 72).astype(np.uint8)
    syms = qpacket.qpacketmodem_encode(msg)
    np.testing.assert_array_equal(syms.numpy(),
                                  np.asarray(jq.qpacketmodem_encode(msg)))
    assert qpacket.qpacketmodem_frame_len(72, "crc24", "none", "golay2412",
                                          "qpsk") == 600
    np.testing.assert_array_equal(qpacket.qpilot_pilots(600, 21),
                                  jq.qpilot_pilots(600, 21))
    fr = qpacket.qpilotgen(syms.numpy(), 21)
    np.testing.assert_array_equal(fr, jq.qpilotgen(np.asarray(syms), 21))
    rx = (fr * 0.7 * np.exp(1j * (0.01 * np.arange(630) + 0.3))
          + 0.2 * tp.cnoise(rng, 630)).astype(np.complex64)
    got, want = qpacket.qpilotsync(rx, 600, 21), jq.qpilotsync(rx, 600, 21)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    for dec, jdec in ((qpacket.qpacketmodem_decode, jq.qpacketmodem_decode),
                      (qpacket.qpacketmodem_decode_soft,
                       jq.qpacketmodem_decode_soft)):
        out, ok = dec(got[0], 72)
        jout, jok = jdec(want[0], 72)
        np.testing.assert_array_equal(out, jout)
        assert ok == jok
        assert ok and np.array_equal(out, msg)


# --- the streaming receiver against the JAX package ---------------------------

@pytest.fixture(scope="module")
def two_channel_stream():
    """[2, 4*T] with 3 + 2 frames (one straddling a block boundary), noise,
    and the frames sent per channel."""
    rng = np.random.default_rng(11)
    x = np.zeros((2, 4 * T), np.complex64)
    sent = [[], []]
    for ch, starts in enumerate(((900, 5200, 9100), (3500, 7000))):
        for s0 in starts:
            h, p, f = _mkframe(rng)
            x[ch, s0:s0 + FRAME64_LEN] = f
            sent[ch].append((s0, h, p))
    x[:, 3 * T:] = 0
    x += 0.004 * tp.cnoise(rng, x.shape)
    return x, sent


@pytest.fixture(scope="module")
def jax_stream(two_channel_stream):
    x, _ = two_channel_stream
    jp = jf.framesync64_stream(T)
    step = jax.jit(jp.apply)
    c = jp.init(batch_shape=(2,))
    outs, carries = [], [tp.to_numpy(c)]
    for b in range(4):
        o, c = step((), c, jnp.asarray(x[:, b * T:(b + 1) * T]))
        outs.append(tp.to_numpy(o._asdict()))
        carries.append(tp.to_numpy(c))
    return outs, carries


def _assert_block_equal(o, oj):
    v = oj["valid"]
    np.testing.assert_array_equal(o.valid.numpy(), v)
    np.testing.assert_array_equal(o.sample_index.numpy(), oj["sample_index"])
    if not v.any():
        return
    for key in ("rxy", "gamma", "evm_db"):
        a, b = getattr(o, key).numpy()[v], oj[key][v]
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), key
    assert np.abs(o.cfo.numpy()[v] - oj["cfo"][v]).max() <= 1e-4 * BIN
    assert tp.rel_err(o.symbols.numpy()[v], oj["symbols"][v]) < 1e-4


def test_stream_blocks_match_jax(two_channel_stream, jax_stream):
    x, sent = two_channel_stream
    outs_j, carries_j = jax_stream
    proc = framesync64_stream(T)
    c = proc.init(batch_shape=(2,))
    for b in range(4):
        o, c = proc(c, torch.from_numpy(x[:, b * T:(b + 1) * T].copy()))
        assert o.symbols.shape == (2, T // FRAME64_LEN + 2, 600)
        _assert_block_equal(o, outs_j[b])
        cj = carries_j[b + 1]
        for key in ("buf", "base", "last_end"):
            got = carry_to_numpy(c)[key]
            assert got.dtype == cj[key].dtype and got.shape == cj[key].shape
            np.testing.assert_array_equal(got, cj[key])
    n = sum(int(o["valid"].sum()) for o in outs_j)
    assert n == sum(len(s) for s in sent)


def test_carry_hands_over_from_jax(two_channel_stream, jax_stream):
    # two blocks in the JAX package, the rest in the port
    x, _ = two_channel_stream
    outs_j, carries_j = jax_stream
    proc = framesync64_stream(T)
    c = carry_from_numpy(carries_j[2])
    for b in (2, 3):
        o, c = proc(c, torch.from_numpy(x[:, b * T:(b + 1) * T].copy()))
        _assert_block_equal(o, outs_j[b])


def test_stream_full_matches_jax(two_channel_stream):
    x, sent = two_channel_stream
    proc = framesync64_stream_full(T)
    jp = jf.framesync64_stream_full(T)
    step = jax.jit(jp.apply)
    c, cj = proc.init(batch_shape=(2,)), jp.init(batch_shape=(2,))
    got = [[], []]
    for b in range(4):
        blk = x[:, b * T:(b + 1) * T].copy()
        o, c = proc(c, torch.from_numpy(blk))
        oj, cj = step((), cj, jnp.asarray(blk))
        v = np.asarray(oj.valid)
        np.testing.assert_array_equal(o.valid.numpy(), v)
        for key in ("hdr_bytes", "pay_bytes", "crc_ok", "sample_index"):
            np.testing.assert_array_equal(getattr(o, key).numpy()[v],
                                          np.asarray(getattr(oj, key))[v])
        assert o.hdr_bytes.dtype == torch.int32
        for ch, s in zip(*np.nonzero(v)):
            got[ch].append((int(o.sample_index[ch, s]), bool(o.crc_ok[ch, s]),
                            o.hdr_bytes[ch, s].numpy().astype(np.uint8),
                            o.pay_bytes[ch, s].numpy().astype(np.uint8)))
    for g, s in zip(got, sent):
        assert len(g) == len(s)
        for (idx, ok, h, p), (s0, hs, ps) in zip(g, s):
            assert ok and abs(idx - s0) <= 2
            np.testing.assert_array_equal(h, hs)
            np.testing.assert_array_equal(p, ps)


def test_detector_stream_matches_jax(two_channel_stream):
    x, _ = two_channel_stream
    tmpl = jf._detector_template()
    jp = jrx.detector_stream(T, tmpl, max_frames=4, suppress_span=1432)
    step = jax.jit(jp.apply)
    proc = stream_rx.detector_stream(T, tmpl, max_frames=4,
                                     suppress_span=1432)
    c, cj = proc.init(batch_shape=(2,)), jp.init(batch_shape=(2,))
    for b in range(3):
        blk = x[:, b * T:(b + 1) * T].copy()
        o, c = proc(c, torch.from_numpy(blk))
        oj, cj = step((), cj, jnp.asarray(blk))
        v = np.asarray(oj.valid)
        np.testing.assert_array_equal(o.valid.numpy(), v)
        np.testing.assert_array_equal(o.sample_index.numpy(),
                                      np.asarray(oj.sample_index))
        for key in ("rxy", "gamma", "tau"):
            a, r = getattr(o, key).numpy()[v], np.asarray(getattr(oj, key))[v]
            assert np.abs(a - r).max() <= 1e-4 * max(np.abs(r).max(), 1.0)
        assert np.abs(o.dphi.numpy()[v] - np.asarray(oj.dphi)[v]).max() \
            <= 1e-4 * BIN


def test_mf_symbol_gather_without_windows_matches_jax():
    # the stand-alone gather path (regions at start_sym > 0)
    rng = np.random.default_rng(12)
    buf = tp.cnoise(rng, (2, 3000))
    n0 = np.array([[100, 1500], [2900, 7]], np.int32)
    off = np.array([[0, -1], [-1, 0]], np.int32)
    dphi = rng.uniform(-0.01, 0.01, (2, 2)).astype(np.float32)
    phi = rng.uniform(-3, 3, (2, 2)).astype(np.float32)
    gamma = rng.uniform(0.1, 1.0, (2, 2)).astype(np.float32)
    bidx = np.array([[0, 31], [5, 17]], np.int32)
    bank = jf._mf_bank()[:, ::-1].copy()
    got = stream_rx.mf_symbol_gather(
        torch.from_numpy(buf), torch.from_numpy(n0).long(),
        torch.from_numpy(off), torch.from_numpy(dphi),
        torch.from_numpy(phi), torch.from_numpy(gamma),
        torch.from_numpy(bank), torch.from_numpy(bidx), 40, start_sym=5)
    for ch in range(2):
        want = np.asarray(jrx.mf_symbol_gather(
            jnp.asarray(buf[ch]), jnp.asarray(n0[ch]), jnp.asarray(off[ch]),
            jnp.asarray(dphi[ch]), jnp.asarray(phi[ch]),
            jnp.asarray(gamma[ch]), jnp.asarray(bank), jnp.asarray(bidx[ch]),
            40, start_sym=5))
        assert tp.rel_err(got[ch].numpy(), want) < 1e-5


def test_time_shard_hooks_and_interp_template_not_ported():
    # the time-shard hooks (once "not ported"): a frame 5 samples after
    # the buffer head, so that its window's front pad is the left_ext
    # samples; a low prev_peak keeps segment 0 a local peak, a high one
    # drops it.  The port's three steps, as a time shard runs them
    # (parallel/rx.py), against the JAX package's _detect_refine with the
    # hooks, at the module's tolerances.
    rng = np.random.default_rng(21)
    proc = framesync64_stream(T).core
    buf = 0.005 * tp.cnoise(rng, 1536 + T)
    buf[5:5 + FRAME64_LEN] += _mkframe(rng)[2]
    ext = 0.3 * rng.standard_normal((2, proc.Lb)).astype(np.float32)
    R = jrx._rx_consts(T, jf._stream_cfg(), 4, 1536)
    tb = torch.from_numpy(buf)[None]
    for pk in (0.1, 10.0):
        seg = stream_rx._detect_segments(tb, proc._dc(), 0.5, T, proc.starts,
                                         torch.tensor([pk]))
        keep = stream_rx._suppress(
            torch.full((1,), -(1 << 30), dtype=torch.int32), seg["cand"],
            seg["n0_seg"], proc.span)
        got = stream_rx._refine(tb, seg, keep, proc._dc(), 4, T,
                                front_pad=proc.Lb, win_len=proc.win_len,
                                left_ext=torch.from_numpy(ext)[None])
        want = jrx._detect_refine(
            jnp.asarray(buf), jnp.int32(-(1 << 30)), R["dc"], 0.5, 4, T,
            R["starts"], R["span"], front_pad=R["Lb"], win_len=R["win_len"],
            prev_peak=jnp.float32(pk), left_ext=jnp.asarray(ext))
        v = np.asarray(want["valid"])
        np.testing.assert_array_equal(got["valid"][0].numpy(), v)
        assert v.sum() == (1 if pk < 1 else 0)
        np.testing.assert_array_equal(got["n0"][0].numpy()[v],
                                      np.asarray(want["n0"])[v])
        np.testing.assert_array_equal(got["cand"][0].numpy(),
                                      np.asarray(want["cand"]))
        for k in ("peak", "gamma", "tau"):
            np.testing.assert_allclose(got[k][0].numpy()[v],
                                       np.asarray(want[k])[v], rtol=1e-4)
        np.testing.assert_allclose(got["dphi"][0].numpy()[v],
                                   np.asarray(want["dphi"])[v],
                                   atol=1e-4 * BIN)
        if pk < 1:
            gw, ww = got["win"][0].numpy()[v], np.asarray(want["win"])[v]
            assert tp.rel_err(gw, ww) < 1e-6
            # the window starts Lb samples before n0 < Lb: its head is
            # the neighbour's samples, not zeros
            n0 = int(np.asarray(want["n0"])[0])
            assert n0 < proc.Lb
            np.testing.assert_array_equal(
                gw[0, :, :proc.Lb - n0], ext[:, n0:])
    # the interpolated template (once "not ported"): parity with the JAX
    # package's make_template on an arkaiser pulse at k = 2
    from liquid_dsp_tpu.framing import detector as jdet
    from liquid_dsp_tpu.ops import fir as jfir
    from liquid_dsp_tpu_torch.ops import fir
    seq = tp.cnoise(np.random.default_rng(9), 64)
    h = jfirdes.firdes_prototype("arkaiser", 2, 7, 0.3)
    got = detector.make_template(seq, fir.firinterp(2, h))
    want = jdet.make_template(seq, jfir.firinterp(2, h))
    assert got.shape == want.shape == (2 * (64 + 2 * 14),)  # Lp = 15
    assert tp.rel_err(got, want) < 1e-5
    with pytest.raises(ValueError, match="multiple of 256"):
        framesync64_stream(1000)


# --- the cases of tests/test_frame64_stream.py on the port -------------------

def test_k_frames_random_offsets_all_decode():
    rng = np.random.default_rng(1)
    frames = [_mkframe(rng) for _ in range(5)]
    gaps = [int(rng.integers(200, 3000)) for _ in range(5)]
    x, starts = _stream(rng, frames, gaps)
    got = _run(x)
    assert len(got) == 5
    for (h, p, _), (gh, hok, gp, pok, st), s0 in zip(frames, got, starts):
        assert hok and pok
        np.testing.assert_array_equal(gh, h)
        np.testing.assert_array_equal(gp, p)
        assert abs(st["sample_index"] - s0) <= 2


@pytest.mark.parametrize("device_fec", [True, False])
def test_frame_straddles_every_block_phase(device_fec):
    rng = np.random.default_rng(2)
    h, p, f = _mkframe(rng)
    B = 2048
    for start in [B - 1441, B - 720, B - 1, B, B + 1, 2 * B - 300]:
        x = np.zeros(start + FRAME64_LEN + 3000, np.complex64)
        x[start:start + FRAME64_LEN] = f
        got = _run(x, block_len=B, device_fec=device_fec)
        assert len(got) == 1, (start, len(got))
        gh, hok, gp, pok, st = got[0]
        assert hok and np.array_equal(gp, p) and np.array_equal(gh, h)
        assert abs(st["sample_index"] - start) <= 2


def test_channel_impairments():
    rng = np.random.default_rng(3)
    frames = [_mkframe(rng) for _ in range(3)]
    x, _ = _stream(rng, frames, [500, 1700, 900], noise=0.0)
    t = np.arange(len(x))
    x = (x * 0.2 * np.exp(1j * (0.008 * t + 1.0))).astype(np.complex64)
    sigma = 0.2 * 10 ** (-15 / 20) / np.sqrt(2)
    x = (x + sigma * np.sqrt(2) * tp.cnoise(rng, len(x)) / np.sqrt(2)
         ).astype(np.complex64)
    got = _run(x)
    assert len(got) == 3
    for (h, p, _), g in zip(frames, got):
        assert g[1] and np.array_equal(g[2], p)
        assert abs(g[4]["cfo"] - 0.008) < 5e-4


def test_interop_reference_frame():
    fg = dict(np.load(GOLDEN))
    x = np.concatenate([np.zeros(777, np.complex64), fg["frame"],
                        np.zeros(600, np.complex64)])
    got = _run(x)
    assert len(got) == 1
    gh, hok, gp, pok, st = got[0]
    assert hok
    np.testing.assert_array_equal(gh, fg["header"])
    np.testing.assert_array_equal(gp, fg["payload"])
    res = framesync64(x, device="cpu")
    assert res.detected and res.crc_ok
    np.testing.assert_array_equal(res.header, fg["header"])
    np.testing.assert_array_equal(res.payload, fg["payload"])


def test_back_to_back_frames():
    rng = np.random.default_rng(4)
    frames = [_mkframe(rng) for _ in range(4)]
    x, _ = _stream(rng, frames, [100, 60, 60, 60])
    got = _run(x)
    assert len(got) == 4
    for (h, p, _), g in zip(frames, got):
        assert g[1] and np.array_equal(g[2], p)


def test_no_false_frames_on_noise():
    rng = np.random.default_rng(5)
    x = (0.3 * tp.cnoise(rng, 20000)).astype(np.complex64)
    assert len(_run(x)) == 0
    assert not framesync64(x[:6000], device="cpu").detected


def test_two_channels_and_callback():
    rng = np.random.default_rng(6)
    (h0, p0, f0), (h1, p1, f1) = _mkframe(rng), _mkframe(rng)
    x = np.zeros((2, 2 * T), np.complex64)
    x[0, 300:300 + FRAME64_LEN] = f0
    x[1, 2500:2500 + FRAME64_LEN] = f1
    proc = framesync64_stream(T)
    carry = proc.init(batch_shape=(2,))
    hits = {}
    for b in range(2):
        out, carry = proc(carry, torch.from_numpy(x[:, b * T:(b + 1) * T]))
        for ch, s in zip(*np.nonzero(out.valid.numpy())):
            hits.setdefault(ch, []).append(
                (int(out.sample_index[ch, s]), out.symbols[ch, s].numpy()))
    assert len(hits[0]) == 1 and len(hits[1]) == 1
    assert abs(hits[0][0][0] - 300) <= 2 and abs(hits[1][0][0] - 2500) <= 2
    for ch, (h, p) in [(0, (h0, p0)), (1, (h1, p1))]:
        by, ok = qpacket.qpacketmodem_decode(hits[ch][0][1], 72)
        assert ok
        np.testing.assert_array_equal(by[:8], h)
        np.testing.assert_array_equal(by[8:], p)
    calls = []
    fs = Framesync64(callback=lambda *a: calls.append(a), block_len=T,
                     device="cpu")
    fs.execute(x[1])
    fs.flush()
    assert len(calls) == 1 and fs.num_frames_detected == 1
    np.testing.assert_array_equal(calls[0][2], p1)


# --- the one-shot receiver ---------------------------------------------------

def test_framesync64_oneshot_matches_jax():
    rng = np.random.default_rng(7)
    h, p, f = _mkframe(rng)
    x = np.concatenate([np.zeros(431, np.complex64), f,
                        np.zeros(900, np.complex64)])
    t = np.arange(len(x))
    x = (x * 0.5 * np.exp(1j * (0.004 * t + 0.4)) + 0.01 * tp.cnoise(
        rng, len(x))).astype(np.complex64)
    r, rj = framesync64(x, device="cpu"), jf.framesync64(x)
    assert r.detected and r.crc_ok and rj.crc_ok
    np.testing.assert_array_equal(r.header, h)
    np.testing.assert_array_equal(r.payload, p)
    assert r.sample_index == rj.sample_index
    assert abs(r.cfo - rj.cfo) <= 1e-4 * BIN
    assert abs(r.evm_db - rj.evm_db) <= 1e-3 and abs(r.rssi_db -
                                                     rj.rssi_db) <= 1e-3
    d, dj = detector.qdetector_detect(x, jf._detector_template(),
                                      device="cpu"), \
        __import__("liquid_dsp_tpu.framing.detector", fromlist=["x"]) \
        .qdetector_detect(x, jf._detector_template())
    assert d.detected and d.sample_index == dj.sample_index
    assert abs(d.gamma_hat - dj.gamma_hat) <= 1e-4 * dj.gamma_hat


def test_entry_points_default_to_the_card_and_raise_without_one():
    # no card here: the defaults must raise, not fall back to the CPU
    assert not torch.cuda.is_available()
    x = np.zeros(4000, np.complex64)
    with pytest.raises(RuntimeError, match="CUDA card"):
        framesync64(x)
    with pytest.raises(RuntimeError, match="CUDA card"):
        detector.qdetector_detect(x, jf._detector_template())
    with pytest.raises(RuntimeError, match="CUDA card"):
        Framesync64(block_len=T)
    with pytest.raises(RuntimeError, match="CUDA card"):
        Framesync64(block_len=T, device="cuda:0")
