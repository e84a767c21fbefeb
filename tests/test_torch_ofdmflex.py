"""Port parity: the OFDM flexframe PHY pair and its receivers
(`liquid_dsp_tpu_torch.framing.ofdmflexframe`, `.ofdmflex_stream`) and
the signal sources (`.sources`) against the reference C library's frames
(tests/golden/flexframe_golden.npz) and the JAX package, on the same
seeded inputs.

Tolerances: ofdmflexframegen within 1e-6 of the JAX package's samples
and 1e-5 of the goldens outside their random pad symbols
(tests/test_flexframes.py:224-262); the receivers' valid masks, sample
indices, message indices, header and payload bytes and verdicts equal,
`cfo` within 1e-6 and `evm_db` within 0.05 dB on the valid slots, `rxy`
within 1e-6; the host-loop receivers' frames, bytes, flags and sample
indices equal.  The sources' samples within 1e-6 (both are numpy: the
same arithmetic).  The JAX stream cases of tests/test_ofdmflex_stream.py
run on the port at T = 4096."""
import pathlib

import numpy as np
import pytest
import torch

import _torch_port as tp
from _golden_frames import lcg_bytes
import jax
import jax.numpy as jnp
from liquid_dsp_tpu.framing import ofdmflex_stream as jofs
from liquid_dsp_tpu.framing import ofdmflexframe as joff
from liquid_dsp_tpu.framing import sources as jsrc
from liquid_dsp_tpu_torch.convert import carry_from_numpy
from liquid_dsp_tpu_torch.framing import ofdmflex_stream as ofs
from liquid_dsp_tpu_torch.framing import ofdmflexframe as off
from liquid_dsp_tpu_torch.framing import sources as src
from liquid_dsp_tpu_torch.multichannel.ofdm import ofdm_params

GOLDEN = pathlib.Path(__file__).parent / "golden" / "flexframe_golden.npz"
OFFG = [("offg_a", 64, "crc32", "none", "golay2412", "qpsk", 101),
        ("offg_b", 40, "crc16", "hamming128", "none", "qam16", 113)]


@pytest.fixture(scope="module")
def fg():
    return dict(np.load(GOLDEN))


def _mk(rng, n, **kw):
    h = rng.integers(0, 256, 8).astype(np.uint8)
    p = rng.integers(0, 256, n).astype(np.uint8)
    return h, p, off.ofdmflexframegen(h, p, **kw)


@pytest.mark.parametrize("n,kw", [
    (64, {}), (40, dict(ms="qam16", fec1="hamming74")),
    (20, dict(ms="bpsk", fec1="none", crc="crc16")),
    (33, dict(fec0="v27", fec1="none", ms="psk8")),
    (50, dict(M=32, cp_len=8, fec1="hamming128"))])
def test_ofdmflexframegen_matches_jax(n, kw):
    rng = np.random.default_rng(n)
    h = rng.integers(0, 256, 8).astype(np.uint8)
    p = rng.integers(0, 256, n).astype(np.uint8)
    got = off.ofdmflexframegen(h, p, **kw)
    want = joff.ofdmflexframegen(h, p, **kw)
    assert got.dtype == np.complex64 and got.shape == want.shape
    assert np.abs(got - want).max() < 1e-6          # measured 0
    with pytest.raises(ValueError, match="8 bytes"):
        off.ofdmflexframegen(h[:7], p)


@pytest.mark.parametrize("tag,n,crc,fec0,fec1,ms,seed", OFFG)
def test_ofdmflexframegen_matches_the_goldens(fg, tag, n, crc, fec0, fec1,
                                              ms, seed):
    # tests/test_flexframes.py's TestOFDMFlexFrameGolden: every OFDM
    # symbol but the last of the header and of the payload block (the
    # reference fills their pad slots with random symbols)
    y = off.ofdmflexframegen(lcg_bytes(8, seed), lcg_bytes(n, seed + 1),
                             M=64, cp_len=16, crc=crc, fec0=fec0, fec1=fec1,
                             ms=ms)
    ref = fg[tag]
    assert len(y) == len(ref)
    _, _, nh, npd = off._frame_geometry(ofdm_params(64, 16), n, crc, fec0,
                                        fec1, ms)
    step = 64 + 16
    pad = {3 + nh - 1, 3 + nh + npd - 1}
    for i in range(len(ref) // step):
        if i not in pad:
            d = np.abs(y[i * step:(i + 1) * step]
                       - ref[i * step:(i + 1) * step]).max()
            assert d < 1e-5, (i, d)


@pytest.mark.parametrize("tag,n,crc,fec0,fec1,ms,seed", OFFG)
def test_ofdmflexframesync_decodes_the_goldens(fg, tag, n, crc, fec0, fec1,
                                               ms, seed):
    x = np.concatenate([np.zeros(30, np.complex64), fg[tag],
                        np.zeros(30, np.complex64)])
    got = off.ofdmflexframesync(x, M=64, cp_len=16, device="cpu")
    want = joff.ofdmflexframesync(x, M=64, cp_len=16)
    assert got.detected and got.header_ok and got.crc_ok
    assert (got.ms, got.payload_len) == (ms, n) == (want.ms,
                                                     want.payload_len)
    np.testing.assert_array_equal(got.header, lcg_bytes(8, seed))
    np.testing.assert_array_equal(got.payload, lcg_bytes(n, seed + 1))
    np.testing.assert_array_equal(got.payload, want.payload)


def test_ofdmflexframesync_failures_match_jax():
    # noise only: not detected; a frame whose header is cut off at its
    # protocol byte: detected, header_ok False; both as the JAX package
    rng = np.random.default_rng(5)
    noise = (0.1 * tp.cnoise(rng, 3000)).astype(np.complex64)
    h, p, f = _mk(rng, 30)
    bad = np.concatenate([np.zeros(50, np.complex64), f[:560],
                          0.5 * tp.cnoise(rng, len(f) - 560)])
    for x in (noise, bad.astype(np.complex64)):
        got = off.ofdmflexframesync(x, device="cpu")
        want = joff.ofdmflexframesync(x)
        assert (got.detected, got.header_ok, got.crc_ok) == \
            (want.detected, want.header_ok, want.crc_ok)


def _mixed_capture(rng, with_v27):
    """tests/test_ofdmflex_stream.py:21-49's capture: three frames of
    three configurations (plus a v27 payload), CFO 0.002 rad/sample,
    noise 0.01."""
    cfgs = [(40, "qpsk", "none", "golay2412"),
            (120, "qam16", "none", "hamming74"),
            (20, "bpsk", "none", "none")]
    starts = [1000, 8000, 15000]
    if with_v27:
        cfgs.append((30, "qpsk", "v27", "none"))
        starts.append(21000)
    cap = np.zeros(starts[-1] + 5000, np.complex64)
    sent = []
    for s0, (n, ms, fec0, fec1) in zip(starts, cfgs):
        h, p, f = _mk(rng, n, ms=ms, fec0=fec0, fec1=fec1)
        cap[s0:s0 + len(f)] += f
        sent.append((s0, h, p))
    cap = cap * np.exp(1j * 0.002 * np.arange(len(cap)))
    cap += 0.01 * tp.cnoise(rng, len(cap))
    return cap.astype(np.complex64), sent


def _frames_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[1] == w[1] and g[3] == w[3]
        for a, b in ((g[0], w[0]), (g[2], w[2])):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)
        assert g[4]["sample_index"] == w[4]["sample_index"]
        assert abs(g[4]["cfo"] - w[4]["cfo"]) < 1e-6
        assert abs(g[4]["evm_db"] - w[4]["evm_db"]) < 0.05


@pytest.mark.parametrize("with_v27", [False, True])
def test_ofdmflex_frame_sync_matches_jax(with_v27):
    rng = np.random.default_rng(1)
    cap, sent = _mixed_capture(rng, with_v27)
    fired = []
    fs = off.OFDMFlexFrameSync(callback=lambda *a: fired.append(a),
                               block_len=4096, device="cpu")
    for i in range(0, len(cap), 6000):   # arbitrary chunking
        fs.execute(cap[i:i + 6000])
    fs.flush()
    jfs = joff.OFDMFlexFrameSync(block_len=4096)
    jfs.execute(cap)
    jfs.flush()
    assert len(fs.frames) == len(fired) == len(sent)
    _frames_equal(fs.frames, jfs.frames)
    for (s0, h, p), (hh, hok, pp, pok, st) in zip(sent, fs.frames):
        assert hok and pok
        np.testing.assert_array_equal(hh, h)
        np.testing.assert_array_equal(pp, p)
        # the coarse plateau index: up to about a symbol late under noise
        assert abs(st["sample_index"] - s0) < 160
        assert st["evm_db"] < -20
    # golay2412 and hamming74 take the device decoder, v27 the Viterbi
    cache = fs._dev_fec_cache
    assert cache[(40, "crc32", "none", "golay2412", "qpsk")] is not None
    assert cache[(20, "crc32", "none", "none", "bpsk")] is None
    if with_v27:
        dfn, _ = cache[(30, "crc32", "v27", "none", "qpsk")]
        assert type(dfn).__name__ == "_ConvPacketDecoder"


@pytest.mark.parametrize("case", ["straddle", "noise", "oneshot"])
def test_ofdmflex_frame_sync_cases_match_jax(case):
    # tests/test_ofdmflex_stream.py's other OFDMFlexFrameSync cases, with
    # noise 0.005 added: without noise the S0 plateau metric is flat to
    # float32 rounding over about 96 samples, and the two packages' sums
    # pick different samples of it (measured 28 apart)
    rng = np.random.default_rng(2)
    if case == "straddle":
        h, p, f = _mk(rng, 64)
        cap = np.zeros(12288, np.complex64)
        s0 = 4096 - len(f) // 2
        cap[s0:s0 + len(f)] += f
    elif case == "noise":
        cap = (0.1 * tp.cnoise(rng, 16384)).astype(np.complex64)
    else:
        h, p, f = _mk(rng, 50, ms="psk8", fec1="hamming128")
        cap = np.zeros(8192, np.complex64)
        cap[700:700 + len(f)] += f
        cap = cap * np.exp(1j * 0.001 * np.arange(len(cap)))
    cap = (cap + 0.005 * tp.cnoise(rng, len(cap))).astype(np.complex64)
    fs = off.OFDMFlexFrameSync(block_len=4096, device="cpu")
    fs.execute(cap)
    fs.flush()
    jfs = joff.OFDMFlexFrameSync(block_len=4096)
    jfs.execute(cap)
    jfs.flush()
    _frames_equal(fs.frames, jfs.frames)
    assert len(fs.frames) == (0 if case == "noise" else 1)
    if case != "noise":
        assert fs.frames[0][3]
        np.testing.assert_array_equal(fs.frames[0][2], p)
    if case == "oneshot":
        one = off.ofdmflexframesync(cap, device="cpu")
        assert one.crc_ok
        np.testing.assert_array_equal(fs.frames[0][2], one.payload)
        np.testing.assert_array_equal(fs.frames[0][0], one.header)


@pytest.mark.parametrize("case", ["straddle", "oneshot"])
def test_ofdmflex_frame_sync_noise_free_cases_match_jax(case):
    # tests/test_ofdmflex_stream.py's straddle and one-shot captures as
    # they are, without noise.  The coarse `sample_index` lies on the S0
    # plateau metric, flat to float32 rounding over 96 samples there, so
    # the two packages may pick different samples of it (straddle: port
    # +29, JAX +1; one-shot: port +1, JAX +73): each is held on the
    # plateau, [start, start + 96], and the port within the 64 of
    # tests/test_ofdmflex_stream.py:48 (the JAX package's own index
    # leaves it on the one-shot capture).  The bytes, the verdicts and
    # `cfo` equal the JAX package's.
    if case == "straddle":
        rng = np.random.default_rng(2)
        h, p, f = _mk(rng, 64)
        cap = np.zeros(12288, np.complex64)
        s0 = 4096 - len(f) // 2
        cap[s0:s0 + len(f)] += f
    else:
        rng = np.random.default_rng(4)
        h, p, f = _mk(rng, 50, ms="psk8", fec1="hamming128")
        cap = np.zeros(8192, np.complex64)
        s0 = 700
        cap[s0:s0 + len(f)] += f
        cap = cap * np.exp(1j * 0.001 * np.arange(len(cap)))
    fs = off.OFDMFlexFrameSync(block_len=4096, device="cpu")
    fs.execute(cap)
    fs.flush()
    jfs = joff.OFDMFlexFrameSync(block_len=4096)
    jfs.execute(cap)
    jfs.flush()
    assert len(fs.frames) == len(jfs.frames) == 1
    (hh, hok, pp, pok, st), (jh, jhok, jp, jpok, jst) = (fs.frames[0],
                                                         jfs.frames[0])
    assert hok == jhok and pok == jpok and hok and pok
    np.testing.assert_array_equal(hh, jh)
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_array_equal(hh, h)
    np.testing.assert_array_equal(pp, p)
    assert abs(st["cfo"] - jst["cfo"]) < 1e-6
    assert abs(st["sample_index"] - s0) < 64
    for idx in (st["sample_index"], jst["sample_index"]):
        assert s0 <= idx <= s0 + 96
    if case == "oneshot":
        one = off.ofdmflexframesync(cap, device="cpu")
        jone = joff.ofdmflexframesync(cap)
        assert one.crc_ok and jone.crc_ok
        np.testing.assert_array_equal(one.payload, jone.payload)
        np.testing.assert_array_equal(one.header, jone.header)
        np.testing.assert_array_equal(pp, one.payload)


RX_KEYS = ("valid", "sample_index", "hdr_msgs", "pay_msgs", "hdr_bytes",
           "hdr_ok", "pay_bytes", "pay_ok")


def _rx_stream(rng, T, B=4):
    """B channels x 3 blocks + a flush block: frames of the receiver's
    config (64 bytes, golay2412, qpsk) at spaced offsets, one across a
    block boundary, CFO 0.002 rad/sample and phase 0.3 on channel 1, a
    foreign-config frame (32 bytes qam16) on channel 2, noise only on the
    last channel.  Returns (x, sent {(ch): [(start, h, p)]}, foreign)."""
    x = np.zeros((B, 4 * T), np.complex64)
    sent, f_len = {}, None
    for ch, starts in ((0, (400, T - 900, 2 * T + 1800)), (1, (1300, 7000)),
                       (2, (600,))):
        for s0 in starts:
            h, p, f = _mk(rng, 64)
            f_len = len(f)
            if ch == 1:
                f = f * np.exp(1j * (0.002 * np.arange(s0, s0 + len(f))
                                     + 0.3))
            x[ch, s0:s0 + len(f)] = f
            sent.setdefault(ch, []).append((s0, h, p))
    assert T - 900 + f_len > T          # across the block boundary
    hw, pw, fw = _mk(rng, 32, ms="qam16")
    x[2, 2 * T + 500:2 * T + 500 + len(fw)] = fw
    x += 0.01 * tp.cnoise(rng, x.shape)
    return x.astype(np.complex64), sent, (2, 2 * T + 500)


def _rx_step_equal(o, oj):
    for k in RX_KEYS:
        g, w = getattr(o, k).numpy(), np.asarray(getattr(oj, k))
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, k)
    v = o.valid.numpy()
    assert o.sample_index.dtype == torch.int32
    assert np.abs(o.rxy.numpy() - np.asarray(oj.rxy)).max() < 1e-6
    if v.any():
        assert np.abs(o.cfo.numpy()[v] - np.asarray(oj.cfo)[v]).max() < 1e-6
        assert np.abs(o.evm_db.numpy()[v] - np.asarray(oj.evm_db)[v]
                      ).max() < 0.05


def test_ofdmflex_rx_stream_matches_jax():
    # B = 4, T = 4096, 3 blocks and a flush: every output of every block
    # equal (valid slots' cfo and evm_db within tolerance), every frame
    # decoded once with the bytes sent, the foreign frame hdr_ok False;
    # then the stream handed from JAX to the port after block 1
    T = 4096
    x, sent, (fch, fpos) = _rx_stream(np.random.default_rng(3), T)
    proc = ofs.ofdmflex_rx_stream(T, 64, max_frames=4)
    jproc = jofs.ofdmflex_rx_stream(T, 64, max_frames=4)
    step = jax.jit(jproc.apply)
    c, cj = proc.init(batch_shape=(4,)), jproc.init(batch_shape=(4,))
    found, outs = [], []
    for b in range(4):
        blk = np.ascontiguousarray(x[:, b * T:(b + 1) * T])
        o, c = proc(c, torch.from_numpy(blk))
        oj, cj = step((), cj, jnp.asarray(blk))
        _rx_step_equal(o, oj)
        outs.append(o)
        if b == 0:
            handed = carry_from_numpy(tp.to_numpy(cj))
        for ch, p in zip(*np.nonzero(o.valid.numpy())):
            found.append((int(ch), int(o.sample_index[ch, p]),
                          bool(o.hdr_ok[ch, p]), bool(o.pay_ok[ch, p]),
                          o.hdr_bytes[ch, p, :8].numpy().astype(np.uint8),
                          o.pay_bytes[ch, p].numpy().astype(np.uint8)))
    foreign = [d for d in found if not d[2]]
    assert len(foreign) == 1 and foreign[0][0] == fch
    assert abs(foreign[0][1] - fpos) < 160
    good = sorted(d for d in found if d[2])
    want = sorted((ch, s0, h, p) for ch, v in sent.items()
                  for s0, h, p in v)
    assert len(good) == len(want) == 6
    assert not [d for d in found if d[0] == 3]
    for d, (ch, s0, h, p) in zip(good, want):
        # the coarse plateau index: up to about a symbol late under noise
        assert d[0] == ch and abs(d[1] - s0) < 160 and d[3]
        np.testing.assert_array_equal(d[4], h)
        np.testing.assert_array_equal(d[5], p)
    # blocks 1-3 in the port from the JAX carry after block 0
    for b in range(1, 4):
        blk = np.ascontiguousarray(x[:, b * T:(b + 1) * T])
        oh, handed = proc(handed, torch.from_numpy(blk))
        for k in RX_KEYS:
            np.testing.assert_array_equal(getattr(oh, k).numpy(),
                                          getattr(outs[b], k).numpy(), k)


def test_ofdmflex_stream_rx_matches_jax():
    # the callback wrapper: tests/test_ofdmflex_stream.py's multi-frame
    # case with arbitrary chunking, and its config-mismatch case
    rng = np.random.default_rng(11)
    cap = np.zeros(24576, np.complex64)
    sent = []
    for s0 in (900, 8000, 17000):
        h, p, f = _mk(rng, 64)
        cap[s0:s0 + len(f)] += f
        sent.append((s0, h, p))
    h, p, f = _mk(rng, 32, ms="qam16")
    cap[12000:12000 + len(f)] += f
    cap = cap * np.exp(1j * 0.002 * np.arange(len(cap)))
    cap = (cap + 0.02 * tp.cnoise(rng, len(cap))).astype(np.complex64)
    fired = []
    rx = ofs.OFDMFlexStreamRX(64, callback=lambda *a: fired.append(a),
                              block_len=4096, device="cpu")
    for i in range(0, len(cap), 6000):
        rx.execute(cap[i:i + 6000])
    rx.flush()
    jrx = jofs.OFDMFlexStreamRX(64, block_len=4096)
    jrx.execute(cap)
    jrx.flush()
    assert len(rx.frames) == len(fired) == len(jrx.frames) == 4
    _frames_equal(rx.frames, jrx.frames)
    good = [f for f in rx.frames if f[1]]
    assert [f[1] for f in rx.frames] == [True, True, False, True]
    for (s0, h, p), (hh, hok, pp, pok, st) in zip(sent, good):
        assert pok and abs(st["sample_index"] - s0) < 160
        np.testing.assert_array_equal(hh, h)
        np.testing.assert_array_equal(pp, p)
        assert st["evm_db"] < -20


def test_entry_points_default_to_the_card_and_raise_without_one():
    assert not torch.cuda.is_available()
    x = np.zeros(4096, np.complex64)
    for make in (lambda: off.ofdmflexframesync(x),
                 lambda: off.OFDMFlexFrameSync(),
                 lambda: ofs.OFDMFlexStreamRX(64)):
        with pytest.raises(RuntimeError, match="CUDA card"):
            make()


# ---------------------------------------------------------------------------
# signal sources


@pytest.mark.parametrize("kw", [{}, dict(ms="qam16", k=4, m=5, beta=0.25),
                                dict(ftype="rrcos", gain_db=-6.0)])
def test_symstream_matches_jax(kw):
    gain = kw.pop("gain_db", 0.0)
    a = src.Symstream(seed=3, gain_db=gain, **kw)
    b = jsrc.Symstream(seed=3, gain_db=gain, **kw)
    for n in (100, 1, 2047, 600):        # chunking does not matter
        ga, gb = a.generate(n), b.generate(n)
        assert ga.dtype == np.complex64 and ga.shape == (n,)
        assert np.abs(ga - gb).max() < 1e-6
    assert abs(a.get_gain() - gain) < 1e-9
    np.testing.assert_array_equal(src.symstream(512, seed=2),
                                  jsrc.symstream(512, seed=2))
    with pytest.raises(ValueError, match="multiple"):
        src.symstream(513)


def test_msource_matches_jax():
    def build(mod):
        q = mod.Msource(seed=7)
        q.add_tone(0.05, -3.0)
        q.add_noise(-0.2, 0.3, -20.0)
        ids = [q.add_noise(gain_db=-30.0),
               q.add_modem(0.1, -6.0, ms="psk8")]
        q.add_user(lambda n: np.ones(n, np.complex64), 0.2, -10.0)
        return q, ids

    (q, ids), (jq, jids) = build(src), build(jsrc)
    for step in range(3):
        if step == 1:
            for m, i in ((q, ids), (jq, jids)):
                m.set_frequency(i[1], -0.07)
                m.set_gain(i[0], -12.0)
                m.disable(i[0])
        if step == 2:
            q.enable(ids[0])
            jq.enable(jids[0])
            q.remove(ids[1])
            jq.remove(jids[1])
        ga, gb = q.generate(700), jq.generate(700)
        assert np.abs(ga - gb).max() < 1e-6
    assert q.num_sources == jq.num_sources == 4
    assert q.get_frequency(0) == 0.05 and abs(q.get_gain(0) + 3) < 1e-9
    srcs = [{"kind": "tone", "fc": 0.1}, {"kind": "noise", "gain_db": -10},
            {"kind": "modem", "ms": "qpsk", "fc": -0.2}]
    assert np.abs(src.msource(1000, srcs, seed=1)
                  - jsrc.msource(1000, srcs, seed=1)).max() < 1e-6
    with pytest.raises(ValueError, match="unknown msource kind"):
        src.msource(10, [{"kind": "chirp"}])


def test_frame_stats_match_jax():
    assert src.FrameSyncStats() == src.FrameSyncStats(0.0, 0.0, 0.0, "", "",
                                                      "", "")
    a, b = src.FrameDataStats(), jsrc.FrameDataStats()
    for hok, pok, n in ((True, True, 64), (True, False, 64),
                        (False, False, 0), (True, True, 10)):
        a.update(hok, pok, n)
        b.update(hok, pok, n)
    assert vars(a) == vars(b) == {"num_frames_detected": 4,
                                  "num_headers_valid": 3,
                                  "num_payloads_valid": 2,
                                  "num_bytes_received": 74}
    a.reset()
    assert vars(a) == vars(src.FrameDataStats())
