"""Port parity: the GMSK slice of liquid_dsp_tpu_torch (design/firdes.py's
GMSK pulses, modem/cpm.py, framing/gmskframe.py) against the reference C
library's frames (tests/golden/flexframe_golden.npz) and the JAX package,
on the same seeded inputs.

Tolerances: the pulses within 1e-6; the modems' samples within 1e-4
absolute (both integrate the phase by a float32 cumsum), their hard
decisions equal; the goldens within 1e-4 (tests/test_modem_cpm.py,
tests/test_flexframes.py); the receivers' valid masks, sample indices,
header and payload bytes and CRC verdicts equal, rxy and the valid
slots' frame metrics within 1e-4 absolute."""
import pathlib

import numpy as np
import pytest
import torch

import _torch_port as tp
from _golden_frames import lcg_bytes
import jax
import jax.numpy as jnp
from liquid_dsp_tpu.design import firdes as jfirdes
from liquid_dsp_tpu.framing import gmskframe as jgf
from liquid_dsp_tpu.modem import cpm as jcpm
from liquid_dsp_tpu_torch.convert import carry_from_numpy, load_jax_params
from liquid_dsp_tpu_torch.design import firdes
from liquid_dsp_tpu_torch.framing import gmskframe as gf
from liquid_dsp_tpu_torch.modem import cpm

GOLDEN = pathlib.Path(__file__).parent / "golden" / "flexframe_golden.npz"
GMSK_GOLDEN = [("gmsk_a", 40, "crc32", "none", "none", 77),
               ("gmsk_b", 64, "crc16", "hamming74", "golay2412", 91)]


@pytest.fixture(scope="module")
def fg():
    return dict(np.load(GOLDEN))


@pytest.mark.parametrize("k,m,bt", [(2, 3, 0.5), (2, 3, 0.3), (4, 3, 0.35),
                                    (3, 2, 0.25)])
def test_gmsk_pulses_match_jax(k, m, bt):
    for name in ("gmsktx", "gmskrx"):
        got = firdes.firdes_prototype(name, k, m, bt)
        want = jfirdes.firdes_prototype(name, k, m, bt)
        assert got.shape == want.shape
        assert np.abs(got - want).max() < 1e-6, name


def _stream_both(proc, jproc, blocks, lead=(3,)):
    """Two blocks through both packages (the port's params loaded from the
    JAX Proc), then the JAX carry after block 1 continued in the port:
    (port outputs, JAX outputs, port's block 2 from the JAX carry)."""
    load_jax_params(proc, tp.jax_params(jproc))
    c, cj = proc.init(batch_shape=lead), jproc.init(batch_shape=lead)
    got, want = [], []
    for k, b in enumerate(blocks):
        y, c = proc(c, torch.from_numpy(b.copy()))
        yj, cj = jproc.apply(jproc.params, cj, jnp.asarray(b))
        got.append(y.numpy())
        want.append(np.asarray(yj))
        if k == 0:
            handed = carry_from_numpy(tp.to_numpy(cj))
    y2, _ = proc(handed, torch.from_numpy(blocks[1].copy()))
    return got, want, y2.numpy()


def _close(got, want, tol=1e-4):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            assert np.abs(g - w).max() < tol


@pytest.mark.parametrize("k,m,bt", [(2, 3, 0.5), (4, 3, 0.3)])
def test_gmsk_modem_streams_match_jax(k, m, bt):
    rng = np.random.default_rng(k)
    bits = [rng.integers(0, 2, (3, 200)).astype(np.int32) for _ in range(2)]
    got, want, y2 = _stream_both(cpm.gmsk_modulator(k, m, bt),
                                 jcpm.gmsk_modulator(k, m, bt), bits)
    _close(got, want)
    _close([y2], [want[1]])
    y = [(w + 0.05 * tp.cnoise(rng, w.shape)).astype(np.complex64)
         for w in want]
    for soft in (False, True):
        got, want_d, y2 = _stream_both(
            cpm.gmsk_demodulator(k, m, bt, soft=soft),
            jcpm.gmsk_demodulator(k, m, bt, soft=soft), y)
        _close(got, want_d)
        _close([y2], [want_d[1]])
    hard = np.concatenate(want_d, axis=-1) > 0
    sent = np.concatenate(bits, axis=-1)
    assert np.mean(hard[:, 2 * m:] == sent[:, :-2 * m]) > 0.99


@pytest.mark.parametrize("m,k,bw", [(1, 4, 0.25), (2, 8, 0.25),
                                    (3, 8, 0.45)])
def test_fsk_streams_match_jax(m, k, bw):
    rng = np.random.default_rng(m)
    syms = [rng.integers(0, 1 << m, (2, 96)).astype(np.int32)
            for _ in range(2)]
    got, want, y2 = _stream_both(cpm.fsk_modulator(m, k, bw),
                                 jcpm.fsk_modulator(m, k, bw), syms, (2,))
    _close(got, want)
    _close([y2], [want[1]])
    y = [(w + 0.1 * tp.cnoise(rng, w.shape)).astype(np.complex64)
         for w in want]
    got, want_d, _ = _stream_both(cpm.fsk_demodulator(m, k, bw),
                                  jcpm.fsk_demodulator(m, k, bw), y, (2,))
    _close(got, want_d)
    np.testing.assert_array_equal(np.concatenate(got, -1),
                                  np.concatenate(syms, -1))
    s, fe = cpm.fsk_frequency_error(torch.from_numpy(y[0]), m, k, bw)
    js, jfe = jcpm.fsk_frequency_error(jnp.asarray(y[0]), m, k, bw)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert np.abs(fe.numpy() - np.asarray(jfe)).max() < 1e-4
    assert cpm.fsk_fft_size(m, k, bw) == jcpm.fsk_fft_size(m, k, bw)


@pytest.mark.parametrize("bps,h,kind", [(1, 0.5, "square"),
                                        (1, 0.5, "rcos_full"),
                                        (1, 0.5, "rcos_partial"),
                                        (1, 0.5, "gmsk"),
                                        (2, 0.25, "square")])
def test_cpfsk_streams_match_jax(bps, h, kind):
    rng = np.random.default_rng(bps)
    k = 8
    syms = [rng.integers(0, 1 << bps, (2, 64)).astype(np.int32)
            for _ in range(2)]
    got, want, y2 = _stream_both(cpm.cpfsk_modulator(bps, h, k, kind=kind),
                                 jcpm.cpfsk_modulator(bps, h, k, kind=kind),
                                 syms, (2,))
    _close(got, want)
    _close([y2], [want[1]])
    np.testing.assert_array_equal(cpm.cpfsk_pulse(k, 3, 0.35, kind),
                                  jcpm.cpfsk_pulse(k, 3, 0.35, kind))
    got, want_d, y2 = _stream_both(
        cpm.cpfsk_demodulator(bps, h, k, kind=kind),
        jcpm.cpfsk_demodulator(bps, h, k, kind=kind), want, (2,))
    _close(got, want_d)
    _close([y2], [want_d[1]])


def test_fsk_and_cpfsk_goldens(fg):
    # tests/test_modem_cpm.py's sample-exact cases against the reference
    syms = torch.from_numpy(np.real(fg["fsk_syms"]).astype(np.int32))
    fm = cpm.fsk_modulator(2, 16, bandwidth=0.25)
    y, _ = fm(fm.init(), syms)
    assert np.abs(y.numpy() - fg["fsk_y"]).max() < 1e-4
    syms = torch.from_numpy(np.real(fg["cpfsk_syms"]).astype(np.int32))
    cm = cpm.cpfsk_modulator(1, 0.5, 8, 3, beta=0.25, kind="square")
    y, _ = cm(cm.init(), syms)
    assert np.abs(y.numpy() - fg["cpfsk_y"]).max() < 1e-4


@pytest.mark.parametrize("tag,n,crc,fec0,fec1,seed", GMSK_GOLDEN)
def test_gmskframegen_and_sync_on_the_goldens(fg, tag, n, crc, fec0, fec1,
                                              seed):
    # the reference's tail symbols are random bits: the body only
    hdr, payload = lcg_bytes(8, seed), lcg_bytes(n, seed + 1)
    y = gf.gmskframegen(hdr, payload, crc=crc, fec0=fec0, fec1=fec1)
    rl = int(fg[tag + "_len"][0])
    body = rl - 2 * 3 * 2
    assert len(y) == rl
    assert np.abs(y[:body] - fg[tag][:body]).max() < 1e-4
    yj = jgf.gmskframegen(hdr, payload, crc=crc, fec0=fec0, fec1=fec1)
    assert np.abs(y - yj).max() < 1e-4
    x = np.concatenate([np.zeros(40, np.complex64), fg[tag][:rl],
                        np.zeros(40, np.complex64)])
    res = gf.gmskframesync(x, device="cpu")
    assert res.detected and res.header_ok and res.crc_ok
    np.testing.assert_array_equal(res.header, hdr)
    np.testing.assert_array_equal(res.payload, payload)
    assert not gf.gmskframesync(0.1 * tp.cnoise(np.random.default_rng(1),
                                                4000), device="cpu").detected


def _mk(rng, n, **kw):
    h = rng.integers(0, 256, 8).astype(np.uint8)
    p = rng.integers(0, 256, n).astype(np.uint8)
    return h, p, gf.gmskframegen(h, p, **kw)


def test_gmskframesync_streaming_matches_jax():
    # three frames of three configurations (uncoded, a block code on the
    # device decoder, a convolutional code on the host), CFO, noise, the
    # stream in chunks that do not match the block
    rng = np.random.default_rng(1)
    cap = np.zeros(24000, np.complex64)
    sent = []
    for s0, (n, fec0, fec1) in zip((1500, 9000, 16500),
                                   ((40, "none", "none"),
                                    (60, "none", "hamming74"),
                                    (25, "v27", "none"))):
        h, p, f = _mk(rng, n, fec0=fec0, fec1=fec1)
        cap[s0:s0 + len(f)] += f
        sent.append((s0, h, p))
    cap = cap * np.exp(1j * (0.0008 * np.arange(len(cap)) + 0.5))
    cap = (cap + 0.014 * tp.cnoise(rng, len(cap))).astype(np.complex64)
    fired = []
    fs = gf.GMSKFrameSync(callback=lambda *a: fired.append(a),
                          block_len=4096, device="cpu")
    for i in range(0, len(cap), 5000):
        fs.execute(cap[i:i + 5000])
    fs.flush()
    jfs = jgf.GMSKFrameSync(block_len=4096)
    jfs.execute(cap)
    jfs.flush()
    assert len(fs.frames) == len(jfs.frames) == len(fired) == 3
    for (s0, h, p), fr, jfr in zip(sent, fs.frames, jfs.frames):
        hh, hok, pp, pok, st = fr
        assert hok and pok
        np.testing.assert_array_equal(hh, h)
        np.testing.assert_array_equal(pp, p)
        np.testing.assert_array_equal(pp, jfr[2])
        assert st["sample_index"] == jfr[4]["sample_index"]
        assert abs(st["sample_index"] - s0) <= 2
    assert fs._dev_fec_cache[(60, "crc32", "none", "hamming74")] is not None
    assert fs._dev_fec_cache[(25, "crc32", "v27", "none")] is None


def _jax_soft_step(T, PL, crc="crc32", fec0="none", fec1="golay2412",
                   k=2, m=3, bt=0.5):
    """The JAX receiver's frame metrics for one block, [B, P, bits] (and
    the valid mask), by the steps of liquid_dsp_tpu/framing/gmskframe.py's
    gmskframe_rx_stream (its _apply_1d up to the soft metrics) on the JAX
    package's own detector, pulses and filter: the JAX receiver returns
    no metrics of its own to compare."""
    from liquid_dsp_tpu.framing import stream_rx as jsr
    from liquid_dsp_tpu.ops.fir import fir_apply_auto
    enc = jgf.packetizer_compute_enc_msg_len
    h_bits = 8 * enc(jgf.GMSKFRAME_H_USER + 5, jgf._H_CRC, jgf._H_FEC,
                     "none")
    total = 63 + h_bits + 8 * enc(PL, crc, fec0, fec1)
    n_win = k * (total + 2 * m) + 64
    dc = jsr._detect_consts(jgf._template(k, m, bt))
    starts = (np.arange(T // jsr._DET_HOP + 1) * jsr._DET_HOP).astype(
        np.int32)
    hr = jfirdes.firdes_gmskrx(k, m, bt).astype(np.float32)
    hr = jnp.asarray(hr / np.sum(np.abs(hr)))
    pre = jnp.asarray(2.0 * jgf._preamble_bits().astype(np.float32) - 1.0)

    def one(carry, x):
        buf = jnp.concatenate([carry["buf"], x], axis=-1)
        det = jsr._detect_refine(buf, carry["last_end"], dc, 0.5, 4, T,
                                 starts, k * total - 8, front_pad=0,
                                 win_len=n_win)
        win = det["win"]
        t = jnp.arange(n_win, dtype=jnp.float32)
        ph = det["dphi"][:, None] * t[None, :] + det["phi"][:, None]
        xa = (jax.lax.complex(win[:, 0], win[:, 1])
              * jax.lax.complex(jnp.cos(ph), -jnp.sin(ph)))
        prevs = jnp.concatenate([jnp.zeros_like(xa[..., :1]),
                                 xa[..., :-1]], axis=-1)
        phi_d = jnp.angle(jnp.conj(prevs) * xa + 1e-20)
        d, _ = fir_apply_auto(hr, jnp.zeros((4, hr.shape[0] - 1),
                                            jnp.float32), phi_d)
        ph0, ph1 = d[..., 0::k][..., :n_win // k], d[..., 1::k][
            ..., :n_win // k]
        s0 = ph0[..., 2 * m: 2 * m + 63] @ pre
        s1 = ph1[..., 2 * m: 2 * m + 63] @ pre
        soft = jnp.where((s1 > s0)[:, None], ph1, ph0)
        return soft[..., 2 * m: 2 * m + total], det["valid"]

    return jax.jit(jax.vmap(one))


@pytest.mark.parametrize("cfg", [dict(fec1="golay2412"),
                                 dict(fec0="v27", fec1="none")])
def test_gmskframe_rx_stream_matches_jax(cfg):
    # B = 2 channels x 4096-sample blocks: frames at spaced offsets (some
    # across block boundaries) under CFO 0.0015 rad/sample, phase 0.3 and
    # noise 0.005 (tests/test_gmskframe_stream.py), one foreign-config
    # frame (hdr_ok False); per block every output equal, rxy within
    # 1e-4, and the frame metrics of the valid slots within 1e-4 of the
    # JAX receiver's steps (_jax_soft_step)
    rng = np.random.default_rng(len(cfg))
    T, PL, B = 4096, 40, 2
    x = np.zeros((B, 4 * T), np.complex64)
    sent = []
    for b in range(B):
        pos = 300 + 700 * b
        while pos < 3 * T - (2200 if b == 0 else 4500):
            h, p, f = _mk(rng, PL, **cfg)
            x[b, pos:pos + len(f)] = f
            sent.append((b, pos, h, p))
            pos += len(f) + 600
    hw, pw, fw = _mk(rng, PL)                    # uncoded: foreign
    x[1, 3 * T - 1900:3 * T - 1900 + len(fw)] = fw
    n = np.arange(x.shape[1])
    x = (x * np.exp(1j * (0.0015 * n + 0.3))).astype(np.complex64)
    x = (x + 0.005 * tp.cnoise(rng, x.shape)).astype(np.complex64)
    proc = gf.gmskframe_rx_stream(T, PL, **cfg)
    jproc = jgf.gmskframe_rx_stream(T, PL, **cfg)
    step = jax.jit(jproc.apply)
    jsoft_step = _jax_soft_step(T, PL, **cfg)
    c, cj = proc.init(batch_shape=(B,)), jproc.init(batch_shape=(B,))
    found = []
    for blk in range(4):
        xb = np.ascontiguousarray(x[:, blk * T:(blk + 1) * T])
        soft = proc.soft_metrics(c, torch.from_numpy(xb))[1].numpy()
        jsoft, jvalid = jsoft_step(cj, jnp.asarray(xb))
        o, c = proc(c, torch.from_numpy(xb))
        oj, cj = step((), cj, jnp.asarray(xb))
        for key in ("valid", "sample_index", "hdr_bytes", "hdr_ok",
                    "pay_bytes", "pay_ok"):
            np.testing.assert_array_equal(getattr(o, key).numpy(),
                                          np.asarray(getattr(oj, key)), key)
        assert np.abs(o.rxy.numpy() - np.asarray(oj.rxy)).max() < 1e-4
        v = o.valid.numpy()
        np.testing.assert_array_equal(v, np.asarray(jvalid))
        assert soft.shape == jsoft.shape
        if v.any():
            assert np.abs(soft[v] - np.asarray(jsoft)[v]).max() < 1e-4
        for b, p in zip(*np.nonzero(v)):
            found.append((int(b), int(o.sample_index[b, p]),
                          bool(o.hdr_ok[b, p]), bool(o.pay_ok[b, p]),
                          o.hdr_bytes[b, p, :8].numpy().astype(np.uint8),
                          o.pay_bytes[b, p].numpy().astype(np.uint8)))
    foreign = [d for d in found if not d[2]]
    assert len(foreign) == 1 and foreign[0][0] == 1
    good = [d for d in found if d[2]]
    assert len(good) == len(sent)
    for d, (b, s0, h, p) in zip(sorted(good), sorted(
            sent, key=lambda s: (s[0], s[1]))):
        assert d[0] == b and abs(d[1] - s0) <= 2 and d[3]
        np.testing.assert_array_equal(d[4], h)
        np.testing.assert_array_equal(d[5], p)


def test_entry_points_default_to_the_card_and_raise_without_one():
    assert not torch.cuda.is_available()
    x = np.zeros(4000, np.complex64)
    with pytest.raises(RuntimeError, match="CUDA card"):
        gf.gmskframesync(x)
    with pytest.raises(RuntimeError, match="CUDA card"):
        gf.GMSKFrameSync()
