"""Port parity: the polyphase channelizers of
`liquid_dsp_tpu_torch.multichannel` against the reference's golden
vectors (tests/golden/channelizer_golden.npz) and the JAX package, and
the wideband scanner (examples/wideband_scanner_example.py's
composition) through both packages.

Tolerances: the goldens at tests/test_channelizer.py's 2e-4 absolute;
the JAX package within 1e-5 absolute (both float32, summed in other
orders); the firpfbch2 loopback within 2e-3 after its delay and the
analyzer's mix-filter-decimate equivalence within 1e-3, the reference
autotests' own bounds; streamed, batched and planar runs against the
one-shot complex run within 1e-5.  The scanner: equal decodes (channel,
sample_index, bytes, crc_ok) from both packages."""
import numpy as np
import pytest
import torch

import _torch_port as tp
import jax
import jax.numpy as jnp
from liquid_dsp_tpu.framing import frame64 as jf64
from liquid_dsp_tpu.multichannel import channelizer as jch
from liquid_dsp_tpu.planar import planar as jplanar
from liquid_dsp_tpu_torch import planar
from liquid_dsp_tpu_torch.convert import carry_from_numpy, carry_to_numpy
from liquid_dsp_tpu_torch.framing.frame64 import (FRAME64_LEN, framegen64,
                                                  framesync64_stream_full)
from liquid_dsp_tpu_torch.multichannel import channelizer as ch

CASES = [(8, 4), (16, 5), (64, 3)]
KINDS = ["firpfbch_analyzer", "firpfbch_synthesizer", "firpfbch2_analyzer",
         "firpfbch2_synthesizer"]
GOLDEN_KEYS = {  # (input key, output key): outputs are frame-major
    "firpfbch_analyzer": ("x", "Z1"), "firpfbch_synthesizer": ("Z1", "z1"),
    "firpfbch2_analyzer": ("x", "Y2"), "firpfbch2_synthesizer": ("Y2", "y2")}


@pytest.fixture(scope="module")
def cg():
    return dict(np.load("tests/golden/channelizer_golden.npz"))


def _pair(kind, M, m=4):
    return getattr(jch, kind)(M, m, 60.0), getattr(ch, kind)(M, m, 60.0)


def _input(kind, rng, M, frames, lead=()):
    """A complex input of `frames` frames: [.., frames*M] for analyzers,
    [.., M, frames] for synthesizers (an even count for firpfbch2)."""
    if "analyzer" in kind:
        return tp.cnoise(rng, lead + (frames * M,))
    return tp.cnoise(rng, lead + (M, frames))


def _carry_close(c, jc, atol):
    """A port carry (tensor or dict) against a JAX carry, key by key."""
    c, jc = carry_to_numpy(c), tp.to_numpy(jc)
    if isinstance(c, dict):
        assert set(c) == set(jc)
        for k in c:
            np.testing.assert_allclose(c[k], jc[k], atol=atol)
    else:
        np.testing.assert_allclose(c, jc, atol=atol)


@pytest.mark.parametrize("M,m", CASES)
@pytest.mark.parametrize("kind", KINDS)
def test_golden_and_jax(cg, kind, M, m):
    ink, outk = GOLDEN_KEYS[kind]
    x = cg[f"{ink}_{M}_{m}"]
    if ink != "x":
        x = x.reshape(-1, M).T.copy()            # [M, frames]
    want = cg[f"{outk}_{M}_{m}"]
    jp, p = _pair(kind, M, m)
    y, c = p(p.init(), torch.from_numpy(x))
    y = y.numpy()
    got = y.T.reshape(-1) if "analyzer" in kind else y
    np.testing.assert_allclose(got, want, atol=2e-4)
    jy, jc = jp.apply(jp.params, jp.init(), jnp.asarray(x))
    np.testing.assert_allclose(y, np.asarray(jy), atol=1e-5)
    _carry_close(c, jc, 1e-6)
    assert y.dtype == np.complex64


@pytest.mark.parametrize("kind", KINDS)
def test_large_m_regime(kind, monkeypatch):
    # above _FUSED_MAX_M: branch filter + batched (I)FFT, carries in the
    # regime's own layout; against the fused port bank and against the
    # JAX package in the same regime, the stream changing package after
    # the first block
    rng = np.random.default_rng(7)
    M = 16
    x = _input(kind, rng, M, 20, (2,))
    fused = getattr(ch, kind)(M)
    monkeypatch.setattr(ch, "_FUSED_MAX_M", 4)
    monkeypatch.setattr(jch, "_FUSED_MAX_M", 4)
    jp, p = _pair(kind, M)
    assert fused.forward_planar is not None and p.forward_planar is None
    assert jp.planar_apply is None
    yf, _ = fused(fused.init(batch_shape=(2,)), torch.from_numpy(x))
    cut = 8 * M if "analyzer" in kind else 8
    blocks = [x[..., :cut], x[..., cut:]]
    jy1, jc = tp.run_jax(jp, blocks[:1], (2,))
    c = carry_from_numpy(tp.to_numpy(jc))
    if kind == "firpfbch2_synthesizer":
        assert set(c) == {"w1", "w0"}
    jy2, jc = tp.run_jax(jp, blocks[1:], (2,), carry=jc)
    y2, c = tp.run_torch(p, blocks[1:], (2,), carry=c)
    np.testing.assert_allclose(y2, jy2, atol=1e-5)
    y, _ = tp.run_torch(p, blocks, (2,))
    np.testing.assert_allclose(y, yf.numpy(), atol=2e-5)
    _carry_close(c, jc, 1e-5)


def test_large_m_on_a_real_size():
    # the FFT regime at M = 1024 (as the card runs it): firpfbch2 loopback
    # at the reference autotest's m = 5
    M, m = 1024, 5
    rng = np.random.default_rng(3)
    x = 0.5 * tp.cnoise(rng, 32 * M) / np.sqrt(2)
    a, s = ch.firpfbch2_analyzer(M, m), ch.firpfbch2_synthesizer(M, m)
    assert a.forward_planar is None and s.forward_planar is None
    Y, _ = a(a.init(), torch.from_numpy(x))
    y, _ = s(s.init(), Y)
    delay = 2 * M * m - M // 2 + 1
    assert np.abs(y.numpy()[delay:] - x[:len(x) - delay]).max() < 2e-3


@pytest.mark.parametrize("kind", KINDS)
def test_planar_matches_complex(kind):
    rng = np.random.default_rng(2)
    M = 16
    x = _input(kind, rng, M, 12, (3,))
    p = getattr(ch, kind)(M)
    pp = planar(p)
    y, _ = tp.run_torch(p, [x], (3,))
    yp, cp = tp.run_torch(pp, [x], (3,), planar=True)
    np.testing.assert_allclose(yp, y, atol=1e-6)
    # the planar carry continues the stream like the complex one
    x2 = _input(kind, rng, M, 6, (3,))
    y_all, _ = tp.run_torch(p, [x, x2], (3,))
    yp2, _ = tp.run_torch(pp, [x2], (3,), planar=True, carry=cp)
    np.testing.assert_allclose(yp2, y_all[..., y.shape[-1]:], atol=1e-6)
    jy, _ = tp.run_jax(jplanar(getattr(jch, kind)(M)), [x], (3,),
                       planar=True)
    np.testing.assert_allclose(yp, jy, atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_streaming_and_batched_match_oneshot(kind):
    rng = np.random.default_rng(4)
    M = 8
    x = _input(kind, rng, M, 24, (3,))
    p = getattr(ch, kind)(M)
    y1, _ = tp.run_torch(p, [x], (3,))
    cuts = [6, 10, 24] if "synth" in kind else [6 * M, 10 * M, 24 * M]
    blocks = np.split(x, cuts[:-1], axis=-1)
    ys, _ = tp.run_torch(p, blocks, (3,))
    np.testing.assert_allclose(ys, y1, atol=1e-5)
    for i in range(3):
        yi, _ = tp.run_torch(p, [x[i]], ())
        np.testing.assert_allclose(yi, y1[i], atol=1e-5)


@pytest.mark.parametrize("kind", ["firpfbch_analyzer",
                                  "firpfbch_synthesizer"])
def test_one_tap_branches(kind):
    # len(h) == M -> p = 1: the carry is EMPTY and stays empty
    rng = np.random.default_rng(1)
    M = 8
    h = np.hanning(M).astype(np.float32) + 0.1
    p = getattr(ch, kind)(M, h=h)
    jp = getattr(jch, kind)(M, h=h)
    assert tuple(p.init().shape) == (0, M)
    x = _input(kind, rng, M, 12)
    cut = 5 * M if "analyzer" in kind else 5
    y, c = tp.run_torch(p, [x[..., :cut], x[..., cut:]], ())
    assert tuple(c.shape) == (0, M)
    jy, _ = tp.run_jax(jp, [x], ())
    np.testing.assert_allclose(y, jy, atol=1e-5)


def test_block_length_errors():
    with pytest.raises(ValueError):
        a = ch.firpfbch_analyzer(8, 4)
        a(a.init(), torch.zeros(100, dtype=torch.complex64))
    with pytest.raises(ValueError):
        a = ch.firpfbch2_analyzer(8, 4)
        a(a.init(), torch.zeros(100, dtype=torch.complex64))
    with pytest.raises(ValueError):
        s = ch.firpfbch2_synthesizer(8, 4)
        s(s.init(), torch.zeros(8, 3, dtype=torch.complex64))
    with pytest.raises(ValueError):
        ch.firpfbch2_analyzer(7)


@pytest.mark.parametrize("kind", KINDS)
def test_precision_takes_only_full_float32(kind):
    # HIGH and HIGHEST (JAX's enum or its name) give HIGHEST's result,
    # as the JAX package's HIGHEST; a lower precision raises
    rng = np.random.default_rng(3)
    x = tp.cnoise(rng, (8, 8) if "synth" in kind else (64,))
    make = getattr(ch, kind)
    want = tp.run_torch(make(8, 4), [x], ())[0]
    for prec in (jax.lax.Precision.HIGH, jax.lax.Precision.HIGHEST, "high",
                 "highest"):
        np.testing.assert_array_equal(
            tp.run_torch(make(8, 4, precision=prec), [x], ())[0], want)
    jwant = tp.run_jax(getattr(jch, kind)(8, 4), [x], ())[0]
    np.testing.assert_allclose(want, jwant, atol=1e-5)
    for prec in (jax.lax.Precision.DEFAULT, "bfloat16", "fastest"):
        with pytest.raises(ValueError, match="full float32"):
            make(8, 4, precision=prec)


@pytest.mark.parametrize("M,m", [(8, 5), (16, 5), (64, 5)])
def test_firpfbch2_reconstruction(M, m):
    # reference firpfbch2_crcf_autotest: loopback reconstructs the input
    # within 1e-3 (2e-3 here, as the JAX package's test) after delay
    # 2*M*m - M/2 + 1
    rng = np.random.default_rng(1)
    n = 64 * M
    x = (0.5 * tp.cnoise(rng, n) / np.sqrt(2)).astype(np.complex64)
    a, s = ch.firpfbch2_analyzer(M, m), ch.firpfbch2_synthesizer(M, m)
    Y, _ = a(a.init(), torch.from_numpy(x))
    y, _ = s(s.init(), Y)
    delay = 2 * M * m - M // 2 + 1
    assert np.abs(y.numpy()[delay:] - x[:n - delay]).max() < 2e-3


def test_firpfbch_analyzer_equivalence():
    # reference firpfbch_crcf_analyzer_autotest: channel c == mix down by
    # c/M, filter with the prototype, decimate by M (float64 numpy)
    M, m = 8, 4
    h = ch.firpfbch_kaiser_taps(M, m, 60.0).astype(np.float64)
    rng = np.random.default_rng(2)
    n = 48 * M
    x = tp.cnoise(rng, n)
    a = ch.firpfbch_analyzer(M, m)
    Y = a(a.init(), torch.from_numpy(x))[0].numpy()
    t = np.arange(n)
    for c in [0, 1, 5]:
        z = x.astype(np.complex128) * np.exp(-2j * np.pi * c * t / M)
        direct = np.convolve(z, h[: 2 * m * M])[:n][M - 1:: M]
        ratio = Y[c, 8:40] / direct[8:40]
        assert np.abs(np.abs(ratio) - 1.0).max() < 1e-3
        assert np.std(np.angle(ratio * np.conj(ratio[0]))) < 1e-3


def test_tone_channel_mapping():
    M = 16
    a = ch.firpfbch2_analyzer(M, 4)
    n = 32 * M
    for c in [0, 3, 9, 15]:
        x = np.exp(2j * np.pi * (c / M) * np.arange(n)).astype(np.complex64)
        Y = a(a.init(), torch.from_numpy(x))[0].numpy()
        power = np.mean(np.abs(Y[:, 16:]) ** 2, axis=1)
        assert int(np.argmax(power)) == c


def test_synthesis_to_analysis_delay():
    # a channel-domain impulse through synthesizer then analyzer peaks on
    # its own channel 4m - 1 channel samples later: the reference
    # autotest's wideband delay 2Mm - M/2 + 1 over the hop M/2, rounded
    for M, m in ((8, 4), (64, 4), (16, 3)):
        X = np.zeros((M, 64), np.complex64)
        X[2, 20] = 1.0
        s, a = ch.firpfbch2_synthesizer(M, m), ch.firpfbch2_analyzer(M, m)
        w, _ = s(s.init(), torch.from_numpy(X))
        Y = a(a.init(), w)[0].numpy()
        assert int(np.argmax(np.abs(Y[2]))) == 20 + round(
            (2 * M * m - M // 2 + 1) / (M // 2)) == 20 + 4 * m - 1


def _scanner_channels(rng, M, n_ch):
    """examples/wideband_scanner_example.py's channel streams at M
    channels: noise 0.002, frame64 bursts on the even channels, an
    interferer tone on channel 1; returns (channels, sent)."""
    chans = 0.002 * tp.cnoise(rng, (M, n_ch))
    chans[1] += 0.5 * np.exp(2j * np.pi * 0.05 * np.arange(n_ch))
    sent = {}
    for c in range(0, M, 2):
        pos = int(rng.integers(100, 900))
        while pos + FRAME64_LEN < n_ch - 4200:
            h = rng.integers(0, 256, 8).astype(np.uint8)
            p = rng.integers(0, 256, 64).astype(np.uint8)
            chans[c, pos:pos + FRAME64_LEN] += framegen64(h, p)
            sent.setdefault(c, []).append((pos, h, p))
            pos += FRAME64_LEN + int(rng.integers(300, 2000))
    return chans.astype(np.complex64), sent


def test_wideband_scanner_both_packages():
    # synthesize one wideband stream, channelize it again, scan every
    # channel with one batched frame64 receiver; the JAX package and the
    # port, each end to end, decode the same frames
    rng = np.random.default_rng(42)
    M, T = 8, 4096
    chans, sent = _scanner_channels(rng, M, 3 * T)
    delay = 4 * 4 - 1                           # m = 4, channel samples
    decodes = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            syn, ana = jch.firpfbch2_synthesizer(M), jch.firpfbch2_analyzer(M)
            rx = jf64.framesync64_stream_full(T)
            wide, _ = tp.run_jax(syn, [chans], ())
            streams, _ = tp.run_jax(ana, [wide], ())
            run, carry = tp.run_jax, None
        else:
            syn, ana = ch.firpfbch2_synthesizer(M), ch.firpfbch2_analyzer(M)
            rx = framesync64_stream_full(T)
            wide, _ = tp.run_torch(syn, [chans], ())
            streams, _ = tp.run_torch(ana, [wide], ())
        got = []
        c = rx.init(batch_shape=(M,))
        step = jax.jit(rx.apply) if pkg == "jax" else None
        for b in range(3):
            xb = np.ascontiguousarray(streams[:, b * T:(b + 1) * T])
            if pkg == "jax":
                out, c = step((), c, jnp.asarray(xb))
                o = {k: np.asarray(v) for k, v in out._asdict().items()}
            else:
                out, c = rx(c, torch.from_numpy(xb))
                o = {k: v.numpy() for k, v in out._asdict().items()}
            for chn, s in zip(*np.nonzero(o["valid"])):
                got.append((int(chn), int(o["sample_index"][chn, s]),
                            bool(o["crc_ok"][chn, s]),
                            o["hdr_bytes"][chn, s].astype(np.uint8).tobytes(),
                            o["pay_bytes"][chn, s].astype(np.uint8).tobytes()))
        decodes[pkg] = sorted(got)
    assert decodes["torch"] == decodes["jax"]
    want = sorted((c, s0 + delay, True, h.tobytes(), p.tobytes())
                  for c, fr in sent.items() for s0, h, p in fr)
    assert len(decodes["torch"]) == len(want) > 0
    for g, w in zip(decodes["torch"], want):
        assert g[0] == w[0] and g[2:] == w[2:] and abs(g[1] - w[1]) <= 2


@pytest.mark.parametrize("kind", KINDS)
def test_fused_stream_changes_package(kind):
    # the fused regime: two blocks in the JAX package, two more in the
    # port from its carry (carry_from_numpy), against the JAX package
    # over all four
    rng = np.random.default_rng(12)
    M = 16
    x = _input(kind, rng, M, 32, (2,))
    blocks = np.split(x, 4, axis=-1)
    jp, p = _pair(kind, M)
    _, jc = tp.run_jax(jp, blocks[:2], (2,))
    jy, jc2 = tp.run_jax(jp, blocks[2:], (2,), carry=jc)
    y, c = tp.run_torch(p, blocks[2:], (2,),
                        carry=carry_from_numpy(tp.to_numpy(jc)))
    np.testing.assert_allclose(y, jy, atol=1e-5)
    _carry_close(c, jc2, 1e-5)
