"""Port parity: the flexframe PHY pair and its receivers
(`liquid_dsp_tpu_torch.framing.flexframe`) against the reference C
library's frames (tests/golden/flexframe_golden.npz) and the JAX package,
on the same seeded inputs.

Tolerances: flexframegen within 1e-5 of the reference's samples
(tests/test_flexframes.py) and of the JAX package's; per receiver block
`valid`, `sample_index`, header and payload bytes and both CRC verdicts
exactly, `rxy` and `evm_db` within 1e-4 (relative to the largest value);
the header-stage symbols within 1e-4 of their rms.  Both sides compute in
float32 with their own FFT and matmul libraries.  The stream cases of
tests/test_flexframe_stream.py run on the port at T <= 4096."""
import pathlib

import numpy as np
import pytest
import torch

import _torch_port as tp
from _golden_frames import lcg_bytes
import jax
import jax.numpy as jnp
from liquid_dsp_tpu.framing import flexframe as jff
from liquid_dsp_tpu_torch.framing import wire
from liquid_dsp_tpu.framing import wire as jwire
from liquid_dsp_tpu_torch.framing.flexframe import (
    FLEXFRAME_H_USER, FlexFrameSync, flexframe_rx_stream,
    flexframe_rx_stream_multi, flexframegen, flexframesync,
    flexframesync_stream)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "flexframe_golden.npz"
CASES = [("ffg_a", 64, "crc32", "none", "golay2412", "qpsk", 21),
         ("ffg_b", 40, "crc16", "hamming128", "none", "qam16", 33),
         ("ffg_c", 100, "crc32", "secded7264", "hamming84", "psk8", 55)]


@pytest.fixture(scope="module")
def fg():
    return dict(np.load(GOLDEN))


def _mkframe(rng, n=64, **kw):
    h = rng.integers(0, 256, FLEXFRAME_H_USER).astype(np.uint8)
    p = rng.integers(0, 256, n).astype(np.uint8)
    return h, p, flexframegen(h, p, **kw)


def _stream(rng, frames, gaps, tail=2000, noise=0.005, T=None):
    """Frames after the given gaps in noise; zero-padded to a whole
    number of T-blocks plus two flush blocks when T is given."""
    parts, starts, pos = [], [], 0
    for (h, p, f), gap in zip(frames, gaps):
        parts.append(np.zeros(gap, np.complex64))
        pos += gap
        starts.append(pos)
        parts.append(f)
        pos += len(f)
    parts.append(np.zeros(tail, np.complex64))
    x = np.concatenate(parts)
    x = (x + noise * tp.cnoise(rng, len(x))).astype(np.complex64)
    if T:
        x = np.concatenate([x, np.zeros((-len(x)) % T + 2 * T,
                                        np.complex64)])
    return x, starts


# --- transmitter and wire format --------------------------------------------

@pytest.mark.parametrize("tag,n,crc,fec0,fec1,ms,seed", CASES)
def test_flexframegen_sample_exact(fg, tag, n, crc, fec0, fec1, ms, seed):
    h, p = lcg_bytes(14, seed), lcg_bytes(n, seed + 1)
    y = flexframegen(h, p, crc=crc, fec0=fec0, fec1=fec1, ms=ms)
    assert y.dtype == np.complex64 and len(y) == len(fg[tag])
    assert np.abs(y - fg[tag]).max() < 1e-5
    want = jff.flexframegen(h, p, crc=crc, fec0=fec0, fec1=fec1, ms=ms)
    assert np.abs(y - want).max() < 1e-5


def test_wire_tables_match_jax():
    for a in ("CRC_WIRE", "FEC_WIRE", "MODEM_WIRE"):
        assert getattr(wire, a) == getattr(jwire, a)
    for i in range(len(wire.MODEM_WIRE)):
        for f, jf in ((wire.modem_from_wire, jwire.modem_from_wire),
                      (wire.fec_from_wire, jwire.fec_from_wire),
                      (wire.crc_from_wire, jwire.crc_from_wire)):
            try:
                want = jf(i)
            except ValueError:
                with pytest.raises(ValueError):
                    f(i)
                continue
            assert f(i) == want
    assert wire.modem_to_wire("QAM16") == jwire.modem_to_wire("qam16")
    with pytest.raises(ValueError):
        wire.fec_to_wire("turbo")
    with pytest.raises(ValueError):
        flexframegen(np.zeros(5, np.uint8), np.zeros(10, np.uint8))


# --- the one-shot and host-loop receivers -----------------------------------

@pytest.mark.parametrize("tag,n,crc,fec0,fec1,ms,seed", CASES)
def test_flexframesync_decodes_reference_frames(fg, tag, n, crc, fec0, fec1,
                                                ms, seed):
    x = np.concatenate([np.zeros(50, np.complex64), fg[tag],
                        np.zeros(50, np.complex64)])
    r = flexframesync(x, device="cpu")
    rj = jff.flexframesync(x)
    assert r.detected and r.header_ok and r.crc_ok and r.ms == ms
    np.testing.assert_array_equal(r.header, lcg_bytes(14, seed))
    np.testing.assert_array_equal(r.payload, lcg_bytes(n, seed + 1))
    assert r.payload_len == rj.payload_len == n
    assert abs(r.evm_db - rj.evm_db) < 1e-2


def test_flexframesync_impaired_and_noise():
    rng = np.random.default_rng(9)
    h, p, f = _mkframe(rng, 80)
    x = np.concatenate([np.zeros(120, np.complex64), f,
                        np.zeros(120, np.complex64)])
    t = np.arange(len(x))
    x = 0.6 * x * np.exp(1j * (0.003 * t + 0.9))
    x = (x + 0.02 * tp.cnoise(rng, len(x))).astype(np.complex64)
    r = flexframesync(x, device="cpu")
    assert r.crc_ok and np.array_equal(r.payload, p)
    assert not flexframesync(0.3 * tp.cnoise(rng, 6000), device="cpu").detected


def _run_sync(x, block_len=4096, **kw):
    fs = FlexFrameSync(block_len=block_len, device="cpu", **kw)
    return fs.execute(x) + fs.flush()


def test_flexframe_sync_decodes_the_reference_stream(fg):
    # ffg_a decodes on the device decoder, ffg_b (hamming128 inner) and
    # ffg_c (secded7264 + hamming84) on the host, after the conv
    # decoders' ValueError; the JAX package's wrapper gives the same
    parts = []
    for tag, *_ in CASES:
        parts += [np.zeros(700, np.complex64), fg[tag]]
    x = np.concatenate(parts + [np.zeros(500, np.complex64)])
    hits = []
    fs = FlexFrameSync(callback=lambda *a: hits.append(a), device="cpu")
    got = fs.execute(x) + fs.flush()
    assert len(got) == len(hits) == fs.num_frames_detected == 3
    want = jff.FlexFrameSync()
    want = want.execute(x) + want.flush()
    keys = list(fs._dev_fec_cache)
    assert [fs._dev_fec_cache[k] is None for k in keys] == [False, True, True]
    for (tag, n, crc, fec0, fec1, ms, seed), g, w in zip(CASES, got, want):
        gh, hok, gp, pok, st = g
        assert hok and pok and st["ms"] == ms and st["payload_len"] == n
        np.testing.assert_array_equal(gh, lcg_bytes(14, seed))
        np.testing.assert_array_equal(gp, lcg_bytes(n, seed + 1))
        np.testing.assert_array_equal(gp, w[2])
        assert st["sample_index"] == w[4]["sample_index"]
        assert abs(st["cfo"] - w[4]["cfo"]) < 1e-5
        assert abs(st["evm_db"] - w[4]["evm_db"]) < 1e-2


def test_flexframe_sync_mixed_schemes_straddling_blocks():
    rng = np.random.default_rng(1)
    specs = [dict(n=64, ms="qpsk", fec1="golay2412"),
             dict(n=40, ms="qam16", fec0="hamming128", fec1="none"),
             dict(n=100, ms="psk8", fec0="secded7264", fec1="hamming84"),
             dict(n=17, ms="bpsk", fec1="none")]
    frames = [_mkframe(rng, s.pop("n"), **s) for s in specs]
    x, starts = _stream(rng, frames, [300, 1900, 600, 2500])
    got = _run_sync(x, block_len=2048)
    assert len(got) == 4
    for (h, p, _), (gh, hok, gp, pok, st), s0 in zip(frames, got, starts):
        assert hok and pok
        np.testing.assert_array_equal(gh, h)
        np.testing.assert_array_equal(gp, p)
        assert abs(st["sample_index"] - s0) <= 2
    assert _run_sync(0.3 * tp.cnoise(rng, 12000)) == []


def test_conv_payload_raises_naming_4b():
    # (named when the convolutional payloads still raised; a test whose
    # check changes keeps its name) the conv payloads are ported: the
    # generator and the full receivers take them (their parity with the
    # JAX package: test_conv_payload_receivers_match_jax); a config with
    # no device decoder still raises ValueError
    rng = np.random.default_rng(3)
    h, p, _ = _mkframe(rng, 8)
    f = flexframegen(h, p, fec1="v27")
    np.testing.assert_allclose(f, jff.flexframegen(h, p, fec1="v27"),
                               atol=1e-5)
    flexframe_rx_stream(2048, 32, fec0="v27", fec1="none")
    flexframe_rx_stream_multi(2048, [(32, "crc32", "v27", "none", "qpsk")])
    with pytest.raises(ValueError):
        flexframe_rx_stream(2048, 32, fec0="secded7264", fec1="hamming84")


def test_entry_points_default_to_the_card_and_raise_without_one():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA card"):
        flexframesync(np.zeros(4000, np.complex64))
    with pytest.raises(RuntimeError, match="CUDA card"):
        FlexFrameSync()


# --- the stream Procs against the JAX package -------------------------------

def _blocks_equal(o, oj, keys_exact, keys_close=("rxy", "evm_db")):
    v = np.asarray(oj.valid)
    np.testing.assert_array_equal(o.valid.numpy(), v)
    np.testing.assert_array_equal(o.sample_index.numpy(),
                                  np.asarray(oj.sample_index))
    if not v.any():
        return
    for key in keys_exact:
        np.testing.assert_array_equal(getattr(o, key).numpy()[v],
                                      np.asarray(getattr(oj, key))[v], key)
    for key in keys_close:
        a, b = getattr(o, key).numpy()[v], np.asarray(getattr(oj, key))[v]
        assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), 1.0), key


def _drain_both(proc, jproc, x, T, keys):
    """Stream x through the port Proc and the JAX one, block by block,
    checking each block; returns the port's decodes."""
    step = jax.jit(jproc.apply)
    lead = x.shape[:-1]
    c, cj = proc.init(batch_shape=lead), jproc.init(batch_shape=lead)
    found = []
    for b in range(x.shape[-1] // T):
        blk = np.ascontiguousarray(x[..., b * T:(b + 1) * T])
        o, c = proc(c, torch.from_numpy(blk))
        oj, cj = step((), cj, jnp.asarray(blk))
        _blocks_equal(o, oj, keys)
        for idx in zip(*np.nonzero(o.valid.numpy())):
            found.append({k: getattr(o, k)[idx].numpy()
                          for k in ("sample_index", "hdr_ok", "hdr_bytes",
                                    "pay_ok", "pay_bytes")
                          + (("cfg_idx",) if hasattr(o, "cfg_idx") else ())})
    return found


RX_KEYS = ("hdr_bytes", "hdr_ok", "pay_bytes", "pay_ok")


def test_flexframesync_stream_matches_jax():
    rng = np.random.default_rng(8)
    T = 2048
    frames = [_mkframe(rng, 20), _mkframe(rng, 20, ms="qam16")]
    x, starts = _stream(rng, frames, [300, 1500], T=T)
    proc, jproc = flexframesync_stream(T), jff.flexframesync_stream(T)
    step = jax.jit(jproc.apply)
    c, cj = proc.init(), jproc.init()
    n = 0
    for b in range(len(x) // T):
        blk = x[b * T:(b + 1) * T]
        o, c = proc(c, torch.from_numpy(blk.copy()))
        oj, cj = step((), cj, jnp.asarray(blk))
        _blocks_equal(o, oj, (), ("rxy", "gamma", "g2"))
        v = np.asarray(oj.valid)
        if v.any():
            assert tp.rel_err(o.region_syms.numpy()[v],
                              np.asarray(oj.region_syms)[v]) < 1e-4
        n += int(v.sum())
    assert n == 2


def test_flexframe_rx_stream_matches_jax():
    # tests/test_flexframe_stream.py's full-receiver cases on two
    # channels: three frames straddling block boundaries on one; a frame
    # with CFO 0.002 rad/sample at ~20 dB SNR and a frame announcing
    # another modulation (hdr_ok False) on the other
    rng = np.random.default_rng(0)
    T, PL = 2048, 40
    frames = [_mkframe(rng, PL) for _ in range(3)]
    x0, starts0 = _stream(rng, frames, [1500, 900, 1100], tail=4000,
                          noise=0.003)
    h, p, f = _mkframe(rng, PL)
    f = (f * np.exp(1j * (0.002 * np.arange(len(f)) + 0.7))
         ).astype(np.complex64)
    hw, pw, fw = _mkframe(rng, PL, ms="qam16")
    x1, starts1 = _stream(rng, [(h, p, f), (hw, pw, fw)], [700, 1200],
                          tail=3000, noise=0.01)
    n = max(len(x0), len(x1))
    n += (-n) % T + 2 * T
    x = np.zeros((2, n), np.complex64)
    x[0, :len(x0)], x[1, :len(x1)] = x0, x1
    found = _drain_both(flexframe_rx_stream(T, PL),
                        jff.flexframe_rx_stream(T, PL), x, T, RX_KEYS)
    assert len(found) == 5
    sent = list(zip(frames, starts0)) + [((h, p, f), starts1[0])]
    ok = [d for d in found if d["hdr_ok"]]
    assert len(ok) == 4
    for (hs, ps, _), s0 in sent:
        m = [d for d in ok if abs(int(d["sample_index"]) - s0) <= 2]
        assert len(m) == 1 and m[0]["pay_ok"]
        np.testing.assert_array_equal(m[0]["hdr_bytes"][:FLEXFRAME_H_USER],
                                      hs)
        np.testing.assert_array_equal(m[0]["pay_bytes"], ps)
    bad = [d for d in found if not d["hdr_ok"]]
    assert len(bad) == 1 and abs(int(bad[0]["sample_index"])
                                 - starts1[1]) <= 2


def test_flexframe_rx_stream_multi_matches_jax():
    # the registered set of block configs (conv configs:
    # test_conv_payload_receivers_match_jax); one frame of an
    # unregistered config
    configs = [(48, "crc32", "none", "golay2412", "qpsk"),
               (96, "crc16", "none", "hamming128", "qam16"),
               (24, "crc24", "none", "hamming74", "psk8")]
    rng = np.random.default_rng(11)
    T = 2048
    order = [0, 1, 2, 1, -1, 0]
    frames = []
    for j in order:
        pl, crc, fec0, fec1, ms = configs[j] if j >= 0 else (
            20, "crc32", "none", "golay2412", "qam64")
        h = rng.integers(0, 256, FLEXFRAME_H_USER).astype(np.uint8)
        p = rng.integers(0, 256, pl).astype(np.uint8)
        frames.append((h, p, flexframegen(h, p, crc=crc, fec0=fec0,
                                          fec1=fec1, ms=ms)))
    x, starts = _stream(rng, frames, [900, 1300, 2100, 1000, 1500, 1200],
                        tail=3000, noise=0.004, T=T)
    found = _drain_both(flexframe_rx_stream_multi(T, configs),
                        jff.flexframe_rx_stream_multi(T, configs), x, T,
                        RX_KEYS + ("cfg_idx",))
    assert len(found) == len(frames)
    for d, j, (h, p, _), s0 in zip(found, order, frames, starts):
        assert abs(int(d["sample_index"]) - s0) <= 2
        assert int(d["cfg_idx"]) == j and bool(d["hdr_ok"]) == (j >= 0)
        if j >= 0:
            assert d["pay_ok"]
            np.testing.assert_array_equal(d["hdr_bytes"][:FLEXFRAME_H_USER],
                                          h)
            np.testing.assert_array_equal(d["pay_bytes"][:len(p)], p)


@pytest.mark.parametrize("fec0,fec1,ms", [("v27", "none", "qpsk"),
                                          ("none", "v29p34", "qam16")])
def test_conv_payload_receivers_match_jax(fec0, fec1, ms):
    # a v27 and a v29p34 payload through flexframe_rx_stream, the
    # registered-set receiver (with a block config beside it) and
    # FlexFrameSync (the device conv decoder): the JAX package's decodes
    cfg = (24, "crc32", fec0, fec1, ms)
    configs = [cfg, (24, "crc32", "none", "golay2412", "qpsk")]
    rng = np.random.default_rng(zlib_seed(fec0, fec1))
    T = 2048
    frames = [_mkframe(rng, 24, crc="crc32", fec0=fec0, fec1=fec1, ms=ms)
              for _ in range(2)]
    h, p = frames[0][0], frames[0][1]
    np.testing.assert_allclose(
        frames[0][2], jff.flexframegen(h, p, crc="crc32", fec0=fec0,
                                       fec1=fec1, ms=ms), atol=1e-5)
    x, starts = _stream(rng, frames, [900, 1300], tail=2000, noise=0.004,
                        T=T)
    for proc, jproc, keys in (
            (flexframe_rx_stream(T, *cfg), jff.flexframe_rx_stream(T, *cfg),
             RX_KEYS),
            (flexframe_rx_stream_multi(T, configs),
             jff.flexframe_rx_stream_multi(T, configs),
             RX_KEYS + ("cfg_idx",))):
        found = _drain_both(proc, jproc, x, T, keys)
        assert len(found) == 2
        for d, (hs, ps, _), s0 in zip(found, frames, starts):
            assert abs(int(d["sample_index"]) - s0) <= 2
            assert d["hdr_ok"] and d["pay_ok"]
            np.testing.assert_array_equal(d["pay_bytes"][:24], ps)
    got = _run_sync(x)
    fs = jff.FlexFrameSync(block_len=4096)
    want = fs.execute(x) + fs.flush()
    assert len(got) == len(want) == 2
    assert fs._dev_fec_cache[cfg] is not None
    for (gh, hok, gp, pok, st), (jh, jhok, jp, jpok, jst), (hs, ps, _) in zip(
            got, want, frames):
        assert hok and pok and jhok and jpok
        np.testing.assert_array_equal(gh, jh)
        np.testing.assert_array_equal(gp, jp)
        np.testing.assert_array_equal(gp, ps)
        assert st["sample_index"] == jst["sample_index"]


def zlib_seed(*parts):
    import zlib
    return zlib.crc32("-".join(parts).encode())
