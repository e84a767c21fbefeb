"""Port parity: the OFDM PHY (`liquid_dsp_tpu_torch.multichannel.ofdm`)
against the JAX package and the reference C library's OFDM symbols
(tests/golden/flexframe_golden.npz), on the same seeded inputs.

Tolerances: the allocation, the S0/S1 sequences and the demodulator's
constants exactly; the generator within 1e-6 of the JAX package's and
1e-5 of the goldens (tests/test_flexframes.py).  ofdm_frame_sync on the
JAX tests' impairments (tests/test_ofdm.py): `detected` and
`sample_index` equal, `cfo_hat` within 1e-6, `data_syms` within 1e-4,
`evm_db` within 0.05 dB where either side is above -100 dB (below, the
pilot error is float32 rounding noise and the dB values are not
comparable: the clean cases measured -132.7 to -142.5 dB, up to 2.6 dB
apart).  The streaming detector: `valid` and `sample_index` and the
carry equal, `cfo` and `rxy` within 1e-6.  Both sides compute in float32 with their
own FFT and matmul libraries; the measured maxima are in the comments."""
import pathlib

import numpy as np
import pytest
import torch

import _torch_port as tp
import jax
import jax.numpy as jnp
from liquid_dsp_tpu.multichannel import ofdm as jofdm
from liquid_dsp_tpu_torch.convert import carry_from_numpy, carry_to_numpy
from liquid_dsp_tpu_torch.modem import constellation
from liquid_dsp_tpu_torch.multichannel import ofdm

GOLDEN = pathlib.Path(__file__).parent / "golden" / "flexframe_golden.npz"


def _frame(M=64, cp=16, n_syms=10, seed=0, ms="qpsk"):
    """tests/test_ofdm.py's frame: random symbols of `ms` through both
    generators."""
    rng = np.random.default_rng(seed)
    table = constellation(ms).astype(np.complex64)
    par = ofdm.ofdm_params(M, cp)
    sidx = rng.integers(0, len(table), (n_syms, par.M_data))
    return par, jofdm.ofdm_params(M, cp), table[sidx]


@pytest.mark.parametrize("M,cp", [(64, 16), (32, 8), (128, 32), (16, 4)])
def test_params_match_jax(M, cp):
    got, want = ofdm.ofdm_params(M, cp), jofdm.ofdm_params(M, cp)
    for name in got._fields:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), name
        else:
            assert g == w, name
    np.testing.assert_array_equal(ofdm.default_sctype(M),
                                  jofdm.default_sctype(M))


def test_default_sctype_counts():
    p = ofdm.default_sctype(64)
    assert p[0] == ofdm.SCTYPE_NULL
    assert np.sum(p == ofdm.SCTYPE_PILOT) == 6
    assert np.sum(p == ofdm.SCTYPE_DATA) == 44
    assert np.sum(ofdm.default_sctype(32) == ofdm.SCTYPE_PILOT) >= 2


@pytest.mark.parametrize("bins,match", [
    # tests/test_ofdm.py's case (one odd data bin: S0 has no bin), all
    # null, and one pilot only
    ({1: ofdm.SCTYPE_DATA}, "no subcarriers"), ({}, "no subcarriers"),
    ({2: ofdm.SCTYPE_DATA, 4: ofdm.SCTYPE_PILOT}, "two pilot")])
def test_params_validation(bins, match):
    p = np.zeros(16, np.uint8)
    for i, t in bins.items():
        p[i] = t
    for mod in (ofdm, jofdm):
        with pytest.raises(ValueError, match=match):
            mod.ofdm_params(16, 4, p=p)


@pytest.mark.parametrize("M,cp,ms", [(64, 16, "qpsk"), (64, 16, "qam16"),
                                     (32, 8, "qpsk"), (128, 32, "qpsk")])
def test_generate_frame_matches_jax(M, cp, ms):
    par, jpar, data = _frame(M, cp, 6, seed=M, ms=ms)
    got = ofdm.ofdm_generate_frame(par, data)
    want = jofdm.ofdm_generate_frame(jpar, data)
    assert got.dtype == np.complex64 and got.shape == want.shape
    assert np.abs(got - want).max() < 1e-6       # measured 0
    with pytest.raises(ValueError, match="data symbols"):
        ofdm.ofdm_generate_frame(par, data[:, 1:])


def test_generate_frame_matches_the_reference_symbols():
    # tests/test_flexframes.py::test_raw_ofdm_layer_sample_exact: three
    # data symbols from the generator's LCG against the C library's
    fg = dict(np.load(GOLDEN))
    par = ofdm.ofdm_params(64, 16)
    assert np.array_equal(par.p, np.real(fg["ofdm_sct_64"]).astype(int))
    state = [123]

    def nxt():
        state[0] = (state[0] * 1103515245 + 12345) & 0xFFFFFFFF
        return ((state[0] >> 16) & 0xFF) / 127.5 - 1.0

    data = [[nxt() + 1j * nxt() for i in range(64)
             if par.p[i] == ofdm.SCTYPE_DATA] for _ in range(3)]
    y = ofdm.ofdm_generate_frame(par, np.asarray(data, np.complex64))
    ref = np.concatenate([fg[f"ofdm_{t}_64_16"] for t in
                          ("s0a", "s0b", "s1", "d0", "d1", "d2")])
    assert np.abs(y - ref).max() < 1e-5


@pytest.mark.parametrize("n_syms", [1, 7, 20])
def test_demod_consts_match_jax(n_syms):
    par = ofdm.ofdm_params(64, 16)
    got = ofdm.ofdm_demod_consts(par, n_syms)
    want = jofdm.ofdm_demod_consts(jofdm.ofdm_params(64, 16), n_syms)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), k
        else:
            assert g == w, k
    dc = ofdm.DemodConsts(got)
    assert dc["WIN"] == want["WIN"] and dc["on_idx"].dtype == torch.int64
    np.testing.assert_array_equal(dc["pilots"].numpy(), want["pilots"])


def _impair(case, frame, rng):
    """The impairments of tests/test_ofdm.py's loopback cases."""
    z = np.zeros
    if case == "clean":
        return np.concatenate([z(100, np.complex64), frame,
                               z(100, np.complex64)])
    if case.startswith("cfo"):
        cfo = float(case[3:])
        x = np.concatenate([z(80, np.complex64), frame, z(80, np.complex64)])
        t = np.arange(len(x))
        return (x * np.exp(1j * (cfo * t + 1.0))).astype(np.complex64)
    if case == "awgn20":
        x = np.concatenate([z(120, np.complex64), frame,
                            z(80, np.complex64)])
        s = 10 ** (-20 / 20) * np.sqrt(np.mean(np.abs(frame) ** 2))
        return (x + s / np.sqrt(2) * tp.cnoise(rng, len(x))
                ).astype(np.complex64)
    if case == "multipath":
        h = np.zeros(6, np.complex64)
        h[0], h[3], h[5] = 1.0, 0.3 - 0.2j, -0.1j
        x = np.concatenate([z(64, np.complex64), frame, z(64, np.complex64)])
        return np.convolve(x, h)[:len(frame) + 128].astype(np.complex64)
    raise ValueError(case)


def _sync_both(par, jpar, x, n_syms):
    got = ofdm.ofdm_frame_sync(par, x, n_syms, device="cpu")
    want = jofdm.ofdm_frame_sync(jpar, x, n_syms)
    assert got.detected == want.detected
    assert got.sample_index == want.sample_index
    assert abs(got.cfo_hat - want.cfo_hat) < 1e-6     # measured 4.8e-11
    if want.detected:
        assert got.data_syms.shape == want.data_syms.shape
        # measured 1.1e-6
        assert np.abs(got.data_syms - want.data_syms).max() < 1e-4
        # measured 2.3e-5 dB above -100 dB
        assert abs(got.evm_db - want.evm_db) < 0.05 or \
            max(got.evm_db, want.evm_db) < -100
    return got


@pytest.mark.parametrize("case,ms,seed", [
    ("clean", "qpsk", 0), ("cfo0.005", "qpsk", 1), ("cfo-0.012", "qpsk", 1),
    ("awgn20", "qpsk", 2), ("multipath", "qpsk", 4), ("clean", "qam16", 5)])
def test_frame_sync_matches_jax(case, ms, seed):
    par, jpar, data = _frame(seed=seed, ms=ms)
    frame = ofdm.ofdm_generate_frame(par, data)
    x = _impair(case, frame, np.random.default_rng(seed + 1))
    got = _sync_both(par, jpar, x, 10)
    assert got.detected
    table = constellation(ms).astype(np.complex64)
    dec = np.argmin(np.abs(got.data_syms.reshape(-1, 1) - table), axis=1)
    sent = np.argmin(np.abs(data.reshape(-1, 1) - table), axis=1)
    assert np.mean(dec != sent) < 0.01


def test_frame_sync_noise_only_matches_jax():
    par, jpar, _ = _frame()
    rng = np.random.default_rng(6)
    x = (0.3 * tp.cnoise(rng, 2000)).astype(np.complex64)
    got = _sync_both(par, jpar, x, 4)
    assert not got.detected or got.data_syms is None


@pytest.mark.parametrize("M,cp", [(32, 8), (128, 32)])
def test_frame_sync_other_sizes_match_jax(M, cp):
    par, jpar, data = _frame(M, cp, 6, seed=7)
    frame = ofdm.ofdm_generate_frame(par, data)
    x = np.concatenate([np.zeros(70, np.complex64), frame,
                        np.zeros(70, np.complex64)])
    assert _sync_both(par, jpar, x, 6).detected


def test_demod_window_matches_jax():
    # frame_demod_core on raw windows at the coarse plateau, batched over
    # three candidates (a clean frame, CFO, zeros) against the JAX
    # package's jitted per-candidate function
    par, jpar, data = _frame(n_syms=5, seed=9)
    frame = ofdm.ofdm_generate_frame(par, data)
    fn, win_len = ofdm.frame_demod_core(par, 5)
    jfn, jwin_len = jofdm.frame_demod_core(jpar, 5)
    assert win_len == jwin_len
    rng = np.random.default_rng(9)
    wins, cfos = np.zeros((3, win_len), np.complex64), [0.0, 0.003, 0.0]
    for k, lead in enumerate((23, 41)):
        x = np.concatenate([np.zeros(lead, np.complex64), frame])[:win_len]
        t = np.arange(len(x))
        wins[k, :len(x)] = x * np.exp(1j * cfos[k] * t) + \
            0.01 * tp.cnoise(rng, len(x))
    cfo = torch.tensor(cfos, dtype=torch.float32)
    best, data_g, perr, cfo_out = fn(torch.from_numpy(wins), cfo)
    assert fn is ofdm.frame_demod_core(par, 5)[0]       # cached
    for k in range(3):
        jb, jd, jp, jc = jfn(jnp.asarray(wins[k]), jnp.float32(cfos[k]))
        assert int(best[k]) == int(jb)
        assert np.abs(data_g[k].numpy() - np.asarray(jd)).max() < 1e-4
        assert np.abs(perr[k].numpy() - np.asarray(jp)).max() < 1e-4
        assert abs(float(cfo_out[k]) - float(jc)) < 1e-6
    # the all-zero window: finite, zero data, cfo unchanged
    assert torch.isfinite(perr[2]).all() and not data_g[2].abs().any()


def _det_stream(rng, T, n_blk):
    """Two channels of frames (one across a block boundary) in noise; the
    last block flushes the detector's history."""
    par, jpar, data = _frame(n_syms=4, seed=3)
    f = ofdm.ofdm_generate_frame(par, data)
    x = np.zeros((2, n_blk * T), np.complex64)
    for ch, s0 in ((0, 300), (0, T - len(f) // 2), (1, 1500),
                   (1, 2 * T + 700)):
        x[ch, s0:s0 + len(f)] = f * np.exp(1j * 0.002 * np.arange(len(f)))
    return par, jpar, (x + 0.01 * tp.cnoise(rng, x.shape)).astype(
        np.complex64)


def test_detector_stream_matches_jax():
    T = 2048
    par, jpar, x = _det_stream(np.random.default_rng(3), T, 4)
    proc = ofdm.ofdm_detector_stream(T, par)
    jproc = jofdm.ofdm_detector_stream(T, jpar)
    step = jax.jit(jproc.apply)
    c, cj = proc.init(batch_shape=(2,)), jproc.init(batch_shape=(2,))
    n = 0
    for b in range(4):
        blk = np.ascontiguousarray(x[:, b * T:(b + 1) * T])
        o, c = proc(c, torch.from_numpy(blk))
        oj, cj = step((), cj, jnp.asarray(blk))
        np.testing.assert_array_equal(o.valid.numpy(), np.asarray(oj[0]))
        np.testing.assert_array_equal(o.sample_index.numpy(),
                                      np.asarray(oj[1]))
        assert o.sample_index.dtype == torch.int32
        assert np.abs(o.cfo.numpy() - np.asarray(oj[2])).max() < 1e-6
        assert np.abs(o.rxy.numpy() - np.asarray(oj[3])).max() < 1e-6
        for k, v in tp.to_numpy(cj).items():
            g = carry_to_numpy(c)[k]
            assert g.dtype == v.dtype and g.shape == v.shape, k
            np.testing.assert_array_equal(g, v, k)
        n += int(o.valid.sum())
    assert n == 4


def test_detector_stream_carry_handed_from_jax():
    # block 0 in the JAX package, blocks 1-2 in the port from its carry:
    # the same detections as a stream run whole in either package
    T = 2048
    par, jpar, x = _det_stream(np.random.default_rng(3), T, 4)
    proc = ofdm.ofdm_detector_stream(T, par)
    jproc = jofdm.ofdm_detector_stream(T, jpar)
    step = jax.jit(jproc.apply)
    whole, handed = [], []
    cj, c = jproc.init(batch_shape=(2,)), proc.init(batch_shape=(2,))
    for b in range(4):
        blk = np.ascontiguousarray(x[:, b * T:(b + 1) * T])
        oj, cj = step((), cj, jnp.asarray(blk))
        o, c = proc(c, torch.from_numpy(blk))
        whole.append((np.asarray(oj[0]), np.asarray(oj[1])))
        if b == 0:
            handed.append(whole[0])
            ch = carry_from_numpy(tp.to_numpy(cj))
        else:
            oh, ch = proc(ch, torch.from_numpy(blk))
            handed.append((oh.valid.numpy(), oh.sample_index.numpy()))
        np.testing.assert_array_equal(o.sample_index.numpy()[o.valid.numpy()],
                                      whole[-1][1][whole[-1][0]])
    for (va, ia), (vb, ib) in zip(whole, handed):
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(ia[va], ib[vb])


def test_entry_point_defaults_to_the_card_and_raises_without_one():
    assert not torch.cuda.is_available()
    par = ofdm.ofdm_params()
    with pytest.raises(RuntimeError, match="CUDA card"):
        ofdm.ofdm_frame_sync(par, np.zeros(2000, np.complex64), 4)
