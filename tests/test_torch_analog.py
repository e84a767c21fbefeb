"""Port parity for `modem/analog.py`, the FM and AM modems.

Tolerances: the FM modulator is sample-exact (integer phase, a table
gather on both sides): equal outputs and carries; the FM demodulator
within 1e-5 absolute (float32 angle over 2*pi*kf, as the reference
golden's bound, tests/test_symsync_misc.py); the AM modulators within
1e-6 (the same FIR and products; tests/test_modem_cpm.py holds the
goldens at 1e-5), the demodulators within 1e-6."""
import pathlib

import numpy as np
import pytest
import torch

import _torch_port as tp
from liquid_dsp_tpu.modem import analog as J
from liquid_dsp_tpu_torch.convert import load_jax_params
from liquid_dsp_tpu_torch.modem import analog as P

FG = pathlib.Path(__file__).parent / "golden" / "flexframe_golden.npz"


def _msg(rng, shape, scale=1.0):
    t = np.arange(shape[-1])
    tones = (0.5 * np.cos(2 * np.pi * 0.013 * t)
             + 0.3 * np.cos(2 * np.pi * 0.003 * t))
    return (scale * tones + 0.05 * rng.standard_normal(shape)
            ).astype(np.float32)


@pytest.mark.parametrize("kf,scale", [(0.1, 1.0), (0.37, 2.0), (1.0, 100.0)])
def test_fm_modulator_is_sample_exact_against_jax(kf, scale):
    # kf 1 at |m| up to ~85 gives steps of ~5.6e6 per sample: the JAX
    # package's int32 cumsum wraps past 2^31 within 400 samples, the port's
    # int64 one does not, and the phase mod 2^16 is the same
    m = _msg(np.random.default_rng(1), (3, 1024), scale)
    blocks = [m[:, :400], m[:, 400:]]
    yj, cj = tp.run_jax(J.freq_modulator(kf), blocks, (3,))
    yt, ct = tp.run_torch(P.freq_modulator(kf), blocks, (3,))
    if scale == 100.0:
        steps = np.abs(np.round(kf * 65536 * m)).sum(-1)
        assert steps.max() > 2 ** 31
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert ct.dtype == torch.int32


def test_fm_modem_goldens():
    fg = dict(np.load(FG))
    m = torch.from_numpy(np.real(fg["freqmod_m"]).astype(np.float32))
    mod = P.freq_modulator(0.1)
    s, _ = mod(mod.init(), m)
    assert np.abs(s.numpy() - fg["freqmod_s"]).max() < 1e-5
    dem = P.freq_demodulator(0.1)
    md, _ = dem(dem.init(), torch.from_numpy(fg["freqmod_s"]))
    assert np.abs(md.numpy() - np.real(fg["freqdem_m"])).max() < 1e-5


@pytest.mark.parametrize("kf", [0.1, 0.25])
def test_fm_demodulator_matches_jax(kf):
    x = tp.cnoise(np.random.default_rng(2), (2, 900))
    blocks = [x[:, :300], x[:, 300:]]
    yj, cj = tp.run_jax(J.freq_demodulator(kf), blocks, (2,))
    yt, ct = tp.run_torch(P.freq_demodulator(kf), blocks, (2,))
    assert yt.dtype == np.float32
    np.testing.assert_allclose(yt, yj, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def test_fm_loopback():
    kf = 0.1
    msg = _msg(np.random.default_rng(3), (2048,))
    mod, dem = P.freq_modulator(kf), P.freq_demodulator(kf)
    y, _ = mod(mod.init(), torch.from_numpy(msg))
    assert np.allclose(np.abs(y.numpy()), 1.0, atol=1e-5)
    m_hat, _ = dem(dem.init(), y)
    err = np.sqrt(np.mean((m_hat.numpy()[1:] - msg[1:]) ** 2))
    assert err < 2.0 / (1024 * kf), err
    with pytest.raises(ValueError):
        P.freq_modulator(0.0)


KINDS = [(k, s) for k in ("dsb", "usb", "lsb") for s in (False, True)]


@pytest.mark.parametrize("kind,sup", KINDS)
def test_am_modem_matches_jax(kind, sup):
    m = _msg(np.random.default_rng(4), (2, 600), 0.7)
    blocks = [m[:, :250], m[:, 250:]]
    jq = J.amp_modulator(0.1, kind=kind, suppressed_carrier=sup)
    q = P.amp_modulator(0.1, kind=kind, suppressed_carrier=sup)
    load_jax_params(q, tp.jax_params(jq))
    yj, cj = tp.run_jax(jq, blocks, (2,))
    yt, ct = tp.run_torch(q, blocks, (2,))
    np.testing.assert_allclose(yt, yj, atol=1e-6, rtol=0)
    if kind != "dsb":
        np.testing.assert_allclose(ct["tail_h"].numpy(),
                                   np.asarray(cj["tail_h"]), atol=0)
    jd = J.amp_demodulator(0.1, kind=kind, suppressed_carrier=sup)
    d = P.amp_demodulator(0.1, kind=kind, suppressed_carrier=sup)
    zj, _ = tp.run_jax(jd, [yj], (2,))
    zt, _ = tp.run_torch(d, [yj.astype(np.complex64)], (2,))
    assert zt.dtype == np.float32
    np.testing.assert_allclose(zt, zj, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind,sup", [("dsb", False), ("usb", True),
                                      ("lsb", False)])
def test_am_goldens(kind, sup):
    g = dict(np.load(FG))
    x = torch.from_numpy(np.real(g["amp_x"]).astype(np.float32))
    am = P.amp_modulator(0.1, kind=kind, suppressed_carrier=sup)
    y, _ = am(am.init(), x)
    assert np.abs(y.numpy() - g[f"amp_{kind}"]).max() < 1e-5


def test_am_ssb_loopback_and_bad_kind():
    msg = np.cos(2 * np.pi * 0.02 * np.arange(2048)).astype(np.float32)
    mod = P.amp_modulator(kind="usb", suppressed_carrier=True)
    dem = P.amp_demodulator(kind="usb", suppressed_carrier=True)
    y, _ = mod(mod.init(), torch.from_numpy(msg))
    m_hat, _ = dem(dem.init(), y)
    d = 18          # the Hilbert form's delay, 2m (ampmodem.c:95)
    err = np.sqrt(np.mean((m_hat.numpy()[d:] - msg[:-d]) ** 2)
                  / np.mean(msg ** 2))
    assert err < 0.02, err
    with pytest.raises(ValueError):
        P.amp_modulator(kind="vsb")


def test_hilbert_taps_and_carries_equal_jax():
    for m in (5, 25):
        np.testing.assert_array_equal(P._hilbert_taps(m), J._hilbert_taps(m))
    for make in ("freq_modulator", "freq_demodulator"):
        cj = getattr(J, make)(0.1).init(batch_shape=(2,))
        c = getattr(P, make)(0.1).init(batch_shape=(2,))
        assert tuple(c.shape) == cj.shape
        assert str(c.dtype)[6:] == str(cj.dtype)
