"""Port parity for ops/resample.py's rate converters: the reference C
library's goldens (resamp 2/3 and 5/4, the halfband decimator and
interpolator, the QMF analyzer and synthesizer, the 2-stage msresamp2
cascades) within 1e-5 as tests/test_resample.py holds the JAX package;
resamp's routes against each other and against the JAX package's
(2e-5 absolute at unit input power, tests/test_resample.py:306-321);
msresamp at interpolating, decimating and arbitrary rates, streamed over
3 carried blocks against the JAX package (1e-5 of rms)."""
import pathlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import _torch_port as tp
from liquid_dsp_tpu.ops import resample as jresample
from liquid_dsp_tpu_torch.convert import (carry_from_numpy, carry_to_numpy,
                                          load_jax_params)
from liquid_dsp_tpu_torch.ops import resample

from test_resample import spectral_peak_and_sidelobe, windowed_tone

GOLDEN = pathlib.Path(__file__).parent / "golden" / "flexframe_golden.npz"
RATES = [(3, 2), (5, 4), (2, 3), (7, 5), (1, 2), (4, 1), (13, 8)]


@pytest.fixture(scope="module")
def fg():
    return dict(np.load(GOLDEN))


def _oneshot(proc, x):
    x = torch.from_numpy(np.asarray(x))
    y, _ = proc(proc.init(dtype=x.dtype), x)
    return y.numpy()


@pytest.mark.parametrize("backend", ["auto", "conv", "matmul"])
@pytest.mark.parametrize("name,num,den", [("resamp_23", 2, 3),
                                          ("resamp_54", 5, 4)])
def test_resamp_golden(fg, name, num, den, backend):
    p = resample.resamp((num, den), m=7, fc=0.25, as_db=60.0, npfb=64,
                        backend=backend)
    y = _oneshot(p, fg[f"{name}_x"])
    assert y.shape == fg[f"{name}_y"].shape
    assert np.abs(y - fg[f"{name}_y"]).max() < 1e-5


@pytest.mark.parametrize("name,make", [
    ("r2_decim", lambda: resample.resamp2_decim(7, 0.0, 60.0)),
    ("r2_interp", lambda: resample.resamp2_interp(7, 0.0, 60.0)),
    ("ms2_d", lambda: resample.msresamp2("decim", 2, 0.4, 0.0, 60.0)),
    ("ms2_i", lambda: resample.msresamp2("interp", 2, 0.4, 0.0, 60.0))])
def test_halfband_goldens(fg, name, make):
    x = fg["r2_x"] if name.startswith("r2") else fg["ms2_x"]
    y = _oneshot(make(), x)
    assert y.shape == fg[name].shape
    assert np.abs(y - fg[name]).max() < 1e-5


def test_qmf_goldens(fg):
    Y = _oneshot(resample.resamp2_analyzer(5, 60.0), fg["qmf_x"])
    assert np.abs(Y[0] - fg["qmf_lo"]).max() < 1e-5
    assert np.abs(Y[1] - fg["qmf_hi"]).max() < 1e-5
    Z = _oneshot(resample.resamp2_synthesizer(5, 60.0),
                 np.stack([fg["qmf_lo"], fg["qmf_hi"]]))
    assert np.abs(Z - fg["qmf_z"]).max() < 1e-5


@pytest.mark.parametrize("num,den", RATES)
def test_resamp_routes_match_each_other_and_jax(num, den):
    # tests/test_resample.py:306-321's cases: both port routes (the class
    # convolutions the CPU takes, the banded matmul the card takes) and
    # both JAX routes, 2 carried blocks of den*192 samples, 2e-5
    rng = np.random.default_rng(num * 16 + den)
    T = den * 192
    x = tp.cnoise(rng, (3, T))
    outs = {}
    for backend in ("conv", "matmul"):
        jp = jresample.resamp((num, den), backend=backend)
        p = resample.resamp((num, den), backend=backend)
        load_jax_params(p, tp.jax_params(jp))
        outs["jax_" + backend], cj = tp.run_jax(jp, [x, x], (3,))
        outs["port_" + backend], ct = tp.run_torch(p, [x, x], (3,))
        assert set(ct) == {"tail", "phi"} and ct["phi"].dtype == torch.float32
        np.testing.assert_array_equal(carry_to_numpy(ct)["tail"],
                                      np.asarray(cj["tail"]))
        assert float(ct["phi"]) == float(cj["phi"]) == 0.0
    ref = outs["jax_conv"]
    assert ref.shape == (3, 2 * T * num // den)
    for k, y in outs.items():
        np.testing.assert_allclose(y, ref, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("num,den,T", [(127, 100, 600), (67, 3, 96),
                                       (65, 64, 256)])
def test_resamp_gather_route_matches_jax(num, den, T):
    # num > 64: every backend takes the gather form, in both packages
    rng = np.random.default_rng(num)
    x = tp.cnoise(rng, (2, T))
    for backend in ("auto", "matmul"):
        jp = jresample.resamp((num, den), backend=backend)
        p = resample.resamp((num, den), backend=backend)
        yj, cj = tp.run_jax(jp, [x, x, x], (2,))
        yt, ct = tp.run_torch(p, [x, x, x], (2,))
        assert yt.shape == (2, 3 * T * num // den)
        np.testing.assert_allclose(yt, yj, atol=2e-5)
        np.testing.assert_array_equal(carry_to_numpy(ct)["tail"],
                                      np.asarray(cj["tail"]))


def test_resamp_rejects_bad_blocks_and_schedules():
    p = resample.resamp((3, 4))
    with pytest.raises(ValueError, match="multiple of 4"):
        p(p.init(), torch.zeros(10, dtype=torch.complex64))
    with pytest.raises(ValueError, match="backend"):
        resample.resamp((3, 4), backend="fft")
    # at 129/2 the JAX package's gather reads past the block and returns
    # non-finite outputs; the port refuses the schedule instead
    x = np.ones(128, np.complex64)
    jp = jresample.resamp((129, 2))
    yj, _ = jp.apply(jp.params, jp.init(), jnp.asarray(x))
    assert not np.isfinite(np.asarray(yj)).all()
    q = resample.resamp((129, 2))
    with pytest.raises(ValueError, match="reads past the block"):
        q(q.init(), torch.from_numpy(x))


@pytest.mark.parametrize("make", [
    lambda m: m.msresamp2("interp", 2),
    lambda m: m.msresamp2("interp", 1, 0.3, 0.0, 70.0),
    lambda m: m.msresamp2("decim", 0),
    lambda m: m.msresamp(2.0),
    lambda m: m.msresamp(2.5),
    lambda m: m.msresamp(0.3),
    lambda m: m.msresamp(0.375),
    lambda m: m.msresamp((8, 3)),
    lambda m: m.resamp2_interp(5),
    lambda m: m.resamp2_analyzer(7),
    lambda m: m.resamp2_synthesizer(7)])
def test_streaming_matches_jax(make):
    rng = np.random.default_rng(29)
    jp, p = make(jresample), make(resample)
    assert p.rate == jp.rate
    load_jax_params(p, tp.jax_params(jp))
    shape = (2, 2, 240) if "synth" in jp.name else (2, 480)
    blocks = [tp.cnoise(rng, shape) for _ in range(3)]
    yj, _ = tp.run_jax(jp, blocks, shape[:1])
    yt, _ = tp.run_torch(p, blocks, shape[:1])
    assert yt.shape == yj.shape
    assert tp.rel_err(yt, yj) < 1e-5
    # the carry handed over: the JAX carry after block 0, then the port
    _, cj1 = tp.run_jax(jp, blocks[:1], shape[:1])
    yt2, _ = tp.run_torch(p, blocks[1:], shape[:1],
                          carry=carry_from_numpy(tp.to_numpy(cj1)))
    n1 = yj.shape[-1] // 3
    assert tp.rel_err(yt2, yj[..., n1:]) < 1e-5


@pytest.mark.parametrize("rate", [0.375, 2.5, 0.3, (2, 3)])
def test_msresamp_tone(rate):
    # tests/test_resample.py:189-201's check on the port: the tone moves
    # to fx / r, everything else 40 dB down
    num, den = resample.as_rational(rate)
    r = num / den
    fx = 0.02
    n = 48 * den * (8 if r < 1 else 1)
    q = resample.msresamp(rate, as_db=60.0)
    y = _oneshot(q, windowed_tone(n, fx))
    assert len(y) == n * num // den
    fpeak, side = spectral_peak_and_sidelobe(
        y, main_lobe_width=0.07 / min(r, 1.0))
    assert abs(fpeak - fx / r) < 0.02
    assert side < -40


def test_qmf_loopback():
    # analyzer -> synthesizer returns a band-limited input after the
    # pair's delay of 4m-1 samples, the high band sign-inverted
    # (tests/test_resample.py:154-176), within 2e-3 on a tone in each band
    m, n = 7, 1024
    d, i = 4 * m - 1, np.arange(n)
    ks = np.arange(d + 4 * m, n - 4 * m)
    a, s = resample.resamp2_analyzer(m), resample.resamp2_synthesizer(m)
    for f, sign in ((0.04, 1.0), (0.44, -1.0)):
        x = np.exp(2j * np.pi * f * i).astype(np.complex64)[None].repeat(2, 0)
        y, _ = a(a.init(batch_shape=(2,)), torch.from_numpy(x))
        z, _ = s(s.init(batch_shape=(2,)), y)
        assert np.abs(z.numpy()[:, ks] - sign * x[:, ks - d]).max() < 2e-3
