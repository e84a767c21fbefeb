"""Port parity for `ops/misc_filters.py`: the Farrow fractional delay,
the IIR decimator and interpolator, linear prediction.

Tolerances: host numpy functions equal the JAX package's to float64
rounding (1e-12); the Procs within 1e-5 absolute of the JAX package on
unit inputs (the same float32 recurrences and FIR); the reference C
library's goldens at the JAX tests' own bounds (tests/test_symsync_misc.py:
5e-4 for the Farrow taps, 1e-5 for iirdecim/iirinterp and lpc's a)."""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as tp
from liquid_dsp_tpu.design.iirdes import iirdes
from liquid_dsp_tpu.ops import misc_filters as J
from liquid_dsp_tpu_torch.convert import load_jax_params
from liquid_dsp_tpu_torch.ops import misc_filters as P

FG = pathlib.Path(__file__).parent / "golden" / "flexframe_golden.npz"


@pytest.fixture(scope="module")
def fg():
    return dict(np.load(FG))


def _close(y, ref, tol):
    y, ref = np.asarray(y), np.asarray(ref)
    assert y.shape == ref.shape, (y.shape, ref.shape)
    assert np.abs(y - ref).max() <= tol, np.abs(y - ref).max()


@pytest.mark.parametrize("mu", [-1.0, -0.7, -0.2, 0.0, 0.3, 0.5, 1.0])
def test_firfarrow_taps_equal_jax(mu):
    np.testing.assert_allclose(P.firfarrow_taps(19, mu),
                               J.firfarrow_taps(19, mu), rtol=0, atol=1e-12)
    np.testing.assert_allclose(P.firfarrow_taps(11, mu, 0.3, 40.0, 3),
                               J.firfarrow_taps(11, mu, 0.3, 40.0, 3),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("ci,mu", [(0, 0.0), (1, 0.3), (2, -0.7)])
def test_firfarrow_taps_golden(fg, ci, mu):
    ref = np.real(fg[f"farrow_h_{ci}"]).astype(np.float32)
    assert np.abs(P.firfarrow_taps(19, mu, 0.45, 60.0) - ref).max() < 5e-4


def test_firfarrow_proc_matches_jax_and_checks_mu():
    x = tp.cnoise(np.random.default_rng(1), (2, 256))
    yj, _ = tp.run_jax(J.firfarrow(19, 0.25), [x[:, :100], x[:, 100:]], (2,))
    yt, _ = tp.run_torch(P.firfarrow(19, 0.25), [x[:, :100], x[:, 100:]],
                         (2,))
    _close(yt, yj, 1e-5)
    with pytest.raises(ValueError):
        P.firfarrow_taps(19, 1.5)


CASES = [(2, None), (4, None), (3, "butter5")]


def _make(mod, kind, m, design):
    if design is None:
        return getattr(mod, kind)(m)
    return getattr(mod, kind)(m, *iirdes("butter", 5, 0.2))


@pytest.mark.parametrize("m,design", CASES)
@pytest.mark.parametrize("kind", ["iirdecim", "iirinterp"])
def test_resampler_streams_match_jax(kind, m, design):
    x = tp.cnoise(np.random.default_rng(m), (3, 240 * m))
    blocks = [x[:, :60 * m], x[:, 60 * m:]]
    jq, q = _make(J, kind, m, design), _make(P, kind, m, design)
    assert q.rate == jq.rate
    yj, cj = tp.run_jax(jq, blocks, (3,))
    yt, ct = tp.run_torch(q, blocks, (3,))
    _close(yt, yj, 1e-5)
    _close(ct.numpy(), np.asarray(cj), 1e-5)


@pytest.mark.parametrize("kind", ["iirdecim", "iirinterp"])
def test_resampler_params_load_from_jax(kind):
    jq = getattr(J, kind)(2, *iirdes("cheby1", 3, 0.2))
    q = getattr(P, kind)(2, *iirdes("butter", 3, 0.3))
    load_jax_params(q, tp.jax_params(jq))
    x = tp.cnoise(np.random.default_rng(3), (1, 128))
    yj, _ = tp.run_jax(jq, [x], (1,))
    yt, _ = tp.run_torch(q, [x], (1,))
    _close(yt, yj, 1e-5)


@pytest.mark.parametrize("kind,key", [("iirdecim", "iird_y"),
                                      ("iirinterp", "iiri_y")])
def test_resampler_goldens(fg, kind, key):
    q = getattr(P, kind)(2)
    x = torch.from_numpy(fg["iird_x"])
    y, _ = q(q.init(dtype=x.dtype), x)
    assert np.abs(y.numpy() - fg[key]).max() < 1e-5


def test_iirdecim_rejects_a_ragged_block():
    q = P.iirdecim(3, *iirdes("butter", 3, 0.2))
    with pytest.raises(ValueError):
        q(q.init(), torch.zeros(100, dtype=torch.complex64))


@pytest.mark.parametrize("p", [1, 2, 6])
def test_lpc_and_autocorr_equal_jax(p):
    rng = np.random.default_rng(p)
    x = rng.standard_normal(500)
    for refl in (False, True):
        for got, want in zip(P.lpc(x, p, refl), J.lpc(x, p, refl)):
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    xc = x[:250] + 1j * x[250:]
    np.testing.assert_allclose(P.autocorr_estimate(xc, p),
                               J.autocorr_estimate(xc, p), rtol=1e-12)
    with pytest.raises(ValueError):
        P.lpc(np.zeros(10), 2)


def test_lpc_golden(fg):
    x = np.real(fg["lpc_x"]).astype(np.float32)
    a, e = P.lpc(x, 6)
    assert np.abs(a - np.real(fg["lpc_a"])).max() < 1e-4
    ref_e = np.real(fg["lpc_g"])
    assert np.abs(e - ref_e).max() / ref_e[0] < 1e-5


def test_lpc_predicts_an_ar_process():
    rng = np.random.default_rng(5)
    w = rng.standard_normal(20000)
    x = np.zeros_like(w)
    for i in range(2, len(w)):
        x[i] = 1.2 * x[i - 1] - 0.5 * x[i - 2] + w[i]
    a, _ = P.lpc(x, 2)
    np.testing.assert_allclose(a, [1.0, -1.2, 0.5], atol=0.03)


def test_iirinterp_zero_stuffs_like_jax():
    # the interpolator's input lands on every m-th sample, zeros between
    q = P.iirinterp(3, [1.0, 0.0], [1.0, 0.0])
    jq = J.iirinterp(3, [1.0, 0.0], [1.0, 0.0])
    x = np.arange(1, 5, dtype=np.float32).astype(np.complex64)
    y, _ = q(q.init(), torch.from_numpy(x))
    yj, _ = jq(jnp.asarray(x), batch_shape=())
    np.testing.assert_array_equal(y.numpy(), np.asarray(yj))
