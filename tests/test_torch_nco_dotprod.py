"""Port parity for the NCO utilities (`pll_step`, `unwrap_phase`,
`unwrap_phase2`) and the vector primitives of `ops/dotprod.py`
(`dotprod`, `sumsq`, `vec_*`) against the JAX package on the same
inputs.  Element-wise results in float32 are held to 1 ulp-scale
tolerances (2e-6 relative); the closed-form unwraps are one cumsum in
both packages and are held to 1e-5 absolute over 2048 samples."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import _torch_port as tp
from liquid_dsp_tpu.ops import dotprod as jdot
from liquid_dsp_tpu.ops import nco as jnco
from liquid_dsp_tpu_torch.ops import dotprod, nco


def _both(rng, shape, complex_=False):
    x = (tp.cnoise(rng, shape) if complex_ else
         rng.standard_normal(shape).astype(np.float32))
    return torch.from_numpy(x), jnp.asarray(x)


@pytest.mark.parametrize("bw", [0.1, 0.02, 0.35])
def test_pll_step_matches_jax(bw):
    rng = np.random.default_rng(int(bw * 100))
    th, dp, pe = (rng.standard_normal(16).astype(np.float32)
                  for _ in range(3))
    t2, d2 = nco.pll_step(torch.from_numpy(th), torch.from_numpy(dp),
                          torch.from_numpy(pe), bw)
    jt, jd = jnco.pll_step(jnp.asarray(th), jnp.asarray(dp),
                           jnp.asarray(pe), bw)
    np.testing.assert_array_equal(t2.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(jd))


@pytest.mark.parametrize("slope", [0.05, 1.9, -2.7])
def test_unwrap_phase_matches_jax(slope):
    # a ramp with noise, wrapped into [-pi, pi), 2 channels: unwrap_phase
    # recovers slopes within pi per sample, unwrap_phase2 steeper ones
    rng = np.random.default_rng(11)
    n = 2048
    raw = (slope * np.arange(n)[None] + rng.uniform(-3, 3, (2, 1))
           + 0.05 * rng.standard_normal((2, n)))
    wrapped = np.angle(np.exp(1j * raw)).astype(np.float32)
    for port, ref in ((nco.unwrap_phase, jnco.unwrap_phase),
                      (nco.unwrap_phase2, jnco.unwrap_phase2)):
        got = port(torch.from_numpy(wrapped)).numpy()
        want = np.asarray(ref(jnp.asarray(wrapped)))
        assert got.shape == want.shape
        assert np.abs(got - want).max() < 1e-5 * max(1.0, abs(slope) * n)
    if abs(slope) < np.pi:
        got = nco.unwrap_phase(torch.from_numpy(wrapped)).numpy()
        np.testing.assert_allclose(np.diff(got), np.diff(raw), atol=1e-3)


@pytest.mark.parametrize("complex_", [False, True])
def test_dotprod_sumsq_norm(complex_):
    rng = np.random.default_rng(5)
    h, jh = _both(rng, (37,), complex_)
    x, jx = _both(rng, (3, 37), complex_)
    for got, want in ((dotprod.dotprod(h, x), jdot.dotprod(jh, jx)),
                      (dotprod.sumsq(x), jdot.sumsq(jx)),
                      (dotprod.vec_norm(x), jdot.vec_norm(jx)),
                      (dotprod.vec_normalize(x), jdot.vec_normalize(jx))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                                   atol=1e-6)


def test_vec_elementwise():
    rng = np.random.default_rng(6)
    x, jx = _both(rng, (4, 50), True)
    y, jy = _both(rng, (4, 50), True)
    th, jth = _both(rng, (4, 50))
    cases = [(dotprod.vec_add(x, y), jdot.vec_add(jx, jy)),
             (dotprod.vec_mul(x, y), jdot.vec_mul(jx, jy)),
             (dotprod.vec_cexpj(th), jdot.vec_cexpj(jth)),
             (dotprod.vec_addscalar(x, 0.5 - 2j), jdot.vec_addscalar(
                 jx, 0.5 - 2j)),
             (dotprod.vec_mulscalar(x, 1.5), jdot.vec_mulscalar(jx, 1.5)),
             (dotprod.vec_carg(x), jdot.vec_carg(jx)),
             (dotprod.vec_abs(x), jdot.vec_abs(jx)),
             (dotprod.vec_init(2.5, 7), jdot.vec_init(2.5, 7)),
             (dotprod.vec_init(1 - 1j, 3), jdot.vec_init(1 - 1j, 3))]
    for got, want in cases:
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-6)
