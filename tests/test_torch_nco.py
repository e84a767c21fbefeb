"""Port parity: liquid_dsp_tpu_torch.ops.nco against the JAX nco on the
same numpy inputs.  Tolerance ~1e-6 absolute on unit-variance input: the
same float32 formulas, with libm's cos/sin differing by an ulp or so.
The streaming test also holds each package to a float64 numpy reference
of x * exp(-+j(theta0 + t*dphi)), so that a failure names the side that
moved: both form the phase theta + t*dphi in float32, up to 300 rad
within a 1000-sample block, where an ulp is 3e-5 rad (1.3e-4 measured at
|x| up to 4.5); the 256-entry sine table is good to half a table step
(pi/256) of phase."""
import numpy as np
import pytest
import torch

import _torch_port as tp
from liquid_dsp_tpu import planar as jplanar
from liquid_dsp_tpu.ops import nco as jnco
from liquid_dsp_tpu_torch import planar
from liquid_dsp_tpu_torch.convert import carry_to_numpy, load_jax_params
from liquid_dsp_tpu_torch.ops import nco

ATOL = 2e-6   # a few f32 ulps at |y| ~ 4 (unit-variance noise)
ATOL_F64 = 2.5e-4          # either package against float64, direct sin/cos
ATOL_F64_TABLE = 1.3e-2    # ... with the table: pi/256 of phase, per unit |x|


@pytest.mark.parametrize("table", [False, True])
@pytest.mark.parametrize("direction", ["down", "up"])
@pytest.mark.parametrize("planar_path", [False, True])
def test_nco_streaming_matches_jax(table, direction, planar_path):
    rng = np.random.default_rng(11)
    blocks = [tp.cnoise(rng, (3, 1000)) for _ in range(3)]
    jp = jnco.nco(dphi=0.3, theta0=0.7, direction=direction, table=table)
    tp_ = nco.nco(dphi=0.3, theta0=0.7, direction=direction, table=table)
    load_jax_params(tp_, tp.jax_params(jp))
    if planar_path:
        jp, tp_ = jplanar(jp), planar(tp_)
    yj, cj = tp.run_jax(jp, blocks, (3,), planar=planar_path)
    yt, ct = tp.run_torch(tp_, blocks, (3,), planar=planar_path)
    # each side against float64 first: a failure here names the side
    x = np.concatenate(blocks, axis=-1).astype(np.complex128)
    sgn = -1.0 if direction == "down" else 1.0
    ref = x * np.exp(sgn * 1j * (float(np.float32(0.7)) + float(np.float32(0.3))
                                 * np.arange(x.shape[-1])))
    for side, y in (("port", yt), ("JAX package", yj)):
        err = np.abs(np.asarray(y) - ref)
        if table:
            err = err / np.abs(x)
        assert err.max() < (ATOL_F64_TABLE if table else ATOL_F64), (
            f"{side} against float64: {err.max():.3e}")
    np.testing.assert_allclose(yt, yj, rtol=0, atol=ATOL)
    np.testing.assert_allclose(carry_to_numpy(ct)["theta"],
                               np.asarray(cj["theta"]), rtol=0, atol=1e-6)


def test_nco_scalar_phase_and_advance():
    rng = np.random.default_rng(12)
    x = tp.cnoise(rng, (4, 512))
    jp = jnco.nco(dphi=0.125, direction="down")
    p = nco.nco(dphi=0.125, direction="down")
    # scalar (shared) phase, the shape kernel_fuse's carry uses
    yj, _ = tp.run_jax(jp, [x], ())
    yt, ct = tp.run_torch(p, [x], ())
    np.testing.assert_allclose(yt, yj, rtol=0, atol=ATOL)
    c0 = p.init(batch_shape=(4,))
    adv = p.advance(c0, 512 * 3 + 7)
    ref = jp.advance(jp.params, jp.init(batch_shape=(4,)), 512 * 3 + 7)
    np.testing.assert_allclose(adv["theta"].numpy(), np.asarray(ref["theta"]),
                               rtol=0, atol=1e-6)
    assert p.meta == jp.meta


@pytest.mark.parametrize("fn", ["mix_down", "mix_up"])
def test_mix_oneshot(fn):
    rng = np.random.default_rng(13)
    x = tp.cnoise(rng, (2, 777))
    y = getattr(nco, fn)(torch.from_numpy(x), 0.05, 0.3).numpy()
    ref = np.asarray(getattr(jnco, fn)(x, 0.05, 0.3))
    np.testing.assert_allclose(y, ref, rtol=0, atol=ATOL)
