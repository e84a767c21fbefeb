"""Port parity: the AGC and the LMS / RLS equalizers of
liquid_dsp_tpu_torch against the JAX package and the compiled reference's
goldens, on the same seeded inputs.

Tolerances: the goldens at the reference's own (agc 2e-5 and gain 1e-4,
tests/test_agc_eq_iir.py:279-291; eqlms 1e-5, :293-315); against the JAX
package 1e-5 of rms for the AGC (XLA fuses two of the loop's multiply-adds
that PyTorch rounds twice, and exp/log differ by an ulp) and 1e-5 for the
equalizers (their window dots are summed in another order).
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as tp
from liquid_dsp_tpu.ops import agc as jagc
from liquid_dsp_tpu.ops import equalize as jeq
from liquid_dsp_tpu_torch.convert import carry_from_numpy, carry_to_numpy
from liquid_dsp_tpu_torch.ops import agc, equalize
from liquid_dsp_tpu_torch.ops.kernels import agc_scan as ak
from liquid_dsp_tpu_torch.planar import planar

GOLDEN = pathlib.Path(__file__).parent / "golden"


def _levels(seed, B, T):
    rng = np.random.default_rng(seed)
    x = tp.cnoise(rng, (B, T))
    return (x * np.geomspace(0.01, 5.0, B)[:, None]).astype(np.complex64)


def test_agc_golden():
    d = dict(np.load(GOLDEN / "agc_golden.npz"))
    q = agc.agc(bandwidth=0.01)
    y, c = q(q.init(), torch.from_numpy(d["x"]))
    np.testing.assert_allclose(y.numpy(), d["y"], atol=2e-5)
    assert abs(float(c["g"]) - float(d["g"])) < 1e-4


@pytest.mark.parametrize("bw,locked", [(0.02, False), (0.1, False),
                                       (0.02, True)])
def test_agc_complex_matches_jax(bw, locked):
    x = _levels(1, 3, 2048)
    jq, pq = jagc.agc(bw, locked=locked), agc.agc(bw, locked=locked)
    yj, cj = tp.run_jax(jq, x.reshape(3, 2, 1024).transpose(1, 0, 2), (3,))
    yp, cp = tp.run_torch(pq, x.reshape(3, 2, 1024).transpose(1, 0, 2), (3,))
    assert tp.rel_err(yp, yj) < 1e-5
    for key in cj:
        np.testing.assert_allclose(carry_to_numpy(cp)[key],
                                   np.asarray(cj[key]), rtol=1e-5)


def test_agc_planar_and_real_match_jax():
    x = _levels(2, 2, 1024)
    jq, pq = jagc.agc(0.05), agc.agc(0.05)
    yj, cj = tp.run_jax(jq, [x], (2,), planar=False)
    jp = jq.planar_apply
    (rj, ij), cjp = jp({}, jq.planar_init((2,)),
                       (jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy())))
    pp = planar(pq)
    (rp, ip), cpp = pp(pp.init(batch_shape=(2,)),
                       (torch.from_numpy(x.real.copy()),
                        torch.from_numpy(x.imag.copy())))
    assert tp.rel_err(rp.numpy() + 1j * ip.numpy(),
                      np.asarray(rj) + 1j * np.asarray(ij)) < 1e-5
    np.testing.assert_allclose(cpp["g"].numpy(), np.asarray(cjp["g"]),
                               rtol=1e-5)
    # a real stream
    xr = np.ascontiguousarray(x.real)
    yjr, _ = jq.apply({}, jq.init((2,)), jnp.asarray(xr))
    ypr, _ = pq(pq.init((2,)), torch.from_numpy(xr))
    assert ypr.dtype == torch.float32
    assert tp.rel_err(ypr.numpy(), np.asarray(yjr)) < 1e-5


def test_agc_carry_crosses_packages_and_rssi():
    x = _levels(3, 2, 1024)
    jq, pq = jagc.agc(0.02), agc.agc(0.02)
    _, cj = jq.apply({}, jq.init((2,)), jnp.asarray(x[:, :512]))
    yj, cj2 = jq.apply({}, cj, jnp.asarray(x[:, 512:]))
    yp, cp2 = pq(carry_from_numpy(tp.to_numpy(cj)),
                 torch.from_numpy(x[:, 512:].copy()))
    assert tp.rel_err(yp.numpy(), np.asarray(yj)) < 1e-5
    np.testing.assert_allclose(agc.rssi_from_carry(cp2).numpy(),
                               np.asarray(jagc.rssi_from_carry(cj2)),
                               rtol=1e-5, atol=1e-4)


def test_agc_scan_wrapper():
    p = torch.rand(2, 64)
    g, y2 = torch.ones(2), torch.ones(2)
    launches = ak.agc_scan.launches
    gains, g2, y22 = ak.agc_scan(p, g, y2, alpha=0.1)
    assert ak.agc_scan.launches == launches and gains.shape == (2, 64)
    assert torch.equal(gains[:, 0], g)
    locked = ak.agc_scan(p, g, y2, alpha=0.1, locked=True)[0]
    assert torch.equal(locked, torch.ones(2, 64))
    with pytest.raises(ValueError, match="float32"):
        ak.agc_scan(p.double(), g, y2, alpha=0.1)
    with pytest.raises(ValueError, match="device"):
        ak.agc_scan(p.to("meta"), g, y2, alpha=0.1)
    with pytest.raises(ValueError, match="device"):
        ak.agc_scan(p.to("meta"), g.to("meta"), y2.to("meta"), alpha=0.1)
    with pytest.raises(ValueError, match="contiguous"):
        ak.agc_scan(torch.rand(64, 2).t(), g, y2, alpha=0.1)


def test_eqlms_golden():
    g = dict(np.load(GOLDEN / "flexframe_golden.npz"))
    L = 13
    carry = {"w": torch.from_numpy(equalize.eqlms_init_weights(L)),
             "buf": torch.zeros(L, dtype=torch.complex64),
             "x2_sum": torch.tensor(0.0), "n": torch.tensor(0,
                                                            dtype=torch.int32)}
    y, c2 = equalize.eqlms_run(None, 0.3, carry,
                               torch.from_numpy(g["eqlms_x"]),
                               d=torch.from_numpy(g["eqlms_d"]))
    assert np.abs(y.numpy() - g["eqlms_y"]).max() < 1e-5
    w_fir = np.conj(c2["w"].numpy()[::-1])
    assert np.abs(w_fir - g["eqlms_w"]).max() < 1e-5


@pytest.mark.parametrize("mode", ["trained", "decision"])
def test_eqlms_matches_jax(mode):
    rng = np.random.default_rng(5)
    x, d = tp.cnoise(rng, (2, 300)) * 0.7, tp.cnoise(rng, (2, 300))
    jq, pq = jeq.eqlms(7, 0.2), equalize.eqlms(7, 0.2)
    if mode == "trained":
        yj, cj = jq.apply({}, jq.init((2,)), (jnp.asarray(x), jnp.asarray(d)))
        yp, cp = pq(pq.init((2,)), (torch.from_numpy(x), torch.from_numpy(d)))
    else:
        yj, cj = jq.apply({}, jq.init((2,)), jnp.asarray(x))
        yp, cp = pq(pq.init((2,)), torch.from_numpy(x))
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), rtol=0, atol=1e-5)
    for key in cj:
        np.testing.assert_allclose(carry_to_numpy(cp)[key],
                                   np.asarray(cj[key]), rtol=0, atol=1e-5)


def test_eqlms_lowpass_weights_and_slicer():
    np.testing.assert_array_equal(equalize.eqlms_lowpass_weights(13),
                                  jeq.eqlms_lowpass_weights(13))
    tab = torch.tensor([1 + 1j, -1 - 1j], dtype=torch.complex64)

    def slicer(y):
        return tab[torch.argmin((y[..., None] - tab).abs(), dim=-1)]

    x = torch.from_numpy(tp.cnoise(np.random.default_rng(0), (64,)))
    y, c = equalize.eqlms(5, 0.1, slicer=slicer)(
        equalize.eqlms(5).init(), x)
    assert y.shape == (64,) and int(c["n"]) == 64


def test_eqrls_matches_jax():
    rng = np.random.default_rng(6)
    x, d = tp.cnoise(rng, (2, 200)) * 0.7, tp.cnoise(rng, (2, 200))
    jq, pq = jeq.eqrls(5), equalize.eqrls(5)
    yj, cj = jq.apply({}, jq.init((2,)), (jnp.asarray(x), jnp.asarray(d)))
    yp, cp = pq(pq.init((2,)), (torch.from_numpy(x), torch.from_numpy(d)))
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(cp["w"].numpy(), np.asarray(cj["w"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(cp["P"].numpy(), np.asarray(cj["P"]),
                               rtol=1e-4, atol=1e-4)
