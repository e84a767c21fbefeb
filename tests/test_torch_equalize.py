"""Port parity: the LMS and RLS equalizers' plain versions
(`ops/kernels/eqlms_scan.py`, `ops/kernels/eqrls_scan.py`, through
`ops/equalize.py`'s Procs and run functions) against the JAX package's
`eqlms_run`/`eqrls_run` on the same seeded numpy inputs.

Tolerances (tests/test_torch_agc_eq.py's): y and w within 1e-5 absolute
(the port sums the window's dot as the kernel's butterfly and forms the
weight step as g e conj-times buf; the JAX package sums and associates in
XLA's order); P within 1e-4 (the JAX package divides by den and lam, the
port multiplies by their float32 reciprocals).  On a complex stream
x2_sum is bit-equal (both form |x|^2 as one fused multiply-add; on a real
one XLA fuses the running sum otherwise: 1e-5 of its value) and n equal.

The RLS cases and the real LMS stream run what the Procs are for, as
examples/eqrls_example.py does: symbols through a multipath channel, the
symbols as d, so y is near the constellation.  (On an uncorrelated (x, d)
pair with a large start for P the RLS gain magnifies float32 rounding:
both packages then stray from a float64 RLS, and from each other, by
more than 1e-5 on outputs several times the unit circle; a real
decision-directed LMS of one tap on white noise takes w += mu e / x and
diverges chaotically in both.)
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as tp
from liquid_dsp_tpu.ops import equalize as jeq
from liquid_dsp_tpu_torch.convert import carry_from_numpy, carry_to_numpy
from liquid_dsp_tpu_torch.ops import equalize

ATOL, ATOL_P = 1e-5, 1e-4


def _stream(seed, shape, real=False):
    rng = np.random.default_rng(seed)
    if real:
        return (0.7 * rng.standard_normal(shape)).astype(np.float32), \
            np.sign(rng.standard_normal(shape)).astype(np.float32)
    return 0.7 * tp.cnoise(rng, shape), tp.cnoise(rng, shape)


def _channel_stream(seed, shape, real=False):
    """(x, d): d unit-energy QPSK (BPSK if real), x = d through
    h = [1, 0, -0.25+0.2j, 0, 0.1] (its real part if real) plus noise
    0.01 a rail."""
    rng = np.random.default_rng(seed)
    h = np.array([1.0, 0.0, -0.25 + 0.2j, 0.0, 0.1], np.complex64)
    if real:
        d = np.sign(rng.standard_normal(shape)).astype(np.float32)
        x = np.apply_along_axis(lambda r: np.convolve(r, h.real), -1, d)
        x = x[..., :shape[-1]] + 0.01 * rng.standard_normal(shape)
        return x.astype(np.float32), d
    d = ((np.sign(rng.standard_normal(shape))
          + 1j * np.sign(rng.standard_normal(shape))) * np.sqrt(0.5)
         ).astype(np.complex64)
    x = np.apply_along_axis(lambda r: np.convolve(r, h), -1, d)
    x = x[..., :shape[-1]] + 0.01 * tp.cnoise(rng, shape)
    return x.astype(np.complex64), d


def _blocks(q_j, q_p, batch, blocks, trained, dtype=None, carry=None):
    """Stream the (x, d) blocks through a JAX Proc and a port Proc from the
    same carry; returns the outputs and carries of both."""
    kw = {} if dtype is None else {"dtype": dtype}
    cj = q_j.init(batch, **kw) if carry is None else carry
    cp = carry_from_numpy(tp.to_numpy(cj))
    yj, yp = [], []
    for x, d in blocks:
        if trained:
            y, cj = q_j.apply({}, cj, (jnp.asarray(x), jnp.asarray(d)))
            z, cp = q_p(cp, (torch.from_numpy(x), torch.from_numpy(d)))
        else:
            y, cj = q_j.apply({}, cj, jnp.asarray(x))
            z, cp = q_p(cp, torch.from_numpy(x))
        yj.append(np.asarray(y))
        yp.append(z.numpy())
    return yj, cj, yp, cp


def _assert_close(yj, cj, yp, cp):
    for a, b in zip(yp, yj):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    got = carry_to_numpy(cp)
    assert set(got) == set(cj)
    for key, want in cj.items():
        want = np.asarray(want)
        assert got[key].dtype == want.dtype and got[key].shape == want.shape
        if key == "P":
            np.testing.assert_allclose(got[key], want, rtol=ATOL_P,
                                       atol=ATOL_P)
        elif key == "n" or (key == "x2_sum" and cj["w"].dtype.kind == "c"):
            np.testing.assert_array_equal(got[key], want)
        elif key == "x2_sum":
            np.testing.assert_allclose(got[key], want, rtol=1e-5)
        else:
            np.testing.assert_allclose(got[key], want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("batch", [(), (2, 3)])
@pytest.mark.parametrize("L", [1, 5, 13, 32])
@pytest.mark.parametrize("mode", ["trained", "decision", "decision_real"])
def test_eqlms_matches_jax(mode, L, batch):
    real = mode == "decision_real"
    x, d = (_channel_stream if real else _stream)(L, batch + (300,), real)
    out = _blocks(jeq.eqlms(L, 0.2), equalize.eqlms(L, 0.2), batch,
                  [(x, d)], mode == "trained",
                  dtype=jnp.float32 if real else None)
    _assert_close(*out)
    if real:
        assert out[2][0].dtype == np.float32


@pytest.mark.parametrize("mode", ["trained", "decision"])
def test_eqlms_blocks_of_every_length_match_jax(mode):
    # T = 0, T < L, and the gate's first update (n + 1 = L) inside a block:
    # the gate counts from the carry's n across blocks
    L = 13
    x, d = _stream(7, (2, 400))
    cuts = [0, 0, 5, 5, 20, 400]
    blocks = [(x[:, a:b].copy(), d[:, a:b].copy())
              for a, b in zip(cuts[:-1], cuts[1:])]
    yj, cj, yp, cp = _blocks(jeq.eqlms(L, 0.3), equalize.eqlms(L, 0.3),
                             (2,), blocks, mode == "trained")
    assert [y.shape[-1] for y in yp] == [0, 5, 0, 15, 380]
    _assert_close(yj, cj, yp, cp)


def test_eqlms_mu_zero_keeps_the_weights():
    # examples/eqlms_block_example.py freezes the weights with mu = 0
    L = 11
    x, d = _stream(8, (3, 200))
    q = equalize.eqlms(L, 0.0)
    c0 = q.init((3,))
    c0["w"] = torch.from_numpy(tp.cnoise(np.random.default_rng(9), (3, L)))
    for blk in ((torch.from_numpy(x), torch.from_numpy(d)),
                torch.from_numpy(x)):
        y, c = q(c0, blk)
        assert torch.equal(c["w"], c0["w"]) and int(c["n"][0]) == 200
    out = _blocks(jeq.eqlms(L, 0.0), q, (3,), [(x, d)], False,
                  carry={k: jnp.asarray(v.numpy()) for k, v in c0.items()})
    _assert_close(*out)


def test_eqlms_carry_crosses_packages():
    # the JAX package's carry after one block, handed to the port through
    # convert.carry_from_numpy, and the next block in both
    L = 9
    x, d = _stream(10, (2, 600))
    jq, pq = jeq.eqlms(L, 0.1), equalize.eqlms(L, 0.1)
    _, cj = jq.apply({}, jq.init((2,)), (jnp.asarray(x[:, :300]),
                                        jnp.asarray(d[:, :300])))
    cp = carry_from_numpy(tp.to_numpy(cj))
    yj, cj2 = jq.apply({}, cj, jnp.asarray(x[:, 300:]))
    yp, cp2 = pq(cp, torch.from_numpy(x[:, 300:].copy()))
    _assert_close([np.asarray(yj)], cj2, [yp.numpy()], cp2)


def test_eqlms_slicer_sees_an_exact_zero():
    # a purely imaginary stream from real weights: y's real part is exactly
    # 0 at every sample, the slicer's sign(0) = 0 keeps the weights real,
    # and y stays on the imaginary axis (a slicer that gives +-s there
    # would turn the weights)
    L = 5
    rng = np.random.default_rng(11)
    x = (1j * rng.standard_normal((2, 256))).astype(np.complex64)
    yj, cj, yp, cp = _blocks(jeq.eqlms(L, 0.2), equalize.eqlms(L, 0.2),
                             (2,), [(x, None)], False)
    assert np.all(yp[0].real == 0) and np.all(np.asarray(yj[0]).real == 0)
    assert np.all(cp["w"].numpy().imag == 0)
    assert np.any(yp[0].imag != 0)
    _assert_close(yj, cj, yp, cp)


def test_eqlms_custom_slicer_on_the_cpu_matches_jax():
    # a caller's slicer (nearest point of a rotated QPSK table) runs once a
    # sample in the plain version, as the JAX package calls it
    L = 7
    tab = np.exp(1j * (np.pi / 4 + np.pi / 2 * np.arange(4) + 0.1)) \
        .astype(np.complex64)
    tj, tt = jnp.asarray(tab), torch.from_numpy(tab)

    def slicer_j(y):
        return tj[jnp.argmin(jnp.abs(y[..., None] - tj), axis=-1)]

    def slicer_t(y):
        return tt[torch.argmin((y[..., None] - tt).abs(), dim=-1)]

    rng = np.random.default_rng(12)
    syms = tab[rng.integers(0, 4, (2, 3, 400))]
    x = (syms + 0.05 * tp.cnoise(rng, syms.shape)).astype(np.complex64)
    out = _blocks(jeq.eqlms(L, 0.05, slicer=slicer_j),
                  equalize.eqlms(L, 0.05, slicer=slicer_t), (2, 3),
                  [(x, None)], False)
    _assert_close(*out)


@pytest.mark.parametrize("batch", [(), (2, 3)])
@pytest.mark.parametrize("L", [1, 5, 9])
def test_eqrls_matches_jax(L, batch):
    x, d = _channel_stream(20 + L, batch + (300,))
    out = _blocks(jeq.eqrls(L, lam=0.99), equalize.eqrls(L, lam=0.99),
                  batch, [(x, d)], True)
    _assert_close(*out)


def test_eqrls_real_stream_matches_jax():
    x, d = _channel_stream(30, (2, 300), real=True)
    out = _blocks(jeq.eqrls(5, lam=0.98), equalize.eqrls(5, lam=0.98), (2,),
                  [(x, d)], True, dtype=jnp.float32)
    _assert_close(*out)
    assert out[2][0].dtype == np.float32


def test_eqrls_blocks_of_every_length_and_carry_cross():
    L = 9
    x, d = _channel_stream(31, (2, 400))
    cuts = [0, 0, 4, 4, 12, 400]
    blocks = [(x[:, a:b].copy(), d[:, a:b].copy())
              for a, b in zip(cuts[:-1], cuts[1:])]
    jq, pq = jeq.eqrls(L, lam=0.995, delta=0.05), \
        equalize.eqrls(L, lam=0.995, delta=0.05)
    yj, cj, yp, cp = _blocks(jq, pq, (2,), blocks, True)
    assert [y.shape[-1] for y in yp] == [0, 4, 0, 8, 388]
    _assert_close(yj, cj, yp, cp)
    # the JAX carry handed to the port mid-stream
    _, ch = jq.apply({}, jq.init((2,)), (jnp.asarray(x[:, :200]),
                                        jnp.asarray(d[:, :200])))
    y2j, c2j = jq.apply({}, ch, (jnp.asarray(x[:, 200:]),
                                 jnp.asarray(d[:, 200:])))
    y2p, c2p = pq(carry_from_numpy(tp.to_numpy(ch)),
                  (torch.from_numpy(x[:, 200:].copy()),
                   torch.from_numpy(d[:, 200:].copy())))
    _assert_close([np.asarray(y2j)], c2j, [y2p.numpy()], c2p)


def test_equalizers_refuse_what_they_do_not_take():
    x = torch.zeros(2, 16, dtype=torch.complex64)
    lms = equalize.eqlms(5)
    with pytest.raises(ValueError, match="device"):
        lms(lms.init((2,), device="meta"), x.to("meta"))
    with pytest.raises(ValueError, match="complex64 or all float32"):
        lms(lms.init((2,), dtype=torch.float32), x)
    with pytest.raises(ValueError, match="batch shape"):
        lms(lms.init((3,)), x)
    rls = equalize.eqrls(5)
    with pytest.raises(ValueError, match="device"):
        rls(rls.init((2,), device="meta"), (x.to("meta"), x.to("meta")))
    with pytest.raises(ValueError, match="batch shape"):
        rls(rls.init((2,)), (x, x[:, :8]))
