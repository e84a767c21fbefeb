"""Port parity: symtrack of liquid_dsp_tpu_torch (the one-shot tracker, the
streaming Proc on both routes, the PLL + LMS kernel's plain version and the
`Symtrack` object) against the JAX package on the same seeded inputs.

Tolerance: the reference's own stream tolerance, symbols within 2e-4 with
decisions equal (tests/test_framing_extras.py:56-58); valid masks equal.
Both sides compute the PLL's cos/sin/atan2 and the LMS dots in float32
with their own libraries and summation orders.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as tp
from liquid_dsp_tpu.design.firdes import firdes_prototype
from liquid_dsp_tpu.modem import constellation, modulate
from liquid_dsp_tpu.ops.fir import firinterp
from liquid_dsp_tpu_torch import framing
from liquid_dsp_tpu_torch.convert import carry_from_numpy, carry_to_numpy
from liquid_dsp_tpu_torch.ops.kernels import pll_lms as pk

# the framing packages export a function named symtrack: take the modules
jst = importlib.import_module("liquid_dsp_tpu.framing.symtrack")
pst = importlib.import_module("liquid_dsp_tpu_torch.framing.symtrack")

TOL = 2e-4


def _stream(n, ms="qpsk", gain=1.0, phase=0.0, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    table = constellation(ms)
    sidx = rng.integers(0, len(table), n)
    syms = np.asarray(modulate(table, jnp.asarray(sidx)))
    tx = firinterp(2, firdes_prototype("arkaiser", 2, 7, 0.3))
    x, _ = tx(jnp.asarray(syms.astype(np.complex64)), batch_shape=())
    x = gain * np.asarray(x) * np.exp(1j * phase)
    if noise:
        x = x + noise * (rng.standard_normal(len(x))
                         + 1j * rng.standard_normal(len(x)))
    return sidx, x.astype(np.complex64)


def test_exports():
    for name in ("symtrack", "SymtrackResult", "symtrack_stream",
                 "Symtrack"):
        assert getattr(framing, name) is getattr(pst, name)


def test_oneshot_matches_jax():
    _, x = _stream(800, gain=0.3, phase=0.8, noise=0.004, seed=3)
    rj, rp = jst.symtrack(x), pst.symtrack(x, device="cpu")
    assert len(rp.symbols) == len(rj.symbols) > 700
    np.testing.assert_allclose(rp.symbols, rj.symbols, rtol=0, atol=TOL)
    np.testing.assert_array_equal(rp.decisions, rj.decisions)
    # the tracker works: unit-modulus QPSK at the tail
    assert abs(np.mean(np.abs(rp.symbols[-200:])) - 1.0) < 0.05


@pytest.mark.parametrize("fused", ["0", "1"])
@pytest.mark.parametrize("ms", ["qpsk", "qam16"])
def test_stream_routes_match_jax(monkeypatch, fused, ms):
    # qpsk takes the sign slicer, qam16 the argmin over the table
    monkeypatch.setenv("LIQUID_SYMTRACK_FUSED", fused)
    _, x = _stream(512, ms=ms, gain=0.5, phase=0.3, noise=0.004, seed=4)
    X = np.stack([x, 0.7 * x[::-1]])
    jp, pp = jst.symtrack_stream(ms=ms), pst.symtrack_stream(ms=ms)
    cj = jp.init((2,))
    cp = carry_from_numpy(tp.to_numpy(cj))
    for b in range(2):
        blk = X[:, b * 512:(b + 1) * 512]
        (yj, dj, vj), cj = jp.apply((), cj, jnp.asarray(blk))
        (yp, dp, vp), cp = pp(cp, torch.from_numpy(blk.copy()))
        vj = np.asarray(vj)
        np.testing.assert_array_equal(vp.numpy(), vj)
        np.testing.assert_allclose(yp.numpy()[vj], np.asarray(yj)[vj],
                                   rtol=0, atol=TOL)
        np.testing.assert_array_equal(dp.numpy()[vj], np.asarray(dj)[vj])
        assert dp.dtype == torch.int32
    got = carry_to_numpy(cp)
    for key in ("theta", "dtheta", "eq_w", "eq_buf", "eq_n"):
        np.testing.assert_allclose(got[key], np.asarray(cj[key]), rtol=0,
                                   atol=TOL, err_msg=key)


def test_pll_lms_plain_version_matches_jax_post_scan():
    # the JAX stream's sequential route on its own symsync slots is its
    # post scan; the port's plain version runs on those same slots
    _, x = _stream(512, gain=0.4, phase=-0.6, noise=0.01, seed=7)
    X = np.stack([x[:512], x[512:]])
    jp, pp = jst.symtrack_stream(ms="qpsk"), pst.symtrack_stream(ms="qpsk")
    c0 = jp.init((2,))
    (yj, dj, vj), _ = jp.apply((), c0, jnp.asarray(X))
    (sy, sv), _ = _jax_slots(c0, X)
    cp = carry_from_numpy(tp.to_numpy(c0))
    sy = torch.from_numpy(np.array(sy))
    y_re, y_im, dec, st = pk.pll_lms_reference(
        sy.real.contiguous(), sy.imag.contiguous(),
        torch.from_numpy(np.array(sv)), pp.pll_state(cp, 2), pp.tab_re,
        pp.tab_im, **pp.pll_kwargs())
    vj = np.asarray(vj)
    np.testing.assert_allclose((y_re + 1j * y_im).numpy()[vj],
                               np.asarray(yj)[vj], rtol=0, atol=TOL)
    np.testing.assert_array_equal(dec.numpy()[vj], np.asarray(dj)[vj])


def _jax_slots(c0, X):
    """The JAX package's AGC and symsync stages of symtrack_stream's
    defaults, as its apply runs them: ((slots, valid), carry)."""
    from liquid_dsp_tpu.ops.agc import agc
    from liquid_dsp_tpu.ops.symsync import symsync
    ag, ss = agc(bandwidth=0.02), symsync("arkaiser", 2, 7, 0.3, bw=0.02)
    y, _ = ag.apply(ag.params, c0["agc"], jnp.asarray(X))
    return ss.apply(ss.params, c0["ss"], y)


@pytest.mark.parametrize("ms", ["qpsk", "psk8", "qam16"])
def test_slicer_config_matches_the_jax_qmap(ms):
    table = np.asarray(constellation(ms)).astype(np.complex64)
    cfg = pk.slicer_config(table)
    if ms != "qpsk":
        assert cfg is None
        return
    s2v, kq = cfg
    for (a, b), k in zip(((0, 0), (0, 1), (1, 0), (1, 1)), kq):
        pt = complex((-1) ** a * s2v, (-1) ** b * s2v)
        assert k == int(np.argmin(np.abs(table - pt)))
    # the sign slicer picks the nearest point
    v = torch.randn(500), torch.randn(500)
    tr = torch.from_numpy(table.real.copy())
    ti = torch.from_numpy(table.imag.copy())
    i1, r1, q1 = pk.nearest(*v, tr, ti, cfg)
    i2, r2, q2 = pk.nearest(*v, tr, ti, None)
    assert torch.equal(i1, i2) and torch.equal(r1, r2) and torch.equal(q1, q2)


def test_pll_lms_wrapper_checks():
    pp = pst.symtrack_stream(ms="qpsk")
    st = pp.pll_state(pp.init((2,)), 2)
    s = torch.zeros(2, 30)
    v = torch.ones(2, 30, dtype=torch.bool)
    kw = pp.pll_kwargs()
    launches = pk.pll_lms.launches
    out = pk.pll_lms(s, s, v, st, pp.tab_re, pp.tab_im, **kw)
    assert pk.pll_lms.launches == launches
    assert out[2].shape == (2, 30) and out[2].dtype == torch.int32
    with pytest.raises(ValueError, match="bool"):
        pk.pll_lms(s, s, v.float(), st, pp.tab_re, pp.tab_im, **kw)
    with pytest.raises(ValueError, match="must be"):
        pk.pll_lms(s, s, v, dict(st, ew_re=st["ew_re"][:, :3]), pp.tab_re,
                   pp.tab_im, **kw)
    with pytest.raises(ValueError, match="device"):
        pk.pll_lms(s.to("meta"), s, v, st, pp.tab_re, pp.tab_im, **kw)
    meta = {k: t.to("meta") for k, t in st.items()}
    with pytest.raises(ValueError, match="device"):
        pk.pll_lms(s.to("meta"), s.to("meta"), v.to("meta"), meta,
                   pp.tab_re.to("meta"), pp.tab_im.to("meta"), **kw)


def test_object_matches_oneshot():
    _, x = _stream(560, gain=0.3, phase=0.8, noise=0.004, seed=3)
    ref = pst.symtrack(x, device="cpu")
    st = pst.Symtrack(block_len=512, device="cpu")
    n_use = len(x) // 512 * 512
    sy, dec = st.execute(x[:n_use])
    n = min(len(sy), len(ref.symbols))
    assert n > 480
    np.testing.assert_allclose(sy[:n], ref.symbols[:n], rtol=0, atol=TOL)
    # decisions equal but where a symbol lies within the tolerance of a
    # QPSK decision boundary (the axes), as the outputs near 0 do while the
    # equalizer's window fills: the one-shot demodulates by a distance
    # metric, the stream by signs
    clear = np.minimum(np.abs(ref.symbols[:n].real),
                       np.abs(ref.symbols[:n].imag)) > TOL
    assert clear.sum() >= 0.95 * n
    np.testing.assert_array_equal(dec[:n][clear], ref.decisions[:n][clear])


def test_object_block_size_invariance():
    _, x = _stream(512, gain=0.5, phase=-0.4, noise=0.01, seed=4)
    outs = []
    for bl in (256, 1024):
        sy, dec = pst.Symtrack(block_len=bl, device="cpu").execute(x)
        outs.append((sy, dec))
    n = min(len(outs[0][0]), len(outs[1][0]))
    assert n > 480
    np.testing.assert_allclose(outs[0][0][:n], outs[1][0][:n], rtol=0,
                               atol=TOL)
    np.testing.assert_array_equal(outs[0][1][:n], outs[1][1][:n])


def test_object_state_survives_calls():
    _, x = _stream(512, gain=0.4, phase=0.2, noise=0.01, seed=5)
    n_use = len(x) // 256 * 256
    st1 = pst.Symtrack(block_len=256, device="cpu")
    sy1, _ = st1.execute(x[:n_use])
    st2 = pst.Symtrack(block_len=256, device="cpu")
    chunks = [s for s, _ in (st2.execute(x[i:i + 300])
                             for i in range(0, n_use, 300)) if len(s)]
    sy2 = np.concatenate(chunks)
    n = min(len(sy1), len(sy2))
    np.testing.assert_allclose(sy1[:n], sy2[:n], rtol=0, atol=TOL)
    st2.reset()
    sy3, _ = st2.execute(x[:n_use])
    np.testing.assert_array_equal(sy3, sy1)


def test_entry_points_default_to_the_card_and_raise_without_one():
    # no card here: the defaults must raise, not fall back to the CPU
    assert not torch.cuda.is_available()
    _, x = _stream(64)
    with pytest.raises(RuntimeError, match="CUDA card"):
        pst.symtrack(x)
    with pytest.raises(RuntimeError, match="CUDA card"):
        pst.Symtrack()
    with pytest.raises(RuntimeError, match="CUDA card"):
        pst.Symtrack(device="cuda:0")


def _per_symbol_route(x, ms):
    """The one-shot tracker as the JAX package writes it, on the port's
    stages: AGC and symsync over the capture, then a per-symbol PLL over
    the compacted symbols, then a per-symbol LMS over the PLL's output."""
    from liquid_dsp_tpu_torch.modem import demodulate
    from liquid_dsp_tpu_torch.ops.agc import agc
    from liquid_dsp_tpu_torch.ops.equalize import (eqlms_lowpass_weights,
                                                   eqlms_run)
    from liquid_dsp_tpu_torch.ops.symsync import symsync
    ag = agc(bandwidth=0.02)
    y, _ = ag(ag.init(), torch.from_numpy(x))
    ss = symsync("arkaiser", 2, 7, 0.3, bw=0.02)
    (sy, sv), _ = ss(ss.init(), y)
    tab = torch.from_numpy(np.asarray(constellation(ms), np.complex64))
    theta = torch.zeros((), dtype=torch.float32)
    dtheta = torch.zeros((), dtype=torch.float32)
    vs = []
    for sym in sy[sv]:
        v = sym * torch.exp(-1j * theta)
        e = torch.angle(v * torch.conj(tab[torch.argmin((v - tab).abs())]))
        dtheta = dtheta + 0.5 * 0.05 ** 2 * e
        theta = theta + dtheta + 0.05 * e
        vs.append(v)
    L = 13
    carry = {"w": torch.from_numpy(eqlms_lowpass_weights(L)),
             "buf": torch.zeros(L, dtype=torch.complex64),
             "x2_sum": torch.tensor(float(L), dtype=torch.float32),
             "n": torch.tensor(L, dtype=torch.int32)}
    veq, _ = eqlms_run(
        None, 0.05, carry, torch.stack(vs),
        slicer=lambda yv: tab[torch.argmin((yv[..., None] - tab).abs(),
                                           dim=-1)])
    return veq.numpy(), demodulate(tab, veq).numpy()


@pytest.mark.parametrize("ms", ["qpsk", "qam16"])
def test_oneshot_by_stream_matches_the_cpu_route(ms):
    # the one-shot tracker is one block of symtrack_stream (PLL and LMS
    # stepped together per slot); the per-symbol loops run the PLL over all
    # symbols first and the LMS after it
    _, x = _stream(500, ms=ms, gain=0.3, phase=0.8, noise=0.004, seed=3)
    got = pst.symtrack(x, ms=ms, device="cpu")
    syms, dec = _per_symbol_route(x, ms)
    assert len(got.symbols) == len(syms) > 450
    np.testing.assert_allclose(got.symbols, syms, rtol=0, atol=TOL)
    np.testing.assert_array_equal(got.decisions, dec)
    assert got.decisions.dtype == dec.dtype
