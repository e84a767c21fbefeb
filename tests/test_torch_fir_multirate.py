"""Port parity for the multi-rate side of ops/fir.py: firdecim against the
reference C library's goldens (1e-3, `assert_close`, as
tests/test_firfilt.py:54-59 holds the JAX package), and firdecim,
firinterp, the Hilbert forms, autocorr, firpfb_execute,
fir_freqresponse and firfilt_rect against the JAX package on the same
inputs over 3 carried blocks (1e-5 of rms: both are float32 filters
that differ in summation order only), with the JAX params and carries
handed to the port."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import _torch_port as tp
from conftest import assert_close
from liquid_dsp_tpu.ops import fir as jfir
from liquid_dsp_tpu_torch.convert import (carry_from_numpy, carry_to_numpy,
                                          load_jax_params)
from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
from liquid_dsp_tpu_torch.ops import fir

from test_firfilt import FIRDECIM_CASES

TOL = 1e-5


def _equal_carries(ct, cj):
    got, want = carry_to_numpy(ct), tp.to_numpy(cj)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", FIRDECIM_CASES)
def test_firdecim_golden(golden, case):
    d = golden(case)
    m = int(case.split("_M")[1][0])
    x = torch.from_numpy(np.asarray(d["x"]))
    p = fir.firdecim(m, d["h"])
    y, _ = p(p.init(dtype=x.dtype), x)
    assert_close(y.numpy(), d["y"], msg=case)


def _h(rng, L, complex_):
    h = rng.standard_normal(L)
    return h + 1j * rng.standard_normal(L) if complex_ else h


# name: (maker taking the module and the taps, block shape, real input)
_MAKERS = {
    "firdecim4": (lambda m, h: m.firdecim(4, h), (2, 512), False),
    "firdecim3_57": (lambda m, h: m.firdecim(3, h), (2, 480), False),
    "firinterp4": (lambda m, h: m.firinterp(4, h), (2, 200), False),
    "firinterp3_29": (lambda m, h: m.firinterp(3, h), (2, 300), False),
    "firinterp2_short": (lambda m, h: m.firinterp(2, h[:2]), (2, 64), False),
    "firhilb": (lambda m, h: m.firhilb(5), (2, 512), True),
    "firhilb_m7": (lambda m, h: m.firhilb(7, 80.0), (3, 256), True),
    "firhilb_r2c": (lambda m, h: m.firhilb_r2c(5), (2, 300), True),
    "firhilb_interp": (lambda m, h: m.firhilb_interp(5), (2, 300), False),
    "firhilb_c2r": (lambda m, h: m.firhilb_c2r(), (2, 100), False),
    "autocorr": (lambda m, h: m.autocorr(16, 4), (2, 300), False),
    "autocorr_d0": (lambda m, h: m.autocorr(7, 0), (1, 128), False),
    "firfilt_rect": (lambda m, h: m.firfilt_rect(9), (2, 200), False),
}


@pytest.mark.parametrize("name,taps", [(n, "real") for n in sorted(_MAKERS)]
                         + [(n, "complex") for n in sorted(_MAKERS)
                            if n.startswith(("firdecim", "firinterp"))])
def test_streaming_matches_jax(name, taps):
    make, shape, real = _MAKERS[name]
    rng = np.random.default_rng(sorted(_MAKERS).index(name))
    L = 57 if "57" in name else 29 if "29" in name else 48
    h = _h(rng, L, taps == "complex")
    jp, p = make(jfir, h), make(fir, h)
    load_jax_params(p, tp.jax_params(jp))
    if real:
        blocks = [rng.standard_normal(shape).astype(np.float32)
                  for _ in range(3)]
    else:
        blocks = [tp.cnoise(rng, shape) for _ in range(3)]
    yj, cj = tp.run_jax(jp, blocks, shape[:1])
    yt, ct = tp.run_torch(p, blocks, shape[:1])
    assert yt.dtype == yj.dtype
    assert tp.rel_err(yt, yj) < TOL
    _equal_carries(ct, cj)
    assert p.rate == jp.rate


@pytest.mark.parametrize("name", ["firdecim4", "firinterp4", "firhilb",
                                  "firhilb_interp", "autocorr"])
def test_jax_carry_hands_over_mid_stream(name):
    make, shape, real = _MAKERS[name]
    rng = np.random.default_rng(40)
    h = _h(rng, 48, False)
    if real:
        blocks = [rng.standard_normal(shape).astype(np.float32)
                  for _ in range(3)]
    else:
        blocks = [tp.cnoise(rng, shape) for _ in range(3)]
    jp, p = make(jfir, h), make(fir, h)
    _, cj = tp.run_jax(jp, blocks[:1], shape[:1])
    yj, _ = tp.run_jax(jp, blocks[1:], shape[:1], carry=cj)
    yt, _ = tp.run_torch(p, blocks[1:], shape[:1],
                         carry=carry_from_numpy(tp.to_numpy(cj)))
    assert tp.rel_err(yt, yj) < TOL


@pytest.mark.parametrize("name", ["firdecim4", "firinterp4"])
def test_planar_forms_match_jax(name):
    make, shape, _ = _MAKERS[name]
    rng = np.random.default_rng(41)
    h = _h(rng, 48, False)
    blocks = [tp.cnoise(rng, shape) for _ in range(3)]
    jp, p = make(jfir, h), make(fir, h)
    jc = jp.planar_init(batch_shape=shape[:1])
    pc = p.init_planar(batch_shape=shape[:1])
    ys_j, ys_t = [], []
    for xb in blocks:
        (jr, ji), jc = jp.planar_apply(jp.params, jc, (
            jnp.asarray(xb.real.copy()), jnp.asarray(xb.imag.copy())))
        (tr, ti), pc = p.forward_planar(pc, (
            torch.from_numpy(xb.real.copy()),
            torch.from_numpy(xb.imag.copy())))
        ys_j.append(np.asarray(jr) + 1j * np.asarray(ji))
        ys_t.append(tr.numpy() + 1j * ti.numpy())
    assert tp.rel_err(np.concatenate(ys_t, -1), np.concatenate(ys_j, -1)) \
        < TOL


@pytest.mark.parametrize("k,L,T", [(4, 48, 300), (2, 29, 256), (3, 7, 100),
                                   (5, 1, 64)])
def test_firinterp_banded_equals_conv(k, L, T):
    # the card's form (one banded matmul for all k phases, output tiles
    # padded to a multiple of k) against the CPU's per-phase conv, and
    # against the JAX package's banded form, on the same inputs
    rng = np.random.default_rng(k * 100 + L)
    p = fir.firinterp(k, rng.standard_normal(L))
    xs = tp.cnoise(rng, (2, T + p.Lp - 1))
    xp = torch.from_numpy(xs)
    y_band = fir._interp_banded(p.hp, xp, T, k, p.Lp)
    y_conv, _ = p(xp[..., :p.Lp - 1], xp[..., p.Lp - 1:])
    assert y_band.shape == y_conv.shape == (2, T * k)
    assert tp.rel_err(y_band.numpy(), y_conv.numpy()) < TOL
    y_jax = jfir._interp_banded(jnp.asarray(p.hp.numpy()), jnp.asarray(xs),
                                T, k, p.Lp)
    assert tp.rel_err(y_band.numpy(), np.asarray(y_jax)) < TOL


@pytest.mark.parametrize("complex_", [False, True])
def test_firpfb_execute_matches_jax(complex_):
    rng = np.random.default_rng(42)
    hp = rng.standard_normal((32, 12)).astype(np.float32)
    xw = (tp.cnoise(rng, (3, 5, 12)) if complex_ else
          rng.standard_normal((3, 5, 12)).astype(np.float32))
    got = fir.firpfb_execute(torch.from_numpy(hp), torch.from_numpy(xw))
    want = np.asarray(jfir.firpfb_execute(jnp.asarray(hp), jnp.asarray(xw)))
    assert got.shape == want.shape == (3, 5, 32)
    assert tp.rel_err(got.numpy(), want) < TOL


@pytest.mark.parametrize("taps", ["real", "complex"])
def test_fir_freqresponse_matches_jax(taps):
    rng = np.random.default_rng(43)
    h = _h(rng, 31, taps == "complex")
    for fc in (0.0, 0.05, 0.2, -0.31):
        got = fir.fir_freqresponse(h, fc)
        want = np.asarray(jfir.fir_freqresponse(h, fc))
        assert got.numpy().dtype == want.dtype
        assert abs(complex(got) - complex(want)) < 1e-5 * np.abs(h).sum()
    hk = firdes_kaiser(41, 0.2, 60.0)
    g = fir.fir_freqresponse(torch.from_numpy(hk.astype(np.float32)), 0.0)
    assert abs(complex(g) - hk.sum()) < 1e-5


def test_firfilt_rect_and_validation():
    p = fir.firfilt_rect(5)
    y, _ = p(p.init(dtype=torch.float32), torch.ones(12))
    np.testing.assert_array_equal(y.numpy(), [1, 2, 3, 4, 5] + [5] * 7)
    for n in (0, 1025):
        with pytest.raises(ValueError):
            fir.firfilt_rect(n)
        with pytest.raises(ValueError):
            jfir.firfilt_rect(n)


def test_firdecim_lti_and_rates():
    h = firdes_kaiser(48, 0.1, 60.0)
    p, jp = fir.firdecim(4, h), jfir.firdecim(4, h)
    assert (p.lti.down, p.lti.d) == (jp.lti.down, jp.lti.d) == (4, 0)
    np.testing.assert_array_equal(p.lti.taps, jp.lti.taps)
    assert p.halo == jp.halo == 47 and p.rate == (1, 4)
    q = fir.firinterp(1, np.array([0.5]))
    y, c = q(q.init(batch_shape=(2,)), torch.ones(2, 8, dtype=torch.complex64))
    assert c.shape == (2, 0) and torch.all(y == 0.5)
