"""Port parity for `design/iirdes.py` (host numpy, float64): every case of
tests/test_iirdes.py through both packages.  The port keeps its own copy
of the design code, so the coefficients must be equal to the last bit
(assert_array_equal); the reference C library's cascades
(tests/golden/flexframe_golden.npz) hold the port to the JAX test's own
tolerances."""
import importlib
import pathlib

import numpy as np
import pytest

import _torch_port  # noqa: F401  (torch thread cap)

# the JAX package's design/__init__ exports the function iirdes under the
# module's name
J = importlib.import_module("liquid_dsp_tpu.design.iirdes")
P = importlib.import_module("liquid_dsp_tpu_torch.design.iirdes")

PROTOTYPES = (
    [("butter_prototype", (n,)) for n in (2, 3, 5, 7)]
    + [("cheby1_prototype", (n, 1.0)) for n in (2, 3, 5)]
    + [("cheby2_prototype", (n, 60.0)) for n in (2, 4, 5)]
    + [("ellip_prototype", (n, 1.0, 60.0)) for n in (3, 4, 5)]
    + [("bessel_prototype", (n,)) for n in (2, 4)])

DESIGNS = [
    # tests/test_iirdes.py SPEC_CASES
    (("butter", 5, 0.2), {"ap_db": 1.0, "as_db": 60.0}),
    (("cheby1", 5, 0.15), {"ap_db": 1.0, "as_db": 60.0}),
    (("cheby2", 5, 0.3), {"ap_db": 1.0, "as_db": 60.0}),
    (("ellip", 5, 0.2), {"ap_db": 1.0, "as_db": 60.0}),
    (("bessel", 5, 0.2), {"ap_db": 1.0, "as_db": 60.0}),
    # the scipy cross-checks
    (("butter", 3, 0.1), {}), (("butter", 7, 0.3), {}),
    (("ellip", 4, 0.2), {"ap_db": 1.0, "as_db": 60.0}),
    (("cheby2", 5, 0.25), {"as_db": 60.0}),
    # the band transforms
    (("butter", 5, 0.2), {"btype": "highpass"}),
    (("butter", 3, 0.35), {"f0": 0.25, "btype": "bandpass"}),
    (("butter", 3, 0.35), {"f0": 0.25, "btype": "bandstop"}),
    # the golden cascades and the paths' filters
    (("cheby2", 4, 0.15), {"as_db": 50.0}),
    (("butter", 7, 0.2), {}), (("butter", 4, 0.125), {"ap_db": 0.1}),
    (("ellip", 6, 0.1), {"ap_db": 0.5, "as_db": 40.0}),
    (("cheby1", 4, 0.3), {"ap_db": 2.0, "btype": "highpass"}),
]


def _equal(p, j):
    for a, b in zip(p, j):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("fn,args", PROTOTYPES)
def test_prototype_equals_jax(fn, args):
    z, p, k = getattr(P, fn)(*args)
    zj, pj, kj = getattr(J, fn)(*args)
    _equal((z, p, k), (zj, pj, kj))
    assert np.all(p.real < 0)


@pytest.mark.parametrize("args,kw", DESIGNS)
@pytest.mark.parametrize("form", ["iirdes", "iirdes_sos"])
def test_design_equals_jax(form, args, kw):
    got = getattr(P, form)(*args, **kw)
    _equal(got, getattr(J, form)(*args, **kw))
    if form == "iirdes":
        assert P.iirdes_isstable(got[0], got[1])


@pytest.mark.parametrize("fn", ["iirdes_pll_active_lag",
                                "iirdes_pll_active_pi"])
@pytest.mark.parametrize("w,zeta,K", [(0.01, 0.707, 1000.0),
                                      (0.02, 0.7071, 1000.0),
                                      (0.1, 0.5, 10.0)])
def test_pll_designs_equal_jax(fn, w, zeta, K):
    _equal(getattr(P, fn)(w, zeta, K), getattr(J, fn)(w, zeta, K))


def test_pll_pi_is_an_integrator_and_bad_params_raise():
    _, a = P.iirdes_pll_active_pi(0.01, 0.707, 1000.0)
    assert abs(np.sum(a)) < 1e-9
    for fn in (P.iirdes_pll_active_lag, P.iirdes_pll_active_pi):
        with pytest.raises(ValueError):
            fn(-1.0, 0.7, 100.0)


@pytest.mark.parametrize("args", [("butter", 5, 0.7), ("gauss", 5, 0.2)])
def test_bad_designs_raise_like_jax(args):
    for mod in (P, J):
        with pytest.raises(ValueError):
            mod.iirdes(*args)


@pytest.mark.parametrize("a", [[1.0, -0.5], [1.0, -1.5], [1.0, -2.0, 1.0],
                               [1.0, -0.9, 0.2], [1.0, 0.0, 0.0, -0.999]])
def test_isstable_equals_jax(a):
    assert P.iirdes_isstable([1.0], a) == J.iirdes_isstable([1.0], a)
    with pytest.raises(ValueError):
        P.iirdes_isstable([1.0], [1.0])


@pytest.mark.parametrize("z,p,k", [
    (np.array([-1.0, -1.0]), np.array([0.5 + 0.3j, 0.5 - 0.3j]), 0.2),
    (np.array([1j, -1j, -1.0]), np.array([0.2 + 0.7j, 0.2 - 0.7j, 0.4]),
     1.5)])
def test_zpk_expansions_equal_jax(z, p, k):
    _equal(P.zpk2tf(z, p, k), J.zpk2tf(z, p, k))
    _equal(P.zpk2sos(z, p, k), J.zpk2sos(z, p, k))
    _equal(P.bilinear_zpk(z[:1], p, 0.7), J.bilinear_zpk(z[:1], p, 0.7))


def _cascade(B, A):
    nb = na = np.poly1d([1.0])
    for b3, a3 in zip(B, A):
        nb, na = nb * np.poly1d(b3), na * np.poly1d(a3)
    return nb.coeffs, na.coeffs


@pytest.mark.parametrize("name,args,kw,tol", [
    ("butter5", ("butter", 5, 0.2), {"as_db": 60.0}, 1e-5),
    ("ellip5", ("ellip", 5, 0.2), {"ap_db": 1.0, "as_db": 60.0}, 5e-3),
    ("cheby24", ("cheby2", 4, 0.15), {"as_db": 50.0}, 1e-3)])
def test_cascade_matches_reference_golden(name, args, kw, tol):
    # tests/test_iirdes.py::TestDesignGolden's case and tolerance
    fg = np.load(pathlib.Path(__file__).parent / "golden" /
                 "flexframe_golden.npz")
    nb, na = _cascade(*P.iirdes_sos(*args, **kw))
    nbr, nar = _cascade(np.real(fg[f"iirdes_{name}_B"]).reshape(-1, 3),
                        np.real(fg[f"iirdes_{name}_A"]).reshape(-1, 3))
    assert np.abs(nb - nbr).max() < tol
    assert np.abs(na - nar).max() < tol
