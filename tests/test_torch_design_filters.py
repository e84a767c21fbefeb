"""Port parity for the filter design code: the firdes names, the
Parks-McClellan design (`design/firdespm.py`) and the special functions
of liquid_dsp_tpu_torch.design against the JAX package's.

Both packages run the same numpy float64 code, so the taps are held
equal to the last bit (assert_array_equal), the Remez exchange and the
hM3 search included; the reference's own firdespm tests bound those by
tolerances (tests/test_firdespm.py), which the bit-equality implies."""
import importlib

import numpy as np
import pytest

import _torch_port  # noqa: F401  (torch thread cap)
from liquid_dsp_tpu.design import firdes as jfirdes
from liquid_dsp_tpu.design import special as jspecial
from liquid_dsp_tpu_torch.design import firdes, special

# both packages' design/__init__ bind the name firdespm to the function
firdespm = importlib.import_module("liquid_dsp_tpu_torch.design.firdespm")
jfirdespm = importlib.import_module("liquid_dsp_tpu.design.firdespm")

NYQUIST = ["rcos", "fexp", "fsech", "farcsech", "rfexp", "rfsech",
           "rfarcsech"]


@pytest.mark.parametrize("ftype,k,m,beta,dt", [
    (f, *c) for f in NYQUIST
    for c in ((2, 5, 0.3, 0.0), (4, 3, 0.5, 0.0), (2, 7, 0.25, 0.25))] + [
    ("hm3", 2, 7, 0.3, 0.0), ("hm3", 2, 4, 0.5, 0.0),
    ("hm3", 3, 3, 0.35, 0.0)])
def test_prototypes_bit_equal(ftype, k, m, beta, dt):
    h = firdes.firdes_prototype(ftype, k, m, beta, dt)
    ref = jfirdes.firdes_prototype(ftype, k, m, beta, dt)
    assert h.dtype == ref.dtype and h.shape == (2 * k * m + 1,)
    np.testing.assert_array_equal(h, ref)


@pytest.mark.parametrize("name", [n[len("firdes_"):] for n in
                                  ("firdes_fexp", "firdes_rfexp",
                                   "firdes_fsech", "firdes_rfsech",
                                   "firdes_farcsech", "firdes_rfarcsech",
                                   "firdes_rcos")])
def test_flipped_nyquist_direct_calls(name):
    for args in ((2, 4, 0.2), (3, 3, 0.7)):
        np.testing.assert_array_equal(
            getattr(firdes, "firdes_" + name)(*args),
            getattr(jfirdes, "firdes_" + name)(*args))


def test_notch_doppler_and_estimates():
    for m, f0, as_db in ((12, 0.2, 60.0), (25, 0.07, 40.0)):
        np.testing.assert_array_equal(firdes.firdes_notch(m, f0, as_db),
                                      jfirdes.firdes_notch(m, f0, as_db))
    for n, fd, kr, th in ((21, 0.05, 2.0, 0.4), (51, 0.01, 0.0, 0.0)):
        np.testing.assert_array_equal(
            firdes.firdes_doppler(n, fd, kr, th),
            jfirdes.firdes_doppler(n, fd, kr, th))
    for as_db, n in ((60.0, 55), (80.0, 101), (30.0, 11)):
        assert firdes.estimate_req_filter_df(as_db, n) == \
            jfirdes.estimate_req_filter_df(as_db, n)


def test_analysis_helpers():
    rng = np.random.default_rng(3)
    h, g = rng.standard_normal(23), rng.standard_normal(17)
    for lag in (-20, -3, 0, 5, 22, 40):
        assert firdes.filter_crosscorr(h, g, lag) == \
            jfirdes.filter_crosscorr(h, g, lag)
    hk = jfirdes.firdes_kaiser(41, 0.2, 60.0)
    for fc in (0.0, 0.1, 0.25):
        assert firdes.filter_energy(hk, fc) == jfirdes.filter_energy(hk, fc)
        assert firdes.fir_group_delay(hk, fc) == \
            jfirdes.fir_group_delay(hk, fc)


@pytest.mark.parametrize("case", [
    (41, [(0.0, 0.2), (0.25, 0.5)], [1.0, 0.0], None, None),
    (40, [(0.0, 0.2), (0.3, 0.5)], [1.0, 0.0], [1.0, 10.0], None),
    (71, [(0.0, 0.1), (0.15, 0.3), (0.36, 0.5)], [0.0, 1.0, 0.0],
     [10.0, 1.0, 10.0], None),
    (29, [(0.0, 0.2), (0.25, 0.25), (0.3, 0.5)], [1.0, 0.7, 0.0],
     None, ["flat", "flat", "exp"]),
    (31, [(0.0, 0.2), (0.3, 0.5)], [1.0, 0.0], None, ["lin", "flat"])])
def test_firdespm_bit_equal(case):
    n, bands, des, w, wt = case
    h = firdespm.firdespm(n, bands, des, w, wtype=wt)
    np.testing.assert_array_equal(
        h, jfirdespm.firdespm(n, bands, des, w, wtype=wt))


@pytest.mark.parametrize("n,fc,as_db", [(41, 0.2, 60.0), (30, 0.1, 40.0)])
def test_firdespm_lowpass_bit_equal(n, fc, as_db):
    np.testing.assert_array_equal(firdespm.firdespm_lowpass(n, fc, as_db),
                                  jfirdespm.firdespm_lowpass(n, fc, as_db))


def test_firdespm_rejects_what_the_reference_rejects():
    for args in ((31, [(0.0, 0.6)], [1.0]), (31, [(0.0, 0.2)], [1.0, 0.0]),
                 (2, [(0.0, 0.2)], [1.0])):
        with pytest.raises(ValueError):
            jfirdespm.firdespm(*args)
        with pytest.raises(ValueError):
            firdespm.firdespm(*args)


def test_pm_prototype_fails_in_both_packages():
    # the JAX reference's "pm" route imports a firdespm_run that its
    # firdespm module lacks (liquid_dsp_tpu/design/firdes.py:423); the
    # port names that fault instead of inventing a design
    with pytest.raises(ImportError, match="firdespm_run"):
        jfirdes.firdes_prototype("pm", 2, 5, 0.3)
    with pytest.raises(NotImplementedError, match="firdespm_run"):
        firdes.firdes_prototype("pm", 2, 5, 0.3)
    with pytest.raises(ValueError, match="unknown prototype"):
        jfirdes.firdes_prototype("nope", 2, 5, 0.3)
    with pytest.raises(ValueError, match="unknown prototype"):
        firdes.firdes_prototype("nope", 2, 5, 0.3)


Z = np.array([0.0, 0.3, 1.0, 2.5, 7.0, 19.0])


@pytest.mark.parametrize("name,args", [
    ("gamma", (np.array([0.5, 1.0, 3.2, 7.0]),)),
    ("lowergamma", (np.array([0.5, 2.0, 4.5]), np.array([0.1, 1.5, 6.0]))),
    ("lnuppergamma", (np.array([0.5, 2.0, 4.5]), np.array([0.1, 1.5, 6.0]))),
    ("uppergamma", (np.array([0.5, 2.0, 4.5]), np.array([0.1, 1.5, 6.0]))),
    ("besselj", (1.5, Z)), ("besselj", (0.0, Z)), ("besselj0", (Z,)),
    ("nchoosek", (48, 23)), ("nchoosek", (7, 0)), ("factorial", (9,)),
    ("gcd", (84, 36)), ("factor", (360,)), ("factor", (97,)),
    ("unique_factor", (360,)), ("is_prime", (97,)), ("is_prime", (91,)),
    ("is_prime", (2,)), ("totient", (36,)), ("totient", (97,)),
    ("modpow", (7, 128, 13)), ("primitive_root_prime", (23,)),
    ("primitive_root_prime", (2,)), ("nextpow2", (1,)),
    ("nextpow2", (1000,))])
def test_special_functions_equal(name, args):
    with np.errstate(invalid="ignore"):
        got = getattr(special, name)(*args)
        ref = getattr(jspecial, name)(*args)
    np.testing.assert_array_equal(got, ref)


def test_special_functions_reject_like_the_reference():
    for name, args in (("nchoosek", (3, 5)), ("nextpow2", (0,)),
                       ("factor", (0,)), ("primitive_root_prime", (21,))):
        with pytest.raises(ValueError):
            getattr(jspecial, name)(*args)
        with pytest.raises(ValueError):
            getattr(special, name)(*args)
