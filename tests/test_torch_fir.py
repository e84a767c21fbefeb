"""Port parity: firfilt, fftfilt and the halfband decimators of
liquid_dsp_tpu_torch against the reference goldens at the reference's
own tolerances (1e-3 autotest convention, tests/test_firfilt.py and
tests/test_fftfilt.py; 1e-5 sample-exact, tests/test_resample.py), and
against the JAX package on the same inputs."""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as tp
from conftest import assert_close
from liquid_dsp_tpu.ops import fir as jfir
from liquid_dsp_tpu.ops import resample as jresample
from liquid_dsp_tpu_torch.convert import (carry_from_numpy, carry_to_numpy,
                                          load_jax_params)
from liquid_dsp_tpu.ops.kernels.pallas_fir import (
    fir_apply_pallas as fir_apply_pallas_jax)
from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
from liquid_dsp_tpu_torch.ops import fir, resample
from liquid_dsp_tpu_torch.ops.kernels import fir_real
from liquid_dsp_tpu_torch.ops.fftfilt import fftfilt

from test_fftfilt import CASES as FFTFILT_CASES
from test_firfilt import FIRFILT_CASES

GOLDEN = pathlib.Path(__file__).parent / "golden" / "flexframe_golden.npz"


def _oneshot(proc, x):
    x = torch.from_numpy(np.asarray(x))
    y, _ = proc(proc.init(dtype=x.dtype), x)
    return y.numpy()


@pytest.mark.parametrize("backend", ["xla", "matmul"])
@pytest.mark.parametrize("case", FIRFILT_CASES)
def test_firfilt_golden(golden, case, backend):
    d = golden(case)
    assert_close(_oneshot(fir.firfilt(d["h"], backend=backend), d["x"]),
                 d["y"], msg=case)


@pytest.mark.parametrize("case", FFTFILT_CASES)
def test_fftfilt_golden(golden, case):
    d = golden(case)
    assert_close(_oneshot(fftfilt(d["h"]), d["x"]), d["y"], msg=case)


@pytest.mark.parametrize("backend", ["xla", "matmul", "fft", "auto"])
@pytest.mark.parametrize("taps", ["real", "complex"])
def test_firfilt_streaming_matches_jax(backend, taps):
    # same inputs through both packages, 3 blocks with carries; f32
    # summation order differs between conv, matmul and FFT: 1e-5 of rms
    rng = np.random.default_rng(21)
    h = rng.standard_normal(37)
    if taps == "complex":
        h = h + 1j * rng.standard_normal(37)
    blocks = [tp.cnoise(rng, (2, 500)) for _ in range(3)]
    jp = jfir.firfilt(h, backend="xla")
    p = fir.firfilt(h, backend=backend)
    load_jax_params(p, tp.jax_params(jp))
    yj, cj = tp.run_jax(jp, blocks, (2,))
    yt, ct = tp.run_torch(p, blocks, (2,))
    assert tp.rel_err(yt, yj) < 1e-5
    np.testing.assert_array_equal(carry_to_numpy(ct), np.asarray(cj))


def test_firfilt_carry_hands_over_from_jax():
    rng = np.random.default_rng(22)
    h = rng.standard_normal(16).astype(np.float32)
    blocks = [tp.cnoise(rng, (2, 256)) for _ in range(2)]
    jp = jfir.firfilt(h)
    _, cj = tp.run_jax(jp, blocks[:1], (2,))
    yj, _ = tp.run_jax(jp, blocks[1:], (2,), carry=cj)
    p = fir.firfilt(h)
    yt, _ = tp.run_torch(p, blocks[1:], (2,),
                         carry=carry_from_numpy(np.asarray(cj)))
    assert tp.rel_err(yt, yj) < 1e-5


def test_firfilt_pallas_backend_not_ported():
    # the port's pallas backend, like the JAX package's, takes real taps
    # only (tests/test_pallas.py:45), and any number of them when it is
    # built: the kernel's limit (fir_real.LMAX) is checked on CUDA tensors
    # only, at the call
    with pytest.raises(ValueError, match="real taps"):
        fir.firfilt(np.ones(8, np.complex64), backend="pallas")
    p = fir.firfilt(np.ones(fir_real.LMAX + 1, np.float32), backend="pallas")
    assert p.backend == "pallas" and p.L == fir_real.LMAX + 1


@pytest.mark.parametrize("L", [4097, 4200])
def test_firfilt_pallas_long_filter_matches_jax(L):
    # above the 4096 taps the card's kernel once took: the plain version on
    # the CPU against the JAX package's Pallas backend (interpret mode on
    # the CPU), 2 carried blocks, 1e-5 of rms as the streaming test
    rng = np.random.default_rng(L)
    h = firdes_kaiser(L, 0.05, 60.0).astype(np.float32)
    blocks = [tp.cnoise(rng, (2, 600)) for _ in range(2)]
    yj, cj = tp.run_jax(jfir.firfilt(h, backend="pallas"), blocks, (2,))
    yt, ct = tp.run_torch(fir.firfilt(h, backend="pallas"), blocks, (2,))
    assert np.isfinite(yt).all() and tp.rel_err(yt, yj) < 1e-5
    np.testing.assert_array_equal(carry_to_numpy(ct), np.asarray(cj))


@pytest.mark.parametrize("L,T,B", [(64, 512, 3), (13, 256, 1), (129, 384, 2),
                                   (257, 1000, 2), (1, 300, 2)])
def test_fir_apply_pallas_matches_jax_interpret(L, T, B):
    # the cases of tests/test_pallas.py:23-43 (and 257 taps, one tap, T
    # not a multiple of a tile): the kernel's plain version against the
    # JAX package's Pallas kernel in interpret mode, 1e-4
    rng = np.random.default_rng(L)
    h = firdes_kaiser(L, 0.2, 60.0).astype(np.float32) if L > 1 else \
        np.array([0.7], np.float32)
    x = tp.cnoise(rng, (B, T))
    carry = tp.cnoise(rng, (B, L - 1))
    yj, cj = fir_apply_pallas_jax(h, jnp.asarray(carry), jnp.asarray(x),
                                  interpret=True)
    y, c = fir_real.fir_apply_pallas(torch.from_numpy(h),
                                     torch.from_numpy(carry),
                                     torch.from_numpy(x))
    assert_close(y.numpy(), np.asarray(yj), tol=1e-4)
    np.testing.assert_array_equal(c.numpy(), np.asarray(cj))


@pytest.mark.parametrize("case", [c for c in FIRFILT_CASES if "cccf" not in c])
def test_firfilt_pallas_golden(golden, case):
    # real-tap goldens (h13x32 is tests/test_pallas.py:39's), 1e-3
    d = golden(case)
    assert_close(_oneshot(fir.firfilt(d["h"], backend="pallas"), d["x"]),
                 d["y"], tol=1e-3, msg=case)


def test_firfilt_pallas_streaming_matches_jax():
    # 3 carried blocks with real taps, as a complex stream and as float
    # planes (planar.py), 1e-5 of rms
    rng = np.random.default_rng(24)
    h = rng.standard_normal(33)
    blocks = [tp.cnoise(rng, (2, 300)) for _ in range(3)]
    jp = jfir.firfilt(h, backend="xla")
    p = fir.firfilt(h, backend="pallas")
    yj, cj = tp.run_jax(jp, blocks, (2,))
    yt, ct = tp.run_torch(p, blocks, (2,))
    np.testing.assert_array_equal(carry_to_numpy(ct), np.asarray(cj))
    assert tp.rel_err(yt, yj) < 1e-5
    cp = p.init_planar(batch_shape=(2,))
    ys = []
    for xb in blocks:
        (yr, yi), cp = p.forward_planar(cp, (torch.from_numpy(xb.real.copy()),
                                             torch.from_numpy(xb.imag.copy())))
        ys.append(yr.numpy() + 1j * yi.numpy())
    assert tp.rel_err(np.concatenate(ys, axis=-1), yj) < 1e-5


def test_fir_real_rejects_bad_input():
    x, c, h = torch.ones(2, 10), torch.ones(2, 3), torch.ones(4)
    with pytest.raises(ValueError, match="carry"):
        fir_real.fir_real(x, torch.ones(2, 4), h)
    with pytest.raises(ValueError, match="float32"):
        fir_real.fir_real(x.double(), c, h)
    with pytest.raises(ValueError, match="contiguous"):
        fir_real.fir_real(torch.ones(10, 2).t(), c, h)
    with pytest.raises(ValueError, match="device"):
        fir_real.fir_real(x, c, h.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        fir_real.fir_real(x.to("meta"), c.to("meta"), h.to("meta"))


@pytest.fixture(scope="module")
def fg():
    return dict(np.load(GOLDEN))


def test_resamp2_decim_golden(fg):
    y = _oneshot(resample.resamp2_decim(7, 0.0, 60.0), fg["r2_x"])
    assert np.abs(y - fg["r2_decim"]).max() < 1e-5


def test_msresamp2_decim_golden(fg):
    y = _oneshot(resample.msresamp2("decim", 2, 0.4, 0.0, 60.0), fg["ms2_x"])
    assert np.abs(y - fg["ms2_d"]).max() < 1e-5


@pytest.mark.parametrize("make", [
    lambda m: m.resamp2_decim(5), lambda m: m.msresamp(0.25, 60.0),
    lambda m: m.msresamp(0.5, 60.0)])
def test_resample_streaming_matches_jax(make):
    rng = np.random.default_rng(23)
    blocks = [tp.cnoise(rng, (2, 512)) for _ in range(3)]
    jp, p = make(jresample), make(resample)
    load_jax_params(p, tp.jax_params(jp))
    yj, _ = tp.run_jax(jp, blocks, (2,))
    yt, _ = tp.run_torch(p, blocks, (2,))
    assert tp.rel_err(yt, yj) < 1e-5


def test_fir_real_never_falls_back_off_cpu(monkeypatch):
    # a device mismatch raises, and a non-CPU tensor never reaches the
    # plain version (here "meta" stands in for a device with no kernel)
    def plain(*a, **k):
        raise AssertionError("plain version reached")

    x, c, h = torch.ones(2, 64), torch.ones(2, 4), torch.ones(5)
    monkeypatch.setattr(fir_real, "fir_real_reference", plain)
    for bad in ((x.to("meta"), c.to("meta"), h.to("meta")),
                (x.to("meta"), c, h), (x, c, h.to("meta"))):
        with pytest.raises(ValueError, match="device"):
            fir_real.fir_real(*bad)
    launches = fir_real.fir_real.launches
    with pytest.raises(AssertionError, match="plain version reached"):
        fir_real.fir_real(x, c, h)        # CPU tensors take the plain path
    assert fir_real.fir_real.launches == launches
