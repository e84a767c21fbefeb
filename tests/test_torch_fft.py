"""Port parity: `liquid_dsp_tpu_torch.ops.fft` against the reference's
golden vectors and the JAX package, on the same seeded inputs.

Tolerances: the goldens at tests/test_fft.py's own (2e-3*sqrt(n) forward,
1e-4*sqrt(n) round trip, 1e-3*n r2r); the JAX package within
1e-5*sqrt(n) of the spectrum's peak (its size chooser and pocketfft sum
in other orders); spgram and the one-shot PSD within 1e-5 relative."""
import pathlib

import numpy as np
import pytest
import torch

import _torch_port as tp
import jax.numpy as jnp
from conftest import assert_close
from liquid_dsp_tpu.ops import fft as jfft
from liquid_dsp_tpu.design import windows as jwin
from liquid_dsp_tpu_torch.convert import (carry_from_numpy, carry_to_numpy,
                                          load_jax_params)
from liquid_dsp_tpu_torch.design import windows
from liquid_dsp_tpu_torch.ops import fft

SIZES = [2, 3, 4, 5, 6, 7, 8, 9, 10, 16, 17, 20, 21, 22, 24, 26, 30, 32,
         35, 36, 43, 48, 63, 64, 79, 92, 96, 120, 130, 157, 192, 317, 509]
GOLDEN = pathlib.Path(__file__).parent / "golden" / "flexframe_golden.npz"


@pytest.mark.parametrize("n", SIZES)
def test_fft_golden_forward_and_roundtrip(golden, n):
    d = golden(f"fft_data_{n}")
    x = torch.from_numpy(d[f"fft_test_x{n}"].astype(np.complex64))
    y = fft.fft(x)
    assert_close(y.numpy(), d[f"fft_test_y{n}"], tol=2e-3 * np.sqrt(n))
    xr = fft.ifft(y, normalize=True)
    assert_close(xr.numpy(), x.numpy(), tol=1e-4 * np.sqrt(n))


@pytest.mark.parametrize("n", [8, 27, 32])
@pytest.mark.parametrize("kind", ["REDFT00", "REDFT10", "REDFT01", "REDFT11",
                                  "RODFT00", "RODFT10", "RODFT01", "RODFT11"])
def test_r2r_golden_and_jax(n, kind):
    d = np.load(f"tests/golden/fft_r2rdata_{n}.npz")
    x = d[f"fftdata_r2r_x{n}"]
    y = fft.r2r(x, kind, device="cpu").numpy()
    assert_close(y, d[f"fftdata_r2r_{kind}_y{n}"], tol=1e-3 * n)
    want = np.asarray(jfft.r2r(jnp.asarray(x), kind))
    assert tp.rel_err(y, want) < 1e-5


# one size per branch of the JAX package's size chooser (four-step mixed
# radix, matmul DFT, Rader, 2^k * prime, the peel) and powers of two
@pytest.mark.parametrize("n", [64, 96, 384, 1200, 638, 127, 509, 1021, 2043,
                               2053, 4099, 8191, 4106, 16396, 6138])
def test_fft_matches_jax_on_the_chooser_sizes(n):
    rng = np.random.default_rng(n)
    x = tp.cnoise(rng, (3, n))
    y = fft.fft(x, device="cpu").numpy()
    want = np.asarray(jfft.fft(jnp.asarray(x)))
    scale = np.abs(want).max()
    assert np.abs(y - want).max() / scale < 1e-5 * np.sqrt(n)
    # the backward transform is unnormalized, as the reference's
    yb = fft.ifft(x, device="cpu").numpy()
    wb = np.asarray(jfft.ifft(jnp.asarray(x)))
    assert np.abs(yb - wb).max() / np.abs(wb).max() < 1e-5 * np.sqrt(n)


@pytest.mark.parametrize("n", [40, 64, 100])
def test_fft_pads_and_cuts_like_jax(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((2, 64)).astype(np.float32)     # real input
    for f, jf in ((fft.fft, jfft.fft), (fft.ifft, jfft.ifft)):
        y = f(x, n, device="cpu").numpy()
        want = np.asarray(jf(jnp.asarray(x), n))
        assert y.dtype == np.complex64 and y.shape == want.shape == (2, n)
        assert tp.rel_err(y, want) < 1e-5
    plan = fft.fft_plan(n, fft.FFT_BACKWARD, device="cpu")
    assert tp.rel_err(plan(x).numpy(),
                      np.asarray(jfft.fft_plan(n, jfft.FFT_BACKWARD)(
                          jnp.asarray(x)))) < 1e-5
    np.testing.assert_array_equal(fft.fft_shift(x, device="cpu").numpy(),
                                  np.asarray(jfft.fft_shift(jnp.asarray(x))))


@pytest.mark.parametrize("kind,n,arg", [
    ("hamming", 33, 0.0), ("hann", 32, 0.0), ("blackmanharris", 40, 0.0),
    ("kbd", 24, 5.0), ("rcostaper", 30, 6), ("kaiser", 31, 10.0),
    ("rect", 7, 0.0)])
def test_windows_match_jax(kind, n, arg):
    np.testing.assert_allclose(windows.window(kind, n, arg),
                               jwin.window(kind, n, arg), rtol=0, atol=1e-15)


def test_window_errors():
    with pytest.raises(ValueError):
        windows.window("triangle", 8)
    with pytest.raises(ValueError):
        windows.kbd(7, 3.0)
    with pytest.raises(ValueError):
        windows.rcostaper(8, 5)


@pytest.mark.parametrize("window,alpha", [("hamming", -1.0),
                                          ("kaiser", 0.1),
                                          ("blackmanharris", 0.5)])
def test_spgram_streams_like_jax(window, alpha):
    # uneven blocks (one shorter than a window, one empty of transforms),
    # three channels; the carry and the PSD after every block
    rng = np.random.default_rng(len(window))
    nfft, wlen, delay = 64, 40, 12
    jq = jfft.spgram(nfft, window, wlen, delay, alpha)
    q = fft.spgram(nfft, window, wlen, delay, alpha)
    np.testing.assert_allclose(q.w.numpy(), np.asarray(jq.params["w"]),
                               rtol=1e-7)
    jc, c = jq.init(batch_shape=(3,)), q.init(batch_shape=(3,))
    for T in (200, 7, 300, 129):
        x = tp.cnoise(rng, (3, T))
        jp, jc = jq.apply(jq.params, jc, jnp.asarray(x))
        p, c = q(c, torch.from_numpy(x))
        want = tp.to_numpy(jc)
        np.testing.assert_array_equal(c["count"].numpy(), want["count"])
        assert tp.rel_err(p.numpy(), np.asarray(jp)) < 1e-5
        assert tp.rel_err(c["buf"].numpy(), want["buf"]) < 1e-6
    db = fft.spgram_estimate(p).numpy()
    jdb = np.asarray(jfft.spgram_estimate(jp))
    assert np.abs(db - jdb).max() < 1e-4
    assert fft.asgram_render(db[0]) == jfft.asgram_render(jdb[0])


def test_spgram_stream_changes_package():
    # the first block in JAX, the rest in the port: the carry by
    # carry_from_numpy, the window by load_jax_params
    rng = np.random.default_rng(5)
    jq = jfft.spgram(128, "hann", 64, 16, 0.2)
    q = fft.spgram(128, "hann", 64, 16, 0.2)
    with torch.no_grad():
        q.w.zero_()
    load_jax_params(q, tp.jax_params(jq))
    x = tp.cnoise(rng, (2, 3 * 500))
    jp, jc = tp.run_jax(jq, [x[:, :500]], (2,))
    c = carry_from_numpy(tp.to_numpy(jc))
    for b in (1, 2):
        xb = x[:, b * 500:(b + 1) * 500]
        jpb, jc = jq.apply(jq.params, jc, jnp.asarray(xb))
        p, c = q(c, torch.from_numpy(xb))
    assert tp.rel_err(p.numpy(), np.asarray(jpb)) < 1e-5
    back = carry_to_numpy(c)
    np.testing.assert_array_equal(back["count"], np.asarray(jc["count"]))


def test_spgram_counts_transforms():
    q = fft.spgram(nfft=128, window_len=64, delay=32)
    rng = np.random.default_rng(0)
    c = q.init()
    for _ in range(3):
        _, c = q(c, torch.from_numpy(tp.cnoise(rng, 512)))
    # each block yields T//delay + 1 transforms (the initial zero-padded
    # window counts once, as in the reference)
    assert int(c["count"]) == 3 * (512 // 32 + 1)
    with pytest.raises(ValueError):
        fft.spgram(nfft=64, window_len=65)


def test_spgram_psd_oneshot_golden_and_jax():
    g = dict(np.load(GOLDEN))
    psd = fft.spgram_psd_oneshot(g["spgram_x"], 256, "kaiser", 128, 10.0,
                                 device="cpu")
    assert np.abs(psd.numpy() - np.real(g["spgram_psd"])).max() < 1e-3
    rng = np.random.default_rng(9)
    x = tp.cnoise(rng, (2, 700))
    want = np.asarray(jfft.spgram_psd_oneshot(jnp.asarray(x), 512, "hamming",
                                              300))
    got = fft.spgram_psd_oneshot(x, 512, "hamming", 300,
                                 device="cpu").numpy()
    assert tp.rel_err(got, want) < 1e-5


ENTRY_POINTS = {
    "fft": lambda x, **kw: fft.fft(x, **kw),
    "ifft": lambda x, **kw: fft.ifft(x, **kw),
    "fft_plan": lambda x, **kw: fft.fft_plan(16, **kw)(x),
    "fft_shift": lambda x, **kw: fft.fft_shift(x, **kw),
    "dct": lambda x, **kw: fft.dct(x.real, **kw),
    "dst": lambda x, **kw: fft.dst(x.real, **kw),
    "r2r": lambda x, **kw: fft.r2r(x.real, "REDFT10", **kw),
    "spgram_psd_oneshot": lambda x, **kw: fft.spgram_psd_oneshot(x, 16, **kw),
    "spgram_estimate": lambda x, **kw: fft.spgram_estimate(abs(x.real),
                                                          **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_host_arrays_go_to_the_card_unless_told(name):
    # a host array runs on the card by default (and raises without one),
    # on the CPU when the caller says so; a tensor stays where it lies
    f = ENTRY_POINTS[name]
    x = tp.cnoise(np.random.default_rng(1), (2, 16))
    on_cpu = f(x, device="cpu")
    assert on_cpu.device.type == "cpu"
    assert torch.equal(f(torch.from_numpy(x)), on_cpu)
    if torch.cuda.is_available():
        assert f(x).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA card"):
            f(x)
