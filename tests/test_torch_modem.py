"""Port parity: the linear modems of liquid_dsp_tpu_torch against the JAX
package.  The tables are the same numpy construction (equal); modulate
and hard demodulate pick table entries (equal); the max-log LLRs are f32
distance differences computed the same way (1e-6).  The Procs
(modem_modulator / modem_demodulator, DPSK) stream against the JAX
package's with equal symbols and samples within 1e-5, and phase_error
within 1e-5."""
import numpy as np
import pytest
import torch

import _torch_port as tp
import jax.numpy as jnp
from liquid_dsp_tpu.modem import linear as jlinear
from liquid_dsp_tpu_torch.modem import linear

TOL_LLR = 1e-6


def test_schemes_and_tables_equal():
    assert linear.MODEM_SCHEMES == jlinear.MODEM_SCHEMES
    for scheme in linear.MODEM_SCHEMES:
        t, j = linear.constellation(scheme), jlinear.constellation(scheme)
        assert t.dtype == j.dtype, scheme
        np.testing.assert_array_equal(t, j, err_msg=scheme)
        assert linear.bits_per_symbol(scheme) == jlinear.bits_per_symbol(
            scheme)


def test_gray_codes():
    x = np.arange(1 << 10)
    np.testing.assert_array_equal(linear.gray_encode(x),
                                  jlinear.gray_encode(x))
    np.testing.assert_array_equal(linear.gray_decode(x),
                                  jlinear.gray_decode(x))
    np.testing.assert_array_equal(linear.gray_decode(linear.gray_encode(x)),
                                  x)


@pytest.mark.parametrize("scheme", ["bpsk", "qpsk", "psk8", "qam16", "ask4",
                                    "apsk32", "qam64", "sqam32", "v29",
                                    "arb64vt"])
def test_modulate_demodulate_match_jax(scheme):
    rng = np.random.default_rng(len(scheme))
    table = linear.constellation(scheme)
    M = len(table)
    syms = rng.integers(0, M, (3, 200))
    y = linear.modulate(table, torch.from_numpy(syms))
    yj = np.asarray(jlinear.modulate(table, jnp.asarray(syms)))
    np.testing.assert_array_equal(y.numpy(), yj)
    noisy = (yj + 0.15 * tp.cnoise(rng, yj.shape)).astype(np.complex64)
    hard = linear.demodulate(table, torch.from_numpy(noisy))
    np.testing.assert_array_equal(
        hard.numpy(), np.asarray(jlinear.demodulate(table,
                                                    jnp.asarray(noisy))))
    np.testing.assert_array_equal(
        linear.demodulate(table, y).numpy(), syms)
    llr = linear.demodulate_soft(table, torch.from_numpy(noisy), 0.5)
    llr_j = np.asarray(jlinear.demodulate_soft(table, jnp.asarray(noisy),
                                               0.5))
    assert llr.dtype == torch.float32 and llr.shape == llr_j.shape
    assert np.abs(llr.numpy() - llr_j).max() < TOL_LLR * max(
        1.0, np.abs(llr_j).max())
    np.testing.assert_array_equal(
        linear.soft_to_hard(llr).numpy(),
        np.asarray(jlinear.soft_to_hard(jnp.asarray(llr_j))))


def test_demodulate_soft_qpsk_signs():
    # frame64's constellation: bit 0 (LSB) -> real sign, bit 1 -> imag
    table = linear.constellation("qpsk")
    y = torch.from_numpy(table.copy())
    llr = linear.demodulate_soft(table, y)
    assert llr.shape == (4, 2)
    np.testing.assert_array_equal((llr > 0).numpy(),
                                  [[0, 0], [0, 1], [1, 0], [1, 1]])


@pytest.mark.parametrize("scheme", ["qpsk", "qam16", "psk8", "apsk32"])
def test_modem_procs_and_phase_error_match_jax(scheme):
    rng = np.random.default_rng(len(scheme) + 7)
    M = len(linear.constellation(scheme))
    mod, jmod = linear.modem_modulator(scheme), jlinear.modem_modulator(
        scheme)
    syms = [rng.integers(0, M, (2, 100)) for _ in range(2)]
    got, _ = tp.run_torch(mod, syms, (2,))
    want, _ = tp.run_jax(jmod, syms, (2,))
    np.testing.assert_array_equal(got, want)
    y = (want + 0.1 * tp.cnoise(rng, want.shape)).astype(np.complex64)
    blocks = [y[:, :100], y[:, 100:]]
    for soft in (False, True):
        dem = linear.modem_demodulator(scheme, soft=soft, noise_var=0.5)
        jdem = jlinear.modem_demodulator(scheme, soft=soft, noise_var=0.5)
        got = np.concatenate([dem((), torch.from_numpy(b.copy()))[0].numpy()
                              for b in blocks], axis=1)
        want_d = np.concatenate([np.asarray(jdem.apply(
            jdem.params, (), jnp.asarray(b))[0]) for b in blocks], axis=1)
        if soft:
            assert np.abs(got - want_d).max() < TOL_LLR * max(
                1.0, np.abs(want_d).max())
        else:
            np.testing.assert_array_equal(got, want_d)
    table = linear.constellation(scheme)
    s_hat = linear.demodulate(table, torch.from_numpy(y))
    pe = linear.phase_error(table, torch.from_numpy(y), s_hat).numpy()
    pe_j = np.asarray(jlinear.phase_error(table, jnp.asarray(y),
                                          jnp.asarray(s_hat.numpy())))
    assert np.abs(pe - pe_j).max() < 1e-5


@pytest.mark.parametrize("m", range(1, 9))
def test_dpsk_streams_match_jax(m):
    # two blocks through both packages, then the JAX carry after block 1
    # continued in the port; a constant rotation leaves every decision
    # but the first unchanged
    from liquid_dsp_tpu_torch.convert import carry_from_numpy
    M = 1 << m
    rng = np.random.default_rng(m)
    syms = [rng.integers(0, M, (2, 128)) for _ in range(2)]
    mod, jmod = linear.dpsk_modulator(m), jlinear.dpsk_modulator(m)
    got, c = tp.run_torch(mod, syms, (2,))
    want, cj = tp.run_jax(jmod, syms, (2,))
    assert np.abs(got - want).max() < 1e-5
    np.testing.assert_array_equal(c.numpy(), np.asarray(cj))
    _, cj1 = tp.run_jax(jmod, syms[:1], (2,))
    y2, _ = mod(carry_from_numpy(tp.to_numpy(cj1)),
                torch.from_numpy(syms[1]))
    assert np.abs(y2.numpy() - want[:, 128:]).max() < 1e-5
    y = (want * np.exp(1j * 1.234)).astype(np.complex64)
    blocks = [y[:, :128], y[:, 128:]]
    dem, jdem = linear.dpsk_demodulator(m), jlinear.dpsk_demodulator(m)
    got, _ = tp.run_torch(dem, blocks, (2,))
    want_d, _ = tp.run_jax(jdem, blocks, (2,))
    np.testing.assert_array_equal(got, want_d)
    np.testing.assert_array_equal(got[:, 1:],
                                  np.concatenate(syms, axis=1)[:, 1:])


def test_dpsk_reference_sequence():
    # tests/test_modem.py's golden: the reference modulates 0..M-1 in turn
    import pathlib
    mg = dict(np.load(pathlib.Path(__file__).parent
                      / "golden/modem_golden.npz"))
    for m in (1, 2, 3):
        M = 1 << m
        mod = linear.dpsk_modulator(m)
        y, _ = mod(mod.init(), torch.arange(M))
        assert np.abs(y.numpy() - mg[f"dpsk{M}"]).max() < 1e-5
