"""Port parity: the linear modems of liquid_dsp_tpu_torch against the JAX
package.  The tables are the same numpy construction (equal); modulate
and hard demodulate pick table entries (equal); the max-log LLRs are f32
distance differences computed the same way (1e-6)."""
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
