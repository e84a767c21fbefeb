"""The scan's real coefficients on a complex stream's planes (`ops/iir.py`:
`iir_apply_sos`, `iir_apply_tf` and the Procs on them): the `iir_scan`
wrapper takes the stream's two float planes as float32 rows with float32
coefficients, complex coefficients keep complex64 rows, and the results
match the JAX package's scan.

Tolerance: 1e-5 of max|ref|, y and carry (`test_torch_iir.py`'s bound for
the port's scan against the JAX scan: the same float32 recurrence).  The
planes and the complex rows of the same real coefficients give the same
values: a product by a zero imaginary part is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as tp
from liquid_dsp_tpu.design.iirdes import iirdes, iirdes_sos
from liquid_dsp_tpu.ops import iir as J
from liquid_dsp_tpu_torch.ops import iir as P

RTOL = 1e-5
SOS = [("butter", 3, 0.2), ("butter", 5, 0.2), ("butter", 7, 0.2),
       ("butter", 24, 0.2)]          # the last: 12 sections
LENGTHS = (600, 424)                 # two carried blocks, 1024 samples


def _close_rel(y, ref, what=""):
    y, ref = np.asarray(y), np.asarray(ref)
    assert y.shape == ref.shape and np.isfinite(y).all(), what
    err = float(np.abs(y - ref).max() / np.abs(ref).max())
    assert err <= RTOL, f"{what}: max|err| / max|ref| {err:.3e} > {RTOL:.0e}"


@pytest.fixture
def scan_calls(monkeypatch):
    """The rows, dtype and coefficients' dtype of each `iir_scan` call
    that `ops/iir.py` makes."""
    calls, kernel = [], P.iir_scan

    def rec(x, b, a, s):
        calls.append((tuple(x.shape), x.dtype, b.dtype, a.dtype, s.dtype))
        return kernel(x, b, a, s)

    monkeypatch.setattr(P, "iir_scan", rec)
    return calls


def _blocks(seed, rows):
    x = tp.cnoise(np.random.default_rng(seed), (rows, sum(LENGTHS)))
    return np.split(x, [LENGTHS[0]], axis=1)


def _both(port_fn, jax_fn, coefs, carry, blocks):
    """Port and JAX function over the carried blocks from `carry`:
    (y, carry) of each."""
    ct, cj = torch.from_numpy(carry), jnp.asarray(carry)
    yt, yj = [], []
    for xb in blocks:
        y, ct = port_fn(*(torch.from_numpy(c) for c in coefs), ct,
                        torch.from_numpy(xb))
        yt.append(y)
        y, cj = jax_fn(*(jnp.asarray(c) for c in coefs), cj, jnp.asarray(xb))
        yj.append(np.asarray(y))
    return (torch.cat(yt, -1), ct), (np.concatenate(yj, -1), np.asarray(cj))


@pytest.mark.parametrize("design", SOS)
def test_sos_real_coefficients_run_on_the_planes(design, scan_calls):
    B, A = (c.astype(np.float32) for c in iirdes_sos(*design))
    ns = B.shape[0]
    carry = tp.cnoise(np.random.default_rng(ns), (3, ns, 2)) * np.float32(0.1)
    (yt, ct), (yj, cj) = _both(P.iir_apply_sos, jax.jit(J.iir_apply_sos),
                               (B, A), carry, _blocks(ns, 3))
    assert scan_calls == [((6, n), torch.float32, torch.float32,
                           torch.float32, torch.float32) for n in LENGTHS]
    assert yt.dtype == ct.dtype == torch.complex64
    assert ct.shape == (3, ns, 2)
    _close_rel(yt.numpy(), yj, "y")
    _close_rel(ct.numpy(), cj, "carry")


@pytest.mark.parametrize("order", [3, 5, 7])
def test_tf_real_coefficients_run_on_the_planes(order, scan_calls):
    b, a = (c.astype(np.float32) for c in iirdes("butter", order, 0.2))
    carry = tp.cnoise(np.random.default_rng(order), (3, order)) \
        * np.float32(0.1)
    (yt, ct), (yj, cj) = _both(P.iir_apply_tf, jax.jit(J.iir_apply_tf),
                               (b, a), carry, _blocks(order + 10, 3))
    assert scan_calls == [((6, n), torch.float32, torch.float32,
                           torch.float32, torch.float32) for n in LENGTHS]
    assert yt.dtype == ct.dtype == torch.complex64 and ct.shape == (3, order)
    _close_rel(yt.numpy(), yj, "y")
    _close_rel(ct.numpy(), cj, "carry")


@pytest.mark.parametrize("form", ["sos", "tf"])
def test_the_procs_scan_runs_on_the_planes(form, scan_calls):
    # iirfilt_sos / iirfilt(backend="scan") on a complex block: float32
    # rows, and the JAX package's Proc within the bound
    make = {"sos": (J.iirfilt_sos, P.iirfilt_sos, iirdes_sos),
            "tf": (J.iirfilt, P.iirfilt, iirdes)}[form]
    coefs = make[2]("butter", 7, 0.2)
    blocks = _blocks(7, 2)
    yj, cj = tp.run_jax(make[0](*coefs, backend="scan"), blocks, (2,))
    yt, ct = tp.run_torch(make[1](*coefs, backend="scan"), blocks, (2,))
    assert [c[:2] for c in scan_calls] == [((4, n), torch.float32)
                                           for n in LENGTHS]
    _close_rel(yt, yj, "y")
    _close_rel(ct.numpy(), np.asarray(cj), "carry")


@pytest.mark.parametrize("design", SOS)
def test_planes_equal_the_complex_rows(design):
    # the parent's route (the real coefficients cast to complex64, the
    # stream as complex rows) and the planes give equal values, y and carry
    B, A = (torch.from_numpy(c.astype(np.float32))
            for c in iirdes_sos(*design))
    x = torch.from_numpy(tp.cnoise(np.random.default_rng(3), (2, 500)))
    s = torch.from_numpy(tp.cnoise(np.random.default_rng(4),
                                   (2, B.shape[0], 2)))
    y, st = P.iir_apply_sos(B, A, s, x)
    yc, sc = P._scan(B.to(torch.complex64), A.to(torch.complex64), s, x)
    assert torch.equal(y, yc) and torch.equal(st, sc)


def test_complex_coefficients_keep_complex_rows(scan_calls):
    # butter 5 shifted by 0.6 rad/sample: complex64 rows and coefficients,
    # against the JAX package's scan
    B, A = iirdes_sos("butter", 5, 0.1)
    rot = np.exp(0.6j * np.arange(3))
    B, A = (B * rot).astype(np.complex64), (A * rot).astype(np.complex64)
    carry = np.zeros((3, B.shape[0], 2), np.complex64)
    (yt, ct), (yj, cj) = _both(P.iir_apply_sos, jax.jit(J.iir_apply_sos),
                               (B, A), carry, _blocks(5, 3))
    assert scan_calls == [((3, n), torch.complex64, torch.complex64,
                           torch.complex64, torch.complex64)
                          for n in LENGTHS]
    _close_rel(yt.numpy(), yj, "y")
    _close_rel(ct.numpy(), cj, "carry")
