"""The support utilities of the PyTorch port against the JAX package on
the same numpy inputs: bits, polynomials, buffers and optimization (host
numpy in both packages: equal, element for element), quantization and the
dense matrices on torch (against the JAX package and the reference's
golden vectors).

Tolerances: quantization 1e-6 absolute plus 1e-5 relative (mu-law's
log1p and pow from two libraries, a last-bit difference that expand
amplifies up to ln(1+mu) (1+mu)^|y| / mu ~ 5.6 times; the ADC's integers
and the DAC's values equal); matrices 1e-5 of the largest
element against the JAX package (LAPACK against XLA's own linear
algebra, both float32), and the golden tolerances of
tests/test_support.py:31-100 against the reference.
"""
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (torch thread cap)

from conftest import assert_close
from liquid_dsp_tpu.utils import bits as jbits
from liquid_dsp_tpu.utils import buffer as jbuffer
from liquid_dsp_tpu.utils import matrix as jmatrix
from liquid_dsp_tpu.utils import optim as joptim
from liquid_dsp_tpu.utils import poly as jpoly
from liquid_dsp_tpu.utils import quantization as jquant
from liquid_dsp_tpu_torch.utils import (bits, buffer, matrix, optim, poly,
                                        quantization)

CPU = dict(device="cpu")


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


# --- bits --------------------------------------------------------------------

_WORDS = [0, 1, 0x80, 0xA5, 0xFFFF, 0x123456, 0xDEADBEEF, 0xFFFFFFFF]


@pytest.mark.parametrize("name", ["count_ones", "count_ones_mod2",
                                  "msb_index", "count_leading_zeros",
                                  "reverse_byte", "reverse_uint16",
                                  "reverse_uint24", "reverse_uint32"])
def test_bit_word_functions_equal(name):
    for w in _WORDS:
        assert getattr(bits, name)(w) == getattr(jbits, name)(w), (name, w)


def test_bit_array_functions_equal():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, 13).astype(np.uint8)
    for fn in ("lbshift", "rbshift", "lbcircshift", "rbcircshift", "lshift",
               "rshift", "lcircshift", "rcircshift"):
        for k in (0, 1, 5, 9, 12):
            np.testing.assert_array_equal(getattr(bits, fn)(src, k),
                                          getattr(jbits, fn)(src, k))
    for bi, bo in ((8, 3), (3, 5), (1, 8), (8, 8), (5, 2)):
        sym = rng.integers(0, 1 << bi, 11).astype(np.uint8)
        np.testing.assert_array_equal(bits.repack_bytes(sym, bi, bo),
                                      jbits.repack_bytes(sym, bi, bo))
    d1, d2 = np.zeros(6, np.uint8), np.zeros(6, np.uint8)
    for k, b, s in ((0, 3, 5), (7, 8, 0xC3), (30, 6, 0x2A), (44, 8, 0xFF)):
        bits.pack_array(d1, k, b, s)
        jbits.pack_array(d2, k, b, s)
        np.testing.assert_array_equal(d1, d2)
        assert bits.unpack_array(d1, k, b) == jbits.unpack_array(d2, k, b)
    np.testing.assert_array_equal(bits.unpack_soft_bits(0x5, 4),
                                  jbits.unpack_soft_bits(0x5, 4))
    assert bits.bdotprod(0xF0F0, 0x3C3C) == jbits.bdotprod(0xF0F0, 0x3C3C)
    assert bits.print_bitstring(37, 9) == jbits.print_bitstring(37, 9)
    assert bits.count_bit_errors(0xAB, 0x54) == \
        jbits.count_bit_errors(0xAB, 0x54)
    b2 = rng.integers(0, 256, 13).astype(np.uint8)
    assert bits.count_bit_errors_array(src, b2) == \
        jbits.count_bit_errors_array(src, b2)


# --- polynomials -------------------------------------------------------------

def test_poly_equal():
    rng = np.random.default_rng(1)
    x = np.linspace(-1, 1, 17)
    y = np.cos(2 * x) + 0.01 * rng.standard_normal(17)
    c = rng.standard_normal(5)
    np.testing.assert_array_equal(poly.poly_val(c, x), jpoly.poly_val(c, x))
    np.testing.assert_array_equal(poly.poly_fit(x, y, 4),
                                  jpoly.poly_fit(x, y, 4))
    np.testing.assert_array_equal(poly.poly_fit_lagrange(x[:6], y[:6]),
                                  jpoly.poly_fit_lagrange(x[:6], y[:6]))
    assert poly.poly_interp_lagrange(x[:6], y[:6], 0.3) == \
        jpoly.poly_interp_lagrange(x[:6], y[:6], 0.3)
    r = [1.0, -2.0, 0.5 + 1j, 0.5 - 1j]
    np.testing.assert_array_equal(poly.poly_expandroots(r),
                                  jpoly.poly_expandroots(r))
    np.testing.assert_array_equal(poly.poly_findroots(c),
                                  jpoly.poly_findroots(c))
    np.testing.assert_array_equal(poly.poly_mul(c, c[:3]),
                                  jpoly.poly_mul(c, c[:3]))


# --- buffers -----------------------------------------------------------------

def test_buffers_equal():
    rng = np.random.default_rng(2)
    xs = (rng.standard_normal(20) + 1j * rng.standard_normal(20)).astype(
        np.complex64)
    w, jw = buffer.Window(7), jbuffer.Window(7)
    c, jc = buffer.CBuffer(12), jbuffer.CBuffer(12)
    d, jd = buffer.WDelay(3), jbuffer.WDelay(3)
    for k, x in enumerate(xs):
        w.push(x)
        jw.push(x)
        np.testing.assert_array_equal(w.read(), jw.read())
        assert d.push(x) == jd.push(x)
        if not c.is_full():
            c.push(x)
            jc.push(x)
        if k % 5 == 4:
            np.testing.assert_array_equal(c.read(3), jc.read(3))
            c.release(3)
            jc.release(3)
            assert c.pop() == jc.pop()
    w.write(xs[:4])
    jw.write(xs[:4])
    np.testing.assert_array_equal(w.read(), jw.read())
    assert w.index(2) == jw.index(2)
    assert c.size() == jc.size() and \
        c.space_available() == jc.space_available()
    with pytest.raises(OverflowError):
        c.write(np.zeros(c.space_available() + 1))
    with pytest.raises(ValueError):
        buffer.Window(0)


# --- optimization ------------------------------------------------------------

@pytest.mark.parametrize("fn", ["rosenbrock", "invgauss", "multimodal",
                                "spiral"])
def test_optim_objectives_equal(fn):
    for v in ([0.3], [0.3, -1.2], [1.0, 1.0, 1.0], [0.1, 0.2, -0.4, 2.0]):
        assert getattr(optim, fn)(v) == getattr(joptim, fn)(v)


def test_optim_searches_equal():
    x, f = optim.gradsearch(joptim.rosenbrock, [-0.5, 0.8], n_iters=40)
    jx, jf = joptim.gradsearch(joptim.rosenbrock, [-0.5, 0.8], n_iters=40)
    np.testing.assert_array_equal(x, jx)
    assert f == jf
    x, f = optim.qnsearch(joptim.invgauss, [0.2, 0.4], n_iters=20)
    jx, jf = joptim.qnsearch(joptim.invgauss, [0.2, 0.4], n_iters=20)
    np.testing.assert_array_equal(x, jx)
    assert f == jf


@pytest.mark.parametrize("seed", [0, 7])
def test_gasearch_same_seed_same_result(seed):
    kw = dict(n_iters=12, population=16, seed=seed)
    x, f = optim.gasearch(joptim.multimodal, [(-2, 2), (-2, 2)], **kw)
    jx, jf = joptim.gasearch(joptim.multimodal, [(-2, 2), (-2, 2)], **kw)
    np.testing.assert_array_equal(x, jx)
    assert f == jf

    def u(c):
        return joptim.rosenbrock(c.values_f() * 4 - 2)

    c, f = optim.gasearch_chromosome(u, [8, 8], n_iters=8, population=12,
                                     seed=seed)
    jc, jf = joptim.gasearch_chromosome(u, [8, 8], n_iters=8,
                                        population=12, seed=seed)
    np.testing.assert_array_equal(c.traits, jc.traits)
    assert f == jf and repr(c) == repr(jc)


def test_chromosome_equal():
    a = optim.Chromosome([3, 5, 8], rng=np.random.default_rng(4))
    ja = joptim.Chromosome([3, 5, 8], rng=np.random.default_rng(4))
    a.init_random()
    ja.init_random()
    np.testing.assert_array_equal(a.traits, ja.traits)
    b, jb = a.clone(), ja.clone()
    b.initf([0.1, 0.9, 1.0])
    jb.initf([0.1, 0.9, 1.0])
    for k in (0, 4, 15):
        b.mutate(k)
        jb.mutate(k)
    c, jc = a.clone(), ja.clone()
    c.crossover(a, b, 6)
    jc.crossover(ja, jb, 6)
    np.testing.assert_array_equal(c.traits, jc.traits)
    np.testing.assert_array_equal(c.values_f(), jc.values_f())
    assert repr(c) == repr(jc)


# --- quantization ------------------------------------------------------------

def test_quantization_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, 257).astype(np.float32)
    z = (x + 1j * rng.uniform(-1, 1, 257)).astype(np.complex64)
    z[3] = 0
    for mu in (255.0, 87.6):
        for fn in ("compress_mulaw", "expand_mulaw"):
            np.testing.assert_allclose(
                _np(getattr(quantization, fn)(x, mu, **CPU)),
                np.asarray(getattr(jquant, fn)(x, mu)), atol=1e-6, rtol=1e-5)
        for fn in ("compress_cf_mulaw", "expand_cf_mulaw"):
            got = _np(getattr(quantization, fn)(z, mu, **CPU))
            assert got.dtype == np.complex64
            np.testing.assert_allclose(
                got, np.asarray(getattr(jquant, fn)(z, mu)), atol=1e-6,
                rtol=1e-5)
    for b in (1, 4, 8, 12):
        q = quantization.quantize_adc(x, b, **CPU)
        assert q.dtype == torch.int32
        np.testing.assert_array_equal(q.numpy(),
                                      np.asarray(jquant.quantize_adc(x, b)))
        np.testing.assert_array_equal(
            quantization.quantize_dac(q, b).numpy(),
            np.asarray(jquant.quantize_dac(q.numpy(), b)))
    # a tensor stays where it lies; host arrays go to the card by default
    t = torch.from_numpy(x)
    assert quantization.compress_mulaw(t).device == t.device
    with pytest.raises(RuntimeError, match="CUDA card"):
        quantization.quantize_adc(x, 8)
    with pytest.raises(ValueError):
        quantization.compress_mulaw(0.5, -1.0, **CPU)
    with pytest.raises(ValueError):
        quantization.quantize_dac([1], 33, **CPU)


# --- matrices ----------------------------------------------------------------

def _sq(v):
    n = int(round(np.sqrt(len(v))))
    return v.reshape(n, n)


@pytest.mark.parametrize("t", ["matrixf", "matrixcf"])
def test_matrix_goldens(golden, t):
    d = golden(f"{t}_data_add")
    assert_close(_np(matrix.matrix_add(d["x"], d["y"], **CPU)), d["z"],
                 tol=1e-4)
    d = golden(f"{t}_data_mul")
    z = matrix.matrix_mul(d["x"].reshape(5, 4), d["y"].reshape(4, 3), **CPU)
    assert_close(_np(z).reshape(-1), d["z"], tol=1e-3)
    d = golden(f"{t}_data_aug")
    z = matrix.matrix_aug(d["x"].reshape(5, 4), d["y"].reshape(5, 3), **CPU)
    assert_close(_np(z).reshape(-1), d["z"], tol=1e-5)
    d = golden(f"{t}_data_inv")
    assert_close(_np(matrix.matrix_inv(_sq(d["x"]), **CPU)).reshape(-1),
                 d["y"], tol=1e-2)
    d = golden(f"{t}_data_linsolve")
    assert_close(_np(matrix.matrix_linsolve(_sq(d["A"]), d["b"], **CPU)),
                 d["x"], tol=1e-2)
    d = golden(f"{t}_data_chol")
    assert_close(_np(matrix.matrix_chol(_sq(d["A"]), **CPU)).reshape(-1),
                 d["L"], tol=1e-3)
    d = golden(f"{t}_data_ludecomp")
    A = _sq(d["A"])
    L, U = matrix.matrix_ludecomp(A)
    assert_close(L @ U, A, tol=1e-3)
    assert np.allclose(np.tril(L), L) and np.allclose(np.triu(U), U)
    d = golden(f"{t}_data_transmul")
    x = d["x"].reshape(5, 4)
    # the reference's naming: its transpose_mul (xTx) is A^H A
    assert_close(_np(matrix.matrix_transmul(x, **CPU)).reshape(-1),
                 d["xTx"], tol=1e-3)
    assert_close(_np(matrix.matrix_multrans(x, **CPU)).reshape(-1),
                 d["xxT"], tol=1e-3)


def test_matrix_real_goldens(golden):
    d = golden("matrixf_data_cgsolve")
    assert_close(_np(matrix.matrix_cgsolve(_sq(d["A"]), d["b"], **CPU)),
                 d["x"], tol=1e-2)
    d = golden("matrixf_data_qrdecomp")
    A = _sq(d["A"])
    Q, R = matrix.matrix_qrdecomp(A, **CPU)
    assert_close(_np(Q @ R), A, tol=1e-3)
    # the reference's own signs, not only their magnitudes
    assert_close(_np(Q).reshape(-1), d["Q"], tol=1e-2)
    assert_close(_np(R).reshape(-1), d["R"], tol=1e-2)
    d = golden("matrixf_data_gramschmidt")
    V = matrix.matrix_gramschmidt(d["A"].reshape(4, 3), **CPU)
    assert_close(_np(V).reshape(-1), d["V"], tol=1e-3)


def _close(a, b, tol=1e-5):
    a, b = _np(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1.0)


@pytest.mark.parametrize("cplx", [False, True])
def test_matrix_matches_jax(cplx):
    rng = np.random.default_rng(6)

    def m(r, c):
        a = rng.standard_normal((r, c))
        if cplx:
            a = a + 1j * rng.standard_normal((r, c))
        return a.astype(np.complex64 if cplx else np.float32)

    A, B, X = m(5, 5), m(5, 5), m(5, 3)
    S = (A @ A.conj().T + 5 * np.eye(5)).astype(A.dtype)     # SPD / HPD
    for name, args in (("matrix_add", (A, B)), ("matrix_sub", (A, B)),
                       ("matrix_mul", (A, X)), ("matrix_aug", (A, X)),
                       ("matrix_trans", (X,)), ("matrix_hermitian", (X,)),
                       ("matrix_transmul", (X,)), ("matrix_multrans", (X,)),
                       ("matrix_inv", (S,)), ("matrix_linsolve", (S, X)),
                       ("matrix_chol", (S,)), ("matrix_qrdecomp", (A,)),
                       ("matrix_gramschmidt", (X,))):
        got = getattr(matrix, name)(*args, **CPU)
        want = getattr(jmatrix, name)(*args)
        if isinstance(want, tuple):
            for g, w in zip(got, want):
                _close(g, w)
        else:
            _close(got, want)
    L, U = matrix.matrix_ludecomp(S)
    jL, jU = jmatrix.matrix_ludecomp(S)
    _close(L, jL)
    _close(U, jU)
    if not cplx:
        _close(matrix.matrix_cgsolve(S, X[:, 0], **CPU),
               jmatrix.matrix_cgsolve(S, X[:, 0]), tol=1e-4)


def test_matrix_device_rule_and_no_tf32():
    a = torch.randn(4, 4)
    assert matrix.matrix_mul(a, a).device == a.device
    with pytest.raises(RuntimeError, match="CUDA card"):
        matrix.matrix_inv(np.eye(3))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with matrix._full_f32():
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_smatrix_equal():
    s, js = matrix.SMatrix(4, 5), jmatrix.SMatrix(4, 5)
    for (i, j, v) in ((1, 2, 3.0), (3, 4, -1.5), (0, 0, 2.0), (1, 2, 0)):
        s.set(i, j, v)
        js.set(i, j, v)
    np.testing.assert_array_equal(s.todense(), js.todense())
    t, jt = matrix.SMatrix(5, 3), jmatrix.SMatrix(5, 3)
    t.set(4, 1, 2.0)
    jt.set(4, 1, 2.0)
    np.testing.assert_array_equal(s.mul(t).todense(), js.mul(jt).todense())
    x = np.arange(5, dtype=np.float32)
    np.testing.assert_array_equal(s.vmul(x), js.vmul(x))
    np.testing.assert_array_equal(s.vmulf(x), js.vmulf(x))
    np.testing.assert_array_equal(s.mulf(t), js.mulf(jt))
    with pytest.raises(IndexError):
        s.set(4, 0, 1.0)
