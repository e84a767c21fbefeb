"""The CVSD codec of the PyTorch port (`utils/audio.py` on the
`cvsd_scan` kernel's plain version) against the compiled reference's
golden vectors and the JAX package, and the kernel's per-thread order
walked in numpy.

Tolerances: the encoder's bits equal, everywhere.  The decoder's audio is
bit-equal to the JAX package's: both take XLA's CPU roundings (delta/zeta
as a product by the float32 1/zeta, -xt - a1*yt as one fused multiply-
add); against the reference's golden audio 1e-4 (tests/test_support.py:
410-427).  The numpy walk of `csrc/cvsd_scan.cu` (one thread's loop over
its row in float32, the fused multiply-add rounded once, exactly) equals
`cvsd_scan_reference` bit for bit.

Change the kernel's arithmetic only together with its walk here.
"""
import pathlib
from fractions import Fraction

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (torch thread cap)
from liquid_dsp_tpu.utils import audio as jaudio
from liquid_dsp_tpu_torch.ops.kernels.cvsd_scan import (cvsd_consts,
                                                        cvsd_scan,
                                                        cvsd_scan_reference)
from liquid_dsp_tpu_torch.utils.audio import cvsd_decode, cvsd_encode

F32 = np.float32
GOLDEN = pathlib.Path(__file__).parent / "golden" / "flexframe_golden.npz"
CPU = dict(device="cpu")


def _audio(T, seed, amp=0.6):
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    x = (amp * np.sin(2 * np.pi * 0.004 * t) + 0.25 * amp
         * np.sin(2 * np.pi * 0.031 * t + 1.0)
         + 0.02 * rng.standard_normal(T))
    return np.clip(x, -1, 1).astype(F32)


def test_golden():
    g = dict(np.load(GOLDEN))
    x = np.real(g["cvsd_x"]).astype(F32)
    bits_ref = np.real(g["cvsd_bits"]).astype(np.int32)
    xr_ref = np.real(g["cvsd_xr"]).astype(F32)
    bits = cvsd_encode(x, **CPU)
    assert bits.dtype == np.uint8 and bits.shape == x.shape
    np.testing.assert_array_equal(bits.astype(np.int32), bits_ref)
    audio = cvsd_decode(bits_ref, **CPU)
    assert audio.dtype == np.float32
    assert np.abs(audio - xr_ref).max() < 1e-4


@pytest.mark.parametrize("num_bits,zeta,alpha", [
    (3, 1.5, 0.95), (2, 1.5, 0.95), (3, 1.7, 0.95), (4, 1.3, 0.9),
    (1, 2.0, 0.5), (5, 1.1, 0.0)])
def test_matches_jax_bit_for_bit(num_bits, zeta, alpha):
    # zeta other than 1.5 keeps delta off its clamps: there a division
    # and a product by the reciprocal round apart (the JAX scan takes the
    # product)
    x = _audio(2048, num_bits)
    kw = dict(num_bits=num_bits, zeta=zeta, alpha=alpha)
    bits = cvsd_encode(x, **kw, **CPU)
    jbits = np.asarray(jaudio.cvsd_encode(x, **kw))
    np.testing.assert_array_equal(bits, jbits)
    np.testing.assert_array_equal(cvsd_decode(jbits, **kw, **CPU),
                                  np.asarray(jaudio.cvsd_decode(jbits, **kw)))


def test_decode_of_any_bits_matches_jax():
    # random bits, not an encoder's: delta wanders over its whole range
    b = np.random.default_rng(9).integers(0, 2, 3000).astype(np.int32)
    for zeta in (1.5, 1.37):
        np.testing.assert_array_equal(
            cvsd_decode(b, zeta=zeta, **CPU),
            np.asarray(jaudio.cvsd_decode(b, zeta=zeta)))


def test_parameters_and_shapes_raise_as_jax_does():
    with pytest.raises(ValueError, match="num_bits"):
        cvsd_encode(np.zeros(8), num_bits=0, **CPU)
    with pytest.raises(ValueError, match="zeta"):
        cvsd_decode(np.zeros(8), zeta=1.0, **CPU)
    with pytest.raises(ValueError, match="1-D"):
        cvsd_encode(np.zeros((2, 8)), **CPU)
    with pytest.raises(RuntimeError, match="CUDA card"):
        cvsd_encode(np.zeros(8))
    assert cvsd_encode(np.zeros(0), **CPU).shape == (0,)
    # a tensor is coded where it lies
    assert cvsd_decode(torch.zeros(5, dtype=torch.uint8)).shape == (5,)


def test_rows_are_independent_streams():
    # the wrapper's [R, T] form: each row is its own stream from a fresh
    # state, as one-row calls are
    xs = np.stack([_audio(700, s) for s in range(5)])
    bits = cvsd_scan(torch.from_numpy(xs), True)
    out = cvsd_scan(bits, False)
    out32 = cvsd_scan(bits.to(torch.int32), False)
    assert bits.dtype == torch.uint8 and out.dtype == torch.float32
    assert torch.equal(out, out32)
    for r in range(5):
        np.testing.assert_array_equal(bits[r].numpy(),
                                      cvsd_encode(xs[r], **CPU))
        np.testing.assert_array_equal(out[r].numpy(),
                                      cvsd_decode(bits[r].numpy(), **CPU))
    with pytest.raises(ValueError, match="decode takes"):
        cvsd_scan(torch.zeros(2, 4), False)
    with pytest.raises(ValueError, match="encode takes"):
        cvsd_scan(torch.zeros(4), True)


# --- the kernel's per-thread order in numpy ----------------------------------

def _round32(q: Fraction) -> F32:
    """The float32 nearest to the rational q, ties to even."""
    f = F32(float(q))
    best = f
    for c in (np.nextafter(f, F32(-np.inf)), np.nextafter(f, F32(np.inf))):
        dc, db = abs(Fraction(float(c)) - q), abs(Fraction(float(best)) - q)
        if dc < db or (dc == db and int(c.view(np.uint32)) % 2 == 0):
            best = c
    return F32(best)


def fma_exact(a, b, c) -> F32:
    """a*b + c rounded once to float32 (__fmaf_rn)."""
    return _round32(Fraction(float(a)) * Fraction(float(b))
                    + Fraction(float(c)))


def kernel_walk(x, encode, num_bits=3, zeta=1.5, alpha=0.95):
    """One thread of csrc/cvsd_scan.cu over its row, in float32 numpy:
    slope() then, for decode, the post-emphasis, each operation rounded
    once (fminf(fmaxf(.)) the clamps)."""
    mask, z, rz, al, na1, na2 = (F32(v) if i else v for i, v in
                                 enumerate(cvsd_consts(num_bits, zeta,
                                                       alpha)))
    ref, delta, bitref, prev = F32(0), F32(0.01), 0, F32(0)
    v0 = v1 = F32(0)
    out = []
    for xt in x:
        if encode:
            y = F32(F32(xt) - F32(al * prev))
            prev = F32(xt)
            bit = 1 if ref <= y else 0
        else:
            bit = int(xt) & 0xFFFFFFFF
        bitref = ((bitref << 1) | bit) & mask
        agree = bitref in (0, mask)
        delta = F32(delta * (z if agree else rz))
        delta = min(max(delta, F32(0.01)), F32(1.0))
        ref = F32(ref + (delta if bit == 1 else -delta))
        ref = min(max(ref, F32(-1.0)), F32(1.0))
        if encode:
            out.append(bit)
            continue
        yt = F32(ref + v0)
        v0, v1 = F32(fma_exact(na1, yt, -ref) + v1), F32(na2 * yt)
        out.append(yt)
    return np.array(out, np.uint8 if encode else F32)


@pytest.mark.parametrize("zeta", [1.5, 1.37])
def test_kernel_walk_bit_equal_to_plain(zeta):
    x = _audio(1500, 3)
    bits = cvsd_scan_reference(torch.from_numpy(x)[None], True, zeta=zeta)
    np.testing.assert_array_equal(bits[0].numpy(),
                                  kernel_walk(x, True, zeta=zeta))
    b = bits[0].numpy()
    audio = cvsd_scan_reference(bits, False, zeta=zeta)
    np.testing.assert_array_equal(audio[0].numpy(),
                                  kernel_walk(b, False, zeta=zeta))


def test_the_fma_is_what_makes_the_decoder_equal():
    # the same walk with -xt - a1*yt rounded twice misses the JAX
    # package's audio: the kernel's FMA is the contraction XLA makes
    b = np.asarray(jaudio.cvsd_encode(_audio(1500, 4)))
    want = np.asarray(jaudio.cvsd_decode(b))
    np.testing.assert_array_equal(kernel_walk(b, False), want)
    global fma_exact
    exact = fma_exact
    fma_exact = lambda a, c, d: F32(F32(a * c) + d)  # noqa: E731
    try:
        assert not np.array_equal(kernel_walk(b, False), want)
    finally:
        fma_exact = exact
