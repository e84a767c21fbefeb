"""The CVSD codec of the PyTorch port (`utils/audio.py` on the
`cvsd_scan` kernel's plain version) against the compiled reference's
golden vectors and the JAX package, and the kernel's per-thread order
walked in numpy.

Tolerances: the encoder's bits equal, everywhere.  The decoder's audio is
bit-equal to the JAX package's: both take XLA's CPU roundings (delta/zeta
as a product by the float32 1/zeta, -xt - a1*yt as one fused multiply-
add); against the reference's golden audio 1e-4 (tests/test_support.py:
410-427).  The numpy walk of `csrc/cvsd_scan.cu` (its copy warp's work on
each half tile and its chain warp's steps over a row, in float32, the
fused multiply-add rounded once, exactly) equals `cvsd_scan_reference`
and the JAX package bit for bit, at the clamps too; the identities it
rests on (encode's candidates selected by the bit, decode's bitref from
ballots of the bytes' bit planes) are tested on their own.

Change the kernel's arithmetic or its order only together with its walk
here.
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


HALF = 32       # samples of a half tile, a lane each (csrc/cvsd_scan.cu)
U32 = 0xFFFFFFFF


def _walk_consts(num_bits, zeta, alpha):
    mask, z, rz, al, na1, na2 = cvsd_consts(num_bits, zeta, alpha)
    return mask, F32(z), F32(rz), F32(al), F32(na1), F32(na2)


def prepare_tile(b, carry, mask):
    """The decode copy warp on one half tile of bytes b (up to 32, a lane
    a sample): bitref of every sample from one ballot per bit plane, each
    reversed and shifted to the lane, and the bitref carried from the last
    half tile; the planes below num_bits (at most 8) where a byte is more than
    a bit, else plane 0 alone.  The new carry is every lane's: the planes'
    reversed ballots, shifted by the plane.  Returns (bitrefs, carry)."""
    lanes = list(b) + [0] * (HALF - len(b))
    planes = min(bin(mask).count("1"), 8) if max(lanes) > 1 else 1
    rec, last = [0] * HALF, 0
    for q in range(planes):
        ballot = sum(((v >> q) & 1) << u for u, v in enumerate(lanes))
        brev = int(f"{ballot:032b}"[::-1], 2)
        last |= (brev << q) & U32
        for u in range(HALF):
            rec[u] |= ((brev >> (31 - u)) << q) & U32
    bitrefs = [((((carry << u) << 1) & U32) | rec[u]) & mask
               for u in range(HALF)]
    return bitrefs[:len(b)], last & mask


def candidates(ref, delta, a1, a0, z, rz):
    """Encode's two outcomes of a step before its bit: (r1, d1, r0, d0),
    each clamp that can bind (dz = min(delta*z, 1), dr = max(delta/z,
    0.01), r1 = min(ref + d1, 1), r0 = max(ref - d0, -1))."""
    dz = min(F32(delta * z), F32(1.0))
    dr = max(F32(delta * rz), F32(0.01))
    d1, d0 = (dz if a1 else dr), (dz if a0 else dr)
    return (min(F32(ref + d1), F32(1.0)), d1,
            max(F32(ref - d0), F32(-1.0)), d0)


def select(bit, cands, hist, mask):
    """The bit's choice among the candidates, and the next step's agree
    after a 1 and after a 0 from the history before this bit (its low
    num_bits - 2 bits; with num_bits 1 both always, as the kernel's own
    instance for it takes them).  Returns (ref, delta, hist, a1, a0)."""
    r1, d1, r0, d0 = cands
    m2, one = mask >> 2, mask == 1
    h = hist & m2
    hist = ((hist << 1) | bit) & U32
    if bit:
        return r1, d1, hist, h == m2, one
    return r0, d0, hist, one, h == 0


def kernel_walk(x, encode, num_bits=3, zeta=1.5, alpha=0.95, seen=None):
    """csrc/cvsd_scan.cu over one row, half tile by half tile, in float32
    numpy.  Encode: the copy warp's pre-emphasis, then the chain's
    candidates and the compare's select, and each half tile's bits from
    the history word.  Decode: the copy warp's factor and sign of each
    step from the bytes (`prepare_tile`), then the chain's three float
    chains, each operation rounded once (fminf(fmaxf(.)) the clamps, the
    FMA exact).  `seen`, a set, collects which clamps the state reached."""
    mask, z, rz, al, na1, na2 = _walk_consts(num_bits, zeta, alpha)
    ref, delta = F32(0), F32(0.01)
    out = []

    def note():
        if seen is not None:
            seen.update(name for name, hit in (
                ("ref 1", ref == 1), ("ref -1", ref == -1),
                ("delta 1", delta == 1), ("delta 0.01", delta == F32(0.01)))
                if hit)
    if encode:
        xlast, hist, a1, a0 = F32(0), 0, mask == 1, True
        for t0 in range(0, len(x), HALF):
            xs = [F32(v) for v in x[t0:t0 + HALF]]
            ys = [F32(v - F32(al * p))
                  for v, p in zip(xs, [xlast] + xs[:-1])]
            xlast = xs[-1]
            for y in ys:
                bit = 1 if ref <= y else 0
                ref, delta, hist, a1, a0 = select(
                    bit, candidates(ref, delta, a1, a0, z, rz), hist, mask)
                note()
            # the tile's bits are the history's last ones, a byte a lane
            n = len(ys)
            out += [(hist >> (n - 1 - u)) & 1 for u in range(n)]
        return np.array(out, np.uint8)
    v0 = v1 = F32(0)
    carry = 0
    for t0 in range(0, len(x), HALF):
        b = [int(v) & 0xFF for v in x[t0:t0 + HALF]]
        bitrefs, carry = prepare_tile(b, carry, mask)
        for bv, br in zip(b, bitrefs):
            k = z if br in (0, mask) else rz
            s = F32(1.0) if bv == 1 else F32(-1.0)
            delta = min(max(F32(delta * k), F32(0.01)), F32(1.0))
            ref = min(max(F32(ref + F32(s * delta)), F32(-1.0)), F32(1.0))
            note()
            yt = F32(ref + v0)
            v0, v1 = F32(fma_exact(na1, yt, -ref) + v1), F32(na2 * yt)
            out.append(yt)
    return np.array(out, F32)


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


# --- the redesign's identities ----------------------------------------------

def _pinning_audio(seed, run=600):
    """Voice-like audio with stretches that pin the encoder's state: a
    steep ramp up and one down (y far above or below ref: ref at +1 or -1,
    delta grows to 1) and silence (the bits alternate: delta falls to
    0.01); runs long enough for zeta 1.01."""
    return np.concatenate([
        _audio(300, seed), 40.0 * np.arange(run, dtype=F32),
        -40.0 * np.arange(run, dtype=F32), np.zeros(run, F32),
        _audio(333, seed + 1)]).astype(F32)


def _pinning_bits(seed, run=600):
    """Random bits with a run of ones, a run of zeros and an alternation,
    each long enough to pin ref or delta at zeta 1.01."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.integers(0, 2, 200), np.ones(run), np.zeros(run),
        np.tile([0, 1], run // 2), rng.integers(0, 2, 217)]).astype(np.uint8)


@pytest.mark.parametrize("zeta", [1.5, 1.37, 1.01])
@pytest.mark.parametrize("num_bits", [1, 2, 3, 5, 8])
def test_kernel_walk_at_the_clamps(num_bits, zeta):
    # the walk, the plain version and the JAX package bit-equal where the
    # dropped clamps sit: ref at +-1 and delta at 0.01 and 1, both ways
    # (with num_bits 1 every step agrees: delta only grows)
    kw = dict(num_bits=num_bits, zeta=zeta)
    clamps = {"ref 1", "ref -1", "delta 1"} | (
        {"delta 0.01"} if num_bits > 1 else set())
    x = _pinning_audio(num_bits)
    seen = set()
    bits = kernel_walk(x, True, seen=seen, **kw)
    assert seen == clamps
    np.testing.assert_array_equal(bits, cvsd_scan_reference(
        torch.from_numpy(x)[None], True, **kw)[0].numpy())
    np.testing.assert_array_equal(bits, np.asarray(jaudio.cvsd_encode(x, **kw)))
    b = _pinning_bits(num_bits)
    seen = set()
    audio = kernel_walk(b, False, seen=seen, **kw)
    assert seen == clamps
    np.testing.assert_array_equal(audio, cvsd_scan_reference(
        torch.from_numpy(b)[None], False, **kw)[0].numpy())
    np.testing.assert_array_equal(audio,
                                  np.asarray(jaudio.cvsd_decode(b, **kw)))


@pytest.mark.parametrize("num_bits", [1, 2, 3, 5, 8])
def test_selected_candidate_is_the_jax_step(num_bits):
    # for every bitref in 0..mask and both bits, from states at the clamps
    # and off them (a run of ones, of zeros, an alternation, then bitref's
    # own bits, then the bit): the candidate the bit selects, through the
    # post-emphasis, is the JAX decoder's output at every step, and the
    # agrees resolved a step early are those of the bitref they stand for
    mask = (1 << num_bits) - 1
    seq = []
    for prefix in ([1] * 24, [0] * 24, [0, 1] * 12):
        for br in range(mask + 1):
            for bit in (0, 1):
                seq += prefix + [(br >> j) & 1
                                 for j in reversed(range(num_bits))] + [bit]
    mask_, z, rz, _, na1, na2 = _walk_consts(num_bits, 1.37, 0.95)
    ref, delta, hist, a1, a0 = F32(0), F32(0.01), 0, mask == 1, True
    bitref, v0, v1, out = 0, F32(0), F32(0), []
    for bit in seq:
        assert a1 == (((bitref << 1) | 1) & mask in (0, mask))
        assert a0 == ((bitref << 1) & mask in (0, mask))
        bitref = ((bitref << 1) | bit) & mask
        ref, delta, hist, a1, a0 = select(
            bit, candidates(ref, delta, a1, a0, z, rz), hist, mask)
        yt = F32(ref + v0)
        v0, v1 = F32(fma_exact(na1, yt, -ref) + v1), F32(na2 * yt)
        out.append(yt)
    want = np.asarray(jaudio.cvsd_decode(np.array(seq), num_bits=num_bits,
                                         zeta=1.37))
    np.testing.assert_array_equal(np.array(out, F32), want)


def test_decode_of_bytes_other_than_0_and_1():
    # a byte is shifted into bitref whole and only a 1 adds delta, in the
    # JAX scan, the plain version and the walk's ballot planes alike
    b = np.random.default_rng(5).choice(
        np.array([0, 1, 1, 0, 2, 3, 128, 255], np.uint8), 700)
    for num_bits in (1, 3, 9):
        walk = kernel_walk(b, False, num_bits=num_bits)
        np.testing.assert_array_equal(walk, cvsd_scan_reference(
            torch.from_numpy(b)[None], False, num_bits=num_bits)[0].numpy())
        np.testing.assert_array_equal(walk, np.asarray(
            jaudio.cvsd_decode(b, num_bits=num_bits)))


@pytest.mark.parametrize("num_bits", [1, 2, 3, 8, 9, 31])
def test_ballot_planes_give_the_serial_bitref(num_bits):
    # the decode copy warp's bitref, a half tile at a time from ballots and
    # the carry, equals ((bitref << 1) | b) & mask sample by sample, for any
    # bytes, a ragged last tile and masks past the 8 planes of a byte
    mask = (1 << num_bits) - 1
    rng = np.random.default_rng(num_bits)
    b = np.where(rng.random(1000) < 0.8, rng.integers(0, 2, 1000),
                 rng.integers(0, 256, 1000))
    want, bitref = [], 0
    for v in b:
        bitref = ((bitref << 1) | int(v)) & mask
        want.append(bitref)
    got, carry = [], 0
    for t0 in range(0, len(b), HALF):
        refs, carry = prepare_tile([int(v) for v in b[t0:t0 + HALF]], carry,
                                   mask)
        got += refs
    assert got == want
