"""Port parity: the plain version of the codebook_argmax kernel (what a CPU
tensor runs) equals the JAX package's Pallas kernel in interpret mode and
numpy's argmax, exactly, on the shapes and the tie case of the reference
test (tests/test_fec_device.py TestPallasCodebookArgmax)."""
import zlib

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (torch thread cap)
import jax.numpy as jnp
from liquid_dsp_tpu.fec.device import _scores_argmax as j_scores_argmax
from liquid_dsp_tpu.ops.kernels.pallas_codebook import (
    codebook_argmax as j_codebook_argmax)
from liquid_dsp_tpu_torch.fec.device import _scores_argmax, block_codebook
from liquid_dsp_tpu_torch.ops.kernels import codebook_argmax as cba


@pytest.mark.parametrize("scheme", ["golay2412", "hamming1511"])
def test_matches_jax_interpret_and_numpy(scheme):
    bip, n, k = block_codebook(scheme)
    rng = np.random.default_rng(zlib.crc32(scheme.encode()))
    for shape in ((4, 50), (1, 128), (300,)):
        cw = rng.standard_normal(shape + (n,)).astype(np.float32)
        want = np.argmax(cw @ bip, axis=-1)
        got = cba.codebook_argmax(torch.from_numpy(cw), torch.from_numpy(bip))
        assert got.dtype == torch.int32 and got.shape == shape
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            j_codebook_argmax(jnp.asarray(cw), jnp.asarray(bip),
                              interpret=True)))


def test_ties_pick_first():
    bip = torch.ones(8, 2048)
    cw = torch.ones(2, 130, 8)
    assert (cba.codebook_argmax(cw, bip) == 0).all()
    bip[:, 1::2] = -1.0
    assert (cba.codebook_argmax(torch.zeros(3, 8), bip) == 0).all()


def test_chunked_plain_version_is_one_ordered_sum():
    # chunking the rows changes nothing: the same exact terms in order
    bip, n, _ = block_codebook("golay2412")
    cw = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1000, n)).astype(np.float32))
    b = torch.from_numpy(bip)
    np.testing.assert_array_equal(
        cba.codebook_argmax_reference(cw, b, chunk=97).numpy(),
        cba.codebook_argmax_reference(cw, b).numpy())


def test_pack_codebook():
    bip = torch.from_numpy(block_codebook("golay2412")[0])
    masks = cba.pack_codebook(bip).numpy().view(np.uint32)
    bits = (masks[None, :] >> (31 - np.arange(24))[:, None]) & 1
    np.testing.assert_array_equal(bits, (bip.numpy() < 0).astype(np.uint32))
    assert ((masks & 0xFF) == 0).all()


def test_sort_codebook():
    bip = block_codebook("golay2412")[0].copy()
    bip[:, 900] = bip[:, 3]                      # equal masks: own order kept
    masks, order = cba.sort_codebook(torch.from_numpy(bip))
    assert masks.dtype == torch.int32 and order.dtype == torch.int32
    m = masks.numpy().view(np.uint32)
    o = order.numpy()
    assert (np.diff(m.astype(np.int64)) >= 0).all()
    assert sorted(o.tolist()) == list(range(bip.shape[1]))
    np.testing.assert_array_equal(
        m, cba.pack_codebook(torch.from_numpy(bip)).numpy().view(np.uint32)[o])
    at = int(np.flatnonzero(o == 3)[0])
    assert o[at + 1] == 900
    # aligned groups of 4 sorted columns share 10 leading positions
    g = cba.sort_codebook(torch.from_numpy(block_codebook("golay2412")[0]))[
        0].numpy().view(np.uint32).reshape(-1, 4)
    assert ((np.bitwise_or.reduce(g ^ g[:, :1], axis=1) >> 22) == 0).all()


def test_sorted_masks_are_kept_per_codebook_tensor():
    bip = torch.from_numpy(block_codebook("hamming1511")[0].copy())
    first = cba.sorted_masks(bip)
    assert cba.sorted_masks(bip) is first
    assert all(torch.equal(a, b) for a, b in zip(first, cba.sort_codebook(bip)))
    bip[0, 5] = -bip[0, 5]                       # written in place: sorted anew
    again = cba.sorted_masks(bip)
    assert again is not first
    assert all(torch.equal(a, b) for a, b in zip(again, cba.sort_codebook(bip)))
    other = bip.clone()                          # another tensor, its own entry
    assert cba.sorted_masks(other) is not again
    n = len(cba._SORTED)
    del bip, other
    assert len(cba._SORTED) == n - 2             # dropped with their tensors


@pytest.mark.parametrize("scheme", ["hamming74", "hamming128", "golay2412"])
def test_scores_argmax_matches_jax(scheme):
    # K < 1024 takes einsum + argmax, K >= 1024 the kernel's plain version
    bip, n, _ = block_codebook(scheme)
    cw = np.random.default_rng(len(scheme)).standard_normal(
        (2, 7, n)).astype(np.float32)
    got = _scores_argmax(torch.from_numpy(cw), torch.from_numpy(bip))
    want = np.asarray(j_scores_argmax(jnp.asarray(cw), bip))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_rejects_bad_input():
    bip = torch.ones(24, 4096)
    with pytest.raises(ValueError, match="contiguous"):
        cba.codebook_argmax(torch.ones(24, 10).t(), bip)
    with pytest.raises(ValueError, match="float32"):
        cba.codebook_argmax(torch.ones(10, 24, dtype=torch.float64), bip)
    with pytest.raises(ValueError, match="n <= 32"):
        cba.codebook_argmax(torch.ones(10, 40), torch.ones(40, 4096))
    with pytest.raises(ValueError, match="device"):
        cba.codebook_argmax(torch.ones(10, 24, device="meta"), bip)
    with pytest.raises(ValueError, match="CUDA"):
        cba.codebook_argmax(torch.ones(10, 24, device="meta"),
                            bip.to("meta"))
