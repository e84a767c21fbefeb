"""Port parity for `ops/kernels/branch_bank.py`, the hoisted symsync path's
branch outputs (its plain version on the CPU): against the JAX package's
convolution of the same banks and input, against PyTorch's conv1d, its
own order of summation, and the wrapper's checks.

Tolerances: the JAX package's `lax.conv_general_dilated` (HIGHEST
precision, `liquid_dsp_tpu/ops/symsync.py:153-166`) and PyTorch's float32
conv1d sum each output's Lb products in their own orders, so they agree
with the plain version to a few float32 roundings of the sum: 1e-6 of the
outputs' rms (the JAX package's own hoisted-versus-scan bound on these
sums is 1e-5, tests/test_symsync_misc.py).  The plain version's own order
(the first product, then one fused multiply-add a tap) is held bit for
bit, as the kernel is held to it on the card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from liquid_dsp_tpu.ops.symsync import symsync_banks as jax_banks
from liquid_dsp_tpu_torch.ops import symsync as pss
from liquid_dsp_tpu_torch.ops.kernels import branch_bank as bk
from liquid_dsp_tpu_torch.ops.kernels.symsync_scan import fma32

TOL = 1e-6


def _bank(k, m, npfb=32):
    mf, dmf = pss.symsync_banks("arkaiser", k, m, 0.3, npfb)
    return mf, dmf, pss.branch_kernel(mf, dmf, "cpu")


def _planes(P, B, n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((P, B, n)).astype(np.float32))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.sqrt(np.mean(b * b)))


def _jax_branch_outputs(mf, dmf, planes):
    # the JAX package's branch outputs, written as its hoisted symsync
    # writes them (liquid_dsp_tpu/ops/symsync.py:153-166): the banks
    # flipped, a VALID conv at HIGHEST precision, [N, 2 npfb, Tc]
    kern = jnp.asarray(np.concatenate([mf[:, ::-1], dmf[:, ::-1]],
                                      axis=0)[:, None, :])
    flat = jnp.asarray(planes.numpy()).reshape((-1, 1, planes.shape[-1]))
    y = lax.conv_general_dilated(flat, kern, (1,), "VALID",
                                 dimension_numbers=("NCH", "OIH", "NCH"),
                                 precision=lax.Precision.HIGHEST)
    return np.asarray(y).reshape(planes.shape[:2] + y.shape[1:])


@pytest.mark.parametrize("k,m,P,B,Tc", [(2, 7, 2, 3, 512), (2, 5, 2, 2, 300),
                                        (2, 3, 1, 4, 257), (4, 2, 2, 1, 64)])
def test_plain_version_matches_the_jax_conv(k, m, P, B, Tc):
    mf, dmf, kern = _bank(k, m)
    jmf, jdmf = (np.asarray(v) for v in jax_banks("arkaiser", k, m, 0.3, 32))
    np.testing.assert_array_equal(mf, jmf)
    np.testing.assert_array_equal(dmf, jdmf)
    planes = _planes(P, B, Tc + kern.shape[1] - 1, seed=k * m + P)
    ma = bk.branch_bank(planes, kern)
    assert ma.shape == (P, B, 2 * 32, Tc) and ma.dtype == torch.float32
    assert _rel(ma.numpy(), _jax_branch_outputs(mf, dmf, planes)) < TOL


@pytest.mark.parametrize("Lb,R", [(28, 64), (20, 64), (1, 3), (5, 10),
                                  (64, 16)])
def test_plain_version_matches_conv1d(Lb, R):
    rng = np.random.default_rng(Lb)
    kern = torch.from_numpy(rng.standard_normal((R, Lb)).astype(np.float32))
    planes = _planes(2, 3, 200 + Lb - 1, seed=R)
    ma = bk.branch_bank(planes, kern)
    ref = F.conv1d(planes.reshape(6, 1, -1), kern[:, None]).reshape(ma.shape)
    assert _rel(ma.numpy(), ref.numpy()) < TOL


def test_each_output_is_summed_tap_by_tap_in_order():
    # out[r, t] = x[t] k[0], then fma(x[t + j], k[j], .) for j = 1 .. Lb-1:
    # the order csrc/branch_dot.cuh writes out, one output at a time
    _, _, kern = _bank(2, 7)
    planes = _planes(1, 1, 40 + kern.shape[1] - 1, seed=9)
    ma = bk.branch_bank_reference(planes, kern)
    x = planes[0, 0]
    for r in (0, 17, 40, 63):
        for t in (0, 13, 39):
            acc = x[t:t + 1] * kern[r, :1]
            for j in range(1, kern.shape[1]):
                acc = fma32(x[t + j:t + j + 1], kern[r, j:j + 1], acc)
            assert torch.equal(acc[0], ma[0, 0, r, t])


def test_a_strided_view_and_the_whole_block_agree_with_chunks():
    # the hoisted path hands each chunk over as a view of the block's
    # planes: any chunking gives the same outputs, bit for bit
    _, _, kern = _bank(2, 7)
    Lb = kern.shape[1]
    planes = _planes(2, 2, 300 + Lb - 1, seed=3)
    whole = bk.branch_bank(planes, kern)
    for s, n in ((0, 128), (128, 100), (228, 72)):
        view = planes[..., s:s + n + Lb - 1]
        assert view.stride(-1) == 1 and not view.is_contiguous()
        assert torch.equal(bk.branch_bank(view, kern), whole[..., s:s + n])


def test_hoisted_symsync_takes_its_branch_outputs_from_branch_bank(
        monkeypatch):
    # the hoisted path's chunks go through branch_bank with the bank that
    # branch_kernel builds: the banks flipped, MF rows then dMF rows
    mf, dmf, kern = _bank(2, 5)
    assert kern.is_contiguous() and kern.shape == (64, 20)
    assert torch.equal(kern[:32], torch.from_numpy(mf).flip(1))
    assert torch.equal(kern[32:], torch.from_numpy(dmf).flip(1))
    seen = []

    def spy(planes, k):
        seen.append((tuple(planes.shape), torch.equal(k, kern)))
        return bk.branch_bank(planes, k)

    monkeypatch.setattr(pss, "branch_bank", spy)
    q = pss.symsync(k=2, m=5)
    x = torch.from_numpy((np.random.default_rng(1).standard_normal(
        (2, 600)) * 0.5).astype(np.complex64))
    pss.symsync_run(q.mf, q.dmf, q.init((2,)), x, 2, hoist=True)
    assert seen == [((2, 2, 600 + 19), True)]


def test_an_empty_chunk():
    _, _, kern = _bank(2, 5)
    ma = bk.branch_bank(torch.zeros(2, 3, kern.shape[1] - 1), kern)
    assert ma.shape == (2, 3, 64, 0)


@pytest.mark.parametrize("case", ["planes dims", "kern dims", "short",
                                  "dtype", "kern dtype", "stride",
                                  "kern contiguous", "devices"])
def test_wrapper_checks(case):
    _, _, kern = _bank(2, 5)
    planes = _planes(2, 3, 50, seed=0)
    if case == "planes dims":
        planes = planes[0]
    elif case == "kern dims":
        kern = kern[None]
    elif case == "short":
        planes = planes[..., :kern.shape[1] - 2]
    elif case == "dtype":
        planes = planes.double()
    elif case == "kern dtype":
        kern = kern.double()
    elif case == "stride":
        planes = planes.mT.contiguous().mT
    elif case == "kern contiguous":
        kern = kern.mT.contiguous().mT
    elif case == "devices":
        kern = kern.to("meta")
    with pytest.raises(ValueError):
        bk.branch_bank(planes, kern)


def test_wrapper_refuses_other_devices():
    _, _, kern = _bank(2, 5)
    with pytest.raises(ValueError, match="runs on CUDA"):
        bk.branch_bank(torch.zeros(2, 3, 50, device="meta"),
                       kern.to("meta"))


def test_limits_are_the_kernels():
    # the plain version takes any bank; the kernel's limits (checked on
    # CUDA tensors only) are its shared memory's
    assert bk.LB_MAX == 64 and bk.tap_pitch(28) == 28 and bk.tap_pitch(29) \
        == 32
    assert 2 * 32 * bk.tap_pitch(bk.LB_MAX) <= bk.BANK_MAX
    kern = torch.ones(3, bk.LB_MAX + 1)
    ma = bk.branch_bank(torch.ones(1, 1, bk.LB_MAX + 4), kern)
    assert ma.shape == (1, 1, 3, 4) and bool((ma == bk.LB_MAX + 1).all())
