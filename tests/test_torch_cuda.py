"""The port's CUDA kernels against their plain PyTorch versions on the card.

Skips without a CUDA card.  The card's machine has no JAX, and
tests/conftest.py imports it, so run this file there without the
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: 1e-5 of rms in f32 (the same float32 arithmetic, summed in
another order); with bf16 output planes one bf16 step (2^-7 of the
largest output), since both versions round their f32 sums to bf16.
codebook_argmax: bit-equal indices (kernel and plain version sum the same
exact terms in the same order).
"""
import numpy as np
import pytest
import torch

from liquid_dsp_tpu_torch.fec.device import block_codebook
from liquid_dsp_tpu_torch.ops.kernels import codebook_argmax as cba
from liquid_dsp_tpu_torch.ops.kernels import fir_real as fr
from liquid_dsp_tpu_torch.ops.kernels import mix_fir_decim as mfd

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False     # plain version: full f32
    return torch.device("cuda")


def _case(dev, B, T, L, down, in_dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(L, generator=g, device=dev) / L ** 0.5
    rc, rs = (torch.from_numpy(r).to(dev)
              for r in mfd.make_ramp(L, 0.3 + 0.01 * seed))
    return dict(
        xr=torch.randn(B, T, generator=g, device=dev).to(in_dtype),
        xi=torch.randn(B, T, generator=g, device=dev).to(in_dtype),
        carry_r=torch.randn(B, mfd.SUB, generator=g, device=dev),
        carry_i=torch.randn(B, mfd.SUB, generator=g, device=dev),
        theta=torch.tensor(2.9, device=dev), ramp_c=rc, ramp_s=rs, taps=h)


def _err(y, ref):
    d = torch.stack([y[0].float() - ref[0].float(),
                     y[1].float() - ref[1].float()])
    rms = torch.stack([ref[0].float(), ref[1].float()]).square().mean().sqrt()
    return float(d.abs().max() / rms)


@pytest.mark.parametrize("B,T,L,down", [
    (64, 262144, 144, 2), (8, 2048, 144, 2), (16, 6144, 41, 4),
    (8, 4096, 257, 1), (8, 2048, 1, 1), (8, 2048, 257, 256),
    (24, 8192, 100, 8)])
@pytest.mark.parametrize("sgn", [-1.0, 1.0])
def test_kernel_matches_plain_f32(dev, B, T, L, down, sgn):
    a = _case(dev, B, T, L, down, torch.float32, seed=L + down)
    kw = dict(down=down, sgn=sgn, dphi=0.3 + 0.01 * (L + down))
    n = mfd.mix_fir_decim.launches
    y = mfd.mix_fir_decim(**a, **kw)
    ref = mfd.mix_fir_decim_reference(*a.values(), **kw)
    torch.cuda.synchronize()
    assert mfd.mix_fir_decim.launches == n + 1
    assert y[0].shape == (B, T // down) and y[0].dtype == torch.float32
    assert _err(y, ref) < 1e-5


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_kernel_dtypes(dev, in_dtype, out_dtype):
    a = _case(dev, 16, 4096, 144, 2, in_dtype, seed=3)
    kw = dict(down=2, sgn=-1.0, dphi=0.125, out_dtype=out_dtype)
    y = mfd.mix_fir_decim(**a, **kw)
    ref = mfd.mix_fir_decim_reference(*a.values(), **kw)
    assert y[0].dtype == out_dtype
    if out_dtype == torch.float32:
        assert _err(y, ref) < 1e-5
    else:
        # both round the same f32 sums to bf16: at most one step apart
        top = max(float(ref[0].float().abs().max()),
                  float(ref[1].float().abs().max()))
        assert float((y[0].float() - ref[0].float()).abs().max()) <= top * 2.0 ** -7
        assert float((y[1].float() - ref[1].float()).abs().max()) <= top * 2.0 ** -7


def test_kernel_rejects_misplaced_tensors(dev):
    a = _case(dev, 8, 2048, 144, 2, torch.float32, seed=0)
    a["taps"] = a["taps"].cpu()
    with pytest.raises(ValueError, match="device"):
        mfd.mix_fir_decim(**a, down=2, sgn=-1.0, dphi=0.125)
    a["taps"] = a["taps"].to(dev)
    a["xr"] = torch.randn(2048, 8, device=dev).t()
    with pytest.raises(ValueError, match="contiguous"):
        mfd.mix_fir_decim(**a, down=2, sgn=-1.0, dphi=0.125)


@pytest.mark.parametrize("scheme,M", [("golay2412", 1000), ("golay2412", 37),
                                      ("hamming1511", 4099)])
def test_codebook_argmax_matches_plain(dev, scheme, M):
    bip_np, n, _ = block_codebook(scheme)
    bip = torch.from_numpy(bip_np).to(dev)
    g = torch.Generator(device=dev).manual_seed(M)
    cw = torch.randn(M, n, generator=g, device=dev)
    launches = cba.codebook_argmax.launches
    got = cba.codebook_argmax(cw, bip)
    want = cba.codebook_argmax_reference(cw, bip)
    torch.cuda.synchronize()
    assert cba.codebook_argmax.launches == launches + 1
    assert got.dtype == torch.int32 and got.shape == (M,)
    assert torch.equal(got, want)
    # and the numpy argmax of the same scores
    ref = np.argmax(cw.cpu().numpy() @ bip_np, axis=-1)
    assert (got.cpu().numpy() == ref).all()


@pytest.mark.parametrize("K", [2048, 4096])
def test_codebook_argmax_ties_pick_first(dev, K):
    bip = torch.ones(8, K, device=dev)
    bip[:, 1::2] = -1.0
    cw = torch.zeros(2, 130, 8, device=dev)   # every score equal
    assert (cba.codebook_argmax(cw, bip) == 0).all()
    cw = torch.ones(3, 8, device=dev)         # columns 0, 2, 4, ... tie
    assert (cba.codebook_argmax(cw, bip) == 0).all()


def test_codebook_argmax_rejects_misplaced_tensors(dev):
    bip = torch.from_numpy(block_codebook("golay2412")[0])
    cw = torch.randn(10, 24, device=dev)
    with pytest.raises(ValueError, match="device"):
        cba.codebook_argmax(cw, bip)
    with pytest.raises(ValueError, match="contiguous"):
        cba.codebook_argmax(torch.randn(24, 10, device=dev).t(), bip.to(dev))


@pytest.mark.parametrize("L", [1, 13, 64, 129, 257])
@pytest.mark.parametrize("T", [1000, 4096, 2053])
def test_fir_real_matches_plain(dev, L, T):
    g = torch.Generator(device=dev).manual_seed(L + T)
    x = torch.randn(6, T, generator=g, device=dev)
    carry = torch.randn(6, L - 1, generator=g, device=dev)
    h = torch.randn(L, generator=g, device=dev) / L ** 0.5
    launches = fr.fir_real.launches
    y = fr.fir_real(x, carry, h)
    ref = fr.fir_real_reference(x, carry, h)
    torch.cuda.synchronize()
    assert fr.fir_real.launches == launches + 1
    assert y.shape == (6, T)
    assert float((y - ref).abs().max() / ref.square().mean().sqrt()) < 1e-5


def test_fir_real_largest_taps(dev):
    L = fr.LMAX
    x = torch.randn(2, 3000, device=dev)
    carry = torch.randn(2, L - 1, device=dev)
    h = torch.randn(L, device=dev) / L ** 0.5
    y, ref = fr.fir_real(x, carry, h), fr.fir_real_reference(x, carry, h)
    assert float((y - ref).abs().max() / ref.square().mean().sqrt()) < 1e-5
    with pytest.raises(ValueError, match="taps"):
        fr.fir_real(x, torch.zeros(2, L, device=dev),
                    torch.zeros(L + 1, device=dev))


def test_fir_real_rejects_misplaced_tensors(dev):
    x = torch.randn(4, 512, device=dev)
    carry = torch.randn(4, 12, device=dev)
    with pytest.raises(ValueError, match="device"):
        fr.fir_real(x, carry, torch.randn(13))
    with pytest.raises(ValueError, match="contiguous"):
        fr.fir_real(torch.randn(512, 4, device=dev).t(), carry,
                    torch.randn(13, device=dev))


def test_receiver_on_the_card_matches_the_cpu(dev):
    # the frame64 receiver path on the card (detection matmuls, windows,
    # grouped conv, pilot sync, codebook kernel, finish) against the same
    # module on the CPU: valid, sample_index, bytes and crc_ok equal
    from liquid_dsp_tpu_torch.framing.frame64 import (
        FRAME64_LEN, Framesync64, framegen64, framesync64,
        framesync64_stream_full)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(3)
    T, x, sent = 4096, np.zeros((2, 4 * 4096), np.complex64), []
    for ch, s0 in ((0, 700), (0, 5000), (1, 4000), (1, 8191)):
        h = rng.integers(0, 256, 8).astype(np.uint8)
        p = rng.integers(0, 256, 64).astype(np.uint8)
        x[ch, s0:s0 + FRAME64_LEN] = framegen64(h, p)
        sent.append((ch, s0, p))
    x += (0.01 * (rng.standard_normal(x.shape)
                  + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
    cpu = framesync64_stream_full(T)
    card = framesync64_stream_full(T).to(dev)
    cc, cg = cpu.init(batch_shape=(2,)), card.init(batch_shape=(2,),
                                                   device=dev)
    n = 0
    for b in range(4):
        blk = torch.from_numpy(x[:, b * T:(b + 1) * T].copy())
        oc, cc = cpu(cc, blk)
        og, cg = card(cg, blk.to(dev))
        for key in ("valid", "sample_index", "hdr_bytes", "pay_bytes",
                    "crc_ok"):
            a, g = getattr(oc, key), getattr(og, key).cpu()
            if key in ("hdr_bytes", "pay_bytes"):
                a, g = a[oc.valid], g[oc.valid]
            assert torch.equal(a, g), (b, key)
        n += int(oc.valid.sum())
        assert bool(oc.crc_ok[oc.valid].all())
    assert n == len(sent)
    fs = Framesync64(block_len=T, device=dev)
    got = fs.execute(x[1]) + fs.flush()
    assert [g[2].tolist() for g in got] == [s[2].tolist() for s in sent
                                            if s[0] == 1]
    res = framesync64(x[0, :4000], device=dev)
    assert res.crc_ok and res.payload.tolist() == sent[0][2].tolist()
