"""The port's CUDA kernels against their plain PyTorch versions on the card.

Skips without a CUDA card.  The card's machine has no JAX, and
tests/conftest.py imports it, so run this file there without the
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: 1e-5 of rms in f32 (the same float32 arithmetic, summed in
another order); with bf16 output planes one bf16 step (2^-7 of the
largest output), since both versions round their f32 sums to bf16.
codebook_argmax: bit-equal indices (kernel and plain version sum the same
exact terms in the same order; a multiply-add by +-1 is the rounded add).
symsync_scan and agc_scan: bit-equal outputs and state (the same
roundings, FMAs where both take them; agc_scan's log and exp are the
module's own in both);
pll_lms: 2e-4 with equal decisions (sincos, atan2 and the dot's order and
association differ), the reference's stream tolerance.
viterbi_acs: bit-equal bits and packed decisions (the same exact products,
sums in the same order, the same max and subtraction).
"""
import numpy as np
import pytest
import torch

from _golden_frames import FLEX_GOLDEN, lcg_bytes
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


@pytest.mark.parametrize("B,T,L,down", [
    (88, 65536, 144, 2),     # blocks of 2 tiles
    (440, 10240, 57, 2),     # 5 tiles a channel: blocks of 2, 2 and 1
    (448, 6144, 144, 1),     # one tile a block, 3 a channel
    (96, 131072, 33, 4)])    # blocks of 4 tiles, 8 outputs per unit
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_kernel_walks_tiles(dev, B, T, L, down, in_dtype):
    # every tile its own phase, tile 0 its halo from the carry, the raw
    # window from an aligned base (bf16: 8 samples a piece)
    a = _case(dev, B, T, L, down, in_dtype, seed=L)
    kw = dict(down=down, sgn=-1.0, dphi=0.3 + 0.01 * L)
    y = mfd.mix_fir_decim(**a, **kw)
    ref = mfd.mix_fir_decim_reference(*a.values(), **kw)
    torch.cuda.synchronize()
    assert _err(y, ref) < 1e-5


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


def _sorted_golay(dev):
    bip = torch.from_numpy(block_codebook("golay2412")[0])
    masks = cba.pack_codebook(bip).numpy().view(np.uint32)
    return bip[:, torch.from_numpy(np.argsort(masks, kind="stable"))] \
        .contiguous().to(dev)


@pytest.mark.parametrize("case,n,K,M", [
    ("sorted", 24, 4096, 5003),      # neighbours share leading positions
    ("random", 32, 1000, 10007),     # nothing shared, K off a pass
    ("random", 32, 100, 777),        # less than one pass
    ("random", 8, 1024, 300),        # the narrowest padded row
    ("random", 9, 2048, 65),         # padded from 9 to 16 positions
    ("random", 17, 4100, 1),         # one row, a ragged last pass
    ("duplicates", 32, 1000, 6000),  # exact ties between far-apart columns
    ("half_shared", 24, 1024, 999)]) # one warp votes shared, the others not
def test_codebook_argmax_structure_cases(dev, case, n, K, M):
    g = torch.Generator(device=dev).manual_seed(n + K + M)
    if case == "sorted":
        bip = _sorted_golay(dev)
    else:
        bip = torch.where(torch.rand(n, K, generator=g, device=dev) < 0.5,
                          -1.0, 1.0)
    cw = torch.randn(M, n, generator=g, device=dev)
    if case == "half_shared":
        # the first 128 columns in groups of 4 that agree on 8 positions
        bip[:8, :128] = bip[:8, :128:4].repeat_interleave(4, dim=1)
    if case == "duplicates":
        bip[:, 900] = bip[:, 3]
        bip[:, 517] = bip[:, 516]
        bip[:, 999] = bip[:, 640]
        col = torch.tensor([3, 516, 640], device=dev)[
            torch.randint(0, 3, (M,), generator=g, device=dev)]
        cw = ((torch.rand(M, n, generator=g, device=dev) + 0.5)
              * bip[:, col].t()).contiguous()
    cw[0] = 0.0                       # a constant row: every score tied
    launches = cba.codebook_argmax.launches
    got = cba.codebook_argmax(cw, bip)
    want = cba.codebook_argmax_reference(cw, bip)
    torch.cuda.synchronize()
    assert cba.codebook_argmax.launches == launches + 1
    assert torch.equal(got, want)
    assert int(got[0]) == 0 and int(got.max()) < K
    if case == "duplicates":
        assert torch.equal(got[1:].long(), col[1:])


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


@pytest.mark.parametrize("rows,T,L", [
    (3, 5 * 2048 + 77, 144),     # inner tiles, a first and a ragged last one
    (5, 3 * 2048 + 2, 9),        # T off a multiple of 4: scalar stores
    (700, 4096, 31)])            # many rows
def test_fir_real_tiles(dev, rows, T, L):
    g = torch.Generator(device=dev).manual_seed(L + T)
    x = torch.randn(rows, T, generator=g, device=dev)
    carry = torch.randn(rows, L - 1, generator=g, device=dev)
    h = torch.randn(L, generator=g, device=dev) / L ** 0.5
    y = fr.fir_real(x, carry, h)
    ref = fr.fir_real_reference(x, carry, h)
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
    fs = Framesync64(block_len=T)               # the card by default
    assert fs.device.type == "cuda"
    got = fs.execute(x[1]) + fs.flush()
    assert [g[2].tolist() for g in got] == [s[2].tolist() for s in sent
                                            if s[0] == 1]
    res = framesync64(x[0, :4000])
    assert res.crc_ok and res.payload.tolist() == sent[0][2].tolist()
    # the detector alone: a host capture goes to the card by default
    from liquid_dsp_tpu_torch.framing import frame64
    from liquid_dsp_tpu_torch.framing.detector import qdetector_detect
    tmpl = frame64._detector_template()
    det = qdetector_detect(x[0, :4000], tmpl)
    on_cpu = qdetector_detect(x[0, :4000], tmpl, device="cpu")
    assert det.detected and det.sample_index == on_cpu.sample_index \
        == res.sample_index
    assert abs(det.rxy - on_cpu.rxy) <= 1e-4


# --- the timing-recovery family's kernels -------------------------------

def _symsync_case(dev, P, B, Tc, seed, npfb=32, scale=0.7, stale=False):
    """Noise as branch outputs (the loop drifts fast, so the branch leaves
    the kernel's staged rows and wraps at 0 and npfb) and a loop state;
    with `stale`, bi and bf off round(tau*npfb) as a step decrement may
    leave them, and one tau on a rounding edge."""
    from liquid_dsp_tpu_torch.ops.kernels import symsync_scan as sk
    g = torch.Generator(device=dev).manual_seed(seed)
    ma = torch.randn(P, B, 2 * npfb, Tc, generator=g, device=dev) * scale
    fs = torch.zeros(6, B, device=dev)
    fs[0] = torch.rand(B, generator=g, device=dev) * 1.2 - 0.3
    fs[1] = fs[2] = 2.0
    fs[4] = fs[0] * npfb
    bi = torch.round(fs[4]).int()
    if stale:
        fs[0, 0] = 15.5 / npfb
        fs[4] = fs[0] * npfb * (1 + 2e-7) + 1e-6
        bi = torch.round(fs[0] * npfb).int()
        bi[1::2] += 1
        bi[2::4] -= 2
    is_ = torch.stack([bi, torch.ones(B, dtype=torch.int32, device=dev)])
    return sk, ma, fs, is_


@pytest.mark.parametrize("P,B,Tc,k,k_out,locked", [
    (2, 256, 1024, 2, 1, False), (1, 37, 300, 2, 1, False),
    (2, 5, 513, 3, 2, False), (2, 40, 256, 2, 1, True)])
def test_symsync_scan_bit_equal_to_plain(dev, P, B, Tc, k, k_out, locked):
    sk, ma, fs, is_ = _symsync_case(dev, P, B, Tc, seed=B + Tc)
    kw = dict(npfb=32, max_out=int(np.ceil(k / k_out)) + 1, k=k,
              k_out=k_out, bw=0.02, locked=locked)
    launches = sk.symsync_scan.launches
    got = sk.symsync_scan(ma, fs, is_, **kw)
    want = sk.symsync_scan_reference(ma, fs, is_, **kw)
    torch.cuda.synchronize()
    assert sk.symsync_scan.launches == launches + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("P,B,Tc,npfb,k,k_out,locked,bw,scale,stale", [
    (2, 1, 4096, 32, 2, 1, False, 0.02, 0.7, False),    # one channel
    (2, 3, 1000, 32, 2, 1, False, 0.02, 0.05, True),    # slow drift, stale
    (1, 7, 31, 32, 2, 1, False, 0.02, 0.7, True),       # less than a tile
    (2, 9, 33, 32, 2, 1, True, 0.02, 0.7, True),        # a tile and a step
    (2, 6, 200, 24, 2, 1, False, 0.05, 0.3, True),      # npfb not 2^n
    (1, 5, 200, 4, 2, 1, False, 0.05, 0.3, False),      # fewer rows than WIN
    (2, 4, 300, 32, 3, 1, False, 0.3, 0.7, True),       # max_out = 4
    (2, 4, 300, 32, 4, 3, False, 0.3, 0.7, False),      # k_out = 3
    (2, 130, 509, 32, 2, 1, False, 0.02, 0.2, True)])   # ragged, B > SMs
def test_symsync_scan_structure_cases(dev, P, B, Tc, npfb, k, k_out, locked,
                                      bw, scale, stale):
    sk, ma, fs, is_ = _symsync_case(dev, P, B, Tc, seed=B + Tc, npfb=npfb,
                                    scale=scale, stale=stale)
    kw = dict(npfb=npfb, max_out=int(np.ceil(k / k_out)) + 1, k=k,
              k_out=k_out, bw=bw, locked=locked)
    launches = sk.symsync_scan.launches
    got = sk.symsync_scan(ma, fs, is_, **kw)
    want = sk.symsync_scan_reference(ma, fs, is_, **kw)
    torch.cuda.synchronize()
    assert sk.symsync_scan.launches == launches + 1
    assert int(want[2].sum()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_symsync_scan_rejects_misplaced_tensors(dev):
    sk, ma, fs, is_ = _symsync_case(dev, 2, 8, 64, seed=0)
    kw = dict(npfb=32, max_out=3, k=2, k_out=1, bw=0.02, locked=False)
    with pytest.raises(ValueError, match="device"):
        sk.symsync_scan(ma, fs.cpu(), is_, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        sk.symsync_scan(ma.transpose(0, 1).contiguous().transpose(0, 1), fs,
                        is_, **kw)


@pytest.mark.parametrize("locked", [False, True])
def test_agc_scan_bit_equal_to_plain(dev, locked):
    from liquid_dsp_tpu_torch.ops.kernels import agc_scan as ak
    g = torch.Generator(device=dev).manual_seed(5)
    p = torch.rand(70, 2000, generator=g, device=dev) * torch.logspace(
        -3, 1, 70, device=dev)[:, None]
    g0 = torch.rand(70, generator=g, device=dev) + 0.5
    y0 = torch.ones(70, device=dev)
    launches = ak.agc_scan.launches
    got = ak.agc_scan(p, g0, y0, alpha=0.02, locked=locked)
    want = ak.agc_scan_reference(p, g0, y0, alpha=0.02, locked=locked)
    torch.cuda.synchronize()
    assert ak.agc_scan.launches == launches + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _agc_power(dev, B, T, seed):
    """Power from 1e-8 to 1e4 across the channels; in mid-block a step
    down by 1e6, a step up by 1e4, or silence on a channel in three each."""
    g = torch.Generator(device=dev).manual_seed(seed)
    p = torch.rand(B, T, generator=g, device=dev) * torch.logspace(
        -8, 4, B, device=dev)[:, None]
    p[::3, T // 2:] *= 1e-6
    p[1::3, T // 3:] *= 1e4
    p[2::3, T // 2:] = 0.0
    return p.contiguous()


@pytest.mark.parametrize("B,T,alpha,locked,g0", [
    (256, 512, 0.5, False, 1.0),      # below the guard and up to the clamp
    (70, 1021, 1e-3, False, 1.0),     # ragged last block and last tile
    (256, 512, 0.02, False, 1e6),     # from a carry with g at the clamp
    (40, 700, 0.02, True, 0.7),       # locked
    (33, 7, 0.1, False, 1.0),         # less than one tile
    (1, 33, 1.0, False, 1.0),         # one channel, a tile and a sample
    (5, 64, 0.3, False, 1e-3),        # whole tiles only
    (300, 100, 0.05, False, 2.0)])    # more blocks than a wave of 8
def test_agc_scan_structure_cases(dev, B, T, alpha, locked, g0):
    from liquid_dsp_tpu_torch.ops.kernels import agc_scan as ak
    p = _agc_power(dev, B, T, seed=B + T)
    g = torch.full((B,), g0, device=dev)
    y = torch.ones(B, device=dev)
    launches = ak.agc_scan.launches
    got = ak.agc_scan(p, g, y, alpha=alpha, locked=locked)
    want = ak.agc_scan_reference(p, g, y, alpha=alpha, locked=locked)
    torch.cuda.synchronize()
    assert ak.agc_scan.launches == launches + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert float(want[0].max()) <= 1e6
    assert torch.equal(g, torch.full((B,), g0, device=dev))   # carry kept


def test_agc_log_and_exp_on_the_card_equal_the_cpu(dev):
    # the plain version's arithmetic does not depend on the device
    from liquid_dsp_tpu_torch.ops.kernels import agc_scan as ak
    g = torch.Generator().manual_seed(0)
    y = torch.exp(torch.rand(100_000, generator=g) * 100 - 13.8)
    x = torch.rand(100_000, generator=g) * 88 - 44
    assert torch.equal(ak.agc_log(y.to(dev)).cpu(), ak.agc_log(y))
    assert torch.equal(ak.agc_exp(x.to(dev)).cpu(), ak.agc_exp(x))


@pytest.mark.parametrize("ms,L", [("qpsk", 13), ("qam16", 13),
                                  ("qpsk", 20), ("psk8", 32)])
def test_pll_lms_matches_plain(dev, ms, L):
    from liquid_dsp_tpu_torch.framing.symtrack import symtrack_stream
    from liquid_dsp_tpu_torch.ops.kernels import pll_lms as pk
    st = symtrack_stream(ms=ms, eq_len=L).to(dev)
    B, S = 40, 1500
    g = torch.Generator(device=dev).manual_seed(L)
    idx = torch.randint(0, st.tab_re.shape[0], (B, S), generator=g,
                        device=dev)
    ph = torch.rand(B, 1, generator=g, device=dev) * 6.28
    sr = st.tab_re[idx] * torch.cos(ph) - st.tab_im[idx] * torch.sin(ph)
    si = st.tab_re[idx] * torch.sin(ph) + st.tab_im[idx] * torch.cos(ph)
    sr = (sr + 0.03 * torch.randn(B, S, generator=g, device=dev)).contiguous()
    si = (si + 0.03 * torch.randn(B, S, generator=g, device=dev)).contiguous()
    valid = torch.rand(B, S, generator=g, device=dev) < 0.5
    pc = st.pll_state(st.init(batch_shape=(B,), device=dev), B)
    launches = pk.pll_lms.launches
    got = pk.pll_lms(sr, si, valid, pc, st.tab_re, st.tab_im,
                     **st.pll_kwargs())
    want = pk.pll_lms_reference(sr, si, valid, pc, st.tab_re, st.tab_im,
                                **st.pll_kwargs())
    torch.cuda.synchronize()
    assert pk.pll_lms.launches == launches + 1
    assert float((got[0] - want[0]).abs().max()) <= 2e-4
    assert float((got[1] - want[1]).abs().max()) <= 2e-4
    assert torch.equal(got[2], want[2])
    for key in pk.STATE_KEYS:
        assert float((got[3][key].float() - want[3][key].float()).abs()
                     .max()) <= 2e-4, key


def _pll_slots(dev, st, B, S, seed):
    """Noisy points of the tracker's constellation within 0.3 rad of a
    multiple of 90 degrees, on every slot."""
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(0, st.tab_re.shape[0], (B, S), generator=g,
                        device=dev)
    ph = (torch.rand(B, 1, generator=g, device=dev) * 0.6 - 0.3
          + torch.randint(0, 4, (B, 1), generator=g, device=dev) * (np.pi / 2))
    sr = st.tab_re[idx] * torch.cos(ph) - st.tab_im[idx] * torch.sin(ph)
    si = st.tab_re[idx] * torch.sin(ph) + st.tab_im[idx] * torch.cos(ph)
    sr = sr + 0.03 * torch.randn(B, S, generator=g, device=dev)
    si = si + 0.03 * torch.randn(B, S, generator=g, device=dev)
    return sr.contiguous(), si.contiguous(), g


@pytest.mark.parametrize("case,ms,L,B,S", [
    ("gaps", "qpsk", 13, 12, 1500), ("all_valid", "qpsk", 13, 9, 700),
    ("none_valid", "qpsk", 13, 3, 300), ("sixth", "qpsk", 13, 1, 3072),
    ("sixth", "qam16", 13, 3, 777), ("sixth", "qpsk", 32, 5, 600),
    ("sixth", "psk8", 16, 2, 600), ("sixth", "qpsk", 17, 2, 600),
    ("all_valid", "qpsk", 1, 2, 100), ("sixth", "qpsk", 13, 4, 7),
    ("zeros", "qpsk", 13, 3, 400), ("sixth", "qpsk", 13, 300, 520)])
def test_pll_lms_structure_cases(dev, case, ms, L, B, S):
    from liquid_dsp_tpu_torch.framing.symtrack import symtrack_stream
    from liquid_dsp_tpu_torch.ops.kernels import pll_lms as pk
    st = symtrack_stream(ms=ms, eq_len=L).to(dev)
    sr, si, g = _pll_slots(dev, st, B, S, seed=L + B + S)
    if case == "gaps":
        # channels with no valid slot, with valid slots only at the two
        # ends (a run of invalid slots over many tiles), and dense ones
        valid = torch.rand(B, S, generator=g, device=dev) < 0.4
        valid[::3] = False
        valid[1::3, 11:S - 9] = False
    elif case == "all_valid":
        valid = torch.ones(B, S, dtype=torch.bool, device=dev)
    elif case == "none_valid":
        valid = torch.zeros(B, S, dtype=torch.bool, device=dev)
    else:
        valid = torch.rand(B, S, generator=g, device=dev) < 1 / 6
    if case == "zeros":
        # invalid slots at zero, as symsync leaves them, and a valid zero
        sr, si = sr * valid, si * valid
        sr[:, 5], si[:, 5], valid[:, 5] = 0.0, 0.0, True
    pc = st.pll_state(st.init(batch_shape=(B,), device=dev), B)
    if case == "sixth" and L == 13:
        pc["eq_n"] = torch.zeros_like(pc["eq_n"])     # the window not full
    args = (sr, si, valid, pc, st.tab_re, st.tab_im)
    launches = pk.pll_lms.launches
    got = pk.pll_lms(*args, **st.pll_kwargs())
    want = pk.pll_lms_reference(*args, **st.pll_kwargs())
    torch.cuda.synchronize()
    assert pk.pll_lms.launches == launches + 1
    assert float((got[0] - want[0]).abs().max()) <= 2e-4
    assert float((got[1] - want[1]).abs().max()) <= 2e-4
    assert torch.equal(got[2], want[2])
    assert torch.equal(got[3]["eq_n"], want[3]["eq_n"])
    for key in pk.STATE_KEYS:
        assert float((got[3][key].float() - want[3][key].float()).abs()
                     .max()) <= 2e-4, key


def test_oneshot_symtrack_on_the_card_matches_the_cpu(dev):
    # symtrack() runs on the card by default, as one block of
    # symtrack_stream through the three kernels
    from liquid_dsp_tpu_torch.framing.symtrack import symtrack
    from liquid_dsp_tpu_torch.ops.kernels import pll_lms as pk
    from liquid_dsp_tpu_torch.design.firdes import firdes_prototype
    rng = np.random.default_rng(3)
    up = np.zeros(1400, np.complex64)
    up[::2] = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, 700)))
    h = firdes_prototype("arkaiser", 2, 7, 0.3)
    x = 0.4 * np.exp(0.5j) * np.convolve(up, h)[:1400]
    x = (x + 0.004 * (rng.standard_normal(1400)
                      + 1j * rng.standard_normal(1400))).astype(np.complex64)
    launches = pk.pll_lms.launches
    got = symtrack(x)
    assert pk.pll_lms.launches == launches + 1
    ref = symtrack(x, device="cpu")
    assert len(got.symbols) == len(ref.symbols) > 600
    np.testing.assert_allclose(got.symbols, ref.symbols, rtol=0, atol=2e-4)
    clear = np.minimum(np.abs(ref.symbols.real),
                       np.abs(ref.symbols.imag)) > 4e-4
    assert clear.sum() >= 0.9 * len(clear)
    np.testing.assert_array_equal(got.decisions[clear], ref.decisions[clear])


def test_pll_lms_rejects_long_equalizers(dev):
    from liquid_dsp_tpu_torch.framing.symtrack import symtrack_stream
    from liquid_dsp_tpu_torch.ops.kernels import pll_lms as pk
    st = symtrack_stream(eq_len=pk.LMAX + 1).to(dev)
    pc = st.pll_state(st.init(batch_shape=(2,), device=dev), 2)
    s = torch.zeros(2, 8, device=dev)
    with pytest.raises(ValueError, match="equalizer"):
        pk.pll_lms(s, s, s > 0, pc, st.tab_re, st.tab_im, **st.pll_kwargs())


def test_symtrack_on_the_card_matches_the_cpu(dev, monkeypatch):
    # the card's route (agc_scan, conv1d + symsync_scan, pll_lms) against
    # the port on the CPU forced to the same hoisted route
    from liquid_dsp_tpu_torch.framing.symtrack import Symtrack, symtrack_stream
    from liquid_dsp_tpu_torch.ops.kernels import agc_scan, pll_lms
    from liquid_dsp_tpu_torch.ops import symsync as ss
    from liquid_dsp_tpu_torch.ops.kernels import symsync_scan
    # the conv must not follow the global flag
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 2048)) + 1j * rng.standard_normal(
        (3, 2048))).astype(np.complex64) * 0.3
    card = symtrack_stream().to(dev)
    cpu = symtrack_stream()
    n = (agc_scan.agc_scan.launches, symsync_scan.symsync_scan.launches,
         pll_lms.pll_lms.launches)
    (yg, dg, vg), _ = card(card.init(batch_shape=(3,), device=dev),
                           torch.from_numpy(x).to(dev))
    run = ss.symsync_run
    monkeypatch.setattr(ss, "symsync_run",
                        lambda *a, **kw: run(*a, **kw, hoist=True))
    monkeypatch.setenv("LIQUID_SYMSYNC_KERNEL", "1")
    (yc, dc, vc), _ = cpu(cpu.init(batch_shape=(3,)), torch.from_numpy(x))
    assert (agc_scan.agc_scan.launches, symsync_scan.symsync_scan.launches,
            pll_lms.pll_lms.launches) == (n[0] + 1, n[1] + 1, n[2] + 1)
    assert torch.equal(vg.cpu(), vc)
    assert float((yg.cpu()[vc] - yc[vc]).abs().max()) <= 2e-4
    assert torch.equal(dg.cpu()[vc], dc[vc])
    tracker = Symtrack(block_len=1024)          # the card by default
    assert tracker.device.type == "cuda"
    sy, dec = tracker.execute(x[0])
    assert len(sy) == len(dec) > 900


def test_fused_routes_raise_on_the_card(dev, monkeypatch):
    from liquid_dsp_tpu_torch.framing.symtrack import symtrack_stream
    from liquid_dsp_tpu_torch.ops import symsync as ss
    monkeypatch.setenv("LIQUID_SYMTRACK_FUSED", "1")
    st = symtrack_stream().to(dev)
    x = torch.zeros(2, 1024, dtype=torch.complex64, device=dev)
    with pytest.raises(NotImplementedError, match="fused timing"):
        st(st.init(batch_shape=(2,), device=dev), x)
    q = ss.symsync().to(dev)
    with pytest.raises(NotImplementedError, match="fused timing"):
        ss._symsync_run_hoisted(q.mf, q.dmf, q.init((2,), device=dev), x, 2,
                                post=lambda *a: a, post_carry={})


def test_per_step_loops_raise_on_the_card(dev):
    # the CPU-only per-step loops refuse CUDA tensors instead of running
    # one launch per op on the card
    from liquid_dsp_tpu_torch.ops import equalize as eq
    from liquid_dsp_tpu_torch.ops import symsync as ss
    x = torch.zeros(2, 512, dtype=torch.complex64, device=dev)
    q = ss.symsync().to(dev)
    with pytest.raises(ValueError, match="scan body"):
        ss.symsync_run(q.mf, q.dmf, q.init((2,), device=dev), x, 2,
                       hoist=False)
    lms = eq.eqlms(5)
    with pytest.raises(NotImplementedError, match="eqlms"):
        lms(lms.init((2,), device=dev), x)
    rls = eq.eqrls(5)
    with pytest.raises(NotImplementedError, match="eqrls"):
        rls(rls.init((2,), device=dev), (x, x))


# --- the channelizers and the flexframe receivers -----------------------

@pytest.mark.parametrize("M", [64, 1024])
@pytest.mark.parametrize("kind", ["firpfbch_analyzer", "firpfbch_synthesizer",
                                  "firpfbch2_analyzer",
                                  "firpfbch2_synthesizer"])
def test_channelizer_on_the_card_matches_the_cpu(dev, kind, M):
    # M = 64: the fused matmul regime; M = 1024: branch filter + cuFFT.
    # cuBLAS and cuFFT sum in other orders than the CPU: 2e-5 of the
    # rms, outputs and carries (the large-M synthesizers carry IFFT-domain
    # frames, M times the input's scale), two blocks with the carry
    # between them
    from liquid_dsp_tpu_torch.multichannel import channelizer as ch
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(M)
    frames = 8
    shape = (3, frames * M) if "analyzer" in kind else (3, M, frames)
    cpu = getattr(ch, kind)(M)
    card = getattr(ch, kind)(M).to(dev)
    assert card.fused == (M <= ch._FUSED_MAX_M)
    cc, cg = cpu.init(batch_shape=(3,)), card.init(batch_shape=(3,),
                                                   device=dev)
    for _ in range(2):
        x = torch.from_numpy((rng.standard_normal(shape) + 1j *
                              rng.standard_normal(shape)).astype(np.complex64))
        yc, cc = cpu(cc, x)
        yg, cg = card(cg, x.to(dev))
        rms = yc.abs().square().mean().sqrt()
        assert float((yg.cpu() - yc).abs().max() / rms) < 2e-5
    for a, g in zip(*(c.values() if isinstance(c, dict) else [c]
                      for c in (cc, cg))):
        rms = a.abs().square().mean().sqrt()
        assert float((g.cpu() - a).abs().max() / rms) < 2e-5


def test_flexframe_rx_stream_on_the_card_matches_the_cpu(dev):
    # the full flexframe receiver (detection, sync, header decode, the
    # codebook kernel for the Golay payload, finish) against the same
    # module on the CPU: valid, sample_index, bytes and both CRCs equal
    from liquid_dsp_tpu_torch.framing.flexframe import (
        FLEXFRAME_H_USER, flexframe_rx_stream, flexframegen)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    T, PL = 4096, 64
    x = np.zeros((2, 4 * T), np.complex64)
    sent = []
    for chn, s0, ms in ((0, 700, "qpsk"), (0, 6000, "qpsk"),
                        (1, 4000, "qpsk"), (1, 9000, "qam16")):
        h = rng.integers(0, 256, FLEXFRAME_H_USER).astype(np.uint8)
        p = rng.integers(0, 256, PL).astype(np.uint8)
        f = flexframegen(h, p, ms=ms)
        x[chn, s0:s0 + len(f)] = f
        sent.append((chn, s0, ms == "qpsk"))
    x += (0.01 * (rng.standard_normal(x.shape)
                  + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
    cpu = flexframe_rx_stream(T, PL)
    card = flexframe_rx_stream(T, PL).to(dev)
    cc, cg = cpu.init(batch_shape=(2,)), card.init(batch_shape=(2,),
                                                   device=dev)
    n = 0
    n_launch = cba.codebook_argmax.launches
    for b in range(4):
        blk = torch.from_numpy(x[:, b * T:(b + 1) * T].copy())
        oc, cc = cpu(cc, blk)
        og, cg = card(cg, blk.to(dev))
        v = oc.valid
        for key in ("valid", "sample_index", "hdr_bytes", "hdr_ok",
                    "pay_bytes", "pay_ok"):
            a, g = getattr(oc, key), getattr(og, key).cpu()
            if key != "valid" and key != "sample_index":
                a, g = a[v], g[v]
            assert torch.equal(a, g), (b, key)
        n += int(v.sum())
        assert int((oc.hdr_ok & oc.pay_ok & v).sum()) == int(
            (oc.hdr_ok & v).sum())
    assert n == len(sent)
    assert cba.codebook_argmax.launches == n_launch + 4


def test_flexframe_sync_on_the_card_decodes_the_reference_frames(dev):
    # FlexFrameSync and flexframesync on the card by default; ffg_b and
    # ffg_c take the host decode
    import pathlib
    from liquid_dsp_tpu_torch.framing.flexframe import (FlexFrameSync,
                                                        flexframesync)
    torch.backends.cuda.matmul.allow_tf32 = False
    fg = dict(np.load(pathlib.Path(__file__).parent
                      / "golden/flexframe_golden.npz"))
    parts = []
    for tag, _, _ in FLEX_GOLDEN:
        parts += [np.zeros(700, np.complex64), fg[tag]]
    fs = FlexFrameSync()
    assert fs.device.type == "cuda"
    got = fs.execute(np.concatenate(parts)) + fs.flush()
    assert len(got) == 3
    for (tag, n, seed), (gh, hok, gp, pok, st) in zip(FLEX_GOLDEN, got):
        assert hok and pok
        np.testing.assert_array_equal(gh, lcg_bytes(14, seed))
        np.testing.assert_array_equal(gp, lcg_bytes(n, seed + 1))
        r = flexframesync(np.concatenate([np.zeros(50, np.complex64),
                                          fg[tag]]))
        assert r.crc_ok
        np.testing.assert_array_equal(r.payload, lcg_bytes(n, seed + 1))


@pytest.mark.parametrize("n", [64, 1021])
def test_fft_entry_points_take_host_arrays_to_the_card(dev, n):
    # host arrays go to the card by default; the result agrees with the
    # CPU run within 1e-5*sqrt(n) of the spectrum's peak (cuFFT and
    # pocketfft sum in other orders)
    from liquid_dsp_tpu_torch.ops import fft
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
         ).astype(np.complex64)
    for f in (fft.fft, fft.ifft):
        y = f(x)
        assert y.device.type == "cuda"
        want = f(x, device="cpu")
        assert float((y.cpu() - want).abs().max() / want.abs().max()) \
            < 1e-5 * np.sqrt(n)
    d = fft.dct(x.real)
    assert d.device.type == "cuda"
    want = fft.dct(x.real, device="cpu")
    assert float((d.cpu() - want).abs().max() / want.abs().max()) \
        < 1e-5 * np.sqrt(n)
    psd = fft.spgram_psd_oneshot(x, 2 * n)
    assert psd.device.type == "cuda"
    assert float((psd.cpu() - fft.spgram_psd_oneshot(
        x, 2 * n, device="cpu")).abs().max()) < 1e-3


def _viterbi_case(dev, scheme, N, dec_len, sigma, seed):
    """(decoder, obs on the card, the messages): N codewords of random
    bytes at noise sigma on +-4 metrics (None: all-zero metrics)."""
    from liquid_dsp_tpu_torch.fec.conv import conv_encode
    from liquid_dsp_tpu_torch.fec.device import conv_soft_decoder
    rng = np.random.default_rng(seed)
    fn, _ = conv_soft_decoder(scheme, dec_len)
    msgs = rng.integers(0, 256, (N, dec_len)).astype(np.uint8)
    bits = np.stack([np.unpackbits(conv_encode(scheme, m)) for m in msgs])
    llr = np.zeros(bits.shape, np.float32) if sigma is None else (
        (2.0 * bits - 1.0) * 4 + sigma * rng.standard_normal(bits.shape)
    ).astype(np.float32)
    fn = fn.to(dev)
    return fn, fn.obs(torch.from_numpy(llr).to(dev)), msgs


@pytest.mark.parametrize("scheme,N,dec_len,sigma", [
    ("v27", 512, 68, 1.0), ("v29", 512, 68, 1.0), ("v39", 512, 68, 1.0),
    ("v27p23", 64, 68, 0.8), ("v27p78", 64, 68, 0.5), ("v29p34", 64, 68, 0.8),
    ("v29p78", 64, 68, 0.5), ("v27", 1, 1, 1.0), ("v29", 37, 1, 1.0),
    ("v27", 64, 68, 0.0), ("v29", 64, 68, None), ("v29", 4, 2000, 1.0)])
def test_viterbi_acs_bit_equal_to_plain(dev, scheme, N, dec_len, sigma):
    # the kernel against its plain version on the card: bits and the
    # packed decisions; 2000 bytes of v29 keep the decisions in device
    # memory (T * ns / 8 > dec_smem_max()); noiseless metrics decode the
    # bytes sent
    from liquid_dsp_tpu_torch.ops.kernels import viterbi_acs as vk
    fn, obs, msgs = _viterbi_case(dev, scheme, N, dec_len, sigma,
                                  N + dec_len)
    n0 = vk.viterbi_acs.launches
    bits = vk.viterbi_acs(obs, fn.exp, fn.nout)
    kb, kd = vk.viterbi_acs(obs, fn.exp, fn.nout, decisions=True)
    pb, pd = vk.viterbi_acs_reference(obs, fn.exp, fn.nout, decisions=True)
    torch.cuda.synchronize()
    assert vk.viterbi_acs.launches == n0 + 2
    assert torch.equal(bits, pb) and torch.equal(kb, pb)
    assert torch.equal(kd, pd)
    if sigma == 0.0:
        np.testing.assert_array_equal(
            np.packbits(bits.cpu().numpy().astype(np.uint8), axis=-1), msgs)


def test_viterbi_acs_rejects_misplaced_tensors(dev):
    from liquid_dsp_tpu_torch.ops.kernels import viterbi_acs as vk
    obs = torch.zeros(2, 30, 2, device=dev)
    exp = torch.ones(64, 2, 2)
    with pytest.raises(ValueError, match="one device"):
        vk.viterbi_acs(obs, exp, 24)
    with pytest.raises(ValueError, match="r in"):
        vk.viterbi_acs(torch.zeros(2, 30, 4, device=dev),
                       torch.ones(64, 2, 4, device=dev), 24)


@pytest.mark.parametrize("cfg", [dict(fec1="golay2412"),
                                 dict(fec0="v27", fec1="none")])
def test_gmskframe_rx_stream_on_the_card_matches_the_cpu(dev, cfg):
    # B = 4 channels x 8192-sample blocks on the card and on the CPU:
    # valid, sample_index, bytes and both CRCs equal; the payload kernel
    # (codebook_argmax or viterbi_acs) launched once per block
    from liquid_dsp_tpu_torch.framing.gmskframe import (gmskframegen,
                                                        gmskframe_rx_stream)
    from liquid_dsp_tpu_torch.ops.kernels import viterbi_acs as vk
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(len(cfg))
    T, PL, B = 8192, 64, 4
    x = np.zeros((B, 4 * T), np.complex64)
    n_sent = 0
    for b in range(B - 1):
        pos = 500 + 900 * b
        while pos < 3 * T - 3000:
            h = rng.integers(0, 256, 8).astype(np.uint8)
            p = rng.integers(0, 256, PL).astype(np.uint8)
            f = gmskframegen(h, p, **cfg)
            x[b, pos:pos + len(f)] = f
            pos += len(f) + 700
            n_sent += 1
    x = (x * np.exp(1j * (0.0015 * np.arange(x.shape[1]) + 0.3))
         + 0.005 * (rng.standard_normal(x.shape)
                    + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
    cpu = gmskframe_rx_stream(T, PL, **cfg)
    card = gmskframe_rx_stream(T, PL, **cfg).to(dev)
    cc, cg = cpu.init(batch_shape=(B,)), card.init(batch_shape=(B,),
                                                   device=dev)
    counter = vk.viterbi_acs if "fec0" in cfg else cba.codebook_argmax
    n_launch = counter.launches
    n = 0
    for b in range(4):
        blk = torch.from_numpy(x[:, b * T:(b + 1) * T].copy())
        oc, cc = cpu(cc, blk)
        og, cg = card(cg, blk.to(dev))
        v = oc.valid
        for key in ("valid", "sample_index", "hdr_bytes", "hdr_ok",
                    "pay_bytes", "pay_ok"):
            a, g = getattr(oc, key), getattr(og, key).cpu()
            if key not in ("valid", "sample_index"):
                a, g = a[v], g[v]
            assert torch.equal(a, g), (b, key)
        assert bool((oc.hdr_ok & oc.pay_ok)[v].all())
        n += int(v.sum())
    assert n == n_sent
    assert counter.launches == n_launch + 4


def test_flexframe_conv_receiver_on_the_card_matches_the_cpu(dev):
    # flexframe_rx_stream with a v27 payload on the card and on the CPU
    from liquid_dsp_tpu_torch.framing.flexframe import (
        FLEXFRAME_H_USER, flexframe_rx_stream, flexframegen)
    from liquid_dsp_tpu_torch.ops.kernels import viterbi_acs as vk
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(6)
    T, PL = 4096, 64
    x = np.zeros((2, 4 * T), np.complex64)
    for chn, s0 in ((0, 700), (0, 7000), (1, 3000)):
        h = rng.integers(0, 256, FLEXFRAME_H_USER).astype(np.uint8)
        p = rng.integers(0, 256, PL).astype(np.uint8)
        f = flexframegen(h, p, fec0="v27", fec1="none")
        x[chn, s0:s0 + len(f)] = f
    x += (0.01 * (rng.standard_normal(x.shape)
                  + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
    cpu = flexframe_rx_stream(T, PL, fec0="v27", fec1="none")
    card = flexframe_rx_stream(T, PL, fec0="v27", fec1="none").to(dev)
    cc, cg = cpu.init(batch_shape=(2,)), card.init(batch_shape=(2,),
                                                   device=dev)
    n_launch = vk.viterbi_acs.launches
    n = 0
    for b in range(4):
        blk = torch.from_numpy(x[:, b * T:(b + 1) * T].copy())
        oc, cc = cpu(cc, blk)
        og, cg = card(cg, blk.to(dev))
        v = oc.valid
        for key in ("valid", "sample_index", "hdr_bytes", "hdr_ok",
                    "pay_bytes", "pay_ok"):
            a, g = getattr(oc, key), getattr(og, key).cpu()
            if key not in ("valid", "sample_index"):
                a, g = a[v], g[v]
            assert torch.equal(a, g), (b, key)
        assert bool((oc.hdr_ok & oc.pay_ok)[v].all())
        n += int(v.sum())
    assert n == 3
    assert vk.viterbi_acs.launches == n_launch + 4


def test_gmsk_entry_points_default_to_the_card(dev):
    # gmskframesync and GMSKFrameSync run on the card by default and
    # decode the reference frames gmsk_a and gmsk_b
    import pathlib
    from liquid_dsp_tpu_torch.framing.gmskframe import (GMSKFrameSync,
                                                        gmskframesync)
    torch.backends.cuda.matmul.allow_tf32 = False
    fg = dict(np.load(pathlib.Path(__file__).parent
                      / "golden/flexframe_golden.npz"))
    parts, want = [], []
    for tag, n, seed in (("gmsk_a", 40, 77), ("gmsk_b", 64, 91)):
        rl = int(fg[tag + "_len"][0])
        parts += [np.zeros(600, np.complex64), fg[tag][:rl]]
        want.append((lcg_bytes(8, seed), lcg_bytes(n, seed + 1)))
        r = gmskframesync(np.concatenate([np.zeros(40, np.complex64),
                                          fg[tag][:rl],
                                          np.zeros(40, np.complex64)]))
        assert r.crc_ok
        np.testing.assert_array_equal(r.payload, lcg_bytes(n, seed + 1))
    fs = GMSKFrameSync()
    assert fs.device.type == "cuda"
    got = fs.execute(np.concatenate(parts)) + fs.flush()
    assert len(got) == 2
    for (gh, hok, gp, pok, st), (h, p) in zip(got, want):
        assert hok and pok
        np.testing.assert_array_equal(gh, h)
        np.testing.assert_array_equal(gp, p)


def _ofdm_stream(rng, T, B, n_blk=3):
    """B channels of OFDM flexframes (64 bytes, golay2412, qpsk) at spaced
    offsets, some across block boundaries, CFO 0.002 rad/sample on
    channel 1, noise 0.01, plus a flush block."""
    from liquid_dsp_tpu_torch.framing.ofdmflexframe import ofdmflexframegen
    x = np.zeros((B, (n_blk + 1) * T), np.complex64)
    n_sent = 0
    for b in range(B - 1):
        pos = 300 + 1100 * b
        while pos < n_blk * T - 2500:
            h = rng.integers(0, 256, 8).astype(np.uint8)
            p = rng.integers(0, 256, 64).astype(np.uint8)
            f = ofdmflexframegen(h, p)
            x[b, pos:pos + len(f)] = f
            pos += len(f) + 1500
            n_sent += 1
    x[1] *= np.exp(1j * (0.002 * np.arange(x.shape[1]) + 0.3))
    x += 0.01 * (rng.standard_normal(x.shape)
                 + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64), n_sent


def test_ofdmflex_rx_stream_on_the_card_matches_the_cpu(dev):
    # B = 4 channels x 4096-sample blocks on the card and on the CPU:
    # valid and sample_index equal, the valid slots' message indices,
    # bytes and verdicts equal, cfo within 1e-5; codebook_argmax launched
    # twice per block (header and payload)
    from liquid_dsp_tpu_torch.framing.ofdmflex_stream import (
        ofdmflex_rx_stream)
    torch.backends.cuda.matmul.allow_tf32 = False
    T, B = 4096, 4
    x, n_sent = _ofdm_stream(np.random.default_rng(10), T, B)
    cpu = ofdmflex_rx_stream(T, 64, max_frames=8)
    card = ofdmflex_rx_stream(T, 64, max_frames=8).to(dev)
    cc, cg = cpu.init(batch_shape=(B,)), card.init(batch_shape=(B,),
                                                   device=dev)
    n_launch = cba.codebook_argmax.launches
    n = 0
    for b in range(4):
        blk = torch.from_numpy(x[:, b * T:(b + 1) * T].copy())
        oc, cc = cpu(cc, blk)
        og, cg = card(cg, blk.to(dev))
        v = oc.valid
        for key in ("valid", "sample_index", "hdr_msgs", "pay_msgs",
                    "hdr_bytes", "hdr_ok", "pay_bytes", "pay_ok"):
            a, g = getattr(oc, key), getattr(og, key).cpu()
            if key not in ("valid", "sample_index"):
                a, g = a[v], g[v]
            assert torch.equal(a, g), (b, key)
        if v.any():
            assert float((oc.cfo[v] - og.cfo.cpu()[v]).abs().max()) < 1e-5
        assert bool((oc.hdr_ok & oc.pay_ok)[v].all())
        n += int(v.sum())
    assert n == n_sent
    assert cba.codebook_argmax.launches == n_launch + 8


def test_ofdm_kernels_bit_equal_to_plain_on_the_ofdm_paths(dev):
    # codebook_argmax on the stream receiver's header and payload soft
    # bits, and viterbi_acs on a v27 payload's metrics as OFDMFlexFrameSync
    # hands them to its device decoder: bit-equal to the plain versions
    from liquid_dsp_tpu_torch.framing.ofdmflex_stream import (
        ofdmflex_rx_stream)
    from liquid_dsp_tpu_torch.framing.ofdmflexframe import (
        OFDMFlexFrameSync, ofdmflexframegen)
    from liquid_dsp_tpu_torch.ops.kernels import viterbi_acs as vk
    torch.backends.cuda.matmul.allow_tf32 = False
    T, B = 4096, 4
    x, _ = _ofdm_stream(np.random.default_rng(11), T, B)
    proc = ofdmflex_rx_stream(T, 64, max_frames=8).to(dev)
    c = proc.init(batch_shape=(B,), device=dev)
    _, c = proc(c, torch.from_numpy(x[:, :T].copy()).to(dev))
    data = proc.detect_demod(c, torch.from_numpy(x[:, T:2 * T].copy())
                             .to(dev))[3]
    for cw in (proc.hdr_dec.soft_bits(proc.header_llr(data)),
               proc.pay_dec.soft_bits(proc.payload_syms(data))):
        cw = cw.reshape(-1, 24).contiguous()
        bip = proc.pay_dec.bip
        assert torch.equal(cba.codebook_argmax(cw, bip),
                           cba.codebook_argmax_reference(cw, bip))
    rng = np.random.default_rng(12)
    h = rng.integers(0, 256, 8).astype(np.uint8)
    p = rng.integers(0, 256, 50).astype(np.uint8)
    f = ofdmflexframegen(h, p, fec0="v27", fec1="none")
    cap = np.zeros(12288, np.complex64)
    cap[900:900 + len(f)] = f
    cap = (cap + 0.01 * (rng.standard_normal(len(cap)) + 1j *
                         rng.standard_normal(len(cap)))).astype(np.complex64)
    fs = OFDMFlexFrameSync(block_len=4096)
    dfn = fs._device_decoder(50, "crc32", "v27", "none", "qpsk")[0]
    seen = []
    dfn.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    n_launch = vk.viterbi_acs.launches
    res = fs.execute(cap) + fs.flush()
    assert len(res) == 1 and res[0][3]
    np.testing.assert_array_equal(res[0][2], p)
    assert vk.viterbi_acs.launches == n_launch + 1 and len(seen) == 1
    obs = dfn.vit.obs(dfn.llr(seen[0]))
    kb, kd = vk.viterbi_acs(obs, dfn.vit.exp, dfn.vit.nout, decisions=True)
    pb, pd = vk.viterbi_acs_reference(obs, dfn.vit.exp, dfn.vit.nout,
                                      decisions=True)
    assert torch.equal(kb, pb) and torch.equal(kd, pd)


def test_ofdm_entry_points_default_to_the_card(dev):
    # ofdm_frame_sync, ofdmflexframesync and OFDMFlexFrameSync run on the
    # card by default and decode the reference frames offg_a and offg_b
    import pathlib
    from liquid_dsp_tpu_torch.framing.ofdmflexframe import (
        OFDMFlexFrameSync, ofdmflexframesync)
    from liquid_dsp_tpu_torch.multichannel.ofdm import (ofdm_frame_sync,
                                                        ofdm_params)
    torch.backends.cuda.matmul.allow_tf32 = False
    fg = dict(np.load(pathlib.Path(__file__).parent
                      / "golden/flexframe_golden.npz"))
    x = np.concatenate([np.zeros(30, np.complex64), fg["offg_a"],
                        np.zeros(30, np.complex64)])
    par = ofdm_params(64, 16)
    r, rc = ofdm_frame_sync(par, x, 20), ofdm_frame_sync(par, x, 20,
                                                          device="cpu")
    assert r.detected and r.sample_index == rc.sample_index == 30 + 176
    assert abs(r.cfo_hat - rc.cfo_hat) < 1e-6
    assert np.abs(r.data_syms - rc.data_syms).max() < 1e-4
    parts, want = [], []
    for tag, n, seed in (("offg_a", 64, 101), ("offg_b", 40, 113)):
        ro = ofdmflexframesync(np.concatenate(
            [np.zeros(30, np.complex64), fg[tag], np.zeros(30, np.complex64)]))
        assert ro.crc_ok
        np.testing.assert_array_equal(ro.payload, lcg_bytes(n, seed + 1))
        parts += [np.zeros(900, np.complex64), fg[tag]]
        want.append((lcg_bytes(8, seed), lcg_bytes(n, seed + 1)))
    fs = OFDMFlexFrameSync()
    assert fs.device.type == "cuda"
    got = fs.execute(np.concatenate(parts)) + fs.flush()
    assert len(got) == 2
    for (gh, hok, gp, pok, st), (h, p) in zip(got, want):
        assert hok and pok
        np.testing.assert_array_equal(gh, h)
        np.testing.assert_array_equal(gp, p)
