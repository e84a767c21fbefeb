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
symsync_pll_lms: its timing loop (slots, mask, loop state) bit-equal to
the plain version, its PLL + LMS as pll_lms (2e-4, decisions equal); the
fused tracker route against the sequential one likewise.
viterbi_acs: bit-equal bits and packed decisions (the same exact products,
sums in the same order, the same max and subtraction).
cvsd_scan: bit-equal bits and audio (the same roundings, one FMA in both).
eqlms_scan and eqrls_scan: bit-equal outputs and carries (the same
roundings in the same order, the lanes' butterflies as the plain version's
trees, one FMA in both).
The LDPC decoder: hard and ok equal to the CPU's wherever the CPU converged
(the CPU's tanh, log, exp and atanh differ in the last bits and can flip a
borderline row that did not); ldpc_bp bit-equal to its plain version on
the card, messages, decisions and parity (both add in slot order, the
pads' part as the plain version adds it, with the card's float32
functions).
suppress_scan: bit-equal keep masks and rankings (integer compares,
selects and counts).
StreamRunner: bit-equal to its proc on the card, 1e-4 of rms against the
CPU (the mixer's float32 phase from another libm).
The mesh (parallel/, the card repeated): the time-sharded FIRs bit-equal
to one device (each output sums the same taps in the same order); with
the mixer no further from a complex128 reference than 1.5 times one
device (its float32 phases round at other magnitudes from each shard's
closed-form start); the time-sharded receiver the same frames with
symbols within 2e-5 and the carry equal; StagePipeline bit-equal to the
chain.  A card mesh fed a host block gives what it gives on the card,
bit for bit.  A mesh of the card and the CPU: each shard bit-equal to a
mesh all on its own device for one FIR and the receiver, a FIR chain
within 1e-5 of rms of one device (the kernel against its plain
version), StagePipeline bit-equal to its stages run in turn.
"""
import pathlib

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
    (700, 4096, 31),             # many rows
    (4, 5000, 4200),             # above 48 KB of shared memory
    (3, 2051, 12001)])           # ragged T, odd taps
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


def test_firfilt_pallas_long_filter_on_the_card(dev):
    # firfilt(backend="pallas") above 4096 taps: one fir_real launch a
    # block, 1e-5 of rms against its plain version, the carry handed on
    from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
    from liquid_dsp_tpu_torch.ops.fir import firfilt
    h = firdes_kaiser(4200, 0.05, 60.0)
    card, cpu = firfilt(h, backend="pallas").to(dev), firfilt(
        h, backend="pallas")
    g = torch.Generator().manual_seed(42)
    blocks = [torch.complex(torch.randn(3, 3000, generator=g),
                            torch.randn(3, 3000, generator=g))
              for _ in range(2)]
    cg, cc = card.init((3,), device=dev), cpu.init((3,))
    n0 = fr.fir_real.launches
    for xb in blocks:
        yg, cg = card(cg, xb.to(dev))
        yc, cc = cpu(cc, xb)
        err = float((yg.cpu() - yc).abs().max() / yc.abs().square().mean()
                    .sqrt())
        assert err < 1e-5
    assert fr.fir_real.launches == n0 + 2
    assert torch.equal(cg.cpu(), cc)


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
    # symtrack_stream on the route the card's rule picks
    from liquid_dsp_tpu_torch.framing.symtrack import _use_fused, symtrack
    from liquid_dsp_tpu_torch.ops.kernels import pll_lms as pk
    from liquid_dsp_tpu_torch.ops.kernels import symsync_pll_lms as fk
    from liquid_dsp_tpu_torch.design.firdes import firdes_prototype
    rng = np.random.default_rng(3)
    up = np.zeros(1400, np.complex64)
    up[::2] = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, 700)))
    h = firdes_prototype("arkaiser", 2, 7, 0.3)
    x = 0.4 * np.exp(0.5j) * np.convolve(up, h)[:1400]
    x = (x + 0.004 * (rng.standard_normal(1400)
                      + 1j * rng.standard_normal(1400))).astype(np.complex64)
    kern = fk.symsync_pll_lms if _use_fused((), dev) else pk.pll_lms
    launches = kern.launches
    got = symtrack(x)
    assert kern.launches == launches + 1
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
    # the card's route (agc_scan, then conv1d + symsync_pll_lms, or
    # conv1d + symsync_scan and pll_lms, as the card's rule picks) against
    # the port on the CPU forced to the sequential hoisted route
    from liquid_dsp_tpu_torch.framing.symtrack import (Symtrack, _use_fused,
                                                       symtrack_stream)
    from liquid_dsp_tpu_torch.ops.kernels import agc_scan, pll_lms
    from liquid_dsp_tpu_torch.ops import symsync as ss
    from liquid_dsp_tpu_torch.ops.kernels import symsync_pll_lms as fk
    from liquid_dsp_tpu_torch.ops.kernels import symsync_scan
    # the conv must not follow the global flag
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 2048)) + 1j * rng.standard_normal(
        (3, 2048))).astype(np.complex64) * 0.3
    card = symtrack_stream().to(dev)
    cpu = symtrack_stream()
    def counts():
        return (agc_scan.agc_scan.launches,
                symsync_scan.symsync_scan.launches, pll_lms.pll_lms.launches,
                fk.symsync_pll_lms.launches)

    n = counts()
    fused = _use_fused((3,), dev)
    (yg, dg, vg), _ = card(card.init(batch_shape=(3,), device=dev),
                           torch.from_numpy(x).to(dev))
    run = ss.symsync_run
    monkeypatch.setattr(ss, "symsync_run",
                        lambda *a, **kw: run(*a, **kw, hoist=True))
    monkeypatch.setenv("LIQUID_SYMSYNC_KERNEL", "1")
    (yc, dc, vc), _ = cpu(cpu.init(batch_shape=(3,)), torch.from_numpy(x))
    assert counts() == ((n[0] + 1, n[1], n[2], n[3] + 1) if fused else
                        (n[0] + 1, n[1] + 1, n[2] + 1, n[3]))
    assert torch.equal(vg.cpu(), vc)
    assert float((yg.cpu()[vc] - yc[vc]).abs().max()) <= 2e-4
    assert torch.equal(dg.cpu()[vc], dc[vc])
    tracker = Symtrack(block_len=1024)          # the card by default
    assert tracker.device.type == "cuda"
    sy, dec = tracker.execute(x[0])
    assert len(sy) == len(dec) > 900


def _tracker_stream(B, n, seed, ms="qpsk"):
    """Symbols of `ms` at 2 samples/symbol through arkaiser(2, 7, 0.3),
    a carrier phase and a gain per channel, noise 0.01 a rail."""
    from liquid_dsp_tpu_torch.design.firdes import firdes_prototype
    from liquid_dsp_tpu_torch.modem import constellation
    rng = np.random.default_rng(seed)
    table = constellation(ms).astype(np.complex64)
    h = firdes_prototype("arkaiser", 2, 7, 0.3)
    x = np.empty((B, n), np.complex64)
    for ch in range(B):
        up = np.zeros(n, np.complex64)
        up[::2] = table[rng.integers(0, len(table), (n + 1) // 2)]
        gain = rng.uniform(0.3, 2.0) * np.exp(1j * rng.uniform(0, 2 * np.pi))
        x[ch] = gain * np.convolve(up, h)[:n] + 0.01 * (
            rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x


def test_fused_tracker_route_runs_on_the_card(dev, monkeypatch):
    # LIQUID_SYMTRACK_FUSED=1 on the card: agc_scan, then one
    # symsync_pll_lms launch a block on the input planes (the sequential
    # route: two branch_bank + symsync_scan chunks a block here, the second
    # ragged), against the sequential route on the same blocks
    from liquid_dsp_tpu_torch.framing.symtrack import symtrack_stream
    from liquid_dsp_tpu_torch.ops.kernels import pll_lms, symsync_scan
    from liquid_dsp_tpu_torch.ops.kernels import symsync_pll_lms as fk
    from liquid_dsp_tpu_torch.ops.symsync import _chunks
    B, T, NB = 6, 6000, 2
    x = torch.from_numpy(_tracker_stream(B, NB * T, 4)).to(dev)
    st = symtrack_stream().to(dev)
    outs, carries = {}, {}
    for route in ("0", "1"):
        monkeypatch.setenv("LIQUID_SYMTRACK_FUSED", route)
        n = (symsync_scan.symsync_scan.launches, pll_lms.pll_lms.launches,
             fk.symsync_pll_lms.launches)
        c, outs[route] = st.init(batch_shape=(B,), device=dev), []
        for b in range(NB):
            out, c = st(c, x[:, b * T:(b + 1) * T])
            outs[route].append(out)
        carries[route] = c
        got = (symsync_scan.symsync_scan.launches - n[0],
               pll_lms.pll_lms.launches - n[1],
               fk.symsync_pll_lms.launches - n[2])
        nch = len(_chunks(T, True))
        assert got == ((nch * NB, NB, 0) if route == "0"
                       else (0, 0, NB)), (route, got)
    for (ys, ds, vs), (yf, df, vf) in zip(outs["0"], outs["1"]):
        assert torch.equal(vs, vf) and int(vs.sum()) > T // 3
        assert torch.equal(ds, df)
        assert float((ys - yf).abs().max()) <= 2e-4
    for key in ("theta", "dtheta", "eq_w", "eq_buf", "eq_x2"):
        assert float((carries["0"][key] - carries["1"][key]).abs().max()) \
            <= 2e-4, key
    assert torch.equal(carries["0"]["eq_n"], carries["1"]["eq_n"])
    for key, v in carries["0"]["ss"].items():
        assert torch.equal(v, carries["1"]["ss"][key]), key


def test_foreign_post_raises_on_the_card(dev):
    # a Python post hook cannot run inside the fused kernel's recurrence
    from liquid_dsp_tpu_torch.ops import symsync as ss
    x = torch.zeros(2, 1024, dtype=torch.complex64, device=dev)
    q = ss.symsync().to(dev)
    with pytest.raises(NotImplementedError, match="Not carried over"):
        ss._symsync_run_hoisted(q.mf, q.dmf, q.init((2,), device=dev), x, 2,
                                post=lambda *a: a, post_carry={})


@pytest.mark.parametrize("P,B,Tc,m", [
    (2, 256, 1024, 7),        # the tracker's bank at its width
    (2, 33, 4096, 5),         # symsync's, a full chunk
    (1, 5, 509, 7),           # a real stream, Tc off a multiple of 4
    (2, 3, 700, 1),           # 4 taps a branch
    (2, 2, 3, 7)])            # less than a thread's 4 outputs
def test_branch_bank_bit_equal_to_plain(dev, P, B, Tc, m):
    # the same sums in the same order (csrc/branch_dot.cuh): bit-equal;
    # against cuDNN's full-float32 conv1d (another order) within 1e-5 of
    # rms; a view of wider planes (rows at a stride) gives the same
    import torch.nn.functional as F
    from liquid_dsp_tpu_torch.ops import symsync as ss
    from liquid_dsp_tpu_torch.ops.kernels import branch_bank as bk
    q = ss.symsync(k=2, m=m).to(dev)
    kern = ss.branch_kernel(q.mf, q.dmf, dev)
    Lb = kern.shape[1]
    g = torch.Generator(device=dev).manual_seed(P * B + Tc)
    wide = torch.randn(P, B, Tc + Lb + 40, generator=g, device=dev)
    planes = wide[..., 17:17 + Tc + Lb - 1]
    n0 = bk.branch_bank.launches
    ma = bk.branch_bank(planes, kern)
    ref = bk.branch_bank_reference(planes.contiguous(), kern)
    conv = F.conv1d(planes.reshape(P * B, 1, -1), kern[:, None].contiguous()
                    ).reshape(ma.shape)
    torch.cuda.synchronize()
    assert bk.branch_bank.launches == n0 + 1
    assert ma.shape == (P, B, 2 * 32, Tc) and torch.equal(ma, ref)
    assert float((ma - conv).abs().max() / conv.square().mean().sqrt()) \
        < 1e-5
    assert torch.equal(bk.branch_bank(planes.contiguous(), kern), ma)


def test_branch_bank_odd_banks_and_refusals(dev):
    # any row count and tap count up to LB_MAX, bit-equal; above it, and a
    # bank beyond the kernel's shared memory, refused on the card only
    from liquid_dsp_tpu_torch.ops.kernels import branch_bank as bk
    g = torch.Generator(device=dev).manual_seed(5)
    for R, Lb in ((1, 1), (3, 2), (10, 5), (7, 63), (40, 64)):
        kern = torch.randn(R, Lb, generator=g, device=dev)
        planes = torch.randn(2, 3, 600 + Lb - 1, generator=g, device=dev)
        assert torch.equal(bk.branch_bank(planes, kern),
                           bk.branch_bank_reference(planes, kern)), (R, Lb)
    planes = torch.zeros(1, 2, 100, device=dev)
    with pytest.raises(ValueError, match="taps"):
        bk.branch_bank(planes, torch.zeros(4, bk.LB_MAX + 1, device=dev))
    with pytest.raises(ValueError, match="bank"):
        bk.branch_bank(planes, torch.zeros(
            bk.BANK_MAX // bk.tap_pitch(8) + 1, 8, device=dev))
    with pytest.raises(ValueError, match="one device"):
        bk.branch_bank(planes, torch.zeros(4, 8))


def test_symsync_on_the_card_runs_branch_bank(dev):
    # symsync's hoisted path: per chunk one branch_bank and one
    # symsync_scan launch, no cuDNN convolution, and the same bits as the
    # plain versions on the CPU's hoisted path
    from liquid_dsp_tpu_torch.ops import symsync as ss
    from liquid_dsp_tpu_torch.ops.kernels import branch_bank as bk
    from liquid_dsp_tpu_torch.ops.kernels import symsync_scan as sk
    q = ss.symsync(k=2, m=5)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((3, 5000)) + 1j * rng.standard_normal(
        (3, 5000))).astype(np.complex64) * 0.5
    n0, n1 = bk.branch_bank.launches, sk.symsync_scan.launches
    yg, vg, _ = ss.symsync_run(q.mf.to(dev), q.dmf.to(dev),
                               q.init((3,), device=dev),
                               torch.from_numpy(x).to(dev), 2)
    torch.cuda.synchronize()
    nch = len(ss._chunks(5000, True))
    assert (bk.branch_bank.launches - n0, sk.symsync_scan.launches - n1) == \
        (nch, nch)
    # the CPU's chunks differ (2 of 2500): the loop is the same at any
    yc, vc, _ = ss.symsync_run(q.mf, q.dmf, q.init((3,)),
                               torch.from_numpy(x), 2, hoist=True)
    assert torch.equal(vg.cpu(), vc)
    assert torch.equal(torch.view_as_real(yg.cpu()), torch.view_as_real(yc))


def _fused_inputs(dev, st, B, n, seed, warm, ms="qpsk"):
    """Input planes, the bank, loop and PLL states of the tracker `st` on a
    stream: from the zero state, or after `warm` samples (a locked
    state)."""
    from liquid_dsp_tpu_torch.ops.symsync import branch_kernel, loop_state
    x = torch.from_numpy(_tracker_stream(B, warm + n, seed, ms)).to(dev)
    c = st.init(batch_shape=(B,), device=dev)
    if warm:
        _, c = st(c, x[:, :warm])
    y, _ = st.ag(c["agc"], x[:, warm:])
    xp = torch.cat([c["ss"]["win"][..., 1:], y], -1)
    planes = torch.stack([xp.real, xp.imag]).contiguous()
    fs, is_ = loop_state(c["ss"], B)
    return (planes, branch_kernel(st.ss.mf, st.ss.dmf, dev), fs, is_,
            st.pll_state(c, B))


@pytest.mark.parametrize("ms,L,B,Tc,warm", [
    ("qpsk", 13, 256, 1024, 4096),     # the tracker's own shape, locked
    ("qam16", 32, 40, 700, 4096),      # the argmin slicer, 32 taps
    ("qpsk", 13, 33, 509, 0),          # ragged, from the zero state
    ("psk8", 20, 5, 31, 2048),         # less than one tile
    ("qpsk", 1, 9, 300, 2048)])        # one tap
def test_symsync_pll_lms_matches_plain(dev, ms, L, B, Tc, warm):
    from liquid_dsp_tpu_torch.framing.symtrack import symtrack_stream
    from liquid_dsp_tpu_torch.ops.kernels import symsync_pll_lms as fk
    st = symtrack_stream(ms=ms, eq_len=L).to(dev)
    planes, kern, fs, is_, pc = _fused_inputs(dev, st, B, Tc, B + Tc, warm,
                                              ms)
    kw = dict(npfb=32, max_out=3, k=2, k_out=1, bw=st.sync_bw, locked=False)
    want = fk.symsync_pll_lms_reference(planes, kern, fs, is_, pc, st.post,
                                        **kw)
    # the filter warp at the full bank (no misses) and at 8 and 3 rows a
    # step (the chain filters what the window misses): the same bits
    for win in (None, 8, 3):
        launches = fk.symsync_pll_lms.launches
        got = fk.symsync_pll_lms(planes, kern, fs, is_, pc, st.post, win=win,
                                 **kw)
        torch.cuda.synchronize()
        assert fk.symsync_pll_lms.launches == launches + 1
        assert got.misses.shape == (B,) and (win is not None or int(
            got.misses.sum()) == 0)
        # the timing loop bit for bit, the PLL + LMS at the stream tolerance
        for name in ("valid", "fstate", "istate"):
            assert torch.equal(getattr(got, name), getattr(want, name)), \
                (name, win)
        assert int(want.valid.sum()) > Tc // 3
        assert float((got.y_re - want.y_re).abs().max()) <= 2e-4
        assert float((got.y_im - want.y_im).abs().max()) <= 2e-4
        assert torch.equal(got.dec, want.dec)
        assert torch.equal(got.pll_state["eq_n"], want.pll_state["eq_n"])
        for key in want.pll_state:
            assert float((got.pll_state[key].float()
                          - want.pll_state[key].float()).abs().max()) \
                <= 2e-4, key


def test_symsync_pll_lms_equals_the_two_kernels(dev):
    # one piece through the fused kernel against branch_bank, symsync_scan
    # then pll_lms on its slots: the same device code, so the same bits;
    # then a second piece with the dot handed on against pll_lms over both
    # pieces' slots
    from liquid_dsp_tpu_torch.framing.symtrack import symtrack_stream
    from liquid_dsp_tpu_torch.ops.kernels import pll_lms as pk
    from liquid_dsp_tpu_torch.ops.kernels import symsync_pll_lms as fk
    from liquid_dsp_tpu_torch.ops.kernels import symsync_scan as sk
    from liquid_dsp_tpu_torch.ops.kernels.branch_bank import branch_bank
    st = symtrack_stream().to(dev)
    planes, kern, fs, is_, pc = _fused_inputs(dev, st, 64, 1400, 3, 2048)
    kw = dict(npfb=32, max_out=3, k=2, k_out=1, bw=st.sync_bw, locked=False)
    Lb = kern.shape[1]
    halves = (planes[..., :700 + Lb - 1], planes[..., 700:])
    f1 = fk.symsync_pll_lms(halves[0], kern, fs, is_, pc, st.post, **kw)
    f2 = fk.symsync_pll_lms(halves[1], kern, f1.fstate, f1.istate,
                            f1.pll_state, st.post, **kw)
    s1 = sk.symsync_scan(branch_bank(halves[0], kern), fs, is_, **kw)
    s2 = sk.symsync_scan(branch_bank(halves[1], kern), s1[3], s1[4], **kw)
    y_re, y_im, dec, pc2 = pk.pll_lms(
        torch.cat([s1[0], s2[0]], -1), torch.cat([s1[1], s2[1]], -1),
        torch.cat([s1[2], s2[2]], -1), pc, st.tab_re, st.tab_im,
        **st.pll_kwargs())
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([f1.valid, f2.valid], -1),
                       torch.cat([s1[2], s2[2]], -1))
    assert torch.equal(f2.fstate, s2[3]) and torch.equal(f2.istate, s2[4])
    assert torch.equal(torch.cat([f1.dec, f2.dec], -1), dec)
    for a, b in ((torch.cat([f1.y_re, f2.y_re], -1), y_re),
                 (torch.cat([f1.y_im, f2.y_im], -1), y_im)):
        assert float((a - b).abs().max()) <= 2e-4
    for key in pk.STATE_KEYS:
        assert float((f2.pll_state[key].float() - pc2[key].float()).abs()
                     .max()) <= 2e-4, key


def test_symsync_pll_lms_refuses(dev):
    from liquid_dsp_tpu_torch.framing.symtrack import symtrack_stream
    from liquid_dsp_tpu_torch.ops.kernels import pll_lms as pk
    from liquid_dsp_tpu_torch.ops.kernels import symsync_pll_lms as fk
    kw = dict(npfb=32, max_out=3, k=2, k_out=1, bw=0.02, locked=False)
    st = symtrack_stream(eq_len=pk.LMAX + 1).to(dev)
    planes, kern, fs, is_, pc = _fused_inputs(dev, st, 2, 64, 0, 0)
    with pytest.raises(ValueError, match="equalizer"):
        fk.symsync_pll_lms(planes, kern, fs, is_, pc, st.post, **kw)
    st = symtrack_stream().to(dev)
    planes, kern, fs, is_, pc = _fused_inputs(dev, st, 2, 64, 0, 0)
    # a branch of more taps than the kernel's register walk takes: on the
    # card only
    wide = torch.zeros(64, 65, device=dev)
    with pytest.raises(ValueError, match="taps"):
        fk.symsync_pll_lms(torch.zeros(2, 2, 128, device=dev), wide, fs, is_,
                           pc, st.post, **kw)
    with pytest.raises(ValueError, match="one device"):
        fk.symsync_pll_lms(planes, kern, fs, is_, pc, st.post.cpu(), **kw)


def test_per_step_loops_raise_on_the_card(dev):
    # the CPU-only per-step loops refuse CUDA tensors instead of running
    # one launch per op on the card: symsync's scan body, and the LMS
    # equalizer with a caller's slicer (a Python callable per sample); the
    # equalizers' own modes run on their kernels
    from liquid_dsp_tpu_torch.ops import equalize as eq
    from liquid_dsp_tpu_torch.ops import symsync as ss
    from liquid_dsp_tpu_torch.ops.kernels.eqlms_scan import eqlms_scan
    from liquid_dsp_tpu_torch.ops.kernels.eqrls_scan import eqrls_scan
    x = torch.zeros(2, 512, dtype=torch.complex64, device=dev)
    q = ss.symsync().to(dev)
    with pytest.raises(ValueError, match="scan body"):
        ss.symsync_run(q.mf, q.dmf, q.init((2,), device=dev), x, 2,
                       hoist=False)
    lms = eq.eqlms(5, slicer=lambda y: y)
    with pytest.raises(NotImplementedError, match="eqlms on the card"):
        lms(lms.init((2,), device=dev), x)
    n0, n1 = eqlms_scan.launches, eqrls_scan.launches
    lms = eq.eqlms(5)
    lms(lms.init((2,), device=dev), x)
    rls = eq.eqrls(5)
    rls(rls.init((2,), device=dev), (x, x))
    assert (eqlms_scan.launches, eqrls_scan.launches) == (n0 + 1, n1 + 1)


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
    ("v27", 64, 68, 0.0), ("v29", 64, 68, None), ("v29", 4, 2000, 1.0),
    ("v27", 2048, 68, 0.8), ("v29", 2048, 68, 1.0), ("v39", 2048, 68, 0.0),
    ("v27", 16, 5, 0.8)])
def test_viterbi_acs_bit_equal_to_plain(dev, scheme, N, dec_len, sigma):
    # the kernel against its plain version on the card: bits and the
    # packed decisions; 2000 bytes of v29 keep the decisions in device
    # memory (T * ns / 8 > dec_smem_max()); noiseless metrics decode the
    # bytes sent; 2048 codewords put several warps on each scheduler, and
    # 5 bytes of v27 (T = 46) end inside the warp form's first tile
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


@pytest.mark.parametrize("ns,r,N,T", [(32, 2, 64, 300), (512, 2, 64, 300),
                                       (1024, 3, 8, 200), (512, 3, 4, 900),
                                       (128, 2, 64, 300)])
def test_viterbi_acs_other_trellis_sizes(dev, ns, r, N, T):
    # the block form (ns of 32, 512, 1024) and the warp form at ns = 128
    # (no decoder's trellis) on random +-1 tables; 900 steps at ns = 512
    # leave shared memory
    from liquid_dsp_tpu_torch.ops.kernels import viterbi_acs as vk
    rng = np.random.default_rng(ns + T)
    exp = torch.from_numpy(rng.choice(np.float32([-1, 1]), (ns, 2, r))
                           ).to(dev)
    obs = torch.from_numpy(rng.standard_normal((N, T, r)).astype(
        np.float32)).to(dev)
    kb, kd = vk.viterbi_acs(obs, exp, T - 8, decisions=True)
    bits = vk.viterbi_acs(obs, exp, T - 8)
    pb, pd = vk.viterbi_acs_reference(obs, exp, T - 8, decisions=True)
    torch.cuda.synchronize()
    assert torch.equal(bits, pb) and torch.equal(kb, pb)
    assert torch.equal(kd, pd)


@pytest.mark.parametrize("scheme", ["v27", "v29"])
def test_viterbi_acs_without_bits_keeps_decisions(dev, scheme):
    # nout = 0 skips the traceback: no bits, the same packed decisions
    from liquid_dsp_tpu_torch.ops.kernels import viterbi_acs as vk
    fn, obs, _ = _viterbi_case(dev, scheme, 64, 68, 0.8, 3)
    kb, kd = vk.viterbi_acs(obs, fn.exp, 0, decisions=True)
    _, pd = vk.viterbi_acs_reference(obs, fn.exp, 0, decisions=True)
    torch.cuda.synchronize()
    assert kb.shape == (64, 0) and torch.equal(kd, pd)


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


# --- the multi-rate Procs and paths: the card against the CPU --------------

_GOLDEN = pathlib.Path(__file__).parent / "golden"
_MR_NAMES = ["firdecim4", "firinterp4", "firinterp3_29", "resamp_3_2",
             "resamp_2_3", "firhilb", "firhilb_r2c", "firhilb_interp",
             "autocorr", "resamp2_interp", "msresamp2_interp2", "qmf",
             "resamp_127_100"]


def _mr_proc(name):
    """(Proc, real input, block length) of a card case."""
    from liquid_dsp_tpu_torch import chain
    from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
    from liquid_dsp_tpu_torch.ops import fir, resample
    h = firdes_kaiser(48, 0.1, 60.0)
    return {
        "firdecim4": (fir.firdecim(4, h), False, 4096),
        "firinterp4": (fir.firinterp(4, h), False, 1024),
        "firinterp3_29": (fir.firinterp(3, h[:29]), False, 1000),
        "resamp_3_2": (resample.resamp((3, 2)), False, 4096),
        "resamp_2_3": (resample.resamp((2, 3)), False, 3072),
        "firhilb": (fir.firhilb(5), True, 4096),
        "firhilb_r2c": (fir.firhilb_r2c(5), True, 2000),
        "firhilb_interp": (fir.firhilb_interp(5), False, 2000),
        "autocorr": (fir.autocorr(16, 4), False, 2000),
        "resamp2_interp": (resample.resamp2_interp(7), False, 2048),
        "msresamp2_interp2": (resample.msresamp2("interp", 2), False, 2048),
        "qmf": (chain(resample.resamp2_analyzer(7),
                      resample.resamp2_synthesizer(7)), False, 2048),
        "resamp_127_100": (resample.resamp((127, 100)), False, 1200)}[name]


def _stream(p, blocks, dev):
    c = p.init(batch_shape=(blocks[0].shape[0],), device=dev)
    ys = []
    for x in blocks:
        y, c = p(c, x.to(dev))
        assert y.device.type == dev.type
        ys.append(y.cpu())
    return torch.cat(ys, dim=-1)


@pytest.mark.parametrize("name", _MR_NAMES)
def test_multirate_proc_card_matches_cpu(dev, name):
    # the card's forms (banded matmuls, the gather on the card) against the
    # CPU's (convolutions), 4 channels x 2 carried blocks, 2e-5 of rms
    g = torch.Generator().manual_seed(len(name))
    p, real, n = _mr_proc(name)
    blocks = [torch.randn(4, n, generator=g) if real else
              torch.randn(4, n, dtype=torch.complex64, generator=g)
              for _ in range(2)]
    y_cpu = _stream(p, blocks, torch.device("cpu"))
    y_card = _stream(p.to(dev), blocks, dev)
    rms = y_cpu.abs().square().mean().sqrt()
    assert float((y_card - y_cpu).abs().max() / rms) < 2e-5


def _mr_path(kind):
    from liquid_dsp_tpu_torch import chain, fuse, kernel_fuse
    from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser, firdes_rrcos
    from liquid_dsp_tpu_torch.ops import fir, nco, resample
    if kind == "rx":
        front = kernel_fuse(fuse(chain(
            nco.nco(dphi=0.125, direction="down"),
            fir.firfilt(firdes_kaiser(64, 0.2, 60.0)),
            fir.firdecim(4, firdes_kaiser(48, 0.1, 60.0)))))
        return chain(front, resample.msresamp(0.375))
    return chain(fir.firinterp(2, firdes_rrcos(2, 7, 0.35)),
                 resample.msresamp(2.5), nco.nco(dphi=0.125, direction="up"))


def test_multirate_rx_card_matches_cpu(dev):
    # one mix_fir_decim launch per block at down 4; 2e-4 of rms against
    # the CPU (the kernel's plain version, the class convolutions)
    g = torch.Generator().manual_seed(31)
    blocks = [torch.randn(8, n, dtype=torch.complex64, generator=g)
              for n in (8192, 4096, 8192)]
    p = _mr_path("rx")
    y_cpu = _stream(p, blocks, torch.device("cpu"))
    n0 = mfd.mix_fir_decim.launches
    y_card = _stream(p.to(dev), blocks, dev)
    assert mfd.mix_fir_decim.launches == n0 + 3
    assert y_card.shape == (8, 20480 * 3 // 32)
    rms = y_cpu.abs().square().mean().sqrt()
    assert float((y_card - y_cpu).abs().max() / rms) < 2e-4


def test_multirate_tx_card_matches_cpu(dev):
    # QPSK symbols at unit power: 2e-5 absolute (tests/test_resample.py:321)
    g = torch.Generator().manual_seed(32)
    blocks = []
    for _ in range(3):
        b = torch.randint(0, 2, (2, 8, 2048), generator=g) * 2.0 - 1
        blocks.append(torch.complex(b[0], b[1]) / 2 ** 0.5)
    p = _mr_path("tx")
    y_cpu = _stream(p, blocks, torch.device("cpu"))
    y_card = _stream(p.to(dev), blocks, dev)
    assert y_card.shape == (8, 3 * 5 * 2048)
    assert float((y_card - y_cpu).abs().max()) < 2e-5


def test_resample_goldens_on_card(dev):
    # the reference C library's vectors, 1e-5 (tests/test_resample.py)
    from liquid_dsp_tpu_torch.ops import resample as r
    fg = dict(np.load(_GOLDEN / "flexframe_golden.npz"))
    lohi = np.stack([fg["qmf_lo"], fg["qmf_hi"]])
    cases = [(r.resamp((2, 3), 7, 0.25, 60.0, 64), "resamp_23_x",
              fg["resamp_23_y"]),
             (r.resamp((5, 4), 7, 0.25, 60.0, 64), "resamp_54_x",
              fg["resamp_54_y"]),
             (r.resamp2_decim(7, 0.0, 60.0), "r2_x", fg["r2_decim"]),
             (r.resamp2_interp(7, 0.0, 60.0), "r2_x", fg["r2_interp"]),
             (r.resamp2_analyzer(5, 60.0), "qmf_x", lohi),
             (r.resamp2_synthesizer(5, 60.0), lohi, fg["qmf_z"]),
             (r.msresamp2("decim", 2, 0.4, 0.0, 60.0), "ms2_x", fg["ms2_d"]),
             (r.msresamp2("interp", 2, 0.4, 0.0, 60.0), "ms2_x", fg["ms2_i"])]
    for p, x, want in cases:
        x = torch.from_numpy(fg[x] if isinstance(x, str) else x).to(dev)
        p = p.to(dev)
        y = p(p.init(dtype=x.dtype, device=dev), x)[0]
        assert y.device.type == "cuda"
        assert np.abs(y.cpu().numpy() - want).max() < 1e-5, p.name


@pytest.mark.parametrize("stem", sorted(
    f.stem for f in _GOLDEN.glob("firdecim_*.npz")))
def test_firdecim_golden_on_card(dev, stem):
    # tests/conftest.py:93's assert_close tolerance, 1e-3
    from liquid_dsp_tpu_torch.ops.fir import firdecim
    d = {k[len(stem) + 1:]: v
         for k, v in np.load(_GOLDEN / f"{stem}.npz").items()}
    p = firdecim(int(stem.split("_M")[1][0]), d["h"]).to(dev)
    x = torch.from_numpy(d["x"]).to(dev)
    y = p(p.init(dtype=x.dtype, device=dev), x)[0]
    assert y.shape == d["y"].shape
    assert np.abs(y.cpu().numpy() - d["y"]).max() <= 1e-3


# --- the IIR recurrences, the channel model and the analog paths ---------

def _draw(g, dev, cplx, *shape, scale=1.0):
    dt = torch.complex64 if cplx else torch.float32
    return torch.randn(*shape, dtype=dt, generator=g, device=dev) * scale


def _bits(t):
    return torch.view_as_real(t) if t.is_complex() else t


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("ns,n", [(1, 2), (1, 3), (1, 5), (1, 9), (1, 17),
                                  (2, 3), (4, 3), (8, 3),
                                  # the wide form (the state in shared)
                                  (1, 18), (1, 25), (1, 33), (1, 200),
                                  # split cascades, a launch a group
                                  (9, 3), (12, 3), (17, 3), (2, 4), (3, 20)])
def test_iir_scan_bit_equal_to_plain(dev, ns, n, cplx):
    # the same roundings in the same order: bit-equal outputs and state,
    # 70 rows (a ragged warp), T = 203 (a ragged last tile), and the carry
    # handed on: two calls equal one (the second's rows start unaligned);
    # then 70 x 1000 and 5 x 31 (rows not a multiple of 32, T not one of
    # the 32- or 16-sample tile).  A cascade the kernel does not take in
    # one launch runs as launch_groups' launches, each section's
    # arithmetic unchanged: the same bits
    from liquid_dsp_tpu_torch.ops.kernels.iir_scan import (
        iir_scan, iir_scan_reference, launch_groups)
    g = torch.Generator(device=dev).manual_seed(ns * 20 + n)
    x = _draw(g, dev, cplx, 70, 203)
    b, a = _draw(g, dev, cplx, ns, n, scale=0.3), _draw(g, dev, cplx, ns, n,
                                                       scale=0.3 / n)
    s = _draw(g, dev, cplx, 70, ns, n - 1)
    k0 = iir_scan.launches
    y, s2 = iir_scan(x, b, a, s)
    ya, sa = iir_scan(x[:, :77].contiguous(), b, a, s)
    yb, sb = iir_scan(x[:, 77:].contiguous(), b, a, sa)
    yr, sr = iir_scan_reference(x, b, a, s)
    torch.cuda.synchronize()
    assert iir_scan.launches == k0 + 3 * len(launch_groups(ns, n))
    assert torch.equal(_bits(y), _bits(yr)) and torch.equal(_bits(s2),
                                                            _bits(sr))
    assert torch.equal(_bits(torch.cat([ya, yb], -1)), _bits(y))
    assert torch.equal(_bits(sb), _bits(s2))
    for rows, T in ((70, 1000), (5, 31)):
        x = _draw(g, dev, cplx, rows, T)
        s = _draw(g, dev, cplx, rows, ns, n - 1)
        y, s2 = iir_scan(x, b, a, s)
        yr, sr = iir_scan_reference(x, b, a, s)
        assert torch.equal(_bits(y), _bits(yr)), (rows, T)
        assert torch.equal(_bits(s2), _bits(sr)), (rows, T)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("p", list(range(1, 9)) + [12, 16, 17, 32])
def test_iir_block_state_bit_equal_to_plain(dev, p, cplx):
    # 70 rows (a ragged last block at every width), 37 block steps (a
    # ragged last chunk), the carry handed on at step 10
    from liquid_dsp_tpu_torch.ops.kernels.iir_block_state import (
        iir_block_state, iir_block_state_reference)
    g = torch.Generator(device=dev).manual_seed(p)
    w = _draw(g, dev, cplx, 70, 37, p)
    m = _draw(g, dev, cplx, p, p, scale=0.5 / p)
    s = _draw(g, dev, cplx, 70, p)
    k0 = iir_block_state.launches
    pre, s2 = iir_block_state(w, m, s)
    pa, sa = iir_block_state(w[:, :10].contiguous(), m, s)
    pb, sb = iir_block_state(w[:, 10:].contiguous(), m, sa)
    pr, sr = iir_block_state_reference(w, m, s)
    torch.cuda.synchronize()
    assert iir_block_state.launches == k0 + 3
    assert torch.equal(_bits(pre), _bits(pr))
    assert torch.equal(_bits(s2), _bits(sr))
    assert torch.equal(_bits(torch.cat([pa, pb], 1)), _bits(pre))
    assert torch.equal(_bits(sb), _bits(s2))


def test_iir_kernels_refuse_what_they_do_not_take(dev):
    # on the card only: a section above the wide form's MAX_WIDE_N
    # coefficients, a block state pass above 32 states, and tensors on two
    # devices
    from liquid_dsp_tpu_torch.ops.kernels.iir_block_state import (
        iir_block_state)
    from liquid_dsp_tpu_torch.ops.kernels.iir_scan import (MAX_WIDE_N,
                                                           iir_scan)
    x = torch.zeros(4, 64, device=dev)
    n = MAX_WIDE_N + 1
    with pytest.raises(ValueError, match="coefficients"):
        iir_scan(x, torch.ones(1, n, device=dev), torch.ones(1, n, device=dev),
                 torch.zeros(4, 1, n - 1, device=dev))
    with pytest.raises(ValueError, match="states"):
        iir_block_state(torch.zeros(4, 3, 33, device=dev),
                        torch.eye(33, device=dev),
                        torch.zeros(4, 33, device=dev))
    with pytest.raises(ValueError, match="one device"):
        iir_scan(x, torch.ones(1, 2), torch.ones(1, 2),
                 torch.zeros(4, 1, 1, device=dev))


def test_block_backend_refuses_more_than_32_states_on_the_card(dev):
    # an explicit 'block' above the state pass kernel's 32 lanes builds,
    # runs on the CPU and is refused at the call on a CUDA tensor; 'auto'
    # takes the scan there, which takes any order
    from liquid_dsp_tpu_torch.design.iirdes import iirdes_sos
    from liquid_dsp_tpu_torch.ops import iir as P
    from liquid_dsp_tpu_torch.ops.kernels.iir_scan import iir_scan
    B, A = iirdes_sos("butter", 33, 0.2)       # 34 states, stable
    x = torch.randn(2, 300, dtype=torch.complex64)
    q = P.iirfilt_sos(B, A, backend="block")
    y_cpu, _ = q(q.init((2,)), x)
    assert bool(torch.isfinite(torch.view_as_real(y_cpu)).all())
    q = q.to(dev)
    with pytest.raises(ValueError, match="at most 32 states"):
        q(q.init((2,), device=dev), x.to(dev))
    auto = P.iirfilt_sos(B, A).to(dev)
    n0 = iir_scan.launches
    y, _ = auto(auto.init((2,), device=dev), x.to(dev))
    assert iir_scan.launches == n0 + 3      # 17 sections: 8 + 8 + 1
    scan = P.iirfilt_sos(B, A, backend="scan")
    yr, _ = scan(scan.init((2,)), x)
    assert torch.equal(torch.view_as_real(y.cpu()), torch.view_as_real(yr))


def _iir_cases():
    from liquid_dsp_tpu_torch.design.iirdes import iirdes, iirdes_sos
    d = np.load(_GOLDEN / "iirfilt_cccf_data_h5x64.npz")
    stem = "iirfilt_cccf_data_h5x64_"
    return {**{f"butter{n}": ("sos", iirdes_sos("butter", n, 0.17))
               for n in (1, 2, 5, 8, 12, 16)},
            "ellip6": ("sos", iirdes_sos("ellip", 6, 0.2)),
            "cheby1_tf5": ("tf", iirdes("cheby1", 5, 0.2)),
            "cccf_h5": ("tf", (d[stem + "b"], d[stem + "a"]))}


@pytest.mark.parametrize("name", ["butter1", "butter2", "butter5", "butter8",
                                  "ellip6", "cheby1_tf5", "cccf_h5",
                                  "butter12", "butter16"])
def test_iir_backends_on_the_card_match_the_cpu(dev, name):
    # scan (iir_scan) and block (iir_block_state) on the card against the
    # CPU's scan, over blocks of 1000 and 333 samples (T % L != 0), carried:
    # 1e-4 of rms (the JAX package's block-versus-scan bound)
    from liquid_dsp_tpu_torch.ops import iir
    form, (b, a) = _iir_cases()[name]
    make = iir.iirfilt_sos if form == "sos" else iir.iirfilt
    g = torch.Generator().manual_seed(len(name))
    blocks = [torch.randn(6, n, dtype=torch.complex64, generator=g)
              for n in (1000, 333)]
    y_cpu = _stream(make(b, a, backend="scan"), blocks, torch.device("cpu"))
    rms = y_cpu.abs().square().mean().sqrt()
    from liquid_dsp_tpu_torch.ops.kernels.iir_block_state import (
        iir_block_state)
    from liquid_dsp_tpu_torch.ops.kernels.iir_scan import iir_scan
    for backend, kern in (("scan", iir_scan), ("block", iir_block_state),
                          ("auto", iir_block_state)):
        k0 = kern.launches
        y = _stream(make(b, a, backend=backend).to(dev), blocks, dev)
        assert kern.launches == k0 + 2, backend
        assert float((y - y_cpu).abs().max() / rms) < 1e-4, backend


def test_unstable_filter_runs_the_scan_kernel_on_the_card(dev):
    from liquid_dsp_tpu_torch.ops import iir
    from liquid_dsp_tpu_torch.ops.kernels.iir_scan import iir_scan
    q = iir.iirfilt([1.0], [1.0, -1.01])
    x = torch.ones(3, 500)
    y_cpu, _ = q(q.init((3,), dtype=torch.float32), x)
    k0 = iir_scan.launches
    q = q.to(dev)
    y, _ = q(q.init((3,), dtype=torch.float32, device=dev), x.to(dev))
    assert iir_scan.launches == k0 + 1
    assert float((y.cpu() - y_cpu).abs().max() / y_cpu.abs().max()) < 1e-5


def _pscan_case(g, dev, cplx, rows, T, ns):
    """x, b, a and a carry for iir_pscan: stable biquads (poles inside
    0.95; complex ones rotated; b scaled by 1 - r, so that 65 sections
    stay finite), unit input, a random carry."""
    dt = torch.complex64 if cplx else torch.float32
    r = 0.3 + 0.65 * torch.rand(ns, generator=g, device=dev)
    th = 0.1 + 2.9 * torch.rand(ns, generator=g, device=dev)
    a = torch.stack([torch.ones_like(r), -2 * r * torch.cos(th), r * r],
                    1).to(dt)
    if cplx:
        w = (0.6 * torch.rand(ns, 1, generator=g, device=dev) - 0.3) \
            * torch.tensor([1.0, 2.0], device=dev)
        a[:, 1:] = a[:, 1:] * torch.polar(torch.ones_like(w), w)
    b = _draw(g, dev, cplx, ns, 3) * (1 - r)[:, None]
    return (_draw(g, dev, cplx, rows, T), b, a.contiguous(),
            _draw(g, dev, cplx, rows, ns, 2))


# (rows, whole tiles, extra samples, sections); a tile is CHUNK * THREADS;
# the last two: the ring of two tiles wraps (3 whole tiles and a ragged
# fourth, 16-byte copies), and 65 sections in two launches across it
_PSCAN_CASES = [(1, 0, 1, 1), (3, 0, 31, 4), (128, 1, 0, 4), (3, 2, 37, 8),
                (1, 3, -1, 20), (128, 1, 5, 1), (3, 0, 1000, 65),
                (128, 3, 8, 4), (2, 3, 4, 65)]


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("rows,tiles,extra,ns", _PSCAN_CASES)
def test_iir_pscan_bit_equal_to_plain(dev, rows, tiles, extra, ns, cplx):
    # one sample, less than a chunk's warp, one whole tile, ragged
    # multiples of the tile, 1 to 20 sections in one launch and 65 in two
    # (launch_groups); from a random carry, then the carry handed on to a
    # second call: outputs and carries bit-equal to the plain version
    from liquid_dsp_tpu_torch.ops.kernels.iir_pscan import (
        CHUNK, THREADS, iir_pscan, iir_pscan_reference, launch_groups)
    T = tiles * CHUNK[cplx] * THREADS + extra
    g = torch.Generator(device=dev).manual_seed(rows * 1000 + T + ns)
    x, b, a, s = _pscan_case(g, dev, cplx, rows, T, ns)
    x2 = _draw(g, dev, cplx, rows, 333)
    k0 = iir_pscan.launches
    y, s2 = iir_pscan(x, b, a, s)
    y2, s3 = iir_pscan(x2, b, a, s2)
    torch.cuda.synchronize()
    assert iir_pscan.launches == k0 + 2 * len(launch_groups(ns))
    yr, sr = iir_pscan_reference(x, b, a, s)
    y2r, s3r = iir_pscan_reference(x2, b, a, sr)
    assert bool(torch.isfinite(_bits(y)).all())
    assert torch.equal(_bits(y), _bits(yr)) and torch.equal(_bits(s2),
                                                            _bits(sr))
    assert torch.equal(_bits(y2), _bits(y2r))
    assert torch.equal(_bits(s3), _bits(s3r))


@pytest.mark.parametrize("cplx", [False, True])
def test_iir_pscan_rows_not_on_16_bytes(dev, cplx):
    # x and y one float past a 16-byte boundary, and a T whose rows are not
    # 16-byte multiples: the float-by-float copies, bit-equal to the plain
    # version
    from liquid_dsp_tpu_torch.ops.kernels.iir_pscan import (
        CHUNK, THREADS, iir_pscan, iir_pscan_reference)
    g = torch.Generator(device=dev).manual_seed(11)
    for rows, T, off in ((3, 2 * CHUNK[cplx] * THREADS + 6, 1),
                         (2, CHUNK[cplx] * THREADS + 1, 0)):
        x, b, a, s = _pscan_case(g, dev, cplx, rows, T, 3)
        buf = torch.empty(rows * T + off, dtype=x.dtype, device=dev)
        xo = buf[off:].view(rows, T)
        xo.copy_(x)
        y, s2 = iir_pscan(xo, b, a, s)
        yr, sr = iir_pscan_reference(x, b, a, s)
        torch.cuda.synchronize()
        assert torch.equal(_bits(y), _bits(yr)) and torch.equal(_bits(s2),
                                                                _bits(sr))


def test_iir_pscan_on_the_cpu_and_without_a_library(dev, monkeypatch,
                                                    tmp_path):
    # a CPU tensor never launches the kernel; a CUDA tensor with no kernel
    # library raises (no plain version on the card), and a source nvcc
    # refuses fails the build
    from liquid_dsp_tpu_torch.ops.kernels import build
    from liquid_dsp_tpu_torch.ops.kernels import iir_pscan as ip
    g = torch.Generator(device=dev).manual_seed(5)
    x, b, a, s = _pscan_case(g, dev, False, 2, 100, 2)
    k0 = ip.iir_pscan.launches
    y, _ = ip.iir_pscan(*(t.cpu() for t in (x, b, a, s)))
    assert ip.iir_pscan.launches == k0 and y.device.type == "cpu"

    def no_library():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(build, "load_library", no_library)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ip.iir_pscan(x, b, a, s)
    assert ip.iir_pscan.launches == k0
    monkeypatch.undo()
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "broken.cu").write_text("this is not C++\n")
    monkeypatch.setattr(build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build()


@pytest.mark.parametrize("design", [("butter", 7, 0.2), ("butter", 16, 0.2),
                                    ("ellip", 6, 0.3)])
def test_pscan_backend_on_the_card_equals_the_cpu(dev, design):
    # iirfilt_sos(backend="pscan") on a complex stream: the card launches
    # iir_pscan once a block on the stream's planes, and equals the CPU's
    # plain version bit for bit (the same chunks, tiles and roundings),
    # over blocks of 20000 and 333 samples, carried; and it stays within
    # 1e-4 of rms of the scan on the card
    from liquid_dsp_tpu_torch.design.iirdes import iirdes_sos
    from liquid_dsp_tpu_torch.ops import iir
    from liquid_dsp_tpu_torch.ops.kernels.iir_pscan import iir_pscan
    B, A = iirdes_sos(*design)
    g = torch.Generator().manual_seed(design[1])
    blocks = [torch.randn(4, n, dtype=torch.complex64, generator=g)
              for n in (20000, 333)]
    y_cpu = _stream(iir.iirfilt_sos(B, A, backend="pscan"), blocks,
                    torch.device("cpu"))
    k0 = iir_pscan.launches
    y = _stream(iir.iirfilt_sos(B, A, backend="pscan").to(dev), blocks, dev)
    assert iir_pscan.launches == k0 + 2
    assert torch.equal(_bits(y), _bits(y_cpu))
    y_scan = _stream(iir.iirfilt_sos(B, A, backend="scan").to(dev), blocks,
                     dev)
    rms = y_scan.abs().square().mean().sqrt()
    assert float((y - y_scan).abs().max() / rms) < 1e-4


@pytest.mark.parametrize("design", [("butter", 7, 0.2), ("butter", 24, 0.2)])
def test_scan_on_the_planes_equals_the_complex_rows_on_the_card(
        dev, design, monkeypatch):
    # iirfilt_sos(backend="scan") on a complex block runs iir_scan on the
    # stream's float32 plane rows, and its outputs and carries equal those
    # of iir_scan over complex64 rows with the coefficients cast to
    # complex64 (the route before the planes), over two carried blocks;
    # butter 24 is 12 sections, two launches a call
    from liquid_dsp_tpu_torch.design.iirdes import iirdes_sos
    from liquid_dsp_tpu_torch.ops import iir
    from liquid_dsp_tpu_torch.ops.kernels.iir_scan import (iir_scan,
                                                           launch_groups)
    B, A = iirdes_sos(*design)
    ns = B.shape[0]
    q = iir.iirfilt_sos(B, A, backend="scan").to(dev)
    g = torch.Generator().manual_seed(ns)
    blocks = [torch.randn(8, n, dtype=torch.complex64, generator=g).to(dev)
              for n in (20000, 333)]
    rows = []

    def rec(x, b, a, s):
        rows.append((tuple(x.shape), x.dtype, b.dtype))
        return iir_scan(x, b, a, s)

    monkeypatch.setattr(iir, "iir_scan", rec)
    c = cc = q.init(batch_shape=(8,), device=dev)
    bc, ac = q.B.to(torch.complex64), q.A.to(torch.complex64)
    for x in blocks:
        k0 = iir_scan.launches
        y, c = q(c, x)
        assert iir_scan.launches == k0 + len(launch_groups(ns, 3))
        yc, cc = iir._scan(bc, ac, cc, x, kernel=iir_scan)
        assert torch.equal(y, yc) and torch.equal(c, cc)
    assert rows == [((16, n), torch.float32, torch.float32)
                    for n in (20000, 333)]


def _analog(kind, noise):
    from liquid_dsp_tpu_torch import chain
    from liquid_dsp_tpu_torch.design.iirdes import iirdes_sos
    from liquid_dsp_tpu_torch.modem.analog import (freq_demodulator,
                                                   freq_modulator)
    from liquid_dsp_tpu_torch.ops.channel import channel
    from liquid_dsp_tpu_torch.ops.iir import iirfilt_dc_blocker, iirfilt_sos
    from liquid_dsp_tpu_torch.ops.misc_filters import iirdecim
    if kind == "tx":
        kw = dict(dphi=0.001, multipath_taps=np.asarray(
            [1.0, 0.12 - 0.05j, -0.06j, 0.03 + 0.02j], np.complex64))
        if noise:
            kw.update(snr_db=30.0, shadowing_std=1.0, shadowing_fd=0.001)
        return chain(freq_modulator(0.1), channel(**kw))
    return chain(iirfilt_sos(*iirdes_sos("butter", 7, 0.2)),
                 freq_demodulator(0.1), iirdecim(4), iirfilt_dc_blocker(0.01))


def test_analog_paths_on_the_card_match_the_cpu(dev):
    # tx without noise: 1e-5 absolute at unit amplitude; rx on the card's tx
    # output with noise: 1e-4 of rms (block form on the card, scan on the
    # CPU)
    t = torch.arange(3 * 4096, dtype=torch.float64)
    m = (0.6 * torch.cos(2 * np.pi * 0.013 * t)
         + 0.3 * torch.cos(2 * np.pi * 0.037 * t)).float().repeat(4, 1)
    blocks = list(m.split(4096, dim=-1))
    y_cpu = _stream(_analog("tx", False), blocks, torch.device("cpu"))
    y_card = _stream(_analog("tx", False).to(dev), blocks, dev)
    assert float((y_card - y_cpu).abs().max()) < 1e-5
    x = _stream(_analog("tx", True).to(dev), blocks, dev)
    xb = list(x.split(4096, dim=-1))
    r_cpu = _stream(_analog("rx", False), xb, torch.device("cpu"))
    r_card = _stream(_analog("rx", False).to(dev), xb, dev)
    assert r_card.shape == (4, 3 * 1024)
    rms = r_cpu.square().mean().sqrt()
    assert float((r_card - r_cpu).abs().max() / rms) < 1e-4


def test_channel_noise_and_shadowing_on_the_card(dev):
    # statistics as tests/test_torch_channel.py: the noise floor's power
    # within 5%, the shadowing's spread within 10%; one generator state per
    # carry, reproducible from the seed
    from liquid_dsp_tpu_torch.ops.channel import channel
    q = channel(snr_db=20.0, noise_floor_db=-40.0, seed=1).to(dev)
    z, _ = q(q.init((8,), device=dev),
             torch.zeros(8, 20000, dtype=torch.complex64, device=dev))
    assert abs(float(z.abs().square().mean()) / 1e-4 - 1) < 0.05
    q = channel(shadowing_std=2.0, shadowing_fd=0.05, seed=4).to(dev)
    c = q.init((8,), device=dev)
    x = torch.ones(8, 8192, dtype=torch.complex64, device=dev)
    y1, c1 = q(c, x)
    y2, _ = q(c, x)
    assert torch.equal(y1, y2)
    g_db = 20 * torch.log10(y1.abs())
    assert abs(float(g_db.std()) / 2.0 - 1) < 0.1


# --- the support slice: cvsd_scan, the LDPC decoder, StreamRunner -----------

def _cvsd_voice(dev, R, T):
    g = torch.Generator(device=dev).manual_seed(R * 7 + T)
    t = torch.arange(T, device=dev, dtype=torch.float32)
    f = 0.001 + 0.02 * torch.rand(R, 1, generator=g, device=dev)
    return (0.7 * torch.sin(2 * np.pi * f * t)
            + 0.05 * torch.randn(R, T, generator=g, device=dev)).clamp(-1, 1)


# the kernel's tiles are 64 samples in two halves of 32, staged 6 ahead, 4
# rows a block: T at a half tile and a tile -1, 0, +1, just past 6 tiles,
# T = 1 and T not a multiple of 4 (uint8 rows that start off a 4-byte
# word), R at 4 -1, +1, 1 and ragged blocks
@pytest.mark.parametrize("R,T", [(1, 1), (3, 7), (33, 1000), (64, 4097),
                                 (100, 64), (1, 31), (5, 32), (3, 33),
                                 (4, 193), (5, 1001), (1, 4097), (2, 63),
                                 (3, 65), (4, 385)])
@pytest.mark.parametrize("zeta", [1.5, 1.37])
def test_cvsd_scan_bit_equal_to_plain(dev, R, T, zeta):
    from liquid_dsp_tpu_torch.ops.kernels.cvsd_scan import (
        cvsd_scan, cvsd_scan_reference)
    x = _cvsd_voice(dev, R, T)
    n0 = cvsd_scan.launches
    bits = cvsd_scan(x, True, zeta=zeta)
    audio = cvsd_scan(bits, False, zeta=zeta)
    audio32 = cvsd_scan(bits.to(torch.int32), False, zeta=zeta)
    torch.cuda.synchronize()
    assert cvsd_scan.launches == n0 + 3
    assert torch.equal(bits, cvsd_scan_reference(x, True, zeta=zeta))
    assert torch.equal(audio, cvsd_scan_reference(bits, False, zeta=zeta))
    assert torch.equal(audio32, audio)


@pytest.mark.parametrize("num_bits", [1, 8, 31])
def test_cvsd_scan_num_bits_on_the_card(dev, num_bits):
    # every step agrees (1), all 8 bit planes of a byte (8), the widest
    # mask (31); decode also on bytes other than 0 and 1 (shifted into
    # bitref whole, as the plain version takes them) and on a view whose
    # first row starts 3 bytes into a word
    from liquid_dsp_tpu_torch.ops.kernels.cvsd_scan import (
        cvsd_scan, cvsd_scan_reference)
    kw = dict(num_bits=num_bits, zeta=1.37)
    x = _cvsd_voice(dev, 5, 1001)
    bits = cvsd_scan(x, True, **kw)
    assert torch.equal(bits, cvsd_scan_reference(x, True, **kw))
    assert torch.equal(cvsd_scan(bits, False, **kw),
                       cvsd_scan_reference(bits, False, **kw))
    g = torch.Generator(device=dev).manual_seed(num_bits)
    flat = torch.randint(0, 2, (3 + 5 * 1001,), generator=g, device=dev,
                         dtype=torch.uint8)
    flat[::7] = torch.randint(0, 256, (716,), generator=g, device=dev,
                              dtype=torch.uint8)
    b = flat[3:].view(5, 1001)
    assert b.data_ptr() % 4 == 3 and b.is_contiguous()
    assert torch.equal(cvsd_scan(b, False, **kw),
                       cvsd_scan_reference(b, False, **kw))


def test_cvsd_on_the_card_equals_the_golden():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from liquid_dsp_tpu_torch.utils.audio import cvsd_decode, cvsd_encode
    g = dict(np.load(pathlib.Path(__file__).parent / "golden"
                     / "flexframe_golden.npz"))
    x = np.real(g["cvsd_x"]).astype(np.float32)
    bits = cvsd_encode(x)          # the card by default
    np.testing.assert_array_equal(bits.astype(np.int32),
                                  np.real(g["cvsd_bits"]).astype(np.int32))
    assert np.abs(cvsd_decode(bits) - np.real(g["cvsd_xr"])).max() < 1e-4


@pytest.mark.parametrize("min_sum", [False, True])
def test_ldpc_decoder_on_the_card_matches_the_cpu(dev, min_sum):
    # hard and ok equal wherever the CPU converged (reductions in another
    # order can flip a borderline row that did not)
    from liquid_dsp_tpu_torch.fec.ldpc import (ldpc_decoder_device,
                                               ldpc_encode_systematic,
                                               make_regular_ldpc)
    H = make_regular_ldpc(96, 48, col_weight=3, seed=1)
    rng = np.random.default_rng(7)
    cws = np.stack([ldpc_encode_systematic(
        H, rng.integers(0, 2, 48).astype(np.uint8))[0] for _ in range(64)])
    y = 1.0 - 2.0 * cws + 0.7 * rng.standard_normal(cws.shape)
    llr = (2 * y / 0.49).astype(np.float32)
    hc, okc = ldpc_decoder_device(H, 30, min_sum, device="cpu")(llr)
    hd, okd = ldpc_decoder_device(H, 30, min_sum)(llr)
    assert hd.device.type == "cuda" and hd.dtype == torch.int32
    hd, okd = hd.cpu(), okd.cpu()
    assert okc.sum() > 48
    assert torch.equal(hd[okc], hc[okc]) and bool(okd[okc].all())
    assert (hd[okd].numpy() == cws[okd.numpy()]).all()


def test_stream_runner_on_the_card_equals_the_proc(dev, tmp_path):
    from liquid_dsp_tpu_torch import chain
    from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
    from liquid_dsp_tpu_torch.ops.fir import firfilt
    from liquid_dsp_tpu_torch.ops.nco import nco
    from liquid_dsp_tpu_torch.runtime import StreamRunner

    def make():
        return chain(nco(dphi=0.1, direction="down"),
                     firfilt(firdes_kaiser(32, 0.2, 60.0)))

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 4096))
         + 1j * rng.standard_normal((4, 4096))).astype(np.complex64)
    r = StreamRunner(make(), batch_shape=(4,))          # the card
    proc = make().to(dev)
    c = proc.init(batch_shape=(4,), device=dev)
    ys = []
    for k, blk in enumerate(np.split(x, 4, axis=-1)):
        y = r(blk)
        yd, c = proc(c, torch.from_numpy(blk).to(dev))
        assert y.device.type == "cuda" and torch.equal(y, yd)
        ys.append(y)
        if k == 1:
            r.save(tmp_path / "s.npz")
    r2 = StreamRunner(make(), batch_shape=(4,))
    r2.load(tmp_path / "s.npz")
    for blk, y in zip(np.split(x, 4, axis=-1)[2:], ys[2:]):
        assert torch.equal(r2(blk), y)
    rc = StreamRunner(make(), batch_shape=(4,), device="cpu")
    yc = torch.cat([rc(b) for b in np.split(x, 4, axis=-1)], dim=-1)
    err = (torch.cat(ys, dim=-1).cpu() - yc).abs().max()
    assert float(err / yc.abs().square().mean().sqrt()) < 1e-4


def test_stream_runner_counts_its_host_copies(dev):
    # numpy and CPU-tensor blocks are copied to the card and counted, in
    # the span runtime.h2d under the profiler; a block on the card is not
    from torch.profiler import ProfilerActivity, profile

    from liquid_dsp_tpu_torch import chain, trace
    from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
    from liquid_dsp_tpu_torch.ops.fir import firfilt
    from liquid_dsp_tpu_torch.ops.nco import nco
    from liquid_dsp_tpu_torch.runtime import StreamRunner

    r = StreamRunner(chain(nco(dphi=0.1), firfilt(firdes_kaiser(32, 0.2,
                                                                60.0))),
                     batch_shape=(4,))
    x = np.ones((4, 4096), np.complex64)
    r(x)
    assert r.h2d_bytes == x.nbytes
    r(torch.from_numpy(x).to(dev))
    assert r.h2d_bytes == x.nbytes
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        r(torch.from_numpy(x))
    assert r.h2d_bytes == 2 * x.nbytes
    got = {s.name: s for s in trace.spans()}
    assert got["runtime.h2d"].parent == got["runtime.call"].id
    assert got["runtime.h2d"].block == 2
    trace.clear()
    r.reset()
    assert r.h2d_bytes == 0


# --- the equalizers ------------------------------------------------------

def _eq_case(dev, B, T, L, real, seed):
    """x, d [B, T] and a carry (w, buf [B, L], x2_sum, n [B], P [B, L, L])
    that is not the Procs' start: weights, window and P off their initial
    values, n below and above L."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def cn(*shape):
        v = torch.randn(*shape, 2, generator=g, device=dev)
        return v[..., 0] if real else torch.view_as_complex(v)

    buf = cn(B, L)
    P = torch.eye(L, device=dev) * 5 + 0.01 * cn(B, L, L)
    return dict(x=0.7 * cn(B, T), d=cn(B, T), w=0.3 * cn(B, L), buf=buf,
                x2_sum=buf.abs().square().sum(-1),
                n=torch.randint(0, 2 * L, (B,), generator=g, device=dev,
                                dtype=torch.int32),
                P=P.to(buf.dtype))


def _lms_pair(a, mode, mu=0.3):
    from liquid_dsp_tpu_torch.ops.kernels.eqlms_scan import (
        eqlms_scan, eqlms_scan_reference)
    args = (a["x"], a["w"], a["buf"], a["x2_sum"], a["n"], mu)
    d = a["d"] if mode == "trained" else None
    n0 = eqlms_scan.launches
    got = eqlms_scan(*args, d=d)
    torch.cuda.synchronize()
    launched = eqlms_scan.launches - n0
    return got, eqlms_scan_reference(*args, d=d), launched


def _rls_pair(a, lam=0.99):
    from liquid_dsp_tpu_torch.ops.kernels.eqrls_scan import (
        eqrls_scan, eqrls_scan_reference)
    args = (a["x"], a["d"], a["w"], a["buf"], a["P"], lam)
    n0 = eqrls_scan.launches
    got = eqrls_scan(*args)
    torch.cuda.synchronize()
    launched = eqrls_scan.launches - n0
    return got, eqrls_scan_reference(*args), launched


def _bit_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(torch.view_as_real(g) if g.is_complex() else g,
                           torch.view_as_real(w) if w.is_complex() else w)


@pytest.mark.parametrize("L", [1, 5, 13, 31, 32])
@pytest.mark.parametrize("mode", ["trained", "decision", "decision_real"])
def test_eqlms_scan_bit_equal_to_plain(dev, mode, L):
    # T = 0, 1, L-1, L and 1000 (whole tiles and a ragged one); 3 channels
    # (ragged warps at L <= 16)
    for T in sorted({0, 1, max(L - 1, 0), L, 1000}):
        a = _eq_case(dev, 3, T, L, mode == "decision_real", L * 1000 + T)
        got, want, launched = _lms_pair(a, mode)
        assert launched == (1 if T else 0)
        _bit_equal(got, want)


@pytest.mark.parametrize("B", [1, 257])
@pytest.mark.parametrize("L", [5, 13, 32])
@pytest.mark.parametrize("mode", ["trained", "decision", "decision_real"])
def test_eqlms_scan_channels_bit_equal_to_plain(dev, mode, L, B):
    a = _eq_case(dev, B, 1000, L, mode == "decision_real", B + L)
    got, want, _ = _lms_pair(a, mode)
    _bit_equal(got, want)


@pytest.mark.parametrize("L", [1, 5, 13, 31, 32])
@pytest.mark.parametrize("real", [False, True])
def test_eqrls_scan_bit_equal_to_plain(dev, real, L):
    for T in sorted({0, 1, max(L - 1, 0), L, 1000}):
        a = _eq_case(dev, 3, T, L, real, L * 1000 + T + 7)
        got, want, launched = _rls_pair(a)
        assert launched == (1 if T else 0)
        _bit_equal(got, want)


@pytest.mark.parametrize("B", [1, 257])
@pytest.mark.parametrize("L", [5, 9, 32])
def test_eqrls_scan_channels_bit_equal_to_plain(dev, L, B):
    a = _eq_case(dev, B, 1000, L, False, B * 3 + L)
    got, want, _ = _rls_pair(a, lam=0.995)
    _bit_equal(got, want)


def _carried(pair, keys, a, T1, **kw):
    """Two carried blocks of a's stream (T1 samples, then the rest) through
    pair(...): each block's kernel result bit-equal to its plain version,
    the second block from the kernel's carry (`keys`, in the order the
    kernel returns it)."""
    blocks = [dict(a, x=a["x"][:, :T1], d=a["d"][:, :T1]),
              dict(a, x=a["x"][:, T1:], d=a["d"][:, T1:])]
    carry = {k: a[k] for k in keys}
    for blk in blocks:
        blk.update(carry)
        got, want, launched = pair(blk, **kw)
        assert launched == 1
        _bit_equal(got, want)
        carry = dict(zip(keys, got[1:]))


@pytest.mark.parametrize("L", [1, 2, 8, 9, 13, 16, 17, 32])
@pytest.mark.parametrize("mode", ["trained", "decision", "decision_real"])
def test_eqlms_scan_instances_over_two_blocks(dev, mode, L):
    # every instance (LM = 8, 16, 32 lanes, each mode): 3 channels (not a
    # multiple of a warp's 4 or 2 at LM = 8, 16), a first block shorter
    # than a tile, a second of 3 tiles and 5 samples (the gains two tiles
    # ahead, a ragged tile)
    from liquid_dsp_tpu_torch.ops.kernels.eqlms_scan import lanes
    LM = lanes(L)
    a = _eq_case(dev, 3, LM // 2 + 3 * LM + 5, L, mode == "decision_real",
                 L * 31 + 3)
    _carried(_lms_pair, ("w", "buf", "x2_sum", "n"), a, LM // 2,
             mode=mode)


@pytest.mark.parametrize("L", list(range(1, 33)))
@pytest.mark.parametrize("real", [False, True])
def test_eqrls_scan_instances_over_two_blocks(dev, real, L):
    # every instance (one per L, two lanes a row at 2 <= L <= 16): 3
    # channels (not a multiple of a warp's 2 or 4 at L <= 8), a first block
    # of 5 samples (shorter than any tile), a second of two tiles of the
    # widest layout and 3 samples
    from liquid_dsp_tpu_torch.ops.kernels.eqlms_scan import lanes
    a = _eq_case(dev, 3, 5 + 4 * lanes(L) + 3, L, real, L * 37 + 11)
    _carried(_rls_pair, ("w", "buf", "P"), a, 5)


def test_equalizer_kernels_take_views_and_batch_shapes(dev):
    # non-contiguous x and d (every other sample, and a transposed
    # block), a (2, 3) batch through the Procs; each equals its plain
    # version on the card, and the card equals the CPU
    from liquid_dsp_tpu_torch.ops import equalize as eq
    a = _eq_case(dev, 6, 2000, 13, False, 5)
    for key in ("x", "d"):
        a[key] = a[key][:, ::2]
        assert not a[key].is_contiguous()
    for mode in ("trained", "decision"):
        got, want, launched = _lms_pair(a, mode)
        assert launched == 1
        _bit_equal(got, want)
    a = _eq_case(dev, 6, 700, 9, False, 6)
    for key in ("x", "d"):
        a[key] = a[key].t().contiguous().t()
        assert not a[key].is_contiguous()
    got, want, launched = _rls_pair(a)
    assert launched == 1
    _bit_equal(got, want)
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(2, 3, 600, dtype=torch.complex64, device=dev,
                    generator=g)
    d = torch.randn(2, 3, 600, dtype=torch.complex64, device=dev,
                    generator=g)
    for q, blk in ((eq.eqlms(13, 0.2), (x, d)), (eq.eqlms(13, 0.05), x),
                   (eq.eqrls(9), (x, d))):
        c = q.init((2, 3), device=dev)
        y, c2 = q(c, blk)
        cc = {k: v.cpu() for k, v in c.items()}
        yc, c2c = q(cc, tuple(t.cpu() for t in blk)
                    if isinstance(blk, tuple) else blk.cpu())
        assert y.shape == (2, 3, 600) and y.device.type == "cuda"
        _bit_equal([y.cpu()] + [c2[k].cpu() for k in sorted(c2)],
                   [yc] + [c2c[k] for k in sorted(c2c)])


def test_equalizer_kernels_refuse_what_they_do_not_take(dev):
    from liquid_dsp_tpu_torch.ops.kernels.eqlms_scan import eqlms_scan
    from liquid_dsp_tpu_torch.ops.kernels.eqrls_scan import eqrls_scan
    a = _eq_case(dev, 2, 64, 33, False, 9)
    with pytest.raises(ValueError, match="1 to 32 taps"):
        eqlms_scan(a["x"], a["w"], a["buf"], a["x2_sum"], a["n"], 0.1)
    with pytest.raises(ValueError, match="1 to 32 taps"):
        eqrls_scan(a["x"], a["d"], a["w"], a["buf"], a["P"], 0.99)
    a = _eq_case(dev, 2, 64, 5, False, 10)
    with pytest.raises(NotImplementedError, match="custom slicer"):
        eqlms_scan(a["x"], a["w"], a["buf"], a["x2_sum"], a["n"], 0.1,
                   slicer=lambda y: y)
    m = {k: v.to("meta") for k, v in a.items()}
    with pytest.raises(ValueError, match="device"):
        eqlms_scan(m["x"], m["w"], m["buf"], m["x2_sum"], m["n"], 0.1)
    with pytest.raises(ValueError, match="device"):
        eqrls_scan(m["x"], m["d"], m["w"], m["buf"], m["P"], 0.99)
    with pytest.raises(ValueError, match="one device"):
        eqlms_scan(a["x"].cpu(), a["w"], a["buf"], a["x2_sum"], a["n"], 0.1)


# --- the mesh (parallel/) on one card, its device repeated ----------------

def _rel(y, ref):
    return float((y - ref).abs().max() / ref.abs().square().mean().sqrt())


def _cnoise(dev, shape, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.complex(torch.randn(shape, generator=g, device=dev),
                         torch.randn(shape, generator=g, device=dev))


def _mixed_ref64(xs, dphi, taps):
    """complex128: the blocks xs joined, mixed down by dphi * n from phase
    0 in closed form, then each FIR of taps in turn from a zero state
    (FFT convolution)."""
    x = torch.cat(xs, dim=-1).to(torch.complex128)
    n = torch.arange(x.shape[-1], dtype=torch.float64, device=x.device)
    y = x * torch.polar(torch.ones_like(n), -dphi * n)
    for h in taps:
        h = h.to(x.device, torch.float64)
        nfft = 1 << (y.shape[-1] + h.shape[0] - 2).bit_length()
        y = torch.fft.ifft(torch.fft.fft(y, n=nfft)
                           * torch.fft.fft(h, n=nfft))[..., :y.shape[-1]]
    return y


@pytest.mark.parametrize("mix", [False, True])
def test_time_sharded_chain_on_the_card(dev, mix):
    from liquid_dsp_tpu_torch import chain
    from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
    from liquid_dsp_tpu_torch.ops.fir import firfilt
    from liquid_dsp_tpu_torch.ops.nco import nco
    from liquid_dsp_tpu_torch.parallel import stream_mesh, time_shard_apply
    stages = [firfilt(firdes_kaiser(64, 0.2, 60.0), backend="pallas"),
              firfilt(firdes_kaiser(57, 0.3, 60.0), backend="pallas")]
    if mix:
        stages.insert(0, nco(dphi=0.125, direction="down"))
    p = chain(*stages).to(dev)
    step = time_shard_apply(p, stream_mesh(4, 2, devices=[dev] * 8))
    xs = [_cnoise(dev, (16, 32768), 40 + k) for k in range(2)]
    c_sh, ys = p.init(batch_shape=(16,), device=dev), []
    fr.fir_real.launches = 0
    for x in xs:
        y, c_sh = step(c_sh, x)
        ys.append(y)
    torch.cuda.synchronize()
    assert fr.fir_real.launches == 2 * 8 * len(xs)   # 2 stages x 8 shards
    c1, y1s = p.init(batch_shape=(16,), device=dev), []
    for x, y in zip(xs, ys):
        y1, c1 = p(c1, x)
        assert y.device == x.device and y.shape == y1.shape
        y1s.append(y1)
        if not mix:
            # each output sample sums the same taps in the same order
            assert torch.equal(y, y1)
    if not mix:
        assert all(torch.equal(a, b) for a, b in zip(c_sh, c1))
        return
    assert torch.equal(c_sh[0]["theta"], c1[0]["theta"])
    # the mixer's float32 phases reach dphi * T on one device, dphi * T / 4
    # from each shard's closed-form start: against complex128 the sharded
    # chain is no further off than one device, within 1.5 times
    ref = _mixed_ref64(xs, 0.125, [st.h for st in p.stages[1:]])
    e_sh = _rel(torch.cat(ys, dim=-1).to(ref.dtype), ref)
    e_1 = _rel(torch.cat(y1s, dim=-1).to(ref.dtype), ref)
    assert e_sh <= 1.5 * e_1


def test_time_sharded_receiver_on_the_card(dev):
    from liquid_dsp_tpu_torch.framing.frame64 import (
        FRAME64_LEN, framegen64, framesync64_stream)
    from liquid_dsp_tpu_torch.parallel import (framesync64_time_sharded,
                                               stream_mesh)
    torch.backends.cuda.matmul.allow_tf32 = False
    T, n, K = 16384, 4, 3
    Tl = T // n
    rng = np.random.default_rng(44)
    x = np.zeros((2, K * T), np.complex64)
    for s0 in (Tl - 300, 2 * Tl, 3 * Tl - 1536 - 100, T - 700,
               2 * T + Tl - 400):
        f = framegen64(rng.integers(0, 256, 8).astype(np.uint8),
                       rng.integers(0, 256, 64).astype(np.uint8))
        x[0, s0:s0 + FRAME64_LEN] += f
    x += (0.004 * (rng.standard_normal(x.shape)
                   + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
    xd = torch.from_numpy(x).to(dev)
    init, step = framesync64_time_sharded(
        T, stream_mesh(n, devices=[dev] * n), max_frames_per_shard=4)
    rx1 = framesync64_stream(T, max_frames=16).to(dev)
    cs, c1 = init(batch_shape=(2,)), rx1.init(batch_shape=(2,), device=dev)
    got, ref = {}, {}
    for k in range(K):
        blk = xd[:, k * T:(k + 1) * T]
        o, cs = step(cs, blk)
        o1, c1 = rx1(c1, blk)
        for out, into in ((o, got), (o1, ref)):
            v = out.valid.cpu().numpy()
            si = out.sample_index.cpu().numpy()
            sy = out.symbols.cpu().numpy()
            for ch, p in zip(*np.nonzero(v)):
                into[(ch, int(si[ch, p]))] = sy[ch, p]
    assert set(got) == set(ref) and len(ref) == 5
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], atol=2e-5)
    for key in ("buf", "base", "last_end"):
        assert torch.equal(cs[key], c1[key])


def test_stage_pipeline_on_the_card(dev):
    from liquid_dsp_tpu_torch import chain, fuse, kernel_fuse
    from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
    from liquid_dsp_tpu_torch.ops.fir import firdecim, firfilt
    from liquid_dsp_tpu_torch.ops.nco import nco
    from liquid_dsp_tpu_torch.ops.resample import msresamp
    from liquid_dsp_tpu_torch.parallel import StagePipeline

    def stages():
        return [kernel_fuse(fuse(chain(
                    nco(dphi=0.125, direction="down"),
                    firfilt(firdes_kaiser(64, 0.2, 60.0)),
                    firdecim(4, firdes_kaiser(48, 0.1, 60.0))))),
                msresamp(0.375)]
    blocks = _cnoise(dev, (3, 8, 8192), 45)
    pipe = StagePipeline(stages(), devices=[dev], batch_shape=(8,))
    mfd.mix_fir_decim.launches = 0
    ys = [pipe.feed(b) for b in blocks]
    torch.cuda.synchronize()
    assert mfd.mix_fir_decim.launches == len(blocks)
    mono = chain(*stages()).to(dev)
    c = mono.init(batch_shape=(8,), device=dev)
    for b, y in zip(blocks, ys):
        y1, c = mono(c, b)
        assert y.device.type == "cuda" and torch.equal(y, y1)


def _fir_chain(dev, n_fir=1):
    from liquid_dsp_tpu_torch import chain
    from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
    from liquid_dsp_tpu_torch.ops.fir import firfilt
    firs = [firfilt(firdes_kaiser(64, 0.2, 60.0), backend="pallas"),
            firfilt(firdes_kaiser(57, 0.3, 60.0), backend="pallas")]
    return chain(*firs[:n_fir]).to(dev)


def _rx_capture(T, K, seed):
    """Two channels of K blocks of T: frames across and on the boundaries
    of 4 shards and across a block boundary, in light noise."""
    from liquid_dsp_tpu_torch.framing.frame64 import FRAME64_LEN, framegen64
    Tl = T // 4
    rng = np.random.default_rng(seed)
    x = np.zeros((2, K * T), np.complex64)
    for ch, s0 in ((0, Tl - 300), (0, 2 * Tl), (1, 3 * Tl - 1536 - 100),
                   (1, T - 700), (0, 2 * T + Tl - 400)):
        f = framegen64(rng.integers(0, 256, 8).astype(np.uint8),
                       rng.integers(0, 256, 64).astype(np.uint8))
        x[ch, s0:s0 + FRAME64_LEN] += f
    x += (0.004 * (rng.standard_normal(x.shape)
                   + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
    return torch.from_numpy(x)


def _run(step, carry, blocks):
    outs = []
    for b in blocks:
        y, carry = step(carry, b)
        outs.append(y)
    return outs, carry


def test_card_mesh_fed_a_host_block(dev):
    # the output is assembled on the block's device: a card mesh fed a
    # host block gives, bit for bit, what it gives for the block on the
    # card (a copy from the card to the host must wait for its data)
    from liquid_dsp_tpu_torch.parallel import (framesync64_time_sharded,
                                               stream_mesh, time_shard_apply)
    p = _fir_chain(dev, 2)
    step = time_shard_apply(p, stream_mesh(4, devices=[dev] * 4))
    xs = [_cnoise(dev, (64, 262144), 50 + k) for k in range(2)]
    on_card, c_card = _run(step, p.init(batch_shape=(64,), device=dev), xs)
    on_host, c_host = _run(step, p.init(batch_shape=(64,), device=dev),
                           [x.cpu() for x in xs])
    for a, b in zip(on_host, on_card):
        assert a.device.type == "cpu" and torch.equal(a, b.cpu())
    assert all(torch.equal(a, b) for a, b in zip(c_host, c_card))
    T = 16384
    x = _rx_capture(T, 3, 51)
    init, rstep = framesync64_time_sharded(T, stream_mesh(
        4, devices=[dev] * 4))
    blocks = [x[:, k * T:(k + 1) * T] for k in range(3)]
    on_host, c_host = _run(rstep, init(batch_shape=(2,)), blocks)
    on_card, c_card = _run(rstep, init(batch_shape=(2,)),
                           [b.to(dev) for b in blocks])
    assert sum(int(o.valid.sum()) for o in on_card) == 5
    for a, b in zip(on_host, on_card):
        for fa, fb in zip(a, b):
            assert fa.device.type == "cpu" and torch.equal(fa, fb.cpu())
    assert all(torch.equal(c_host[k], c_card[k]) for k in c_card)


def test_mesh_of_the_card_and_the_cpu(dev):
    # distinct devices: the halos, the carries and the output cross
    # between the card and the host.  One FIR: each shard's output is its
    # own device's, so it is bit-equal to the same shard of a mesh all on
    # that device; a chain of two within 1e-5 of rms of one device.
    from liquid_dsp_tpu_torch.parallel import stream_mesh, time_shard_apply
    cpu = torch.device("cpu")
    layout = [dev, cpu, cpu, dev]          # ch 2 x t 2: [dev, cpu], [cpu, dev]
    xs = [_cnoise(dev, (8, 32768), 52 + k) for k in range(3)]
    p = _fir_chain(dev, 1)
    runs = {}
    for name, devs in (("mixed", layout), ("card", [dev] * 4),
                       ("cpu", [cpu] * 4)):
        step = time_shard_apply(p, stream_mesh(2, 2, devices=devs))
        runs[name] = _run(step, p.init(batch_shape=(8,), device=dev), xs)
    (ym, cm), Tl = runs["mixed"], 16384
    for k, y in enumerate(ym):
        assert y.device == xs[k].device
        for g in range(2):
            for i in range(2):
                want = runs["card" if layout[2 * g + i] == dev else "cpu"]
                sl = (slice(4 * g, 4 * g + 4), slice(i * Tl, (i + 1) * Tl))
                assert torch.equal(y[sl], want[0][k][sl])
    assert all(torch.equal(cm[0].cpu(), c[0].cpu())
               for c in (runs["card"][1], runs["cpu"][1]))
    p2 = _fir_chain(dev, 2)
    step = time_shard_apply(p2, stream_mesh(2, 2, devices=layout))
    ym, _ = _run(step, p2.init(batch_shape=(8,), device=dev), xs)
    y1, _ = _run(p2, p2.init(batch_shape=(8,), device=dev), xs)
    for a, b in zip(ym, y1):
        assert _rel(a, b) < 1e-5


def test_receiver_on_a_mesh_of_the_card_and_the_cpu(dev):
    # each shard's slot group bit-equal to the same group of a mesh all on
    # its own device; the carry (input samples, positions) equal
    from liquid_dsp_tpu_torch.parallel import (framesync64_time_sharded,
                                               stream_mesh)
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu, T, P = torch.device("cpu"), 16384, 4
    layout = [dev, cpu, cpu, dev]
    x = _rx_capture(T, 3, 53).to(dev)
    blocks = [x[:, k * T:(k + 1) * T] for k in range(3)]
    runs = {}
    for name, devs in (("mixed", layout), ("card", [dev] * 4),
                       ("cpu", [cpu] * 4)):
        init, step = framesync64_time_sharded(
            T, stream_mesh(4, devices=devs), max_frames_per_shard=P)
        runs[name] = _run(step, init(batch_shape=(2,)), blocks)
    (om, cm) = runs["mixed"]
    assert sum(int(o.valid.sum()) for o in om) == 5
    for k, o in enumerate(om):
        for i, d in enumerate(layout):
            want = runs["card" if d == dev else "cpu"][0][k]
            sl = (slice(None), slice(i * P, (i + 1) * P))
            for fa, fb in zip(o, want):
                assert torch.equal(fa[sl], fb[sl].to(fa.device))
    for name in ("card", "cpu"):
        c = runs[name][1]
        assert all(torch.equal(cm[k], c[k].to(cm[k].device)) for k in cm)


def test_stage_pipeline_of_the_card_and_the_cpu(dev):
    from liquid_dsp_tpu_torch import chain, fuse, kernel_fuse
    from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
    from liquid_dsp_tpu_torch.ops.fir import firdecim, firfilt
    from liquid_dsp_tpu_torch.ops.nco import nco
    from liquid_dsp_tpu_torch.ops.resample import msresamp
    from liquid_dsp_tpu_torch.parallel import StagePipeline

    def stages():
        return [kernel_fuse(fuse(chain(
                    nco(dphi=0.125, direction="down"),
                    firfilt(firdes_kaiser(64, 0.2, 60.0)),
                    firdecim(4, firdes_kaiser(48, 0.1, 60.0))))),
                msresamp(0.375)]
    cpu = torch.device("cpu")
    blocks = _cnoise(dev, (3, 8, 8192), 54)
    pipe = StagePipeline(stages(), devices=[dev, cpu], batch_shape=(8,))
    ys = [pipe.feed(b) for b in blocks]
    s0, s1 = stages()
    s0, s1 = s0.to(dev), s1.to(cpu)
    c0 = s0.init(batch_shape=(8,), device=dev)
    c1 = s1.init(batch_shape=(8,), device=cpu)
    for b, y in zip(blocks, ys):
        z, c0 = s0(c0, b)
        z, c1 = s1(c1, z.cpu())
        assert y.device == cpu and torch.equal(y, z)


# --- the receivers' suppression fold and LDPC belief propagation -----------

def _fold_case(dev, B, S, le_dtype, pos_dtype, seed, share=0.3):
    """Segments as the receivers give them: positions a segment of 256
    apart with a lag inside, candidates at `share`, watermarks around the
    block head (some past it), span 1000 (about four segments)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pos = (torch.arange(S, device=dev) * 256
           + torch.randint(0, 256, (B, S), generator=g, device=dev))
    cand = torch.rand(B, S, generator=g, device=dev) < share
    last_end = torch.randint(-600, 2400, (B,), generator=g, device=dev)
    return last_end.to(le_dtype), cand, pos.to(pos_dtype), 1000


@pytest.mark.parametrize("B", [1, 128, 257])
@pytest.mark.parametrize("S", [1, 129, 516])
@pytest.mark.parametrize("dtypes", [(torch.int32, torch.int32),
                                    (torch.int64, torch.int64),
                                    (torch.int32, torch.int64)])
def test_suppress_scan_bit_equal_to_plain(dev, B, S, dtypes):
    # a warp a row, 32 segments a turn: S at one, 4 turns + 1 and a
    # multiple of 4 turns; B at one, a multiple of the 4 rows a block and
    # one past; the watermarks and positions as int32, int64 and the
    # receivers' mix (int32 watermarks, int64 positions)
    from liquid_dsp_tpu_torch.ops.kernels.suppress_scan import (
        suppress_scan, suppress_scan_reference)
    for share in (0.0, 0.3, 1.0):
        args = _fold_case(dev, B, S, *dtypes, seed=B * 7 + S, share=share)
        n0 = suppress_scan.launches
        keep = suppress_scan(*args)
        torch.cuda.synchronize()
        assert suppress_scan.launches == n0 + 1
        assert keep.dtype == torch.bool and keep.shape == (B, S)
        assert torch.equal(keep, suppress_scan_reference(*args))
        if share == 0.0:
            assert not bool(keep.any())


def test_suppress_scan_takes_views_and_refuses(dev):
    from liquid_dsp_tpu_torch.ops.kernels.suppress_scan import (
        suppress_scan, suppress_scan_reference)
    le, cand, pos, span = _fold_case(dev, 6, 200, torch.int64, torch.int64, 3)
    # a column slice (not contiguous) and a span of 0
    args = (le, cand[:, 50:], pos[:, 50:], 0)
    assert torch.equal(suppress_scan(*args), suppress_scan_reference(*args))
    with pytest.raises(ValueError):
        suppress_scan(le, cand, pos.float(), span)
    with pytest.raises(ValueError):
        suppress_scan(le, cand.to(torch.uint8), pos, span)
    with pytest.raises(ValueError):
        suppress_scan(le.cpu(), cand, pos, span)


def _irregular_h(m, n, seed):
    """A parity-check matrix whose rows and columns differ in weight
    (pads on both sides), columns of weight 1 to 5, no empty row."""
    rng = np.random.default_rng(seed)
    H = np.zeros((m, n), np.uint8)
    for j in range(n):
        w = int(rng.choice([1, 2, 3, 3, 3, 4, 5]))
        H[rng.choice(m, size=w, replace=False), j] = 1
    for i in np.nonzero(H.sum(axis=1) == 0)[0]:
        H[i, rng.integers(0, n)] = 1
    return H


@pytest.mark.parametrize("code", ["regular", "irregular", "long"])
@pytest.mark.parametrize("min_sum", [False, True])
def test_ldpc_bp_on_the_card_matches_its_plain_version(dev, code, min_sum):
    # the messages bit-equal to the plain version on the card (both add in
    # slot order), so decisions and parity equal wherever it converged;
    # the long code's messages (745 KB a codeword) do not fit in shared
    # memory
    from liquid_dsp_tpu_torch.fec.ldpc import _slot_maps, make_regular_ldpc
    from liquid_dsp_tpu_torch.ops.kernels.ldpc_bp import (
        ldpc_bp, ldpc_bp_reference)
    H, R, sigma, iters = {
        "regular": (make_regular_ldpc(648, 324, 3, seed=0), 256, 0.7, 50),
        "irregular": (_irregular_h(60, 120, 5), 256, 0.55, 30),
        "long": (make_regular_ldpc(16200, 8100, 3, seed=0), 12, 0.75, 30),
    }[code]
    m, n, wr, wc, c2v, v2c, cvar, cw = _slot_maps(H)
    maps = [torch.from_numpy(a.astype(np.int32)).to(dev)
            for a in (c2v, v2c, cvar)]
    # the all-zero codeword (a codeword of any H) through BPSK and AWGN
    rng = np.random.default_rng(R + n)
    llr = torch.from_numpy((2 * (1.0 + sigma * rng.standard_normal((R, n)))
                            / sigma ** 2).astype(np.float32)).to(dev)
    n0 = ldpc_bp.launches
    rk = ldpc_bp(llr, *maps, m, n, wr, wc, iters, min_sum)
    torch.cuda.synchronize()
    assert ldpc_bp.launches == n0 + 1
    rp = ldpc_bp_reference(llr, *maps, m, n, wr, wc, iters, min_sum)
    assert rk.shape == rp.shape == (R, n * wc + 1)
    assert bool(torch.isfinite(rk).all()) and float(rk[:, -1].abs().max()) == 0
    assert torch.equal(rk, rp)

    def decide(rv):
        post = llr + rv[:, :n * wc].reshape(R, n, wc).sum(-1)
        hard = (post < 0).cpu().numpy().astype(np.int64)
        return hard, ~((hard @ H.T.astype(np.int64)) % 2).any(axis=1)

    hk, okk = decide(rk)
    hp, okp = decide(rp)
    assert okp.sum() >= R // 2, (code, okp.sum())
    assert (hk[okp] == hp[okp]).all() and okk[okp].all()
    if code != "irregular":   # its weight-1 columns make light codewords
        assert (hk[okk] == 0).all()      # every parity-passing row is sent


def test_ldpc_bp_refuses_what_it_does_not_take(dev):
    from liquid_dsp_tpu_torch.fec.ldpc import _slot_maps, make_regular_ldpc
    from liquid_dsp_tpu_torch.ops.kernels.ldpc_bp import ldpc_bp
    m, n, wr, wc, c2v, v2c, cvar, _ = _slot_maps(
        make_regular_ldpc(40, 20, 2, seed=0))
    m32 = [torch.from_numpy(a.astype(np.int32)).to(dev)
           for a in (c2v, v2c, cvar)]
    llr = torch.randn(3, n, device=dev)
    with pytest.raises(ValueError):       # int64 maps on the card
        ldpc_bp(llr, *(a.long() for a in m32), m, n, wr, wc, 5, False)
    with pytest.raises(ValueError):       # another n
        ldpc_bp(llr[:, 1:], *m32, m, n, wr, wc, 5, False)
    with pytest.raises(ValueError):       # maps on the CPU
        ldpc_bp(llr, *(a.cpu() for a in m32), m, n, wr, wc, 5, False)
    # zero iterations: the messages' start
    assert float(ldpc_bp(llr, *m32, m, n, wr, wc, 0, True).abs().max()) == 0


@pytest.mark.parametrize("S", [1, 31, 32, 33, 129, 132, 516])
@pytest.mark.parametrize("P", ["none", "1", "8", "S+1"])
@pytest.mark.parametrize("dtypes", [(torch.int32, torch.int32),
                                    (torch.int64, torch.int64),
                                    (torch.int32, torch.int64)])
def test_suppress_scan_ranking_bit_equal_to_plain(dev, S, P, dtypes):
    # keep, and with P the ranking (sel, n_cand) from the same launch,
    # against the plain fold and its cumsum ranking: S around the turns of
    # 32 and a long row (516: 17 turns, each turn's loads a turn ahead)
    from liquid_dsp_tpu_torch.ops.kernels.suppress_scan import (
        rank_reference, suppress_scan, suppress_scan_reference)
    P = {"none": None, "1": 1, "8": 8, "S+1": S + 1}[P]
    for share in (0.0, 0.3, 1.0):
        args = _fold_case(dev, 129, S, *dtypes, seed=S * 5 + (P or 0),
                          share=share)
        n0 = suppress_scan.launches
        out = suppress_scan(*args, P=P)
        torch.cuda.synchronize()
        assert suppress_scan.launches == n0 + 1
        keep = suppress_scan_reference(*args)
        if P is None:
            assert torch.equal(out, keep)
            continue
        sel, n_cand = rank_reference(keep, P)
        assert torch.equal(out[0], keep)
        assert out[1].shape == (129, P) and out[1].dtype == torch.int64
        assert torch.equal(out[1], sel) and torch.equal(out[2], n_cand)


_LDPC_CODES = {}


def _ldpc_case(dev, n):
    """(H's maps on the card, the LLRs): make_regular_ldpc(n, n / 2), the
    all-zero codeword (a codeword of any H) through BPSK and AWGN."""
    from liquid_dsp_tpu_torch.fec.ldpc import _slot_maps, make_regular_ldpc
    from liquid_dsp_tpu_torch.ops.kernels.ldpc_bp import compact_maps
    if n not in _LDPC_CODES:
        _LDPC_CODES[n] = _slot_maps(make_regular_ldpc(n, n // 2, 3, seed=0))
    m, n, wr, wc, c2v, v2c, cvar, cw = _LDPC_CODES[n]
    R, sigma = (256, 0.7) if n == 648 else (12, 0.75)
    rng = np.random.default_rng(R + n + 1)
    llr = torch.from_numpy((2 * (1.0 + sigma * rng.standard_normal((R, n)))
                            / sigma ** 2).astype(np.float32)).to(dev)
    maps = [torch.from_numpy(a.astype(np.int32)).to(dev)
            for a in (c2v, v2c, cvar)] + [torch.from_numpy(cw).to(dev)]
    cm = tuple(torch.from_numpy(a).to(dev)
               for a in compact_maps(c2v, v2c, cvar, m, n, wr, wc))
    return (m, n, wr, wc), maps, cm, llr


@pytest.mark.parametrize("n", [648, 16200])
@pytest.mark.parametrize("min_sum", [False, True])
@pytest.mark.parametrize("iters", [0, 1, 2, 5, 50])
def test_ldpc_bp_decisions_bit_equal_to_plain(dev, n, min_sum, iters):
    # the messages, hard and ok of one launch against the plain version's
    # iterations and epilogue: n = 648 with a codeword's arrays in shared
    # memory, n = 16200 in the global scratch
    from liquid_dsp_tpu_torch.ops.kernels import ldpc_bp as lb
    (m, n, wr, wc), (c2v, v2c, cvar, cw), cm, llr = _ldpc_case(dev, n)
    args = (llr, c2v, v2c, cvar, m, n, wr, wc, iters, min_sum)
    n0 = lb.ldpc_bp.launches
    rk, hk, okk = lb.ldpc_bp(*args, cw, cm, messages=True)
    torch.cuda.synchronize()
    assert lb.ldpc_bp.launches == n0 + 1
    hard, ok = lb.ldpc_bp(*args, cw, cm)            # the decoder's form
    rp = lb.ldpc_bp_reference(*args)
    hp, okp = lb.ldpc_decide_reference(llr, rp, cvar, cw, m, n, wr, wc)
    assert torch.equal(rk, rp)
    assert hk.dtype == torch.int32 and okk.dtype == torch.bool
    assert torch.equal(hk, hp) and torch.equal(okk, okp)
    assert torch.equal(hard, hp) and torch.equal(ok, okp)
    if iters == 50:
        assert int(okp.sum()) >= llr.shape[0] // 2


@pytest.mark.parametrize("min_sum", [False, True])
def test_ldpc_bp_parity_follows_h_weights(dev, min_sum):
    # the kernel's ok reads H's weights `cw` as the plain version does: an
    # irregular H with weights 1, 2 and 3 (an even weight drops the edge
    # from the syndrome) and the same H with every weight 2 (every row
    # passes); at a high noise, so that the two verdicts differ
    from liquid_dsp_tpu_torch.fec.ldpc import _slot_maps
    from liquid_dsp_tpu_torch.ops.kernels import ldpc_bp as lb
    H = _irregular_h(60, 120, 5)
    rng = np.random.default_rng(11)
    nz = np.nonzero(H)
    H[nz] = rng.choice([1, 2, 3], size=len(nz[0]))
    m, n, wr, wc, c2v, v2c, cvar, cw = _slot_maps(H)
    maps = [torch.from_numpy(a.astype(np.int32)).to(dev)
            for a in (c2v, v2c, cvar)]
    cm = tuple(torch.from_numpy(a).to(dev)
               for a in lb.compact_maps(c2v, v2c, cvar, m, n, wr, wc))
    llr = torch.from_numpy((2 * (1.0 + 1.2 * rng.standard_normal((64, n)))
                            / 1.2 ** 2).astype(np.float32)).to(dev)
    args = (llr, *maps, m, n, wr, wc, 5, min_sum)
    rp = lb.ldpc_bp_reference(*args)
    oks = []
    for w in (cw, np.where(cw != 0, 2, 0)):
        wt = torch.from_numpy(w).to(dev)
        hard, ok = lb.ldpc_bp(*args, wt, cm)
        hp, okp = lb.ldpc_decide_reference(llr, rp, maps[2], wt, m, n, wr,
                                           wc)
        assert torch.equal(hard, hp) and torch.equal(ok, okp)
        oks.append(ok)
    assert bool(oks[1].all()) and not bool(oks[0].all())
    with pytest.raises(ValueError):       # H's weights as int32
        lb.ldpc_bp(*args, wt.int(), cm)
