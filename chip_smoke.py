#!/usr/bin/env python3
"""Smoke test of the PyTorch port (liquid_dsp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path, the headline stream chain

    planar(kernel_fuse(fuse(chain(nco, firfilt64, firfilt57, msresamp(0.5)))))

at 64 channels x 262144 samples per block on the card, through the
public entry points, and checks it:

  1. header: card name and power limit, torch / CUDA / nvcc versions,
     TF32 switched off for matmul and cuDNN (a reference is full f32);
  2. build: the CUDA kernel is compiled from csrc/ with nvcc (sm_90a);
  3. main path: 3 streaming blocks with the carry handed from block to
     block; the kernel's output against its plain PyTorch version on the
     same inputs and carries (max|err|/rms < 2e-4);
  4. mixed block sizes (4096, 2048, 4096) and bfloat16 input planes with
     out_dtype="input" (< 3e-2 against the f32 plain version);
  5. an independent numpy float64 reference (mixer + the unfused filter
     cascade) on 2 channels x the first 8192 outputs (< 2e-4), and the
     port's unfused and fused (no kernel) chains on the card against the
     kernel chain;
  6. the kernel's launch count over the main-path run equals its blocks;
  7. kernel and plain-version times (CUDA events) at 64x262144.

Then the frame64 streaming receiver with in-stream Golay decode,
``framesync64_stream_full``, at 128 channels x 32768-sample blocks:

  8. frames from the port's framegen64 at random offsets on 120 channels
     (some straddling block boundaries, one channel with the reference C
     library's own frame from tests/golden/frame64_golden.npz, one with
     CFO 0.008 rad/sample, gain 0.2 and 15 dB SNR), 8 noise-only
     channels, noise everywhere; 3 carried blocks plus a flush block.
     Every frame decodes exactly once, in order, with crc_ok, the bytes
     sent and sample_index within 2 of the true start; nothing decodes
     on a noise-only channel; the codebook_argmax kernel ran;
  9. codebook_argmax: the kernel against its plain version on that run's
     slot soft bits (153,600 rows x 24 x 4096): bit-equal indices, and
     the first index on constant rows;
 10. fir_real: firfilt(h, backend="pallas") on the card against its
     plain version over 3 carried 64x262144 blocks (< 1e-5 of rms), one
     launch per block;
 11. times (CUDA events): the receiver step, and each kernel against its
     plain version (plain, kernel, kernel, plain).

The JSON line before the card's name lists all three kernels.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
B, T, NBLK = 64, 1 << 18, 3
DPHI = 0.125
TOL_F32 = 2e-4     # the reference's own bound (tests/test_pallas_chain.py:49)
TOL_BF16 = 3e-2    # bf16 quantization of input and output planes (:106)
N_CHECK = 8192     # outputs per channel in the float64 check
RX_B, RX_T = 128, 1 << 15   # receiver: channels x samples per block
RX_NBLK = 3                 # carried receiver blocks (plus one flush block)
RX_QUIET = 8                # noise-only channels (the last ones)
RX_FRAMES = 8               # frames per channel with frames
FIR_L = 144                 # fir_real taps (the headline chain's fused FIR)
TOL_FIR = 1e-5              # fir_real kernel vs plain, max|err|/rms


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def complex_err(y, ref):
    """(max |y - ref|, max |y - ref| / rms(ref)) over complex samples
    given as (re, im) plane pairs."""
    dr = y[0].double() - ref[0].double()
    di = y[1].double() - ref[1].double()
    err = float(((dr * dr + di * di).sqrt()).max())
    rms = float((ref[0].double() ** 2 + ref[1].double() ** 2).mean().sqrt())
    return err, err / rms


def flat_stages(p):
    return ([s for c in p.stages for s in flat_stages(c)]
            if hasattr(p, "stages") else [p])


def time_ms(fn, iters=20):
    """Mean ms per call over `iters` calls, CUDA events, after 3 warm-ups."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def make_rx_stream(rng):
    """The receiver's input [RX_B, (RX_NBLK+1)*RX_T] complex64 and, per
    channel, the frames sent: [(start, header, payload), ...] in order."""
    from liquid_dsp_tpu_torch.framing.frame64 import FRAME64_LEN, framegen64
    n = (RX_NBLK + 1) * RX_T
    x = np.zeros((RX_B, n), np.complex64)
    sent = [[] for _ in range(RX_B)]
    gold = dict(np.load(os.path.join(ROOT, "tests", "golden",
                                     "frame64_golden.npz")))
    usable = RX_NBLK * RX_T - FRAME64_LEN
    for ch in range(RX_B - RX_QUIET):
        # frames at least FRAME64_LEN + 60 apart, at random offsets; on
        # every 4th channel one straddles a block boundary
        starts = []
        pos = int(rng.integers(0, 3000))
        while len(starts) < RX_FRAMES and pos < usable:
            starts.append(pos)
            pos += FRAME64_LEN + int(rng.integers(60, 9000))
        if ch % 4 == 0:
            b = (ch // 4) % (RX_NBLK - 1) + 1
            cut = b * RX_T - int(rng.integers(1, FRAME64_LEN))
            starts = [s0 for s0 in starts
                      if abs(s0 - cut) >= FRAME64_LEN + 60] + [cut]
            starts = sorted(s0 for s0 in starts if s0 <= usable)
        for k, s0 in enumerate(starts):
            if ch == 1 and k == 0:
                h, p, f = gold["header"], gold["payload"], gold["frame"]
            else:
                h = rng.integers(0, 256, 8).astype(np.uint8)
                p = rng.integers(0, 256, 64).astype(np.uint8)
                f = framegen64(h, p)
            x[ch, s0:s0 + FRAME64_LEN] = f
            sent[ch].append((s0, np.asarray(h, np.uint8),
                             np.asarray(p, np.uint8)))
    noise = 0.01
    x += (noise * (rng.standard_normal(x.shape)
                   + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
    # channel 2: CFO 0.008 rad/sample, phase 1.0, gain 0.2, 15 dB SNR
    t = np.arange(n)
    sig = np.zeros(n, np.complex64)
    for s0, h, p in sent[2]:
        sig[s0:s0 + FRAME64_LEN] = framegen64(h, p)
    sigma = 0.2 * 10 ** (-15 / 20) / np.sqrt(2)
    x[2] = (sig * 0.2 * np.exp(1j * (0.008 * t + 1.0)) + sigma * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
        ).astype(np.complex64)
    return x, sent


def check_rx(got, sent):
    """got/sent per channel; returns the number of frames checked."""
    n = 0
    for ch, (g, s) in enumerate(zip(got, sent)):
        check(len(g) == len(s), f"receiver channel {ch}: {len(g)} frames "
              f"decoded, {len(s)} sent")
        for k, ((idx, ok, h, p), (s0, hs, ps)) in enumerate(zip(g, s)):
            check(ok, f"receiver channel {ch} frame {k}: crc failed")
            check(np.array_equal(h, hs) and np.array_equal(p, ps),
                  f"receiver channel {ch} frame {k}: bytes differ")
            check(abs(idx - s0) <= 2, f"receiver channel {ch} frame {k}: "
                  f"sample_index {idx}, sent at {s0}")
            n += 1
    return n


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs one CUDA card")
    sys.path.insert(0, ROOT)
    from liquid_dsp_tpu_torch import chain, fuse, kernel_fuse, planar
    from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
    from liquid_dsp_tpu_torch.ops.fir import firfilt
    from liquid_dsp_tpu_torch.ops.kernels import build
    from liquid_dsp_tpu_torch.ops.kernels.mix_fir_decim import (
        mix_fir_decim, mix_fir_decim_reference)
    from liquid_dsp_tpu_torch.ops.nco import nco
    from liquid_dsp_tpu_torch.ops.resample import msresamp

    # 1. header
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    check(smi, "nvidia-smi printed no card")
    card = smi[0].strip()
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"header: card {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; nvcc {nvcc[-1] if nvcc else '?'}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    dev = torch.device("cuda")

    # 2. build
    t0 = time.perf_counter()
    lib = build.build()
    build.load_library()
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    print(f"build: {lib.name} (nvcc {' '.join(build.NVCC_FLAGS)}) in "
          f"{time.perf_counter() - t0:.1f} s; ptxas: {' | '.join(ptxas)}",
          flush=True)

    # 3. the main path through the public API
    stages = chain(nco(dphi=DPHI, direction="down"),
                   firfilt(firdes_kaiser(64, 0.2, 60.0)),
                   firfilt(firdes_kaiser(57, 0.3, 60.0)),
                   msresamp(0.5, 60.0))
    fused = fuse(stages)
    proc = planar(kernel_fuse(fused)).to(dev)
    kern = proc.inner
    check(type(kern).__name__ == "MixFIRDecim",
          f"kernel_fuse did not match the headline chain: {type(kern)}")
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = [(torch.randn(B, T, generator=gen, device=dev),
           torch.randn(B, T, generator=gen, device=dev))
          for _ in range(NBLK)]
    carry = proc.init(batch_shape=(B,), device=dev)
    carries, outs = [carry], []
    mix_fir_decim.launches = 0
    for x in xs:
        y, carry = proc(carry, x)
        outs.append(y)
        carries.append(carry)
    torch.cuda.synchronize()
    launches = mix_fir_decim.launches

    def plain(x, c, out_dtype=torch.float32):
        return mix_fir_decim_reference(
            x[0], x[1], c["tr"], c["ti"], c["theta"], kern.ramp_c,
            kern.ramp_s, kern.taps, down=kern.down, sgn=kern.sgn,
            dphi=kern.dphi, out_dtype=out_dtype)

    max_abs, worst = 0.0, 0.0
    refs = []
    for k, (x, y) in enumerate(zip(xs, outs)):
        check(y[0].shape == (B, T // 2) and y[0].dtype == torch.float32,
              f"block {k}: output {tuple(y[0].shape)} {y[0].dtype}")
        check(bool(torch.isfinite(y[0]).all() and torch.isfinite(y[1]).all()),
              f"block {k}: non-finite output")
        ref = plain(x, carries[k])
        refs.append(ref)
        err, rel = complex_err(y, ref)
        max_abs, worst = max(max_abs, err), max(worst, rel)
    check(worst < TOL_F32, f"kernel vs plain version: {worst:.3e}")
    print(f"main path: {NBLK} blocks of {B}x{T} f32, carried; kernel vs "
          f"plain max|err| {max_abs:.3e}, max|err|/rms {worst:.3e} "
          f"(< {TOL_F32})", flush=True)

    # 4. mixed block sizes, bf16 planes and the out_dtype policy
    c = proc.init(batch_shape=(B,), device=dev)
    worst_mixed = 0.0
    for k, Tb in enumerate((4096, 2048, 4096)):
        x = (xs[k][0][:, :Tb].contiguous(), xs[k][1][:, :Tb].contiguous())
        ref = plain(x, c)
        y, c = proc(c, x)
        worst_mixed = max(worst_mixed, complex_err(y, ref)[1])
    check(worst_mixed < TOL_F32, f"mixed block sizes: {worst_mixed:.3e}")
    pbf = planar(kernel_fuse(fused, out_dtype="input")).to(dev)
    c = pbf.init(batch_shape=(B,), device=dev)
    worst_bf = 0.0
    for k, x in enumerate(xs):
        xb = (x[0].bfloat16(), x[1].bfloat16())
        y, c = pbf(c, xb)
        check(y[0].dtype == torch.bfloat16, f"bf16 output dtype {y[0].dtype}")
        worst_bf = max(worst_bf, complex_err(y, refs[k])[1])
    check(worst_bf < TOL_BF16, f"bf16 planes: {worst_bf:.3e}")
    y, _ = proc(proc.init(batch_shape=(B,), device=dev),
                (xs[0][0].bfloat16(), xs[0][1].bfloat16()))
    check(y[0].dtype == torch.float32, "default out_dtype must be float32")
    print(f"blocks 4096/2048/4096: max|err|/rms {worst_mixed:.3e} "
          f"(< {TOL_F32}); bf16 in/out vs f32 plain: {worst_bf:.3e} "
          f"(< {TOL_BF16}); bf16 in, default out: float32", flush=True)

    # 5. independent float64 reference: mixer + the unfused cascade
    n = np.arange(2 * N_CHECK)
    x64 = (xs[0][0][:2, :2 * N_CHECK].double().cpu().numpy()
           + 1j * xs[0][1][:2, :2 * N_CHECK].double().cpu().numpy())
    z = x64 * np.exp(-1j * DPHI * n)
    for s in flat_stages(stages)[1:]:
        h = np.asarray(s.lti.taps, np.float64)
        z = np.stack([np.convolve(r, h)[:len(r)][s.lti.d::s.lti.down]
                      for r in z])
    got = outs[0][0][:2, :N_CHECK].double().cpu().numpy() \
        + 1j * outs[0][1][:2, :N_CHECK].double().cpu().numpy()
    rel64 = np.abs(got - z).max() / np.sqrt(np.mean(np.abs(z) ** 2))
    check(z.shape == got.shape and rel64 < TOL_F32,
          f"float64 reference: {rel64:.3e} (shapes {z.shape} {got.shape})")
    # the port's other paths on the card: the unfused chain and the fused
    # chain without the kernel, against the kernel chain
    worst_alt = {}
    for name, alt in (("unfused", planar(stages)), ("fused", planar(fused))):
        alt = alt.to(dev)
        ca = alt.init(batch_shape=(8,), device=dev)
        ck = proc.init(batch_shape=(8,), device=dev)
        worst_alt[name] = 0.0
        for x in xs[:2]:
            xb = (x[0][:8, :8192].contiguous(), x[1][:8, :8192].contiguous())
            ya, ca = alt(ca, xb)
            yk, ck = proc(ck, xb)
            worst_alt[name] = max(worst_alt[name], complex_err(yk, ya)[1])
        check(worst_alt[name] < TOL_F32,
              f"{name} chain vs kernel: {worst_alt[name]:.3e}")
    print(f"float64 numpy reference (2 ch x {N_CHECK} outputs): "
          f"max|err|/rms {rel64:.3e}; the port's unfused / fused chains on "
          f"the card vs the kernel chain (8x8192, 2 blocks): "
          f"{worst_alt['unfused']:.3e} / {worst_alt['fused']:.3e} "
          f"(< {TOL_F32})", flush=True)

    # 6. the main path went through the kernel
    check(launches == NBLK, f"{launches} kernel launches for {NBLK} blocks")
    print(f"launches: mix_fir_decim {launches} for {NBLK} main-path blocks",
          flush=True)

    # 7. timing at the main path's shape
    c0, x0 = carries[0], xs[0]
    xb0 = (x0[0].bfloat16(), x0[1].bfloat16())

    def kernel_f32():
        return mix_fir_decim(x0[0], x0[1], c0["tr"], c0["ti"], c0["theta"],
                             kern.ramp_c, kern.ramp_s, kern.taps,
                             down=kern.down, sgn=kern.sgn, dphi=kern.dphi)

    def kernel_bf16():
        return mix_fir_decim(xb0[0], xb0[1], c0["tr"], c0["ti"], c0["theta"],
                             kern.ramp_c, kern.ramp_s, kern.taps,
                             down=kern.down, sgn=kern.sgn, dphi=kern.dphi,
                             out_dtype=torch.bfloat16)

    # plain, kernel, kernel, plain: one card, in turns
    p1 = time_ms(lambda: plain(x0, c0))
    k1 = time_ms(kernel_f32)
    k2 = time_ms(kernel_f32)
    p2 = time_ms(lambda: plain(x0, c0))
    kb = time_ms(kernel_bf16)
    step = time_ms(lambda: proc(c0, x0))
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    msps = B * T / ms / 1e3
    print(f"timing ({card}): kernel {ms:.4f} ms = {msps:.1f} Msamples/s "
          f"(runs {k1:.4f}, {k2:.4f}); plain version {plain_ms:.4f} ms = "
          f"{B * T / plain_ms / 1e3:.1f} Msamples/s (runs {p1:.4f}, "
          f"{p2:.4f}); kernel bf16 in/out {kb:.4f} ms = "
          f"{B * T / kb / 1e3:.1f} Msamples/s; main-path step "
          f"{step:.4f} ms; {B}x{T} complex samples per block", flush=True)

    kernels = [{
        "name": "mix_fir_decim", "route": "cuda",
        "source": "liquid_dsp_tpu_torch/csrc/mix_fir_decim.cu",
        "replaces": "liquid_dsp_tpu/ops/kernels/pallas_chain.py:154",
        "launches": launches, "max_abs_err": max_abs,
        "ms": ms, "plain_ms": plain_ms}]
    del xs, outs, carries, refs, xb0
    torch.cuda.empty_cache()
    kernels += receiver_phases(torch, dev, card)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def receiver_phases(torch, dev, card):
    """Phases 8-11: the frame64 receiver with in-stream Golay decode, the
    codebook_argmax and fir_real kernels.  Returns their kernel entries."""
    from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
    from liquid_dsp_tpu_torch.framing.frame64 import framesync64_stream_full
    from liquid_dsp_tpu_torch.ops.fir import firfilt
    from liquid_dsp_tpu_torch.ops.kernels.codebook_argmax import (
        codebook_argmax, codebook_argmax_reference)
    from liquid_dsp_tpu_torch.ops.kernels.fir_real import (
        fir_real, fir_real_reference)

    # 8. the receiver at full width
    t0 = time.perf_counter()
    x_np, sent = make_rx_stream(np.random.default_rng(7))
    x = torch.from_numpy(x_np).to(dev)
    del x_np
    n_frames = sum(len(s) for s in sent)
    t_gen = time.perf_counter() - t0
    proc = framesync64_stream_full(RX_T).to(dev)
    carry = proc.init(batch_shape=(RX_B,), device=dev)
    carries, outs = [carry], []
    codebook_argmax.launches = 0
    t0 = time.perf_counter()
    for b in range(RX_NBLK + 1):
        out, carry = proc(carry, x[:, b * RX_T:(b + 1) * RX_T])
        outs.append(out)
        carries.append(carry)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    cb_launches = codebook_argmax.launches
    got = [[] for _ in range(RX_B)]
    for out in outs:
        o = {k: v.cpu().numpy() for k, v in out._asdict().items()}
        for ch, p in zip(*np.nonzero(o["valid"])):
            got[ch].append((int(o["sample_index"][ch, p]),
                            bool(o["crc_ok"][ch, p]),
                            o["hdr_bytes"][ch, p].astype(np.uint8),
                            o["pay_bytes"][ch, p].astype(np.uint8)))
    n_ok = check_rx(got, sent)
    check(all(not got[ch] for ch in range(RX_B - RX_QUIET, RX_B)),
          "a frame decoded on a noise-only channel")
    check(cb_launches == RX_NBLK + 1, f"codebook_argmax launched "
          f"{cb_launches} times in {RX_NBLK + 1} receiver blocks")
    print(f"receiver: framesync64_stream_full at {RX_B}x{RX_T}, "
          f"{RX_NBLK} carried blocks + 1 flush; {n_ok} of {n_frames} frames "
          f"decoded once, in order, crc_ok, bytes equal, sample_index "
          f"within 2 (incl. the reference C frame and the CFO 0.008 / gain "
          f"0.2 / 15 dB channel); {RX_QUIET} noise-only channels: 0 frames; "
          f"codebook_argmax launches {cb_launches}; stream made in "
          f"{t_gen:.1f} s, first pass {t_run:.2f} s", flush=True)

    # 9. codebook_argmax on the slot soft bits of block 1
    sym = proc.core(carries[1], x[:, RX_T:2 * RX_T])[0].symbols
    cw = proc.decode.soft_bits(sym).reshape(-1, 24).contiguous()
    bip = proc.decode.bip
    n0 = codebook_argmax.launches
    idx_k = codebook_argmax(cw, bip)
    idx_p = codebook_argmax_reference(cw, bip)
    torch.cuda.synchronize()
    check(codebook_argmax.launches == n0 + 1, "codebook_argmax: no launch")
    check(torch.equal(idx_k, idx_p), f"codebook_argmax: "
          f"{int((idx_k != idx_p).sum())} of {cw.shape[0]} indices differ")
    ties = codebook_argmax(torch.zeros(4099, 24, device=dev), bip)
    check(bool((ties == 0).all()), "codebook_argmax: ties must pick 0")
    print(f"codebook_argmax: kernel = plain on all {cw.shape[0]} rows "
          f"(n=24, K={bip.shape[1]}); constant rows pick index 0",
          flush=True)

    # 10. fir_real through firfilt(backend="pallas"), 3 carried blocks
    h = firdes_kaiser(FIR_L, 0.2, 60.0)
    fk, fp = (firfilt(h, backend=b).to(dev) for b in ("pallas", "xla"))
    gen = torch.Generator(device=dev).manual_seed(1)
    blocks = [torch.complex(torch.randn(B, T, generator=gen, device=dev),
                            torch.randn(B, T, generator=gen, device=dev))
              for _ in range(3)]
    ck = cp = fk.init(batch_shape=(B,), device=dev)
    fir_real.launches = 0
    worst_fir, abs_fir = 0.0, 0.0
    for xb in blocks:
        yk, ck = fk(ck, xb)
        yp, cp = fp(cp, xb)
        err, rel = complex_err((yk.real, yk.imag), (yp.real, yp.imag))
        worst_fir, abs_fir = max(worst_fir, rel), max(abs_fir, err)
    torch.cuda.synchronize()
    fir_launches = fir_real.launches
    check(worst_fir < TOL_FIR, f"fir_real vs plain: {worst_fir:.3e}")
    check(fir_launches == len(blocks), f"fir_real launched {fir_launches} "
          f"times in {len(blocks)} blocks")
    print(f"fir_real: firfilt(backend='pallas') {FIR_L} taps, 3 carried "
          f"blocks of {B}x{T} complex vs plain: max|err| {abs_fir:.3e}, "
          f"max|err|/rms {worst_fir:.3e} (< {TOL_FIR}); launches "
          f"{fir_launches}", flush=True)

    # 11. timing: plain, kernel, kernel, plain on one card
    c1, x1 = carries[1], x[:, RX_T:2 * RX_T]
    rx1 = time_ms(lambda: proc(c1, x1), iters=10)
    rx2 = time_ms(lambda: proc(c1, x1), iters=10)
    rx_ms = (rx1 + rx2) / 2
    cp1 = time_ms(lambda: codebook_argmax_reference(cw, bip), iters=3)
    ck1 = time_ms(lambda: codebook_argmax(cw, bip))
    ck2 = time_ms(lambda: codebook_argmax(cw, bip))
    cp2 = time_ms(lambda: codebook_argmax_reference(cw, bip), iters=3)
    rows = torch.cat([blocks[0].real, blocks[0].imag]).contiguous()
    crow = torch.zeros(2 * B, FIR_L - 1, device=dev)
    hk = fk.h
    fp1 = time_ms(lambda: fir_real_reference(rows, crow, hk))
    fk1 = time_ms(lambda: fir_real(rows, crow, hk))
    fk2 = time_ms(lambda: fir_real(rows, crow, hk))
    fp2 = time_ms(lambda: fir_real_reference(rows, crow, hk))
    cb_ms, cb_plain = (ck1 + ck2) / 2, (cp1 + cp2) / 2
    fr_ms, fr_plain = (fk1 + fk2) / 2, (fp1 + fp2) / 2
    print(f"timing ({card}): receiver step {rx_ms:.4f} ms per {RX_B}x{RX_T} "
          f"block = {RX_B * RX_T / rx_ms / 1e3:.1f} Msamples/s (runs "
          f"{rx1:.4f}, {rx2:.4f})", flush=True)
    print(f"timing ({card}): codebook_argmax kernel {cb_ms:.4f} ms (runs "
          f"{ck1:.4f}, {ck2:.4f}) vs plain {cb_plain:.4f} ms (runs "
          f"{cp1:.4f}, {cp2:.4f}) at {cw.shape[0]} x 24 x {bip.shape[1]}",
          flush=True)
    print(f"timing ({card}): fir_real kernel {fr_ms:.4f} ms (runs "
          f"{fk1:.4f}, {fk2:.4f}) vs plain {fr_plain:.4f} ms (runs "
          f"{fp1:.4f}, {fp2:.4f}) at {B}x{T} complex ({2 * B} rows), "
          f"{FIR_L} taps", flush=True)
    return [{
        "name": "codebook_argmax", "route": "cuda",
        "source": "liquid_dsp_tpu_torch/csrc/codebook_argmax.cu",
        "replaces": "liquid_dsp_tpu/ops/kernels/pallas_codebook.py:40",
        "launches": cb_launches,
        "max_abs_err": float((idx_k - idx_p).abs().max()),
        "ms": cb_ms, "plain_ms": cb_plain}, {
        "name": "fir_real", "route": "cuda",
        "source": "liquid_dsp_tpu_torch/csrc/fir_real.cu",
        "replaces": "liquid_dsp_tpu/ops/kernels/pallas_fir.py:51",
        "launches": fir_launches, "max_abs_err": abs_fir,
        "ms": fr_ms, "plain_ms": fr_plain}]


if __name__ == "__main__":
    main()
