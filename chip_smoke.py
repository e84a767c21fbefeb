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
  7. kernel and plain-version times (CUDA events) at 64x262144; then the
     kernel against its plain version (< 1e-5 of rms, both mixer signs)
     at the shapes that exercise its structure: (B, T, L, down) =
     (16, 6144, 41, 4), (8, 4096, 257, 1), (8, 2048, 257, 256),
     (8, 2048, 1, 1), (24, 8192, 100, 8).

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
     the first index on constant rows; then bit-equal indices for
     hamming1511 (n = 15, K = 2048), a ragged number of rows, golay2412
     with its columns handed over sorted by mask (the wrapper sorts them
     anyway, so that neighbouring columns share leading positions and the
     kernel sums those once), a random +-1 codebook with n = 32 and
     K = 1000 (too little shared, K not a multiple of a pass), and
     rows whose best score is tied between far-apart duplicate columns;
 10. fir_real: firfilt(h, backend="pallas") on the card against its
     plain version over 3 carried 64x262144 blocks (< 1e-5 of rms), one
     launch per block; then fir_real itself at 1, 13, 257 and 4096 taps
     and at a ragged T (2053);
 11. times (CUDA events): the receiver step, and each kernel against its
     plain version (plain, kernel, kernel, plain); torch.profiler over 3
     receiver steps (device time by kernel; a measurement, no check).

Then the timing-recovery family at 256 channels x 32768-sample blocks
(QPSK at 2 samples/symbol, arkaiser pulses with a fractional delay per
channel, made with numpy and scipy):

 12. symsync(k=2, m=5) over 3 carried blocks at 40 dB SNR: after the first
     block T/2 +- 2 symbols per block on every channel, the tail symbols
     against those sent (_tail_err < 5e-3, tests/test_symsync_misc.py)
     on every channel, symsync_scan launched once per chunk and block;
 13. symtrack_stream(ms="qpsk") over 3 carried blocks, adding per-channel
     gain, carrier phase and on a quarter of the channels a CFO up to
     5e-4 rad/sample, at 20 dB SNR: over the third block's last 8192
     symbols the decisions equal those sent up to a delay and a multiple
     of 90 degrees (SER <= 1e-3) on every channel; agc_scan, symsync_scan
     and pll_lms launched as the blocks and chunks say;
 14. each new kernel against its plain version on the same inputs and
     states: symsync_scan bit-equal over 1024 steps x 256 channels,
     agc_scan bit-equal (else max|err|/rms <= 1e-6) over 1024 samples,
     pll_lms within 2e-4 with equal decisions over 3072 slots; agc_scan
     bit-equal again with locked=True, at a ragged T (1021) with B = 70
     (a ragged last block) and alpha = 1e-3, at alpha = 0.5 with power
     from 1e-8 to 1e4 and level steps (below the guard and up to the
     clamp), from a carry with g at the clamp, and on less than one tile;
     then two kernels' own structure under stress, 256 channels each:
     symsync_scan bit-equal on a ragged chunk (509 steps), a real stream
     (P = 1), locked=True, k = 3 with k_out = 2, and from the zero state
     (acquisition: fast drift, negative branch indices); pll_lms within
     2e-4 (outputs and state) with equal decisions where every 4th
     channel has no valid slot (and invalid slots carry samples), where
     all slots are valid, with the argmin slicer (qam16) and with L = 32;
 15. 4 channels x 4096 samples through symtrack_stream on the card and on
     the CPU (hoisted route with the kernels' plain versions): equal valid
     masks and decisions, symbols within 2e-4;
 16. times (CUDA events): each new kernel against its plain version at
     1024 steps / 3072 slots (plain, kernel, kernel, plain), each kernel
     at full width, and the symsync and symtrack_stream block steps;
 17. torch.profiler over 3 symtrack_stream steps: device time by kernel,
     device operations per step, busy share (a measurement, no check).

Then the channelizer family, the 64-channel wideband scanner and the
flexframe receiver on block codes:

 18. the four channelizer Procs (firpfbch and firpfbch2, analyzer and
     synthesizer) on the card against the reference C library's goldens
     (tests/golden/channelizer_golden.npz, atol 2e-4);
 19. at 16 x 65536 wideband samples (tools/bench_channelizer.py's shape):
     the M = 64 analyzer against float64 numpy "mix down by c/M, filter,
     decimate by M" on 2 channels (|gain| and max|err|/rms < 1e-3), the
     firpfbch2 loopback within 2e-3 after its delay at M = 64 and at
     M = 1024, the four Procs at M = 1024 (branch filter + cuFFT) against
     their fused matrices (< 1e-4 of rms); block times in Msamples/s;
 20. the wideband scanner: firpfbch2_synthesizer(64) builds 2 wideband
     streams of 3 blocks + a flush x 1,048,576 samples on the card from
     64 channels x 32768 samples per block (frame64 frames on the even
     channels, noise 0.002, a tone on channel 11);
     firpfbch2_analyzer(64) feeds framesync64_stream_full(32768) over the
     128 channel streams, carries handed from block to block.  Every
     frame decodes once on its own channel, in order, crc_ok, with the
     bytes sent and sample_index within 2 of its start plus the bank's
     delay (15 channel samples); nothing on an odd channel;
     codebook_argmax launched once per block and bit-equal to its plain
     version on block 1's slot soft bits;
 21. times (CUDA events) of the analyzer, receiver and whole scanner
     steps; torch.profiler over 3 scanner steps;
 22. flexframe_rx_stream(32768, 64) (crc32 / none / golay2412 / qpsk) at
     128 channels, 3 carried blocks + a flush: frames from the port's
     flexframegen at random offsets (some across block boundaries), the
     reference's ffg_a on channel 1, CFO 0.002 rad/sample at 20 dB SNR on
     channel 2, a qam16 frame on channel 3 (must come back hdr_ok False),
     8 noise-only channels.  Every frame decodes once with hdr_ok, pay_ok,
     the header and payload bytes and sample_index within 2;
     codebook_argmax launched once per block and bit-equal to its plain
     version on the payload soft bits; the step's time and profile;
 23. FlexFrameSync and flexframesync on the card (their default) decode
     the reference frames ffg_a, ffg_b and ffg_c; ffg_b and ffg_c take
     the host decode.

Then the convolutional codes and the GMSK frame family:

 24. viterbi_acs against its plain version on the card, bits and packed
     decisions bit-equal: v27, v29, v39 at 512 codewords x 68 bytes (the
     GMSK receiver's shape) at noise 0.8 / 1.0 and at zero noise (which
     must decode to the bytes sent), v27p23, v27p78, v29p34, v29p78, one
     codeword and 37 of one byte, v29 at 2000 bytes (decisions in device
     memory), all-zero metrics; times at the receiver's shape and at
     tools/bench_viterbi.py's (256 x 64 bytes, v27 and v29) over 200
     launches, in decoded kbit/s, beside the bound and the chain's floor
     (T steps at one step's latency, from a lone codeword at two lengths);
 25. gmskframe_rx_stream(32768, 64) (crc32 / none / golay2412) at 128
     channels, 3 carried blocks + a flush: the frames' bits from the
     port's host packetizer, modulated in one batched gmsk_modulator call
     on the card (one frame held to gmskframegen within 1e-4), 3 frames
     per channel and block on 120 channels, 8 of them at CFO 0.0015
     rad/sample and phase 0.3, one frame of another configuration (must
     come back hdr_ok False), 8 noise-only channels, noise 0.005.  Every
     frame decodes once, in order, hdr_ok and pay_ok, header and payload
     bytes equal, sample_index within 2; codebook_argmax launched once per
     block and bit-equal to its plain version on the path's own soft
     metrics; the step's time and profile;
 26. the same receiver with fec0="v27", fec1="none" (138 encoded payload
     bytes, as the Golay one): the same checks, viterbi_acs launched once
     per block and bit-equal to its plain version on the path's LLRs;
 27. flexframe_rx_stream with a v27 payload (crc32 / v27 / none / qpsk,
     64 bytes) at 16 x 32768: every frame once with the bytes sent,
     viterbi_acs once per block; gmskframesync on the card decodes the
     reference frames gmsk_a and gmsk_b; GMSKFrameSync on the card
     decodes three frames of three configurations.

Then OFDM (64 subcarriers, cyclic prefix 16):

 28. ofdmflex_rx_stream(32768, 64) (crc32 / none / golay2412 / qpsk, 8
     slots) at 128 channels, 3 carried blocks + a flush: the frames'
     grids from the port's host packetizer, modulated in one batched
     inverse FFT on the card (one frame held to ofdmflexframegen within
     1e-5), 3 frames per channel and block on 120 channels (some across
     block boundaries), 8 of them at CFO 0.002 rad/sample and phase 0.3,
     one qam16 frame (must come back hdr_ok False), 8 noise-only
     channels, noise 0.01.  Every frame decodes once, in order, hdr_ok
     and pay_ok, header and payload bytes equal, its S1 timing within 2
     of its start and the coarse sample_index on its S0 plateau;
     codebook_argmax launched twice per block (header and payload) and
     bit-equal to its plain version on the path's own soft bits, timed
     there against its bound; the step's time (CUDA events) and profile;
 29. OFDMFlexFrameSync on the card over six frames of six configs
     (golay2412 on codebook_argmax, v27 on viterbi_acs, hamming74 on the
     device einsum, uncoded on the host): every frame with the bytes
     sent, each kernel launched once per such payload and held to its
     plain version on the payload's own symbols;
 30. ofdm_frame_sync on the card on the reference frame offg_a (S1 found
     where the CPU finds it, the header's bytes), ofdm_detector_stream on
     the card against the CPU on offg_a in noise, ofdmflexframesync on
     the card decoding offg_a and offg_b.

The JSON line before the card's name lists all seven kernels, each with
its launches on its main path (codebook_argmax also per path, in
"launches_by_path": frame64 receiver, scanner, flexframe receiver, GMSK
receiver, OFDM receiver, OFDMFlexFrameSync; viterbi_acs on the GMSK
receiver with v27 payloads, on the flexframe receiver and on
OFDMFlexFrameSync; each counted from 0 over its own run), its error
against the plain version (for viterbi_acs the count of decoded bits that
differ), its time,
the plain version's, the time of one PyTorch call for the same function
where there is one (F.conv1d for fir_real), and its bound: the larger of
the bytes it must move over 3.35 TB/s and its float32 operations over
67 TFLOP/s (a multiply-add counts 2), from this run's shapes and data.
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
TR_B, TR_T, TR_NBLK = 256, 1 << 15, 3   # timing family: channels x samples
TR_CMP = 1024      # steps (x3 slots for pll_lms) of the kernel-vs-plain runs
TR_AGC = 1024      # samples of the agc_scan comparison (its plain loop is slow)
TR_TAIL = 8192     # symtrack symbols checked in the last block
TR_SMALL = (4, 4096)   # channels x samples of the card-vs-CPU run
TOL_TAIL = 5e-3    # symsync tail error (tests/test_symsync_misc.py:45-56)
TOL_STREAM = 2e-4  # symtrack stream tolerance (tests/test_framing_extras.py:56)
TOL_AGC = 1e-6     # agc_scan vs plain, max|err|/rms, if not bit-equal
MAX_SER = 1e-3     # symtrack symbol errors over the checked tail
RX_B, RX_T = 128, 1 << 15   # receiver: channels x samples per block
RX_NBLK = 3                 # carried receiver blocks (plus one flush block)
RX_QUIET = 8                # noise-only channels (the last ones)
RX_FRAMES = 8               # frames per channel with frames
FIR_L = 144                 # fir_real taps (the headline chain's fused FIR)
TOL_FIR = 1e-5              # fir_real kernel vs plain, max|err|/rms
TOL_SHAPES = 1e-5           # mix_fir_decim vs plain at the structure's shapes
# (B, T, L, down): a template instance each, the run-time down (256: 8
# outputs per tile, 2 taps per component), one tap, a tail of 4-tap steps
MIX_SHAPES = ((16, 6144, 41, 4), (8, 4096, 257, 1), (8, 2048, 257, 256),
              (8, 2048, 1, 1), (24, 8192, 100, 8))
FIR_SHAPES = ((6, 4096, 1), (6, 4096, 13), (6, 4096, 257), (2, 3000, 4096),
              (6, 2053, 144))   # (rows, T, L): a ragged T stores past no row
TR_STRESS = 509             # steps of the symsync_scan stress cases (ragged)
PLL_STRESS = 1536           # slots of the pll_lms stress cases
AGC_STRESS = 1024           # samples of the longest agc_scan stress cases
CH_M, CH_B, CH_T = 64, 16, 1 << 16   # channelizers: tools/bench_channelizer.py
CH_BIG_M = 1024             # a bank in the branch-filter + cuFFT regime
CH_ITERS, CH_PROF = 100, 5  # channelizer calls timed by events, profiled
TOL_GOLDEN = 2e-4           # channelizer goldens (tests/test_channelizer.py)
TOL_LOOP = 2e-3             # firpfbch2 loopback after its delay (same file)
TOL_EQUIV = 1e-3            # analyzer vs mix, filter, decimate (same file)
TOL_REGIME = 1e-4           # FFT regime vs fused matrices, max|err|/rms
SC_M, SC_S, SC_T = 64, 2, 1 << 15   # scanner: channels, wideband streams,
SC_NBLK = 3                 # channel samples per block; carried blocks
SC_TONE = 11                # the interferer's (odd) channel
# synthesis -> analysis delay in channel samples: the reference autotest's
# wideband delay 2Mm - M/2 + 1 (tests/test_channelizer.py:61-76) over the
# hop M/2, rounded: 4m - 1 = 15 at m = 4
SC_DELAY = round((2 * SC_M * 4 - SC_M // 2 + 1) / (SC_M // 2))
FF_B, FF_T, FF_NBLK = 128, 1 << 15, 3   # flexframe receiver
FF_PL, FF_MAX = 64, 8       # payload bytes; candidate slots per block
FF_QUIET = 8                # noise-only channels (the last ones)
FF_GOLD, FF_CFO, FF_FOREIGN = 1, 2, 3   # channels with ffg_a, CFO, another
VT_N, VT_DEC = 512, 68      # viterbi_acs at the GMSK receiver's shape
VT_BENCH = 256, 64          # tools/bench_viterbi.py's largest batch x dec_len
VT_ITERS = 200              # launches per viterbi_acs timing
GM_B, GM_T, GM_NBLK = 128, 1 << 15, 3   # the GMSK stream receiver
GM_PL, GM_QUIET = 64, 8     # payload bytes; noise-only channels (the last)
GM_PER_BLOCK = 3            # frames per channel and block
GM_CFO = tuple(range(1, 9))  # CFO 0.0015 rad/sample, phase 0.3
GM_FOREIGN = 9              # also carries a frame of another config
CV_B, CV_T, CV_NBLK = 16, 1 << 15, 3    # flexframe with a v27 payload
OF_B, OF_T, OF_NBLK = 128, 1 << 15, 3   # the OFDM flexframe receiver
OF_PL, OF_MAX, OF_QUIET = 64, 8, 8      # payload bytes; slots; noise only
OF_PER_BLOCK = 3            # frames per channel and block
OF_CFO = tuple(range(1, 9))  # CFO 0.002 rad/sample, phase 0.3
OF_FOREIGN = 9              # also carries a frame of another config
OF_S1 = 2 * 80 + 16         # S1's body after the frame start (M=64, cp=16)
OF_PLATEAU = 2 * 80 - 64    # the S0 plateau: coarse index in [s0, s0 + 96]
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 rate outside the tensor cores


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def bound(n_bytes, n_ops):
    """{"bound_ms", "bound_by"}: the least time the card could take, the
    larger of bytes moved once over the memory rate and float32 operations
    over the peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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
    """Mean ms per call over `iters` calls, CUDA events, after 3 warm-up
    calls."""
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
    t_phase = time.perf_counter()

    def took(what):
        """Prints the host seconds since the last call; frees the cache."""
        nonlocal t_phase
        now = time.perf_counter()
        print(f"elapsed: {what} {now - t_phase:.1f} s", flush=True)
        t_phase = now
        torch.cuda.empty_cache()

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

    # the kernel's structure at other shapes, both mixer signs: a block
    # that walks 1, 2 or 3 tiles, each template instance, the run-time down
    from liquid_dsp_tpu_torch.ops.kernels.mix_fir_decim import SUB, make_ramp
    held = []
    for Bs, Ts, Ls, ds in MIX_SHAPES:
        worst_s = 0.0
        for sg in (-1.0, 1.0):
            g = torch.Generator(device=dev).manual_seed(Ls + ds)
            args = [torch.randn(Bs, Ts, generator=g, device=dev),
                    torch.randn(Bs, Ts, generator=g, device=dev),
                    torch.randn(Bs, SUB, generator=g, device=dev),
                    torch.randn(Bs, SUB, generator=g, device=dev),
                    torch.tensor(2.9, device=dev)]
            args += [torch.from_numpy(r).to(dev) for r in make_ramp(Ls, 0.31)]
            args.append(torch.randn(Ls, generator=g, device=dev) / Ls ** 0.5)
            kw = dict(down=ds, sgn=sg, dphi=0.31)
            worst_s = max(worst_s, complex_err(
                mix_fir_decim(*args, **kw),
                mix_fir_decim_reference(*args, **kw))[1])
        torch.cuda.synchronize()
        check(worst_s < TOL_SHAPES, f"mix_fir_decim at B={Bs} T={Ts} L={Ls} "
              f"down={ds}: {worst_s:.3e}")
        held.append(f"{Bs}x{Ts} L={Ls} down={ds}: {worst_s:.2e}")
    print(f"mix_fir_decim vs plain at other shapes, both signs (< "
          f"{TOL_SHAPES}): " + "; ".join(held), flush=True)

    n_taps = int(kern.taps.numel())
    kernels = [{
        "name": "mix_fir_decim", "route": "cuda",
        "source": "liquid_dsp_tpu_torch/csrc/mix_fir_decim.cu",
        "replaces": "liquid_dsp_tpu/ops/kernels/pallas_chain.py:154",
        "launches": launches, "max_abs_err": max_abs,
        "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        # planes in and out once; per output L taps x 2 planes, per input
        # one complex rotation (6 operations)
        **bound(2 * B * T * 4 + 2 * B * (T // kern.down) * 4,
                B * (T // kern.down) * n_taps * 2 * 2 + B * T * 6)}]
    print(f"bound: mix_fir_decim {kernels[0]['bound_ms']:.4f} ms by "
          f"{kernels[0]['bound_by']} ({n_taps} taps)", flush=True)
    del xs, outs, carries, refs, xb0
    took("phases 1-8 (the build included)")
    kernels += receiver_phases(torch, dev, card)
    took("phases 9-11")
    kernels += timing_phases(torch, dev, card)
    took("phases 12-17")
    channelizer_phases(torch, dev, card)
    took("phases 18-19")
    sc_launches, sc_err = scanner_phases(torch, dev, card)
    took("phases 20-21")
    ff_launches, ff_err = flexframe_phases(torch, dev, card)
    took("phases 22-23")
    vt = viterbi_phase(torch, dev, card)
    took("phase 24")
    gm_cb, gm_cb_err, gm_vt, gm_vt_err = gmsk_phases(torch, dev, card)
    took("phases 25-26")
    cv_launches = conv_phases(torch, dev, card)
    took("phase 27")
    of_cb, of_cb_err = ofdm_stream_phase(torch, dev, card)
    took("phase 28")
    fs_cb, fs_vt, fs_vt_err = ofdm_sync_phases(torch, dev, card)
    took("phases 29-30")
    cb = next(k for k in kernels if k["name"] == "codebook_argmax")
    # each path's run, its counts set to 0 just before it
    cb["launches_by_path"] = {"framesync64_stream_full": cb["launches"],
                              "wideband_scanner": sc_launches,
                              "flexframe_rx_stream": ff_launches,
                              "gmskframe_rx_stream": gm_cb,
                              "ofdmflex_rx_stream": of_cb,
                              "OFDMFlexFrameSync": fs_cb}
    cb["max_abs_err"] = max(cb["max_abs_err"], sc_err, ff_err, gm_cb_err,
                            of_cb_err)
    vt["launches"] = gm_vt
    vt["launches_by_path"] = {"gmskframe_rx_stream": gm_vt,
                              "flexframe_rx_stream": cv_launches,
                              "OFDMFlexFrameSync": fs_vt}
    vt["max_abs_err"] = max(vt["max_abs_err"], gm_vt_err, fs_vt_err)
    kernels.append(vt)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def receiver_phases(torch, dev, card):
    """Phases 8-11: the frame64 receiver with in-stream Golay decode, the
    codebook_argmax and fir_real kernels.  Returns their kernel entries."""
    from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
    from liquid_dsp_tpu_torch.fec.device import block_codebook
    from liquid_dsp_tpu_torch.framing.frame64 import framesync64_stream_full
    from liquid_dsp_tpu_torch.ops.fir import firfilt
    from liquid_dsp_tpu_torch.ops.kernels.codebook_argmax import (
        codebook_argmax, codebook_argmax_reference, pack_codebook)
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

    def hold_codebook(name, cw_, bip_):
        got_ = codebook_argmax(cw_, bip_)
        want_ = codebook_argmax_reference(cw_, bip_)
        torch.cuda.synchronize()
        check(torch.equal(got_, want_), f"codebook_argmax, {name}: "
              f"{int((got_ != want_).sum())} of {cw_.shape[0]} indices "
              f"differ")
        return f"{name} ({cw_.shape[0]} x {bip_.shape[0]} x {bip_.shape[1]})"

    gen = torch.Generator(device=dev).manual_seed(9)
    ham = torch.from_numpy(block_codebook("hamming1511")[0]).to(dev)
    order = torch.from_numpy(np.argsort(
        pack_codebook(bip).cpu().numpy().view(np.uint32), kind="stable")).to(dev)
    rnd = torch.where(torch.rand(32, 1000, generator=gen, device=dev) < 0.5,
                      -1.0, 1.0)
    dup = rnd.clone()
    dup[:, 900] = dup[:, 3]           # far-apart duplicate columns
    dup[:, 517] = dup[:, 516]
    dup[:, 999] = dup[:, 640]
    # rows that score highest on a duplicated column: its own signs, scaled
    mag = torch.rand(6000, 32, generator=gen, device=dev) + 0.5
    col = torch.tensor([3, 516, 640], device=dev)[
        torch.randint(0, 3, (6000,), generator=gen, device=dev)]
    tied = (mag * dup[:, col].t()).contiguous()
    idx_t = codebook_argmax(tied, dup)
    check(torch.equal(idx_t.long(), col), "codebook_argmax: a tie between "
          "duplicate columns must pick the first")
    held = [
        hold_codebook("hamming1511", torch.randn(
            20000, 15, generator=gen, device=dev), ham),
        hold_codebook("ragged rows", cw[:4099].contiguous(), bip),
        hold_codebook("columns sorted by mask", cw[:20011].contiguous(),
                      bip[:, order].contiguous()),
        hold_codebook("random codebook", torch.randn(
            10007, 32, generator=gen, device=dev), rnd),
        hold_codebook("tied duplicate columns", tied, dup)]
    print("codebook_argmax: kernel = plain also on " + "; ".join(held),
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

    held = []
    for rows_, T_, L_ in FIR_SHAPES:
        g_ = torch.Generator(device=dev).manual_seed(L_ + T_)
        x_ = torch.randn(rows_, T_, generator=g_, device=dev)
        c_ = torch.randn(rows_, L_ - 1, generator=g_, device=dev)
        h_ = torch.randn(L_, generator=g_, device=dev) / L_ ** 0.5
        y_ = fir_real(x_, c_, h_)
        ref_ = fir_real_reference(x_, c_, h_)
        torch.cuda.synchronize()
        e_ = float((y_ - ref_).abs().max() / ref_.square().mean().sqrt())
        check(y_.shape == x_.shape and e_ < TOL_FIR,
              f"fir_real at {rows_}x{T_}, {L_} taps: {e_:.3e}")
        held.append(f"{rows_}x{T_} L={L_}: {e_:.2e}")
    print(f"fir_real vs plain at other shapes (< {TOL_FIR}): "
          + "; ".join(held), flush=True)

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
    # the one PyTorch call for the same function: conv1d (a
    # cross-correlation, so the taps flipped) over [carry | rows]
    import torch.nn.functional as F
    xin = torch.cat([crow, rows], 1)[:, None, :]
    wk = hk.flip(0)[None, None, :].contiguous()
    lib_err = float((F.conv1d(xin, wk)[:, 0] - fir_real(rows, crow, hk))
                    .abs().max() / rows.square().mean().sqrt())
    check(lib_err < TOL_FIR, f"F.conv1d vs fir_real: {lib_err:.3e}")
    fr_lib = time_ms(lambda: F.conv1d(xin, wk))
    del xin
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
          f"{fp1:.4f}, {fp2:.4f}) and F.conv1d {fr_lib:.4f} ms at {B}x{T} "
          f"complex ({2 * B} rows), {FIR_L} taps", flush=True)
    profile_steps(torch, card, lambda: proc(c1, x1), 3,
                  f"framesync64_stream_full step at {RX_B}x{RX_T}")
    N, n, K = cw.shape[0], cw.shape[1], bip.shape[1]
    # soft bits in, indices out, the codebook once; one multiply-add per
    # (row, bit, codeword)
    cb_bound = bound(N * n * 4 + N * 4 + bip.numel() * bip.element_size(),
                     2 * N * n * K)
    # rows in and out once; one multiply-add per output and tap
    fr_bound = bound(2 * rows.numel() * 4, 2 * rows.numel() * FIR_L)
    print(f"bound: codebook_argmax {cb_bound['bound_ms']:.4f} ms by "
          f"{cb_bound['bound_by']}; fir_real {fr_bound['bound_ms']:.4f} ms "
          f"by {fr_bound['bound_by']}", flush=True)
    return [{
        "name": "codebook_argmax", "route": "cuda",
        "source": "liquid_dsp_tpu_torch/csrc/codebook_argmax.cu",
        "replaces": "liquid_dsp_tpu/ops/kernels/pallas_codebook.py:40",
        "launches": cb_launches,
        "max_abs_err": float((idx_k - idx_p).abs().max()),
        "ms": cb_ms, "plain_ms": cb_plain, "library_ms": None,
        **cb_bound}, {
        "name": "fir_real", "route": "cuda",
        "source": "liquid_dsp_tpu_torch/csrc/fir_real.cu",
        "replaces": "liquid_dsp_tpu/ops/kernels/pallas_fir.py:51",
        "launches": fir_launches, "max_abs_err": abs_fir,
        "ms": fr_ms, "plain_ms": fr_plain, "library_ms": fr_lib,
        **fr_bound}]


def time_once(fn):
    """(ms, result) of one call, CUDA events."""
    import torch
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1), out


def make_timing_stream(rng, B, n, m, snr_db, carrier):
    """QPSK at 2 samples/symbol through an arkaiser(2, m, 0.3) pulse with a
    fractional delay in [-0.5, 0.5) samples per channel, white noise at
    `snr_db`: x [B, n] complex64 and the symbol indices sent [B, n/2 + 2m].
    With `carrier`, each channel also gets a gain in [0.3, 2] and a
    carrier phase, and every 4th channel a CFO of 1e-4..5e-4 rad/sample."""
    from scipy.signal import upfirdn
    from liquid_dsp_tpu_torch.design.firdes import firdes_prototype
    from liquid_dsp_tpu_torch.modem import constellation
    table = constellation("qpsk").astype(np.complex64)
    nsym = n // 2 + 2 * m
    idx = rng.integers(0, 4, (B, nsym))
    x = np.empty((B, n), np.complex64)
    t = np.arange(n)
    for ch in range(B):
        h = firdes_prototype("arkaiser", 2, m, 0.3, rng.uniform(-0.5, 0.5))
        s = upfirdn(h, table[idx[ch]], up=2)[:n]
        gain = 1.0
        if carrier:
            gain = float(np.exp(rng.uniform(np.log(0.3), np.log(2.0))))
            cfo = (rng.uniform(1e-4, 5e-4) * rng.choice([-1.0, 1.0])
                   if ch % 4 == 0 else 0.0)
            s = gain * s * np.exp(1j * (rng.uniform(0, 2 * np.pi) + cfo * t))
        sigma = gain * 10 ** (-snr_db / 20) / np.sqrt(2)
        x[ch] = s + sigma * (rng.standard_normal(n)
                             + 1j * rng.standard_normal(n))
    return x, idx


def tail_err(y, syms, window=400, dmax=20):
    """tests/test_symsync_misc.py's _tail_err: the least mean |y - sent|^2
    over the last `window` outputs, for delays 0..dmax-1."""
    best = np.inf
    for d in range(dmax):
        L = min(len(y) - d, len(syms))
        if L <= window:
            continue
        best = min(best, float(np.mean(np.abs(
            y[d + L - window:d + L] - syms[L - window:L]) ** 2)))
    return best


def qpsk_ser(rec, sent, rot, n, dmax=64, probe=512):
    """Symbol error rate of the last `n` decisions of `rec` (all of a
    channel's, in order) against the indices `sent`, at the delay d (rec[j]
    is sent[j - d]) and the 90-degree rotation (`rot[r]` maps a sent
    index) that fit their first `probe` symbols best."""
    a = len(rec) - n
    tail, best = rec[a:], (2.0, 0, 0)
    for d in range(dmax):
        for r in range(4):
            s = rot[r][sent[a - d:a - d + probe]]
            best = min(best, (float(np.mean(s != tail[:probe])), d, r))
    _, d, r = best
    return float(np.mean(rot[r][sent[a - d:a - d + n]] != tail))


def profile_steps(torch, card, step, n, what):
    """torch.profiler over n calls of `step`: prints the device time per
    call by kernel (the 8 largest), the device operations per call and the
    busy share (device time over the host clock of the n calls, taken with
    the profiler on: its own host work counts as idle), and returns
    {kernel name: (device ms, launches)} over the n calls.  One call before
    them is the profiler's warm-up cycle, traced and thrown away: a
    profiler's first device events can be lost while the tracing starts.
    (Host and device time stamps differ by up to a millisecond, so a
    window on the host's clock cannot pick the events.)  Fails when the
    profiler records no device event."""
    by_name, wall = device_profile(torch, step, n, what)
    dev_ms = sum(t for t, _ in by_name.values())
    ops = sum(c for _, c in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    whole = "" if ops % n == 0 else \
        f" (INCOMPLETE: {ops} events are no multiple of the calls)"
    print(f"profile ({card}): {what}, {n} calls: device time "
          f"{dev_ms / n:.3f} ms per call in {ops / n:.0f} device "
          f"operations{whole}, "
          f"host clock {wall / n:.3f} ms per call and busy share "
          f"{dev_ms / wall:.3f}, both with the profiler on; by kernel, ms "
          f"per call (launches per call): " + "; ".join(
              f"{name[:48]} {t / n:.3f} ({c / n:.0f})"
              for name, (t, c) in top), flush=True)
    return by_name


def device_profile(torch, step, n, what):
    """({kernel name: (device ms, launches)} over n calls of `step`,
    host ms of the n calls), torch.profiler after its warm-up cycle (see
    `profile_steps`)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        step()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.events():
        # the profiler mirrors its cycle on the device as an annotation
        # "ProfilerStep#k", which is no kernel
        if ev.device_type == torch.autograd.DeviceType.CUDA and \
                not ev.name.startswith("ProfilerStep"):
            tot, cnt = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (tot + ev.time_range.elapsed_us() / 1e3,
                                cnt + 1)
    if not by_name:
        fail(f"profile: {what}: the profiler recorded no device event")
    return by_name, wall


def synth_slots(torch, dev, st, B, S, share, seed):
    """Slots for `pll_lms` on the card from a seed: points of the tracker's
    constellation under a carrier phase per channel, noise 0.03, a share of
    them valid at random places (the others carry samples too);
    (s_re, s_im, valid)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(0, st.tab_re.shape[0], (B, S), generator=g,
                        device=dev)
    # within 0.3 rad of a multiple of 90 degrees: a decision-directed loop
    # pulls in from there on any square constellation
    ph = (torch.rand(B, 1, generator=g, device=dev) * 0.6 - 0.3
          + torch.randint(0, 4, (B, 1), generator=g, device=dev) * (np.pi / 2))
    sr = st.tab_re[idx] * torch.cos(ph) - st.tab_im[idx] * torch.sin(ph)
    si = st.tab_re[idx] * torch.sin(ph) + st.tab_im[idx] * torch.cos(ph)
    sr = sr + 0.03 * torch.randn(B, S, generator=g, device=dev)
    si = si + 0.03 * torch.randn(B, S, generator=g, device=dev)
    valid = torch.rand(B, S, generator=g, device=dev) < share
    return sr.contiguous(), si.contiguous(), valid


def symsync_bound(out, P, B, Tc, max_out):
    """Bound of one `symsync_scan` call from its own output: 2P floats read
    per active emit, 9 bytes written per slot, the state read and written;
    about 12 float32 operations per active emit."""
    active = int(out[2].sum())
    return bound(active * 2 * P * 4 + B * Tc * max_out * 9 + 2 * 8 * B * 4,
                 active * 12)


def pll_bound(valid, L):
    """Bound of one `pll_lms` call: 9 bytes read and 12 written per slot,
    the state read and written; per valid slot the L-tap complex dot and
    update (16 L operations) and about 60 for the PLL and the slicers."""
    B, S = valid.shape
    return bound(B * S * 21 + 2 * B * (4 * L + 4) * 4,
                 int(valid.sum()) * (16 * L + 60))


def timing_phases(torch, dev, card):
    """Phases 12-16: symsync and symtrack_stream at full width, the
    symsync_scan, agc_scan and pll_lms kernels.  Returns their kernel
    entries."""
    from unittest import mock
    from liquid_dsp_tpu_torch.framing.symtrack import symtrack_stream
    from liquid_dsp_tpu_torch.modem import constellation
    from liquid_dsp_tpu_torch.ops import symsync as symsync_mod
    from liquid_dsp_tpu_torch.ops.kernels.agc_scan import (
        agc_scan, agc_scan_reference)
    from liquid_dsp_tpu_torch.ops.kernels.pll_lms import (
        pll_lms, pll_lms_reference)
    from liquid_dsp_tpu_torch.ops.kernels.symsync_scan import (
        symsync_scan, symsync_scan_reference)
    from liquid_dsp_tpu_torch.ops.symsync import (
        _chunks, branch_kernel, branch_outputs, loop_state, symsync)

    B, T, NB = TR_B, TR_T, TR_NBLK
    nch = len(_chunks(T, True))
    table = constellation("qpsk").astype(np.complex64)
    rot = [np.array([int(np.argmin(np.abs(table - p * 1j ** r)))
                     for p in table]) for r in range(4)]

    # 12. symsync at full width
    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    x_np, idx = make_timing_stream(rng, B, NB * T, 5, 40.0, False)
    x1 = torch.from_numpy(x_np).to(dev)
    del x_np
    t_gen = time.perf_counter() - t0
    ss = symsync(k=2, m=5).to(dev)
    c = ss.init(batch_shape=(B,), device=dev)
    ss_carries, outs = [c], []
    symsync_scan.launches = 0
    for b in range(NB):
        out, c = ss(c, x1[:, b * T:(b + 1) * T])
        outs.append(out)
        ss_carries.append(c)
    torch.cuda.synchronize()
    ss_launches = symsync_scan.launches
    check(ss_launches == nch * NB, f"symsync_scan launched {ss_launches} "
          f"times for {nch} chunks x {NB} blocks")
    counts = torch.stack([v.sum(-1) for _, v in outs]).cpu().numpy()
    check(np.abs(counts[1:] - T // 2).max() <= 2, f"symsync: symbols per "
          f"block after lock {counts[1:].min()}..{counts[1:].max()}, "
          f"want {T // 2} +- 2")
    ys = torch.cat([y for y, _ in outs], -1).cpu().numpy()
    vs = torch.cat([v for _, v in outs], -1).cpu().numpy()
    check(np.isfinite(ys).all(), "symsync: non-finite output")
    errs = [tail_err(ys[ch][vs[ch]], table[idx[ch]]) for ch in range(B)]
    check(max(errs) < TOL_TAIL, f"symsync tail error {max(errs):.3e} "
          f"(channel {int(np.argmax(errs))}) >= {TOL_TAIL}")
    print(f"symsync: symsync(k=2, m=5) at {B}x{T}, {NB} carried blocks, "
          f"40 dB SNR; symbols per block after lock {counts[1:].min()}.."
          f"{counts[1:].max()} (T/2 = {T // 2}); tail error max "
          f"{max(errs):.3e} (< {TOL_TAIL}) on all {B} channels; "
          f"symsync_scan launches {ss_launches} ({nch} chunks x {NB} "
          f"blocks); stream made in {t_gen:.1f} s", flush=True)

    # 13. symtrack_stream at full width
    t0 = time.perf_counter()
    x_np, idx2 = make_timing_stream(rng, B, NB * T, 7, 20.0, True)
    x2 = torch.from_numpy(x_np).to(dev)
    del x_np
    t_gen = time.perf_counter() - t0
    st = symtrack_stream(ms="qpsk").to(dev)
    c = st.init(batch_shape=(B,), device=dev)
    st_carries, st_outs = [c], []
    agc_scan.launches = symsync_scan.launches = pll_lms.launches = 0
    t0 = time.perf_counter()
    for b in range(NB):
        out, c = st(c, x2[:, b * T:(b + 1) * T])
        st_outs.append(out)
        st_carries.append(c)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = {"agc_scan": agc_scan.launches,
                "symsync_scan": symsync_scan.launches,
                "pll_lms": pll_lms.launches}
    want = {"agc_scan": NB, "symsync_scan": nch * NB, "pll_lms": NB}
    check(launches == want, f"symtrack launches {launches}, want {want}")
    for sy, dec, sv in st_outs:
        check(sy.shape == (B, 3 * T) and dec.shape == (B, 3 * T),
              f"symtrack output {tuple(sy.shape)} {tuple(dec.shape)}")
        check(bool(torch.isfinite(torch.view_as_real(sy)).all()),
              "symtrack: non-finite symbols")
    dec_all = torch.cat([d for _, d, _ in st_outs], -1).cpu().numpy()
    val_all = torch.cat([v for _, _, v in st_outs], -1).cpu().numpy()
    last = st_outs[-1][2].sum(-1).cpu().numpy()
    check(last.min() >= TR_TAIL, f"symtrack: {last.min()} symbols in the "
          f"last block")
    sers = [qpsk_ser(dec_all[ch][val_all[ch]], idx2[ch], rot, TR_TAIL)
            for ch in range(B)]
    check(max(sers) <= MAX_SER, f"symtrack SER {max(sers):.2e} (channel "
          f"{int(np.argmax(sers))}) > {MAX_SER}")
    print(f"symtrack: symtrack_stream(ms='qpsk') at {B}x{T}, {NB} carried "
          f"blocks, gain 0.3-2, random phase, CFO up to 5e-4 rad/sample on "
          f"{(B + 3) // 4} channels, 20 dB SNR; SER over the last "
          f"{TR_TAIL} symbols max {max(sers):.2e} (<= {MAX_SER}), "
          f"{sum(s > 0 for s in sers)} channels with any error; launches "
          f"{launches}; stream made in {t_gen:.1f} s, first pass "
          f"{t_run:.2f} s", flush=True)

    # 14. each kernel against its plain version, same inputs and states
    c1 = ss_carries[1]
    kern = branch_kernel(ss.mf, ss.dmf, dev)
    xp = torch.cat([c1["win"][..., 1:], x1[:, T:T + TR_CMP]], -1)
    ma = branch_outputs(kern, torch.stack([xp.real, xp.imag]).contiguous())
    fs, is_ = loop_state(c1, B)
    kw = dict(npfb=32, max_out=3, k=2, k_out=1, bw=ss.bw, locked=False)
    out_k = symsync_scan(ma, fs, is_, **kw)
    ssp1, out_p = time_once(lambda: symsync_scan_reference(ma, fs, is_, **kw))
    check(all(torch.equal(a, b) for a, b in zip(out_k, out_p)),
          "symsync_scan: kernel and plain version differ")
    ss_err = float((out_k[0] - out_p[0]).abs().max()
                   + (out_k[1] - out_p[1]).abs().max())

    xa = x2[:, T:T + TR_AGC]
    p = (xa.real * xa.real + xa.imag * xa.imag).contiguous()
    ca = st_carries[1]["agc"]
    akw = dict(alpha=st.ag.alpha)
    g_k = agc_scan(p, ca["g"], ca["y2_prime"], **akw)
    agp1, g_p = time_once(lambda: agc_scan_reference(
        p, ca["g"], ca["y2_prime"], **akw))
    agc_equal = all(torch.equal(a, b) for a, b in zip(g_k, g_p))
    agc_err = float((g_k[0] - g_p[0]).abs().max())
    agc_rel = agc_err / float(g_p[0].square().mean().sqrt())
    check(agc_equal or agc_rel <= TOL_AGC, f"agc_scan vs plain: "
          f"{agc_rel:.3e} of rms")

    c2 = st_carries[2]
    ya, _ = st.ag(c2["agc"], x2[:, 2 * T:2 * T + TR_CMP])
    (sy, sv), _ = st.ss(c2["ss"], ya)
    sr, si = sy.real.contiguous(), sy.imag.contiguous()
    pc = st.pll_state(c2, B)
    pkw = st.pll_kwargs()
    pl_k = pll_lms(sr, si, sv, pc, st.tab_re, st.tab_im, **pkw)
    plp1, pl_p = time_once(lambda: pll_lms_reference(
        sr, si, sv, pc, st.tab_re, st.tab_im, **pkw))
    pll_err = max(float((pl_k[0] - pl_p[0]).abs().max()),
                  float((pl_k[1] - pl_p[1]).abs().max()))
    check(pll_err <= TOL_STREAM, f"pll_lms vs plain: {pll_err:.3e}")
    check(torch.equal(pl_k[2], pl_p[2]), f"pll_lms: "
          f"{int((pl_k[2] != pl_p[2]).sum())} decisions differ")
    print(f"kernels vs plain: symsync_scan bit-equal (y, valid, state) over "
          f"{TR_CMP} steps x {B} channels; agc_scan "
          f"{'bit-equal' if agc_equal else f'{agc_rel:.3e} of rms'} over "
          f"{TR_AGC} samples (max|err| {agc_err:.3e}); pll_lms max|err| "
          f"{pll_err:.3e} (<= {TOL_STREAM}), decisions equal over "
          f"{sr.shape[1]} slots", flush=True)

    ss_bound = symsync_bound(out_k, 2, B, TR_CMP, 3)
    ag_bound = bound(2 * p.numel() * 4, p.numel() * 12)
    pl_bound = pll_bound(sv, st.L)

    # 14b. the two kernels' structure under stress
    def hold_symsync(name, ma_, fs_, is__, **kws):
        k_ = symsync_scan(ma_, fs_, is__, **kws)
        p_ = symsync_scan_reference(ma_, fs_, is__, **kws)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(k_, p_)),
              f"symsync_scan, {name}: kernel and plain version differ")
        return int(k_[2].sum())

    n_s = TR_STRESS
    ma_s = ma[..., :n_s].contiguous()
    xr = torch.cat([c1["win"][..., 1:].real, x1[:, T:T + n_s].real], -1)
    ma_real = branch_outputs(kern, xr[None].contiguous())
    c0 = ss_carries[0]
    xp0 = torch.cat([c0["win"][..., 1:], x1[:, :n_s]], -1)
    ma_acq = branch_outputs(kern, torch.stack([xp0.real, xp0.imag])
                            .contiguous())
    fs0, is0 = loop_state(c0, B)
    stress = {
        "ragged chunk": hold_symsync("ragged chunk", ma_s, fs, is_, **kw),
        "real stream (P=1)": hold_symsync("P=1", ma_real, fs, is_, **kw),
        "locked": hold_symsync("locked", ma_s, fs, is_,
                               **dict(kw, locked=True)),
        "k=3, k_out=2": hold_symsync("k=3, k_out=2", ma_s, fs, is_,
                                     **dict(kw, k=3, k_out=2)),
        "from the zero state": hold_symsync("zero state", ma_acq, fs0, is0,
                                            **kw)}
    del ma_s, ma_real, ma_acq

    def hold_pll(name, trk, sr_, si_, sv_):
        pc_ = trk.pll_state(trk.init(batch_shape=(B,), device=dev), B) \
            if trk is not st else pc
        args = (sr_, si_, sv_, pc_, trk.tab_re, trk.tab_im)
        k_ = pll_lms(*args, **trk.pll_kwargs())
        p_ = pll_lms_reference(*args, **trk.pll_kwargs())
        torch.cuda.synchronize()
        err = max(float((k_[j] - p_[j]).abs().max()) for j in (0, 1))
        check(err <= TOL_STREAM, f"pll_lms, {name}: {err:.3e} vs plain")
        check(torch.equal(k_[2], p_[2]) and torch.equal(
            k_[3]["eq_n"], p_[3]["eq_n"]), f"pll_lms, {name}: "
            f"{int((k_[2] != p_[2]).sum())} decisions differ")
        # the state, at the card tests' limit
        for key in p_[3]:
            d = float((k_[3][key].float() - p_[3][key].float()).abs().max())
            check(d <= TOL_STREAM, f"pll_lms, {name}: state {key} {d:.3e}")
        return err

    n_p = PLL_STRESS
    sv_gap = sv[:, :n_p].clone()
    sv_gap[::4] = False          # no valid slot at all; the samples stay
    n_all = int(sv.sum(-1).min()) // 32 * 32 - 7      # not a multiple of 32
    order = torch.argsort((~sv).to(torch.uint8), dim=1, stable=True)[:, :n_all]
    st16 = symtrack_stream(ms="qam16").to(dev)
    st32 = symtrack_stream(ms="qpsk", eq_len=32).to(dev)
    pll_stress = {
        "no valid slot on every 4th channel": hold_pll(
            "channels without a valid slot", st, sr[:, :n_p].contiguous(),
            si[:, :n_p].contiguous(), sv_gap),
        f"all {n_all} slots valid": hold_pll(
            "all slots valid", st, sr.gather(1, order).contiguous(),
            si.gather(1, order).contiguous(),
            torch.ones(B, n_all, dtype=torch.bool, device=dev)),
        "argmin slicer (qam16)": hold_pll(
            "argmin slicer", st16, *synth_slots(torch, dev, st16, B, n_p,
                                                0.3, 16)),
        "L=32": hold_pll("L=32", st32, *synth_slots(torch, dev, st32, B, n_p,
                                                    0.3, 32))}
    print(f"kernels vs plain under stress, {B} channels: symsync_scan "
          f"bit-equal over {n_s} steps on "
          + "; ".join(f"{k_} ({v_} symbols)" for k_, v_ in stress.items())
          + f"; pll_lms over {n_p} slots, decisions equal, max|err| "
          + "; ".join(f"{k_} {v_:.3e}" for k_, v_ in pll_stress.items())
          + f" (<= {TOL_STREAM})", flush=True)

    # 14c. agc_scan's structure under stress: bit-equal each time
    def hold_agc(name, p_, g_, y_, **kws):
        k_ = agc_scan(p_, g_, y_, **kws)
        r_ = agc_scan_reference(p_, g_, y_, **kws)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(k_, r_)),
              f"agc_scan, {name}: kernel and plain version differ, max|err| "
              f"{float((k_[0] - r_[0]).abs().max()):.3e}")
        return (f"{name} ({p_.shape[0]} x {p_.shape[1]}; gains "
                f"{float(r_[0].min()):.3g}..{float(r_[0].max()):.3g}, y2p "
                f"{float(r_[2].min()):.3g}..{float(r_[2].max()):.3g})")

    def stress_power(nb_, nt_, seed):
        # power from 1e-8 to 1e4 across the channels; in mid-block a step
        # down by 1e6, a step up by 1e4, or silence (y2p falls below the
        # guard) on a channel in three each
        g_ = torch.Generator(device=dev).manual_seed(seed)
        p_ = torch.rand(nb_, nt_, generator=g_, device=dev) * torch.logspace(
            -8, 4, nb_, device=dev)[:, None]
        p_[::3, nt_ // 2:] *= 1e-6
        p_[1::3, nt_ // 3:] *= 1e4
        p_[2::3, nt_ // 2:] = 0.0
        return p_.contiguous()

    def ones(n_, v=1.0):
        return torch.full((n_,), v, device=dev)

    agc_stress = [
        hold_agc("locked", p[:, :AGC_STRESS].contiguous(), ca["g"],
                 ca["y2_prime"], alpha=st.ag.alpha, locked=True),
        hold_agc("ragged T and B, alpha 1e-3", stress_power(70, 1021, 1),
                 ones(70), ones(70), alpha=1e-3),
        hold_agc("alpha 0.5, power 1e-8..1e4 with steps",
                 stress_power(B, AGC_STRESS // 2, 2), ones(B), ones(B),
                 alpha=0.5),
        hold_agc("from g at the clamp", stress_power(B, AGC_STRESS // 2, 3),
                 ones(B, 1e6), ones(B), alpha=st.ag.alpha),
        hold_agc("less than a tile", stress_power(33, 7, 4), ones(33),
                 ones(33), alpha=0.1)]
    print(f"agc_scan vs plain under stress, bit-equal (gains, g, y2p): "
          + "; ".join(agc_stress), flush=True)

    # 15. the card against the port on the CPU
    nb, ns = TR_SMALL
    xs = x2[:nb, :ns].contiguous()
    card_st = symtrack_stream(ms="qpsk").to(dev)
    (sy_g, dec_g, sv_g), _ = card_st(card_st.init(batch_shape=(nb,),
                                                   device=dev), xs)
    # the CPU forced to the card's route: the hoisted form, with the
    # timing-loop kernel's plain version
    cpu_st = symtrack_stream(ms="qpsk")
    run = symsync_mod.symsync_run
    with mock.patch.object(symsync_mod, "symsync_run",
                           lambda *a, **kw: run(*a, **kw, hoist=True)), \
            mock.patch.dict(os.environ, {"LIQUID_SYMSYNC_KERNEL": "1"}):
        (sy_c, dec_c, sv_c), _ = cpu_st(cpu_st.init(batch_shape=(nb,)),
                                        xs.cpu())
    sv_g = sv_g.cpu()
    check(torch.equal(sv_g, sv_c), "card vs CPU: valid masks differ")
    cpu_err = float((sy_g.cpu()[sv_c] - sy_c[sv_c]).abs().max())
    check(cpu_err <= TOL_STREAM, f"card vs CPU symbols: {cpu_err:.3e}")
    check(torch.equal(dec_g.cpu()[sv_c], dec_c[sv_c]),
          "card vs CPU: decisions differ")
    print(f"card vs CPU: symtrack_stream at {nb}x{ns}, {int(sv_c.sum())} "
          f"symbols: valid masks and decisions equal, symbols max|err| "
          f"{cpu_err:.3e} (<= {TOL_STREAM})", flush=True)

    # 16. times: plain, kernel, kernel, plain at the comparison shapes,
    # then each kernel at full width and the block steps
    ssk1 = time_ms(lambda: symsync_scan(ma, fs, is_, **kw), iters=5)
    ssk2 = time_ms(lambda: symsync_scan(ma, fs, is_, **kw), iters=5)
    ssp2 = time_once(lambda: symsync_scan_reference(ma, fs, is_, **kw))[0]
    ak1 = time_ms(lambda: agc_scan(p, ca["g"], ca["y2_prime"], **akw))
    ak2 = time_ms(lambda: agc_scan(p, ca["g"], ca["y2_prime"], **akw))
    agp2 = time_once(lambda: agc_scan_reference(
        p, ca["g"], ca["y2_prime"], **akw))[0]
    plk1 = time_ms(lambda: pll_lms(sr, si, sv, pc, st.tab_re, st.tab_im,
                                   **pkw), iters=5)
    plk2 = time_ms(lambda: pll_lms(sr, si, sv, pc, st.tab_re, st.tab_im,
                                   **pkw), iters=5)
    plp2 = time_once(lambda: pll_lms_reference(
        sr, si, sv, pc, st.tab_re, st.tab_im, **pkw))[0]
    ss_ms, ss_plain = (ssk1 + ssk2) / 2, (ssp1 + ssp2) / 2
    ag_ms, ag_plain = (ak1 + ak2) / 2, (agp1 + agp2) / 2
    pl_ms, pl_plain = (plk1 + plk2) / 2, (plp1 + plp2) / 2
    print(f"timing ({card}): symsync_scan kernel {ss_ms:.4f} ms (runs "
          f"{ssk1:.4f}, {ssk2:.4f}) vs plain {ss_plain:.2f} ms (runs "
          f"{ssp1:.2f}, {ssp2:.2f}) at {B} x {TR_CMP} steps = "
          f"{ss_ms / TR_CMP * 1e3:.3f} vs {ss_plain / TR_CMP * 1e3:.1f} "
          f"us per step", flush=True)
    print(f"timing ({card}): agc_scan kernel {ag_ms:.4f} ms (runs "
          f"{ak1:.4f}, {ak2:.4f}) vs plain {ag_plain:.2f} ms (runs "
          f"{agp1:.2f}, {agp2:.2f}) at {B} x {TR_AGC} samples = "
          f"{ag_ms / TR_AGC * 1e3:.3f} vs {ag_plain / TR_AGC * 1e3:.1f} "
          f"us per step", flush=True)
    print(f"timing ({card}): pll_lms kernel {pl_ms:.4f} ms (runs "
          f"{plk1:.4f}, {plk2:.4f}) vs plain {pl_plain:.2f} ms (runs "
          f"{plp1:.2f}, {plp2:.2f}) at {B} x {sr.shape[1]} slots = "
          f"{pl_ms / sr.shape[1] * 1e3:.3f} vs "
          f"{pl_plain / sr.shape[1] * 1e3:.1f} us per slot", flush=True)
    del ma
    xp = torch.cat([c1["win"][..., 1:], x1[:, T:2 * T]], -1)
    ma_full = branch_outputs(kern, torch.stack(
        [xp[:, :T // nch + kern.shape[-1] - 1].real,
         xp[:, :T // nch + kern.shape[-1] - 1].imag]).contiguous())
    ss_full = time_ms(lambda: symsync_scan(ma_full, fs, is_, **kw), iters=3)
    ss_full_bound = symsync_bound(symsync_scan(ma_full, fs, is_, **kw), 2, B,
                                  ma_full.shape[-1], 3)
    del ma_full
    xa = x2[:, T:2 * T]
    p_full = (xa.real * xa.real + xa.imag * xa.imag).contiguous()
    ag_full = time_ms(lambda: agc_scan(p_full, ca["g"], ca["y2_prime"],
                                       **akw), iters=5)
    (sy_b, sv_b), _ = st.ss(c2["ss"], st.ag(c2["agc"], x2[:, 2 * T:])[0])
    sr_b, si_b = sy_b.real.contiguous(), sy_b.imag.contiguous()
    pl_full = time_ms(lambda: pll_lms(sr_b, si_b, sv_b, pc, st.tab_re,
                                      st.tab_im, **pkw), iters=3)
    xb2 = x2[:, 2 * T:]
    ss_step = time_ms(lambda: ss(ss_carries[2], x1[:, 2 * T:]), iters=3)
    st1 = time_ms(lambda: st(c2, xb2), iters=3)
    st2 = time_ms(lambda: st(c2, xb2), iters=3)
    st_step = (st1 + st2) / 2
    print(f"timing ({card}): at full width {B}x{T}: symsync_scan "
          f"{ss_full:.4f} ms per {T // nch}-step chunk ({nch} per block); "
          f"agc_scan {ag_full:.4f} ms per block; pll_lms {pl_full:.4f} ms "
          f"per block ({sr_b.shape[1]} slots); symsync step {ss_step:.4f} "
          f"ms = {B * T / ss_step / 1e3:.1f} Msamples/s; symtrack_stream "
          f"step {st_step:.4f} ms (runs {st1:.4f}, {st2:.4f}) = "
          f"{B * T / st_step / 1e3:.1f} Msamples/s", flush=True)
    ag_full_bound = bound(2 * p_full.numel() * 4, p_full.numel() * 12)
    pl_full_bound = pll_bound(sv_b, st.L)
    print(f"bounds (bytes once over {HBM_BYTES_PER_S / 1e12} TB/s, float32 "
          f"operations over {F32_OPS_PER_S / 1e12} TFLOP/s), ms at "
          f"{TR_CMP} steps / full width: symsync_scan "
          f"{ss_bound['bound_ms']:.5f} / {ss_full_bound['bound_ms']:.5f} per "
          f"chunk by {ss_bound['bound_by']}; agc_scan "
          f"{ag_bound['bound_ms']:.5f} / {ag_full_bound['bound_ms']:.5f} by "
          f"{ag_bound['bound_by']}; pll_lms {pl_bound['bound_ms']:.5f} / "
          f"{pl_full_bound['bound_ms']:.5f} by {pl_bound['bound_by']}",
          flush=True)

    # 17. where the tracker step's device time goes
    profile_steps(torch, card, lambda: st(c2, xb2), 3,
                  f"symtrack_stream step at {B}x{T}")
    return [{
        "name": "symsync_scan", "route": "cuda",
        "source": "liquid_dsp_tpu_torch/csrc/symsync_scan.cu",
        "replaces": "liquid_dsp_tpu/ops/kernels/pallas_symsync.py:132",
        "launches": launches["symsync_scan"], "max_abs_err": ss_err,
        "ms": ss_ms, "plain_ms": ss_plain, "library_ms": None, **ss_bound,
        "steps": TR_CMP, "full_chunk_ms": ss_full,
        "full_chunk_bound_ms": ss_full_bound["bound_ms"]}, {
        "name": "agc_scan", "route": "cuda",
        "source": "liquid_dsp_tpu_torch/csrc/agc_scan.cu", "replaces": None,
        "recurrence": "liquid_dsp_tpu/ops/agc.py:39-50 (lax.scan)",
        "launches": launches["agc_scan"], "max_abs_err": agc_err,
        "ms": ag_ms, "plain_ms": ag_plain, "library_ms": None, **ag_bound,
        "steps": TR_AGC, "full_block_ms": ag_full,
        "full_block_bound_ms": ag_full_bound["bound_ms"]}, {
        "name": "pll_lms", "route": "cuda",
        "source": "liquid_dsp_tpu_torch/csrc/pll_lms.cu", "replaces": None,
        "recurrence": "liquid_dsp_tpu/framing/symtrack.py:218-267,301-306 "
                      "(lax.scan)",
        "launches": launches["pll_lms"], "max_abs_err": pll_err,
        "ms": pl_ms, "plain_ms": pl_plain, "library_ms": None, **pl_bound,
        "steps": int(sr.shape[1]), "full_block_ms": pl_full,
        "full_block_bound_ms": pl_full_bound["bound_ms"]}]


CH_KINDS = ("firpfbch_analyzer", "firpfbch_synthesizer",
            "firpfbch2_analyzer", "firpfbch2_synthesizer")


def ch_input(torch, dev, kind, M, B, T, seed):
    """Unit-power complex noise on the card: [B, T] for an analyzer,
    [B, M, frames] for a synthesizer (the frames that make T outputs)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if "analyzer" in kind:
        shape = (B, T)
    else:
        shape = (B, M, (2 if "2" in kind else 1) * T // M)
    return torch.complex(torch.randn(shape, generator=g, device=dev),
                         torch.randn(shape, generator=g, device=dev)) / 2 ** .5


def channelizer_phases(torch, dev, card):
    """Phases 18-19: the four channelizer Procs on the card."""
    from liquid_dsp_tpu_torch.multichannel import channelizer as ch

    # 18. against the reference C library's goldens
    gold = dict(np.load(os.path.join(ROOT, "tests", "golden",
                                     "channelizer_golden.npz")))
    keys = {"firpfbch_analyzer": ("x", "Z1"),
            "firpfbch_synthesizer": ("Z1", "z1"),
            "firpfbch2_analyzer": ("x", "Y2"),
            "firpfbch2_synthesizer": ("Y2", "y2")}
    worst = 0.0
    for M, m in ((8, 4), (16, 5), (64, 3)):
        for kind in CH_KINDS:
            ink, outk = keys[kind]
            x = gold[f"{ink}_{M}_{m}"]
            if ink != "x":
                x = x.reshape(-1, M).T.copy()          # [M, frames]
            p = getattr(ch, kind)(M, m, 60.0).to(dev)
            y = p(p.init(device=dev), torch.from_numpy(x).to(dev))[0]
            y = y.cpu().numpy()
            got = y.T.reshape(-1) if "analyzer" in kind else y
            e = float(np.abs(got - gold[f"{outk}_{M}_{m}"]).max())
            check(e < TOL_GOLDEN, f"{kind}({M}, {m}) vs golden: {e:.3e}")
            worst = max(worst, e)
    print(f"channelizers: the four Procs at (M, m) = (8, 4), (16, 5), (64, 3) "
          f"on the card vs the reference goldens: max|err| {worst:.3e} (< "
          f"{TOL_GOLDEN})", flush=True)

    # 19. full width: the analyzer's equivalence, the firpfbch2 loopback,
    # the FFT regime at M = 1024 against the fused matrices, and times
    a = ch.firpfbch_analyzer(CH_M).to(dev)
    x = ch_input(torch, dev, "firpfbch_analyzer", CH_M, CH_B, CH_T, 18)
    Y = a(a.init(batch_shape=(CH_B,), device=dev), x)[0]
    check(tuple(Y.shape) == (CH_B, CH_M, CH_T // CH_M),
          f"firpfbch_analyzer output {tuple(Y.shape)}")
    h = ch.firpfbch_kaiser_taps(CH_M).astype(np.float64)
    xs = x[0].cpu().numpy().astype(np.complex128)
    t = np.arange(CH_T)
    eq = []
    for c in (1, 37):
        # channel c = x mixed down by c/M, filtered, decimated by M, up to
        # a constant unit phase per channel (firpfbch_crcf autotest)
        d = np.convolve(xs * np.exp(-2j * np.pi * c * t / CH_M),
                        h[:8 * CH_M])[:CH_T][CH_M - 1::CH_M][8:]
        yc = Y[0, c].cpu().numpy().astype(np.complex128)[8:]
        g = np.vdot(d, yc) / np.vdot(d, d)
        e = float(np.abs(yc - g * d).max() / np.sqrt(np.mean(np.abs(d) ** 2)))
        check(abs(abs(g) - 1) < TOL_EQUIV and e < TOL_EQUIV,
              f"firpfbch_analyzer channel {c} vs mix/filter/decimate: "
              f"|gain| {abs(g):.6f}, max|err|/rms {e:.3e}")
        eq.append(f"channel {c}: |gain| {abs(g):.6f}, max|err|/rms {e:.2e}")
    del Y

    def loopback(M, m=5):
        an, sy = ch.firpfbch2_analyzer(M, m).to(dev), \
            ch.firpfbch2_synthesizer(M, m).to(dev)
        xl = 0.5 * ch_input(torch, dev, "firpfbch2_analyzer", M, CH_B, CH_T,
                            M)
        Yl, _ = an(an.init(batch_shape=(CH_B,), device=dev), xl)
        yl, _ = sy(sy.init(batch_shape=(CH_B,), device=dev), Yl)
        d = 2 * M * m - M // 2 + 1
        e = float((yl[:, d:] - xl[:, :CH_T - d]).abs().max())
        check(e < TOL_LOOP, f"firpfbch2 loopback at M={M}: {e:.3e}")
        return f"M={M} m={m} (fused: {an.fused}) delay {d}: {e:.2e}"

    loops = [loopback(CH_M), loopback(CH_BIG_M)]
    regime = []
    for kind in CH_KINDS:
        p = getattr(ch, kind)(CH_BIG_M).to(dev)
        check(not p.fused, f"{kind}({CH_BIG_M}) is not in the FFT regime")
        old = ch._FUSED_MAX_M
        ch._FUSED_MAX_M = CH_BIG_M
        try:
            q = getattr(ch, kind)(CH_BIG_M).to(dev)
        finally:
            ch._FUSED_MAX_M = old
        xb = ch_input(torch, dev, kind, CH_BIG_M, 4, CH_T, 19)
        y1 = p(p.init(batch_shape=(4,), device=dev), xb)[0]
        y2 = q(q.init(batch_shape=(4,), device=dev), xb)[0]
        e = float((y1 - y2).abs().max() / y2.abs().square().mean().sqrt())
        check(e < TOL_REGIME, f"{kind}({CH_BIG_M}): FFT regime vs fused "
              f"matrices {e:.3e}")
        regime.append(f"{kind} {e:.2e}")
        del q, y1, y2
    print(f"channelizers at full width ({CH_B}x{CH_T}): firpfbch_analyzer "
          f"({CH_M}) vs float64 mix/filter/decimate on stream 0, "
          + "; ".join(eq) + f" (< {TOL_EQUIV}); firpfbch2 loopback (< "
          f"{TOL_LOOP}): " + "; ".join(loops) + f"; M={CH_BIG_M} FFT regime "
          f"vs fused matrices (< {TOL_REGIME} of rms): " + "; ".join(regime),
          flush=True)

    # CUDA events over CH_ITERS calls, and the device time per call from
    # the profiler (what the card spends, whatever the host's rate)
    rates = []
    for M in (CH_M, CH_BIG_M):
        for kind in CH_KINDS:
            p = getattr(ch, kind)(M).to(dev)
            xb = ch_input(torch, dev, kind, M, CH_B, CH_T, 20)
            c0 = p.init(batch_shape=(CH_B,), device=dev)
            ms = time_ms(lambda: p(c0, xb), iters=CH_ITERS)
            by_name, _ = device_profile(torch, lambda: p(c0, xb), CH_PROF,
                                        kind)
            d_ms = sum(t for t, _ in by_name.values()) / CH_PROF
            n_ops = sum(c for _, c in by_name.values()) / CH_PROF
            b = ""
            if p.fused:
                y = p(c0, xb)[0]
                bd = ch_bound(p, xb, y)
                b = f", bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})"
                del y
            rates.append(f"{kind}({M}) {ms:.4f} ms = "
                         f"{CH_B * CH_T / ms / 1e3:.0f}; device {d_ms:.4f} "
                         f"ms in {n_ops:.0f} operations = "
                         f"{CH_B * CH_T / d_ms / 1e3:.0f}{b}")
            del xb
    print(f"timing ({card}): channelizer block steps at {CH_B}x{CH_T} "
          f"wideband samples, ms (CUDA events over {CH_ITERS} calls) and "
          f"Msamples/s; device ms per call (torch.profiler over {CH_PROF} "
          f"calls) and Msamples/s: " + "; ".join(rates), flush=True)
    torch.cuda.empty_cache()


def ch_bound(p, x, y):
    """Bound of one fused channelizer block: input and output once and the
    dense matrices read once; each complex product on (re, im) planes is
    four real matmuls over the block's T/M frame windows (a multiply-add
    counts 2)."""
    mats = [b for name, b in p.named_buffers() if name.endswith("r")
            and b.dim() == 2 and b.is_floating_point()]
    frames = x.numel() // p.M
    if p.rate == (1, 2):
        frames //= 2        # the firpfbch2 synthesizer: two hops per window
    n_ops = sum(8 * frames * a.shape[0] * a.shape[1] for a in mats)
    n_bytes = 8 * (x.numel() + y.numel()) + sum(8 * a.numel() for a in mats)
    return bound(n_bytes, n_ops)


def make_scanner_channels(rng):
    """The scanner's channel-domain streams [SC_S, SC_M, (SC_NBLK+1)*SC_T]
    (examples/wideband_scanner_example.py at full width: noise 0.002
    everywhere, frame64 frames on the even channels, an interferer tone
    on channel SC_TONE) and the frames sent per (stream, channel)."""
    from liquid_dsp_tpu_torch.framing.frame64 import FRAME64_LEN, framegen64
    n = (SC_NBLK + 1) * SC_T
    x = np.empty((SC_S, SC_M, n), np.complex64)
    x.real = rng.standard_normal(x.shape, np.float32)
    x.imag = rng.standard_normal(x.shape, np.float32)
    x *= 0.002
    x[:, SC_TONE] += 0.5 * np.exp(2j * np.pi * 0.05 * np.arange(n))
    sent = {}
    usable = SC_NBLK * SC_T - FRAME64_LEN - SC_DELAY - 8
    for s in range(SC_S):
        for c in range(0, SC_M, 2):
            starts, pos = [], int(rng.integers(100, 3000))
            while pos < usable:
                starts.append(pos)
                pos += FRAME64_LEN + int(rng.integers(300, 9000))
            if c % 8 == 0:      # one frame across a block boundary
                b = (c // 8) % (SC_NBLK - 1) + 1
                cut = b * SC_T - int(rng.integers(1, FRAME64_LEN))
                starts = sorted([s0 for s0 in starts
                                 if abs(s0 - cut) >= FRAME64_LEN + 60] + [cut])
            for s0 in starts:
                h = rng.integers(0, 256, 8).astype(np.uint8)
                p = rng.integers(0, 256, 64).astype(np.uint8)
                x[s, c, s0:s0 + FRAME64_LEN] += framegen64(h, p)
                sent.setdefault((s, c), []).append((s0 + SC_DELAY, h, p))
    return x, sent


def check_decodes(got, sent, what):
    """got/sent: {(stream, channel): [(sample_index, ..., bytes...)]} with
    the decodes in order; every frame once, on its own channel, within 2
    samples.  Returns the number of frames checked."""
    n = 0
    for key in sorted(set(got) | set(sent)):
        g, s = got.get(key, []), sent.get(key, [])
        check(len(g) == len(s), f"{what} {key}: {len(g)} frames decoded "
              f"{[d[0] for d in g]}, {len(s)} sent {[d[0] for d in s]}")
        for k, (d, w) in enumerate(zip(g, s)):
            check(abs(d[0] - w[0]) <= 2, f"{what} {key} frame {k}: "
                  f"sample_index {d[0]}, expected {w[0]}")
            check(all(d[1:-2]), f"{what} {key} frame {k}: a CRC failed")
            check(np.array_equal(d[-2], w[1]) and np.array_equal(d[-1], w[2]),
                  f"{what} {key} frame {k}: bytes differ")
            n += 1
    return n


def hold_payload_codebook(torch, cw, bip):
    """codebook_argmax against its plain version on a path's soft bits;
    returns the max index difference (0: bit-equal)."""
    from liquid_dsp_tpu_torch.ops.kernels.codebook_argmax import (
        codebook_argmax, codebook_argmax_reference)
    k = codebook_argmax(cw, bip)
    p = codebook_argmax_reference(cw, bip)
    torch.cuda.synchronize()
    check(torch.equal(k, p), f"codebook_argmax: {int((k != p).sum())} of "
          f"{cw.shape[0]} indices differ")
    return float((k - p).abs().max())


def scanner_phases(torch, dev, card):
    """Phases 20-21: the 64-channel wideband scanner.  Returns
    codebook_argmax's launches on its run."""
    from liquid_dsp_tpu_torch.framing.frame64 import framesync64_stream_full
    from liquid_dsp_tpu_torch.multichannel import (firpfbch2_analyzer,
                                                   firpfbch2_synthesizer)
    from liquid_dsp_tpu_torch.ops.kernels.codebook_argmax import (
        codebook_argmax)

    # 20. the capture, synthesized on the card, then the scanner over it
    t0 = time.perf_counter()
    chans, sent = make_scanner_channels(np.random.default_rng(20))
    n_frames = sum(len(v) for v in sent.values())
    syn = firpfbch2_synthesizer(SC_M).to(dev)
    cs = syn.init(batch_shape=(SC_S,), device=dev)
    wide = []
    for b in range(SC_NBLK + 1):
        blk = torch.from_numpy(chans[..., b * SC_T:(b + 1) * SC_T]).to(dev)
        w, cs = syn(cs, blk)
        wide.append(w)
    del chans, blk
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    Tw = wide[0].shape[-1]
    check(Tw == SC_T * SC_M // 2, f"synthesizer block {Tw}")
    ana = firpfbch2_analyzer(SC_M).to(dev)
    rx = framesync64_stream_full(SC_T).to(dev)

    def scan(ca, cr, w):
        streams, ca = ana(ca, w)                       # [S, M, SC_T]
        out, cr = rx(cr, streams.reshape(SC_S * SC_M, SC_T))
        return out, ca, cr, streams

    ca = ana.init(batch_shape=(SC_S,), device=dev)
    cr = rx.init(batch_shape=(SC_S * SC_M,), device=dev)
    states, outs = [], []
    codebook_argmax.launches = 0
    t0 = time.perf_counter()
    for w in wide:
        states.append((ca, cr))
        out, ca, cr, streams = scan(ca, cr, w)
        outs.append(out)
        if len(states) == 2:
            streams1 = streams
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = codebook_argmax.launches
    got = {}
    for out in outs:
        o = {k: v.cpu().numpy() for k, v in out._asdict().items()}
        for r, p in zip(*np.nonzero(o["valid"])):
            got.setdefault((int(r) // SC_M, int(r) % SC_M), []).append((
                int(o["sample_index"][r, p]), bool(o["crc_ok"][r, p]),
                o["hdr_bytes"][r, p].astype(np.uint8),
                o["pay_bytes"][r, p].astype(np.uint8)))
    odd = {k: [d[0] for d in v] for k, v in got.items() if k[1] % 2}
    check(not odd, f"scanner: frames decoded on odd channels (stream, "
          f"channel): sample_index {odd}")
    n_ok = check_decodes(got, sent, "scanner (stream, channel)")
    check(launches == SC_NBLK + 1, f"codebook_argmax launched {launches} "
          f"times in {SC_NBLK + 1} scanner blocks")
    print(f"scanner: firpfbch2_synthesizer({SC_M}) made {SC_S} wideband "
          f"streams of {SC_NBLK} blocks + 1 flush x {Tw} samples on the card "
          f"(frame64 on the even channels, noise 0.002, a tone on channel "
          f"{SC_TONE}); firpfbch2_analyzer({SC_M}) -> "
          f"framesync64_stream_full({SC_T}) over {SC_S * SC_M} channel "
          f"streams, carried: {n_ok} of {n_frames} frames decoded once on "
          f"their own channel, in order, crc_ok, bytes equal, sample_index "
          f"within 2 of the start + {SC_DELAY} (the bank's delay); 0 on the "
          f"odd channels; codebook_argmax launches {launches}; capture made "
          f"in {t_gen:.1f} s, first pass {t_run:.2f} s", flush=True)

    # the kernel against its plain version on block 1's slot soft bits
    sym = rx.core(states[1][1], streams1.reshape(SC_S * SC_M, SC_T))[0].symbols
    cw = rx.decode.soft_bits(sym).reshape(-1, 24).contiguous()
    err = hold_payload_codebook(torch, cw, rx.decode.bip)
    print(f"codebook_argmax: kernel = plain on the scanner's {cw.shape[0]} "
          f"rows (n=24, K={rx.decode.bip.shape[1]})", flush=True)

    # 21. times and the profile of the scanner step
    (ca1, cr1), w1 = states[1], wide[1]
    st1 = streams1.reshape(SC_S * SC_M, SC_T)
    a_ms = time_ms(lambda: ana(ca1, w1), iters=CH_ITERS)
    r_ms = time_ms(lambda: rx(cr1, st1), iters=10)
    s_ms = time_ms(lambda: scan(ca1, cr1, w1), iters=20)
    print(f"timing ({card}): scanner step {s_ms:.4f} ms (20 calls) per "
          f"{SC_S}x{Tw} wideband block = "
          f"{SC_S * Tw / s_ms / 1e3:.1f} Msamples/s wideband; analyzer "
          f"{a_ms:.4f} ms ({CH_ITERS} calls), receiver {r_ms:.4f} ms "
          f"({SC_S * SC_M}x{SC_T}, 10 calls)",
          flush=True)
    profile_steps(torch, card, lambda: scan(ca1, cr1, w1), 3,
                  f"wideband scanner step at {SC_S}x{Tw}")
    return launches, err


def make_flex_stream(rng):
    """The flexframe receiver's input [FF_B, (FF_NBLK+1)*FF_T] and, per
    channel, the frames sent [(start, header, payload)]: frames of the
    receiver's config (crc32, none, golay2412, qpsk) at random offsets,
    the reference C library's ffg_a first on channel FF_GOLD, CFO 0.002
    rad/sample at about 20 dB SNR on channel FF_CFO, one frame of another
    config (qam16) alone on channel FF_FOREIGN, FF_QUIET noise-only
    channels, noise 0.005 elsewhere.  Returns (x, sent, foreign start)."""
    from liquid_dsp_tpu_torch.framing.flexframe import flexframegen
    lcg_bytes = golden_frames().lcg_bytes
    n = (FF_NBLK + 1) * FF_T
    x = np.zeros((FF_B, n), np.complex64)
    sent = {}
    gold = dict(np.load(os.path.join(ROOT, "tests", "golden",
                                     "flexframe_golden.npz")))
    ffg_a = gold["ffg_a"]
    flen = len(ffg_a)
    usable = FF_NBLK * FF_T - flen - 8
    for c in range(FF_B - FF_QUIET):
        if c == FF_FOREIGN:
            continue
        starts, pos = [], int(rng.integers(0, 3000))
        while pos < usable:
            starts.append(pos)
            pos += flen + int(rng.integers(3000, 9000))
        if c % 4 == 0:          # one frame across a block boundary
            b = (c // 4) % (FF_NBLK - 1) + 1
            cut = b * FF_T - int(rng.integers(1, flen))
            starts = sorted([s0 for s0 in starts
                             if abs(s0 - cut) >= flen + 3000] + [cut])
        for k, s0 in enumerate(starts):
            if c == FF_GOLD and k == 0:
                h, p, f = lcg_bytes(14, 21), lcg_bytes(FF_PL, 22), ffg_a
            else:
                h = rng.integers(0, 256, 14).astype(np.uint8)
                p = rng.integers(0, 256, FF_PL).astype(np.uint8)
                f = flexframegen(h, p)
            if c == FF_CFO:
                f = f * np.exp(1j * (0.002 * np.arange(s0, s0 + flen) + 0.7))
            x[c, s0:s0 + flen] = f
            sent.setdefault((0, c), []).append((s0, h, p))
    h = rng.integers(0, 256, 14).astype(np.uint8)
    p = rng.integers(0, 256, FF_PL).astype(np.uint8)
    f = flexframegen(h, p, ms="qam16")
    x[FF_FOREIGN, 5000:5000 + len(f)] = f
    noise = np.full((FF_B, 1), 0.005, np.float32)
    noise[FF_CFO] = 0.01
    x += noise * (rng.standard_normal(x.shape, np.float32)
                  + 1j * rng.standard_normal(x.shape, np.float32))
    return x, sent, 5000


def golden_frames():
    """tests/_golden_frames.py (numpy only): the flexframe goldens and
    the bytes their generator filled them with."""
    if os.path.join(ROOT, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _golden_frames
    return _golden_frames


def flexframe_phases(torch, dev, card):
    """Phases 22-23: the flexframe full receiver and the host-loop entry
    points.  Returns codebook_argmax's launches on the receiver's run."""
    from liquid_dsp_tpu_torch.framing.flexframe import (
        FLEXFRAME_H_USER, FlexFrameSync, flexframe_rx_stream, flexframesync)
    from liquid_dsp_tpu_torch.ops.kernels.codebook_argmax import (
        codebook_argmax)

    # 22. flexframe_rx_stream at full width
    t0 = time.perf_counter()
    x_np, sent, foreign_at = make_flex_stream(np.random.default_rng(22))
    x = torch.from_numpy(x_np).to(dev)
    del x_np
    n_frames = sum(len(v) for v in sent.values())
    t_gen = time.perf_counter() - t0
    proc = flexframe_rx_stream(FF_T, FF_PL, max_frames=FF_MAX).to(dev)
    carry = proc.init(batch_shape=(FF_B,), device=dev)
    carries, outs = [], []
    codebook_argmax.launches = 0
    t0 = time.perf_counter()
    for b in range(FF_NBLK + 1):
        carries.append(carry)
        out, carry = proc(carry, x[:, b * FF_T:(b + 1) * FF_T])
        outs.append(out)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = codebook_argmax.launches
    got, foreign = {}, []
    for out in outs:
        o = {k: v.cpu().numpy() for k, v in out._asdict().items()}
        for c, p in zip(*np.nonzero(o["valid"])):
            d = (int(o["sample_index"][c, p]), bool(o["hdr_ok"][c, p]),
                 bool(o["pay_ok"][c, p]),
                 o["hdr_bytes"][c, p, :FLEXFRAME_H_USER].astype(np.uint8),
                 o["pay_bytes"][c, p].astype(np.uint8))
            if c == FF_FOREIGN:
                foreign.append(d)
            else:
                got.setdefault((0, int(c)), []).append(d)
    check(foreign and abs(foreign[0][0] - foreign_at) <= 2
          and not any(d[1] for d in foreign),
          f"flexframe: the qam16 frame must come back hdr_ok False: "
          f"{[(d[0], d[1]) for d in foreign]}")
    quiet = [k for k in got if k[1] >= FF_B - FF_QUIET]
    check(not quiet, f"flexframe: frames on noise-only channels {quiet}")
    n_ok = check_decodes(got, sent, "flexframe channel")
    check(launches == FF_NBLK + 1, f"codebook_argmax launched {launches} "
          f"times in {FF_NBLK + 1} flexframe blocks")
    print(f"flexframe: flexframe_rx_stream({FF_T}, {FF_PL}) crc32/none/"
          f"golay2412/qpsk at {FF_B}x{FF_T}, {FF_NBLK} carried blocks + 1 "
          f"flush, {FF_MAX} slots: {n_ok} of {n_frames} frames decoded once, "
          f"in order, hdr_ok and pay_ok, header and payload bytes equal, "
          f"sample_index within 2 (incl. the reference C frame ffg_a and the "
          f"CFO 0.002 / 20 dB channel); the qam16 frame hdr_ok False; "
          f"{FF_QUIET} noise-only channels: 0 frames; codebook_argmax "
          f"launches {launches}; stream made in {t_gen:.1f} s, first pass "
          f"{t_run:.2f} s", flush=True)

    o1 = proc.core(carries[1], x[:, FF_T:2 * FF_T])[0]
    cw = proc.pay_dec.soft_bits(o1.region_syms[..., proc.h_sym_len:])
    cw = cw.reshape(-1, 24).contiguous()
    err = hold_payload_codebook(torch, cw, proc.pay_dec.bip)
    print(f"codebook_argmax: kernel = plain on the flexframe payloads' "
          f"{cw.shape[0]} rows (n=24, K={proc.pay_dec.bip.shape[1]})",
          flush=True)
    c1, x1 = carries[1], x[:, FF_T:2 * FF_T]
    r_ms = time_ms(lambda: proc(c1, x1), iters=20)
    print(f"timing ({card}): flexframe receiver step {r_ms:.4f} ms per "
          f"{FF_B}x{FF_T} block = {FF_B * FF_T / r_ms / 1e3:.1f} "
          f"Msamples/s (20 calls)", flush=True)
    profile_steps(torch, card, lambda: proc(c1, x1), 3,
                  f"flexframe_rx_stream step at {FF_B}x{FF_T}")
    del x, outs, carries, o1, cw
    torch.cuda.empty_cache()

    # 23. the host-loop entry points on the card over the three reference
    # frames (mixed schemes): ffg_b and ffg_c decode on the host
    gold = dict(np.load(os.path.join(ROOT, "tests", "golden",
                                     "flexframe_golden.npz")))
    gf = golden_frames()
    cases = gf.FLEX_GOLDEN
    parts = []
    for tag, _, _ in cases:
        parts += [np.zeros(700, np.complex64), gold[tag]]
    fs = FlexFrameSync()
    check(fs.device.type == "cuda", f"FlexFrameSync on {fs.device}")
    res = fs.execute(np.concatenate(parts + [np.zeros(500, np.complex64)]))
    res += fs.flush()
    check(len(res) == 3, f"FlexFrameSync: {len(res)} frames of 3")
    host = [k[4] for k, v in fs._dev_fec_cache.items() if v is None]
    for (tag, n, seed), (gh, hok, gp, pok, st) in zip(cases, res):
        check(hok and pok and np.array_equal(gh, gf.lcg_bytes(14, seed))
              and np.array_equal(gp, gf.lcg_bytes(n, seed + 1)),
              f"FlexFrameSync: {tag} not decoded")
        r = flexframesync(np.concatenate([np.zeros(50, np.complex64),
                                          gold[tag]]))
        check(r.crc_ok and np.array_equal(r.payload,
                                          gf.lcg_bytes(n, seed + 1)),
              f"flexframesync: {tag} not decoded")
    check(host == ["qam16", "psk8"], f"host decodes for {host}")
    print(f"flexframe: FlexFrameSync and flexframesync on the card decode "
          f"ffg_a (device decoder), ffg_b and ffg_c (host decode after the "
          f"conv decoders' ValueError) with the golden's bytes", flush=True)
    return launches, err


def viterbi_case(torch, dev, scheme, N, dec_len, sigma, seed):
    """(decoder, depunctured metrics [N, T, r] on the card, the bytes
    sent): N codewords of random bytes, +-4 metrics with noise of std
    `sigma` (None: all zero)."""
    from liquid_dsp_tpu_torch.fec.conv import conv_encode
    from liquid_dsp_tpu_torch.fec.device import conv_soft_decoder
    rng = np.random.default_rng(seed)
    fn, _ = conv_soft_decoder(scheme, dec_len)
    fn = fn.to(dev)
    msgs = rng.integers(0, 256, (N, dec_len)).astype(np.uint8)
    bits = np.stack([np.unpackbits(conv_encode(scheme, m)) for m in msgs])
    llr = np.zeros(bits.shape, np.float32) if sigma is None else (
        (2.0 * bits - 1.0) * 4 + sigma * rng.standard_normal(bits.shape)
    ).astype(np.float32)
    return fn, fn.obs(torch.from_numpy(llr).to(dev)), msgs


def vt_bound(obs, exp, nout):
    """viterbi_acs's bound: metrics in, the trellis table and the bits out
    once; the float32 operations the recurrence needs, not the kernel's
    count: per step and codeword the 2^r distinct branch metrics (r-1
    sums each; a product by +-1 is a sign flip), and per state two sums,
    the compare-select, its share of the max over states and one
    subtraction of that max."""
    N, T, r = obs.shape
    ns = exp.shape[0]
    return bound(obs.numel() * 4 + exp.numel() * 4 + N * nout * 4,
                 N * T * (ns * 5 + (1 << r) * (r - 1)))


def hold_viterbi(torch, fn, obs, what):
    """viterbi_acs against its plain version on these metrics: bits and
    packed decisions bit-equal.  Returns the kernel's bits and the count
    of its bits that differ from the plain version's."""
    from liquid_dsp_tpu_torch.ops.kernels.viterbi_acs import (
        viterbi_acs, viterbi_acs_reference)
    kb, kd = viterbi_acs(obs, fn.exp, fn.nout, decisions=True)
    bits = viterbi_acs(obs, fn.exp, fn.nout)
    pb, pd = viterbi_acs_reference(obs, fn.exp, fn.nout, decisions=True)
    torch.cuda.synchronize()
    n_diff = max(int((kb != pb).sum()), int((bits != pb).sum()))
    check(n_diff == 0, f"viterbi_acs, {what}: {n_diff} bits differ")
    check(torch.equal(kd, pd), f"viterbi_acs, {what}: "
          f"{int((kd != pd).sum())} decision words differ")
    return bits, n_diff


def viterbi_phase(torch, dev, card):
    """Phase 24: viterbi_acs against its plain version at the slice's
    cases, then its times.  Returns its kernel entry (launches filled in
    by the GMSK receiver's run)."""
    from liquid_dsp_tpu_torch.ops.kernels.viterbi_acs import (
        dec_smem_max, viterbi_acs, viterbi_acs_reference)
    held, err = [], 0
    # (scheme, N, dec_len, noise): the receiver's shape at the JAX tests'
    # noise levels (tests/test_fec_device.py: 0.8, 1.0) and at zero, the
    # puncturings, one and a ragged number of codewords, decisions that
    # do not fit shared memory, all-zero metrics (every early step a tie)
    cases = [("v27", VT_N, VT_DEC, 0.8), ("v29", VT_N, VT_DEC, 1.0),
             ("v39", VT_N, VT_DEC, 1.0), ("v27", VT_N, VT_DEC, 0.0),
             ("v29", VT_N, VT_DEC, 0.0), ("v27p23", 128, VT_DEC, 0.8),
             ("v27p78", 128, VT_DEC, 0.5), ("v29p34", 128, VT_DEC, 0.8),
             ("v29p78", 128, VT_DEC, 0.5), ("v27", 1, 1, 1.0),
             ("v29", 37, 1, 1.0), ("v29", 8, 2000, 1.0),
             ("v27", 64, VT_DEC, None), ("v29", 64, VT_DEC, None)]
    for k, (scheme, N, dec_len, sigma) in enumerate(cases):
        fn, obs, msgs = viterbi_case(torch, dev, scheme, N, dec_len, sigma,
                                     100 + k)
        if dec_len == 2000:
            check(obs.shape[1] * fn.exp.shape[0] // 8 > dec_smem_max(),
                  "the long case must leave shared memory")
        bits, n_diff = hold_viterbi(torch, fn, obs, f"{scheme} N={N} "
                                    f"dec_len={dec_len} noise={sigma}")
        err = max(err, n_diff)
        if sigma == 0.0:
            got = np.packbits(bits.cpu().numpy().astype(np.uint8), axis=-1)
            check(np.array_equal(got, msgs), f"viterbi_acs {scheme}: the "
                  f"noiseless codewords do not decode to the bytes sent")
        held.append(f"{scheme} {N}x{dec_len} "
                    f"{'zeros' if sigma is None else sigma}")
    print(f"viterbi_acs: kernel = plain version (bits and packed "
          f"decisions) at " + "; ".join(held) + "; the noiseless ones "
          f"decode to the bytes sent", flush=True)

    # times: the receiver's shape, plain, kernel, kernel, plain
    fn, obs, _ = viterbi_case(torch, dev, "v27", VT_N, VT_DEC, 0.8, 7)
    exp, nout = fn.exp, fn.nout
    p1, _ = time_once(lambda: viterbi_acs_reference(obs, exp, nout))
    k1 = time_ms(lambda: viterbi_acs(obs, exp, nout), iters=VT_ITERS)
    k2 = time_ms(lambda: viterbi_acs(obs, exp, nout), iters=VT_ITERS)
    p2, _ = time_once(lambda: viterbi_acs_reference(obs, exp, nout))
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    vb = vt_bound(obs, exp, nout)
    # the chain's floor: T dependent steps at one step's latency, from a
    # lone codeword at two lengths
    one = {}
    for d in (8, VT_DEC):
        f1, o1, _ = viterbi_case(torch, dev, "v27", 1, d, 0.8, 8)
        one[d] = (o1.shape[1], time_ms(lambda: viterbi_acs(
            o1, f1.exp, f1.nout), iters=VT_ITERS))
    step_us = (one[VT_DEC][1] - one[8][1]) / (one[VT_DEC][0] - one[8][0]) \
        * 1e3
    floor_ms = obs.shape[1] * step_us / 1e3
    print(f"timing ({card}): viterbi_acs v27 {VT_N}x{VT_DEC} bytes (T = "
          f"{obs.shape[1]}) {ms:.4f} ms = {VT_N * nout / ms:.1f} kbit/s "
          f"decoded (runs {k1:.4f}, {k2:.4f}; {VT_ITERS} launches each); "
          f"plain version {plain_ms:.2f} ms (runs {p1:.2f}, {p2:.2f}); bound "
          f"{vb['bound_ms']:.5f} ms by {vb['bound_by']}; one step's latency "
          f"{step_us:.4f} us (one codeword at T = {one[8][0]} and "
          f"{one[VT_DEC][0]}: {one[8][1]:.4f}, {one[VT_DEC][1]:.4f} ms), so "
          f"the chain's floor is {floor_ms:.4f} ms", flush=True)
    bench = []
    for scheme in ("v27", "v29"):
        fb, ob, _ = viterbi_case(torch, dev, scheme, VT_BENCH[0],
                                 VT_BENCH[1], 0.8, 9)
        tb = time_ms(lambda: viterbi_acs(ob, fb.exp, fb.nout),
                     iters=VT_ITERS)
        bb = vt_bound(ob, fb.exp, fb.nout)
        bench.append(f"{scheme} {VT_BENCH[0]}x{VT_BENCH[1]} {tb:.4f} ms = "
                     f"{VT_BENCH[0] * fb.nout / tb:.1f} kbit/s (bound "
                     f"{bb['bound_ms']:.5f} ms by {bb['bound_by']})")
    print(f"timing ({card}): viterbi_acs at tools/bench_viterbi.py's "
          f"shapes: " + "; ".join(bench), flush=True)
    return {"name": "viterbi_acs", "route": "cuda",
            "source": "liquid_dsp_tpu_torch/csrc/viterbi_acs.cu",
            "replaces": None,
            "recurrence": "liquid_dsp_tpu/fec/device.py:171-271 (lax.scan)",
            "launches": 0, "max_abs_err": float(err), "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, **vb,
            "chain_floor_ms": floor_ms, "step_latency_us": step_us}


def make_gmsk_stream(torch, dev, rng, cfg):
    """The GMSK receiver's input on the card [GM_B, (GM_NBLK+1)*GM_T] and
    the frames sent {(0, channel): [(start, header, payload)]}: the
    frames' bits from the port's host packetizer, modulated in one batched
    gmsk_modulator call on the card and placed GM_PER_BLOCK per channel
    and block at random spacings longer than a frame; CFO 0.0015
    rad/sample and phase 0.3 on the GM_CFO channels; one uncoded frame
    (another config) on GM_FOREIGN; GM_QUIET noise-only channels; noise
    0.005 everywhere (tests/test_gmskframe_stream.py:117-146).  Returns
    (x, sent, foreign start, one host frame for the modulator check)."""
    from liquid_dsp_tpu_torch.framing import gmskframe as gf
    from liquid_dsp_tpu_torch.modem.cpm import gmsk_modulator
    k, m = 2, 3
    n = (GM_NBLK + 1) * GM_T
    h0 = rng.integers(0, 256, 8).astype(np.uint8)
    flen = len(gf._frame_bits(h0, np.zeros(GM_PL, np.uint8), m, **cfg)) * k
    gap = GM_T // GM_PER_BLOCK - flen       # the mean gap between frames
    frames, where, sent, fpos = [], [], {}, None
    for c in range(GM_B - GM_QUIET):
        pos = int(rng.integers(0, 2000))
        while pos + flen < GM_NBLK * GM_T - 8:
            if c == GM_FOREIGN and fpos is None and pos > GM_T:
                fpos = pos                      # the foreign frame's slot
            else:
                h = rng.integers(0, 256, 8).astype(np.uint8)
                p = rng.integers(0, 256, GM_PL).astype(np.uint8)
                frames.append(gf._frame_bits(h, p, m, **cfg))
                where.append((c, pos))
                sent.setdefault((0, c), []).append((pos, h, p))
            pos += flen + int(rng.integers(gap - 2000, gap + 2000))
    hf = rng.integers(0, 256, 8).astype(np.uint8)
    foreign = gf._frame_bits(hf, rng.integers(0, 256, 40).astype(np.uint8),
                             m)
    mod = gmsk_modulator(k, m, 0.5).to(dev)
    bits = torch.from_numpy(np.stack(frames).astype(np.int32)).to(dev)
    y, _ = mod(mod.init(batch_shape=(len(frames),), device=dev), bits)
    w = torch.from_numpy(gf._ramp(k, m)).to(dev)
    y[:, :m * k] *= w[:m * k]
    y[:, -m * k:] *= w[m * k:]
    x = torch.zeros(GM_B, n, dtype=torch.complex64, device=dev)
    rows = torch.tensor([c for c, _ in where], device=dev)
    cols = torch.tensor([s0 for _, s0 in where], device=dev)
    idx = cols[:, None] + torch.arange(flen, device=dev)
    x[rows[:, None], idx] = y
    yf, _ = mod(mod.init(device=dev), torch.from_numpy(
        foreign.astype(np.int32)).to(dev))
    yf[:m * k] *= w[:m * k]
    yf[-m * k:] *= w[m * k:]
    x[GM_FOREIGN, fpos:fpos + len(yf)] = yf
    t = torch.arange(n, dtype=torch.float32, device=dev)
    ph = 0.0015 * t + 0.3
    rot = torch.complex(torch.cos(ph), torch.sin(ph))
    cfo = torch.tensor(GM_CFO, device=dev)
    x[cfo] = x[cfo] * rot
    g = torch.Generator(device=dev).manual_seed(25)
    x += 0.005 * torch.complex(
        torch.randn(x.shape, generator=g, device=dev),
        torch.randn(x.shape, generator=g, device=dev))
    h, p = sent[(0, where[0][0])][0][1:]
    host = (gf.gmskframegen(h, p, **cfg), y[0].cpu().numpy())
    return x, sent, fpos, host


def gmsk_run(torch, dev, card, cfg, tag):
    """Phases 25 and 26: the GMSK stream receiver at GM_B x GM_T for one
    payload configuration.  Returns (the payload kernel's launches on the
    run, the receiver, a carry and block for the hold and the times)."""
    from liquid_dsp_tpu_torch.framing.gmskframe import (GMSKFRAME_H_USER,
                                                        gmskframe_rx_stream)
    from liquid_dsp_tpu_torch.ops.kernels.codebook_argmax import (
        codebook_argmax)
    from liquid_dsp_tpu_torch.ops.kernels.viterbi_acs import viterbi_acs
    t0 = time.perf_counter()
    x, sent, foreign_at, (fh, fd) = make_gmsk_stream(
        torch, dev, np.random.default_rng(25), cfg)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    check(np.abs(fh - fd).max() < 1e-4, f"gmsk {tag}: the batched card "
          f"modulator differs from gmskframegen by {np.abs(fh - fd).max()}")
    n_frames = sum(len(v) for v in sent.values())
    proc = gmskframe_rx_stream(GM_T, GM_PL, crc="crc32", **cfg).to(dev)
    carry = proc.init(batch_shape=(GM_B,), device=dev)
    counter = viterbi_acs if "fec0" in cfg else codebook_argmax
    carries, outs = [], []
    counter.launches = 0
    t0 = time.perf_counter()
    for b in range(GM_NBLK + 1):
        carries.append(carry)
        out, carry = proc(carry, x[:, b * GM_T:(b + 1) * GM_T])
        outs.append(out)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = counter.launches
    got, foreign = {}, []
    for out in outs:
        o = {k: v.cpu().numpy() for k, v in out._asdict().items()}
        for c, p in zip(*np.nonzero(o["valid"])):
            d = (int(o["sample_index"][c, p]), bool(o["hdr_ok"][c, p]),
                 bool(o["pay_ok"][c, p]),
                 o["hdr_bytes"][c, p, :GMSKFRAME_H_USER].astype(np.uint8),
                 o["pay_bytes"][c, p].astype(np.uint8))
            if c == GM_FOREIGN and abs(d[0] - foreign_at) <= 2:
                foreign.append(d)
            else:
                got.setdefault((0, int(c)), []).append(d)
    check(len(foreign) == 1 and not foreign[0][1],
          f"gmsk {tag}: the foreign frame must come back once, hdr_ok "
          f"False: {[(d[0], d[1]) for d in foreign]}")
    quiet = [k for k in got if k[1] >= GM_B - GM_QUIET]
    check(not quiet, f"gmsk {tag}: frames on noise-only channels {quiet}")
    n_ok = check_decodes(got, sent, f"gmsk {tag} channel")
    check(launches == GM_NBLK + 1, f"gmsk {tag}: {counter.__name__} "
          f"launched {launches} times in {GM_NBLK + 1} blocks")
    print(f"gmsk: gmskframe_rx_stream({GM_T}, {GM_PL}) crc32/{tag} at "
          f"{GM_B}x{GM_T}, {GM_NBLK} carried blocks + 1 flush: {n_ok} of "
          f"{n_frames} frames decoded once, in order, hdr_ok and pay_ok, "
          f"header and payload bytes equal, sample_index within 2 (incl. "
          f"{len(GM_CFO)} channels at CFO 0.0015 rad/sample); the foreign "
          f"frame hdr_ok False; {GM_QUIET} noise-only channels: 0 frames; "
          f"{counter.__name__} launches {launches}; the frames modulated "
          f"in one call on the card (= gmskframegen within 1e-4), stream "
          f"made in {t_gen:.1f} s, first pass {t_run:.2f} s", flush=True)
    c1, x1 = carries[1], x[:, GM_T:2 * GM_T]
    del outs, carries, x
    return launches, proc, c1, x1


def gmsk_times(torch, card, proc, c1, x1, tag):
    r_ms = time_ms(lambda: proc(c1, x1), iters=10)
    print(f"timing ({card}): gmsk {tag} receiver step {r_ms:.4f} ms per "
          f"{GM_B}x{GM_T} block = {GM_B * GM_T / r_ms / 1e3:.1f} Msamples/s "
          f"(10 calls)", flush=True)
    profile_steps(torch, card, lambda: proc(c1, x1), 3,
                  f"gmskframe_rx_stream ({tag}) step at {GM_B}x{GM_T}")


def gmsk_phases(torch, dev, card):
    """Phases 25-26: the GMSK stream receiver on golay2412 payloads
    (codebook_argmax) and on v27 payloads (viterbi_acs), each kernel held
    to its plain version on the path's own soft metrics.  Returns
    (codebook_argmax launches, its max error, viterbi_acs launches, its
    max error)."""
    # 25. golay2412: the JAX tool's configuration
    cb_launches, proc, c1, x1 = gmsk_run(torch, dev, card,
                                         {"fec1": "golay2412"},
                                         "none/golay2412")
    soft = proc.soft_metrics(c1, x1)[1]
    cw = proc.pay_dec.soft_bits(soft[..., 63 + proc.h_bits:])
    cw = cw.reshape(-1, 24).contiguous()
    cb_err = hold_payload_codebook(torch, cw, proc.pay_dec.bip)
    print(f"codebook_argmax: kernel = plain on the GMSK payloads' "
          f"{cw.shape[0]} rows (n=24, K={proc.pay_dec.bip.shape[1]})",
          flush=True)
    gmsk_times(torch, card, proc, c1, x1, "golay2412")
    del proc, c1, x1, soft, cw
    torch.cuda.empty_cache()

    # 26. v27 with the same frame size (138 encoded payload bytes)
    vt_launches, proc, c1, x1 = gmsk_run(torch, dev, card,
                                         {"fec0": "v27", "fec1": "none"},
                                         "v27/none")
    soft = proc.soft_metrics(c1, x1)[1]
    vit = proc.pay_dec.vit
    obs = vit.obs(proc.pay_dec.llr(soft[..., 63 + proc.h_bits:]))
    vt_err = hold_viterbi(torch, vit, obs, "the GMSK receiver's LLRs")[1]
    print(f"viterbi_acs: kernel = plain (bits and decisions) on the GMSK "
          f"payloads' {obs.shape[0]} codewords of T = {obs.shape[1]}",
          flush=True)
    gmsk_times(torch, card, proc, c1, x1, "v27")
    del proc, c1, x1, soft, obs
    torch.cuda.empty_cache()
    return cb_launches, cb_err, vt_launches, float(vt_err)


def conv_phases(torch, dev, card):
    """Phase 27: convolutional payloads outside the GMSK receiver, and the
    GMSK host-loop entry points on the card.  Returns viterbi_acs's
    launches on the flexframe run."""
    from liquid_dsp_tpu_torch.framing import gmskframe as gf
    from liquid_dsp_tpu_torch.framing.flexframe import (
        FLEXFRAME_H_USER, flexframe_rx_stream, flexframegen)
    from liquid_dsp_tpu_torch.ops.kernels.viterbi_acs import viterbi_acs
    rng = np.random.default_rng(27)
    cfg = dict(crc="crc32", fec0="v27", fec1="none", ms="qpsk")
    n = (CV_NBLK + 1) * CV_T
    x = np.zeros((CV_B, n), np.complex64)
    sent = {}
    flen = len(flexframegen(np.zeros(14, np.uint8), np.zeros(64, np.uint8),
                            **cfg))
    for c in range(CV_B):
        pos = int(rng.integers(0, 3000))
        while pos + flen < CV_NBLK * CV_T - 8:
            h = rng.integers(0, 256, 14).astype(np.uint8)
            p = rng.integers(0, 256, 64).astype(np.uint8)
            x[c, pos:pos + flen] = flexframegen(h, p, **cfg)
            sent.setdefault((0, c), []).append((pos, h, p))
            pos += flen + int(rng.integers(3000, 9000))
    x += 0.005 * (rng.standard_normal(x.shape, np.float32)
                  + 1j * rng.standard_normal(x.shape, np.float32))
    xd = torch.from_numpy(x).to(dev)
    proc = flexframe_rx_stream(CV_T, 64, max_frames=FF_MAX, **cfg).to(dev)
    carry = proc.init(batch_shape=(CV_B,), device=dev)
    viterbi_acs.launches = 0
    got = {}
    for b in range(CV_NBLK + 1):
        out, carry = proc(carry, xd[:, b * CV_T:(b + 1) * CV_T])
        o = {k: v.cpu().numpy() for k, v in out._asdict().items()}
        for c, p in zip(*np.nonzero(o["valid"])):
            got.setdefault((0, int(c)), []).append((
                int(o["sample_index"][c, p]), bool(o["hdr_ok"][c, p]),
                bool(o["pay_ok"][c, p]),
                o["hdr_bytes"][c, p, :FLEXFRAME_H_USER].astype(np.uint8),
                o["pay_bytes"][c, p].astype(np.uint8)))
    launches = viterbi_acs.launches
    n_ok = check_decodes(got, sent, "flexframe v27 channel")
    check(launches == CV_NBLK + 1, f"viterbi_acs launched {launches} times "
          f"in {CV_NBLK + 1} flexframe blocks")
    print(f"conv: flexframe_rx_stream({CV_T}, 64) crc32/v27/none/qpsk at "
          f"{CV_B}x{CV_T}: {n_ok} of {sum(len(v) for v in sent.values())} "
          f"frames decoded once with the bytes sent; viterbi_acs launches "
          f"{launches}", flush=True)
    del xd, proc, carry

    # gmskframesync on the goldens, GMSKFrameSync on mixed configs
    gfr = golden_frames()
    gold = dict(np.load(os.path.join(ROOT, "tests", "golden",
                                     "flexframe_golden.npz")))
    for tag, nb, seed in (("gmsk_a", 40, 77), ("gmsk_b", 64, 91)):
        rl = int(gold[tag + "_len"][0])
        r = gf.gmskframesync(np.concatenate([
            np.zeros(40, np.complex64), gold[tag][:rl],
            np.zeros(40, np.complex64)]))
        check(r.crc_ok and np.array_equal(r.header, gfr.lcg_bytes(8, seed))
              and np.array_equal(r.payload, gfr.lcg_bytes(nb, seed + 1)),
              f"gmskframesync: {tag} not decoded")
    parts, want = [], []
    for n_p, f0, f1 in ((40, "none", "none"), (60, "none", "golay2412"),
                        (25, "v27", "none")):
        h = rng.integers(0, 256, 8).astype(np.uint8)
        p = rng.integers(0, 256, n_p).astype(np.uint8)
        parts += [np.zeros(900, np.complex64),
                  gf.gmskframegen(h, p, fec0=f0, fec1=f1)]
        want.append((h, p))
    fs = gf.GMSKFrameSync()
    check(fs.device.type == "cuda", f"GMSKFrameSync on {fs.device}")
    res = fs.execute(np.concatenate(parts)) + fs.flush()
    check(len(res) == 3 and all(
        r[1] and r[3] and np.array_equal(r[0], h) and np.array_equal(r[2], p)
        for r, (h, p) in zip(res, want)), "GMSKFrameSync: mixed configs")
    print("gmsk: gmskframesync on the card decodes the reference frames "
          "gmsk_a and gmsk_b; GMSKFrameSync on the card decodes 3 frames "
          "of 3 configs (uncoded, golay2412 on the device decoder, v27 on "
          "the host)", flush=True)
    return launches


def ofdm_modulate(torch, dev, par, grids):
    """`ofdm_generate_frame` for a batch of frames on the card: grids
    [F, n_syms, M_data] complex64 (numpy) -> samples [F, (3 + n_syms)(M +
    cp)] complex64, one inverse FFT for all of them."""
    from liquid_dsp_tpu_torch.multichannel import ofdm
    M, cp = par.M, par.cp_len
    F, n_syms, _ = grids.shape
    g = 1.0 / np.sqrt(par.M_pilot + par.M_data)
    X = torch.zeros(F, n_syms, M, dtype=torch.complex64, device=dev)
    pil = ofdm._pilot_sequence(par.M_pilot, n_syms) * g
    X[:, :, torch.from_numpy(ofdm._pilot_order(par)).to(dev)] = \
        torch.from_numpy(pil.astype(np.complex64)).to(dev)
    dat = torch.from_numpy(np.nonzero(par.p == ofdm.SCTYPE_DATA)[0]).to(dev)
    X[:, :, dat] = torch.from_numpy(grids).to(dev) * g
    x = torch.fft.ifft(X, dim=-1) * M
    x = torch.cat([x[..., M - cp:], x], dim=-1).reshape(F, -1)
    pre = ofdm.ofdm_generate_frame(par, np.zeros((1, par.M_data),
                                                 np.complex64))
    pre = torch.from_numpy(pre[:3 * (M + cp)]).to(dev)
    return torch.cat([pre.expand(F, -1), x], dim=-1)


def make_ofdm_stream(torch, dev, rng):
    """The OFDM receiver's input on the card [OF_B, (OF_NBLK+1)*OF_T] and
    the frames sent {(0, channel): [(start, header, payload)]}: the
    frames' data grids from the port's host packetizer
    (`ofdmflexframe._frame_grid`), modulated in one batched inverse FFT on
    the card (one frame held to ofdmflexframegen within 1e-5) and placed
    OF_PER_BLOCK per channel and block at random spacings longer than a
    frame; CFO 0.002 rad/sample and phase 0.3 on the OF_CFO channels; one
    qam16 frame of 32 bytes (another config) on OF_FOREIGN; OF_QUIET
    noise-only channels; noise 0.01 everywhere.  Returns (x, sent,
    foreign start, frames across a block boundary)."""
    from liquid_dsp_tpu_torch.framing import ofdmflexframe as off
    from liquid_dsp_tpu_torch.multichannel.ofdm import ofdm_params
    par = ofdm_params(64, 16)
    n = (OF_NBLK + 1) * OF_T
    h0, p0 = np.zeros(8, np.uint8), np.zeros(OF_PL, np.uint8)
    flen = len(off.ofdmflexframegen(h0, p0))
    gap = OF_T // OF_PER_BLOCK - flen       # the mean gap between frames
    grids, where, sent, fpos = [], [], {}, None
    for c in range(OF_B - OF_QUIET):
        pos = int(rng.integers(0, 2000))
        while pos + flen < OF_NBLK * OF_T - 8:
            if c == OF_FOREIGN and fpos is None and pos > OF_T:
                fpos = pos                      # the foreign frame's slot
            else:
                h = rng.integers(0, 256, 8).astype(np.uint8)
                p = rng.integers(0, 256, OF_PL).astype(np.uint8)
                grids.append(off._frame_grid(h, p, par))
                where.append((c, pos))
                sent.setdefault((0, c), []).append((pos, h, p))
            pos += flen + int(rng.integers(gap - 2000, gap + 2000))
    y = ofdm_modulate(torch, dev, par, np.stack(grids))
    check(y.shape[1] == flen, f"ofdm: batched frames of {y.shape[1]} "
          f"samples, the generator's {flen}")
    x = torch.zeros(OF_B, n, dtype=torch.complex64, device=dev)
    rows = torch.tensor([c for c, _ in where], device=dev)
    cols = torch.tensor([s0 for _, s0 in where], device=dev)
    x[rows[:, None], cols[:, None] + torch.arange(flen, device=dev)] = y
    hf = rng.integers(0, 256, 8).astype(np.uint8)
    yf = off.ofdmflexframegen(hf, rng.integers(0, 256, 32).astype(np.uint8),
                              ms="qam16")
    x[OF_FOREIGN, fpos:fpos + len(yf)] = torch.from_numpy(yf).to(dev)
    t = torch.arange(n, dtype=torch.float32, device=dev)
    ph = 0.002 * t + 0.3
    cfo = torch.tensor(OF_CFO, device=dev)
    x[cfo] = x[cfo] * torch.complex(torch.cos(ph), torch.sin(ph))
    g = torch.Generator(device=dev).manual_seed(28)
    x += 0.01 * torch.complex(torch.randn(x.shape, generator=g, device=dev),
                              torch.randn(x.shape, generator=g, device=dev))
    h, p = sent[(0, where[0][0])][0][1:]
    err = float(np.abs(off.ofdmflexframegen(h, p)
                       - y[0].cpu().numpy()).max())
    check(err < 1e-5, f"ofdm: the batched card modulator differs from "
          f"ofdmflexframegen by {err}")
    straddle = sum(1 for _, s0 in where
                   if s0 // OF_T != (s0 + flen - 1) // OF_T)
    return x, sent, fpos, straddle


def ofdm_stream_phase(torch, dev, card):
    """Phase 28: ofdmflex_rx_stream at full width.  Returns
    codebook_argmax's launches on its run and its max index difference
    against the plain version on the path's soft bits."""
    from liquid_dsp_tpu_torch.framing.ofdmflex_stream import (
        ofdmflex_rx_stream)
    from liquid_dsp_tpu_torch.ops.kernels.codebook_argmax import (
        codebook_argmax)
    t0 = time.perf_counter()
    x, sent, foreign_at, straddle = make_ofdm_stream(
        torch, dev, np.random.default_rng(28))
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    n_frames = sum(len(v) for v in sent.values())
    check(straddle > 0, "ofdm: no frame across a block boundary")
    proc = ofdmflex_rx_stream(OF_T, OF_PL, max_frames=OF_MAX).to(dev)
    carry = proc.init(batch_shape=(OF_B,), device=dev)
    carries, outs = [], []
    codebook_argmax.launches = 0
    t0 = time.perf_counter()
    for b in range(OF_NBLK + 1):
        carries.append(carry)
        out, carry = proc(carry, x[:, b * OF_T:(b + 1) * OF_T])
        outs.append(out)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = codebook_argmax.launches
    # the S1 timing of every valid slot, from the same blocks' demod half:
    # the frame starts OF_S1 samples before S1's body
    starts = []
    for b in range(OF_NBLK + 1):
        _, det, best = proc.detect_demod(
            carries[b], x[:, b * OF_T:(b + 1) * OF_T])[:3]
        starts.append((carries[b]["base"][:, None] + det[1] + best
                       - OF_S1).cpu().numpy())
    got, foreign = {}, []
    for out, s1 in zip(outs, starts):
        o = {k: v.cpu().numpy() for k, v in out._asdict().items()}
        for c, p in zip(*np.nonzero(o["valid"])):
            d = (int(s1[c, p]), int(o["sample_index"][c, p]),
                 bool(o["hdr_ok"][c, p]), bool(o["pay_ok"][c, p]),
                 o["hdr_bytes"][c, p, :8].astype(np.uint8),
                 o["pay_bytes"][c, p].astype(np.uint8))
            if c == OF_FOREIGN and abs(d[0] - foreign_at) <= 2:
                foreign.append(d)
            else:
                got.setdefault((0, int(c)), []).append(d)
    check(len(foreign) == 1 and not foreign[0][2],
          f"ofdm: the foreign frame must come back once, hdr_ok False: "
          f"{[(d[0], d[2]) for d in foreign]}")
    quiet = [k for k in got if k[1] >= OF_B - OF_QUIET]
    check(not quiet, f"ofdm: frames on noise-only channels {quiet}")
    off_plateau = [(k, d[1], w[0]) for k in got for d, w in
                   zip(got[k], sent.get(k, []))
                   if not 0 <= d[1] - w[0] <= OF_PLATEAU]
    check(not off_plateau, f"ofdm: coarse sample_index off the S0 plateau "
          f"(channel, index, start): {off_plateau[:5]}")
    # check_decodes holds (S1 start, hdr_ok, pay_ok, header, payload)
    n_ok = check_decodes({k: [(d[0],) + d[2:] for d in v]
                          for k, v in got.items()}, sent, "ofdm channel")
    check(launches == 2 * (OF_NBLK + 1), f"codebook_argmax launched "
          f"{launches} times in {OF_NBLK + 1} OFDM blocks (header and "
          f"payload: 2 each)")
    print(f"ofdm: ofdmflex_rx_stream({OF_T}, {OF_PL}) crc32/none/golay2412/"
          f"qpsk, M=64 cp=16, {OF_MAX} slots, at {OF_B}x{OF_T}, {OF_NBLK} "
          f"carried blocks + 1 flush: {n_ok} of {n_frames} frames decoded "
          f"once, in order, hdr_ok and pay_ok, header and payload bytes "
          f"equal, the S1 start within 2 and the coarse sample_index on the "
          f"S0 plateau (incl. {len(OF_CFO)} channels at CFO 0.002 "
          f"rad/sample, {straddle} frames across a block boundary); the "
          f"qam16 frame hdr_ok False; {OF_QUIET} noise-only channels: 0 "
          f"frames; codebook_argmax launches {launches}; the frames "
          f"modulated in one inverse FFT on the card (= ofdmflexframegen "
          f"within 1e-5), stream made in {t_gen:.1f} s, first pass "
          f"{t_run:.2f} s", flush=True)

    # codebook_argmax against its plain version on block 1's header and
    # payload soft bits, then its time per launch there
    c1, x1 = carries[1], x[:, OF_T:2 * OF_T]
    data = proc.detect_demod(c1, x1)[3]
    cws = [proc.hdr_dec.soft_bits(proc.header_llr(data)),
           proc.pay_dec.soft_bits(proc.payload_syms(data))]
    errs, kms = [], []
    for cw in cws:
        cw = cw.reshape(-1, 24).contiguous()
        errs.append(hold_payload_codebook(torch, cw, proc.pay_dec.bip))
        kms.append((cw.shape[0], time_ms(
            lambda: codebook_argmax(cw, proc.pay_dec.bip), iters=100)))
    rows = sum(r for r, _ in kms)
    # soft bits in, indices out, the codebook once (per launch); one
    # multiply-add per (row, bit, codeword)
    bip = proc.pay_dec.bip
    cb_bound = bound(rows * 24 * 4 + rows * 4 + 2 * bip.numel() * 4,
                     2 * rows * 24 * bip.shape[1])
    print(f"codebook_argmax: kernel = plain on the OFDM header's "
          f"{kms[0][0]} and payload's {kms[1][0]} rows (n=24, "
          f"K={bip.shape[1]}); per launch ({card}, 100 launches each) "
          f"{kms[0][1]:.4f} and {kms[1][1]:.4f} ms; the two together "
          f"{kms[0][1] + kms[1][1]:.4f} ms against a bound of "
          f"{cb_bound['bound_ms']:.4f} ms by {cb_bound['bound_by']}",
          flush=True)
    r1 = time_ms(lambda: proc(c1, x1), iters=10)
    r2 = time_ms(lambda: proc(c1, x1), iters=10)
    print(f"timing ({card}): ofdm receiver step {r1:.4f}, {r2:.4f} ms per "
          f"{OF_B}x{OF_T} block = {OF_B * OF_T / r1 / 1e3:.1f}, "
          f"{OF_B * OF_T / r2 / 1e3:.1f} Msamples/s (10 calls each)",
          flush=True)
    by_name = profile_steps(torch, card, lambda: proc(c1, x1), 3,
                            f"ofdmflex_rx_stream step at {OF_B}x{OF_T}")
    cbk = [(t, c) for k, (t, c) in by_name.items() if "codebook" in k]
    if cbk:
        print(f"profile ({card}): codebook_argmax inside the OFDM step "
              f"{sum(t for t, _ in cbk) / 3:.4f} ms per step in "
              f"{sum(c for _, c in cbk) / 3:.0f} launches", flush=True)
    del x, outs, carries, data, cws
    torch.cuda.empty_cache()
    return launches, max(errs)


def ofdm_sync_phases(torch, dev, card):
    """Phases 29-30: OFDMFlexFrameSync on the card over mixed
    configurations (v27 on `viterbi_acs`, golay2412 on `codebook_argmax`,
    others on the host), then the one-shot sync, the S0 detector and
    ofdmflexframesync on the reference frames.  Returns (codebook_argmax
    and viterbi_acs launches on the OFDMFlexFrameSync run, viterbi_acs's
    count of bits that differ from its plain version)."""
    from liquid_dsp_tpu_torch.framing import ofdmflexframe as off
    from liquid_dsp_tpu_torch.multichannel import ofdm
    from liquid_dsp_tpu_torch.ops.kernels.codebook_argmax import (
        codebook_argmax)
    from liquid_dsp_tpu_torch.ops.kernels.viterbi_acs import viterbi_acs
    # 29. the tests' mixed capture plus v27 and a second golay2412 frame,
    # CFO 0.002 rad/sample, noise 0.01, fed in chunks of 6000
    rng = np.random.default_rng(29)
    cfgs = [(40, "qpsk", "none", "golay2412"),
            (120, "qam16", "none", "hamming74"),
            (20, "bpsk", "none", "none"), (64, "qpsk", "v27", "none"),
            (64, "qpsk", "none", "golay2412"), (30, "qpsk", "v27", "none")]
    cap = np.zeros(7000 * len(cfgs) + 4000, np.complex64)
    sent = []
    for k, (n, ms, f0, f1) in enumerate(cfgs):
        h = rng.integers(0, 256, 8).astype(np.uint8)
        p = rng.integers(0, 256, n).astype(np.uint8)
        f = off.ofdmflexframegen(h, p, ms=ms, fec0=f0, fec1=f1)
        s0 = 1000 + 7000 * k
        cap[s0:s0 + len(f)] = f
        sent.append((s0, h, p))
    cap = cap * np.exp(1j * 0.002 * np.arange(len(cap)))
    cap = (cap + 0.01 * (rng.standard_normal(len(cap)) + 1j *
                         rng.standard_normal(len(cap)))).astype(np.complex64)
    fs = off.OFDMFlexFrameSync(block_len=4096)
    check(fs.device.type == "cuda", f"OFDMFlexFrameSync on {fs.device}")
    # record what the device decoders get: the path's own symbols
    seen = {}
    for n, ms, f0, f1 in {c for c in cfgs if c[3] == "golay2412"
                          or c[2] == "v27"}:
        dfn = fs._device_decoder(n, "crc32", f0, f1, ms)[0]
        dfn.register_forward_pre_hook(
            lambda m, a, key=(n, f0): seen.setdefault(key, a[0]))
    codebook_argmax.launches = viterbi_acs.launches = 0
    res = []
    for i in range(0, len(cap), 6000):
        res += fs.execute(cap[i:i + 6000])
    res += fs.flush()
    torch.cuda.synchronize()
    cb_launches, vt_launches = codebook_argmax.launches, viterbi_acs.launches
    check(len(res) == len(sent), f"OFDMFlexFrameSync: {len(res)} frames "
          f"of {len(sent)}")
    for (s0, h, p), (gh, hok, gp, pok, st) in zip(sent, res):
        check(hok and pok and np.array_equal(gh, h) and np.array_equal(gp, p)
              and 0 <= st["sample_index"] - s0 <= OF_PLATEAU,
              f"OFDMFlexFrameSync: the frame at {s0} not decoded "
              f"({hok}, {pok}, {st['sample_index']})")
    n_gol = sum(1 for c in cfgs if c[3] == "golay2412")
    n_v27 = sum(1 for c in cfgs if c[2] == "v27")
    check(cb_launches == n_gol and vt_launches == n_v27,
          f"OFDMFlexFrameSync: codebook_argmax {cb_launches} launches for "
          f"{n_gol} golay2412 payloads, viterbi_acs {vt_launches} for "
          f"{n_v27} v27 payloads")
    vt_err = 0
    for n, ms, f0, f1 in cfgs:
        if f0 == "v27":
            dfn = fs._device_decoder(n, "crc32", f0, f1, ms)[0]
            obs = dfn.vit.obs(dfn.llr(seen[(n, f0)]))
            vt_err = max(vt_err, hold_viterbi(
                torch, dfn.vit, obs, f"OFDMFlexFrameSync's v27 payload "
                f"of {n} bytes")[1])
        elif f1 == "golay2412":
            dfn = fs._device_decoder(n, "crc32", f0, f1, ms)[0]
            hold_payload_codebook(torch, dfn.soft_bits(seen[(n, f0)])
                                  .reshape(-1, 24).contiguous(), dfn.bip)
    print(f"ofdm: OFDMFlexFrameSync on the card decodes {len(res)} frames of "
          f"{len(cfgs)} configs (golay2412 on codebook_argmax: "
          f"{cb_launches} launches; v27 on viterbi_acs: {vt_launches} "
          f"launches; hamming74 on the device einsum; uncoded on the host; "
          f"the headers on the host) with the bytes sent; viterbi_acs = "
          f"plain (bits and decisions) and codebook_argmax = plain on the "
          f"payloads' own symbols", flush=True)

    # 30. the one-shot sync and the S0 detector on the reference frame
    # offg_a; ofdmflexframesync on offg_a and offg_b
    gfr = golden_frames()
    gold = dict(np.load(os.path.join(ROOT, "tests", "golden",
                                     "flexframe_golden.npz")))
    par = ofdm.ofdm_params(64, 16)
    x = np.concatenate([np.zeros(30, np.complex64), gold["offg_a"],
                        np.zeros(30, np.complex64)])
    _, p_syms, nh, npd = off._frame_geometry(par, 64, "crc32", "none",
                                             "golay2412", "qpsk")
    r = ofdm.ofdm_frame_sync(par, x, nh + npd)
    rc = ofdm.ofdm_frame_sync(par, x, nh + npd, device="cpu")
    check(r.detected and r.sample_index == 30 + OF_S1 == rc.sample_index
          and abs(r.cfo_hat - rc.cfo_hat) < 1e-6
          and np.abs(r.data_syms - rc.data_syms).max() < 1e-4,
          f"ofdm_frame_sync on offg_a: card ({r.detected}, "
          f"{r.sample_index}, {r.cfo_hat}), CPU ({rc.sample_index}, "
          f"{rc.cfo_hat})")
    dec, _ = off._decode_header(r.data_syms.reshape(-1)[:8 * 36])[:2]
    check(np.array_equal(dec[:8], gfr.lcg_bytes(8, 101)),
          "ofdm_frame_sync on offg_a: header bytes")
    rng = np.random.default_rng(30)
    xs = np.zeros(4 * 4096, np.complex64)
    xs[5000:5000 + len(gold["offg_a"])] = gold["offg_a"]
    xs = (xs + 0.01 * (rng.standard_normal(len(xs)) + 1j *
                       rng.standard_normal(len(xs)))).astype(np.complex64)
    det = {}
    for key, where in (("card", dev), ("cpu", torch.device("cpu"))):
        d = ofdm.ofdm_detector_stream(4096, par).to(where)
        c = d.init(device=where)
        hits = []
        for b in range(4):
            o, c = d(c, torch.from_numpy(xs[b * 4096:(b + 1) * 4096])
                     .to(where))
            v = o.valid.cpu().numpy()
            hits += [(int(i), float(f)) for i, f in zip(
                o.sample_index.cpu().numpy()[v], o.cfo.cpu().numpy()[v])]
        det[key] = hits
    check(len(det["card"]) == 1 and [i for i, _ in det["card"]]
          == [i for i, _ in det["cpu"]]
          and abs(det["card"][0][1] - det["cpu"][0][1]) < 1e-6
          and 0 <= det["card"][0][0] - 5000 <= OF_PLATEAU,
          f"ofdm_detector_stream: card {det['card']}, CPU {det['cpu']}")
    for tag, n, seed in (("offg_a", 64, 101), ("offg_b", 40, 113)):
        ro = off.ofdmflexframesync(np.concatenate(
            [np.zeros(30, np.complex64), gold[tag],
             np.zeros(30, np.complex64)]))
        check(ro.crc_ok and np.array_equal(ro.header, gfr.lcg_bytes(8, seed))
              and np.array_equal(ro.payload, gfr.lcg_bytes(n, seed + 1)),
              f"ofdmflexframesync: {tag} not decoded")
    print(f"ofdm: ofdm_frame_sync on the card finds offg_a's S1 at "
          f"{r.sample_index} (= the CPU's; cfo within 1e-6, symbols within "
          f"1e-4) and its header bytes; ofdm_detector_stream on the card = "
          f"the CPU on offg_a in noise (index {det['card'][0][0]}, on the S0 "
          f"plateau); ofdmflexframesync on the card decodes offg_a and "
          f"offg_b with the golden's bytes", flush=True)
    return cb_launches, vt_launches, float(vt_err)


if __name__ == "__main__":
    main()
