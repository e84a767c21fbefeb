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
     on a noise-only channel; the codebook_argmax kernel ran, and the
     suppress_scan kernel once a block (the greedy suppression fold and
     the ranking of the first P kept segments);
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
     launch per block; then fir_real itself at 1, 13, 257, 4096, 4200
     and 24576 taps (fir_real.LMAX: above 4096 the kernel asks for more
     than 48 KB of shared memory) and at a ragged T (2053), the long
     filters' times at 16 x 65536 beside F.conv1d, and 24577 taps
     refused on the card;
 11. times (CUDA events): the receiver step, and each kernel against its
     plain version (plain, kernel, kernel, plain); torch.profiler over 3
     receiver steps (device time by kernel; a measurement, no check);
     suppress_scan's keep masks and ranking (sel, n_cand) bit-equal to
     its plain version on block 1's own detections, its device time a
     launch there (torch.profiler over 50 launches), the wrapper's time a
     call and the plain version's.

Then the timing-recovery family at 256 channels x 32768-sample blocks
(QPSK at 2 samples/symbol, arkaiser pulses with a fractional delay per
channel, made with numpy and scipy):

 12. symsync(k=2, m=5) over 3 carried blocks at 40 dB SNR: after the first
     block T/2 +- 2 symbols per block on every channel, the tail symbols
     against those sent (_tail_err < 5e-3, tests/test_symsync_misc.py)
     on every channel, branch_bank and symsync_scan launched once per
     chunk and block;
 13. symtrack_stream(ms="qpsk") over 3 carried blocks, adding per-channel
     gain, carrier phase and on a quarter of the channels a CFO up to
     5e-4 rad/sample, at 20 dB SNR, on the route the card's rule picks
     (framing/symtrack.py's _use_fused): over the third block's last 8192
     symbols the decisions equal those sent up to a delay and a multiple
     of 90 degrees (SER <= 1e-3) on every channel; agc_scan and that
     route's kernels (branch_bank, symsync_scan and pll_lms per chunk
     and block, or symsync_pll_lms once a block) launched as the blocks
     and chunks say;
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
     branch_bank bit-equal to its plain version and within 1e-5 of rms
     of F.conv1d (TF32 off) on symsync's input, the tracker's bank on
     phase 13's, a real stream, a ragged chunk and a strided view;
 15. 4 channels x 4096 samples through symtrack_stream on the card and on
     the CPU (hoisted route with the kernels' plain versions): equal valid
     masks and decisions, symbols within 2e-4;
 16. times (CUDA events): each new kernel against its plain version at
     1024 steps / 3072 slots (plain, kernel, kernel, plain), each kernel
     at full width, branch_bank at the tracker's whole block (256 x
     32768, 4.29 GB out) beside F.conv1d, and the symsync and
     symtrack_stream block steps;
 17. torch.profiler over 3 symtrack_stream steps: device time by kernel,
     device operations per step, busy share (a measurement, no check);
 41. (right after phase 17, on phase 13's stream) symtrack's two routes
     over its 3 carried blocks, LIQUID_SYMTRACK_FUSED=1 and =0: on the
     fused route symsync_pll_lms launched once per block and neither
     branch_bank, symsync_scan nor pll_lms, valid masks and decisions
     equal to the sequential route's, symbols and carries within 2e-4
     (the largest difference printed, 0 when bit-equal), SER <= 1e-3 on
     every channel; symsync_pll_lms (on the input planes, its filter warp
     at its default 8 rows a step and at the full bank of 32, the misses
     of both printed, none at the full bank) against its plain version
     on 256 channels x 1024
     steps (the timing loop's slot mask and state bit-equal, y and the
     PLL state within 2e-4, decisions and eq_n equal), on a ragged chunk
     (509 steps), from the zero state (acquisition), at L = 32 and with
     the argmin slicer (qam16, its own stream); times (CUDA events): the
     kernel at 1024 steps against its plain version, per 4096-step chunk
     against branch_bank + symsync_scan + pll_lms on the same chunk, a
     whole block's one launch at both windows, both routes' block steps
     at 1, 8, 32, 64 and 256 channels x 32768 samples (the crossover the
     card's rule rests on), and torch.profiler over 3 steps of each
     route.

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
     version on block 1's slot soft bits; suppress_scan once per block;
 21. times (CUDA events) of the analyzer, receiver and whole scanner
     steps; torch.profiler over 3 scanner steps; suppress_scan's keep
     masks and ranking bit-equal to its plain version on block 1's
     detections;
 22. flexframe_rx_stream(32768, 64) (crc32 / none / golay2412 / qpsk) at
     128 channels, 3 carried blocks + a flush: frames from the port's
     flexframegen at random offsets (some across block boundaries), the
     reference's ffg_a on channel 1, CFO 0.002 rad/sample at 20 dB SNR on
     channel 2, a qam16 frame on channel 3 (must come back hdr_ok False),
     8 noise-only channels.  Every frame decodes once with hdr_ok, pay_ok,
     the header and payload bytes and sample_index within 2;
     codebook_argmax launched once per block and bit-equal to its plain
     version on the payload soft bits; the step's time and profile;
     suppress_scan once per block, its keep masks and ranking bit-equal
     to its plain version on block 1's detections;
 23. FlexFrameSync and flexframesync on the card (their default) decode
     the reference frames ffg_a, ffg_b and ffg_c; ffg_b and ffg_c take
     the host decode.

Then the convolutional codes and the GMSK frame family:

 24. viterbi_acs against its plain version on the card, bits and packed
     decisions bit-equal: v27, v29, v39 at 512 codewords x 68 bytes (the
     GMSK receiver's shape) at noise 0.8 / 1.0 and at zero noise (which
     must decode to the bytes sent), v27p23, v27p78, v29p34, v29p78, one
     codeword and 37 of one byte, v29 at 2000 bytes (decisions in device
     memory), all-zero metrics, 2048 codewords (several warps a
     scheduler), 46 steps (not a multiple of the warp form's tile), and
     the block form at ns = 32, 512, 1024 on random +-1 tables; times at
     the receiver's shape and at tools/bench_viterbi.py's (256 x 64
     bytes, v27 and v29) over 200 launches, in decoded kbit/s, beside the
     bound, the chain's floor (T steps at one step's latency, from a lone
     codeword at two lengths, also in cycles at the card's clock), the
     traceback's share (the launch with nout = 0 skips it) and the block
     form's figures before (PERF.md);
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
     metrics; suppress_scan once per block, its keep masks and ranking
     bit-equal to its plain version on block 1's detections (also in
     phase 26); the
     step's time and profile;
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
     there against its bound; suppress_scan once per block (the S0
     chunks' fold and its ranking), its keep masks and ranking bit-equal
     to its plain version on block 1's detections; the step's time (CUDA
     events) and profile;
 29. OFDMFlexFrameSync on the card over six frames of six configs
     (golay2412 on codebook_argmax, v27 on viterbi_acs, hamming74 on the
     device einsum, uncoded on the host): every frame with the bytes
     sent, each kernel launched once per such payload and held to its
     plain version on the payload's own symbols;
 30. ofdm_frame_sync on the card on the reference frame offg_a (S1 found
     where the CPU finds it, the header's bytes), ofdm_detector_stream on
     the card against the CPU on offg_a in noise, ofdmflexframesync on
     the card decoding offg_a and offg_b.

Then the multi-rate paths and the FIR side of the filters and resamplers:

 31. multirate_rx, chain(kernel_fuse(fuse(chain(nco(0.125, "down"),
     firfilt(kaiser 64), firdecim(4, kaiser 48)))), msresamp(0.375)): one
     mix_fir_decim at down 4 with 111 taps, then a halfband decimator,
     its zeta and resamp(3/4) on the banded matmul; 64 channels, 3
     carried blocks of 262144 samples, then blocks of 8192/4096/8192.
     mix_fir_decim launched once per block and within 2e-4 of its plain
     version on the path's own inputs and carries (a forward hook); the
     front against float64 numpy (mix, the unfused filters, decimate) on
     2 channels x 8192 outputs; the path on 8 channels against the port
     on the CPU (< 2e-4 of rms); a tone 0.02 cycles/sample above the
     mixer at 0.02 * 32/3 within 0.02, sidelobes below -40 dB; times of
     the step and of the kernel alone at down 4 (plain, kernel, kernel,
     plain) beside its bound; torch.profiler over 3 steps;
 32. multirate_tx, chain(firinterp(2, rrcos(2, 7, 0.35)), msresamp(2.5),
     nco(0.125, "up")): 64 channels x 32768 QPSK symbols per block, 3
     carried blocks of 163,840 samples out; 8 channels against the CPU
     within 2e-5 at unit power; a tone's peak and sidelobes as in 31; the
     step's time and profile;
 33. the new Procs alone at 16 x 131072 (tools/bench_suite.py's shape):
     firdecim4, firinterp4, resamp 3/2 and 2/3, firhilb, resamp2_interp,
     msresamp2("interp", 2), the QMF analyzer -> synthesizer, and resamp
     127/100 (the gather route) at 4 x 12800, each against its CPU run on
     4 channels (< 2e-5 of rms) and timed; the QMF loopback within 2e-3
     after its delay; on the card, the reference C library's resamp_23,
     resamp_54, r2_*, qmf_* and ms2_* goldens within 1e-5 and the 12
     firdecim goldens within 1e-3.

Then the analog paths, the IIR side of the filters and the channel model,
at 64 channels x 262144 samples per block:

 34. analog_tx, chain(freq_modulator(0.1), channel(snr_db=30, dphi=0.001,
     4 complex multipath taps, shadowing 1 dB at Doppler 0.001)): a
     two-tone message (0.013 and 0.037 cycles/sample at 0.6 and 0.3,
     scaled per channel) over 3 carried blocks; iir_scan (the shadowing)
     launched once per block and bit-equal to its plain version on the
     path's own noise (the first and last 1024 samples of each block and
     the carries, a recording wrapper); channels 0-3 rebuilt in float64
     numpy from the message and the recorded shadowing (the FM table,
     the multipath, the shadowing gain, the carrier offset): the card's
     output less the signal gain times that rebuild has the AWGN's power
     within 1%, and the same rebuild without the shadowing does not; the
     shadowing process's std within 0.02 of 1; iir_scan's size repairs:
     12 second-order sections (two launches) and an order-24 complex
     section (the wide form, its state in shared memory) bit-equal to the
     plain version over 64 x 1024 from a random state, each timed at
     64 x 32768, and a section of 4097 coefficients refused on the card;
     the step's time, the kernel at the path's shape over 100 launches
     beside its bound, a lone row's time at two lengths (its step
     latency), the plain version at 1024 steps; torch.profiler over 3
     steps;
 35. analog_rx on those blocks, chain(iirfilt_sos(butter 7, 0.2),
     freq_demodulator(0.1), iirdecim(4), iirfilt_dc_blocker(0.01)):
     every IIR filter on the block form, iir_block_state launched 3 times
     a block and bit-equal to its plain version on the last block's own
     inputs; channels 0-3 within 1e-4 of rms of a float64 scipy
     sosfilt/lfilter reference on the same input; the message back (both
     tones within 2% of their amplitudes, the residual below 0.016 rms,
     twice what 30 dB of AWGN leaves); the scan and block backends within
     1e-4 of rms of each other on the card at 64 x 32768 (an order-7 SOS,
     the cccf golden's filter, the integrator, the differentiator), each
     case's reading printed beside each backend's against float64 scipy
     on channels 0-3, and the block form with TF32 matmuls outside that
     limit in every case (the limit sees the precision it guards);
     the step's time, iir_block_state at the order-7 filter's shape over
     100 launches beside its bound, a lone row's time at two lengths, its
     plain version; torch.profiler.
 42. (right after phase 35, on analog_tx's blocks) analog_rx's first
     stage on the third backend, iirfilt_sos(butter 7, 0.2,
     backend="pscan"): 3 carried blocks of 64 x 262144 complex samples,
     the iir_pscan kernel once a block on the 128 plane rows (no iir_scan,
     no iir_block_state) and bit-equal to its plain version on block 1's
     own rows and carry; y and the carries within 1e-4 of rms of the scan
     and of the block form on the card, channels 0-3 against float64
     scipy (beside the scan's figure, < 1e-4), the 3 carried blocks
     within 1e-4 of rms of one call over the whole stream; iir_pscan
     bit-equal to its plain version from a random carry on butter 16 (8
     sections) and butter 2 (one) at 128 plane rows x 32768 and on a
     complex-coefficient cascade (butter 5 at 0.1 shifted by 0.6
     rad/sample) at 64 complex rows x 32768; times: the kernel at the
     path's shape over 100 launches, twice, beside iir_scan on the same
     rows and filter, its bound by bytes and by operations, its plain
     version, and a block through each backend's Proc (pscan, scan,
     block); the scan backend's iir_scan calls on the stream's 128
     float32 plane rows (real coefficients kept real).

Then the support slice (FEC, IO, the streaming runtime, the CVSD codec):

 36. stream_runner: 64 cs16 captures of 3 x 262144 + 100,000 samples
     (a tone of its own and noise each, written with io.write_iq), read
     by 64 io.iq_stream iterators in blocks of 262144 (four, the last
     zero-padded) and stacked into StreamRunner(kernel_fuse(fuse(chain(
     nco, firfilt64, firfilt57, msresamp(0.5)))), batch_shape=(64,)):
     one mix_fir_decim launch a block; a checkpoint after block 2 that a
     fresh runner loads, its blocks 3-4 bit-equal to the uninterrupted
     run's; every output bit-equal to the proc called directly with the
     same carries, and within 2e-4 of rms of the kernel's plain version;
     8 channels within 2e-4 of rms of the port on the CPU (the kernel
     takes B % 8); an output back exactly through write_iq/read_iq cf32;
     ms per block for the host read, the runner call, the whole loop,
     and alone the host-to-device copy and the step;
 37. ldpc_bp: make_regular_ldpc(648, 324, col_weight=3, seed=0) (the
     first full-rank seed), 64 messages x 64 BPSK AWGN draws at sigma
     0.65 = 4096 rows, ldpc_decoder_device(H, 50) and min-sum on the
     card: at least 99% of rows decode under sum-product, every ok row
     is its sent codeword, the first 256 rows equal the CPU's wherever
     the CPU converged (ok counts within 0.5%), rows 0-7 equal the host
     float64 decoder; ms per decode, operations per call and busy share
     (torch.profiler, at most 4 a decode); the iterations, decisions and
     parity are one ldpc_bp launch a decode in both modes, and ldpc_bp
     on each decode's LLRs against its plain version on the card: the
     messages, hard and ok bit-equal, and by a matmul syndrome the same
     decisions and parity on every row the plain version decodes (>= 99%
     of them in sum-product); both timed (CUDA events) beside the bound;
 38. cvsd: cvsd_encode/cvsd_decode on the card against the compiled
     reference's golden (bits equal, audio within 1e-4); cvsd_scan bit-
     equal to its plain version on the path's own [1, 400] rows and at
     1024 x 4096 (bits and audio; decode on uint8 bits, as the path); its
     times at 1024 streams x 32768 samples (100 launches each) beside
     its bound and a lone row's step (the chain's floor).

Then the equalizers:

 39. eqlms and eqrls at 256 channels, as examples/eqlms_dd_example.py
     and examples/eqrls_example.py run them, through the Procs on the
     card: eqlms(13, mu=0.2) trained on 256 x 400 unit-energy QPSK
     symbols through h = [1, 0.35-0.2j, -0.12+0.05j] with noise 0.01 a
     rail (a seed per channel), then eqlms(13, mu=0.05) decision-directed
     on the carry over 256 x 32768: every decision after sample 200
     equal to the sent symbol and EVM <= -30 dB on every channel;
     eqrls(9, lam=0.99, delta=0.1) trained over 256 x 32768 through
     h = [1, 0, -0.25+0.2j, 0, 0.1]: MSE after sample 1000 <= -30 dB on
     every channel, P finite.  eqlms_scan bit-equal to its plain version
     on the card on the path's 400-sample trained block and the first
     1024 decision-directed samples (outputs and every carry leaf), and
     on a real BPSK stream with the sign slicer at 64 x 4096; eqrls_scan
     on the first 1024 samples and at L = 32 on 64 x 2048.  Each
     kernel's time at 256 x 32768 (100 launches, twice) beside its
     bound, a lone channel's step (the chain's floor) and its plain
     version at 256 x 1024.

Then the mesh (parallel/), in one process, its device repeated on one
card (the cards in turn where there are several):

 40. time_shard_apply: chain(nco(0.125, "down"), firfilt 64 and 57 taps
     with backend="pallas") at 64 x 262144 on a 2 (ch) x 4 (t) mesh, 3
     carried blocks, against the same chain on one device and a
     complex128 reference (the mixer in closed form, FFT convolutions):
     the sharded outputs and FIR carries no further from the reference
     than 1.5 times one device's (the mixer's float32 phases round at
     other magnitudes from each shard's closed-form start; both errors
     printed), its carried phase bit-equal; the two FIRs alone
     bit-equal to one device; fir_real launched 2 x 8 a
     block and held to its plain version on one shard's input and carry;
     framesync64_time_sharded at 128 x 32768 on 4 shards of 8192, 6
     slots a shard, 3 carried blocks: frames 1740 or more apart, one a
     channel placed across a shard boundary, on one, across a shard's
     emit window or across a block boundary, 8 noise-only channels;
     every frame decoded once through qpacket_soft_decoder on the card
     (codebook_argmax, once a block, bit-equal to its plain version on
     block 1's rows) with its CRC and bytes, one suppress_scan a block
     over every shard's segments (its keep masks bit-equal to its plain
     version on block 1's), no shard over its slots, the
     same sample_index as framesync64_stream on one device, symbols
     within 2e-5 (tests/test_rx_timeshard.py) and the carry equal;
     StagePipeline of multirate_rx's two stages at 64 x 262144, 3 blocks,
     bit-equal to the stages chained on one device, mix_fir_decim
     launched once a block and held to its plain version on stage 0's
     block; StreamRunner(mesh=) on the fused headline chain (no
     kernel_fuse: its carry is not a halo) on 4 time shards, 3 blocks
     with a checkpoint resume (bit-equal), no further from a complex128
     reference than 1.5 times the runner without a mesh, and without
     the mixer bit-equal to it; ms a block of each path,
     sharded and on one device (the host clock over 10 calls, every
     card synchronized), and torch.profiler over the sharded chain's and
     receiver's steps.

Then Proc.scan_blocks, the JAX package's run over [N_blocks, ..., T]:

 43. the headline chain (phase 3's proc, on mix_fir_decim) through
     scan_blocks over 3 blocks of 64 x 262144 planes with device=cuda:
     the stacked output and the carry torch.equal to 3 forward calls,
     mix_fir_decim launched 3 times in the scan and block 0 held to its
     plain version (< 2e-4 of rms), the scan's ms beside the 3 calls';
     the frame64 stream receiver (framesync64_stream) over 2 blocks of
     128 x 32768: every leaf of its NamedTuple output, stacked on axis
     0, and its carry equal bit for bit to 2 forward calls,
     suppress_scan launched once a block.

The JSON line before the card's name lists all seventeen kernels, each
with its launches on its main path (symsync_scan and branch_bank on
symsync and, in "launches_by_path", the tracker's sequential route;
pll_lms on that route; symsync_pll_lms on the fused route; mix_fir_decim also per path, in
"launches_by_path": the headline chain, multirate_rx, stream_runner,
the StagePipeline and the headline chain's scan_blocks; fir_real on firfilt(backend="pallas") and the
time-sharded chain; codebook_argmax also per path, in
"launches_by_path": frame64 receiver, scanner, flexframe receiver, GMSK
receiver, OFDM receiver, OFDMFlexFrameSync, the time-sharded receiver; viterbi_acs on the GMSK
receiver with v27 payloads, on the flexframe receiver and on
OFDMFlexFrameSync; iir_scan and iir_block_state on analog_tx and
analog_rx, with the lax.scan each replaces under "recurrence";
iir_pscan on iirfilt_sos(backend="pscan") (phase 42), with the
lax.associative_scan it replaces under "recurrence"; cvsd_scan
on cvsd_encode/cvsd_decode; eqlms_scan and eqrls_scan on the equalizer
path; suppress_scan per path, in "launches_by_path": frame64 receiver,
scanner, flexframe receiver, GMSK receiver, OFDM receiver, the
time-sharded receiver, framesync64_stream's scan_blocks; ldpc_bp on ldpc_decoder_device, per mode; each
counted from 0 over its own run), its error against the plain version
(for viterbi_acs the count of decoded bits that differ, for ldpc_bp of
the final messages), its time,
the plain version's, the time of one PyTorch call for the same function
where there is one (F.conv1d for fir_real and branch_bank), and its bound: the larger of
the bytes it must move over 3.35 TB/s and its float32 operations over
67 TFLOP/s (a multiply-add counts 2), from this run's shapes and data.
"""
import contextlib
import json
import os
import subprocess
import sys
import time
import types

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
TR_WARM = 8192     # samples a stress case's tracker runs before the window
TR_CROSS = (1, 8, 32, 64, 256)   # channels of the routes' crossover
TOL_TAIL = 5e-3    # symsync tail error (tests/test_symsync_misc.py:45-56)
TOL_STREAM = 2e-4  # symtrack stream tolerance (tests/test_framing_extras.py:56)
TOL_AGC = 1e-6     # agc_scan vs plain, max|err|/rms, if not bit-equal
TOL_CONV = 1e-5    # branch_bank vs F.conv1d (TF32 off), max|err|/rms: two
#                    summation orders of one float32 sum of Lb products
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
              (6, 2053, 144), (2, 3000, 4200), (2, 3000, 24576))
#             (rows, T, L): a ragged T stores past no row; above 4096 taps
#             the shared memory asked for beyond 48 KB, up to fir_real.LMAX
FIR_LONG = (16, 1 << 16)    # rows x samples of the long filters' timings
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
VT_WIDE = 2048              # codewords: several warps a scheduler
VT_ONE = 68, 400            # bytes of the lone codeword timed for the slope
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
MR_B, MR_T = 64, 1 << 18    # multirate_rx: channels x samples per block
MR_MIXED = (8192, 4096, 8192)   # blocks of mixed length after the full ones
MR_CMP = (8, 1 << 15)       # channels x samples of the card-vs-CPU run
MR_TONE = 0.02              # cycles/sample above the mixer
TX_B, TX_T = 64, 1 << 15    # multirate_tx: channels x QPSK symbols per block
TX_OUT = 5 * TX_T           # samples out per block (2 x 5/4 x 2)
TX_TONE = 0.05              # cycles/symbol
TOL_TX = 2e-5               # card vs CPU at unit power (tests/test_resample.py:321)
P33_B, P33_T = 16, 1 << 17  # the new Procs alone: tools/bench_suite.py's shape
P33_CPU = 4                 # channels of their card-vs-CPU runs
P33_GATHER = (4, 12800)     # resamp(127/100)'s gather route: kept small
TOL_PROC = 2e-5             # a Proc on the card vs the CPU, max|err|/rms
TOL_R2 = 1e-5               # resamp, resamp2, QMF, msresamp2 goldens
TOL_DECIM = 1e-3            # firdecim goldens (tests/conftest.py:93)
AN_B, AN_T = 64, 1 << 18    # channels x samples per block, analog paths
AN_KF = 0.1                 # FM modulation factor (freqmodem_example.py)
AN_TAPS = (1.0, 0.12 - 0.05j, -0.06j, 0.03 + 0.02j)   # multipath taps
AN_CHECK = 4                # channels held to the float64 scipy reference
AN_SETTLE = 2048            # output samples before the filters settle
AN_CMP = 1024               # steps of the iir_scan kernel-vs-plain windows
AN_BACKENDS = (64, 32768)   # channels x samples of the scan-vs-block runs
AN_SPLIT = 12               # sections of the split iir_scan cascade
AN_WIDE = 24                # order of the wide-form iir_scan section
AN_IIR_T = 1 << 15          # samples a row of the repairs' timings
TOL_AN64 = 1e-4             # analog_rx vs float64, max|err|/rms (block vs
#                             scan bound, tests/test_agc_eq_iir.py:193)
TOL_BACKENDS = 1e-4         # scan vs block on the card, max|err|/rms
AN_RES = 0.016              # recovered message's residual rms: twice the
#                             0.0080 that 30 dB of AWGN predicts (PERF.md)
AN_AMP = 0.02               # each recovered tone's amplitude, relative
AN_TXPOW = 0.01             # analog_tx minus its float64 rebuild on
#                             channels 0-3, over the AWGN's power nstd^2:
#                             within 1% of 1 (the estimate's own spread on
#                             3.1 M complex samples is 0.06%)
SR_CH, SR_T = 64, 1 << 18  # stream_runner: captures x samples per block
SR_N = 3 * SR_T + 100_000   # samples per capture: 4 blocks, the last padded
SR_CPU = 8                  # channels held to the port on the CPU (B % 8)
LD_N, LD_SEED = 648, 0      # LDPC block length, the first full-rank seed
LD_MSGS, LD_ROWS = 64, 4096  # messages, rows (64 noise draws each)
LD_SIGMA = 0.65             # BPSK AWGN: 99.8% of 512 rows decode on the CPU
LD_ITERS = 50               # belief-propagation iterations
LD_CPU, LD_HOST = 256, 8    # rows held to the CPU, to the host decoder
CV_CMP = (1024, 4096)       # cvsd_scan vs its plain version
CV_GATEWAY = (1024, 1 << 15)  # streams x samples of the timing
EQ_B, EQ_T = 256, 1 << 15   # equalizer channels x samples (DD / RLS block)
EQ_TRAIN = 400              # LMS training symbols (eqlms_dd_example.py)
EQ_CMP = 1024               # samples of the kernel-vs-plain windows
EQ_REAL = (64, 4096)        # the real BPSK stream (sign slicer)
EQ_RLS32 = (64, 2048)       # eqrls_scan at L = 32
EQ_LIMIT_DB = -30.0         # LMS EVM and RLS MSE limit on every channel
AN_SHSTD = 0.02             # the shadowing process's std and mean over
#                             64 x 786432 samples, from 1 and 0 (their
#                             spread at 159 samples a correlation time:
#                             0.0013 and 0.0025)
PA_B, PA_T = 64, 1 << 18    # parallel: the chain, pipeline and runner
PA_NT, PA_NC = 4, 2         # time shards; the chain's channel groups
PA_RX_B, PA_RX_T = 128, 1 << 15   # the time-sharded receiver
PA_RX_P = 6                 # slots a shard: frames >= 1740 apart, so at
#                             most 5 start in a shard's 8192 samples
PA_QUIET = 8                # noise-only channels (the last ones)
PA_GAP = (1740, 6000)       # frame spacing on a channel
TOL_SHARD_SYM = 2e-5        # tests/test_rx_timeshard.py:108
F64_RATIO = 1.5             # a sharded mixer's error to complex128 over
                            # one device's


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
    log = lib.with_suffix(".log").read_text().splitlines()
    ptxas = [ln.strip() for ln in log if "registers" in ln or "spill" in ln]
    # each source's nvcc seconds (all run at once; a cached library has
    # the times of the call that built it)
    secs = sorted((ln.split()[1:3] for ln in log if ln.startswith("nvcc ")),
                  key=lambda v: -float(v[1]))
    print(f"build: {lib.name} (nvcc {' '.join(build.NVCC_FLAGS)}) in "
          f"{time.perf_counter() - t0:.1f} s; nvcc a source: "
          + ", ".join(f"{n[:-1]} {v} s" for n, v in secs)
          + f"; ptxas: {' | '.join(ptxas)}", flush=True)

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
    tr_ctx, tr_entries = timing_phases(torch, dev, card)
    kernels += tr_entries
    took("phases 12-17")
    seq_n, fused_entry = fused_phase(torch, dev, card, tr_ctx)
    # symsync_scan's own path is symsync (phase 12); it and pll_lms run on
    # the tracker's sequential route too, which phase 41 drives alone
    for ent in tr_entries:
        if ent["name"] == "symsync_scan":
            ent["launches"] = tr_ctx["ss_launches"]
            ent["launches_by_path"] = {
                "symsync": tr_ctx["ss_launches"],
                "symtrack_sequential": seq_n["symsync_scan"]}
        elif ent["name"] == "branch_bank":
            ent["launches_by_path"] = {
                "symsync": ent["launches"],
                "symtrack_sequential": seq_n["branch_bank"]}
        elif ent["name"] == "pll_lms":
            ent["launches"] = seq_n["pll_lms"]
            ent["launches_by_path"] = {"symtrack_sequential":
                                       seq_n["pll_lms"]}
    del tr_ctx
    took("phase 41")
    channelizer_phases(torch, dev, card)
    took("phases 18-19")
    sc_launches, sc_err, sc_ss = scanner_phases(torch, dev, card)
    took("phases 20-21")
    ff_launches, ff_err, ff_ss = flexframe_phases(torch, dev, card)
    took("phases 22-23")
    vt = viterbi_phase(torch, dev, card)
    took("phase 24")
    gm_cb, gm_cb_err, gm_vt, gm_vt_err, gm_ss = gmsk_phases(torch, dev,
                                                            card)
    took("phases 25-26")
    cv_launches = conv_phases(torch, dev, card)
    took("phase 27")
    of_cb, of_cb_err, of_ss = ofdm_stream_phase(torch, dev, card)
    took("phase 28")
    fs_cb, fs_vt, fs_vt_err = ofdm_sync_phases(torch, dev, card)
    took("phases 29-30")
    mr_launches, mr_err = multirate_rx_phase(torch, dev, card)
    took("phase 31")
    multirate_tx_phase(torch, dev, card)
    took("phase 32")
    p33_phase(torch, dev, card)
    took("phase 33")
    an_x, scan_entry = analog_tx_phase(torch, dev, card)
    took("phase 34")
    block_entry = analog_rx_phase(torch, dev, card, an_x)
    took("phase 35")
    pscan_entry = pscan_phase(torch, dev, card, an_x)
    del an_x
    took("phase 42")
    sr_launches, sr_err = stream_runner_phase(torch, dev, card)
    took("phase 36")
    ldpc_entry = ldpc_phase(torch, dev, card)
    took("phase 37")
    cvsd_entry = cvsd_phase(torch, dev, card)
    took("phase 38")
    eq_entries = equalizer_phase(torch, dev, card)
    took("phase 39")
    pa = parallel_phase(torch, dev, card)
    took("phase 40")
    sb = scan_blocks_phase(torch, dev, card)
    took("phase 43")
    # each path's run counted from 0; the other kernel's count was checked
    # to be 0 there
    scan_entry["launches_by_path"] = {"analog_tx": scan_entry["launches"],
                                      "analog_rx": 0}
    block_entry["launches_by_path"] = {"analog_rx": block_entry["launches"],
                                       "analog_tx": 0}
    mfd = kernels[0]
    mfd["launches_by_path"] = {"headline": mfd["launches"],
                               "multirate_rx": mr_launches,
                               "stream_runner": sr_launches,
                               "stage_pipeline": pa["mix_fir_decim"][0],
                               "scan_blocks": sb["mix_fir_decim"][0]}
    mfd["max_abs_err"] = max(mfd["max_abs_err"], mr_err, sr_err,
                             pa["mix_fir_decim"][1], sb["mix_fir_decim"][1])
    fr = next(k for k in kernels if k["name"] == "fir_real")
    fr["launches_by_path"] = {"firfilt_pallas": fr["launches"],
                              "time_sharded_chain": pa["fir_real"][0]}
    fr["max_abs_err"] = max(fr["max_abs_err"], pa["fir_real"][1])
    cb = next(k for k in kernels if k["name"] == "codebook_argmax")
    # each path's run, its counts set to 0 just before it
    cb["launches_by_path"] = {"framesync64_stream_full": cb["launches"],
                              "wideband_scanner": sc_launches,
                              "flexframe_rx_stream": ff_launches,
                              "gmskframe_rx_stream": gm_cb,
                              "ofdmflex_rx_stream": of_cb,
                              "OFDMFlexFrameSync": fs_cb,
                              "framesync64_time_sharded":
                                  pa["codebook_argmax"][0]}
    cb["max_abs_err"] = max(cb["max_abs_err"], sc_err, ff_err, gm_cb_err,
                            of_cb_err)
    vt["launches"] = gm_vt
    vt["launches_by_path"] = {"gmskframe_rx_stream": gm_vt,
                              "flexframe_rx_stream": cv_launches,
                              "OFDMFlexFrameSync": fs_vt}
    vt["max_abs_err"] = max(vt["max_abs_err"], gm_vt_err, fs_vt_err)
    ss = next(k for k in kernels if k["name"] == "suppress_scan")
    ss["launches_by_path"] = {"framesync64_stream_full": ss["launches"],
                              "wideband_scanner": sc_ss,
                              "flexframe_rx_stream": ff_ss,
                              "gmskframe_rx_stream": gm_ss,
                              "ofdmflex_rx_stream": of_ss,
                              "framesync64_time_sharded":
                                  pa["suppress_scan"][0],
                              "framesync64_stream.scan_blocks":
                                  sb["suppress_scan"]}
    kernels += [vt, scan_entry, block_entry, cvsd_entry] + eq_entries
    pscan_entry["launches_by_path"] = {"iirfilt_sos_pscan":
                                       pscan_entry["launches"]}
    kernels += [fused_entry, ldpc_entry, pscan_entry]
    check(len(kernels) == 17, f"{len(kernels)} kernels listed, want 17")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def receiver_phases(torch, dev, card):
    """Phases 8-11: the frame64 receiver with in-stream Golay decode, the
    codebook_argmax, fir_real and suppress_scan kernels.  Returns their
    kernel entries."""
    from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
    from liquid_dsp_tpu_torch.fec.device import block_codebook
    from liquid_dsp_tpu_torch.framing.frame64 import framesync64_stream_full
    from liquid_dsp_tpu_torch.ops.fir import firfilt
    from liquid_dsp_tpu_torch.ops.kernels.codebook_argmax import (
        codebook_argmax, codebook_argmax_reference, pack_codebook)
    from liquid_dsp_tpu_torch.ops.kernels.fir_real import (
        fir_real, fir_real_reference)
    from liquid_dsp_tpu_torch.ops.kernels.suppress_scan import suppress_scan

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
    suppress_scan.launches = 0
    t0 = time.perf_counter()
    for b in range(RX_NBLK + 1):
        out, carry = proc(carry, x[:, b * RX_T:(b + 1) * RX_T])
        outs.append(out)
        carries.append(carry)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    cb_launches = codebook_argmax.launches
    ss_launches = suppress_scan.launches
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
    check(ss_launches == RX_NBLK + 1, f"suppress_scan launched "
          f"{ss_launches} times in {RX_NBLK + 1} receiver blocks")
    print(f"receiver: framesync64_stream_full at {RX_B}x{RX_T}, "
          f"{RX_NBLK} carried blocks + 1 flush; {n_ok} of {n_frames} frames "
          f"decoded once, in order, crc_ok, bytes equal, sample_index "
          f"within 2 (incl. the reference C frame and the CFO 0.008 / gain "
          f"0.2 / 15 dB channel); {RX_QUIET} noise-only channels: 0 frames; "
          f"codebook_argmax launches {cb_launches}, suppress_scan launches "
          f"{ss_launches} (one fold a block); stream made in "
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
    # the long filters at FIR_LONG, the kernel beside F.conv1d (the same
    # function, TF32 off), and the refusal above the kernel's limit
    import torch.nn.functional as F
    from liquid_dsp_tpu_torch.ops.kernels.fir_real import LMAX as FIR_LMAX
    long_ms = {}
    for L_ in (4200, FIR_LMAX):
        g_ = torch.Generator(device=dev).manual_seed(L_)
        x_ = torch.randn(*FIR_LONG, generator=g_, device=dev)
        c_ = torch.randn(FIR_LONG[0], L_ - 1, generator=g_, device=dev)
        h_ = torch.randn(L_, generator=g_, device=dev) / L_ ** 0.5
        xin_ = torch.cat([c_, x_], 1)[:, None, :]
        w_ = h_.flip(0)[None, None, :].contiguous()
        long_ms[L_] = (time_ms(lambda: fir_real(x_, c_, h_), iters=5),
                       time_ms(lambda: F.conv1d(xin_, w_), iters=5),
                       bound(2 * x_.numel() * 4, 2 * x_.numel() * L_))
        del xin_
    refused = False
    try:
        fir_real(x_[:, :64].contiguous(), torch.zeros(
            FIR_LONG[0], FIR_LMAX, device=dev), torch.zeros(
            FIR_LMAX + 1, device=dev))
    except ValueError:
        refused = True
    check(refused, f"fir_real took {FIR_LMAX + 1} taps on the card")
    print(f"timing ({card}): fir_real at {FIR_LONG[0]} x {FIR_LONG[1]}: "
          + "; ".join(f"{L_} taps {k_:.4f} ms (F.conv1d {c_:.4f} ms, bound "
                      f"{b_['bound_ms']:.4f} ms by {b_['bound_by']})"
                      for L_, (k_, c_, b_) in long_ms.items())
          + f"; {FIR_LMAX + 1} taps refused on the card (ValueError)",
          flush=True)

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
    folds, _ = hold_folds(torch, lambda: proc(c1, x1),
                          "framesync64_stream_full block 1")
    ss_entry = fold_entry(torch, card, folds[0][:5],
                          "framesync64_stream_full")
    ss_entry["launches"] = ss_launches
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
        **fr_bound, "long_filters_ms": {
            str(L_): {"ms": k_, "library_ms": c_, "bound_ms": b_["bound_ms"]}
            for L_, (k_, c_, b_) in long_ms.items()}}, ss_entry]


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


def make_timing_stream(rng, B, n, m, snr_db, carrier, ms="qpsk"):
    """Symbols of `ms` (QPSK unless given) at 2 samples/symbol through an
    arkaiser(2, m, 0.3) pulse with a fractional delay in [-0.5, 0.5)
    samples per channel, white noise at `snr_db`: x [B, n] complex64 and
    the symbol indices sent [B, n/2 + 2m].  With `carrier`, each channel
    also gets a gain in [0.3, 2] and a carrier phase, and every 4th
    channel a CFO of 1e-4..5e-4 rad/sample."""
    from scipy.signal import upfirdn
    from liquid_dsp_tpu_torch.design.firdes import firdes_prototype
    from liquid_dsp_tpu_torch.modem import constellation
    table = constellation(ms).astype(np.complex64)
    nsym = n // 2 + 2 * m
    idx = rng.integers(0, len(table), (B, nsym))
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


# idle host time at each end of a trace, one a take: wider each time a
# trace is taken again, so that the takes span a spell of ~20 s
PROFILE_MARGINS_S = (0.02, 0.25, 1.0, 3.0, 3.0, 3.0)


def device_profile(torch, step, n, what):
    """({kernel name: (device ms, launches)} over n calls of `step`,
    host ms of the n calls), torch.profiler after its warm-up cycle (see
    `profile_steps`).  The n calls sit a margin of PROFILE_MARGINS_S
    inside each end of the traced cycle.  A trace with no device event,
    or with a count of device events that is no multiple of n (every call
    launches the same work), is taken again with the next margin, up to
    len(PROFILE_MARGINS_S) traces in all, and each retake is printed; the
    last is returned (`profile_steps` marks it incomplete).

    The card's profiler loses device events now and then, in spells of a
    few seconds late in a long process: a few of a trace's, or all of a
    short one's.  In phase 37, traces of six `ldpc_bp` launches came back
    empty at margins of 0.02, 0.25 and 1 s in a row and whole at 3 s;
    three takes at 0.02 s, this function's earlier form, all failed
    there once."""
    from torch.profiler import ProfilerActivity, profile, schedule
    step()
    torch.cuda.synchronize()
    for margin in PROFILE_MARGINS_S:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            step()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(margin)
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            time.sleep(margin)
        by_name = {}
        for ev in prof.events():
            # the profiler mirrors its cycle on the device as an annotation
            # "ProfilerStep#k", which is no kernel
            if ev.device_type == torch.autograd.DeviceType.CUDA and \
                    not ev.name.startswith("ProfilerStep"):
                tot, cnt = by_name.get(ev.name, (0.0, 0))
                by_name[ev.name] = (tot + ev.time_range.elapsed_us() / 1e3,
                                    cnt + 1)
        events = sum(c for _, c in by_name.values())
        if events and events % n == 0:
            return by_name, wall
        print(f"profile: {what}: {events} device events in a trace of {n} "
              f"calls at a margin of {margin} s", flush=True)
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
    """Phases 12-17: symsync and symtrack_stream at full width, the
    symsync_scan, agc_scan and pll_lms kernels.  Returns (what phase 41
    reuses: phase 13's stream and tracker, the chunks a block, phase 12's
    symsync_scan launches; the three kernels' entries)."""
    from unittest import mock
    from liquid_dsp_tpu_torch.framing.symtrack import (_use_fused,
                                                       symtrack_stream)
    from liquid_dsp_tpu_torch.modem import constellation
    from liquid_dsp_tpu_torch.ops import symsync as symsync_mod
    from liquid_dsp_tpu_torch.ops.kernels.agc_scan import (
        agc_scan, agc_scan_reference)
    from liquid_dsp_tpu_torch.ops.kernels.symsync_pll_lms import \
        symsync_pll_lms
    from liquid_dsp_tpu_torch.ops.kernels.pll_lms import (
        pll_lms, pll_lms_reference)
    from liquid_dsp_tpu_torch.ops.kernels.symsync_scan import (
        symsync_scan, symsync_scan_reference)
    from liquid_dsp_tpu_torch.ops.kernels.branch_bank import (
        branch_bank, branch_bank_reference)
    from liquid_dsp_tpu_torch.ops.symsync import (
        _chunks, branch_kernel, loop_state, symsync)
    import torch.nn.functional as F

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
    symsync_scan.launches = branch_bank.launches = 0
    for b in range(NB):
        out, c = ss(c, x1[:, b * T:(b + 1) * T])
        outs.append(out)
        ss_carries.append(c)
    torch.cuda.synchronize()
    ss_launches, bb_launches = symsync_scan.launches, branch_bank.launches
    check(ss_launches == nch * NB and bb_launches == nch * NB,
          f"symsync_scan launched {ss_launches}, branch_bank "
          f"{bb_launches} times for {nch} chunks x {NB} blocks")
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
          f"symsync_scan and branch_bank launches {ss_launches} and "
          f"{bb_launches} ({nch} chunks x {NB} blocks); stream made in "
          f"{t_gen:.1f} s", flush=True)

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
    symsync_pll_lms.launches = branch_bank.launches = 0
    t0 = time.perf_counter()
    for b in range(NB):
        out, c = st(c, x2[:, b * T:(b + 1) * T])
        st_outs.append(out)
        st_carries.append(c)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = {"agc_scan": agc_scan.launches,
                "branch_bank": branch_bank.launches,
                "symsync_scan": symsync_scan.launches,
                "pll_lms": pll_lms.launches,
                "symsync_pll_lms": symsync_pll_lms.launches}
    # the route the card's rule picks for this batch (phase 41 runs both):
    # the fused kernel once a block, or per chunk branch_bank and
    # symsync_scan, then pll_lms
    fused = _use_fused((B,), dev)
    want = {"agc_scan": NB, "branch_bank": 0 if fused else nch * NB,
            "symsync_scan": 0 if fused else nch * NB,
            "pll_lms": 0 if fused else NB,
            "symsync_pll_lms": NB if fused else 0}
    check(launches == want, f"symtrack launches {launches}, want {want} "
          f"({'fused' if fused else 'sequential'} route)")
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
          f"blocks on the card's default ({'fused' if fused else 'sequential'}"
          f") route, gain 0.3-2, random phase, CFO up to 5e-4 rad/sample on "
          f"{(B + 3) // 4} channels, 20 dB SNR; SER over the last "
          f"{TR_TAIL} symbols max {max(sers):.2e} (<= {MAX_SER}), "
          f"{sum(s > 0 for s in sers)} channels with any error; launches "
          f"{launches}; stream made in {t_gen:.1f} s, first pass "
          f"{t_run:.2f} s", flush=True)

    # 14. each kernel against its plain version, same inputs and states
    c1 = ss_carries[1]
    kern = branch_kernel(ss.mf, ss.dmf, dev)
    xp = torch.cat([c1["win"][..., 1:], x1[:, T:T + TR_CMP]], -1)
    ma = branch_bank(torch.stack([xp.real, xp.imag]).contiguous(), kern)
    fs, is_ = loop_state(c1, B)
    kw = dict(npfb=32, max_out=3, k=2, k_out=1, bw=ss.bw, locked=False)
    out_k = symsync_scan(ma, fs, is_, **kw)
    ssp1, out_p = time_once(lambda: symsync_scan_reference(ma, fs, is_, **kw))
    check(all(torch.equal(a, b) for a, b in zip(out_k, out_p)),
          "symsync_scan: kernel and plain version differ")
    ss_err = float((out_k[0] - out_p[0]).abs().max()
                   + (out_k[1] - out_p[1]).abs().max())

    # branch_bank against its plain version (bit-equal) and against cuDNN's
    # full-float32 conv1d (another summation order: TOL_CONV of the rms),
    # on symsync's input above, the tracker's bank on phase 13's input, a
    # real stream, a ragged chunk (no 16-byte stores) and a strided view
    def hold_bank(name, planes_, kern_):
        k_ = branch_bank(planes_, kern_)
        p_ = branch_bank_reference(planes_, kern_)
        P_, B_, n_ = planes_.shape
        c_ = F.conv1d(planes_.reshape(P_ * B_, 1, n_), kern_[:, None]
                      ).reshape(k_.shape)
        torch.cuda.synchronize()
        check(torch.equal(k_, p_), f"branch_bank, {name}: kernel and plain "
              f"version differ by {float((k_ - p_).abs().max()):.3e}")
        rel = float((k_ - c_).abs().max() / c_.square().mean().sqrt())
        check(rel <= TOL_CONV, f"branch_bank, {name}: {rel:.3e} of rms "
              f"from F.conv1d (> {TOL_CONV})")
        bank_abs.append(float((k_ - p_).abs().max()))
        return rel

    bank_abs = []
    kern_t = branch_kernel(st.ss.mf, st.ss.dmf, dev)
    xp_t = torch.cat([st_carries[1]["ss"]["win"][..., 1:],
                      x2[:, T:T + TR_CMP]], -1)
    xp_w = torch.cat([c1["win"][..., 1:], x1[:, T:T + 4 * TR_CMP]], -1)
    planes_w = torch.stack([xp_w.real, xp_w.imag])
    bank_rel = {
        f"symsync's bank (Lb {kern.shape[1]}), {B} x {TR_CMP}": hold_bank(
            "symsync", torch.stack([xp.real, xp.imag]).contiguous(), kern),
        f"the tracker's bank (Lb {kern_t.shape[1]})": hold_bank(
            "tracker", torch.stack([xp_t.real, xp_t.imag]).contiguous(),
            kern_t),
        "a real stream (P=1)": hold_bank("P=1", xp.real[None].contiguous(),
                                         kern),
        f"a ragged chunk ({TR_STRESS} steps)": hold_bank(
            "ragged", torch.stack([xp.real, xp.imag])[
                ..., :TR_STRESS + kern.shape[1] - 1].contiguous(), kern),
        "a strided view": hold_bank("view", planes_w[
            ..., TR_CMP // 2 + 3:TR_CMP // 2 + 3 + TR_CMP
            + kern.shape[1] - 1], kern)}
    del xp_w, planes_w
    print(f"branch_bank vs plain, bit-equal; vs F.conv1d (TF32 off), "
          f"max|err|/rms: " + "; ".join(f"{k_} {v_:.2e}" for k_, v_ in
                                        bank_rel.items())
          + f" (<= {TOL_CONV})", flush=True)

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
    ma_real = branch_bank(xr[None].contiguous(), kern)
    c0 = ss_carries[0]
    xp0 = torch.cat([c0["win"][..., 1:], x1[:, :n_s]], -1)
    ma_acq = branch_bank(torch.stack([xp0.real, xp0.imag]).contiguous(),
                         kern)
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
    ma_full = branch_bank(torch.stack(
        [xp[:, :T // nch + kern.shape[-1] - 1].real,
         xp[:, :T // nch + kern.shape[-1] - 1].imag]).contiguous(), kern)
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
    # branch_bank at the tracker's full block (its bank, 256 x 32768, the
    # planes as the fused route builds them) against F.conv1d on the same
    # planes; its plain version at TR_CMP steps.  Bound: the planes read
    # and the outputs written once, one multiply-add a tap and output
    xp_b = torch.cat([c2["ss"]["win"][..., 1:],
                      st.ag(c2["agc"], x2[:, 2 * T:])[0]], -1)
    pl_b = torch.stack([xp_b.real, xp_b.imag]).contiguous()
    del xp_b
    R_, Lb_ = kern_t.shape
    wc_ = kern_t[:, None].contiguous()
    pl_c = pl_b[..., :TR_CMP + Lb_ - 1].contiguous()
    bbp1 = time_once(lambda: branch_bank_reference(pl_c, kern_t))[0]
    bbk = []
    for _ in range(2):
        bbk.append(time_ms(lambda: branch_bank(pl_b, kern_t), iters=3))
        torch.cuda.empty_cache()
    bb_lib = time_ms(lambda: F.conv1d(pl_b.reshape(2 * B, 1, -1), wc_),
                     iters=3)
    torch.cuda.empty_cache()
    bbp2 = time_once(lambda: branch_bank_reference(pl_c, kern_t))[0]
    bb_ms, bb_plain = sum(bbk) / 2, (bbp1 + bbp2) / 2
    bb_bound = bound(pl_b.numel() * 4 + 2 * B * R_ * T * 4 + R_ * Lb_ * 4,
                     2 * 2 * B * R_ * T * Lb_)
    bb_cmp_bound = bound(pl_c.numel() * 4 + 2 * B * R_ * TR_CMP * 4,
                         2 * 2 * B * R_ * TR_CMP * Lb_)
    del pl_b, pl_c
    print(f"timing ({card}): branch_bank at the tracker's block (2 planes x "
          f"{B} x {T} steps, {R_} rows of {Lb_} taps, "
          f"{2 * B * R_ * T * 4 / 1e9:.2f} GB out): {bbk[0]:.4f}, "
          f"{bbk[1]:.4f} ms against F.conv1d {bb_lib:.4f} ms, bound "
          f"{bb_bound['bound_ms']:.4f} ms by {bb_bound['bound_by']} "
          f"({bb_bound['bound_ms'] / bb_ms:.1%}); plain version at "
          f"{TR_CMP} steps {bbp1:.2f}, {bbp2:.2f} ms", flush=True)
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
                  f"symtrack_stream step at {B}x{T} ("
                  f"{'fused' if fused else 'sequential'} route)")
    ctx = {"x2": x2, "idx2": idx2, "rot": rot, "st": st, "nch": nch,
           "ss_launches": ss_launches}
    return ctx, [{
        "name": "branch_bank", "route": "cuda",
        "source": "liquid_dsp_tpu_torch/csrc/branch_bank.cu",
        "replaces": None,
        "computes": "liquid_dsp_tpu/ops/symsync.py:153-166 "
                    "(lax.conv_general_dilated, outside any Pallas kernel)",
        "launches": bb_launches, "max_abs_err": max(bank_abs),
        "conv1d_max_rel_err": max(bank_rel.values()),
        "ms": bb_ms, "plain_ms": bb_plain, "library_ms": bb_lib,
        **bb_bound, "shape": [2, B, R_, T], "plain_steps": TR_CMP,
        "plain_bound_ms": bb_cmp_bound["bound_ms"]}, {
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


def fused_inputs(torch, st, c, x):
    """What `symsync_pll_lms` takes for the tracker `st` at carry `c` on the
    samples x [B, n]: (planes, bank, fstate, istate, PLL state)."""
    from liquid_dsp_tpu_torch.ops.symsync import branch_kernel, loop_state
    B = x.shape[0]
    y, _ = st.ag(c["agc"], x)
    xp = torch.cat([c["ss"]["win"][..., 1:], y], -1)
    planes = torch.stack([xp.real, xp.imag]).contiguous()
    fs, is_ = loop_state(c["ss"], B)
    return (planes, branch_kernel(st.ss.mf, st.ss.dmf, x.device), fs, is_,
            st.pll_state(c, B))


def fused_bound(out, planes, Lb, L):
    """Bound of one `symsync_pll_lms` call from its own output and input:
    the planes read once, 13 bytes written per slot (y, the decision, the
    mask), both states read and written; per active emit about 12 float32
    operations of the timing loop, 16 L of the equalizer's dot and update
    and 60 of the PLL and the slicers, and the 2P branch dots it reads (Lb
    multiply-adds each; the rows the kernel filters beyond those are its
    own choice, not the function's).  The branch rows and the slots pass
    through shared memory, so unlike branch_bank + symsync_scan + pll_lms
    they count once."""
    B, S = out.valid.shape
    P = planes.shape[0]
    active = int(out.valid.sum())
    return bound(planes.numel() * 4 + B * S * 13
                 + 2 * B * (8 * 4 + (4 * L + 4) * 4 + 8),
                 active * (12 + 16 * L + 60 + 2 * P * 2 * Lb))


def fused_phase(torch, dev, card, ctx):
    """Phase 41: symtrack's fused route on symsync_pll_lms, on phase 13's
    stream, against the sequential route; the kernel against its plain
    version and its window's misses; the two routes' times.  Returns the
    launches of the sequential route's kernels and the kernel's entry."""
    from unittest import mock
    from liquid_dsp_tpu_torch.framing.symtrack import symtrack_stream
    from liquid_dsp_tpu_torch.ops.kernels.agc_scan import agc_scan
    from liquid_dsp_tpu_torch.ops.kernels.branch_bank import branch_bank
    from liquid_dsp_tpu_torch.ops.kernels.pll_lms import pll_lms
    from liquid_dsp_tpu_torch.ops.kernels.symsync_pll_lms import (
        FILTER_WIN, symsync_pll_lms, symsync_pll_lms_reference)
    from liquid_dsp_tpu_torch.ops.kernels.symsync_scan import symsync_scan

    B, T, NB = TR_B, TR_T, TR_NBLK
    x2, st, nch = ctx["x2"], ctx["st"], ctx["nch"]

    def route(fused):
        return mock.patch.dict(os.environ, {
            "LIQUID_SYMTRACK_FUSED": "1" if fused else "0"})

    # both routes over phase 13's 3 carried blocks, counts from 0 each
    runs = {}
    for fused in (False, True):
        agc_scan.launches = symsync_scan.launches = pll_lms.launches = 0
        symsync_pll_lms.launches = branch_bank.launches = 0
        c = st.init(batch_shape=(B,), device=dev)
        outs, carries = [], [c]
        with route(fused):
            for b in range(NB):
                out, c = st(c, x2[:, b * T:(b + 1) * T])
                outs.append(out)
                carries.append(c)
        torch.cuda.synchronize()
        runs[fused] = (outs, carries, {
            "agc_scan": agc_scan.launches,
            "branch_bank": branch_bank.launches,
            "symsync_scan": symsync_scan.launches,
            "pll_lms": pll_lms.launches,
            "symsync_pll_lms": symsync_pll_lms.launches})
    (s_outs, s_cs, s_n), (f_outs, f_cs, f_n) = runs[False], runs[True]
    check(s_n == {"agc_scan": NB, "branch_bank": nch * NB,
                  "symsync_scan": nch * NB, "pll_lms": NB,
                  "symsync_pll_lms": 0}, f"sequential route launches {s_n}")
    check(f_n == {"agc_scan": NB, "branch_bank": 0, "symsync_scan": 0,
                  "pll_lms": 0, "symsync_pll_lms": NB},
          f"fused route launches {f_n}: want symsync_pll_lms once a block "
          f"({NB}) and no branch_bank, symsync_scan or pll_lms")
    sym_diff, bits = 0.0, True
    for b, ((ys, ds, vs), (yf, df, vf)) in enumerate(zip(s_outs, f_outs)):
        check(torch.equal(vs, vf), f"fused vs sequential, block {b}: valid "
              f"masks differ")
        check(torch.equal(ds, df), f"fused vs sequential, block {b}: "
              f"{int((ds != df).sum())} decisions differ")
        sym_diff = max(sym_diff, float((ys - yf).abs().max()))
        bits = bits and torch.equal(torch.view_as_real(ys),
                                    torch.view_as_real(yf))
    s_c, f_c = s_cs[-1], f_cs[-1]
    carry_diff = 0.0
    for key in ("theta", "dtheta", "eq_w", "eq_buf", "eq_x2"):
        carry_diff = max(carry_diff, float((s_c[key] - f_c[key]).abs().max()))
        bits = bits and torch.equal(s_c[key], f_c[key])
    check(torch.equal(s_c["eq_n"], f_c["eq_n"]) and all(
        torch.equal(v, f_c["ss"][k_]) for k_, v in s_c["ss"].items()) and all(
        torch.equal(v, f_c["agc"][k_]) for k_, v in s_c["agc"].items()),
        "fused vs sequential: the timing, AGC or eq_n carries differ")
    check(sym_diff <= TOL_STREAM and carry_diff <= TOL_STREAM,
          f"fused vs sequential: symbols {sym_diff:.3e}, carries "
          f"{carry_diff:.3e} (> {TOL_STREAM})")
    dec_all = torch.cat([d for _, d, _ in f_outs], -1).cpu().numpy()
    val_all = torch.cat([v for _, _, v in f_outs], -1).cpu().numpy()
    sers = [qpsk_ser(dec_all[ch][val_all[ch]], ctx["idx2"][ch], ctx["rot"],
                     TR_TAIL) for ch in range(B)]
    check(max(sers) <= MAX_SER, f"fused route SER {max(sers):.2e} (channel "
          f"{int(np.argmax(sers))}) > {MAX_SER}")
    same = "bit-equal" if bits else "not bit-equal"
    print(f"fused route: symtrack_stream at {B}x{T}, {NB} carried blocks "
          f"with LIQUID_SYMTRACK_FUSED=1 against =0: valid masks and "
          f"decisions equal, largest difference symbols {sym_diff:.3e}, "
          f"carries {carry_diff:.3e} ({same}); SER over the last {TR_TAIL} "
          f"symbols max {max(sers):.2e} (<= {MAX_SER}), "
          f"{sum(v > 0 for v in sers)} channels with any error; launches "
          f"fused {f_n}, sequential {s_n}", flush=True)
    del s_outs, f_outs

    # the kernel against its plain version on the same inputs and states,
    # its filter warp at the default window (FILTER_WIN rows a step, the
    # branches outside it filtered on the chain: misses, counted) and at
    # the full bank (npfb rows: none)
    kw = dict(npfb=32, max_out=3, k=2, k_out=1, bw=st.sync_bw, locked=False)
    win_d, full = FILTER_WIN or kw["npfb"], kw["npfb"]
    misses = {}

    def hold(name, trk, planes_, kern_, fs_, is__, pc_, p_=None):
        if p_ is None:
            p_ = symsync_pll_lms_reference(planes_, kern_, fs_, is__, pc_,
                                           trk.post, **kw)
        errs = []
        for win in (win_d, full):
            k_ = symsync_pll_lms(planes_, kern_, fs_, is__, pc_, trk.post,
                                 win=win, **kw)
            torch.cuda.synchronize()
            what = f"{name}, {win} rows a step"
            for f_ in ("valid", "fstate", "istate"):
                check(torch.equal(getattr(k_, f_), getattr(p_, f_)),
                      f"symsync_pll_lms, {what}: the timing loop's {f_} "
                      f"differs from the plain version")
            err = max(float((k_.y_re - p_.y_re).abs().max()),
                      float((k_.y_im - p_.y_im).abs().max()))
            check(err <= TOL_STREAM, f"symsync_pll_lms, {what}: {err:.3e} "
                  f"vs plain")
            check(torch.equal(k_.dec, p_.dec), f"symsync_pll_lms, {what}: "
                  f"{int((k_.dec != p_.dec).sum())} decisions differ")
            check(torch.equal(k_.pll_state["eq_n"], p_.pll_state["eq_n"]),
                  f"symsync_pll_lms, {what}: eq_n differs")
            for key in p_.pll_state:
                d = float((k_.pll_state[key].float()
                           - p_.pll_state[key].float()).abs().max())
                check(d <= TOL_STREAM, f"symsync_pll_lms, {what}: state "
                      f"{key} {d:.3e}")
            # (the plain version counts none: a CPU rehearsal)
            misses.setdefault(name, []).append(
                0 if k_.misses is None else int(k_.misses.sum()))
            errs.append(err)
        return k_, max(errs)

    c2 = s_cs[2]
    planes, kern, fs, is_, pc = fused_inputs(torch, st, c2,
                                             x2[:, 2 * T:2 * T + TR_CMP])
    fup1, out_p = time_once(lambda: symsync_pll_lms_reference(
        planes, kern, fs, is_, pc, st.post, **kw))
    out_k, fu_err = hold(f"{B} x {TR_CMP} steps", st, planes, kern, fs, is_,
                         pc, out_p)
    del out_p
    fu_bound = fused_bound(out_k, planes, kern.shape[1], st.L)
    Lb = kern.shape[1]
    stress = {f"{B} x {TR_CMP} steps": fu_err}
    stress[f"ragged chunk ({TR_STRESS} steps)"] = hold(
        "ragged chunk", st, planes[..., :TR_STRESS + Lb - 1].contiguous(),
        kern, fs, is_, pc)[1]
    stress["from the zero state"] = hold(
        "from the zero state", st,
        *fused_inputs(torch, st, s_cs[0], x2[:, :TR_CMP]))[1]
    st32 = symtrack_stream(ms="qpsk", eq_len=32).to(dev)
    c32 = st32.init(batch_shape=(B,), device=dev)
    with route(False):
        _, c32 = st32(c32, x2[:, :TR_WARM])
    stress["L=32"] = hold("L=32", st32, *fused_inputs(
        torch, st32, c32, x2[:, TR_WARM:TR_WARM + TR_CMP]))[1]
    x16, _ = make_timing_stream(np.random.default_rng(16), B,
                                TR_WARM + TR_CMP, 7, 30.0, False, ms="qam16")
    x16 = torch.from_numpy(x16).to(dev)
    st16 = symtrack_stream(ms="qam16").to(dev)
    c16 = st16.init(batch_shape=(B,), device=dev)
    with route(False):
        _, c16 = st16(c16, x16[:, :TR_WARM])
    stress["argmin slicer (qam16)"] = hold("argmin slicer (qam16)", st16,
                                           *fused_inputs(
        torch, st16, c16, x16[:, TR_WARM:]))[1]
    del x16, out_k
    check(all(v_[1] == 0 for v_ in misses.values()),
          f"symsync_pll_lms: misses at the full bank {misses}")
    print(f"symsync_pll_lms vs plain, {B} channels, the filter warp at "
          f"{win_d} and {full} rows a step: the timing loop's mask and "
          f"state bit-equal, decisions and eq_n equal, max|err| of y and "
          f"state at most: " + "; ".join(
              f"{k_} {v_:.3e}" for k_, v_ in stress.items())
          + f" (<= {TOL_STREAM}); branches filtered on the chain (misses, "
          f"all channels) at {win_d} / {full} rows: " + "; ".join(
              f"{k_} {v_[0]} / {v_[1]}" for k_, v_ in misses.items()),
          flush=True)

    # times: plain, kernel, kernel, plain at the comparison shape; the
    # kernel against branch_bank + symsync_scan + pll_lms on one 4096-step
    # chunk; a whole block in the route's one launch at both windows
    fuk1 = time_ms(lambda: symsync_pll_lms(planes, kern, fs, is_, pc,
                                           st.post, **kw), iters=5)
    fuk2 = time_ms(lambda: symsync_pll_lms(planes, kern, fs, is_, pc,
                                           st.post, **kw), iters=5)
    fup2 = time_once(lambda: symsync_pll_lms_reference(
        planes, kern, fs, is_, pc, st.post, **kw))[0]
    fu_ms, fu_plain = (fuk1 + fuk2) / 2, (fup1 + fup2) / 2
    del planes
    pl_c, kern_c, fs_c, is_c, pc_c = fused_inputs(
        torch, st, c2, x2[:, 2 * T:2 * T + T // nch])

    def seq_chunk():
        sr_, si_, sv_, _, _ = symsync_scan(branch_bank(pl_c, kern_c), fs_c,
                                           is_c, **kw)
        return pll_lms(sr_, si_, sv_, pc_c, st.tab_re, st.tab_im,
                       **st.pll_kwargs())

    def fused_chunk():
        return symsync_pll_lms(pl_c, kern_c, fs_c, is_c, pc_c, st.post, **kw)

    sq1 = time_ms(seq_chunk, iters=5)
    fc1 = time_ms(fused_chunk, iters=5)
    fc2 = time_ms(fused_chunk, iters=5)
    sq2 = time_ms(seq_chunk, iters=5)
    bb_alone = time_ms(lambda: branch_bank(pl_c, kern_c), iters=5)
    ma_c = branch_bank(pl_c, kern_c)
    ss_alone = time_ms(lambda: symsync_scan(ma_c, fs_c, is_c, **kw), iters=5)
    sr_c, si_c, sv_c, _, _ = symsync_scan(ma_c, fs_c, is_c, **kw)
    pl_alone = time_ms(lambda: pll_lms(sr_c, si_c, sv_c, pc_c, st.tab_re,
                                       st.tab_im, **st.pll_kwargs()), iters=5)
    chunk_bound = fused_bound(fused_chunk(), pl_c, kern_c.shape[1], st.L)
    fc_ms = (fc1 + fc2) / 2
    del ma_c, sr_c, si_c, sv_c, pl_c
    pl_b, kern_b, fs_b, is_b, pc_b = fused_inputs(torch, st, c2,
                                                  x2[:, 2 * T:])
    block_ms = {}
    for win in (win_d, full, full, win_d):
        block_ms.setdefault(win, []).append(time_ms(
            lambda: symsync_pll_lms(pl_b, kern_b, fs_b, is_b, pc_b, st.post,
                                    win=win, **kw), iters=3))
    block_bound = fused_bound(symsync_pll_lms(pl_b, kern_b, fs_b, is_b,
                                              pc_b, st.post, **kw), pl_b,
                              kern_b.shape[1], st.L)
    del pl_b
    print(f"timing ({card}): symsync_pll_lms {fu_ms:.4f} ms (runs "
          f"{fuk1:.4f}, {fuk2:.4f}) vs plain {fu_plain:.2f} ms (runs "
          f"{fup1:.2f}, {fup2:.2f}) at {B} x {TR_CMP} steps; per "
          f"{T // nch}-step chunk {fc_ms:.4f} ms (runs {fc1:.4f}, {fc2:.4f})"
          f" against branch_bank + symsync_scan + pll_lms "
          f"{(sq1 + sq2) / 2:.4f} ms (runs {sq1:.4f}, {sq2:.4f}; alone "
          f"{bb_alone:.4f}, {ss_alone:.4f} and {pl_alone:.4f}); a whole "
          f"{B} x {T} block, the route's one launch, by rows a step: "
          + "; ".join(f"{w_} rows {', '.join(f'{t_:.4f}' for t_ in v_)} ms"
                      for w_, v_ in block_ms.items())
          + f"; bound {fu_bound['bound_ms']:.5f} / "
          f"{chunk_bound['bound_ms']:.5f} / {block_bound['bound_ms']:.5f} "
          f"ms by {block_bound['bound_by']}", flush=True)

    # the two routes' block steps at 32768 samples by channels (the
    # crossover the card's rule rests on): sequential, fused, fused,
    # sequential at each B
    steps = {}
    for Bc in TR_CROSS:
        xb = x2[:Bc, 2 * T:].contiguous()
        cb = st.init(batch_shape=(Bc,), device=dev)
        ts = []
        for fused in (False, True, True, False):
            with route(fused):
                ts.append(time_ms(lambda: st(cb, xb), iters=3))
        steps[Bc] = ((ts[0] + ts[3]) / 2, (ts[1] + ts[2]) / 2, ts)
    print(f"timing ({card}): symtrack_stream step at {T} samples, "
          f"sequential / fused ms (runs s, f, f, s): " + "; ".join(
              f"B={Bc} {sq:.4f} / {fu:.4f} ({', '.join(f'{t:.4f}' for t in ts)})"
              for Bc, (sq, fu, ts) in steps.items()) + " ; fused wins at B = "
          + ", ".join(str(Bc) for Bc, (sq, fu, _) in steps.items() if fu < sq),
          flush=True)

    # where each route's step's device time goes
    for fused in (True, False):
        with route(fused):
            profile_steps(torch, card, lambda: st(c2, x2[:, 2 * T:]), 3,
                          f"symtrack_stream step at {B}x{T}, "
                          f"{'fused' if fused else 'sequential'} route")
    return s_n, {
        "name": "symsync_pll_lms", "route": "cuda",
        "source": "liquid_dsp_tpu_torch/csrc/symsync_pll_lms.cu",
        "replaces": None,
        "recurrence": "liquid_dsp_tpu/ops/symsync.py:187-206 with "
                      "liquid_dsp_tpu/framing/symtrack.py:218-267,284-296 "
                      "(lax.scan: the loop of pallas_symsync.py:132 with "
                      "the post step)",
        "launches": f_n["symsync_pll_lms"], "max_abs_err": max(
            stress.values()),
        "ms": fu_ms, "plain_ms": fu_plain, "library_ms": None, **fu_bound,
        "steps": TR_CMP, "full_chunk_ms": fc_ms,
        "full_chunk_bound_ms": chunk_bound["bound_ms"],
        "sequential_chunk_ms": (sq1 + sq2) / 2,
        "block_ms_by_rows": {str(w_): v_ for w_, v_ in block_ms.items()},
        "block_bound_ms": block_bound["bound_ms"],
        "misses_by_rows": {k_: dict(zip((str(win_d), str(full)), v_))
                           for k_, v_ in misses.items()},
        "tracker_step_ms": {str(Bc): {"sequential": sq, "fused": fu}
                            for Bc, (sq, fu, _) in steps.items()},
        "fused_vs_sequential_max_diff": max(sym_diff, carry_diff)}


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


@contextlib.contextmanager
def recorded_folds():
    """Records every suppression fold the receivers run inside the block:
    [(last_end, cand, pos, span, P, out)], the inputs cloned before the
    call, `out` the wrapper's return (keep, or (keep, sel, n_cand) where
    the caller asked for the ranking of the first P kept segments).  The
    recorder stands in for `suppress_scan` in the two modules that call
    it and calls the wrapper itself, so the kernel runs (and counts its
    launch) as on the path."""
    from liquid_dsp_tpu_torch.framing import stream_rx
    from liquid_dsp_tpu_torch.multichannel import ofdm
    from liquid_dsp_tpu_torch.ops.kernels.suppress_scan import suppress_scan
    calls = []

    def record(last_end, cand, pos, span, P=None):
        args = (last_end.clone(), cand.clone(), pos.clone(), span, P)
        out = suppress_scan(last_end, cand, pos, span, P=P)
        calls.append(args + (out,))
        return out

    mods = (stream_rx, ofdm)
    for m in mods:
        m.suppress_scan = record
    try:
        yield calls
    finally:
        for m in mods:
            m.suppress_scan = suppress_scan


def hold_folds(torch, step, what):
    """Runs `step()` with its folds recorded and holds each keep mask of
    the kernel, and where the caller asked for it the ranking (sel,
    n_cand), against the plain version on the same inputs, bit for bit.
    Returns (the folds as recorded, the max |keep - plain| (0))."""
    from liquid_dsp_tpu_torch.ops.kernels.suppress_scan import (
        rank_reference, suppress_scan_reference)
    with recorded_folds() as calls:
        step()
    torch.cuda.synchronize()
    check(calls, f"suppress_scan: {what} ran no fold")
    cells = kept = cands = ranked = 0
    for le, cand, pos, span, P, out in calls:
        keep = out if P is None else out[0]
        want = suppress_scan_reference(le, cand, pos, span)
        check(torch.equal(keep, want), f"suppress_scan on {what}: "
              f"{int((keep != want).sum())} of {keep.numel()} keep bits "
              f"differ from the plain version")
        if P is not None:
            sel, n_cand = rank_reference(want, P)
            check(torch.equal(out[1], sel) and torch.equal(out[2], n_cand),
                  f"suppress_scan on {what}: the ranking of the first {P} "
                  f"kept segments differs from the plain version "
                  f"({int((out[1] != sel).sum())} slots, "
                  f"{int((out[2] != n_cand).sum())} counts)")
            ranked += 1
        cells += keep.numel()
        kept += int(keep.sum())
        cands += int(cand.sum())
    print(f"suppress_scan: kernel = plain on {what}: {len(calls)} fold(s) "
          f"over {cells} segments ({tuple(calls[0][1].shape)} a fold), "
          f"{kept} of {cands} candidates kept; {ranked} fold(s) with the "
          f"ranking of the first P (P = {calls[0][4]}), sel and n_cand "
          f"equal", flush=True)
    return calls, 0.0


def fold_entry(torch, card, args, what):
    """suppress_scan's kernel entry from one fold's inputs `args` (last_end,
    cand, pos, span, P): the kernel's device time a launch (torch.profiler
    over 50 launches: the wrapper's host work is longer than the kernel),
    the wrapper's time a call (CUDA events over 100 calls), the plain
    version's (plain, kernel, kernel, plain) and the bound."""
    from liquid_dsp_tpu_torch.ops.kernels.suppress_scan import (
        rank_reference, suppress_scan, suppress_scan_reference)
    le, cand, pos, span, P = args

    def kernel():
        return suppress_scan(le, cand, pos, span, P=P)

    def plain():
        keep = suppress_scan_reference(le, cand, pos, span)
        return keep if P is None else rank_reference(keep, P)

    p1 = time_ms(plain, iters=5)
    w1 = time_ms(kernel, iters=100)
    w2 = time_ms(kernel, iters=100)
    p2 = time_ms(plain, iters=5)
    by, _ = device_profile(torch, kernel, 50, "suppress_scan")
    dk = [(t, c) for k, (t, c) in by.items() if "suppress_scan" in k]
    check(dk and dk[0][1] == 50, f"suppress_scan: the profiler saw {dk}")
    ms = dk[0][0] / 50
    B, S = cand.shape
    # the watermarks, candidates and positions in once, the mask out once,
    # the ranking's slots and counts out once; a compare, a select and an
    # add a segment
    b = bound(le.numel() * le.element_size() + B * S
              + B * S * pos.element_size() + B * S
              + (0 if P is None else 8 * B * (P + 1)), 3 * B * S)
    print(f"timing ({card}): suppress_scan at {what}'s fold ({B} rows x {S} "
          f"segments, {pos.dtype}, ranking the first {P}): kernel "
          f"{ms * 1e3:.2f} us a launch (device time, 50 launches), the "
          f"wrapper {w1:.4f}, {w2:.4f} ms a call; plain version {p1:.3f}, "
          f"{p2:.3f} ms ({S} steps of a compare and a select, then a cumsum "
          f"and a scatter); bound {b['bound_ms'] * 1e3:.4f} us by "
          f"{b['bound_by']}", flush=True)
    return {"name": "suppress_scan", "route": "cuda",
            "source": "liquid_dsp_tpu_torch/csrc/suppress_scan.cu",
            "replaces": "liquid_dsp_tpu/framing/stream_rx.py:323",
            "recurrence": "lax.scan of the greedy suppression fold "
                          "(liquid_dsp_tpu/framing/stream_rx.py:311-324, "
                          "multichannel/ofdm.py:497-502, parallel/rx.py:"
                          "127-135) and the jnp.nonzero ranking after it",
            "launches": 0, "max_abs_err": 0.0, "ms": ms,
            "wrapper_ms": (w1 + w2) / 2, "plain_ms": (p1 + p2) / 2,
            "library_ms": None, **b}


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
    codebook_argmax's launches on its run, its max error, and
    suppress_scan's launches."""
    from liquid_dsp_tpu_torch.framing.frame64 import framesync64_stream_full
    from liquid_dsp_tpu_torch.multichannel import (firpfbch2_analyzer,
                                                   firpfbch2_synthesizer)
    from liquid_dsp_tpu_torch.ops.kernels.codebook_argmax import (
        codebook_argmax)
    from liquid_dsp_tpu_torch.ops.kernels.suppress_scan import suppress_scan

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
    suppress_scan.launches = 0
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
    ss_launches = suppress_scan.launches
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
    check(ss_launches == SC_NBLK + 1, f"suppress_scan launched "
          f"{ss_launches} times in {SC_NBLK + 1} scanner blocks")
    print(f"scanner: firpfbch2_synthesizer({SC_M}) made {SC_S} wideband "
          f"streams of {SC_NBLK} blocks + 1 flush x {Tw} samples on the card "
          f"(frame64 on the even channels, noise 0.002, a tone on channel "
          f"{SC_TONE}); firpfbch2_analyzer({SC_M}) -> "
          f"framesync64_stream_full({SC_T}) over {SC_S * SC_M} channel "
          f"streams, carried: {n_ok} of {n_frames} frames decoded once on "
          f"their own channel, in order, crc_ok, bytes equal, sample_index "
          f"within 2 of the start + {SC_DELAY} (the bank's delay); 0 on the "
          f"odd channels; codebook_argmax launches {launches}, "
          f"suppress_scan launches {ss_launches}; capture made "
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
    hold_folds(torch, lambda: rx(cr1, st1), "the scanner's block 1")
    return launches, err, ss_launches


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
    points.  Returns codebook_argmax's launches on the receiver's run, its
    max error, and suppress_scan's launches."""
    from liquid_dsp_tpu_torch.framing.flexframe import (
        FLEXFRAME_H_USER, FlexFrameSync, flexframe_rx_stream, flexframesync)
    from liquid_dsp_tpu_torch.ops.kernels.codebook_argmax import (
        codebook_argmax)
    from liquid_dsp_tpu_torch.ops.kernels.suppress_scan import suppress_scan

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
    suppress_scan.launches = 0
    t0 = time.perf_counter()
    for b in range(FF_NBLK + 1):
        carries.append(carry)
        out, carry = proc(carry, x[:, b * FF_T:(b + 1) * FF_T])
        outs.append(out)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = codebook_argmax.launches
    ss_launches = suppress_scan.launches
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
    check(ss_launches == FF_NBLK + 1, f"suppress_scan launched "
          f"{ss_launches} times in {FF_NBLK + 1} flexframe blocks")
    print(f"flexframe: flexframe_rx_stream({FF_T}, {FF_PL}) crc32/none/"
          f"golay2412/qpsk at {FF_B}x{FF_T}, {FF_NBLK} carried blocks + 1 "
          f"flush, {FF_MAX} slots: {n_ok} of {n_frames} frames decoded once, "
          f"in order, hdr_ok and pay_ok, header and payload bytes equal, "
          f"sample_index within 2 (incl. the reference C frame ffg_a and the "
          f"CFO 0.002 / 20 dB channel); the qam16 frame hdr_ok False; "
          f"{FF_QUIET} noise-only channels: 0 frames; codebook_argmax "
          f"launches {launches}, suppress_scan launches {ss_launches}; "
          f"stream made in {t_gen:.1f} s, first pass {t_run:.2f} s",
          flush=True)

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
    hold_folds(torch, lambda: proc(c1, x1), "flexframe_rx_stream block 1")
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
    return launches, err, ss_launches


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
    # do not fit shared memory, all-zero metrics (every early step a
    # tie); several warps a scheduler (VT_WIDE codewords) and T = 46, not
    # a multiple of the warp form's 32-step tile or its 8-step runs
    cases = [("v27", VT_N, VT_DEC, 0.8), ("v29", VT_N, VT_DEC, 1.0),
             ("v39", VT_N, VT_DEC, 1.0), ("v27", VT_N, VT_DEC, 0.0),
             ("v29", VT_N, VT_DEC, 0.0), ("v27p23", 128, VT_DEC, 0.8),
             ("v27p78", 128, VT_DEC, 0.5), ("v29p34", 128, VT_DEC, 0.8),
             ("v29p78", 128, VT_DEC, 0.5), ("v27", 1, 1, 1.0),
             ("v29", 37, 1, 1.0), ("v29", 8, 2000, 1.0),
             ("v27", 64, VT_DEC, None), ("v29", 64, VT_DEC, None),
             ("v27", VT_WIDE, VT_DEC, 0.8), ("v29", VT_WIDE, VT_DEC, 1.0),
             ("v39", VT_WIDE, VT_DEC, 0.0), ("v27", 16, 5, 0.8)]
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
    # the block form (ns of 32, 512, 1024: no decoder's trellis) on
    # random +-1 tables
    for ns, r, N, T in ((32, 2, 64, 300), (512, 2, 64, 300),
                        (1024, 3, 8, 200), (512, 3, 4, 900)):
        fn, obs = vt_synthetic(torch, dev, ns, r, N, T, ns + T)
        err = max(err, hold_viterbi(torch, fn, obs, f"ns={ns} r={r} "
                                    f"{N}x{T} steps")[1])
        held.append(f"ns={ns} r={r} {N}x{T} steps")
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
    # lone codeword at two lengths, each long enough that the card and not
    # the wrapper's host work sets the launch's time
    one = {}
    for d in VT_ONE:
        f1, o1, _ = viterbi_case(torch, dev, "v27", 1, d, 0.8, 8)
        one[d] = (o1.shape[1], time_ms(lambda: viterbi_acs(
            o1, f1.exp, f1.nout), iters=VT_ITERS))
    (ta, ma), (tb, mb) = one[VT_ONE[0]], one[VT_ONE[1]]
    step_us = (mb - ma) / (tb - ta) * 1e3
    floor_ms = obs.shape[1] * step_us / 1e3
    mhz = sm_mhz()
    # the traceback's share: the same launch with nothing to write skips it
    k0 = time_ms(lambda: viterbi_acs(obs, exp, 0), iters=VT_ITERS)
    print(f"timing ({card}): viterbi_acs v27 {VT_N}x{VT_DEC} bytes (T = "
          f"{obs.shape[1]}) {ms:.4f} ms = {VT_N * nout / ms:.1f} kbit/s "
          f"decoded (runs {k1:.4f}, {k2:.4f}; {VT_ITERS} launches each); "
          f"plain version {plain_ms:.2f} ms (runs {p1:.2f}, {p2:.2f}); bound "
          f"{vb['bound_ms']:.5f} ms by {vb['bound_by']}; one step's latency "
          f"{step_us:.4f} us (one codeword at T = {ta} and {tb}: "
          f"{ma:.4f}, {mb:.4f} ms) = "
          f"{step_us * mhz:.0f} cycles at the card's {mhz:.0f} MHz, so the "
          f"chain's floor is {floor_ms:.4f} ms; without the traceback "
          f"(nout = 0) {k0:.4f} ms, so the traceback is "
          f"{100 * (1 - k0 / ms):.1f}% of the kernel; the block form "
          f"before, measured the same way (PERF.md's kernel table, H100 "
          f"80GB HBM3 at 700.00 W): 0.1701-0.1718 ms, 574-578 cycles a "
          f"step on a lone codeword", flush=True)
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
            "chain_floor_ms": floor_ms, "step_latency_us": step_us,
            "step_cycles": step_us * mhz, "traceback_share": 1 - k0 / ms}


def vt_synthetic(torch, dev, ns, r, N, T, seed):
    """(a stand-in decoder with exp [ns, 2, r] random +-1 and nout = T - 8,
    metrics [N, T, r] normal on the card) for the trellis sizes no
    decoder launches."""
    rng = np.random.default_rng(seed)
    fn = types.SimpleNamespace(
        exp=torch.from_numpy(rng.choice(np.float32([-1, 1]), (ns, 2, r))
                             ).to(dev), nout=T - 8)
    return fn, torch.from_numpy(
        rng.standard_normal((N, T, r)).astype(np.float32)).to(dev)


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
    run, suppress_scan's, the receiver, a carry and block for the hold and
    the times)."""
    from liquid_dsp_tpu_torch.framing.gmskframe import (GMSKFRAME_H_USER,
                                                        gmskframe_rx_stream)
    from liquid_dsp_tpu_torch.ops.kernels.codebook_argmax import (
        codebook_argmax)
    from liquid_dsp_tpu_torch.ops.kernels.suppress_scan import suppress_scan
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
    suppress_scan.launches = 0
    t0 = time.perf_counter()
    for b in range(GM_NBLK + 1):
        carries.append(carry)
        out, carry = proc(carry, x[:, b * GM_T:(b + 1) * GM_T])
        outs.append(out)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = counter.launches
    ss_launches = suppress_scan.launches
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
    check(ss_launches == GM_NBLK + 1, f"gmsk {tag}: suppress_scan "
          f"launched {ss_launches} times in {GM_NBLK + 1} blocks")
    print(f"gmsk: gmskframe_rx_stream({GM_T}, {GM_PL}) crc32/{tag} at "
          f"{GM_B}x{GM_T}, {GM_NBLK} carried blocks + 1 flush: {n_ok} of "
          f"{n_frames} frames decoded once, in order, hdr_ok and pay_ok, "
          f"header and payload bytes equal, sample_index within 2 (incl. "
          f"{len(GM_CFO)} channels at CFO 0.0015 rad/sample); the foreign "
          f"frame hdr_ok False; {GM_QUIET} noise-only channels: 0 frames; "
          f"{counter.__name__} launches {launches}, suppress_scan launches "
          f"{ss_launches}; the frames modulated "
          f"in one call on the card (= gmskframegen within 1e-4), stream "
          f"made in {t_gen:.1f} s, first pass {t_run:.2f} s", flush=True)
    c1, x1 = carries[1], x[:, GM_T:2 * GM_T]
    del outs, carries, x
    hold_folds(torch, lambda: proc(c1, x1), f"gmskframe_rx_stream ({tag}) "
               f"block 1")
    return launches, ss_launches, proc, c1, x1


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
    to its plain version on the path's own soft metrics, and
    suppress_scan on each run's detections.  Returns (codebook_argmax
    launches, its max error, viterbi_acs launches, its max error,
    suppress_scan's launches on the golay2412 run)."""
    # 25. golay2412: the JAX tool's configuration
    cb_launches, ss_launches, proc, c1, x1 = gmsk_run(
        torch, dev, card, {"fec1": "golay2412"}, "none/golay2412")
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
    vt_launches, _, proc, c1, x1 = gmsk_run(
        torch, dev, card, {"fec0": "v27", "fec1": "none"}, "v27/none")
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
    return cb_launches, cb_err, vt_launches, float(vt_err), ss_launches


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
    codebook_argmax's launches on its run, its max index difference
    against the plain version on the path's soft bits, and suppress_scan's
    launches."""
    from liquid_dsp_tpu_torch.framing.ofdmflex_stream import (
        ofdmflex_rx_stream)
    from liquid_dsp_tpu_torch.ops.kernels.codebook_argmax import (
        codebook_argmax)
    from liquid_dsp_tpu_torch.ops.kernels.suppress_scan import suppress_scan
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
    suppress_scan.launches = 0
    t0 = time.perf_counter()
    for b in range(OF_NBLK + 1):
        carries.append(carry)
        out, carry = proc(carry, x[:, b * OF_T:(b + 1) * OF_T])
        outs.append(out)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = codebook_argmax.launches
    ss_launches = suppress_scan.launches
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
    check(ss_launches == OF_NBLK + 1, f"suppress_scan launched "
          f"{ss_launches} times in {OF_NBLK + 1} OFDM blocks")
    print(f"ofdm: ofdmflex_rx_stream({OF_T}, {OF_PL}) crc32/none/golay2412/"
          f"qpsk, M=64 cp=16, {OF_MAX} slots, at {OF_B}x{OF_T}, {OF_NBLK} "
          f"carried blocks + 1 flush: {n_ok} of {n_frames} frames decoded "
          f"once, in order, hdr_ok and pay_ok, header and payload bytes "
          f"equal, the S1 start within 2 and the coarse sample_index on the "
          f"S0 plateau (incl. {len(OF_CFO)} channels at CFO 0.002 "
          f"rad/sample, {straddle} frames across a block boundary); the "
          f"qam16 frame hdr_ok False; {OF_QUIET} noise-only channels: 0 "
          f"frames; codebook_argmax launches {launches}, suppress_scan "
          f"launches {ss_launches}; the frames "
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
    hold_folds(torch, lambda: proc(c1, x1), "ofdmflex_rx_stream block 1")
    del x, outs, carries, data, cws
    torch.cuda.empty_cache()
    return launches, max(errs), ss_launches


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


def multirate_paths():
    """(rx, tx): functions that make the two multi-rate paths (phases
    31-32) through the public API.  rx: the mixer, a 64-tap Kaiser FIR and a 48-tap
    decimator by 4, fused to one 111-tap FIR and kernel_fuse'd into
    mix_fir_decim at down = 4, then msresamp(0.375): a halfband decimator,
    its zeta and resamp(3/4).  tx: a 29-tap root-raised-cosine pulse
    shaper interpolating by 2, msresamp(2.5): resamp(5/4) and a halfband
    interpolator, then the up-mix."""
    from liquid_dsp_tpu_torch import chain, fuse, kernel_fuse
    from liquid_dsp_tpu_torch.design.firdes import (firdes_kaiser,
                                                    firdes_rrcos)
    from liquid_dsp_tpu_torch.ops.fir import firdecim, firfilt, firinterp
    from liquid_dsp_tpu_torch.ops.nco import nco
    from liquid_dsp_tpu_torch.ops.resample import msresamp

    def rx():
        front = kernel_fuse(fuse(chain(
            nco(dphi=DPHI, direction="down"),
            firfilt(firdes_kaiser(64, 0.2, 60.0)),
            firdecim(4, firdes_kaiser(48, 0.1, 60.0)))))
        return chain(front, msresamp(0.375))

    def tx():
        return chain(firinterp(2, firdes_rrcos(2, 7, 0.35)), msresamp(2.5),
                     nco(dphi=DPHI, direction="up"))

    return rx, tx


def tone_peak(y, main_lobe):
    """tests/test_resample.py's spectral check on a Kaiser-windowed 1-D
    stream: (peak frequency in cycles/sample, largest sidelobe in dB
    below the peak outside +-main_lobe)."""
    from liquid_dsp_tpu_torch.design.windows import kaiser
    y = np.asarray(y) * kaiser(len(y), 10.0)
    nfft = 1 << int(np.ceil(np.log2(len(y))))
    mag = np.abs(np.fft.fftshift(np.fft.fft(y, nfft)))
    f = np.arange(nfft) / nfft - 0.5
    k = int(np.argmax(mag))
    db = 20 * np.log10(mag / mag[k] + 1e-12)
    return float(f[k]), float(db[np.abs(f - f[k]) > main_lobe].max())


def run_blocks(proc, carry, blocks):
    """Stream blocks through proc; (outputs, carry)."""
    outs = []
    for x in blocks:
        y, carry = proc(carry, x)
        outs.append(y)
    return outs, carry


def card_vs_cpu(torch, dev, make, blocks, what):
    """max|err| and max|err|/rms of `make()` on the card against the same
    Proc on the CPU over carried blocks (host tensors); the card's output
    must stay on the card."""
    p, q = make().to(dev), make()
    B = blocks[0].shape[0]
    yk, _ = run_blocks(p, p.init(batch_shape=(B,), device=dev),
                       [x.to(dev) for x in blocks])
    check(all(y.device.type == dev.type for y in yk),
          f"{what}: output left the card")
    yc, _ = run_blocks(q, q.init(batch_shape=(B,)), blocks)
    yk = torch.cat(yk, dim=-1).cpu().to(torch.complex128)
    yc = torch.cat(yc, dim=-1).to(torch.complex128)
    check(yk.shape == yc.shape, f"{what}: {tuple(yk.shape)} on the card, "
          f"{tuple(yc.shape)} on the CPU")
    err = float((yk - yc).abs().max())
    return err, err / float(yc.abs().square().mean().sqrt())


def multirate_rx_phase(torch, dev, card):
    """Phase 31: the multi-rate receive path at 64 channels.  Returns
    (mix_fir_decim's launches on the path's run, its max|err| against
    the plain version on the path's own inputs)."""
    from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
    from liquid_dsp_tpu_torch.ops.kernels.mix_fir_decim import (
        mix_fir_decim, mix_fir_decim_reference)
    make_rx, _ = multirate_paths()
    path = make_rx().to(dev)
    front = path.stages[0]
    check(type(front).__name__ == "MixFIRDecim" and front.down == 4
          and front.taps.numel() == 111 and path.rate == (3, 32),
          f"multirate_rx: kernel_fuse gave {type(front).__name__} "
          f"down {getattr(front, 'down', '?')}, rate {path.rate}")
    gen = torch.Generator(device=dev).manual_seed(31)
    xs = [torch.randn(MR_B, MR_T, dtype=torch.complex64, generator=gen,
                      device=dev) for _ in range(NBLK)]
    blocks = xs + [xs[k][:, :Tb] for k, Tb in enumerate(MR_MIXED)]
    seen = []
    hook = front.register_forward_hook(
        lambda mod, args, out: seen.append((args[0], args[1], out[0])))
    carry0 = path.init(batch_shape=(MR_B,), device=dev)
    mix_fir_decim.launches = 0
    outs, _ = run_blocks(path, carry0, blocks)
    torch.cuda.synchronize()
    launches = mix_fir_decim.launches
    hook.remove()
    for k, (x, y) in enumerate(zip(blocks, outs)):
        want = (MR_B, x.shape[-1] * 3 // 32)
        check(tuple(y.shape) == want and y.dtype == torch.complex64
              and y.device.type == dev.type, f"multirate_rx block {k}: "
              f"{tuple(y.shape)} {y.dtype} on {y.device}, want {want}")
        check(bool(torch.isfinite(torch.view_as_real(y)).all()),
              f"multirate_rx block {k}: non-finite output")
    check(launches == len(blocks), f"multirate_rx: {launches} "
          f"mix_fir_decim launches for {len(blocks)} blocks")

    # the kernel against its plain version on the path's own inputs
    max_abs, worst = 0.0, 0.0
    for c, x, yk in seen:
        ref = mix_fir_decim_reference(
            x.real.contiguous(), x.imag.contiguous(), c["tr"], c["ti"],
            c["theta"], front.ramp_c, front.ramp_s, front.taps, down=4,
            sgn=front.sgn, dphi=front.dphi, out_dtype=torch.float32)
        err, rel = complex_err((yk.real, yk.imag), ref)
        max_abs, worst = max(max_abs, err), max(worst, rel)
    check(worst < TOL_F32, f"multirate_rx: mix_fir_decim vs plain "
          f"{worst:.3e}")
    # the front against float64 numpy: mix, the unfused filters, decimate
    n = np.arange(4 * N_CHECK)
    z = xs[0][:2, :4 * N_CHECK].cpu().numpy().astype(np.complex128) \
        * np.exp(-1j * DPHI * n)
    for h in (firdes_kaiser(64, 0.2, 60.0), firdes_kaiser(48, 0.1, 60.0)):
        h = h.astype(np.float32).astype(np.float64)
        z = np.stack([np.convolve(r, h)[:len(n)] for r in z])
    z = z[:, ::4]
    got = seen[0][2][:2, :N_CHECK].cpu().numpy().astype(np.complex128)
    rel64 = float(np.abs(got - z).max() / np.sqrt(np.mean(np.abs(z) ** 2)))
    check(rel64 < TOL_F32, f"multirate_rx front vs float64: {rel64:.3e}")
    del seen
    # the whole path on 8 channels against the port on the CPU (the class
    # convolutions and the kernel's plain version)
    cmp_abs, cmp_rel = card_vs_cpu(
        torch, dev, make_rx, [x[:MR_CMP[0], :MR_CMP[1]].cpu()
                              for x in xs], "multirate_rx")
    check(cmp_rel < TOL_F32, f"multirate_rx card vs CPU: {cmp_rel:.3e}")
    # a tone MR_TONE cycles/sample above the mixer lands at MR_TONE*32/3
    t = np.arange(4 * MR_CMP[1])
    tone = np.exp(1j * (DPHI + 2 * np.pi * MR_TONE) * t).astype(np.complex64)
    xt = torch.from_numpy(np.repeat(tone[None], 8, 0)).to(dev)
    p8 = make_rx().to(dev)
    yt, _ = run_blocks(p8, p8.init(batch_shape=(8,), device=dev),
                       list(xt.split(MR_CMP[1], dim=-1)))
    fpk, side = tone_peak(torch.cat(yt, -1)[0, 64:].cpu().numpy(), 0.07)
    check(abs(fpk - MR_TONE * 32 / 3) < 0.02 and side < -40,
          f"multirate_rx tone: peak {fpk:.4f} (want {MR_TONE * 32 / 3:.4f}),"
          f" sidelobes {side:.1f} dB")
    print(f"multirate_rx: chain(kernel_fuse(fuse(nco, firfilt64, "
          f"firdecim(4, 48))), msresamp(0.375)) on {MR_B} channels, blocks "
          f"{'/'.join(str(x.shape[-1]) for x in blocks)} carried, "
          f"{MR_T * 3 // 32} outputs per full block; mix_fir_decim "
          f"launches {launches} for {len(blocks)} blocks (111 taps, down 4); "
          f"kernel vs plain on the path's inputs max|err| {max_abs:.3e}, "
          f"max|err|/rms {worst:.3e}; front vs float64 numpy (2 ch x "
          f"{N_CHECK}) {rel64:.3e}; card vs CPU ({MR_CMP[0]}x{MR_CMP[1]} x "
          f"{NBLK} blocks) {cmp_rel:.3e} (< {TOL_F32}); tone at "
          f"{fpk:.4f} cycles/sample (want {MR_TONE * 32 / 3:.4f} +- 0.02), "
          f"sidelobes {side:.1f} dB (< -40)", flush=True)

    # times: the step, the kernel alone at down 4 against its plain version
    c0, x0 = carry0, xs[0]
    xr, xi = x0.real.contiguous(), x0.imag.contiguous()

    def kern():
        return mix_fir_decim(xr, xi, c0[0]["tr"], c0[0]["ti"],
                             c0[0]["theta"], front.ramp_c, front.ramp_s,
                             front.taps, down=4, sgn=front.sgn,
                             dphi=front.dphi)

    def plain():
        return mix_fir_decim_reference(
            xr, xi, c0[0]["tr"], c0[0]["ti"], c0[0]["theta"], front.ramp_c,
            front.ramp_s, front.taps, down=4, sgn=front.sgn, dphi=front.dphi)

    p1 = time_ms(plain)
    k1 = time_ms(kern, iters=100)
    k2 = time_ms(kern, iters=100)
    p2 = time_ms(plain)
    step = time_ms(lambda: path(c0, x0))
    bd = bound(2 * MR_B * MR_T * 4 + 2 * MR_B * (MR_T // 4) * 4,
               MR_B * (MR_T // 4) * 111 * 2 * 2 + MR_B * MR_T * 6)
    ms = (k1 + k2) / 2
    print(f"timing ({card}): multirate_rx step {step:.4f} ms per "
          f"{MR_B}x{MR_T} block = {MR_B * MR_T / step / 1e3:.1f} Msamples/s "
          f"in; mix_fir_decim at down 4, 111 taps: {k1:.4f}, {k2:.4f} ms "
          f"(100 launches each) = {MR_B * MR_T / ms / 1e3:.1f} Msamples/s, "
          f"{bd['bound_ms'] / ms:.1%} of its bound {bd['bound_ms']:.4f} ms "
          f"({bd['bound_by']}); plain version {p1:.4f}, {p2:.4f} ms",
          flush=True)
    profile_steps(torch, card, lambda: path(c0, x0), 3, "multirate_rx step")
    del xs, blocks, outs
    return launches, max_abs


def multirate_tx_phase(torch, dev, card):
    """Phase 32: the multi-rate transmit path at 64 channels."""
    _, make_tx = multirate_paths()
    path = make_tx().to(dev)
    gen = torch.Generator(device=dev).manual_seed(32)

    def qpsk(B, n):
        b = torch.randint(0, 2, (2, B, n), generator=gen, device=dev)
        return torch.complex(2.0 * b[0] - 1, 2.0 * b[1] - 1) / np.sqrt(2)

    xs = [qpsk(TX_B, TX_T) for _ in range(NBLK)]
    c0 = path.init(batch_shape=(TX_B,), device=dev)
    outs, _ = run_blocks(path, c0, xs)
    torch.cuda.synchronize()
    for k, y in enumerate(outs):
        check(tuple(y.shape) == (TX_B, TX_OUT) and y.device.type == dev.type
              and bool(torch.isfinite(torch.view_as_real(y)).all()),
              f"multirate_tx block {k}: {tuple(y.shape)} on {y.device}, "
              f"want ({TX_B}, {TX_OUT}) finite")
    cmp_abs, _ = card_vs_cpu(torch, dev, make_tx,
                             [x[:MR_CMP[0]].cpu() for x in xs],
                             "multirate_tx")
    check(cmp_abs < TOL_TX, f"multirate_tx card vs CPU: {cmp_abs:.3e}")
    # a tone of TX_TONE cycles/symbol lands at TX_TONE/5 + the up-mix
    k = np.arange(4 * 4096)
    tone = np.exp(2j * np.pi * TX_TONE * k).astype(np.complex64)
    xt = torch.from_numpy(np.repeat(tone[None], 8, 0)).to(dev)
    p8 = make_tx().to(dev)
    yt, _ = run_blocks(p8, p8.init(batch_shape=(8,), device=dev),
                       list(xt.split(4096, dim=-1)))
    want = TX_TONE / 5 + DPHI / (2 * np.pi)
    fpk, side = tone_peak(torch.cat(yt, -1)[0, 400:].cpu().numpy(), 0.07)
    check(abs(fpk - want) < 0.02 and side < -40,
          f"multirate_tx tone: peak {fpk:.4f} (want {want:.4f}), sidelobes "
          f"{side:.1f} dB")
    step = time_ms(lambda: path(c0, xs[0]))
    print(f"multirate_tx: chain(firinterp(2, rrcos(2, 7, 0.35)), "
          f"msresamp(2.5), nco up) on {TX_B} channels x {TX_T} QPSK symbols "
          f"per block, {NBLK} blocks carried, {TX_OUT} samples out per "
          f"block; card vs CPU ({MR_CMP[0]} channels) max|err| "
          f"{cmp_abs:.3e} (< {TOL_TX}); tone at {fpk:.4f} cycles/sample "
          f"(want {want:.4f} +- 0.02), sidelobes {side:.1f} dB (< -40)",
          flush=True)
    print(f"timing ({card}): multirate_tx step {step:.4f} ms per "
          f"{TX_B}x{TX_T} symbols = {TX_B * TX_T / step / 1e3:.1f} "
          f"Msymbols/s in, {TX_B * TX_OUT / step / 1e3:.1f} Msamples/s out",
          flush=True)
    profile_steps(torch, card, lambda: path(c0, xs[0]), 3,
                  "multirate_tx step")


def p33_procs():
    """Phase 33's Procs: name -> (maker, real input, channels, block)."""
    from liquid_dsp_tpu_torch import chain
    from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
    from liquid_dsp_tpu_torch.ops.fir import firdecim, firhilb, firinterp
    from liquid_dsp_tpu_torch.ops.resample import (
        msresamp2, resamp, resamp2_analyzer, resamp2_interp,
        resamp2_synthesizer)
    h48 = firdes_kaiser(48, 0.1, 60.0)
    full = (P33_B, P33_T)
    return {
        "firdecim4": (lambda: firdecim(4, h48), False, full),
        "firinterp4": (lambda: firinterp(4, h48), False, full),
        "resamp_3_2": (lambda: resamp((3, 2)), False, full),
        "resamp_2_3": (lambda: resamp((2, 3)), False,
                       (P33_B, 3 * P33_T // 2)),
        "firhilb_decim": (lambda: firhilb(5), True, full),
        "resamp2_interp": (lambda: resamp2_interp(7), False, full),
        "msresamp2_interp2": (lambda: msresamp2("interp", 2), False, full),
        "qmf_loopback": (lambda: chain(resamp2_analyzer(7),
                                       resamp2_synthesizer(7)), False, full),
        "resamp_127_100": (lambda: resamp((127, 100)), False, P33_GATHER)}


def golden_npz(stem):
    """tests/golden/<stem>.npz with the stem's prefix cut from the keys."""
    d = np.load(os.path.join(ROOT, "tests", "golden", stem + ".npz"))
    return {k[len(stem) + 1:] if k.startswith(stem + "_") else k: d[k]
            for k in d.files}


def p33_phase(torch, dev, card):
    """Phase 33: the new Procs alone on the card, against the CPU and the
    reference goldens, and their rates."""
    from liquid_dsp_tpu_torch.ops.fir import firdecim
    from liquid_dsp_tpu_torch.ops.resample import (
        msresamp2, resamp, resamp2_analyzer, resamp2_decim, resamp2_interp,
        resamp2_synthesizer)
    gen = torch.Generator(device=dev).manual_seed(33)
    held, rates = [], []
    for name, (make, real, (B, Tn)) in p33_procs().items():
        x = (torch.randn(B, Tn, generator=gen, device=dev) if real else
             torch.randn(B, Tn, dtype=torch.complex64, generator=gen,
                         device=dev))
        _, rel = card_vs_cpu(torch, dev, make, [x[:P33_CPU].cpu()], name)
        check(rel < TOL_PROC, f"{name} card vs CPU: {rel:.3e}")
        p = make().to(dev)
        c0 = p.init(batch_shape=(B,), device=dev)
        ms = time_ms(lambda: p(c0, x))
        by_name, _ = device_profile(torch, lambda: p(c0, x), CH_PROF, name)
        d_ms = sum(t for t, _ in by_name.values()) / CH_PROF
        n_ops = sum(c for _, c in by_name.values()) / CH_PROF
        held.append(f"{name} {rel:.2e}")
        rates.append(f"{name} ({B}x{Tn}) {ms:.4f} ms = "
                     f"{B * Tn / ms / 1e3:.1f}, device {d_ms:.4f} ms in "
                     f"{n_ops:.0f} operations")
    # the QMF pair returns a band-limited input after its delay 4m - 1
    m, n = 7, 4096
    d, i = 4 * m - 1, np.arange(n)
    a, s = resamp2_analyzer(m).to(dev), resamp2_synthesizer(m).to(dev)
    loop = 0.0
    for f, sign in ((0.04, 1.0), (0.44, -1.0)):
        x = torch.from_numpy(np.exp(2j * np.pi * f * i).astype(
            np.complex64)[None].repeat(4, 0)).to(dev)
        z = s(s.init(batch_shape=(4,), device=dev),
              a(a.init(batch_shape=(4,), device=dev), x)[0])[0]
        k0, k1 = d + 4 * m, n - 4 * m
        loop = max(loop, float((z[:, k0:k1] - sign * x[:, k0 - d:k1 - d])
                               .abs().max()))
    check(loop < TOL_LOOP, f"QMF loopback: {loop:.3e}")
    print(f"new Procs on the card vs their CPU runs ({P33_CPU} channels, "
          f"max|err|/rms < {TOL_PROC}): " + "; ".join(held) + f"; QMF "
          f"loopback after its delay {d}: {loop:.2e} (< {TOL_LOOP})",
          flush=True)
    print(f"timing ({card}): new Procs, ms per block (CUDA events over 20 "
          f"calls) and Msamples/s in; device ms per call (torch.profiler "
          f"over {CH_PROF} calls): " + "; ".join(rates), flush=True)

    # the reference C library's goldens on the card
    fg = dict(np.load(os.path.join(ROOT, "tests", "golden",
                                   "flexframe_golden.npz")))

    def on_card(p, x):
        p = p.to(dev)
        x = torch.from_numpy(np.asarray(x)).to(dev)
        y = p(p.init(dtype=x.dtype, device=dev), x)[0]
        check(y.device.type == dev.type, f"{p.name}: output left the card")
        return y.cpu().numpy()

    gold = {
        "resamp_23": (on_card(resamp((2, 3), 7, 0.25, 60.0, 64),
                              fg["resamp_23_x"]), fg["resamp_23_y"]),
        "resamp_54": (on_card(resamp((5, 4), 7, 0.25, 60.0, 64),
                              fg["resamp_54_x"]), fg["resamp_54_y"]),
        "r2_decim": (on_card(resamp2_decim(7, 0.0, 60.0), fg["r2_x"]),
                     fg["r2_decim"]),
        "r2_interp": (on_card(resamp2_interp(7, 0.0, 60.0), fg["r2_x"]),
                      fg["r2_interp"]),
        "qmf_lo_hi": (on_card(resamp2_analyzer(5, 60.0), fg["qmf_x"]),
                      np.stack([fg["qmf_lo"], fg["qmf_hi"]])),
        "qmf_z": (on_card(resamp2_synthesizer(5, 60.0),
                          np.stack([fg["qmf_lo"], fg["qmf_hi"]])),
                  fg["qmf_z"]),
        "ms2_d": (on_card(msresamp2("decim", 2, 0.4, 0.0, 60.0),
                          fg["ms2_x"]), fg["ms2_d"]),
        "ms2_i": (on_card(msresamp2("interp", 2, 0.4, 0.0, 60.0),
                          fg["ms2_x"]), fg["ms2_i"])}
    worst = 0.0
    for name, (y, ref) in gold.items():
        check(y.shape == ref.shape, f"golden {name}: {y.shape} vs "
              f"{ref.shape}")
        e = float(np.abs(y - ref).max())
        check(e < TOL_R2, f"golden {name} on the card: {e:.3e}")
        worst = max(worst, e)
    worst_d = 0.0
    stems = sorted(f[:-4] for f in os.listdir(os.path.join(
        ROOT, "tests", "golden")) if f.startswith("firdecim_"))
    check(len(stems) == 12, f"{len(stems)} firdecim goldens, want 12")
    for stem in stems:
        g = golden_npz(stem)
        y = on_card(firdecim(int(stem.split("_M")[1][0]), g["h"]), g["x"])
        check(y.shape == g["y"].shape, f"{stem}: {y.shape}")
        e = float(np.abs(y - g["y"]).max())
        check(e <= TOL_DECIM, f"{stem} on the card: {e:.3e}")
        worst_d = max(worst_d, e)
    print(f"goldens on the card: resamp_23, resamp_54, r2_decim, r2_interp, "
          f"qmf analyzer and synthesizer, ms2_d, ms2_i max|err| {worst:.3e} "
          f"(< {TOL_R2}); the 12 firdecim goldens max|err| {worst_d:.3e} "
          f"(<= {TOL_DECIM})", flush=True)


def analog_paths():
    """(tx, rx): functions that make the two analog paths (phases 34-35)
    through the public API.  tx: a real message FM-modulated at kf = 0.1,
    then the channel: 4 complex multipath taps, shadowing (1 dB, Doppler
    0.001), a carrier offset of 0.001 rad/sample and AWGN at 30 dB.  rx:
    an order-7 Butterworth lowpass at 0.2 in second-order sections, the FM
    demodulator, iirdecim(4) (its default order-4 Butterworth at 0.125)
    and a DC blocker at alpha 0.01."""
    from liquid_dsp_tpu_torch import chain
    from liquid_dsp_tpu_torch.design.iirdes import iirdes_sos
    from liquid_dsp_tpu_torch.modem.analog import (freq_demodulator,
                                                   freq_modulator)
    from liquid_dsp_tpu_torch.ops.channel import channel
    from liquid_dsp_tpu_torch.ops.iir import iirfilt_dc_blocker, iirfilt_sos
    from liquid_dsp_tpu_torch.ops.misc_filters import iirdecim

    def tx():
        return chain(freq_modulator(AN_KF), channel(
            snr_db=30.0, dphi=0.001, multipath_taps=np.asarray(AN_TAPS),
            shadowing_std=1.0, shadowing_fd=0.001))

    def rx():
        return chain(iirfilt_sos(*iirdes_sos("butter", 7, 0.2)),
                     freq_demodulator(AN_KF), iirdecim(4),
                     iirfilt_dc_blocker(0.01))

    return tx, rx


def an_message(torch, dev, B, t0, n):
    """freqmodem_example's two tones, 0.013 and 0.037 cycles/sample at
    0.6 and 0.3, scaled per channel from 0.5 to 1: [B, n] float32 from
    sample t0 on."""
    t = torch.arange(t0, t0 + n, dtype=torch.float64, device=dev)
    scale = 0.5 + 0.5 * torch.arange(B, dtype=torch.float64, device=dev
                                     )[:, None] / max(B - 1, 1)
    return (scale * (0.6 * torch.cos(2 * np.pi * 0.013 * t)
                     + 0.3 * torch.cos(2 * np.pi * 0.037 * t))).float()


class Recorder:
    """Wraps a kernel wrapper where a module looks it up, recording each
    call's arguments and results (the path's own inputs)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn, self.calls = getattr(module, name), []

    def __enter__(self):
        def rec(*args):
            out = self.fn(*args)
            self.calls.append((args, out))
            return out
        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def bits_equal(torch, a, b):
    """Equal bit for bit (float or complex), as a bool."""
    return bool(torch.equal(torch.view_as_real(a) if a.is_complex() else a,
                            torch.view_as_real(b) if b.is_complex() else b))


def sm_mhz():
    """The card's maximum SM clock in MHz (nvidia-smi)."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()[0])


def lone_row_step_us(fn, lengths):
    """(us per step, {length: ms}) of fn(n), a launch on one row of n
    steps, at two lengths: the slope, each launch long enough that the
    card and not the host sets its time."""
    ms = {n: time_ms(lambda: fn(n), iters=20) for n in lengths}
    a, b = lengths
    return (ms[b] - ms[a]) / (b - a) * 1e3, ms


def analog_tx_reference(msg, s, h, kf, sh_std, dphi):
    """analog_tx without its signal gain and AWGN, in float64 numpy on
    rows msg [b, n] (the message, float32) with the shadowing process's
    outputs s [b, n]: the FM modulator's 16-bit phase and 1024-entry table
    (as freqmod.c), the multipath h, the gain 10^(sh_std*s/20), the
    carrier offset dphi rad/sample; zero initial state."""
    from scipy.signal import lfilter
    x = msg.astype(np.float32) * np.float32(kf * (1 << 16))
    steps = np.trunc(x + np.sign(x) * np.float32(0.5)).astype(np.int64)
    idx = (((np.cumsum(steps, axis=-1) & 0xFFFF) + 0x20) >> 6) & 0x3FF
    z = lfilter(np.asarray(h, np.complex128), [1.0],
                np.exp(2j * np.pi * idx / 1024.0), axis=-1)
    z = z * 10.0 ** (sh_std * s.astype(np.float64) / 20.0)
    return z * np.exp(1j * dphi * np.arange(msg.shape[-1]))


def analog_tx_phase(torch, dev, card):
    """Phase 34: the FM transmit path at AN_B x AN_T.  Returns (the
    blocks it made, the iir_scan kernel's entry)."""
    import liquid_dsp_tpu_torch.ops.channel as chmod
    from liquid_dsp_tpu_torch.ops.kernels.iir_block_state import (
        iir_block_state)
    from liquid_dsp_tpu_torch.ops.kernels.iir_scan import (
        iir_scan, iir_scan_reference)
    make_tx, _ = analog_paths()
    path = make_tx().to(dev)
    msgs = [an_message(torch, dev, AN_B, k * AN_T, AN_T)
            for k in range(NBLK)]
    c0 = path.init(batch_shape=(AN_B,), device=dev)
    iir_scan.launches = iir_block_state.launches = 0
    with Recorder(chmod, "iir_scan") as rec:
        outs, _ = run_blocks(path, c0, msgs)
        torch.cuda.synchronize()
    launches = iir_scan.launches
    check(launches == NBLK and iir_block_state.launches == 0,
          f"analog_tx: {launches} iir_scan, {iir_block_state.launches} "
          f"iir_block_state launches for {NBLK} blocks")
    check(len(rec.calls) == NBLK, f"analog_tx: {len(rec.calls)} shadowing "
          f"calls recorded")
    for k, y in enumerate(outs):
        check(tuple(y.shape) == (AN_B, AN_T) and y.dtype == torch.complex64
              and y.device.type == dev.type
              and bool(torch.isfinite(torch.view_as_real(y)).all()),
              f"analog_tx block {k}: {tuple(y.shape)} {y.dtype} on "
              f"{y.device}, want ({AN_B}, {AN_T}) complex64 finite")
    # the kernel against its plain version on the path's own inputs: the
    # first AN_CMP samples of each block from its carry, the last AN_CMP
    # from the state the kernel reaches before them
    max_abs, equal = 0.0, True
    for (x, b, a, st), (y, st2) in rec.calls:
        yh, sh = iir_scan_reference(x[:, :AN_CMP], b, a, st)
        _, smid = iir_scan(x[:, :-AN_CMP].contiguous(), b, a, st)
        yt, stt = iir_scan_reference(x[:, -AN_CMP:], b, a, smid)
        for got, want in ((y[:, :AN_CMP], yh), (y[:, -AN_CMP:], yt),
                          (st2, stt)):
            equal &= bits_equal(torch, got, want)
            max_abs = max(max_abs, float((got - want).abs().max()))
    check(equal, f"analog_tx: iir_scan vs plain max|err| {max_abs:.3e} "
          f"(the same roundings: bit-equal)")
    # the shadowing process (the filter's outputs): unit variance, mean 0
    sh = torch.cat([out[0] for _, out in rec.calls], dim=-1)
    sh_std, sh_mean = float(sh.std()), float(sh.mean())
    check(abs(sh_std - 1) < AN_SHSTD and abs(sh_mean) < AN_SHSTD,
          f"analog_tx: shadowing process std {sh_std:.4f}, mean "
          f"{sh_mean:.4f}, want 1 and 0 within {AN_SHSTD}")
    # the deterministic impairments at the path's size: channels
    # 0..AN_CHECK-1 rebuilt in float64 from the message and the recorded
    # shadowing; what the card adds beyond gamma times that is the AWGN
    ch = path.stages[1]
    y64 = torch.cat(outs, dim=-1)[:AN_CHECK].cpu().numpy().astype(
        np.complex128)
    m64 = torch.cat(msgs, dim=-1)[:AN_CHECK].cpu().numpy()
    s64 = sh[:AN_CHECK].cpu().numpy()
    npow = ch.nstd ** 2
    pw = {}
    for what, sstd in (("rebuild", ch.shadowing_std), ("unshadowed", 0.0)):
        ref = analog_tx_reference(m64, s64, AN_TAPS, AN_KF, sstd, ch.dphi)
        pw[what] = float(np.mean(np.abs(y64 - ch.gamma * ref) ** 2)) / npow
    check(abs(pw["rebuild"] - 1) < AN_TXPOW and pw["unshadowed"] > 1 +
          AN_TXPOW, f"analog_tx vs its float64 rebuild: residual power "
          f"{pw['rebuild']:.5f} of the AWGN's (want 1 within {AN_TXPOW}); "
          f"without the shadowing {pw['unshadowed']:.5f} (want above "
          f"{1 + AN_TXPOW})")
    del y64, m64, s64, ref
    print(f"analog_tx: chain(freq_modulator({AN_KF}), channel(snr 30 dB, "
          f"dphi 0.001, {len(AN_TAPS)} multipath taps, shadowing 1 dB at "
          f"fd 0.001)) on {AN_B} channels x {AN_T} samples, {NBLK} blocks "
          f"carried; iir_scan launches {launches} (the shadowing, one a "
          f"block), bit-equal to its plain version on the path's own noise "
          f"({2 * NBLK} windows of {AN_CMP} samples and the carries); "
          f"shadowing process std {sh_std:.4f}, mean {sh_mean:.4f} (unit "
          f"variance, 1/(1-beta) ~ 159 samples a correlation time; limit "
          f"{AN_SHSTD}); channels 0-{AN_CHECK - 1} less gamma times their "
          f"float64 rebuild (FM table, multipath, shadowing gain, CFO): "
          f"{pw['rebuild']:.5f} of the AWGN's power nstd^2 = {npow:.1e} "
          f"(limit 1 +- {AN_TXPOW}); the rebuild without the shadowing "
          f"reads {pw['unshadowed']:.5f}", flush=True)
    del rec, sh
    # the size repairs: a cascade of more second-order sections than one
    # launch takes runs as split launches, a section of more coefficients
    # than the registers hold on the wide form, each bit-equal to the plain
    # version (AN_CMP steps from a random state), and timed at AN_B x
    # AN_IIR_T; a section above MAX_WIDE_N is refused on the card only
    from liquid_dsp_tpu_torch.ops.kernels.iir_scan import (MAX_WIDE_N,
                                                           launch_groups)
    gen = torch.Generator(device=dev).manual_seed(35)
    ns_, n_ = AN_SPLIT, AN_WIDE + 1
    b_w = torch.randn(1, n_, generator=gen, device=dev) * 0.1
    a_w = torch.zeros(1, n_, device=dev)
    a_w[0, 0], a_w[0, -1] = 1.0, -0.5
    repairs = {
        f"{ns_} second-order sections": (
            torch.tensor([[0.2, 0.4, 0.2]] * ns_, device=dev),
            torch.tensor([[1.0, -0.5, 0.2]] * ns_, device=dev),
            torch.float32),
        f"order {AN_WIDE} ({n_} coefficients), complex": (
            b_w.to(torch.complex64), a_w.to(torch.complex64),
            torch.complex64)}
    rep_ms, rep_txt = {}, []
    for what, (b_, a_, dt_) in repairs.items():
        x_ = torch.randn(AN_B, AN_CMP, generator=gen, device=dev).to(dt_)
        s_ = (torch.randn(AN_B, *b_.shape[:1], b_.shape[1] - 1,
                          generator=gen, device=dev) * 0.1).to(dt_)
        n0 = iir_scan.launches
        y_, s2_ = iir_scan(x_, b_, a_, s_)
        nl = iir_scan.launches - n0
        yr_, sr_ = iir_scan_reference(x_, b_, a_, s_)
        torch.cuda.synchronize()
        want_nl = len(launch_groups(*b_.shape))
        check(bits_equal(torch, y_, yr_) and bits_equal(torch, s2_, sr_)
              and nl == want_nl, f"iir_scan, {what}: {nl} launches (want "
              f"{want_nl}), max|err| {float((y_ - yr_).abs().max()):.3e} "
              f"against the plain version (want bit-equal)")
        xl = torch.randn(AN_B, AN_IIR_T, generator=gen, device=dev).to(dt_)
        rep_ms[what] = [time_ms(lambda: iir_scan(xl, b_, a_, s_), iters=5)
                        for _ in range(2)]
        rep_txt.append(f"{what}: {nl} launches, bit-equal over {AN_B} x "
                       f"{AN_CMP}; {rep_ms[what][0]:.4f}, "
                       f"{rep_ms[what][1]:.4f} ms at {AN_B} x {AN_IIR_T}")
    refused = False
    try:
        iir_scan(x_[:, :8], torch.ones(1, MAX_WIDE_N + 1, device=dev),
                 torch.ones(1, MAX_WIDE_N + 1, device=dev),
                 torch.zeros(AN_B, 1, MAX_WIDE_N, device=dev))
    except ValueError:
        refused = True
    check(refused, f"iir_scan took a section of {MAX_WIDE_N + 1} "
          f"coefficients on the card")
    print(f"iir_scan size repairs ({card}): " + "; ".join(rep_txt)
          + f"; a section of {MAX_WIDE_N + 1} coefficients refused on the "
          f"card (ValueError)", flush=True)
    # times: the step, the kernel alone at the path's shape
    gen = torch.Generator(device=dev).manual_seed(34)
    w = torch.randn(AN_B, AN_T, generator=gen, device=dev)
    sh_b, sh_a = path.stages[1].sh_b, path.stages[1].sh_a
    st0 = torch.zeros(AN_B, 1, 1, device=dev)
    wc = w[:, :AN_CMP].contiguous()
    p1 = time_once(lambda: iir_scan_reference(wc, sh_b, sh_a, st0))[0]
    k1 = time_ms(lambda: iir_scan(w, sh_b, sh_a, st0), iters=100)
    k2 = time_ms(lambda: iir_scan(w, sh_b, sh_a, st0), iters=100)
    p2 = time_once(lambda: iir_scan_reference(wc, sh_b, sh_a, st0))[0]
    step = time_ms(lambda: path(c0, msgs[0]))
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    # x in, y out once; per sample 3 products, a difference, a sum
    bd = bound(2 * AN_B * AN_T * 4, 5 * AN_B * AN_T)
    # a lone row at two lengths: the time one row's loop takes per sample
    step_us, one = lone_row_step_us(lambda n: iir_scan(
        w[:1, :n].contiguous(), sh_b, sh_a, st0[:1]), (AN_T // 4, AN_T))
    lone_ms = AN_T * step_us / 1e3
    mhz = sm_mhz()
    print(f"timing ({card}): analog_tx step {step:.4f} ms per {AN_B}x{AN_T} "
          f"block = {AN_B * AN_T / step / 1e3:.1f} Msamples/s; iir_scan at "
          f"the shadowing's shape ({AN_B} rows x {AN_T}, one pole): {k1:.4f}"
          f", {k2:.4f} ms (100 launches each) = "
          f"{AN_B * AN_T / ms / 1e3:.1f} Msamples/s, bound "
          f"{bd['bound_ms']:.5f} ms by {bd['bound_by']} "
          f"({bd['bound_ms'] / ms:.1%}); a lone row at "
          + ", ".join(f"{n} steps {t:.4f} ms" for n, t in one.items())
          + f" (20 launches each): {step_us * 1e3:.2f} ns a step "
          f"(= {step_us * mhz:.0f} cycles at the card's maximum SM clock, "
          f"{mhz:.0f} MHz), {lone_ms:.4f} ms at {AN_T} steps, so the "
          f"{AN_B}-row launch takes {ms / lone_ms:.3f} of one row's loop; "
          f"the chain's arithmetic alone (the one-pole step's 12.44 "
          f"cycles, chip_kernel_bench.py --latency) would be "
          f"{AN_T * 12.44 / mhz / 1e3:.4f} ms; plain version at {AN_CMP} "
          f"steps {p1:.2f}, {p2:.2f} ms", flush=True)
    profile_steps(torch, card, lambda: path(c0, msgs[0]), 3,
                  "analog_tx step")
    entry = {
        "name": "iir_scan", "route": "cuda",
        "source": "liquid_dsp_tpu_torch/csrc/iir_scan.cu", "replaces": None,
        "recurrence": "liquid_dsp_tpu/ops/iir.py:37-78 and "
                      "liquid_dsp_tpu/ops/channel.py:65-75 (lax.scan)",
        "launches": launches, "max_abs_err": max_abs, "ms": ms,
        "plain_ms": plain_ms, "library_ms": None, **bd,
        "plain_steps": AN_CMP, "step_latency_us": step_us,
        "lone_row_ms": lone_ms, "size_repairs_ms": rep_ms}
    del msgs, w
    return outs, entry


def tone_fit(y, freqs, settle):
    """Per row of y [B, n] (numpy), the least-squares amplitudes of cosines
    at `freqs` (cycles/sample) past `settle` samples, and the rms of what
    is left."""
    n = np.arange(settle, y.shape[1])
    M = np.stack([f(2 * np.pi * fr * n) for fr in freqs
                  for f in (np.cos, np.sin)], axis=1)
    c, *_ = np.linalg.lstsq(M, y[:, settle:].T.astype(np.float64),
                            rcond=None)
    amp = np.hypot(c[0::2], c[1::2]).T
    res = y[:, settle:] - (M @ c).T
    return amp, np.sqrt(np.mean(res ** 2, axis=1))


def analog_rx_reference(x, B7, A7, B4, A4, alpha):
    """analog_rx in float64 with scipy and numpy on rows x [b, n]
    (complex): the same coefficients, zero initial state."""
    from scipy.signal import lfilter, sosfilt
    sos = np.concatenate([B7, A7], axis=1).astype(np.float64)
    z = sosfilt(sos, x.astype(np.complex128), axis=-1)
    prev = np.concatenate([np.zeros((len(z), 1)), z[:, :-1]], axis=1)
    m = np.angle(np.conj(prev) * z) / (2 * np.pi * AN_KF)
    d = sosfilt(np.concatenate([B4, A4], axis=1).astype(np.float64), m,
                axis=-1)[:, ::4]
    a1 = float(np.float32(-1.0 + alpha))
    return lfilter([1.0, -1.0], [1.0, a1], d, axis=-1)


def analog_rx_phase(torch, dev, card, xs):
    """Phase 35: the FM receive path on analog_tx's blocks, the scan and
    block backends on the card, the iir_block_state kernel.  Returns its
    kernel entry."""
    import liquid_dsp_tpu_torch.ops.iir as iirmod
    from liquid_dsp_tpu_torch.ops.kernels.iir_block_state import (
        iir_block_state, iir_block_state_reference)
    from liquid_dsp_tpu_torch.ops.kernels.iir_scan import iir_scan
    _, make_rx = analog_paths()
    path = make_rx().to(dev)
    filters = [path.stages[0], path.stages[2].filt, path.stages[3]]
    check(all(f.uses_block(xs[0]) for f in filters),
          "analog_rx: a filter does not take the block form on the card")
    c0 = path.init(batch_shape=(AN_B,), device=dev)
    iir_scan.launches = iir_block_state.launches = 0
    with Recorder(iirmod, "iir_block_state") as rec:
        outs, _ = run_blocks(path, c0, xs)
        torch.cuda.synchronize()
    launches = iir_block_state.launches
    check(launches == 3 * NBLK and iir_scan.launches == 0,
          f"analog_rx: {launches} iir_block_state, {iir_scan.launches} "
          f"iir_scan launches for {NBLK} blocks of 3 filters")
    for k, y in enumerate(outs):
        check(tuple(y.shape) == (AN_B, AN_T // 4) and y.dtype == torch.float32
              and y.device.type == dev.type and bool(torch.isfinite(y).all()),
              f"analog_rx block {k}: {tuple(y.shape)} {y.dtype} on "
              f"{y.device}, want ({AN_B}, {AN_T // 4}) float32 finite")
    # the kernel against its plain version on the path's own inputs: the
    # three filters' calls of the last block
    max_abs = 0.0
    for (w, m, s), (s_pre, s2) in rec.calls[-3:]:
        pre_ref, s_ref = iir_block_state_reference(w, m, s)
        for got, want in ((s_pre, pre_ref), (s2, s_ref)):
            max_abs = max(max_abs, float((got - want).abs().max()))
            check(bits_equal(torch, got, want), "analog_rx: iir_block_state "
                  f"vs plain at p = {m.shape[0]}: not bit-equal, max|err| "
                  f"{max_abs:.3e}")
    shapes = [tuple(w.shape) for (w, _, _), _ in rec.calls[-3:]]
    del rec
    y = torch.cat(outs, dim=-1).cpu().numpy()
    # an independent float64 reference on channels 0..AN_CHECK-1
    x64 = torch.cat(xs, dim=-1)[:AN_CHECK].cpu().numpy()
    f7, f4 = filters[0], filters[1]
    ref = analog_rx_reference(x64, f7.B.cpu().numpy(), f7.A.cpu().numpy(),
                              f4.B.cpu().numpy(), f4.A.cpu().numpy(), 0.01)
    rel64 = float(np.abs(y[:AN_CHECK] - ref).max()
                  / np.sqrt(np.mean(ref ** 2)))
    check(rel64 < TOL_AN64, f"analog_rx vs float64 scipy: {rel64:.3e}")
    # the message comes back: both tones at their amplitudes, and a
    # residual at the AWGN's level
    scale = 0.5 + 0.5 * np.arange(AN_B) / max(AN_B - 1, 1)
    amp, res = tone_fit(y, (4 * 0.013, 4 * 0.037), AN_SETTLE)
    amp_err = float(np.abs(amp / np.stack([0.6 * scale, 0.3 * scale], 1)
                           - 1).max())
    check(amp_err < AN_AMP and float(res.max()) < AN_RES,
          f"analog_rx message: tone amplitudes within {amp_err:.4f} "
          f"(< {AN_AMP}), residual rms up to {float(res.max()):.4f} "
          f"(< {AN_RES})")
    print(f"analog_rx: chain(iirfilt_sos(butter 7, 0.2), "
          f"freq_demodulator({AN_KF}), iirdecim(4), iirfilt_dc_blocker(0.01))"
          f" on {AN_B} channels x {AN_T} samples in, {AN_T // 4} out per "
          f"block, {NBLK} blocks carried; iir_block_state launches "
          f"{launches} (3 filters a block; w {shapes}), bit-equal to its "
          f"plain version on the last block's own inputs; channels "
          f"0-{AN_CHECK - 1} vs float64 scipy sosfilt/lfilter on the same "
          f"input: max|err|/rms {rel64:.3e} (< {TOL_AN64}); the message "
          f"past {AN_SETTLE} output samples: tone amplitudes within "
          f"{amp_err:.4f} of those sent (< {AN_AMP}), residual rms "
          f"{float(res.min()):.4f}-{float(res.max()):.4f} (< {AN_RES})",
          flush=True)

    # scan and block on the card, AN_BACKENDS channels x samples
    from liquid_dsp_tpu_torch.design.iirdes import iirdes_sos
    from liquid_dsp_tpu_torch.ops.iir import (
        iirfilt, iirfilt_differentiator, iirfilt_integrator, iirfilt_sos)
    cccf = golden_npz("iirfilt_cccf_data_h7x64")
    # butter 16: 16 states, above the 8 the block form took before each
    # state had a lane of its own
    sos = {"sos_butter7": iirdes_sos("butter", 7, 0.2),
           "sos_butter16": iirdes_sos("butter", 16, 0.2),
           **{f.name[8:]: (f.B.numpy(), f.A.numpy()) for f in (
               iirfilt_integrator(), iirfilt_differentiator())}}
    cases = {name: (lambda be, B=B, A=A: iirfilt_sos(B, A, backend=be))
             for name, (B, A) in sos.items()}
    cases["cccf_h7"] = lambda be: iirfilt(cccf["b"], cccf["a"], backend=be)
    gen = torch.Generator(device=dev).manual_seed(35)
    xb = torch.randn(*AN_BACKENDS, dtype=torch.complex64, generator=gen,
                     device=dev)
    x4 = xb[:AN_CHECK].cpu().numpy().astype(np.complex128)

    def rel_err(a, b):
        return float((a - b).abs().max() / b.abs().square().mean().sqrt())

    @contextlib.contextmanager
    def tf32():
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    held, loose = [], {}
    n0 = iir_scan.launches, iir_block_state.launches
    for name, make in cases.items():
        qs = {be: make(be).to(dev) for be in ("scan", "block")}
        ys = {be: q(q.init(batch_shape=(AN_BACKENDS[0],), device=dev), xb)
              for be, q in qs.items()}
        rel = rel_err(ys["block"][0], ys["scan"][0])
        crel = rel_err(ys["block"][1], ys["scan"][1])
        check(rel < TOL_BACKENDS and crel < TOL_BACKENDS,
              f"scan vs block on the card, {name}: {rel:.3e}, carry "
              f"{crel:.3e}")
        # each backend against float64 scipy on channels 0..AN_CHECK-1
        ref = iir_reference64(qs["scan"], x4)
        r64 = {be: float(np.abs(ys[be][0][:AN_CHECK].cpu().numpy() - ref)
                         .max() / np.sqrt(np.mean(np.abs(ref) ** 2)))
               for be in ys}
        held.append(f"{name} {rel:.2e} (carry {crel:.2e}; vs float64 scan "
                    f"{r64['scan']:.2e}, block {r64['block']:.2e})")
        # the control: the block form with its matmuls in TF32
        q, pinned = qs["block"], iirmod._full_f32
        iirmod._full_f32 = contextlib.nullcontext
        try:
            with tf32():
                yt = q(q.init(batch_shape=(AN_BACKENDS[0],), device=dev), xb)
        finally:
            iirmod._full_f32 = pinned
        loose[name] = rel_err(yt[0], ys["scan"][0])
    check((iir_scan.launches - n0[0], iir_block_state.launches - n0[1])
          == (len(cases), 2 * len(cases)), "scan vs block: each backend "
          "must launch its kernel once a case (block twice: the control)")
    check(all(v > TOL_BACKENDS for v in loose.values()),
          f"scan vs block with TF32 matmuls: {loose}, want every case above "
          f"{TOL_BACKENDS}")
    print(f"scan vs block on the card at {AN_BACKENDS[0]}x{AN_BACKENDS[1]} "
          f"complex samples, max|err|/rms (< {TOL_BACKENDS}): "
          + "; ".join(held) + "; the block form with TF32 matmuls (the "
          f"control; every case must read above {TOL_BACKENDS}): "
          + ", ".join(f"{k} {v:.2e}" for k, v in loose.items()), flush=True)

    # times: the step; the kernel alone at the path's largest shape
    w0 = torch.randn(2 * AN_B, AN_T // 128, 8, generator=gen, device=dev)
    m0 = torch.from_numpy(np.asarray(filters[0].Apow[128].cpu())).to(dev)
    s0 = torch.zeros(2 * AN_B, 8, device=dev)
    p1 = time_once(lambda: iir_block_state_reference(w0, m0, s0))[0]
    k1 = time_ms(lambda: iir_block_state(w0, m0, s0), iters=100)
    k2 = time_ms(lambda: iir_block_state(w0, m0, s0), iters=100)
    p2 = time_once(lambda: iir_block_state_reference(w0, m0, s0))[0]
    step = time_ms(lambda: path(c0, xs[0]))
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    R, nb, p = w0.shape
    # w in, s_pre out once; per block and row p*p products and sums
    bd = bound(2 * R * nb * p * 4 + (p * p + 2 * R * p) * 4,
               2 * p * p * R * nb)
    wl = torch.randn(1, 4 * nb, p, generator=gen, device=dev)
    step_us, one = lone_row_step_us(lambda n: iir_block_state(
        wl[:, :n].contiguous(), m0, s0[:1]), (nb, 4 * nb))
    lone_ms = nb * step_us / 1e3
    mhz = sm_mhz()
    print(f"timing ({card}): analog_rx step {step:.4f} ms per {AN_B}x{AN_T} "
          f"block = {AN_B * AN_T / step / 1e3:.1f} Msamples/s in; "
          f"iir_block_state at the order-7 filter's shape ({R} rows x {nb} "
          f"blocks x {p} states): {k1:.4f}, {k2:.4f} ms (100 launches each),"
          f" bound {bd['bound_ms']:.5f} ms by {bd['bound_by']} "
          f"({bd['bound_ms'] / ms:.1%}); a lone row at "
          + ", ".join(f"{n} blocks {t:.4f} ms" for n, t in one.items())
          + f" (20 launches each): {step_us * 1e3:.2f} ns a block step "
          f"(= {step_us * mhz:.0f} cycles at the card's maximum SM clock, "
          f"{mhz:.0f} MHz), {lone_ms:.4f} ms at {nb} blocks, so the {R}-row "
          f"launch takes {ms / lone_ms:.3f} of one row's loop; plain "
          f"version {p1:.1f}, {p2:.1f} ms", flush=True)
    profile_steps(torch, card, lambda: path(c0, xs[0]), 3, "analog_rx step")
    return {
        "name": "iir_block_state", "route": "cuda",
        "source": "liquid_dsp_tpu_torch/csrc/iir_block_state.cu",
        "replaces": None,
        "recurrence": "liquid_dsp_tpu/ops/iir.py:172-181 (lax.scan)",
        "launches": launches, "max_abs_err": max_abs, "ms": ms,
        "plain_ms": plain_ms, "library_ms": None, **bd,
        "step_latency_us": step_us, "lone_row_ms": lone_ms}


def pscan_phase(torch, dev, card, xs):
    """Phase 42: iirfilt_sos(butter 7, 0.2, backend="pscan"), analog_rx's
    first stage, on analog_tx's blocks, on the iir_pscan kernel.  Returns
    its kernel entry."""
    import liquid_dsp_tpu_torch.ops.iir as iirmod
    from liquid_dsp_tpu_torch.design.iirdes import iirdes_sos
    from liquid_dsp_tpu_torch.ops.iir import iirfilt_sos
    from liquid_dsp_tpu_torch.ops.kernels.iir_block_state import (
        iir_block_state)
    from liquid_dsp_tpu_torch.ops.kernels.iir_pscan import (
        CHUNK, THREADS, iir_pscan, iir_pscan_reference)
    from liquid_dsp_tpu_torch.ops.kernels.iir_scan import iir_scan
    B7, A7 = iirdes_sos("butter", 7, 0.2)
    procs = {be: iirfilt_sos(B7, A7, backend=be).to(dev)
             for be in ("pscan", "scan", "block")}
    q = procs["pscan"]
    check(q.backend == "pscan" and not q.uses_block(xs[0]),
          "pscan: iirfilt_sos(backend='pscan') does not take the pscan form")
    c0 = q.init(batch_shape=(AN_B,), device=dev)
    iir_pscan.launches = iir_scan.launches = iir_block_state.launches = 0
    with Recorder(iirmod, "iir_pscan") as rec:
        outs, carries = [], []
        c = c0
        for x in xs:
            y, c = q(c, x)
            outs.append(y)
            carries.append(c)
        torch.cuda.synchronize()
    launches = iir_pscan.launches
    check(launches == NBLK and iir_scan.launches == 0
          and iir_block_state.launches == 0,
          f"pscan: {launches} iir_pscan, {iir_scan.launches} iir_scan, "
          f"{iir_block_state.launches} iir_block_state launches for {NBLK} "
          f"blocks (want one iir_pscan launch a block, nothing else)")
    for k, y in enumerate(outs):
        check(tuple(y.shape) == (AN_B, AN_T) and y.dtype == torch.complex64
              and bool(torch.isfinite(torch.view_as_real(y)).all()),
              f"pscan block {k}: {tuple(y.shape)} {y.dtype}, want "
              f"({AN_B}, {AN_T}) complex64 finite")
    # the kernel against its plain version on block 1's own inputs: the
    # stream's 128 plane rows from the carry of block 0
    (xp, b, a, s), (yk, sk) = rec.calls[1]
    check(tuple(xp.shape) == (2 * AN_B, AN_T) and xp.dtype == torch.float32,
          f"pscan: the kernel took {tuple(xp.shape)} {xp.dtype}, want the "
          f"{2 * AN_B} plane rows")
    p1, (y_ref, s_ref) = time_once(lambda: iir_pscan_reference(xp, b, a, s))
    max_abs = max(float((yk - y_ref).abs().max()),
                  float((sk - s_ref).abs().max()))
    check(bits_equal(torch, yk, y_ref) and bits_equal(torch, sk, s_ref),
          f"pscan: iir_pscan vs plain on block 1: not bit-equal, max|err| "
          f"{max_abs:.3e}")
    del rec

    def rel_err(a, b):
        return float((a - b).abs().max() / b.abs().square().mean().sqrt())

    # the scan and the block form on the card over the same blocks; the
    # scan's real coefficients run on the stream's float32 plane rows
    held = {}
    for be in ("scan", "block"):
        qb, cb, worst = procs[be], c0, (0.0, 0.0)
        with Recorder(iirmod, "iir_scan") as srec:
            for k, x in enumerate(xs):
                y, cb = qb(cb, x)
                worst = (max(worst[0], rel_err(outs[k], y)),
                         max(worst[1], rel_err(carries[k], cb)))
        check(max(worst) < TOL_BACKENDS, f"pscan vs {be} on the card: "
              f"{worst[0]:.3e}, carry {worst[1]:.3e}")
        held[be] = worst
        if be == "scan":
            taken = [(tuple(a[0].shape), a[0].dtype, a[1].dtype)
                     for a, _ in srec.calls]
            check(taken == [((2 * AN_B, AN_T), torch.float32,
                             torch.float32)] * NBLK,
                  f"pscan: the scan backend gave iir_scan {taken}, want "
                  f"{NBLK} calls on the {2 * AN_B} float32 plane rows")
        del srec
    # against float64 scipy on channels 0..AN_CHECK-1, beside the scan
    x64 = torch.cat(xs, dim=-1)[:AN_CHECK].cpu().numpy().astype(np.complex128)
    ref = iir_reference64(q, x64)
    r64 = {}
    for be in ("pscan", "scan"):
        qb, cb, ys = procs[be], c0[:AN_CHECK], []
        for x in xs:
            y, cb = qb(cb, x[:AN_CHECK])
            ys.append(y)
        y4 = torch.cat(ys, dim=-1).cpu().numpy()
        r64[be] = float(np.abs(y4 - ref).max()
                        / np.sqrt(np.mean(np.abs(ref) ** 2)))
    check(r64["pscan"] < TOL_AN64, f"pscan vs float64 scipy: "
          f"{r64['pscan']:.3e}")
    # three carried blocks against one call over the whole stream
    y1, c1 = q(c0, torch.cat(xs, dim=-1))
    rel1 = (rel_err(torch.cat(outs, dim=-1), y1), rel_err(carries[-1], c1))
    check(max(rel1) < TOL_BACKENDS, f"pscan: {NBLK} carried blocks vs one "
          f"call: {rel1[0]:.3e}, carry {rel1[1]:.3e}")
    del y1
    print(f"pscan: iirfilt_sos(butter 7, 0.2, backend='pscan') on {AN_B} "
          f"channels x {AN_T} complex samples a block ({2 * AN_B} plane "
          f"rows), {NBLK} blocks carried; iir_pscan launches {launches} (one "
          f"a block), bit-equal to its plain version on block 1 (y and "
          f"carry); max|err|/rms against the scan on the card "
          f"{held['scan'][0]:.3e} (carry {held['scan'][1]:.3e}), the block "
          f"form {held['block'][0]:.3e} (carry {held['block'][1]:.3e}) (< "
          f"{TOL_BACKENDS}); channels 0-{AN_CHECK - 1} vs float64 scipy "
          f"pscan {r64['pscan']:.3e}, scan {r64['scan']:.3e} (< {TOL_AN64}); "
          f"{NBLK} carried blocks vs one call {rel1[0]:.3e} (carry "
          f"{rel1[1]:.3e})", flush=True)

    # other cascades, each bit-equal to the plain version from a random
    # carry: 8 sections (butter 16) and one (butter 2) on plane rows, a
    # complex-coefficient cascade (butter 5 at 0.1, shifted by 0.6
    # rad/sample: section k's B and A times e^{j 0.6 [0, 1, 2]}) on
    # complex rows
    gen = torch.Generator(device=dev).manual_seed(42)
    rot = np.exp(0.6j * np.arange(3))
    B5, A5 = iirdes_sos("butter", 5, 0.1)
    cases = {"butter16": iirdes_sos("butter", 16, 0.2),
             "butter2": iirdes_sos("butter", 2, 0.2),
             "butter5_shifted": ((B5 * rot).astype(np.complex64),
                                 (A5 * rot).astype(np.complex64))}
    others = []
    for name, (Bc, Ac) in cases.items():
        cplx = np.iscomplexobj(Bc)
        dt = torch.complex64 if cplx else torch.float32
        rows = AN_BACKENDS[0] * (1 if cplx else 2)
        bc = torch.from_numpy(np.asarray(Bc, np.complex64 if cplx
                                         else np.float32)).to(dev)
        ac = torch.from_numpy(np.asarray(Ac, np.complex64 if cplx
                                         else np.float32)).to(dev)
        xc = torch.randn(rows, AN_BACKENDS[1], dtype=dt, generator=gen,
                         device=dev)
        sc = 0.1 * torch.randn(rows, bc.shape[0], 2, dtype=dt,
                               generator=gen, device=dev)
        n0 = iir_pscan.launches
        yc, s2 = iir_pscan(xc, bc, ac, sc)
        yr, sr = iir_pscan_reference(xc, bc, ac, sc)
        torch.cuda.synchronize()
        check(iir_pscan.launches == n0 + 1, f"pscan {name}: "
              f"{iir_pscan.launches - n0} launches, want 1")
        err = max(float((yc - yr).abs().max()), float((s2 - sr).abs().max()))
        check(bits_equal(torch, yc, yr) and bits_equal(torch, s2, sr),
              f"pscan {name}: iir_pscan vs plain not bit-equal, max|err| "
              f"{err:.3e}")
        max_abs = max(max_abs, err)
        others.append(f"{name} ({bc.shape[0]} sections, {rows} "
                      f"{'complex' if cplx else 'plane'} rows)")
    print(f"pscan: iir_pscan bit-equal to its plain version at "
          f"{AN_BACKENDS[1]} samples from a random carry: "
          + ", ".join(others), flush=True)

    # times: the kernel at the path's shape (the plane rows of a block)
    # beside iir_scan on the same rows and filter, then the three
    # backends' Proc calls on a block
    s0 = torch.zeros_like(s)
    k1 = time_ms(lambda: iir_pscan(xp, b, a, s0), iters=100)
    sc1 = time_ms(lambda: iir_scan(xp, b, a, s0), iters=100)
    k2 = time_ms(lambda: iir_pscan(xp, b, a, s0), iters=100)
    sc2 = time_ms(lambda: iir_scan(xp, b, a, s0), iters=100)
    p2 = time_once(lambda: iir_pscan_reference(xp, b, a, s0))[0]
    step = {be: [time_ms(lambda qb=qb: qb(c0, xs[0])) for _ in range(2)]
            for be, qb in procs.items()}
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    R, T = xp.shape
    ns = b.shape[0]
    # x in and y out once; per sample and section the kernel's two walks
    # (7 and 9 operations) and its share of the 6 combines a chunk (8
    # each: 5 in the warp, the lane power's), and warp 0's log2(warps)
    # over the warps' totals a tile (on its 32 lanes)
    C = CHUNK[False]
    n_ops = R * ns * (T * (7 + 9 + 6 * 8 / C) + T / (C * THREADS)
                      * ((THREADS // 32).bit_length() - 1) * 8 * 32)
    bd = bound(2 * R * T * 4 + (2 * ns * 3 + 2 * R * ns * 2) * 4, n_ops)
    t_bytes = (2 * R * T * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    print(f"timing ({card}): iir_pscan at the path's shape ({R} plane rows "
          f"x {T} samples, {ns} sections): {k1:.4f}, {k2:.4f} ms (100 "
          f"launches each), bound {bd['bound_ms']:.5f} ms by "
          f"{bd['bound_by']} (bytes {t_bytes:.5f} ms, operations "
          f"{n_ops / 1e9:.2f} G = {t_ops:.5f} ms), so {bd['bound_ms'] / ms:.1%}"
          f" of it; iir_scan on the same rows and filter {sc1:.4f}, "
          f"{sc2:.4f} ms, {(sc1 + sc2) / (k1 + k2):.1f} times iir_pscan; "
          f"plain version {p1:.1f}, {p2:.1f} ms; a {AN_B}x{AN_T} complex "
          f"block through iirfilt_sos(butter 7) by backend (the scan on "
          f"the {2 * AN_B} plane rows): "
          + ", ".join(f"{be} {v[0]:.4f}, {v[1]:.4f} ms"
                      for be, v in step.items()), flush=True)
    return {
        "name": "iir_pscan", "route": "cuda",
        "source": "liquid_dsp_tpu_torch/csrc/iir_pscan.cu",
        "replaces": None,
        "recurrence": "liquid_dsp_tpu/ops/iir.py:266-305 "
                      "(lax.associative_scan)",
        "launches": launches, "max_abs_err": max_abs, "ms": ms,
        "plain_ms": plain_ms, "library_ms": None, **bd,
        "iir_scan_ms": (sc1 + sc2) / 2,
        "backend_step_ms": {be: sum(v) / 2 for be, v in step.items()}}


def sr_captures(tmpdir):
    """The SR_CH cs16 captures of SR_N samples (written with io.write_iq):
    channel c holds a tone at its own frequency, 0.4 of full scale, plus
    complex noise of 0.05 rms a plane, inside the int16 rails."""
    from liquid_dsp_tpu_torch import io
    paths = []
    t = np.arange(SR_N)
    for c in range(SR_CH):
        rng = np.random.default_rng(3600 + c)
        f = DPHI / (2 * np.pi) + 0.001 * (c - SR_CH / 2)
        x = 0.4 * np.exp(2j * np.pi * f * t + 1j * rng.uniform(0, 6.3))
        x += 0.05 * (rng.standard_normal(SR_N)
                     + 1j * rng.standard_normal(SR_N))
        p = os.path.join(tmpdir, f"ch{c:02d}.cs16")
        io.write_iq(p, x.astype(np.complex64), "cs16")
        paths.append(p)
    return paths


def sr_proc():
    """The headline chain (chip_smoke.py's phase 3) for StreamRunner."""
    from liquid_dsp_tpu_torch import chain, fuse, kernel_fuse
    from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
    from liquid_dsp_tpu_torch.ops.fir import firfilt
    from liquid_dsp_tpu_torch.ops.nco import nco
    from liquid_dsp_tpu_torch.ops.resample import msresamp
    return kernel_fuse(fuse(chain(nco(dphi=DPHI, direction="down"),
                                  firfilt(firdes_kaiser(64, 0.2, 60.0)),
                                  firfilt(firdes_kaiser(57, 0.3, 60.0)),
                                  msresamp(0.5, 60.0))))


def clone_tree(torch, c):
    if isinstance(c, dict):
        return {k: clone_tree(torch, v) for k, v in c.items()}
    if isinstance(c, (tuple, list)):
        return type(c)(clone_tree(torch, v) for v in c)
    return c.clone() if torch.is_tensor(c) else c


def stream_runner_phase(torch, dev, card):
    """Phase 36: the headline chain through StreamRunner over SR_CH cs16
    captures read with io.iq_stream, a checkpoint after block 2 and a
    resume.  Returns (mix_fir_decim launches, its max|err| against its
    plain version on the run's own blocks)."""
    import tempfile
    from liquid_dsp_tpu_torch import io
    from liquid_dsp_tpu_torch.ops.kernels.mix_fir_decim import (
        mix_fir_decim, mix_fir_decim_reference)
    from liquid_dsp_tpu_torch.runtime import StreamRunner
    nblk = -(-SR_N // SR_T)
    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        paths = sr_captures(tmpdir)
        t_write = time.perf_counter() - t0
        runner = StreamRunner(sr_proc(), batch_shape=(SR_CH,), device=dev)
        check(type(runner.proc).__name__ == "MixFIRDecim",
              f"stream_runner: kernel_fuse gave {type(runner.proc)}")
        its = [io.iq_stream(p, "cs16", block=SR_T) for p in paths]
        ck = os.path.join(tmpdir, "state.npz")
        blocks, outs, carries, t_read, t_loop, t_call = [], [], [], [], [], []
        mix_fir_decim.launches = 0
        for k in range(nblk):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = np.stack([next(it) for it in its])
            t1 = time.perf_counter()
            carries.append(clone_tree(torch, runner.carry))
            y = runner(x)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            t_read.append((t1 - t0) * 1e3)
            t_call.append((t2 - t1) * 1e3)
            t_loop.append((t2 - t0) * 1e3)
            blocks.append(x)
            outs.append(y)
            if k == 1:
                runner.save(ck)
        launches = mix_fir_decim.launches
        check(all(next(it, None) is None for it in its),
              f"stream_runner: the captures hold more than {nblk} blocks")
        check(launches == nblk, f"stream_runner: {launches} mix_fir_decim "
              f"launches for {nblk} blocks")
        check(runner.blocks_processed == nblk,
              f"stream_runner: {runner.blocks_processed} blocks processed")
        # the last block is zero-padded past the capture
        tail = SR_N - (nblk - 1) * SR_T
        check(not blocks[-1][:, tail:].any() and blocks[-1][:, :tail].any(),
              "stream_runner: the last block is not the capture's tail "
              "zero-padded")
        # a fresh runner resumes from the checkpoint: bit-equal
        resumed = StreamRunner(sr_proc(), batch_shape=(SR_CH,), device=dev)
        resumed.load(ck)
        check(resumed.blocks_processed == 2, "stream_runner: the checkpoint "
              f"resumes at block {resumed.blocks_processed}, want 2")
        for k in range(2, nblk):
            check(bits_equal(torch, resumed(blocks[k]), outs[k]),
                  f"stream_runner: resumed block {k} differs from the "
                  f"uninterrupted run")
        # the cf32 round trip of an output
        y0 = outs[-1][0].cpu().numpy()
        io.write_iq(os.path.join(tmpdir, "out.cf32"), y0, "cf32")
        back = io.read_iq(os.path.join(tmpdir, "out.cf32"), "cf32")
        check(np.array_equal(back, y0), "stream_runner: write_iq cf32 then "
              "read_iq does not give the output back")
    # the proc called directly with the same carries, and its kernel
    # against its plain version on the same inputs
    proc = runner.proc
    max_abs = 0.0
    for k, (x, c, y) in enumerate(zip(blocks, carries, outs)):
        check(tuple(y.shape) == (SR_CH, SR_T // 2)
              and y.dtype == torch.complex64 and y.device.type == dev.type
              and bool(torch.isfinite(torch.view_as_real(y)).all()),
              f"stream_runner block {k}: {tuple(y.shape)} {y.dtype} on "
              f"{y.device}")
        xd = torch.from_numpy(x).to(dev)
        with torch.inference_mode():
            yd, _ = proc(clone_tree(torch, c), xd)
            ref = mix_fir_decim_reference(
                xd.real.contiguous(), xd.imag.contiguous(), c["tr"],
                c["ti"], c["theta"], proc.ramp_c, proc.ramp_s, proc.taps,
                down=proc.down, sgn=proc.sgn, dphi=proc.dphi)
        check(bits_equal(torch, yd, y), f"stream_runner block {k}: the "
              f"runner's output differs from the proc called directly")
        err, rel = complex_err((y.real, y.imag), ref)
        check(rel < TOL_F32, f"stream_runner block {k}: mix_fir_decim vs "
              f"plain {rel:.3e} of rms")
        max_abs = max(max_abs, err)
    # four channels against the port on the CPU
    cpu = StreamRunner(sr_proc(), batch_shape=(SR_CPU,), device="cpu")
    worst = 0.0
    for x, y in zip(blocks, outs):
        yc = cpu(x[:SR_CPU])
        yg = y[:SR_CPU].cpu()
        worst = max(worst, complex_err((yg.real, yg.imag),
                                       (yc.real, yc.imag))[1])
    check(worst < TOL_F32, f"stream_runner vs the CPU on channels 0-"
          f"{SR_CPU - 1}: {worst:.3e} of rms")
    # times: the copy and the step alone, on the last block
    xh = blocks[-1]
    copy = time_ms(lambda: torch.from_numpy(xh).to(dev), iters=10)
    xd = torch.from_numpy(xh).to(dev)
    c0 = carries[-1]
    with torch.inference_mode():
        step = time_ms(lambda: proc(c0, xd))
    mb = xh.nbytes / 1e6
    print(f"stream_runner: StreamRunner(kernel_fuse(fuse(chain(nco, "
          f"firfilt64, firfilt57, msresamp(0.5)))), batch_shape=({SR_CH},))"
          f" over {SR_CH} cs16 captures of {SR_N} samples (written in "
          f"{t_write:.1f} s) read by io.iq_stream in blocks of {SR_T}: "
          f"{nblk} blocks, the last zero-padded after {tail} samples; "
          f"mix_fir_decim launches {launches}; checkpoint after block 2 and "
          f"a fresh runner's resume bit-equal on blocks 3-{nblk}; the "
          f"runner bit-equal to the proc called directly with the same "
          f"carries; mix_fir_decim within {max_abs:.2e} of its plain "
          f"version; channels 0-{SR_CPU - 1} vs the CPU {worst:.2e} of rms "
          f"(< {TOL_F32}); write_iq/read_iq cf32 of an output exact",
          flush=True)
    print(f"timing ({card}): stream_runner ms per block of {SR_CH}x{SR_T} "
          f"(block 1 first): host read and convert ({SR_CH} iq_stream reads "
          f"of cs16, np.stack) " + ", ".join(f"{v:.1f}" for v in t_read)
          + "; runner call (host clock, synchronized: the copy of "
          f"{mb:.0f} MB of complex64 from pageable memory and the step) "
          + ", ".join(f"{v:.1f}" for v in t_call) + "; whole loop "
          + ", ".join(f"{v:.1f}" for v in t_loop)
          + f"; alone, on the last block (CUDA events): host-to-device copy "
          f"{copy:.3f} ms ({mb / copy:.2f} GB/s), the step {step:.4f} ms",
          flush=True)
    del blocks, outs, carries, xd, runner, resumed
    return launches, max_abs


def ldpc_phase(torch, dev, card):
    """Phase 37: batched LDPC belief propagation on the card at LD_ROWS
    codewords of the n = 648 code, sum-product and min-sum, its iterations,
    decisions and parity in one launch of the ldpc_bp kernel a decode,
    held to the plain version (messages, hard, ok) on each decode's own
    LLRs.  Returns ldpc_bp's kernel entry."""
    from liquid_dsp_tpu_torch.fec.ldpc import (ldpc_decoder_device,
                                               ldpc_encode_systematic,
                                               ldpc_sumproduct_decode,
                                               make_regular_ldpc)
    from liquid_dsp_tpu_torch.ops.kernels.ldpc_bp import (
        ldpc_bp, ldpc_bp_reference, ldpc_decide_reference)
    n, k = LD_N, LD_N // 2
    H = make_regular_ldpc(n, k, col_weight=3, seed=LD_SEED)
    rng = np.random.default_rng(37)
    msgs = rng.integers(0, 2, (LD_MSGS, k)).astype(np.uint8)
    t0 = time.perf_counter()
    cws = np.stack([ldpc_encode_systematic(H, m)[0] for m in msgs])
    t_enc = time.perf_counter() - t0
    check(not ((cws @ H.T) % 2).any(), "ldpc: a codeword fails its parity")
    sent = np.repeat(cws, LD_ROWS // LD_MSGS, axis=0)
    y = 1.0 - 2.0 * sent + LD_SIGMA * rng.standard_normal(sent.shape)
    llr_h = (2 * y / LD_SIGMA ** 2).astype(np.float32)
    llr = torch.from_numpy(llr_h).to(dev)
    Ht = torch.from_numpy(H.T.astype(np.float32)).to(dev)

    def decide(x, rv, wc):
        """(hard [R, n] numpy, parity ok [R]) from the messages."""
        post = x + rv[:, :n * wc].reshape(x.shape[0], n, wc).sum(-1)
        hard = (post < 0).to(torch.float32)
        syn = torch.remainder(hard @ Ht, 2.0)     # exact: TF32 is off
        return hard.cpu().numpy().astype(np.int32), \
            (syn == 0).all(-1).cpu().numpy()

    res, times, bp = {}, {}, {}
    for mode in ("sum-product", "min-sum"):
        ms_ = mode == "min-sum"
        dec = ldpc_decoder_device(H, LD_ITERS, min_sum=ms_, device=dev)
        ldpc_bp.launches = 0
        hard, ok = dec(llr)
        torch.cuda.synchronize()
        n_bp = ldpc_bp.launches
        check(n_bp == 1, f"ldpc {mode}: ldpc_bp launched {n_bp} times in "
              f"one decode")
        check(tuple(hard.shape) == (LD_ROWS, n) and hard.dtype == torch.int32
              and ok.dtype == torch.bool and hard.device.type == dev.type,
              f"ldpc {mode}: {tuple(hard.shape)} {hard.dtype} {ok.dtype}")
        hard, ok = hard.cpu().numpy(), ok.cpu().numpy()
        good = (hard == sent).all(axis=1)
        check(not (ok & ~good).any(), f"ldpc {mode}: {int((ok & ~good).sum())}"
              f" rows pass their parity with another codeword than sent")
        # the first LD_CPU rows on the CPU: equal wherever the CPU converged
        hc, okc = ldpc_decoder_device(H, LD_ITERS, min_sum=ms_,
                                      device="cpu")(llr_h[:LD_CPU])
        hc, okc = hc.numpy(), okc.numpy()
        same = (hard[:LD_CPU][okc] == hc[okc]).all() and ok[:LD_CPU][okc].all()
        check(same, f"ldpc {mode}: the card differs from the CPU on rows the "
              f"CPU decoded")
        dcount = abs(int(ok[:LD_CPU].sum()) - int(okc.sum()))
        check(dcount <= LD_CPU * 0.005 + 1e-9 or dcount == 0,
              f"ldpc {mode}: {int(ok[:LD_CPU].sum())} rows ok on the card, "
              f"{int(okc.sum())} on the CPU, of {LD_CPU}")
        res[mode] = (int(ok.sum()), int(okc.sum()), int(ok[:LD_CPU].sum()))
        if not ms_:
            check(ok.mean() >= 0.99, f"ldpc sum-product at sigma {LD_SIGMA}:"
                  f" {ok.mean():.4f} of rows decode, want >= 0.99")
            # the host decoder (float64, stops at the first codeword)
            for r in range(LD_HOST):
                hb, okh, _ = ldpc_sumproduct_decode(H, llr_h[r], LD_ITERS)
                check(not okh or (ok[r] and (hard[r] == hb).all()),
                      f"ldpc: row {r} differs from the host decoder")
        times[mode] = (time_ms(lambda: dec(llr), iters=5),
                       time_ms(lambda: dec(llr), iters=5))
        # six decodes: a decode is one launch now, and a trace of two
        # (two events) came back empty three times in a row on the card
        by = profile_steps(torch, card, lambda: dec(llr), 6,
                           f"ldpc_decoder_device({mode}) at {LD_ROWS} rows")
        events = sum(c for _, c in by.values())
        times[mode] += (events / 6,)
        check(events % 6 == 0 and times[mode][2] <= 4,
              f"ldpc {mode}: {events} device operations in 6 decodes, want "
              f"a whole trace (a multiple of 6) and <= 4 a decode (one "
              f"ldpc_bp launch)")
        # ldpc_bp against its plain version on this decode's inputs, in
        # the decoder's form (the real edges' maps, the decisions and the
        # parity from the same launch): the messages, hard and ok
        # bit-equal (sums in slot order in both, the pads' part added as
        # the plain version adds it, the same float32 functions)
        c2v, v2c, cvar, cw, cmaps = dec._on(dev)
        args = (llr, c2v, v2c, cvar, dec.m, n, dec.wr, dec.wc, LD_ITERS, ms_)
        rk, hk_t, okk_t = ldpc_bp(*args, cw, cmaps, messages=True)
        rp = ldpc_bp_reference(*args)
        hp_t, okp_t = ldpc_decide_reference(llr, rp, cvar, cw, dec.m, n,
                                            dec.wr, dec.wc)
        check(torch.equal(hk_t, hp_t) and torch.equal(okk_t, okp_t),
              f"ldpc {mode}: the kernel's decisions or parity differ from "
              f"the plain version's: {int((hk_t != hp_t).sum())} bits, "
              f"{int((okk_t != okp_t).sum())} verdicts")
        # the matmul syndrome: a second, independent check of the verdicts
        hk, okk = decide(llr, rk, dec.wc)
        hp, okp = decide(llr, rp, dec.wc)
        check(np.array_equal(hk, hard) and np.array_equal(okk, ok)
              and np.array_equal(hk_t.cpu().numpy(), hard)
              and np.array_equal(okk_t.cpu().numpy(), ok),
              f"ldpc {mode}: ldpc_bp alone differs from the decoder")
        n_diff = int((hk[okp] != hp[okp]).sum())
        rv_err = float((rk - rp).abs().max())
        check(okp.mean() >= (0.99 if not ms_ else 0.5) and n_diff == 0
              and okk[okp].all() and torch.equal(rk, rp),
              f"ldpc {mode}: ldpc_bp against its plain version: messages "
              f"max|diff| {rv_err:.3e}, {n_diff} decisions differ on the "
              f"{int(okp.sum())} rows the plain version decoded, "
              f"{int((~okk[okp]).sum())} of them fail their parity")

        def plain():
            rv = ldpc_bp_reference(*args)
            return ldpc_decide_reference(llr, rv, cvar, cw, dec.m, n, dec.wr,
                                         dec.wc)

        p1 = time_ms(plain, iters=2)
        k1 = time_ms(lambda: ldpc_bp(*args, cw, cmaps), iters=5)
        k2 = time_ms(lambda: ldpc_bp(*args, cw, cmaps), iters=5)
        p2 = time_ms(plain, iters=2)
        bp[mode] = {"launches": n_bp, "diff": n_diff, "rv_err": rv_err,
                    "ok": (int(okk.sum()), int(okp.sum())),
                    "ms": (k1, k2), "plain_ms": (p1, p2)}
    print(f"ldpc_bp: make_regular_ldpc({n}, {k}, col_weight=3, seed="
          f"{LD_SEED}) (the first full-rank seed from 0), {LD_MSGS} "
          f"messages (encoded on the host in {t_enc:.1f} s) x "
          f"{LD_ROWS // LD_MSGS} BPSK AWGN draws at sigma {LD_SIGMA} = "
          f"{LD_ROWS} rows, {LD_ITERS} iterations; rows ok (card, CPU on "
          f"the first {LD_CPU}, card on them): " + "; ".join(
              f"{m} {a} of {LD_ROWS}, {b} / {c} of {LD_CPU}"
              for m, (a, b, c) in res.items())
          + "; every ok row is its sent codeword; the card equals the CPU "
          f"where the CPU converged; rows 0-{LD_HOST - 1} equal the host "
          f"float64 decoder", flush=True)
    print(f"timing ({card}): ldpc_decoder_device at {LD_ROWS} x {n}, "
          f"{LD_ITERS} iterations, ms per decode (5 calls each, CUDA "
          f"events): " + "; ".join(f"{m} {a:.3f}, {b:.3f} ({c:.0f} device "
                                   f"operations a call)"
                                   for m, (a, b, c) in times.items()),
          flush=True)
    print(f"ldpc_bp: one launch a decode in both modes; against its plain "
          f"version on the card on the decodes' LLRs: " + "; ".join(
              f"{m} rows ok {v['ok'][0]} (plain {v['ok'][1]}) of {LD_ROWS}, "
              f"messages, hard and ok bit-equal (max|diff| "
              f"{v['rv_err']:.3e}), "
              f"{v['diff']} decisions differ where the plain version "
              f"converged"
              for m, v in bp.items()), flush=True)
    print(f"timing ({card}): ldpc_bp at {LD_ROWS} x {n}, {LD_ITERS} "
          f"iterations, the decoder's launch (decisions and parity out; "
          f"CUDA events): " + "; ".join(
              f"{m} kernel {v['ms'][0]:.3f}, {v['ms'][1]:.3f} ms (5 calls "
              f"each), plain version {v['plain_ms'][0]:.3f}, "
              f"{v['plain_ms'][1]:.3f} ms (2 calls each)"
              for m, v in bp.items()), flush=True)
    # an edge of H takes 16 float operations an iteration in sum-product
    # (tanh, log, exp and atanh counted as one each) and an add on its
    # variable's side; the LLRs in and the decisions and verdicts out once
    E = int(H.sum())
    sp, mn = bp["sum-product"], bp["min-sum"]
    b = bound(LD_ROWS * n * 4 + LD_ROWS * n * 4 + LD_ROWS,
              LD_ROWS * LD_ITERS * (17 * E + n))
    print(f"bound: ldpc_bp (sum-product) {b['bound_ms']:.4f} ms by "
          f"{b['bound_by']} ({E} edges)", flush=True)
    return {"name": "ldpc_bp", "route": "cuda",
            "source": "liquid_dsp_tpu_torch/csrc/ldpc_bp.cu",
            "replaces": "liquid_dsp_tpu/fec/ldpc.py:241",
            "recurrence": "lax.scan of the belief-propagation iterations "
                          "(liquid_dsp_tpu/fec/ldpc.py:225-241)",
            "launches": sp["launches"] + mn["launches"],
            "launches_by_path": {
                "ldpc_decoder_device(sum-product)": sp["launches"],
                "ldpc_decoder_device(min-sum)": mn["launches"]},
            # the messages' largest difference from the plain version
            "max_abs_err": max(sp["rv_err"], mn["rv_err"]),
            "ms": sum(sp["ms"]) / 2, "plain_ms": sum(sp["plain_ms"]) / 2,
            "min_sum_ms": sum(mn["ms"]) / 2,
            "min_sum_plain_ms": sum(mn["plain_ms"]) / 2,
            "library_ms": None, **b}


def cvsd_phase(torch, dev, card):
    """Phase 38: CVSD on the cvsd_scan kernel: the golden through the
    public functions (the main path), the kernel against its plain version
    and its times at a gateway's shape, a lone row's step each way, and
    one entry call on a 0.5 s host array each way (what a user waits for).
    Returns its kernel entry."""
    from liquid_dsp_tpu_torch.ops.kernels.cvsd_scan import (
        cvsd_scan, cvsd_scan_reference)
    from liquid_dsp_tpu_torch.utils.audio import cvsd_decode, cvsd_encode
    g = dict(np.load(os.path.join(ROOT, "tests", "golden",
                                  "flexframe_golden.npz")))
    x = np.real(g["cvsd_x"]).astype(np.float32)
    cvsd_scan.launches = 0
    bits = cvsd_encode(x)                 # the card: the entry's default
    audio = cvsd_decode(bits)
    launches = cvsd_scan.launches
    check(launches == 2, f"cvsd: {launches} cvsd_scan launches for an "
          f"encode and a decode")
    check(np.array_equal(bits.astype(np.int32),
                         np.real(g["cvsd_bits"]).astype(np.int32)),
          "cvsd: encoded bits differ from the compiled reference's")
    gerr = float(np.abs(audio - np.real(g["cvsd_xr"])).max())
    check(gerr < 1e-4, f"cvsd: decoded audio {gerr:.3e} from the "
          f"reference's (limit 1e-4)")
    # the launches the path made, again on its own tensors ([1, 400]
    # float32 in, the uint8 bits back), against the plain version
    xp = torch.from_numpy(x).to(dev).reshape(1, -1)
    bp = torch.from_numpy(bits).to(dev).reshape(1, -1)
    kb, ka = cvsd_scan(xp, True), cvsd_scan(bp, False)
    pb, pa = cvsd_scan_reference(xp, True), cvsd_scan_reference(bp, False)
    check(bits_equal(torch, kb, pb) and bits_equal(torch, kb, bp)
          and bits_equal(torch, ka, pa)
          and np.array_equal(ka[0].cpu().numpy(), audio),
          f"cvsd_scan vs plain on the path's [1, {x.size}] rows: not bit-"
          f"equal (bits {int((kb != pb).sum())} differ, audio max|err| "
          f"{float((ka - pa).abs().max()):.3e})")
    path_err = float((ka - pa).abs().max())

    def voice(R, T, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        t = torch.arange(T, device=dev, dtype=torch.float32) / 64000.0
        f0 = 200 + 3000 * torch.rand(R, 1, generator=gen, device=dev)
        return (0.5 * torch.sin(2 * np.pi * f0 * t) + 0.05 * torch.randn(
            R, T, generator=gen, device=dev)).clamp(-1, 1).contiguous()

    R, Tc = CV_CMP
    xc = voice(R, Tc, 38)
    bc = cvsd_scan(xc, True)
    ac = cvsd_scan(bc, False)
    p_enc, pb = time_once(lambda: cvsd_scan_reference(xc, True))
    p_dec, pa = time_once(lambda: cvsd_scan_reference(bc, False))
    check(bits_equal(torch, bc, pb) and bits_equal(torch, ac, pa),
          f"cvsd_scan vs plain at {R}x{Tc}: not bit-equal (bits "
          f"{int((bc != pb).sum())} differ, audio max|err| "
          f"{float((ac - pa).abs().max()):.3e})")
    max_abs = max(path_err, float((ac - pa).abs().max()))
    R, T = CV_GATEWAY
    xg = voice(R, T, 39)
    bg = cvsd_scan(xg, True)
    e1 = time_ms(lambda: cvsd_scan(xg, True), iters=100)
    d1 = time_ms(lambda: cvsd_scan(bg, False), iters=100)
    e2 = time_ms(lambda: cvsd_scan(xg, True), iters=100)
    d2 = time_ms(lambda: cvsd_scan(bg, False), iters=100)
    enc, dec = (e1 + e2) / 2, (d1 + d2) / 2
    # encode: 4 bytes in, 1 out a sample; 9 operations (the pre-emphasis's
    # product and difference, the compare, delta's product and two clamps,
    # ref's sum and two clamps); decode: 1 in, 4 out, those 7 after the
    # compare plus the post-emphasis's sum, FMA (2), sum and product
    bd = bound(2 * 5 * R * T, (9 + 12) * R * T)
    lens = (T // 4, T)
    xl = {n: xg[:1, :n].contiguous() for n in lens}
    bl = {n: bg[:1, :n].contiguous() for n in lens}
    step_us, one = lone_row_step_us(lambda n: cvsd_scan(bl[n], False), lens)
    step_enc, one_enc = lone_row_step_us(lambda n: cvsd_scan(xl[n], True),
                                         lens)
    # what a user waits for: one entry call on a host array of T samples,
    # the copies to and from the card included (host clock, 5 calls)
    xh = xg[0].cpu().numpy()
    bh = cvsd_encode(xh)
    call_ms = {}
    for what, fn in (("cvsd_encode", lambda: cvsd_encode(xh)),
                     ("cvsd_decode", lambda: cvsd_decode(bh))):
        fn()
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        call_ms[what] = sorted(ts)
    mhz = sm_mhz()
    print(f"cvsd: the golden (400 samples) through cvsd_encode/cvsd_decode "
          f"on the card: bits equal, audio {gerr:.2e} from the reference's;"
          f" cvsd_scan launches {launches}, bit-equal to its plain version"
          f" on the path's rows and at {CV_CMP[0]}x{CV_CMP[1]} (bits and "
          f"audio)", flush=True)
    print(f"timing ({card}): cvsd_scan at {R} streams x {T} samples (0.5 s "
          f"of 64 kHz voice each): encode {e1:.4f}, {e2:.4f} ms, decode "
          f"{d1:.4f}, {d2:.4f} ms (100 launches each) = "
          f"{R * T / enc / 1e3:.1f} and {R * T / dec / 1e3:.1f} Msamples/s;"
          f" bound for both {bd['bound_ms']:.5f} ms by {bd['bound_by']} "
          f"({bd['bound_ms'] / (enc + dec):.2%}); a lone decode row at "
          + ", ".join(f"{n} steps {t:.4f} ms" for n, t in one.items())
          + f": {step_us * 1e3:.2f} ns a step (= {step_us * mhz:.1f} cycles "
          f"at {mhz:.0f} MHz), the chain's floor {T * step_us / 1e3:.4f} ms "
          f"at {T} steps, the {R}-row launch {dec / (T * step_us / 1e3):.3f} "
          f"of it; a lone encode row at "
          + ", ".join(f"{n} steps {t:.4f} ms" for n, t in one_enc.items())
          + f": {step_enc * 1e3:.2f} ns a step (= {step_enc * mhz:.1f} "
          f"cycles), the {R}-row launch {enc / (T * step_enc / 1e3):.3f} of "
          f"its loop; plain version at {CV_CMP[0]}x{CV_CMP[1]}: encode "
          f"{p_enc:.1f} ms, decode {p_dec:.1f} ms", flush=True)
    print(f"timing ({card}): one call on a {T}-sample host array (0.5 s of "
          f"64 kHz voice), copies included, 5 calls (host clock): "
          + "; ".join(f"{w} " + ", ".join(f"{t:.3f}" for t in ts) + " ms"
                      for w, ts in call_ms.items()), flush=True)
    return {
        "name": "cvsd_scan", "route": "cuda",
        "source": "liquid_dsp_tpu_torch/csrc/cvsd_scan.cu", "replaces": None,
        "recurrence": "liquid_dsp_tpu/utils/audio.py:41-52 and :62-84 "
                      "(lax.scan)",
        "launches": launches, "max_abs_err": max_abs, "ms": enc + dec,
        "ms_encode": enc, "ms_decode": dec, "shape": [R, T],
        "plain_ms": p_enc + p_dec, "plain_shape": list(CV_CMP),
        "library_ms": None, **bd, "step_latency_us": step_us,
        "step_latency_us_encode": step_enc,
        "chain_floor_ms": T * step_us / 1e3,
        "call_ms": {w: ts[len(ts) // 2] for w, ts in call_ms.items()}}


def eq_streams(seed, B, n, h, noise):
    """(x, s) [B, n] complex64: unit-energy QPSK symbols s, a seed per
    channel, through the channel taps h, plus `noise` a rail."""
    s2 = np.float32(np.sqrt(0.5))
    s = np.empty((B, n), np.complex64)
    x = np.empty((B, n), np.complex64)
    for ch in range(B):
        rng = np.random.default_rng([seed, ch])
        bits = rng.integers(0, 2, (2, n)) * 2 - 1
        s[ch] = (bits[0] + 1j * bits[1]) * s2
        x[ch] = np.convolve(s[ch], np.asarray(h, np.complex64))[:n] + noise * (
            rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x, s


def eq_carry_equal(torch, got, want):
    """(bit-equal, max |got - want|) over outputs and carries."""
    same = all(bits_equal(torch, g, w) for g, w in zip(got, want))
    err = max((float((g - w).abs().max()) if g.numel() else 0.0)
              for g, w in zip(got, want) if g.dtype != torch.int32)
    return same, err


def equalizer_phase(torch, dev, card):
    """Phase 39: the LMS and RLS equalizers at 256 channels through their
    Procs on the card (the path), eqlms_scan and eqrls_scan bit-equal to
    their plain versions on the path's own inputs and at other shapes,
    their times beside their bounds.  Returns their kernel entries."""
    from liquid_dsp_tpu_torch.ops.equalize import eqlms, eqrls
    from liquid_dsp_tpu_torch.ops.kernels.eqlms_scan import (
        eqlms_scan, eqlms_scan_reference)
    from liquid_dsp_tpu_torch.ops.kernels.eqrls_scan import (
        eqrls_scan, eqrls_scan_reference)
    B, T, NT, L = EQ_B, EQ_T, EQ_TRAIN, 13
    x, s = eq_streams(39, B, NT + T, (1.0, 0.35 - 0.2j, -0.12 + 0.05j),
                      0.01)
    xr, dr = eq_streams(40, B, T, (1.0, 0.0, -0.25 + 0.2j, 0.0, 0.1), 0.0)
    xt = torch.from_numpy(x[:, :NT].copy()).to(dev)
    st = torch.from_numpy(s[:, :NT].copy()).to(dev)
    xd = torch.from_numpy(x[:, NT:].copy()).to(dev)
    xr, dr = torch.from_numpy(xr).to(dev), torch.from_numpy(dr).to(dev)
    torch.cuda.synchronize()
    # the path: train, hand the carry on, decision-directed; RLS trained
    q_tr, q_dd = eqlms(L, mu=0.2).to(dev), eqlms(L, mu=0.05).to(dev)
    q_rls = eqrls(9, lam=0.99, delta=0.1).to(dev)
    c0 = q_tr.init((B,), device=dev)
    r0 = q_rls.init((B,), device=dev)
    eqlms_scan.launches = eqrls_scan.launches = 0
    t0 = time.perf_counter()
    y1, c1 = q_tr(c0, (xt, st))
    y2, c2 = q_dd(c1, xd)
    yr, r1 = q_rls(r0, (xr, dr))
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    lms_n, rls_n = eqlms_scan.launches, eqrls_scan.launches
    check(lms_n == 2 and rls_n == 1, f"equalizers: {lms_n} eqlms_scan and "
          f"{rls_n} eqrls_scan launches on the path, want 2 and 1")
    sd = torch.from_numpy(s[:, NT:].copy()).to(dev)
    ya, sa = y2[:, 200:], sd[:, 200:]
    wrong = int(((torch.sign(ya.real) != torch.sign(sa.real))
                 | (torch.sign(ya.imag) != torch.sign(sa.imag))).sum())
    evm = 10 * torch.log10((ya - sa).abs().square().mean(-1)).cpu()
    check(wrong == 0, f"eqlms: {wrong} decisions after sample 200 differ "
          f"from the sent symbols")
    check(float(evm.max()) <= EQ_LIMIT_DB, f"eqlms: EVM {float(evm.max()):.2f}"
          f" dB on the worst channel (limit {EQ_LIMIT_DB})")
    mse = 10 * torch.log10((yr[:, 1000:] - dr[:, 1000:]).abs().square()
                           .mean(-1)).cpu()
    p_ok = bool(torch.isfinite(torch.view_as_real(r1["P"])).all())
    check(float(mse.max()) <= EQ_LIMIT_DB and p_ok, f"eqrls: MSE "
          f"{float(mse.max()):.2f} dB on the worst channel (limit "
          f"{EQ_LIMIT_DB}), P finite {p_ok}")
    # the kernels against their plain versions on the card, on the path's
    # own inputs and carries
    keys = ("w", "buf", "x2_sum", "n")
    cmp = {}
    got = eqlms_scan(xt, *(c0[k] for k in keys), 0.2, d=st)
    cmp["lms trained (path's 400)"] = eq_carry_equal(
        torch, got, eqlms_scan_reference(xt, *(c0[k] for k in keys), 0.2,
                                         d=st))
    check(bits_equal(torch, got[0], y1), "eqlms_scan: the trained block "
          "again differs from the path's")
    xd0 = xd[:, :EQ_CMP]
    got = eqlms_scan(xd0, *(c1[k] for k in keys), 0.05)
    p_dd, want = time_once(lambda: eqlms_scan_reference(
        xd0, *(c1[k] for k in keys), 0.05))
    cmp[f"lms decision-directed (path's first {EQ_CMP})"] = eq_carry_equal(
        torch, got, want)
    check(bits_equal(torch, got[0], y2[:, :EQ_CMP]), "eqlms_scan: the first "
          "decision-directed samples again differ from the path's")
    Br, Tr = EQ_REAL
    g = torch.Generator(device=dev).manual_seed(41)
    bpsk = torch.sign(torch.randn(Br, Tr, generator=g, device=dev))
    xb = (bpsk + 0.3 * torch.roll(bpsk, 1, -1) + 0.05 * torch.randn(
        Br, Tr, generator=g, device=dev)).contiguous()
    cb = eqlms(L, mu=0.05).init((Br,), dtype=torch.float32, device=dev)
    got = eqlms_scan(xb, *(cb[k] for k in keys), 0.05)
    cmp[f"lms real, sign slicer ({Br}x{Tr})"] = eq_carry_equal(
        torch, got, eqlms_scan_reference(xb, *(cb[k] for k in keys), 0.05))
    xr0, dr0 = xr[:, :EQ_CMP], dr[:, :EQ_CMP]
    got = eqrls_scan(xr0, dr0, r0["w"], r0["buf"], r0["P"], 0.99)
    p_rls, want = time_once(lambda: eqrls_scan_reference(
        xr0, dr0, r0["w"], r0["buf"], r0["P"], 0.99))
    cmp[f"rls (path's first {EQ_CMP})"] = eq_carry_equal(torch, got, want)
    check(bits_equal(torch, got[0], yr[:, :EQ_CMP]), "eqrls_scan: the first "
          "samples again differ from the path's")
    B32, T32 = EQ_RLS32
    x32, d32 = eq_streams(42, B32, T32, (1.0, 0.0, -0.25 + 0.2j, 0.0, 0.1),
                          0.04)
    x32, d32 = torch.from_numpy(x32).to(dev), torch.from_numpy(d32).to(dev)
    r32 = eqrls(32, lam=0.99, delta=0.1).init((B32,), device=dev)
    args32 = (x32, d32, r32["w"], r32["buf"], r32["P"], 0.99)
    cmp[f"rls L=32 ({B32}x{T32})"] = eq_carry_equal(
        torch, eqrls_scan(*args32), eqrls_scan_reference(*args32))
    for what, (same, err) in cmp.items():
        check(same, f"equalizer kernel vs plain, {what}: not bit-equal "
              f"(max|err| {err:.3e})")
    lms_err = max(e for w, (_, e) in cmp.items() if w.startswith("lms"))
    rls_err = max(e for w, (_, e) in cmp.items() if w.startswith("rls"))
    # times at the path's shape: 100 launches, twice; a lone channel's step
    cl = [c1[k] for k in keys]
    lms_ms = [time_ms(lambda: eqlms_scan(xd, *cl, 0.05), iters=100)
              for _ in range(2)]
    rl = (xr, dr, r0["w"], r0["buf"], r0["P"], 0.99)
    rls_ms = [time_ms(lambda: eqrls_scan(*rl), iters=100) for _ in range(2)]
    lens = (T // 4, T)
    one = {n: xd[:1, :n].contiguous() for n in lens}
    c1one = [t[:1] for t in cl]
    lms_step, lms_one = lone_row_step_us(
        lambda n: eqlms_scan(one[n], *c1one, 0.05), lens)
    onr = {n: (xr[:1, :n].contiguous(), dr[:1, :n].contiguous())
           for n in lens}
    rls_step, rls_one = lone_row_step_us(
        lambda n: eqrls_scan(*onr[n], r0["w"][:1], r0["buf"][:1],
                             r0["P"][:1], 0.99), lens)
    mhz = sm_mhz()
    # bounds: LMS 16 bytes a sample (x in, y out) and about 18 L + 12
    # float32 operations (the dot's and the update's 6 L and 8 L, the
    # tree's 2 L, |x|^2, the gain, the error); RLS 24 bytes (x, d in, y
    # out) and about 26 L^2 + 18 L (P x and buf^H P at 8 L^2 each with
    # their trees, the update of P at 10 L^2, y, den, k and w)
    bd_lms = bound(16 * B * T, (18 * L + 12) * B * T)
    bd_rls = bound(24 * B * T, (26 * 81 + 18 * 9) * B * T)
    lm, rm = sum(lms_ms) / 2, sum(rls_ms) / 2
    print(f"equalizers: the path at {B} channels (train {NT}, decision-"
          f"directed {T}; RLS {T}) {path_s:.2f} s host (builds included on "
          f"a first call); eqlms: decision errors after sample 200: "
          f"{wrong}, EVM worst {float(evm.max()):.2f} dB, mean "
          f"{float(evm.mean()):.2f} dB; eqrls: MSE after sample 1000 worst "
          f"{float(mse.max()):.2f} dB, mean {float(mse.mean()):.2f} dB, P "
          f"finite; launches eqlms_scan {lms_n}, eqrls_scan {rls_n}; "
          f"bit-equal to the plain versions on the card: "
          + "; ".join(cmp), flush=True)
    print(f"timing ({card}): eqlms_scan (L = {L}) at {B}x{T} "
          f"{lms_ms[0]:.4f}, {lms_ms[1]:.4f} ms, eqrls_scan (L = 9) "
          f"{rls_ms[0]:.4f}, {rls_ms[1]:.4f} ms (100 launches each); "
          f"bounds {bd_lms['bound_ms']:.5f} ms by {bd_lms['bound_by']} "
          f"({bd_lms['bound_ms'] / lm:.2%}) and {bd_rls['bound_ms']:.5f} ms "
          f"by {bd_rls['bound_by']} ({bd_rls['bound_ms'] / rm:.2%}); a lone "
          f"channel: eqlms_scan "
          + ", ".join(f"{n} steps {t:.4f} ms" for n, t in lms_one.items())
          + f": {lms_step * 1e3:.2f} ns a step (= {lms_step * mhz:.1f} "
          f"cycles at {mhz:.0f} MHz), the {B}-channel launch "
          f"{lm / (T * lms_step / 1e3):.3f} of its chain; eqrls_scan "
          + ", ".join(f"{n} steps {t:.4f} ms" for n, t in rls_one.items())
          + f": {rls_step * 1e3:.2f} ns a step (= {rls_step * mhz:.1f} "
          f"cycles), the {B}-channel launch {rm / (T * rls_step / 1e3):.3f} "
          f"of it; plain versions at {B}x{EQ_CMP}: eqlms {p_dd:.1f} ms, "
          f"eqrls {p_rls:.1f} ms", flush=True)
    common = {"route": "cuda", "replaces": None, "shape": [B, T],
              "plain_shape": [B, EQ_CMP], "library_ms": None}
    return [
        {"name": "eqlms_scan",
         "source": "liquid_dsp_tpu_torch/csrc/eqlms_scan.cu",
         "recurrence": "liquid_dsp_tpu/ops/equalize.py:48-86 (lax.scan)",
         "launches": lms_n, "max_abs_err": lms_err, "ms": lm,
         "ms_runs": lms_ms, "plain_ms": p_dd, **common, **bd_lms,
         "step_latency_us": lms_step, "chain_floor_ms": T * lms_step / 1e3},
        {"name": "eqrls_scan",
         "source": "liquid_dsp_tpu_torch/csrc/eqrls_scan.cu",
         "recurrence": "liquid_dsp_tpu/ops/equalize.py:125-151 (lax.scan)",
         "launches": rls_n, "max_abs_err": rls_err, "ms": rm,
         "ms_runs": rls_ms, "plain_ms": p_rls, **common, **bd_rls,
         "step_latency_us": rls_step, "chain_floor_ms": T * rls_step / 1e3}]


def mesh_devices(torch, dev, n):
    """n mesh devices: the cards in turn where there are several, else the
    one card (or the CPU of a rehearsal) n times."""
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if cards < 2:
        return [dev] * n
    return [torch.device("cuda", i % cards) for i in range(n)]


def mixed_ref64(torch, xs, taps, down=1, d=0):
    """complex128 reference on xs' device: the blocks xs [B, T] joined,
    mixed down by DPHI x n from phase 0 in closed form, then filtered by
    each of ``taps`` in turn from a zero state (FFT convolution) and kept
    at d::down.  Returns (the output [B, len / down], each stage's input
    in turn, for the FIR carries)."""
    x = torch.cat(xs, dim=-1).to(torch.complex128)
    n = torch.arange(x.shape[-1], dtype=torch.float64, device=x.device)
    y = x * torch.polar(torch.ones_like(n), -DPHI * n)
    ins = []
    for h in taps:
        ins.append(y)
        h = h.to(x.device, torch.float64)
        nfft = 1 << (y.shape[-1] + h.shape[0] - 2).bit_length()
        y = torch.fft.ifft(torch.fft.fft(y, n=nfft)
                           * torch.fft.fft(h, n=nfft))[..., :y.shape[-1]]
    return y[..., d::down], ins


def rel_err(torch, y, ref):
    """max |y - ref| / rms(ref) over complex tensors, in float64."""
    d = (y.to(torch.complex128) - ref.to(torch.complex128)).abs()
    return float(d.max() / ref.to(torch.complex128).abs().square().mean()
                 .sqrt())


def make_shard_rx_stream(rng):
    """The time-sharded receiver's input [PA_RX_B, NBLK * PA_RX_T] and the
    frames sent per channel [(start, header, payload), ...] in order.
    Every channel but the last PA_QUIET carries frames PA_GAP apart (at
    most 5 start in a shard's 8192 samples), and channel c one more,
    placed by c % 4: 300 samples before a shard boundary (it runs into
    the next shard's samples), on a shard boundary, 200 samples before a
    shard's emit window (hist before its boundary: the frame starts in
    one shard's window and ends in the next's), across a block boundary."""
    from liquid_dsp_tpu_torch.framing.frame64 import FRAME64_LEN, framegen64
    from liquid_dsp_tpu_torch.framing.stream_rx import STREAM_HIST
    T, Tl = PA_RX_T, PA_RX_T // PA_NT
    n = NBLK * T
    usable = n - STREAM_HIST - FRAME64_LEN     # emitted within the run
    x = np.zeros((PA_RX_B, n), np.complex64)
    sent = [[] for _ in range(PA_RX_B)]
    for ch in range(PA_RX_B - PA_QUIET):
        edge = int(rng.integers(0, NBLK)) * T + int(rng.integers(1, PA_NT)) * Tl
        starts = [min(usable, (edge - 300, edge, edge - STREAM_HIST - 200,
                               int(rng.integers(1, NBLK)) * T - 700)[ch % 4])]
        pos = int(rng.integers(0, 2000))
        while pos <= usable:
            if all(abs(pos - s0) >= PA_GAP[0] for s0 in starts):
                starts.append(pos)
            pos += int(rng.integers(*PA_GAP))
        for s0 in sorted(starts):
            h = rng.integers(0, 256, 8).astype(np.uint8)
            p = rng.integers(0, 256, 64).astype(np.uint8)
            x[ch, s0:s0 + FRAME64_LEN] = framegen64(h, p)
            sent[ch].append((s0, h, p))
    x += (0.01 * (rng.standard_normal(x.shape)
                  + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
    return x, sent


def step_ms(torch, fn, iters=10):
    """Mean ms per call of a step that may spread over several cards: the
    host clock over `iters` calls after 3 warm-up calls, every card
    synchronized before and after (CUDA events on one card would not wait
    for another's work)."""
    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    for _ in range(3):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / iters


def parallel_phase(torch, dev, card):
    """Phase 40: the mesh (parallel/), its device repeated on one card.
    Returns {kernel: (launches on its path here, max|err| against its
    plain version on the path's data)} for fir_real, codebook_argmax and
    mix_fir_decim."""
    import tempfile
    from liquid_dsp_tpu_torch import chain, fuse
    from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
    from liquid_dsp_tpu_torch.fec.device import (device_packet_finish,
                                                 qpacket_soft_decoder)
    from liquid_dsp_tpu_torch.framing.frame64 import framesync64_stream
    from liquid_dsp_tpu_torch.ops.fir import firfilt
    from liquid_dsp_tpu_torch.ops.kernels.codebook_argmax import (
        codebook_argmax, codebook_argmax_reference)
    from liquid_dsp_tpu_torch.ops.kernels.fir_real import (
        fir_real, fir_real_reference)
    from liquid_dsp_tpu_torch.ops.kernels.mix_fir_decim import (
        mix_fir_decim, mix_fir_decim_reference)
    from liquid_dsp_tpu_torch.ops.kernels.suppress_scan import suppress_scan
    from liquid_dsp_tpu_torch.ops.nco import nco
    from liquid_dsp_tpu_torch.ops.resample import msresamp
    from liquid_dsp_tpu_torch.parallel import (
        StagePipeline, framesync64_time_sharded, stream_mesh,
        time_shard_apply)
    from liquid_dsp_tpu_torch.runtime import StreamRunner

    mesh = stream_mesh(PA_NT, PA_NC,
                       devices=mesh_devices(torch, dev, PA_NT * PA_NC))
    tmesh = stream_mesh(PA_NT, devices=mesh_devices(torch, dev, PA_NT))
    distinct = len(set(mesh.devices.flat))
    print(f"parallel: mesh {mesh}: {PA_NC} (ch) x {PA_NT} (t) on "
          f"{distinct} distinct card(s) ({card})", flush=True)
    got = {}

    # the time-sharded chain: the mixer, then two FIRs on fir_real
    def make_chain(mix):
        firs = [firfilt(firdes_kaiser(64, 0.2, 60.0), backend="pallas"),
                firfilt(firdes_kaiser(57, 0.3, 60.0), backend="pallas")]
        mixer = [nco(dphi=DPHI, direction="down")] if mix else []
        return chain(*(mixer + firs)).to(dev)

    gen = torch.Generator(device=dev).manual_seed(40)
    xs = [torch.complex(torch.randn(PA_B, PA_T, generator=gen, device=dev),
                        torch.randn(PA_B, PA_T, generator=gen, device=dev))
          for _ in range(NBLK)]
    held = {}
    for mix in (True, False):
        p = make_chain(mix)
        step = time_shard_apply(p, mesh)
        c = p.init(batch_shape=(PA_B,), device=dev)
        ys, carries = [], [c]
        fir_real.launches = 0
        for x in xs:
            y, c = step(c, x)
            ys.append(y)
            carries.append(c)
        torch.cuda.synchronize()
        launches = fir_real.launches
        check(launches == 2 * PA_NT * PA_NC * NBLK, f"time-sharded chain: "
              f"fir_real launched {launches} times, want 2 x "
              f"{PA_NT * PA_NC} a block")
        c1, worst, equal = p.init(batch_shape=(PA_B,), device=dev), 0.0, True
        y1s = []
        for x, y in zip(xs, ys):
            y1, c1 = p(c1, x)
            check(y.shape == y1.shape and y.device == x.device,
                  f"time-sharded chain: output {tuple(y.shape)} on "
                  f"{y.device}")
            worst = max(worst, rel_err(torch, y, y1))
            equal = equal and torch.equal(y, y1)
            y1s.append(y1)
        c_worst = max(rel_err(torch, a, b)
                      for a, b in zip(carries[-1][-2:], c1[-2:]))
        if not mix:
            check(equal and c_worst == 0, f"time-sharded FIRs vs one "
                  f"device: output {worst:.3e}, carries {c_worst:.3e} of "
                  f"rms, not bit-equal")
            held[mix] = (worst, equal, c_worst)
            continue
        check(torch.equal(carries[-1][0]["theta"], c1[0]["theta"]),
              "time-sharded chain: the mixer's carried phase differs")
        # both against complex128: the outputs, and the FIR carries (the
        # last L - 1 samples of each FIR's input)
        ref, ins = mixed_ref64(torch, xs, [st.h for st in p.stages[1:]])
        e64 = [rel_err(torch, torch.cat(yy, dim=-1), ref) for yy in (ys, y1s)]
        c64 = [max(rel_err(torch, a, b[..., -a.shape[-1]:])
                   for a, b in zip(cc[1:], ins)) for cc in (carries[-1], c1)]
        del ref, ins, y1s
        check(e64[0] <= F64_RATIO * e64[1] and c64[0] <= F64_RATIO * c64[1],
              f"time-sharded chain vs complex128: output {e64[0]:.3e}, FIR "
              f"carries {c64[0]:.3e}; one device {e64[1]:.3e} and "
              f"{c64[1]:.3e} (at most {F64_RATIO} times)")
        got["fir_real"] = launches
        t_sh = step_ms(torch, lambda: step(carries[0], xs[0]), iters=10)
        t_1 = step_ms(torch, lambda: p(carries[0], xs[0]), iters=10)
        for what, fn in (("time-sharded", step), ("one-device", p)):
            profile_steps(torch, card, lambda: fn(carries[0], xs[0]), 3,
                          f"{what} chain step at {PA_B}x{PA_T}")
        held[mix] = (worst, equal, c_worst)
    # fir_real on one shard's input and carry (channel group 1, shard 2,
    # block 1), against its plain version
    Tl, G = PA_T // PA_NT, PA_B // PA_NC
    h = make_chain(False).stages[0].h
    xsh = xs[1][G:, 2 * Tl:3 * Tl]
    csh = xs[1][G:, 2 * Tl - (h.shape[0] - 1):2 * Tl]
    rows = torch.cat([xsh.real, xsh.imag]).contiguous()
    crow = torch.cat([csh.real, csh.imag]).contiguous()
    yk, yp = fir_real(rows, crow, h), fir_real_reference(rows, crow, h)
    fr_err = float((yk - yp).abs().max())
    fr_rel = fr_err / float(yp.square().mean().sqrt())
    check(fr_rel < TOL_FIR, f"fir_real on a shard: {fr_rel:.3e}")
    print(f"time-sharded chain: chain(nco, firfilt 64, firfilt 57) "
          f"(backend pallas) at {PA_B}x{PA_T}, {NBLK} carried blocks on the "
          f"{PA_NC}x{PA_NT} mesh against one device: max|err|/rms "
          f"{held[True][0]:.3e}, FIR carries {held[True][2]:.3e}, the "
          f"mixer's carried phase bit-equal; against complex128, sharded "
          f"{e64[0]:.3e} (carries {c64[0]:.3e}), one device {e64[1]:.3e} "
          f"({c64[1]:.3e}), ratio {e64[0] / e64[1]:.3f} (<= {F64_RATIO}); "
          f"the two FIRs alone bit-equal, carries too; fir_real launches "
          f"{got['fir_real']} (2 x {PA_NT * PA_NC} a block); fir_real on "
          f"shard 2 of group 1 (block 1, {rows.shape[0]} rows x {Tl}) vs "
          f"plain max|err| {fr_err:.3e}, of rms {fr_rel:.3e} (< {TOL_FIR}); "
          f"ms a block ({card}, {distinct} card(s)): sharded {t_sh:.4f}, "
          f"one device {t_1:.4f}", flush=True)

    # the time-sharded frame64 receiver, its frames decoded on the card
    t0 = time.perf_counter()
    x_np, sent = make_shard_rx_stream(np.random.default_rng(41))
    xr = torch.from_numpy(x_np).to(dev)
    del x_np
    t_gen = time.perf_counter() - t0
    T = PA_RX_T
    init, rstep = framesync64_time_sharded(T, tmesh,
                                           max_frames_per_shard=PA_RX_P)
    decode, _ = qpacket_soft_decoder(72, "crc24", "none", "golay2412",
                                     "qpsk")
    decode = decode.to(dev)
    finish = device_packet_finish(72, "crc24", "none", "golay2412").to(dev)
    c = init(batch_shape=(PA_RX_B,))
    rcarries, outs, decs = [c], [], []
    codebook_argmax.launches = 0
    suppress_scan.launches = 0
    for b in range(NBLK):
        out, c = rstep(c, xr[:, b * T:(b + 1) * T])
        decs.append(finish(decode(out.symbols)))
        outs.append(out)
        rcarries.append(c)
    torch.cuda.synchronize()
    got["codebook_argmax"] = codebook_argmax.launches
    got["suppress_scan"] = suppress_scan.launches
    check(got["codebook_argmax"] == NBLK, f"time-sharded receiver: "
          f"codebook_argmax launched {got['codebook_argmax']} times in "
          f"{NBLK} blocks")
    check(got["suppress_scan"] == NBLK, f"time-sharded receiver: "
          f"suppress_scan launched {got['suppress_scan']} times in {NBLK} "
          f"blocks (one fold over every shard's segments)")
    frames = [[] for _ in range(PA_RX_B)]
    most = 0
    for out, (buf, ok) in zip(outs, decs):
        check(out.valid.shape == (PA_RX_B, PA_NT * PA_RX_P),
              f"time-sharded receiver: {tuple(out.valid.shape)} slots")
        most = max(most, int(out.valid.reshape(PA_RX_B, PA_NT, PA_RX_P)
                             .sum(-1).max()))
        v, si = out.valid.cpu().numpy(), out.sample_index.cpu().numpy()
        buf, ok = buf.cpu().numpy().astype(np.uint8), ok.cpu().numpy()
        for ch, s in zip(*np.nonzero(v)):
            frames[ch].append((int(si[ch, s]), bool(ok[ch, s]),
                               buf[ch, s, :8], buf[ch, s, 8:]))
    check(most < PA_RX_P, f"time-sharded receiver: a shard kept {most} "
          f"candidates in {PA_RX_P} slots")
    n_ok = check_rx(frames, sent)
    # against the receiver on one device, slots enough for every shard's
    rx1 = framesync64_stream(T, max_frames=PA_NT * PA_RX_P).to(dev)
    c1 = rx1.init(batch_shape=(PA_RX_B,), device=dev)
    c10 = c1
    sym_err, n_same = 0.0, 0
    for b, out in enumerate(outs):
        o1, c1 = rx1(c1, xr[:, b * T:(b + 1) * T])
        v, v1 = out.valid.cpu().numpy(), o1.valid.cpu().numpy()
        si, si1 = out.sample_index.cpu().numpy(), o1.sample_index.cpu().numpy()
        for ch in range(PA_RX_B):
            a = {int(i): k for k, i in zip(np.nonzero(v[ch])[0],
                                            si[ch][v[ch]])}
            a1 = {int(i): k for k, i in zip(np.nonzero(v1[ch])[0],
                                             si1[ch][v1[ch]])}
            check(set(a) == set(a1), f"time-sharded receiver block {b} "
                  f"channel {ch}: {sorted(a)} against one device's "
                  f"{sorted(a1)}")
            for i in a:
                sym_err = max(sym_err, float(
                    (out.symbols[ch, a[i]] - o1.symbols[ch, a1[i]])
                    .abs().max()))
                n_same += 1
    for key in ("buf", "base", "last_end"):
        check(torch.equal(rcarries[-1][key], c1[key]),
              f"time-sharded receiver: carry {key} differs from one device's")
    check(sym_err <= TOL_SHARD_SYM, f"time-sharded receiver: symbols "
          f"{sym_err:.3e} from one device's (> {TOL_SHARD_SYM})")
    cw = decode.soft_bits(outs[1].symbols).reshape(-1, 24).contiguous()
    idx_k = codebook_argmax(cw, decode.bip)
    idx_p = codebook_argmax_reference(cw, decode.bip)
    torch.cuda.synchronize()
    check(torch.equal(idx_k, idx_p), f"codebook_argmax on the time-sharded "
          f"receiver's rows: {int((idx_k != idx_p).sum())} of {cw.shape[0]} "
          f"differ")
    t_rsh = step_ms(torch, lambda: rstep(rcarries[0], xr[:, :T]), iters=5)
    t_r1 = step_ms(torch, lambda: rx1(c10, xr[:, :T]), iters=5)
    profile_steps(torch, card, lambda: rstep(rcarries[0], xr[:, :T]), 3,
                  f"time-sharded receiver step at {PA_RX_B}x{T}")
    hold_folds(torch, lambda: rstep(rcarries[1], xr[:, T:2 * T]),
               "the time-sharded receiver's block 1")
    print(f"time-sharded receiver: framesync64_time_sharded at "
          f"{PA_RX_B}x{T} on {PA_NT} shards of {T // PA_NT}, P "
          f"{PA_RX_P} a shard, {NBLK} carried blocks: {n_ok} of "
          f"{sum(len(s) for s in sent)} frames (some across shard, emit "
          f"window and block boundaries) decoded once, in order, crc_ok, "
          f"bytes equal, sample_index within 2, through "
          f"qpacket_soft_decoder on the card; {PA_QUIET} noise-only "
          f"channels: 0; at most {most} kept a shard (< {PA_RX_P}); against "
          f"framesync64_stream on one device: the same {n_same} "
          f"sample_index, symbols max|err| {sym_err:.3e} (<= "
          f"{TOL_SHARD_SYM}), the carry equal; suppress_scan launches "
          f"{got['suppress_scan']}; codebook_argmax launches "
          f"{got['codebook_argmax']}, bit-equal to plain on block 1's "
          f"{cw.shape[0]} rows; ms a block ({card}, {distinct} card(s)): "
          f"sharded {t_rsh:.3f}, one device {t_r1:.3f} (the decode not "
          f"included); capture made in {t_gen:.1f} s", flush=True)
    del xr, outs, decs, rcarries

    # StagePipeline: multirate_rx's two stages, stage 0 on mix_fir_decim
    make_rx, _ = multirate_paths()
    pdevs = mesh_devices(torch, dev, 2) if distinct > 1 else [dev]
    pipe = StagePipeline(list(make_rx().stages), devices=pdevs,
                         batch_shape=(PA_B,))
    mix_fir_decim.launches = 0
    yp = [pipe.feed(x) for x in xs]
    torch.cuda.synchronize()
    got["mix_fir_decim"] = mix_fir_decim.launches
    check(got["mix_fir_decim"] == NBLK, f"StagePipeline: mix_fir_decim "
          f"launched {got['mix_fir_decim']} times in {NBLK} blocks")
    mono = make_rx().to(dev)
    cm = mono.init(batch_shape=(PA_B,), device=dev)
    cm0 = cm
    for x, y in zip(xs, yp):
        y1, cm = mono(cm, x)
        check(torch.equal(y.to(dev), y1), "StagePipeline: output differs "
              "from the same stages chained on one device")
    front = pipe.procs[0]
    cf = front.init(batch_shape=(PA_B,), device=pdevs[0])
    x0 = xs[0].to(pdevs[0])
    yk = front(cf, x0)[0]
    ref = mix_fir_decim_reference(
        x0.real.contiguous(), x0.imag.contiguous(), cf["tr"], cf["ti"],
        cf["theta"], front.ramp_c, front.ramp_s, front.taps,
        down=front.down, sgn=front.sgn, dphi=front.dphi)
    mfd_err, mfd_rel = complex_err((yk.real, yk.imag), ref)
    check(mfd_rel < TOL_F32, f"mix_fir_decim on the pipeline's stage 0: "
          f"{mfd_rel:.3e}")
    t_pipe = step_ms(torch, lambda: pipe.feed(xs[0]), iters=10)
    t_mono = step_ms(torch, lambda: mono(cm0, xs[0]), iters=10)
    print(f"StagePipeline: multirate_rx's stages (kernel_fuse(fuse(nco, "
          f"firfilt 64, firdecim 4)), msresamp(0.375)) on {pdevs} at "
          f"{PA_B}x{PA_T}, {NBLK} blocks: bit-equal to the chain on one "
          f"device, output {tuple(yp[0].shape)}; mix_fir_decim launches "
          f"{got['mix_fir_decim']}, vs plain on stage 0's block 0 "
          f"max|err| {mfd_err:.3e}, of rms {mfd_rel:.3e} (< {TOL_F32}); ms "
          f"a block ({card}): pipeline {t_pipe:.4f}, chain {t_mono:.4f}",
          flush=True)
    del yp, pipe, mono

    # StreamRunner(mesh=...): the fused headline chain, time-sharded
    def fused(mix=True):
        mixer = [nco(dphi=DPHI, direction="down")] if mix else []
        return fuse(chain(*mixer, firfilt(firdes_kaiser(64, 0.2, 60.0)),
                          firfilt(firdes_kaiser(57, 0.3, 60.0)),
                          msresamp(0.5, 60.0)))
    r = StreamRunner(fused(), batch_shape=(PA_B,), mesh=tmesh)
    r1 = StreamRunner(fused(), batch_shape=(PA_B,), device=dev)
    check(r.device == tmesh.home, f"StreamRunner(mesh): device {r.device}")
    with tempfile.TemporaryDirectory() as tmpdir:
        ck = os.path.join(tmpdir, "state.npz")
        ys, ys1, worst = [], [], 0.0
        for k, x in enumerate(xs):
            ys.append(r(x))
            ys1.append(r1(x))
            worst = max(worst, rel_err(torch, ys[-1], ys1[-1]))
            if k == 1:
                r.save(ck)
        r2 = StreamRunner(fused(), batch_shape=(PA_B,), mesh=tmesh)
        r2.load(ck)
        check(r2.blocks_processed == 2 and torch.equal(r2(xs[2]), ys[2]),
              "StreamRunner(mesh): the resumed block differs")
    # the fused chain is the mixer, then one FusedFIR of both FIRs and the
    # resampler's decimation
    ff = r1.proc.stages[1]
    check(ff.lti is not None and len(r1.proc.stages) == 2,
          f"StreamRunner(mesh): the fused chain is {r1.proc}")
    ref, _ = mixed_ref64(torch, xs, [ff.h], ff.down, ff.d)
    r64 = [rel_err(torch, torch.cat(yy, dim=-1), ref) for yy in (ys, ys1)]
    del ref, ys, ys1
    check(r64[0] <= F64_RATIO * r64[1], f"StreamRunner(mesh) vs complex128: "
          f"{r64[0]:.3e}, without a mesh {r64[1]:.3e} (at most {F64_RATIO} "
          f"times)")
    rn = StreamRunner(fused(False), batch_shape=(PA_B,), mesh=tmesh)
    rn1 = StreamRunner(fused(False), batch_shape=(PA_B,), device=dev)
    check(all(torch.equal(rn(x), rn1(x)) for x in xs),
          "StreamRunner(mesh) without the mixer: not bit-equal to the "
          "runner without a mesh")
    t_r = step_ms(torch, lambda: r(xs[0]), iters=10)
    t_n = step_ms(torch, lambda: r1(xs[0]), iters=10)
    print(f"StreamRunner(mesh=): fuse(chain(nco, firfilt 64, firfilt 57, "
          f"msresamp(0.5))) on {PA_NT} time shards at {PA_B}x{PA_T}, "
          f"{NBLK} blocks, a checkpoint after block 2 and a resume "
          f"(bit-equal); against the runner without a mesh max|err|/rms "
          f"{worst:.3e}; against complex128 mesh {r64[0]:.3e}, no mesh "
          f"{r64[1]:.3e}, ratio {r64[0] / r64[1]:.3f} (<= {F64_RATIO}); "
          f"without the mixer bit-equal to no mesh; ms a block ({card}): "
          f"mesh {t_r:.4f}, no mesh {t_n:.4f}", flush=True)
    return {"fir_real": (got["fir_real"], fr_err),
            "codebook_argmax": (got["codebook_argmax"], 0.0),
            "suppress_scan": (got["suppress_scan"], 0.0),
            "mix_fir_decim": (got["mix_fir_decim"], mfd_err)}


def same_bits(torch, a, b):
    """Trees of tensors (dicts, tuples, NamedTuples) equal bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_bits(torch, a[k], b[k])
                                            for k in a)
    if isinstance(a, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same_bits(torch, u, v) for u, v in zip(a, b)))
    return a.dtype == b.dtype and bits_equal(torch, a, b)


def scan_blocks_phase(torch, dev, card):
    """Phase 43: Proc.scan_blocks on the card, the headline chain and the
    frame64 stream receiver, each against as many forward calls.  Returns
    {"mix_fir_decim": (launches in the chain's scan, max|err| against the
    plain version), "suppress_scan": launches in the receiver's scan}."""
    from liquid_dsp_tpu_torch import chain, fuse, kernel_fuse, planar
    from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
    from liquid_dsp_tpu_torch.framing.frame64 import (FRAME64_LEN,
                                                      framesync64_stream)
    from liquid_dsp_tpu_torch.ops.fir import firfilt
    from liquid_dsp_tpu_torch.ops.kernels.mix_fir_decim import (
        mix_fir_decim, mix_fir_decim_reference)
    from liquid_dsp_tpu_torch.ops.kernels.suppress_scan import suppress_scan
    from liquid_dsp_tpu_torch.ops.nco import nco
    from liquid_dsp_tpu_torch.ops.resample import msresamp

    # 43. the headline chain, as phase 3 builds it, over NBLK blocks
    proc = planar(kernel_fuse(fuse(chain(
        nco(dphi=DPHI, direction="down"),
        firfilt(firdes_kaiser(64, 0.2, 60.0)),
        firfilt(firdes_kaiser(57, 0.3, 60.0)),
        msresamp(0.5, 60.0))))).to(dev)
    kern = proc.inner
    gen = torch.Generator(device=dev).manual_seed(43)
    xs = (torch.randn(NBLK, B, T, generator=gen, device=dev),
          torch.randn(NBLK, B, T, generator=gen, device=dev))
    mix_fir_decim.launches = 0
    y, carry = proc.scan_blocks(xs, batch_shape=(B,), device=dev)
    torch.cuda.synchronize()
    launches = mix_fir_decim.launches
    check(isinstance(y, tuple) and all(
        p.shape == (NBLK, B, T // 2) and p.dtype == torch.float32
        and bool(torch.isfinite(p).all()) for p in y),
        f"scan_blocks: output {[tuple(p.shape) for p in y]}")
    check(launches == NBLK, f"scan_blocks: mix_fir_decim launched "
          f"{launches} times over {NBLK} blocks")
    c0 = proc.init(batch_shape=(B,), device=dev)

    def forwards():
        c, ys = c0, []
        for n in range(NBLK):
            yn, c = proc(c, (xs[0][n], xs[1][n]))
            ys.append(yn)
        return ys, c

    ys, c = forwards()
    check(all(torch.equal(y[p], torch.stack([o[p] for o in ys]))
              for p in (0, 1)), "scan_blocks: the headline chain's output "
          "differs from its forward calls")
    check(carry.keys() == c.keys() and all(torch.equal(carry[k], c[k])
                                           for k in c),
          "scan_blocks: the headline chain's carry differs from its "
          "forward calls'")
    err, rel = complex_err((y[0][0], y[1][0]), mix_fir_decim_reference(
        xs[0][0], xs[1][0], c0["tr"], c0["ti"], c0["theta"], kern.ramp_c,
        kern.ramp_s, kern.taps, down=kern.down, sgn=kern.sgn,
        dphi=kern.dphi))
    check(rel < TOL_F32, f"scan_blocks: block 0 vs plain {rel:.3e}")
    del ys, c
    scan_ms = time_ms(lambda: proc.scan_blocks(xs, carry=c0), iters=10)
    fwd_ms = time_ms(forwards, iters=10)
    del xs, y, carry

    # the frame64 stream receiver over 2 blocks: a NamedTuple output
    x_np, sent = make_rx_stream(np.random.default_rng(43))
    xb = torch.from_numpy(np.ascontiguousarray(
        x_np[:, :2 * RX_T].reshape(RX_B, 2, RX_T).transpose(1, 0, 2))
    ).to(dev)
    del x_np
    rx = framesync64_stream(RX_T).to(dev)
    suppress_scan.launches = 0
    out, rc = rx.scan_blocks(xb, batch_shape=(RX_B,), device=dev)
    torch.cuda.synchronize()
    ss_launches = suppress_scan.launches
    check(ss_launches == 2, f"scan_blocks: suppress_scan launched "
          f"{ss_launches} times over 2 receiver blocks")
    outs, c = [], rx.init(batch_shape=(RX_B,), device=dev)
    for n in range(2):
        o, c = rx(c, xb[n])
        outs.append(o)
    check(type(out) is type(outs[0]) and all(
        same_bits(torch, leaf, torch.stack([o[k] for o in outs]))
        for k, leaf in enumerate(out)), "scan_blocks: the receiver's "
          "stacked output differs from its forward calls'")
    check(same_bits(torch, rc, c), "scan_blocks: the receiver's carry "
          "differs from its forward calls'")
    n_valid = int(out.valid.sum())
    n_sent = sum(s0 + FRAME64_LEN <= 2 * RX_T
                 for per in sent for s0, _, _ in per)
    check(0 < n_valid <= n_sent, f"scan_blocks: {n_valid} frames valid, "
          f"{n_sent} sent whole in 2 blocks")
    print(f"scan_blocks ({card}): the headline chain over {NBLK} blocks of "
          f"{B}x{T} planes, y {(NBLK, B, T // 2)} x 2 planes and carry "
          f"torch.equal to {NBLK} forward calls; mix_fir_decim "
          f"launches {launches}; block 0 vs plain max|err| {err:.3e}, "
          f"max|err|/rms {rel:.3e} (< {TOL_F32}); scan {scan_ms:.4f} ms, "
          f"{NBLK} forward calls {fwd_ms:.4f} ms (CUDA events, 10 runs "
          f"after 3); framesync64_stream over 2 blocks of {RX_B}x{RX_T}: "
          f"{type(out).__name__}'s {len(out)} leaves stacked on axis 0 and "
          f"the carry equal bit for bit to 2 forward calls, {n_valid} "
          f"frames valid ({n_sent} sent whole in the 2 blocks), "
          f"suppress_scan launches {ss_launches}", flush=True)
    return {"mix_fir_decim": (launches, err), "suppress_scan": ss_launches}


def iir_reference64(q, x):
    """An IIRFilt `q`'s output in float64/complex128 scipy on rows x [b, n]
    (complex) from zero state: sosfilt for a cascade, lfilter for the
    transfer-function form, on the filter's own float32 or complex64
    coefficients."""
    from scipy.signal import lfilter, sosfilt
    if q.sos:
        sos = np.concatenate([q.B.cpu().numpy(), q.A.cpu().numpy()], axis=1)
        return sosfilt(sos.astype(np.result_type(sos, np.float64)), x,
                       axis=-1)
    return lfilter(q.b.cpu().numpy().astype(np.complex128),
                   q.a.cpu().numpy().astype(np.complex128), x, axis=-1)


if __name__ == "__main__":
    main()
