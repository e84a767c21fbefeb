#!/usr/bin/env python3
"""Times of the port's two FIR kernels, `mix_fir_decim` and `fir_real`, on
one CUDA card, and of the steps of the three paths, for a checkout given
by --root:

    python3 chip_kernel_bench.py [--root DIR] [--tag NAME] [--no-steps] [--sass DIR]
    python3 chip_kernel_bench.py --ffma-rate
    python3 chip_kernel_bench.py --mma-probe
    python3 chip_kernel_bench.py --viterbi [--root DIR] [--tag NAME] [--sass DIR]
    python3 chip_kernel_bench.py --latency
    python3 chip_kernel_bench.py --iir [--root DIR] [--tag NAME] [--sass DIR]
    python3 chip_kernel_bench.py --cvsd [--root DIR] [--tag NAME] [--sass DIR]
    python3 chip_kernel_bench.py --eq [--root DIR] [--tag NAME] [--vs DIR]
    python3 chip_kernel_bench.py --fused [--root DIR] [--tag NAME] [--vs DIR]
    python3 chip_kernel_bench.py --fold [--root DIR] [--tag NAME] [--vs DIR]
                                 [--sass DIR]
    python3 chip_kernel_bench.py --pscan [--root DIR] [--tag NAME] [--vs DIR]
                                 [--sass DIR]

With two checkouts (this one and, say, `git archive` of its parent unpacked
into a directory that .gitignore lists) run it in turns, one after the other,
on one card: parent, change, change, parent.  It uses only what both
checkouts have: the two wrappers with their plain versions, and the stream
makers, the timer and the profiler table of that checkout's chip_smoke.py.

  * ptxas's registers and spills for every instance of the two kernels;
  * mix_fir_decim at the headline shape, 64 x 262144 with the chain's 144
    fused taps and down 2, f32 and bf16 planes, against the plain version
    (max|err|/rms), and at down 1, 4 and 8 with the same taps;
  * fir_real at 128 rows x 262144 with 144 taps against the plain version,
    and at 13 and 1024 taps;
  * the headline step planar(kernel_fuse(fuse(chain))) at 64 x 262144;
  * unless --no-steps: the symtrack_stream step at 256 x 32768 and the
    framesync64_stream_full step at 128 x 32768 (neither launches these
    kernels), each timed (CUDA events) and under torch.profiler;
  * with --sass DIR: cuobjdump's SASS of the headline instances of the two
    kernels into DIR/sass_<tag>.txt.

With --ffma-rate it measures instead what the float32 bound of these
kernels rests on: the card's rate of float32 multiply-adds per
clock and SM sub-partition (the data sheet's 67 TFLOP/s is 1.0 at
1.98 GHz) in a loop of independent `acc[k] = fma(a, b, acc[k])` where two,
one or none of the three register operands repeat from the instruction
before, at 4 to 32 warps per SM.

With --mma-probe it builds fir_real's function as a product on the tensor
cores (mma.sync in TF32, each operand split in two, three products) and
prints its error and its time beside the port's kernel: the measurement
behind the choice of the ordinary cores for the two FIR kernels.

With --latency it measures the cycles of one instruction on a dependent
chain, one warp alone (clock64): FADD, FMNMX, IMAD, SHFL.IDX, REDUX.MAX
and the pair REDUX.MAX, REDUX.MIN with its FMNMX, the instructions on
viterbi_acs's chain; FMUL, a FADD-FMUL pair and iir_scan's one-pole
DF2T step (FADD, FMUL, FADD), the IIR kernels' chains; FSETP + FSEL,
and one whole step of cvsd_scan's decode and of its encode (every
instruction of the step, no memory), the CVSD chains' floor.

With --viterbi it times only `viterbi_acs`, for the checkout given by
--root: v27 at 512 codewords x 68 bytes (the GMSK receiver's shape), v27
and v29 at 256 x 64 bytes (tools/bench_viterbi.py's), each over 200
launches and twice, the same v27 launch with nout = 0 (the traceback's
share where the kernel skips it), and one codeword at two lengths (v27:
68 and 400 bytes, v29: 68 and 120) for one step's latency (the slope) in
us and in cycles at the card's clock;
with --sass DIR, cuobjdump's SASS of its kernels into
DIR/sass_viterbi_<tag>.txt.

With --iir it times only the two IIR recurrence kernels, for the
checkout given by --root: `iir_scan` at 64 x 262144 with the shadowing's
one pole (analog_tx's shape) and at 128 plane rows x 262144 with the
order-7 Butterworth's 4 sections; `iir_block_state` at analog_rx's three
shapes (128 x 2048 blocks x 8 states, 64 x 2048 x 4, 64 x 512 x 1, each
with its filter's own M = A^128) and at 64 x 2048 with 16 and 32 states;
each over 100 launches and twice, with a lone row's step from the slope
between two lengths, its cycles at the card's maximum SM clock beside the
chain's estimate (FADD 4.5 and SHFL 26 cycles, --latency), the kernel's
device time per launch (torch.profiler: a launch shorter than the
wrapper's host work is timed by the host over 100 calls) and how many
times a lone row's loop that is; ptxas's registers, shared
memory and spills for every instance of both kernels first.  A checkout
whose kernel refuses an instance (more than 8 states before the lane per
state) prints "not taken" for it.  With --sass DIR, cuobjdump's SASS of
the paths' instances into DIR/sass_iir_<tag>.txt.

With --cvsd it times only `cvsd_scan`, for the checkout given by
--root: encode and decode at 1024 streams x 32768 samples, each over 100
launches and twice, with the device time per launch (torch.profiler), and
a lone row of each at 8192 and 32768 samples for one step's time (the
slope) in ns and in cycles at the card's maximum SM clock, beside the
chain's estimate (--latency's whole step, measured in the same run), and
how many times a lone row's loop the 1024-row launch takes; ptxas's
registers, shared memory and spills first.  For a source that takes its
rows per block as a macro (CVSD_ROWS) it builds it again at 1, 2, 4, 8
and 16 rows and times each beside the library's outputs.  With --sass DIR,
cuobjdump's SASS of its kernels into DIR/sass_cvsd_<tag>.txt.

With --eq it times only the two equalizer kernels, for the checkout given
by --root: `eqlms_scan` at 256 x 32768, L = 13, decision-directed, and
`eqrls_scan` at 256 x 32768, L = 9, each over 20 launches and twice, with
a lone channel's step (the slope between 8192 and 32768 samples) in ns and
cycles at the card's maximum SM clock, the library's build time, and the
ptxas registers and spills and the SASS instruction count (cuobjdump) of
the path's instance of each; then, for a source that takes its steps a
loop turn as a build macro (EQLMS_UNROLL at 2, 4, 8 and 0, the whole
tile; EQRLS_UNROLL at 2, 4 and 8), each kernel rebuilt at each setting
(all nvcc at once): ptxas, SASS instructions and its local loads and
stores, time against the library's outputs (equal or not) and a lone
channel's step (not with --no-variants).  The
last line is `EQ_RESULT {json}`.  With --vs DIR it runs that for DIR and
for this checkout in turns, each in its own process (DIR, this, this, DIR;
the variants on the first of this checkout's turns), and prints both
checkouts' times side by side:

    python3 chip_kernel_bench.py --eq --vs build/parent

With --fused it runs, for the checkout given by --root, `pll_lms` on
seeded slots (chip_smoke.py's `synth_slots`: 256 channels x 12288 slots,
a sixth valid, qpsk at L = 13 and qam16 at L = 32) over 20 launches and
twice, and saves its outputs and state; and where the checkout has the
fused kernel, `symsync_pll_lms` per 4096-step chunk at 256 channels on a
tracker's own inputs (a QPSK stream after 8192 samples) against the
sequential route's kernels on the same chunk (fused, sequential, in
turns), both tracker routes' steps and symsync(k=2, m=5) alone at 256 x
32768, and each route's step under torch.profiler (device ms,
operations, `symsync_pll_lms` launches a block, the convolutions' ms);
where the fused kernel takes the input planes, also a whole block in its
one launch at 32 (the full bank), 8, 4 and 2 rows a step (with the
misses) and
`branch_bank` against F.conv1d on that block.  The last line is
`FUSED_RESULT {json}`.  With --vs DIR it runs that for DIR and for this
checkout in turns (DIR, this, this, DIR), each in its own process, and
prints the two checkouts' `pll_lms` outputs against each other (largest
difference of y, decisions and every state leaf equal or not) and their
times side by side:

    python3 chip_kernel_bench.py --fused --vs build/parent

With --fold it times, for the checkout given by --root, the paths of the
suppression fold and of LDPC belief propagation: the frame64 receiver's
step at 128 x 32768 and the OFDM flexframe receiver's (chip_smoke.py's
streams, block 1 from the carry after block 0), and one
ldpc_decoder_device decode of 4096 rows of n = 648 at 50 iterations in
each mode; each twice by CUDA events and under torch.profiler (device
ms, operations, busy share).  Then the two kernels alone: suppress_scan
on each step's own fold (device us a launch, the keep mask alone and,
where the checkout ranks in the launch, with the ranking of the first
P), ldpc_bp with its messages out and, where the checkout has it, in the
decoder's form (decisions and parity out).  With --sass DIR their SASS
goes there, with the floor that tanhf, logf, expf and atanhf set on
ldpc_bp (their instructions counted in probe kernels' SASS).  The last
line is `FOLD_RESULT {json}`.  With --vs DIR it runs that for DIR and
for this checkout in turns (DIR, this, this, DIR), each in its own
process (--sass on the first turn of each), and prints both side by
side:

    python3 chip_kernel_bench.py --fold --vs build/parent [--sass DIR]

With --pscan it times, for the checkout given by --root, the three ways
the port filters a cascade of second-order sections on the card, on the
same filter and rows: `iir_pscan` (where the checkout has it), `iir_scan`
and the block form, at 128 plane rows x 262144 samples (a 64 x 262144
complex block's planes) for butter 7 at 0.2 (4 sections, analog_rx's
first stage) and butter 16 (8 sections), and on 64 complex rows for a
complex-coefficient cascade (butter 5 at 0.1 shifted by 0.6 rad/sample,
pscan and scan); each kernel over 100 launches (iir_scan 20) and twice,
with iir_pscan's device time a launch (torch.profiler) and a lone row's,
and iir_pscan held bit for bit to the checkout's plain version (3 rows
of 40000 from a random carry); then a 64 x 262144 complex block through
iirfilt_sos(butter 7) under each backend the checkout takes (20 calls,
twice); ptxas's registers and spills of iir_pscan's instances first;
with --sass DIR, cuobjdump's SASS
of both instances into DIR/sass_pscan_<tag>.txt and each instance's
count of instructions by kind (barriers, shared loads and stores, cp.async
copies, shuffles, float multiplies, adds, fused multiply-adds and selects,
branches).  The last line is `PSCAN_RESULT
{json}`.  With --vs DIR it runs that for DIR and for this checkout in
turns (DIR, this, this, DIR), each in its own process, and prints both
side by side:

    python3 chip_kernel_bench.py --pscan --vs build/parent

Every line names the card and its power limit.
"""
import argparse
import os
import subprocess
import sys
import time

import numpy as np


FFMA_RATE_SRC = r"""
#include <cuda_runtime.h>
// REPEAT 2: acc[k] = fma(a, b, acc[k]); 1: fma(a, b[k], acc[k]);
// 0: fma(a[k'], b[k''], acc[k])
constexpr int NACC = 16;
extern "C" __global__ void __launch_bounds__(128)
ffma_rate(const float* __restrict__ in, float* __restrict__ out, int iters) {
  float a[NACC], b[NACC], acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    a[k] = in[threadIdx.x + k];
    b[k] = in[threadIdx.x + 64 + k];
    acc[k] = in[threadIdx.x + 128 + k];
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int k = 0; k < NACC; ++k) {
#if REPEAT == 2
        acc[k] = __fmaf_rn(a[0], b[0], acc[k]);
#elif REPEAT == 1
        acc[k] = __fmaf_rn(a[u & 1], b[k], acc[k]);
#else
        acc[k] = __fmaf_rn(a[(k + u) % NACC], b[(k + 3 * u + 1) % NACC], acc[k]);
#endif
      }
    }
  }
  float t = 0.f;
#pragma unroll
  for (int k = 0; k < NACC; ++k) t += acc[k];
  out[blockIdx.x * 128 + threadIdx.x] = t;
}
extern "C" int ffma_rate_launch(const void* in, void* out, int blocks,
                                int iters, void* stream) {
  ffma_rate<<<blocks, 128, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, iters);
  return (int)cudaGetLastError();
}
"""
LATENCY_SRC = r"""
// --latency: cycles of one instruction on a dependent chain, one warp
// alone on the card (clock64 around ITERS chained instances).
#include <cuda_runtime.h>
constexpr int ITERS = 4096;
constexpr unsigned FULL = 0xffffffffu;
template <int OP>
__global__ void chain(const float* __restrict__ in, long long* __restrict__ cyc,
                      float* __restrict__ out) {
  const int lane = threadIdx.x;
  float v = in[lane], w = in[32 + lane];
  int k = __float_as_int(v);
  const int src = (lane + 1) & 31;
  // the one-pole DF2T step of iir_scan (OP 8): the input x and its two
  // products are off the chain; s -> y (FADD) -> a1*y (FMUL) -> s (FADD)
  const float x = w, b0x = __fmul_rn(0.25f, x), b1x = __fmul_rn(0.5f, x);
  float s = v;
  // cvsd_scan's steps (OP 10, 11): delta, v1, the encoder's history and
  // its two agrees (num_bits 3: the history's last bit)
  float dl = 0.01f + 0.5f * w, v1 = 0.f;
  unsigned hist = static_cast<unsigned>(lane);
  bool pa1 = false, pa0 = true;
  const long long t0 = clock64();
#pragma unroll 16
  for (int it = 0; it < ITERS; ++it) {
    if (OP == 0) v = __fadd_rn(v, w);                      // FADD
    if (OP == 1) v = fmaxf(w, -v);                         // FMNMX
    if (OP == 2) k = k * 3 + lane;                         // IMAD
    if (OP == 3) v = __shfl_sync(FULL, v, src);            // SHFL.IDX
    if (OP == 4) k = __reduce_max_sync(FULL, k) ^ lane;    // REDUX + LOP3
    if (OP == 5) {                                         // the step's M
      const int hi = __reduce_max_sync(FULL, k);
      const int lo = __reduce_min_sync(FULL, k);
      k = __float_as_int(fmaxf(__int_as_float(hi), __int_as_float(lo))) ^ lane;
    }
    if (OP == 6) v = __fmul_rn(v, w);                      // FMUL
    if (OP == 7) v = __fmul_rn(__fadd_rn(v, w), w);        // FADD, FMUL
    if (OP == 8) {                                         // a DF2T step
      const float y = __fadd_rn(b0x, s);
      s = __fsub_rn(b1x, __fmul_rn(-0.9f, y));
      v = y;
    }
    if (OP == 9) v = v <= w ? b0x : b1x;                   // FSETP + FSEL
    if (OP == 10) {            // a cvsd decode step: three chains of three
      const float kk = (it & 1) ? 1.5f : 0.6666667f;
      const float sg = (it & 2) ? 1.0f : -1.0f;
      dl = fminf(fmaxf(__fmul_rn(dl, kk), 0.01f), 1.0f);
      s = fminf(fmaxf(__fmaf_rn(sg, dl, s), -1.0f), 1.0f);
      const float yt = __fadd_rn(s, v);
      v = __fadd_rn(__fmaf_rn(1.9305f, yt, -s), v1);
      v1 = __fmul_rn(-0.9405f, yt);
    }
    if (OP == 11) {            // a cvsd encode step: both outcomes, a select
      const float y = (it & 1) ? w : -w;
      const float dz = fminf(__fmul_rn(dl, 1.5f), 1.0f);
      const float dr = fmaxf(__fmul_rn(dl, 0.6666667f), 0.01f);
      const float d1 = pa1 ? dz : dr, d0 = pa0 ? dz : dr;
      const float r1 = fminf(__fadd_rn(s, d1), 1.0f);
      const float r0 = fmaxf(__fsub_rn(s, d0), -1.0f);
      const unsigned h = hist & 1u;
      const bool n11 = h == 1u, n00 = h == 0u, bit = s <= y;
      s = bit ? r1 : r0;
      dl = bit ? d1 : d0;
      hist = (hist << 1) | static_cast<unsigned>(bit);
      pa1 = bit && n11;
      pa0 = !bit && n00;
    }
  }
  const long long t1 = clock64();
  out[lane] = v + s + dl + v1 + __int_as_float(k) + static_cast<float>(hist);
  if (lane == 0) cyc[OP] = t1 - t0;
}
// the SM clock a kernel sees: `blocks` warps each spin n cycles (clock64),
// timed by the host's CUDA events
__global__ void spin(long long n, long long* __restrict__ out) {
  const long long t0 = clock64();
  long long t = t0;
  while (t - t0 < n) t = clock64();
  if (threadIdx.x == 0) out[blockIdx.x] = t - t0;
}
extern "C" int spin_launch(long long n, int blocks, void* out, void* stream) {
  spin<<<blocks, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
extern "C" int latency_launch(const void* in, void* cyc, void* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const float*>(in);
  auto c = static_cast<long long*>(cyc);
  auto o = static_cast<float*>(out);
  chain<0><<<1, 32, 0, s>>>(i, c, o);
  chain<1><<<1, 32, 0, s>>>(i, c, o);
  chain<2><<<1, 32, 0, s>>>(i, c, o);
  chain<3><<<1, 32, 0, s>>>(i, c, o);
  chain<4><<<1, 32, 0, s>>>(i, c, o);
  chain<5><<<1, 32, 0, s>>>(i, c, o);
  chain<6><<<1, 32, 0, s>>>(i, c, o);
  chain<7><<<1, 32, 0, s>>>(i, c, o);
  chain<8><<<1, 32, 0, s>>>(i, c, o);
  chain<9><<<1, 32, 0, s>>>(i, c, o);
  chain<10><<<1, 32, 0, s>>>(i, c, o);
  chain<11><<<1, 32, 0, s>>>(i, c, o);
  return static_cast<int>(cudaGetLastError());
}
"""
MMA_PROBE_SRC = r"""
// fir_real as a product on the tensor cores, for --mma-probe: per warp
// Y[m][n] = sum_k A[m][k] B[k][n] with A[m][k] = w[16 m + k] read straight
// from the padded shared window (rows overlap, nothing is materialised),
// B[k][n] = g[k - n] (the taps as a band), Y[m][n] = output 16 m + n;
// mma.sync.m16n8k8 in TF32 with w and g split into hi = tf32(v) and
// lo = tf32(v - hi) and the three products lo.hi + hi.lo + hi.hi.  By
// default each k-step's products start from zero and are added to float32
// sums; with -DCHAIN_ACC they accumulate in the tensor core.
#include <cuda_runtime.h>
#include <cstdint>
namespace {
constexpr int THREADS = 128, TILE = 2048, G = 16, PAD = 4, LMAX = 4096;
__host__ __device__ __forceinline__ int padded(int k) { return k + k / G * PAD; }
struct Layout {
  int S, Wn, Ws, Gz;
  __host__ __device__ explicit Layout(int L) {
    S = (L + 15 + 7) / 8;                  // k-steps
    Wn = (TILE - 16 + 8 * S + 15) / 16 * 16;   // window entries
    Ws = Wn / G * (G + PAD);
    Gz = 8 + 8 * S + 8;
  }
  __host__ __device__ size_t words() const { return 2 * (size_t)Ws + 2 * Gz; }
};
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t u; asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(v)); return u;
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2], const float (&c)[4]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}
__global__ void __launch_bounds__(THREADS)
fir_mma_kernel(const float* __restrict__ x, const float* __restrict__ carry, const float* __restrict__ h,
               float* __restrict__ y, int T, int L, int ntiles) {
  extern __shared__ __align__(16) uint32_t sm[];
  const Layout lay(L);
  uint32_t* wh = sm; uint32_t* wl = wh + lay.Ws; uint32_t* gh = wl + lay.Ws; uint32_t* gl = gh + lay.Gz;
  const int r = blockIdx.x / ntiles, t = blockIdx.x - r * ntiles;
  const long long xrow = (long long)r * T, crow = (long long)r * (L - 1);
  for (int i = threadIdx.x; i < lay.Gz; i += THREADS) {
    const int a = i - 8;
    const float v = (a >= 0 && a < L) ? h[L - 1 - a] : 0.f;
    const uint32_t hi = tf32(v);
    gh[i] = hi; gl[i] = tf32(v - __uint_as_float(hi));
  }
  for (int q = threadIdx.x; q < lay.Wn; q += THREADS) {
    const int n = t * TILE + q;
    float v = 0.f;
    if (n < L - 1) v = carry[crow + n];
    else if (n - (L - 1) < T) v = x[xrow + n - (L - 1)];
    const uint32_t hi = tf32(v);
    wh[padded(q)] = hi; wl[padded(q)] = tf32(v - __uint_as_float(hi));
  }
  __syncthreads();
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tt = lane & 3;
  float acc[2][2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][n][c] = 0.f;
  uint32_t bhp[2] = {0u, 0u}, blp[2] = {0u, 0u};
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  const int abase = (32 * wid + g) * (G + PAD) + tt;
  const int gbase = 8 + tt - g;
  for (int s = 0; s < lay.S; ++s) {
    const int kp = padded(8 * s);
    uint32_t bh[2], bl[2];
    bh[0] = gh[gbase + 8 * s]; bh[1] = gh[gbase + 8 * s + 4];
    bl[0] = gl[gbase + 8 * s]; bl[1] = gl[gbase + 8 * s + 4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int a0 = abase + j * 16 * (G + PAD) + kp;
      uint32_t ah[4], al[4];
      ah[0] = wh[a0]; ah[1] = wh[a0 + 8 * (G + PAD)]; ah[2] = wh[a0 + 4]; ah[3] = wh[a0 + 8 * (G + PAD) + 4];
      al[0] = wl[a0]; al[1] = wl[a0 + 8 * (G + PAD)]; al[2] = wl[a0 + 4]; al[3] = wl[a0 + 8 * (G + PAD) + 4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const uint32_t (&Bh)[2] = n ? bhp : bh;
        const uint32_t (&Bl)[2] = n ? blp : bl;
#ifdef CHAIN_ACC
        mma(acc[j][n], al, Bh, acc[j][n]);
        mma(acc[j][n], ah, Bl, acc[j][n]);
        mma(acc[j][n], ah, Bh, acc[j][n]);
#else
        float d[4];
        mma(d, al, Bh, zero);
        mma(d, ah, Bl, d);
        mma(d, ah, Bh, d);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][n][c] += d[c];
#endif
      }
    }
    bhp[0] = bh[0]; bhp[1] = bh[1]; blp[0] = bl[0]; blp[1] = bl[1];
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int o = t * TILE + 16 * (32 * wid + 16 * j + g + 8 * hh) + 8 * n + 2 * tt;
        float* yp = y + xrow + o;
        if ((T & 1) == 0 && o + 2 <= T) *reinterpret_cast<float2*>(yp) = make_float2(acc[j][n][2 * hh], acc[j][n][2 * hh + 1]);
        else { if (o < T) yp[0] = acc[j][n][2 * hh]; if (o + 1 < T) yp[1] = acc[j][n][2 * hh + 1]; }
      }
}
}
extern "C" int fir_mma_launch(const void* x, const void* carry, const void* h, void* y, int rows, int T, int L, void* stream) {
  if (L < 1 || L > LMAX) return (int)cudaErrorInvalidValue;
  const int ntiles = (T + TILE - 1) / TILE;
  const size_t smem = 4 * Layout(L).words();
  if (smem > 48 * 1024) { cudaError_t e = cudaFuncSetAttribute(fir_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem); if (e != cudaSuccess) return (int)e; }
  fir_mma_kernel<<<ntiles * rows, THREADS, smem, (cudaStream_t)stream>>>((const float*)x, (const float*)carry, (const float*)h, (float*)y, T, L, ntiles);
  return (int)cudaGetLastError();
}
"""
SM_CLOCK_HZ = 1.98e9     # H100 SXM boost clock: 67 TFLOP/s = 132*128*2*1.98e9
SUBPARTITIONS = 132 * 4


def ffma_rate(torch, cs, build, tag):
    """Float32 multiply-adds per clock and SM sub-partition by how many
    register operands repeat (see the module's note)."""
    import ctypes
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "ffma_rate.cu"
    src.write_text(FFMA_RATE_SRC)
    dev = torch.device("cuda")
    inp = torch.rand(1024, device=dev) * 1e-3
    iters, nacc = 2000, 16
    for repeat in (2, 1, 0):
        so = build.BUILD_DIR / f"ffma_rate_{repeat}.so"
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, f"-DREPEAT={repeat}",
                        "-shared", "-o", str(so), str(src)], check=True,
                       capture_output=True, text=True)
        fn = ctypes.CDLL(str(so)).ffma_rate_launch
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        rates = []
        for warps in (4, 8, 16, 32):
            blocks = 132 * warps // 4
            out = torch.empty(blocks * 128, device=dev)

            def run():
                rc = fn(inp.data_ptr(), out.data_ptr(), blocks, iters,
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"ffma_rate launch failed: {rc}")

            ms = cs.time_ms(run, iters=5)
            n = blocks * 4 * iters * 8 * nacc       # warp instructions
            rates.append(f"{warps} warps/SM "
                         f"{n / (ms * 1e-3) / (SUBPARTITIONS * SM_CLOCK_HZ):.3f}")
        print(f"{tag} float32 multiply-adds per clock and sub-partition, "
              f"{repeat} of 3 register operands repeating: "
              + "; ".join(rates), flush=True)


LATENCY_NAMES = [
    "FADD", "FMNMX", "IMAD", "SHFL.IDX", "REDUX.MAX + LOP3",
    "REDUX.MAX, REDUX.MIN + FMNMX + LOP3", "FMUL", "FADD + FMUL",
    "iir_scan's one-pole step (FADD, FMUL, FADD)", "FSETP + FSEL",
    "cvsd_scan's decode step (three chains of three)",
    "cvsd_scan's encode step (both outcomes, then the select)"]


def latency(torch, build, tag):
    """--latency: the dependent latency in cycles of the instructions on
    the recurrence kernels' chains (see LATENCY_SRC), one warp alone."""
    per = latency_cycles(torch, build)
    print(f"{tag} cycles per dependent instruction (one warp): "
          + "; ".join(f"{n} {c:.2f}" for n, c in zip(LATENCY_NAMES, per)),
          flush=True)
    print(f"{tag} the SM clock a kernel runs at (clock64 against CUDA "
          f"events): one warp {sm_clock_mhz(torch, build, 1):.0f} MHz, a "
          f"warp on each of 132 SMs {sm_clock_mhz(torch, build, 132):.0f} "
          f"MHz", flush=True)


def latency_lib(build):
    """LATENCY_SRC built (once per process) and loaded."""
    import ctypes
    if getattr(latency_lib, "lib", None) is None:
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = build.BUILD_DIR / "latency.cu"
        src.write_text(LATENCY_SRC)
        so = build.BUILD_DIR / "latency.so"
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                        str(so), str(src)], check=True, capture_output=True,
                       text=True)
        latency_lib.lib = ctypes.CDLL(str(so))
    return latency_lib.lib


def sm_clock_mhz(torch, build, blocks):
    """The SM clock (MHz) a kernel of `blocks` one-warp blocks runs at:
    2e7 cycles of clock64 against CUDA events, the median of 3."""
    import ctypes
    fn = latency_lib(build).spin_launch
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(blocks, dtype=torch.int64, device="cuda")
    n = 20_000_000
    mhz = []
    for _ in range(3):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        rc = fn(n, blocks, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        e1.record()
        e1.synchronize()
        if rc != 0:
            raise RuntimeError(f"spin launch failed: {rc}")
        mhz.append(float(out.min()) / (e0.elapsed_time(e1) * 1e3))
    return sorted(mhz)[1]


def latency_cycles(torch, build):
    """Cycles per instance of each chain of LATENCY_SRC, one warp alone."""
    import ctypes
    fn = latency_lib(build).latency_launch
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    inp = torch.rand(64, device=dev)
    cyc = torch.zeros(len(LATENCY_NAMES), dtype=torch.int64, device=dev)
    out = torch.empty(32, device=dev)
    for _ in range(3):                      # the last run is read
        rc = fn(inp.data_ptr(), cyc.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"latency launch failed: {rc}")
    torch.cuda.synchronize()
    return (cyc.double() / 4096).tolist()


def mma_probe(torch, cs, build, tag):
    """fir_real's function on the tensor cores (see MMA_PROBE_SRC): its
    error against the plain version and float64, and its time beside the
    port's kernel, for both ways of accumulating."""
    import ctypes
    from liquid_dsp_tpu_torch.ops.kernels.fir_real import (
        fir_real, fir_real_reference)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "fir_mma.cu"
    src.write_text(MMA_PROBE_SRC)
    fns = {}
    for name, flags in (("sums in float32", []),
                        ("sums in the tensor core", ["-DCHAIN_ACC"])):
        so = build.BUILD_DIR / f"fir_mma_{len(fns)}.so"
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *flags, "-shared",
                        "-o", str(so), str(src)], check=True,
                       capture_output=True, text=True)
        fn = ctypes.CDLL(str(so)).fir_mma_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def call(fn, x, c, h, y):
        rc = fn(x.data_ptr(), c.data_ptr(), h.data_ptr(), y.data_ptr(),
                x.shape[0], x.shape[1], h.shape[0],
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fir_mma launch failed: {rc}")

    def rel(a, b):
        return float((a - b).abs().max() / b.square().mean().sqrt())

    for rows, T, L in ((6, 1000, 1), (6, 4096, 13), (6, 4096, 144),
                       (6, 2053, 257), (2, 3000, 4096)):
        x = torch.randn(rows, T, generator=gen, device=dev)
        c = torch.randn(rows, L - 1, generator=gen, device=dev)
        h = torch.randn(L, generator=gen, device=dev) / L ** 0.5
        ref = fir_real_reference(x, c, h)
        ref64 = torch.nn.functional.conv1d(
            torch.cat([c, x], 1).double()[:, None],
            h.double().flip(0)[None, None])[:, 0]
        out = [f"plain version against float64 {rel(ref, ref64):.3e}"]
        for name, fn in fns.items():
            y = torch.full_like(x, float("nan"))
            call(fn, x, c, h, y)
            torch.cuda.synchronize()
            out.append(f"{name}: {rel(y, ref):.3e} against the plain "
                       f"version, {rel(y, ref64):.3e} against float64")
        print(f"{tag} tensor-core fir_real, {rows} x {T}, {L} taps, "
              f"max|err|/rms: " + "; ".join(out), flush=True)
    rows, T = 128, 1 << 18
    x = torch.randn(rows, T, generator=gen, device=dev)
    y = torch.empty_like(x)
    for L in (144, 13, 1024):
        h = torch.randn(L, generator=gen, device=dev) / L ** 0.5
        c = torch.randn(rows, L - 1, generator=gen, device=dev)
        out = [f"{name} {cs.time_ms(lambda: call(fn, x, c, h, y)):.4f} ms"
               for name, fn in fns.items()]
        out.append(f"the port's fir_real "
                   f"{cs.time_ms(lambda: fir_real(x, c, h)):.4f} ms")
        print(f"{tag} tensor-core fir_real, {rows} x {T}, {L} taps: "
              + "; ".join(out), flush=True)


def write_sass(build, lib, sass_dir, fname, pick):
    """cuobjdump's SASS of the built library's functions whose header line
    `pick` accepts, into sass_dir/fname; returns (path, lines)."""
    out = os.path.abspath(sass_dir)
    os.makedirs(out, exist_ok=True)
    nvcc_dir = os.path.dirname(build._nvcc())
    sass = subprocess.run([os.path.join(nvcc_dir, "cuobjdump"), "-sass",
                           str(lib)], capture_output=True, text=True,
                          timeout=600).stdout
    keep, on = [], False
    for ln in sass.splitlines():
        if "Function :" in ln:
            on = pick(ln)
        if on:
            keep.append(ln)
    path = os.path.join(out, fname)
    with open(path, "w") as f:
        f.write("\n".join(keep))
    return path, len(keep)


def print_ptxas(lib, tag, keys):
    """ptxas's registers and spills for every kernel of the built library
    whose name holds one of `keys` (from the build's log)."""
    log = lib.with_suffix(".log").read_text().splitlines()
    for k, ln in enumerate(log):
        if "Compiling entry" in ln and any(key in ln for key in keys):
            used = [u.strip() for u in log[k + 1:k + 4]
                    if "registers" in u or "spill" in u]
            print(f"{tag} ptxas {ln.split('function')[-1].strip()}: "
                  f"{' | '.join(used)}", flush=True)


def viterbi_bench(torch, cs, build, tag, name, sass_dir):
    """--viterbi: times of viterbi_acs for this checkout (see the module
    docstring); uses only what every checkout since its port has: the
    wrapper, chip_smoke.viterbi_case and chip_smoke.time_ms."""
    from liquid_dsp_tpu_torch.ops.kernels.viterbi_acs import viterbi_acs
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib = build.build()
    build.load_library()
    print(f"{tag} built in {time.perf_counter() - t0:.1f} s", flush=True)
    print_ptxas(lib, tag, ("viterbi",))
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()[0])

    def twice(fn):
        return [cs.time_ms(fn, iters=200) for _ in range(2)]

    for scheme, N, d in (("v27", 512, 68), ("v27", 256, 64),
                         ("v29", 256, 64)):
        fn, obs, _ = cs.viterbi_case(torch, dev, scheme, N, d, 0.8, 7)
        a = twice(lambda: viterbi_acs(obs, fn.exp, fn.nout))
        line = (f"{tag} viterbi_acs {scheme} {N} x {d} bytes (T = "
                f"{obs.shape[1]}): {a[0]:.4f}, {a[1]:.4f} ms")
        if N == 512:
            b = twice(lambda: viterbi_acs(obs, fn.exp, 0))
            line += (f"; nout = 0: {b[0]:.4f}, {b[1]:.4f} ms (traceback "
                     f"{100 * (1 - sum(b) / sum(a)):.1f}%)")
        print(line, flush=True)
    # lengths at which the card, not the wrapper's host work, sets the
    # launch's time; the long v29 one still keeps its decisions in
    # shared memory
    for scheme, lens in (("v27", (68, 400)), ("v29", (68, 120))):
        one = []
        for d in lens:
            fn, obs, _ = cs.viterbi_case(torch, dev, scheme, 1, d, 0.8, 8)
            one.append((obs.shape[1], min(twice(
                lambda: viterbi_acs(obs, fn.exp, fn.nout)))))
        (ta, ma), (tb, mb) = one
        us = (mb - ma) / (tb - ta) * 1e3
        print(f"{tag} viterbi_acs {scheme} one codeword, T = {ta} and {tb}: "
              f"{ma:.4f}, {mb:.4f} ms; one step {us:.4f} us = "
              f"{us * mhz:.0f} cycles at {mhz:.0f} MHz", flush=True)
    if sass_dir:
        path, n = write_sass(build, lib, sass_dir, f"sass_viterbi_{name}.txt",
                             lambda ln: "viterbi" in ln)
        print(f"{tag} SASS of viterbi_acs's kernels: {path} ({n} lines)",
              flush=True)


def iir_bench(torch, cs, build, tag, name, sass_dir):
    """--iir: times of iir_scan and iir_block_state for this checkout (see
    the module docstring); uses only what every checkout since their port
    has: the wrappers, the Procs and chip_smoke's analog_paths, time_ms,
    lone_row_step_us and sm_mhz."""
    from liquid_dsp_tpu_torch.design.iirdes import iirdes_sos
    from liquid_dsp_tpu_torch.ops.iir import iirfilt_sos
    from liquid_dsp_tpu_torch.ops.kernels.iir_block_state import (
        iir_block_state)
    from liquid_dsp_tpu_torch.ops.kernels.iir_scan import iir_scan
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib = build.build()
    build.load_library()
    print(f"{tag} built in {time.perf_counter() - t0:.1f} s", flush=True)
    print_ptxas(lib, tag, ("iir_scan", "iir_block_state"))
    mhz = cs.sm_mhz()
    gen = torch.Generator(device=dev).manual_seed(14)

    def twice(fn):
        return [cs.time_ms(fn, iters=100) for _ in range(2)]

    def device_ms(fn, kernel):
        """The kernel's device time per launch over 20 calls (profiler):
        what a short launch takes on the card without the wrapper's host
        work, which 100 back-to-back calls also time."""
        by_name, _ = cs.device_profile(torch, fn, 20, kernel)
        tot, cnt = map(sum, zip(*[v for k, v in by_name.items()
                                  if kernel in k]))
        return tot / cnt

    def report(what, rows, steps, ms, dev_ms, one_step_us, lone, est):
        ratio = dev_ms / (steps * one_step_us / 1e3)
        print(f"{tag} {what}: {ms[0]:.4f}, {ms[1]:.4f} ms (100 launches "
              f"each); device time {dev_ms:.4f} ms a launch (profiler) = "
              f"{dev_ms / steps * 1e3 * mhz:.1f} cycles a step; a lone row "
              + ", ".join(f"{n} steps {t:.4f} ms" for n, t in lone.items())
              + f": {one_step_us * 1e3:.2f} ns = {one_step_us * mhz:.1f} "
              f"cycles a step at {mhz:.0f} MHz (the chain's estimate "
              f"{est:.1f}), so the {rows}-row launch takes {ratio:.3f} of "
              f"one row's loop", flush=True)

    make_tx, make_rx = cs.analog_paths()
    ch = make_tx().stages[1]
    rx = make_rx()
    q7 = rx.stages[0]
    T = 1 << 18
    # iir_scan: (what, rows, b, a, the chain's estimate in cycles a sample:
    # 3 dependent operations a pole at 4.5; for the cascade the ~38
    # instructions one warp issues a sample, 9 a section, more than its 4
    # dependent operations a section)
    for what, rows, b, a, est in (
            ("one pole (the shadowing)", 64, ch.sh_b, ch.sh_a, 13.5),
            ("4 sections (butter 7)", 128, q7.B, q7.A, 38.0)):
        b, a = b.to(dev), a.to(dev)
        ns, n = b.shape
        x = torch.randn(rows, T, generator=gen, device=dev)
        st = torch.zeros(rows, ns, n - 1, device=dev)
        ms = twice(lambda: iir_scan(x, b, a, st))
        dms = device_ms(lambda: iir_scan(x, b, a, st), "iir_scan")
        us, lone = cs.lone_row_step_us(lambda m: iir_scan(
            x[:1, :m].contiguous(), b, a, st[:1]), (T // 4, T))
        report(f"iir_scan {what}, {rows} x {T}", rows, T, ms, dms, us, lone,
               est)
        del x
    # iir_block_state: M = A^128 of the path's filters, then of 16- and
    # 32-state Butterworths; the chain's estimate: a shuffle, a product and
    # p sums (p = 1: a product and a sum)
    L = 128
    mats = [(128, 2048, q7.Apow[L]), (64, 2048, rx.stages[2].filt.Apow[L]),
            (64, 512, rx.stages[3].Apow[L])]
    for order in (16, 32):
        mats.append((64, 2048, iirfilt_sos(*iirdes_sos(
            "butter", order, 0.2)).Apow[L]))
    for rows, nb, m in mats:
        m = m.to(dev).contiguous()
        p = m.shape[0]
        est = 9.0 if p == 1 else 26 + 4.5 * (p + 1)
        # a lone row at lengths where the card, not the launch, sets the
        # time: 8192 and 32768 steps at least
        nl = max(nb, 8192)
        wb = torch.randn(rows, nb, p, generator=gen, device=dev)
        wl = torch.randn(1, 4 * nl, p, generator=gen, device=dev)
        s0 = torch.zeros(rows, p, device=dev)
        what = f"iir_block_state {rows} x {nb} blocks x {p} states"
        try:
            ms = twice(lambda: iir_block_state(wb, m, s0))
        except ValueError as e:
            print(f"{tag} {what}: not taken ({e})", flush=True)
            continue
        dms = device_ms(lambda: iir_block_state(wb, m, s0),
                        "iir_block_state")
        us, lone = cs.lone_row_step_us(lambda k: iir_block_state(
            wl[:, :k].contiguous(), m, s0[:1]), (nl, 4 * nl))
        report(what, rows, nb, ms, dms, us, lone, est)
        del wb, wl
    if sass_dir:
        # the paths' instances: the one-pole scan, the block state pass at
        # 8, 4 and 1 real states
        want = ("iir_scan_kernelILi1ELi2ELb0E",
                "iir_block_state_kernelILi8ELb0E",
                "iir_block_state_kernelILi4ELb0E",
                "iir_block_state_kernelILi1ELb0E")
        path, n = write_sass(build, lib, sass_dir, f"sass_iir_{name}.txt",
                             lambda ln: any(k in ln for k in want))
        print(f"{tag} SASS of the IIR kernels' path instances: {path} ({n} "
              f"lines)", flush=True)


def cvsd_bench(torch, cs, build, tag, name, sass_dir):
    """--cvsd: times of cvsd_scan for this checkout (see the module
    docstring); uses only what every checkout since its port has: the
    wrapper and its constants, and chip_smoke's time_ms, device_profile,
    lone_row_step_us and sm_mhz."""
    from liquid_dsp_tpu_torch.ops.kernels.cvsd_scan import (
        cvsd_consts, cvsd_scan)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib = build.build()
    build.load_library()
    print(f"{tag} built in {time.perf_counter() - t0:.1f} s", flush=True)
    print_ptxas(lib, tag, ("cvsd",))
    mhz = cs.sm_mhz()
    # the chains' estimates: one warp's whole step with no memory
    # (--latency, measured here)
    lat = dict(zip(LATENCY_NAMES, latency_cycles(torch, build)))
    est = {True: lat[LATENCY_NAMES[11]], False: lat[LATENCY_NAMES[10]]}
    # the clock a lone row's block and a full card's run at, measured
    clk1, clkn = (sm_clock_mhz(torch, build, b) for b in (1, 132))
    print(f"{tag} SM clock (clock64 against CUDA events): one warp "
          f"{clk1:.0f} MHz, a warp on each of 132 SMs {clkn:.0f} MHz; "
          f"nvidia-smi's maximum {mhz:.0f} MHz", flush=True)
    R, T = 1024, 1 << 15
    gen = torch.Generator(device=dev).manual_seed(16)
    t = torch.arange(T, device=dev, dtype=torch.float32) / 64000.0
    f0 = 200 + 3000 * torch.rand(R, 1, generator=gen, device=dev)
    x = (0.5 * torch.sin(2 * np.pi * f0 * t) + 0.05 * torch.randn(
        R, T, generator=gen, device=dev)).clamp(-1, 1).contiguous()
    bits = cvsd_scan(x, True)
    lens = (T // 4, T)
    for enc, inp in ((True, x), (False, bits)):
        what = "encode" if enc else "decode"
        ms = [cs.time_ms(lambda: cvsd_scan(inp, enc), iters=100)
              for _ in range(2)]
        by_name, _ = cs.device_profile(torch, lambda: cvsd_scan(inp, enc),
                                       20, f"cvsd_scan {what}")
        tot, cnt = map(sum, zip(*[v for k, v in by_name.items()
                                  if "cvsd" in k]))
        dev_ms = tot / cnt
        one = {n: inp[:1, :n].contiguous() for n in lens}
        us, lone = cs.lone_row_step_us(lambda n: cvsd_scan(one[n], enc),
                                       lens)
        print(f"{tag} cvsd_scan {what} {R} x {T}: {ms[0]:.4f}, {ms[1]:.4f} "
              f"ms (100 launches each); device time {dev_ms:.4f} ms a "
              f"launch (profiler) = {dev_ms / T * 1e3 * mhz:.1f} cycles a "
              f"step at {mhz:.0f} MHz ({dev_ms / T * 1e3 * clkn:.1f} at "
              f"{clkn:.0f}); a lone row "
              + ", ".join(f"{n} steps {v:.4f} ms" for n, v in lone.items())
              + f": {us * 1e3:.2f} ns = {us * mhz:.1f} cycles a step at "
              f"{mhz:.0f} MHz ({us * clk1:.1f} at {clk1:.0f}; the chain's "
              f"estimate, one warp's step alone: {est[enc]:.1f}), so the "
              f"{R}-row launch takes {dev_ms / (T * us / 1e3):.3f} of one "
              f"row's loop", flush=True)
    # rows per block, for a source that takes them as a macro: each build
    # against the library's on the same inputs
    import ctypes
    src = build.CSRC / "cvsd_scan.cu"
    if "CVSD_ROWS" in src.read_text():
        mask, z, rz, al, na1, na2 = cvsd_consts(3, 1.5, 0.95)
        want = {True: cvsd_scan(x, True), False: cvsd_scan(bits, False)}
        for rows in (1, 2, 4, 8, 16):
            so = build.BUILD_DIR / f"cvsd_rows_{rows}.so"
            proc = subprocess.run(
                [build._nvcc(), *build.NVCC_FLAGS, f"-DCVSD_ROWS={rows}",
                 "-shared", "-o", str(so), str(src)], check=True,
                capture_output=True, text=True)
            used = sorted({ln.split(":", 1)[-1].strip()
                           for ln in (proc.stdout + proc.stderr).splitlines()
                           if "registers" in ln or "spill" in ln})
            fn = ctypes.CDLL(str(so)).cvsd_scan_launch
            fn.argtypes, fn.restype = build._SIGNATURES["cvsd_scan_launch"]
            line = []
            for enc, inp in ((True, x), (False, bits)):
                out = torch.empty_like(want[enc])

                def call(a, rows_, t_):
                    rc = fn(a.data_ptr(), out.data_ptr(), rows_, t_,
                            0 if enc else 1, mask, z, rz,
                            al if enc else na1, na2,
                            torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"cvsd_scan launch failed: {rc}")

                call(inp, R, T)
                same = bool(torch.equal(out, want[enc]))
                ms = cs.time_ms(lambda: call(inp, R, T), iters=20)
                one = {n: inp[:1, :n].contiguous() for n in lens}
                us, _ = cs.lone_row_step_us(
                    lambda n: call(one[n], 1, n), lens)
                line.append(f"{'encode' if enc else 'decode'} {ms:.4f} ms"
                            f"{'' if same else ' NOT EQUAL'} (a lone row "
                            f"{us * clk1:.1f} cycles a step at {clk1:.0f} "
                            f"MHz)")
            print(f"{tag} cvsd_scan {R} x {T} at {rows} rows a block: "
                  + ", ".join(line) + "; ptxas " + " | ".join(used),
                  flush=True)
    if sass_dir:
        path, n = write_sass(build, lib, sass_dir, f"sass_cvsd_{name}.txt",
                             lambda ln: "cvsd" in ln)
        print(f"{tag} SASS of cvsd_scan's kernels: {path} ({n} lines)",
              flush=True)


def eq_instance(names, name):
    """The kernel instance on the equalizer path among `names` (mangled):
    eqrls_scan at L = 9 (a source built per L; one built per lane count
    has it at 16 lanes), eqlms_scan at 16 lanes, decision-directed where
    the mode is a template parameter."""
    prefs = {"eqrls": ("eqrls_scan_kernelILi9E", "eqrls_scan_kernelILi16EEv"),
             "eqlms": ("eqlms_scan_kernelILi16ELb0E",
                       "eqlms_scan_kernelILi16EEv")}[name]
    for pref in prefs:
        hit = [n for n in names if pref in n]
        if hit:
            return hit[0]
    return None


def eq_build_facts(build, so, log_text, name):
    """(instance, ptxas registers and spills with the SASS's local loads
    and stores, SASS instructions) of the path's instance of `name` in
    the shared library `so`."""
    import re
    sass = subprocess.run(
        [os.path.join(os.path.dirname(build._nvcc()), "cuobjdump"), "-sass",
         str(so)], capture_output=True, text=True,
        timeout=600).stdout.split("Function : ")[1:]
    counts = {f.split("\n", 1)[0].strip(): (
        len(re.findall(r"^\s+/\*[0-9a-f]{4,}\*/", f, re.M)),
        len(re.findall(r"\b(?:LDL|STL)\b", f))) for f in sass}
    inst = eq_instance(counts, name)
    log = log_text.splitlines()
    used = next((" | ".join(u.split(":", 1)[-1].strip()
                            for u in log[k + 1:k + 4]
                            if "registers" in u or "spill" in u)
                 for k, ln in enumerate(log)
                 if "Compiling entry" in ln and inst and inst in ln), "?")
    n_ins, n_local = counts.get(inst, (None, None))
    return inst, f"{used}; {n_local} local loads and stores", n_ins


def eq_bench(torch, cs, build, tag, turn, variants=True):
    """--eq: times of eqlms_scan and eqrls_scan for this checkout, and of
    their sources rebuilt at other steps a loop turn (see the module
    docstring).  Ends with one line `EQ_RESULT {json}`."""
    import ctypes
    import json
    from liquid_dsp_tpu_torch.ops.equalize import eqlms, eqrls
    from liquid_dsp_tpu_torch.ops.kernels.eqlms_scan import (
        QPSK_SCALE, eqlms_scan)
    from liquid_dsp_tpu_torch.ops.kernels.eqrls_scan import (
        eqrls_scan, rls_consts)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib = build.build()
    build.load_library()
    print(f"{tag} library built in {time.perf_counter() - t0:.1f} s "
          f"(0 if it was there)", flush=True)
    mhz = cs.sm_mhz()
    B, T = 256, 1 << 15
    lens = (T // 4, T)
    gen = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn(B, T, dtype=torch.complex64, device=dev, generator=gen)
    d = torch.randn(B, T, dtype=torch.complex64, device=dev, generator=gen)
    lms = eqlms(13).init((B,), device=dev)
    rls = eqrls(9).init((B,), device=dev)
    keys = ("w", "buf", "x2_sum", "n")
    lf, il = rls_consts(0.99)
    st = torch.cuda.current_stream().cuda_stream

    def c_lms(fn):
        def run(b, n, out):
            c = [lms[k][:b].clone() for k in keys]
            rc = fn(x[:b, :n].contiguous().data_ptr(), None, out.data_ptr(),
                    *(t.data_ptr() for t in c), b, n, 13, 1, 0, 0.05,
                    QPSK_SCALE, st)
            if rc != 0:
                raise RuntimeError(f"eqlms_scan launch failed: {rc}")
        return run

    def c_rls(fn):
        def run(b, n, out):
            c = [rls[k][:b].clone() for k in ("w", "buf", "P")]
            rc = fn(x[:b, :n].contiguous().data_ptr(),
                    d[:b, :n].contiguous().data_ptr(), out.data_ptr(),
                    *(t.data_ptr() for t in c), b, n, 9, 1, lf, il, st)
            if rc != 0:
                raise RuntimeError(f"eqrls_scan launch failed: {rc}")
        return run

    # the steps a loop turn a source takes as a macro, and the builds of
    # it to time
    builds = {"eqlms": ("EQLMS_UNROLL", (2, 4, 8, 0)),
              "eqrls": ("EQRLS_UNROLL", (2, 4, 8))}
    cases = (("eqlms", c_lms, lambda: eqlms_scan(
        x, *(lms[k] for k in keys), 0.05)[0]),
             ("eqrls", c_rls, lambda: eqrls_scan(
                 x, d, rls["w"], rls["buf"], rls["P"], 0.99)[0]))
    # every variant's nvcc at once, before the timings
    jobs = {}
    for name, (macro, values) in builds.items():
        src = build.CSRC / f"{name}_scan.cu"
        if not variants or macro not in src.read_text():
            continue
        for v in values:
            so = build.BUILD_DIR / f"{name}_{v}.so"
            jobs[name, v] = (so, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, f"-D{macro}={v}",
                 "-shared", "-o", str(so), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (so, job) in jobs.items():
        out, _ = job.communicate()
        if job.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        built[key] = (so, out)
    result = {"tag": turn}
    for name, wrap, call in cases:
        inst, used, n_ins = eq_build_facts(
            build, lib, lib.with_suffix(".log").read_text(), name)
        want = call()
        ms = [cs.time_ms(call, iters=20) for _ in range(2)]
        one = wrap(getattr(build.load_library(), f"{name}_scan_launch"))
        bufs = {n: torch.empty(1, n, dtype=torch.complex64, device=dev)
                for n in lens}
        us, _ = cs.lone_row_step_us(lambda n: one(1, n, bufs[n]), lens)
        result[name] = {"ms": ms, "cycles": us * mhz, "sass": n_ins,
                        "ptxas": used}
        print(f"{tag} {name}_scan {B} x {T} (the library): {ms[0]:.4f}, "
              f"{ms[1]:.4f} ms (20 launches each); a lone channel "
              f"{us * 1e3:.2f} ns = {us * mhz:.1f} cycles a step at "
              f"{mhz:.0f} MHz; path instance {inst}: {n_ins} SASS "
              f"instructions, ptxas {used}", flush=True)
        if not any(key[0] == name for key in built):
            print(f"{tag} {name}_scan: no build variants "
                  f"({'not asked' if not variants else 'no macros'})",
                  flush=True)
            continue
        macro, values = builds[name]
        for v in values:
            label = f"{macro}={v}"
            so, out = built[name, v]
            v_inst, v_used, v_ins = eq_build_facts(build, so, out, name)
            fn = getattr(ctypes.CDLL(str(so)), f"{name}_scan_launch")
            fn.argtypes, fn.restype = build._SIGNATURES[f"{name}_scan_launch"]
            run = wrap(fn)
            out = torch.empty_like(want)
            run(B, T, out)
            same = bool(torch.equal(torch.view_as_real(out),
                                    torch.view_as_real(want)))
            v_ms = cs.time_ms(lambda: run(B, T, out), iters=5)
            v_us, _ = cs.lone_row_step_us(lambda n: run(1, n, bufs[n]), lens)
            print(f"{tag} {name}_scan built with {label}: {v_ms:.4f} ms"
                  f"{'' if same else ' NOT EQUAL'}; a lone channel"
                  f" {v_us * mhz:.1f} cycles a step; {v_inst}: "
                  f"{v_ins} SASS instructions, ptxas {v_used}", flush=True)
    print("EQ_RESULT " + json.dumps(result), flush=True)


def eq_turns(args):
    """--eq --vs DIR: this script's --eq for DIR and for this checkout in
    turns (DIR, this, this, DIR), each in its own process, the build
    variants on the first of this checkout's turns only; then both
    checkouts' times side by side."""
    import json
    here = os.path.dirname(os.path.abspath(__file__))
    me = os.path.abspath(__file__)
    turns = [(args.vs, "parent"), (args.root, args.tag),
             (args.root, args.tag), (args.vs, "parent")]
    got = []
    for k, (root, tag) in enumerate(turns):
        cmd = [sys.executable, me, "--eq", "--root", root, "--tag", tag]
        if k != 1:
            cmd.append("--no-variants")
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=here)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            sys.exit(f"chip_kernel_bench --eq for {root} failed "
                     f"({proc.returncode})")
        got += [json.loads(ln.split(" ", 1)[1])
                for ln in proc.stdout.splitlines()
                if ln.startswith("EQ_RESULT ")]
    for name in ("eqlms", "eqrls"):
        cells = "; ".join(
            f"{r['tag']} {r[name]['ms'][0]:.4f}, {r[name]['ms'][1]:.4f} ms "
            f"({r[name]['cycles']:.1f} cycles a lone step)" for r in got)
        par = [m for r in got if r["tag"] == "parent" for m in r[name]["ms"]]
        new = [m for r in got if r["tag"] != "parent" for m in r[name]["ms"]]
        print(f"{name}_scan, turns in order: {cells}; parent "
              f"{min(par):.4f}-{max(par):.4f} ms against "
              f"{min(new):.4f}-{max(new):.4f} ms, "
              f"{min(par) / max(new):.2f}-{max(par) / min(new):.2f} times",
              flush=True)


FLOOR_PROBE_SRC = r"""
// one library call a kernel, for counting its SASS instructions
#include <cuda_runtime.h>
extern "C" __global__ void probe_base(float* x) {
  const int i = threadIdx.x; x[i] = __fmul_rn(x[i], 0.5f); }
extern "C" __global__ void probe_tanhf(float* x) {
  const int i = threadIdx.x; x[i] = tanhf(x[i]); }
extern "C" __global__ void probe_logf(float* x) {
  const int i = threadIdx.x; x[i] = logf(x[i]); }
extern "C" __global__ void probe_expf(float* x) {
  const int i = threadIdx.x; x[i] = expf(x[i]); }
extern "C" __global__ void probe_atanhf(float* x) {
  const int i = threadIdx.x; x[i] = atanhf(x[i]); }
"""
SM_MUFU_PER_CLOCK = 16   # special-function results a clock and SM (sm_90)


def sass_counts(sass):
    """{function: (instructions, MUFU instructions)} of cuobjdump -sass
    text, NOPs left out."""
    import re
    out, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            out[name] = [0, 0]
            continue
        mt = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", ln)
        if name is None or not mt or mt.group(1).startswith("NOP"):
            continue
        out[name][0] += 1
        out[name][1] += mt.group(1).startswith("MUFU")
    return {k: tuple(v) for k, v in out.items()}


def transcendental_floor(build, sass_dir, card, R, iters, E):
    """The floor that tanhf, logf, expf and atanhf set on ldpc_bp's
    sum-product form: their SASS instructions (each probe kernel's count
    less the base probe's), four calls an edge and iteration, over the
    card's issue rate (a warp instruction a clock on each of 132 x 4
    sub-partitions at 1.98 GHz) and over its special-function rate (16
    MUFU a clock and SM); the larger.  Writes the SASS to sass_dir."""
    nvcc = build._nvcc()
    out = os.path.abspath(sass_dir)
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "floor_probe.cu")
    cubin = os.path.join(out, "floor_probe.cubin")
    with open(src, "w") as f:
        f.write(FLOOR_PROBE_SRC)
    subprocess.run([nvcc, *build.ARCH, "-O3", "-cubin", "-o", cubin, src],
                   check=True, capture_output=True, timeout=300)
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                           "-sass", cubin], capture_output=True, text=True,
                          timeout=300).stdout
    with open(os.path.join(out, "floor_probe.sass"), "w") as f:
        f.write(sass)
    cnt = sass_counts(sass)
    base = cnt["probe_base"]
    per = {k: (cnt[f"probe_{k}"][0] - base[0], cnt[f"probe_{k}"][1] - base[1])
           for k in ("tanhf", "logf", "expf", "atanhf")}
    ins = sum(v[0] for v in per.values())
    mufu = sum(v[1] for v in per.values())
    work = R * iters * E
    issue_ms = work * ins / (SUBPARTITIONS * 32 * SM_CLOCK_HZ) * 1e3
    mufu_ms = work * mufu / (132 * SM_MUFU_PER_CLOCK * SM_CLOCK_HZ) * 1e3
    print(f"[floor] ({card}) ldpc_bp sum-product's library functions, "
          f"static SASS instructions a call less the base probe's (MUFU "
          f"among them): " + ", ".join(f"{k} {v[0]} ({v[1]})"
                                       for k, v in per.items())
          + f"; {ins} instructions ({mufu} MUFU) an edge and iteration x "
          f"{R} x {iters} x {E} edges: issue floor {issue_ms:.4f} ms, "
          f"special-function floor {mufu_ms:.4f} ms, so "
          f"{max(issue_ms, mufu_ms):.4f} ms", flush=True)
    return {"per_call": per, "issue_ms": issue_ms, "mufu_ms": mufu_ms,
            "floor_ms": max(issue_ms, mufu_ms)}


def kernel_sass_counts(build, sass_dir, names):
    """The built library's SASS of the kernels whose name holds one of
    `names`, into sass_dir; {function: (instructions, MUFU)}."""
    lib = build.build()
    path, _ = write_sass(build, lib, sass_dir, "fold_kernels.sass",
                         lambda ln: any(k in ln for k in names))
    with open(path) as f:
        return sass_counts(f.read())


def fold_bench(torch, cs, tag, name, sass_dir=None):
    """--fold for one checkout (see the module's docstring)."""
    import json
    from liquid_dsp_tpu_torch.fec.ldpc import (ldpc_decoder_device,
                                               make_regular_ldpc)
    from liquid_dsp_tpu_torch.framing.frame64 import framesync64_stream_full
    from liquid_dsp_tpu_torch.framing.ofdmflex_stream import (
        ofdmflex_rx_stream)
    from liquid_dsp_tpu_torch.ops.kernels import ldpc_bp as lb
    from liquid_dsp_tpu_torch.ops.kernels.suppress_scan import suppress_scan
    dev = torch.device("cuda")
    result = {"tag": name}

    def measure(key, step, iters, what):
        ms = [cs.time_ms(step, iters=iters) for _ in range(2)]
        by, wall = cs.device_profile(torch, step, 3, what)
        dev_ms = sum(t for t, _ in by.values()) / 3
        ops = sum(c for _, c in by.values()) / 3
        busy = dev_ms * 3 / wall
        result[key] = {"ms": ms, "device_ms": dev_ms, "ops": ops,
                       "busy": busy}
        print(f"{tag} {what}: {ms[0]:.4f}, {ms[1]:.4f} ms ({iters} calls "
              f"each, CUDA events); device {dev_ms:.3f} ms in {ops:.0f} "
              f"operations, busy {busy:.3f} (torch.profiler, 3 calls)",
              flush=True)

    def kernel_us(fn, key, n):
        """A kernel's device us a launch over n calls of fn (profiler)."""
        for _ in range(3):      # a trace that lost events, taken again
            by, _ = cs.device_profile(torch, fn, n, key)
            dk = [(t, c) for k, (t, c) in by.items() if key in k]
            if dk and dk[0][1] == n:
                return dk[0][0] / n * 1e3
        sys.exit(f"chip_kernel_bench: the profiler saw {dk} for {key}")

    def fold_kernel(key, step, what):
        """suppress_scan on the step's own fold: device us a launch, the
        keep mask alone and, where the checkout ranks in the launch, with
        the ranking of the first P."""
        calls, _ = cs.hold_folds(torch, step, what)
        le, cand, pos, span = calls[0][:4]
        P = calls[0][4] if len(calls[0]) == 6 else None
        r = {"shape": list(cand.shape), "P": P,
             "keep_us": [kernel_us(lambda: suppress_scan(le, cand, pos, span),
                                   "suppress_scan", 200) for _ in range(2)]}
        if P is not None:
            r["rank_us"] = [kernel_us(
                lambda: suppress_scan(le, cand, pos, span, P=P),
                "suppress_scan", 200) for _ in range(2)]
        result[key]["fold"] = r
        print(f"{tag} suppress_scan on {what}'s fold {tuple(cand.shape)}: "
              f"keep alone {r['keep_us'][0]:.3f}, {r['keep_us'][1]:.3f} us a "
              f"launch" + (f", with the ranking of the first {P} "
                           f"{r['rank_us'][0]:.3f}, {r['rank_us'][1]:.3f} us"
                           if P is not None else "")
              + " (device time, 200 launches each)", flush=True)

    # the frame64 receiver's block 1 and the OFDM receiver's, from their
    # carries after block 0
    x, _ = cs.make_rx_stream(np.random.default_rng(7))
    x = torch.from_numpy(x).to(dev)
    rx = framesync64_stream_full(cs.RX_T).to(dev)
    _, c1 = rx(rx.init(batch_shape=(cs.RX_B,), device=dev), x[:, :cs.RX_T])
    blk = x[:, cs.RX_T:2 * cs.RX_T]
    measure("frame64", lambda: rx(c1, blk), 10,
            f"framesync64_stream_full step at {cs.RX_B}x{cs.RX_T}")
    fold_kernel("frame64", lambda: rx(c1, blk), "the frame64 step")
    x = cs.make_ofdm_stream(torch, dev, np.random.default_rng(28))[0]
    of = ofdmflex_rx_stream(cs.OF_T, cs.OF_PL, max_frames=cs.OF_MAX).to(dev)
    _, c2 = of(of.init(batch_shape=(cs.OF_B,), device=dev), x[:, :cs.OF_T])
    oblk = x[:, cs.OF_T:2 * cs.OF_T]
    measure("ofdm", lambda: of(c2, oblk), 10,
            f"ofdmflex_rx_stream step at {cs.OF_B}x{cs.OF_T}")
    fold_kernel("ofdm", lambda: of(c2, oblk), "the OFDM step")
    del x, blk, oblk
    # LDPC: the all-zero codeword (a codeword of any H) through BPSK and
    # AWGN at chip_smoke.py's sigma
    H = make_regular_ldpc(cs.LD_N, cs.LD_N // 2, col_weight=3,
                          seed=cs.LD_SEED)
    rng = np.random.default_rng(37)
    llr = torch.from_numpy((2 * (1.0 + cs.LD_SIGMA * rng.standard_normal(
        (cs.LD_ROWS, cs.LD_N))) / cs.LD_SIGMA ** 2).astype(np.float32)).to(dev)
    for min_sum in (False, True):
        mode = "min_sum" if min_sum else "sum_product"
        dec = ldpc_decoder_device(H, cs.LD_ITERS, min_sum=min_sum, device=dev)
        ok = int(dec(llr)[1].sum())
        measure(f"ldpc_{mode}", lambda: dec(llr), 3,
                f"ldpc_decoder_device({mode}) at {cs.LD_ROWS} x {cs.LD_N}, "
                f"{cs.LD_ITERS} iterations ({ok} rows ok)")
        result[f"ldpc_{mode}"]["ok"] = ok
        # the kernel alone: the messages out (the only form a checkout
        # without the decisions in the launch has), and where it has them
        # the decoder's form
        maps = dec._on(dev)
        args = (llr, *maps[:3], dec.m, cs.LD_N, dec.wr, dec.wc,
                cs.LD_ITERS, min_sum)
        forms = {"messages": lambda: lb.ldpc_bp(*args)}
        if len(maps) == 5:
            forms = {"messages": lambda: lb.ldpc_bp(*args, None, maps[4]),
                     "decisions": lambda: lb.ldpc_bp(*args, *maps[3:])}
        kr = {}
        for form, fn in forms.items():
            kr[form] = [cs.time_ms(fn, iters=5) for _ in range(2)]
            kr[form].append(kernel_us(fn, "ldpc_bp", 3) / 1e3)
        result[f"ldpc_{mode}"]["kernel"] = kr
        print(f"{tag} ldpc_bp({mode}) alone at {cs.LD_ROWS} x {cs.LD_N}, "
              f"{cs.LD_ITERS} iterations, ms a launch (CUDA events, 5 "
              f"launches, twice; device time, 3): " + "; ".join(
                  f"{k} {v[0]:.4f}, {v[1]:.4f} (device {v[2]:.4f})"
                  for k, v in kr.items()), flush=True)
    if sass_dir:
        from liquid_dsp_tpu_torch.ops.kernels import build
        result["floor"] = transcendental_floor(
            build, sass_dir, tag, cs.LD_ROWS, cs.LD_ITERS, int(H.sum()))
        result["sass"] = kernel_sass_counts(
            build, os.path.join(sass_dir, name), ("ldpc_bp", "suppress_scan"))
        print(f"{tag} SASS instructions (MUFU) of the kernels: " + "; ".join(
            f"{k} {v[0]} ({v[1]})" for k, v in result["sass"].items()),
            flush=True)
    print("FOLD_RESULT " + json.dumps(result), flush=True)


def fold_turns(args):
    """--fold --vs DIR: this script's --fold for DIR and for this checkout
    in turns (DIR, this, this, DIR), each in its own process; then both
    checkouts' figures side by side (with --sass DIR, the first turn of
    each checkout writes its kernels' SASS there, and the change's the
    library functions' floor)."""
    import json
    here = os.path.dirname(os.path.abspath(__file__))
    me = os.path.abspath(__file__)
    turns = [(args.vs, "parent"), (args.root, args.tag),
             (args.root, args.tag), (args.vs, "parent")]
    got = []
    for k, (root, tag) in enumerate(turns):
        cmd = [sys.executable, me, "--fold", "--root", root, "--tag", tag]
        if args.sass and k < 2:
            cmd += ["--sass", args.sass]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=here)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            sys.exit(f"chip_kernel_bench --fold for {root} failed "
                     f"({proc.returncode})")
        got += [json.loads(ln.split(" ", 1)[1])
                for ln in proc.stdout.splitlines()
                if ln.startswith("FOLD_RESULT ")]
    for key in ("frame64", "ofdm", "ldpc_sum_product", "ldpc_min_sum"):
        print(f"{key}, turns in order: " + "; ".join(
            f"{r['tag']} {r[key]['ms'][0]:.4f}, {r[key]['ms'][1]:.4f} ms, "
            f"device {r[key]['device_ms']:.3f} ms in {r[key]['ops']:.0f} "
            f"operations, busy {r[key]['busy']:.3f}" for r in got),
            flush=True)
    for key in ("frame64", "ofdm"):
        print(f"suppress_scan on the {key} fold, us a launch, turns in "
              f"order: " + "; ".join(
                  f"{r['tag']} keep {'/'.join(f'{v:.3f}' for v in r[key]['fold']['keep_us'])}"
                  + (f", ranked {'/'.join(f'{v:.3f}' for v in r[key]['fold']['rank_us'])}"
                     if "rank_us" in r[key]["fold"] else "")
                  for r in got), flush=True)
    for key in ("ldpc_sum_product", "ldpc_min_sum"):
        print(f"ldpc_bp alone ({key[5:]}), ms a launch, turns in order: "
              + "; ".join(f"{r['tag']} " + ", ".join(
                  f"{k} {v[0]:.4f}/{v[1]:.4f}"
                  for k, v in r[key]["kernel"].items()) for r in got),
              flush=True)


def pscan_bench(torch, cs, build, tag, name, sass_dir):
    """--pscan: iir_pscan, iir_scan and the block form on the same filters
    and rows for this checkout (see the module docstring); a checkout
    without iir_pscan times the other two."""
    import json
    from liquid_dsp_tpu_torch.design.iirdes import iirdes_sos
    from liquid_dsp_tpu_torch.ops.iir import iirfilt_sos
    from liquid_dsp_tpu_torch.ops.kernels.iir_scan import iir_scan
    try:
        from liquid_dsp_tpu_torch.ops.kernels.iir_pscan import (
            iir_pscan, iir_pscan_reference)
    except ImportError:
        iir_pscan = None
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib = build.build()
    build.load_library()
    print(f"{tag} built in {time.perf_counter() - t0:.1f} s", flush=True)
    print_ptxas(lib, tag, ("iir_pscan",))
    gen = torch.Generator(device=dev).manual_seed(24)
    B, T = 64, 1 << 18
    result = {"tag": name}

    def twice(fn, iters):
        return [cs.time_ms(fn, iters=iters) for _ in range(2)]

    def device_ms(fn, kernel):
        by_name, _ = cs.device_profile(torch, fn, 20, kernel)
        tot, cnt = map(sum, zip(*[v for k, v in by_name.items()
                                  if kernel in k]))
        return tot / cnt

    rot = np.exp(0.6j * np.arange(3))
    B5, A5 = iirdes_sos("butter", 5, 0.1)
    cases = {"butter7": iirdes_sos("butter", 7, 0.2),
             "butter16": iirdes_sos("butter", 16, 0.2),
             "butter5_shifted": ((B5 * rot).astype(np.complex64),
                                 (A5 * rot).astype(np.complex64))}
    for what, (Bc, Ac) in cases.items():
        cplx = np.iscomplexobj(Bc)
        dt = torch.complex64 if cplx else torch.float32
        rows = B if cplx else 2 * B
        b = torch.from_numpy(np.asarray(Bc, np.complex64 if cplx
                                        else np.float32)).to(dev)
        a = torch.from_numpy(np.asarray(Ac, np.complex64 if cplx
                                        else np.float32)).to(dev)
        x = torch.randn(rows, T, dtype=dt, generator=gen, device=dev)
        st = torch.zeros(rows, b.shape[0], 2, dtype=dt, device=dev)
        r = {"rows": rows, "sections": int(b.shape[0])}
        r["iir_scan_ms"] = twice(lambda: iir_scan(x, b, a, st), 20)
        line = (f"{tag} {what} ({b.shape[0]} sections) at {rows} "
                f"{'complex' if cplx else 'plane'} rows x {T}: iir_scan "
                f"{r['iir_scan_ms'][0]:.4f}, {r['iir_scan_ms'][1]:.4f} ms")
        if iir_pscan is not None:
            r["iir_pscan_ms"] = twice(lambda: iir_pscan(x, b, a, st), 100)
            r["iir_pscan_device_ms"] = device_ms(
                lambda: iir_pscan(x, b, a, st), "iir_pscan")
            x1, s1 = x[:1].contiguous(), st[:1]
            r["iir_pscan_lone_row_ms"] = min(twice(
                lambda: iir_pscan(x1, b, a, s1), 100))
            xs = torch.randn(3, 40000, dtype=dt, generator=gen, device=dev)
            s0 = 0.1 * torch.randn(3, b.shape[0], 2, dtype=dt, generator=gen,
                                   device=dev)
            ys, s2 = iir_pscan(xs, b, a, s0)
            yr, sr = iir_pscan_reference(xs, b, a, s0)
            r["bit_equal"] = (cs.bits_equal(torch, ys, yr)
                              and cs.bits_equal(torch, s2, sr))
            line += (f"; iir_pscan {r['iir_pscan_ms'][0]:.4f}, "
                     f"{r['iir_pscan_ms'][1]:.4f} ms (100 launches each; "
                     f"device {r['iir_pscan_device_ms']:.4f} ms a launch), "
                     f"a lone row {r['iir_pscan_lone_row_ms']:.4f} ms; "
                     f"iir_scan / iir_pscan "
                     f"{sum(r['iir_scan_ms']) / sum(r['iir_pscan_ms']):.1f}; "
                     f"{'' if r['bit_equal'] else 'NOT '}bit-equal to its "
                     f"plain version")
        if not cplx:
            q = iirfilt_sos(Bc, Ac, backend="block").to(dev)
            xc = torch.complex(x[:B], x[B:])
            c0 = q.init(batch_shape=(B,), device=dev)
            r["block_ms"] = twice(lambda: q(c0, xc), 20)
            line += (f"; the block form (a {B}x{T} complex block, the same "
                     f"rows) {r['block_ms'][0]:.4f}, {r['block_ms'][1]:.4f} "
                     f"ms")
        print(line, flush=True)
        result[what] = r
        del x
    # a block through the Proc under each backend the checkout takes
    xc = torch.randn(B, T, dtype=torch.complex64, generator=gen, device=dev)
    steps = {}
    for be in ("pscan", "block", "scan"):
        try:
            q = iirfilt_sos(*cases["butter7"], backend=be).to(dev)
        except ValueError:
            continue
        c0 = q.init(batch_shape=(B,), device=dev)
        steps[be] = twice(lambda: q(c0, xc), 20)
    result["steps"] = steps
    print(f"{tag} a {B}x{T} complex block through iirfilt_sos(butter 7): "
          + ", ".join(f"{be} {v[0]:.4f}, {v[1]:.4f} ms"
                      for be, v in steps.items()), flush=True)
    if sass_dir and iir_pscan is not None:
        path, n = write_sass(build, lib, sass_dir, f"sass_pscan_{name}.txt",
                             lambda ln: "iir_pscan_kernel" in ln)
        print(f"{tag} SASS of iir_pscan's instances: {path} ({n} lines)",
              flush=True)
        kinds = ("BAR", "LDS", "STS", "LDG", "STG", "LDGSTS", "SHFL", "FMUL",
                 "FADD", "FFMA", "FSEL", "BRA", "ISETP")
        insts, counts = None, {}
        for ln in open(path).read().splitlines():
            if "Function :" in ln:
                insts = "real" if "ILb0E" in ln else "complex"
                counts[insts] = dict.fromkeys(kinds + ("all",), 0)
            elif insts and "/*" in ln and ";" in ln:
                op = ln.split("*/", 1)[1].strip().split()[0]
                if op.startswith("@"):
                    op = ln.split("*/", 1)[1].strip().split()[1]
                counts[insts]["all"] += 1
                base = op.split(".")[0]
                if base in counts[insts]:
                    counts[insts][base] += 1
        result["sass_counts"] = counts
        for k, v in counts.items():
            print(f"{tag} iir_pscan {k} SASS: " + ", ".join(
                f"{op} {c}" for op, c in v.items()), flush=True)
    print("PSCAN_RESULT " + json.dumps(result), flush=True)


def pscan_turns(args):
    """--pscan --vs DIR: this script's --pscan for DIR and for this
    checkout in turns (DIR, this, this, DIR), each in its own process;
    then both checkouts' figures side by side."""
    import json
    here = os.path.dirname(os.path.abspath(__file__))
    me = os.path.abspath(__file__)
    turns = [(args.vs, "parent"), (args.root, args.tag),
             (args.root, args.tag), (args.vs, "parent")]
    got = []
    for k, (root, tag) in enumerate(turns):
        cmd = [sys.executable, me, "--pscan", "--root", root, "--tag", tag]
        if args.sass and k == 1:
            cmd += ["--sass", args.sass]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=here)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            sys.exit(f"chip_kernel_bench --pscan for {root} failed "
                     f"({proc.returncode})")
        got += [json.loads(ln.split(" ", 1)[1])
                for ln in proc.stdout.splitlines()
                if ln.startswith("PSCAN_RESULT ")]
    for what in ("butter7", "butter16", "butter5_shifted"):
        for key in ("iir_pscan_ms", "iir_scan_ms", "block_ms"):
            vals = [f"{r['tag']} {r[what][key][0]:.4f}/{r[what][key][1]:.4f}"
                    for r in got if key in r[what]]
            if vals:
                print(f"{what} {key[:-3]}, ms, turns in order: "
                      + "; ".join(vals), flush=True)
    for be in ("pscan", "block", "scan"):
        vals = [f"{r['tag']} {r['steps'][be][0]:.4f}/{r['steps'][be][1]:.4f}"
                for r in got if be in r["steps"]]
        if vals:
            print(f"a block through iirfilt_sos(butter 7, backend={be!r}), "
                  f"ms, turns in order: " + "; ".join(vals), flush=True)


FUSED_PLL = (("qpsk", 13), ("qam16", 32))   # pll_lms's cases in --fused


def fused_bench(torch, cs, build, tag, name, save):
    """--fused for one checkout (see the module's docstring)."""
    import json
    from liquid_dsp_tpu_torch.framing.symtrack import symtrack_stream
    from liquid_dsp_tpu_torch.ops.kernels.pll_lms import pll_lms
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib = build.build()
    build.load_library()
    print(f"{tag} built in {time.perf_counter() - t0:.1f} s", flush=True)
    print_ptxas(lib, tag, ("pll_lms", "symsync"))
    result, outs = {"tag": name}, {}
    for ms, L in FUSED_PLL:
        st = symtrack_stream(ms=ms, eq_len=L).to(dev)
        B, S = 256, 12288
        sr, si, sv = cs.synth_slots(torch, dev, st, B, S, 1 / 6, L)
        pc = st.pll_state(st.init(batch_shape=(B,), device=dev), B)
        args = (sr, si, sv, pc, st.tab_re, st.tab_im)
        y_re, y_im, dec, stt = pll_lms(*args, **st.pll_kwargs())
        outs[ms] = {"y_re": y_re.cpu(), "y_im": y_im.cpu(), "dec": dec.cpu(),
                    **{k: v.cpu() for k, v in stt.items()}}
        ms_ = [cs.time_ms(lambda: pll_lms(*args, **st.pll_kwargs()))
               for _ in range(2)]
        result[f"pll_lms_{ms}"] = ms_
        print(f"{tag} pll_lms {ms} L={L} at {B} x {S} slots: {ms_[0]:.4f}, "
              f"{ms_[1]:.4f} ms", flush=True)
    torch.save(outs, save)
    if hasattr(cs, "fused_phase"):
        fused_steps(torch, cs, dev, tag, result)
    print("FUSED_RESULT " + json.dumps(result), flush=True)


WINDOWS = (32, 8, 4, 2)   # the fused kernel's filter rows a step, timed


def fused_steps(torch, cs, dev, tag, result):
    """--fused's tracker part for a checkout with the fused kernel: the
    kernel per 4096-step chunk against the sequential route's kernels on
    the same chunk; both routes' steps and symsync(k=2, m=5) alone at
    256 x 32768 (host clock, CUDA events); each route's step profiled
    (device ms, operations, kernel launches, the convolutions' share);
    for a checkout whose fused kernel takes the input planes (it has
    ops/kernels/branch_bank.py), also the whole block in one launch at
    WINDOWS rows a step (32: the full bank; with the misses), and
    branch_bank against F.conv1d on the tracker's block."""
    import torch.nn.functional as F
    from liquid_dsp_tpu_torch.framing.symtrack import symtrack_stream
    from liquid_dsp_tpu_torch.ops.kernels.pll_lms import pll_lms as pl
    from liquid_dsp_tpu_torch.ops.kernels.symsync_pll_lms import \
        symsync_pll_lms
    from liquid_dsp_tpu_torch.ops.kernels.symsync_scan import symsync_scan
    from liquid_dsp_tpu_torch.ops.symsync import symsync
    try:
        from liquid_dsp_tpu_torch.ops.kernels.branch_bank import branch_bank
    except ImportError:          # the fused kernel on branch outputs
        branch_bank = None
    B, T, warm = 256, 1 << 15, 8192
    x, _ = cs.make_timing_stream(np.random.default_rng(41), B, warm + T,
                                 7, 20.0, True)
    x = torch.from_numpy(x).to(dev)
    st = symtrack_stream().to(dev)
    c = st.init(batch_shape=(B,), device=dev)
    os.environ["LIQUID_SYMTRACK_FUSED"] = "0"
    _, c = st(c, x[:, :warm])
    kw = dict(npfb=32, max_out=3, k=2, k_out=1, bw=st.sync_bw, locked=False)
    inp = cs.fused_inputs(torch, st, c, x[:, warm:warm + 4096])
    if branch_bank is None:
        ma, fs, is_, pc = inp
        bank = (lambda: ma)
        fused_args = (ma,)
    else:
        planes, kern, fs, is_, pc = inp
        bank = (lambda: branch_bank(planes, kern))
        fused_args = (planes, kern)

    def seq():
        sr_, si_, sv_, _, _ = symsync_scan(bank(), fs, is_, **kw)
        return pl(sr_, si_, sv_, pc, st.tab_re, st.tab_im, **st.pll_kwargs())

    def fused():
        return symsync_pll_lms(*fused_args, fs, is_, pc, st.post, **kw)

    chunk = [cs.time_ms(f, iters=10) for f in (fused, seq, seq, fused)]
    del inp, fused_args
    steps, prof = {}, {}
    xb = x[:, warm:]
    for route in ("1", "0", "0", "1"):
        os.environ["LIQUID_SYMTRACK_FUSED"] = route
        steps.setdefault(route, []).append(
            cs.time_ms(lambda: st(c, xb), iters=5))
    ss = symsync(k=2, m=5).to(dev)
    cs_ss = ss.init(batch_shape=(B,), device=dev)
    _, cs_ss = ss(cs_ss, x[:, :warm])
    ss_ms = [cs.time_ms(lambda: ss(cs_ss, xb), iters=5) for _ in range(2)]
    for route in ("1", "0"):
        os.environ["LIQUID_SYMTRACK_FUSED"] = route
        n0 = symsync_pll_lms.launches
        st(c, xb)
        torch.cuda.synchronize()
        launches = symsync_pll_lms.launches - n0
        by_name, wall = cs.device_profile(torch, lambda: st(c, xb), 3,
                                          f"route {route}")
        conv = [(k_, v_) for k_, v_ in by_name.items()
                if "conv" in k_.lower() or "cudnn" in k_.lower()]
        prof[route] = {
            "device_ms": sum(t for t, _ in by_name.values()) / 3,
            "operations": sum(n for _, n in by_name.values()) / 3,
            "busy": sum(t for t, _ in by_name.values()) / wall,
            "fused_launches_a_block": launches,
            "conv_ms": sum(t for _, (t, _) in conv) / 3,
            "top": {k_[:60]: [t / 3, n / 3] for k_, (t, n) in sorted(
                by_name.items(), key=lambda kv: -kv[1][0])[:6]}}
    result.update(chunk_fused=[chunk[0], chunk[3]],
                  chunk_sequential=[chunk[1], chunk[2]],
                  step_fused=steps["1"], step_sequential=steps["0"],
                  symsync_step=ss_ms, profile=prof)
    print(f"{tag} per 4096-step chunk at {B} channels: symsync_pll_lms "
          f"{chunk[0]:.4f}, {chunk[3]:.4f} ms against the sequential "
          f"route's kernels {chunk[1]:.4f}, {chunk[2]:.4f} ms; steps at {B} "
          f"x {T}: symtrack_stream fused {steps['1'][0]:.4f}, "
          f"{steps['1'][1]:.4f} ms, sequential {steps['0'][0]:.4f}, "
          f"{steps['0'][1]:.4f} ms; symsync(k=2, m=5) {ss_ms[0]:.4f}, "
          f"{ss_ms[1]:.4f} ms", flush=True)
    for route, pr in prof.items():
        print(f"{tag} profile, {'fused' if route == '1' else 'sequential'} "
              f"route step: device {pr['device_ms']:.3f} ms in "
              f"{pr['operations']:.0f} operations, busy {pr['busy']:.3f}; "
              f"symsync_pll_lms launches a block "
              f"{pr['fused_launches_a_block']}; convolutions "
              f"{pr['conv_ms']:.3f} ms; by kernel (ms, launches): "
              + "; ".join(f"{k_} {t:.3f} ({n:.0f})"
                          for k_, (t, n) in pr["top"].items()), flush=True)
    if branch_bank is None:
        return
    planes, kern, fs, is_, pc = cs.fused_inputs(torch, st, c, xb)
    blk = {}
    for win in WINDOWS + WINDOWS[::-1]:
        blk.setdefault(str(win), []).append(cs.time_ms(
            lambda: symsync_pll_lms(planes, kern, fs, is_, pc, st.post,
                                    win=win, **kw), iters=3))
    miss = {str(w): int(symsync_pll_lms(planes, kern, fs, is_, pc, st.post,
                                        win=w, **kw).misses.sum())
            for w in WINDOWS}
    bb = [cs.time_ms(lambda: branch_bank(planes, kern), iters=3)
          for _ in range(2)]
    torch.cuda.empty_cache()
    wk = kern[:, None].contiguous()
    cv = [cs.time_ms(lambda: F.conv1d(planes.reshape(2 * B, 1, -1), wk),
                     iters=3) for _ in range(2)]
    result.update(block_by_rows=blk, misses_by_rows=miss, branch_bank=bb,
                  conv1d=cv)
    print(f"{tag} symsync_pll_lms on a whole {B} x {T} block by rows a "
          f"step: " + "; ".join(f"{w} rows {', '.join(f'{t:.4f}' for t in v)}"
                                f" ms ({miss[w]} misses)"
                                for w, v in blk.items())
          + f"; branch_bank on that block {bb[0]:.4f}, {bb[1]:.4f} ms "
          f"against F.conv1d {cv[0]:.4f}, {cv[1]:.4f} ms", flush=True)


def fused_turns(args):
    """--fused --vs DIR: this script's --fused for DIR and for this
    checkout in turns (DIR, this, this, DIR), each in its own process;
    then the two checkouts' pll_lms outputs against each other and their
    times side by side."""
    import json
    import torch
    here = os.path.dirname(os.path.abspath(__file__))
    me = os.path.abspath(__file__)
    turns = [(args.vs, "parent"), (args.root, args.tag),
             (args.root, args.tag), (args.vs, "parent")]
    got, saved = [], {}
    for k, (root, tag) in enumerate(turns):
        save = os.path.join(here, "build", f"fused_{tag}_{k}.pt")
        cmd = [sys.executable, me, "--fused", "--root", root, "--tag", tag,
               "--save", save]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=here)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            sys.exit(f"chip_kernel_bench --fused for {root} failed "
                     f"({proc.returncode})")
        got += [json.loads(ln.split(" ", 1)[1])
                for ln in proc.stdout.splitlines()
                if ln.startswith("FUSED_RESULT ")]
        saved.setdefault(tag, torch.load(save))
    par, new = saved["parent"], saved[args.tag]
    for ms, L in FUSED_PLL:
        a, b = new[ms], par[ms]
        dy = max(float((a[k] - b[k]).abs().max()) for k in ("y_re", "y_im"))
        same = {k: bool(torch.equal(a[k], b[k])) for k in a}
        print(f"pll_lms {ms} L={L}, {args.tag} against parent: y largest "
              f"difference {dy:.3e}; equal: {same}", flush=True)
        cells = "; ".join(f"{r['tag']} {r[f'pll_lms_{ms}'][0]:.4f}, "
                          f"{r[f'pll_lms_{ms}'][1]:.4f}" for r in got)
        print(f"pll_lms {ms} ms, turns in order: {cells}", flush=True)
    for r in got:
        if "profile" not in r:
            continue
        pf, ps = r["profile"]["1"], r["profile"]["0"]
        print(f"turn {r['tag']}: symtrack_stream step fused "
              f"{', '.join(f'{t:.4f}' for t in r['step_fused'])} ms "
              f"(device {pf['device_ms']:.3f} ms, convolutions "
              f"{pf['conv_ms']:.3f}, symsync_pll_lms launches a block "
              f"{pf['fused_launches_a_block']}), sequential "
              f"{', '.join(f'{t:.4f}' for t in r['step_sequential'])} ms "
              f"(device {ps['device_ms']:.3f}, convolutions "
              f"{ps['conv_ms']:.3f}); symsync "
              f"{', '.join(f'{t:.4f}' for t in r['symsync_step'])} ms; "
              f"chunk fused {', '.join(f'{t:.4f}' for t in r['chunk_fused'])}"
              f", sequential "
              f"{', '.join(f'{t:.4f}' for t in r['chunk_sequential'])}",
              flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--no-steps", action="store_true")
    ap.add_argument("--sass", metavar="DIR")
    ap.add_argument("--ffma-rate", action="store_true")
    ap.add_argument("--mma-probe", action="store_true")
    ap.add_argument("--viterbi", action="store_true")
    ap.add_argument("--latency", action="store_true")
    ap.add_argument("--iir", action="store_true")
    ap.add_argument("--cvsd", action="store_true")
    ap.add_argument("--eq", action="store_true")
    ap.add_argument("--vs", metavar="DIR")
    ap.add_argument("--no-variants", action="store_true")
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--fold", action="store_true")
    ap.add_argument("--pscan", action="store_true")
    ap.add_argument("--save", metavar="FILE", default="build/fused.pt")
    args = ap.parse_args()
    if args.eq and args.vs:
        eq_turns(args)
        return
    if args.fused and args.vs:
        fused_turns(args)
        return
    if args.fold and args.vs:
        fold_turns(args)
        return
    if args.pscan and args.vs:
        pscan_turns(args)
        return
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_kernel_bench: needs one CUDA card")
    import chip_smoke as cs
    from liquid_dsp_tpu_torch import chain, fuse, kernel_fuse, planar
    from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
    from liquid_dsp_tpu_torch.ops.fir import firfilt
    from liquid_dsp_tpu_torch.ops.kernels import build
    from liquid_dsp_tpu_torch.ops.kernels.fir_real import (
        fir_real, fir_real_reference)
    from liquid_dsp_tpu_torch.ops.kernels.mix_fir_decim import (
        SUB, mix_fir_decim, mix_fir_decim_reference)
    from liquid_dsp_tpu_torch.ops.nco import nco
    from liquid_dsp_tpu_torch.ops.resample import msresamp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    tag = f"[{args.tag}] ({card})"
    if args.ffma_rate:
        ffma_rate(torch, cs, build, tag)
        return
    if args.mma_probe:
        mma_probe(torch, cs, build, tag)
        return
    if args.latency:
        latency(torch, build, tag)
        return
    if args.viterbi:
        viterbi_bench(torch, cs, build, tag, args.tag, args.sass)
        return
    if args.iir:
        iir_bench(torch, cs, build, tag, args.tag, args.sass)
        return
    if args.cvsd:
        cvsd_bench(torch, cs, build, tag, args.tag, args.sass)
        return
    if args.eq:
        eq_bench(torch, cs, build, tag, args.tag, not args.no_variants)
        return
    if args.fused:
        fused_bench(torch, cs, build, tag, args.tag, args.save)
        return
    if args.fold:
        fold_bench(torch, cs, tag, args.tag, args.sass)
        return
    if args.pscan:
        pscan_bench(torch, cs, build, tag, args.tag, args.sass)
        return
    t0 = time.perf_counter()
    lib = build.build()
    build.load_library()
    print(f"{tag} built {root} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print_ptxas(lib, tag, ("mix_fir", "fir_real"))

    def rel(y, ref):
        d = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(y, ref))
        rms = torch.stack([r.float() for r in ref]).square().mean().sqrt()
        return d / float(rms)

    # mix_fir_decim at the headline shape: the chain's own fused taps
    B, T = 64, 1 << 18
    stages = chain(nco(dphi=cs.DPHI, direction="down"),
                   firfilt(firdes_kaiser(64, 0.2, 60.0)),
                   firfilt(firdes_kaiser(57, 0.3, 60.0)),
                   msresamp(0.5, 60.0))
    proc = planar(kernel_fuse(fuse(stages))).to(dev)
    kern = proc.inner
    gen = torch.Generator(device=dev).manual_seed(0)
    xr = torch.randn(B, T, generator=gen, device=dev)
    xi = torch.randn(B, T, generator=gen, device=dev)
    cr = torch.randn(B, SUB, generator=gen, device=dev)
    ci = torch.randn(B, SUB, generator=gen, device=dev)
    theta = torch.tensor(2.9, device=dev)

    def mfd(fn, a, b, down, out_dtype=torch.float32):
        return fn(a, b, cr, ci, theta, kern.ramp_c, kern.ramp_s, kern.taps,
                  down=down, sgn=kern.sgn, dphi=kern.dphi,
                  out_dtype=out_dtype)

    err = rel(mfd(mix_fir_decim, xr, xi, 2),
              mfd(mix_fir_decim_reference, xr, xi, 2))
    # 100 launches a reading: the wrappers' host work (tens of
    # microseconds a call) must stay under the kernels' time
    k1 = cs.time_ms(lambda: mfd(mix_fir_decim, xr, xi, 2), iters=100)
    k2 = cs.time_ms(lambda: mfd(mix_fir_decim, xr, xi, 2), iters=100)
    xb = (xr.bfloat16(), xi.bfloat16())
    kb = cs.time_ms(lambda: mfd(mix_fir_decim, xb[0], xb[1], 2,
                                torch.bfloat16), iters=100)
    L = int(kern.taps.numel())
    print(f"{tag} mix_fir_decim {B} x {T}, {L} taps, down 2: {k1:.4f}, "
          f"{k2:.4f} ms; bf16 planes {kb:.4f} ms; max|err|/rms against the "
          f"plain version {err:.3e}", flush=True)
    other = []
    for down in (1, 4, 8):
        ms = cs.time_ms(lambda: mfd(mix_fir_decim, xr, xi, down), iters=100)
        other.append(f"down {down}: {ms:.4f} ms")
    print(f"{tag} mix_fir_decim {B} x {T}, {L} taps, " + "; ".join(other),
          flush=True)
    c0 = proc.init(batch_shape=(B,), device=dev)
    s1 = cs.time_ms(lambda: proc(c0, (xr, xi)), iters=100)
    s2 = cs.time_ms(lambda: proc(c0, (xr, xi)), iters=100)
    print(f"{tag} headline step {B} x {T}: {s1:.4f}, {s2:.4f} ms", flush=True)
    del xb

    # fir_real at 128 rows (64 complex channels as planes)
    rows = torch.cat([xr, xi]).contiguous()
    for taps_n in (144, 13, 1024):
        h = torch.from_numpy(np.asarray(
            firdes_kaiser(taps_n, 0.2, 60.0), np.float32)).to(dev)
        crow = torch.randn(rows.shape[0], taps_n - 1, generator=gen,
                           device=dev)
        e = rel([fir_real(rows[:8], crow[:8], h)],
                [fir_real_reference(rows[:8], crow[:8], h)])
        f1 = cs.time_ms(lambda: fir_real(rows, crow, h), iters=100)
        f2 = cs.time_ms(lambda: fir_real(rows, crow, h), iters=100)
        print(f"{tag} fir_real {rows.shape[0]} x {T}, {taps_n} taps: "
              f"{f1:.4f}, {f2:.4f} ms; max|err|/rms against the plain "
              f"version (8 rows) {e:.3e}", flush=True)
    del rows, xr, xi

    if args.sass:
        seen = set()

        def pick(ln):
            # fir_real, and mix_fir_decim's instance for float planes (at
            # down 2 where the factor is a template parameter)
            name = "fir_real" if "fir_real" in ln else (
                "mix_fir_decim" if "mix_fir_decim" in ln and (
                    "ILi2ELi16EffE" in ln or "kernelIffE" in ln) else None)
            if name is None or name in seen:
                return False
            seen.add(name)
            return True

        path, n = write_sass(build, lib, args.sass, f"sass_{args.tag}.txt",
                             pick)
        print(f"{tag} SASS of fir_real and mix_fir_decim (f32, down 2): "
              f"{path} ({n} lines)", flush=True)

    if args.no_steps:
        return
    from liquid_dsp_tpu_torch.framing.frame64 import framesync64_stream_full
    from liquid_dsp_tpu_torch.framing.symtrack import symtrack_stream
    # the tracker step
    B, T = 256, 1 << 15
    xt, _ = cs.make_timing_stream(np.random.default_rng(11), B, 2 * T, 7,
                                  20.0, True)
    xt = torch.from_numpy(xt).to(dev)
    st = symtrack_stream(ms="qpsk").to(dev)
    _, c1 = st(st.init(batch_shape=(B,), device=dev), xt[:, :T])
    blk = xt[:, T:]
    t1 = cs.time_ms(lambda: st(c1, blk), iters=3)
    t2 = cs.time_ms(lambda: st(c1, blk), iters=3)
    print(f"{tag} symtrack_stream step {B} x {T}: {t1:.4f}, {t2:.4f} ms",
          flush=True)
    cs.profile_steps(torch, f"{args.tag}; {card}", lambda: st(c1, blk), 3,
                     f"symtrack_stream step at {B}x{T}")
    del xt, blk
    # the receiver step
    xr, _ = cs.make_rx_stream(np.random.default_rng(7))
    xr = torch.from_numpy(xr).to(dev)
    rx = framesync64_stream_full(cs.RX_T).to(dev)
    _, r1 = rx(rx.init(batch_shape=(cs.RX_B,), device=dev), xr[:, :cs.RX_T])
    rblk = xr[:, cs.RX_T:2 * cs.RX_T]
    r_1 = cs.time_ms(lambda: rx(r1, rblk), iters=10)
    r_2 = cs.time_ms(lambda: rx(r1, rblk), iters=10)
    print(f"{tag} framesync64_stream_full step {cs.RX_B} x {cs.RX_T}: "
          f"{r_1:.4f}, {r_2:.4f} ms", flush=True)
    cs.profile_steps(torch, f"{args.tag}; {card}", lambda: rx(r1, rblk), 3,
                     f"framesync64_stream_full step at {cs.RX_B}x{cs.RX_T}")


if __name__ == "__main__":
    main()
