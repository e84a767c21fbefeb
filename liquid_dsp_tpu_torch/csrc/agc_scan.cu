// The AGC gain recurrence over instantaneous power, for Hopper (sm_90a).
//
// Replaces the lax.scan of liquid_dsp_tpu/ops/agc.py:39-50 (agc_scan and
// the agc Proc's planar_apply); the JAX package has no Pallas kernel
// here, and PyTorch has no scan that stays on the device.
//
// What it computes, per channel b and sample t (agc.py:41-46):
//   y2p = (1-alpha)*y2p + (alpha*(g*g))*p[b, t]
//   gains[b, t] = g
//   unless locked: g = y2p > 1e-6 ? g*exp((-alpha/2)*log(y2p)) : g;
//                  g = min(g, 1e6)
// The caller scales x by the gains outside, as the JAX package does.
//
// Bound on this card: the latency of one dependent chain per channel.
// Each sample's gain needs the last one's, through four products and a
// sum, a log, an exp, a product and a min; the 8 bytes a sample moves are
// nothing beside it, and a few hundred channels fill 8 of the card's
// 8,448 warps.  The time axis cannot be split: the recurrence has no
// closed form.  So the design is about the length of that chain and about
// keeping everything else off it:
//
// * One lane per channel: 32 channels share the chain warp's
//   instructions, B channels spread over B/32 SMs.  A lone warp issues
//   well under one instruction a cycle, so every instruction it runs
//   beside the chain costs time: it runs the chain and nothing else.
// * One basic block per 8 samples.  ptxas schedules inside a basic block
//   only, so the guard y2p > 1e-6 is a select, `locked` a template
//   parameter, and the body is unrolled by 8: the loads of the next
//   samples from shared memory, the stores of the last gains and
//   (1-alpha)*y2p fill the chain's idle issue slots.
// * The log and the exp are written here for the loop's own domain (y2p a
//   positive normal float above 1e-6 where the value is used, the
//   exponent bounded by 44 alpha), without a branch or a special case:
//   log(y) = e ln2 + f + f^2 P(f) with y = 2^e (1 + f), f in [-1/3, 1/3),
//   taken from the float's bits; exp(x) = 2^j (1 + r + r^2 Q(r)) with
//   j = rint(x log2 e) by the magic-number add and r = x - j ln2 in two
//   steps.  The guard is a select of the exponent's factor (-alpha/2 or
//   0, beside the log): with 0 the exp is exactly 1.  P (degree 8) and Q (degree 5) go by Estrin's scheme: their
//   pairs c + c' f are ready when f^4 is, two or three fused steps follow.
//   Each is below 1 ulp of float32 against float64.
// * Memory off the chain, in full lines, by a second warp.  It brings
//   tiles of p, 32 channels x 32 samples, into shared memory by cp.async
//   two tiles ahead: a 128-byte line of one channel per instruction, into
//   rows of pitch 33 floats, so the chain lanes' walk down their own rows
//   hits 32 different banks.  The chain warp leaves its gains in shared
//   memory the same way, and the second warp stores the last tile's as
//   full lines.  The two meet at one barrier per tile.  4-byte cp.async:
//   any T, no alignment asked; a last ragged tile runs sample by sample.
//
// Numerics: every operation is rounded once and written explicitly
// (__fmul_rn, __fadd_rn, __fmaf_rn; integer operations on the float's
// bits), so nvcc contracts and reorders nothing, and the plain PyTorch
// version (ops/kernels/agc_scan.py: agc_log, agc_exp) takes the same
// operations in the same order, an exact FMA where this takes __fmaf_rn.
// The two agree bit for bit on the card.
//
// Built by liquid_dsp_tpu_torch/ops/kernels/build.py with nvcc for sm_90a,
// bound with ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int LANES = 32;        // channels per block: a chain per lane
constexpr int TILE = 32;         // samples per staged tile: one line a channel
constexpr int PITCH = TILE + 1;  // row pitch in shared memory, in floats
constexpr int GROUP = 8;         // samples per basic block
constexpr int PBUF = 4;          // p tiles in shared memory (two ahead)

// ln(y) for a positive normal y, below 1 ulp; the coefficients and the
// order of operations are agc_log's in ops/kernels/agc_scan.py.
__device__ __forceinline__ float agc_log(float y) {
  const int ix = __float_as_int(y);
  const int e = (ix - 0x3f2aaaab) >> 23;            // y = 2^e m, m in [2/3, 4/3)
  const float f = __fadd_rn(
      __uint_as_float(static_cast<unsigned>(ix) -
                      (static_cast<unsigned>(e) << 23)), -1.0f);   // exact
  const float f2 = __fmul_rn(f, f);
  const float f4 = __fmul_rn(f2, f2);
  const float a0 = __fadd_rn(-0.5f, __fmul_rn(0.33333272f, f));
  const float a1 = __fadd_rn(-0.24999945f, __fmul_rn(0.20007233f, f));
  const float a2 = __fadd_rn(-0.16673316f, __fmul_rn(0.14055812f, f));
  const float a3 = __fmaf_rn(f2, -0.124222f,
                             __fadd_rn(-0.12288722f, __fmul_rn(0.13748309f, f)));
  const float b0 = __fmaf_rn(f2, a1, a0);
  const float b1 = __fmaf_rn(f2, a3, a2);
  const float r = __fmaf_rn(f2, __fmaf_rn(f4, b1, b0), f);
  return __fmaf_rn(static_cast<float>(e), 0.693147182f, r);
}

// exp(x) for |x| < 87, below 1 ulp; agc_exp's operations in order.  t is
// x log2(e) + 1.5 2^23 rounded once (its low bits hold j = rint(x log2 e));
// the caller forms it beside x.
__device__ __forceinline__ float agc_exp(float x, float t) {
  const float jf = __fadd_rn(t, -12582912.0f);
  float r = __fmaf_rn(jf, -0.693145751953125f, x);
  r = __fmaf_rn(jf, -1.42860677e-06f, r);
  const float r2 = __fmul_rn(r, r);
  const float r4 = __fmul_rn(r2, r2);
  const float q0 = __fadd_rn(0.5f, __fmul_rn(0.16666667f, r));
  const float q1 = __fadd_rn(4.1666456e-02f, __fmul_rn(8.3333105e-03f, r));
  const float q2 = __fadd_rn(1.3934541e-03f, __fmul_rn(1.9891981e-04f, r));
  const float s = __fmaf_rn(r2, __fmaf_rn(r4, q2, __fmaf_rn(r2, q1, q0)), r);
  // 2^j (1 + s): the sum rounded once, the power of two exact
  const float scale =
      __int_as_float((__float_as_int(t) - 0x4b400000 + 127) << 23);
  return __fmaf_rn(s, scale, scale);
}

// One sample: returns the gain that applies to it and steps (g, y2p).
// ch is -alpha/2 and chl its float32 product with log2(e).  The guard
// y2p > 1e-6 picks the exponent's factor (ch or 0) beside the log, off the
// chain: with 0 the exp is exactly 1 and g stays.
template <bool LOCKED>
__device__ __forceinline__ float agc_step(float& g, float& y2p, float pt,
                                          float c1, float ca, float ch,
                                          float chl) {
  const float g_out = g;
  y2p = __fadd_rn(__fmul_rn(c1, y2p),
                  __fmul_rn(__fmul_rn(ca, __fmul_rn(g, g)), pt));
  if (!LOCKED) {
    const bool on = y2p > 1e-6f;
    const float lg = agc_log(y2p);
    const float x = __fmul_rn(lg, on ? ch : 0.f);
    const float t = __fmaf_rn(lg, on ? chl : 0.f, 12582912.0f);
    g = fminf(__fmul_rn(g, agc_exp(x, t)), 1e6f);
  }
  return g_out;
}

template <bool LOCKED>
__global__ void __launch_bounds__(2 * LANES)
agc_scan_kernel(const float* __restrict__ p, float* __restrict__ g_io,
                float* __restrict__ y2p_io, float* __restrict__ gains, int B,
                int T, float c1, float ca, float ch) {
  __shared__ float sp[PBUF][LANES * PITCH];   // p tiles, [channel][sample]
  __shared__ float sg[2][LANES * PITCH];      // gain tiles
  const int lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * LANES;
  const int nch = min(LANES, B - b0);         // channels of this block
  const int ntiles = (T + TILE - 1) / TILE;

  if (nch < LANES) {   // the idle lanes of a ragged last block read zeros
    for (int q = threadIdx.x; q < PBUF * LANES * PITCH; q += 2 * LANES)
      (&sp[0][0])[q] = 0.f;
    __syncthreads();
  }

  if (threadIdx.x >= LANES) {
    // the copying warp
    const float* pin = p + static_cast<size_t>(b0) * T;
    float* gout = gains + static_cast<size_t>(b0) * T;
    // tile nt of p into its buffer, a line per instruction (nothing for a
    // tile past the end); closes a group either way
    auto stage = [&](int nt) {
      const int t = nt * TILE + lane;
      if (t < T) {
        float* dst = sp[nt % PBUF] + lane;
        for (int r = 0; r < nch; ++r)
          cp_async_f32(dst + r * PITCH, pin + static_cast<size_t>(r) * T + t);
      }
      cp_async_commit();
    };
    stage(0);
    stage(1);
    cp_async_wait_all_but<1>();   // tile 0 has landed
    tile_barrier();
    for (int nt = 0; nt < ntiles; ++nt) {
      // the chain warp works on tile nt: store tile nt-1's gains, start
      // tile nt+2, wait for tile nt+1
      const int t = (nt - 1) * TILE + lane;
      if (nt > 0 && t < T) {
        const float* src = sg[(nt - 1) & 1] + lane;
        for (int r = 0; r < nch; ++r)
          gout[static_cast<size_t>(r) * T + t] = src[r * PITCH];
      }
      stage(nt + 2);
      cp_async_wait_all_but<1>();
      tile_barrier();
    }
    const int t = (ntiles - 1) * TILE + lane;
    if (t < T) {
      const float* src = sg[(ntiles - 1) & 1] + lane;
      for (int r = 0; r < nch; ++r)
        gout[static_cast<size_t>(r) * T + t] = src[r * PITCH];
    }
    return;
  }

  // the chain warp
  const bool live = lane < nch;
  float g = live ? g_io[b0 + lane] : 1.f;
  float y2p = live ? y2p_io[b0 + lane] : 1.f;
  const float chl = __fmul_rn(ch, 1.44269502f);
  tile_barrier();
  for (int nt = 0; nt < ntiles; ++nt) {
    const float* in = sp[nt % PBUF] + lane * PITCH;
    float* out = sg[nt & 1] + lane * PITCH;
    const int left = T - nt * TILE;
    if (left >= TILE) {
#pragma unroll 1
      for (int q = 0; q < TILE; q += GROUP) {
#pragma unroll
        for (int s = 0; s < GROUP; ++s)
          out[q + s] = agc_step<LOCKED>(g, y2p, in[q + s], c1, ca, ch, chl);
      }
    } else {
      for (int s = 0; s < left; ++s)
        out[s] = agc_step<LOCKED>(g, y2p, in[s], c1, ca, ch, chl);
    }
    tile_barrier();
  }
  if (live) {
    g_io[b0 + lane] = g;
    y2p_io[b0 + lane] = y2p;
  }
}

}  // namespace

// p: [B, T] float32, contiguous.  g, y2p: [B] float32, read and
// overwritten in place.  gains: [B, T] float32.  c1, ca, ch: 1-alpha,
// alpha and -alpha/2 rounded to float32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int agc_scan_launch(const void* p, void* g, void* y2p, void* gains,
                               int B, int T, int locked, float c1, float ca,
                               float ch, void* stream) {
  if (B < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + LANES - 1) / LANES);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define AGC_SCAN_ARGS                                                     \
  static_cast<const float*>(p), static_cast<float*>(g),                   \
      static_cast<float*>(y2p), static_cast<float*>(gains), B, T, c1, ca, ch
  if (locked)
    agc_scan_kernel<true><<<grid, 2 * LANES, 0, st>>>(AGC_SCAN_ARGS);
  else
    agc_scan_kernel<false><<<grid, 2 * LANES, 0, st>>>(AGC_SCAN_ARGS);
#undef AGC_SCAN_ARGS
  return static_cast<int>(cudaGetLastError());
}
