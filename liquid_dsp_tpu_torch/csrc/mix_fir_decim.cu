// Mixer + fused real-tap FIR + decimation in one pass, for Hopper (sm_90a).
//
// Replaces liquid_dsp_tpu/ops/kernels/pallas_chain.py:mix_fir_decim, the
// TPU kernel behind fuse.kernel_fuse on the headline chain
// nco -> firfilt -> firfilt -> msresamp(0.5) (144 taps, down=2).
//
// What it computes, per channel b and input tile t of TILE samples:
//   w[q]  = x[t*TILE - (L-1) + q]          q in [0, TILE+L-1)
//           (samples before the block come from the carry: the last SUB
//           raw pre-mix samples of the previous block)
//   m[q]  = w[q] * exp(sgn*j*(phase_t + dphi*(q-(L-1))))
//           by angle addition: the per-tile (cos, sin) of phase_t times
//           the host ramp cos/sin(dphi*(q-(L-1))), so no per-sample sinf
//           of a large f32 argument is ever taken
//   y[o]  = sum_{j<L} h[j] * m[down*o + (L-1) - j]   o in [0, TILE/down)
//           h = fold_offset(taps, d), so the strided offset is in h
//
// Bound on this card: the FIR's float32 multiply-adds (L per output per
// plane: 2.4 G per 64x262144 block at L=144), not device-memory bytes
// (about 12 B per complex input sample at f32).  What the kernel is held
// by is instruction issue: four fifths of its instructions are the FIR's
// multiply-adds, and a multiply-add whose two other register operands are
// new issues at 0.81 per clock and SM sub-partition at best
// (chip_kernel_bench.py --ffma-rate; NVIDIA H100 80GB HBM3 at 700 W).
// The design:
//   * a block walks up to 4 consecutive tiles of one channel.  While one
//     tile's FIR runs, the next tile's raw window (its TILE samples and
//     the L-1 before them, again from device memory: CUDA blocks run in
//     no order, so unlike the TPU kernel no halo rides between blocks,
//     and within a block the halo comes from the L2 cache) is in flight
//     into a second shared buffer by cp.async, so the loads wait under
//     the multiply-adds and not before them.  Each tile takes its own
//     phase: cos/sin of the wrapped per-tile phase, formed in the kernel
//     with the plain version's roundings;
//   * mixes the window once into shared memory, split into its `down`
//     polyphase components m_p[k] = m[down*k + p], so the strided FIR
//     becomes `down` unit-stride correlations
//         y[o] = sum_p sum_a g_p[a] * m_p[o + a],  g_p[a] = h[L-1-down*a-p];
//   * runs each correlation through fir_window.cuh's loop: a work unit is
//     R consecutive outputs of one plane (re or im; the two planes go to
//     different warps), 16-byte shared loads only, 2 loads per 4 taps and
//     4 R multiply-adds, so the multiply-add pipe and not the shared-memory
//     pipe sets the pace;
//   * `down` is a template parameter for 1, 2, 4 and 8 (R = 16 for 1 and
//     2, else 8, so that a tile still has a unit for every thread where it
//     can), and a run-time value for every other divisor of SUB, in the
//     same kernel: the launch only selects the template;
//   * several blocks are resident per SM (about 40 KB of shared memory
//     and 128 threads each at the headline shape), so one block's mix
//     pass (shared to shared) runs under the others' FIR;
//   * stores each unit's R outputs as 16-byte vectors.
//
// Built by liquid_dsp_tpu_torch/ops/kernels/build.py with nvcc for
// sm_90a, bound with ctypes; the C entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "fir_window.cuh"

namespace {

using firwin::PAD;

constexpr int SUB = 256;      // carry length per channel (raw pre-mix samples)
constexpr int TILE = 2048;    // input samples per block; divides every legal T
constexpr int THREADS = 128;
constexpr int NT = 4;        // most tiles a block walks
constexpr int U = 6;         // samples a thread mixes per batch (3 batches a tile)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int R>
__device__ __forceinline__ void store_outputs(float* p, const float (&v)[R]) {
  float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int i = 0; i < R / 4; ++i)
    q[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

template <int R>
__device__ __forceinline__ void store_outputs(__nv_bfloat16* p,
                                              const float (&v)[R]) {
  uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int i = 0; i < R / 8; ++i) {
    __nv_bfloat162 h[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h[k] = __floats2bfloat162_rn(v[8 * i + 2 * k], v[8 * i + 2 * k + 1]);
    q[i] = *reinterpret_cast<const uint4*>(h);
  }
}

template <int R>
struct Layout {        // shared-memory layout, the same on host and device
  int no, A4, Ap, K, Ks, raw;
  __host__ __device__ Layout(int L, int down) {
    no = TILE / down;                                  // outputs per tile
    const int A = (L + down - 1) / down;               // taps per component
    A4 = (A + 3) / 4 * 4;                              // ... as the loop runs
    Ap = (A + R - 1) / R * R;                          // ... as stored
    K = no + Ap;                                       // entries per component
    Ks = K / R * (R + PAD);                            // padded stride
    raw = (TILE + L + 5) / 4 * 4;                      // raw words per plane
  }
  // words: taps, the mixed window (re | im), the raw window (re | im),
  // the tiles' phases
  __host__ __device__ size_t words(int down) const {
    return static_cast<size_t>(down) * (Ap + 2 * Ks) + 2 * raw + 2 * NT;
  }
};

// The phase of tile t, wrapped to [-pi, pi), as the wrapper's plain
// version forms it (tile_phases: separately rounded product and sum, then
// remainder(ph + pi, 2 pi) - pi in float32), and its (cos, sin).  The
// argument is small, so sincosf takes its fast path.
__device__ __forceinline__ void tile_phase(float theta, float step, int t,
                                           float* c, float* s) {
  const float pi = 3.14159265358979323846f, two_pi = 6.28318530717958647692f;
  const float a = __fadd_rn(__fadd_rn(theta, __fmul_rn(step, static_cast<float>(t))), pi);
  float r = fmodf(a, two_pi);
  if (r < 0.f) r = __fadd_rn(r, two_pi);
  sincosf(__fsub_rn(r, pi), s, c);
}

// DOWN > 0: the decimation factor at compile time; DOWN == 0: down_rt.
// Block (x, b) walks the tiles [x * nt, min((x + 1) * nt, T / TILE)) of
// channel b.
template <int DOWN, int R, typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
mix_fir_decim_kernel(const Tin* __restrict__ xr, const Tin* __restrict__ xi,
                     const float* __restrict__ carry_r,
                     const float* __restrict__ carry_i,
                     const float* __restrict__ theta,
                     const float* __restrict__ ramp_c,
                     const float* __restrict__ ramp_s,
                     const float* __restrict__ taps,
                     Tout* __restrict__ yr, Tout* __restrict__ yi,
                     int T, int L, int down_rt, int sgn, float tile_step,
                     int nt) {
  extern __shared__ __align__(16) float smem[];
  constexpr int VEC = 16 / sizeof(Tin);  // input elements per 16-byte copy
  const int down = DOWN ? DOWN : down_rt;
  const Layout<R> lay(L, down);
  float* g = smem;                       // [down][Ap] per-component taps
  float* m = g + down * lay.Ap;          // [2][down][Ks] mixed window, re | im
  float* mi = m + down * lay.Ks;
  float* raw_r = mi + down * lay.Ks;     // [raw] the next tile's raw window
  float* raw_i = raw_r + lay.raw;        //       (re, im)
  float* phase = raw_i + lay.raw;        // [NT][2] the tiles' (cos, sin)

  const int b = blockIdx.y;
  const int t_first = blockIdx.x * nt;
  const int t_end = min(t_first + nt, T / TILE);
  const long long row = static_cast<long long>(b) * T;
  const int W = TILE + L - 1;

  // Tile t's window is the samples [start, start + W) of the row, start =
  // t*TILE - (L-1).  Its part inside the row comes by cp.async in 16-byte
  // pieces, from the piece that holds sample max(start, 0): raw element i
  // is sample base(t) + i.  (The row starts on a piece: T is a multiple of
  // TILE and the planes are 16-byte aligned.)
  auto base = [&](int t) {
    const int first = max(t * TILE - (L - 1), 0);
    return first - first % VEC;
  };
  auto prefetch = [&](int t) {
    const int e0 = base(t);
    const int pieces = (t * TILE + TILE - e0 + VEC - 1) / VEC;
    const float4* sr = reinterpret_cast<const float4*>(xr + row + e0);
    const float4* si = reinterpret_cast<const float4*>(xi + row + e0);
    for (int j = threadIdx.x; j < pieces; j += THREADS) {
      cp_async_16(reinterpret_cast<float4*>(raw_r) + j, sr + j);
      cp_async_16(reinterpret_cast<float4*>(raw_i) + j, si + j);
    }
  };
  prefetch(t_first);

  for (int i = threadIdx.x; i < down * lay.Ap; i += THREADS) {
    const int p = i / lay.Ap, a = i - p * lay.Ap;
    const int j = L - 1 - (down * a + p);
    g[i] = j >= 0 ? taps[j] : 0.f;
  }
  auto put = [&](int q, float vr, float vi) {
    const int k = q / down;
    const int at = (q - k * down) * lay.Ks + firwin::padded<R>(k);
    m[at] = vr;
    mi[at] = vi;
  };
  // past the window: zeros (zero taps read them), written once
  for (int q = W + threadIdx.x; q < down * lay.K; q += THREADS)
    put(q, 0.f, 0.f);
  // every tile's phase once, a thread each (the remainder and the sincos
  // are a hundred instructions); the loop's first barrier hands them over
  if (threadIdx.x < t_end - t_first)
    tile_phase(theta[0], tile_step, t_first + threadIdx.x,
               &phase[2 * threadIdx.x], &phase[2 * threadIdx.x + 1]);
  const int groups = lay.no / R;         // units per plane

  for (int t = t_first; t < t_end; ++t) {
    const int start = t * TILE - (L - 1);  // sample index of window position 0
    // halo of the block's tile 0: the previous block's raw samples
    const int halo = start < 0 ? -start : 0;
    cp_async_wait_all();
    __syncthreads();   // the raw window has landed; the last FIR is done
    // the mixer's sign rides on the tile's phase: s = sgn * sin(phase + ramp)
    const float cb = phase[2 * (t - t_first)], sb = phase[2 * (t - t_first) + 1];
    const float cbs = sgn < 0 ? -cb : cb;
    const float sbs = sgn < 0 ? -sb : sb;
    auto mix = [&](int q, float r, float im, float ct, float st) {
      const float c = cb * ct - sb * st;
      const float s = sbs * ct + cbs * st;
      put(q, r * c - im * s, r * s + im * c);
    };
    for (int q = threadIdx.x; q < halo; q += THREADS)
      mix(q, carry_r[b * SUB + SUB + start + q],
          carry_i[b * SUB + SUB + start + q], ramp_c[q], ramp_s[q]);
    const Tin* er = reinterpret_cast<const Tin*>(raw_r) + (start - base(t));
    const Tin* ei = reinterpret_cast<const Tin*>(raw_i) + (start - base(t));
    if constexpr (DOWN != 0) {
      // sample q = tid + THREADS*i sits in component tid % DOWN at entry
      // tid / DOWN + (THREADS/DOWN)*i: whole groups of R further on per
      // step, so its padded address moves by a constant
      constexpr int STEP = THREADS / DOWN / R * (R + PAD);
      const int k0 = threadIdx.x / DOWN;
      int at = (threadIdx.x - k0 * DOWN) * lay.Ks + firwin::padded<R>(k0);
      // the thread's first sample at or past the halo
      const int skip = halo > static_cast<int>(threadIdx.x)
          ? (halo - threadIdx.x + THREADS - 1) / THREADS : 0;
      at += skip * STEP;
      // U samples at a time, every load of a batch before its first use
      for (int q0 = threadIdx.x + skip * THREADS; q0 < W;
           q0 += U * THREADS, at += U * STEP) {
        float r[U], im[U], ct[U], st[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int q = q0 + u * THREADS;
          if (q < W) {
            ct[u] = ramp_c[q], st[u] = ramp_s[q];
            r[u] = to_f32(er[q]), im[u] = to_f32(ei[q]);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (q0 + u * THREADS < W) {
            const float c = cb * ct[u] - sb * st[u];
            const float s = sbs * ct[u] + cbs * st[u];
            m[at + u * STEP] = r[u] * c - im[u] * s;
            mi[at + u * STEP] = r[u] * s + im[u] * c;
          }
        }
      }
    } else {
      for (int q = halo + threadIdx.x; q < W; q += THREADS)
        mix(q, to_f32(er[q]), to_f32(ei[q]), ramp_c[q], ramp_s[q]);
    }
    __syncthreads();   // the mixed window is whole; the raw window is free
    if (t + 1 < t_end) prefetch(t + 1);    // in flight under this tile's FIR

    const long long orow = static_cast<long long>(b) * (T / down)
        + static_cast<long long>(t) * lay.no;
    for (int u = threadIdx.x; u < 2 * groups; u += THREADS) {
      const bool imag = u >= groups;
      const int grp = imag ? u - groups : u;
      const float* w = (imag ? mi : m) + grp * (R + PAD);
      float acc[R];
#pragma unroll
      for (int k = 0; k < R; ++k) acc[k] = 0.f;
#pragma unroll 1
      for (int p = 0; p < down; ++p)
        firwin::correlate<R>(acc, w + p * lay.Ks, g + p * lay.Ap, lay.A4);
      store_outputs<R>((imag ? yi : yr) + orow + grp * R, acc);
    }
  }
}

// Tiles a block walks: NT where the grid then still holds two rounds of the
// card's resident blocks (5 per SM), else half of that, down to 1: a short
// block fills the card before a long one saves it a prologue.
inline int tiles_per_block(int B, int tiles) {
  int sms = 132, device = 0;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  for (int nt = NT; nt > 1; nt /= 2)
    if (static_cast<long long>(B) * ((tiles + nt - 1) / nt) >= 10LL * sms)
      return nt;
  return 1;
}

template <int DOWN, int R, typename Tin, typename Tout>
int launch(const void* xr, const void* xi, const void* carry_r,
           const void* carry_i, const void* theta,
           const void* ramp_c, const void* ramp_s, const void* taps,
           void* yr, void* yi, int B, int T, int L, int down, int sgn,
           float tile_step, cudaStream_t stream) {
  const int tiles = T / TILE;
  const int nt = tiles_per_block(B, tiles);
  const dim3 grid((tiles + nt - 1) / nt, B);
  const size_t smem = sizeof(float) * Layout<R>(L, down).words(down);
  auto kernel = mix_fir_decim_kernel<DOWN, R, Tin, Tout>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const Tin*>(xr), static_cast<const Tin*>(xi),
      static_cast<const float*>(carry_r), static_cast<const float*>(carry_i),
      static_cast<const float*>(theta),
      static_cast<const float*>(ramp_c), static_cast<const float*>(ramp_s),
      static_cast<const float*>(taps), static_cast<Tout*>(yr),
      static_cast<Tout*>(yi), T, L, down, sgn, tile_step, nt);
  return static_cast<int>(cudaGetLastError());
}

// The launch selects the template only: every `down` runs the same kernel.
template <typename Tin, typename Tout, typename... Args>
int launch_down(int down, Args... args) {
  switch (down) {
    case 1: return launch<1, 16, Tin, Tout>(args...);
    case 2: return launch<2, 16, Tin, Tout>(args...);
    case 4: return launch<4, 8, Tin, Tout>(args...);
    case 8: return launch<8, 8, Tin, Tout>(args...);
    default: return launch<0, 8, Tin, Tout>(args...);
  }
}

}  // namespace

// xr, xi: [B, T] float32 or bfloat16 (in_bf16), contiguous, 16-byte aligned,
// T % TILE == 0.  carry_r, carry_i: [B, SUB] float32.  theta: the scalar
// float32 phase at the block's first sample; tile_step: the phase step
// per tile, f32(dphi * TILE mod 2 pi).
// ramp_c, ramp_s: >= TILE + L - 1 float32.  taps: [L] float32, L <= SUB + 1.
// yr, yi: [B, T / down] float32 or bfloat16 (out_bf16), 16-byte aligned.
// down divides SUB, so a tile holds a whole number of 8-output units.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int mix_fir_decim_launch(const void* xr, const void* xi,
                                    const void* carry_r, const void* carry_i,
                                    const void* theta,
                                    const void* ramp_c, const void* ramp_s,
                                    const void* taps, void* yr, void* yi,
                                    int B, int T, int L, int down, int sgn,
                                    int in_bf16, int out_bf16,
                                    float tile_step, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    if (out_bf16)
      return launch_down<__nv_bfloat16, __nv_bfloat16>(down, xr, xi, carry_r,
          carry_i, theta, ramp_c, ramp_s, taps, yr, yi, B, T, L, down, sgn,
          tile_step, s);
    return launch_down<__nv_bfloat16, float>(down, xr, xi, carry_r, carry_i,
        theta, ramp_c, ramp_s, taps, yr, yi, B, T, L, down, sgn, tile_step, s);
  }
  if (out_bf16)
    return launch_down<float, __nv_bfloat16>(down, xr, xi, carry_r, carry_i,
        theta, ramp_c, ramp_s, taps, yr, yi, B, T, L, down, sgn, tile_step, s);
  return launch_down<float, float>(down, xr, xi, carry_r, carry_i, theta,
      ramp_c, ramp_s, taps, yr, yi, B, T, L, down, sgn, tile_step, s);
}
