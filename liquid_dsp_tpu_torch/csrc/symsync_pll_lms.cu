// symtrack's fused route for Hopper (sm_90a): the symsync timing loop over
// precomputed branch outputs and, after every emit, the tracker's carrier
// PLL + decision-directed LMS step, in one kernel.
//
// Replaces the JAX package's fused route: the lax.scan of
// liquid_dsp_tpu/ops/symsync.py:187-206 (_symsync_run_hoisted with a `post`
// hook) driven by liquid_dsp_tpu/framing/symtrack.py:284-296 with the post
// step of :218-267.  On the TPU that route is a lax.scan, because the
// Pallas timing kernel (pallas_symsync.symsync_scan_pallas) cannot carry
// the hook; here the hook's own kernel code runs beside the timing loop.
//
// What it computes, per channel b over one chunk of Tc input steps: what
// symsync_scan.cu computes (the slots y, valid of up to max_out emits a
// step and the loop state), then what pll_lms.cu computes over those
// slots (y, y_im and the decision on every slot; theta, dtheta, the
// weights, the window, x2 and n).  The PLL never feeds back into the
// timing loop, so the two chains run side by side: the same result as the
// sequential route, where the slots go through global memory in between.
//
// Bound on this card: the latency of two dependent chains per channel,
// the timing loop's (~290 cycles an input step) and the PLL + LMS's
// (~580 a valid slot, one valid slot per two steps at k = 2); the bytes
// (the branch rows an active emit reads, 13 bytes out a slot) are far
// below.  What the design does about it:
//
// * Two warps a channel, one block a channel.  Warp 0 is symsync_scan's
//   warp: its lanes stage the branch rows by cp.async a tile ahead, lane 0
//   runs the timing chain over the active emits only and writes each
//   32-step tile's slots into a ring of NBUF tiles in shared memory.
//   Warp 1 is pll_lms's warp: it takes a tile from the ring, walks the
//   valid slots of each 32-slot group (ballot) on its chain, computes the
//   invalid ones off the chain, zeroes the tile's slots and hands the
//   buffer back.  So the PLL + LMS of tile n runs while the timing loop
//   runs tile n + 1: a chunk takes about the longer chain, not the sum.
// * The hand-off is two named barriers per buffer: FULL (warp 0 arrives
//   when the tile is written, warp 1 waits) and EMPTY (warp 1 arrives when
//   it has read and zeroed it, warp 0 waits before it writes the tile
//   NBUF later).  The barriers order the shared-memory accesses.
// * Only the tracker's outputs (y, decision, valid) and the states go to
//   global memory.
// * Bits: the timing step is symsync_step.cuh's and the PLL + LMS walk
//   pll_lms_step.cuh's, the code of the two sequential kernels.  The
//   dot over the shifted window, which pll_lms sums anew at the start of a
//   launch and then carries as A + (g e) C, is read from and written to
//   `dot` when dot_in is set, so a block run chunk by chunk with the dot
//   carried (fresh at the block's first chunk) equals pll_lms over the
//   whole block bit for bit, as the timing loop equals symsync_scan.
//
// Built by liquid_dsp_tpu_torch/ops/kernels/build.py with nvcc for sm_90a,
// bound with ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include "pll_lms_step.cuh"
#include "symsync_step.cuh"

namespace {

using pll_lms_step::FULL;
using pll_lms_step::Slicer;
using symsync_step::STAGE;
using symsync_step::TILE;

constexpr int THREADS = 64;   // warp 0 the timing loop, warp 1 PLL + LMS
constexpr int NBUF = 4;       // tiles of slots in the ring between them

// Named barriers of the block's two warps: FULL of buffer u is 1 + u,
// EMPTY of buffer u is 1 + NBUF + u (0 is __syncthreads').
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(THREADS) : "memory");
}

__device__ __forceinline__ void bar_wait(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(THREADS) : "memory");
}

template <int LM, bool QPSK>
__global__ void __launch_bounds__(THREADS)
symsync_pll_lms_kernel(
    const float* __restrict__ ma, float* __restrict__ fstate,
    int* __restrict__ istate, float* __restrict__ theta_io,
    float* __restrict__ dtheta_io, float* __restrict__ w_re_io,
    float* __restrict__ w_im_io, float* __restrict__ b_re_io,
    float* __restrict__ b_im_io, float* __restrict__ x2_io,
    int* __restrict__ n_io, float* __restrict__ dot_io, int dot_in,
    Slicer sl, float* __restrict__ y_re_o, float* __restrict__ y_im_o,
    int* __restrict__ dec_o, unsigned char* __restrict__ valid_o, int B,
    int Tc, int npfb, int P, int max_out, int k_out, int locked,
    float inv_k, float c_q, float c_v, float c_r, int L, float alpha,
    float beta2, float mu) {
  extern __shared__ float smem[];
  const int TS = TILE * max_out;             // slots a tile
  float* stage = smem;                       // [2][2*P][WIN][TILE]
  float* ring_re = smem + 2 * STAGE;         // [NBUF][TS]
  float* ring_im = ring_re + NBUF * TS;
  unsigned char* ring_v =
      reinterpret_cast<unsigned char*>(ring_im + NBUF * TS);

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ntiles = (Tc + TILE - 1) / TILE;
  const size_t row = static_cast<size_t>(b) * Tc * max_out;

  if (warp == 0) {
    // the timing loop, as symsync_scan.cu runs it, into the ring
    symsync_step::TimingLoop lp{};
    lp.load(fstate, istate, B, b);
    lp.npfb = npfb;
    lp.max_out = max_out;
    lp.k_out = k_out;
    lp.locked = locked;
    lp.inv_k = inv_k;
    lp.c_q = c_q;
    lp.c_v = c_v;
    lp.c_r = c_r;
    lp.fnpfb = static_cast<float>(npfb);
    const symsync_step::Rows rw(ma, B, b, Tc, npfb, P);
    for (int i = lane; i < NBUF * TS; i += 32) {
      ring_re[i] = 0.f;
      ring_im[i] = 0.f;
      ring_v[i] = 0;
    }
    int r0_cur = symsync_step::window_start(__shfl_sync(FULL, lp.bi, 0),
                                            npfb, rw.win);
    rw.stage_tile(stage, 0, r0_cur, lane);
    for (int n = 0; n < ntiles; ++n) {
      const int r0_next = symsync_step::window_start(
          __shfl_sync(FULL, lp.bi, 0), npfb, rw.win);
      if (n + 1 < ntiles)
        rw.stage_tile(stage, n + 1, r0_next, lane);
      else
        cp_async_commit();
      cp_async_wait_all_but<1>();
      __syncwarp();
      const int u = n % NBUF;
      if (n >= NBUF) bar_wait(1 + NBUF + u);     // tile n - NBUF was read
      const int t0 = n * TILE;
      const int nt = Tc - t0 < TILE ? Tc - t0 : TILE;
      float* o_re = ring_re + u * TS;
      float* o_im = ring_im + u * TS;
      unsigned char* o_v = ring_v + u * TS;
      if (lane == 0) {
        const float* st = stage + (n & 1) * STAGE;
        for (int tl = 0; tl < nt; ++tl)
          lp.step(st, r0_cur, rw, t0, tl, o_re, o_im, o_v);
      }
      __syncwarp();
      bar_arrive(1 + u);                         // tile n is in buffer u
      r0_cur = r0_next;
    }
    if (lane == 0) lp.store(fstate, istate, B, b);
  } else {
    // the PLL + LMS, as pll_lms.cu runs it, over the ring's tiles
    pll_lms_step::Chain<LM, QPSK> ch;
    ch.sl = sl;
    ch.alpha = alpha;
    ch.beta2 = beta2;
    ch.mu = mu;
    ch.L = L;
    ch.lane = lane;
    ch.load(theta_io, dtheta_io, w_re_io, w_im_io, b_re_io, b_im_io, x2_io,
            n_io, b);
    ch.start(!dot_in, dot_in ? dot_io[b] : 0.f, dot_in ? dot_io[B + b] : 0.f);
    for (int n = 0; n < ntiles; ++n) {
      const int u = n % NBUF;
      bar_wait(1 + u);                           // tile n is in buffer u
      const int t0 = n * TILE;
      const int nt = Tc - t0 < TILE ? Tc - t0 : TILE;
      const int ns = nt * max_out;
      float* o_re = ring_re + u * TS;
      float* o_im = ring_im + u * TS;
      unsigned char* o_v = ring_v + u * TS;
      const size_t ob = row + static_cast<size_t>(t0) * max_out;
      for (int g = 0; g * 32 < ns; ++g) {
        const int i = g * 32 + lane;
        const bool in = i < ns;
        const float my_re = in ? o_re[i] : 0.f;
        const float my_im = in ? o_im[i] : 0.f;
        const bool my_v = in && o_v[i] != 0;
        if (in) {                                // zeroed for tile n + NBUF
          o_re[i] = 0.f;
          o_im[i] = 0.f;
          o_v[i] = 0;
        }
        float oy_re, oy_im;
        int od;
        ch.group(my_re, my_im, __ballot_sync(FULL, my_v), &oy_re, &oy_im,
                 &od);
        if (in) {
          y_re_o[ob + i] = oy_re;
          y_im_o[ob + i] = oy_im;
          dec_o[ob + i] = od;
          valid_o[ob + i] = my_v;
        }
      }
      __syncwarp();
      if (n + NBUF < ntiles) bar_arrive(1 + NBUF + u);   // buffer u free
    }
    ch.store(theta_io, dtheta_io, w_re_io, w_im_io, b_re_io, b_im_io, x2_io,
             n_io, b);
    if (lane == 0) {
      dot_io[b] = ch.cur.p_re;
      dot_io[B + b] = ch.cur.p_im;
    }
  }
}

}  // namespace

// ma: [P, B, 2*npfb, Tc] float32, contiguous, P in {1, 2}.  fstate [6, B]
// float32 and istate [2, B] int32 (symsync_scan's), theta, dtheta, x2 [B]
// float32, n [B] int32, w_re, w_im, b_re, b_im [B, L] float32 (pll_lms's),
// 1 <= L <= 32, and dot [2, B] float32 (the dot's re, im; read when
// dot_in, always written): all read and overwritten in place.  tab_re,
// tab_im: [M] float32.  y_re, y_im: [B, Tc*max_out] float32, dec the
// same int32, valid the same bytes (0/1).  inv_k, c_q, c_v, c_r:
// symsync_scan_launch's; qpsk, k00..k11, s2v, alpha, beta2, mu:
// pll_lms_launch's.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int symsync_pll_lms_launch(
    const void* ma, void* fstate, void* istate, void* theta, void* dtheta,
    void* w_re, void* w_im, void* b_re, void* b_im, void* x2, void* n,
    void* dot, const void* tab_re, const void* tab_im, void* y_re,
    void* y_im, void* dec, void* valid, int B, int Tc, int npfb, int P,
    int max_out, int k_out, int locked, int L, int M, int qpsk, int k00,
    int k01, int k10, int k11, int dot_in,
    float inv_k, float c_q, float c_v, float c_r, float alpha, float beta2,
    float mu, float s2v, void* stream) {
  if (B < 1 || Tc < 1 || npfb < 1 || max_out < 1 || (P != 1 && P != 2)
      || L < 1 || L > 32 || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Slicer sl{static_cast<const float*>(tab_re),
                  static_cast<const float*>(tab_im), M, k00, k01, k10, k11,
                  s2v};
  // two stage buffers, then the ring (two float planes and a byte a slot)
  const size_t shmem = 2 * STAGE * sizeof(float)
      + static_cast<size_t>(NBUF) * TILE * max_out * (2 * sizeof(float) + 1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    if (shmem > 48 * 1024) {
      const cudaError_t rc = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(shmem));
      if (rc != cudaSuccess) return static_cast<int>(rc);
    }
    kernel<<<B, THREADS, shmem, st>>>(
        static_cast<const float*>(ma), static_cast<float*>(fstate),
        static_cast<int*>(istate), static_cast<float*>(theta),
        static_cast<float*>(dtheta), static_cast<float*>(w_re),
        static_cast<float*>(w_im), static_cast<float*>(b_re),
        static_cast<float*>(b_im), static_cast<float*>(x2),
        static_cast<int*>(n), static_cast<float*>(dot), dot_in, sl,
        static_cast<float*>(y_re), static_cast<float*>(y_im),
        static_cast<int*>(dec), static_cast<unsigned char*>(valid), B, Tc,
        npfb, P, max_out, k_out, locked, inv_k, c_q, c_v, c_r, L, alpha,
        beta2, mu);
    return static_cast<int>(cudaGetLastError());
  };
  if (L <= 16 && qpsk) return launch(symsync_pll_lms_kernel<16, true>);
  if (L <= 16) return launch(symsync_pll_lms_kernel<16, false>);
  if (qpsk) return launch(symsync_pll_lms_kernel<32, true>);
  return launch(symsync_pll_lms_kernel<32, false>);
}
