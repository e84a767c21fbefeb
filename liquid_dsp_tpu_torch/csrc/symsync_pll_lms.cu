// symtrack's fused route for Hopper (sm_90a): the symsync timing loop and,
// after every emit, the tracker's carrier PLL + decision-directed LMS step,
// in one kernel that filters the branches its timing chain reads itself.
//
// Replaces the JAX package's fused route: the lax.scan of
// liquid_dsp_tpu/ops/symsync.py:187-206 (_symsync_run_hoisted with a `post`
// hook) driven by liquid_dsp_tpu/framing/symtrack.py:284-296 with the post
// step of :218-267.  On the TPU that route is a lax.scan, because the
// Pallas timing kernel (pallas_symsync.symsync_scan_pallas) cannot carry
// the hook; here the hook's own kernel code runs beside the timing loop.
//
// What it computes, per channel b over Tc input steps from its input planes
// [P, B, Tc + Lb - 1] (the window's last Lb - 1 samples, then the block):
// what branch_bank.cu computes (the branch outputs, summed as
// branch_dot.cuh says) and then symsync_scan.cu over them (the slots y,
// valid of up to max_out emits a step and the loop state), then what
// pll_lms.cu computes over those slots (y, y_im and the decision on every
// slot; theta, dtheta, the weights, the window, x2 and n).  The PLL never
// feeds back into the timing loop, so the chains run side by side: the
// same result as the sequential route (branch_bank, symsync_scan, pll_lms),
// where the branch rows and the slots go through global memory.
//
// Bound on this card: the latency of two dependent chains per channel,
// the timing loop's (~290 cycles an input step) and the PLL + LMS's
// (~580 a valid slot, one valid slot per two steps at k = 2); the bytes
// (the input planes read once, 13 bytes out a slot) are far below.  The
// branch rows the timing chain reads were 537 MB a 4096-step chunk of
// 256 channels written by cuDNN's conv1d before this kernel filtered
// them itself; now no such buffer exists.  What the design does:
//
// * Three warps a channel, one block a channel.  Warp 2, the filter warp,
//   stages the input planes by cp.async two 32-step tiles ahead and
//   computes, one tile ahead of the chain, the branch rows the chain will
//   read: `win` rows around the branch the chain stands on (wrapping at
//   npfb), MF and dMF of each plane, with branch_dot.cuh's code, into a
//   stage buffer of two tiles.  win = npfb is the full bank (no row is
//   ever missing); a smaller window costs less filtering, and a branch
//   outside it is filtered on the chain from the staged input by the same
//   sums, in the same order (a "miss", counted per channel).  So the rows
//   equal branch_bank's bit for bit either way.  The filter warp's issue
//   slots are what it costs the chains (measured on an H100 at 256 x
//   32768, a block in one launch: 7.4 ms at the full bank, 5.1 at 8 rows
//   with ~10 misses, 5.2 at 4 rows with ~20,000; the chains alone, as the
//   parent kernel ran them on precomputed rows, 4.48), so the wrapper's
//   default is 8 rows (ops/kernels/symsync_pll_lms.py, FILTER_WIN).
// * Warp 0 is symsync_scan's chain: lane 0 runs the timing loop over the
//   active emits only (symsync_step.cuh's step) and writes each tile's
//   slots into a ring of NBUF tiles in shared memory.  Warp 1 is pll_lms's
//   warp: it takes a tile from the ring, walks the valid slots of each
//   32-slot group (ballot) on its chain (pll_lms_step.cuh), computes the
//   invalid ones off the chain, zeroes the tile's slots and hands the
//   buffer back.  The PLL + LMS of tile n runs while the timing loop runs
//   tile n + 1 and the filter warp tile n + 2.
// * Hand-offs are named barriers of two warps.  Filter -> chain: READY of
//   stage buffer n & 1 (the rows of tile n are there), FREE (the chain
//   has left tile n - 1 and published where tile n + 1's window starts).
//   Chain -> PLL: FULL and EMPTY of each ring buffer.  The barriers order
//   the shared-memory accesses.
// * Only the tracker's outputs (y, decision, valid) and the states go to
//   global memory.
// * Bits: the branch rows are branch_dot.cuh's, the timing step
//   symsync_step.cuh's and the PLL + LMS walk pll_lms_step.cuh's, the code
//   of the sequential kernels, every rounding written out.  The dot over
//   the shifted window, which pll_lms sums anew at the start of a launch
//   and then carries as A + (g e) C, is read from and written to `dot`
//   when dot_in is set, so a block run in pieces with the dot carried
//   (fresh at the block's first) equals pll_lms over the whole block bit
//   for bit, as the timing loop equals branch_bank + symsync_scan.
//
// Built by liquid_dsp_tpu_torch/ops/kernels/build.py with nvcc for sm_90a,
// bound with ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include "branch_dot.cuh"
#include "cp_async.cuh"
#include "pll_lms_step.cuh"
#include "symsync_step.cuh"

namespace {

using pll_lms_step::FULL;
using pll_lms_step::Slicer;
using symsync_step::TILE;

constexpr int THREADS = 96;   // warp 0 timing, warp 1 PLL + LMS, 2 filter
constexpr int PAIR = 64;      // threads of a hand-off barrier: two warps
constexpr int NBUF = 4;       // tiles of slots in the ring (timing -> PLL)
constexpr int NXB = 4;        // input tiles staged (filter warp, misses)
constexpr int RCH = 4;        // branch rows a filter pass
// named barriers (0 is __syncthreads'): the ring's FULL of buffer u is
// 1 + u, its EMPTY 1 + NBUF + u; the stage buffers' READY and FREE
constexpr int READY = 1 + 2 * NBUF;
constexpr int FREE = READY + 2;

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(PAIR) : "memory");
}

__device__ __forceinline__ void bar_wait(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(PAIR) : "memory");
}

// samples of a plane's staged input tile: 32 steps, Lb - 1 more, room for
// branch_dot::dots4's reads
__host__ __device__ __forceinline__ int tile_samples(int kp) {
  return TILE + kp + 4;
}

// The timing chain's branch values for step tl of a tile: the filter
// warp's row from the stage, or, for a branch outside the window, the dot
// from the staged input (a miss: the same sum in the same order).
struct FilterRead {
  const float* rows;    // the tile's stage [2P][win][TILE]
  const float* x;       // the tile's input, plane 0; plane 1 XT further
  const float* taps;    // [2 npfb][kp]
  int* misses;
  int win, r0, npfb, P, XT, Lb, kp, tl;

  __device__ __forceinline__ void operator()(int bc, float& mf_re,
                                             float& dmf_re, float& mf_im,
                                             float& dmf_im) const {
    int j = bc - r0;
    if (j < 0) j += npfb;
    if (j < win) {
      const float* s = rows + j * TILE + tl;
      mf_re = s[0];
      dmf_re = s[win * TILE];
      if (P == 2) {
        mf_im = s[2 * win * TILE];
        dmf_im = s[3 * win * TILE];
      }
    } else {
      // both filters on both planes in one loop (a real stream's second
      // plane is the first again, its sums unused)
      ++*misses;
      const float* xt = x + tl;
      float v[4];
      branch_dot::dot2x2(xt, P == 2 ? xt + XT : xt, taps + bc * kp,
                         taps + (npfb + bc) * kp, Lb, v);
      mf_re = v[0];
      dmf_re = v[1];
      if (P == 2) {
        mf_im = v[2];
        dmf_im = v[3];
      }
    }
  }
};

// The filter warp's copy of input tile n (steps n*TILE ..) into its buffer,
// the samples past the row's end zero; closes one cp.async group.
__device__ __forceinline__ void stage_input(float* xin, const float* row0,
                                            const float* row1, int P, int XT,
                                            int n, int n_in, int lane) {
  const int t0 = n * TILE;
  float* dst = xin + (n % NXB) * P * XT;
  for (int pl = 0; pl < P; ++pl) {
    const float* src = pl ? row1 : row0;
    for (int q = lane; q < XT; q += 32) {
      if (t0 + q < n_in)
        cp_async_f32(dst + pl * XT + q, src + t0 + q);
      else
        dst[pl * XT + q] = 0.f;
    }
  }
  cp_async_commit();
}

template <int LM, bool QPSK>
__global__ void __launch_bounds__(THREADS)
symsync_pll_lms_kernel(
    const float* __restrict__ planes, long long pstride, long long rstride,
    const float* __restrict__ kern, int Lb, int win,
    float* __restrict__ fstate, int* __restrict__ istate,
    float* __restrict__ theta_io, float* __restrict__ dtheta_io,
    float* __restrict__ w_re_io, float* __restrict__ w_im_io,
    float* __restrict__ b_re_io, float* __restrict__ b_im_io,
    float* __restrict__ x2_io, int* __restrict__ n_io,
    float* __restrict__ dot_io, int dot_in, Slicer sl,
    float* __restrict__ y_re_o, float* __restrict__ y_im_o,
    int* __restrict__ dec_o, unsigned char* __restrict__ valid_o,
    int* __restrict__ miss_o, int B, int Tc, int npfb, int P, int max_out,
    int k_out, int locked, float inv_k, float c_q, float c_v, float c_r,
    int L, float alpha, float beta2, float mu) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int r0s[2];                     // windows of the next tiles
  const int R = 2 * npfb;
  const int kp = branch_dot::pitch(Lb);
  const int XT = tile_samples(kp);
  const int SB = 2 * P * win * TILE;         // floats a stage buffer
  const int TS = TILE * max_out;             // slots a tile
  float* taps = smem;                        // [R][kp]
  float* xin = taps + R * kp;                // [NXB][P][XT]
  float* stage = xin + NXB * P * XT;         // [2][2P][win][TILE]
  float* ring_re = stage + 2 * SB;           // [NBUF][TS]
  float* ring_im = ring_re + NBUF * TS;
  unsigned char* ring_v =
      reinterpret_cast<unsigned char*>(ring_im + NBUF * TS);

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ntiles = (Tc + TILE - 1) / TILE;
  const size_t row = static_cast<size_t>(b) * Tc * max_out;

  for (int q = threadIdx.x; q < R * kp; q += THREADS) {
    const int r = q / kp;
    const int j = q - r * kp;
    taps[q] = j < Lb ? kern[r * Lb + j] : 0.f;
  }
  __syncthreads();

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
    for (int i = lane; i < NBUF * TS; i += 32) {
      ring_re[i] = 0.f;
      ring_im[i] = 0.f;
      ring_v[i] = 0;
    }
    int misses = 0;
    // tile 0's window, from where the loop starts
    int r0_cur = symsync_step::window_start(__shfl_sync(FULL, lp.bi, 0),
                                            npfb, win);
    if (lane == 0) r0s[0] = r0_cur;
    __syncwarp();
    bar_arrive(FREE);
    for (int n = 0; n < ntiles; ++n) {
      // tile n + 1's window from the branch this tile starts on (the
      // filter warp works a tile ahead); tile n - 1's rows are read
      const int r0_next = symsync_step::window_start(
          __shfl_sync(FULL, lp.bi, 0), npfb, win);
      if (n + 1 < ntiles) {
        if (lane == 0) r0s[(n + 1) & 1] = r0_next;
        __syncwarp();
        bar_arrive(FREE + ((n + 1) & 1));
      }
      bar_wait(READY + (n & 1));                 // tile n's rows are there
      const int u = n % NBUF;
      if (n >= NBUF) bar_wait(1 + NBUF + u);     // tile n - NBUF was read
      const int nt = Tc - n * TILE < TILE ? Tc - n * TILE : TILE;
      float* o_re = ring_re + u * TS;
      float* o_im = ring_im + u * TS;
      unsigned char* o_v = ring_v + u * TS;
      if (lane == 0) {
        const float* rows = stage + (n & 1) * SB;
        const float* x = xin + (n % NXB) * P * XT;
        for (int tl = 0; tl < nt; ++tl)
          lp.step(FilterRead{rows, x, taps, &misses, win, r0_cur, npfb, P,
                             XT, Lb, kp, tl},
                  P, tl, o_re, o_im, o_v);
      }
      __syncwarp();
      bar_arrive(1 + u);                         // tile n is in buffer u
      r0_cur = r0_next;
    }
    if (lane == 0) {
      lp.store(fstate, istate, B, b);
      if (miss_o != nullptr) miss_o[b] = misses;
    }
  } else if (warp == 1) {
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
  } else {
    // the filter warp: tile n's input two tiles ahead, its rows one tile
    // ahead of the chain
    const float* row0 = planes + b * rstride;
    const float* row1 = row0 + pstride;
    const int n_in = Tc + Lb - 1;
    stage_input(xin, row0, row1, P, XT, 0, n_in, lane);
    stage_input(xin, row0, row1, P, XT, 1, n_in, lane);
    const int cpp = (win + RCH - 1) / RCH;       // passes a plane's filter
    const int items = 2 * P * cpp * 8;           // passes x 8 step quads
    for (int n = 0; n < ntiles; ++n) {
      // the chain has left tile n - 2 (its stage and input buffers) and
      // published tile n's window
      bar_wait(FREE + (n & 1));
      const int r0 = r0s[n & 1];
      if (n + 2 < ntiles)
        stage_input(xin, row0, row1, P, XT, n + 2, n_in, lane);
      else
        cp_async_commit();
      cp_async_wait_all_but<2>();                // tile n's input landed
      __syncwarp();
      float* rows = stage + (n & 1) * SB;
      const float* x = xin + (n % NXB) * P * XT;
      for (int it = lane; it < items; it += 32) {
        const int tq = it & 7;                   // steps 4 tq .. 4 tq + 3
        const int c = it >> 3;
        const int pg = c / cpp;                  // plane * 2 + (0 MF, 1 dMF)
        const int jw0 = (c - pg * cpp) * RCH;
        int off[RCH];
#pragma unroll
        for (int r = 0; r < RCH; ++r) {
          const int jw = jw0 + r < win ? jw0 + r : win - 1;
          const int rr = r0 + jw < npfb ? r0 + jw : r0 + jw - npfb;
          off[r] = ((pg & 1) * npfb + rr) * kp;
        }
        float acc[RCH][4];
        branch_dot::dots4<RCH>(acc, x + (pg >> 1) * XT + 4 * tq, taps, off,
                               Lb);
#pragma unroll
        for (int r = 0; r < RCH; ++r) {
          if (jw0 + r < win)
            *reinterpret_cast<float4*>(rows + (pg * win + jw0 + r) * TILE
                                       + 4 * tq) =
                make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        }
      }
      __syncwarp();
      bar_arrive(READY + (n & 1));               // tile n's rows are there
    }
  }
}

}  // namespace

// planes: [P, B, Tc + Lb - 1] float32, P in {1, 2}, the plane p, channel b
// row at planes + p*pstride + b*rstride (floats), its samples contiguous.
// kern: [2*npfb, Lb] float32, contiguous, 1 <= Lb <= 64 (the bank as
// branch_bank takes it).  win: branch rows the filter warp computes a step
// per plane and filter, 1 <= win <= npfb (npfb: the full bank).  fstate
// [6, B] float32 and istate [2, B] int32 (symsync_scan's), theta, dtheta,
// x2 [B] float32, n [B] int32, w_re, w_im, b_re, b_im [B, L] float32
// (pll_lms's), 1 <= L <= 32, and dot [2, B] float32 (the dot's re, im; read
// when dot_in, always written): all read and overwritten in place.
// tab_re, tab_im: [M] float32.  y_re, y_im: [B, Tc*max_out] float32, dec
// the same int32, valid the same bytes (0/1); misses: [B] int32, the
// branches filtered on the chain (null: not written).  inv_k, c_q, c_v,
// c_r: symsync_scan_launch's; qpsk, k00..k11, s2v, alpha, beta2, mu:
// pll_lms_launch's.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int symsync_pll_lms_launch(
    const void* planes, long long pstride, long long rstride,
    const void* kern, int Lb, int win, void* fstate, void* istate,
    void* theta, void* dtheta, void* w_re, void* w_im, void* b_re,
    void* b_im, void* x2, void* n, void* dot, const void* tab_re,
    const void* tab_im, void* y_re, void* y_im, void* dec, void* valid,
    void* misses, int B, int Tc, int npfb, int P, int max_out, int k_out,
    int locked, int L, int M, int qpsk, int k00, int k01, int k10, int k11,
    int dot_in, float inv_k, float c_q, float c_v, float c_r, float alpha,
    float beta2, float mu, float s2v, void* stream) {
  if (B < 1 || Tc < 1 || npfb < 1 || max_out < 1 || (P != 1 && P != 2)
      || L < 1 || L > 32 || M < 1 || Lb < 1 || Lb > branch_dot::LB_MAX
      || win < 1 || win > npfb)
    return static_cast<int>(cudaErrorInvalidValue);
  const Slicer sl{static_cast<const float*>(tab_re),
                  static_cast<const float*>(tab_im), M, k00, k01, k10, k11,
                  s2v};
  // the taps, the staged input, two stage buffers of rows, then the ring
  // (two float planes and a byte a slot)
  const int kp = branch_dot::pitch(Lb);
  const size_t floats = static_cast<size_t>(2 * npfb) * kp
      + static_cast<size_t>(NXB) * P * tile_samples(kp)
      + static_cast<size_t>(2) * 2 * P * win * TILE
      + static_cast<size_t>(2) * NBUF * TILE * max_out;
  const size_t shmem = floats * sizeof(float)
      + static_cast<size_t>(NBUF) * TILE * max_out;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    if (shmem > 48 * 1024) {
      const cudaError_t rc = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(shmem));
      if (rc != cudaSuccess) return static_cast<int>(rc);
    }
    kernel<<<B, THREADS, shmem, st>>>(
        static_cast<const float*>(planes), pstride, rstride,
        static_cast<const float*>(kern), Lb, win,
        static_cast<float*>(fstate), static_cast<int*>(istate),
        static_cast<float*>(theta), static_cast<float*>(dtheta),
        static_cast<float*>(w_re), static_cast<float*>(w_im),
        static_cast<float*>(b_re), static_cast<float*>(b_im),
        static_cast<float*>(x2), static_cast<int*>(n),
        static_cast<float*>(dot), dot_in, sl, static_cast<float*>(y_re),
        static_cast<float*>(y_im), static_cast<int*>(dec),
        static_cast<unsigned char*>(valid), static_cast<int*>(misses), B, Tc,
        npfb, P, max_out, k_out, locked, inv_k, c_q, c_v, c_r, L, alpha,
        beta2, mu);
    return static_cast<int>(cudaGetLastError());
  };
  if (L <= 16 && qpsk) return launch(symsync_pll_lms_kernel<16, true>);
  if (L <= 16) return launch(symsync_pll_lms_kernel<16, false>);
  if (qpsk) return launch(symsync_pll_lms_kernel<32, true>);
  return launch(symsync_pll_lms_kernel<32, false>);
}
