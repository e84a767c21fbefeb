// symtrack's carrier PLL + decision-directed LMS over the symsync slots,
// for Hopper (sm_90a).
//
// Replaces the lax.scan of the post step in
// liquid_dsp_tpu/framing/symtrack.py:218-267 (sequential route, :301-306);
// the JAX package has no Pallas kernel here, and PyTorch has no scan that
// stays on the device.
//
// What it computes, per channel b and slot s (all-real, re/im planes):
//   v = sym * exp(-j theta);  r = nearest(v);  e = atan2(Im v conj r,
//   Re v conj r);  dtheta += beta2 e;  theta += dtheta + alpha e;
//   buf <- [buf[1:], v];  x2 += |v|^2 - |buf_oldest|^2;
//   y = sum_j conj(w_j) buf_j;  d = nearest(y);
//   w += ((n+1 >= L) mu / max(x2, 1e-12)) conj(d - y) buf
// every state update gated by the slot's valid flag; y and the index of d
// written for every slot.  nearest: the quadrant sign slicer for a
// QPSK-like table (qpsk = 1, k_ab the index at ((-1)^a s, (-1)^b s)),
// else the first argmin of |v - t|^2 over the M points (the table read
// through the read-only cache); the kernel is compiled for each of the two.
//
// Bound on this card: the latency of one dependent chain per channel
// (theta and w pass from valid slot to valid slot); the 21 bytes a slot
// moves are far below it.  What the design does about it:
//
// * One warp per channel, one block per warp: B channels spread over
//   min(B, 132) SMs.  Lane j holds tap j of the weights and of the window
//   (LM = 16 or 32 lanes hold the taps, the smallest that holds L; with
//   LM = 16 both half-warps hold a copy), the scalar state is kept alike
//   in every lane.
// * The chain walks the valid slots only.  The state changes nowhere
//   else, so per 32-slot group a ballot of the valid flags gives a mask
//   and the warp steps from set bit to set bit.  At 2 samples per symbol
//   one slot in six is valid.
// * The window is kept shifted ahead (sb_j = buf_{j+1}), and with it the
//   part of the dot that does not see the new sample, P = sum_{j<L-1}
//   conj(w_j) sb_j.  A slot's output is then y = P + conj(w_{L-1}) v: two
//   multiply-adds after v.
// * No sum across lanes stands on the LMS chain.  With w' = w + g conj(e)
//   nb (nb the window with v, g the gain, e = d - y) the next P is
//       P' = sum conj(w'_j) nb_{j+1} = A + (g e) C,
//       A = sum_{j<L-1} conj(w_j) nb_{j+1},  C = sum_{j<L-1} conj(nb_j) nb_{j+1}
//   and A, C need only v and the old w: their butterflies of shuffles run
//   beside the slicer, and after e two complex multiply-adds give P'.  So
//   the LMS chain is y -> d -> e -> P', and it hides behind the PLL chain
//   (theta -> sincosf -> v -> atan2 -> theta).  theta is never wrapped,
//   so sincosf stays the accurate one.  Each lane still updates its own
//   tap exactly; the newest tap w_{L-1}, which every output needs, is
//   updated alike in every lane with the same rounded operations as its
//   own lane's, so no broadcast is needed and the copies never drift.
// * An invalid slot's output is the same expression with the state
//   frozen at the last valid slot before it.  Each lane owns one slot of
//   the group and latches (P, w_{L-1}, cos, sin) when the chain passes a
//   valid slot below its own; after the group every lane computes its
//   invalid slot off the chain.  Runs of invalid slots that cross groups
//   or tiles carry over in the latched registers.
// * Slots are staged: s_re and s_im of the next 256-slot tile come into
//   shared memory by cp.async (a warp copies full 128-byte lines) while
//   the chain works on the current tile; the next tile's valid bytes wait
//   in registers and become ballot masks.  Each group's y_re, y_im and
//   dec go out as one full-line store per warp, straight from the lanes'
//   registers.
//
// Numerics: float32 with the accurate sincosf, an atan2 by polynomial
// (7e-8 rad) and a fast division for the gain (2 ulp); every other
// rounding is written out (one FMA for each part of a complex product), so
// that nvcc contracts nothing by its own choice.  The length-L
// dot is summed as a tree across lanes with the newest tap added last,
// and through A + (g e) C instead of from the updated taps: another order
// and association than the plain PyTorch version's
// (ops/kernels/pll_lms.py), so the two agree to the stream tolerance
// (2e-4, decisions equal), not bit for bit.
//
// The slicers, the atan2 and the walk over a group are pll_lms_step.cuh's,
// shared with symsync_pll_lms.cu (the same step inside the timing loop).
//
// Built by liquid_dsp_tpu_torch/ops/kernels/build.py with nvcc for sm_90a,
// bound with ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "pll_lms_step.cuh"

namespace {

using pll_lms_step::FULL;
using pll_lms_step::Slicer;

constexpr int THREADS = 32;          // one warp = one channel
constexpr int TILE = 256;            // slots per staged tile
constexpr int GROUPS = TILE / 32;    // 32-slot groups per tile

template <int LM, bool QPSK>
__global__ void __launch_bounds__(THREADS)
pll_lms_kernel(const float* __restrict__ s_re, const float* __restrict__ s_im,
               const unsigned char* __restrict__ valid,
               float* __restrict__ theta_io, float* __restrict__ dtheta_io,
               float* __restrict__ w_re_io, float* __restrict__ w_im_io,
               float* __restrict__ b_re_io, float* __restrict__ b_im_io,
               float* __restrict__ x2_io, int* __restrict__ n_io,
               Slicer sl, float* __restrict__ y_re_o,
               float* __restrict__ y_im_o, int* __restrict__ dec_o, int B,
               int S, int L, float alpha, float beta2, float mu) {
  __shared__ float sh_re[2][TILE];
  __shared__ float sh_im[2][TILE];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  pll_lms_step::Chain<LM, QPSK> ch;
  ch.sl = sl;
  ch.alpha = alpha;
  ch.beta2 = beta2;
  ch.mu = mu;
  ch.L = L;
  ch.lane = lane;
  ch.load(theta_io, dtheta_io, w_re_io, w_im_io, b_re_io, b_im_io, x2_io,
          n_io, b);
  ch.start(true, 0.f, 0.f);
  const size_t row = static_cast<size_t>(b) * S;
  const int ntiles = (S + TILE - 1) / TILE;

  // tile n's planes into buffer n & 1, a line per warp instruction
  auto stage_tile = [&](int n_tile) {
    const int s0 = n_tile * TILE;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const int s = s0 + g * 32 + lane;
      if (s < S) {
        cp_async_f32(&sh_re[n_tile & 1][g * 32 + lane], s_re + row + s);
        cp_async_f32(&sh_im[n_tile & 1][g * 32 + lane], s_im + row + s);
      }
    }
    cp_async_commit();
  };
  // tile n's valid bytes, one per lane and group (0 past the end)
  auto load_valid = [&](int n_tile, unsigned char (&vb)[GROUPS]) {
    const int s0 = n_tile * TILE;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const int s = s0 + g * 32 + lane;
      vb[g] = s < S ? valid[row + s] : 0;
    }
  };
  // lane g keeps group g's ballot
  auto to_masks = [&](const unsigned char (&vb)[GROUPS]) {
    unsigned mine = 0;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const unsigned m = __ballot_sync(FULL, vb[g] != 0);
      if (lane == g) mine = m;
    }
    return mine;
  };

  unsigned char vb[GROUPS];
  stage_tile(0);
  load_valid(0, vb);
  unsigned masks = to_masks(vb);

  for (int nt = 0; nt < ntiles; ++nt) {
    if (nt + 1 < ntiles) {
      stage_tile(nt + 1);
      load_valid(nt + 1, vb);
    } else {
      cp_async_commit();
    }
    cp_async_wait_all_but<1>();
    __syncwarp();

    const int s0 = nt * TILE;
    for (int g = 0; g < GROUPS && s0 + g * 32 < S; ++g) {
      const int s = s0 + g * 32 + lane;
      const float my_re = s < S ? sh_re[nt & 1][g * 32 + lane] : 0.f;
      const float my_im = s < S ? sh_im[nt & 1][g * 32 + lane] : 0.f;
      float oy_re, oy_im;
      int od;
      ch.group(my_re, my_im, __shfl_sync(FULL, masks, g), &oy_re, &oy_im,
               &od);
      if (s < S) {
        y_re_o[row + s] = oy_re;
        y_im_o[row + s] = oy_im;
        dec_o[row + s] = od;
      }
    }
    __syncwarp();
    if (nt + 1 < ntiles) masks = to_masks(vb);
  }

  ch.store(theta_io, dtheta_io, w_re_io, w_im_io, b_re_io, b_im_io, x2_io,
           n_io, b);
}

}  // namespace

// s_re, s_im: [B, S] float32; valid: [B, S] bytes (0/1).  State, read and
// overwritten in place: theta, dtheta, x2 [B] float32, n [B] int32,
// w_re, w_im, b_re, b_im [B, L] float32, 1 <= L <= 32.  tab_re, tab_im:
// [M] float32.  y_re, y_im: [B, S] float32; dec: [B, S] int32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int pll_lms_launch(
    const void* s_re, const void* s_im, const void* valid, void* theta,
    void* dtheta, void* w_re, void* w_im, void* b_re, void* b_im, void* x2,
    void* n, const void* tab_re, const void* tab_im, void* y_re, void* y_im,
    void* dec, int B, int S, int L, int M, int qpsk, int k00, int k01,
    int k10, int k11, float alpha, float beta2, float mu, float s2v,
    void* stream) {
  if (B < 1 || S < 1 || L < 1 || L > 32 || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Slicer sl{static_cast<const float*>(tab_re),
                  static_cast<const float*>(tab_im), M, k00, k01, k10, k11,
                  s2v};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PLL_LMS_ARGS                                                       \
  static_cast<const float*>(s_re), static_cast<const float*>(s_im),        \
      static_cast<const unsigned char*>(valid), static_cast<float*>(theta), \
      static_cast<float*>(dtheta), static_cast<float*>(w_re),              \
      static_cast<float*>(w_im), static_cast<float*>(b_re),                \
      static_cast<float*>(b_im), static_cast<float*>(x2),                  \
      static_cast<int*>(n), sl, static_cast<float*>(y_re),                 \
      static_cast<float*>(y_im), static_cast<int*>(dec), B, S, L, alpha,    \
      beta2, mu
  if (L <= 16 && qpsk)
    pll_lms_kernel<16, true><<<B, THREADS, 0, st>>>(PLL_LMS_ARGS);
  else if (L <= 16)
    pll_lms_kernel<16, false><<<B, THREADS, 0, st>>>(PLL_LMS_ARGS);
  else if (qpsk)
    pll_lms_kernel<32, true><<<B, THREADS, 0, st>>>(PLL_LMS_ARGS);
  else
    pll_lms_kernel<32, false><<<B, THREADS, 0, st>>>(PLL_LMS_ARGS);
#undef PLL_LMS_ARGS
  return static_cast<int>(cudaGetLastError());
}
