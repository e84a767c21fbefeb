// The inner loop that fir_real.cu and mix_fir_decim.cu share: a unit-stride
// correlation of one shared-memory window with one row of taps, R
// consecutive outputs per thread,
//     acc[k] += sum_{a < A4} g[a] * w[o0 + k + a]        k in [0, R)
//
// What bounds it is the float32 multiply-add pipe, so the loop is built to
// keep everything else out of that pipe's way:
//   * the window sits in shared memory in groups of R words followed by
//     PAD = 4 empty words (`padded`).  A thread's R outputs start on a
//     group, so every load is one aligned 16-byte vector at a constant
//     offset from a pointer that moves once per R taps: no index
//     arithmetic per load.  The stride of R + 4 words between lanes puts
//     the 8 lanes of a quarter warp (what the hardware serves together for
//     16-byte loads) on 8 distinct 4-bank groups for R = 8 and R = 16;
//   * taps come 4 at a time as one 16-byte broadcast load;
//   * the R window samples live in a circular register window with
//     compile-time indices: tap j reads xw[(j + k) % R] and then replaces
//     xw[j], which no later tap of the group reads, by the next group's
//     sample j.
// Per 4 taps a thread issues 2 shared loads and 4 R multiply-adds (R = 16:
// about a third of the shared-memory pipe when the multiply-add pipe is
// full; the form before this one, one scalar load per tap and per sample
// with 8 outputs, filled both pipes at once).
//
// The tap count is a run-time value: whole groups of R taps run in the
// main loop, the rest (a multiple of 4, the taps are zero-padded to that)
// in a tail of guarded 4-tap steps.

#pragma once

#include <cuda_runtime.h>

namespace firwin {

constexpr int PAD = 4;   // empty words after each group of R window words

template <int R>
__device__ __forceinline__ int padded(int k) {
  return k + k / R * PAD;
}

// 4 taps at the compile-time position c of a group: taps g[4c .. 4c+3]
// against the register window, whose entries 4c .. 4c+3 are then replaced
// by the next group's (wn[4c .. 4c+3]).
template <int R>
__device__ __forceinline__ void step4(float (&acc)[R], float (&xw)[R],
                                      const float* __restrict__ g,
                                      const float* __restrict__ wn,
                                      const int c) {
  const float4 gv = *reinterpret_cast<const float4*>(g + 4 * c);
  const float4 nv = *reinterpret_cast<const float4*>(wn + 4 * c);
  const float gs[4] = {gv.x, gv.y, gv.z, gv.w};
  const float ns[4] = {nv.x, nv.y, nv.z, nv.w};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int j = 4 * c + s;
#pragma unroll
    for (int k = 0; k < R; ++k) acc[k] = fmaf(gs[s], xw[(j + k) % R], acc[k]);
    xw[j] = ns[s];
  }
}

// acc[k] += sum_{a < A4} g[a] * w[k + a], k < R.  `w` points at the
// thread's first window word (the start of a group, in the padded
// layout), `g` at the taps (16-byte aligned, zero from the true count up
// to A4), A4 is a multiple of 4.  The window must hold the groups up to
// the one that starts A4 words (rounded up to R) after the thread's.
template <int R>
__device__ __forceinline__ void correlate(float (&acc)[R],
                                          const float* __restrict__ w,
                                          const float* __restrict__ g,
                                          const int A4) {
  float xw[R];
#pragma unroll
  for (int i = 0; i < R; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(w + i);
    xw[i] = v.x, xw[i + 1] = v.y, xw[i + 2] = v.z, xw[i + 3] = v.w;
  }
  int a0 = 0;
  for (; a0 + R <= A4; a0 += R) {
    w += R + PAD;
#pragma unroll
    for (int c = 0; c < R / 4; ++c) step4<R>(acc, xw, g + a0, w, c);
  }
  w += R + PAD;
#pragma unroll
  for (int c = 0; c < R / 4 - 1; ++c)
    if (a0 + 4 * c < A4) step4<R>(acc, xw, g + a0, w, c);
}

}  // namespace firwin
