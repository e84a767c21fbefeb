// One arithmetic for symsync's branch outputs, shared by branch_bank.cu (the
// whole bank over a chunk, the hoisted symsync path's input) and
// symsync_pll_lms.cu (the branches the fused tracker's timing chain reads,
// filtered inside the kernel).
//
// A branch output is out[r, t] = sum_{j < Lb} x[t + j] * k[r, j] with
// k = the banks flipped (ops/symsync.py branch_kernel: rows 0..npfb-1 the
// matched filter, npfb..2*npfb-1 its derivative).  Every output is summed
// in one fixed order, j = 0, 1, ..., Lb-1: the first product rounded on
// its own (__fmul_rn), then one fused multiply-add a tap (__fmaf_rn).
// Each rounding is written out, so nvcc contracts nothing differently in
// the two kernels that inline this code (it did for a written a*b + c
// before), and the plain PyTorch version (ops/kernels/branch_bank.py,
// branch_bank_reference: fma32 in the same order) agrees bit for bit.
//
// The taps sit in shared memory, a row every pitch(Lb) floats (Lb rounded
// up to 4, the padding zero and never read into a sum), so a group of 4
// taps is one 16-byte broadcast load.

#pragma once

#include <cuda_runtime.h>

namespace branch_dot {

constexpr int LB_MAX = 64;   // taps a branch takes in the kernels

// floats a row of taps takes in shared memory
__host__ __device__ __forceinline__ int pitch(int Lb) {
  return (Lb + 3) & ~3;
}

// One output of two rows on two inputs (the matched filter k0 and its
// derivative k1 on the planes x0 and x1, any alignment), each summed over
// x[j] k[j], j = 0 .. Lb-1, in the order above: four independent chains
// in one loop, so their latencies overlap.
__device__ __forceinline__ void dot2x2(const float* x0, const float* x1,
                                       const float* k0, const float* k1,
                                       int Lb, float (&out)[4]) {
  float a = __fmul_rn(x0[0], k0[0]), b = __fmul_rn(x0[0], k1[0]);
  float c = __fmul_rn(x1[0], k0[0]), d = __fmul_rn(x1[0], k1[0]);
#pragma unroll 4
  for (int j = 1; j < Lb; ++j) {
    const float u = x0[j], v = x1[j], p = k0[j], q = k1[j];
    a = __fmaf_rn(u, p, a);
    b = __fmaf_rn(u, q, b);
    c = __fmaf_rn(v, p, c);
    d = __fmaf_rn(v, q, d);
  }
  out[0] = a;
  out[1] = b;
  out[2] = c;
  out[3] = d;
}

// Taps u0 .. u0 + NU - 1 of a group of four (w: the 8 window samples from
// the group's first, kk: its 4 taps) into RCH rows x 4 outputs; FIRST: the
// group holds tap 0, whose product starts each sum.
template <bool FIRST, int RCH, int NU>
__device__ __forceinline__ void group(float (&acc)[RCH][4],
                                      const float (&w)[8],
                                      const float (&kk)[RCH][4]) {
#pragma unroll
  for (int u = 0; u < NU; ++u) {
#pragma unroll
    for (int r = 0; r < RCH; ++r) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[r][i] = (FIRST && u == 0)
                        ? __fmul_rn(w[i + u], kk[r][u])
                        : __fmaf_rn(w[i + u], kk[r][u], acc[r][i]);
    }
  }
}

// Group g's window and taps: w = x[4g .. 4g + 7] from lo (x[4g .. 4g+3],
// carried from the last group) and one new 16-byte load, which becomes lo.
template <int RCH>
__device__ __forceinline__ void load_group(float4& lo, float (&w)[8],
                                           float (&kk)[RCH][4],
                                           const float4* x4,
                                           const float* taps,
                                           const int (&off)[RCH], int g) {
  const float4 hi = x4[g + 1];
  w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
  w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
#pragma unroll
  for (int r = 0; r < RCH; ++r) {
    const float4 q = *reinterpret_cast<const float4*>(taps + off[r] + 4 * g);
    kk[r][0] = q.x; kk[r][1] = q.y; kk[r][2] = q.z; kk[r][3] = q.w;
  }
  lo = hi;
}

// RCH rows x 4 consecutive outputs: acc[r][i] = sum_j x[i + j] * k_r[j],
// row r's taps at taps + off[r].  x is 16-byte aligned in shared memory
// with at least 4 * (Lb / 4 + 2) readable floats; the taps rows are
// 16-byte aligned and pitch(Lb) long.  The window slides by 4 a group: one
// 16-byte load of x and RCH of taps (broadcasts) feed 16 RCH multiply-adds.
template <int RCH>
__device__ __forceinline__ void dots4(float (&acc)[RCH][4], const float* x,
                                      const float* taps,
                                      const int (&off)[RCH], int Lb) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const int G = Lb >> 2;          // whole groups of 4 taps
  const int rem = Lb & 3;         // taps of the last, partial group
  float4 lo = x4[0];
  float w[8];
  float kk[RCH][4];
  if (G > 0) {
    load_group<RCH>(lo, w, kk, x4, taps, off, 0);
    group<true, RCH, 4>(acc, w, kk);
  }
  for (int g = 1; g < G; ++g) {
    load_group<RCH>(lo, w, kk, x4, taps, off, g);
    group<false, RCH, 4>(acc, w, kk);
  }
  if (rem > 0) {
    load_group<RCH>(lo, w, kk, x4, taps, off, G);
    if (G == 0) {
      if (rem == 1) group<true, RCH, 1>(acc, w, kk);
      else if (rem == 2) group<true, RCH, 2>(acc, w, kk);
      else group<true, RCH, 3>(acc, w, kk);
    } else {
      if (rem == 1) group<false, RCH, 1>(acc, w, kk);
      else if (rem == 2) group<false, RCH, 2>(acc, w, kk);
      else group<false, RCH, 3>(acc, w, kk);
    }
  }
}

}  // namespace branch_dot
