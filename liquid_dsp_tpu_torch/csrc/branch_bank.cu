// Every branch output of symsync's polyphase matched-filter pair over a
// chunk, for Hopper (sm_90a): the hoisted symsync path's input
// (ops/symsync.py _symsync_run_hoisted, on the sequential tracker route and
// on symsync alone).
//
// Replaces no Pallas kernel: the JAX package computes these outputs with
// lax.conv_general_dilated (liquid_dsp_tpu/ops/symsync.py:153-166) outside
// any kernel, and the port had cuDNN's conv1d there.  It was written so
// that the branch rows come from one arithmetic (branch_dot.cuh) on both
// tracker routes: the fused kernel (symsync_pll_lms.cu) filters the
// branches its timing chain reads with the same code, so the two routes
// stay bit-equal, which cuDNN's summation order would not allow.
//
// What it computes: planes [P, B, Tc + Lb - 1] float32 (a channel's
// window tail, then the chunk, per float plane; rows at any stride, the
// time axis contiguous) and the bank k [R = 2*npfb, Lb] (the banks
// flipped) give
//   ma[p, b, r, t] = sum_{j < Lb} planes[p, b, t + j] * k[r, j]
// in the layout symsync_scan reads, summed as branch_dot.cuh says.
//
// Bound on this card: the bytes written.  Each input sample feeds 2*npfb
// outputs of 4 bytes (4.29 GB for a 256-channel complex block of 32768
// steps at npfb = 32: 1.28 ms at 3.35 TB/s), and its Lb multiply-adds an
// output (28 at the tracker's m = 7) come to 0.9 ms at 67 TFLOP/s.  The
// design keeps both near their pipes:
//
// * A block takes one plane row and 512 steps (128 threads x 4 outputs),
//   stages its input window (512 + Lb - 1 samples) and the whole bank in
//   shared memory (by 4-byte cp.async: any row start), and each thread
//   walks the rows in passes of 8: 8 rows x 4 outputs in registers, the
//   window sliding by 4 taps a group, so one 16-byte load of samples and
//   8 broadcast loads of taps feed 128 multiply-adds.
// * Each row's 4 outputs leave as one 16-byte store; a warp writes 512
//   contiguous bytes of a row.
//
// Built by liquid_dsp_tpu_torch/ops/kernels/build.py with nvcc for sm_90a,
// bound with ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include "branch_dot.cuh"
#include "cp_async.cuh"

namespace {

using branch_dot::LB_MAX;

constexpr int THREADS = 128;
constexpr int TT = 4 * THREADS;     // steps a block
constexpr int RCH = 8;              // rows a pass
constexpr int XW = TT + LB_MAX + 4;   // staged samples (room for dots4)

__global__ void __launch_bounds__(THREADS)
branch_bank_kernel(const float* __restrict__ planes,
                   const float* __restrict__ kern, float* __restrict__ ma,
                   int B, int Tc, int Lb, int R, long long pstride,
                   long long rstride) {
  extern __shared__ __align__(16) float taps[];   // [R][pitch]
  __shared__ __align__(16) float xs[XW];
  const int pb = blockIdx.x;                 // plane * B + channel
  const int p = pb / B;
  const int b = pb - p * B;
  const int t0 = blockIdx.y * TT;
  const int n = Tc + Lb - 1;                 // samples in the row
  const int kp = branch_dot::pitch(Lb);
  const float* row = planes + p * pstride + b * rstride;

  for (int q = threadIdx.x; q < XW; q += THREADS) {
    if (t0 + q < n)
      cp_async_f32(xs + q, row + t0 + q);
    else
      xs[q] = 0.f;
  }
  for (int q = threadIdx.x; q < R * kp; q += THREADS) {
    const int r = q / kp;
    const int j = q - r * kp;
    taps[q] = j < Lb ? kern[r * Lb + j] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  const int t = t0 + 4 * threadIdx.x;        // this thread's first step
  if (t >= Tc) return;
  const bool vec = (Tc & 3) == 0;            // rows 16-byte aligned
  float* out = ma + static_cast<size_t>(pb) * R * Tc + t;
  for (int r0 = 0; r0 < R; r0 += RCH) {
    int off[RCH];
#pragma unroll
    for (int r = 0; r < RCH; ++r)
      off[r] = (r0 + r < R ? r0 + r : R - 1) * kp;
    float acc[RCH][4];
    branch_dot::dots4<RCH>(acc, xs + 4 * threadIdx.x, taps, off, Lb);
#pragma unroll
    for (int r = 0; r < RCH; ++r) {
      if (r0 + r >= R) continue;
      float* o = out + static_cast<size_t>(r0 + r) * Tc;
      if (vec) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (t + i < Tc) o[i] = acc[r][i];
      }
    }
  }
}

}  // namespace

// planes: [P, B, Tc + Lb - 1] float32, the plane p, channel b row at
// planes + p*pstride + b*rstride (floats), its samples contiguous.  kern:
// [R, Lb] float32, contiguous, 1 <= Lb <= 64.  ma: [P, B, R, Tc] float32,
// contiguous, 16-byte aligned.  Tc < 2^25 (65535 blocks of 512 steps).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int branch_bank_launch(const void* planes, const void* kern,
                                  void* ma, int P, int B, int Tc, int Lb,
                                  int R, long long pstride, long long rstride,
                                  void* stream) {
  if (P < 1 || B < 1 || Tc < 1 || Lb < 1 || Lb > LB_MAX || R < 1
      || (Tc + TT - 1) / TT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = sizeof(float) * R * branch_dot::pitch(Lb);
  if (shmem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        branch_bank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const dim3 grid(P * B, (Tc + TT - 1) / TT);
  branch_bank_kernel<<<grid, THREADS, shmem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(planes), static_cast<const float*>(kern),
      static_cast<float*>(ma), B, Tc, Lb, R, pstride, rstride);
  return static_cast<int>(cudaGetLastError());
}
