// Stride-1 real-tap FIR over float32 rows, for Hopper (sm_90a).
//
// Replaces liquid_dsp_tpu/ops/kernels/pallas_fir.py:fir_pallas_real (and
// its wrapper fir_apply_pallas), the TPU kernel behind
// firfilt(backend="pallas").  Complex streams arrive as rows: the re and
// im planes stacked, as the TPU wrapper stacks them.
//
// What it computes, per row r and output t in [0, T):
//   y[r, t] = sum_{j<L} h[j] * xp[r, t + L-1 - j],   xp = [carry | x]
// where carry [R, L-1] is the previous block's last L-1 input samples.
//
// Bound on this card: at the taps of a real filter (tens to hundreds) the
// float32 multiply-adds (L per output) outweigh the 8 bytes per sample
// moved.  The TPU kernel multiplied pre-overlapped windows by a banded
// [L+127, 128] matrix (mostly zeros) on the MXU; here the direct form does
// only the L nonzero products per output, as mix_fir_decim.cu does:
//   * one block per (row, tile of TILE outputs) loads its own window of
//     TILE + L - 1 samples into shared memory, the halo from the carry for
//     tile 0 (CUDA blocks run in no order, so nothing rides between them);
//     samples past the end of the row read as zeros, so any T works.  The
//     window comes by cp.async, all of a thread's copies in flight at once
//     (one instruction per copy on an inner tile); the other blocks on
//     the SM (8 at 144 taps) compute meanwhile;
//   * each thread computes R = 16 consecutive outputs through
//     fir_window.cuh's loop: 16-byte shared loads only (4 taps as one
//     broadcast, 4 window samples at a constant offset in a layout padded
//     by 4 words per 16), 2 loads per 64 multiply-adds, so the
//     multiply-add pipe and not the shared-memory pipe sets the pace;
//   * outputs leave as 16-byte vectors where the row allows it.
// L <= LMAX = 24576 keeps the shared memory within the 227 KB a block may
// opt in to (231,424 bytes at LMAX; above 48 KB the launch asks for it
// with cudaFuncSetAttribute).  At such lengths one block fits an SM and
// each loads a window 13 times its outputs, but the L multiply-adds per
// output still dwarf the loads.
//
// Built by liquid_dsp_tpu_torch/ops/kernels/build.py with nvcc for sm_90a,
// bound with ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "fir_window.cuh"

namespace {

using firwin::PAD;

constexpr int THREADS = 128;
constexpr int R = 16;               // consecutive outputs per thread
constexpr int TILE = THREADS * R;   // outputs per block
constexpr int LMAX = 24576;

struct Layout {        // shared-memory layout, the same on host and device
  int A4, Ap, K, Ks;
  __host__ __device__ explicit Layout(int L) {
    A4 = (L + 3) / 4 * 4;         // taps as the loop runs them
    Ap = (L + R - 1) / R * R;     // taps as stored
    K = TILE + Ap;                // window entries
    Ks = K / R * (R + PAD);       // padded size
  }
  __host__ __device__ size_t floats() const {
    return static_cast<size_t>(Ap) + Ks;
  }
};

__global__ void __launch_bounds__(THREADS)
fir_real_kernel(const float* __restrict__ x, const float* __restrict__ carry,
                const float* __restrict__ h, float* __restrict__ y,
                int T, int L, int ntiles) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay(L);
  float* g = smem;               // [Ap] reversed taps: g[a] = h[L-1-a]
  float* w = g + lay.Ap;         // [Ks] the tile's input window, padded

  const int r = blockIdx.x / ntiles;
  const int t = blockIdx.x - r * ntiles;
  const long long xrow = static_cast<long long>(r) * T;
  const long long crow = static_cast<long long>(r) * (L - 1);

  // the window by cp.async: every copy of the thread is in flight at once
  // (a load into a register, stored to shared memory, waits out the
  // device-memory latency once per sample)
  const int n0 = t * TILE - (L - 1);   // x index of window position 0
  if (n0 >= 0 && n0 + lay.K <= T) {
    // an inner tile: sample tid + THREADS*i lands THREADS/R whole groups
    // further on per step, so both addresses move by constants
    const float* src = x + xrow + n0 + threadIdx.x;
    float* dst = w + firwin::padded<R>(threadIdx.x);
#pragma unroll
    for (int i = 0; i < R; ++i)
      cp_async_f32(dst + i * (THREADS / R * (R + PAD)), src + i * THREADS);
    for (int q = TILE + threadIdx.x; q < lay.K; q += THREADS)
      cp_async_f32(w + firwin::padded<R>(q), x + xrow + n0 + q);
  } else {
    for (int q = threadIdx.x; q < lay.K; q += THREADS) {
      const int n = t * TILE + q;  // xp index
      float* dst = w + firwin::padded<R>(q);
      if (n < L - 1)
        cp_async_f32(dst, carry + crow + n);
      else if (n - (L - 1) < T)
        cp_async_f32(dst, x + xrow + n - (L - 1));
      else
        *dst = 0.f;
    }
  }
  for (int a = threadIdx.x; a < lay.Ap; a += THREADS)
    g[a] = a < L ? h[L - 1 - a] : 0.f;
  cp_async_wait_all();
  __syncthreads();

  const int ot = t * TILE + threadIdx.x * R;   // this thread's first output
  if (ot >= T) return;
  float acc[R];
#pragma unroll
  for (int k = 0; k < R; ++k) acc[k] = 0.f;
  firwin::correlate<R>(acc, w + threadIdx.x * (R + PAD), g, lay.A4);
  float* yp = y + xrow + ot;
  if ((T & 3) == 0 && ot + R <= T) {
    float4* q = reinterpret_cast<float4*>(yp);
#pragma unroll
    for (int i = 0; i < R / 4; ++i)
      q[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                         acc[4 * i + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (ot + k < T) yp[k] = acc[k];
  }
}

}  // namespace

// x: [rows, T] float32, contiguous.  carry: [rows, L-1] float32.  h: [L]
// float32, 1 <= L <= 24576.  y: [rows, T] float32, 16-byte aligned.
// rows * ceil(T / 2048) < 2^31.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int fir_real_launch(const void* x, const void* carry,
                               const void* h, void* y, int rows, int T, int L,
                               void* stream) {
  if (L < 1 || L > LMAX) return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = (T + TILE - 1) / TILE;
  const dim3 grid(ntiles * rows);
  const size_t smem = sizeof(float) * Layout(L).floats();
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        fir_real_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  fir_real_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(carry),
      static_cast<const float*>(h), static_cast<float*>(y), T, L, ntiles);
  return static_cast<int>(cudaGetLastError());
}
