// Fused codebook correlation + argmax (soft block-code decode), for Hopper
// (sm_90a).
//
// Replaces liquid_dsp_tpu/ops/kernels/pallas_codebook.py:codebook_argmax,
// the TPU kernel behind fec/device._scores_argmax for codebooks of
// K >= 1024 words (golay2412: n=24, K=4096; hamming1511: n=15, K=2048).
//
// What it computes, per row m of cw [M, n] f32 soft bits:
//   score[k] = sum_{i<n} cw[m, i] * bip[i, k]      bip in {+1, -1}
//   out[m]   = the smallest k with the largest score
// without ever writing the [M, K] scores to device memory (2.5 GB at the
// receiver's 153,600 rows x 4096).
//
// Exactness.  Every product cw*bip is exact (bip is +-1), so the score is
// the f32 sum acc = acc + (+-cw[i]) taken in the order i = 0..n-1 from
// acc = 0.  The plain version in ops/kernels/codebook_argmax.py sums in
// the same order, so the two give bit-identical scores and the same index.
// The sign comes from a packed mask: bit (31 - i) of mask[k] is set where
// bip[i, k] = -1, and flipping the float's sign bit with it is exact.
//
// Bound on this card: the adds.  15.1 G f32 adds per receiver block
// (153,600 x 4096 x 24); each add costs three instructions here (sign
// flip, mask shift, add).  Device-memory traffic is small: the soft bits
// once (14.7 MB) and the 16 KB mask table, served from L2 to every block.
// The design:
//   * a block holds TILE_M rows' soft bits in shared memory; every warp
//     reads the same word at a time, a broadcast;
//   * each thread strides over the columns CB at a time, so one shared
//     load feeds CB adds, and keeps a running (score, index) per row with
//     a strict '>' (first index wins inside a thread);
//   * a warp-shuffle and then a shared-memory reduction per row take the
//     largest score and, on equal scores, the smaller index.
//
// Built by liquid_dsp_tpu_torch/ops/kernels/build.py with nvcc for sm_90a,
// bound with ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_M = 16;   // rows per block
constexpr int CB = 4;        // columns per thread per pass
constexpr int NMAX = 32;     // soft bits per row (one 32-bit mask per column)

// (s, k) beats (t, j): larger score, or equal score and smaller index
__device__ __forceinline__ bool better(float s, int k, float t, int j) {
  return s > t || (s == t && k < j);
}

__global__ void __launch_bounds__(THREADS)
codebook_argmax_kernel(const float* __restrict__ cw,
                       const unsigned* __restrict__ masks,
                       int* __restrict__ out, int M, int n, int K) {
  __shared__ float sw[TILE_M * NMAX];
  __shared__ float red_s[WARPS][TILE_M];
  __shared__ int red_k[WARPS][TILE_M];

  const int row0 = blockIdx.x * TILE_M;
  for (int q = threadIdx.x; q < TILE_M * n; q += THREADS) {
    const int r = q / n;
    sw[q] = row0 + r < M ? cw[static_cast<long long>(row0) * n + q] : 0.f;
  }
  __syncthreads();

  float best[TILE_M];
  int bidx[TILE_M];
#pragma unroll
  for (int r = 0; r < TILE_M; ++r) {
    best[r] = -CUDART_INF_F;
    bidx[r] = 0x7fffffff;
  }

  for (int c0 = threadIdx.x * CB; c0 < K; c0 += THREADS * CB) {
    unsigned m[CB];
#pragma unroll
    for (int j = 0; j < CB; ++j) m[j] = c0 + j < K ? masks[c0 + j] : 0u;
#pragma unroll
    for (int r = 0; r < TILE_M; ++r) {
      const float* w = sw + r * n;
      float acc[CB];
      unsigned mm[CB];
#pragma unroll
      for (int j = 0; j < CB; ++j) {
        acc[j] = 0.f;
        mm[j] = m[j];
      }
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const unsigned c = __float_as_uint(w[i]);
#pragma unroll
        for (int j = 0; j < CB; ++j) {
          // __fadd_rn: a plain rounded add, never contracted
          acc[j] = __fadd_rn(acc[j], __uint_as_float(c ^ (mm[j] & 0x80000000u)));
          mm[j] <<= 1;
        }
      }
#pragma unroll
      for (int j = 0; j < CB; ++j) {
        if (c0 + j < K && acc[j] > best[r]) {
          best[r] = acc[j];
          bidx[r] = c0 + j;
        }
      }
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < TILE_M; ++r) {
    float s = best[r];
    int k = bidx[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float t = __shfl_down_sync(0xffffffffu, s, off);
      const int j = __shfl_down_sync(0xffffffffu, k, off);
      if (better(t, j, s, k)) {
        s = t;
        k = j;
      }
    }
    if (lane == 0) {
      red_s[warp][r] = s;
      red_k[warp][r] = k;
    }
  }
  __syncthreads();
  if (threadIdx.x < TILE_M && row0 + threadIdx.x < M) {
    const int r = threadIdx.x;
    float s = red_s[0][r];
    int k = red_k[0][r];
    for (int w = 1; w < WARPS; ++w) {
      if (better(red_s[w][r], red_k[w][r], s, k)) {
        s = red_s[w][r];
        k = red_k[w][r];
      }
    }
    out[row0 + r] = k;
  }
}

}  // namespace

// cw: [M, n] float32, contiguous, n <= 32.  masks: [K] 32-bit words, bit
// (31 - i) set where bip[i, k] = -1.  out: [M] int32.  M >= 1, K >= 1.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int codebook_argmax_launch(const void* cw, const void* masks,
                                      void* out, int M, int n, int K,
                                      void* stream) {
  const dim3 grid((M + TILE_M - 1) / TILE_M);
  codebook_argmax_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cw), static_cast<const unsigned*>(masks),
      static_cast<int*>(out), M, n, K);
  return static_cast<int>(cudaGetLastError());
}
