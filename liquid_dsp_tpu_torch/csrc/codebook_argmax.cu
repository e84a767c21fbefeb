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
// acc = 0, each add rounded once.  The plain version in
// ops/kernels/codebook_argmax.py sums in the same order, so the two give
// bit-identical scores and the same index.  The codebook comes packed and
// sorted: bit (31 - i) of mask[c] is set where bip[i, order[c]] = -1, the
// masks ascending as unsigned numbers, order[c] the column's own index.
//
// Bound on this card: the instruction rate of the adds, 15.1 G per receiver block
// (153,600 x 4096 x 24) against 132 SMs x 128 lanes x 1.98 GHz; the soft
// bits (14.7 MB, read once) and the 16 KB mask table are nothing beside
// it.  The card reaches that rate only when two of a multiply-add's three
// register operands repeat from the instruction before; with one
// repeating it reaches 0.82 of it and with none 0.6 (chip_kernel_bench.py
// --ffma-rate).  Here the running sum and the sign are new in every
// instruction, and the soft bit repeats at best.  The design:
//
//   * One instruction per add.  A thread unpacks the signs of its CB
//     columns once per pass into registers as +-1.0f and takes
//     acc = fma(w[i], s[i], acc): the product is exact and the one
//     rounding is the add's, so the score is the add chain's, bit for bit
//     (tests/test_torch_agc_codebook_identities.py).  The unpack is shared by
//     the TILE_M rows of the block.
//   * The soft bits of a row come from shared memory as float4, the same
//     address in every lane (a broadcast): one load per 16 adds.  Rows are
//     padded with zeros to NP, a multiple of 8, so the loops over the
//     positions unroll; adding +-0 changes no sum.
//   * Shared prefixes, exactly.  Columns whose masks agree on their first
//     P positions have the same partial sum after P adds, by the same
//     operations, so it is computed once for the thread's CB columns.  The
//     wrapper hands the columns over sorted by mask, so neighbours share
//     what they can: aligned groups of 4 of a 2^k-word code whose first k
//     positions are free share k - 2 of them (10 for golay2412, 9 for
//     hamming1511), 66 adds instead of 96 at n = 24.  Each pass looks at
//     its own masks: where every lane's 4 columns agree on the first
//     PFX<NP> positions the warp takes the shared form, else the
//     general one, so any codebook is served.
//   * Each thread keeps a running (score, index) per row, the index the
//     column's own (order[c]); sorted columns do not ascend in it, so a
//     larger score wins and an equal score keeps the smaller index.  A
//     warp-shuffle and then a shared-memory reduction per row do the
//     same.  Columns past K repeat the last real column with its index,
//     which changes nothing.
//
// Built by liquid_dsp_tpu_torch/ops/kernels/build.py with nvcc for sm_90a,
// bound with ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_M = 32;   // rows per block
constexpr int CB = 4;        // columns per thread per pass
constexpr unsigned FULL = 0xffffffffu;

// Positions summed once for a thread's CB columns in the shared form, by
// the padded row width: what sorted golay2412 (n = 24) and hamming1511
// (n = 15) share, 8 elsewhere.
template <int NP>
constexpr int PFX = NP == 24 ? 10 : NP == 16 ? 9 : 8;

// (s, k) beats (t, j): larger score, or equal score and smaller index
__device__ __forceinline__ bool better(float s, int k, float t, int j) {
  return s > t || (s == t && k < j);
}

// +-1.0f from bit (31 - i) of a column's mask
__device__ __forceinline__ float sign_of(unsigned mask, int i) {
  return __uint_as_float(((mask << i) & 0x80000000u) | 0x3f800000u);
}

// One pass of a thread over the block's rows: the scores of its CB
// columns (masks m, own indices o), the first P positions summed once,
// against the running best of each row.
template <int NP, int P>
__device__ __forceinline__ void score_rows(const float* __restrict__ sw,
                                           const unsigned (&m)[CB],
                                           const int (&o)[CB],
                                           float (&best)[TILE_M],
                                           int (&bidx)[TILE_M]) {
  float s0[P > 0 ? P : 1];
  float s[NP > P ? NP - P : 1][CB];
#pragma unroll
  for (int i = 0; i < P; ++i) s0[i] = sign_of(m[0], i);
#pragma unroll
  for (int i = P; i < NP; ++i)
#pragma unroll
    for (int j = 0; j < CB; ++j) s[i - P][j] = sign_of(m[j], i);

#pragma unroll
  for (int r = 0; r < TILE_M; ++r) {
    float w[NP];
#pragma unroll
    for (int i = 0; i < NP; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(sw + r * NP + i);
      w[i] = v.x;
      w[i + 1] = v.y;
      w[i + 2] = v.z;
      w[i + 3] = v.w;
    }
    // __fmaf_rn with a factor of +-1: the add's rounding and no other
    float head = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) head = __fmaf_rn(w[i], s0[i], head);
    float acc[CB];
#pragma unroll
    for (int j = 0; j < CB; ++j) acc[j] = head;
#pragma unroll
    for (int i = P; i < NP; ++i)
#pragma unroll
      for (int j = 0; j < CB; ++j)
        acc[j] = __fmaf_rn(w[i], s[i - P][j], acc[j]);
#pragma unroll
    for (int j = 0; j < CB; ++j) {
      const bool more = acc[j] > best[r];
      const bool same = acc[j] == best[r];
      best[r] = fmaxf(best[r], acc[j]);
      bidx[r] = more ? o[j] : same ? min(bidx[r], o[j]) : bidx[r];
    }
  }
}

template <int NP>
__global__ void __launch_bounds__(THREADS)
codebook_argmax_kernel(const float* __restrict__ cw,
                       const unsigned* __restrict__ masks,
                       const int* __restrict__ order,
                       int* __restrict__ out, int M, int n, int K) {
  constexpr int P = PFX<NP>;
  static_assert(P >= 1 && P <= NP, "the shared positions lie inside a row");
  __shared__ __align__(16) float sw[TILE_M * NP];
  __shared__ float red_s[WARPS][TILE_M];
  __shared__ int red_k[WARPS][TILE_M];

  const int row0 = blockIdx.x * TILE_M;
  for (int q = threadIdx.x; q < TILE_M * NP; q += THREADS) {
    const int r = q / NP, i = q - r * NP;
    sw[q] = row0 + r < M && i < n
                ? cw[static_cast<long long>(row0 + r) * n + i] : 0.f;
  }
  __syncthreads();

  float best[TILE_M];
  int bidx[TILE_M];
#pragma unroll
  for (int r = 0; r < TILE_M; ++r) {
    best[r] = -CUDART_INF_F;
    bidx[r] = 0x7fffffff;
  }

  // the same number of passes in every thread: the warp votes below
  for (int base = 0; base < K; base += THREADS * CB) {
    const int c0 = base + threadIdx.x * CB;
    unsigned m[CB];
    int o[CB];
    if (c0 + CB <= K) {
      const uint4 v = *reinterpret_cast<const uint4*>(masks + c0);
      const int4 u = *reinterpret_cast<const int4*>(order + c0);
      m[0] = v.x, m[1] = v.y, m[2] = v.z, m[3] = v.w;
      o[0] = u.x, o[1] = u.y, o[2] = u.z, o[3] = u.w;
    } else {
      // past K: the last real column again, with its own index
#pragma unroll
      for (int j = 0; j < CB; ++j) {
        m[j] = masks[min(c0 + j, K - 1)];
        o[j] = order[min(c0 + j, K - 1)];
      }
    }
    // the shared form where every lane's columns agree on their first P
    // positions, else the general one.  Keep both behind this vote: as
    // straight-line code in the pass loop the soft bits' loads do not
    // depend on the pass, the compiler lifts all of them out of the loop,
    // and the kernel spills (17.5 ms instead of 0.9 on an H100).
    unsigned differ = 0;
#pragma unroll
    for (int j = 1; j < CB; ++j) differ |= m[0] ^ m[j];
    if (__all_sync(FULL, (differ >> (32 - P)) == 0))
      score_rows<NP, P>(sw, m, o, best, bidx);
    else
      score_rows<NP, 0>(sw, m, o, best, bidx);
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < TILE_M; ++r) {
    float s = best[r];
    int k = bidx[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float t = __shfl_down_sync(FULL, s, off);
      const int j = __shfl_down_sync(FULL, k, off);
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

// cw: [M, n] float32, contiguous, n <= 32.  masks: [K] 32-bit words, 16-byte
// aligned, ascending as unsigned numbers; order: [K] int32, 16-byte aligned,
// the column of bip that masks[c] packs (bit (31 - i) set where
// bip[i, order[c]] = -1).  out: [M] int32.  M >= 1, K >= 1.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int codebook_argmax_launch(const void* cw, const void* masks,
                                      const void* order, void* out, int M,
                                      int n, int K, void* stream) {
  if (M < 1 || n < 1 || n > 32 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + TILE_M - 1) / TILE_M);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CODEBOOK_ARGS                                                     \
  static_cast<const float*>(cw), static_cast<const unsigned*>(masks),     \
      static_cast<const int*>(order), static_cast<int*>(out), M, n, K
  if (n <= 8)
    codebook_argmax_kernel<8><<<grid, THREADS, 0, st>>>(CODEBOOK_ARGS);
  else if (n <= 16)
    codebook_argmax_kernel<16><<<grid, THREADS, 0, st>>>(CODEBOOK_ARGS);
  else if (n <= 24)
    codebook_argmax_kernel<24><<<grid, THREADS, 0, st>>>(CODEBOOK_ARGS);
  else
    codebook_argmax_kernel<32><<<grid, THREADS, 0, st>>>(CODEBOOK_ARGS);
#undef CODEBOOK_ARGS
  return static_cast<int>(cudaGetLastError());
}
