// The inter-block state pass of the block-processed IIR filter, for Hopper
// (sm_90a).
//
// Replaces the lax.scan of liquid_dsp_tpu/ops/iir.py:172-181 (inside
// iir_apply_block); the JAX package has no Pallas kernel here.  The block
// form splits a stream of T samples into T/L blocks of L: inside a block
// the outputs are two matrix products (the Toeplitz matrix of the impulse
// response times the inputs, the observability matrix times the state at
// the block's start), and the only recurrence left is the state from one
// block to the next,
//   s_pre[r, n] = s;   s = M s + w[r, n]        (n = 0 .. nb-1)
// with M = A^L the state matrix over one block ([p, p]) and w = K u the
// inputs' contribution (one matrix product before this pass).  Those
// products stay cuBLAS matmuls, as XLA computed them outside any kernel;
// this kernel is the lax.scan between them.
//
// What it computes, per row r and block n, in the JAX package's order
// (s @ M^T, then + w): for each q, acc = s[0]*M[q][0], then
// acc += s[j]*M[q][j] for j = 1 .. p-1 in order, s'[q] = acc + w[r, n, q].
// Real filters run
// on float32 rows (a complex stream split into planes by the caller),
// complex filters on complex64 rows, their products written out on the
// planes: (ar*br - ai*bi, ar*bi + ai*br).
//
// Bound on this card: for the paths' shapes the bytes are small (w in and
// s_pre out, 8 states x 4 bytes x 2 per block and row: 0.005 ms at 128
// rows x 2048 blocks) and the chain is nb steps of a p-term dot product
// (a product and p-1 dependent sums, estimated at about 0.04 ms there).
// This simplest right form, one thread per row with M and the state in
// registers and one warp per block so the rows spread over the SMs, takes
// 1.18 ms there on an H100 (about 1,100 cycles a step), and a lone row
// 0.44 ms (214 ns a step): each lane reads its own row, so a warp's load
// touches 32 lines far apart and every step waits for memory with only 4
// warps to hide it.  Staging tiles through shared
// memory, and spreading a row's p outputs over lanes (a shuffle per
// state), are a later redesign.
//
// Numerics: every operation is rounded once and written explicitly
// (__fmul_rn, __fadd_rn, __fsub_rn), so nvcc contracts nothing into an FMA
// and the plain PyTorch version (ops/kernels/iir_block_state.py,
// iir_block_state_reference), which takes the same operations in the same
// order, agrees with it bit for bit.
//
// Built by liquid_dsp_tpu_torch/ops/kernels/build.py with nvcc for sm_90a,
// bound with ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;   // rows per block: one warp
constexpr int MAX_P = 8;    // states: M lives in registers

template <bool CPLX>
struct Arith;

template <>
struct Arith<false> {
  using T = float;
  static __device__ __forceinline__ T mul(T a, T b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ T add(T a, T b) { return __fadd_rn(a, b); }
};

template <>
struct Arith<true> {
  using T = float2;
  static __device__ __forceinline__ T mul(T a, T b) {
    return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                       __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
  }
  static __device__ __forceinline__ T add(T a, T b) {
    return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
  }
};

template <int P, bool CPLX>
__global__ void __launch_bounds__(LANES)
    iir_block_state_kernel(const typename Arith<CPLX>::T* __restrict__ w,
                           const typename Arith<CPLX>::T* __restrict__ mg,
                           typename Arith<CPLX>::T* __restrict__ s_io,
                           typename Arith<CPLX>::T* __restrict__ s_pre,
                           int rows, int nb) {
  using A = Arith<CPLX>;
  using V = typename A::T;
  const int r = blockIdx.x * LANES + threadIdx.x;
  if (r >= rows) return;
  V m[P][P], s[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
#pragma unroll
    for (int j = 0; j < P; ++j) m[q][j] = mg[q * P + j];
  }
#pragma unroll
  for (int q = 0; q < P; ++q) s[q] = s_io[static_cast<size_t>(r) * P + q];
  const V* wr = w + static_cast<size_t>(r) * nb * P;
  V* pr = s_pre + static_cast<size_t>(r) * nb * P;
  for (int n = 0; n < nb; ++n, wr += P, pr += P) {
    V wv[P], ns[P];
#pragma unroll
    for (int q = 0; q < P; ++q) wv[q] = wr[q];
#pragma unroll
    for (int q = 0; q < P; ++q) pr[q] = s[q];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      V acc = A::mul(s[0], m[q][0]);
#pragma unroll
      for (int j = 1; j < P; ++j) acc = A::add(acc, A::mul(s[j], m[q][j]));
      ns[q] = A::add(acc, wv[q]);
    }
#pragma unroll
    for (int q = 0; q < P; ++q) s[q] = ns[q];
  }
#pragma unroll
  for (int q = 0; q < P; ++q) s_io[static_cast<size_t>(r) * P + q] = s[q];
}

struct Args {
  const void* w;
  const void* m;
  void* s;
  void* s_pre;
  int rows, nb;
  cudaStream_t stream;
};

template <int P, bool CPLX>
int go(const Args& g) {
  using V = typename Arith<CPLX>::T;
  const dim3 grid((g.rows + LANES - 1) / LANES);
  iir_block_state_kernel<P, CPLX><<<grid, LANES, 0, g.stream>>>(
      static_cast<const V*>(g.w), static_cast<const V*>(g.m),
      static_cast<V*>(g.s), static_cast<V*>(g.s_pre), g.rows, g.nb);
  return static_cast<int>(cudaGetLastError());
}

template <bool CPLX, int P = 1>
int by_p(int p, const Args& g) {
  if constexpr (P > MAX_P) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return p == P ? go<P, CPLX>(g) : by_p<CPLX, P + 1>(p, g);
  }
}

}  // namespace

// w, s_pre: [rows, nb, p]; m: [p, p] (row q holds M[q][:]); s: [rows, p],
// read as the state before block 0 and overwritten with the state after
// the last block.  All float32 (cplx = 0) or all complex64 (cplx = 1);
// 1 <= p <= 8.
extern "C" int iir_block_state_launch(const void* w, const void* m, void* s,
                                      void* s_pre, int rows, int nb, int p,
                                      int cplx, void* stream) {
  if (rows < 1 || nb < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args g{w, m, s, s_pre, rows, nb, static_cast<cudaStream_t>(stream)};
  return cplx ? by_p<true>(p, g) : by_p<false>(p, g);
}
