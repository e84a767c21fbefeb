// The per-sample IIR recurrence (a cascade of transposed direct-form II
// sections), for Hopper (sm_90a).
//
// Replaces the lax.scans of liquid_dsp_tpu/ops/iir.py:37-57 (iir_apply_tf)
// and :60-78 (iir_apply_sos), and the shadowing loop of
// liquid_dsp_tpu/ops/channel.py:65-75 (a one-pole filter); the JAX package
// has no Pallas kernel here, and PyTorch has no scan that stays on the
// device.
//
// What it computes, per row r (a channel, or one float plane of it) and
// sample t, for sections k = 0 .. NS-1 of N coefficients each (a[k][0] is
// 1 and not read), v = x[r, t] on entry and y[r, t] = v after the last
// section (iir.py:48-51 and :66-71, in that order of operations):
//   yk        = b[k][0]*v + s[k][0]
//   s[k][i]   = (b[k][i+1]*v - a[k][i+1]*yk) + s[k][i+1]   (i < N-2)
//   s[k][N-2] =  b[k][N-1]*v - a[k][N-1]*yk
//   v         = yk
// The transfer-function form is NS = 1 with any N in 2..17; a cascade of
// second-order sections is N = 3 with NS in 1..8.  Real coefficients run
// on float32 rows (a complex stream is split into its two planes by the
// caller); complex coefficients on complex64 rows, their products written
// out on the planes: (ar*br - ai*bi, ar*bi + ai*br).
//
// Bound on this card: the chain.  Each sample's first section needs the
// last sample's state, through a product, a difference and a sum per
// section (about 12 cycles at 4 cycles a dependent float operation), and
// the sections follow one another inside the sample; the 8 bytes a real
// sample moves are nothing beside that, and the time axis cannot be split
// without changing the arithmetic (the block form, iir_block_state.cu,
// is that change).  This is the simplest design that is right:
//
// * One thread per row, the coefficients and the state in registers; a
//   warp per block, so the rows spread over as many SMs as there are
//   warps.
// * Straight-line code over 8 samples: the 8 loads first, the 8 steps, the
//   8 stores, one basic block.  A ragged tail runs sample by sample.
//
// It does not reach the chain: at 64 rows x 262144 samples, one pole, it
// takes about 28 ms on an H100 (211 cycles a sample) against the chain's
// estimated 1.6 ms, and a lone row 6.9 ms (26 ns a sample).  Each lane
// reads its own row, so a warp's load touches 32 lines 1 MB apart and a
// group's loads wait for memory after the last group's chain, with 2
// warps to hide it.  Staging tiles through shared
// memory from a second warp, as agc_scan.cu does, is a later redesign.
//
// Numerics: every operation is rounded once and written explicitly
// (__fmul_rn, __fadd_rn, __fsub_rn), so nvcc contracts nothing into an FMA
// and the plain PyTorch version (ops/kernels/iir_scan.py,
// iir_scan_reference), which takes the same operations in the same order,
// agrees with it bit for bit.
//
// Built by liquid_dsp_tpu_torch/ops/kernels/build.py with nvcc for sm_90a,
// bound with ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;     // rows per block: one warp
constexpr int GROUP = 8;      // samples per basic block
constexpr int MAX_N = 17;     // transfer-function form: order up to 16
constexpr int MAX_NS = 8;     // second-order sections: order up to 16

template <bool CPLX>
struct Arith;

template <>
struct Arith<false> {
  using T = float;
  static __device__ __forceinline__ T mul(T a, T b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ T add(T a, T b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ T sub(T a, T b) { return __fsub_rn(a, b); }
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
  static __device__ __forceinline__ T sub(T a, T b) {
    return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
  }
};

// One sample through the cascade; returns the output.
template <int NS, int N, bool CPLX>
__device__ __forceinline__ typename Arith<CPLX>::T step(
    typename Arith<CPLX>::T v, const typename Arith<CPLX>::T (&b)[NS][N],
    const typename Arith<CPLX>::T (&a)[NS][N],
    typename Arith<CPLX>::T (&s)[NS][N - 1]) {
  using A = Arith<CPLX>;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const auto yk = A::add(A::mul(b[k][0], v), s[k][0]);
#pragma unroll
    for (int i = 0; i + 2 < N; ++i)
      s[k][i] = A::add(
          A::sub(A::mul(b[k][i + 1], v), A::mul(a[k][i + 1], yk)),
          s[k][i + 1]);
    s[k][N - 2] = A::sub(A::mul(b[k][N - 1], v), A::mul(a[k][N - 1], yk));
    v = yk;
  }
  return v;
}

template <int NS, int N, bool CPLX>
__global__ void __launch_bounds__(LANES)
    iir_scan_kernel(const typename Arith<CPLX>::T* __restrict__ x,
                    typename Arith<CPLX>::T* __restrict__ y,
                    const typename Arith<CPLX>::T* __restrict__ bg,
                    const typename Arith<CPLX>::T* __restrict__ ag,
                    typename Arith<CPLX>::T* __restrict__ state, int rows,
                    int T) {
  using V = typename Arith<CPLX>::T;
  const int r = blockIdx.x * LANES + threadIdx.x;
  if (r >= rows) return;
  V b[NS][N], a[NS][N], s[NS][N - 1];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      b[k][i] = bg[k * N + i];
      a[k][i] = ag[k * N + i];
    }
  }
  V* const st = state + static_cast<size_t>(r) * NS * (N - 1);
#pragma unroll
  for (int k = 0; k < NS; ++k) {
#pragma unroll
    for (int i = 0; i < N - 1; ++i) s[k][i] = st[k * (N - 1) + i];
  }
  const V* const xr = x + static_cast<size_t>(r) * T;
  V* const yr = y + static_cast<size_t>(r) * T;
  int t = 0;
  for (; t + GROUP <= T; t += GROUP) {
    V v[GROUP];
#pragma unroll
    for (int u = 0; u < GROUP; ++u) v[u] = xr[t + u];
#pragma unroll
    for (int u = 0; u < GROUP; ++u) v[u] = step<NS, N, CPLX>(v[u], b, a, s);
#pragma unroll
    for (int u = 0; u < GROUP; ++u) yr[t + u] = v[u];
  }
  for (; t < T; ++t) yr[t] = step<NS, N, CPLX>(xr[t], b, a, s);
#pragma unroll
  for (int k = 0; k < NS; ++k) {
#pragma unroll
    for (int i = 0; i < N - 1; ++i) st[k * (N - 1) + i] = s[k][i];
  }
}

struct Args {
  const void* x;
  void* y;
  const void* b;
  const void* a;
  void* state;
  int rows, T;
  cudaStream_t stream;
};

template <int NS, int N, bool CPLX>
int go(const Args& g) {
  using V = typename Arith<CPLX>::T;
  const dim3 grid((g.rows + LANES - 1) / LANES);
  iir_scan_kernel<NS, N, CPLX><<<grid, LANES, 0, g.stream>>>(
      static_cast<const V*>(g.x), static_cast<V*>(g.y),
      static_cast<const V*>(g.b), static_cast<const V*>(g.a),
      static_cast<V*>(g.state), g.rows, g.T);
  return static_cast<int>(cudaGetLastError());
}

// the transfer-function form: one section of n coefficients
template <bool CPLX, int N = 2>
int by_n(int n, const Args& g) {
  if constexpr (N > MAX_N) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return n == N ? go<1, N, CPLX>(g) : by_n<CPLX, N + 1>(n, g);
  }
}

// second-order sections: ns sections of 3 coefficients
template <bool CPLX, int NS = 2>
int by_ns(int ns, const Args& g) {
  if constexpr (NS > MAX_NS) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return ns == NS ? go<NS, 3, CPLX>(g) : by_ns<CPLX, NS + 1>(ns, g);
  }
}

template <bool CPLX>
int dispatch(int ns, int n, const Args& g) {
  if (ns == 1) return by_n<CPLX>(n, g);
  if (n == 3) return by_ns<CPLX>(ns, g);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, y: [rows, T] float32 (cplx = 0) or complex64 (cplx = 1); b, a:
// [ns, n] of the same type; state: [rows, ns, n - 1] of the same type, read
// as the carry and overwritten with the carry after the last sample.
// Takes ns = 1 with 2 <= n <= 17, or n = 3 with 1 <= ns <= 8.
extern "C" int iir_scan_launch(const void* x, void* y, const void* b,
                               const void* a, void* state, int rows, int T,
                               int ns, int n, int cplx, void* stream) {
  if (rows < 1 || T < 0 || ns < 1 || n < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args g{x, y, b, a, state, rows, T, static_cast<cudaStream_t>(stream)};
  return cplx ? dispatch<true>(ns, n, g) : dispatch<false>(ns, n, g);
}
