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
// Real filters run on float32 rows (a complex stream split into planes by
// the caller), complex filters on complex64 rows, their products written
// out on the planes: (ar*br - ai*bi, ar*bi + ai*br).  1 <= p <= 32.
//
// Bound on this card: the chain.  The bytes are small (w in and s_pre out,
// 8 states x 4 bytes x 2 a block step and row: 0.005 ms at 128 rows x 2048
// blocks), and each block step needs the last one's whole state.  The
// design puts as little as it can on that chain:
//
// * A row takes P' lanes (P' the next power of two >= p), so a warp holds
//   32/P' rows.  Lane q keeps row q of M (p values) and its own state s[q]
//   in registers.  Each step it broadcasts the row's p states by
//   __shfl_sync (width P'; none at p = 1), then forms its one output in
//   the plain version's order.  Shuffles are exact, so the result is the
//   same bits; a lane issues p shuffles and 2p float operations a step
//   instead of a thread's 2p^2, and the chain is one shuffle, one product
//   and p sums (about 66 cycles at p = 8 from SHFL's measured 26 and
//   FADD's 4.5).  M's row is what a lane holds, so 32 states fit a warp.
// * A second warp copies, as agc_scan.cu's does.  It stages chunks of C
//   block steps of w (32 for float rows, 16 for complex: each row's chunk
//   is C*p contiguous values, 32p floats) into shared memory by 4-byte
//   cp.async, AHEAD chunks ahead; a row's chunk sits at a pitch of
//   C*p + P' mod 32 floats (P' mod 16 float2), so a warp's reads of
//   w[., n, q] fall in distinct banks.  The chain warp leaves s_pre in a
//   shared chunk laid out the same way, and the copy warp stores it as
//   full lines, the loads before the stores.  Its base addresses are
//   opaque registers (cp_async.cuh).  The two warps meet at one named
//   barrier per chunk.
// * Up to 4 states a whole chunk is one basic block of the chain warp
//   (its w loads first, then the steps); above, groups of 8 steps (a
//   whole chunk at 8 states takes twice as long).
// * Rows a block: as many as the warp holds, but for few states no more
//   than 8 lines a chunk (8 rows at p = 1, 2 at p = 4, 1 from p = 5), so
//   the copy warp keeps up with a short chain (at p = 1 and 32 rows a
//   block its 64 four-byte lines a chunk set a lone row's step at 64
//   cycles; at 8 rows, 16) and the rows spread over the SMs.  The chain
//   warp's other lanes mirror the block's rows.
//
// Measured on an H100 (80GB HBM3, 700 W; chip_kernel_bench.py --iir):
// 0.095 ms at 128 rows x 2048 blocks x 8 states (0.092-0.093 ms of device
// time), 87-90 cycles a step
// against the chain's ~66, the 128-row launch 1.01-1.04 times a lone
// row's loop; 0.063-0.065 ms at 64 x 2048 x 4 (61-63 cycles against ~48);
// 0.0058 ms of device time at 64 x 512 x 1; 0.143 and 0.239 ms at 64 x
// 2048 with 16 and 32 states (137 and 229 cycles against ~102 and ~175).
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

#include "cp_async.cuh"

namespace {

constexpr int LANES = 32;     // lanes of the chain warp
constexpr int AHEAD = 6;      // chunks staged ahead of the chain
constexpr int PBUF = 8;       // w chunks in shared memory (more than AHEAD)
constexpr int MAX_P = 32;     // states: one lane each
constexpr int MAX_LINES = 8;  // 128-byte lines of a block's chunk (P < 8)
constexpr unsigned FULL = 0xffffffffu;

template <bool CPLX>
struct Arith;

template <>
struct Arith<false> {
  using T = float;
  static __device__ __forceinline__ T mul(T a, T b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ T add(T a, T b) { return __fadd_rn(a, b); }
  template <int PW>
  static __device__ __forceinline__ T bcast(T v, int j) {
    return PW == 1 ? v : __shfl_sync(FULL, v, j, PW);
  }
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
  template <int PW>
  static __device__ __forceinline__ T bcast(T v, int j) {
    return PW == 1 ? v
                   : make_float2(__shfl_sync(FULL, v.x, j, PW),
                                 __shfl_sync(FULL, v.y, j, PW));
  }
};

// The layout of a P-state instance.
template <int P, bool CPLX>
struct Shape {
  static constexpr int PW = P <= 1 ? 1 : P <= 2 ? 2 : P <= 4 ? 4
                          : P <= 8 ? 8 : P <= 16 ? 16 : 32;   // lanes a row
  // rows a block: as many as a warp holds, but for few states no more
  // than MAX_LINES lines a chunk, so the copy warp keeps up and the rows
  // spread over more SMs
  static constexpr int G0 = MAX_LINES / P > 1 ? MAX_LINES / P : 1;
  static constexpr int G = LANES / PW < G0 ? LANES / PW : G0;
  static constexpr int W = CPLX ? 2 : 1;        // floats a value
  static constexpr int C = LANES / W;           // block steps a chunk
  static constexpr int CPW = C * P * W;         // floats of a row's chunk: 32p
  static constexpr int RP = CPW + (PW % (LANES / W)) * W;   // row pitch
  static constexpr int BUF = G * RP;            // floats a chunk buffer
  static constexpr int LINES = G * P;           // 128-byte lines a chunk
  // block steps a basic block: the whole chunk up to 4 states, else 8
  static constexpr int GROUP = P <= 4 ? C : 8;
};

// One block step of lane q: returns sum_j s[j]*m[j] (in order) + wv, with
// s[j] the state held by lane j of the row.
template <int P, int PW, bool CPLX>
__device__ __forceinline__ typename Arith<CPLX>::T block_step(
    typename Arith<CPLX>::T s, const typename Arith<CPLX>::T (&m)[P],
    typename Arith<CPLX>::T wv) {
  using A = Arith<CPLX>;
  auto acc = A::mul(A::template bcast<PW>(s, 0), m[0]);
#pragma unroll
  for (int j = 1; j < P; ++j)
    acc = A::add(acc, A::mul(A::template bcast<PW>(s, j), m[j]));
  return A::add(acc, wv);
}

template <int P, bool CPLX>
__global__ void __launch_bounds__(2 * LANES)
    iir_block_state_kernel(const typename Arith<CPLX>::T* __restrict__ w,
                           const typename Arith<CPLX>::T* __restrict__ mg,
                           typename Arith<CPLX>::T* __restrict__ s_io,
                           typename Arith<CPLX>::T* __restrict__ s_pre,
                           int rows, int nb) {
  using A = Arith<CPLX>;
  using V = typename A::T;
  using S = Shape<P, CPLX>;
  __shared__ __align__(16) float sw[PBUF][S::BUF];   // w chunks
  __shared__ __align__(16) float sp[2][S::BUF];      // s_pre chunks
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * S::G;
  const int nrows = min(S::G, rows - r0);    // rows of this block
  const int nchunks = (nb + S::C - 1) / S::C;

  if (nrows < S::G) {   // the absent rows of a ragged last block read zeros
    for (int q = threadIdx.x; q < PBUF * S::BUF; q += 2 * LANES)
      (&sw[0][0])[q] = 0.f;
    __syncthreads();
  }

  if (threadIdx.x >= LANES) {
    // the copying warp: a row's chunk is CPW contiguous floats, P lines;
    // line i of a chunk is float (i % P) * 32 + lane of row i / P's part.
    // The lane's addresses are computed once: its float of row 0 (held in
    // a register, opaque), then rows at a stride of rowf floats (device
    // memory, one multiply-add a line) and RP floats (shared memory, a
    // constant offset)
    const unsigned rowf = static_cast<unsigned>(nb) * P * S::W;   // a row
    const size_t first = static_cast<size_t>(r0) * rowf + lane;
    const float* win = opaque(reinterpret_cast<const float*>(w) + first);
    float* pout = opaque(reinterpret_cast<float*>(s_pre) + first);
    const unsigned sw0 = smem_addr(&sw[0][0]) + 4 * lane;
    // floats of each row from chunk k's start to the row's end
    auto left = [&](int k) {
      const unsigned f = static_cast<unsigned>(k) * S::CPW;
      return f < rowf ? rowf - f : 0u;
    };
    auto stage = [&](int k) {
      const unsigned n = left(k);
      const float* src = win + static_cast<size_t>(k) * S::CPW;
      const unsigned dst = sw0 + (k % PBUF) * (4 * S::BUF);
#pragma unroll
      for (int i = 0; i < S::LINES; ++i) {
        const int g = i / P, c = (i % P) * LANES;
        if (g < nrows && c + lane < n)
          cp_async_f32_at(dst + 4 * (g * S::RP + c),
                          src + static_cast<size_t>(g) * rowf + c);
      }
      cp_async_commit();
    };
    // chunk k's s_pre to its rows as full lines: all the loads, then the
    // stores (a load then its store, line by line, would wait a
    // shared-memory latency a line)
    auto store = [&](int k) {
      const unsigned n = left(k);
      const float* src = sp[k & 1] + lane;
      float* dst = pout + static_cast<size_t>(k) * S::CPW;
      float v[S::LINES];
#pragma unroll
      for (int i = 0; i < S::LINES; ++i)
        v[i] = src[(i / P) * S::RP + (i % P) * LANES];
#pragma unroll
      for (int i = 0; i < S::LINES; ++i) {
        const int g = i / P, c = (i % P) * LANES;
        if (g < nrows && c + lane < n)
          dst[static_cast<size_t>(g) * rowf + c] = v[i];
      }
    };
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) stage(k);
    cp_async_wait_all_but<AHEAD - 1>();   // chunk 0 has landed
    tile_barrier();
    for (int k = 0; k < nchunks; ++k) {
      // the chain warp works on chunk k: store chunk k-1's s_pre, start
      // chunk k+AHEAD, wait for chunk k+1
      if (k > 0) store(k - 1);
      stage(k + AHEAD);
      cp_async_wait_all_but<AHEAD - 1>();
      tile_barrier();
    }
    if (nchunks > 0) store(nchunks - 1);
    return;
  }

  // the chain warp: lane = g * PW + q holds state q of the block's row g;
  // the lanes past G * PW mirror those below (the same state, the same
  // work, the same stores)
  const int g = (lane / S::PW) % S::G, q = lane % S::PW;
  const bool live_q = q < P;                  // false only when p < P'
  const bool live = live_q && g < nrows;
  const int qr = live_q ? q : P - 1;          // an idle lane reads a live slot
  V m[P];
#pragma unroll
  for (int j = 0; j < P; ++j) m[j] = live_q ? mg[q * P + j] : V{};
  V* const sg = s_io + static_cast<size_t>(r0 + g) * P + q;
  V s = live ? *sg : V{};
  tile_barrier();
  for (int k = 0; k < nchunks; ++k) {
    const V* in = reinterpret_cast<const V*>(sw[k % PBUF] + g * S::RP) + qr;
    V* out = reinterpret_cast<V*>(sp[k & 1] + g * S::RP) + q;
    const int left = nb - k * S::C;
    if (left >= S::C) {
      // a group of steps is one basic block: its w loads first, then the
      // chain, each s_pre stored as the step begins
#pragma unroll 1
      for (int n = 0; n < S::C; n += S::GROUP) {
        V wv[S::GROUP];
#pragma unroll
        for (int u = 0; u < S::GROUP; ++u) wv[u] = in[(n + u) * P];
#pragma unroll
        for (int u = 0; u < S::GROUP; ++u) {
          if (live_q) out[(n + u) * P] = s;
          s = block_step<P, S::PW, CPLX>(s, m, wv[u]);
        }
      }
    } else {
      for (int n = 0; n < left; ++n) {
        if (live_q) out[n * P] = s;
        s = block_step<P, S::PW, CPLX>(s, m, in[n * P]);
      }
    }
    tile_barrier();
  }
  if (live && lane < S::G * S::PW) *sg = s;
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
  constexpr int G = Shape<P, CPLX>::G;
  const dim3 grid((g.rows + G - 1) / G);
  iir_block_state_kernel<P, CPLX><<<grid, 2 * LANES, 0, g.stream>>>(
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
// 1 <= p <= 32.
extern "C" int iir_block_state_launch(const void* w, const void* m, void* s,
                                      void* s_pre, int rows, int nb, int p,
                                      int cplx, void* stream) {
  if (rows < 1 || nb < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args g{w, m, s, s_pre, rows, nb, static_cast<cudaStream_t>(stream)};
  return cplx ? by_p<true>(p, g) : by_p<false>(p, g);
}
