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
// The transfer-function form is NS = 1 with any N in 2..17 in registers,
// and N in 18..4096 in the wide form (N = 0 in the template: n at run time,
// the coefficients and the rows' states in shared memory, the lanes of
// the 4 rows alone on the chain; slow, a shared load and store a
// coefficient, but it takes any order the reference takes); a cascade of
// second-order sections is N = 3 with NS in 1..8 (the wrapper runs a
// longer cascade as launches of at most 8 sections, each on its own slice
// of the state, one launch's output the next one's input: each section's
// arithmetic is unchanged, so the bits are too).  Real coefficients run
// on float32 rows (a complex stream is split into its two planes by the
// caller); complex coefficients on complex64 rows, their products written
// out on the planes: (ar*br - ai*bi, ar*bi + ai*br).
//
// Bound on this card: the chain.  Each sample's first section needs the
// last sample's state through a sum, a product and a difference per
// section (12.44 cycles for the one-pole step alone on a warp,
// chip_kernel_bench.py --latency), and the sections follow one another
// inside the sample; the 8 bytes a real sample moves are nothing beside
// that.  The time axis is not split: that would change the arithmetic,
// and the block form (iir_block_state.cu and the matmuls around it) is
// that split.  So a row can go no faster than its chain, and at the
// shadowing's shape (64 rows x 262144 samples, one pole) the chain alone
// is 262144 x 12.44 cycles = 1.65 ms at 1.98 GHz, however few rows there
// are.  The design keeps everything else off the chain:
//
// * One lane per row in a chain warp that runs the chain and nothing
//   else: the coefficients and the state in registers, every operation
//   rounded once.  A whole tile is one basic block: its samples' loads
//   from shared memory first, then the chain, each output stored as it
//   forms (with the loads at the top of groups of 8, ptxas sinks them
//   below the chain, and each group waits for shared memory).  A last
//   ragged tile runs sample by sample.
// * 4 rows a block (the chain warp's other lanes mirror them: the same
//   state, the same work, the same stores), so the copy warp moves 4
//   lines in and 4 out a tile and the rows spread over the SMs: at 32
//   rows a block the copy warp's 64 four-byte lines a tile took longer
//   than a one-pole chain's tile (the 64-row launch 1.16 times a lone
//   row's loop, 1.00 at 4 rows).
// * A second warp copies, as agc_scan.cu's does.  It stages tiles of x,
//   a row's tile one 128-byte line (32 float samples or 16 complex ones),
//   into shared memory by 4-byte cp.async, AHEAD tiles ahead of the
//   chain: any T and any row start, no alignment asked.  Rows sit at a
//   pitch of 33 floats (34 for complex rows: 17 float2, odd, so 64-bit
//   reads hit distinct bank pairs), so the chain lanes' walk down their
//   own rows hits distinct banks.  The chain warp leaves y in a shared
//   tile the same way, and the copy warp stores it as full lines, the
//   loads before the stores.  Its base addresses are opaque registers
//   (cp_async.cuh), so ptxas does not rebuild them from the kernel's
//   parameters line by line.  The two warps meet at one named barrier
//   per tile.
//
// Measured on an H100 (80GB HBM3, 700 W; chip_kernel_bench.py --iir): at
// the shadowing's shape 2.99 ms, 22.5 cycles a sample, the 64-row launch
// 1.00 times a lone row's loop: memory does not set the time.  What is
// left above the step's 12.44 cycles: warps issue in order, and each
// sample's input product sits between the last state and this sum (about
// 15 cycles a sample in the SASS), then a tile's barrier and loads.
//
// Numerics: every operation is rounded once and written explicitly
// (__fmul_rn, __fadd_rn, __fsub_rn), so nvcc contracts nothing into an FMA
// and the plain PyTorch version (ops/kernels/iir_scan.py,
// iir_scan_reference), which takes the same operations in the same order,
// agrees with it bit for bit.  Fused multiply-adds would cut the chain to
// two operations a section, with a plain version that takes the same
// FMAs (ROADMAP, recorded for the queues that follow the benchmark).
//
// Built by liquid_dsp_tpu_torch/ops/kernels/build.py with nvcc for sm_90a,
// bound with ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int LANES = 32;     // lanes of the chain warp
constexpr int ROWS = 4;       // rows per block: a chain each
constexpr int LINE = 32;      // floats of a row per staged tile: 128 bytes
constexpr int AHEAD = 6;      // tiles staged ahead of the chain
constexpr int PBUF = 8;       // x tiles in shared memory (more than AHEAD)
constexpr int MAX_N = 17;     // transfer-function form in registers
constexpr int MAX_NS = 8;     // second-order sections in one launch
// the wide form's largest section: its coefficients and 4 row states,
// (6n - 4) complex values, stay within the 227 KB a block may ask for
constexpr int MAX_WIDE_N = 4096;

template <bool CPLX>
struct Arith;

template <>
struct Arith<false> {
  using T = float;
  static constexpr int PITCH = LINE + 1;   // row pitch in shared, floats
  static __device__ __forceinline__ T mul(T a, T b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ T add(T a, T b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ T sub(T a, T b) { return __fsub_rn(a, b); }
};

template <>
struct Arith<true> {
  using T = float2;
  static constexpr int PITCH = LINE + 2;   // 17 float2: odd
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
__global__ void __launch_bounds__(2 * LANES)
    iir_scan_kernel(const typename Arith<CPLX>::T* __restrict__ x,
                    typename Arith<CPLX>::T* __restrict__ y,
                    const typename Arith<CPLX>::T* __restrict__ bg,
                    const typename Arith<CPLX>::T* __restrict__ ag,
                    typename Arith<CPLX>::T* __restrict__ state, int rows,
                    int T, int n) {
  using A = Arith<CPLX>;
  using V = typename A::T;
  constexpr int W = sizeof(V) / sizeof(float);   // floats a sample
  constexpr int TILE = LINE / W;                 // samples a tile
  constexpr int PITCH = A::PITCH;
  __shared__ __align__(16) float sx[PBUF][ROWS * PITCH];   // x tiles
  __shared__ __align__(16) float sy[2][ROWS * PITCH];      // y tiles
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * ROWS;
  const int nch = min(ROWS, rows - r0);      // rows of this block
  const int ntiles = (T + TILE - 1) / TILE;

  if (nch < ROWS) {   // the absent rows of a ragged last block read zeros
    for (int q = threadIdx.x; q < PBUF * ROWS * PITCH; q += 2 * LANES)
      (&sx[0][0])[q] = 0.f;
    __syncthreads();
  }

  // the wide form (N = 0: one section of n coefficients, any n): the
  // coefficients [n] b, [n] a and the block's row states [ROWS][n-1] sit
  // in dynamic shared memory, loaded here by both warps
  extern __shared__ __align__(16) float wide[];
  V* const cb = reinterpret_cast<V*>(wide);
  V* const ca = cb + n;
  V* const cs = ca + n;
  if constexpr (N == 0) {
    for (int q = threadIdx.x; q < n; q += 2 * LANES) {
      cb[q] = bg[q];
      ca[q] = ag[q];
    }
    const size_t s0 = static_cast<size_t>(r0) * (n - 1);
    for (int q = threadIdx.x; q < ROWS * (n - 1); q += 2 * LANES)
      cs[q] = q < nch * (n - 1) ? state[s0 + q] : V{};
    __syncthreads();
  }

  if (threadIdx.x >= LANES) {
    // the copying warp: a row's tile is one line, a float per lane.  The
    // lane's addresses are computed once: its float of row 0 (held in a
    // register, opaque), then rows at a stride of rowf floats (device
    // memory, one multiply-add a line) and PITCH floats (shared memory, a
    // constant offset)
    const unsigned rowf = static_cast<unsigned>(T) * W;   // floats a row
    const size_t first = static_cast<size_t>(r0) * rowf + lane;
    const float* xin = opaque(reinterpret_cast<const float*>(x) + first);
    float* yout = opaque(reinterpret_cast<float*>(y) + first);
    const unsigned sx0 = smem_addr(&sx[0][0]) + 4 * lane;
    // tile nt of x into its buffer (nothing for a tile past the end);
    // closes a group either way
    auto stage = [&](int nt) {
      const unsigned f = static_cast<unsigned>(nt) * LINE;
      if (f + lane < rowf) {
        const float* src = xin + f;
        const unsigned dst = sx0 + (nt % PBUF) * (4 * ROWS * PITCH);
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          if (r < nch)
            cp_async_f32_at(dst + 4 * r * PITCH,
                            src + static_cast<size_t>(r) * rowf);
      }
      cp_async_commit();
    };
    // tile nt's outputs from shared memory to their rows, as full lines:
    // the loads, then the stores
    auto store = [&](int nt) {
      const unsigned f = static_cast<unsigned>(nt) * LINE;
      if (f + lane < rowf) {
        const float* src = sy[nt & 1] + lane;
        float v[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) v[r] = src[r * PITCH];
        float* dst = yout + f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          if (r < nch) dst[static_cast<size_t>(r) * rowf] = v[r];
      }
    };
#pragma unroll
    for (int nt = 0; nt < AHEAD; ++nt) stage(nt);
    cp_async_wait_all_but<AHEAD - 1>();   // tile 0 has landed
    tile_barrier();
    for (int nt = 0; nt < ntiles; ++nt) {
      // the chain warp works on tile nt: store tile nt-1's outputs, start
      // tile nt+AHEAD, wait for tile nt+1
      if (nt > 0) store(nt - 1);
      stage(nt + AHEAD);
      cp_async_wait_all_but<AHEAD - 1>();
      tile_barrier();
    }
    if (ntiles > 0) store(ntiles - 1);
    return;
  }

  // the chain warp: lane l runs row l % ROWS
  const int row = lane % ROWS;
  if constexpr (N == 0) {
    // the wide form: lanes 0..ROWS-1 walk their row's state in shared
    // memory, in place in the order i = 0 .. n-2 (s[i] reads s[i+1]
    // before it is written); the other lanes only meet the barriers
    V* const s = cs + row * (n - 1);
    const bool mine = lane < ROWS;
    tile_barrier();
    for (int nt = 0; nt < ntiles; ++nt) {
      const V* in = reinterpret_cast<const V*>(sx[nt % PBUF] + row * PITCH);
      V* out = reinterpret_cast<V*>(sy[nt & 1] + row * PITCH);
      const int cnt = T - nt * TILE < TILE ? T - nt * TILE : TILE;
      for (int u = 0; mine && u < cnt; ++u) {
        const V v = in[u];
        const V yk = A::add(A::mul(cb[0], v), s[0]);
        for (int i = 0; i + 2 < n; ++i)
          s[i] = A::add(A::sub(A::mul(cb[i + 1], v), A::mul(ca[i + 1], yk)),
                        s[i + 1]);
        s[n - 2] = A::sub(A::mul(cb[n - 1], v), A::mul(ca[n - 1], yk));
        out[u] = yk;
      }
      tile_barrier();
    }
    const size_t s0 = static_cast<size_t>(r0) * (n - 1);
    for (int q = lane; q < nch * (n - 1); q += LANES) state[s0 + q] = cs[q];
  } else {
    // the lanes past ROWS mirror those below (the same state, the same
    // work, the same stores)
    const bool live = row < nch;
    V b[NS][N], a[NS][N], s[NS][N - 1];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        b[k][i] = bg[k * N + i];
        a[k][i] = ag[k * N + i];
      }
    }
    V* const st = state + static_cast<size_t>(r0 + row) * NS * (N - 1);
#pragma unroll
    for (int k = 0; k < NS; ++k) {
#pragma unroll
      for (int i = 0; i < N - 1; ++i)
        s[k][i] = live ? st[k * (N - 1) + i] : V{};
    }
    tile_barrier();
    for (int nt = 0; nt < ntiles; ++nt) {
      const V* in = reinterpret_cast<const V*>(sx[nt % PBUF] + row * PITCH);
      V* out = reinterpret_cast<V*>(sy[nt & 1] + row * PITCH);
      const int left = T - nt * TILE;
      if (left >= TILE) {
        // the whole tile is one basic block: its loads first (one shared
        // latency a tile), then the chain, each output stored as it forms
        V v[TILE];
#pragma unroll
        for (int u = 0; u < TILE; ++u) v[u] = in[u];
#pragma unroll
        for (int u = 0; u < TILE; ++u) {
          v[u] = step<NS, N, CPLX>(v[u], b, a, s);
          out[u] = v[u];
        }
      } else {
        for (int u = 0; u < left; ++u)
          out[u] = step<NS, N, CPLX>(in[u], b, a, s);
      }
      tile_barrier();
    }
    if (live && lane < ROWS) {
#pragma unroll
      for (int k = 0; k < NS; ++k) {
#pragma unroll
        for (int i = 0; i < N - 1; ++i) st[k * (N - 1) + i] = s[k][i];
      }
    }
  }
}

struct Args {
  const void* x;
  void* y;
  const void* b;
  const void* a;
  void* state;
  int rows, T, n;
  cudaStream_t stream;
};

template <int NS, int N, bool CPLX>
int go(const Args& g) {
  using V = typename Arith<CPLX>::T;
  const dim3 grid((g.rows + ROWS - 1) / ROWS);
  // the wide form's coefficients and row states (none for the others)
  const size_t shmem = N == 0 ? sizeof(V) * (2 * g.n + ROWS * (g.n - 1)) : 0;
  if (shmem > 0) {
    const cudaError_t rc = cudaFuncSetAttribute(
        iir_scan_kernel<NS, N, CPLX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shmem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  iir_scan_kernel<NS, N, CPLX><<<grid, 2 * LANES, shmem, g.stream>>>(
      static_cast<const V*>(g.x), static_cast<V*>(g.y),
      static_cast<const V*>(g.b), static_cast<const V*>(g.a),
      static_cast<V*>(g.state), g.rows, g.T, g.n);
  return static_cast<int>(cudaGetLastError());
}

// the transfer-function form: one section of n coefficients, in
// registers up to MAX_N, in shared memory (the wide form) above
template <bool CPLX, int N = 2>
int by_n(int n, const Args& g) {
  if constexpr (N > MAX_N) {
    return n <= MAX_WIDE_N ? go<1, 0, CPLX>(g)
                           : static_cast<int>(cudaErrorInvalidValue);
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
// Takes ns = 1 with 2 <= n <= MAX_WIDE_N (4096), or n = 3 with 1 <= ns <= 8
// (the wrapper runs longer cascades as successive launches).
extern "C" int iir_scan_launch(const void* x, void* y, const void* b,
                               const void* a, void* state, int rows, int T,
                               int ns, int n, int cplx, void* stream) {
  if (rows < 1 || T < 0 || ns < 1 || n < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args g{x, y, b, a, state, rows, T, n,
               static_cast<cudaStream_t>(stream)};
  return cplx ? dispatch<true>(ns, n, g) : dispatch<false>(ns, n, g);
}
