// A cascade of second-order sections evaluated parallel in time, for
// Hopper (sm_90a).
//
// Replaces the lax.associative_scan of liquid_dsp_tpu/ops/iir.py:266-305
// (iir_apply_sos_pscan, iirfilt_sos(backend="pscan")); the JAX package has
// no Pallas kernel here.  Each section's DF2T update is an affine map of
// its state s = (s0, s1):
//   s[n] = M s[n-1] + v[n],  M = [[-a1, 1], [-a2, 0]],
//   v[n] = (c1 x[n], c2 x[n]),  c1 = b1 - a1 b0,  c2 = b2 - a2 b0,
//   y[n] = b0 x[n] + s0[n-1]
// with x the section's input, the previous section's output.
//
// What it computes, per row (a channel, or one float plane of it): the
// row in tiles of TILE = NT * C samples, a tile in NT chunks of C samples,
// a chunk a thread.  Per tile, for each section in turn:
//   1. the walk: thread j runs the map over its chunk from the zero state
//      (thread 0 from the tile's carry), to its end state e_j;
//   2. the combine: an inclusive Kogge-Stone scan over the threads, for
//      d = 0 .. 9, e_j <- P_d e_{j-2^d} + e_j for j >= 2^d, with
//      P_d = M^(C 2^d), so e_j becomes the state at the end of chunk j;
//   3. the re-walk: thread j runs the map from its chunk's true start
//      (the carry, or e_{j-1}) and leaves y in its registers, the next
//      section's input.  The thread that holds the tile's last sample
//      keeps its end state as the section's carry into the next tile.
// The powers are repeated squares in float32 (Q_0 = M, Q_{i+1} = Q_i Q_i,
// P_d = Q_{log2 C + d}), formed once a launch by thread k for section k.
// Real coefficients run on float32 rows (the caller splits a complex
// stream into its planes), complex coefficients on complex64 rows, their
// products written out on the planes: (ar*br - ai*bi, ar*bi + ai*br).
//
// Bound on this card: the bytes.  A real row moves 8 bytes a sample (x
// in, y out once: 0.080 ms for 128 rows x 262144 samples at 3.35 TB/s)
// against 21 float operations a sample and section (7 a step of the walk,
// 9 of the re-walk, 8 a combine and chunk of 16, 10 combines): 0.042 ms
// at 4 sections at the float32 rate.  The serial chain of the per-sample
// form (iir_scan.cu) is gone: a row's depth is 2 C steps and 10 combines
// a tile and section.  The design:
//
// * One block of NT = 1024 threads a row, so 128 plane rows take 128 of
//   the 132 SMs and leave 4 idle (a row in several blocks would need a
//   carry between blocks, a decoupled look-back: later work).
// * A tile comes in by coalesced loads (thread t loads samples t, t + NT,
//   ...) into shared memory at a padded index (one pad a 32 floats, a 16
//   float2), from where each thread takes its chunk into registers without
//   bank conflicts; every section runs on those registers; the outputs go
//   back the same way.  One read and one write of x.
// * The scan's partners pass through shared memory, double-buffered by a
//   running phase (a write, a barrier, a read each phase; a buffer is
//   written again only two phases on, after the barrier between): 11
//   barriers a section and tile, 3 more a tile.
// * C = 16 samples a thread for real rows, 8 for complex (the chunk in
//   registers; 64 registers a thread at 1024 threads).  The walk's steps
//   are predicated on the chunk's count (a ragged last tile), not a loop
//   of run-time length, so the chunk stays in registers.
//
// Measured on an H100 (80GB HBM3, 700 W; chip_kernel_bench.py --pscan):
// 0.346-0.348 ms at 128 rows x 262144 with 4 sections (23% of the bytes'
// bound; iir_scan 7.47-7.53 ms on the same rows), 0.585-0.587 ms with 8; a
// lone row 0.284-0.286 ms, so each row's depth, not the memory, sets the
// time: a section and tile take ~7,400 cycles, and the tiles' loads and
// stores (about 0.11 ms) sit beside no work.
//
// Numerics: every operation is rounded once and written explicitly
// (__fmul_rn, __fadd_rn, __fsub_rn), so nvcc contracts nothing into an FMA
// and the plain PyTorch version (ops/kernels/iir_pscan.py,
// iir_pscan_reference), which takes the same operations in the same order
// with the same chunk, tile and combine order, agrees with it bit for bit.
// A step is s0' = (-a1) s0 + (s1 + c1 x), s1' = (-a2) s0 + c2 x; a
// combine (P[i][0] f0 + P[i][1] f1) + e_i.
//
// Built by liquid_dsp_tpu_torch/ops/kernels/build.py with nvcc for sm_90a,
// bound with ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int NT = 1024;      // threads a block: the chunks of a tile
constexpr int LOG_NT = 10;
constexpr int MAX_NS = 64;    // sections in one launch
// a section's constants in shared memory: b0, c1, c2, -a1, -a2, then
// P_d (4 entries, row-major) for d = 0 .. LOG_NT - 1
constexpr int SEC = 5 + 4 * LOG_NT;

template <bool CPLX>
struct Arith;

template <>
struct Arith<false> {
  using T = float;
  static __device__ __forceinline__ T mul(T a, T b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ T add(T a, T b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ T sub(T a, T b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ T neg(T a) { return -a; }
  static __device__ __forceinline__ T one() { return 1.f; }
  static __device__ __forceinline__ T zero() { return 0.f; }
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
  static __device__ __forceinline__ T neg(T a) { return make_float2(-a.x, -a.y); }
  static __device__ __forceinline__ T one() { return make_float2(1.f, 0.f); }
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
};

template <bool CPLX>
struct Shape {
  static constexpr int C = CPLX ? 8 : 16;            // samples a chunk
  static constexpr int LOG_C = CPLX ? 3 : 4;
  static constexpr int TILE = NT * C;                // samples a tile
  static constexpr int LOG_PAD = CPLX ? 4 : 5;       // one pad a 32 banks
  static constexpr int TILE_P = TILE + (TILE >> LOG_PAD);
};

template <bool CPLX>
__device__ __forceinline__ int padded(int g) {
  return g + (g >> Shape<CPLX>::LOG_PAD);
}

// Shared memory, in values V: the tile, the scan's two buffers of both
// state entries, the sections' constants, their carries.
template <bool CPLX>
size_t smem_bytes(int ns) {
  using V = typename Arith<CPLX>::T;
  return sizeof(V) * (static_cast<size_t>(Shape<CPLX>::TILE_P) + 4 * NT +
                      static_cast<size_t>(ns) * (SEC + 2));
}

// One step of the map on (e0, e1) with input u.
template <bool CPLX>
__device__ __forceinline__ void step(typename Arith<CPLX>::T& e0,
                                     typename Arith<CPLX>::T& e1,
                                     typename Arith<CPLX>::T u,
                                     typename Arith<CPLX>::T c1,
                                     typename Arith<CPLX>::T c2,
                                     typename Arith<CPLX>::T na1,
                                     typename Arith<CPLX>::T na2) {
  using A = Arith<CPLX>;
  const auto n0 = A::add(A::mul(na1, e0), A::add(e1, A::mul(c1, u)));
  const auto n1 = A::add(A::mul(na2, e0), A::mul(c2, u));
  e0 = n0;
  e1 = n1;
}

template <bool CPLX>
__global__ void __launch_bounds__(NT, 1)
    iir_pscan_kernel(const typename Arith<CPLX>::T* __restrict__ x,
                     typename Arith<CPLX>::T* __restrict__ y,
                     const typename Arith<CPLX>::T* __restrict__ bg,
                     const typename Arith<CPLX>::T* __restrict__ ag,
                     typename Arith<CPLX>::T* __restrict__ st, int T,
                     int ns) {
  using A = Arith<CPLX>;
  using V = typename A::T;
  using S = Shape<CPLX>;
  constexpr int C = S::C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* const tile = reinterpret_cast<V*>(smem_raw);
  V* const ks = tile + S::TILE_P;          // [2 buffers][2 entries][NT]
  V* const sec = ks + 4 * NT;              // [ns][SEC]
  V* const car = sec + ns * SEC;           // [ns][2]
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;

  // the sections' constants and powers, thread k for section k
  for (int k = tid; k < ns; k += NT) {
    const V b0 = bg[3 * k], b1 = bg[3 * k + 1], b2 = bg[3 * k + 2];
    const V a1 = ag[3 * k + 1], a2 = ag[3 * k + 2];
    V* q = sec + k * SEC;
    q[0] = b0;
    q[1] = A::sub(b1, A::mul(a1, b0));
    q[2] = A::sub(b2, A::mul(a2, b0));
    q[3] = A::neg(a1);
    q[4] = A::neg(a2);
    V m00 = A::neg(a1), m01 = A::one(), m10 = A::neg(a2), m11 = A::zero();
#pragma unroll 1
    for (int i = 0; i < S::LOG_C + LOG_NT; ++i) {
      if (i >= S::LOG_C) {
        V* p = q + 5 + 4 * (i - S::LOG_C);
        p[0] = m00;
        p[1] = m01;
        p[2] = m10;
        p[3] = m11;
      }
      const V n00 = A::add(A::mul(m00, m00), A::mul(m01, m10));
      const V n01 = A::add(A::mul(m00, m01), A::mul(m01, m11));
      const V n10 = A::add(A::mul(m10, m00), A::mul(m11, m10));
      const V n11 = A::add(A::mul(m10, m01), A::mul(m11, m11));
      m00 = n00;
      m01 = n01;
      m10 = n10;
      m11 = n11;
    }
    car[2 * k] = st[(row * ns + k) * 2];
    car[2 * k + 1] = st[(row * ns + k) * 2 + 1];
  }

  const V* const xr = x + row * static_cast<size_t>(T);
  V* const yr = y + row * static_cast<size_t>(T);
  const int c0 = tid * C;               // the thread's chunk in a tile
  int ph = 0;                           // the scan's running phase
  V v[C];
#pragma unroll 1
  for (int t0 = 0; t0 < T; t0 += S::TILE) {
    const int n = min(S::TILE, T - t0);   // samples of this tile
    // the last tile's outputs have left the tile, the carries are written
    __syncthreads();
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int g = tid + NT * i;
      if (g < n) tile[padded<CPLX>(g)] = xr[t0 + g];
    }
    __syncthreads();
    const int cnt = max(0, min(C, n - c0));   // samples of the chunk
#pragma unroll
    for (int i = 0; i < C; ++i) v[i] = tile[padded<CPLX>(c0 + i)];
#pragma unroll 1
    for (int k = 0; k < ns; ++k) {
      const V* q = sec + k * SEC;
      const V b0 = q[0], c1 = q[1], c2 = q[2], na1 = q[3], na2 = q[4];
      V cin0 = A::zero(), cin1 = A::zero();
      if (tid == 0) {
        cin0 = car[2 * k];
        cin1 = car[2 * k + 1];
      }
      // 1. the walk, from zero (thread 0 from the carry)
      V e0 = cin0, e1 = cin1;
#pragma unroll
      for (int i = 0; i < C; ++i)
        if (i < cnt) step<CPLX>(e0, e1, v[i], c1, c2, na1, na2);
      // 2. the combine
#pragma unroll 1
      for (int d = 0; d < LOG_NT; ++d) {
        V* buf = ks + (ph & 1) * 2 * NT;
        ++ph;
        buf[tid] = e0;
        buf[NT + tid] = e1;
        __syncthreads();
        const int o = 1 << d;
        if (tid >= o) {
          const V f0 = buf[tid - o], f1 = buf[NT + tid - o];
          const V* p = q + 5 + 4 * d;
          e0 = A::add(A::add(A::mul(p[0], f0), A::mul(p[1], f1)), e0);
          e1 = A::add(A::add(A::mul(p[2], f0), A::mul(p[3], f1)), e1);
        }
      }
      {
        V* buf = ks + (ph & 1) * 2 * NT;
        ++ph;
        buf[tid] = e0;
        buf[NT + tid] = e1;
        __syncthreads();
        if (tid > 0) {
          cin0 = buf[tid - 1];
          cin1 = buf[NT + tid - 1];
        }
      }
      // 3. the re-walk from the chunk's true start, y in place of x
      e0 = cin0;
      e1 = cin1;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        if (i < cnt) {
          const V u = v[i];
          v[i] = A::add(A::mul(b0, u), e0);
          step<CPLX>(e0, e1, u, c1, c2, na1, na2);
        }
      }
      if (cnt > 0 && c0 + cnt == n) {   // the thread with the tile's end
        car[2 * k] = e0;
        car[2 * k + 1] = e1;
      }
    }
    // the outputs through the tile (every read of it lies behind the
    // scan's barriers), then out as whole lines
#pragma unroll
    for (int i = 0; i < C; ++i) tile[padded<CPLX>(c0 + i)] = v[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int g = tid + NT * i;
      if (g < n) yr[t0 + g] = tile[padded<CPLX>(g)];
    }
  }
  __syncthreads();
  for (int k = tid; k < ns; k += NT) {
    st[(row * ns + k) * 2] = car[2 * k];
    st[(row * ns + k) * 2 + 1] = car[2 * k + 1];
  }
}

template <bool CPLX>
int go(const void* x, void* y, const void* b, const void* a, void* s,
       int rows, int T, int ns, cudaStream_t stream) {
  using V = typename Arith<CPLX>::T;
  const size_t bytes = smem_bytes<CPLX>(ns);
  cudaError_t e = cudaFuncSetAttribute(
      iir_pscan_kernel<CPLX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  iir_pscan_kernel<CPLX><<<rows, NT, bytes, stream>>>(
      static_cast<const V*>(x), static_cast<V*>(y),
      static_cast<const V*>(b), static_cast<const V*>(a),
      static_cast<V*>(s), T, ns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: [rows, T]; b, a: [ns, 3] (a[k][0] = 1, not read); s: [rows, ns, 2],
// read as the DF2T states before the first sample and overwritten with
// those after the last.  All float32 (cplx = 0) or all complex64
// (cplx = 1); 1 <= ns <= 64.
extern "C" int iir_pscan_launch(const void* x, void* y, const void* b,
                                const void* a, void* s, int rows, int T,
                                int ns, int cplx, void* stream) {
  if (rows < 1 || T < 1 || ns < 1 || ns > MAX_NS)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return cplx ? go<true>(x, y, b, a, s, rows, T, ns, st)
              : go<false>(x, y, b, a, s, rows, T, ns, st);
}
