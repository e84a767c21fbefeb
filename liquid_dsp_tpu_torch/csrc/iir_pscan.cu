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
// a chunk a thread (lane l of warp w holds chunk j = 32 w + l).  Per tile,
// for each section in turn:
//   1. the walk: thread j runs the map over its chunk from the zero state
//      (thread 0 from the tile's carry), to its end state e_j;
//   2. the combine, in two levels.  In each warp an inclusive scan by
//      shuffles, for d = 0 .. 4, e_l <- P_d e_{l-2^d} + e_l (l >= 2^d),
//      P_d = M^(C 2^d), gives W_l, the end of chunk l from the warp's
//      start taken as zero.  Lane 31's W (the warp's total) goes through
//      shared memory; warp 0 scans the NW totals by shuffles with
//      P_{5+d} = M^(32 C 2^d), which gives G_w, the true end of warp w,
//      and hands G on through shared memory.  Chunk j's true start is
//      W_{l-1} + M^(C l) G_{w-1}: G_{w-1} for lane 0, and in warp 0
//      W_{l-1} (thread 0: the carry);
//   3. the re-walk: thread j runs the map again from that start and
//      leaves y in its registers, the next section's input, which the
//      next section's walk takes in the same pass over the registers.
//      The thread that holds the tile's last sample keeps its end state
//      as the section's carry into the next tile.
// The powers are repeated squares in float32 (Q_0 = M, Q_{i+1} = Q_i Q_i,
// P_d = Q_{log2 C + d}), made once a launch by thread k for section k; the
// lane powers M^(C l), l = 0 .. 31, from them (the lowest set bit's P
// times the higher bits' in turn from the left), by thread (k, l).  Real
// coefficients run on float32 rows (the caller splits a complex stream
// into its planes), complex coefficients on complex64 rows.
//
// Bound on this card: the bytes.  A real row moves 8 bytes a sample (x
// in, y out once: 0.080 ms for 128 rows x 262144 samples at 3.35 TB/s)
// against about 17 float operations a sample and section (7 a step of
// the walk, 9 of the re-walk, the combines' share): 0.035 ms at 4
// sections at the float32 rate.  The first form of this kernel reached
// 23% of the bytes' bound, held by each row's depth: a 1024-wide
// Kogge-Stone through shared memory with 11 barriers a section and tile,
// the tiles' loads and stores beside no work, a branch a step in the
// re-walk.  The design:
//
// * One block of NT = 256 threads a row, a chunk of C = 64 real or 32
//   complex samples a thread in registers (224 and 255 registers, no
//   spill), so 128 plane rows take 128 of the 132 SMs.  Against 512
//   threads of 32 samples it halves the warps at each barrier and takes
//   one level fewer over their totals, for the same issue; it measured
//   7-12% faster (PERF.md), and 1024 threads slower still.  Fewer threads
//   would not hold their chunk in registers.  A row in several blocks
//   would need a decoupled look-back of the cascade's state (later work).
// * A ring of two 64 KB tiles in shared memory, one barrier a tile.  Right
//   after it, tile t's chunks are read, tile t - 1's outputs leave the
//   other buffer as coalesced 16-byte stores, and tile t + 1 is copied
//   into that buffer by 16-byte cp.async (4-byte copies where a row is not
//   16-byte aligned), all before tile t's walks, so stores and copies run
//   beside its work.  No second barrier is needed: a thread copies into
//   exactly the units its own stores read, after the stores have taken
//   their values.  A third buffer would not fit: with the lane powers and
//   constants of 64 sections it takes 235 KB real and 277 KB complex, of
//   227.  cp.async and not TMA: no tensor map a launch, and the same code
//   for any T.  The layout is a swizzle of 16-byte units, unit f at
//   f ^ ((f / UPT) & 7), UPT = 16 the units of a chunk: a quarter warp's
//   coalesced copies and stores (unit f = tid + NT k) and its chunk reads
//   (units UPT tid .. UPT tid + UPT - 1, LDS.128) each fall on 8 distinct
//   16-byte bank groups, with no pad.
// * The combine by shuffles: 5 steps in the warp, one exchange of the
//   totals through shared memory (its buffer alternates between sections,
//   so no section writes the one the last still reads), 3 steps over them
//   in warp 0, G back through shared memory: two barriers a section and
//   tile.  Then the lane's power from a table in shared memory.
// * Walks without branches: a full tile takes an unpredicated path, only
//   a ragged last tile the predicated one (selects, no branch).  Section
//   k's re-walk and section k + 1's walk run in one pass, two independent
//   chains a step.
// * Every a*b + c is one fused multiply-add: a step s0' = fma(-a1, s0,
//   fma(c1, x, s1)), s1' = fma(-a2, s0, c2 x), y = fma(b0, x, s0); 4 and 5
//   instructions for real rows where separate roundings took 7 and 9.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_kernel_bench.py
// --pscan, this kernel and its first form in one call; PERF.md): 0.1195-0.1201
// ms at 128 plane rows x 262144 with butter 7's 4 sections, 67% of the
// bytes' bound (the first form 0.3472-0.3486 in the same call), a lone
// row 0.1091-0.1098 ms, so each row's depth still sets the time; 8
// sections 0.1884-0.1890 ms; 3 complex sections on 64 complex rows
// 0.2724-0.2744 ms.
//
// Numerics: every operation is written out (__fmaf_rn, __fmul_rn), so
// nvcc contracts nothing more, and the plain PyTorch version
// (ops/kernels/iir_pscan.py, iir_pscan_reference), which takes the same
// operations in the same order with the same chunk, tile and combine
// order (fma32 for the fused ones), agrees with it bit for bit.  A complex
// a*b + c is (fma(ar, br, fma(-ai, bi, cr)), fma(ar, bi, fma(ai, br, ci))),
// a complex a*b (fma(ar, br, -(ai bi)), fma(ar, bi, ai br)); a matrix
// applied, P f + e, is fma(P[i][0], f0, fma(P[i][1], f1, e_i)); a matrix
// product's entry fma(A[i][0], B[0][j], A[i][1] B[1][j]).
//
// Built by liquid_dsp_tpu_torch/ops/kernels/build.py with nvcc for sm_90a,
// bound with ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int log2i(int n) { return n > 1 ? 1 + log2i(n / 2) : 0; }

constexpr int NT = 256;           // threads a block: the chunks of a tile
constexpr int WL = 32;            // lanes a warp
constexpr int NW = NT / WL;       // warps a block: warp 0 scans their totals
constexpr int LOG_WL = 5;
constexpr int LOG_NW = log2i(NW);
static_assert(NW <= WL && (NT & (NT - 1)) == 0, "warp 0 scans the totals");
constexpr int MAX_NS = 64;        // sections in one launch
constexpr int UNITS = 4096;       // 16-byte units of a tile: 64 KB
constexpr int UPT = UNITS / NT;   // 16-byte units of a thread's chunk
constexpr int LOG_UPT = log2i(UPT);
static_assert(UPT >= 8, "a chunk of at least one 128-byte line");
// a section's constants in shared memory: b0, c1, c2, -a1, -a2, three
// pads, then P_d (4 entries, row-major) for d = 0 .. LOG_WL + LOG_NW - 1
constexpr int SEC = 8 + 4 * (LOG_WL + LOG_NW);
constexpr unsigned FULL_MASK = 0xffffffffu;

template <bool CPLX>
struct Arith;

template <>
struct Arith<false> {
  using T = float;
  static constexpr int H = 1;   // float4s of a 2x2 matrix
  static __device__ __forceinline__ T madd(T a, T b, T c) {
    return __fmaf_rn(a, b, c);
  }
  static __device__ __forceinline__ T mul(T a, T b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ T neg(T a) { return -a; }
  static __device__ __forceinline__ T one() { return 1.f; }
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T shfl_up(T a, int o) {
    return __shfl_up_sync(FULL_MASK, a, o);
  }
};

template <>
struct Arith<true> {
  using T = float2;
  static constexpr int H = 2;
  static __device__ __forceinline__ T madd(T a, T b, T c) {
    return make_float2(__fmaf_rn(a.x, b.x, __fmaf_rn(-a.y, b.y, c.x)),
                       __fmaf_rn(a.x, b.y, __fmaf_rn(a.y, b.x, c.y)));
  }
  static __device__ __forceinline__ T mul(T a, T b) {
    return make_float2(__fmaf_rn(a.x, b.x, -__fmul_rn(a.y, b.y)),
                       __fmaf_rn(a.x, b.y, __fmul_rn(a.y, b.x)));
  }
  static __device__ __forceinline__ T neg(T a) {
    return make_float2(-a.x, -a.y);
  }
  static __device__ __forceinline__ T one() { return make_float2(1.f, 0.f); }
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ T shfl_up(T a, int o) {
    return make_float2(__shfl_up_sync(FULL_MASK, a.x, o),
                       __shfl_up_sync(FULL_MASK, a.y, o));
  }
};

template <bool CPLX>
struct Shape {
  static constexpr int C = 4 * UPT / (CPLX ? 2 : 1);   // samples a chunk
  static constexpr int LOG_C = log2i(C);
  static constexpr int TILE = NT * C;       // samples a tile
  static constexpr int FPS = CPLX ? 2 : 1;  // floats a sample
};

// The tile's layout: 16-byte unit f at f ^ ((f / UPT) & 7), a permutation
// inside each 128-byte line.
__device__ __forceinline__ int swz(int f) { return f ^ ((f >> LOG_UPT) & 7); }

template <bool CPLX>
struct Mat {
  using V = typename Arith<CPLX>::T;
  V a, b, c, d;   // [[a, b], [c, d]]
};

template <bool CPLX>
__device__ __forceinline__ Mat<CPLX> load_mat(
    const typename Arith<CPLX>::T* p) {
  if constexpr (CPLX) {
    const float4 u = reinterpret_cast<const float4*>(p)[0];
    const float4 v = reinterpret_cast<const float4*>(p)[1];
    return {make_float2(u.x, u.y), make_float2(u.z, u.w),
            make_float2(v.x, v.y), make_float2(v.z, v.w)};
  } else {
    const float4 u = *reinterpret_cast<const float4*>(p);
    return {u.x, u.y, u.z, u.w};
  }
}

template <bool CPLX>
__device__ __forceinline__ void store_mat(typename Arith<CPLX>::T* p,
                                          const Mat<CPLX>& m) {
  p[0] = m.a;
  p[1] = m.b;
  p[2] = m.c;
  p[3] = m.d;
}

// The lane power table: [ns][H][WL] float4, so that a warp's 32 lanes read
// 32 neighbouring float4s.
template <bool CPLX>
__device__ __forceinline__ Mat<CPLX> load_lane_pw(const float4* t, int l) {
  const float4 u = t[l];
  if constexpr (CPLX) {
    const float4 v = t[WL + l];
    return {make_float2(u.x, u.y), make_float2(u.z, u.w),
            make_float2(v.x, v.y), make_float2(v.z, v.w)};
  } else {
    return {u.x, u.y, u.z, u.w};
  }
}

template <bool CPLX>
__device__ __forceinline__ void store_lane_pw(float4* t, int l,
                                              const Mat<CPLX>& m) {
  if constexpr (CPLX) {
    t[l] = make_float4(m.a.x, m.a.y, m.b.x, m.b.y);
    t[WL + l] = make_float4(m.c.x, m.c.y, m.d.x, m.d.y);
  } else {
    t[l] = make_float4(m.a, m.b, m.c, m.d);
  }
}

// A B, each entry fma(A[i][0], B[0][j], A[i][1] B[1][j]).
template <bool CPLX>
__device__ __forceinline__ Mat<CPLX> matmul(const Mat<CPLX>& A,
                                            const Mat<CPLX>& B) {
  using R = Arith<CPLX>;
  return {R::madd(A.a, B.a, R::mul(A.b, B.c)),
          R::madd(A.a, B.b, R::mul(A.b, B.d)),
          R::madd(A.c, B.a, R::mul(A.d, B.c)),
          R::madd(A.c, B.b, R::mul(A.d, B.d))};
}

// (n0, n1) = P (f0, f1) + (e0, e1).
template <bool CPLX>
__device__ __forceinline__ void apply(const Mat<CPLX>& P,
                                      typename Arith<CPLX>::T f0,
                                      typename Arith<CPLX>::T f1,
                                      typename Arith<CPLX>::T e0,
                                      typename Arith<CPLX>::T e1,
                                      typename Arith<CPLX>::T& n0,
                                      typename Arith<CPLX>::T& n1) {
  using R = Arith<CPLX>;
  n0 = R::madd(P.a, f0, R::madd(P.b, f1, e0));
  n1 = R::madd(P.c, f0, R::madd(P.d, f1, e1));
}

// A section's coefficients as its steps take them.
template <bool CPLX>
struct Sec {
  using V = typename Arith<CPLX>::T;
  V b0, c1, c2, na1, na2;
};

template <bool CPLX>
__device__ __forceinline__ Sec<CPLX> load_sec(
    const typename Arith<CPLX>::T* q) {
  return {q[0], q[1], q[2], q[3], q[4]};
}

// One step of the map on (e0, e1) with input u:
// s0' = fma(-a1, s0, fma(c1, u, s1)), s1' = fma(-a2, s0, c2 u).
template <bool CPLX>
__device__ __forceinline__ void step(typename Arith<CPLX>::T& e0,
                                     typename Arith<CPLX>::T& e1,
                                     typename Arith<CPLX>::T u,
                                     const Sec<CPLX>& K) {
  using R = Arith<CPLX>;
  const auto t = R::madd(K.c1, u, e1);
  const auto n1 = R::madd(K.na2, e0, R::mul(K.c2, u));
  e0 = R::madd(K.na1, e0, t);
  e1 = n1;
}

template <bool CPLX>
__device__ __forceinline__ typename Arith<CPLX>::T pick(
    bool p, typename Arith<CPLX>::T a, typename Arith<CPLX>::T b) {
  if constexpr (CPLX) {
    return make_float2(p ? a.x : b.x, p ? a.y : b.y);
  } else {
    return p ? a : b;
  }
}

// Tile copies: floats [0, nf) of src into the ring's tile at their
// swizzled units, by 16-byte cp.async where the row allows (vec), else
// float by float; one commit group.
__device__ __forceinline__ void tile_load(float4* tile, const float* src,
                                          int nf, bool vec, int tid) {
  if (vec && nf == 4 * UNITS) {
#pragma unroll
    for (int k = 0; k < UPT; ++k) {
      const int f = tid + NT * k;
      cp_async_16(tile + swz(f), src + 4 * f);
    }
  } else if (vec) {
#pragma unroll
    for (int k = 0; k < UPT; ++k) {
      const int f = tid + NT * k;
      if (4 * f < nf) cp_async_16(tile + swz(f), src + 4 * f);
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < 4 * UPT; ++k) {
      const int g = tid + NT * k;
      if (g < nf)
        cp_async_f32(reinterpret_cast<float*>(tile + swz(g >> 2)) + (g & 3),
                     src + g);
    }
  }
  cp_async_commit();
}

// The outputs out of the tile, coalesced: floats [0, nf) to dst; a whole
// tile's reads all issued before its stores.
__device__ __forceinline__ void tile_store(float* dst, const float4* tile,
                                           int nf, bool vec, int tid) {
  if (vec && nf == 4 * UNITS) {
    float4 u[UPT];
#pragma unroll
    for (int k = 0; k < UPT; ++k) u[k] = tile[swz(tid + NT * k)];
#pragma unroll
    for (int k = 0; k < UPT; ++k)
      reinterpret_cast<float4*>(dst)[tid + NT * k] = u[k];
  } else if (vec) {
#pragma unroll
    for (int k = 0; k < UPT; ++k) {
      const int f = tid + NT * k;
      if (4 * f < nf) reinterpret_cast<float4*>(dst)[f] = tile[swz(f)];
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < 4 * UPT; ++k) {
      const int g = tid + NT * k;
      if (g < nf)
        dst[g] = reinterpret_cast<const float*>(tile + swz(g >> 2))[g & 3];
    }
  }
}

// The thread's chunk between the tile and registers: units UPT tid ..
// UPT tid + UPT - 1.
template <bool CPLX>
__device__ __forceinline__ void chunk_in(
    typename Arith<CPLX>::T (&v)[Shape<CPLX>::C], const float4* tile, int tid) {
#pragma unroll
  for (int q = 0; q < UPT; ++q) {
    const float4 u = tile[swz(UPT * tid + q)];
    if constexpr (CPLX) {
      v[2 * q] = make_float2(u.x, u.y);
      v[2 * q + 1] = make_float2(u.z, u.w);
    } else {
      v[4 * q] = u.x;
      v[4 * q + 1] = u.y;
      v[4 * q + 2] = u.z;
      v[4 * q + 3] = u.w;
    }
  }
}

template <bool CPLX>
__device__ __forceinline__ void chunk_out(
    const typename Arith<CPLX>::T (&v)[Shape<CPLX>::C], float4* tile, int tid) {
#pragma unroll
  for (int q = 0; q < UPT; ++q) {
    float4 u;
    if constexpr (CPLX) {
      u = make_float4(v[2 * q].x, v[2 * q].y, v[2 * q + 1].x, v[2 * q + 1].y);
    } else {
      u = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
    tile[swz(UPT * tid + q)] = u;
  }
}

// The combine of section q's walk end states (e0, e1) into the chunk's
// true start (s0, s1); (cin0, cin1) is the tile's carry on thread 0.
template <bool CPLX>
__device__ __forceinline__ void combine(
    typename Arith<CPLX>::T e0, typename Arith<CPLX>::T e1,
    typename Arith<CPLX>::T cin0, typename Arith<CPLX>::T cin1,
    const typename Arith<CPLX>::T* q, const float4* lane_pw,
    typename Arith<CPLX>::T* tot, int& ph, int lane, int w,
    typename Arith<CPLX>::T& s0, typename Arith<CPLX>::T& s1) {
  using R = Arith<CPLX>;
  using V = typename R::T;
  // 1. in the warp, by shuffles: W_l
#pragma unroll
  for (int d = 0; d < LOG_WL; ++d) {
    const int o = 1 << d;
    const Mat<CPLX> P = load_mat<CPLX>(q + 8 + 4 * d);
    V n0, n1;
    apply<CPLX>(P, R::shfl_up(e0, o), R::shfl_up(e1, o), e0, e1, n0, n1);
    e0 = pick<CPLX>(lane >= o, n0, e0);
    e1 = pick<CPLX>(lane >= o, n1, e1);
  }
  // 2. the warps' totals through shared memory, their scan by shuffles in
  // warp 0 (G_l), and G handed on through shared memory
  V* const tb = tot + (ph & 1) * 2 * NW;
  ++ph;
  if (lane == WL - 1) {
    tb[w] = e0;
    tb[NW + w] = e1;
  }
  __syncthreads();
  V g0 = R::zero(), g1 = R::zero();
  if (w == 0) {
    if (lane < NW) {
      g0 = tb[lane];
      g1 = tb[NW + lane];
    }
#pragma unroll
    for (int d = 0; d < LOG_NW; ++d) {
      const int o = 1 << d;
      const Mat<CPLX> P = load_mat<CPLX>(q + 8 + 4 * (LOG_WL + d));
      V n0, n1;
      apply<CPLX>(P, R::shfl_up(g0, o), R::shfl_up(g1, o), g0, g1, n0, n1);
      g0 = pick<CPLX>(lane >= o, n0, g0);
      g1 = pick<CPLX>(lane >= o, n1, g1);
    }
  }
  V* const gb = tot + 4 * NW;   // [2][NW]: G, from warp 0
  if (w == 0 && lane < NW) {
    gb[lane] = g0;
    gb[NW + lane] = g1;
  }
  __syncthreads();
  // 3. the chunk's start: W_{l-1} + M^(C l) G_{w-1}
  const V p0 = R::shfl_up(e0, 1), p1 = R::shfl_up(e1, 1);
  if (w == 0) {
    s0 = pick<CPLX>(lane == 0, cin0, p0);
    s1 = pick<CPLX>(lane == 0, cin1, p1);
  } else {
    const V h0 = gb[w - 1], h1 = gb[NW + w - 1];
    V m0, m1;
    apply<CPLX>(load_lane_pw<CPLX>(lane_pw, lane), h0, h1, p0, p1, m0, m1);
    s0 = pick<CPLX>(lane == 0, h0, m0);
    s1 = pick<CPLX>(lane == 0, h1, m1);
  }
}

// Every section on the chunk v: a full tile (FULL, every step taken) or a
// ragged one (cnt steps, by selects).  ends: this thread holds the tile's
// last sample, so its re-walk end states are the carries.
template <bool CPLX, bool FULL>
__device__ __forceinline__ void tile_sections(
    typename Arith<CPLX>::T (&v)[Shape<CPLX>::C], int cnt, int ns,
    const typename Arith<CPLX>::T* sec, const float4* lane_pw,
    typename Arith<CPLX>::T* tot, typename Arith<CPLX>::T* car, int& ph,
    bool ends) {
  using R = Arith<CPLX>;
  using V = typename R::T;
  constexpr int C = Shape<CPLX>::C;
  const int tid = threadIdx.x, lane = tid & (WL - 1), w = tid / WL;
  V cin0 = R::zero(), cin1 = R::zero();
  if (tid == 0) {
    cin0 = car[0];
    cin1 = car[1];
  }
  // section 0's walk, from zero (thread 0 from the carry)
  V e0 = cin0, e1 = cin1;
  {
    const Sec<CPLX> K = load_sec<CPLX>(sec);
#pragma unroll
    for (int i = 0; i < C; ++i) {
      V n0 = e0, n1 = e1;
      step<CPLX>(n0, n1, v[i], K);
      e0 = FULL ? n0 : pick<CPLX>(i < cnt, n0, e0);
      e1 = FULL ? n1 : pick<CPLX>(i < cnt, n1, e1);
    }
  }
#pragma unroll 1
  for (int k = 0; k < ns; ++k) {
    const V* const q = sec + k * SEC;
    V s0, s1;
    combine<CPLX>(e0, e1, cin0, cin1, q, lane_pw + k * R::H * WL, tot, ph,
                  lane, w, s0, s1);
    const Sec<CPLX> K = load_sec<CPLX>(q);
    if (k + 1 < ns) {
      // section k's re-walk and section k + 1's walk in one pass
      const Sec<CPLX> Kn = load_sec<CPLX>(q + SEC);
      if (tid == 0) {
        cin0 = car[2 * k + 2];
        cin1 = car[2 * k + 3];
      }
      V f0 = cin0, f1 = cin1;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const V u = v[i];
        const V yv = R::madd(K.b0, u, s0);
        V n0 = s0, n1 = s1, m0 = f0, m1 = f1;
        step<CPLX>(n0, n1, u, K);
        step<CPLX>(m0, m1, yv, Kn);
        if (FULL) {
          s0 = n0;
          s1 = n1;
          f0 = m0;
          f1 = m1;
          v[i] = yv;
        } else {
          const bool p = i < cnt;
          s0 = pick<CPLX>(p, n0, s0);
          s1 = pick<CPLX>(p, n1, s1);
          f0 = pick<CPLX>(p, m0, f0);
          f1 = pick<CPLX>(p, m1, f1);
          v[i] = pick<CPLX>(p, yv, u);
        }
      }
      e0 = f0;
      e1 = f1;
    } else {
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const V u = v[i];
        const V yv = R::madd(K.b0, u, s0);
        V n0 = s0, n1 = s1;
        step<CPLX>(n0, n1, u, K);
        if (FULL) {
          s0 = n0;
          s1 = n1;
          v[i] = yv;
        } else {
          const bool p = i < cnt;
          s0 = pick<CPLX>(p, n0, s0);
          s1 = pick<CPLX>(p, n1, s1);
          v[i] = pick<CPLX>(p, yv, u);
        }
      }
    }
    if (ends) {
      car[2 * k] = s0;
      car[2 * k + 1] = s1;
    }
  }
}

// Shared memory, in bytes: the ring of two tiles, the lane powers, the
// sections' constants, the totals' two buffers, the carries.
template <bool CPLX>
size_t smem_bytes(int ns) {
  using V = typename Arith<CPLX>::T;
  return sizeof(float4) * (2 * static_cast<size_t>(UNITS) +
                           static_cast<size_t>(ns) * Arith<CPLX>::H * WL) +
         sizeof(V) * (static_cast<size_t>(ns) * (SEC + 2) + 6 * NW);
}

template <bool CPLX>
__global__ void __launch_bounds__(NT, 1)
    iir_pscan_kernel(const typename Arith<CPLX>::T* __restrict__ x,
                     typename Arith<CPLX>::T* __restrict__ y,
                     const typename Arith<CPLX>::T* __restrict__ bg,
                     const typename Arith<CPLX>::T* __restrict__ ag,
                     typename Arith<CPLX>::T* __restrict__ st, int T, int ns,
                     int vec_rows) {
  using R = Arith<CPLX>;
  using V = typename R::T;
  using S = Shape<CPLX>;
  constexpr int C = S::C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* const ring = reinterpret_cast<float4*>(smem_raw);   // [2][UNITS]
  float4* const lane_pw = ring + 2 * UNITS;                   // [ns][H][WL]
  V* const sec = reinterpret_cast<V*>(lane_pw + ns * R::H * WL);  // [ns][SEC]
  V* const car = sec + ns * SEC;                              // [ns][2]
  V* const tot = car + 2 * ns;            // [2][2][NW] totals, [2][NW] G
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const bool vec = vec_rows != 0;
  const float* const xr =
      reinterpret_cast<const float*>(x) + row * T * S::FPS;
  float* const yr = reinterpret_cast<float*>(y) + row * T * S::FPS;

  // tile 0's copies first: they land while the constants are made
  tile_load(ring, xr, min(S::TILE, T) * S::FPS, vec, tid);

  // the sections' constants and squared powers, thread k for section k
  for (int k = tid; k < ns; k += NT) {
    const V b0 = bg[3 * k], b1 = bg[3 * k + 1], b2 = bg[3 * k + 2];
    const V na1 = R::neg(ag[3 * k + 1]), na2 = R::neg(ag[3 * k + 2]);
    V* const q = sec + k * SEC;
    q[0] = b0;
    q[1] = R::madd(na1, b0, b1);
    q[2] = R::madd(na2, b0, b2);
    q[3] = na1;
    q[4] = na2;
    q[5] = q[6] = q[7] = R::zero();
    constexpr int NSQ = S::LOG_C + LOG_WL + LOG_NW;
    Mat<CPLX> m{na1, R::one(), na2, R::zero()};
#pragma unroll 1
    for (int i = 0; i < NSQ; ++i) {
      if (i >= S::LOG_C) store_mat<CPLX>(q + 8 + 4 * (i - S::LOG_C), m);
      if (i + 1 < NSQ) m = matmul<CPLX>(m, m);
    }
    car[2 * k] = st[(row * ns + k) * 2];
    car[2 * k + 1] = st[(row * ns + k) * 2 + 1];
  }
  __syncthreads();
  // the lane powers M^(C l): P of l's lowest set bit, then times P of
  // each higher set bit in turn, from the left
  for (int it = tid; it < ns * WL; it += NT) {
    const int k = it / WL, l = it % WL;
    const V* const q = sec + k * SEC;
    Mat<CPLX> m{R::one(), R::zero(), R::zero(), R::one()};
    if (l != 0) {
      int b = __ffs(l) - 1;
      m = load_mat<CPLX>(q + 8 + 4 * b);
#pragma unroll 1
      for (++b; b < LOG_WL; ++b)
        if ((l >> b) & 1) m = matmul<CPLX>(load_mat<CPLX>(q + 8 + 4 * b), m);
    }
    store_lane_pw<CPLX>(lane_pw + k * R::H * WL, l, m);
  }

  int ph = 0;   // the totals' buffer, alternating by section
  V v[C];
  const int nt = (T + S::TILE - 1) / S::TILE;   // tiles
#pragma unroll 1
  for (int t = 0; t < nt; ++t) {
    const int t0 = t * S::TILE;
    const int n = min(S::TILE, T - t0);   // samples of this tile
    float4* const cur = ring + (t & 1) * UNITS;
    float4* const other = ring + ((t + 1) & 1) * UNITS;
    // tile t has landed; tile t - 1's outputs are in place in the other
    // buffer; the constants, lane powers and carries are written
    cp_async_wait_all();
    __syncthreads();
    chunk_in<CPLX>(v, cur, tid);
    // tile t - 1's outputs leave (a whole tile: only the last is ragged),
    // then tile t + 1 is copied into the buffer they leave, beside this
    // tile's work: a thread copies into the units its own stores read, so
    // no barrier comes between
    if (t > 0)
      tile_store(yr + static_cast<size_t>(t0 - S::TILE) * S::FPS, other,
                 S::TILE * S::FPS, vec, tid);
    if (t0 + S::TILE < T)
      tile_load(other, xr + static_cast<size_t>(t0 + S::TILE) * S::FPS,
                min(S::TILE, T - t0 - S::TILE) * S::FPS, vec, tid);
    if (n == S::TILE) {
      tile_sections<CPLX, true>(v, C, ns, sec, lane_pw, tot, car, ph,
                                tid == NT - 1);
    } else {
      const int c0 = tid * C, cnt = max(0, min(C, n - c0));
      tile_sections<CPLX, false>(v, cnt, ns, sec, lane_pw, tot, car, ph,
                                 cnt > 0 && c0 + cnt == n);
    }
    chunk_out<CPLX>(v, cur, tid);
  }
  __syncthreads();   // the last tile's outputs and the carries are in place
  const int tl0 = (nt - 1) * S::TILE;
  tile_store(yr + static_cast<size_t>(tl0) * S::FPS,
             ring + ((nt - 1) & 1) * UNITS, (T - tl0) * S::FPS, vec, tid);
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
  // 16-byte copies when every row starts on 16 bytes
  const int vec = (reinterpret_cast<size_t>(x) % 16 == 0 &&
                   reinterpret_cast<size_t>(y) % 16 == 0 &&
                   (static_cast<size_t>(T) * sizeof(V)) % 16 == 0);
  iir_pscan_kernel<CPLX><<<rows, NT, bytes, stream>>>(
      static_cast<const V*>(x), static_cast<V*>(y),
      static_cast<const V*>(b), static_cast<const V*>(a),
      static_cast<V*>(s), T, ns, vec);
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
