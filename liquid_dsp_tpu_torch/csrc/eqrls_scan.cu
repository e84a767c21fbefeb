// The RLS equalizer's per-sample recurrence (trained), for Hopper (sm_90a).
//
// Replaces the lax.scan of liquid_dsp_tpu/ops/equalize.py:125-151
// (eqrls_run); the JAX package has no Pallas kernel here, and PyTorch has
// no scan that stays on the device.
//
// What it computes, per channel and sample, with the window of the last L
// inputs oldest first and the L x L matrix P (ops/kernels/eqrls_scan.py
// writes it out):
//   buf <- [buf[1:], x];  y = tree_i conj(w_i) buf_i;  e = d - y;
//   Px_i = live_j P_ij buf_j;  den = lam + tree_i Re(conj(buf_i) Px_i);
//   k_i = Px_i * (1 / den);  w_i <- w_i + k_i conj(e);
//   r_l = live_i conj(buf_i) P_il;  P_il <- (P_il - k_i r_l) * (1/lam)
// tree is the butterfly over LM lanes (the rows padded with zeros), live
// the same levels over the L live entries only (an add whose partner is
// past the end is skipped).  r is the column product buf^H P as written:
// P does not stay exactly Hermitian under this update, so (P buf)^H would
// be another function.  A real stream runs as a complex one with zero
// imaginary parts.
//
// Bound on this card: the instructions a channel's warp issues a sample.
// The bytes are small (x, d in and y out, 24 bytes a complex sample) and
// the float32 work is about 8 L^2 operations a sample, but each sample
// needs the P and w that the last one left, and the work of one sample
// sits on the lanes of one channel: one warp on one of an SM's four
// schedulers.  The chain under it (P -> Px -> den -> 1/den -> k -> P) is
// about 230 cycles; the kernel before this design issued about 1,000
// instructions a step (2,211 cycles at L = 9, 16 column butterflies of
// four shuffle levels each way and a padded row of 16 columns).  What the
// design does:
//
// * The kernel is built for each L (NC = L columns, a compile-time count):
//   every column loop, P's row in registers and the window run over the
//   live columns only, and every sum is a tree unfolded at compile time
//   (no array a sum could leave in local memory).  A channel takes LM
//   rows (8, 16 or 32, the smallest power of two >= L and >= 8) times H
//   halves of lanes: at 2 <= L <= 16, H = 2 and lane (h, i) keeps columns
//   h, h + 2, h + 4, ... of row i, so a warp holds one channel at L = 9
//   and each lane half of the row; Px_i is each half's own live tree and
//   one shuffle (the live tree over all columns equals the even columns'
//   plus the odd ones').  Otherwise H = 1 and a lane keeps the whole row.
// * r goes through shared memory: each lane writes its row's products
//   conj(buf_i) P_il, lane l sums column l in the live tree's order after
//   a __syncwarp and writes r_l, and after a second one each lane reads
//   its columns' r as 16-byte loads.  r needs the old P and the window
//   only, so this work runs beside the Px -> den -> k chain.  The
//   products and r are double-buffered by the step's parity.
// * The window comes from the staged tile in shared memory (LM samples of
//   history, then the tile): a tile of LM * H samples is loaded one
//   sample a lane a tile ahead and staged between two __syncwarps; each
//   step reads its row's entry and its columns' entries and d from there.
// * y and den are butterflies of __shfl_xor_sync over the LM rows, each
//   level rounded once, so every lane holds the same bits.  1/den is
//   __frcp_rn (the correctly rounded 1/x, as __fdiv_rn(1, x)).
// * Each step reads the window and d before r's first __syncwarp (which
//   orders the shared accesses around it), stores r_l from every lane
//   (those past L to a slot no lane reads), and takes the tree's one
//   select as a selp: each store under an `if`, and that ?:, had become a
//   branch that split the step's basic block.  Lane s keeps step s's
//   output for one store a lane a tile; the tile's steps run EQRLS_UNROLL
//   a loop turn (a whole tile outran the instruction cache in the design
//   before).
//
// Measured at L = 9 (chip_kernel_bench.py --eq, H100 at 700 W, parent
// and change in one call): a lone step 483 cycles (2,210-2,214 before),
// 8.07-8.08 ms at 256 x 32768 (36.55-36.56).  The designs it was held
// against, in the calls before: one lane a row (H = 1), 571-594 cycles;
// den's row sum through shared memory, 556-639.
//
// Numerics: every operation is rounded once and written explicitly
// (__fmul_rn, __fadd_rn, __fsub_rn, __frcp_rn), so nvcc contracts
// nothing, and the plain PyTorch version (ops/kernels/eqrls_scan.py,
// eqrls_scan_reference) agrees with it bit for bit.
//
// Built by liquid_dsp_tpu_torch/ops/kernels/build.py with nvcc for sm_90a,
// bound with ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

#ifndef EQRLS_UNROLL
#define EQRLS_UNROLL 4   // steps a loop turn (even)
#endif

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float2 load_sample(const float* p, size_t k,
                                             bool cplx) {
  if (cplx) return reinterpret_cast<const float2*>(p)[k];
  return make_float2(p[k], 0.f);
}

__device__ __forceinline__ void store_sample(float* p, size_t k, bool cplx,
                                             float re, float im) {
  if (cplx)
    reinterpret_cast<float2*>(p)[k] = make_float2(re, im);
  else
    p[k] = re;
}

__host__ __device__ constexpr int pow2_ge(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// the rows a channel takes: a power of two >= L and >= 8
__host__ __device__ constexpr int rows_of(int nc) {
  return pow2_ge(nc) < 8 ? 8 : pow2_ge(nc);
}

template <int V>
struct Idx {
  static constexpr int value = V;
};

__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

// p ? a : b kept a select: with ?: the compiler may branch around the
// operand it can skip, and a branch splits the step's basic block
__device__ __forceinline__ float vsel(bool p, float a, float b) {
  float r;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %3, 0;\n\t"
      "selp.f32 %0, %1, %2, q;\n\t}"
      : "=f"(r)
      : "f"(a), "f"(b), "r"(static_cast<unsigned>(p)));
  return r;
}

__device__ __forceinline__ float2 vsel(bool p, float2 a, float2 b) {
  return make_float2(vsel(p, a.x, b.x), vsel(p, a.y, b.y));
}

// entry J of the live tree over N entries after its levels from the first
// down to O: at level o (halving from pow2_ge(N) / 2) entry j takes
// v[j] + v[j + o] while j + o is live (below min(N, 2o)).  get(Idx<j>)
// is entry j before the first level; with `dead`, entry N-1 holds no
// value and its one add is skipped.  The tree unfolds at compile time
// into straight-line code: no array and no loop, so nothing of it can be
// left in local memory.
template <int N, int J = 0, int O = 1, class Get>
__device__ __forceinline__ float2 live_tree(const Get& get, bool dead) {
  if constexpr (2 * O > pow2_ge(N)) {
    return get(Idx<J>{});
  } else {
    constexpr int live = N < 2 * O ? N : 2 * O;
    const float2 a = live_tree<N, J, 2 * O>(get, dead);
    if constexpr (J + O < live) {
      const float2 b = live_tree<N, J + O, 2 * O>(get, dead);
      if constexpr (J + O == N - 1)
        return vsel(dead, a, add2(a, b));
      else
        return add2(a, b);
    } else {
      return a;
    }
  }
}

// the butterfly sum over a channel's LM row lanes (width CW)
template <int LM, int CW>
__device__ __forceinline__ float rows_sum(float v) {
#pragma unroll
  for (int o = LM / 2; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(FULL, v, o, CW));
  return v;
}

template <int NC, int H>
__global__ void __launch_bounds__(32)
eqrls_scan_kernel(const float* __restrict__ x, const float* __restrict__ d,
                  float* __restrict__ y, float* __restrict__ w_io,
                  float* __restrict__ buf_io, float* __restrict__ p_io,
                  int B, int T, bool cplx, float lam, float inv_lam) {
  constexpr int LM = rows_of(NC);      // rows a channel
  constexpr int CW = LM * H;           // lanes a channel, samples a tile
  constexpr int G = 32 / CW;           // channels a warp
  constexpr int CH = (NC + H - 1) / H; // column slots a lane
  constexpr int CHP = CH + (CH & 1);   // r's slots a half, even: 16-byte reads
  constexpr int PITCH = NC | 1;        // a row of products, odd: no conflicts
  constexpr int XW = LM + CW + 2;      // history, tile, the dead slot's read
  constexpr int RS = H * CHP + 2;      // r a parity, and a slot for the rest
  constexpr int UNROLL = EQRLS_UNROLL;
  static_assert(UNROLL % 2 == 0, "steps a loop turn come in pairs");
  __shared__ __align__(16) float2 xs[G][XW];
  __shared__ float2 ds[G][CW];
  __shared__ float2 ps[G][2][LM * PITCH];
  __shared__ __align__(16) float2 rs[G][2][RS];

  const int lane = threadIdx.x;
  const int c = lane % CW;             // lane in the channel: tile sample c
  const int g = lane / CW;
  const int i = c % LM;                // row of P, tap of w and the window
  const int h = c / LM;                // columns h, h + H, h + 2H, ...
  const int ch = blockIdx.x * G + g;
  const bool live = ch < B;
  const bool row = i < NC;
  const bool dead = H == 2 && (NC & 1) && h == 1;   // slot CH-1: no column

  const size_t tap = static_cast<size_t>(ch) * NC + i;
  float wr = 0.f, wi = 0.f;
  if (live && row) {
    const float2 v = load_sample(w_io, tap, cplx);
    wr = v.x;
    wi = v.y;
  }
  float pr[CH], pi[CH];                // row i of P, columns h + H a
#pragma unroll
  for (int a = 0; a < CH; ++a) {
    const int col = h + H * a;
    const float2 v = live && row && col < NC
                         ? load_sample(p_io, tap * NC + col, cplx)
                         : make_float2(0.f, 0.f);
    pr[a] = v.x;
    pi[a] = v.y;
  }
  // shared memory starts at zero; the history is the carried window
  // (entry j is sample j - L, at xs[LM - L + j])
  for (int k = c; k < XW; k += CW) xs[g][k] = make_float2(0.f, 0.f);
  for (int k = c; k < 2 * RS; k += CW)
    rs[g][k / RS][k % RS] = make_float2(0.f, 0.f);
  __syncwarp();
  if (live && c < NC)
    xs[g][LM - NC + c] =
        load_sample(buf_io, static_cast<size_t>(ch) * NC + c, cplx);
  const size_t rowT = static_cast<size_t>(ch) * T;

  auto load_tile = [&](int t0, float2& xv, float2& dv) {
    const int t = t0 + c;
    const bool in = live && t < T;
    xv = in ? load_sample(x, rowT + t, cplx) : make_float2(0.f, 0.f);
    dv = in ? load_sample(d, rowT + t, cplx) : make_float2(0.f, 0.f);
  };
  // a tile into shared memory; the last LM samples of the one before
  // become the history
  auto stage = [&](bool first, float2 xprev, float2 xv, float2 dv) {
    __syncwarp();
    if (!first && c >= CW - LM) xs[g][c - (CW - LM)] = xprev;
    xs[g][LM + c] = xv;
    ds[g][c] = dv;
    __syncwarp();
  };

  // per lane, where each step reads and writes (step s, parity b):
  // window entry j at win[s + j]; its row's products at prow[b * PS + H a]
  // for column h + H a; column l's products at col[b * PS + k PITCH];
  // r_l (lane l < L; the others write a slot no lane reads) at
  // rw[b * RS]; its columns' r from rr0[b * RS + a]
  constexpr int PS = LM * PITCH;
  const float2* win = &xs[g][LM - NC + 1];
  float2* prow = &ps[g][0][i * PITCH + h];
  const float2* col = &ps[g][0][c < NC ? c : NC - 1];
  float2* rw = &rs[g][0][c < NC ? (c % H) * CHP + c / H : H * CHP];
  const float2* rr0 = &rs[g][0][h * CHP];
  float br = 0.f, bi = 0.f, yr_keep = 0.f, yi_keep = 0.f;
  // step s of a tile; b, the parity of s, picks the double buffers (a
  // constant where the tile's loop calls it)
  auto step = [&](int s, int b) {
    // every read of the window and of d comes first: a __syncwarp orders
    // the shared-memory accesses around it, and these must not wait for
    // r's two round trips
    const float2 bo = win[s + (row ? i : NC - 1)];
    br = row ? bo.x : 0.f;
    bi = row ? bo.y : 0.f;
    const float2 dd = ds[g][s];
    float2 wv[CH];
#pragma unroll
    for (int a = 0; a < CH; ++a) wv[a] = win[s + h + H * a];
    // Px_i = live_j P_ij buf_j: this half's columns, then the other's
    float2 px = live_tree<CH>(
        [&](auto k) {
          constexpr int a = decltype(k)::value;
          return make_float2(
              __fsub_rn(__fmul_rn(pr[a], wv[a].x), __fmul_rn(pi[a], wv[a].y)),
              __fadd_rn(__fmul_rn(pr[a], wv[a].y), __fmul_rn(pi[a], wv[a].x)));
        },
        dead);
    if (H == 2) {
      px.x = __fadd_rn(px.x, __shfl_xor_sync(FULL, px.x, LM, CW));
      px.y = __fadd_rn(px.y, __shfl_xor_sync(FULL, px.y, LM, CW));
    }
    const float pxr = px.x, pxi = px.y;
    // den's row sum (the chain), then r beside it
    const float q = rows_sum<LM, CW>(
        __fadd_rn(__fmul_rn(br, pxr), __fmul_rn(bi, pxi)));
    // r_l = live_i conj(buf_i) P_il: this row's products, then lane l
    // sums column l, then each lane reads its columns' r
#pragma unroll
    for (int a = 0; a < CH; ++a)
      if (!(dead && a == CH - 1))
        prow[b * PS + H * a] = make_float2(
            __fadd_rn(__fmul_rn(br, pr[a]), __fmul_rn(bi, pi[a])),
            __fsub_rn(__fmul_rn(br, pi[a]), __fmul_rn(bi, pr[a])));
    __syncwarp();
    rw[b * RS] = live_tree<NC>(
        [&](auto k) { return col[b * PS + decltype(k)::value * PITCH]; },
        false);
    __syncwarp();
    float rr[CHP], ri[CHP];
#pragma unroll
    for (int a = 0; a < CHP; a += 2) {
      const float4 v = *reinterpret_cast<const float4*>(&rr0[b * RS + a]);
      rr[a] = v.x;
      ri[a] = v.y;
      rr[a + 1] = v.z;
      ri[a + 1] = v.w;
    }
    // y and e with the old weights
    const float yr = rows_sum<LM, CW>(
        __fadd_rn(__fmul_rn(wr, br), __fmul_rn(wi, bi)));
    const float yi = rows_sum<LM, CW>(
        __fsub_rn(__fmul_rn(wr, bi), __fmul_rn(wi, br)));
    const float er = __fsub_rn(dd.x, yr), ei = __fsub_rn(dd.y, yi);
    // the gain k_i = Px_i / (lam + Re(buf^H Px))
    const float rden = __frcp_rn(__fadd_rn(q, lam));
    const float kr = __fmul_rn(pxr, rden), ki = __fmul_rn(pxi, rden);
    wr = __fadd_rn(wr, __fadd_rn(__fmul_rn(kr, er), __fmul_rn(ki, ei)));
    wi = __fadd_rn(wi, __fsub_rn(__fmul_rn(ki, er), __fmul_rn(kr, ei)));
    // this lane's columns of row i of (P - k r) / lam
#pragma unroll
    for (int a = 0; a < CH; ++a) {
      pr[a] = __fmul_rn(
          __fsub_rn(pr[a], __fsub_rn(__fmul_rn(kr, rr[a]), __fmul_rn(ki, ri[a]))),
          inv_lam);
      pi[a] = __fmul_rn(
          __fsub_rn(pi[a], __fadd_rn(__fmul_rn(kr, ri[a]), __fmul_rn(ki, rr[a]))),
          inv_lam);
    }
    if (c == s) {
      yr_keep = yr;
      yi_keep = yi;
    }
  };

  float2 xv, dv, xn, dn, xprev = make_float2(0.f, 0.f);
  load_tile(0, xv, dv);
  const int full = T / CW * CW;
  for (int t0 = 0; t0 < full; t0 += CW) {
    load_tile(t0 + CW, xn, dn);
    stage(t0 == 0, xprev, xv, dv);
#pragma unroll (UNROLL / 2)
    for (int s = 0; s < CW; s += 2) {
      step(s, 0);
      step(s + 1, 1);
    }
    if (live) store_sample(y, rowT + t0 + c, cplx, yr_keep, yi_keep);
    xprev = xv;
    xv = xn;
    dv = dn;
  }
  const int rem = T - full;
  if (rem > 0) {
    stage(full == 0, xprev, xv, dv);
#pragma unroll 1
    for (int s = 0; s < rem; ++s) step(s, s & 1);
    if (live && c < rem)
      store_sample(y, rowT + full + c, cplx, yr_keep, yi_keep);
  }

  if (live && row) {
    if (h == 0) {
      store_sample(w_io, tap, cplx, wr, wi);
      store_sample(buf_io, tap, cplx, br, bi);
    }
#pragma unroll
    for (int a = 0; a < CH; ++a) {
      const int col = h + H * a;
      if (col < NC) store_sample(p_io, tap * NC + col, cplx, pr[a], pi[a]);
    }
  }
}

#define EQRLS_PARAMS                                                      \
  const float *x, const float *d, float *y, float *w, float *buf,         \
      float *p, int B, int T, bool cplx, float lam, float inv_lam,        \
      cudaStream_t st

// the instance for L = NC: two lanes a row at 2 <= L <= 16, else one
template <int NC>
void launch_nc(int L, EQRLS_PARAMS) {
  if (L != NC) {
    if constexpr (NC < 32) launch_nc<NC + 1>(L, x, d, y, w, buf, p, B, T,
                                             cplx, lam, inv_lam, st);
    return;
  }
  constexpr int H = NC >= 2 && NC <= 16 ? 2 : 1;
  constexpr int G = 32 / (rows_of(NC) * H);
  eqrls_scan_kernel<NC, H><<<(B + G - 1) / G, 32, 0, st>>>(
      x, d, y, w, buf, p, B, T, cplx, lam, inv_lam);
}

}  // namespace

// x, d, y: [B, T] rows, complex64 (interleaved floats) if cplx else
// float32.  State, read and overwritten in place: w, buf [B, L] and P
// [B, L, L] of the same type; 1 <= L <= 32.  lam and inv_lam: the
// forgetting factor and its float32 reciprocal.  Returns the cudaError_t
// of the launch (0 on success).
extern "C" int eqrls_scan_launch(const void* x, const void* d, void* y,
                                 void* w, void* buf, void* p, int B, int T,
                                 int L, int cplx, float lam, float inv_lam,
                                 void* stream) {
  if (B < 1 || T < 1 || L < 1 || L > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  launch_nc<1>(L, static_cast<const float*>(x), static_cast<const float*>(d),
               static_cast<float*>(y), static_cast<float*>(w),
               static_cast<float*>(buf), static_cast<float*>(p), B, T,
               cplx != 0, lam, inv_lam, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
