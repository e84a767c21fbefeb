// The normalized LMS equalizer's per-sample recurrence, for Hopper
// (sm_90a).
//
// Replaces the lax.scan of liquid_dsp_tpu/ops/equalize.py:48-86
// (eqlms_run); the JAX package has no Pallas kernel here, and PyTorch has
// no scan that stays on the device.
//
// What it computes, per channel and sample, with the window of the last L
// inputs oldest first (ops/kernels/eqlms_scan.py writes it out):
//   buf <- [buf[1:], x];  x2 <- (x2 + fma(xr, xr, xi*xi)) - |oldest|^2;
//   n <- n + 1;  g = (n >= L ? mu : 0) / max(x2, 1e-12);
//   y = tree_j conj(w_j) buf_j;  e = target - y;
//   w_j <- w_j + (g e_re b_re + g e_im b_im, g e_re b_im - g e_im b_re)
// with the target d (trained) or the default slicer, sign(y_re) sc +
// j sign(y_im) sc (sc = sqrt(1/2) as float32 on a complex stream, 1 on a
// real one, sign(0) = 0).  tree is the butterfly over LM entries (the
// taps padded with zeros): at each level entry j takes v[j] + v[j + o], o
// halving.  A real stream runs as a complex one with zero imaginary parts;
// its rows are read and written as floats, a complex stream's as
// interleaved (re, im) pairs.
//
// Bound on this card: the chain.  A sample moves 16 bytes (x in, y out,
// complex), and each sample's output needs the weights that the last
// sample's error updated: y -> e -> w -> y.  The design before this one
// took 248 cycles a step at L = 13: each step divided for its gain (an
// IEEE division, whose slow-path branch split the step's basic block, so
// no two steps overlapped), and the dot's four shuffle levels sat on the
// chain.  What the design does:
//
// * A channel takes LM lanes (8, 16 or 32: the smallest power of two >= L
//   and >= 8), so a warp holds 32/LM channels, one block per warp: 256
//   channels at L = 13 spread over 128 SMs.  Lane j keeps tap j of w;
//   lanes j >= L hold zeros.  The kernel is built for each LM and mode
//   (trained or the slicer).
// * Samples come a tile of LM: lane j loads sample t0 + j two tiles
//   ahead, and each tile is staged into shared memory (LM samples of
//   history, then the tile) between two __syncwarps; each step reads its
//   window entry from there.  Lane s keeps step s's output, and the
//   tile's outputs leave as one store a lane.
// * The gains leave the chain.  x2's running sum depends on the inputs
//   only: while a tile's steps run, every lane also runs the next tile's
//   running sum, a step each (the powers entering and leaving from lane
//   s by two shuffles; the same additions in the same order), and lane j
//   keeps the value after step j.  At the tile's start each lane divides
//   once for its own step's gain, and step s takes lane s's by a shuffle.
//   The steps hold no division and no branch; EQLMS_UNROLL steps a loop
//   turn (the whole tile, 20 KB of code a turn, ran slower).
// * The dot goes through shared memory: each lane writes its tap's
//   product, and after one __syncwarp every lane reads all LM of its
//   channel's products as LM/2 16-byte broadcast loads and sums them in
//   registers in the butterfly's order (double-buffered by the step's
//   parity, so one __syncwarp a step).
//
// Measured at L = 13 (chip_kernel_bench.py --eq, H100 at 700 W, parent
// and change in one call): a lone step 201-202 cycles (248 before), 3.33
// ms at 256 x 32768 (4.10-4.11).  The designs it was held against, in
// the calls before: the dot by the xor shuffles, 208-222 cycles; two
// taps a lane (three levels across lanes), 213-248; four, 254-348.  The
// step is held by its chain (the product, the sum, the slicer, the
// error, g e and the update), not by the levels across lanes.
//
// Numerics: every operation is rounded once and written explicitly
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, and __fmaf_rn where the
// JAX package's XLA build fuses |x|^2), so nvcc contracts nothing, and
// the plain PyTorch version (ops/kernels/eqlms_scan.py,
// eqlms_scan_reference) agrees with it bit for bit.
//
// Built by liquid_dsp_tpu_torch/ops/kernels/build.py with nvcc for sm_90a,
// bound with ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

#ifndef EQLMS_UNROLL
#define EQLMS_UNROLL 4   // steps a loop turn (even); 0: the whole tile
#endif

namespace {

constexpr unsigned FULL = 0xffffffffu;

// sample k of a row: an interleaved complex value, or a real one
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

// |v|^2 as XLA's CPU build forms it: one fused multiply-add
__device__ __forceinline__ float power(float2 v) {
  return __fmaf_rn(v.x, v.x, __fmul_rn(v.y, v.y));
}

// sign(v) * sc with sign(0) = 0 (and 0 for NaN, as torch.sign)
__device__ __forceinline__ float slice(float v, float sc) {
  return v > 0.f ? sc : (v < 0.f ? -sc : 0.f);
}

template <int V>
struct Idx {
  static constexpr int value = V;
};

// entry J of the butterfly's order over N entries (a power of two) after
// its levels from the first down to O: at level o entry j takes v[j] +
// v[j + o].  get(Idx<j>) is entry j before the first level.  It unfolds
// at compile time into straight-line code: no array and no loop, so
// nothing of it can be left in local memory.
template <int N, int J = 0, int O = 1, class Get>
__device__ __forceinline__ float2 lane_tree(const Get& get) {
  if constexpr (2 * O > N) {
    return get(Idx<J>{});
  } else {
    const float2 a = lane_tree<N, J, 2 * O>(get);
    const float2 b = lane_tree<N, J + O, 2 * O>(get);
    return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
  }
}

template <int LM, bool TRAINED>
__global__ void __launch_bounds__(32)
eqlms_scan_kernel(const float* __restrict__ x, const float* __restrict__ d,
                  float* __restrict__ y, float* __restrict__ w_io,
                  float* __restrict__ buf_io, float* __restrict__ x2_io,
                  int* __restrict__ n_io, int B, int T, int L, bool cplx,
                  float mu, float sc) {
  constexpr int G = 32 / LM;           // channels a warp
  constexpr int UNROLL = EQLMS_UNROLL > 0 ? EQLMS_UNROLL : LM;
  static_assert(UNROLL % 2 == 0, "steps a loop turn come in pairs");
  __shared__ __align__(16) float2 xs[G][2 * LM];      // history, the tile
  __shared__ __align__(16) float2 ps[G][2][LM];       // the dot's products
  const int lane = threadIdx.x;
  const int j = lane % LM;             // this lane's tap and tile sample
  const int g = lane / LM;
  const int ch = blockIdx.x * G + g;
  const bool live = ch < B;
  const bool tap = j < L;

  const size_t k0 = static_cast<size_t>(ch) * L + j;
  float2 wv = make_float2(0.f, 0.f), bv = make_float2(0.f, 0.f);
  if (live && tap) {
    wv = load_sample(w_io, k0, cplx);
    bv = load_sample(buf_io, k0, cplx);
  }
  float wr = wv.x, wi = wv.y, br = bv.x, bi = bv.y;
  const float x2_in = live ? x2_io[ch] : 0.f;
  const int n = live ? n_io[ch] : 0;
  // the history is the carried window: entry j is sample j - L, at
  // xs[LM - L + j]; window entry j of step s is win[s]
  xs[g][j] = make_float2(0.f, 0.f);
  xs[g][LM + j] = make_float2(0.f, 0.f);
  __syncwarp();
  if (tap) xs[g][LM - L + j] = bv;
  const float2* win = &xs[g][LM - L + 1 + (tap ? j : L - 1)];
  float2* pw = &ps[g][0][j];
  const float4* pq = reinterpret_cast<const float4*>(&ps[g][0][0]);
  const size_t row = static_cast<size_t>(ch) * T;

  // lane j's sample of the tile at t0 (zero past the end)
  auto load_tile = [&](int t0, float2& xv, float2& dv) {
    const int t = t0 + j;
    const bool in = live && t < T;
    xv = in ? load_sample(x, row + t, cplx) : make_float2(0.f, 0.f);
    dv = TRAINED && in ? load_sample(d, row + t, cplx) : make_float2(0.f, 0.f);
  };
  auto stage = [&](bool first, float2 xprev, float2 xv) {
    __syncwarp();
    if (!first) xs[g][j] = xprev;
    xs[g][LM + j] = xv;
    __syncwarp();
  };
  // one step of the running sum: the powers entering (A) and leaving (P)
  // at step s from lane s; lane s keeps the sum after it
  auto run_step = [&](float A, float P, float& run, float& mine, int s) {
    run = __fsub_rn(__fadd_rn(run, __shfl_sync(FULL, A, s, LM)),
                    __shfl_sync(FULL, P, s, LM));
    if (j == s) mine = run;
  };

  float yr_keep = 0.f, yi_keep = 0.f;
  // step s of a tile; b, the parity of s, picks the products' buffer (a
  // constant where the tile's loop calls it)
  auto step = [&](int s, int b, float gs, float2 dv) {
    const float2 v = win[s];
    br = tap ? v.x : 0.f;
    bi = tap ? v.y : 0.f;
    // y = sum conj(w_j) buf_j: the products through shared memory, every
    // lane sums all of its channel's in the butterfly's order, entries
    // 2k and 2k+1 from one 16-byte load
    pw[b * LM] = make_float2(__fadd_rn(__fmul_rn(wr, br), __fmul_rn(wi, bi)),
                             __fsub_rn(__fmul_rn(wr, bi), __fmul_rn(wi, br)));
    __syncwarp();
    const float2 yv = lane_tree<LM>([&](auto k) {
      constexpr int e = decltype(k)::value;
      const float4 q = pq[b * (LM / 2) + e / 2];
      return e % 2 ? make_float2(q.z, q.w) : make_float2(q.x, q.y);
    });
    const float yr = yv.x, yi = yv.y;
    float tr, ti;
    if (TRAINED) {
      tr = __shfl_sync(FULL, dv.x, s, LM);
      ti = __shfl_sync(FULL, dv.y, s, LM);
    } else {
      tr = slice(yr, sc);
      ti = slice(yi, sc);
    }
    const float ger = __fmul_rn(gs, __fsub_rn(tr, yr));
    const float gei = __fmul_rn(gs, __fsub_rn(ti, yi));
    wr = __fadd_rn(wr, __fadd_rn(__fmul_rn(ger, br), __fmul_rn(gei, bi)));
    wi = __fadd_rn(wi, __fsub_rn(__fmul_rn(ger, bi), __fmul_rn(gei, br)));
    if (j == s) {
      yr_keep = yr;
      yi_keep = yi;
    }
  };

  // tiles 0 and 1 in registers, and tile 0's running sum: the power
  // leaving at step j is the carried window's entry j (j < L) or tile
  // 0's sample j - L
  float2 xc, dc, xn, dn, xnn, dnn, xprev = make_float2(0.f, 0.f);
  load_tile(0, xc, dc);
  load_tile(LM, xn, dn);
  float Ac = power(xc);
  float run = x2_in, x2m = 0.f;
  {
    const float back = __shfl_sync(FULL, Ac, j >= L ? j - L : 0, LM);
    const float P = tap ? power(bv) : back;
#pragma unroll
    for (int s = 0; s < LM; ++s) run_step(Ac, P, run, x2m, s);
  }
  float x2_out = x2_in;
  const int full = T / LM * LM;
  for (int t0 = 0; t0 < full; t0 += LM) {
    // this tile's gains, one division a lane ahead of its steps
    const float gm = __fdiv_rn(n + t0 + j + 1 >= L ? mu : 0.f,
                               fmaxf(x2m, 1e-12f));
    x2_out = run;                      // the running sum after this tile
    load_tile(t0 + 2 * LM, xnn, dnn);
    // the next tile's powers: entering, its own samples; leaving at step
    // j, its sample j - L or this tile's sample LM + j - L
    const float An = power(xn);
    const float back = __shfl_sync(FULL, An, j >= L ? j - L : 0, LM);
    const float here = __shfl_sync(FULL, Ac, j < L ? LM + j - L : 0, LM);
    const float Pn = j >= L ? back : here;
    stage(t0 == 0, xprev, xc);
    float x2m_next = 0.f;
#pragma unroll (UNROLL / 2)
    for (int s = 0; s < LM; s += 2) {
      step(s, 0, __shfl_sync(FULL, gm, s, LM), dc);
      run_step(An, Pn, run, x2m_next, s);
      step(s + 1, 1, __shfl_sync(FULL, gm, s + 1, LM), dc);
      run_step(An, Pn, run, x2m_next, s + 1);
    }
    if (live) store_sample(y, row + t0 + j, cplx, yr_keep, yi_keep);
    xprev = xc;
    xc = xn;
    dc = dn;
    xn = xnn;
    dn = dnn;
    Ac = An;
    x2m = x2m_next;
  }
  const int rem = T - full;
  if (rem > 0) {
    const float gm = __fdiv_rn(n + full + j + 1 >= L ? mu : 0.f,
                               fmaxf(x2m, 1e-12f));
    stage(full == 0, xprev, xc);
#pragma unroll 1
    for (int s = 0; s < rem; ++s)
      step(s, s & 1, __shfl_sync(FULL, gm, s, LM), dc);
    if (live && j < rem)
      store_sample(y, row + full + j, cplx, yr_keep, yi_keep);
    x2_out = __shfl_sync(FULL, x2m, rem - 1, LM);
  }

  if (live && tap) {
    store_sample(w_io, k0, cplx, wr, wi);
    store_sample(buf_io, k0, cplx, br, bi);
  }
  if (live && j == 0) {
    x2_io[ch] = x2_out;
    n_io[ch] = n + T;
  }
}

#define EQLMS_ARGS                                                         \
  static_cast<const float*>(x), static_cast<const float*>(d),              \
      static_cast<float*>(y), static_cast<float*>(w),                      \
      static_cast<float*>(buf), static_cast<float*>(x2),                   \
      static_cast<int*>(n), B, T, L, cplx != 0, mu, sc

template <int LM>
void launch_lm(bool trained, const void* x, const void* d, void* y, void* w,
               void* buf, void* x2, void* n, int B, int T, int L, int cplx,
               float mu, float sc, cudaStream_t st) {
  constexpr int G = 32 / LM;
  if (trained)
    eqlms_scan_kernel<LM, true><<<(B + G - 1) / G, 32, 0, st>>>(EQLMS_ARGS);
  else
    eqlms_scan_kernel<LM, false><<<(B + G - 1) / G, 32, 0, st>>>(EQLMS_ARGS);
}

#undef EQLMS_ARGS

}  // namespace

// x, d (d null unless trained), y: [B, T] rows, complex64 (interleaved
// floats) if cplx else float32.  State, read and overwritten in place:
// w, buf [B, L] of the same type, x2 [B] float32, n [B] int32; 1 <= L <=
// 32.  Returns the cudaError_t of the launch (0 on success).
extern "C" int eqlms_scan_launch(const void* x, const void* d, void* y,
                                 void* w, void* buf, void* x2, void* n, int B,
                                 int T, int L, int cplx, int trained,
                                 float mu, float sc, void* stream) {
  if (B < 1 || T < 1 || L < 1 || L > 32 || (trained && !d))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L <= 8)
    launch_lm<8>(trained != 0, x, d, y, w, buf, x2, n, B, T, L, cplx, mu, sc,
                 st);
  else if (L <= 16)
    launch_lm<16>(trained != 0, x, d, y, w, buf, x2, n, B, T, L, cplx, mu,
                  sc, st);
  else
    launch_lm<32>(trained != 0, x, d, y, w, buf, x2, n, B, T, L, cplx, mu,
                  sc, st);
  return static_cast<int>(cudaGetLastError());
}
