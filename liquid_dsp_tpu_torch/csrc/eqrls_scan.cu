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
//   Px_i = tree_j P_ij buf_j;  den = lam + tree_i Re(conj(buf_i) Px_i);
//   k_i = Px_i * (1 / den);  w_i <- w_i + k_i conj(e);
//   r_l = tree_i conj(buf_i) P_il;  P_il <- (P_il - k_i r_l) * (1/lam)
// r is the column product buf^H P as written: P does not stay exactly
// Hermitian under this update, so (P buf)^H would be another function.
// A real stream runs as a complex one with zero imaginary parts.
//
// Bound on this card: the instructions a channel's warp issues a sample.
// The bytes are small (x, d in and y out, 24 bytes a complex sample) and
// the float32 work is about 8 L^2 operations a sample, but each sample
// needs the P and w that the last one left, and the work of one sample
// sits on the LM lanes of one channel.  What the design does:
//
// * A channel takes LM lanes (8, 16 or 32: the smallest power of two >= L
//   and >= 8), so a warp holds 32/LM channels, one block per warp.  Lane i
//   keeps row i of P in registers (LM complex values, zero from column L),
//   and tap i of w and of the window; lanes i >= L hold zeros, which stay
//   zero (each update adds products by zero).
// * The window shifts by one __shfl_down_sync a sample; each lane then
//   gathers the whole window by LM __shfl_sync (they depend on the inputs
//   only and run ahead of the chain).  Px_i is then lane i's own tree over
//   its row.
// * Sums over the rows (y, den and each of the LM column sums r_l) are
//   butterflies of __shfl_xor_sync over the channel's lanes, each level
//   rounded once: every lane ends with the same bits, equal to the plain
//   version's tree (v[i] + v[i + o], o halving), so every lane holds all
//   of r and updates its row of P with no further exchange.
// * Samples come a tile of LM at a time, as in eqlms_scan.cu: lane i
//   loads sample t0 + i of x and d, the next tile's loads go out before
//   the current tile's steps, each step takes its sample from lane s, and
//   lane s keeps step s's output for one store per lane a tile.  A step is
//   about 1,000 instructions at LM = 16, so the tile's loop is unrolled
//   by two steps only.
//
// Numerics: every operation is rounded once and written explicitly
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), so nvcc contracts
// nothing, and the plain PyTorch version (ops/kernels/eqrls_scan.py,
// eqrls_scan_reference) agrees with it bit for bit.
//
// Built by liquid_dsp_tpu_torch/ops/kernels/build.py with nvcc for sm_90a,
// bound with ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

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

// the butterfly sum over a channel's LM lanes
template <int LM>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = LM / 2; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(FULL, v, o, LM));
  return v;
}

template <int LM>
__global__ void __launch_bounds__(32)
eqrls_scan_kernel(const float* __restrict__ x, const float* __restrict__ d,
                  float* __restrict__ y, float* __restrict__ w_io,
                  float* __restrict__ buf_io, float* __restrict__ p_io,
                  int B, int T, int L, bool cplx, float lam, float inv_lam) {
  constexpr int G = 32 / LM;           // channels a warp
  const int lane = threadIdx.x;
  const int i = lane % LM;             // this lane's row and tap
  const int ch = blockIdx.x * G + lane / LM;
  const bool live = ch < B;
  const bool mine = live && i < L;
  const bool newest = i == L - 1;
  const bool ahead = i < L - 1;

  const size_t tap = static_cast<size_t>(ch) * L + i;
  float2 wv = make_float2(0.f, 0.f), bv = make_float2(0.f, 0.f);
  if (mine) {
    wv = load_sample(w_io, tap, cplx);
    bv = load_sample(buf_io, tap, cplx);
  }
  float wr = wv.x, wi = wv.y, br = bv.x, bi = bv.y;
  float pr[LM], pi[LM];                // row i of P
#pragma unroll
  for (int l = 0; l < LM; ++l) {
    const float2 v = mine && l < L ? load_sample(p_io, tap * L + l, cplx)
                                   : make_float2(0.f, 0.f);
    pr[l] = v.x;
    pi[l] = v.y;
  }
  const size_t row = static_cast<size_t>(ch) * T;

  auto load_tile = [&](int t0, float2& xv, float2& dv) {
    const int t = t0 + i;
    const bool in = live && t < T;
    xv = in ? load_sample(x, row + t, cplx) : make_float2(0.f, 0.f);
    dv = in ? load_sample(d, row + t, cplx) : make_float2(0.f, 0.f);
  };

  float yr_keep = 0.f, yi_keep = 0.f;
  auto step = [&](int s, float2 xv, float2 dv) {
    const float xr = __shfl_sync(FULL, xv.x, s, LM);
    const float xi = __shfl_sync(FULL, xv.y, s, LM);
    const float dr = __shfl_sync(FULL, dv.x, s, LM);
    const float di = __shfl_sync(FULL, dv.y, s, LM);
    const float ur = __shfl_down_sync(FULL, br, 1, LM);
    const float ui = __shfl_down_sync(FULL, bi, 1, LM);
    br = newest ? xr : (ahead ? ur : 0.f);
    bi = newest ? xi : (ahead ? ui : 0.f);
    // Px_i = sum_j P_ij buf_j over the gathered window, a tree over j
    float qr[LM], qi[LM];
#pragma unroll
    for (int j = 0; j < LM; ++j) {
      const float vr = __shfl_sync(FULL, br, j, LM);
      const float vi = __shfl_sync(FULL, bi, j, LM);
      qr[j] = __fsub_rn(__fmul_rn(pr[j], vr), __fmul_rn(pi[j], vi));
      qi[j] = __fadd_rn(__fmul_rn(pr[j], vi), __fmul_rn(pi[j], vr));
    }
#pragma unroll
    for (int o = LM / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < o; ++j) {
        qr[j] = __fadd_rn(qr[j], qr[j + o]);
        qi[j] = __fadd_rn(qi[j], qi[j + o]);
      }
    }
    const float pxr = qr[0], pxi = qi[0];
    // y and e with the old weights
    const float yr = lanes_sum<LM>(
        __fadd_rn(__fmul_rn(wr, br), __fmul_rn(wi, bi)));
    const float yi = lanes_sum<LM>(
        __fsub_rn(__fmul_rn(wr, bi), __fmul_rn(wi, br)));
    const float er = __fsub_rn(dr, yr), ei = __fsub_rn(di, yi);
    // the gain k_i = Px_i / (lam + Re(buf^H Px))
    const float q = lanes_sum<LM>(
        __fadd_rn(__fmul_rn(br, pxr), __fmul_rn(bi, pxi)));
    const float rden = __fdiv_rn(1.f, __fadd_rn(q, lam));
    const float kr = __fmul_rn(pxr, rden), ki = __fmul_rn(pxi, rden);
    wr = __fadd_rn(wr, __fadd_rn(__fmul_rn(kr, er), __fmul_rn(ki, ei)));
    wi = __fadd_rn(wi, __fsub_rn(__fmul_rn(ki, er), __fmul_rn(kr, ei)));
    // r_l = sum_i conj(buf_i) P_il, then row i of (P - k r) / lam
#pragma unroll
    for (int l = 0; l < LM; ++l) {
      const float rr = lanes_sum<LM>(
          __fadd_rn(__fmul_rn(br, pr[l]), __fmul_rn(bi, pi[l])));
      const float ri = lanes_sum<LM>(
          __fsub_rn(__fmul_rn(br, pi[l]), __fmul_rn(bi, pr[l])));
      pr[l] = __fmul_rn(
          __fsub_rn(pr[l], __fsub_rn(__fmul_rn(kr, rr), __fmul_rn(ki, ri))),
          inv_lam);
      pi[l] = __fmul_rn(
          __fsub_rn(pi[l], __fadd_rn(__fmul_rn(kr, ri), __fmul_rn(ki, rr))),
          inv_lam);
    }
    if (i == s) {
      yr_keep = yr;
      yi_keep = yi;
    }
  };

  float2 xv, dv, xn, dn;
  load_tile(0, xv, dv);
  const int full = T / LM * LM;
  for (int t0 = 0; t0 < full; t0 += LM) {
    load_tile(t0 + LM, xn, dn);
    // two steps a loop turn: a whole tile unrolled (17,000 instructions
    // at LM = 16) outran the instruction cache, 2.8 times slower; one or
    // four steps a turn left ptxas a stack frame (chip_kernel_bench.py --eq)
#pragma unroll 2
    for (int s = 0; s < LM; ++s) step(s, xv, dv);
    if (live) store_sample(y, row + t0 + i, cplx, yr_keep, yi_keep);
    xv = xn;
    dv = dn;
  }
  const int rem = T - full;
  for (int s = 0; s < rem; ++s) step(s, xv, dv);
  if (live && i < rem) store_sample(y, row + full + i, cplx, yr_keep, yi_keep);

  if (mine) {
    store_sample(w_io, tap, cplx, wr, wi);
    store_sample(buf_io, tap, cplx, br, bi);
#pragma unroll
    for (int l = 0; l < LM; ++l)
      if (l < L) store_sample(p_io, tap * L + l, cplx, pr[l], pi[l]);
  }
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EQRLS_ARGS                                                         \
  static_cast<const float*>(x), static_cast<const float*>(d),              \
      static_cast<float*>(y), static_cast<float*>(w),                      \
      static_cast<float*>(buf), static_cast<float*>(p), B, T, L,           \
      cplx != 0, lam, inv_lam
  if (L <= 8)
    eqrls_scan_kernel<8><<<(B + 3) / 4, 32, 0, st>>>(EQRLS_ARGS);
  else if (L <= 16)
    eqrls_scan_kernel<16><<<(B + 1) / 2, 32, 0, st>>>(EQRLS_ARGS);
  else
    eqrls_scan_kernel<32><<<B, 32, 0, st>>>(EQRLS_ARGS);
#undef EQRLS_ARGS
  return static_cast<int>(cudaGetLastError());
}
