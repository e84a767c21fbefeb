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
// real one, sign(0) = 0).  A real stream runs as a complex one with zero
// imaginary parts; its rows are read and written as floats, a complex
// stream's as interleaved (re, im) pairs.
//
// Bound on this card: the chain.  A sample moves 16 bytes (x in, y out,
// complex), and each sample's output needs the weights that the last
// sample's error updated: y -> e -> w -> y.  What the design does:
//
// * A channel takes LM lanes (8, 16 or 32: the smallest power of two >= L
//   and >= 8), so a warp holds 32/LM channels, one block per warp: 256
//   channels at L = 13 spread over 128 SMs.  Lane j keeps tap j of w and
//   of the window; lanes j >= L hold zeros.  The scalar state (x2, n) is
//   kept alike in every lane of the channel.
// * The window shifts by one __shfl_down_sync a sample (lane L-1 takes the
//   new sample), the oldest sample comes from lane 0 by __shfl_sync.
// * The dot is the butterfly of __shfl_xor_sync over the LM lanes (width
//   LM), each level rounded once: lane j adds its value and lane j^o's.
//   The sum is commutative, so every lane ends with the same bits, and
//   they equal the plain version's tree (v[j] + v[j + o], o halving).  The
//   chain per sample is two products and a sum, log2(LM) shuffles and
//   sums, the slicer's selects, the error, its product by g and the
//   weight update (three roundings).  g, the window and x2 depend on the
//   inputs only and run beside it.
// * Samples come a tile of LM at a time: lane j loads sample t0 + j of its
//   channel (LM neighbouring 8-byte values, a line at LM = 16), the next
//   tile's loads are issued before the current tile's LM steps, and each
//   step takes its sample from lane s by __shfl_sync.  Lane s keeps step
//   s's output, and the tile's outputs leave as one store per lane.  The
//   steps of a full tile run four a loop turn; the last, partial tile
//   runs the same step one at a time.
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

// sign(v) * sc with sign(0) = 0 (and 0 for NaN, as torch.sign)
__device__ __forceinline__ float slice(float v, float sc) {
  return v > 0.f ? sc : (v < 0.f ? -sc : 0.f);
}

template <int LM>
__global__ void __launch_bounds__(32)
eqlms_scan_kernel(const float* __restrict__ x, const float* __restrict__ d,
                  float* __restrict__ y, float* __restrict__ w_io,
                  float* __restrict__ buf_io, float* __restrict__ x2_io,
                  int* __restrict__ n_io, int B, int T, int L, bool cplx,
                  bool trained, float mu, float sc) {
  constexpr int G = 32 / LM;           // channels a warp
  const int lane = threadIdx.x;
  const int j = lane % LM;             // this lane's tap
  const int ch = blockIdx.x * G + lane / LM;
  const bool live = ch < B;
  const bool newest = j == L - 1;      // the tap that takes the new sample
  const bool ahead = j < L - 1;        // taps that take their right neighbour

  const size_t tap = static_cast<size_t>(ch) * L + j;
  float2 wv = make_float2(0.f, 0.f), bv = make_float2(0.f, 0.f);
  if (live && j < L) {
    wv = load_sample(w_io, tap, cplx);
    bv = load_sample(buf_io, tap, cplx);
  }
  float wr = wv.x, wi = wv.y, br = bv.x, bi = bv.y;
  float x2 = live ? x2_io[ch] : 0.f;
  int n = live ? n_io[ch] : 0;
  const size_t row = static_cast<size_t>(ch) * T;

  // lane j's sample of the tile at t0 (zero past the end)
  auto load_tile = [&](int t0, float2& xv, float2& dv) {
    const int t = t0 + j;
    const bool in = live && t < T;
    xv = in ? load_sample(x, row + t, cplx) : make_float2(0.f, 0.f);
    dv = in && trained ? load_sample(d, row + t, cplx) : make_float2(0.f, 0.f);
  };

  float yr_keep = 0.f, yi_keep = 0.f;
  auto step = [&](int s, float2 xv, float2 dv) {
    const float xr = __shfl_sync(FULL, xv.x, s, LM);
    const float xi = __shfl_sync(FULL, xv.y, s, LM);
    const float dr = __shfl_sync(FULL, dv.x, s, LM);
    const float di = __shfl_sync(FULL, dv.y, s, LM);
    // the window: the oldest sample leaves, lane L-1 takes the new one
    const float orr = __shfl_sync(FULL, br, 0, LM);
    const float oi = __shfl_sync(FULL, bi, 0, LM);
    const float ur = __shfl_down_sync(FULL, br, 1, LM);
    const float ui = __shfl_down_sync(FULL, bi, 1, LM);
    br = newest ? xr : (ahead ? ur : 0.f);
    bi = newest ? xi : (ahead ? ui : 0.f);
    x2 = __fsub_rn(__fadd_rn(x2, __fmaf_rn(xr, xr, __fmul_rn(xi, xi))),
                   __fmaf_rn(orr, orr, __fmul_rn(oi, oi)));
    n += 1;
    const float g = __fdiv_rn(n >= L ? mu : 0.f, fmaxf(x2, 1e-12f));
    // y = sum conj(w_j) buf_j, the butterfly over the channel's lanes
    float yr = __fadd_rn(__fmul_rn(wr, br), __fmul_rn(wi, bi));
    float yi = __fsub_rn(__fmul_rn(wr, bi), __fmul_rn(wi, br));
#pragma unroll
    for (int o = LM / 2; o > 0; o >>= 1) {
      yr = __fadd_rn(yr, __shfl_xor_sync(FULL, yr, o, LM));
      yi = __fadd_rn(yi, __shfl_xor_sync(FULL, yi, o, LM));
    }
    const float tr = trained ? dr : slice(yr, sc);
    const float ti = trained ? di : slice(yi, sc);
    const float ger = __fmul_rn(g, __fsub_rn(tr, yr));
    const float gei = __fmul_rn(g, __fsub_rn(ti, yi));
    wr = __fadd_rn(wr, __fadd_rn(__fmul_rn(ger, br), __fmul_rn(gei, bi)));
    wi = __fadd_rn(wi, __fsub_rn(__fmul_rn(ger, bi), __fmul_rn(gei, br)));
    if (j == s) {
      yr_keep = yr;
      yi_keep = yi;
    }
  };

  float2 xv, dv, xn, dn;
  load_tile(0, xv, dv);
  const int full = T / LM * LM;
  for (int t0 = 0; t0 < full; t0 += LM) {
    load_tile(t0 + LM, xn, dn);
    // four steps a loop turn: 5% less time than the whole tile unrolled
    // at L = 13, 17% less than one step a turn (chip_kernel_bench.py --eq)
#pragma unroll 4
    for (int s = 0; s < LM; ++s) step(s, xv, dv);
    if (live) store_sample(y, row + t0 + j, cplx, yr_keep, yi_keep);
    xv = xn;
    dv = dn;
  }
  const int rem = T - full;
  for (int s = 0; s < rem; ++s) step(s, xv, dv);
  if (live && j < rem) store_sample(y, row + full + j, cplx, yr_keep, yi_keep);

  if (live && j < L) {
    store_sample(w_io, tap, cplx, wr, wi);
    store_sample(buf_io, tap, cplx, br, bi);
  }
  if (live && j == 0) {
    x2_io[ch] = x2;
    n_io[ch] = n;
  }
}

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
#define EQLMS_ARGS                                                         \
  static_cast<const float*>(x), static_cast<const float*>(d),              \
      static_cast<float*>(y), static_cast<float*>(w),                      \
      static_cast<float*>(buf), static_cast<float*>(x2),                   \
      static_cast<int*>(n), B, T, L, cplx != 0, trained != 0, mu, sc
  if (L <= 8)
    eqlms_scan_kernel<8><<<(B + 3) / 4, 32, 0, st>>>(EQLMS_ARGS);
  else if (L <= 16)
    eqlms_scan_kernel<16><<<(B + 1) / 2, 32, 0, st>>>(EQLMS_ARGS);
  else
    eqlms_scan_kernel<32><<<B, 32, 0, st>>>(EQLMS_ARGS);
#undef EQLMS_ARGS
  return static_cast<int>(cudaGetLastError());
}
