// symtrack's carrier PLL + decision-directed LMS over the symsync slots,
// for Hopper (sm_90a).
//
// Replaces the lax.scan of the post step in
// liquid_dsp_tpu/framing/symtrack.py:218-267 (sequential route, :301-306);
// the JAX package has no Pallas kernel here, and PyTorch has no scan that
// stays on the device.
//
// What it computes, per channel b and slot s (all-real, re/im planes):
//   v = sym * exp(-j theta);  r = nearest(v);  e = atan2(Im v conj r,
//   Re v conj r);  dtheta += beta2 e;  theta += dtheta + alpha e;
//   buf <- [buf[1:], v];  x2 += |v|^2 - |buf_oldest|^2;
//   y = sum_j conj(w_j) buf_j;  d = nearest(y);
//   w += ((n+1 >= L) mu / max(x2, 1e-12)) conj(d - y) buf
// every state update gated by the slot's valid flag; y and the index of d
// written for every slot.  nearest: the quadrant sign slicer for a
// QPSK-like table (qpsk = 1, k_ab the index at ((-1)^a s, (-1)^b s)),
// else the first argmin of |v - t|^2 over the M points (the table read
// through the read-only cache; all threads read the same entry).
//
// Numerics: float32 with sincosf and atan2f (CUDA has atan2, which the
// TPU's Mosaic lacked) and nvcc's default FMA contraction; the dot is
// summed in index order.  So it agrees with the plain PyTorch version
// (ops/kernels/pll_lms.py) to the stream tolerance (2e-4, decisions
// equal), not bit for bit.
//
// Bound on this card: latency.  Each slot depends on the last through
// theta and w, so one thread per channel walks its own slots with the
// whole state in registers: w and the window as LM-entry arrays (LM = 16
// or 32, the smallest that holds L), the live L entries at the top, the
// rest zero, every loop over them unrolled so that no index is dynamic.
// 32 threads per block spread the channels over SMs.
//
// Built by liquid_dsp_tpu_torch/ops/kernels/build.py with nvcc for sm_90a,
// bound with ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;

struct Slicer {
  const float* tab_re;
  const float* tab_im;
  int M, qpsk, k00, k01, k10, k11;
  float s2v;

  __device__ __forceinline__ int nearest(float v_re, float v_im, float* r_re,
                                         float* r_im) const {
    if (qpsk) {
      const bool a = v_re < 0.f, b = v_im < 0.f;
      *r_re = a ? -s2v : s2v;
      *r_im = b ? -s2v : s2v;
      return a ? (b ? k11 : k10) : (b ? k01 : k00);
    }
    int best = 0;
    float dbest = 0.f;
    for (int m = 0; m < M; ++m) {
      const float dr = v_re - __ldg(tab_re + m);
      const float di = v_im - __ldg(tab_im + m);
      const float d2 = dr * dr + di * di;
      if (m == 0 || d2 < dbest) {
        dbest = d2;
        best = m;
      }
    }
    *r_re = __ldg(tab_re + best);
    *r_im = __ldg(tab_im + best);
    return best;
  }
};

template <int LM>
__global__ void __launch_bounds__(THREADS)
pll_lms_kernel(const float* __restrict__ s_re, const float* __restrict__ s_im,
               const unsigned char* __restrict__ valid,
               float* __restrict__ theta_io, float* __restrict__ dtheta_io,
               float* __restrict__ w_re_io, float* __restrict__ w_im_io,
               float* __restrict__ b_re_io, float* __restrict__ b_im_io,
               float* __restrict__ x2_io, int* __restrict__ n_io,
               Slicer sl, float* __restrict__ y_re_o,
               float* __restrict__ y_im_o, int* __restrict__ dec_o, int B,
               int S, int L, float alpha, float beta2, float mu) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  const int off = LM - L;     // live entries at [off, LM)
  float w_re[LM], w_im[LM], q_re[LM], q_im[LM];
#pragma unroll
  for (int j = 0; j < LM; ++j) {
    const bool live = j >= off;
    const size_t src = static_cast<size_t>(b) * L + (j - off);
    w_re[j] = live ? w_re_io[src] : 0.f;
    w_im[j] = live ? w_im_io[src] : 0.f;
    q_re[j] = live ? b_re_io[src] : 0.f;
    q_im[j] = live ? b_im_io[src] : 0.f;
  }
  float theta = theta_io[b], dtheta = dtheta_io[b], x2s = x2_io[b];
  int n = n_io[b];
  const size_t row = static_cast<size_t>(b) * S;

  for (int s = 0; s < S; ++s) {
    const float sr = s_re[row + s], si = s_im[row + s];
    const bool vm = valid[row + s] != 0;
    float sth, cth;
    sincosf(theta, &sth, &cth);
    const float v_re = sr * cth + si * sth;
    const float v_im = si * cth - sr * sth;
    float r_re, r_im;
    sl.nearest(v_re, v_im, &r_re, &r_im);
    const float e = atan2f(v_im * r_re - v_re * r_im,
                           v_re * r_re + v_im * r_im);
    const float dtheta_n = dtheta + beta2 * e;
    const float theta_n = theta + dtheta_n + alpha * e;
    // the oldest live entry, read with compile-time indices only
    float o_re = 0.f, o_im = 0.f;
#pragma unroll
    for (int j = 0; j < LM; ++j)
      if (j == off) {
        o_re = q_re[j];
        o_im = q_im[j];
      }
    // the shifted window (padding stays zero) and y = sum conj(w) buf
    float nb_re[LM], nb_im[LM];
    float y_re = 0.f, y_im = 0.f;
#pragma unroll
    for (int j = 0; j < LM; ++j) {
      nb_re[j] = j == LM - 1 ? v_re : (j >= off ? q_re[j + 1 < LM ? j + 1 : j] : 0.f);
      nb_im[j] = j == LM - 1 ? v_im : (j >= off ? q_im[j + 1 < LM ? j + 1 : j] : 0.f);
      y_re += w_re[j] * nb_re[j] + w_im[j] * nb_im[j];
      y_im += w_re[j] * nb_im[j] - w_im[j] * nb_re[j];
    }
    const float x2n = x2s + (v_re * v_re + v_im * v_im)
                      - (o_re * o_re + o_im * o_im);
    float d_re, d_im;
    const int dec = sl.nearest(y_re, y_im, &d_re, &d_im);
    const float e_re = d_re - y_re, e_im = d_im - y_im;
    const int nn = n + 1;
    const float g = (nn >= L ? mu : 0.f) / fmaxf(x2n, 1e-12f);
    if (vm) {
#pragma unroll
      for (int j = 0; j < LM; ++j) {
        w_re[j] += g * (e_re * nb_re[j] + e_im * nb_im[j]);
        w_im[j] += g * (e_re * nb_im[j] - e_im * nb_re[j]);
        q_re[j] = nb_re[j];
        q_im[j] = nb_im[j];
      }
      theta = theta_n;
      dtheta = dtheta_n;
      x2s = x2n;
      n = nn;
    }
    y_re_o[row + s] = y_re;
    y_im_o[row + s] = y_im;
    dec_o[row + s] = dec;
  }

#pragma unroll
  for (int j = 0; j < LM; ++j) {
    if (j >= off) {
      const size_t dst = static_cast<size_t>(b) * L + (j - off);
      w_re_io[dst] = w_re[j];
      w_im_io[dst] = w_im[j];
      b_re_io[dst] = q_re[j];
      b_im_io[dst] = q_im[j];
    }
  }
  theta_io[b] = theta;
  dtheta_io[b] = dtheta;
  x2_io[b] = x2s;
  n_io[b] = n;
}

}  // namespace

// s_re, s_im: [B, S] float32; valid: [B, S] bytes (0/1).  State, read and
// overwritten in place: theta, dtheta, x2 [B] float32, n [B] int32,
// w_re, w_im, b_re, b_im [B, L] float32, 1 <= L <= 32.  tab_re, tab_im:
// [M] float32.  y_re, y_im: [B, S] float32; dec: [B, S] int32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int pll_lms_launch(
    const void* s_re, const void* s_im, const void* valid, void* theta,
    void* dtheta, void* w_re, void* w_im, void* b_re, void* b_im, void* x2,
    void* n, const void* tab_re, const void* tab_im, void* y_re, void* y_im,
    void* dec, int B, int S, int L, int M, int qpsk, int k00, int k01,
    int k10, int k11, float alpha, float beta2, float mu, float s2v,
    void* stream) {
  if (B < 1 || S < 1 || L < 1 || L > 32 || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Slicer sl{static_cast<const float*>(tab_re),
                  static_cast<const float*>(tab_im), M, qpsk, k00, k01, k10,
                  k11, s2v};
  const dim3 grid((B + THREADS - 1) / THREADS);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PLL_LMS_ARGS                                                       \
  static_cast<const float*>(s_re), static_cast<const float*>(s_im),        \
      static_cast<const unsigned char*>(valid), static_cast<float*>(theta), \
      static_cast<float*>(dtheta), static_cast<float*>(w_re),              \
      static_cast<float*>(w_im), static_cast<float*>(b_re),                \
      static_cast<float*>(b_im), static_cast<float*>(x2),                  \
      static_cast<int*>(n), sl, static_cast<float*>(y_re),                 \
      static_cast<float*>(y_im), static_cast<int*>(dec), B, S, L, alpha,    \
      beta2, mu
  if (L <= 16)
    pll_lms_kernel<16><<<grid, THREADS, 0, st>>>(PLL_LMS_ARGS);
  else
    pll_lms_kernel<32><<<grid, THREADS, 0, st>>>(PLL_LMS_ARGS);
#undef PLL_LMS_ARGS
  return static_cast<int>(cudaGetLastError());
}
