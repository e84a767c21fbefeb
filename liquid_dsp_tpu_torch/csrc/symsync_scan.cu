// The symsync timing loop over precomputed branch outputs, for Hopper
// (sm_90a).
//
// Replaces liquid_dsp_tpu/ops/kernels/pallas_symsync.py:symsync_scan_pallas
// (with its helpers _make_kernel and _round_half_even), the TPU kernel
// behind the hoisted symsync path (ops/symsync._symsync_run_hoisted).
//
// What it computes, per channel b and input step t, for up to max_out
// emits (ops/symsync._timing_update):
//   active = bi < npfb;  bc = clip(bi, 0, npfb-1)
//   mf, dmf = the branch-bc matched-filter outputs (re and im planes)
//   q = clip(mf_re*dmf_re + mf_im*dmf_im, -1, 1)
//   loop filter q_hat, v0; rate, del on a loop update; tau += del
//   bf = tau*npfb;  bi = round-half-even(bf);  y = active ? mf*(1/k) : 0
// then tau -= 1, bf -= npfb, bi -= npfb.
//
// Bit-exactness: the JAX kernel (and the scan it equals) compiles with
// three products contracted into FMAs: q_raw = fma(mf_re, dmf_re,
// mf_im*dmf_im), q_hat = fma(B0/A0, q, v0), rate' = fma(rate_adj, q_hat,
// rate), and folds the division by k into a multiply by 1/k rounded in
// float32.  This kernel takes __fmaf_rn at exactly those places and
// writes every other product and sum with __fmul_rn / __fadd_rn, which
// nvcc never contracts, so its output equals the plain
// PyTorch version (ops/kernels/symsync_scan.py, which computes the same
// FMAs exactly in float64) bit for bit.  rintf rounds half to even.
//
// Layout: ma [P, B, 2*npfb, Tc] float32 as conv1d leaves it (row
// p*B + b, branch rows 0..npfb-1 the MF, npfb.. the dMF), so each channel
// reads its own contiguous time axis.  The branch index moves slowly (a
// fractional timing phase), so a thread's reads of steps t, t+1, ...
// fall on the same four 128-byte lines: mostly L1 hits.
//
// Bound on this card: latency, not bandwidth.  Each emit's branch read
// depends on the previous emit's tau, so a channel is one chain of
// dependent loads and float ops; at B = 256 only 256 threads run.  The
// design is the simple one: one thread per channel, the state in
// registers, a loop over time inside the thread (the TPU's sequential
// 32-step grid is gone), 32 threads per block so the channels spread
// over B/32 SMs.  Prefetching the next step's lines and more threads per
// SM are later work.
//
// Built by liquid_dsp_tpu_torch/ops/kernels/build.py with nvcc for sm_90a,
// bound with ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;

__global__ void __launch_bounds__(THREADS)
symsync_scan_kernel(const float* __restrict__ ma, float* __restrict__ fstate,
                    int* __restrict__ istate, float* __restrict__ y_re,
                    float* __restrict__ y_im,
                    unsigned char* __restrict__ valid, int B, int Tc,
                    int npfb, int P, int max_out, int k_out, int locked,
                    float inv_k, float c_q, float c_v, float c_r) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  float tau = fstate[b], rate = fstate[B + b], dl = fstate[2 * B + b];
  float v0 = fstate[3 * B + b], bf = fstate[4 * B + b];
  float ran = fstate[5 * B + b];
  int bi = istate[b], decim = istate[B + b];

  const size_t row = static_cast<size_t>(2 * npfb) * Tc;
  const float* mre = ma + static_cast<size_t>(b) * row;
  const float* mim = mre + static_cast<size_t>(B) * row;
  const size_t o0 = static_cast<size_t>(b) * Tc * max_out;
  const float fnpfb = static_cast<float>(npfb);

  for (int t = 0; t < Tc; ++t) {
    for (int e = 0; e < max_out; ++e) {
      const bool active = bi < npfb;
      float mf_re = 0.f, dmf_re = 0.f, mf_im = 0.f, dmf_im = 0.f;
      if (active) {
        const int bc = bi < 0 ? 0 : bi;
        mf_re = __ldg(mre + static_cast<size_t>(bc) * Tc + t);
        dmf_re = __ldg(mre + static_cast<size_t>(npfb + bc) * Tc + t);
        if (P == 2) {
          mf_im = __ldg(mim + static_cast<size_t>(bc) * Tc + t);
          dmf_im = __ldg(mim + static_cast<size_t>(npfb + bc) * Tc + t);
        }
      }
      const float q_raw = P == 2
          ? __fmaf_rn(mf_re, dmf_re, __fmul_rn(mf_im, dmf_im))
          : __fmul_rn(mf_re, dmf_re);
      const bool run = decim == k_out && active && !locked;
      // clip(q, -1, 1) as selects (a NaN passes, as in jnp.clip)
      const float q = q_raw < -1.f ? -1.f : (q_raw > 1.f ? 1.f : q_raw);
      const float q_hat = __fmaf_rn(c_q, q, v0);
      const float v0n = __fmul_rn(c_v, q_hat);
      const float rn = __fmaf_rn(c_r, q_hat, rate);
      const float dn = __fadd_rn(rn, q_hat);
      tau = __fadd_rn(tau, active ? dl : 0.f);
      if (run) {
        rate = rn;
        dl = dn;
        v0 = v0n;
      }
      ran = fmaxf(ran, run ? 1.f : 0.f);
      if (active) decim = decim == k_out ? 1 : decim + 1;
      bf = __fmul_rn(tau, fnpfb);
      bi = static_cast<int>(rintf(bf));
      const size_t o = o0 + static_cast<size_t>(t) * max_out + e;
      y_re[o] = active ? __fmul_rn(mf_re, inv_k) : 0.f;
      y_im[o] = active ? __fmul_rn(mf_im, inv_k) : 0.f;
      valid[o] = active ? 1 : 0;
    }
    tau = __fadd_rn(tau, -1.f);
    bf = __fadd_rn(bf, -fnpfb);
    bi -= npfb;
  }
  fstate[b] = tau;
  fstate[B + b] = rate;
  fstate[2 * B + b] = dl;
  fstate[3 * B + b] = v0;
  fstate[4 * B + b] = bf;
  fstate[5 * B + b] = ran;
  istate[b] = bi;
  istate[B + b] = decim;
}

}  // namespace

// ma: [P, B, 2*npfb, Tc] float32, contiguous, P in {1, 2}.  fstate: [6, B]
// float32 and istate: [2, B] int32, read and overwritten in place.
// y_re, y_im: [B, Tc*max_out] float32; valid: [B, Tc*max_out] bytes (0/1).
// inv_k: 1/k; c_q, c_v, c_r: B0/A0, -A1/A0 and rate_adj; all rounded to
// float32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int symsync_scan_launch(const void* ma, void* fstate, void* istate,
                                   void* y_re, void* y_im, void* valid, int B,
                                   int Tc, int npfb, int P, int max_out,
                                   int k_out, int locked, float inv_k,
                                   float c_q,
                                   float c_v, float c_r, void* stream) {
  if (B < 1 || Tc < 1 || npfb < 1 || max_out < 1 || (P != 1 && P != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + THREADS - 1) / THREADS);
  symsync_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ma), static_cast<float*>(fstate),
      static_cast<int*>(istate), static_cast<float*>(y_re),
      static_cast<float*>(y_im), static_cast<unsigned char*>(valid), B, Tc,
      npfb, P, max_out, k_out, locked, inv_k, c_q, c_v, c_r);
  return static_cast<int>(cudaGetLastError());
}
