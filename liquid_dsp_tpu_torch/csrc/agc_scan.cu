// The AGC gain recurrence over instantaneous power, for Hopper (sm_90a).
//
// Replaces the lax.scan of liquid_dsp_tpu/ops/agc.py:39-50 (agc_scan and
// the agc Proc's planar_apply); the JAX package has no Pallas kernel
// here, and PyTorch has no scan that stays on the device.
//
// What it computes, per channel b and sample t (agc.py:41-46):
//   y2p = (1-alpha)*y2p + (alpha*(g*g))*p[b, t]
//   gains[b, t] = g
//   unless locked: g = y2p > 1e-6 ? g*expf((-alpha/2)*logf(y2p)) : g;
//                  g = min(g, 1e6)
// The caller scales x by the gains outside, as the JAX package does.
//
// Numerics: every product and sum is written with __fmul_rn / __fadd_rn,
// which nvcc never contracts into an FMA, in the order above; expf and
// logf are the accurate library functions (never __expf), as PyTorch's
// own exp and log on the card.  So the kernel equals the plain PyTorch
// version (ops/kernels/agc_scan.py) bit for bit on the card.
//
// Bound on this card: latency.  Each sample's gain depends on the last
// (a log and an exp in the chain), so one thread per channel walks its
// own time axis with (g, y2p) in registers; a thread's reads and writes
// of samples t, t+1, ... share 128-byte lines.  32 threads per block
// spread the channels over SMs.  Channels are few (hundreds), so the
// card is mostly idle: splitting the time axis needs the recurrence in a
// closed form it does not have.
//
// Built by liquid_dsp_tpu_torch/ops/kernels/build.py with nvcc for sm_90a,
// bound with ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;

__global__ void __launch_bounds__(THREADS)
agc_scan_kernel(const float* __restrict__ p, float* __restrict__ g_io,
                float* __restrict__ y2p_io, float* __restrict__ gains, int B,
                int T, int locked, float c1, float ca, float ch) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  float g = g_io[b], y2p = y2p_io[b];
  const float* pb = p + static_cast<size_t>(b) * T;
  float* ob = gains + static_cast<size_t>(b) * T;
  for (int t = 0; t < T; ++t) {
    y2p = __fadd_rn(__fmul_rn(c1, y2p),
                    __fmul_rn(__fmul_rn(ca, __fmul_rn(g, g)), pb[t]));
    ob[t] = g;
    if (!locked) {
      if (y2p > 1e-6f) g = __fmul_rn(g, expf(__fmul_rn(ch, logf(y2p))));
      g = fminf(g, 1e6f);
    }
  }
  g_io[b] = g;
  y2p_io[b] = y2p;
}

}  // namespace

// p: [B, T] float32, contiguous.  g, y2p: [B] float32, read and
// overwritten in place.  gains: [B, T] float32.  c1, ca, ch: 1-alpha,
// alpha and -alpha/2 rounded to float32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int agc_scan_launch(const void* p, void* g, void* y2p, void* gains,
                               int B, int T, int locked, float c1, float ca,
                               float ch, void* stream) {
  if (B < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + THREADS - 1) / THREADS);
  agc_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<float*>(g),
      static_cast<float*>(y2p), static_cast<float*>(gains), B, T, locked, c1,
      ca, ch);
  return static_cast<int>(cudaGetLastError());
}
