// The CVSD codec's per-sample recurrence, for Hopper (sm_90a).
//
// Replaces the lax.scans of liquid_dsp_tpu/utils/audio.py:41-52
// (cvsd_encode) and :62-84 (cvsd_decode with its post-emphasis); the JAX
// package has no Pallas kernel here, and PyTorch has no scan that stays on
// the device.
//
// What it computes, per row r (one audio stream) and sample t, from
// ref = 0, delta = 0.01, bitref = 0 (audio.py:41-50 and :62-70):
//   encode: y = x[t] - alpha*x[t-1]   (x[-1] = 0: the pre-emphasis)
//           bit = ref <= y
//   decode: bit = bits[t]
//   both:   bitref = ((bitref << 1) | bit) & mask
//           delta  = bitref in {0, mask} ? delta*zeta : delta*(1/zeta)
//           delta  = min(max(delta, 0.01), 1)
//           ref    = min(max(ref + (bit == 1 ? delta : -delta), -1), 1)
//   encode writes bit (uint8); decode runs ref through the post-emphasis
//   DF2T of audio.py:77-84 in the same thread and writes its output:
//           yt = ref + v0
//           v0 = fma(-a1, yt, -ref) + v1,  v1 = (-a2)*yt
//
// Numerics: every operation is rounded once and written explicitly
// (__fmul_rn, __fadd_rn, __fsub_rn, __fmaf_rn), as XLA's CPU build rounds
// the JAX scans: the division by zeta is a product by the float32 1/zeta
// (XLA folds a division by a constant), and the post-emphasis takes
// -xt - a1*yt as one fused multiply-add.  The JAX package's encoder runs
// its pre-emphasis outside the scan, op by op: a product, then a
// difference.  The plain PyTorch version (ops/kernels/cvsd_scan.py,
// cvsd_scan_reference) takes the same operations in the same order, an
// exact FMA where this takes __fmaf_rn, so the two agree bit for bit.
//
// Design: one thread per row, 32 rows a block so that the rows spread
// over the SMs, the row's own state in registers.  A row is one dependent
// chain (delta's product and clamps, then ref's sum and clamps), so the
// time is T times that chain whatever the row count up to the card's 132
// SMs x 4 schedulers; the bytes (5 a sample) are nothing beside it.  The
// next 8 samples' loads are issued before the current 8 run on the chain
// (all predicated: one basic block a chunk).  A simple kernel, not yet
// redesigned (ROADMAP queue 2b).  Measured on an H100 (80GB HBM3, 700 W;
// chip_smoke.py phase 38): a lone decode row 75 cycles a sample; at 1024
// rows x 32768 samples decode 2.27 ms, 1.83 times a lone row's loop (each
// thread reads its own row from device memory), encode 3.60 ms.
//
// Built by liquid_dsp_tpu_torch/ops/kernels/build.py with nvcc for sm_90a,
// bound with ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 32;    // threads (rows) a block
constexpr int CHUNK = 8;    // samples loaded ahead of the chain

struct Params {
  unsigned mask;
  float zeta, rzeta;        // zeta and the float32 1/zeta
  float alpha;              // encode: the pre-emphasis
  float na1, na2;           // decode: -a1 and -a2 of the post-emphasis
};

// One step of the adaptive slope; returns the new ref.
__device__ __forceinline__ float slope(unsigned bit_in, unsigned& bitref,
                                       float& delta, float ref,
                                       const Params& p) {
  bitref = ((bitref << 1) | bit_in) & p.mask;
  const bool agree = (bitref == 0u) | (bitref == p.mask);
  delta = __fmul_rn(delta, agree ? p.zeta : p.rzeta);
  delta = fminf(fmaxf(delta, 0.01f), 1.0f);
  ref = __fadd_rn(ref, bit_in == 1u ? delta : -delta);
  return fminf(fmaxf(ref, -1.0f), 1.0f);
}

__global__ void __launch_bounds__(ROWS)
    cvsd_encode_kernel(const float* __restrict__ x, uint8_t* __restrict__ bits,
                       int rows, int T, Params p) {
  const int r = blockIdx.x * ROWS + threadIdx.x;
  if (r >= rows) return;
  const float* xr = x + static_cast<size_t>(r) * T;
  uint8_t* br = bits + static_cast<size_t>(r) * T;
  float ref = 0.f, delta = 0.01f, prev = 0.f;
  unsigned bitref = 0u;
  float cur[CHUNK], nxt[CHUNK];
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) cur[j] = j < T ? xr[j] : 0.f;
  for (int t0 = 0; t0 < T; t0 += CHUNK) {
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
      nxt[j] = t0 + CHUNK + j < T ? xr[t0 + CHUNK + j] : 0.f;
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const float y = __fsub_rn(cur[j], __fmul_rn(p.alpha, prev));
      prev = cur[j];
      const unsigned bit = ref <= y ? 1u : 0u;
      const float ref2 = slope(bit, bitref, delta, ref, p);
      if (t0 + j < T) {
        br[t0 + j] = static_cast<uint8_t>(bit);
        ref = ref2;
      }
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) cur[j] = nxt[j];
  }
}

__global__ void __launch_bounds__(ROWS)
    cvsd_decode_kernel(const uint8_t* __restrict__ bits,
                       float* __restrict__ audio, int rows, int T, Params p) {
  const int r = blockIdx.x * ROWS + threadIdx.x;
  if (r >= rows) return;
  const uint8_t* br = bits + static_cast<size_t>(r) * T;
  float* yr = audio + static_cast<size_t>(r) * T;
  float ref = 0.f, delta = 0.01f, v0 = 0.f, v1 = 0.f;
  unsigned bitref = 0u;
  unsigned cur[CHUNK], nxt[CHUNK];
#pragma unroll
  for (int j = 0; j < CHUNK; ++j)
    cur[j] = j < T ? static_cast<unsigned>(br[j]) : 0u;
  for (int t0 = 0; t0 < T; t0 += CHUNK) {
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
      nxt[j] = t0 + CHUNK + j < T ? static_cast<unsigned>(br[t0 + CHUNK + j])
                                  : 0u;
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      // a past-the-end step changes nothing: its state is not kept
      unsigned bitref2 = bitref;
      float delta2 = delta;
      const float x = slope(cur[j], bitref2, delta2, ref, p);
      const float yt = __fadd_rn(x, v0);
      const float v0n = __fadd_rn(__fmaf_rn(p.na1, yt, -x), v1);
      const float v1n = __fmul_rn(p.na2, yt);
      if (t0 + j < T) {
        yr[t0 + j] = yt;
        ref = x;
        bitref = bitref2;
        delta = delta2;
        v0 = v0n;
        v1 = v1n;
      }
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) cur[j] = nxt[j];
  }
}

}  // namespace

// mode 0: encode float32 x [rows, T] -> uint8 bits; mode 1: decode uint8
// bits -> float32 audio.  `a` is alpha for encode and -a1 for decode, `b`
// is -a2 (decode only).
extern "C" int cvsd_scan_launch(const void* in, void* out, int rows, int T,
                                int mode, unsigned mask, float zeta,
                                float rzeta, float a, float b, void* stream) {
  if (rows < 0 || T < 0 || mode < 0 || mode > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || T == 0) return 0;
  const Params p{mask, zeta, rzeta, a, a, b};
  const dim3 grid((rows + ROWS - 1) / ROWS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    cvsd_encode_kernel<<<grid, ROWS, 0, s>>>(
        static_cast<const float*>(in), static_cast<uint8_t*>(out), rows, T, p);
  else
    cvsd_decode_kernel<<<grid, ROWS, 0, s>>>(
        static_cast<const uint8_t*>(in), static_cast<float*>(out), rows, T, p);
  return static_cast<int>(cudaGetLastError());
}
