// The Viterbi add-compare-select recurrence and its traceback, for Hopper
// (sm_90a).
//
// Replaces the two lax.scans of liquid_dsp_tpu/fec/device.py:171-271
// (conv_soft_decoder's device_fn after the depuncture); the JAX package
// has no Pallas kernel here, and PyTorch has no scan that stays on the
// device.
//
// What it computes, per codeword n (obs [N, T, R] float32 depunctured
// metrics, exp [ns, 2, R] float32 +-1, half = ns / 2):
//   pm = -1e9 everywhere except pm[0] = 0;
//   per step t and next state s' (p0 = s' >> 1, p1 = p0 + half, b = s' & 1):
//     bm_i   = ((exp[p_i, b, 0] * o[0]) + exp[p_i, b, 1] * o[1]) + ...
//     cand_i = pm[p_i] + bm_i
//     j      = cand1 > cand0            (a tie takes p0)
//     pm'    = max(cand0, cand1) - max over states of max(cand0, cand1);
//   traceback from state 0: bit[t] = s & 1, s = (s >> 1) + j[t][s] * half;
//   bits[n, t] for t < nout.
//
// Design (a simple one; the recurrence is one dependent chain per
// codeword, so the bound of bytes and operations is far away):
// * One thread block per codeword, one thread per next state (64 for K=7,
//   256 for K=9).  Each thread keeps the expected outputs of its two
//   incoming branches in registers.
// * The path metrics live in shared memory, double-buffered, unnormalized:
//   step t writes max(cand0, cand1) and the warp's max, and after the one
//   __syncthreads of the step every thread forms the state max M from the
//   warps' maxima.  Step t+1 then reads pm[p] - M, which is the plain
//   version's normalized metric with the same rounding.  The max is exact
//   in any order.
// * The decisions are one bit per state, a warp's 32 packed by
//   __ballot_sync into one word: word (s >> 5) of step t, bit (s & 31).
//   They stay in shared memory while T * ns / 8 bytes fit (17.6 KB for K=9
//   at T = 550), else (and when the caller asks for them) they go to a
//   buffer in device memory.
// * The metrics of 64 steps at a time are staged in shared memory; every
//   thread reads the same R values a step (a broadcast).
// * Thread 0 walks the traceback alone.
//
// Numerics: __fmul_rn / __fadd_rn / __fsub_rn, so nvcc contracts nothing;
// ops/kernels/viterbi_acs.py:viterbi_acs_reference takes the same
// operations in the same order, and the two agree bit for bit in bits and
// decisions.
//
// Built by liquid_dsp_tpu_torch/ops/kernels/build.py with nvcc for sm_90a,
// bound with ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;               // steps of metrics staged at a time
constexpr int MAX_WARPS = 32;          // ns <= 1024
constexpr int DEC_SMEM_MAX = 32768;    // decision bytes kept in shared memory
constexpr float NEG = -1e9f;

template <int R>
__global__ void viterbi_acs_kernel(const float* __restrict__ obs,
                                   const float* __restrict__ exp,
                                   int* __restrict__ bits,
                                   unsigned* __restrict__ dec_global,
                                   int T, int ns, int nout) {
  extern __shared__ float smem[];
  const int s = threadIdx.x;
  const int lane = s & 31;
  const int warp = s >> 5;
  const int nw = ns >> 5;
  const int half = ns >> 1;
  const int n = blockIdx.x;

  float* pm = smem;                       // [2][ns] unnormalized metrics
  float* red = pm + 2 * ns;               // [2][MAX_WARPS] warp maxima
  float* ob = red + 2 * MAX_WARPS;        // [TILE * R] staged metrics
  unsigned* dec = dec_global != nullptr
      ? dec_global + static_cast<size_t>(n) * T * nw
      : reinterpret_cast<unsigned*>(ob + TILE * R);   // [T][nw]

  const int p0 = s >> 1;
  const int p1 = p0 + half;
  const int b = s & 1;
  float e0[R], e1[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    e0[k] = exp[(p0 * 2 + b) * R + k];
    e1[k] = exp[(p1 * 2 + b) * R + k];
  }
  pm[s] = s == 0 ? 0.0f : NEG;
  float M = 0.0f;                         // the last step's state max
  int cur = 0;
  const float* ob_n = obs + static_cast<size_t>(n) * T * R;

  for (int t0 = 0; t0 < T; t0 += TILE) {
    const int len = min(TILE, T - t0);
    for (int i = s; i < len * R; i += ns) ob[i] = ob_n[t0 * R + i];
    __syncthreads();
    for (int tt = 0; tt < len; ++tt) {
      const float* o = ob + tt * R;
      float bm0 = __fmul_rn(e0[0], o[0]);
      float bm1 = __fmul_rn(e1[0], o[0]);
#pragma unroll
      for (int k = 1; k < R; ++k) {
        bm0 = __fadd_rn(bm0, __fmul_rn(e0[k], o[k]));
        bm1 = __fadd_rn(bm1, __fmul_rn(e1[k], o[k]));
      }
      const float c0 = __fadd_rn(__fsub_rn(pm[cur * ns + p0], M), bm0);
      const float c1 = __fadd_rn(__fsub_rn(pm[cur * ns + p1], M), bm1);
      const bool j = c1 > c0;
      const float m = j ? c1 : c0;
      const int nxt = cur ^ 1;
      pm[nxt * ns + s] = m;
      float wm = m;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        wm = fmaxf(wm, __shfl_xor_sync(0xffffffffu, wm, off));
      const unsigned word = __ballot_sync(0xffffffffu, j);
      if (lane == 0) {
        red[nxt * MAX_WARPS + warp] = wm;
        dec[static_cast<size_t>(t0 + tt) * nw + warp] = word;
      }
      __syncthreads();
      M = red[nxt * MAX_WARPS];
      for (int w = 1; w < nw; ++w) M = fmaxf(M, red[nxt * MAX_WARPS + w]);
      cur = nxt;
    }
  }

  if (s == 0) {
    int st = 0;
    int* out = bits + static_cast<size_t>(n) * nout;
    for (int t = T - 1; t >= 0; --t) {
      const unsigned w = dec[static_cast<size_t>(t) * nw + (st >> 5)];
      if (t < nout) out[t] = st & 1;
      st = (st >> 1) + static_cast<int>((w >> (st & 31)) & 1u) * half;
    }
  }
}

template <int R>
int launch(const float* obs, const float* exp, int* bits, unsigned* dec,
           int N, int T, int ns, int nout, cudaStream_t stream) {
  size_t smem = sizeof(float) * (2 * ns + 2 * MAX_WARPS + TILE * R);
  if (dec == nullptr) smem += sizeof(unsigned) * static_cast<size_t>(T) * (ns >> 5);
  viterbi_acs_kernel<R><<<N, ns, smem, stream>>>(obs, exp, bits, dec, T, ns,
                                                  nout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The most decision bytes (T * ns / 8) a codeword keeps in shared memory;
// the wrapper reads it here to choose between the two layouts.
extern "C" int viterbi_acs_dec_smem_max() { return DEC_SMEM_MAX; }

// obs [N, T, r] f32, exp [ns, 2, r] f32, bits [N, nout] i32; dec: null to
// keep the decisions in shared memory (T * ns / 8 <= DEC_SMEM_MAX bytes),
// else [N, T, ns / 32] u32 in device memory, filled with them.
extern "C" int viterbi_acs_launch(const void* obs, const void* exp,
                                  void* bits, void* dec, int N, int T, int r,
                                  int ns, int nout, void* stream) {
  if (N < 1 || T < 1 || nout < 0 || nout > T || ns < 32 || ns > 1024 ||
      (ns & (ns - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dec == nullptr && static_cast<long long>(T) * (ns >> 3) > DEC_SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* o = static_cast<const float*>(obs);
  const auto* e = static_cast<const float*>(exp);
  auto* bt = static_cast<int*>(bits);
  auto* d = static_cast<unsigned*>(dec);
  auto st = static_cast<cudaStream_t>(stream);
  if (r == 2) return launch<2>(o, e, bt, d, N, T, ns, nout, st);
  if (r == 3) return launch<3>(o, e, bt, d, N, T, ns, nout, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
