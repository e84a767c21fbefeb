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
// What bounds it: neither bytes nor operations (0.8% of the bound in its
// first form) but the latency of one trellis step, T times over, on one
// dependent chain per codeword.  So the design keeps that chain short.
//
// The warp form (64 <= ns <= 256, every scheme the decoders launch): one
// warp per codeword, no block barrier.
// * Lane l holds states l + 32 i in register i < NR = ns / 32.  The
//   predecessors of state l + 32 i are (l >> 1) + 16 i and that + ns/2,
//   both in lane (l >> 1) + 16 (i & 1), registers i >> 1 and
//   (i >> 1) + NR/2: 2 NR shuffles a step from fixed lanes, independent
//   of each other.
// * The metrics stay unnormalized; the step's state max M is subtracted
//   when they are read, which is the plain version's normalized metric
//   with the same rounding.  M comes from two REDUX (__reduce_max_sync
//   and __reduce_min_sync, side by side) over the bits of each lane's
//   max as signed ints: a float >= +0 orders as its bits do and lies
//   above every negative one, among which the order is reversed; so the
//   int max is M when it is >= 0, else the int min is, and in both cases
//   M is the larger of the two as floats (one fmaxf).  A max of floats
//   (fmaxf here, torch.maximum there) may return either zero of +-0; the
//   two differ only in the sign of a zero, which changes no compare (a
//   zero of either sign adds to a nonzero metric exactly and compares
//   equal), so the decisions and the bits are the same (the numpy walk
//   in tests/test_torch_kernel_identities.py covers +-0 metrics).
// * The chain of a step is M -> two adds -> max -> the lane's max ->
//   REDUX -> fmaxf; the compare, the predecessor shuffles and the
//   branch metrics run beside it.  The metrics of 32 steps are loaded a
//   tile ahead, one step per lane, and broadcast by shuffle; the branch
//   metrics are the plain version's products and sums (exp need not be
//   +-1).
// * The decisions of register i are __ballot_sync's word: word i of the
//   packed layout (bit s & 31 of word s >> 5).  Lane l keeps the words of
//   step t0 + l of its tile and writes them whole at the tile's end, to
//   shared memory while T * ns / 8 bytes fit (WARPS codewords a block),
//   and to the caller's buffer in device memory where it asks for them
//   or they do not fit.
// * The tiles are run in unrolled runs of 8 steps; a last partial run
//   steps on past T on zero metrics, and its decisions are not kept.
// * Traceback: the warp walks it together, each lane on the same state;
//   the words of a run of 8 steps are loaded during the run before (their
//   addresses do not depend on the state), every word of a step is
//   rotated (by log2(ns/2) at its load, by the state on the chain) so
//   that the state's bit lands on the bit of ns/2, and the chain is the
//   select of the word by the state's high bits and one or.  The warp
//   shifts each step's bit into one word and every 32 steps writes its 32
//   bits at once, lane l bit l.  nout = 0 skips it (nothing to write).
//   It stays a single walk: it is about a fifth of the kernel's time
//   (PERF.md section 7 has the step's cycles and what sets them).
//
// The block form (ns of 32, 512 and 1024; no decoder launches these, but
// the wrapper takes 32 <= ns <= 1024): one thread block per codeword, one
// thread per next state, the metrics double-buffered in shared memory,
// one __syncthreads a step after which every thread forms M from the
// warps' maxima, thread 0 walking the traceback.
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

constexpr int TILE = 64;               // block form: steps staged at a time
constexpr int MAX_WARPS = 32;          // ns <= 1024
constexpr int DEC_SMEM_MAX = 32768;    // decision bytes kept in shared memory
constexpr int WARPS = 4;               // warp form: codewords per block
constexpr int RUN = 8;                 // warp form: steps unrolled together
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e9f;

// The warp form: NR = ns / 32 registers a lane, R streams.
template <int NR, int R>
__global__ void __launch_bounds__(WARPS * 32)
viterbi_warp_kernel(const float* __restrict__ obs,
                    const float* __restrict__ exp, int* __restrict__ bits,
                    unsigned* __restrict__ dec_global, int N, int T,
                    int nout, int dec_in_smem) {
  extern __shared__ __align__(16) unsigned dsm[];
  constexpr int NS = 32 * NR;
  constexpr int H = NR / 2;
  constexpr int LOG_HALF = NR == 2 ? 5 : NR == 4 ? 6 : 7;   // log2(NS / 2)
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int n = blockIdx.x * WARPS + w;
  if (n >= N) return;

  // the expected outputs of each register's two incoming branches
  float e0[NR][R], e1[NR][R];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int p0 = (lane >> 1) + 16 * i;
    const int b = lane & 1;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      e0[i][k] = exp[(p0 * 2 + b) * R + k];
      e1[i][k] = exp[((p0 + NS / 2) * 2 + b) * R + k];
    }
  }
  float pm[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) pm[i] = (i == 0 && lane == 0) ? 0.0f : NEG;
  float M = 0.0f;                         // the last step's state max

  unsigned* dec_s = dsm + static_cast<size_t>(w) * T * NR;  // if dec_in_smem
  unsigned* dec_g = dec_global != nullptr
      ? dec_global + static_cast<size_t>(n) * T * NR : nullptr;
  const float* ob = obs + static_cast<size_t>(n) * T * R;
  const int src_a = lane >> 1, src_b = (lane >> 1) + 16;

  float o_cur[R];
#pragma unroll
  for (int k = 0; k < R; ++k) o_cur[k] = lane < T ? ob[lane * R + k] : 0.0f;

  for (int t0 = 0; t0 < T; t0 += 32) {
    float o_nxt[R];                       // the next tile, loaded ahead
    const int tn = t0 + 32 + lane;
#pragma unroll
    for (int k = 0; k < R; ++k) o_nxt[k] = tn < T ? ob[tn * R + k] : 0.0f;
    unsigned wd[NR];                      // step t0 + lane's words
#pragma unroll
    for (int i = 0; i < NR; ++i) wd[i] = 0u;
    const int len = min(32, T - t0);
    for (int u0 = 0; u0 < len; u0 += RUN) {
#pragma unroll
      for (int u = 0; u < RUN; ++u) {
        const int tt = u0 + u;
        float o[R];
#pragma unroll
        for (int k = 0; k < R; ++k) o[k] = __shfl_sync(FULL, o_cur[k], tt);
        float qa[NR], qb[NR];
#pragma unroll
        for (int k = 0; k < NR; ++k) {
          qa[k] = __shfl_sync(FULL, pm[k], src_a);
          qb[k] = __shfl_sync(FULL, pm[k], src_b);
        }
        const bool mine = lane == tt;
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const float q0 = (i & 1) ? qb[i >> 1] : qa[i >> 1];
          const float q1 = (i & 1) ? qb[(i >> 1) + H] : qa[(i >> 1) + H];
          float bm0 = __fmul_rn(e0[i][0], o[0]);
          float bm1 = __fmul_rn(e1[i][0], o[0]);
#pragma unroll
          for (int k = 1; k < R; ++k) {
            bm0 = __fadd_rn(bm0, __fmul_rn(e0[i][k], o[k]));
            bm1 = __fadd_rn(bm1, __fmul_rn(e1[i][k], o[k]));
          }
          const float c0 = __fadd_rn(__fsub_rn(q0, M), bm0);
          const float c1 = __fadd_rn(__fsub_rn(q1, M), bm1);
          const bool j = c1 > c0;
          pm[i] = fmaxf(c0, c1);
          const unsigned word = __ballot_sync(FULL, j);
          wd[i] = mine ? word : wd[i];
        }
        float mx[NR];                     // the lane's max, as a tree
#pragma unroll
        for (int i = 0; i < NR; ++i) mx[i] = pm[i];
#pragma unroll
        for (int span = 1; span < NR; span <<= 1)
#pragma unroll
          for (int i = 0; i + span < NR; i += 2 * span)
            mx[i] = fmaxf(mx[i], mx[i + span]);
        const int hi = __reduce_max_sync(FULL, __float_as_int(mx[0]));
        const int lo = __reduce_min_sync(FULL, __float_as_int(mx[0]));
        M = fmaxf(__int_as_float(hi), __int_as_float(lo));
      }
    }
    if (lane < len) {
      const size_t row = static_cast<size_t>(t0 + lane) * NR;
#pragma unroll
      for (int i = 0; i < NR; i += 2) {
        const uint2 v = make_uint2(wd[i], wd[i + 1]);
        if (dec_in_smem) *reinterpret_cast<uint2*>(dec_s + row + i) = v;
        if (dec_g != nullptr) *reinterpret_cast<uint2*>(dec_g + row + i) = v;
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) o_cur[k] = o_nxt[k];
  }
  if (nout == 0) return;
  __syncwarp();

  // traceback: every lane walks the same states, from shared memory or
  // from the device buffer (two copies, so that each load is the plain
  // one of its space)
  int* out = bits + static_cast<size_t>(n) * nout;
  auto walk = [&](const unsigned* dec) {
    int st = 0;
    unsigned keep = 0;                    // bit t & 31: the bit of step t
    auto load = [&](int t, unsigned (&v)[NR]) {
      const unsigned* row = dec + static_cast<size_t>(t) * NR;
#pragma unroll
      for (int i = 0; i < NR; i += 2) {   // rotated left by log2(ns/2)
        const uint2 p = *reinterpret_cast<const uint2*>(row + i);
        v[i] = __funnelshift_l(p.x, p.x, LOG_HALF);
        v[i + 1] = __funnelshift_l(p.y, p.y, LOG_HALF);
      }
    };
    auto step = [&](int t, const unsigned (&v)[NR]) {
      // every word, rotated left by log2(ns/2) at its load, rotated right
      // by st, so that its bit st & 31 lands on the bit of ns/2, all at
      // once; then the word st >> 5 is selected
      unsigned x[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i) x[i] = __funnelshift_r(v[i], v[i], st);
#pragma unroll
      for (int span = 1; span < NR; span <<= 1) {
        const bool hi = (st >> 5) & span;
#pragma unroll
        for (int i = 0; i + span < NR; i += 2 * span)
          x[i] = hi ? x[i + span] : x[i];
      }
      keep = (keep << 1) | (st & 1);
      st = (st >> 1) | static_cast<int>(x[0] & (NS / 2));
    };
    auto put = [&](int t) {             // after step t, a multiple of 32
      if (t + lane < nout) out[t + lane] = (keep >> lane) & 1;
    };
    int t = T - 1;
    for (; (t + 1) % RUN != 0; --t) {
      unsigned v[NR];
      load(t, v);
      step(t, v);
      if ((t & 31) == 0) put(t);
    }
    if (t < 0) return;
    unsigned cur[RUN][NR];
#pragma unroll
    for (int u = 0; u < RUN; ++u) load(t - u, cur[u]);
    for (; t >= 0; t -= RUN) {
      unsigned nxt[RUN][NR];              // the next run, loaded ahead
#pragma unroll
      for (int u = 0; u < RUN; ++u) load(max(t - RUN - u, 0), nxt[u]);
#pragma unroll
      for (int u = 0; u < RUN; ++u) step(t - u, cur[u]);
      if (((t - RUN + 1) & 31) == 0) put(t - RUN + 1);
#pragma unroll
      for (int u = 0; u < RUN; ++u)
#pragma unroll
        for (int i = 0; i < NR; ++i) cur[u][i] = nxt[u][i];
    }
  };
  if (dec_in_smem) {
    walk(dec_s);
  } else {
    walk(dec_g);
  }
}

// The block form: one block per codeword, one thread per next state.
template <int R>
__global__ void viterbi_block_kernel(const float* __restrict__ obs,
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
        wm = fmaxf(wm, __shfl_xor_sync(FULL, wm, off));
      const unsigned word = __ballot_sync(FULL, j);
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

template <int NR, int R>
int launch_warp(const float* obs, const float* exp, int* bits, unsigned* dec,
                int N, int T, int nout, cudaStream_t stream) {
  const bool in_smem = static_cast<long long>(T) * NR * 4 <= DEC_SMEM_MAX;
  const size_t smem = in_smem ? sizeof(unsigned) * WARPS * NR *
                                    static_cast<size_t>(T) : 0;
  if (smem > 48 * 1024) {                 // the opt-in above 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        viterbi_warp_kernel<NR, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  viterbi_warp_kernel<NR, R><<<(N + WARPS - 1) / WARPS, WARPS * 32, smem,
                               stream>>>(obs, exp, bits, dec, N, T, nout,
                                         in_smem ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch_block(const float* obs, const float* exp, int* bits, unsigned* dec,
                 int N, int T, int ns, int nout, cudaStream_t stream) {
  size_t smem = sizeof(float) * (2 * ns + 2 * MAX_WARPS + TILE * R);
  if (dec == nullptr) smem += sizeof(unsigned) * static_cast<size_t>(T) * (ns >> 5);
  viterbi_block_kernel<R><<<N, ns, smem, stream>>>(obs, exp, bits, dec, T,
                                                   ns, nout);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch(const float* obs, const float* exp, int* bits, unsigned* dec,
           int N, int T, int ns, int nout, cudaStream_t stream) {
  if (ns == 64) return launch_warp<2, R>(obs, exp, bits, dec, N, T, nout, stream);
  if (ns == 128) return launch_warp<4, R>(obs, exp, bits, dec, N, T, nout, stream);
  if (ns == 256) return launch_warp<8, R>(obs, exp, bits, dec, N, T, nout, stream);
  return launch_block<R>(obs, exp, bits, dec, N, T, ns, nout, stream);
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
