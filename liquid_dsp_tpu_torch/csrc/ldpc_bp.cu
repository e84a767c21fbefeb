// LDPC belief propagation's iteration loop and the decode's decisions, for
// Hopper (sm_90a).
//
// Replaces the lax.scan of liquid_dsp_tpu/fec/ldpc.py:225-241 (the
// batched decoder's `step`, max_iters times over the message array Rv)
// and the posterior, hard decisions and syndrome after it (:243-250); the
// JAX package has no Pallas kernel here.  One launch runs every iteration
// for every codeword, from the LLRs and the maps of the real edges
// (ops/kernels/ldpc_bp.py's `compact_maps`, built once on the host from
// `_slot_maps`), and writes the final variable-side messages Rv [R, n*wc
// + 1] in the padded slot layout (pads 0), the decisions hard [R, n]
// (post < 0) and the parity verdict ok [R], each where asked.
//
// The plain version (ops/kernels/ldpc_bp.py) walks padded slots: a check
// has wr slots, its deg real edges first (`_slot_maps` counts a check's
// slots up in edge order), its pads after, each pad Q = neutral.  The
// kernel walks the real edges only and takes the pads' part in closed
// form, with the same bits:
//   sum-product: a pad's lt is one constant, computed here on the card
//     with the pad's own expression log(max(|clamp(tanh(neutral/2))|,
//     tiny)), added wr - deg times after the real edges: the plain
//     version's slot-order sum; a pad's t is +sat, no negative.  A pad's
//     message is never read.
//   min-sum: a pad's |Q| is inf; with the strict < it moves neither m1,
//     m2 nor the first slot (a degree-1 check still sends cap).
//   variable side: the pads add +0.0 after the real messages; x + 0 + 0
//     = x + 0, so one add of 0 stands for them.
// An iteration is four phases, a barrier after each:
//   1. per edge e: Q = post[var(e)] - msg[e]; sum-product: t =
//      clamp(tanh(Q/2), +-sat), lt = log(max(|t|, tiny)), kept as lt with
//      t's sign (lt < 0 always, so -lt marks a negative t); min-sum: Q.
//   2. per check c over its edges in slot order: the sum of lt then the
//      pads' adds, and the count of negatives (min-sum: m1, m2, the first
//      slot holding m1, the count).
//   3. per edge: the message, from the stored lt (no second log):
//      2 atanh(clamp(sign * exp(lsum - lt), +-sat)), or sign * min(first ?
//      m2 : m1, cap); sign -1 when the other edges hold an odd count of
//      negatives.
//   4. per variable v over its edges in vslot order: post = llr + sum.
// Messages are indexed by edge on both sides: the check-side message of
// edge e is the next iteration's variable-side message of e, so the
// plain version's gathers (c2v, v2c) have no counterpart.  Every rounding
// is written out (__fadd_rn, __fsub_rn, __fmul_rn) and tanhf, logf, expf,
// atanhf are CUDA's, which PyTorch's elementwise ops on the card call
// too: the kernel equals the plain version bit for bit.
//
// After the last iteration the block still holds the posterior: hard =
// post < 0, and ok = no check whose edges of odd weight in H hold an odd
// count of ones (the exact syndrome), combined across the block by
// __syncthreads_or.  H's weights are the plain version's own `cw` [m*wr]
// (int64, at the check slots): a check's real slots come first, so edge
// e of check c sits at slot c*wr + e - cstart[c].
//
// Layout: a persistent grid (the blocks the card keeps resident), a block
// walks codewords; 256 threads share a codeword (128 and 512 measured
// slower on an H100, PERF.md).  Per codeword msg and the stored lt (or Q)
// [E], post [n] and four words a check sit in shared memory where they
// fit (n = 648, E = 1,946: 23 KB), else in a global scratch a block
// (make_regular_ldpc(16200, 8100): 583 KB).  The maps are the same for
// every codeword and are read through the read-only cache: copied into
// shared memory once per block (27 KB more at n = 648, half the blocks an
// SM) they measured 2-5% slower on an H100.
//
// Bound on this card: operations.  An edge takes about 17 float
// operations an iteration in sum-product (tanh, log, exp and atanh
// counted as one each), a variable one; at 4096 codewords of n = 648
// (1,946 edges), 50 iterations: 6.9e9, 0.10 ms at 67 TFLOP/s, against 21
// MB of LLRs in and decisions out.  The four library functions are tens of
// instructions each, so the instruction issue of those four calls an edge
// sets the floor (chip_kernel_bench.py --fold counts them in the SASS).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads sharing a codeword

struct Maps {
  const int* cstart;  // [m + 1] a check's first edge (edges check-major)
  const int* evar;    // [E] an edge's variable
  const int* echk;    // [E] an edge's check
  const int* vstart;  // [n + 1] a variable's first entry of vedge
  const int* vedge;   // [E] a variable's edges in vslot order
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// the sign of the product over a check's other edges: -1 for an odd count
// of negatives among them (`_excl_sign`)
__device__ __forceinline__ float excl_sign(int tot, int neg) {
  return ((tot - neg) & 1) ? -1.0f : 1.0f;
}

// words a codeword's arrays take: msg, val [E], post [n], 4 per check
__host__ __device__ inline long long row_words(int m, int n, int E) {
  return 2LL * E + n + 4LL * m;
}

template <bool kMinSum, bool kSmem>
__global__ void __launch_bounds__(kThreads)
ldpc_bp_kernel(const float* __restrict__ llr, float* __restrict__ rv_out,
               int* __restrict__ hard_out, uint8_t* __restrict__ ok_out,
               float* __restrict__ scratch, Maps g,
               const long long* __restrict__ cw, int R, int m, int n, int E,
               int wr, int wc, int iters, float sat, float tiny,
               float neutral, float cap) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  float* msg = kSmem ? smem : scratch + blockIdx.x * row_words(m, n, E);
  float* val = msg + E;      // lt with t's sign, or Q
  float* post = val + E;
  float* ca = post + n;      // lsum, or m1
  float* cb = ca + m;        // m2
  int* ctot = reinterpret_cast<int*>(cb + m);
  int* cfirst = ctot + m;    // the edge holding m1
  // a pad slot's part, from its own expression (the CPU's logf is not the
  // card's, so the host does not pass it)
  float padc = 0.0f;
  int padneg = 0;
  if (!kMinSum) {
    const float t = clampf(tanhf(__fmul_rn(neutral, 0.5f)), -sat, sat);
    padc = logf(fmaxf(fabsf(t), tiny));
    padneg = t < 0.0f;
  }

  for (int row = blockIdx.x; row < R; row += gridDim.x) {
    const float* x = llr + static_cast<size_t>(row) * n;
    for (int e = tid; e < E; e += kThreads) msg[e] = 0.0f;
    for (int v = tid; v < n; v += kThreads) post[v] = x[v];
    __syncthreads();

    for (int it = 0; it < iters; ++it) {
      // 1. per edge
      for (int e = tid; e < E; e += kThreads) {
        const float q = __fsub_rn(post[__ldg(g.evar + e)], msg[e]);
        if (kMinSum) {
          val[e] = q;
        } else {
          const float t = clampf(tanhf(__fmul_rn(q, 0.5f)), -sat, sat);
          const float lt = logf(fmaxf(fabsf(t), tiny));
          val[e] = t < 0.0f ? -lt : lt;
        }
      }
      __syncthreads();
      // 2. per check, its edges in slot order
      for (int c = tid; c < m; c += kThreads) {
        const int e0 = __ldg(g.cstart + c);
        const int e1 = __ldg(g.cstart + c + 1);
        int tot = 0;
        if (kMinSum) {
          float m1 = __int_as_float(0x7f800000), m2 = m1;
          int first = e0;
          for (int e = e0; e < e1; ++e) {
            const float q = val[e];
            tot += q < 0.0f;
            const float a = fabsf(q);
            if (a < m1) {
              m2 = m1;
              m1 = a;
              first = e;
            } else if (a < m2) {
              m2 = a;
            }
          }
          ca[c] = m1;
          cb[c] = m2;
          cfirst[c] = first;
        } else {
          float lsum = 0.0f;
          for (int e = e0; e < e1; ++e) {
            const float sv = val[e];
            tot += sv > 0.0f;
            const float lt = -fabsf(sv);
            lsum = e == e0 ? lt : __fadd_rn(lsum, lt);
          }
          const int pads = wr - (e1 - e0);
          for (int k = 0; k < pads; ++k)
            lsum = (k == 0 && e1 == e0) ? padc : __fadd_rn(lsum, padc);
          tot += pads * padneg;
          ca[c] = lsum;
        }
        ctot[c] = tot;
      }
      __syncthreads();
      // 3. per edge: the messages
      for (int e = tid; e < E; e += kThreads) {
        const int c = __ldg(g.echk + e);
        const float sv = val[e];
        if (kMinSum) {
          msg[e] = __fmul_rn(excl_sign(ctot[c], sv < 0.0f),
                             fminf(e == cfirst[c] ? cb[c] : ca[c], cap));
        } else {
          const float r = __fmul_rn(excl_sign(ctot[c], sv > 0.0f),
                                    expf(__fsub_rn(ca[c], -fabsf(sv))));
          msg[e] = __fmul_rn(2.0f, atanhf(clampf(r, -sat, sat)));
        }
      }
      __syncthreads();
      // 4. per variable, its edges in vslot order
      for (int v = tid; v < n; v += kThreads) {
        const int j0 = __ldg(g.vstart + v);
        const int j1 = __ldg(g.vstart + v + 1);
        float sum = 0.0f;
        for (int j = j0; j < j1; ++j) {
          const float r = msg[__ldg(g.vedge + j)];
          sum = j == j0 ? r : __fadd_rn(sum, r);
        }
        if (j1 > j0 && j1 - j0 < wc) sum = __fadd_rn(sum, 0.0f);  // the pads
        post[v] = __fadd_rn(x[v], sum);
      }
      __syncthreads();
    }

    // the decode's epilogue from the last posterior
    if (hard_out != nullptr)
      for (int v = tid; v < n; v += kThreads)
        hard_out[static_cast<size_t>(row) * n + v] = post[v] < 0.0f;
    if (ok_out != nullptr) {
      int bad = 0;
      for (int c = tid; c < m; c += kThreads) {
        const int e0 = __ldg(g.cstart + c);
        const int e1 = __ldg(g.cstart + c + 1);
        const long long* w = cw + static_cast<size_t>(c) * wr;
        int par = 0;
        for (int e = e0; e < e1; ++e)
          par ^= (post[__ldg(g.evar + e)] < 0.0f) &
                 static_cast<int>(__ldg(w + (e - e0)) & 1);
        bad |= par;
      }
      bad = __syncthreads_or(bad);
      if (tid == 0) ok_out[row] = bad ? 0 : 1;
    }
    if (rv_out != nullptr) {
      // the padded variable-slot layout of the plain version
      float* out = rv_out + static_cast<size_t>(row) * (n * wc + 1);
      for (int i = tid; i < n * wc; i += kThreads) {
        const int v = i / wc, j = i - v * wc;
        const int j0 = __ldg(g.vstart + v);
        out[i] = j < __ldg(g.vstart + v + 1) - j0
                     ? msg[__ldg(g.vedge + j0 + j)]
                     : 0.0f;
      }
      if (tid == 0) out[n * wc] = 0.0f;
    }
    __syncthreads();  // the next codeword overwrites msg and post
  }
}

template <bool kMinSum, bool kSmem>
void* kernel_of() {
  return reinterpret_cast<void*>(ldpc_bp_kernel<kMinSum, kSmem>);
}

void* pick(int min_sum, int in_smem) {
  if (min_sum)
    return in_smem ? kernel_of<true, true>() : kernel_of<true, false>();
  return in_smem ? kernel_of<false, true>() : kernel_of<false, false>();
}

struct Args {
  const float* llr;
  float* rv;
  int* hard;
  uint8_t* ok;
  float* scratch;
  Maps maps;
  const long long* cw;
  int R, m, n, E, wr, wc, iters;
  float sat, tiny, neutral, cap;
};

template <bool kMinSum, bool kSmem>
void launch(const Args& a, int blocks, size_t smem, cudaStream_t stream) {
  ldpc_bp_kernel<kMinSum, kSmem><<<blocks, kThreads, smem, stream>>>(
      a.llr, a.rv, a.hard, a.ok, a.scratch, a.maps, a.cw, a.R, a.m, a.n,
      a.E, a.wr, a.wc, a.iters, a.sat, a.tiny, a.neutral, a.cap);
}

size_t smem_of(int m, int n, int E, int in_smem) {
  return in_smem ? static_cast<size_t>(4 * row_words(m, n, E)) : 0;
}

}  // namespace

// The shared memory a codeword's arrays take, in bytes.
extern "C" long long ldpc_bp_smem_bytes(int m, int n, int E) {
  return static_cast<long long>(smem_of(m, n, E, 1));
}

// The most dynamic shared memory a block may ask for on the current
// device (the opt-in limit), or -1.
extern "C" long long ldpc_bp_smem_max() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return v;
}

// The persistent grid: the blocks the current device keeps resident at
// once (the caller takes at most one a codeword), or a negative CUDA
// error.
extern "C" int ldpc_bp_blocks(int m, int n, int E, int min_sum,
                              int in_smem) {
  const void* k = pick(min_sum, in_smem);
  const size_t smem = smem_of(m, n, E, in_smem);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)  // above 48 KB only after asking
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads,
                                                      smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  return per_sm * sms;
}

// llr [R, n] float32 in; out, each skipped where null: rv [R, n*wc + 1]
// float32, hard [R, n] int32, ok [R] bool (with ok, cw [m*wr] int64, H's
// weights at the check slots).  scratch [blocks, 2E + n + 4m] float32
// unless in_smem, else unused.  Maps of the real edges (`compact_maps`):
// cstart [m + 1], evar, echk [E], vstart [n + 1], vedge [E] int32.  All
// contiguous on one card; blocks at most ldpc_bp_blocks and R.  Returns
// cudaGetLastError().
extern "C" int ldpc_bp_launch(const void* llr, void* rv, void* hard,
                              void* ok, void* scratch, const void* cstart,
                              const void* evar, const void* echk,
                              const void* vstart, const void* vedge,
                              const void* cw, int R, int blocks, int m,
                              int n, int E, int wr, int wc, int iters,
                              int min_sum, int in_smem, float sat, float tiny,
                              float neutral, float cap, void* stream) {
  if (R < 1 || blocks < 1 || m < 1 || n < 1 || E < 0 || wr < 1 || wc < 1 ||
      iters < 0 || (ok != nullptr && cw == nullptr) ||
      (!in_smem && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(llr),
               static_cast<float*>(rv),
               static_cast<int*>(hard),
               static_cast<uint8_t*>(ok),
               static_cast<float*>(scratch),
               {static_cast<const int*>(cstart), static_cast<const int*>(evar),
                static_cast<const int*>(echk),
                static_cast<const int*>(vstart),
                static_cast<const int*>(vedge)},
               static_cast<const long long*>(cw),
               R, m, n, E, wr, wc, iters, sat, tiny, neutral, cap};
  const size_t smem = smem_of(m, n, E, in_smem);
  if (smem > 48 * 1024) {  // above 48 KB only after asking
    const cudaError_t e = cudaFuncSetAttribute(
        pick(min_sum, in_smem), cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (min_sum) {
    if (in_smem) launch<true, true>(a, blocks, smem, st);
    else launch<true, false>(a, blocks, smem, st);
  } else {
    if (in_smem) launch<false, true>(a, blocks, smem, st);
    else launch<false, false>(a, blocks, smem, st);
  }
  return static_cast<int>(cudaGetLastError());
}
