// LDPC belief propagation's iteration loop, for Hopper (sm_90a).
//
// Replaces the lax.scan of liquid_dsp_tpu/fec/ldpc.py:225-241 (the
// batched decoder's `step`, max_iters times over the message array Rv);
// the JAX package has no Pallas kernel here.  One launch runs every
// iteration for every codeword, from the LLRs and the slot maps of
// fec/ldpc.py's `_slot_maps` (c2v, v2c, cvar) to the final variable-side
// messages Rv [R, n*wc + 1] (pad 0).  An iteration, as the plain version
// (ops/kernels/ldpc_bp.py) writes it:
//   check phase, per check c and slot k (pads: Q = neutral):
//     Q = post[cvar] - Rv[c2v]
//     sum-product: t = clamp(tanh(Q/2), +-sat); lt = log(max(|t|, tiny));
//       R = 2 atanh(clamp(sign * exp(sum(lt) - lt), +-sat))
//     min-sum: m1 = min |Q|, its first slot, m2 = min over the others;
//       R = sign * min(slot == first ? m2 : m1, cap)
//     sign = -1 when the other slots hold an odd count of negatives
//   variable phase, per variable v: Rv[v, j] = R at its check slot (pads
//     0); post[v] = llr[v] + sum_j Rv[v, j].
// The roundings are written out (__fadd_rn, __fsub_rn, __fmul_rn) and
// tanhf/logf/expf/atanhf are CUDA's, which PyTorch's elementwise ops on
// the card call too; sums run in slot order from the first slot, as the
// plain version's `slot_sum` adds them.
//
// Layout: a block per codeword.  The check phase takes a thread per check
// over its wr slots (two passes: the first leaves t, or Q, in the slot and
// forms the slot sums, the second the messages), the variable phase a
// thread per variable over its wc slots, a barrier between the phases.
// Rv (n*wc), the check-side messages (m*wr) and the posterior (n) sit in
// shared memory where one codeword's fit (n = 648: 23 KB); otherwise Rv is
// the output row itself and the other two a global scratch the wrapper
// allocates.  The maps are read through the read-only cache: every block
// shares them.
//
// Bound on this card: operations.  A check slot takes about 16 float
// operations an iteration (tanh, log, exp and atanh counted as one each),
// a variable slot one; at 4096 codewords of n = 648 (3240 check slots),
// 50 iterations: about 1.1e10, 0.16 ms at 67 TFLOP/s, against 42 MB of
// LLRs in and messages out (0.013 ms at 3.35 TB/s).  The transcendental
// functions are library calls of tens of instructions each, so the kernel
// runs far above that bound; a simple kernel first.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// the sign of the product over a check's other slots: -1 for an odd count
// of negatives among them (`_excl_sign`)
__device__ __forceinline__ float excl_sign(int tot, int neg) {
  return ((tot - neg) & 1) ? -1.0f : 1.0f;
}

__global__ void __launch_bounds__(kThreads)
ldpc_bp_kernel(const float* __restrict__ llr, float* __restrict__ rv_out,
               float* __restrict__ scratch, const int* __restrict__ c2v,
               const int* __restrict__ v2c, const int* __restrict__ cvar,
               int m, int n, int wr, int wc, int iters, int min_sum,
               int in_smem, float sat, float tiny, float neutral,
               float cap) {
  extern __shared__ float smem[];
  const int nwc = n * wc, mwr = m * wr;
  const size_t row = blockIdx.x;
  const float* x = llr + row * n;
  float* out = rv_out + row * (nwc + 1);
  float *Rv, *Rc, *post;
  if (in_smem) {
    Rv = smem;
    Rc = smem + nwc;
    post = Rc + mwr;
  } else {
    Rv = out;
    Rc = scratch + row * (mwr + n);
    post = Rc + mwr;
  }
  for (int i = threadIdx.x; i < nwc; i += blockDim.x) Rv[i] = 0.0f;
  for (int v = threadIdx.x; v < n; v += blockDim.x) post[v] = x[v];
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    for (int c = threadIdx.x; c < m; c += blockDim.x) {
      float* rc = Rc + c * wr;
      const int* cv = cvar + c * wr;
      const int* cr = c2v + c * wr;
      int tot = 0;
      if (min_sum) {
        float m1 = __int_as_float(0x7f800000), m2 = m1;
        int first = 0;
        for (int k = 0; k < wr; ++k) {
          const int vi = __ldg(cv + k);
          const float q =
              vi == n ? neutral : __fsub_rn(post[vi], Rv[__ldg(cr + k)]);
          rc[k] = q;
          tot += q < 0.0f;
          const float a = fabsf(q);
          if (a < m1) {
            m2 = m1;
            m1 = a;
            first = k;
          } else if (a < m2) {
            m2 = a;
          }
        }
        for (int k = 0; k < wr; ++k) {
          const float q = rc[k];
          rc[k] = __fmul_rn(excl_sign(tot, q < 0.0f),
                            fminf(k == first ? m2 : m1, cap));
        }
      } else {
        float lsum = 0.0f;
        for (int k = 0; k < wr; ++k) {
          const int vi = __ldg(cv + k);
          const float q =
              vi == n ? neutral : __fsub_rn(post[vi], Rv[__ldg(cr + k)]);
          const float t = clampf(tanhf(__fmul_rn(q, 0.5f)), -sat, sat);
          const float lt = logf(fmaxf(fabsf(t), tiny));
          rc[k] = t;
          tot += t < 0.0f;
          lsum = k == 0 ? lt : __fadd_rn(lsum, lt);
        }
        for (int k = 0; k < wr; ++k) {
          const float t = rc[k];
          const float lt = logf(fmaxf(fabsf(t), tiny));
          const float r = __fmul_rn(excl_sign(tot, t < 0.0f),
                                    expf(__fsub_rn(lsum, lt)));
          rc[k] = __fmul_rn(2.0f, atanhf(clampf(r, -sat, sat)));
        }
      }
    }
    __syncthreads();
    for (int v = threadIdx.x; v < n; v += blockDim.x) {
      float s = 0.0f;
      for (int j = 0; j < wc; ++j) {
        const int ci = __ldg(v2c + v * wc + j);
        const float r = ci == mwr ? 0.0f : Rc[ci];
        Rv[v * wc + j] = r;
        s = j == 0 ? r : __fadd_rn(s, r);
      }
      post[v] = __fadd_rn(x[v], s);
    }
    __syncthreads();
  }
  if (in_smem)
    for (int i = threadIdx.x; i < nwc; i += blockDim.x) out[i] = Rv[i];
  if (threadIdx.x == 0) out[nwc] = 0.0f;
}

}  // namespace

// The shared memory one codeword needs, in bytes: Rv, the check-side
// messages and the posterior.
extern "C" long long ldpc_bp_smem_bytes(int m, int n, int wr, int wc) {
  return 4LL * (static_cast<long long>(n) * wc +
                static_cast<long long>(m) * wr + n);
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

// llr [R, n] float32, rv [R, n*wc + 1] float32 out; scratch [R, m*wr + n]
// float32 when the messages do not fit in shared memory (in_smem 0), else
// unused; c2v, cvar [m*wr] and v2c [n*wc] int32 (`_slot_maps`: pads point
// one past the end).  All contiguous on one card.  Returns
// cudaGetLastError().
extern "C" int ldpc_bp_launch(const void* llr, void* rv, void* scratch,
                              const void* c2v, const void* v2c,
                              const void* cvar, int R, int m, int n, int wr,
                              int wc, int iters, int min_sum, int in_smem,
                              float sat, float tiny, float neutral, float cap,
                              void* stream) {
  if (R < 1 || m < 1 || n < 1 || wr < 1 || wc < 1 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  if (in_smem) {
    smem = static_cast<size_t>(ldpc_bp_smem_bytes(m, n, wr, wc));
    if (smem > 48 * 1024) {  // above 48 KB only after asking
      const cudaError_t e = cudaFuncSetAttribute(
          ldpc_bp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  ldpc_bp_kernel<<<R, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(llr), static_cast<float*>(rv),
      static_cast<float*>(scratch), static_cast<const int*>(c2v),
      static_cast<const int*>(v2c), static_cast<const int*>(cvar), m, n, wr,
      wc, iters, min_sum, in_smem, sat, tiny, neutral, cap);
  return static_cast<int>(cudaGetLastError());
}
