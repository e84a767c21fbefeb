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
// FMAs exactly in float64) bit for bit.  The float-to-int conversion
// rounds half to even, as rintf and torch.round do.
//
// Layout: ma [P, B, 2*npfb, Tc] float32 as conv1d leaves it (row
// p*B + b, branch rows 0..npfb-1 the MF, npfb.. the dMF), so each channel
// reads its own contiguous time axis.
//
// Bound on this card: the latency of one dependent chain per channel, not
// bandwidth (the loop needs 2P floats per active emit and writes 9 bytes
// per slot).  What the design does about it:
//
// * One warp per channel, one block per warp, so B channels spread over
//   min(B, 132) SMs.  Lane 0 carries the chain with the state in
//   registers; the other lanes move data.
// * The chain runs only the emits that do something.  An inactive emit
//   (bi >= npfb) changes nothing but tau + 0, bf = tau*npfb and
//   bi = rint(bf).  After an active emit those are the values just
//   computed (tau > 0 there, so tau + 0 is tau), and after an inactive one
//   tau + 0 is a fixed point: once bi >= npfb holds on a freshly computed
//   bi, every later emit of the step is the same no-op and its slot stays
//   zero.  Only a step that opens inactive needs one recompute, because
//   its bi and bf come from the step decrement and not from tau; the
//   recompute may move them by a rounding, even below npfb, and the state
//   keeps what it gives.  At k = 2 that is one active emit and one
//   recompute per two steps instead of six full emits, bit for bit.
// * Branch rows are staged.  Per 32-step tile the warp copies, one tile
//   ahead and with cp.async (one 128-byte line per row and instruction),
//   WIN rows of the MF and of the dMF (re and im planes for P = 2) around
//   the branch the chain stands on when the copy is started, wrapping at
//   npfb.  The chain reads shared memory; a branch outside the staged
//   rows (fast drift during acquisition) is read from global memory: a
//   load is a load, the bits are the same.
// * Outputs leave through shared memory: the chain writes the active
//   emits into a zeroed tile, and after the tile all lanes write y_re,
//   y_im and valid to global memory in full lines and zero the tile again.
//
// The staging and the step are symsync_step.cuh's, shared with
// symsync_pll_lms.cu (the loop with symtrack's PLL + LMS after every emit).
//
// Built by liquid_dsp_tpu_torch/ops/kernels/build.py with nvcc for sm_90a,
// bound with ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include "symsync_step.cuh"

namespace {

using symsync_step::STAGE;
using symsync_step::TILE;

constexpr int THREADS = 32;   // one warp = one channel

__global__ void __launch_bounds__(THREADS)
symsync_scan_kernel(const float* __restrict__ ma, float* __restrict__ fstate,
                    int* __restrict__ istate, float* __restrict__ y_re,
                    float* __restrict__ y_im,
                    unsigned char* __restrict__ valid, int B, int Tc,
                    int npfb, int P, int max_out, int k_out, int locked,
                    float inv_k, float c_q, float c_v, float c_r) {
  extern __shared__ float smem[];
  float* stage = smem;                       // [2][2*P][WIN][TILE]
  float* o_re = smem + 2 * STAGE;            // [TILE*max_out]
  float* o_im = o_re + TILE * max_out;
  unsigned char* o_v = reinterpret_cast<unsigned char*>(o_im + TILE * max_out);

  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned FULL = 0xffffffffu;
  symsync_step::TimingLoop lp{};
  lp.load(fstate, istate, B, b);
  lp.npfb = npfb;
  lp.max_out = max_out;
  lp.k_out = k_out;
  lp.locked = locked;
  lp.inv_k = inv_k;
  lp.c_q = c_q;
  lp.c_v = c_v;
  lp.c_r = c_r;
  lp.fnpfb = static_cast<float>(npfb);
  const symsync_step::Rows rw(ma, B, b, Tc, npfb, P);
  const size_t o0 = static_cast<size_t>(b) * Tc * max_out;
  const int ntiles = (Tc + TILE - 1) / TILE;

  for (int i = lane; i < TILE * max_out; i += THREADS) {
    o_re[i] = 0.f;
    o_im[i] = 0.f;
    o_v[i] = 0;
  }

  int r0_cur = symsync_step::window_start(__shfl_sync(FULL, lp.bi, 0), npfb,
                                          rw.win);
  rw.stage_tile(stage, 0, r0_cur, lane);

  for (int n = 0; n < ntiles; ++n) {
    const int r0_next = symsync_step::window_start(
        __shfl_sync(FULL, lp.bi, 0), npfb, rw.win);
    if (n + 1 < ntiles)
      rw.stage_tile(stage, n + 1, r0_next, lane);
    else
      cp_async_commit();
    cp_async_wait_all_but<1>();
    __syncwarp();

    const int t0 = n * TILE;
    const int nt = Tc - t0 < TILE ? Tc - t0 : TILE;
    if (lane == 0) {
      const float* st = stage + (n & 1) * STAGE;
      for (int tl = 0; tl < nt; ++tl)
        lp.step(symsync_step::RowRead{rw, st, r0_cur, t0, tl}, P, tl, o_re,
                o_im, o_v);
    }
    __syncwarp();

    // the tile's slots to global memory in full lines; zero the tile again
    const size_t ob = o0 + static_cast<size_t>(t0) * max_out;
    for (int i = lane; i < nt * max_out; i += THREADS) {
      y_re[ob + i] = o_re[i];
      y_im[ob + i] = o_im[i];
      valid[ob + i] = o_v[i];
      o_re[i] = 0.f;
      o_im[i] = 0.f;
      o_v[i] = 0;
    }
    r0_cur = r0_next;
  }

  if (lane == 0) lp.store(fstate, istate, B, b);
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
  // two stage buffers, then the output tile (two float planes and a byte)
  const size_t shmem = 2 * STAGE * sizeof(float)
      + static_cast<size_t>(TILE) * max_out * (2 * sizeof(float) + 1);
  if (shmem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        symsync_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  symsync_scan_kernel<<<B, THREADS, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ma), static_cast<float*>(fstate),
      static_cast<int*>(istate), static_cast<float*>(y_re),
      static_cast<float*>(y_im), static_cast<unsigned char*>(valid), B, Tc,
      npfb, P, max_out, k_out, locked, inv_k, c_q, c_v, c_r);
  return static_cast<int>(cudaGetLastError());
}
