// The symsync timing loop's device code, shared by symsync_scan.cu (the
// loop alone) and symsync_pll_lms.cu (the loop with symtrack's PLL + LMS
// after every emit): one input step of the chain, whatever gives it the
// branch values, and symsync_scan's staging of branch rows around the
// current branch.  Both kernels run this step, so from the same branch
// values their slots and loop state are the same bits (see
// symsync_scan.cu for what it computes, its roundings and why only the
// active emits run).
//
// In symsync_scan one warp stages and runs the loop: every lane starts the
// cp.async copies of a tile's rows, lane 0 carries the chain with its
// state in registers.

#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace symsync_step {

constexpr int TILE = 32;      // steps per staged tile (one line per row)
constexpr int WIN = 8;        // branch rows staged around the current one
constexpr int STAGE = 4 * WIN * TILE;   // floats per stage buffer (P = 2)

// First staged row for a tile, from the chain's current branch index: the
// window [r0, r0 + win) mod npfb is centred on where the next active emit
// will read (bi mod npfb; a negative bi reads row 0).
__device__ __forceinline__ int window_start(int bi, int npfb, int win) {
  const int c = bi < 0 ? 0 : bi % npfb;
  const int r0 = c - win / 2;
  return r0 < 0 ? r0 + npfb : r0;
}

// One channel's rows: ma [P, B, 2*npfb, Tc] as conv1d leaves it; mre is
// the channel's MF/dMF rows of the re plane, mim those of the im plane.
struct Rows {
  const float* mre;
  const float* mim;
  int Tc, npfb, P, win;

  __device__ __forceinline__ Rows(const float* ma, int B, int b, int Tc_,
                                  int npfb_, int P_)
      : Tc(Tc_), npfb(npfb_), P(P_), win(npfb_ < WIN ? npfb_ : WIN) {
    const size_t row = static_cast<size_t>(2 * npfb) * Tc;
    mre = ma + static_cast<size_t>(b) * row;
    mim = mre + static_cast<size_t>(B) * row;
  }

  // Stage tile n (steps n*TILE ..) into buffer n & 1 of `stage`
  // ([2][2*P][WIN][TILE] floats): segment (plane*2 + g)*WIN + j holds row
  // (r0 + j) mod npfb of the MF (g = 0) or dMF (g = 1) of that plane;
  // each lane copies its own step.  Closes one cp.async group.
  __device__ __forceinline__ void stage_tile(float* stage, int n, int r0,
                                             int lane) const {
    const int t0 = n * TILE;
    if (t0 + lane < Tc) {
      float* dst = stage + (n & 1) * STAGE + lane;
      for (int pg = 0; pg < 2 * P; ++pg) {
        const float* src = ((pg >> 1) ? mim : mre)
            + static_cast<size_t>((pg & 1) * npfb) * Tc + t0 + lane;
        for (int j = 0; j < win; ++j) {
          const int r = r0 + j < npfb ? r0 + j : r0 + j - npfb;
          cp_async_f32(dst + (pg * WIN + j) * TILE,
                       src + static_cast<size_t>(r) * Tc);
        }
      }
    }
    cp_async_commit();
  }
};

// symsync_scan's branch values for step tl of the tile staged in `st` from
// row r0 (tile start t0): a staged row from shared memory, a row outside
// the staged window from global memory (a load is a load: the same bits).
struct RowRead {
  const Rows& rw;
  const float* st;
  int r0, t0, tl;

  __device__ __forceinline__ void operator()(int bc, float& mf_re,
                                             float& dmf_re, float& mf_im,
                                             float& dmf_im) const {
    const int npfb = rw.npfb;
    int j = bc - r0;
    if (j < 0) j += npfb;
    if (j < rw.win) {
      const float* s = st + j * TILE + tl;
      mf_re = s[0];
      dmf_re = s[WIN * TILE];
      if (rw.P == 2) {
        mf_im = s[2 * WIN * TILE];
        dmf_im = s[3 * WIN * TILE];
      }
    } else {
      const size_t t = static_cast<size_t>(t0 + tl);
      const size_t Tc = static_cast<size_t>(rw.Tc);
      mf_re = __ldg(rw.mre + static_cast<size_t>(bc) * Tc + t);
      dmf_re = __ldg(rw.mre + static_cast<size_t>(npfb + bc) * Tc + t);
      if (rw.P == 2) {
        mf_im = __ldg(rw.mim + static_cast<size_t>(bc) * Tc + t);
        dmf_im = __ldg(rw.mim + static_cast<size_t>(npfb + bc) * Tc + t);
      }
    }
  }
};

// The loop's state and constants, carried by lane 0.
struct TimingLoop {
  float tau, rate, dl, v0, bf, ran;
  int bi, decim;
  int npfb, max_out, k_out, locked;
  float inv_k, c_q, c_v, c_r, fnpfb;

  // fstate [6, B] (tau, rate, del, v0, bf, ran), istate [2, B] (b, decim)
  __device__ __forceinline__ void load(const float* fstate,
                                       const int* istate, int B, int b) {
    tau = fstate[b];
    rate = fstate[B + b];
    dl = fstate[2 * B + b];
    v0 = fstate[3 * B + b];
    bf = fstate[4 * B + b];
    ran = fstate[5 * B + b];
    bi = istate[b];
    decim = istate[B + b];
  }

  __device__ __forceinline__ void store(float* fstate, int* istate, int B,
                                        int b) const {
    fstate[b] = tau;
    fstate[B + b] = rate;
    fstate[2 * B + b] = dl;
    fstate[3 * B + b] = v0;
    fstate[4 * B + b] = bf;
    fstate[5 * B + b] = ran;
    istate[b] = bi;
    istate[B + b] = decim;
  }

  // Input step tl of a tile: its active emits into slots tl*max_out + e
  // of the zeroed tile (o_re, o_im, o_v), then the step decrement.  The
  // branch values come from fetch(bc, mf_re, dmf_re, mf_im, dmf_im) (the
  // im plane's left at 0 for P = 1): symsync_scan's staged rows
  // (RowRead), or the rows the fused kernel filters itself.
  template <class Fetch>
  __device__ __forceinline__ void step(const Fetch& fetch, int P, int tl,
                                       float* o_re, float* o_im,
                                       unsigned char* o_v) {
    int e = 0;
    if (bi >= npfb) {
      // the step opens inactive on the bi and bf of the step
      // decrement: the emit's tau + 0 and its recompute of bf, bi
      tau = __fadd_rn(tau, 0.f);
      ran = fmaxf(ran, 0.f);
      bf = __fmul_rn(tau, fnpfb);
      bi = __float2int_rn(bf);
      e = 1;
    }
    // active emits; the first inactive emit after one, and every emit
    // after an inactive one, would only repeat the recompute just made
    for (; e < max_out && bi < npfb; ++e) {
      const int bc = bi < 0 ? 0 : bi;
      float mf_re, dmf_re, mf_im = 0.f, dmf_im = 0.f;
      fetch(bc, mf_re, dmf_re, mf_im, dmf_im);
      const float q_raw = P == 2
          ? __fmaf_rn(mf_re, dmf_re, __fmul_rn(mf_im, dmf_im))
          : __fmul_rn(mf_re, dmf_re);
      const bool run = decim == k_out && !locked;
      // clip(q, -1, 1) as selects (a NaN passes, as in jnp.clip)
      const float q = q_raw < -1.f ? -1.f : (q_raw > 1.f ? 1.f : q_raw);
      const float q_hat = __fmaf_rn(c_q, q, v0);
      const float v0n = __fmul_rn(c_v, q_hat);
      const float rn = __fmaf_rn(c_r, q_hat, rate);
      const float dn = __fadd_rn(rn, q_hat);
      tau = __fadd_rn(tau, dl);
      bf = __fmul_rn(tau, fnpfb);
      bi = __float2int_rn(bf);        // rounds half to even
      if (run) {
        rate = rn;
        dl = dn;
        v0 = v0n;
      }
      ran = fmaxf(ran, run ? 1.f : 0.f);
      decim = decim == k_out ? 1 : decim + 1;
      const int o = tl * max_out + e;
      o_re[o] = __fmul_rn(mf_re, inv_k);
      o_im[o] = __fmul_rn(mf_im, inv_k);
      o_v[o] = 1;
    }
    tau = __fadd_rn(tau, -1.f);
    bf = __fadd_rn(bf, -fnpfb);
    bi -= npfb;
  }
};

}  // namespace symsync_step
