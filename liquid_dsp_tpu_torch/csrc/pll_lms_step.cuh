// symtrack's carrier PLL + decision-directed LMS on one warp, shared by
// pll_lms.cu (over the symsync slots of a block) and symsync_pll_lms.cu
// (over each tile of slots as the timing loop emits it): the slicers, the
// polynomial atan2, and a channel's state with its walk over a group of 32
// slots.  Both kernels run this code, so from the same state and slots they
// give the same bits (see pll_lms.cu for what it computes, its numerics and
// why only the valid slots run on the chain).

#pragma once

#include <cuda_runtime.h>

namespace pll_lms_step {

constexpr unsigned FULL = 0xffffffffu;

struct Slicer {
  const float* tab_re;
  const float* tab_im;
  int M, k00, k01, k10, k11;
  float s2v;

  template <bool QPSK>
  __device__ __forceinline__ int nearest(float v_re, float v_im, float* r_re,
                                         float* r_im) const {
    if (QPSK) {
      const bool a = v_re < 0.f, b = v_im < 0.f;
      *r_re = a ? -s2v : s2v;
      *r_im = b ? -s2v : s2v;
      return a ? (b ? k11 : k10) : (b ? k01 : k00);
    }
    int best = 0;
    float dbest = 0.f;
    for (int m = 0; m < M; ++m) {
      const float dr = __fsub_rn(v_re, __ldg(tab_re + m));
      const float di = __fsub_rn(v_im, __ldg(tab_im + m));
      const float d2 = __fmaf_rn(dr, dr, __fmul_rn(di, di));
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

// atan2(y, x) of finite arguments without a branch or a call, so that the
// compiler can weave the PLL chain and the LMS work into one block: the
// smaller magnitude over the larger (fast reciprocal, 2 ulp), an odd
// polynomial for atan on [0, 1] (max error 7e-8 rad against float64), then
// the octant by selects.  Zeros follow atan2f: the sign bit of x picks
// 0 or pi, the sign of y the sign.
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float mx = fmaxf(ax, ay), mn = fminf(ax, ay);
  const float a = mx > 0.f ? __fdividef(mn, mx) : 0.f;
  const float s = __fmul_rn(a, a);
  float r = 0.0027856871f;
  r = __fmaf_rn(r, s, -0.0158660002f);
  r = __fmaf_rn(r, s, 0.042472221f);
  r = __fmaf_rn(r, s, -0.0749753043f);
  r = __fmaf_rn(r, s, 0.106448799f);
  r = __fmaf_rn(r, s, -0.142070308f);
  r = __fmaf_rn(r, s, 0.199934542f);
  r = __fmaf_rn(r, s, -0.333331466f);
  r = __fmaf_rn(__fmul_rn(r, s), a, a);
  r = ay > ax ? __fsub_rn(1.57079637f, r) : r;
  r = __float_as_int(x) < 0 ? __fsub_rn(3.14159274f, r) : r;
  return copysignf(r, y);
}

// What an output needs of the state: the dot over the shifted window, the
// newest tap and the rotation.
struct Frozen {
  float p_re, p_im, wl_re, wl_im, cth, sth;
};

// conj(a) b of complex a, b on their planes, each rounding written out
// (one FMA for each part): nvcc contracts a written a*b + c by its own
// choice, which differs between two kernels that inline the same code, and
// the two kernels that share this code must give the same bits
__device__ __forceinline__ float cdot_re(float a_re, float a_im, float b_re,
                                         float b_im) {
  return __fmaf_rn(a_re, b_re, __fmul_rn(a_im, b_im));
}

__device__ __forceinline__ float cdot_im(float a_re, float a_im, float b_re,
                                         float b_im) {
  return __fmaf_rn(a_re, b_im, -__fmul_rn(a_im, b_re));
}

// a sum over the lanes' taps; the butterfly leaves the same bits in every
// lane (each level adds the same two numbers)
template <int LM>
__device__ __forceinline__ float lanes_sum(float x) {
#pragma unroll
  for (int o = LM / 2; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// One channel's PLL + LMS on a warp.  Lane j holds tap j of the weights
// and of the window kept shifted ahead (sb_j = buf_{j+1}; LM = 16 or 32
// lanes hold the taps, with LM = 16 both half-warps hold a copy); the
// scalar state is kept alike in every lane, `cur` is what an output needs.
template <int LM, bool QPSK>
struct Chain {
  Slicer sl;
  float alpha, beta2, mu;
  int L, lane;
  bool newest, ahead;
  float w_re, w_im, sb_re, sb_im, old_re, old_im, theta, dtheta, x2s;
  int n;
  Frozen cur;

  // theta, dtheta, x2 [B], n [B], w_re, w_im, b_re, b_im [B, L]: channel b
  __device__ __forceinline__ void load(
      const float* theta_io, const float* dtheta_io, const float* w_re_io,
      const float* w_im_io, const float* b_re_io, const float* b_im_io,
      const float* x2_io, const int* n_io, int b) {
    const int jt = lane & (LM - 1);    // this lane's tap
    newest = jt == L - 1;              // the tap that takes the new sample
    ahead = jt < L - 1;                // taps with a shifted-ahead sample
    const size_t tap0 = static_cast<size_t>(b) * L;
    w_re = jt < L ? w_re_io[tap0 + jt] : 0.f;
    w_im = jt < L ? w_im_io[tap0 + jt] : 0.f;
    sb_re = ahead ? b_re_io[tap0 + jt + 1] : 0.f;
    sb_im = ahead ? b_im_io[tap0 + jt + 1] : 0.f;
    old_re = b_re_io[tap0];            // buf_0
    old_im = b_im_io[tap0];
    theta = theta_io[b];
    dtheta = dtheta_io[b];
    x2s = x2_io[b];
    n = n_io[b];
  }

  // What an output needs, from the loaded state; the dot summed anew
  // (fresh) or as a run left it (the dot carried from the last call).
  __device__ __forceinline__ void start(bool fresh, float p_re, float p_im) {
    if (fresh) {
      p_re = lanes_sum<LM>(cdot_re(w_re, w_im, sb_re, sb_im));
      p_im = lanes_sum<LM>(cdot_im(w_re, w_im, sb_re, sb_im));
    }
    cur.p_re = p_re;
    cur.p_im = p_im;
    cur.wl_re = __shfl_sync(FULL, w_re, L - 1);
    cur.wl_im = __shfl_sync(FULL, w_im, L - 1);
    sincosf(theta, &cur.sth, &cur.cth);
  }

  // A group of 32 slots, this lane's (my_re, my_im), mask the group's valid
  // flags: the chain steps from valid slot to valid slot; each lane gets
  // its own slot's output (y, decision).  An invalid slot's output is the
  // same expression with the state frozen at the last valid slot before
  // it, computed off the chain after the walk.
  __device__ __forceinline__ void group(float my_re, float my_im,
                                        unsigned mask, float* oy_re,
                                        float* oy_im, int* od) {
    const bool my_valid = (mask >> lane) & 1u;
    Frozen fz = cur;                 // the state this lane's slot sees
    *oy_re = 0.f;
    *oy_im = 0.f;
    *od = 0;

    // the first valid slot's sample, fetched one slot ahead of its use
    int i = mask ? __ffs(mask) - 1 : 0;
    float sr = __shfl_sync(FULL, my_re, i);
    float si = __shfl_sync(FULL, my_im, i);
    while (mask) {
      mask &= mask - 1;
      const int i_next = mask ? __ffs(mask) - 1 : 0;
      const float sr_next = __shfl_sync(FULL, my_re, i_next);
      const float si_next = __shfl_sync(FULL, my_im, i_next);

      const float v_re = cdot_re(cur.cth, cur.sth, sr, si);
      const float v_im = cdot_im(cur.cth, cur.sth, sr, si);
      // PLL chain
      float r_re, r_im;
      sl.nearest<QPSK>(v_re, v_im, &r_re, &r_im);
      const float e = atan2_poly(cdot_im(r_re, r_im, v_re, v_im),
                                 cdot_re(r_re, r_im, v_re, v_im));
      dtheta = __fmaf_rn(beta2, e, dtheta);
      theta = __fmaf_rn(alpha, e, __fadd_rn(theta, dtheta));
      // the window with v and its shift, then the two sums that the
      // next P needs and that do not wait for the decision
      const float nb_re = newest ? v_re : sb_re;
      const float nb_im = newest ? v_im : sb_im;
      const float up_re = __shfl_down_sync(FULL, nb_re, 1);
      const float up_im = __shfl_down_sync(FULL, nb_im, 1);
      const float first_re = __shfl_sync(FULL, nb_re, 0);
      const float first_im = __shfl_sync(FULL, nb_im, 0);
      sb_re = ahead ? up_re : 0.f;    // lane j takes tap j+1's sample
      sb_im = ahead ? up_im : 0.f;
      const float a_re = lanes_sum<LM>(cdot_re(w_re, w_im, sb_re, sb_im));
      const float a_im = lanes_sum<LM>(cdot_im(w_re, w_im, sb_re, sb_im));
      const float c_re = lanes_sum<LM>(cdot_re(nb_re, nb_im, sb_re, sb_im));
      const float c_im = lanes_sum<LM>(cdot_im(nb_re, nb_im, sb_re, sb_im));
      x2s = __fsub_rn(__fadd_rn(x2s, cdot_re(v_re, v_im, v_re, v_im)),
                      cdot_re(old_re, old_im, old_re, old_im));
      old_re = first_re;
      old_im = first_im;
      n = n + 1;
      const float gain = __fdividef(n >= L ? mu : 0.f, fmaxf(x2s, 1e-12f));
      // LMS chain: the output, the decision, the error, the next P
      const float y_re = __fadd_rn(cur.p_re,
                                   cdot_re(cur.wl_re, cur.wl_im, v_re, v_im));
      const float y_im = __fadd_rn(cur.p_im,
                                   cdot_im(cur.wl_re, cur.wl_im, v_re, v_im));
      float d_re, d_im;
      const int dec = sl.nearest<QPSK>(y_re, y_im, &d_re, &d_im);
      const float e_re = __fsub_rn(d_re, y_re), e_im = __fsub_rn(d_im, y_im);
      const float ge_re = __fmul_rn(gain, e_re), ge_im = __fmul_rn(gain, e_im);
      cur.p_re = __fadd_rn(a_re, __fmaf_rn(ge_re, c_re,
                                           -__fmul_rn(ge_im, c_im)));
      cur.p_im = __fadd_rn(a_im, __fmaf_rn(ge_re, c_im,
                                           __fmul_rn(ge_im, c_re)));
      // w += g conj(e) nb, in operations rounded one by one so that the
      // newest tap's copy in every lane equals its own lane's
      w_re = __fmaf_rn(gain, __fmaf_rn(e_re, nb_re, __fmul_rn(e_im, nb_im)),
                       w_re);
      w_im = __fmaf_rn(gain, __fmaf_rn(e_re, nb_im,
                                       -__fmul_rn(e_im, nb_re)), w_im);
      cur.wl_re = __fmaf_rn(gain, __fmaf_rn(e_re, v_re,
                                            __fmul_rn(e_im, v_im)),
                            cur.wl_re);
      cur.wl_im = __fmaf_rn(gain, __fmaf_rn(e_re, v_im,
                                            -__fmul_rn(e_im, v_re)),
                            cur.wl_im);
      sincosf(theta, &cur.sth, &cur.cth);

      if (lane == i) {
        *oy_re = y_re;
        *oy_im = y_im;
        *od = dec;
      }
      if (lane > i) fz = cur;
      i = i_next;
      sr = sr_next;
      si = si_next;
    }

    if (!my_valid) {
      const float v_re = cdot_re(fz.cth, fz.sth, my_re, my_im);
      const float v_im = cdot_im(fz.cth, fz.sth, my_re, my_im);
      *oy_re = __fadd_rn(fz.p_re, cdot_re(fz.wl_re, fz.wl_im, v_re, v_im));
      *oy_im = __fadd_rn(fz.p_im, cdot_im(fz.wl_re, fz.wl_im, v_re, v_im));
      float d_re, d_im;
      *od = sl.nearest<QPSK>(*oy_re, *oy_im, &d_re, &d_im);
    }
  }

  // The state back, the window in its own order: buf_0 the oldest,
  // buf_{j+1} = sb_j.
  __device__ __forceinline__ void store(
      float* theta_io, float* dtheta_io, float* w_re_io, float* w_im_io,
      float* b_re_io, float* b_im_io, float* x2_io, int* n_io, int b) const {
    const size_t tap0 = static_cast<size_t>(b) * L;
    if (lane < L) {
      w_re_io[tap0 + lane] = w_re;
      w_im_io[tap0 + lane] = w_im;
      if (lane < L - 1) {
        b_re_io[tap0 + lane + 1] = sb_re;
        b_im_io[tap0 + lane + 1] = sb_im;
      }
    }
    if (lane == 0) {
      b_re_io[tap0] = old_re;
      b_im_io[tap0] = old_im;
      theta_io[b] = theta;
      dtheta_io[b] = dtheta;
      x2_io[b] = x2s;
      n_io[b] = n;
    }
  }
};

}  // namespace pll_lms_step
