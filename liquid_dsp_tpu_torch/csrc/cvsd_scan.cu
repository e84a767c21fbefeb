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
//   DF2T of audio.py:77-84 and writes its output:
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
// Three rewrites below keep every value: ref + (+-1)*delta as one FMA
// (the product by +-1 is exact, so the sum is rounded once either way);
// a clamp that cannot bind dropped (delta*zeta >= delta >= 0.01 as zeta >=
// 1, delta*(1/zeta) <= delta <= 1 as 1/zeta <= 1, ref + d >= ref >= -1 and
// ref - d <= ref <= 1 as d > 0: rounding is monotone); and encode's choice
// between the two outcomes of its bit after both are formed.
//
// Bound on this card: the chain.  A row is one dependent chain, so its
// time is T steps of it however few rows there are; the 5 bytes a sample
// moves are nothing beside that.  The time axis is not split (the state is
// exact and serial).  The design keeps everything but the chain's own
// operations off it:
//
// * A copy warp beside the chain warp, as iir_scan.cu's.  It stages tiles
//   of each row (64 samples, two halves of 32: a lane a sample) in shared
//   memory by cp.async, AHEAD tiles ahead of the chain, and drains the
//   outputs from a shared tile; the two warps meet at one named barrier
//   per tile.  A uint8 row starts at r*T bytes, mostly not 4-byte aligned,
//   and cp.async moves 4 bytes at least: the copy warp stages the aligned
//   words that hold a tile's bytes (each word holds one of the row's
//   bytes, so none lies outside the row's allocation) and reads the bytes
//   at the row's offset.  Both warps address shared memory by 32-bit
//   offsets computed once: through generic pointers ptxas rebuilt each
//   tile's shared window (an S2R and a chain of integer operations) ahead
//   of the chain's first load.
// * Decode: what the bits alone decide leaves the chain.  bitref after
//   sample t is the last num_bits bits (each byte shifted by its age, ORed:
//   a byte other than 0 or 1 is taken as the plain version takes it), so
//   the copy warp forms it for a half tile at once from one ballot per bit
//   plane of the bytes (plane 0 alone unless a byte is more than a bit;
//   else the planes below num_bits, at most 8) and the bitref carried from
//   the last half tile (every lane has it: the planes' reversed ballots);
//   then the factor (zeta or 1/zeta) and the sign (+-1) of each step, into
//   a shared tile.  The chain warp runs three short float chains,
//   interleaved by ptxas: delta = clamp(delta*k), ref = clamp(fma(s,
//   delta, ref)) and the post-emphasis (a sum, an FMA and a sum), three
//   dependent operations each.
// * Encode: the bit decides among values formed before it.  From delta,
//   dz = min(delta*zeta, 1) and dr = max(delta/zeta, 0.01); the step's
//   agree after a 1 and after a 0 was resolved one step earlier (from the
//   bits before the last one), so d1 and d0 are selects, and
//   r1 = min(ref + d1, 1), r0 = max(ref - d0, -1).  Then bit = ref <= y
//   selects ref, delta and the next step's two agrees.  The bits collect
//   in the history word, which the chain stores once a half tile (the copy
//   warp writes them out a byte a lane); the pre-emphasis runs on the copy
//   warp (y in place of x in the staged tile); num_bits 1 (every step
//   agrees) is an instance of its own.
// * One lane per row in the chain warp (the lanes past ROWS mirror those
//   below), 4 rows a block; a whole tile is one basic block with its
//   shared loads (16 bytes each) at the top, a last ragged tile runs
//   sample by sample; rows sit at pitches that put the chain lanes' reads
//   and writes in distinct banks.
//
// Measured on an H100 (80GB HBM3, 700 W; chip_kernel_bench.py --cvsd, the
// thread-per-row kernel before it in the same call): at 1024 rows x 32768
// samples encode 0.52 ms and decode 0.37 ms (before: 3.59 and 2.26 ms),
// 1.01 and 1.05-1.06 times a lone row's loop (before: 2.33 and 1.83).  A
// lone row takes 30.7 cycles a step to encode and 21.1 to decode (before:
// 92.5 and 74.2), against 30.1 and 18.0 for one warp running the step
// alone with no memory (--latency).  At 8 rows a block and more the decode
// copy warp sets the time, at 1 or 2 two chain warps share a scheduler.
//
// Built by liquid_dsp_tpu_torch/ops/kernels/build.py with nvcc for sm_90a,
// bound with ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

#ifndef CVSD_ROWS
#define CVSD_ROWS 4   // rows per block (chip_kernel_bench.py --cvsd sweeps it)
#endif

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int LANES = 32;          // lanes of a warp
constexpr int ROWS = CVSD_ROWS;    // rows per block: a chain each
constexpr int HALF = 32;           // samples of a half tile: a lane each
constexpr int TILE = 2 * HALF;     // samples of a row per tile
constexpr int AHEAD = 6;           // tiles staged ahead of the chain
constexpr int PBUF = 8;            // staged tiles in shared memory (> AHEAD)
constexpr int XPITCH = TILE + 4;   // floats: rows 16 bytes apart in banks
constexpr int KPITCH = TILE + 2;   // float2s: the same
constexpr int YPITCH = TILE + 1;   // floats: odd
constexpr int WPITCH = TILE / 4 + 1;   // words of a tile's staged bytes

static_assert(ROWS >= 1 && ROWS <= LANES && LANES % ROWS == 0,
              "rows per block divide the warp");

// Shared memory by 32-bit offsets (see the note above).
__device__ __forceinline__ float4 lds128(unsigned a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ float2 lds64(unsigned a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ float lds32(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ unsigned lds8(unsigned a) {
  unsigned v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void sts64(unsigned a, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};"
               :: "r"(a), "f"(x), "f"(y) : "memory");
}
__device__ __forceinline__ void sts32(unsigned a, float v) {
  asm volatile("st.shared.f32 [%0], %1;" :: "r"(a), "f"(v) : "memory");
}
__device__ __forceinline__ void sts32(unsigned a, unsigned v) {
  asm volatile("st.shared.u32 [%0], %1;" :: "r"(a), "r"(v) : "memory");
}

struct Params {
  unsigned mask;
  unsigned m2;              // mask >> 2: the history an agree looks at
  int planes;               // bit planes of a byte that reach bitref
  float zeta, rzeta;        // zeta and the float32 1/zeta
  float alpha;              // encode: the pre-emphasis
  float na1, na2;           // decode: -a1 and -a2 of the post-emphasis
};

// One encode step.  a1, a0: whether bitref agrees after a 1 or after a 0
// (resolved one step earlier); hist: the bits so far, newest in bit 0
// (unmasked: the agrees read its low num_bits - 2 bits, the tile's store
// its last 32).  ONE: num_bits == 1, where every step agrees.
template <bool ONE>
__device__ __forceinline__ void enc_step(float y, float& ref, float& delta,
                                         unsigned& hist, bool& a1, bool& a0,
                                         const Params& p) {
  const float dz = fminf(__fmul_rn(delta, p.zeta), 1.0f);
  const float dr = fmaxf(__fmul_rn(delta, p.rzeta), 0.01f);
  const float d1 = ONE || a1 ? dz : dr;
  const float d0 = ONE || a0 ? dz : dr;
  const float r1 = fminf(__fadd_rn(ref, d1), 1.0f);
  const float r0 = fmaxf(__fsub_rn(ref, d0), -1.0f);
  // the next step agrees after 1, 1 when the num_bits - 2 bits before this
  // one are all 1, after 0, 0 when they are all 0, never after a change
  const unsigned h = hist & p.m2;
  const bool n11 = h == p.m2, n00 = h == 0u;
  const bool bit = ref <= y;
  ref = bit ? r1 : r0;
  delta = bit ? d1 : d0;
  hist = (hist << 1) | static_cast<unsigned>(bit);
  a1 = bit && n11;
  a0 = !bit && n00;
}

// One decode step from the copy warp's factor k and sign s; returns the
// post-emphasis output.
__device__ __forceinline__ float dec_step(float k, float s, float& ref,
                                          float& delta, float& v0, float& v1,
                                          const Params& p) {
  delta = fminf(fmaxf(__fmul_rn(delta, k), 0.01f), 1.0f);
  ref = fminf(fmaxf(__fmaf_rn(s, delta, ref), -1.0f), 1.0f);
  const float yt = __fadd_rn(ref, v0);
  v0 = __fadd_rn(__fmaf_rn(p.na1, yt, -ref), v1);
  v1 = __fmul_rn(p.na2, yt);
  return yt;
}

template <bool ONE>
__global__ void __launch_bounds__(2 * LANES)
    cvsd_encode_kernel(const float* __restrict__ x, uint8_t* __restrict__ bits,
                       int rows, int T, Params p) {
  __shared__ __align__(16) float sx[PBUF][ROWS * XPITCH];   // x, then y
  __shared__ unsigned sh[2][ROWS][2];   // half tiles' bits, the last in bit 0
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * ROWS;
  const int nch = min(ROWS, rows - r0);      // rows of this block
  const int ntiles = (T + TILE - 1) / TILE;
  const unsigned rowT = static_cast<unsigned>(T);

  if (threadIdx.x >= LANES) {
    // the copy warp: lane u holds sample u of each row's half tiles.
    // Addresses are computed once: in device memory, row 0's (an opaque
    // register) and a row's stride of rowT, or per row; in shared memory,
    // constant offsets
    const size_t first = static_cast<size_t>(r0) * rowT + lane;
    const float* xin = opaque(x + first);
    uint8_t* brow[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      brow[r] = opaque(bits + first + static_cast<size_t>(r) * rowT);
    const unsigned sx0 = smem_addr(&sx[0][0]) + 4 * lane;
    const unsigned sh0 = smem_addr(&sh[0][0][0]);
    // tile nt of x into its buffer (nothing past the end); closes a group
    auto stage = [&](int nt) {
      const unsigned dst = sx0 + (nt % PBUF) * (4 * ROWS * XPITCH);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned f = static_cast<unsigned>(nt) * TILE + h * HALF;
        if (f + lane < rowT) {
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            if (r < nch)
              cp_async_f32_at(dst + 4 * (r * XPITCH + h * HALF),
                              xin + f + static_cast<size_t>(r) * rowT);
        }
      }
      cp_async_commit();
    };
    // tile nt's x becomes y = x - alpha*x[-1] in place; x[-1] of lane 0 is
    // the last half tile's lane 31 (0 before the first)
    float xlast[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) xlast[r] = 0.f;
    auto emphasize = [&](int nt) {
      const unsigned buf = sx0 + (nt % PBUF) * (4 * ROWS * XPITCH);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          v[r] = lds32(buf + 4 * (r * XPITCH + h * HALF));
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          float prev = __shfl_up_sync(FULL, v[r], 1);
          if (lane == 0) prev = xlast[r];
          xlast[r] = __shfl_sync(FULL, v[r], 31);
          sts32(buf + 4 * (r * XPITCH + h * HALF),
                __fsub_rn(v[r], __fmul_rn(p.alpha, prev)));
        }
      }
    };
    // tile nt's bits to their rows, a byte a lane: the loads, then the
    // stores
    auto store = [&](int nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned f = static_cast<unsigned>(nt) * TILE + h * HALF;
        if (f + lane < rowT) {
          const unsigned back = min(static_cast<unsigned>(HALF), rowT - f) -
                                1 - lane;
          const unsigned src = sh0 + 4 * ((nt & 1) * 2 * ROWS + h);
          unsigned v[ROWS];
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            v[r] = __float_as_uint(lds32(src + 8 * r));
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            if (r < nch)
              brow[r][f] = static_cast<uint8_t>((v[r] >> back) & 1u);
        }
      }
    };
#pragma unroll
    for (int nt = 0; nt < AHEAD; ++nt) stage(nt);
    cp_async_wait_all_but<AHEAD - 1>();   // tile 0 has landed
    emphasize(0);
    tile_barrier();
    for (int nt = 0; nt < ntiles; ++nt) {
      // the chain warp works on tile nt: store tile nt-1's bits, start
      // tile nt+AHEAD, ready tile nt+1
      if (nt > 0) store(nt - 1);
      stage(nt + AHEAD);
      cp_async_wait_all_but<AHEAD - 1>();
      if (nt + 1 < ntiles) emphasize(nt + 1);
      tile_barrier();
    }
    if (ntiles > 0) store(ntiles - 1);
    return;
  }

  // the chain warp: lane l runs row l % ROWS
  const int row = lane % ROWS;
  const unsigned xs = smem_addr(&sx[0][0]) + 4 * row * XPITCH;
  const unsigned hs = smem_addr(&sh[0][0][0]) + 8 * row;
  float ref = 0.f, delta = 0.01f;
  unsigned hist = 0u;
  bool a1 = false, a0 = true;   // bitref 0 agrees after a 0
  tile_barrier();
  for (int nt = 0; nt < ntiles; ++nt) {
    const unsigned in = xs + (nt % PBUF) * (4 * ROWS * XPITCH);
    const unsigned out = hs + (nt & 1) * (8 * ROWS);
    const int left = T - nt * TILE;
    if (left >= TILE) {
      // one basic block: the tile's loads first, then the chain; each half
      // tile's bits are the history's last 32 after it
      float y[TILE];
#pragma unroll
      for (int q = 0; q < TILE / 4; ++q) {
        const float4 v = lds128(in + 16 * q);
        y[4 * q] = v.x;
        y[4 * q + 1] = v.y;
        y[4 * q + 2] = v.z;
        y[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int u = 0; u < TILE; ++u) {
        enc_step<ONE>(y[u], ref, delta, hist, a1, a0, p);
        if (u % HALF == HALF - 1) sts32(out + 4 * (u / HALF), hist);
      }
    } else {
      for (int u = 0; u < left; ++u) {
        enc_step<ONE>(lds32(in + 4 * u), ref, delta, hist, a1, a0, p);
        if (u == HALF - 1) sts32(out, hist);
      }
      sts32(out + (left > HALF ? 4 : 0), hist);
    }
    tile_barrier();
  }
}

__global__ void __launch_bounds__(2 * LANES)
    cvsd_decode_kernel(const uint8_t* __restrict__ bits,
                       float* __restrict__ audio, int rows, int T, Params p) {
  __shared__ __align__(16) unsigned sw[PBUF][ROWS * WPITCH];   // raw bytes
  __shared__ __align__(16) float2 sk[2][ROWS * KPITCH];        // (k, s)
  __shared__ __align__(16) float sy[2][ROWS * YPITCH];         // outputs
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * ROWS;
  const int nch = min(ROWS, rows - r0);
  const int ntiles = (T + TILE - 1) / TILE;
  const unsigned rowT = static_cast<unsigned>(T);

  if (threadIdx.x >= LANES) {
    // the copy warp.  Row r's bytes start off[r] bytes into the aligned
    // word at wrow[r]; a tile (64 bytes) spans up to 17 words.  Addresses
    // are computed once: per row in device memory (opaque registers), by
    // constant offsets in shared memory
    const uint8_t* wrow[ROWS];
    float* yrow[ROWS];
    unsigned off[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const size_t start = static_cast<size_t>(r0 + r) * rowT;
      const uintptr_t a = reinterpret_cast<uintptr_t>(bits + start);
      off[r] = static_cast<unsigned>(a & 3u);
      wrow[r] = opaque(reinterpret_cast<const uint8_t*>(a - off[r]) +
                       4 * lane);
      yrow[r] = opaque(audio + start + lane);
    }
    const unsigned sw0 = smem_addr(&sw[0][0]);
    const unsigned sk0 = smem_addr(&sk[0][0]) + 8 * lane;
    const unsigned sy0 = smem_addr(&sy[0][0]) + 4 * lane;
    // tile nt's words, word w of each row by lane w (those that hold a
    // byte of the tile); closes a group
    auto stage = [&](int nt) {
      const unsigned f = static_cast<unsigned>(nt) * TILE;
      if (f < rowT) {
        const unsigned n = min(static_cast<unsigned>(TILE), rowT - f);
        const unsigned dst =
            sw0 + 4 * lane + (nt % PBUF) * (4 * ROWS * WPITCH);
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          if (r < nch && 4u * lane < off[r] + n)
            cp_async_f32_at(dst + 4 * r * WPITCH,
                            reinterpret_cast<const float*>(wrow[r] + f));
      }
      cp_async_commit();
    };
    // bitref carried from the last half tile
    unsigned carry[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) carry[r] = 0u;
    // tile nt's bytes to its factors and signs, a half tile at a time
    auto prepare = [&](int nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned f = static_cast<unsigned>(nt) * TILE + h * HALF;
        if (f >= rowT) break;
        const unsigned n = min(static_cast<unsigned>(HALF), rowT - f);
        const unsigned src =
            sw0 + lane + h * HALF + (nt % PBUF) * (4 * ROWS * WPITCH);
        unsigned b[ROWS], rec[ROWS], last[ROWS], any = 0u;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          b[r] = r < nch && lane < n ? lds8(src + 4 * r * WPITCH + off[r])
                                     : 0u;
          any |= b[r];
        }
        // bit j of rec: plane q of the byte j samples back, at bit j + q;
        // last: the same at lane 31, every lane's (the carry to the next
        // half tile).  Planes past the first only where a byte is more
        // than a bit
        const unsigned back = 31 - lane;
        const int planes = __any_sync(FULL, any > 1u) ? p.planes : 1;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          last[r] = __brev(__ballot_sync(FULL, b[r] & 1u));
          rec[r] = last[r] >> back;
        }
        for (int q = 1; q < planes; ++q) {
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const unsigned v = __brev(__ballot_sync(FULL, (b[r] >> q) & 1u));
            rec[r] |= (v >> back) << q;
            last[r] |= v << q;
          }
        }
        const unsigned dst =
            sk0 + 8 * h * HALF + (nt & 1) * (8 * ROWS * KPITCH);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const unsigned bitref =
              (((carry[r] << lane) << 1) | rec[r]) & p.mask;
          const bool agree = bitref == 0u || bitref == p.mask;
          sts64(dst + 8 * r * KPITCH, agree ? p.zeta : p.rzeta,
                b[r] == 1u ? 1.0f : -1.0f);
          carry[r] = last[r] & p.mask;
        }
      }
    };
    // tile nt's outputs from shared memory to their rows, as full lines:
    // the loads, then the stores
    auto store = [&](int nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned f = static_cast<unsigned>(nt) * TILE + h * HALF;
        if (f + lane < rowT) {
          const unsigned src = sy0 + 4 * h * HALF +
                               (nt & 1) * (4 * ROWS * YPITCH);
          float v[ROWS];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) v[r] = lds32(src + 4 * r * YPITCH);
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            if (r < nch) yrow[r][f] = v[r];
        }
      }
    };
#pragma unroll
    for (int nt = 0; nt < AHEAD; ++nt) stage(nt);
    cp_async_wait_all_but<AHEAD - 1>();
    __syncwarp();                         // other lanes' words have landed
    prepare(0);
    tile_barrier();
    for (int nt = 0; nt < ntiles; ++nt) {
      if (nt > 0) store(nt - 1);
      stage(nt + AHEAD);
      cp_async_wait_all_but<AHEAD - 1>();
      __syncwarp();
      if (nt + 1 < ntiles) prepare(nt + 1);
      tile_barrier();
    }
    if (ntiles > 0) store(ntiles - 1);
    return;
  }

  // the chain warp: lane l runs row l % ROWS
  const int row = lane % ROWS;
  const unsigned ks = smem_addr(&sk[0][0]) + 8 * row * KPITCH;
  const unsigned ys = smem_addr(&sy[0][0]) + 4 * row * YPITCH;
  float ref = 0.f, delta = 0.01f, v0 = 0.f, v1 = 0.f;
  tile_barrier();
  for (int nt = 0; nt < ntiles; ++nt) {
    const unsigned in = ks + (nt & 1) * (8 * ROWS * KPITCH);
    const unsigned out = ys + (nt & 1) * (4 * ROWS * YPITCH);
    const int left = T - nt * TILE;
    if (left >= TILE) {
      float k[TILE], s[TILE];
#pragma unroll
      for (int q = 0; q < TILE / 2; ++q) {
        const float4 v = lds128(in + 16 * q);
        k[2 * q] = v.x;
        s[2 * q] = v.y;
        k[2 * q + 1] = v.z;
        s[2 * q + 1] = v.w;
      }
#pragma unroll
      for (int u = 0; u < TILE; ++u)
        sts32(out + 4 * u, dec_step(k[u], s[u], ref, delta, v0, v1, p));
    } else {
      for (int u = 0; u < left; ++u) {
        const float2 v = lds64(in + 8 * u);
        sts32(out + 4 * u, dec_step(v.x, v.y, ref, delta, v0, v1, p));
      }
    }
    tile_barrier();
  }
}

}  // namespace

// mode 0: encode float32 x [rows, T] -> uint8 bits; mode 1: decode uint8
// bits -> float32 audio.  `a` is alpha for encode and -a1 for decode, `b`
// is -a2 (decode only).  mask = 2^num_bits - 1 with num_bits <= 31.
extern "C" int cvsd_scan_launch(const void* in, void* out, int rows, int T,
                                int mode, unsigned mask, float zeta,
                                float rzeta, float a, float b, void* stream) {
  if (rows < 0 || T < 0 || mode < 0 || mode > 1 || mask == 0u ||
      mask > 0x7FFFFFFFu || (mask & (mask + 1)) != 0u)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || T == 0) return 0;
  const int nbits = __builtin_popcount(mask);
  const Params p{mask, mask >> 2, nbits < 8 ? nbits : 8, zeta, rzeta, a, a,
                 b};
  const dim3 grid((rows + ROWS - 1) / ROWS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0 && mask == 1u)   // num_bits 1: every step agrees
    cvsd_encode_kernel<true><<<grid, 2 * LANES, 0, s>>>(
        static_cast<const float*>(in), static_cast<uint8_t*>(out), rows, T, p);
  else if (mode == 0)
    cvsd_encode_kernel<false><<<grid, 2 * LANES, 0, s>>>(
        static_cast<const float*>(in), static_cast<uint8_t*>(out), rows, T, p);
  else
    cvsd_decode_kernel<<<grid, 2 * LANES, 0, s>>>(
        static_cast<const uint8_t*>(in), static_cast<float*>(out), rows, T, p);
  return static_cast<int>(cudaGetLastError());
}
