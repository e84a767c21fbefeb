// The preamble receivers' greedy in-order suppression fold, for Hopper
// (sm_90a).
//
// Replaces the lax.scan of liquid_dsp_tpu/framing/stream_rx.py:311-324
// (`_suppress` in `_detect_refine`), of liquid_dsp_tpu/multichannel/
// ofdm.py:497-502 (`s0_detect_block`) and of liquid_dsp_tpu/parallel/
// rx.py:127-135 (the time-sharded receiver's fold over every shard's
// segments); the JAX package has no Pallas kernel here.  Once a frame
// fires, nothing fires again for `span` samples: per row b, from
// le = last_end[b], over the segments s = 0 .. S-1 in order,
//   pc      = cand[b, s] ? pos[b, s] : -2^40   (below any watermark)
//   keep    = pc >= le
//   le      = keep ? pos[b, s] + span : le
// in int64, whatever the input types (int32 or int64 watermarks and
// positions), as the plain version (ops/kernels/suppress_scan.py) does.
// Integer compares and selects: the kernel equals it bit for bit.
//
// Bound on this card: the chain and the launch.  The bytes are few (at
// 128 rows x 129 segments: 1 + 8 bytes in and 1 out a segment, 0.17 MB,
// 0.05 us at 3.35 TB/s), and each segment needs the last one's watermark.
// A warp takes a row: its 32 lanes load 32 segments at once (coalesced),
// then every lane walks the 32 in turn with the candidate's position and
// its end broadcast by __shfl_sync (loads and shuffles do not depend on
// the watermark, so only a 64-bit compare and select sit on the chain),
// and lane i keeps step i's verdict and stores it with the others.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr long long kNonCand = -(1LL << 40);
constexpr int kWarps = 4;  // rows a block

template <typename LE, typename POS>
__global__ void __launch_bounds__(32 * kWarps)
suppress_scan_kernel(const LE* __restrict__ last_end,
                     const uint8_t* __restrict__ cand,
                     const POS* __restrict__ pos, uint8_t* __restrict__ keep,
                     int B, int S, long long span) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp leaves together
  const size_t base = static_cast<size_t>(b) * S;
  long long le = static_cast<long long>(last_end[b]);
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int n = min(32, S - s0);
    long long pc = kNonCand, pe = 0;
    if (lane < n) {
      const long long p = static_cast<long long>(pos[base + s0 + lane]);
      pc = cand[base + s0 + lane] ? p : kNonCand;
      pe = p + span;
    }
    bool mine = false;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const long long pi = __shfl_sync(0xffffffffu, pc, i);
      const long long ei = __shfl_sync(0xffffffffu, pe, i);
      const bool ki = (i < n) & (pi >= le);
      le = ki ? ei : le;
      mine = (lane == i) ? ki : mine;
    }
    if (lane < n) keep[base + s0 + lane] = mine ? 1 : 0;
  }
}

template <typename LE, typename POS>
int launch(const void* last_end, const void* cand, const void* pos,
           void* keep, int B, int S, long long span, cudaStream_t stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  suppress_scan_kernel<LE, POS><<<blocks, 32 * kWarps, 0, stream>>>(
      static_cast<const LE*>(last_end), static_cast<const uint8_t*>(cand),
      static_cast<const POS*>(pos), static_cast<uint8_t*>(keep), B, S, span);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// last_end [B] (int64 if le64 else int32), cand [B, S] bool (one byte
// each, 0 or 1), pos [B, S] (int64 if pos64 else int32), keep [B, S] bool
// out; all contiguous on one card.  Returns cudaGetLastError().
extern "C" int suppress_scan_launch(const void* last_end, const void* cand,
                                    const void* pos, void* keep, int B,
                                    int S, int le64, int pos64,
                                    long long span, void* stream) {
  if (B < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (le64)
    return pos64 ? launch<long long, long long>(last_end, cand, pos, keep, B,
                                                S, span, st)
                 : launch<long long, int>(last_end, cand, pos, keep, B, S,
                                          span, st);
  return pos64 ? launch<int, long long>(last_end, cand, pos, keep, B, S, span,
                                        st)
               : launch<int, int>(last_end, cand, pos, keep, B, S, span, st);
}
