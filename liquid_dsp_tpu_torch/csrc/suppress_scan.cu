// The preamble receivers' greedy in-order suppression fold and the ranking
// of its first P kept segments, for Hopper (sm_90a).
//
// Replaces the lax.scan of liquid_dsp_tpu/framing/stream_rx.py:311-324
// (`_suppress` in `_detect_refine`), of liquid_dsp_tpu/multichannel/
// ofdm.py:497-502 (`s0_detect_block`) and of liquid_dsp_tpu/parallel/
// rx.py:127-135 (the time-sharded receiver's fold over every shard's
// segments), and the jnp.nonzero(keep, size=P, fill_value=0) after the
// first two (stream_rx.py:328, ofdm.py:505); the JAX package has no Pallas
// kernel here.  Once a frame fires, nothing fires again for `span`
// samples: per row b, from le = last_end[b], over the segments s = 0 ..
// S-1 in order,
//   pc      = cand[b, s] ? pos[b, s] : -2^40   (below any watermark)
//   keep    = pc >= le
//   le      = keep ? pos[b, s] + span : le
// in int64, whatever the input types (int32 or int64 watermarks and
// positions), as the plain version (ops/kernels/suppress_scan.py) does.
// With the ranking asked for, sel[b, r] = the r-th kept segment for r <
// min(P, n_cand[b]), 0 after, and n_cand[b] = the count kept: the plain
// version's cumsum and scatter.  Integer compares, selects and counts:
// the kernel equals it bit for bit.
//
// Bound on this card: the chain and the launch.  The bytes are few (at
// 128 rows x 129 segments: 1 + 8 bytes in and 1 out a segment, 0.17 MB,
// 0.05 us at 3.35 TB/s), and each segment needs the last one's watermark.
// A warp takes a row, 32 segments a turn.  Each lane issues the next
// turn's loads of `cand` and `pos` before this turn's chain (a turn
// ahead), so only the first turn's memory round trip is exposed.  Then every lane
// walks the 32 segments of the turn with the candidate's position and its
// end broadcast by __shfl_sync (loads and shuffles do not depend on the
// watermark, so only a 64-bit compare and select sit on the chain), and
// lane i keeps step i's verdict.  After each turn a ballot of the
// verdicts and a popc of the lanes below give each kept segment its rank
// from a running count; a lane whose rank is below P writes its segment
// there.  At 128 x 129 on an H100 this takes 3.4 us a launch, 3.7 with
// the ranking; five turns' loads held in registers and rotated a turn at
// a time took 5.8-6.8, a loop pass of 8 steps 5.8, each turn's loads
// after the last one's chain 4.4 (PERF.md): the chain and the
// launch hold it, not the loads, which the receivers' kernels before it
// leave in L2.
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
                     long long* __restrict__ sel,
                     long long* __restrict__ n_cand, int B, int S, int P,
                     int rank, long long span) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp leaves together
  const size_t base = static_cast<size_t>(b) * S;
  long long le = static_cast<long long>(last_end[b]);
  // indices past the row read its last segment again: no branch
  POS p = pos[base + min(lane, S - 1)];
  uint8_t c = cand[base + min(lane, S - 1)];
  const unsigned below = (1u << lane) - 1u;
  int cnt = 0;
  for (int st = 0; st < S; st += 32) {
    // the next turn's loads, before this turn's chain
    const int sn = min(st + 32 + lane, S - 1);
    const POS pn = pos[base + sn];
    const uint8_t cn = cand[base + sn];
    const int n = min(32, S - st);
    const long long pl = static_cast<long long>(p);
    const long long pc = (lane < n && c) ? pl : kNonCand;
    const long long pe = pl + span;
    bool mine = false;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const long long pi = __shfl_sync(0xffffffffu, pc, i);
      const long long ei = __shfl_sync(0xffffffffu, pe, i);
      const bool ki = (i < n) & (pi >= le);
      le = ki ? ei : le;
      mine = (lane == i) ? ki : mine;
    }
    if (lane < n) keep[base + st + lane] = mine ? 1 : 0;
    if (rank) {
      const unsigned bal = __ballot_sync(0xffffffffu, mine);
      const int r = cnt + __popc(bal & below);
      if (mine && r < P) sel[static_cast<size_t>(b) * P + r] = st + lane;
      cnt += __popc(bal);
    }
    p = pn;
    c = cn;
  }
  if (rank) {
    for (int r = cnt + lane; r < P; r += 32)
      sel[static_cast<size_t>(b) * P + r] = 0;
    if (lane == 0) n_cand[b] = cnt;
  }
}

template <typename LE, typename POS>
int launch(const void* last_end, const void* cand, const void* pos,
           void* keep, void* sel, void* n_cand, int B, int S, int P,
           int rank, long long span, cudaStream_t stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  suppress_scan_kernel<LE, POS><<<blocks, 32 * kWarps, 0, stream>>>(
      static_cast<const LE*>(last_end), static_cast<const uint8_t*>(cand),
      static_cast<const POS*>(pos), static_cast<uint8_t*>(keep),
      static_cast<long long*>(sel), static_cast<long long*>(n_cand), B, S, P,
      rank, span);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// last_end [B] (int64 if le64 else int32), cand [B, S] bool (one byte
// each, 0 or 1), pos [B, S] (int64 if pos64 else int32), keep [B, S] bool
// out; with rank, sel [B, P] and n_cand [B] int64 out (else unused).  All
// contiguous on one card.  Returns cudaGetLastError().
extern "C" int suppress_scan_launch(const void* last_end, const void* cand,
                                    const void* pos, void* keep, void* sel,
                                    void* n_cand, int B, int S, int P,
                                    int rank, int le64, int pos64,
                                    long long span, void* stream) {
  if (B < 1 || S < 1 || P < 0 || (rank && n_cand == nullptr) ||
      (rank && P > 0 && sel == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (le64)
    return pos64 ? launch<long long, long long>(last_end, cand, pos, keep,
                                                sel, n_cand, B, S, P, rank,
                                                span, st)
                 : launch<long long, int>(last_end, cand, pos, keep, sel,
                                          n_cand, B, S, P, rank, span, st);
  return pos64 ? launch<int, long long>(last_end, cand, pos, keep, sel,
                                        n_cand, B, S, P, rank, span, st)
               : launch<int, int>(last_end, cand, pos, keep, sel, n_cand, B,
                                  S, P, rank, span, st);
}
