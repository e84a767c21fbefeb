// Asynchronous global -> shared copies (cp.async, sm_80 and later) for the
// kernels that stage tiles ahead of a serial chain: the copy is started by
// any lane, runs while the chain computes, and is waited for one tile later.
//
// cp_async_f32 copies one float (4 bytes, the smallest cp.async size, so no
// alignment beyond the float's own is asked of the caller's rows); a warp
// that copies 32 neighbouring floats moves one full 128-byte line.

#pragma once

#include <cuda_runtime.h>

// The shared-memory address of a generic pointer into shared memory.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One float to the shared-memory address dst: a copy loop that keeps its
// destinations as a base address plus constant offsets spends one
// instruction a line on them, not a generic-to-shared conversion.
__device__ __forceinline__ void cp_async_f32_at(unsigned dst,
                                                const float* gmem_src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(gmem_src) : "memory");
}

// p as an opaque register value.  A copy loop's base pointers derive from
// kernel parameters, and ptxas may rebuild them line by line from the
// constant bank (a load and a 64-bit address chain a line, ~33 cycles)
// rather than keep them in a register; through this it cannot.
template <typename T>
__device__ __forceinline__ T* opaque(T* p) {
  asm volatile("" : "+l"(p));
  return p;
}

__device__ __forceinline__ void cp_async_f32(float* smem_dst,
                                             const float* gmem_src) {
  cp_async_f32_at(smem_addr(smem_dst), gmem_src);
}

// 16 bytes at once (both addresses 16-byte aligned), past the L1 cache.
__device__ __forceinline__ void cp_async_16(void* smem_dst,
                                            const void* gmem_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(gmem_src) : "memory");
}

// Close the copies started so far into one group.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until all but the newest N groups of this thread have landed.
template <int N>
__device__ __forceinline__ void cp_async_wait_all_but() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Where a chain warp and the warp that copies for it meet, once per tile
// (agc_scan, iir_scan, iir_block_state): named barrier 1 for the block's
// two warps.
__device__ __forceinline__ void tile_barrier() {
  asm volatile("bar.sync 1, 64;\n" ::: "memory");
}

// Wait until every copy this thread has started has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
