// Asynchronous global -> shared copies (cp.async, sm_80 and later) for the
// kernels that stage tiles ahead of a serial chain: the copy is started by
// any lane, runs while the chain computes, and is waited for one tile later.
//
// cp_async_f32 copies one float (4 bytes, the smallest cp.async size, so no
// alignment beyond the float's own is asked of the caller's rows); a warp
// that copies 32 neighbouring floats moves one full 128-byte line.

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void cp_async_f32(float* smem_dst,
                                             const float* gmem_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(gmem_src) : "memory");
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

// Wait until all but the newest group of this thread have landed.
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Wait until every copy this thread has started has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
