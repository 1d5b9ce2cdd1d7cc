// Asynchronous copies from device memory into shared memory (cp.async, sm_80
// and later), shared by the kernels that keep gathered rows in flight in a
// ring: attend.cu's piece walks and spmm.cu's fused-gather piece walk.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Asynchronous copy of one pack (VEC values) into shared memory. cp.async
// moves 4, 8 or 16 bytes; a 2-byte pack (bf16 at an odd F) is copied by the
// thread itself.
template <int BYTES>
__device__ __forceinline__ void copy_async(uint32_t dst, const void* src) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src) : "memory");
  } else if constexpr (BYTES == 8 || BYTES == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                 "l"(src), "n"(BYTES) : "memory");
  } else {
    const uint16_t v = *static_cast<const uint16_t*>(src);
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(v) : "memory");
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t shared_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

}  // namespace
