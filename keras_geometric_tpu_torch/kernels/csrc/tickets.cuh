// Arrival tickets of the kernels that merge a split row in the same launch
// as its pieces: spmm.cu's messages form (K1) and segment_max.cu's narrow
// segment max (K3). Each split row (and column pack) has an int32 counter,
// kept at zero between launches; a piece stores its share, then draws its
// row's ticket, and the piece that draws the last one reads the shares back
// (load_share), merges them and returns the counter to zero.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Adds one to a split row's ticket and returns the count before it, with
// release and acquire at device scope: this thread's share is visible to the
// thread that draws the last ticket, and that thread sees every share. (A
// __threadfence() on both sides of a relaxed atomicAdd orders the same and
// took the Cora-shaped scatter 8% longer on the H100, PERF.md.)
__device__ __forceinline__ int32_t take_ticket(int32_t* ticket) {
  int32_t drawn;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(drawn) : "l"(ticket) : "memory");
  return drawn;
}

// The split row whose pieces include one of row `row` (fix_rows ascends).
__device__ __forceinline__ int64_t find_split_row(
    const int32_t* __restrict__ fix_rows, int64_t n_fix, int32_t row) {
  int64_t lo = 0, hi = n_fix - 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (fix_rows[mid] < row) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// VEC f32 values of a split row's share, read back from L2 (cg: other SMs
// wrote them in this launch).
template <int VEC>
__device__ __forceinline__ void load_share(float (&v)[VEC], const float* p) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      const float4 q = __ldcg(reinterpret_cast<const float4*>(p + j));
      v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
    }
  } else if constexpr (VEC == 2) {
    const float2 q = __ldcg(reinterpret_cast<const float2*>(p));
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = __ldcg(p);
  }
}

}  // namespace
