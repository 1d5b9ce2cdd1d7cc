// Integer division by a divisor fixed for a launch, for the kernels that
// find their (slot or piece, pack) item from a flat thread index: spmm.cu's
// messages form and expand (K1, K2) and softmax.cu's normalisation (K6).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// x / d for 0 <= x < 2^31 by a multiply-high and a shift (d >= 1), so that a
// thread finds its item from a flat index without an integer division.
struct FastDiv {
  uint32_t d, mul, shift;
};

inline FastDiv make_fast_div(uint32_t d) {
  FastDiv q{d, 0, 0};
  if (d > 1) {
    uint32_t l = 0;
    while ((1u << l) < d) ++l;  // ceil(log2(d))
    q.mul = static_cast<uint32_t>(((uint64_t{1} << (31 + l)) + d - 1) / d);
    q.shift = l - 1;
  }
  return q;
}

__device__ __forceinline__ uint32_t fast_div(const FastDiv& q, uint32_t x) {
  return q.d == 1 ? x : __umulhi(x, q.mul) >> q.shift;
}

}  // namespace
