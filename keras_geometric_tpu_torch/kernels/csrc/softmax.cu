// The sorted edge softmax for Hopper (sm_90a): per-receiver statistics and
// the normalisation, over receiver-sorted [E, K] f32 edge scores.
//
// They replace two TPU kernels of the JAX package:
//   softmax_stats_kernel <- kernels/softmax_pallas.py softmax_stats_sorted
//   softmax_apply_kernel <- kernels/softmax_pallas.py softmax_apply_sorted
//
// stats: m[r, k] = max over the row's slots of s[e, k], and
//        l[r, k] = sum over them of exp(s[e, k] - m[r, k]);
//        masked slots arrive as -inf and add nothing; m is stored as 0 and l
//        as 0 for a row without a finite score (the reference's fixup).
// apply: alpha[e, k] = exp(s[e, k] - m[recv[e], k]) / (l[recv[e], k] + eps),
//        stored in f32 or bf16; -inf slots and rows without a finite score
//        come out 0.
//
// The TPU kernels reach the rows through one-hot matrix products over a
// boundary-encoded work list (that machine has no vector gather). Here:
//
// - stats: one warp per receiver row, its lanes striding over the row's
//   slots row_ptr[r] .. row_ptr[r+1], so a 20,000-slot hub row is 625 loads
//   a lane, not 20,000 dependent steps of one group. Each lane keeps an
//   online (m, l) pair per head, the flash-attention recurrence
//   l <- l * exp(m_old - m_new) + exp(s - m_new); the lanes merge their
//   pairs by butterfly shuffles with the same rescaling. A lane or pair that
//   has seen only -inf keeps m = -inf, l = 0 and is never rescaled, so
//   exp(-inf - (-inf)) is never formed. Heads are taken eight at a time, so
//   any K works. Bound by bytes (the [E, K] score stream, read once).
// - apply: edge-parallel, one thread per (slot, head): no row walk, so a hub
//   row is no hazard. Bound by bytes (scores in, alpha out).
//
// Sums are f32 in registers, no atomics. Offsets into data are 64-bit;
// indices and row_ptr are int32; row_ptr[0] must be 0 and row_ptr[N] the
// slot count. The C entry points launch on the given stream, allocate
// nothing, do not synchronise, and return cudaGetLastError().

#include "lanes.cuh"

namespace {

constexpr int kHeadsPerPass = 8;  // heads a lane keeps (m, l) for at once
constexpr int kApplyBlocksPerSm = 32;

// Merge of two online pairs: (m, l) absorbs (mo, lo).
__device__ __forceinline__ void merge(float& m, float& l, float mo, float lo) {
  const float m_new = fmaxf(m, mo);
  if (m_new > -INFINITY) {  // else both are (-inf, 0) and stay so
    l = l * expf(m - m_new) + lo * expf(mo - m_new);
    m = m_new;
  }
}

__global__ void __launch_bounds__(kThreads)
softmax_stats_kernel(const float* __restrict__ scores,
                     const int32_t* __restrict__ row_ptr,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int64_t n_rows, int heads) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (row >= n_rows) return;  // the whole warp: one row per warp
  const int lane = threadIdx.x & 31;
  const int64_t lo = row_ptr[row], hi = row_ptr[row + 1];

  for (int k0 = 0; k0 < heads; k0 += kHeadsPerPass) {
    const int kc = min(kHeadsPerPass, heads - k0);  // the same on every lane
    float m[kHeadsPerPass], l[kHeadsPerPass];
#pragma unroll
    for (int k = 0; k < kHeadsPerPass; ++k) {
      m[k] = -INFINITY;
      l[k] = 0.0f;
    }
    for (int64_t e = lo + lane; e < hi; e += 32) {
      const float* s_e = scores + e * heads + k0;
#pragma unroll
      for (int k = 0; k < kHeadsPerPass; ++k) {
        if (k < kc) {
          const float s = s_e[k];
          if (s > -INFINITY) {
            const float m_new = fmaxf(m[k], s);
            l[k] = l[k] * expf(m[k] - m_new) + expf(s - m_new);
            m[k] = m_new;
          }
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < kHeadsPerPass; ++k) {
        if (k < kc) {
          const float mo = __shfl_xor_sync(0xffffffffu, m[k], off);
          const float lo_k = __shfl_xor_sync(0xffffffffu, l[k], off);
          merge(m[k], l[k], mo, lo_k);
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kHeadsPerPass; ++k) {
        if (k < kc) {
          m_out[row * heads + k0 + k] = m[k] > -INFINITY ? m[k] : 0.0f;
          l_out[row * heads + k0 + k] = l[k];
        }
      }
    }
  }
}

template <typename O>
__global__ void __launch_bounds__(kThreads)
softmax_apply_kernel(const float* __restrict__ scores,
                     const int32_t* __restrict__ recv,
                     const float* __restrict__ m, const float* __restrict__ l,
                     O* __restrict__ alpha, int64_t n_slots, int heads,
                     float eps) {
  const int64_t total = n_slots * heads;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += stride) {
    const int64_t e = i / heads;
    const int64_t r = static_cast<int64_t>(recv[e]) * heads + (i - e * heads);
    alpha[i] = Cvt<O>::from_f(expf(scores[i] - m[r]) / (l[r] + eps));
  }
}

unsigned apply_blocks(int64_t total) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  const int64_t cap = static_cast<int64_t>(sms) * kApplyBlocksPerSm;
  const int64_t need = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned>(need < cap ? need : cap);
}

}  // namespace

extern "C" {

// m, l [n_rows, heads] f32 from scores [n_slots, heads] f32 (masked slots
// -inf) and the row pointers of the sorted receivers.
int kgt_softmax_stats_sorted(const float* scores, const int32_t* row_ptr,
                             float* m, float* l, int64_t n_rows, int heads,
                             void* stream) {
  if (scores == nullptr || row_ptr == nullptr || m == nullptr ||
      l == nullptr || n_rows <= 0 || heads < 1 ||
      (n_rows + kThreads / 32 - 1) / (kThreads / 32) >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(
      (n_rows + kThreads / 32 - 1) / (kThreads / 32));
  softmax_stats_kernel<<<grid, kThreads, 0, s>>>(scores, row_ptr, m, l,
                                                 n_rows, heads);
  return static_cast<int>(cudaGetLastError());
}

// alpha [n_slots, heads] in f32 (out_bf16 = 0) or bf16.
int kgt_softmax_apply_sorted(const float* scores, const int32_t* recv,
                             const float* m, const float* l, void* alpha,
                             int64_t n_slots, int heads, float eps,
                             int out_bf16, void* stream) {
  if (scores == nullptr || recv == nullptr || m == nullptr || l == nullptr ||
      alpha == nullptr || n_slots <= 0 || heads < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = apply_blocks(n_slots * heads);
  if (out_bf16) {
    softmax_apply_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        scores, recv, m, l, static_cast<uint16_t*>(alpha), n_slots, heads,
        eps);
  } else {
    softmax_apply_kernel<float><<<grid, kThreads, 0, s>>>(
        scores, recv, m, l, static_cast<float*>(alpha), n_slots, heads, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kgt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
