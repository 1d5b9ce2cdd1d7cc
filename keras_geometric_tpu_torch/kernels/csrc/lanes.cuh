// Shared device helpers of the attention kernels (attend.cu, sddmm.cu,
// softmax.cu): storage types, packs of neighbouring columns, sub-warp groups
// that own one head's columns, the GATv2 score and the online softmax step
// that every score kernel shares, the launcher's layout choice and the fixed-
// order reduction of per-group partials.
//
// A group of `lph` lanes (a power of two, at most a warp) owns one head's F
// columns of one row or edge slot. A lane holds NJ packs of VEC neighbouring
// columns (pack j of lane t starts at column (j*lph + t)*VEC) and moves each
// pack with one load or store of up to 16 bytes; VEC is the widest vector
// that divides F and the pointers' alignment, so any F >= 1 works, up to
// 32 lanes * kMaxPerLane columns. Data arrive in f32 or bf16 (raw uint16_t
// bits); every sum is taken in f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocksPerSm = 4;  // caps the registers at 64 a thread
constexpr int kMaxPerLane = 8;      // columns a lane holds at most (VEC * NJ)
constexpr int kBlocksPerSm = 16;    // fixed grid of the kernels with partials

__device__ __forceinline__ float bf16_bits_to_float(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

__device__ __forceinline__ uint16_t float_to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Storage types: float for f32 data, raw uint16_t bits for bf16 data.
template <typename S> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
};
template <> struct Cvt<uint16_t> {
  static __device__ __forceinline__ float to_f(uint16_t v) {
    return bf16_bits_to_float(v);
  }
  static __device__ __forceinline__ uint16_t from_f(float v) {
    return float_to_bf16_bits(v);
  }
};

// VEC neighbouring values, moved with one load or store.
template <typename S, int VEC>
struct alignas(sizeof(S) * VEC) Pack {
  S v[VEC];
};

template <typename S, int VEC>
__device__ __forceinline__ void load_pack(const S* p, float (&out)[VEC]) {
  const Pack<S, VEC> pack = *reinterpret_cast<const Pack<S, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = Cvt<S>::to_f(pack.v[i]);
}

template <typename S, int VEC>
__device__ __forceinline__ void store_pack(S* p, const float (&in)[VEC]) {
  Pack<S, VEC> pack;
#pragma unroll
  for (int i = 0; i < VEC; ++i) pack.v[i] = Cvt<S>::from_f(in[i]);
  *reinterpret_cast<Pack<S, VEC>*>(p) = pack;
}

// att and the keep mask arrive in f32 or bf16 whatever the data's type.
__device__ __forceinline__ float load_scalar(const void* p, int is_bf16,
                                             int64_t i) {
  if (is_bf16) return bf16_bits_to_float(static_cast<const uint16_t*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ unsigned group_mask(int lph) {
  if (lph >= 32) return 0xffffffffu;
  const int first = ((threadIdx.x & 31) / lph) * lph;
  return ((1u << lph) - 1u) << first;
}

// Butterfly sum over the group's lanes: every lane ends with the same bits.
__device__ __forceinline__ float group_sum(float v, int lph, unsigned mask) {
  for (int off = lph >> 1; off > 0; off >>= 1) {
    v += __shfl_xor_sync(mask, v, off);
  }
  return v;
}

// What one group needs to know about itself.
struct Geometry {
  int lph;      // lanes per group
  int lane;     // this thread's lane in its group
  int64_t gid;  // group index in the grid
  unsigned mask;
};

__device__ __forceinline__ Geometry geometry(int lph) {
  Geometry q;
  q.lph = lph;
  const int sub = threadIdx.x / lph;
  q.lane = threadIdx.x - sub * lph;
  q.gid = static_cast<int64_t>(blockIdx.x) * (kThreads / lph) + sub;
  q.mask = group_mask(lph);
  return q;
}

// First column of pack j of this lane; the pack lies inside the head's F
// columns or wholly outside (F is a multiple of VEC).
template <int VEC>
__device__ __forceinline__ int pack_column(const Geometry& q, int j) {
  return (j * q.lph + q.lane) * VEC;
}

// This lane's packs of one row's head: zeros outside the head.
template <typename S, int VEC, int NJ>
__device__ __forceinline__ void load_lane(const S* head, int f,
                                          const Geometry& q,
                                          float (&out)[NJ][VEC]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = pack_column<VEC>(q, j);
    if (c < f) {
      load_pack<S, VEC>(head + c, out[j]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) out[j][i] = 0.0f;
    }
  }
}

template <typename S, int VEC, int NJ>
__device__ __forceinline__ void store_lane(S* head, int f, const Geometry& q,
                                           const float (&in)[NJ][VEC]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = pack_column<VEC>(q, j);
    if (c < f) store_pack<S, VEC>(head + c, in[j]);
  }
}

// This lane's columns of att (f32 or bf16 by its own flag).
template <int VEC, int NJ>
__device__ __forceinline__ void load_att(const void* att, int att_bf16,
                                         int64_t col0, int f,
                                         const Geometry& q,
                                         float (&out)[NJ][VEC]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = pack_column<VEC>(q, j);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      out[j][i] = c < f ? load_scalar(att, att_bf16, col0 + c + i) : 0.0f;
    }
  }
}

// The GATv2 score of one (slot, head), sum_f att * leaky_relu(hi + hj), on
// every lane of the group. Every kernel that computes or recomputes a score
// (sddmm.cu's score kernels, attend.cu's forward and backward kernels) calls
// this one function: the lane's columns in pack order, then the group's
// butterfly. Inlined everywhere as the same expression, it compiles to the
// same operations (nvcc contracts part + a * z into one fused multiply-add
// and, without fast-math, reassociates nothing), so for the same layout
// (pick_layout: F, the type, and 16-byte aligned data) a recomputed score is
// the forward's bit for bit and exp(s - m) in a backward kernel sees exactly
// the forward's s. (Rounding intrinsics in place of the plain expressions
// gave the same bits and measured 6% slower in the forward and 14% in the
// sender backward on the H100.)
template <int VEC, int NJ>
__device__ __forceinline__ float gatv2_score(const float (&hi)[NJ][VEC],
                                             const float (&hj)[NJ][VEC],
                                             const float (&a)[NJ][VEC],
                                             float slope, int lph,
                                             unsigned mask) {
  float part = 0.0f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float pre = hi[j][i] + hj[j][i];
      part += a[j][i] * (pre > 0.0f ? pre : slope * pre);
    }
  }
  return group_sum(part, lph, mask);
}

// Folds a finite score s into a row's running max m and normaliser l (the
// online softmax); sets p = exp(s - m_new) and returns exp(m_old - m_new),
// the factor that rescales what was summed under the old max (0 while m is
// still -inf). The forward kernels and the score-and-statistics kernel share
// it, so their m and l agree bit for bit.
__device__ __forceinline__ float online_step(float s, float& m, float& l,
                                             float& p) {
  const float m_new = fmaxf(m, s);
  const float scale = expf(m - m_new);
  p = expf(s - m_new);
  l = l * scale + p;
  m = m_new;
  return scale;
}

template <int VEC, int NJ>
__device__ __forceinline__ void zero_lane(float (&v)[NJ][VEC]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[j][i] = 0.0f;
  }
}

// A group's partial of datt (its head's columns) into its row of the
// partials: one row per `heads` groups of a grid whose group count is a
// multiple of `heads`, so that the group's head is gid % heads.
template <int VEC, int NJ>
__device__ __forceinline__ void store_partial(float* partial, int heads,
                                              int64_t d, int64_t col0, int f,
                                              const Geometry& q,
                                              const float (&acc)[NJ][VEC]) {
  float* row = partial + (q.gid / heads) * d + col0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = pack_column<VEC>(q, j);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if (c < f) row[c + i] = acc[j][i];
    }
  }
}

// datt[c] = sum over the partial rows, in a fixed order: one block per
// column, threads stride over the rows, then a tree in shared memory.
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ partial,
                       float* __restrict__ datt, int64_t p_rows, int64_t d) {
  __shared__ float buf[kThreads];
  const int64_t c = blockIdx.x;
  float acc = 0.0f;
  for (int64_t p = threadIdx.x; p < p_rows; p += kThreads) {
    acc += partial[p * d + c];
  }
  buf[threadIdx.x] = acc;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) buf[threadIdx.x] += buf[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) datt[c] = buf[0];
}

// How a head's F columns are laid over lanes: packs of `vec` columns, `lph`
// lanes per head, `nj` packs per lane.
struct Layout {
  int vec, lph, nj;
};

inline bool aligned_to(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

// Widest pack (in elements, at most 16 bytes) that divides F and keeps every
// row of every data array aligned; then the power of two of lanes that
// covers the head's packs, at most a warp; then the packs per lane, rounded
// up to a power of two.
inline Layout pick_layout(int64_t f, int elem_size, const void* a,
                          const void* b, const void* c, const void* d) {
  Layout lay;
  lay.vec = 16 / elem_size;
  while (lay.vec > 1) {
    const int bytes = lay.vec * elem_size;
    if (f % lay.vec == 0 && aligned_to(a, bytes) && aligned_to(b, bytes) &&
        aligned_to(c, bytes) && aligned_to(d, bytes)) {
      break;
    }
    lay.vec /= 2;
  }
  const int64_t packs = f / lay.vec;
  lay.lph = 1;
  while (lay.lph < packs && lay.lph < 32) lay.lph <<= 1;
  const int64_t need = (packs + lay.lph - 1) / lay.lph;
  lay.nj = 1;
  while (lay.nj < need) lay.nj <<= 1;
  return lay;
}

// `items` (row, head) or (slot, head) pairs, one group each, fit the grid.
inline bool shape_ok(int64_t items, int heads, int64_t f) {
  return items > 0 && heads >= 1 && f >= 1 &&
         f <= 32 * static_cast<int64_t>(kMaxPerLane) &&
         items * heads < (static_cast<int64_t>(1) << 31);  // grid.x
}

inline unsigned blocks_for_all(int64_t items, int heads, int lph) {
  const int64_t per_block = kThreads / lph;
  return static_cast<unsigned>((items * heads + per_block - 1) / per_block);
}

// The fixed grid of a kernel whose groups stride over the pairs with their
// head held constant: enough blocks to fill the card, no more than the work
// needs, rounded up to a multiple of `heads`.
inline unsigned blocks_for_fixed_grid(int64_t items, int heads, int lph) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  int64_t blocks = static_cast<int64_t>(sms) * kBlocksPerSm;
  const int64_t all = blocks_for_all(items, heads, lph);
  if (blocks > all) blocks = all;
  blocks = (blocks + heads - 1) / heads * heads;
  return static_cast<unsigned>(blocks);
}

// Rows of datt partials such a grid writes at `lph` lanes per head: one per
// `heads` groups.
inline int64_t partial_rows(int64_t items, int heads, int lph) {
  return static_cast<int64_t>(blocks_for_fixed_grid(items, heads, lph)) *
         (kThreads / lph) / heads;
}

// Sums the partials into datt [d] f32 in a fixed order.
inline cudaError_t reduce_partials(const float* partial, float* datt,
                                   int64_t p_rows, int64_t d,
                                   cudaStream_t s) {
  reduce_partials_kernel<<<static_cast<unsigned>(d), kThreads, 0, s>>>(
      partial, datt, p_rows, d);
  return cudaGetLastError();
}

}  // namespace

// Runs LAUNCH(S) with VEC and NJ bound to the layout's compile-time values.
// Only layouts with VEC * NJ <= kMaxPerLane exist (pick_layout makes no
// other for F <= 32 * kMaxPerLane).
#define KGT_CASE(V, N, LAUNCH, S)                 \
  case (V) * 16 + (N): {                          \
    constexpr int VEC = (V);                      \
    constexpr int NJ = (N);                       \
    LAUNCH(S);                                    \
  } break;
#define KGT_CASES_UP_TO_4(LAUNCH, S)                                       \
  KGT_CASE(4, 1, LAUNCH, S) KGT_CASE(4, 2, LAUNCH, S)                      \
  KGT_CASE(2, 1, LAUNCH, S) KGT_CASE(2, 2, LAUNCH, S)                      \
  KGT_CASE(2, 4, LAUNCH, S) KGT_CASE(1, 1, LAUNCH, S)                      \
  KGT_CASE(1, 2, LAUNCH, S) KGT_CASE(1, 4, LAUNCH, S)                      \
  KGT_CASE(1, 8, LAUNCH, S)
#define KGT_DISPATCH(is_bf16, lay, LAUNCH)                                 \
  if (is_bf16) {                                                           \
    switch ((lay).vec * 16 + (lay).nj) {                                   \
      KGT_CASE(8, 1, LAUNCH, uint16_t)                                     \
      KGT_CASES_UP_TO_4(LAUNCH, uint16_t)                                  \
      default: return static_cast<int>(cudaErrorInvalidValue);             \
    }                                                                      \
  } else {                                                                 \
    switch ((lay).vec * 16 + (lay).nj) {                                   \
      KGT_CASES_UP_TO_4(LAUNCH, float)                                     \
      default: return static_cast<int>(cudaErrorInvalidValue);             \
    }                                                                      \
  }
