// Shared device helpers of the attention kernels (attend.cu, sddmm.cu,
// softmax.cu) and of segment_max.cu: storage types, packs of neighbouring
// columns, sub-warp groups that own one head's columns, the ring of rows in
// flight that the piece walks keep in shared memory, the GATv2 score and the
// online softmax step that every score kernel shares, the launcher's layout
// choice and the fixed-order reduction of per-group partials.
//
// A group of `lph` lanes (a power of two, at most a warp) owns one head's F
// columns of one row or edge slot. A lane holds NJ packs of VEC neighbouring
// columns (pack j of lane t starts at column (j*lph + t)*VEC) and moves each
// pack with one load or store of up to 16 bytes; VEC is the widest vector
// that divides F and the pointers' alignment, so any F >= 1 works. Data
// arrive in f32 or bf16 (raw uint16_t bits); every sum is taken in f32.
//
// Wide heads. A warp holds at most kSlab = 32 lanes * kMaxPerLane columns
// at once. A head wider than that (F > 256) is cut into 256-column slabs
// (the last one shorter), laid over a warp as a 256-column head would be
// (lph = 32, VEC * NJ = kMaxPerLane), and such a launch is its own
// instantiation (WIDE = true), so that the narrow launches keep their
// registers. A wide kernel gives each group one slab of a (row or slot,
// head) pair where its output has columns, and computes a quantity summed
// over the whole head (a score, a dot product) by walking the head's slabs
// in order and reducing over the group once at the end: gatv2_score_wide
// below, the one score function of every wide kernel, so that a recomputed
// score is again the forward's bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocksPerSm = 4;  // caps the registers at 64 a thread
constexpr int kMaxPerLane = 8;      // columns a lane holds at most (VEC * NJ)
constexpr int kBlocksPerSm = 16;    // fixed grid of the kernels with partials
constexpr int kSlab = 32 * kMaxPerLane;  // columns of a wide head's slab

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

// This lane's share of a GATv2 score: part + sum over the lane's columns of
// att * leaky_relu(hi + hj), in pack order.
template <int VEC, int NJ>
__device__ __forceinline__ float gatv2_part(float part,
                                            const float (&hi)[NJ][VEC],
                                            const float (&hj)[NJ][VEC],
                                            const float (&a)[NJ][VEC],
                                            float slope) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float pre = hi[j][i] + hj[j][i];
      part += a[j][i] * (pre > 0.0f ? pre : slope * pre);
    }
  }
  return part;
}

// A group's ring of DEPTH stages in shared memory, each holding this lane's
// packs of one row's head (a gathered sender row, or a slot's row of a
// contiguous stream): [stage][pack j][thread] packs of VEC values, so the
// threads of a warp touch consecutive words. A lane copies (cp.async) and
// reads only its own packs, so it needs no barrier, only its own waits.
template <typename S, int VEC, int NJ, int DEPTH>
struct PackRing {
  static constexpr int kPack = VEC * static_cast<int>(sizeof(S));
  static constexpr int kBytes = DEPTH * NJ * kThreads * kPack;

  __device__ static int offset(int stage, int j) {
    return ((stage * NJ + j) * kThreads + static_cast<int>(threadIdx.x)) *
           kPack;
  }

  // Starts the copies of this lane's packs of a head (its first column).
  __device__ static void fill(uint8_t* ring, int stage, const S* head, int f,
                              const Geometry& q) {
    const uint32_t base = shared_u32(ring);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = pack_column<VEC>(q, j);
      if (c < f) copy_async<kPack>(base + offset(stage, j), head + c);
    }
  }

  // This lane's packs of a landed stage, zeros outside the head (as
  // load_lane gives them).
  __device__ static void read(const uint8_t* ring, int stage, int f,
                              const Geometry& q, float (&out)[NJ][VEC]) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = pack_column<VEC>(q, j);
      if (c < f) {
        load_pack<S, VEC>(
            reinterpret_cast<const S*>(ring + offset(stage, j)), out[j]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) out[j][i] = 0.0f;
      }
    }
  }
};

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
  return group_sum(gatv2_part<VEC, NJ>(0.0f, hi, hj, a, slope), lph, mask);
}

// The score of a wide head: the receiver's and the sender's F columns (hi,
// hj: their first column) and att from column att_col0, slab by slab, the
// lane's share carried across the slabs, then one butterfly. Every wide
// kernel computes every score with this function (the receiver's columns
// first, as the narrow ones do).
template <typename S, int VEC, int NJ>
__device__ __forceinline__ float gatv2_score_wide(
    const S* __restrict__ hi, const S* __restrict__ hj, const void* att,
    int att_bf16, int64_t att_col0, int f, float slope, const Geometry& q) {
  float part = 0.0f;
  for (int c = 0; c < f; c += kSlab) {
    const int fk = f - c < kSlab ? f - c : kSlab;
    float x[NJ][VEC], y[NJ][VEC], a[NJ][VEC];
    load_lane<S, VEC, NJ>(hi + c, fk, q, x);
    load_lane<S, VEC, NJ>(hj + c, fk, q, y);
    load_att<VEC, NJ>(att, att_bf16, att_col0 + c, fk, q, a);
    part = gatv2_part<VEC, NJ>(part, x, y, a, slope);
  }
  return group_sum(part, q.lph, q.mask);
}

// Slabs of a head: 1 for a narrow launch.
template <bool WIDE>
__device__ __forceinline__ int head_slabs(int f) {
  if constexpr (WIDE) {
    return (f + kSlab - 1) / kSlab;
  } else {
    return 1;
  }
}

// What a group owns: a (row or slot, head, slab) triple, its first column in
// the [*, heads*f] arrays and its width. Groups enumerate the triples row by
// row, and within a row slab by slab, head by head, so that a fixed grid
// whose group count is a multiple of heads * slabs keeps each group on one
// (head, slab).
struct Item {
  int64_t row;
  int h, fk;
  int64_t col0;
};

template <bool WIDE>
__device__ __forceinline__ Item item_of(int64_t i, int heads, int f) {
  Item it;
  if constexpr (WIDE) {
    const int64_t per_row = static_cast<int64_t>(heads) * head_slabs<WIDE>(f);
    it.row = i / per_row;
    const int hk = static_cast<int>(i - it.row * per_row);
    const int k = hk / heads;
    it.h = hk - k * heads;
    const int rest = f - k * kSlab;
    it.fk = rest < kSlab ? rest : kSlab;
    it.col0 =
        static_cast<int64_t>(it.h) * f + static_cast<int64_t>(k) * kSlab;
  } else {
    it.row = i / heads;
    it.h = static_cast<int>(i - it.row * heads);
    it.fk = f;
    it.col0 = static_cast<int64_t>(it.h) * f;
  }
  return it;
}

// A wide group's (head, slab) in a fixed grid, from gid % (heads * slabs):
// its head, first column and width. A narrow group owns its head's columns.
template <bool WIDE>
__device__ __forceinline__ Item fixed_grid_item(int64_t gid, int heads,
                                                int f) {
  if constexpr (WIDE) {
    return item_of<true>(gid % (static_cast<int64_t>(heads) *
                                head_slabs<true>(f)),
                         heads, f);
  } else {
    Item it;
    it.row = 0;
    it.h = static_cast<int>(gid % heads);
    it.fk = f;
    it.col0 = static_cast<int64_t>(it.h) * f;
    return it;
  }
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

// A group's partial of datt (its columns) into its row of the partials: one
// row per `per_row` groups (heads, times slabs for a wide head) of a grid
// whose group count is a multiple of `per_row`, so that the group's (head,
// slab) is gid % per_row.
template <int VEC, int NJ>
__device__ __forceinline__ void store_partial(float* partial, int64_t per_row,
                                              int64_t d, int64_t col0, int f,
                                              const Geometry& q,
                                              const float (&acc)[NJ][VEC]) {
  float* row = partial + (q.gid / per_row) * d + col0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = pack_column<VEC>(q, j);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if (c < f) row[c + i] = acc[j][i];
    }
  }
}

// datt[c] = sum over the partial rows, in a fixed order, by one block of
// kThreads: threads stride over the rows, then a tree in shared memory.
__device__ __forceinline__ void reduce_partial_column(
    const float* __restrict__ partial, float* __restrict__ datt,
    int64_t p_rows, int64_t d, int64_t c) {
  __shared__ float buf[kThreads];
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

// One block per column.
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ partial,
                       float* __restrict__ datt, int64_t p_rows, int64_t d) {
  reduce_partial_column(partial, datt, p_rows, d, blockIdx.x);
}

// How a head's F columns are laid over lanes: packs of `vec` columns, `lph`
// lanes per head, `nj` packs per lane, `slabs` slabs of kSlab columns (1 for
// a narrow head).
struct Layout {
  int vec, lph, nj, slabs;
};

inline bool aligned_to(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

// Widest pack (in elements, at most 16 bytes) that divides F and keeps every
// row of every data array aligned; then the power of two of lanes that
// covers the head's packs, at most a warp; then the packs per lane, rounded
// up to a power of two. A head wider than kSlab takes a warp and
// kMaxPerLane columns a lane, slab by slab.
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
  lay.slabs = static_cast<int>((f + kSlab - 1) / kSlab);
  if (lay.slabs > 1) {
    lay.lph = 32;
    lay.nj = kMaxPerLane / lay.vec;
    return lay;
  }
  const int64_t packs = f / lay.vec;
  lay.lph = 1;
  while (lay.lph < packs && lay.lph < 32) lay.lph <<= 1;
  const int64_t need = (packs + lay.lph - 1) / lay.lph;
  lay.nj = 1;
  while (lay.nj < need) lay.nj <<= 1;
  return lay;
}

// `items` (row, head) or (slot, head) pairs, one group per slab each, fit
// the grid.
inline bool shape_ok(int64_t items, int heads, int64_t f) {
  const int64_t slabs = (f + kSlab - 1) / kSlab;
  return items > 0 && heads >= 1 && f >= 1 && f < (1 << 30) &&
         items * heads * slabs < (static_cast<int64_t>(1) << 31);  // grid.x
}

inline unsigned blocks_for_all(int64_t items, int heads, int lph) {
  const int64_t per_block = kThreads / lph;
  return static_cast<unsigned>((items * heads + per_block - 1) / per_block);
}

// The fixed grid of a kernel whose groups stride over the pairs with their
// head held constant: `per_sm` blocks a SM to fill the card, no more than
// the work needs, rounded up to a multiple of `heads`.
inline unsigned blocks_for_fixed_grid(int64_t items, int heads, int lph,
                                      int per_sm = kBlocksPerSm) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  int64_t blocks = static_cast<int64_t>(sms) * per_sm;
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

// Runs LAUNCH(S) with VEC, NJ and WIDE bound to the layout's compile-time
// values. Only layouts with VEC * NJ <= kMaxPerLane exist (pick_layout makes
// no other); a wide head has VEC * NJ == kMaxPerLane.
#define KGT_CASE(V, N, LAUNCH, S)                 \
  case (V) * 16 + (N): {                          \
    constexpr int VEC = (V);                      \
    constexpr int NJ = (N);                       \
    constexpr bool WIDE = false;                  \
    LAUNCH(S);                                    \
  } break;
#define KGT_WIDE_CASE(V, LAUNCH, S)               \
  case (V): {                                     \
    constexpr int VEC = (V);                      \
    constexpr int NJ = kMaxPerLane / (V);         \
    constexpr bool WIDE = true;                   \
    LAUNCH(S);                                    \
  } break;
#define KGT_CASES_UP_TO_4(LAUNCH, S)                                       \
  KGT_CASE(4, 1, LAUNCH, S) KGT_CASE(4, 2, LAUNCH, S)                      \
  KGT_CASE(2, 1, LAUNCH, S) KGT_CASE(2, 2, LAUNCH, S)                      \
  KGT_CASE(2, 4, LAUNCH, S) KGT_CASE(1, 1, LAUNCH, S)                      \
  KGT_CASE(1, 2, LAUNCH, S) KGT_CASE(1, 4, LAUNCH, S)                      \
  KGT_CASE(1, 8, LAUNCH, S)
#define KGT_DISPATCH(is_bf16, lay, LAUNCH)                                 \
  if ((lay).slabs > 1) {                                                   \
    if (is_bf16) {                                                         \
      switch ((lay).vec) {                                                 \
        KGT_WIDE_CASE(8, LAUNCH, uint16_t)                                 \
        KGT_WIDE_CASE(4, LAUNCH, uint16_t)                                 \
        KGT_WIDE_CASE(2, LAUNCH, uint16_t)                                 \
        KGT_WIDE_CASE(1, LAUNCH, uint16_t)                                 \
        default: return static_cast<int>(cudaErrorInvalidValue);           \
      }                                                                    \
    } else {                                                               \
      switch ((lay).vec) {                                                 \
        KGT_WIDE_CASE(4, LAUNCH, float)                                    \
        KGT_WIDE_CASE(2, LAUNCH, float)                                    \
        KGT_WIDE_CASE(1, LAUNCH, float)                                    \
        default: return static_cast<int>(cudaErrorInvalidValue);           \
      }                                                                    \
    }                                                                      \
  } else if (is_bf16) {                                                    \
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
