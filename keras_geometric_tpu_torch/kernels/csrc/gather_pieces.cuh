// The fused-gather piece walk and the helpers it is built from, shared by
// spmm.cu (K1's fused-gather form: the attention's finishes, the gather's
// VJP) and band.cu (K12, the window scatter): out[r, :] = sum over the slots
// e of row r of w[e] * src[idx[e], :], over a host-built work list that cuts
// every row into pieces of at most `cap` slots (spmm_cuda.recv_bwd_work).
//
// A sub-warp per (piece, column tile) copies the piece's indices (and
// weights) into shared memory in one go, then keeps the gathered packs of
// the next kRingDepth slots in flight in a ring in shared memory (cp.async,
// one commit group a slot) and sums them in f32 in slot order, each message
// with one fused multiply-add (fmaf). A piece that is its whole row stores
// the row, with the diagonal epilogue, rounded once; a piece of a split row
// stores its f32 share, and a second launch (merge_shares) adds each split
// row's shares in piece order, applies the epilogue and rounds once. A row
// that is one piece therefore gets a serial walk's bits. (A register window
// of eight packs loaded before its adds took 69-82 registers and ran 9-72%
// slower at the finish's and the GCN's shapes on the H100, PERF.md.)
//
// CHECKED walks (K12) also take a table `check` of the row each slot belongs
// to: a slot adds to row r only where check[idx[e]] == r, so a slot whose
// entry is -1 (or another row) contributes nothing. The lookups run while the
// ring's first copies are in flight.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRingDepth = 8;  // gathered rows in flight per lane

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

template <typename S, int VEC>
struct alignas(sizeof(S) * VEC) Pack {
  S v[VEC];
};

template <typename S, int VEC>
__device__ __forceinline__ Pack<S, VEC> load_pack(const S* p) {
  return *reinterpret_cast<const Pack<S, VEC>*>(p);
}

template <typename S, int VEC>
__device__ __forceinline__ void store_pack(S* p, const Pack<S, VEC>& v) {
  *reinterpret_cast<Pack<S, VEC>*>(p) = v;
}

// Per-edge (or per-node) scalar weight: 1 when absent, f32 or bf16 otherwise.
__device__ __forceinline__ float load_weight(const void* w, int w_bf16,
                                             int64_t i) {
  if (w == nullptr) return 1.0f;
  if (w_bf16) return bf16_bits_to_float(static_cast<const uint16_t*>(w)[i]);
  return static_cast<const float*>(w)[i];
}

// One message into a row's sums: w * message, or nothing on a masked slot.
// The messages form adds the rounded product; the fused-gather form adds with
// one fused multiply-add, the same operation in its row walk and its piece
// walk (an explicit fmaf, not left to the compiler's contraction).
template <typename S, int VEC, bool GATHER>
__device__ __forceinline__ void add_message(float (&acc)[VEC], float w, bool ok,
                                            const Pack<S, VEC>& p) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    if constexpr (GATHER) {
      if (ok) acc[j] = fmaf(w, Cvt<S>::to_f(p.v[j]), acc[j]);
    } else {
      const float v = w * Cvt<S>::to_f(p.v[j]);
      acc[j] += ok ? v : 0.0f;
    }
  }
}

// The epilogue: self_w[row] * src[row, col .. col + VEC] into the sums.
template <typename S, int VEC>
__device__ __forceinline__ void add_diagonal(float (&acc)[VEC],
                                             const void* __restrict__ self_w,
                                             int self_w_bf16,
                                             const S* __restrict__ src,
                                             int64_t row, int64_t f,
                                             int64_t col) {
  const float sw = load_weight(self_w, self_w_bf16, row);
  const Pack<S, VEC> p = load_pack<S, VEC>(src + row * f + col);
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = fmaf(sw, Cvt<S>::to_f(p.v[j]), acc[j]);
}

// Bytes of the ring: kRingDepth stages of one pack a thread, [stage][thread].
template <typename S, int VEC>
__host__ __device__ constexpr int ring_bytes() {
  return kRingDepth * kThreads * VEC * static_cast<int>(sizeof(S));
}

// Dynamic shared memory of a piece walk: the ring, then per sub-warp `cap`
// indices and, where there are weights or a check table, `cap` more words.
template <typename S, int VEC>
inline size_t pieces_smem(int lpr, int cap, bool second) {
  return ring_bytes<S, VEC>() +
         static_cast<size_t>(kThreads / lpr) * cap * (second ? 8 : 4);
}

// Lanes of this thread's sub-warp of lpr lanes (a power of two, at most 32).
__device__ __forceinline__ unsigned sub_mask(int lpr) {
  if (lpr >= 32) return 0xffffffffu;
  const int first = ((threadIdx.x & 31) / lpr) * lpr;
  return ((1u << lpr) - 1u) << first;
}

// pieces[p] = (row, first slot, end slot, share): at most `cap` slots of one
// row; share is -1 where the piece is its whole row, else its row in the f32
// scratch `part` [*, f]. A sub-warp per (piece, column tile of lpr * VEC
// columns). Shared memory as pieces_smem lays it out.
template <typename S, int VEC, bool CHECKED>
__device__ __forceinline__ void gather_pieces_walk(
    const S* __restrict__ src, const int32_t* __restrict__ idx,
    const int4* __restrict__ pieces, int64_t n_pieces, int cap,
    const void* __restrict__ w, int w_bf16,
    const int32_t* __restrict__ check, const void* __restrict__ self_w,
    int self_w_bf16, S* __restrict__ out, float* __restrict__ part,
    int64_t f, int lpr) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int sub = threadIdx.x / lpr;
  const int lane = threadIdx.x - sub * lpr;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * (kThreads / lpr) + sub;
  if (p >= n_pieces) return;  // the whole sub-warp
  const int64_t col =
      (static_cast<int64_t>(blockIdx.y) * lpr + lane) * VEC;
  const int4 pc = pieces[p];
  const int64_t lo = pc.y;
  const int n = pc.z - pc.y;

  // The piece's indices and weights, the sub-warp's lanes together (lanes
  // past the row's width help too, then leave).
  const bool second = CHECKED || w != nullptr;
  int32_t* t_idx = reinterpret_cast<int32_t*>(smem + ring_bytes<S, VEC>()) +
                   static_cast<int64_t>(sub) * cap * (second ? 2 : 1);
  float* t_w = reinterpret_cast<float*>(t_idx + cap);
  int32_t* t_hit = t_idx + cap;  // CHECKED: 1 where the slot is the row's
  for (int i = lane; i < n; i += lpr) {
    t_idx[i] = idx[lo + i];
    if (!CHECKED && w != nullptr) t_w[i] = load_weight(w, w_bf16, lo + i);
  }
  __syncwarp(sub_mask(lpr));

  // Slot j's pack lands in stage j % kRingDepth, one commit group a slot
  // (empty past the piece's end), so that waiting for all but the
  // kRingDepth - 1 latest groups means slot j has landed; its stage is
  // refilled with slot j + kRingDepth after use. Each lane copies and reads
  // only its own packs.
  constexpr int kPack = VEC * static_cast<int>(sizeof(S));
  const bool active = col < f;
  const uint32_t ring = shared_u32(smem);
  const int mine = static_cast<int>(threadIdx.x) * kPack;
  if (active) {
#pragma unroll
    for (int k = 0; k < kRingDepth; ++k) {
      if (k < n) {
        copy_async<kPack>(ring + k * kThreads * kPack + mine,
                          src + static_cast<int64_t>(t_idx[k]) * f + col);
      }
      copy_commit();
    }
  }
  if constexpr (CHECKED) {
    for (int i = lane; i < n; i += lpr) t_hit[i] = check[t_idx[i]] == pc.x;
    __syncwarp(sub_mask(lpr));
  }
  if (!active) return;

  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
  int stage = 0;
  for (int j = 0; j < n; ++j) {
    copy_wait<kRingDepth - 1>();
    const int at = stage * kThreads * kPack + mine;
    const Pack<S, VEC> pk = *reinterpret_cast<const Pack<S, VEC>*>(smem + at);
    const float wj = (!CHECKED && w != nullptr) ? t_w[j] : 1.0f;
    add_message<S, VEC, true>(acc, wj, !CHECKED || t_hit[j] != 0, pk);
    if (j + kRingDepth < n) {
      copy_async<kPack>(
          ring + at,
          src + static_cast<int64_t>(t_idx[j + kRingDepth]) * f + col);
    }
    copy_commit();
    stage = stage + 1 == kRingDepth ? 0 : stage + 1;
  }

  if (pc.w < 0) {  // the whole row
    const int64_t row = pc.x;
    if (self_w != nullptr) {
      add_diagonal<S, VEC>(acc, self_w, self_w_bf16, src, row, f, col);
    }
    Pack<S, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) o.v[j] = Cvt<S>::from_f(acc[j]);
    store_pack<S, VEC>(out + row * f + col, o);
  } else {  // a share of a split row
    float* share = part + static_cast<int64_t>(pc.w) * f + col;
#pragma unroll
    for (int j = 0; j < VEC; ++j) share[j] = acc[j];
  }
}

// The second launch, one thread per (split row, column): the row's shares
// (rows fix_ptr[k] .. fix_ptr[k + 1] of part) added in piece order, the
// epilogue, one rounding. A hub row has hundreds of shares: the unrolled loop
// issues several loads before their adds, which stay in order.
template <typename S>
__device__ __forceinline__ void merge_shares(
    const float* __restrict__ part, const int32_t* __restrict__ fix_rows,
    const int32_t* __restrict__ fix_ptr, int64_t n_fix,
    const S* __restrict__ src, const void* __restrict__ self_w,
    int self_w_bf16, S* __restrict__ out, int64_t f) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_fix * f) return;
  const int64_t k = i / f;
  const int64_t c = i - k * f;
  float acc = 0.0f;
#pragma unroll 8
  for (int32_t p = fix_ptr[k]; p < fix_ptr[k + 1]; ++p) {
    acc += part[static_cast<int64_t>(p) * f + c];
  }
  const int64_t row = fix_rows[k];
  if (self_w != nullptr) {
    acc = fmaf(load_weight(self_w, self_w_bf16, row),
               Cvt<S>::to_f(src[row * f + c]), acc);
  }
  out[row * f + c] = Cvt<S>::from_f(acc);
}

// Widest vector (in elements) that divides the row width and keeps every row
// of every array aligned to the vector's size.
inline int pick_vec(int64_t f, int elem_size, const void* a, const void* b) {
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  int vec = 16 / elem_size;
  while (vec > 1 &&
         (f % vec != 0 || bits % static_cast<uintptr_t>(vec * elem_size) != 0)) {
    vec /= 2;
  }
  return vec;
}

// Lanes per row: the power of two that covers the row's chunks, at most a
// warp; wider rows are split into column tiles along grid.y.
inline void pick_geometry(int64_t f, int vec, int64_t n_items, int* lpr,
                          dim3* grid) {
  const int64_t chunks = (f + vec - 1) / vec;
  int l = 1;
  while (l < chunks && l < 32) l <<= 1;
  const int per_block = kThreads / l;
  *lpr = l;
  *grid = dim3(static_cast<unsigned>((n_items + per_block - 1) / per_block),
               static_cast<unsigned>((chunks + l - 1) / l), 1);
}

// A piece walk's work list, as the C entry points check it: pieces
// [n_pieces, 4] int32, 16-byte aligned, at least one per row, each of at most
// cap slots; the split rows' tables and scratch where n_fix > 0; grids that
// fit.
inline bool piece_list_ok(const int32_t* pieces, int64_t n_pieces,
                          int64_t n_rows, int cap, int64_t n_fix,
                          const float* part, const int32_t* fix_rows,
                          const int32_t* fix_ptr, int64_t f) {
  return pieces != nullptr && n_rows > 0 && f > 0 && n_pieces >= n_rows &&
         cap >= 1 && cap <= 1024 &&
         reinterpret_cast<uintptr_t>(pieces) % 16 == 0 && n_fix >= 0 &&
         (n_fix == 0 || (part != nullptr && fix_rows != nullptr &&
                         fix_ptr != nullptr)) &&
         (n_fix * f + kThreads - 1) / kThreads <
             (static_cast<int64_t>(1) << 31) &&
         n_pieces < (static_cast<int64_t>(1) << 31) * (kThreads / 32);
}

}  // namespace

// Runs LAUNCH(S, V) with the storage type and the vector width of `vec`
// (pick_vec) as compile-time values.
#define KGT_VEC_DISPATCH(is_bf16, vec, LAUNCH) \
  if (is_bf16) {                               \
    switch (vec) {                             \
      case 8: LAUNCH(uint16_t, 8); break;      \
      case 4: LAUNCH(uint16_t, 4); break;      \
      case 2: LAUNCH(uint16_t, 2); break;      \
      default: LAUNCH(uint16_t, 1); break;     \
    }                                          \
  } else {                                     \
    switch (vec) {                             \
      case 4: LAUNCH(float, 4); break;         \
      case 2: LAUNCH(float, 2); break;         \
      default: LAUNCH(float, 1); break;        \
    }                                          \
  }
