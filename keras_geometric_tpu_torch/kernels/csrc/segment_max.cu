// Segment max kernels for Hopper (sm_90a) over receiver-sorted streams: the
// narrow per-row max of attention-width scores, and the wide per-row max of
// message rows with its backward.
//
// They replace two TPU kernels of the JAX package's kernels/spmm_pallas.py:
//   segment_max_sorted_kernel   <- segment_max_sorted (_segment_max_kernel)
//   segment_max_wide_kernel     <- segment_max_wide_raw
//                                  (_segment_max_wide_kernel), the forward of
//                                  segment_max_wide_sorted
//   segment_max_wide_bwd_kernel <- segment_max_wide_sorted's custom VJP
//                                  (_segment_max_wide_bwd: two sorted expands
//                                  and an elementwise select)
//
// With row r owning the slots row_ptr[r] .. row_ptr[r+1] and mask[e] == 0
// marking a slot that takes no part:
//   narrow: out[r, k] = max over the row's unmasked slots of scores[e, k]
//           ([E, K] -> [N, K] in the scores' type; -inf for a row with no
//           unmasked slot; no backward).
//   wide  : out[r, c] = max(-1e30, max over the row's unmasked slots of
//           msgs[e, c]) ([E, F] f32 or bf16 -> [N, F] f32): an empty row
//           holds the -1e30 sentinel, mapped to 0 when empty_to_zero is set.
//   wide backward, from the forward's out and its cotangent g [N, F] f32:
//           dmsg[e, c] = (unmasked and msgs[e, c] == out[r, c]) ? g[r, c] / t
//           in the messages' type, where t = 1 (TIES_SPLIT false: every tied
//           element gets the whole cotangent, the JAX package's kernel rule)
//           or t = the number of unmasked elements of row r, column c equal
//           to out[r, c] (TIES_SPLIT true: the cotangent split evenly among
//           the tied elements, as XLA's and PyTorch's segment max do).
//
// The TPU kernels run a masked max over each (row block, edge chunk) work
// item (narrow) or a segmented Hillis-Steele max-scan along the chunk and a
// one-hot matrix product that picks each row's last scanned value (wide),
// because that machine has no vector gather and no per-row loop; the wide
// backward expands the row max and the cotangent to every slot. Here every
// kernel is row-parallel CSR and walks a row's slots: a max is order-free,
// so the forward is exact whatever the order, and nothing is expanded.
//
// Narrow design: a group of kNarrowLanes lanes per row; lane t takes the
// row's slots t, t + kNarrowLanes, ..., each lane keeps up to kNarrowCols
// running maxes in registers (columns beyond that in further passes, so any
// K works), then a butterfly max over the group and one store per column.
// Bound by bytes: the [E, K] scores read once, [N, K] written, the mask and
// row pointers.
//
// Wide design: a sub-warp of `lpr` lanes per row lies across the feature
// axis, each lane with VEC neighbouring columns moved in one load of up to
// 16 bytes (any F >= 1: narrower packs where F or the alignment demand),
// four slots in flight per lane, f32 maxes in registers, one f32 store. The
// backward walks the row once to count the ties (TIES_SPLIT) and once more
// to write every slot: no atomics, deterministic. Bound by bytes: the
// forward reads the [E, F] messages once and writes [N, F] f32; the
// backward reads the messages (twice with TIES_SPLIT: the second time from
// L1/L2 for rows that fit) and [N, F] f32 twice, and writes [E, F].
//
// Every slot must lie in a row: row_ptr[0] == 0 and row_ptr[N] == E (the
// backward writes exactly the slots of the rows). Offsets into data are
// 64-bit; row pointers are int32. The C entry points launch on the given
// stream, allocate nothing, do not synchronise, and return
// cudaGetLastError().

#include "lanes.cuh"

namespace {

constexpr int kUnroll = 4;
constexpr float kSentinel = -1e30f;  // the JAX package's _NEG_SENTINEL
constexpr int kNarrowLanes = 8;      // lanes per row of the narrow kernel
constexpr int kNarrowCols = 8;       // columns a lane holds per pass

__device__ __forceinline__ bool slot_on(const uint8_t* __restrict__ mask,
                                        int64_t e) {
  return mask == nullptr || mask[e] != 0;
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
segment_max_sorted_kernel(const S* __restrict__ scores,
                          const int32_t* __restrict__ row_ptr,
                          const uint8_t* __restrict__ mask,
                          S* __restrict__ out, int64_t n_rows, int k) {
  const int sub = threadIdx.x / kNarrowLanes;
  const int lane = threadIdx.x - sub * kNarrowLanes;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (kThreads / kNarrowLanes) + sub;
  if (row >= n_rows) return;  // the whole group leaves together
  const unsigned gmask = group_mask(kNarrowLanes);
  const int64_t lo = row_ptr[row];
  const int64_t hi = row_ptr[row + 1];

  for (int c0 = 0; c0 < k; c0 += kNarrowCols) {
    float m[kNarrowCols];
#pragma unroll
    for (int j = 0; j < kNarrowCols; ++j) m[j] = -INFINITY;
    for (int64_t e = lo + lane; e < hi; e += kNarrowLanes) {
      if (!slot_on(mask, e)) continue;
      const S* p = scores + e * k + c0;
#pragma unroll
      for (int j = 0; j < kNarrowCols; ++j) {
        if (c0 + j < k) m[j] = fmaxf(m[j], Cvt<S>::to_f(p[j]));
      }
    }
#pragma unroll
    for (int j = 0; j < kNarrowCols; ++j) {
      for (int off = kNarrowLanes / 2; off > 0; off >>= 1) {
        m[j] = fmaxf(m[j], __shfl_xor_sync(gmask, m[j], off));
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kNarrowCols; ++j) {
        if (c0 + j < k) out[row * k + c0 + j] = Cvt<S>::from_f(m[j]);
      }
    }
  }
}

// Row and first column of this lane's pack; false when it has none.
__device__ __forceinline__ bool wide_cell(int64_t n_rows, int64_t f, int lpr,
                                          int vec, int64_t* row,
                                          int64_t* col) {
  const int sub = threadIdx.x / lpr;
  const int lane = threadIdx.x - sub * lpr;
  *row = static_cast<int64_t>(blockIdx.x) * (kThreads / lpr) + sub;
  *col = (static_cast<int64_t>(blockIdx.y) * lpr + lane) * vec;
  return *row < n_rows && *col < f;
}

template <typename S, int VEC>
__global__ void __launch_bounds__(kThreads)
segment_max_wide_kernel(const S* __restrict__ msgs,
                        const int32_t* __restrict__ row_ptr,
                        const uint8_t* __restrict__ mask,
                        float* __restrict__ out, int64_t n_rows, int64_t f,
                        int lpr, int empty_to_zero) {
  int64_t row, col;
  if (!wide_cell(n_rows, f, lpr, VEC, &row, &col)) return;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = kSentinel;

  const int64_t hi = row_ptr[row + 1];
  int64_t e = row_ptr[row];
  for (; e + kUnroll <= hi; e += kUnroll) {
    bool ok[kUnroll];
    float v[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) ok[u] = slot_on(mask, e + u);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load_pack<S, VEC>(msgs + (e + u) * f + col, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if (ok[u]) acc[i] = fmaxf(acc[i], v[u][i]);
      }
    }
  }
  for (; e < hi; ++e) {
    if (!slot_on(mask, e)) continue;
    float v[VEC];
    load_pack<S, VEC>(msgs + e * f + col, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = fmaxf(acc[i], v[i]);
  }
  if (empty_to_zero) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if (acc[i] <= kSentinel / 2) acc[i] = 0.0f;
    }
  }
  store_pack<float, VEC>(out + row * f + col, acc);
}

template <typename S, int VEC, bool TIES_SPLIT>
__global__ void __launch_bounds__(kThreads)
segment_max_wide_bwd_kernel(const S* __restrict__ msgs,
                            const float* __restrict__ maxv,
                            const float* __restrict__ g,
                            const int32_t* __restrict__ row_ptr,
                            const uint8_t* __restrict__ mask,
                            S* __restrict__ dmsg, int64_t n_rows, int64_t f,
                            int lpr) {
  int64_t row, col;
  if (!wide_cell(n_rows, f, lpr, VEC, &row, &col)) return;
  float m[VEC], gv[VEC];
  load_pack<float, VEC>(maxv + row * f + col, m);
  load_pack<float, VEC>(g + row * f + col, gv);
  const int64_t lo = row_ptr[row];
  const int64_t hi = row_ptr[row + 1];

  if constexpr (TIES_SPLIT) {
    float ties[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) ties[i] = 0.0f;
    for (int64_t e = lo; e < hi; ++e) {
      if (!slot_on(mask, e)) continue;
      float v[VEC];
      load_pack<S, VEC>(msgs + e * f + col, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) ties[i] += v[i] == m[i] ? 1.0f : 0.0f;
    }
    // A column without a tie routes nothing, whatever gv becomes.
#pragma unroll
    for (int i = 0; i < VEC; ++i) gv[i] = gv[i] / ties[i];
  }

  for (int64_t e = lo; e < hi; ++e) {
    const bool ok = slot_on(mask, e);
    float v[VEC];
    load_pack<S, VEC>(msgs + e * f + col, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = (ok && v[i] == m[i]) ? gv[i] : 0.0f;
    store_pack<S, VEC>(dmsg + e * f + col, v);
  }
}

// Widest pack (in elements, at most 16 bytes of the messages) that divides
// F and keeps every row of the messages and of the f32 arrays aligned to it.
int pick_wide_vec(int64_t f, int elem_size, const void* msgs,
                  const void* rows) {
  int vec = 16 / elem_size;
  while (vec > 1 &&
         (f % vec != 0 || !aligned_to(msgs, vec * elem_size) ||
          !aligned_to(rows, vec * 4))) {
    vec /= 2;
  }
  return vec;
}

// Lanes per row: the power of two that covers the row's packs, at most a
// warp; wider rows are split into column tiles along grid.y.
void wide_geometry(int64_t f, int vec, int64_t n_rows, int* lpr,
                   dim3* grid) {
  const int64_t packs = (f + vec - 1) / vec;
  int l = 1;
  while (l < packs && l < 32) l <<= 1;
  const int per_block = kThreads / l;
  *lpr = l;
  *grid = dim3(static_cast<unsigned>((n_rows + per_block - 1) / per_block),
               static_cast<unsigned>((packs + l - 1) / l), 1);
}

}  // namespace

// Runs LAUNCH(S, V) with the pack width bound at compile time.
#define KGT_WIDE_DISPATCH(is_bf16, vec, LAUNCH)            \
  if (is_bf16) {                                           \
    switch (vec) {                                         \
      case 8: LAUNCH(uint16_t, 8); break;                  \
      case 4: LAUNCH(uint16_t, 4); break;                  \
      case 2: LAUNCH(uint16_t, 2); break;                  \
      default: LAUNCH(uint16_t, 1); break;                 \
    }                                                      \
  } else {                                                 \
    switch (vec) {                                         \
      case 4: LAUNCH(float, 4); break;                     \
      case 2: LAUNCH(float, 2); break;                     \
      default: LAUNCH(float, 1); break;                    \
    }                                                      \
  }

extern "C" {

// out[r, k] = max over the unmasked slots of row r of scores[e, k]; -inf
// for a row without one. scores/out: f32 (is_bf16 = 0) or bf16, [*, k]
// row-major. mask: [n_slots] bytes, null when every slot counts.
int kgt_segment_max_sorted(const void* scores, const int32_t* row_ptr,
                           const uint8_t* mask, void* out, int64_t n_rows,
                           int k, int is_bf16, void* stream) {
  if (scores == nullptr || row_ptr == nullptr || out == nullptr ||
      n_rows <= 0 || k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_block = kThreads / kNarrowLanes;
  const unsigned grid =
      static_cast<unsigned>((n_rows + per_block - 1) / per_block);
  if (is_bf16) {
    segment_max_sorted_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(scores), row_ptr, mask,
        static_cast<uint16_t*>(out), n_rows, k);
  } else {
    segment_max_sorted_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(scores), row_ptr, mask,
        static_cast<float*>(out), n_rows, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// out [n_rows, f] f32: the per-row max of the unmasked message rows, the
// -1e30 sentinel for a row without one (0 when empty_to_zero != 0). msgs
// [n_slots, f] f32 (is_bf16 = 0) or bf16; mask as above.
int kgt_segment_max_wide_sorted(const void* msgs, const int32_t* row_ptr,
                                const uint8_t* mask, float* out,
                                int64_t n_rows, int64_t f, int empty_to_zero,
                                int is_bf16, void* stream) {
  if (msgs == nullptr || row_ptr == nullptr || out == nullptr ||
      n_rows <= 0 || f <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = pick_wide_vec(f, is_bf16 ? 2 : 4, msgs, out);
  int lpr;
  dim3 grid;
  wide_geometry(f, vec, n_rows, &lpr, &grid);
#define KGT_FWD(S, V)                                                     \
  segment_max_wide_kernel<S, V><<<grid, kThreads, 0, s>>>(                \
      static_cast<const S*>(msgs), row_ptr, mask, out, n_rows, f, lpr,    \
      empty_to_zero)
  KGT_WIDE_DISPATCH(is_bf16, vec, KGT_FWD)
#undef KGT_FWD
  return static_cast<int>(cudaGetLastError());
}

// dmsg [n_slots, f] in the messages' type: g [n_rows, f] f32 routed to the
// unmasked elements equal to their row's max maxv [n_rows, f] f32, whole
// (ties_split = 0) or divided by the row's count of such elements in that
// column (ties_split = 1).
int kgt_segment_max_wide_bwd(const void* msgs, const float* maxv,
                             const float* g, const int32_t* row_ptr,
                             const uint8_t* mask, void* dmsg, int64_t n_rows,
                             int64_t f, int ties_split, int is_bf16,
                             void* stream) {
  if (msgs == nullptr || maxv == nullptr || g == nullptr ||
      row_ptr == nullptr || dmsg == nullptr || n_rows <= 0 || f <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int es = is_bf16 ? 2 : 4;
  int vec = pick_wide_vec(f, es, msgs, maxv);
  while (vec > 1 && (!aligned_to(g, vec * 4) || !aligned_to(dmsg, vec * es))) {
    vec /= 2;
  }
  int lpr;
  dim3 grid;
  wide_geometry(f, vec, n_rows, &lpr, &grid);
#define KGT_BWD(S, V)                                                      \
  if (ties_split) {                                                        \
    segment_max_wide_bwd_kernel<S, V, true><<<grid, kThreads, 0, s>>>(     \
        static_cast<const S*>(msgs), maxv, g, row_ptr, mask,               \
        static_cast<S*>(dmsg), n_rows, f, lpr);                            \
  } else {                                                                 \
    segment_max_wide_bwd_kernel<S, V, false><<<grid, kThreads, 0, s>>>(    \
        static_cast<const S*>(msgs), maxv, g, row_ptr, mask,               \
        static_cast<S*>(dmsg), n_rows, f, lpr);                            \
  }
  KGT_WIDE_DISPATCH(is_bf16, vec, KGT_BWD)
#undef KGT_BWD
  return static_cast<int>(cudaGetLastError());
}

const char* kgt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
