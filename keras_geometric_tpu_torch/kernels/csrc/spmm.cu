// Sorted-CSR SpMM kernels for Hopper (sm_90a): scatter-sum and its transpose.
//
// scatter_sum_sorted_kernel replaces the TPU scatter of
// the JAX package's kernels/spmm_pallas.py (_scatter_impl and
// _scatter_block_impl behind scatter_sum_sorted):
//     out[r, :] = sum_{e in row_ptr[r] .. row_ptr[r+1]} w[e] * message(e)
// The TPU has no vector gather, so its kernel multiplies a one-hot indicator
// into the messages on the matrix unit (2*E*ROW_BLOCK*F operations). This card
// gathers, so the work is one multiply-add per (edge, feature) and the kernel
// is bound by bytes: every message row is read once, every output row written
// once, plus the index and weight streams. Design: row-parallel CSR. A
// sub-warp of `lpr` lanes owns one receiver row, walks its edge range and
// keeps the row's partial sums in f32 registers; lanes lie across the feature
// axis and each loads VEC contiguous values (16 bytes where the width and the
// alignment allow, a scalar otherwise, so any F >= 1 works). Four edges are in
// flight per lane to cover the latency of the random row reads. No atomics:
// the order of the sum is the edge order, so results are deterministic.
// Empty rows store zeros. The weight is multiplied in f32 and the sum is
// rounded once, at the store.
//
// Where message(e) lives is a template flag:
//   GATHER = false: src[e, :]       (an [E, F] message array);
//   GATHER = true : src[idx[e], :]  (rows of a node array, gathered in the
//                   kernel, so the [E, F] array the TPU path materialises
//                   before its scatter never exists here). The source of the
//                   arxiv-shaped layer (43 MB in bf16) fits the 50 MB L2, so
//                   most of the random reads are served from there.
// An optional epilogue adds self_w[r] * src[r, :] (the densified diagonal of
// the GCN operator) before the store.
//
// expand_sorted_kernel replaces _expand_impl (expand_sorted) of the same
// file: out[e, :] = rows[recv[e], :] * w[e], the scatter's transpose and its
// VJP. The TPU kernel again multiplies by a one-hot matrix; here each
// (edge, VEC-wide column chunk) is one thread that loads, scales and stores.
// Bound by bytes: E*F values written, the node rows read (sorted receivers
// make neighbouring edges re-read the same row from cache).
//
// All offsets into data are 64-bit. Indices and row_ptr are int32.
// The C entry points launch on the given stream, allocate nothing, do not
// synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

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

template <typename S, int VEC, bool GATHER>
__global__ void __launch_bounds__(kThreads)
scatter_sum_sorted_kernel(const S* __restrict__ src,
                          const int32_t* __restrict__ idx,
                          const int32_t* __restrict__ row_ptr,
                          const void* __restrict__ w, int w_bf16,
                          const uint8_t* __restrict__ mask,
                          const void* __restrict__ self_w, int self_w_bf16,
                          S* __restrict__ out, int64_t n_rows, int64_t f,
                          int lpr) {
  const int sub = threadIdx.x / lpr;
  const int lane = threadIdx.x - sub * lpr;
  const int rows_per_block = kThreads / lpr;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * rows_per_block + sub;
  const int64_t col =
      (static_cast<int64_t>(blockIdx.y) * lpr + lane) * VEC;
  if (row >= n_rows || col >= f) return;

  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;

  const int64_t lo = row_ptr[row];
  const int64_t hi = row_ptr[row + 1];
  int64_t e = lo;
  for (; e + kUnroll <= hi; e += kUnroll) {
    int64_t r[kUnroll];
    float ww[kUnroll];
    bool ok[kUnroll];
    Pack<S, VEC> p[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      r[k] = GATHER ? static_cast<int64_t>(idx[e + k]) : (e + k);
      ww[k] = load_weight(w, w_bf16, e + k);
      ok[k] = (mask == nullptr) || (mask[e + k] != 0);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      p[k] = load_pack<S, VEC>(src + r[k] * f + col);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float v = ww[k] * Cvt<S>::to_f(p[k].v[j]);
        acc[j] += ok[k] ? v : 0.0f;
      }
    }
  }
  for (; e < hi; ++e) {
    const int64_t r = GATHER ? static_cast<int64_t>(idx[e]) : e;
    const float ww = load_weight(w, w_bf16, e);
    const bool ok = (mask == nullptr) || (mask[e] != 0);
    const Pack<S, VEC> p = load_pack<S, VEC>(src + r * f + col);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float v = ww * Cvt<S>::to_f(p.v[j]);
      acc[j] += ok ? v : 0.0f;
    }
  }

  if (self_w != nullptr) {
    const float sw = load_weight(self_w, self_w_bf16, row);
    const Pack<S, VEC> p = load_pack<S, VEC>(src + row * f + col);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] += sw * Cvt<S>::to_f(p.v[j]);
  }

  Pack<S, VEC> o;
#pragma unroll
  for (int j = 0; j < VEC; ++j) o.v[j] = Cvt<S>::from_f(acc[j]);
  store_pack<S, VEC>(out + row * f + col, o);
}

template <typename S, int VEC>
__global__ void __launch_bounds__(kThreads)
expand_sorted_kernel(const S* __restrict__ rows,
                     const int32_t* __restrict__ recv,
                     const void* __restrict__ w, int w_bf16,
                     const uint8_t* __restrict__ mask, S* __restrict__ out,
                     int64_t n_edges, int64_t f, int lpr) {
  const int sub = threadIdx.x / lpr;
  const int lane = threadIdx.x - sub * lpr;
  const int edges_per_block = kThreads / lpr;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * edges_per_block + sub;
  const int64_t col =
      (static_cast<int64_t>(blockIdx.y) * lpr + lane) * VEC;
  if (e >= n_edges || col >= f) return;

  const bool ok = (mask == nullptr) || (mask[e] != 0);
  const float ww = load_weight(w, w_bf16, e);
  const int64_t r = recv[e];
  const Pack<S, VEC> p = load_pack<S, VEC>(rows + r * f + col);
  Pack<S, VEC> o;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float v = ww * Cvt<S>::to_f(p.v[j]);
    o.v[j] = Cvt<S>::from_f(ok ? v : 0.0f);
  }
  store_pack<S, VEC>(out + e * f + col, o);
}

// Widest vector (in elements) that divides the row width and keeps every row
// of every array aligned to the vector's size.
int pick_vec(int64_t f, int elem_size, const void* a, const void* b) {
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
void pick_geometry(int64_t f, int vec, int64_t n_items, int* lpr, dim3* grid) {
  const int64_t chunks = (f + vec - 1) / vec;
  int l = 1;
  while (l < chunks && l < 32) l <<= 1;
  const int per_block = kThreads / l;
  *lpr = l;
  *grid = dim3(static_cast<unsigned>((n_items + per_block - 1) / per_block),
               static_cast<unsigned>((chunks + l - 1) / l), 1);
}

template <typename S, int VEC>
void launch_scatter(const void* src, const int32_t* idx,
                    const int32_t* row_ptr, const void* w, int w_bf16,
                    const uint8_t* mask, const void* self_w, int self_w_bf16,
                    void* out, int64_t n_rows, int64_t f,
                    cudaStream_t stream) {
  int lpr;
  dim3 grid;
  pick_geometry(f, VEC, n_rows, &lpr, &grid);
  if (idx != nullptr) {
    scatter_sum_sorted_kernel<S, VEC, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const S*>(src), idx, row_ptr, w, w_bf16, mask, self_w,
        self_w_bf16, static_cast<S*>(out), n_rows, f, lpr);
  } else {
    scatter_sum_sorted_kernel<S, VEC, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const S*>(src), idx, row_ptr, w, w_bf16, mask, self_w,
        self_w_bf16, static_cast<S*>(out), n_rows, f, lpr);
  }
}

template <typename S, int VEC>
void launch_expand(const void* rows, const int32_t* recv, const void* w,
                   int w_bf16, const uint8_t* mask, void* out,
                   int64_t n_edges, int64_t f, cudaStream_t stream) {
  int lpr;
  dim3 grid;
  pick_geometry(f, VEC, n_edges, &lpr, &grid);
  expand_sorted_kernel<S, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const S*>(rows), recv, w, w_bf16, mask,
      static_cast<S*>(out), n_edges, f, lpr);
}

}  // namespace

extern "C" {

// out[r, :] = sum over e in [row_ptr[r], row_ptr[r+1]) of
//             w[e] * (idx ? src[idx[e], :] : src[e, :])   (+ self_w[r]*src[r, :])
// src/out: f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), row-major, width f.
// idx: null for the messages form. w, mask, self_w: null when absent.
int kgt_scatter_sum_sorted(const void* src, const int32_t* idx,
                           const int32_t* row_ptr, const void* w, int w_bf16,
                           const uint8_t* mask, const void* self_w,
                           int self_w_bf16, void* out, int64_t n_rows,
                           int64_t f, int is_bf16, void* stream) {
  if (src == nullptr || row_ptr == nullptr || out == nullptr || n_rows <= 0 ||
      f <= 0 || (self_w != nullptr && idx == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = pick_vec(f, is_bf16 ? 2 : 4, src, out);
#define KGT_SCATTER(S, V)                                                  \
  launch_scatter<S, V>(src, idx, row_ptr, w, w_bf16, mask, self_w,         \
                       self_w_bf16, out, n_rows, f, s)
  if (is_bf16) {
    switch (vec) {
      case 8: KGT_SCATTER(uint16_t, 8); break;
      case 4: KGT_SCATTER(uint16_t, 4); break;
      case 2: KGT_SCATTER(uint16_t, 2); break;
      default: KGT_SCATTER(uint16_t, 1); break;
    }
  } else {
    switch (vec) {
      case 4: KGT_SCATTER(float, 4); break;
      case 2: KGT_SCATTER(float, 2); break;
      default: KGT_SCATTER(float, 1); break;
    }
  }
#undef KGT_SCATTER
  return static_cast<int>(cudaGetLastError());
}

// out[e, :] = rows[recv[e], :] * w[e]   (0 where mask[e] is false)
int kgt_expand_sorted(const void* rows, const int32_t* recv, const void* w,
                      int w_bf16, const uint8_t* mask, void* out,
                      int64_t n_edges, int64_t f, int is_bf16, void* stream) {
  if (rows == nullptr || recv == nullptr || out == nullptr || n_edges <= 0 ||
      f <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = pick_vec(f, is_bf16 ? 2 : 4, rows, out);
#define KGT_EXPAND(S, V) \
  launch_expand<S, V>(rows, recv, w, w_bf16, mask, out, n_edges, f, s)
  if (is_bf16) {
    switch (vec) {
      case 8: KGT_EXPAND(uint16_t, 8); break;
      case 4: KGT_EXPAND(uint16_t, 4); break;
      case 2: KGT_EXPAND(uint16_t, 2); break;
      default: KGT_EXPAND(uint16_t, 1); break;
    }
  } else {
    switch (vec) {
      case 4: KGT_EXPAND(float, 4); break;
      case 2: KGT_EXPAND(float, 2); break;
      default: KGT_EXPAND(float, 1); break;
    }
  }
#undef KGT_EXPAND
  return static_cast<int>(cudaGetLastError());
}

const char* kgt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
