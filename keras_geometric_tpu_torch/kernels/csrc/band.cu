// Locality-tier kernels for Hopper (sm_90a): the banded SpMM and the window
// scatter of the banded attention backward.
//
// band_bf16_kernel / band_f32_kernel replace the TPU kernel of the JAX
// package's kernels/band_pallas.py, _band_kernel behind _band_matmul
// (band_spmm):
//     y[b*RB : (b+1)*RB, :] = band[b*RB : (b+1)*RB, 0:W] @ x[base(b) : base(b)+W, :]
// with base(b) = base_idx[b] * W/2 (the host clamps it so that the window
// lies inside [0, n_pad)). The band is dense: after a locality reordering it
// holds the edges whose sender lies in the receiver block's window. The work
// is a product of dense tiles, bound by bytes on this card: the [n_pad, W]
// band is read once (2W bytes per node row in bf16 against 2F for each of x
// and y), and at F <= 128 the operations are far below the tensor cores'
// rate.
// Design: a block owns a 64-row tile of one row block (row_block is a
// multiple of 64) and up to 128 columns of F; it walks the window in slabs of
// 32, stages band[rows, slab] and x[base + slab, cols] in shared memory and
//   - bf16: multiplies 16x16x16 fragments on the tensor cores (nvcuda::wmma,
//     f32 accumulators), each of the 4 warps owning 16 rows;
//   - f32: multiplies on the FMA units (no TF32: the f32 path keeps f32
//     products), each of 256 threads owning a 4x4 tile of a 64x64 block.
// Columns past F are zero in shared memory and never stored, so any F >= 1
// works and x is never read past its row. The sum is rounded once, at the
// store. The band's zero tiles are multiplied like any other.
//
// window_scatter_kernel replaces _win_scatter_kernel behind
// window_scatter_sum of the same file: for every window-eligible slot e
// (sender_tab[e] >= 0) add v[e, :] into row sender_tab[e] of the output. The
// TPU has no scatter and multiplies an equality one-hot on its matrix unit;
// here the rows are summed directly. Bound by bytes: the eligible rows of v
// once, sender_tab, the output once. Design: one block per (window, part of
// up to 256 of its rows, tile of up to 32 columns) holds that part's
// [rows, cols] f32 sums in shared memory (50 KB in all: four blocks per
// SM). The block walks the window's edge chunks in plan order, 512 slots at
// a time: its threads stage each slot's row in the part (or -1) in shared
// memory, then each of its 8 warps, which owns 1/8 of the part's rows,
// compacts the slots that hit its rows into a queue (ballot and prefix
// count, in slot order), loads their v rows 16 at a time (one column per
// lane, all 16 in flight) and adds them in queue order. A warp owns only a
// few percent of the slots, so the queue is what keeps loads in flight. Every
// (row, column) therefore gets its terms in plan and slot order from one
// lane: no atomics, the result is the same bit for bit on every launch. The
// whole [W, F] window is stored, zeros included, for every window.
//
// The C entry points launch on the given stream, allocate nothing, do not
// synchronise, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using nvcuda::wmma::accumulator;
using nvcuda::wmma::fragment;
using nvcuda::wmma::matrix_a;
using nvcuda::wmma::matrix_b;
using nvcuda::wmma::mem_row_major;
using nvcuda::wmma::row_major;

constexpr int kTileRows = 64;   // rows of a block's output tile
constexpr int kSlab = 32;       // window columns staged per step
constexpr int kBf16Threads = 128;
constexpr int kF32Threads = 256;
constexpr int kF32Cols = 64;
constexpr int kScatterThreads = 256;
constexpr int kScatterWarps = kScatterThreads / 32;
constexpr int kScatterCols = 32;
constexpr int kScatterRows = 256;  // rows of a window per block, at most
constexpr int kStage = 512;        // slots staged in shared memory at a time
constexpr int kBatch = 16;         // v rows loaded ahead of their adds

__device__ __forceinline__ float bf16_bits_to_float(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

__device__ __forceinline__ uint16_t float_to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

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

// ---------------------------------------------------------------------------
// K11, bf16: tensor-core fragments. NF fragments of 16 columns per warp.
// ---------------------------------------------------------------------------

template <int NF, bool VEC>
__global__ void __launch_bounds__(kBf16Threads)
band_bf16_kernel(const uint16_t* __restrict__ x,
                 const uint16_t* __restrict__ band,
                 const int32_t* __restrict__ base_idx,
                 uint16_t* __restrict__ out, int64_t n_pad, int64_t f,
                 int window, int row_block, int col_tiles) {
  constexpr int kCols = NF * 16;
  constexpr int kLdA = kSlab + 8;   // bf16 elements; rows stay 32-byte aligned
  constexpr int kLdB = kCols + 8;
  constexpr int kLdS = 16 + 4;      // f32 staging of one fragment
  __shared__ __align__(32) uint16_t a_s[kTileRows * kLdA];
  __shared__ __align__(32) uint16_t b_s[kSlab * kLdB];
  __shared__ __align__(32) float stage[4 * 16 * kLdS];

  const int tile = blockIdx.x / col_tiles;
  const int64_t row0 = static_cast<int64_t>(tile) * kTileRows;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x % col_tiles) * kCols;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t base =
      static_cast<int64_t>(base_idx[row0 / row_block]) * (window / 2);

  fragment<accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) nvcuda::wmma::fill_fragment(acc[j], 0.0f);

  for (int k0 = 0; k0 < window; k0 += kSlab) {
    // band[row0 .. +64, k0 .. +32]: 256 chunks of 8 values, 2 per thread.
    for (int c = threadIdx.x; c < kTileRows * (kSlab / 8); c += kBf16Threads) {
      const int r = c / (kSlab / 8);
      const int q = c % (kSlab / 8);
      *reinterpret_cast<uint4*>(&a_s[r * kLdA + q * 8]) =
          *reinterpret_cast<const uint4*>(
              band + (row0 + r) * window + k0 + q * 8);
    }
    // x[base + k0 .. +32, col0 .. +kCols], zero past F or past n_pad.
    if (VEC) {
      for (int c = threadIdx.x; c < kSlab * (kCols / 8); c += kBf16Threads) {
        const int r = c / (kCols / 8);
        const int q = c % (kCols / 8);
        const int64_t xr = base + k0 + r;
        const int64_t xc = col0 + q * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (xr < n_pad && xc < f) {
          v = *reinterpret_cast<const uint4*>(x + xr * f + xc);
        }
        *reinterpret_cast<uint4*>(&b_s[r * kLdB + q * 8]) = v;
      }
    } else {
      for (int c = threadIdx.x; c < kSlab * kCols; c += kBf16Threads) {
        const int r = c / kCols;
        const int q = c % kCols;
        const int64_t xr = base + k0 + r;
        const int64_t xc = col0 + q;
        b_s[r * kLdB + q] =
            (xr < n_pad && xc < f) ? x[xr * f + xc] : static_cast<uint16_t>(0);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlab; kk += 16) {
      fragment<matrix_a, 16, 16, 16, __nv_bfloat16, row_major> a;
      nvcuda::wmma::load_matrix_sync(
          a, reinterpret_cast<const __nv_bfloat16*>(
                 &a_s[(warp * 16) * kLdA + kk]), kLdA);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        fragment<matrix_b, 16, 16, 16, __nv_bfloat16, row_major> b;
        nvcuda::wmma::load_matrix_sync(
            b, reinterpret_cast<const __nv_bfloat16*>(
                   &b_s[kk * kLdB + j * 16]), kLdB);
        nvcuda::wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();
  }

  // Each warp stores its 16 rows fragment by fragment through shared memory,
  // rounding once and skipping the columns past F.
  float* st = stage + warp * 16 * kLdS;
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    nvcuda::wmma::store_matrix_sync(st, acc[j], kLdS, mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) {
      const int r = i / 16;
      const int c = i % 16;
      const int64_t oc = col0 + j * 16 + c;
      if (oc < f) {
        out[(row0 + warp * 16 + r) * f + oc] = float_to_bf16_bits(st[r * kLdS + c]);
      }
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// K11, f32: FMA units, 4x4 outputs per thread.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kF32Threads)
band_f32_kernel(const float* __restrict__ x, const float* __restrict__ band,
                const int32_t* __restrict__ base_idx, float* __restrict__ out,
                int64_t n_pad, int64_t f, int window, int row_block,
                int col_tiles) {
  constexpr int kLdA = kSlab + 1;
  __shared__ float a_s[kTileRows * kLdA];
  __shared__ __align__(16) float b_s[kSlab * kF32Cols];

  const int tile = blockIdx.x / col_tiles;
  const int64_t row0 = static_cast<int64_t>(tile) * kTileRows;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x % col_tiles) * kF32Cols;
  const int ty = threadIdx.x / 16;  // rows ty*4 .. +4
  const int tx = threadIdx.x % 16;  // columns tx*4 .. +4
  const int64_t base =
      static_cast<int64_t>(base_idx[row0 / row_block]) * (window / 2);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < window; k0 += kSlab) {
    for (int c = threadIdx.x; c < kTileRows * (kSlab / 4); c += kF32Threads) {
      const int r = c / (kSlab / 4);
      const int q = c % (kSlab / 4);
      const float4 v = *reinterpret_cast<const float4*>(
          band + (row0 + r) * window + k0 + q * 4);
      a_s[r * kLdA + q * 4 + 0] = v.x;
      a_s[r * kLdA + q * 4 + 1] = v.y;
      a_s[r * kLdA + q * 4 + 2] = v.z;
      a_s[r * kLdA + q * 4 + 3] = v.w;
    }
    for (int c = threadIdx.x; c < kSlab * kF32Cols; c += kF32Threads) {
      const int r = c / kF32Cols;
      const int q = c % kF32Cols;
      const int64_t xr = base + k0 + r;
      const int64_t xc = col0 + q;
      b_s[r * kF32Cols + q] = (xr < n_pad && xc < f) ? x[xr * f + xc] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kSlab; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(
          &b_s[kk * kF32Cols + tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = a_s[(ty * 4 + i) * kLdA + kk];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = row0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t c = col0 + tx * 4 + j;
      if (c < f) out[r * f + c] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// K12: the window scatter.
// ---------------------------------------------------------------------------

template <typename S>
__global__ void __launch_bounds__(kScatterThreads)
window_scatter_kernel(const S* __restrict__ v,
                      const int32_t* __restrict__ sender_tab,
                      const int32_t* __restrict__ win_ptr,
                      const int32_t* __restrict__ item_chunk,
                      S* __restrict__ out, int window, int part_rows,
                      int edge_chunk, int64_t n_slots, int64_t f, int cols) {
  extern __shared__ float smem[];
  float* acc = smem;  // [part_rows, cols]
  int* rows_s = reinterpret_cast<int*>(smem + part_rows * cols);  // [kStage]
  // Per warp: (slot in the stage << 8) | row in the part, in slot order.
  int* queue = rows_s + kStage + (threadIdx.x / 32) * kStage;
  const int parts = window / part_rows;
  const int64_t win = blockIdx.x / parts;
  const int part = blockIdx.x % parts;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rows_per_warp = part_rows / kScatterWarps;
  const int lo = warp * rows_per_warp;
  const int hi = lo + rows_per_warp;
  const int64_t col = static_cast<int64_t>(blockIdx.y) * cols + lane;
  const bool in_tile = lane < cols;
  const bool active = in_tile && col < f;
  const int64_t base = win * window + static_cast<int64_t>(part) * part_rows;

  for (int r = lo; r < hi; ++r) {
    if (in_tile) acc[r * cols + lane] = 0.0f;
  }
  for (int it = win_ptr[win]; it < win_ptr[win + 1]; ++it) {
    const int64_t e0 = static_cast<int64_t>(item_chunk[it]) * edge_chunk;
    const int64_t e1 = e0 + edge_chunk < n_slots ? e0 + edge_chunk : n_slots;
    for (int64_t sb = e0; sb < e1; sb += kStage) {
      const int n = static_cast<int>(e1 - sb < kStage ? e1 - sb : kStage);
      __syncthreads();  // the previous stage is consumed
      for (int i = threadIdx.x; i < kStage; i += kScatterThreads) {
        int row = -1;
        if (i < n) {
          const int32_t s = sender_tab[sb + i];
          const int64_t d = static_cast<int64_t>(s) - base;
          if (s >= 0 && d >= 0 && d < part_rows) row = static_cast<int>(d);
        }
        rows_s[i] = row;
      }
      __syncthreads();
      int count = 0;
      for (int g = 0; g < n; g += 32) {
        const int row_of_lane = rows_s[g + lane];
        const bool mine = row_of_lane >= lo && row_of_lane < hi;
        const unsigned hits = __ballot_sync(0xffffffffu, mine);
        if (mine) {
          queue[count + __popc(hits & ((1u << lane) - 1u))] =
              ((g + lane) << 8) | row_of_lane;
        }
        count += __popc(hits);
      }
      __syncwarp();
      for (int q0 = 0; q0 < count; q0 += kBatch) {  // warp-uniform
        int ent[kBatch];
        float val[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          ent[b] = q0 + b < count ? queue[q0 + b] : -1;
          val[b] = 0.0f;
          if (ent[b] >= 0 && active) {
            val[b] = Cvt<S>::to_f(v[(sb + (ent[b] >> 8)) * f + col]);
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (ent[b] >= 0 && in_tile) acc[(ent[b] & 255) * cols + lane] += val[b];
        }
      }
    }
  }
  for (int r = lo; r < hi; ++r) {
    if (active) out[(base + r) * f + col] = Cvt<S>::from_f(acc[r * cols + lane]);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int NF>
cudaError_t launch_band_bf16(const void* x, const void* band,
                             const int32_t* base_idx, void* out,
                             int64_t n_pad, int64_t f, int window,
                             int row_block, cudaStream_t s) {
  const int col_tiles = static_cast<int>((f + NF * 16 - 1) / (NF * 16));
  const int64_t blocks = (n_pad / kTileRows) * col_tiles;
  const bool vec = f % 8 == 0 && aligned16(x);
  if (vec) {
    band_bf16_kernel<NF, true><<<static_cast<unsigned>(blocks), kBf16Threads,
                                 0, s>>>(
        static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(band),
        base_idx, static_cast<uint16_t*>(out), n_pad, f, window, row_block,
        col_tiles);
  } else {
    band_bf16_kernel<NF, false><<<static_cast<unsigned>(blocks), kBf16Threads,
                                  0, s>>>(
        static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(band),
        base_idx, static_cast<uint16_t*>(out), n_pad, f, window, row_block,
        col_tiles);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y = band @ x over row blocks: y[r, :] = sum_c band[r, c] * x[base + c, :]
// with base = base_idx[r / row_block] * window / 2. x, band and y share one
// type, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); x and y are [n_pad, f],
// band [n_pad, window]. n_pad is a multiple of row_block, row_block of 64 and
// window of 32; band is 16-byte aligned.
int kgt_band_matmul(const void* x, const void* band, const int32_t* base_idx,
                    void* out, int64_t n_pad, int64_t f, int window,
                    int row_block, int is_bf16, void* stream) {
  if (x == nullptr || band == nullptr || base_idx == nullptr ||
      out == nullptr || n_pad <= 0 || f <= 0 || window <= 0 ||
      window % kSlab != 0 || row_block <= 0 || row_block % kTileRows != 0 ||
      n_pad % row_block != 0 || !aligned16(band)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const int64_t w = f < 128 ? f : 128;
    if (w <= 16) return static_cast<int>(launch_band_bf16<1>(x, band, base_idx, out, n_pad, f, window, row_block, s));
    if (w <= 32) return static_cast<int>(launch_band_bf16<2>(x, band, base_idx, out, n_pad, f, window, row_block, s));
    if (w <= 64) return static_cast<int>(launch_band_bf16<4>(x, band, base_idx, out, n_pad, f, window, row_block, s));
    return static_cast<int>(launch_band_bf16<8>(x, band, base_idx, out, n_pad, f, window, row_block, s));
  }
  const int col_tiles = static_cast<int>((f + kF32Cols - 1) / kF32Cols);
  const int64_t blocks = (n_pad / kTileRows) * col_tiles;
  band_f32_kernel<<<static_cast<unsigned>(blocks), kF32Threads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(band), base_idx,
      static_cast<float*>(out), n_pad, f, window, row_block, col_tiles);
  return static_cast<int>(cudaGetLastError());
}

// out[win * window + j, :] = sum over the slots e of the chunks listed for
// window win (item_chunk[win_ptr[win] .. win_ptr[win + 1]], edge_chunk slots
// each) with sender_tab[e] == win * window + j of v[e, :]; every row of every
// window is written. v and out share one type, f32 or bf16; v is
// [n_slots, f], out [num_windows * window, f].
int kgt_window_scatter_sum(const void* v, const int32_t* sender_tab,
                           const int32_t* win_ptr, const int32_t* item_chunk,
                           void* out, int64_t num_windows, int window,
                           int edge_chunk, int64_t n_slots, int64_t f,
                           int is_bf16, void* stream) {
  if (v == nullptr || sender_tab == nullptr || win_ptr == nullptr ||
      item_chunk == nullptr || out == nullptr || num_windows <= 0 || window <= 0 || edge_chunk <= 0 ||
      n_slots <= 0 || f <= 0 || num_windows >= (static_cast<int64_t>(1) << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // A block owns up to kScatterRows rows of a window (the window is split
  // into equal parts) and up to 32 columns, one per lane.
  int part_rows = window < kScatterRows ? window : kScatterRows;
  while (window % part_rows != 0 || part_rows % kScatterWarps != 0) {
    --part_rows;
  }
  if (part_rows < kScatterWarps) return static_cast<int>(cudaErrorInvalidValue);
  const int cols = kScatterCols;
  const size_t smem = static_cast<size_t>(part_rows) * cols * sizeof(float) +
                      (1 + kScatterWarps) * kStage * sizeof(int);
  const int64_t tiles = (f + cols - 1) / cols;
  const int64_t blocks = num_windows * (window / part_rows);
  if (tiles >= 65536 || blocks >= (static_cast<int64_t>(1) << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(tiles), 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = cudaFuncSetAttribute(window_scatter_kernel<uint16_t>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    window_scatter_kernel<uint16_t><<<grid, kScatterThreads, smem, s>>>(
        static_cast<const uint16_t*>(v), sender_tab, win_ptr, item_chunk,
        static_cast<uint16_t*>(out), window, part_rows, edge_chunk, n_slots,
        f, cols);
  } else {
    err = cudaFuncSetAttribute(window_scatter_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    window_scatter_kernel<float><<<grid, kScatterThreads, smem, s>>>(
        static_cast<const float*>(v), sender_tab, win_ptr, item_chunk,
        static_cast<float*>(out), window, part_rows, edge_chunk, n_slots, f,
        cols);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kgt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
