// Locality-tier kernels for Hopper (sm_90a): the banded SpMM and the window
// scatter of the banded attention backward.
//
// band_bf16_tma_kernel, band_bf16_kernel and band_f32_kernel replace the TPU
// kernel of the JAX package's kernels/band_pallas.py, _band_kernel behind
// _band_matmul (band_spmm):
//     y[b*RB : (b+1)*RB, :] = band[b*RB : (b+1)*RB, 0:W] @ x[base(b) : base(b)+W, :]
// with base(b) = base_idx[b] * W/2 (the host clamps it so that the window
// lies inside [0, n_pad)). The band is dense: after a locality reordering it
// holds the edges whose sender lies in the receiver block's window. The work
// is a product of dense tiles, bound by bytes on this card: the [n_pad, W]
// band is read once (2W bytes per node row in bf16 against 2F for each of x
// and y), and at F <= 128 the operations are far below the tensor cores'
// rate.
// Four instantiations, chosen by the caller (the route argument; nothing
// falls back from one to another):
//   - bf16, F % 8 == 0, row_block 256, window % 64 == 0 (the banded GCN's
//     arxiv widths): band_bf16_tma_kernel<N, false>. A CTA owns a whole row
//     block at a time (up to 128 columns; wider F takes more column tiles),
//     so each [W, F] x window is read once per row block. A producer warp
//     keeps a ring of up to 192 KB of stages full by TMA
//     (cp.async.bulk.tensor, 2-D tensor maps, completion counted on
//     mbarriers): a stage holds band[256 rows, 64 window columns] and x[64
//     window rows, N columns], both in the 128-byte swizzle, so that every
//     TMA row is a 128-byte run of device memory. Two consumer warpgroups,
//     128 rows each, multiply every stage with wgmma (m64 N k16, bf16 in,
//     f32 accumulators in registers; the band K-major, x MN-major, N = the
//     tile's columns, any multiple of 8 up to 128, so F = 40 runs as N =
//     40) and release it. The grid is persistent (one CTA per SM walks the
//     tiles), so the ring runs on into the next tile while the consumers
//     round once to bf16 and store the last one from their registers. Rows
//     past n_pad of an x window and columns past F are TMA's zero fill.
//   - bf16 at any other F, row_block 256, window % 64 == 0 (the products
//     widths, F = 100 and 47): band_bf16_tma_kernel<N, true>, the same CTA,
//     ring, band tensor map and wgmma with N = the tile's columns rounded up
//     to 8 (7 -> 8, 47 -> 48, 100 -> 104). A tensor map's rows must start on
//     16-byte boundaries, which a row of 2F bytes does not; but the 64
//     window rows of a stage start at a multiple of 32 (W/2 is one), so
//     their 128F bytes are one run of device memory from a 64F-byte
//     boundary, 16-byte aligned whatever F is. Where the
//     tile holds every column (F <= 128) the producer brings that run in
//     with one 1-D cp.async.bulk on the stage's mbarrier; a column tile of a
//     wider F takes each row's part, widened to the 16-byte chunks around
//     it, in a 1-D copy of its own. The consumers then rewrite the run, 8
//     columns a thread at a time, into the MN-major swizzled tile that wgmma
//     reads (zeros past F), fence it to the async proxy, meet on a named
//     barrier and multiply. The epilogue stores no column at or past F.
//   - bf16 at other row blocks or windows: band_bf16_kernel. A block owns a
//     64-row tile of one row block (row_block a multiple of 64) and up to
//     128 columns; it walks the window in slabs of 32, stages band[rows,
//     slab] and x[base + slab, cols] in shared memory with thread-issued
//     loads and multiplies 16x16x16 fragments on the tensor cores
//     (nvcuda::wmma, f32 accumulators), each of the 4 warps owning 16 rows.
//     Columns past F are zero in shared memory and never stored. No run of
//     the port gives it a shape: build_band_plan makes windows of a
//     multiple of 256, and prepare_graph's band_row_block is 256 unless a
//     caller sets another.
//   - f32: band_f32_kernel<NC, K, VEC>, on the FMA units (no TF32: the f32
//     path keeps f32 products). The banded twin (examples_torch/
//     locality_banded_gcn.py) runs it 4 times a step. Bound by operations at
//     F = 64 (67 TFLOP/s against 4W bytes a row) and by the band's bytes at
//     F = 16. A block of 4 warps owns 64 rows of one row block and NC = 16,
//     32 or 64 columns, the least that holds F (wider F: more column
//     tiles), so no FMA is spent on a zero column below 16. A cp.async ring
//     brings band[64 rows, K window columns] (row-major, 16-byte copies,
//     rows padded to K + 4 floats) and x[K window rows, NC columns]
//     (16-byte copies where F % 4 == 0, else 4-byte ones; zeros past F), so
//     the next slabs are in flight while the FMAs run, with one
//     __syncthreads a slab: K = 32 in 4 stages where the FMAs bound it, K =
//     64 in 2 stages at NC = 16, where the band's bytes do and 256-byte runs
//     of a band row read faster than 128-byte ones (K = 32 there too where
//     the window is not a multiple of 64). A thread owns 8 rows x
//     8 columns (8 x 4 at NC = 16): per 4 window columns it reads one
//     16-byte band vector a row and two 16-byte x vectors a column, 16
//     shared loads for 256 FMAs (a 4 x 8 tile took 12 for 128 and ran
//     slower, PERF.md), without bank conflicts. The rows of a block take
//     one or two warps, so 2 or 4 warps (k groups) share each row range,
//     each summing its own quarter or half of every slab's window columns;
//     at the end the groups' sums meet in shared memory and are added in
//     group order. So the twin's 20,480 rows give 320 blocks, 3 an SM at
//     most (168 registers a thread and a 69 KB ring at NC = 64): all of
//     them resident at once.
// x is never read past its row. The sum is rounded once, at the store. The
// band's zero tiles are multiplied like any other.
//
// window_scatter_kernel replaces _win_scatter_kernel behind
// window_scatter_sum of the same file: for every window-eligible slot e
// (sender_tab[e] >= 0) add v[e, :] into row sender_tab[e] of the output,
// every row of every window written, zeros included. The TPU has no scatter
// and multiplies an equality one-hot on its matrix unit, window by window
// over the receiver-sorted stream; here the rows are summed directly. Bound
// by bytes: the eligible rows of v once, sender_tab, the output once. A walk
// of the receiver-sorted stream per (window, column tile) would read every
// slot's index once per tile and hold a window's sums in shared memory (such
// a walk reached 13% of the bound on the H100, PERF.md). Instead the host lists
// the eligible slots in sender order (stable, so ascending slot order within
// a row) with a row pointer over the windows' rows and that list's work list
// of pieces of at most 32 slots (band_cuda.build_window_scatter_plan), and
// the kernel is the fused-gather piece walk of gather_pieces.cuh, which
// spmm.cu's sender finish shares: a sub-warp per piece stages its slot
// indices, keeps the next eight v rows in flight in a cp.async ring, 16-byte
// packs a lane (a whole 512-byte row a warp at H*F = 256 in bf16), and sums
// them in f32 in slot order; a row without a slot is one empty piece and is
// stored as zeros; a split row's shares are added in piece order by a second
// launch (window_scatter_merge_kernel). The walk is CHECKED: a slot adds to
// its row only where sender_tab names that row, so a slot whose entry is -1
// contributes nothing whatever the list says. No atomics: every launch gives
// the same bits, and a row of at most 32 eligible slots gets the bits of a
// serial sum in ascending slot order.
//
// The C entry points launch on the given stream, allocate nothing, do not
// synchronise, and return cudaGetLastError().

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "gather_pieces.cuh"

namespace {

using nvcuda::wmma::accumulator;
using nvcuda::wmma::fragment;
using nvcuda::wmma::matrix_a;
using nvcuda::wmma::matrix_b;
using nvcuda::wmma::mem_row_major;
using nvcuda::wmma::row_major;

constexpr int kTileRows = 64;   // rows of a wmma block (the row blocks' grain)
constexpr int kSlab = 32;       // window columns a wmma block stages a step
constexpr int kBf16Threads = 128;
constexpr int kF32Rows = 64;    // rows of an f32 block
constexpr int kTmaRows = 256;      // rows of a row block, all in one CTA
constexpr int kTmaK = 64;          // window columns of a ring stage
constexpr int kTmaRingBytes = 192 * 1024;  // ring stages fill up to this
constexpr int kTmaMaxN = 128;      // output columns of a CTA at most
constexpr int kTmaConsumers = 256; // two warpgroups of 128 rows each
constexpr int kTmaThreads = kTmaConsumers + 32;  // and one producer warp

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
// K11, bf16 on Hopper's TMA and wgmma.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 2-D tensor map into shared memory; c0 is the column (the
// contiguous dimension), c1 the row. Completion is counted on `bar`;
// `policy` is an L2 cache policy (createpolicy).
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "l"(policy)
      : "memory");
}

// L2 policies: the band is read once (evict it first), an x window is read
// by the row blocks around it (keep it).
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// wgmma's shared-memory descriptor: start address, the byte strides
// between core matrices (leading, stride) in 16-byte units, and the layout
// (1: the 128-byte swizzle TMA writes with CU_TENSOR_MAP_SWIZZLE_128B).
__device__ __forceinline__ uint64_t gmma_desc_sw128(uint32_t addr,
                                                   uint32_t lbo,
                                                   uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (uint64_t{1} << 62);
}

// Keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x N] += A[64 x 16] * B[16 x N], bf16 in, f32 accumulators: A
// K-major, B MN-major (transposed), both read from shared memory through
// their descriptors. Thread t of the warpgroup holds, for each 8-column
// chunk j, d[4j], d[4j+1] at row 16*(t/32) + (t%32)/4, columns
// 8j + 2*(t%4) + {0, 1}, and d[4j+2], d[4j+3] eight rows below.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a,
                                           uint64_t b);

#define KGT_S4(i, j, k, l) "%" #i ", %" #j ", %" #k ", %" #l
#define KGT_G0 KGT_S4(0, 1, 2, 3)
#define KGT_G1 KGT_G0 ", " KGT_S4(4, 5, 6, 7)
#define KGT_G2 KGT_G1 ", " KGT_S4(8, 9, 10, 11)
#define KGT_G3 KGT_G2 ", " KGT_S4(12, 13, 14, 15)
#define KGT_G4 KGT_G3 ", " KGT_S4(16, 17, 18, 19)
#define KGT_G5 KGT_G4 ", " KGT_S4(20, 21, 22, 23)
#define KGT_G6 KGT_G5 ", " KGT_S4(24, 25, 26, 27)
#define KGT_G7 KGT_G6 ", " KGT_S4(28, 29, 30, 31)
#define KGT_G8 KGT_G7 ", " KGT_S4(32, 33, 34, 35)
#define KGT_G9 KGT_G8 ", " KGT_S4(36, 37, 38, 39)
#define KGT_G10 KGT_G9 ", " KGT_S4(40, 41, 42, 43)
#define KGT_G11 KGT_G10 ", " KGT_S4(44, 45, 46, 47)
#define KGT_G12 KGT_G11 ", " KGT_S4(48, 49, 50, 51)
#define KGT_G13 KGT_G12 ", " KGT_S4(52, 53, 54, 55)
#define KGT_G14 KGT_G13 ", " KGT_S4(56, 57, 58, 59)
#define KGT_G15 KGT_G14 ", " KGT_S4(60, 61, 62, 63)
#define KGT_F4(i) \
  "+f"(d[4 * i]), "+f"(d[4 * i + 1]), "+f"(d[4 * i + 2]), "+f"(d[4 * i + 3])
#define KGT_R0 KGT_F4(0)
#define KGT_R1 KGT_R0, KGT_F4(1)
#define KGT_R2 KGT_R1, KGT_F4(2)
#define KGT_R3 KGT_R2, KGT_F4(3)
#define KGT_R4 KGT_R3, KGT_F4(4)
#define KGT_R5 KGT_R4, KGT_F4(5)
#define KGT_R6 KGT_R5, KGT_F4(6)
#define KGT_R7 KGT_R6, KGT_F4(7)
#define KGT_R8 KGT_R7, KGT_F4(8)
#define KGT_R9 KGT_R8, KGT_F4(9)
#define KGT_R10 KGT_R9, KGT_F4(10)
#define KGT_R11 KGT_R10, KGT_F4(11)
#define KGT_R12 KGT_R11, KGT_F4(12)
#define KGT_R13 KGT_R12, KGT_F4(13)
#define KGT_R14 KGT_R13, KGT_F4(14)
#define KGT_R15 KGT_R14, KGT_F4(15)
// N columns: (N/8) groups of four accumulator registers, then the two
// descriptors and the scale-d flag as operands 4*(N/8), +1, +2.
#define KGT_WGMMA(N, G, R, A, B, P)                                         \
  template <>                                                               \
  __device__ __forceinline__ void wgmma_bf16<N>(float (&d)[N / 2],          \
                                                uint64_t a, uint64_t b) {   \
    asm volatile(                                                           \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                    \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" G     \
        "}, %" #A ", %" #B ", p, 1, 1, 0, 1;\n}\n"                          \
        : R                                                                 \
        : "l"(a), "l"(b), "r"(1));                                          \
  }
KGT_WGMMA(8, KGT_G0, KGT_R0, 4, 5, 6)
KGT_WGMMA(16, KGT_G1, KGT_R1, 8, 9, 10)
KGT_WGMMA(24, KGT_G2, KGT_R2, 12, 13, 14)
KGT_WGMMA(32, KGT_G3, KGT_R3, 16, 17, 18)
KGT_WGMMA(40, KGT_G4, KGT_R4, 20, 21, 22)
KGT_WGMMA(48, KGT_G5, KGT_R5, 24, 25, 26)
KGT_WGMMA(56, KGT_G6, KGT_R6, 28, 29, 30)
KGT_WGMMA(64, KGT_G7, KGT_R7, 32, 33, 34)
KGT_WGMMA(72, KGT_G8, KGT_R8, 36, 37, 38)
KGT_WGMMA(80, KGT_G9, KGT_R9, 40, 41, 42)
KGT_WGMMA(88, KGT_G10, KGT_R10, 44, 45, 46)
KGT_WGMMA(96, KGT_G11, KGT_R11, 48, 49, 50)
KGT_WGMMA(104, KGT_G12, KGT_R12, 52, 53, 54)
KGT_WGMMA(112, KGT_G13, KGT_R13, 56, 57, 58)
KGT_WGMMA(120, KGT_G14, KGT_R14, 60, 61, 62)
KGT_WGMMA(128, KGT_G15, KGT_R15, 64, 65, 66)

// One 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into shared memory, completion counted on
// `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// Shared memory of a ring stage, every operand in the 128-byte swizzle TMA
// writes and wgmma reads: the band tile [256 rows, 64 window columns], one
// 128-byte row a node (K-major A), then the x tile [64 window rows, N
// columns] as ceil(N/64) atoms of [64 rows, 64 columns] (MN-major B; columns
// past F are TMA's zero fill). FLAT (x by 1-D copies) adds the copied run:
// 64 slots of N + 8 bf16 values (a row's columns with up to 7 values of the
// 16-byte chunk they start in), which also holds 64 whole rows of F <= N.
template <int N, bool FLAT>
struct TmaStage {
  static constexpr int kAtoms = (N + 63) / 64;
  static constexpr int kABytes = kTmaRows * kTmaK * 2;
  static constexpr int kAtomBytes = kTmaK * 64 * 2;
  static constexpr int kSlot = N + 8;  // bf16 values of a row's slot
  static constexpr int kRawBytes =
      FLAT ? (kTmaK * kSlot * 2 + 1023) / 1024 * 1024 : 0;
  static constexpr int kBytes = kABytes + kAtoms * kAtomBytes + kRawBytes;
  static constexpr int kStages = kTmaRingBytes / kBytes;  // 4 at N = 128
  static constexpr int kSmem = kStages * kBytes + 2 * kStages * 8 + 1024;
};

// FLAT: the 1-D copy that brings x row `xr`'s columns col0 .. col0 + ncols
// into its slot, widened to whole 16-byte chunks: the first chunk's index
// (in bf16 values) and the bytes. A row past n_pad is not copied.
__device__ __forceinline__ uint32_t row_copy(int64_t xr, int64_t f,
                                             int64_t col0, int ncols,
                                             int64_t n_pad, int64_t* first) {
  if (xr >= n_pad) return 0;
  const int64_t lo = xr * f + col0;
  *first = lo / 8 * 8;
  return static_cast<uint32_t>((lo + ncols + 7) / 8 * 8 - *first) * 2;
}

// FLAT: 8 columns (chunk j of the tile) of window row k, from the copied run
// into the swizzled MN-major B tile; zeros past the tile's ncols and for a
// row past n_pad. `start` is the row's first value in the run (bf16
// index); the run is read as 32-bit words, an odd start through byte_perm.
template <int N>
__device__ __forceinline__ void flat_chunk(const uint8_t* raw, uint8_t* b,
                                           int k, int j, int64_t start,
                                           int ncols, bool in) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  const int valid = ncols - 8 * j;
  if (in && valid > 0) {
    const int64_t e0 = start + 8 * j;
    const uint32_t* words = reinterpret_cast<const uint32_t*>(raw) + e0 / 2;
    uint32_t v[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) v[i] = words[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = (e0 & 1) ? __byte_perm(v[i], v[i + 1], 0x5432) : v[i];
      if (2 * i >= valid) {
        w[i] = 0u;
      } else if (2 * i + 1 >= valid) {
        w[i] &= 0xFFFFu;  // the low half is column 2i, the high one 2i + 1
      }
    }
  }
  // TMA's 128-byte swizzle: chunk c of a 128-byte row k sits at c ^ (k % 8).
  *reinterpret_cast<uint4*>(b + (j / 8) * TmaStage<N, true>::kAtomBytes +
                            k * 128 + (((j % 8) ^ (k % 8)) * 16)) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

// Persistent: CTA c takes tiles c, c + gridDim.x, ... of `tiles` (row block
// major, then col_tiles column tiles of N columns from col_base). The ring
// runs on across tiles, so the producer loads the next tile while the
// consumers store the last one. FLAT reads x through `x` (x_map unused);
// `whole`: a tile holds every column (F <= 128), so a stage's x is one run.
template <int N, bool FLAT>
__global__ void __launch_bounds__(kTmaThreads, 1)
band_bf16_tma_kernel(const __grid_constant__ CUtensorMap band_map,
                     const __grid_constant__ CUtensorMap x_map,
                     const uint16_t* __restrict__ x,
                     const int32_t* __restrict__ base_idx,
                     uint16_t* __restrict__ out, int64_t n_pad, int64_t f,
                     int window, int col_base, int col_tiles, int tiles) {
  using St = TmaStage<N, FLAT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const uint32_t ring = smem_u32(smem);
  const uint32_t full0 = ring + St::kStages * St::kBytes;  // kStages x 8 B
  const uint32_t empty0 = full0 + St::kStages * 8;
  const int ktiles = window / kTmaK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool whole = col_base == 0 && col_tiles == 1 && f <= N;

  if (threadIdx.x == 0) {
    for (int s = 0; s < St::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kTmaConsumers / 32);  // one arrive a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kTmaConsumers / 32) {
    // Producer: one thread keeps the ring full.
    if (lane == 0) {
      const uint64_t stream_once = l2_evict_first();
      const uint64_t reread = l2_evict_last();
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int rb = tile / col_tiles;
        const int col0 = col_base + (tile % col_tiles) * kTmaMaxN;
        const int row0 = rb * kTmaRows;
        const int base = base_idx[rb] * (window / 2);
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % St::kStages;
          if (it >= St::kStages) {
            mbar_wait(empty0 + 8 * s, ((it / St::kStages) - 1) & 1);
          }
          const uint32_t full = full0 + 8 * s;
          const uint32_t a = ring + s * St::kBytes;
          if constexpr (!FLAT) {
            mbar_expect_tx(full, St::kBytes);
            tma_load_2d(a, &band_map, full, kt * kTmaK, row0, stream_once);
#pragma unroll
            for (int g = 0; g < St::kAtoms; ++g) {
              tma_load_2d(a + St::kABytes + g * St::kAtomBytes, &x_map, full,
                          col0 + g * 64, base + kt * kTmaK, reread);
            }
          } else {
            const uint32_t raw = a + St::kABytes + St::kAtoms * St::kAtomBytes;
            const int64_t xr0 = static_cast<int64_t>(base) + kt * kTmaK;
            if (whole) {
              // The rows from xr0 (a multiple of 32: W/2 is one) up to 64 or
              // n_pad (a multiple of 256): one run of a multiple of 64F
              // bytes from a 64F-byte boundary, so 16-byte aligned.
              const int64_t rows = n_pad - xr0 < kTmaK ? n_pad - xr0 : kTmaK;
              const uint32_t bytes =
                  rows > 0 ? static_cast<uint32_t>(rows * f * 2) : 0u;
              mbar_expect_tx(full, St::kABytes + bytes);
              tma_load_2d(a, &band_map, full, kt * kTmaK, row0, stream_once);
              if (bytes) bulk_load(raw, x + xr0 * f, bytes, full, reread);
            } else {
              const int ncols = static_cast<int>(
                  f - col0 < N ? f - col0 : N);
              uint32_t bytes = 0;
              int64_t first;
              for (int k = 0; k < kTmaK; ++k) {
                bytes += row_copy(xr0 + k, f, col0, ncols, n_pad, &first);
              }
              mbar_expect_tx(full, St::kABytes + bytes);
              tma_load_2d(a, &band_map, full, kt * kTmaK, row0, stream_once);
              for (int k = 0; k < kTmaK; ++k) {
                const uint32_t row_bytes =
                    row_copy(xr0 + k, f, col0, ncols, n_pad, &first);
                if (row_bytes) {
                  bulk_load(raw + k * St::kSlot * 2, x + first, row_bytes,
                            full, reread);
                }
              }
            }
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows wg*128 .. +128 of a tile as two m64
  // tiles; thread t holds rows 16*(t/32 % 4) + (t%32)/4 (+8) of each.
  const int wg = warp / 4;
  float acc[2][N / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t col0 = col_base + (tile % col_tiles) * kTmaMaxN;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[t][i] = 0.0f;
    }
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int s = it % St::kStages;
      mbar_wait(full0 + 8 * s, (it / St::kStages) & 1);
      const uint32_t a = ring + s * St::kBytes + wg * 128 * 128;
      const uint32_t b = ring + s * St::kBytes + St::kABytes;
      if constexpr (FLAT) {
        // Rewrite the copied run into the B tile: 8 columns a thread at a
        // time, then make the generic-proxy stores visible to wgmma and
        // wait for the other consumers' (named barrier 1: the 256
        // consumer threads; the producer warp never joins it).
        uint8_t* stage = smem + s * St::kBytes;
        const uint8_t* raw = stage + St::kABytes + St::kAtoms * St::kAtomBytes;
        const int64_t xr0 =
            static_cast<int64_t>(base_idx[tile / col_tiles]) * (window / 2) +
            kt * kTmaK;
        const int ncols = static_cast<int>(f - col0 < N ? f - col0 : N);
        for (int item = threadIdx.x; item < kTmaK * (N / 8);
             item += kTmaConsumers) {
          const int k = item / (N / 8);
          const int j = item % (N / 8);
          const int64_t xr = xr0 + k;
          const int64_t start =
              whole ? static_cast<int64_t>(k) * f
                    : static_cast<int64_t>(k) * St::kSlot +
                          (xr * f + col0) % 8;
          flat_chunk<N>(raw, stage + St::kABytes, k, j, start, ncols,
                        xr < n_pad);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync 1, %0;\n" ::"n"(kTmaConsumers) : "memory");
      }
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kTmaK / 16; ++kk) {
        // B: 8-row groups 1 KB apart along K, 64-column atoms apart along N;
        // a k16 step is 16 rows (2 KB) on.
        const uint64_t db =
            gmma_desc_sw128(b + kk * 16 * 128, St::kAtomBytes, 1024);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          // A: 8-row groups 1 KB apart; a k16 step is 32 bytes into each
          // swizzled 128-byte row.
          const uint64_t da =
              gmma_desc_sw128(a + t * 64 * 128 + kk * 32, 16, 1024);
          wgmma_bf16<N>(acc[t], da, db);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }
    // Epilogue: round once and store each thread's bf16 pairs; the ring is
    // already taking the next tile. FLAT stores no column at or past F, a
    // pair as one 4-byte store where F is even (then r * F + c is even).
    const int64_t row0 = static_cast<int64_t>(tile / col_tiles) * kTmaRows;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int64_t r =
          row0 + wg * 128 + t * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int64_t c = col0 + j * 8 + (lane % 4) * 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint16_t* dst = out + (r + 8 * h) * f + c;
          const float lo = acc[t][4 * j + 2 * h];
          const float hi = acc[t][4 * j + 2 * h + 1];
          if (!FLAT || (c + 1 < f && f % 2 == 0)) {
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(lo, hi);
          } else {
            if (c < f) dst[0] = float_to_bf16_bits(lo);
            if (c + 1 < f) dst[1] = float_to_bf16_bits(hi);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K11, f32: FMA units, a cp.async ring, 8 x 8 outputs a thread.
// ---------------------------------------------------------------------------

// Asynchronous copy of BYTES (16 or 4) into shared memory; src_bytes 0 reads
// nothing and writes zeros.
template <int BYTES>
__device__ __forceinline__ void copy_async_zfill(uint32_t dst, const void* src,
                                                 int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes) : "memory");
  }
}

// The tile of a block: 64 rows, NC columns, 4 warps. A thread owns 8 rows
// (ty + i*TY of its warp's rows) x TN columns (4tx .. +4, and NC/2 + 4tx ..
// +4 where TN = 8); a warp covers WR rows. RW warps cover the block's rows
// and KS warps, one per k group, share each row range: group kg takes
// window columns kg*32/KS .. +32/KS of every slab, and the groups' sums
// are added in group order at the end.
template <int NC, int KK>
struct F32Tile {
  // A ring stage holds KK window columns: 32 in 4 stages where the FMAs
  // bound the kernel; at NC = 16 the band's bytes do, and 64 columns in 2
  // stages read 256-byte runs of each band row (where window % 64 == 0;
  // other windows take 32 in 4 stages there too).
  static constexpr int kK = KK;
  static constexpr int kStages = KK == 64 ? 2 : 4;
  static constexpr int kLdA = kK + 4;  // band rows in shared memory, floats
  static constexpr int kRows = kF32Rows;
  static constexpr int kTn = NC >= 32 ? 8 : 4;
  static constexpr int kTx = NC / kTn;
  static constexpr int kTy = 32 / kTx;
  static constexpr int kWarpRows = 8 * kTy;
  static constexpr int kRw = kRows / kWarpRows;
  static constexpr int kKs = 4 / kRw;
  static constexpr int kGroupK = kK / kKs;  // window columns a slab
  static constexpr int kColStep = NC * 4 / kTn;  // between a thread's vectors
  static constexpr int kThreads = 128;
  static constexpr int kAFloats = kRows * kLdA;
  static constexpr int kStageFloats = kAFloats + kK * NC;
  static constexpr int kSmem = kStages * kStageFloats * 4;
  static_assert(KK == 32 || KK == 64, "a slab of 32 or 64 window columns");
  static_assert(kRw >= 1 && kRw * kKs == 4, "4 warps: row warps x k groups");
  // The k groups' sums, each element of a thread kThreads / kKs floats
  // apart, fit in the ring.
  static_assert((kKs - 1) * kRows * NC <= kStages * kStageFloats,
                "the merge must fit in the ring");
};

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <int NC, int KK, bool VEC>
__global__ void __launch_bounds__(128)
band_f32_kernel(const float* __restrict__ x, const float* __restrict__ band,
                const int32_t* __restrict__ base_idx, float* __restrict__ out,
                int64_t n_pad, int64_t f, int window, int row_block,
                int col_tiles) {
  using T = F32Tile<NC, KK>;
  constexpr int kTm = 8;
  extern __shared__ __align__(16) float f32_smem[];
  const int64_t row0 =
      static_cast<int64_t>(blockIdx.x / col_tiles) * T::kRows;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x % col_tiles) * NC;
  const int64_t base =
      static_cast<int64_t>(base_idx[row0 / row_block]) * (window / 2);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kg = warp / T::kRw;  // k group
  const int tx = lane % T::kTx;
  const int ty = lane / T::kTx;
  const int wrow = (warp % T::kRw) * T::kWarpRows + ty;  // rows wrow + i*TY
  const int ktiles = window / T::kK;

  // Slab kt of the window into ring stage s: band[row0 .., k0 .. +kK] as
  // 16-byte copies into rows of kLdA floats; x[base + k0 .., col0 ..
  // +NC], zeros past F (and past n_pad, which a clamped window never
  // reaches).
  auto load = [&](int kt, int s) {
    float* a = f32_smem + s * T::kStageFloats;
    float* b = a + T::kAFloats;
    const int k0 = kt * T::kK;
    for (int c = threadIdx.x; c < T::kRows * (T::kK / 4); c += T::kThreads) {
      const int r = c / (T::kK / 4);
      const int q = c % (T::kK / 4);
      copy_async_zfill<16>(shared_u32(a + r * T::kLdA + q * 4),
                           band + (row0 + r) * window + k0 + q * 4, 16);
    }
    if constexpr (VEC) {
      for (int c = threadIdx.x; c < T::kK * (NC / 4); c += T::kThreads) {
        const int r = c / (NC / 4);
        const int q = c % (NC / 4);
        const int64_t xr = base + k0 + r;
        const int64_t xc = col0 + q * 4;
        const bool in = xr < n_pad && xc < f;
        copy_async_zfill<16>(shared_u32(b + r * NC + q * 4),
                             in ? x + xr * f + xc : x, in ? 16 : 0);
      }
    } else {
      for (int c = threadIdx.x; c < T::kK * NC; c += T::kThreads) {
        const int r = c / NC;
        const int q = c % NC;
        const int64_t xr = base + k0 + r;
        const int64_t xc = col0 + q;
        const bool in = xr < n_pad && xc < f;
        copy_async_zfill<4>(shared_u32(b + r * NC + q), in ? x + xr * f + xc
                                                           : x,
                            in ? 4 : 0);
      }
    }
  };

  float acc[kTm][T::kTn];
#pragma unroll
  for (int i = 0; i < kTm; ++i) {
#pragma unroll
    for (int j = 0; j < T::kTn; ++j) acc[i][j] = 0.0f;
  }

#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < ktiles) load(s, s);
    copy_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    copy_wait<T::kStages - 2>();
    // Slab kt has landed for every thread, and every thread is done with
    // slab kt - 1, whose stage the next load refills.
    __syncthreads();
    if (kt + T::kStages - 1 < ktiles) {
      load(kt + T::kStages - 1, (kt + T::kStages - 1) % T::kStages);
    }
    copy_commit();
    const float* a = f32_smem + (kt % T::kStages) * T::kStageFloats;
    const float* b = a + T::kAFloats;
#pragma unroll
    for (int kq = 0; kq < T::kGroupK / 4; ++kq) {
      const int k = kg * T::kGroupK + kq * 4;
      float4 av[kTm];
#pragma unroll
      for (int i = 0; i < kTm; ++i) {
        av[i] = *reinterpret_cast<const float4*>(
            a + (wrow + i * T::kTy) * T::kLdA + k);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow = b + (k + kk) * NC + tx * 4;
        float bv[T::kTn];
#pragma unroll
        for (int h = 0; h < T::kTn / 4; ++h) {
          const float4 v =
              *reinterpret_cast<const float4*>(brow + h * T::kColStep);
          bv[4 * h] = v.x;
          bv[4 * h + 1] = v.y;
          bv[4 * h + 2] = v.z;
          bv[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < kTm; ++i) {
          const float ai = lane_of(av[i], kk);
#pragma unroll
          for (int j = 0; j < T::kTn; ++j) {
            acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
          }
        }
      }
    }
  }
  copy_wait<0>();
  __syncthreads();  // the ring is free: it takes the k groups' sums

  // Groups 1 .. KS-1 leave their sums in the ring, element e of thread t
  // of a group at (group - 1, e, t); group 0 adds them in group order.
  constexpr int kGroupThreads = T::kThreads / T::kKs;
  const int t = threadIdx.x % kGroupThreads;
  float* part = f32_smem;
  if (kg > 0) {
#pragma unroll
    for (int i = 0; i < kTm; ++i) {
#pragma unroll
      for (int j = 0; j < T::kTn; ++j) {
        part[((kg - 1) * kTm * T::kTn + i * T::kTn + j) * kGroupThreads + t] =
            acc[i][j];
      }
    }
  }
  __syncthreads();
  if (kg > 0) return;
  for (int g = 1; g < T::kKs; ++g) {
#pragma unroll
    for (int i = 0; i < kTm; ++i) {
#pragma unroll
      for (int j = 0; j < T::kTn; ++j) {
        acc[i][j] +=
            part[((g - 1) * kTm * T::kTn + i * T::kTn + j) * kGroupThreads + t];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTm; ++i) {
    float* row = out + (row0 + wrow + i * T::kTy) * f;
#pragma unroll
    for (int h = 0; h < T::kTn / 4; ++h) {
      const int64_t c = col0 + h * T::kColStep + tx * 4;
      const float* v = acc[i] + 4 * h;
      if (VEC && c < f) {  // F % 4 == 0: the four columns are all in
        *reinterpret_cast<float4*>(row + c) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else if (!VEC) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c + j < f) row[c + j] = v[j];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K12: the window scatter.
// ---------------------------------------------------------------------------

template <typename S, int VEC>
__global__ void __launch_bounds__(kThreads)
window_scatter_kernel(const S* __restrict__ v,
                      const int32_t* __restrict__ sender_tab,
                      const int32_t* __restrict__ idx,
                      const int4* __restrict__ pieces, int64_t n_pieces,
                      int cap, S* __restrict__ out, float* __restrict__ part,
                      int64_t f, int lpr) {
  gather_pieces_walk<S, VEC, true>(v, idx, pieces, n_pieces, cap, nullptr, 0,
                                   sender_tab, nullptr, 0, out, part, f, lpr);
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
window_scatter_merge_kernel(const float* __restrict__ part,
                            const int32_t* __restrict__ fix_rows,
                            const int32_t* __restrict__ fix_ptr,
                            int64_t n_fix, S* __restrict__ out, int64_t f) {
  merge_shares<S>(part, fix_rows, fix_ptr, n_fix, nullptr, nullptr, 0, out,
                  f);
}

template <typename S, int VEC>
cudaError_t launch_window_scatter(const void* v, const int32_t* sender_tab,
                                  const int32_t* idx, const int4* pieces,
                                  int64_t n_pieces, int cap, void* out,
                                  float* part, int64_t f, cudaStream_t s) {
  int lpr;
  dim3 grid;
  pick_geometry(f, VEC, n_pieces, &lpr, &grid);
  const size_t smem = pieces_smem<S, VEC>(lpr, cap, true);
  auto kernel = window_scatter_kernel<S, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return attr;
  }
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const S*>(v), sender_tab, idx, pieces, n_pieces, cap,
      static_cast<S*>(out), part, f, lpr);
  return cudaGetLastError();
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

// KK: window columns of a ring stage; window % KK == 0.
template <int NC, int KK>
cudaError_t launch_band_f32(const void* x, const void* band,
                            const int32_t* base_idx, void* out, int64_t n_pad,
                            int64_t f, int window, int row_block,
                            cudaStream_t s) {
  using T = F32Tile<NC, KK>;
  if (window % KK != 0) return cudaErrorInvalidValue;
  const int col_tiles = static_cast<int>((f + NC - 1) / NC);
  const int64_t blocks = (n_pad / T::kRows) * col_tiles;
  const bool vec = f % 4 == 0 && aligned16(x) && aligned16(out);
  auto kernel =
      vec ? band_f32_kernel<NC, KK, true> : band_f32_kernel<NC, KK, false>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (attr != cudaSuccess) return attr;
  kernel<<<static_cast<unsigned>(blocks), T::kThreads, T::kSmem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(band), base_idx,
      static_cast<float*>(out), n_pad, f, window, row_block, col_tiles);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime (no
// link against the driver library).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A row-major bf16 [rows, cols] array read in boxes of [box_rows, 64
// columns] (128 bytes a row), written to shared memory in the 128-byte
// swizzle; rows and columns past the end read as zeros.
bool encode_bf16_2d(CUtensorMap* map, const void* ptr, int64_t rows,
                    int64_t cols, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N, bool FLAT>
cudaError_t launch_tma_tile(const CUtensorMap& band_map,
                            const CUtensorMap& x_map, const void* x,
                            const int32_t* base_idx, void* out, int64_t n_pad,
                            int64_t f, int window, int col_base, int col_tiles,
                            cudaStream_t s) {
  const int smem = TmaStage<N, FLAT>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      band_bf16_tma_kernel<N, FLAT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  const int64_t tiles = n_pad / kTmaRows * col_tiles;
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  band_bf16_tma_kernel<N, FLAT><<<grid, kTmaThreads, smem, s>>>(
      band_map, x_map, static_cast<const uint16_t*>(x), base_idx,
      static_cast<uint16_t*>(out), n_pad, f, window, col_base, col_tiles,
      static_cast<int>(tiles));
  return cudaGetLastError();
}

// `col_tiles` CTAs of n columns per row block, from column col_base.
template <bool FLAT>
cudaError_t launch_tma_cols(int n, const CUtensorMap& band_map,
                            const CUtensorMap& x_map, const void* x,
                            const int32_t* base_idx, void* out, int64_t n_pad,
                            int64_t f, int window, int col_base, int col_tiles,
                            cudaStream_t s) {
#define KGT_TMA_N(N)                                                       \
  case N:                                                                  \
    return launch_tma_tile<N, FLAT>(band_map, x_map, x, base_idx, out,     \
                                    n_pad, f, window, col_base, col_tiles, \
                                    s);
  switch (n) {
    KGT_TMA_N(8) KGT_TMA_N(16) KGT_TMA_N(24) KGT_TMA_N(32) KGT_TMA_N(40)
    KGT_TMA_N(48) KGT_TMA_N(56) KGT_TMA_N(64) KGT_TMA_N(72) KGT_TMA_N(80)
    KGT_TMA_N(88) KGT_TMA_N(96) KGT_TMA_N(104) KGT_TMA_N(112)
    KGT_TMA_N(120) KGT_TMA_N(128)
    default: return cudaErrorInvalidValue;
  }
#undef KGT_TMA_N
}

// FLAT: x by 1-D copies (any F); else x by its tensor map (F % 8 == 0). The
// last column tile takes the rest of F rounded up to 8.
template <bool FLAT>
cudaError_t launch_band_tma(const void* x, const void* band,
                            const int32_t* base_idx, void* out,
                            int64_t n_pad, int64_t f, int window,
                            cudaStream_t s) {
  CUtensorMap band_map, x_map;
  if (!encode_bf16_2d(&band_map, band, n_pad, window, kTmaRows)) {
    return cudaErrorInvalidValue;
  }
  if (FLAT) {
    x_map = band_map;  // not read
  } else if (!encode_bf16_2d(&x_map, x, n_pad, f, kTmaK)) {
    return cudaErrorInvalidValue;
  }
  const int full = static_cast<int>(f / kTmaMaxN);
  const int rest = static_cast<int>(f % kTmaMaxN);
  if (full > 0) {
    const cudaError_t err = launch_tma_cols<FLAT>(
        kTmaMaxN, band_map, x_map, x, base_idx, out, n_pad, f, window, 0,
        full, s);
    if (err != cudaSuccess) return err;
  }
  if (rest > 0) {
    return launch_tma_cols<FLAT>((rest + 7) / 8 * 8, band_map, x_map, x,
                                 base_idx, out, n_pad, f, window,
                                 full * kTmaMaxN, 1, s);
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// y = band @ x over row blocks: y[r, :] = sum_c band[r, c] * x[base + c, :]
// with base = base_idx[r / row_block] * window / 2. x, band and y share one
// type, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); x and y are [n_pad, f],
// band [n_pad, window]. n_pad is a multiple of row_block, row_block of 64 and
// window of 32; band is 16-byte aligned. route picks the instantiation: 0
// the thread-staged kernels (wmma for bf16, the FMA ring for f32), 1 the TMA
// + wgmma kernel with x by its tensor map, which takes bf16 with f % 8 == 0,
// 2 the same kernel with x by 1-D copies, which takes bf16 at any f; both
// need row_block == 256, window % 64 == 0 and 16-byte aligned x and y, and
// refuse anything else.
int kgt_band_matmul(const void* x, const void* band, const int32_t* base_idx,
                    void* out, int64_t n_pad, int64_t f, int window,
                    int row_block, int is_bf16, int route, void* stream) {
  if (x == nullptr || band == nullptr || base_idx == nullptr ||
      out == nullptr || n_pad <= 0 || f <= 0 || window <= 0 ||
      window % kSlab != 0 || row_block <= 0 || row_block % kTileRows != 0 ||
      n_pad % row_block != 0 || !aligned16(band) || route < 0 || route > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route != 0) {
    if (!is_bf16 || (route == 1 && f % 8 != 0) || row_block != kTmaRows ||
        window % kTmaK != 0 || !aligned16(x) || !aligned16(out) ||
        n_pad >= (static_cast<int64_t>(1) << 31)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(
        route == 1 ? launch_band_tma<false>(x, band, base_idx, out, n_pad, f,
                                            window, s)
                   : launch_band_tma<true>(x, band, base_idx, out, n_pad, f,
                                           window, s));
  }
  if (is_bf16) {
    const int64_t w = f < 128 ? f : 128;
    if (w <= 16) return static_cast<int>(launch_band_bf16<1>(x, band, base_idx, out, n_pad, f, window, row_block, s));
    if (w <= 32) return static_cast<int>(launch_band_bf16<2>(x, band, base_idx, out, n_pad, f, window, row_block, s));
    if (w <= 64) return static_cast<int>(launch_band_bf16<4>(x, band, base_idx, out, n_pad, f, window, row_block, s));
    return static_cast<int>(launch_band_bf16<8>(x, band, base_idx, out, n_pad, f, window, row_block, s));
  }
  // NC: the least of 16, 32 and 64 columns that holds F (64 and more
  // column tiles past it). Slabs of 64 window columns at NC = 16 where the
  // window holds whole ones, else of 32.
  if (f <= 16) {
    return static_cast<int>(
        window % 64 == 0
            ? launch_band_f32<16, 64>(x, band, base_idx, out, n_pad, f,
                                      window, row_block, s)
            : launch_band_f32<16, 32>(x, band, base_idx, out, n_pad, f,
                                      window, row_block, s));
  }
  if (f <= 32) {
    return static_cast<int>(launch_band_f32<32, 32>(
        x, band, base_idx, out, n_pad, f, window, row_block, s));
  }
  return static_cast<int>(launch_band_f32<64, 32>(
      x, band, base_idx, out, n_pad, f, window, row_block, s));
}

// out[r, :] = sum over the eligible slots e with sender_tab[e] == r of
// v[e, :], for every row r of [0, n_rows) (n_rows = num_windows * window),
// zeros where there is none. v and out share one type, f32 or bf16; v is
// [n_slots, f], out [n_rows, f]. idx [n_idx] int32 lists the eligible slots
// in sender order and pieces [n_pieces, 4] int32 (row, first, end, share row
// or -1: positions in idx), 16-byte aligned, each of at most cap of them,
// cover every row and every listed slot once; the n_fix rows fix_rows split
// into several pieces are the sum of their shares fix_ptr[k] .. fix_ptr[k +
// 1] in the f32 scratch part [*, f], written before it is read. A listed
// slot adds only where sender_tab names its piece's row. Two launches: the
// piece walk, then (n_fix > 0) the split rows' merge.
int kgt_window_scatter_sum(const void* v, const int32_t* sender_tab,
                           const int32_t* idx, const int32_t* pieces,
                           int64_t n_pieces, int cap, float* part,
                           const int32_t* fix_rows, const int32_t* fix_ptr,
                           int64_t n_fix, void* out, int64_t n_rows,
                           int64_t f, int is_bf16, void* stream) {
  // idx may be null only for a list without slots (nothing reads it).
  if (v == nullptr || sender_tab == nullptr || out == nullptr ||
      !piece_list_ok(pieces, n_pieces, n_rows, cap, n_fix, part, fix_rows,
                     fix_ptr, f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = pick_vec(f, is_bf16 ? 2 : 4, v, out);
  const int4* work = reinterpret_cast<const int4*>(pieces);
  cudaError_t err = cudaSuccess;
#define KGT_WINDOW(S, V)                                                    \
  err = launch_window_scatter<S, V>(v, sender_tab, idx, work, n_pieces,     \
                                    cap, out, part, f, s)
  KGT_VEC_DISPATCH(is_bf16, vec, KGT_WINDOW)
#undef KGT_WINDOW
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_fix > 0) {
    const unsigned blocks =
        static_cast<unsigned>((n_fix * f + kThreads - 1) / kThreads);
    if (is_bf16) {
      window_scatter_merge_kernel<uint16_t><<<blocks, kThreads, 0, s>>>(
          part, fix_rows, fix_ptr, n_fix, static_cast<uint16_t*>(out), f);
    } else {
      window_scatter_merge_kernel<float><<<blocks, kThreads, 0, s>>>(
          part, fix_rows, fix_ptr, n_fix, static_cast<float*>(out), f);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kgt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
