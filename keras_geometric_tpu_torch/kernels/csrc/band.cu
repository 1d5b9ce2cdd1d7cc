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
// Three instantiations, chosen by the caller (the route argument; nothing
// falls back from one to another):
//   - bf16, F % 8 == 0, row_block 256, window % 64 == 0 (the banded GCN's
//     shapes): band_bf16_tma_kernel. A CTA owns a whole row block at a time
//     (up to 128 columns; wider F takes more column tiles), so each [W, F]
//     x window is read once per row block. A producer warp keeps a ring of
//     up to 200 KB of stages full by TMA (cp.async.bulk.tensor, 2-D tensor maps,
//     completion counted on mbarriers): a stage holds band[256 rows, 64
//     window columns] and x[64 window rows, N columns], both in the 128-byte
//     swizzle, so that every TMA row is a 128-byte run of device memory.
//     Two consumer warpgroups, 128 rows each, multiply every stage with
//     wgmma (m64 N k16, bf16 in, f32 accumulators in registers; the band
//     K-major, x MN-major, N = the tile's columns, any multiple of 8 up to
//     128, so F = 40 runs as N = 40) and release it. The grid is persistent
//     (one CTA per SM walks the tiles), so the ring runs on into the next
//     tile while the consumers round once to bf16 and store the last one
//     from their registers. Rows past n_pad of an x window and columns past
//     F are TMA's zero fill.
//   - other bf16 shapes: band_bf16_kernel. A block owns a 64-row tile of one
//     row block (row_block a multiple of 64) and up to 128 columns; it walks
//     the window in slabs of 32, stages band[rows, slab] and x[base + slab,
//     cols] in shared memory with thread-issued loads and multiplies
//     16x16x16 fragments on the tensor cores (nvcuda::wmma, f32
//     accumulators), each of the 4 warps owning 16 rows. Columns past F are
//     zero in shared memory and never stored, so any F >= 1 works.
//   - f32: band_f32_kernel, the same tiling on the FMA units (no TF32: the
//     f32 path keeps f32 products), each of 256 threads owning a 4x4 tile of
//     a 64x64 block. No timed run reaches it.
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

constexpr int kTileRows = 64;   // rows of a block's output tile
constexpr int kSlab = 32;       // window columns staged per step
constexpr int kBf16Threads = 128;
constexpr int kF32Threads = 256;
constexpr int kF32Cols = 64;
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

// Shared memory of a ring stage, every operand in the 128-byte swizzle TMA
// writes and wgmma reads: the band tile [256 rows, 64 window columns], one
// 128-byte row a node (K-major A), then the x tile [64 window rows, N
// columns] as ceil(N/64) atoms of [64 rows, 64 columns] (MN-major B; columns
// past F are TMA's zero fill).
template <int N>
struct TmaStage {
  static constexpr int kAtoms = (N + 63) / 64;
  static constexpr int kABytes = kTmaRows * kTmaK * 2;
  static constexpr int kAtomBytes = kTmaK * 64 * 2;
  static constexpr int kBytes = kABytes + kAtoms * kAtomBytes;  // 1 KB units
  static constexpr int kStages = kTmaRingBytes / kBytes;  // 4 at N = 128
  static constexpr int kSmem = kStages * kBytes + 2 * kStages * 8 + 1024;
};

// Persistent: CTA c takes tiles c, c + gridDim.x, ... of `tiles` (row block
// major, then col_tiles column tiles of N columns from col_base). The ring
// runs on across tiles, so the producer loads the next tile while the
// consumers store the last one.
template <int N>
__global__ void __launch_bounds__(kTmaThreads, 1)
band_bf16_tma_kernel(const __grid_constant__ CUtensorMap band_map,
                     const __grid_constant__ CUtensorMap x_map,
                     const int32_t* __restrict__ base_idx,
                     uint16_t* __restrict__ out, int64_t f, int window,
                     int col_base, int col_tiles, int tiles) {
  using St = TmaStage<N>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const uint32_t ring = smem_u32(smem);
  const uint32_t full0 = ring + St::kStages * St::kBytes;  // kStages x 8 B
  const uint32_t empty0 = full0 + St::kStages * 8;
  const int ktiles = window / kTmaK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

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
          mbar_expect_tx(full, St::kBytes);
          tma_load_2d(a, &band_map, full, kt * kTmaK, row0, stream_once);
#pragma unroll
          for (int g = 0; g < St::kAtoms; ++g) {
            tma_load_2d(a + St::kABytes + g * St::kAtomBytes, &x_map, full,
                        col0 + g * 64, base + kt * kTmaK, reread);
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
    // already taking the next tile.
    const int64_t row0 = static_cast<int64_t>(tile / col_tiles) * kTmaRows;
    const int64_t col0 = col_base + (tile % col_tiles) * kTmaMaxN;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int64_t r =
          row0 + wg * 128 + t * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int64_t c = col0 + j * 8 + (lane % 4) * 2;
        *reinterpret_cast<__nv_bfloat162*>(out + r * f + c) =
            __floats2bfloat162_rn(acc[t][4 * j], acc[t][4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(out + (r + 8) * f + c) =
            __floats2bfloat162_rn(acc[t][4 * j + 2], acc[t][4 * j + 3]);
      }
    }
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

template <int N>
cudaError_t launch_tma_tile(const CUtensorMap& band_map,
                            const CUtensorMap& x_map, const int32_t* base_idx,
                            void* out, int64_t n_pad, int64_t f, int window,
                            int col_base, int col_tiles, cudaStream_t s) {
  const int smem = TmaStage<N>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      band_bf16_tma_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  const int64_t tiles = n_pad / kTmaRows * col_tiles;
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  band_bf16_tma_kernel<N><<<grid, kTmaThreads, smem, s>>>(
      band_map, x_map, base_idx, static_cast<uint16_t*>(out), f, window,
      col_base, col_tiles, static_cast<int>(tiles));
  return cudaGetLastError();
}

// `col_tiles` CTAs of n columns per row block, from column col_base.
cudaError_t launch_tma_cols(int n, const CUtensorMap& band_map,
                            const CUtensorMap& x_map, const int32_t* base_idx,
                            void* out, int64_t n_pad, int64_t f, int window,
                            int col_base, int col_tiles, cudaStream_t s) {
#define KGT_TMA_N(N)                                                       \
  case N:                                                                  \
    return launch_tma_tile<N>(band_map, x_map, base_idx, out, n_pad, f,    \
                              window, col_base, col_tiles, s);
  switch (n) {
    KGT_TMA_N(8) KGT_TMA_N(16) KGT_TMA_N(24) KGT_TMA_N(32) KGT_TMA_N(40)
    KGT_TMA_N(48) KGT_TMA_N(56) KGT_TMA_N(64) KGT_TMA_N(72) KGT_TMA_N(80)
    KGT_TMA_N(88) KGT_TMA_N(96) KGT_TMA_N(104) KGT_TMA_N(112)
    KGT_TMA_N(120) KGT_TMA_N(128)
    default: return cudaErrorInvalidValue;
  }
#undef KGT_TMA_N
}

cudaError_t launch_band_tma(const void* x, const void* band,
                            const int32_t* base_idx, void* out,
                            int64_t n_pad, int64_t f, int window,
                            cudaStream_t s) {
  CUtensorMap band_map, x_map;
  if (!encode_bf16_2d(&band_map, band, n_pad, window, kTmaRows) ||
      !encode_bf16_2d(&x_map, x, n_pad, f, kTmaK)) {
    return cudaErrorInvalidValue;
  }
  const int full = static_cast<int>(f / kTmaMaxN);
  const int rest = static_cast<int>(f % kTmaMaxN);
  if (full > 0) {
    const cudaError_t err = launch_tma_cols(kTmaMaxN, band_map, x_map,
                                            base_idx, out, n_pad, f, window,
                                            0, full, s);
    if (err != cudaSuccess) return err;
  }
  if (rest > 0) {
    return launch_tma_cols(rest, band_map, x_map, base_idx, out, n_pad, f,
                           window, full * kTmaMaxN, 1, s);
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
// the thread-staged kernels (wmma for bf16, FMA for f32), 1 the TMA + wgmma
// kernel, which takes bf16 with f % 8 == 0, row_block == 256, window % 64 ==
// 0 and 16-byte aligned x and y, and refuses anything else.
int kgt_band_matmul(const void* x, const void* band, const int32_t* base_idx,
                    void* out, int64_t n_pad, int64_t f, int window,
                    int row_block, int is_bf16, int route, void* stream) {
  if (x == nullptr || band == nullptr || base_idx == nullptr ||
      out == nullptr || n_pad <= 0 || f <= 0 || window <= 0 ||
      window % kSlab != 0 || row_block <= 0 || row_block % kTileRows != 0 ||
      n_pad % row_block != 0 || !aligned16(band) || route < 0 || route > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (!is_bf16 || f % 8 != 0 || row_block != kTmaRows ||
        window % kTmaK != 0 || !aligned16(x) || !aligned16(out) ||
        n_pad >= (static_cast<int64_t>(1) << 31)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(
        launch_band_tma(x, band, base_idx, out, n_pad, f, window, s));
  }
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
