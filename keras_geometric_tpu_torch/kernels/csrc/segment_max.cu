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
// backward expands the row max and the cotangent to every slot. Here the
// wide kernels are row-parallel CSR and walk a row's slots, the narrow one
// walks pieces of rows: a max is order-free, so the forwards are exact
// whatever the order, and nothing is expanded.
//
// Narrow design: the kernel walks the work list of K1's messages form
// (spmm_cuda.recv_bwd_work(row_ptr, split_piece=8): a row of at most 32
// slots is one piece, a longer one, a hub or the padded tail, pieces of 8),
// one thread per (piece, pack), a pack being up to 16 bytes of a slot's K
// heads (narrower where K or the pointers' alignment demand, so any K
// works). A block's pieces cover one contiguous run of slots: the block
// copies it, with its mask bytes, into shared memory a 32 KB tile at a
// time, neighbouring threads on neighbouring packs (cp.async: the scores
// are read as a copy reads them, no load waiting on the mask), and each
// thread keeps the maxes of its piece's unmasked slots. A whole row
// stores its maxes; a piece of a split row stores its f32 share and draws
// the row's ticket (tickets.cuh), and the warp of the thread that draws the
// last one merges the row's shares together, 32 at a time, then a butterfly
// (a max is exact in any order: every row equals a serial walk's, bit for
// bit). Blocks take the list from its end, so the padded tail (the last
// row) is merged while the rest is walked. Bound by bytes: the [E, K]
// scores read once, [N, K] written, the mask and the work list. (On the
// H100 at arxiv's [E, 4] scores a thread loading eight slots' packs and
// mask bytes straight from device memory ran within 5% of the tiles, both
// at about the time of a copy of the scores; on a 20,000-slot hub row it
// took 2.4x its time without the hub, the tiles 1.9x, PERF.md.)
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
// backward writes exactly the slots of the rows). No atomics on data (the
// narrow kernel's tickets count arrivals). Offsets into data are
// 64-bit; row pointers are int32. The C entry points launch on the given
// stream, allocate nothing, do not synchronise, and return
// cudaGetLastError().

#include "cp_async.cuh"
#include "fast_div.cuh"
#include "lanes.cuh"
#include "tickets.cuh"

namespace {

constexpr int kUnroll = 4;
constexpr float kSentinel = -1e30f;  // the JAX package's _NEG_SENTINEL
constexpr int kTileBytes = 32 * 1024;  // a narrow block's tile of scores
constexpr int kSharesInFlight = 8;     // shares a merging lane loads at once

__device__ __forceinline__ bool slot_on(const uint8_t* __restrict__ mask,
                                        int64_t e) {
  return mask == nullptr || mask[e] != 0;
}

// One thread per (piece, pack) of pieces [pieces, pieces + n_pieces) (the
// host launches a long list in parts of fewer than 2^31 items).
// pieces[p] = (row, first slot, end slot, share): share is -1 where the
// piece is its whole row, else its row in the f32 scratch part [*, k];
// tickets[s * chunks + c] counts the pieces of split row s whose pack c is
// in part. MASKED: whether mask is given. A block's pieces are consecutive,
// so their slots are one contiguous run of the scores: the block copies it
// into shared memory a tile at a time (cp.async, neighbouring threads on
// neighbouring packs, as a copy of the scores would read them), and each
// thread takes its piece's slots of the tile from there.
template <typename S, int VEC, bool MASKED>
__global__ void __launch_bounds__(kThreads)
segment_max_sorted_kernel(const S* __restrict__ scores,
                          const int4* __restrict__ pieces, int64_t n_pieces,
                          FastDiv chunks, const uint8_t* __restrict__ mask,
                          S* __restrict__ out, float* __restrict__ part,
                          const int32_t* __restrict__ fix_rows,
                          const int32_t* __restrict__ fix_ptr, int64_t n_fix,
                          int32_t* __restrict__ tickets, int k) {
  using P = Pack<S, VEC>;
  constexpr int kTilePacks = kTileBytes / static_cast<int>(sizeof(P));
  __shared__ P tile[kTilePacks];
  __shared__ uint8_t tile_mask[MASKED ? kTilePacks : 1];
  // Blocks take the list from its end, so the padded tail's pieces (the
  // last row's) run first and their merge overlaps the rest of the launch.
  const int64_t first_item =
      static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kThreads;
  const int64_t n_items = n_pieces * chunks.d;
  const int64_t item = first_item + threadIdx.x;
  const bool live = item < n_items;  // no return: the block loads together
  // The block's run of slots, from its first piece's to its last piece's.
  const int64_t last_item =
      (n_items - first_item < kThreads ? n_items : first_item + kThreads) - 1;
  const int32_t run_lo =
      pieces[fast_div(chunks, static_cast<uint32_t>(first_item))].y;
  const int32_t run_hi =
      pieces[fast_div(chunks, static_cast<uint32_t>(last_item))].z;
  int4 pc = make_int4(0, 0, 0, -1);
  uint32_t c = 0;
  if (live) {
    const uint32_t p = fast_div(chunks, static_cast<uint32_t>(item));
    c = static_cast<uint32_t>(item) - p * chunks.d;
    pc = pieces[p];
  }
  const int64_t col = static_cast<int64_t>(c) * VEC;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = -INFINITY;
  const int tile_slots = kTilePacks / static_cast<int>(chunks.d);
  for (int32_t t0 = run_lo; t0 < run_hi; t0 += tile_slots) {
    const int n_slots = run_hi - t0 < tile_slots ? run_hi - t0 : tile_slots;
    const int n_packs = n_slots * static_cast<int>(chunks.d);
    __syncthreads();  // the previous tile is read out
    const P* src = reinterpret_cast<const P*>(scores) +
                   static_cast<int64_t>(t0) * chunks.d;
    for (int j = threadIdx.x; j < n_packs; j += kThreads) {
      copy_async<sizeof(P)>(shared_u32(tile + j), src + j);
    }
    if constexpr (MASKED) {
      for (int j = threadIdx.x; j < n_slots; j += kThreads) {
        tile_mask[j] = mask[t0 + j];
      }
    }
    copy_commit();
    copy_wait<0>();
    __syncthreads();
    const int32_t lo = pc.y > t0 ? pc.y : t0;
    const int32_t hi = pc.z < t0 + n_slots ? pc.z : t0 + n_slots;
    for (int32_t e = lo; e < hi; ++e) {
      if constexpr (MASKED) {
        if (tile_mask[e - t0] == 0) continue;
      }
      const P v = tile[static_cast<int64_t>(e - t0) * chunks.d + c];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        acc[i] = fmaxf(acc[i], Cvt<S>::to_f(v.v[i]));
      }
    }
  }

  bool last = false;  // this thread drew its split row's last ticket
  int32_t split = 0;
  const int32_t row = pc.x;
  if (live) {
    if (pc.w < 0) {  // the whole row
      store_pack<S, VEC>(out + static_cast<int64_t>(row) * k + col, acc);
    } else {  // a share of a split row, then the row's ticket for this pack
      store_pack<float, VEC>(part + static_cast<int64_t>(pc.w) * k + col,
                             acc);
      split = static_cast<int32_t>(find_split_row(fix_rows, n_fix, row));
      last = take_ticket(tickets + static_cast<int64_t>(split) * chunks.d +
                         c) == fix_ptr[split + 1] - fix_ptr[split] - 1;
    }
  }

  // The warp merges each row whose last ticket one of its lanes drew: every
  // lane loads shares 32 apart, then a butterfly max. The lane that drew the
  // ticket acquired the other pieces' shares; the warp barrier passes them
  // on to its lanes.
  unsigned todo = __ballot_sync(0xffffffffu, last);
  if (todo == 0) return;
  __syncwarp();
  const int lane = threadIdx.x & 31;
  while (todo != 0) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const int32_t s_k = __shfl_sync(0xffffffffu, split, src);
    const uint32_t c_k = __shfl_sync(0xffffffffu, c, src);
    const int64_t col_k = static_cast<int64_t>(c_k) * VEC;
    const int32_t first = fix_ptr[s_k], stop = fix_ptr[s_k + 1];
    float mx[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) mx[i] = -INFINITY;
    for (int32_t s0 = first + lane; s0 < stop; s0 += 32 * kSharesInFlight) {
      float v[kSharesInFlight][VEC];
#pragma unroll
      for (int u = 0; u < kSharesInFlight; ++u) {
        const int32_t sh = s0 + 32 * u;
        if (sh < stop) {
          load_share<VEC>(v[u], part + static_cast<int64_t>(sh) * k + col_k);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) v[u][i] = -INFINITY;
        }
      }
#pragma unroll
      for (int u = 0; u < kSharesInFlight; ++u) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) mx[i] = fmaxf(mx[i], v[u][i]);
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
      }
    }
    if (lane == src) {
      store_pack<S, VEC>(out + static_cast<int64_t>(row) * k + col_k, mx);
      tickets[static_cast<int64_t>(s_k) * chunks.d + c_k] = 0;
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

// The narrow kernel over a work list, in parts of fewer than 2^31 items.
template <typename S, int VEC>
void launch_narrow(const void* scores, const int4* pieces, int64_t n_pieces,
                   const uint8_t* mask, void* out, float* part,
                   const int32_t* fix_rows, const int32_t* fix_ptr,
                   int64_t n_fix, int32_t* tickets, int k,
                   cudaStream_t stream) {
  const int64_t chunks = k / VEC;
  const FastDiv q = make_fast_div(static_cast<uint32_t>(chunks));
  const int64_t step = ((static_cast<int64_t>(1) << 31) - 1) / chunks;
  const auto kernel = mask == nullptr
                          ? &segment_max_sorted_kernel<S, VEC, false>
                          : &segment_max_sorted_kernel<S, VEC, true>;
  for (int64_t p0 = 0; p0 < n_pieces; p0 += step) {
    const int64_t n = n_pieces - p0 < step ? n_pieces - p0 : step;
    const unsigned blocks =
        static_cast<unsigned>((n * chunks + kThreads - 1) / kThreads);
    kernel<<<blocks, kThreads, 0, stream>>>(
        static_cast<const S*>(scores), pieces + p0, n, q, mask,
        static_cast<S*>(out), part, fix_rows, fix_ptr, n_fix, tickets, k);
  }
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
// row-major, k * the element size at most kTileBytes (a slot fits a tile).
// mask: [n_slots] bytes, null when every slot counts. pieces
// [n_pieces, 4] int32 (row, first slot, end slot, share row or -1), 16-byte
// aligned, cover every row of [0, n_rows) and each of its slots once; the
// n_fix rows fix_rows split into several pieces take the max of their
// shares fix_ptr[s] .. fix_ptr[s + 1] in the f32 scratch part [*, k],
// merged in the same launch; tickets: n_fix * k int32 zeros, left at zero.
int kgt_segment_max_sorted(const void* scores, const int32_t* pieces,
                           int64_t n_pieces, const uint8_t* mask, void* out,
                           float* part, const int32_t* fix_rows,
                           const int32_t* fix_ptr, int64_t n_fix,
                           int32_t* tickets, int64_t n_rows, int k,
                           int is_bf16, void* stream) {
  if (scores == nullptr || out == nullptr || pieces == nullptr ||
      reinterpret_cast<uintptr_t>(pieces) % 16 != 0 || n_rows <= 0 ||
      k <= 0 || k * (is_bf16 ? 2 : 4) > kTileBytes || n_pieces < n_rows ||
      n_fix < 0 ||
      (n_fix > 0 && (part == nullptr || fix_rows == nullptr ||
                     fix_ptr == nullptr || tickets == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The widest pack that divides K and keeps the scores' rows, the output's
  // (as an f32 array's) and the shares' aligned to it.
  int vec = pick_wide_vec(k, is_bf16 ? 2 : 4, scores, out);
  while (vec > 1 && part != nullptr && !aligned_to(part, vec * 4)) vec /= 2;
  const int4* work = reinterpret_cast<const int4*>(pieces);
#define KGT_NARROW(S, V)                                                   \
  launch_narrow<S, V>(scores, work, n_pieces, mask, out, part, fix_rows,   \
                      fix_ptr, n_fix, tickets, k, s)
  KGT_WIDE_DISPATCH(is_bf16, vec, KGT_NARROW)
#undef KGT_NARROW
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
