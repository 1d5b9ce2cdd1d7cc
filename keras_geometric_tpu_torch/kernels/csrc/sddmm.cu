// GATv2 attention scores for Hopper (sm_90a): the score kernel and its
// backward over a receiver-sorted edge stream with the gathered sender rows
// materialised (the composed path), and the score-and-statistics kernel,
// which gathers the sender rows itself (the first half of the two-pass
// forward).
//
// They replace three TPU kernels of the JAX package:
//   sddmm_scores_kernel <- kernels/sddmm_pallas.py sddmm_scores_sorted
//   sddmm_bwd_kernel    <- kernels/sddmm_pallas.py sddmm_bwd_sorted
//   sddmm_stats_kernel  <- kernels/sddmm_pallas.py sddmm_stats_sorted
//
// With ht [N, D] the transformed node rows (D = H*F, head h owns columns
// h*F .. (h+1)*F), hj [E, D] the sender rows in slot order, att [H, F], and
// for slot e with receiver r = recv[e]:
//   pre[e]   = ht[r] + hj[e]
//   z[e]     = pre > 0 ? pre : slope * pre
//   s[e, h]  = sum_f att[h, f] * z[e, h, f]                  (f32)
// backward, from ds [E, H] f32:
//   d_pre[e, hF+f] = ds[e, h] * att[h, f] * (pre > 0 ? 1 : slope)
//                                           (stored in hj's type)
//   datt[h, f]     = sum over ALL slots of z[e, hF+f] * ds[e, h]
//                                           (f32 sum, cast by the caller)
// d_pre is the cotangent of both endpoints (pre is symmetric in hi and hj):
// the caller returns it as d hj and scatters it by receiver for d ht.
// statistics, with hj[e] = ht[senders[e]] read in the kernel: the scores
// (-inf on invalid slots) and per receiver row m = the row's max score (0
// for a row without a finite one) and l = sum exp(s - m).
//
// The TPU kernels expand the receiver rows with one-hot matrix products over
// a boundary-encoded work list and reduce each head through a block-diagonal
// selector matrix, because that machine has no vector gather. Here a sub-warp
// group (lanes.cuh) owns one head's columns and works in f32 registers.
//
// The score kernel is bound by bytes: the [E, D] stream of hj is most of
// what it moves, the work a few multiply-adds per (slot, column). A group
// per (slot, head) that reads recv[e], then ht[recv[e]] and hj[e], reduces
// and exits exposes about two memory latencies per item and left it at 46%
// / 30% of its bound at arxiv's shapes on the H100 (PERF.md). So it walks the
// pieces of the receiver-sorted stream (spmm_cuda.recv_bwd_work(row_ptr),
// at most 32 slots of one row, the list the attention kernels walk): a
// fixed grid of groups strides over the (piece, head) items with its head
// held constant, reads the next piece's header a piece ahead, holds its
// head's columns of the piece's receiver row ht[r] and of att in registers
// for the whole piece, and streams the piece's hj rows, which are contiguous
// in slot order, through a ring of kScoreRing stages in shared memory
// (cp.async, one commit group a slot; PackRing in lanes.cuh), computing the
// scores of kScoreBatch slots at once so that their dependent chains overlap
// (on the H100 two slots at a time ran 6-7% faster than one at CiteSeer's
// shapes, where the 32-slot pieces of the padded tail row set the time, and
// as fast at arxiv's; four were 2-4% slower at arxiv's; PERF.md). It keeps the
// piece's scores in shared memory and writes them at the end, the group's
// lanes together, so that the groups of a warp (the heads of one piece at
// arxiv's and CiteSeer's widths) store whole lines. No slot's score depends
// on another's, so a split row needs no merge.
//
// The backward is edge-parallel: it runs a fixed grid whose groups stride
// over the (slot, head) pairs with their head held constant, read the head's
// F-segment of ht[recv[e]] (neighbouring slots share a receiver, so the row
// comes from L1/L2) and of hj[e], keep their datt partial in registers and
// write it once; a second small kernel sums the partials in a fixed order.
// No atomics, so datt is bit-reproducible. Padded slots are computed like
// any other: their ds is 0 (alpha is 0 there), so they add nothing to d_pre
// or datt. It moves the [E, D] stream of hj and the [E, D] write of d_pre.
//
// The statistics kernel is row-parallel like attend.cu's forward: a group
// per (receiver row, head) walks the row's slots, gathers each sender row and
// keeps the online (m, l) in registers; it moves the node rows, the index
// and validity streams and the [E, H] score write, and is bound by bytes.
// Every score here is gatv2_score (lanes.cuh), the function attend.cu's
// kernels use, in the same lane layout, and the statistics step is
// online_step, the forward's: the score kernel's scores equal the one-pass
// forward's on hj = ht[senders], and the statistics kernel's scores, m and l
// equal the forward's, bit for bit.
//
// A head wider than 256 columns (lanes.cuh) runs its own instantiation
// (WIDE): the score kernels compute each score over the head's slabs in
// order (gatv2_score_wide, the function attend.cu's wide kernels use; the
// score kernel's wide groups read their rows from device memory, no ring),
// the backward gives each group one slab, since its work is per column.
//
// Offsets into data are 64-bit; indices are int32. The C entry points
// launch on the given stream, allocate nothing, do not synchronise, and
// return cudaGetLastError().

#include "lanes.cuh"

namespace {

constexpr int kScoreRing = 8;   // hj rows in flight per group
constexpr int kScoreBatch = 2;  // slots whose scores a group computes at once
static_assert(kScoreRing % kScoreBatch == 0, "a batch never wraps the ring");

template <typename S, int VEC, int NJ>
using HjRing = PackRing<S, VEC, NJ, kScoreRing>;

// Dynamic shared memory of the score kernel: its groups' rings (none for a
// wide launch), then `cap` f32 scores a group.
template <typename S, int VEC, int NJ, bool WIDE>
inline size_t score_smem(int lph, int cap) {
  return (WIDE ? 0 : HjRing<S, VEC, NJ>::kBytes) +
         static_cast<size_t>(kThreads / lph) * cap * sizeof(float);
}

// pieces[p] = (row, first slot, end slot, share): at most `cap` slots of one
// receiver row (the share is not read: every slot's score is its own).
template <typename S, int VEC, int NJ, bool WIDE>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
sddmm_scores_kernel(const S* __restrict__ ht, const S* __restrict__ hj,
                    const int4* __restrict__ pieces, int64_t n_pieces,
                    int cap, const void* __restrict__ att, int att_bf16,
                    float* __restrict__ scores, int heads, int f, int lph,
                    float slope) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Geometry q = geometry(lph);
  // The grid holds a multiple of heads groups, so a group that strides over
  // the (piece, head) pairs by the grid's size keeps its head.
  const int64_t n_groups =
      static_cast<int64_t>(gridDim.x) * (kThreads / lph);
  const int64_t n_items = n_pieces * heads;
  const int h = static_cast<int>(q.gid % heads);
  const int64_t d = static_cast<int64_t>(heads) * f;
  const int64_t col0 = static_cast<int64_t>(h) * f;
  float* sc = reinterpret_cast<float*>(
                  smem + (WIDE ? 0 : HjRing<S, VEC, NJ>::kBytes)) +
              static_cast<int64_t>(threadIdx.x / lph) * cap;

  float a[NJ][VEC];
  if constexpr (!WIDE) load_att<VEC, NJ>(att, att_bf16, col0, f, q, a);

  int4 pc = make_int4(0, 0, 0, -1);
  if (q.gid < n_items) pc = pieces[q.gid / heads];
  for (int64_t item = q.gid; item < n_items; item += n_groups) {
    // The next piece's header is read a piece ahead.
    int4 pc_next = make_int4(0, 0, 0, -1);
    if (item + n_groups < n_items) pc_next = pieces[(item + n_groups) / heads];
    const int64_t row = pc.x;
    const int64_t lo = pc.y;
    const int n = pc.z - pc.y;
    const S* hi = ht + row * d + col0;
    const S* hj_head = hj + lo * d + col0;  // slot lo + j at hj_head + j * d

    if constexpr (WIDE) {
      for (int j = 0; j < n; ++j) {
        const float s = gatv2_score_wide<S, VEC, NJ>(
            hi, hj_head + j * d, att, att_bf16, col0, f, slope, q);
        if (q.lane == 0) sc[j] = s;
      }
    } else {
      // Slot j's row lands in stage j % kScoreRing, one commit group a slot
      // (empty past the piece's end); the receiver's row is read meanwhile.
#pragma unroll
      for (int k = 0; k < kScoreRing; ++k) {
        if (k < n) HjRing<S, VEC, NJ>::fill(smem, k, hj_head + k * d, f, q);
        copy_commit();
      }
      float hi_row[NJ][VEC];
      load_lane<S, VEC, NJ>(hi, f, q, hi_row);
      // kScoreBatch slots at a time: their scores are independent chains
      // (loads, arithmetic, butterfly) that the warp interleaves; a batch
      // past the piece's end computes on stale stages and stores nothing.
      int stage = 0;
      for (int j = 0; j < n; j += kScoreBatch) {
        copy_wait<kScoreRing - kScoreBatch>();  // slots j .. j + batch - 1
        float s[kScoreBatch];
#pragma unroll
        for (int u = 0; u < kScoreBatch; ++u) {
          float hj_row[NJ][VEC];
          HjRing<S, VEC, NJ>::read(smem, stage + u, f, q, hj_row);
          s[u] = gatv2_score<VEC, NJ>(hi_row, hj_row, a, slope, lph, q.mask);
        }
#pragma unroll
        for (int u = 0; u < kScoreBatch; ++u) {
          if (q.lane == 0 && j + u < n) sc[j + u] = s[u];
          const int ahead = j + u + kScoreRing;
          if (ahead < n) {
            HjRing<S, VEC, NJ>::fill(smem, stage + u, hj_head + ahead * d, f,
                                     q);
          }
          copy_commit();
        }
        stage = stage + kScoreBatch == kScoreRing ? 0 : stage + kScoreBatch;
      }
    }
    __syncwarp(q.mask);  // the piece's scores are in shared memory
    for (int i = q.lane; i < n; i += lph) scores[(lo + i) * heads + h] = sc[i];
    __syncwarp(q.mask);  // and read out before the next piece writes them
    pc = pc_next;
  }
}

template <typename S, int VEC, int NJ, bool WIDE>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
sddmm_stats_kernel(const S* __restrict__ ht,
                   const int32_t* __restrict__ senders,
                   const int32_t* __restrict__ row_ptr,
                   const void* __restrict__ att, int att_bf16,
                   const uint8_t* __restrict__ valid,
                   float* __restrict__ scores, float* __restrict__ m_out,
                   float* __restrict__ l_out, int64_t n_rows, int heads,
                   int f, int lph, float slope) {
  const Geometry q = geometry(lph);
  if (q.gid >= n_rows * heads) return;
  const int64_t row = q.gid / heads;
  const int h = static_cast<int>(q.gid - row * heads);
  const int64_t d = static_cast<int64_t>(heads) * f;
  const int64_t col0 = static_cast<int64_t>(h) * f;

  float hi_row[NJ][VEC], a[NJ][VEC];
  if constexpr (!WIDE) {
    load_lane<S, VEC, NJ>(ht + row * d + col0, f, q, hi_row);
    load_att<VEC, NJ>(att, att_bf16, col0, f, q, a);
  }
  float m = -INFINITY, l = 0.0f;

  const int64_t hi = row_ptr[row + 1];
  for (int64_t e = row_ptr[row]; e < hi; ++e) {
    const S* sender = ht + static_cast<int64_t>(senders[e]) * d + col0;
    float part;
    if constexpr (WIDE) {
      part = gatv2_score_wide<S, VEC, NJ>(ht + row * d + col0, sender, att,
                                          att_bf16, col0, f, slope, q);
    } else {
      float hj[NJ][VEC];
      load_lane<S, VEC, NJ>(sender, f, q, hj);
      part = gatv2_score<VEC, NJ>(hi_row, hj, a, slope, lph, q.mask);
    }
    const float s =
        (valid == nullptr || valid[e] != 0) ? part : -INFINITY;
    if (q.lane == 0) scores[e * heads + h] = s;
    if (s > -INFINITY) {  // the same on every lane of the group
      float p;
      online_step(s, m, l, p);
    }
  }
  if (q.lane == 0) {
    m_out[row * heads + h] = m > -INFINITY ? m : 0.0f;
    l_out[row * heads + h] = l;
  }
}

template <typename S, int VEC, int NJ, bool WIDE>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
sddmm_bwd_kernel(const S* __restrict__ ht, const S* __restrict__ hj,
                 const int32_t* __restrict__ recv,
                 const void* __restrict__ att, int att_bf16,
                 const float* __restrict__ ds, S* __restrict__ d_pre,
                 float* __restrict__ partial, int64_t n_slots, int heads,
                 int f, int lph, float slope) {
  const Geometry q = geometry(lph);
  // The grid holds a multiple of heads * slabs groups, so a group that
  // strides over the (slot, head, slab) triples by the grid's size keeps its
  // head and slab: every column's work is its own, so a wide head needs no
  // more than its slab.
  const int64_t n_groups =
      static_cast<int64_t>(gridDim.x) * (kThreads / lph);
  const int64_t per_slot =
      static_cast<int64_t>(heads) * head_slabs<WIDE>(f);
  const Item mine = fixed_grid_item<WIDE>(q.gid, heads, f);
  const int h = mine.h;
  const int fk = mine.fk;
  const int64_t col0 = mine.col0;
  const int64_t d = static_cast<int64_t>(heads) * f;

  float a[NJ][VEC], datt_acc[NJ][VEC];
  load_att<VEC, NJ>(att, att_bf16, col0, fk, q, a);
  zero_lane<VEC, NJ>(datt_acc);

  for (int64_t item = q.gid; item < n_slots * per_slot; item += n_groups) {
    const int64_t e = item / per_slot;
    float hi_row[NJ][VEC], row[NJ][VEC];
    load_lane<S, VEC, NJ>(ht + static_cast<int64_t>(recv[e]) * d + col0, fk,
                          q, hi_row);
    load_lane<S, VEC, NJ>(hj + e * d + col0, fk, q, row);
    const float g = WIDE ? ds[e * heads + h] : ds[item];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float pre = hi_row[j][i] + row[j][i];
        const bool pos = pre > 0.0f;
        datt_acc[j][i] += (pos ? pre : slope * pre) * g;
        row[j][i] = g * a[j][i] * (pos ? 1.0f : slope);  // this lane's d_pre
      }
    }
    store_lane<S, VEC, NJ>(d_pre + e * d + col0, fk, q, row);
  }
  store_partial<VEC, NJ>(partial, per_slot, d, col0, fk, q, datt_acc);
}

}  // namespace

extern "C" {

// Scores [n_slots, heads] f32. ht [n_rows, heads*f] and hj [n_slots,
// heads*f]: both f32 (is_bf16 = 0) or both bf16; att [heads, f] f32 or bf16
// by its own flag. pieces [n_pieces, 4] int32 (row, first slot, end slot,
// share), 16-byte aligned, each of at most cap slots of one row of ht, cover
// every slot once (row_ptr[0] == 0 and row_ptr[n_rows] == n_slots).
int kgt_sddmm_scores_sorted(const void* ht, const void* hj,
                            const int32_t* pieces, int64_t n_pieces, int cap,
                            const void* att, int att_bf16, float* scores,
                            int64_t n_rows, int heads, int64_t f, float slope,
                            int is_bf16, void* stream) {
  if (ht == nullptr || hj == nullptr || pieces == nullptr || att == nullptr ||
      scores == nullptr || n_rows <= 0 || n_pieces < n_rows || cap < 1 ||
      cap > 1024 || reinterpret_cast<uintptr_t>(pieces) % 16 != 0 ||
      !shape_ok(n_pieces, heads, f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lay = pick_layout(f, is_bf16 ? 2 : 4, ht, hj, ht, hj);
  const unsigned grid = blocks_for_fixed_grid(n_pieces, heads, lay.lph);
  const int fi = static_cast<int>(f);
  const int4* work = reinterpret_cast<const int4*>(pieces);
#define KGT_SCORES(S)                                                       \
  {                                                                         \
    auto kernel = sddmm_scores_kernel<S, VEC, NJ, WIDE>;                    \
    const size_t smem = score_smem<S, VEC, NJ, WIDE>(lay.lph, cap);         \
    if (smem > 48 * 1024) {                                                 \
      const cudaError_t attr = cudaFuncSetAttribute(                        \
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,              \
          static_cast<int>(smem));                                          \
      if (attr != cudaSuccess) return static_cast<int>(attr);               \
    }                                                                       \
    kernel<<<grid, kThreads, smem, s>>>(                                    \
        static_cast<const S*>(ht), static_cast<const S*>(hj), work,         \
        n_pieces, cap, att, att_bf16, scores, heads, fi, lay.lph, slope);   \
  }
  KGT_DISPATCH(is_bf16, lay, KGT_SCORES)
#undef KGT_SCORES
  return static_cast<int>(cudaGetLastError());
}

// Scores [n_slots, heads] f32 (-inf where valid[e] == 0; valid null: all
// valid) and m, l [n_rows, heads] f32 over the receiver-sorted stream
// (row_ptr [n_rows + 1]); the sender rows ht[senders[e]] are read in the
// kernel. ht f32 (is_bf16 = 0) or bf16; att by its own flag.
int kgt_sddmm_stats_sorted(const void* ht, const int32_t* senders,
                           const int32_t* row_ptr, const void* att,
                           int att_bf16, const uint8_t* valid, float* scores,
                           float* m, float* l, int64_t n_rows, int heads,
                           int64_t f, float slope, int is_bf16,
                           void* stream) {
  if (ht == nullptr || senders == nullptr || row_ptr == nullptr ||
      att == nullptr || scores == nullptr || m == nullptr || l == nullptr ||
      !shape_ok(n_rows, heads, f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lay = pick_layout(f, is_bf16 ? 2 : 4, ht, ht, ht, ht);
  const unsigned grid = blocks_for_all(n_rows, heads, lay.lph);
  const int fi = static_cast<int>(f);
#define KGT_STATS(S)                                                        \
  sddmm_stats_kernel<S, VEC, NJ, WIDE><<<grid, kThreads, 0, s>>>(            \
      static_cast<const S*>(ht), senders, row_ptr, att, att_bf16, valid,    \
      scores, m, l, n_rows, heads, fi, lay.lph, slope)
  KGT_DISPATCH(is_bf16, lay, KGT_STATS)
#undef KGT_STATS
  return static_cast<int>(cudaGetLastError());
}

// Rows of the [rows, heads*f] f32 scratch that the backward needs for its
// datt partials on the current device, for the same data pointers (their
// alignment decides the layout, and the layout the number of groups); 0 for
// a shape it does not take.
int64_t kgt_sddmm_bwd_partial_rows(const void* ht, const void* hj,
                                   const void* d_pre, int64_t n_slots,
                                   int heads, int64_t f, int is_bf16) {
  if (!shape_ok(n_slots, heads, f)) return 0;
  const Layout lay = pick_layout(f, is_bf16 ? 2 : 4, ht, hj, d_pre, d_pre);
  return partial_rows(n_slots, heads * lay.slabs, lay.lph);
}

// Backward: d_pre [n_slots, heads*f] in the data's type, datt [heads*f] f32,
// from ds [n_slots, heads] f32. partial: scratch of
// kgt_sddmm_bwd_partial_rows(...) rows, written before it is read.
int kgt_sddmm_bwd_sorted(const void* ht, const void* hj, const int32_t* recv,
                         const void* att, int att_bf16, const float* ds,
                         void* d_pre, float* datt, float* partial,
                         int64_t n_slots, int heads, int64_t f, float slope,
                         int is_bf16, void* stream) {
  if (ht == nullptr || hj == nullptr || recv == nullptr || att == nullptr ||
      ds == nullptr || d_pre == nullptr || datt == nullptr ||
      partial == nullptr || !shape_ok(n_slots, heads, f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lay = pick_layout(f, is_bf16 ? 2 : 4, ht, hj, d_pre, d_pre);
  const unsigned grid =
      blocks_for_fixed_grid(n_slots, heads * lay.slabs, lay.lph);
  const int64_t p_rows = partial_rows(n_slots, heads * lay.slabs, lay.lph);
  const int fi = static_cast<int>(f);
#define KGT_BWD(S)                                                          \
  sddmm_bwd_kernel<S, VEC, NJ, WIDE><<<grid, kThreads, 0, s>>>(              \
      static_cast<const S*>(ht), static_cast<const S*>(hj), recv, att,      \
      att_bf16, ds, static_cast<S*>(d_pre), partial, n_slots, heads, fi,    \
      lay.lph, slope)
  KGT_DISPATCH(is_bf16, lay, KGT_BWD)
#undef KGT_BWD
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return static_cast<int>(first);
  return static_cast<int>(
      reduce_partials(partial, datt, p_rows, static_cast<int64_t>(heads) * f,
                      s));
}

const char* kgt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
