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
//                          (+ merge_split_stats, recv_pieces.cuh)
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
// The backward is bound by bytes too: the [E, D] stream of hj in and the
// [E, D] write of d_pre out. Its predecessor, edge-parallel over (slot,
// head) items, read recv[e] and then ht[recv[e]] for every slot and took
// the time of its bound for re-reading that row from device memory on every
// slot (PERF.md). It walks the same pieces as the score kernel, save that a
// row longer than one piece (the padded tail, a hub) comes in pieces of 8
// slots (sddmm_cuda.BWD_SPLIT_PIECE) that run side by side: at CiteSeer's
// shapes the tail's 32-slot chains set the walk's time. A fixed grid of
// groups strides over the (piece, head) items with its head (and a wide
// head's slab) held constant, holds the head's columns of att for the whole
// grid and of the piece's receiver row ht[r] for the whole piece, stages
// the piece's ds values in shared memory (cp.async, the group's lanes
// together), and streams the piece's contiguous hj rows through a ring of
// kBwdRing stages (PackRing). Each slot's d_pre is its own, so the lanes of
// a group store their packs straight from registers (the groups of a warp,
// the heads of one piece, store whole lines) and a split row needs no
// merge: the pieces serve only to read ht[r] once a piece. datt is a sum
// over every slot: a group keeps its columns' partial in f32 registers
// across its pieces; at the end the block sums its groups' partials in
// group order into one row per block, and a second small kernel sums those
// rows in a fixed order (reduce_partials, lanes.cuh). No atomics, so datt
// is bit-reproducible. Padded slots are computed like any other: their ds
// is 0 (alpha is 0 there), so they add nothing to d_pre or datt.
//
// The statistics kernel computes the fused forward (attend.cu's K9) minus
// its aggregation, so it walks K9's work the same way: the pieces of
// spmm_cuda.recv_bwd_work(row_ptr) (at most 32 slots of one row, every row
// at least one piece), a fixed grid of groups striding over the (piece,
// head) items with the head held constant and the next piece's header read
// a piece ahead. A group stages its piece's senders and validity flags in
// shared memory (stage_piece), keeps the sender rows of the next kRing
// slots in flight in a cp.async ring (ring_start / ring_next; all three in
// recv_pieces.cuh, shared with attend.cu) and never gathers a padded slot;
// it holds its head's columns of the receiver row ht[r] and of att in
// registers for the piece, folds the piece's scores in slot order with
// online_step, keeps them in the piece table's unused keep column and
// writes them at the piece's end, the group's lanes together. A piece that
// is its whole row stores the row's (m, l); a split row's pieces leave
// their (m_p, l_p) in f32 scratch, and a second launch merges them in
// piece order with the forward's merge (merge_split_stats, which K5 also
// takes). Every score here is gatv2_score (lanes.cuh), the function
// attend.cu's kernels use, in the same lane layout, and the statistics
// step and merge are the forward's: the score kernel's scores equal the
// one-pass forward's on hj = ht[senders], and the statistics kernel's
// scores, m and l equal the forward's on every row, bit for bit. Bound by
// bytes in principle (the node rows, the index and validity streams, the
// [E, H] score write), it issues per-slot arithmetic and shuffles like K9
// (PERF.md). Its predecessor gave a group to each (row, head) and walked
// the row serially, one dependent chain a slot (index, gather, score), so
// the padded tail, which prepare_graph puts in the last row (351 slots at
// arxiv), and any hub were single long chains that set its time, and a
// padded slot was gathered and scored before it became -inf.
//
// A head wider than 256 columns (lanes.cuh) runs its own instantiation
// (WIDE): the score kernels compute each score over the head's slabs in
// order (gatv2_score_wide, the function attend.cu's wide kernels use; the
// score kernel's wide groups read their rows from device memory, no ring),
// the backward gives each group one slab, since its work is per column, and
// streams that slab through its ring as a narrow group streams its head.
//
// Offsets into data are 64-bit; indices are int32. The C entry points
// launch on the given stream, allocate nothing, do not synchronise, and
// return cudaGetLastError().

#include "lanes.cuh"
#include "recv_pieces.cuh"

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

// pieces[p] = (row, first slot, end slot, share): at most `cap` slots of one
// receiver row; share -1 where the piece is its whole row, else its row of
// m_part / l_part ([shares, heads]), which merge_split_stats combines.
template <typename S, int VEC, int NJ, bool WIDE>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
sddmm_stats_kernel(const S* __restrict__ ht,
                   const int32_t* __restrict__ senders,
                   const int4* __restrict__ pieces, int64_t n_pieces, int cap,
                   const void* __restrict__ att, int att_bf16,
                   const uint8_t* __restrict__ valid,
                   float* __restrict__ scores, float* __restrict__ m_out,
                   float* __restrict__ l_out, float* __restrict__ m_part,
                   float* __restrict__ l_part, int heads, int f, int lph,
                   float slope) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Geometry q = geometry(lph);
  // One group per (piece, head), a wide one walking the head's slabs for
  // each score; the grid holds a multiple of heads groups, so a group that
  // strides over the pairs by the grid's size keeps its head.
  const int64_t n_groups =
      static_cast<int64_t>(gridDim.x) * (kThreads / lph);
  const int64_t n_items = n_pieces * heads;
  const int h = static_cast<int>(q.gid % heads);
  const int64_t d = static_cast<int64_t>(heads) * f;
  const int64_t col0 = static_cast<int64_t>(h) * f;
  // The table's keep column holds the piece's scores: there is no keep.
  const PieceTable t =
      piece_table(smem, SenderRing<S, VEC, NJ>::kBytes, lph, cap);

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
    float m = -INFINITY, l = 0.0f;

    if constexpr (WIDE) {
      // Rows from device memory, slab by slab for each score (no ring).
      for (int64_t e = lo; e < lo + n; ++e) {
        float s = -INFINITY;
        if (valid == nullptr || valid[e] != 0) {  // never gather a padded slot
          s = gatv2_score_wide<S, VEC, NJ>(
              ht + row * d + col0,
              ht + static_cast<int64_t>(senders[e]) * d + col0, att, att_bf16,
              col0, f, slope, q);
          if (s > -INFINITY) {  // the same on every lane of the group
            float p;
            online_step(s, m, l, p);
          }
        }
        if (q.lane == 0) scores[e * heads + h] = s;
      }
    } else {
      // The piece's senders and validity land while the receiver's row is
      // read; then the ring keeps the next kRing sender rows in flight.
      stage_piece<true>(t, lo, n, senders, nullptr, valid, nullptr, 0, heads,
                        h, q);
      float hi_row[NJ][VEC];
      load_lane<S, VEC, NJ>(ht + row * d + col0, f, q, hi_row);
      piece_landed(q);
      ring_start<S, VEC, NJ>(smem, t, n, ht, d, col0, f, q);
      int stage = 0;
      for (int j = 0; j < n; ++j) {
        copy_wait<kRing - 1>();
        float s = -INFINITY;
        if (t.flag[j] != -INFINITY) {
          float hj[NJ][VEC];
          SenderRing<S, VEC, NJ>::read(smem, stage, f, q, hj);
          s = gatv2_score<VEC, NJ>(hi_row, hj, a, slope, lph, q.mask);
          if (s > -INFINITY) {  // the same on every lane of the group
            float p;
            online_step(s, m, l, p);
          }
        }
        if (q.lane == 0) t.keep[j] = s;
        stage = ring_next<S, VEC, NJ>(smem, t, j, n, stage, ht, d, col0, f,
                                      q);
      }
      // The piece's scores, the group's lanes together: the groups of a
      // warp (the heads of one piece at arxiv's and CiteSeer's widths)
      // store whole lines. (Lane 0 storing each score as it is made, as the
      // fused forward does, measured 2% slower at arxiv's shapes, PERF.md.)
      __syncwarp(q.mask);  // the piece's scores are in shared memory
      for (int i = q.lane; i < n; i += lph) {
        scores[(lo + i) * heads + h] = t.keep[i];
      }
    }

    if (q.lane == 0) {
      if (pc.w < 0) {  // the whole row
        m_out[row * heads + h] = m > -INFINITY ? m : 0.0f;
        l_out[row * heads + h] = l;
      } else {  // a share of a split row; m is -inf where no score was finite
        m_part[static_cast<int64_t>(pc.w) * heads + h] = m;
        l_part[static_cast<int64_t>(pc.w) * heads + h] = l;
      }
    }
    pc = pc_next;
  }
}

// hj rows in flight per group; the backward's blocks per SM (76 registers,
// no spills; four a SM ran 4.6% slower at composed arxiv L1 on an NVIDIA
// H100 80GB HBM3 at 700 W, PERF.md); and its fixed grid in blocks a SM
// (blocks_for_fixed_grid): two waves of the blocks that run at once. The
// shared grid of 16 a SM ran 5.3 waves, and its partial last wave and its
// 2,112 partial rows cost 4% at arxiv L2; one wave (3 a SM) ran 1% slower
// at L1 (PERF.md).
constexpr int kBwdRing = 8;
constexpr int kBwdBlocksPerSm = 3;
constexpr int kBwdGridPerSm = 2 * kBwdBlocksPerSm;

template <typename S, int VEC, int NJ>
using BwdRing = PackRing<S, VEC, NJ, kBwdRing>;

// Dynamic shared memory of the backward: its groups' rings, then `cap` f32
// ds values a group. After the walk the rings hold the block's datt
// partials (kThreads * VEC * NJ f32, less than the rings' bytes).
template <typename S, int VEC, int NJ>
inline size_t bwd_smem(int lph, int cap) {
  return BwdRing<S, VEC, NJ>::kBytes +
         static_cast<size_t>(kThreads / lph) * cap * sizeof(float);
}

// pieces[p] = (row, first slot, end slot, share): at most `cap` slots of one
// receiver row (the share is not read: every slot's d_pre is its own).
// partial: one row of d f32 per block, the block's groups' datt partials.
template <typename S, int VEC, int NJ, bool WIDE>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSm)
sddmm_bwd_kernel(const S* __restrict__ ht, const S* __restrict__ hj,
                 const int4* __restrict__ pieces, int64_t n_pieces, int cap,
                 const void* __restrict__ att, int att_bf16,
                 const float* __restrict__ ds, S* __restrict__ d_pre,
                 float* __restrict__ partial, int heads, int f, int lph,
                 float slope) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Geometry q = geometry(lph);
  // The grid holds a multiple of heads * slabs groups, so a group that
  // strides over the (piece, head, slab) triples by the grid's size keeps
  // its head and slab.
  const int groups = kThreads / lph;
  const int64_t n_groups = static_cast<int64_t>(gridDim.x) * groups;
  const int64_t per_row = static_cast<int64_t>(heads) * head_slabs<WIDE>(f);
  const int64_t n_items = n_pieces * per_row;
  const Item mine = fixed_grid_item<WIDE>(q.gid, heads, f);
  const int h = mine.h;
  const int fk = mine.fk;
  const int64_t col0 = mine.col0;
  const int64_t d = static_cast<int64_t>(heads) * f;
  float* tab = reinterpret_cast<float*>(smem + BwdRing<S, VEC, NJ>::kBytes) +
               static_cast<int64_t>(threadIdx.x / lph) * cap;

  float a[NJ][VEC], acc[NJ][VEC];
  load_att<VEC, NJ>(att, att_bf16, col0, fk, q, a);
  zero_lane<VEC, NJ>(acc);

  int4 pc = make_int4(0, 0, 0, -1);
  if (q.gid < n_items) pc = pieces[q.gid / per_row];
  for (int64_t item = q.gid; item < n_items; item += n_groups) {
    // The next piece's header is read a piece ahead.
    int4 pc_next = make_int4(0, 0, 0, -1);
    if (item + n_groups < n_items) pc_next = pieces[(item + n_groups) / per_row];
    const int64_t lo = pc.y;
    const int n = pc.z - pc.y;
    if (n > 0) {  // an empty row has nothing to read or write
      const S* hj_piece = hj + lo * d + col0;  // slot lo + j at + j * d
      S* out = d_pre + lo * d + col0;
      // The piece's ds values of this head, the group's lanes together, as
      // the oldest copy group; then slot j's row into stage j % kBwdRing,
      // one commit group a slot (empty past the piece's end); the receiver's
      // row is read meanwhile.
      __syncwarp(q.mask);  // the previous piece's values are read out
      for (int i = q.lane; i < n; i += lph) {
        copy_async<4>(shared_u32(tab + i), ds + (lo + i) * heads + h);
      }
      copy_commit();
#pragma unroll
      for (int k = 0; k < kBwdRing; ++k) {
        if (k < n) BwdRing<S, VEC, NJ>::fill(smem, k, hj_piece + k * d, fk, q);
        copy_commit();
      }
      float hi_row[NJ][VEC];
      load_lane<S, VEC, NJ>(ht + static_cast<int64_t>(pc.x) * d + col0, fk, q,
                            hi_row);
      copy_wait<kBwdRing>();  // the ds values have landed
      __syncwarp(q.mask);     // every lane's share of them
      int stage = 0;
      for (int j = 0; j < n; ++j) {
        copy_wait<kBwdRing - 1>();  // slot j has landed in `stage`
        float row[NJ][VEC];
        BwdRing<S, VEC, NJ>::read(smem, stage, fk, q, row);
        const float g = tab[j];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float pre = hi_row[jj][i] + row[jj][i];
            const bool pos = pre > 0.0f;
            acc[jj][i] += (pos ? pre : slope * pre) * g;
            row[jj][i] = g * a[jj][i] * (pos ? 1.0f : slope);  // d_pre
          }
        }
        store_lane<S, VEC, NJ>(out + static_cast<int64_t>(j) * d, fk, q,
                               row);
        const int ahead = j + kBwdRing;
        if (ahead < n) {
          BwdRing<S, VEC, NJ>::fill(
              smem, stage, hj_piece + static_cast<int64_t>(ahead) * d, fk, q);
        }
        copy_commit();
        stage = stage + 1 == kBwdRing ? 0 : stage + 1;
      }
    }
    pc = pc_next;
  }

  // datt: the block's groups' partials, summed column by column in group
  // order into the block's row of partial.
  copy_wait<0>();
  __syncthreads();  // every ring is read out
  float* buf = reinterpret_cast<float*>(smem);  // [thread][pack][value]
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      buf[(threadIdx.x * NJ + jj) * VEC + i] = acc[jj][i];
    }
  }
  __syncthreads();
  const int64_t first = static_cast<int64_t>(blockIdx.x) * groups;
  for (int64_t c = threadIdx.x; c < d; c += kThreads) {
    // Column c is (head hc, slab k, column cc of the slab); the block's
    // groups that own it are g = g0, g0 + per_row, ... (item_of's order).
    const int hc = static_cast<int>(c / f);
    const int ch = static_cast<int>(c - static_cast<int64_t>(hc) * f);
    const int k = WIDE ? ch / kSlab : 0;
    const int cc = ch - k * kSlab;
    const int64_t r = static_cast<int64_t>(k) * heads + hc;
    const int pack = cc / VEC;
    const int t = pack % lph;
    const int at = ((t * NJ) + pack / lph) * VEC + (cc - pack * VEC);
    float sum = 0.0f;
    for (int64_t g = (r - first % per_row + per_row) % per_row; g < groups;
         g += per_row) {
      sum += buf[g * lph * NJ * VEC + at];
    }
    partial[static_cast<int64_t>(blockIdx.x) * d + c] = sum;
  }
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
// valid) and m, l [n_rows, heads] f32 over the receiver-sorted stream; the
// sender rows ht[senders[e]] are read in the kernel. ht f32 (is_bf16 = 0) or
// bf16; att by its own flag. pieces [n_pieces, 4] int32 (row, first slot,
// end slot, share row or -1), each of at most cap slots, cover every row and
// every slot once; the n_fix rows fix_rows split into several pieces take
// their m, l from their shares fix_ptr[k] .. fix_ptr[k + 1] of the f32
// scratch m_part, l_part [*, heads], written before they are read. Two
// launches when a row is split, else one.
int kgt_sddmm_stats_sorted(const void* ht, const int32_t* senders,
                           const int32_t* pieces, int64_t n_pieces, int cap,
                           const void* att, int att_bf16,
                           const uint8_t* valid, float* scores, float* m,
                           float* l, float* m_part, float* l_part,
                           const int32_t* fix_rows, const int32_t* fix_ptr,
                           int64_t n_fix, int64_t n_rows, int heads,
                           int64_t f, float slope, int is_bf16,
                           void* stream) {
  if (ht == nullptr || senders == nullptr || att == nullptr ||
      scores == nullptr || m == nullptr || l == nullptr ||
      !shape_ok(n_rows, heads, f) ||
      !pieces_ok(pieces, n_pieces, n_rows, cap, n_fix,
                 m_part != nullptr && l_part != nullptr &&
                     fix_rows != nullptr && fix_ptr != nullptr,
                 heads, f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lay = pick_layout(f, is_bf16 ? 2 : 4, ht, ht, ht, ht);
  const unsigned grid = blocks_for_fixed_grid(n_pieces, heads, lay.lph);
  const int fi = static_cast<int>(f);
  const int4* work = reinterpret_cast<const int4*>(pieces);
#define KGT_STATS(S)                                                        \
  {                                                                         \
    const cudaError_t err = launch_pieces(                                  \
        sddmm_stats_kernel<S, VEC, NJ, WIDE>, grid,                         \
        piece_smem<S, VEC, NJ, WIDE>(lay.lph, cap), s,                      \
        static_cast<const S*>(ht), senders, work, n_pieces, cap, att,       \
        att_bf16, valid, scores, m, l, m_part, l_part, heads, fi, lay.lph,  \
        slope);                                                             \
    if (err != cudaSuccess) return static_cast<int>(err);                   \
  }
  KGT_DISPATCH(is_bf16, lay, KGT_STATS)
#undef KGT_STATS
  return static_cast<int>(
      merge_split_stats(m_part, l_part, fix_rows, fix_ptr, n_fix, heads, m, l,
                        s));
}

// Rows of the [rows, heads*f] f32 scratch that the backward needs for its
// datt partials on the current device over n_pieces pieces, for the same
// data pointers (their alignment decides the layout, and the layout the
// grid): one per block; 0 for a shape it does not take.
int64_t kgt_sddmm_bwd_partial_rows(const void* ht, const void* hj,
                                   const void* d_pre, int64_t n_pieces,
                                   int heads, int64_t f, int is_bf16) {
  if (!shape_ok(n_pieces, heads, f)) return 0;
  const Layout lay = pick_layout(f, is_bf16 ? 2 : 4, ht, hj, d_pre, d_pre);
  return blocks_for_fixed_grid(n_pieces, heads * lay.slabs, lay.lph,
                               kBwdGridPerSm);
}

// Backward: d_pre [n_slots, heads*f] in the data's type, datt [heads*f] f32,
// from ds [n_slots, heads] f32. ht [n_rows, heads*f], hj and d_pre [n_slots,
// heads*f]: f32 (is_bf16 = 0) or bf16; att [heads, f] by its own flag.
// pieces as for kgt_sddmm_scores_sorted. partial: scratch of
// kgt_sddmm_bwd_partial_rows(..., n_pieces, ...) rows, written before it is
// read.
int kgt_sddmm_bwd_sorted(const void* ht, const void* hj, const int32_t* pieces,
                         int64_t n_pieces, int cap, const void* att,
                         int att_bf16, const float* ds, void* d_pre,
                         float* datt, float* partial, int64_t n_rows,
                         int heads, int64_t f, float slope, int is_bf16,
                         void* stream) {
  if (ht == nullptr || hj == nullptr || pieces == nullptr || att == nullptr ||
      ds == nullptr || d_pre == nullptr || datt == nullptr ||
      partial == nullptr || n_rows <= 0 || n_pieces < n_rows || cap < 1 ||
      cap > 1024 || reinterpret_cast<uintptr_t>(pieces) % 16 != 0 ||
      !shape_ok(n_pieces, heads, f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lay = pick_layout(f, is_bf16 ? 2 : 4, ht, hj, d_pre, d_pre);
  const unsigned grid = blocks_for_fixed_grid(
      n_pieces, heads * lay.slabs, lay.lph, kBwdGridPerSm);
  const int fi = static_cast<int>(f);
  const int4* work = reinterpret_cast<const int4*>(pieces);
#define KGT_BWD(S)                                                          \
  {                                                                         \
    auto kernel = sddmm_bwd_kernel<S, VEC, NJ, WIDE>;                       \
    const size_t smem = bwd_smem<S, VEC, NJ>(lay.lph, cap);                 \
    if (smem > 48 * 1024) {                                                 \
      const cudaError_t attr = cudaFuncSetAttribute(                        \
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,              \
          static_cast<int>(smem));                                          \
      if (attr != cudaSuccess) return static_cast<int>(attr);               \
    }                                                                       \
    kernel<<<grid, kThreads, smem, s>>>(                                    \
        static_cast<const S*>(ht), static_cast<const S*>(hj), work,         \
        n_pieces, cap, att, att_bf16, ds, static_cast<S*>(d_pre), partial,  \
        heads, fi, lay.lph, slope);                                         \
  }
  KGT_DISPATCH(is_bf16, lay, KGT_BWD)
#undef KGT_BWD
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return static_cast<int>(first);
  return static_cast<int>(reduce_partials(
      partial, datt, grid, static_cast<int64_t>(heads) * f, s));
}

const char* kgt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
