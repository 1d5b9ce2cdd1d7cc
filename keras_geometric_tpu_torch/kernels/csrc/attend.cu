// Fused GATv2 attention kernels for Hopper (sm_90a): the one-pass forward,
// the aggregation from cached scores, rho, the receiver-side backward and the
// sender-side backward, over CSR edge streams.
//
// They replace five TPU kernels of the JAX package:
//   sddmm_stats_agg_kernel  <- kernels/sddmm_pallas.py  sddmm_stats_agg_sorted
//   attend_aggregate_kernel <- kernels/attend_pallas.py attend_aggregate_sorted
//   attend_rho_kernel       <- kernels/attend_pallas.py attend_rho_sorted
//   attend_recv_bwd_kernel  <- kernels/attend_pallas.py attend_recv_bwd_full_sorted
//   attend_send_bwd_kernel  <- kernels/attend_pallas.py attend_send_bwd_sorted
//
// With ht [N, D] the transformed node rows (D = H*F, head h owns columns
// h*F .. (h+1)*F), att [H, F], and for edge slot e of receiver row r with
// sender j = senders[e]:
//   pre[e]   = ht[r] + ht[j]
//   z[e]     = pre > 0 ? pre : slope * pre
//   s[e, h]  = sum_f att[h, f] * z[e, h, f]        (-inf where valid[e] == 0)
//   alpha    = exp(s - m[r, h]) / (l[r, h] + eps)  with m the row's max score
//                                                  and l = sum exp(s - m)
// forward : out[r] = sum_e alpha[e] * keep[e] * ht[j]  (keep scales the
//           numerator only), m, l [N, H] f32 and, unless told not to, the
//           scores [E, H] f32; m is stored as 0 for a row that saw no finite
//           score.
// aggregate: the same out from cached scores, m and l (the second half of
//           the two-pass forward; sddmm.cu's score-and-statistics kernel is
//           the first).
// rho     : rho[r, h] = sum_e alpha * keep * dalpha,
//           dalpha[e, h] = sum_f g[r, h, f] * ht[j, h, f]
// backward: ds = alpha * (keep * dalpha - rho[r]),
//           d_pre[e] = ds * att * (pre > 0 ? 1 : slope),
//           dht[r]   = sum_e d_pre[e]           (receiver part of d ht)
//           v[e]     = alpha * keep * g[r] + d_pre[e]   (sender cotangent)
//           datt[h, f] = sum over ALL edges of z[e, h, f] * ds[e, h]
// sender  : dht_send[j] = sum over the slots e whose sender is j of v[e],
//           recomputed in sender-sorted order (no [E, D] v in memory).
//
// Modes: without the score cache the forward writes no scores (a null
// pointer) and rho and the receiver backward recompute s from ht[r], ht[j]
// and att (gatv2_score in lanes.cuh, the function the forward used, so s is
// the forward's bit for bit, and exp(min(s - m, 0)) is exact); the receiver
// backward writes v only when given one (the permute finish) and not when
// the sender backward finishes. The recompute is a template parameter of rho
// and the receiver backward, and so is writing v in the receiver backward,
// not runtime branches: as a runtime branch the recompute's extra registers
// cost the cached launches blocks in flight (rho 60 registers instead of 40,
// 31% slower; the receiver backward 3-7% slower, measured on the H100), and
// with v the receiver backward runs best at two blocks per SM, without it at
// three. The other flags are runtime branches.
//
// The TPU kernels take the gathered rows hj = ht[senders] (and, sender-side,
// g[recv], ht[recv] and the receivers' statistics) as [E, *] inputs and
// build everything from one-hot matrix products over a boundary-encoded work
// list, because that machine has no vector gather. Here the rows are
// gathered inside each kernel, so no [E, D] gather ever exists in device
// memory, and the work is a few multiply-adds per (edge, column): by bytes
// and operations every kernel here is bound by bytes (the node arrays, the
// index, score and mask streams, and for the permute backward the [E, D]
// write of v).
//
// Design: a group of `lph` lanes (a power of two, at most a warp) owns one
// head's columns, keeps its running sums in f32 registers (the forward: the
// running max, normaliser and output columns, the flash-attention
// recurrence), and reduces over the head's F columns with shuffles inside
// the group. How a head's columns are laid over the group's lanes in packs
// of up to 16 bytes is set out in lanes.cuh, with the helpers this file
// shares with sddmm.cu. At F = 64 in bf16 a head takes 8 lanes and a warp
// four heads, so wide packs keep several heads busy with each operation a
// warp issues.
// The forward, the aggregation, rho and the receiver backward walk pieces:
// a host-built work list (attend_cuda.recv_bwd_work, one per row_ptr
// tensor) cuts every row into pieces of at most 32 slots, and a fixed grid
// of groups strides over the (piece, head) items with its head held
// constant, reading the next piece's header a piece ahead. So no group walks a long row serially (the
// padded tail, which prepare_graph puts in the last row, or a hub). A group
// copies its piece's senders, scores (or validity) and keep factors into
// shared memory in one go (cp.async, stage_piece), then keeps the sender
// rows of the next kRing slots in flight in a shared-memory ring (cp.async,
// one commit group a slot, ring_start / ring_next); a padded slot is never
// gathered. A piece that is its whole row stores its row's results as a
// row walk would; the pieces of a split row leave f32 partials in scratch,
// and a second launch combines them in piece order (no atomics): the
// forward's per-piece (m, l, o) by the flash-decoding merge, the
// aggregation's, rho's and dht's shares by a sum. The per-slot arithmetic,
// not the walk's latency, bounds these kernels at arxiv's shapes (PERF.md):
// the forward, the aggregation and rho run at four blocks per SM, the
// receiver backward at two or three.
// The sender backward walks the pieces of the sender-sorted stream (the
// list of row_ptr_bwd): a group stages its piece's receivers (-1 for a padded
// slot), keep factors and the receivers' (m, l, rho) of its head in shared
// memory, and keeps both of each slot's receiver rows, ht[r] and g[r], in
// flight in two rings; a split sender row's f32 shares of d ht are added in
// piece order by its second launch. So neither a hub sender nor the padded
// tail, which in sender order piles into the last row, is walked serially,
// and a padded slot costs one validity read. The aggregation from cached
// scores stages its piece's scores as rho's flags, so a slot whose score is
// -inf is never gathered either, and adds each slot's w * ht[sender] with
// w = exp(s - m) / (l + eps) * keep: one exp and one division a slot, no
// score and no online rescale.
//
// Wide heads (F > 256, lanes.cuh): a launch of its own instantiation (WIDE)
// gives each group one 256-column slab of a (row or piece, head) pair. The
// scores, m and l, and dalpha, span the head: a wide group computes them by
// walking the head's slabs for each slot (gatv2_score_wide, head_dot_wide),
// so every slab's group of a piece runs the same online recurrence and the
// first slab's group writes the scores and statistics; the columns' own work
// (the output, d_pre, v, the datt partials) is per slab. rho has no column
// output: one group per (piece, head) walks the slabs. A wide group reads
// its rows from device memory (no ring, no staged table).
//
// No atomics anywhere. The one reduction that spans rows, datt, is done in
// two steps: the receiver backward's groups, which keep their head, each
// write their partial datt once, and its second launch sums the partials in
// a fixed order, so datt is bit-reproducible. Everything is accumulated
// in f32 and rounded once at the store. Offsets into data are 64-bit;
// indices and row pointers are int32. row_ptr[0] must be 0 and row_ptr[N]
// the slot count, so that every slot's score is written. The C entry points
// launch on the given stream, allocate nothing, do not synchronise, and
// return cudaGetLastError().

#include "cp_async.cuh"
#include "lanes.cuh"
#include "recv_pieces.cuh"

namespace {

// One edge slot of a row: this lane's columns of the sender's row and the
// slot's keep factor (1 without dropout).
template <typename S, int VEC, int NJ>
__device__ __forceinline__ float load_edge(
    const S* __restrict__ ht, const int32_t* __restrict__ senders,
    const void* __restrict__ drop, int drop_bf16, int64_t e, int64_t d,
    int64_t col0, int heads, int h, int f, const Geometry& q,
    float (&hj)[NJ][VEC]) {
  const int64_t src = senders[e];
  load_lane<S, VEC, NJ>(ht + src * d + col0, f, q, hj);
  return drop == nullptr ? 1.0f
                         : load_scalar(drop, drop_bf16, e * heads + h);
}

// sum over this lane's columns of a[.] * b[.]
template <int VEC, int NJ>
__device__ __forceinline__ float lane_dot(const float (&a)[NJ][VEC],
                                          const float (&b)[NJ][VEC]) {
  float part = 0.0f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) part += a[j][i] * b[j][i];
  }
  return part;
}

// The dot product of two rows over a wide head's F columns (a, b: their
// first column), slab by slab, then one butterfly.
template <typename S, int VEC, int NJ>
__device__ __forceinline__ float head_dot_wide(const S* __restrict__ a,
                                               const S* __restrict__ b,
                                               int f, const Geometry& q) {
  float part = 0.0f;
  for (int c = 0; c < f; c += kSlab) {
    const int fk = f - c < kSlab ? f - c : kSlab;
    float x[NJ][VEC], y[NJ][VEC];
    load_lane<S, VEC, NJ>(a + c, fk, q, x);
    load_lane<S, VEC, NJ>(b + c, fk, q, y);
    part += lane_dot<VEC, NJ>(x, y);
  }
  return group_sum(part, q.lph, q.mask);
}

// alpha of a wide head's slot e from its score: the cached one, or
// (RECOMPUTE) the one recomputed from the receiver's and the sender's
// columns (hi, hj: their first column of the head; hcol the head's first
// column of att), 0 on an invalid slot. exp(min(s - m, 0)) equals
// exp(s - m) for the forward's own s.
template <bool RECOMPUTE, typename S, int VEC, int NJ>
__device__ __forceinline__ float slot_alpha_wide(
    const float* __restrict__ scores, const uint8_t* __restrict__ valid,
    int64_t e, int heads, int h, const S* hi, const S* hj, const void* att,
    int att_bf16, int64_t hcol, int f, float slope, float m, float denom,
    const Geometry& q) {
  if constexpr (!RECOMPUTE) {
    return expf(scores[e * heads + h] - m) / denom;
  } else {
    if (valid != nullptr && valid[e] == 0) return 0.0f;
    const float s = gatv2_score_wide<S, VEC, NJ>(hi, hj, att, att_bf16, hcol,
                                                 f, slope, q);
    return expf(fminf(s - m, 0.0f)) / denom;
  }
}

// ---------------------------------------------------------------------------
// The shares of split rows. The piece walk itself (the work list, the staged
// piece table, the ring of sender rows, launch_pieces) is recv_pieces.cuh's,
// shared with sddmm.cu's score-and-statistics kernel.
// ---------------------------------------------------------------------------

// This lane's columns of a split row's f32 share (part: the share's first
// column of the group).
template <int VEC, int NJ>
__device__ __forceinline__ void store_share(float* part, int fk,
                                            const Geometry& q,
                                            const float (&v)[NJ][VEC]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = pack_column<VEC>(q, j);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if (c < fk) part[c + i] = v[j][i];
    }
  }
}

// Column c of split row k: its shares (rows fix_ptr[k] .. fix_ptr[k + 1] of
// part, `cols` wide) added in piece order. A hub row has hundreds of shares:
// the unrolled loop issues several shares' loads before their adds, which
// stay in order.
__device__ __forceinline__ float sum_shares(const float* __restrict__ part,
                                            int64_t cols,
                                            const int32_t* __restrict__ fix_ptr,
                                            int64_t k, int64_t c) {
  float acc = 0.0f;
#pragma unroll 8
  for (int32_t p = fix_ptr[k]; p < fix_ptr[k + 1]; ++p) {
    acc += part[static_cast<int64_t>(p) * cols + c];
  }
  return acc;
}

// The second launch of the aggregation and of the sender backward, one
// thread per (split row, column): its pieces' f32 shares added in piece
// order, rounded once.
template <typename S>
__global__ void __launch_bounds__(kThreads)
shares_finish_kernel(const float* __restrict__ part,
                     const int32_t* __restrict__ fix_rows,
                     const int32_t* __restrict__ fix_ptr, int64_t n_fix,
                     int64_t d, S* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_fix * d) return;
  const int64_t k = i / d;
  const int64_t c = i - k * d;
  out[static_cast<int64_t>(fix_rows[k]) * d + c] =
      Cvt<S>::from_f(sum_shares(part, d, fix_ptr, k, c));
}

// Blocks per SM the receiver backward is built for, by whether it writes v
// (NVIDIA H100 80GB HBM3 at 700 W, arxiv shapes, bf16 F = 64 / 40): writing
// v, two blocks and 108 registers without spills beat three blocks at 80
// registers with spills by 18% / 2%; without v three blocks win by 9% /
// 11%. The forward and rho take kMinBlocksPerSm (four, 64 registers): on
// the same card and shapes four blocks beat three (80 registers, no
// spills) by 8% / 11% in the forward and the recomputing rho despite about
// 116 bytes of spills, five (48 registers) lost by 2x, and the cached rho
// ran within 2% at three, four or five.
constexpr int recv_bwd_min_blocks(bool emit_v) { return emit_v ? 2 : 3; }

// ---------------------------------------------------------------------------
// The forward
// ---------------------------------------------------------------------------

// Folds a finite score s into a piece's running max m and normaliser l and
// its output columns o, the sender's columns hj weighted by p * keep
// (dropout scales the numerator only).
template <int VEC, int NJ>
__device__ __forceinline__ void fold_slot(float s, float keep,
                                          const float (&hj)[NJ][VEC],
                                          float& m, float& l,
                                          float (&o)[NJ][VEC]) {
  float p;
  const float scale = online_step(s, m, l, p);
  const float pk = p * keep;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[j][i] = o[j][i] * scale + pk * hj[j][i];
  }
}

template <typename S, int VEC, int NJ, bool WIDE>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
sddmm_stats_agg_kernel(const S* __restrict__ ht,
                       const int32_t* __restrict__ senders,
                       const int4* __restrict__ pieces, int64_t n_pieces,
                       int cap, const void* __restrict__ att, int att_bf16,
                       const uint8_t* __restrict__ valid,
                       const void* __restrict__ drop, int drop_bf16,
                       S* __restrict__ out, float* __restrict__ scores,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       float* __restrict__ m_part, float* __restrict__ l_part,
                       float* __restrict__ o_part, int heads, int f, int lph,
                       float slope, float eps) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Geometry q = geometry(lph);
  // The grid holds a multiple of heads * slabs groups, so a group that
  // strides over the (piece, head, slab) triples by the grid's size keeps
  // its head and slab.
  const int64_t n_groups =
      static_cast<int64_t>(gridDim.x) * (kThreads / lph);
  const int64_t per_row = static_cast<int64_t>(heads) * head_slabs<WIDE>(f);
  const int64_t n_items = n_pieces * per_row;
  const Item mine = fixed_grid_item<WIDE>(q.gid, heads, f);
  const int h = mine.h;
  const int fk = mine.fk;
  const int64_t d = static_cast<int64_t>(heads) * f;
  const int64_t col0 = mine.col0;  // this group's columns: col0 .. col0 + fk
  const int64_t hcol = static_cast<int64_t>(h) * f;  // the head's first
  // The group of a wide head's first slab writes the scores and statistics;
  // every slab's group runs the same recurrence over the same scores.
  const bool lead = q.lane == 0 && (!WIDE || col0 == hcol);
  const PieceTable t =
      piece_table(smem, SenderRing<S, VEC, NJ>::kBytes, lph, cap);

  float a[NJ][VEC];
  if constexpr (!WIDE) load_att<VEC, NJ>(att, att_bf16, col0, fk, q, a);

  int4 pc = make_int4(0, 0, 0, -1);
  if (q.gid < n_items) pc = pieces[q.gid / per_row];
  for (int64_t item = q.gid; item < n_items; item += n_groups) {
    // The next piece's header is read a piece ahead.
    int4 pc_next = make_int4(0, 0, 0, -1);
    if (item + n_groups < n_items) pc_next = pieces[(item + n_groups) / per_row];
    const int64_t row = pc.x;
    const int64_t lo = pc.y;
    const int n = pc.z - pc.y;
    float o[NJ][VEC];
    zero_lane<VEC, NJ>(o);
    float m = -INFINITY, l = 0.0f;

    if constexpr (WIDE) {
      // Rows from device memory, slab by slab for each score (no ring).
      for (int64_t e = lo; e < lo + n; ++e) {
        const int64_t src = senders[e];  // read beside the slot's flag
        float s = -INFINITY;
        if (valid == nullptr || valid[e] != 0) {  // never gather a padded slot
          float hj[NJ][VEC];
          load_lane<S, VEC, NJ>(ht + src * d + col0, fk, q, hj);
          const float keep = drop == nullptr
                                 ? 1.0f
                                 : load_scalar(drop, drop_bf16, e * heads + h);
          s = gatv2_score_wide<S, VEC, NJ>(ht + row * d + hcol,
                                           ht + src * d + hcol, att, att_bf16,
                                           hcol, f, slope, q);
          if (s > -INFINITY) fold_slot<VEC, NJ>(s, keep, hj, m, l, o);
        }
        if (scores != nullptr && lead) scores[e * heads + h] = s;
      }
    } else {
      // The piece's senders, validity and keep factors land while the
      // receiver's row is read.
      stage_piece<true>(t, lo, n, senders, nullptr, valid, drop, drop_bf16,
                        heads, h, q);
      float hi_row[NJ][VEC];
      load_lane<S, VEC, NJ>(ht + row * d + col0, fk, q, hi_row);
      piece_landed(q);
      ring_start<S, VEC, NJ>(smem, t, n, ht, d, col0, fk, q);
      int stage = 0;
      for (int j = 0; j < n; ++j) {
        copy_wait<kRing - 1>();
        float s = -INFINITY;
        if (t.flag[j] != -INFINITY) {
          float hj[NJ][VEC];
          SenderRing<S, VEC, NJ>::read(smem, stage, fk, q, hj);
          s = gatv2_score<VEC, NJ>(hi_row, hj, a, slope, lph, q.mask);
          if (s > -INFINITY) {  // the same on every lane of the group
            const float keep = drop == nullptr ? 1.0f : t.keep[j];
            fold_slot<VEC, NJ>(s, keep, hj, m, l, o);
          }
        }
        if (scores != nullptr && lead) scores[(lo + j) * heads + h] = s;
        stage =
            ring_next<S, VEC, NJ>(smem, t, j, n, stage, ht, d, col0, fk, q);
      }
    }

    if (pc.w < 0) {  // the whole row: its statistics and output
      if (lead) {
        m_out[row * heads + h] = m > -INFINITY ? m : 0.0f;
        l_out[row * heads + h] = l;
      }
      const float denom = l + eps;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) o[j][i] /= denom;
      }
      store_lane<S, VEC, NJ>(out + row * d + col0, fk, q, o);
    } else {  // a share of a split row; m is -inf where no score was finite
      if (lead) {
        m_part[static_cast<int64_t>(pc.w) * heads + h] = m;
        l_part[static_cast<int64_t>(pc.w) * heads + h] = l;
      }
      store_share<VEC, NJ>(o_part + static_cast<int64_t>(pc.w) * d + col0,
                           fk, q, o);
    }
    pc = pc_next;
  }
}

// The forward's second launch, one thread per (split row, column): the
// row's m, l and output from its pieces' (m_p, l_p, o_p) in piece order, the
// flash-decoding merge: m = max m_p over the pieces that saw a finite score
// (stored as 0 where none did), l = sum l_p exp(m_p - m), o = sum o_p
// exp(m_p - m), out = o / (l + eps) rounded once. A piece without a finite
// score is skipped, so a row whose finite scores lie in one piece gets what
// a walk of the whole row gives, bit for bit.
template <typename S>
__global__ void __launch_bounds__(kThreads)
agg_finish_kernel(const float* __restrict__ m_part,
                  const float* __restrict__ l_part,
                  const float* __restrict__ o_part,
                  const int32_t* __restrict__ fix_rows,
                  const int32_t* __restrict__ fix_ptr, int64_t n_fix,
                  int heads, int f, float eps, S* __restrict__ out,
                  float* __restrict__ m_out, float* __restrict__ l_out) {
  const int64_t d = static_cast<int64_t>(heads) * f;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_fix * d) return;
  const int64_t k = i / d;
  const int64_t c = i - k * d;
  const int h = static_cast<int>(c / f);
  float m = -INFINITY;
#pragma unroll 8
  for (int32_t p = fix_ptr[k]; p < fix_ptr[k + 1]; ++p) {
    m = fmaxf(m, m_part[static_cast<int64_t>(p) * heads + h]);
  }
  float l = 0.0f, o = 0.0f;
#pragma unroll 8
  for (int32_t p = fix_ptr[k]; p < fix_ptr[k + 1]; ++p) {
    const int64_t ph = static_cast<int64_t>(p) * heads + h;
    const float mp = m_part[ph];
    const float lp = l_part[ph];
    const float op = o_part[static_cast<int64_t>(p) * d + c];
    if (mp > -INFINITY) {  // a piece without a finite score is skipped
      const float w = expf(mp - m);
      l += lp * w;
      o += op * w;
    }
  }
  const int64_t row = fix_rows[k];
  if (c == static_cast<int64_t>(h) * f) {
    m_out[row * heads + h] = m > -INFINITY ? m : 0.0f;
    l_out[row * heads + h] = l;
  }
  out[row * d + c] = Cvt<S>::from_f(o / (l + eps));
}

// ---------------------------------------------------------------------------
// rho
// ---------------------------------------------------------------------------

template <typename S, int VEC, int NJ, bool RECOMPUTE, bool WIDE>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
attend_rho_kernel(const S* __restrict__ g, const S* __restrict__ ht,
                  const int32_t* __restrict__ senders,
                  const int4* __restrict__ pieces, int64_t n_pieces, int cap,
                  const float* __restrict__ scores,
                  const float* __restrict__ m_in,
                  const float* __restrict__ l_in,
                  const void* __restrict__ att, int att_bf16,
                  const uint8_t* __restrict__ valid,
                  const void* __restrict__ drop, int drop_bf16,
                  float* __restrict__ rho, float* __restrict__ rho_part,
                  int heads, int f, int lph, float slope, float eps) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Geometry q = geometry(lph);
  // One group per (piece, head), a wide one walking the head's slabs; the
  // grid holds a multiple of heads groups, so a group keeps its head.
  const int64_t n_groups =
      static_cast<int64_t>(gridDim.x) * (kThreads / lph);
  const int64_t n_items = n_pieces * heads;
  const int h = static_cast<int>(q.gid % heads);
  const int64_t d = static_cast<int64_t>(heads) * f;
  const int64_t col0 = static_cast<int64_t>(h) * f;
  const PieceTable t =
      piece_table(smem, SenderRing<S, VEC, NJ>::kBytes, lph, cap);

  // The receiver's columns and att only feed a recomputed score; the
  // cached instantiation never reads them.
  float a[NJ][VEC];
  if constexpr (!WIDE && RECOMPUTE) {
    load_att<VEC, NJ>(att, att_bf16, col0, f, q, a);
  }

  int4 pc = make_int4(0, 0, 0, -1);
  if (q.gid < n_items) pc = pieces[q.gid / heads];
  for (int64_t item = q.gid; item < n_items; item += n_groups) {
    int4 pc_next = make_int4(0, 0, 0, -1);  // read a piece ahead
    if (item + n_groups < n_items) pc_next = pieces[(item + n_groups) / heads];
    const int64_t row = pc.x;
    const int64_t lo = pc.y;
    const int n = pc.z - pc.y;
    const float m = m_in[row * heads + h];
    const float denom = l_in[row * heads + h] + eps;
    float acc = 0.0f;

    if constexpr (WIDE) {
      for (int64_t e = lo; e < lo + n; ++e) {
        const int64_t src = senders[e];  // read beside the slot's flag
        // A padded slot (invalid; with the cache, score -inf) is skipped
        // before its gather.
        if constexpr (RECOMPUTE) {
          if (valid != nullptr && valid[e] == 0) continue;
        } else {
          if (scores[e * heads + h] == -INFINITY) continue;
        }
        const S* hj = ht + src * d + col0;
        const float keep = drop == nullptr
                               ? 1.0f
                               : load_scalar(drop, drop_bf16, e * heads + h);
        const float dalpha =
            head_dot_wide<S, VEC, NJ>(g + row * d + col0, hj, f, q);
        const float alpha = slot_alpha_wide<RECOMPUTE, S, VEC, NJ>(
            scores, valid, e, heads, h, ht + row * d + col0, hj, att,
            att_bf16, col0, f, slope, m, denom, q);
        acc += alpha * keep * dalpha;
      }
    } else {
      // The piece's table lands while the receiver's rows are read.
      stage_piece<RECOMPUTE>(t, lo, n, senders, scores, valid, drop,
                             drop_bf16, heads, h, q);
      float g_row[NJ][VEC], hi_row[NJ][VEC];
      load_lane<S, VEC, NJ>(g + row * d + col0, f, q, g_row);
      if constexpr (RECOMPUTE) {
        load_lane<S, VEC, NJ>(ht + row * d + col0, f, q, hi_row);
      }
      piece_landed(q);
      ring_start<S, VEC, NJ>(smem, t, n, ht, d, col0, f, q);
      int stage = 0;
      for (int j = 0; j < n; ++j) {
        copy_wait<kRing - 1>();
        const float flag = t.flag[j];
        if (flag != -INFINITY) {  // else a padded slot: alpha is 0
          float hj[NJ][VEC];
          SenderRing<S, VEC, NJ>::read(smem, stage, f, q, hj);
          const float dalpha =
              group_sum(lane_dot<VEC, NJ>(g_row, hj), lph, q.mask);
          // The cached score, or the forward's recomputed bit for bit
          // (gatv2_score on the same lane layout).
          float alpha;
          if constexpr (RECOMPUTE) {
            const float sr =
                gatv2_score<VEC, NJ>(hi_row, hj, a, slope, lph, q.mask);
            alpha = expf(fminf(sr - m, 0.0f)) / denom;
          } else {
            alpha = expf(flag - m) / denom;
          }
          const float keep = drop == nullptr ? 1.0f : t.keep[j];
          acc += alpha * keep * dalpha;
        }
        stage =
            ring_next<S, VEC, NJ>(smem, t, j, n, stage, ht, d, col0, f, q);
      }
    }
    if (q.lane == 0) {
      if (pc.w < 0) {
        rho[row * heads + h] = acc;
      } else {
        rho_part[static_cast<int64_t>(pc.w) * heads + h] = acc;
      }
    }
    pc = pc_next;
  }
}

// rho's second launch, one thread per (split row, head): its pieces' shares
// added in piece order.
__global__ void __launch_bounds__(kThreads)
rho_finish_kernel(const float* __restrict__ rho_part,
                  const int32_t* __restrict__ fix_rows,
                  const int32_t* __restrict__ fix_ptr, int64_t n_fix,
                  int heads, float* __restrict__ rho) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_fix * heads) return;
  const int64_t k = i / heads;
  const int64_t h = i - k * heads;
  rho[static_cast<int64_t>(fix_rows[k]) * heads + h] =
      sum_shares(rho_part, heads, fix_ptr, k, h);
}

// ---------------------------------------------------------------------------
// The aggregation from cached scores
// ---------------------------------------------------------------------------

// Adds a slot's sender columns hj weighted by w to the output columns o, one
// fused multiply-add a column in slot order (what `o += w * hj` compiles to).
template <int VEC, int NJ>
__device__ __forceinline__ void add_weighted(float w,
                                             const float (&hj)[NJ][VEC],
                                             float (&o)[NJ][VEC]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[j][i] = fmaf(w, hj[j][i], o[j][i]);
  }
}

// One group per (piece, head, slab) of rho's work list: a slot whose cached
// score is finite adds w * ht[sender] with w = exp(s - m) / (l + eps) * keep,
// the slots of a piece in slot order. A piece that is its whole row stores
// it, rounded once (so such a row has a serial walk's bits); a piece of a
// split row stores its f32 share, and the second launch adds the shares in
// piece order (shares_finish_kernel).
template <typename S, int VEC, int NJ, bool WIDE>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
attend_aggregate_kernel(const float* __restrict__ scores,
                        const float* __restrict__ m_in,
                        const float* __restrict__ l_in,
                        const S* __restrict__ ht,
                        const int32_t* __restrict__ senders,
                        const int4* __restrict__ pieces, int64_t n_pieces,
                        int cap, const void* __restrict__ drop, int drop_bf16,
                        S* __restrict__ out, float* __restrict__ out_part,
                        int heads, int f, int lph, float eps) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Geometry q = geometry(lph);
  // The grid holds a multiple of heads * slabs groups, so a group that
  // strides over the (piece, head, slab) triples by the grid's size keeps
  // its head and slab.
  const int64_t n_groups =
      static_cast<int64_t>(gridDim.x) * (kThreads / lph);
  const int64_t per_row = static_cast<int64_t>(heads) * head_slabs<WIDE>(f);
  const int64_t n_items = n_pieces * per_row;
  const Item mine = fixed_grid_item<WIDE>(q.gid, heads, f);
  const int h = mine.h;
  const int fk = mine.fk;
  const int64_t d = static_cast<int64_t>(heads) * f;
  const int64_t col0 = mine.col0;
  const PieceTable t =
      piece_table(smem, SenderRing<S, VEC, NJ>::kBytes, lph, cap);

  int4 pc = make_int4(0, 0, 0, -1);
  if (q.gid < n_items) pc = pieces[q.gid / per_row];
  for (int64_t item = q.gid; item < n_items; item += n_groups) {
    int4 pc_next = make_int4(0, 0, 0, -1);  // read a piece ahead
    if (item + n_groups < n_items) pc_next = pieces[(item + n_groups) / per_row];
    const int64_t row = pc.x;
    const int64_t lo = pc.y;
    const int n = pc.z - pc.y;
    const float m = m_in[row * heads + h];
    const float denom = l_in[row * heads + h] + eps;
    float o[NJ][VEC];
    zero_lane<VEC, NJ>(o);

    if constexpr (WIDE) {
      // Rows from device memory, slab by slab (no ring).
      for (int64_t e = lo; e < lo + n; ++e) {
        const float s = scores[e * heads + h];
        if (!(s > -INFINITY)) continue;  // an invalid slot: alpha is 0
        float hj[NJ][VEC];
        const float keep = load_edge<S, VEC, NJ>(
            ht, senders, drop, drop_bf16, e, d, col0, heads, h, fk, q, hj);
        add_weighted<VEC, NJ>(expf(s - m) / denom * keep, hj, o);
      }
    } else {
      // The piece's senders, scores and keep factors land in one go; a
      // slot whose score is -inf is never gathered.
      stage_piece<false>(t, lo, n, senders, scores, nullptr, drop, drop_bf16,
                         heads, h, q);
      piece_landed(q);
      ring_start<S, VEC, NJ>(smem, t, n, ht, d, col0, fk, q);
      int stage = 0;
      for (int j = 0; j < n; ++j) {
        copy_wait<kRing - 1>();
        const float s = t.flag[j];
        if (s > -INFINITY) {
          float hj[NJ][VEC];
          SenderRing<S, VEC, NJ>::read(smem, stage, fk, q, hj);
          const float keep = drop == nullptr ? 1.0f : t.keep[j];
          add_weighted<VEC, NJ>(expf(s - m) / denom * keep, hj, o);
        }
        stage =
            ring_next<S, VEC, NJ>(smem, t, j, n, stage, ht, d, col0, fk, q);
      }
    }

    if (pc.w < 0) {  // the whole row
      store_lane<S, VEC, NJ>(out + row * d + col0, fk, q, o);
    } else {  // a share of a split row
      store_share<VEC, NJ>(out_part + static_cast<int64_t>(pc.w) * d + col0,
                           fk, q, o);
    }
    pc = pc_next;
  }
}

// ---------------------------------------------------------------------------
// The receiver backward
// ---------------------------------------------------------------------------

// d_pre of one column: rounded products that the compiler may not fuse into
// the sums that read d_pre, so that dht is the same bit for bit whether or
// not the instantiation also writes v (which reads d_pre too).
__device__ __forceinline__ float recv_d_pre(float ds, float a, bool pos,
                                            float slope) {
  return __fmul_rn(__fmul_rn(ds, a), pos ? 1.0f : slope);
}

template <typename S, int VEC, int NJ, bool RECOMPUTE, bool EMIT_V, bool WIDE>
__global__ void __launch_bounds__(kThreads, recv_bwd_min_blocks(EMIT_V))
attend_recv_bwd_kernel(const S* __restrict__ ht, const S* __restrict__ g,
                       const int32_t* __restrict__ senders,
                       const int4* __restrict__ pieces, int64_t n_pieces,
                       int cap, const void* __restrict__ att, int att_bf16,
                       const float* __restrict__ scores,
                       const float* __restrict__ m_in,
                       const float* __restrict__ l_in,
                       const float* __restrict__ rho,
                       const uint8_t* __restrict__ valid,
                       const void* __restrict__ drop, int drop_bf16,
                       S* __restrict__ dht, float* __restrict__ dht_part,
                       S* __restrict__ v, float* __restrict__ partial,
                       int heads, int f, int lph, float slope, float eps) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Geometry q = geometry(lph);
  // The grid holds a multiple of heads * slabs groups, so a group that
  // strides over the (piece, head, slab) triples by the grid's size keeps
  // its head and slab.
  const int64_t n_groups =
      static_cast<int64_t>(gridDim.x) * (kThreads / lph);
  const int64_t per_row = static_cast<int64_t>(heads) * head_slabs<WIDE>(f);
  const int64_t n_items = n_pieces * per_row;
  const Item mine = fixed_grid_item<WIDE>(q.gid, heads, f);
  const int h = mine.h;
  const int fk = mine.fk;
  const int64_t d = static_cast<int64_t>(heads) * f;
  const int64_t col0 = mine.col0;
  const int64_t hcol = static_cast<int64_t>(h) * f;
  const PieceTable t =
      piece_table(smem, SenderRing<S, VEC, NJ>::kBytes, lph, cap);

  float a[NJ][VEC], datt_acc[NJ][VEC];
  load_att<VEC, NJ>(att, att_bf16, col0, fk, q, a);
  zero_lane<VEC, NJ>(datt_acc);

  int4 pc = make_int4(0, 0, 0, -1);
  if (q.gid < n_items) pc = pieces[q.gid / per_row];
  for (int64_t item = q.gid; item < n_items; item += n_groups) {
    // The next piece's header is read a piece ahead.
    int4 pc_next = make_int4(0, 0, 0, -1);
    if (item + n_groups < n_items) pc_next = pieces[(item + n_groups) / per_row];
    const int64_t row = pc.x;
    const int64_t lo = pc.y;
    const int n = pc.z - pc.y;
    float acc[NJ][VEC];
    zero_lane<VEC, NJ>(acc);

    if constexpr (WIDE) {
      // A wide head reads its rows slab by slab for each slot, from device
      // memory (no ring).
      float hi_row[NJ][VEC], g_row[NJ][VEC];
      load_lane<S, VEC, NJ>(ht + row * d + col0, fk, q, hi_row);
      load_lane<S, VEC, NJ>(g + row * d + col0, fk, q, g_row);
      const float m = m_in[row * heads + h];
      const float denom = l_in[row * heads + h] + eps;
      const float rho_row = rho[row * heads + h];
      for (int64_t e = lo; e < lo + n; ++e) {
        float hj[NJ][VEC];
        const float keep = load_edge<S, VEC, NJ>(
            ht, senders, drop, drop_bf16, e, d, col0, heads, h, fk, q, hj);
        const S* hj_head = ht + static_cast<int64_t>(senders[e]) * d + hcol;
        const float dalpha =
            head_dot_wide<S, VEC, NJ>(g + row * d + hcol, hj_head, f, q);
        const float alpha = slot_alpha_wide<RECOMPUTE, S, VEC, NJ>(
            scores, valid, e, heads, h, ht + row * d + hcol, hj_head, att,
            att_bf16, hcol, f, slope, m, denom, q);
        const float ds = alpha * (keep * dalpha - rho_row);
        const float alpha_keep = alpha * keep;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float pre = hi_row[j][i] + hj[j][i];
            const bool pos = pre > 0.0f;
            const float d_pre = recv_d_pre(ds, a[j][i], pos, slope);
            acc[j][i] += d_pre;
            datt_acc[j][i] += (pos ? pre : slope * pre) * ds;
            hj[j][i] = alpha_keep * g_row[j][i] + d_pre;  // this lane's v
          }
        }
        if constexpr (EMIT_V) {
          store_lane<S, VEC, NJ>(v + e * d + col0, fk, q, hj);
        }
      }
    } else {
      // The piece's table lands while the receiver's rows are read.
      stage_piece<RECOMPUTE>(t, lo, n, senders, scores, valid, drop,
                             drop_bf16, heads, h, q);
      float hi_row[NJ][VEC], g_row[NJ][VEC];
      load_lane<S, VEC, NJ>(ht + row * d + col0, fk, q, hi_row);
      load_lane<S, VEC, NJ>(g + row * d + col0, fk, q, g_row);
      const float m = m_in[row * heads + h];
      const float denom = l_in[row * heads + h] + eps;
      const float rho_row = rho[row * heads + h];
      piece_landed(q);
      ring_start<S, VEC, NJ>(smem, t, n, ht, d, col0, fk, q);
      int stage = 0;
      for (int j = 0; j < n; ++j) {
        copy_wait<kRing - 1>();
        const float s = t.flag[j];
        const float keep = drop == nullptr ? 1.0f : t.keep[j];
        float hj[NJ][VEC];
        if (s != -INFINITY) {
          SenderRing<S, VEC, NJ>::read(smem, stage, fk, q, hj);
          const float dalpha =
              group_sum(lane_dot<VEC, NJ>(g_row, hj), lph, q.mask);
          // The cached score, or the forward's recomputed bit for bit
          // (gatv2_score on the same lane layout).
          float alpha;
          if constexpr (RECOMPUTE) {
            const float sr =
                gatv2_score<VEC, NJ>(hi_row, hj, a, slope, lph, q.mask);
            alpha = expf(fminf(sr - m, 0.0f)) / denom;
          } else {
            alpha = expf(s - m) / denom;
          }
          const float ds = alpha * (keep * dalpha - rho_row);
          const float alpha_keep = alpha * keep;
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
              const float pre = hi_row[jj][i] + hj[jj][i];
              const bool pos = pre > 0.0f;
              const float d_pre = recv_d_pre(ds, a[jj][i], pos, slope);
              acc[jj][i] += d_pre;
              datt_acc[jj][i] += (pos ? pre : slope * pre) * ds;
              hj[jj][i] = alpha_keep * g_row[jj][i] + d_pre;  // lane's v
            }
          }
        } else {
          zero_lane<VEC, NJ>(hj);  // a padded slot: v is 0
        }
        if constexpr (EMIT_V) {
          store_lane<S, VEC, NJ>(v + (lo + j) * d + col0, fk, q, hj);
        }
        stage =
            ring_next<S, VEC, NJ>(smem, t, j, n, stage, ht, d, col0, fk, q);
      }
    }
    if (pc.w < 0) {
      store_lane<S, VEC, NJ>(dht + row * d + col0, fk, q, acc);
    } else {
      store_share<VEC, NJ>(dht_part + static_cast<int64_t>(pc.w) * d + col0,
                           fk, q, acc);
    }
    pc = pc_next;
  }

  store_partial<VEC, NJ>(partial, per_row, d, col0, fk, q, datt_acc);
}

// The receiver backward's second launch: blocks 0 .. d-1 sum the datt
// partials in a fixed order (reduce_partials_kernel's work); the blocks
// after them give each split row its dht, the f32 shares of its pieces
// added in piece order and rounded once.
template <typename S>
__global__ void __launch_bounds__(kThreads)
recv_bwd_finish_kernel(const float* __restrict__ partial,
                       float* __restrict__ datt, int64_t p_rows, int64_t d,
                       const float* __restrict__ dht_part,
                       const int32_t* __restrict__ fix_rows,
                       const int32_t* __restrict__ fix_ptr, int64_t n_fix,
                       S* __restrict__ dht) {
  if (blockIdx.x < d) {
    reduce_partial_column(partial, datt, p_rows, d, blockIdx.x);
    return;
  }
  const int64_t i = (static_cast<int64_t>(blockIdx.x) - d) * kThreads +
                    threadIdx.x;
  if (i >= n_fix * d) return;
  const int64_t k = i / d;
  const int64_t c = i - k * d;
  dht[static_cast<int64_t>(fix_rows[k]) * d + c] =
      Cvt<S>::from_f(sum_shares(dht_part, d, fix_ptr, k, c));
}

// ---------------------------------------------------------------------------
// The sender backward
// ---------------------------------------------------------------------------

// Blocks per SM the sender backward is built for (NVIDIA H100 80GB HBM3 at
// 700 W, arxiv shapes, bf16 F = 64 / 40; PERF.md): three blocks (79
// registers, no spills) took 0.775 / 0.779 ms, two (87) 0.954 / 0.965, four
// (64, 104 bytes of spills) 1.144 / 1.002. Its ring holds two rows a slot,
// so shared memory allows at most four blocks at those widths anyway.
constexpr int kSendBwdMinBlocks = 3;

// The sender backward's piece table in shared memory, after the block's two
// rings: per slot the receiver (-1 for a padded slot), the keep factor, and
// the receiver's m, l and rho for the group's head, `cap` of each.
struct SendTable {
  int32_t* recv;
  float* keep;
  float* m;
  float* l;
  float* rho;
};

__device__ __forceinline__ SendTable send_table(uint8_t* smem, int ring_bytes,
                                                int lph, int cap) {
  int32_t* recv = reinterpret_cast<int32_t*>(smem + ring_bytes) +
                  static_cast<int64_t>(threadIdx.x / lph) * cap * 5;
  float* keep = reinterpret_cast<float*>(recv + cap);
  return SendTable{recv, keep, keep + cap, keep + 2 * cap, keep + 3 * cap};
}

// Dynamic shared memory of a sender-backward block: two rings (the
// receivers' ht and g rows), then its groups' tables (20 bytes a slot). A
// wide launch uses none.
template <typename S, int VEC, int NJ, bool WIDE>
inline size_t send_smem(int lph, int cap) {
  if constexpr (WIDE) {
    return 0;
  } else {
    return 2 * SenderRing<S, VEC, NJ>::kBytes +
           static_cast<size_t>(kThreads / lph) * cap * 20;
  }
}

// Stages the table of the piece of n slots from slot lo: each lane reads the
// receivers, validity and keep factors of its slots, then starts copying
// those receivers' (m, l, rho) of head h (one commit group). The caller's
// __syncwarp makes the receivers visible to the group; copy_wait and another
// __syncwarp the statistics.
__device__ __forceinline__ void stage_send_piece(
    const SendTable& t, int64_t lo, int n,
    const int32_t* __restrict__ receivers_ss,
    const float* __restrict__ valid_ss, const void* __restrict__ drop_ss,
    int drop_bf16, const float* __restrict__ m_in,
    const float* __restrict__ l_in, const float* __restrict__ rho,
    int heads, int h, const Geometry& q) {
  __syncwarp(q.mask);  // the previous piece's table is read out
  for (int i = q.lane; i < n; i += q.lph) {
    const int64_t e = lo + i;
    const bool ok = valid_ss == nullptr || valid_ss[e] != 0.0f;
    const int32_t r = receivers_ss[e];
    t.recv[i] = ok ? r : -1;
    if (drop_ss != nullptr) t.keep[i] = load_scalar(drop_ss, drop_bf16,
                                                    e * heads + h);
    if (ok) {  // a padded slot's statistics are never read
      const int64_t rh = static_cast<int64_t>(r) * heads + h;
      copy_async<4>(shared_u32(t.m + i), m_in + rh);
      copy_async<4>(shared_u32(t.l + i), l_in + rh);
      copy_async<4>(shared_u32(t.rho + i), rho + rh);
    }
  }
  copy_commit();
}

// The ring of the sender backward: slot j's receiver rows of ht and g land
// in stage j % kRing of the two rings, one commit group a slot, as
// ring_start / ring_next do it for one row; a padded slot is never copied.
template <typename S, int VEC, int NJ>
__device__ __forceinline__ void pair_fill(uint8_t* ring_ht, uint8_t* ring_g,
                                          int stage, int32_t r,
                                          const S* __restrict__ ht,
                                          const S* __restrict__ g, int64_t d,
                                          int64_t col0, int fk,
                                          const Geometry& q) {
  if (r >= 0) {
    const int64_t off = static_cast<int64_t>(r) * d + col0;
    SenderRing<S, VEC, NJ>::fill(ring_ht, stage, ht + off, fk, q);
    SenderRing<S, VEC, NJ>::fill(ring_g, stage, g + off, fk, q);
  }
  copy_commit();
}

template <typename S, int VEC, int NJ, bool WIDE>
__global__ void __launch_bounds__(kThreads, kSendBwdMinBlocks)
attend_send_bwd_kernel(const S* __restrict__ ht, const S* __restrict__ g,
                       const int32_t* __restrict__ receivers_ss,
                       const int4* __restrict__ pieces, int64_t n_pieces,
                       int cap, const void* __restrict__ att, int att_bf16,
                       const float* __restrict__ m_in,
                       const float* __restrict__ l_in,
                       const float* __restrict__ rho,
                       const float* __restrict__ valid_ss,
                       const void* __restrict__ drop_ss, int drop_bf16,
                       S* __restrict__ out, float* __restrict__ out_part,
                       int heads, int f, int lph, float slope, float eps) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Geometry q = geometry(lph);
  // The grid holds a multiple of heads * slabs groups, so a group that
  // strides over the (piece, head, slab) triples by the grid's size keeps
  // its head and slab.
  const int64_t n_groups =
      static_cast<int64_t>(gridDim.x) * (kThreads / lph);
  const int64_t per_row = static_cast<int64_t>(heads) * head_slabs<WIDE>(f);
  const int64_t n_items = n_pieces * per_row;
  const Item mine = fixed_grid_item<WIDE>(q.gid, heads, f);
  const int h = mine.h;
  const int fk = mine.fk;
  const int64_t d = static_cast<int64_t>(heads) * f;
  const int64_t col0 = mine.col0;
  const int64_t hcol = static_cast<int64_t>(h) * f;
  constexpr int kRingBytes = SenderRing<S, VEC, NJ>::kBytes;
  uint8_t* ring_ht = smem;
  uint8_t* ring_g = smem + kRingBytes;
  const SendTable t = send_table(smem, 2 * kRingBytes, lph, cap);

  float a[NJ][VEC];
  load_att<VEC, NJ>(att, att_bf16, col0, fk, q, a);

  int4 pc = make_int4(0, 0, 0, -1);
  if (q.gid < n_items) pc = pieces[q.gid / per_row];
  for (int64_t item = q.gid; item < n_items; item += n_groups) {
    // The next piece's header is read a piece ahead.
    int4 pc_next = make_int4(0, 0, 0, -1);
    if (item + n_groups < n_items) pc_next = pieces[(item + n_groups) / per_row];
    const int64_t row = pc.x;  // the sender
    const int64_t lo = pc.y;
    const int n = pc.z - pc.y;
    float hs[NJ][VEC], acc[NJ][VEC];
    zero_lane<VEC, NJ>(acc);

    if constexpr (WIDE) {
      // A wide head reads its rows slab by slab for each slot, from device
      // memory (no ring, no staged table).
      load_lane<S, VEC, NJ>(ht + row * d + col0, fk, q, hs);
      for (int64_t e = lo; e < lo + n; ++e) {
        if (valid_ss != nullptr && valid_ss[e] == 0.0f) continue;  // padded
        const int64_t r = receivers_ss[e];
        float hr[NJ][VEC], gr[NJ][VEC];
        load_lane<S, VEC, NJ>(ht + r * d + col0, fk, q, hr);
        load_lane<S, VEC, NJ>(g + r * d + col0, fk, q, gr);
        // The forward's score: receiver columns first, as it summed them.
        const float s = gatv2_score_wide<S, VEC, NJ>(
            ht + r * d + hcol, ht + row * d + hcol, att, att_bf16, hcol, f,
            slope, q);
        const int64_t rh = r * heads + h;
        const float alpha =
            expf(fminf(s - m_in[rh], 0.0f)) / (l_in[rh] + eps);
        const float keep =
            drop_ss == nullptr ? 1.0f
                               : load_scalar(drop_ss, drop_bf16, e * heads + h);
        const float dalpha = head_dot_wide<S, VEC, NJ>(
            g + r * d + hcol, ht + row * d + hcol, f, q);
        const float ds = alpha * (keep * dalpha - rho[rh]);
        const float alpha_keep = alpha * keep;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float pre = hr[j][i] + hs[j][i];
            const float d_pre = ds * a[j][i] * (pre > 0.0f ? 1.0f : slope);
            acc[j][i] += alpha_keep * gr[j][i] + d_pre;
          }
        }
      }
    } else {
      // The piece's receivers land, then their statistics and rows are
      // copied while the sender's row is read.
      stage_send_piece(t, lo, n, receivers_ss, valid_ss, drop_ss, drop_bf16,
                       m_in, l_in, rho, heads, h, q);
      __syncwarp(q.mask);  // every lane's receivers are in the table
#pragma unroll
      for (int i = 0; i < kRing; ++i) {
        pair_fill<S, VEC, NJ>(ring_ht, ring_g, i, i < n ? t.recv[i] : -1, ht,
                              g, d, col0, fk, q);
      }
      load_lane<S, VEC, NJ>(ht + row * d + col0, fk, q, hs);
      copy_wait<kRing>();  // this lane's statistics copies have landed
      __syncwarp(q.mask);  // and every lane's
      int stage = 0;
      for (int j = 0; j < n; ++j) {
        copy_wait<kRing - 1>();
        const int32_t r = t.recv[j];
        if (r >= 0) {  // else a padded slot
          float hr[NJ][VEC], gr[NJ][VEC];
          SenderRing<S, VEC, NJ>::read(ring_ht, stage, fk, q, hr);
          SenderRing<S, VEC, NJ>::read(ring_g, stage, fk, q, gr);
          // The forward's score: receiver columns first, as it summed them.
          const float s = gatv2_score<VEC, NJ>(hr, hs, a, slope, lph, q.mask);
          const float alpha = expf(fminf(s - t.m[j], 0.0f)) / (t.l[j] + eps);
          const float keep = drop_ss == nullptr ? 1.0f : t.keep[j];
          const float dalpha =
              group_sum(lane_dot<VEC, NJ>(gr, hs), lph, q.mask);
          const float ds = alpha * (keep * dalpha - t.rho[j]);
          const float alpha_keep = alpha * keep;
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
              const float pre = hr[jj][i] + hs[jj][i];
              const float d_pre = ds * a[jj][i] * (pre > 0.0f ? 1.0f : slope);
              acc[jj][i] += alpha_keep * gr[jj][i] + d_pre;
            }
          }
        }
        const int ahead = j + kRing;
        pair_fill<S, VEC, NJ>(ring_ht, ring_g, stage,
                              ahead < n ? t.recv[ahead] : -1, ht, g, d, col0,
                              fk, q);
        stage = stage + 1 == kRing ? 0 : stage + 1;
      }
    }
    if (pc.w < 0) {
      store_lane<S, VEC, NJ>(out + row * d + col0, fk, q, acc);
    } else {
      store_share<VEC, NJ>(out_part + static_cast<int64_t>(pc.w) * d + col0,
                           fk, q, acc);
    }
    pc = pc_next;
  }
}

// Blocks of a second launch with one thread per (split row, column) of
// `cols` columns, 0 when the grid would not fit.
inline int64_t finish_blocks(int64_t n_fix, int64_t cols) {
  const int64_t blocks = (n_fix * cols + kThreads - 1) / kThreads;
  return blocks < (static_cast<int64_t>(1) << 31) ? blocks : 0;
}

}  // namespace

extern "C" {

// Fused forward. ht/out: f32 (is_bf16 = 0) or bf16, row-major [n_rows,
// heads*f]. att [heads, f] and drop [n_slots, heads] (null when absent) are
// f32 or bf16 by their own flags; valid [n_slots] bytes (null: all valid).
// scores [n_slots, heads] (null: not written), m, l [n_rows, heads]: f32.
// pieces [n_pieces, 4] int32 (row, first slot, end slot, share row or -1),
// each of at most cap slots, cover every row and every slot once; the n_fix
// rows fix_rows split into several pieces take their m, l and output from
// their shares fix_ptr[k] .. fix_ptr[k + 1] of the f32 scratch m_part,
// l_part [*, heads] and o_part [*, heads*f], written before they are read.
int kgt_sddmm_stats_agg_sorted(
    const void* ht, const int32_t* senders, const int32_t* pieces,
    int64_t n_pieces, int cap, const void* att, int att_bf16,
    const uint8_t* valid, const void* drop, int drop_bf16, void* out,
    float* scores, float* m, float* l, float* m_part, float* l_part,
    float* o_part, const int32_t* fix_rows, const int32_t* fix_ptr,
    int64_t n_fix, int64_t n_rows, int heads, int64_t f, float slope,
    float eps, int is_bf16, void* stream) {
  const int64_t fix_blocks = finish_blocks(n_fix, heads * f);
  if (ht == nullptr || senders == nullptr || att == nullptr ||
      out == nullptr || m == nullptr || l == nullptr ||
      !shape_ok(n_rows, heads, f) ||
      !pieces_ok(pieces, n_pieces, n_rows, cap, n_fix,
                 m_part != nullptr && l_part != nullptr &&
                     o_part != nullptr && fix_rows != nullptr &&
                     fix_ptr != nullptr,
                 heads, f) ||
      (n_fix > 0 && fix_blocks == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lay = pick_layout(f, is_bf16 ? 2 : 4, ht, out, ht, out);
  const unsigned grid =
      blocks_for_fixed_grid(n_pieces, heads * lay.slabs, lay.lph);
  const int fi = static_cast<int>(f);
  const int4* work = reinterpret_cast<const int4*>(pieces);
#define KGT_FWD(S)                                                          \
  {                                                                         \
    const cudaError_t err = launch_pieces(                                  \
        sddmm_stats_agg_kernel<S, VEC, NJ, WIDE>, grid,                     \
        piece_smem<S, VEC, NJ, WIDE>(lay.lph, cap), s,                      \
        static_cast<const S*>(ht), senders, work, n_pieces, cap, att,       \
        att_bf16, valid, drop, drop_bf16, static_cast<S*>(out), scores, m,  \
        l, m_part, l_part, o_part, heads, fi, lay.lph, slope, eps);         \
    if (err != cudaSuccess) return static_cast<int>(err);                   \
  }
  KGT_DISPATCH(is_bf16, lay, KGT_FWD)
#undef KGT_FWD
  if (n_fix > 0) {
    const unsigned blocks = static_cast<unsigned>(fix_blocks);
    if (is_bf16) {
      agg_finish_kernel<uint16_t><<<blocks, kThreads, 0, s>>>(
          m_part, l_part, o_part, fix_rows, fix_ptr, n_fix, heads, fi, eps,
          static_cast<uint16_t*>(out), m, l);
    } else {
      agg_finish_kernel<float><<<blocks, kThreads, 0, s>>>(
          m_part, l_part, o_part, fix_rows, fix_ptr, n_fix, heads, fi, eps,
          static_cast<float*>(out), m, l);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Aggregation from cached scores [n_slots, heads] (-inf on invalid slots)
// and m, l [n_rows, heads], all f32; ht/out in the data's type. pieces, cap,
// fix_rows, fix_ptr and n_fix as for the forward (rho's work list); a split
// row's out is the sum of its shares in out_part ([*, heads*f] f32
// scratch), written before it is read.
int kgt_attend_aggregate_sorted(const float* scores, const float* m,
                                const float* l, const void* ht,
                                const int32_t* senders, const int32_t* pieces,
                                int64_t n_pieces, int cap, const void* drop,
                                int drop_bf16, void* out, float* out_part,
                                const int32_t* fix_rows,
                                const int32_t* fix_ptr, int64_t n_fix,
                                int64_t n_rows, int heads, int64_t f,
                                float eps, int is_bf16, void* stream) {
  const int64_t d = static_cast<int64_t>(heads) * f;
  const int64_t fix_blocks = finish_blocks(n_fix, d);
  if (scores == nullptr || m == nullptr || l == nullptr || ht == nullptr ||
      senders == nullptr || out == nullptr || !shape_ok(n_rows, heads, f) ||
      !pieces_ok(pieces, n_pieces, n_rows, cap, n_fix,
                 out_part != nullptr && fix_rows != nullptr &&
                     fix_ptr != nullptr,
                 heads, f) ||
      (n_fix > 0 && fix_blocks == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lay = pick_layout(f, is_bf16 ? 2 : 4, ht, out, ht, out);
  const unsigned grid =
      blocks_for_fixed_grid(n_pieces, heads * lay.slabs, lay.lph);
  const int fi = static_cast<int>(f);
  const int4* work = reinterpret_cast<const int4*>(pieces);
#define KGT_AGG(S)                                                          \
  {                                                                         \
    const cudaError_t err = launch_pieces(                                  \
        attend_aggregate_kernel<S, VEC, NJ, WIDE>, grid,                    \
        piece_smem<S, VEC, NJ, WIDE>(lay.lph, cap), s, scores, m, l,        \
        static_cast<const S*>(ht), senders, work, n_pieces, cap, drop,      \
        drop_bf16, static_cast<S*>(out), out_part, heads, fi, lay.lph,      \
        eps);                                                               \
    if (err != cudaSuccess) return static_cast<int>(err);                   \
  }
  KGT_DISPATCH(is_bf16, lay, KGT_AGG)
#undef KGT_AGG
  if (n_fix > 0) {
    const unsigned blocks = static_cast<unsigned>(fix_blocks);
    if (is_bf16) {
      shares_finish_kernel<uint16_t><<<blocks, kThreads, 0, s>>>(
          out_part, fix_rows, fix_ptr, n_fix, d, static_cast<uint16_t*>(out));
    } else {
      shares_finish_kernel<float><<<blocks, kThreads, 0, s>>>(
          out_part, fix_rows, fix_ptr, n_fix, d, static_cast<float*>(out));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// rho [n_rows, heads] f32 from the output cotangent g (same type as ht) and
// the forward's m, l and cached scores; scores == null recomputes them from
// ht and att (valid: null or [n_slots] bytes). pieces, cap, fix_rows,
// fix_ptr and n_fix as for the forward; rho_part: f32 scratch [*, heads] of
// the split rows' shares.
int kgt_attend_rho_sorted(const void* g, const void* ht,
                          const int32_t* senders, const int32_t* pieces,
                          int64_t n_pieces, int cap, const float* scores,
                          const float* m, const float* l, const void* att,
                          int att_bf16, const uint8_t* valid,
                          const void* drop, int drop_bf16, float* rho,
                          float* rho_part, const int32_t* fix_rows,
                          const int32_t* fix_ptr, int64_t n_fix,
                          int64_t n_rows, int heads, int64_t f, float slope,
                          float eps, int is_bf16, void* stream) {
  const int64_t fix_blocks = finish_blocks(n_fix, heads);
  if (g == nullptr || ht == nullptr || senders == nullptr || m == nullptr ||
      l == nullptr || rho == nullptr || (scores == nullptr && att == nullptr) ||
      !shape_ok(n_rows, heads, f) ||
      !pieces_ok(pieces, n_pieces, n_rows, cap, n_fix,
                 rho_part != nullptr && fix_rows != nullptr &&
                     fix_ptr != nullptr,
                 heads, f) ||
      (n_fix > 0 && fix_blocks == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lay = pick_layout(f, is_bf16 ? 2 : 4, g, ht, g, ht);
  const unsigned grid = blocks_for_fixed_grid(n_pieces, heads, lay.lph);
  const int fi = static_cast<int>(f);
  const int4* work = reinterpret_cast<const int4*>(pieces);
#define KGT_RHO_AS(S, RECOMPUTE)                                           \
  {                                                                        \
    const cudaError_t err = launch_pieces(                                 \
        attend_rho_kernel<S, VEC, NJ, RECOMPUTE, WIDE>, grid,              \
        piece_smem<S, VEC, NJ, WIDE>(lay.lph, cap), s,                     \
        static_cast<const S*>(g), static_cast<const S*>(ht), senders,      \
        work, n_pieces, cap, scores, m, l, att, att_bf16, valid, drop,     \
        drop_bf16, rho, rho_part, heads, fi, lay.lph, slope, eps);         \
    if (err != cudaSuccess) return static_cast<int>(err);                  \
  }
#define KGT_RHO(S)                                                         \
  if (scores != nullptr) {                                                 \
    KGT_RHO_AS(S, false);                                                  \
  } else {                                                                 \
    KGT_RHO_AS(S, true);                                                   \
  }
  KGT_DISPATCH(is_bf16, lay, KGT_RHO)
#undef KGT_RHO
#undef KGT_RHO_AS
  if (n_fix > 0) {
    rho_finish_kernel<<<static_cast<unsigned>(fix_blocks), kThreads, 0, s>>>(
        rho_part, fix_rows, fix_ptr, n_fix, heads, rho);
  }
  return static_cast<int>(cudaGetLastError());
}

// Rows of the [rows, heads*f] f32 scratch that the receiver backward needs
// for its datt partials on the current device over n_pieces pieces of work,
// for the same data pointers (their alignment decides the layout, and the
// layout the number of groups); 0 for a shape it does not take.
int64_t kgt_attend_recv_bwd_partial_rows(const void* ht, const void* g,
                                         const void* dht, const void* v,
                                         int64_t n_pieces, int heads,
                                         int64_t f, int is_bf16) {
  if (!shape_ok(n_pieces, heads, f)) return 0;
  const Layout lay = pick_layout(f, is_bf16 ? 2 : 4, ht, g, dht,
                                 v == nullptr ? dht : v);
  return partial_rows(n_pieces, heads * lay.slabs, lay.lph);
}

// Receiver-side backward: dht [n_rows, heads*f] and v [n_slots, heads*f]
// (null: not written) in the data's type, datt [heads*f] f32. scores == null
// recomputes them (valid: null or [n_slots] bytes). pieces, cap, fix_rows,
// fix_ptr and n_fix as for the forward; a split row's dht is the sum of its
// shares in dht_part ([*, heads*f] f32 scratch). partial: scratch of
// kgt_attend_recv_bwd_partial_rows(..., n_pieces, ...) rows. Scratch is
// written before it is read.
int kgt_attend_recv_bwd_full_sorted(
    const void* ht, const void* g, const int32_t* senders,
    const int32_t* pieces, int64_t n_pieces, int cap, const void* att,
    int att_bf16,
    const float* scores, const float* m, const float* l, const float* rho,
    const uint8_t* valid, const void* drop, int drop_bf16, void* dht,
    float* dht_part, const int32_t* fix_rows, const int32_t* fix_ptr,
    int64_t n_fix, void* v, float* datt, float* partial, int64_t n_rows,
    int heads, int64_t f, float slope, float eps, int is_bf16,
    void* stream) {
  const int64_t d = static_cast<int64_t>(heads) * f;
  const int64_t fix_blocks = finish_blocks(n_fix, d);
  if (ht == nullptr || g == nullptr || senders == nullptr || att == nullptr ||
      m == nullptr || l == nullptr || rho == nullptr || dht == nullptr ||
      datt == nullptr || partial == nullptr ||
      !pieces_ok(pieces, n_pieces, n_rows, cap, n_fix,
                 dht_part != nullptr && fix_rows != nullptr &&
                     fix_ptr != nullptr,
                 heads, f) ||
      (n_fix > 0 && fix_blocks == 0) ||
      d + fix_blocks >= (static_cast<int64_t>(1) << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lay = pick_layout(f, is_bf16 ? 2 : 4, ht, g, dht,
                                 v == nullptr ? dht : v);
  const unsigned grid =
      blocks_for_fixed_grid(n_pieces, heads * lay.slabs, lay.lph);
  const int64_t p_rows = partial_rows(n_pieces, heads * lay.slabs, lay.lph);
  const int fi = static_cast<int>(f);
  const int4* work = reinterpret_cast<const int4*>(pieces);
#define KGT_BWD_AS(S, RECOMPUTE, EMIT_V)                                    \
  {                                                                         \
    const cudaError_t err = launch_pieces(                                  \
        attend_recv_bwd_kernel<S, VEC, NJ, RECOMPUTE, EMIT_V, WIDE>, grid,  \
        piece_smem<S, VEC, NJ, WIDE>(lay.lph, cap), s,                      \
        static_cast<const S*>(ht), static_cast<const S*>(g), senders, work, \
        n_pieces, cap, att, att_bf16, scores, m, l, rho, valid, drop,       \
        drop_bf16, static_cast<S*>(dht), dht_part, static_cast<S*>(v),      \
        partial, heads, fi, lay.lph, slope, eps);                           \
    if (err != cudaSuccess) return static_cast<int>(err);                   \
  }
#define KGT_BWD(S)                                                          \
  if (scores != nullptr && v != nullptr) {                                  \
    KGT_BWD_AS(S, false, true);                                             \
  } else if (scores != nullptr) {                                           \
    KGT_BWD_AS(S, false, false);                                            \
  } else if (v != nullptr) {                                                \
    KGT_BWD_AS(S, true, true);                                              \
  } else {                                                                  \
    KGT_BWD_AS(S, true, false);                                             \
  }
  KGT_DISPATCH(is_bf16, lay, KGT_BWD)
#undef KGT_BWD
#undef KGT_BWD_AS
  const unsigned finish = static_cast<unsigned>(d + fix_blocks);
  if (is_bf16) {
    recv_bwd_finish_kernel<uint16_t><<<finish, kThreads, 0, s>>>(
        partial, datt, p_rows, d, dht_part, fix_rows, fix_ptr, n_fix,
        static_cast<uint16_t*>(dht));
  } else {
    recv_bwd_finish_kernel<float><<<finish, kThreads, 0, s>>>(
        partial, datt, p_rows, d, dht_part, fix_rows, fix_ptr, n_fix,
        static_cast<float*>(dht));
  }
  return static_cast<int>(cudaGetLastError());
}

// Sender-side backward: out [n_rows, heads*f] in the data's type, the sum
// over each sender row's slots (the sender-sorted stream, receivers_ss its
// receivers) of alpha*keep*g[r] + d_pre, recomputed from ht, g, att and the
// receivers' m, l, rho [n_rows, heads] f32. valid_ss [n_slots] f32 1/0
// (null: all valid); drop_ss [n_slots, heads] (null: no dropout) in
// sender-sorted order. pieces, cap, fix_rows, fix_ptr and n_fix as for the
// forward, over the sender-sorted stream; a split sender row's out is the
// sum of its shares in out_part ([*, heads*f] f32 scratch), written before
// it is read.
int kgt_attend_send_bwd_sorted(
    const void* ht, const void* g, const int32_t* receivers_ss,
    const int32_t* pieces, int64_t n_pieces, int cap, const void* att,
    int att_bf16, const float* m, const float* l, const float* rho,
    const float* valid_ss, const void* drop_ss, int drop_bf16, void* out,
    float* out_part, const int32_t* fix_rows, const int32_t* fix_ptr,
    int64_t n_fix, int64_t n_rows, int heads, int64_t f, float slope,
    float eps, int is_bf16, void* stream) {
  const int64_t d = static_cast<int64_t>(heads) * f;
  const int64_t fix_blocks = finish_blocks(n_fix, d);
  if (ht == nullptr || g == nullptr || receivers_ss == nullptr ||
      att == nullptr || m == nullptr || l == nullptr || rho == nullptr ||
      out == nullptr || !shape_ok(n_rows, heads, f) ||
      !pieces_ok(pieces, n_pieces, n_rows, cap, n_fix,
                 out_part != nullptr && fix_rows != nullptr &&
                     fix_ptr != nullptr,
                 heads, f) ||
      (n_fix > 0 && fix_blocks == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lay = pick_layout(f, is_bf16 ? 2 : 4, ht, g, out, out);
  const unsigned grid =
      blocks_for_fixed_grid(n_pieces, heads * lay.slabs, lay.lph);
  const int fi = static_cast<int>(f);
  const int4* work = reinterpret_cast<const int4*>(pieces);
#define KGT_SEND(S)                                                         \
  {                                                                         \
    const cudaError_t err = launch_pieces(                                  \
        attend_send_bwd_kernel<S, VEC, NJ, WIDE>, grid,                     \
        send_smem<S, VEC, NJ, WIDE>(lay.lph, cap), s,                       \
        static_cast<const S*>(ht), static_cast<const S*>(g), receivers_ss,  \
        work, n_pieces, cap, att, att_bf16, m, l, rho, valid_ss, drop_ss,   \
        drop_bf16, static_cast<S*>(out), out_part, heads, fi, lay.lph,      \
        slope, eps);                                                        \
    if (err != cudaSuccess) return static_cast<int>(err);                   \
  }
  KGT_DISPATCH(is_bf16, lay, KGT_SEND)
#undef KGT_SEND
  if (n_fix > 0) {
    const unsigned blocks = static_cast<unsigned>(fix_blocks);
    if (is_bf16) {
      shares_finish_kernel<uint16_t><<<blocks, kThreads, 0, s>>>(
          out_part, fix_rows, fix_ptr, n_fix, d, static_cast<uint16_t*>(out));
    } else {
      shares_finish_kernel<float><<<blocks, kThreads, 0, s>>>(
          out_part, fix_rows, fix_ptr, n_fix, d, static_cast<float*>(out));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kgt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
