// The sorted edge softmax for Hopper (sm_90a): per-receiver statistics and
// the normalisation, over receiver-sorted [E, K] f32 edge scores.
//
// They replace two TPU kernels of the JAX package:
//   softmax_stats_kernel <- kernels/softmax_pallas.py softmax_stats_sorted
//   softmax_apply_kernel <- kernels/softmax_pallas.py softmax_apply_sorted
//
// stats: m[r, k] = max over the row's slots of s[e, k], and
//        l[r, k] = sum over them of exp(s[e, k] - m[r, k]);
//        masked slots arrive as -inf and add nothing; m is stored as 0 and l
//        as 0 for a row without a finite score (the reference's fixup).
// apply: alpha[e, k] = exp(s[e, k] - m[recv[e], k]) / (l[recv[e], k] + eps),
//        stored in f32 or bf16; -inf slots and rows without a finite score
//        come out 0.
//
// The TPU kernels reach the rows through one-hot matrix products over a
// boundary-encoded work list (that machine has no vector gather). Here:
//
// - stats: the pieces of the receiver-sorted stream that the attention
//   kernels walk (spmm_cuda.recv_bwd_work(row_ptr): at most 32 slots of one
//   row, every row at least one piece), one thread per (piece, head). A
//   thread loads its piece's scores kStatsBatch slots at once (independent
//   loads: one memory latency for a piece of up to kStatsBatch slots) and
//   folds them in slot order with online_step (lanes.cuh), the step of the
//   fused forward (attend.cu, K9): l <- l * exp(m_old - m_new) +
//   exp(s - m_new), -inf slots skipped, so a lane that has seen only -inf
//   keeps m = -inf, l = 0 and exp(-inf - (-inf)) is never formed. A row of
//   one piece stores its (m, l); a split row (a hub, the padded tail)
//   stores each piece's pair in scratch, and a second launch, a warp per
//   (split row, head; recv_pieces.cuh, shared with sddmm.cu's K8), merges
//   them with the forward's merge (agg_finish_kernel): m = max m_p, l =
//   sum in piece order over the pieces with a finite m_p of l_p exp(m_p -
//   m), each piece's factor formed by its own lane and the sum taken in
//   order. So on the same
//   scores every row's (m, l) is the fused forward's, bit for bit. Bound
//   by bytes (the [E, K] score stream, read once) in principle; the work
//   is two expf a finite score, and at arxiv's shapes the two dependent
//   loads a thread makes (its piece's header, then its scores) leave it at
//   about a third of that bound (PERF.md). Its predecessor gave a warp to
//   each row and merged the lanes' pairs by a five-step butterfly: on
//   arxiv's rows of ~9 slots 23 of 32 lanes loaded nothing and every lane
//   paid ~40 expf and ~40 shuffles a row, which set its time.
// - apply: edge-parallel on the flat (slot, pack) index, a pack being up to
//   four neighbouring heads (16 bytes of f32 scores: H = 4 is one pack a
//   slot, H = 8 two; H = 6 takes packs of 2, an odd H or an unaligned
//   pointer packs of 1, a template parameter of the same kernel). No row
//   walk, so a hub row is no hazard. Bound by bytes: the scores and the
//   receivers read once, the receivers' (m, l) rows once a row (sorted
//   receivers: neighbouring items hit one row in L1), alpha written once.
//   A thread serves one pack: its slot comes from a multiply-high and a
//   shift (fast_div.cuh), not a 64-bit division, and it reads recv[e] once
//   a pack. A launch too small to give every SM two blocks (CiteSeer's
//   E * H = 106k) takes narrower packs, down to single heads, so that it
//   spreads over the card. Its predecessor ran one thread per (slot, head)
//   in a grid-stride loop: a 64-bit division, the H threads of a slot each
//   reloading recv[e], and two dependent 4-byte gathers an element, with
//   nothing independent in flight, at 40% of its bound at arxiv's shapes
//   (PERF.md). Each element is expf(s - m) / (l + eps) with an IEEE
//   division, as before: the same bits.
//
// Sums are f32 in registers, no atomics. Offsets into data are 64-bit;
// indices and row_ptr are int32; row_ptr[0] must be 0 and row_ptr[N] the
// slot count. The C entry points launch on the given stream, allocate
// nothing, do not synchronise, and return cudaGetLastError().

#include "fast_div.cuh"
#include "lanes.cuh"
#include "recv_pieces.cuh"

namespace {

// Slots whose scores a thread loads at once, and the statistics' blocks
// per SM (48 registers). NVIDIA H100 80GB HBM3 at 700 W, composed arxiv
// shapes, the walk alone: 0.023 ms, the same at three blocks a SM, 0.029
// at six and 0.030 at eight (batches of 8) (PERF.md).
constexpr int kStatsBatch = 16;
constexpr int kStatsBlocksPerSm = 4;

// pieces[p] = (row, first slot, end slot, share): share -1 where the piece
// is its whole row, else its row of m_part / l_part ([shares, heads]).
__global__ void __launch_bounds__(kThreads, kStatsBlocksPerSm)
softmax_stats_kernel(const float* __restrict__ scores,
                     const int4* __restrict__ pieces, int64_t n_pieces,
                     int heads, float* __restrict__ m_out,
                     float* __restrict__ l_out, float* __restrict__ m_part,
                     float* __restrict__ l_part) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_pieces * heads) return;
  const int64_t p = i / heads;
  const int h = static_cast<int>(i - p * heads);
  const int4 pc = pieces[p];
  const int n = pc.z - pc.y;
  const float* s_h = scores + static_cast<int64_t>(pc.y) * heads + h;
  float m = -INFINITY, l = 0.0f;
  for (int j0 = 0; j0 < n; j0 += kStatsBatch) {
    float s[kStatsBatch];
#pragma unroll
    for (int u = 0; u < kStatsBatch; ++u) {
      s[u] = j0 + u < n ? s_h[static_cast<int64_t>(j0 + u) * heads]
                        : -INFINITY;
    }
#pragma unroll
    for (int u = 0; u < kStatsBatch; ++u) {
      if (s[u] > -INFINITY) {
        float e;
        online_step(s[u], m, l, e);
      }
    }
  }
  if (pc.w < 0) {
    const int64_t r = static_cast<int64_t>(pc.x) * heads + h;
    m_out[r] = m > -INFINITY ? m : 0.0f;
    l_out[r] = l;
  } else {  // m stays -inf where the piece saw no finite score
    const int64_t r = static_cast<int64_t>(pc.w) * heads + h;
    m_part[r] = m;
    l_part[r] = l;
  }
}

unsigned blocks_for(int64_t items) {
  return static_cast<unsigned>((items + kThreads - 1) / kThreads);
}

// alpha for the flat item i = e * packs + c (c the pack of VEC heads) of
// [0, n_items), one item a thread: slot e's pack c is VEC neighbouring
// values at offset i * VEC of scores and alpha (packs * VEC == heads), and
// at recv[e] * heads + c * VEC of m and l. (Two items a thread, their loads
// issued before their gathers, measured 2% slower at composed arxiv L1 and
// the same at L2 on an NVIDIA H100 80GB HBM3 at 700 W: other warps hide
// the gathers' latency; a launch too small to fill the card takes narrower
// packs instead, softmax_cuda._apply_vec; PERF.md.)
template <typename O, int VEC>
__global__ void __launch_bounds__(kThreads)
softmax_apply_kernel(const float* __restrict__ scores,
                     const int32_t* __restrict__ recv,
                     const float* __restrict__ m, const float* __restrict__ l,
                     O* __restrict__ alpha, uint32_t n_items, FastDiv packs,
                     int heads, float eps) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_items) return;
  const uint32_t e = fast_div(packs, i);
  const uint32_t c = i - e * packs.d;
  // The scores load beside the receiver; m and l then gather its row
  // (receivers are sorted, so neighbouring items mostly hit one row).
  const int64_t row = static_cast<int64_t>(recv[e]) * heads + c * VEC;
  float s[VEC], mm[VEC], ll[VEC], a[VEC];
  load_pack<float, VEC>(scores + static_cast<int64_t>(i) * VEC, s);
  load_pack<float, VEC>(m + row, mm);
  load_pack<float, VEC>(l + row, ll);
#pragma unroll
  for (int j = 0; j < VEC; ++j) a[j] = expf(s[j] - mm[j]) / (ll[j] + eps);
  store_pack<O, VEC>(alpha + static_cast<int64_t>(i) * VEC, a);
}

template <typename O, int VEC>
cudaError_t launch_apply(const float* scores, const int32_t* recv,
                         const float* m, const float* l, void* alpha,
                         int64_t n_slots, int heads, float eps,
                         cudaStream_t s) {
  const int64_t n_items = n_slots * (heads / VEC);
  softmax_apply_kernel<O, VEC><<<blocks_for(n_items), kThreads, 0, s>>>(
      scores, recv, m, l, static_cast<O*>(alpha),
      static_cast<uint32_t>(n_items),
      make_fast_div(static_cast<uint32_t>(heads / VEC)), heads, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// m, l [n_rows, heads] f32 from scores [n_slots, heads] f32 (masked slots
// -inf). pieces [n_pieces, 4] int32 (row, first slot, end slot, share),
// 16-byte aligned: the pieces of the receiver-sorted stream's row pointers,
// every row at least one; fix_rows [n_fix] the split rows, their shares
// fix_ptr[k] .. fix_ptr[k + 1] ([n_fix + 1]) in piece order; m_part, l_part
// [shares, heads] f32 scratch, written before they are read (unused when
// n_fix == 0). Two launches when a row is split, else one.
int kgt_softmax_stats_sorted(const float* scores, const int32_t* pieces,
                             int64_t n_pieces, const int32_t* fix_rows,
                             const int32_t* fix_ptr, int64_t n_fix, float* m,
                             float* l, float* m_part, float* l_part,
                             int64_t n_rows, int heads, void* stream) {
  if (scores == nullptr || pieces == nullptr || m == nullptr ||
      l == nullptr || n_rows <= 0 || heads < 1 || n_pieces < n_rows ||
      n_fix < 0 || reinterpret_cast<uintptr_t>(pieces) % 16 != 0 ||
      (n_fix > 0 && (fix_rows == nullptr || fix_ptr == nullptr ||
                     m_part == nullptr || l_part == nullptr)) ||
      n_pieces * heads / kThreads >= (1ll << 31) - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  softmax_stats_kernel<<<blocks_for(n_pieces * heads), kThreads, 0, s>>>(
      scores, reinterpret_cast<const int4*>(pieces), n_pieces, heads, m, l,
      m_part, l_part);
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return static_cast<int>(first);
  return static_cast<int>(
      merge_split_stats(m_part, l_part, fix_rows, fix_ptr, n_fix, heads, m, l,
                        s));
}

// alpha [n_slots, heads] in f32 (out_bf16 = 0) or bf16, scores [n_slots,
// heads] and m, l [*, heads] f32, in packs of vec heads (4, 2 or 1): vec
// divides heads, and every pointer is aligned to its pack
// (softmax_cuda._apply_vec picks it). n_slots * heads < 2^31.
int kgt_softmax_apply_sorted(const float* scores, const int32_t* recv,
                             const float* m, const float* l, void* alpha,
                             int64_t n_slots, int heads, int vec, float eps,
                             int out_bf16, void* stream) {
  const int out_size = out_bf16 ? 2 : 4;
  if (scores == nullptr || recv == nullptr || m == nullptr || l == nullptr ||
      alpha == nullptr || n_slots <= 0 || heads < 1 ||
      n_slots * heads >= (static_cast<int64_t>(1) << 31) ||
      (vec != 1 && vec != 2 && vec != 4) || heads % vec != 0 ||
      !aligned_to(scores, vec * 4) || !aligned_to(m, vec * 4) ||
      !aligned_to(l, vec * 4) || !aligned_to(alpha, vec * out_size)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KGT_APPLY(V)                                                        \
  (out_bf16 ? launch_apply<uint16_t, V>(scores, recv, m, l, alpha, n_slots, \
                                        heads, eps, s)                      \
            : launch_apply<float, V>(scores, recv, m, l, alpha, n_slots,    \
                                     heads, eps, s))
  const cudaError_t err =
      vec == 4 ? KGT_APPLY(4) : vec == 2 ? KGT_APPLY(2) : KGT_APPLY(1);
#undef KGT_APPLY
  return static_cast<int>(err);
}

const char* kgt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
