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
//   (split row, head), merges them with the forward's merge
//   (agg_finish_kernel): m = max m_p, l = sum in piece order over the
//   pieces with a finite m_p of l_p exp(m_p - m), each piece's factor
//   formed by its own lane and the sum taken in order. So on the same
//   scores every row's (m, l) is the fused forward's, bit for bit. Bound
//   by bytes (the [E, K] score stream, read once) in principle; the work
//   is two expf a finite score, and at arxiv's shapes the two dependent
//   loads a thread makes (its piece's header, then its scores) leave it at
//   about a third of that bound (PERF.md). Its predecessor gave a warp to
//   each row and merged the lanes' pairs by a five-step butterfly: on
//   arxiv's rows of ~9 slots 23 of 32 lanes loaded nothing and every lane
//   paid ~40 expf and ~40 shuffles a row, which set its time.
// - apply: edge-parallel, one thread per (slot, head): no row walk, so a hub
//   row is no hazard. Bound by bytes (scores in, alpha out).
//
// Sums are f32 in registers, no atomics. Offsets into data are 64-bit;
// indices and row_ptr are int32; row_ptr[0] must be 0 and row_ptr[N] the
// slot count. The C entry points launch on the given stream, allocate
// nothing, do not synchronise, and return cudaGetLastError().

#include "lanes.cuh"

namespace {

// Slots whose scores a thread loads at once, and the statistics' blocks
// per SM (48 registers). NVIDIA H100 80GB HBM3 at 700 W, composed arxiv
// shapes, the walk alone: 0.023 ms, the same at three blocks a SM, 0.029
// at six and 0.030 at eight (batches of 8) (PERF.md).
constexpr int kStatsBatch = 16;
constexpr int kStatsBlocksPerSm = 4;
constexpr int kApplyBlocksPerSm = 32;

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

// The split rows' (m, l) from their pieces' pairs, a warp per (split row,
// head): the fused forward's merge (attend.cu's agg_finish_kernel) with the
// same operations in the same order. m = the max of the pieces' m_p (a max
// is exact in any order), then l in piece order: each lane forms its
// piece's factor exp(m_p - m), and lane 0 adds l_p * factor piece by piece
// as the forward's loop does. A piece without a finite score is skipped, so
// a row whose finite scores lie in one piece gets that piece's pair.
__global__ void __launch_bounds__(kThreads)
softmax_stats_finish_kernel(const float* __restrict__ m_part,
                            const float* __restrict__ l_part,
                            const int32_t* __restrict__ fix_rows,
                            const int32_t* __restrict__ fix_ptr, int64_t n_fix,
                            int heads, float* __restrict__ m_out,
                            float* __restrict__ l_out) {
  const int64_t w =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  if (w >= n_fix * heads) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int64_t k = w / heads;
  const int h = static_cast<int>(w - k * heads);
  const int32_t p0 = fix_ptr[k], p1 = fix_ptr[k + 1];
  float m = -INFINITY;
  for (int32_t p = p0 + lane; p < p1; p += 32) {
    m = fmaxf(m, m_part[static_cast<int64_t>(p) * heads + h]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  float l = 0.0f;
  for (int32_t c = p0; c < p1; c += 32) {
    const int32_t p = c + lane;
    float mp = -INFINITY, lp = 0.0f, wp = 0.0f;
    if (p < p1) {
      mp = m_part[static_cast<int64_t>(p) * heads + h];
      lp = l_part[static_cast<int64_t>(p) * heads + h];
      if (mp > -INFINITY) wp = expf(mp - m);
    }
    const int count = min(32, p1 - c);  // the same on every lane
    for (int j = 0; j < count; ++j) {
      const float mj = __shfl_sync(0xffffffffu, mp, j);
      const float lj = __shfl_sync(0xffffffffu, lp, j);
      const float wj = __shfl_sync(0xffffffffu, wp, j);
      if (mj > -INFINITY) l += lj * wj;  // a piece without a finite score
    }
  }
  if (lane == 0) {
    const int64_t r = static_cast<int64_t>(fix_rows[k]) * heads + h;
    m_out[r] = m > -INFINITY ? m : 0.0f;
    l_out[r] = l;
  }
}

unsigned blocks_for(int64_t items) {
  return static_cast<unsigned>((items + kThreads - 1) / kThreads);
}

template <typename O>
__global__ void __launch_bounds__(kThreads)
softmax_apply_kernel(const float* __restrict__ scores,
                     const int32_t* __restrict__ recv,
                     const float* __restrict__ m, const float* __restrict__ l,
                     O* __restrict__ alpha, int64_t n_slots, int heads,
                     float eps) {
  const int64_t total = n_slots * heads;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += stride) {
    const int64_t e = i / heads;
    const int64_t r = static_cast<int64_t>(recv[e]) * heads + (i - e * heads);
    alpha[i] = Cvt<O>::from_f(expf(scores[i] - m[r]) / (l[r] + eps));
  }
}

unsigned apply_blocks(int64_t total) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  const int64_t cap = static_cast<int64_t>(sms) * kApplyBlocksPerSm;
  const int64_t need = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned>(need < cap ? need : cap);
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
  if (first != cudaSuccess || n_fix == 0) return static_cast<int>(first);
  softmax_stats_finish_kernel<<<blocks_for(n_fix * heads * 32), kThreads, 0,
                                s>>>(m_part, l_part, fix_rows, fix_ptr, n_fix,
                                     heads, m, l);
  return static_cast<int>(cudaGetLastError());
}

// alpha [n_slots, heads] in f32 (out_bf16 = 0) or bf16.
int kgt_softmax_apply_sorted(const float* scores, const int32_t* recv,
                             const float* m, const float* l, void* alpha,
                             int64_t n_slots, int heads, float eps,
                             int out_bf16, void* stream) {
  if (scores == nullptr || recv == nullptr || m == nullptr || l == nullptr ||
      alpha == nullptr || n_slots <= 0 || heads < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = apply_blocks(n_slots * heads);
  if (out_bf16) {
    softmax_apply_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        scores, recv, m, l, static_cast<uint16_t*>(alpha), n_slots, heads,
        eps);
  } else {
    softmax_apply_kernel<float><<<grid, kThreads, 0, s>>>(
        scores, recv, m, l, static_cast<float*>(alpha), n_slots, heads, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kgt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
