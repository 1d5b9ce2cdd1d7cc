// The walk over pieces of a receiver-sorted stream that the attention
// kernels share: attend.cu's forward (K9), rho (K10b) and receiver backward
// (K10c), and sddmm.cu's score-and-statistics kernel (K8); and the merge of
// split rows' softmax statistics that K8 and softmax.cu's statistics (K5)
// share with the forward's merge.
//
// Piece p covers slots pieces[p].y .. pieces[p].z of row pieces[p].x, at
// most `cap` of them (the host cuts longer rows, the padded tail included,
// into pieces: spmm_cuda.recv_bwd_work); pieces[p].w is -1 for a piece that
// is its whole row (it stores the row's results) and otherwise its row in
// the f32 scratch of shares, which the kernel's second launch combines in
// piece order.

#pragma once

#include "cp_async.cuh"
#include "lanes.cuh"

namespace {

constexpr int kRing = 4;  // sender rows in flight per group

// A group's ring of kRing stages of sender rows (lanes.cuh).
template <typename S, int VEC, int NJ>
using SenderRing = PackRing<S, VEC, NJ, kRing>;

// A group's piece table in shared memory, after the block's rings: the
// senders of the piece's slots, their flags (the cached score, or 0 / -inf
// for a valid / padded slot) and their keep factors, `cap` of each (K8,
// which has no keep factors, keeps the piece's scores there).
struct PieceTable {
  int32_t* send;
  float* flag;
  float* keep;
};

__device__ __forceinline__ PieceTable piece_table(uint8_t* smem,
                                                  int ring_bytes, int lph,
                                                  int cap) {
  int32_t* send = reinterpret_cast<int32_t*>(smem + ring_bytes) +
                  static_cast<int64_t>(threadIdx.x / lph) * cap * 3;
  float* flag = reinterpret_cast<float*>(send + cap);
  return PieceTable{send, flag, flag + cap};
}

// Dynamic shared memory of a block that walks pieces: its groups' rings,
// then their tables (12 bytes a slot). A wide launch uses none.
template <typename S, int VEC, int NJ, bool WIDE>
inline size_t piece_smem(int lph, int cap) {
  if constexpr (WIDE) {
    return 0;
  } else {
    return SenderRing<S, VEC, NJ>::kBytes +
           static_cast<size_t>(kThreads / lph) * cap * 12;
  }
}

// Starts copying the table of the piece of n slots from slot lo into shared
// memory, the group's lanes together (one latency for the piece): the flags
// are head h's cached scores or (FROM_VALID) 0 / -inf from the validity
// bytes. piece_landed waits for it; the group reads its rows meanwhile.
template <bool FROM_VALID>
__device__ __forceinline__ void stage_piece(
    const PieceTable& t, int64_t lo, int n,
    const int32_t* __restrict__ senders, const float* __restrict__ scores,
    const uint8_t* __restrict__ valid, const void* __restrict__ drop,
    int drop_bf16, int heads, int h, const Geometry& q) {
  __syncwarp(q.mask);  // the previous piece's table is read out
  for (int i = q.lane; i < n; i += q.lph) {
    const int64_t e = lo + i;
    copy_async<4>(shared_u32(t.send + i), senders + e);
    if constexpr (FROM_VALID) {
      t.flag[i] = (valid == nullptr || valid[e] != 0) ? 0.0f : -INFINITY;
    } else {
      copy_async<4>(shared_u32(t.flag + i), scores + e * heads + h);
    }
    if (drop != nullptr) {
      if (drop_bf16) {
        t.keep[i] = load_scalar(drop, 1, e * heads + h);
      } else {
        copy_async<4>(shared_u32(t.keep + i),
                      static_cast<const float*>(drop) + e * heads + h);
      }
    }
  }
  copy_commit();
}

__device__ __forceinline__ void piece_landed(const Geometry& q) {
  copy_wait<0>();
  __syncwarp(q.mask);  // every lane's part of the table has landed
}

// The ring over a landed piece table: a slot's sender row is copied kRing
// slots ahead of its use, one commit group a slot (empty where nothing is
// copied), so that waiting for all but the kRing - 1 latest groups
// (copy_wait<kRing - 1>) means slot j has landed in stage j % kRing. A slot
// whose flag is -inf is never copied. ring_start fills the first kRing
// stages; after slot j is read, ring_next refills its stage with slot
// j + kRing and returns the next stage.
template <typename S, int VEC, int NJ>
__device__ __forceinline__ void ring_start(uint8_t* ring, const PieceTable& t,
                                           int n, const S* __restrict__ ht,
                                           int64_t d, int64_t col0, int fk,
                                           const Geometry& q) {
#pragma unroll
  for (int i = 0; i < kRing; ++i) {
    if (i < n && t.flag[i] != -INFINITY) {
      SenderRing<S, VEC, NJ>::fill(
          ring, i, ht + static_cast<int64_t>(t.send[i]) * d + col0, fk, q);
    }
    copy_commit();
  }
}

template <typename S, int VEC, int NJ>
__device__ __forceinline__ int ring_next(uint8_t* ring, const PieceTable& t,
                                         int j, int n, int stage,
                                         const S* __restrict__ ht, int64_t d,
                                         int64_t col0, int fk,
                                         const Geometry& q) {
  const int ahead = j + kRing;
  if (ahead < n && t.flag[ahead] != -INFINITY) {
    SenderRing<S, VEC, NJ>::fill(
        ring, stage, ht + static_cast<int64_t>(t.send[ahead]) * d + col0, fk,
        q);
  }
  copy_commit();
  return stage + 1 == kRing ? 0 : stage + 1;
}

// The work list's arguments: pieces 16-byte aligned (int4 loads), at least
// one a row, at most 1,024 slots each (the piece tables' shared memory),
// and the scratch of shares present where rows are split.
inline bool pieces_ok(const int32_t* pieces, int64_t n_pieces, int64_t n_rows,
                      int cap, int64_t n_fix, bool has_scratch, int heads,
                      int64_t f) {
  return pieces != nullptr && n_pieces >= n_rows && n_fix >= 0 && cap >= 1 &&
         cap <= 1024 && (n_fix == 0 || has_scratch) &&
         reinterpret_cast<uintptr_t>(pieces) % 16 == 0 &&
         shape_ok(n_pieces, heads, f);
}

// Launches a piece-walking kernel with `smem` bytes of dynamic shared memory
// (more than the default 48 KB only once the kernel is allowed them).
template <typename Kernel, typename... Args>
cudaError_t launch_pieces(Kernel kernel, unsigned grid, size_t smem,
                          cudaStream_t s, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return attr;
  }
  kernel<<<grid, kThreads, smem, s>>>(args...);
  return cudaGetLastError();
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

// Launches the merge above for the n_fix split rows (none: nothing).
inline cudaError_t merge_split_stats(const float* m_part, const float* l_part,
                                     const int32_t* fix_rows,
                                     const int32_t* fix_ptr, int64_t n_fix,
                                     int heads, float* m_out, float* l_out,
                                     cudaStream_t s) {
  if (n_fix == 0) return cudaSuccess;
  const int64_t blocks = (n_fix * heads * 32 + kThreads - 1) / kThreads;
  if (blocks >= (static_cast<int64_t>(1) << 31)) return cudaErrorInvalidValue;
  softmax_stats_finish_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                s>>>(m_part, l_part, fix_rows, fix_ptr, n_fix,
                                     heads, m_out, l_out);
  return cudaGetLastError();
}

}  // namespace
