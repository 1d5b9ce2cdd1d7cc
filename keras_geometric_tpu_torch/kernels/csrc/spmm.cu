// Sorted-CSR SpMM kernels for Hopper (sm_90a): scatter-sum and its transpose.
//
// scatter_sum_sorted_kernel replaces the TPU scatter of
// the JAX package's kernels/spmm_pallas.py (_scatter_impl and
// _scatter_block_impl behind scatter_sum_sorted):
//     out[r, :] = sum_{e in row_ptr[r] .. row_ptr[r+1]} w[e] * message(e)
// The TPU has no vector gather, so its kernel multiplies a one-hot indicator
// into the messages on the matrix unit (2*E*ROW_BLOCK*F operations). This card
// gathers, so the work is one multiply-add per (edge, feature) and the kernel
// is bound by bytes: every message row is read once, every output row written
// once, plus the index and weight streams. Design: row-parallel CSR. A
// sub-warp of `lpr` lanes owns one receiver row, walks its edge range and
// keeps the row's partial sums in f32 registers; lanes lie across the feature
// axis and each loads VEC contiguous values (16 bytes where the width and the
// alignment allow, a scalar otherwise, so any F >= 1 works). Four edges are in
// flight per lane to cover the latency of the random row reads. No atomics:
// the order of the sum is the edge order, so results are deterministic.
// Empty rows store zeros. The weight is multiplied in f32 and the sum is
// rounded once, at the store.
//
// Where message(e) lives is a template flag:
//   GATHER = false: src[e, :]       (an [E, F] message array);
//   GATHER = true : src[idx[e], :]  (rows of a node array, gathered in the
//                   kernel, so the [E, F] array the TPU path materialises
//                   before its scatter never exists here). The source of the
//                   arxiv-shaped layer (43 MB in bf16) fits the 50 MB L2, so
//                   most of the random reads are served from there.
// An optional epilogue adds self_w[r] * src[r, :] (the densified diagonal of
// the GCN operator) before the store.
//
// The fused-gather form has a second walk, over pieces (gather_scatter_pieces_
// kernel): a row walk gives each row to one sub-warp, which walks its slots
// one window after another, so one long row (a hub, or the padded tail, which
// prepare_graph puts in the last row and which in sender order piles into the
// last sender's row: 521 slots at CiteSeer's GATv2 shape) keeps the whole
// kernel waiting on its dependent rounds of random reads. The piece walk
// (gather_pieces.cuh, which band.cu's window scatter shares) takes a
// host-built work list (spmm_cuda.recv_bwd_work, one per row_ptr tensor, the
// list the attention kernels walk) that cuts every row into pieces of at most
// 32 slots, stages each piece's indices and weights, keeps the next eight
// gathered rows in flight in a cp.async ring and sums them in f32 in slot
// order; a split row's shares are added in piece order by a second launch
// (gather_scatter_merge_kernel). In both walks of the fused-gather form a
// message is added with one fused multiply-add (fmaf), so a row that is one
// piece gets the row walk's bits.
//
// expand_sorted_kernel replaces _expand_impl (expand_sorted) of the same
// file: out[e, :] = rows[recv[e], :] * w[e], the scatter's transpose and its
// VJP. The TPU kernel again multiplies by a one-hot matrix; here each
// (edge, VEC-wide column chunk) is one thread that loads, scales and stores.
// Bound by bytes: E*F values written, the node rows read (sorted receivers
// make neighbouring edges re-read the same row from cache).
//
// All offsets into data are 64-bit. Indices and row_ptr are int32.
// The C entry points launch on the given stream, allocate nothing, do not
// synchronise, and return cudaGetLastError().

#include "gather_pieces.cuh"

namespace {

constexpr int kUnroll = 4;

template <typename S, int VEC, bool GATHER>
__global__ void __launch_bounds__(kThreads)
scatter_sum_sorted_kernel(const S* __restrict__ src,
                          const int32_t* __restrict__ idx,
                          const int32_t* __restrict__ row_ptr,
                          const void* __restrict__ w, int w_bf16,
                          const uint8_t* __restrict__ mask,
                          const void* __restrict__ self_w, int self_w_bf16,
                          S* __restrict__ out, int64_t n_rows, int64_t f,
                          int lpr) {
  const int sub = threadIdx.x / lpr;
  const int lane = threadIdx.x - sub * lpr;
  const int rows_per_block = kThreads / lpr;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * rows_per_block + sub;
  const int64_t col =
      (static_cast<int64_t>(blockIdx.y) * lpr + lane) * VEC;
  if (row >= n_rows || col >= f) return;

  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;

  const int64_t lo = row_ptr[row];
  const int64_t hi = row_ptr[row + 1];
  int64_t e = lo;
  for (; e + kUnroll <= hi; e += kUnroll) {
    int64_t r[kUnroll];
    float ww[kUnroll];
    bool ok[kUnroll];
    Pack<S, VEC> p[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      r[k] = GATHER ? static_cast<int64_t>(idx[e + k]) : (e + k);
      ww[k] = load_weight(w, w_bf16, e + k);
      ok[k] = (mask == nullptr) || (mask[e + k] != 0);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      p[k] = load_pack<S, VEC>(src + r[k] * f + col);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      add_message<S, VEC, GATHER>(acc, ww[k], ok[k], p[k]);
    }
  }
  for (; e < hi; ++e) {
    const int64_t r = GATHER ? static_cast<int64_t>(idx[e]) : e;
    const float ww = load_weight(w, w_bf16, e);
    const bool ok = (mask == nullptr) || (mask[e] != 0);
    const Pack<S, VEC> p = load_pack<S, VEC>(src + r * f + col);
    add_message<S, VEC, GATHER>(acc, ww, ok, p);
  }

  if (self_w != nullptr) add_diagonal<S, VEC>(acc, self_w, self_w_bf16, src, row,
                                              f, col);

  Pack<S, VEC> o;
#pragma unroll
  for (int j = 0; j < VEC; ++j) o.v[j] = Cvt<S>::from_f(acc[j]);
  store_pack<S, VEC>(out + row * f + col, o);
}

// ---------------------------------------------------------------------------
// The fused-gather form over pieces (gather_pieces.cuh)
// ---------------------------------------------------------------------------

template <typename S, int VEC>
__global__ void __launch_bounds__(kThreads)
gather_scatter_pieces_kernel(const S* __restrict__ src,
                             const int32_t* __restrict__ idx,
                             const int4* __restrict__ pieces, int64_t n_pieces,
                             int cap, const void* __restrict__ w, int w_bf16,
                             const void* __restrict__ self_w, int self_w_bf16,
                             S* __restrict__ out, float* __restrict__ part,
                             int64_t f, int lpr) {
  gather_pieces_walk<S, VEC, false>(src, idx, pieces, n_pieces, cap, w,
                                    w_bf16, nullptr, self_w, self_w_bf16, out,
                                    part, f, lpr);
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
gather_scatter_merge_kernel(const float* __restrict__ part,
                            const int32_t* __restrict__ fix_rows,
                            const int32_t* __restrict__ fix_ptr, int64_t n_fix,
                            const S* __restrict__ src,
                            const void* __restrict__ self_w, int self_w_bf16,
                            S* __restrict__ out, int64_t f) {
  merge_shares<S>(part, fix_rows, fix_ptr, n_fix, src, self_w, self_w_bf16,
                  out, f);
}

template <typename S, int VEC>
__global__ void __launch_bounds__(kThreads)
expand_sorted_kernel(const S* __restrict__ rows,
                     const int32_t* __restrict__ recv,
                     const void* __restrict__ w, int w_bf16,
                     const uint8_t* __restrict__ mask, S* __restrict__ out,
                     int64_t n_edges, int64_t f, int lpr) {
  const int sub = threadIdx.x / lpr;
  const int lane = threadIdx.x - sub * lpr;
  const int edges_per_block = kThreads / lpr;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * edges_per_block + sub;
  const int64_t col =
      (static_cast<int64_t>(blockIdx.y) * lpr + lane) * VEC;
  if (e >= n_edges || col >= f) return;

  const bool ok = (mask == nullptr) || (mask[e] != 0);
  const float ww = load_weight(w, w_bf16, e);
  const int64_t r = recv[e];
  const Pack<S, VEC> p = load_pack<S, VEC>(rows + r * f + col);
  Pack<S, VEC> o;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float v = ww * Cvt<S>::to_f(p.v[j]);
    o.v[j] = Cvt<S>::from_f(ok ? v : 0.0f);
  }
  store_pack<S, VEC>(out + e * f + col, o);
}

template <typename S, int VEC>
void launch_scatter(const void* src, const int32_t* idx,
                    const int32_t* row_ptr, const void* w, int w_bf16,
                    const uint8_t* mask, const void* self_w, int self_w_bf16,
                    void* out, int64_t n_rows, int64_t f,
                    cudaStream_t stream) {
  int lpr;
  dim3 grid;
  pick_geometry(f, VEC, n_rows, &lpr, &grid);
  if (idx != nullptr) {
    scatter_sum_sorted_kernel<S, VEC, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const S*>(src), idx, row_ptr, w, w_bf16, mask, self_w,
        self_w_bf16, static_cast<S*>(out), n_rows, f, lpr);
  } else {
    scatter_sum_sorted_kernel<S, VEC, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const S*>(src), idx, row_ptr, w, w_bf16, mask, self_w,
        self_w_bf16, static_cast<S*>(out), n_rows, f, lpr);
  }
}

template <typename S, int VEC>
cudaError_t launch_pieces(const void* src, const int32_t* idx,
                          const int4* pieces, int64_t n_pieces, int cap,
                          const void* w, int w_bf16, const void* self_w,
                          int self_w_bf16, void* out, float* part,
                          int64_t f, cudaStream_t stream) {
  int lpr;
  dim3 grid;
  pick_geometry(f, VEC, n_pieces, &lpr, &grid);
  const size_t smem = pieces_smem<S, VEC>(lpr, cap, w != nullptr);
  auto kernel = gather_scatter_pieces_kernel<S, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return attr;
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const S*>(src), idx, pieces, n_pieces, cap, w, w_bf16,
      self_w, self_w_bf16, static_cast<S*>(out), part, f, lpr);
  return cudaGetLastError();
}

template <typename S, int VEC>
void launch_expand(const void* rows, const int32_t* recv, const void* w,
                   int w_bf16, const uint8_t* mask, void* out,
                   int64_t n_edges, int64_t f, cudaStream_t stream) {
  int lpr;
  dim3 grid;
  pick_geometry(f, VEC, n_edges, &lpr, &grid);
  expand_sorted_kernel<S, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const S*>(rows), recv, w, w_bf16, mask,
      static_cast<S*>(out), n_edges, f, lpr);
}

}  // namespace

extern "C" {

// out[r, :] = sum over e in [row_ptr[r], row_ptr[r+1]) of
//             w[e] * (idx ? src[idx[e], :] : src[e, :])   (+ self_w[r]*src[r, :])
// src/out: f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), row-major, width f.
// idx: null for the messages form. w, mask, self_w: null when absent.
int kgt_scatter_sum_sorted(const void* src, const int32_t* idx,
                           const int32_t* row_ptr, const void* w, int w_bf16,
                           const uint8_t* mask, const void* self_w,
                           int self_w_bf16, void* out, int64_t n_rows,
                           int64_t f, int is_bf16, void* stream) {
  if (src == nullptr || row_ptr == nullptr || out == nullptr || n_rows <= 0 ||
      f <= 0 || (self_w != nullptr && idx == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = pick_vec(f, is_bf16 ? 2 : 4, src, out);
#define KGT_SCATTER(S, V)                                                  \
  launch_scatter<S, V>(src, idx, row_ptr, w, w_bf16, mask, self_w,         \
                       self_w_bf16, out, n_rows, f, s)
  KGT_VEC_DISPATCH(is_bf16, vec, KGT_SCATTER)
#undef KGT_SCATTER
  return static_cast<int>(cudaGetLastError());
}

// The fused-gather form over pieces: the same out as kgt_scatter_sum_sorted
// with idx and no mask. pieces [n_pieces, 4] int32 (row, first slot, end
// slot, share row or -1), 16-byte aligned, each of at most cap slots, cover
// every row of [0, n_rows) and every slot once; the n_fix rows fix_rows split
// into several pieces are the sum of their shares fix_ptr[k] .. fix_ptr[k +
// 1] in the f32 scratch part [*, f], written before it is read. Two launches:
// the piece walk, then (n_fix > 0) the split rows' merge.
int kgt_gather_scatter_pieces(const void* src, const int32_t* idx,
                              const int32_t* pieces, int64_t n_pieces, int cap,
                              const void* w, int w_bf16, const void* self_w,
                              int self_w_bf16, void* out, float* part,
                              const int32_t* fix_rows, const int32_t* fix_ptr,
                              int64_t n_fix, int64_t n_rows, int64_t f,
                              int is_bf16, void* stream) {
  // idx may be null only for a stream without slots (nothing reads it).
  if (src == nullptr || out == nullptr ||
      !piece_list_ok(pieces, n_pieces, n_rows, cap, n_fix, part, fix_rows,
                     fix_ptr, f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = pick_vec(f, is_bf16 ? 2 : 4, src, out);
  const int4* work = reinterpret_cast<const int4*>(pieces);
  cudaError_t err = cudaSuccess;
#define KGT_PIECES(S, V)                                                    \
  err = launch_pieces<S, V>(src, idx, work, n_pieces, cap, w, w_bf16,       \
                            self_w, self_w_bf16, out, part, f, s)
  KGT_VEC_DISPATCH(is_bf16, vec, KGT_PIECES)
#undef KGT_PIECES
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_fix > 0) {
    const unsigned blocks =
        static_cast<unsigned>((n_fix * f + kThreads - 1) / kThreads);
    if (is_bf16) {
      gather_scatter_merge_kernel<uint16_t><<<blocks, kThreads, 0, s>>>(
          part, fix_rows, fix_ptr, n_fix, static_cast<const uint16_t*>(src),
          self_w, self_w_bf16, static_cast<uint16_t*>(out), f);
    } else {
      gather_scatter_merge_kernel<float><<<blocks, kThreads, 0, s>>>(
          part, fix_rows, fix_ptr, n_fix, static_cast<const float*>(src),
          self_w, self_w_bf16, static_cast<float*>(out), f);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// out[e, :] = rows[recv[e], :] * w[e]   (0 where mask[e] is false)
int kgt_expand_sorted(const void* rows, const int32_t* recv, const void* w,
                      int w_bf16, const uint8_t* mask, void* out,
                      int64_t n_edges, int64_t f, int is_bf16, void* stream) {
  if (rows == nullptr || recv == nullptr || out == nullptr || n_edges <= 0 ||
      f <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = pick_vec(f, is_bf16 ? 2 : 4, rows, out);
#define KGT_EXPAND(S, V) \
  launch_expand<S, V>(rows, recv, w, w_bf16, mask, out, n_edges, f, s)
  KGT_VEC_DISPATCH(is_bf16, vec, KGT_EXPAND)
#undef KGT_EXPAND
  return static_cast<int>(cudaGetLastError());
}

const char* kgt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
