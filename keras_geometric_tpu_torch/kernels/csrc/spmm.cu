// Sorted-CSR SpMM kernels for Hopper (sm_90a): scatter-sum and its transpose.
//
// The scatter replaces the TPU scatter of the JAX package's
// kernels/spmm_pallas.py (_scatter_impl and _scatter_block_impl behind
// scatter_sum_sorted):
//     out[r, :] = sum_{e in row_ptr[r] .. row_ptr[r+1]} w[e] * message(e)
// The TPU has no vector gather, so its kernel multiplies a one-hot indicator
// into the messages on the matrix unit (2*E*ROW_BLOCK*F operations). This card
// gathers, so the work is one multiply-add per (edge, feature) and the kernel
// is bound by bytes: every message row is read once, every output row written
// once, plus the index and weight streams. No atomics on data: the order of
// every sum is fixed by the slots and a host-built work list, so results are
// bit-reproducible. Empty rows store zeros. Sums are f32, rounded once, at
// the store.
//
// Where message(e) lives gives two forms:
//   the messages form: src[e, :], an [E, F] array (scatter_messages_kernel);
//   the fused-gather form: src[idx[e], :], rows of a node array gathered in
//     the kernel, so the [E, F] array the TPU path materialises before its
//     scatter never exists here. The source of the arxiv-shaped layer (43 MB
//     in bf16) fits the 50 MB L2, so most of the random reads are served
//     from there. An optional epilogue adds self_w[r] * src[r, :] (the
//     densified diagonal of the GCN operator) before the store.
//
// The messages form walks pieces (scatter_messages_kernel): the work list
// spmm_cuda.recv_bwd_work(row_ptr, split_piece=8) (the score backward's
// list, cached on the same row_ptr) keeps a row of at most 32 slots whole and
// cuts a longer row (a hub, or the padded tail that prepare_graph puts in the
// last row) into pieces of 8, so no thread walks a long chain of dependent
// loads. A piece's messages are one contiguous block of rows, so the kernel
// maps one thread to each (piece, 16-byte column pack), flat, with no lane
// idle whatever the pack count (20 packs at F = 160 bf16), and each thread
// streams its column of the block with eight slots' loads in flight, adding
// w * message rounded to f32 in slot order (add_message<S, VEC, false>'s
// add). A whole row stores its sum rounded once: a serial walk's bits. A
// piece of a split row stores its f32 share and takes an arrival ticket (one
// int per split row and column pack, kept zeroed beside the work list); the
// thread that draws the last ticket adds the row's shares in piece order,
// stores the row and returns the ticket to zero, in the same launch; blocks
// take the list from its end, so that merge of the padded tail (the last
// row) overlaps the rest of the walk. The tickets assume that calls over one
// work list run one after another, on one stream: the port launches every
// kernel on the current stream and never overlaps two of them.
//
// The fused-gather form has two walks. The row walk
// (scatter_sum_sorted_kernel, which the GCN's operator takes) gives each row
// to a sub-warp of `lpr` lanes that lie across the feature axis, each loading
// VEC contiguous values (16 bytes where the width and the alignment allow, a
// scalar otherwise, so any F >= 1 works), four edges in flight per lane. One
// long row (a hub, or the padded tail, which in sender order piles into the
// last sender's row: 521 slots at CiteSeer's GATv2 shape) keeps that whole
// kernel waiting on its dependent rounds of random reads. The piece walk
// (gather_scatter_pieces_kernel; gather_pieces.cuh, which band.cu's window
// scatter shares) takes the work list spmm_cuda.recv_bwd_work (one per
// row_ptr tensor, the list the attention kernels walk) that cuts every row
// into pieces of at most 32 slots, stages each piece's indices and weights,
// keeps the next eight gathered rows in flight in a cp.async ring and sums
// them in f32 in slot order; a split row's shares are added in piece order by
// a second launch (gather_scatter_merge_kernel). In both walks a message is
// added with one fused multiply-add (fmaf), so a row that is one piece gets
// the row walk's bits.
//
// expand_sorted_kernel replaces _expand_impl (expand_sorted) of the same
// file: out[e, :] = rows[recv[e], :] * w[e], the scatter's transpose and its
// VJP. The TPU kernel again multiplies by a one-hot matrix; here threads lie
// on the flat (slot, pack) index of the contiguous [E, F] output, so every
// warp stores 32 neighbouring packs at any F, 16 bytes of output a thread
// (one pack, or four of 4 bytes) with their loads in flight together. Bound
// by bytes: E*F values written, the node
// rows read (sorted receivers make neighbouring slots re-read the same row
// from cache). One f32 product and one rounding: the plain version's bits.
//
// All offsets into data are 64-bit. Indices and row_ptr are int32.
// The C entry points launch on the given stream, allocate nothing, do not
// synchronise, and return cudaGetLastError().

#include "fast_div.cuh"
#include "gather_pieces.cuh"
#include "tickets.cuh"

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

// ---------------------------------------------------------------------------
// The messages form over pieces, and expand, on flat (item, pack) indices
// ---------------------------------------------------------------------------

constexpr int kInFlight = 8;  // slots a messages-form thread loads at once

// (slot, pack) items an expand thread serves: 16 bytes of output (one
// 16-byte pack, or as many narrower packs).
template <typename S, int VEC>
__host__ __device__ constexpr int expand_items() {
  return 16 / (VEC * static_cast<int>(sizeof(S)));
}

// VEC f32 values of a share row, stored (tickets.cuh's load_share reads
// them back).
template <int VEC>
__device__ __forceinline__ void store_share(float* p, const float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      *reinterpret_cast<float4*>(p + j) = make_float4(v[j], v[j + 1],
                                                      v[j + 2], v[j + 3]);
    }
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// One thread per (piece, column pack) of the pieces [pieces, pieces +
// n_pieces) (the host launches a long list in parts, each of fewer than
// 2^31 items). pieces[p] = (row, first slot, end slot, share): share is -1
// where the piece is its whole row, else its row in the f32 scratch part
// [*, f]; tickets[k * chunks + c] counts the pieces of split row k whose
// pack c is in part. WEIGHTED / MASKED: whether w / mask are given (each
// absent one costs no register a slot). A window's slots past the piece's
// end load its last slot again and add +0.0, which leaves an f32 sum that
// starts at +0.0 as it is, so every window runs unpredicated.
template <typename S, int VEC, bool WEIGHTED, bool MASKED>
__global__ void __launch_bounds__(kThreads)
scatter_messages_kernel(const S* __restrict__ src,
                        const int4* __restrict__ pieces, int64_t n_pieces,
                        FastDiv chunks, const void* __restrict__ w,
                        int w_bf16, const uint8_t* __restrict__ mask,
                        S* __restrict__ out, float* __restrict__ part,
                        const int32_t* __restrict__ fix_rows,
                        const int32_t* __restrict__ fix_ptr, int64_t n_fix,
                        int32_t* __restrict__ tickets, int64_t f) {
  // Blocks take the list from its end, so the padded tail's pieces (the
  // last row's) run first and their merge overlaps the rest of the launch.
  const int64_t item =
      static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kThreads +
      threadIdx.x;
  if (item >= n_pieces * chunks.d) return;
  const uint32_t p = fast_div(chunks, static_cast<uint32_t>(item));
  const uint32_t c = static_cast<uint32_t>(item) - p * chunks.d;
  const int64_t col = static_cast<int64_t>(c) * VEC;
  const int4 pc = pieces[p];

  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
  const int32_t end = pc.z - 1;
  for (int32_t e = pc.y; e < pc.z; e += kInFlight) {
    Pack<S, VEC> v[kInFlight];
    float ww[kInFlight];
    bool ok[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const int32_t at = e + k < end ? e + k : end;
      ok[k] = e + k <= end;
      if constexpr (MASKED) ok[k] = ok[k] && mask[at] != 0;
      ww[k] = WEIGHTED ? load_weight(w, w_bf16, at) : 1.0f;
      v[k] = load_pack<S, VEC>(src + static_cast<int64_t>(at) * f + col);
    }
    // add_message<S, VEC, false>'s add with the product rounded by
    // __fmul_rn, which the compiler never contracts into a multiply-add
    // (it did contract `w * v + acc` in a bulk-copy variant of this walk
    // whose `ok` was a constant, PERF.md): a serial walk's bits.
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float x = WEIGHTED ? __fmul_rn(ww[k], Cvt<S>::to_f(v[k].v[j]))
                                 : Cvt<S>::to_f(v[k].v[j]);
        acc[j] += ok[k] ? x : 0.0f;
      }
    }
  }

  if (pc.w < 0) {  // the whole row
    Pack<S, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) o.v[j] = Cvt<S>::from_f(acc[j]);
    store_pack<S, VEC>(out + static_cast<int64_t>(pc.x) * f + col, o);
    return;
  }

  // A share of a split row: store it, then take the row's ticket for this
  // pack; the last of its pieces to arrive adds the shares in piece order.
  store_share<VEC>(part + static_cast<int64_t>(pc.w) * f + col, acc);
  const int64_t k = find_split_row(fix_rows, n_fix, pc.x);
  const int32_t first = fix_ptr[k];
  const int32_t last = fix_ptr[k + 1];
  int32_t* ticket = tickets + k * chunks.d + c;
  if (take_ticket(ticket) != last - first - 1) return;
  // Shares in flight: 32 floats at VEC = 8 (bf16 packs), 16 below, where
  // 32 raised the walk's registers and slowed it (PERF.md).
  constexpr int kShares = VEC >= 8 ? 32 / VEC : 16 / VEC;
  float sum[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) sum[j] = 0.0f;
  for (int32_t s = first; s < last; s += kShares) {
    float v[kShares][VEC];
#pragma unroll
    for (int i = 0; i < kShares; ++i) {
      if (s + i < last) {
        load_share<VEC>(v[i], part + static_cast<int64_t>(s + i) * f + col);
      }
    }
#pragma unroll
    for (int i = 0; i < kShares; ++i) {
      if (s + i < last) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) sum[j] += v[i][j];
      }
    }
  }
  Pack<S, VEC> o;
#pragma unroll
  for (int j = 0; j < VEC; ++j) o.v[j] = Cvt<S>::from_f(sum[j]);
  store_pack<S, VEC>(out + static_cast<int64_t>(pc.x) * f + col, o);
  *ticket = 0;
}

// out[e, :] = rows[recv[e], :] * w[e] over the flat items i = e * chunks + c
// (c the pack) of [recv, recv + n_items / chunks): a block serves
// kThreads * expand_items() neighbouring items, a thread every kThreads-th
// of them, all loads in flight before the stores. WEIGHTED / MASKED: whether
// w / mask are given. (On the H100 four 16-byte
// items a thread, against one, took the composed arxiv run's expand 0.3428
// -> 0.3355 ms at F = 256 bf16 but 0.2186 -> 0.2255 at 160, and the
// Cora-shaped one 0.0067 -> 0.0087: a small grid then leaves SMs idle;
// at F = 1,433 f32, 4-byte packs, four items took 0.0770 -> 0.0389. PERF.md)
template <typename S, int VEC, bool WEIGHTED, bool MASKED>
__global__ void __launch_bounds__(kThreads)
expand_sorted_kernel(const S* __restrict__ rows,
                     const int32_t* __restrict__ recv,
                     const void* __restrict__ w, int w_bf16,
                     const uint8_t* __restrict__ mask, S* __restrict__ out,
                     int64_t n_items, FastDiv chunks, int64_t f) {
  constexpr int kItems = expand_items<S, VEC>();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * kItems +
                       threadIdx.x;
  Pack<S, VEC> v[kItems];
  float ww[kItems];
  bool ok[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k * kThreads;
    if (i < n_items) {
      const uint32_t e = fast_div(chunks, static_cast<uint32_t>(i));
      const uint32_t c = static_cast<uint32_t>(i) - e * chunks.d;
      ww[k] = WEIGHTED ? load_weight(w, w_bf16, e) : 1.0f;
      ok[k] = !MASKED || mask[e] != 0;
      v[k] = load_pack<S, VEC>(rows + static_cast<int64_t>(recv[e]) * f +
                               static_cast<int64_t>(c) * VEC);
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k * kThreads;
    if (i < n_items) {
      Pack<S, VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float x = WEIGHTED ? __fmul_rn(ww[k], Cvt<S>::to_f(v[k].v[j]))
                                 : Cvt<S>::to_f(v[k].v[j]);
        o.v[j] = Cvt<S>::from_f(ok[k] ? x : 0.0f);
      }
      store_pack<S, VEC>(out + i * VEC, o);
    }
  }
}

// Items of one launch of the flat kernels: fewer than 2^31, whole slots or
// pieces of `chunks` items each.
inline int64_t per_launch(int64_t chunks) {
  return ((static_cast<int64_t>(1) << 31) - 1) / chunks;
}

template <typename S, int VEC>
void launch_messages(const void* src, const int4* pieces, int64_t n_pieces,
                     const void* w, int w_bf16, const uint8_t* mask,
                     void* out, float* part, const int32_t* fix_rows,
                     const int32_t* fix_ptr, int64_t n_fix, int32_t* tickets,
                     int64_t f, cudaStream_t stream) {
  const int64_t chunks = f / VEC;
  const FastDiv q = make_fast_div(static_cast<uint32_t>(chunks));
  const int64_t step = per_launch(chunks);
  auto kernel = &scatter_messages_kernel<S, VEC, false, false>;
  if (w == nullptr && mask != nullptr) {
    kernel = &scatter_messages_kernel<S, VEC, false, true>;
  } else if (w != nullptr) {
    kernel = mask == nullptr ? &scatter_messages_kernel<S, VEC, true, false>
                             : &scatter_messages_kernel<S, VEC, true, true>;
  }
  for (int64_t p0 = 0; p0 < n_pieces; p0 += step) {
    const int64_t n = n_pieces - p0 < step ? n_pieces - p0 : step;
    const unsigned blocks =
        static_cast<unsigned>((n * chunks + kThreads - 1) / kThreads);
    kernel<<<blocks, kThreads, 0, stream>>>(
        static_cast<const S*>(src), pieces + p0, n, q, w, w_bf16, mask,
        static_cast<S*>(out), part, fix_rows, fix_ptr, n_fix, tickets, f);
  }
}

template <typename S, int VEC>
void launch_expand(const void* rows, const int32_t* recv, const void* w,
                   int w_bf16, const uint8_t* mask, void* out,
                   int64_t n_edges, int64_t f, cudaStream_t stream) {
  const int64_t chunks = f / VEC;
  const FastDiv q = make_fast_div(static_cast<uint32_t>(chunks));
  const int64_t step = per_launch(chunks);
  const size_t w_size = w_bf16 ? 2 : 4;
  auto kernel = &expand_sorted_kernel<S, VEC, false, false>;
  if (w == nullptr && mask != nullptr) {
    kernel = &expand_sorted_kernel<S, VEC, false, true>;
  } else if (w != nullptr) {
    kernel = mask == nullptr ? &expand_sorted_kernel<S, VEC, true, false>
                             : &expand_sorted_kernel<S, VEC, true, true>;
  }
  for (int64_t e0 = 0; e0 < n_edges; e0 += step) {
    const int64_t n = n_edges - e0 < step ? n_edges - e0 : step;
    const int64_t per_block =
        static_cast<int64_t>(kThreads) * expand_items<S, VEC>();
    const unsigned blocks =
        static_cast<unsigned>((n * chunks + per_block - 1) / per_block);
    kernel<<<blocks, kThreads, 0, stream>>>(
        static_cast<const S*>(rows), recv + e0,
        w == nullptr ? nullptr
                     : static_cast<const uint8_t*>(w) + e0 * w_size,
        w_bf16, mask == nullptr ? nullptr : mask + e0,
        static_cast<S*>(out) + e0 * f, n * chunks, q, f);
  }
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
  scatter_sum_sorted_kernel<S, VEC, true><<<grid, kThreads, 0, stream>>>(
      static_cast<const S*>(src), idx, row_ptr, w, w_bf16, mask, self_w,
      self_w_bf16, static_cast<S*>(out), n_rows, f, lpr);
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

}  // namespace

extern "C" {

// The fused-gather form's row walk:
// out[r, :] = sum over e in [row_ptr[r], row_ptr[r+1]) of
//             w[e] * src[idx[e], :]   (+ self_w[r] * src[r, :])
// src/out: f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), row-major, width f.
// w, mask, self_w: null when absent.
int kgt_scatter_sum_sorted(const void* src, const int32_t* idx,
                           const int32_t* row_ptr, const void* w, int w_bf16,
                           const uint8_t* mask, const void* self_w,
                           int self_w_bf16, void* out, int64_t n_rows,
                           int64_t f, int is_bf16, void* stream) {
  if (src == nullptr || idx == nullptr || row_ptr == nullptr ||
      out == nullptr || n_rows <= 0 || f <= 0) {
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

// The messages form over pieces: out[r, :] = sum over the slots e of row r
// of w[e] * src[e, :] (nothing where mask[e] is false). pieces [n_pieces, 4]
// int32 (row, first slot, end slot, share row or -1), 16-byte aligned, each
// of at most cap slots, cover every row of [0, n_rows) and every slot once;
// the n_fix rows fix_rows split into several pieces are the sum of their
// shares fix_ptr[k] .. fix_ptr[k + 1] in the f32 scratch part [*, f], added
// by the last of the row's pieces to arrive (tickets: n_fix * f int32 zeros,
// left zero). One launch (a list of 2^31 or more (piece, pack) items in
// parts).
int kgt_scatter_messages(const void* src, const int32_t* pieces,
                         int64_t n_pieces, int cap, const void* w, int w_bf16,
                         const uint8_t* mask, void* out, float* part,
                         const int32_t* fix_rows, const int32_t* fix_ptr,
                         int64_t n_fix, int32_t* tickets, int64_t n_rows,
                         int64_t f, int is_bf16, void* stream) {
  if (src == nullptr || out == nullptr || (n_fix > 0 && tickets == nullptr) ||
      !piece_list_ok(pieces, n_pieces, n_rows, cap, n_fix, part, fix_rows,
                     fix_ptr, f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = pick_vec(f, is_bf16 ? 2 : 4, src, out);
  const int4* work = reinterpret_cast<const int4*>(pieces);
#define KGT_MESSAGES(S, V)                                                   \
  launch_messages<S, V>(src, work, n_pieces, w, w_bf16, mask, out, part,     \
                        fix_rows, fix_ptr, n_fix, tickets, f, s)
  KGT_VEC_DISPATCH(is_bf16, vec, KGT_MESSAGES)
#undef KGT_MESSAGES
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
