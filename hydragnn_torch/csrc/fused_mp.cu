// Hand-written Hopper (sm_90a) kernels for the two sorted-segment
// reductions on the SchNet prediction path.  Plain C interface, loaded with
// ctypes by hydragnn_torch/kernels/build.py; wrappers, plain PyTorch
// versions and launch counters live in hydragnn_torch/ops/fused_mp.py.
//
// gather_mul_segment_sum_kernel
//   out[n, f] = sum_{e in [row_ptr[n], row_ptr[n+1])} x[send[e], f] * w[e, f]
//   (or * mask[e] in the no-w mode, the reference's gather_segment_sum).
//   Replaces the TPU kernel hydragnn_tpu/ops/fused_mp.py:_fused_impl
//   (pl.pallas_call at :171; public ops gather_mul_segment_sum :182 and
//   gather_segment_sum :247).
//   Bound on the H100 SXM: bytes.  Per call it must read x [N,F], the
//   valid rows of w [E_valid,F], the valid ids, and write out [N,F]; at
//   2*E_valid*F flops that is ~0.5 flop/byte, far below the card's
//   ~20 flop/byte float32 ridge, so the least time is bytes / 3.35 TB/s.
//   Design against that bound: the [E,F] message tensor is never written
//   (gather, multiply and sum happen in registers), each output row is
//   written exactly once, and masked edges are never read because the
//   CSR schedule parks them out of every row's range.  Lanes of a warp
//   span F, so every x, w and out row access is one coalesced 128-byte
//   transaction per 32 columns.  First version: no cp.async/TMA staging
//   of x rows, no persistent grid (later PRs).
//
// segment_sum_dense_kernel
//   out[s, f] = sum_{r in [row_ptr[s], row_ptr[s+1])} data[perm[r], f]
//   (perm null: data[r, f]), over at most the first max_rows rows of each
//   segment (the reference's max_per_segment contract; INT_MAX otherwise).
//   Replaces hydragnn_tpu/ops/fused_mp.py:_scatter_impl (pl.pallas_call at
//   :340; public op segment_sum_dense :350).  Bound: bytes (read the valid
//   rows of data once, write out once; 1 flop per 4-byte element).  Same
//   warp-per-segment design: contiguous rows, coalesced across lanes.
//   With a row permutation it also replaces the two kernels of the
//   reference's `pallas` aggregation backend, both plain segment sums:
//   hydragnn_tpu/ops/aggregate.py:_pallas_segment_sum_impl (pl.pallas_call
//   at :157, any id order: a blocked one-hot contraction on the MXU) and
//   :_sorted_impl (:244, nondecreasing ids).  On Hopper the one-hot tile
//   is wasted work: the wrapper's stable sort of the ids is the schedule
//   (perm, CSR offsets, out-of-range ids parked past the last segment) and
//   each warp sums its segment's rows in id-then-edge order through perm.
//   Same bound (bytes), plus the 4-byte perm entry per row.  The sorted
//   function's cap keeps collate's padding segment (every padding edge on
//   node N-1, pre-masked to zeros) from holding one warp for thousands of
//   rows, as the reference's cap drops those rows.
//
// Contract shared with the reference kernels (collate guarantees it):
// rows/edges are sorted by output id, so each output row owns one
// contiguous CSR range; masked rows sort last and are parked out of range
// by the wrapper's schedule.  The reference's TPU kernel gathers senders
// through a +-1 node-block window and drops out-of-window senders; collate
// attaches the kernel marker only when every graph fits one block, so
// every real sender lies in the window and global indexing here gives the
// same answer.  Senders outside [0, n_src) contribute nothing.
//
// Determinism: one warp owns each output row and adds its edges in edge
// order into float32 registers.  No atomics, no [E,F] intermediate; the
// result is bit-identical from run to run.  Every output row is written,
// empty rows (zero-length ranges) as zeros.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;    // one warp per output row
constexpr int kVec = 4;             // accumulators per lane: 128 columns per pass

enum Mode { kMulW = 0, kMask = 1 };

template <int MODE>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
gather_mul_segment_sum_kernel(const float* __restrict__ x,
                              const float* __restrict__ w,
                              const float* __restrict__ mask,
                              const int* __restrict__ senders,
                              const int* __restrict__ row_ptr,
                              float* __restrict__ out,
                              int n_rows, int n_src, int f) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= n_rows) return;
  const int e0 = row_ptr[row];
  const int e1 = row_ptr[row + 1];
  float* out_row = out + static_cast<size_t>(row) * f;
  for (int c0 = 0; c0 < f; c0 += kWarp * kVec) {
    float acc[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
    for (int e = e0; e < e1; ++e) {
      const int s = senders[e];
      if (static_cast<unsigned>(s) >= static_cast<unsigned>(n_src)) continue;
      const float* xs = x + static_cast<size_t>(s) * f;
      if (MODE == kMulW) {
        const float* we = w + static_cast<size_t>(e) * f;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const int c = c0 + j * kWarp + lane;
          if (c < f) acc[j] += xs[c] * we[c];
        }
      } else {
        const float m = mask[e];
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const int c = c0 + j * kWarp + lane;
          if (c < f) acc[j] += xs[c] * m;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int c = c0 + j * kWarp + lane;
      if (c < f) out_row[c] = acc[j];
    }
  }
}

// PERM is a template parameter so that the dense sum (the pool) keeps a
// loop whose row addresses the compiler can run ahead of: a run-time
// "perm or not" inside the row loop halved the pool's speed on its long
// padding segment.
template <bool PERM>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
segment_sum_dense_kernel(const float* __restrict__ data,
                         const int* __restrict__ perm,
                         const int* __restrict__ row_ptr,
                         float* __restrict__ out, int n_seg, int f,
                         int max_rows) {
  const int lane = threadIdx.x % kWarp;
  const int seg = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (seg >= n_seg) return;
  const int r0 = row_ptr[seg];
  int r1 = row_ptr[seg + 1];
  if (r1 - r0 > max_rows) r1 = r0 + max_rows;
  float* out_row = out + static_cast<size_t>(seg) * f;
  for (int c0 = 0; c0 < f; c0 += kWarp * kVec) {
    float acc[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
    for (int r = r0; r < r1; ++r) {
      const int row = PERM ? perm[r] : r;
      const float* dr = data + static_cast<size_t>(row) * f;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int c = c0 + j * kWarp + lane;
        if (c < f) acc[j] += dr[c];
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int c = c0 + j * kWarp + lane;
      if (c < f) out_row[c] = acc[j];
    }
  }
}

inline unsigned grid_for(int rows) {
  return static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  Pointers are device
// pointers; the launch goes on `stream` and does not synchronise.
extern "C" int hg_gather_mul_segment_sum_f32(
    const void* x, const void* w, const void* mask, const void* senders,
    const void* row_ptr, void* out, int n_rows, int n_src, int f, int has_w,
    void* stream) {
  if (n_rows <= 0 || f <= 0) return 0;
  const dim3 block(kWarp * kRowsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (has_w) {
    gather_mul_segment_sum_kernel<kMulW><<<grid_for(n_rows), block, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), nullptr,
        static_cast<const int*>(senders), static_cast<const int*>(row_ptr),
        static_cast<float*>(out), n_rows, n_src, f);
  } else {
    gather_mul_segment_sum_kernel<kMask><<<grid_for(n_rows), block, 0, st>>>(
        static_cast<const float*>(x), nullptr, static_cast<const float*>(mask),
        static_cast<const int*>(senders), static_cast<const int*>(row_ptr),
        static_cast<float*>(out), n_rows, n_src, f);
  }
  return static_cast<int>(cudaGetLastError());
}

// `perm` (may be null) maps a CSR position to its data row; each segment
// sums at most its first `max_rows` rows.
extern "C" int hg_segment_sum_rows_f32(const void* data, const void* perm,
                                       const void* row_ptr, void* out,
                                       int n_seg, int f, int max_rows,
                                       void* stream) {
  if (n_seg <= 0 || f <= 0) return 0;
  if (max_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kWarp * kRowsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (perm != nullptr) {
    segment_sum_dense_kernel<true><<<grid_for(n_seg), block, 0, st>>>(
        static_cast<const float*>(data), static_cast<const int*>(perm),
        static_cast<const int*>(row_ptr), static_cast<float*>(out), n_seg, f,
        max_rows);
  } else {
    segment_sum_dense_kernel<false><<<grid_for(n_seg), block, 0, st>>>(
        static_cast<const float*>(data), nullptr,
        static_cast<const int*>(row_ptr), static_cast<float*>(out), n_seg, f,
        max_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
