// Hand-written Hopper (sm_90a) kernels for the multi-moment (poly) segment
// reductions: sum, sum of squares, max of [v, -v] and count of the rows of
// each sorted segment, in one pass.  Plain C interface, loaded with ctypes
// by hydragnn_torch/kernels/build.py; wrappers, plain PyTorch versions,
// autograd Functions and launch counters live in
// hydragnn_torch/ops/poly_mp.py.
//
// poly_segment_kernel<kScatter>
//   moments of edge-valued data[e, :] over e in [row_ptr[n], row_ptr[n+1]).
//   Replaces the TPU kernel hydragnn_tpu/ops/poly_mp.py:_poly_scatter_impl
//   (pl.pallas_call at :278; public op segment_poly_dense :359) — PNA's
//   four aggregators and degree.
// poly_segment_kernel<kGather>
//   the same moments of v = x[senders[e], :] * mask[e], with no [E, F]
//   message tensor in memory.  Replaces _poly_gather_impl (pl.pallas_call
//   at :342; public op gather_poly_segment :428) — SAGE's and MFC's
//   neighbour sum and degree.
//
// Outputs, each optional (a null pointer skips the moment, and the
// template mask removes its arithmetic):
//   sum  [N, F]   sum_e v
//   sq   [N, F]   sum_e v * v
//   mxmn [N, 2F]  columns [0, F): max_e v; columns [F, 2F): max_e (-v);
//                 -1e9 on empty segments (the reference's sentinel)
//   cnt  [N]      rows in the segment, as float32
//
// Why this is not the TPU kernel block by block: that one walks a step
// table of (node block, edge block) pairs, places rows with one-hot
// matmuls and finds each run's max with a Hillis-Steele scan because a TPU
// has no per-row loop.  Here one warp owns one output row and walks its CSR
// range in edge order; lanes span the features.
//
// Bound on the H100 SXM: bytes.  Scatter mode reads each real row of data
// once (4 F bytes) and does at most 5 float32 operations per element, ~1
// flop per byte against the card's ~20 flop/byte float32 ridge; the least
// time is (real rows of data + ids + requested outputs) / 3.35 TB/s.
// Gather mode reads x [N, F] (each row again per in-edge, from L2) plus the
// real ids and mask.  Design against that bound: one read of each input
// row feeds every requested moment from registers, each output row is
// written exactly once, masked rows are never read (the wrapper's CSR
// schedule parks them out of every range), and every row access is one
// coalesced 128-byte transaction per 32 columns.  cnt is row_ptr[n+1] -
// row_ptr[n]: no pass over the edges at all.  A warp walking its rows one
// by one waits out a memory latency per row, so the edge loop takes rows
// four at a time: all their loads are started first (in gather mode the ids
// and masks, then the x rows), then the rows enter the sums in edge order,
// so the result has the same bits as a row-by-row walk.  On the H100 at
// F = 64, N = 9680, E = 131k (chip_smoke.py, cold L2) this took gather
// mode from 0.022 to 0.017 ms (sum + count) and from 0.025 to 0.019 ms
// (all moments); scatter mode, which streams contiguous rows, did not
// move.  Still one warp per row however long the row, and no cp.async
// staging (later PRs).
//
// Exactness the backward relies on: max and max(-v) are selected, never
// computed, so each equals the float32 value of one input row bit for bit
// (ties are then found with ==).  In gather mode v = x * mask is the same
// single float32 product the backward recomputes.
//
// Determinism: sums run in edge order in float32 registers; no atomics.
// Every output row is written: empty rows get 0, 0, -1e9 and 0.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;    // one warp per output row
constexpr int kVec = 4;             // columns per lane and pass: 128 a warp
constexpr int kUnroll = 4;          // edge rows whose loads are in flight at once
constexpr float kNeg = -1e9f;       // empty-segment sentinel of mxmn

enum Mode { kScatter = 0, kGather = 1 };
enum Moment { kSum = 1, kSq = 2, kMxMn = 4 };

template <int MODE, int M>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
poly_segment_kernel(const float* __restrict__ src,
                    const int* __restrict__ senders,
                    const float* __restrict__ mask,
                    const int* __restrict__ row_ptr,
                    float* __restrict__ o_sum, float* __restrict__ o_sq,
                    float* __restrict__ o_mxmn, float* __restrict__ o_cnt,
                    int n_rows, int n_src, int f) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= n_rows) return;
  const int e0 = row_ptr[row];
  const int e1 = row_ptr[row + 1];
  if (o_cnt != nullptr && lane == 0) o_cnt[row] = static_cast<float>(e1 - e0);
  if (M == 0) return;
  const size_t base = static_cast<size_t>(row) * f;
  for (int c0 = 0; c0 < f; c0 += kWarp * kVec) {
    float s[kVec], q[kVec], mx[kVec], mn[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      s[j] = 0.f;
      q[j] = 0.f;
      mx[j] = kNeg;
      mn[j] = kNeg;
    }
    // loads of one edge row into registers (0 beyond the width: those
    // columns are never stored)
    auto load = [&](int e, float (&v)[kVec]) {
      const float* r;
      float m = 1.f;
      bool live = true;
      if (MODE == kGather) {
        // a sender outside [0, n_src) sends a zero message (the
        // reference's one-hot window finds no row for it)
        const int sd = senders[e];
        live = static_cast<unsigned>(sd) < static_cast<unsigned>(n_src);
        r = src + static_cast<size_t>(live ? sd : 0) * f;
        m = mask[e];
      } else {
        r = src + static_cast<size_t>(e) * f;
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int c = c0 + j * kWarp + lane;
        v[j] = (c < f && live) ? (MODE == kGather ? r[c] * m : r[c]) : 0.f;
      }
    };
    auto add = [&](const float (&v)[kVec]) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (M & kSum) s[j] += v[j];
        if (M & kSq) q[j] += v[j] * v[j];
        if (M & kMxMn) {
          mx[j] = fmaxf(mx[j], v[j]);
          mn[j] = fmaxf(mn[j], -v[j]);
        }
      }
    };
    int e = e0;
    for (; e + kUnroll <= e1; e += kUnroll) {
      float v[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) load(e + u, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add(v[u]);
    }
    for (; e < e1; ++e) {
      float v[kVec];
      load(e, v);
      add(v);
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int c = c0 + j * kWarp + lane;
      if (c < f) {
        if (M & kSum) o_sum[base + c] = s[j];
        if (M & kSq) o_sq[base + c] = q[j];
        if (M & kMxMn) {
          o_mxmn[2 * base + c] = mx[j];
          o_mxmn[2 * base + f + c] = mn[j];
        }
      }
    }
  }
}

template <int MODE, int M>
void launch(const float* src, const int* senders, const float* mask,
            const int* row_ptr, float* o_sum, float* o_sq, float* o_mxmn,
            float* o_cnt, int n_rows, int n_src, int f, cudaStream_t st) {
  const unsigned grid =
      static_cast<unsigned>((n_rows + kRowsPerBlock - 1) / kRowsPerBlock);
  poly_segment_kernel<MODE, M><<<grid, dim3(kWarp * kRowsPerBlock), 0, st>>>(
      src, senders, mask, row_ptr, o_sum, o_sq, o_mxmn, o_cnt, n_rows, n_src,
      f);
}

template <int MODE>
void dispatch(int m, const float* src, const int* senders, const float* mask,
              const int* row_ptr, float* o_sum, float* o_sq, float* o_mxmn,
              float* o_cnt, int n_rows, int n_src, int f, cudaStream_t st) {
#define HG_POLY_CASE(K)                                                     \
  case K:                                                                   \
    launch<MODE, K>(src, senders, mask, row_ptr, o_sum, o_sq, o_mxmn,       \
                    o_cnt, n_rows, n_src, f, st);                           \
    break;
  switch (m) {
    HG_POLY_CASE(0)
    HG_POLY_CASE(1)
    HG_POLY_CASE(2)
    HG_POLY_CASE(3)
    HG_POLY_CASE(4)
    HG_POLY_CASE(5)
    HG_POLY_CASE(6)
    HG_POLY_CASE(7)
  }
#undef HG_POLY_CASE
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  Pointers are device
// pointers; a null output pointer skips that moment.  `src` is data [E, F]
// (gather == 0; senders and mask unused) or x [n_src, F] (gather != 0).
// The launch goes on `stream` and does not synchronise.
extern "C" int hg_poly_segment_f32(
    const void* src, const void* senders, const void* mask,
    const void* row_ptr, void* o_sum, void* o_sq, void* o_mxmn, void* o_cnt,
    int n_rows, int n_src, int f, int gather, void* stream) {
  if (n_rows <= 0 || f <= 0) return 0;
  const int m = (o_sum ? kSum : 0) | (o_sq ? kSq : 0) | (o_mxmn ? kMxMn : 0);
  if (m == 0 && o_cnt == nullptr) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gather) {
    dispatch<kGather>(m, static_cast<const float*>(src),
                      static_cast<const int*>(senders),
                      static_cast<const float*>(mask),
                      static_cast<const int*>(row_ptr),
                      static_cast<float*>(o_sum), static_cast<float*>(o_sq),
                      static_cast<float*>(o_mxmn), static_cast<float*>(o_cnt),
                      n_rows, n_src, f, st);
  } else {
    dispatch<kScatter>(m, static_cast<const float*>(src), nullptr, nullptr,
                       static_cast<const int*>(row_ptr),
                       static_cast<float*>(o_sum), static_cast<float*>(o_sq),
                       static_cast<float*>(o_mxmn), static_cast<float*>(o_cnt),
                       n_rows, n_src, f, st);
  }
  return static_cast<int>(cudaGetLastError());
}
