// Hand-written Hopper (sm_90a) kernels for the multi-moment (poly) segment
// reductions: sum, sum of squares, max of [v, -v] and count of the rows of
// each sorted segment, in one pass.  Plain C interface, loaded with ctypes
// by hydragnn_torch/kernels/build.py; wrappers, plain PyTorch versions,
// autograd Functions and launch counters live in
// hydragnn_torch/ops/poly_mp.py.
//
// r1::poly_scatter_kernel (route 1) and poly_segment_kernel<kScatter>
// (route 2)
//   moments of edge-valued data[e, :] over e in [row_ptr[n], row_ptr[n+1]).
//   Replaces the TPU kernel hydragnn_tpu/ops/poly_mp.py:_poly_scatter_impl
//   (pl.pallas_call at :278; public op segment_poly_dense :359) — PNA's
//   four aggregators and degree.
// poly_segment_kernel<kGather> (route 2 only)
//   the same moments of v = x[senders[e], :] * mask[e], with no [E, F]
//   message tensor in memory.  Replaces _poly_gather_impl (pl.pallas_call
//   at :342; public op gather_poly_segment :428) — SAGE's and MFC's
//   neighbour sum and degree.  Its redesign is later work (ROADMAP B6).
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
// has no per-row loop.  Here warps walk CSR ranges in edge order; lanes
// span the features.
//
// Bound on the H100 SXM: bytes.  Scatter mode reads each real row of data
// once (4 F bytes) and does at most 5 float32 operations per element, ~1
// flop per byte against the card's ~20 flop/byte float32 ridge; the least
// time is (real rows of data + ids + requested outputs) / 3.35 TB/s.
// Gather mode reads x [N, F] (each row again per in-edge, from L2) plus the
// real ids and mask.  Both routes against that bound: one read of each
// input row feeds every requested moment from registers, each output row
// is written exactly once, masked rows are never read (the wrapper's CSR
// schedule parks them out of every range), and cnt is row_ptr[n+1] -
// row_ptr[n]: no pass over the edges at all.
//
// Route 2 (the first design; hg_poly_segment_route: odd F, F past 128,
// and gather mode at every F): one warp per output row in blocks of 8,
// lanes on columns lane + 32 j of 128 a pass (at F = 64 half the
// accumulators are masked off), 4 rows' loads in flight, restarting at
// every row boundary.
// Route 1 (scatter mode at even F up to 128, PNA's 64 among them), the
// gather-multiply's route-1 recipe on contiguous rows:
// - the grid is sized to the blocks the card holds (8 warps a block), and
//   each warp takes one walk::share_rows share of the rows (rows plus
//   edges balanced, no row split); a share's edge rows are one contiguous
//   range of data, so the loads run on across row boundaries (8 rows in
//   flight) and a row's moments are written when its range ends
//   (walk::Cursor: a shuffle a boundary);
// - a lane takes a float2 (a 64-column row is one 256-byte access); past
//   64 columns a walk takes two 64-column chunks (4 rows in flight, so
//   still 8 float2s a lane), and a forced route 1 past 128 columns loops
//   over 128-column pairs;
// - the rows are read cache-streaming (walk::ldcs2: evict-first, read
//   once).
// Each column of a row is summed in edge order with route 2's expressions
// (s += v, q += v * v under the same contraction, max and min selected),
// so route 1 gives route 2's bits for every moment subset.
// Measured (NVIDIA H100 80GB HBM3, 700 W; python3 fused_mp_variants.py
// --which rows: chip_smoke.py's first flagship batch, all moments, cold
// after chip_smoke's memset flush, which leaves L2 dirty): at F = 64
// route 1 0.0246 ms, route 2 0.0267; of route 1's time an empty launch
// of its grid takes 0.0050 and the share search 0.0032.  After a
// read-only flush (L2 left clean) the two routes tie at ~0.020, and
// route 2 with streaming loads (r2_ldcs) ties route 1 cold (0.0243).
// On the path route 1 gains more: PNA's 24 poly launches of a profiled
// train epoch (--which path; 18 at F = 64 on route 1, 6 at a width that
// takes route 2) take 0.324 ms with route 1, 0.405 with route 2 alone
// and 0.361 with route 2's streaming-load copy, so route 1 stays.  At
// F = 256 the search costs more than the walk gains (route 1 0.0734,
// route 2 0.0710), so route 2 takes F past 128.  Float4 lanes, more rows
// in flight, other block sizes and equal row counts in place of the
// search were tried in edited copies and were not faster at F = 64.
//
// Exactness the backward relies on: max and max(-v) are selected, never
// computed, so each equals the float32 value of one input row bit for bit
// (ties are then found with ==).  In gather mode v = x * mask is the same
// single float32 product the backward recomputes.
//
// Determinism: sums run in edge order in float32 registers; no atomics.
// Every output row is written: empty rows get 0, 0, -1e9 and 0.

#include <cuda_runtime.h>

#include "row_walk.cuh"

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

// ---------------------------------------------------------------------------
// route 1 of the scatter mode (see above)
// ---------------------------------------------------------------------------
namespace r1 {

constexpr int kWarps = 8;         // warps a block
constexpr int kU = 8;             // edge rows in flight a warp at NC = 1
constexpr int kCols = 2 * kWarp;  // columns a chunk: a float2 a lane

// NC chunks of 64 columns a walk: lane l holds columns c0 + 64 j + 2 l
template <int M, int NC>
__global__ void __launch_bounds__(kWarp * kWarps)
poly_scatter_kernel(const float* __restrict__ data,
                    const int* __restrict__ row_ptr,
                    float* __restrict__ o_sum, float* __restrict__ o_sq,
                    float* __restrict__ o_mxmn, float* __restrict__ o_cnt,
                    int n_rows, int f) {
  const int lane = threadIdx.x & 31;
  int rb, re, p0, p1;
  walk::share_rows(row_ptr, n_rows, blockIdx.x * kWarps + threadIdx.x / kWarp,
                   gridDim.x * kWarps, rb, re, p0, p1);
  if (rb >= re) return;
  if (o_cnt != nullptr)
    for (int r = rb + lane; r < re; r += kWarp)
      o_cnt[r] = static_cast<float>(__ldg(row_ptr + r + 1) -
                                    __ldg(row_ptr + r));
  if (M == 0) return;
  for (int c0 = 0; c0 < f; c0 += NC * kCols) {
    bool on[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) on[j] = c0 + j * kCols + 2 * lane < f;
    float2 s[NC], q[NC], mx[NC], mn[NC];
    auto reset = [&]() {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        s[j] = q[j] = make_float2(0.f, 0.f);
        mx[j] = mn[j] = make_float2(kNeg, kNeg);
      }
    };
    reset();
    auto put = [&](int r) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        if (!on[j]) continue;
        const int col = c0 + j * kCols + 2 * lane;
        const size_t o = static_cast<size_t>(r) * f + col;
        if (M & kSum) walk::st2(o_sum + o, s[j]);
        if (M & kSq) walk::st2(o_sq + o, q[j]);
        if (M & kMxMn) {
          walk::st2(o_mxmn + 2 * static_cast<size_t>(r) * f + col, mx[j]);
          walk::st2(o_mxmn + 2 * static_cast<size_t>(r) * f + f + col,
                    mn[j]);
        }
      }
      reset();
    };
    // route 2's expressions, column by column, in edge order
    auto add = [&](int j, float2 v) {
      if (M & kSum) {
        s[j].x += v.x;
        s[j].y += v.y;
      }
      if (M & kSq) {
        q[j].x += v.x * v.x;
        q[j].y += v.y * v.y;
      }
      if (M & kMxMn) {
        mx[j].x = fmaxf(mx[j].x, v.x);
        mx[j].y = fmaxf(mx[j].y, v.y);
        mn[j].x = fmaxf(mn[j].x, -v.x);
        mn[j].y = fmaxf(mn[j].y, -v.y);
      }
    };
    walk::Cursor cur;
    cur.init(row_ptr, n_rows, rb);
    // rows in flight: kU float2s a lane whatever NC
    constexpr int U = kU / NC;
    for (int base = p0; base < p1; base += U) {
      float2 v[U][NC];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          v[u][j] = make_float2(0.f, 0.f);
          if (base + u < p1 && on[j])
            v[u][j] = walk::ldcs2(data + static_cast<size_t>(base + u) * f +
                                 c0 + j * kCols + 2 * lane);
        }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (base + u >= p1) break;
        while (base + u >= cur.end) {
          put(cur.row);
          cur.next();
        }
#pragma unroll
        for (int j = 0; j < NC; ++j) add(j, v[u][j]);
      }
    }
    // the row of the last edge (rb when the share has none), then the
    // share's rows past it, which have no edge
    put(cur.row);
    for (int r = cur.row + 1; r < re; ++r) put(r);
  }
}

template <int M, int NC>
cudaError_t launch_nc(const float* data, const int* row_ptr, float* o_sum,
                      float* o_sq, float* o_mxmn, float* o_cnt, int n_rows,
                      int f, cudaStream_t st) {
  int grid = 0;
  const cudaError_t err = walk::persistent_grid(
      poly_scatter_kernel<M, NC>, kWarps, n_rows, kWarps, &grid);
  if (err != cudaSuccess) return err;
  poly_scatter_kernel<M, NC><<<grid, kWarp * kWarps, 0, st>>>(
      data, row_ptr, o_sum, o_sq, o_mxmn, o_cnt, n_rows, f);
  return cudaGetLastError();
}

// one 64-column chunk a walk at 64 columns or fewer, else two
template <int M>
cudaError_t launch(const float* data, const int* row_ptr, float* o_sum,
                   float* o_sq, float* o_mxmn, float* o_cnt, int n_rows,
                   int f, cudaStream_t st) {
  return f <= kCols ? launch_nc<M, 1>(data, row_ptr, o_sum, o_sq, o_mxmn,
                                      o_cnt, n_rows, f, st)
                    : launch_nc<M, 2>(data, row_ptr, o_sum, o_sq, o_mxmn,
                                      o_cnt, n_rows, f, st);
}

cudaError_t dispatch(int m, const float* data, const int* row_ptr,
                     float* o_sum, float* o_sq, float* o_mxmn, float* o_cnt,
                     int n_rows, int f, cudaStream_t st) {
#define HG_POLY_R1_CASE(K)                                                 \
  case K:                                                                  \
    return launch<K>(data, row_ptr, o_sum, o_sq, o_mxmn, o_cnt, n_rows, f, \
                     st);
  switch (m) {
    HG_POLY_R1_CASE(0)
    HG_POLY_R1_CASE(1)
    HG_POLY_R1_CASE(2)
    HG_POLY_R1_CASE(3)
    HG_POLY_R1_CASE(4)
    HG_POLY_R1_CASE(5)
    HG_POLY_R1_CASE(6)
    default:
      HG_POLY_R1_CASE(7)
  }
#undef HG_POLY_R1_CASE
}

}  // namespace r1

// whether route 1 takes width f: scatter mode, f even (a float2 a lane)
inline bool route1_takes(int f, int gather) {
  return !gather && f > 0 && f % 2 == 0;
}

// the route of the poly kernel at width f: 1 in scatter mode at even f up
// to 128 (two chunks a walk); 2 (the first design) at odd f, past 128
// (where it was the faster: fused_mp_variants.py) and in gather mode
inline int poly_segment_route(int f, int gather) {
  return route1_takes(f, gather) && f <= 2 * r1::kCols ? 1 : 2;
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

extern "C" int hg_poly_segment_route(int f, int gather) {
  return poly_segment_route(f, gather);
}

// Returns the cudaError_t of the launch (0 = success).  Pointers are device
// pointers; a null output pointer skips that moment.  `src` is data [E, F]
// (gather == 0; senders and mask unused) or x [n_src, F] (gather != 0).
// `route`: 0 the width's own (hg_poly_segment_route), 1 or 2 that one (1
// only in scatter mode at an even f); data and the outputs 8-byte aligned
// on route 1.  The launch goes on `stream` and does not synchronise.
extern "C" int hg_poly_segment_f32(
    const void* src, const void* senders, const void* mask,
    const void* row_ptr, void* o_sum, void* o_sq, void* o_mxmn, void* o_cnt,
    int n_rows, int n_src, int f, int gather, int route, void* stream) {
  if (route == 0) route = poly_segment_route(f, gather);
  if (route < 1 || route > 2 || (route == 1 && !route1_takes(f, gather)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0 || f <= 0) return 0;
  const int m = (o_sum ? kSum : 0) | (o_sq ? kSq : 0) | (o_mxmn ? kMxMn : 0);
  if (m == 0 && o_cnt == nullptr) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1)
    return static_cast<int>(r1::dispatch(
        m, static_cast<const float*>(src), static_cast<const int*>(row_ptr),
        static_cast<float*>(o_sum), static_cast<float*>(o_sq),
        static_cast<float*>(o_mxmn), static_cast<float*>(o_cnt), n_rows, f,
        st));
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
