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
// pg::poly_gather_kernel (route 1) and poly_segment_kernel<kGather>
// (route 2)
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
// Route 2 (the first design; hg_poly_segment_route: odd F and F past 128
// in scatter mode, F not a multiple of 4 and F past 64 in gather mode):
// one warp per output row in blocks of 8, lanes on columns lane + 32 j
// of 128 a pass (at F = 64 half the accumulators are masked off), 4 rows'
// loads in flight, restarting at every row boundary.
// In gather mode every edge gathers its sender's whole row from L2
// (33.6 MB at the flagship's first batch against x's 2.5 MB).
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
// Gather route 1 (F a multiple of 4 up to 64: SAGE's and MFC's 64), the
// TPU kernel's node window (a 3-block window of x in VMEM) as Hopper
// stages it:
// - each block owns an equal count of the receiver rows (at most kRows
//   = 128; one block a SM) and stages the rows of x around them, its rows
//   and up to kReach = 127 either side (window_of; collate attaches the
//   kernel marker only when every graph fits one 128-node block, so each
//   sender lies in its receiver's graph and so in the window), in shared
//   memory by one TMA bulk copy (cp.async.bulk, completion on an
//   mbarrier) issued before anything else, and a zero row after them;
// - while it lands, the block loads its row offsets and turns its edges'
//   sender ids and mask values into read codes (code_of: a row of the
//   window, the zero row with mask 0 for a sender outside [0, N), or a
//   row outside the window, read from global memory with the same
//   arithmetic, correct whatever the ids are);
// - each half-warp of its 32 warps walks an equal count of its rows in
//   edge order, a float4 a lane (a 64-column row is 256 bytes of shared
//   memory), the next edge's code loaded while this edge's row is read;
//   each row's moments come from registers and are written when its
//   range ends, cnt from row_ptr.
// It computes v = x[s] * mask[e] as one float32 product and route 2's
// s += v, q += v * v, max and min in edge order, so it gives route 2's
// bits for every moment subset.  Route 2 keeps F not a multiple of 4 and
// F past 64.
// Measured (NVIDIA H100 80GB HBM3, 700 W; python3 fused_mp_variants.py
// --which staged and chip_smoke.py, the flagship's first train batch, N
// = 9680, E = 135744, cold after the memset flush): ("sum", "cnt") at F
// = 64 0.0154-0.0156 ms against route 2's 0.0164-0.0167 (warm 0.0142
// against 0.0145), all moments 0.0173 against 0.0186; at F = 128 with all
// moments 0.0271 against 0.0210, hence route 2 there.  Of the 0.0156 the
// launch takes 0.0053, the window and the read codes 0.0037 more; the
// walk the rest: walking no edge takes 0.0089, and neither dropping the
// window's reads (0.0148) nor the row stores (0.0156) removes it.  Its
// first form, a span of the block's senders found first and staged by a
// loop, a warp a row, took 0.0244-0.0258; a warp (not a half-warp) a row
// stream of float2 lanes 0.0171-0.0177; 16 warps in place of 32 0.0177.

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
        v[j] = (c < f && live) ? (MODE == kGather ? __fmul_rn(r[c], m) : r[c])
                               : 0.f;
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

// ---------------------------------------------------------------------------
// route 1 of the gather mode: x's node window in shared memory (see above)
// ---------------------------------------------------------------------------
namespace pg {

constexpr int kWarps = 32;                // warps a block
constexpr int kThreads = kWarp * kWarps;
constexpr int kRows = 128;                // receiver rows a block owns at most
constexpr int kEdgeCap = 4096;            // edges whose id and mask are staged
constexpr int kXBytes = 96 * 1024;        // x's node window
constexpr int kReach = 127;               // rows either side a block stages
constexpr int kCols = 64;                 // columns a chunk: a float4 a lane
                                          // of a half-warp

// the rows of x the window holds at width f (or `stage_rows`, when the
// checks ask for fewer)
inline int window_rows(int f, int stage_rows) {
  const int cap = kXBytes / (static_cast<int>(sizeof(float)) * f);
  return stage_rows > 0 && stage_rows < cap ? stage_rows : cap;
}

// the blocks at n rows: one a SM (each stages its own window), at least
// one for every kRows rows, at most one for every 16 rows
inline int blocks(int n, int sms) {
  long long g = (static_cast<long long>(n) + 15) / 16;
  if (g > sms) g = sms;
  const long long need = (static_cast<long long>(n) + kRows - 1) / kRows;
  if (g < need) g = need;
  return static_cast<int>(g < 1 ? 1 : g);
}

// the first row of x that block rows [r0, r1) stage, and how many, for
// a window of `win` rows over x's n_src: the block's rows with an equal
// reach either side (kReach at most: a sender of a collated batch lies in
// its receiver's graph of at most 128 nodes), kept inside [0, n_src)
__device__ __forceinline__ void window_of(int r0, int r1, int n_src, int f,
                                          int win, int* lo, int* n_st) {
  const int nr = r1 - r0;
  const int reach = win > nr ? min((win - nr) / 2, kReach) : 0;
  int a = max(r0 - reach, 0);
  int b = min(max(r1 + reach, a), n_src);
  if (b - a > win) b = a + win;
  *lo = a;
  *n_st = b - a;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One thread arms the barrier `bar` for `bytes` and starts their bulk
// copy from global `src` to shared `dst` (both 16-byte aligned, bytes a
// multiple of 16; none at 0); the block waits on it with window_wait
// after a __syncthreads.
__device__ __forceinline__ void window_copy(void* dst, const void* src,
                                            unsigned bytes,
                                            unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  if (bytes > 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// until the copy armed on `bar` has landed (its phase 0 completed)
__device__ __forceinline__ void window_wait(unsigned long long* bar) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)) : "memory");
}

// an edge's read of its sender's row: the row's first float4 in the
// window (>= 0; a sender outside [0, n_src) reads the zero row after the
// window's rows, with mask bits 0, so its message is +0 as route 2's), or
// -1 - s for a row s outside the window (read from global memory)
__device__ __forceinline__ int2 code_of(int s, float m, int n_src, int lo,
                                        int n_st, int f) {
  if (static_cast<unsigned>(s) >= static_cast<unsigned>(n_src))
    return make_int2(n_st * (f / 4), 0);
  const int d = s - lo;
  return make_int2(static_cast<unsigned>(d) < static_cast<unsigned>(n_st)
                       ? d * (f / 4)
                       : -1 - s,
                   __float_as_int(m));
}

// The requested moments of v = x[senders[e]] * mask[e] over each row's
// edges.  Block k owns the rows [n k / B, n (k + 1) / B); its window of x
// (window_of) arrives in shared memory by one bulk copy, issued first,
// while the block loads its row offsets and turns its edges' sender ids
// and mask values into read codes (code_of).  Each half-warp walks an
// equal count of the block's rows in edge order, a float4 a lane (16
// lanes a 64-column chunk, chunks one after another).
template <int M>
__global__ void __launch_bounds__(kThreads)
poly_gather_kernel(const float* __restrict__ x,
                   const int* __restrict__ senders,
                   const float* __restrict__ mask,
                   const int* __restrict__ row_ptr,
                   float* __restrict__ o_sum, float* __restrict__ o_sq,
                   float* __restrict__ o_mxmn, float* __restrict__ o_cnt,
                   int n_rows, int n_src, int f, int win) {
  // x[lo + i, c] at xs[(i f + c) / 4]; then one zero row
  extern __shared__ __align__(128) float4 xs[];
  __shared__ int2 code_s[kEdgeCap];   // (read code, mask bits) an edge
  __shared__ int rp_s[kRows + 1];
  __shared__ unsigned long long bar;  // the copy's completion
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int r0 = static_cast<int>(static_cast<long long>(n_rows) *
                                  blockIdx.x / gridDim.x);
  const int r1 = static_cast<int>(static_cast<long long>(n_rows) *
                                  (blockIdx.x + 1) / gridDim.x);
  const int nr = r1 - r0;  // <= kRows
  int lo = 0, n_st = 0;
  if (M != 0) window_of(r0, r1, n_src, f, win, &lo, &n_st);
  // 1. the window's copy, in flight from here to the walk; the zero row
  if (threadIdx.x == 0)
    window_copy(xs, x + static_cast<size_t>(lo) * f,
                static_cast<unsigned>(n_st) * static_cast<unsigned>(f) * 4u,
                &bar);
  if (M != 0)
    for (int i = threadIdx.x; i < f / 4; i += kThreads)
      xs[n_st * (f / 4) + i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // 2. the rows' offsets, then their edges' read codes (the first
  //    kEdgeCap staged; the walk codes the rest itself)
  for (int i = threadIdx.x; i <= nr; i += kThreads)
    rp_s[i] = __ldg(row_ptr + r0 + i);
  __syncthreads();
  const int p0 = rp_s[0], ne = min(rp_s[nr] - p0, kEdgeCap);
  if (M != 0) {
    constexpr int kL = kEdgeCap / kThreads;
    int sd[kL];
    float mv[kL];
#pragma unroll
    for (int j = 0; j < kL; ++j) {
      const int k = threadIdx.x + j * kThreads;
      if (k < ne) {
        sd[j] = __ldg(senders + p0 + k);
        mv[j] = __ldg(mask + p0 + k);
      }
    }
#pragma unroll
    for (int j = 0; j < kL; ++j) {
      const int k = threadIdx.x + j * kThreads;
      if (k < ne) code_s[k] = code_of(sd[j], mv[j], n_src, lo, n_st, f);
    }
  }
  if (o_cnt != nullptr)
    for (int r = threadIdx.x; r < nr; r += kThreads)
      o_cnt[r0 + r] = static_cast<float>(rp_s[r + 1] - rp_s[r]);
  if (M == 0) return;
  // 3. the window has landed
  window_wait(&bar);
  __syncthreads();
  // 4. each half-warp walks an equal count of the block's rows
  constexpr int kWalkers = 2 * kWarps;
  const int hl = lane & 15, wk = 2 * wid + (lane >> 4);
  const int ra = nr * wk / kWalkers, rb = nr * (wk + 1) / kWalkers;
  const int ea = rp_s[ra], eb = rp_s[rb];
  // an edge's code: staged, or coded here past the staged ones
  auto code_at = [&](int e) {
    const int k = e - p0;
    return k < kEdgeCap ? code_s[k]
                        : code_of(__ldg(senders + e), __ldg(mask + e), n_src,
                                  lo, n_st, f);
  };
  for (int c0 = 0; c0 < f; c0 += kCols) {
    const int col = c0 + 4 * hl;
    const bool on = col < f;  // f a multiple of 4: col + 3 < f too
    float4 s, q, mx, mn;
    auto reset = [&]() {
      s = q = make_float4(0.f, 0.f, 0.f, 0.f);
      mx = mn = make_float4(kNeg, kNeg, kNeg, kNeg);
    };
    auto put = [&](int r) {  // r: the block's row index
      if (!on) return;
      const size_t row = static_cast<size_t>(r0 + r);
      if (M & kSum) *reinterpret_cast<float4*>(o_sum + row * f + col) = s;
      if (M & kSq) *reinterpret_cast<float4*>(o_sq + row * f + col) = q;
      if (M & kMxMn) {
        *reinterpret_cast<float4*>(o_mxmn + 2 * row * f + col) = mx;
        *reinterpret_cast<float4*>(o_mxmn + 2 * row * f + f + col) = mn;
      }
    };
    reset();
    int row = ra, end = rp_s[ra + 1];
    // the next edge's code is loaded while this edge's row is read
    int2 cm = ea < eb ? code_at(ea) : make_int2(0, 0);
    for (int e = ea; e < eb; ++e) {
      while (e >= end) {
        put(row);
        reset();
        ++row;
        end = rp_s[row + 1];
      }
      const int2 cn = e + 1 < eb ? code_at(e + 1) : cm;
      // a window row is read whole whatever f (the window's buffer runs
      // kCols floats past the zero row); a global row only where on
      const float4 r =
          cm.x >= 0 ? xs[cm.x + (col >> 2)]
          : on      ? __ldg(reinterpret_cast<const float4*>(
                          x + static_cast<size_t>(-1 - cm.x) * f + col))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      const float m = __int_as_float(cm.y);
      cm = cn;
      // route 2's expressions, column by column, in edge order
      const float4 v = make_float4(__fmul_rn(r.x, m), __fmul_rn(r.y, m),
                                   __fmul_rn(r.z, m), __fmul_rn(r.w, m));
      if (M & kSum) {
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      if (M & kSq) {
        q.x += v.x * v.x;
        q.y += v.y * v.y;
        q.z += v.z * v.z;
        q.w += v.w * v.w;
      }
      if (M & kMxMn) {
        mx = make_float4(fmaxf(mx.x, v.x), fmaxf(mx.y, v.y),
                         fmaxf(mx.z, v.z), fmaxf(mx.w, v.w));
        mn = make_float4(fmaxf(mn.x, -v.x), fmaxf(mn.y, -v.y),
                         fmaxf(mn.z, -v.z), fmaxf(mn.w, -v.w));
      }
    }
    // the row of the last edge (ra when the rows have none), then the
    // rows past it, which have no edge
    if (ra < rb) {
      put(row);
      reset();
      for (int r = row + 1; r < rb; ++r) put(r);
    }
  }
}

template <int M>
cudaError_t launch(const float* x, const int* senders, const float* mask,
                   const int* row_ptr, float* o_sum, float* o_sq,
                   float* o_mxmn, float* o_cnt, int n_rows, int n_src, int f,
                   int win, int grid, cudaStream_t st) {
  // the window's rows, the zero row and a chunk's overrun past it
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(win + 1) * f + kCols);
  const cudaError_t err = cudaFuncSetAttribute(
      poly_gather_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  poly_gather_kernel<M><<<grid, kThreads, smem, st>>>(
      x, senders, mask, row_ptr, o_sum, o_sq, o_mxmn, o_cnt, n_rows, n_src,
      f, win);
  return cudaGetLastError();
}

cudaError_t dispatch(int m, const float* x, const int* senders,
                     const float* mask, const int* row_ptr, float* o_sum,
                     float* o_sq, float* o_mxmn, float* o_cnt, int n_rows,
                     int n_src, int f, int stage_rows, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int grid = blocks(n_rows, sms), win = window_rows(f, stage_rows);
#define HG_POLY_PG_CASE(K)                                                  \
  case K:                                                                   \
    return launch<K>(x, senders, mask, row_ptr, o_sum, o_sq, o_mxmn, o_cnt, \
                     n_rows, n_src, f, win, grid, st);
  switch (m) {
    HG_POLY_PG_CASE(0)
    HG_POLY_PG_CASE(1)
    HG_POLY_PG_CASE(2)
    HG_POLY_PG_CASE(3)
    HG_POLY_PG_CASE(4)
    HG_POLY_PG_CASE(5)
    HG_POLY_PG_CASE(6)
    default:
      HG_POLY_PG_CASE(7)
  }
#undef HG_POLY_PG_CASE
}

}  // namespace pg

// whether route 1 takes width f: in scatter mode f even (a float2 a
// lane), in gather mode f a multiple of 4 (a float4 a lane)
inline bool route1_takes(int f, int gather) {
  return f > 0 && f % (gather ? 4 : 2) == 0;
}

// the route of the poly kernel at width f: 1 at the widths route1_takes
// up to 128 in scatter mode (two chunks a walk) and up to 64 in gather
// mode (the paths' 64); 2 (the first design) elsewhere: odd f (and,
// gathering, f not a multiple of 4), past 128 in scatter mode and past 64
// in gather mode, where route 2 measured faster (fused_mp_variants.py:
// the scatter at 256; the gather at 128, whose window holds fewer rows)
inline int poly_segment_route(int f, int gather) {
  return route1_takes(f, gather) && f <= (gather ? pg::kCols : 2 * r1::kCols)
             ? 1
             : 2;
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
// only at a width route1_takes); src and the outputs 8-byte aligned on
// route 1, 16-byte in gather mode.
// `stage_rows` > 0 caps the rows of x that gather route 1 stages (the
// checks force senders past the window), 0 takes the budget's.  The
// launch goes on `stream` and does not synchronise.
extern "C" int hg_poly_segment_f32(
    const void* src, const void* senders, const void* mask,
    const void* row_ptr, void* o_sum, void* o_sq, void* o_mxmn, void* o_cnt,
    int n_rows, int n_src, int f, int gather, int route, int stage_rows,
    void* stream) {
  if (route == 0) route = poly_segment_route(f, gather);
  if (route < 1 || route > 2 || (route == 1 && !route1_takes(f, gather)) ||
      stage_rows < 0 || (stage_rows > 0 && !(route == 1 && gather)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0 || f <= 0) return 0;
  const int m = (o_sum ? kSum : 0) | (o_sq ? kSq : 0) | (o_mxmn ? kMxMn : 0);
  if (m == 0 && o_cnt == nullptr) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1 && gather)
    return static_cast<int>(pg::dispatch(
        m, static_cast<const float*>(src), static_cast<const int*>(senders),
        static_cast<const float*>(mask), static_cast<const int*>(row_ptr),
        static_cast<float*>(o_sum), static_cast<float*>(o_sq),
        static_cast<float*>(o_mxmn), static_cast<float*>(o_cnt), n_rows,
        n_src, f, stage_rows, st));
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

// The rows of x gather route 1's window stages at width f (`stage_rows`
// as above); -1 at a width it cannot take.
extern "C" int hg_poly_gather_window(int f, int stage_rows) {
  return f > 0 ? pg::window_rows(f, stage_rows) : -1;
}
