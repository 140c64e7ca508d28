// Hand-written Hopper (sm_90a) kernels for the sorted-segment reductions
// of the SchNet path and the `pallas` backend's unsorted segment sum.
// Plain C interface, loaded with ctypes by hydragnn_torch/kernels/build.py;
// wrappers, plain PyTorch versions and launch counters live in
// hydragnn_torch/ops/fused_mp.py.
//
// gm_fwd_kernel (route 1) and gather_mul_segment_sum_kernel (route 2)
//   out[n, f] = sum_{e in [row_ptr[n], row_ptr[n+1])} x[send[e], f] * w[e, f]
//   (or * mask[e] in the no-w mode, the reference's gather_segment_sum).
//   Replaces the TPU kernel hydragnn_tpu/ops/fused_mp.py:_fused_impl
//   (pl.pallas_call at :171; public ops gather_mul_segment_sum :182 and
//   gather_segment_sum :247).
//   Bound on the H100 SXM: bytes.  Per call it must read x [N,F], the
//   valid rows of w [E_valid,F], the valid ids, and write out [N,F]; at
//   2*E_valid*F flops that is ~0.5 flop/byte, far below the card's
//   ~20 flop/byte float32 ridge, so the least time is bytes / 3.35 TB/s.
//   Both routes keep the [E,F] message tensor out of memory (gather,
//   multiply and sum happen in registers), write each output row exactly
//   once and never read a masked edge, which the CSR schedule parks out
//   of every row's range.
//   Route 1 (hg_gather_mul_route: every even F, the paths' F = 64) against
//   what held the first design back:
//   - the dependent id load: route 2 loads send[e], then x[send[e]], one
//     edge at a time.  Route 1 loads 32 consecutive sender ids (and mask
//     values) in one coalesced load, the next 32 while this batch is
//     summed, and hands them out by shuffles; the x and w rows of U = 8
//     edges are issued before any of them is added;
//   - the idle lanes: route 2's lanes take columns lane + 32 j of 128 a
//     pass, so at F = 64 half its accumulators are masked off and each
//     lane issues two 4-byte loads a row.  Route 1's lane takes columns
//     2 lane, 2 lane + 1 as a float2: one 256-byte access a 64-column row
//     (wider F loops over 64-column chunks);
//   - the ragged wave: route 2 runs one warp per output row in blocks of
//     8 warps (1.15 waves at the flagship's batch).  Route 1 sizes its
//     grid to the SMs (the blocks the card holds at once) and gives each
//     warp one share of the rows (passp::share_range's: rows plus edges
//     balanced, no row split; gm::share_rows finds them with two loads
//     fewer before the first edge); a share's edges are one contiguous
//     range, so the loads run on across row boundaries, and a row's sum
//     is written when its range ends.
//   Each row is summed in edge order with one fma a term and column, as
//   route 2 does, so the two routes give the same bits.  Route 2 stays
//   for odd F (GIN's layer-0 input width), and the card checks ask for it
//   by route to time it beside route 1.
//
// gm_bwd_kernel (route 1 of the backward)
//   dx[s, f] = sum_{k in [row_ptr[s], row_ptr[s+1])}
//                  g[recv[p[k]], f] * w[p[k], f]
//   dw[e, f] = x[s, f] * g[recv[e], f]      (w mode; zero off real edges)
//   on the sender CSR: p (collate's sender_perm) orders the edges by
//   sender, and the wrapper's offsets park masked edges past every row.
//   Replaces hydragnn_tpu/ops/fused_mp.py:_vjp_bwd (:235: the Pallas
//   kernel rerun on w[sender_perm], and dw = x[senders] * g[receivers] as
//   plain jnp) and :_gss_bwd (:270, the no-w mode's dx on mask[p]).
//   Bound: bytes.  It reads g and x [N,F], the real rows of w, p and recv
//   on real positions and writes dx [N,F] and dw [E,F] (~76 MB at the
//   flagship's first batch, ~0.023 ms); 3 flops a real edge and column.
//   The route-2 backward (the wrapper's composition) also gathered w[p],
//   x[senders] and g[receivers], three [E,F] tensors, around the first
//   design in sender order.  Route 1 is one launch on the forward's
//   shape with the roles swapped: each warp owns a share of the sender
//   rows and walks its positions k in order, 32 edge ids e = p[k] and
//   their recv[e] at a time (the next 32 in flight), and issues the g and
//   w rows of U = 8 edges before adding g * w into dx[s] in position
//   order (one fma a term, as route 2, so dx keeps its bits) and storing
//   dw[e] = x[s] * g (one float32 product, the bits of x[senders] *
//   g[receivers]).  x[s] is loaded once a row, the next row's while this
//   one is walked; the g row is already in registers.  Each edge has one
//   position, so one warp writes each dw row exactly once: the walk the
//   rows of its positions (zeros where the receiver is out of range), and
//   the warps in turn the positions outside every row (masked edges,
//   senders out of range), as zeros: their true gradient.  A null dx or
//   dw skips that output.  The double backward
//   (grad mode on in the backward) keeps the route-2 composition, which
//   is differentiable; the no-w mode has no dw.
//
// ss::seg_sum_kernel (route 1) and segment_sum_dense_kernel (route 2)
//   out[s, f] = sum_{r in [row_ptr[s], row_ptr[s+1])} data[perm[r], f]
//   (perm null: data[r, f]), over at most the first max_rows rows of each
//   segment (the reference's max_per_segment contract; INT_MAX otherwise).
//   Replaces hydragnn_tpu/ops/fused_mp.py:_scatter_impl (pl.pallas_call at
//   :340; public op segment_sum_dense :350).  Bound: bytes (read the valid
//   rows of data once, write out once; 1 flop per 4-byte element).
//   It also replaces the reference's `pallas` aggregation backend's
//   sorted segment sum, hydragnn_tpu/ops/aggregate.py:_sorted_impl
//   (pl.pallas_call at :244, nondecreasing ids), whose cap keeps collate's
//   padding segment (every padding edge on node N-1, pre-masked to zeros)
//   from costing thousands of rows, as the reference's cap drops those
//   rows; and, through a row permutation, it is route 2 of the unsorted
//   sum below.
//   Route 2 (the first design; hg_segment_sum_route: odd F, such as
//   EGNN's position gathers at 3): one warp per segment in blocks of 8,
//   lanes on columns lane + 32 j of 128 a pass.  At the pool (513
//   segments) that fills 65 blocks on 132 SMs, and the padding graph's
//   220-row segment, walked by one warp one row at a time, sets the time
//   (0.050 ms cold against a bound of 0.0008).  PERM is a template
//   parameter so that the dense sum keeps a loop whose row addresses the
//   compiler can run ahead of: a run-time "perm or not" inside the row
//   loop halved the pool's speed on its long padding segment.
//   Route 1 (every even F: the pool, PNA's gather backwards at 64 and tie
//   counts at 128, the pallas backend) splits rows, not only segments:
//   - the grid is sized to the blocks the card holds (16 warps a block);
//     each block takes an equal count of the segments (so no segment
//     crosses a block) and its warps equal slices of their positions,
//     which may cut a segment.  Equal counts, not a share search: a
//     search (walk::share_rows) puts ~0.003 ms of dependent loads before
//     every block's first row, which lost to route 2 on DimeNet's short
//     segment sums; the warp slices already split a long segment, so the
//     block's rows need no balance across blocks on the paths' segments
//     (see the measurements below);
//   - each warp sums its slice in position order, a float2 a lane (two
//     64-column chunks a walk past 64 columns), 8 rows in flight, loads
//     running on across segment boundaries (perm ids 32 at a time, the
//     next 32 in flight), rows read cache-streaming (walk::ldcs2);
//   - it writes each segment that lies wholly in its slice straight to
//     out, with route 2's bits, and leaves the partial sums of the (at
//     most two) segments that its slice cuts in shared memory; after one
//     __syncthreads the warp that holds a cut segment's last position
//     adds the partials in warp order (the first slice's tail partial,
//     then the head partials after it) and writes the segment;
//   - positions past a segment's cap are not added: the walk jumps from
//     the cap to the segment's end (a group of 8 rows that crosses a
//     segment boundary may still load a few), and the block's empty
//     segments are written as zeros first.
//   One launch, no atomics, no global scratch, deterministic.
//   ops/aggregate.py:segment_sum_plan writes the plan out for the tests.
//   Measured (NVIDIA H100 80GB HBM3, 700 W; python3 fused_mp_variants.py
//   --which rows, cold after chip_smoke's memset flush, and --which path,
//   device time a launch in profiled train epochs): against block shares
//   found by walk::share_rows (rows plus segments balanced), equal counts
//   take the pool from 0.0108 to 0.0102 ms, edge rows [E, 64] from 0.0243
//   to 0.0221 (route 2 0.0244), DimeNet's sums from 7.18 to 6.49 us a
//   launch (route 2 6.63) and PNA's from 1.090 to 1.054 ms an epoch
//   (route 2 1.438).  dimenet_wide's sums (F = 128) take 10.15 us a
//   launch against route 2's 11.90; chip_smoke's routes_on_path, read
//   three times in turns in one run, 9.93-10.14 against 11.83-11.88, so
//   route 1 keeps F = 128.  Plain loads in place of the
//   streaming ones: edge rows 0.0241 against 0.0221, tie counts 0.0383
//   against 0.0346 (the pool ties).

// us::us_sum_kernel (route 1 of the unsorted segment sum)
//   out[t, f] = sum of data[e, f] over the edges e with ids[e] = t, in
//   edge order; ids in any order, those outside [0, S) dropped.
//   Replaces hydragnn_tpu/ops/aggregate.py:_pallas_segment_sum_impl
//   (pl.pallas_call at :157; public op segment_sum_pallas :310), which
//   accumulates a blocked one-hot contraction over edge blocks on the MXU
//   with no sort.  On Hopper the one-hot tile is wasted work and the sum
//   needs a schedule: route 2 (the first design) makes it with library
//   launches in the wrapper (a stable torch.sort of the parked ids,
//   segment_offsets' arange and searchsorted: ~0.085 ms, 3.6x the CSR
//   kernel after it) and then runs the CSR kernel through the sort's
//   permutation.  Route 1 builds the same schedule inside one launch:
//   - block k owns the CSR kernel's equal count of segments [sb, se) (at
//     most kSegs = 128); its threads read every id once (int4 loads,
//     4 in flight) for the first and last edge it owns, its span;
//   - its 16 warps take equal contiguous parts of the span and count, 8
//     loads of 32 ids in flight, the edges of each owned segment (a key's
//     lanes add once, through __match_any_sync);
//   - an exclusive prefix over (segment, warp) order gives the block's
//     CSR offsets and each warp's first position in each segment; the
//     warps walk their parts again and place each edge at that start plus
//     its rank (lanes below it with the same key, and a running count
//     across loads), so each segment's edges keep edge order: position
//     for position the slice of the stable sort's permutation that the
//     CSR kernel's block k walks;
//   - the positions live in shared memory, kWindow = 16384 a round: a
//     block whose list is longer places and sums it in rounds, walking its
//     span again each round.  The budget is per round, not per call, so
//     no id order is refused and nothing is decided on the host (the
//     block count and route come from E, S and F alone, with no sync);
//   - the sum is the CSR kernel's route 1 over those positions, with the
//     permutation read from shared memory: the same warp slices, order,
//     cut-segment combine and empty-segment zeros, 16 rows in flight a
//     warp.  Launched at the same block count, route 1 gives the CSR
//     kernel's bits through the sort's permutation.
//   One launch, no atomics on floats and no integer atomics either (each
//   count has one writer: a key's first lane, its warp's own slot), no
//   global scratch beyond the output, deterministic.  Bound: bytes, as
//   the CSR kernel's (the rows summed, every id once, the output once).
//   Every block reads all E ids for its span, 132 x 0.54 MB from L2 at
//   the flagship's batch: what bounds route 1 below the CSR kernel.
//   Route 1 takes even F up to 128 and S up to kSegs * 256 segments
//   (hg_unsorted_sum_route); route 2 stays past that and as the timing
//   beside it.
//   Measured (NVIDIA H100 80GB HBM3, 700 W; python3 fused_mp_variants.py
//   --which staged: the flagship's first train batch, E = 135744, S =
//   9680, F = 64, cold after chip_smoke's memset flush): on the senders
//   with the masked tail out of range the whole call takes 0.0388 ms on
//   route 1, 0.1104 on route 2 (the CSR kernel alone 0.0242, index_add_
//   0.0742); on the receivers with the padded tail on node N-1, the
//   path's ids, 0.0587 against 0.1552: the block that owns N-1 sums its
//   4342 padding rows alone, as the CSR kernel's block does (0.0692); on
//   shuffled receivers, where every block's span is the whole id array,
//   0.1299 against 0.1584.  Of route 1's 0.0388 the launch takes 0.0054,
//   the span pass 0.0115 (every block reads all E ids from L2, ~72 MB
//   at ~6 TB/s) and the counts and prefix 0.0029.  16 rows in flight a
//   warp against 8: 0.0583 against 0.0650 on the receivers (32: 0.0601);
//   8 loads of 32 ids in flight against 1: 0.1294 against 0.2018 on
//   shuffled ids; one block a SM against the least the segments take
//   (76) and twice as many: 0.0388, 0.0432, 0.0394.  ops/aggregate.py:unsorted_sum_plan writes the schedule
//   out for the tests; the launch's debug output (the checks only)
//   writes the blocks' permutation and offsets.

// Contract shared with the reference kernels (collate guarantees it):
// rows/edges are sorted by output id, so each output row owns one
// contiguous CSR range; masked rows sort last and are parked out of range
// by the wrapper's schedule.  The reference's TPU kernel gathers senders
// through a +-1 node-block window and drops out-of-window senders; collate
// attaches the kernel marker only when every graph fits one block, so
// every real sender lies in the window and global indexing here gives the
// same answer.  Senders (in the backward: receivers) outside [0, n_src)
// contribute nothing.
//
// Determinism: every output row is added up in a fixed order in float32
// registers (one warp a row in edge or position order; route 1 of the
// segment sum adds a cut segment's warp partials in warp order).  No
// atomics, no [E,F] intermediate; the result is bit-identical from run to
// run.  Every output row is written, empty rows (zero-length ranges) as
// zeros.

#include <cuda_runtime.h>

#include <cstdint>

#include "pass_p.cuh"
#include "row_walk.cuh"

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

// PERM is a template parameter: see the header (route 2)
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

// ---------------------------------------------------------------------------
// route 1 of the gather-multiply forward and of its backward (see above)
// ---------------------------------------------------------------------------
namespace gm {

constexpr int kWarps = 8;        // warps a block
constexpr int kU = 8;            // edges whose rows are in flight a warp
constexpr int kCols = 2 * kWarp; // columns a pass: a float2 a lane
using walk::Cursor;
using walk::kFull;
using walk::ldg2;
using walk::share_rows;
using walk::st2;

// Forward: out[n] = sum over row n's positions of x[send[k]] * (w[k] or
// mask[k]), each warp on its share of the rows.
template <int MODE>
__global__ void __launch_bounds__(kWarp * kWarps)
gm_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ mask, const int* __restrict__ senders,
              const int* __restrict__ row_ptr, float* __restrict__ out,
              int n_rows, int n_src, int f) {
  const int lane = threadIdx.x & 31;
  int rb, re, p0, p1;
  share_rows(row_ptr, n_rows, blockIdx.x * kWarps + threadIdx.x / kWarp,
             gridDim.x * kWarps, rb, re, p0, p1);
  if (rb >= re) return;
  for (int c0 = 0; c0 < f; c0 += kCols) {
    const int col = c0 + 2 * lane;
    const bool on = col < f;  // f even: col + 1 < f too
    Cursor cur;
    cur.init(row_ptr, n_rows, rb);
    float2 acc = make_float2(0.f, 0.f);
    auto put = [&](int r) {
      if (on) st2(out + static_cast<size_t>(r) * f + col, acc);
      acc = make_float2(0.f, 0.f);
    };
    // the first batch's ids; each batch issues the next batch's
    int s_nx = p0 + lane < p1 ? __ldg(senders + p0 + lane) : -1;
    float m_nx = 0.f;
    if (MODE == kMask && p0 + lane < p1) m_nx = __ldg(mask + p0 + lane);
    for (int base = p0; base < p1; base += kWarp) {
      const int s_l = s_nx;
      const float m_l = m_nx;
      const int kn = base + kWarp + lane;
      s_nx = kn < p1 ? __ldg(senders + kn) : -1;
      if (MODE == kMask) m_nx = kn < p1 ? __ldg(mask + kn) : 0.f;
      const int cnt = min(kWarp, p1 - base);
      for (int i = 0; i < cnt; i += kU) {
        float2 xv[kU], wv[kU];
        float mv[kU];
        bool ok[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int s = __shfl_sync(kFull, s_l, i + u);
          if (MODE == kMask) mv[u] = __shfl_sync(kFull, m_l, i + u);
          ok[u] = i + u < cnt &&
                  static_cast<unsigned>(s) < static_cast<unsigned>(n_src);
          xv[u] = make_float2(0.f, 0.f);
          wv[u] = make_float2(0.f, 0.f);
          if (ok[u] && on) {
            xv[u] = ldg2(x + static_cast<size_t>(s) * f + col);
            if (MODE == kMulW)
              wv[u] = ldg2(w + static_cast<size_t>(base + i + u) * f + col);
          }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (i + u >= cnt) break;
          while (base + i + u >= cur.end) {
            put(cur.row);
            cur.next();
          }
          if (!ok[u]) continue;
          if (MODE == kMulW) {
            acc.x = fmaf(xv[u].x, wv[u].x, acc.x);
            acc.y = fmaf(xv[u].y, wv[u].y, acc.y);
          } else {
            acc.x = fmaf(xv[u].x, mv[u], acc.x);
            acc.y = fmaf(xv[u].y, mv[u], acc.y);
          }
        }
      }
    }
    // the row of the last edge (rb when the share has none), then the
    // share's rows past it, which have no edge
    put(cur.row);
    for (int r = cur.row + 1; r < re; ++r) put(r);
  }
}

// Backward: dx[s] = sum over sender row s's positions k of g[recv[p[k]]] *
// (w[p[k]] or mask[p[k]]), and in the w mode dw[p[k]] = x[s] * g[recv[p[k]]]
// (zeros on the positions outside every row).  Null dx or dw: not written.
template <int MODE>
__global__ void __launch_bounds__(kWarp * kWarps)
gm_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x,
              const float* __restrict__ w, const float* __restrict__ mask,
              const int* __restrict__ perm, const int* __restrict__ recv,
              const int* __restrict__ row_ptr, float* __restrict__ dx,
              float* __restrict__ dw, int n_rows, int n_src, int n_edges,
              int f) {
  const int lane = threadIdx.x & 31;
  const int part = blockIdx.x * kWarps + threadIdx.x / kWarp;
  const int n_parts = gridDim.x * kWarps;
  const bool want_dx = dx != nullptr;
  const bool want_dw = MODE == kMulW && dw != nullptr;
  int rb, re, p0, p1;
  share_rows(row_ptr, n_rows, part, n_parts, rb, re, p0, p1);
  if (rb < re) {
    for (int c0 = 0; c0 < f; c0 += kCols) {
      const int col = c0 + 2 * lane;
      const bool on = col < f;
      Cursor cur;
      cur.init(row_ptr, n_rows, rb);
      float2 acc = make_float2(0.f, 0.f);
      // x of the current sender row and of the next one
      float2 xc = make_float2(0.f, 0.f), xn = make_float2(0.f, 0.f);
      if (want_dw && on) {
        xc = ldg2(x + static_cast<size_t>(rb) * f + col);
        if (rb + 1 < re) xn = ldg2(x + static_cast<size_t>(rb + 1) * f + col);
      }
      auto step = [&]() {  // the current row's dx written; to the next row
        if (want_dx && on)
          st2(dx + static_cast<size_t>(cur.row) * f + col, acc);
        acc = make_float2(0.f, 0.f);
        cur.next();
        if (want_dw) {
          xc = xn;
          if (on && cur.row + 1 < re)
            xn = ldg2(x + static_cast<size_t>(cur.row + 1) * f + col);
        }
      };
      // a batch's edge ids, their receivers (and mask values)
      auto ids = [&](int k, int& e, int& r, float& m) {
        e = k < p1 ? __ldg(perm + k) : 0;
        r = k < p1 ? __ldg(recv + e) : -1;
        if (MODE == kMask)
          m = k >= p1 ? 0.f : (mask != nullptr ? __ldg(mask + e) : 1.f);
      };
      int e_nx, r_nx;
      float m_nx = 0.f;
      ids(p0 + lane, e_nx, r_nx, m_nx);
      for (int base = p0; base < p1; base += kWarp) {
        const int e_l = e_nx, r_l = r_nx;
        const float m_l = m_nx;
        ids(base + kWarp + lane, e_nx, r_nx, m_nx);
        const int cnt = min(kWarp, p1 - base);
        for (int i = 0; i < cnt; i += kU) {
          float2 gv[kU], wv[kU];
          float mv[kU];
          int ev[kU];
          bool ok[kU];
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            ev[u] = __shfl_sync(kFull, e_l, i + u);
            const int r = __shfl_sync(kFull, r_l, i + u);
            if (MODE == kMask) mv[u] = __shfl_sync(kFull, m_l, i + u);
            ok[u] = i + u < cnt &&
                    static_cast<unsigned>(r) < static_cast<unsigned>(n_src);
            gv[u] = make_float2(0.f, 0.f);
            wv[u] = make_float2(0.f, 0.f);
            if (ok[u] && on) {
              gv[u] = ldg2(g + static_cast<size_t>(r) * f + col);
              if (MODE == kMulW && want_dx)
                wv[u] = ldg2(w + static_cast<size_t>(ev[u]) * f + col);
            }
          }
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            if (i + u >= cnt) break;
            while (base + i + u >= cur.end) step();
            if (want_dw && on) {
              const float2 d = ok[u] ? make_float2(xc.x * gv[u].x,
                                                   xc.y * gv[u].y)
                                     : make_float2(0.f, 0.f);
              st2(dw + static_cast<size_t>(ev[u]) * f + col, d);
            }
            if (!want_dx || !ok[u]) continue;
            if (MODE == kMulW) {
              acc.x = fmaf(gv[u].x, wv[u].x, acc.x);
              acc.y = fmaf(gv[u].y, wv[u].y, acc.y);
            } else {
              acc.x = fmaf(gv[u].x, mv[u], acc.x);
              acc.y = fmaf(gv[u].y, mv[u], acc.y);
            }
          }
        }
      }
      if (want_dx && on) {
        st2(dx + static_cast<size_t>(cur.row) * f + col, acc);
        for (int r = cur.row + 1; r < re; ++r)
          st2(dx + static_cast<size_t>(r) * f + col, make_float2(0.f, 0.f));
      }
    }
  }
  if (!want_dw) return;
  // the dw rows of the positions outside every row's range (before the
  // first row's, after the last's): zeros, 32 positions a warp in turn
  const int lo = __ldg(row_ptr), hi = __ldg(row_ptr + n_rows);
  const int tail = lo + (n_edges - hi);
  for (int t0 = part * kWarp; t0 < tail; t0 += n_parts * kWarp) {
    const int t = t0 + lane;
    const int e_l = t < tail ? __ldg(perm + (t < lo ? t : hi + (t - lo))) : 0;
    const int cnt = min(kWarp, tail - t0);
    for (int j = 0; j < cnt; ++j) {
      const int e = __shfl_sync(kFull, e_l, j);
      for (int c = 2 * lane; c < f; c += kCols)
        st2(dw + static_cast<size_t>(e) * f + c, make_float2(0.f, 0.f));
    }
  }
}

}  // namespace gm

// ---------------------------------------------------------------------------
// route 1 of the CSR segment sum (see above)
// ---------------------------------------------------------------------------
namespace ss {

using walk::Cursor;
using walk::kFull;
using walk::st2;

constexpr int kWarps = 16;       // warps a block: the slices of its rows
constexpr int kRowsInFlight = 8;  // rows in flight a warp at NC = 1
constexpr int kCols = 2 * kWarp; // columns a chunk: a float2 a lane

// the first position of warp w's slice of its block's positions [q0, q1)
// (w = kWarps: q1)
__device__ __forceinline__ int slice_begin(int q0, int q1, int w) {
  return q0 + static_cast<int>(static_cast<long long>(q1 - q0) * w / kWarps);
}

// the largest segment r in [lo, hi) with row_ptr[r] <= a, given
// row_ptr[lo] <= a: the segment that holds position a when a <
// row_ptr[hi].  Found by the whole warp, 32 probes a round.
__device__ __forceinline__ int segment_at(const int* row_ptr, int lo, int hi,
                                          int a) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) >> 5;
    const int r = lo + lane * step;
    const bool ok = r < hi && __ldg(row_ptr + r) <= a;
    const int j = 31 - __clz(__ballot_sync(kFull, ok));  // lane 0 is ok
    lo += j * step;
    hi = min(lo + step, hi);
  }
  return lo;
}

__device__ __forceinline__ void add2(float2& acc, float2 v) {
  acc.x += v.x;
  acc.y += v.y;
}

// out[s] = sum of data[perm[r]] (PERM; data[r] otherwise) over the first
// max_rows positions r of segment s, NC chunks of 64 columns a walk (lane
// l holds columns c0 + 64 j + 2 l).  Each block takes an equal count of
// the segments (no segment split), its warps equal slices of their
// positions; a warp writes the segments that
// lie wholly in its slice and leaves the partial sums of the (at most
// two) that its slice cuts in shared memory, which the warp holding a cut
// segment's last position adds in warp order after one barrier.
template <bool PERM, int NC>
__global__ void __launch_bounds__(kWarp * kWarps)
seg_sum_kernel(const float* __restrict__ data, const int* __restrict__ perm,
               const int* __restrict__ row_ptr, float* __restrict__ out,
               int n_seg, int f, int max_rows) {
  // per walk: each warp's partial of its first segment when an earlier
  // slice holds that segment's head ([0]), and of its last segment when a
  // later slice holds that segment's tail ([1])
  __shared__ float2 part[2][kWarps][NC][kWarp];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  // rows in flight: kRowsInFlight float2s a lane whatever NC
  constexpr int U = kRowsInFlight / NC;
  // the block's segments [sb, se): an equal count a block (no search
  // before the first row; the warp slices balance the rows inside it)
  const int sb = static_cast<int>(static_cast<long long>(n_seg) * blockIdx.x /
                                  gridDim.x);
  const int se = static_cast<int>(static_cast<long long>(n_seg) *
                                  (blockIdx.x + 1) / gridDim.x);
  const int q0 = __ldg(row_ptr + sb), q1 = __ldg(row_ptr + se);
  // the block's empty segments: zeros (the walks write the others)
  for (int s = sb + wid; s < se; s += kWarps)
    if (__ldg(row_ptr + s) == __ldg(row_ptr + s + 1))
      for (int c = 2 * lane; c < f; c += kCols)
        st2(out + static_cast<size_t>(s) * f + c, make_float2(0.f, 0.f));
  const int a = slice_begin(q0, q1, wid), b = slice_begin(q0, q1, wid + 1);
  // the segment of the slice's first position, its first and end positions
  int s0 = sb, start0 = q0, end0 = q0;
  if (a < b) {
    s0 = segment_at(row_ptr, sb, se, a);
    start0 = __ldg(row_ptr + s0);
    end0 = __ldg(row_ptr + s0 + 1);
  }
  auto ldp = [&](int q) { return PERM && q < b ? __ldg(perm + q) : 0; };
  for (int c0 = 0; c0 < f; c0 += NC * kCols) {
    bool on[NC];  // f even: col + 1 < f too
#pragma unroll
    for (int j = 0; j < NC; ++j) on[j] = c0 + j * kCols + 2 * lane < f;
    auto store = [&](int row, const float2 (&v)[NC]) {
#pragma unroll
      for (int j = 0; j < NC; ++j)
        if (on[j])
          st2(out + static_cast<size_t>(row) * f + c0 + j * kCols + 2 * lane,
              v[j]);
    };
    auto keep = [&](int slot, const float2 (&v)[NC]) {
#pragma unroll
      for (int j = 0; j < NC; ++j) part[slot][wid][j][lane] = v[j];
    };
    if (a < b) {
      Cursor cur;
      cur.init(row_ptr, n_seg, s0);
      int start = start0;  // the current segment's first position
      float2 acc[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[j] = make_float2(0.f, 0.f);
      // the current segment ends inside the slice: written, or (its head
      // in earlier slices) left for the combine; then the next segment
      auto finish = [&]() {
        if (start < a)
          keep(0, acc);
        else if (start < cur.end)
          store(cur.row, acc);
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[j] = make_float2(0.f, 0.f);
        start = cur.end;
        cur.next();
      };
      // PERM: the data rows of 32 positions from idb one a lane, and of
      // the 32 after them
      int idb = a, id_l = ldp(a + lane), nx_l = ldp(a + kWarp + lane);
      int p = a;
      while (p < b) {
        while (p >= cur.end) finish();
        if (p - start >= max_rows) {  // the rest of the segment is capped
          p = min(cur.end, b);
          continue;
        }
        const int n_u = min(U, b - p);
        if (PERM && p + n_u > idb + kWarp) {
          id_l = p == idb + kWarp ? nx_l : ldp(p + lane);
          idb = p;
          nx_l = ldp(idb + kWarp + lane);
        }
        float2 v[U][NC];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int row = PERM ? __shfl_sync(kFull, id_l, (p - idb + u) & 31)
                               : p + u;
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            v[u][j] = make_float2(0.f, 0.f);
            if (u < n_u && on[j])
              v[u][j] = walk::ldcs2(data + static_cast<size_t>(row) * f + c0 +
                             j * kCols + 2 * lane);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (u >= n_u) break;
          while (p + u >= cur.end) finish();
          if (p + u - start < max_rows) {
#pragma unroll
            for (int j = 0; j < NC; ++j) add2(acc[j], v[u][j]);
          }
        }
        p += n_u;
      }
      // the segment of the slice's last position
      if (cur.end > b)
        keep(start < a ? 0 : 1, acc);
      else if (start < a)
        keep(0, acc);
      else
        store(cur.row, acc);
    }
    __syncthreads();
    // the combine: the segment whose head lies in earlier slices and whose
    // end lies in this one is the tail partial of the slice that holds its
    // first position plus the head partials after it, in warp order
    if (a < b && start0 < a && end0 <= b) {
      int w0 = wid - 1;
      while (slice_begin(q0, q1, w0) > start0) --w0;
      float2 acc[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[j] = part[1][w0][j][lane];
      for (int v = w0 + 1; v <= wid; ++v)
        if (slice_begin(q0, q1, v) < slice_begin(q0, q1, v + 1)) {
#pragma unroll
          for (int j = 0; j < NC; ++j) add2(acc[j], part[0][v][j][lane]);
        }
      store(s0, acc);
    }
    __syncthreads();
  }
}

// the kernel at NC chunks a walk: one at 64 columns or fewer, else two;
// n_blocks > 0 asks for that many blocks (the unsorted sum's checks hold
// it to this kernel at its own block count), 0 takes the card's
template <bool PERM, int NC>
cudaError_t launch(const float* data, const int* perm, const int* row_ptr,
                   float* out, int n_seg, int n_data, int f, int max_rows,
                   int n_blocks, cudaStream_t st) {
  // at most one block for every kWarps units of work (rows + segments)
  int grid = n_blocks;
  if (grid <= 0) {
    const cudaError_t err = walk::persistent_grid(
        seg_sum_kernel<PERM, NC>, kWarps,
        static_cast<long long>(n_data) + n_seg, kWarps, &grid);
    if (err != cudaSuccess) return err;
  }
  seg_sum_kernel<PERM, NC><<<grid, kWarp * kWarps, 0, st>>>(
      data, perm, row_ptr, out, n_seg, f, max_rows);
  return cudaGetLastError();
}

template <bool PERM>
cudaError_t launch_by_width(const float* data, const int* perm,
                            const int* row_ptr, float* out, int n_seg,
                            int n_data, int f, int max_rows, int n_blocks,
                            cudaStream_t st) {
  return f <= kCols
             ? launch<PERM, 1>(data, perm, row_ptr, out, n_seg, n_data, f,
                               max_rows, n_blocks, st)
             : launch<PERM, 2>(data, perm, row_ptr, out, n_seg, n_data, f,
                               max_rows, n_blocks, st);
}

}  // namespace ss

// ---------------------------------------------------------------------------
// route 1 of the unsorted segment sum: the schedule built in each block's
// shared memory, then route 1 of the CSR segment sum over it (see above)
// ---------------------------------------------------------------------------
namespace us {

using walk::kFull;
using walk::st2;

constexpr int kWarps = ss::kWarps;        // 16: the CSR kernel's warp slices
constexpr int kThreads = kWarp * kWarps;
constexpr int kSegs = 128;                // segments a block owns at most
constexpr int kWindow = 16384;            // positions a round places
constexpr int kMaxSegments = kSegs * 256; // route 1's segment limit
constexpr int kRowsInFlight = 16;         // rows in flight a warp at NC = 1
constexpr int kIdLoads = 8;               // id loads of 32 in flight a warp
constexpr int kCols = ss::kCols;
// dynamic shared memory: base and run [kSegs][kWarps], rp [kSegs + 1],
// the window of the permutation [kWindow]
constexpr size_t kSmemBytes =
    sizeof(int) * (2 * kSegs * kWarps + kSegs + 1 + kWindow);

// the blocks route 1 launches for e ids over s segments: one a SM (each
// block reads every id once), at most one for every kThreads ids and
// segments and one a segment, at least one for every kSegs segments
inline int blocks(int e, int s, int sms) {
  long long g = (static_cast<long long>(e) + s + kThreads - 1) / kThreads;
  if (g > sms) g = sms;
  if (g > s) g = s;  // no block without a segment
  const long long need = (static_cast<long long>(s) + kSegs - 1) / kSegs;
  if (g < need) g = need;
  return static_cast<int>(g < 1 ? 1 : g);
}

// out[t] = sum of data[e] over the edges e with ids[e] = t, in edge order,
// for the segments [sb, se) of this block (an equal count a block, as the
// CSR kernel's), with the CSR kernel's warp slices, order and combine over
// the block's positions.  DBG also writes the block's slice of the
// permutation (perm_dbg, global positions) and its row_ptr entries.
template <int NC, bool DBG>
__global__ void __launch_bounds__(kThreads)
us_sum_kernel(const float* __restrict__ data, const int* __restrict__ ids,
              float* __restrict__ out, int n_edges, int n_seg, int f,
              int* __restrict__ perm_dbg, int* __restrict__ rp_dbg) {
  extern __shared__ int smem[];
  int* base = smem;                   // [t * kWarps + w]: (segment, warp)
  int* run = base + kSegs * kWarps;   // running positions of a round
  int* rp = run + kSegs * kWarps;     // the block's row_ptr, from 0
  int* pw = rp + kSegs + 1;           // positions [R, R + kWindow) -> edge
  __shared__ float2 part[2][kWarps][NC][kWarp];
  __shared__ int red[3][kWarps];
  __shared__ int tot[kWarps];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int sb = static_cast<int>(static_cast<long long>(n_seg) * blockIdx.x /
                                  gridDim.x);
  const int se = static_cast<int>(static_cast<long long>(n_seg) *
                                  (blockIdx.x + 1) / gridDim.x);
  const unsigned ns = static_cast<unsigned>(se - sb);  // <= kSegs
  auto key_of = [&](int id) {  // the owned segment of an id, or -1
    const unsigned k = static_cast<unsigned>(id) - static_cast<unsigned>(sb);
    return k < ns ? static_cast<int>(k) : -1;
  };
  for (int i = threadIdx.x; i < kSegs * kWarps; i += kThreads) base[i] = 0;

  // 1. the span: the first and last edge whose id the block owns (and,
  //    DBG, the in-range ids below sb: the block's first global position)
  int lo = 0x7fffffff, hi = -1, below = 0;
  auto test = [&](int id, int e) {
    if (key_of(id) >= 0) {
      lo = min(lo, e);
      hi = max(hi, e);
    }
    if (DBG && id >= 0 && id < sb) ++below;
  };
  {
    const int n4 = n_edges >> 2;
    const int4* ids4 = reinterpret_cast<const int4*>(ids);
    int i = threadIdx.x;
    for (; i + 3 * kThreads < n4; i += 4 * kThreads) {
      int4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = __ldg(ids4 + i + u * kThreads);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = 4 * (i + u * kThreads);
        test(v[u].x, e);
        test(v[u].y, e + 1);
        test(v[u].z, e + 2);
        test(v[u].w, e + 3);
      }
    }
    for (; i < n4; i += kThreads) {
      const int4 v = __ldg(ids4 + i);
      test(v.x, 4 * i);
      test(v.y, 4 * i + 1);
      test(v.z, 4 * i + 2);
      test(v.w, 4 * i + 3);
    }
    for (int e = 4 * n4 + threadIdx.x; e < n_edges; e += kThreads)
      test(__ldg(ids + e), e);
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if (DBG) below = __reduce_add_sync(kFull, below);
  if (lane == 0) {
    red[0][wid] = lo;
    red[1][wid] = hi;
    red[2][wid] = below;
  }
  __syncthreads();
  lo = red[0][0];
  hi = red[1][0];
  int q0 = red[2][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    lo = min(lo, red[0][w]);
    hi = max(hi, red[1][w]);
    if (DBG) q0 += red[2][w];
  }
  // the warps' equal parts of [lo, hi]: where each counts and places
  if (hi < lo) lo = hi = -1;  // no owned id: empty parts
  const int len = hi - lo + (hi >= 0 ? 1 : 0);
  const int ca = lo + static_cast<int>(static_cast<long long>(len) * wid /
                                       kWarps);
  const int cb = lo + static_cast<int>(static_cast<long long>(len) *
                                       (wid + 1) / kWarps);

  // the keys of kIdLoads loads of 32 ids of the warp's part from e0, all
  // in flight at once (-1 past the part)
  auto load_keys = [&](int e0, int (&key)[kIdLoads]) {
    int id[kIdLoads];
#pragma unroll
    for (int j = 0; j < kIdLoads; ++j) {
      const int e = e0 + j * kWarp + lane;
      id[j] = e < cb ? __ldg(ids + e) : -1;
    }
#pragma unroll
    for (int j = 0; j < kIdLoads; ++j)
      key[j] = e0 + j * kWarp + lane < cb ? key_of(id[j]) : -1;
  };

  // 2. counts per (owned segment, warp part), 32 ids a step; a key's
  //    lanes add once (__match_any_sync), no atomics
  for (int e0 = ca; e0 < cb; e0 += kIdLoads * kWarp) {
    int key[kIdLoads];
    load_keys(e0, key);
#pragma unroll
    for (int j = 0; j < kIdLoads; ++j) {
      if (__ballot_sync(kFull, key[j] >= 0) == 0) continue;
      const unsigned m = __match_any_sync(kFull, key[j]);
      if (key[j] >= 0 && lane == __ffs(m) - 1)
        base[key[j] * kWarps + wid] += __popc(m);
      __syncwarp();
    }
  }
  __syncthreads();

  // 3. exclusive prefix over (segment, warp) order: kSegs * kWarps =
  //    4 * kThreads entries, 4 consecutive a thread
  {
    int v[4], s = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = base[4 * threadIdx.x + j];
      s += v[j];
    }
    int inc = s;  // inclusive scan of the threads' sums within the warp
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int t = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += t;
    }
    if (lane == kWarp - 1) tot[wid] = inc;
    __syncthreads();
    int before = inc - s;
    for (int w = 0; w < wid; ++w) before += tot[w];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      base[4 * threadIdx.x + j] = before;
      run[4 * threadIdx.x + j] = before;
      before += v[j];
    }
  }
  __syncthreads();
  int n_in = 0;  // the block's positions
#pragma unroll
  for (int w = 0; w < kWarps; ++w) n_in += tot[w];
  for (int t = threadIdx.x; t < static_cast<int>(ns); t += kThreads)
    rp[t] = base[t * kWarps];
  if (threadIdx.x == 0) rp[ns] = n_in;
  __syncthreads();
  if (DBG) {
    for (int t = threadIdx.x; t < static_cast<int>(ns); t += kThreads)
      rp_dbg[sb + t] = q0 + rp[t];
    if (se == n_seg && threadIdx.x == 0) rp_dbg[n_seg] = q0 + n_in;
  }
  // the block's empty segments: zeros (the walks write the others)
  for (int t = wid; t < static_cast<int>(ns); t += kWarps)
    if (rp[t] == rp[t + 1])
      for (int c = 2 * lane; c < f; c += kCols)
        st2(out + static_cast<size_t>(sb + t) * f + c, make_float2(0.f, 0.f));

  // 4. the sum: route 1 of the CSR kernel over positions [0, n_in), in
  //    rounds of kWindow positions placed in shared memory
  const int a = ss::slice_begin(0, n_in, wid);
  const int b = ss::slice_begin(0, n_in, wid + 1);
  bool on[NC];  // f even: col + 1 < f too
#pragma unroll
  for (int j = 0; j < NC; ++j) on[j] = j * kCols + 2 * lane < f;
  auto store = [&](int t, const float2 (&v)[NC]) {
#pragma unroll
    for (int j = 0; j < NC; ++j)
      if (on[j])
        st2(out + static_cast<size_t>(sb + t) * f + j * kCols + 2 * lane,
            v[j]);
  };
  auto keep = [&](int slot, const float2 (&v)[NC]) {
#pragma unroll
    for (int j = 0; j < NC; ++j) part[slot][wid][j][lane] = v[j];
  };
  // the segment of position a (the largest t with rp[t] <= a), its first
  // and end positions
  int t0 = 0;
  if (a < b) {
    int l = 0, h = static_cast<int>(ns) - 1;
    while (l < h) {
      const int mid = (l + h + 1) >> 1;
      if (rp[mid] <= a) l = mid; else h = mid - 1;
    }
    t0 = l;
  }
  const int start0 = rp[t0], end0 = rp[t0 + 1];
  int t = t0, start = start0, end = end0, p = a;
  float2 acc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = make_float2(0.f, 0.f);
  auto finish = [&]() {
    if (start < a)
      keep(0, acc);
    else if (start < end)
      store(t, acc);
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[j] = make_float2(0.f, 0.f);
    start = end;
    ++t;
    end = rp[t + 1];
  };
  constexpr int U = kRowsInFlight / NC;
  for (int r0 = 0; r0 < n_in; r0 += kWindow) {
    if (r0 > 0) {
      for (int i = threadIdx.x; i < kSegs * kWarps; i += kThreads)
        run[i] = base[i];
      __syncthreads();
    }
    // placement: each owned id's position is its (segment, warp) start
    // plus its rank among them, in edge order
    for (int e0 = ca; e0 < cb; e0 += kIdLoads * kWarp) {
      int key[kIdLoads];
      load_keys(e0, key);
#pragma unroll
      for (int j = 0; j < kIdLoads; ++j) {
        if (__ballot_sync(kFull, key[j] >= 0) == 0) continue;
        const unsigned m = __match_any_sync(kFull, key[j]);
        if (key[j] >= 0) {
          const int pos = run[key[j] * kWarps + wid] +
                          __popc(m & ((1u << lane) - 1u));
          if (pos >= r0 && pos < r0 + kWindow) {
            const int e = e0 + j * kWarp + lane;
            pw[pos - r0] = e;
            if (DBG) perm_dbg[q0 + pos] = e;
          }
        }
        __syncwarp();
        if (key[j] >= 0 && lane == __ffs(m) - 1)
          run[key[j] * kWarps + wid] += __popc(m);
        __syncwarp();
      }
    }
    __syncthreads();
    // this warp's slice within the round's window, in position order
    const int wend = min(b, r0 + kWindow);
    while (p < wend) {
      while (p >= end) finish();
      const int n_u = min(U, wend - p);
      float2 v[U][NC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int row = u < n_u ? pw[p - r0 + u] : 0;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          v[u][j] = make_float2(0.f, 0.f);
          if (u < n_u && on[j])
            v[u][j] = walk::ldcs2(data + static_cast<size_t>(row) * f +
                                  j * kCols + 2 * lane);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u >= n_u) break;
        while (p + u >= end) finish();
#pragma unroll
        for (int j = 0; j < NC; ++j) ss::add2(acc[j], v[u][j]);
      }
      p += n_u;
    }
    __syncthreads();  // before the next round overwrites the window
  }
  // the segment of the slice's last position
  if (a < b) {
    if (end > b)
      keep(start < a ? 0 : 1, acc);
    else if (start < a)
      keep(0, acc);
    else
      store(t, acc);
  }
  __syncthreads();
  // the combine, as the CSR kernel's: the tail partial of the slice that
  // holds the segment's first position, then the head partials after it
  if (a < b && start0 < a && end0 <= b) {
    int w0 = wid - 1;
    while (ss::slice_begin(0, n_in, w0) > start0) --w0;
    float2 s[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) s[j] = part[1][w0][j][lane];
    for (int v = w0 + 1; v <= wid; ++v)
      if (ss::slice_begin(0, n_in, v) < ss::slice_begin(0, n_in, v + 1)) {
#pragma unroll
        for (int j = 0; j < NC; ++j) ss::add2(s[j], part[0][v][j][lane]);
      }
    store(t0, s);
  }
}

template <int NC, bool DBG>
cudaError_t launch(const float* data, const int* ids, float* out, int n_edges,
                   int n_seg, int f, int grid, int* perm_dbg, int* rp_dbg,
                   cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      us_sum_kernel<NC, DBG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  us_sum_kernel<NC, DBG><<<grid, kThreads, kSmemBytes, st>>>(
      data, ids, out, n_edges, n_seg, f, perm_dbg, rp_dbg);
  return cudaGetLastError();
}

}  // namespace us

// the route of the CSR segment sum at width f: 1 for even f (a float2 a
// lane), 2 (the first design) for odd f
inline int segment_sum_route(int f) { return f > 0 && f % 2 == 0 ? 1 : 2; }

// the route of the unsorted segment sum (e ids, s segments, width f): 1
// (the schedule in each block's shared memory, one launch) at even f up
// to 128 and s up to us::kMaxSegments (which bounds the blocks, each of
// which reads all e ids); 2 (a stable torch.sort of the ids, then the
// CSR kernel) past that.  e only has to fit an int, as everywhere here.
inline int unsorted_sum_route(int e, int s, int f) {
  return e >= 0 && s >= 0 && s <= us::kMaxSegments && f > 0 && f % 2 == 0 &&
                 f <= 2 * us::kCols
             ? 1
             : 2;
}

inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// the route of the gather-multiply kernel and its backward at width f:
// 1 for even f (a float2 a lane), 2 (the first design) for odd f
inline int gather_mul_route(int f) { return f > 0 && f % 2 == 0 ? 1 : 2; }

inline unsigned grid_for(int rows) {
  return static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace

extern "C" int hg_gather_mul_route(int f) { return gather_mul_route(f); }

// Returns the cudaError_t of the launch (0 = success).  Pointers are device
// pointers; the launch goes on `stream` and does not synchronise.  `route`:
// 0 the width's own (hg_gather_mul_route), 1 or 2 that one (1 only at an
// even f); x, w and out 8-byte aligned on route 1.
extern "C" int hg_gather_mul_segment_sum_f32(
    const void* x, const void* w, const void* mask, const void* senders,
    const void* row_ptr, void* out, int n_rows, int n_src, int f, int has_w,
    int route, void* stream) {
  if (route == 0) route = gather_mul_route(f);
  if (route < 1 || route > 2 || (route == 1 && gather_mul_route(f) != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0 || f <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* mf = static_cast<const float*>(mask);
  const int* sp = static_cast<const int*>(senders);
  const int* rp = static_cast<const int*>(row_ptr);
  float* of = static_cast<float*>(out);
  if (route == 1) {
    int grid = 0;
    cudaError_t err;
    if (has_w) {
      err = walk::persistent_grid(gm::gm_fwd_kernel<kMulW>, gm::kWarps,
                                  n_rows, gm::kWarps, &grid);
      if (err != cudaSuccess) return static_cast<int>(err);
      gm::gm_fwd_kernel<kMulW><<<grid, kWarp * gm::kWarps, 0, st>>>(
          xf, wf, nullptr, sp, rp, of, n_rows, n_src, f);
    } else {
      err = walk::persistent_grid(gm::gm_fwd_kernel<kMask>, gm::kWarps,
                                  n_rows, gm::kWarps, &grid);
      if (err != cudaSuccess) return static_cast<int>(err);
      gm::gm_fwd_kernel<kMask><<<grid, kWarp * gm::kWarps, 0, st>>>(
          xf, nullptr, mf, sp, rp, of, n_rows, n_src, f);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 block(kWarp * kRowsPerBlock);
  if (has_w) {
    gather_mul_segment_sum_kernel<kMulW><<<grid_for(n_rows), block, 0, st>>>(
        xf, wf, nullptr, sp, rp, of, n_rows, n_src, f);
  } else {
    gather_mul_segment_sum_kernel<kMask><<<grid_for(n_rows), block, 0, st>>>(
        xf, nullptr, mf, sp, rp, of, n_rows, n_src, f);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward's route 1 (gm_bwd_kernel) on the sender CSR `row_ptr` over
// positions (`perm`: position -> edge): dx [n_rows, f] and, with has_w,
// dw [n_edges, f]; a null dx or dw is not written, a null mask reads ones.
// g, x, w, dx and dw 8-byte aligned; f even (hg_gather_mul_route).
extern "C" int hg_gather_mul_bwd_f32(
    const void* g, const void* x, const void* w, const void* mask,
    const void* perm, const void* receivers, const void* row_ptr, void* dx,
    void* dw, int n_rows, int n_src, int n_edges, int f, int has_w,
    void* stream) {
  if (gather_mul_route(f) != 1 || n_rows <= 0 || (!has_w && dw != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dx == nullptr && dw == nullptr) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* mf = static_cast<const float*>(mask);
  const int* pp = static_cast<const int*>(perm);
  const int* rv = static_cast<const int*>(receivers);
  const int* rp = static_cast<const int*>(row_ptr);
  float* dxf = static_cast<float*>(dx);
  float* dwf = static_cast<float*>(dw);
  int grid = 0;
  cudaError_t err;
  if (has_w) {
    err = walk::persistent_grid(gm::gm_bwd_kernel<kMulW>, gm::kWarps, n_rows,
                                gm::kWarps, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    gm::gm_bwd_kernel<kMulW><<<grid, kWarp * gm::kWarps, 0, st>>>(
        gf, xf, wf, nullptr, pp, rv, rp, dxf, dwf, n_rows, n_src, n_edges,
        f);
  } else {
    err = walk::persistent_grid(gm::gm_bwd_kernel<kMask>, gm::kWarps, n_rows,
                                gm::kWarps, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    gm::gm_bwd_kernel<kMask><<<grid, kWarp * gm::kWarps, 0, st>>>(
        gf, nullptr, nullptr, mf, pp, rv, rp, dxf, nullptr, n_rows, n_src,
        n_edges, f);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hg_segment_sum_route(int f) { return segment_sum_route(f); }

// `perm` (may be null) maps a CSR position to its data row (of `n_rows`);
// each segment sums at most its first `max_rows` positions.  `route`: 0
// the width's own (hg_segment_sum_route), 1 or 2 that one (1 only at an
// even f); data and out 8-byte aligned on route 1.  `n_blocks` > 0 runs
// route 1 on that many blocks (the unsorted sum's checks), 0 on its own.
extern "C" int hg_segment_sum_rows_f32(const void* data, const void* perm,
                                       const void* row_ptr, void* out,
                                       int n_rows, int n_seg, int f,
                                       int max_rows, int route, int n_blocks,
                                       void* stream) {
  if (route == 0) route = segment_sum_route(f);
  if (route < 1 || route > 2 || (route == 1 && segment_sum_route(f) != 1) ||
      max_rows < 0 || n_blocks < 0 || (route == 2 && n_blocks != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_seg <= 0 || f <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* df = static_cast<const float*>(data);
  const int* pp = static_cast<const int*>(perm);
  const int* rp = static_cast<const int*>(row_ptr);
  float* of = static_cast<float*>(out);
  if (route == 1)
    return static_cast<int>(
        pp != nullptr
            ? ss::launch_by_width<true>(df, pp, rp, of, n_seg, n_rows, f,
                                        max_rows, n_blocks, st)
            : ss::launch_by_width<false>(df, nullptr, rp, of, n_seg, n_rows,
                                         f, max_rows, n_blocks, st));
  const dim3 block(kWarp * kRowsPerBlock);
  if (pp != nullptr) {
    segment_sum_dense_kernel<true><<<grid_for(n_seg), block, 0, st>>>(
        df, pp, rp, of, n_seg, f, max_rows);
  } else {
    segment_sum_dense_kernel<false><<<grid_for(n_seg), block, 0, st>>>(
        df, nullptr, rp, of, n_seg, f, max_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hg_unsorted_sum_route(int e, int s, int f) {
  return unsorted_sum_route(e, s, f);
}

// The blocks route 1 of the unsorted sum launches for e ids over s
// segments on this card (a cudaError_t, negated, on failure).
extern "C" int hg_unsorted_sum_blocks(int e, int s, int f) {
  if (unsorted_sum_route(e, s, f) != 1 || s == 0)
    return -static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return us::blocks(e, s, sms);
}

// Route 1 of the unsorted segment sum: out [n_seg, f] (every row written)
// = the sum of data [n_edges, f] rows by ids [n_edges] (int32, any order;
// ids outside [0, n_seg) dropped), in one launch.  `n_blocks` 0 takes
// hg_unsorted_sum_blocks', else that many (at least one for every
// us::kSegs segments).  With `rp_dbg` [n_seg + 1] and `perm_dbg` [n_edges]
// (null only when n_edges is 0) the blocks also write the schedule they
// built: the
// stable sort's permutation of the in-range ids and its CSR offsets.
// data and out 8-byte aligned, ids 16-byte aligned.
extern "C" int hg_unsorted_sum_f32(const void* data, const void* ids,
                                   void* out, void* perm_dbg, void* rp_dbg,
                                   int n_edges, int n_seg, int f,
                                   int n_blocks, void* stream) {
  if (unsorted_sum_route(n_edges, n_seg, f) != 1 || n_blocks < 0 ||
      (perm_dbg != nullptr && rp_dbg == nullptr) ||
      (rp_dbg != nullptr && perm_dbg == nullptr && n_edges > 0) ||
      reinterpret_cast<uintptr_t>(ids) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(data) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_seg == 0) return 0;
  int grid = n_blocks;
  if (grid == 0) {
    int sms = 0;
    const cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    grid = us::blocks(n_edges, n_seg, sms);
  }
  if ((static_cast<long long>(n_seg) + grid - 1) / grid > us::kSegs)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* df = static_cast<const float*>(data);
  const int* ip = static_cast<const int*>(ids);
  float* of = static_cast<float*>(out);
  int* pd = static_cast<int*>(perm_dbg);
  int* rd = static_cast<int*>(rp_dbg);
  cudaError_t err;
  if (f <= us::kCols)
    err = rd ? us::launch<1, true>(df, ip, of, n_edges, n_seg, f, grid, pd,
                                   rd, st)
             : us::launch<1, false>(df, ip, of, n_edges, n_seg, f, grid,
                                    nullptr, nullptr, st);
  else
    err = rd ? us::launch<2, true>(df, ip, of, n_edges, n_seg, f, grid, pd,
                                   rd, st)
             : us::launch<2, false>(df, ip, of, n_edges, n_seg, f, grid,
                                    nullptr, nullptr, st);
  return static_cast<int>(err);
}
