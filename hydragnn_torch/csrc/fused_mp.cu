// Hand-written Hopper (sm_90a) kernels for the two sorted-segment
// reductions on the SchNet prediction path.  Plain C interface, loaded with
// ctypes by hydragnn_torch/kernels/build.py; wrappers, plain PyTorch
// versions and launch counters live in hydragnn_torch/ops/fused_mp.py.
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
//   With a row permutation it also replaces the two kernels of the
//   reference's `pallas` aggregation backend, both plain segment sums:
//   hydragnn_tpu/ops/aggregate.py:_pallas_segment_sum_impl (pl.pallas_call
//   at :157, any id order: a blocked one-hot contraction on the MXU) and
//   :_sorted_impl (:244, nondecreasing ids).  On Hopper the one-hot tile
//   is wasted work: the wrapper's stable sort of the ids is the schedule
//   (perm, CSR offsets, out-of-range ids parked past the last segment) and
//   the rows are summed in id-then-edge order through perm.  Same bound
//   (bytes), plus the 4-byte perm entry per row.  The sorted function's
//   cap keeps collate's padding segment (every padding edge on node N-1,
//   pre-masked to zeros) from costing thousands of rows, as the
//   reference's cap drops those rows.
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
//   launch against route 2's 11.90.  Plain loads in place of the
//   streaming ones: edge rows 0.0241 against 0.0221, tie counts 0.0383
//   against 0.0346 (the pool ties).

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

// the kernel at NC chunks a walk: one at 64 columns or fewer, else two
template <bool PERM, int NC>
cudaError_t launch(const float* data, const int* perm, const int* row_ptr,
                   float* out, int n_seg, int n_data, int f, int max_rows,
                   cudaStream_t st) {
  // at most one block for every kWarps units of work (rows + segments)
  int grid = 0;
  const cudaError_t err = walk::persistent_grid(
      seg_sum_kernel<PERM, NC>, kWarps, static_cast<long long>(n_data) + n_seg,
      kWarps, &grid);
  if (err != cudaSuccess) return err;
  seg_sum_kernel<PERM, NC><<<grid, kWarp * kWarps, 0, st>>>(
      data, perm, row_ptr, out, n_seg, f, max_rows);
  return cudaGetLastError();
}

template <bool PERM>
cudaError_t launch_by_width(const float* data, const int* perm,
                            const int* row_ptr, float* out, int n_seg,
                            int n_data, int f, int max_rows,
                            cudaStream_t st) {
  return f <= kCols
             ? launch<PERM, 1>(data, perm, row_ptr, out, n_seg, n_data, f,
                               max_rows, st)
             : launch<PERM, 2>(data, perm, row_ptr, out, n_seg, n_data, f,
                               max_rows, st);
}

}  // namespace ss

// the route of the CSR segment sum at width f: 1 for even f (a float2 a
// lane), 2 (the first design) for odd f
inline int segment_sum_route(int f) { return f > 0 && f % 2 == 0 ? 1 : 2; }

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
// even f); data and out 8-byte aligned on route 1.
extern "C" int hg_segment_sum_rows_f32(const void* data, const void* perm,
                                       const void* row_ptr, void* out,
                                       int n_rows, int n_seg, int f,
                                       int max_rows, int route,
                                       void* stream) {
  if (route == 0) route = segment_sum_route(f);
  if (route < 1 || route > 2 || (route == 1 && segment_sum_route(f) != 1) ||
      max_rows < 0)
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
                                        max_rows, st)
            : ss::launch_by_width<false>(df, nullptr, rp, of, n_seg, n_rows,
                                         f, max_rows, st));
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
