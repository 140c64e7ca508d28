// Hand-written Hopper (sm_90a) kernels for CGCNN's fused gated sum
//
//   z_e    = [x[r_e], x[s_e], ea_e]                   (r receiver, s sender)
//   tf     = x[r].Wfr + x[s].Wfs + ea.Wfg + bf          [D]
//   ts     = x[r].Wsr + x[s].Wss + ea.Wsg + bs          [D]
//   out[r] += sigmoid(tf) * softplus(ts)
//
// Plain C interface, loaded with ctypes by hydragnn_torch/kernels/build.py;
// wrappers, plain PyTorch versions and launch counters live in
// hydragnn_torch/ops/cgcnn_mp.py.  Float32 throughout; the composed path's
// concat kernels kf, ks [2F+A, D] are split by row ranges into the
// receiver, sender and edge-attribute blocks (each [rows, D] row-major);
// the biases stay vectors (Hopper needs no bias lane).
//
// softplus is torch.nn.functional.softplus's numerically safe form (beta 1,
// threshold 20): softplus(v) = v for v > 20, else log1p(exp(v)); its
// derivative is 1 above the threshold, else exp(v) / (exp(v) + 1), as in
// PyTorch's own backward.  sigmoid(v) = 1 / (1 + exp(-v)).
//
// cgcnn_node_table_kernel + cgcnn_fwd_kernel — the forward.  Replaces
//   hydragnn_tpu/ops/fused_block.py:_fused_fwd with the cgcnn spec of
//   hydragnn_tpu/ops/cgcnn_mp.py (pl.pallas_call at :495).  x's products
//   factor to the nodes (x[r].Wfr = (x.Wfr)[r]), so the node table x .
//   [Wfr | Wsr | Wfs | Wss] ([N, 4D], 3xTF32 on the tensor cores, the
//   kernel pass P runs) is built first; then each warp owns one receiver
//   row (receiver order: collate's receivers are nondecreasing, so edge ids
//   are CSR positions), holds the table's receiver half [tf_r | ts_r] plus
//   the biases in registers, and per edge gathers the sender's half [tf_s |
//   ts_s] (lane l its V = ceil(D / 32), rounded to a power of two,
//   consecutive columns, one vector load each where D % V == 0), adds ea .
//   [Wfg | Wsg] at A > 0 (weights read through L1) and sums sigmoid(tf) *
//   softplus(ts) into the row in edge order.  The sender ids come 32 at a
//   time, one load a lane, and are broadcast by shuffles; the gathers of
//   16 / V edges are issued before any of them is used.  Bound: operations
//   (the table's products, at 3xTF32, and ~4D per edge); what decides the
//   time is the latency of the dependent loads (row_ptr, the ids, the
//   gathered rows from L2), which the warps in flight hide.  One route:
//   every width the op takes (F, D <= 256, A <= 127).
// cgcnn_pass_s_sums_kernel + cgcnn_row_product_kernel — backward pass S,
//   every width the op takes.  Replaces :_fused_bwd pass S
//   (pl.pallas_call at :599).  dx of the sender side is sum over s's edges
//   of dtf.Wfs^T + dts.Wss^T = [sum dtf | sum dts] . [Wfs | Wss]^T, and tf,
//   ts are gathered sums from pass P's node table (the same backward hands
//   it over; nothing builds it twice).  So: one warp per sender row, walked
//   in sender-position order through edge_perm_sender, holds its own
//   [T[s, 2D:3D] + bf | T[s, 3D:4D] + bs] in registers (lane l its V
//   columns, as the forward), per edge gathers the receiver's T[r, 0:2D]
//   and dout[r] (the edge ids and receiver ids 32 at a time, one load a
//   lane, broadcast by shuffles; the gathers of a group of max(1, 4 / V)
//   edges issued before any of them is used), adds ea . [Wfg | Wsg] at
//   A > 0, forms dtf, dts and sums them into the row in position order:
//   [N, 2D] sums, no [E, .] tensor.  Then dx = sums . [Wfs | Wss]^T, one
//   [2D] . [2D, F] product a row, in 3xTF32 on the tensor cores (blocks of
//   64 rows x 64 columns, as the node table's).  Bound: bytes at the
//   path's widths (the table, dout and the ids read once; ~12 D flops an
//   edge and the row product's 4 D F a node lie below them); what decides
//   the time is the latency of the dependent loads (the ids, then the
//   gathered rows from L2), which the warps a SM holds hide: fewer edges
//   in flight a warp and so more warps were faster on the card.
//
// cgcnn_node_table_kernel + cgcnn_pass_p_kernel (+ the fixed-order
// reductions) — backward pass P.  Replaces :_fused_bwd pass P
// (pl.pallas_call at :561).  With the row's own cotangent g = dout[r]:
//     dtf = g * softplus(ts) * sigmoid(tf) (1 - sigmoid(tf))
//     dts = g * sigmoid(tf) * softplus'(ts)
//   and the weight blocks' and biases' gradients, dx of the receiver side
//   and the per-edge d ea.  Bound: operations; x's products factor to the
//   nodes (x[r].W = (x.W)[r]; sum_e x[r]^T dtf = x[r]^T (sum over r's
//   edges of dtf)), so the work is ~2 (F + A) * 2D multiply-adds per edge
//   and ~8 F D per node.  Design: the node table x . [Wfr | Wsr | Wfs |
//   Wss] ([N, 4D], L2-resident) is computed once per launch (and left for
//   pass S), so tf and ts are gathered sums; the grid is (part p, slice j
//   of wp output columns), a part is a run of whole receiver rows with
//   about n_valid / n_parts edges, walked kPR rows at a time and their
//   edges kPE at a time.  Per
//   edge only [dtf | dts] and the sender-side products remain:
//   sum_e [x[s] | ea]^T [dtf | dts] (dWfs, dWss, dWfg, dWsg); per row,
//   once, the row sums of [dtf | dts] give dWfr, dWsr (x[r]^T . sum) and
//   dx_r (sum . [Wfr | Wsr]^T).  Every product runs on the tensor cores in
//   3xTF32 (pass_p.cuh: each k step's products from zero, then a float32
//   add), with the gradient sums accumulated in shared memory over the
//   part's whole share and written once; the row sums and the biases'
//   sums are compensated, and each tile's ids are loaded during the tile
//   before it.  The slice width wp is the widest multiple of 16 whose tiles
//   fit the device's shared memory (hg_cgcnn_pass_p_width: all of D up to
//   64 at F = D = 64; 16 at F = D = 256, the slower route); with more than
//   one slice, dx and d ea are per-slice partials summed in slice order.
//   Block (p, j) writes its columns of the weight gradients straight into
//   part p's partial in the packed layout of `wgrad` (the slices' columns
//   are disjoint), and the reduce kernel sums the parts in order.
//
// Contract (collate guarantees it): positions are sorted by output row, so
// each row owns one contiguous CSR range; masked edges sort last in both
// orderings and are parked out of every range by the wrapper, so they are
// never read and every gradient on them is exactly zero (the wrapper
// zero-fills d ea).  Gather ids outside [0, n_rows) contribute nothing.
// Determinism: every sum runs in a fixed order (edge order within a row;
// tile, then part, then slice order for the weight gradients and the
// per-slice partials); no atomics.  Every output row is written, rows
// without edges as zeros.

#include <cuda_runtime.h>

#include "pass_p.cuh"

namespace {

constexpr int kMaxF = 256;
constexpr int kMaxD = 256;
constexpr int kMaxA = 127;

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.f / (1.f + expf(-v));
}

// torch.nn.functional.softplus (beta 1, threshold 20)
__device__ __forceinline__ float softplus_f(float v) {
  return v > 20.f ? v : log1pf(expf(v));
}

// d softplus / dv, as PyTorch's softplus backward computes it
__device__ __forceinline__ float softplus_grad(float v) {
  if (v > 20.f) return 1.f;
  const float z = expf(v);
  return z / (z + 1.f);
}

// ---------------------------------------------------------------------------
// pass P
// ---------------------------------------------------------------------------

constexpr int kPThreads = 512;
constexpr int kPWarps = kPThreads / 32;
constexpr int kPE = 32;   // edges per tile
constexpr int kPR = 16;   // receiver rows per chunk

// x . [Wfr | Wsr | Wfs | Wss] for every node, [N, 4D], in 3xTF32: blocks
// of 64 nodes x 64 columns, four warps of 16 nodes, depth in steps of 32
__global__ void __launch_bounds__(128)
cgcnn_node_table_kernel(const float* __restrict__ x,
                        const float* __restrict__ wfr,
                        const float* __restrict__ wsr,
                        const float* __restrict__ wfs,
                        const float* __restrict__ wss,
                        float* __restrict__ table, int n, int f, int d) {
  using namespace passp;
  __shared__ float xs[64 * 36];   // x rows [node][k], stride 36
  __shared__ float ws[32 * 72];   // weight columns [k][col], stride 72
  const int tid = threadIdx.x, warp = tid >> 5;
  const int r0 = blockIdx.x * 64, c0 = blockIdx.y * 64, w4 = 4 * d;
  const float* wq[4] = {wfr, wsr, wfs, wss};
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[nt][v] = 0.f;
  for (int k0 = 0; k0 < f; k0 += 32) {
    __syncthreads();
    for (int i = tid; i < 64 * 32; i += 128) {
      const int r = i / 32, k = i - r * 32;
      xs[r * 36 + k] = r0 + r < n && k0 + k < f
          ? x[static_cast<size_t>(r0 + r) * f + k0 + k] : 0.f;
    }
    for (int i = tid; i < 32 * 64; i += 128) {
      const int k = i / 64, c = i - k * 64, col = c0 + c;
      ws[k * 72 + c] = k0 + k < f && col < w4
          ? wq[col / d][static_cast<size_t>(k0 + k) * d + col % d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 32; kk += 8) {
      FragA fa;
      load_a(fa, xs + 16 * warp * 36 + kk, 36, 1);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        FragB fb;
        load_b(fb, ws + kk * 72 + nt * 8, 72, 1);
        mma3(acc[nt], fa, fb);
      }
    }
  }
  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = r0 + 16 * warp + g + 8 * (v >> 1);
      const int col = c0 + nt * 8 + 2 * t + (v & 1);
      if (r < n && col < w4)
        table[static_cast<size_t>(r) * w4 + col] = acc[nt][v];
    }
}

// ---------------------------------------------------------------------------
// the forward: the node table (above), then a gathered sum per receiver row
// ---------------------------------------------------------------------------

constexpr int kFThreads = 256;
constexpr int kFWarps = kFThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct FwdArgs {
  const float* table;    // [N, 4D]: x . [Wfr | Wsr | Wfs | Wss]
  const float* ea;       // [E, A], or null when A = 0
  const int* send;       // [E], receiver order
  const int* row_ptr;    // [N + 1] CSR over positions (edge ids)
  const float *bf, *bs;  // [D]
  const float *wfg, *wsg;  // [A, D], or null when A = 0
  float* out;            // [N, D]
  int n_rows, d, a;
};

// v = this lane's V columns c0 .. c0 + V - 1 of a row at `src`, zeros past
// D: one vector load where D % V == 0 (then a lane's columns lie wholly
// below D or wholly past it, and the address is 4V-byte aligned in a row
// of 4D floats), else guarded scalar loads
template <int V>
__device__ __forceinline__ void load_cols(float (&v)[V], const float* src,
                                          int c0, int d) {
  if (d % V == 0) {
    if (c0 < d) {
      if constexpr (V == 1) {
        v[0] = __ldg(src + c0);
      } else if constexpr (V == 2) {
        const float2 u = __ldg(reinterpret_cast<const float2*>(src + c0));
        v[0] = u.x;
        v[1] = u.y;
      } else {
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
          const float4 u =
              __ldg(reinterpret_cast<const float4*>(src + c0) + q);
          v[4 * q] = u.x;
          v[4 * q + 1] = u.y;
          v[4 * q + 2] = u.z;
          v[4 * q + 3] = u.w;
        }
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = 0.f;
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = c0 + j < d ? __ldg(src + c0 + j) : 0.f;
}

// One warp a receiver row r: out[r] = sum over r's edges e, in edge order,
// of sigmoid(tf) * softplus(ts), with tf = (T[r, 0:D] + bf) + T[s, 2D:3D]
// (+ ea_e . Wfg) and ts = (T[r, D:2D] + bs) + T[s, 3D:4D] (+ ea_e . Wsg).
// Lane l owns the V columns from V l.  Every load of a group of U edges
// reads a clamped, in-range address and is issued before the group's
// arithmetic, so the group's gathers are in flight at once.
template <int V>
__global__ void __launch_bounds__(kFThreads)
cgcnn_fwd_kernel(const FwdArgs p) {
  constexpr int U = V >= 8 ? 2 : 16 / V;   // 32 gathered floats a lane
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kFWarps + (threadIdx.x >> 5);
  if (r >= p.n_rows) return;
  const int d = p.d, a = p.a, c0 = V * lane;
  const size_t w4 = 4 * static_cast<size_t>(d);
  const int e_begin = __ldg(p.row_ptr + r);
  const int e_end = __ldg(p.row_ptr + r + 1);
  float hf[V], hs[V], acc[V];
  {
    const float* tr = p.table + r * w4;
    float bb[V];
    load_cols<V>(hf, tr, c0, d);
    load_cols<V>(hs, tr + d, c0, d);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      bb[j] = c0 + j < d ? __ldg(p.bf + c0 + j) : 0.f;
      hf[j] += bb[j];
      bb[j] = c0 + j < d ? __ldg(p.bs + c0 + j) : 0.f;
      hs[j] += bb[j];
      acc[j] = 0.f;
    }
  }
  for (int base = e_begin; base < e_end; base += 32) {
    const int cnt = min(32, e_end - base);
    int s_l = lane < cnt ? __ldg(p.send + base + lane) : -1;
    if (static_cast<unsigned>(s_l) >= static_cast<unsigned>(p.n_rows))
      s_l = -1;
    for (int i = 0; i < cnt; i += U) {
      float gf[U][V], gs[U][V];
      int sv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sv[u] = __shfl_sync(kFull, s_l, (i + u) & 31);
        if (i + u >= cnt) sv[u] = -1;
        const float* ts = p.table + (sv[u] >= 0 ? sv[u] : 0) * w4 + 2 * d;
        load_cols<V>(gf[u], ts, c0, d);
        load_cols<V>(gs[u], ts + d, c0, d);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (sv[u] < 0) continue;
        float vf[V], vs[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          vf[j] = hf[j] + gf[u][j];
          vs[j] = hs[j] + gs[u][j];
        }
        if (a > 0) {
          const float* ge = p.ea + static_cast<size_t>(base + i + u) * a;
          for (int q = 0; q < a; ++q) {
            const float g = __ldg(ge + q);
#pragma unroll
            for (int j = 0; j < V; ++j) {
              if (c0 + j < d) {
                vf[j] += g * __ldg(p.wfg + q * d + c0 + j);
                vs[j] += g * __ldg(p.wsg + q * d + c0 + j);
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc[j] += sigmoid_f(vf[j]) * softplus_f(vs[j]);
      }
    }
  }
  float* dst = p.out + static_cast<size_t>(r) * d;
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (c0 + j < d) dst[c0 + j] = acc[j];
}

// ---------------------------------------------------------------------------
// pass S, route 1: the node table's gathered sums per sender row, then one
// row product per sender
// ---------------------------------------------------------------------------

struct PassSArgs {
  const float* table;    // [N, 4D]: x . [Wfr | Wsr | Wfs | Wss]
  const float* ea;       // [E, A] by edge id, or null when A = 0
  const int* recv;       // [E]
  const int* perm;       // [E] sender position -> edge id
  const int* row_ptr;    // [N + 1] CSR over sender positions
  const float *bf, *bs;  // [D]
  const float *wfg, *wsg;  // [A, D], or null when A = 0
  const float* gout;     // [N, D]
  float* sums;           // [N, 2D]: [sum dtf | sum dts] per sender row
  int n_rows, d, a;
};

// One warp a sender row s: sums[s] = [sum dtf | sum dts] over s's edges e
// = (r -> s) in sender-position order, with tf = (T[s, 2D:3D] + bf) +
// T[r, 0:D] (+ ea_e . Wfg), ts = (T[s, 3D:4D] + bs) + T[r, D:2D] (+ ea_e .
// Wsg) and g = dout[r].  Lane l owns the V columns from V l of each half.
// Every load of a group of U edges reads a clamped, in-range address and
// is issued before the group's arithmetic.
template <int V>
__global__ void __launch_bounds__(kFThreads)
cgcnn_pass_s_sums_kernel(const PassSArgs p) {
  // 12 gathered floats a lane (24 at V = 8): more edges in flight cost
  // registers, and the warps a SM holds hide the latency better
  constexpr int U = V >= 4 ? 1 : 4 / V;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kFWarps + (threadIdx.x >> 5);
  if (s >= p.n_rows) return;
  const int d = p.d, a = p.a, c0 = V * lane;
  const size_t w4 = 4 * static_cast<size_t>(d);
  const int e_begin = __ldg(p.row_ptr + s);
  const int e_end = __ldg(p.row_ptr + s + 1);
  float hf[V], hs[V], sum_f[V], sum_s[V];
  {
    const float* ts = p.table + s * w4 + 2 * d;
    float bb[V];
    load_cols<V>(hf, ts, c0, d);
    load_cols<V>(hs, ts + d, c0, d);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      bb[j] = c0 + j < d ? __ldg(p.bf + c0 + j) : 0.f;
      hf[j] += bb[j];
      bb[j] = c0 + j < d ? __ldg(p.bs + c0 + j) : 0.f;
      hs[j] += bb[j];
      sum_f[j] = 0.f;
      sum_s[j] = 0.f;
    }
  }
  for (int base = e_begin; base < e_end; base += 32) {
    const int cnt = min(32, e_end - base);
    const int e_l = lane < cnt ? __ldg(p.perm + base + lane) : 0;
    int r_l = lane < cnt ? __ldg(p.recv + e_l) : -1;
    if (static_cast<unsigned>(r_l) >= static_cast<unsigned>(p.n_rows))
      r_l = -1;
    for (int i = 0; i < cnt; i += U) {
      float gf[U][V], gs[U][V], gg[U][V];
      int rv[U], ev[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        rv[u] = __shfl_sync(kFull, r_l, (i + u) & 31);
        ev[u] = __shfl_sync(kFull, e_l, (i + u) & 31);
        if (i + u >= cnt) rv[u] = -1;
        const int r = rv[u] >= 0 ? rv[u] : 0;
        const float* tr = p.table + r * w4;
        load_cols<V>(gf[u], tr, c0, d);
        load_cols<V>(gs[u], tr + d, c0, d);
        load_cols<V>(gg[u], p.gout + static_cast<size_t>(r) * d, c0, d);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (rv[u] < 0) continue;
        float vf[V], vs[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          vf[j] = hf[j] + gf[u][j];
          vs[j] = hs[j] + gs[u][j];
        }
        if (a > 0) {
          const float* ge = p.ea + static_cast<size_t>(ev[u]) * a;
          for (int q = 0; q < a; ++q) {
            const float g = __ldg(ge + q);
#pragma unroll
            for (int j = 0; j < V; ++j) {
              if (c0 + j < d) {
                vf[j] += g * __ldg(p.wfg + q * d + c0 + j);
                vs[j] += g * __ldg(p.wsg + q * d + c0 + j);
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float sg = sigmoid_f(vf[j]);
          sum_f[j] += gg[u][j] * softplus_f(vs[j]) * (sg * (1.f - sg));
          sum_s[j] += gg[u][j] * sg * softplus_grad(vs[j]);
        }
      }
    }
  }
  float* dst = p.sums + s * (2 * static_cast<size_t>(d));
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (c0 + j < d) {
      dst[c0 + j] = sum_f[j];
      dst[d + c0 + j] = sum_s[j];
    }
  }
}

// dx [N, F] = sums [N, 2D] . [Wfs | Wss]^T in 3xTF32: blocks of 64 rows x
// 64 columns, four warps of 16 rows, depth in steps of 32.  B is staged
// transposed ([column][k], stride 36), so that both the global reads
// (along a weight row) and the fragments' reads are conflict-free.
__global__ void __launch_bounds__(128)
cgcnn_row_product_kernel(const float* __restrict__ sums,
                         const float* __restrict__ wfs,
                         const float* __restrict__ wss,
                         float* __restrict__ out, int n, int f, int d) {
  using namespace passp;
  __shared__ float as[64 * 36];   // sums rows [row][k], stride 36
  __shared__ float bt[64 * 36];   // [Wfs | Wss] rows [column][k], stride 36
  const int tid = threadIdx.x, warp = tid >> 5;
  const int r0 = blockIdx.x * 64, c0 = blockIdx.y * 64, k2 = 2 * d;
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[nt][v] = 0.f;
  for (int k0 = 0; k0 < k2; k0 += 32) {
    __syncthreads();
    for (int i = tid; i < 64 * 32; i += 128) {
      const int r = i / 32, k = i - r * 32, kk = k0 + k, col = c0 + r;
      as[r * 36 + k] = r0 + r < n && kk < k2
          ? sums[static_cast<size_t>(r0 + r) * k2 + kk] : 0.f;
      float w = 0.f;
      if (col < f && kk < k2)
        w = kk < d ? wfs[static_cast<size_t>(col) * d + kk]
                   : wss[static_cast<size_t>(col) * d + kk - d];
      bt[r * 36 + k] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 32; kk += 8) {
      FragA fa;
      load_a(fa, as + 16 * warp * 36 + kk, 36, 1);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        FragB fb;
        load_b(fb, bt + nt * 8 * 36 + kk, 1, 36);
        mma3(acc[nt], fa, fb);
      }
    }
  }
  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = r0 + 16 * warp + g + 8 * (v >> 1);
      const int col = c0 + nt * 8 + 2 * t + (v & 1);
      if (r < n && col < f) out[static_cast<size_t>(r) * f + col] = acc[nt][v];
    }
}

// shared memory of one pass-P block, in floats, for slice width wp (N =
// 2 wp columns: dtf's then dts's)
struct PassPLayout {
  int n, mz, mr, fp32;
  int ldg, ldz, ldd, ldx, ldw, ldo;
  int ge, gr, zs, ds, rs, xr, wr, dxs, bias, ids, floats;
};

__host__ __device__ inline PassPLayout pass_p_layout(int f, int a, int wp) {
  PassPLayout L;
  L.n = 2 * wp;
  L.mz = (f + a + 15) / 16 * 16;   // rows of [x[s] | ea]
  L.mr = (f + 15) / 16 * 16;       // rows of x[r]
  L.fp32 = (f + 31) / 32 * 32;     // dx columns
  L.ldg = L.n + 4;
  L.ldz = L.mz + 8;
  L.ldd = L.n + 8;
  L.ldx = L.mr + 8;
  L.ldw = L.n + 4;
  L.ldo = L.fp32 + 4;
  int o = 0;
  L.ge = o; o += L.mz * L.ldg;     // sum_e [x[s] | ea]^T [dtf | dts]
  L.gr = o; o += L.mr * L.ldg;     // sum_r x[r]^T (sum over r's edges)
  L.zs = o; o += kPE * L.ldz;      // [x[s] | ea] per edge
  L.ds = o; o += kPE * L.ldd;      // [dtf | dts] per edge
  L.rs = o; o += kPR * L.ldd;      // [dtf | dts] summed per row
  L.xr = o; o += kPR * L.ldx;      // x[r] per row
  L.wr = o; o += L.fp32 * L.ldw;   // [Wfr | Wsr] of the slice, [k][col]
  L.dxs = o; o += kPR * L.ldo;     // dx per row
  L.bias = o; o += L.n;            // [bf | bs] of the slice
  L.ids = o; o += 3 * kPE;         // senders, receivers, local rows (int)
  L.floats = o;
  return L;
}

struct PassPArgs {
  const float* x;        // [N, F]
  const float* ea;       // [E, A], or null when A = 0
  const int* send;       // [E], receiver order
  const int* recv;       // [E]
  const int* row_ptr;    // [N + 1] CSR over positions
  const float* table;    // [N, 4D]: x . [Wfr | Wsr | Wfs | Wss]
  const float* w[8];     // wfr, wfs, wfg, bf, wsr, wss, wsg, bs
  const float* gout;     // [N, D]
  float* partial;        // [n_parts, 2 (2F + A + 1) D], `wgrad`'s layout
  float* dx;             // [n_slices, N, F] or null
  float* dea;            // [n_slices, E, A] or null
  int n_rows, n_edges, f, d, a, wp;
};

// the first row whose edges start at or after part's share of the valid
// edges (n_rows past the last part)
__device__ __forceinline__ int part_row(const int* row_ptr, int n_rows,
                                        int part, int n_parts) {
  if (part >= n_parts) return n_rows;
  const long long target =
      static_cast<long long>(row_ptr[n_rows]) * part / n_parts;
  int lo = 0, hi = n_rows;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (row_ptr[mid] < target)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kPThreads, 1)
cgcnn_pass_p_kernel(const PassPArgs p) {
  using namespace passp;
  const int f = p.f, d = p.d, a = p.a, wp = p.wp;
  const PassPLayout L = pass_p_layout(f, a, wp);
  const int nn = L.n;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* ge = sm + L.ge;
  float* gr = sm + L.gr;
  float* zs = sm + L.zs;
  float* ds = sm + L.ds;
  float* rs = sm + L.rs;
  float* xr = sm + L.xr;
  float* wr = sm + L.wr;
  float* dxs = sm + L.dxs;
  float* bias = sm + L.bias;
  int* s_s = reinterpret_cast<int*>(sm + L.ids);
  int* r_s = s_s + kPE;
  int* lr_s = r_s + kPE;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int j = blockIdx.y, d0 = j * wp;
  const bool want_dx = p.dx != nullptr, want_ea = p.dea != nullptr;
  const float *wfg = p.w[2], *wsg = p.w[6];

  for (int i = tid; i < (L.mz + L.mr) * L.ldg; i += kPThreads) ge[i] = 0.f;
  for (int c = tid; c < nn; c += kPThreads) {
    const int dd = d0 + c % wp;
    bias[c] = dd < d ? p.w[c < wp ? 3 : 7][dd] : 0.f;
  }
  if (want_dx) {
    for (int i = tid; i < L.fp32 * nn; i += kPThreads) {
      const int k = i / nn, c = i - k * nn, dd = d0 + c % wp;
      wr[k * L.ldw + c] = k < f && dd < d
          ? p.w[c < wp ? 0 : 4][static_cast<size_t>(k) * d + dd] : 0.f;
    }
  }
  // this part's receiver rows: whole rows, about n_valid / n_parts edges
  const int row_lo = part_row(p.row_ptr, p.n_rows, blockIdx.x, gridDim.x);
  const int row_hi = part_row(p.row_ptr, p.n_rows, blockIdx.x + 1, gridDim.x);
  float db = 0.f, dbc = 0.f;  // thread c < nn: column c of [dbf | dbs]
  // each tile's ids are loaded during the tile before it (tiles run over
  // the part's edges in order, chunk after chunk)
  int s_n = -1, r_n = -1;
  {
    const int q = p.row_ptr[row_lo] + tid;
    if (tid < kPE && q < p.n_edges) {
      s_n = p.send[q];
      r_n = p.recv[q];
    }
  }

  for (int r0 = row_lo; r0 < row_hi; r0 += kPR) {
    const int r1 = min(r0 + kPR, row_hi);
    const int eb = p.row_ptr[r0], ee = p.row_ptr[r1];
    __syncthreads();  // staging done; the previous chunk's readers are done
    for (int i = tid; i < kPR * L.ldd; i += kPThreads) rs[i] = 0.f;
    for (int i = tid; i < kPR * L.mr; i += kPThreads) {
      const int rr = i / L.mr, k = i - rr * L.mr;
      xr[rr * L.ldx + k] = r0 + rr < r1 && k < f
          ? p.x[static_cast<size_t>(r0 + rr) * f + k] : 0.f;
    }
    if (want_dx)
      for (int i = tid; i < kPR * L.ldo; i += kPThreads) dxs[i] = 0.f;

    for (int t = eb; t < ee; t += kPE) {
      const int cnt = min(kPE, ee - t);
      __syncthreads();  // rows zeroed; the previous tile's readers are done
      if (tid < kPE) {
        const bool ok =
            tid < cnt &&
            static_cast<unsigned>(s_n) < static_cast<unsigned>(p.n_rows) &&
            r_n >= r0 && r_n < r1;
        s_s[tid] = ok ? s_n : -1;
        r_s[tid] = ok ? r_n : -1;
        lr_s[tid] = ok ? r_n - r0 : 0;
        const int q = (t + kPE < ee ? t + kPE : ee) + tid;
        if (q < p.n_edges) {
          s_n = p.send[q];
          r_n = p.recv[q];
        }
      }
      __syncthreads();
      // [x[s] | ea] rows and the slice's [dtf | dts]; zeros past the tile,
      // on invalid edges and in the padding.  Every load reads a clamped,
      // in-range address and the zeros are selected after it, so an
      // unrolled group's loads are all in flight at once.
#pragma unroll 4
      for (int i = tid; i < kPE * L.mz; i += kPThreads) {
        const int e = i / L.mz, k = i - e * L.mz;
        const int s = s_s[e];
        float v = p.x[static_cast<size_t>(s >= 0 ? s : 0) * f +
                      (k < f ? k : 0)];
        if (s >= 0 && k >= f && k < f + a)
          v = p.ea[static_cast<size_t>(t + e) * a + k - f];
        zs[e * L.ldz + k] = s >= 0 && k < f + a ? v : 0.f;
      }
#pragma unroll 4
      for (int i = tid; i < kPE * wp; i += kPThreads) {
        const int e = i / wp, c = i - e * wp, dd = d0 + c;
        const int s = s_s[e];
        const bool ok = s >= 0 && dd < d;
        const int r = ok ? r_s[e] : 0, sn = ok ? s : 0, dc = ok ? dd : 0;
        const float* tr = p.table + static_cast<size_t>(r) * 4 * d;
        const float* tsn = p.table + static_cast<size_t>(sn) * 4 * d;
        float vf = tr[dc] + tsn[2 * d + dc] + bias[c];
        float vs = tr[d + dc] + tsn[3 * d + dc] + bias[wp + c];
        const float gc = p.gout[static_cast<size_t>(r) * d + dc];
        for (int q = 0; q < a; ++q) {
          const float g = ok ? p.ea[static_cast<size_t>(t + e) * a + q] : 0.f;
          vf += g * wfg[q * d + dc];
          vs += g * wsg[q * d + dc];
        }
        const float sf = sigmoid_f(vf);
        ds[e * L.ldd + c] = ok ? gc * softplus_f(vs) * (sf * (1.f - sf)) : 0.f;
        ds[e * L.ldd + wp + c] = ok ? gc * sf * softplus_grad(vs) : 0.f;
      }
      __syncthreads();
      // dWfs, dWss (and dWfg, dWsg) += [x[s] | ea]^T [dtf | dts]
      gemm_smem(ge, L.ldg, zs, 1, L.ldz, ds, L.ldd, 1, L.mz, nn, kPE, warp,
                kPWarps);
      // the row sums, in edge order: a row's run of edges in this tile is
      // summed in a register, then added to the row
      if (tid < nn) {
        int row = lr_s[0];
        float run = 0.f, runc = 0.f;
        for (int e = 0; e < cnt; ++e) {
          const float v = ds[e * L.ldd + tid];
          if (lr_s[e] != row) {
            rs[row * L.ldd + tid] += run + runc;
            row = lr_s[e];
            run = runc = 0.f;
          }
          add_comp(run, runc, v);
        }
        rs[row * L.ldd + tid] += run + runc;
      }
      if (want_ea) {
        // this slice's share of d ea = dtf . Wfg^T + dts . Wsg^T
        for (int i = tid; i < cnt * a; i += kPThreads) {
          const int e = i / a, q = i - e * a;
          float v = 0.f;
          for (int c = 0; c < wp && d0 + c < d; ++c)
            v += ds[e * L.ldd + c] * wfg[q * d + d0 + c] +
                 ds[e * L.ldd + wp + c] * wsg[q * d + d0 + c];
          p.dea[(static_cast<size_t>(j) * p.n_edges + t + e) * a + q] = v;
        }
      }
    }
    __syncthreads();
    // the biases' gradients: the chunk's row sums, in row order
    if (tid < nn) {
      for (int rr = 0; rr < r1 - r0; ++rr)
        add_comp(db, dbc, rs[rr * L.ldd + tid]);
    }
    // dWfr, dWsr += x[r]^T (the row sums): once per row
    gemm_smem(gr, L.ldg, xr, 1, L.ldx, rs, L.ldd, 1, L.mr, nn, kPR, warp,
              kPWarps);
    if (want_dx) {
      // dx[r] = (sum dtf) . Wfr^T + (sum dts) . Wsr^T: once per row
      gemm_smem(dxs, L.ldo, rs, L.ldd, 1, wr, 1, L.ldw, kPR, L.fp32, nn, warp,
                kPWarps);
      __syncthreads();
      for (int i = tid; i < (r1 - r0) * f; i += kPThreads) {
        const int rr = i / f, k = i - rr * f;
        p.dx[(static_cast<size_t>(j) * p.n_rows + r0 + rr) * f + k] =
            dxs[rr * L.ldo + k];
      }
    }
  }

  // the slice, once, into part p's partial in `wgrad`'s layout: per half
  // (dtf's columns, then dts's) rows of D [receiver (F) | sender (F) |
  // edge attributes (A) | bias]; ge holds the sender and edge-attribute
  // rows, gr (after ge's padded rows, same stride) the receiver rows
  __syncthreads();
  const int rows = 2 * f + a + 1;
  float* out = p.partial + static_cast<size_t>(blockIdx.x) * 2 * rows * d;
  for (int i = tid; i < (2 * f + a) * nn; i += kPThreads) {
    const int k = i / nn, c = i - k * nn, dd = d0 + c % wp;
    if (dd >= d) continue;
    const int src = k < f + a ? k : L.mz + k - f - a;
    const int row = k < f + a ? f + k : k - f - a;
    out[(static_cast<size_t>(c / wp) * rows + row) * d + dd] =
        ge[src * L.ldg + c];
  }
  if (tid < nn && d0 + tid % wp < d)
    out[(static_cast<size_t>(tid / wp) * rows + rows - 1) * d + d0 +
        tid % wp] = db + dbc;
}

template <int V>
int launch_fwd(const FwdArgs& p, cudaStream_t st) {
  cgcnn_fwd_kernel<V><<<(p.n_rows + kFWarps - 1) / kFWarps, kFThreads, 0,
                        st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_pass_s_sums(const PassSArgs& p, cudaStream_t st) {
  cgcnn_pass_s_sums_kernel<V><<<(p.n_rows + kFWarps - 1) / kFWarps,
                                kFThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

void node_table(const float* x, const float* const (&w)[8], float* table,
                int n_rows, int f, int d, cudaStream_t st) {
  cgcnn_node_table_kernel<<<dim3((n_rows + 63) / 64, (4 * d + 63) / 64), 128,
                            0, st>>>(x, w[0], w[4], w[1], w[5], table, n_rows,
                                     f, d);
}

bool widths_ok(int f, int d, int a, const void* ea) {
  return f >= 1 && f <= kMaxF && d >= 1 && d <= kMaxD && a >= 0 &&
         a <= kMaxA && (a == 0 || ea != nullptr);
}

}  // namespace

// The forward: the node table into `table` (scratch [N, 4D]), then out [N,
// D], rows the receivers (`row_ptr` the receiver-order CSR, positions are
// edge ids); two launches.  Returns the cudaError_t (0 = success).
// Pointers are device pointers; launches go on `stream` and do not
// synchronise.
extern "C" int hg_cgcnn_fwd_f32(
    const void* x, const void* ea, const void* send, const void* row_ptr,
    const void* wfr, const void* wfs, const void* wfg, const void* bf,
    const void* wsr, const void* wss, const void* wsg, const void* bs,
    void* table, void* out, int n_rows, int f, int d, int a, void* stream) {
  if (n_rows <= 0) return 0;
  if (!widths_ok(f, d, a, ea)) return static_cast<int>(cudaErrorInvalidValue);
  const void* ws[8] = {wfr, wfs, wfg, bf, wsr, wss, wsg, bs};
  const float* w[8];
  for (int i = 0; i < 8; ++i) w[i] = static_cast<const float*>(ws[i]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  node_table(static_cast<const float*>(x), w, static_cast<float*>(table),
             n_rows, f, d, st);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  FwdArgs p{};
  p.table = static_cast<const float*>(table);
  p.ea = static_cast<const float*>(ea);
  p.send = static_cast<const int*>(send);
  p.row_ptr = static_cast<const int*>(row_ptr);
  p.bf = w[3];
  p.bs = w[7];
  p.wfg = w[2];
  p.wsg = w[6];
  p.out = static_cast<float*>(out);
  p.n_rows = n_rows;
  p.d = d;
  p.a = a;
  if (d <= 32) return launch_fwd<1>(p, st);
  if (d <= 64) return launch_fwd<2>(p, st);
  if (d <= 128) return launch_fwd<4>(p, st);
  return launch_fwd<8>(p, st);
}

// Pass S: dx [N, F] of the sender side, rows the senders (`perm` the
// sender permutation, `row_ptr` the CSR over its positions), from
// `table` [N, 4D], the node table pass P wrote; `sums` [N, 2D] is scratch.
// Two launches; returns the cudaError_t.
extern "C" int hg_cgcnn_pass_s_f32(
    const void* ea, const void* recv, const void* perm, const void* row_ptr,
    const void* wfs, const void* wfg, const void* bf, const void* wss,
    const void* wsg, const void* bs, const void* gout, const void* table,
    void* sums, void* out, int n_rows, int f, int d, int a, void* stream) {
  if (n_rows <= 0) return 0;
  if (!widths_ok(f, d, a, ea) || perm == nullptr || gout == nullptr ||
      table == nullptr || sums == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PassSArgs q{};
  q.table = static_cast<const float*>(table);
  q.ea = static_cast<const float*>(ea);
  q.recv = static_cast<const int*>(recv);
  q.perm = static_cast<const int*>(perm);
  q.row_ptr = static_cast<const int*>(row_ptr);
  q.bf = static_cast<const float*>(bf);
  q.bs = static_cast<const float*>(bs);
  q.wfg = static_cast<const float*>(wfg);
  q.wsg = static_cast<const float*>(wsg);
  q.gout = static_cast<const float*>(gout);
  q.sums = static_cast<float*>(sums);
  q.n_rows = n_rows;
  q.d = d;
  q.a = a;
  const int err = d <= 32   ? launch_pass_s_sums<1>(q, st)
                  : d <= 64  ? launch_pass_s_sums<2>(q, st)
                  : d <= 128 ? launch_pass_s_sums<4>(q, st)
                             : launch_pass_s_sums<8>(q, st);
  if (err != 0) return err;
  cgcnn_row_product_kernel<<<dim3((n_rows + 63) / 64, (f + 63) / 64), 128, 0,
                             st>>>(
      static_cast<const float*>(sums), static_cast<const float*>(wfs),
      static_cast<const float*>(wss), static_cast<float*>(out), n_rows, f, d);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of one pass-P block's shared memory at slice width `wp`.
extern "C" int hg_cgcnn_pass_p_smem(int f, int a, int wp) {
  return static_cast<int>(sizeof(float)) * pass_p_layout(f, a, wp).floats;
}

// The pass-P slice width: the widest multiple of 16 output columns (all of
// D where it fits) whose block fits the current device's shared memory;
// -1 when none does or the device cannot be asked.
extern "C" int hg_cgcnn_pass_p_width(int f, int d, int a) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  for (int wp = (d + 15) / 16 * 16; wp >= 16; wp -= 16)
    if (hg_cgcnn_pass_p_smem(f, a, wp) <= optin) return wp;
  return -1;
}

// Pass P (receiver order) and its reductions; returns the cudaError_t.
// `table` [N, 4D] receives the node table (pass S's route 1 reads it in the
// same backward); `partial` scratch [n_parts, P] for the
// parts' sums of `wgrad` [dWfr | dWfs | dWfg | dbf | dWsr | dWss | dWsg |
// dbs] (P = 2 (2F + A + 1) D entries); `wp` the slice width
// (hg_cgcnn_pass_p_width).  `dx` [N, F] and `dea` [E, A] (zero-filled) may be
// null; with more than one slice `dx_part` [n_slices, N, F] and `dea_part`
// [n_slices, E, A] are their scratch (with one slice, the outputs
// themselves).
extern "C" int hg_cgcnn_pass_p_f32(
    const void* x, const void* ea, const void* send, const void* recv,
    const void* row_ptr, const void* wfr, const void* wfs, const void* wfg,
    const void* bf, const void* wsr, const void* wss, const void* wsg,
    const void* bs, const void* gout, void* table,
    void* partial, void* wgrad, void* dx_part, void* dea_part, void* dx,
    void* dea, int n_rows, int n_edges, int f, int d, int a, int wp,
    int n_parts, void* stream) {
  if (n_rows <= 0) return 0;
  if (!widths_ok(f, d, a, ea) || n_parts < 1 || wp < 16 || wp % 16 != 0 ||
      2 * wp > kPThreads || (dx == nullptr) != (dx_part == nullptr) ||
      (dea == nullptr) != (dea_part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      sizeof(float) * static_cast<size_t>(pass_p_layout(f, a, wp).floats);
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PassPArgs p{};
  p.x = static_cast<const float*>(x);
  p.ea = static_cast<const float*>(ea);
  p.send = static_cast<const int*>(send);
  p.recv = static_cast<const int*>(recv);
  p.row_ptr = static_cast<const int*>(row_ptr);
  p.table = static_cast<const float*>(table);
  const void* ws[8] = {wfr, wfs, wfg, bf, wsr, wss, wsg, bs};
  for (int i = 0; i < 8; ++i) p.w[i] = static_cast<const float*>(ws[i]);
  p.gout = static_cast<const float*>(gout);
  p.partial = static_cast<float*>(partial);
  p.dx = static_cast<float*>(dx_part);
  p.dea = static_cast<float*>(dea_part);
  p.n_rows = n_rows;
  p.n_edges = n_edges;
  p.f = f;
  p.d = d;
  p.a = a;
  p.wp = wp;
  node_table(p.x, p.w, static_cast<float*>(table), n_rows, f, d, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(cgcnn_pass_p_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_slices = (d + wp - 1) / wp;
  cgcnn_pass_p_kernel<<<dim3(n_parts, n_slices), kPThreads, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = passp::launch_reduce_partials(p.partial, static_cast<float*>(wgrad),
                                      n_parts, 2 * (2 * f + a + 1) * d, st);
  if (err != cudaSuccess || n_slices == 1) return static_cast<int>(err);
  if (dx != nullptr)
    err = passp::launch_reduce_slices(p.dx, dx, nullptr, n_rows, f, n_slices,
                                      static_cast<size_t>(n_rows) * f, st);
  if (err == cudaSuccess && dea != nullptr)
    err = passp::launch_reduce_slices(p.dea, dea, p.row_ptr, n_rows, a,
                                      n_slices,
                                      static_cast<size_t>(n_edges) * a, st);
  return static_cast<int>(err);
}
