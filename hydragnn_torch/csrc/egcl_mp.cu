// Hand-written Hopper (sm_90a) kernels for EGNN's fused EGCL interaction
// block
//
//   t0 = x[s].W0s + x[r].W0r + [radial, edge_attr].W0g + b0
//   m  = relu(relu(t0).W1 + b1)                        -> agg[s]  += m
//   c  = tanh(relu(m.Wc0 + bc0).wc1)   (equivariant)   -> psum[s] += clip(diff*c, +-100)
//
// Plain C interface, loaded with ctypes by hydragnn_torch/kernels/build.py;
// wrappers, plain PyTorch versions and launch counters live in
// hydragnn_torch/ops/egcl_mp.py.  Float32 throughout; every weight is
// [in, out] row-major (W0s [F,H], W0r [F,H], W0g [1+A,H], W1 and Wc0 [H,H],
// wc1 [H]).  geo is [E, 3 + gp]: diff_normed (3 lanes), then radial and the
// edge attributes (gp = 1 + A lanes).
//
// One kernel template, three modes:
//
// The forward.  Replaces hydragnn_tpu/ops/fused_block.py:_fused_fwd with
//   the egcl spec (pl.pallas_call at :495).  Sender order: positions of a
//   sender CSR, mapped to edge ids through edge_perm_sender; the chain is
//   recomputed per edge tile and m (and the three translation lanes) added
//   into the sender rows in edge order.  No [E,H] tensor reaches device
//   memory, no atomics.  Two routes, chosen by width (hg_egcl_fwd_route):
// tc::fwd_tc_kernel — route 1: pass P's route-1 widths (F, H <= 48, gp <=
//   15: md17's and oc22's layers), pass S's route 1 with the forward's
//   roles.  Each of a block's 12 warps (one block per SM) owns one share of
//   the sender rows (passp::share_range over all the warps) and walks its
//   positions in 16-edge tiles: it gathers the tile's x[s], x[r] and
//   geometry rows with cp.async (zero-filled off real edges) and runs the
//   front of the chain on the tensor cores in 3xTF32 (each k step's large
//   product summed apart from the two small ones: mma3_apart), each
//   product's accumulators the next one's A fragments: t0, a, m and, when
//   equivariant, v and c.  m goes to a slot of the warp's region, the
//   three translation lanes clip(diff * c) beside it (columns Hp .. Hp +
//   2), and each lane adds two columns of the tile's rows into their sender
//   rows in position order, a row's sum carried from one tile into the
//   next; every row of the share written once.  No block barrier after
//   the weights are staged.
// egcl_kernel<kFwd> — route 2, every other width up to the limits: the
//   first design below (each block owns kRows sender rows and walks their
//   positions TE edges at a time on the CUDA cores).
// Backward pass P (+ egcl_reduce_partials_kernel).  Replaces :_fused_bwd
//   pass P (pl.pallas_call at :561).  Sender order again: recompute the
//   chain, take the cotangents dagg[s], dpsum[s], backpropagate through
//   the coordinate gate (tanh, relu, the clip, whose mask is 1 because
//   |diff_normed| < 1) and the two-layer edge MLP, and write dx_sender
//   (summed per row), the per-edge dgeo stream and the weight gradients.
//   The weight gradients are sums over all edges: each of n_parts blocks
//   (one per SM) keeps its own float32 partial over a share of the rows
//   and writes it once; the reduce kernel sums the partials in block
//   order.  Two routes, chosen by width (hg_egcl_pass_p_route):
// tc::pass_p_tc_kernel — route 1: F, H <= 48 (padded to 16) and gp <= 15,
//   every instantiation of md17's and oc22's paths.  Block b owns one
//   share of the sender rows (passp::share_range: rows plus edges balanced)
//   and walks its positions 128 at a time, one 16-edge tile (an m16
//   fragment) per warp.  Each warp gathers its tile's x[s], x[r] and
//   geometry rows with cp.async (zero-filled off real edges) and runs the
//   chain on the tensor cores in 3xTF32 (csrc/pass_p.cuh), accumulators
//   in registers from one product to the next: t0 = [x[s] | x[r] | G'] .
//   [W0s; W0r; W0g; b0] (G' = the geometry lanes and a ones column, so b0
//   and its gradient ride along), m, v and, back, dm = dagg[s] + du0 .
//   Wc0^T, dt0 = (du . W1^T) (a > 0), dx = dt0 . W0s^T; the k index of
//   each product is permuted within its 8-wide step, so an accumulator is
//   the next product's A fragment as it stands.  c, dcp, du0, dwc1 and
//   dgeo's lanes are elementwise or four-lane sums.  The weight gradients
//   are edge-contracted products A^T . D over the block's eight tiles,
//   in three phases (m^T du0 and G'^T du0; a^T du and G'^T du; x[s]^T dt0,
//   x[r]^T dt0 and G'^T dt0, whose ones row is db0): every (product,
//   16-row tile, half of the columns) is one job, warp w takes jobs w,
//   w + 8, ... and keeps their accumulators in registers over the whole
//   share (at most 4 jobs, 48 floats a lane at H = 48); dwc1 is summed
//   per tile (shuffles) into each warp's sums in shared memory.  Six
//   block barriers a step of 128 edges.  dx: each warp sums its tile's
//   per-edge dx rows into their sender rows in position order and writes
//   the rows that begin and end in the tile; the sums of its first and
//   last rows, which may straddle tiles, are added in tile order by the
//   last warp while the last phase runs.  Weights stay in shared memory with row
//   stride H + 4 (16 floats at most past H), the tiles with a stride of 8
//   or 24 mod 32, so fragment loads along rows and down columns hit 32
//   banks (the transposed weight loads of dm, dt0 and dx meet two-way
//   conflicts on a few lanes).
// egcl_kernel<kPassP> — route 2, every other width up to the limits: the
//   first design below (each block keeps its partial in shared memory
//   beside the staged weights, or in device memory at H = 128).
// Backward pass S.  Replaces :_fused_bwd pass S (pl.pallas_call at :599).
//   Receiver order (edge ids are positions): recompute the chain and its
//   backward up to dt0 with the cotangents gathered at the sender, and sum
//   dx_receiver = dt0 . W0r^T per row.  Two routes, chosen by width
//   (hg_egcl_pass_s_route):
// tc::pass_s_tc_kernel — route 1: pass P's route-1 widths (F, H <= 48,
//   gp <= 15: md17's and oc22's layers), pass P's machinery with pass S's
//   roles.  Each of a block's 12 warps (one block per SM) owns one share
//   of the receiver rows (passp::share_range over all the warps: rows
//   plus edges balanced) and walks its positions in 16-edge tiles: it
//   gathers the tile's x[s], x[r], geometry rows and the cotangents
//   dagg[s], dpsum[s] with cp.async (zero-filled off real edges) and runs
//   the chain on the tensor cores in 3xTF32, each product's accumulators
//   the next one's A fragments: t0, a (kept as its signs), m, and when
//   equivariant v, c, dcp and du0; dm = dagg[s] + du0 . Wc0^T, du, dt0 and
//   dx = dt0 . W0r^T.  The per-edge dx rows are summed into their receiver
//   rows in position order, a row's sum carried from one tile into the
//   next (the rows of a share never leave its warp), and every row of the
//   share is written once.  No weight-gradient jobs and no dgeo, so no
//   block barrier after the weights are staged.  What held the first
//   design back: CUDA cores, five block barriers a 32-edge tile, and the
//   row sums added by one thread per column.
// egcl_kernel<kPassS> — route 2, every other width up to the limits: the
//   first design below.
//
// Bound on the H100 SXM: operations.  At md17's widths (F = H = 48) the
// forward does ~19 kFLOP per real edge against ~0.4 KB of edge and node
// bytes, far above the card's ~20 flop/byte float32 ridge; pass P does
// about three times the forward's work, pass S about twice.  Design
// against it, first version: no [E,*] intermediate reaches device memory;
// the weights are staged once per block in shared memory with an odd row
// stride (H | 1), so that both a forward product (threads along a row) and
// a backward product (threads down a column) read without bank conflicts;
// per-edge tiles live transposed in shared memory ([k][e], row stride
// TE+4) so that one 16-byte broadcast load feeds four multiply-adds; each
// thread computes EQ edges of one output column.  Where the weights (and,
// for pass P, the partials) do not fit a block's shared memory (H = 128),
// they are read from L2 and the partial lives in device memory; that path
// is correct and slow.  The routes 2 of the three kernels run on the CUDA
// cores; their routes 1 on the tensor cores (above).
//
// Contract (collate guarantees it): positions are sorted by output row, so
// each row owns one contiguous CSR range; masked edges sort last in both
// orderings and are parked out of every range by the wrapper, so they are
// never read and every grad on them is exactly zero (the wrapper
// zero-fills dgeo).  Gather ids outside [0, n_rows) contribute nothing.
// Determinism: every sum runs in a fixed order (edge order within a row;
// tile, chunk, then block order for the weight gradients); no atomics.
// Every output row is written, rows without edges as zeros.

#include <cuda_runtime.h>

#include "pass_p.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int TE = 32;           // edges per tile
constexpr int EQ = 8;            // edges per work item
constexpr int kGroups = TE / EQ;
constexpr int LDT = TE + 4;      // row stride of a transposed tile
constexpr int kRows = 16;        // output rows per chunk
constexpr int kMaxF = 128;
constexpr int kMaxH = 128;
constexpr int kMaxGp = 124;      // geo payload <= 127 lanes: 3 diff + gp

constexpr int kFwd = 0;
constexpr int kPassP = 1;
constexpr int kPassS = 2;

struct Params {
  const float* x;        // [N, F]
  const float* geo;      // [E, 3 + gp]
  const int* send;       // [E]
  const int* recv;       // [E]
  const int* perm;       // [E] position -> edge id, or null (identity)
  const int* row_ptr;    // [N + 1] CSR over positions
  const float* w[9];     // w0s, w0r, w0g, b0, w1, b1, wc0, bc0, wc1
  const float* gagg;     // [N, H] cotangent of agg (backward)
  const float* gpsum;    // [N, 3] cotangent of psum (backward, equivariant)
  float* out;            // fwd: agg [N, H]; pass P / S: dx [N, F] or null
  float* psum;           // fwd, equivariant: [N, 3]
  float* partial;        // pass P: [gridDim.x, wsize(ld = H)]
  float* dgeo;           // pass P: [E, 3 + gp] (zero-filled) or null
  int n_rows, f, h, gp, n_chunks;
  int stage;             // 1: weights (and partials) in shared memory
};

// offsets of the nine weight blocks in a packed layout with row stride ld;
// returns the total, rounded up to keep the next region 16-byte aligned
__host__ __device__ inline int weight_layout(int f, int h, int gp, int ld,
                                             bool equiv, int* off) {
  int o = 0;
  off[0] = o; o += f * ld;    // w0s
  off[1] = o; o += f * ld;    // w0r
  off[2] = o; o += gp * ld;   // w0g
  off[3] = o; o += h;         // b0
  off[4] = o; o += h * ld;    // w1
  off[5] = o; o += h;         // b1
  off[6] = o; if (equiv) o += h * ld;  // wc0
  off[7] = o; if (equiv) o += h;       // bc0
  off[8] = o; if (equiv) o += h;       // wc1
  return (o + 3) & ~3;
}

// rows of each weight block (its columns are H; b0, b1, bc0, wc1 are one row)
__host__ __device__ inline int weight_rows(int i, int f, int h, int gp) {
  switch (i) {
    case 0: case 1: return f;
    case 2: return gp;
    case 4: case 6: return h;
    default: return 1;
  }
}

__host__ __device__ inline int tile_floats(int mode, bool equiv, int f, int h,
                                           int gp) {
  int n = (2 * f + gp) * LDT + 2 * h * LDT;          // xs, xr, g, a, m
  if (equiv) n += h * LDT * (mode == kFwd ? 1 : 2);  // v (+ du0)
  if (mode != kFwd) n += 2 * h * LDT;                // du, dt0
  n += kRows * (mode == kFwd ? h : f) + kRows * 4;   // row sums, psum rows
  n += TE * 2 + 4 * TE + 4 * TE;                     // c, dcp, diff, ids
  return n;
}

// acc[j] += sum_k T[k][e0 + j] * w[k * stride] over k < K: T is a transposed
// [K][LDT] shared tile; w walks a weight column (stride = row stride) or a
// weight row (stride = 1)
__device__ __forceinline__ void mv(float (&acc)[EQ], const float* T, int K,
                                   const float* w, int stride, int e0) {
  for (int k = 0; k < K; ++k) {
    const float wk = w[k * stride];
    const float4 lo = *reinterpret_cast<const float4*>(T + k * LDT + e0);
    const float4 hi = *reinterpret_cast<const float4*>(T + k * LDT + e0 + 4);
    acc[0] += lo.x * wk;
    acc[1] += lo.y * wk;
    acc[2] += lo.z * wk;
    acc[3] += lo.w * wk;
    acc[4] += hi.x * wk;
    acc[5] += hi.y * wk;
    acc[6] += hi.z * wk;
    acc[7] += hi.w * wk;
  }
}

__device__ __forceinline__ void store8(float* dst, const float (&v)[EQ]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// sum_e A[e] * B[e] over the TE edges of two transposed tile rows
__device__ __forceinline__ float row_dot(const float* a, const float* b) {
  float v = 0.f;
#pragma unroll
  for (int q = 0; q < TE / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(a)[q];
    const float4 y = reinterpret_cast<const float4*>(b)[q];
    v += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
  }
  return v;
}

__device__ __forceinline__ float row_sum(const float* a) {
  float v = 0.f;
#pragma unroll
  for (int q = 0; q < TE / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(a)[q];
    v += x.x + x.y + x.z + x.w;
  }
  return v;
}

// G[k*ld + c] += sum_e A[k][e] * D[c][e] for k < K, c < h (a weight grad)
__device__ __forceinline__ void outer_acc(float* G, int ld, const float* A,
                                          int K, const float* D, int h) {
  for (int it = threadIdx.x; it < K * h; it += kThreads) {
    const int k = it / h, c = it - k * h;
    G[k * ld + c] += row_dot(A + k * LDT, D + c * LDT);
  }
}

// out tile [K][LDT] = act(bias + sum of products) for K output columns
// (forward products: thread per column c, EQ edges each)
template <bool RELU>
__device__ __forceinline__ void dense_tile(float* out, int K, const float* T0,
                                           int K0, const float* W0,
                                           const float* T1, int K1,
                                           const float* W1, const float* T2,
                                           int K2, const float* W2,
                                           const float* bias, int ld) {
  for (int it = threadIdx.x; it < K * kGroups; it += kThreads) {
    const int c = it % K, e0 = (it / K) * EQ;
    float acc[EQ];
    const float b = bias != nullptr ? bias[c] : 0.f;
#pragma unroll
    for (int j = 0; j < EQ; ++j) acc[j] = b;
    mv(acc, T0, K0, W0 + c, ld, e0);
    if (T1 != nullptr) mv(acc, T1, K1, W1 + c, ld, e0);
    if (T2 != nullptr) mv(acc, T2, K2, W2 + c, ld, e0);
    if (RELU) {
#pragma unroll
      for (int j = 0; j < EQ; ++j) acc[j] = fmaxf(acc[j], 0.f);
    }
    store8(out + c * LDT + e0, acc);
  }
}

template <int MODE, bool EQUIV>
__global__ void __launch_bounds__(kThreads) egcl_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int f = p.f, h = p.h, gp = p.gp, geo_ld = 3 + p.gp;
  const int n_rows = p.n_rows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float* xs_t = sm; sm += f * LDT;     // x[s]; pass P: then dx per edge
  float* xr_t = sm; sm += f * LDT;     // x[r]; pass S: then dx per edge
  float* g_t = sm; sm += gp * LDT;     // radial, edge_attr
  float* a_t = sm; sm += h * LDT;      // relu(t0)
  float* m_t = sm; sm += h * LDT;      // m
  float* v_t = nullptr;                // relu(m.Wc0 + bc0)
  float* du0_t = nullptr;
  float* du_t = nullptr;
  float* dt0_t = nullptr;
  if (EQUIV) {
    v_t = sm; sm += h * LDT;
    if (MODE != kFwd) { du0_t = sm; sm += h * LDT; }
  }
  if (MODE != kFwd) {
    du_t = sm; sm += h * LDT;
    dt0_t = sm; sm += h * LDT;
  }
  const int ow = MODE == kFwd ? h : f;  // width of the row sums
  float* rows_s = sm; sm += kRows * ow;
  float* psum_s = sm; sm += kRows * 4;
  float* c_s = sm; sm += TE;
  float* dcp_s = sm; sm += TE;
  float* diff_s = sm; sm += 4 * TE;     // [3][TE]
  int* eid_s = reinterpret_cast<int*>(sm);
  int* s_s = eid_s + TE;
  int* r_s = s_s + TE;
  int* row_s = r_s + TE;
  sm += 4 * TE;

  // weights: staged in shared memory with row stride h | 1, or read from
  // global memory (row stride h) when they do not fit
  int off[9];
  const float* w[9];
  int ld = h;
  if (p.stage) {
    ld = h | 1;
    weight_layout(f, h, gp, ld, EQUIV, off);
    for (int i = 0; i < 9; ++i) {
      if (!EQUIV && i >= 6) { w[i] = nullptr; continue; }
      const int rows = weight_rows(i, f, h, gp);
      float* dst = sm + off[i];
      const int rld = rows == 1 ? h : ld;
      for (int j = tid; j < rows * h; j += kThreads) {
        const int k = j / h, c = j - k * h;
        dst[k * rld + c] = p.w[i][j];
      }
      w[i] = dst;
    }
    sm += weight_layout(f, h, gp, ld, EQUIV, off);
  } else {
    for (int i = 0; i < 9; ++i) w[i] = p.w[i];
  }
  const float *w0s = w[0], *w0r = w[1], *w0g = w[2], *b0 = w[3], *w1 = w[4],
              *b1 = w[5], *wc0 = w[6], *bc0 = w[7], *wc1 = w[8];

  // pass P: this block's weight-gradient partial (same layout as the
  // weights), zeroed here, written once at the end
  float* gw[9] = {nullptr};
  if (MODE == kPassP) {
    float* base;
    int goff[9];
    int gsize;
    if (p.stage) {
      base = sm;
      gsize = weight_layout(f, h, gp, ld, EQUIV, goff);
    } else {
      gsize = weight_layout(f, h, gp, h, EQUIV, goff);
      base = p.partial + static_cast<size_t>(gsize) * blockIdx.x;
    }
    for (int j = tid; j < gsize; j += kThreads) base[j] = 0.f;
    for (int i = 0; i < 9; ++i) gw[i] = base + goff[i];
  }

  for (int chunk = blockIdx.x; chunk < p.n_chunks; chunk += gridDim.x) {
    const int r0 = chunk * kRows;
    const int r1 = min(r0 + kRows, n_rows);
    const int e_begin = p.row_ptr[r0];
    const int e_end = p.row_ptr[r1];
    __syncthreads();  // staging done; the previous chunk's rows written out
    for (int i = tid; i < kRows * ow; i += kThreads) rows_s[i] = 0.f;
    if (MODE == kFwd && EQUIV && tid < kRows * 4) psum_s[tid] = 0.f;

    for (int t = e_begin; t < e_end; t += TE) {
      const int cnt = min(TE, e_end - t);
      __syncthreads();  // rows zeroed; the previous tile's readers are done
      if (tid < TE) {
        int eid = -1, s = -1, r = -1, row = 0;
        if (tid < cnt) {
          const int pos = t + tid;
          eid = p.perm != nullptr ? p.perm[pos] : pos;
          s = p.send[eid];
          r = p.recv[eid];
          if (static_cast<unsigned>(s) >= static_cast<unsigned>(n_rows) ||
              static_cast<unsigned>(r) >= static_cast<unsigned>(n_rows)) {
            s = -1;
            r = -1;
          } else {
            row = (MODE == kPassS ? r : s) - r0;
          }
        }
        eid_s[tid] = eid;
        s_s[tid] = s;
        r_s[tid] = r;
        row_s[tid] = row;
      }
      __syncthreads();
      // gather x[s], x[r] and the geometry lanes, transposed; invalid and
      // out-of-tile edges read zeros
      for (int i = tid; i < TE * f; i += kThreads) {
        const int e = i / f, k = i - e * f;
        const int s = s_s[e], r = r_s[e];
        xs_t[k * LDT + e] = s >= 0 ? p.x[static_cast<size_t>(s) * f + k] : 0.f;
        xr_t[k * LDT + e] = r >= 0 ? p.x[static_cast<size_t>(r) * f + k] : 0.f;
      }
      for (int i = tid; i < TE * geo_ld; i += kThreads) {
        const int e = i / geo_ld, k = i - e * geo_ld;
        const float v = s_s[e] >= 0
            ? p.geo[static_cast<size_t>(eid_s[e]) * geo_ld + k] : 0.f;
        if (k < 3)
          diff_s[k * TE + e] = v;
        else
          g_t[(k - 3) * LDT + e] = v;
      }
      __syncthreads();
      // a = relu(x[s].W0s + x[r].W0r + g.W0g + b0)
      dense_tile<true>(a_t, h, xs_t, f, w0s, xr_t, f, w0r, g_t, gp, w0g, b0,
                       ld);
      __syncthreads();
      // m = relu(a.W1 + b1)
      dense_tile<true>(m_t, h, a_t, h, w1, nullptr, 0, nullptr, nullptr, 0,
                       nullptr, b1, ld);
      __syncthreads();
      if (EQUIV) {
        // v = relu(m.Wc0 + bc0); c = tanh(v.wc1), one warp per edge
        dense_tile<true>(v_t, h, m_t, h, wc0, nullptr, 0, nullptr, nullptr,
                         0, nullptr, bc0, ld);
        __syncthreads();
        for (int e = warp; e < TE; e += kWarps) {
          float v = 0.f;
          for (int k = lane; k < h; k += 32) v += v_t[k * LDT + e] * wc1[k];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
          if (lane == 0) c_s[e] = tanhf(v);
        }
        __syncthreads();
      }

      if (MODE == kFwd) {
        // rows += m and psum rows += clip(diff * c), in edge order
        for (int c = tid; c < h; c += kThreads) {
          for (int e = 0; e < cnt; ++e)
            if (s_s[e] >= 0) rows_s[row_s[e] * h + c] += m_t[c * LDT + e];
        }
        if (EQUIV && tid >= kThreads - 3) {
          const int j = tid - (kThreads - 3);
          for (int e = 0; e < cnt; ++e) {
            if (s_s[e] < 0) continue;
            const float tr = fminf(fmaxf(diff_s[j * TE + e] * c_s[e], -100.f),
                                   100.f);
            psum_s[row_s[e] * 4 + j] += tr;
          }
        }
        continue;
      }

      // ---- backward: the cotangents are gathered at the sender ----
      if (EQUIV) {
        // d(clip(diff * c)) -> dc, ddiff; dcp = dc * (1 - c^2)
        if (tid < TE) {
          const int e = tid, s = s_s[e];
          const bool valid = e < cnt && s >= 0;
          const float c = c_s[e];
          float dc = 0.f;
          for (int j = 0; j < 3; ++j) {
            const float dtr = valid ? p.gpsum[static_cast<size_t>(s) * 3 + j]
                                    : 0.f;
            const float d = diff_s[j * TE + e];
            const float tr = d * c;
            const bool pass = tr >= -100.f && tr <= 100.f;
            dc += pass ? dtr * d : 0.f;
            if (MODE == kPassP && p.dgeo != nullptr && valid)
              p.dgeo[static_cast<size_t>(eid_s[e]) * geo_ld + j] =
                  pass ? dtr * c : 0.f;
          }
          dcp_s[e] = dc * (1.f - c * c);
        }
        __syncthreads();
        // du0 = wc1 * dcp * (v > 0); pass P: dwc1 += v^T dcp
        for (int it = tid; it < h * kGroups; it += kThreads) {
          const int k = it % h, e0 = (it / h) * EQ;
          float d[EQ];
          const float wk = wc1[k];
#pragma unroll
          for (int j = 0; j < EQ; ++j) {
            const float vv = v_t[k * LDT + e0 + j];
            d[j] = vv > 0.f ? wk * dcp_s[e0 + j] : 0.f;
          }
          store8(du0_t + k * LDT + e0, d);
        }
        if (MODE == kPassP) {
          for (int k = tid; k < h; k += kThreads)
            gw[8][k] += row_dot(v_t + k * LDT, dcp_s);
        }
        __syncthreads();
        if (MODE == kPassP) {
          // dWc0 += m^T du0; dbc0 += sum du0
          outer_acc(gw[6], ld, m_t, h, du0_t, h);
          for (int c = tid; c < h; c += kThreads)
            gw[7][c] += row_sum(du0_t + c * LDT);
        }
      }
      // dm = dagg[s] (+ du0 . Wc0^T); du = dm * (m > 0)
      for (int it = tid; it < h * kGroups; it += kThreads) {
        const int c = it % h, e0 = (it / h) * EQ;
        float acc[EQ];
#pragma unroll
        for (int j = 0; j < EQ; ++j) {
          const int e = e0 + j, s = s_s[e];
          acc[j] = (e < cnt && s >= 0)
              ? p.gagg[static_cast<size_t>(s) * h + c] : 0.f;
        }
        if (EQUIV) mv(acc, du0_t, h, wc0 + c * ld, 1, e0);
#pragma unroll
        for (int j = 0; j < EQ; ++j)
          if (!(m_t[c * LDT + e0 + j] > 0.f)) acc[j] = 0.f;
        store8(du_t + c * LDT + e0, acc);
      }
      __syncthreads();
      // da = du . W1^T; dt0 = da * (a > 0)
      for (int it = tid; it < h * kGroups; it += kThreads) {
        const int k = it % h, e0 = (it / h) * EQ;
        float acc[EQ];
#pragma unroll
        for (int j = 0; j < EQ; ++j) acc[j] = 0.f;
        mv(acc, du_t, h, w1 + k * ld, 1, e0);
#pragma unroll
        for (int j = 0; j < EQ; ++j)
          if (!(a_t[k * LDT + e0 + j] > 0.f)) acc[j] = 0.f;
        store8(dt0_t + k * LDT + e0, acc);
      }
      if (MODE == kPassP) {
        // dW1 += a^T du; db1 += sum du
        outer_acc(gw[4], ld, a_t, h, du_t, h);
        for (int c = tid; c < h; c += kThreads)
          gw[5][c] += row_sum(du_t + c * LDT);
      }
      __syncthreads();
      if (MODE == kPassP) {
        // dW0s, dW0r, dW0g, db0; the radial and edge_attr lanes of dgeo
        outer_acc(gw[0], ld, xs_t, f, dt0_t, h);
        outer_acc(gw[1], ld, xr_t, f, dt0_t, h);
        outer_acc(gw[2], ld, g_t, gp, dt0_t, h);
        for (int c = tid; c < h; c += kThreads)
          gw[3][c] += row_sum(dt0_t + c * LDT);
        if (p.dgeo != nullptr) {
          for (int it = tid; it < gp * TE; it += kThreads) {
            const int e = it / gp, k = it - e * gp;
            if (e >= cnt || s_s[e] < 0) continue;
            float v = 0.f;
            for (int c = 0; c < h; ++c)
              v += dt0_t[c * LDT + e] * w0g[k * ld + c];
            p.dgeo[static_cast<size_t>(eid_s[e]) * geo_ld + 3 + k] = v;
          }
        }
        __syncthreads();  // xs_t is overwritten next
      }
      if (p.out == nullptr) continue;
      // dx per edge = dt0 . W0own^T into the own side's x tile, then
      // summed per row in edge order
      float* dx_t = MODE == kPassP ? xs_t : xr_t;
      const float* w_own = MODE == kPassP ? w0s : w0r;
      for (int it = tid; it < f * kGroups; it += kThreads) {
        const int k = it % f, e0 = (it / f) * EQ;
        float acc[EQ];
#pragma unroll
        for (int j = 0; j < EQ; ++j) acc[j] = 0.f;
        mv(acc, dt0_t, h, w_own + k * ld, 1, e0);
        store8(dx_t + k * LDT + e0, acc);
      }
      __syncthreads();
      for (int k = tid; k < f; k += kThreads) {
        for (int e = 0; e < cnt; ++e)
          if (s_s[e] >= 0) rows_s[row_s[e] * f + k] += dx_t[k * LDT + e];
      }
    }
    __syncthreads();
    if (p.out != nullptr) {
      for (int i = tid; i < (r1 - r0) * ow; i += kThreads)
        p.out[static_cast<size_t>(r0) * ow + i] = rows_s[i];
    }
    if (MODE == kFwd && EQUIV) {
      for (int i = tid; i < (r1 - r0) * 3; i += kThreads)
        p.psum[static_cast<size_t>(r0) * 3 + i] = psum_s[(i / 3) * 4 + i % 3];
    }
  }

  if (MODE == kPassP && p.stage) {
    // the shared partial, written once in the unpadded layout (row stride h)
    __syncthreads();
    int goff[9];
    const int gsize = weight_layout(f, h, gp, h, EQUIV, goff);
    float* dst = p.partial + static_cast<size_t>(gsize) * blockIdx.x;
    // the alignment pad at the end stays unwritten: nothing reads it
    for (int i = 0; i < 9; ++i) {
      if (!EQUIV && i >= 6) continue;
      const int rows = weight_rows(i, f, h, gp);
      const int rld = rows == 1 ? h : ld;
      for (int j = tid; j < rows * h; j += kThreads) {
        const int k = j / h, c = j - k * h;
        dst[goff[i] + j] = gw[i][k * rld + c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// pass P, route 1: warps on 16-edge tiles, tensor cores in 3xTF32, weight
// gradients in registers
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int M = 16;                 // edges per warp tile: one m16 fragment
constexpr int kStep = kWarps * M;     // positions per block step
constexpr int kMaxW = 48;             // F and H, padded to 16, up to this
constexpr int kGW = 16;               // G' columns: gp lanes, ones, zeros
constexpr int kLdG = 24;              // G' row stride
constexpr int kLdRaw = 20;            // raw geo rows (3 + gp <= 18 lanes)
constexpr int kMaxJobs = 4;           // weight-gradient jobs a warp
constexpr int kSlots = 5;             // XS, XR, A, M, D0
constexpr unsigned kFull = 0xffffffffu;

// slots of a warp's region: the gathered x[s], x[r]; a (then dt0); m
// (then du); du0 (then the per-edge dx)
constexpr int XS = 0, XR = 1, SA = 2, SM = 3, SD = 4;

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

struct Layout {
  int fp, hp, ld, ldw;          // padded widths, slot and weight strides
  int wst, w1, wc0, b1, bc0, wc1;  // weight offsets (floats)
  int warps;                    // per-warp regions' offset
  int per_warp;                 // floats a warp region
  int total;                    // floats in all
};

// the shared layout: the weights (W0s; W0r; W0g then b0 as one stacked
// [2 Fp + 16, Hp] matrix; W1; Wc0; b1, bc0, wc1), then per warp its five
// slots [16][ld], its G' [16][kLdG], raw geo rows [16][kLdRaw], 32 ids,
// its dwc1 sums [48], and the dx sums of its tile's first and last sender
// rows [2][48] with their rows
__host__ __device__ inline Layout layout(int f, int h, bool equiv) {
  Layout L;
  L.fp = round16(f);
  L.hp = round16(h);
  L.ld = passp::frag_ld(L.fp > L.hp ? L.fp : L.hp);
  L.ldw = L.hp + 4;
  int o = 0;
  L.wst = o; o += (2 * L.fp + kGW) * L.ldw;
  L.w1 = o; o += L.hp * L.ldw;
  L.wc0 = o; if (equiv) o += L.hp * L.ldw;
  L.b1 = o; o += L.hp;
  L.bc0 = o; o += L.hp;
  L.wc1 = o; o += L.hp;
  L.warps = o;
  L.per_warp =
      kSlots * M * L.ld + M * kLdG + M * kLdRaw + 2 * M + 3 * kMaxW + 4;
  L.total = o + kWarps * L.per_warp;   // then the block's two row bounds
  return L;
}

// the weight-gradient products of a block step, in phases: each pairs an
// A operand (its rows: F, H or G' columns) with a D operand (H columns),
// contracted over the step's edges.  The jobs are (pair, m-tile, half of
// the n-tiles) in this order; warp w takes jobs w, w + 8, w + 16, ...
constexpr int kPairs = 7;
// pair: phase, A slot (-1: G'), D slot
__host__ __device__ inline void pair_info(int i, int& phase, int& a, int& dd) {
  switch (i) {
    case 0: phase = 0; a = SM; dd = SD; break;   // dWc0 = m^T du0
    case 1: phase = 0; a = -1; dd = SD; break;   // dbc0 (G' ones row)
    case 2: phase = 1; a = SA; dd = SM; break;   // dW1 = a^T du
    case 3: phase = 1; a = -1; dd = SM; break;   // db1
    case 4: phase = 2; a = XS; dd = SA; break;   // dW0s = x[s]^T dt0
    case 5: phase = 2; a = XR; dd = SA; break;   // dW0r = x[r]^T dt0
    default: phase = 2; a = -1; dd = SA; break;  // dW0g, db0
  }
}

__host__ __device__ inline int pair_mtiles(int i, int fp, int hp,
                                           bool equiv) {
  if (i <= 1 && !equiv) return 0;
  if (i == 0 || i == 2) return hp / 16;
  if (i == 4 || i == 5) return fp / 16;
  return 1;
}

__host__ __device__ inline int n_jobs(int fp, int hp, bool equiv) {
  int n = 0;
  for (int i = 0; i < kPairs; ++i) n += 2 * pair_mtiles(i, fp, hp, equiv);
  return n;
}

// job j -> pair, m-tile, n-half; false past the last job
__host__ __device__ inline bool job_of(int j, int fp, int hp, bool equiv,
                                       int& pair, int& mt, int& nh) {
  for (int i = 0; i < kPairs; ++i) {
    const int n = 2 * pair_mtiles(i, fp, hp, equiv);
    if (j < n) {
      pair = i;
      mt = j >> 1;
      nh = j & 1;
      return true;
    }
    j -= n;
  }
  return false;
}

// route 1 at these widths: F, H <= 48, gp <= 15 (G' holds gp lanes and the
// ones column), the jobs <= 4 a warp and the layout in `optin` bytes
__host__ inline bool fits(int f, int h, int gp, bool equiv, int optin) {
  const int fp = round16(f), hp = round16(h);
  return fp <= kMaxW && hp <= kMaxW && gp + 1 <= kGW &&
         n_jobs(fp, hp, equiv) <= kWarps * kMaxJobs &&
         sizeof(float) * static_cast<size_t>(layout(f, h, equiv).total + 4) <=
             static_cast<size_t>(optin);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(a), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(a), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// A fragment (k permuted: columns k0 + 2t, k0 + 2t + 1 in slots t, t + 4)
// of a [16][ld] tile
__device__ __forceinline__ void load_a_perm(passp::FragA& a, const float* T,
                                            int ld, int k0) {
  const int g = passp::lane_g(), t = passp::lane_t();
  const float2 u0 = *reinterpret_cast<const float2*>(T + g * ld + k0 + 2 * t);
  const float2 u1 =
      *reinterpret_cast<const float2*>(T + (g + 8) * ld + k0 + 2 * t);
  passp::set_a<true>(a, u0.x, u1.x, u0.y, u1.y);
}

// B fragment of W (k permuted rows k0 + 2t, k0 + 2t + 1; column n0 + g)
__device__ __forceinline__ void load_b_perm(passp::FragB& b, const float* W,
                                            int ldw, int k0, int n0) {
  const int g = passp::lane_g(), t = passp::lane_t();
  const float* w = W + (k0 + 2 * t) * ldw + n0 + g;
  passp::split_ih(w[0], b.hi[0], b.lo[0]);
  passp::split_ih(w[ldw], b.hi[1], b.lo[1]);
}

// B fragment of W^T (k permuted over W's columns k0 + 2t, + 1; W's row
// n0 + g): one float2
__device__ __forceinline__ void load_bt_perm(passp::FragB& b, const float* W,
                                             int ldw, int k0, int n0) {
  const int g = passp::lane_g(), t = passp::lane_t();
  const float2 w =
      *reinterpret_cast<const float2*>(W + (n0 + g) * ldw + k0 + 2 * t);
  passp::split_ih(w.x, b.hi[0], b.lo[0]);
  passp::split_ih(w.y, b.hi[1], b.lo[1]);
}

// an accumulator [NT][4] (rows g, g + 8; columns 8j + 2t, + 1) into a
// [16][ld] tile
template <int NT>
__device__ __forceinline__ void store_c(float* T, int ld,
                                        const float (&c)[NT][4]) {
  const int g = passp::lane_g(), t = passp::lane_t();
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    *reinterpret_cast<float2*>(T + g * ld + 8 * j + 2 * t) =
        make_float2(c[j][0], c[j][1]);
    *reinterpret_cast<float2*>(T + (g + 8) * ld + 8 * j + 2 * t) =
        make_float2(c[j][2], c[j][3]);
  }
}

template <int NT>
__device__ __forceinline__ void load_c(float (&c)[NT][4], const float* T,
                                       int ld) {
  const int g = passp::lane_g(), t = passp::lane_t();
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 u0 =
        *reinterpret_cast<const float2*>(T + g * ld + 8 * j + 2 * t);
    const float2 u1 =
        *reinterpret_cast<const float2*>(T + (g + 8) * ld + 8 * j + 2 * t);
    c[j][0] = u0.x; c[j][1] = u0.y; c[j][2] = u1.x; c[j][3] = u1.y;
  }
}

// c += a * b, one k step in 3xTF32 with the large product apart: the two
// small products from zero, the large one from zero, each sum added to c
// with a float32 add.  The tensor cores truncate an mma's result toward
// zero, and the large product added onto the small ones inside one mma
// leaves a bias toward zero in long chains; kept apart, the forward's agg
// had half that bias on the card (see PERF.md)
__device__ __forceinline__ void mma3_apart(float (&c)[4],
                                           const passp::FragA& a,
                                           const passp::FragB& b) {
  float d[4], e[4];
  passp::mma_z(d, a.lo, b.hi);
  passp::mma(d, a.hi, b.lo);
  passp::mma_z(e, a.hi, b.hi);
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    c[v] += d[v];
    c[v] += e[v];
  }
}

// c += A . B for A [16 x K] from registers (an accumulator of the previous
// product, [KT][4], k permuted) and B = W (TR: W^T) from shared memory;
// APART: each k step as mma3_apart
template <int NT, int KT, bool TR, bool APART = false>
__device__ __forceinline__ void chain_regs(float (&c)[NT][4],
                                           const float (&a)[KT][4],
                                           const float* W, int ldw) {
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    passp::FragA fa;
    passp::set_a<true>(fa, a[j][0], a[j][2], a[j][1], a[j][3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      passp::FragB fb;
      if (TR)
        load_bt_perm(fb, W, ldw, 8 * j, 8 * n);
      else
        load_b_perm(fb, W, ldw, 8 * j, 8 * n);
      if (APART)
        mma3_apart(c[n], fa, fb);
      else
        passp::mma3(c[n], fa, fb);
    }
  }
}

// c += T . W (TR: W^T) for T [16 x 8 KS] a shared tile (row stride ld);
// APART as chain_regs
template <int NT, bool TR, bool APART = false>
__device__ __forceinline__ void chain_smem(float (&c)[NT][4], const float* T,
                                           int ld, int ks, const float* W,
                                           int ldw) {
  for (int s = 0; s < ks; ++s) {
    passp::FragA fa;
    load_a_perm(fa, T, ld, 8 * s);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      passp::FragB fb;
      if (TR)
        load_bt_perm(fb, W, ldw, 8 * s, 8 * n);
      else
        load_b_perm(fb, W, ldw, 8 * s, 8 * n);
      if (APART)
        mma3_apart(c[n], fa, fb);
      else
        passp::mma3(c[n], fa, fb);
    }
  }
}

// the weights into a block's shared memory (layout()), zero-padded: Wst
// rows [0, Fp) W0s, [Fp, 2Fp) W0r, [2Fp, 2Fp + gp) W0g, 2Fp + gp b0, then
// zeros; W1 and Wc0 [HP][ldw]; b1, bc0, wc1 [HP].  No barrier inside.
template <bool EQUIV, int HP, int THREADS>
__device__ __forceinline__ void stage_weights(const Params& p,
                                              const Layout& L, float* sm) {
  const int f = p.f, h = p.h, gp = p.gp, fp = L.fp, ldw = L.ldw;
  float* wst = sm + L.wst;
  for (int i = threadIdx.x; i < (2 * fp + kGW) * ldw; i += THREADS) {
    const int r = i / ldw, c = i - r * ldw;
    float v = 0.f;
    if (c < h) {
      if (r < fp) {
        if (r < f) v = p.w[0][r * h + c];
      } else if (r < 2 * fp) {
        if (r - fp < f) v = p.w[1][(r - fp) * h + c];
      } else if (r - 2 * fp < gp) {
        v = p.w[2][(r - 2 * fp) * h + c];
      } else if (r - 2 * fp == gp) {
        v = p.w[3][c];
      }
    }
    wst[i] = v;
  }
  for (int i = threadIdx.x; i < HP * ldw; i += THREADS) {
    const int r = i / ldw, c = i - r * ldw;
    const bool in = r < h && c < h;
    sm[L.w1 + i] = in ? p.w[4][r * h + c] : 0.f;
    if (EQUIV) sm[L.wc0 + i] = in ? p.w[6][r * h + c] : 0.f;
  }
  for (int c = threadIdx.x; c < HP; c += THREADS) {
    sm[L.b1 + c] = c < h ? p.w[5][c] : 0.f;
    sm[L.bc0 + c] = EQUIV && c < h ? p.w[7][c] : 0.f;
    sm[L.wc1 + c] = EQUIV && c < h ? p.w[8][c] : 0.f;
  }
}

template <bool EQUIV, int NT>
__global__ void __launch_bounds__(kThreads, 1)
pass_p_tc_kernel(const Params p) {
  constexpr int HP = 8 * NT;
  constexpr int NH = NT / 2;            // n-tiles a job
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int f = p.f, h = p.h, gp = p.gp, geo_ld = 3 + p.gp;
  const int n_rows = p.n_rows;
  const Layout L = layout(f, h, EQUIV);
  const int fp = L.fp, ld = L.ld, ldw = L.ldw;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* wst = sm + L.wst;
  float* w1s = sm + L.w1;
  float* wc0s = sm + L.wc0;
  float* b1s = sm + L.b1;
  float* bc0s = sm + L.bc0;
  float* wc1s = sm + L.wc1;
  auto region = [&](int w) { return sm + L.warps + w * L.per_warp; };
  auto slot = [&](int w, int k) { return region(w) + k * M * ld; };
  auto gtile = [&](int w) { return region(w) + kSlots * M * ld; };
  float* mine = region(warp);
  float* graw = gtile(warp) + M * kLdG;
  int* s_ids = reinterpret_cast<int*>(graw + M * kLdRaw);   // [16] sender
  int* e_ids = s_ids + M;                                   // [16] edge id
  float* dwc1_s = reinterpret_cast<float*>(e_ids + M);      // [48] dwc1
  // [2][48] dx sums of the tile's first (head) and last (tail) rows
  float* piece = dwc1_s + kMaxW;
  int* piece_row = reinterpret_cast<int*>(piece + 2 * kMaxW);  // [2]

  stage_weights<EQUIV, HP, kThreads>(p, L, sm);
  // this warp's region zeroed: the slots' pad columns stay zero (the
  // gathers write columns < F only)
  for (int i = lane; i < L.per_warp; i += 32) mine[i] = 0.f;
  if (warp == 0) {
    int rb, re;
    passp::share_range(p.row_ptr, n_rows, blockIdx.x, gridDim.x, rb, re);
    if (lane == 0) {
      reinterpret_cast<int*>(sm + L.total)[0] = rb;
      reinterpret_cast<int*>(sm + L.total)[1] = re;
    }
  }
  __syncthreads();
  const int r_begin = reinterpret_cast<const int*>(sm + L.total)[0];
  const int r_end = reinterpret_cast<const int*>(sm + L.total)[1];
  const int p_begin = __ldg(p.row_ptr + r_begin);
  const int p_end = __ldg(p.row_ptr + r_end);
  const int n_steps = (p_end - p_begin + kStep - 1) / kStep;

  // this warp's jobs: warp + 8 k, k < kMaxJobs, their accumulators
  float acc[kMaxJobs][NH][4];
#pragma unroll
  for (int k = 0; k < kMaxJobs; ++k)
#pragma unroll
    for (int n = 0; n < NH; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[k][n][v] = 0.f;

  // the jobs of one phase over the step's eight tiles (natural edge order
  // as k: A^T fragments and D fragments both read down columns)
  auto run_phase = [&](int phase, int q) {
#pragma unroll
    for (int k = 0; k < kMaxJobs; ++k) {
      int pair, mt, nh, ph, as, ds;
      if (!job_of(warp + kWarps * k, fp, HP, EQUIV, pair, mt, nh)) continue;
      pair_info(pair, ph, as, ds);
      if (ph != phase) continue;
      const int m0 = 16 * mt, n0 = 8 * NH * nh;
      for (int w = 0; w < kWarps; ++w) {
        if (q + M * w >= p_end) break;
        const float* A = as < 0 ? gtile(w) : slot(w, as);
        const int lda = as < 0 ? kLdG : ld;
        const float* D = slot(w, ds);
#pragma unroll
        for (int kk = 0; kk < M; kk += 8) {
          passp::FragA fa;
          const float* ap = A + (kk + t) * lda + m0 + g;
          passp::set_a<true>(fa, ap[0], ap[8], ap[4 * lda], ap[4 * lda + 8]);
#pragma unroll
          for (int n = 0; n < NH; ++n) {
            passp::FragB fb;
            const float* dp = D + (kk + t) * ld + n0 + 8 * n + g;
            passp::split_ih(dp[0], fb.hi[0], fb.lo[0]);
            passp::split_ih(dp[4 * ld], fb.hi[1], fb.lo[1]);
            passp::mma3(acc[k][n], fa, fb);
          }
        }
      }
    }
  };

  // dx, in two steps.  Each warp sums its tile's edges' dx rows into
  // their sender rows in position order, writes the rows that begin and
  // end inside the tile, and leaves the sums of its first and last rows
  // (which may go on in the tiles before and after) as pieces; the last
  // warp, during the last phase, adds the step's pieces in tile order
  // into the rows they belong to and writes those rows, rows without
  // edges as zeros.
  const bool walker = p.out != nullptr && warp == kWarps - 1;
  int cur = r_begin;
  float dx0 = 0.f, dx1 = 0.f;
  auto flush = [&](int upto) {
    float* o = p.out + static_cast<size_t>(cur) * f;
    if (lane < f) o[lane] = dx0;
    if (lane + 32 < f) o[lane + 32] = dx1;
    for (int r = cur + 1; r < upto; ++r) {
      o = p.out + static_cast<size_t>(r) * f;
      if (lane < f) o[lane] = 0.f;
      if (lane + 32 < f) o[lane + 32] = 0.f;
    }
  };

  // ids of this warp's tile of step i in lanes 0..15: edge id, sender,
  // receiver (-1 past the block's positions)
  auto load_eid = [&](int i) {
    const int pos = p_begin + i * kStep + warp * M + lane;
    if (lane >= M || i >= n_steps || pos >= p_end) return -1;
    return p.perm != nullptr ? __ldg(p.perm + pos) : pos;
  };
  int eid = load_eid(0);
  int snd = eid >= 0 ? __ldg(p.send + eid) : -1;
  int rcv = eid >= 0 ? __ldg(p.recv + eid) : -1;

  for (int i = 0; i < n_steps; ++i) {
    const int q = p_begin + i * kStep;
    const int eid_next = load_eid(i + 1);
    // ---- this warp's tile: ids, gathers, cotangents ----
    const bool ok = eid >= 0 && snd >= r_begin && snd < r_end &&
                    static_cast<unsigned>(rcv) < static_cast<unsigned>(n_rows);
    if (lane < M) {
      s_ids[lane] = ok ? snd : -1;
      e_ids[lane] = eid;
    }
    float* xs = slot(warp, XS);
    float* xr = slot(warp, XR);
    const unsigned okm = __ballot_sync(kFull, ok);
#pragma unroll 1
    for (int e = 0; e < M; ++e) {
      const bool ve = (okm >> e) & 1u;
      const int se = __shfl_sync(kFull, snd, e);
      const int re = __shfl_sync(kFull, rcv, e);
      const int ee = __shfl_sync(kFull, eid, e);
      const float* xsr = p.x + static_cast<size_t>(ve ? se : 0) * f;
      const float* xrr = p.x + static_cast<size_t>(ve ? re : 0) * f;
      if ((f & 3) == 0) {
        for (int c = 4 * lane; c < f; c += 128) {
          cp_async16(xs + e * ld + c, xsr + c, ve);
          cp_async16(xr + e * ld + c, xrr + c, ve);
        }
      } else {
        for (int c = lane; c < f; c += 32) {
          cp_async4(xs + e * ld + c, xsr + c, ve);
          cp_async4(xr + e * ld + c, xrr + c, ve);
        }
      }
      const float* gr = p.geo + static_cast<size_t>(ve ? ee : 0) * geo_ld;
      if (lane < geo_ld) cp_async4(graw + e * kLdRaw + lane, gr + lane, ve);
    }
    // the cotangents at this lane's rows g and g + 8, zero off real edges
    const bool ok0 = (okm >> g) & 1u;
    const bool ok1 = (okm >> (g + 8)) & 1u;
    const int s0 = __shfl_sync(kFull, snd, g);
    const int s1 = __shfl_sync(kFull, snd, g + 8);
    float dm[NT][4];
    auto load_dagg = [&]() {
      const float* g0 = p.gagg + static_cast<size_t>(ok0 ? s0 : 0) * h;
      const float* g1 = p.gagg + static_cast<size_t>(ok1 ? s1 : 0) * h;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = 8 * n + 2 * t;
        dm[n][0] = ok0 && c < h ? __ldg(g0 + c) : 0.f;
        dm[n][1] = ok0 && c + 1 < h ? __ldg(g0 + c + 1) : 0.f;
        dm[n][2] = ok1 && c < h ? __ldg(g1 + c) : 0.f;
        dm[n][3] = ok1 && c + 1 < h ? __ldg(g1 + c + 1) : 0.f;
      }
    };
    if (!EQUIV) load_dagg();   // in flight while t0 and m are formed
    float dtr0[3], dtr1[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      dtr0[j] = EQUIV && ok0 ? __ldg(p.gpsum + static_cast<size_t>(s0) * 3 + j)
                             : 0.f;
      dtr1[j] = EQUIV && ok1 ? __ldg(p.gpsum + static_cast<size_t>(s1) * 3 + j)
                             : 0.f;
    }
    cp_async_wait_all();
    __syncwarp();
    // G': the geometry lanes, the ones column (real edges), zeros
    float* gt = gtile(warp);
    for (int i2 = lane; i2 < M * kGW; i2 += 32) {
      const int e = i2 >> 4, k = i2 & 15;
      const bool ve = s_ids[e] >= 0;
      gt[e * kLdG + k] = k < gp ? graw[e * kLdRaw + 3 + k]
                                : (k == gp && ve ? 1.f : 0.f);
    }
    __syncwarp();

    // ---- the chain: t0, a ----
    float cc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) cc[n][0] = cc[n][1] = cc[n][2] = cc[n][3] = 0.f;
    chain_smem<NT, false>(cc, xs, ld, fp / 8, wst, ldw);
    chain_smem<NT, false>(cc, xr, ld, fp / 8, wst + fp * ldw, ldw);
    chain_smem<NT, false>(cc, gt, kLdG, 2, wst + 2 * fp * ldw, ldw);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) cc[n][v] = fmaxf(cc[n][v], 0.f);
    store_c<NT>(slot(warp, SA), ld, cc);
    // m = relu(a . W1 + b1)
    float mm[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 bb = *reinterpret_cast<const float2*>(b1s + 8 * n + 2 * t);
      mm[n][0] = bb.x; mm[n][1] = bb.y; mm[n][2] = bb.x; mm[n][3] = bb.y;
    }
    chain_regs<NT, NT, false>(mm, cc, w1s, ldw);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) mm[n][v] = fmaxf(mm[n][v], 0.f);

    if (EQUIV) {
      store_c<NT>(slot(warp, SM), ld, mm);
      // v = relu(m . Wc0 + bc0); c = tanh(v . wc1)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 bb =
            *reinterpret_cast<const float2*>(bc0s + 8 * n + 2 * t);
        cc[n][0] = bb.x; cc[n][1] = bb.y; cc[n][2] = bb.x; cc[n][3] = bb.y;
      }
      chain_regs<NT, NT, false>(cc, mm, wc0s, ldw);
      float p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 wc = *reinterpret_cast<const float2*>(wc1s + 8 * n + 2 * t);
#pragma unroll
        for (int v = 0; v < 4; ++v) cc[n][v] = fmaxf(cc[n][v], 0.f);
        p0 += cc[n][0] * wc.x + cc[n][1] * wc.y;
        p1 += cc[n][2] * wc.x + cc[n][3] * wc.y;
      }
      p0 += __shfl_xor_sync(kFull, p0, 1);
      p1 += __shfl_xor_sync(kFull, p1, 1);
      p0 += __shfl_xor_sync(kFull, p0, 2);
      p1 += __shfl_xor_sync(kFull, p1, 2);
      const float c0 = tanhf(p0), c1 = tanhf(p1);
      // d(clip(diff * c)): dc, the diff lanes of dgeo; dcp = dc (1 - c^2)
      float dc0 = 0.f, dc1 = 0.f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float d0 = graw[g * kLdRaw + j], d1 = graw[(g + 8) * kLdRaw + j];
        const float tr0 = d0 * c0, tr1 = d1 * c1;
        const bool pass0 = tr0 >= -100.f && tr0 <= 100.f;
        const bool pass1 = tr1 >= -100.f && tr1 <= 100.f;
        dc0 += pass0 ? dtr0[j] * d0 : 0.f;
        dc1 += pass1 ? dtr1[j] * d1 : 0.f;
        if (p.dgeo != nullptr && t == j) {
          const int e0 = e_ids[g], e1 = e_ids[g + 8];
          if (ok0)
            p.dgeo[static_cast<size_t>(e0) * geo_ld + j] =
                pass0 ? dtr0[j] * c0 : 0.f;
          if (ok1)
            p.dgeo[static_cast<size_t>(e1) * geo_ld + j] =
                pass1 ? dtr1[j] * c1 : 0.f;
        }
      }
      const float dcp0 = dc0 * (1.f - c0 * c0), dcp1 = dc1 * (1.f - c1 * c1);
      // dwc1 += v^T dcp: the tile's column sums (this lane's two rows,
      // then the rows g by shuffles, in a fixed order) into the warp's
      // sums; du0 = wc1 dcp (v > 0)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 wc = *reinterpret_cast<const float2*>(wc1s + 8 * n + 2 * t);
        float w0 = cc[n][0] * dcp0 + cc[n][2] * dcp1;
        float w1 = cc[n][1] * dcp0 + cc[n][3] * dcp1;
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          w0 += __shfl_xor_sync(kFull, w0, o);
          w1 += __shfl_xor_sync(kFull, w1, o);
        }
        if (g == 0) {
          dwc1_s[8 * n + 2 * t] += w0;
          dwc1_s[8 * n + 2 * t + 1] += w1;
        }
        cc[n][0] = cc[n][0] > 0.f ? wc.x * dcp0 : 0.f;
        cc[n][1] = cc[n][1] > 0.f ? wc.y * dcp0 : 0.f;
        cc[n][2] = cc[n][2] > 0.f ? wc.x * dcp1 : 0.f;
        cc[n][3] = cc[n][3] > 0.f ? wc.y * dcp1 : 0.f;
      }
      store_c<NT>(slot(warp, SD), ld, cc);
      __syncthreads();                                  // B1
      load_dagg();   // in flight through the first phase
      run_phase(0, q);                                  // dWc0, dbc0
      __syncthreads();                                  // B2
      // dm = dagg[s] + du0 . Wc0^T; du = dm (m > 0)
      load_c<NT>(cc, slot(warp, SD), ld);
      chain_regs<NT, NT, true>(dm, cc, wc0s, ldw);
      load_c<NT>(mm, slot(warp, SM), ld);
    }
    // du = dm (m > 0), over m in its slot
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) dm[n][v] = mm[n][v] > 0.f ? dm[n][v] : 0.f;
    store_c<NT>(slot(warp, SM), ld, dm);
    __syncthreads();                                    // B3
    int snd_next = -1, rcv_next = -1;
    if (eid_next >= 0) {
      snd_next = __ldg(p.send + eid_next);
      rcv_next = __ldg(p.recv + eid_next);
    }
    run_phase(1, q);                                    // dW1, db1
    __syncthreads();                                    // B4
    // dt0 = (du . W1^T) (a > 0), over a in its slot
#pragma unroll
    for (int n = 0; n < NT; ++n) cc[n][0] = cc[n][1] = cc[n][2] = cc[n][3] = 0.f;
    chain_regs<NT, NT, true>(cc, dm, w1s, ldw);
    load_c<NT>(mm, slot(warp, SA), ld);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) cc[n][v] = mm[n][v] > 0.f ? cc[n][v] : 0.f;
    store_c<NT>(slot(warp, SA), ld, cc);
    // the radial and edge_attr lanes of dgeo: dt0 . W0g^T
    if (p.dgeo != nullptr) {
      for (int k = 0; k < gp; ++k) {
        const float* wg = wst + (2 * fp + k) * ldw;
        float v0 = 0.f, v1 = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float2 w = *reinterpret_cast<const float2*>(wg + 8 * n + 2 * t);
          v0 += cc[n][0] * w.x + cc[n][1] * w.y;
          v1 += cc[n][2] * w.x + cc[n][3] * w.y;
        }
        v0 += __shfl_xor_sync(kFull, v0, 1);
        v1 += __shfl_xor_sync(kFull, v1, 1);
        v0 += __shfl_xor_sync(kFull, v0, 2);
        v1 += __shfl_xor_sync(kFull, v1, 2);
        if (t == 0) {
          if (ok0)
            p.dgeo[static_cast<size_t>(e_ids[g]) * geo_ld + 3 + k] = v0;
          if (ok1)
            p.dgeo[static_cast<size_t>(e_ids[g + 8]) * geo_ld + 3 + k] = v1;
        }
      }
    }
    // dx per edge = dt0 . W0s^T into the D0 slot
    if (p.out != nullptr) {
      float* dd = slot(warp, SD);
      for (int n = 0; n < fp / 8; ++n) {
        float dx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          passp::FragA fa;
          passp::set_a<true>(fa, cc[j][0], cc[j][2], cc[j][1], cc[j][3]);
          passp::FragB fb;
          load_bt_perm(fb, wst, ldw, 8 * j, 8 * n);
          passp::mma3(dx, fa, fb);
        }
        *reinterpret_cast<float2*>(dd + g * ld + 8 * n + 2 * t) =
            make_float2(dx[0], dx[1]);
        *reinterpret_cast<float2*>(dd + (g + 8) * ld + 8 * n + 2 * t) =
            make_float2(dx[2], dx[3]);
      }
      __syncwarp();
      // this tile's rows: senders and this lane's columns read first
      int sv[M];
      float v0[M], v1[M];
#pragma unroll
      for (int e = 0; e < M; ++e) {
        sv[e] = s_ids[e];
        v0[e] = lane < f ? dd[e * ld + lane] : 0.f;
        v1[e] = lane + 32 < f ? dd[e * ld + lane + 32] : 0.f;
      }
      int first = -1, row = -1;
      float a0 = 0.f, a1 = 0.f;
      auto put = [&](int r, float u0, float u1) {
        float* o = p.out + static_cast<size_t>(r) * f;
        if (lane < f) o[lane] = u0;
        if (lane + 32 < f) o[lane + 32] = u1;
      };
#pragma unroll
      for (int e = 0; e < M; ++e) {
        const int s = sv[e];
        if (s < 0 || s < row) continue;   // not a real edge of these rows
        if (s != row) {
          if (row == first && row >= 0) {
            if (lane < f) piece[lane] = a0;
            if (lane + 32 < f) piece[lane + 32] = a1;
          } else if (row >= 0) {
            put(row, a0, a1);             // begins and ends in this tile
          }
          if (row >= 0)
            for (int r = row + 1; r < s; ++r) put(r, 0.f, 0.f);
          if (first < 0) first = s;
          row = s;
          a0 = a1 = 0.f;
        }
        a0 += v0[e];
        a1 += v1[e];
      }
      if (row >= 0 && row != first) {
        if (lane < f) piece[kMaxW + lane] = a0;
        if (lane + 32 < f) piece[kMaxW + lane + 32] = a1;
      } else if (row >= 0) {
        if (lane < f) piece[lane] = a0;
        if (lane + 32 < f) piece[lane + 32] = a1;
      }
      if (lane == 0) {
        piece_row[0] = first;
        piece_row[1] = row != first ? row : -1;
      }
    }
    __syncthreads();                                    // B5
    run_phase(2, q);                                    // dW0s, dW0r, dW0g, db0
    if (walker) {
      for (int w = 0; w < kWarps; ++w) {
        if (q + M * w >= p_end) break;
        const float* pw = piece + (w - warp) * L.per_warp;
        const int* rw = piece_row + (w - warp) * L.per_warp;
        const int hr = rw[0], tr = rw[1];
        if (hr >= cur) {               // the head: the row carried on, or
          if (hr != cur) {             // a later one (rows between: none)
            flush(hr);
            cur = hr;
            dx0 = dx1 = 0.f;
          }
          if (lane < f) dx0 += pw[lane];
          if (lane + 32 < f) dx1 += pw[lane + 32];
        }
        if (tr > cur) {                // the tail: the rows between the
          flush(cur + 1);              // head and it are written
          cur = tr;
          dx0 = lane < f ? pw[kMaxW + lane] : 0.f;
          dx1 = lane + 32 < f ? pw[kMaxW + lane + 32] : 0.f;
        }
      }
    }
    __syncthreads();                                    // B6
    eid = eid_next;
    snd = snd_next;
    rcv = rcv_next;
  }
  if (walker && r_begin < r_end) flush(r_end);

  // this block's partial: every entry of the packed layout written once
  int goff[9];
  const int gsize = weight_layout(f, h, gp, h, EQUIV, goff);
  float* G = p.partial + static_cast<size_t>(gsize) * blockIdx.x;
#pragma unroll
  for (int k = 0; k < kMaxJobs; ++k) {
    int pair, mt, nh;
    if (!job_of(warp + kWarps * k, fp, HP, EQUIV, pair, mt, nh)) continue;
    const int m0 = 16 * mt, n0 = 8 * NH * nh;
#pragma unroll
    for (int n = 0; n < NH; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = m0 + g + 8 * (v >> 1);
        const int c = n0 + 8 * n + 2 * t + (v & 1);
        if (c >= h) continue;
        const float val = acc[k][n][v];
        switch (pair) {
          case 0: if (r < h) G[goff[6] + r * h + c] = val; break;
          case 1: if (r == gp) G[goff[7] + c] = val; break;
          case 2: if (r < h) G[goff[4] + r * h + c] = val; break;
          case 3: if (r == gp) G[goff[5] + c] = val; break;
          case 4: if (r < f) G[goff[0] + r * h + c] = val; break;
          case 5: if (r < f) G[goff[1] + r * h + c] = val; break;
          default:
            if (r < gp) G[goff[2] + r * h + c] = val;
            else if (r == gp) G[goff[3] + c] = val;
            break;
        }
      }
  }
  if (EQUIV) {
    // dwc1: the warps' sums, in warp order
    __syncthreads();
    for (int c = tid; c < h; c += kThreads) {
      float v = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float* sw = reinterpret_cast<const float*>(
            gtile(w) + M * kLdG + M * kLdRaw + 2 * M);
        v += sw[c];
      }
      G[goff[8] + c] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// pass S, route 1: pass P's chain in receiver order, each warp on its own
// share of the rows
// ---------------------------------------------------------------------------

constexpr int kWarpsS = 12;             // warps a block of pass S
constexpr int kThreadsS = 32 * kWarpsS;

// pass S's shared layout: the weights as layout() stages them, then per
// warp the gathered x[s], x[r] and a slot for dagg[s] (then the per-edge
// dx), its G' [16][kLdG], raw geo rows [16][kLdRaw], dpsum[s] [16][4] and
// the receivers [16]
__host__ __device__ inline Layout layout_s(int f, int h, bool equiv) {
  Layout L = layout(f, h, equiv);
  L.per_warp = 3 * M * L.ld + M * kLdG + M * kLdRaw + 4 * M + M;
  L.total = L.warps + kWarpsS * L.per_warp;
  return L;
}

// pass S's route 1 at these widths: pass P's F, H <= 48 and gp <= 15 (no
// weight-gradient jobs), the layout in `optin` bytes
__host__ inline bool fits_s(int f, int h, int gp, bool equiv, int optin) {
  return round16(f) <= kMaxW && round16(h) <= kMaxW && gp + 1 <= kGW &&
         sizeof(float) * static_cast<size_t>(layout_s(f, h, equiv).total) <=
             static_cast<size_t>(optin);
}

// async copy of n floats from src to dst (16-byte pieces when n and both
// ends allow), zero-filled when !valid; the warp's lanes share the pieces
template <bool WIDE>
__device__ __forceinline__ void cp_row(float* dst, const float* src, int n,
                                       bool valid, int lane) {
  if (WIDE) {
    for (int c = 4 * lane; c < n; c += 128) cp_async16(dst + c, src + c, valid);
  } else {
    for (int c = lane; c < n; c += 32) cp_async4(dst + c, src + c, valid);
  }
}

template <bool EQUIV, int NT>
__global__ void __launch_bounds__(kThreadsS, 1)
pass_s_tc_kernel(const Params p) {
  constexpr int HP = 8 * NT;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int f = p.f, h = p.h, gp = p.gp, geo_ld = 3 + p.gp;
  const int n_rows = p.n_rows;
  const Layout L = layout_s(f, h, EQUIV);
  const int fp = L.fp, ld = L.ld, ldw = L.ldw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float* wst = sm + L.wst;
  const float* w1s = sm + L.w1;
  const float* wc0s = sm + L.wc0;
  const float* b1s = sm + L.b1;
  const float* bc0s = sm + L.bc0;
  const float* wc1s = sm + L.wc1;
  float* xs = sm + L.warps + warp * L.per_warp;
  float* xr = xs + M * ld;
  float* sd = xr + M * ld;               // dagg[s], then the per-edge dx
  float* gt = sd + M * ld;
  float* graw = gt + M * kLdG;
  float* dps = graw + M * kLdRaw;        // dpsum[s]: [16][4]
  int* r_ids = reinterpret_cast<int*>(dps + 4 * M);

  stage_weights<EQUIV, HP, kThreadsS>(p, L, sm);
  // this warp's region zeroed: the slots' pad columns stay zero (the
  // gathers write columns < F, or < H, only)
  for (int i = lane; i < L.per_warp; i += 32) xs[i] = 0.f;
  // this warp's share of the receiver rows (rows plus edges balanced)
  int rb, re;
  passp::share_range(p.row_ptr, n_rows, blockIdx.x * kWarpsS + warp,
                     gridDim.x * kWarpsS, rb, re);
  __syncthreads();
  const int p_begin = __ldg(p.row_ptr + rb);
  const int p_end = __ldg(p.row_ptr + re);

  // dx: each row's per-edge rows summed in position order (a row goes on
  // from one tile into the next), lane holding columns lane and lane + 32;
  // every row of the share written once, rows without edges as zeros
  int row = -1, next = rb;
  float a0 = 0.f, a1 = 0.f;
  auto put = [&](int r, float u0, float u1) {
    float* o = p.out + static_cast<size_t>(r) * f;
    if (lane < f) o[lane] = u0;
    if (lane + 32 < f) o[lane + 32] = u1;
  };

  // lanes 0..15: the tile's edge ids (positions) and their ends
  auto load_eid = [&](int q) {
    return lane < M && q + lane < p_end ? q + lane : -1;
  };
  int eid = load_eid(p_begin);
  int snd = eid >= 0 ? __ldg(p.send + eid) : -1;
  int rcv = eid >= 0 ? __ldg(p.recv + eid) : -1;

  for (int q = p_begin; q < p_end; q += M) {
    const bool ok = eid >= 0 &&
                    static_cast<unsigned>(snd) < static_cast<unsigned>(n_rows) &&
                    rcv >= rb && rcv < re;
    if (lane < M) r_ids[lane] = ok ? rcv : -1;
    const unsigned okm = __ballot_sync(kFull, ok);
    // the gathers: x[s], x[r], the geometry, dagg[s] and dpsum[s], zeros
    // off real edges
#pragma unroll 1
    for (int e = 0; e < M; ++e) {
      const bool ve = (okm >> e) & 1u;
      const int se = ve ? __shfl_sync(kFull, snd, e) : 0;
      const int rr = ve ? __shfl_sync(kFull, rcv, e) : 0;
      const int ee = ve ? __shfl_sync(kFull, eid, e) : 0;
      if ((f & 3) == 0) {
        cp_row<true>(xs + e * ld, p.x + static_cast<size_t>(se) * f, f, ve,
                     lane);
        cp_row<true>(xr + e * ld, p.x + static_cast<size_t>(rr) * f, f, ve,
                     lane);
      } else {
        cp_row<false>(xs + e * ld, p.x + static_cast<size_t>(se) * f, f, ve,
                      lane);
        cp_row<false>(xr + e * ld, p.x + static_cast<size_t>(rr) * f, f, ve,
                      lane);
      }
      if ((h & 3) == 0)
        cp_row<true>(sd + e * ld, p.gagg + static_cast<size_t>(se) * h, h,
                     ve, lane);
      else
        cp_row<false>(sd + e * ld, p.gagg + static_cast<size_t>(se) * h, h,
                      ve, lane);
      if (lane < geo_ld)
        cp_async4(graw + e * kLdRaw + lane,
                  p.geo + static_cast<size_t>(ee) * geo_ld + lane, ve);
      if (EQUIV && lane < 3)
        cp_async4(dps + 4 * e + lane,
                  p.gpsum + static_cast<size_t>(se) * 3 + lane, ve);
    }
    // the next tile's ids, in flight while this one is computed
    const int eid_next = load_eid(q + M);
    const int snd_next = eid_next >= 0 ? __ldg(p.send + eid_next) : -1;
    const int rcv_next = eid_next >= 0 ? __ldg(p.recv + eid_next) : -1;
    cp_async_wait_all();
    __syncwarp();
    // G': the geometry lanes, the ones column (real edges), zeros
    for (int i2 = lane; i2 < M * kGW; i2 += 32) {
      const int e = i2 >> 4, k = i2 & 15;
      gt[e * kLdG + k] = k < gp ? graw[e * kLdRaw + 3 + k]
                                : (k == gp && r_ids[e] >= 0 ? 1.f : 0.f);
    }
    __syncwarp();

    // ---- the chain: t0, a (kept as its signs) ----
    float cc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) cc[n][0] = cc[n][1] = cc[n][2] = cc[n][3] = 0.f;
    chain_smem<NT, false>(cc, xs, ld, fp / 8, wst, ldw);
    chain_smem<NT, false>(cc, xr, ld, fp / 8, wst + fp * ldw, ldw);
    chain_smem<NT, false>(cc, gt, kLdG, 2, wst + 2 * fp * ldw, ldw);
    unsigned a_pos = 0u, m_pos = 0u;   // bit 4 n + v: a > 0, m > 0
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        cc[n][v] = fmaxf(cc[n][v], 0.f);
        a_pos |= cc[n][v] > 0.f ? 1u << (4 * n + v) : 0u;
      }
    // m = relu(a . W1 + b1)
    float mm[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 bb = *reinterpret_cast<const float2*>(b1s + 8 * n + 2 * t);
      mm[n][0] = bb.x; mm[n][1] = bb.y; mm[n][2] = bb.x; mm[n][3] = bb.y;
    }
    chain_regs<NT, NT, false>(mm, cc, w1s, ldw);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        mm[n][v] = fmaxf(mm[n][v], 0.f);
        m_pos |= mm[n][v] > 0.f ? 1u << (4 * n + v) : 0u;
      }
    // dm = dagg[s] (columns < H of the slot)
    float dm[NT][4];
    {
      const float* d0 = sd + g * ld;
      const float* d1 = sd + (g + 8) * ld;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = 8 * n + 2 * t;
        dm[n][0] = c < h ? d0[c] : 0.f;
        dm[n][1] = c + 1 < h ? d0[c + 1] : 0.f;
        dm[n][2] = c < h ? d1[c] : 0.f;
        dm[n][3] = c + 1 < h ? d1[c + 1] : 0.f;
      }
    }
    if (EQUIV) {
      // v = relu(m . Wc0 + bc0); c = tanh(v . wc1)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 bb =
            *reinterpret_cast<const float2*>(bc0s + 8 * n + 2 * t);
        cc[n][0] = bb.x; cc[n][1] = bb.y; cc[n][2] = bb.x; cc[n][3] = bb.y;
      }
      chain_regs<NT, NT, false>(cc, mm, wc0s, ldw);
      float p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 wc = *reinterpret_cast<const float2*>(wc1s + 8 * n + 2 * t);
#pragma unroll
        for (int v = 0; v < 4; ++v) cc[n][v] = fmaxf(cc[n][v], 0.f);
        p0 += cc[n][0] * wc.x + cc[n][1] * wc.y;
        p1 += cc[n][2] * wc.x + cc[n][3] * wc.y;
      }
      p0 += __shfl_xor_sync(kFull, p0, 1);
      p1 += __shfl_xor_sync(kFull, p1, 1);
      p0 += __shfl_xor_sync(kFull, p0, 2);
      p1 += __shfl_xor_sync(kFull, p1, 2);
      const float c0 = tanhf(p0), c1 = tanhf(p1);
      // d(clip(diff * c)) -> dc; dcp = dc (1 - c^2)
      float dc0 = 0.f, dc1 = 0.f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float d0 = graw[g * kLdRaw + j], d1 = graw[(g + 8) * kLdRaw + j];
        const float tr0 = d0 * c0, tr1 = d1 * c1;
        dc0 += tr0 >= -100.f && tr0 <= 100.f ? dps[4 * g + j] * d0 : 0.f;
        dc1 += tr1 >= -100.f && tr1 <= 100.f ? dps[4 * (g + 8) + j] * d1
                                             : 0.f;
      }
      const float dcp0 = dc0 * (1.f - c0 * c0), dcp1 = dc1 * (1.f - c1 * c1);
      // du0 = wc1 dcp (v > 0); dm += du0 . Wc0^T
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 wc = *reinterpret_cast<const float2*>(wc1s + 8 * n + 2 * t);
        cc[n][0] = cc[n][0] > 0.f ? wc.x * dcp0 : 0.f;
        cc[n][1] = cc[n][1] > 0.f ? wc.y * dcp0 : 0.f;
        cc[n][2] = cc[n][2] > 0.f ? wc.x * dcp1 : 0.f;
        cc[n][3] = cc[n][3] > 0.f ? wc.y * dcp1 : 0.f;
      }
      chain_regs<NT, NT, true>(dm, cc, wc0s, ldw);
    }
    // du = dm (m > 0); dt0 = (du . W1^T) (a > 0)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        if (!((m_pos >> (4 * n + v)) & 1u)) dm[n][v] = 0.f;
        cc[n][v] = 0.f;
      }
    chain_regs<NT, NT, true>(cc, dm, w1s, ldw);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (!((a_pos >> (4 * n + v)) & 1u)) cc[n][v] = 0.f;
    __syncwarp();   // every lane has read dagg from the slot
    // dx per edge = dt0 . W0r^T into the slot
    for (int n = 0; n < fp / 8; ++n) {
      float dx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        passp::FragA fa;
        passp::set_a<true>(fa, cc[j][0], cc[j][2], cc[j][1], cc[j][3]);
        passp::FragB fb;
        load_bt_perm(fb, wst + fp * ldw, ldw, 8 * j, 8 * n);
        passp::mma3(dx, fa, fb);
      }
      *reinterpret_cast<float2*>(sd + g * ld + 8 * n + 2 * t) =
          make_float2(dx[0], dx[1]);
      *reinterpret_cast<float2*>(sd + (g + 8) * ld + 8 * n + 2 * t) =
          make_float2(dx[2], dx[3]);
    }
    __syncwarp();
    // the tile's edges into their rows, in position order
#pragma unroll 1
    for (int e = 0; e < M; ++e) {
      const int r = r_ids[e];
      if (r < 0) continue;
      if (r != row) {
        if (row >= 0) {
          put(row, a0, a1);
          next = row + 1;
        }
        for (int z = next; z < r; ++z) put(z, 0.f, 0.f);
        row = r;
        a0 = a1 = 0.f;
      }
      if (lane < f) a0 += sd[e * ld + lane];
      if (lane + 32 < f) a1 += sd[e * ld + lane + 32];
    }
    __syncwarp();   // the slots are gathered into next
    eid = eid_next;
    snd = snd_next;
    rcv = rcv_next;
  }
  if (row >= 0) {
    put(row, a0, a1);
    next = row + 1;
  }
  for (int z = next; z < re; ++z) put(z, 0.f, 0.f);
}

// ---------------------------------------------------------------------------
// the forward, route 1: the front half of the chain in sender order, each
// warp on its own share of the rows
// ---------------------------------------------------------------------------

constexpr int kWarpsF = 12;             // warps a block of the forward
constexpr int kThreadsF = 32 * kWarpsF;

// the forward's shared layout: the weights as layout() stages them, then per
// warp the gathered x[s] and x[r], a slot for m and the translation lanes,
// its G' [16][kLdG], raw geo rows [16][kLdRaw] and the senders [16]
__host__ __device__ inline Layout layout_f(int f, int h, bool equiv) {
  Layout L = layout(f, h, equiv);
  L.per_warp = 3 * M * L.ld + M * kLdG + M * kLdRaw + M;
  L.total = L.warps + kWarpsF * L.per_warp;
  return L;
}

// the forward's route 1 at these widths: pass P's F, H <= 48 and gp <= 15
// (the slot's columns Hp .. Hp + 2, inside its row stride, hold the
// translation lanes), the layout in `optin` bytes
__host__ inline bool fits_f(int f, int h, int gp, bool equiv, int optin) {
  return round16(f) <= kMaxW && round16(h) <= kMaxW && gp + 1 <= kGW &&
         sizeof(float) * static_cast<size_t>(layout_f(f, h, equiv).total) <=
             static_cast<size_t>(optin);
}

template <bool EQUIV, int NT>
__global__ void __launch_bounds__(kThreadsF, 1)
fwd_tc_kernel(const Params p) {
  constexpr int HP = 8 * NT;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int f = p.f, h = p.h, gp = p.gp, geo_ld = 3 + p.gp;
  const int n_rows = p.n_rows;
  const Layout L = layout_f(f, h, EQUIV);
  const int fp = L.fp, ld = L.ld, ldw = L.ldw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float* wst = sm + L.wst;
  const float* w1s = sm + L.w1;
  const float* wc0s = sm + L.wc0;
  const float* b1s = sm + L.b1;
  const float* bc0s = sm + L.bc0;
  const float* wc1s = sm + L.wc1;
  float* xs = sm + L.warps + warp * L.per_warp;
  float* xr = xs + M * ld;
  float* mt = xr + M * ld;              // [m (H) | pad | tr (3)] rows
  float* gt = mt + M * ld;
  float* graw = gt + M * kLdG;
  int* s_ids = reinterpret_cast<int*>(graw + M * kLdRaw);

  stage_weights<EQUIV, HP, kThreadsF>(p, L, sm);
  // this warp's region zeroed: the slots' pad columns stay zero (the
  // gathers write columns < F, m columns < Hp, the translation Hp .. Hp + 2)
  for (int i = lane; i < L.per_warp; i += 32) xs[i] = 0.f;
  // this warp's share of the sender rows (rows plus edges balanced)
  int rb, re;
  passp::share_range(p.row_ptr, n_rows, blockIdx.x * kWarpsF + warp,
                     gridDim.x * kWarpsF, rb, re);
  __syncthreads();   // the only block barrier
  const int p_begin = __ldg(p.row_ptr + rb);
  const int p_end = __ldg(p.row_ptr + re);

  // the sums: lane holds the columns c0 = lane and c1 = lane + 32 of a row
  // [m (H) | pad | tr (3)] of the slot; each row's edges summed in position
  // order (a row goes on from one tile into the next), every row of the
  // share written once, rows without edges as zeros
  const int c0 = lane, c1 = lane + 32;
  auto used = [&](int c) {
    return c < h || (EQUIV && c >= HP && c < HP + 3);
  };
  const bool u0 = used(c0), u1 = used(c1);
  int row = -1, next = rb;
  float a0 = 0.f, a1 = 0.f;
  auto put1 = [&](int r, int c, float v) {
    if (c < h)
      p.out[static_cast<size_t>(r) * h + c] = v;
    else
      p.psum[static_cast<size_t>(r) * 3 + c - HP] = v;
  };
  auto put = [&](int r, float v0, float v1) {
    if (u0) put1(r, c0, v0);
    if (u1) put1(r, c1, v1);
  };

  // lanes 0..15: the tile's edge ids (through the sender permutation) and
  // their ends
  auto load_eid = [&](int q) {
    if (lane >= M || q + lane >= p_end) return -1;
    return p.perm != nullptr ? __ldg(p.perm + q + lane) : q + lane;
  };
  int eid = load_eid(p_begin);
  int snd = eid >= 0 ? __ldg(p.send + eid) : -1;
  int rcv = eid >= 0 ? __ldg(p.recv + eid) : -1;

  for (int q = p_begin; q < p_end; q += M) {
    const bool ok = eid >= 0 && snd >= rb && snd < re &&
                    static_cast<unsigned>(rcv) < static_cast<unsigned>(n_rows);
    if (lane < M) s_ids[lane] = ok ? snd : -1;
    const unsigned okm = __ballot_sync(kFull, ok);
    // the gathers: x[s], x[r] and the geometry, zeros off real edges
#pragma unroll 1
    for (int e = 0; e < M; ++e) {
      const bool ve = (okm >> e) & 1u;
      const int se = ve ? __shfl_sync(kFull, snd, e) : 0;
      const int rr = ve ? __shfl_sync(kFull, rcv, e) : 0;
      const int ee = ve ? __shfl_sync(kFull, eid, e) : 0;
      if ((f & 3) == 0) {
        cp_row<true>(xs + e * ld, p.x + static_cast<size_t>(se) * f, f, ve,
                     lane);
        cp_row<true>(xr + e * ld, p.x + static_cast<size_t>(rr) * f, f, ve,
                     lane);
      } else {
        cp_row<false>(xs + e * ld, p.x + static_cast<size_t>(se) * f, f, ve,
                      lane);
        cp_row<false>(xr + e * ld, p.x + static_cast<size_t>(rr) * f, f, ve,
                      lane);
      }
      if (lane < geo_ld)
        cp_async4(graw + e * kLdRaw + lane,
                  p.geo + static_cast<size_t>(ee) * geo_ld + lane, ve);
    }
    // the next tile's ids, in flight while this one is computed
    const int eid_next = load_eid(q + M);
    const int snd_next = eid_next >= 0 ? __ldg(p.send + eid_next) : -1;
    const int rcv_next = eid_next >= 0 ? __ldg(p.recv + eid_next) : -1;
    cp_async_wait_all();
    __syncwarp();
    // G': the geometry lanes, the ones column (real edges), zeros
    for (int i2 = lane; i2 < M * kGW; i2 += 32) {
      const int e = i2 >> 4, k = i2 & 15;
      gt[e * kLdG + k] = k < gp ? graw[e * kLdRaw + 3 + k]
                                : (k == gp && s_ids[e] >= 0 ? 1.f : 0.f);
    }
    __syncwarp();

    // ---- the chain: t0, a ----
    float cc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) cc[n][0] = cc[n][1] = cc[n][2] = cc[n][3] = 0.f;
    chain_smem<NT, false, true>(cc, xs, ld, fp / 8, wst, ldw);
    chain_smem<NT, false, true>(cc, xr, ld, fp / 8, wst + fp * ldw, ldw);
    chain_smem<NT, false, true>(cc, gt, kLdG, 2, wst + 2 * fp * ldw, ldw);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) cc[n][v] = fmaxf(cc[n][v], 0.f);
    // m = relu(a . W1 + b1)
    float mm[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 bb = *reinterpret_cast<const float2*>(b1s + 8 * n + 2 * t);
      mm[n][0] = bb.x; mm[n][1] = bb.y; mm[n][2] = bb.x; mm[n][3] = bb.y;
    }
    chain_regs<NT, NT, false, true>(mm, cc, w1s, ldw);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) mm[n][v] = fmaxf(mm[n][v], 0.f);
    store_c<NT>(mt, ld, mm);
    if (EQUIV) {
      // v = relu(m . Wc0 + bc0); c = tanh(v . wc1)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 bb =
            *reinterpret_cast<const float2*>(bc0s + 8 * n + 2 * t);
        cc[n][0] = bb.x; cc[n][1] = bb.y; cc[n][2] = bb.x; cc[n][3] = bb.y;
      }
      chain_regs<NT, NT, false, true>(cc, mm, wc0s, ldw);
      float p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 wc = *reinterpret_cast<const float2*>(wc1s + 8 * n + 2 * t);
        p0 += fmaxf(cc[n][0], 0.f) * wc.x + fmaxf(cc[n][1], 0.f) * wc.y;
        p1 += fmaxf(cc[n][2], 0.f) * wc.x + fmaxf(cc[n][3], 0.f) * wc.y;
      }
      p0 += __shfl_xor_sync(kFull, p0, 1);
      p1 += __shfl_xor_sync(kFull, p1, 1);
      p0 += __shfl_xor_sync(kFull, p0, 2);
      p1 += __shfl_xor_sync(kFull, p1, 2);
      // tr = clip(diff . c), lane t < 3 its lane t of rows g and g + 8
      if (t < 3) {
        const float c0v = tanhf(p0), c1v = tanhf(p1);
        mt[g * ld + HP + t] =
            fminf(fmaxf(graw[g * kLdRaw + t] * c0v, -100.f), 100.f);
        mt[(g + 8) * ld + HP + t] =
            fminf(fmaxf(graw[(g + 8) * kLdRaw + t] * c1v, -100.f), 100.f);
      }
    }
    __syncwarp();
    // the tile's edges into their rows, in position order
#pragma unroll 1
    for (int e = 0; e < M; ++e) {
      const int r = s_ids[e];
      if (r < 0) continue;
      if (r != row) {
        if (row >= 0) {
          put(row, a0, a1);
          next = row + 1;
        }
        for (int z = next; z < r; ++z) put(z, 0.f, 0.f);
        row = r;
        a0 = a1 = 0.f;
      }
      if (u0) a0 += mt[e * ld + c0];
      if (u1) a1 += mt[e * ld + c1];
    }
    __syncwarp();   // the slots are gathered into next
    eid = eid_next;
    snd = snd_next;
    rcv = rcv_next;
  }
  if (row >= 0) {
    put(row, a0, a1);
    next = row + 1;
  }
  for (int z = next; z < re; ++z) put(z, 0.f, 0.f);
}

}  // namespace tc

__global__ void egcl_reduce_partials_kernel(const float* __restrict__ partial,
                                            float* __restrict__ out,
                                            int n_parts, int size) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= size) return;
  float v = 0.f;
  for (int b = 0; b < n_parts; ++b)
    v += partial[static_cast<size_t>(b) * size + j];
  out[j] = v;
}

template <int MODE, bool EQUIV>
int launch(Params p, int grid, cudaStream_t st) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int off[9];
  const size_t tiles = sizeof(float) *
                       static_cast<size_t>(tile_floats(MODE, EQUIV, p.f, p.h,
                                                       p.gp));
  const size_t wts = sizeof(float) *
                     static_cast<size_t>(weight_layout(p.f, p.h, p.gp, p.h | 1,
                                                       EQUIV, off));
  const size_t staged = tiles + wts * (MODE == kPassP ? 2 : 1);
  p.stage = staged <= static_cast<size_t>(optin) ? 1 : 0;
  const size_t smem = p.stage ? staged : tiles;
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(egcl_kernel<MODE, EQUIV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  egcl_kernel<MODE, EQUIV><<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool EQUIV, int NT>
int launch_tc(const Params& p, int grid, cudaStream_t st) {
  const size_t smem = sizeof(float) *
      static_cast<size_t>(tc::layout(p.f, p.h, EQUIV).total + 4);
  const cudaError_t err = cudaFuncSetAttribute(
      tc::pass_p_tc_kernel<EQUIV, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  tc::pass_p_tc_kernel<EQUIV, NT><<<grid, tc::kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the device's opt-in shared memory per block in bytes, 0 when it cannot be
// asked
int optin_bytes() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return optin;
}

// the routes at these widths on the current device: 1 (route 1, the
// tensor-core kernel: F, H <= 48, gp <= 15, its layout in a block's shared
// memory), 2 (the first design), 0 when the device cannot be asked.  Pass
// P's; pass S's (in receiver order) and the forward's (in sender order),
// each warp on its own share of the rows
int pass_p_route(int f, int h, int gp, bool equiv) {
  const int optin = optin_bytes();
  return optin == 0 ? 0 : tc::fits(f, h, gp, equiv, optin) ? 1 : 2;
}

int pass_s_route(int f, int h, int gp, bool equiv) {
  const int optin = optin_bytes();
  return optin == 0 ? 0 : tc::fits_s(f, h, gp, equiv, optin) ? 1 : 2;
}

int fwd_route(int f, int h, int gp, bool equiv) {
  const int optin = optin_bytes();
  return optin == 0 ? 0 : tc::fits_f(f, h, gp, equiv, optin) ? 1 : 2;
}

// route 1 of the forward or pass S: one block a SM, each warp on its own
// share of the rows
template <int MODE, bool EQUIV, int NT>
int launch_tc_rows(const Params& p, cudaStream_t st) {
  constexpr bool kF = MODE == kFwd;
  const auto kernel = kF ? tc::fwd_tc_kernel<EQUIV, NT>
                         : tc::pass_s_tc_kernel<EQUIV, NT>;
  const int threads = kF ? tc::kThreadsF : tc::kThreadsS;
  const tc::Layout L = kF ? tc::layout_f(p.f, p.h, EQUIV)
                          : tc::layout_s(p.f, p.h, EQUIV);
  const size_t smem = sizeof(float) * static_cast<size_t>(L.total);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<sms, threads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the forward or pass S on `route` (0: the widths' own); route 1 where the
// widths do not take it is refused
template <int MODE, bool EQUIV>
int launch_rows(const Params& p, int route, int grid, cudaStream_t st) {
  const int own = MODE == kFwd ? fwd_route(p.f, p.h, p.gp, EQUIV)
                               : pass_s_route(p.f, p.h, p.gp, EQUIV);
  if (own == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (route == 0) route = own;
  if (route == 1 && own != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (route == 2) return launch<MODE, EQUIV>(p, grid, st);
  switch (tc::round16(p.h)) {
    case 16: return launch_tc_rows<MODE, EQUIV, 2>(p, st);
    case 32: return launch_tc_rows<MODE, EQUIV, 4>(p, st);
    case 48: return launch_tc_rows<MODE, EQUIV, 6>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool EQUIV>
int launch_pass_p(const Params& p, int grid, cudaStream_t st) {
  const int route = pass_p_route(p.f, p.h, p.gp, EQUIV);
  if (route == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (route == 2) return launch<kPassP, EQUIV>(p, grid, st);
  switch (tc::round16(p.h)) {
    case 16: return launch_tc<EQUIV, 2>(p, grid, st);
    case 32: return launch_tc<EQUIV, 4>(p, grid, st);
    case 48: return launch_tc<EQUIV, 6>(p, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The size in floats of one weight-gradient partial (and of `wgrad`):
// [dW0s F*H | dW0r F*H | dW0g gp*H | db0 H | dW1 H*H | db1 H | dWc0 H*H |
//  dbc0 H | dwc1 H], the last three only when equivariant, padded to a
// multiple of 4.
extern "C" int hg_egcl_wgrad_size(int f, int h, int gp, int equivariant) {
  int off[9];
  return weight_layout(f, h, gp, h, equivariant != 0, off);
}

// Pass P's route at these widths (pass_p_route): 1, 2, or 0 when the
// device cannot be asked.
extern "C" int hg_egcl_pass_p_route(int f, int h, int gp, int equivariant) {
  return pass_p_route(f, h, gp, equivariant != 0);
}

// Pass S's route at these widths (pass_s_route): 1, 2, or 0 when the
// device cannot be asked.
extern "C" int hg_egcl_pass_s_route(int f, int h, int gp, int equivariant) {
  return pass_s_route(f, h, gp, equivariant != 0);
}

// The forward's route at these widths (fwd_route): 1, 2, or 0 when the
// device cannot be asked.
extern "C" int hg_egcl_fwd_route(int f, int h, int gp, int equivariant) {
  return fwd_route(f, h, gp, equivariant != 0);
}

// One EGCL launch; returns the cudaError_t (0 = success).  mode 0: the
// forward (out = agg [N,H], psum [N,3] when equivariant; rows are senders,
// `perm` the sender permutation); mode 1: pass P (out = dx [N,F] or null,
// `partial` scratch [n_parts, wgrad size], `wgrad` the reduced weight
// gradients, `dgeo` [E,3+gp] zero-filled or null; same order as the
// forward); mode 2: pass S (out = dx [N,F]; rows are receivers, `perm`
// null).  `route` (the forward and pass S): 0 takes the widths' own
// (hg_egcl_fwd_route, hg_egcl_pass_s_route), 1 or 2 that one where the
// widths admit it; pass P takes route 0.  Pointers are device pointers; launches go on `stream` and do
// not synchronise.
extern "C" int hg_egcl_f32(
    int mode, int equivariant, const void* x, const void* geo,
    const void* send, const void* recv, const void* perm, const void* row_ptr,
    const void* w0s, const void* w0r, const void* w0g, const void* b0,
    const void* w1, const void* b1, const void* wc0, const void* bc0,
    const void* wc1, const void* gagg, const void* gpsum, void* out,
    void* psum, void* partial, void* wgrad, void* dgeo, int n_rows, int f,
    int h, int gp, int n_parts, int route, void* stream) {
  if (n_rows <= 0 || h <= 0) return 0;
  if (f < 1 || f > kMaxF || h > kMaxH || gp < 1 || gp > kMaxGp ||
      mode < kFwd || mode > kPassS || (mode == kPassP && n_parts < 1) ||
      route < 0 || route > 2 || (mode == kPassP && route != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool equiv = equivariant != 0;
  Params p{};
  p.x = static_cast<const float*>(x);
  p.geo = static_cast<const float*>(geo);
  p.send = static_cast<const int*>(send);
  p.recv = static_cast<const int*>(recv);
  p.perm = static_cast<const int*>(perm);
  p.row_ptr = static_cast<const int*>(row_ptr);
  const void* ws[9] = {w0s, w0r, w0g, b0, w1, b1, wc0, bc0, wc1};
  for (int i = 0; i < 9; ++i) p.w[i] = static_cast<const float*>(ws[i]);
  p.gagg = static_cast<const float*>(gagg);
  p.gpsum = static_cast<const float*>(gpsum);
  p.out = static_cast<float*>(out);
  p.psum = static_cast<float*>(psum);
  p.partial = static_cast<float*>(partial);
  p.dgeo = static_cast<float*>(dgeo);
  p.n_rows = n_rows;
  p.f = f;
  p.h = h;
  p.gp = gp;
  p.n_chunks = (n_rows + kRows - 1) / kRows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kFwd)
    return equiv ? launch_rows<kFwd, true>(p, route, p.n_chunks, st)
                 : launch_rows<kFwd, false>(p, route, p.n_chunks, st);
  if (mode == kPassS)
    return equiv ? launch_rows<kPassS, true>(p, route, p.n_chunks, st)
                 : launch_rows<kPassS, false>(p, route, p.n_chunks, st);
  const int grid = n_parts < p.n_chunks ? n_parts : p.n_chunks;
  const int rc = equiv ? launch_pass_p<true>(p, grid, st)
                       : launch_pass_p<false>(p, grid, st);
  if (rc != 0) return rc;
  const int size = hg_egcl_wgrad_size(f, h, gp, equivariant);
  egcl_reduce_partials_kernel<<<(size + 255) / 256, 256, 0, st>>>(
      p.partial, static_cast<float*>(wgrad), grid, size);
  return static_cast<int>(cudaGetLastError());
}
