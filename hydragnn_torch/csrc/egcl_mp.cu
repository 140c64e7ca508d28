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
// egcl_kernel<kFwd>   — the forward.  Replaces
//   hydragnn_tpu/ops/fused_block.py:_fused_fwd with the egcl spec
//   (pl.pallas_call at :495).  Sender order: each block owns kRows sender
//   rows and walks their CSR range of edge positions (mapped to edge ids
//   through edge_perm_sender) TE edges at a time; it recomputes the chain
//   per edge tile in shared memory and adds m (and the three translation
//   lanes) into the block's rows in edge order.  No [E,H] tensor reaches
//   device memory, no atomics.
// egcl_kernel<kPassP> (+ egcl_reduce_partials_kernel) — backward pass P.
//   Replaces :_fused_bwd pass P (pl.pallas_call at :561).  Sender order
//   again: recompute the chain, take the cotangents dagg[s], dpsum[s],
//   backpropagate through the coordinate gate (tanh, relu, the clip, whose
//   mask is 1 because |diff_normed| < 1) and the two-layer edge MLP, and
//   write dx_sender (summed per row), the per-edge dgeo stream and the
//   weight gradients.  The weight gradients are sums over all edges: each
//   of n_parts blocks keeps its own float32 partial in shared memory over
//   all of its rows and writes it once; the reduce kernel sums the
//   partials in block order.
// egcl_kernel<kPassS> — backward pass S.  Replaces :_fused_bwd pass S
//   (pl.pallas_call at :599).  Receiver order (edge ids are positions):
//   recompute the chain and its backward up to dt0 with the cotangents
//   gathered at the sender, and sum dx_receiver = dt0 . W0r^T per row.
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
// is correct and slow.  Not yet: tensor cores, register micro-tiles.
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

template <int MODE>
int launch_mode(const Params& p, bool equiv, int grid, cudaStream_t st) {
  return equiv ? launch<MODE, true>(p, grid, st)
               : launch<MODE, false>(p, grid, st);
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

// One EGCL launch; returns the cudaError_t (0 = success).  mode 0: the
// forward (out = agg [N,H], psum [N,3] when equivariant; rows are senders,
// `perm` the sender permutation); mode 1: pass P (out = dx [N,F] or null,
// `partial` scratch [n_parts, wgrad size], `wgrad` the reduced weight
// gradients, `dgeo` [E,3+gp] zero-filled or null; same order as the
// forward); mode 2: pass S (out = dx [N,F]; rows are receivers, `perm`
// null).  Pointers are device pointers; launches go on `stream` and do not
// synchronise.
extern "C" int hg_egcl_f32(
    int mode, int equivariant, const void* x, const void* geo,
    const void* send, const void* recv, const void* perm, const void* row_ptr,
    const void* w0s, const void* w0r, const void* w0g, const void* b0,
    const void* w1, const void* b1, const void* wc0, const void* bc0,
    const void* wc1, const void* gagg, const void* gpsum, void* out,
    void* psum, void* partial, void* wgrad, void* dgeo, int n_rows, int f,
    int h, int gp, int n_parts, void* stream) {
  if (n_rows <= 0 || h <= 0) return 0;
  if (f < 1 || f > kMaxF || h > kMaxH || gp < 1 || gp > kMaxGp ||
      mode < kFwd || mode > kPassS || (mode == kPassP && n_parts < 1))
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
  if (mode == kFwd) return launch_mode<kFwd>(p, equiv, p.n_chunks, st);
  if (mode == kPassS) return launch_mode<kPassS>(p, equiv, p.n_chunks, st);
  const int grid = n_parts < p.n_chunks ? n_parts : p.n_chunks;
  const int rc = launch_mode<kPassP>(p, equiv, grid, st);
  if (rc != 0) return rc;
  const int size = hg_egcl_wgrad_size(f, h, gp, equivariant);
  egcl_reduce_partials_kernel<<<(size + 255) / 256, 256, 0, st>>>(
      p.partial, static_cast<float*>(wgrad), grid, size);
  return static_cast<int>(cudaGetLastError());
}
