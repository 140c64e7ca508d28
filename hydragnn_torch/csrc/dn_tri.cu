// Hand-written Hopper (sm_90a) kernels for DimeNet++'s factored-basis
// triplet interaction
//
//   sbf_t   = radial[kj(t)] * expand(cbf[t])     [S*R]  (slot l*R + r: l)
//   emb_t   = (sbf_t @ W1) @ W2                  [D]
//   out[e]  = sum_{t: ji(t) = e} x2[kj(t)] * emb_t
//
// radial [E, S*R], x2 [E, D], cbf [T, S], W1 [S*R, B], W2 [B, D], all
// float32 row-major; S <= 8, S*R <= 64, B <= 64, D <= 64.  Plain C
// interface, loaded with ctypes by hydragnn_torch/kernels/build.py; the
// wrappers, plain PyTorch versions and launch counters live in
// hydragnn_torch/ops/dn_tri.py.
//
// The forward replaces hydragnn_tpu/ops/dn_tri.py:_tri_fwd (pl.pallas_call
//   at :285).  Rows are output edges e; the triplets are sorted by idx_ji
//   (the builder's order), so each row owns one CSR range.  Two routes by
//   width (hg_dn_tri_fwd_route):
// fwd_tc_kernel<kFwd, FactoredRows> — route 1, B <= 8 and D a multiple of
//   8 (the arch sweep's S = 7, R = 6, B = 8, D = 64): the builder
//   forward's route-1 kernel (csrc/tri_tc.cuh: each warp on its own share
//   of the rows, 16-triplet tiles through a two-stage cp.async ring, both
//   products on the tensor cores in 3xTF32 with a permuted k index,
//   x2[kj] * emb2 formed in place and summed into the warp's rows in
//   triplet order) with the A operand formed as it is loaded: the stage
//   holds each taken triplet's radial[kj] row (8-byte cp.async, 168 B at
//   S*R = 42) and the tile's cbf rows, one contiguous block in ji order,
//   and a fragment's sbf[t, c] = radial[kj, c] * cbf[t, c / R].  No sbf
//   row reaches device memory.
// dn_tri_fwd_kernel — route 2, every other width (the first design): each
//   block owns kRows rows and walks their triplets TT at a time: gathers
//   radial[kj] and cbf into a transposed sbf tile and x2[kj] into another,
//   recomputes emb1 = sbf.W1 and emb2 = emb1.W2 in shared memory, and adds
//   x2[kj] * emb2 into its rows in triplet order.
// dn_tri_bwd_kernel (+ passp::reduce_partials_kernel) — the backward.
//   Replaces :_tri_vjp_bwd (pl.pallas_call at :358).  One pass in kj order
//   (through perm_kj): rows are the gathered edges k, and every triplet of
//   row k shares radial[k] and x2[k], so with g_t = dout[ji(t)] the
//   backward factors onto the rows (sbf_t[l*R + r] = radial[k, l*R + r] *
//   cbf[t, l]):
//     P[k, l]  = sum_r radial[k, l*R + r] W1[l*R + r]     [S, B]
//     Q[k, l]  = P[k, l] . W2                             [S, D]
//     G[k, l]  = sum_{t in row k} cbf[t, l] g_t           [S, D]
//     d_x2[k]  = sum_l Q[k, l] * G[k, l]
//     U[k, l]  = x2[k] * G[k, l];   Hk[k, l] = U[k, l] . W2^T   [S, B]
//     dW2     += sum_l P[k, l]^T U[k, l]
//     dW1[l*R + r] += radial[k, l*R + r] Hk[k, l]
//     d_radial[k, l*R + r] = Hk[k, l] . W1[l*R + r]
//     d_cbf[t, l] = g_t . (x2[k] * Q[k, l])
//   G is the only per-triplet work of the path (S*D multiply-adds a
//   triplet, d_cbf as many again); the rest is per row.  Each block owns
//   chunks of NR rows (16 at S = 7, R = 6, B = 8, D = 64; fewer where the
//   chunk's tiles would not fit): the chunk's P and Q first (d_cbf reads
//   x2 * Q), then G kBatch triplets at a time: all threads load the
//   batch's ids and cbf rows, then gather its cotangent rows into shared
//   memory (every load in flight at once), then each (row, column) adds
//   its own triplets in triplet order; then d_x2, U, Hk, dW2, dW1 and
//   d_radial over the chunk.  Every phase over D columns gives a thread
//   one column c (tid mod 64) and a quarter of the rows, Q reads W2's
//   column c from registers; B pads to the kernel's instantiation (8, 16,
//   32, 64) with zero weights so the loops over it unroll.  dW1 and dW2
//   stay in shared memory over the block's whole share (one block per
//   chunk slot of the card) and are written once as its partial; the
//   partials are summed in block order, compensated.  A chunk without a
//   triplet writes zeros and does no product.  d_cbf goes straight to the
//   triplet's own slot, which one row visits once.
//
// Bound on the H100 SXM: bytes in the forward (per real triplet ~2(SR*B +
// B*D) flops against the ids, cbf and gathered rows it reads; route 1 is
// latency-bound at 8 warps a SM, as the builder's forward is); the
// backward's factored work (2*S*D flops a triplet, ~24 kFLOP a row at the
// path's widths) is ~1.8 GFLOP against ~40 MB, at the border of the two
// bounds, and in practice bound by the latency of the cotangent gathers.
// Forward design, route 2: no [T, D] or [T, S*R] tensor reaches
// device memory (every per-triplet quantity lives in a shared-memory tile
// of TT triplets); tiles are transposed ([k][t], row stride TT+4) so one
// 16-byte load feeds four multiply-adds; each thread computes EQ triplets
// of one output column; W1 and W2 are staged once per block with odd row
// strides (B | 1, D | 1).  The backward's per-row products run on the CUDA
// cores: at B = 8 they are ~1.4 GFLOP a launch (0.02 ms at the CUDA-core
// peak), beside the gathers' latency.
//
// Contract (add_dimenet_extras guarantees it): idx_ji is nondecreasing;
// masked triplets sort last in both orders and are parked out of every
// range by the wrapper, so they are never read and get exactly zero in
// every output and gradient (the wrapper zero-fills d_cbf).  Ids outside
// [0, E) contribute nothing.  Determinism: every sum runs in a fixed order
// (triplet order within a row; row, then chunk, then block order for dW1,
// dW2); no atomics.  Every output row is written, rows without triplets as
// zeros.

#include <cuda_runtime.h>

#include "pass_p.cuh"
#include "tri_tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int TT = 32;            // triplets per tile
constexpr int EQ = 8;             // triplets per work item
constexpr int kGroups = TT / EQ;
constexpr int LDT = TT + 4;       // row stride of a transposed tile
constexpr int kRows = 16;         // output rows per chunk
constexpr int kMaxS = 8;
constexpr int kMaxSR = 64;
constexpr int kMaxB = 64;
constexpr int kMaxD = 64;

constexpr int kFwd = 0;
constexpr int kBwd = 1;

struct Params {
  const float* radial;   // [E, SR]
  const float* x2;       // [E, D]
  const float* cbf;      // [T, S]
  const float* w1;       // [SR, B]
  const float* w2;       // [B, D]
  const int* kj;         // [T]
  const int* ji;         // [T]
  const int* perm;       // [T] position -> triplet, or null (identity)
  const int* row_ptr;    // [E + 1] CSR over positions
  const float* gout;     // [E, D] cotangent of out (backward)
  float* out;            // forward: [E, D]
  float* d_radial;       // backward: [E, SR] or null
  float* d_x2;           // backward: [E, D] or null
  float* d_cbf;          // backward: [T, S] zero-filled, or null
  float* partial;        // backward: [gridDim.x, wgrad size] or null
  int n_rows, s, r, sr, b, d, n_chunks;
  int rows;              // backward: rows per chunk
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// the forward's shared-memory floats at these widths
__host__ __device__ inline int fwd_smem_floats(int sr, int b, int d) {
  int n = round4(sr * (b | 1)) + round4(b * (d | 1));   // W1, W2
  n += (sr + b + 2 * d) * LDT;                          // sbf, emb1, x2, emb2
  n += kRows * d;                                       // out rows
  n += 4 * TT;                                          // ids
  return n;
}

// acc[j] += sum_k T[k][e0 + j] * w[k * stride] over k < K
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

// out tile [n_out][LDT] = T [K][LDT] . W (W[k][c] at w[k * ld + c])
__device__ __forceinline__ void product(float* out, int n_out, const float* T,
                                        int K, const float* w, int ld) {
  for (int it = threadIdx.x; it < n_out * kGroups; it += kThreads) {
    const int c = it % n_out, e0 = (it / n_out) * EQ;
    float acc[EQ] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    mv(acc, T, K, w + c, ld, e0);
    store8(out + c * LDT + e0, acc);
  }
}

__global__ void __launch_bounds__(kThreads) dn_tri_fwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int s = p.s, r = p.r, sr = p.sr, b = p.b, d = p.d;
  const int ld1 = b | 1, ld2 = d | 1;
  const int tid = threadIdx.x;

  float* w1s = sm; sm += round4(sr * ld1);
  float* w2s = sm; sm += round4(b * ld2);
  float* sbf_t = sm; sm += sr * LDT;     // sbf
  float* e1_t = sm; sm += b * LDT;       // emb1
  float* x_t = sm; sm += d * LDT;        // x2[kj]
  float* e2_t = sm; sm += d * LDT;       // the message
  float* rows_x = sm; sm += kRows * d;   // out rows
  int* t_s = reinterpret_cast<int*>(sm);
  int* k_s = t_s + TT;
  int* j_s = k_s + TT;
  int* row_s = j_s + TT;

  for (int i = tid; i < sr * b; i += kThreads)
    w1s[(i / b) * ld1 + i % b] = p.w1[i];
  for (int i = tid; i < b * d; i += kThreads)
    w2s[(i / d) * ld2 + i % d] = p.w2[i];

  for (int chunk = blockIdx.x; chunk < p.n_chunks; chunk += gridDim.x) {
    const int r0 = chunk * kRows;
    const int r1 = min(r0 + kRows, p.n_rows);
    const int p_begin = p.row_ptr[r0];
    const int p_end = p.row_ptr[r1];
    __syncthreads();  // staging done; the previous chunk's rows written out
    for (int i = tid; i < kRows * d; i += kThreads) rows_x[i] = 0.f;

    for (int q = p_begin; q < p_end; q += TT) {
      const int cnt = min(TT, p_end - q);
      __syncthreads();  // rows zeroed; the previous tile's readers are done
      if (tid < TT) {
        int t = -1, k = -1, j = -1, row = 0;
        if (tid < cnt) {
          const int pos = q + tid;
          t = p.perm != nullptr ? p.perm[pos] : pos;
          k = p.kj[t];
          j = p.ji[t];
          if (static_cast<unsigned>(k) >= static_cast<unsigned>(p.n_rows) ||
              static_cast<unsigned>(j) >= static_cast<unsigned>(p.n_rows) ||
              j < r0 || j >= r1) {
            k = -1;
          } else {
            row = j - r0;
          }
        }
        t_s[tid] = t;
        k_s[tid] = k;
        j_s[tid] = j;
        row_s[tid] = row;
      }
      __syncthreads();
      // gathers, transposed; invalid and out-of-tile triplets read zeros
      for (int i = tid; i < TT * sr; i += kThreads) {
        const int e = i / sr, c = i - e * sr;
        const int k = k_s[e];
        float rad = 0.f, cb = 0.f;
        if (k >= 0) {
          rad = p.radial[static_cast<size_t>(k) * sr + c];
          cb = p.cbf[static_cast<size_t>(t_s[e]) * s + c / r];
        }
        sbf_t[c * LDT + e] = rad * cb;
      }
      for (int i = tid; i < TT * d; i += kThreads) {
        const int e = i / d, c = i - e * d;
        const int k = k_s[e];
        x_t[c * LDT + e] = k >= 0 ? p.x2[static_cast<size_t>(k) * d + c] : 0.f;
      }
      __syncthreads();
      product(e1_t, b, sbf_t, sr, w1s, ld1);        // emb1 = sbf . W1
      __syncthreads();
      product(e2_t, d, e1_t, b, w2s, ld2);          // emb2 = emb1 . W2
      __syncthreads();
      // rows += x2[kj] * emb2 in triplet order
      for (int c = tid; c < d; c += kThreads) {
        for (int e = 0; e < cnt; ++e)
          if (k_s[e] >= 0)
            rows_x[row_s[e] * d + c] += x_t[c * LDT + e] * e2_t[c * LDT + e];
      }
    }
    __syncthreads();
    for (int i = tid; i < (r1 - r0) * d; i += kThreads)
      p.out[static_cast<size_t>(r0) * d + i] = rows_x[i];
  }
}

// ---------------------------------------------------------------------------
// the forward, route 1: tri_tc.cuh's kernel with the factored A operand
// ---------------------------------------------------------------------------

// The loader of tritc::fwd_tc_kernel for the factored basis: a stage holds
// each taken triplet's radial[kj] row [16][frag_ld(round8(SR))] (8-byte
// cp.async at an even SR, 4-byte at an odd one; zero columns past SR) and
// the tile's cbf rows [16][S], one contiguous block in ji order (8-byte
// pieces at an even S, 4-byte at an odd one).  Step q's A fragment is
// sbf[t, c] = radial[kj(t), c] * cbf[t, c / R] at the permuted columns c =
// 8q + 2t and 8q + 2t + 1, formed as it is loaded (c / R clamped to S - 1:
// past SR the radial columns are zero).
struct FactoredRows {
  const float* radial;   // [E, SR]
  const float* cbf;      // [T, S]
  int s, r, lds;
  int l0[tritc::kMaxSR / 8], l1[tritc::kMaxSR / 8];  // this lane's c / R

  __host__ __device__ static int floats(int sr) {
    return tritc::kM * (passp::frag_ld(tritc::round8(sr)) + kMaxS);
  }
  __device__ void init(int sr, int lane) {
    lds = passp::frag_ld(tritc::round8(sr));
    const int t = lane & 3;
#pragma unroll
    for (int q = 0; q < tritc::kMaxSR / 8; ++q) {
      l0[q] = min((8 * q + 2 * t) / r, s - 1);
      l1[q] = min((8 * q + 2 * t + 1) / r, s - 1);
    }
  }
  __device__ void zero(float* st, int sr, int lane) const {
    const int pad = tritc::round8(sr) - sr;
    for (int i = lane; i < tritc::kM * pad; i += 32)
      st[(i / pad) * lds + sr + i % pad] = 0.f;
  }
  __device__ void row(float* st, int sr, int, int e, int, int k, bool take,
                      int lane) const {
    if (take)
      tritc::copy_row(st + e * lds, radial + static_cast<size_t>(k) * sr,
                      sr, lane);
  }
  __device__ void tile(float* st, int q, int cnt, int lane) const {
    float* cb = st + tritc::kM * lds;
    const float* src = cbf + static_cast<size_t>(q) * s;
    if ((s & 1) == 0) {
      for (int i = 2 * lane; i < cnt * s; i += 64)
        tritc::cp_async8(cb + i, src + i);
    } else {
      for (int i = lane; i < cnt * s; i += 32) tritc::cp_async4(cb + i, src + i);
    }
  }
  __device__ void frag(passp::FragA& a, const float* st, int q, int g,
                       int t) const {
    const float2 u0 =
        *reinterpret_cast<const float2*>(st + g * lds + 8 * q + 2 * t);
    const float2 u1 =
        *reinterpret_cast<const float2*>(st + (g + 8) * lds + 8 * q + 2 * t);
    const float* c0 = st + tritc::kM * lds + g * s;
    const float* c1 = c0 + 8 * s;
    passp::set_a<true>(a, u0.x * c0[l0[q]], u1.x * c1[l0[q]],
                       u0.y * c0[l1[q]], u1.y * c1[l1[q]]);
  }
};

// the forward's route: 1 (fwd_tc_kernel<kFwd, FactoredRows>) at B <= 8 and
// D a multiple of 8 when a block's shared memory (optin bytes) holds it,
// 2 (dn_tri_fwd_kernel) otherwise
inline int fwd_route(int sr, int b, int d, int optin) {
  return tritc::route<FactoredRows>(sr, b, d, optin);
}

// ---------------------------------------------------------------------------
// the backward, factored onto the kj rows
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;
constexpr int kBwdMaxRows = 16;   // rows per chunk at most
constexpr int kBatch = 96;        // triplets gathered at a time
constexpr int kCols = 64;         // column lanes: c = tid mod 64 (D <= 64)
constexpr int kColGroups = kBwdThreads / kCols;

// the backward's shared memory at chunk height nr and B padded to bt, in
// floats (each offset a multiple of 4): W1 [SR x bt|1], W2^T [D x bt], the
// chunk's radial [nr x SR] and x2 [nr x D] rows, P [nr S x bt], Q and G
// then U [nr S x ldq], Hk [nr S x bt], the block's dW1 [SR x B] and dW2 [B
// x D], a batch of gathered cotangent rows [kBatch x ldq], their cbf rows
// [kBatch x 8] and ids, the chunk's row_ptr; ldq = D rounded to 4, + 4
// (16-byte rows; rows of different (row, l) pairs start 4 banks apart)
struct BwdLayout {
  int ld1, ldq, w1, w2t, rad, xs, pm, qm, um, hk, gw1, gw2, xg, cb, ids,
      ptr, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int s, int sr, int bt, int d,
                                                int nr, int b) {
  BwdLayout l{};
  l.ld1 = bt | 1;
  l.ldq = round4(d) + 4;
  const int ns = nr * s;
  int o = 0;
  l.w1 = o; o += round4(sr * l.ld1);
  l.w2t = o; o += round4(d * bt);
  l.rad = o; o += round4(nr * sr);
  l.xs = o; o += round4(nr * d);
  l.pm = o; o += round4(ns * bt);
  l.qm = o; o += round4(ns * l.ldq);
  l.um = o; o += round4(ns * l.ldq);
  l.hk = o; o += round4(ns * bt);
  l.gw1 = o; o += round4(sr * b);
  l.gw2 = o; o += round4(b * d);
  l.xg = o; o += round4(kBatch * l.ldq);
  l.cb = o; o += kBatch * kMaxS;
  l.ids = o; o += 3 * kBatch;
  l.ptr = o; o += round4(kBwdMaxRows + 1);
  l.total = o;
  return l;
}

// B padded to the kernel's instantiation: 8, 16, 32 or 64
inline int bwd_bt(int b) {
  return b <= 8 ? 8 : b <= 16 ? 16 : b <= 32 ? 32 : 64;
}

// rows per chunk: the largest of 16, 8, 4, 2, 1 whose layout fits `optin`
// bytes, or 0
inline int bwd_chunk_rows(int s, int sr, int b, int d, int optin) {
  for (int nr = kBwdMaxRows; nr >= 1; nr /= 2)
    if (sizeof(float) * static_cast<size_t>(
            bwd_layout(s, sr, bwd_bt(b), d, nr, b).total)
        <= static_cast<size_t>(optin))
      return nr;
  return 0;
}

// dst (shared) = src (global), or zero, asynchronously (cp.async: every
// copy of a phase in flight at once, no register held until it lands)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// One block per chunk slot of the card; BT: B padded (zero weights).  Each
// thread owns column c = tid mod 64 of the D-wide phases (idle past D).
template <int BT>
__global__ void __launch_bounds__(kBwdThreads)
dn_tri_bwd_kernel(const Params p) {
  constexpr int NT = kBwdThreads;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int s = p.s, r = p.r, sr = p.sr, b = p.b, d = p.d, nr = p.rows;
  const BwdLayout ly = bwd_layout(s, sr, BT, d, nr, b);
  const int ld1 = ly.ld1, ldq = ly.ldq, ns = nr * s;
  float* w1s = sm + ly.w1;
  float* w2t = sm + ly.w2t;
  float* rad = sm + ly.rad;
  float* xs = sm + ly.xs;
  float* pm = sm + ly.pm;
  float* qm = sm + ly.qm;
  float* um = sm + ly.um;
  float* hk = sm + ly.hk;
  float* gw1 = sm + ly.gw1;
  float* gw2 = sm + ly.gw2;
  float* xg = sm + ly.xg;
  float* cbs = sm + ly.cb;
  int* rows_s = reinterpret_cast<int*>(sm + ly.ids);
  int* j_s = rows_s + kBatch;
  int* t_s = j_s + kBatch;
  int* ptr_s = reinterpret_cast<int*>(sm + ly.ptr);
  const int tid = threadIdx.x, c = tid & (kCols - 1), cg = tid / kCols;
  const bool col = c < d;
  const bool wgrad = p.partial != nullptr;
  const bool need_q = p.d_x2 != nullptr || p.d_cbf != nullptr;
  const bool need_hk = wgrad || p.d_radial != nullptr;

  for (int i = tid; i < sr * ld1; i += NT) {
    const int row = i / ld1, bb = i - row * ld1;
    w1s[i] = bb < b ? p.w1[row * b + bb] : 0.f;
  }
  for (int i = tid; i < d * BT; i += NT) {
    const int cc = i / BT, bb = i - cc * BT;
    w2t[i] = bb < b ? p.w2[bb * d + cc] : 0.f;
  }
  for (int i = tid; i < sr * b; i += NT) gw1[i] = 0.f;
  for (int i = tid; i < b * d; i += NT) gw2[i] = 0.f;
  __syncthreads();
  // this thread's column of W2, for Q
  float w2c[BT];
#pragma unroll
  for (int bb = 0; bb < BT; ++bb) w2c[bb] = col ? w2t[c * BT + bb] : 0.f;

  for (int chunk = blockIdx.x; chunk < p.n_chunks; chunk += gridDim.x) {
    const int r0 = chunk * nr, r1 = min(r0 + nr, p.n_rows), nrc = r1 - r0;
    const int p_begin = p.row_ptr[r0], p_end = p.row_ptr[r1];
    __syncthreads();  // the previous chunk's readers are done
    if (p_begin == p_end) {
      // no triplet in the chunk: zero rows, no product
      if (p.d_x2 != nullptr)
        for (int i = tid; i < nrc * d; i += NT)
          p.d_x2[static_cast<size_t>(r0) * d + i] = 0.f;
      if (p.d_radial != nullptr)
        for (int i = tid; i < nrc * sr; i += NT)
          p.d_radial[static_cast<size_t>(r0) * sr + i] = 0.f;
      continue;
    }
    // the ids and cbf rows of the kBatch triplets from position base
    auto load_ids = [&](int base, int n) {
      if (tid >= n) return;
      const int t = p.perm != nullptr ? p.perm[base + tid] : base + tid;
      const int k = p.kj[t], j = p.ji[t];
      const bool ok =
          static_cast<unsigned>(j) < static_cast<unsigned>(p.n_rows) &&
          k >= r0 && k < r1;
      rows_s[tid] = ok ? k - r0 : -1;
      j_s[tid] = ok ? j : -1;
      t_s[tid] = t;
#pragma unroll
      for (int l = 0; l < kMaxS; ++l)
        cbs[tid * kMaxS + l] =
            ok && l < s ? p.cbf[static_cast<size_t>(t) * s + l] : 0.f;
    };
    // their cotangent rows, asynchronously (zero for a skipped triplet)
    auto gather = [&](int n) {
      if (!col) return;
      for (int i = cg; i < n; i += kColGroups) {
        const int j = j_s[i];
        cp_async4(xg + i * ldq + c,
                         p.gout + static_cast<size_t>(j >= 0 ? j : 0) * d + c,
                         j >= 0);
      }
    };
    // the chunk's radial and x2 rows (zero past the last row), its row_ptr,
    // G zeroed, and the first batch's ids, all in flight together
    {
      const float* src = p.radial + static_cast<size_t>(r0) * sr;
      for (int i = tid; i < nr * sr; i += NT)
        cp_async4(rad + i, src + (i < nrc * sr ? i : 0), i < nrc * sr);
      src = p.x2 + static_cast<size_t>(r0) * d;
      for (int i = tid; i < nr * d; i += NT)
        cp_async4(xs + i, src + (i < nrc * d ? i : 0), i < nrc * d);
    }
    for (int i = tid; i < ns * ldq; i += NT) um[i] = 0.f;
    for (int i = tid; i <= nrc; i += NT) ptr_s[i] = p.row_ptr[r0 + i];
    int base = p_begin, n = min(kBatch, p_end - p_begin);
    load_ids(base, n);
    cp_async_wait_all();
    __syncthreads();
    gather(n);   // lands while P and Q are formed
    // P[k, l] = sum_r radial[k, l R + r] W1[l R + r]
    for (int it = tid; it < ns * BT; it += NT) {
      const int pr = it / BT, bb = it - pr * BT, kk = pr / s, l = pr - kk * s;
      const float* rp = rad + kk * sr + l * r;
      const float* wp = w1s + l * r * ld1 + bb;
      float v = 0.f;
      for (int q = 0; q < r; ++q) v += rp[q] * wp[q * ld1];
      pm[it] = v;
    }
    __syncthreads();
    if (need_q && col) {
      // Q[k, l] = P[k, l] . W2, column c
      for (int pr = cg; pr < ns; pr += kColGroups) {
        const float4* pp = reinterpret_cast<const float4*>(pm + pr * BT);
        float v = 0.f;
#pragma unroll
        for (int q = 0; q < BT / 4; ++q) {
          const float4 x = pp[q];
          v += x.x * w2c[4 * q] + x.y * w2c[4 * q + 1] +
               x.z * w2c[4 * q + 2] + x.w * w2c[4 * q + 3];
        }
        qm[pr * ldq + c] = v;
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // G[k, l] = sum over row k's triplets, in triplet order, of cbf[t, l]
    // g_t, kBatch triplets at a time: their ids and cbf rows, their
    // cotangent rows gathered, then each (row, column) adds its own
    while (true) {
      if (col) {
        for (int kk = cg; kk < nrc; kk += kColGroups) {
          const int lo = max(ptr_s[kk], base) - base;
          const int hi = min(ptr_s[kk + 1], base + n) - base;
          if (lo >= hi) continue;
          float acc[kMaxS];
#pragma unroll
          for (int l = 0; l < kMaxS; ++l)
            acc[l] = l < s ? um[(kk * s + l) * ldq + c] : 0.f;
#pragma unroll 2
          for (int i = lo; i < hi; ++i) {
            if (rows_s[i] != kk) continue;
            const float x = xg[i * ldq + c];
            const float4 c0 = reinterpret_cast<const float4*>(cbs)[2 * i];
            const float4 c1 = reinterpret_cast<const float4*>(cbs)[2 * i + 1];
            acc[0] += c0.x * x;
            acc[1] += c0.y * x;
            acc[2] += c0.z * x;
            acc[3] += c0.w * x;
            acc[4] += c1.x * x;
            acc[5] += c1.y * x;
            acc[6] += c1.z * x;
            acc[7] += c1.w * x;
          }
#pragma unroll
          for (int l = 0; l < kMaxS; ++l)
            if (l < s) um[(kk * s + l) * ldq + c] = acc[l];
        }
      }
      if (p.d_cbf != nullptr) {
        // d_cbf[t, l] = g_t . (x2 * Q)[k, l], to the triplet's own slot
        for (int it = tid; it < n * s; it += NT) {
          const int i = it / s, l = it - i * s, kk = rows_s[i];
          if (kk < 0) continue;
          const float* xp = xg + i * ldq;
          const float* x2p = xs + kk * d;
          const float* qp = qm + (kk * s + l) * ldq;
          float v = 0.f;
          int cc = 0;
          if ((d & 3) == 0)   // 16-byte rows of x2 too
            for (; cc < d; cc += 4) {
              const float4 x = *reinterpret_cast<const float4*>(xp + cc);
              const float4 y = *reinterpret_cast<const float4*>(x2p + cc);
              const float4 q = *reinterpret_cast<const float4*>(qp + cc);
              v += x.x * (y.x * q.x);
              v += x.y * (y.y * q.y);
              v += x.z * (y.z * q.z);
              v += x.w * (y.w * q.w);
            }
          for (; cc < d; ++cc) v += xp[cc] * (x2p[cc] * qp[cc]);
          p.d_cbf[static_cast<size_t>(t_s[i]) * s + l] = v;
        }
      }
      base += kBatch;
      __syncthreads();   // the batch's readers are done
      if (base >= p_end) break;
      n = min(kBatch, p_end - base);
      load_ids(base, n);
      __syncthreads();
      gather(n);
      cp_async_wait_all();
      __syncthreads();
    }

    // d_x2[k] = sum_l Q[k, l] * G[k, l]; U[k, l] = x2[k] * G[k, l] in place
    if (col) {
      for (int kk = cg; kk < nr; kk += kColGroups) {
        const float x = xs[kk * d + c];
        float v = 0.f;
        for (int l = 0; l < s; ++l) {
          float* gp = um + (kk * s + l) * ldq + c;
          const float gv = *gp;
          if (need_q) v += qm[(kk * s + l) * ldq + c] * gv;
          *gp = x * gv;
        }
        if (p.d_x2 != nullptr && kk < nrc)
          p.d_x2[static_cast<size_t>(r0 + kk) * d + c] = v;
      }
    }
    if (!need_hk) continue;   // the next chunk starts with a barrier
    __syncthreads();
    // Hk[k, l] = U[k, l] . W2^T: thread (pair, half of B)
    for (int it = tid; it < 2 * ns; it += NT) {
      constexpr int H2 = BT / 2;
      const int pr = it >> 1, b0 = (it & 1) * H2;
      const float* up = um + pr * ldq;
      float v[H2];
#pragma unroll
      for (int q = 0; q < H2; ++q) v[q] = 0.f;
      for (int cc = 0; cc < d; ++cc) {
        const float u = up[cc];
        const float4* wp = reinterpret_cast<const float4*>(w2t + cc * BT + b0);
#pragma unroll
        for (int q = 0; q < H2 / 4; ++q) {
          const float4 w = wp[q];
          v[4 * q] += u * w.x;
          v[4 * q + 1] += u * w.y;
          v[4 * q + 2] += u * w.z;
          v[4 * q + 3] += u * w.w;
        }
      }
#pragma unroll
      for (int q = 0; q < H2; ++q) hk[pr * BT + b0 + q] = v[q];
    }
    if (wgrad && col) {
      // dW2[b, c] += sum over the chunk's (row, l) pairs of P[., b] U[., c]:
      // thread (c, a quarter of B)
      constexpr int B4 = BT / 4;
      const int b0 = cg * B4;
      float v[B4];
#pragma unroll
      for (int q = 0; q < B4; ++q) v[q] = 0.f;
      for (int pr = 0; pr < ns; ++pr) {
        const float u = um[pr * ldq + c];
        const float* pp = pm + pr * BT + b0;
#pragma unroll
        for (int q = 0; q < B4; ++q) v[q] += pp[q] * u;
      }
#pragma unroll
      for (int q = 0; q < B4; ++q)
        if (b0 + q < b) gw2[(b0 + q) * d + c] += v[q];
    }
    __syncthreads();
    if (wgrad) {
      // dW1[i] += sum_k radial[k, i] Hk[k, i / R]
      for (int it = tid; it < sr * b; it += NT) {
        const int i = it / b, bb = it - i * b, l = i / r;
        float v = 0.f;
        for (int kk = 0; kk < nr; ++kk)
          v += rad[kk * sr + i] * hk[(kk * s + l) * BT + bb];
        gw1[it] += v;
      }
    }
    if (p.d_radial != nullptr) {
      // d_radial[k, i] = Hk[k, i / R] . W1[i]
      for (int it = tid; it < nrc * sr; it += NT) {
        const int kk = it / sr, i = it - kk * sr;
        const float* hp = hk + (kk * s + i / r) * BT;
        const float* wp = w1s + i * ld1;
        float v = 0.f;
#pragma unroll
        for (int bb = 0; bb < BT; ++bb) v += hp[bb] * wp[bb];
        p.d_radial[static_cast<size_t>(r0) * sr + it] = v;
      }
    }
  }

  if (wgrad) {
    // this block's partial, once: [dW1 SR*B | dW2 B*D], padded with zeros
    __syncthreads();
    const int n1 = sr * b, n2 = b * d, size = round4(n1 + n2);
    float* dst = p.partial + static_cast<size_t>(size) * blockIdx.x;
    for (int i = tid; i < size; i += NT)
      dst[i] = i < n1 ? gw1[i] : (i < n1 + n2 ? gw2[i - n1] : 0.f);
  }
}

// the opt-in shared memory of the current device (bytes), or an error
cudaError_t optin_smem(int* optin, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess || sms == nullptr) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// the forward on `route`: 0 the widths' own (fwd_route), 1 or 2 that one
// (1 only at widths it takes)
int launch_fwd(const Params& p, int route, cudaStream_t st) {
  int optin = 0, sms = 0;
  cudaError_t err = optin_smem(&optin, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int own = fwd_route(p.sr, p.b, p.d, optin);
  if (route == 0) route = own;
  if ((route == 1 && own != 1) || route < 1 || route > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1) {
    tritc::Args a{};
    a.x = p.x2;
    a.w1 = p.w1;
    a.w2 = p.w2;
    a.kj = p.kj;
    a.ji = p.ji;
    a.row_ptr = p.row_ptr;
    a.out = p.out;
    a.n_rows = p.n_rows;
    a.sr = p.sr;
    a.b = p.b;
    a.d = p.d;
    FactoredRows src{};
    src.radial = p.radial;
    src.cbf = p.cbf;
    src.s = p.s;
    src.r = p.r;
    return tritc::launch<tritc::kFwd>(a, src, sms, st);
  }
  const size_t smem =
      sizeof(float) * static_cast<size_t>(fwd_smem_floats(p.sr, p.b, p.d));
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(dn_tri_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dn_tri_fwd_kernel<<<p.n_chunks, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int BT>
int launch_bwd_bt(Params p, int n_parts, void* wgrad, int optin, int sms,
                  cudaStream_t st) {
  const size_t smem = sizeof(float) * static_cast<size_t>(
      bwd_layout(p.s, p.sr, BT, p.d, p.rows, p.b).total);
  cudaError_t err = cudaFuncSetAttribute(
      dn_tri_bwd_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dn_tri_bwd_kernel<BT>, kBwdThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int grid = per_sm > 0 ? per_sm * sms : 1;
  if (grid > p.n_chunks) grid = p.n_chunks;
  if (p.partial != nullptr && grid > n_parts) grid = n_parts;
  dn_tri_bwd_kernel<BT><<<grid, kBwdThreads, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.partial == nullptr)
    return static_cast<int>(err);
  return static_cast<int>(passp::launch_reduce_partials(
      p.partial, static_cast<float*>(wgrad), grid,
      round4(p.sr * p.b + p.b * p.d), st));
}

// the backward on a persistent grid: as many blocks as the card holds at
// once, at most one per chunk and (with weight gradients) per partial
int launch_bwd(Params p, int n_parts, void* wgrad, cudaStream_t st) {
  int optin = 0, sms = 0;
  const cudaError_t err = optin_smem(&optin, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.rows = bwd_chunk_rows(p.s, p.sr, p.b, p.d, optin);
  if (p.rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  p.n_chunks = (p.n_rows + p.rows - 1) / p.rows;
  switch (bwd_bt(p.b)) {
    case 8: return launch_bwd_bt<8>(p, n_parts, wgrad, optin, sms, st);
    case 16: return launch_bwd_bt<16>(p, n_parts, wgrad, optin, sms, st);
    case 32: return launch_bwd_bt<32>(p, n_parts, wgrad, optin, sms, st);
    default: return launch_bwd_bt<64>(p, n_parts, wgrad, optin, sms, st);
  }
}

}  // namespace

// The size in floats of one weight-gradient partial (and of `wgrad`):
// [dW1 SR*B | dW2 B*D], padded to a multiple of 4.
extern "C" int hg_dn_tri_wgrad_size(int sr, int b, int d) {
  return round4(sr * b + b * d);
}

// The forward's route at these widths on the current device: 1
// (fwd_tc_kernel<kFwd, FactoredRows>: B <= 8, D a multiple of 8), 2
// (dn_tri_fwd_kernel, the first design), 0 when the device cannot be asked
// or the op does not take the widths.
extern "C" int hg_dn_tri_fwd_route(int s, int sr, int b, int d) {
  int optin = 0;
  if (s < 1 || s > kMaxS || sr < s || sr > kMaxSR || sr % s != 0 || b < 1 ||
      b > kMaxB || d < 1 || d > kMaxD ||
      optin_smem(&optin, nullptr) != cudaSuccess)
    return 0;
  return fwd_route(sr, b, d, optin);
}

// Bytes of dynamic shared memory of one route-1 block of the forward at
// S*R and D.
extern "C" int hg_dn_tri_fwd_smem(int sr, int d) {
  return static_cast<int>(
      sizeof(float) *
      static_cast<size_t>(tritc::smem_words<FactoredRows>(sr, d)));
}

// One dn_tri launch; returns the cudaError_t (0 = success).  mode 0: the
// forward (out [E, D]; rows are ji, positions in triplet order, `perm`
// null; `route` 0 takes the widths' own, hg_dn_tri_fwd_route, 1 or 2 that
// one where the widths admit it); mode 1: the backward (rows are kj, positions through `perm`, the
// stable argsort of idx_kj; d_radial, d_x2 or null; d_cbf zero-filled or
// null; `partial` [n_parts, wgrad size] scratch and `wgrad` the reduced
// weight gradients, or both null).  Pointers are device pointers;
// launches go on `stream` and do not synchronise.
extern "C" int hg_dn_tri_f32(
    int mode, const void* radial, const void* x2, const void* cbf,
    const void* w1, const void* w2, const void* kj, const void* ji,
    const void* perm, const void* row_ptr, const void* gout, void* out,
    void* d_radial, void* d_x2, void* d_cbf, void* partial, void* wgrad,
    int n_rows, int s, int r, int b, int d, int n_parts, int route,
    void* stream) {
  if (n_rows <= 0) return 0;
  if (s < 1 || s > kMaxS || r < 1 || s * r > kMaxSR || b < 1 || b > kMaxB ||
      d < 1 || d > kMaxD || mode < kFwd || mode > kBwd ||
      (mode == kBwd && (gout == nullptr ||
                        (partial != nullptr) != (wgrad != nullptr) ||
                        (partial != nullptr && n_parts < 1))) ||
      (mode == kFwd && out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.radial = static_cast<const float*>(radial);
  p.x2 = static_cast<const float*>(x2);
  p.cbf = static_cast<const float*>(cbf);
  p.w1 = static_cast<const float*>(w1);
  p.w2 = static_cast<const float*>(w2);
  p.kj = static_cast<const int*>(kj);
  p.ji = static_cast<const int*>(ji);
  p.perm = static_cast<const int*>(perm);
  p.row_ptr = static_cast<const int*>(row_ptr);
  p.gout = static_cast<const float*>(gout);
  p.out = static_cast<float*>(out);
  p.d_radial = static_cast<float*>(d_radial);
  p.d_x2 = static_cast<float*>(d_x2);
  p.d_cbf = static_cast<float*>(d_cbf);
  p.partial = static_cast<float*>(partial);
  p.n_rows = n_rows;
  p.s = s;
  p.r = r;
  p.sr = s * r;
  p.b = b;
  p.d = d;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kFwd) {
    p.n_chunks = (n_rows + kRows - 1) / kRows;
    return launch_fwd(p, route, st);
  }
  return launch_bwd(p, n_parts, wgrad, st);
}
