// Hand-written Hopper (sm_90a) kernels for DimeNet++'s triplet interaction
// at the builder's widths (past the factored-basis kernel's gate)
//
//   emb_t   = (sbf_t @ K1) @ K2                  [D]
//   out[e]  = sum_{t: ji(t) = e} x[kj(t)] * emb_t
//
// x [E, D], sbf [T, SR] (the full per-triplet spherical basis), K1 [SR, B],
// K2 [B, D], all float32 row-major; SR <= 127, B <= 128, D <= 128.  Plain C
// interface, loaded with ctypes by hydragnn_torch/kernels/build.py; the
// wrappers, plain PyTorch versions and launch counters live in
// hydragnn_torch/ops/dn_tri.py (dimenet_tri_builder).
//
// Replaces the generic fused-block builder of hydragnn_tpu/ops/fused_block.py
// with the dn_tri_builder spec (hydragnn_tpu/ops/dn_tri.py:416-450):
// _fused_fwd (pl.pallas_call at fused_block.py:495), _fused_bwd pass P
// (:561) and pass S (:599).  Four kernels, one of them in two modes:
//
// fwd_tc_kernel<kFwd> — the forward, route 1 (hg_dn_tri_builder_fwd_route):
//   B <= 8, SR <= 64 and D a multiple of 8, DimeNet++'s QM9 widths (42, 8,
//   128) among them.  Warps work alone, with no block barrier after the
//   weights are staged: each of the grid's warps owns one contiguous run of output
//   rows (passp::share_range: the runs balance rows plus triplets) and walks
//   its triplets (positions in ji order are triplet ids) 16 at a time, one
//   m16 tile.  A tile's sbf rows are one contiguous block of device memory,
//   brought in row by row with 8-byte cp.async (4-byte at an odd SR); its
//   x[kj] rows with 16-byte cp.async, 512 B a row at D = 128; both land in
//   the warp's own ring of kTcStages stages, so the next tiles' copies are
//   in flight while this tile's products run, and the ids a stage further
//   ahead are loaded into registers.  Both products run on the tensor cores
//   in 3xTF32 (csrc/pass_p.cuh: each k step's three products from zero, then
//   a float32 add): emb1 = sbf.K1 as [16 x SR (padded to 8)] . [8 x B
//   (padded to 8)], one n-tile; emb2 = emb1.K2 as one k step over D / 8
//   n-tiles. The k index of each product is permuted within its 8-wide step
//   (A's column 2t and 2t + 1 in the fragment's slots t and t + 4, B's rows
//   to match), so that emb1's accumulator fragment is already emb2's A
//   fragment and an A fragment of sbf is two float2 loads.  K1's and K2's
//   fragments are split into hi and lo once per block and read as one
//   16-byte load a lane.  x[kj] * emb2 goes back into the x stage in place;
//   the warp then adds each triplet's row into its output row in triplet
//   order, each lane four columns, and writes every row of its run once
//   (rows without triplets as zeros).  Tile strides are 8 or 24 mod 32
//   floats, so the fragments' float2 loads and stores hit 32 banks.
// fwd_tc_kernel<kPassS> — pass S, route 1 (hg_dn_tri_builder_bwd_s_route:
//   the forward's widths, and only when d sbf is not asked for, as on the
//   training path): the same kernel in kj order.  Rows are kj, the CSR is
//   over positions in kj order, and a tile's triplets are t = perm[pos]
//   (ids loaded a stage ahead, perm first); each sbf row is its own
//   triplet's, gathered by cp.async (8 bytes a lane at an even SR; the
//   rows are scattered, so they come from device memory), and the x stage
//   receives dout[ji] with 16-byte cp.async.  The products are the
//   forward's; dout[ji] * emb2 is formed in place and each warp adds it
//   into its own kj rows in position order (the triplet order of route 2
//   and of the stable argsort).
// tri_rows_kernel<kFwd> — the forward, route 2 (every other width): rows
//   are output edges e, each block owns kRows rows and walks their
//   triplets TT at a time: gathers sbf[t] into a transposed tile and x[kj]
//   into another, forms emb1 = sbf.K1 and emb2 = emb1.K2 in shared memory
//   on the CUDA cores, and adds x[kj] * emb2 into its rows in triplet
//   order.
// tri_rows_kernel<kPassS> — the backward's pass S, route 2 (d sbf asked
//   for, or past route 1's widths).  One pass in kj order
//   (through perm_kj): rows are the gathered edges k.  Per triplet it
//   recomputes emb1, emb2, takes g = dout[ji] and
//     d_x[k]  += g * emb2                (the row's own sum, no atomics)
//     d_emb2   = g * x[k];  d_emb1 = d_emb2.K2^T;  d_sbf[t] = d_emb1.K1^T
//   d_sbf goes straight to the triplet's own slot (skipped when not asked
//   for: on the training path sbf needs no gradient).
// tri_wgrad_kernel (+ tri_reduce_partials_kernel) — the backward's pass P,
//   the weight gradients
//     dK2 = sum_t emb1_t^T d_emb2_t,   dK1 = sum_t sbf_t^T d_emb1_t
//   over the real triplets in ji order.  K1, K2 and their gradients do not
//   fit one block's shared memory together at the limits (four 64 KB
//   blocks), so the grid's second dimension cuts B into slices of kSlice:
//   a block holds K1[:, slice], K2[slice, :] and the gradient partials of
//   the same entries (d_emb1[:, slice] needs only K2[slice, :]).  Each block
//   of a persistent grid sums its tiles into one float32 partial; the
//   reduce kernel adds the partials in block order.
//
// Bound on the H100 SXM: bytes (per real triplet the sbf row, the ids and
// the x[kj] row from L2 against ~2(SR*B + B*D) flops; the backward also
// writes d_sbf when asked).  The first design's kernels (route 2, pass S,
// pass P): no [T, D] or [T, B] tensor reaches device memory (every
// per-triplet quantity lives in a shared-memory tile of TT triplets);
// tiles are transposed ([k][t], row stride TT+4) so one 16-byte load feeds
// four multiply-adds; K1 and K2 are staged once per block with odd row
// strides (B | 1, D | 1), free of bank conflicts along a row and down a
// column; shared memory is sized from the actual widths (at the limits
// the forward takes 209 KB, pass P 110 KB).  They run on the CUDA cores.
//
// Contract (add_dimenet_extras guarantees it): idx_ji is nondecreasing;
// masked triplets sort last in both orders and are parked out of every
// range by the wrapper, so they are never read and get exactly zero in
// every output and gradient (the wrapper zero-fills d_sbf).  Ids outside
// [0, E) contribute nothing.  Determinism: every sum runs in a fixed order
// (triplet order within a row; tile, then block order for dK1, dK2); no
// atomics.  Every output row is written, rows without triplets as zeros.
// Triplet offsets into sbf and d_sbf are 64-bit (T * SR passes 2^31).

#include <cuda_runtime.h>

#include "pass_p.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int TT = 32;            // triplets per tile
constexpr int EQ = 8;             // triplets per work item
constexpr int kGroups = TT / EQ;
constexpr int LDT = TT + 4;       // row stride of a transposed tile
constexpr int kRows = 16;         // output rows per chunk
constexpr int kSlice = 32;        // B entries per pass-P block
constexpr int kMaxSR = 127;
constexpr int kMaxB = 128;
constexpr int kMaxD = 128;

constexpr int kFwd = 0;
constexpr int kPassS = 1;
constexpr int kPassP = 2;

struct Params {
  const float* x;        // [E, D]
  const float* sbf;      // [T, SR]
  const float* w1;       // [SR, B]
  const float* w2;       // [B, D]
  const int* kj;         // [T]
  const int* ji;         // [T]
  const int* perm;       // [T] position -> triplet, or null (identity)
  const int* row_ptr;    // [E + 1] CSR over positions
  const float* gout;     // [E, D] cotangent of out (backward)
  float* out;            // forward: out [E, D]; pass S: d_x [E, D] or null
  float* d_sbf;          // pass S: [T, SR] zero-filled, or null
  float* partial;        // pass P: [gridDim.x, wgrad size]
  int n_rows, sr, b, d, n_chunks;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline int slice_width(int b) {
  return b < kSlice ? b : kSlice;
}

// shared-memory floats of a mode at these widths
__host__ __device__ inline int smem_floats(int mode, int sr, int b, int d) {
  if (mode == kPassP) {
    const int bs = slice_width(b);
    int n = 2 * (round4(sr * (bs | 1)) + round4(bs * (d | 1)));  // K, dK
    n += (sr + d + 2 * bs) * LDT;      // sbf, d_emb2, emb1, d_emb1
    return n + 2 * TT;                 // ids
  }
  int n = round4(sr * (b | 1)) + round4(b * (d | 1));   // K1, K2
  n += (sr + b + 2 * d) * LDT;                          // sbf, emb1, x, emb2
  n += kRows * d;                                       // out / d_x rows
  return n + 4 * TT;                                    // ids
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

// out tile [n_out][LDT] = T [K][LDT] . W^T (W[c][k] at w[c * ld + k])
__device__ __forceinline__ void product_t(float* out, int n_out,
                                          const float* T, int K,
                                          const float* w, int ld) {
  for (int it = threadIdx.x; it < n_out * kGroups; it += kThreads) {
    const int c = it % n_out, e0 = (it / n_out) * EQ;
    float acc[EQ] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    mv(acc, T, K, w + c * ld, 1, e0);
    store8(out + c * LDT + e0, acc);
  }
}

// sum_e a[e] * b[e] over the TT triplets of two transposed tile rows
__device__ __forceinline__ float row_dot(const float* a, const float* b) {
  float v = 0.f;
#pragma unroll
  for (int q = 0; q < TT / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(a)[q];
    const float4 y = reinterpret_cast<const float4*>(b)[q];
    v += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
  }
  return v;
}

// G[k*ld + c] += sum_e A[k][e] * D[c][e] for k < K, c < n (a weight grad)
__device__ __forceinline__ void outer_acc(float* G, int ld, const float* A,
                                          int K, const float* D, int n) {
  for (int it = threadIdx.x; it < K * n; it += kThreads) {
    const int k = it / n, c = it - k * n;
    G[k * ld + c] += row_dot(A + k * LDT, D + c * LDT);
  }
}

// The forward and pass S: rows in CSR order, one chunk of kRows rows at a
// time per block.
template <int MODE>
__global__ void __launch_bounds__(kThreads) tri_rows_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int sr = p.sr, b = p.b, d = p.d;
  const int ld1 = b | 1, ld2 = d | 1;
  const int tid = threadIdx.x;

  float* w1s = sm; sm += round4(sr * ld1);
  float* w2s = sm; sm += round4(b * ld2);
  float* sbf_t = sm; sm += sr * LDT;     // sbf; pass S: then d_sbf
  float* e1_t = sm; sm += b * LDT;       // emb1; pass S: then d_emb1
  float* x_t = sm; sm += d * LDT;        // x[kj]; pass S: then d_emb2
  float* e2_t = sm; sm += d * LDT;       // emb2; pass S: then g * emb2
  float* rows = sm; sm += kRows * d;     // out rows / d_x rows
  int* t_s = reinterpret_cast<int*>(sm);
  int* k_s = t_s + TT;
  int* j_s = k_s + TT;
  int* row_s = j_s + TT;

  for (int i = tid; i < sr * b; i += kThreads)
    w1s[(i / b) * ld1 + i % b] = p.w1[i];
  for (int i = tid; i < b * d; i += kThreads)
    w2s[(i / d) * ld2 + i % d] = p.w2[i];
  const bool want_dsbf = MODE == kPassS && p.d_sbf != nullptr;

  for (int chunk = blockIdx.x; chunk < p.n_chunks; chunk += gridDim.x) {
    const int r0 = chunk * kRows;
    const int r1 = min(r0 + kRows, p.n_rows);
    const int p_begin = p.row_ptr[r0];
    const int p_end = p.row_ptr[r1];
    __syncthreads();  // staging done; the previous chunk's rows written out
    for (int i = tid; i < kRows * d; i += kThreads) rows[i] = 0.f;

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
          const int own = MODE == kFwd ? j : k;
          if (static_cast<unsigned>(k) >= static_cast<unsigned>(p.n_rows) ||
              static_cast<unsigned>(j) >= static_cast<unsigned>(p.n_rows) ||
              own < r0 || own >= r1) {
            k = -1;
          } else {
            row = own - r0;
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
        sbf_t[c * LDT + e] = k_s[e] >= 0
            ? p.sbf[static_cast<size_t>(t_s[e]) * sr + c] : 0.f;
      }
      for (int i = tid; i < TT * d; i += kThreads) {
        const int e = i / d, c = i - e * d;
        const int k = k_s[e];
        x_t[c * LDT + e] = k >= 0 ? p.x[static_cast<size_t>(k) * d + c] : 0.f;
      }
      __syncthreads();
      product(e1_t, b, sbf_t, sr, w1s, ld1);        // emb1 = sbf . K1
      __syncthreads();
      product(e2_t, d, e1_t, b, w2s, ld2);          // emb2 = emb1 . K2
      __syncthreads();

      if constexpr (MODE == kFwd) {
        // rows += x[kj] * emb2 in triplet order
        for (int c = tid; c < d; c += kThreads) {
          for (int e = 0; e < cnt; ++e)
            if (k_s[e] >= 0)
              rows[row_s[e] * d + c] += x_t[c * LDT + e] * e2_t[c * LDT + e];
        }
      } else {
        // ---- pass S: the cotangent is gathered at ji ----
        for (int it = tid; it < d * TT; it += kThreads) {
          const int c = it / TT, e = it - c * TT;
          const float g = k_s[e] >= 0
              ? p.gout[static_cast<size_t>(j_s[e]) * d + c] : 0.f;
          x_t[c * LDT + e] *= g;       // d_emb2 = g * x[k]
          e2_t[c * LDT + e] *= g;      // the d_x message: g * emb2
        }
        __syncthreads();
        if (want_dsbf) {
          product_t(e1_t, b, x_t, d, w2s, ld2);     // d_emb1 = d_emb2 . K2^T
          __syncthreads();
          product_t(sbf_t, sr, e1_t, b, w1s, ld1);  // d_sbf = d_emb1 . K1^T
          __syncthreads();
          for (int it = tid; it < cnt * sr; it += kThreads) {
            const int e = it / sr, c = it - e * sr;
            p.d_sbf[static_cast<size_t>(t_s[e]) * sr + c] =
                sbf_t[c * LDT + e];
          }
        }
        // the row's own d_x, in triplet order
        for (int c = tid; c < d; c += kThreads) {
          for (int e = 0; e < cnt; ++e)
            if (k_s[e] >= 0) rows[row_s[e] * d + c] += e2_t[c * LDT + e];
        }
      }
    }
    __syncthreads();
    if (p.out != nullptr) {
      for (int i = tid; i < (r1 - r0) * d; i += kThreads)
        p.out[static_cast<size_t>(r0) * d + i] = rows[i];
    }
  }
}

// Pass P: dK1[:, slice] and dK2[slice, :] over the real triplets (positions
// [row_ptr[0], row_ptr[E]) in ji order), tile q handled by block q mod
// gridDim.x; blockIdx.y picks the slice of B.
__global__ void __launch_bounds__(kThreads) tri_wgrad_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int sr = p.sr, b = p.b, d = p.d;
  const int bmax = slice_width(b);
  const int j0 = blockIdx.y * kSlice;
  const int bs = min(kSlice, b - j0);
  const int ld1 = bmax | 1, ld2 = d | 1;
  const int tid = threadIdx.x;

  float* w1s = sm; sm += round4(sr * ld1);      // K1[:, slice]
  float* w2s = sm; sm += round4(bmax * ld2);    // K2[slice, :]
  float* gw1 = sm; sm += round4(sr * ld1);
  float* gw2 = sm; sm += round4(bmax * ld2);
  float* sbf_t = sm; sm += sr * LDT;
  float* x_t = sm; sm += d * LDT;               // d_emb2 = g * x[kj]
  float* e1_t = sm; sm += bmax * LDT;
  float* de1_t = sm; sm += bmax * LDT;
  int* k_s = reinterpret_cast<int*>(sm);
  int* j_s = k_s + TT;

  for (int i = tid; i < sr * bs; i += kThreads) {
    const int c = i / bs, jj = i - c * bs;
    w1s[c * ld1 + jj] = p.w1[static_cast<size_t>(c) * b + j0 + jj];
    gw1[c * ld1 + jj] = 0.f;
  }
  for (int i = tid; i < bs * d; i += kThreads) {
    const int jj = i / d, c = i - jj * d;
    w2s[jj * ld2 + c] = p.w2[static_cast<size_t>(j0 + jj) * d + c];
    gw2[jj * ld2 + c] = 0.f;
  }
  const int p0 = p.row_ptr[0];
  const int p1 = p.row_ptr[p.n_rows];

  for (int q = p0 + blockIdx.x * TT; q < p1; q += gridDim.x * TT) {
    const int cnt = min(TT, p1 - q);
    __syncthreads();  // staging done; the previous tile's readers are done
    if (tid < TT) {
      int k = -1, j = -1;
      if (tid < cnt) {
        k = p.kj[q + tid];
        j = p.ji[q + tid];
        if (static_cast<unsigned>(k) >= static_cast<unsigned>(p.n_rows) ||
            static_cast<unsigned>(j) >= static_cast<unsigned>(p.n_rows))
          k = -1;
      }
      k_s[tid] = k;
      j_s[tid] = j;
    }
    __syncthreads();
    // gathers, transposed; invalid and out-of-tile triplets read zeros
    for (int i = tid; i < TT * sr; i += kThreads) {
      const int e = i / sr, c = i - e * sr;
      sbf_t[c * LDT + e] = k_s[e] >= 0
          ? p.sbf[static_cast<size_t>(q + e) * sr + c] : 0.f;
    }
    for (int i = tid; i < TT * d; i += kThreads) {
      const int e = i / d, c = i - e * d;
      const int k = k_s[e];
      x_t[c * LDT + e] = k >= 0
          ? p.x[static_cast<size_t>(k) * d + c]
                * p.gout[static_cast<size_t>(j_s[e]) * d + c]
          : 0.f;
    }
    __syncthreads();
    product(e1_t, bs, sbf_t, sr, w1s, ld1);       // emb1 = sbf . K1[:, sl]
    product_t(de1_t, bs, x_t, d, w2s, ld2);       // d_emb1 = d_emb2 . K2[sl]^T
    __syncthreads();
    outer_acc(gw2, ld2, e1_t, bs, x_t, d);        // dK2[sl] += emb1^T d_emb2
    outer_acc(gw1, ld1, sbf_t, sr, de1_t, bs);    // dK1[:, sl] += sbf^T d_emb1
  }

  // this block's partial entries of the slice: [dK1 SR*B | dK2 B*D]
  __syncthreads();
  const int size = round4(sr * b + b * d);
  float* dst = p.partial + static_cast<size_t>(size) * blockIdx.x;
  for (int i = tid; i < sr * bs; i += kThreads) {
    const int c = i / bs, jj = i - c * bs;
    dst[c * b + j0 + jj] = gw1[c * ld1 + jj];
  }
  for (int i = tid; i < bs * d; i += kThreads) {
    const int jj = i / d, c = i - jj * d;
    dst[sr * b + (j0 + jj) * d + c] = gw2[jj * ld2 + c];
  }
}

// ---------------------------------------------------------------------------
// the forward, route 1: warps on their own rows, cp.async rings, tensor
// cores in 3xTF32
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcStages = 2;      // each warp's ring of tiles in flight
constexpr int kTcM = 16;          // triplets per warp tile: one m16 fragment
constexpr int kTcMaxSR = 64;
constexpr int kTcMaxB = 8;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int round8(int n) { return (n + 7) & ~7; }

// one stage of a warp's ring: the sbf tile [16][frag_ld(round8(SR))], then
// the x tile [16][frag_ld(D)]
__host__ __device__ inline int tc_stage_floats(int sr, int d) {
  return kTcM * (passp::frag_ld(round8(sr)) + passp::frag_ld(d));
}

// shared 32-bit words of route 1: K1's and K2's split fragments (one uint4
// a lane a k step or n-tile), then each warp's stages
__host__ __device__ inline int tc_smem_words(int sr, int d) {
  return 4 * 32 * (round8(sr) / 8 + d / 8) +
         kTcWarps * kTcStages * tc_stage_floats(sr, d);
}

// route 1 at these widths, when a block's shared memory (optin bytes)
// holds it; 2 otherwise
__host__ inline int fwd_route(int sr, int b, int d, int optin) {
  if (b <= kTcMaxB && sr <= kTcMaxSR && d % 8 == 0 &&
      sizeof(float) * static_cast<size_t>(tc_smem_words(sr, d)) <=
          static_cast<size_t>(optin))
    return 1;
  return 2;
}

// pass S takes the forward's route 1 at its widths when d sbf is not asked
// for (the training path: sbf needs no gradient); route 2 keeps d sbf
__host__ inline int bwd_s_route(int sr, int b, int d, bool want_sbf,
                                int optin) {
  return want_sbf ? 2 : fwd_route(sr, b, d, optin);
}

// the device's opt-in shared memory per block and its SM count
__host__ inline cudaError_t device_limits(int* optin, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess && sms != nullptr)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(a), "l"(src));
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(a), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(a), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N groups of this thread's copies are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

template <int MODE>
__global__ void __launch_bounds__(kTcThreads, 1)
fwd_tc_kernel(const Params p) {
  static_assert(MODE == kFwd || MODE == kPassS, "forward or pass S");
  constexpr bool kS = MODE == kPassS;
  extern __shared__ float4 smem4[];
  const int sr = p.sr, b = p.b, d = p.d;
  const int ks = round8(sr) / 8, nt = d / 8;
  const int lds = passp::frag_ld(round8(sr)), ldx = passp::frag_ld(d);
  const int stage = tc_stage_floats(sr, d);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint4* k1f = reinterpret_cast<uint4*>(smem4);     // [ks][32]
  uint4* k2f = k1f + ks * 32;                        // [nt][32]
  float* ring =
      reinterpret_cast<float*>(k2f + nt * 32) + warp * kTcStages * stage;

  // K1's fragments, k permuted within each step: lane (g, t) of step s
  // holds K1[8s + 2t][g] and K1[8s + 2t + 1][g] (zero past SR or B), split
  for (int i = tid; i < ks * 32; i += kTcThreads) {
    const int s = i >> 5, l = i & 31, lg = l >> 2, r = 8 * s + 2 * (l & 3);
    const float v0 = r < sr && lg < b ? p.w1[r * b + lg] : 0.f;
    const float v1 = r + 1 < sr && lg < b ? p.w1[(r + 1) * b + lg] : 0.f;
    uint4 f;
    passp::split_ih(v0, f.x, f.z);
    passp::split_ih(v1, f.y, f.w);
    k1f[i] = f;
  }
  // K2's, the same permutation of its B rows: K2[2t][8j + g], K2[2t+1][..]
  for (int i = tid; i < nt * 32; i += kTcThreads) {
    const int j = i >> 5, l = i & 31, r = 2 * (l & 3), c = 8 * j + (l >> 2);
    const float v0 = r < b ? p.w2[r * d + c] : 0.f;
    const float v1 = r + 1 < b ? p.w2[(r + 1) * d + c] : 0.f;
    uint4 f;
    passp::split_ih(v0, f.x, f.z);
    passp::split_ih(v1, f.y, f.w);
    k2f[i] = f;
  }
  // the sbf tiles' columns [SR, round8(SR)): zero, never written again
  const int pad = round8(sr) - sr;
  for (int i = lane; i < kTcStages * kTcM * pad; i += 32) {
    const int st = i / (kTcM * pad), rr = i - st * kTcM * pad;
    ring[st * stage + (rr / pad) * lds + sr + rr % pad] = 0.f;
  }
  __syncthreads();  // the only block barrier

  int r_begin, r_end;
  passp::share_range(p.row_ptr, p.n_rows, blockIdx.x * kTcWarps + warp,
              gridDim.x * kTcWarps, r_begin, r_end);
  if (r_begin >= r_end) return;
  const int p_begin = __ldg(p.row_ptr + r_begin);
  const int p_end = __ldg(p.row_ptr + r_end);
  const int n_tiles = (p_end - p_begin + kTcM - 1) / kTcM;

  // a tile's ids in lanes 0..15: the triplet t of position p_begin + 16 i
  // + lane (the forward: positions are triplet ids in ji order; pass S:
  // through perm, in kj order), its kj and ji; -1 past the run
  auto load_ids = [&](int i, int& tt, int& kj, int& ji) {
    const int pos = p_begin + i * kTcM + lane;
    const bool in = lane < kTcM && i < n_tiles && pos < p_end;
    tt = in ? (kS ? __ldg(p.perm + pos) : pos) : -1;
    kj = in ? __ldg(p.kj + tt) : -1;
    ji = in ? __ldg(p.ji + tt) : -1;
  };
  // a triplet is taken when both ids are edges and its row (the forward:
  // ji; pass S: kj) is this warp's
  auto taken = [&](int kj, int ji) {
    const int own = kS ? kj : ji, other = kS ? ji : kj;
    return static_cast<unsigned>(other) < static_cast<unsigned>(p.n_rows) &&
           own >= r_begin && own < r_end;
  };
  // tile i's sbf rows and x rows (the forward: x[kj]; pass S: the
  // cotangent at ji) into a stage, as one group of copies (SR <= 64: one
  // 8-byte piece, or two floats, a lane a row; D <= 128: one 16-byte piece
  // a lane a row).  The forward's sbf rows are one contiguous block, pass
  // S's each its own triplet's.
  auto fetch = [&](int i, int tt, int kj, int ji, float* st) {
    const int q = p_begin + i * kTcM;
    const int cnt = min(kTcM, p_end - q);
    float* xb = st + kTcM * lds;
    const float* xs = kS ? p.gout : p.x;
#pragma unroll
    for (int e = 0; e < kTcM; ++e) {
      const int k = __shfl_sync(kFull, kj, e);
      const int j = __shfl_sync(kFull, ji, e);
      const int t_e = kS ? __shfl_sync(kFull, tt, e) : q + e;
      if (e < cnt) {
        const float* src = p.sbf + static_cast<size_t>(t_e) * sr;
        if ((sr & 1) == 0) {
          if (2 * lane < sr) cp_async8(st + e * lds + 2 * lane, src + 2 * lane);
        } else {
          if (lane < sr) cp_async4(st + e * lds + lane, src + lane);
          if (lane + 32 < sr)
            cp_async4(st + e * lds + lane + 32, src + lane + 32);
        }
        if (taken(k, j) && 4 * lane < d)
          cp_async16(xb + e * ldx + 4 * lane,
                     xs + static_cast<size_t>(kS ? j : k) * d + 4 * lane);
      }
    }
    cp_async_commit();
  };

  int cur = r_begin;            // the row being summed
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int c4 = 4 * lane;      // this lane's four columns of the sums
  auto flush = [&](int upto) {  // write row cur, then zero rows to upto
    if (c4 < d) {
      *reinterpret_cast<float4*>(p.out + static_cast<size_t>(cur) * d + c4) =
          acc;
      for (int r = cur + 1; r < upto; ++r)
        *reinterpret_cast<float4*>(p.out + static_cast<size_t>(r) * d + c4) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  // ids of tiles i .. i + kTcStages in registers; tiles i .. i +
  // kTcStages - 1 in flight (one group of copies each, empty past the
  // run's last tile)
  constexpr int S = kTcStages;
  int tr[S + 1], kjr[S + 1], jir[S + 1];
#pragma unroll
  for (int u = 0; u <= S; ++u) load_ids(u, tr[u], kjr[u], jir[u]);
#pragma unroll
  for (int u = 0; u + 1 < S; ++u) {
    if (u < n_tiles)
      fetch(u, tr[u], kjr[u], jir[u], ring + u * stage);
    else
      cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    float* st = ring + (i % S) * stage;
    const int ahead = i + S - 1;
    if (ahead < n_tiles)
      fetch(ahead, tr[S - 1], kjr[S - 1], jir[S - 1],
            ring + (ahead % S) * stage);
    else
      cp_async_commit();  // an empty group: tile i's stays S-th to last
    cp_async_wait<S - 1>();
    __syncwarp();
    const int kj0 = kjr[0], ji0 = jir[0];

    // emb1 = sbf . K1 over the k steps (at most 8): one m16 x n8
    // accumulator
    float e1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < kTcMaxSR / 8; ++s) {
      if (s < ks) {
        const float2 u0 =
            *reinterpret_cast<const float2*>(st + g * lds + 8 * s + 2 * t);
        const float2 u1 = *reinterpret_cast<const float2*>(
            st + (g + 8) * lds + 8 * s + 2 * t);
        passp::FragA a;
        passp::set_a<true>(a, u0.x, u1.x, u0.y, u1.y);
        const uint4 f = k1f[s * 32 + lane];
        passp::FragB bf;
        bf.hi[0] = f.x; bf.hi[1] = f.y; bf.lo[0] = f.z; bf.lo[1] = f.w;
        passp::mma3(e1, a, bf);
      }
    }
    // emb2 = emb1 . K2, one k step: emb1's accumulator is its A fragment;
    // each n-tile's x * emb2 (pass S: dout[ji] * emb2) replaces x in the
    // stage
    passp::FragA a2;
    passp::set_a<true>(a2, e1[0], e1[2], e1[1], e1[3]);
    float* xb = st + kTcM * lds;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (8 * j < d) {
        const uint4 f = k2f[j * 32 + lane];
        passp::FragB bf;
        bf.hi[0] = f.x; bf.hi[1] = f.y; bf.lo[0] = f.z; bf.lo[1] = f.w;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        passp::mma3(c, a2, bf);
        float2* x0 = reinterpret_cast<float2*>(xb + g * ldx + 8 * j + 2 * t);
        float2* x1 =
            reinterpret_cast<float2*>(xb + (g + 8) * ldx + 8 * j + 2 * t);
        const float2 v0 = *x0, v1 = *x1;
        *x0 = make_float2(v0.x * c[0], v0.y * c[1]);
        *x1 = make_float2(v1.x * c[2], v1.y * c[3]);
      }
    }
    __syncwarp();
    // each triplet's row into its output row (pass S: d x at kj), in
    // position order: the tile's rows (this lane's four columns) and ids
    // read first, then summed
    const int cnt = min(kTcM, p_end - (p_begin + i * kTcM));
    const unsigned use = __ballot_sync(kFull, lane < cnt && taken(kj0, ji0));
    float4 v[kTcM];
    int jv[kTcM];
#pragma unroll
    for (int e = 0; e < kTcM; ++e) {
      jv[e] = __shfl_sync(kFull, kS ? kj0 : ji0, e);
      v[e] = c4 < d ? *reinterpret_cast<const float4*>(xb + e * ldx + c4)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int e = 0; e < kTcM; ++e) {
      const int j = jv[e];
      if (((use >> e) & 1u) && j >= cur) {
        if (j != cur) {
          flush(j);
          cur = j;
          acc = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        acc.x += v[e].x;
        acc.y += v[e].y;
        acc.z += v[e].z;
        acc.w += v[e].w;
      }
    }
    __syncwarp();  // this stage is refilled by the next tile's fetch
#pragma unroll
    for (int u = 0; u < S; ++u) {
      tr[u] = tr[u + 1];
      kjr[u] = kjr[u + 1];
      jir[u] = jir[u + 1];
    }
    load_ids(i + S + 1, tr[S], kjr[S], jir[S]);
  }
  cp_async_wait_all();
  flush(r_end);
}

__global__ void tri_reduce_partials_kernel(const float* __restrict__ partial,
                                           float* __restrict__ out,
                                           int n_parts, int size, int used) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= used) return;
  float v = 0.f;
  for (int q = 0; q < n_parts; ++q)
    v += partial[static_cast<size_t>(q) * size + j];
  out[j] = v;
}

template <typename Kernel>
int launch(Kernel kernel, int mode, const Params& p, dim3 grid,
           cudaStream_t st) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) *
      static_cast<size_t>(smem_floats(mode, p.sr, p.b, p.d));
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// route 1 of the forward or pass S: a persistent grid, every warp one
// share of the rows; about one warp a row at most
template <int MODE>
int launch_tc(const Params& p, int sms, cudaStream_t st) {
  const size_t smem = sizeof(float) *
      static_cast<size_t>(tc_smem_words(p.sr, p.d));
  int per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_tc_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fwd_tc_kernel<MODE>, kTcThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (p.n_rows + kTcWarps - 1) / kTcWarps;
  const int grid = min(sms * per_sm, blocks);
  fwd_tc_kernel<MODE><<<grid, kTcThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The size in floats of one weight-gradient partial (and of `wgrad`):
// [dK1 SR*B | dK2 B*D], padded to a multiple of 4.
extern "C" int hg_dn_tri_builder_wgrad_size(int sr, int b, int d) {
  return round4(sr * b + b * d);
}

// The forward's route at these widths on the current device: 1
// (fwd_tc_kernel: B <= 8, SR <= 64, D a multiple of 8), 2 (the first
// design), 0 when the device cannot be asked.
extern "C" int hg_dn_tri_builder_fwd_route(int sr, int b, int d) {
  int optin = 0;
  if (device_limits(&optin, nullptr) != cudaSuccess) return 0;
  return fwd_route(sr, b, d, optin);
}

// Pass S's route: 1 (fwd_tc_kernel<kPassS>: the forward's route 1 in kj
// order, at its widths, when d sbf is not asked for), 2 (the first
// design), 0 when the device cannot be asked.
extern "C" int hg_dn_tri_builder_bwd_s_route(int sr, int b, int d,
                                             int want_sbf) {
  int optin = 0;
  if (device_limits(&optin, nullptr) != cudaSuccess) return 0;
  return bwd_s_route(sr, b, d, want_sbf != 0, optin);
}

// One builder launch; returns the cudaError_t (0 = success).  mode 0: the
// forward (out [E, D]; rows are ji, positions in triplet order, `perm`
// null).  mode 1: pass S (rows are kj, positions through `perm`, the stable
// argsort of idx_kj; `out` is d_x [E, D] or null, `d_sbf` [T, SR]
// zero-filled or null).  mode 2: pass P (`row_ptr` the ji-order CSR;
// `partial` [n_parts, wgrad size] scratch, `wgrad` the reduced dK1, dK2;
// the grid is n_parts / ceil(B / 32) blocks by ceil(B / 32) slices).
// Pointers are device pointers; launches go on `stream` and do not
// synchronise.
extern "C" int hg_dn_tri_builder_f32(
    int mode, const void* x, const void* sbf, const void* w1, const void* w2,
    const void* kj, const void* ji, const void* perm, const void* row_ptr,
    const void* gout, void* out, void* d_sbf, void* partial, void* wgrad,
    int n_rows, int sr, int b, int d, int n_parts, void* stream) {
  if (n_rows <= 0) return 0;
  if (sr < 1 || sr > kMaxSR || b < 1 || b > kMaxB || d < 1 || d > kMaxD ||
      mode < kFwd || mode > kPassP ||
      (mode == kFwd && out == nullptr) ||
      (mode == kPassS && (gout == nullptr || perm == nullptr ||
                          (out == nullptr && d_sbf == nullptr))) ||
      (mode == kPassP && (gout == nullptr || partial == nullptr ||
                          wgrad == nullptr || n_parts < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.x = static_cast<const float*>(x);
  p.sbf = static_cast<const float*>(sbf);
  p.w1 = static_cast<const float*>(w1);
  p.w2 = static_cast<const float*>(w2);
  p.kj = static_cast<const int*>(kj);
  p.ji = static_cast<const int*>(ji);
  p.perm = static_cast<const int*>(perm);
  p.row_ptr = static_cast<const int*>(row_ptr);
  p.gout = static_cast<const float*>(gout);
  p.out = static_cast<float*>(out);
  p.d_sbf = static_cast<float*>(d_sbf);
  p.partial = static_cast<float*>(partial);
  p.n_rows = n_rows;
  p.sr = sr;
  p.b = b;
  p.d = d;
  p.n_chunks = (n_rows + kRows - 1) / kRows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode != kPassP) {
    int optin = 0, sms = 0;
    const cudaError_t err = device_limits(&optin, &sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (mode == kFwd)
      return fwd_route(sr, b, d, optin) == 1
          ? launch_tc<kFwd>(p, sms, st)
          : launch(tri_rows_kernel<kFwd>, kFwd, p, dim3(p.n_chunks), st);
    return bwd_s_route(sr, b, d, d_sbf != nullptr, optin) == 1
        ? launch_tc<kPassS>(p, sms, st)
        : launch(tri_rows_kernel<kPassS>, kPassS, p, dim3(p.n_chunks), st);
  }
  const int n_slices = (b + kSlice - 1) / kSlice;
  const int grid_x = n_parts / n_slices > 0 ? n_parts / n_slices : 1;
  const int rc = launch(tri_wgrad_kernel, kPassP, p, dim3(grid_x, n_slices),
                        st);
  if (rc != 0) return rc;
  const int size = hg_dn_tri_builder_wgrad_size(sr, b, d);
  tri_reduce_partials_kernel<<<(size + 255) / 256, 256, 0, st>>>(
      p.partial, static_cast<float*>(wgrad), grid_x, size, sr * b + b * d);
  return static_cast<int>(cudaGetLastError());
}
