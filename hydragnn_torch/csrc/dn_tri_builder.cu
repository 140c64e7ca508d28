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
// (:561) and pass S (:599).  Five kernels, one of them in two modes:
//
// fwd_tc_kernel<kFwd, SbfRows> — the forward, route 1
//   (hg_dn_tri_builder_fwd_route): B <= 8, SR <= 64 and D a multiple of 8,
//   DimeNet++'s QM9 widths (42, 8, 128) among them.  The kernel lives in
//   csrc/tri_tc.cuh, shared with the factored forward of dn_tri.cu: each
//   warp owns one run of output rows (passp::share_range) and walks its
//   triplets (positions in ji order are triplet ids) 16 at a time through
//   its own two-stage cp.async ring, both products on the tensor cores in
//   3xTF32 with a permuted k index, x[kj] * emb2 formed in place and added
//   into the warp's rows in triplet order.  Its A-operand loader here,
//   tritc::SbfRows, copies each triplet's stored sbf row: a tile's rows are
//   one contiguous block of device memory, brought in row by row with
//   8-byte cp.async (4-byte at an odd SR); the x[kj] rows with 16-byte
//   cp.async, 512 B a row at D = 128.
// fwd_tc_kernel<kPassS, SbfRows> — pass S, route 1
//   (hg_dn_tri_builder_bwd_s_route:
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
// wgtc::wgrad_tc_kernel (+ tri_reduce_partials_kernel) — the backward's
//   pass P, route 1 (hg_dn_tri_builder_bwd_p_route: the forward's route-1
//   widths), the weight gradients
//     dK2 = sum_t emb1_t^T d_emb2_t,   dK1 = sum_t sbf_t^T d_emb1_t
//   over the real triplets in ji order.  The forward's structure: each warp
//   of a persistent grid owns one share of the ji rows and walks its
//   triplets 16 at a time through its own two-stage cp.async ring (the
//   SbfRows loader for the sbf rows, 16-byte copies for x[kj]).  d_emb2 =
//   dout[ji] * x[kj] is formed in place in the x stage, each lane its four
//   columns times the triplet's dout row (an L1-cached load: triplets in
//   ji order share it for runs of about ten); emb1 = sbf.K1 and d_emb1 =
//   d_emb2.K2^T run in 3xTF32 as the forward's products (K2^T's split
//   fragments staged once per block in place of K2's).  The weight
//   gradients are edge-contracted products over the tile's triplets, held
//   in registers over the warp's whole share: dK2^T [D x 8] = d_emb2^T .
//   emb1 (D / 16 m16 tiles of one n8 tile, 32 floats a lane at D = 128) and
//   dK1 [SR padded to 16 x 8] = sbf^T . d_emb1 (12 floats a lane at SR =
//   42); their A^T operands load down the stage's columns, and emb1 and
//   d_emb1 reach them as B fragments through two 16 x 8 slots of the warp.
//   At the end each warp's entries go to its own region of the rings'
//   space, the block sums its warps in warp order into its partial, and
//   the reduce kernel sums the blocks in block order.
// tri_wgrad_kernel (+ tri_reduce_partials_kernel) — pass P, route 2 (every
//   other width), the first design.  K1, K2 and their gradients do not
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
#include "tri_tc.cuh"

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
// pass P, route 1: the forward's ring and products, the weight gradients in
// registers over each warp's share
// ---------------------------------------------------------------------------

namespace wgtc {

using tritc::kM;
using tritc::kStages;
using tritc::kWarps;
using tritc::kThreads;
using tritc::kFull;
constexpr int kLdSlot = 8;                  // emb1 and d_emb1 slots [16][8]
constexpr int kMaxMT1 = tritc::kMaxSR / 16;  // dK1's m16 tiles (SR <= 64)
constexpr int kMaxMT2 = kMaxD / 16;         // dK2^T's m16 tiles (D <= 128)

// an A fragment from four float32 values, split as passp::split_tc (lo
// passed untruncated: no conversion instruction), for the operands split
// anew at every use
__device__ __forceinline__ void set_a_tc(passp::FragA& a, float v0, float v1,
                                         float v2, float v3) {
  passp::split_tc(v0, a.hi[0], a.lo[0]);
  passp::split_tc(v1, a.hi[1], a.lo[1]);
  passp::split_tc(v2, a.hi[2], a.lo[2]);
  passp::split_tc(v3, a.hi[3], a.lo[3]);
}

// shared 32-bit words: K1's and K2^T's split fragments, each warp's ring,
// then each warp's two slots
__host__ __device__ inline int smem_words(int sr, int d) {
  return tritc::smem_words<tritc::SbfRows>(sr, d) + kWarps * 2 * kM * kLdSlot;
}

// route 1 at the forward's route-1 widths, when a block's shared memory
// (optin bytes) also holds the slots; 2 otherwise
__host__ inline int route(int sr, int b, int d, int optin) {
  const int slots = sizeof(float) * kWarps * 2 * kM * kLdSlot;
  return tritc::route<tritc::SbfRows>(sr, b, d, optin - slots);
}

__global__ void __launch_bounds__(kThreads, 1)
wgrad_tc_kernel(const tritc::Args p, tritc::SbfRows src, float* partial) {
  extern __shared__ float4 smem4[];
  const int sr = p.sr, b = p.b, d = p.d;
  const int ks = tritc::round8(sr) / 8, nt = d / 8;
  const int mt1 = (sr + 15) / 16, mt2 = (d + 15) / 16;
  const int ldx = passp::frag_ld(d);
  const int stage = tritc::stage_floats<tritc::SbfRows>(sr, d);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint4* k1f = reinterpret_cast<uint4*>(smem4);      // [ks][32]
  uint4* k2tf = k1f + ks * 32;                        // [nt][32]
  float* rings = reinterpret_cast<float*>(k2tf + nt * 32);
  float* ring = rings + warp * kStages * stage;
  float* e1s = rings + kWarps * kStages * stage + warp * 2 * kM * kLdSlot;
  float* de1s = e1s + kM * kLdSlot;
  src.init(sr, lane);

  // K1's fragments as the forward's: lane (g, t) of step s holds
  // K1[8s + 2t][g] and K1[8s + 2t + 1][g] (zero past SR or B), split
  for (int i = tid; i < ks * 32; i += kThreads) {
    const int s = i >> 5, l = i & 31, lg = l >> 2, r = 8 * s + 2 * (l & 3);
    const float v0 = r < sr && lg < b ? p.w1[r * b + lg] : 0.f;
    const float v1 = r + 1 < sr && lg < b ? p.w1[(r + 1) * b + lg] : 0.f;
    uint4 f;
    passp::split_ih(v0, f.x, f.z);
    passp::split_ih(v1, f.y, f.w);
    k1f[i] = f;
  }
  // K2^T's as a B operand (k = D, n = B), k permuted as d_emb2's columns:
  // lane (g, t) of step s holds K2[g][8s + 2t] and K2[g][8s + 2t + 1]
  for (int i = tid; i < nt * 32; i += kThreads) {
    const int s = i >> 5, l = i & 31, lg = l >> 2, c = 8 * s + 2 * (l & 3);
    const float v0 = lg < b ? p.w2[lg * d + c] : 0.f;
    const float v1 = lg < b ? p.w2[lg * d + c + 1] : 0.f;
    uint4 f;
    passp::split_ih(v0, f.x, f.z);
    passp::split_ih(v1, f.y, f.w);
    k2tf[i] = f;
  }
  for (int u = 0; u < kStages; ++u) src.zero(ring + u * stage, sr, lane);
  __syncthreads();

  int r_begin, r_end;
  passp::share_range(p.row_ptr, p.n_rows, blockIdx.x * kWarps + warp,
                     gridDim.x * kWarps, r_begin, r_end);
  const int p_begin = __ldg(p.row_ptr + r_begin);
  const int p_end = __ldg(p.row_ptr + r_end);
  const int n_tiles = (p_end - p_begin + kM - 1) / kM;

  // ids in lanes 0..15 as the forward's: positions in ji order are triplet
  // ids; a triplet is taken when kj is an edge and ji one of this warp's
  // rows
  auto load_ids = [&](int i, int& kj, int& ji) {
    const int pos = p_begin + i * kM + lane;
    const bool in = lane < kM && i < n_tiles && pos < p_end;
    kj = in ? __ldg(p.kj + pos) : -1;
    ji = in ? __ldg(p.ji + pos) : -1;
  };
  auto taken = [&](int kj, int ji) {
    return static_cast<unsigned>(kj) < static_cast<unsigned>(p.n_rows) &&
           ji >= r_begin && ji < r_end;
  };
  // tile i's sbf rows and x[kj] rows into a stage, as one group of copies
  auto fetch = [&](int i, int kj, int ji, float* st) {
    const int q = p_begin + i * kM;
    const int cnt = min(kM, p_end - q);
    float* xb = st + tritc::SbfRows::floats(sr);
#pragma unroll
    for (int e = 0; e < kM; ++e) {
      const int k = __shfl_sync(kFull, kj, e);
      const int j = __shfl_sync(kFull, ji, e);
      if (e < cnt) {
        const bool take = taken(k, j);
        src.row(st, sr, tritc::kFwd, e, q + e, k, take, lane);
        if (take && 4 * lane < d)
          tritc::cp_async16(xb + e * ldx + 4 * lane,
                            p.x + static_cast<size_t>(k) * d + 4 * lane);
      }
    }
    tritc::cp_async_commit();
  };

  // the weight gradients over the warp's share: dK2^T [D x 8] in mt2 m16
  // tiles, dK1 [SR x 8] in mt1; row r of tile m is row 16 m + 2 (r % 8) +
  // r / 8 (rows past D or SR are never written out)
  float acc2[kMaxMT2][4], acc1[kMaxMT1][4];
#pragma unroll
  for (int m = 0; m < kMaxMT2; ++m)
    acc2[m][0] = acc2[m][1] = acc2[m][2] = acc2[m][3] = 0.f;
#pragma unroll
  for (int m = 0; m < kMaxMT1; ++m)
    acc1[m][0] = acc1[m][1] = acc1[m][2] = acc1[m][3] = 0.f;

  constexpr int S = kStages;
  int kjr[S + 1], jir[S + 1];
#pragma unroll
  for (int u = 0; u <= S; ++u) load_ids(u, kjr[u], jir[u]);
#pragma unroll
  for (int u = 0; u + 1 < S; ++u) {
    if (u < n_tiles)
      fetch(u, kjr[u], jir[u], ring + u * stage);
    else
      tritc::cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    float* st = ring + (i % S) * stage;
    const int cnt = min(kM, p_end - (p_begin + i * kM));
    const unsigned use =
        __ballot_sync(kFull, lane < cnt && taken(kjr[0], jir[0])) & 0xffffu;
    // this tile's dout[ji] rows, four columns a lane, in flight through the
    // next tile's fetch and this one's wait (zero for rows of no real
    // triplet; triplets in ji order share rows, so most come from L1)
    float4 gv[kM];
#pragma unroll
    for (int e = 0; e < kM; ++e) {
      const int j = __shfl_sync(kFull, jir[0], e);
      gv[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (((use >> e) & 1u) && 4 * lane < d)
        gv[e] = __ldg(reinterpret_cast<const float4*>(
            p.gout + static_cast<size_t>(j) * d + 4 * lane));
    }
    const int ahead = i + S - 1;
    if (ahead < n_tiles)
      fetch(ahead, kjr[S - 1], jir[S - 1], ring + (ahead % S) * stage);
    else
      tritc::cp_async_commit();
    tritc::cp_async_wait<S - 1>();
    __syncwarp();
    float* xb = st + tritc::SbfRows::floats(sr);
    // rows of no real triplet: sbf zero (stale or not taken), d_emb2 zero
    if (use != 0xffffu) {
      for (int e = 0; e < kM; ++e)
        if (!((use >> e) & 1u))
          for (int c = lane; c < sr; c += 32) st[e * src.lds + c] = 0.f;
    }
    // d_emb2 = dout[ji] * x[kj] in place in the x stage
#pragma unroll
    for (int e = 0; e < kM; ++e) {
      if (4 * lane < d) {
        float4* xp = reinterpret_cast<float4*>(xb + e * ldx + 4 * lane);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if ((use >> e) & 1u) {
          const float4 xv = *xp;
          v = make_float4(xv.x * gv[e].x, xv.y * gv[e].y, xv.z * gv[e].z,
                          xv.w * gv[e].w);
        }
        *xp = v;
      }
    }
    // emb1 = sbf . K1, the forward's product
    float e1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < tritc::kMaxSR / 8; ++s) {
      if (s < ks) {
        passp::FragA a;
        src.frag(a, st, s, g, t);
        const uint4 f = k1f[s * 32 + lane];
        passp::FragB bf;
        bf.hi[0] = f.x; bf.hi[1] = f.y; bf.lo[0] = f.z; bf.lo[1] = f.w;
        passp::mma3(e1, a, bf);
      }
    }
    __syncwarp();   // every lane's d_emb2 columns are in the stage
    // d_emb1 = d_emb2 . K2^T over D / 8 k steps (k permuted as K2^T's
    // fragments)
    float de1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < kMaxD / 8; ++s) {
      if (s < nt) {
        const float2 u0 =
            *reinterpret_cast<const float2*>(xb + g * ldx + 8 * s + 2 * t);
        const float2 u1 = *reinterpret_cast<const float2*>(
            xb + (g + 8) * ldx + 8 * s + 2 * t);
        passp::FragA a;
        set_a_tc(a, u0.x, u1.x, u0.y, u1.y);
        const uint4 f = k2tf[s * 32 + lane];
        passp::FragB bf;
        bf.hi[0] = f.x; bf.hi[1] = f.y; bf.lo[0] = f.z; bf.lo[1] = f.w;
        passp::mma3(de1, a, bf);
      }
    }
    // emb1 and d_emb1 into their slots, to be read as B fragments
    *reinterpret_cast<float2*>(e1s + g * kLdSlot + 2 * t) =
        make_float2(e1[0], e1[1]);
    *reinterpret_cast<float2*>(e1s + (g + 8) * kLdSlot + 2 * t) =
        make_float2(e1[2], e1[3]);
    *reinterpret_cast<float2*>(de1s + g * kLdSlot + 2 * t) =
        make_float2(de1[0], de1[1]);
    *reinterpret_cast<float2*>(de1s + (g + 8) * kLdSlot + 2 * t) =
        make_float2(de1[2], de1[3]);
    __syncwarp();
    // dK2^T += d_emb2^T . emb1 and dK1 += sbf^T . d_emb1, contracted over
    // the tile's 16 triplets (two k steps).  The A^T operands read down the
    // stage's columns, an m16 tile's rows g and g + 8 being the columns 2g
    // and 2g + 1 of its 16: one float2 a lane a k row, in 32 banks a
    // half-warp
#pragma unroll
    for (int kk = 0; kk < kM; kk += 8) {
      passp::FragB b2, b1;
      passp::split_ih(e1s[(kk + t) * kLdSlot + g], b2.hi[0], b2.lo[0]);
      passp::split_ih(e1s[(kk + t + 4) * kLdSlot + g], b2.hi[1], b2.lo[1]);
      passp::split_ih(de1s[(kk + t) * kLdSlot + g], b1.hi[0], b1.lo[0]);
      passp::split_ih(de1s[(kk + t + 4) * kLdSlot + g], b1.hi[1], b1.lo[1]);
      const float* x0 = xb + (kk + t) * ldx + 2 * g;
      const float* x1 = xb + (kk + t + 4) * ldx + 2 * g;
#pragma unroll
      for (int m = 0; m < kMaxMT2; ++m) {
        if (m < mt2) {
          const float2 u0 = *reinterpret_cast<const float2*>(x0 + 16 * m);
          const float2 u1 = *reinterpret_cast<const float2*>(x1 + 16 * m);
          passp::FragA a;
          set_a_tc(a, u0.x, u0.y, u1.x, u1.y);
          passp::mma3(acc2[m], a, b2);
        }
      }
      const float* s0 = st + (kk + t) * src.lds + 2 * g;
      const float* s1 = st + (kk + t + 4) * src.lds + 2 * g;
#pragma unroll
      for (int m = 0; m < kMaxMT1; ++m) {
        if (m < mt1) {
          const float2 u0 = *reinterpret_cast<const float2*>(s0 + 16 * m);
          const float2 u1 = *reinterpret_cast<const float2*>(s1 + 16 * m);
          passp::FragA a;
          set_a_tc(a, u0.x, u0.y, u1.x, u1.y);
          passp::mma3(acc1[m], a, b1);
        }
      }
    }
    __syncwarp();  // this stage and the slots are refilled next
#pragma unroll
    for (int u = 0; u < S; ++u) {
      kjr[u] = kjr[u + 1];
      jir[u] = jir[u + 1];
    }
    load_ids(i + S + 1, kjr[S], jir[S]);
  }
  tritc::cp_async_wait_all();
  __syncthreads();  // every warp is done with its ring

  // each warp's gradients into its own region of the rings' space, in the
  // packed layout [dK1 SR*B | dK2 B*D]; then the block's partial, the
  // warps summed in warp order, every entry written once
  const int size = sr * b + b * d;
  float* mine = rings + warp * size;
#pragma unroll
  for (int m = 0; m < kMaxMT2; ++m) {
    if (m < mt2) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = 16 * m + 2 * g + (v >> 1), c = 2 * t + (v & 1);
        if (r < d && c < b) mine[sr * b + c * d + r] = acc2[m][v];
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kMaxMT1; ++m) {
    if (m < mt1) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = 16 * m + 2 * g + (v >> 1), c = 2 * t + (v & 1);
        if (r < sr && c < b) mine[r * b + c] = acc1[m][v];
      }
    }
  }
  __syncthreads();
  float* dst = partial + static_cast<size_t>(round4(size)) * blockIdx.x;
  for (int j = tid; j < size; j += kThreads) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += rings[w * size + j];
    dst[j] = v;
  }
}

}  // namespace wgtc

// the forward's route 1 (tri_tc.cuh's fwd_tc_kernel with the stored sbf
// rows) at these widths, when a block's shared memory (optin bytes) holds
// it; 2 otherwise
__host__ inline int fwd_route(int sr, int b, int d, int optin) {
  return tritc::route<tritc::SbfRows>(sr, b, d, optin);
}

// pass P's route 1 (wgtc::wgrad_tc_kernel) at the forward's route-1 widths,
// when a block's shared memory (optin bytes) holds it; 2 otherwise
__host__ inline int bwd_p_route(int sr, int b, int d, int optin) {
  return wgtc::route(sr, b, d, optin);
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

// route 1 of the forward or pass S: tri_tc.cuh's kernel on the stored sbf
// rows
template <int MODE>
int launch_tc(const Params& p, int sms, cudaStream_t st) {
  tritc::Args a;
  a.x = p.x;
  a.gout = p.gout;
  a.w1 = p.w1;
  a.w2 = p.w2;
  a.kj = p.kj;
  a.ji = p.ji;
  a.perm = p.perm;
  a.row_ptr = p.row_ptr;
  a.out = p.out;
  a.n_rows = p.n_rows;
  a.sr = p.sr;
  a.b = p.b;
  a.d = p.d;
  tritc::SbfRows src;
  src.sbf = p.sbf;
  src.lds = 0;
  return tritc::launch<MODE>(a, src, sms, st);
}

// pass P's route 1: a persistent grid of at most n_parts blocks, every warp
// one share of the ji rows; the number of blocks (the partials written)
// goes to *grid
int launch_wgrad_tc(const Params& p, int sms, int n_parts, int* grid,
                    cudaStream_t st) {
  tritc::Args a{};
  a.x = p.x;
  a.gout = p.gout;
  a.w1 = p.w1;
  a.w2 = p.w2;
  a.kj = p.kj;
  a.ji = p.ji;
  a.row_ptr = p.row_ptr;
  a.n_rows = p.n_rows;
  a.sr = p.sr;
  a.b = p.b;
  a.d = p.d;
  tritc::SbfRows src;
  src.sbf = p.sbf;
  src.lds = 0;
  const size_t smem = sizeof(float) *
      static_cast<size_t>(wgtc::smem_words(p.sr, p.d));
  int per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      wgtc::wgrad_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, wgtc::wgrad_tc_kernel, wgtc::kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (p.n_rows + wgtc::kWarps - 1) / wgtc::kWarps;
  *grid = min(min(sms * per_sm, n_parts), blocks);
  wgtc::wgrad_tc_kernel<<<*grid, wgtc::kThreads, smem, st>>>(a, src,
                                                            p.partial);
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

// Pass P's route at these widths: 1 (wgrad_tc_kernel: the forward's
// route-1 widths, weight gradients in registers), 2 (the first design,
// tri_wgrad_kernel), 0 when the device cannot be asked.
extern "C" int hg_dn_tri_builder_bwd_p_route(int sr, int b, int d) {
  int optin = 0;
  if (device_limits(&optin, nullptr) != cudaSuccess) return 0;
  return bwd_p_route(sr, b, d, optin);
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
// route 1 runs at most n_parts blocks, route 2 n_parts / ceil(B / 32)
// blocks by ceil(B / 32) slices).  `route` (pass P): 0 takes the widths'
// own (hg_dn_tri_builder_bwd_p_route), 1 or 2 that one where the widths
// admit it; the forward and pass S take route 0.  Pointers are device
// pointers; launches go on `stream` and do not synchronise.
extern "C" int hg_dn_tri_builder_f32(
    int mode, const void* x, const void* sbf, const void* w1, const void* w2,
    const void* kj, const void* ji, const void* perm, const void* row_ptr,
    const void* gout, void* out, void* d_sbf, void* partial, void* wgrad,
    int n_rows, int sr, int b, int d, int n_parts, int route, void* stream) {
  if (n_rows <= 0) return 0;
  if (sr < 1 || sr > kMaxSR || b < 1 || b > kMaxB || d < 1 || d > kMaxD ||
      mode < kFwd || mode > kPassP || route < 0 || route > 2 ||
      (mode != kPassP && route != 0) ||
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
  int optin = 0, sms = 0;
  const cudaError_t err = device_limits(&optin, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (mode != kPassP) {
    if (mode == kFwd)
      return fwd_route(sr, b, d, optin) == 1
          ? launch_tc<kFwd>(p, sms, st)
          : launch(tri_rows_kernel<kFwd>, kFwd, p, dim3(p.n_chunks), st);
    return bwd_s_route(sr, b, d, d_sbf != nullptr, optin) == 1
        ? launch_tc<kPassS>(p, sms, st)
        : launch(tri_rows_kernel<kPassS>, kPassS, p, dim3(p.n_chunks), st);
  }
  const int own = bwd_p_route(sr, b, d, optin);
  if (route == 0) route = own;
  if (route == 1 && own != 1) return static_cast<int>(cudaErrorInvalidValue);
  int grid_x = 0, rc = 0;
  if (route == 1) {
    rc = launch_wgrad_tc(p, sms, n_parts, &grid_x, st);
  } else {
    const int n_slices = (b + kSlice - 1) / kSlice;
    grid_x = n_parts / n_slices > 0 ? n_parts / n_slices : 1;
    rc = launch(tri_wgrad_kernel, kPassP, p, dim3(grid_x, n_slices), st);
  }
  if (rc != 0) return rc;
  const int size = hg_dn_tri_builder_wgrad_size(sr, b, d);
  tri_reduce_partials_kernel<<<(size + 255) / 256, 256, 0, st>>>(
      p.partial, static_cast<float*>(wgrad), grid_x, size, sr * b + b * d);
  return static_cast<int>(cudaGetLastError());
}
