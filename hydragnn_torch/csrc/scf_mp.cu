// Hand-written Hopper (sm_90a) kernels for SchNet's fused edge pipeline
//
//   filt_e = (ssp(rbf_e . W0 + b0) . W1 + b1) * cm_e
//   out[n] = sum_{e: recv[e]=n} h[send_e] * filt_e
//
// Plain C interface, loaded with ctypes by hydragnn_torch/kernels/build.py;
// wrappers, plain PyTorch versions and launch counters live in
// hydragnn_torch/ops/scf_mp.py.  Float32 throughout; W0 [G,F] and W1 [F,F]
// are [in, out].
//
// The forward AND pass S — one kernel in two modes, two routes by width
//   Replaces hydragnn_tpu/ops/fused_block.py:_fused_fwd with the scf spec
//   (pl.pallas_call at :495) and :_fused_bwd pass S (_bwd_s_kernel,
//   pl.pallas_call at :599).  Forward: positions are edge ids in receiver
//   order, x = h, gidx = senders.  Pass S: positions map to edge ids
//   through the sender permutation, rows are senders, x = the output
//   cotangent, gidx = receivers — dh[n] = sum_{e: send[e]=n} g[recv[e]] *
//   filt_e.  hg_scf_fwd_route picks the route.
//   Bound: operations (G*F + F*F multiply-adds per edge against ~1 KB of
//   edge and node bytes): 2 E (G F + F^2) flops, 20.6 GFLOP at the wide
//   SchNet's first batch.
// scf_fg_tc_kernel — route 1: F a multiple of 8 up to 256, G <= 64 (the
//   wide SchNet's 256, 50).  A persistent grid, one block per SM, each on
//   a share of the rows (passp::share_range: rows plus edges balanced, no
//   second partial wave), walking its positions 64 edges at a time.  Both
//   products run on the tensor cores in 3xTF32 (pass_p.cuh's fragments
//   and mma3; the lo half of each operand passed untruncated, split_tc):
//   t0 = rbf.W0 + b0, a = ssp(t0) into shared memory, f2 = a.W1 + b1, the
//   accumulators in registers (8 warps, each all 64 rows by 32 columns).
//   W1 (256 KB at F = 256) does not fit a block, so W0 and W1
//   stream through a two-stage cp.async ring of 32-row chunks, the same
//   stream every tile: the weights are read from L2 once per 64 edges, not
//   per 32, ~0.67 GB a launch at the wide cell's first batch (the first
//   design read ~1.3 GB).  Each tile's x[gidx] rows (16-byte cp.async) are
//   copied when it begins and the next tile's rbf rows when its t0 is
//   done, each in the group of a weight chunk; the ids wait one tile ahead
//   in shared memory and two in registers.  After the last chunk each
//   accumulator's owner forms x[gidx] * (f2 * cm) in place of a, and
//   thread c adds column c of the messages into the current row in edge
//   order, writing each row once (rows without edges as zeros).
// scf_filter_gather_kernel — route 2 (the first design; every other width
//   up to F = 1024, G = 127).  One thread block owns kRowsPerCta output
//   rows and walks their CSR range of edge positions in order, TE edges at
//   a time: it recomputes t0 = rbf.W0 + b0 and a = ssp(t0) into shared
//   memory, then f2 = a.W1 + b1 (W1 streamed column by column from L2),
//   and adds f2 * cm * x[gidx[e]] into the block's rows in shared memory,
//   in edge order; float32 on the CUDA cores, per-edge tiles transposed in
//   shared memory so one 16-byte load feeds four multiply-adds.
//
// scf_pass_p_kernel (+ the reductions of pass_p.cuh) — backward pass P
//   Replaces :_fused_bwd pass P (_bwd_p_kernel, pl.pallas_call at :561).
//   With dfilt = g[recv] * h[send] (zero on invalid edges), u = dfilt.W1^T:
//     dt0 = cm * u * sigmoid(t0), db0 = sum_e dt0, dW0 = rbf^T dt0,
//     dW1 = (cm * a)^T dfilt, db1 = sum_e cm * dfilt  (a = ssp(t0)),
//     dcm = sum_k a*u + sum_c b1*dfilt (= sum_f dfilt * f2, f2 never formed),
//     drbf = dt0 . W0^T.
//   Bound: operations, 2F^2 + 2GF multiply-adds per edge (~1.6e5 flops at
//   F = 256, G = 50, against ~1 KB of edge bytes).  Design: the grid is
//   (edge share p, slice j of W columns of t0); block (p, j) walks its share
//   of the receiver-order edges TE at a time and computes only its slice:
//   t0[:, j] (rbf . W0[:, j]), u[:, j] (dfilt . W1[j, :]^T), dt0[:, j], and
//   accumulates dW1[j, :] (W x F), dW0[:, j], db0[j], db1[j] in registers
//   over the whole share, written once at the end: no read-modify-write of
//   a partial per tile.  The slice's W1 rows and W0 columns are staged in
//   shared memory once per block, and each tile's ids are loaded during
//   the tile before it.  All four products run on the tensor cores in
//   3xTF32 (pass_p.cuh: each k step's products from zero, then a
//   float32 add; the bias sums compensated).  W x F <= 16384 floats
//   bounds the register accumulator: W = 64 for F <= 256, 32 for F <= 512,
//   16 for F <= 1024; TE = W, or 32 at W = 64 when G is wide enough that
//   the tiles would pass 227 KB.  dcm and drbf (asked only with a gradient
//   of rbf or cm: not on the energy-only training path) are written as
//   per-slice partials and summed in slice order.  Block (p, j) writes its
//   columns of the weight gradients straight into part p's partial in the
//   packed layout [dW0 | db0 | dW1 | db1] (the slices' columns are
//   disjoint), and the reduce kernel sums the parts in order.
//
// Contract (collate guarantees it): positions are sorted by output row, so
// each row owns one contiguous CSR range; masked edges sort last and are
// parked out of every range by the wrapper, so they are never read and
// every grad on them is exactly zero (the wrapper zero-fills drbf/dcm).
// Gather ids outside [0, n_rows) contribute nothing.  Determinism: every
// sum runs in a fixed order (edge order within a row; tile order, then
// part order, then slice order for the weight and per-edge grads); no
// atomics.  Every output row is written, rows without edges as zeros.

#include <cuda_runtime.h>

#include <cstdint>

#include "pass_p.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxF = 1024;
constexpr int kMaxG = 127;
constexpr int kRowsPerCta = 16;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ssp(float x) {
  // softplus(x) - ln 2 with softplus(x) = max(x, 0) + log1p(exp(-|x|))
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))) - kLn2;
}

// a = ssp(x) and s = sigmoid(x) from one exp(-|x|)
__device__ __forceinline__ void ssp_logistic(float x, float& a, float& s) {
  const float z = expf(-fabsf(x));
  a = fmaxf(x, 0.f) + log1pf(z) - kLn2;
  const float r = 1.f / (1.f + z);
  s = x >= 0.f ? r : z * r;
}

// acc[e] += sum_k tile_t[k][e] * w[k*ld + c] over k < kdim: tile_t is a
// transposed [kdim][TE+4] shared tile, w is read down column c
template <int TE>
__device__ __forceinline__ void tile_times_column(
    float (&acc)[TE], const float* tile_t, const float* __restrict__ w,
    int kdim, int ld, int c) {
  constexpr int LDT = TE + 4;
  for (int k = 0; k < kdim; ++k) {
    const float wk = w[static_cast<size_t>(k) * ld + c];
    const float4* row = reinterpret_cast<const float4*>(tile_t + k * LDT);
#pragma unroll
    for (int q = 0; q < TE / 4; ++q) {
      const float4 v = row[q];
      acc[4 * q + 0] += v.x * wk;
      acc[4 * q + 1] += v.y * wk;
      acc[4 * q + 2] += v.z * wk;
      acc[4 * q + 3] += v.w * wk;
    }
  }
}

template <int TE>
__device__ __forceinline__ void store_row(float* row_t, const float (&v)[TE]) {
  float4* row = reinterpret_cast<float4*>(row_t);
#pragma unroll
  for (int q = 0; q < TE / 4; ++q)
    row[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

template <int TE>
size_t filter_gather_smem(int f, int g) {
  return sizeof(float) * (static_cast<size_t>(g) * (TE + 4) +
                          static_cast<size_t>(f) * (TE + 4) +
                          static_cast<size_t>(kRowsPerCta) * f + TE) +
         sizeof(int) * 3 * TE;
}

template <int TE>
__global__ void __launch_bounds__(kThreads)
scf_filter_gather_kernel(const float* __restrict__ x,
                         const float* __restrict__ rbf,
                         const float* __restrict__ cm,
                         const int* __restrict__ gidx,
                         const int* __restrict__ rowid,
                         const int* __restrict__ perm,
                         const int* __restrict__ row_ptr,
                         const float* __restrict__ w0,
                         const float* __restrict__ b0,
                         const float* __restrict__ w1,
                         const float* __restrict__ b1,
                         float* __restrict__ out,
                         int n_rows, int f, int g) {
  constexpr int LDT = TE + 4;
  extern __shared__ float4 smem4[];
  float* rbf_t = reinterpret_cast<float*>(smem4);  // [g][LDT]
  float* a_t = rbf_t + g * LDT;                     // [f][LDT]  ssp(t0)
  float* out_s = a_t + f * LDT;                     // [kRowsPerCta][f]
  float* cm_s = out_s + kRowsPerCta * f;            // [TE]
  int* eid_s = reinterpret_cast<int*>(cm_s + TE);   // [TE]
  int* src_s = eid_s + TE;                          // [TE]
  int* row_s = src_s + TE;                          // [TE]

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kRowsPerCta;
  const int r1 = min(r0 + kRowsPerCta, n_rows);
  const int e_begin = row_ptr[r0];
  const int e_end = row_ptr[r1];
  for (int i = tid; i < kRowsPerCta * f; i += kThreads) out_s[i] = 0.f;

  for (int t = e_begin; t < e_end; t += TE) {
    const int cnt = min(TE, e_end - t);
    __syncthreads();  // out_s zeroed; the previous tile's readers are done
    if (tid < TE) {
      int eid = -1, s = -1, r = r0;
      float c = 0.f;
      if (tid < cnt) {
        const int pos = t + tid;
        eid = perm != nullptr ? perm[pos] : pos;
        s = gidx[eid];
        r = rowid[eid];
        c = cm[eid];
        if (static_cast<unsigned>(s) >= static_cast<unsigned>(n_rows)) s = -1;
      }
      eid_s[tid] = eid;
      src_s[tid] = s;
      row_s[tid] = r - r0;
      cm_s[tid] = c;
    }
    __syncthreads();
    for (int i = tid; i < TE * g; i += kThreads) {
      const int e = i / g, k = i - e * g;
      const int eid = eid_s[e];
      rbf_t[k * LDT + e] =
          eid >= 0 ? rbf[static_cast<size_t>(eid) * g + k] : 0.f;
    }
    __syncthreads();
    // a = ssp(rbf . W0 + b0), one column per thread
    for (int c = tid; c < f; c += kThreads) {
      float acc[TE];
      const float bc = b0[c];
#pragma unroll
      for (int e = 0; e < TE; ++e) acc[e] = bc;
      tile_times_column<TE>(acc, rbf_t, w0, g, f, c);
#pragma unroll
      for (int e = 0; e < TE; ++e) acc[e] = ssp(acc[e]);
      store_row<TE>(a_t + c * LDT, acc);
    }
    __syncthreads();
    // f2 = a . W1 + b1; rows += f2 * cm * x[gidx], in edge order
    for (int c = tid; c < f; c += kThreads) {
      float acc[TE];
      const float bc = b1[c];
#pragma unroll
      for (int e = 0; e < TE; ++e) acc[e] = bc;
      tile_times_column<TE>(acc, a_t, w1, f, f, c);
#pragma unroll
      for (int e = 0; e < TE; ++e) {
        if (e < cnt) {
          const int s = src_s[e];
          if (s >= 0)
            out_s[row_s[e] * f + c] +=
                x[static_cast<size_t>(s) * f + c] * (acc[e] * cm_s[e]);
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < (r1 - r0) * f; i += kThreads)
    out[static_cast<size_t>(r0) * f + i] = out_s[i];
}


// ---------------------------------------------------------------------------
// the forward and pass S, route 1: tensor cores, a ring of weight chunks, a
// persistent grid balanced by rows plus edges
// ---------------------------------------------------------------------------

constexpr int kTcM = 64;        // edges per tile
constexpr int kTcKC = 32;       // weight rows per ring stage: four k steps
constexpr int kTcStages = 2;    // ring stages
constexpr int kTcMaxF = 256;    // route 1: F a multiple of 8 up to 256
                                //   (8 warps x 32 columns), G <= 64
constexpr int kTcMaxG = 64;

// dst (shared) = 16 bytes of src (global), or zeros when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(a), "l"(src), "r"(valid ? 16 : 0));
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

// shared memory of a route-1 block, in floats
struct FgLayout {
  int g8;     // the t0 product's depth: G rounded up to 8
  int lda;    // row stride of the a and x tiles: frag_ld(F)
  int ldr;    // row stride of the rbf tile: frag_ld(g8)
  int ldw;    // row stride of a weight chunk: F + 4, so that a B
              // fragment's rows 2t and 2t + 1 fall on 32 banks
  int c0, c1;  // chunks of W0 (rows zero past G) and of W1 in a tile
  int as, xs, rs, ring, b0s, b1s, ids, floats;
};

__host__ __device__ inline FgLayout fg_layout(int f, int g) {
  FgLayout L;
  L.g8 = (g + 7) / 8 * 8;
  L.lda = passp::frag_ld(f);
  L.ldr = passp::frag_ld(L.g8);
  L.ldw = f + 4;
  L.c0 = (L.g8 + kTcKC - 1) / kTcKC;
  L.c1 = (f + kTcKC - 1) / kTcKC;
  int o = 0;
  L.as = o; o += kTcM * L.lda;                   // a = ssp(t0), then msg
  L.xs = o; o += kTcM * L.lda;                   // x[gidx] rows
  L.rs = o; o += kTcM * L.ldr;                   // rbf rows
  L.ring = o; o += kTcStages * kTcKC * L.ldw;    // weight chunks
  L.b0s = o; o += f;
  L.b1s = o; o += f;
  L.ids = o; o += 2 * 4 * kTcM;                  // two tiles' ids
  L.floats = o;
  return L;
}

// route 1 (scf_fg_tc_kernel) at these widths when a block's shared memory
// (optin bytes) holds it, 2 (scf_filter_gather_kernel) otherwise
inline int fwd_route(int f, int g, int optin) {
  return f % 8 == 0 && f <= kTcMaxF && g >= 1 &&
                 g <= kTcMaxG &&
                 sizeof(float) * static_cast<size_t>(fg_layout(f, g).floats)
                     <= static_cast<size_t>(optin)
             ? 1
             : 2;
}

struct FgArgs {
  const float* x;       // [N, F] forward: h; pass S: the cotangent
  const float* rbf;     // [E, G]
  const float* cm;      // [E]
  const int* gidx;      // [E] gathered rows
  const int* rowid;     // [E] output rows
  const int* perm;      // [E] position -> edge, or null (identity)
  const int* row_ptr;   // [N + 1] CSR over positions
  const float* w0;      // [G, F]
  const float* b0;      // [F]
  const float* w1;      // [F, F]
  const float* b1;      // [F]
  float* out;           // [N, F]
  int n_rows, f, g;
};

// The grid is one block per SM; block b owns the rows of share b
// (passp::share_range over the CSR: rows plus edges balanced) and walks
// their positions kTcM at a time.  Per tile, t0 = rbf . W0 + b0 and then
// f2 = ssp(t0) . W1 + b1 run as [64 x K] . [K x F] products on the tensor
// cores in 3xTF32, warp w owning columns 32w .. 32w + 31 (a 4 x 4 grid of
// m16n8 accumulators); the weights stream through a ring of kTcStages
// chunks of kTcKC rows (W0's chunks, then W1's, the same stream every
// tile), one barrier a chunk.  A's and B's k index is permuted within each
// 8-wide step (the A fragment's slots t, t + 4 hold columns 2t, 2t + 1:
// one float2 load a row), both split hi/lo as they are loaded (split_tc).
// After the last chunk each accumulator's owner forms x[gidx] * (f2 * cm)
// into the a tile, and each thread c < F adds its column of the messages
// into the current row in edge order, writing a row when the next begins
// (rows without edges as zeros).  The ids of tile i +
// 1 wait in shared memory and those of tile i + 2 in registers; tile i's
// x[gidx] rows are copied when it begins and tile i + 1's rbf rows when
// tile i's t0 is done, each in the group of a weight chunk.
__global__ void __launch_bounds__(kThreads, 1)
scf_fg_tc_kernel(const FgArgs p) {
  using namespace passp;
  constexpr int M = kTcM, KC = kTcKC, S = kTcStages;
  const int f = p.f, g = p.g;
  const FgLayout L = fg_layout(f, g);
  const int lda = L.lda, ldr = L.ldr, ldw = L.ldw;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* as = sm + L.as;
  float* xs = sm + L.xs;
  float* rs = sm + L.rs;
  float* ring = sm + L.ring;
  float* b0s = sm + L.b0s;
  float* b1s = sm + L.b1s;
  // slot (i & 1) holds tile i's edge ids, gathered rows, output rows (-1
  // where the gathered row is out of range), cm
  int* ids = reinterpret_cast<int*>(sm + L.ids);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int gq = lane_g(), tq = lane_t();
  const int n0 = 32 * warp;     // this warp's first column

  int r_begin, r_end;           // every warp finds the block's share
  share_range(p.row_ptr, p.n_rows, blockIdx.x, gridDim.x, r_begin, r_end);
  if (r_begin >= r_end) return;
  const int p_begin = __ldg(p.row_ptr + r_begin);
  const int p_end = __ldg(p.row_ptr + r_end);
  const int n_tiles = (p_end - p_begin + M - 1) / M;
  const int cpt = L.c0 + L.c1;
  const int n_chunks = n_tiles * cpt;
  const int f4 = f / 4;

  for (int i = tid; i < f; i += kThreads) {
    b0s[i] = p.b0[i];
    b1s[i] = p.b1[i];
  }
  // the rbf tile's columns [G, g8): zero, never written again
  for (int i = tid; i < M * (L.g8 - g); i += kThreads) {
    const int e = i / (L.g8 - g);
    rs[e * ldr + g + i - e * (L.g8 - g)] = 0.f;
  }

  // ids of one tile in threads tid < M: position p_begin + M i + tid ->
  // the edge, its gathered row and its output row (both -1 when the
  // gathered row is out of range), cm
  int eid_n = -1, src_n = -1, row_n = -1;
  float cm_n = 0.f;
  auto load_ids = [&](int i) {
    const int pos = p_begin + i * M + tid;
    const bool in = tid < M && i < n_tiles && pos < p_end;
    eid_n = in ? (p.perm != nullptr ? __ldg(p.perm + pos) : pos) : -1;
    const int s = in ? __ldg(p.gidx + eid_n) : -1;
    src_n = static_cast<unsigned>(s) < static_cast<unsigned>(p.n_rows) ? s
                                                                       : -1;
    row_n = src_n >= 0 ? __ldg(p.rowid + eid_n) : -1;
    cm_n = in ? __ldg(p.cm + eid_n) : 0.f;
  };
  auto store_ids = [&](int i) {
    if (tid < M) {
      int* sl = ids + (i & 1) * 4 * M;
      sl[tid] = eid_n;
      sl[M + tid] = src_n;
      sl[2 * M + tid] = row_n;
      reinterpret_cast<float*>(sl)[3 * M + tid] = cm_n;
    }
  };
  auto tile_edges = [&](int i) { return min(M, p_end - (p_begin + i * M)); };
  // chunk q of the weight stream into its stage: W0's rows (zeros past G,
  // which meet the rbf tile's zero columns), then W1's
  auto fetch_chunk = [&](int q) {
    const int c = q % cpt;
    const bool first = c < L.c0;
    const float* w = first ? p.w0 : p.w1;
    const int r0 = (first ? c : c - L.c0) * KC, rows = first ? g : f;
    float* st = ring + (q % S) * KC * ldw;
    for (int i = tid; i < KC * f4; i += kThreads) {
      const int r = i / f4, c4 = 4 * (i - r * f4);
      const bool ok = r0 + r < rows;
      cp_async16(st + r * ldw + c4,
                 w + static_cast<size_t>(ok ? r0 + r : 0) * f + c4, ok);
    }
  };
  // tile i's x[gidx] rows (none for a gathered row out of range: never
  // read)
  auto fetch_x = [&](int i) {
    const int* sl = ids + (i & 1) * 4 * M;
    for (int k = tid; k < tile_edges(i) * f4; k += kThreads) {
      const int e = k / f4, c4 = 4 * (k - e * f4);
      const int s = sl[M + e];
      if (s >= 0)
        cp_async16(xs + e * lda + c4, p.x + static_cast<size_t>(s) * f + c4,
                   true);
    }
  };
  // tile i's rbf rows (the forward: one contiguous block; pass S: each
  // edge's own), 8-byte pieces at an even G
  auto fetch_rbf = [&](int i) {
    const int* sl = ids + (i & 1) * 4 * M;
    const int cnt = tile_edges(i);
    if ((g & 1) == 0) {
      const int g2 = g / 2;
      for (int k = tid; k < cnt * g2; k += kThreads) {
        const int e = k / g2, c = 2 * (k - e * g2);
        cp_async8(rs + e * ldr + c, p.rbf + static_cast<size_t>(sl[e]) * g + c);
      }
    } else {
      for (int k = tid; k < cnt * g; k += kThreads) {
        const int e = k / g, c = k - e * g;
        cp_async4(rs + e * ldr + c, p.rbf + static_cast<size_t>(sl[e]) * g + c);
      }
    }
  };

  int cur = r_begin;            // the row being summed, column tid
  float racc = 0.f;
  auto flush = [&](int upto) {  // write row cur, then zero rows to upto
    if (tid < f) {
      p.out[static_cast<size_t>(cur) * f + tid] = racc;
      for (int r = cur + 1; r < upto; ++r)
        p.out[static_cast<size_t>(r) * f + tid] = 0.f;
    }
  };

  if (n_tiles > 0) {
    load_ids(0);
    store_ids(0);
    load_ids(1);
    __syncthreads();
    fetch_rbf(0);
  }
  for (int u = 0; u + 1 < S; ++u) {
    if (u < n_chunks) fetch_chunk(u);
    cp_async_commit();
  }
  float acc[4][4][4];
  for (int q = 0; q < n_chunks; ++q) {
    const int i = q / cpt, c = q - i * cpt;
    cp_async_wait<S - 2>();
    __syncthreads();  // chunk q landed; every reader of chunk q - 1 is done
    if (c == 0) {
      // tile i begins: ids of tile i + 1 to their slot, tile i + 2's into
      // registers, tile i's x rows; t0's accumulators start from b0
      store_ids(i + 1);
      load_ids(i + 2);
      fetch_x(i);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = min(n0 + 8 * nt + 2 * tq, f - 2);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          acc[mt][nt][0] = acc[mt][nt][2] = b0s[col];
          acc[mt][nt][1] = acc[mt][nt][3] = b0s[col + 1];
        }
      }
    }
    if (c == L.c0 && i + 1 < n_tiles) fetch_rbf(i + 1);
    if (q + S - 1 < n_chunks) fetch_chunk(q + S - 1);
    cp_async_commit();

    const bool first = c < L.c0;
    const float* w = ring + (q % S) * KC * ldw;
    const int kb = (first ? c : c - L.c0) * KC;
    const int kend = first ? L.g8 : f;
    const float* a_t = first ? rs : as;
    const int ld = first ? ldr : lda;
    if (n0 < f) {
#pragma unroll
      for (int j = 0; j < KC / 8; ++j) {
        if (kb + 8 * j < kend) {
          FragA fa[4];
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            const float* ap = a_t + (16 * mt + gq) * ld + kb + 8 * j + 2 * tq;
            const float2 u0 = *reinterpret_cast<const float2*>(ap);
            const float2 u1 = *reinterpret_cast<const float2*>(ap + 8 * ld);
            split_tc(u0.x, fa[mt].hi[0], fa[mt].lo[0]);
            split_tc(u1.x, fa[mt].hi[1], fa[mt].lo[1]);
            split_tc(u0.y, fa[mt].hi[2], fa[mt].lo[2]);
            split_tc(u1.y, fa[mt].hi[3], fa[mt].lo[3]);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if (n0 + 8 * nt < f) {
              const float* wp = w + (8 * j + 2 * tq) * ldw + n0 + 8 * nt + gq;
              FragB fb;
              split_tc(wp[0], fb.hi[0], fb.lo[0]);
              split_tc(wp[ldw], fb.hi[1], fb.lo[1]);
#pragma unroll
              for (int mt = 0; mt < 4; ++mt) mma3(acc[mt][nt], fa[mt], fb);
            }
          }
        }
      }
    }

    if (c == L.c0 - 1 && n0 < f) {
      // a = ssp(t0) into the a tile; f2's accumulators start from b1
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (n0 + 8 * nt < f) {
          const int col = n0 + 8 * nt + 2 * tq;
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            float* o = as + (16 * mt + gq) * lda + col;
            *reinterpret_cast<float2*>(o) =
                make_float2(ssp(acc[mt][nt][0]), ssp(acc[mt][nt][1]));
            *reinterpret_cast<float2*>(o + 8 * lda) =
                make_float2(ssp(acc[mt][nt][2]), ssp(acc[mt][nt][3]));
            acc[mt][nt][0] = acc[mt][nt][2] = b1s[col];
            acc[mt][nt][1] = acc[mt][nt][3] = b1s[col + 1];
          }
        }
      }
    }
    if (c == cpt - 1) {
      __syncthreads();  // every warp's reads of the a tile are done
      const float* cms =
          reinterpret_cast<const float*>(ids + (i & 1) * 4 * M + 3 * M);
      if (n0 < f) {
        // msg = x[gidx] * (f2 * cm) at this thread's accumulators, into
        // the a tile (rows past the tile or without a gathered row hold
        // what they hold: never summed)
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const float c_lo = cms[16 * mt + gq], c_hi = cms[16 * mt + gq + 8];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if (n0 + 8 * nt < f) {
              const int o = (16 * mt + gq) * lda + n0 + 8 * nt + 2 * tq;
              const float2 x0 = *reinterpret_cast<const float2*>(xs + o);
              const float2 x1 =
                  *reinterpret_cast<const float2*>(xs + o + 8 * lda);
              *reinterpret_cast<float2*>(as + o) =
                  make_float2(x0.x * (acc[mt][nt][0] * c_lo),
                              x0.y * (acc[mt][nt][1] * c_lo));
              *reinterpret_cast<float2*>(as + o + 8 * lda) =
                  make_float2(x1.x * (acc[mt][nt][2] * c_hi),
                              x1.y * (acc[mt][nt][3] * c_hi));
            }
          }
        }
      }
      __syncthreads();  // the messages are in place
      if (tid < f) {
        // column tid of the messages into the current row, in edge order,
        // eight edges' loads at a time
        const int* rows = ids + (i & 1) * 4 * M + 2 * M;
        const int cnt = tile_edges(i);
        for (int e0 = 0; e0 < cnt; e0 += 8) {
          float v[8];
          int jr[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            v[k] = as[(e0 + k) * lda + tid];
            jr[k] = e0 + k < cnt ? rows[e0 + k] : -1;
          }
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int j = jr[k];
            if (j < cur || j >= r_end) continue;
            if (j != cur) {
              flush(j);
              cur = j;
              racc = 0.f;
            }
            racc += v[k];
          }
        }
      }
    }
  }
  cp_async_wait_all();
  flush(r_end);
}

int launch_fg_tc(const FgArgs& a, int sms, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * static_cast<size_t>(fg_layout(a.f, a.g).floats);
  int per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      scf_fg_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scf_fg_tc_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = min(sms * per_sm, a.n_rows);
  scf_fg_tc_kernel<<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// pass P
// ---------------------------------------------------------------------------

// dW1 floats a block holds in registers: W rows of the slice x F columns
constexpr int kAccFloats = 16384;

template <int TE, int W>
struct PassPShape {
  static constexpr int FP = kAccFloats / W;    // largest F of this shape
  static constexpr int LA = W + 8;             // row stride of [e][k'] tiles
  static constexpr int NB = W / 8;             // n-tiles across the slice
  static constexpr int T1 = (TE / 16) * NB;    // C tiles of t0 and of u
  static constexpr int Q1 = T1 >= kWarps ? T1 / kWarps : 1;  // per warp
  static constexpr int WPR = NB / Q1;          // warps per 16 edges in t0, u
  static constexpr int MT4 = W / 16;           // dW1: m-tiles (slice rows)
  static constexpr int NT4 = FP / (8 * kWarps);  // dW1: n-tiles per warp
  static constexpr int CW = NT4 * 8;           // dW1: columns per warp
  static_assert(T1 < kWarps || T1 % kWarps == 0, "t0 tiles per warp");
  static_assert(NB % Q1 == 0, "a warp's t0 tiles share their 16 edges");
  static_assert(2 * W <= kThreads, "db0 and db1 take a thread per column");
};

// shared memory of one pass-P block, in floats
struct PassPLayout {
  int fp;    // dfilt and W1 tile columns: F rounded up to a warp's columns
  int ldf;   // their row stride (fp + 4: conflict-free A fragments)
  int gk;    // the t0 product's depth: G rounded up to 8
  int g32;   // rows of the W0 tile and columns of the rbf tile
  int ldr;   // rbf tile row stride
  int w1s, dfs, w0s, rbfs, as, dts, b0s, red, cms, ids, floats;
};

template <int TE, int W>
__host__ __device__ inline PassPLayout pass_p_layout(int f, int g) {
  using S = PassPShape<TE, W>;
  PassPLayout L;
  L.fp = (f + S::CW - 1) / S::CW * S::CW;
  L.ldf = L.fp + 4;
  L.gk = (g + 7) / 8 * 8;
  L.g32 = (g + 31) / 32 * 32;
  L.ldr = L.g32 + 4;
  int o = 0;
  L.w1s = o; o += W * L.ldf;       // W1[k0 + k'][c]
  L.dfs = o; o += TE * L.ldf;      // dfilt[e][c]
  L.w0s = o; o += L.g32 * S::LA;   // W0[gg][k0 + k']
  L.rbfs = o; o += TE * L.ldr;     // rbf[e][gg]
  L.as = o; o += TE * S::LA;       // a = ssp(t0)[e][k']
  L.dts = o; o += TE * S::LA;      // sigmoid(t0), then dt0 [e][k']
  L.b0s = o; o += W;
  L.red = o; o += kWarps * TE;     // dcm terms per warp and edge
  L.cms = o; o += TE;
  L.ids = o; o += 2 * TE;          // senders, receivers (int)
  L.floats = o;
  return L;
}

struct PassPArgs {
  const float* h;       // [N, F]
  const float* gout;    // [N, F] cotangent of out
  const float* rbf;     // [E, G]
  const float* cm;      // [E]
  const int* send;      // [E], receiver order
  const int* recv;      // [E], nondecreasing over the valid edges
  const int* row_ptr;   // [N + 1]
  const float* w0;      // [G, F]
  const float* b0;      // [F]
  const float* w1;      // [F, F]
  const float* b1;      // [F]
  float* partial;       // [n_parts, G*F + F + F*F + F], packed
  float* drbf;          // [n_slices, E, G] or null
  float* dcm;           // [n_slices, E] or null
  int n_rows, n_edges, f, g;
  int vec4;             // h and gout rows are 16-byte aligned float4s
};

template <int TE, int W>
__global__ void __launch_bounds__(kThreads, 1)
scf_pass_p_kernel(const PassPArgs p) {
  using S = PassPShape<TE, W>;
  using namespace passp;
  constexpr int LA = S::LA;
  const int f = p.f, g = p.g;
  const PassPLayout L = pass_p_layout<TE, W>(f, g);
  const int ldf = L.ldf, ldr = L.ldr;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* w1s = sm + L.w1s;
  float* dfs = sm + L.dfs;
  float* w0s = sm + L.w0s;
  float* rbfs = sm + L.rbfs;
  float* as = sm + L.as;
  float* dts = sm + L.dts;
  float* b0s = sm + L.b0s;
  float* red = sm + L.red;
  float* cm_s = sm + L.cms;
  int* send_s = reinterpret_cast<int*>(sm + L.ids);
  int* recv_s = send_s + TE;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int gq = lane_g(), tq = lane_t();
  const int j = blockIdx.y, k0 = j * W;
  const int wk = min(W, f - k0);  // the slice's real columns

  // the slice's weights, once: W1 rows k0.., W0 columns k0.., b0; zeros
  // pad every product to whole tiles
  for (int i = tid; i < W * L.fp; i += kThreads) {
    const int r = i / L.fp, c = i - r * L.fp;
    w1s[r * ldf + c] =
        r < wk && c < f ? p.w1[static_cast<size_t>(k0 + r) * f + c] : 0.f;
  }
  for (int i = tid; i < L.g32 * W; i += kThreads) {
    const int r = i / W, c = i - r * W;
    w0s[r * LA + c] =
        r < g && c < wk ? p.w0[static_cast<size_t>(r) * f + k0 + c] : 0.f;
  }
  for (int c = tid; c < W; c += kThreads) b0s[c] = c < wk ? p.b0[k0 + c] : 0.f;

  const long long n_valid = p.row_ptr[p.n_rows];
  const int lo = static_cast<int>(n_valid * blockIdx.x / gridDim.x);
  const int hi = static_cast<int>(n_valid * (blockIdx.x + 1) / gridDim.x);

  // t0 and u: this warp's Q1 tiles share 16 edges (m1) and take n-tiles
  // n1 .. n1 + Q1 - 1 of the slice
  const int q0 = warp * S::Q1;
  const bool p12 = q0 < S::T1;
  const int m1 = (q0 / S::NB) * 16, n1 = q0 % S::NB;
  // dW0: this warp's 16 rows of G; dW1: this warp's CW columns of F
  const bool p3 = 16 * warp < g;
  const int cb = warp * S::CW;
  const bool p4 = cb < f;
  // db0, db1: one thread per slice column, in the last warps
  const int dbi = tid - (kThreads - 2 * W);
  const int fk8 = (f + 7) / 8 * 8;
  const bool want_dcm = p.dcm != nullptr, want_drbf = p.drbf != nullptr;

  float acc1[S::MT4][S::NT4][4];  // dW1: the slice's rows, this warp's columns
  float acc0[S::NB][4];           // dW0: this warp's rows, the slice
#pragma unroll
  for (int mt = 0; mt < S::MT4; ++mt)
#pragma unroll
    for (int nt = 0; nt < S::NT4; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc1[mt][nt][v] = 0.f;
#pragma unroll
  for (int n = 0; n < S::NB; ++n)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc0[n][v] = 0.f;
  float db = 0.f, dbc = 0.f;
  // the rbf tile's padding columns stay zero
  for (int i = tid; i < TE * (L.g32 - g); i += kThreads) {
    const int e = i / (L.g32 - g);
    rbfs[e * ldr + g + i - e * (L.g32 - g)] = 0.f;
  }
  // each tile's ids are loaded during the tile before it
  int s_n = -1, r_n = -1;
  float c_n = 0.f;
  if (tid < TE && lo + tid < hi) {
    s_n = p.send[lo + tid];
    r_n = p.recv[lo + tid];
    c_n = p.cm[lo + tid];
  }

  for (int t = lo; t < hi; t += TE) {
    const int cnt = min(TE, hi - t);
    __syncthreads();  // staging done; the previous tile's readers are done
    if (tid < TE) {
      const bool ok =
          tid < cnt &&
          static_cast<unsigned>(s_n) < static_cast<unsigned>(p.n_rows) &&
          static_cast<unsigned>(r_n) < static_cast<unsigned>(p.n_rows);
      send_s[tid] = ok ? s_n : -1;
      recv_s[tid] = ok ? r_n : -1;
      cm_s[tid] = tid < cnt ? c_n : 0.f;
      const int q = t + TE + tid;
      if (q < hi) {
        s_n = p.send[q];
        r_n = p.recv[q];
        c_n = p.cm[q];
      }
    }
    __syncthreads();
    // dfilt = g[recv] * h[send] (zero past the tile's edges, on invalid
    // ones and in the padding columns) and the tile's rbf rows.  Every
    // load reads a clamped, in-range address and the zeros are selected
    // after it, so an unrolled group's loads are all in flight at once.
    if (p.vec4) {
      const int f4 = L.fp / 4;
#pragma unroll 4
      for (int i = tid; i < TE * f4; i += kThreads) {
        const int e = i / f4, c = 4 * (i - e * f4);
        const int s = send_s[e];
        const bool ok = s >= 0 && c < f;
        const size_t cc = ok ? c : 0;
        const float4 a = *reinterpret_cast<const float4*>(
            p.gout + static_cast<size_t>(ok ? recv_s[e] : 0) * f + cc);
        const float4 b = *reinterpret_cast<const float4*>(
            p.h + static_cast<size_t>(ok ? s : 0) * f + cc);
        *reinterpret_cast<float4*>(dfs + e * ldf + c) =
            ok ? make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w)
               : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
#pragma unroll 4
      for (int i = tid; i < TE * L.fp; i += kThreads) {
        const int e = i / L.fp, c = i - e * L.fp;
        const int s = send_s[e];
        const bool ok = s >= 0 && c < f;
        const size_t cc = ok ? c : 0;
        const float v =
            p.gout[static_cast<size_t>(ok ? recv_s[e] : 0) * f + cc] *
            p.h[static_cast<size_t>(ok ? s : 0) * f + cc];
        dfs[e * ldf + c] = ok ? v : 0.f;
      }
    }
#pragma unroll 4
    for (int i = tid; i < TE * g; i += kThreads) {
      const int e = i / g;
      const bool ok = e < cnt;
      const float v = p.rbf[static_cast<size_t>(t) * g + (ok ? i : 0)];
      rbfs[e * ldr + i - e * g] = ok ? v : 0.f;
    }
    __syncthreads();

    if (p12) {
      // t0 = rbf . W0[:, slice] + b0 -> a into as, sigmoid(t0) into dts
      float acc[S::Q1][4];
#pragma unroll
      for (int i = 0; i < S::Q1; ++i) {
        const int c = (n1 + i) * 8 + 2 * tq;
        acc[i][0] = acc[i][2] = b0s[c];
        acc[i][1] = acc[i][3] = b0s[c + 1];
      }
      for (int kk = 0; kk < L.gk; kk += 8) {
        FragA fa;
        load_a(fa, rbfs + m1 * ldr + kk, ldr, 1);
#pragma unroll
        for (int i = 0; i < S::Q1; ++i) {
          FragB fb;
          load_b(fb, w0s + kk * LA + (n1 + i) * 8, LA, 1);
          mma3(acc[i], fa, fb);
        }
      }
#pragma unroll
      for (int i = 0; i < S::Q1; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int o = (m1 + gq + 8 * (v >> 1)) * LA + (n1 + i) * 8 +
                        2 * tq + (v & 1);
          ssp_logistic(acc[i][v], as[o], dts[o]);
        }
      // u = dfilt . W1[slice, :]^T; dt0 = cm * u * sigmoid(t0) in place
      // (each thread rereads only what it wrote above)
#pragma unroll
      for (int i = 0; i < S::Q1; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][v] = 0.f;
      for (int kk = 0; kk < fk8; kk += 8) {
        FragA fa;
        load_a(fa, dfs + m1 * ldf + kk, ldf, 1);
#pragma unroll
        for (int i = 0; i < S::Q1; ++i) {
          FragB fb;
          load_b(fb, w1s + (n1 + i) * 8 * ldf + kk, 1, ldf);
          mma3(acc[i], fa, fb);
        }
      }
      float dc[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < S::Q1; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int e = m1 + gq + 8 * (v >> 1);
          const int o = e * LA + (n1 + i) * 8 + 2 * tq + (v & 1);
          dts[o] = cm_s[e] * acc[i][v] * dts[o];
          dc[v >> 1] += as[o] * acc[i][v];
        }
      if (want_dcm) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          dc[h] += __shfl_xor_sync(0xffffffffu, dc[h], 1);
          dc[h] += __shfl_xor_sync(0xffffffffu, dc[h], 2);
        }
        if (tq == 0) {
          red[warp * TE + m1 + gq] = dc[0];
          red[warp * TE + m1 + gq + 8] = dc[1];
        }
      }
    }
    __syncthreads();

    if (p3) {
      // dW0[:, slice] += rbf^T dt0 over this warp's 16 rows of G
      for (int kk = 0; kk < TE; kk += 8) {
        FragA fa;
        load_a(fa, rbfs + kk * ldr + 16 * warp, 1, ldr);
#pragma unroll
        for (int n = 0; n < S::NB; ++n) {
          FragB fb;
          load_b(fb, dts + kk * LA + n * 8, LA, 1);
          mma3(acc0[n], fa, fb);
        }
      }
    }
    if (dbi >= 0) {
      // db0 = sum_e dt0 (first W threads), db1 = sum_e cm * dfilt (next W),
      // in edge order
      if (dbi < W) {
        for (int e = 0; e < cnt; ++e) add_comp(db, dbc, dts[e * LA + dbi]);
      } else if (k0 + dbi - W < f) {
        const int c = k0 + dbi - W;
        for (int e = 0; e < cnt; ++e)
          add_comp(db, dbc, cm_s[e] * dfs[e * ldf + c]);
      }
    }
    if (want_dcm && tid < cnt) {
      // the warps that hold this edge's u, in order, then the b1 term of the
      // slice's columns
      const int w0_ = (tid / 16) * S::WPR;
      float v = 0.f;
      for (int w = w0_; w < w0_ + S::WPR; ++w) v += red[w * TE + tid];
      for (int c = 0; c < wk; ++c) v += p.b1[k0 + c] * dfs[tid * ldf + k0 + c];
      p.dcm[static_cast<size_t>(j) * p.n_edges + t + tid] = v;
    }
    if (want_drbf) {
      // this slice's share of drbf = dt0 . W0^T
      for (int i = tid; i < cnt * g; i += kThreads) {
        const int e = i / g, gg = i - e * g;
        float v = 0.f;
        for (int c = 0; c < wk; ++c) v += dts[e * LA + c] * w0s[gg * LA + c];
        p.drbf[(static_cast<size_t>(j) * p.n_edges + t + e) * g + gg] = v;
      }
    }
    if (p4) {
      // dW1[slice, :] += (cm * a)^T dfilt over this warp's columns
      for (int kk = 0; kk < TE; kk += 8) {
        const float c0 = cm_s[kk + tq], c1 = cm_s[kk + tq + 4];
        FragA fa[S::MT4];
#pragma unroll
        for (int mt = 0; mt < S::MT4; ++mt) {
          const float* ap = as + kk * LA + mt * 16 + gq;
          set_a(fa[mt], ap[tq * LA] * c0, ap[tq * LA + 8] * c0,
                ap[(tq + 4) * LA] * c1, ap[(tq + 4) * LA + 8] * c1);
        }
#pragma unroll
        for (int nt = 0; nt < S::NT4; ++nt) {
          FragB fb;
          load_b(fb, dfs + kk * ldf + cb + nt * 8, ldf, 1);
#pragma unroll
          for (int mt = 0; mt < S::MT4; ++mt) mma3(acc1[mt][nt], fa[mt], fb);
        }
      }
    }
  }

  // the slice, once, into part p's partial in the packed layout [dW0 (G x
  // F) | db0 (F) | dW1 (F x F) | db1 (F)]: columns k0.. of dW0 and db0,
  // rows k0.. of dW1, entries k0.. of db1
  const size_t gf = static_cast<size_t>(g) * f;
  float* out =
      p.partial + blockIdx.x * (gf + f + static_cast<size_t>(f) * f + f);
  if (p3) {
#pragma unroll
    for (int n = 0; n < S::NB; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int gg = 16 * warp + gq + 8 * (v >> 1);
        const int c = n * 8 + 2 * tq + (v & 1);
        if (gg < g && c < wk)
          out[static_cast<size_t>(gg) * f + k0 + c] = acc0[n][v];
      }
  }
  if (dbi >= 0 && (dbi < W ? dbi : dbi - W) < wk) {
    out[dbi < W ? gf + k0 + dbi
                : gf + f + static_cast<size_t>(f) * f + k0 + dbi - W] =
        db + dbc;
  }
  if (p4) {
    float* o1 = out + gf + f + static_cast<size_t>(k0) * f;
#pragma unroll
    for (int mt = 0; mt < S::MT4; ++mt)
#pragma unroll
      for (int nt = 0; nt < S::NT4; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int r = mt * 16 + gq + 8 * (v >> 1);
          const int c = cb + nt * 8 + 2 * tq + (v & 1);
          if (r < wk && c < f)
            o1[static_cast<size_t>(r) * f + c] = acc1[mt][nt][v];
        }
  }
}

template <int TE>
int launch_filter_gather(const float* x, const float* rbf, const float* cm,
                         const int* gidx, const int* rowid, const int* perm,
                         const int* row_ptr, const float* w0, const float* b0,
                         const float* w1, const float* b1, float* out,
                         int n_rows, int f, int g,
                         cudaStream_t st) {
  const size_t smem = filter_gather_smem<TE>(f, g);
  cudaError_t err = cudaFuncSetAttribute(
      scf_filter_gather_kernel<TE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = (n_rows + kRowsPerCta - 1) / kRowsPerCta;
  scf_filter_gather_kernel<TE><<<grid, kThreads, smem, st>>>(
      x, rbf, cm, gidx, rowid, perm, row_ptr, w0, b0, w1, b1, out, n_rows, f,
      g);
  return static_cast<int>(cudaGetLastError());
}

template <int TE, int W>
size_t pass_p_bytes(int f, int g) {
  return sizeof(float) *
         static_cast<size_t>(pass_p_layout<TE, W>(f, g).floats);
}

template <int TE, int W>
int launch_pass_p(const PassPArgs& a, int n_parts, cudaStream_t st) {
  const size_t smem = pass_p_bytes<TE, W>(a.f, a.g);
  cudaError_t err = cudaFuncSetAttribute(
      scf_pass_p_kernel<TE, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_parts, (a.f + W - 1) / W);
  scf_pass_p_kernel<TE, W><<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the opt-in shared memory per block and the SM count of the current
// device
cudaError_t device_limits(int* optin, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess && sms != nullptr)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

}  // namespace

// The forward's and pass S's route at these widths on the current device:
// 1 (scf_fg_tc_kernel: F a multiple of 8 up to 256, G <= 64), 2
// (scf_filter_gather_kernel, the first design, up to F = 1024 and G =
// 127), 0 when the device cannot be asked.
extern "C" int hg_scf_fwd_route(int f, int g) {
  int optin = 0;
  if (device_limits(&optin, nullptr) != cudaSuccess) return 0;
  return fwd_route(f, g, optin);
}

// Bytes of dynamic shared memory of one route-1 block (scf_fg_tc_kernel)
// at F and G.
extern "C" int hg_scf_fwd_smem(int f, int g) {
  return static_cast<int>(sizeof(float) *
                          static_cast<size_t>(fg_layout(f, g).floats));
}

// Returns the cudaError_t of the launch (0 = success).  Pointers are device
// pointers; `perm` may be null (identity); `route` 0 takes the widths' own
// (hg_scf_fwd_route), 1 or 2 that one where the widths admit it; launches
// go on `stream` and do not synchronise.
extern "C" int hg_scf_filter_gather_f32(
    const void* x, const void* rbf, const void* cm, const void* gidx,
    const void* rowid, const void* perm, const void* row_ptr, const void* w0,
    const void* b0, const void* w1, const void* b1, void* out, int n_rows,
    int f, int g, int route, void* stream) {
  if (n_rows <= 0 || f <= 0) return 0;
  if (f > kMaxF || g < 1 || g > kMaxG)
    return static_cast<int>(cudaErrorInvalidValue);
  int optin = 0, sms = 0;
  const cudaError_t err = device_limits(&optin, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int own = fwd_route(f, g, optin);
  if (route == 0) route = own;
  if ((route == 1 && own != 1) || route < 1 || route > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* rf = static_cast<const float*>(rbf);
  const float* cf = static_cast<const float*>(cm);
  const int* gi = static_cast<const int*>(gidx);
  const int* ri = static_cast<const int*>(rowid);
  const int* pi = static_cast<const int*>(perm);
  const int* rp = static_cast<const int*>(row_ptr);
  const float* w0f = static_cast<const float*>(w0);
  const float* b0f = static_cast<const float*>(b0);
  const float* w1f = static_cast<const float*>(w1);
  const float* b1f = static_cast<const float*>(b1);
  float* of = static_cast<float*>(out);
  if (route == 1) {
    // 16-byte rows of x and the weights, 8-byte rbf rows at an even G
    if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w0) |
          reinterpret_cast<uintptr_t>(w1)) & 15) != 0 ||
        (reinterpret_cast<uintptr_t>(rbf) & 7) != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
    const FgArgs a{xf, rf, cf, gi, ri, pi, rp, w0f, b0f, w1f, b1f, of,
                   n_rows, f, g};
    return launch_fg_tc(a, sms, st);
  }
  if (f <= 256)
    return launch_filter_gather<32>(xf, rf, cf, gi, ri, pi, rp, w0f, b0f, w1f,
                                    b1f, of, n_rows, f, g, st);
  if (f <= 512)
    return launch_filter_gather<16>(xf, rf, cf, gi, ri, pi, rp, w0f, b0f, w1f,
                                    b1f, of, n_rows, f, g, st);
  return launch_filter_gather<8>(xf, rf, cf, gi, ri, pi, rp, w0f, b0f, w1f,
                                 b1f, of, n_rows, f, g, st);
}

// Bytes of shared memory of one pass-P block at F, G and slice width
// `width` on the current device (edges per tile: `width`, or 32 where 64
// would pass the device's limit), or -1.
extern "C" int hg_scf_pass_p_smem(int f, int g, int width) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  size_t b = 0;
  if (width == 64) {
    b = pass_p_bytes<64, 64>(f, g);
    if (b > static_cast<size_t>(optin)) b = pass_p_bytes<32, 64>(f, g);
  } else if (width == 32) {
    b = pass_p_bytes<32, 32>(f, g);
  } else if (width == 16) {
    b = pass_p_bytes<16, 16>(f, g);
  } else {
    return -1;
  }
  return static_cast<int>(b);
}

// Pass P and its reductions.  `width` is the slice width W (64 for F <= 256,
// 32 for F <= 512, 16 for F <= 1024: scf_mp.py:pass_p_plan); `partial` is
// scratch [n_parts, P] for the parts' sums of `wgrad` [dW0 (G*F) | db0 (F)
// | dW1 (F*F) | db1 (F)] (P entries).  `drbf` [E,G] and `dcm` [E] may be
// null; when given they must be zero-filled (masked edges are never
// written), and with more than one slice `drbf_part` [n_slices, E, G] and
// `dcm_part` [n_slices, E] are their scratch (with one slice, pass the
// outputs themselves).
extern "C" int hg_scf_pass_p_f32(
    const void* h, const void* gout, const void* rbf, const void* cm,
    const void* send, const void* recv, const void* row_ptr, const void* w0,
    const void* b0, const void* w1, const void* b1, void* partial,
    void* wgrad, void* drbf_part, void* dcm_part, void* drbf, void* dcm,
    int n_rows, int n_edges, int f, int g, int width, int n_parts,
    void* stream) {
  if (n_rows <= 0 || f <= 0) return 0;
  if (f > kMaxF || g < 1 || g > kMaxG || n_parts < 1 ||
      (width != 64 && width != 32 && width != 16) ||
      f > kAccFloats / width || (drbf == nullptr) != (drbf_part == nullptr) ||
      (dcm == nullptr) != (dcm_part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PassPArgs a;
  a.h = static_cast<const float*>(h);
  a.gout = static_cast<const float*>(gout);
  a.rbf = static_cast<const float*>(rbf);
  a.cm = static_cast<const float*>(cm);
  a.send = static_cast<const int*>(send);
  a.recv = static_cast<const int*>(recv);
  a.row_ptr = static_cast<const int*>(row_ptr);
  a.w0 = static_cast<const float*>(w0);
  a.b0 = static_cast<const float*>(b0);
  a.w1 = static_cast<const float*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.partial = static_cast<float*>(partial);
  a.drbf = static_cast<float*>(drbf_part);
  a.dcm = static_cast<float*>(dcm_part);
  a.n_rows = n_rows;
  a.n_edges = n_edges;
  a.f = f;
  a.g = g;
  a.vec4 = f % 4 == 0 &&
           ((reinterpret_cast<uintptr_t>(h) |
             reinterpret_cast<uintptr_t>(gout)) & 15) == 0;
  int rc;
  if (width == 64)
    rc = pass_p_bytes<64, 64>(f, g) <= static_cast<size_t>(optin)
             ? launch_pass_p<64, 64>(a, n_parts, st)
             : launch_pass_p<32, 64>(a, n_parts, st);
  else if (width == 32)
    rc = launch_pass_p<32, 32>(a, n_parts, st);
  else
    rc = launch_pass_p<16, 16>(a, n_parts, st);
  if (rc != 0) return rc;
  const int n_slices = (f + width - 1) / width;
  err = passp::launch_reduce_partials(a.partial, static_cast<float*>(wgrad),
                                      n_parts, g * f + f + f * f + f, st);
  if (err != cudaSuccess || n_slices == 1) return static_cast<int>(err);
  if (drbf != nullptr)
    err = passp::launch_reduce_slices(a.drbf, drbf, a.row_ptr, n_rows, g,
                                      n_slices,
                                      static_cast<size_t>(n_edges) * g, st);
  if (err == cudaSuccess && dcm != nullptr)
    err = passp::launch_reduce_slices(a.dcm, dcm, a.row_ptr, n_rows, 1,
                                      n_slices,
                                      static_cast<size_t>(n_edges), st);
  return static_cast<int>(err);
}
