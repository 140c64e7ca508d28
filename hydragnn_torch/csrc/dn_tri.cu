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
// One kernel template, two modes:
//
// dn_tri_kernel<kFwd> — the forward.  Replaces
//   hydragnn_tpu/ops/dn_tri.py:_tri_fwd (pl.pallas_call at :285).  Rows are
//   output edges e; the triplets are sorted by idx_ji (the builder's
//   order), so each row owns one CSR range.  Each block owns kRows rows and
//   walks their triplets TT at a time: gathers radial[kj] and cbf into a
//   transposed sbf tile and x2[kj] into another, recomputes emb1 = sbf.W1
//   and emb2 = emb1.W2 in shared memory, and adds x2[kj] * emb2 into its
//   rows in triplet order.
// dn_tri_kernel<kBwd> (+ dn_tri_reduce_partials_kernel) — the backward.
//   Replaces :_tri_vjp_bwd (pl.pallas_call at :358).  One pass in kj order
//   (through perm_kj): rows are the gathered edges k.  Per triplet it
//   recomputes sbf, emb1, emb2, takes g = dout[ji], and
//     d_emb2 = g * x2[k];   d_x2[k]     += g * emb2
//     d_emb1 = d_emb2.W2^T; d_sbf        = d_emb1.W1^T
//     dW2   += emb1^T d_emb2; dW1       += sbf^T d_emb1
//     d_radial[k] += d_sbf * expand(cbf[t])
//     d_cbf[t, l]  = sum_r d_sbf[l*R + r] * radial[k, l*R + r]
//   Each row's d_x2 and d_radial are owned by its block (no atomics);
//   d_cbf goes straight to the triplet's own slot, which one row visits
//   once (the reference unpermutes a kj-sorted stream instead); dW1 and
//   dW2 sum into one float32 partial per block of a persistent grid, and
//   the reduce kernel adds the partials in block order.
//
// Bound on the H100 SXM: bytes in the forward (per real triplet ~2(SR*B +
// B*D) flops against the ids, cbf and gathered rows it reads), operations
// in the backward (three times the forward's products).  Design against
// it, first version: no [T, D] or [T, S*R] tensor reaches device memory
// (every per-triplet quantity lives in a shared-memory tile of TT
// triplets); tiles are transposed ([k][t], row stride TT+4) so one 16-byte
// load feeds four multiply-adds; each thread computes EQ triplets of one
// output column; W1 and W2 are staged once per block with odd row strides
// (B | 1, D | 1) so that products along a row and down a column are both
// free of bank conflicts.  Not yet: tensor cores, the factorisation of
// sbf.W1 into edge-space products (emb1 = sum_l cbf[t,l] (radial[k].W1)_l).
//
// Contract (add_dimenet_extras guarantees it): idx_ji is nondecreasing;
// masked triplets sort last in both orders and are parked out of every
// range by the wrapper, so they are never read and get exactly zero in
// every output and gradient (the wrapper zero-fills d_cbf).  Ids outside
// [0, E) contribute nothing.  Determinism: every sum runs in a fixed order
// (triplet order within a row; tile, then block order for dW1, dW2); no
// atomics.  Every output row is written, rows without triplets as zeros.

#include <cuda_runtime.h>

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
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// shared-memory floats of a mode at these widths
__host__ __device__ inline int smem_floats(int mode, int s, int sr, int b,
                                           int d) {
  int n = round4(sr * (b | 1)) + round4(b * (d | 1));   // W1, W2
  n += (sr + b + 2 * d) * LDT;                          // sbf, emb1, x2, emb2
  n += kRows * d;                                       // fwd out / d_x2 rows
  n += 4 * TT;                                          // ids
  if (mode == kBwd) {
    n += (2 * sr + b + s) * LDT;        // radial, d_sbf, d_emb1, cbf
    n += round4(kRows * sr);            // d_radial rows
    n += round4(sr * (b | 1)) + round4(b * (d | 1));    // dW1, dW2 partial
  }
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

template <int MODE>
__global__ void __launch_bounds__(kThreads) dn_tri_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int s = p.s, r = p.r, sr = p.sr, b = p.b, d = p.d;
  const int ld1 = b | 1, ld2 = d | 1;
  const int tid = threadIdx.x;

  float* w1s = sm; sm += round4(sr * ld1);
  float* w2s = sm; sm += round4(b * ld2);
  float* sbf_t = sm; sm += sr * LDT;     // sbf
  float* e1_t = sm; sm += b * LDT;       // emb1
  float* x_t = sm; sm += d * LDT;        // x2[kj]; bwd: then d_emb2
  float* e2_t = sm; sm += d * LDT;       // fwd: the message; bwd: g * emb2
  float* rows_x = sm; sm += kRows * d;   // fwd: out rows; bwd: d_x2 rows
  int* t_s = reinterpret_cast<int*>(sm);
  int* k_s = t_s + TT;
  int* j_s = k_s + TT;
  int* row_s = j_s + TT;
  sm += 4 * TT;
  float *rad_t = nullptr, *dsbf_t = nullptr, *de1_t = nullptr,
        *cb_t = nullptr, *rows_rad = nullptr, *gw1 = nullptr, *gw2 = nullptr;
  if (MODE == kBwd) {
    rad_t = sm; sm += sr * LDT;
    dsbf_t = sm; sm += sr * LDT;
    de1_t = sm; sm += b * LDT;
    cb_t = sm; sm += s * LDT;
    rows_rad = sm; sm += round4(kRows * sr);
    gw1 = sm; sm += round4(sr * ld1);
    gw2 = sm; sm += round4(b * ld2);
  }

  for (int i = tid; i < sr * b; i += kThreads)
    w1s[(i / b) * ld1 + i % b] = p.w1[i];
  for (int i = tid; i < b * d; i += kThreads)
    w2s[(i / d) * ld2 + i % d] = p.w2[i];
  const bool wgrad = MODE == kBwd && p.partial != nullptr;
  if (wgrad) {
    for (int i = tid; i < round4(sr * ld1); i += kThreads) gw1[i] = 0.f;
    for (int i = tid; i < round4(b * ld2); i += kThreads) gw2[i] = 0.f;
  }

  for (int chunk = blockIdx.x; chunk < p.n_chunks; chunk += gridDim.x) {
    const int r0 = chunk * kRows;
    const int r1 = min(r0 + kRows, p.n_rows);
    const int p_begin = p.row_ptr[r0];
    const int p_end = p.row_ptr[r1];
    __syncthreads();  // staging done; the previous chunk's rows written out
    for (int i = tid; i < kRows * d; i += kThreads) rows_x[i] = 0.f;
    if (MODE == kBwd)
      for (int i = tid; i < kRows * sr; i += kThreads) rows_rad[i] = 0.f;

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
        const int k = k_s[e];
        float rad = 0.f, cb = 0.f;
        if (k >= 0) {
          rad = p.radial[static_cast<size_t>(k) * sr + c];
          cb = p.cbf[static_cast<size_t>(t_s[e]) * s + c / r];
        }
        sbf_t[c * LDT + e] = rad * cb;
        if (MODE == kBwd) rad_t[c * LDT + e] = rad;
      }
      for (int i = tid; i < TT * d; i += kThreads) {
        const int e = i / d, c = i - e * d;
        const int k = k_s[e];
        x_t[c * LDT + e] = k >= 0 ? p.x2[static_cast<size_t>(k) * d + c] : 0.f;
      }
      if (MODE == kBwd) {
        for (int i = tid; i < TT * s; i += kThreads) {
          const int e = i / s, l = i - e * s;
          cb_t[l * LDT + e] = k_s[e] >= 0
              ? p.cbf[static_cast<size_t>(t_s[e]) * s + l] : 0.f;
        }
      }
      __syncthreads();
      product(e1_t, b, sbf_t, sr, w1s, ld1);        // emb1 = sbf . W1
      __syncthreads();
      product(e2_t, d, e1_t, b, w2s, ld2);          // emb2 = emb1 . W2
      __syncthreads();

      if (MODE == kFwd) {
        // rows += x2[kj] * emb2 in triplet order
        for (int c = tid; c < d; c += kThreads) {
          for (int e = 0; e < cnt; ++e)
            if (k_s[e] >= 0)
              rows_x[row_s[e] * d + c] += x_t[c * LDT + e] * e2_t[c * LDT + e];
        }
        continue;
      }

      // ---- backward: the cotangent is gathered at ji ----
      for (int it = tid; it < d * TT; it += kThreads) {
        const int c = it / TT, e = it - c * TT;
        const float g = k_s[e] >= 0
            ? p.gout[static_cast<size_t>(j_s[e]) * d + c] : 0.f;
        x_t[c * LDT + e] *= g;       // d_emb2 = g * x2[k]
        e2_t[c * LDT + e] *= g;      // the d_x2 message: g * emb2
      }
      __syncthreads();
      product_t(de1_t, b, x_t, d, w2s, ld2);        // d_emb1 = d_emb2 . W2^T
      __syncthreads();
      product_t(dsbf_t, sr, de1_t, b, w1s, ld1);    // d_sbf = d_emb1 . W1^T
      if (wgrad) {
        outer_acc(gw2, ld2, e1_t, b, x_t, d);       // dW2 += emb1^T d_emb2
        outer_acc(gw1, ld1, sbf_t, sr, de1_t, b);   // dW1 += sbf^T d_emb1
      }
      __syncthreads();
      if (p.d_cbf != nullptr) {
        // d_cbf[t, l] = sum_r d_sbf[l*R + r] * radial[k, l*R + r], written
        // to the triplet's own slot
        for (int it = tid; it < TT * s; it += kThreads) {
          const int e = it / s, l = it - e * s;
          if (e >= cnt || k_s[e] < 0) continue;
          float v = 0.f;
          for (int rr = 0; rr < r; ++rr)
            v += dsbf_t[(l * r + rr) * LDT + e] * rad_t[(l * r + rr) * LDT + e];
          p.d_cbf[static_cast<size_t>(t_s[e]) * s + l] = v;
        }
      }
      // the row's own d_x2 and d_radial, in triplet order
      if (tid < d) {
        const int c = tid;
        for (int e = 0; e < cnt; ++e)
          if (k_s[e] >= 0) rows_x[row_s[e] * d + c] += e2_t[c * LDT + e];
      } else if (tid < d + sr) {
        const int c = tid - d, l = c / r;
        for (int e = 0; e < cnt; ++e)
          if (k_s[e] >= 0)
            rows_rad[row_s[e] * sr + c] +=
                dsbf_t[c * LDT + e] * cb_t[l * LDT + e];
      }
    }
    __syncthreads();
    float* dst_x = MODE == kFwd ? p.out : p.d_x2;
    if (dst_x != nullptr) {
      for (int i = tid; i < (r1 - r0) * d; i += kThreads)
        dst_x[static_cast<size_t>(r0) * d + i] = rows_x[i];
    }
    if (MODE == kBwd && p.d_radial != nullptr) {
      for (int i = tid; i < (r1 - r0) * sr; i += kThreads)
        p.d_radial[static_cast<size_t>(r0) * sr + i] = rows_rad[i];
    }
  }

  if (wgrad) {
    // this block's partial, once, unpadded: [dW1 SR*B | dW2 B*D]
    __syncthreads();
    const int size = round4(sr * b + b * d);
    float* dst = p.partial + static_cast<size_t>(size) * blockIdx.x;
    for (int i = tid; i < sr * b; i += kThreads)
      dst[i] = gw1[(i / b) * ld1 + i % b];
    for (int i = tid; i < b * d; i += kThreads)
      dst[sr * b + i] = gw2[(i / d) * ld2 + i % d];
  }
}

__global__ void dn_tri_reduce_partials_kernel(const float* __restrict__ partial,
                                              float* __restrict__ out,
                                              int n_parts, int size, int used) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= used) return;
  float v = 0.f;
  for (int q = 0; q < n_parts; ++q)
    v += partial[static_cast<size_t>(q) * size + j];
  out[j] = v;
}

template <int MODE>
int launch(const Params& p, int grid, cudaStream_t st) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      sizeof(float) * static_cast<size_t>(smem_floats(MODE, p.s, p.sr, p.b,
                                                      p.d));
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(dn_tri_kernel<MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dn_tri_kernel<MODE><<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The size in floats of one weight-gradient partial (and of `wgrad`):
// [dW1 SR*B | dW2 B*D], padded to a multiple of 4.
extern "C" int hg_dn_tri_wgrad_size(int sr, int b, int d) {
  return round4(sr * b + b * d);
}

// One dn_tri launch; returns the cudaError_t (0 = success).  mode 0: the
// forward (out [E, D]; rows are ji, positions in triplet order, `perm`
// null); mode 1: the backward (rows are kj, positions through `perm`, the
// stable argsort of idx_kj; d_radial, d_x2 or null; d_cbf zero-filled or
// null; `partial` [n_parts, wgrad size] scratch and `wgrad` the reduced
// weight gradients, or both null).  Pointers are device pointers;
// launches go on `stream` and do not synchronise.
extern "C" int hg_dn_tri_f32(
    int mode, const void* radial, const void* x2, const void* cbf,
    const void* w1, const void* w2, const void* kj, const void* ji,
    const void* perm, const void* row_ptr, const void* gout, void* out,
    void* d_radial, void* d_x2, void* d_cbf, void* partial, void* wgrad,
    int n_rows, int s, int r, int b, int d, int n_parts, void* stream) {
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
  p.n_chunks = (n_rows + kRows - 1) / kRows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kFwd) return launch<kFwd>(p, p.n_chunks, st);
  const int grid = (p.partial != nullptr && n_parts < p.n_chunks)
      ? n_parts : p.n_chunks;
  const int rc = launch<kBwd>(p, grid, st);
  if (rc != 0 || p.partial == nullptr) return rc;
  const int size = hg_dn_tri_wgrad_size(p.sr, b, d);
  dn_tri_reduce_partials_kernel<<<(size + 255) / 256, 256, 0, st>>>(
      p.partial, static_cast<float*>(wgrad), grid, size, p.sr * b + b * d);
  return static_cast<int>(cudaGetLastError());
}
