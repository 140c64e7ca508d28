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
// scf_filter_gather_kernel — the forward AND pass S
//   Replaces hydragnn_tpu/ops/fused_block.py:_fused_fwd with the scf spec
//   (pl.pallas_call at :495) and :_fused_bwd pass S (_bwd_s_kernel,
//   pl.pallas_call at :599).  One thread block owns kRowsPerCta output rows
//   and walks their CSR range of edge positions in order, TE edges at a
//   time: it recomputes t0 = rbf.W0 + b0 and a = ssp(t0) into shared
//   memory, then f2 = a.W1 + b1 (W1 streamed column by column from L2: at
//   F = 256 it is 256 KB, more than a block's 227 KB of shared memory), and
//   adds f2 * cm * x[gidx[e]] into the block's rows in shared memory, in
//   edge order.  Forward: positions are edge ids in receiver order, x = h,
//   gidx = senders.  Pass S: positions map to edge ids through the sender
//   permutation, rows are senders, x = the output cotangent, gidx =
//   receivers — dh[n] = sum_{e: send[e]=n} g[recv[e]] * filt_e.
//
// scf_pass_p_kernel (+ scf_reduce_partials_kernel) — backward pass P
//   Replaces :_fused_bwd pass P (_bwd_p_kernel, pl.pallas_call at :561).
//   Receiver order.  Each of n_parts thread blocks takes a contiguous share
//   of the valid edges, recomputes t0, a, f2 per tile, and with
//   dfilt = g[recv] * h[send] derives
//     dcm = sum_f dfilt*f2, df2 = dfilt*cm, db1 += df2, dW1 += a^T df2,
//     dt0 = (df2 . W1^T) * sigmoid(t0), db0 += dt0, dW0 += rbf^T dt0,
//     drbf = dt0 . W0^T.
//   The weight grads are sums over all edges: each block accumulates its
//   own f32 partial [dW0 | db0 | dW1 | db1] in device memory (it owns it:
//   no atomics), and the reduce kernel sums the partials in block order.
//
// Bound on the H100 SXM: operations.  Per valid edge the forward does
// G*F + F*F multiply-adds (pass S the same, pass P about three times that);
// at F = 256, G = 50 that is ~1.6e5 flops per edge against ~1 KB of edge
// and node bytes, far above the card's ~20 flop/byte float32 ridge, so the
// least time is flops / 67 TFLOP/s (float32 outside the tensor cores).
// Design against it, first version: no [E,F] tensor reaches device memory
// (the reference's whole point); the per-edge tiles live transposed in
// shared memory ([k][e], row stride TE+4) so that one 16-byte broadcast
// load feeds four multiply-adds; every weight read is coalesced across the
// threads of a warp (one thread per output column).  Not yet: tensor cores
// (3xTF32 or bf16 wgmma), register micro-tiles, TMA staging (later PRs).
//
// Contract (collate guarantees it): positions are sorted by output row, so
// each row owns one contiguous CSR range; masked edges sort last and are
// parked out of every range by the wrapper, so they are never read and
// every grad on them is exactly zero (the wrapper zero-fills drbf/dcm).
// Gather ids outside [0, n_rows) contribute nothing.  Determinism: every
// sum runs in a fixed order (edge order within a row; tile order, then
// block order, for the weight grads); no atomics.  Every output row is
// written, rows without edges as zeros.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxF = 1024;
constexpr int kMaxG = 127;
constexpr int kMaxChunks = kMaxF / kThreads;
constexpr int kRowsPerCta = 16;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ssp(float x) {
  // softplus(x) - ln 2 with softplus(x) = max(x, 0) + log1p(exp(-|x|))
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))) - kLn2;
}

__device__ __forceinline__ float logistic(float x) {
  return 1.f / (1.f + expf(-x));
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

// dot of a transposed tile row with a register vector: sum_e row[e] * d[e]
template <int TE>
__device__ __forceinline__ float row_dot(const float* row_t,
                                         const float (&d)[TE]) {
  const float4* row = reinterpret_cast<const float4*>(row_t);
  float v = 0.f;
#pragma unroll
  for (int q = 0; q < TE / 4; ++q) {
    const float4 r = row[q];
    v += r.x * d[4 * q] + r.y * d[4 * q + 1] + r.z * d[4 * q + 2] +
         r.w * d[4 * q + 3];
  }
  return v;
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

template <int TE>
size_t pass_p_smem(int f, int g) {
  return sizeof(float) * (static_cast<size_t>(g) * (TE + 4) +
                          3 * static_cast<size_t>(f) * (TE + 4) +
                          static_cast<size_t>(kMaxChunks) * kWarps * TE + TE) +
         sizeof(int) * 2 * TE;
}

template <int TE>
__global__ void __launch_bounds__(kThreads)
scf_pass_p_kernel(const float* __restrict__ h, const float* __restrict__ gout,
                  const float* __restrict__ rbf, const float* __restrict__ cm,
                  const int* __restrict__ send, const int* __restrict__ recv,
                  const int* __restrict__ row_ptr,
                  const float* __restrict__ w0, const float* __restrict__ b0,
                  const float* __restrict__ w1, const float* __restrict__ w1t,
                  const float* __restrict__ b1, float* __restrict__ partial,
                  float* __restrict__ drbf, float* __restrict__ dcm,
                  int n_rows, int f, int g) {
  constexpr int LDT = TE + 4;
  extern __shared__ float4 smem4[];
  float* rbf_t = reinterpret_cast<float*>(smem4);  // [g][LDT]
  float* a_t = rbf_t + g * LDT;                     // [f][LDT] ssp(t0)
  float* s_t = a_t + f * LDT;                       // [f][LDT] sigmoid(t0), then dt0
  float* d_t = s_t + f * LDT;                       // [f][LDT] df2
  float* red = d_t + f * LDT;                       // [kMaxChunks*kWarps][TE]
  float* cm_s = red + kMaxChunks * kWarps * TE;     // [TE]
  int* src_s = reinterpret_cast<int*>(cm_s + TE);   // [TE]
  int* dst_s = src_s + TE;                          // [TE]

  const size_t psize = static_cast<size_t>(g) * f + f +
                       static_cast<size_t>(f) * f + f;
  float* p_dw0 = partial + psize * blockIdx.x;
  float* p_db0 = p_dw0 + static_cast<size_t>(g) * f;
  float* p_dw1 = p_db0 + f;
  float* p_db1 = p_dw1 + static_cast<size_t>(f) * f;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_chunks = (f + kThreads - 1) / kThreads;
  const long long n_valid = row_ptr[n_rows];
  const int lo = static_cast<int>(n_valid * blockIdx.x / gridDim.x);
  const int hi = static_cast<int>(n_valid * (blockIdx.x + 1) / gridDim.x);
  for (size_t i = tid; i < psize; i += kThreads) p_dw0[i] = 0.f;

  for (int t = lo; t < hi; t += TE) {
    const int cnt = min(TE, hi - t);
    __syncthreads();  // partial zeroed; the previous tile's readers are done
    if (tid < TE) {
      int s = -1, r = -1;
      float c = 0.f;
      if (tid < cnt) {
        s = send[t + tid];
        r = recv[t + tid];
        c = cm[t + tid];
        if (static_cast<unsigned>(s) >= static_cast<unsigned>(n_rows) ||
            static_cast<unsigned>(r) >= static_cast<unsigned>(n_rows)) {
          s = -1;
          r = -1;
        }
      }
      src_s[tid] = s;
      dst_s[tid] = r;
      cm_s[tid] = c;
    }
    for (int i = tid; i < TE * g; i += kThreads) {
      const int e = i / g, k = i - e * g;
      rbf_t[k * LDT + e] =
          e < cnt ? rbf[static_cast<size_t>(t + e) * g + k] : 0.f;
    }
    __syncthreads();
    // (1) t0 = rbf . W0 + b0 -> a = ssp(t0), sigmoid(t0)
    for (int c = tid; c < f; c += kThreads) {
      float acc[TE];
      const float bc = b0[c];
#pragma unroll
      for (int e = 0; e < TE; ++e) acc[e] = bc;
      tile_times_column<TE>(acc, rbf_t, w0, g, f, c);
      float sg[TE];
#pragma unroll
      for (int e = 0; e < TE; ++e) {
        sg[e] = logistic(acc[e]);
        acc[e] = ssp(acc[e]);
      }
      store_row<TE>(a_t + c * LDT, acc);
      store_row<TE>(s_t + c * LDT, sg);
    }
    __syncthreads();
    // (2) f2 = a . W1 + b1; dfilt = g[recv] * h[send]; df2 = dfilt * cm;
    //     db1 += df2; the dcm terms dfilt * f2 summed over each warp
    for (int j = 0; j < n_chunks; ++j) {
      const int c = j * kThreads + tid;
      const bool active = c < f;
      float acc[TE];
#pragma unroll
      for (int e = 0; e < TE; ++e) acc[e] = 0.f;
      if (active) {
        const float bc = b1[c];
#pragma unroll
        for (int e = 0; e < TE; ++e) acc[e] = bc;
        tile_times_column<TE>(acc, a_t, w1, f, f, c);
      }
      float df2[TE];
      float db1_sum = 0.f;
#pragma unroll
      for (int e = 0; e < TE; ++e) {
        const int s = src_s[e], r = dst_s[e];
        float dfilt = 0.f;
        if (active && s >= 0)
          dfilt = gout[static_cast<size_t>(r) * f + c] *
                  h[static_cast<size_t>(s) * f + c];
        df2[e] = dfilt * cm_s[e];
        db1_sum += df2[e];
        acc[e] = dfilt * acc[e];
      }
      if (active) {
        store_row<TE>(d_t + c * LDT, df2);
        p_db1[c] += db1_sum;
      }
#pragma unroll
      for (int e = 0; e < TE; ++e) {
        float v = acc[e];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) red[(j * kWarps + warp) * TE + e] = v;
      }
    }
    __syncthreads();
    if (dcm != nullptr && tid < cnt) {
      float v = 0.f;
      for (int w = 0; w < n_chunks * kWarps; ++w) v += red[w * TE + tid];
      dcm[t + tid] = v;
    }
    // (3) dt0 = (df2 . W1^T) * sigmoid(t0), one column k per thread;
    //     db0 += dt0; dW0[:, k] += rbf^T dt0; dt0 overwrites sigmoid(t0)
    for (int k = tid; k < f; k += kThreads) {
      float acc[TE];
#pragma unroll
      for (int e = 0; e < TE; ++e) acc[e] = 0.f;
      tile_times_column<TE>(acc, d_t, w1t, f, f, k);
      const float4* sk = reinterpret_cast<const float4*>(s_t + k * LDT);
      float db0_sum = 0.f;
#pragma unroll
      for (int q = 0; q < TE / 4; ++q) {
        const float4 sg = sk[q];
        acc[4 * q + 0] *= sg.x;
        acc[4 * q + 1] *= sg.y;
        acc[4 * q + 2] *= sg.z;
        acc[4 * q + 3] *= sg.w;
        db0_sum += acc[4 * q] + acc[4 * q + 1] + acc[4 * q + 2] +
                   acc[4 * q + 3];
      }
      store_row<TE>(s_t + k * LDT, acc);
      p_db0[k] += db0_sum;
      for (int gg = 0; gg < g; ++gg)
        p_dw0[static_cast<size_t>(gg) * f + k] +=
            row_dot<TE>(rbf_t + gg * LDT, acc);
    }
    __syncthreads();
    // (4) dW1[k][c] += sum_e a[e][k] * df2[e][c], one column c per thread
    for (int c = tid; c < f; c += kThreads) {
      float dv[TE];
      const float4* dc = reinterpret_cast<const float4*>(d_t + c * LDT);
#pragma unroll
      for (int q = 0; q < TE / 4; ++q) {
        const float4 v = dc[q];
        dv[4 * q] = v.x;
        dv[4 * q + 1] = v.y;
        dv[4 * q + 2] = v.z;
        dv[4 * q + 3] = v.w;
      }
      for (int k = 0; k < f; ++k)
        p_dw1[static_cast<size_t>(k) * f + c] += row_dot<TE>(a_t + k * LDT, dv);
    }
    // (5) drbf[e][gg] = sum_k dt0[e][k] * W0[gg][k], four edges per item
    if (drbf != nullptr) {
      for (int i = tid; i < g * (TE / 4); i += kThreads) {
        const int gg = i % g, q = i / g;
        const float* wg = w0 + static_cast<size_t>(gg) * f;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int k = 0; k < f; ++k) {
          const float wk = wg[k];
          const float4 d = reinterpret_cast<const float4*>(s_t + k * LDT)[q];
          v.x += d.x * wk;
          v.y += d.y * wk;
          v.z += d.z * wk;
          v.w += d.w * wk;
        }
        const int e = 4 * q;
        float* dr = drbf + static_cast<size_t>(t + e) * g + gg;
        if (e < cnt) dr[0] = v.x;
        if (e + 1 < cnt) dr[g] = v.y;
        if (e + 2 < cnt) dr[2 * g] = v.z;
        if (e + 3 < cnt) dr[3 * g] = v.w;
      }
    }
  }
}

__global__ void scf_reduce_partials_kernel(const float* __restrict__ partial,
                                           float* __restrict__ out,
                                           int n_parts, int size) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= size) return;
  float v = 0.f;
  for (int b = 0; b < n_parts; ++b)
    v += partial[static_cast<size_t>(b) * size + j];
  out[j] = v;
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

template <int TE>
int launch_pass_p(const float* h, const float* gout, const float* rbf,
                  const float* cm, const int* send, const int* recv,
                  const int* row_ptr, const float* w0, const float* b0,
                  const float* w1, const float* w1t, const float* b1,
                  float* partial, float* drbf, float* dcm, int n_rows,
                  int f, int g, int n_parts, cudaStream_t st) {
  const size_t smem = pass_p_smem<TE>(f, g);
  cudaError_t err = cudaFuncSetAttribute(
      scf_pass_p_kernel<TE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  scf_pass_p_kernel<TE><<<n_parts, kThreads, smem, st>>>(
      h, gout, rbf, cm, send, recv, row_ptr, w0, b0, w1, w1t, b1, partial,
      drbf, dcm, n_rows, f, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  Pointers are device
// pointers; `perm` may be null (identity); launches go on `stream` and do
// not synchronise.
extern "C" int hg_scf_filter_gather_f32(
    const void* x, const void* rbf, const void* cm, const void* gidx,
    const void* rowid, const void* perm, const void* row_ptr, const void* w0,
    const void* b0, const void* w1, const void* b1, void* out, int n_rows,
    int f, int g, void* stream) {
  if (n_rows <= 0 || f <= 0) return 0;
  if (f > kMaxF || g < 1 || g > kMaxG)
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
  if (f <= 256)
    return launch_filter_gather<32>(xf, rf, cf, gi, ri, pi, rp, w0f, b0f, w1f,
                                    b1f, of, n_rows, f, g, st);
  if (f <= 512)
    return launch_filter_gather<16>(xf, rf, cf, gi, ri, pi, rp, w0f, b0f, w1f,
                                    b1f, of, n_rows, f, g, st);
  return launch_filter_gather<8>(xf, rf, cf, gi, ri, pi, rp, w0f, b0f, w1f,
                                 b1f, of, n_rows, f, g, st);
}

// Pass P and its partial reduction: `partial` is scratch [n_parts, P] and
// `wgrad` receives [dW0 (G*F) | db0 (F) | dW1 (F*F) | db1 (F)].  `drbf`
// [E,G] and `dcm` [E] may be null; when given they must be zero-filled
// (masked edges are never written).
extern "C" int hg_scf_pass_p_f32(
    const void* h, const void* gout, const void* rbf, const void* cm,
    const void* send, const void* recv, const void* row_ptr, const void* w0,
    const void* b0, const void* w1, const void* w1t, const void* b1,
    void* partial, void* wgrad, void* drbf, void* dcm, int n_rows, int f,
    int g, int n_parts, void* stream) {
  if (n_rows <= 0 || f <= 0) return 0;
  if (f > kMaxF || g < 1 || g > kMaxG || n_parts < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* hf = static_cast<const float*>(h);
  const float* gf = static_cast<const float*>(gout);
  const float* rf = static_cast<const float*>(rbf);
  const float* cf = static_cast<const float*>(cm);
  const int* si = static_cast<const int*>(send);
  const int* ri = static_cast<const int*>(recv);
  const int* rp = static_cast<const int*>(row_ptr);
  const float* w0f = static_cast<const float*>(w0);
  const float* b0f = static_cast<const float*>(b0);
  const float* w1f = static_cast<const float*>(w1);
  const float* w1tf = static_cast<const float*>(w1t);
  const float* b1f = static_cast<const float*>(b1);
  float* pf = static_cast<float*>(partial);
  float* drf = static_cast<float*>(drbf);
  float* dcf = static_cast<float*>(dcm);
  int rc;
  if (f <= 256)
    rc = launch_pass_p<32>(hf, gf, rf, cf, si, ri, rp, w0f, b0f, w1f, w1tf,
                           b1f, pf, drf, dcf, n_rows, f, g, n_parts,
                           st);
  else if (f <= 512)
    rc = launch_pass_p<16>(hf, gf, rf, cf, si, ri, rp, w0f, b0f, w1f, w1tf,
                           b1f, pf, drf, dcf, n_rows, f, g, n_parts,
                           st);
  else
    rc = launch_pass_p<8>(hf, gf, rf, cf, si, ri, rp, w0f, b0f, w1f, w1tf,
                          b1f, pf, drf, dcf, n_rows, f, g, n_parts,
                          st);
  if (rc != 0) return rc;
  const int size = g * f + f + f * f + f;
  scf_reduce_partials_kernel<<<(size + 255) / 256, 256, 0, st>>>(
      pf, static_cast<float*>(wgrad), n_parts, size);
  return static_cast<int>(cudaGetLastError());
}
