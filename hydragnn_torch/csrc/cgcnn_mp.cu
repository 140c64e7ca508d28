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
// One kernel template, three modes:
//
// cgcnn_kernel<kFwd>   — the forward.  Replaces
//   hydragnn_tpu/ops/fused_block.py:_fused_fwd with the cgcnn spec of
//   hydragnn_tpu/ops/cgcnn_mp.py (pl.pallas_call at :495).  Receiver
//   order (the receiver is the primary side; collate's receivers are
//   nondecreasing, so edge ids are CSR positions): each block owns kRows
//   receiver rows and walks their edges TE at a time, gathers x[r], x[s]
//   and ea into transposed shared-memory tiles, recomputes tf and ts and
//   adds sigmoid(tf) * softplus(ts) into the block's rows in edge order.
// cgcnn_kernel<kPassP> (+ cgcnn_reduce_partials_kernel) — backward pass P.
//   Replaces :_fused_bwd pass P (pl.pallas_call at :561).  Receiver order
//   again: recompute, take the cotangent dout[r] (the row's own), and
//     dtf = dout * softplus(ts) * sigmoid(tf) (1 - sigmoid(tf))
//     dts = dout * sigmoid(tf) * softplus'(ts)
//   then write dx of the receiver side (dtf.Wfr^T + dts.Wsr^T summed per
//   row), the per-edge d ea (dtf.Wfg^T + dts.Wsg^T) and the six weight
//   blocks' and two biases' gradients: each of n_parts blocks keeps one
//   float32 partial over all of its rows and writes it once; the reduce
//   kernel sums the partials in block order.
// cgcnn_kernel<kPassS> — backward pass S.  Replaces :_fused_bwd pass S
//   (pl.pallas_call at :599).  Sender order through edge_perm_sender:
//   recompute, gather the cotangent at the receiver, and sum dx of the
//   sender side (dtf.Wfs^T + dts.Wss^T) per sender row.
//
// Bound on the H100 SXM: operations.  Per real edge the forward does
// 2 * 2 * (2F + A) * D flops against ~(2F + A) * 4 bytes of gathered rows
// (F = D = 64: ~33 kFLOP per ~0.5 KB, far above the card's ~20 flop/byte
// float32 ridge); pass P about three times the forward, pass S twice.
// Design against it, first version: no [E, D] or [E, 2F+A] tensor reaches
// device memory (the gathered rows, tf, ts and their cotangents live in
// shared-memory tiles of TE edges); per-edge tiles are transposed ([k][e],
// row stride TE+4) so one 16-byte broadcast load feeds four multiply-adds;
// each thread computes EQ edges of one output column.  Weight staging: the
// six [rows, D] blocks and two biases are copied once per block into
// shared memory with an odd row stride (D | 1), so that a forward product
// (threads along a row) and a backward product (threads down a column) are
// both free of bank conflicts, and pass P keeps its weight-gradient
// partial there too.  At F = D = 64 that is 2 x 67 KB beside 41 KB of
// tiles.  Where weights (and partial) do not fit a block's 227 KB
// (F = D = 256: the six blocks alone are 1.5 MB), the kernel reads the
// weights from global memory (L2-resident, coalesced along D in the
// forward) and keeps the partial in device memory: correct and slow.  Not
// yet: tensor cores, the receiver-side product x[r].W once per row.
//
// Contract (collate guarantees it): positions are sorted by output row, so
// each row owns one contiguous CSR range; masked edges sort last in both
// orderings and are parked out of every range by the wrapper, so they are
// never read and every gradient on them is exactly zero (the wrapper
// zero-fills d ea).  Gather ids outside [0, n_rows) contribute nothing.
// Determinism: every sum runs in a fixed order (edge order within a row;
// tile, then block order for the weight gradients); no atomics.  Every
// output row is written, rows without edges as zeros.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int TE = 32;           // edges per tile
constexpr int EQ = 8;            // edges per work item
constexpr int kGroups = TE / EQ;
constexpr int LDT = TE + 4;      // row stride of a transposed tile
constexpr int kRows = 16;        // output rows per chunk
constexpr int kMaxF = 256;
constexpr int kMaxD = 256;
constexpr int kMaxA = 127;

constexpr int kFwd = 0;
constexpr int kPassP = 1;
constexpr int kPassS = 2;

struct Params {
  const float* x;        // [N, F]
  const float* ea;       // [E, A], or null when A = 0
  const int* send;       // [E]
  const int* recv;       // [E]
  const int* perm;       // [E] position -> edge id, or null (identity)
  const int* row_ptr;    // [N + 1] CSR over positions
  const float* w[8];     // wfr, wfs, wfg, bf, wsr, wss, wsg, bs
  const float* gout;     // [N, D] cotangent of out (backward)
  float* out;            // fwd: out [N, D]; pass P / S: dx [N, F] or null
  float* partial;        // pass P: [gridDim.x, wgrad size (ld = D)]
  float* dea;            // pass P: [E, A] (zero-filled) or null
  int n_rows, f, d, a, n_chunks;
  int stage;             // 1: weights (and partials) in shared memory
};

// offsets of the eight blocks in a packed layout with row stride ld:
// [wfr F | wfs F | wfg A | bf 1 | wsr F | wss F | wsg A | bs 1] rows of D;
// with ld = D the first 2F+A rows are dkf [2F+A, D] as the concat kernel
// lays it out.  Returns the total, rounded up to keep the next region
// 16-byte aligned.
__host__ __device__ inline int weight_layout(int f, int d, int a, int ld,
                                             int* off) {
  int o = 0;
  for (int half = 0; half < 2; ++half) {
    off[4 * half + 0] = o; o += f * ld;
    off[4 * half + 1] = o; o += f * ld;
    off[4 * half + 2] = o; o += a * ld;
    off[4 * half + 3] = o; o += d;
  }
  return (o + 3) & ~3;
}

__host__ __device__ inline int weight_rows(int i, int f, int a) {
  switch (i % 4) {
    case 0: case 1: return f;
    case 2: return a;
    default: return 1;
  }
}

__host__ __device__ inline int tile_floats(int mode, int f, int d, int a) {
  int n = (2 * f + a) * LDT + 2 * d * LDT;         // x[r], x[s], ea, tf, ts
  n += kRows * (mode == kFwd ? d : f);              // row sums
  n += 4 * TE;                                      // ids
  return n;
}

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

// G[k*ld + c] += sum_e A[k][e] * D[c][e] for k < K, c < d (a weight grad)
__device__ __forceinline__ void outer_acc(float* G, int ld, const float* A,
                                          int K, const float* D, int d) {
  for (int it = threadIdx.x; it < K * d; it += kThreads) {
    const int k = it / d, c = it - k * d;
    G[k * ld + c] += row_dot(A + k * LDT, D + c * LDT);
  }
}

// out tile [D][LDT] = bias + T0.W0 + T1.W1 (+ T2.W2): thread per output
// column c, EQ edges each
__device__ __forceinline__ void dense_tile(float* out, int d, const float* T0,
                                           const float* W0, const float* T1,
                                           const float* W1, int K01,
                                           const float* T2, const float* W2,
                                           int K2, const float* bias, int ld) {
  for (int it = threadIdx.x; it < d * kGroups; it += kThreads) {
    const int c = it % d, e0 = (it / d) * EQ;
    float acc[EQ];
    const float b = bias[c];
#pragma unroll
    for (int j = 0; j < EQ; ++j) acc[j] = b;
    mv(acc, T0, K01, W0 + c, ld, e0);
    mv(acc, T1, K01, W1 + c, ld, e0);
    if (K2 > 0) mv(acc, T2, K2, W2 + c, ld, e0);
    store8(out + c * LDT + e0, acc);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) cgcnn_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int f = p.f, d = p.d, a = p.a;
  const int n_rows = p.n_rows;
  const int tid = threadIdx.x;

  float* xr_t = sm; sm += f * LDT;     // x[r]; pass P: then dx per edge
  float* xs_t = sm; sm += f * LDT;     // x[s]; pass S: then dx per edge
  float* g_t = sm; sm += a * LDT;      // edge attributes
  float* tf_t = sm; sm += d * LDT;     // tf; fwd: then the message; bwd: dtf
  float* ts_t = sm; sm += d * LDT;     // ts; bwd: then dts
  const int ow = MODE == kFwd ? d : f;  // width of the row sums
  float* rows_s = sm; sm += kRows * ow;
  int* eid_s = reinterpret_cast<int*>(sm);
  int* s_s = eid_s + TE;
  int* r_s = s_s + TE;
  int* row_s = r_s + TE;
  sm += 4 * TE;

  // weights: staged in shared memory with row stride d | 1, or read from
  // global memory (row stride d) when they do not fit
  int off[8];
  const float* w[8];
  int ld = d;
  if (p.stage) {
    ld = d | 1;
    const int wsize = weight_layout(f, d, a, ld, off);
    for (int i = 0; i < 8; ++i) {
      const int rows = weight_rows(i, f, a);
      float* dst = sm + off[i];
      const int rld = i % 4 == 3 ? d : ld;
      for (int j = tid; j < rows * d; j += kThreads) {
        const int k = j / d, c = j - k * d;
        dst[k * rld + c] = p.w[i][j];
      }
      w[i] = dst;
    }
    sm += wsize;
  } else {
    for (int i = 0; i < 8; ++i) w[i] = p.w[i];
  }
  const float *wfr = w[0], *wfs = w[1], *wfg = w[2], *bf = w[3],
              *wsr = w[4], *wss = w[5], *wsg = w[6], *bs = w[7];

  // pass P: this block's weight-gradient partial (the weights' layout),
  // zeroed here, written once at the end
  float* gw[8] = {nullptr};
  if (MODE == kPassP) {
    float* base;
    int goff[8];
    int gsize;
    if (p.stage) {
      base = sm;
      gsize = weight_layout(f, d, a, ld, goff);
    } else {
      gsize = weight_layout(f, d, a, d, goff);
      base = p.partial + static_cast<size_t>(gsize) * blockIdx.x;
    }
    for (int j = tid; j < gsize; j += kThreads) base[j] = 0.f;
    for (int i = 0; i < 8; ++i) gw[i] = base + goff[i];
  }

  for (int chunk = blockIdx.x; chunk < p.n_chunks; chunk += gridDim.x) {
    const int r0 = chunk * kRows;
    const int r1 = min(r0 + kRows, n_rows);
    const int e_begin = p.row_ptr[r0];
    const int e_end = p.row_ptr[r1];
    __syncthreads();  // staging done; the previous chunk's rows written out
    for (int i = tid; i < kRows * ow; i += kThreads) rows_s[i] = 0.f;

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
            row = (MODE == kPassS ? s : r) - r0;
          }
        }
        eid_s[tid] = eid;
        s_s[tid] = s;
        r_s[tid] = r;
        row_s[tid] = row;
      }
      __syncthreads();
      // gather x[r], x[s] and the edge attributes, transposed; invalid and
      // out-of-tile edges read zeros
      for (int i = tid; i < TE * f; i += kThreads) {
        const int e = i / f, k = i - e * f;
        const int s = s_s[e], r = r_s[e];
        xr_t[k * LDT + e] = r >= 0 ? p.x[static_cast<size_t>(r) * f + k] : 0.f;
        xs_t[k * LDT + e] = s >= 0 ? p.x[static_cast<size_t>(s) * f + k] : 0.f;
      }
      for (int i = tid; i < TE * a; i += kThreads) {
        const int e = i / a, k = i - e * a;
        g_t[k * LDT + e] = s_s[e] >= 0
            ? p.ea[static_cast<size_t>(eid_s[e]) * a + k] : 0.f;
      }
      __syncthreads();
      // tf = bf + x[r].Wfr + x[s].Wfs + ea.Wfg; ts likewise
      dense_tile(tf_t, d, xr_t, wfr, xs_t, wfs, f, g_t, wfg, a, bf, ld);
      dense_tile(ts_t, d, xr_t, wsr, xs_t, wss, f, g_t, wsg, a, bs, ld);
      __syncthreads();

      if (MODE == kFwd) {
        // the message in place of tf, then rows += message in edge order
        for (int it = tid; it < d * TE; it += kThreads) {
          const int c = it / TE, e = it - c * TE;
          tf_t[c * LDT + e] = sigmoid_f(tf_t[c * LDT + e]) *
                              softplus_f(ts_t[c * LDT + e]);
        }
        __syncthreads();
        for (int c = tid; c < d; c += kThreads) {
          for (int e = 0; e < cnt; ++e)
            if (s_s[e] >= 0) rows_s[row_s[e] * d + c] += tf_t[c * LDT + e];
        }
        continue;
      }

      // ---- backward: the cotangent is gathered at the receiver ----
      for (int it = tid; it < d * TE; it += kThreads) {
        const int c = it / TE, e = it - c * TE;
        const int r = r_s[e];
        const float gc = (e < cnt && r >= 0)
            ? p.gout[static_cast<size_t>(r) * d + c] : 0.f;
        const float vf = tf_t[c * LDT + e], vs = ts_t[c * LDT + e];
        const float sf = sigmoid_f(vf);
        tf_t[c * LDT + e] = gc * softplus_f(vs) * (sf * (1.f - sf));
        ts_t[c * LDT + e] = gc * sf * softplus_grad(vs);
      }
      __syncthreads();
      if (MODE == kPassP) {
        // dWfr, dWfs, dWfg, dbf from dtf; dWsr, dWss, dWsg, dbs from dts
        outer_acc(gw[0], ld, xr_t, f, tf_t, d);
        outer_acc(gw[1], ld, xs_t, f, tf_t, d);
        outer_acc(gw[2], ld, g_t, a, tf_t, d);
        outer_acc(gw[4], ld, xr_t, f, ts_t, d);
        outer_acc(gw[5], ld, xs_t, f, ts_t, d);
        outer_acc(gw[6], ld, g_t, a, ts_t, d);
        for (int c = tid; c < d; c += kThreads) {
          gw[3][c] += row_sum(tf_t + c * LDT);
          gw[7][c] += row_sum(ts_t + c * LDT);
        }
        // d ea per edge = dtf.Wfg^T + dts.Wsg^T
        if (p.dea != nullptr) {
          for (int it = tid; it < a * TE; it += kThreads) {
            const int e = it / a, k = it - e * a;
            if (e >= cnt || s_s[e] < 0) continue;
            float v = 0.f;
            for (int c = 0; c < d; ++c)
              v += tf_t[c * LDT + e] * wfg[k * ld + c] +
                   ts_t[c * LDT + e] * wsg[k * ld + c];
            p.dea[static_cast<size_t>(eid_s[e]) * a + k] = v;
          }
        }
        __syncthreads();  // xr_t is overwritten next
      }
      if (p.out == nullptr) continue;
      // dx per edge = dtf.Wf_own^T + dts.Ws_own^T into the own side's x
      // tile, then summed per row in edge order
      float* dx_t = MODE == kPassP ? xr_t : xs_t;
      const float* wf_own = MODE == kPassP ? wfr : wfs;
      const float* ws_own = MODE == kPassP ? wsr : wss;
      for (int it = tid; it < f * kGroups; it += kThreads) {
        const int k = it % f, e0 = (it / f) * EQ;
        float acc[EQ];
#pragma unroll
        for (int j = 0; j < EQ; ++j) acc[j] = 0.f;
        mv(acc, tf_t, d, wf_own + k * ld, 1, e0);
        mv(acc, ts_t, d, ws_own + k * ld, 1, e0);
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
  }

  if (MODE == kPassP && p.stage) {
    // the shared partial, written once in the unpadded layout (row stride d)
    __syncthreads();
    int goff[8];
    const int gsize = weight_layout(f, d, a, d, goff);
    float* dst = p.partial + static_cast<size_t>(gsize) * blockIdx.x;
    // the alignment pad at the end stays unwritten: nothing reads it
    for (int i = 0; i < 8; ++i) {
      const int rows = weight_rows(i, f, a);
      const int rld = i % 4 == 3 ? d : ld;
      for (int j = tid; j < rows * d; j += kThreads) {
        const int k = j / d, c = j - k * d;
        dst[goff[i] + j] = gw[i][k * rld + c];
      }
    }
  }
}

__global__ void cgcnn_reduce_partials_kernel(const float* __restrict__ partial,
                                             float* __restrict__ out,
                                             int n_parts, int size) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= size) return;
  float v = 0.f;
  for (int b = 0; b < n_parts; ++b)
    v += partial[static_cast<size_t>(b) * size + j];
  out[j] = v;
}

template <int MODE>
int launch(Params p, int grid, cudaStream_t st) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int off[8];
  const size_t tiles = sizeof(float) *
                       static_cast<size_t>(tile_floats(MODE, p.f, p.d, p.a));
  const size_t wts = sizeof(float) *
                     static_cast<size_t>(weight_layout(p.f, p.d, p.a, p.d | 1,
                                                       off));
  const size_t staged = tiles + wts * (MODE == kPassP ? 2 : 1);
  p.stage = staged <= static_cast<size_t>(optin) ? 1 : 0;
  const size_t smem = p.stage ? staged : tiles;
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(cgcnn_kernel<MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cgcnn_kernel<MODE><<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The size in floats of one weight-gradient partial (and of `wgrad`):
// [dWfr F*D | dWfs F*D | dWfg A*D | dbf D | dWsr | dWss | dWsg | dbs],
// padded to a multiple of 4.
extern "C" int hg_cgcnn_wgrad_size(int f, int d, int a) {
  int off[8];
  return weight_layout(f, d, a, d, off);
}

// One cgcnn launch; returns the cudaError_t (0 = success).  mode 0: the
// forward (out [N, D]; rows are receivers, `perm` null); mode 1: pass P
// (out = dx [N, F] or null, `partial` scratch [n_parts, wgrad size],
// `wgrad` the reduced weight gradients, `dea` [E, A] zero-filled or null;
// receiver order); mode 2: pass S (out = dx [N, F]; rows are senders,
// `perm` the sender permutation).  Pointers are device pointers; launches
// go on `stream` and do not synchronise.
extern "C" int hg_cgcnn_f32(
    int mode, const void* x, const void* ea, const void* send,
    const void* recv, const void* perm, const void* row_ptr, const void* wfr,
    const void* wfs, const void* wfg, const void* bf, const void* wsr,
    const void* wss, const void* wsg, const void* bs, const void* gout,
    void* out, void* partial, void* wgrad, void* dea, int n_rows, int f,
    int d, int a, int n_parts, void* stream) {
  if (n_rows <= 0) return 0;
  if (f < 1 || f > kMaxF || d < 1 || d > kMaxD || a < 0 || a > kMaxA ||
      mode < kFwd || mode > kPassS || (mode == kPassP && n_parts < 1) ||
      (a > 0 && ea == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.x = static_cast<const float*>(x);
  p.ea = static_cast<const float*>(ea);
  p.send = static_cast<const int*>(send);
  p.recv = static_cast<const int*>(recv);
  p.perm = static_cast<const int*>(perm);
  p.row_ptr = static_cast<const int*>(row_ptr);
  const void* ws[8] = {wfr, wfs, wfg, bf, wsr, wss, wsg, bs};
  for (int i = 0; i < 8; ++i) p.w[i] = static_cast<const float*>(ws[i]);
  p.gout = static_cast<const float*>(gout);
  p.out = static_cast<float*>(out);
  p.partial = static_cast<float*>(partial);
  p.dea = static_cast<float*>(dea);
  p.n_rows = n_rows;
  p.f = f;
  p.d = d;
  p.a = a;
  p.n_chunks = (n_rows + kRows - 1) / kRows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kFwd) return launch<kFwd>(p, p.n_chunks, st);
  if (mode == kPassS) return launch<kPassS>(p, p.n_chunks, st);
  const int grid = n_parts < p.n_chunks ? n_parts : p.n_chunks;
  const int rc = launch<kPassP>(p, grid, st);
  if (rc != 0) return rc;
  const int size = hg_cgcnn_wgrad_size(f, d, a);
  cgcnn_reduce_partials_kernel<<<(size + 255) / 256, 256, 0, st>>>(
      p.partial, static_cast<float*>(wgrad), grid, size);
  return static_cast<int>(cudaGetLastError());
}
