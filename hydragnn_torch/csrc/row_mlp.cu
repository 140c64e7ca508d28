// Hand-written Hopper (sm_90a) kernels for DimeNet++'s row-local
// post-interaction chain
//
//   u  = silu(tri . W_0)                                (lin_up, no bias)
//   h  = x_ji + u
//   n_before x:  h = h + silu(silu(h . W_a + b_a) . W_b + b_b)
//   h  = silu(h . W + b) + x_edge
//   n_after x:   h = h + silu(silu(h . W_a + b_a) . W_b + b_b)
//
// Rows are independent: tri [E, Din], x_ji and x_edge [E, H] -> out
// [E, H], float32 row-major; Din, H <= 128; L = 2 + 2 (n_before + n_after)
// dense layers, weights packed [W_0 Din*H | W_1 H*H | ...] ([in, out]
// row-major), biases [L, H] (row 0 zero: lin_up has none).  Plain C
// interface, loaded with ctypes by hydragnn_torch/kernels/build.py; the
// wrappers, plain PyTorch versions and launch counters live in
// hydragnn_torch/ops/row_mlp.py.
//
// row_mlp_fwd_kernel — the forward.  Replaces
//   hydragnn_tpu/ops/row_mlp.py:_post_fwd (pl.pallas_call at :184).  Each
//   block takes RB rows at a time, holds them transposed in shared memory
//   ([feature][row], row stride RB + 4) and walks the L layers, staging
//   one layer's weights at a time (from L2) beside them; only tri, x_ji
//   and x_edge are read and out written.
// row_mlp_bwd_kernel (+ row_mlp_reduce_partials_kernel) — the backward.
//   Replaces :_post_vjp_bwd (pl.pallas_call at :228).  Per row tile it
//   recomputes the chain, keeping every layer's pre-activation z_k and
//   every residual state h that a layer reads, then walks the chain
//   backwards: dz_k = dpost * silu'(z_k), dW_k += in_k^T dz_k,
//   db_k += sum dz_k, d in_k = dz_k . W_k^T; it writes d tri, d x_ji (the
//   cotangent of h after lin_up) and d x_edge (that of h after lin) per
//   row.  dW and db sum into one float32 partial per block of a
//   persistent grid (one block per SM: 132 x 131 KB at H = 64, in device
//   memory, L2-resident), and the reduce kernel adds them in block order.
//
// Bound on the H100 SXM: operations.  Per row the forward does 2 (Din H +
// (L-1) H^2) flops against 3 rows in and 1 out (H = 64: ~66 kFLOP per ~1 KB),
// the backward about twice that again.  Design against it, first version:
// nothing but the inputs and outputs touches device memory per row; a
// weight is staged once per tile with an odd row stride (H | 1), so that
// the forward's products (threads along a row) and the backward's
// transposed ones (threads down a column) are free of bank conflicts; one
// 16-byte load of a transposed tile feeds four multiply-adds.  The tile
// height RB is the largest of 32, 16, 8 whose stored states fit a block's
// shared memory.  The backward, at one block per SM, waits mostly on L2:
// each tile re-stages every weight and reads and writes its dW partial, so
// it runs 16 warps, stages with 16-byte loads several in flight, and loads
// each partial entry before the dot product it is added to.  Not yet:
// tensor cores, keeping a layer's weight gradient in registers across
// tiles.
//
// silu(z) = z * sigmoid(z), silu'(z) = s (1 + z (1 - s)), s = sigmoid(z),
// sigmoid(z) = 1 / (1 + exp(-z)).  Determinism: fixed-order sums (row
// order within a tile, tile then block order for dW, db); no atomics.

#include <cuda_runtime.h>

namespace {

// threads per block: the backward, one block per SM (its state tiles fill
// the shared memory), hides the latency of its weight staging and partial
// updates with 16 warps
constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 512;
constexpr int EQ = 8;             // rows per work item
constexpr int kMaxH = 128;
constexpr int kFwdRows = 32;

struct Params {
  const float* tri;      // [E, Din]
  const float* xji;      // [E, H]
  const float* xe;       // [E, H]
  const float* w;        // packed weights
  const float* bias;     // [L, H]
  const float* gout;     // [E, H] (backward)
  float* out;            // forward: [E, H]
  float* dtri;           // backward: [E, Din] or null
  float* dxji;           // backward: [E, H] or null
  float* dxe;            // backward: [E, H] or null
  float* partial;        // backward: [gridDim.x, wgrad size]
  int n_rows, din, h, nb, na, L, rb, n_tiles;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline int w_offset(int k, int din, int h) {
  return k == 0 ? 0 : din * h + (k - 1) * h * h;
}

// the size of the packed weights and of one partial: [dW | db]
__host__ __device__ inline int wgrad_floats(int din, int h, int L) {
  return round4(w_offset(L, din, h) + L * h);
}

__host__ __device__ inline int fwd_smem_floats(int din, int h) {
  const int m = din > h ? din : h, ldt = kFwdRows + 4;
  return 3 * m * ldt + round4(m * (h | 1)) + round4(h);
}

// tiles the backward keeps: L pre-activations, nb + na + 2 residual
// states, tri, dh, dz, a scratch tile
__host__ __device__ inline int bwd_smem_floats(int din, int h, int L, int nb,
                                               int na, int rb) {
  const int m = din > h ? din : h, ldt = rb + 4;
  return (L + nb + na + 2 + 2) * h * ldt + 2 * m * ldt +
         round4(m * (h | 1)) + round4(h);
}

__device__ __forceinline__ float sigmoid_f(float z) {
  return 1.f / (1.f + expf(-z));
}

__device__ __forceinline__ float silu_f(float z) { return z * sigmoid_f(z); }

__device__ __forceinline__ float dsilu_f(float z) {
  const float s = sigmoid_f(z);
  return s * (1.f + z * (1.f - s));
}

// acc[j] += sum_k T[k][r0 + j] * w[k * stride] over k < K
__device__ __forceinline__ void mv(float (&acc)[EQ], const float* T, int ldt,
                                   int K, const float* w, int stride, int r0) {
  for (int k = 0; k < K; ++k) {
    const float wk = w[k * stride];
    const float4 lo = *reinterpret_cast<const float4*>(T + k * ldt + r0);
    const float4 hi = *reinterpret_cast<const float4*>(T + k * ldt + r0 + 4);
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

// stage layer k's weight [in, h] (row stride h | 1) and bias; 16-byte
// loads, several in flight, where the packed layers stay 16-byte aligned
template <int NT>
__device__ __forceinline__ void stage(float* ws, float* bs, const Params& p,
                                      int k) {
  const int in = k == 0 ? p.din : p.h, h = p.h, ld = h | 1;
  const float* src = p.w + w_offset(k, p.din, h);
  __syncthreads();  // the previous layer's readers are done
  if ((h & 3) == 0 && (p.din & 3) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll 4
    for (int i = threadIdx.x; i < in * h / 4; i += NT) {
      const float4 v = s4[i];
      float* d = ws + ((4 * i) / h) * ld + (4 * i) % h;
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
  } else {
    for (int i = threadIdx.x; i < in * h; i += NT)
      ws[(i / h) * ld + i % h] = src[i];
  }
  for (int i = threadIdx.x; i < h; i += NT)
    bs[i] = p.bias[k * h + i];
  __syncthreads();
}

// z [h][ldt] = bias + V [in][ldt] . W (staged)
template <int NT>
__device__ __forceinline__ void dense(float* z, const float* V, int in,
                                      const float* ws, const float* bs, int h,
                                      int ldt, int rb) {
  const int groups = rb / EQ, ld = h | 1;
  for (int it = threadIdx.x; it < h * groups; it += NT) {
    const int o = it % h, r0 = (it / h) * EQ;
    float acc[EQ];
#pragma unroll
    for (int j = 0; j < EQ; ++j) acc[j] = bs[o];
    mv(acc, V, ldt, in, ws + o, ld, r0);
#pragma unroll
    for (int j = 0; j < EQ; ++j) z[o * ldt + r0 + j] = acc[j];
  }
}

// dv [in][ldt] (= or +=) dz [h][ldt] . W^T (staged)
template <int NT>
__device__ __forceinline__ void dense_t(float* dv, bool add, const float* dz,
                                        int in, const float* ws, int h,
                                        int ldt, int rb) {
  const int groups = rb / EQ, ld = h | 1;
  for (int it = threadIdx.x; it < in * groups; it += NT) {
    const int i = it % in, r0 = (it / in) * EQ;
    float acc[EQ];
#pragma unroll
    for (int j = 0; j < EQ; ++j) acc[j] = add ? dv[i * ldt + r0 + j] : 0.f;
    mv(acc, dz, ldt, h, ws + i * ld, 1, r0);
#pragma unroll
    for (int j = 0; j < EQ; ++j) dv[i * ldt + r0 + j] = acc[j];
  }
}

// rows [r0, r0 + nr) of a row-major [E, width] array into a transposed
// tile; rows past nr read zeros
template <int NT>
__device__ __forceinline__ void load_tile(float* t, const float* src,
                                          int width, int r0, int nr, int rb,
                                          int ldt) {
  for (int i = threadIdx.x; i < rb * width; i += NT) {
    const int r = i / width, c = i - r * width;
    t[c * ldt + r] =
        r < nr ? src[static_cast<size_t>(r0 + r) * width + c] : 0.f;
  }
}

template <int NT>
__device__ __forceinline__ void store_tile(float* dst, const float* t,
                                           int width, int r0, int nr,
                                           int ldt) {
  for (int i = threadIdx.x; i < nr * width; i += NT) {
    const int r = i / width, c = i - r * width;
    dst[static_cast<size_t>(r0 + r) * width + c] = t[c * ldt + r];
  }
}

__global__ void __launch_bounds__(kFwdThreads)
row_mlp_fwd_kernel(const Params p) {
  constexpr int NT = kFwdThreads;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int h = p.h, din = p.din, m = din > h ? din : h;
  const int rb = kFwdRows, ldt = rb + 4;
  float* A = sm; sm += m * ldt;     // the running h
  float* T = sm; sm += m * ldt;     // tri, then t = silu(z_a)
  float* Z = sm; sm += m * ldt;     // a layer's output
  float* ws = sm; sm += round4(m * (h | 1));
  float* bs = sm;

  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const int r0 = tile * rb, nr = min(rb, p.n_rows - r0);
    __syncthreads();  // the previous tile's rows written out
    load_tile<NT>(T, p.tri, din, r0, nr, rb, ldt);
    stage<NT>(ws, bs, p, 0);
    dense<NT>(Z, T, din, ws, bs, h, ldt, rb);
    __syncthreads();
    load_tile<NT>(A, p.xji, h, r0, nr, rb, ldt);
    __syncthreads();
    for (int i = threadIdx.x; i < h * ldt; i += NT)
      A[i] += silu_f(Z[i]);
    int k = 1;
    for (int side = 0; side < 2; ++side) {
      const int pairs = side == 0 ? p.nb : p.na;
      for (int q = 0; q < pairs; ++q, k += 2) {
        stage<NT>(ws, bs, p, k);
        dense<NT>(Z, A, h, ws, bs, h, ldt, rb);
        __syncthreads();
        for (int i = threadIdx.x; i < h * ldt; i += NT)
          T[i] = silu_f(Z[i]);
        stage<NT>(ws, bs, p, k + 1);
        dense<NT>(Z, T, h, ws, bs, h, ldt, rb);
        __syncthreads();
        for (int i = threadIdx.x; i < h * ldt; i += NT)
          A[i] += silu_f(Z[i]);
      }
      if (side == 0) {
        // h = silu(h . W + b) + x_edge
        stage<NT>(ws, bs, p, k);
        dense<NT>(Z, A, h, ws, bs, h, ldt, rb);
        __syncthreads();
        load_tile<NT>(A, p.xe, h, r0, nr, rb, ldt);
        __syncthreads();
        for (int i = threadIdx.x; i < h * ldt; i += NT)
          A[i] += silu_f(Z[i]);
        ++k;
      }
    }
    __syncthreads();
    store_tile<NT>(p.out, A, h, r0, nr, ldt);
  }
}

// G[i*h + o] += sum_r V[i][r] * dZ[o][r] (i < in, o < h); G[boff + o] +=
// sum_r dZ[o][r]: one layer's weight and bias gradient into the partial
// (each entry's old value loaded first, so its latency hides behind the
// dot product)
template <int NT>
__device__ __forceinline__ void wgrad_acc(float* G, float* Gb, const float* V,
                                          int in, const float* dZ, int h,
                                          int ldt, int rb) {
#pragma unroll 2
  for (int it = threadIdx.x; it < in * h; it += NT) {
    const int i = it / h, o = it - i * h;
    const float* a = V + i * ldt;
    const float* b = dZ + o * ldt;
    float v = G[it];
    for (int q = 0; q < rb; q += 4) {
      const float4 x = *reinterpret_cast<const float4*>(a + q);
      const float4 y = *reinterpret_cast<const float4*>(b + q);
      v += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
    }
    G[it] = v;
  }
  if (Gb != nullptr) {
    for (int o = threadIdx.x; o < h; o += NT) {
      const float* b = dZ + o * ldt;
      float v = 0.f;
      for (int q = 0; q < rb; q += 4) {
        const float4 y = *reinterpret_cast<const float4*>(b + q);
        v += y.x + y.y + y.z + y.w;
      }
      Gb[o] += v;
    }
  }
}

__global__ void __launch_bounds__(kBwdThreads)
row_mlp_bwd_kernel(const Params p) {
  constexpr int NT = kBwdThreads;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int h = p.h, din = p.din, m = din > h ? din : h, L = p.L;
  const int nb = p.nb, na = p.na, rb = p.rb, ldt = rb + 4;
  const int tile_f = h * ldt;
  float* Zs = sm; sm += L * tile_f;                // pre-activations
  float* Hs = sm; sm += (nb + na + 2) * tile_f;    // residual states
  float* dH = sm; sm += tile_f;
  float* dZ = sm; sm += tile_f;
  float* T0 = sm; sm += m * ldt;                   // tri
  float* S = sm; sm += m * ldt;                    // scratch: t, dt, dtri
  float* ws = sm; sm += round4(m * (h | 1));
  float* bs = sm;

  const int gsize = wgrad_floats(din, h, L);
  float* G = p.partial + static_cast<size_t>(gsize) * blockIdx.x;
  float* Gb = G + w_offset(L, din, h);
  for (int i = threadIdx.x; i < gsize; i += NT) G[i] = 0.f;

  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const int r0 = tile * rb, nr = min(rb, p.n_rows - r0);
    __syncthreads();  // the previous tile's rows written out
    // ---- the chain again, keeping z_k and the residual states ----
    load_tile<NT>(T0, p.tri, din, r0, nr, rb, ldt);
    load_tile<NT>(Hs, p.xji, h, r0, nr, rb, ldt);
    stage<NT>(ws, bs, p, 0);
    dense<NT>(Zs, T0, din, ws, bs, h, ldt, rb);
    __syncthreads();
    for (int i = threadIdx.x; i < tile_f; i += NT)
      Hs[i] += silu_f(Zs[i]);
    int k = 1, hi = 0;   // hi: the residual state the next layer reads
    for (int side = 0; side < 2; ++side) {
      const int pairs = side == 0 ? nb : na;
      for (int q = 0; q < pairs; ++q, k += 2, ++hi) {
        float* hin = Hs + hi * tile_f;
        float* hout = hin + tile_f;
        float* za = Zs + k * tile_f;
        float* zb = za + tile_f;
        stage<NT>(ws, bs, p, k);
        dense<NT>(za, hin, h, ws, bs, h, ldt, rb);
        __syncthreads();
        for (int i = threadIdx.x; i < tile_f; i += NT)
          S[i] = silu_f(za[i]);
        stage<NT>(ws, bs, p, k + 1);
        dense<NT>(zb, S, h, ws, bs, h, ldt, rb);
        __syncthreads();
        for (int i = threadIdx.x; i < tile_f; i += NT)
          hout[i] = hin[i] + silu_f(zb[i]);
      }
      if (side == 0) {
        float* hin = Hs + hi * tile_f;
        float* hout = hin + tile_f;
        float* z = Zs + k * tile_f;
        stage<NT>(ws, bs, p, k);
        dense<NT>(z, hin, h, ws, bs, h, ldt, rb);
        __syncthreads();
        load_tile<NT>(hout, p.xe, h, r0, nr, rb, ldt);
        __syncthreads();
        for (int i = threadIdx.x; i < tile_f; i += NT)
          hout[i] += silu_f(z[i]);
        ++k;
        ++hi;
      }
    }
    // ---- backwards through the chain ----
    load_tile<NT>(dH, p.gout, h, r0, nr, rb, ldt);
    k = L - 1;
    for (int side = 1; side >= 0; --side) {
      const int pairs = side == 0 ? nb : na;
      for (int q = 0; q < pairs; ++q, k -= 2) {
        --hi;
        const float* hin = Hs + hi * tile_f;
        const float* za = Zs + (k - 1) * tile_f;
        const float* zb = Zs + k * tile_f;
        __syncthreads();
        // dz_b = dh * silu'(z_b); t = silu(z_a)
        for (int i = threadIdx.x; i < tile_f; i += NT) {
          dZ[i] = dH[i] * dsilu_f(zb[i]);
          S[i] = silu_f(za[i]);
        }
        __syncthreads();
        wgrad_acc<NT>(G + w_offset(k, din, h), Gb + k * h, S, h, dZ, h, ldt,
                      rb);
        stage<NT>(ws, bs, p, k);
        dense_t<NT>(S, false, dZ, h, ws, h, ldt, rb);  // dt = dz_b . W_b^T
        __syncthreads();
        for (int i = threadIdx.x; i < tile_f; i += NT)
          dZ[i] = S[i] * dsilu_f(za[i]);
        __syncthreads();
        wgrad_acc<NT>(G + w_offset(k - 1, din, h), Gb + (k - 1) * h, hin, h,
                      dZ, h, ldt, rb);
        stage<NT>(ws, bs, p, k - 1);
        dense_t<NT>(dH, true, dZ, h, ws, h, ldt, rb);  // dh += dz_a . W_a^T
      }
      if (side == 1) {
        // h = silu(h_in . W + b) + x_edge
        --hi;
        const float* hin = Hs + hi * tile_f;
        const float* z = Zs + k * tile_f;
        __syncthreads();
        if (p.dxe != nullptr) store_tile<NT>(p.dxe, dH, h, r0, nr, ldt);
        for (int i = threadIdx.x; i < tile_f; i += NT)
          dZ[i] = dH[i] * dsilu_f(z[i]);
        __syncthreads();
        wgrad_acc<NT>(G + w_offset(k, din, h), Gb + k * h, hin, h, dZ, h,
                      ldt, rb);
        stage<NT>(ws, bs, p, k);
        dense_t<NT>(dH, false, dZ, h, ws, h, ldt, rb);  // dh = dz . W^T
        --k;
      }
    }
    // h0 = x_ji + silu(tri . W_0)
    __syncthreads();
    if (p.dxji != nullptr) store_tile<NT>(p.dxji, dH, h, r0, nr, ldt);
    for (int i = threadIdx.x; i < tile_f; i += NT)
      dZ[i] = dH[i] * dsilu_f(Zs[i]);
    __syncthreads();
    wgrad_acc<NT>(G, nullptr, T0, din, dZ, h, ldt, rb);
    if (p.dtri != nullptr) {
      stage<NT>(ws, bs, p, 0);
      dense_t<NT>(S, false, dZ, din, ws, h, ldt, rb);  // dtri = dz_0 . W_0^T
      __syncthreads();
      store_tile<NT>(p.dtri, S, din, r0, nr, ldt);
    }
  }
}

__global__ void row_mlp_reduce_partials_kernel(const float* __restrict__ partial,
                                               float* __restrict__ out,
                                               int n_parts, int size) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= size) return;
  float v = 0.f;
  for (int q = 0; q < n_parts; ++q)
    v += partial[static_cast<size_t>(q) * size + j];
  out[j] = v;
}

int set_smem(const void* fn, size_t smem) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

}  // namespace

// The size in floats of the packed weights plus biases, of one
// weight-gradient partial and of `wgrad`: [dW packed | db L*H], padded to
// a multiple of 4.
extern "C" int hg_row_mlp_wgrad_size(int din, int h, int nb, int na) {
  return wgrad_floats(din, h, 2 + 2 * (nb + na));
}

// The backward's row-tile height at these widths (32, 16 or 8), or 0 when
// even 8 rows do not fit a block's shared memory.
extern "C" int hg_row_mlp_bwd_rows(int din, int h, int nb, int na) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  const int L = 2 + 2 * (nb + na);
  for (int rb = 32; rb >= 8; rb /= 2) {
    const size_t need = sizeof(float) *
        static_cast<size_t>(bwd_smem_floats(din, h, L, nb, na, rb));
    if (need <= static_cast<size_t>(optin)) return rb;
  }
  return 0;
}

// One row_mlp launch; returns the cudaError_t (0 = success).  mode 0: the
// forward (out [E, H]); mode 1: the backward (dtri [E, Din], dxji, dxe
// [E, H], each or null; `partial` [n_parts, wgrad size] scratch, `wgrad`
// the reduced [dW | db]).  Pointers are device pointers; launches go on
// `stream` and do not synchronise.
extern "C" int hg_row_mlp_f32(
    int mode, const void* tri, const void* xji, const void* xe,
    const void* w, const void* bias, const void* gout, void* out, void* dtri,
    void* dxji, void* dxe, void* partial, void* wgrad, int n_rows, int din,
    int h, int nb, int na, int n_parts, void* stream) {
  if (n_rows <= 0) return 0;
  if (din < 1 || din > kMaxH || h < 1 || h > kMaxH || nb < 0 || na < 0 ||
      mode < 0 || mode > 1 ||
      (mode == 0 && out == nullptr) ||
      (mode == 1 && (gout == nullptr || partial == nullptr ||
                     wgrad == nullptr || n_parts < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.tri = static_cast<const float*>(tri);
  p.xji = static_cast<const float*>(xji);
  p.xe = static_cast<const float*>(xe);
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.gout = static_cast<const float*>(gout);
  p.out = static_cast<float*>(out);
  p.dtri = static_cast<float*>(dtri);
  p.dxji = static_cast<float*>(dxji);
  p.dxe = static_cast<float*>(dxe);
  p.partial = static_cast<float*>(partial);
  p.n_rows = n_rows;
  p.din = din;
  p.h = h;
  p.nb = nb;
  p.na = na;
  p.L = 2 + 2 * (nb + na);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    p.rb = kFwdRows;
    p.n_tiles = (n_rows + p.rb - 1) / p.rb;
    const size_t smem = sizeof(float) *
                        static_cast<size_t>(fwd_smem_floats(din, h));
    const int rc = set_smem(reinterpret_cast<const void*>(row_mlp_fwd_kernel),
                            smem);
    if (rc != 0) return rc;
    row_mlp_fwd_kernel<<<p.n_tiles, kFwdThreads, smem, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  p.rb = hg_row_mlp_bwd_rows(din, h, nb, na);
  if (p.rb == 0) return static_cast<int>(cudaErrorInvalidValue);
  p.n_tiles = (n_rows + p.rb - 1) / p.rb;
  const int grid = n_parts < p.n_tiles ? n_parts : p.n_tiles;
  const size_t smem = sizeof(float) * static_cast<size_t>(
      bwd_smem_floats(din, h, p.L, nb, na, p.rb));
  int rc = set_smem(reinterpret_cast<const void*>(row_mlp_bwd_kernel), smem);
  if (rc != 0) return rc;
  row_mlp_bwd_kernel<<<grid, kBwdThreads, smem, st>>>(p);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int size = wgrad_floats(din, h, p.L);
  row_mlp_reduce_partials_kernel<<<(size + 255) / 256, 256, 0, st>>>(
      p.partial, static_cast<float*>(wgrad), grid, size);
  return static_cast<int>(cudaGetLastError());
}
