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
// The forward replaces hydragnn_tpu/ops/row_mlp.py:_post_fwd
//   (pl.pallas_call at :184).  Two routes, chosen by width
//   (hg_row_mlp_fwd_route):
//
// row_mlp_fwd_tc_kernel<L> — route 1: the backward's route-1 widths (Din,
//   H <= 64, L <= 8), the arch sweep's DimeNet (64, 64, L = 8) among them.
//   A persistent grid (one block per SM at most, 16 warps); every layer's
//   weight, zero-padded to 64 x 64, and bias is staged once per block (130
//   KB at L = 8) and stays.  Then each warp takes its own 16-row tiles with
//   no block barrier, and a tile's rows never pass through shared memory
//   between layers: with the 64 columns of every layer's output permuted
//   (fwd_physical), a layer's tensor-core accumulators are, value for value
//   and lane for lane, the next layer's A fragments, so the layer's input
//   (tri, h or t = silu(z_a)) stays in registers, and each lane's values of
//   a row are float4s of it in memory.  The running h waits in the lane's
//   own float4 slots of shared memory (64 KB for 16 warps), where x_ji, at
//   the tile's start, and x_edge, when lin begins (h being lin's input),
//   are copied asynchronously.  Every product [16 x 64] . [64 x 64] runs in
//   3xTF32 (mma.sync m16n8k8 through csrc/pass_p.cuh, each k step's three
//   products from zero, then a float32 add; hi rounded by integer
//   operations, lo passed untruncated; one float4 load gives a B
//   fragment's two k steps); bias and silu are applied to the accumulators;
//   the last layer writes out, once.  What held the first design back was
//   the weight stage: per 32-row tile and per layer, a 16 KB weight copied
//   from L2 between two block barriers (~240 MB a launch at the dimenet
//   cell's first batch, four times the rows' own bytes), and products on
//   the CUDA cores.
// row_mlp_fwd_kernel — route 2: the first design, for every other width up
//   to 128.  Each block takes RB rows at a time, holds them transposed in
//   shared memory ([feature][row], row stride RB + 4) and walks the L
//   layers, staging one layer's weights at a time (from L2) beside them;
//   only tri, x_ji and x_edge are read and out written.
// The backward replaces :_post_vjp_bwd (pl.pallas_call at :228).  Per row
//   tile it recomputes the chain, keeping every layer's pre-activation
//   z_k, then walks the chain backwards: dz_k = dpost * silu'(z_k), dW_k
//   += in_k^T dz_k, db_k += sum dz_k, d in_k = dz_k . W_k^T; it writes
//   d tri, d x_ji (the cotangent of h after lin_up) and d x_edge (that of
//   h after lin) per row.  dW and db sum into one float32 partial per
//   block of a persistent grid (one block per SM), and
//   passp::reduce_partials_kernel adds the partials in block order,
//   compensated.  Two routes, chosen by width (hg_row_mlp_bwd_route):
//
// row_mlp_bwd_tc_kernel<L> — route 1: Din, H <= 64 and L <= 8 (at most
//   three residual pairs), the arch sweep's DimeNet (64, 64, L = 8)
//   among them.  Din and H pad to 64 with zeros.  Every layer's weight and
//   bias is staged into shared memory once per block (128 KB at L = 8) and
//   stays there; the weight gradients stay in the tensor cores'
//   accumulator fragments (registers) over the block's whole share of
//   rows: each of the 16 warps owns one 16 x 16 block of every dW_k, 8
//   floats a thread per layer; the bias gradients stay in shared memory
//   (compensated sums).  The block writes its partial once, at the end.
//   Tiles are 16 rows (one m16 fragment).  At a tile's start every thread
//   loads its two elements of tri, x_ji, x_edge and dout, so no later
//   phase waits on device memory; the block keeps the pre-activations
//   but the last (whose backward step joins the recompute's last phase),
//   not the residual states: each state a layer reads is rebuilt
//   elementwise from the stored z_k and x_ji or x_edge with the
//   operations of the recompute, so its bits are the recompute's.  Every
//   product (the recompute h . W_k, dz . W_k^T, in_k^T . dz) runs on the
//   tensor cores in 3xTF32 (mma.sync m16n8k8 through csrc/pass_p.cuh: each
//   k step's three products from zero, then a float32 add).  Operands are
//   split into hi and lo with hi rounded by integer operations
//   (passp::split_ih); dz, which two products read and four warps share
//   each fragment of, is split once, as it is formed, and stored as its
//   hi and lo tiles.  A 16 x 64
//   row product splits over the 16 warps as 4 column blocks x 4 depth
//   quarters (each A fragment feeds two column tiles), and the
//   elementwise pass that follows adds the quarters in order.  The
//   weights and the tiles read as fragments have a row stride of 64 + 4
//   (fragments taken along rows hit 32 banks, those down columns two lanes
//   a bank), so every fragment address is a per-lane base plus a constant.
// row_mlp_bwd_kernel — route 2: every other width up to 128.  Per tile of
//   32, 16 or 8 rows it stages each layer's weight from L2 again, keeps
//   every residual state a layer reads beside the pre-activations, runs
//   its products on the CUDA cores and adds each tile's dW, db into its
//   block's partial in device memory.
//
// Bound on the H100 SXM: operations.  Per row the forward does 2 (Din H +
// (L-1) H^2) flops against 3 rows in and 1 out (H = 64: ~66 kFLOP per ~1 KB),
// the backward three times the products; at 3xTF32 on the tensor cores
// (the routes 1) the bound is a third of the tensor cores' TF32 rate.  In
// the forward and in route 2 of the backward nothing but the inputs and
// outputs touches device memory per row; in the first designs a weight is
// staged once per tile with an odd row stride (H | 1), so that
// the forward's products (threads along a row) and the backward's
// transposed ones (threads down a column) are free of bank conflicts; one
// 16-byte load of a transposed tile feeds four multiply-adds.
//
// silu(z) = z * sigmoid(z), silu'(z) = s (1 + z (1 - s)), s = sigmoid(z),
// sigmoid(z) = 1 / (1 + exp(-z)).  Determinism: fixed-order sums (row
// order within a tile, tile then block order for dW, db); no atomics.

#include <cuda_runtime.h>

#include "pass_p.cuh"

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
  // the forward's route 1: tri (vec_d) and x_ji, x_edge and out (vec_h)
  // have a width that is a multiple of 4 and 16-byte aligned rows
  bool vec_d, vec_h;
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

// ---------------------------------------------------------------------------
// route 1: weights resident, weight gradients in registers, tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 512;
constexpr int kTcRows = 16;        // rows per tile: one m16 fragment
constexpr int kTcW = 64;           // Din and H pad to 64
constexpr int kTcMaxLayers = 8;    // 8 accumulator floats a thread a layer
constexpr int kTcParts = 4;        // a product's depth quarters
// row strides: tiles read as fragments and the weights (64 + 4: a
// fragment's 8 rows x 4 columns hit 32 banks, 4 rows x 8 columns 16), the
// product quarters (64 + 8: the accumulator stores), tiles read only
// elementwise (64)
constexpr int kLdF = kTcW + 4;
constexpr int kLdP = kTcW + 8;
constexpr int kTileF = kTcRows * kLdF;
constexpr int kTileP = kTcRows * kLdP;
constexpr int kTileE = kTcRows * kTcW;
constexpr int kLayer = kTcW * kLdF;

// a layer's role in the chain
constexpr int kUp = 0;     // lin_up: input tri
constexpr int kA = 1;      // first layer of a residual pair: input h
constexpr int kB = 2;      // second layer of a pair: input t = silu(z_a)
constexpr int kLin = 3;    // lin: input h, then + x_edge

// resident weights [L][64 x kLdF], biases, db sums and their compensation
// [L x 64] each, the db column pre-sums [8 x 64]; L - 1 pre-activation
// tiles, dH, x_ji, x_edge (elementwise), h, t, dz's hi and lo, tri
// (fragments) and the four product quarters
__host__ __device__ inline int tc_smem_floats(int L) {
  return L * kLayer + 3 * L * kTcW + 8 * kTcW + (L + 2) * kTileE +
         5 * kTileF + kTcParts * kTileP;
}

__device__ __forceinline__ int tc_role(int k, int nb) {
  if (k == 0) return kUp;
  if (k <= 2 * nb) return (k & 1) ? kA : kB;
  if (k == 2 * nb + 1) return kLin;
  return ((k - 2 * nb) & 1) ? kB : kA;
}

// the residual state that layer k (kA or kLin) reads: h^(q) after q pairs
// before the skip, h^(nb + 1 + q) after lin and q pairs after it
__device__ __forceinline__ int tc_state_in(int k, int nb) {
  if (k <= 2 * nb + 1) return (k - 1) / 2;
  return nb + 1 + (k - 2 * nb - 2) / 2;
}

// A fragment (16 x 8) of a fragment tile (row stride kLdF) whose element
// (m, k) is T(m0 + m, k0 + k), or with TR T(k0 + k, m0 + m)
template <bool TR>
__device__ __forceinline__ void tc_load_a(passp::FragA& a, const float* T,
                                          int m0, int k0) {
  if (TR)
    passp::load_a<true>(a, T + k0 * kLdF + m0, 1, kLdF);
  else
    passp::load_a<true>(a, T + m0 * kLdF + k0, kLdF, 1);
}

// B fragment (8 x 8) whose element (k, n) is W(k0 + k, n0 + n), or with TR
// W(n0 + n, k0 + k) (row stride kLdF)
template <bool TR>
__device__ __forceinline__ void tc_load_b(passp::FragB& b, const float* W,
                                          int k0, int n0) {
  if (TR)
    passp::load_b<true>(b, W + n0 * kLdF + k0, 1, kLdF);
  else
    passp::load_b<true>(b, W + k0 * kLdF + n0, kLdF, 1);
}

// fragments of a tile split in advance: hi and lo tiles of one layout
__device__ __forceinline__ void load_a_pre(passp::FragA& a, const uint32_t* hi,
                                           const uint32_t* lo, int sm, int sk) {
  const int g = passp::lane_g(), t = passp::lane_t();
  const int o0 = g * sm + t * sk, o1 = (g + 8) * sm + t * sk;
  const int o2 = g * sm + (t + 4) * sk, o3 = (g + 8) * sm + (t + 4) * sk;
  a.hi[0] = hi[o0]; a.hi[1] = hi[o1]; a.hi[2] = hi[o2]; a.hi[3] = hi[o3];
  a.lo[0] = lo[o0]; a.lo[1] = lo[o1]; a.lo[2] = lo[o2]; a.lo[3] = lo[o3];
}

__device__ __forceinline__ void load_b_pre(passp::FragB& b, const uint32_t* hi,
                                           const uint32_t* lo, int sk, int sn) {
  const int g = passp::lane_g(), t = passp::lane_t();
  const int o0 = t * sk + g * sn, o1 = (t + 4) * sk + g * sn;
  b.hi[0] = hi[o0]; b.hi[1] = hi[o1];
  b.lo[0] = lo[o0]; b.lo[1] = lo[o1];
}

// A [16 x 64] . op(W) into the four product quarters P: op(W)(i, o) =
// W(i, o), with TR W(o, i); warp w takes the 16 columns 16 (w mod 4) over
// the 16 rows of depth 16 (w / 4)
template <bool TR, bool PRE = false>
__device__ __forceinline__ void tc_chain(float* P, const float* A,
                                         const float* W, int warp,
                                         const uint32_t* Ah = nullptr,
                                         const uint32_t* Al = nullptr) {
  const int n0 = 16 * (warp & 3), k0 = 16 * (warp >> 2);
  float c[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < 16; kk += 8) {
    passp::FragA a;
    if (PRE)
      load_a_pre(a, Ah + k0 + kk, Al + k0 + kk, kLdF, 1);
    else
      tc_load_a<false>(a, A, 0, k0 + kk);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      passp::FragB b;
      tc_load_b<TR>(b, W, k0 + kk, n0 + 8 * j);
      passp::mma3(c[j], a, b);
    }
  }
  float* out = P + (warp >> 2) * kTileP + passp::lane_g() * kLdP + n0 +
               2 * passp::lane_t();
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    out[8 * j] = c[j][0];
    out[8 * j + 1] = c[j][1];
    out[8 * kLdP + 8 * j] = c[j][2];
    out[8 * kLdP + 8 * j + 1] = c[j][3];
  }
}

// acc += In^T . dZ on the warp's 16 x 16 block (16 (w / 4), 16 (w mod 4))
// of [64 x 64] (In, dZ [16 x 64] fragment tiles)
__device__ __forceinline__ void tc_wgrad(float (&acc)[2][4], const float* In,
                                         const uint32_t* dZh,
                                         const uint32_t* dZl, int warp) {
  const int m0 = 16 * (warp >> 2), n0 = 16 * (warp & 3);
#pragma unroll
  for (int kk = 0; kk < kTcRows; kk += 8) {
    passp::FragA a;
    tc_load_a<true>(a, In, m0, kk);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      passp::FragB b;
      load_b_pre(b, dZh + kk * kLdF + n0 + 8 * j, dZl + kk * kLdF + n0 + 8 * j,
                 kLdF, 1);
      passp::mma3(acc[j], a, b);
    }
  }
}

// the four depth quarters of a product at element offset o (r kLdP + c),
// in order
__device__ __forceinline__ float tc_sum(const float* P, int o) {
  return ((P[o] + P[kTileP + o]) + P[2 * kTileP + o]) + P[3 * kTileP + o];
}

template <int L>
__global__ void __launch_bounds__(kTcThreads, 1)
row_mlp_bwd_tc_kernel(const Params p) {
  constexpr int NT = kTcThreads;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int din = p.din, h = p.h, nb = p.nb;
  const int tid = threadIdx.x, warp = tid >> 5;
  float* ws = sm; sm += L * kLayer;        // weights [64 x kLdF]
  float* bs = sm; sm += L * kTcW;          // biases
  float* dbs = sm; sm += L * kTcW;         // db, compensated: dbs + dbc
  float* dbc = sm; sm += L * kTcW;
  float* db8 = sm; sm += 8 * kTcW;         // a tile's dz column pair sums
  float* Z = sm; sm += (L - 1) * kTileE;   // pre-activations but the last
  float* dH = sm; sm += kTileE;            // the cotangent of h
  float* Xj = sm; sm += kTileE;            // the tile's x_ji, x_edge
  float* Xe = sm; sm += kTileE;
  float* Th = sm; sm += kTileF;            // h: running, rebuilt
  float* Ts = sm; sm += kTileF;            // t = silu(z_a)
  uint32_t* dZh = reinterpret_cast<uint32_t*>(sm); sm += kTileF;
  uint32_t* dZl = reinterpret_cast<uint32_t*>(sm); sm += kTileF;
  float* Tri = sm; sm += kTileF;           // the tile's tri
  float* P = sm;                           // a product's depth quarters

  for (int i = tid; i < L * kLayer; i += NT) {
    const int k = i / kLayer, rr = i - k * kLayer;
    const int r = rr / kLdF, c = rr - r * kLdF;
    ws[i] = r < (k == 0 ? din : h) && c < h
        ? p.w[w_offset(k, din, h) + r * h + c] : 0.f;
  }
  for (int i = tid; i < L * kTcW; i += NT) {
    const int k = i / kTcW, c = i - k * kTcW;
    bs[i] = c < h ? p.bias[k * h + c] : 0.f;
    dbs[i] = 0.f;
    dbc[i] = 0.f;
  }
  float acc[L][2][4];
#pragma unroll
  for (int k = 0; k < L; ++k)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[k][j][v] = 0.f;

  // this thread's two elements of every tile: rows er and er + 8, column
  // ec; their offsets in the elementwise, fragment and quarter tiles
  const int er = tid >> 6, ec = tid & (kTcW - 1);
  const int oe = er * kTcW + ec, of = er * kLdF + ec, op = er * kLdP + ec;

  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const int r0 = tile * kTcRows, nr = min(kTcRows, p.n_rows - r0);
    // element u's offset into a row-major [E, width] array, or -1 past the
    // tile's rows or the width
    auto off = [&](int u, int width) -> long long {
      const int r = er + 8 * u;
      return r < nr && ec < width
          ? static_cast<long long>(r0 + r) * width + ec : -1;
    };
    // the state that layer k reads, rebuilt at element u as the recompute
    // below builds it
    auto rebuild = [&](int k, int u) {
      const int s = tc_state_in(k, nb), e = oe + u * 8 * kTcW;
      float v;
      if (s <= nb) {
        v = Xj[e] + silu_f(Z[e]);
        for (int q = 0; q < s; ++q)
          v = v + silu_f(Z[(2 + 2 * q) * kTileE + e]);
      } else {
        v = Xe[e] + silu_f(Z[(2 * nb + 1) * kTileE + e]);
        for (int q = 0; q < s - nb - 1; ++q)
          v = v + silu_f(Z[(2 * nb + 3 + 2 * q) * kTileE + e]);
      }
      return v;
    };
    // layer j ready for its products at element u: dz from the cotangent
    // of its output and its pre-activation zj (dz split into dZh, dZl;
    // returned for its column pair sum), its input into Ts or Th, and d
    // x_edge, d x_ji where that cotangent is theirs
    auto prep = [&](int j, float dpost, float zj, int u) {
      const int role = tc_role(j, nb);
      const int e = oe + u * 8 * kTcW, f = of + u * 8 * kLdF;
      const long long o = off(u, h);
      if (o >= 0 && role == kLin && p.dxe != nullptr) p.dxe[o] = dpost;
      if (o >= 0 && j == 0 && p.dxji != nullptr) p.dxji[o] = dpost;
      const float dz = dpost * dsilu_f(zj);
      passp::split_ih(dz, dZh[f], dZl[f]);
      if (role == kB) Ts[f] = silu_f(Z[(j - 1) * kTileE + e]);
      else if (role != kUp) Th[f] = rebuild(j, u);
      return dz;
    };

    // the tile's rows of tri, x_ji, x_edge and dout, zero-padded (the
    // previous tile read them last before its final two barriers)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = oe + u * 8 * kTcW;
      const long long oi = off(u, din), oh = off(u, h);
      Tri[of + u * 8 * kLdF] = oi >= 0 ? p.tri[oi] : 0.f;
      Xj[e] = oh >= 0 ? p.xji[oh] : 0.f;
      Xe[e] = oh >= 0 ? p.xe[oh] : 0.f;
      dH[e] = oh >= 0 ? p.gout[oh] : 0.f;
    }
    __syncthreads();
    // ---- the chain again, keeping every pre-activation ----
#pragma unroll 1
    for (int k = 0; k < L; ++k) {
      const int role = tc_role(k, nb);
      tc_chain<false>(P, role == kUp ? Tri : role == kB ? Ts : Th,
                      ws + k * kLayer, warp);
      __syncthreads();
      float dzs = 0.f;   // the last layer's dz column pair sum
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = oe + u * 8 * kTcW, f = of + u * 8 * kLdF;
        const float z = tc_sum(P, op + u * 8 * kLdP) + bs[k * kTcW + ec];
        if (k == L - 1) {
          // the chain's output is not needed: the last layer is made
          // ready for the backward instead (dH holds dout)
          dzs += prep(L - 1, dH[e], z, u);
          continue;
        }
        Z[k * kTileE + e] = z;
        if (role == kUp) Th[f] = Xj[e] + silu_f(z);
        else if (role == kA) Ts[f] = silu_f(z);
        else if (role == kB) Th[f] = Th[f] + silu_f(z);
        else Th[f] = Xe[e] + silu_f(z);
      }
      if (k == L - 1) db8[oe] = dzs;
      __syncthreads();
    }
    // ---- backwards through the chain ----
#pragma unroll 1
    for (int k = L - 1; k >= 0; --k) {
      const int role = tc_role(k, nb);
      const float* in = role == kUp ? Tri : role == kB ? Ts : Th;
      // acc[k] in registers: one unrolled copy of the product per layer
#pragma unroll
      for (int q = 0; q < L; ++q)
        if (q == k) tc_wgrad(acc[q], in, dZh, dZl, warp);
      if (k > 0 && tid < h) {
        // db_k += the tile's column sum: its pair sums, rows in order
        float v = 0.f;
#pragma unroll
        for (int r = 0; r < 8; ++r) v += db8[r * kTcW + tid];
        passp::add_comp(dbs[k * kTcW + tid], dbc[k * kTcW + tid], v);
      }
      if (k > 0 || p.dtri != nullptr)    // d in_k = dz . W_k^T
        tc_chain<true, true>(P, nullptr, ws + k * kLayer, warp, dZh, dZl);
      __syncthreads();
      if (k == 0) {
        if (p.dtri != nullptr)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const long long o = off(u, din);
            if (o >= 0) p.dtri[o] = tc_sum(P, op + u * 8 * kLdP);
          }
        continue;   // the next tile starts with a barrier
      }
      float dz = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = oe + u * 8 * kTcW;
        const float d = tc_sum(P, op + u * 8 * kLdP);
        float dpost = d;   // kB: the cotangent of t, layer k - 1's output
        if (role != kB) {
          dpost = role == kA ? dH[e] + d : d;   // lin: h feeds only lin
          dH[e] = dpost;
        }
        dz += prep(k - 1, dpost, Z[(k - 1) * kTileE + e], u);
      }
      db8[oe] = dz;
      __syncthreads();
    }
  }

  // this block's partial, once: [dW packed | db L*H], padded with zeros
  __syncthreads();
  const int gsize = wgrad_floats(din, h, L);
  float* G = p.partial + static_cast<size_t>(gsize) * blockIdx.x;
  const int g = passp::lane_g(), t = passp::lane_t();
  const int m0 = 16 * (warp >> 2), n0 = 16 * (warp & 3);
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int in = k == 0 ? din : h;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int i = m0 + g + 8 * (v >> 1), o = n0 + 8 * j + 2 * t + (v & 1);
        if (i < in && o < h) G[w_offset(k, din, h) + i * h + o] = acc[k][j][v];
      }
  }
  const int boff = w_offset(L, din, h);
  for (int i = tid; i < gsize - boff; i += NT) {
    const int k = i / h, o = i - k * h;
    G[boff + i] = k > 0 && k < L ? dbs[k * kTcW + o] + dbc[k * kTcW + o]
                                 : 0.f;
  }
}

// ---------------------------------------------------------------------------
// the forward's route 1: weights resident, each warp on its own row tiles,
// tensor cores
// ---------------------------------------------------------------------------

constexpr int kFwdTcWarps = 16;
constexpr int kFwdTcThreads = kFwdTcWarps * 32;
constexpr int kFwdTcRows = 16;       // rows a warp's tile: one m16 fragment
constexpr int kFwdLayer = kTcW * kTcW;
// a warp's running h in float4s: each lane's 8 groups (below), group q of
// lane l at q * 32 + l (no lane reads another's)
constexpr int kFwdH = 8 * 32;

// Column order.  A layer's accumulators are the next layer's A operand with
// no data movement, and every row's values a lane holds are float4s in
// memory, when the 64 columns of every layer's output are permuted: the C
// fragment's column 2t + u of n-tile j = 2m + s (m < 4) is logical column
// 16 m + 4 t + 2 s + u, and the k index of an A fragment's step j follows
// the same order (slot t: 16 m + 4 t + 2 s, slot t + 4: that + 1).  So lane
// (g, t) holds, of rows g and g + 8, the logical columns 16 m + 4 t .. + 3:
// group (m, r) = (x[2m][2r], x[2m][2r + 1], x[2m + 1][2r], x[2m + 1][2r +
// 1]) is one float4 of row g + 8 r.  Physical column p = 8 j + g of a B
// fragment is logical column 16 (j >> 1) + 4 (g >> 1) + 2 (j & 1) + (g &
// 1); fwd_physical maps a logical column n back to p.
__device__ __forceinline__ int fwd_physical(int n) {
  return 16 * (n >> 4) + 8 * ((n >> 1) & 1) + 2 * ((n >> 2) & 3) + (n & 1);
}

// The weights sit transposed, row p (physical output column) holding
// column n of W_k (p = fwd_physical(n)) over k, 16 float4 chunks a row;
// chunk c at c ^
// fwd_swz(p), so that a B load (rows 8j + g, chunks 4m + t) and a staging
// store (eight consecutive logical columns, one chunk) each hit every bank
// once a quarter-warp
__device__ __forceinline__ int fwd_swz(int p) {
  return ((p & 1) << 2) | ((p >> 1) & 1) | ((p >> 2) & 2);
}

// weights [L][64 x 64] (transposed, swizzled), biases [L x 64] in logical
// order, each warp's running h
__host__ __device__ inline int fwd_tc_smem_floats(int L) {
  return L * (kFwdLayer + kTcW) + kFwdTcWarps * kFwdH * 4;
}

// dst (shared) = BYTES of src (global), zero-filled past `valid` bytes,
// asynchronously
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const float* src,
                                         int valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// visit(m, r, ptr, n) for each group of the lane's values of a row-major
// [E, width] array (the tile's rows from r0, nr of them): ptr the group's
// first entry (the array's first where n == 0), n its valid entries
// (columns inside the width, 0 past the tile's rows); a width that is a
// multiple of 4 gives whole groups
template <class T, class F>
__device__ __forceinline__ void fwd_tc_visit(T* a, int width, int r0, int nr,
                                             F visit) {
  const int g = passp::lane_g(), t = passp::lane_t();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool row_ok = g + 8 * r < nr;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int c = 16 * m + 4 * t;
      const int n = row_ok ? min(max(width - c, 0), 4) : 0;
      visit(m, r,
            n > 0 ? a + static_cast<size_t>(r0 + g + 8 * r) * width + c : a,
            n);
    }
  }
}

// c's n-tiles 4 HALF .. 4 HALF + 3 = X . W's columns of them (W transposed
// and swizzled in shared memory) in 3xTF32: each k step's three products
// from zero, then a float32 add; one float4 load gives a B fragment's two
// k steps.  A layer's product comes in two halves so that the first half's
// silu can run beside the second half's products.
template <int HALF>
__device__ __forceinline__ void fwd_tc_product(float (&c)[8][4],
                                               const float (&x)[8][4],
                                               const float* W) {
  const int g = passp::lane_g(), t = passp::lane_t();
#pragma unroll
  for (int j = 4 * HALF; j < 4 * HALF + 4; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) c[j][v] = 0.f;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    passp::FragA a[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      passp::split_tc(x[2 * m + s][0], a[s].hi[0], a[s].lo[0]);   // (g, t)
      passp::split_tc(x[2 * m + s][2], a[s].hi[1], a[s].lo[1]);   // (g + 8, t)
      passp::split_tc(x[2 * m + s][1], a[s].hi[2], a[s].lo[2]);   // (g, t + 4)
      passp::split_tc(x[2 * m + s][3], a[s].hi[3], a[s].lo[3]);
    }
#pragma unroll
    for (int j = 4 * HALF; j < 4 * HALF + 4; ++j) {
      const int p = 8 * j + g;
      const float4 w = *reinterpret_cast<const float4*>(
          W + p * kTcW + 4 * ((4 * m + t) ^ fwd_swz(p)));
      passp::FragB b;
      passp::split_tc(w.x, b.hi[0], b.lo[0]);   // step 2m: (slot t, n = g)
      passp::split_tc(w.y, b.hi[1], b.lo[1]);   // (slot t + 4, g)
      passp::mma3(c[j], a[0], b);
      passp::split_tc(w.z, b.hi[0], b.lo[0]);   // step 2m + 1
      passp::split_tc(w.w, b.hi[1], b.lo[1]);
      passp::mma3(c[j], a[1], b);
    }
  }
}

// The forward, route 1: a persistent grid of one block per SM (at most);
// every layer's weight (zero-padded to 64 x 64) and bias is staged once per
// block and stays; then each warp takes its own 16-row tiles, tile w
// gridDim.x + blockIdx.x of warp w and every kFwdTcWarps gridDim.x after
// it, with no block barrier.  The layer's input (tri, h or t = silu(z_a))
// stays in registers in the accumulator layout; the running h waits in the
// lane's own float4 slots of shared memory, where x_ji (at the tile's
// start) and x_edge (when lin begins, h being lin's input) are copied
// asynchronously; the last layer writes out, once.
template <int L>
__global__ void __launch_bounds__(kFwdTcThreads, 1)
row_mlp_fwd_tc_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* wt = reinterpret_cast<float*>(smem4);   // [L][64 x 64]
  float* bs = wt + L * kFwdLayer;                // [L x 64]
  const int din = p.din, h = p.h, nb = p.nb;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // group (m, r) of the lane's running h at hs[32 (2 m + r)]
  float4* hs = reinterpret_cast<float4*>(bs + L * kTcW) + warp * kFwdH + lane;
  // the weights: each warp transposes 32 x 32 blocks, lane l reading
  // column n0 + l of 32 rows (all loads in flight), then writing its
  // column's 32 entries as 8 float4s of row fwd_physical(n0 + l)
  for (int blk = warp; blk < L * 4; blk += kFwdTcWarps) {
    const int k = blk >> 2, r0 = 32 * ((blk >> 1) & 1);
    const int n = 32 * (blk & 1) + lane;
    const int in = k == 0 ? din : h;
    const float* src = p.w + w_offset(k, din, h);
    float v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i)
      v[i] = r0 + i < in && n < h ? __ldg(src + (r0 + i) * h + n) : 0.f;
    const int row = fwd_physical(n);
    float4* dst = reinterpret_cast<float4*>(wt + k * kFwdLayer + row * kTcW);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      dst[(r0 / 4 + c) ^ fwd_swz(row)] =
          make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  }
  for (int i = tid; i < L * kTcW; i += kFwdTcThreads) {
    const int k = i / kTcW, c = i - k * kTcW;
    bs[i] = c < h ? p.bias[k * h + c] : 0.f;
  }
  __syncthreads();

  const bool h4 = p.vec_h, d4 = p.vec_d;
  const int t = passp::lane_t();
  const int step = gridDim.x * kFwdTcWarps;
  // a [E, h] array's rows of the tile into the lane's h slots
  auto copy_h = [&](const float* src, int r0, int nr) {
    fwd_tc_visit(src, h, r0, nr, [&](int m, int r, const float* a, int n) {
      float4* d = hs + 32 * (2 * m + r);
      if (h4) {
        cp_async<16>(d, a, 4 * n);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          cp_async<4>(reinterpret_cast<float*>(d) + u, a + (u < n ? u : 0),
                      u < n ? 4 : 0);
      }
    });
  };
  for (int tile = warp * gridDim.x + blockIdx.x; tile < p.n_tiles;
       tile += step) {
    const int r0 = tile * kFwdTcRows, nr = min(kFwdTcRows, p.n_rows - r0);
    copy_h(p.xji, r0, nr);
    float x[8][4], c[8][4];   // the layer's input and output
    fwd_tc_visit(p.tri, din, r0, nr, [&](int m, int r, const float* a, int n) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (d4 && n == 4) {
        v = __ldg(reinterpret_cast<const float4*>(a));
      } else {
        v.x = n > 0 ? __ldg(a) : 0.f;
        v.y = n > 1 ? __ldg(a + 1) : 0.f;
        v.z = n > 2 ? __ldg(a + 2) : 0.f;
        v.w = n > 3 ? __ldg(a + 3) : 0.f;
      }
      x[2 * m][2 * r] = v.x;
      x[2 * m][2 * r + 1] = v.y;
      x[2 * m + 1][2 * r] = v.z;
      x[2 * m + 1][2 * r + 1] = v.w;
    });
    // layer k: out = silu(in . W_k + b_k), plus the running h except at
    // kA (whose output t is the next input): h's slots take the sum too
    auto layer = [&](int k, const float (&in)[8][4], float (&out)[8][4]) {
      const bool is_a = tc_role(k, nb) == kA;
      if (tc_role(k, nb) == kLin) copy_h(p.xe, r0, nr);   // h is in `in`
      fwd_tc_product<0>(out, in, wt + k * kFwdLayer);
      fwd_tc_product<1>(out, in, wt + k * kFwdLayer);
      cp_async_wait_all();
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 bb =
            *reinterpret_cast<const float4*>(bs + k * kTcW + 16 * m + 4 * t);
        const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float4 hv = hs[32 * (2 * m + r)];
          float* hp = reinterpret_cast<float*>(&hv);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            // value q of group (m, r): out[2m + (q >> 1)][2r + (q & 1)]
            float& o = out[2 * m + (q >> 1)][2 * r + (q & 1)];
            const float sv = silu_f(o + bv[q]);
            o = is_a ? sv : hp[q] + sv;
            hp[q] = o;
          }
          if (!is_a) hs[32 * (2 * m + r)] = hv;
        }
      }
    };
    // L is even: the layers in pairs, x and c taking turns as input
#pragma unroll 1
    for (int k = 0; k < L; k += 2) {
      layer(k, x, c);
      layer(k + 1, c, x);
    }
    // the last layer (kB or lin) left the output in x
    fwd_tc_visit(p.out, h, r0, nr, [&](int m, int r, float* a, int n) {
      const float4 v = make_float4(x[2 * m][2 * r], x[2 * m][2 * r + 1],
                                   x[2 * m + 1][2 * r],
                                   x[2 * m + 1][2 * r + 1]);
      if (h4 && n == 4) {
        *reinterpret_cast<float4*>(a) = v;
      } else {
        if (n > 0) a[0] = v.x;
        if (n > 1) a[1] = v.y;
        if (n > 2) a[2] = v.z;
        if (n > 3) a[3] = v.w;
      }
    });
  }
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

// route 2's row-tile height (32, 16 or 8), or 0 when even 8 rows' states
// do not fit `optin` bytes
int bwd_rows(int din, int h, int nb, int na, int optin) {
  const int L = 2 + 2 * (nb + na);
  for (int rb = 32; rb >= 8; rb /= 2) {
    const size_t need = sizeof(float) *
        static_cast<size_t>(bwd_smem_floats(din, h, L, nb, na, rb));
    if (need <= static_cast<size_t>(optin)) return rb;
  }
  return 0;
}

// The backward's route at these widths, chosen once against the device's
// opt-in shared memory: 1 (row_mlp_bwd_tc_kernel: Din, H <= 64, at most
// three residual pairs), 2 (row_mlp_bwd_kernel, with its tile height in
// *rb), or 0 when neither fits a block or the device cannot be asked.
int bwd_plan(int din, int h, int nb, int na, int* rb) {
  *rb = 0;
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  const int L = 2 + 2 * (nb + na);
  if (din <= kTcW && h <= kTcW && L <= kTcMaxLayers &&
      sizeof(float) * static_cast<size_t>(tc_smem_floats(L)) <=
          static_cast<size_t>(optin)) {
    *rb = kTcRows;
    return 1;
  }
  *rb = bwd_rows(din, h, nb, na, optin);
  return *rb > 0 ? 2 : 0;
}

// The forward's route at these widths: 1 (row_mlp_fwd_tc_kernel: Din, H
// <= 64, at most three residual pairs, where its shared memory fits the
// device's opt-in limit: 194 KB at L = 8 of the H100's 227), 2
// (row_mlp_fwd_kernel), or 0 when the device cannot be asked.
int fwd_plan(int din, int h, int nb, int na) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  const int L = 2 + 2 * (nb + na);
  return din <= kTcW && h <= kTcW && L <= kTcMaxLayers &&
                 sizeof(float) * static_cast<size_t>(fwd_tc_smem_floats(L)) <=
                     static_cast<size_t>(optin)
             ? 1 : 2;
}

template <int L>
int launch_fwd_tc(const Params& p, int grid, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * static_cast<size_t>(fwd_tc_smem_floats(L));
  const int rc = set_smem(
      reinterpret_cast<const void*>(row_mlp_fwd_tc_kernel<L>), smem);
  if (rc != 0) return rc;
  row_mlp_fwd_tc_kernel<L><<<grid, kFwdTcThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int L>
int launch_tc(const Params& p, int grid, cudaStream_t st) {
  const size_t smem = sizeof(float) * static_cast<size_t>(tc_smem_floats(L));
  const int rc = set_smem(
      reinterpret_cast<const void*>(row_mlp_bwd_tc_kernel<L>), smem);
  if (rc != 0) return rc;
  row_mlp_bwd_tc_kernel<L><<<grid, kTcThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The size in floats of the packed weights plus biases, of one
// weight-gradient partial and of `wgrad`: [dW packed | db L*H], padded to
// a multiple of 4.
extern "C" int hg_row_mlp_wgrad_size(int din, int h, int nb, int na) {
  return wgrad_floats(din, h, 2 + 2 * (nb + na));
}

// The backward's route at these widths (bwd_plan): 1, 2, or 0 when
// neither fits a block's shared memory.
extern "C" int hg_row_mlp_bwd_route(int din, int h, int nb, int na) {
  int rb = 0;
  return bwd_plan(din, h, nb, na, &rb);
}

// The forward's route at these widths (fwd_plan): 1, 2, or 0 when the
// device cannot be asked.
extern "C" int hg_row_mlp_fwd_route(int din, int h, int nb, int na) {
  return fwd_plan(din, h, nb, na);
}

// One row_mlp launch; returns the cudaError_t (0 = success).  mode 0: the
// forward (out [E, H]; route 1's grid is min(n_parts, 16-row tiles)
// blocks; `route` 0 takes the widths' own, hg_row_mlp_fwd_route, 1 or 2
// that one where the widths admit it); mode 1: the backward (dtri [E,
// Din], dxji, dxe [E, H], each or null; `partial` [n_parts, wgrad size]
// scratch, `wgrad` the reduced [dW | db]; route 0, the widths' own).
// Pointers are device pointers; launches go on `stream` and do not
// synchronise.
extern "C" int hg_row_mlp_f32(
    int mode, const void* tri, const void* xji, const void* xe,
    const void* w, const void* bias, const void* gout, void* out, void* dtri,
    void* dxji, void* dxe, void* partial, void* wgrad, int n_rows, int din,
    int h, int nb, int na, int n_parts, int route, void* stream) {
  if (n_rows <= 0) return 0;
  if (din < 1 || din > kMaxH || h < 1 || h > kMaxH || nb < 0 || na < 0 ||
      mode < 0 || mode > 1 || n_parts < 1 || route < 0 || route > 2 ||
      (mode == 0 && out == nullptr) ||
      (mode == 1 && (gout == nullptr || partial == nullptr ||
                     wgrad == nullptr || route != 0)))
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
    const int own = fwd_plan(din, h, nb, na);
    if (own == 0 || (route == 1 && own != 1))
      return static_cast<int>(cudaErrorInvalidValue);
    if ((route == 0 ? own : route) == 1) {
      p.rb = kFwdTcRows;
      p.n_tiles = (n_rows + kFwdTcRows - 1) / kFwdTcRows;
      const auto a16 = [](const void* q) {
        return reinterpret_cast<uintptr_t>(q) % 16 == 0;
      };
      p.vec_d = din % 4 == 0 && a16(tri);
      p.vec_h = h % 4 == 0 && a16(xji) && a16(xe) && a16(out);
      const int grid = n_parts < p.n_tiles ? n_parts : p.n_tiles;
      switch (p.L) {
        case 2: return launch_fwd_tc<2>(p, grid, st);
        case 4: return launch_fwd_tc<4>(p, grid, st);
        case 6: return launch_fwd_tc<6>(p, grid, st);
        case 8: return launch_fwd_tc<8>(p, grid, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    }
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
  const int bwd = bwd_plan(din, h, nb, na, &p.rb);
  if (bwd == 0) return static_cast<int>(cudaErrorInvalidValue);
  p.n_tiles = (n_rows + p.rb - 1) / p.rb;
  const int grid = n_parts < p.n_tiles ? n_parts : p.n_tiles;
  int rc = static_cast<int>(cudaErrorInvalidValue);
  if (bwd == 1) {
    switch (p.L) {
      case 2: rc = launch_tc<2>(p, grid, st); break;
      case 4: rc = launch_tc<4>(p, grid, st); break;
      case 6: rc = launch_tc<6>(p, grid, st); break;
      case 8: rc = launch_tc<8>(p, grid, st); break;
      default: break;
    }
  } else {
    const size_t smem = sizeof(float) * static_cast<size_t>(
        bwd_smem_floats(din, h, p.L, nb, na, p.rb));
    rc = set_smem(reinterpret_cast<const void*>(row_mlp_bwd_kernel), smem);
    if (rc == 0) {
      row_mlp_bwd_kernel<<<grid, kBwdThreads, smem, st>>>(p);
      rc = static_cast<int>(cudaGetLastError());
    }
  }
  if (rc != 0) return rc;
  return static_cast<int>(passp::launch_reduce_partials(
      p.partial, static_cast<float*>(wgrad), grid,
      wgrad_floats(din, h, p.L), st));
}
