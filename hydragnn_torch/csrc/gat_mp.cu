// Hand-written Hopper (sm_90a) kernels for GATv2 edge attention
//
//   z    = leaky_relu(xl[src] + xr[dst], slope)          [HF = H*F lanes]
//   e_h  = sum over head h's F lanes of z * att           (lane order)
//   m    = max_e e,  d = sum_e exp(e - m),
//   acc  = sum_e exp(e - m) * b_e * xl[src]              (over real edges)
//
// Plain C interface, loaded with ctypes by hydragnn_torch/kernels/build.py;
// wrappers, plain PyTorch versions and launch counters live in
// hydragnn_torch/ops/gat_mp.py.  Float32 throughout; xl, xr, acc, ga, dxl,
// dxr are [N, HF] row-major, m, d, gd are [N, H], b is [E, H] (or null for
// ones), att is [H, F].  Lane c belongs to head c / F.
//
// One kernel template, three modes, and a reduction:
//
// gat_kernel<kFwd>   — the forward.  Replaces
//   hydragnn_tpu/ops/gat_mp.py:_fwd_impl (pl.pallas_call at :259).  One
//   warp per receiver row walks the row's CSR range in edge order; the
//   online-softmax state (m, d per head in shared memory, acc in registers)
//   is rescaled per edge, as in flash attention.  No atomics and no
//   [E, HF] tensor in device memory.
// gat_kernel<kPassR> (+ gat_sum_partials_kernel) — backward pass R.
//   Replaces :_gea_bwd's receiver-side pass (pl.pallas_call at :543).
//   Receiver order again: recompute z, e and p = exp(e - m[dst]) (m
//   frozen), de = p (b <ga[dst], xl[src]>_h + gd[dst]), dz = de * att *
//   leaky_relu'(z); sum dz into the dxr row, and z_act * de into the warp's
//   d att partial in shared memory.  A block keeps its warps' partials over
//   all of its rows and sums them in warp order into one partial of HF
//   floats, written once; the reduction kernel sums the partials in block
//   order.
// gat_kernel<kPassS> — backward pass S.  Replaces :_gea_bwd's sender-side
//   pass (pl.pallas_call at :594).  One warp per sender row walks the
//   row's range of sender-sorted positions (edge ids through
//   edge_perm_sender), recomputes as pass R and sums p b ga[dst] + dz into
//   the dxl row.
//
// Bound on the H100 SXM: bytes at these widths.  Per real edge the forward
// reads one xl row (4 HF bytes) and does ~8 HF flops plus ~5 per head, i.e.
// ~2 flop/byte against the card's ~20 flop/byte float32 ridge; the
// backward passes read two or three rows and do ~3x the forward's flops.
// The rows gathered per edge are what the bound counts once per node (a
// node's xl row is read by each of its ~10 out-edges, from L2).  Design,
// first version: lanes of a warp span the HF columns (each xl, xr, ga row
// access is one coalesced 128-byte line per 32 columns); each head's logit
// is summed in lane order by one lane from the per-lane products staged in
// shared memory (head stride F | 1, conflict-free across heads), so the
// logits, and with them m, are bit-identical to the plain version's
// sequential sum; the multiply and the adds of that sum are __fmul_rn /
// __fadd_rn so that no contraction changes them.  Not yet: edge tiles per
// warp, several rows per warp for small HF, tensor cores.
//
// Contract (collate guarantees it): edges are sorted by receiver, so each
// receiver row owns one contiguous CSR range; masked edges sort last in
// both orderings and are parked out of every range by the wrapper's
// schedule (skipped by range, never by a zero dropout bit: a dropped real
// edge still counts in d).  Rows with no real edge write m = -1e9, d = 0,
// acc = 0 and zero gradient rows.  Determinism: every sum runs in a fixed
// order (edge order within a row; row, warp and block order for d att); no
// atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;                  // warps (rows in flight) per block
constexpr int kThreads = kWarp * kWarps;
constexpr int kMaxHF = 1024;
constexpr float kNeg = -1e9f;              // the reference's _NEG

constexpr int kFwd = 0;
constexpr int kPassR = 1;
constexpr int kPassS = 2;

struct Params {
  const float* xl;
  const float* xr;
  const float* att;
  const int* send;
  const int* recv;
  const int* perm;
  const int* row_ptr;
  const float* b;      // [E, H] or null (ones)
  const float* m;      // [N, H] (backward)
  const float* ga;     // [N, HF] (backward)
  const float* gd;     // [N, H] (backward)
  float* out;          // acc, dxr or dxl [N, HF]
  float* m_out;        // [N, H] (forward)
  float* d_out;        // [N, H] (forward)
  float* partial;      // [gridDim.x, HF] (pass R)
  int n_rows;
  int hf;
  int f;
  int h;
  int sf;              // head stride of the staged products: F | 1
  float slope;
};

__host__ __device__ inline int warp_floats(int mode, int hf, int h, int sf) {
  // staged products (two arrays in the backward), per-head scalars, and
  // pass R's d att partial
  if (mode == kFwd) return h * sf + 4 * h;
  if (mode == kPassR) return 2 * h * sf + 2 * h + hf;
  return 2 * h * sf + 2 * h;
}

__host__ inline size_t smem_bytes(int mode, int hf, int h, int sf) {
  // att [HF] floats, the lane -> head and lane -> staged-slot tables [HF]
  // ints, then each warp's area
  return sizeof(float) * (3 * static_cast<size_t>(hf) +
                          static_cast<size_t>(kWarps) *
                              warp_floats(mode, hf, h, sf));
}

__device__ inline float leaky(float z, float slope) {
  return z > 0.f ? z : __fmul_rn(z, slope);
}

// The logit of head hh from its F staged products, in lane order.
__device__ inline float head_sum(const float* staged, int hh, int sf, int f) {
  const float* ph = staged + hh * sf;
  float v = ph[0];
  for (int k = 1; k < f; ++k) v = __fadd_rn(v, ph[k]);
  return v;
}

template <int MODE, int NJ>
__global__ void __launch_bounds__(kThreads) gat_kernel(Params p) {
  extern __shared__ float smem[];
  const int hf = p.hf, f = p.f, h = p.h, sf = p.sf;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  float* att_s = smem;
  int* col_h = reinterpret_cast<int*>(att_s + hf);
  int* col_slot = col_h + hf;
  float* wbase = reinterpret_cast<float*>(col_slot + hf) +
                 warp * warp_floats(MODE, hf, h, sf);
  for (int c = threadIdx.x; c < hf; c += kThreads) {
    att_s[c] = p.att[c];
    const int hh = c / f;
    col_h[c] = hh;
    col_slot[c] = hh * sf + (c - hh * f);
  }
  float* prod = wbase;                        // [H * sf] z_act * att
  float* gprod = wbase + h * sf;              // [H * sf] ga * xl (backward)
  float* hs0 = wbase + (MODE == kFwd ? 1 : 2) * h * sf;  // per-head scalars
  float* hs1 = hs0 + h;
  float* hs2 = hs1 + h;                       // forward only
  float* hs3 = hs2 + h;                       // forward only
  float* datt_w = hs1 + h;                    // pass R only: [HF]
  if (MODE == kPassR)
    for (int c = lane; c < hf; c += kWarp) datt_w[c] = 0.f;
  __syncthreads();

  const int stride = gridDim.x * kWarps;
  for (int row = blockIdx.x * kWarps + warp; row < p.n_rows; row += stride) {
    const int e0 = p.row_ptr[row];
    const int e1 = p.row_ptr[row + 1];
    const float* row_a = (MODE == kPassS ? p.xl : p.xr) +
                         static_cast<size_t>(row) * hf;
    float own[NJ];   // the row's own xr (forward, pass R) or xl (pass S)
    float gar[NJ];   // pass R: ga of the row
    float sum[NJ];   // acc, dxr or dxl of the row
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + j * kWarp;
      own[j] = c < hf ? row_a[c] : 0.f;
      gar[j] = (MODE == kPassR && c < hf)
                   ? p.ga[static_cast<size_t>(row) * hf + c] : 0.f;
      sum[j] = 0.f;
    }
    if (MODE == kFwd) {
      for (int hh = lane; hh < h; hh += kWarp) {
        hs0[hh] = kNeg;   // m
        hs1[hh] = 0.f;    // d
      }
    }
    __syncwarp();
    for (int k = e0; k < e1; ++k) {
      const int e = MODE == kPassS ? p.perm[k] : k;
      // the other end of the edge: the sender (forward, pass R) or the
      // receiver (pass S)
      const int o = MODE == kPassS ? p.recv[e] : p.send[e];
      if (static_cast<unsigned>(o) >= static_cast<unsigned>(p.n_rows))
        continue;
      const float* other = (MODE == kPassS ? p.xr : p.xl) +
                           static_cast<size_t>(o) * hf;
      float xo[NJ];    // xl[src] (forward, pass R) or xr[dst] (pass S)
      float gao[NJ];   // pass S: ga[dst]
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + j * kWarp;
        if (c < hf) {
          xo[j] = other[c];
          const float xs = MODE == kPassS ? own[j] : xo[j];
          const float xt = MODE == kPassS ? xo[j] : own[j];
          const float z = __fadd_rn(xs, xt);
          prod[col_slot[c]] = __fmul_rn(leaky(z, p.slope), att_s[c]);
          if (MODE == kPassS) {
            gao[j] = p.ga[static_cast<size_t>(o) * hf + c];
            gprod[col_slot[c]] = gao[j] * xs;
          } else if (MODE == kPassR) {
            gprod[col_slot[c]] = gar[j] * xs;
          }
        }
      }
      __syncwarp();
      const int dst = MODE == kPassS ? o : row;
      for (int hh = lane; hh < h; hh += kWarp) {
        const float ev = head_sum(prod, hh, sf, f);
        const float bb = p.b ? p.b[static_cast<size_t>(e) * h + hh] : 1.f;
        if (MODE == kFwd) {
          const float mo = hs0[hh];
          const float mn = fmaxf(mo, ev);
          const float r = expf(mo - mn);
          const float pe = expf(ev - mn);
          hs0[hh] = mn;
          hs1[hh] = hs1[hh] * r + pe;
          hs2[hh] = r;
          hs3[hh] = pe * bb;
        } else {
          const size_t hi = static_cast<size_t>(dst) * h + hh;
          const float pe = expf(ev - p.m[hi]);
          float q = 0.f;
          const float* gh = gprod + hh * sf;
          for (int k2 = 0; k2 < f; ++k2) q += gh[k2];
          hs0[hh] = pe * bb;                      // p b
          hs1[hh] = pe * (bb * q + p.gd[hi]);     // de
        }
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + j * kWarp;
        if (c < hf) {
          const int hh = col_h[c];
          if (MODE == kFwd) {
            sum[j] = sum[j] * hs2[hh] + hs3[hh] * xo[j];
          } else {
            const float xs = MODE == kPassS ? own[j] : xo[j];
            const float xt = MODE == kPassS ? xo[j] : own[j];
            const float z = __fadd_rn(xs, xt);
            const float de = hs1[hh];
            const float dz = de * att_s[c] * (z > 0.f ? 1.f : p.slope);
            if (MODE == kPassR) {
              sum[j] += dz;
              datt_w[c] += leaky(z, p.slope) * de;
            } else {
              sum[j] += hs0[hh] * gao[j] + dz;
            }
          }
        }
      }
      __syncwarp();
    }
    float* out_row = p.out + static_cast<size_t>(row) * hf;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + j * kWarp;
      if (c < hf) out_row[c] = sum[j];
    }
    if (MODE == kFwd) {
      for (int hh = lane; hh < h; hh += kWarp) {
        p.m_out[static_cast<size_t>(row) * h + hh] = hs0[hh];
        p.d_out[static_cast<size_t>(row) * h + hh] = hs1[hh];
      }
    }
    __syncwarp();
  }

  if (MODE == kPassR) {
    // the block's partial: its warps' partials summed in warp order
    __syncthreads();
    const int wf = warp_floats(MODE, hf, h, sf);
    float* first = reinterpret_cast<float*>(col_slot + hf);
    for (int c = threadIdx.x; c < hf; c += kThreads) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w)
        s += first[w * wf + 2 * h * sf + 2 * h + c];
      p.partial[static_cast<size_t>(blockIdx.x) * hf + c] = s;
    }
  }
}

__global__ void gat_sum_partials_kernel(const float* __restrict__ partial,
                                        float* __restrict__ datt, int n_parts,
                                        int hf) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= hf) return;
  float s = 0.f;
  for (int b = 0; b < n_parts; ++b)
    s += partial[static_cast<size_t>(b) * hf + c];
  datt[c] = s;
}

template <int MODE, int NJ>
int launch(const Params& p, int grid, cudaStream_t st) {
  const size_t smem = smem_bytes(MODE, p.hf, p.h, p.sf);
  cudaError_t err = cudaFuncSetAttribute(
      gat_kernel<MODE, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gat_kernel<MODE, NJ><<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// NJ = columns per lane, the smallest instantiated count >= HF / 32
template <int MODE>
int launch_width(const Params& p, int grid, cudaStream_t st) {
  const int nj = (p.hf + kWarp - 1) / kWarp;
  if (nj <= 1) return launch<MODE, 1>(p, grid, st);
  if (nj <= 2) return launch<MODE, 2>(p, grid, st);
  if (nj <= 4) return launch<MODE, 4>(p, grid, st);
  if (nj <= 8) return launch<MODE, 8>(p, grid, st);
  if (nj <= 12) return launch<MODE, 12>(p, grid, st);
  if (nj <= 16) return launch<MODE, 16>(p, grid, st);
  if (nj <= 24) return launch<MODE, 24>(p, grid, st);
  return launch<MODE, 32>(p, grid, st);
}

}  // namespace

// One GAT launch; returns the cudaError_t (0 = success).  mode 0: the
// forward (out = acc, m_out, d_out; rows are receivers, row_ptr over edge
// ids); mode 1: pass R (out = dxr; `partial` scratch [n_parts, HF], `datt`
// [HF] the reduced attention gradient; rows are receivers); mode 2: pass S
// (out = dxl; rows are senders, row_ptr over sender-sorted positions and
// `perm` the sender permutation).  Pointers are device pointers; launches
// go on `stream` and do not synchronise.
extern "C" int hg_gat_f32(int mode, const void* xl, const void* xr,
                          const void* att, const void* send, const void* recv,
                          const void* perm, const void* row_ptr,
                          const void* b, const void* m, const void* ga,
                          const void* gd, void* out, void* m_out, void* d_out,
                          void* partial, void* datt, int n_rows, int hf,
                          int f, float slope, int n_parts, void* stream) {
  if (n_rows <= 0) return 0;
  if (f < 1 || hf < f || hf > kMaxHF || hf % f != 0 || mode < kFwd ||
      mode > kPassS || (mode == kPassR && n_parts < 1) ||
      (mode == kPassS && perm == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.xl = static_cast<const float*>(xl);
  p.xr = static_cast<const float*>(xr);
  p.att = static_cast<const float*>(att);
  p.send = static_cast<const int*>(send);
  p.recv = static_cast<const int*>(recv);
  p.perm = static_cast<const int*>(perm);
  p.row_ptr = static_cast<const int*>(row_ptr);
  p.b = static_cast<const float*>(b);
  p.m = static_cast<const float*>(m);
  p.ga = static_cast<const float*>(ga);
  p.gd = static_cast<const float*>(gd);
  p.out = static_cast<float*>(out);
  p.m_out = static_cast<float*>(m_out);
  p.d_out = static_cast<float*>(d_out);
  p.partial = static_cast<float*>(partial);
  p.n_rows = n_rows;
  p.hf = hf;
  p.f = f;
  p.h = hf / f;
  p.sf = f | 1;
  p.slope = slope;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n_rows + kWarps - 1) / kWarps;
  if (mode == kFwd) return launch_width<kFwd>(p, blocks, st);
  if (mode == kPassS) return launch_width<kPassS>(p, blocks, st);
  const int grid = n_parts < blocks ? n_parts : blocks;
  const int rc = launch_width<kPassR>(p, grid, st);
  if (rc != 0) return rc;
  gat_sum_partials_kernel<<<(hf + 255) / 256, 256, 0, st>>>(
      p.partial, static_cast<float*>(datt), grid, hf);
  return static_cast<int>(cudaGetLastError());
}
