// Shared by the kernels that run float32 products on Hopper's tensor cores
// (scf_mp.cu, cgcnn_mp.cu and egcl_mp.cu pass P; row_mlp.cu's routes 1;
// dn_tri_builder.cu's forward) and the dn_tri backward: products in
// 3xTF32 (sm_80+ mma.sync), compensated sums, the fixed-order reductions
// of per-block partials, and the shares of rows that warps or blocks
// take.
//
// Each float32 operand x is split as hi = tf32(x), lo = tf32(x - hi) (x - hi
// is exact in float32), and a*b is taken as lo_a*hi_b + hi_a*lo_b +
// hi_a*hi_b, accumulated in float32: the dropped lo*lo term and lo's own
// rounding sit near 2^-22 of the product.  Single-pass TF32 (about three
// decimal digits) is never used.  The tensor cores' own float32
// accumulation truncates, and its error would grow, with a bias toward
// zero, with every product added into one accumulator: so each k step's
// three products start from zero (the small terms first) and the step is
// added to the running sum with an ordinary float32 add, which rounds to
// nearest.
//
// Fragments of mma.sync.aligned.m16n8k8 .tf32 (lane = 4 * gq + tq):
//   A [16 x 8]: (gq, tq), (gq + 8, tq), (gq, tq + 4), (gq + 8, tq + 4)
//   B [8 x 8]:  (k = tq, n = gq), (k = tq + 4, n = gq)
//   C [16 x 8]: (gq, 2tq), (gq, 2tq + 1), (gq + 8, 2tq), (gq + 8, 2tq + 1)
// The loaders take an element (m, k) of A at p[m * sm + k * sk] and (k, n)
// of B at p[k * sk + n * sn], so a transposed operand is a change of
// strides.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// internal linkage: each library that includes this has its own copy
namespace {
namespace passp {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// split() bit for bit, with hi rounded by two integer operations in place
// of the conversion: the bits plus 2^12 with the low 13 cleared round to
// nearest, ties away from zero, as cvt.rna does, for every x but a NaN
// (which may come out a zero or an infinity); lo = x - hi is then NaN and
// goes through the conversion, which keeps it, so a NaN operand still
// makes the product NaN
__device__ __forceinline__ void split_ih(float x, uint32_t& hi,
                                         uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = to_tf32(x - __uint_as_float(hi));
}

// x = hi + lo for the tensor cores: hi rounded to tf32 by two integer
// operations (as split_ih), lo = x - hi (exact) passed as it is: the
// tensor cores read a tf32 operand's top 19 bits, so lo is truncated where
// split rounds it (both near 2^-22 of x), without the conversion's
// instruction sequence
__device__ __forceinline__ void split_tc(float x, uint32_t& hi,
                                         uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// the split the loaders below use: IH picks split_ih
template <bool IH>
__device__ __forceinline__ void split_as(float x, uint32_t& hi,
                                         uint32_t& lo) {
  if (IH)
    split_ih(x, hi, lo);
  else
    split(x, hi, lo);
}

struct FragA {
  uint32_t hi[4], lo[4];
};

struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

template <bool IH = false>
__device__ __forceinline__ void set_a(FragA& a, float v0, float v1, float v2,
                                      float v3) {
  split_as<IH>(v0, a.hi[0], a.lo[0]);
  split_as<IH>(v1, a.hi[1], a.lo[1]);
  split_as<IH>(v2, a.hi[2], a.lo[2]);
  split_as<IH>(v3, a.hi[3], a.lo[3]);
}

template <bool IH = false>
__device__ __forceinline__ void load_a(FragA& a, const float* p, int sm,
                                       int sk) {
  const int g = lane_g(), t = lane_t();
  set_a<IH>(a, p[g * sm + t * sk], p[(g + 8) * sm + t * sk],
            p[g * sm + (t + 4) * sk], p[(g + 8) * sm + (t + 4) * sk]);
}

template <bool IH = false>
__device__ __forceinline__ void load_b(FragB& b, const float* p, int sk,
                                       int sn) {
  const int g = lane_g(), t = lane_t();
  split_as<IH>(p[t * sk + g * sn], b.hi[0], b.lo[0]);
  split_as<IH>(p[(t + 4) * sk + g * sn], b.hi[1], b.lo[1]);
}

// d = a * b from zero (not volatile: no side effect, so the compiler may
// interleave independent products)
__device__ __forceinline__ void mma_z(float (&d)[4], const uint32_t (&a)[4],
                                      const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// d += a * b
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b, one k step in 3xTF32: the three products from zero, the
// small terms first, then a float32 add into c
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  float d[4];
  mma_z(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
#pragma unroll
  for (int v = 0; v < 4; ++v) c[v] += d[v];
}

// C [M x N] += A [M x K] . B [K x N], every operand in shared memory
// (strides as the loaders above; C's element (m, n) at c[m * cm + n]),
// M % 16 == 0, N % 32 == 0, K % 8 == 0.  The block's warps share the work
// in groups of 16 x 32 (four C tiles that reuse one A fragment per k
// step); each group is read from and written back to shared memory once.
// No synchronisation inside: the caller fences before and after.
__device__ __forceinline__ void gemm_smem(float* c, int cm, const float* a,
                                          int asm_, int ask, const float* b,
                                          int bsk, int bsn, int m, int n,
                                          int k, int warp, int n_warps) {
  const int g = lane_g(), t = lane_t();
  const int ng = n / 32;
  for (int q = warp; q < (m / 16) * ng; q += n_warps) {
    const int m0 = (q / ng) * 16, n0 = (q % ng) * 32;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* cp = c + (m0 + g) * cm + n0 + 8 * j + 2 * t;
      acc[j][0] = cp[0];
      acc[j][1] = cp[1];
      acc[j][2] = cp[8 * cm];
      acc[j][3] = cp[8 * cm + 1];
    }
    for (int kk = 0; kk < k; kk += 8) {
      FragA fa;
      load_a(fa, a + m0 * asm_ + kk * ask, asm_, ask);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB fb;
        load_b(fb, b + kk * bsk + (n0 + 8 * j) * bsn, bsk, bsn);
        mma3(acc[j], fa, fb);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* cp = c + (m0 + g) * cm + n0 + 8 * j + 2 * t;
      cp[0] = acc[j][0];
      cp[1] = acc[j][1];
      cp[8 * cm] = acc[j][2];
      cp[8 * cm + 1] = acc[j][3];
    }
  }
}

// s + c += v, compensated (Neumaier): the running sums of many edges'
// terms (bias gradients, row sums, the parts' partials) keep float32
// accuracy whatever their length; s + c is the sum
__device__ __forceinline__ void add_comp(float& s, float& c, float v) {
  const float t = s + v;
  c += fabsf(s) >= fabsf(v) ? (s - t) + v : (v - t) + s;
  s = t;
}

// out[i] = sum over parts b, in order (compensated), of partial[b][i]:
// the parts' weight gradients, each part in the packed layout of `out`
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int n_parts,
                                       int size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float v = 0.f, c = 0.f;
  for (int b = 0; b < n_parts; ++b)
    add_comp(v, c, partial[static_cast<size_t>(b) * size + i]);
  out[i] = v + c;
}

// out[i] = sum over slices s, in order, of part[s * stride + i] for i <
// count * per, count = row_ptr[n_rows] (the valid edges) or, with no
// row_ptr, n_rows
__global__ void reduce_slices_kernel(const float* __restrict__ part,
                                     float* __restrict__ out,
                                     const int* __restrict__ row_ptr,
                                     int n_rows, int per, int n_slices,
                                     size_t stride) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t count = row_ptr != nullptr ? row_ptr[n_rows] : n_rows;
  if (i >= count * per) return;
  float v = 0.f;
  for (int s = 0; s < n_slices; ++s) v += part[s * stride + i];
  out[i] = v;
}

// The rows [begin, end) of share `part` of `n_parts` over the rows [0, n)
// of a CSR schedule: share i begins at the least r in [0, n] with
// row_ptr[r] + r >= floor(i * (row_ptr[n] + n) / n_parts).  Each row weighs
// one (its output) plus its entries, so the shares balance both, and no
// row splits; share n_parts begins at n.  Found by the whole warp (called
// with every lane), each half-warp searching one bound with 16 probes a
// round; every lane returns the same rows.  ops/aggregate.py:row_shares
// writes the same plan out.
__device__ __forceinline__ void share_range(const int* row_ptr, int n,
                                            int part, int n_parts,
                                            int& begin, int& end) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, half = lane >> 4, hl = lane & 15;
  const long long total = static_cast<long long>(__ldg(row_ptr + n)) + n;
  const long long target = total * (part + half) / n_parts;
  int lo = 0, hi = n;  // this half's row lies in [lo, hi]; key(hi) >= target
  while (__any_sync(full, lo < hi)) {
    const int step = (hi - lo + 15) >> 4;
    const int r = min(lo + hl * step, hi);
    const bool ok = static_cast<long long>(__ldg(row_ptr + r)) + r >= target;
    const unsigned m = (__ballot_sync(full, ok) >> (16 * half)) & 0xffffu;
    if (lo < hi) {
      if (m == 0u) {
        lo = min(lo + 15 * step, hi) + 1;  // past the last probe
      } else {
        const int j = __ffs(m) - 1;
        const int rj = min(lo + j * step, hi);
        lo = j == 0 ? rj : min(lo + (j - 1) * step, hi) + 1;
        hi = rj;
      }
    }
  }
  begin = __shfl_sync(full, lo, 0);
  end = __shfl_sync(full, lo, 16);
}

// the least row stride >= n (n a multiple of 8) that is 8 or 24 mod 32
// floats: a fragment's float2 accesses along rows (row g, column 2t) and
// its scalar accesses down columns (row t, column g) then hit 32
// different banks
__host__ __device__ inline int frag_ld(int n) {
  const int m = n & 31;
  return (m == 8 || m == 24) ? n : n + 8;
}

// the two reductions of a pass-P launch: the parts onto `wgrad`, and,
// with more than one slice, the per-slice partials onto each output
inline cudaError_t launch_reduce_partials(const float* partial,
                                          float* wgrad, int n_parts,
                                          int size, cudaStream_t st) {
  reduce_partials_kernel<<<(size + 255) / 256, 256, 0, st>>>(
      partial, wgrad, n_parts, size);
  return cudaGetLastError();
}

inline cudaError_t launch_reduce_slices(const float* part, void* out,
                                        const int* row_ptr, int n_rows,
                                        int per, int n_slices, size_t stride,
                                        cudaStream_t st) {
  if (stride == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((stride + 255) / 256);
  reduce_slices_kernel<<<blocks, 256, 0, st>>>(
      part, static_cast<float*>(out), row_ptr, n_rows, per, n_slices,
      stride);
  return cudaGetLastError();
}

}  // namespace passp
}  // namespace
