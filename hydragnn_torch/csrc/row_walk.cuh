// Shared by the kernels whose warps walk a CSR schedule across row
// boundaries (fused_mp.cu: the gather-multiply's route 1 and the segment
// sum's route 1; poly_mp.cu: the poly scatter's route 1): float2 row
// accesses, a cursor over the rows of a share, the search that finds a
// share's rows and offsets, and the grid sized to the blocks the card
// holds at once.

#pragma once

#include <cuda_runtime.h>

// internal linkage: each library that includes this has its own copy
namespace {
namespace walk {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// a row read once: cache-streaming (evict-first in L1 and L2), so the
// lines it brings in are the first to leave again
__device__ __forceinline__ float2 ldcs2(const float* p) {
  return __ldcs(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ void st2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

// A warp's walk over its rows of a CSR schedule: `row` the current row,
// `end` = row_ptr[row + 1].  Lane l holds row_ptr[base + 1 + l], so a row
// boundary costs a shuffle, and a load only every 32 rows.
struct Cursor {
  const int* row_ptr;
  int n_rows, row, base, mine, end;

  __device__ __forceinline__ void init(const int* rp, int n, int r) {
    row_ptr = rp;
    n_rows = n;
    row = r;
    load();
  }
  __device__ __forceinline__ void load() {
    base = row;
    mine = __ldg(row_ptr + min(base + 1 + static_cast<int>(threadIdx.x & 31),
                               n_rows));
    end = __shfl_sync(kFull, mine, 0);
  }
  // to the next row (called only while a position of the share lies past
  // `end`, so the new row is still the share's)
  __device__ __forceinline__ void next() {
    ++row;
    if (row - base == kLanes)
      load();
    else
      end = __shfl_sync(kFull, mine, row - base);
  }
};

// passp::share_range's rows [rb, re) of share `part` (the same search:
// each half-warp one bound, 16 probes a round) and their offsets p0 =
// row_ptr[rb], p1 = row_ptr[re], with two loads fewer on the path before
// a warp's first edge: row_ptr[n] is loaded beside the first round's
// probes (which do not depend on the target), and the offsets come from
// the probes that found the rows.
__device__ __forceinline__ void share_rows(const int* row_ptr, int n,
                                           int part, int n_parts, int& rb,
                                           int& re, int& p0, int& p1) {
  const int lane = threadIdx.x & 31, half = lane >> 4, hl = lane & 15;
  int lo = 0, hi = n;  // this half's row lies in [lo, hi]; key(hi) >= target
  int step = (n + 15) >> 4;
  int r = min(hl * step, n);
  int v = __ldg(row_ptr + r);
  int v_hi = __ldg(row_ptr + n);  // row_ptr[hi]
  const long long target =
      (static_cast<long long>(v_hi) + n) * (part + half) / n_parts;
  for (bool first = true; __any_sync(kFull, lo < hi); first = false) {
    if (!first) {
      step = (hi - lo + 15) >> 4;
      r = min(lo + hl * step, hi);
      v = __ldg(row_ptr + r);
    }
    const bool ok = static_cast<long long>(v) + r >= target;
    const unsigned m = (__ballot_sync(kFull, ok) >> (16 * half)) & 0xffffu;
    const int j = m == 0u ? 0 : __ffs(m) - 1;
    const int vj = __shfl_sync(kFull, v, 16 * half + j);
    if (lo < hi) {
      if (m == 0u) {
        lo = min(lo + 15 * step, hi) + 1;  // past the last probe
      } else {
        const int rj = min(lo + j * step, hi);
        lo = j == 0 ? rj : min(lo + (j - 1) * step, hi) + 1;
        hi = rj;
        v_hi = vj;
      }
    }
  }
  rb = __shfl_sync(kFull, lo, 0);
  re = __shfl_sync(kFull, lo, 16);
  p0 = __shfl_sync(kFull, v_hi, 0);
  p1 = __shfl_sync(kFull, v_hi, 16);
}

// Blocks of `kernel` (`warps` warps each) the card holds at once (its SMs
// times the blocks a SM takes), at most one for every `per_block` units
// of work and at least one.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int warps, long long work,
                            int per_block, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kLanes * warps, 0);
  if (err != cudaSuccess) return err;
  const long long need = (work + per_block - 1) / per_block;
  const long long held = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  *grid = static_cast<int>(held < need ? held : need);
  if (*grid < 1) *grid = 1;
  return cudaSuccess;
}

}  // namespace walk
}  // namespace
