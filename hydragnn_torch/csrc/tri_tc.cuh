// The triplet forward's route 1 on Hopper's tensor cores, shared by
// dn_tri_builder.cu (a stored sbf row per triplet: its forward and pass S)
// and dn_tri.cu (sbf formed from radial[kj] and cbf: the factored forward).
//
//   emb_t   = (sbf_t @ K1) @ K2                  [D]
//   out[e]  = sum_{t: own(t) = e} x[other(t)] * emb_t
//
// (the forward: own = ji, other = kj, x the gathered rows; pass S: own =
// kj, other = ji, x the cotangent).  B <= 8, SR <= 64, D a multiple of 8.
// Warps work alone, with no block barrier after the weights are staged:
// each of the grid's warps owns one contiguous run of output rows
// (passp::share_range: the runs balance rows plus triplets) and walks its
// triplets 16 at a time, one m16 tile.  A tile's A-operand sources (the
// loader's) and its x rows (16-byte cp.async) land in the warp's own ring
// of kStages stages, so the next tile's copies are in flight while this
// tile's products run, and the ids a stage further ahead are loaded into
// registers.  Both products run in 3xTF32 (pass_p.cuh: each k step's three
// products from zero, then a float32 add): emb1 = sbf.K1 as [16 x SR
// (padded to 8)] . [8 x B (padded to 8)], one n-tile; emb2 = emb1.K2 as
// one k step over D / 8 n-tiles.  The k index of each product is permuted
// within its 8-wide step (A's columns 2t and 2t + 1 in the fragment's
// slots t and t + 4, B's rows to match), so that emb1's accumulator
// fragment is already emb2's A fragment and an A fragment is two float2
// loads a lane.  K1's and K2's fragments are split into hi and lo once per
// block and read as one 16-byte load a lane.  x * emb2 goes back into the
// x stage in place; the warp then adds each triplet's row into its output
// row in position order, each lane four columns, and writes every row of
// its run once (rows without triplets as zeros).  Tile strides are 8 or 24
// mod 32 floats, so the fragments' float2 loads and stores hit 32 banks.
//
// The A operand's loader (the template parameter A) says how a stage holds
// a tile's sources and how a fragment is formed from them:
//   static int floats(int sr)      its floats of one stage (a multiple of 4)
//   void init(int sr, int lane)    per-lane set-up, once
//   void zero(float* st, int sr, int lane)   what copies never write, once
//   void row(float* st, int sr, int mode, int e, int t, int other,
//            bool take, int lane)  row e's copies (triplet t, gathered row
//                                  `other`, taken or not)
//   void tile(float* st, int q, int cnt, int lane)   a tile's own copies
//                                  (positions q .. q + cnt - 1)
//   void frag(FragA&, const float* st, int s, int g, int t)   step s's
//                                  A fragment, k permuted as above
// SbfRows (dn_tri_builder.cu) copies each triplet's sbf row; the factored
// loader (dn_tri.cu) copies radial[kj] rows and the tile's cbf rows and
// multiplies them as the fragment is formed.

#pragma once

#include <cuda_runtime.h>

#include "pass_p.cuh"

namespace {
namespace tritc {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;      // each warp's ring of tiles in flight
constexpr int kM = 16;          // triplets per warp tile: one m16 fragment
constexpr int kMaxSR = 64;
constexpr int kMaxB = 8;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kFwd = 0;
constexpr int kPassS = 1;

__host__ __device__ inline int round8(int n) { return (n + 7) & ~7; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(a), "l"(src));
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

// one row of SR floats into a stage row: 8-byte pieces at an even SR, else
// 4-byte ones (SR <= 64: at most two a lane)
__device__ __forceinline__ void copy_row(float* dst, const float* src,
                                         int sr, int lane) {
  if ((sr & 1) == 0) {
    if (2 * lane < sr) cp_async8(dst + 2 * lane, src + 2 * lane);
  } else {
    if (lane < sr) cp_async4(dst + lane, src + lane);
    if (lane + 32 < sr) cp_async4(dst + lane + 32, src + lane + 32);
  }
}

// the builder's loader: each triplet's sbf row [T, SR], copied whether the
// triplet is taken or not (its row always exists)
struct SbfRows {
  const float* sbf;
  int lds;

  __host__ __device__ static int floats(int sr) {
    return kM * passp::frag_ld(round8(sr));
  }
  __device__ void init(int sr, int) { lds = passp::frag_ld(round8(sr)); }
  // the tiles' columns [SR, round8(SR)): zero, never written again
  __device__ void zero(float* st, int sr, int lane) const {
    const int pad = round8(sr) - sr;
    for (int i = lane; i < kM * pad; i += 32)
      st[(i / pad) * lds + sr + i % pad] = 0.f;
  }
  __device__ void row(float* st, int sr, int, int e, int t, int, bool,
                      int lane) const {
    copy_row(st + e * lds, sbf + static_cast<size_t>(t) * sr, sr, lane);
  }
  __device__ void tile(float*, int, int, int) const {}
  __device__ void frag(passp::FragA& a, const float* st, int s, int g,
                       int t) const {
    const float2 u0 =
        *reinterpret_cast<const float2*>(st + g * lds + 8 * s + 2 * t);
    const float2 u1 =
        *reinterpret_cast<const float2*>(st + (g + 8) * lds + 8 * s + 2 * t);
    passp::set_a<true>(a, u0.x, u1.x, u0.y, u1.y);
  }
};

struct Args {
  const float* x;        // [E, D]: the forward's gathered rows
  const float* gout;     // [E, D]: pass S's cotangent, gathered at ji
  const float* w1;       // [SR, B]
  const float* w2;       // [B, D]
  const int* kj;         // [T]
  const int* ji;         // [T]
  const int* perm;       // [T] pass S: position -> triplet
  const int* row_ptr;    // [E + 1] CSR over positions
  float* out;            // [E, D]
  int n_rows, sr, b, d;
};

// one stage of a warp's ring: the loader's sources, then the x tile
// [16][frag_ld(D)]
template <class A>
__host__ __device__ inline int stage_floats(int sr, int d) {
  return A::floats(sr) + kM * passp::frag_ld(d);
}

// shared 32-bit words: K1's and K2's split fragments (one uint4 a lane a k
// step or n-tile), then each warp's stages
template <class A>
__host__ __device__ inline int smem_words(int sr, int d) {
  return 4 * 32 * (round8(sr) / 8 + d / 8) +
         kWarps * kStages * stage_floats<A>(sr, d);
}

// route 1 at these widths, when a block's shared memory (optin bytes)
// holds it; 2 otherwise
template <class A>
__host__ inline int route(int sr, int b, int d, int optin) {
  if (b <= kMaxB && sr <= kMaxSR && d % 8 == 0 &&
      sizeof(float) * static_cast<size_t>(smem_words<A>(sr, d)) <=
          static_cast<size_t>(optin))
    return 1;
  return 2;
}

template <int MODE, class A>
__global__ void __launch_bounds__(kThreads, 1)
fwd_tc_kernel(const Args p, A src) {
  static_assert(MODE == kFwd || MODE == kPassS, "forward or pass S");
  constexpr bool kS = MODE == kPassS;
  extern __shared__ float4 smem4[];
  const int sr = p.sr, b = p.b, d = p.d;
  const int ks = round8(sr) / 8, nt = d / 8;
  const int ldx = passp::frag_ld(d);
  const int stage = stage_floats<A>(sr, d);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint4* k1f = reinterpret_cast<uint4*>(smem4);     // [ks][32]
  uint4* k2f = k1f + ks * 32;                        // [nt][32]
  float* ring =
      reinterpret_cast<float*>(k2f + nt * 32) + warp * kStages * stage;
  src.init(sr, lane);

  // K1's fragments, k permuted within each step: lane (g, t) of step s
  // holds K1[8s + 2t][g] and K1[8s + 2t + 1][g] (zero past SR or B), split
  for (int i = tid; i < ks * 32; i += kThreads) {
    const int s = i >> 5, l = i & 31, lg = l >> 2, r = 8 * s + 2 * (l & 3);
    const float v0 = r < sr && lg < b ? p.w1[r * b + lg] : 0.f;
    const float v1 = r + 1 < sr && lg < b ? p.w1[(r + 1) * b + lg] : 0.f;
    uint4 f;
    passp::split_ih(v0, f.x, f.z);
    passp::split_ih(v1, f.y, f.w);
    k1f[i] = f;
  }
  // K2's, the same permutation of its B rows: K2[2t][8j + g], K2[2t+1][..]
  for (int i = tid; i < nt * 32; i += kThreads) {
    const int j = i >> 5, l = i & 31, r = 2 * (l & 3), c = 8 * j + (l >> 2);
    const float v0 = r < b ? p.w2[r * d + c] : 0.f;
    const float v1 = r + 1 < b ? p.w2[(r + 1) * d + c] : 0.f;
    uint4 f;
    passp::split_ih(v0, f.x, f.z);
    passp::split_ih(v1, f.y, f.w);
    k2f[i] = f;
  }
  for (int u = 0; u < kStages; ++u) src.zero(ring + u * stage, sr, lane);
  __syncthreads();  // the only block barrier

  int r_begin, r_end;
  passp::share_range(p.row_ptr, p.n_rows, blockIdx.x * kWarps + warp,
                     gridDim.x * kWarps, r_begin, r_end);
  if (r_begin >= r_end) return;
  const int p_begin = __ldg(p.row_ptr + r_begin);
  const int p_end = __ldg(p.row_ptr + r_end);
  const int n_tiles = (p_end - p_begin + kM - 1) / kM;

  // a tile's ids in lanes 0..15: the triplet t of position p_begin + 16 i
  // + lane (the forward: positions are triplet ids in ji order; pass S:
  // through perm, in kj order), its kj and ji; -1 past the run
  auto load_ids = [&](int i, int& tt, int& kj, int& ji) {
    const int pos = p_begin + i * kM + lane;
    const bool in = lane < kM && i < n_tiles && pos < p_end;
    tt = in ? (kS ? __ldg(p.perm + pos) : pos) : -1;
    kj = in ? __ldg(p.kj + tt) : -1;
    ji = in ? __ldg(p.ji + tt) : -1;
  };
  // a triplet is taken when both ids are edges and its row (the forward:
  // ji; pass S: kj) is this warp's
  auto taken = [&](int kj, int ji) {
    const int own = kS ? kj : ji, other = kS ? ji : kj;
    return static_cast<unsigned>(other) < static_cast<unsigned>(p.n_rows) &&
           own >= r_begin && own < r_end;
  };
  // tile i's A sources and x rows (the forward: x[kj]; pass S: the
  // cotangent at ji) into a stage, as one group of copies (D <= 128: one
  // 16-byte piece a lane a row)
  auto fetch = [&](int i, int tt, int kj, int ji, float* st) {
    const int q = p_begin + i * kM;
    const int cnt = min(kM, p_end - q);
    float* xb = st + A::floats(sr);
    const float* xs = kS ? p.gout : p.x;
#pragma unroll
    for (int e = 0; e < kM; ++e) {
      const int k = __shfl_sync(kFull, kj, e);
      const int j = __shfl_sync(kFull, ji, e);
      const int t_e = kS ? __shfl_sync(kFull, tt, e) : q + e;
      if (e < cnt) {
        const bool take = taken(k, j);
        src.row(st, sr, MODE, e, t_e, kS ? j : k, take, lane);
        if (take && 4 * lane < d)
          cp_async16(xb + e * ldx + 4 * lane,
                     xs + static_cast<size_t>(kS ? j : k) * d + 4 * lane);
      }
    }
    src.tile(st, q, cnt, lane);
    cp_async_commit();
  };

  int cur = r_begin;            // the row being summed
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int c4 = 4 * lane;      // this lane's four columns of the sums
  auto flush = [&](int upto) {  // write row cur, then zero rows to upto
    if (c4 < d) {
      *reinterpret_cast<float4*>(p.out + static_cast<size_t>(cur) * d + c4) =
          acc;
      for (int r = cur + 1; r < upto; ++r)
        *reinterpret_cast<float4*>(p.out + static_cast<size_t>(r) * d + c4) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  // ids of tiles i .. i + kStages in registers; tiles i .. i + kStages - 1
  // in flight (one group of copies each, empty past the run's last tile)
  constexpr int S = kStages;
  int tr[S + 1], kjr[S + 1], jir[S + 1];
#pragma unroll
  for (int u = 0; u <= S; ++u) load_ids(u, tr[u], kjr[u], jir[u]);
#pragma unroll
  for (int u = 0; u + 1 < S; ++u) {
    if (u < n_tiles)
      fetch(u, tr[u], kjr[u], jir[u], ring + u * stage);
    else
      cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    float* st = ring + (i % S) * stage;
    const int ahead = i + S - 1;
    if (ahead < n_tiles)
      fetch(ahead, tr[S - 1], kjr[S - 1], jir[S - 1],
            ring + (ahead % S) * stage);
    else
      cp_async_commit();  // an empty group: tile i's stays S-th to last
    cp_async_wait<S - 1>();
    __syncwarp();
    const int kj0 = kjr[0], ji0 = jir[0];

    // emb1 = sbf . K1 over the k steps (at most 8): one m16 x n8
    // accumulator
    float e1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < kMaxSR / 8; ++s) {
      if (s < ks) {
        passp::FragA a;
        src.frag(a, st, s, g, t);
        const uint4 f = k1f[s * 32 + lane];
        passp::FragB bf;
        bf.hi[0] = f.x; bf.hi[1] = f.y; bf.lo[0] = f.z; bf.lo[1] = f.w;
        passp::mma3(e1, a, bf);
      }
    }
    // emb2 = emb1 . K2, one k step: emb1's accumulator is its A fragment;
    // each n-tile's x * emb2 (pass S: dout[ji] * emb2) replaces x in the
    // stage
    passp::FragA a2;
    passp::set_a<true>(a2, e1[0], e1[2], e1[1], e1[3]);
    float* xb = st + A::floats(sr);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (8 * j < d) {
        const uint4 f = k2f[j * 32 + lane];
        passp::FragB bf;
        bf.hi[0] = f.x; bf.hi[1] = f.y; bf.lo[0] = f.z; bf.lo[1] = f.w;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        passp::mma3(c, a2, bf);
        float2* x0 = reinterpret_cast<float2*>(xb + g * ldx + 8 * j + 2 * t);
        float2* x1 =
            reinterpret_cast<float2*>(xb + (g + 8) * ldx + 8 * j + 2 * t);
        const float2 v0 = *x0, v1 = *x1;
        *x0 = make_float2(v0.x * c[0], v0.y * c[1]);
        *x1 = make_float2(v1.x * c[2], v1.y * c[3]);
      }
    }
    __syncwarp();
    // each triplet's row into its output row (pass S: d x at kj), in
    // position order: the tile's rows (this lane's four columns) and ids
    // read first, then summed
    const int cnt = min(kM, p_end - (p_begin + i * kM));
    const unsigned use = __ballot_sync(kFull, lane < cnt && taken(kj0, ji0));
    float4 v[kM];
    int jv[kM];
#pragma unroll
    for (int e = 0; e < kM; ++e) {
      jv[e] = __shfl_sync(kFull, kS ? kj0 : ji0, e);
      v[e] = c4 < d ? *reinterpret_cast<const float4*>(xb + e * ldx + c4)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int e = 0; e < kM; ++e) {
      const int j = jv[e];
      if (((use >> e) & 1u) && j >= cur) {
        if (j != cur) {
          flush(j);
          cur = j;
          acc = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        acc.x += v[e].x;
        acc.y += v[e].y;
        acc.z += v[e].z;
        acc.w += v[e].w;
      }
    }
    __syncwarp();  // this stage is refilled by the next tile's fetch
#pragma unroll
    for (int u = 0; u < S; ++u) {
      tr[u] = tr[u + 1];
      kjr[u] = kjr[u + 1];
      jir[u] = jir[u + 1];
    }
    load_ids(i + S + 1, tr[S], kjr[S], jir[S]);
  }
  cp_async_wait_all();
  flush(r_end);
}

// route 1 of the forward or pass S: a persistent grid, every warp one
// share of the rows; about one warp a row at most
template <int MODE, class A>
int launch(const Args& p, const A& src, int sms, cudaStream_t st) {
  const size_t smem = sizeof(float) *
      static_cast<size_t>(smem_words<A>(p.sr, p.d));
  int per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_tc_kernel<MODE, A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fwd_tc_kernel<MODE, A>, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (p.n_rows + kWarps - 1) / kWarps;
  const int grid = min(sms * per_sm, blocks);
  fwd_tc_kernel<MODE, A><<<grid, kThreads, smem, st>>>(p, src);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tritc
}  // namespace
