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
// Route 1 of each pass (three kernels), the first designs as one template
// in three modes (route 2), and a reduction:
//
// gat_fwd_kernel — the forward, route 1.  Replaces
//   hydragnn_tpu/ops/gat_mp.py:_fwd_impl (pl.pallas_call at :259).  One
//   warp per receiver row walks the row's CSR range in edge order, lane l
//   holding the acc slots of column h F + 32 i + l of each head (slot i <
//   S), as passes R and S (route 1, below) hold theirs; lane u < U loads
//   the sender id of a group's edge u, two groups ahead, and lane t < H
//   head t's b scalars, one group ahead.
//   The logits stay in lane order, so that m equals the plain version's
//   bit for bit.  The xl rows of a group of U edges are copied with
//   cp.async into a ring of two groups in the warp's shared memory (the
//   next group's in flight while this one is computed, no register held
//   for them), beside the row's own xr and the block's att, each head at a
//   stride hs = 4 q floats (q = ceil(F / 4) made odd): lane u H + h forms
//   head h's F products z * att of edge u from float4 reads at word hs (u
//   H + h) + k, which fall in distinct banks, and adds them one after
//   another, U H chains at once where the first design ran H.  Lane t < H
//   then folds the group's U logits of head t into the online softmax (no
//   [E, HF] tensor, as in flash attention): one max, one rescale, then
//   each edge's p and p b in edge order; the acc slots are rescaled and
//   updated once a group from the staged rows.  m is a max, so the
//   grouping leaves it exact; d and acc move by roundings only.  U
//   (fwd_group_of) is the most edges whose U H chains take a lane each and
//   whose two groups' rows fit the warp's part of a block's stage sized
//   for four blocks a SM: 3 at 6 x 64, 1 at 3 x 256.  What held the first
//   design back: one edge at a time, a dependent load of
//   send[k] before the xl[src] row, the products staged with three
//   __syncwarp()s an edge, one lane a head adding F products in series
//   and no other edge's loads in flight.  Route 1 takes the widths of
//   passes R and S (lane_route); gat_kernel<kFwd> (route 2, the first
//   design: per edge in edge order, the online-softmax state rescaled per
//   edge in shared memory, acc in registers) the others, and the card
//   checks ask for it by route to time it beside route 1.
// gat_pass_r_kernel (+ gat_sum_partials_kernel) — backward pass R, route
//   1.  Replaces :_gea_bwd's receiver-side pass (pl.pallas_call at :543).
//   Receiver order again: recompute z, e and p = exp(e - m[dst]) (m
//   frozen), de = p (b <ga[dst], xl[src]>_h + gd[dst]), dz = de * att *
//   leaky_relu'(z); sum dz into the dxr row, and z_act * de into d att.
//   Pass S's route 1 with pass R's roles: one warp per receiver row, lane
//   l holding column h F + 32 i + l of each head (slot i < S), the row's
//   own xr, ga and att slots in registers once per row and lane t < H
//   holding head t's m[dst] and gd[dst]; the row's sender ids loaded 32
//   at a time (one a lane, broadcast by shuffles), U edges' xl[src] rows
//   and b scalars issued before their arithmetic; each head's e and q
//   summed across lanes by the same reduce-scatter butterfly, lane h
//   forming head h's de and shuffling it back to the head's slots; dxr
//   summed in registers in edge order.  Each lane keeps its d att slots in
//   registers across all of its warp's rows; at the end the block's warps
//   add theirs in warp order through shared memory and the block writes
//   one partial of HF floats; gat_sum_partials_kernel sums the partials
//   in block order.  The grid is min(n_parts, row blocks), so a block's
//   rows are fixed and d att is deterministic.  What held the first
//   design back (gat_kernel<kPassR>, route 2) was pass S's old shape: a
//   dependent load of send[k] before the xl[src] row, no other edge's
//   loads in flight, both products staged in shared memory, one lane a
//   head adding F logit products and then F q products one after another,
//   and d att read-modify-written in shared memory between __syncwarp()s.
// gat_kernel<kPassR> — pass R, route 2: the first design, for the widths
//   route 1 does not take (as pass S's route 2); the card checks also ask
//   for it by route to time it beside route 1.  Its warps keep their d att
//   partials in shared memory and the block sums them in warp order.
// gat_pass_s_kernel — backward pass S, route 1.  Replaces :_gea_bwd's
//   sender-side pass (pl.pallas_call at :594).  One warp per sender row
//   walks the row's range of sender-sorted positions (edge ids through
//   edge_perm_sender), recomputes as pass R and sums p b ga[dst] + dz into
//   the dxl row.  What held the first design back was latency: per edge a
//   chain of dependent loads (perm, recv, then the rows), products staged
//   in shared memory, each head's logit and q summed by one lane, F adds
//   one after another, three __syncwarp()s, and no edge's loads in flight
//   while another edge was computed.  Route 1 loads the group's edge ids
//   and receiver ids 32 at a time (one load a lane, broadcast by
//   shuffles), issues an edge's xr[dst] and ga[dst] rows and m, gd and b
//   scalars together before its arithmetic (two edges' at NJ <= 8 slots
//   a lane), and sums each head's
//   logit e and q = <ga[dst], xl[src]>_h across lanes: lane l holds
//   columns h F + 32 i + l of head h (i < S = ceil(F / 32), the head's
//   slots) and adds its S products in slot order; then the fixed
//   butterfly of __shfl_xor_sync over offsets 16, 8, 4, 2, 1, done as a
//   reduce-scatter (a lane holding c values keeps the half its offset bit
//   picks and adds its partner's partials of those: c / 2 shuffles a
//   step, 30 an edge at 6 heads where a butterfly per value takes 60,
//   the same sums bit for bit); lane h gathers head h's e and q, holds
//   its m, gd and b, forms p = exp(e - m), p b and de, and shuffles them
//   back to the head's slots.  No shared memory and no barrier.  e is
//   summed in another order than the forward's (lane order), so p sees e
//   rounded differently: the kernel is held to the plain version at the
//   first design's tolerance (1e-5 of dxl's largest entry).  Route 1
//   takes S <= 8 (F <= 256), H S <= 32 slots a lane and H <= 16 heads,
//   every path's width among them (6 x 64, 3 x 256 a group); pass R's
//   route 1 takes the same widths (lane_route).
// gat_kernel<kPassS> — pass S, route 2: the first design, for the other
//   widths (many narrow heads, or F > 256); the card checks also ask for
//   it by route to time it beside route 1.
//
// Bound on the H100 SXM: bytes at these widths.  Per real edge the forward
// reads one xl row (4 HF bytes) and does ~8 HF flops plus ~5 per head, i.e.
// ~2 flop/byte against the card's ~20 flop/byte float32 ridge; the
// backward passes read two or three rows and do ~3x the forward's flops.
// The rows gathered per edge are what the bound counts once per node (a
// node's xl row is read by each of its ~10 out-edges, from L2).  Design,
// first version (route 2): lanes of a warp span the HF columns (each xl,
// xr, ga row access is one coalesced 128-byte line per 32 columns); each
// head's logit is summed in lane order by one lane from the per-lane
// products staged in shared memory (head stride F | 1, conflict-free
// across heads), so the logits, and with them m, are bit-identical to the
// plain version's sequential sum; in both forwards the multiply and the
// adds of that sum are __fmul_rn / __fadd_rn so that no contraction
// changes them.  Not yet: several rows per warp for small HF, tensor
// cores.
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

constexpr unsigned kFull = 0xffffffffu;

// Route 1 of passes R and S: the values a lane sums across the warp, e and
// q of NJ / S heads, padded to a power of two
template <int NJ, int S>
__host__ __device__ constexpr int lane_values() {
  return 2 * NJ / S <= 2 ? 2 : 2 * NJ / S <= 4 ? 4
         : 2 * NJ / S <= 8 ? 8 : 2 * NJ / S <= 16 ? 16 : 32;
}

template <int P>
__host__ __device__ constexpr int log2_of() {
  return P == 2 ? 1 : P == 4 ? 2 : P == 8 ? 3 : P == 16 ? 4 : 5;
}

// The butterfly over offsets 16, 8, 4, 2, 1 as a reduce-scatter: while a
// lane holds c > 1 values, it keeps the half its offset bit picks and adds
// the partner's partials of those; the sums are those of the full
// butterfly, bit for bit.  After it the lane whose offset bits 16, 8, ...
// (the first log2 P of them) spell value v holds v's sum in val[0].
template <int P>
__device__ __forceinline__ void lane_sums(float (&val)[P], int lane) {
  int c = P;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (c > 1) {
      const bool upper = (lane & o) != 0;
#pragma unroll
      for (int k = 0; k < P / 2; ++k) {
        if (k < c / 2) {
          const float send = upper ? val[k] : val[k + c / 2];
          const float keep = upper ? val[k + c / 2] : val[k];
          val[k] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, o));
        }
      }
      c /= 2;
    } else {
      val[0] = __fadd_rn(val[0], __shfl_xor_sync(kFull, val[0], o));
    }
  }
}

// The lane that holds value 2 t (e of head t) after lane_sums, for lane t;
// value 2 t + 1 (its q) sits one more lowest bit on: lane_of_sum + (16 >>
// (log2 P - 1))
template <int P>
__device__ __forceinline__ int lane_of_sum(int t) {
  constexpr int LOG_P = log2_of<P>();
  int src = 0;
#pragma unroll
  for (int b = 0; b < LOG_P; ++b)
    if ((2 * t >> (LOG_P - 1 - b)) & 1) src |= 16 >> b;
  return src;
}

// Pass S, route 1 (see the note above): slot j of lane l is column (j / S)
// F + 32 (j % S) + l, of head j / S, where the head exists (j / S < H) and
// the column lies in it (32 (j % S) + l < F); NJ >= H S slots a lane.  U
// edges' loads are in flight together.
template <int NJ, int S>
__global__ void __launch_bounds__(kThreads) gat_pass_s_kernel(Params p) {
  static_assert(NJ % S == 0 && NJ <= 32 && NJ / S <= 16,
                "slots: whole heads, at most 32 and 16 heads");
  // edges whose loads are in flight together: more cost registers, and
  // the warps a SM holds hide the latency better
  constexpr int U = NJ <= 8 ? 2 : 1;
  constexpr int P = lane_values<NJ, S>();
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kWarps + threadIdx.x / kWarp;
  if (row >= p.n_rows) return;
  const int hf = p.hf, f = p.f, h = p.h;
  const float slope = p.slope;
  // lane t < H: the lanes that hold head t's e and q after lane_sums
  const int src_e = lane_of_sum<P>(lane);
  const int src_q = 16 >> (log2_of<P>() - 1);
  unsigned ok = 0u;   // bit j: slot j holds a column
  float own[NJ], attv[NJ], sum[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int in_head = 32 * (j % S) + lane;
    const bool v = j / S < h && in_head < f;
    const int c = (j / S) * f + in_head;
    ok |= v ? 1u << j : 0u;
    own[j] = v ? __ldg(p.xl + static_cast<size_t>(row) * hf + c) : 0.f;
    attv[j] = v ? __ldg(p.att + c) : 0.f;
    sum[j] = 0.f;
  }
  const int e0 = __ldg(p.row_ptr + row);
  const int e1 = __ldg(p.row_ptr + row + 1);
  for (int base = e0; base < e1; base += kWarp) {
    const int cnt = min(kWarp, e1 - base);
    const int e_l = lane < cnt ? __ldg(p.perm + base + lane) : 0;
    int d_l = lane < cnt ? __ldg(p.recv + e_l) : -1;
    if (static_cast<unsigned>(d_l) >= static_cast<unsigned>(p.n_rows))
      d_l = -1;
    for (int i = 0; i < cnt; i += U) {
      // the group's loads: every address clamped in range, all issued
      // before the arithmetic
      float xo[U][NJ], go[U][NJ], mh[U], gdh[U], bh[U];
      int dv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        dv[u] = __shfl_sync(kFull, d_l, (i + u) & 31);
        const int ev = __shfl_sync(kFull, e_l, (i + u) & 31);
        if (i + u >= cnt) dv[u] = -1;
        const int dst = dv[u] >= 0 ? dv[u] : 0;
        const float* xr_row = p.xr + static_cast<size_t>(dst) * hf;
        const float* ga_row = p.ga + static_cast<size_t>(dst) * hf;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const bool v = (ok >> j) & 1u;
          const int c = (j / S) * f + 32 * (j % S) + lane;
          xo[u][j] = v ? __ldg(xr_row + c) : 0.f;
          go[u][j] = v ? __ldg(ga_row + c) : 0.f;
        }
        // lane t < H: head t's scalars
        const int t = lane < h ? lane : 0;
        mh[u] = __ldg(p.m + static_cast<size_t>(dst) * h + t);
        gdh[u] = __ldg(p.gd + static_cast<size_t>(dst) * h + t);
        bh[u] = p.b ? __ldg(p.b + static_cast<size_t>(ev) * h + t) : 1.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (dv[u] < 0) continue;
        // the lane's partials: value 2h the logit e of head h, 2h + 1 its
        // q, each its S slots in order (zeros past the heads)
        float val[P];
#pragma unroll
        for (int v = 0; v < P; ++v) val[v] = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float z = __fadd_rn(own[j], xo[u][j]);
          xo[u][j] = z;
          const float pe = __fmul_rn(leaky(z, slope), attv[j]);
          const float pq = __fmul_rn(go[u][j], own[j]);
          const int v = 2 * (j / S);
          val[v] = j % S == 0 ? pe : __fadd_rn(val[v], pe);
          val[v + 1] = j % S == 0 ? pq : __fadd_rn(val[v + 1], pq);
        }
        lane_sums(val, lane);
        // lane t < H: head t's e and q from the lanes that hold them, its
        // p b and de; zeros on the other lanes
        const float e_mine = __shfl_sync(kFull, val[0], src_e);
        const float q_mine = __shfl_sync(kFull, val[0], src_e + src_q);
        float pb = 0.f, de = 0.f;
        if (lane < h) {
          const float pt = expf(e_mine - mh[u]);
          pb = pt * bh[u];
          de = pt * (bh[u] * q_mine + gdh[u]);
        }
        float cpb = 0.f, cde = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j % S == 0) {
            cpb = __shfl_sync(kFull, pb, j / S);
            cde = __shfl_sync(kFull, de, j / S);
          }
          const float dz = cde * attv[j] * (xo[u][j] > 0.f ? 1.f : slope);
          sum[j] += cpb * go[u][j] + dz;
        }
      }
    }
  }
  float* out_row = p.out + static_cast<size_t>(row) * hf;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if ((ok >> j) & 1u) out_row[(j / S) * f + 32 * (j % S) + lane] = sum[j];
}

// Pass R, route 1 (see the note above): the slots of pass S's route 1.
// Warp w of block b takes the receiver rows b kWarps + w + i gridDim.x
// kWarps, in that order; U edges' loads are in flight together.  The
// block's d att partial: its warps' register partials added in warp order.
template <int NJ, int S>
__global__ void __launch_bounds__(kThreads) gat_pass_r_kernel(Params p) {
  static_assert(NJ % S == 0 && NJ <= 32 && NJ / S <= 16,
                "slots: whole heads, at most 32 and 16 heads");
  // one row gathered an edge (pass S gathers two): two edges in flight up
  // to 12 slots a lane
  constexpr int U = NJ <= 12 ? 2 : 1;
  constexpr int P = lane_values<NJ, S>();
  __shared__ float datt_w[kWarps][NJ * kWarp];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int hf = p.hf, f = p.f, h = p.h;
  const float slope = p.slope;
  // lane t < H: the lanes that hold head t's e and q after lane_sums
  const int src_e = lane_of_sum<P>(lane);
  const int src_q = 16 >> (log2_of<P>() - 1);
  const int t = lane < h ? lane : 0;   // lane t < H: head t's scalars
  unsigned ok = 0u;   // bit j: slot j holds a column
  float attv[NJ], datt[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int in_head = 32 * (j % S) + lane;
    const bool v = j / S < h && in_head < f;
    ok |= v ? 1u << j : 0u;
    attv[j] = v ? __ldg(p.att + (j / S) * f + in_head) : 0.f;
    datt[j] = 0.f;
  }
  const int stride = gridDim.x * kWarps;
  for (int row = blockIdx.x * kWarps + warp; row < p.n_rows; row += stride) {
    const float* xr_row = p.xr + static_cast<size_t>(row) * hf;
    const float* ga_row = p.ga + static_cast<size_t>(row) * hf;
    float own[NJ], gar[NJ], sum[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const bool v = (ok >> j) & 1u;
      const int c = (j / S) * f + 32 * (j % S) + lane;
      own[j] = v ? __ldg(xr_row + c) : 0.f;
      gar[j] = v ? __ldg(ga_row + c) : 0.f;
      sum[j] = 0.f;
    }
    const float mh = __ldg(p.m + static_cast<size_t>(row) * h + t);
    const float gdh = __ldg(p.gd + static_cast<size_t>(row) * h + t);
    const int e0 = __ldg(p.row_ptr + row);
    const int e1 = __ldg(p.row_ptr + row + 1);
    for (int base = e0; base < e1; base += kWarp) {
      const int cnt = min(kWarp, e1 - base);
      int s_l = lane < cnt ? __ldg(p.send + base + lane) : -1;
      if (static_cast<unsigned>(s_l) >= static_cast<unsigned>(p.n_rows))
        s_l = -1;
      for (int i = 0; i < cnt; i += U) {
        // the group's loads: every address clamped in range, all issued
        // before the arithmetic
        float xo[U][NJ], bh[U];
        int sv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          sv[u] = __shfl_sync(kFull, s_l, (i + u) & 31);
          if (i + u >= cnt) sv[u] = -1;
          const float* xl_row =
              p.xl + static_cast<size_t>(sv[u] >= 0 ? sv[u] : 0) * hf;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const bool v = (ok >> j) & 1u;
            xo[u][j] = v ? __ldg(xl_row + (j / S) * f + 32 * (j % S) + lane)
                         : 0.f;
          }
          const int ev = min(base + i + u, e1 - 1);
          bh[u] = p.b ? __ldg(p.b + static_cast<size_t>(ev) * h + t) : 1.f;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (sv[u] < 0) continue;
          // the lane's partials: value 2h the logit e of head h, 2h + 1
          // its q, each its S slots in order (zeros past the heads)
          float val[P];
          unsigned pos = 0u;
#pragma unroll
          for (int v = 0; v < P; ++v) val[v] = 0.f;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float z = __fadd_rn(xo[u][j], own[j]);
            const float pq = __fmul_rn(gar[j], xo[u][j]);
            const float zl = leaky(z, slope);
            xo[u][j] = zl;
            pos |= z > 0.f ? 1u << j : 0u;
            const float pe = __fmul_rn(zl, attv[j]);
            const int v = 2 * (j / S);
            val[v] = j % S == 0 ? pe : __fadd_rn(val[v], pe);
            val[v + 1] = j % S == 0 ? pq : __fadd_rn(val[v + 1], pq);
          }
          lane_sums(val, lane);
          // lane t < H: head t's de; zeros on the other lanes
          const float e_mine = __shfl_sync(kFull, val[0], src_e);
          const float q_mine = __shfl_sync(kFull, val[0], src_e + src_q);
          float de = 0.f;
          if (lane < h) de = expf(e_mine - mh) * (bh[u] * q_mine + gdh);
          float cde = 0.f;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            if (j % S == 0) cde = __shfl_sync(kFull, de, j / S);
            sum[j] += cde * attv[j] * ((pos >> j) & 1u ? 1.f : slope);
            datt[j] += xo[u][j] * cde;
          }
        }
      }
    }
    float* out_row = p.out + static_cast<size_t>(row) * hf;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if ((ok >> j) & 1u) out_row[(j / S) * f + 32 * (j % S) + lane] = sum[j];
  }
  // the block's partial: its warps' d att slots added in warp order
#pragma unroll
  for (int j = 0; j < NJ; ++j) datt_w[warp][j * kWarp + lane] = datt[j];
  __syncthreads();
  for (int c = threadIdx.x; c < hf; c += kThreads) {
    const int hh = c / f, in_head = c - hh * f;
    const int slot = (hh * S + in_head / kWarp) * kWarp + in_head % kWarp;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += datt_w[w][slot];
    p.partial[static_cast<size_t>(blockIdx.x) * hf + c] = s;
  }
}

// The forward's staged head stride: 4 q floats, q = ceil(F / 4) made odd,
// so that lanes u H + h, reading word hs (u H + h) + k as float4s, fall in
// distinct banks
__host__ __device__ inline int fwd_head_stride(int f) {
  return 4 * (((f + 3) / 4) | 1);
}

// The forward's route 1: the floats of a warp's stage at most (two groups'
// xl rows and the row's own xr, each H heads of hs floats), so that four
// blocks of four warps fit a SM
constexpr int kFwdWarpFloats = 3456;

// U, the edges of a group at NJ slots of S a head (see the note above):
// the U H chains take a lane each (H <= NJ / S), and 2 U + 1 staged rows of
// NJ / S heads of the instantiation's widest head stride (32 S + 4) fit
// kFwdWarpFloats
__host__ __device__ constexpr int fwd_group_of(int nj, int s) {
  const int by_smem = (kFwdWarpFloats / ((nj / s) * (32 * s + 4)) - 1) / 2;
  const int by_lanes = 32 / (nj / s);
  return by_smem < 1 ? 1 : by_smem < by_lanes ? by_smem : by_lanes;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(a), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(a), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// A row of H F floats into the stage, head hh at dst[hh hs + k]: the warp's
// lanes share the 16-byte pieces (4-byte ones when F % 4 != 0); zeros when
// !valid
__device__ __forceinline__ void stage_row(float* dst, const float* src,
                                          bool valid, int hf, int f, int hs,
                                          int lane) {
  if ((f & 3) == 0) {
    for (int c = 4 * lane; c < hf; c += 4 * kWarp) {
      const int hh = c / f;
      cp_async16(dst + hh * hs + c - hh * f, src + c, valid);
    }
  } else {
    for (int c = lane; c < hf; c += kWarp) {
      const int hh = c / f;
      cp_async4(dst + hh * hs + c - hh * f, src + c, valid);
    }
  }
}

__device__ __forceinline__ float fwd_product(float x, float o, float a,
                                             float slope) {
  return __fmul_rn(leaky(__fadd_rn(x, o), slope), a);
}

// One head's logit from its staged xl[src] (x), xr[dst] (o) and att (a)
// columns: the F products z * att added in lane order (((p0 + p1) + p2)
// + ...), read as float4s (16-byte aligned)
__device__ __forceinline__ float head_chain(const float* x, const float* o,
                                            const float* a, int f,
                                            float slope) {
  const int f4 = f & ~3;
  float v;
  int k;
  if (f4 > 0) {
    const float4 X = *reinterpret_cast<const float4*>(x);
    const float4 O = *reinterpret_cast<const float4*>(o);
    const float4 A = *reinterpret_cast<const float4*>(a);
    v = fwd_product(X.x, O.x, A.x, slope);
    v = __fadd_rn(v, fwd_product(X.y, O.y, A.y, slope));
    v = __fadd_rn(v, fwd_product(X.z, O.z, A.z, slope));
    v = __fadd_rn(v, fwd_product(X.w, O.w, A.w, slope));
    k = 4;
  } else {
    v = fwd_product(x[0], o[0], a[0], slope);
    k = 1;
  }
  for (; k < f4; k += 4) {
    const float4 X = *reinterpret_cast<const float4*>(x + k);
    const float4 O = *reinterpret_cast<const float4*>(o + k);
    const float4 A = *reinterpret_cast<const float4*>(a + k);
    v = __fadd_rn(v, fwd_product(X.x, O.x, A.x, slope));
    v = __fadd_rn(v, fwd_product(X.y, O.y, A.y, slope));
    v = __fadd_rn(v, fwd_product(X.z, O.z, A.z, slope));
    v = __fadd_rn(v, fwd_product(X.w, O.w, A.w, slope));
  }
  for (; k < f; ++k) v = __fadd_rn(v, fwd_product(x[k], o[k], a[k], slope));
  return v;
}

// Forward, route 1 (see the note above): one warp per receiver row, groups
// of U edges.  Dynamic shared memory: att [H][hs] for the block, then per
// warp its row's xr [H][hs] and a ring of two groups' xl rows [2][U][H][hs].
template <int NJ, int S>
__global__ void __launch_bounds__(kThreads) gat_fwd_kernel(Params p) {
  static_assert(NJ % S == 0 && NJ <= 32 && NJ / S <= 16,
                "slots: whole heads, at most 32 and 16 heads");
  constexpr int U = fwd_group_of(NJ, S);
  static_assert(U >= 1 && U * (NJ / S) <= kWarp, "a logit a lane");
  extern __shared__ float4 fwd_smem4[];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int hf = p.hf, f = p.f, h = p.h;
  const int hs = fwd_head_stride(f), rs = h * hs;   // a staged row
  float* att_s = reinterpret_cast<float*>(fwd_smem4);
  float* own_s = att_s + rs + warp * (2 * U + 1) * rs;
  float* ring = own_s + rs;
  for (int c = threadIdx.x; c < hf; c += kThreads) {
    const int hh = c / f;
    att_s[hh * hs + c - hh * f] = __ldg(p.att + c);
  }
  __syncthreads();
  const int row = blockIdx.x * kWarps + warp;
  if (row >= p.n_rows) return;   // no block barrier follows
  const float slope = p.slope;
  const int e0 = __ldg(p.row_ptr + row);
  const int e1 = __ldg(p.row_ptr + row + 1);
  const int n_groups = (e1 - e0 + U - 1) / U;
  unsigned ok = 0u;   // bit j: slot j holds a column
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    ok |= j / S < h && 32 * (j % S) + lane < f ? 1u << j : 0u;
    acc[j] = 0.f;
  }
  // lane t < H: head t's running max and denominator
  const int t = lane < h ? lane : 0;
  float m_run = kNeg, d_run = 0.f;
  // lane u H + hh < U H: the logit of head hh of the group's edge u
  const bool summer = lane < U * h;
  const int lh = summer ? lane % h : 0;
  // lane u < U: the sender of the group's edge u (-1: none)
  auto sender = [&](int grp) {
    const int k = e0 + grp * U + lane;
    const int sv = lane < U && k < e1 ? __ldg(p.send + k) : -1;
    return static_cast<unsigned>(sv) < static_cast<unsigned>(p.n_rows) ? sv
                                                                       : -1;
  };
  // lane t < H: head t's dropout bits of the group's edges
  auto bits = [&](int grp, float (&bh)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = min(e0 + grp * U + u, e1 - 1);
      bh[u] = p.b ? __ldg(p.b + static_cast<size_t>(k) * h + t) : 1.f;
    }
  };
  // the group's xl rows into its half of the ring, one commit group
  auto issue = [&](int grp, int s_l) {
    float* dst = ring + (grp & 1) * U * rs;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int sv = __shfl_sync(kFull, s_l, u);
      stage_row(dst + u * rs, p.xl + static_cast<size_t>(sv >= 0 ? sv : 0) * hf,
                sv >= 0, hf, f, hs, lane);
    }
    cp_async_commit();
  };
  int s_cur = -1, s_next = -1;
  float b_cur[U], b_next[U];
  if (n_groups > 0) {
    stage_row(own_s, p.xr + static_cast<size_t>(row) * hf, true, hf, f, hs,
              lane);
    s_cur = sender(0);
    issue(0, s_cur);
    if (n_groups > 1) s_next = sender(1);
    bits(0, b_cur);
  }
  for (int grp = 0; grp < n_groups; ++grp) {
    // the next group's rows in flight while this one is computed
    if (grp + 1 < n_groups) {
      issue(grp + 1, s_next);
      bits(grp + 1, b_next);
    } else {
      cp_async_commit();
    }
    const int s_after = grp + 2 < n_groups ? sender(grp + 2) : -1;
    cp_async_wait_one();
    __syncwarp();
    const float* xs = ring + (grp & 1) * U * rs;
    const unsigned real = __ballot_sync(kFull, s_cur >= 0);
    const float e = summer ? head_chain(xs + lane * hs, own_s + lh * hs,
                                        att_s + lh * hs, f, slope)
                           : 0.f;
    // lane t < H: head t's logits of the group, one max, one rescale,
    // then each edge's p (and p b) in edge order
    float pb[U];
    float mn = m_run;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      pb[u] = __shfl_sync(kFull, e, u * h + t);
      if ((real >> u) & 1u) mn = fmaxf(mn, pb[u]);
    }
    const float r = expf(m_run - mn);
    d_run *= r;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float pe = (real >> u) & 1u ? expf(pb[u] - mn) : 0.f;
      d_run += pe;
      pb[u] = pe * b_cur[u];
    }
    m_run = mn;
    // every slot: acc = acc r + sum over the group, in edge order, of
    // p b xl[src]
    float cr = 0.f, cpb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) cpb[u] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j % S == 0) {
        cr = __shfl_sync(kFull, r, j / S);
#pragma unroll
        for (int u = 0; u < U; ++u)
          cpb[u] = __shfl_sync(kFull, pb[u], j / S);
      }
      if ((ok >> j) & 1u) {
        const float* xc = xs + (j / S) * hs + 32 * (j % S) + lane;
        float a = acc[j] * cr;
#pragma unroll
        for (int u = 0; u < U; ++u) a += cpb[u] * xc[u * rs];
        acc[j] = a;
      }
    }
    __syncwarp();   // this half of the ring is refilled two groups on
    s_cur = s_next;
    s_next = s_after;
#pragma unroll
    for (int u = 0; u < U; ++u) b_cur[u] = b_next[u];
  }
  float* out_row = p.out + static_cast<size_t>(row) * hf;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if ((ok >> j) & 1u) out_row[(j / S) * f + 32 * (j % S) + lane] = acc[j];
  if (lane < h) {
    p.m_out[static_cast<size_t>(row) * h + lane] = m_run;
    p.d_out[static_cast<size_t>(row) * h + lane] = d_run;
  }
}

// slots of a head in route 1: ceil(F / 32) rounded up to 1, 2, 4 or 8 (0
// past 8: route 2)
__host__ inline int head_slots(int f) {
  const int s = (f + 31) / 32;
  return s <= 1 ? 1 : s <= 2 ? 2 : s <= 4 ? 4 : s <= 8 ? 8 : 0;
}

// the route of pass R and pass S at these widths: 1 where a head takes at
// most 8 slots, the heads at most 32 and there are at most 16 heads, else 2
__host__ inline int lane_route(int hf, int f) {
  const int s = head_slots(f), h = hf / f;
  return s > 0 && h * s <= 32 && h <= 16 ? 1 : 2;
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

// the forward's route-1 stage: att, then kWarps warps of 2 U + 1 rows, each
// H heads of hs floats
template <int NJ, int S>
size_t fwd_smem(const Params& p) {
  const int rows = 1 + kWarps * (2 * fwd_group_of(NJ, S) + 1);
  return sizeof(float) * static_cast<size_t>(rows) * p.h *
         fwd_head_stride(p.f);
}

template <int MODE, int NJ, int S>
int launch_route1(const Params& p, int grid, cudaStream_t st) {
  if constexpr (MODE == kFwd) {
    const size_t smem = fwd_smem<NJ, S>(p);
    const cudaError_t err = cudaFuncSetAttribute(
        gat_fwd_kernel<NJ, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    gat_fwd_kernel<NJ, S><<<grid, kThreads, smem, st>>>(p);
  } else if constexpr (MODE == kPassR) {
    gat_pass_r_kernel<NJ, S><<<grid, kThreads, 0, st>>>(p);
  } else {
    gat_pass_s_kernel<NJ, S><<<grid, kThreads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// NJ = the smallest instantiated count >= H S (route 1: H <= 16 heads):
// 4, 8, 16 at S = 1; 4, 12 (6 heads of 64), 16, 32 at S = 2; 4, 8, 16, 32
// at S = 4; 8, 24 (3 heads of 256), 32 at S = 8.  A count rounded up
// leaves slots empty, at the cost of registers only.
template <int MODE, int S>
int launch_route1_width(const Params& p, int grid, cudaStream_t st) {
  const int nj = p.h * S;
  if constexpr (S == 1) {
    if (nj <= 4) return launch_route1<MODE, 4, 1>(p, grid, st);
    if (nj <= 8) return launch_route1<MODE, 8, 1>(p, grid, st);
    return launch_route1<MODE, 16, 1>(p, grid, st);
  } else if constexpr (S == 2) {
    if (nj <= 4) return launch_route1<MODE, 4, 2>(p, grid, st);
    if (nj <= 12) return launch_route1<MODE, 12, 2>(p, grid, st);
    if (nj <= 16) return launch_route1<MODE, 16, 2>(p, grid, st);
    return launch_route1<MODE, 32, 2>(p, grid, st);
  } else if constexpr (S == 4) {
    if (nj <= 4) return launch_route1<MODE, 4, 4>(p, grid, st);
    if (nj <= 8) return launch_route1<MODE, 8, 4>(p, grid, st);
    if (nj <= 16) return launch_route1<MODE, 16, 4>(p, grid, st);
    return launch_route1<MODE, 32, 4>(p, grid, st);
  } else {
    if (nj <= 8) return launch_route1<MODE, 8, 8>(p, grid, st);
    if (nj <= 24) return launch_route1<MODE, 24, 8>(p, grid, st);
    return launch_route1<MODE, 32, 8>(p, grid, st);
  }
}

// the count route 1 instantiates for H heads of S slots: launch_route1_width
// written out (0 past route 1's widths)
__host__ inline int route1_nj(int h, int s) {
  static constexpr int kCounts[4][4] = {
      {4, 8, 16, 0}, {4, 12, 16, 32}, {4, 8, 16, 32}, {8, 24, 32, 0}};
  const int* counts = kCounts[s == 1 ? 0 : s == 2 ? 1 : s == 4 ? 2 : 3];
  for (int k = 0; k < 4; ++k)
    if (counts[k] >= h * s) return counts[k];
  return 0;
}

// the forward's, pass R's or pass S's route 1 (MODE) at the slots of the
// head width
template <int MODE>
int launch_route1_slots(const Params& p, int grid, cudaStream_t st) {
  switch (head_slots(p.f)) {
    case 1: return launch_route1_width<MODE, 1>(p, grid, st);
    case 2: return launch_route1_width<MODE, 2>(p, grid, st);
    case 4: return launch_route1_width<MODE, 4>(p, grid, st);
    default: return launch_route1_width<MODE, 8>(p, grid, st);
  }
}

}  // namespace

// The forward's route at these widths: the rule of passes R and S (1 or 2;
// 0 for widths no kernel takes).
extern "C" int hg_gat_fwd_route(int hf, int f) {
  if (f < 1 || hf < f || hf > kMaxHF || hf % f != 0) return 0;
  return lane_route(hf, f);
}

// The forward's route-1 group U at these widths (0 where the forward takes
// route 2 or no kernel takes them).
extern "C" int hg_gat_fwd_group(int hf, int f) {
  if (hg_gat_fwd_route(hf, f) != 1) return 0;
  const int s = head_slots(f);
  return fwd_group_of(route1_nj(hf / f, s), s);
}

// Pass S's route at these widths (1 or 2; 0 for widths no kernel takes).
extern "C" int hg_gat_pass_s_route(int hf, int f) {
  if (f < 1 || hf < f || hf > kMaxHF || hf % f != 0) return 0;
  return lane_route(hf, f);
}

// Pass R's route at these widths: pass S's rule (1 or 2; 0 for widths no
// kernel takes).
extern "C" int hg_gat_pass_r_route(int hf, int f) {
  if (f < 1 || hf < f || hf > kMaxHF || hf % f != 0) return 0;
  return lane_route(hf, f);
}

// One GAT launch; returns the cudaError_t (0 = success).  mode 0: the
// forward (out = acc, m_out, d_out; rows are receivers, row_ptr over edge
// ids); mode 1: pass R (out = dxr; `partial` scratch [n_parts, HF], `datt`
// [HF] the reduced attention gradient; rows are receivers); mode 2: pass S
// (out = dxl; rows are senders, row_ptr over sender-sorted positions and
// `perm` the sender permutation).  `route`: 0 takes the widths' own
// (hg_gat_fwd_route, hg_gat_pass_r_route, hg_gat_pass_s_route), 1 or 2
// that one where the widths admit it.  Pointers are device pointers;
// launches go on `stream` and do not synchronise.
extern "C" int hg_gat_f32(int mode, const void* xl, const void* xr,
                          const void* att, const void* send, const void* recv,
                          const void* perm, const void* row_ptr,
                          const void* b, const void* m, const void* ga,
                          const void* gd, void* out, void* m_out, void* d_out,
                          void* partial, void* datt, int n_rows, int hf,
                          int f, float slope, int n_parts, int route,
                          void* stream) {
  if (n_rows <= 0) return 0;
  if (f < 1 || hf < f || hf > kMaxHF || hf % f != 0 || mode < kFwd ||
      mode > kPassS || (mode == kPassR && n_parts < 1) ||
      (mode == kPassS && perm == nullptr) || route < 0 || route > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int own = lane_route(hf, f);
  if (route == 0) route = own;
  if (route == 1 && own != 1) return static_cast<int>(cudaErrorInvalidValue);
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
  if (mode == kFwd)
    return route == 1 ? launch_route1_slots<kFwd>(p, blocks, st)
                      : launch_width<kFwd>(p, blocks, st);
  if (mode == kPassS)
    return route == 1 ? launch_route1_slots<kPassS>(p, blocks, st)
                      : launch_width<kPassS>(p, blocks, st);
  const int grid = n_parts < blocks ? n_parts : blocks;
  const int rc = route == 1 ? launch_route1_slots<kPassR>(p, grid, st)
                            : launch_width<kPassR>(p, grid, st);
  if (rc != 0) return rc;
  gat_sum_partials_kernel<<<(hf + 255) / 256, 256, 0, st>>>(
      p.partial, static_cast<float*>(datt), grid, hf);
  return static_cast<int>(cudaGetLastError());
}
