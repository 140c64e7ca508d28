"""Multi-moment (poly) segment reductions: wrappers, plain versions, launch
counts.

Port of hydragnn_tpu/ops/poly_mp.py.  One pass over the sorted-receiver
edges gives every requested aggregation moment: sum, sum of squares, the
max of ``[v, -v]`` (so max and min) and the count.  Two kernels,
hand-written in CUDA C++ for Hopper (csrc/poly_mp.cu, built by
kernels/build.py):

- ``segment_poly_dense`` (scatter mode): moments of edge-valued ``data``
  [E, F] at nondecreasing ``sorted_ids`` — PNA's four aggregators and
  degree.
- ``gather_poly_segment`` (gather mode): the same moments of the messages
  ``x[senders] * mask`` with no ``[E, F]`` tensor in memory — SAGE's and
  MFC's neighbour sum and degree.

Both modes take one of two routes by width (:func:`fwd_route`, the C
side's ``hg_poly_segment_route``): route 1 at even F up to 128, route 2
(the first design, one warp per row) at odd F and past 128.  The scatter
mode's route 1 puts each warp on a share of the rows, the rows of 8 edges
in flight across row boundaries, a float2 a lane
(:func:`scatter_route1_walk` writes the walk out).  The gather mode's
route 1 gives each block a contiguous range of receiver rows and stages
the rows of x around them (the block's rows and up to 127 either side,
where a collated batch's senders lie) in shared memory by one bulk copy,
so that no edge gathers its sender's row from L2; a sender outside the
window is read from global memory (:func:`gather_route1_plan` writes it
out).  Both routes give the same bits.  ``launch_poly_segment``'s
``route`` (0: the width's own) lets the card checks time either beside
the other.

The reference contract is kept: the result is a tuple in kernel-moment
order (the requested subset of ``MOMENT_ORDER``): ``sum`` [N, F], ``sq``
[N, F], ``mxmn`` [N, 2F] (max of ``[v, -v]``; ``-1e9`` on empty segments,
callers apply the zero-clean), ``cnt`` [N] float32.  Masked rows
(``valid``/``mask`` == 0) sort last, are parked out of every segment's
range and enter nothing; mean and std are elementwise math outside.

Each public op is a ``torch.autograd.Function`` with the reference's
custom VJP (``_spd_bwd``, ``_gps_bwd``), which needs no kernel of its own:

- d sum / d data[e] = g_sum[ids[e]]; d sq = 2 data[e] g_sq[ids[e]];
  d mxmn = +- tie(e) g[ids[e]] / n_ties, an even split among ties (the
  tie counts ride one ``segment_sum_dense`` launch of width 2F); ``cnt``
  carries no gradient; masked rows get exactly zero.
- gather mode chains these through ``msgs = x[send] * mask`` and sums at
  senders over collate's sender-sorted permutation with
  ``segment_sum_dense``; the sum-only case (SAGE, MFC) takes the no-``w``
  gather's backward of ops/fused_mp.py on that ordering
  (``gather_sum_dx``), with no ``[E, F]`` intermediate, counted as
  ``gather_segment_sum_dx``.

At the leaves a CPU tensor takes the plain PyTorch version below (the CPU
path and the tests' oracle) and a CUDA tensor the kernel; a CUDA input the
kernel does not take raises — there is no fallback.  ``LAUNCHES`` counts
kernel launches per op, incremented only where the kernel is launched.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from hydragnn_torch.ops import fused_mp
from hydragnn_torch.ops.aggregate import segment_offsets

# empty-segment sentinel of ``mxmn`` (the reference's magnitude)
_NEG = -1e9

# canonical kernel-moment order; public dispatchers map mx/mn onto "mxmn"
MOMENT_ORDER = ("sum", "sq", "mxmn", "cnt")

# the reference kernel's width gates, kept so dispatch matches it: above
# these the dispatchers of graph/segment.py take the composed path
POLY_MAX_F_MXMN = 512
POLY_MAX_F = 1024

LAUNCHES: Dict[str, int] = {
    "segment_poly_dense": 0,
    "gather_poly_segment": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _norm_moments(moments: Sequence[str]) -> Tuple[str, ...]:
    ms = tuple(m for m in MOMENT_ORDER if m in moments)
    unknown = set(moments) - set(MOMENT_ORDER)
    if unknown or not ms:
        raise ValueError(f"moments must be a nonempty subset of "
                         f"{MOMENT_ORDER}, got {moments!r}")
    return ms


def _park(ids, num_segments, valid):
    """int32 ids with ``valid == 0`` rows parked at ``num_segments``."""
    ids = ids.to(torch.int32)
    if valid is not None:
        ids = torch.where(valid != 0, ids, num_segments)
    return ids


# ---------------------------------------------------------------------------
# plain PyTorch versions (index_add_ + scatter_reduce_), differentiable
# ---------------------------------------------------------------------------

def _moments_plain(msgs, ids, num_segments, moments, dtype):
    """Moments of float32 ``msgs`` [E, F] at ``ids`` (rows with an id
    outside ``[0, num_segments)`` enter nothing)."""
    n, f = num_segments, msgs.shape[1]
    ok = (ids >= 0) & (ids < n)
    safe = ids.clamp(0, max(n - 1, 0)).long()
    zero = torch.zeros_like(msgs)
    out = []
    for m in moments:
        if m == "sum":
            out.append(torch.zeros((n, f), dtype=torch.float32,
                                   device=msgs.device).index_add_(
                0, safe, torch.where(ok[:, None], msgs, zero)).to(dtype))
        elif m == "sq":
            out.append(torch.zeros((n, f), dtype=torch.float32,
                                   device=msgs.device).index_add_(
                0, safe, torch.where(ok[:, None], msgs * msgs, zero)
            ).to(dtype))
        elif m == "mxmn":
            both = torch.cat([msgs, -msgs], dim=1)
            both = torch.where(ok[:, None], both,
                               torch.full_like(both, _NEG))
            base = torch.full((n, 2 * f), _NEG, dtype=torch.float32,
                              device=msgs.device)
            out.append(base.scatter_reduce(
                0, safe[:, None].expand(-1, 2 * f), both, "amax",
                include_self=True).to(dtype))
        else:  # cnt
            out.append(torch.zeros(n, dtype=torch.float32,
                                   device=msgs.device).index_add_(
                0, safe, ok.to(torch.float32)))
    return tuple(out)


def segment_poly_dense_plain(data, sorted_ids, num_segments, moments,
                             valid=None):
    """The requested moments of ``data`` [E, F] per segment, in float32,
    cast to ``data``'s type (``cnt`` stays float32).  Rows with ``valid ==
    0`` or an id outside ``[0, num_segments)`` enter nothing."""
    moments = _norm_moments(moments)
    ids = _park(sorted_ids, num_segments, valid)
    return _moments_plain(data.float(), ids, num_segments, moments,
                          data.dtype)


def gather_poly_segment_plain(x, senders, receivers, moments, mask=None):
    """The requested moments of ``x[senders] * mask`` at ``receivers``.
    Edges with ``mask == 0`` enter nothing; a sender outside ``[0, N)``
    sends a zero message."""
    moments = _norm_moments(moments)
    n = x.shape[0]
    m = (torch.ones(senders.shape[0], dtype=torch.float32, device=x.device)
         if mask is None else mask.float())
    src_ok = (senders >= 0) & (senders < n)
    msgs = x[senders.clamp(0, max(n - 1, 0)).long()].float()
    msgs = torch.where(src_ok[:, None], msgs, torch.zeros_like(msgs))
    msgs = msgs * m[:, None]
    ids = _park(receivers, n, m)
    return _moments_plain(msgs, ids, n, moments, x.dtype)


# ---------------------------------------------------------------------------
# kernel launch (CUDA tensors only)
# ---------------------------------------------------------------------------

def route1_takes(f, gather):
    """Whether route 1 takes width ``f`` at all: in scatter mode ``f``
    even (a float2 a lane), in gather mode a multiple of 4 (a float4 a
    lane); a forced route 1 elsewhere is refused."""
    return f > 0 and f % (4 if gather else 2) == 0


def fwd_route(f, gather):
    """The poly kernel's route at width ``f``: 1 at the widths
    :func:`route1_takes` up to 128 in scatter mode and up to 64 in gather
    mode (PNA's, SAGE's and MFC's 64 among them); 2 (the first design, one
    warp per row) elsewhere: odd ``f`` (gathering, ``f`` not a multiple of
    4) and past those widths, where route 2 measured faster (the scatter
    at 256, the gather at 128, whose window holds fewer rows).  Mirrors
    ``hg_poly_segment_route``; a card test holds the two together."""
    return 1 if route1_takes(f, gather) and f <= (64 if gather else 128) \
        else 2


# route 1 of the scatter mode (csrc/poly_mp.cu ``r1::``): edge rows in
# flight a warp
POLY_ROWS_IN_FLIGHT = 8


def scatter_route1_walk(row_ptr, n_warps):
    """Route 1's plan of the scatter mode over a CSR schedule, as the
    card's ``n_warps`` warps walk it: warp ``w`` owns the rows ``[b[w],
    b[w + 1])`` of :func:`~hydragnn_torch.ops.aggregate.row_shares` (rows
    plus edges balanced, no row split) and walks their edges in order, in
    groups of at most 8 whose rows are loaded before any is added, across
    row boundaries; a row's moments are written when the walk passes its
    end, the share's rows past its last edge as empty rows.  Returns
    ``(bounds, groups)``: ``groups[w]`` the ``(begin, end)`` edge ranges of
    warp ``w`` in walking order."""
    from hydragnn_torch.ops.aggregate import row_shares

    bounds = row_shares(row_ptr, n_warps)
    ptr = row_ptr.long().cpu()
    groups = []
    for w in range(n_warps):
        p0, p1 = int(ptr[int(bounds[w])]), int(ptr[int(bounds[w + 1])])
        groups.append([(q, min(q + POLY_ROWS_IN_FLIGHT, p1))
                       for q in range(p0, p1, POLY_ROWS_IN_FLIGHT)])
    return bounds, groups


# route 1 of the gather mode (csrc/poly_mp.cu ``pg::``): warps a block,
# receiver rows a block owns at most, the bytes of x's node window and
# the rows it reaches either side of the block's own
GATHER_WARPS = 32
GATHER_ROWS_PER_BLOCK = 128
GATHER_X_BYTES = 96 * 1024
GATHER_REACH = 127


def gather_window_rows(f, stage_rows=0):
    """The rows of x that gather route 1's window holds at width ``f``
    (``stage_rows`` > 0: at most that many, as the checks ask).  Mirrors
    ``hg_poly_gather_window``."""
    cap = GATHER_X_BYTES // (4 * f)
    return stage_rows if 0 < stage_rows < cap else cap


def gather_window(r0, r1, n_src, win):
    """The rows of x that block rows ``[r0, r1)`` stage in a window of
    ``win`` rows: ``(lo, n_st)``, the block's rows with an equal reach
    either side (``GATHER_REACH`` at most: a sender of a collated batch
    lies in its receiver's graph of at most 128 nodes) inside ``[0,
    n_src)``.  Mirrors the kernel's ``window_of``."""
    nr = r1 - r0
    reach = min((win - nr) // 2, GATHER_REACH) if win > nr else 0
    a = max(r0 - reach, 0)
    b = min(max(r1 + reach, a), n_src, a + win)
    return a, b - a


def gather_route1_plan(row_ptr, senders, n_src, n_blocks, f, stage_rows=0,
                       n_warps=GATHER_WARPS):
    """Route 1's plan of the gather mode, as the card's ``n_blocks``
    blocks of ``n_warps`` warps run it, each half-warp a walker.

    Block ``k`` owns the receiver rows ``[r0, r1) = [n k // n_blocks, n (k
    + 1) // n_blocks)`` and their edges ``[p0, p1) = [row_ptr[r0],
    row_ptr[r1])``; it stages read codes for the first 4096 of them
    (the walk codes the rest itself), and x's rows ``[lo, lo + n_st)``
    (:func:`gather_window` with ``gather_window_rows(f, stage_rows)``
    rows) by one bulk copy issued before anything else.  Walker ``w`` of
    its ``2 n_warps`` half-warps walks an equal count of the block's rows,
    ``[r0 + nr w // (2 n_warps), r0 + nr (w + 1) // (2 n_warps))``, in
    edge order, a float4 a lane.  An edge reads its sender's row
    from the window (``"staged"``), from global memory when it lies
    outside it (``"global"``), or sends zero when its sender lies outside
    ``[0, n_src)`` (``"dead"``).  Returns one dict a block: ``rows``,
    ``edges``, ``span`` (the live senders' least and greatest, None
    without one), ``staged`` (the window's rows), ``walkers`` (each
    half-warp's
    rows) and ``reads`` (edge -> how it reads its sender)."""
    ptr = [int(v) for v in row_ptr.long().cpu()]
    send = [int(v) for v in senders.long().cpu()]
    n = len(ptr) - 1
    win = gather_window_rows(f, stage_rows)
    blocks = []
    for k in range(n_blocks):
        r0, r1 = n * k // n_blocks, n * (k + 1) // n_blocks
        p0, p1 = ptr[r0], ptr[r1]
        live = [send[e] for e in range(p0, p1) if 0 <= send[e] < n_src]
        span = (min(live), max(live)) if live else None
        lo, n_st = gather_window(r0, r1, n_src, win)
        reads = {}
        for e in range(p0, p1):
            s = send[e]
            reads[e] = ("dead" if not 0 <= s < n_src else
                        "staged" if 0 <= s - lo < n_st else "global")
        nr = r1 - r0
        blocks.append({
            "rows": (r0, r1), "edges": (p0, p1), "span": span,
            "staged": (lo, lo + n_st),
            "walkers": [(r0 + nr * w // (2 * n_warps),
                         r0 + nr * (w + 1) // (2 * n_warps))
                        for w in range(2 * n_warps)],
            "reads": reads})
    return blocks


def gather_route1_moments(x, senders, mask, row_ptr, moments, n_blocks,
                          stage_rows=0, n_warps=GATHER_WARPS):
    """The gather mode's moments as route 1 computes them from
    :func:`gather_route1_plan`: each walker's rows in edge order, ``v =
    x[s] * mask[e]`` (one float32 product; zero from a dead sender) read
    from the window or from x, ``s += v``, ``q += v * v``, max and min
    selected; the count from ``row_ptr``.  For the tests: the card's
    kernel cannot run here.  Returns float32 tensors in the order of
    ``moments``."""
    moments = _norm_moments(moments)
    n, f = x.shape
    x32 = x.float()
    m32 = mask.float()
    ptr = [int(v) for v in row_ptr.long().cpu()]
    out = {"sum": torch.full((n, f), float("nan")),
           "sq": torch.full((n, f), float("nan")),
           "mxmn": torch.full((n, 2 * f), float("nan")),
           "cnt": torch.full((n,), float("nan"))}
    plan = gather_route1_plan(row_ptr, senders, n, n_blocks, f, stage_rows,
                              n_warps)
    for blk in plan:
        lo, hi = blk["staged"]
        window = x32[lo:hi]
        for ra, rb in blk["walkers"]:
            for r in range(ra, rb):
                s = torch.zeros(f)
                q = torch.zeros(f)
                mx = torch.full((2 * f,), _NEG)
                for e in range(ptr[r], ptr[r + 1]):
                    how = blk["reads"][e]
                    if how == "dead":
                        v = torch.zeros(f)
                    else:
                        src = int(senders[e])
                        row = (window[src - lo] if how == "staged"
                               else x32[src])
                        v = row * m32[e]
                    s = s + v
                    q = q + v * v
                    mx = torch.maximum(mx, torch.cat([v, -v]))
                out["sum"][r], out["sq"][r], out["mxmn"][r] = s, q, mx
                out["cnt"][r] = float(ptr[r + 1] - ptr[r])
    return tuple(out[m] for m in moments)


def launch_poly_segment(src, senders, mask, row_ptr, num_segments, moments,
                        op, route=0, stage_rows=0):
    """Launch the poly kernel on a precomputed CSR schedule (``row_ptr``
    from :func:`segment_offsets`).  Scatter mode (``senders is None``):
    ``src`` is data [E, F].  Gather mode: ``src`` is x [N, F] with
    ``senders`` [E] int32 and ``mask`` [E] float32.  ``route``: 0 takes
    the width's own (:func:`fwd_route`), 1 or 2 asks for that one (the
    card checks time the first design beside route 1).  ``stage_rows`` >
    0 (gather route 1, the checks) caps the rows of x staged, so that
    senders fall outside the window.  Returns new float32 tensors in the
    order of ``moments``."""
    from hydragnn_torch.kernels.build import load_library

    dev = src.device
    if src.ndim != 2:
        raise ValueError(f"{op}: expected a 2-D tensor, got {src.ndim}-D")
    rows, f = src.shape
    n = num_segments
    fused_mp._require(src, "data" if senders is None else "x", torch.float32,
                      (rows, f), dev)
    fused_mp._require(row_ptr, "row_ptr", torch.int32, (n + 1,), dev)
    n_src = rows
    if senders is not None:
        e = senders.shape[0]
        fused_mp._require(senders, "senders", torch.int32, (e,), dev)
        fused_mp._require(mask, "mask", torch.float32, (e,), dev)
        rows = e
    if rows >= 2**31 or n >= 2**31:
        raise ValueError("the kernel indexes rows and segments with int32")
    gather = senders is not None
    if route not in (0, 1, 2) or (route == 1
                                  and not route1_takes(f, gather)):
        raise ValueError(f"{op} takes route 0, 2, or 1 at an even width; "
                         f"got {route} at F={f}")
    if stage_rows < 0 or (stage_rows and not (
            gather and (route or fwd_route(f, gather)) == 1)):
        raise ValueError(f"{op}: staged rows are gather route 1's; got "
                         f"{stage_rows}")
    outs = {}
    for m in moments:
        shape = {"sum": (n, f), "sq": (n, f), "mxmn": (n, 2 * f),
                 "cnt": (n,)}[m]
        outs[m] = torch.empty(shape, dtype=torch.float32, device=dev)
    if f == 0:
        raise ValueError(f"{op}: the feature width must be positive")
    if n == 0:
        return tuple(outs[m] for m in moments)

    def ptr(name):
        return outs[name].data_ptr() if name in outs else None

    src = fused_mp._aligned(src)   # route 1 reads float2s
    lib = load_library("poly_mp")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hg_poly_segment_f32(
            src.data_ptr(),
            None if senders is None else senders.data_ptr(),
            None if mask is None else mask.data_ptr(),
            row_ptr.data_ptr(), ptr("sum"), ptr("sq"), ptr("mxmn"),
            ptr("cnt"), n, n_src, f, int(gather), route, stage_rows,
            stream)
    fused_mp._check_rc(rc, op)
    LAUNCHES[op] += 1
    return tuple(outs[m] for m in moments)


# ---------------------------------------------------------------------------
# autograd Functions (the reference's custom VJPs)
# ---------------------------------------------------------------------------

def _mxmn_term(both, ok, safe, ids, mxmn, g_mxmn, n, f):
    """d mxmn / d v: ``+- tie * g / n_ties`` with the even tie split; the
    tie counts for max and min ride one sorted segment sum of width 2F."""
    tie = (both == mxmn.float()[safe]) & ok[:, None]
    n_tie = fused_mp.segment_sum_dense(tie.to(torch.float32), ids, n)
    zero = torch.zeros((), dtype=torch.float32, device=both.device)
    gmx = torch.where(ok[:, None], g_mxmn.float()[safe], zero)
    term = torch.where(tie, gmx / n_tie[safe].clamp(min=1.0), zero)
    return term[:, :f] - term[:, f:]


class _SegmentPolyDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, sorted_ids, num_segments, moments, valid):
        ids = _park(sorted_ids, num_segments, valid)
        if not data.is_cuda:
            outs = _moments_plain(data.float(), ids, num_segments,
                                  moments, data.dtype)
        else:
            row_ptr = segment_offsets(ids, num_segments)
            outs = launch_poly_segment(data, None, None, row_ptr,
                                       num_segments, moments,
                                       "segment_poly_dense")
            outs = tuple(o if m == "cnt" else o.to(data.dtype)
                         for m, o in zip(moments, outs))
        mxmn = outs[moments.index("mxmn")] if "mxmn" in moments else None
        ctx.save_for_backward(data, ids, mxmn)
        ctx.num_segments = num_segments
        ctx.moments = moments
        if "cnt" in moments:
            ctx.mark_non_differentiable(outs[moments.index("cnt")])
        return outs

    @staticmethod
    def backward(ctx, *g):
        data, ids, mxmn = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        n, f = ctx.num_segments, data.shape[1]
        ok = (ids >= 0) & (ids < n)
        safe = ids.clamp(0, max(n - 1, 0)).long()
        zero = torch.zeros((), dtype=torch.float32, device=data.device)
        d = torch.zeros(data.shape, dtype=torch.float32, device=data.device)
        for m, gm in zip(ctx.moments, g):
            if m == "sum":
                d = d + torch.where(ok[:, None], gm.float()[safe], zero)
            elif m == "sq":
                d = d + 2.0 * data.float() * torch.where(
                    ok[:, None], gm.float()[safe], zero)
            elif m == "mxmn":
                both = torch.cat([data, -data], dim=1).float()
                d = d + _mxmn_term(both, ok, safe, ids, mxmn, gm, n, f)
            # cnt: no data gradient
        return d.to(data.dtype), None, None, None, None


class _GatherPolySegment(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, senders, receivers, sender_perm, moments, mask):
        n = x.shape[0]
        if not x.is_cuda:
            outs = gather_poly_segment_plain(x, senders, receivers,
                                             moments, mask)
        else:
            m = (torch.ones(senders.shape[0], dtype=torch.float32,
                            device=x.device) if mask is None else mask)
            row_ptr = segment_offsets(receivers, n, m)
            outs = launch_poly_segment(x, senders, m, row_ptr, n, moments,
                                       "gather_poly_segment")
            outs = tuple(o if k == "cnt" else o.to(x.dtype)
                         for k, o in zip(moments, outs))
        mxmn = outs[moments.index("mxmn")] if "mxmn" in moments else None
        ctx.save_for_backward(x, senders, receivers, sender_perm, mask, mxmn)
        ctx.moments = moments
        if "cnt" in moments:
            ctx.mark_non_differentiable(outs[moments.index("cnt")])
        return outs

    @staticmethod
    def backward(ctx, *g):
        x, senders, receivers, sender_perm, mask, mxmn = ctx.saved_tensors
        none = (None,) * 6
        if not ctx.needs_input_grad[0]:
            return none
        moments = ctx.moments
        n, f = x.shape
        moms = dict(zip(moments, g))
        need_msgs = ("sq" in moments) or ("mxmn" in moments)
        if not need_msgs and "sum" not in moms:
            return (torch.zeros_like(x),) + none[1:]  # cnt-only
        m = (torch.ones(senders.shape[0], dtype=torch.float32,
                        device=x.device) if mask is None else mask.float())
        if not need_msgs:
            # sum-only (cnt has no x-grad): dx[n] = sum_{e: send=n} m_e
            # g_sum[recv_e] — the no-w gather's backward (the fused launch,
            # or under create_graph the no-w Function on the sender-sorted
            # ordering), no [E, F] intermediate
            dx = fused_mp.gather_sum_dx(moms["sum"], senders, receivers,
                                        sender_perm, m)
            return (dx.to(x.dtype),) + none[1:]

        # sq/mxmn need the messages: recompute the gather
        sl, rl = senders.long(), receivers.long()
        msgs = x[sl].float() * m[:, None]
        c = torch.zeros_like(msgs)                       # dL/dmsgs
        if "sum" in moments:
            c = c + moms["sum"].float()[rl]
        if "sq" in moments:
            c = c + 2.0 * msgs * moms["sq"].float()[rl]
        if "mxmn" in moments:
            ok = m != 0
            ids = _park(receivers, n, m)
            safe = ids.clamp(0, max(n - 1, 0)).long()
            both = torch.cat([msgs, -msgs], dim=1)
            c = c + _mxmn_term(both, ok, safe, ids, mxmn, moms["mxmn"], n, f)
        # dmsgs/dx[send] = m; sum at senders over the sorted permutation
        c = c * m[:, None]
        p = fused_mp._sender_order(senders, sender_perm)
        dx = fused_mp.segment_sum_dense(c[p], senders[p], n, valid=m[p])
        return (dx.to(x.dtype),) + none[1:]


# ---------------------------------------------------------------------------
# public ops (the reference's names and signatures)
# ---------------------------------------------------------------------------

def segment_poly_dense(data, sorted_ids, num_segments, moments, valid=None):
    """Multi-moment segment reduce of edge-valued ``data`` [E, F] at
    nondecreasing ``sorted_ids``: a tuple in kernel-moment order (the
    requested subset of ``MOMENT_ORDER``).  ``valid`` (1 = real) parks
    masked rows, which must sort last, out of range; they and out-of-range
    rows get zero gradients.  Differentiable wrt ``data``; the max/min
    gradient splits evenly among ties."""
    moments = _norm_moments(moments)
    if data.ndim != 2:
        raise ValueError(f"data must be [E, F], got {tuple(data.shape)}")
    return _SegmentPolyDense.apply(data, sorted_ids, num_segments, moments,
                                   valid)


def gather_poly_segment(x, senders, receivers, sender_perm, moments,
                        mask=None):
    """Multi-moment reduce of the gathered messages ``x[senders] * mask``
    at nondecreasing ``receivers`` without an ``[E, F]`` message tensor
    (collate's invariants: masked edges zero-masked and tail-sorted in both
    edge orderings).  Same tuple layout as :func:`segment_poly_dense`.
    ``sender_perm`` is collate's stable sender argsort (the backward sums
    dx at senders through it; ``None`` computes it).  Differentiable wrt
    ``x``."""
    moments = _norm_moments(moments)
    return _GatherPolySegment.apply(x, senders, receivers, sender_perm,
                                    moments, mask)
