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

def launch_poly_segment(src, senders, mask, row_ptr, num_segments, moments,
                        op):
    """Launch the poly kernel on a precomputed CSR schedule (``row_ptr``
    from :func:`segment_offsets`).  Scatter mode (``senders is None``):
    ``src`` is data [E, F].  Gather mode: ``src`` is x [N, F] with
    ``senders`` [E] int32 and ``mask`` [E] float32.  Returns new float32
    tensors in the order of ``moments``."""
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

    lib = load_library("poly_mp")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hg_poly_segment_f32(
            src.data_ptr(),
            None if senders is None else senders.data_ptr(),
            None if mask is None else mask.data_ptr(),
            row_ptr.data_ptr(), ptr("sum"), ptr("sq"), ptr("mxmn"),
            ptr("cnt"), n, n_src, f, 0 if senders is None else 1, stream)
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
