"""Segment (scatter/gather) ops — the message-passing primitives.

Port of hydragnn_tpu/graph/segment.py (the sum/mean/max/min/std/count
family, the kernel dispatch points, the multi-moment dispatchers, the
dense-backward gathers and the pools; the segment softmax and
``gather_perm`` come with GAT and DimeNet).  Message passing is a gather
(``x[senders]``) plus a segment reduce at ``receivers``; every op takes an
optional mask (1.0 = valid) so padded rows contribute nothing.

The dispatch points are the reference's: ``gather_mul_segment``,
``gather_segment``, ``sorted_segment_sum``, ``scatter_segment`` and
``masked_mean_pool`` route to the kernels of ops/fused_mp.py, and
``poly_scatter_segment`` / ``poly_gather_segment`` to those of
ops/poly_mp.py, when the batch carries collate's ``edge_perm_sender``
marker (or the caller vouches for sorted ids), and to plain PyTorch
otherwise.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

_BIG = 1e9


def _bcast(mask, data):
    return mask.reshape(mask.shape + (1,) * (data.ndim - mask.ndim)).to(
        data.dtype)


def _count(op: str, fused: bool) -> None:
    from hydragnn_torch.telemetry import pipeline

    pipeline.count_fused_choice(op, fused)


def _has_marker(g) -> bool:
    return bool(g.extras and "edge_perm_sender" in g.extras)


def segment_sum(data, segment_ids, num_segments, mask=None):
    """Masked segment sum under the ``HYDRAGNN_AGGR_BACKEND`` backend
    (``fused`` uses the plain path here, as in the reference)."""
    if mask is not None:
        data = data * _bcast(mask, data)
    from hydragnn_torch.ops.aggregate import (
        aggr_backend,
        segment_sum_onehot,
        segment_sum_pallas,
    )

    backend = aggr_backend()
    if backend == "onehot" and data.is_floating_point():
        return segment_sum_onehot(data, segment_ids, num_segments)
    if backend == "pallas" and data.is_floating_point():
        return segment_sum_pallas(data, segment_ids, num_segments)
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def gather_mul_segment(x, w, g):
    """``out[n] = sum_{e: recv[e]=n} x[send[e]] * w[e]`` over real edges:
    the fused kernel when the batch carries the marker, else gather +
    masked segment_sum."""
    perm = g.extras.get("edge_perm_sender") if g.extras else None
    _count("gather_mul", perm is not None)
    if perm is not None:
        from hydragnn_torch.ops.fused_mp import gather_mul_segment_sum

        w = w * _bcast(g.edge_mask, w)
        return gather_mul_segment_sum(x, w, g.senders, g.receivers, perm,
                                      edge_valid=g.edge_mask)
    return segment_sum(
        x[g.senders] * w, g.receivers, x.shape[0], g.edge_mask)


def gather_segment(x, g):
    """Plain neighbor sum ``out[n] = sum_{e: recv[e]=n} x[send[e]]`` over
    real edges (same dispatch rule as :func:`gather_mul_segment`)."""
    perm = g.extras.get("edge_perm_sender") if g.extras else None
    _count("gather_sum", perm is not None)
    if perm is not None:
        from hydragnn_torch.ops.fused_mp import gather_segment_sum

        return gather_segment_sum(
            x, g.senders, g.receivers, perm, g.edge_mask)
    return segment_sum(
        x[g.senders], g.receivers, x.shape[0], g.edge_mask)


def segment_count(segment_ids, num_segments, mask=None,
                  dtype=torch.float32):
    ones = torch.ones(segment_ids.shape[0], dtype=dtype,
                      device=segment_ids.device)
    if mask is not None:
        ones = ones * mask.to(dtype)
    out = torch.zeros(num_segments, dtype=dtype, device=segment_ids.device)
    return out.index_add_(0, segment_ids.long(), ones)


def _mean_divide(total, count):
    """The one definition of the empty-segment convention: mean uses
    max(count, 1) so empty segments read zero, not NaN."""
    return total / _bcast(torch.clamp(count, min=1.0), total)


def segment_mean(data, segment_ids, num_segments, mask=None):
    total = segment_sum(data, segment_ids, num_segments, mask)
    count = segment_count(segment_ids, num_segments, mask)
    return _mean_divide(total, count)


def _segment_amax(data, segment_ids, num_segments, fill):
    """Per-segment max with ``fill`` on empty segments; under autograd the
    gradient splits evenly among ties (``scatter_reduce``'s amax rule, the
    same as ``jax.ops.segment_max``'s VJP)."""
    idx = segment_ids.long().reshape(
        (-1,) + (1,) * (data.ndim - 1)).expand_as(data)
    base = torch.full((num_segments,) + tuple(data.shape[1:]), fill,
                      dtype=data.dtype, device=data.device)
    return base.scatter_reduce(0, idx, data, "amax", include_self=True)


def segment_max(data, segment_ids, num_segments, mask=None):
    """Max-reduce; empty/masked segments yield 0."""
    if mask is not None:
        data = torch.where(_bcast(mask, data) > 0, data,
                           torch.full_like(data, -_BIG))
    out = _segment_amax(data, segment_ids, num_segments, -_BIG)
    return torch.where(out <= -_BIG * 0.5, torch.zeros_like(out), out)


def segment_min(data, segment_ids, num_segments, mask=None):
    if mask is not None:
        data = torch.where(_bcast(mask, data) > 0, data,
                           torch.full_like(data, _BIG))
    out = -_segment_amax(-data, segment_ids, num_segments, -_BIG)
    return torch.where(out >= _BIG * 0.5, torch.zeros_like(out), out)


def segment_std(data, segment_ids, num_segments, mask=None, eps=1e-5):
    """Per-segment standard deviation (PNA 'std' aggregator numerics)."""
    mean = segment_mean(data, segment_ids, num_segments, mask)
    sq_mean = segment_mean(data * data, segment_ids, num_segments, mask)
    var = torch.clamp(sq_mean - mean * mean, min=0.0)
    return torch.sqrt(var + eps)


def degree(receivers, num_nodes, mask=None):
    """In-degree per node."""
    return segment_count(receivers, num_nodes, mask)


def sorted_segment_sum(data, segment_ids, num_segments, mask=None,
                       sorted_hint=False):
    """Masked segment sum on the sorted-segment kernel when the caller
    vouches (``sorted_hint``) that ``segment_ids`` are nondecreasing; else
    the masked segment_sum.  Masking happens before the dense sum —
    padding rows park on real slots."""
    _count("sorted_sum", bool(sorted_hint))
    if sorted_hint:
        from hydragnn_torch.ops.fused_mp import segment_sum_dense

        if mask is not None:
            data = data * _bcast(mask, data)
        return segment_sum_dense(data, segment_ids, num_segments,
                                 valid=mask)
    return segment_sum(data, segment_ids, num_segments, mask)


def scatter_segment(data, g):
    """Receiver-side masked segment sum of edge-valued ``data``: the
    sorted-segment kernel when the batch carries the marker, else the
    masked segment_sum.  Always edge-masked."""
    _count("scatter_sum", _has_marker(g))
    if _has_marker(g):
        from hydragnn_torch.ops.fused_mp import segment_sum_dense

        data = data * _bcast(g.edge_mask, data)
        return segment_sum_dense(data, g.receivers, g.num_nodes,
                                 valid=g.edge_mask)
    return segment_sum(data, g.receivers, g.num_nodes, g.edge_mask)


def masked_mean_pool(x, node_gid, num_graphs, node_mask, sorted_hint=False):
    """Per-graph mean over real nodes.  ``sorted_hint`` (set by
    ``Base.forward`` when the batch carries the marker) routes the sum
    through the sorted-segment kernel — collate's node_gid is
    nondecreasing.  Halo-sharded graphs wait for the parallel slice."""
    _count("mean_pool", bool(sorted_hint))
    if sorted_hint:
        from hydragnn_torch.ops.fused_mp import segment_sum_dense

        total = segment_sum_dense(
            x * _bcast(node_mask, x), node_gid, num_graphs)
        count = segment_count(node_gid, num_graphs, node_mask)
        return _mean_divide(total, count)
    total = segment_sum(x, node_gid, num_graphs, node_mask)
    count = segment_count(node_gid, num_graphs, node_mask)
    return _mean_divide(total, count)


def masked_sum_pool(x, node_gid, num_graphs, node_mask):
    return segment_sum(x, node_gid, num_graphs, node_mask)


# ---------------------------------------------------------------------------
# multi-moment (poly) aggregation: sum/sq-derived mean+std, max, min, count
# in one kernel pass (ops/poly_mp.py) when the batch carries the marker
# ---------------------------------------------------------------------------

def _poly_public_keys():
    """Public moment vocabulary, derived from the kernel's MOMENT_ORDER:
    the combined ``mxmn`` output splits into the ``mx``/``mn`` keys."""
    from hydragnn_torch.ops.poly_mp import MOMENT_ORDER

    keys = []
    for m in MOMENT_ORDER:
        keys.extend(("mx", "mn") if m == "mxmn" else (m,))
    return tuple(keys)


def _poly_kernel_moments(moments):
    from hydragnn_torch.ops.poly_mp import MOMENT_ORDER

    want = set(moments)
    unknown = want - set(_poly_public_keys())
    if unknown or not want:
        raise ValueError(f"moments must be a nonempty subset of "
                         f"{_poly_public_keys()}, got {moments!r}")
    return tuple(
        m for m in MOMENT_ORDER
        if m in want or (m == "mxmn" and ("mx" in want or "mn" in want)))


def _poly_unpack(kern_moments, outs, moments, f):
    """Kernel tuple -> {requested key: cleaned tensor}.  mx/mn get the
    empty-segment zero-clean of :func:`segment_max` / :func:`segment_min`,
    with the threshold taken from the kernel's own sentinel."""
    res: Dict[str, torch.Tensor] = {}
    by = dict(zip(kern_moments, outs))
    if "sum" in moments:
        res["sum"] = by["sum"]
    if "sq" in moments:
        res["sq"] = by["sq"]
    if "mx" in moments or "mn" in moments:
        from hydragnn_torch.ops.poly_mp import _NEG

        mxmn = by["mxmn"]
        if "mx" in moments:
            mx = mxmn[:, :f]
            res["mx"] = torch.where(mx <= _NEG * 0.5, torch.zeros_like(mx),
                                    mx)
        if "mn" in moments:
            neg = mxmn[:, f:]
            res["mn"] = torch.where(neg <= _NEG * 0.5, torch.zeros_like(neg),
                                    -neg)
    if "cnt" in moments:
        res["cnt"] = by["cnt"]
    return res


def _poly_composed(moments, g, data_fn, sum_fn):
    """Composed path shared by both poly dispatchers: ``data_fn`` yields the
    edge-valued messages (only when a beyond-sum moment needs them),
    ``sum_fn`` the masked segment sum of the raw inputs (which may still
    take a sum kernel when only the poly width gate failed)."""
    res: Dict[str, torch.Tensor] = {}
    if "sum" in moments:
        res["sum"] = sum_fn()
    data = (data_fn() if ("sq" in moments or "mx" in moments
                          or "mn" in moments) else None)
    n = g.num_nodes
    if "sq" in moments:
        res["sq"] = scatter_segment(data * data, g)
    if "mx" in moments or "mn" in moments:
        f = data.shape[-1]
        mxmn = segment_max(torch.cat([data, -data], dim=-1), g.receivers, n,
                           g.edge_mask)
        if "mx" in moments:
            res["mx"] = mxmn[:, :f]
        if "mn" in moments:
            res["mn"] = -mxmn[:, f:]
    if "cnt" in moments:
        res["cnt"] = degree(g.receivers, n, g.edge_mask)
    return res


def _poly_fused_ok(g, f: int, moments) -> bool:
    from hydragnn_torch.ops.poly_mp import POLY_MAX_F, POLY_MAX_F_MXMN

    if not _has_marker(g):
        return False
    limit = (POLY_MAX_F_MXMN if ("mx" in moments or "mn" in moments)
             else POLY_MAX_F)
    return f <= limit


def poly_scatter_segment(data, g, moments: Sequence[str]):
    """Multi-moment masked segment reduce of edge-valued ``data`` [E, F] at
    receivers: a dict with the requested subset of ``sum`` [N, F], ``sq``
    [N, F], ``mx``/``mn`` [N, F] (over real edges, 0 on empty nodes) and
    ``cnt`` [N] (== :func:`degree`).  One kernel pass when the batch
    carries the marker and F fits the width gate, composed segment ops
    otherwise; a pure sum goes to :func:`scatter_segment`."""
    kern = _poly_kernel_moments(moments)
    if kern == ("sum",):
        return {"sum": scatter_segment(data, g)}
    f = data.shape[-1]
    fused = _poly_fused_ok(g, f, moments)
    _count("poly_scatter", fused)
    if fused:
        from hydragnn_torch.ops.poly_mp import segment_poly_dense

        # data is NOT premasked: masked rows are excluded by the schedule
        outs = segment_poly_dense(data, g.receivers, g.num_nodes, kern,
                                  valid=g.edge_mask)
        return _poly_unpack(kern, outs, moments, f)
    return _poly_composed(moments, g, lambda: data,
                          lambda: scatter_segment(data, g))


def poly_gather_segment(x, g, moments: Sequence[str]):
    """Multi-moment reduce of the gathered neighbour messages
    ``x[senders]`` over real edges — same result dict as
    :func:`poly_scatter_segment`; the kernel path never forms the ``[E, F]``
    tensor.  A pure sum goes to :func:`gather_segment`."""
    kern = _poly_kernel_moments(moments)
    if kern == ("sum",):
        return {"sum": gather_segment(x, g)}
    f = x.shape[-1]
    perm = g.extras.get("edge_perm_sender") if g.extras else None
    fused = perm is not None and _poly_fused_ok(g, f, moments)
    _count("poly_gather", fused)
    if fused:
        from hydragnn_torch.ops.poly_mp import gather_poly_segment

        outs = gather_poly_segment(x, g.senders, g.receivers, perm, kern,
                                   mask=g.edge_mask)
        return _poly_unpack(kern, outs, moments, f)
    return _poly_composed(moments, g, lambda: x[g.senders.long()],
                          lambda: gather_segment(x, g))


# ---------------------------------------------------------------------------
# gathers whose backward is the sorted-segment kernel
# ---------------------------------------------------------------------------

class _GatherDenseBwd(torch.autograd.Function):
    """``x[idx]`` whose backward is ``segment_sum_dense`` over the sorted
    ``idx`` (through ``perm`` when ``idx`` itself is not sorted).

    Zero-cotangent requirement, the reference's: padding rows of ``idx``
    park on a real slot (node N-1), and every caller must make the
    cotangent exactly zero on them — the gathered value is multiplied by
    the edge mask, or enters a masked reduce, before any loss.  The
    backward leaves those rows out of the sum (``valid``, the edge mask;
    they sort last in both orderings): the same result, without one warp
    walking every padding row of the batch for node N-1."""

    @staticmethod
    def forward(ctx, x, idx, perm, valid):
        ctx.save_for_backward(idx, perm, valid)
        ctx.shape = x.shape
        return x[idx.long()]

    @staticmethod
    def backward(ctx, grad):
        from hydragnn_torch.ops.fused_mp import segment_sum_dense

        idx, perm, valid = ctx.saved_tensors
        g2 = grad.reshape(grad.shape[0], -1)
        if perm is not None:
            p = perm.long()
            g2, idx, valid = g2[p], idx[p], valid[p]
        out = segment_sum_dense(g2.contiguous(), idx, ctx.shape[0],
                                valid=valid)
        return out.reshape(ctx.shape), None, None, None


def gather_receiver_sorted(x, g):
    """``x[receivers]`` whose backward is the sorted-segment kernel
    (receivers are nondecreasing by collate's invariant) — with the marker;
    a plain gather otherwise."""
    if _has_marker(g):
        return _GatherDenseBwd.apply(x, g.receivers, None, g.edge_mask)
    return x[g.receivers.long()]


def gather_sender(x, g):
    """``x[senders]`` whose backward is the sorted-segment kernel through
    collate's sender-sorted permutation — with the marker."""
    perm = g.extras.get("edge_perm_sender") if g.extras else None
    if perm is not None:
        return _GatherDenseBwd.apply(x, g.senders, perm, g.edge_mask)
    return x[g.senders.long()]
