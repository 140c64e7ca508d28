"""Fused message-passing reductions: wrappers, plain versions, launch counts.

Port of hydragnn_tpu/ops/fused_mp.py.  Two kernels, hand-written in CUDA
C++ for Hopper (csrc/fused_mp.cu, built by kernels/build.py):

- ``gather_mul_segment_sum`` (and its no-``w`` mode ``gather_segment_sum``):
  ``out[n] = sum_{e: recv[e]=n} x[send[e]] * w[e]`` in one pass, with no
  ``[E, F]`` message tensor in memory — SchNet's CFConv aggregation.
- ``segment_sum_dense``: sorted-id segment sum — the masked mean pool.

Both keep the reference contract: ids (receivers / node_gid) are
nondecreasing, masked rows (``edge_valid``/``valid`` == 0) sort last and
contribute nothing, out-of-range ids contribute nothing, every output row
is written (empty segments read 0), accumulation is float32 in a fixed
order (no atomics).  The TPU kernel's +-1 block sender window drops
out-of-window senders; collate attaches the marker only when every graph
fits one node block, so all real senders are in the window and the card's
global indexing gives the same answer.

Each public op is a ``torch.autograd.Function`` with the reference's
custom VJP (hydragnn_tpu/ops/fused_mp.py ``_vjp_bwd``, ``_gss_bwd``,
``_ssd_bwd``):

- ``gather_mul_segment_sum``: ``dw = x[send] * g[recv]`` by plain
  indexing (garbage on masked edges, as in the reference: the caller's
  ``w`` premask kills it); ``dx`` reruns the same kernel on the
  sender-sorted ordering (``sender_perm``) with the roles swapped —
  ``dx[n] = sum_{e: send[e]=n} g[recv[e]] * w[e]`` — through the same
  autograd Function, so the backward is itself differentiable: a double
  backward (``create_graph=True``) on the card gives the CPU's answer.
- ``gather_segment_sum``: ``dx`` the same way, in the no-``w`` mode.
- ``segment_sum_dense``: its backward is a plain gather that zeroes
  out-of-range (and masked) ids (differentiable).

At the leaves, a CPU tensor takes the kernel's plain PyTorch version
below (the CPU path and the tests' oracle) and a CUDA tensor the kernel;
a CUDA input the kernel does not take raises — there is no fallback.

``LAUNCHES`` counts kernel launches per op (incremented only where the
kernel is launched), the backward's dx passes under their own
``*_dx`` keys, so a run can show that its main path went through the
kernels, forward and backward apart.
"""

from __future__ import annotations

from typing import Dict

import torch

from hydragnn_torch.ops.aggregate import segment_offsets

LAUNCHES: Dict[str, int] = {
    "gather_mul_segment_sum": 0,
    "gather_mul_segment_sum_dx": 0,
    "gather_segment_sum": 0,
    "gather_segment_sum_dx": 0,
    "segment_sum_dense": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (index_add_ + gathers)
# ---------------------------------------------------------------------------

def gather_mul_segment_sum_plain(x, w, senders, receivers, edge_valid=None,
                                 mask=None):
    """``out[n] = sum_{e: recv[e]=n, valid} x[send[e]] * (w[e] or mask[e])``
    in float32, cast to ``x``'s type.  Edges with ``edge_valid == 0`` or an
    id outside ``[0, N)`` contribute nothing."""
    n, f = x.shape
    ok = (senders >= 0) & (senders < n) & (receivers >= 0) & (receivers < n)
    if edge_valid is not None:
        ok = ok & (edge_valid != 0)
    src = x[senders.clamp(0, n - 1).long()].float()
    if w is not None:
        msgs = src * w.float()
    elif mask is not None:
        msgs = src * mask.float()[:, None]
    else:
        msgs = src
    msgs = torch.where(ok[:, None], msgs, torch.zeros_like(msgs))
    out = torch.zeros((n, f), dtype=torch.float32, device=x.device)
    out.index_add_(0, receivers.clamp(0, n - 1).long(), msgs)
    return out.to(x.dtype)


def segment_sum_dense_plain(data, sorted_ids, num_segments, valid=None,
                            max_per_segment=None):
    """Segment sum over ``sorted_ids`` in float32, cast to ``data``'s type;
    rows with ``valid == 0`` or an id outside ``[0, num_segments)``
    contribute nothing, and with ``max_per_segment`` neither do the rows
    of a segment past its first ``max_per_segment``.  Only the cap needs
    the ids sorted, so this is also the plain version of both ``pallas``
    backend segment sums (ops/aggregate.py)."""
    shape = data.shape
    d2 = data.reshape(shape[0], -1).float()
    ok = (sorted_ids >= 0) & (sorted_ids < num_segments)
    if valid is not None:
        ok = ok & (valid != 0)
    if max_per_segment is not None:
        first = segment_offsets(sorted_ids, num_segments)[
            sorted_ids.clamp(0, num_segments).long()]
        rank = torch.arange(shape[0], device=data.device)
        ok = ok & (rank - first < max_per_segment)
    d2 = torch.where(ok[:, None], d2, torch.zeros_like(d2))
    out = torch.zeros((num_segments, d2.shape[1]), dtype=torch.float32,
                      device=data.device)
    out.index_add_(0, sorted_ids.clamp(0, max(num_segments - 1, 0)).long(),
                   d2)
    return out.to(data.dtype).reshape((num_segments,) + tuple(shape[1:]))


# ---------------------------------------------------------------------------
# kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------

def _require(t, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(
            f"{name} must be {dtype} for the CUDA kernel, got {t.dtype} "
            "(bf16 comes with mixed precision, ROADMAP queue A5)")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _aligned(t):
    """``t``, or a copy of it on a 16-byte boundary: the kernels' cp.async
    row copies need it (a view may start anywhere)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed, cudaError_t {rc}")


def launch_gather_mul(x, w, mask, senders, row_ptr, op="gather_mul_segment_sum"):
    """Launch the gather-multiply kernel on a precomputed CSR schedule
    (``row_ptr`` from :func:`segment_offsets`).  ``w`` [E,F] or, in the
    no-w mode, ``mask`` [E].  Returns a new float32 [N,F] tensor."""
    from hydragnn_torch.kernels.build import load_library

    dev = x.device
    n, f = x.shape
    e = senders.shape[0]
    _require(x, "x", torch.float32, (n, f), dev)
    if w is not None:
        _require(w, "w", torch.float32, (e, f), dev)
    else:
        _require(mask, "mask", torch.float32, (e,), dev)
    _require(senders, "senders", torch.int32, (e,), dev)
    _require(row_ptr, "row_ptr", torch.int32, (n + 1,), dev)
    if e >= 2**31 or n >= 2**31:
        raise ValueError("the kernel indexes edges and rows with int32")
    out = torch.empty((n, f), dtype=torch.float32, device=dev)
    if n == 0 or f == 0:
        return out
    lib = load_library("fused_mp")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hg_gather_mul_segment_sum_f32(
            x.data_ptr(), None if w is None else w.data_ptr(),
            None if mask is None else mask.data_ptr(), senders.data_ptr(),
            row_ptr.data_ptr(), out.data_ptr(), n, n, f,
            1 if w is not None else 0, stream)
    _check_rc(rc, op)
    LAUNCHES[op] += 1
    return out


def launch_segment_sum_rows(data2d, row_ptr, num_segments,
                            op="segment_sum_dense", perm=None, max_rows=None,
                            launches=None):
    """Launch the CSR segment-sum kernel: segment ``s`` sums the data rows
    ``perm[r]`` (``r`` itself when ``perm`` is None) for the first at most
    ``max_rows`` ``r`` of ``[row_ptr[s], row_ptr[s+1])``.  Counts one launch
    under ``op`` in ``launches`` (this module's ``LAUNCHES`` unless given).
    Returns a new float32 [num_segments, F] tensor."""
    from hydragnn_torch.kernels.build import load_library

    dev = data2d.device
    r, f = data2d.shape
    _require(data2d, "data", torch.float32, (r, f), dev)
    if perm is not None:
        _require(perm, "perm", torch.int32, (r,), dev)
    _require(row_ptr, "row_ptr", torch.int32, (num_segments + 1,), dev)
    if r >= 2**31 or num_segments >= 2**31:
        raise ValueError("the kernel indexes rows and segments with int32")
    out = torch.empty((num_segments, f), dtype=torch.float32, device=dev)
    if num_segments == 0 or f == 0:
        return out
    lib = load_library("fused_mp")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hg_segment_sum_rows_f32(
            data2d.data_ptr(), None if perm is None else perm.data_ptr(),
            row_ptr.data_ptr(), out.data_ptr(), num_segments, f,
            2**31 - 1 if max_rows is None else min(int(max_rows), 2**31 - 1),
            stream)
    _check_rc(rc, op)
    (LAUNCHES if launches is None else launches)[op] += 1
    return out


# ---------------------------------------------------------------------------
# leaves: the kernel on a CUDA tensor, its plain version on a CPU tensor
# ---------------------------------------------------------------------------

def _gather_mul(x, w, mask, senders, receivers, edge_valid, op):
    """``out[n] = sum_{e: receivers[e]=n, valid} x[senders[e]] * (w[e] or
    mask[e])`` over nondecreasing ``receivers``."""
    if not x.is_cuda:
        return gather_mul_segment_sum_plain(
            x, w, senders, receivers, edge_valid=edge_valid, mask=mask)
    if w is None and mask is None:
        mask = torch.ones(senders.shape[0], dtype=torch.float32,
                          device=x.device)
    row_ptr = segment_offsets(receivers, x.shape[0], edge_valid)
    return launch_gather_mul(x, w, mask, senders, row_ptr, op=op)


def _sender_order(senders, sender_perm):
    if sender_perm is None:
        sender_perm = torch.argsort(senders, stable=True)
    return sender_perm.long()


def _reversed_schedule(senders, receivers, sender_perm):
    """The backward's roles swapped: ``(p, perm of the reversed call)``.
    ``p`` orders the edges by sender; the reversed call gathers at
    ``receivers[p]`` and sums at ``senders[p]``, so its own sender
    permutation is the stable argsort of ``receivers[p]``.  That one is
    needed only when the backward is itself differentiated (grad mode on
    in the backward: ``create_graph=True``), and is computed only then."""
    p = _sender_order(senders, sender_perm)
    rp = None
    if torch.is_grad_enabled():
        rp = torch.argsort(receivers[p], stable=True).to(torch.int32)
    return p, rp


class _GatherMulSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, senders, receivers, sender_perm, edge_valid, op):
        ctx.save_for_backward(x, w, senders, receivers, sender_perm,
                              edge_valid)
        return _gather_mul(x, w, None, senders, receivers, edge_valid, op)

    @staticmethod
    def backward(ctx, g):
        x, w, senders, receivers, sender_perm, edge_valid = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dw = (x[senders.long()] * g[receivers.long()]).to(w.dtype)
        if ctx.needs_input_grad[0]:
            # dx is the same linear op with the roles swapped, called
            # through this Function so that it is differentiable in turn
            p, rp = _reversed_schedule(senders, receivers, sender_perm)
            dx = _GatherMulSegmentSum.apply(
                g.float(), w[p].float(), receivers[p], senders[p], rp,
                None if edge_valid is None else edge_valid[p],
                "gather_mul_segment_sum_dx").to(x.dtype)
        return dx, dw, None, None, None, None, None


class _GatherSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, senders, receivers, sender_perm, mask, op):
        ctx.save_for_backward(senders, receivers, sender_perm, mask)
        return _gather_mul(x, None, mask, senders, receivers, mask, op)

    @staticmethod
    def backward(ctx, g):
        senders, receivers, sender_perm, mask = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None, None
        p, rp = _reversed_schedule(senders, receivers, sender_perm)
        dx = _GatherSegmentSum.apply(
            g.contiguous().float(), receivers[p], senders[p], rp,
            None if mask is None else mask[p], "gather_segment_sum_dx")
        return dx.to(g.dtype), None, None, None, None, None


class _SegmentSumDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, sorted_ids, num_segments, valid):
        ctx.num_segments = num_segments
        ctx.shape = data.shape
        parked = sorted_ids
        if valid is not None:
            parked = torch.where(valid != 0, sorted_ids.to(torch.int32),
                                 num_segments)
        ctx.save_for_backward(parked)
        if not data.is_cuda:
            return segment_sum_dense_plain(data, sorted_ids, num_segments,
                                           valid)
        row_ptr = segment_offsets(sorted_ids, num_segments, valid)
        out = launch_segment_sum_rows(
            data.reshape(data.shape[0], -1), row_ptr, num_segments)
        return out.reshape((num_segments,) + tuple(data.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        s = ctx.num_segments
        g2 = g.reshape(s, -1)
        ok = (ids >= 0) & (ids < s)
        d = g2[ids.clamp(0, s - 1).long()]
        d = torch.where(ok[:, None], d, torch.zeros_like(d))
        return d.reshape(ctx.shape), None, None, None


# ---------------------------------------------------------------------------
# public ops (the reference's names and signatures)
# ---------------------------------------------------------------------------

def gather_mul_segment_sum(x, w, senders, receivers, sender_perm, window=3,
                           edge_valid=None):
    """``out[n, f] = sum_{e: recv[e]=n} x[send[e], f] * w[e, f]``.

    Requires nondecreasing ``receivers`` and pre-masked ``w``; with
    ``edge_valid`` the schedule skips masked edges, which must sort last
    in both edge orderings.  ``sender_perm`` (collate's stable argsort of
    ``senders``) orders the backward's dx pass; ``window`` (odd) is kept
    for the signature.  Differentiable wrt ``x`` and ``w``; ``dw`` on
    masked edges is garbage by contract."""
    if window % 2 != 1:
        raise ValueError("window must be odd")
    return _GatherMulSegmentSum.apply(x, w, senders, receivers, sender_perm,
                                      edge_valid, "gather_mul_segment_sum")


def gather_segment_sum(x, senders, receivers, sender_perm, mask=None):
    """``out[n] = sum_{e: recv[e]=n} mask[e] * x[send[e]]`` — the no-``w``
    mode of the same kernel; ``mask == 0`` edges are skipped (they must
    sort last).  Differentiable wrt ``x``."""
    return _GatherSegmentSum.apply(x, senders, receivers, sender_perm, mask,
                                   "gather_segment_sum")


def segment_sum_dense(data, sorted_ids, num_segments, valid=None):
    """Exact segment sum over nondecreasing ``sorted_ids``; out-of-range
    ids and ``valid == 0`` rows (which must sort last) contribute
    nothing.  Differentiable wrt ``data``."""
    return _SegmentSumDense.apply(data, sorted_ids, num_segments, valid)
