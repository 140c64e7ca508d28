"""Aggregation backends and the sorted-segment schedule.

Port of hydragnn_tpu/ops/aggregate.py.  ``HYDRAGNN_AGGR_BACKEND`` selects
how message passing aggregates, read the same way as the reference:

- ``scatter`` (default): plain PyTorch (``index_add_``) — the CPU path.
- ``onehot``: one-hot matrix times messages, plain PyTorch.
- ``pallas``: the reference's segment-sum kernel (a blocked one-hot
  contraction on the TPU); here :func:`segment_sum_pallas`, one
  hand-written CSR segment sum (csrc/fused_mp.cu) over a sort of the ids.
- ``fused``: collate attaches the ``edge_perm_sender`` marker and the
  marked dispatch sites run the hand-written kernels of ops/fused_mp.py.

The reference kernels walk a TPU step table of (node-block, edge-block)
pairs (``_dense_schedule`` / ``block_ranges``).  On the card that
schedule becomes per-segment CSR offsets: :func:`segment_offsets` gives
``row_ptr[S+1]`` with one ``torch.searchsorted`` over the sorted ids, and
each output row then owns the contiguous row range
``[row_ptr[s], row_ptr[s+1])``.

The ``pallas`` backend's two segment sums sum the rows of each segment in
float32 in a fixed order (no atomics), each segment's rows in edge order:

- :func:`segment_sum_sorted` (nondecreasing ids) launches the pool's CSR
  segment sum (ops/fused_mp.py ``launch_segment_sum_rows``), on route 1 at
  even widths (:func:`segment_sum_plan`: equal segment counts a block,
  warp slices, cut segments' partials added in warp order);
- :func:`segment_sum_pallas` (ids in any order) launches the unsorted sum
  (``launch_unsorted_sum``).  Its route 1 is one launch with no library
  sort: each block finds the edges of its own segments, places them in the
  stable order in its shared memory (:func:`unsorted_sum_plan` writes the
  schedule out) and sums them as the CSR kernel's route 1 does.  Route 2,
  past route 1's widths and segment counts, is :func:`sort_schedule` (a
  stable ``torch.sort`` of the ids, out-of-range ids parked past the last
  segment) and the CSR kernel through its permutation.

A CPU tensor takes the pool's plain version (``segment_sum_dense_plain``,
``index_add_``), a CUDA tensor the kernels.  Their VJP is a gather with
zeros where the forward dropped the row (plain PyTorch, so differentiable
in turn).  ``LAUNCHES`` counts the kernels' launches per function.
"""

from __future__ import annotations

import bisect
import math
import os
import warnings
from typing import Dict, Optional

import numpy as np
import torch

# THE backend vocabulary (same values as the reference)
KNOWN_BACKENDS = ("scatter", "onehot", "pallas", "fused")
_warned_unknown = set()

# node-block size of the reference kernel: collate attaches the kernel
# marker only when every graph fits one block, the reference's window
# invariant (graph/batch.py)
NODE_BLOCK = 128


def aggr_backend() -> str:
    """Current backend name, read from ``HYDRAGNN_AGGR_BACKEND`` on every
    call.  An unrecognized value warns once and behaves as ``scatter``."""
    v = os.environ.get("HYDRAGNN_AGGR_BACKEND", "scatter").lower()
    if v not in KNOWN_BACKENDS and v not in _warned_unknown:
        _warned_unknown.add(v)
        warnings.warn(
            f"HYDRAGNN_AGGR_BACKEND={v!r} is not one of {KNOWN_BACKENDS};"
            " every aggregation will take the scatter path", stacklevel=2)
    return v


def segment_offsets(ids: torch.Tensor, num_segments: int,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CSR offsets ``row_ptr[num_segments + 1]`` (int32) over sorted ids.

    Segment ``s`` owns rows ``[row_ptr[s], row_ptr[s+1])``.  Rows with
    ``valid == 0`` are parked at ``num_segments`` (out of range) so no
    segment's range holds them; this relies on collate's guarantee that
    masked rows sort last.  Ids outside ``[0, num_segments)`` fall outside
    every range.  ``ids`` must be nondecreasing after parking."""
    ids = ids.to(torch.int32)
    if valid is not None:
        ids = torch.where(valid != 0, ids, num_segments)
    bounds = torch.arange(num_segments + 1, dtype=torch.int32,
                          device=ids.device)
    return torch.searchsorted(ids, bounds, out_int32=True)


def row_shares(row_ptr: torch.Tensor, n_parts: int) -> torch.Tensor:
    """The first row of each of ``n_parts`` shares of a CSR schedule's rows,
    then ``n``: share ``i`` owns rows ``[b[i], b[i + 1])``.

    Each row weighs one (its output row) plus its entries, and share ``i``
    begins at the least row ``r`` whose weight before it, ``row_ptr[r] +
    r``, reaches ``floor(i * (row_ptr[n] + n) / n_parts)``: the shares
    balance entries and rows, and a row never splits.  The kernels that
    give each warp (the builder forward) or each block (egcl pass P) one
    share find the same rows on the card (``passp::share_range``,
    csrc/pass_p.cuh); this is their plan written out, for the tests."""
    n = row_ptr.shape[0] - 1
    key = row_ptr.to(torch.int64).cpu() + torch.arange(n + 1)
    total = int(key[-1])
    targets = torch.tensor([total * i // n_parts for i in range(n_parts + 1)],
                           dtype=torch.int64)
    return torch.searchsorted(key, targets)


# route 1 of the CSR segment sum (csrc/fused_mp.cu ``ss::``): warps a
# block, each summing one slice of the block's rows
SEG_SUM_WARPS = 16


def segment_sum_plan(row_ptr: torch.Tensor, n_blocks: int,
                     max_rows: Optional[int] = None,
                     n_warps: int = SEG_SUM_WARPS):
    """Route 1's plan of the CSR segment sum, as the card's ``n_blocks``
    blocks of ``n_warps`` warps run it.

    Block ``k`` takes an equal count of the segments, ``[sb, se) =
    [S k // n_blocks, S (k + 1) // n_blocks)`` (no segment split), and
    their positions ``[q0, q1) = [row_ptr[sb], row_ptr[se])``; warp ``w``
    the equal slice ``[a, b)`` of them, ``a = q0 + (q1 - q0) w //
    n_warps``.  A warp sums, in position order, the positions of its slice
    that lie within their segment's first ``max_rows`` (``rows``); it writes
    the segments that lie wholly in its slice (``whole``) and leaves the
    partial sums of its first segment when an earlier slice holds that
    segment's head (``head``) and of its last when a later slice holds its
    tail (``tail``; a segment through the whole slice is its head).  After
    the block's barrier each cut segment is its first slice's tail partial
    plus the head partials after it, in warp order (``combine``: segment ->
    ``[(warp, "tail"), (warp, "head"), ...]``); the block's empty segments
    are written as zeros (``zeros``).  Returns one dict a block."""
    ptr = [int(v) for v in row_ptr.long().cpu()]
    cap = 2**31 - 1 if max_rows is None else int(max_rows)
    n_seg = len(ptr) - 1
    bounds = [n_seg * k // n_blocks for k in range(n_blocks + 1)]
    blocks = []
    for k in range(n_blocks):
        sb, se = bounds[k], bounds[k + 1]
        q0, q1 = ptr[sb], ptr[se]
        cuts = [q0 + (q1 - q0) * w // n_warps for w in range(n_warps + 1)]
        warps, combine = [], {}
        s = sb
        for w in range(n_warps):
            a, b = cuts[w], cuts[w + 1]
            rec = {"slice": (a, b), "rows": [], "whole": [], "head": None,
                   "tail": None}
            warps.append(rec)
            if a == b:
                continue
            while ptr[s + 1] <= a:   # the segment of position a
                s += 1
            t = s
            while True:
                lo, hi = ptr[t], ptr[t + 1]
                rec["rows"] += [q for q in range(max(lo, a), min(hi, b))
                                if q - lo < cap]
                if lo < a:
                    rec["head"] = t
                elif hi > b:
                    rec["tail"] = t
                elif lo < hi:
                    rec["whole"].append(t)
                if lo < a or hi > b:
                    combine.setdefault(t, []).append(
                        (w, "head" if lo < a else "tail"))
                if hi >= b:
                    break
                t += 1
        blocks.append({
            "segments": (sb, se), "positions": (q0, q1), "warps": warps,
            "combine": combine,
            "zeros": [t for t in range(sb, se) if ptr[t] == ptr[t + 1]]})
    return blocks


def segment_sum_route1(data2d, row_ptr, n_blocks, perm=None,
                       max_rows=None, n_warps=SEG_SUM_WARPS):
    """The CSR segment sum as route 1 computes it from
    :func:`segment_sum_plan`: each warp's sums in float32, row by row in
    position order (``data2d[perm[q]]``, or ``data2d[q]``), the cut
    segments' partials added in warp order.  For the tests: the card's
    kernel cannot run here."""
    n_seg = row_ptr.shape[0] - 1
    f = data2d.shape[1]
    ptr = [int(v) for v in row_ptr.long().cpu()]
    out = torch.full((n_seg, f), float("nan"), dtype=torch.float32)
    rows = data2d.float() if perm is None else data2d.float()[perm.long()]
    for blk in segment_sum_plan(row_ptr, n_blocks, max_rows, n_warps):
        part = {}
        for w, rec in enumerate(blk["warps"]):
            sums = {}
            for q in rec["rows"]:
                t = bisect.bisect_right(ptr, q) - 1
                acc = sums.get(t, torch.zeros(f, dtype=torch.float32))
                sums[t] = acc + rows[q]
            for t in rec["whole"]:
                out[t] = sums.get(t, torch.zeros(f))
            for slot in ("head", "tail"):
                t = rec[slot]
                if t is not None:
                    part[(w, slot)] = sums.get(t, torch.zeros(f))
        for t, order in blk["combine"].items():
            acc = part[order[0]]
            for key in order[1:]:
                acc = acc + part[key]
            out[t] = acc
        for t in blk["zeros"]:
            out[t] = 0.0
    return out


# route 1 of the unsorted segment sum (csrc/fused_mp.cu ``us::``): ids a
# load of the counting and placing walks, segments a block owns at most,
# positions a round places in shared memory, and the segment count past
# which route 2 takes the call
UNSORTED_ID_LOAD = 32
UNSORTED_SEGS_PER_BLOCK = 128
UNSORTED_WINDOW = 16384
UNSORTED_MAX_SEGMENTS = UNSORTED_SEGS_PER_BLOCK * 256


def unsorted_sum_plan(ids, num_segments, n_blocks, n_warps=SEG_SUM_WARPS,
                      window=None):
    """Route 1's schedule of the unsorted segment sum, as the card's
    ``n_blocks`` blocks of ``n_warps`` warps build it in shared memory.

    Block ``k`` owns the segments ``[sb, se) = [S k // n_blocks, S (k + 1)
    // n_blocks)`` (the CSR kernel's).  (1) Its threads read every id once
    and keep the first and last edge whose id it owns, its span ``[lo,
    hi]``.  (2) Warp ``w`` takes the equal part ``[lo + L w // n_warps, lo
    + L (w + 1) // n_warps)`` of the span (``L = hi - lo + 1``) and counts,
    32 ids a load, the edges of each owned segment (``counts[t][w]``: a
    key's lanes add once).  (3) An exclusive prefix of the counts in
    (segment, warp) order gives ``base[t][w]``, the first position of warp
    ``w``'s edges of segment ``sb + t``, and the block's offsets
    ``row_ptr[t] = base[t][0]`` (``row_ptr[se - sb]`` the block's
    positions).  (4) In rounds of ``window`` positions, each warp walks
    its part again and places each owned edge at its (segment, warp) start
    plus its rank among them so far (lanes in order within a load, a
    running count across loads), keeping the round's positions.  The
    result is the slice of the stable sort's permutation that the CSR
    kernel's block ``k`` would walk.  Returns one dict a block:
    ``segments``, ``span`` (None when the block owns no edge), ``parts``,
    ``counts``, ``row_ptr`` (from 0), ``positions`` (edge indices in
    position order), ``q0`` (the in-range ids below ``sb``: the block's
    first global position) and ``rounds``."""
    ids = np.asarray(ids.cpu() if torch.is_tensor(ids) else ids,
                     dtype=np.int64)
    window = UNSORTED_WINDOW if window is None else int(window)
    e, n_seg = len(ids), int(num_segments)
    blocks = []
    for k in range(n_blocks):
        sb, se = n_seg * k // n_blocks, n_seg * (k + 1) // n_blocks
        ns = se - sb
        owned = np.nonzero((ids >= sb) & (ids < se))[0]
        q0 = int(((ids >= 0) & (ids < sb)).sum())
        span = (int(owned[0]), int(owned[-1])) if len(owned) else None
        lo, length = (span[0], span[1] - span[0] + 1) if span else (0, 0)
        parts = [(lo + length * w // n_warps, lo + length * (w + 1) // n_warps)
                 for w in range(n_warps)]

        def loads(w):   # (edge, key or -1) a lane, 32 ids a load
            a, b = parts[w]
            for e0 in range(a, b, UNSORTED_ID_LOAD):
                es = range(e0, min(e0 + UNSORTED_ID_LOAD, b))
                yield [(q, int(ids[q]) - sb if sb <= ids[q] < se else -1)
                       for q in es]

        counts = [[0] * n_warps for _ in range(ns)]
        for w in range(n_warps):
            for load in loads(w):
                for key in {key for _, key in load if key >= 0}:
                    counts[key][w] += sum(1 for _, k_ in load if k_ == key)
        base, acc = [[0] * n_warps for _ in range(ns)], 0
        for t in range(ns):
            for w in range(n_warps):
                base[t][w], acc = acc, acc + counts[t][w]
        n_in = acc
        row_ptr = [base[t][0] for t in range(ns)] + [n_in]
        positions = [None] * n_in
        rounds = 0
        for r0 in range(0, n_in, window):
            rounds += 1
            run = [row[:] for row in base]
            for w in range(n_warps):
                for load in loads(w):
                    for lane, (q, key) in enumerate(load):
                        if key < 0:
                            continue
                        rank = sum(1 for _, k_ in load[:lane] if k_ == key)
                        pos = run[key][w] + rank
                        if r0 <= pos < r0 + window:
                            assert positions[pos] is None
                            positions[pos] = q
                    for key in {key for _, key in load if key >= 0}:
                        run[key][w] += sum(1 for _, k_ in load if k_ == key)
        blocks.append({"segments": (sb, se), "span": span, "parts": parts,
                       "counts": counts, "row_ptr": row_ptr,
                       "positions": positions, "q0": q0, "rounds": rounds})
    return blocks


def unsorted_sum_schedule(plan, num_segments):
    """The blocks' schedules of :func:`unsorted_sum_plan` joined: ``(perm,
    row_ptr)`` in global positions (int32), as ``sort_schedule`` gives them
    for the in-range ids."""
    perm, row_ptr = [], [0] * (num_segments + 1)
    for blk in plan:
        sb, se = blk["segments"]
        for t in range(se - sb + 1):
            row_ptr[sb + t] = blk["q0"] + blk["row_ptr"][t]
        perm += blk["positions"]
    return (torch.tensor(perm, dtype=torch.int32),
            torch.tensor(row_ptr, dtype=torch.int32))


def unsorted_sum_route1(data2d, ids, num_segments, n_blocks,
                        n_warps=SEG_SUM_WARPS, window=None):
    """The unsorted segment sum as route 1 computes it: the CSR kernel's
    route 1 (:func:`segment_sum_route1`, same blocks and warps) over the
    schedule that :func:`unsorted_sum_plan` builds.  For the tests."""
    perm, row_ptr = unsorted_sum_schedule(
        unsorted_sum_plan(ids, num_segments, n_blocks, n_warps, window),
        num_segments)
    return segment_sum_route1(data2d, row_ptr, n_blocks, perm, None, n_warps)


def segment_sum_onehot(data, segment_ids, num_segments):
    """``onehot[e, n]^T @ data`` in full float32."""
    shape = data.shape
    flat = data.reshape(shape[0], -1)
    onehot = torch.nn.functional.one_hot(
        segment_ids.long(), num_segments).to(flat.dtype)
    out = onehot.t() @ flat
    return out.reshape((num_segments,) + tuple(shape[1:]))


LAUNCHES: Dict[str, int] = {"segment_sum_pallas": 0,
                             "segment_sum_sorted": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sort_schedule(segment_ids, num_segments):
    """The schedule of an unsorted segment sum: ``(perm, row_ptr)`` from a
    stable sort of the ids with out-of-range ids parked at
    ``num_segments`` (after every segment, so no range holds them)."""
    ids = segment_ids.to(torch.int32)
    ok = (ids >= 0) & (ids < num_segments)
    parked = torch.where(ok, ids, num_segments)
    sorted_ids, perm = torch.sort(parked, stable=True)
    return perm.to(torch.int32), segment_offsets(sorted_ids, num_segments)


class _SegmentSumRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data2d, segment_ids, num_segments, op, max_per_segment):
        from hydragnn_torch.ops import fused_mp

        ctx.num_segments = num_segments
        ctx.save_for_backward(segment_ids)
        if not data2d.is_cuda:
            return fused_mp.segment_sum_dense_plain(
                data2d, segment_ids, num_segments,
                max_per_segment=max_per_segment)
        if op == "segment_sum_pallas":
            return fused_mp.launch_unsorted_sum(
                data2d.contiguous(), segment_ids, num_segments, op=op,
                launches=LAUNCHES).to(data2d.dtype)
        return fused_mp.launch_segment_sum_rows(
            data2d.contiguous(), segment_offsets(segment_ids, num_segments),
            num_segments, op=op, max_rows=max_per_segment,
            launches=LAUNCHES).to(data2d.dtype)

    @staticmethod
    def backward(ctx, g):
        # the reference's _gather_bwd: g[ids], zero where the forward
        # dropped the row for its id (a bare gather would clamp it onto a
        # segment)
        (ids,) = ctx.saved_tensors
        s = ctx.num_segments
        ok = (ids >= 0) & (ids < s)
        d = g[ids.clamp(0, max(s - 1, 0)).long()]
        return (torch.where(ok[:, None], d, torch.zeros_like(d)), None, None,
                None, None)


def _segment_sum_2d(data, segment_ids, num_segments, op,
                    max_per_segment=None):
    shape = data.shape
    # the columns named: a reshape to -1 is ambiguous with no rows
    out = _SegmentSumRows.apply(
        data.reshape(shape[0], math.prod(shape[1:])), segment_ids,
        num_segments, op, max_per_segment)
    return out.reshape((num_segments,) + tuple(shape[1:]))


def segment_sum_pallas(data, segment_ids, num_segments):
    """Exact segment sum over ids in any order (the reference's
    hydragnn_tpu/ops/aggregate.py:segment_sum_pallas): ids outside ``[0,
    num_segments)`` are dropped; float32 accumulation, in id then edge
    order.  Differentiable wrt ``data``."""
    return _segment_sum_2d(data, segment_ids, num_segments,
                           "segment_sum_pallas")


def segment_sum_sorted(data, segment_ids, num_segments, max_per_segment):
    """Exact segment sum over NONDECREASING ``segment_ids`` with at most
    ``max_per_segment`` REAL rows per segment (the reference's
    segment_sum_sorted).  As there, the data must be pre-masked: collate's
    padding rows all target node N-1, far past the cap, and the rows of a
    segment past its first ``max_per_segment`` are dropped, which is
    harmless only because they are zeros.  The VJP is the gather
    (the reference's), whatever the cap dropped."""
    return _segment_sum_2d(data, segment_ids, num_segments,
                           "segment_sum_sorted", int(max_per_segment))
