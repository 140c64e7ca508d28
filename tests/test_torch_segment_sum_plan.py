"""Route 1 of the CSR segment sum and of the poly scatter, on the CPU.

The card's kernels (csrc/fused_mp.cu ``ss::``, csrc/poly_mp.cu ``r1::``)
cannot run here, so their plans are held instead.  The segment sum's
(``aggregate.segment_sum_plan``): an equal count of segments a block,
equal warp slices of each block's positions (which may cut a segment), the cut
segments' partials added in warp order after the block's barrier.  Every
live row is summed exactly once, rows past the cap and masked rows in no
slice, every segment written once (empty ones as zeros), a 220-row and a
2000-row segment split across warps; the plan's float32 sums
(``segment_sum_route1``) against ``segment_sum_dense_plain`` and the JAX
``segment_sum_dense`` (interpret mode) within 1e-6 of the largest entry,
with the pool's ids, edge ids with a masked tail, a cap, and unsorted ids
through a permutation.  The poly scatter's (``scatter_route1_walk``): warp
shares, groups of 8 edges across row boundaries, each row's moments in
edge order, against the plain version.  And both kernels' routes by
width.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hydragnn_tpu.ops import fused_mp as jfm
from hydragnn_torch.ops import aggregate as ag
from hydragnn_torch.ops import fused_mp as tfm
from hydragnn_torch.ops import poly_mp as tpm
from test_torch_gpu import _graph_batch


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("f,route", [(64, 1), (128, 1), (2, 1), (256, 1),
                                     (3, 2), (1, 2), (63, 2), (0, 2)])
def test_segment_sum_routes_by_width(f, route):
    assert tfm.segment_sum_route(f) == route


@pytest.mark.parametrize("f,gather,route", [
    (64, False, 1), (128, False, 1), (2, False, 1), (130, False, 2),
    (256, False, 2), (63, False, 2), (1, False, 2), (64, True, 1),
    (1, True, 2), (0, False, 2)])
def test_poly_routes_by_width(f, gather, route):
    assert tpm.fwd_route(f, gather) == route
    # a forced route 1 takes every even width in scatter mode, every
    # multiple of 4 in gather mode
    assert tpm.route1_takes(f, gather) == (f > 0
                                           and f % (4 if gather else 2) == 0)


def _case(name):
    """(data [R, F], ids, num_segments, valid, perm, max_rows, the segment
    route 1 must split or None)."""
    f = 6
    if name == "pool":      # 290 real nodes, a 220-node padding graph
        b = _graph_batch(11, n_real=290, n_pad=510)
        ids, n_seg = b["node_gid"], b["n_graphs"]
        data = b["rng"].randn(len(ids), f).astype(np.float32)
        data *= b["node_mask"][:, None]
        return data, ids, n_seg, None, None, None, n_seg - 1
    b = _graph_batch(12, hub=2000 if name == "hub" else 0, e_pad=6000)
    n = len(b["node_gid"])
    data = (b["rng"].randn(len(b["senders"]), f).astype(np.float32)
            * b["edge_mask"][:, None])
    if name in ("edges", "hub"):   # masked tail, empty segments
        return (data, b["receivers"], n, b["edge_mask"], None, None,
                0 if name == "hub" else None)
    if name == "cap":   # the padding edges (node N-1) past the cap
        return data, b["receivers"], n, None, None, 7, None
    # perm: unsorted ids (the senders), masked rows out of range
    ids = np.where(b["edge_mask"] != 0, b["senders"], n + 1)
    return data, ids.astype(np.int32), n, None, True, None, None


def _schedule(ids, n_seg, valid, perm):
    if perm:
        return ag.sort_schedule(_t(ids), n_seg)
    return None, ag.segment_offsets(_t(ids), n_seg,
                                    None if valid is None else _t(valid))


@pytest.mark.parametrize("n_blocks", [1, 7, 60])
@pytest.mark.parametrize("n_warps", [4, 16, 32])
@pytest.mark.parametrize("name", ["pool", "edges", "hub", "cap", "perm"])
def test_segment_sum_plan(name, n_warps, n_blocks):
    """Every live position summed by exactly one warp, none past the cap
    or outside every segment; every segment written exactly once (empty
    ones as zeros, cut ones by the combine, in warp order from the slice
    that holds their head); the long segment split across warps when the
    block has more than one warp's worth of rows."""
    data, ids, n_seg, valid, perm, cap, long_seg = _case(name)
    perm_t, ptr = _schedule(ids, n_seg, valid, perm)
    plan = ag.segment_sum_plan(ptr, n_blocks, cap, n_warps)
    p = [int(v) for v in ptr]
    live = [q for s in range(n_seg)
            for q in range(p[s], p[s + 1])
            if cap is None or q - p[s] < cap]
    summed = sorted(q for blk in plan for w in blk["warps"]
                    for q in w["rows"])
    assert summed == live
    written = []
    for blk in plan:
        sb, se = blk["segments"]
        q0, q1 = blk["positions"]
        assert (q0, q1) == (p[sb], p[se])
        slices = [w["slice"] for w in blk["warps"]]
        assert slices[0][0] == q0 and slices[-1][1] == q1
        assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
        written += blk["zeros"]
        for w in blk["warps"]:
            written += w["whole"]
        for t, order in blk["combine"].items():
            written.append(t)
            assert order[0][1] == "tail" and all(
                slot == "head" for _, slot in order[1:])
            assert [w for w, _ in order] == sorted({w for w, _ in order})
            assert len(order) >= 2
        for t in blk["zeros"]:
            assert p[t] == p[t + 1]
    assert sorted(written) == list(range(n_seg))
    if long_seg is not None and n_warps > 1:
        assert p[long_seg + 1] - p[long_seg] >= 220
        cut = [t for blk in plan for t in blk["combine"]]
        assert long_seg in cut


@pytest.mark.parametrize("n_blocks,n_warps", [(1, 16), (7, 16), (40, 4),
                                              (3, 32)])
@pytest.mark.parametrize("name", ["pool", "edges", "hub", "cap", "perm"])
def test_segment_sum_route1_matches_plain(name, n_blocks, n_warps):
    """The plan's float32 sums against the plain version at 1e-6 of the
    largest entry; segments that no slice cuts keep the first design's
    order (each segment's rows in position order), so they are exact
    against a row-by-row sum."""
    data, ids, n_seg, valid, perm, cap, _ = _case(name)
    perm_t, ptr = _schedule(ids, n_seg, valid, perm)
    got = ag.segment_sum_route1(_t(data), ptr, n_blocks, perm_t, cap,
                                n_warps)
    want = tfm.segment_sum_dense_plain(
        _t(data), _t(ids), n_seg,
        valid=None if valid is None else _t(valid), max_per_segment=cap)
    if perm:   # the plain version sums unsorted ids in any order
        want = tfm.segment_sum_dense_plain(_t(data), _t(ids), n_seg)
    top = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * top
    rows = _t(data) if perm_t is None else _t(data)[perm_t.long()]
    p = [int(v) for v in ptr]
    cut = {t for blk in ag.segment_sum_plan(ptr, n_blocks, cap, n_warps)
           for t in blk["combine"]}
    for s in range(n_seg):
        if s in cut:
            continue
        acc = torch.zeros(data.shape[1])
        for q in range(p[s], p[s + 1] if cap is None
                       else min(p[s + 1], p[s] + cap)):
            acc = acc + rows[q]
        assert torch.equal(got[s], acc)


@pytest.mark.parametrize("name", ["pool", "edges"])
def test_segment_sum_route1_matches_jax(name):
    data, ids, n_seg, valid, perm, cap, _ = _case(name)
    _, ptr = _schedule(ids, n_seg, valid, perm)
    got = ag.segment_sum_route1(_t(data), ptr, 7)
    want = np.asarray(jfm.segment_sum_dense(
        jnp.asarray(data), jnp.asarray(ids), n_seg,
        valid=None if valid is None else jnp.asarray(valid)))
    top = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= 1e-6 * top


@pytest.mark.parametrize("n_warps", [1, 7, 64, 600])
@pytest.mark.parametrize("hub", [0, 300])
def test_poly_scatter_route1_walk(n_warps, hub):
    """Route 1's walk over the receiver rows: each warp's groups cover its
    share's edges in order, at most 8 an edge group; the rows' moments,
    summed in edge order as the walk passes them, against the plain
    version (sum and sq 1e-6 of the largest entry, max/min and the count
    exactly), every row written once."""
    b = _graph_batch(30 + hub, hub=hub)
    n, e, f = len(b["node_gid"]), len(b["senders"]), 4
    data = _t((b["rng"].randn(e, f) * 2).round().astype(np.float32) / 2)
    recv, mask = _t(b["receivers"]), _t(b["edge_mask"])
    ptr = ag.segment_offsets(recv, n, mask)
    p = [int(v) for v in ptr]
    bounds, groups = tpm.scatter_route1_walk(ptr, n_warps)
    s = torch.full((n, f), float("nan"))
    q = s.clone()
    mx = torch.full((n, 2 * f), float("nan"))
    writes = torch.zeros(n, dtype=torch.int64)

    def put(r, acc):
        s[r], q[r], mx[r] = acc
        writes[r] += 1

    def empty():
        return (torch.zeros(f), torch.zeros(f),
                torch.full((2 * f,), tpm._NEG))

    for w in range(n_warps):
        rb, re = int(bounds[w]), int(bounds[w + 1])
        walked = [k for g0, g1 in groups[w] for k in range(g0, g1)]
        assert walked == list(range(p[rb], p[re]))
        assert all(0 < g1 - g0 <= tpm.POLY_ROWS_IN_FLIGHT
                   for g0, g1 in groups[w])
        if rb >= re:
            continue
        row, acc = rb, empty()
        for k in walked:
            while k >= p[row + 1]:
                put(row, acc)
                row, acc = row + 1, empty()
            v = data[k]
            acc = (acc[0] + v, acc[1] + v * v,
                   torch.maximum(acc[2], torch.cat([v, -v])))
        put(row, acc)
        for r in range(row + 1, re):
            put(r, empty())
    assert bool((writes == 1).all())
    want = tpm.segment_poly_dense_plain(data, recv, n,
                                        ("sum", "sq", "mxmn"), valid=mask)
    for got_m, want_m in zip((s, q), want[:2]):
        top = float(want_m.abs().max())
        assert float((got_m - want_m).abs().max()) <= 1e-6 * top
    assert torch.equal(mx, want[2])
