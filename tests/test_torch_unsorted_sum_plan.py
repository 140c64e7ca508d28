"""Route 1 of the unsorted segment sum, on the CPU.

The card's kernel (csrc/fused_mp.cu ``us::us_sum_kernel``) cannot run
here, so its plan (``aggregate.unsorted_sum_plan``) is held instead: each
block owns an equal count of the segments, finds the span of the edges
whose ids it owns, counts them per (segment, warp part) of that span,
takes a prefix in (segment, warp) order and places each edge at its
(segment, warp) start plus its rank, in rounds of a window of positions.
On every id pattern the card tests use (sorted, a padded tail on node
N-1, shuffled, graph-blocked senders, an out-of-range tail, all out of
range, empty segments, no ids), at several warp and block counts: the
blocks' positions are the stable sort's permutation and their offsets
``segment_offsets``'; the sum over that schedule is the CSR kernel's
route 1 (``segment_sum_route1``) through the sort's permutation bit for
bit, and within 1e-6 of the largest entry of the JAX
``segment_sum_pallas`` (interpret mode).  With no ids at all the sum
is zeros, on the plan and through the plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hydragnn_tpu.ops import aggregate as jagg
from hydragnn_torch.ops import aggregate as ag
from hydragnn_torch.ops import fused_mp as tfm
from test_torch_gpu import ID_PATTERNS, _id_pattern


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _schedule(ids, n):
    perm, ptr = ag.sort_schedule(_t(ids), n)
    return perm[:int(ptr[-1])], ptr


@pytest.mark.parametrize("n_blocks", [3, 7])
@pytest.mark.parametrize("n_warps", [1, 4, 16])
@pytest.mark.parametrize("name", ID_PATTERNS)
def test_unsorted_plan_is_the_stable_sort(name, n_warps, n_blocks):
    """The blocks' positions, joined, are ``torch.sort(stable)``'s
    permutation of the in-range ids, and their offsets ``row_ptr``; each
    block's warp parts tile its span, and its counts add up to its
    positions."""
    ids, n = _id_pattern(name)
    plan = ag.unsorted_sum_plan(ids, n, n_blocks, n_warps)
    perm, ptr = ag.unsorted_sum_schedule(plan, n)
    want_perm, want_ptr = _schedule(ids, n)
    assert torch.equal(perm, want_perm)
    assert torch.equal(ptr, want_ptr)
    assert torch.equal(ptr, ag.segment_offsets(
        _t(np.sort(ids[(ids >= 0) & (ids < n)])), n))
    for blk in plan:
        sb, se = blk["segments"]
        n_in = blk["row_ptr"][-1]
        assert sum(map(sum, blk["counts"])) == n_in == len(blk["positions"])
        assert blk["rounds"] == -(-n_in // ag.UNSORTED_WINDOW)
        parts = blk["parts"]
        if blk["span"] is None:
            assert n_in == 0
            continue
        lo, hi = blk["span"]
        assert parts[0][0] == lo and parts[-1][1] == hi + 1
        assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
        assert all(sb <= ids[q] < se for q in blk["positions"])


@pytest.mark.parametrize("window", [40, 1000])
@pytest.mark.parametrize("name", ["padded_tail", "shuffled", "graph_blocked"])
def test_unsorted_plan_in_rounds(name, window):
    """A window smaller than a block's positions places them in rounds,
    each walk of the span keeping its round's positions: the same
    schedule."""
    ids, n = _id_pattern(name)
    plan = ag.unsorted_sum_plan(ids, n, 3, 16, window=window)
    assert max(blk["rounds"] for blk in plan) == max(
        -(-blk["row_ptr"][-1] // window) for blk in plan)
    if window == 40:
        assert max(blk["rounds"] for blk in plan) > 1
    perm, ptr = ag.unsorted_sum_schedule(plan, n)
    want_perm, want_ptr = _schedule(ids, n)
    assert torch.equal(perm, want_perm) and torch.equal(ptr, want_ptr)


@pytest.mark.parametrize("n_blocks,n_warps", [(3, 16), (7, 4)])
@pytest.mark.parametrize("name", ID_PATTERNS)
def test_unsorted_route1_sum(name, n_blocks, n_warps):
    """The sum over the plan's schedule is the CSR kernel's route 1
    through the stable sort's permutation, at the same blocks and warps,
    bit for bit; within 1e-6 of the largest entry of the JAX
    ``segment_sum_pallas`` (interpret mode); segments with no id are
    zeros."""
    ids, n = _id_pattern(name)
    rng = np.random.RandomState(len(ids) + n_warps)
    data = rng.randn(len(ids), 6).astype(np.float32)
    got = ag.unsorted_sum_route1(_t(data), ids, n, n_blocks, n_warps)
    perm, ptr = ag.sort_schedule(_t(ids), n)
    want = ag.segment_sum_route1(_t(data), ptr, n_blocks, perm, None,
                                 n_warps)
    assert torch.equal(got, want)
    if len(ids):
        ref = np.asarray(jagg.segment_sum_pallas(
            jnp.asarray(data), jnp.asarray(ids), n))
    else:   # the reference's kernel takes no empty input
        ref = np.zeros((n, 6), np.float32)
    top = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(got.numpy() - ref).max()) <= 1e-6 * top
    empty = ptr.diff() == 0
    assert bool((got[empty] == 0).all())


@pytest.mark.parametrize("e,s,f,route", [
    (2560, 304, 64, 1), (2560, 304, 128, 1), (0, 304, 2, 1), (5, 0, 64, 1),
    (2560, 304, 130, 2), (2560, 304, 63, 2), (2560, 304, 0, 2),
    (2560, ag.UNSORTED_MAX_SEGMENTS, 64, 1),
    (2560, ag.UNSORTED_MAX_SEGMENTS + 1, 64, 2)])
def test_unsorted_sum_routes(e, s, f, route):
    """Route 1 at even widths up to 128 and up to
    ``UNSORTED_MAX_SEGMENTS`` segments, route 2 (the stable sort and the
    CSR kernel) past them."""
    assert tfm.unsorted_sum_route(e, s, f) == route


@pytest.mark.parametrize("name", ["shuffled", "no_ids"])
def test_unsorted_sum_on_cpu_is_the_plain_version(name):
    """A CPU tensor takes the plain version whatever the route would be,
    and launches nothing; with no ids the sum is zeros."""
    ids, n = _id_pattern(name)
    data = _t(np.random.RandomState(0).randn(len(ids), 4).astype(np.float32))
    ag.reset_launches()
    got = ag.segment_sum_pallas(data, _t(ids), n)
    assert sum(ag.LAUNCHES.values()) == 0
    assert torch.equal(got, tfm.segment_sum_dense_plain(data, _t(ids), n))
    if not len(ids):
        assert got.shape == (n, 4) and not bool(got.any())
