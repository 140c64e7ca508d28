"""GAT's receiver-side backward pass (pass R) as route 1 of its kernel
computes it (csrc/gat_mp.cu ``gat_pass_r_kernel``), written out in torch on
the CPU.

- Head sums across lanes: each head's logit ``e`` and ``q = <ga[dst],
  xl[src]>_h`` summed over the head's columns as the warp's lanes add them
  (each lane's slots in order, then the butterfly of offsets 16, 8, 4, 2,
  1: ``test_torch_pass_s_plan._lane_head_sums``).
- dxr: each receiver row's ``dz`` summed in edge order.
- d att: each lane's per-column partial summed over its warp's rows in the
  order the warp takes them (row ``b * 4 + w + i * 4 * grid`` of warp ``w``
  of block ``b``; each row's edges in order), then the block's four warps
  in order, then the blocks in order (the reduction kernel), on a grid of
  ``min(n_parts, ceil(N / 4))`` blocks.

Held to ``gat_pass_r_plain`` and to autograd through the plain forward:
dxr 1e-5 of its largest entry, d att 1e-4 (a sum over every edge in
another order); the logits are summed in another order than the
forward's (lane order), so ``p = exp(e - m)`` moves by a rounding of
``e``.  Once against the JAX op's gradients in interpret mode, at the
tolerance of tests/test_torch_gat.py.  And pass R's route by width, pass
S's rule, as ``hg_gat_pass_r_route`` decides it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_torch.ops import gat_mp
from hydragnn_torch.ops.aggregate import segment_offsets
from test_torch_gat import OP_TOL, SLOPE, _jax_op, _op_case, _torch_args
from test_torch_pass_s_plan import (
    _close,
    _gat_case,
    _in_position_order,
    _lane_head_sums,
)

WARPS = 4   # csrc/gat_mp.cu kWarps: rows in flight a block


def _in_group_order(values, group, n_groups):
    """``out[g] = ((0 + v_0) + v_1) + ...`` over the rows of ``values``
    whose ``group`` is g, in row order: the k-th of every group added in
    step k, as a warp adds its edges into its register partials."""
    order = torch.argsort(group, stable=True)
    g_sorted = group[order]
    first = torch.searchsorted(g_sorted, g_sorted, right=False)
    rank = torch.empty_like(group)
    rank[order] = torch.arange(group.shape[0]) - first
    out = torch.zeros((n_groups, values.shape[1]), dtype=values.dtype)
    for k in range(int(rank.max()) + 1 if rank.numel() else 0):
        idx = torch.nonzero(rank == k)[:, 0]
        out[group[idx]] += values[idx]
    return out


def _gat_pass_r_lanes(xl, xr, att, senders, receivers, edge_mask, b_edge, m,
                      ga, gd, slope, n_parts):
    """gat pass R as route 1 computes it: ``(dxr [N, H*F], d att [H, F])``
    (and the edges' logits)."""
    n = xl.shape[0]
    h, f = att.shape
    ok, s, r = gat_mp._valid_edges(edge_mask, senders, receivers, n)
    xs, xt = xl[s], xr[r]
    z = xs + xt
    zl = torch.where(z > 0, z, z * slope)
    e = _lane_head_sums(zl * att.reshape(1, -1), h, f)
    q = _lane_head_sums(ga[r] * xs, h, f)
    zero = torch.zeros((), dtype=xl.dtype)
    pe = torch.where(ok[:, None], torch.exp(e - m[r]), zero)
    bb = torch.ones_like(pe) if b_edge is None else b_edge
    de = pe * (bb * q + gd[r])
    att_row = att.reshape(1, -1)
    dz = gat_mp._expand(de, f) * torch.where(z > 0, att_row, att_row * slope)
    # dxr: receiver order is edge order
    dxr = _in_position_order(dz, segment_offsets(receivers, n, edge_mask), n)
    # d att: per warp, its rows' real edges in edge order
    grid = min(n_parts, -(-n // WARPS))
    real = torch.nonzero(ok)[:, 0]
    warp = r[real] % (WARPS * grid)          # b * 4 + w
    per_warp = _in_group_order((zl * gat_mp._expand(de, f))[real], warp,
                               WARPS * grid)
    datt = torch.zeros(h * f, dtype=xl.dtype)
    for blk in range(grid):
        part = torch.zeros(h * f, dtype=xl.dtype)
        for w in range(WARPS):
            part = part + per_warp[blk * WARPS + w]
        datt = datt + part
    return dxr, datt.reshape(h, f), e[ok]


@pytest.mark.parametrize("n_parts", [1, 5, 528])
@pytest.mark.parametrize("bits", [False, True], ids=["ones", "dropout"])
@pytest.mark.parametrize("h,f", [(3, 12), (6, 64)])
def test_gat_pass_r_lane_sums_match_plain(h, f, bits, n_parts):
    """gat pass R as route 1 computes it (head sums across lanes, dxr in
    edge order, d att per lane over each warp's rows, then warps and blocks
    in order) equals the plain pass R and autograd through the plain
    forward (dxr 1e-5, d att 1e-4 of the largest entry) at a width that
    does not divide 32 (3 x 12) and the gat cell's (6 x 64), with and
    without dropout bits, on one block, on five (each of several rows a
    warp) and on the card's 4 x 132 parts (more than the batch's row
    blocks); its logits lie within a rounding of the forward's; rows
    without a real incoming edge (node 5 and the receive-nothing nodes)
    get exact zeros.  The batch has a hub, a node with no edge, a
    receive-only node and a masked tail."""
    (xl, xr, att, ca, cd, b), (send, recv, _), mask = _gat_case(h, f, bits)
    leaves = [t.clone().requires_grad_(True) for t in (xr, att)]
    acc, m, d = gat_mp.gat_edge_attention_reference(
        xl, leaves[0], leaves[1], send, recv, mask, b, SLOPE)
    ((acc * ca).sum() + (d * cd).sum()).backward()
    dxr, datt, e_lanes = _gat_pass_r_lanes(xl, xr, att, send, recv, mask, b,
                                           m, ca, cd, SLOPE, n_parts)
    want_dxr, want_datt = gat_mp.gat_pass_r_plain(xl, xr, att, send, recv,
                                                  mask, b, m, ca, cd, SLOPE)
    _close(dxr, want_dxr)
    _close(dxr, leaves[0].grad)
    _close(datt, want_datt, rel=1e-4)
    _close(datt, leaves[1].grad, rel=1e-4)
    ok = mask != 0
    e_fwd, _, _ = gat_mp.edge_logits(xl[send.long()[ok]],
                                     xr[recv.long()[ok]], att, SLOPE)
    _close(e_lanes, e_fwd, rel=1e-6)
    no_in = ~torch.isin(torch.arange(xl.shape[0]), recv[ok])
    assert bool(no_in[5]) and int(no_in.sum()) >= 2
    assert float(dxr[no_in].abs().max()) == 0


@pytest.mark.parametrize("bits", [True], ids=["dropout"])
def test_gat_pass_r_lane_sums_match_jax(bits, monkeypatch):
    """Pass R as route 1 computes it against the JAX op's gradients wrt xr
    and att (interpret mode; the batch and inputs of
    tests/test_torch_gat.py at H = 4, F = 8) at that file's tolerance."""
    ids, xl, xr, att, b, ca, cd = _op_case(monkeypatch, 4, 8, 9, bits)
    with jax.default_matmul_precision("highest"):
        _, jgrads = jax.value_and_grad(
            _jax_op(ids, xl, xr, att, b), argnums=(1, 2), has_aux=True)(
            jnp.asarray(xl), jnp.asarray(xr), jnp.asarray(att), ca, cd)
    s, r, _, em, tb_ = _torch_args(ids, b)
    txl, txr, tatt = (torch.from_numpy(a) for a in (xl, xr, att))
    _, m, _ = gat_mp.gat_edge_attention_reference(txl, txr, tatt, s, r, em,
                                                  tb_, SLOPE)
    dxr, datt, _ = _gat_pass_r_lanes(txl, txr, tatt, s, r, em, tb_, m,
                                     torch.from_numpy(ca),
                                     torch.from_numpy(cd), SLOPE, 3)
    assert float(datt.abs().max()) > 0
    np.testing.assert_allclose(dxr.numpy(), np.asarray(jgrads[0]), **OP_TOL)
    np.testing.assert_allclose(datt.numpy(), np.asarray(jgrads[1]), **OP_TOL)


@pytest.mark.parametrize("hf,f,route", [
    (384, 64, 1), (768, 256, 1), (36, 12, 1), (32, 8, 1), (40, 10, 1),
    (512, 32, 1), (1024, 128, 1), (1024, 256, 1), (96, 96, 1), (40, 1, 2),
    (384, 16, 2), (384, 8, 2), (1020, 12, 2), (960, 48, 2), (1024, 512, 2),
    (1024, 1024, 2)])
def test_gat_pass_r_route_by_width(hf, f, route):
    """Pass R's route 1 at pass S's route-1 widths (a head at most 8 slots
    of 32 lanes, at most 32 slots a lane and 16 heads: the gat cell's 6 x
    64 and gat_h256's head groups of 3 x 256 among them); the first design
    past that."""
    assert gat_mp.pass_r_route(hf, f) == route
    assert gat_mp.pass_r_route(hf, f) == gat_mp.pass_s_route(hf, f)
