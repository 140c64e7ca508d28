"""EGNN's egcl pass S as route 1 of its kernel walks it
(csrc/egcl_mp.cu ``tc::pass_s_tc_kernel``), written out in torch on the CPU.

- Receiver order, positions as edge ids: warp ``w`` of the card's ``12 x
  SMs`` owns the receiver rows of share ``w`` of
  :func:`~hydragnn_torch.ops.aggregate.row_shares` (rows plus edges
  balanced, no row split) and walks their positions in 16-edge tiles
  (:func:`egcl_mp.pass_s_tiles`).
- Each real edge's dx row ``dt0 @ W0r^T`` is added into its receiver's
  row in position order; a row's sum goes on from one tile into the next
  (rows that straddle tiles are summed in tile order); every row of the
  share is written once, rows without a real incoming edge as zeros.

The per-edge rows come from the plain chain (the kernel runs it in 3xTF32):
held to ``egcl_pass_s_plain`` at 1e-5 of the largest entry and, with pass
P's sender side, once to the JAX op's dx in interpret mode (the tolerance
of tests/test_torch_egnn.py).  And pass S's route by width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_torch.ops import egcl_mp
from hydragnn_torch.ops.aggregate import segment_offsets
from hydragnn_tpu.ops.egcl_mp import egcl_block as j_egcl
from test_torch_egnn import GRAD_TOL, _block_case, _ids
from test_torch_pass_s_plan import _close


def _walk(per_edge, receivers, ok, row_ptr, n_warps):
    """Pass S's row sums as route 1's warps walk them: ``dx [N, F]`` and how
    many times each row was written."""
    n, f = row_ptr.shape[0] - 1, per_edge.shape[1]
    bounds, tiles = egcl_mp.pass_s_tiles(row_ptr, n_warps)
    out = torch.full((n, f), float("nan"))
    written = torch.zeros(n, dtype=torch.long)

    def put(r, v):
        out[r] = v
        written[r] += 1

    for w in range(n_warps):
        rb, re = int(bounds[w]), int(bounds[w + 1])
        row, nxt, acc = -1, rb, None
        for q0, q1 in tiles[w]:
            for k in range(q0, q1):
                r = int(receivers[k])
                if not (bool(ok[k]) and rb <= r < re):
                    continue
                if r != row:
                    if row >= 0:
                        put(row, acc)
                        nxt = row + 1
                    for z in range(nxt, r):
                        put(z, torch.zeros(f))
                    row, acc = r, torch.zeros(f)
                acc = acc + per_edge[k]
        if row >= 0:
            put(row, acc)
            nxt = row + 1
        for z in range(nxt, re):
            put(z, torch.zeros(f))
    return out, written


def _per_edge_dx(eq, x, geo, em, ws, senders, receivers, gagg, gpsum):
    """Each edge's ``dt0 @ W0r^T`` from the plain chain (zero off real
    edges) and the real-edge mask."""
    r = egcl_mp._backward_plain(eq, x, geo, em, *ws, senders, receivers,
                                gagg, gpsum)
    _, w0r, _ = egcl_mp.split_weights(ws[0], x.shape[1])
    return torch.where(r["ok"][:, None], r["dt0"] @ w0r.t(), r["zero"]), \
        r["ok"]


def _pass_s_case(f, h, eq, seed=0):
    """A receiver-sorted batch of 40 nodes: node 4 receives 45 edges (it
    straddles 16-edge tiles), nodes 0, 7 and the last three receive
    nothing, one real edge's sender lies outside [0, N), a masked tail is
    parked on the last node."""
    rng = np.random.RandomState(seed + f + h)
    n, e, real = 40, 260, 230
    recv = rng.randint(1, n - 3, real)
    recv[:45] = 4
    recv[recv == 7] = 8
    recv = np.sort(recv)
    send = rng.randint(0, n - 1, real)
    send[real // 3] = n + 2
    pad = np.full(e - real, n - 1)
    send, recv = (torch.from_numpy(np.concatenate([v, pad]).astype(np.int32))
                  for v in (send, recv))
    em = torch.from_numpy((np.arange(e) < real).astype(np.int32))
    gp = 2
    d = rng.rand(e, 3) * 1.2 - 0.6
    geo = np.concatenate([d, rng.rand(e, gp) * 3.0], 1)
    shapes = [((2 * f + gp, h), (2 * f + gp) ** -0.5), ((h,), 0.1),
              ((h, h), h ** -0.5), ((h,), 0.1)]
    if eq:
        shapes += [((h, h), h ** -0.5), ((h,), 0.1), ((h, 1), 0.5)]
    ws = [torch.from_numpy((rng.randn(*s) * sc).astype(np.float32))
          for s, sc in shapes] + [None] * (3 * (not eq))
    x, geo, gagg, gpsum = (torch.from_numpy(v.astype(np.float32)) for v in (
        rng.randn(n, f), geo, rng.randn(n, h), rng.randn(n, 3)))
    return x, geo, em, ws, send, recv, gagg, gpsum if eq else None


@pytest.mark.parametrize("n_warps",
                         [1, 5, egcl_mp.EGCL_PASS_S_WARPS * 132])
def test_egcl_pass_s_tiles_cover_every_edge_once(n_warps):
    """Route 1's warps: each owns the rows of its share (rows plus edges
    balanced, no row split) and their positions in 16-edge tiles, in
    order; every real edge's position lies in exactly one tile, and some
    row straddles two tiles."""
    _, _, em, _, send, recv, _, _ = _pass_s_case(8, 8, True)
    n = 40
    row_ptr = segment_offsets(recv, n, em)
    bounds, tiles = egcl_mp.pass_s_tiles(row_ptr, n_warps)
    assert int(bounds[0]) == 0 and int(bounds[-1]) == n
    seen = torch.zeros(len(send), dtype=torch.long)
    straddle = False
    for w in range(n_warps):
        p0 = int(row_ptr[int(bounds[w])])
        p1 = int(row_ptr[int(bounds[w + 1])])
        q = p0
        for a, b in tiles[w]:
            assert a == q and 0 < b - a <= egcl_mp.EGCL_PASS_S_TILE
            assert b - a == egcl_mp.EGCL_PASS_S_TILE or b == p1
            seen[a:b] += 1
            straddle |= bool(recv[a] == recv[a - 1]) if a > p0 else False
            q = b
        assert q == p1
    assert bool((seen[em != 0] == 1).all()) and int(seen[em == 0].sum()) == 0
    assert straddle


@pytest.mark.parametrize("n_warps",
                         [1, 5, egcl_mp.EGCL_PASS_S_WARPS * 132])
@pytest.mark.parametrize("f,h,eq", [(48, 48, True), (48, 48, False),
                                    (32, 32, False), (12, 20, True)])
def test_egcl_pass_s_walk_matches_plain(f, h, eq, n_warps):
    """Pass S as route 1 walks it (the per-edge dx rows summed into their
    receiver rows in position order across tiles, each warp's share
    written once) equals the plain pass S within 1e-5 of its largest entry
    at md17's layers (48, equivariant or not), oc22's last (32) and a width
    off the 16 grid; rows without a real incoming edge exact zeros."""
    x, geo, em, ws, send, recv, gagg, gpsum = _pass_s_case(f, h, eq)
    n = x.shape[0]
    per_edge, ok = _per_edge_dx(eq, x, geo, em, ws, send, recv, gagg, gpsum)
    got, written = _walk(per_edge, recv, ok,
                         segment_offsets(recv, n, em), n_warps)
    assert bool((written == 1).all())
    want = egcl_mp.egcl_pass_s_plain(eq, x, geo, em, *ws, send, recv, gagg,
                                     gpsum)
    _close(got, want)
    no_in = ~torch.isin(torch.arange(n), recv[ok])
    assert bool(no_in[0]) and bool(no_in[7]) and bool(no_in[-1])
    assert float(got[no_in].abs().max()) == 0


@pytest.mark.parametrize("equivariant", [True, False],
                         ids=["equivariant", "last-layer"])
def test_egcl_pass_s_walk_matches_jax(equivariant, monkeypatch):
    """Pass P's sender side (plain) plus pass S as route 1 walks it equals
    the JAX op's dx (interpret mode; the batch and inputs of
    tests/test_torch_egnn.py) at that file's gradient tolerance."""
    g, args, wa, wp = _block_case(monkeypatch, 7, equivariant, 2, True)
    s, r, p, em = _ids(g)

    def jloss(x):
        full = [x] + [jnp.asarray(a) for a in args[1:]]
        full += [None] * (9 - len(full))
        agg, psum = j_egcl(equivariant, *full[:2], jnp.asarray(em),
                           *full[2:], jnp.asarray(s), jnp.asarray(r),
                           jnp.asarray(p))
        out = jnp.sum(agg * wa)
        if equivariant:
            out = out + jnp.sum(psum[:, :3] * wp)
        return out

    jdx = np.asarray(jax.grad(jloss)(jnp.asarray(args[0])))
    ts = [torch.from_numpy(a) for a in args]
    ws = ts[2:] + [None] * (9 - len(ts))
    st, rt, emt = (torch.from_numpy(v) for v in (s, r, em))
    ct = torch.from_numpy(wa)
    cp = torch.from_numpy(wp) if equivariant else None
    dx_s = egcl_mp.egcl_pass_p_plain(equivariant, ts[0], ts[1], emt, *ws,
                                     st, rt, ct, cp)[8]
    per_edge, ok = _per_edge_dx(equivariant, ts[0], ts[1], emt, ws, st, rt,
                                ct, cp)
    n = ts[0].shape[0]
    dx_r, written = _walk(per_edge, rt, ok, segment_offsets(rt, n, emt), 5)
    assert bool((written == 1).all()) and float(dx_r.abs().max()) > 0
    np.testing.assert_allclose((dx_s + dx_r).numpy(), jdx, **GRAD_TOL)


@pytest.mark.parametrize("f,h,gp,eq,route", [
    (48, 48, 1, True, 1), (48, 48, 1, False, 1), (32, 32, 1, False, 1),
    (32, 32, 4, True, 1), (1, 48, 1, True, 1), (48, 33, 1, True, 1),
    (8, 8, 15, True, 1), (8, 8, 16, True, 2), (48, 64, 1, True, 2),
    (64, 48, 1, False, 2), (128, 128, 4, True, 2), (128, 32, 1, True, 2)])
def test_egcl_pass_s_route_by_width(f, h, gp, eq, route):
    """Pass S's route 1 at pass P's route-1 widths (F, H <= 48, gp <= 15:
    md17's layers and oc22's); the first design past that."""
    assert egcl_mp.pass_s_route(f, h, gp, eq) == route
    assert egcl_mp.pass_p_route(f, h, gp, eq) == route
