"""EGNN's egcl forward as route 1 of its kernel walks it
(csrc/egcl_mp.cu ``tc::fwd_tc_kernel``), written out in torch on the CPU.

- Sender order, positions mapped to edges through ``sender_perm``: warp
  ``w`` of the card's ``12 x SMs`` owns the sender rows of share ``w`` of
  :func:`~hydragnn_torch.ops.aggregate.row_shares` over the sender CSR
  (rows plus edges balanced, no row split) and walks their positions in
  16-edge tiles (:func:`egcl_mp.pass_s_tiles`, pass S's plan).
- Each real edge's row ``[m | clip(diff * c)]`` is added into its sender's
  row in position order; a row's sum goes on from one tile into the next;
  every row of the share is written once, rows without a real outgoing
  edge as zeros.  No sum crosses warps.

The per-edge rows come from the plain chain (the kernel runs it in 3xTF32):
held to ``egcl_block_reference`` at 1e-5 of the largest entry and once to
the JAX op's forward in interpret mode (the tolerance of
tests/test_torch_egnn.py).  And the forward's route by width, with its
refusals.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_torch.ops import egcl_mp
from hydragnn_torch.ops.aggregate import segment_offsets
from hydragnn_tpu.ops.egcl_mp import egcl_block as j_egcl
from test_torch_egnn import FWD_TOL, _block_case, _ids
from test_torch_pass_s_plan import _close

N_CARD_WARPS = egcl_mp.EGCL_PASS_S_WARPS * 132


def _walk(per_edge, senders, perm, ok, row_ptr, n_warps):
    """The forward's row sums as route 1's warps walk them: ``out [N, W]``
    (W = H + 3: agg, then psum) and how many times each row was
    written."""
    n, w_ = row_ptr.shape[0] - 1, per_edge.shape[1]
    bounds, tiles = egcl_mp.pass_s_tiles(row_ptr, n_warps)
    out = torch.full((n, w_), float("nan"))
    written = torch.zeros(n, dtype=torch.long)

    def put(r, v):
        out[r] = v
        written[r] += 1

    for w in range(n_warps):
        rb, re = int(bounds[w]), int(bounds[w + 1])
        row, nxt, acc = -1, rb, None
        for q0, q1 in tiles[w]:
            for q in range(q0, q1):
                k = int(perm[q])
                s = int(senders[k])
                if not (bool(ok[k]) and rb <= s < re):
                    continue
                if s != row:
                    if row >= 0:
                        put(row, acc)
                        nxt = row + 1
                    for z in range(nxt, s):
                        put(z, torch.zeros(w_))
                    row, acc = s, torch.zeros(w_)
                acc = acc + per_edge[k]
        if row >= 0:
            put(row, acc)
            nxt = row + 1
        for z in range(nxt, re):
            put(z, torch.zeros(w_))
    return out, written


def _per_edge(eq, x, geo, em, ws, senders, receivers):
    """Each edge's ``[m | clip(diff * c)]`` row from the plain chain (the
    translation lanes zero in the last layer's block) and the real-edge
    mask."""
    n = x.shape[0]
    ok, send, recv = egcl_mp._valid_edges(em, senders, receivers, n)
    _, m, _, c = egcl_mp._chain(eq, x, geo, *ws, send, recv)
    tr = (torch.clamp(geo[:, :3] * c, -100.0, 100.0) if eq
          else torch.zeros((m.shape[0], 3)))
    return torch.cat([m, tr], 1), ok


def _sender_perm(send, em, n):
    """The stable argsort of the senders with masked edges last, as collate
    builds ``edge_perm_sender``."""
    key = send.long() + n * (em == 0).long()
    return torch.argsort(key, stable=True).to(torch.int32)


def _fwd_case(f, h, eq, seed=0):
    """A batch of 40 nodes: node 4 sends 45 edges (its row straddles
    16-edge tiles), nodes 0, 7 and the last three send nothing, one real
    edge's receiver lies outside [0, N), a masked tail is parked on the
    last node."""
    rng = np.random.RandomState(seed + f + h)
    n, e, real = 40, 260, 230
    send = rng.randint(1, n - 3, real)
    send[:45] = 4
    send[send == 7] = 8
    recv = rng.randint(0, n - 1, real)
    recv[real // 3] = n + 2
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
    x, geo = (torch.from_numpy(v.astype(np.float32))
              for v in (rng.randn(n, f), geo))
    return x, geo, em, ws, send, recv, _sender_perm(send, em, n)


def _schedule(send, em, perm, n):
    return egcl_mp._sender_schedule(send, em, perm, n)


@pytest.mark.parametrize("n_warps", [1, 5, N_CARD_WARPS])
def test_egcl_fwd_tiles_cover_every_edge_once(n_warps):
    """Route 1's warps on the sender CSR: each owns the rows of its share
    and their positions in 16-edge tiles, in order; every real edge (its
    position mapped through the sender permutation) lies in exactly one
    tile, masked edges in none, and some sender row straddles two
    tiles."""
    _, _, em, _, send, _, perm = _fwd_case(8, 8, True)
    n = 40
    row_ptr = _schedule(send, em, perm, n)
    bounds, tiles = egcl_mp.pass_s_tiles(row_ptr, n_warps)
    assert int(bounds[0]) == 0 and int(bounds[-1]) == n
    seen = torch.zeros(len(send), dtype=torch.long)
    straddle = False
    p = perm.long()
    for w in range(n_warps):
        p0 = int(row_ptr[int(bounds[w])])
        p1 = int(row_ptr[int(bounds[w + 1])])
        q = p0
        for a, b in tiles[w]:
            assert a == q and 0 < b - a <= egcl_mp.EGCL_PASS_S_TILE
            assert b - a == egcl_mp.EGCL_PASS_S_TILE or b == p1
            seen[p[a:b]] += 1
            if a > p0:
                straddle |= bool(send[p[a]] == send[p[a - 1]])
            q = b
        assert q == p1
    assert bool((seen[em != 0] == 1).all()) and int(seen[em == 0].sum()) == 0
    assert straddle


@pytest.mark.parametrize("n_warps", [1, 5, N_CARD_WARPS])
@pytest.mark.parametrize("f,h,eq", [(48, 48, True), (48, 48, False),
                                    (1, 48, True), (32, 32, False),
                                    (12, 20, True)])
def test_egcl_fwd_walk_matches_plain(f, h, eq, n_warps):
    """The forward as route 1 walks it (each edge's m and translation lanes
    summed into its sender row in position order across tiles, each warp's
    share written once) equals the plain forward within 1e-5 of each
    output's largest entry at md17's layers 1-2 and 3 (48), layer 0 (F =
    1), oc22's last (32) and widths off the 16 grid; rows without a real
    outgoing edge exact zeros."""
    x, geo, em, ws, send, recv, perm = _fwd_case(f, h, eq)
    n = x.shape[0]
    per_edge, ok = _per_edge(eq, x, geo, em, ws, send, recv)
    got, written = _walk(per_edge, send, perm, ok,
                         _schedule(send, em, perm, n), n_warps)
    assert bool((written == 1).all())
    agg, psum = egcl_mp.egcl_block_reference(eq, x, geo, em, *ws, send, recv)
    _close(got[:, :h], agg)
    if eq:
        _close(got[:, h:], psum)
    else:
        assert float(got[:, h:].abs().max()) == 0
    no_out = ~torch.isin(torch.arange(n), send[ok])
    assert bool(no_out[0]) and bool(no_out[7]) and bool(no_out[-1])
    assert float(got[no_out].abs().max()) == 0


@pytest.mark.parametrize("eq", [True, False],
                         ids=["equivariant", "last-layer"])
def test_egcl_fwd_walk_all_masked(eq):
    """Every edge masked: no tile holds a position, and every row of every
    share is written once, as zeros."""
    x, geo, em, ws, send, recv, _ = _fwd_case(48, 48, eq)
    n = x.shape[0]
    em = torch.zeros_like(em)
    perm = _sender_perm(send, em, n)
    row_ptr = _schedule(send, em, perm, n)
    assert int(row_ptr[-1]) == 0
    per_edge, ok = _per_edge(eq, x, geo, em, ws, send, recv)
    got, written = _walk(per_edge, send, perm, ok, row_ptr, 5)
    assert bool((written == 1).all()) and float(got.abs().max()) == 0
    agg, _ = egcl_mp.egcl_block_reference(eq, x, geo, em, *ws, send, recv)
    assert float(agg.abs().max()) == 0


@pytest.mark.parametrize("equivariant", [True, False],
                         ids=["equivariant", "last-layer"])
def test_egcl_fwd_walk_matches_jax(equivariant, monkeypatch):
    """The forward as route 1 walks it equals the JAX op's forward
    (interpret mode; the batch and inputs of tests/test_torch_egnn.py,
    whose collate gives the sender permutation) at that file's forward
    tolerance."""
    g, args, _, _ = _block_case(monkeypatch, 9, equivariant, 2, True)
    s, r, p, em = _ids(g)
    full = [jnp.asarray(a) for a in args] + [None] * (9 - len(args))
    jagg, jpsum = j_egcl(equivariant, *full[:2], jnp.asarray(em), *full[2:],
                         jnp.asarray(s), jnp.asarray(r), jnp.asarray(p))
    ts = [torch.from_numpy(a) for a in args]
    ws = ts[2:] + [None] * (9 - len(ts))
    st, rt, pt, emt = (torch.from_numpy(v) for v in (s, r, p, em))
    n = ts[0].shape[0]
    per_edge, ok = _per_edge(equivariant, ts[0], ts[1], emt, ws, st, rt)
    got, written = _walk(per_edge, st, pt, ok,
                         _schedule(st, emt, pt, n), 5)
    assert bool((written == 1).all()) and float(got.abs().max()) > 0
    h = ws[2].shape[0]
    np.testing.assert_allclose(got[:, :h].numpy(), np.asarray(jagg),
                               **FWD_TOL)
    if equivariant:
        np.testing.assert_allclose(got[:, h:].numpy(),
                                   np.asarray(jpsum)[:, :3], **FWD_TOL)


@pytest.mark.parametrize("f,h,gp,eq,route", [
    (48, 48, 1, True, 1), (48, 48, 1, False, 1), (32, 32, 1, False, 1),
    (32, 32, 4, True, 1), (1, 48, 1, True, 1), (48, 33, 1, True, 1),
    (8, 8, 15, True, 1), (8, 8, 16, True, 2), (48, 64, 1, True, 2),
    (64, 48, 1, False, 2), (128, 128, 4, True, 2), (128, 32, 1, True, 2)])
def test_egcl_fwd_route_by_width(f, h, gp, eq, route):
    """The forward's route 1 at pass S's route-1 widths (F, H <= 48, gp <=
    15: md17's layers 0-3 and oc22's); the first design past that."""
    assert egcl_mp.fwd_route(f, h, gp, eq) == route
    assert egcl_mp.pass_s_route(f, h, gp, eq) == route


@pytest.mark.parametrize("f,route,op", [
    (64, 1, "egcl_block"), (48, 3, "egcl_block"),
    (48, 1, "egcl_block_pass_p")],
    ids=["route-1-past-its-widths", "no-such-route", "pass-p-takes-none"])
def test_egcl_fwd_route_refusals(f, route, op):
    """``launch_egcl`` refuses route 1 where the widths do not take it, a
    route that does not exist, and any route for pass P, before it looks
    for the library."""
    x, geo, em, ws, send, recv, perm = _fwd_case(f, 48, True)
    n = x.shape[0]
    kw = egcl_mp.kernel_weights(True, *ws, f, 48, x.device)
    extra = {}
    if op == "egcl_block_pass_p":
        extra = dict(gagg=torch.zeros(n, 48), gpsum=torch.zeros(n, 3))
    with pytest.raises(ValueError, match="route"):
        egcl_mp.launch_egcl(op, True, x, geo, kw, send, recv, perm,
                            _schedule(send, em, perm, n), route=route,
                            **extra)
