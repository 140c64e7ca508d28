"""The builder's pass P as route 1 of its kernel walks it
(csrc/dn_tri_builder.cu ``wgtc::wgrad_tc_kernel``), written out in torch on
the CPU.

- ji order, positions as triplet ids: warp ``w`` of ``8 x blocks`` owns
  the ji rows of share ``w`` of
  :func:`~hydragnn_torch.ops.aggregate.row_shares` over the ji CSR (rows
  plus triplets balanced) and walks their positions in 16-triplet tiles.
- Per tile: ``emb1 = sbf . K1``, ``d_emb2 = dout[ji] * x[kj]`` and
  ``d_emb1 = d_emb2 . K2^T`` on the taken triplets (rows of no real
  triplet zero); the tile's ``emb1^T d_emb2`` and ``sbf^T d_emb1`` added
  into the warp's float32 sums in tile order.
- The block adds its eight warps' sums in warp order; the blocks' partials
  are added in block order.

Held to ``dimenet_tri_builder_pass_p_plain`` at 1e-4 of each gradient's
largest entry and once to the JAX op's dk1, dk2 (the reference builder in
interpret mode, at tests/test_torch_dn_tri_builder.py's tolerance).  And
pass P's route by width, with its refusals.
"""

import numpy as np
import pytest
import torch

from hydragnn_torch.ops import dn_tri
from hydragnn_torch.ops.aggregate import row_shares, segment_offsets
from test_torch_dn_tri_builder import WGRAD_TOL, _case, _jax

WARPS = 8
TILE = 16


def _plan(row_ptr, n_blocks):
    """Route 1's shares and tiles: ``(bounds, tiles)``, ``tiles`` a list
    per warp (block ``b``'s warp ``w`` is ``8 b + w``) of ``(begin, end)``
    position ranges in walking order."""
    bounds = row_shares(row_ptr, n_blocks * WARPS)
    ptr = row_ptr.long()
    tiles = []
    for w in range(n_blocks * WARPS):
        p0, p1 = int(ptr[int(bounds[w])]), int(ptr[int(bounds[w + 1])])
        tiles.append([(q, min(q + TILE, p1)) for q in range(p0, p1, TILE)])
    return bounds, tiles


def _walk(x, sbf, tmask, k1, k2, kj, ji, dout, n_blocks):
    """dk1, dk2 as route 1 sums them, and each warp's own sums."""
    e = x.shape[0]
    row_ptr = segment_offsets(ji, e, tmask)
    bounds, tiles = _plan(row_ptr, n_blocks)
    zero = torch.zeros(())
    per_warp = []
    for w in range(n_blocks * WARPS):
        rb, re = int(bounds[w]), int(bounds[w + 1])
        a1 = torch.zeros(k1.shape)
        a2 = torch.zeros(k2.shape)
        for q0, q1 in tiles[w]:
            pos = torch.arange(q0, q1)
            k, j = kj[pos].long(), ji[pos].long()
            take = ((k >= 0) & (k < e) & (j >= rb) & (j < re))[:, None]
            s = torch.where(take, sbf[pos], zero)
            d2 = torch.where(take, dout[j.clamp(0, e - 1)]
                             * x[k.clamp(0, e - 1)], zero)
            e1 = s @ k1
            de1 = d2 @ k2.t()
            a2 = a2 + e1.t() @ d2
            a1 = a1 + s.t() @ de1
        per_warp.append((a1, a2))
    dk1, dk2 = torch.zeros(k1.shape), torch.zeros(k2.shape)
    for blk in range(n_blocks):
        p1, p2 = torch.zeros(k1.shape), torch.zeros(k2.shape)
        for w in range(WARPS):
            a1, a2 = per_warp[blk * WARPS + w]
            p1, p2 = p1 + a1, p2 + a2
        dk1, dk2 = dk1 + p1, dk2 + p2
    return dk1, dk2, per_warp, tiles


def _table(sr, b, d, seed=0, all_masked=False):
    """60 edges and 420 triplet slots: idx_ji nondecreasing, ji row 5 holds
    45 triplets (it straddles 16-triplet tiles), ji rows 0, 9 and the last
    four hold none, one real triplet's kj lies outside [0, E), a masked
    tail of 60 is parked on the last edge."""
    rng = np.random.RandomState(seed + sr + b + d)
    e, t, real = 60, 420, 360
    ji = rng.randint(1, e - 4, real)
    ji[:45] = 5
    ji[ji == 9] = 10
    ji = np.sort(ji)
    kj = rng.randint(0, e - 1, real)
    kj[real // 2] = e + 3
    pad = np.full(t - real, e - 1)
    kj, ji = (torch.from_numpy(np.concatenate([v, pad]).astype(np.int32))
              for v in (kj, ji))
    tm = torch.from_numpy((np.arange(t) < real).astype(np.int32))
    if all_masked:
        tm = torch.zeros_like(tm)
    x, sbf, k1, k2, dout = (torch.from_numpy(a.astype(np.float32)) for a in (
        rng.randn(e, d), rng.randn(t, sr) * 0.5,
        rng.randn(sr, b) / np.sqrt(sr), rng.randn(b, d) / np.sqrt(b),
        rng.randn(e, d)))
    return x, sbf, tm, k1, k2, kj, ji, dout


@pytest.mark.parametrize("n_blocks", [1, 3, 132])
def test_builder_pass_p_tiles_cover_every_triplet_once(n_blocks):
    """Route 1's warps: each owns the ji rows of its share and their
    positions in 16-triplet tiles, in order; every real triplet lies in
    exactly one tile, masked ones in none, and some ji row straddles two
    tiles."""
    x, _, tm, _, _, _, ji, _ = _table(42, 8, 128)
    row_ptr = segment_offsets(ji, x.shape[0], tm)
    bounds, tiles = _plan(row_ptr, n_blocks)
    assert int(bounds[0]) == 0 and int(bounds[-1]) == x.shape[0]
    seen = torch.zeros(len(ji), dtype=torch.long)
    straddle = False
    for w, ts in enumerate(tiles):
        p0 = int(row_ptr[int(bounds[w])])
        p1 = int(row_ptr[int(bounds[w + 1])])
        q = p0
        for a, b in ts:
            assert a == q and 0 < b - a <= TILE
            assert b - a == TILE or b == p1
            seen[a:b] += 1
            if a > p0:
                straddle |= bool(ji[a] == ji[a - 1])
            q = b
        assert q == p1
    assert bool((seen[tm != 0] == 1).all()) and int(seen[tm == 0].sum()) == 0
    assert straddle


@pytest.mark.parametrize("n_blocks", [1, 3, 132])
@pytest.mark.parametrize("sr,b,d", [(42, 8, 128), (21, 8, 96), (43, 5, 24),
                                    (64, 8, 8)])
def test_builder_pass_p_walk_matches_plain(sr, b, d, n_blocks):
    """dk1 and dk2 as route 1 sums them (tile by tile in each warp's
    float32 sums, then the block's warps in warp order, then the blocks in
    order) equal the plain pass P within 1e-4 of each gradient's largest
    entry at dimenet_wide's widths (42, 8, 128), the JAX tests' (21, 8,
    96), an odd S*R with B < 8 and route 1's limits (64, 8, 8); a warp
    whose share holds no triplet adds exact zeros."""
    args = _table(sr, b, d)
    dk1, dk2, per_warp, tiles = _walk(*args, n_blocks)
    want = dn_tri.dimenet_tri_builder_pass_p_plain(*args)
    for got, w in zip((dk1, dk2), want):
        scale = float(w.abs().max())
        assert scale > 0
        assert float((got - w).abs().max()) <= WGRAD_TOL * scale
    idle = [i for i, ts in enumerate(tiles) if not ts]
    assert bool(idle) or n_blocks < 132
    for i in idle:
        assert all(float(a.abs().max()) == 0 for a in per_warp[i])


def test_builder_pass_p_walk_all_masked():
    """Every triplet masked: no tile holds a position, dk1 and dk2 exact
    zeros."""
    args = _table(42, 8, 128, all_masked=True)
    dk1, dk2, _, tiles = _walk(*args, 3)
    assert not any(tiles)
    assert float(dk1.abs().max()) == 0 and float(dk2.abs().max()) == 0


@pytest.mark.parametrize("sr,b,d", [(21, 8, 96), (42, 8, 128)])
def test_builder_pass_p_walk_matches_jax(sr, b, d, monkeypatch):
    """dk1 and dk2 as route 1 sums them against the JAX builder op's
    gradients (interpret mode under ``jax.vjp``; the tables of
    tests/test_torch_dn_tri_builder.py) at that file's tolerance."""
    args, ids, tmask, wa = _case(monkeypatch, sr, b, d)
    kj, ji, _ = ids
    ts = [torch.from_numpy(a) for a in args]
    dk1, dk2, _, _ = _walk(ts[0], ts[1], tmask, ts[2], ts[3], kj, ji,
                           torch.from_numpy(wa), 3)
    _, jgrads = _jax(args, ids, tmask, wa)
    for got, w in zip((dk1, dk2), jgrads[2:]):
        scale = float(np.abs(w).max())
        assert scale > 0
        assert float(np.abs(got.numpy() - w).max()) <= WGRAD_TOL * scale


@pytest.mark.parametrize("sr,b,d,route", [
    (42, 8, 128, 1), (21, 8, 96, 1), (43, 5, 24, 1), (64, 8, 8, 1),
    (1, 1, 8, 1), (65, 8, 128, 2), (42, 9, 128, 2), (42, 8, 124, 2),
    (70, 8, 64, 2), (126, 128, 128, 2), (127, 33, 1, 2)])
def test_builder_pass_p_route_by_width(sr, b, d, route):
    """Pass P's route 1 at the forward's route-1 widths (B <= 8, S*R <=
    64, D a multiple of 8: dimenet_wide's among them); the first design
    past that."""
    assert dn_tri.builder_bwd_p_route(sr, b, d) == route
    assert dn_tri.builder_fwd_route(sr, b, d) == route


@pytest.mark.parametrize("sr,b,d,route,op", [
    (70, 8, 64, 1, "dimenet_tri_builder_bwd_p"),
    (42, 8, 128, 3, "dimenet_tri_builder_bwd_p"),
    (42, 8, 128, 2, "dimenet_tri_builder")],
    ids=["route-1-past-its-widths", "no-such-route", "forward-takes-none"])
def test_builder_pass_p_route_refusals(sr, b, d, route, op):
    """``launch_dn_tri_builder`` refuses route 1 where the widths do not
    take it, a route that does not exist, and any route for the forward
    (and pass S), before it looks for the library."""
    x, sbf, tm, k1, k2, kj, ji, dout = _table(sr, b, d)
    with pytest.raises(ValueError, match="route"):
        dn_tri.launch_dn_tri_builder(
            op, x, sbf, k1, k2, kj, ji, None,
            segment_offsets(ji, x.shape[0], tm), dout, route=route)
