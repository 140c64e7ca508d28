"""The sender-side backward passes of CGCNN and GAT as their kernels
compute them (GAT: route 1), written out in torch on the CPU.

- cgcnn pass S (csrc/cgcnn_mp.cu ``cgcnn_pass_s_sums_kernel`` and
  ``cgcnn_row_product_kernel``): pass P's node table ``T = x @ [Wfr | Wsr |
  Wfs | Wss]``, per sender row the sums of ``(dtf, dts)`` over its edges in
  sender-position order (tf, ts gathered sums from the table), then one
  row product ``[sum dtf | sum dts] @ [Wfs | Wss]^T``.  Held to
  ``cgcnn_pass_s_plain`` (1e-5 of the largest entry) and, with pass P's
  receiver side, to the JAX op's gradient in interpret mode (the
  tolerance of tests/test_torch_cgcnn.py).
- gat pass S (csrc/gat_mp.cu ``gat_pass_s_kernel``): each head's logit and
  ``q = <ga[dst], xl[src]>_h`` summed across a warp's lanes, each lane's
  slots of the head first, then the butterfly of offsets 16, 8, 4, 2, 1.
  Held to ``gat_pass_s_plain`` and to autograd through the plain forward
  at 1e-5 of dxl's largest entry: the logits are summed in another order
  than the forward's (lane order), so ``p = exp(e - m)`` moves by a
  rounding of ``e`` (a few 1e-7 relative), far inside that.
- the route of gat pass S by width, as ``hg_gat_pass_s_route`` decides it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hydragnn_torch.ops import cgcnn_mp, egcl_mp, gat_mp
from hydragnn_torch.ops.aggregate import segment_offsets
from test_torch_cgcnn import GRAD_TOL, _ids, _op_case
from hydragnn_tpu.ops.cgcnn_mp import cgcnn_gated_block as j_cgcnn


def _close(got, want, rel=1e-5):
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= rel * scale


def _in_position_order(values, row_ptr, n):
    """``out[row] = sum over the row's positions k, in order, of
    values[k]``: the k-th position of every row added in step k, as one
    warp a row adds them; positions past the ranges add nothing."""
    row_ptr = row_ptr.long()
    start, deg = row_ptr[:-1], row_ptr[1:] - row_ptr[:-1]
    out = torch.zeros((n, values.shape[1]), dtype=values.dtype)
    for k in range(int(deg.max())):
        rows = torch.nonzero(deg > k)[:, 0]
        out[rows] += values[start[rows] + k]
    return out


# ---------------------------------------------------------------------------
# cgcnn pass S
# ---------------------------------------------------------------------------

def _cgcnn_pass_s_tabled(x, edge_attr, em, kf, bf, ks, bs, senders,
                         receivers, sender_perm, gout):
    """cgcnn pass S as its kernels compute it: ``dx_sender [N, F]``."""
    n, f = x.shape
    d = kf.shape[1]
    kfr, kfs, kfg = egcl_mp.split_weights(kf, f)
    ksr, kss, ksg = egcl_mp.split_weights(ks, f)
    # pass P's node table, which the backward hands to pass S
    table = x @ torch.cat([kfr, ksr, kfs, kss], dim=1)
    eid = sender_perm.long()
    s = senders.long()[eid].clamp(0, n - 1)
    r_raw = receivers.long()[eid]
    ok = (r_raw >= 0) & (r_raw < n)
    r = r_raw.clamp(0, n - 1)
    tf = (table[s, 2 * d:3 * d] + bf) + table[r, :d]
    ts = (table[s, 3 * d:] + bs) + table[r, d:2 * d]
    if edge_attr is not None:
        tf = tf + edge_attr[eid] @ kfg
        ts = ts + edge_attr[eid] @ ksg
    g = gout[r]
    sg = torch.sigmoid(tf)
    sps = torch.where(ts > 20.0, torch.ones_like(ts), torch.sigmoid(ts))
    dtf = g * F.softplus(ts) * (sg * (1.0 - sg))
    dts = g * sg * sps
    zero = torch.zeros((), dtype=x.dtype)
    both = torch.where(ok[:, None], torch.cat([dtf, dts], dim=1), zero)
    row_ptr = segment_offsets(senders[eid], n, em[eid])
    sums = _in_position_order(both, row_ptr, n)
    return sums @ torch.cat([kfs, kss], dim=1).t()


def _cgcnn_sender_case(f, a, d, all_masked, seed=0):
    """A receiver-sorted batch of 60 nodes: a hub sender (node 3, over 100
    edges: four groups of 32 ids), a node with no edge (7), a sender
    outside [0, N), and a masked tail parked on the last node (every edge
    masked when asked); the sender permutation the stable argsort."""
    rng = np.random.RandomState(seed + f + a + d)
    n, e, real = 60, 420, 360
    recv = np.sort(rng.randint(0, n - 1, real))
    recv[recv == 7] = 8
    send = rng.randint(0, n - 1, real)
    send[rng.permutation(real)[:110]] = 3
    send[send == 7] = 8
    send[real // 2] = n + 3
    pad = np.full(e - real, n - 1)
    em = (np.arange(e) < (0 if all_masked else real)).astype(np.int32)
    ins = [rng.randn(n, f), rng.randn(e, a) * 0.5 if a else None,
           rng.randn(2 * f + a, d) / (2 * f + a) ** 0.5, rng.randn(d) * 0.1,
           rng.randn(2 * f + a, d) / (2 * f + a) ** 0.5, rng.randn(d) * 0.1]
    ins = [None if v is None else torch.from_numpy(v.astype(np.float32))
           for v in ins]
    send, recv = (np.concatenate([v, pad]).astype(np.int32)
                  for v in (send, recv))
    perm = np.argsort(send, kind="stable").astype(np.int32)
    gout = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    return ins, torch.from_numpy(em), [torch.from_numpy(v)
                                       for v in (send, recv, perm)], gout


@pytest.mark.parametrize("all_masked", [False, True],
                         ids=["masked-tail", "all-masked"])
@pytest.mark.parametrize("f,a,d", [(64, 0, 64), (24, 5, 16)])
def test_cgcnn_pass_s_tabled_matches_plain(f, a, d, all_masked):
    """cgcnn pass S as its kernels compute it (the node table, per-sender
    sums in position order, one row product) equals the plain pass S at
    the path's widths and at (24, 5, 16), 1e-5 of the largest entry; the
    row without an edge and the all-masked batch give exact zeros."""
    ins, em, (send, recv, perm), gout = _cgcnn_sender_case(f, a, d,
                                                           all_masked)
    got = _cgcnn_pass_s_tabled(ins[0], ins[1], em, *ins[2:], send, recv,
                               perm, gout)
    want = cgcnn_mp.cgcnn_pass_s_plain(ins[0], ins[1], em, *ins[2:], send,
                                       recv, gout)
    if all_masked:
        assert float(got.abs().max()) == 0
        return
    _close(got, want)
    assert float(got[7].abs().max()) == 0


@pytest.mark.parametrize("f,a,d", [(64, 0, 64), (24, 5, 16)],
                         ids=["path", "edge-attr"])
def test_cgcnn_pass_s_tabled_matches_jax(f, a, d, monkeypatch):
    """Pass P's receiver side plus pass S as its kernels compute it equals
    the JAX op's dx (interpret mode; the batch and inputs of
    tests/test_torch_cgcnn.py) at that file's gradient tolerance."""
    g, args, wa = _op_case(monkeypatch, 41 + a, f, a, d)
    s, r, p, em = _ids(g)

    def jloss(x):
        ea = None if args[1] is None else jnp.asarray(args[1])
        out = j_cgcnn(x, ea, jnp.asarray(em),
                      *(jnp.asarray(v) for v in args[2:]), jnp.asarray(s),
                      jnp.asarray(r), jnp.asarray(p))
        return jnp.sum(out * wa)

    jdx = np.asarray(jax.grad(jloss)(jnp.asarray(args[0])))
    ts = [None if v is None else torch.from_numpy(v) for v in args]
    st, rt, pt, emt = (torch.from_numpy(v) for v in (s, r, p, em))
    ct = torch.from_numpy(wa)
    dx_r = cgcnn_mp.cgcnn_pass_p_plain(ts[0], ts[1], emt, *ts[2:], st, rt,
                                       ct)[5]
    dx_s = _cgcnn_pass_s_tabled(ts[0], ts[1], emt, *ts[2:], st, rt, pt, ct)
    assert float(dx_s.abs().max()) > 0
    np.testing.assert_allclose((dx_r + dx_s).numpy(), jdx, **GRAD_TOL)


# ---------------------------------------------------------------------------
# gat pass S
# ---------------------------------------------------------------------------

def _lane_head_sums(v, h, f):
    """Per head, the sum of ``v [E, H*F]`` over the head's columns as the
    kernel adds them: lane l holds columns 32 i + l of the head (slot i),
    adds its slots in order, then ``v += v[lane ^ o]`` for o = 16, 8, 4,
    2, 1; every lane ends with the same sum.  Returns ``[E, H]``."""
    e_, slots = v.shape[0], -(-f // 32)
    pad = torch.zeros((e_, h, slots * 32), dtype=v.dtype)
    pad[:, :, :f] = v.reshape(e_, h, f)
    lanes = pad.reshape(e_, h, slots, 32)
    run = lanes[:, :, 0]
    for i in range(1, slots):
        run = run + lanes[:, :, i]
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        run = run + run[:, :, idx ^ o]
    assert torch.equal(run, run[:, :, :1].expand_as(run))
    return run[:, :, 0]


def _gat_pass_s_lanes(xl, xr, att, senders, receivers, edge_mask, b_edge, m,
                      ga, gd, slope, sender_perm):
    """gat pass S as route 1 computes it: ``dxl [N, H*F]`` (and the edges'
    logits, in sender-position order)."""
    n = xl.shape[0]
    h, f = att.shape
    p = sender_perm.long()
    ok, s, r = gat_mp._valid_edges(edge_mask[p], senders[p], receivers[p],
                                   n)
    xs, xt = xl[s], xr[r]
    z = xs + xt
    zl = torch.where(z > 0, z, z * slope)
    e = _lane_head_sums(zl * att.reshape(1, -1), h, f)
    q = _lane_head_sums(ga[r] * xs, h, f)
    zero = torch.zeros((), dtype=xl.dtype)
    pe = torch.where(ok[:, None], torch.exp(e - m[r]), zero)
    bb = torch.ones_like(pe) if b_edge is None else b_edge[p]
    pb, de = pe * bb, pe * (bb * q + gd[r])
    att_row = att.reshape(1, -1)
    dz = gat_mp._expand(de, f) * torch.where(z > 0, att_row,
                                             att_row * slope)
    contrib = gat_mp._expand(pb, f) * ga[r] + dz
    row_ptr = segment_offsets(senders[p], n, edge_mask[p])
    return _in_position_order(contrib, row_ptr, n), e[ok]


def _gat_case(h, f, bits, seed=0):
    """A receiver-sorted batch of 50 nodes: a hub sender (node 2, 70
    edges: three groups of 32 ids), node 5 sends and receives nothing,
    node 9 receives only, a masked tail parked on the last node."""
    rng = np.random.RandomState(seed + h + f)
    n, e, real = 50, 300, 260
    recv = np.sort(rng.randint(0, n - 1, real))
    recv[recv == 5] = 6
    send = rng.randint(0, n - 1, real)
    send[rng.permutation(real)[:70]] = 2
    send[(send == 5) | (send == 9)] = 10
    pad = np.full(e - real, n - 1)
    send, recv = (np.concatenate([v, pad]).astype(np.int32)
                  for v in (send, recv))
    perm = np.argsort(send, kind="stable").astype(np.int32)
    mask = (np.arange(e) < real).astype(np.float32)
    hf = h * f
    vals = [rng.randn(n, hf), rng.randn(n, hf), rng.randn(h, f) / f ** 0.5,
            rng.randn(n, hf), rng.randn(n, h)]
    b = ((rng.rand(e, h) < 0.75) / 0.75) if bits else None
    xl, xr, att, ca, cd = (torch.from_numpy(v.astype(np.float32))
                           for v in vals)
    b = None if b is None else torch.from_numpy(b.astype(np.float32))
    ids = [torch.from_numpy(v) for v in (send, recv, perm)]
    return (xl, xr, att, ca, cd, b), ids, torch.from_numpy(mask)


@pytest.mark.parametrize("bits", [False, True], ids=["ones", "dropout"])
@pytest.mark.parametrize("h,f", [(3, 12), (6, 64)])
def test_gat_pass_s_lane_sums_match_plain(h, f, bits):
    """gat pass S as route 1 computes it (head sums across lanes, then the
    butterfly) equals the plain pass S and autograd's dxl through the
    plain forward within 1e-5 of dxl's largest entry, at a width that does
    not divide 32 (3 x 12) and the gat cell's (6 x 64), with and without
    dropout bits; its logits lie within a rounding of the forward's (lane
    order); rows that send no real edge get exact zeros."""
    (xl, xr, att, ca, cd, b), (send, recv, perm), mask = _gat_case(h, f,
                                                                   bits)
    slope = 0.05
    leaf = xl.clone().requires_grad_(True)
    acc, m, d = gat_mp.gat_edge_attention_reference(leaf, xr, att, send,
                                                    recv, mask, b, slope)
    ((acc * ca).sum() + (d * cd).sum()).backward()
    got, e_lanes = _gat_pass_s_lanes(xl, xr, att, send, recv, mask, b, m,
                                     ca, cd, slope, perm)
    want = gat_mp.gat_pass_s_plain(xl, xr, att, send, recv, mask, b, m, ca,
                                   cd, slope)
    _close(got, want)
    _close(got, leaf.grad)
    p = perm.long()
    ok = (mask[p] != 0)
    e_fwd, _, _ = gat_mp.edge_logits(xl[send.long()[p][ok]],
                                     xr[recv.long()[p][ok]], att, slope)
    _close(e_lanes, e_fwd, rel=1e-6)
    assert float(got[5].abs().max()) == 0 and float(got[9].abs().max()) == 0


@pytest.mark.parametrize("hf,f,route", [
    (384, 64, 1), (768, 256, 1), (36, 12, 1), (32, 8, 1), (40, 10, 1),
    (512, 32, 1), (1024, 128, 1), (1024, 256, 1), (96, 96, 1), (40, 1, 2),
    (384, 16, 2), (384, 8, 2), (1020, 12, 2), (960, 48, 2), (1024, 512, 2),
    (1024, 1024, 2)])
def test_gat_pass_s_route_by_width(hf, f, route):
    """Pass S's route 1 (head sums across lanes) where a head takes at
    most 8 slots of 32 lanes (F <= 256), the heads at most 32 slots and
    there are at most 16 heads: the gat cell's 6 x 64 and gat_h256's head
    groups of 3 x 256 among them; the first design past that (many narrow
    heads, F > 256)."""
    assert gat_mp.pass_s_route(hf, f) == route


@pytest.mark.parametrize("f,slots", [(1, 1), (32, 1), (33, 2), (64, 2),
                                     (65, 4), (128, 4), (129, 8), (256, 8),
                                     (257, 0)])
def test_gat_pass_s_head_slots(f, slots):
    """A head's slots in route 1: ceil(F / 32) rounded up to 1, 2, 4, 8."""
    assert gat_mp.head_slots(f) == slots
