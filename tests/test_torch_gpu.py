"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; every test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so it also runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py sets up JAX for the rest of the
suite).  Tolerance 1e-5 at kernel level: float32 sums, the plain
version's ``index_add_`` adds in another order on the card; 1e-4 for the
edge-summed weight grads and at model level.  Covered: the forward
kernels, the backward (dx passes, the pool's gather), the three scf
kernels through their autograd Function (the forward's and pass S's two
routes, route 1 against a float64 run), the SchNet forward, three
training steps at the flagship width and the wide one, the two poly
kernels at every width gate (forward and, through their autograd
Functions, backward with ties), three PNA/GIN/SAGE/MFC training steps,
the three egcl kernels at every width the EGNN gate admits (both routes
of pass P, a float64 yardstick, a NaN in the cotangent) and on an
all-masked batch, three
EGNN training steps at md17's widths (pass S's two routes alone), the
three GAT kernels at H*F from 32 to the kernel limit of 1024, with and
without dropout bits (the forward's, pass R's and pass S's two routes
alone), three GAT
training steps in lockstep, the three cgcnn kernels at F from 1 to the
limit of 256 with and without edge attributes, three CGCNN training
steps in lockstep at F = 64, the pallas backend's two segment sums, a
double backward through the linear Functions, card against CPU, the
dn_tri and row_mlp kernels at every width their gates admit (the dn_tri
and row_mlp forwards' two routes), three
DimeNet training steps in lockstep at the arch sweep's widths, the
builder's three kernels from the dimenet_wide cell's widths to the limits
(both routes of the forward, a float64 yardstick, NaNs in its inputs),
and three DimeNet training steps at dimenet_wide's widths in lockstep,
with and without HYDRAGNN_DIMENET_REMAT.
"""

import numpy as np
import pytest
import torch

from hydragnn_torch.ops import fused_mp as tfm

TOL = dict(rtol=1e-5, atol=1e-5)


def _graph_batch(seed, n_real=290, n_pad=304, e_pad=2560, hub=0):
    """Collate-shaped arrays: contiguous graphs of <= 60 nodes (~3 node
    blocks in all), intra-graph edges sorted by receiver, some nodes with
    no incoming edge, padding edges parked on node N-1 with mask 0.
    ``hub`` > 0 gives node 0 that many more incoming edges, so that its
    row spans several edge tiles and edge shares of the kernels."""
    rng = np.random.RandomState(seed)
    send, recv, gid = [], [], []
    if hub:
        send.append(rng.randint(0, 5, hub))
        recv.append(np.zeros(hub, np.int64))
    off, g = 0, 0
    while off < n_real:
        size = min(int(rng.randint(5, 61)), n_real - off)
        n_e = int(rng.randint(0, 6 * size + 1))
        dst = np.sort(rng.randint(0, max(size - 2, 1), n_e))  # last nodes: no in-edges
        src = rng.randint(0, size, n_e)
        send.append(src + off)
        recv.append(dst + off)
        gid.append(np.full(size, g))
        off += size
        g += 1
    send, recv = np.concatenate(send), np.concatenate(recv)
    e_real = len(send)
    assert e_real < e_pad
    senders = np.full(e_pad, n_pad - 1, np.int32)
    receivers = np.full(e_pad, n_pad - 1, np.int32)
    senders[:e_real], receivers[:e_real] = send, recv
    edge_mask = np.zeros(e_pad, np.float32)
    edge_mask[:e_real] = 1.0
    node_gid = np.full(n_pad, g, np.int32)
    node_gid[:n_real] = np.concatenate(gid)
    node_mask = np.zeros(n_pad, np.float32)
    node_mask[:n_real] = 1.0
    perm = np.argsort(senders, kind="stable").astype(np.int32)
    return dict(senders=senders, receivers=receivers, edge_mask=edge_mask,
                node_gid=node_gid, node_mask=node_mask, perm=perm,
                n_graphs=g + 1, rng=rng)



# the id patterns the unsorted segment sum is held on (here and in
# tests/test_torch_unsorted_sum_plan.py)
ID_PATTERNS = ("sorted", "padded_tail", "shuffled", "graph_blocked",
               "out_of_range_tail", "all_out_of_range", "empty_segments",
               "no_ids")


def _id_pattern(name, seed=0):
    """(ids int32 [E], num_segments) of a collate-shaped batch: its
    receivers (sorted; ``padded_tail``: the masked tail on node N-1, as
    collate parks it), a shuffled copy, its senders (blocked by graph,
    unsorted within one), senders with an out-of-range tail, ids all
    outside ``[0, N)``, receivers over every third node only (empty
    segments), and no ids at all."""
    b = _graph_batch(40 + seed)
    n = len(b["node_gid"])
    rng = np.random.RandomState(seed)
    recv, send, mask = b["receivers"], b["senders"], b["edge_mask"]
    real = recv[mask != 0]
    ids = {
        "sorted": lambda: real,
        "padded_tail": lambda: recv,
        "shuffled": lambda: rng.permutation(recv),
        "graph_blocked": lambda: send[mask != 0],
        "out_of_range_tail": lambda: np.where(
            mask != 0, send, n + np.arange(len(send)) % 3),
        "all_out_of_range": lambda: np.where(
            rng.rand(len(recv)) < 0.5, -1 - recv, n + recv),
        "empty_segments": lambda: (real // 3) * 3,
        "no_ids": lambda: np.zeros(0, np.int64),
    }[name]()
    return np.asarray(ids, np.int32), n


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written kernels)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_match_plain_on_card(cuda):
    b = _graph_batch(5)
    n, e = len(b["node_gid"]), len(b["senders"])
    g = torch.Generator().manual_seed(0)
    x = torch.randn(n, 64, generator=g).to(cuda)
    w = (torch.randn(e, 64, generator=g) * _t(b["edge_mask"])[:, None]).to(cuda)
    send, recv = _t(b["senders"]).to(cuda), _t(b["receivers"]).to(cuda)
    mask = _t(b["edge_mask"]).to(cuda)
    tfm.reset_launches()
    with torch.inference_mode():
        k = tfm.gather_mul_segment_sum(x, w, send, recv, None, edge_valid=mask)
        p = tfm.gather_mul_segment_sum_plain(x, w, send, recv, edge_valid=mask)
        torch.cuda.synchronize()
        torch.testing.assert_close(k, p, **TOL)
        k = tfm.gather_segment_sum(x, send, recv, None, mask)
        p = tfm.gather_mul_segment_sum_plain(x, None, send, recv,
                                             edge_valid=mask, mask=mask)
        torch.cuda.synchronize()
        torch.testing.assert_close(k, p, **TOL)
        k = tfm.segment_sum_dense(w, recv, n, valid=mask)
        p = tfm.segment_sum_dense_plain(w, recv, n, valid=mask)
        torch.cuda.synchronize()
        torch.testing.assert_close(k, p, **TOL)
    assert tfm.LAUNCHES == {"gather_mul_segment_sum": 1,
                            "gather_mul_segment_sum_dx": 0,
                            "gather_segment_sum": 1,
                            "gather_segment_sum_dx": 0,
                            "segment_sum_dense": 1}


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda):
    b = _graph_batch(6, n_real=40, n_pad=48, e_pad=512)
    send, recv = _t(b["senders"]).to(cuda), _t(b["receivers"]).to(cuda)
    x = torch.randn(48, 8, device=cuda)
    w = torch.randn(512, 8, device=cuda)
    with pytest.raises(TypeError):
        tfm.gather_mul_segment_sum(x.double(), w.double(), send, recv, None)


def _grads(fn, inputs, ct):
    ts = [t.detach().clone().requires_grad_(True) for t in inputs]
    fn(*ts).backward(ct)
    return [t.grad for t in ts]


@pytest.mark.gpu
def test_backward_on_card_matches_plain(cuda):
    """The ops' backward on the card (dx: the kernel on the sender-sorted
    ordering, under its own launch count) against autograd through the
    plain versions on the card; dw on real edges."""
    b = _graph_batch(7)
    n, e = len(b["node_gid"]), len(b["senders"])
    g = torch.Generator().manual_seed(1)
    x = torch.randn(n, 64, generator=g).to(cuda)
    w = (torch.randn(e, 64, generator=g) * _t(b["edge_mask"])[:, None]).to(cuda)
    ct = torch.randn(n, 64, generator=g).to(cuda)
    send, recv = _t(b["senders"]).to(cuda), _t(b["receivers"]).to(cuda)
    perm, mask = _t(b["perm"]).to(cuda), _t(b["edge_mask"]).to(cuda)
    real = mask != 0
    tfm.reset_launches()
    k = _grads(lambda x_, w_: tfm.gather_mul_segment_sum(
        x_, w_, send, recv, perm, edge_valid=mask), (x, w), ct)
    p = _grads(lambda x_, w_: tfm.gather_mul_segment_sum_plain(
        x_, w_, send, recv, edge_valid=mask), (x, w), ct)
    torch.cuda.synchronize()
    torch.testing.assert_close(k[0], p[0], **TOL)
    torch.testing.assert_close(k[1][real], p[1][real], **TOL)
    k = _grads(lambda x_: tfm.gather_segment_sum(x_, send, recv, perm, mask),
               (x,), ct)
    p = _grads(lambda x_: tfm.gather_mul_segment_sum_plain(
        x_, None, send, recv, edge_valid=mask, mask=mask), (x,), ct)
    torch.testing.assert_close(k[0], p[0], **TOL)
    gid = _t(b["node_gid"]).to(cuda)
    cg = torch.randn(b["n_graphs"], 64, generator=g).to(cuda)
    k = _grads(lambda d: tfm.segment_sum_dense(d, gid, b["n_graphs"]),
               (x,), cg)
    p = _grads(lambda d: tfm.segment_sum_dense_plain(d, gid, b["n_graphs"]),
               (x,), cg)
    torch.testing.assert_close(k[0], p[0], **TOL)
    assert tfm.LAUNCHES["gather_mul_segment_sum_dx"] == 1
    assert tfm.LAUNCHES["gather_segment_sum_dx"] == 1
    assert tfm.LAUNCHES["segment_sum_dense"] == 1


def _route_inputs(cuda, b, f, seed):
    """x, w (pre-masked), a cotangent and the ids of ``b`` on the card."""
    from hydragnn_torch.ops.aggregate import segment_offsets

    n, e = len(b["node_gid"]), len(b["senders"])
    g = torch.Generator().manual_seed(seed)
    mask = _t(b["edge_mask"])
    x = torch.randn(n, f, generator=g).to(cuda)
    w = (torch.randn(e, f, generator=g) * mask[:, None]).to(cuda)
    ct = torch.randn(n, f, generator=g).to(cuda)
    send, recv = _t(b["senders"]).to(cuda), _t(b["receivers"]).to(cuda)
    perm, mask = _t(b["perm"]).to(cuda), mask.to(cuda)
    return x, w, ct, send, recv, perm, mask, segment_offsets(recv, n, mask)


def _near_plain(got, want):
    """Within 1e-5 of the plain version's largest entry (as chip_smoke
    holds the kernels): the plain version's ``index_add_`` adds in an
    order that changes from run to run on the card, so an entry near zero
    in a long row can miss an entrywise tolerance."""
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _poisoned(cuda, shape):
    """Leave NaNs in the allocator's free block of ``shape``, which the
    next ``torch.empty`` of that shape takes: an output row the kernel
    does not write shows as NaN."""
    t = torch.full(shape, float("nan"), device=cuda)
    del t


@pytest.mark.gpu
def test_gather_mul_route_matches_plan_on_card(cuda):
    """The C side's route by width is the plan's (``fwd_route``), and a
    forced route 1 at an odd width is refused."""
    from hydragnn_torch.kernels.build import load_library

    lib = load_library("fused_mp")
    for f in range(0, 300):
        assert lib.hg_gather_mul_route(f) == tfm.fwd_route(f), f
    b = _graph_batch(41, n_real=40, n_pad=48, e_pad=512)
    x, w, _, send, _, _, _, ptr = _route_inputs(cuda, b, 5, 0)
    with pytest.raises(ValueError):
        tfm.launch_gather_mul(x, w, None, send, ptr, route=1)


@pytest.mark.gpu
@pytest.mark.parametrize("hub", [0, 300])
@pytest.mark.parametrize("f", [2, 64, 130, 256])
def test_gather_mul_route1_matches_route2_on_card(cuda, f, hub):
    """The forward's route 1, both modes, against route 2 bit for bit and
    the plain version at 1e-5, bit-identical over two runs, every row
    written (empty rows zero); ``hub`` gives one row that spans several
    id batches and edge groups."""
    b = _graph_batch(40 + f, hub=hub)
    x, w, _, send, recv, _, mask, ptr = _route_inputs(cuda, b, f, 1)
    n = x.shape[0]
    tfm.reset_launches()
    for ww, mm, op in ((w, None, "gather_mul_segment_sum"),
                       (None, mask, "gather_segment_sum")):
        _poisoned(cuda, (n, f))
        r1 = tfm.launch_gather_mul(x, ww, mm, send, ptr, op=op, route=1)
        r1b = tfm.launch_gather_mul(x, ww, mm, send, ptr, op=op, route=1)
        r2 = tfm.launch_gather_mul(x, ww, mm, send, ptr, op=op, route=2)
        own = tfm.launch_gather_mul(x, ww, mm, send, ptr, op=op)
        p = tfm.gather_mul_segment_sum_plain(x, ww, send, recv,
                                             edge_valid=mask, mask=mm)
        torch.cuda.synchronize()
        assert torch.equal(r1, r1b) and torch.equal(r1, r2)
        assert torch.equal(own, r1)
        _near_plain(r1, p)
        empty = ptr.diff() == 0
        assert bool(empty.any()) and bool((r1[empty] == 0).all())
    assert tfm.LAUNCHES["gather_mul_segment_sum"] == 4
    assert tfm.LAUNCHES["gather_segment_sum"] == 4


def _composed_backward(x, w, ct, send, recv, perm, mask):
    """The backward's route 2 as the composition runs it: dx by the first
    design in sender order on w[p] (or mask[p]), dw by indexing."""
    from hydragnn_torch.ops.aggregate import segment_offsets

    n = x.shape[0]
    p = perm.long()
    ptr_s = segment_offsets(send[p], n, mask[p])
    rs = recv[p].contiguous()
    if w is None:
        return tfm.launch_gather_mul(ct, None, mask[p].contiguous(), rs,
                                     ptr_s, route=2), None
    dx = tfm.launch_gather_mul(ct, w[p].contiguous(), None, rs, ptr_s,
                               route=2)
    return dx, x[send.long()] * ct[recv.long()]


@pytest.mark.gpu
@pytest.mark.parametrize("hub", [0, 300])
@pytest.mark.parametrize("f", [2, 64, 130])
def test_gather_mul_fused_backward_on_card(cuda, f, hub):
    """The backward's route 1: dx bit for bit the composition's (route 2)
    and 1e-5 of the plain version's; dw bit-equal to x[s] * g[r] on real
    edges and exactly zero on masked ones, every row written; dx alone
    and dw alone the same bits; the no-``w`` mode's dx likewise; two runs
    bit-identical."""
    from hydragnn_torch.ops.aggregate import segment_offsets

    b = _graph_batch(50 + f, hub=hub)
    x, w, ct, send, recv, perm, mask, _ = _route_inputs(cuda, b, f, 2)
    n, e = x.shape[0], w.shape[0]
    real = mask != 0
    ptr_s = segment_offsets(send[perm.long()], n, mask[perm.long()])
    _poisoned(cuda, (e, f))
    dx, dw = tfm.launch_gather_mul_bwd(ct, x, w, None, perm, recv, ptr_s)
    dx2, dw2 = tfm.launch_gather_mul_bwd(ct, x, w, None, perm, recv, ptr_s)
    dx_only, none_w = tfm.launch_gather_mul_bwd(ct, x, w, None, perm, recv,
                                                ptr_s, want_dw=False)
    none_x, dw_only = tfm.launch_gather_mul_bwd(ct, x, w, None, perm, recv,
                                                ptr_s, want_dx=False)
    cdx, cdw = _composed_backward(x, w, ct, send, recv, perm, mask)
    pdx, pdw = tfm.gather_mul_segment_sum_bwd_plain(ct, x, w, send, recv,
                                                    mask)
    torch.cuda.synchronize()
    assert none_w is None and none_x is None
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    assert torch.equal(dx, cdx) and torch.equal(dx_only, dx)
    assert torch.equal(dw_only, dw)
    _near_plain(dx, pdx)
    assert torch.equal(dw[real], cdw[real])
    assert bool((dw[~real] == 0).all()) and bool((~real).any())
    assert torch.equal(dw, pdw)
    sdx, _ = tfm.launch_gather_mul_bwd(ct, None, None, mask, perm, recv,
                                       ptr_s)
    csdx, _ = _composed_backward(x, None, ct, send, recv, perm, mask)
    psdx, _ = tfm.gather_mul_segment_sum_bwd_plain(ct, None, None, send,
                                                   recv, mask, mask)
    torch.cuda.synchronize()
    assert torch.equal(sdx, csdx)
    _near_plain(sdx, psdx)


@pytest.mark.gpu
def test_gather_mul_route1_long_shares_on_card(cuda):
    """Shares of more than 32 rows (the row-boundary window reloads):
    200000 rows of which a few hold 4000 edges, a masked tail; the
    forward's and the backward's route 1 against route 2 and the
    composition, bit for bit, every row written."""
    from hydragnn_torch.ops.aggregate import segment_offsets

    n, e_real, e_pad, f = 200000, 4000, 4500, 64
    rng = np.random.RandomState(3)
    recv = np.full(e_pad, n - 1, np.int32)
    send = np.full(e_pad, n - 1, np.int32)
    recv[:e_real] = np.sort(rng.randint(0, n - 1, e_real))
    send[:e_real] = rng.randint(0, n - 1, e_real)
    mask = np.zeros(e_pad, np.float32)
    mask[:e_real] = 1.0
    perm = np.argsort(send, kind="stable").astype(np.int32)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(n, f, generator=g).to(cuda)
    ct = torch.randn(n, f, generator=g).to(cuda)
    m = _t(mask).to(cuda)
    w = (torch.randn(e_pad, f, generator=g).to(cuda)) * m[:, None]
    s, r, p = _t(send).to(cuda), _t(recv).to(cuda), _t(perm).to(cuda)
    ptr = segment_offsets(r, n, m)
    _poisoned(cuda, (n, f))
    r1 = tfm.launch_gather_mul(x, w, None, s, ptr, route=1)
    r2 = tfm.launch_gather_mul(x, w, None, s, ptr, route=2)
    ptr_s = segment_offsets(s[p.long()], n, m[p.long()])
    _poisoned(cuda, (n, f))
    dx, dw = tfm.launch_gather_mul_bwd(ct, x, w, None, p, r, ptr_s)
    cdx, cdw = _composed_backward(x, w, ct, s, r, p, m)
    torch.cuda.synchronize()
    assert torch.equal(r1, r2)
    assert torch.equal(dx, cdx)
    real = m != 0
    assert torch.equal(dw[real], cdw[real]) and bool((dw[~real] == 0).all())


@pytest.mark.gpu
def test_gather_mul_function_backward_routes_on_card(cuda):
    """Through the ops' autograd Functions: a plain backward takes the
    fused launch (one ``*_dx`` launch, the composition's bits), a forced
    route 2 (the Functions' last argument) the composition (one ``*_dx``
    launch too), and both match."""
    b = _graph_batch(60, hub=200)
    x, w, ct, send, recv, perm, mask, _ = _route_inputs(cuda, b, 64, 3)
    real = mask != 0
    out = {}
    for route in (0, 2):
        tfm.reset_launches()
        out[route] = _grads(lambda x_, w_: tfm._GatherMulSegmentSum.apply(
            x_, w_, send, recv, perm, mask, "gather_mul_segment_sum", route),
            (x, w), ct)
        out[route] += _grads(lambda x_: tfm._GatherSegmentSum.apply(
            x_, send, recv, perm, mask, "gather_segment_sum", route), (x,),
            ct)
        torch.cuda.synchronize()
        assert tfm.LAUNCHES["gather_mul_segment_sum_dx"] == 1
        assert tfm.LAUNCHES["gather_segment_sum_dx"] == 1
    assert torch.equal(out[0][0], out[2][0])
    assert torch.equal(out[0][1][real], out[2][1][real])
    assert bool((out[0][1][~real] == 0).all())
    assert torch.equal(out[0][2], out[2][2])


def _scf_composed(h, rbf, cm, w0, b0, w1, b1, em, send, recv):
    """The composed edge pipeline in the inputs' dtype (the plain version
    computes in float32): the float64 yardstick of the scf kernels."""
    filt = ((torch.nn.functional.softplus(rbf @ w0 + b0) - np.log(2.0)) @ w1
            + b1) * cm[:, None]
    msgs = torch.where((em != 0)[:, None], h[send.long()] * filt,
                       torch.zeros((), dtype=h.dtype, device=h.device))
    return torch.zeros_like(h).index_add(0, recv.long(), msgs)


def _float64_yardstick(name, got, plain32, plain64):
    """The kernel's error against a float64 run of the plain version: at
    most twice the float32 plain version's own, or 1e-6 of the largest
    entry where that is larger (the products run in 3xTF32)."""
    scale = float(plain64.abs().max())
    e32 = float((plain32.double() - plain64).abs().max())
    err = float((got.double() - plain64).abs().max())
    assert err <= max(2 * e32, 1e-6 * scale), (name, err, e32, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("geo", [True, False], ids=["drbf-dcm", "no-geo"])
@pytest.mark.parametrize("f,gd", [(48, 50), (200, 50), (256, 50), (384, 127),
                                  (512, 127), (1024, 127)])
def test_scf_kernels_match_plain_on_card(cuda, f, gd, geo):
    """The three scf kernels (forward, pass P, pass S) through the autograd
    Function against autograd through the composed plain version, at the
    wide SchNet's widths (F = 256, G = 50), at F = 48 and 200 (not whole
    slices of pass P's 64 columns) and at each slice width pass P
    instantiates up to the limits (F = 384 and 512: 32 columns a slice;
    F = 1024: 16; G = 127), with drbf and dcm asked (rbf and cm need a
    gradient) and not.  Node 0 receives 200 extra edges, so its row spans
    several edge tiles and edge shares; other rows have none, and shares
    end mid-tile.  The edge-summed weight grads are held to 1e-4 relative
    to their largest entry (thousands of float32 products summed in
    another order), the rest to 1e-5; pass P's outputs also against a
    float64 run (:func:`_float64_yardstick`); masked edges' drbf, dcm
    exactly zero; a second run bit-identical.  The forward's and pass S's
    route on the card is the plan's (``scf_mp.fwd_route``: route 1 up to
    F = 256); at route 1's widths the forward and pass S, launched as the
    path launches them, lie within the float64 bound and repeat bit for
    bit, and route 2 (the first design) at the same inputs is held to the
    plain version at 1e-5."""
    from hydragnn_torch.kernels.build import load_library
    from hydragnn_torch.ops import scf_mp
    from hydragnn_torch.ops.aggregate import segment_offsets

    route = scf_mp.fwd_route(f, gd)
    assert load_library("scf_mp").hg_scf_fwd_route(f, gd) == route
    assert route == (1 if f <= 256 else 2)

    b = _graph_batch(8, hub=200)
    n, e = len(b["node_gid"]), len(b["senders"])
    g = torch.Generator().manual_seed(2)
    mask = _t(b["edge_mask"])
    # weights at the scale of a lecun-normal init
    ins = [torch.randn(n, f, generator=g),
           torch.rand(e, gd, generator=g),
           torch.rand(e, generator=g) * mask,
           torch.randn(gd, f, generator=g) / gd ** 0.5,
           torch.randn(f, generator=g) * 0.1,
           torch.randn(f, f, generator=g) / f ** 0.5,
           torch.randn(f, generator=g) * 0.1]
    ins = [t.to(cuda) for t in ins]
    ct = torch.randn(n, f, generator=g).to(cuda)
    send, recv = _t(b["senders"]).to(cuda), _t(b["receivers"]).to(cuda)
    perm = _t(b["perm"]).to(cuda)
    em = mask.to(torch.int32).to(cuda)
    names = ("h", "rbf", "cm", "w0", "b0", "w1", "b1")

    def run(fn, inputs):
        ts = [t.detach().clone().requires_grad_(geo or i not in (1, 2))
              for i, t in enumerate(inputs)]
        fn(*ts).backward(ct.to(inputs[0].dtype))
        torch.cuda.synchronize()
        return [t.grad for t in ts]

    scf_mp.reset_launches()
    k = run(lambda *a: scf_mp.scf_edge_pipeline(
        a[0], a[1], a[2], em, *a[3:], send, recv, perm), ins)
    assert scf_mp.LAUNCHES == {"scf_edge_pipeline": 1,
                               "scf_edge_pipeline_pass_p": 1,
                               "scf_edge_pipeline_pass_s": 1}
    again = run(lambda *a: scf_mp.scf_edge_pipeline(
        a[0], a[1], a[2], em, *a[3:], send, recv, perm), ins)
    for name, x_, y_ in zip(names, k, again):
        assert (x_ is None and y_ is None) or torch.equal(x_, y_), name

    p = run(lambda *a: scf_mp.scf_edge_pipeline_plain(
        a[0], a[1], a[2], em, *a[3:], send, recv), ins)
    p64 = run(lambda *a: _scf_composed(*a, em, send, recv),
              [t.double() for t in ins])
    real = em.bool()
    for name, a, c, c64 in zip(names, k, p, p64):
        if a is None:
            assert not geo and c is None and name in ("rbf", "cm"), name
            continue
        if name in ("rbf", "cm"):
            assert bool((a[~real] == 0).all()), name
            a, c, c64 = a[real], c[real], c64[real]
        scale = float(c.abs().max())
        rel = 1e-4 if name in ("w0", "b0", "w1", "b1") else 1e-5
        assert float((a - c).abs().max()) <= rel * scale, name
        if name != "h":
            _float64_yardstick(name, a, c, c64)
    if route != 1:
        return
    # the forward and pass S as the path launches them, both routes
    ptr_r = segment_offsets(recv, n, em)
    pk = perm.long()
    ptr_s = segment_offsets(send[pk], n, em[pk])
    with torch.no_grad():
        for op, x_, gi, ri, pm, ptr in (
                ("scf_edge_pipeline", ins[0], send, recv, None, ptr_r),
                ("scf_edge_pipeline_pass_s", ct, recv, send, perm, ptr_s)):
            def launch(r_):
                return scf_mp.launch_scf_filter_gather(
                    x_, *ins[1:], gi, ri, pm, ptr, op, route=r_)
            k1, k1b, k2 = launch(1), launch(1), launch(2)
            torch.cuda.synchronize()
            assert torch.equal(k1, k1b), op
            c = scf_mp.scf_edge_pipeline_plain(x_, *ins[1:3], em, *ins[3:],
                                               gi, ri)
            c64 = _scf_composed(*(t.double() for t in [x_] + ins[1:]), em,
                                gi, ri)
            _float64_yardstick(op, k1, c, c64)
            assert float((k2 - c).abs().max()) <= 1e-5 * float(
                c.abs().max()), op


def _schnet_batch(monkeypatch):
    from hydragnn_torch.graph.batch import GraphSample, HeadSpec, PadSpec, collate
    from hydragnn_torch.graph.neighborlist import radius_graph

    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", "fused")
    rng = np.random.RandomState(0)
    samples = []
    for _ in range(16):
        pos = rng.rand(20, 3).astype(np.float32) * 4.0
        samples.append(GraphSample(
            x=rng.randint(0, 5, (20, 1)), pos=pos,
            edge_index=radius_graph(pos, 1.8, max_neighbours=20),
            graph_y=rng.rand(1)))
    g = collate(samples, PadSpec.for_batch(16, 20, max(
        s.num_edges for s in samples)), [HeadSpec("energy", "graph", 1)])
    assert "edge_perm_sender" in g.extras
    return g


def _schnet(width, seed=0):
    from hydragnn_torch.models.base import GraphHeadCfg, ModelConfig
    from hydragnn_torch.models.create import create_model

    cfg = ModelConfig(
        model_type="SchNet", input_dim=1, hidden_dim=width, output_dim=(1,),
        output_type=("graph",),
        graph_head=GraphHeadCfg(2, width, 2, (width, width)),
        node_head=None, task_weights=(1.0,), num_conv_layers=4,
        num_gaussians=50, num_filters=width, radius=1.8, max_neighbours=20)
    return cfg, create_model(cfg, seed=seed)


@pytest.mark.gpu
def test_schnet_forward_on_card_matches_cpu(cuda, monkeypatch):
    """The SchNet forward under the fused backend: the card (kernels) and
    the CPU (plain versions) agree to 1e-4, with 4 + 1 launches."""
    g = _schnet_batch(monkeypatch)
    _, model = _schnet(64)
    model = model.eval()
    with torch.inference_mode():
        want = model(g)[0]
        tfm.reset_launches()
        got = model.to(cuda)(g.to(cuda))[0]
        torch.cuda.synchronize()
    assert tfm.LAUNCHES["gather_mul_segment_sum"] == 4
    assert tfm.LAUNCHES["segment_sum_dense"] == 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [64, 256])
def test_schnet_train_steps_on_card_match_cpu(cuda, monkeypatch, width):
    """Three AdamW steps under fused from one init, on the card (kernels,
    forward and backward) and on the CPU (plain versions): the same
    losses and parameters to 1e-4, with the kernels of each width
    launched once per conv layer and pass."""
    from hydragnn_torch.ops import scf_mp
    from hydragnn_torch.train.optimizer import select_optimizer
    from hydragnn_torch.train.trainer import create_train_state, make_train_step

    g = _schnet_batch(monkeypatch)
    runs = []
    for dev in (torch.device("cpu"), cuda):
        cfg, model = _schnet(width, seed=1)
        model = model.to(dev)
        spec = select_optimizer({"type": "AdamW", "learning_rate": 1e-3})
        state = create_train_state(model, spec)
        step = make_train_step(model, cfg, spec)
        tfm.reset_launches()
        scf_mp.reset_launches()
        losses = []
        gd = g.to(dev)
        for _ in range(3):
            state, m = step(state, gd)
            losses.append(float(m["loss"]))
        runs.append((losses, [p.detach().cpu() for p in model.parameters()]))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-4, atol=1e-6)
    for a, b in zip(runs[1][1], runs[0][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    if width == 64:
        assert tfm.LAUNCHES["gather_mul_segment_sum"] == 12
        assert tfm.LAUNCHES["gather_mul_segment_sum_dx"] == 12
        assert scf_mp.LAUNCHES["scf_edge_pipeline"] == 0
    else:
        assert tfm.LAUNCHES["gather_mul_segment_sum"] == 0
        assert scf_mp.LAUNCHES == {"scf_edge_pipeline": 12,
                                   "scf_edge_pipeline_pass_p": 12,
                                   "scf_edge_pipeline_pass_s": 12}
    assert tfm.LAUNCHES["segment_sum_dense"] == 3


def _degree_batch(n=300, lo=0, hi=20, seed=0):
    """Rows of degree 0 (every third) and of degrees up to ``hi``, sorted
    receivers, random senders, a masked tail parked on node n-1."""
    rng = np.random.RandomState(seed)
    deg = rng.randint(lo, hi + 1, n)
    deg[::3] = 0
    deg[1] = hi
    deg[n - 1] = 0
    recv = np.repeat(np.arange(n), deg)
    e_real = len(recv)
    e = e_real + 37
    senders = np.full(e, n - 1, np.int32)
    receivers = np.full(e, n - 1, np.int32)
    senders[:e_real] = rng.randint(0, n - 1, e_real)
    receivers[:e_real] = recv
    mask = np.zeros(e, np.float32)
    mask[:e_real] = 1.0
    perm = np.argsort(senders, kind="stable").astype(np.int32)
    return senders, receivers, mask, perm, deg


@pytest.mark.gpu
@pytest.mark.parametrize("f,moments", [
    (64, ("sum", "sq", "mxmn", "cnt")), (256, ("sum", "sq", "mxmn", "cnt")),
    (512, ("sum", "sq", "mxmn", "cnt")), (1024, ("sum", "sq", "cnt")),
    (64, ("sum", "cnt")), (5, ("mxmn",)), (130, ("cnt",))])
@pytest.mark.parametrize("all_masked", [False, True])
def test_poly_kernels_match_plain_on_card(cuda, f, moments, all_masked):
    """Both poly kernels against their plain versions at the widths of the
    gates (512 with mxmn, 1024 without), on rows of degree 0 and degree 20
    and with every edge masked: sums to 1e-5 of the largest entry, max/min
    and the count exactly equal; then the backward through the autograd
    Functions against autograd through the plain versions, on data with
    ties, masked rows exactly zero."""
    from hydragnn_torch.ops import poly_mp

    n = 300
    send, recv, mask, perm, deg = _degree_batch(n)
    if all_masked:
        mask = np.zeros_like(mask)
    g = torch.Generator().manual_seed(3)
    e = len(send)
    # a coarse grid: ties within a segment
    data = (torch.randn(e, f, generator=g) * 2).round().div(2).to(cuda)
    x = (torch.randn(n, f, generator=g) * 2).round().div(2).to(cuda)
    send, recv, mask, perm = (_t(a).to(cuda) for a in (send, recv, mask, perm))
    order = poly_mp._norm_moments(moments)

    def check(k, p):
        for m, a, c in zip(order, k, p):
            if m in ("mxmn", "cnt"):
                assert torch.equal(a, c), m
            else:
                scale = max(float(c.abs().max()), 1.0)
                assert float((a - c).abs().max()) <= 1e-5 * scale, m

    poly_mp.reset_launches()
    tfm.reset_launches()
    with torch.inference_mode():
        k = poly_mp.segment_poly_dense(data, recv, n, moments, valid=mask)
        p = poly_mp.segment_poly_dense_plain(data, recv, n, moments,
                                             valid=mask)
        torch.cuda.synchronize()
        check(k, p)
        if "cnt" in order and not all_masked:
            assert torch.equal(k[order.index("cnt")].cpu(),
                               torch.from_numpy(deg).float())
        k = poly_mp.gather_poly_segment(x, send, recv, perm, moments,
                                        mask=mask)
        p = poly_mp.gather_poly_segment_plain(x, send, recv, moments,
                                              mask=mask)
        torch.cuda.synchronize()
        check(k, p)
    assert poly_mp.LAUNCHES == {"segment_poly_dense": 1,
                                "gather_poly_segment": 1}
    if order == ("cnt",):
        return

    def loss(outs):
        total = 0.0
        for m, o in zip(order, outs):
            if m == "mxmn":
                o = torch.where(o <= -5e8, torch.zeros_like(o), o)
            if m != "cnt":
                total = total + (o ** 2).sum()
        return total

    def grad(fn, t):
        t = t.detach().clone().requires_grad_(True)
        loss(fn(t)).backward()
        torch.cuda.synchronize()
        return t.grad

    for kern, plain, t in (
            (lambda d: poly_mp.segment_poly_dense(d, recv, n, moments,
                                                  valid=mask),
             lambda d: poly_mp.segment_poly_dense_plain(d, recv, n, moments,
                                                        valid=mask), data),
            (lambda x_: poly_mp.gather_poly_segment(x_, send, recv, perm,
                                                    moments, mask=mask),
             lambda x_: poly_mp.gather_poly_segment_plain(x_, send, recv,
                                                          moments, mask=mask),
             x)):
        gk, gp = grad(kern, t), grad(plain, t)
        scale = max(float(gp.abs().max()), 1.0)
        assert float((gk - gp).abs().max()) <= 1e-5 * scale
    gk = grad(lambda d: poly_mp.segment_poly_dense(d, recv, n, moments,
                                                   valid=mask), data)
    assert bool((gk[mask == 0] == 0).all())


@pytest.mark.gpu
def test_poly_kernels_refuse_what_they_do_not_take(cuda):
    from hydragnn_torch.ops import poly_mp

    send, recv, mask, perm, _ = _degree_batch(40)
    send, recv, mask = (_t(a).to(cuda) for a in (send, recv, mask))
    data = torch.randn(len(send), 8, device=cuda)
    with pytest.raises(TypeError):
        poly_mp.segment_poly_dense(data.double(), recv, 40, ("sum",))
    with pytest.raises(ValueError):
        poly_mp.segment_poly_dense(data.t(), recv, 8, ("sum",))
    with pytest.raises(TypeError):
        poly_mp.gather_poly_segment(torch.randn(40, 8, device=cuda), send,
                                    recv, None, ("sum",), mask=mask.double())


_MOMENT_SUBSETS = [
    tuple(m for i, m in enumerate(("sum", "sq", "mxmn", "cnt")) if k >> i & 1)
    for k in range(1, 16)]


@pytest.mark.gpu
def test_poly_route_matches_plan_on_card(cuda):
    """The C side's route by width and mode is the plan's (``fwd_route``),
    a forced route 1 in gather mode or at an odd width is refused, and at
    256 columns (route 2's width) a forced route 1 gives its bits."""
    from hydragnn_torch.kernels.build import load_library
    from hydragnn_torch.ops import poly_mp
    from hydragnn_torch.ops.aggregate import segment_offsets

    lib = load_library("poly_mp")
    for f in range(0, 300):
        for gather in (0, 1):
            assert lib.hg_poly_segment_route(f, gather) == \
                poly_mp.fwd_route(f, bool(gather)), (f, gather)
    send, recv, mask, _, _ = _degree_batch(40)
    send, recv, mask = (_t(a).to(cuda) for a in (send, recv, mask))
    ptr = segment_offsets(recv, 40, mask)
    with pytest.raises(ValueError):
        poly_mp.launch_poly_segment(torch.randn(len(send), 5, device=cuda),
                                    None, None, ptr, 40, ("sum",),
                                    "segment_poly_dense", route=1)
    # past 128 columns route 2 is the width's own, route 1 taken when asked
    assert poly_mp.fwd_route(256, False) == 2
    wide = torch.randn(len(send), 256, device=cuda)
    a = poly_mp.launch_poly_segment(wide, None, None, ptr, 40, ("sum",),
                                    "segment_poly_dense", route=1)[0]
    b = poly_mp.launch_poly_segment(wide, None, None, ptr, 40, ("sum",),
                                    "segment_poly_dense")[0]
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        poly_mp.launch_poly_segment(torch.randn(40, 5, device=cuda), send,
                                    mask, ptr, 40, ("sum",),
                                    "gather_poly_segment", route=1)
    for f in (1, 2, 64, 128, 256):
        for stage in (0, 3, 10**6):
            assert lib.hg_poly_gather_window(f, stage) == \
                poly_mp.gather_window_rows(f, stage), (f, stage)


@pytest.mark.gpu
@pytest.mark.parametrize("hub", [0, 300])
@pytest.mark.parametrize("f", [64, 256])
def test_poly_scatter_route1_matches_route2_on_card(cuda, f, hub):
    """The scatter mode's route 1 against route 2 bit for bit for every
    moment subset, bit-identical over two runs, every row written (empty
    rows 0, 0, -1e9, 0), and against the plain version (sums 1e-5 of the
    largest entry, max/min and the count exactly); ``hub`` gives one row
    of 300 edges more."""
    from hydragnn_torch.ops import poly_mp
    from hydragnn_torch.ops.aggregate import segment_offsets

    b = _graph_batch(70 + f, hub=hub)
    n, e = len(b["node_gid"]), len(b["senders"])
    g = torch.Generator().manual_seed(f + hub)
    # a coarse grid: ties within a segment
    data = (torch.randn(e, f, generator=g) * 2).round().div(2).to(cuda)
    recv = _t(b["receivers"]).to(cuda)
    mask = _t(b["edge_mask"]).to(cuda)
    ptr = segment_offsets(recv, n, mask)
    empty = ptr.diff() == 0
    assert bool(empty.any())
    op = "segment_poly_dense"
    for moments in _MOMENT_SUBSETS:
        for m in moments:
            _poisoned(cuda, (n, 2 * f) if m == "mxmn" else
                      (n,) if m == "cnt" else (n, f))
        r1 = poly_mp.launch_poly_segment(data, None, None, ptr, n, moments,
                                         op, route=1)
        r1b = poly_mp.launch_poly_segment(data, None, None, ptr, n, moments,
                                          op, route=1)
        r2 = poly_mp.launch_poly_segment(data, None, None, ptr, n, moments,
                                         op, route=2)
        p = poly_mp.segment_poly_dense_plain(data, recv, n, moments,
                                             valid=mask)
        torch.cuda.synchronize()
        for m, a, a2, c, want in zip(moments, r1, r1b, r2, p):
            assert torch.equal(a, a2) and torch.equal(a, c), (moments, m)
            if m in ("mxmn", "cnt"):
                assert torch.equal(a, want), (moments, m)
            else:
                _near_plain(a, want)
            blank = {"mxmn": -1e9}.get(m, 0.0)
            assert bool((a[empty] == blank).all()), (moments, m)


@pytest.mark.gpu
@pytest.mark.parametrize("stage", [0, 3])
@pytest.mark.parametrize("hub", [0, 300])
@pytest.mark.parametrize("f", [64, 128])
def test_poly_gather_route1_matches_route2_on_card(cuda, f, hub, stage):
    """The gather mode's route 1 (x's node window in shared memory)
    against route 2 bit for bit for every moment subset, bit-identical
    over two runs, on a mask with fractions and senders outside ``[0,
    N)``; ``stage`` 3 stages at most 3 rows of x, so that most senders
    lie past the window and are read from global memory."""
    from hydragnn_torch.ops import poly_mp
    from hydragnn_torch.ops.aggregate import segment_offsets

    b = _graph_batch(90 + f, hub=hub)
    n, e = len(b["node_gid"]), len(b["senders"])
    g = torch.Generator().manual_seed(f + hub + stage)
    x = ((torch.randn(n, f, generator=g) * 2).round() / 2).to(cuda)
    send = _t(b["senders"]).clone()
    send[::7] = torch.where(torch.arange(e)[::7] % 2 == 0, n + 3, -2).int()
    send = send.to(cuda)
    recv = _t(b["receivers"]).to(cuda)
    mask = (_t(b["edge_mask"]) * (torch.rand(e, generator=g) + 0.5)).to(cuda)
    ptr = segment_offsets(recv, n, mask)
    op = "gather_poly_segment"
    # the width's own route: 1 up to 64, 2 at 128 (a forced route 1 there)
    assert poly_mp.fwd_route(f, True) == (1 if f <= 64 else 2)
    for moments in _MOMENT_SUBSETS:
        r1 = poly_mp.launch_poly_segment(x, send, mask, ptr, n, moments, op,
                                         route=1, stage_rows=stage)
        r1b = poly_mp.launch_poly_segment(x, send, mask, ptr, n, moments, op,
                                          route=1, stage_rows=stage)
        r2 = poly_mp.launch_poly_segment(x, send, mask, ptr, n, moments, op,
                                         route=2)
        p = poly_mp.gather_poly_segment_plain(x, send, recv, moments,
                                              mask=mask)
        torch.cuda.synchronize()
        for m, a, a2, c, want in zip(moments, r1, r1b, r2, p):
            assert torch.equal(a, a2) and torch.equal(a, c), (moments, m)
            if m in ("mxmn", "cnt"):
                assert torch.equal(a, want), (moments, m)
            else:
                _near_plain(a, want)


@pytest.mark.gpu
def test_unsorted_sum_route_matches_plan_on_card(cuda):
    """The C side's route of the unsorted sum is the plan's
    (``unsorted_sum_route``), its block count covers the segments, and a
    forced route 1 it does not take is refused."""
    from hydragnn_torch.kernels.build import load_library
    from hydragnn_torch.ops import aggregate as ag

    lib = load_library("fused_mp")
    for e in (0, 1, 5000):
        for s in (0, 1, 513, ag.UNSORTED_MAX_SEGMENTS,
                  ag.UNSORTED_MAX_SEGMENTS + 1):
            for f in range(0, 140):
                assert lib.hg_unsorted_sum_route(e, s, f) == \
                    tfm.unsorted_sum_route(e, s, f), (e, s, f)
            if s and tfm.unsorted_sum_route(e, s, 64) == 1:
                nb = tfm.unsorted_sum_blocks(e, s, 64)
                assert -(-s // nb) <= ag.UNSORTED_SEGS_PER_BLOCK
    ids = torch.arange(10, device=cuda, dtype=torch.int32)
    for f in (3, 130):
        with pytest.raises(ValueError):
            tfm.launch_unsorted_sum(torch.randn(10, f, device=cuda), ids, 10,
                                    route=1)


@pytest.mark.gpu
@pytest.mark.parametrize("f", [64, 128, 2, 6])
@pytest.mark.parametrize("name", ID_PATTERNS)
def test_unsorted_sum_route1_on_card(cuda, name, f):
    """Route 1 of the unsorted sum (one launch, the schedule built in each
    block's shared memory) bit for bit against the CSR kernel on the
    stable sort's permutation at the same block count, and against itself
    over two runs; its schedule (the debug output) the stable sort's
    permutation and offsets; within 1e-5 of the plain version and of
    route 2; every segment written, empty ones zero; int64 ids the same,
    with no host synchronisation; at the least block count it takes (128
    segments a block) and at 3x its own too."""
    from hydragnn_torch.ops import aggregate as ag

    ids_np, n = _id_pattern(name)
    ids = _t(ids_np).to(cuda)
    e = len(ids_np)
    g = torch.Generator().manual_seed(f + e)
    data = torch.randn(e, f, generator=g).to(cuda)
    perm, ptr = ag.sort_schedule(ids, n)
    nb = tfm.unsorted_sum_blocks(e, n, f)
    least = -(-n // ag.UNSORTED_SEGS_PER_BLOCK)   # 128 segments a block
    for blocks in (0, least, 3 * nb):
        _poisoned(cuda, (n, f))
        r1 = tfm.launch_unsorted_sum(data, ids, n, n_blocks=blocks)
        r1b, p_dbg, rp_dbg = tfm.launch_unsorted_sum(data, ids, n,
                                                     n_blocks=blocks,
                                                     debug=True)
        csr = tfm.launch_segment_sum_rows(data, ptr, n, perm=perm, route=1,
                                          n_blocks=blocks or nb)
        torch.cuda.synchronize()
        q = int(ptr[-1])
        assert torch.equal(rp_dbg, ptr), blocks
        assert torch.equal(p_dbg[:q], perm[:q]), blocks
        assert bool((p_dbg[q:] == -1).all()), blocks
        assert torch.equal(r1, csr) and torch.equal(r1, r1b), blocks
        if blocks == 0:
            own = r1
    r1 = own    # at its own block count, as the path launches it
    want = tfm.segment_sum_dense_plain(data, ids, n)
    r2 = tfm.launch_unsorted_sum(data, ids, n, route=2)
    # no host synchronisation in the wrapper, whatever the ids' type
    torch.cuda.set_sync_debug_mode("error")
    try:
        r64 = tfm.launch_unsorted_sum(data, ids.long(), n)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if e:
        _near_plain(r1, want)
        _near_plain(r1, r2)
    assert torch.equal(r64, r1)
    empty = ptr.diff() == 0
    assert bool((r1[empty] == 0).all())
    op = ag.segment_sum_pallas(data, ids, n)
    torch.cuda.synchronize()
    assert torch.equal(op, r1)


@pytest.mark.gpu
def test_segment_sum_route_matches_plan_on_card(cuda):
    """The C side's route by width is the plan's (``segment_sum_route``),
    and a forced route 1 at an odd width is refused."""
    from hydragnn_torch.kernels.build import load_library
    from hydragnn_torch.ops.aggregate import segment_offsets

    lib = load_library("fused_mp")
    for f in range(0, 300):
        assert lib.hg_segment_sum_route(f) == tfm.segment_sum_route(f), f
    ids = torch.arange(10, device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError):
        tfm.launch_segment_sum_rows(torch.randn(10, 3, device=cuda),
                                    segment_offsets(ids, 10), 10, route=1)


def _segment_case(cuda, name, f):
    """(data, ids, num_segments, valid, perm, row_ptr, max_rows) on the
    card: the pool's ids (a 220-node padding graph), edge ids over the
    receivers with a masked tail and empty segments (``hub``: one of 2000
    rows more), unsorted ids through a permutation, a cap."""
    from hydragnn_torch.ops import aggregate as ag

    g = torch.Generator().manual_seed(f)
    if name == "pool":
        b = _graph_batch(11, n_real=290, n_pad=510)
        ids = _t(b["node_gid"]).to(cuda)
        data = (torch.randn(len(ids), f, generator=g).to(cuda)
                * _t(b["node_mask"]).to(cuda)[:, None])
        n = b["n_graphs"]
        return data, ids, n, None, None, ag.segment_offsets(ids, n), None
    b = _graph_batch(12, hub=2000 if name == "hub" else 0, e_pad=6000)
    n = len(b["node_gid"])
    mask = _t(b["edge_mask"]).to(cuda)
    data = torch.randn(len(mask), f, generator=g).to(cuda) * mask[:, None]
    recv = _t(b["receivers"]).to(cuda)
    if name in ("edges", "hub"):
        return (data, recv, n, mask, None, ag.segment_offsets(recv, n, mask),
                None)
    if name == "cap":
        return data, recv, n, None, None, ag.segment_offsets(recv, n), 7
    ids = torch.where(mask != 0, _t(b["senders"]).to(cuda), n + 1)
    perm, ptr = ag.sort_schedule(ids, n)
    return data, ids, n, None, perm, ptr, None


@pytest.mark.gpu
@pytest.mark.parametrize("f", [64, 128, 2, 6, 3])
@pytest.mark.parametrize("name", ["pool", "edges", "hub", "cap", "perm"])
def test_segment_sum_route1_on_card(cuda, name, f):
    """The CSR segment sum's route 1 (route 2 at odd F) against the plain
    version at 1e-5 of the largest entry and route 2 to float32 rounding,
    bit-identical over two runs, every segment written (empty ones zero):
    the pool's shape with its 220-row padding segment, edge rows with a
    masked tail, a 2000-row segment, a cap, unsorted ids in ``perm``
    mode; and through the op (``segment_sum_dense``) the same bits."""
    data, ids, n, valid, perm, ptr, cap = _segment_case(cuda, name, f)
    _poisoned(cuda, (n, f))
    r1 = tfm.launch_segment_sum_rows(data, ptr, n, perm=perm, max_rows=cap)
    r1b = tfm.launch_segment_sum_rows(data, ptr, n, perm=perm, max_rows=cap)
    r2 = tfm.launch_segment_sum_rows(data, ptr, n, perm=perm, max_rows=cap,
                                     route=2)
    if perm is None:
        want = tfm.segment_sum_dense_plain(data, ids, n, valid=valid,
                                           max_per_segment=cap)
    else:
        want = tfm.segment_sum_dense_plain(data, ids, n)
    torch.cuda.synchronize()
    assert torch.equal(r1, r1b)
    _near_plain(r1, want)
    _near_plain(r1, r2)
    empty = ptr.diff() == 0
    assert bool((r1[empty] == 0).all())
    if name in ("edges", "pool"):
        op = tfm.segment_sum_dense(data, ids, n, valid=valid)
        torch.cuda.synchronize()
        assert torch.equal(op, r1)


def _arch(model_type, seed=0):
    from hydragnn_torch.models.base import GraphHeadCfg, ModelConfig
    from hydragnn_torch.models.create import create_model

    cfg = ModelConfig(
        model_type=model_type, input_dim=1, hidden_dim=64, output_dim=(1,),
        output_type=("graph",), graph_head=GraphHeadCfg(2, 64, 2, (64, 64)),
        node_head=None, task_weights=(1.0,), num_conv_layers=4, radius=1.8,
        max_neighbours=20, max_degree=20, pna_avg_deg_log=1.8,
        pna_avg_deg_lin=6.0)
    return cfg, create_model(cfg, seed=seed)


@pytest.mark.gpu
@pytest.mark.parametrize("model_type", ["GIN", "SAGE", "MFC", "PNA"])
def test_arch_train_steps_on_card_match_cpu(cuda, monkeypatch, model_type):
    """Three AdamW steps under fused, the card (kernels) and the CPU (plain
    versions) in lockstep: before each step the card model takes the CPU
    model's weights and BatchNorm buffers, then both step on the same
    batch.  Held at each step: the loss (1e-5), the BatchNorm statistics
    the forward updated (1e-4) and every parameter gradient, to 1e-3 of
    the model's largest gradient entry — BatchNorm makes the weights in
    front of it scale-invariant, so their gradients are small differences
    of large cancelling float32 sums, and Adam would blow that noise up to
    steps of the learning rate's size if the two runs went on alone.  Each
    architecture's kernels launch once per conv layer (the first layer's
    input needs no gradient)."""
    from hydragnn_torch.models.base import multihead_loss
    from hydragnn_torch.ops import poly_mp
    from hydragnn_torch.train.optimizer import select_optimizer
    from hydragnn_torch.train.trainer import create_train_state, make_train_step

    g = _schnet_batch(monkeypatch)
    sides = []
    for dev in (torch.device("cpu"), cuda):
        cfg, model = _arch(model_type, seed=1)
        model = model.to(dev)
        spec = select_optimizer({"type": "AdamW", "learning_rate": 1e-3})
        sides.append([model, create_train_state(model, spec),
                      make_train_step(model, cfg, spec), g.to(dev)])

    def loss_and_grads(model, gd):
        kept = [b.clone() for b in model.buffers()]
        model.train()
        loss, _ = multihead_loss(cfg, model(gd), gd)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        stats = [b.detach().cpu().clone() for b in model.buffers()]
        with torch.no_grad():
            for b_, k in zip(model.buffers(), kept):
                b_.copy_(k)
        return float(loss.detach()), [d.cpu() for d in grads], stats

    counted = {}
    for _ in range(3):
        sides[1][0].load_state_dict(sides[0][0].state_dict())
        (lc, gc, sc), (lg, gg, sg) = (loss_and_grads(m, gd)
                                      for m, _, _, gd in sides)
        assert abs(lg - lc) <= 1e-5 * abs(lc)
        top = max(float(d.abs().max()) for d in gc)
        for d_c, d_g in zip(gc, gg):
            assert float((d_c - d_g).abs().max()) <= 1e-3 * top
        for b_c, b_g in zip(sc, sg):
            torch.testing.assert_close(b_g, b_c, rtol=1e-4, atol=1e-5)
        tfm.reset_launches()
        poly_mp.reset_launches()
        for side in sides:
            side[1], _ = side[2](side[1], side[3])
        for k, v in {**tfm.LAUNCHES, **poly_mp.LAUNCHES}.items():
            counted[k] = counted.get(k, 0) + v
    want = {
        "GIN": {"gather_segment_sum": 12, "gather_segment_sum_dx": 9,
                "segment_sum_dense": 3},
        "SAGE": {"gather_poly_segment": 12, "gather_segment_sum_dx": 9,
                 "segment_sum_dense": 3},
        "MFC": {"gather_poly_segment": 12, "gather_segment_sum_dx": 9,
                "segment_sum_dense": 3},
        # per step: 1 pool + 4 tie counts + 2 gathers' backward in each of
        # the 3 layers whose input needs a gradient
        "PNA": {"segment_poly_dense": 12, "segment_sum_dense": 3 * 11},
    }[model_type]
    for k, v in counted.items():
        assert v == want.get(k, 0), (k, counted)


def _egcl_inputs(b, f, h, a, equivariant, seed):
    """Op inputs at a lecun-normal weight scale on the collate-shaped batch:
    geo = [diff (|diff| < 1), radial, A edge attributes]."""
    n, e = len(b["node_gid"]), len(b["senders"])
    g = torch.Generator().manual_seed(seed)
    geo = torch.cat([torch.rand(e, 3, generator=g) * 1.2 - 0.6,
                     torch.rand(e, 1 + a, generator=g) * 3.0], 1)
    ins = [torch.randn(n, f, generator=g), geo,
           torch.randn(2 * f + 1 + a, h, generator=g) / (2 * f + 1 + a) ** 0.5,
           torch.randn(h, generator=g) * 0.1,
           torch.randn(h, h, generator=g) / h ** 0.5,
           torch.randn(h, generator=g) * 0.1]
    if equivariant:
        ins += [torch.randn(h, h, generator=g) / h ** 0.5,
                torch.randn(h, generator=g) * 0.1,
                torch.randn(h, 1, generator=g) * 0.5]
    cts = (torch.randn(n, h, generator=g), torch.randn(n, 3, generator=g))
    return ins, cts


@pytest.mark.gpu
@pytest.mark.parametrize("equivariant", [True, False],
                         ids=["equivariant", "last-layer"])
@pytest.mark.parametrize("a", [0, 3])
@pytest.mark.parametrize("h", [32, 48, 64, 128])
@pytest.mark.parametrize("f", [1, 48, 128])
def test_egcl_kernels_match_plain_on_card(cuda, f, h, a, equivariant):
    """The three egcl kernels (forward, pass P with its reduction, pass S)
    through the autograd Function against autograd through the composed
    plain version, at every width the gate admits that the main path and
    the limits give: F = 1 (layer 0 on one node feature), 48 and 128; H =
    32, 48 (not a multiple of 32), 64 and 128 (weights streamed from L2);
    with and without edge attributes.  Pass P takes route 1 (tensor cores)
    at F, H <= 48 — md17's layers 0-3 and oc22's widths among them — and
    route 2 (the first design) past that, the card's choice the plan's
    (``pass_p_route``).  Forward, dx and dgeo 1e-5 of their largest entry,
    against the float32 plain version and against a float64 run of it;
    the edge-summed weight grads 1e-4; on route 1 every output and
    gradient also within the float64 bound (:func:`_float64_yardstick`);
    dgeo exactly zero on masked edges; a second run bit-identical; a NaN
    in the cotangent of agg in the same output and gradient entries as in
    the composed chain.  The biases are moved off the ReLU kinks first
    (``chip_smoke.egcl_off_kinks``): an edge whose ReLU input lies within
    float32 rounding of zero takes either branch in two correct
    computations."""
    from chip_smoke import egcl_off_kinks
    from hydragnn_torch.kernels.build import load_library
    from hydragnn_torch.ops import egcl_mp

    route = egcl_mp.pass_p_route(f, h, 1 + a, equivariant)
    assert load_library("egcl_mp").hg_egcl_pass_p_route(
        f, h, 1 + a, int(equivariant)) == route
    assert route == (1 if f <= 48 and h <= 48 else 2)
    b = _graph_batch(11 + f + h + a)
    ins, (ca, cp) = _egcl_inputs(b, f, h, a, equivariant, seed=3)
    ins, _ = egcl_off_kinks(torch, equivariant, ins, _t(b["senders"]),
                            _t(b["receivers"]), _t(b["edge_mask"]))
    ins = [t.to(cuda) for t in ins]
    ca, cp = ca.to(cuda), cp.to(cuda)
    send, recv = _t(b["senders"]).to(cuda), _t(b["receivers"]).to(cuda)
    perm = _t(b["perm"]).to(cuda)
    em = _t(b["edge_mask"]).to(torch.int32).to(cuda)

    def run(fn, inputs=ins, c_agg=ca):
        ts = [t.detach().clone().requires_grad_(True) for t in inputs]
        full = ts + [None] * (9 - len(ts))
        agg, psum = fn(equivariant, full[0], full[1], em, *full[2:], send,
                       recv)
        loss = (agg * c_agg.to(agg.dtype)).sum()
        if equivariant:
            loss = loss + (psum * cp.to(psum.dtype)).sum()
        loss.backward()
        torch.cuda.synchronize()
        outs = [agg.detach()] + ([psum.detach()] if equivariant else [])
        return outs, [t.grad for t in ts]

    egcl_mp.reset_launches()
    k_out, k_grads = run(lambda *a_: egcl_mp.egcl_block(*a_, perm))
    assert egcl_mp.LAUNCHES == {"egcl_block": 1, "egcl_block_pass_p": 1,
                                "egcl_block_pass_s": 1}
    again_out, again_grads = run(lambda *a_: egcl_mp.egcl_block(*a_, perm))
    for x_, y_ in zip(k_out + k_grads, again_out + again_grads):
        assert torch.equal(x_, y_)
    p_out, p_grads = run(egcl_mp.egcl_block_reference)
    p64_out, p64_grads = run(egcl_mp.egcl_block_reference,
                             [t.double() for t in ins])
    for i, (x_, y_, z_) in enumerate(zip(k_out, p_out, p64_out)):
        assert float((x_ - y_).abs().max()) <= 1e-5 * float(y_.abs().max())
        assert float((x_.double() - z_).abs().max()) <= 1e-5 * float(
            z_.abs().max())
        if route == 1:
            _float64_yardstick(f"out {i}", x_, y_, z_)
    real = em.bool()
    names = ("x", "geo", "w0", "b0", "w1", "b1", "wc0", "bc0", "wc1")
    for name, x_, y_, z_ in zip(names, k_grads, p_grads, p64_grads):
        if name == "geo":
            assert bool((x_[~real] == 0).all())
            x_, y_, z_ = x_[real], y_[real], z_[real]
        rel = 1e-5 if name in ("x", "geo") else 1e-4
        assert float((x_ - y_).abs().max()) <= rel * float(y_.abs().max()), \
            name
        if name in ("x", "geo"):
            assert float((x_.double() - z_).abs().max()) <= 1e-5 * float(
                z_.abs().max()), name
        if route == 1:
            _float64_yardstick(name, x_, y_, z_)
    # NaNs in the cotangent (one sender's whole row, so that some of its
    # edges pass the ReLU masks) reach the same entries as in the composed
    # chain: the products' hi/lo split keeps them, the masks select
    c_nan = ca.clone()
    c_nan[int(send[0])] = float("nan")
    kn = run(lambda *a_: egcl_mp.egcl_block(*a_, perm), c_agg=c_nan)
    pn = run(egcl_mp.egcl_block_reference, c_agg=c_nan)
    assert any(bool(torch.isnan(y_).any()) for y_ in pn[1])
    for name, x_, y_ in zip(names, kn[1], pn[1]):
        assert torch.equal(torch.isnan(x_), torch.isnan(y_)), name


@pytest.mark.gpu
@pytest.mark.parametrize("f,h,equivariant", [(48, 48, True), (1, 48, True),
                                             (48, 48, False),
                                             (128, 128, True)])
def test_egcl_pass_p_all_masked_on_card(cuda, f, h, equivariant):
    """Every edge masked (parked on the last node): the forward's rows and
    pass P's and pass S's every output and gradient exactly zero, on both
    routes of pass P."""
    from hydragnn_torch.ops import egcl_mp

    b = _graph_batch(5 + f + h)
    ins, (ca, cp) = _egcl_inputs(b, f, h, 0, equivariant, seed=4)
    ins = [t.to(cuda) for t in ins]
    n = ins[0].shape[0]
    send = torch.full_like(_t(b["senders"]), n - 1).to(cuda)
    recv = send.clone()
    em = torch.zeros(len(send), dtype=torch.int32, device=cuda)
    perm = torch.arange(len(send), dtype=torch.int32, device=cuda)
    ts = [t.detach().clone().requires_grad_(True) for t in ins]
    full = ts + [None] * (9 - len(ts))
    agg, psum = egcl_mp.egcl_block(equivariant, full[0], full[1], em,
                                   *full[2:], send, recv, perm)
    loss = (agg * ca.to(cuda)).sum()
    if equivariant:
        loss = loss + (psum * cp.to(cuda)).sum()
    loss.backward()
    torch.cuda.synchronize()
    assert float(agg.abs().max()) == 0
    for t in ts:
        assert float(t.grad.abs().max()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("f,h,equivariant", [(48, 48, True), (48, 48, False),
                                             (32, 32, False), (64, 48, True)],
                         ids=["md17-layers-1-2", "md17-layer-3",
                              "oc22-layer-1", "past-route-1"])
def test_egcl_pass_s_routes_on_card(cuda, f, h, equivariant):
    """egcl pass S alone, as the backward launches it: its route the plan's
    (``hg_egcl_pass_s_route`` equals ``egcl_mp.pass_s_route``); route 1
    (pass P's tensor-core chain in receiver order, a warp per share of the
    rows, 16-edge tiles) at md17's and oc22's instantiations that launch
    it; both routes within 1e-5 of the plain version's largest entry after
    the biases are moved off the ReLU kinks (``chip_smoke.egcl_off_kinks``),
    bit-identical twice; rows without a real incoming edge exactly zero;
    route 1 refused past its widths.  Node 0 receives 200 extra edges, so
    its row straddles thirteen 16-edge tiles."""
    from chip_smoke import egcl_off_kinks
    from hydragnn_torch.kernels.build import load_library
    from hydragnn_torch.ops import egcl_mp
    from hydragnn_torch.ops.aggregate import segment_offsets

    own = egcl_mp.pass_s_route(f, h, 1, equivariant)
    assert load_library("egcl_mp").hg_egcl_pass_s_route(
        f, h, 1, int(equivariant)) == own
    assert own == (1 if f <= 48 and h <= 48 else 2)
    b = _graph_batch(29 + f + h, hub=200)
    ins, (ca, cp) = _egcl_inputs(b, f, h, 0, equivariant, seed=6)
    send, recv = _t(b["senders"]), _t(b["receivers"])
    em = _t(b["edge_mask"]).to(torch.int32)
    ins, _ = egcl_off_kinks(torch, equivariant, ins, send, recv, em)
    ins = [t.to(cuda) for t in ins]
    full = ins + [None] * (9 - len(ins))
    ca = ca.to(cuda)
    cp = cp.to(cuda) if equivariant else None
    send, recv, em = send.to(cuda), recv.to(cuda), em.to(cuda)
    n = ins[0].shape[0]
    ws = egcl_mp.kernel_weights(equivariant, *full[2:], f, h, ins[0].device)
    ptr_r = segment_offsets(recv, n, em)
    with torch.no_grad():
        def launch(route):
            return egcl_mp.launch_egcl("egcl_block_pass_s", equivariant,
                                       ins[0], ins[1], ws, send, recv, None,
                                       ptr_r, ca, cp, route=route)

        plain = egcl_mp.egcl_pass_s_plain(equivariant, ins[0], ins[1], em,
                                          *full[2:], send, recv, ca, cp)
        routes = [2] + ([1] if own == 1 else [])
        if own == 2:
            with pytest.raises(ValueError, match="route"):
                launch(1)
        no_in = ~torch.isin(torch.arange(n, device=cuda), recv[em != 0])
        assert bool(no_in.any())
        scale = float(plain.abs().max())
        for route in routes:
            got = launch(route)
            again = launch(route)
            torch.cuda.synchronize()
            assert torch.equal(got, again), route
            assert float((got - plain).abs().max()) <= 1e-5 * scale, route
            assert bool((got[no_in] == 0).all()), route
        assert torch.equal(launch(0), launch(own))


@pytest.mark.gpu
@pytest.mark.parametrize("f,h,equivariant", [(48, 48, True), (48, 48, False),
                                             (1, 48, True), (32, 32, False),
                                             (64, 48, True)],
                         ids=["md17-layers-1-2", "md17-layer-3",
                              "md17-layer-0", "oc22-layer-1",
                              "past-route-1"])
def test_egcl_fwd_routes_on_card(cuda, f, h, equivariant):
    """The egcl forward alone, as the Function launches it: its route the
    plan's (``hg_egcl_fwd_route`` equals ``egcl_mp.fwd_route``); route 1
    (the front of pass P's tensor-core chain in sender order, a warp per
    share of the sender rows, 16-edge tiles) at md17's and oc22's
    instantiations; both routes within 1e-5 of the plain version's largest
    entry (agg and psum) after the biases are moved off the ReLU kinks
    (``chip_smoke.egcl_off_kinks``), bit-identical twice; rows without a
    real outgoing edge exactly zero; all edges masked, every row exactly
    zero; route 1 refused past its widths.  The batch is
    ``_graph_batch``'s with senders and receivers swapped, so node 0 sends
    200 extra edges and its row straddles thirteen 16-edge tiles."""
    from chip_smoke import egcl_off_kinks
    from hydragnn_torch.kernels.build import load_library
    from hydragnn_torch.ops import egcl_mp

    own = egcl_mp.fwd_route(f, h, 1, equivariant)
    assert load_library("egcl_mp").hg_egcl_fwd_route(
        f, h, 1, int(equivariant)) == own
    assert own == (1 if f <= 48 and h <= 48 else 2)
    b = _graph_batch(31 + f + h, hub=200)
    ins, _ = _egcl_inputs(b, f, h, 0, equivariant, seed=8)
    send, recv = _t(b["receivers"]), _t(b["senders"])
    em = _t(b["edge_mask"]).to(torch.int32)
    ins, _ = egcl_off_kinks(torch, equivariant, ins, send, recv, em)
    ins = [t.to(cuda) for t in ins]
    full = ins + [None] * (9 - len(ins))
    send, recv, em = send.to(cuda), recv.to(cuda), em.to(cuda)
    n = ins[0].shape[0]
    ws = egcl_mp.kernel_weights(equivariant, *full[2:], f, h, ins[0].device)

    def launch(route, mask=em):
        key = send.long() + n * (mask == 0).long()
        perm = torch.argsort(key, stable=True).to(torch.int32)
        return egcl_mp.launch_egcl(
            "egcl_block", equivariant, ins[0], ins[1], ws, send, recv, perm,
            egcl_mp._sender_schedule(send, mask, perm, n), route=route)

    with torch.no_grad():
        agg, psum = egcl_mp.egcl_block_reference(
            equivariant, ins[0], ins[1], em, *full[2:], send, recv)
        if own == 2:
            with pytest.raises(ValueError, match="route"):
                launch(1)
        no_out = ~torch.isin(torch.arange(n, device=cuda), send[em != 0])
        assert bool(no_out.any())
        for route in [2] + ([1] if own == 1 else []):
            got = launch(route)
            again = launch(route)
            torch.cuda.synchronize()
            assert (got[1] is None) == (not equivariant), route
            for x_, y_, z_ in zip(got, again, (agg, psum)):
                if z_ is None:
                    continue
                assert torch.equal(x_, y_), route
                assert float((x_ - z_).abs().max()) <= 1e-5 * float(
                    z_.abs().max()), route
                assert bool((x_[no_out] == 0).all()), route
            dead = launch(route, torch.zeros_like(em))
            for x_ in dead:
                if x_ is not None:
                    assert float(x_.abs().max()) == 0, route
        for x_, y_ in zip(launch(0), launch(own)):
            assert (x_ is None and y_ is None) or torch.equal(x_, y_)


@pytest.mark.gpu
def test_egnn_train_steps_on_card_match_cpu(cuda, monkeypatch):
    """md17's EGNN widths (hidden 48, 4 convs, equivariant): three AdamW
    steps under fused from one init on the card (kernels) and on the CPU
    (plain versions), the same losses and parameters to 1e-4; per step 4
    forward, 4 pass P and 3 pass S launches (layer 0's input needs no
    gradient), 1 pool and 6 segment sums (the backward of layers 1-3's two
    position gathers)."""
    from hydragnn_torch.models.base import GraphHeadCfg, ModelConfig
    from hydragnn_torch.models.create import create_model
    from hydragnn_torch.ops import egcl_mp
    from hydragnn_torch.train.optimizer import select_optimizer
    from hydragnn_torch.train.trainer import create_train_state, make_train_step

    g = _schnet_batch(monkeypatch)
    cfg = ModelConfig(
        model_type="EGNN", input_dim=1, hidden_dim=48, output_dim=(1,),
        output_type=("graph",), graph_head=GraphHeadCfg(2, 48, 2, (48, 48)),
        node_head=None, task_weights=(1.0,), num_conv_layers=4, radius=1.8,
        max_neighbours=20, equivariance=True)
    runs = []
    for dev in (torch.device("cpu"), cuda):
        model = create_model(cfg, seed=1).to(dev)
        spec = select_optimizer({"type": "AdamW", "learning_rate": 1e-3})
        state = create_train_state(model, spec)
        step = make_train_step(model, cfg, spec)
        tfm.reset_launches()
        egcl_mp.reset_launches()
        losses = []
        gd = g.to(dev)
        for _ in range(3):
            state, m = step(state, gd)
            losses.append(float(m["loss"]))
        runs.append((losses, [p.detach().cpu() for p in model.parameters()]))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-4, atol=1e-6)
    for a, b in zip(runs[1][1], runs[0][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert egcl_mp.LAUNCHES == {"egcl_block": 12, "egcl_block_pass_p": 12,
                                "egcl_block_pass_s": 9}
    assert tfm.LAUNCHES["segment_sum_dense"] == 21


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [False, True], ids=["ones", "dropout"])
@pytest.mark.parametrize("h,f", [(4, 8), (4, 10), (40, 1), (6, 64),
                                 (3, 256), (8, 128)],
                         ids=["HF32", "HF40", "HF40-F1", "HF384", "HF768",
                              "HF1024"])
def test_gat_kernels_match_plain_on_card(cuda, h, f, bits):
    """The three GAT kernels (forward, pass R with its partial sum, pass S)
    through the autograd Function against autograd through the plain
    forward, at H*F = 32, 40 (F = 10 and F = 1, widths that do not divide
    32), 384 (hidden 64), 768 (a head group of hidden 256) and 1024 (the
    limit), with ones and with dropout bits: acc, d, dxl and dxr within
    1e-5 of their largest entry, d att 1e-4, m equal (both sum each
    head's lanes in lane order); rows without a real edge read m = -1e9
    and zero gradients; a second run bit-identical."""
    from hydragnn_torch.ops import gat_mp

    b = _graph_batch(23 + h + f)
    n, e = len(b["node_gid"]), len(b["senders"])
    g = torch.Generator().manual_seed(h * f)
    xl = torch.randn(n, h * f, generator=g).to(cuda)
    xr = torch.randn(n, h * f, generator=g).to(cuda)
    att = (torch.randn(h, f, generator=g) / f ** 0.5).to(cuda)
    bb = None
    if bits:
        bb = ((torch.rand(e, h, generator=g) < 0.75).float() / 0.75).to(cuda)
    ca = torch.randn(n, h * f, generator=g).to(cuda)
    cd = torch.randn(n, h, generator=g).to(cuda)
    send, recv = _t(b["senders"]).to(cuda), _t(b["receivers"]).to(cuda)
    perm, em = _t(b["perm"]).to(cuda), _t(b["edge_mask"]).to(cuda)

    def run(fn):
        ts = [t.detach().clone().requires_grad_(True) for t in (xl, xr, att)]
        acc, m, d = fn(*ts)
        ((acc * ca).sum() + (d * cd).sum()).backward()
        torch.cuda.synchronize()
        return [acc.detach(), m, d.detach()], [t.grad for t in ts]

    gat_mp.reset_launches()
    k_out, k_grads = run(lambda a, c, w: gat_mp.gat_edge_attention(
        a, c, w, send, recv, perm, em, bb, 0.05, f))
    assert gat_mp.LAUNCHES == {"gat_edge_attention": 1,
                               "gat_edge_attention_pass_r": 1,
                               "gat_edge_attention_pass_s": 1}
    again = run(lambda a, c, w: gat_mp.gat_edge_attention(
        a, c, w, send, recv, perm, em, bb, 0.05, f))
    for x_, y_ in zip(k_out + k_grads, again[0] + again[1]):
        assert torch.equal(x_, y_)
    p_out, p_grads = run(lambda a, c, w: gat_mp.gat_edge_attention_reference(
        a, c, w, send, recv, em, bb, 0.05))
    assert torch.equal(k_out[1], p_out[1])
    for name, x_, y_ in (("acc", k_out[0], p_out[0]), ("d", k_out[2],
                                                       p_out[2])):
        assert float((x_ - y_).abs().max()) <= 1e-5 * float(y_.abs().max()), \
            name
    for name, x_, y_ in zip(("dxl", "dxr", "datt"), k_grads, p_grads):
        rel = 1e-4 if name == "datt" else 1e-5
        assert float((x_ - y_).abs().max()) <= rel * float(y_.abs().max()), \
            name
    real = em != 0
    nodes = torch.arange(n, device=cuda)
    no_in = ~torch.isin(nodes, recv[real])
    no_out = ~torch.isin(nodes, send[real])
    assert bool(no_in.any()) and bool((no_in & no_out).any())
    assert bool((k_out[1][no_in] == -1e9).all())
    assert bool((k_out[2][no_in] == 0).all())
    assert bool((k_grads[1][no_in] == 0).all())
    assert bool((k_grads[0][no_in & no_out] == 0).all())


@pytest.mark.gpu
def test_gat_kernels_refuse_what_they_do_not_take(cuda):
    from hydragnn_torch.ops import gat_mp

    b = _graph_batch(3)
    n, e = len(b["node_gid"]), len(b["senders"])
    send, recv = _t(b["senders"]).to(cuda), _t(b["receivers"]).to(cuda)
    row_ptr = torch.zeros(n + 1, dtype=torch.int32, device=cuda)
    x = torch.zeros(n, 2048, device=cuda)
    with pytest.raises(ValueError, match="H\\*F <= 1024"):
        gat_mp.launch_gat("gat_edge_attention", x, x,
                          torch.zeros(8, 256, device=cuda), send, recv, None,
                          row_ptr, None, 0.05)
    x = torch.zeros(n, 32, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        gat_mp.launch_gat("gat_edge_attention", x, x,
                          torch.zeros(4, 8, device=cuda), send, recv, None,
                          row_ptr, None, 0.05)
    assert e > 0


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [False, True], ids=["ones", "dropout"])
@pytest.mark.parametrize("h,f", [(6, 64), (3, 256), (4, 8), (3, 12),
                                 (8, 128), (16, 32), (1, 96), (24, 16),
                                 (40, 1)],
                         ids=["HF384", "HF768", "HF32", "HF36", "HF1024",
                              "HF512-H16", "HF96-H1", "HF384-F16",
                              "HF40-F1"])
def test_gat_pass_s_routes_on_card(cuda, h, f, bits):
    """GAT pass S alone on the forward's m, as the backward launches it:
    its route the plan's (``hg_gat_pass_s_route`` equals
    ``gat_mp.pass_s_route``); route 1 (head sums across lanes, edges in
    flight) where the widths take it, bit-identical twice; both routes
    within 1e-5 of the plain version's largest entry (route 1 sums the
    logits in another order than the forward, which moves p = exp(e - m)
    by a rounding of e); rows that send no real edge exactly zero; route 1
    refused where the widths do not take it.  Node 0 receives 200 extra
    edges from nodes 0-4, so those send over 32 edges each."""
    from hydragnn_torch.kernels.build import load_library
    from hydragnn_torch.ops import gat_mp
    from hydragnn_torch.ops.aggregate import segment_offsets

    b = _graph_batch(57 + h + f, hub=200)
    n, e = len(b["node_gid"]), len(b["senders"])
    g = torch.Generator().manual_seed(h + f)
    xl, xr, ga = (torch.randn(n, h * f, generator=g).to(cuda)
                  for _ in range(3))
    att = (torch.randn(h, f, generator=g) / f ** 0.5).to(cuda)
    gd = torch.randn(n, h, generator=g).to(cuda)
    bb = None
    if bits:
        bb = ((torch.rand(e, h, generator=g) < 0.75).float() / 0.75).to(cuda)
    send, recv = _t(b["senders"]).to(cuda), _t(b["receivers"]).to(cuda)
    perm, em = _t(b["perm"]).to(cuda), _t(b["edge_mask"]).to(cuda)
    p_ = perm.long()
    ptr_s = segment_offsets(send[p_], n, em[p_])
    own = gat_mp.pass_s_route(h * f, f)
    assert load_library("gat_mp").hg_gat_pass_s_route(h * f, f) == own
    with torch.no_grad():
        _, m, _ = gat_mp.gat_edge_attention_reference(xl, xr, att, send,
                                                      recv, em, bb, 0.05)

        def launch(route):
            return gat_mp.launch_gat("gat_edge_attention_pass_s", xl, xr, att,
                                     send, recv, perm, ptr_s, bb, 0.05, m,
                                     ga, gd, route=route)

        plain = gat_mp.gat_pass_s_plain(xl, xr, att, send, recv, em, bb, m,
                                        ga, gd, 0.05)
        routes = [2] + ([1] if own == 1 else [])
        if own == 2:
            with pytest.raises(ValueError, match="route"):
                launch(1)
        no_out = ~torch.isin(torch.arange(n, device=cuda), send[em != 0])
        assert bool(no_out.any())
        scale = float(plain.abs().max())
        for route in routes:
            got = launch(route)
            again = launch(route)
            torch.cuda.synchronize()
            assert torch.equal(got, again), route
            assert float((got - plain).abs().max()) <= 1e-5 * scale, route
            assert bool((got[no_out] == 0).all()), route
        assert torch.equal(launch(0), launch(own))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [False, True], ids=["ones", "dropout"])
@pytest.mark.parametrize("h,f", [(6, 64), (3, 256), (4, 8), (3, 12),
                                 (8, 128), (16, 32), (1, 96), (24, 16),
                                 (40, 1)],
                         ids=["HF384", "HF768", "HF32", "HF36", "HF1024",
                              "HF512-H16", "HF96-H1", "HF384-F16",
                              "HF40-F1"])
def test_gat_pass_r_routes_on_card(cuda, h, f, bits):
    """GAT pass R alone on the forward's m, as the backward launches it:
    its route the plan's (``hg_gat_pass_r_route`` equals
    ``gat_mp.pass_r_route``, pass S's rule); route 1 (head sums across
    lanes, edges in flight, d att partials in registers) where the widths
    take it; both routes within 1e-5 (dxr) and 1e-4 (d att, a sum over
    every edge in another order) of the plain version's largest entry,
    bit-identical twice; rows without a real incoming edge exactly zero;
    route 1 refused where the widths do not take it.  Node 0 receives 200
    extra edges, so its row spans seven groups of 32 sender ids."""
    from hydragnn_torch.kernels.build import load_library
    from hydragnn_torch.ops import gat_mp
    from hydragnn_torch.ops.aggregate import segment_offsets

    b = _graph_batch(61 + h + f, hub=200)
    n = len(b["node_gid"])
    e = len(b["senders"])
    g = torch.Generator().manual_seed(2 * h + f)
    xl, xr, ga = (torch.randn(n, h * f, generator=g).to(cuda)
                  for _ in range(3))
    att = (torch.randn(h, f, generator=g) / f ** 0.5).to(cuda)
    gd = torch.randn(n, h, generator=g).to(cuda)
    bb = None
    if bits:
        bb = ((torch.rand(e, h, generator=g) < 0.75).float() / 0.75).to(cuda)
    send, recv = _t(b["senders"]).to(cuda), _t(b["receivers"]).to(cuda)
    em = _t(b["edge_mask"]).to(cuda)
    ptr_r = segment_offsets(recv, n, em)
    own = gat_mp.pass_r_route(h * f, f)
    assert own == gat_mp.pass_s_route(h * f, f)
    assert load_library("gat_mp").hg_gat_pass_r_route(h * f, f) == own
    with torch.no_grad():
        _, m, _ = gat_mp.gat_edge_attention_reference(xl, xr, att, send,
                                                      recv, em, bb, 0.05)

        def launch(route):
            return gat_mp.launch_gat("gat_edge_attention_pass_r", xl, xr, att,
                                     send, recv, None, ptr_r, bb, 0.05, m,
                                     ga, gd, route=route)

        plain = gat_mp.gat_pass_r_plain(xl, xr, att, send, recv, em, bb, m,
                                        ga, gd, 0.05)
        routes = [2] + ([1] if own == 1 else [])
        if own == 2:
            with pytest.raises(ValueError, match="route"):
                launch(1)
        no_in = ~torch.isin(torch.arange(n, device=cuda), recv[em != 0])
        assert bool(no_in.any())
        for route in routes:
            got = launch(route)
            again = launch(route)
            torch.cuda.synchronize()
            for name, x_, y_, z_, tol in zip(("dxr", "datt"), got, again,
                                             plain, (1e-5, 1e-4)):
                assert torch.equal(x_, y_), (route, name)
                assert float((x_ - z_).abs().max()) <= tol * float(
                    z_.abs().max()), (route, name)
            assert bool((got[0][no_in] == 0).all()), route
        for x_, y_ in zip(launch(0), launch(own)):
            assert torch.equal(x_, y_)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [False, True], ids=["ones", "dropout"])
@pytest.mark.parametrize("h,f", [(6, 64), (3, 256), (4, 8), (3, 12),
                                 (8, 128), (16, 32), (1, 96), (24, 16),
                                 (40, 1)],
                         ids=["HF384", "HF768", "HF32", "HF36", "HF1024",
                              "HF512-H16", "HF96-H1", "HF384-F16",
                              "HF40-F1"])
def test_gat_fwd_routes_on_card(cuda, h, f, bits):
    """The GAT forward alone, as the op launches it: its route the plan's
    (``hg_gat_fwd_route`` equals ``gat_mp.fwd_route``, and its group U
    ``gat_mp.fwd_group``); route 1 (lane-order logits of U edges in
    flight, one rescale a group) where the widths take it; on both routes
    m equal to the plain version's (both sum each head's lanes in lane
    order), acc and d within 1e-5 of their largest entry, bit-identical
    twice; rows without a real incoming edge read m = -1e9, d = 0 and acc
    = 0; route 1 refused where the widths do not take it.  Node 0 receives
    200 extra edges, so its row spans seven groups of 32 sender ids."""
    from hydragnn_torch.kernels.build import load_library
    from hydragnn_torch.ops import gat_mp
    from hydragnn_torch.ops.aggregate import segment_offsets

    b = _graph_batch(67 + h + f, hub=200)
    n, e = len(b["node_gid"]), len(b["senders"])
    g = torch.Generator().manual_seed(3 * h + f)
    xl, xr = (torch.randn(n, h * f, generator=g).to(cuda) for _ in range(2))
    att = (torch.randn(h, f, generator=g) / f ** 0.5).to(cuda)
    bb = None
    if bits:
        bb = ((torch.rand(e, h, generator=g) < 0.75).float() / 0.75).to(cuda)
    send, recv = _t(b["senders"]).to(cuda), _t(b["receivers"]).to(cuda)
    em = _t(b["edge_mask"]).to(cuda)
    ptr_r = segment_offsets(recv, n, em)
    own = gat_mp.fwd_route(h * f, f)
    lib = load_library("gat_mp")
    assert lib.hg_gat_fwd_route(h * f, f) == own
    assert lib.hg_gat_fwd_group(h * f, f) == gat_mp.fwd_group(h * f, f)
    with torch.no_grad():
        def launch(route):
            return gat_mp.launch_gat("gat_edge_attention", xl, xr, att, send,
                                     recv, None, ptr_r, bb, 0.05,
                                     route=route)

        plain = gat_mp.gat_edge_attention_reference(xl, xr, att, send, recv,
                                                    em, bb, 0.05)
        routes = [2] + ([1] if own == 1 else [])
        if own == 2:
            with pytest.raises(ValueError, match="route"):
                launch(1)
        no_in = ~torch.isin(torch.arange(n, device=cuda), recv[em != 0])
        assert bool(no_in.any())
        for route in routes:
            got = launch(route)
            again = launch(route)
            torch.cuda.synchronize()
            for x_, y_ in zip(got, again):
                assert torch.equal(x_, y_), route
            assert torch.equal(got[1], plain[1]), route
            for name, i in (("acc", 0), ("d", 2)):
                assert float((got[i] - plain[i]).abs().max()) <= 1e-5 * float(
                    plain[i].abs().max()), (route, name)
            assert bool((got[1][no_in] == -1e9).all()), route
            assert bool((got[2][no_in] == 0).all()), route
            assert bool((got[0][no_in] == 0).all()), route
        for x_, y_ in zip(launch(0), launch(own)):
            assert torch.equal(x_, y_)


@pytest.mark.gpu
@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_gat_train_steps_on_card_match_cpu(cuda, monkeypatch, dropout):
    """GAT at the arch-sweep widths (hidden 64, 6 heads, 4 convs): three
    AdamW steps under fused in lockstep, card (kernels) against CPU (plain
    versions), as for the other BatchNorm architectures; with dropout the
    bits are drawn on the CPU for both sides
    (``chip_smoke.cpu_dropout_bits``).  Per step 4 forward, 4 pass R and 4
    pass S launches (layer 0's xl and xr need gradients for lin_l and
    lin_r) and 1 pool."""
    from chip_smoke import cpu_dropout_bits
    from hydragnn_torch.models.base import (
        GraphHeadCfg,
        ModelConfig,
        multihead_loss,
    )
    from hydragnn_torch.models.create import create_model
    from hydragnn_torch.ops import gat_mp
    from hydragnn_torch.train.optimizer import select_optimizer
    from hydragnn_torch.train.trainer import create_train_state, make_train_step

    g = _schnet_batch(monkeypatch)
    cfg = ModelConfig(
        model_type="GAT", input_dim=1, hidden_dim=64, output_dim=(1,),
        output_type=("graph",), graph_head=GraphHeadCfg(2, 64, 2, (64, 64)),
        node_head=None, task_weights=(1.0,), num_conv_layers=4,
        dropout=dropout)
    sides = []
    for dev in (torch.device("cpu"), cuda):
        model = create_model(cfg, seed=1).to(dev)
        spec = select_optimizer({"type": "AdamW", "learning_rate": 1e-3})
        sides.append([model, create_train_state(model, spec),
                      make_train_step(model, cfg, spec), g.to(dev)])

    def loss_and_grads(model, gd, seed):
        kept = [b_.clone() for b_ in model.buffers()]
        model.train()
        loss, _ = multihead_loss(cfg, model(gd, dropout_seed=seed), gd)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        stats = [b_.detach().cpu().clone() for b_ in model.buffers()]
        with torch.no_grad():
            for b_, k in zip(model.buffers(), kept):
                b_.copy_(k)
        return float(loss.detach()), [d.cpu() for d in grads], stats

    counted = {}
    with cpu_dropout_bits():
        for step in range(3):
            sides[1][0].load_state_dict(sides[0][0].state_dict())
            (lc, gc, sc), (lg, gg, sg) = (loss_and_grads(m, gd, step)
                                          for m, _, _, gd in sides)
            assert abs(lg - lc) <= 1e-5 * abs(lc)
            top = max(float(d.abs().max()) for d in gc)
            for d_c, d_g in zip(gc, gg):
                assert float((d_c - d_g).abs().max()) <= 1e-3 * top
            for b_c, b_g in zip(sc, sg):
                torch.testing.assert_close(b_g, b_c, rtol=1e-4, atol=1e-5)
            tfm.reset_launches()
            gat_mp.reset_launches()
            for side in sides:
                side[1], _ = side[2](side[1], side[3])
            for k, v in {**tfm.LAUNCHES, **gat_mp.LAUNCHES}.items():
                counted[k] = counted.get(k, 0) + v
    assert counted == {
        "gather_mul_segment_sum": 0, "gather_mul_segment_sum_dx": 0,
        "gather_segment_sum": 0, "gather_segment_sum_dx": 0,
        "segment_sum_dense": 3, "gat_edge_attention": 12,
        "gat_edge_attention_pass_r": 12, "gat_edge_attention_pass_s": 12}


@pytest.mark.gpu
@pytest.mark.parametrize("want_ea", [True, False], ids=["dea", "no-dea"])
@pytest.mark.parametrize("a", [0, 5], ids=["no-edge-attr", "edge-attr"])
@pytest.mark.parametrize("f,d", [(1, 1), (24, 16), (64, 64), (32, 96),
                                 (40, 33), (256, 256)])
def test_cgcnn_kernels_match_plain_on_card(cuda, f, d, a, want_ea):
    """The three cgcnn kernels (forward with its node table, pass P with
    its node table and reduction, pass S) through the autograd Function
    against autograd through the composed plain version: F = 1 (layer 0 on
    one node feature), 24 with D = 16 (a transposed block shows), 64 (the
    arch sweep's CGCNN), D = 96 and 33 (the forward's four columns a lane,
    and its scalar loads at an odd D) and the limit 256 (the forward's
    eight columns a lane; sixteen slices of pass P's output columns); with
    and without edge attributes, and their gradient asked or not.  Node 0
    receives 200 extra edges (a row over several edge tiles, past an even
    share of the edges); other rows have none.  Forward, dx and d
    edge_attr 1e-5 of their largest entry, the edge-summed weight and bias
    grads 1e-4; the forward and the gradients also against a float64 run
    (:func:`_float64_yardstick`: the forward's node table runs in 3xTF32);
    d edge_attr exactly zero on masked edges; a second run
    bit-identical."""
    from hydragnn_torch.ops import cgcnn_mp

    b = _graph_batch(31 + f + a, hub=200)
    n, e = len(b["node_gid"]), len(b["senders"])
    g = torch.Generator().manual_seed(4)
    ins = [torch.randn(n, f, generator=g),
           torch.randn(e, a, generator=g) * 0.5 if a else None,
           torch.randn(2 * f + a, d, generator=g) / (2 * f + a) ** 0.5,
           torch.randn(d, generator=g) * 0.1,
           torch.randn(2 * f + a, d, generator=g) / (2 * f + a) ** 0.5,
           torch.randn(d, generator=g) * 0.1]
    ins = [None if t is None else t.to(cuda) for t in ins]
    ct = torch.randn(n, d, generator=g).to(cuda)
    send, recv = _t(b["senders"]).to(cuda), _t(b["receivers"]).to(cuda)
    perm = _t(b["perm"]).to(cuda)
    em = _t(b["edge_mask"]).to(torch.int32).to(cuda)

    def run(fn, inputs):
        ts = [None if t is None else t.detach().clone().requires_grad_(
            want_ea or i != 1) for i, t in enumerate(inputs)]
        out = fn(ts[0], ts[1], em, *ts[2:], send, recv)
        (out * ct.to(out.dtype)).sum().backward()
        torch.cuda.synchronize()
        return [out.detach()] + [None if t is None else t.grad for t in ts]

    cgcnn_mp.reset_launches()
    k = run(lambda *a_: cgcnn_mp.cgcnn_gated_block(*a_, perm), ins)
    assert cgcnn_mp.LAUNCHES == {"cgcnn_block": 1, "cgcnn_block_pass_p": 1,
                                 "cgcnn_block_pass_s": 1}
    again = run(lambda *a_: cgcnn_mp.cgcnn_gated_block(*a_, perm), ins)
    for x_, y_ in zip(k, again):
        assert (x_ is None and y_ is None) or torch.equal(x_, y_)
    p = run(cgcnn_mp.cgcnn_block_reference, ins)
    p64 = run(cgcnn_mp.cgcnn_block_reference,
              [None if t is None else t.double() for t in ins])
    real = em.bool()
    names = ("out", "x", "edge_attr", "kf", "bf", "ks", "bs")
    for name, x_, y_, z_ in zip(names, k, p, p64):
        if x_ is None:
            assert y_ is None
            continue
        if name == "edge_attr":
            assert bool((x_[~real] == 0).all())
            x_, y_, z_ = x_[real], y_[real], z_[real]
        rel = 1e-5 if name in ("out", "x", "edge_attr") else 1e-4
        assert float((x_ - y_).abs().max()) <= rel * float(y_.abs().max()), \
            name
        _float64_yardstick(name, x_, y_, z_)


@pytest.mark.gpu
@pytest.mark.parametrize("a", [0, 5], ids=["no-edge-attr", "edge-attr"])
@pytest.mark.parametrize("f,d", [(64, 64), (24, 16), (256, 256), (1, 1),
                                 (40, 33), (32, 96)])
def test_cgcnn_pass_s_on_card(cuda, f, d, a):
    """cgcnn pass S alone, as the backward launches it, on the node table
    that a pass-P launch wrote (gathered sums per sender row, then one row
    product in 3xTF32): within 1e-5 of the plain version's largest entry,
    within a float64 run's bound (:func:`_float64_yardstick`) and
    bit-identical twice; rows that send no real edge exactly zero.  Nodes
    0-4 send the 200 extra edges of node 0 (over 32 ids a row: several
    groups of loads)."""
    from hydragnn_torch.ops import cgcnn_mp
    from hydragnn_torch.ops.aggregate import segment_offsets

    b = _graph_batch(71 + f + a, hub=200)
    n, e = len(b["node_gid"]), len(b["senders"])
    g = torch.Generator().manual_seed(5)
    ins = [torch.randn(n, f, generator=g),
           torch.randn(e, a, generator=g) * 0.5 if a else None,
           torch.randn(2 * f + a, d, generator=g) / (2 * f + a) ** 0.5,
           torch.randn(d, generator=g) * 0.1,
           torch.randn(2 * f + a, d, generator=g) / (2 * f + a) ** 0.5,
           torch.randn(d, generator=g) * 0.1]
    ins = [None if t is None else t.to(cuda) for t in ins]
    ct = torch.randn(n, d, generator=g).to(cuda)
    send, recv = _t(b["senders"]).to(cuda), _t(b["receivers"]).to(cuda)
    perm = _t(b["perm"]).to(cuda)
    em = _t(b["edge_mask"]).to(torch.int32).to(cuda)
    p_ = perm.long()
    ptr_r = segment_offsets(recv, n, em)
    ptr_s = segment_offsets(send[p_], n, em[p_])
    ws = cgcnn_mp.kernel_weights(*ins[2:], f, a, ins[0].device)
    table = torch.empty((n, 4 * d), device=cuda)
    with torch.no_grad():
        cgcnn_mp.launch_cgcnn("cgcnn_block_pass_p", ins[0], ins[1], ws, send,
                              recv, None, ptr_r, ct, want_dx=False,
                              table=table)
        k, again = (cgcnn_mp.launch_cgcnn(
            "cgcnn_block_pass_s", ins[0], ins[1], ws, send, recv, perm, ptr_s,
            ct, table=table) for _ in range(2))
        p32 = cgcnn_mp.cgcnn_pass_s_plain(ins[0], ins[1], em, *ins[2:], send,
                                          recv, ct)
        p64 = cgcnn_mp.cgcnn_pass_s_plain(
            *(None if t is None else t.double() for t in ins[:2]), em,
            *(t.double() for t in ins[2:]), send, recv, ct.double())
    torch.cuda.synchronize()
    assert torch.equal(k, again)
    assert float((k - p32).abs().max()) <= 1e-5 * float(p32.abs().max())
    _float64_yardstick("dx_sender", k, p32, p64)
    no_out = ~torch.isin(torch.arange(n, device=cuda), send[em != 0])
    assert bool(no_out.any()) and bool((k[no_out] == 0).all())


@pytest.mark.gpu
def test_cgcnn_kernels_refuse_what_they_do_not_take(cuda):
    from hydragnn_torch.ops import cgcnn_mp

    b = _graph_batch(8, n_real=40, n_pad=48, e_pad=512)
    send, recv = _t(b["senders"]).to(cuda), _t(b["receivers"]).to(cuda)
    perm = _t(b["perm"]).to(cuda)
    em = _t(b["edge_mask"]).to(torch.int32).to(cuda)
    x = torch.randn(48, 257, device=cuda)
    k = torch.randn(514, 8, device=cuda)
    bias = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="F <= 256"):
        cgcnn_mp.cgcnn_gated_block(x, None, em, k, bias, k, bias, send, recv,
                                   perm)
    x = torch.randn(48, 8, device=cuda).double()
    k = torch.randn(16, 8, device=cuda).double()
    with pytest.raises(TypeError):
        cgcnn_mp.cgcnn_gated_block(x, None, em, k, bias.double(), k,
                                   bias.double(), send, recv, perm)
    # pass S's route 1 reads pass P's node table: it does not run without
    x = torch.randn(48, 8, device=cuda)
    ws = cgcnn_mp.kernel_weights(torch.randn(16, 8, device=cuda), bias,
                                 torch.randn(16, 8, device=cuda), bias, 8, 0,
                                 x.device)
    row_ptr = torch.zeros(49, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="node table"):
        cgcnn_mp.launch_cgcnn("cgcnn_block_pass_s", x, None, ws, send, recv,
                              perm, row_ptr, torch.zeros(48, 8, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["pallas", "sorted"])
def test_segment_sum_kernels_match_plain_on_card(cuda, which):
    """The pallas backend's two segment sums on the card: unsorted ids with
    out-of-range ones (pallas) and the receivers with a pre-masked padded
    tail (sorted, capped at the largest real in-degree), forward and VJP
    against the plain version, 1e-5; one launch each under its own key."""
    from hydragnn_torch.ops import aggregate

    b = _graph_batch(12)
    n, e = len(b["node_gid"]), len(b["senders"])
    g = torch.Generator().manual_seed(5)
    mask = _t(b["edge_mask"])
    data = torch.randn(e, 64, generator=g)
    if which == "pallas":
        ids = torch.where(mask != 0, _t(b["senders"]),
                          n + torch.arange(e, dtype=torch.int32) % 3)
        fn, key = aggregate.segment_sum_pallas, "segment_sum_pallas"
    else:
        data = data * mask[:, None]
        ids = _t(b["receivers"])
        cap = int(torch.bincount(ids[mask != 0].long(), minlength=n).max())
        fn = lambda d_, i_, s_: aggregate.segment_sum_sorted(d_, i_, s_, cap)
        key = "segment_sum_sorted"
    ct = torch.randn(n, 64, generator=g).to(cuda)
    data, ids = data.to(cuda), ids.to(cuda)
    aggregate.reset_launches()
    k = _grads(lambda d_: fn(d_, ids, n), (data,), ct)
    kout = fn(data, ids, n)
    p = _grads(lambda d_: tfm.segment_sum_dense_plain(d_, ids, n), (data,),
               ct)
    pout = tfm.segment_sum_dense_plain(data, ids, n)
    torch.cuda.synchronize()
    assert aggregate.LAUNCHES[key] == 2 and sum(
        aggregate.LAUNCHES.values()) == 2
    torch.testing.assert_close(kout, pout, **TOL)
    torch.testing.assert_close(k[0], p[0], **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["gather_mul_segment_sum",
                                "gather_segment_sum"])
def test_double_backward_on_card_matches_cpu(cuda, op):
    """A double backward (create_graph, then a backward through the first
    gradients) through the linear Functions: the card's first and second
    derivatives equal the CPU's within 1e-5 of their largest entry, and
    the second derivative is not zero."""
    b = _graph_batch(13)
    n, e = len(b["node_gid"]), len(b["senders"])
    g = torch.Generator().manual_seed(6)
    mask = _t(b["edge_mask"])
    x0, w0 = torch.randn(n, 16, generator=g), torch.randn(e, 16, generator=g)
    w0 = w0 * mask[:, None]
    c1, c2 = torch.randn(n, 16, generator=g), torch.randn(n, 16, generator=g)
    c3 = torch.randn(e, 16, generator=g) * mask[:, None]

    def second(dev):
        s, r = _t(b["senders"]).to(dev), _t(b["receivers"]).to(dev)
        p, m = _t(b["perm"]).to(dev), mask.to(dev)
        xs = x0.to(dev).requires_grad_(True)
        if op == "gather_mul_segment_sum":
            ws = w0.to(dev).requires_grad_(True)
            out = tfm.gather_mul_segment_sum(xs, ws, s, r, p, edge_valid=m)
            leaves, cs = (xs, ws), (c2.to(dev), c3.to(dev))
        else:
            out = tfm.gather_segment_sum(xs, s, r, p, m)
            leaves, cs = (xs,), (c2.to(dev),)
        first = torch.autograd.grad((out.square() * c1.to(dev)).sum(),
                                    leaves, create_graph=True)
        inner = sum((a_ * c_).sum() for a_, c_ in zip(first, cs))
        return [t.detach().cpu() for t in
                tuple(first) + tuple(torch.autograd.grad(inner, leaves))]

    tfm.reset_launches()
    card = second(cuda)
    torch.cuda.synchronize()
    assert tfm.LAUNCHES[f"{op}_dx"] >= 2
    for x_, y_ in zip(card, second(torch.device("cpu"))):
        assert float((x_ - y_).abs().max()) <= 1e-5 * float(y_.abs().max())
    assert float(card[-1].abs().max()) > 0


@pytest.mark.gpu
def test_cgcnn_train_steps_on_card_match_cpu(cuda, monkeypatch):
    """CGCNN at the arch sweep's widths (input = hidden = 64, 4 convs): three
    AdamW steps under fused in lockstep, card (kernels) against CPU (plain
    versions), as for the other BatchNorm architectures.  Per step 4
    forward, 4 pass P and 3 pass S launches (layer 0's input is data) and
    1 pool."""
    import dataclasses

    from hydragnn_torch.models.base import (
        GraphHeadCfg,
        ModelConfig,
        multihead_loss,
    )
    from hydragnn_torch.models.create import create_model
    from hydragnn_torch.ops import cgcnn_mp
    from hydragnn_torch.train.optimizer import select_optimizer
    from hydragnn_torch.train.trainer import create_train_state, make_train_step

    g = _schnet_batch(monkeypatch)
    gen = torch.Generator().manual_seed(2)
    g = dataclasses.replace(
        g, x=torch.rand(g.x.shape[0], 64, generator=gen) * g.node_mask[:, None])
    cfg = ModelConfig(
        model_type="CGCNN", input_dim=64, hidden_dim=64, output_dim=(1,),
        output_type=("graph",), graph_head=GraphHeadCfg(2, 64, 2, (64, 64)),
        node_head=None, task_weights=(1.0,), num_conv_layers=4, edge_dim=0)
    sides = []
    for dev in (torch.device("cpu"), cuda):
        model = create_model(cfg, seed=1).to(dev)
        spec = select_optimizer({"type": "AdamW", "learning_rate": 1e-3})
        sides.append([model, create_train_state(model, spec),
                      make_train_step(model, cfg, spec), g.to(dev)])

    def loss_and_grads(model, gd):
        kept = [b_.clone() for b_ in model.buffers()]
        model.train()
        loss, _ = multihead_loss(cfg, model(gd), gd)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        stats = [b_.detach().cpu().clone() for b_ in model.buffers()]
        with torch.no_grad():
            for b_, k in zip(model.buffers(), kept):
                b_.copy_(k)
        return float(loss.detach()), [d.cpu() for d in grads], stats

    counted = {}
    for _ in range(3):
        sides[1][0].load_state_dict(sides[0][0].state_dict())
        (lc, gc, sc), (lg, gg, sg) = (loss_and_grads(m, gd)
                                      for m, _, _, gd in sides)
        assert abs(lg - lc) <= 1e-5 * abs(lc)
        top = max(float(d.abs().max()) for d in gc)
        for d_c, d_g in zip(gc, gg):
            assert float((d_c - d_g).abs().max()) <= 1e-4 * top
        for b_c, b_g in zip(sc, sg):
            torch.testing.assert_close(b_g, b_c, rtol=1e-4, atol=1e-5)
        tfm.reset_launches()
        cgcnn_mp.reset_launches()
        for side in sides:
            side[1], _ = side[2](side[1], side[3])
        for k, v in {**tfm.LAUNCHES, **cgcnn_mp.LAUNCHES}.items():
            counted[k] = counted.get(k, 0) + v
    assert counted == {
        "gather_mul_segment_sum": 0, "gather_mul_segment_sum_dx": 0,
        "gather_segment_sum": 0, "gather_segment_sum_dx": 0,
        "segment_sum_dense": 3, "cgcnn_block": 12,
        "cgcnn_block_pass_p": 12, "cgcnn_block_pass_s": 9}


def _dimenet_tables(n_edges, n_tri, s, seed, hubs=(), gap=None):
    """A triplet table as add_dimenet_extras lays it out: idx_ji
    nondecreasing, a masked tail parked on the last edge, the stable
    argsort of idx_kj.  ``gap`` (lo, hi) leaves those kj rows without a
    triplet.  ``hubs`` lists (row, count): that kj row gets ``count`` more
    triplets, taken from rows of the table's second half; a row given as
    (first, position) is the row after ``first`` whose triplets begin at
    most ``position`` triplets past those of row ``first``, and nearest to
    it."""
    rng = np.random.RandomState(seed)
    real = n_tri - n_tri // 5
    ji = np.sort(rng.randint(0, n_edges - 1, real))
    kj = rng.randint(0, n_edges - 1, real)
    if gap is not None:
        inside = (kj >= gap[0]) & (kj < gap[1])
        kj[inside] = gap[1] + (kj[inside] - gap[0]) % (n_edges - 1 - gap[1])
    for row, count in hubs:
        if not isinstance(row, int):
            first, position = row
            ends = np.cumsum(np.bincount(kj, minlength=n_edges)[first:])
            row = first + int(np.searchsorted(ends, position, side="right"))
        donors = np.flatnonzero(kj >= n_edges // 2)
        kj[rng.choice(donors, count, replace=False)] = row
    pad = np.full(n_tri - real, n_edges - 1)
    idx_ji = np.concatenate([ji, pad]).astype(np.int32)
    idx_kj = np.concatenate([kj, pad]).astype(np.int32)
    tmask = (np.arange(n_tri) < real).astype(np.int32)
    perm = np.argsort(idx_kj, kind="stable").astype(np.int32)
    return idx_kj, idx_ji, tmask, perm


@pytest.mark.gpu
@pytest.mark.parametrize("all_masked", [False, True],
                         ids=["masked-tail", "all-masked"])
@pytest.mark.parametrize("s,r,b,d", [(7, 6, 8, 64), (7, 3, 8, 16),
                                     (8, 8, 64, 64), (1, 1, 1, 1)])
def test_dn_tri_kernels_match_plain_on_card(cuda, s, r, b, d, all_masked):
    """The dn_tri forward and backward through the autograd Function
    against autograd through the composed plain version: the arch sweep's
    widths (S = 7, R = 6, B = 8, D = 64), the JAX test's (7, 3, 8, 16), the
    limits (8, 8, 64, 64) and one lane each.  The backward gathers the
    triplets of a chunk of kj rows (16 rows, 8 at the limits) 96 at a
    time: kj row 3 holds ~210 triplets from ~25 into its chunk (three
    batches); a second row, the one whose triplets begin nearest to 90
    past row 16's, holds ~210 from there (83-89 into its 16-row chunk:
    four batches); rows 100-149 hold none (whole chunks without a
    triplet).  Forward, d radial, d x2 and d cbf
    1e-5 of their largest entry, the triplet-summed dW1, dW2 1e-4; every
    gradient also within the float64 bound (:func:`_float64_yardstick`); d
    cbf exactly zero on masked triplets; a second run bit-identical.  The
    backward also as the DimeNet path launches it (d x2 and the weights
    only: radial and cbf come from pos), the outputs not asked for not
    formed.  The forward's route on the card is the plan's
    (``dn_tri.fwd_route``): route 1 at (7, 6, 8, 64) and (7, 3, 8, 16),
    its output also within the float64 bound and the first design (route
    2) at the same inputs held to the plain version at 1e-5; route 2 at
    the limits and at one lane."""
    from hydragnn_torch.kernels.build import load_library
    from hydragnn_torch.ops import dn_tri
    from hydragnn_torch.ops.aggregate import segment_offsets

    route = dn_tri.fwd_route(s, s * r, b, d)
    assert load_library("dn_tri").hg_dn_tri_fwd_route(s, s * r, b,
                                                      d) == route
    assert route == (1 if (s, r, b, d) in ((7, 6, 8, 64), (7, 3, 8, 16))
                     else 2)
    e, t = 700, 6000
    kj, ji, tm, perm = (_t(a).to(cuda) for a in _dimenet_tables(
        e, t, s, 5 + s + b, hubs=((3, 200), ((16, 90), 200)),
        gap=(100, 150)))
    if all_masked:
        tm = torch.zeros_like(tm)
    g = torch.Generator().manual_seed(3)
    ins = [torch.rand(e, s * r, generator=g),
           torch.randn(e, d, generator=g),
           torch.randn(t, s, generator=g) * 0.5,
           torch.randn(s * r, b, generator=g) / (s * r) ** 0.5,
           torch.randn(b, d, generator=g) / b ** 0.5]
    ins = [x.to(cuda) for x in ins]
    ct = torch.randn(e, d, generator=g).to(cuda)

    def run(fn, inputs=ins):
        ts = [x.detach().clone().requires_grad_(True) for x in inputs]
        out = fn(*ts)
        (out * ct.to(out.dtype)).sum().backward()
        torch.cuda.synchronize()
        return [out.detach()] + [x.grad for x in ts]

    dn_tri.reset_launches()
    k = run(lambda *a: dn_tri.dimenet_triplet_mp(*a, kj, ji, tm, perm, r))
    assert {k_: v for k_, v in dn_tri.LAUNCHES.items() if v} == {
        "dimenet_triplet_mp": 1, "dimenet_triplet_mp_bwd": 1}
    again = run(lambda *a: dn_tri.dimenet_triplet_mp(*a, kj, ji, tm, perm,
                                                     r))
    for x_, y_ in zip(k, again):
        assert torch.equal(x_, y_)
    p = run(lambda *a: dn_tri.dimenet_triplet_reference(*a, kj, ji, tm, r))
    p64 = run(lambda *a: dn_tri.dimenet_triplet_reference(*a, kj, ji, tm, r),
              [x.double() for x in ins])
    assert bool((k[3][tm == 0] == 0).all())
    names = ("out", "radial", "x2", "cbf", "w1", "w2")
    for name, x_, y_, z_ in zip(names, k, p, p64):
        if all_masked:
            assert float(x_.abs().max()) == 0, name
            continue
        rel = 1e-5 if name in ("out", "radial", "x2", "cbf") else 1e-4
        assert float((x_ - y_).abs().max()) <= rel * float(y_.abs().max()), \
            name
        if name != "out" or route == 1:
            _float64_yardstick(name, x_, y_, z_)
    if route == 1 and not all_masked:
        # the first design at route 1's widths, as the path would launch it
        with torch.no_grad():
            k2 = dn_tri.launch_dn_tri(
                "dimenet_triplet_mp", *[x.contiguous() for x in ins], kj, ji,
                None, segment_offsets(ji, e, tm), r, route=2)
        torch.cuda.synchronize()
        assert float((k2 - p[0]).abs().max()) <= 1e-5 * float(
            p[0].abs().max())

    # the backward as the path launches it
    pk = perm.long()
    path = dn_tri.launch_dn_tri(
        "dimenet_triplet_mp_bwd", *[x.contiguous() for x in ins], kj, ji,
        perm, segment_offsets(kj[pk], e, tm[pk]), r, ct,
        want=(False, True, False, True))
    torch.cuda.synchronize()
    assert path[0] is None and path[2] is None
    for name, x_, y_ in zip(("x2", "w1", "w2"), (path[1], path[3], path[4]),
                            (p[2], p[4], p[5])):
        if all_masked:
            assert float(x_.abs().max()) == 0, name
            continue
        rel = 1e-5 if name == "x2" else 1e-4
        assert float((x_ - y_).abs().max()) <= rel * float(y_.abs().max()), \
            name


@pytest.mark.gpu
@pytest.mark.parametrize("fwd", [1, 2], ids=["fwd-route1", "fwd-route2"])
@pytest.mark.parametrize("din,h,nb,na,e,route", [
    (64, 64, 1, 2, 1003, 1), (64, 64, 1, 2, 100, 1), (16, 24, 1, 2, 1003, 1),
    (8, 8, 0, 0, 1003, 1), (40, 33, 0, 3, 1003, 1), (64, 64, 2, 2, 1003, 2),
    (65, 65, 1, 2, 1003, 2), (128, 128, 1, 2, 1003, 2),
    (32, 128, 3, 1, 1003, 2)])
def test_row_mlp_kernels_match_plain_on_card(cuda, din, h, nb, na, e, route,
                                             fwd):
    """The row_mlp forward and backward through the autograd Function
    against autograd through the composed chain, on both routes of the
    backward and across their boundary: route 1 (weights resident, tensor
    cores) at the arch sweep's widths (64, 64, one pair before the skip, two
    after; also on 100 rows, fewer 16-row tiles than the card has SMs), the
    JAX test's (16, 24), no residual pairs, and widths that pad to 64 with
    three pairs; route 2 at H = 64 with four pairs, H = 65, the limit 128
    (8- or 16-row tiles), and Din < H with more pairs.  The forward's
    route is the backward's at each of these widths, on the card
    (``hg_row_mlp_fwd_route``) as in the plan (``row_mlp.fwd_route``).
    Forward, d tri, d x_ji, d x_edge 1e-5 of their largest entry, the
    row-summed weight and bias grads 1e-4; on route 1 every output also
    within the float64 bound (:func:`_float64_yardstick`; route 2, the
    first design on the CUDA cores, lies just past it for d x_edge at H =
    128, on an H100: 1.04e-6 of the largest entry); a second run
    bit-identical; rows not a multiple of a tile; the forward also
    launched alone on the route ``fwd`` asks for (route 1 refused where
    the widths do not take it): 1e-5, bit-identical twice, route 1 within
    the float64 bound; then each of tri, x_ji, x_edge left without a
    gradient in turn (the backward's ``want``), the others unchanged; a
    NaN in the cotangent in the same gradient entries as the composed
    chain's."""
    from hydragnn_torch.kernels.build import load_library
    from hydragnn_torch.ops import row_mlp

    assert row_mlp.bwd_route(din, h, nb, na) == route
    assert row_mlp.fwd_route(din, h, nb, na) == route
    assert load_library("row_mlp").hg_row_mlp_fwd_route(din, h, nb,
                                                        na) == route
    g = torch.Generator().manual_seed(din + h)
    ins = [torch.randn(e, din, generator=g), torch.randn(e, h, generator=g),
           torch.randn(e, h, generator=g)]
    wb = [torch.randn(din, h, generator=g) / din ** 0.5, None]
    for _ in range(2 * (nb + na) + 1):
        wb += [torch.randn(h, h, generator=g) / h ** 0.5,
               torch.randn(h, generator=g) * 0.1]
    ins = [x.to(cuda) for x in ins]
    wb = [None if w is None else w.to(cuda) for w in wb]
    ct = torch.randn(e, h, generator=g).to(cuda)

    def run(fn, inputs=ins, weights=wb, need=(True,) * 3):
        ti = [x.detach().clone().requires_grad_(n)
              for x, n in zip(inputs, need)]
        tw = [None if w is None else w.detach().clone().requires_grad_(True)
              for w in weights]
        out = fn(*ti, nb, na, *tw)
        (out * ct.to(out.dtype)).sum().backward()
        torch.cuda.synchronize()
        return ([out.detach()] + [x.grad for x in ti],
                [w.grad for w in tw if w is not None])

    row_mlp.reset_launches()
    k = run(row_mlp.dimenet_post_mlp)
    assert row_mlp.LAUNCHES == {"dimenet_post_mlp": 1,
                                "dimenet_post_mlp_bwd": 1}
    again = run(row_mlp.dimenet_post_mlp)
    for x_, y_ in zip(k[0] + k[1], again[0] + again[1]):
        assert torch.equal(x_, y_)
    p = run(row_mlp.dimenet_post_mlp_reference)
    p64 = run(row_mlp.dimenet_post_mlp_reference, [x.double() for x in ins],
              [None if w is None else w.double() for w in wb])
    for i, (x_, y_, z_) in enumerate(zip(k[0], p[0], p64[0])):
        assert float((x_ - y_).abs().max()) <= 1e-5 * float(
            y_.abs().max()), i
        if route == 1:
            _float64_yardstick(f"output {i}", x_, y_, z_)
    # the forward alone on the route asked for
    w_p, b_p = row_mlp.pack_weights(wb, din, h, cuda)

    def forward(route_):
        return row_mlp.launch_row_mlp("dimenet_post_mlp", *ins, w_p, b_p, nb,
                                      na, route=route_)

    if fwd == 1 and route != 1:
        with pytest.raises(ValueError, match="route"):
            forward(1)
    else:
        with torch.no_grad():
            got, again = forward(fwd), forward(fwd)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert float((got - p[0][0]).abs().max()) <= 1e-5 * float(
            p[0][0].abs().max())
        if fwd == 1:
            _float64_yardstick("forward, route 1", got, p[0][0], p64[0][0])
            assert torch.equal(got, k[0][0])
    for i, (x_, y_, z_) in enumerate(zip(k[1], p[1], p64[1])):
        assert float((x_ - y_).abs().max()) <= 1e-4 * float(
            y_.abs().max()), f"wb {i}"
        if route == 1:
            _float64_yardstick(f"wb {i}", x_, y_, z_)
    for skip in range(3):
        need = tuple(i != skip for i in range(3))
        part = run(row_mlp.dimenet_post_mlp, need=need)
        assert part[0][1 + skip] is None
        for x_, y_ in zip(part[0] + part[1], k[0] + k[1]):
            assert x_ is None or torch.equal(x_, y_)
    # a NaN in the cotangent reaches the same gradient entries as in the
    # composed chain: the products' hi/lo split keeps it
    ct[e // 2, h // 3] = float("nan")
    kn = run(row_mlp.dimenet_post_mlp)
    pn = run(row_mlp.dimenet_post_mlp_reference)
    for i, (x_, y_) in enumerate(zip(kn[0][1:] + kn[1], pn[0][1:] + pn[1])):
        assert bool(torch.isnan(y_).any()), i
        assert torch.equal(torch.isnan(x_), torch.isnan(y_)), i


@pytest.mark.gpu
def test_dimenet_kernels_refuse_what_they_do_not_take(cuda):
    from hydragnn_torch.ops import dn_tri, row_mlp

    kj, ji, tm, perm = (_t(a).to(cuda) for a in _dimenet_tables(50, 200, 9,
                                                               1))
    with pytest.raises(ValueError, match="S <= 8"):
        dn_tri.dimenet_triplet_mp(
            torch.rand(50, 18, device=cuda), torch.rand(50, 8, device=cuda),
            torch.rand(200, 9, device=cuda), torch.rand(18, 4, device=cuda),
            torch.rand(4, 8, device=cuda), kj, ji, tm, perm, 2)
    with pytest.raises(TypeError):
        dn_tri.dimenet_triplet_mp(
            torch.rand(50, 6, device=cuda).double(),
            torch.rand(50, 8, device=cuda).double(),
            torch.rand(200, 2, device=cuda).double(),
            torch.rand(6, 4, device=cuda).double(),
            torch.rand(4, 8, device=cuda).double(), kj, ji, tm, perm, 3)
    x = torch.rand(10, 129, device=cuda)
    with pytest.raises(ValueError, match="H <= 128"):
        row_mlp.dimenet_post_mlp(
            x, x, x, 0, 0, torch.rand(129, 129, device=cuda), None,
            torch.rand(129, 129, device=cuda), torch.rand(129, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("all_masked", [False, True],
                         ids=["masked-tail", "all-masked"])
@pytest.mark.parametrize("sr,b,d", [(42, 8, 128), (21, 8, 96), (43, 5, 24),
                                    (64, 8, 8), (70, 8, 64),
                                    (126, 128, 128), (127, 33, 1)])
def test_dn_tri_builder_kernels_match_plain_on_card(cuda, sr, b, d,
                                                    all_masked):
    """The builder's forward, pass S and pass P through the autograd
    Function against autograd through the composed plain version: the
    dimenet_wide cell's widths (S*R = 42, B = 8, D = 128), the JAX tests'
    (21, 8, 96), an odd S*R with B < 8 (43, 5, 24) and route 1's limits
    (64, 8, 8) — the forward's route 1, tensor cores — then (70, 8, 64),
    the limits (126, 128, 128: four slices of B in pass P) and a ragged
    slice (127, 33, 1) on route 2, the first design; the card's route the
    plan's (``builder_fwd_route``).  Forward, d x_kj and d sbf 1e-5 of
    their largest entry, the triplet-summed dk1, dk2 1e-4; the forward
    also 1e-5 against a float64 run of the plain version and, on route 1,
    within the float64 bound (:func:`_float64_yardstick`); d sbf exactly
    zero on masked triplets; a second run bit-identical; a NaN in x_kj and
    one in sbf in the same output entries as in the composed forward."""
    from hydragnn_torch.kernels.build import load_library
    from hydragnn_torch.ops import dn_tri

    route = dn_tri.builder_fwd_route(sr, b, d)
    assert load_library("dn_tri_builder").hg_dn_tri_builder_fwd_route(
        sr, b, d) == route
    assert route == (1 if (sr, b, d) in ((42, 8, 128), (21, 8, 96),
                                         (43, 5, 24), (64, 8, 8)) else 2)
    e, t = 700, 6000
    kj, ji, tm, perm = (_t(a).to(cuda) for a in
                        _dimenet_tables(e, t, 1, 7 + sr + b))
    if all_masked:
        tm = torch.zeros_like(tm)
    g = torch.Generator().manual_seed(4)
    ins = [torch.randn(e, d, generator=g),
           torch.randn(t, sr, generator=g) * 0.5,
           torch.randn(sr, b, generator=g) / sr ** 0.5,
           torch.randn(b, d, generator=g) / b ** 0.5]
    ins = [x.to(cuda) for x in ins]
    ct = torch.randn(e, d, generator=g).to(cuda)

    def run(fn):
        ts = [x.detach().clone().requires_grad_(True) for x in ins]
        out = fn(ts[0], ts[1], tm, ts[2], ts[3], kj, ji)
        (out * ct).sum().backward()
        torch.cuda.synchronize()
        return [out.detach()] + [x.grad for x in ts]

    def kern(*a):
        return dn_tri.dimenet_tri_builder(*a, perm)

    dn_tri.reset_launches()
    k = run(kern)
    assert {k_: v for k_, v in dn_tri.LAUNCHES.items() if v} == {
        "dimenet_tri_builder": 1, "dimenet_tri_builder_bwd_s": 1,
        "dimenet_tri_builder_bwd_p": 1}
    again = run(kern)
    for x_, y_ in zip(k, again):
        assert torch.equal(x_, y_)
    p = run(dn_tri.dimenet_tri_builder_reference)
    assert bool((k[2][tm == 0] == 0).all())
    for name, x_, y_ in zip(("out", "x_kj", "sbf", "k1", "k2"), k, p):
        if all_masked:
            assert float(x_.abs().max()) == 0, name
            continue
        assert float(y_.abs().max()) > 0, name
        rel = 1e-5 if name in ("out", "x_kj", "sbf") else 1e-4
        assert float((x_ - y_).abs().max()) <= rel * float(y_.abs().max()), \
            name
    if all_masked:
        return
    with torch.no_grad():
        p64 = dn_tri.dimenet_tri_builder_reference(
            *(x.double() for x in ins[:2]), tm,
            *(x.double() for x in ins[2:]), kj, ji)
    assert float((k[0].double() - p64).abs().max()) <= 1e-5 * float(
        p64.abs().max())
    if route == 1:
        _float64_yardstick("out", k[0], p[0], p64)
    # NaNs in the inputs reach the same output entries: a gathered row's
    # column, and a whole triplet's message through its basis row
    real = int(tm.sum())
    ins[0][int(kj[real // 2]), d // 2] = float("nan")
    ins[1][real // 3, 0] = float("nan")
    with torch.no_grad():
        kn = kern(ins[0], ins[1], tm, ins[2], ins[3], kj, ji)
        pn = dn_tri.dimenet_tri_builder_reference(ins[0], ins[1], tm,
                                                  ins[2], ins[3], kj, ji)
    torch.cuda.synchronize()
    assert bool(torch.isnan(pn).any())
    assert torch.equal(torch.isnan(kn), torch.isnan(pn))


@pytest.mark.gpu
@pytest.mark.parametrize("sr,b,d", [(42, 8, 128), (21, 8, 96), (64, 8, 8)])
def test_dn_tri_builder_pass_s_route1_on_card(cuda, sr, b, d):
    """Pass S's route 1 (the forward's tensor-core kernel in kj order),
    which the training path takes: sbf without a gradient, so d sbf is not
    asked for.  The dimenet_wide cell's widths, the JAX tests' and route
    1's limits, on a table with a masked tail and two ~210-triplet kj rows
    (several tiles, one beginning mid-tile).  The card's routes are the
    plan's (``builder_bwd_s_route``, also with d sbf asked, route 2);
    d x_kj 1e-5 of its largest entry against the plain version and within
    the float64 bound (:func:`_float64_yardstick`), dk1 and dk2 1e-4; one
    launch of each kernel; a second run bit-identical."""
    from hydragnn_torch.kernels.build import load_library
    from hydragnn_torch.ops import dn_tri

    lib = load_library("dn_tri_builder")
    for want_sbf in (False, True):
        assert lib.hg_dn_tri_builder_bwd_s_route(sr, b, d, want_sbf) == \
            dn_tri.builder_bwd_s_route(sr, b, d, want_sbf) == \
            (2 if want_sbf else 1)
    e, t = 700, 6000
    kj, ji, tm, perm = (_t(a).to(cuda) for a in _dimenet_tables(
        e, t, 1, 11 + sr + d, hubs=((40, 210), ((300, 40), 210))))
    g = torch.Generator().manual_seed(5)
    ins = [torch.randn(e, d, generator=g),
           torch.randn(t, sr, generator=g) * 0.5,
           torch.randn(sr, b, generator=g) / sr ** 0.5,
           torch.randn(b, d, generator=g) / b ** 0.5]
    ins = [x.to(cuda) for x in ins]
    ct = torch.randn(e, d, generator=g).to(cuda)

    def run(fn, inputs):
        ts = [x.detach().clone().requires_grad_(i != 1)
              for i, x in enumerate(inputs)]
        out = fn(ts[0], ts[1], tm, ts[2], ts[3], kj, ji)
        (out * ct.to(out.dtype)).sum().backward()
        torch.cuda.synchronize()
        return [ts[0].grad, ts[2].grad, ts[3].grad]

    def kern(*a):
        return dn_tri.dimenet_tri_builder(*a, perm)

    dn_tri.reset_launches()
    k = run(kern, ins)
    assert {k_: v for k_, v in dn_tri.LAUNCHES.items() if v} == {
        "dimenet_tri_builder": 1, "dimenet_tri_builder_bwd_s": 1,
        "dimenet_tri_builder_bwd_p": 1}
    again = run(kern, ins)
    for x_, y_ in zip(k, again):
        assert torch.equal(x_, y_)
    p = run(dn_tri.dimenet_tri_builder_reference, ins)
    p64 = run(dn_tri.dimenet_tri_builder_reference, [x.double() for x in ins])
    for name, x_, y_, z_ in zip(("x_kj", "k1", "k2"), k, p, p64):
        assert float(y_.abs().max()) > 0, name
        rel = 1e-5 if name == "x_kj" else 1e-4
        assert float((x_ - y_).abs().max()) <= rel * float(y_.abs().max()), \
            name
    _float64_yardstick("x_kj", k[0], p[0], p64[0])


@pytest.mark.gpu
@pytest.mark.parametrize("sr,b,d", [(42, 8, 128), (21, 8, 96), (43, 5, 24),
                                    (64, 8, 8), (70, 8, 64),
                                    (126, 128, 128)])
def test_dn_tri_builder_pass_p_routes_on_card(cuda, sr, b, d):
    """The builder's pass P alone, as the backward launches it: its route
    the plan's (``hg_dn_tri_builder_bwd_p_route`` equals
    ``dn_tri.builder_bwd_p_route``); route 1 (the forward's ring, each warp
    on its own share of the ji rows, dK1 and dK2 in registers) at the
    forward's route-1 widths, dimenet_wide's (42, 8, 128) among them; both
    routes' dk1 and dk2 within 1e-4 of the plain version's largest entry,
    route 1 also within the float64 bound (:func:`_float64_yardstick`),
    bit-identical twice; every triplet masked, exactly zero; route 1
    refused past its widths.  The table leaves ji rows without triplets and
    has a ~210-triplet ji row (several tiles of one warp)."""
    from hydragnn_torch.kernels.build import load_library
    from hydragnn_torch.ops import dn_tri
    from hydragnn_torch.ops.aggregate import segment_offsets

    own = dn_tri.builder_bwd_p_route(sr, b, d)
    assert load_library("dn_tri_builder").hg_dn_tri_builder_bwd_p_route(
        sr, b, d) == own
    assert own == (1 if b <= 8 and sr <= 64 else 2)
    e, t = 700, 6000
    kj, ji, tm, _ = _dimenet_tables(e, t, 1, 13 + sr + d)
    real = int(tm.sum())
    ji[real // 2:real // 2 + 210] = ji[real // 2]   # still nondecreasing
    kj, ji, tm = (_t(a).to(cuda) for a in (kj, ji, tm))
    g = torch.Generator().manual_seed(6)
    x, sbf, k1, k2, ct = (a.to(cuda) for a in (
        torch.randn(e, d, generator=g), torch.randn(t, sr, generator=g) * 0.5,
        torch.randn(sr, b, generator=g) / sr ** 0.5,
        torch.randn(b, d, generator=g) / b ** 0.5,
        torch.randn(e, d, generator=g)))
    assert bool((torch.bincount(ji[tm != 0].long(), minlength=e) == 0).any())

    def launch(route, mask=tm):
        return dn_tri.launch_dn_tri_builder(
            "dimenet_tri_builder_bwd_p", x, sbf, k1, k2, kj, ji, None,
            segment_offsets(ji, e, mask), ct, route=route)

    with torch.no_grad():
        plain = dn_tri.dimenet_tri_builder_pass_p_plain(x, sbf, tm, k1, k2,
                                                        kj, ji, ct)
        p64 = dn_tri.dimenet_tri_builder_pass_p_plain(
            x.double(), sbf.double(), tm, k1.double(), k2.double(), kj, ji,
            ct.double())
        if own == 2:
            with pytest.raises(ValueError, match="route"):
                launch(1)
        for route in [2] + ([1] if own == 1 else []):
            got = launch(route)
            again = launch(route)
            dead = launch(route, torch.zeros_like(tm))
            torch.cuda.synchronize()
            for name, x_, y_, z_, w_, q_ in zip(("k1", "k2"), got, again,
                                                dead, plain, p64):
                assert torch.equal(x_, y_), (route, name)
                assert float(z_.abs().max()) == 0, (route, name)
                assert float((x_ - w_).abs().max()) <= 1e-4 * float(
                    w_.abs().max()), (route, name)
                if route == 1:
                    _float64_yardstick(name, x_, w_, q_)
        for x_, y_ in zip(launch(0), launch(own)):
            assert torch.equal(x_, y_)


@pytest.mark.gpu
def test_dn_tri_builder_refuses_what_it_does_not_take(cuda):
    from hydragnn_torch.ops import dn_tri

    kj, ji, tm, perm = (_t(a).to(cuda) for a in _dimenet_tables(50, 200, 1,
                                                               2))
    with pytest.raises(ValueError, match="S\\*R <= 127"):
        dn_tri.dimenet_tri_builder(
            torch.rand(50, 8, device=cuda), torch.rand(200, 128, device=cuda),
            tm, torch.rand(128, 4, device=cuda),
            torch.rand(4, 8, device=cuda), kj, ji, perm)
    with pytest.raises(ValueError, match="D <= 128"):
        dn_tri.dimenet_tri_builder(
            torch.rand(50, 129, device=cuda), torch.rand(200, 42, device=cuda),
            tm, torch.rand(42, 8, device=cuda),
            torch.rand(8, 129, device=cuda), kj, ji, perm)
    with pytest.raises(TypeError):
        dn_tri.dimenet_tri_builder(
            torch.rand(50, 8, device=cuda).double(),
            torch.rand(200, 42, device=cuda).double(), tm,
            torch.rand(42, 8, device=cuda).double(),
            torch.rand(8, 8, device=cuda).double(), kj, ji, perm)


def _dimenet_steps(cuda, monkeypatch, widths, remat=False):
    """Three AdamW steps of DimeNet on 16 molecule-sized graphs under
    fused, card (kernels) against CPU (plain versions) in lockstep (the
    card takes the CPU's weights before each step): loss 1e-5, every
    gradient 1e-4 of the largest.  Returns the launches of the steps."""
    from hydragnn_torch.graph.batch import GraphSample, HeadSpec, PadSpec, collate
    from hydragnn_torch.graph.neighborlist import radius_graph
    from hydragnn_torch.models.base import (
        GraphHeadCfg,
        ModelConfig,
        multihead_loss,
    )
    from hydragnn_torch.models.create import create_model
    from hydragnn_torch.models.dimenet import (
        DnTriGate,
        add_dimenet_extras,
        count_triplets,
    )
    from hydragnn_torch.ops import dn_tri, row_mlp
    from hydragnn_torch.train.optimizer import select_optimizer
    from hydragnn_torch.train.trainer import create_train_state, make_train_step

    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", "fused")
    if remat:
        monkeypatch.setenv("HYDRAGNN_DIMENET_REMAT", "1")
    rng = np.random.RandomState(0)
    samples = []
    for _ in range(16):
        pts = []
        while len(pts) < 14:
            q = rng.rand(3) * 3.0
            if all(np.linalg.norm(q - o) >= 0.8 for o in pts):
                pts.append(q)
        pos = np.asarray(pts, np.float32)
        samples.append(GraphSample(
            x=rng.rand(14, 1).astype(np.float32), pos=pos,
            edge_index=radius_graph(pos, 1.8, max_neighbours=20),
            graph_y=rng.rand(1)))
    max_e = max(s.num_edges for s in samples)
    g = collate(samples, PadSpec.for_batch(16, 14, max_e),
                [HeadSpec("energy", "graph", 1)])
    per = max(count_triplets(s.edge_index, 14) for s in samples)
    g = add_dimenet_extras(g, 16 * per + 8,
                           tri_gate=DnTriGate(max_edges_per_graph=max_e))
    assert "dn_tri_ok" in g.extras
    cfg = ModelConfig(
        model_type="DimeNet", input_dim=1, output_dim=(1,),
        output_type=("graph",), node_head=None, task_weights=(1.0,),
        num_conv_layers=4, radius=1.8, max_neighbours=20,
        envelope_exponent=5, num_before_skip=1, num_after_skip=2,
        num_spherical=7, **widths)
    sides = []
    for dev in (torch.device("cpu"), cuda):
        model = create_model(cfg, seed=1).to(dev)
        spec = select_optimizer({"type": "AdamW", "learning_rate": 1e-3})
        sides.append([model, create_train_state(model, spec),
                      make_train_step(model, cfg, spec), g.to(dev)])

    def loss_and_grads(model, gd):
        model.train()
        loss, _ = multihead_loss(cfg, model(gd), gd)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return float(loss.detach()), [d_.cpu() for d_ in grads]

    counted = {}
    for _ in range(3):
        sides[1][0].load_state_dict(sides[0][0].state_dict())
        (lc, gc), (lg, gg) = (loss_and_grads(m, gd) for m, _, _, gd in sides)
        assert abs(lg - lc) <= 1e-5 * abs(lc)
        top = max(float(d_.abs().max()) for d_ in gc)
        for d_c, d_g in zip(gc, gg):
            assert float((d_c - d_g).abs().max()) <= 1e-4 * top
        for m in (tfm, dn_tri, row_mlp):
            m.reset_launches()
        for side in sides:
            side[1], _ = side[2](side[1], side[3])
        for m in (tfm, dn_tri, row_mlp):
            for k, v in m.LAUNCHES.items():
                counted[k] = counted.get(k, 0) + v
    return {k: v for k, v in counted.items() if v}


@pytest.mark.gpu
def test_dimenet_train_steps_on_card_match_cpu(cuda, monkeypatch):
    """DimeNet at the arch sweep's widths (hidden 64, 4 convs, S = 7, R =
    6, B = 8, int_emb = out_emb = 64, one pair before the skip, two after)
    in lockstep.  Per step 4 dn_tri forward and backward, 4 row_mlp
    forward and backward, 13 segment sums (4 output blocks, the pool and
    the backward of each conv's two embedding gathers)."""
    counted = _dimenet_steps(cuda, monkeypatch, dict(
        hidden_dim=64, graph_head=_dimenet_head(64), num_radial=6,
        basis_emb_size=8, int_emb_size=64, out_emb_size=64))
    assert counted == {
        "segment_sum_dense": 39, "dimenet_triplet_mp": 12,
        "dimenet_triplet_mp_bwd": 12, "dimenet_post_mlp": 12,
        "dimenet_post_mlp_bwd": 12}


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_dimenet_wide_train_steps_on_card_match_cpu(cuda, monkeypatch,
                                                     remat):
    """DimeNet at the dimenet_wide cell's widths (DimeNet++'s QM9 model
    with int_emb_size 128: hidden 128, out_emb 256, B = 8, S = 7, R = 6)
    in lockstep (two float32 runs of it part within an epoch:
    backend_drift.py DimeNet_wide), with and without
    HYDRAGNN_DIMENET_REMAT.  Per step 4 builder forwards, 4 pass S, 4 pass
    P, 13 segment sums (output blocks, pool, the embedding gathers'
    backward; under REMAT the backward runs each conv again: 8 forwards,
    17 sums); no factored kernel and no row tail."""
    counted = _dimenet_steps(cuda, monkeypatch, dict(
        hidden_dim=128, graph_head=_dimenet_head(128), num_radial=6,
        basis_emb_size=8, int_emb_size=128, out_emb_size=256), remat=remat)
    # under REMAT each conv's four output-block sums run again, the pool
    # (outside the convs) does not
    assert counted == {
        "segment_sum_dense": 51 if remat else 39,
        "dimenet_tri_builder": 24 if remat else 12,
        "dimenet_tri_builder_bwd_s": 12, "dimenet_tri_builder_bwd_p": 12}


def _dimenet_head(width):
    from hydragnn_torch.models.base import GraphHeadCfg

    return GraphHeadCfg(2, width, 2, (width, width))
