"""Host-side planning of the builder forward's and pass S's and egcl pass
P's tensor-core routes (hydragnn_torch/ops/dn_tri.py, ops/egcl_mp.py,
ops/aggregate.py ``row_shares``) and of the row_mlp forward's
(ops/row_mlp.py ``fwd_route``, ``fwd_tiles``): the route by width, the
shares of rows that the kernels' warps (builder forward and pass S, the
row_mlp forward's 16-row tiles) or blocks (egcl pass P) take, and the
weight-gradient jobs of egcl pass P; the cgcnn forward as its kernel
computes it (the node table, then each receiver row's sum in
edge order); and the routes 1 of the scf filter-gather kernel (forward
and pass S: the blocks' shares, 64-edge tiles, the weights' k steps, each
row's sum in position order) and of the factored dn_tri forward (the A
operand formed from radial and cbf under the permuted k index, the
warps' shares), each written out in torch.

The kernels only run on the card; here each share's part is computed by
the plain version on the rows (and their triplets or edges) the share
gives it, and written, as the kernel writes it, at its own output rows or
at its own entries of the part's partial in the packed layout of the
weight gradients; the parts are then summed in order, as the reduce
kernel sums them.  Every entry must be written exactly once per part, and
the result must equal the plain version over the whole batch (1e-5 of the
largest entry: the same float32 sums in another order).  Small random
graphs on the CPU, in seconds.
"""

import numpy as np
import pytest
import torch

from hydragnn_torch.ops import cgcnn_mp, dn_tri, egcl_mp, row_mlp, scf_mp
from hydragnn_torch.ops.aggregate import row_shares, segment_offsets


def _close(got, want):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * max(scale, 1e-30)


def _every_entry_once(entries, size):
    count = torch.zeros(size, dtype=torch.long)
    for idx in entries:
        count.index_add_(0, idx, torch.ones_like(idx))
    assert bool((count == 1).all())


@pytest.mark.parametrize("sr,b,d,route", [
    (42, 8, 128, 1), (70, 8, 64, 2), (126, 128, 128, 2), (21, 8, 96, 1),
    (64, 8, 128, 1), (65, 8, 128, 2), (42, 9, 128, 2), (42, 8, 100, 2),
    (127, 33, 1, 2), (1, 1, 8, 1)])
def test_builder_forward_route_by_width(sr, b, d, route):
    """Route 1 (tensor cores) at B <= 8, S*R <= 64 and D a multiple of 8:
    DimeNet++'s QM9 widths (42, 8, 128) and the JAX tests' (21, 8, 96);
    the first design past that, the limits (126, 128, 128) and (70, 8, 64)
    among them."""
    assert dn_tri.builder_fwd_route(sr, b, d) == route


def _shares_ok(row_ptr, n_parts):
    """row_shares: contiguous runs from row 0 to row n, each starting
    where its weight (rows plus entries before it) reaches its target."""
    b = row_shares(row_ptr, n_parts)
    n = row_ptr.shape[0] - 1
    assert b.shape == (n_parts + 1,)
    assert int(b[0]) == 0 and int(b[-1]) == n
    assert bool((b[1:] >= b[:-1]).all())
    key = row_ptr.long() + torch.arange(n + 1)
    total = int(key[-1])
    for i in range(n_parts + 1):
        target = total * i // n_parts
        r = int(b[i])
        assert int(key[r]) >= target
        assert r == 0 or int(key[r - 1]) < target
    return b


@pytest.mark.parametrize("n_parts", [1, 3, 64, 500])
def test_row_shares_cover_every_row_once(n_parts):
    """Every row in exactly one share (a share may be empty), on a CSR
    schedule with a hub row, rows without entries and padding rows last;
    with no entries at all the rows still split evenly."""
    rng = np.random.RandomState(n_parts)
    counts = rng.poisson(6, 120)
    counts[7] = 300
    counts[50:60] = 0
    counts[-5:] = 0
    row_ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]))
    b = _shares_ok(row_ptr.int(), n_parts)
    seen = torch.zeros(120, dtype=torch.long)
    for i in range(n_parts):
        seen[int(b[i]):int(b[i + 1])] += 1
    assert bool((seen == 1).all())
    empty = _shares_ok(torch.zeros(121, dtype=torch.int32), n_parts)
    sizes = (empty[1:] - empty[:-1]).tolist()
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("n_parts", [1, 7, 200])
def test_builder_forward_shares_sum_to_plain(n_parts):
    """The forward's partition emulated with the plain version: warp i of
    ``n_parts`` takes rows [b_i, b_{i+1}) and their triplets (ji order);
    its rows, written once each, make up the forward over the batch."""
    rng = np.random.RandomState(n_parts)
    e, t, sr, b, d = 90, 700, 42, 8, 16
    real = 600
    ji = np.sort(rng.randint(0, e - 1, real))
    kj = rng.randint(0, e - 1, real)
    idx_ji = torch.from_numpy(np.concatenate([ji, np.full(t - real, e - 1)])
                              ).int()
    idx_kj = torch.from_numpy(np.concatenate([kj, np.full(t - real, e - 1)])
                              ).int()
    tm = (torch.arange(t) < real).int()
    x = torch.from_numpy(rng.randn(e, d).astype(np.float32))
    sbf = torch.from_numpy(rng.randn(t, sr).astype(np.float32))
    k1 = torch.from_numpy((rng.randn(sr, b) / 6).astype(np.float32))
    k2 = torch.from_numpy((rng.randn(b, d) / 3).astype(np.float32))
    bounds = _shares_ok(segment_offsets(idx_ji, e, tm), n_parts)
    out = torch.full((e, d), float("nan"))
    written = torch.zeros(e, dtype=torch.long)
    for i in range(n_parts):
        r0, r1 = int(bounds[i]), int(bounds[i + 1])
        share = tm * ((idx_ji >= r0) & (idx_ji < r1)).int()
        part = dn_tri.dimenet_tri_builder_reference(x, sbf, share, k1, k2,
                                                    idx_kj, idx_ji)
        out[r0:r1] = part[r0:r1]
        written[r0:r1] += 1
    assert bool((written == 1).all())
    _close(out, dn_tri.dimenet_tri_builder_reference(x, sbf, tm, k1, k2,
                                                     idx_kj, idx_ji))


@pytest.mark.parametrize("sr,b,d,want_sbf,route", [
    (42, 8, 128, False, 1), (42, 8, 128, True, 2), (21, 8, 96, False, 1),
    (64, 8, 8, False, 1), (64, 8, 8, True, 2), (70, 8, 64, False, 2),
    (42, 9, 128, False, 2), (42, 8, 100, False, 2),
    (126, 128, 128, True, 2)])
def test_builder_pass_s_route_by_width(sr, b, d, want_sbf, route):
    """Pass S takes the forward's route 1 at its widths when d sbf is not
    asked for (the training path, DimeNet++'s QM9 widths among them); the
    first design keeps d sbf and every width past route 1's."""
    assert dn_tri.builder_bwd_s_route(sr, b, d, want_sbf) == route


@pytest.mark.parametrize("n_parts", [1, 7, 200])
def test_builder_pass_s_shares_sum_to_plain(n_parts):
    """Pass S's route-1 partition emulated with the plain version: warp i
    of ``n_parts`` takes kj rows [b_i, b_{i+1}) of the kj-order CSR (a hub
    row, rows without triplets, a masked tail parked on the last edge) and
    their triplets; its rows of d x_kj, written once each, make up pass S
    over the batch."""
    rng = np.random.RandomState(n_parts + 3)
    e, t, sr, b, d = 90, 700, 42, 8, 16
    real = 600
    ji = np.sort(rng.randint(0, e - 1, real))
    kj = rng.randint(0, e - 1, real)
    kj[:80] = 5
    kj[(kj >= 30) & (kj < 40)] = 41
    idx_ji = torch.from_numpy(np.concatenate([ji, np.full(t - real, e - 1)])
                              ).int()
    idx_kj = torch.from_numpy(np.concatenate([kj, np.full(t - real, e - 1)])
                              ).int()
    tm = (torch.arange(t) < real).int()
    perm = torch.argsort(idx_kj, stable=True)
    x = torch.from_numpy(rng.randn(e, d).astype(np.float32))
    sbf = torch.from_numpy(rng.randn(t, sr).astype(np.float32))
    k1 = torch.from_numpy((rng.randn(sr, b) / 6).astype(np.float32))
    k2 = torch.from_numpy((rng.randn(b, d) / 3).astype(np.float32))
    g = torch.from_numpy(rng.randn(e, d).astype(np.float32))
    bounds = _shares_ok(segment_offsets(idx_kj[perm], e, tm[perm]), n_parts)
    dx = torch.full((e, d), float("nan"))
    written = torch.zeros(e, dtype=torch.long)
    for i in range(n_parts):
        r0, r1 = int(bounds[i]), int(bounds[i + 1])
        share = tm * ((idx_kj >= r0) & (idx_kj < r1)).int()
        part, none = dn_tri.dimenet_tri_builder_pass_s_plain(
            x, sbf, share, k1, k2, idx_kj, idx_ji, g, want_sbf=False)
        assert none is None
        dx[r0:r1] = part[r0:r1]
        written[r0:r1] += 1
    assert bool((written == 1).all())
    _close(dx, dn_tri.dimenet_tri_builder_pass_s_plain(
        x, sbf, tm, k1, k2, idx_kj, idx_ji, g, want_sbf=False)[0])


def _cgcnn_tabled(x, edge_attr, em, kf, bf, ks, bs, senders, receivers):
    """The cgcnn forward as csrc/cgcnn_mp.cu computes it: the node
    table ``T = x @ [Wfr | Wsr | Wfs | Wss]``, then per edge ``tf = (T[r,
    :D] + bf) + T[s, 2D:3D]`` (+ ``edge_attr @ Wfg``), ``ts`` from the
    second and fourth blocks, and each receiver row's
    ``sigmoid(tf) * softplus(ts)`` summed over its CSR range in edge order
    (the k-th edge of every row added in step k).  Masked edges lie in no
    range; senders outside ``[0, N)`` add nothing."""
    n, f = x.shape
    d = kf.shape[1]
    kfr, kfs, kfg = egcl_mp.split_weights(kf, f)
    ksr, kss, ksg = egcl_mp.split_weights(ks, f)
    table = x @ torch.cat([kfr, ksr, kfs, kss], dim=1)
    send = senders.long()
    ok = (send >= 0) & (send < n)
    ts_ = table[send.clamp(0, n - 1)]
    recv = receivers.long().clamp(0, n - 1)
    tf = (table[recv, :d] + bf) + ts_[:, 2 * d:3 * d]
    ts = (table[recv, d:2 * d] + bs) + ts_[:, 3 * d:]
    if edge_attr is not None:
        tf = tf + edge_attr @ kfg
        ts = ts + edge_attr @ ksg
    msg = torch.sigmoid(tf) * torch.nn.functional.softplus(ts)
    msg = torch.where(ok[:, None], msg, torch.zeros((), dtype=x.dtype))
    row_ptr = segment_offsets(receivers, n, em).long()
    start, deg = row_ptr[:-1], row_ptr[1:] - row_ptr[:-1]
    out = torch.zeros((n, d), dtype=msg.dtype)
    for k in range(int(deg.max())):
        rows = torch.nonzero(deg > k)[:, 0]
        out[rows] += msg[start[rows] + k]
    return out


def _cgcnn_case(f, a, d, all_masked, seed=0):
    """A receiver-sorted batch: 60 nodes, a hub row, rows without edges, a
    sender outside [0, N), and a masked tail parked on the last node (all
    edges masked when asked)."""
    rng = np.random.RandomState(seed + f + a + d)
    n, e, real = 60, 420, 360
    recv = np.sort(rng.randint(0, n - 1, real))
    recv[recv == 7] = 8
    recv[:50] = 0
    recv.sort()
    send = rng.randint(0, n - 1, real)
    send[real // 2] = n + 3
    pad = np.full(e - real, n - 1)
    em = (np.arange(e) < (0 if all_masked else real)).astype(np.int32)
    ins = [rng.randn(n, f), rng.randn(e, a) * 0.5 if a else None,
           rng.randn(2 * f + a, d) / (2 * f + a) ** 0.5, rng.randn(d) * 0.1,
           rng.randn(2 * f + a, d) / (2 * f + a) ** 0.5, rng.randn(d) * 0.1]
    ins = [None if v is None else torch.from_numpy(v.astype(np.float32))
           for v in ins]
    ids = [torch.from_numpy(np.concatenate([v, pad]).astype(np.int32))
           for v in (send, recv)]
    return ins, torch.from_numpy(em), ids


@pytest.mark.parametrize("all_masked", [False, True],
                         ids=["masked-tail", "all-masked"])
@pytest.mark.parametrize("f,a,d", [(64, 0, 64), (24, 5, 16), (256, 0, 256)])
def test_cgcnn_forward_tabled_matches_reference(f, a, d, all_masked):
    """The cgcnn forward as its kernel computes it (the node table, then
    each receiver row's sum in edge order) equals the composed plain
    version at the path's widths (F = D = 64), at (24, 5, 16) and at the
    limit 256, 1e-5 of the largest entry; rows without an edge and the
    all-masked batch give exact zeros."""
    ins, em, (send, recv) = _cgcnn_case(f, a, d, all_masked)
    got = _cgcnn_tabled(ins[0], ins[1], em, *ins[2:], send, recv)
    want = cgcnn_mp.cgcnn_block_reference(ins[0], ins[1], em, *ins[2:],
                                          send, recv)
    if all_masked:
        assert float(got.abs().max()) == 0
        return
    assert float(want.abs().max()) > 0
    _close(got, want)
    assert float(got[7].abs().max()) == 0


@pytest.mark.parametrize("f,h,gp,eq,route", [
    (48, 48, 1, True, 1), (48, 48, 1, False, 1), (1, 48, 1, True, 1),
    (32, 32, 1, True, 1), (32, 32, 4, True, 1), (1, 32, 4, False, 1),
    (48, 33, 1, True, 1), (8, 8, 15, True, 1), (8, 8, 16, True, 2),
    (48, 64, 1, True, 2), (64, 48, 1, True, 2), (128, 128, 4, True, 2),
    (128, 32, 1, True, 2)])
def test_egcl_pass_p_route_by_width(f, h, gp, eq, route):
    """Route 1 (tensor cores) at F, H <= 48 and gp <= 15: md17's layers
    (48, 48, equivariant or not; F = 1) and oc22's (32, 32); the first
    design past that, H = 64 and the limit 128 among them."""
    assert egcl_mp.pass_p_route(f, h, gp, eq) == route


def _egcl_offsets(f, h, gp, eq):
    """The packed weight gradients' blocks (csrc/egcl_mp.cu weight_layout
    at row stride H): dW0s, dW0r, dW0g, db0, dW1, db1, dWc0, dbc0, dwc1,
    and the used size."""
    off, o = {}, 0
    for name, size in (("w0s", f * h), ("w0r", f * h), ("w0g", gp * h),
                       ("b0", h), ("w1", h * h), ("b1", h)) + (
            (("wc0", h * h), ("bc0", h), ("wc1", h)) if eq else ()):
        off[name] = o
        o += size
    return off, o


def _job_entries(job, f, h, gp, off):
    """The packed entries one job writes (tc::pass_p_tc_kernel's last
    switch): rows of its 16-row tile and columns of its half that fall
    inside its block; G' products keep their gp lanes (dW0g) and their
    ones row (db0, db1, dbc0)."""
    _, name, r0, c0, cols = job
    out = []
    for r in range(r0, r0 + 16):
        for c in range(c0, min(c0 + cols, h)):
            if name in ("wc0", "w1") and r < h:
                out.append(off[name] + r * h + c)
            elif name in ("w0s", "w0r") and r < f:
                out.append(off[name] + r * h + c)
            elif name == "w0g" and r < gp:
                out.append(off["w0g"] + r * h + c)
            elif r == gp and name in ("w0g", "b1", "bc0"):
                out.append(off["b0" if name == "w0g" else name] + c)
    return torch.tensor(out, dtype=torch.long)


@pytest.mark.parametrize("f,h,gp,eq", [(48, 48, 1, True), (48, 48, 1, False),
                                       (1, 48, 1, True), (32, 32, 1, True),
                                       (32, 32, 4, True), (48, 33, 3, False)])
def test_egcl_pass_p_jobs_cover_the_partial_once(f, h, gp, eq):
    """Route 1's jobs: at most four a warp of eight (warp w takes jobs w,
    w + 8, ...), the products in three phases, and their entries plus
    dwc1's (summed in registers) cover the packed partial exactly once."""
    jobs = egcl_mp.pass_p_jobs(f, h, gp, eq)
    assert len(jobs) <= egcl_mp.EGCL_TC_WARPS * egcl_mp.EGCL_TC_JOBS
    assert [j[0] for j in jobs] == sorted(j[0] for j in jobs)
    off, used = _egcl_offsets(f, h, gp, eq)
    entries = [_job_entries(j, f, h, gp, off) for j in jobs]
    if eq:
        entries.append(off["wc1"] + torch.arange(h))
    _every_entry_once(entries, used)


def _egcl_batch(n, e_real, e_pad, seed):
    """Receivers sorted over n - 1 real nodes, masked edges parked last on
    node n - 1, a hub sender; some nodes send nothing."""
    rng = np.random.RandomState(seed)
    recv = np.sort(rng.randint(0, n - 4, e_real))
    send = rng.randint(0, n - 4, e_real)
    send[::7] = 2
    pad = e_pad - e_real
    senders = torch.from_numpy(np.concatenate([send, np.full(pad, n - 1)]))
    receivers = torch.from_numpy(np.concatenate([recv, np.full(pad, n - 1)]))
    em = (torch.arange(e_pad) < e_real).int()
    return senders.int(), receivers.int(), em, rng


@pytest.mark.parametrize("f,h,a,eq,n_parts", [(48, 48, 0, True, 5),
                                              (48, 48, 0, False, 3),
                                              (1, 48, 0, True, 9),
                                              (32, 32, 3, True, 132)])
def test_egcl_pass_p_shares_and_jobs_sum_to_plain(f, h, a, eq, n_parts):
    """Pass P's partition emulated with the plain version: block i takes
    the sender rows [b_i, b_{i+1}) of ``row_shares`` over the sender CSR
    and their edges; its weight gradients, written at its jobs' entries
    (and dwc1's) of its partial, summed over the blocks in order, give
    pass P over the batch, and so do its dx rows (written once each) and
    its edges' dgeo rows."""
    n = 30
    send, recv, em, rng = _egcl_batch(n, 160, 200, seed=f + h + a)
    e = len(send)
    gp = 1 + a
    geo = torch.cat([torch.from_numpy(rng.rand(e, 3).astype(np.float32))
                     * 1.2 - 0.6,
                     torch.from_numpy(rng.rand(e, gp).astype(np.float32))], 1)
    x = torch.from_numpy(rng.randn(n, f).astype(np.float32))
    ws = [torch.from_numpy((rng.randn(*s) * sc).astype(np.float32))
          for s, sc in (((2 * f + gp, h), 0.2), ((h,), 0.1), ((h, h), 0.15),
                        ((h,), 0.1))]
    if eq:
        ws += [torch.from_numpy((rng.randn(*s) * sc).astype(np.float32))
               for s, sc in (((h, h), 0.15), ((h,), 0.1), ((h, 1), 0.5))]
    else:
        ws += [None, None, None]
    gagg = torch.from_numpy(rng.randn(n, h).astype(np.float32))
    gpsum = torch.from_numpy(rng.randn(n, 3).astype(np.float32)) if eq \
        else None
    perm = torch.argsort(torch.where(em != 0, send, n), stable=True)
    bounds = _shares_ok(segment_offsets(send[perm], n, em[perm]), n_parts)
    off, used = _egcl_offsets(f, h, gp, eq)
    jobs = egcl_mp.pass_p_jobs(f, h, gp, eq)
    entries = [_job_entries(j, f, h, gp, off) for j in jobs]
    if eq:
        entries.append(off["wc1"] + torch.arange(h))
    partial = torch.full((n_parts, used), float("nan"))
    dx = torch.full((n, f), float("nan"))
    dgeo = torch.zeros(e, 3 + gp)
    for i in range(n_parts):
        r0, r1 = int(bounds[i]), int(bounds[i + 1])
        share = em * ((send >= r0) & (send < r1)).int()
        out = egcl_mp.egcl_pass_p_plain(eq, x, geo, share, *ws, send, recv,
                                        gagg, gpsum)
        packed = torch.cat([t.reshape(-1) for t in out[:7]
                            if t is not None])
        for idx in entries:
            partial[i, idx] = packed[idx]
        dx[r0:r1] = out[8][r0:r1]
        dgeo += out[7]
    wgrad = partial[0]
    for i in range(1, n_parts):
        wgrad = wgrad + partial[i]
    want = egcl_mp.egcl_pass_p_plain(eq, x, geo, em, *ws, send, recv, gagg,
                                     gpsum)
    got = egcl_mp.unpack_wgrad(eq, wgrad, f, h, gp)
    for a_, b_ in zip(got, want[:7]):
        if b_ is None:
            assert a_ is None
            continue
        _close(a_.reshape(b_.shape), b_)
    _close(dgeo, want[7])
    _close(dx, want[8])


@pytest.mark.parametrize("f,g,route", [
    (256, 50, 1), (48, 50, 1), (200, 50, 1), (40, 7, 1), (256, 64, 1),
    (16, 50, 1), (8, 1, 1), (12, 50, 2), (252, 50, 2), (260, 50, 2),
    (256, 65, 2), (384, 127, 2), (1024, 127, 2)])
def test_scf_forward_route_by_width(f, g, route):
    """The scf forward's and pass S's route 1 (tensor cores, a ring of
    weight chunks) at F a multiple of 8 up to 256 and G <= 64: the wide
    SchNet's (256, 50) among them; the first design past that, up to the
    op's limits (1024, 127)."""
    assert scf_mp.fwd_route(f, g) == route


@pytest.mark.parametrize("s,sr,b,d,route", [
    (7, 42, 8, 64, 1), (7, 21, 8, 16, 1), (5, 25, 8, 24, 1),
    (8, 64, 8, 64, 1), (4, 16, 6, 40, 1), (8, 64, 64, 64, 2),
    (1, 1, 1, 1, 2), (7, 42, 9, 64, 2), (7, 42, 8, 60, 2)])
def test_dn_tri_forward_route_by_width(s, sr, b, d, route):
    """The factored forward's route 1 (the builder forward's kernel with
    the A operand formed from radial and cbf) at B <= 8 and D a multiple
    of 8, the arch sweep's (7, 42, 8, 64) and the JAX test's (7, 21, 8,
    16) among them; the first design keeps the rest, the limits (8, 64,
    64, 64) among them."""
    assert dn_tri.fwd_route(s, sr, b, d) == route


@pytest.mark.parametrize("din,h,nb,na,route", [
    (64, 64, 1, 2, 1), (16, 24, 1, 2, 1), (8, 8, 0, 0, 1), (40, 33, 0, 3, 1),
    (1, 1, 3, 0, 1), (64, 65, 1, 2, 2), (65, 64, 1, 2, 2),
    (128, 128, 1, 2, 2), (64, 64, 2, 2, 2), (64, 64, 4, 0, 2),
    (64, 64, 0, 4, 2), (16, 24, 3, 1, 2)])
def test_row_mlp_forward_route_by_width(din, h, nb, na, route):
    """The row_mlp forward's route 1 (weights resident, each warp on its
    own 16-row tiles, tensor cores) at the backward's route-1 widths: Din,
    H <= 64 with at most three residual pairs (8 layers), the arch sweep's
    DimeNet (64, 64, 1, 2) and the JAX test's (16, 24, 1, 2) among them;
    the first design at H or Din = 65, H = 128 and four pairs."""
    assert row_mlp.fwd_route(din, h, nb, na) == route


@pytest.mark.parametrize("n_rows,n_parts", [
    (1, 132), (15, 132), (100, 132), (1003, 132), (2111, 132), (4093, 132),
    (57776, 132), (1003, 7), (33, 1)])
def test_row_mlp_forward_tiles_cover_every_row_once(n_rows, n_parts):
    """Route 1's plan: a grid of min(n_parts, 16-row tiles) blocks, each of
    16 warps walking tiles w * grid + b, then every 16 * grid: every row in
    exactly one tile of one warp, each tile 16 rows but the last, a warp's
    tiles in increasing order; at row counts that are not a multiple of 16,
    below the SM count (100 rows: 7 tiles, 7 blocks), around one and two
    rounds of the card's 132 x 16 warps, the dimenet cell's 57776 rows, and
    with fewer parts than tiles."""
    grid, tiles = row_mlp.fwd_tiles(n_rows, n_parts)
    n_tiles = -(-n_rows // 16)
    assert grid == min(n_parts, n_tiles)
    assert set(tiles) == {(b, w) for b in range(grid) for w in range(16)}
    seen = torch.zeros(n_rows, dtype=torch.long)
    for walk in tiles.values():
        starts = [r0 for r0, _ in walk]
        assert starts == sorted(starts)
        for r0, nr in walk:
            assert r0 % 16 == 0 and nr == min(16, n_rows - r0) and nr > 0
            seen[r0:r0 + nr] += 1
    assert bool((seen == 1).all())
    counts = [len(w) for w in tiles.values()]
    assert max(counts) - min(counts) <= 1


def _scf_case(f, g, all_masked, seed):
    """A receiver-sorted batch: 120 nodes, a hub row of 200 edges (four
    64-edge tiles), rows without edges, a sender outside [0, N), and a
    masked tail parked on the last node (all edges masked when asked)."""
    rng = np.random.RandomState(seed + f + g)
    n, e, real = 120, 1100, 900
    recv = np.sort(rng.randint(0, n - 3, real))
    recv[recv == 9] = 10
    recv[:200] = 3
    recv.sort()
    send = rng.randint(0, n - 1, real)
    send[real // 3] = n + 5
    pad = np.full(e - real, n - 1)
    em = (np.arange(e) < (0 if all_masked else real)).astype(np.int32)
    cm = rng.rand(e) * em
    ins = [rng.randn(n, f), rng.rand(e, g), cm, rng.randn(g, f) / g ** 0.5,
           rng.randn(f) * 0.1, rng.randn(f, f) / f ** 0.5,
           rng.randn(f) * 0.1]
    ins = [torch.from_numpy(v.astype(np.float32)) for v in ins]
    send, recv = (torch.from_numpy(np.concatenate([v, pad]).astype(np.int32))
                  for v in (send, recv))
    return ins, torch.from_numpy(em), send, recv


def _scf_route1(x, rbf, cm, em, w0, b0, w1, b1, gidx, rowid, perm, n_parts):
    """The scf forward (pass S: x the cotangent, gathered at the
    receivers, rows the senders, positions through ``perm``) as
    csrc/scf_mp.cu's route 1 computes it: block i of ``n_parts`` takes the
    rows [b_i, b_{i+1}) of ``row_shares`` over the CSR and walks their
    positions 64 at a time; per tile t0 = b0 + the k steps (8 wide) of rbf
    . W0 (W0's rows zero past G), a = ssp(t0), f2 = b1 + the k steps of a .
    W1, each step added to the sum in order, as the weights stream through
    32-row chunks; then x[gidx] * (f2 * cm) added into the current row in
    position order, each row written once when the next begins (rows
    without edges as zeros)."""
    n, f = x.shape
    g = rbf.shape[1]
    m, kc = scf_mp.SCF_TC_TILE, scf_mp.SCF_TC_CHUNK
    order = perm.long() if perm is not None else torch.arange(len(gidx))
    row_ptr = segment_offsets(rowid[order], n, em[order])
    bounds = _shares_ok(row_ptr, n_parts)
    g8 = -(-g // 8) * 8
    gk = -(-g8 // kc) * kc
    w0p = torch.zeros(gk, f)
    w0p[:g] = w0
    out = torch.full((n, f), float("nan"))
    written = torch.zeros(n, dtype=torch.long)
    for i in range(n_parts):
        r0, r1 = int(bounds[i]), int(bounds[i + 1])
        if r0 >= r1:
            continue
        p0, p1 = int(row_ptr[r0]), int(row_ptr[r1])
        cur, acc = r0, torch.zeros(f)

        def flush(upto):
            out[cur] = acc
            out[cur + 1:upto] = 0.0
            written[cur:upto] += 1

        for q in range(p0, p1, m):
            eid = order[q:min(q + m, p1)]
            rp = torch.zeros(len(eid), gk)
            rp[:, :g] = rbf[eid]
            t0 = b0.expand(len(eid), f)
            for k in range(0, g8, 8):
                t0 = t0 + rp[:, k:k + 8] @ w0p[k:k + 8]
            a = scf_mp._ssp(t0)
            f2 = b1.expand(len(eid), f)
            for k in range(0, f, 8):
                f2 = f2 + a[:, k:k + 8] @ w1[k:k + 8]
            for j, ed in enumerate(eid.tolist()):
                s, r = int(gidx[ed]), int(rowid[ed])
                if not 0 <= s < n or r < cur or r >= r1:
                    continue
                if r != cur:
                    flush(r)
                    cur, acc = r, torch.zeros(f)
                acc = acc + x[s] * (f2[j] * cm[ed])
        flush(r1)
    assert bool((written == 1).all())
    return out


@pytest.mark.parametrize("mode", ["forward", "pass_s"])
@pytest.mark.parametrize("all_masked", [False, True],
                         ids=["masked-tail", "all-masked"])
@pytest.mark.parametrize("f,g", [(256, 50), (48, 50), (200, 50)])
def test_scf_route1_order_matches_plain(f, g, all_masked, mode):
    """The scf forward and pass S as route 1 computes them (the block
    shares, 64-edge tiles, the k steps of the weight chunks, each row's
    sum in position order) equal scf_edge_pipeline_plain, 1e-5 of the
    largest entry, at the wide SchNet's widths and at F = 48 and 200 (not
    whole warps of 32 columns); every row written once, the all-masked
    batch exact zeros."""
    ins, em, send, recv = _scf_case(f, g, all_masked, seed=11)
    x, rbf, cm, w0, b0, w1, b1 = ins
    if mode == "forward":
        got = _scf_route1(x, rbf, cm, em, w0, b0, w1, b1, send, recv, None,
                          n_parts=5)
        want = scf_mp.scf_edge_pipeline_plain(x, rbf, cm, em, w0, b0, w1,
                                              b1, send, recv)
    else:
        perm = torch.argsort(send, stable=True)
        got = _scf_route1(x, rbf, cm, em, w0, b0, w1, b1, recv, send, perm,
                          n_parts=7)
        want = scf_mp.scf_edge_pipeline_plain(x, rbf, cm, em, w0, b0, w1,
                                              b1, recv, send)
    if all_masked:
        assert float(got.abs().max()) == 0
        return
    assert float(want.abs().max()) > 0
    _close(got, want)


def _tri_route1(radial, x2, cbf, w1, w2, idx_kj, idx_ji, tmask, r, n_parts):
    """The factored forward as route 1 computes it: warp i of ``n_parts``
    takes the ji rows [b_i, b_{i+1}) of ``row_shares`` and walks their
    triplets 16 at a time; the A operand is formed under the builder's
    permuted k index (a step's slots t and t + 4 hold its columns 2t and
    2t + 1) as radial[kj, c] * cbf[t, min(c // R, S - 1)], radial zero past
    S*R; emb1 = the k steps of A . W1 (rows permuted alike, B padded to 8),
    emb2 = emb1 . W2, and x2[kj] * emb2 added into the current row in
    triplet order, each row written once."""
    e, d = x2.shape
    t, s = cbf.shape
    sr, b = w1.shape
    ks = -(-sr // 8)
    cols = torch.tensor([8 * q + 2 * tt + h for q in range(ks)
                         for h in (0, 1) for tt in range(4)])
    lidx = torch.clamp(cols // r, max=s - 1)
    rad = torch.zeros(e, 8 * ks)
    rad[:, :sr] = radial
    w1p = torch.zeros(8 * ks, 8)
    w1p[:sr, :b] = w1
    w2p = torch.zeros(8, d)
    w2p[:b] = w2
    row_ptr = segment_offsets(idx_ji, e, tmask)
    bounds = _shares_ok(row_ptr, n_parts)
    out = torch.full((e, d), float("nan"))
    written = torch.zeros(e, dtype=torch.long)
    kj_all, ji_all = idx_kj.long(), idx_ji.long()
    for i in range(n_parts):
        r0, r1 = int(bounds[i]), int(bounds[i + 1])
        if r0 >= r1:
            continue
        p0, p1 = int(row_ptr[r0]), int(row_ptr[r1])
        cur, acc = r0, torch.zeros(d)

        def flush(upto):
            out[cur] = acc
            out[cur + 1:upto] = 0.0
            written[cur:upto] += 1

        for q in range(p0, p1, 16):
            tt = torch.arange(q, min(q + 16, p1))
            kj = kj_all[tt].clamp(0, e - 1)
            a = rad[kj][:, cols] * cbf[tt][:, lidx]
            emb1 = torch.zeros(len(tt), 8)
            for k in range(0, 8 * ks, 8):
                emb1 = emb1 + a[:, k:k + 8] @ w1p[cols[k:k + 8]]
            msg = x2[kj] * (emb1 @ w2p)
            for j, tr in enumerate(tt.tolist()):
                k_, row = int(kj_all[tr]), int(ji_all[tr])
                if not 0 <= k_ < e or row < cur or row >= r1:
                    continue
                if row != cur:
                    flush(row)
                    cur, acc = row, torch.zeros(d)
                acc = acc + msg[j]
        flush(r1)
    assert bool((written == 1).all())
    return out


@pytest.mark.parametrize("all_masked", [False, True],
                         ids=["masked-tail", "all-masked"])
@pytest.mark.parametrize("s,r,b,d", [(7, 6, 8, 64), (7, 3, 8, 16)])
@pytest.mark.parametrize("n_parts", [3, 40])
def test_dn_tri_route1_factored_operand_matches_reference(s, r, b, d,
                                                          all_masked,
                                                          n_parts):
    """The factored A operand formed under the permuted k index, the
    products by k step and the rows summed over the warps' shares equal
    dimenet_triplet_reference, 1e-5 of the largest entry, at the arch
    sweep's widths (7, 6, 8, 64) and the JAX test's (7, 3, 8, 16); every
    row written once, the all-masked table exact zeros."""
    rng = np.random.RandomState(s * r + b + d + n_parts)
    e, t, real = 90, 700, 0 if all_masked else 600
    ji = np.sort(rng.randint(0, e - 1, real))
    kj = rng.randint(0, e - 1, real)
    kj[:5] = e + 4
    idx_ji = torch.from_numpy(np.concatenate([ji, np.full(t - real, e - 1)])
                              ).int()
    idx_kj = torch.from_numpy(np.concatenate([kj, np.full(t - real, e - 1)])
                              ).int()
    tm = (torch.arange(t) < real).int()
    radial = torch.from_numpy(rng.rand(e, s * r).astype(np.float32))
    x2 = torch.from_numpy(rng.randn(e, d).astype(np.float32))
    cbf = torch.from_numpy((rng.randn(t, s) * 0.5).astype(np.float32))
    w1 = torch.from_numpy((rng.randn(s * r, b) / (s * r) ** 0.5
                           ).astype(np.float32))
    w2 = torch.from_numpy((rng.randn(b, d) / b ** 0.5).astype(np.float32))
    got = _tri_route1(radial, x2, cbf, w1, w2, idx_kj, idx_ji, tm, r,
                      n_parts)
    want = dn_tri.dimenet_triplet_reference(radial, x2, cbf, w1, w2, idx_kj,
                                            idx_ji, tm, r)
    if all_masked:
        assert float(got.abs().max()) == 0
        return
    assert float(want.abs().max()) > 0
    _close(got, want)
