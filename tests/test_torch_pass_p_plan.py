"""Host-side planning of the two pass-P kernels (hydragnn_torch/ops/scf_mp.py
and ops/cgcnn_mp.py): the grid of edge shares (scf) or runs of receiver
rows (cgcnn) times slices of columns, and the partial sizes.

The kernels only run on the card; here each part's and each slice's share
is computed by the plain versions on the edges the kernel's partition
gives that part, and written, as block (part, slice) writes it, at its own
entries of the part's partial in the packed layout of the weight
gradients; the parts are then summed in order, as the reduce kernel sums
them.  Every entry must be written exactly once per part, and the result
must equal the plain version over the whole batch (1e-5 of the largest
entry: the same float32 sums in another order).  Small random graphs on
the CPU.
"""

import numpy as np
import pytest
import torch

from hydragnn_torch.ops import cgcnn_mp, scf_mp

SMS = 132  # the H100's streaming multiprocessors


def _batch(n, e_real, e_pad, seed, hub=0):
    """Sorted receivers over n - 1 real nodes (node n - 1 is padding),
    masked edges parked last on node n - 1; ``hub`` extra edges into node
    3; some nodes receive nothing."""
    rng = np.random.RandomState(seed)
    recv = np.sort(np.concatenate([rng.randint(0, n - 6, e_real),
                                   np.full(hub, 3)]))
    send = rng.randint(0, n - 1, len(recv))
    pad = e_pad - len(recv)
    senders = torch.from_numpy(np.concatenate([send, np.full(pad, n - 1)]))
    receivers = torch.from_numpy(np.concatenate([recv, np.full(pad, n - 1)]))
    em = torch.cat([torch.ones(len(recv), dtype=torch.int32),
                    torch.zeros(pad, dtype=torch.int32)])
    return senders.int(), receivers.int(), em, rng


def _close(got, want):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * max(scale, 1e-30)


def _scf_slice_entries(f, g, width, j):
    """The entries of the packed ``[dW0 (G x F) | db0 (F) | dW1 (F x F) |
    db1 (F)]`` that slice j writes (csrc/scf_mp.cu): columns k of dW0 and
    db0, rows k of dW1 and entries k of db1, for k in [j W, (j + 1) W)."""
    k = torch.arange(j * width, min((j + 1) * width, f))
    gf = g * f
    return torch.cat([(torch.arange(g)[:, None] * f + k).reshape(-1),
                      gf + k,
                      (gf + f + k[:, None] * f + torch.arange(f)).reshape(-1),
                      gf + f + f * f + k])


def _cgcnn_slice_entries(f, d, a, wp, j):
    """The entries of the packed weight gradients (the layout
    ``unpack_wgrad`` reads: per half, rows of D [receiver (F) | sender (F)
    | edge attributes (A) | bias]) that slice j writes
    (csrc/cgcnn_mp.cu): columns [j wp, (j + 1) wp) of every row."""
    rows = 2 * f + a + 1
    cols = torch.arange(j * wp, min((j + 1) * wp, d))
    r = torch.arange(2 * rows)
    return (r[:, None] * d + cols).reshape(-1)


def _every_entry_once(entries, size):
    count = torch.zeros(size, dtype=torch.long)
    for idx in entries:
        count.index_add_(0, idx, torch.ones_like(idx))
    assert bool((count == 1).all())


@pytest.mark.parametrize("f,g,width,n_slices", [(48, 50, 64, 1),
                                                (256, 50, 64, 4),
                                                (1024, 127, 16, 64)])
def test_scf_pass_p_plan(f, g, width, n_slices):
    """Slice widths by F, one block per SM, the packed partial per part,
    and slices whose entries cover the packed layout exactly once."""
    plan = scf_mp.pass_p_plan(f, g, 10**6, SMS)
    assert (plan.width, plan.n_slices) == (width, n_slices)
    assert plan.part_size == g * f + f + f * f + f
    assert plan.n_parts == max(1, SMS // n_slices)
    assert plan.n_parts * plan.part_size * 4 <= scf_mp._PARTIAL_BUDGET
    assert scf_mp.pass_p_plan(f, g, 3, SMS).n_parts == min(3, plan.n_parts)
    _every_entry_once([_scf_slice_entries(f, g, width, j)
                       for j in range(n_slices)], plan.part_size)


@pytest.mark.parametrize("f,g", [(48, 50), (256, 50), (1024, 127)])
def test_scf_parts_and_slices_cover_every_edge_and_column_once(f, g):
    """Pass P's partition emulated with the plain version: part p takes
    the valid edges [n_valid p / P, n_valid (p + 1) / P) in receiver
    order, slice j the columns [j W, (j + 1) W); written at their packed
    entries, summed over the parts in order and split as the wrapper
    splits ``wgrad``, they equal pass P over the whole batch."""
    n = 40
    send, recv, em, rng = _batch(n, 150, 220, seed=f, hub=40)
    e = len(send)
    h = torch.from_numpy(rng.randn(n, f).astype(np.float32))
    gout = torch.from_numpy(rng.randn(n, f).astype(np.float32))
    rbf = torch.from_numpy(rng.rand(e, g).astype(np.float32))
    cm = torch.from_numpy(rng.rand(e).astype(np.float32)) * em
    w0 = torch.from_numpy((rng.randn(g, f) / g ** 0.5).astype(np.float32))
    b0 = torch.from_numpy((rng.randn(f) * 0.1).astype(np.float32))
    w1 = torch.from_numpy((rng.randn(f, f) / f ** 0.5).astype(np.float32))
    b1 = torch.from_numpy((rng.randn(f) * 0.1).astype(np.float32))
    plan = scf_mp.pass_p_plan(f, g, e, SMS)
    n_valid = int(em.sum())
    partial = torch.full((plan.n_parts, plan.part_size), float("nan"))
    for p in range(plan.n_parts):
        lo, hi = n_valid * p // plan.n_parts, n_valid * (p + 1) // plan.n_parts
        share = torch.zeros_like(em)
        share[lo:hi] = 1
        dw0, db0, dw1, db1, _, _ = scf_mp.scf_pass_p_plain(
            h, gout, rbf, cm, share, w0, b0, w1, b1, send, recv)
        packed = torch.cat([dw0.reshape(-1), db0, dw1.reshape(-1), db1])
        entries = [_scf_slice_entries(f, g, plan.width, j)
                   for j in range(plan.n_slices)]
        _every_entry_once(entries, plan.part_size)
        for idx in entries:
            partial[p, idx] = packed[idx]
    wgrad = partial[0]
    for p in range(1, plan.n_parts):
        wgrad = wgrad + partial[p]
    assert bool(torch.isfinite(wgrad).all())
    o1, o2, o3 = g * f, g * f + f, g * f + f + f * f
    got = (wgrad[:o1].view(g, f), wgrad[o1:o2], wgrad[o2:o3].view(f, f),
           wgrad[o3:])
    want = scf_mp.scf_pass_p_plain(h, gout, rbf, cm, em, w0, b0, w1, b1,
                                   send, recv)[:4]
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("f,d,a,wp,n_slices", [(64, 64, 0, 64, 1),
                                               (24, 16, 5, 16, 1),
                                               (1, 1, 0, 16, 1),
                                               (64, 64, 127, 64, 1),
                                               (256, 256, 0, 16, 16),
                                               (256, 256, 127, 16, 16)])
def test_cgcnn_pass_p_plan(f, d, a, wp, n_slices):
    """Slices of ``wp`` columns (the kernel's width at these shapes on the
    H100), one block per SM, the packed partial per part, and slices whose
    entries cover the packed layout exactly once."""
    plan = cgcnn_mp.pass_p_plan(f, d, a, 10**6, SMS, wp)
    assert (plan.wp, plan.n_slices) == (wp, n_slices)
    assert plan.part_size == 2 * (2 * f + a + 1) * d
    assert plan.n_parts == max(1, SMS // n_slices)
    assert cgcnn_mp.pass_p_plan(f, d, a, 3, SMS, wp).n_parts == min(
        3, plan.n_parts)
    _every_entry_once([_cgcnn_slice_entries(f, d, a, wp, j)
                       for j in range(n_slices)], plan.part_size)


def _part_rows(row_ptr, n_parts):
    """The kernel's runs of receiver rows: part p starts at the first row
    whose edges start at or after n_valid p / n_parts."""
    n_valid = int(row_ptr[-1])
    starts = [int(torch.searchsorted(row_ptr, n_valid * p // n_parts))
              for p in range(n_parts)]
    return list(zip(starts, starts[1:] + [len(row_ptr) - 1]))


@pytest.mark.parametrize("f,d,a,wp", [(64, 64, 0, 64), (24, 16, 5, 16),
                                      (40, 48, 3, 16)])
def test_cgcnn_parts_and_slices_cover_every_edge_and_column_once(f, d, a,
                                                                 wp):
    """Pass P's partition emulated with the plain version: each part takes
    whole receiver rows (its edges are theirs), each slice ``wp`` output
    columns; written at their packed entries, summed over the parts in
    order and unpacked by ``unpack_wgrad``, they equal pass P over the
    whole batch.  (40, 48, 3) with slices of 16 takes three slices."""
    from hydragnn_torch.ops.aggregate import segment_offsets

    n = 40
    send, recv, em, rng = _batch(n, 150, 220, seed=f + a, hub=40)
    e = len(send)
    x = torch.from_numpy(rng.randn(n, f).astype(np.float32))
    ea = (torch.from_numpy(rng.randn(e, a).astype(np.float32))
          if a else None)
    kf = torch.from_numpy((rng.randn(2 * f + a, d) / 8).astype(np.float32))
    ks = torch.from_numpy((rng.randn(2 * f + a, d) / 8).astype(np.float32))
    bf = torch.from_numpy((rng.randn(d) * 0.1).astype(np.float32))
    bs = torch.from_numpy((rng.randn(d) * 0.1).astype(np.float32))
    gout = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    plan = cgcnn_mp.pass_p_plan(f, d, a, e, SMS, wp)
    row_ptr = segment_offsets(recv, n, em).long()
    runs = _part_rows(row_ptr, plan.n_parts)
    assert runs[0][0] == 0 and runs[-1][1] == n
    assert all(r0 <= r1 for r0, r1 in runs)
    partial = torch.full((plan.n_parts, plan.part_size), float("nan"))
    for p, (r0, r1) in enumerate(runs):
        share = em * ((recv >= r0) & (recv < r1)).int()
        dkf, dbf, dks, dbs, _, _ = cgcnn_mp.cgcnn_pass_p_plain(
            x, ea, share, kf, bf, ks, bs, send, recv, gout)
        packed = torch.cat([dkf, dbf[None], dks, dbs[None]]).reshape(-1)
        entries = [_cgcnn_slice_entries(f, d, a, wp, j)
                   for j in range(plan.n_slices)]
        _every_entry_once(entries, plan.part_size)
        for idx in entries:
            partial[p, idx] = packed[idx]
    wgrad = partial[0]
    for p in range(1, plan.n_parts):
        wgrad = wgrad + partial[p]
    assert bool(torch.isfinite(wgrad).all())
    got = cgcnn_mp.unpack_wgrad(wgrad, f, d, a)
    want = cgcnn_mp.cgcnn_pass_p_plain(x, ea, em, kf, bf, ks, bs, send, recv,
                                       gout)[:4]
    for g_, w_ in zip(got, want):
        _close(g_, w_)
