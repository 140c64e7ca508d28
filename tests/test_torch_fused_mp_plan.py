"""Route 1 of the gather-multiply kernel and its fused backward, on the CPU.

The card's kernels (csrc/fused_mp.cu ``gm::``) cannot run here, so their
plan is held instead: the routes by width (``fwd_route``), and route 1's
walks written out in torch from ``route1_walk`` — warp shares of
``row_shares``, batches of 32 ids, groups of at most 8 edges, each row
summed in edge (forward) or position (backward) order — which must give
the plain versions' answer with every output row and every dw row written
exactly once, empty rows and masked edges' dw rows zero.  The fused
backward's plain version (``gather_mul_segment_sum_bwd_plain``) against
the reference VJPs (``_vjp_bwd``, ``_gss_bwd``) through ``jax.vjp`` in
interpret mode, masked and unmasked, at 1e-5 (float32 sums in another
order, dx at 1e-5 of its largest entry; dw on real edges: the reference's
masked rows are garbage).  And
the ops' autograd Functions on the CPU: a plain backward takes the fused
leaf once and builds no ``[E, F]`` tensor outside it; under
``create_graph`` the composition (``w[p]``, ``x[senders]``,
``g[receivers]``) runs instead.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import jax
import jax.numpy as jnp

from hydragnn_tpu.ops import fused_mp as jfm
from hydragnn_torch.ops import fused_mp as tfm
from hydragnn_torch.ops.aggregate import segment_offsets
from test_torch_gpu import _graph_batch

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("f,route", [
    (64, 1),    # the flagship's convs, GIN's layers 1-3, SAGE's and MFC's
                # sum-only backward, the arch sweep's hidden width
    (1, 2),     # GIN's layer-0 input width (one node feature)
    (2, 1), (130, 1), (256, 1), (5, 2), (63, 2), (0, 2)])
def test_routes_by_width(f, route):
    assert tfm.fwd_route(f) == route


def _batch(seed, hub, masked, f):
    b = _graph_batch(seed, hub=hub)
    n, e = len(b["node_gid"]), len(b["senders"])
    rng = np.random.RandomState(seed + 1)
    mask = b["edge_mask"]
    x = _t(rng.randn(n, f).astype(np.float32))
    w = _t((rng.randn(e, f) * mask[:, None]).astype(np.float32))
    g = _t(rng.randn(n, f).astype(np.float32))
    return (b, x, w, g, _t(b["senders"]), _t(b["receivers"]), _t(b["perm"]),
            _t(mask) if masked else None)


def _check_groups(row_ptr, bounds, groups):
    """Each warp walks its rows' positions in order, in groups of at most
    8 that never straddle a batch of 32 ids."""
    ptr = row_ptr.long()
    for w_, gs in enumerate(groups):
        p0 = int(ptr[int(bounds[w_])])
        p1 = int(ptr[int(bounds[w_ + 1])])
        walked = [k for b, e in gs for k in range(b, e)]
        assert walked == list(range(p0, p1))
        batch = tfm.GM_ID_BATCH
        for b, e in gs:
            assert 0 < e - b <= tfm.GM_EDGES_IN_FLIGHT
            assert (b - p0) // batch == (e - 1 - p0) // batch


def _walk(n, f, row_ptr, n_warps, term, at_position=None):
    """Route 1's walk over ``row_ptr``: each warp's rows summed in position
    order, a row written when the walk passes its end and the share's rows
    past its last position as zeros.  ``term(k)`` is position k's term (or
    None off a real edge); ``at_position(k, row)`` is called at each
    position with its row.  Returns the rows and their write counts."""
    out = torch.full((n, f), float("nan"))
    writes = torch.zeros(n, dtype=torch.int64)
    ptr = row_ptr.long()
    bounds, groups, _ = tfm.route1_walk(row_ptr, n_warps)
    _check_groups(row_ptr, bounds, groups)

    def put(r, v):
        out[r] = v
        writes[r] += 1

    for w_ in range(n_warps):
        rb, re = int(bounds[w_]), int(bounds[w_ + 1])
        if rb >= re:
            assert not groups[w_]
            continue
        row, acc = rb, torch.zeros(f)
        for b, e in groups[w_]:
            terms = [term(k) for k in range(b, e)]  # loaded before adding
            for k, t_ in zip(range(b, e), terms):
                while k >= int(ptr[row + 1]):
                    put(row, acc)
                    row, acc = row + 1, torch.zeros(f)
                if at_position is not None:
                    at_position(k, row)
                if t_ is not None:
                    acc = acc + t_
        put(row, acc)
        for r in range(row + 1, re):
            put(r, torch.zeros(f))
    return out, writes


@pytest.mark.parametrize("n_warps", [1, 5, 64, 400])
@pytest.mark.parametrize("hub", [0, 300])
@pytest.mark.parametrize("mode", ["w", "mask"])
def test_route1_forward_walk(n_warps, hub, mode):
    """The forward's walk over the receiver rows gives the plain version's
    answer (1e-5), every row written once, empty rows zero, whatever the
    number of warps."""
    b, x, w, _, send, recv, _, mask = _batch(3 + hub, hub, True, 6)
    n, f = x.shape
    row_ptr = segment_offsets(recv, n, mask)

    def term(k):
        s = int(send[k])
        if not 0 <= s < n:
            return None
        return x[s] * (w[k] if mode == "w" else mask[k])

    out, writes = _walk(n, f, row_ptr, n_warps, term)
    want = tfm.gather_mul_segment_sum_plain(
        x, w if mode == "w" else None, send, recv, edge_valid=mask,
        mask=mask if mode == "mask" else None)
    assert torch.equal(writes, torch.ones(n, dtype=torch.int64))
    torch.testing.assert_close(out, want, **TOL)
    empty = row_ptr.diff() == 0
    assert bool(empty.any()) and bool((out[empty] == 0).all())


@pytest.mark.parametrize("n_warps", [1, 7, 64, 400])
@pytest.mark.parametrize("hub", [0, 300])
@pytest.mark.parametrize("masked", [True, False])
def test_route1_backward_walk(n_warps, hub, masked):
    """The backward's walk over the sender rows (positions through
    ``sender_perm``): dx the plain version's (1e-5), dw its bits, every dx
    row and every dw row written once (the walk's, then the warps' share
    of the positions outside every row), masked edges' dw rows zero."""
    b, x, w, g, send, recv, perm, mask = _batch(11 + hub, hub, masked, 6)
    n, f = x.shape
    e = w.shape[0]
    p = perm.long()
    row_ptr = segment_offsets(send[p], n, None if mask is None else mask[p])
    dw = torch.full((e, f), float("nan"))
    dw_writes = torch.zeros(e, dtype=torch.int64)

    def term(k):
        r = int(recv[p[k]])
        return g[r] * w[p[k]] if 0 <= r < n else None

    def at_position(k, row):
        ei, r = int(p[k]), int(recv[p[k]])
        assert int(send[ei]) == row
        dw[ei] = x[row] * g[r] if 0 <= r < n else torch.zeros(f)
        dw_writes[ei] += 1

    dx, writes = _walk(n, f, row_ptr, n_warps, term, at_position)
    _, _, tail = tfm.route1_walk(row_ptr, n_warps, e)
    for ks in tail:
        for k in ks:
            dw[int(p[k])] = 0.0
            dw_writes[int(p[k])] += 1
    pdx, pdw = tfm.gather_mul_segment_sum_bwd_plain(g, x, w, send, recv, mask)
    assert torch.equal(writes, torch.ones(n, dtype=torch.int64))
    assert torch.equal(dw_writes, torch.ones(e, dtype=torch.int64))
    torch.testing.assert_close(dx, pdx, **TOL)
    assert torch.equal(dw, pdw)
    if masked:
        off = mask == 0
        assert bool(off.any()) and bool((dw[off] == 0).all())


def _vjp_jax(fn, primals, ct):
    _, pull = jax.vjp(fn, *primals)
    return [np.asarray(a) for a in pull(jnp.asarray(ct))]


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("mode", ["w", "no-w"])
def test_bwd_plain_matches_jax(mode, masked):
    """The fused backward's plain version against the reference VJP
    (``_vjp_bwd``; ``_gss_bwd`` in the no-``w`` mode) in interpret mode:
    dx at 1e-5, dw on real edges at 1e-5, and zero on masked ones."""
    b, x, w, g, send, recv, perm, mask = _batch(21, 0, True, 24)
    m = b["edge_mask"]
    s, r, p = (jnp.asarray(b[k]) for k in ("senders", "receivers", "perm"))
    if mode == "w":
        ev = jnp.asarray(m) if masked else None
        want = _vjp_jax(lambda x_, w_: jfm.gather_mul_segment_sum(
            x_, w_, s, r, p, edge_valid=ev),
            (jnp.asarray(x.numpy()), jnp.asarray(w.numpy())), g.numpy())
        dx, dw = tfm.gather_mul_segment_sum_bwd_plain(
            g, x, w, send, recv, mask if masked else None)
        real = m != 0
        np.testing.assert_allclose(dw.numpy()[real], want[1][real], **TOL)
        if masked:
            assert np.all(dw.numpy()[~real] == 0)
    else:
        mk = jnp.asarray(m) if masked else None
        want = _vjp_jax(lambda x_: jfm.gather_segment_sum(x_, s, r, p, mk),
                        (jnp.asarray(x.numpy()),), g.numpy())
        mm = mask if masked else None
        dx, dw = tfm.gather_mul_segment_sum_bwd_plain(
            g, None, None, send, recv, mm, mm)
        assert dw is None
    # float32 sums in another order, held at 1e-5 of the largest entry:
    # unmasked, the no-w mode's padding node sums every padding edge
    np.testing.assert_allclose(dx.numpy(), want[0], rtol=1e-5,
                               atol=1e-5 * float(np.abs(want[0]).max()))


class _Shapes(TorchDispatchMode):
    """The shapes of every tensor an op makes, except while ``paused``."""

    def __init__(self):
        super().__init__()
        self.made, self.paused = [], False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused:
            self.made += [(str(func), tuple(t.shape))
                          for t in tree_flatten(out)[0]
                          if isinstance(t, torch.Tensor)]
        return out


@pytest.mark.parametrize("create_graph", [False, True],
                         ids=["fused", "composed"])
@pytest.mark.parametrize("op", ["gather_mul", "gather"])
def test_function_backward_path_on_cpu(op, create_graph, monkeypatch):
    """A plain backward through the op's Function calls the fused leaf
    once (under the ``*_dx`` key) and makes no ``[E, F]`` tensor outside
    it: no ``w[p]``, ``x[senders]`` or ``g[receivers]``.  Under
    ``create_graph`` the composition runs instead (the forward's leaf under
    the ``*_dx`` key, and in the w mode those ``[E, F]`` gathers).  Both
    give the plain versions' gradients, dw on real edges."""
    b, x, w, g, send, recv, perm, mask = _batch(31, 0, True, 8)
    e, f = w.shape
    calls, mode = [], _Shapes()
    real_fwd, real_bwd = tfm._gather_mul, tfm._gather_mul_bwd

    def leaf(*args, **kw):
        calls.append(("fwd", args[6]))
        mode.paused = True
        try:
            return real_fwd(*args, **kw)
        finally:
            mode.paused = False

    def leaf_bwd(*args):
        calls.append(("bwd", args[-1]))
        mode.paused = True
        try:
            return real_bwd(*args)
        finally:
            mode.paused = False

    monkeypatch.setattr(tfm, "_gather_mul", leaf)
    monkeypatch.setattr(tfm, "_gather_mul_bwd", leaf_bwd)
    xs = x.clone().requires_grad_(True)
    if op == "gather_mul":
        ws = w.clone().requires_grad_(True)
        out = tfm.gather_mul_segment_sum(xs, ws, send, recv, perm,
                                         edge_valid=mask)
        leaves, key = (xs, ws), "gather_mul_segment_sum_dx"
        want = tfm.gather_mul_segment_sum_bwd_plain(g, x, w, send, recv,
                                                    mask)
    else:
        out = tfm.gather_segment_sum(xs, send, recv, perm, mask)
        leaves, key = (xs,), "gather_segment_sum_dx"
        want = tfm.gather_mul_segment_sum_bwd_plain(g, None, None, send,
                                                    recv, mask, mask)
    calls.clear()
    with mode:
        got = torch.autograd.grad(out, leaves, g, create_graph=create_graph)
    kind = "fwd" if create_graph else "bwd"
    assert calls == [(kind, key)]
    big = [m_ for m_ in mode.made if m_[1] == (e, f)]
    if create_graph and op == "gather_mul":
        assert big  # the composition's gathers, seen by the same record
    else:
        assert not big, big
    torch.testing.assert_close(got[0].detach(), want[0], **TOL)
    if op == "gather_mul":
        real = mask != 0
        torch.testing.assert_close(got[1].detach()[real], want[1][real],
                                   **TOL)
