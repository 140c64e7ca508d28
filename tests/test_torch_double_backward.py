"""Double backward through the port's autograd Functions (create_graph).

The gather-multiply and the no-``w`` gather (ops/fused_mp.py), and the
sum-only branch of the poly gather's backward (ops/poly_mp.py), are
linear, so their backward is the same op with the roles swapped; it runs
through the same autograd Function and is differentiable in turn.  Held on
the CPU against the double backward of the plain composition (gather,
multiply, ``index_add_``), 1e-5 of the largest entry, also with the kernel leaf replaced by a
stand-in whose output carries no autograd graph, as a CUDA kernel's
output does not: the second derivative must not depend on the leaf.

The Functions whose backward runs kernels that are not differentiable
(the scf edge pipeline, the egcl block, the GAT attention, the cgcnn gated
sum) raise under ``create_graph=True`` instead of returning a silent zero,
on the CPU too.  The launches per train step of the paths that use the
fixed Functions stay what ``chip_smoke.PATH_LAUNCHES`` counts.
"""

import numpy as np
import pytest
import torch

from hydragnn_torch.ops import fused_mp as tfm
from hydragnn_torch.ops import poly_mp as tpoly

def _edges(seed, n=40, e_real=150, e_pad=170):
    """Sorted receivers, a masked tail parked on node N-1, the stable
    sender argsort."""
    rng = np.random.RandomState(seed)
    recv = np.sort(rng.randint(0, n - 3, e_real))
    send = rng.randint(0, n, e_real)
    senders = np.full(e_pad, n - 1, np.int32)
    receivers = np.full(e_pad, n - 1, np.int32)
    senders[:e_real], receivers[:e_real] = send, recv
    mask = np.zeros(e_pad, np.float32)
    mask[:e_real] = 1.0
    perm = np.argsort(senders, kind="stable").astype(np.int32)
    return (torch.from_numpy(senders), torch.from_numpy(receivers),
            torch.from_numpy(perm), torch.from_numpy(mask), rng)


def _second_order(fn, x, w, rng):
    """d/d(x, w) of < d/dx [sum(fn(x, w)^2 * c1)], c2 > (+ the same for
    d/dw on real edges): every term of the double backward."""
    c1 = torch.from_numpy(rng.randn(*fn(x, w).shape).astype(np.float32))
    xs = x.detach().clone().requires_grad_(True)
    ws = None if w is None else w.detach().clone().requires_grad_(True)
    out = fn(xs, ws)
    loss = (out.square() * c1).sum()
    leaves = (xs,) if ws is None else (xs, ws)
    first = torch.autograd.grad(loss, leaves, create_graph=True)
    c2 = [torch.from_numpy(np.random.RandomState(9).randn(*t.shape).astype(
        np.float32)) for t in first]
    inner = sum((d * c).sum() for d, c in zip(first, c2))
    return [t.detach() for t in first], torch.autograd.grad(inner, leaves)


def _plain_gather_mul(x, w, s, r, mask):
    msgs = x[s.long()] * (w if w is not None else mask[:, None])
    msgs = msgs * mask[:, None]
    return torch.zeros_like(x).index_add(0, r.long(), msgs)


def _kernel_like(monkeypatch):
    """Replace the kernel leaves (the forward's, and the backward's fused
    launch) by stand-ins whose outputs have no autograd graph (as a CUDA
    kernel's do not); count their calls per op."""
    real, real_bwd = tfm._gather_mul, tfm._gather_mul_bwd
    calls = {}

    def leaf(x, w, mask, senders, receivers, edge_valid, op, route=0):
        calls[op] = calls.get(op, 0) + 1
        with torch.no_grad():
            return real(x, w, mask, senders, receivers, edge_valid, op,
                        route)

    def leaf_bwd(*args):
        op = args[-1]
        calls[op] = calls.get(op, 0) + 1
        with torch.no_grad():
            return real_bwd(*args)

    monkeypatch.setattr(tfm, "_gather_mul", leaf)
    monkeypatch.setattr(tfm, "_gather_mul_bwd", leaf_bwd)
    return calls


OPS = {
    "gather_mul": (
        lambda x, w, s, r, p, m: tfm.gather_mul_segment_sum(
            x, w * m[:, None], s, r, p, edge_valid=m),
        lambda x, w, s, r, p, m: _plain_gather_mul(x, w, s, r, m), True),
    "gather": (
        lambda x, w, s, r, p, m: tfm.gather_segment_sum(x, s, r, p, m),
        lambda x, w, s, r, p, m: _plain_gather_mul(x, None, s, r, m), False),
    "poly_sum": (
        lambda x, w, s, r, p, m: tpoly.gather_poly_segment(
            x, s, r, p, ("sum", "cnt"), mask=m)[0],
        lambda x, w, s, r, p, m: _plain_gather_mul(x, None, s, r, m), False),
}


@pytest.mark.parametrize("stand_in", [False, True],
                         ids=["plain", "kernel-stand-in"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_double_backward_matches_plain(op, stand_in, monkeypatch):
    """First and second derivatives through the op equal those through the
    plain composition (1e-5 of the largest entry); with the stand-in leaf the backward's dx pass
    is still one call per backward, under the ``*_dx`` op name."""
    fused, plain, has_w = OPS[op]
    s, r, p, m, rng = _edges(3)
    n = 40
    x = torch.from_numpy(rng.randn(n, 6).astype(np.float32))
    w = torch.from_numpy(rng.randn(s.shape[0], 6).astype(np.float32)) \
        if has_w else None
    calls = _kernel_like(monkeypatch) if stand_in else None
    got_first, got = _second_order(
        lambda x_, w_: fused(x_, w_, s, r, p, m), x, w,
        np.random.RandomState(4))
    want_first, want = _second_order(
        lambda x_, w_: plain(x_, w_, s, r, p, m), x, w,
        np.random.RandomState(4))
    real = m != 0
    for a, b in zip(got_first + list(got), want_first + list(want)):
        if a.shape[0] == s.shape[0]:  # dw: garbage on masked edges
            a, b = a[real], b[real]
        # float32 sums in another order: 1e-5 of the largest entry
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    assert float(got[0].abs().max()) > 0
    if stand_in:
        dx = "gather_mul_segment_sum_dx" if has_w else "gather_segment_sum_dx"
        # the double backward differentiates the dx pass (another dx
        # pass) and, through x, the forward once more (its backward is a
        # dx pass again)
        assert calls.get(dx, 0) >= 2


def test_reversed_schedule_only_under_create_graph():
    """The reversed call's sender permutation (the stable argsort of
    receivers[p]) is built only when the backward itself is
    differentiated."""
    s, r, p, _, _ = _edges(5)
    q, rp = tfm._reversed_schedule(s, r, p)
    assert torch.equal(q, p.long())
    with torch.no_grad():
        assert tfm._reversed_schedule(s, r, p)[1] is None
    assert torch.equal(rp.long(), torch.argsort(r[q], stable=True))


def _forward(op_name):
    """``(out, x)`` through one of the Functions whose backward runs
    non-differentiable kernels."""
    s, r, p, m, rng = _edges(7)
    n, e = 40, s.shape[0]
    em = m.to(torch.int32)
    f = 8

    def t(*shape, scale=0.3):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32))

    x = t(n, f).requires_grad_(True)
    if op_name == "scf":
        from hydragnn_torch.ops.scf_mp import scf_edge_pipeline

        g = 5
        out = scf_edge_pipeline(x, t(e, g), m, em, t(g, f), t(f), t(f, f),
                                t(f), s, r, p)
    elif op_name == "egcl":
        from hydragnn_torch.ops.egcl_mp import egcl_block

        h = 8
        geo = torch.cat([t(e, 3, scale=0.2), t(e, 1).abs()], 1)
        out, _ = egcl_block(False, x, geo, em, t(2 * f + 1, h), t(h),
                            t(h, h), t(h), None, None, None, s, r, p)
    elif op_name == "gat":
        from hydragnn_torch.ops.gat_mp import gat_edge_attention

        heads = 2
        x = t(n, heads * f).requires_grad_(True)
        out, _, _ = gat_edge_attention(x, t(n, heads * f), t(heads, f), s,
                                       r, p, m, None, 0.05, f)
    else:
        from hydragnn_torch.ops.cgcnn_mp import cgcnn_gated_block

        out = cgcnn_gated_block(x, None, em, t(2 * f, f), t(f),
                                t(2 * f, f), t(f), s, r, p)
    return out, x


@pytest.mark.parametrize("op_name", ["scf", "egcl", "gat", "cgcnn"])
def test_kernel_backwards_refuse_double_backward(op_name):
    """A double backward through a Function whose backward runs
    non-differentiable kernels raises (on the CPU too) instead of
    returning a silent zero; a single backward runs."""
    out, x = _forward(op_name)
    (g,) = torch.autograd.grad(out.square().sum(), (x,), retain_graph=True)
    assert float(g.abs().max()) > 0
    with pytest.raises(RuntimeError, match="not differentiable twice"):
        torch.autograd.grad(out.square().sum(), (x,), create_graph=True)


@pytest.mark.parametrize("path", ["flagship", "GIN", "SAGE"])
def test_dx_launches_per_step_unchanged(path, monkeypatch):
    """One train step under ``fused`` on the CPU, the kernel leaf replaced
    by the stand-in: the gather and dx calls per step equal
    ``chip_smoke.PATH_LAUNCHES``, where the card counts a launch for each
    (the backward's dx passes now run through the Functions)."""
    import chip_smoke
    from hydragnn_torch.models.base import GraphHeadCfg, ModelConfig
    from hydragnn_torch.models.create import create_model
    from hydragnn_torch.train.optimizer import select_optimizer
    from hydragnn_torch.train.trainer import create_train_state, \
        make_train_step
    from test_torch_schnet import _batches, _samples

    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", "fused")
    _, gt = _batches(_samples(1.6, 10, 12, n_graphs=4, seed=2),
                     [("energy", "graph", 1)])
    model_type = "SchNet" if path == "flagship" else path
    cfg = ModelConfig(
        model_type=model_type, input_dim=1, hidden_dim=8, output_dim=(1,),
        output_type=("graph",), graph_head=GraphHeadCfg(1, 8, 1, (8,)),
        node_head=None, task_weights=(1.0,), num_conv_layers=4,
        num_gaussians=6, num_filters=8, radius=1.6, max_neighbours=10)
    model = create_model(cfg, seed=0)
    spec = select_optimizer({"type": "AdamW", "learning_rate": 1e-3})
    state = create_train_state(model, spec)
    step = make_train_step(model, cfg, spec)
    calls = _kernel_like(monkeypatch)
    step(state, gt)
    want = {k: v for k, v in chip_smoke.PATH_LAUNCHES[path][0].items()
            if k.startswith("gather_") and k != "gather_poly_segment"}
    assert calls == want
