"""DimeNet++'s builder-backed triplet op and ``HYDRAGNN_DIMENET_REMAT`` in
the PyTorch port against the JAX reference (hydragnn_tpu/ops/dn_tri.py
``dimenet_tri_builder``, hydragnn_tpu/models/dimenet.py).

The reference runs the fused-block builder in Pallas interpret mode on the
CPU; the port runs the plain versions of its CUDA kernels.  Tables as in
tests/test_dn_tri.py (5 graphs of 7 nodes, 37 padded triplets), built by
``tests/test_torch_dimenet.py:_both``.  Widths (S*R, B, D): (21, 8, 96),
the reference model test's int_emb_size 96 (tests/test_fused_block.py:779);
(70, 8, 64), num_radial 10; (126, 128, 128), the builder's limits.
Tolerances: ``out``, ``d_x_kj`` and ``d_sbf`` 1e-5 of their largest entry;
``dk1`` and ``dk2`` (sums over every triplet in another order) 1e-4; the
model 1e-4 (outputs and every parameter gradient, weights carried from a
JAX init); REMAT against no REMAT 1e-6.  Masked triplets give exactly zero
``d_sbf``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_torch.models.create import create_model as t_create_model
from hydragnn_torch.ops import dn_tri as tdt
from hydragnn_torch.telemetry import pipeline
from hydragnn_torch.utils.weights import load_flax_params
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.models.create import init_model
from test_torch_dimenet import MODEL_TOL, _both, _cfgs, _close, _model_run, _raw

WGRAD_TOL = 1e-4
REMAT_TOL = dict(rtol=1e-6, atol=1e-6)
NAMES = ("x_kj", "sbf", "k1", "k2")
WIDTHS = [(21, 8, 96), (70, 8, 64), (126, 128, 128)]


def _case(monkeypatch, sr, b, d, seed=3):
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", "fused")
    _, gt = _both(_raw(seed=seed))
    rng = np.random.RandomState(seed + sr + b + d)
    e = gt.senders.shape[0]
    t = gt.extras["dn_idx_kj"].shape[0]
    args = [rng.randn(e, d).astype(np.float32),
            (rng.randn(t, sr) * 0.5).astype(np.float32),
            (rng.randn(sr, b) / np.sqrt(sr)).astype(np.float32),
            (rng.randn(b, d) / np.sqrt(b)).astype(np.float32)]
    ex = gt.extras
    ids = (ex["dn_idx_kj"], ex["dn_idx_ji"], ex["dn_perm_kj"])
    tmask = ex["dn_triplet_mask"].to(torch.int32)
    return args, ids, tmask, rng.randn(e, d).astype(np.float32)


def _port(args, ids, tmask, wa, fn=None):
    kj, ji, perm = ids
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    if fn is None:
        out = tdt.dimenet_tri_builder(ts[0], ts[1], tmask, ts[2], ts[3], kj,
                                      ji, perm)
    else:
        out = fn(ts[0], ts[1], tmask, ts[2], ts[3], kj, ji)
    (out * torch.from_numpy(wa)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in ts]


def _jax(args, ids, tmask, wa):
    from hydragnn_tpu.ops.dn_tri import dimenet_tri_builder

    kj, ji, perm = (jnp.asarray(v.numpy()) for v in ids)
    tm = jnp.asarray(tmask.numpy())

    def f(x, sbf, k1, k2):
        return dimenet_tri_builder(x, sbf, tm, k1, k2, kj, ji, perm)

    out, vjp = jax.vjp(f, *[jnp.asarray(a) for a in args])
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(wa))]


def _hold(got, want, what=""):
    out, grads = got
    jout, jgrads = want
    _close(out, jout, f"{what}out")
    for name, g, w in zip(NAMES, grads, jgrads):
        tol = WGRAD_TOL if name in ("k1", "k2") else 1e-5
        _close(g, w, f"{what}d{name}", tol)


@pytest.mark.parametrize("sr,b,d", WIDTHS)
def test_builder_op_matches_jax(sr, b, d, monkeypatch):
    """``dimenet_tri_builder`` (the Function over the plain versions) and
    the composed plain version under autograd against the JAX op in
    interpret mode under ``jax.vjp``: forward and the four gradients;
    ``d_sbf`` exactly zero on masked triplets; no kernel launched."""
    args, ids, tmask, wa = _case(monkeypatch, sr, b, d)
    real = tmask.numpy() != 0
    assert (~real).any() and real.any()
    want = _jax(args, ids, tmask, wa)
    tdt.reset_launches()
    for fn in (None, tdt.dimenet_tri_builder_reference):
        got = _port(args, ids, tmask, wa, fn)
        _hold(got, want)
        assert np.all(got[1][1][~real] == 0.0)
    assert all(v == 0 for v in tdt.LAUNCHES.values())


@pytest.mark.parametrize("case", ["masked_tail", "all_masked", "empty"])
def test_builder_op_masked_and_empty(case, monkeypatch):
    """A longer masked tail (the last third of the real triplets masked as
    well, still last in both orders), every triplet masked, and no triplet
    at all: outputs and gradients exactly zero where the reference's are,
    the rest as in the matching test."""
    args, ids, tmask, wa = _case(monkeypatch, 70, 8, 64, seed=7)
    kj, ji, perm = ids
    if case == "masked_tail":
        real = int(tmask.sum())
        tmask = tmask.clone()
        tmask[real - real // 3:] = 0
        # the newly masked triplets are parked on the last edge, as
        # add_dimenet_extras parks padding, so both orders keep them last
        e = args[0].shape[0]
        kj, ji = kj.clone(), ji.clone()
        kj[tmask == 0] = e - 1
        ji[tmask == 0] = e - 1
        perm = torch.argsort(kj, stable=True).to(torch.int32)
    elif case == "all_masked":
        tmask = torch.zeros_like(tmask)
    else:
        args[1] = args[1][:0]
        kj, ji, perm, tmask = kj[:0], ji[:0], perm[:0], tmask[:0]
    ids = (kj, ji, perm)
    got = _port(args, ids, tmask, wa)
    dead = tmask.numpy() == 0
    assert np.all(got[1][1][dead] == 0.0)
    if case != "masked_tail":
        assert float(np.abs(got[0]).max()) == 0.0
        assert all(float(np.abs(g).sum()) == 0.0 for g in got[1])
    if case == "empty":
        return
    want = _jax(args, ids, tmask, wa)
    # rows with no real triplet: exactly zero in both packages
    rows = np.ones(args[0].shape[0], bool)
    rows[ji.numpy()[~dead]] = False
    assert np.all(got[0][rows] == 0.0) and np.all(want[0][rows] == 0.0)
    if case == "masked_tail":
        _hold(got, want)
    else:
        np.testing.assert_allclose(want[0], 0.0, atol=1e-6)


def test_builder_backward_plain_matches_autograd(monkeypatch):
    """The hand-written backward (plain version) against autograd through
    the composed reference, 1e-5 of each gradient's largest entry (1e-4
    for dk1, dk2); a single asked-for gradient; a double backward raises,
    naming the force term's queue item; the width check names its
    limits."""
    args, ids, tmask, wa = _case(monkeypatch, 21, 8, 96, seed=11)
    kj, ji, perm = ids
    ts = [torch.from_numpy(a) for a in args]
    grads = tdt.dimenet_tri_builder_bwd_plain(
        ts[0], ts[1], tmask, ts[2], ts[3], kj, ji, torch.from_numpy(wa))
    _, ref = _port(args, ids, tmask, wa, tdt.dimenet_tri_builder_reference)
    for name, g, r in zip(NAMES, grads, ref):
        assert g.dtype == torch.float32
        _close(g, r, name, WGRAD_TOL if name in ("k1", "k2") else 1e-5)
    k1 = ts[2].clone().requires_grad_(True)
    out = tdt.dimenet_tri_builder(ts[0], ts[1], tmask, k1, ts[3], kj, ji,
                                  perm)
    (g,) = torch.autograd.grad((out * torch.from_numpy(wa)).sum(), (k1,))
    _close(g, ref[2], "k1 alone", WGRAD_TOL)
    xs = ts[0].clone().requires_grad_(True)
    out = tdt.dimenet_tri_builder(xs, ts[1], tmask, ts[2], ts[3], kj, ji,
                                  perm)
    with pytest.raises(RuntimeError, match="not differentiable twice.*A3"):
        torch.autograd.grad(out.square().sum(), (xs,), create_graph=True)
    with pytest.raises(ValueError, match="S\\*R <= 127"):
        tdt.check_builder_widths(128, 8, 64)
    with pytest.raises(ValueError, match="D <= 128"):
        tdt.check_builder_widths(42, 8, 129)


# --- the model ----------------------------------------------------------------

def _jax_and_port(cfgs, gj, gt):
    jc, tc = cfgs
    jm = j_create_model(jc)
    variables = jax.tree.map(np.asarray, init_model(jm, gj, seed=0))
    tm = t_create_model(tc)
    load_flax_params(tm, variables["params"])
    return jm, variables, tm


def _held_to_jax(outs, got, jouts, jgrads):
    for t, j in zip(outs, jouts):
        np.testing.assert_allclose(t, np.asarray(j), **MODEL_TOL)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_allclose(flat_got[path], np.asarray(leaf),
                                   err_msg=jax.tree_util.keystr(path),
                                   **MODEL_TOL)


@pytest.mark.parametrize("width", ["int_emb96", "num_radial10_remat"])
def test_dimenet_builder_branch_matches_jax(width, monkeypatch):
    """DIMEStack (hidden 16, 2 convs, S = 7) past the factored gate, at
    int_emb_size 96 (R = 3), or at num_radial 10 (S*R = 70) with
    HYDRAGNN_DIMENET_REMAT=1 on both sides (the reference's nn.remat, the
    port's checkpoint), with JAX weights: both packages take the builder
    branch; outputs and every parameter gradient within 1e-4 of JAX; the
    tally shows dn_tri_builder:fused per interaction (twice under REMAT:
    the backward runs each conv again) and neither dn_tri nor
    dn_row_mlp."""
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", "fused")
    remat = width.endswith("remat")
    if remat:
        monkeypatch.setenv("HYDRAGNN_DIMENET_REMAT", "1")
    gj, gt = _both(_raw(seed=8))
    cfgs = _cfgs(num_radial=10) if remat else _cfgs(int_emb=96)
    jm, variables, tm = _jax_and_port(cfgs, gj, gt)
    assert all(c.remat is remat for c in tm.graph_convs)
    assert tm.graph_convs[0].branch(gt.extras) == "tri_builder"
    before = pipeline.dispatch_snapshot()
    outs, got, jouts, jgrads = _model_run(jm, variables, tm, gj, gt)
    delta = pipeline.dispatch_delta(before, pipeline.dispatch_snapshot())
    assert {k: v for k, v in delta.items() if k.startswith("dn_")} == {
        "dn_tri_builder:fused": 4 if remat else 2}
    _held_to_jax(outs, got, jouts, jgrads)


def _outs_and_grads(tm, gt):
    tm.zero_grad()
    outs = tm(gt)
    sum(o.square().sum() for o in outs).backward()
    return ([o.detach() for o in outs],
            {k: p.grad.clone() for k, p in tm.named_parameters()})


@pytest.mark.parametrize("branch", ["composed", "tri_builder"])
def test_remat_matches_without(branch, monkeypatch):
    """HYDRAGNN_DIMENET_REMAT=1 (each conv under torch.utils.checkpoint,
    read at model build): the same parameter names, outputs and every
    gradient within 1e-6 of the model without it, on the composed branch
    (``scatter``) and on the builder branch (``fused``, int_emb_size 96);
    an eval-mode forward keeps no recompute."""
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND",
                       "scatter" if branch == "composed" else "fused")
    _, gt = _both(_raw(seed=4))
    _, tc = _cfgs(int_emb=96)
    res = {}
    for remat in (False, True):
        if remat:
            monkeypatch.setenv("HYDRAGNN_DIMENET_REMAT", "1")
        tm = t_create_model(tc, seed=2)
        monkeypatch.delenv("HYDRAGNN_DIMENET_REMAT", raising=False)
        assert all(c.remat is remat for c in tm.graph_convs)
        assert tm.graph_convs[0].branch(gt.extras) == branch
        res[remat] = _outs_and_grads(tm, gt)
        with torch.no_grad():
            res[remat] += (tm(gt)[0],)
    (o0, g0, e0), (o1, g1, e1) = res[False], res[True]
    assert list(g0) == list(g1)
    for a, b in zip(o0 + [e0], o1 + [e1]):
        torch.testing.assert_close(b, a, **REMAT_TOL)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], **REMAT_TOL, msg=k)
