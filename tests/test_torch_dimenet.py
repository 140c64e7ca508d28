"""DimeNet++ in the PyTorch port against the JAX reference
(hydragnn_tpu/models/dimenet.py, ops/dn_tri.py, ops/row_mlp.py).

The reference runs its Pallas kernels in interpret mode on the CPU; the
port runs the plain versions of its CUDA kernels.  Inputs as in
tests/test_dn_tri.py (5 graphs of 7 nodes, S = 7, R = 3, B = 8, D = 16,
37 padded triplets) and tests/test_row_mlp.py (H = 24, D = 16, one pair
before the skip, two after).  Tolerances: the host tables exactly; the
basis and the two ops' forwards 1e-5; the ops' gradients 1e-5 of each
gradient's largest entry (sums over triplets in another order); the model
1e-4 (outputs and every parameter gradient, weights carried from a JAX
init by ``load_flax_params``).  Masked triplets give exactly zero
``d_cbf``.

The reference's spherical Bessel functions come from an upward recurrence
that loses every float32 digit where 0.5 < z_ln * d/cutoff < l (d/cutoff
between ~0.03 and ~0.4 at S = 7): there the two packages are as far from
float64 as each other and disagree with each other (tested on both sides
of that band).  The random graphs here keep their atoms at least 0.55
apart (d/cutoff >= 0.42), as molecules and the synthetic BCC set (0.87)
do.

Also: the hand-written backwards against autograd through the composed
plain versions, the double-backward refusals, the dispatch tally, the
builder width's branch (its op and REMAT against JAX:
tests/test_torch_dn_tri_builder.py), and a DimeNet ``.pk`` written by each
package's ``run_training`` read by both ``run_prediction``s.
"""

import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.graph import batch as jb
from hydragnn_tpu.graph.neighborlist import radius_graph
from hydragnn_tpu.models import base as jbase
from hydragnn_tpu.models import dimenet as jdn
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.models.create import init_model
from hydragnn_torch.graph import batch as tb
from hydragnn_torch.graph import segment as tseg
from hydragnn_torch.models import base as tbase
from hydragnn_torch.models import dimenet as tdn
from hydragnn_torch.models.create import create_model as t_create_model
from hydragnn_torch.ops import dn_tri as tdt
from hydragnn_torch.ops import row_mlp as trm
from hydragnn_torch.telemetry import pipeline
from hydragnn_torch.utils.weights import (
    flax_params_from_module,
    load_flax_params,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, R, B, D = 7, 3, 8, 16
OP_TOL = 1e-5
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
TRI_NAMES = ("radial", "x2", "cbf", "w1", "w2")
EXTRA_KEYS = ("dn_idx_i", "dn_idx_j", "dn_idx_k", "dn_idx_kj", "dn_idx_ji",
              "dn_perm_kj", "dn_triplet_mask")


def _spread(rng, nodes, box=2.0, gap=0.55):
    """``nodes`` random points in a box, at least ``gap`` apart."""
    pts = []
    while len(pts) < nodes:
        p = rng.rand(3) * box
        if all(np.linalg.norm(p - q) >= gap for q in pts):
            pts.append(p)
    return np.asarray(pts, np.float32)


def _raw(n_graphs=5, nodes=7, seed=0, radius=1.3, cap=6):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_graphs):
        pos = _spread(rng, nodes)
        out.append(dict(x=rng.rand(nodes, 1).astype(np.float32), pos=pos,
                        edge_index=radius_graph(pos, radius, cap),
                        graph_y=rng.rand(1).astype(np.float32)))
    return out


def _both(raw, extra_pad=37):
    """The same samples collated by both packages, each with its own
    ``add_dimenet_extras`` (one-shot: the per-batch gate)."""
    heads = [("e", "graph", 1)]
    js = [jb.GraphSample(**r) for r in raw]
    ts = [tb.GraphSample(**r) for r in raw]
    n = max(s.num_nodes for s in js)
    e = max(s.num_edges for s in js)
    gj = jb.collate(js, jb.PadSpec.for_batch(len(js), n, e),
                    [jb.HeadSpec(*h) for h in heads])
    gt = tb.collate(ts, tb.PadSpec.for_batch(len(ts), n, e),
                    [tb.HeadSpec(*h) for h in heads])
    real = np.asarray(gj.edge_mask) > 0
    ei = np.stack([np.asarray(gj.senders)[real],
                   np.asarray(gj.receivers)[real]])
    t = jdn.count_triplets(ei, gj.x.shape[0])
    assert tdn.count_triplets(ei, gt.x.shape[0]) == t
    return (jdn.add_dimenet_extras(gj, max_triplets=t + extra_pad),
            tdn.add_dimenet_extras(gt, max_triplets=t + extra_pad))


# --- host tables ------------------------------------------------------------

@pytest.mark.parametrize("mode", ["scatter", "fused", "fused_off",
                                  "fused_window"])
def test_host_tables_match_jax(mode, monkeypatch):
    """build_triplets and add_dimenet_extras array for array: the padding
    fills, ``dn_perm_kj``, the ``dn_tri_ok`` marker under ``fused`` only
    (not under HYDRAGNN_DN_TRI_OFF), ``dn_tri_window`` under
    HYDRAGNN_DIMENET_FUSED_TRI."""
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND",
                       "scatter" if mode == "scatter" else "fused")
    if mode == "fused_off":
        monkeypatch.setenv("HYDRAGNN_DN_TRI_OFF", "1")
    if mode == "fused_window":
        monkeypatch.setenv("HYDRAGNN_DIMENET_FUSED_TRI", "1")
    raw = _raw(seed=1)
    gj, gt = _both(raw)
    for r in raw:
        want = jdn.build_triplets(r["edge_index"], 7)
        got = tdn.build_triplets(r["edge_index"], 7)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    assert set(gt.extras) == set(gj.extras)
    for k in gj.extras:
        np.testing.assert_array_equal(gt.extras[k].numpy(),
                                      np.asarray(gj.extras[k]), err_msg=k)
    assert ("dn_tri_ok" in gt.extras) == (mode in ("fused", "fused_window"))
    assert ("dn_tri_window" in gt.extras) == (mode == "fused_window")
    tm = gt.extras["dn_triplet_mask"].numpy()
    assert 0 < tm.sum() < tm.size and np.all(np.diff(tm) <= 0)
    ji = gt.extras["dn_idx_ji"].numpy()
    assert np.all(np.diff(ji) >= 0)


def test_empty_graphs_give_an_all_masked_table():
    """No edges at all: every triplet slot is padding, parked on the last
    node and edge, as in the reference."""
    raw = [dict(x=np.ones((3, 1), np.float32),
                pos=np.zeros((3, 3), np.float32) + np.arange(3)[:, None] * 9,
                edge_index=np.zeros((2, 0), np.int64),
                graph_y=np.ones(1, np.float32))] * 2
    js = [jb.GraphSample(**r) for r in raw]
    ts = [tb.GraphSample(**r) for r in raw]
    gj = jb.collate(js, jb.PadSpec.for_batch(2, 3, 1), [jb.HeadSpec("e", "graph", 1)])
    gt = tb.collate(ts, tb.PadSpec.for_batch(2, 3, 1), [tb.HeadSpec("e", "graph", 1)])
    gj = jdn.add_dimenet_extras(gj, max_triplets=8)
    gt = tdn.add_dimenet_extras(gt, max_triplets=8)
    for k in EXTRA_KEYS:
        np.testing.assert_array_equal(gt.extras[k].numpy(),
                                      np.asarray(gj.extras[k]), err_msg=k)
    assert float(gt.extras["dn_triplet_mask"].sum()) == 0
    with pytest.raises(ValueError, match="max_triplets"):
        tdn.add_dimenet_extras(_both(_raw(seed=2))[1], max_triplets=4)


def test_dn_tri_gate_static_and_sticky():
    """The reference's static and sticky modes (tests/test_dn_tri.py:168):
    the static gate never measures; the sticky one turns off for the rest
    of the run at the first over-span batch, tallied as a fallback."""
    def must_not_measure():
        raise AssertionError("static gate measured a batch span")

    for bound, ok in ((2 * 128, True), (257, True), (258, False),
                      (4 * 128, False)):
        gate = tdn.DnTriGate(max_edges_per_graph=bound)
        want = jdn.DnTriGate(max_edges_per_graph=bound)
        assert gate.static and gate.allow(must_not_measure) is ok
        assert gate.span_bound == want.span_bound and want.ok is ok
    before = pipeline.dispatch_snapshot()
    gate = tdn.DnTriGate()
    assert gate.allow(lambda: 1)
    assert not gate.allow(lambda: 3)
    assert not gate.allow(lambda: 0)
    assert not gate.allow(must_not_measure)
    delta = pipeline.dispatch_delta(before, pipeline.dispatch_snapshot())
    assert delta == {"dn_tri_fallback:edge_span": 1}


def test_static_gate_keeps_the_extras_tree(monkeypatch):
    """With a static gate every batch carries the same extras keys
    (tests/test_dn_tri.py:194)."""
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", "fused")
    gate = tdn.DnTriGate(max_edges_per_graph=42)
    keys = []
    for seed in (21, 22):
        _, gt = _both(_raw(seed=seed))
        gt = tdn.add_dimenet_extras(
            dataclasses.replace(gt, extras={
                k: v for k, v in gt.extras.items()
                if not k.startswith("dn_")}), 4096, tri_gate=gate)
        keys.append(sorted(gt.extras))
    assert keys[0] == keys[1] and "dn_tri_ok" in keys[0]


# --- basis ------------------------------------------------------------------

def test_basis_functions_match_jax():
    """BesselBasis (the same freq), radial_sbf, angular_cbf and
    spherical_basis (with and without the permuted gather) at 1e-5, with
    distances past the cutoff, inside the Taylor guard (z d/cutoff < 0.5
    for every slot) and at it, and angles at 0 and pi; in the recurrence's
    ill-conditioned band, the port no further from float64 than JAX."""
    rng = np.random.RandomState(3)
    dist = np.concatenate([0.75 + rng.rand(40) * 1.5,
                           [0.0, 1e-8, 0.01, 1.8, 2.5]]).astype(np.float32)
    angle = np.concatenate([rng.rand(60) * np.pi, [0.0, np.pi]]
                           ).astype(np.float32)
    e, t = dist.size, angle.size
    idx_kj = rng.randint(0, e, t).astype(np.int32)
    perm = np.argsort(idx_kj, kind="stable").astype(np.int32)
    cutoff, env = 1.8, 5
    freq = (np.arange(1, R + 1) * np.pi + rng.rand(R) * 0.1).astype(
        np.float32)
    bb = jdn.BesselBasis(R, cutoff, env)
    want = bb.apply({"params": {"freq": freq}}, jnp.asarray(dist))
    tbb = tdn.BesselBasis(R, cutoff, env)
    with torch.no_grad():
        tbb.freq.copy_(torch.from_numpy(freq))
        got = tbb(torch.from_numpy(dist))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    dn = dist / cutoff
    td, ta = torch.from_numpy(dn), torch.from_numpy(angle)
    np.testing.assert_allclose(
        tdn.radial_sbf(td, S, R, env).numpy(),
        np.asarray(jdn.radial_sbf(jnp.asarray(dn), S, R, env)), **tol)
    np.testing.assert_allclose(
        tdn.angular_cbf(ta, S).numpy(),
        np.asarray(jdn.angular_cbf(jnp.asarray(angle), S)), **tol)
    for p in (None, perm):
        got = tdn.spherical_basis(
            td, ta, torch.from_numpy(idx_kj), S, R, env,
            perm_kj=None if p is None else torch.from_numpy(p))
        want = jdn.spherical_basis(
            jnp.asarray(dn), jnp.asarray(angle), jnp.asarray(idx_kj), S, R,
            env, perm_kj=None if p is None else jnp.asarray(p))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    assert np.isfinite(tdn.radial_sbf(td, S, R, env).numpy()).all()
    # inside the recurrence's ill-conditioned band both packages lose every
    # float32 digit: the port is no further from float64 than the reference
    band = np.linspace(0.03, 0.4, 60).astype(np.float32)
    tb_ = torch.from_numpy(band)
    exact = tdn.radial_sbf(tb_.double(), S, R, env).numpy()
    port_err = np.abs(tdn.radial_sbf(tb_, S, R, env).numpy() - exact).max()
    jax_err = np.abs(np.asarray(jdn.radial_sbf(jnp.asarray(band), S, R, env))
                     - exact).max()
    assert port_err <= 1.5 * jax_err


def test_gather_perm_matches_jax():
    """segment.gather_perm: forward and backward (the sorted segment sum
    through the permutation) against hydragnn_tpu's, with and without the
    triplet mask."""
    from hydragnn_tpu.graph import segment as jseg

    rng = np.random.RandomState(5)
    x = rng.randn(30, 6).astype(np.float32)
    idx = rng.randint(0, 30, 80).astype(np.int32)
    idx[70:] = 29
    valid = np.ones(80, np.float32)
    valid[70:] = 0
    perm = np.argsort(idx, kind="stable").astype(np.int32)
    ct = rng.randn(80, 6).astype(np.float32) * valid[:, None]

    def jf(xx):
        return jnp.sum(jseg.gather_perm(xx, jnp.asarray(idx),
                                        jnp.asarray(perm)) * ct)

    jout = jseg.gather_perm(jnp.asarray(x), jnp.asarray(idx),
                            jnp.asarray(perm))
    jgrad = jax.grad(jf)(jnp.asarray(x))
    for v in (None, torch.from_numpy(valid)):
        tx = torch.from_numpy(x).requires_grad_(True)
        out = tseg.gather_perm(tx, torch.from_numpy(idx),
                               torch.from_numpy(perm), v)
        (out * torch.from_numpy(ct)).sum().backward()
        np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad),
                                   rtol=1e-5, atol=1e-5)


# --- the triplet op (B10) ---------------------------------------------------

def _tri_case(monkeypatch, seed):
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", "fused")
    gj, gt = _both(_raw(seed=seed))
    rng = np.random.RandomState(seed + 1)
    e = gt.senders.shape[0]
    t = gt.extras["dn_idx_kj"].shape[0]
    args = [rng.rand(e, S * R).astype(np.float32),
            rng.randn(e, D).astype(np.float32),
            (rng.randn(t, S) * 0.5).astype(np.float32),
            (rng.randn(S * R, B) * 0.3).astype(np.float32),
            (rng.randn(B, D) * 0.3).astype(np.float32)]
    ids = tuple(gt.extras[k] for k in ("dn_idx_kj", "dn_idx_ji"))
    tmask = gt.extras["dn_triplet_mask"].to(torch.int32)
    return args, ids, tmask, gt.extras["dn_perm_kj"], rng.randn(
        e, D).astype(np.float32)


def _tri_run(fn, args, wa):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fn(*ts)
    (out * torch.from_numpy(wa)).sum().backward()
    return out.detach(), [x.grad for x in ts]


def _close(got, want, what, tol=OP_TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("seed", [3, 9])
def test_triplet_op_matches_jax(seed, monkeypatch):
    """``dimenet_triplet_mp`` (the Function over the plain versions) and
    the composed reference under autograd against the JAX op in interpret
    mode: forward and all five gradients 1e-5 of their largest entry;
    ``d_cbf`` exactly zero on masked triplets."""
    args, (kj, ji), tmask, perm, wa = _tri_case(monkeypatch, seed)
    j_ids = [jnp.asarray(v.numpy()) for v in (kj, ji, tmask, perm)]

    def jloss(*a):
        out = jdn_op(*a)
        return jnp.sum(out * wa), out

    def jdn_op(*a):
        from hydragnn_tpu.ops.dn_tri import dimenet_triplet_mp

        return dimenet_triplet_mp(*a, *j_ids, R)

    (_, jout), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True)(
        *[jnp.asarray(a) for a in args])
    real = tmask.numpy() != 0
    assert (~real).any()
    tdt.reset_launches()
    for fn in (lambda *a: tdt.dimenet_triplet_mp(*a, kj, ji, tmask, perm, R),
               lambda *a: tdt.dimenet_triplet_reference(*a, kj, ji, tmask,
                                                        R)):
        out, grads = _tri_run(fn, args, wa)
        _close(out, jout, "out")
        for name, got, want in zip(TRI_NAMES, grads, jgrads):
            if name == "cbf":
                assert np.all(got.numpy()[~real] == 0.0)
            _close(got, want, name)
    assert all(v == 0 for v in tdt.LAUNCHES.values())


def test_triplet_backward_matches_autograd(monkeypatch):
    """The hand-written backward (plain version) against autograd through
    the composed reference, 1e-5 of each gradient's largest entry; only
    the asked-for gradients are computed."""
    args, (kj, ji), tmask, perm, wa = _tri_case(monkeypatch, 11)
    _, gk = _tri_run(lambda *a: tdt.dimenet_triplet_mp(
        *a, kj, ji, tmask, perm, R), args, wa)
    _, gr = _tri_run(lambda *a: tdt.dimenet_triplet_reference(
        *a, kj, ji, tmask, R), args, wa)
    for name, x, y in zip(TRI_NAMES, gk, gr):
        assert x.dtype == torch.float32
        _close(x, y, name)
    ts = [torch.from_numpy(a) for a in args]
    w1 = ts[3].requires_grad_(True)
    out = tdt.dimenet_triplet_mp(*ts[:3], w1, ts[4], kj, ji, tmask, perm, R)
    (g,) = torch.autograd.grad((out * torch.from_numpy(wa)).sum(), (w1,))
    _close(g, gr[3], "w1 alone")


@pytest.mark.parametrize("case", ["empty", "all_masked"])
def test_triplet_op_empty_and_all_masked(case, monkeypatch):
    """No triplet at all (T = 0) and every triplet masked: zero output
    and zero gradients, as the reference gives."""
    args, (kj, ji), tmask, perm, wa = _tri_case(monkeypatch, 5)
    if case == "empty":
        args[2] = args[2][:0]
        kj, ji, tmask, perm = kj[:0], ji[:0], tmask[:0], perm[:0]
    else:
        tmask = torch.zeros_like(tmask)
    out, grads = _tri_run(lambda *a: tdt.dimenet_triplet_mp(
        *a, kj, ji, tmask, perm, R), args, wa)
    assert float(out.abs().max()) == 0.0
    assert all(float(g.abs().sum()) == 0.0 for g in grads)
    if case == "all_masked":
        from hydragnn_tpu.ops.dn_tri import dimenet_triplet_mp

        jout = dimenet_triplet_mp(
            *[jnp.asarray(a) for a in args],
            *[jnp.asarray(v.numpy()) for v in (kj, ji, tmask, perm)], R)
        np.testing.assert_allclose(np.asarray(jout), 0.0, atol=1e-6)


# --- the row-MLP tail (B12) -------------------------------------------------

H, DIN, NB, NA = 24, 16, 1, 2


def _mlp_case(seed=0, e=700):
    rng = np.random.RandomState(seed)
    wb = [(rng.randn(DIN, H) * 0.3).astype(np.float32), None]
    for _ in range(2 * NB + 1 + 2 * NA):
        wb.append((rng.randn(H, H) * 0.3).astype(np.float32))
        wb.append((rng.randn(H) * 0.1).astype(np.float32))
    ins = [rng.randn(e, DIN).astype(np.float32),
           rng.randn(e, H).astype(np.float32),
           rng.randn(e, H).astype(np.float32)]
    return ins, wb, rng.randn(e, H).astype(np.float32)


def _mlp_run(fn, ins, wb, wa):
    ti = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    tw = [None if w is None else torch.from_numpy(w).requires_grad_(True)
          for w in wb]
    out = fn(*ti, NB, NA, *tw)
    (out * torch.from_numpy(wa)).sum().backward()
    return out.detach(), [x.grad for x in ti], [
        None if w is None else w.grad for w in tw]


def test_row_mlp_matches_jax():
    """``dimenet_post_mlp`` (the Function over the plain versions) and the
    composed reference against the JAX op in interpret mode: forward 1e-5,
    every input, weight and bias gradient 1e-5 of its largest entry."""
    from hydragnn_tpu.ops.row_mlp import dimenet_post_mlp as j_post

    ins, wb, wa = _mlp_case(seed=1)
    live = [i for i, w in enumerate(wb) if w is not None]

    def jloss(tri, xji, xe, *lw):
        full = list(wb)
        for i, w in zip(live, lw):
            full[i] = w
        full = [None if w is None else jnp.asarray(w) for w in full]
        out = j_post(tri, xji, xe, NB, NA, *full)
        return jnp.sum(out * wa), out

    args = [jnp.asarray(a) for a in ins] + [jnp.asarray(wb[i]) for i in live]
    (_, jout), jg = jax.value_and_grad(
        jloss, argnums=tuple(range(len(args))), has_aux=True)(*args)
    trm.reset_launches()
    for fn in (trm.dimenet_post_mlp, trm.dimenet_post_mlp_reference):
        out, gi, gw = _mlp_run(fn, ins, wb, wa)
        _close(out, jout, "out")
        for name, g, w in zip(("tri", "x_ji", "x_edge"), gi, jg[:3]):
            _close(g, w, name)
        for i, w in zip(live, jg[3:]):
            _close(gw[i], w, f"wb[{i}]")
        assert gw[1] is None
    assert all(v == 0 for v in trm.LAUNCHES.values())


def test_row_mlp_backward_matches_autograd():
    """The hand-written backward (plain version) against autograd through
    the composed chain, 1e-5 of each gradient's largest entry."""
    ins, wb, wa = _mlp_case(seed=2, e=300)
    _, gi_k, gw_k = _mlp_run(trm.dimenet_post_mlp, ins, wb, wa)
    _, gi_r, gw_r = _mlp_run(trm.dimenet_post_mlp_reference, ins, wb, wa)
    for i, (a, b) in enumerate(zip(gi_k + gw_k, gi_r + gw_r)):
        if b is None:
            assert a is None
            continue
        _close(a, b, f"grad {i}")
    # the kernels' packing: weights [W_0 | W_1 ...], biases [L, H], row 0
    # zero; the flat wgrad unpacks back to the shapes
    tw = [None if w is None else torch.from_numpy(w) for w in wb]
    w, b = trm.pack_weights(tw, DIN, H, torch.device("cpu"))
    L = trm.n_dense(NB, NA)
    assert w.shape == (DIN * H + (L - 1) * H * H,) and b.shape == (L, H)
    assert float(b[0].abs().max()) == 0
    flat = torch.cat([w, b.reshape(-1)])
    dws, dbs = trm.unpack_wgrad(flat, DIN, H, NB, NA)
    for k in range(L):
        torch.testing.assert_close(dws[k], tw[2 * k])
        if k:
            torch.testing.assert_close(dbs[k], tw[2 * k + 1])
    assert dbs[0] is None


def test_double_backward_refused_and_widths_checked(monkeypatch):
    """create_graph through either Function raises, naming the force
    term's queue item; the kernels' width checks name their limits."""
    args, (kj, ji), tmask, perm, _ = _tri_case(monkeypatch, 13)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = tdt.dimenet_triplet_mp(*ts, kj, ji, tmask, perm, R)
    with pytest.raises(RuntimeError, match="not differentiable twice.*A3"):
        torch.autograd.grad(out.square().sum(), ts, create_graph=True)
    ins, wb, _ = _mlp_case(e=20)
    ti = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    out = trm.dimenet_post_mlp(*ti, NB, NA, *[
        None if w is None else torch.from_numpy(w) for w in wb])
    with pytest.raises(RuntimeError, match="not differentiable twice.*A3"):
        torch.autograd.grad(out.square().sum(), ti, create_graph=True)
    with pytest.raises(ValueError, match="S <= 8"):
        tdt.check_widths(9, 18, 8, 16)
    with pytest.raises(ValueError, match="S\\*R <= 64"):
        tdt.check_widths(7, 70, 8, 16)
    with pytest.raises(ValueError, match="H <= 128"):
        trm.check_widths(16, 129)


# --- the model --------------------------------------------------------------

def _cfgs(hidden=16, convs=2, num_radial=3, num_spherical=7, basis=8,
          int_emb=16, input_dim=1):
    kw = dict(model_type="DimeNet", input_dim=input_dim, hidden_dim=hidden,
              output_dim=(1,), output_type=("graph",),
              graph_head=jbase.GraphHeadCfg(1, 8, 1, (8,)), node_head=None,
              task_weights=(1.0,), num_conv_layers=convs, radius=1.3,
              max_neighbours=6, envelope_exponent=5, num_before_skip=1,
              num_after_skip=2, num_radial=num_radial,
              num_spherical=num_spherical, basis_emb_size=basis,
              int_emb_size=int_emb, out_emb_size=16)
    tkw = dict(kw)
    tkw["graph_head"] = tbase.GraphHeadCfg(
        *dataclasses.astuple(kw["graph_head"]))
    return jbase.ModelConfig(**kw), tbase.ModelConfig(**tkw)


def _model_run(jm, variables, tm, gj, gt):
    """Training-mode outputs and every parameter gradient of both models,
    the port's gradients read back as a flax tree."""
    rng = np.random.RandomState(1)
    probe = jm.apply(variables, gj, train=True)
    cts = [rng.randn(*np.shape(o)).astype(np.float32)
           * np.asarray(gj.graph_mask)[:, None] for o in probe]

    def jloss(params):
        outs = jm.apply({"params": params}, gj, train=True)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cts)), outs

    (_, jouts), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        variables["params"])
    tm.train()
    tm.zero_grad()
    outs = tm(gt)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cts)).backward()
    kept = [q.detach().clone() for q in tm.parameters()]
    with torch.no_grad():
        for q in tm.parameters():
            q.copy_(q.grad)
    got = flax_params_from_module(tm)
    with torch.no_grad():
        for q, k in zip(tm.parameters(), kept):
            q.copy_(k)
    return [o.detach().numpy() for o in outs], got, jouts, jgrads


@pytest.mark.parametrize("branch", ["composed", "tri_kernel",
                                    "tri_kernel_composed_tail",
                                    "tri_window"])
def test_dimenet_forward_and_grads_match_jax(branch, monkeypatch):
    """DIMEStack (hidden 16, 2 convs, S = 7, R = 3) with JAX weights:
    outputs and every parameter gradient within 1e-4 of JAX on each
    branch — composed under ``scatter``, the factored kernel and the row
    tail under ``fused`` (JAX's Pallas ops in interpret mode against the
    port's plain versions), the factored kernel with the composed tail
    under HYDRAGNN_DN_ROW_MLP_OFF, the edge-space window under
    HYDRAGNN_DIMENET_FUSED_TRI — and the tally names the branch."""
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND",
                       "scatter" if branch == "composed" else "fused")
    if branch == "tri_window":
        monkeypatch.setenv("HYDRAGNN_DIMENET_FUSED_TRI", "1")
    tail = branch == "tri_kernel"
    if branch == "tri_kernel_composed_tail":
        monkeypatch.setenv("HYDRAGNN_DN_ROW_MLP_OFF", "1")
        branch = "tri_kernel"
    gj, gt = _both(_raw(seed=8))
    jc, tc = _cfgs()
    jm = j_create_model(jc)
    variables = jax.tree.map(np.asarray, init_model(jm, gj, seed=0))
    tm = t_create_model(tc)
    load_flax_params(tm, variables["params"])
    assert tm.graph_convs[0].branch(gt.extras) == branch
    before = pipeline.dispatch_snapshot()
    outs, got, jouts, jgrads = _model_run(jm, variables, tm, gj, gt)
    delta = pipeline.dispatch_delta(before, pipeline.dispatch_snapshot())
    kernel = branch == "tri_kernel"
    assert delta["dn_tri:fused" if kernel else "dn_tri:scatter"] == 2
    assert delta.get("dn_row_mlp:fused", 0) == (2 if tail else 0)
    assert delta.get("dn_row_mlp:scatter", 0) == (2 if kernel and not tail
                                                   else 0)
    for t, j in zip(outs, jouts):
        np.testing.assert_allclose(t, np.asarray(j), **MODEL_TOL)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_allclose(flat_got[path], np.asarray(leaf),
                                   err_msg=jax.tree_util.keystr(path),
                                   **MODEL_TOL)


def test_port_branches_agree_and_params_round_trip(monkeypatch):
    """One set of weights on the port's composed and factored-kernel
    branches: the same outputs and gradients at 1e-4 (one checkpoint serves
    every branch); the flax tree round-trips through the module."""
    jc, tc = _cfgs(hidden=12, input_dim=3)
    res = {}
    for backend in ("scatter", "fused"):
        monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", backend)
        raw = _raw(seed=4)
        for r in raw:
            r["x"] = np.repeat(r["x"], 3, axis=1) * [1.0, 0.5, -1.0]
        gj, gt = _both(raw)
        tm = t_create_model(tc, seed=3)
        tree = flax_params_from_module(tm)
        load_flax_params(tm, tree)
        # the reference's width quirk: hidden = in_dim unless in_dim == 1
        assert tm.graph_convs[0].lin_in.weight.shape == (3, 3)
        out = tm(gt)[0]
        out.square().sum().backward()
        res[backend] = (out.detach(), [p.grad.clone()
                                       for p in tm.parameters()])
    torch.testing.assert_close(res["fused"][0], res["scatter"][0],
                               rtol=1e-4, atol=1e-4)
    for a, b in zip(res["fused"][1], res["scatter"][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_embedding_gathers_take_the_sorted_segment_backward(monkeypatch):
    """With collate's marker the embedding block's h[dst] and h[src] are
    the dense-backward gathers (their backward the sorted-segment sum,
    padding edges left out): the model's outputs and every parameter
    gradient equal those of the plain gathers (1e-5 of each one's largest
    entry); both gathers are taken once per conv."""
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", "fused")
    _, gt = _both(_raw(seed=9))
    assert "edge_perm_sender" in gt.extras
    _, tc = _cfgs(hidden=12, convs=2)
    calls = []
    dense_apply = tseg._GatherDenseBwd.apply

    def spy(*a):
        calls.append(a[2] is None)
        return dense_apply(*a)

    def run(plain):
        if plain:
            monkeypatch.setattr(tseg, "gather_receiver_sorted",
                                lambda x, g: x[g.receivers.long()])
            monkeypatch.setattr(tseg, "gather_sender",
                                lambda x, g: x[g.senders.long()])
        tm = t_create_model(tc, seed=5)
        tm.train()
        out = tm(gt)[0]
        (out * torch.linspace(-1.0, 1.0, out.numel()).reshape(out.shape)
         ).sum().backward()
        return out.detach(), [q.grad.clone() for q in tm.parameters()]

    monkeypatch.setattr(tseg._GatherDenseBwd, "apply", spy)
    got = run(False)
    # receivers: no permutation; senders: through it; once per conv
    assert sorted(calls) == [False, False, True, True]
    calls.clear()
    want = run(True)
    assert not calls
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    for a, b in zip(got[1], want[1]):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * max(scale, 1e-30)


def test_builder_width_raises_and_fallbacks_are_tallied(monkeypatch):
    """Past the factored gate but within one lane tile (S*R = 70) the
    reference takes the builder's dn_tri spec, and so does the port: the
    builder branch runs (tallied dn_tri_builder:fused) and gives finite
    outputs; past the builder too (int_emb_size 160), the composed path
    runs and the width-gate fallback is tallied.  The composed path's
    dispatch needs no marker.  HYDRAGNN_DIMENET_REMAT builds, and runs the
    same branches."""
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", "fused")
    _, gt = _both(_raw(seed=6))
    for remat in (False, True):
        if remat:
            monkeypatch.setenv("HYDRAGNN_DIMENET_REMAT", "1")
        _, tc = _cfgs(num_radial=10)
        tm = t_create_model(tc)
        assert all(c.remat is remat for c in tm.graph_convs)
        assert tm.graph_convs[0].branch(gt.extras) == "tri_builder"
        before = pipeline.dispatch_snapshot()
        out = tm(gt)[0]
        out.square().sum().backward()
        delta = pipeline.dispatch_delta(before, pipeline.dispatch_snapshot())
        assert torch.isfinite(out).all()
        # under REMAT the backward runs each conv's forward again
        assert delta["dn_tri_builder:fused"] == (4 if remat else 2)
        assert "dn_tri:scatter" not in delta and "dn_tri:fused" not in delta
        _, tc = _cfgs(int_emb=160)
        before = pipeline.dispatch_snapshot()
        with torch.no_grad():
            out = t_create_model(tc)(gt)[0]
        delta = pipeline.dispatch_delta(before, pipeline.dispatch_snapshot())
        assert torch.isfinite(out).all()
        assert delta["dn_tri_fallback:width_gate"] == 2
        assert delta["dn_tri:scatter"] == 2


def test_create_refuses_missing_dimenet_keys():
    """The reference's required keys (models/create.py:79-91)."""
    _, tc = _cfgs()
    for key in ("num_radial", "radius", "int_emb_size"):
        with pytest.raises(ValueError, match=f"DimeNet requires {key}"):
            t_create_model(dataclasses.replace(tc, **{key: None}))


# --- run_training and run_prediction ----------------------------------------

def test_dimenet_checkpoints_read_in_both_packages(monkeypatch, tmp_path):
    """A DimeNet ``.pk`` written by each package's ``run_training`` (the
    port's under ``fused``: the factored kernel and the row tail through
    their plain versions) is read by both ``run_prediction``s, which agree
    at 1e-4."""
    import hydragnn_tpu
    import hydragnn_torch
    from ci_data import generate_cached

    monkeypatch.setenv("HYDRAGNN_AUTO_PIPELINE", "0")
    monkeypatch.delenv("HYDRAGNN_AGGR_BACKEND", raising=False)
    monkeypatch.setattr(jax, "local_devices",
                        lambda *a, **k: jax.devices()[:1])
    name = "torch_port_dimenet_ckpt"
    generate_cached(name, f"dataset/{name}", 48)
    with open(os.path.join(REPO, "tests", "inputs", "ci.json")) as f:
        config = json.load(f)
    config["Dataset"].update(name=name, path={"total": f"dataset/{name}"},
                             compositional_stratified_splitting=False)
    config["NeuralNetwork"]["Architecture"].update(
        model_type="DimeNet", hidden_dim=8, num_conv_layers=2, radius=2.0,
        max_neighbours=20, int_emb_size=16, out_emb_size=16)
    config["NeuralNetwork"]["Training"].update(num_epoch=2, batch_size=16)
    tlogs, jlogs = str(tmp_path / "torch"), str(tmp_path / "jax")
    tconfig = copy.deepcopy(config)
    tconfig["NeuralNetwork"]["Architecture"]["aggregation_backend"] = "fused"
    before = pipeline.dispatch_snapshot()
    _, hist, _ = hydragnn_torch.run_training(tconfig, logs_dir=tlogs,
                                             device="cpu")
    delta = pipeline.dispatch_delta(before, pipeline.dispatch_snapshot())
    assert delta.get("dn_tri:fused", 0) > 0 and "dn_tri:scatter" not in delta
    assert delta.get("dn_row_mlp:fused", 0) > 0
    assert len(hist["train"]) == 2 and all(np.isfinite(hist["train"]))
    hydragnn_tpu.run_training(copy.deepcopy(config), logs_dir=jlogs)
    for logs in (tlogs, jlogs):
        got = hydragnn_torch.run_prediction(copy.deepcopy(config),
                                            logs_dir=logs, device="cpu")
        want = hydragnn_tpu.run_prediction(copy.deepcopy(config),
                                           logs_dir=logs)
        np.testing.assert_allclose(got[0], want[0], **MODEL_TOL)
        for t, j in zip(got[3], want[3]):
            np.testing.assert_allclose(t, np.asarray(j), **MODEL_TOL)
