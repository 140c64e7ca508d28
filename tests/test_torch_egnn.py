"""EGNN and its fused EGCL block in the PyTorch port against the JAX
reference (hydragnn_tpu/ops/egcl_mp.py over ops/fused_block.py,
hydragnn_tpu/models/egnn.py).

The reference runs its Pallas kernels in interpret mode on the CPU; the
port runs the plain versions of its three CUDA kernels (forward, pass P,
pass S).  Inputs as in tests/test_fused_block.py (F=16, H=24, collated
random molecules with a masked tail, |diff| < 1).  Tolerances: the block's
forward 1e-5; its gradients 3e-4, the JAX package's own egcl gradient
tolerance (tests/test_fused_block.py); the model 1e-4 of its largest
entry (forward, positions and every parameter gradient) and each parameter
gradient 1e-4 of its own largest entry.  Masked edges
give exactly zero ``dgeo`` in the port.

Also: the hand-written backward against autograd through the composed
plain version, the dispatch tally and the width gate, ``finalize`` for
the two configurations ``chip_smoke.py`` runs, rotation invariance, and a
port-written ``.pk`` read by both ``run_prediction``s.
"""

import copy
import dataclasses
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.graph import batch as jb
from hydragnn_tpu.graph.neighborlist import radius_graph
from hydragnn_tpu.models import base as jbase
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.models.create import init_model
from hydragnn_tpu.ops.egcl_mp import egcl_block as j_egcl
from hydragnn_torch.graph import batch as tb
from hydragnn_torch.models import base as tbase
from hydragnn_torch.models.create import create_model as t_create_model
from hydragnn_torch.ops import egcl_mp as tegcl
from hydragnn_torch.telemetry import pipeline
from hydragnn_torch.utils.weights import (
    flax_params_from_module,
    load_flax_params,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, H = 16, 24  # distinct widths catch f/h transpositions
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=3e-4, atol=3e-4)
NAMES = ("x", "geo", "w0", "b0", "w1", "b1", "wc0", "bc0", "wc1")


def _raw(n_graphs=6, nodes=9, seed=0, isolate=False, node_dim=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n_graphs):
        pos = rng.rand(nodes, 3).astype(np.float32) * 2.2
        if isolate and i == 0:
            pos[-2:] += 50.0  # two nodes with no incident edge
        x = rng.rand(nodes, 2).astype(np.float32)
        out.append(dict(
            x=x, pos=pos, edge_index=radius_graph(pos, 1.4, 8),
            graph_y=rng.rand(1).astype(np.float32),
            node_y=rng.rand(nodes, node_dim).astype(np.float32)
            if node_dim else x))
    return out


def _collate(raw, heads, pkg):
    ss = [pkg.GraphSample(**r) for r in raw]
    pad = pkg.PadSpec.for_batch(len(ss), max(s.num_nodes for s in ss),
                                max(s.num_edges for s in ss))
    return pkg.collate(ss, pad, [pkg.HeadSpec(*h) for h in heads])


def _inputs(g, seed, edge_attr_dim):
    rng = np.random.RandomState(seed)
    n, e = g.x.shape[0], g.senders.shape[0]
    return [rng.randn(n, F).astype(np.float32),
            (rng.rand(e, 4 + edge_attr_dim) * 0.8).astype(np.float32),
            (rng.randn(2 * F + 1 + edge_attr_dim, H) * 0.3).astype(np.float32),
            (rng.randn(H) * 0.1).astype(np.float32),
            (rng.randn(H, H) * 0.3).astype(np.float32),
            (rng.randn(H) * 0.1).astype(np.float32),
            (rng.randn(H, H) * 0.3).astype(np.float32),
            (rng.randn(H) * 0.1).astype(np.float32),
            (rng.randn(H, 1) * 0.5).astype(np.float32)]


def _ids(g):
    return (np.asarray(g.senders), np.asarray(g.receivers),
            np.asarray(g.extras["edge_perm_sender"]),
            np.asarray(g.edge_mask).astype(np.int32))


def _block_case(monkeypatch, seed, equivariant, edge_attr_dim, isolate):
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", "fused")
    g = _collate(_raw(seed=seed, isolate=isolate), [("e", "graph", 1)], jb)
    args = _inputs(g, seed + 1, edge_attr_dim)
    if not equivariant:
        args = args[:6]
    rng = np.random.RandomState(seed + 2)
    n = args[0].shape[0]
    return g, args, rng.randn(n, H).astype(np.float32), \
        rng.randn(n, 3).astype(np.float32)


@pytest.mark.parametrize("equivariant,edge_attr_dim,isolate", [
    (True, 0, False), (False, 0, False), (True, 2, True), (False, 2, False)],
    ids=["equivariant", "last-layer", "edge-attr-isolated",
         "last-layer-edge-attr"])
def test_reference_matches_jax_block(equivariant, edge_attr_dim, isolate,
                                     monkeypatch):
    """egcl_block_reference under autograd against the JAX op (interpret
    mode): forward 1e-5, every gradient 3e-4, dgeo exactly zero on masked
    edges; then the port's Function (forward, pass P and pass S as plain
    versions) against the same JAX numbers."""
    g, args, wa, wp = _block_case(monkeypatch, 3 + edge_attr_dim,
                                  equivariant, edge_attr_dim, isolate)
    s, r, p, em = _ids(g)

    def jloss(*a):
        full = list(a) + [None] * (9 - len(a))
        agg, psum = j_egcl(equivariant, *full[:2], jnp.asarray(em),
                           *full[2:], jnp.asarray(s), jnp.asarray(r),
                           jnp.asarray(p))
        out = jnp.sum(agg * wa)
        if equivariant:
            out = out + jnp.sum(psum[:, :3] * wp)
        return out, (agg, psum)

    (_, (jagg, jpsum)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(len(args))), has_aux=True))(
        *[jnp.asarray(a) for a in args])
    real = em != 0
    if isolate:
        deg = np.bincount(s[real], minlength=args[0].shape[0])
        assert (deg == 0).any()
    full = [None] * 9
    for fn in (tegcl.egcl_block_reference,
               lambda *a: tegcl.egcl_block(*a, torch.from_numpy(p))):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
        full[:len(ts)] = ts
        agg, psum = fn(equivariant, full[0], full[1], torch.from_numpy(em),
                       *full[2:], torch.from_numpy(s), torch.from_numpy(r))
        np.testing.assert_allclose(agg.detach().numpy(), np.asarray(jagg),
                                   **FWD_TOL)
        loss = (agg * torch.from_numpy(wa)).sum()
        if equivariant:
            np.testing.assert_allclose(psum.detach().numpy(),
                                       np.asarray(jpsum)[:, :3], **FWD_TOL)
            loss = loss + (psum * torch.from_numpy(wp)).sum()
        else:
            assert psum is None
        loss.backward()
        for name, t, w in zip(NAMES, ts, jgrads):
            got, want = t.grad.numpy(), np.asarray(w)
            if name == "geo":
                assert np.all(got[~real] == 0.0)
                got, want = got[real], want[real]
            np.testing.assert_allclose(got, want, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("equivariant", [True, False],
                         ids=["equivariant", "last-layer"])
def test_function_matches_reference_under_autograd(equivariant,
                                                   monkeypatch):
    """The hand-written backward (pass P and pass S, plain versions) against
    autograd through the composed reference at 1e-5 — the check
    chip_smoke.py makes on the card with the kernels in their place — and
    no kernel launches on the CPU.  Both instantiations: the equivariant
    block and the last layer's, which has no coordinate gate."""
    g, args, wa, wp = _block_case(monkeypatch, 11, equivariant, 3, False)
    s, r, p, em = (torch.from_numpy(a) for a in _ids(g))
    full = [None] * 9
    grads = []
    tegcl.reset_launches()
    for fn in (lambda *a: tegcl.egcl_block(*a, p),
               tegcl.egcl_block_reference):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
        full[:len(ts)] = ts
        agg, psum = fn(equivariant, full[0], full[1], em, *full[2:], s, r)
        loss = (agg * torch.from_numpy(wa)).sum()
        if equivariant:
            loss = loss + (psum * torch.from_numpy(wp)).sum()
        else:
            assert psum is None
        loss.backward()
        grads.append([t.grad for t in ts])
    for name, a, b in zip(NAMES, *grads):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, msg=name, rtol=1e-5, atol=1e-5)
    assert all(v == 0 for v in tegcl.LAUNCHES.values())


def test_grads_only_where_asked_and_no_double_backward(monkeypatch):
    """Layer 0 asks for no x and no geo gradient (both are data); the
    Function then skips them.  create_graph through it raises."""
    g, args, _, _ = _block_case(monkeypatch, 13, True, 0, False)
    s, r, p, em = (torch.from_numpy(a) for a in _ids(g))
    ts = [torch.from_numpy(a) for a in args]
    w1 = ts[4].requires_grad_(True)
    agg, psum = tegcl.egcl_block(True, ts[0], ts[1], em, ts[2], ts[3], w1,
                                 *ts[5:], s, r, p)
    (gw1,) = torch.autograd.grad(agg.square().sum() + psum.sum(), (w1,))
    assert gw1.shape == w1.shape and float(gw1.abs().max()) > 0
    x = ts[0].requires_grad_(True)
    agg, _ = tegcl.egcl_block(True, x, ts[1], em, *ts[2:], s, r, p)
    with pytest.raises(RuntimeError, match="not differentiable twice"):
        torch.autograd.grad(agg.square().sum(), (x,), create_graph=True)
    with pytest.raises(ValueError, match="H <= 128"):
        tegcl.check_widths(16, 136, 4)


# --- the model ----------------------------------------------------------------


def _cfgs(hidden=16, convs=3, equivariance=True, node_head=True,
          edge_dim=None):
    kw = dict(model_type="EGNN", input_dim=2, hidden_dim=hidden,
              output_dim=(1, 2) if node_head else (1,),
              output_type=("graph", "node") if node_head else ("graph",),
              graph_head=jbase.GraphHeadCfg(2, hidden, 2, (hidden, hidden)),
              node_head=jbase.NodeHeadCfg(2, (hidden, hidden), "mlp")
              if node_head else None,
              task_weights=(1.0, 10.0) if node_head else (1.0,),
              num_conv_layers=convs, radius=1.4, max_neighbours=8,
              equivariance=equivariance, edge_dim=edge_dim)
    tkw = dict(kw)
    tkw["graph_head"] = tbase.GraphHeadCfg(
        *dataclasses.astuple(kw["graph_head"]))
    if node_head:
        tkw["node_head"] = tbase.NodeHeadCfg(
            *dataclasses.astuple(kw["node_head"]))
    return jbase.ModelConfig(**kw), tbase.ModelConfig(**tkw)


def _models(monkeypatch, backend, seed=0, **kw):
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", backend)
    heads = [("energy", "graph", 1), ("x2", "node", 2)]
    raw = _raw(n_graphs=4, seed=seed, node_dim=2)
    gj, gt = _collate(raw, heads, jb), _collate(raw, heads, tb)
    jc, tc = _cfgs(**kw)
    jm = j_create_model(jc)
    variables = init_model(jm, gj, seed=0)
    tm = t_create_model(tc)
    load_flax_params(tm, variables["params"], variables.get("batch_stats"))
    return jm, variables, tm, gj, gt


@pytest.mark.parametrize("backend", ["scatter", "fused"])
def test_egnn_forward_positions_and_grads_match_jax(backend, monkeypatch):
    """H=16, 3 convs, equivariant (layers 0-1 move the positions that the
    next layer's geometry reads): every head output, every layer's
    positions and every parameter gradient — layers 0-1's coord_mlp
    included — within 1e-4 of the model's largest entry, and every
    parameter gradient within 1e-4 of its own largest entry."""
    jm, variables, tm, gj, gt = _models(monkeypatch, backend)
    assert ("edge_perm_sender" in gt.extras) == (backend == "fused")
    rng = np.random.RandomState(1)
    cts = [rng.randn(*o.shape).astype(np.float32)
           for o in jm.apply(variables, gj, train=False)]

    def jloss(params):
        out, inter = jm.apply({"params": params}, gj, train=False,
                              capture_intermediates=True,
                              mutable=["intermediates"])
        loss = sum(jnp.sum(o * c) for o, c in zip(out, cts))
        return loss, (out, inter["intermediates"])

    (_, (jout, inter)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(variables["params"])
    jpos = [np.asarray(inter[f"encoder_conv_{i}"]["__call__"][0][1])
            for i in range(3)]

    tpos = []
    hooks = [c.register_forward_hook(
        lambda m, i, o: tpos.append(o[1].detach().numpy()))
        for c in tm.graph_convs]
    before = pipeline.dispatch_snapshot()
    out = tm(gt)
    counts = pipeline.dispatch_delta(before, pipeline.dispatch_snapshot())
    for h in hooks:
        h.remove()
    assert counts.get("egcl:fused" if backend == "fused"
                      else "egcl:scatter") == 3
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, cts))
    loss.backward()

    def close(got, want, what):
        scale = max(float(np.abs(w).max()) for w in want)
        for k, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * scale,
                                       err_msg=f"{what} {k}")

    close([o.detach().numpy() for o in out], [np.asarray(o) for o in jout],
          "output")
    close(tpos, jpos, "positions of layer")
    assert np.abs(jpos[1] - np.asarray(gj.pos)).max() > 1e-6  # they moved
    with torch.no_grad():
        for q in tm.parameters():
            q.copy_(q.grad)
    got = dict(jax.tree_util.tree_leaves_with_path(
        flax_params_from_module(tm)))
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(got) == len(want)
    keys = [jax.tree_util.keystr(p) for p, _ in want]
    for i in (0, 1):
        for leaf in ("coord_mlp_0']['kernel", "coord_mlp_1']['kernel",
                     "edge_mlp_0']['kernel"):
            assert f"['encoder_conv_{i}']['{leaf}']" in keys
    assert not any("encoder_conv_2']['coord" in k for k in keys)
    scale = max(float(np.abs(np.asarray(w)).max()) for _, w in want)
    for path, w in want:
        w, key = np.asarray(w), jax.tree_util.keystr(path)
        np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-4 * scale,
                                   err_msg=key)
        # each leaf on its own scale too: layer 0's coord_mlp gradient is
        # orders below the model's largest entry, so a port that lost dgeo
        # (or the coordinate gate's backward) would pass the check above
        own = float(np.abs(w).max())
        np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-4 * own,
                                   err_msg=f"{key} on its own scale")
        if "coord_mlp" in key:
            assert own > 0 and float(np.abs(got[path]).max()) > 0, key


def test_egnn_edge_features_match_jax(monkeypatch):
    """edge_dim > 0: the edge attributes ride the geo lanes of the fused
    block; forward as the reference."""
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", "fused")
    heads = [("energy", "graph", 1)]
    raw = _raw(n_graphs=3, seed=4)
    rng = np.random.RandomState(5)
    for r in raw:
        r["edge_attr"] = rng.rand(r["edge_index"].shape[1], 2).astype(
            np.float32)
    gj, gt = _collate(raw, heads, jb), _collate(raw, heads, tb)
    jc, tc = _cfgs(convs=2, node_head=False, edge_dim=2)
    jm = j_create_model(jc)
    variables = init_model(jm, gj, seed=0)
    tm = t_create_model(tc)
    load_flax_params(tm, variables["params"])
    want = jm.apply(variables, gj, train=False)
    with torch.inference_mode():
        got = tm(gt)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-4)


def test_dispatch_tally_and_width_gate(monkeypatch):
    """egcl:fused with the marker; egcl:scatter (with a warning) past
    EGCL_H_LIMIT and under HYDRAGNN_EGCL_FUSED=0; egcl:scatter without a
    warning when nobody asked for the fused path."""
    from hydragnn_torch.models.egnn import _egcl_pipeline_enabled

    assert _egcl_pipeline_enabled(1, 128, 127)
    assert not _egcl_pipeline_enabled(1, 129, 4)
    assert not _egcl_pipeline_enabled(129, 16, 4)
    assert not _egcl_pipeline_enabled(16, 16, 128)

    def tally(backend, hidden=16, env=None):
        if env is None:
            monkeypatch.delenv("HYDRAGNN_EGCL_FUSED", raising=False)
        else:
            monkeypatch.setenv("HYDRAGNN_EGCL_FUSED", env)
        monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", backend)
        gt = _collate(_raw(n_graphs=2), [("energy", "graph", 1)], tb)
        tm = t_create_model(_cfgs(hidden=hidden, convs=2,
                                  node_head=False)[1])
        before = pipeline.dispatch_snapshot()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with torch.inference_mode():
                tm(gt)
        got = pipeline.dispatch_delta(before, pipeline.dispatch_snapshot())
        egcl = {k: v for k, v in got.items() if k.startswith("egcl:")}
        return egcl, [str(w.message) for w in caught
                      if "fused EGCL block is off" in str(w.message)]

    assert tally("fused") == ({"egcl:fused": 2}, [])
    counts, warned = tally("fused", hidden=136)
    assert counts == {"egcl:scatter": 2} and "H=136" in warned[0]
    counts, warned = tally("fused", env="0")
    assert counts == {"egcl:scatter": 2} and warned
    assert tally("scatter") == ({"egcl:scatter": 2}, [])


def test_position_gathers_take_the_sorted_segment_backward(monkeypatch):
    """With the marker, every layer gathers the positions at the senders
    and receivers through the gathers whose backward is the sorted-segment
    kernel (two such backwards a layer, the positions needing a gradient
    at every layer here); against the same model with plain gathers, the
    forward and the gradients of every parameter, of x and of the real
    nodes' positions agree to 1e-5 of each one's largest entry."""
    from hydragnn_torch.graph import segment

    _, _, tm, _, gt = _models(monkeypatch, "fused")
    assert "edge_perm_sender" in gt.extras
    x = gt.x.clone().requires_grad_(True)
    pos = gt.pos.clone().requires_grad_(True)
    g = dataclasses.replace(gt, x=x, pos=pos)
    rng = np.random.RandomState(4)
    real = gt.node_mask != 0

    def run():
        out = tm(g)
        loss = sum((o * torch.from_numpy(
            rng.randn(*o.shape).astype(np.float32))).sum() for o in out)
        grads = torch.autograd.grad(loss, [x, pos] + list(tm.parameters()))
        return ([o.detach() for o in out], grads[0], grads[1][real],
                grads[2:])

    backwards = []
    kernel_bwd = segment._GatherDenseBwd.backward

    def counted(ctx, grad):
        backwards.append(tuple(ctx.shape))
        return kernel_bwd(ctx, grad)

    monkeypatch.setattr(segment._GatherDenseBwd, "backward",
                        staticmethod(counted))
    got = run()
    assert backwards.count(tuple(pos.shape)) == 2 * len(tm.graph_convs)
    monkeypatch.setattr(segment._GatherDenseBwd, "apply", staticmethod(
        lambda x_, idx, perm, valid: x_[idx.long()]))
    rng = np.random.RandomState(4)
    want = run()
    for a, b in zip(got[0] + [got[1], got[2]] + list(got[3]),
                    want[0] + [want[1], want[2]] + list(want[3])):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * scale


def test_energy_invariant_under_rotation(monkeypatch):
    """The graph output does not move under a rotation of every position
    (1e-5 relative); the fused path."""
    heads = [("energy", "graph", 1), ("x2", "node", 2)]
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", "fused")
    _, tc = _cfgs()
    tm = t_create_model(tc, seed=3)
    raw = _raw(n_graphs=4, seed=6, node_dim=2)
    q, _ = np.linalg.qr(np.random.RandomState(7).randn(3, 3))
    rot = [dict(r, pos=(r["pos"] @ q.T).astype(np.float32)) for r in raw]
    with torch.inference_mode():
        e0 = tm(_collate(raw, heads, tb))[0].numpy()
        e1 = tm(_collate(rot, heads, tb))[0].numpy()
    np.testing.assert_allclose(e1, e0, rtol=1e-5,
                               atol=1e-5 * float(np.abs(e0).max()))


def test_smoke_lockstep_yardstick_takes_the_composed_path(monkeypatch):
    """``chip_smoke.lockstep`` with the CPU standing in for the card, on
    EGNN under ``fused``: the float32 runs go through the Function
    (``egcl:fused``), the float64 yardstick through the composed path
    (``egcl:scatter``), so it shares no code with the hand-written
    backward; a faithful copy passes on every parameter's own scale."""
    import chip_smoke

    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", "fused")
    _, tc = _cfgs()
    heads = [("energy", "graph", 1), ("x2", "node", 2)]
    gt = _collate(_raw(n_graphs=4, seed=8, node_dim=2), heads, tb)
    assert "edge_perm_sender" in gt.extras
    assert "edge_perm_sender" not in chip_smoke.as_double(gt).extras
    before = pipeline.dispatch_snapshot()
    out = chip_smoke.lockstep(torch, tc, [gt], 0, torch.device("cpu"))
    counts = pipeline.dispatch_delta(before, pipeline.dispatch_snapshot())
    convs = tc.num_conv_layers
    # float32: the CPU's and the card's gradients, then the CPU's step
    assert counts.get("egcl:fused") == 3 * convs
    assert counts.get("egcl:scatter") == convs
    assert out["loss"] == 0.0 and out["grad_over_largest"] == 0.0
    assert out["card_vs_float64_over_own_largest"] \
        <= out["card_vs_float64_allowed"]


@pytest.mark.parametrize("which", ["egnn_md17", "egnn_oc22"])
def test_finalize_parity_for_the_chip_configurations(which):
    from chip_smoke import egnn_md17_config, egnn_oc22_config
    from hydragnn_tpu.config import config as jcfg
    from hydragnn_torch.config import config as tcfg

    rng = np.random.RandomState(0)
    samples = [jb.GraphSample(x=rng.rand(n, 3), pos=rng.rand(n, 3),
                              edge_index=np.stack([rng.randint(0, n, 9),
                                                   rng.randint(0, n, 9)]))
               for n in (4, 6, 5)]
    config = {"egnn_md17": egnn_md17_config,
              "egnn_oc22": egnn_oc22_config}[which]()
    want = jcfg.finalize(copy.deepcopy(config),
                         jcfg.DatasetStats.from_samples(samples))
    got = tcfg.finalize(copy.deepcopy(config),
                        tcfg.DatasetStats.from_samples(samples))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    cfg = tbase.ModelConfig.from_config(got)
    assert cfg.model_type == "EGNN" and cfg.equivariance
    assert cfg.hidden_dim == (48 if which == "egnn_md17" else 32)
    names = got["NeuralNetwork"]["Variables_of_interest"]["output_names"]
    assert "total_energy" not in names and "atomic_forces" not in names


def test_port_checkpoint_read_by_both_packages(monkeypatch, tmp_path):
    """An EGNN ``.pk`` written by the port's ``run_training`` (fused: the
    Function over the plain kernel versions) is read by both
    ``run_prediction``s, which agree at 1e-4."""
    import hydragnn_tpu
    import hydragnn_torch
    from ci_data import generate_cached

    monkeypatch.setenv("HYDRAGNN_AUTO_PIPELINE", "0")
    monkeypatch.delenv("HYDRAGNN_AGGR_BACKEND", raising=False)
    monkeypatch.setattr(jax, "local_devices",
                        lambda *a, **k: jax.devices()[:1])
    name = "torch_port_egnn_ckpt"
    generate_cached(name, f"dataset/{name}", 64)
    with open(os.path.join(REPO, "tests", "inputs", "ci.json")) as f:
        config = json.load(f)
    ds = config["Dataset"]
    ds.update(name=name, path={"total": f"dataset/{name}"},
              compositional_stratified_splitting=False)
    config["NeuralNetwork"]["Architecture"].update(
        model_type="EGNN", hidden_dim=8, num_conv_layers=2, radius=2.0,
        max_neighbours=20, equivariance=True)
    config["NeuralNetwork"]["Training"].update(num_epoch=2, batch_size=16)
    tconfig = copy.deepcopy(config)
    tconfig["NeuralNetwork"]["Architecture"]["aggregation_backend"] = "fused"
    logs = str(tmp_path / "torch")
    _, hist, _ = hydragnn_torch.run_training(tconfig, logs_dir=logs,
                                             device="cpu")
    assert len(hist["train"]) == 2 and all(np.isfinite(hist["train"]))
    got = hydragnn_torch.run_prediction(copy.deepcopy(config), logs_dir=logs,
                                        device="cpu")
    want = hydragnn_tpu.run_prediction(copy.deepcopy(config), logs_dir=logs)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    for t, j in zip(got[3], want[3]):
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-4, atol=1e-4)
