"""CGCNN and its fused gated sum in the PyTorch port against the JAX
reference (hydragnn_tpu/ops/cgcnn_mp.py over ops/fused_block.py,
hydragnn_tpu/models/cgcnn.py).

The reference runs its Pallas kernels in interpret mode on the CPU; the
port runs the plain versions of its three CUDA kernels (forward, pass P,
pass S).  Inputs as in tests/test_fused_block.py (collated random
molecules with a masked tail; F = 24, A = 5, D = 16, distinct widths that
catch transposed blocks, and the no-edge-attribute case).  Tolerances: the
op's forward 1e-5; its gradients 3e-4, the JAX package's own cgcnn
gradient tolerance; the model 1e-4 (forward, every parameter gradient,
the updated running statistics).  Masked edges give exactly zero
``d edge_attr`` in the port.

Also: the hand-written backward against autograd through the composed
plain version, the double-backward refusal, the dispatch tally, the
``HYDRAGNN_CGCNN_FUSED`` override and the width gate, the conv-node-head
refusal, and a port-written ``.pk`` read by both ``run_prediction``s.
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
from hydragnn_tpu.ops.cgcnn_mp import cgcnn_gated_block as j_cgcnn
from hydragnn_torch.graph import batch as tb
from hydragnn_torch.models import base as tbase
from hydragnn_torch.models.create import create_model as t_create_model
from hydragnn_torch.ops import cgcnn_mp as tcg
from hydragnn_torch.telemetry import pipeline
from hydragnn_torch.utils.weights import load_flax_params
from test_torch_archs import _train_eval_and_grads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=3e-4, atol=3e-4)
NAMES = ("x", "edge_attr", "kf", "bf", "ks", "bs")


def _raw(n_graphs=8, seed=0, node_dim=2, max_nodes=14):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_graphs):
        n = int(rng.randint(3, max_nodes + 1))
        pos = rng.rand(n, 3).astype(np.float32) * 2.5
        x = rng.rand(n, node_dim).astype(np.float32)
        out.append(dict(x=x, pos=pos, edge_index=radius_graph(pos, 1.4, 10),
                        graph_y=rng.rand(1).astype(np.float32), node_y=x))
    return out


def _collate(raw, heads, pkg):
    ss = [pkg.GraphSample(**r) for r in raw]
    pad = pkg.PadSpec.for_batch(len(ss), max(s.num_nodes for s in ss),
                                max(s.num_edges for s in ss) + 7)
    return pkg.collate(ss, pad, [pkg.HeadSpec(*h) for h in heads])


def _ids(g):
    return (np.asarray(g.senders), np.asarray(g.receivers),
            np.asarray(g.extras["edge_perm_sender"]),
            np.asarray(g.edge_mask).astype(np.int32))


def _op_case(monkeypatch, seed, f, a, d):
    """The batch, the op inputs ``[x, edge_attr or None, kf, bf, ks, bs]``
    and a cotangent, as tests/test_fused_block.py draws them."""
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", "fused")
    g = _collate(_raw(seed=seed), [("e", "graph", 1)], jb)
    rng = np.random.RandomState(seed + 1)
    n, e = g.x.shape[0], g.senders.shape[0]
    args = [(rng.randn(n, f) * 0.5).astype(np.float32),
            (rng.randn(e, a) * 0.5).astype(np.float32) if a else None,
            (rng.randn(2 * f + a, d) * 0.3).astype(np.float32),
            (rng.randn(d) * 0.1).astype(np.float32),
            (rng.randn(2 * f + a, d) * 0.3).astype(np.float32),
            (rng.randn(d) * 0.1).astype(np.float32)]
    return g, args, rng.randn(n, d).astype(np.float32)


def _run(fn, args, em, s, r, wa):
    """Forward and every gradient of ``sum(fn(...) * wa)``."""
    ts = [None if v is None else torch.from_numpy(v).requires_grad_(True)
          for v in args]
    out = fn(ts[0], ts[1], em, *ts[2:], s, r)
    (out * torch.from_numpy(wa)).sum().backward()
    return out.detach(), [None if t is None else t.grad for t in ts]


@pytest.mark.parametrize("f,a,d", [(24, 5, 16), (16, 0, 16)],
                         ids=["edge-attr", "no-edge-attr"])
def test_op_matches_jax(f, a, d, monkeypatch):
    """``cgcnn_block_reference`` under autograd and the port's Function
    (forward, pass P and pass S as plain versions) against the JAX op in
    interpret mode: forward 1e-5, all six gradients 3e-4; ``d edge_attr``
    exactly zero on masked edges."""
    g, args, wa = _op_case(monkeypatch, 21 + a, f, a, d)
    s, r, p, em = _ids(g)
    jargs = [None if v is None else jnp.asarray(v) for v in args]
    argnums = tuple(i for i, v in enumerate(args) if v is not None)

    def jloss(*live):
        full = list(jargs)
        for i, v in zip(argnums, live):
            full[i] = v
        out = j_cgcnn(full[0], full[1], jnp.asarray(em), *full[2:],
                      jnp.asarray(s), jnp.asarray(r), jnp.asarray(p))
        return jnp.sum(out * wa), out

    (_, jout), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(len(argnums))), has_aux=True)(
        *[jargs[i] for i in argnums])
    jgrads = dict(zip(argnums, jgrads))
    real = em != 0
    assert (~real).any()
    st, rt, pt, emt = (torch.from_numpy(v) for v in (s, r, p, em))
    for fn in (tcg.cgcnn_block_reference,
               lambda *a_: tcg.cgcnn_gated_block(*a_, pt)):
        out, grads = _run(fn, args, emt, st, rt, wa)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FWD_TOL)
        for i, (name, got) in enumerate(zip(NAMES, grads)):
            if args[i] is None:
                assert got is None
                continue
            got, want = got.numpy(), np.asarray(jgrads[i])
            if name == "edge_attr":
                assert np.all(got[~real] == 0.0)
                got, want = got[real], want[real]
            np.testing.assert_allclose(got, want, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("a", [3, 0], ids=["edge-attr", "no-edge-attr"])
def test_plain_passes_match_reference_under_autograd(a, monkeypatch):
    """The hand-written backward (pass P and pass S, plain versions)
    against autograd through the composed reference at 1e-5 — the check
    chip_smoke.py makes on the card with the kernels in their place — and
    no kernel launches on the CPU."""
    g, args, wa = _op_case(monkeypatch, 31, 12, a, 20)
    st, rt, pt, emt = (torch.from_numpy(v) for v in _ids(g))
    tcg.reset_launches()
    _, gk = _run(lambda *a_: tcg.cgcnn_gated_block(*a_, pt), args, emt, st,
                 rt, wa)
    _, gr = _run(tcg.cgcnn_block_reference, args, emt, st, rt, wa)
    for name, x_, y_ in zip(NAMES, gk, gr):
        if x_ is None:
            assert y_ is None
            continue
        assert x_.dtype == torch.float32
        torch.testing.assert_close(x_, y_, msg=name, rtol=1e-5, atol=1e-5)
    assert all(v == 0 for v in tcg.LAUNCHES.values())
    # pass P and pass S add up to the whole backward: each on its own
    ts = [None if v is None else torch.from_numpy(v) for v in args]
    ct = torch.from_numpy(wa)
    dkf, dbf, dks, dbs, dea, dx_r = tcg.cgcnn_pass_p_plain(
        ts[0], ts[1], emt, *ts[2:], st, rt, ct)
    dx_s = tcg.cgcnn_pass_s_plain(ts[0], ts[1], emt, *ts[2:], st, rt, ct)
    torch.testing.assert_close(dx_r + dx_s, gr[0], rtol=1e-5, atol=1e-5)
    assert float(dx_r.abs().max()) > 0 and float(dx_s.abs().max()) > 0
    for got, want in ((dkf, gr[2]), (dbf, gr[3]), (dks, gr[4]),
                      (dbs, gr[5])):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert (dea is None) == (a == 0)


def test_grads_only_where_asked_and_no_double_backward(monkeypatch):
    """Layer 0 asks for no x gradient (x is data): the Function skips it.
    create_graph through it raises, naming the force term's queue item."""
    g, args, wa = _op_case(monkeypatch, 41, 8, 0, 8)
    st, rt, pt, emt = (torch.from_numpy(v) for v in _ids(g))
    ts = [None if v is None else torch.from_numpy(v) for v in args]
    kf = ts[2].requires_grad_(True)
    out = tcg.cgcnn_gated_block(ts[0], None, emt, kf, *ts[3:], st, rt, pt)
    (gk,) = torch.autograd.grad(out.square().sum(), (kf,))
    assert gk.shape == kf.shape and float(gk.abs().max()) > 0
    x = ts[0].requires_grad_(True)
    out = tcg.cgcnn_gated_block(x, None, emt, *ts[2:], st, rt, pt)
    with pytest.raises(RuntimeError, match="not differentiable twice.*A3"):
        torch.autograd.grad(out.square().sum(), (x,), create_graph=True)
    with pytest.raises(ValueError, match="A <= 127"):
        tcg.check_widths(16, 16, 128)
    with pytest.raises(ValueError, match="F <= 256"):
        tcg.check_widths(257, 16, 0)


# --- the model ----------------------------------------------------------------


def _cfgs(dim=6, convs=3, edge_dim=0, node_head=None):
    kw = dict(model_type="CGCNN", input_dim=dim, hidden_dim=dim,
              output_dim=(1,), output_type=("graph",),
              graph_head=jbase.GraphHeadCfg(2, 10, 2, (10, 8)),
              node_head=None, task_weights=(1.0,), num_conv_layers=convs,
              edge_dim=edge_dim, radius=1.4, max_neighbours=10)
    if node_head is not None:
        kw.update(output_dim=(1, 2), output_type=("graph", "node"),
                  task_weights=(1.0, 1.0), node_head=node_head)
    tkw = dict(kw)
    tkw["graph_head"] = tbase.GraphHeadCfg(
        *dataclasses.astuple(kw["graph_head"]))
    if node_head is not None:
        tkw["node_head"] = tbase.NodeHeadCfg(*dataclasses.astuple(node_head))
    return jbase.ModelConfig(**kw), tbase.ModelConfig(**tkw)


@pytest.mark.parametrize("backend", ["scatter", "fused"])
def test_cgcnn_forward_grads_and_stats_match_jax(backend, monkeypatch):
    """F = 6, 2 convs, the residual ``x + agg`` and a BatchNorm after each
    conv: the training-mode forward, every parameter gradient, the
    updated running statistics and the eval forward within 1e-4 of JAX
    (``test_torch_archs._train_eval_and_grads``).  ``fused``: every conv
    through the gated-sum Function (``cgcnn:fused``) against the JAX
    Pallas op; ``scatter``: the composed path on both sides."""
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", backend)
    raw = _raw(n_graphs=4, seed=3, node_dim=6)
    heads = [("energy", "graph", 1)]
    gj, gt = _collate(raw, heads, jb), _collate(raw, heads, tb)
    assert ("edge_perm_sender" in gt.extras) == (backend == "fused")
    jc, tc = _cfgs(convs=2)
    jm = j_create_model(jc)
    variables = jax.tree.map(np.asarray, init_model(jm, gj, seed=0))
    assert set(variables["params"]["encoder_conv_0"]) == {"lin_f", "lin_s"}
    tm = t_create_model(tc)
    load_flax_params(tm, variables["params"], variables["batch_stats"])
    before = pipeline.dispatch_snapshot()
    _train_eval_and_grads(jm, variables, tm, gj, gt)
    delta = pipeline.dispatch_delta(before, pipeline.dispatch_snapshot())
    label = "fused" if backend == "fused" else "scatter"
    # two conv layers, one training and one eval forward
    assert delta == {f"cgcnn:{label}": 4, f"mean_pool:{label}": 2} | (
        {} if backend == "fused" else {"scatter_sum:scatter": 4})


def test_cgcnn_edge_features_match_jax(monkeypatch):
    """edge_dim > 0: the edge attributes ride the kernel's third weight
    block; forward (eval mode) as the reference."""
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", "fused")
    heads = [("energy", "graph", 1)]
    raw = _raw(n_graphs=4, seed=4, node_dim=5)
    rng = np.random.RandomState(5)
    for r in raw:
        r["edge_attr"] = rng.rand(r["edge_index"].shape[1], 3).astype(
            np.float32)
    gj, gt = _collate(raw, heads, jb), _collate(raw, heads, tb)
    jc, tc = _cfgs(dim=5, convs=2, edge_dim=3)
    jm = j_create_model(jc)
    variables = init_model(jm, gj, seed=0)
    tm = t_create_model(tc).eval()
    load_flax_params(tm, variables["params"], variables["batch_stats"])
    want = jm.apply(variables, gj, train=False)
    before = pipeline.dispatch_snapshot()
    with torch.inference_mode():
        got = tm(gt)
    delta = pipeline.dispatch_delta(before, pipeline.dispatch_snapshot())
    assert delta["cgcnn:fused"] == 2
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-4)


def test_dispatch_tally_override_and_width_gate(monkeypatch):
    """cgcnn:fused with the marker; cgcnn:scatter (with a warning naming
    the reason) without it under the fused backend, under
    HYDRAGNN_CGCNN_FUSED=0 and past CGCNN_F_LIMIT; cgcnn:scatter without a
    warning when nobody asked for the fused path."""
    from hydragnn_torch.models.cgcnn import _cgcnn_pipeline_enabled

    assert _cgcnn_pipeline_enabled(256, 127)
    assert not _cgcnn_pipeline_enabled(257, 0)
    assert not _cgcnn_pipeline_enabled(16, 128)

    def tally(backend, env=None, marker=True, limit=None):
        if env is None:
            monkeypatch.delenv("HYDRAGNN_CGCNN_FUSED", raising=False)
        else:
            monkeypatch.setenv("HYDRAGNN_CGCNN_FUSED", env)
        if limit is not None:
            monkeypatch.setattr("hydragnn_torch.models.cgcnn.CGCNN_F_LIMIT",
                                limit)
        monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", backend)
        gt = _collate(_raw(n_graphs=2, node_dim=4), [("e", "graph", 1)], tb)
        if not marker:
            gt = dataclasses.replace(gt, extras={})
        tm = t_create_model(_cfgs(dim=4, convs=2)[1]).eval()
        before = pipeline.dispatch_snapshot()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with torch.inference_mode():
                tm(gt)
        got = pipeline.dispatch_delta(before, pipeline.dispatch_snapshot())
        cg = {k: v for k, v in got.items() if k.startswith("cgcnn:")}
        return cg, [str(w.message) for w in caught
                    if "fused gated-sum block is off" in str(w.message)]

    assert tally("fused") == ({"cgcnn:fused": 2}, [])
    counts, warned = tally("fused", marker=False)
    assert counts == {"cgcnn:scatter": 2} and "no_sender_perm" in warned[0]
    counts, warned = tally("fused", env="0")
    assert counts == {"cgcnn:scatter": 2} and "width_gate" in warned[0]
    counts, warned = tally("fused", limit=3)
    assert counts == {"cgcnn:scatter": 2} and "dim=4" in warned[0]
    assert tally("scatter") == ({"cgcnn:scatter": 2}, [])


def test_conv_node_head_refused():
    """The reference refuses a conv-type node head for CGCNN (create time),
    with the same message; an mlp node head builds."""
    from hydragnn_tpu.models.create import create_model as jcreate

    head = jbase.NodeHeadCfg(2, (6, 6), "conv")
    jc, tc = _cfgs(node_head=head)
    with pytest.raises(ValueError) as want:
        jcreate(jc)
    with pytest.raises(ValueError) as got:
        t_create_model(tc)
    assert str(got.value) == str(want.value)
    _, tc = _cfgs(node_head=jbase.NodeHeadCfg(2, (6, 6), "mlp"))
    assert t_create_model(tc).cfg.model_type == "CGCNN"


def test_port_checkpoint_read_by_both_packages(monkeypatch, tmp_path):
    """A CGCNN ``.pk`` written by the port's ``run_training`` (fused: the
    Function over the plain kernel versions) is read by both
    ``run_prediction``s, which agree at 1e-4."""
    import hydragnn_tpu
    import hydragnn_torch
    from ci_data import generate_cached

    monkeypatch.setenv("HYDRAGNN_AUTO_PIPELINE", "0")
    monkeypatch.delenv("HYDRAGNN_AGGR_BACKEND", raising=False)
    monkeypatch.setattr(jax, "local_devices",
                        lambda *a, **k: jax.devices()[:1])
    name = "torch_port_cgcnn_ckpt"
    generate_cached(name, f"dataset/{name}", 64)
    with open(os.path.join(REPO, "tests", "inputs", "ci.json")) as f:
        config = json.load(f)
    ds = config["Dataset"]
    ds.update(name=name, path={"total": f"dataset/{name}"},
              compositional_stratified_splitting=False)
    config["NeuralNetwork"]["Architecture"].update(
        model_type="CGCNN", hidden_dim=8, num_conv_layers=2, radius=2.0,
        max_neighbours=20)
    config["NeuralNetwork"]["Training"].update(num_epoch=2, batch_size=16)
    tconfig = copy.deepcopy(config)
    tconfig["NeuralNetwork"]["Architecture"]["aggregation_backend"] = "fused"
    logs = str(tmp_path / "torch")
    before = pipeline.dispatch_snapshot()
    _, hist, _ = hydragnn_torch.run_training(tconfig, logs_dir=logs,
                                             device="cpu")
    delta = pipeline.dispatch_delta(before, pipeline.dispatch_snapshot())
    assert delta.get("cgcnn:fused", 0) > 0 and "cgcnn:scatter" not in delta
    assert len(hist["train"]) == 2 and all(np.isfinite(hist["train"]))
    got = hydragnn_torch.run_prediction(copy.deepcopy(config), logs_dir=logs,
                                        device="cpu")
    want = hydragnn_tpu.run_prediction(copy.deepcopy(config), logs_dir=logs)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    for t, j in zip(got[3], want[3]):
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-4, atol=1e-4)
