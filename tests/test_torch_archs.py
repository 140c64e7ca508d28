"""GIN, SAGE, MFC and PNA in the PyTorch port against the JAX reference.

Weights and BatchNorm statistics come from a JAX ``init`` and are carried
into the port with ``load_flax_params``; the same padded batch goes through
both models under the ``scatter`` and the ``fused`` backend (the JAX side
then runs its Pallas ops in interpret mode, the port its plain kernel
versions).  Held at 1e-4 (model level, float32): the forward in training
mode, every parameter gradient, the running statistics that forward
updated, and the forward in eval mode on those statistics.

Also: ``MaskedBatchNorm`` alone (1e-6, a one-row mask included); the
conv-type node head at ``tests/inputs/ci_conv_head.json``'s shape and the
PNA multihead of ``ci_multihead.json``; ``train_validate_test`` from one
init for PNA (per-epoch losses 1e-4, identical decisions); a PNA ``.pk``
written by each package read by both ``run_prediction``s; the weight round
trip through ``tools/port_weights.port_state_dict``; and the last two
architectures to be ported, which build.
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

from hydragnn_tpu.models import base as jbase
from hydragnn_tpu.models import layers as jlayers
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.models.create import init_model
from hydragnn_torch.models import base as tbase
from hydragnn_torch.models import layers as tlayers
from hydragnn_torch.models.create import create_model as t_create_model
from hydragnn_torch.telemetry import pipeline
from hydragnn_torch.utils.weights import (
    flax_batch_stats_from_module,
    flax_params_from_module,
    load_flax_params,
)
from test_torch_schnet import _batches, _samples
from tools.port_weights import port_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("GIN", "SAGE", "MFC", "PNA")


def _cfgs(model_type, hidden=16, node_head=None, n_node_heads=0,
          graph_head=True):
    out_dim, out_type, weights = [], [], []
    if graph_head:
        out_dim, out_type, weights = [1], ["graph"], [1.0]
    for i in range(n_node_heads):
        out_dim.append(2)
        out_type.append("node")
        weights.append(0.5 + i)
    kw = dict(
        model_type=model_type, input_dim=1, hidden_dim=hidden,
        output_dim=tuple(out_dim), output_type=tuple(out_type),
        graph_head=(jbase.GraphHeadCfg(2, hidden, 2, (hidden, 12))
                    if graph_head else None),
        node_head=node_head, task_weights=tuple(weights), num_conv_layers=2,
        max_degree=6, max_neighbours=6, num_nodes=12,
        pna_avg_deg_log=1.1, pna_avg_deg_lin=3.0)
    jc = jbase.ModelConfig(**kw)
    tkw = dict(kw)
    if graph_head:
        tkw["graph_head"] = tbase.GraphHeadCfg(
            *dataclasses.astuple(kw["graph_head"]))
    if node_head is not None:
        tkw["node_head"] = tbase.NodeHeadCfg(*dataclasses.astuple(node_head))
    return jc, tbase.ModelConfig(**tkw)


def _both(model_type, monkeypatch, backend, **kw):
    """JAX model + variables, the port's model with them loaded, and the
    same batch collated by both packages."""
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", backend)
    n_node = kw.get("n_node_heads", 0)
    heads = ([("energy", "graph", 1)] if kw.get("graph_head", True) else [])
    heads += [(f"n{i}", "node", 2) for i in range(n_node)]
    raw = _samples(1.6, 10, 12, n_graphs=5, seed=3,
                   node_dim=2 * n_node if n_node else 0)
    gj, gt = _batches(raw, heads)
    jc, tc = _cfgs(model_type, **kw)
    jm = j_create_model(jc)
    variables = jax.tree.map(np.asarray, init_model(jm, gj, seed=0))
    tm = t_create_model(tc)
    load_flax_params(tm, variables["params"], variables.get("batch_stats"))
    return jm, variables, tm, gj, gt


def _assert_tree_close(got, want, tol=TOL):
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_allclose(
            flat_got[path], np.asarray(leaf),
            err_msg=jax.tree_util.keystr(path), **tol)


def _assert_grads_close(got, want, scaled):
    """Elementwise at 1e-4; ``scaled`` holds each leaf to 1e-4 of its own
    largest entry instead (the deep conv-head stacks: five BatchNorms'
    mean subtractions cancel float32 sums taken in another order)."""
    if not scaled:
        return _assert_tree_close(got, want)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        leaf = np.asarray(leaf)
        err = float(np.abs(flat_got[path] - leaf).max())
        assert err <= 1e-4 * max(float(np.abs(leaf).max()), 1.0), (
            jax.tree_util.keystr(path), err)


def _train_eval_and_grads(jm, variables, tm, gj, gt, scaled_grads=False):
    """Training-mode forward + every parameter gradient + the updated
    running statistics, then the eval-mode forward on them."""
    rng = np.random.RandomState(1)
    probe = jm.apply(variables, gj, train=False)
    cts = [rng.randn(*np.shape(o)).astype(np.float32) for o in probe]
    masks = [np.asarray(gj.graph_mask if t == "graph" else gj.node_mask)
             for t in jm.cfg.output_type]
    cts = [c * m[:, None] for c, m in zip(cts, masks)]  # real rows only

    def jloss(params):
        outs, new = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, gj,
            train=True, mutable=["batch_stats"])
        return sum(jnp.sum(o * c) for o, c in zip(outs, cts)), (outs, new)

    (jl, (jouts, jnew)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        variables["params"])
    tm.train()
    outs = tm(gt)
    for t, j, m in zip(outs, jouts, masks):
        np.testing.assert_allclose(t.detach().numpy()[m > 0],
                                   np.asarray(j)[m > 0], **TOL)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cts))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    _assert_tree_close(flax_batch_stats_from_module(tm), jnew["batch_stats"])

    tm.eval()
    stats_before = flax_batch_stats_from_module(tm)
    with torch.no_grad():
        eouts = tm(gt)
    want = jm.apply({"params": variables["params"],
                     "batch_stats": jnew["batch_stats"]}, gj, train=False)
    for t, j, m in zip(eouts, want, masks):
        np.testing.assert_allclose(t.numpy()[m > 0], np.asarray(j)[m > 0],
                                   **TOL)
    # eval mode updates nothing
    for a, b in zip(jax.tree.leaves(stats_before),
                    jax.tree.leaves(flax_batch_stats_from_module(tm))):
        np.testing.assert_array_equal(a, b)

    # read the gradients out through the weight map, then put the weights
    # back
    kept = [q.detach().clone() for q in tm.parameters()]
    with torch.no_grad():
        for q in tm.parameters():
            assert q.grad is not None
            q.copy_(q.grad)
    got = flax_params_from_module(tm)
    with torch.no_grad():
        for q, k in zip(tm.parameters(), kept):
            q.copy_(k)
    _assert_grads_close(got, jgrads, scaled_grads)


@pytest.mark.parametrize("backend", ["scatter", "fused"])
@pytest.mark.parametrize("model_type", ARCHS)
def test_arch_forward_grads_and_stats_match_jax(model_type, backend,
                                                monkeypatch):
    jm, variables, tm, gj, gt = _both(model_type, monkeypatch, backend)
    assert ("edge_perm_sender" in gt.extras) == (backend == "fused")
    assert set(variables["batch_stats"]) == {"encoder_bn_0", "encoder_bn_1"}
    before = pipeline.dispatch_snapshot()
    _train_eval_and_grads(jm, variables, tm, gj, gt)
    delta = pipeline.dispatch_delta(before, pipeline.dispatch_snapshot())
    label = "fused" if backend == "fused" else "scatter"
    site = {"GIN": "gather_sum", "SAGE": "poly_gather", "MFC": "poly_gather",
            "PNA": "poly_scatter"}[model_type]
    # two conv layers, one training and one eval forward
    want = {f"{site}:{label}": 4, f"mean_pool:{label}": 2}
    if backend == "scatter":
        # the composed path's sum (and PNA's sum of squares) re-dispatch
        if site == "poly_gather":
            want["gather_sum:scatter"] = 4
        elif site == "poly_scatter":
            want["scatter_sum:scatter"] = 8
    assert delta == want
    assert pipeline.dispatch_summary(delta) == label


@pytest.mark.parametrize("model_type", ARCHS)
def test_weights_round_trip_through_port_weights(model_type, monkeypatch):
    """The port's ``state_dict()`` carries the reference checkpoint keys:
    the repo's torch->flax porter rebuilds the JAX params and batch_stats
    from it exactly, and the port's own inverse gives the same trees."""
    jm, variables, tm, gj, gt = _both(model_type, monkeypatch, "scatter")
    tm.train()
    tm(gt)  # running statistics away from their initial values
    stats = flax_batch_stats_from_module(tm)
    assert float(np.abs(stats["encoder_bn_0"]["mean"]).max()) > 0
    ported = port_state_dict(tm.state_dict(), model_type,
                             {"params": variables["params"],
                              "batch_stats": variables["batch_stats"]})
    for got, want in ((ported["params"], variables["params"]),
                      (flax_params_from_module(tm), variables["params"]),
                      (ported["batch_stats"], stats)):
        assert jax.tree_util.tree_structure(
            jax.tree.map(np.asarray, got)) == \
            jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert np.shape(a) == np.shape(b)
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # a batch_stats tree that does not name the module's BatchNorms raises
    with pytest.raises(KeyError):
        load_flax_params(tm, variables["params"], {})
    again = t_create_model(tm.cfg, seed=5)
    load_flax_params(again, flax_params_from_module(tm), stats)
    for (k, a), b in zip(tm.state_dict().items(),
                         again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_mfc_bank_init_uses_the_stacked_fan_in():
    """flax's lecun_normal on a [d, in, out] bank takes fan-in d * in."""
    _, tc = _cfgs("MFC", hidden=64)
    conv = t_create_model(tc, seed=0).graph_convs[1]
    d = tc.max_degree + 1
    w = torch.stack([m.weight for m in conv.lins_l]).detach().numpy()
    assert w.shape == (d, 64, 64)
    np.testing.assert_allclose(w.std(), np.sqrt(1.0 / (d * 64)), rtol=0.05)
    assert all(float(m.bias.abs().max()) == 0 for m in conv.lins_l)


@pytest.mark.parametrize("model_type", ["CGCNN", "DimeNet"])
def test_unported_archs_raise(model_type):
    """Queue A4's two architectures, the last to be ported, now build:
    CGCNN (tests/test_torch_cgcnn.py holds it to JAX) and DimeNet
    (tests/test_torch_dimenet.py), which needs its own keys."""
    _, tc = _cfgs("GIN")
    tc = dataclasses.replace(tc, model_type=model_type)
    if model_type == "DimeNet":
        tc = dataclasses.replace(
            tc, radius=1.6, envelope_exponent=5, num_before_skip=1,
            num_after_skip=2, num_radial=6, num_spherical=7,
            basis_emb_size=8, int_emb_size=16, out_emb_size=16)
    assert t_create_model(tc).cfg.model_type == model_type


def test_create_refuses_what_the_reference_asserts():
    _, tc = _cfgs("PNA")
    with pytest.raises(ValueError, match="degree"):
        t_create_model(dataclasses.replace(tc, pna_avg_deg_log=None))
    with pytest.raises(ValueError, match="max_neighbours"):
        t_create_model(dataclasses.replace(tc, model_type="MFC",
                                           max_degree=None))
    with pytest.raises(ValueError, match="Unknown model_type"):
        t_create_model(dataclasses.replace(tc, model_type="Nope"))


# --- MaskedBatchNorm alone ---------------------------------------------------


@pytest.mark.parametrize("n_valid", [1, 9, 14], ids=["one-row", "some", "all"])
def test_masked_batchnorm_matches_jax(n_valid, monkeypatch):
    rng = np.random.RandomState(n_valid)
    x = (rng.randn(14, 5) * 3 + 1).astype(np.float32)
    mask = np.zeros(14, np.float32)
    mask[:n_valid] = 1.0
    jbn = jlayers.MaskedBatchNorm(5)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                         jnp.asarray(mask))
    params = {"scale": jnp.asarray(rng.rand(5).astype(np.float32) + 0.5),
              "bias": jnp.asarray(rng.randn(5).astype(np.float32))}
    stats = variables["batch_stats"]
    tbn = tlayers.MaskedBatchNorm(5)
    with torch.no_grad():
        tbn.scale.copy_(torch.from_numpy(np.asarray(params["scale"])))
        tbn.bias.copy_(torch.from_numpy(np.asarray(params["bias"])))
    assert set(dict(tbn.named_parameters())) == {"module.weight",
                                                 "module.bias"}
    assert set(dict(tbn.named_buffers())) == {"module.running_mean",
                                              "module.running_var"}
    tol = dict(rtol=1e-6, atol=1e-6)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    for step in range(3):  # the running statistics build up over steps
        if step == 2:
            monkeypatch.setenv("HYDRAGNN_BN_MOMENTUM", "0.3")
        want, new = jbn.apply({"params": params, "batch_stats": stats},
                              jnp.asarray(x), jnp.asarray(mask),
                              mutable=["batch_stats"])
        stats = new["batch_stats"]
        tbn.train()
        got = tbn(xt, mt)
        # a one-row batch normalises to the bias: (x - mean) is exactly 0
        np.testing.assert_allclose(got.detach().numpy()[:n_valid],
                                   np.asarray(want)[:n_valid], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(tbn.mean.numpy(), np.asarray(stats["mean"]),
                                   **tol)
        np.testing.assert_allclose(tbn.var.numpy(), np.asarray(stats["var"]),
                                   **tol)
    assert np.isfinite(tbn.var.numpy()).all()
    tbn.eval()
    want = jbn.apply({"params": params, "batch_stats": stats},
                     jnp.asarray(x), jnp.asarray(mask),
                     use_running_average=True)
    mean0 = tbn.mean.clone()
    with torch.no_grad():
        got = tbn(xt, mt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(tbn.mean, mean0, rtol=0, atol=0)
    # gradients of the training-mode forward
    ct = rng.randn(14, 5).astype(np.float32) * mask[:, None]
    jg = jax.grad(lambda p, x_: jnp.sum(jbn.apply(
        {"params": p, "batch_stats": stats}, x_, jnp.asarray(mask),
        mutable=["batch_stats"])[0] * ct), argnums=(0, 1))(
            params, jnp.asarray(x))
    tbn.train()
    xg = xt.clone().requires_grad_(True)
    (tbn(xg, mt) * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(xg.grad.numpy(), np.asarray(jg[1]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tbn.scale.grad.numpy(),
                               np.asarray(jg[0]["scale"]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tbn.bias.grad.numpy(),
                               np.asarray(jg[0]["bias"]), rtol=1e-4,
                               atol=1e-5)


# --- conv-type node heads and the PNA multihead ------------------------------


@pytest.mark.parametrize("backend", ["scatter", "fused"])
def test_conv_node_head_matches_jax(backend, monkeypatch):
    """``ci_conv_head.json``'s shape: PNA, hidden 20, two convs, one node
    head of type ``conv`` with hidden dims (20, 10) and no graph head."""
    nh = jbase.NodeHeadCfg(2, (20, 10), "conv")
    jm, variables, tm, gj, gt = _both(
        "PNA", monkeypatch, backend, hidden=20, node_head=nh,
        n_node_heads=1, graph_head=False)
    assert set(variables["batch_stats"]) == {
        "encoder_bn_0", "encoder_bn_1", "node_conv_hidden_bn_0",
        "node_conv_hidden_bn_1", "head_0_out_bn"}
    assert {"node_conv_hidden_0", "node_conv_hidden_1",
            "head_0_out_conv"} <= set(variables["params"])
    _train_eval_and_grads(jm, variables, tm, gj, gt, scaled_grads=True)


def test_conv_node_heads_share_their_hidden_stack(monkeypatch):
    nh = jbase.NodeHeadCfg(1, (8,), "conv")
    jm, variables, tm, gj, gt = _both(
        "SAGE", monkeypatch, "scatter", node_head=nh, n_node_heads=2)
    assert len(tm.convs_node_hidden) == 1
    assert {"head_1_out_conv", "head_2_out_conv",
            "node_conv_hidden_0"} <= set(variables["params"])
    _train_eval_and_grads(jm, variables, tm, gj, gt)


@pytest.mark.parametrize("backend", ["scatter", "fused"])
def test_pna_multihead_matches_jax(backend, monkeypatch):
    """``ci_multihead.json``'s shape: PNA, hidden 8, a graph head and three
    node heads of type ``mlp`` with task weights."""
    nh = jbase.NodeHeadCfg(2, (10, 10), "mlp")
    jm, variables, tm, gj, gt = _both(
        "PNA", monkeypatch, backend, hidden=8, node_head=nh, n_node_heads=3)
    assert len(tm.heads_NN) == 4
    _train_eval_and_grads(jm, variables, tm, gj, gt)
    # and the weighted multi-task loss
    tm.eval()
    with torch.no_grad():
        tl, per_t = tbase.multihead_loss(tm.cfg, tm(gt), gt)
    jl, per_j = jbase.multihead_loss(
        jm.cfg, jm.apply({"params": variables["params"],
                          "batch_stats": flax_batch_stats_from_module(tm)},
                         gj, train=False), gj)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    for a, b in zip(per_t, per_j):
        np.testing.assert_allclose(float(a), float(b), **TOL)


def test_pna_edge_features_match_jax(monkeypatch):
    """The ``edge_dim`` branch: an ``edge_encoder`` on ``edge_attr``."""
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", "fused")
    raw = _samples(1.6, 10, 12, n_graphs=4, seed=5)
    rng = np.random.RandomState(6)
    for r in raw:
        r["edge_attr"] = rng.rand(r["edge_index"].shape[1], 1).astype(
            np.float32)
    gj, gt = _batches(raw, [("energy", "graph", 1)])
    jc, tc = _cfgs("PNA")
    jc = dataclasses.replace(jc, edge_dim=1)
    tc = dataclasses.replace(tc, edge_dim=1)
    jm = j_create_model(jc)
    variables = jax.tree.map(np.asarray, init_model(jm, gj, seed=0))
    assert "edge_encoder" in variables["params"]["encoder_conv_0"]
    tm = t_create_model(tc)
    load_flax_params(tm, variables["params"], variables["batch_stats"])
    _train_eval_and_grads(jm, variables, tm, gj, gt)
    with pytest.raises(ValueError, match="edge_attr"):
        tm(dataclasses.replace(gt, edge_attr=None))


# --- the training loop and the checkpoints -----------------------------------


def _pna_config(name, epochs, lr=1e-3):
    with open(os.path.join(REPO, "tests", "inputs", "ci.json")) as f:
        config = json.load(f)
    ds = config["Dataset"]
    ds["name"] = name
    ds["path"] = {"total": f"dataset/{name}"}
    ds["compositional_stratified_splitting"] = False
    arch = config["NeuralNetwork"]["Architecture"]
    arch.update(model_type="PNA", hidden_dim=8, num_conv_layers=2,
                radius=2.0, max_neighbours=20)
    tr = config["NeuralNetwork"]["Training"]
    tr.update(num_epoch=epochs, batch_size=16, EarlyStopping=True,
              patience=2, Checkpoint=True, checkpoint_warmup=1)
    tr["Optimizer"] = {"type": "AdamW", "learning_rate": lr}
    return config


def test_pna_train_validate_test_tracks_jax(monkeypatch, tmp_path):
    """Same init (weights and BatchNorm statistics), same batches: the
    reference (scatter, one device) and the port (fused: its autograd
    Functions over the plain kernel versions) give the same per-epoch
    losses — eval passes on the running statistics — and decisions."""
    from ci_data import generate_cached
    from hydragnn_tpu.config.config import get_log_name_config
    from hydragnn_tpu.data.load_data import (
        dataset_loading_and_splitting as j_load)
    from hydragnn_tpu.train import trainer as jtr
    from hydragnn_tpu.train.optimizer import select_optimizer as j_opt
    from hydragnn_torch.data.load_data import (
        dataset_loading_and_splitting as t_load)
    from hydragnn_torch.train import trainer as ttr
    from hydragnn_torch.train.optimizer import select_optimizer as t_opt
    from test_torch_train import _record_checkpoints

    monkeypatch.setenv("HYDRAGNN_AUTO_PIPELINE", "0")
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", "scatter")
    monkeypatch.setattr(jax, "local_devices",
                        lambda *a, **k: jax.devices()[:1])
    name = "torch_port_pna_train"
    generate_cached(name, f"dataset/{name}", 120)
    config = _pna_config(name, epochs=6, lr=2e-2)
    jtrain, jval, jtest, jcfg = j_load(copy.deepcopy(config))
    log_name = get_log_name_config(jcfg)
    jc = jbase.ModelConfig.from_config(jcfg["NeuralNetwork"])
    jm = j_create_model(jc)
    jspec = j_opt(jcfg["NeuralNetwork"]["Training"]["Optimizer"])
    jstate = jtr.create_train_state(jm, next(iter(jtrain)), jspec)
    params0 = jax.tree.map(np.asarray, jstate.params)
    stats0 = jax.tree.map(np.asarray, jstate.batch_stats)
    for mod in (jtr, ttr):
        monkeypatch.setattr(mod.ReduceLROnPlateau.__init__, "__defaults__",
                            (0.5, 1, 1e-5, 1e-4))
    jsaves, tsaves = [], []
    _record_checkpoints(monkeypatch, jtr, jsaves)
    _record_checkpoints(monkeypatch, ttr, tsaves)
    jstate, jh = jtr.train_validate_test(
        jm, jc, jstate, jspec, jtrain, jval, jtest, jcfg["NeuralNetwork"],
        log_name, logs_dir=str(tmp_path / "jax"), use_mesh_dp=False)

    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", "fused")
    ttrain, tval, ttest, tcfg = t_load(copy.deepcopy(config))
    assert json.dumps(tcfg, sort_keys=True) == json.dumps(jcfg,
                                                          sort_keys=True)
    cfg = tbase.ModelConfig.from_config(tcfg["NeuralNetwork"])
    assert cfg.pna_avg_deg_log == pytest.approx(jc.pna_avg_deg_log)
    model = t_create_model(cfg)
    load_flax_params(model, params0, stats0)
    tspec = t_opt(tcfg["NeuralNetwork"]["Training"]["Optimizer"])
    state = ttr.create_train_state(model, tspec)
    state, th = ttr.train_validate_test(
        model, cfg, state, tspec, ttrain, tval, ttest,
        tcfg["NeuralNetwork"], log_name, logs_dir=str(tmp_path / "torch"),
        device=torch.device("cpu"))
    assert "edge_perm_sender" in next(iter(ttrain)).extras

    for k in ("train", "val", "test"):
        np.testing.assert_allclose(th[k], jh[k], rtol=1e-4, err_msg=k)
    assert th["lr"] == jh["lr"]
    assert len(th["train"]) == len(jh["train"])
    assert tsaves == jsaves and True in tsaves
    assert state.step == len(th["train"]) * len(ttrain)
    # the running statistics moved once per step in both packages: the
    # variances agree.  The means are held through the val/test losses above
    # and not leaf by leaf: a bias in front of a BatchNorm has a zero true
    # gradient, so Adam turns its float32 rounding noise into a random walk
    # (~5e-3 here) that the running mean absorbs and the normalisation
    # cancels
    jstats = jax.tree.map(np.asarray, jstate.batch_stats)
    tstats = flax_batch_stats_from_module(model)
    for bn in ("encoder_bn_0", "encoder_bn_1"):
        np.testing.assert_allclose(tstats[bn]["var"], jstats[bn]["var"],
                                   rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(tstats[bn]["mean"], jstats[bn]["mean"],
                                   atol=5e-2)
        assert float(np.abs(tstats[bn]["mean"]).max()) > 0
    assert not model.training  # the last pass of an epoch is an eval pass


def test_pna_checkpoints_read_in_both_packages(monkeypatch, tmp_path):
    """A PNA ``.pk`` (with ``batch_stats``) written by each package's
    ``run_training`` is read by both ``run_prediction``s, which agree."""
    import hydragnn_tpu
    import hydragnn_torch
    from ci_data import generate_cached
    from hydragnn_torch.config.config import get_log_name_config
    from hydragnn_torch.serve.engine import load_inference_state
    from hydragnn_torch.train.trainer import load_state

    monkeypatch.setenv("HYDRAGNN_AUTO_PIPELINE", "0")
    monkeypatch.delenv("HYDRAGNN_AGGR_BACKEND", raising=False)
    monkeypatch.setattr(jax, "local_devices",
                        lambda *a, **k: jax.devices()[:1])
    name = "torch_port_pna_ckpt"
    generate_cached(name, f"dataset/{name}", 96)
    config = _pna_config(name, epochs=2)
    config["NeuralNetwork"]["Variables_of_interest"]["denormalize_output"] \
        = True

    tlogs, jlogs = str(tmp_path / "torch"), str(tmp_path / "jax")
    tconfig = copy.deepcopy(config)
    tconfig["NeuralNetwork"]["Architecture"]["aggregation_backend"] = "fused"
    state, hist, fcfg = hydragnn_torch.run_training(
        tconfig, logs_dir=tlogs, device="cpu")
    assert len(hist["train"]) == 2 and all(np.isfinite(hist["train"]))
    hydragnn_tpu.run_training(copy.deepcopy(config), logs_dir=jlogs)

    for logs in (tlogs, jlogs):
        st = load_inference_state(fcfg, logs)
        assert set(st.batch_stats) == {"encoder_bn_0", "encoder_bn_1"}
        assert set(st.batch_stats["encoder_bn_0"]) == {"mean", "var"}
        # trained statistics, not the initial zeros and ones
        assert float(np.abs(st.batch_stats["encoder_bn_0"]["mean"]).max()) > 0
        got = hydragnn_torch.run_prediction(copy.deepcopy(config),
                                            logs_dir=logs, device="cpu")
        want = hydragnn_tpu.run_prediction(copy.deepcopy(config),
                                           logs_dir=logs)
        np.testing.assert_allclose(got[0], want[0], **TOL)
        for t, j in zip(got[3], want[3]):
            np.testing.assert_allclose(t, np.asarray(j), **TOL)
    # the port restores its own state, BatchNorm buffers included
    stats = flax_batch_stats_from_module(state.model)
    for b in state.model.buffers():
        b.data.zero_()
    back = load_state(state, get_log_name_config(fcfg), tlogs)
    assert back.step == state.step
    for a, b in zip(jax.tree.leaves(flax_batch_stats_from_module(back.model)),
                    jax.tree.leaves(stats)):
        np.testing.assert_array_equal(a, b)


def test_freeze_conv_layers_covers_the_batchnorms():
    from hydragnn_torch.train.optimizer import frozen_mask

    _, tc = _cfgs("GIN")
    names = [n for n, _ in t_create_model(tc).named_parameters()]
    mask = frozen_mask(names, True)
    frozen = {n for n, m in zip(names, mask) if m}
    assert "feature_layers.0.module.weight" in frozen
    assert "graph_convs.1.eps" in frozen
    assert not any(n.startswith(("graph_shared", "heads_NN"))
                   for n in frozen)
    assert all(n.startswith(("graph_shared", "heads_NN"))
               for n in set(names) - frozen)


@pytest.mark.parametrize("wrong_leaf", [False, True], ids=["right", "wrong"])
@pytest.mark.parametrize("model_type", ARCHS)
def test_smoke_lockstep_holds_each_parameter_on_its_own_scale(
        model_type, wrong_leaf, monkeypatch):
    """``chip_smoke.lockstep`` with the CPU standing in for the card: the
    float64 yardstick runs for every arch and passes a faithful copy; a
    copy whose smallest non-zero gradient leaf is off by half of what the
    model-wide tolerance (1e-4 of the largest gradient entry) lets
    through is refused on that leaf's own scale."""
    import chip_smoke
    from hydragnn_torch.models import create as tcreate

    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", "fused")
    _, tc = _cfgs(model_type)
    raw = _samples(1.6, 10, 12, n_graphs=5, seed=3)
    _, gt = _batches(raw, [("energy", "graph", 1)])
    if not wrong_leaf:
        out = chip_smoke.lockstep(torch, tc, [gt, gt], 0, torch.device("cpu"))
        assert out["loss"] == 0.0 and out["grad_over_largest"] == 0.0
        assert (0.0 < out["grad_over_allowed"]
                <= 1.0 / chip_smoke.LOCKSTEP_GRAD_SLACK)
        assert out["zero_gradient_parameters"] >= tc.num_conv_layers
        return

    # the smallest leaf with a true gradient, by the float64 run itself
    model = t_create_model(tc, seed=0).double()
    model.train()
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", "scatter")
    loss, _ = tbase.multihead_loss(tc, model(chip_smoke.as_double(gt)),
                                   chip_smoke.as_double(gt))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", "fused")
    tops = [float(d.abs().max()) for d in grads]
    live = [i for i, t in enumerate(tops) if t > 1e-6 * max(tops)]
    victim = min(live, key=lambda i: tops[i])
    assert tops[victim] < 0.05 * max(tops)

    made = []

    def create(cfg, seed=0):
        m = t_create_model(cfg, seed=seed)
        made.append(m)
        if len(made) == 2:    # lockstep's second model is the card's
            list(m.parameters())[victim].register_hook(
                lambda d: d + 0.5e-4 * max(tops))
        return m

    monkeypatch.setattr(tcreate, "create_model", create)
    with pytest.raises(RuntimeError, match="from the float64 gradient, allowed"):
        chip_smoke.lockstep(torch, tc, [gt], 0, torch.device("cpu"))
