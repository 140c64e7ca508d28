"""SchNet in the PyTorch port against the JAX reference.

Weights come from a JAX ``init`` and are carried into the port with
``hydragnn_torch.utils.weights.load_flax_params``; the same padded batch
(``__graft_entry__._flagship``-style random molecules) goes through both
forward passes.  Covered: the h32/3-layer entry config and the flagship
widths (hidden 64, 4 convs, 50 gaussians, 64 filters, radius 1.8), under
the ``scatter`` and ``fused`` backends (the JAX side then runs the Pallas
ops in interpret mode, the port its plain versions), with and without the
equivariant branch.  Tolerance 1e-4 (model level, float32).

Also: the weight round trip through ``tools/port_weights.port_state_dict``,
and the wide-filter SchNet (``num_filters >= 256``, the fused edge
pipeline under ``fused``): forward and every parameter gradient.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from hydragnn_tpu.graph import batch as jb
from hydragnn_tpu.graph.neighborlist import radius_graph
from hydragnn_tpu.models import base as jbase
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.models.create import init_model
from hydragnn_torch.graph import batch as tb
from hydragnn_torch.models import base as tbase
from hydragnn_torch.models.create import create_model as t_create_model
from hydragnn_torch.utils.weights import (
    flax_params_from_module,
    load_flax_params,
)
from tools.port_weights import port_state_dict

TOL = dict(rtol=1e-4, atol=1e-4)

# (hidden, convs, gaussians, filters, radius, max_neighbours, nodes/graph)
H32 = (32, 3, 32, 32, 1.5, 16, 16)
FLAGSHIP = (64, 4, 50, 64, 1.8, 20, 24)


def _samples(radius, cap, nodes, n_graphs=4, seed=0, node_dim=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_graphs):
        pos = rng.rand(nodes, 3).astype(np.float32) * 3.0
        x = rng.rand(nodes, 1).astype(np.float32)
        ny = rng.rand(nodes, node_dim).astype(np.float32) if node_dim else x
        out.append(dict(x=x, pos=pos,
                        edge_index=radius_graph(pos, radius,
                                                max_neighbours=cap),
                        graph_y=rng.rand(1).astype(np.float32), node_y=ny))
    return out


def _batches(raw, heads):
    js = [jb.GraphSample(**r) for r in raw]
    ts = [tb.GraphSample(**r) for r in raw]
    n = max(s.num_nodes for s in js)
    e = max(s.num_edges for s in js)
    gj = jb.collate(js, jb.PadSpec.for_batch(len(js), n, e),
                    [jb.HeadSpec(*h) for h in heads])
    gt = tb.collate(ts, tb.PadSpec.for_batch(len(ts), n, e),
                    [tb.HeadSpec(*h) for h in heads])
    return gj, gt


def _cfgs(widths, equivariance, node_head=None):
    hidden, convs, gauss, filters, radius, cap, _ = widths
    kw = dict(
        model_type="SchNet", input_dim=1, hidden_dim=hidden,
        output_dim=(1,), output_type=("graph",),
        graph_head=jbase.GraphHeadCfg(2, hidden, 2, (hidden, hidden)),
        node_head=None, task_weights=(1.0,), num_conv_layers=convs,
        num_gaussians=gauss, num_filters=filters, radius=radius,
        max_neighbours=cap, equivariance=equivariance)
    if node_head is not None:
        kw.update(output_dim=(1, 2), output_type=("graph", "node"),
                  task_weights=(1.0, 1.0), node_head=node_head,
                  num_nodes=widths[6])
    jc = jbase.ModelConfig(**kw)
    tkw = dict(kw)
    tkw["graph_head"] = tbase.GraphHeadCfg(*dataclasses.astuple(kw["graph_head"]))
    if node_head is not None:
        tkw["node_head"] = tbase.NodeHeadCfg(*dataclasses.astuple(node_head))
    return jc, tbase.ModelConfig(**tkw)


def _both(widths, equivariance, monkeypatch, backend, node_head=None):
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", backend)
    heads = [("energy", "graph", 1)]
    if node_head is not None:
        heads.append(("forces", "node", 2))
    raw = _samples(widths[4], widths[5], widths[6],
                   node_dim=2 if node_head is not None else 0)
    gj, gt = _batches(raw, heads)
    jc, tc = _cfgs(widths, equivariance, node_head)
    jm = j_create_model(jc)
    variables = init_model(jm, gj, seed=0)
    tm = t_create_model(tc)
    load_flax_params(tm, variables["params"], variables.get("batch_stats"))
    return jm, variables, tm, gj, gt


@pytest.mark.parametrize("backend", ["scatter", "fused"])
@pytest.mark.parametrize("equivariance", [False, True])
@pytest.mark.parametrize("widths", [H32, FLAGSHIP], ids=["h32", "flagship"])
def test_schnet_forward_matches_jax(widths, equivariance, backend,
                                    monkeypatch):
    jm, variables, tm, gj, gt = _both(widths, equivariance, monkeypatch,
                                      backend)
    assert ("edge_perm_sender" in gt.extras) == (backend == "fused")
    want = jm.apply(variables, gj, train=False)
    with torch.inference_mode():
        got = tm(gt)
    assert len(got) == len(want)
    for t, j in zip(got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("node_type", ["mlp", "mlp_per_node"])
def test_weights_round_trip_through_port_weights(node_type, monkeypatch):
    """port.state_dict() carries the reference checkpoint keys, so the
    repo's torch->flax porter rebuilds the JAX tree from it exactly; and
    the port's own inverse gives the same tree back."""
    nh = jbase.NodeHeadCfg(2, (8, 8), node_type)
    jm, variables, tm, gj, gt = _both(H32, True, monkeypatch, "scatter",
                                      node_head=nh)
    ported = port_state_dict(tm.state_dict(), "SchNet", variables)
    flat_want = jax.tree_util.tree_leaves_with_path(variables["params"])
    flat_got = dict(jax.tree_util.tree_leaves_with_path(ported["params"]))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]),
                                      np.asarray(leaf))
    mine = flax_params_from_module(tm)
    assert jax.tree_util.tree_structure(mine) == \
        jax.tree_util.tree_structure(jax.tree.map(np.asarray,
                                                  variables["params"]))
    for a, b in zip(jax.tree.leaves(mine),
                    jax.tree.leaves(variables["params"])):
        np.testing.assert_array_equal(a, np.asarray(b))
    # and the node heads agree in the forward pass too
    want = jm.apply(variables, gj, train=False)
    with torch.inference_mode():
        got = tm(gt)
    for t, j in zip(got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_load_rejects_a_tree_that_does_not_match():
    _, tc = _cfgs(H32, False)
    tm = t_create_model(tc)
    tree = flax_params_from_module(tm)
    del tree["encoder_conv_0"]["lin1"]
    with pytest.raises(KeyError):
        load_flax_params(tm, tree)


@pytest.mark.parametrize("backend", ["fused", "scatter"])
def test_wide_filters_forward_and_grads_match_jax(backend, monkeypatch):
    """num_filters >= 256: under ``fused`` both packages take the fused edge
    pipeline (the port's plain kernel versions on the CPU, the reference's
    Pallas ops in interpret mode), under ``scatter`` the composed path;
    forward and every parameter gradient agree at 1e-4."""
    from hydragnn_torch.ops import fused_mp
    from hydragnn_torch.telemetry import pipeline

    wide = (16, 2, 8, 256, 1.5, 16, 8)
    jm, variables, tm, gj, gt = _both(wide, False, monkeypatch, backend)
    ct = np.random.RandomState(1).randn(gj.graph_mask.shape[0], 1).astype(
        np.float32)

    def jloss(params):
        out = jm.apply({"params": params}, gj, train=False)
        return jax.numpy.sum(out[0] * ct)

    jl, jgrads = jax.value_and_grad(jloss)(variables["params"])
    before = pipeline.dispatch_snapshot()
    fused_mp.reset_launches()
    out = tm(gt)[0]
    loss = (out * torch.from_numpy(ct)).sum()
    loss.backward()
    counts = pipeline.dispatch_delta(before, pipeline.dispatch_snapshot())
    if backend == "fused":
        assert counts.get("scf_pipeline:fused") == 2
        assert "gather_mul:fused" not in counts
    else:
        assert "scf_pipeline:fused" not in counts
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    with torch.no_grad():
        for q in tm.parameters():
            q.copy_(q.grad)
    got = flax_params_from_module(tm)
    flat_want = jax.tree_util.tree_leaves_with_path(jgrads)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_allclose(flat_got[path], np.asarray(leaf),
                                   err_msg=jax.tree_util.keystr(path), **TOL)
