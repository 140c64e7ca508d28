"""The PyTorch port's graph layer against the JAX reference: collate (same
arrays, same kernel marker, under both aggregation backends), the radius
graph, and the segment ops at their dispatch points (plain path and the
marked path, whose JAX side runs the Pallas ops in interpret mode).
Tolerance 1e-5 (float32 sums in a different order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hydragnn_tpu.graph import batch as jb
from hydragnn_tpu.graph import neighborlist as jnl
from hydragnn_tpu.graph import segment as jseg
from hydragnn_torch.graph import batch as tb
from hydragnn_torch.graph import neighborlist as tnl
from hydragnn_torch.graph import segment as tseg
from hydragnn_torch.telemetry import pipeline

TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = ("x", "pos", "senders", "receivers", "edge_attr", "node_gid",
          "node_mask", "edge_mask", "graph_mask", "cell")


def _raw_samples(n_graphs=5, seed=0, max_nodes=40):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_graphs):
        n = int(rng.randint(3, max_nodes + 1))
        pos = (rng.rand(n, 3) * 3.0).astype(np.float32)
        out.append(dict(
            x=rng.rand(n, 2).astype(np.float32), pos=pos,
            edge_attr=None, graph_y=rng.rand(2).astype(np.float32),
            node_y=rng.rand(n, 3).astype(np.float32)))
    return out


def _collate_both(raw, monkeypatch, backend, radius=1.5, cap=16):
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", backend)
    js, ts = [], []
    for r in raw:
        ei_j = jnl.radius_graph(r["pos"], radius, max_neighbours=cap)
        ei_t = tnl.radius_graph(r["pos"], radius, max_neighbours=cap)
        np.testing.assert_array_equal(ei_j, ei_t)
        js.append(jb.GraphSample(edge_index=ei_j, **r))
        ts.append(tb.GraphSample(edge_index=ei_t, **r))
    heads_j = [jb.HeadSpec("e", "graph", 1), jb.HeadSpec("f", "node", 2)]
    heads_t = [tb.HeadSpec("e", "graph", 1), tb.HeadSpec("f", "node", 2)]
    n_max = max(s.num_nodes for s in js)
    e_max = max(s.num_edges for s in js)
    gj = jb.collate(js, jb.PadSpec.for_batch(len(js), n_max, e_max), heads_j)
    gt = tb.collate(ts, tb.PadSpec.for_batch(len(ts), n_max, e_max), heads_t)
    return gj, gt


@pytest.mark.parametrize("backend", ["scatter", "fused"])
def test_collate_same_arrays_and_marker(backend, monkeypatch):
    gj, gt = _collate_both(_raw_samples(), monkeypatch, backend)
    for name in FIELDS:
        a, b = getattr(gj, name), getattr(gt, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert b.dtype == torch.from_numpy(np.asarray(a)).dtype, name
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), name)
    assert len(gj.labels) == len(gt.labels)
    for a, b in zip(gj.labels, gt.labels):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert set(gj.extras) == set(gt.extras)
    assert ("edge_perm_sender" in gt.extras) == (backend == "fused")
    for k in gj.extras:
        np.testing.assert_array_equal(np.asarray(gj.extras[k]),
                                      gt.extras[k].numpy())


def test_marker_needs_small_graphs_and_sorted_receivers(monkeypatch):
    # a graph larger than one node block keeps the batch off the kernels
    gj, gt = _collate_both(_raw_samples(2, seed=1, max_nodes=40)
                           + [dict(x=np.zeros((130, 2), np.float32),
                                   pos=np.random.RandomState(2).rand(
                                       130, 3).astype(np.float32) * 9,
                                   edge_attr=None,
                                   graph_y=np.zeros(2, np.float32),
                                   node_y=np.zeros((130, 3), np.float32))],
                           monkeypatch, "fused")
    assert "edge_perm_sender" not in gj.extras
    assert "edge_perm_sender" not in gt.extras


def _features(g, f, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(g.num_nodes, f).astype(np.float32)
    w = rng.randn(g.num_edges, f).astype(np.float32)
    return x, w


@pytest.mark.parametrize("backend", ["scatter", "fused"])
def test_segment_ops_match_jax(backend, monkeypatch):
    gj, gt = _collate_both(_raw_samples(6, seed=3), monkeypatch, backend)
    x, w = _features(gj, 7, 4)
    n, G = gj.num_nodes, gj.num_graphs
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    before = pipeline.dispatch_snapshot()

    def close(t, j):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)

    close(tseg.gather_mul_segment(xt, wt, gt),
          jseg.gather_mul_segment(xj, wj, gj))
    close(tseg.gather_segment(xt, gt), jseg.gather_segment(xj, gj))
    close(tseg.scatter_segment(wt, gt), jseg.scatter_segment(wj, gj))
    hint = backend == "fused"
    close(tseg.masked_mean_pool(xt, gt.node_gid, G, gt.node_mask, hint),
          jseg.masked_mean_pool(xj, jnp.asarray(gj.node_gid), G,
                                jnp.asarray(gj.node_mask), hint))
    close(tseg.sorted_segment_sum(wt, gt.receivers, n, gt.edge_mask, hint),
          jseg.sorted_segment_sum(wj, jnp.asarray(gj.receivers), n,
                                  jnp.asarray(gj.edge_mask), hint))
    close(tseg.segment_mean(wt, gt.receivers, n, gt.edge_mask),
          jseg.segment_mean(wj, jnp.asarray(gj.receivers), n,
                            jnp.asarray(gj.edge_mask)))
    close(tseg.segment_sum(wt, gt.senders, n, gt.edge_mask),
          jseg.segment_sum(wj, jnp.asarray(gj.senders), n,
                           jnp.asarray(gj.edge_mask)))
    close(tseg.degree(gt.receivers, n, gt.edge_mask),
          jseg.degree(jnp.asarray(gj.receivers), n,
                      jnp.asarray(gj.edge_mask)))
    close(tseg.masked_sum_pool(xt, gt.node_gid, G, gt.node_mask),
          jseg.masked_sum_pool(xj, jnp.asarray(gj.node_gid), G,
                               jnp.asarray(gj.node_mask)))
    # the port's tally records which path each dispatch site took
    delta = pipeline.dispatch_delta(before, pipeline.dispatch_snapshot())
    label = "fused" if hint else "scatter"
    assert delta == {f"gather_mul:{label}": 1, f"gather_sum:{label}": 1,
                     f"scatter_sum:{label}": 1, f"mean_pool:{label}": 1,
                     f"sorted_sum:{label}": 1}
    assert pipeline.dispatch_summary(delta) == label


def test_onehot_backend_matches_scatter(monkeypatch):
    rng = np.random.RandomState(0)
    data = torch.from_numpy(rng.randn(50, 3).astype(np.float32))
    ids = torch.from_numpy(rng.randint(0, 9, 50).astype(np.int32))
    want = tseg.segment_sum(data, ids, 9)
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", "onehot")
    torch.testing.assert_close(tseg.segment_sum(data, ids, 9), want, **TOL)
    # the pallas backend: the port's CSR segment-sum kernel (its plain
    # version on the CPU), the same sums
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", "pallas")
    torch.testing.assert_close(tseg.segment_sum(data, ids, 9), want, **TOL)


def test_graph_batch_to_moves_every_tensor(monkeypatch):
    _, gt = _collate_both(_raw_samples(2), monkeypatch, "fused")
    moved = gt.to("cpu")
    assert moved.num_nodes == gt.num_nodes and moved.num_graphs == gt.num_graphs
    assert float(moved.n_real_graphs) == 2.0
    assert set(moved.extras) == {"edge_perm_sender"}
