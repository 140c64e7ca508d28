"""The ``pallas`` aggregation backend in the PyTorch port against the JAX
reference (hydragnn_tpu/ops/aggregate.py: segment_sum_pallas,
segment_sum_sorted, run in interpret mode on the CPU).

The port computes both with one CSR segment-sum kernel (csrc/fused_mp.cu);
on the CPU its plain version (``index_add_``) runs.  Held at 1e-5: the
forward and the VJP (a gather, zero where the forward dropped a row) at
the shapes of tests/test_aggr_backends.py, out-of-range ids included; the
kernel's schedule (a stable sort of the ids, out-of-range ids parked after
the last segment, CSR offsets) walked in Python as the kernel walks it;
and SchNet under the backend, which reaches the pallas segment sum in
each conv and in the pool.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.ops import aggregate as jagg
from hydragnn_torch.ops import aggregate as tagg
from hydragnn_torch.ops import fused_mp as tfm

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(e=70, n=13, f=5, seed=0, oob=True):
    rng = np.random.RandomState(seed)
    data = rng.randn(e, f).astype(np.float32)
    ids = rng.randint(0, n, size=e)
    if oob:  # padded edges scatter out of range and must vanish
        ids[-7:] = n + rng.randint(0, 3, size=7)
        ids[3] = -1
    return data, ids.astype(np.int32), n


def _sorted_case(n=600, max_deg=12, f=7, seed=0):
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, max_deg + 1, size=n)
    ids = np.repeat(np.arange(n), counts).astype(np.int32)
    data = rng.randn(len(ids), f).astype(np.float32)
    return data, ids, n, max_deg


def _forward_and_vjp(fn, data, ids, n, w):
    t = torch.from_numpy(data).requires_grad_(True)
    out = fn(t, torch.from_numpy(ids), n)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), t.grad.numpy()


def _jax_forward_and_vjp(fn, data, ids, n, w):
    def loss(d):
        return jnp.sum(fn(d, jnp.asarray(ids), n) * w)

    d = jnp.asarray(data)
    return np.asarray(fn(d, jnp.asarray(ids), n)), np.asarray(
        jax.grad(loss)(d))


@pytest.mark.parametrize("e,n,f,oob", [(70, 13, 5, True), (40, 9, 1, True),
                                       (300, 37, 64, False)],
                         ids=["oob", "narrow", "in-range"])
def test_segment_sum_pallas_matches_jax(e, n, f, oob):
    data, ids, n = _case(e, n, f, seed=e, oob=oob)
    w = np.random.RandomState(2).randn(n, f).astype(np.float32)
    got = _forward_and_vjp(tagg.segment_sum_pallas, data, ids, n, w)
    want = _jax_forward_and_vjp(jagg.segment_sum_pallas, data, ids, n, w)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)
    if oob:
        drop = (ids < 0) | (ids >= n)
        assert np.all(got[1][drop] == 0.0)


@pytest.mark.parametrize("n", [600, 2500])
def test_segment_sum_sorted_matches_jax(n):
    data, ids, n, k = _sorted_case(n=n)
    w = np.random.RandomState(1).randn(n, data.shape[1]).astype(np.float32)
    got = _forward_and_vjp(
        lambda d, i, s: tagg.segment_sum_sorted(d, i, s, k), data, ids, n, w)
    want = _jax_forward_and_vjp(
        lambda d, i, s: jagg.segment_sum_sorted(d, i, s, k), data, ids, n, w)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)


def test_segment_sum_sorted_on_collated_receivers():
    """Collate's receivers with the padded tail (all on node N-1), the
    data pre-masked as the contract asks."""
    from hydragnn_torch.graph.batch import GraphSample, HeadSpec, PadSpec, \
        collate
    from hydragnn_torch.graph.neighborlist import radius_graph

    rng = np.random.RandomState(2)
    samples = []
    for _ in range(6):
        pos = rng.rand(10, 3).astype(np.float32) * 2.5
        samples.append(GraphSample(
            x=rng.rand(10, 1).astype(np.float32), pos=pos,
            edge_index=radius_graph(pos, 1.3, 8),
            graph_y=rng.rand(1).astype(np.float32)))
    b = collate(samples, PadSpec.for_batch(6, 12, 90),
                [HeadSpec("e", "graph", 1)])
    data = (rng.randn(b.num_edges, 5).astype(np.float32)
            * b.edge_mask.numpy()[:, None])
    got = tagg.segment_sum_sorted(torch.from_numpy(data), b.receivers,
                                  b.num_nodes, 8)
    want = jagg.segment_sum_sorted(jnp.asarray(data),
                                   jnp.asarray(b.receivers.numpy()),
                                   b.num_nodes, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _csr_walk(data, perm, row_ptr, n, cap=None):
    """The kernel's loop in Python: segment s sums data[perm[r]] for r in
    [row_ptr[s], row_ptr[s+1]) (its first ``cap`` rows), in order, in
    float32."""
    out = np.zeros((n, data.shape[1]), np.float32)
    for s in range(n):
        end = int(row_ptr[s + 1])
        if cap is not None:
            end = min(end, int(row_ptr[s]) + cap)
        for r in range(int(row_ptr[s]), end):
            out[s] += data[int(perm[r]) if perm is not None else r]
    return out


def test_kernel_schedule_covers_each_row_once():
    """The unsorted function's schedule: every in-range row in exactly one
    segment's range, in edge order within it; out-of-range rows in none.
    Walked as the kernel walks it, it gives the plain version's sums."""
    data, ids, n = _case(seed=5)
    perm, row_ptr = tagg.sort_schedule(torch.from_numpy(ids), n)
    perm, row_ptr = perm.numpy(), row_ptr.numpy()
    assert perm.dtype == np.int32 and row_ptr.dtype == np.int32
    ok = (ids >= 0) & (ids < n)
    covered = perm[:row_ptr[n]]
    assert sorted(covered.tolist()) == np.flatnonzero(ok).tolist()
    for s in range(n):
        seg = perm[row_ptr[s]:row_ptr[s + 1]]
        assert np.all(ids[seg] == s) and np.all(np.diff(seg) > 0)
    want = tfm.segment_sum_dense_plain(torch.from_numpy(data),
                                      torch.from_numpy(ids), n).numpy()
    np.testing.assert_allclose(_csr_walk(data, perm, row_ptr, n), want,
                               **TOL)
    # the sorted function needs no permutation; its cap drops the rows of
    # a segment past the first max_per_segment, in the kernel's walk and in
    # the plain version alike
    sdata, sids, sn, _ = _sorted_case(n=50)
    ptr = tagg.segment_offsets(torch.from_numpy(sids), sn).numpy()
    for cap in (None, 3):
        want = tfm.segment_sum_dense_plain(
            torch.from_numpy(sdata), torch.from_numpy(sids), sn,
            max_per_segment=cap).numpy()
        np.testing.assert_allclose(_csr_walk(sdata, None, ptr, sn, cap), want,
                                   **TOL)
    full = tfm.segment_sum_dense_plain(torch.from_numpy(sdata),
                                       torch.from_numpy(sids), sn).numpy()
    assert not np.allclose(want, full)


def test_schnet_under_the_pallas_backend(monkeypatch):
    """SchNet under ``HYDRAGNN_AGGR_BACKEND=pallas``: the same outputs and
    gradients as under ``scatter`` (1e-5), and per forward 5 calls of
    segment_sum_pallas (4 conv aggregations and the pool) — what the card
    counts as launches per train step and per eval batch."""
    from hydragnn_torch.models.base import GraphHeadCfg, ModelConfig
    from hydragnn_torch.models.create import create_model
    from test_torch_schnet import _batches, _samples

    cfg = ModelConfig(
        model_type="SchNet", input_dim=1, hidden_dim=8, output_dim=(1,),
        output_type=("graph",), graph_head=GraphHeadCfg(1, 8, 1, (8,)),
        node_head=None, task_weights=(1.0,), num_conv_layers=4,
        num_gaussians=6, num_filters=8, radius=1.6, max_neighbours=10)
    raw = _samples(1.6, 10, 12, n_graphs=4, seed=6)
    runs = {}
    for backend in ("scatter", "pallas"):
        monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", backend)
        _, gt = _batches(raw, [("energy", "graph", 1)])
        assert "edge_perm_sender" not in gt.extras
        model = create_model(cfg, seed=0)
        calls = []
        real = tagg.segment_sum_pallas

        def counted(*a, _real=real, _calls=calls):
            _calls.append(a[0].shape)
            return _real(*a)

        monkeypatch.setattr(tagg, "segment_sum_pallas", counted)
        out = model(gt)[0]
        out.square().sum().backward()
        runs[backend] = (out.detach(), [p.grad for p in model.parameters()],
                         len(calls))
        monkeypatch.setattr(tagg, "segment_sum_pallas", real)
    assert runs["scatter"][2] == 0 and runs["pallas"][2] == 5
    torch.testing.assert_close(runs["pallas"][0], runs["scatter"][0], **TOL)
    for a, b in zip(runs["pallas"][1], runs["scatter"][1]):
        torch.testing.assert_close(a, b, **TOL)
