"""GAT and its fused GATv2 edge attention in the PyTorch port against the
JAX reference (hydragnn_tpu/ops/gat_mp.py, hydragnn_tpu/models/gat.py).

The reference runs its Pallas kernels in interpret mode on the CPU; the
port runs the plain versions of its three CUDA kernels (forward, pass R,
pass S).  Inputs as in tests/test_gat_fused.py (H = 4, F = 8, 6 graphs of 9
nodes, a masked edge tail, two nodes with no edge), plus H = 3, F = 12, a
width that does not divide 32.  Tolerances: the op 1e-5 (forward, and
every gradient against JAX's and against autograd through the plain
forward); the model 1e-4 (forward in training mode, every parameter
gradient, the updated BatchNorm statistics, the eval forward on them).
JAX's matmuls run at full float32 precision here
(``jax.default_matmul_precision("highest")``): the reference's interpret
mode gathers through one-hot matmuls.

Also: ``segment_softmax``, the tiled path, the width gate and the tally,
the dropout bits of a train step, ``train_validate_test`` from one init,
a port-written ``.pk`` read by both ``run_prediction``s, the weight round
trip through ``tools/port_weights.port_state_dict`` and ``finalize`` for
the configurations ``chip_smoke.py`` runs.
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
from hydragnn_tpu.graph import segment as jseg
from hydragnn_tpu.graph.neighborlist import radius_graph
from hydragnn_tpu.models import base as jbase
from hydragnn_tpu.models import gat as jgat
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.models.create import init_model
from hydragnn_tpu.ops import gat_mp as jgm
from hydragnn_torch.graph import batch as tb
from hydragnn_torch.graph import segment as tseg
from hydragnn_torch.models import base as tbase
from hydragnn_torch.models import gat as tgat
from hydragnn_torch.models.create import create_model as t_create_model
from hydragnn_torch.ops import gat_mp as tgm
from hydragnn_torch.telemetry import pipeline
from hydragnn_torch.utils.weights import (
    flax_batch_stats_from_module,
    flax_params_from_module,
    load_flax_params,
)
from test_torch_archs import _train_eval_and_grads
from tools.port_weights import port_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOPE = 0.05
OP_TOL = dict(rtol=1e-5, atol=1e-5)
WIDTHS = [(4, 8), (3, 12)]   # (H, F); 12 does not divide 32


@pytest.fixture(autouse=True)
def _full_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _raw(n_graphs=6, nodes=9, seed=0, isolate=True, node_dim=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n_graphs):
        pos = rng.rand(nodes, 3).astype(np.float32) * 2.2
        if isolate and i == 1:
            pos[-2:] += 50.0  # two nodes with no incident edge
        x = rng.rand(nodes, 2).astype(np.float32)
        out.append(dict(
            x=x, pos=pos, edge_index=radius_graph(pos, 1.4, 8),
            graph_y=rng.rand(1).astype(np.float32),
            node_y=rng.rand(nodes, node_dim).astype(np.float32)
            if node_dim else x))
    return out


def _collate(raw, heads, pkg, monkeypatch, backend="fused"):
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", backend)
    ss = [pkg.GraphSample(**r) for r in raw]
    pad = pkg.PadSpec.for_batch(len(ss), max(s.num_nodes for s in ss),
                                max(s.num_edges for s in ss))
    return pkg.collate(ss, pad, [pkg.HeadSpec(*h) for h in heads])


def _op_case(monkeypatch, h, f, seed, bits):
    g = _collate(_raw(seed=seed), [("e", "graph", 1)], jb, monkeypatch)
    rng = np.random.RandomState(seed + 1)
    n, e = g.x.shape[0], g.senders.shape[0]
    xl = rng.randn(n, h * f).astype(np.float32)
    xr = rng.randn(n, h * f).astype(np.float32)
    att = (rng.randn(h, f) * 0.5).astype(np.float32)
    b = np.ones((e, h), np.float32)
    if bits:
        b = ((rng.rand(e, h) > 0.25).astype(np.float32) / 0.75)
    ca = rng.randn(n, h * f).astype(np.float32)
    cd = rng.randn(n, h).astype(np.float32)
    em = np.asarray(g.edge_mask)
    assert (em == 0).any()  # a masked tail
    ids = dict(s=np.asarray(g.senders), r=np.asarray(g.receivers),
               p=np.asarray(g.extras["edge_perm_sender"]), em=em)
    return ids, xl, xr, att, b, ca, cd


def _att_mat(att):
    h, f = att.shape
    rows = jnp.arange(h * f)
    return jnp.zeros((h * f, h), jnp.float32).at[rows, rows // f].set(
        att.reshape(-1))


def _jax_op(ids, xl, xr, att, b):
    """JAX's op (interpret mode) and its gradients wrt xl, xr and the att
    parameter under the loss sum(acc * ca) + sum(d * cd)."""
    f = att.shape[1]

    def run(xl_, xr_, att_, ca, cd):
        acc, m, d = jgm.gat_edge_attention(
            xl_, xr_, _att_mat(att_), jnp.asarray(ids["s"]),
            jnp.asarray(ids["r"]), jnp.asarray(ids["p"]),
            jnp.asarray(ids["em"]), jnp.asarray(b), (SLOPE, f))
        return jnp.sum(acc * ca) + jnp.sum(d * cd), (acc, m, d)

    return run


def _torch_args(ids, b):
    return (torch.from_numpy(ids["s"]), torch.from_numpy(ids["r"]),
            torch.from_numpy(ids["p"]), torch.from_numpy(ids["em"]),
            torch.from_numpy(b))


@pytest.mark.parametrize("bits", [False, True], ids=["ones", "dropout"])
@pytest.mark.parametrize("h,f", WIDTHS, ids=["H4F8", "H3F12"])
def test_plain_forward_matches_jax(h, f, bits, monkeypatch):
    """acc, m and d of the plain forward against JAX's op within 1e-5; rows
    with no real edge give m = -1e9 (equal), d = 0, acc = 0."""
    ids, xl, xr, att, b, ca, cd = _op_case(monkeypatch, h, f, 3, bits)
    _, (jacc, jm, jd) = _jax_op(ids, xl, xr, att, b)(
        jnp.asarray(xl), jnp.asarray(xr), jnp.asarray(att), ca, cd)
    s, r, _, em, tb_ = _torch_args(ids, b)
    acc, m, d = tgm.gat_edge_attention_reference(
        torch.from_numpy(xl), torch.from_numpy(xr), torch.from_numpy(att),
        s, r, em, tb_, SLOPE)
    empty = np.bincount(ids["r"][ids["em"] != 0],
                        minlength=xl.shape[0]) == 0
    assert empty.sum() >= 2
    np.testing.assert_array_equal(m.numpy()[empty], np.asarray(jm)[empty])
    assert np.all(m.numpy()[empty] == np.float32(-1e9))
    assert np.all(d.numpy()[empty] == 0) and np.all(acc.numpy()[empty] == 0)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **OP_TOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **OP_TOL)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), **OP_TOL)


@pytest.mark.parametrize("bits", [False, True], ids=["ones", "dropout"])
@pytest.mark.parametrize("h,f", WIDTHS, ids=["H4F8", "H3F12"])
def test_passes_match_jax_and_autograd(h, f, bits, monkeypatch):
    """The op's backward (pass R and pass S, plain versions) against JAX's
    gradients wrt xl, xr and att (through att_mat) and against autograd
    through the plain forward, within 1e-5; no kernel launches on the
    CPU; exact zeros on rows whose only edges are masked."""
    ids, xl, xr, att, b, ca, cd = _op_case(monkeypatch, h, f, 5, bits)
    (_, _), jgrads = jax.value_and_grad(
        _jax_op(ids, xl, xr, att, b), argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(xl), jnp.asarray(xr), jnp.asarray(att), ca, cd)
    s, r, p, em, tb_ = _torch_args(ids, b)
    tca, tcd = torch.from_numpy(ca), torch.from_numpy(cd)
    tgm.reset_launches()
    grads = []
    for fn in (lambda *a: tgm.gat_edge_attention(*a[:5], p, *a[5:], f),
               lambda *a: tgm.gat_edge_attention_reference(*a)):
        ts = [torch.from_numpy(a).requires_grad_(True)
              for a in (xl, xr, att)]
        acc, m, d = fn(*ts, s, r, em, tb_, SLOPE)
        assert not m.requires_grad
        ((acc * tca).sum() + (d * tcd).sum()).backward()
        grads.append([t.grad for t in ts])
    assert all(v == 0 for v in tgm.LAUNCHES.values())
    for name, got, ref, want in zip(("dxl", "dxr", "datt"), grads[0],
                                    grads[1], jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **OP_TOL)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5,
                                   msg=name)
    # rows with no real edge in either role get exactly zero
    real = ids["em"] != 0
    n = xl.shape[0]
    lone = ((np.bincount(ids["s"][real], minlength=n) == 0)
            & (np.bincount(ids["r"][real], minlength=n) == 0))
    assert lone.sum() >= 2
    # dxl of a lone row is zero from the edges (dacc reaches it only
    # through the merge, which this loss does not have)
    assert np.all(grads[0][0].numpy()[lone] == 0)
    assert np.all(grads[0][1].numpy()[lone] == 0)


def test_passes_written_out_match_autograd(monkeypatch):
    """gat_pass_r_plain / gat_pass_s_plain called directly, as chip_smoke.py
    times them, against autograd through the plain forward."""
    ids, xl, xr, att, b, ca, cd = _op_case(monkeypatch, 3, 12, 7, True)
    s, r, _, em, tb_ = _torch_args(ids, b)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (xl, xr, att)]
    acc, m, d = tgm.gat_edge_attention_reference(*ts, s, r, em, tb_, SLOPE)
    ga, gd = torch.from_numpy(ca), torch.from_numpy(cd)
    ((acc * ga).sum() + (d * gd).sum()).backward()
    args = (*(t.detach() for t in ts), s, r, em, tb_, m, ga, gd, SLOPE)
    dxr, datt = tgm.gat_pass_r_plain(*args)
    dxl = tgm.gat_pass_s_plain(*args)
    for name, got, want in (("dxl", dxl, ts[0].grad), ("dxr", dxr, ts[1].grad),
                            ("datt", datt, ts[2].grad)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5, msg=name)


def test_logits_sum_each_head_in_lane_order():
    """edge_logits adds each head's F products one after another, in lane
    order (the kernels' order, which makes their m equal the plain
    version's bit for bit), and differs from a pairwise sum only by
    rounding."""
    rng = np.random.RandomState(0)
    h, f = 3, 12
    xs = torch.from_numpy(rng.randn(40, h * f).astype(np.float32))
    xt = torch.from_numpy(rng.randn(40, h * f).astype(np.float32))
    att = torch.from_numpy(rng.randn(h, f).astype(np.float32))
    e, z, zl = tgm.edge_logits(xs, xt, att, SLOPE)
    prod = (zl.reshape(-1, h, f) * att).numpy()
    want = prod[:, :, 0].copy()
    for k in range(1, f):
        want = (want + prod[:, :, k]).astype(np.float32)
    np.testing.assert_array_equal(e.numpy(), want)
    np.testing.assert_allclose(e.numpy(), prod.sum(-1), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(zl, torch.nn.functional.leaky_relu(z, SLOPE))


def test_backward_refuses_a_second_order(monkeypatch):
    ids, xl, xr, att, b, _, _ = _op_case(monkeypatch, 4, 8, 9, False)
    s, r, p, em, _ = _torch_args(ids, b)
    x = torch.from_numpy(xl).requires_grad_(True)
    acc, _, _ = tgm.gat_edge_attention(x, torch.from_numpy(xr),
                                       torch.from_numpy(att), s, r, p, em,
                                       None, SLOPE, 8)
    with pytest.raises(RuntimeError, match="not differentiable twice"):
        torch.autograd.grad(acc.square().sum(), (x,), create_graph=True)
    with pytest.raises(ValueError, match="per-head width"):
        tgm.gat_edge_attention(x, x, torch.from_numpy(att), s, r, p, em,
                               None, SLOPE, 4)


def test_tiled_matches_untiled(monkeypatch):
    """gat_edge_attention_tiled with FUSED_HF_LIMIT forced to 2F (two head
    groups) against the one-call op: forward and every gradient."""
    ids, xl, xr, att, b, ca, cd = _op_case(monkeypatch, 4, 8, 13, True)
    s, r, p, em, tb_ = _torch_args(ids, b)

    def run():
        ts = [torch.from_numpy(a).requires_grad_(True)
              for a in (xl, xr, att)]
        out = tgm.gat_edge_attention_tiled(*ts[:3], s, r, p, em, tb_,
                                           SLOPE, 8)
        ((out[0] * torch.from_numpy(ca)).sum()
         + (out[2] * torch.from_numpy(cd)).sum()).backward()
        return [o.detach() for o in out], [t.grad for t in ts]

    ref_out, ref_grads = run()
    monkeypatch.setattr(tgm, "FUSED_HF_LIMIT", 16)
    assert tgm._head_groups(4, 8) == [2, 2]
    assert tgm._head_groups(6, 3) == [3, 3]
    calls = []
    orig = tgm.gat_edge_attention
    monkeypatch.setattr(tgm, "gat_edge_attention",
                        lambda *a: calls.append(a[0].shape) or orig(*a))
    out, grads = run()
    assert calls == [(xl.shape[0], 16)] * 2
    for name, a, c in zip(("acc", "m", "d", "dxl", "dxr", "datt"),
                          out + grads, ref_out + ref_grads):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5, msg=name)


@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "no-mask"])
def test_segment_softmax_matches_jax(with_mask):
    """segment_softmax (graph/segment.py) against the reference's, with a
    mask and with empty segments: values and the gradient of a weighted
    sum, 1e-5."""
    rng = np.random.RandomState(2)
    e, n = 40, 9
    ids = np.sort(rng.randint(0, n - 3, e)).astype(np.int32)  # 3 empty
    logits = (rng.randn(e, 3) * 4).astype(np.float32)
    mask = (rng.rand(e) > 0.3).astype(np.float32) if with_mask else None
    w = rng.randn(e, 3).astype(np.float32)

    def jloss(x):
        out = jseg.segment_softmax(x, jnp.asarray(ids), n,
                                   None if mask is None else jnp.asarray(mask))
        return jnp.sum(out * w), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    out = tseg.segment_softmax(x, torch.from_numpy(ids), n,
                               None if mask is None else torch.from_numpy(mask))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **OP_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), **OP_TOL)
    if mask is not None:
        assert np.all(out.detach().numpy()[mask == 0] == 0)
    # each non-empty segment's real weights sum to one
    sums = np.zeros((n, 3))
    np.add.at(sums, ids, out.detach().numpy())
    live = np.bincount(ids[(mask if mask is not None else np.ones(e)) > 0],
                       minlength=n) > 0
    np.testing.assert_allclose(sums[live], 1.0, rtol=1e-6)
    assert np.all(sums[~live] == 0)


# --- the model ----------------------------------------------------------------


def _cfgs(hidden=8, convs=3, dropout=0.0, node_head=None, heads=6):
    graph = jbase.GraphHeadCfg(2, hidden, 2, (hidden, hidden))
    kw = dict(model_type="GAT", input_dim=2, hidden_dim=hidden,
              output_dim=(1,), output_type=("graph",), graph_head=graph,
              node_head=None, task_weights=(1.0,), num_conv_layers=convs,
              dropout=dropout, gat_heads=heads)
    if node_head is not None:
        kw.update(output_dim=(1, 2), output_type=("graph", "node"),
                  task_weights=(1.0, 2.0), node_head=node_head)
    tkw = dict(kw)
    tkw["graph_head"] = tbase.GraphHeadCfg(*dataclasses.astuple(graph))
    if node_head is not None:
        tkw["node_head"] = tbase.NodeHeadCfg(*dataclasses.astuple(node_head))
    return jbase.ModelConfig(**kw), tbase.ModelConfig(**tkw)


def _models(monkeypatch, backend, seed=0, **kw):
    node = kw.get("node_head") is not None
    heads = [("energy", "graph", 1)] + ([("n", "node", 2)] if node else [])
    raw = _raw(n_graphs=4, seed=seed, node_dim=2 if node else 0)
    gj = _collate(raw, heads, jb, monkeypatch, backend)
    gt = _collate(raw, heads, tb, monkeypatch, backend)
    jc, tc = _cfgs(**kw)
    jm = j_create_model(jc)
    variables = jax.tree.map(np.asarray, init_model(jm, gj, seed=0))
    tm = t_create_model(tc)
    load_flax_params(tm, variables["params"], variables["batch_stats"])
    return jm, variables, tm, gj, gt


def _inject_bits(monkeypatch, n_layers, e, n, h, seed=0):
    """The same dropout bits on both sides, one pair per layer in call
    order (training only): keep 0.75, scaled by 1/keep."""
    rng = np.random.RandomState(seed)
    table = [((rng.rand(e, h) < 0.75).astype(np.float32) / 0.75,
              (rng.rand(n, h) < 0.75).astype(np.float32) / 0.75)
             for _ in range(n_layers)]
    calls = {"jax": 0, "torch": 0}

    def jbits(self, train, e_count, n_, dtype):
        if not train:
            return None, None
        be, bs = table[calls["jax"] % n_layers]
        calls["jax"] += 1
        return jnp.asarray(be), jnp.asarray(bs)

    def tbits(self, e_count, n_, device, dtype):
        if not self.training:
            return None, None
        be, bs = table[calls["torch"] % n_layers]
        calls["torch"] += 1
        return (torch.from_numpy(be).to(device, dtype),
                torch.from_numpy(bs).to(device, dtype))

    monkeypatch.setattr(jgat.GATv2Conv, "_dropout_bits", jbits)
    monkeypatch.setattr(tgat.GATv2Conv, "_dropout_bits", tbits)
    return calls


@pytest.mark.parametrize("case", ["dropout0", "bits", "conv-head"])
@pytest.mark.parametrize("backend", ["scatter", "fused"])
def test_gat_forward_grads_and_stats_match_jax(backend, case, monkeypatch):
    """GATStack (hidden 8, 6 heads, 3 convs: two concat layers whose
    BatchNorm normalises 48 features, then the averaged one) in training
    mode against JAX: outputs, every parameter gradient and the updated
    batch_stats within 1e-4, then the eval forward on them.  At dropout 0,
    with identical injected dropout bits, and with a conv-type node head;
    under the composed (scatter) and the fused path."""
    kw = {}
    if case == "bits":
        kw["dropout"] = 0.25
    if case == "conv-head":
        kw["node_head"] = jbase.NodeHeadCfg(2, (4, 4), "conv")
    jm, variables, tm, gj, gt = _models(monkeypatch, backend, **kw)
    assert ("edge_perm_sender" in gt.extras) == (backend == "fused")
    assert variables["batch_stats"]["encoder_bn_0"]["mean"].shape == (48,)
    assert variables["batch_stats"]["encoder_bn_2"]["mean"].shape == (8,)
    convs = 3 + (3 if case == "conv-head" else 0)
    calls = None
    if case == "bits":
        calls = _inject_bits(monkeypatch, convs, gt.senders.shape[0],
                             gt.x.shape[0], 6)
    before = pipeline.dispatch_snapshot()
    _train_eval_and_grads(jm, variables, tm, gj, gt)
    delta = pipeline.dispatch_delta(before, pipeline.dispatch_snapshot())
    label = "fused" if backend == "fused" else "scatter"
    assert delta[f"gat_attn:{label}"] == 2 * convs  # train + eval forward
    assert not any(k.startswith("gat_attn:") and k != f"gat_attn:{label}"
                   for k in delta)
    if calls is not None:
        assert calls["torch"] == convs and calls["jax"] >= convs


def test_gat_train_step_bits_follow_the_step_seed(monkeypatch):
    """Training draws the bits from a generator seeded with the step's
    seed, each layer its own stream: two models from one init give equal
    steps; eval draws nothing; training without a seed raises."""
    from hydragnn_torch.train.optimizer import select_optimizer
    from hydragnn_torch.train.trainer import (
        create_train_state,
        dropout_seed,
        make_train_step,
    )

    _, tc = _cfgs(dropout=0.5)
    gt = _collate(_raw(n_graphs=4, seed=2), [("energy", "graph", 1)], tb,
                  monkeypatch)
    seen = []
    orig = tgat.GATv2Conv._dropout_bits

    def spy(self, *a):
        out = orig(self, *a)
        seen.append((self.dropout_seed, None if out[0] is None
                     else out[0].clone()))
        return out

    monkeypatch.setattr(tgat.GATv2Conv, "_dropout_bits", spy)
    runs = []
    for _ in range(2):
        model = t_create_model(tc, seed=1)
        spec = select_optimizer({"type": "AdamW", "learning_rate": 1e-3})
        state = create_train_state(model, spec)
        step = make_train_step(model, tc, spec)
        losses = []
        for _ in range(2):
            state, m = step(state, gt)
            losses.append(float(m["loss"]))
        runs.append(losses)
    assert runs[0] == runs[1]
    seeds = [s for s, _ in seen[:6]]
    assert seeds == [(dropout_seed(k) << 8) | i for k in (0, 1)
                     for i in range(3)]
    assert len(set(seeds)) == 6
    assert not torch.equal(seen[0][1], seen[1][1])   # layers differ
    assert not torch.equal(seen[0][1], seen[3][1])   # steps differ
    b = seen[0][1]
    assert set(np.unique(b.numpy())) <= {0.0, 2.0}
    seen.clear()
    model.eval()
    with torch.no_grad():
        model(gt)
    assert [out for _, out in seen] == [None] * 3
    model.train()
    with pytest.raises(RuntimeError, match="dropout_seed"):
        model(gt)


def test_single_over_wide_head_falls_back(monkeypatch):
    """Only a single head wider than FUSED_HF_LIMIT forces the composed
    path (tallied gat_attn:scatter), with the same outputs; a wide layer
    of narrow heads stays fused through the tiling."""
    jm, variables, tm, gj, gt = _models(monkeypatch, "fused")
    tm.eval()

    def tally():
        before = pipeline.dispatch_snapshot()
        with torch.no_grad():
            out = tm(gt)[0].numpy()
        got = pipeline.dispatch_delta(before, pipeline.dispatch_snapshot())
        return out, {k: v for k, v in got.items()
                     if k.startswith("gat_attn:")}

    fused_out, counts = tally()
    assert counts == {"gat_attn:fused": 3}
    monkeypatch.setattr(tgm, "FUSED_HF_LIMIT", 16)   # 6 heads of 8: tiled
    tiled_out, counts = tally()
    assert counts == {"gat_attn:fused": 3}
    monkeypatch.setattr(tgm, "FUSED_HF_LIMIT", 4)    # < F = 8
    composed_out, counts = tally()
    assert counts == {"gat_attn:scatter": 3}
    want = np.asarray(jm.apply(variables, gj, train=False)[0])
    for got in (fused_out, tiled_out, composed_out):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    monkeypatch.setattr(tgm, "FUSED_HF_LIMIT", 1024)
    monkeypatch.setenv("HYDRAGNN_GAT_FUSED", "0")
    _, counts = tally()
    assert counts == {"gat_attn:scatter": 3}


def test_create_warns_for_wide_dropout():
    """The reference's create-time warning: attention dropout at
    hidden * heads >= 256."""
    _, tc = _cfgs(hidden=64, dropout=0.25)
    with pytest.warns(UserWarning, match="dropout"):
        t_create_model(tc)
    _, tc = _cfgs(hidden=64, dropout=0.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t_create_model(tc)


def test_weights_round_trip_through_port_weights(monkeypatch):
    """The port's state_dict carries the reference checkpoint keys
    (lin_l, lin_r, att, bias, the BatchNorms): the repo's torch->flax
    porter rebuilds the JAX params and batch_stats from it exactly."""
    jm, variables, tm, gj, gt = _models(monkeypatch, "scatter")
    tm.train()
    tm(gt)
    stats = flax_batch_stats_from_module(tm)
    ported = port_state_dict(tm.state_dict(), "GAT",
                             {"params": variables["params"],
                              "batch_stats": variables["batch_stats"]})
    for got, want in ((ported["params"], variables["params"]),
                      (flax_params_from_module(tm), variables["params"]),
                      (ported["batch_stats"], stats)):
        assert jax.tree_util.tree_structure(
            jax.tree.map(np.asarray, got)) == \
            jax.tree_util.tree_structure(want)
        for a, c in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
    assert tm.state_dict()["graph_convs.0.att"].shape == (1, 6, 8)


# --- the training loop and the checkpoints -----------------------------------


def _gat_config(name, epochs, lr=1e-3):
    with open(os.path.join(REPO, "tests", "inputs", "ci.json")) as f:
        config = json.load(f)
    ds = config["Dataset"]
    ds.update(name=name, path={"total": f"dataset/{name}"},
              compositional_stratified_splitting=False)
    config["NeuralNetwork"]["Architecture"].update(
        model_type="GAT", hidden_dim=8, num_conv_layers=2, radius=2.0,
        max_neighbours=20, dropout=0.0)
    tr = config["NeuralNetwork"]["Training"]
    tr.update(num_epoch=epochs, batch_size=16, EarlyStopping=True,
              patience=2, Checkpoint=True, checkpoint_warmup=1)
    tr["Optimizer"] = {"type": "AdamW", "learning_rate": lr}
    return config


def test_gat_train_validate_test_tracks_jax(monkeypatch, tmp_path):
    """Same init (weights and BatchNorm statistics), same batches, dropout
    0: the reference (scatter, one device) and the port (fused: the
    attention op over its plain versions) give the same per-epoch losses
    and the same learning-rate, early-stop and checkpoint decisions.  At
    lr 1e-3: at 2e-2, as the PNA test runs, two correct float32 runs of
    GAT part past 1e-4 within five epochs (the port's own scatter and
    fused runs by 7e-3: BatchNorm under Adam, as for PNA)."""
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
    name = "torch_port_gat_train"
    generate_cached(name, f"dataset/{name}", 120)
    config = _gat_config(name, epochs=4, lr=1e-3)
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
    assert cfg.dropout == 0.0 and cfg.gat_heads == 6
    model = t_create_model(cfg)
    load_flax_params(model, params0, stats0)
    tspec = t_opt(tcfg["NeuralNetwork"]["Training"]["Optimizer"])
    state = ttr.create_train_state(model, tspec)
    before = pipeline.dispatch_snapshot()
    state, th = ttr.train_validate_test(
        model, cfg, state, tspec, ttrain, tval, ttest,
        tcfg["NeuralNetwork"], log_name, logs_dir=str(tmp_path / "torch"),
        device=torch.device("cpu"))
    delta = pipeline.dispatch_delta(before, pipeline.dispatch_snapshot())
    assert delta.get("gat_attn:fused", 0) > 0
    assert "gat_attn:scatter" not in delta

    for k in ("train", "val", "test"):
        np.testing.assert_allclose(th[k], jh[k], rtol=1e-4, err_msg=k)
    assert th["lr"] == jh["lr"]
    assert len(th["train"]) == len(jh["train"])
    assert tsaves == jsaves and True in tsaves
    assert state.step == len(th["train"]) * len(ttrain)


def test_gat_checkpoint_read_by_both_packages(monkeypatch, tmp_path):
    """A GAT ``.pk`` (with the 48-wide BatchNorm statistics) written by the
    port's ``run_training`` under fused is read by both
    ``run_prediction``s, which agree at 1e-4."""
    import hydragnn_tpu
    import hydragnn_torch
    from ci_data import generate_cached
    from hydragnn_torch.serve.engine import load_inference_state

    monkeypatch.setenv("HYDRAGNN_AUTO_PIPELINE", "0")
    monkeypatch.delenv("HYDRAGNN_AGGR_BACKEND", raising=False)
    monkeypatch.setattr(jax, "local_devices",
                        lambda *a, **k: jax.devices()[:1])
    name = "torch_port_gat_ckpt"
    generate_cached(name, f"dataset/{name}", 64)
    config = _gat_config(name, epochs=2)
    config["NeuralNetwork"]["Architecture"]["dropout"] = 0.25
    tconfig = copy.deepcopy(config)
    tconfig["NeuralNetwork"]["Architecture"]["aggregation_backend"] = "fused"
    logs = str(tmp_path / "torch")
    _, hist, fcfg = hydragnn_torch.run_training(tconfig, logs_dir=logs,
                                                device="cpu")
    assert len(hist["train"]) == 2 and all(np.isfinite(hist["train"]))
    st = load_inference_state(fcfg, logs)
    assert st.batch_stats["encoder_bn_0"]["mean"].shape == (48,)
    got = hydragnn_torch.run_prediction(copy.deepcopy(config), logs_dir=logs,
                                        device="cpu")
    want = hydragnn_tpu.run_prediction(copy.deepcopy(config), logs_dir=logs)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    for t, j in zip(got[3], want[3]):
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("which", ["gat", "gat_h256"])
def test_finalize_parity_for_the_chip_configurations(which):
    from chip_smoke import gat_config
    from hydragnn_tpu.config import config as jcfg
    from hydragnn_torch.config import config as tcfg

    rng = np.random.RandomState(0)
    samples = [jb.GraphSample(x=rng.rand(n, 3), pos=rng.rand(n, 3),
                              edge_index=np.stack([rng.randint(0, n, 9),
                                                   rng.randint(0, n, 9)]))
               for n in (4, 6, 5)]
    config = gat_config(256, dropout=0.25) if which == "gat_h256" \
        else gat_config()
    want = jcfg.finalize(copy.deepcopy(config),
                         jcfg.DatasetStats.from_samples(samples))
    got = tcfg.finalize(copy.deepcopy(config),
                        tcfg.DatasetStats.from_samples(samples))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    cfg = tbase.ModelConfig.from_config(got)
    jc = jbase.ModelConfig.from_config(want)
    assert cfg.model_type == "GAT" and cfg.gat_heads == jc.gat_heads == 6
    assert cfg.gat_negative_slope == jc.gat_negative_slope == 0.05
    assert cfg.dropout == jc.dropout == (0.25 if which == "gat_h256"
                                         else 0.0)
    assert cfg.hidden_dim == (256 if which == "gat_h256" else 64)
    hf = cfg.hidden_dim * cfg.gat_heads
    if which == "gat_h256":
        assert hf > tgm.FUSED_HF_LIMIT
        assert tgm._head_groups(6, 256) == jgm._head_groups(6, 256) == [3, 3]
    else:
        assert hf == 384 <= tgm.FUSED_HF_LIMIT
