"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; every test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so it also runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py sets up JAX for the rest of the
suite).  Tolerance 1e-5 at kernel level: float32 sums, the plain
version's ``index_add_`` adds in another order on the card; 1e-4 for the
edge-summed weight grads and at model level.  Covered: the forward
kernels, the backward (dx passes, the pool's gather), the three scf
kernels through their autograd Function, the SchNet forward, three
training steps at the flagship width and the wide one, the two poly
kernels at every width gate (forward and, through their autograd
Functions, backward with ties), and three PNA/GIN/SAGE/MFC training steps.
"""

import numpy as np
import pytest
import torch

from hydragnn_torch.ops import fused_mp as tfm

TOL = dict(rtol=1e-5, atol=1e-5)


def _graph_batch(seed, n_real=290, n_pad=304, e_pad=2560):
    """Collate-shaped arrays: contiguous graphs of <= 60 nodes (~3 node
    blocks in all), intra-graph edges sorted by receiver, some nodes with
    no incoming edge, padding edges parked on node N-1 with mask 0."""
    rng = np.random.RandomState(seed)
    send, recv, gid = [], [], []
    off, g = 0, 0
    while off < n_real:
        size = min(int(rng.randint(5, 61)), n_real - off)
        n_e = int(rng.randint(0, 6 * size + 1))
        dst = np.sort(rng.randint(0, max(size - 2, 1), n_e))  # last nodes: no in-edges
        src = rng.randint(0, size, n_e)
        send.append(src + off)
        recv.append(dst + off)
        gid.append(np.full(size, g))
        off += size
        g += 1
    send, recv = np.concatenate(send), np.concatenate(recv)
    e_real = len(send)
    assert e_real < e_pad
    senders = np.full(e_pad, n_pad - 1, np.int32)
    receivers = np.full(e_pad, n_pad - 1, np.int32)
    senders[:e_real], receivers[:e_real] = send, recv
    edge_mask = np.zeros(e_pad, np.float32)
    edge_mask[:e_real] = 1.0
    node_gid = np.full(n_pad, g, np.int32)
    node_gid[:n_real] = np.concatenate(gid)
    node_mask = np.zeros(n_pad, np.float32)
    node_mask[:n_real] = 1.0
    perm = np.argsort(senders, kind="stable").astype(np.int32)
    return dict(senders=senders, receivers=receivers, edge_mask=edge_mask,
                node_gid=node_gid, node_mask=node_mask, perm=perm,
                n_graphs=g + 1, rng=rng)



def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written kernels)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_match_plain_on_card(cuda):
    b = _graph_batch(5)
    n, e = len(b["node_gid"]), len(b["senders"])
    g = torch.Generator().manual_seed(0)
    x = torch.randn(n, 64, generator=g).to(cuda)
    w = (torch.randn(e, 64, generator=g) * _t(b["edge_mask"])[:, None]).to(cuda)
    send, recv = _t(b["senders"]).to(cuda), _t(b["receivers"]).to(cuda)
    mask = _t(b["edge_mask"]).to(cuda)
    tfm.reset_launches()
    with torch.inference_mode():
        k = tfm.gather_mul_segment_sum(x, w, send, recv, None, edge_valid=mask)
        p = tfm.gather_mul_segment_sum_plain(x, w, send, recv, edge_valid=mask)
        torch.cuda.synchronize()
        torch.testing.assert_close(k, p, **TOL)
        k = tfm.gather_segment_sum(x, send, recv, None, mask)
        p = tfm.gather_mul_segment_sum_plain(x, None, send, recv,
                                             edge_valid=mask, mask=mask)
        torch.cuda.synchronize()
        torch.testing.assert_close(k, p, **TOL)
        k = tfm.segment_sum_dense(w, recv, n, valid=mask)
        p = tfm.segment_sum_dense_plain(w, recv, n, valid=mask)
        torch.cuda.synchronize()
        torch.testing.assert_close(k, p, **TOL)
    assert tfm.LAUNCHES == {"gather_mul_segment_sum": 1,
                            "gather_mul_segment_sum_dx": 0,
                            "gather_segment_sum": 1,
                            "gather_segment_sum_dx": 0,
                            "segment_sum_dense": 1}


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda):
    b = _graph_batch(6, n_real=40, n_pad=48, e_pad=512)
    send, recv = _t(b["senders"]).to(cuda), _t(b["receivers"]).to(cuda)
    x = torch.randn(48, 8, device=cuda)
    w = torch.randn(512, 8, device=cuda)
    with pytest.raises(TypeError):
        tfm.gather_mul_segment_sum(x.double(), w.double(), send, recv, None)


def _grads(fn, inputs, ct):
    ts = [t.detach().clone().requires_grad_(True) for t in inputs]
    fn(*ts).backward(ct)
    return [t.grad for t in ts]


@pytest.mark.gpu
def test_backward_on_card_matches_plain(cuda):
    """The ops' backward on the card (dx: the kernel on the sender-sorted
    ordering, under its own launch count) against autograd through the
    plain versions on the card; dw on real edges."""
    b = _graph_batch(7)
    n, e = len(b["node_gid"]), len(b["senders"])
    g = torch.Generator().manual_seed(1)
    x = torch.randn(n, 64, generator=g).to(cuda)
    w = (torch.randn(e, 64, generator=g) * _t(b["edge_mask"])[:, None]).to(cuda)
    ct = torch.randn(n, 64, generator=g).to(cuda)
    send, recv = _t(b["senders"]).to(cuda), _t(b["receivers"]).to(cuda)
    perm, mask = _t(b["perm"]).to(cuda), _t(b["edge_mask"]).to(cuda)
    real = mask != 0
    tfm.reset_launches()
    k = _grads(lambda x_, w_: tfm.gather_mul_segment_sum(
        x_, w_, send, recv, perm, edge_valid=mask), (x, w), ct)
    p = _grads(lambda x_, w_: tfm.gather_mul_segment_sum_plain(
        x_, w_, send, recv, edge_valid=mask), (x, w), ct)
    torch.cuda.synchronize()
    torch.testing.assert_close(k[0], p[0], **TOL)
    torch.testing.assert_close(k[1][real], p[1][real], **TOL)
    k = _grads(lambda x_: tfm.gather_segment_sum(x_, send, recv, perm, mask),
               (x,), ct)
    p = _grads(lambda x_: tfm.gather_mul_segment_sum_plain(
        x_, None, send, recv, edge_valid=mask, mask=mask), (x,), ct)
    torch.testing.assert_close(k[0], p[0], **TOL)
    gid = _t(b["node_gid"]).to(cuda)
    cg = torch.randn(b["n_graphs"], 64, generator=g).to(cuda)
    k = _grads(lambda d: tfm.segment_sum_dense(d, gid, b["n_graphs"]),
               (x,), cg)
    p = _grads(lambda d: tfm.segment_sum_dense_plain(d, gid, b["n_graphs"]),
               (x,), cg)
    torch.testing.assert_close(k[0], p[0], **TOL)
    assert tfm.LAUNCHES["gather_mul_segment_sum_dx"] == 1
    assert tfm.LAUNCHES["gather_segment_sum_dx"] == 1
    assert tfm.LAUNCHES["segment_sum_dense"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("f,gd", [(256, 50), (384, 127), (512, 127),
                                  (1024, 127)])
def test_scf_kernels_match_plain_on_card(cuda, f, gd):
    """The three scf kernels (forward, pass P, pass S) through the autograd
    Function against autograd through the composed plain version, at the
    wide SchNet's widths (F = 256, G = 50) and at each edge-tile width the
    kernels instantiate up to the limits (F = 384 and 512: 16 edges a
    tile, F = 384 with a partly idle column chunk; F = 1024: 8 edges a
    tile; G = 127).  The edge-summed weight grads are held to 1e-4
    relative to their largest entry: thousands of float32 products summed
    in another order."""
    from hydragnn_torch.ops import scf_mp

    b = _graph_batch(8)
    n, e = len(b["node_gid"]), len(b["senders"])
    g = torch.Generator().manual_seed(2)
    mask = _t(b["edge_mask"])
    # weights at the scale of a lecun-normal init
    ins = [torch.randn(n, f, generator=g),
           torch.rand(e, gd, generator=g),
           torch.rand(e, generator=g) * mask,
           torch.randn(gd, f, generator=g) / gd ** 0.5,
           torch.randn(f, generator=g) * 0.1,
           torch.randn(f, f, generator=g) / f ** 0.5,
           torch.randn(f, generator=g) * 0.1]
    ins = [t.to(cuda) for t in ins]
    ct = torch.randn(n, f, generator=g).to(cuda)
    send, recv = _t(b["senders"]).to(cuda), _t(b["receivers"]).to(cuda)
    perm = _t(b["perm"]).to(cuda)
    em = mask.to(torch.int32).to(cuda)
    scf_mp.reset_launches()
    k = _grads(lambda *a: scf_mp.scf_edge_pipeline(
        a[0], a[1], a[2], em, *a[3:], send, recv, perm), ins, ct)
    p = _grads(lambda *a: scf_mp.scf_edge_pipeline_plain(
        a[0], a[1], a[2], em, *a[3:], send, recv), ins, ct)
    torch.cuda.synchronize()
    assert scf_mp.LAUNCHES == {"scf_edge_pipeline": 1,
                               "scf_edge_pipeline_pass_p": 1,
                               "scf_edge_pipeline_pass_s": 1}
    real = em.bool()
    for name, a, c in zip(("h", "rbf", "cm", "w0", "b0", "w1", "b1"), k, p):
        if name in ("rbf", "cm"):
            assert bool((a[~real] == 0).all()), name
            a, c = a[real], c[real]
        scale = float(c.abs().max())
        rel = 1e-4 if name in ("w0", "b0", "w1", "b1") else 1e-5
        assert float((a - c).abs().max()) <= rel * scale, name


def _schnet_batch(monkeypatch):
    from hydragnn_torch.graph.batch import GraphSample, HeadSpec, PadSpec, collate
    from hydragnn_torch.graph.neighborlist import radius_graph

    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", "fused")
    rng = np.random.RandomState(0)
    samples = []
    for _ in range(16):
        pos = rng.rand(20, 3).astype(np.float32) * 4.0
        samples.append(GraphSample(
            x=rng.randint(0, 5, (20, 1)), pos=pos,
            edge_index=radius_graph(pos, 1.8, max_neighbours=20),
            graph_y=rng.rand(1)))
    g = collate(samples, PadSpec.for_batch(16, 20, max(
        s.num_edges for s in samples)), [HeadSpec("energy", "graph", 1)])
    assert "edge_perm_sender" in g.extras
    return g


def _schnet(width, seed=0):
    from hydragnn_torch.models.base import GraphHeadCfg, ModelConfig
    from hydragnn_torch.models.create import create_model

    cfg = ModelConfig(
        model_type="SchNet", input_dim=1, hidden_dim=width, output_dim=(1,),
        output_type=("graph",),
        graph_head=GraphHeadCfg(2, width, 2, (width, width)),
        node_head=None, task_weights=(1.0,), num_conv_layers=4,
        num_gaussians=50, num_filters=width, radius=1.8, max_neighbours=20)
    return cfg, create_model(cfg, seed=seed)


@pytest.mark.gpu
def test_schnet_forward_on_card_matches_cpu(cuda, monkeypatch):
    """The SchNet forward under the fused backend: the card (kernels) and
    the CPU (plain versions) agree to 1e-4, with 4 + 1 launches."""
    g = _schnet_batch(monkeypatch)
    _, model = _schnet(64)
    model = model.eval()
    with torch.inference_mode():
        want = model(g)[0]
        tfm.reset_launches()
        got = model.to(cuda)(g.to(cuda))[0]
        torch.cuda.synchronize()
    assert tfm.LAUNCHES["gather_mul_segment_sum"] == 4
    assert tfm.LAUNCHES["segment_sum_dense"] == 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [64, 256])
def test_schnet_train_steps_on_card_match_cpu(cuda, monkeypatch, width):
    """Three AdamW steps under fused from one init, on the card (kernels,
    forward and backward) and on the CPU (plain versions): the same
    losses and parameters to 1e-4, with the kernels of each width
    launched once per conv layer and pass."""
    from hydragnn_torch.ops import scf_mp
    from hydragnn_torch.train.optimizer import select_optimizer
    from hydragnn_torch.train.trainer import create_train_state, make_train_step

    g = _schnet_batch(monkeypatch)
    runs = []
    for dev in (torch.device("cpu"), cuda):
        cfg, model = _schnet(width, seed=1)
        model = model.to(dev)
        spec = select_optimizer({"type": "AdamW", "learning_rate": 1e-3})
        state = create_train_state(model, spec)
        step = make_train_step(model, cfg, spec)
        tfm.reset_launches()
        scf_mp.reset_launches()
        losses = []
        gd = g.to(dev)
        for _ in range(3):
            state, m = step(state, gd)
            losses.append(float(m["loss"]))
        runs.append((losses, [p.detach().cpu() for p in model.parameters()]))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-4, atol=1e-6)
    for a, b in zip(runs[1][1], runs[0][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    if width == 64:
        assert tfm.LAUNCHES["gather_mul_segment_sum"] == 12
        assert tfm.LAUNCHES["gather_mul_segment_sum_dx"] == 12
        assert scf_mp.LAUNCHES["scf_edge_pipeline"] == 0
    else:
        assert tfm.LAUNCHES["gather_mul_segment_sum"] == 0
        assert scf_mp.LAUNCHES == {"scf_edge_pipeline": 12,
                                   "scf_edge_pipeline_pass_p": 12,
                                   "scf_edge_pipeline_pass_s": 12}
    assert tfm.LAUNCHES["segment_sum_dense"] == 3


def _degree_batch(n=300, lo=0, hi=20, seed=0):
    """Rows of degree 0 (every third) and of degrees up to ``hi``, sorted
    receivers, random senders, a masked tail parked on node n-1."""
    rng = np.random.RandomState(seed)
    deg = rng.randint(lo, hi + 1, n)
    deg[::3] = 0
    deg[1] = hi
    deg[n - 1] = 0
    recv = np.repeat(np.arange(n), deg)
    e_real = len(recv)
    e = e_real + 37
    senders = np.full(e, n - 1, np.int32)
    receivers = np.full(e, n - 1, np.int32)
    senders[:e_real] = rng.randint(0, n - 1, e_real)
    receivers[:e_real] = recv
    mask = np.zeros(e, np.float32)
    mask[:e_real] = 1.0
    perm = np.argsort(senders, kind="stable").astype(np.int32)
    return senders, receivers, mask, perm, deg


@pytest.mark.gpu
@pytest.mark.parametrize("f,moments", [
    (64, ("sum", "sq", "mxmn", "cnt")), (256, ("sum", "sq", "mxmn", "cnt")),
    (512, ("sum", "sq", "mxmn", "cnt")), (1024, ("sum", "sq", "cnt")),
    (64, ("sum", "cnt")), (5, ("mxmn",)), (130, ("cnt",))])
@pytest.mark.parametrize("all_masked", [False, True])
def test_poly_kernels_match_plain_on_card(cuda, f, moments, all_masked):
    """Both poly kernels against their plain versions at the widths of the
    gates (512 with mxmn, 1024 without), on rows of degree 0 and degree 20
    and with every edge masked: sums to 1e-5 of the largest entry, max/min
    and the count exactly equal; then the backward through the autograd
    Functions against autograd through the plain versions, on data with
    ties, masked rows exactly zero."""
    from hydragnn_torch.ops import poly_mp

    n = 300
    send, recv, mask, perm, deg = _degree_batch(n)
    if all_masked:
        mask = np.zeros_like(mask)
    g = torch.Generator().manual_seed(3)
    e = len(send)
    # a coarse grid: ties within a segment
    data = (torch.randn(e, f, generator=g) * 2).round().div(2).to(cuda)
    x = (torch.randn(n, f, generator=g) * 2).round().div(2).to(cuda)
    send, recv, mask, perm = (_t(a).to(cuda) for a in (send, recv, mask, perm))
    order = poly_mp._norm_moments(moments)

    def check(k, p):
        for m, a, c in zip(order, k, p):
            if m in ("mxmn", "cnt"):
                assert torch.equal(a, c), m
            else:
                scale = max(float(c.abs().max()), 1.0)
                assert float((a - c).abs().max()) <= 1e-5 * scale, m

    poly_mp.reset_launches()
    tfm.reset_launches()
    with torch.inference_mode():
        k = poly_mp.segment_poly_dense(data, recv, n, moments, valid=mask)
        p = poly_mp.segment_poly_dense_plain(data, recv, n, moments,
                                             valid=mask)
        torch.cuda.synchronize()
        check(k, p)
        if "cnt" in order and not all_masked:
            assert torch.equal(k[order.index("cnt")].cpu(),
                               torch.from_numpy(deg).float())
        k = poly_mp.gather_poly_segment(x, send, recv, perm, moments,
                                        mask=mask)
        p = poly_mp.gather_poly_segment_plain(x, send, recv, moments,
                                              mask=mask)
        torch.cuda.synchronize()
        check(k, p)
    assert poly_mp.LAUNCHES == {"segment_poly_dense": 1,
                                "gather_poly_segment": 1}
    if order == ("cnt",):
        return

    def loss(outs):
        total = 0.0
        for m, o in zip(order, outs):
            if m == "mxmn":
                o = torch.where(o <= -5e8, torch.zeros_like(o), o)
            if m != "cnt":
                total = total + (o ** 2).sum()
        return total

    def grad(fn, t):
        t = t.detach().clone().requires_grad_(True)
        loss(fn(t)).backward()
        torch.cuda.synchronize()
        return t.grad

    for kern, plain, t in (
            (lambda d: poly_mp.segment_poly_dense(d, recv, n, moments,
                                                  valid=mask),
             lambda d: poly_mp.segment_poly_dense_plain(d, recv, n, moments,
                                                        valid=mask), data),
            (lambda x_: poly_mp.gather_poly_segment(x_, send, recv, perm,
                                                    moments, mask=mask),
             lambda x_: poly_mp.gather_poly_segment_plain(x_, send, recv,
                                                          moments, mask=mask),
             x)):
        gk, gp = grad(kern, t), grad(plain, t)
        scale = max(float(gp.abs().max()), 1.0)
        assert float((gk - gp).abs().max()) <= 1e-5 * scale
    gk = grad(lambda d: poly_mp.segment_poly_dense(d, recv, n, moments,
                                                   valid=mask), data)
    assert bool((gk[mask == 0] == 0).all())


@pytest.mark.gpu
def test_poly_kernels_refuse_what_they_do_not_take(cuda):
    from hydragnn_torch.ops import poly_mp

    send, recv, mask, perm, _ = _degree_batch(40)
    send, recv, mask = (_t(a).to(cuda) for a in (send, recv, mask))
    data = torch.randn(len(send), 8, device=cuda)
    with pytest.raises(TypeError):
        poly_mp.segment_poly_dense(data.double(), recv, 40, ("sum",))
    with pytest.raises(ValueError):
        poly_mp.segment_poly_dense(data.t(), recv, 8, ("sum",))
    with pytest.raises(TypeError):
        poly_mp.gather_poly_segment(torch.randn(40, 8, device=cuda), send,
                                    recv, None, ("sum",), mask=mask.double())


def _arch(model_type, seed=0):
    from hydragnn_torch.models.base import GraphHeadCfg, ModelConfig
    from hydragnn_torch.models.create import create_model

    cfg = ModelConfig(
        model_type=model_type, input_dim=1, hidden_dim=64, output_dim=(1,),
        output_type=("graph",), graph_head=GraphHeadCfg(2, 64, 2, (64, 64)),
        node_head=None, task_weights=(1.0,), num_conv_layers=4, radius=1.8,
        max_neighbours=20, max_degree=20, pna_avg_deg_log=1.8,
        pna_avg_deg_lin=6.0)
    return cfg, create_model(cfg, seed=seed)


@pytest.mark.gpu
@pytest.mark.parametrize("model_type", ["GIN", "SAGE", "MFC", "PNA"])
def test_arch_train_steps_on_card_match_cpu(cuda, monkeypatch, model_type):
    """Three AdamW steps under fused, the card (kernels) and the CPU (plain
    versions) in lockstep: before each step the card model takes the CPU
    model's weights and BatchNorm buffers, then both step on the same
    batch.  Held at each step: the loss (1e-5), the BatchNorm statistics
    the forward updated (1e-4) and every parameter gradient, to 1e-3 of
    the model's largest gradient entry — BatchNorm makes the weights in
    front of it scale-invariant, so their gradients are small differences
    of large cancelling float32 sums, and Adam would blow that noise up to
    steps of the learning rate's size if the two runs went on alone.  Each
    architecture's kernels launch once per conv layer (the first layer's
    input needs no gradient)."""
    from hydragnn_torch.models.base import multihead_loss
    from hydragnn_torch.ops import poly_mp
    from hydragnn_torch.train.optimizer import select_optimizer
    from hydragnn_torch.train.trainer import create_train_state, make_train_step

    g = _schnet_batch(monkeypatch)
    sides = []
    for dev in (torch.device("cpu"), cuda):
        cfg, model = _arch(model_type, seed=1)
        model = model.to(dev)
        spec = select_optimizer({"type": "AdamW", "learning_rate": 1e-3})
        sides.append([model, create_train_state(model, spec),
                      make_train_step(model, cfg, spec), g.to(dev)])

    def loss_and_grads(model, gd):
        kept = [b.clone() for b in model.buffers()]
        model.train()
        loss, _ = multihead_loss(cfg, model(gd), gd)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        stats = [b.detach().cpu().clone() for b in model.buffers()]
        with torch.no_grad():
            for b_, k in zip(model.buffers(), kept):
                b_.copy_(k)
        return float(loss.detach()), [d.cpu() for d in grads], stats

    counted = {}
    for _ in range(3):
        sides[1][0].load_state_dict(sides[0][0].state_dict())
        (lc, gc, sc), (lg, gg, sg) = (loss_and_grads(m, gd)
                                      for m, _, _, gd in sides)
        assert abs(lg - lc) <= 1e-5 * abs(lc)
        top = max(float(d.abs().max()) for d in gc)
        for d_c, d_g in zip(gc, gg):
            assert float((d_c - d_g).abs().max()) <= 1e-3 * top
        for b_c, b_g in zip(sc, sg):
            torch.testing.assert_close(b_g, b_c, rtol=1e-4, atol=1e-5)
        tfm.reset_launches()
        poly_mp.reset_launches()
        for side in sides:
            side[1], _ = side[2](side[1], side[3])
        for k, v in {**tfm.LAUNCHES, **poly_mp.LAUNCHES}.items():
            counted[k] = counted.get(k, 0) + v
    want = {
        "GIN": {"gather_segment_sum": 12, "gather_segment_sum_dx": 9,
                "segment_sum_dense": 3},
        "SAGE": {"gather_poly_segment": 12, "gather_segment_sum_dx": 9,
                 "segment_sum_dense": 3},
        "MFC": {"gather_poly_segment": 12, "gather_segment_sum_dx": 9,
                "segment_sum_dense": 3},
        # per step: 1 pool + 4 tie counts + 2 gathers' backward in each of
        # the 3 layers whose input needs a gradient
        "PNA": {"segment_poly_dense": 12, "segment_sum_dense": 3 * 11},
    }[model_type]
    for k, v in counted.items():
        assert v == want.get(k, 0), (k, counted)
