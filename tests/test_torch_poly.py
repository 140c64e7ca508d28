"""The PyTorch port's multi-moment (poly) ops against the JAX reference.

Plain PyTorch versions and autograd Functions of
``hydragnn_torch.ops.poly_mp`` against ``hydragnn_tpu.ops.poly_mp``'s
Pallas ops, which run in interpret mode on the CPU, on numpy-seeded
collate-shaped inputs (sorted receivers, a masked tail of padding edges
parked on node N-1, empty segments).  Forward tolerance 1e-5 (float32 sums
in another order); max, min and the count exactly equal; gradients 1e-5,
with ties (data on a coarse grid) and exactly zero on masked rows.

Also: the ``poly_*_segment`` dispatchers of ``graph/segment.py`` under the
marker and without it, their tally keys and the width gate; the composed
path's ``segment_max``/``min``/``std`` and its tie split against
``jax.ops.segment_max``; and the dense-backward gathers' gradients, the
parked slot's included.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hydragnn_tpu.graph import segment as jseg
from hydragnn_tpu.ops import poly_mp as jpm
from hydragnn_torch.graph import segment as tseg
from hydragnn_torch.ops import fused_mp as tfm
from hydragnn_torch.ops import poly_mp as tpm
from hydragnn_torch.telemetry import pipeline
from test_torch_gpu import _graph_batch
from test_torch_graph import _collate_both, _raw_samples

TOL = dict(rtol=1e-5, atol=1e-5)
ALL = ("sum", "sq", "mxmn", "cnt")
PUBLIC = ("sum", "sq", "mx", "mn", "cnt")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _data(b, f, quantize=False):
    d = b["rng"].randn(len(b["senders"]), f).astype(np.float32)
    if quantize:  # a coarse grid: deliberate ties within a segment
        d = np.round(d * 2.0) / 2.0
    return d


def _close(got, want, moments, exact=("mxmn", "cnt")):
    assert len(got) == len(want) == len(moments)
    for m, t, j in zip(moments, got, want):
        if m in exact:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), m)
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=m,
                                       **TOL)


def _loss_j(outs, moments, f):
    total = 0.0
    for m, o in zip(moments, outs):
        if m == "sum":
            total = total + jnp.sum(o ** 2)
        elif m == "sq":
            total = total + 0.5 * jnp.sum(o ** 2)
        elif m == "mxmn":
            mx = jnp.where(o[:, :f] <= -5e8, 0.0, o[:, :f])
            mn = jnp.where(o[:, f:] <= -5e8, 0.0, -o[:, f:])
            total = total + jnp.sum(mx ** 2) + jnp.sum(mn ** 3)
        else:
            total = total + jnp.sum(o)
    return total


def _loss_t(outs, moments, f):
    total = 0.0
    for m, o in zip(moments, outs):
        if m == "sum":
            total = total + (o ** 2).sum()
        elif m == "sq":
            total = total + 0.5 * (o ** 2).sum()
        elif m == "mxmn":
            zero = torch.zeros(())
            mx = torch.where(o[:, :f] <= -5e8, zero, o[:, :f])
            mn = torch.where(o[:, f:] <= -5e8, zero, -o[:, f:])
            total = total + (mx ** 2).sum() + (mn ** 3).sum()
        else:
            total = total + o.sum()
    return total


# --- scatter mode -----------------------------------------------------------


@pytest.mark.parametrize("f", [5, 48])
@pytest.mark.parametrize("moments", [ALL, ("sum", "cnt"), ("mxmn",),
                                     ("sq", "sum")],
                         ids=["all", "sum-cnt", "mxmn", "sq-sum"])
def test_scatter_forward_matches_jax(f, moments):
    b = _graph_batch(f)
    n = len(b["node_gid"])
    data = _data(b, f)
    want = jpm.segment_poly_dense(
        jnp.asarray(data), jnp.asarray(b["receivers"]), n, moments,
        valid=jnp.asarray(b["edge_mask"]))
    order = tpm._norm_moments(moments)
    assert order == jpm._norm_moments(moments)
    tpm.reset_launches()
    got = tpm.segment_poly_dense(_t(data), _t(b["receivers"]), n, moments,
                                 valid=_t(b["edge_mask"]))
    _close(got, want, order)
    plain = tpm.segment_poly_dense_plain(_t(data), _t(b["receivers"]), n,
                                         moments, valid=_t(b["edge_mask"]))
    for a, c in zip(got, plain):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    assert all(v == 0 for v in tpm.LAUNCHES.values())  # CPU: plain version
    if "mxmn" in order:  # nodes without in-edges carry the sentinel
        mxmn = got[order.index("mxmn")]
        assert bool((mxmn == -1e9).any()) and mxmn.shape == (n, 2 * f)


@pytest.mark.parametrize("quantize", [False, True],
                         ids=["distinct", "with-ties"])
def test_scatter_gradients_match_jax(quantize):
    b = _graph_batch(2)
    n, f = len(b["node_gid"]), 12
    data = _data(b, f, quantize)
    ids, mask = b["receivers"], b["edge_mask"]

    want = jax.grad(lambda d: _loss_j(jpm.segment_poly_dense(
        d, jnp.asarray(ids), n, ALL, valid=jnp.asarray(mask)), ALL, f))(
            jnp.asarray(data))
    d = _t(data).requires_grad_(True)
    tfm.reset_launches()
    _loss_t(tpm.segment_poly_dense(d, _t(ids), n, ALL, valid=_t(mask)),
            ALL, f).backward()
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(want), **TOL)
    # masked rows carry exactly zero, the sq term 2*data*g included
    assert bool((d.grad[_t(mask) == 0] == 0).all())
    # ... and autograd through the plain version agrees (its amax splits
    # ties evenly too): the oracle the card check uses
    p = _t(data).requires_grad_(True)
    _loss_t(tpm.segment_poly_dense_plain(p, _t(ids), n, ALL, valid=_t(mask)),
            ALL, f).backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want), **TOL)
    if quantize:
        cat = np.concatenate([data, -data], 1)
        real = mask > 0
        top = np.full((n, 2 * f), -np.inf, np.float32)
        np.maximum.at(top, ids[real], cat[real])
        ties = np.zeros((n, 2 * f))
        np.add.at(ties, ids[real], cat[real] == top[ids[real]])
        assert ties.max() > 1  # the even split was exercised


def test_scatter_all_masked_and_empty_segments():
    b = _graph_batch(11)
    n, f = len(b["node_gid"]), 7
    data = _data(b, f) + 5.0     # a leaked masked max would be visibly > 0
    none = np.zeros_like(b["edge_mask"])
    s, q, mxmn, cnt = tpm.segment_poly_dense(
        _t(data), _t(b["receivers"]), n, ALL, valid=_t(none))
    want = jpm.segment_poly_dense(jnp.asarray(data),
                                  jnp.asarray(b["receivers"]), n, ALL,
                                  valid=jnp.asarray(none))
    _close((s, q, mxmn, cnt), want, ALL, exact=ALL)
    assert bool((s == 0).all() and (q == 0).all() and (cnt == 0).all())
    assert bool((mxmn == -1e9).all())
    # through the dispatcher's clean, every moment reads 0
    res = tseg._poly_unpack(ALL, (s, q, mxmn, cnt), PUBLIC, f)
    assert all(bool((res[k] == 0).all()) for k in PUBLIC)


def test_moment_vocabulary_is_checked():
    for bad in ((), ("mean",), ("sum", "mx")):
        with pytest.raises(ValueError):
            tpm._norm_moments(bad)
    assert tpm.MOMENT_ORDER == jpm.MOMENT_ORDER
    assert (tpm.POLY_MAX_F, tpm.POLY_MAX_F_MXMN, tpm._NEG) == (
        jpm.POLY_MAX_F, jpm.POLY_MAX_F_MXMN, jpm._NEG)
    assert tseg._poly_public_keys() == jseg._poly_public_keys() == PUBLIC
    for ms in (PUBLIC, ("mn",), ("sum", "cnt"), ("sum",)):
        assert tseg._poly_kernel_moments(ms) == jseg._poly_kernel_moments(ms)
    with pytest.raises(ValueError):
        tseg._poly_kernel_moments(("mxmn",))


# --- gather mode ------------------------------------------------------------


@pytest.mark.parametrize("moments", [ALL, ("sum", "cnt"), ("cnt",)],
                         ids=["all", "sum-cnt", "cnt"])
@pytest.mark.parametrize("masked", [True, False])
def test_gather_forward_and_gradients_match_jax(moments, masked):
    b = _graph_batch(7)
    n, f = len(b["node_gid"]), 10
    x = np.round(b["rng"].randn(n, f).astype(np.float32) * 2.0) / 2.0
    s, r, perm = b["senders"], b["receivers"], b["perm"]
    mask = b["edge_mask"] if masked else None
    if not masked:  # every slot real: drop the padding tail
        s, r = s[b["edge_mask"] > 0], r[b["edge_mask"] > 0]
        perm = np.argsort(s, kind="stable").astype(np.int32)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    order = tpm._norm_moments(moments)

    def jloss(x_):
        return _loss_j(jpm.gather_poly_segment(
            x_, jnp.asarray(s), jnp.asarray(r), jnp.asarray(perm), moments,
            mask=jm), order, f)

    want = jpm.gather_poly_segment(jnp.asarray(x), jnp.asarray(s),
                                   jnp.asarray(r), jnp.asarray(perm),
                                   moments, mask=jm)
    xt = _t(x).requires_grad_(True)
    got = tpm.gather_poly_segment(xt, _t(s), _t(r), _t(perm), moments,
                                  mask=tm)
    _close([o.detach() for o in got], want, order)
    if "cnt" in order:
        assert not got[order.index("cnt")].requires_grad
    if order == ("cnt",):
        return
    gwant = jax.grad(jloss)(jnp.asarray(x))
    _loss_t(got, order, f).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gwant), **TOL)
    # no sender permutation given: the backward sorts for itself
    x2 = _t(x).requires_grad_(True)
    _loss_t(tpm.gather_poly_segment(x2, _t(s), _t(r), None, moments,
                                    mask=tm), order, f).backward()
    torch.testing.assert_close(x2.grad, xt.grad, rtol=0, atol=0)
    xp = _t(x).requires_grad_(True)
    _loss_t(tpm.gather_poly_segment_plain(xp, _t(s), _t(r), moments,
                                          mask=tm), order, f).backward()
    np.testing.assert_allclose(xp.grad.numpy(), np.asarray(gwant), **TOL)


def test_gather_sum_cnt_gives_the_neighbour_mean():
    """The SAGE/MFC moment set: sum + cnt compose to ``segment_mean`` of the
    gathered messages (max(cnt, 1) divide)."""
    b = _graph_batch(9)
    n = len(b["node_gid"])
    x = _t(b["rng"].rand(n, 6).astype(np.float32))
    s, r, m = _t(b["senders"]), _t(b["receivers"]), _t(b["edge_mask"])
    su, cnt = tpm.gather_poly_segment(x, s, r, _t(b["perm"]), ("sum", "cnt"),
                                      mask=m)
    torch.testing.assert_close(
        tseg._mean_divide(su, cnt),
        tseg.segment_mean(x[s.long()], r, n, m), **TOL)
    torch.testing.assert_close(cnt, tseg.degree(r, n, m), rtol=0, atol=0)


# --- composed segment ops ---------------------------------------------------


def test_segment_max_min_std_match_jax_with_ties():
    b = _graph_batch(21)
    n, f = len(b["node_gid"]), 6
    data = _data(b, f, quantize=True)
    ids, mask = b["receivers"], b["edge_mask"]
    jd, ji, jm = jnp.asarray(data), jnp.asarray(ids), jnp.asarray(mask)
    for tfn, jfn in ((tseg.segment_max, jseg.segment_max),
                     (tseg.segment_min, jseg.segment_min),
                     (tseg.segment_std, jseg.segment_std)):
        np.testing.assert_allclose(
            tfn(_t(data), _t(ids), n, _t(mask)).numpy(),
            np.asarray(jfn(jd, ji, n, jm)), err_msg=tfn.__name__, **TOL)
        want = jax.grad(lambda d: jnp.sum(jfn(d, ji, n, jm) ** 2))(jd)
        d = _t(data).requires_grad_(True)
        (tfn(d, _t(ids), n, _t(mask)) ** 2).sum().backward()
        np.testing.assert_allclose(d.grad.numpy(), np.asarray(want),
                                   err_msg=tfn.__name__, **TOL)
    # unmasked too (every slot real)
    np.testing.assert_allclose(
        tseg.segment_max(_t(data), _t(ids), n).numpy(),
        np.asarray(jseg.segment_max(jd, ji, n)), **TOL)


# --- dispatchers ------------------------------------------------------------


def _strip(g):
    return dataclasses.replace(g, extras={})


@pytest.mark.parametrize("mode", ["scatter", "gather"])
def test_dispatchers_fused_composed_and_jax_agree(mode, monkeypatch):
    gj, gt = _collate_both(_raw_samples(6, seed=13), monkeypatch, "fused")
    assert "edge_perm_sender" in gt.extras
    rng = np.random.RandomState(14)
    rows = gt.num_edges if mode == "scatter" else gt.num_nodes
    data = np.round(rng.randn(rows, 9).astype(np.float32) * 2.0) / 2.0
    tfn = getattr(tseg, f"poly_{mode}_segment")
    jfn = getattr(jseg, f"poly_{mode}_segment")
    before = pipeline.dispatch_snapshot()
    fused = tfn(_t(data), gt, PUBLIC)
    composed = tfn(_t(data), _strip(gt), PUBLIC)
    delta = pipeline.dispatch_delta(before, pipeline.dispatch_snapshot())
    assert delta[f"poly_{mode}:fused"] == 1
    assert delta[f"poly_{mode}:scatter"] == 1
    want = jfn(jnp.asarray(data), gj, PUBLIC)
    assert set(fused) == set(composed) == set(want) == set(PUBLIC)
    for k in PUBLIC:
        np.testing.assert_allclose(fused[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
        np.testing.assert_allclose(composed[k].numpy(), fused[k].numpy(),
                                   err_msg=k, **TOL)
    torch.testing.assert_close(
        fused["cnt"], tseg.degree(gt.receivers, gt.num_nodes, gt.edge_mask),
        rtol=0, atol=0)

    # gradients: kernel path (custom VJP) vs composed path vs JAX
    def tloss(res):
        return sum((res[k] ** 2).sum() for k in ("sum", "sq", "mx", "mn"))

    want_g = jax.grad(lambda d: sum(
        jnp.sum(jfn(d, gj, PUBLIC)[k] ** 2)
        for k in ("sum", "sq", "mx", "mn")))(jnp.asarray(data))
    for g in (gt, _strip(gt)):
        d = _t(data).requires_grad_(True)
        tloss(tfn(d, g, PUBLIC)).backward()
        np.testing.assert_allclose(d.grad.numpy(), np.asarray(want_g),
                                   rtol=1e-4, atol=1e-4)


def test_dispatch_sum_delegates_and_width_gate_falls_back(monkeypatch):
    gj, gt = _collate_both(_raw_samples(4, seed=16), monkeypatch, "fused")
    rng = np.random.RandomState(17)
    e, n = gt.num_edges, gt.num_nodes
    data = _t(rng.randn(e, 4).astype(np.float32))
    x = _t(rng.randn(n, 4).astype(np.float32))
    before = pipeline.dispatch_snapshot()
    a = tseg.poly_scatter_segment(data, gt, ("sum",))
    c = tseg.poly_gather_segment(x, gt, ("sum",))
    delta = pipeline.dispatch_delta(before, pipeline.dispatch_snapshot())
    assert delta == {"scatter_sum:fused": 1, "gather_sum:fused": 1}
    torch.testing.assert_close(a["sum"], tseg.scatter_segment(data, gt))
    torch.testing.assert_close(c["sum"], tseg.gather_segment(x, gt))

    # F above the mxmn gate takes the composed path with the marker present
    # (the sum inside still rides its kernel's dispatch site) — still right
    wide = _t(rng.rand(e, tpm.POLY_MAX_F_MXMN + 1).astype(np.float32))
    before = pipeline.dispatch_snapshot()
    out = tseg.poly_scatter_segment(wide, gt, ("sum", "mx"))
    delta = pipeline.dispatch_delta(before, pipeline.dispatch_snapshot())
    assert delta == {"poly_scatter:scatter": 1, "scatter_sum:fused": 1}
    assert tseg._poly_fused_ok(gt, tpm.POLY_MAX_F, ("sum", "cnt"))
    assert not tseg._poly_fused_ok(gt, tpm.POLY_MAX_F + 1, ("sum", "cnt"))
    assert not tseg._poly_fused_ok(_strip(gt), 4, ("sum",))
    want = jseg.poly_scatter_segment(jnp.asarray(wide.numpy()), gj,
                                     ("sum", "mx"))
    for k in ("sum", "mx"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


# --- dense-backward gathers -------------------------------------------------


@pytest.mark.parametrize("which", ["gather_sender", "gather_receiver_sorted"])
def test_dense_backward_gathers_match_jax(which, monkeypatch):
    gj, gt = _collate_both(_raw_samples(5, seed=19), monkeypatch, "fused")
    rng = np.random.RandomState(20)
    n = gt.num_nodes
    x = rng.rand(n, 8).astype(np.float32)
    idx = gt.senders if which == "gather_sender" else gt.receivers
    tfn, jfn = getattr(tseg, which), getattr(jseg, which)
    torch.testing.assert_close(tfn(_t(x), gt), _t(x)[idx.long()], rtol=0,
                               atol=0)
    # the callers' contract: the gathered value meets the edge mask before
    # any loss, so padding rows carry a zero cotangent
    jmask = jnp.asarray(gj.edge_mask)[:, None]
    want = jax.grad(lambda x_: jnp.sum((jfn(x_, gj) * jmask) ** 2))(
        jnp.asarray(x))
    tfm.reset_launches()
    for g in (gt, _strip(gt)):
        xt = _t(x).requires_grad_(True)
        ((tfn(xt, g) * gt.edge_mask[:, None]) ** 2).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **TOL)
    # padding edges park on node N-1, a padding node no real edge touches:
    # with the contract kept its gradient is exactly zero
    assert int(gt.senders[-1]) == n - 1 and float(gt.edge_mask[-1]) == 0.0
    assert bool((xt.grad[n - 1] == 0).all())
    assert all(v == 0 for v in tfm.LAUNCHES.values())  # CPU: plain versions
