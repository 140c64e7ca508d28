"""The PyTorch port's fused message-passing ops against the JAX reference.

Plain PyTorch versions (the CPU path of ``hydragnn_torch.ops.fused_mp``)
against the reference Pallas ops, which run in interpret mode on the CPU:
``gather_mul_segment_sum``, its no-``w`` mode ``gather_segment_sum`` and
``segment_sum_dense``, on collate-shaped inputs (graphs within one node
block, sorted receivers, a masked tail of padding edges parked on node
N-1, empty segments).  Tolerance 1e-5: both sides accumulate in float32,
in a different order.

Backward: the ops' autograd Functions against the reference's custom
VJPs — dx of both gather ops (the kernel rerun on the sender-sorted
ordering), dw on real edges (garbage on masked ones by contract), and the
pool's gather backward, with a masked tail and empty segments.

Also: the CSR schedule covers every valid row exactly once and no masked
row.  The CUDA kernels against their plain versions on the card are in
tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hydragnn_tpu.ops import fused_mp as jfm
from hydragnn_torch.ops import fused_mp as tfm
from hydragnn_torch.ops.aggregate import segment_offsets
from test_torch_gpu import _graph_batch

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("f", [5, 64])
@pytest.mark.parametrize("masked", [True, False])
def test_gather_mul_segment_sum_matches_jax(f, masked):
    b = _graph_batch(f)
    n = len(b["node_gid"])
    x = b["rng"].randn(n, f).astype(np.float32)
    w = b["rng"].randn(len(b["senders"]), f).astype(np.float32)
    w *= b["edge_mask"][:, None]  # callers pre-mask w
    ev = b["edge_mask"] if masked else None
    want = jfm.gather_mul_segment_sum(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b["senders"]),
        jnp.asarray(b["receivers"]), jnp.asarray(b["perm"]),
        edge_valid=None if ev is None else jnp.asarray(ev))
    got = tfm.gather_mul_segment_sum(
        _t(x), _t(w), _t(b["senders"]), _t(b["receivers"]), _t(b["perm"]),
        edge_valid=None if ev is None else _t(ev))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tfm.LAUNCHES["gather_mul_segment_sum"] == 0  # CPU: plain version


@pytest.mark.parametrize("f", [5, 64])
def test_gather_segment_sum_matches_jax(f):
    b = _graph_batch(10 + f)
    n = len(b["node_gid"])
    x = b["rng"].randn(n, f).astype(np.float32)
    want = jfm.gather_segment_sum(
        jnp.asarray(x), jnp.asarray(b["senders"]),
        jnp.asarray(b["receivers"]), jnp.asarray(b["perm"]),
        jnp.asarray(b["edge_mask"]))
    got = tfm.gather_segment_sum(
        _t(x), _t(b["senders"]), _t(b["receivers"]), _t(b["perm"]),
        _t(b["edge_mask"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("f", [5, 64])
def test_segment_sum_dense_matches_jax(f):
    b = _graph_batch(20 + f)
    e = len(b["senders"])
    # edge-valued data over receivers, masked rows skipped via `valid`
    data = b["rng"].randn(e, f).astype(np.float32) * b["edge_mask"][:, None]
    want = jfm.segment_sum_dense(
        jnp.asarray(data), jnp.asarray(b["receivers"]),
        len(b["node_gid"]), valid=jnp.asarray(b["edge_mask"]))
    got = tfm.segment_sum_dense(
        _t(data), _t(b["receivers"]), len(b["node_gid"]),
        valid=_t(b["edge_mask"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # node-valued data over node_gid: the mean pool's call
    xn = b["rng"].randn(len(b["node_gid"]), f).astype(np.float32)
    xn *= b["node_mask"][:, None]
    want = jfm.segment_sum_dense(
        jnp.asarray(xn), jnp.asarray(b["node_gid"]), b["n_graphs"])
    got = tfm.segment_sum_dense(_t(xn), _t(b["node_gid"]), b["n_graphs"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_schedule_covers_each_valid_row_once():
    b = _graph_batch(3)
    n = len(b["node_gid"])
    recv, mask = b["receivers"], b["edge_mask"]
    row_ptr = segment_offsets(_t(recv), n, _t(mask)).numpy()
    assert row_ptr.dtype == np.int32 and row_ptr.shape == (n + 1,)
    assert np.all(np.diff(row_ptr) >= 0)
    covered = np.zeros(len(recv), np.int64)
    for s in range(n):
        lo, hi = row_ptr[s], row_ptr[s + 1]
        covered[lo:hi] += 1
        assert np.all(recv[lo:hi] == s)
    np.testing.assert_array_equal(covered, (mask != 0).astype(np.int64))
    # empty segments exist among the real nodes (no in-edges): zero-length
    n_real = int(b["node_mask"].sum())
    assert np.sum(np.diff(row_ptr)[:n_real] == 0) > 0
    # without a mask the padding edges land on the padding node N-1
    row_ptr = segment_offsets(_t(recv), n).numpy()
    assert row_ptr[n] - row_ptr[n - 1] == np.sum(recv == n - 1)
    # ids out of range fall outside every range
    row_ptr = segment_offsets(_t(np.array([-1, 0, 0, 2, 7], np.int32)), 3).numpy()
    np.testing.assert_array_equal(row_ptr, [1, 3, 3, 4])


def test_wrappers_use_plain_version_on_cpu():
    tfm.reset_launches()
    b = _graph_batch(4, n_real=40, n_pad=48, e_pad=512)
    x = torch.randn(48, 8, requires_grad=True)
    w = torch.randn(512, 8) * _t(b["edge_mask"])[:, None]
    out = tfm.gather_mul_segment_sum(x, w, _t(b["senders"]),
                                     _t(b["receivers"]), None,
                                     edge_valid=_t(b["edge_mask"]))
    out.sum().backward()  # the plain version is differentiable
    assert x.grad is not None
    with pytest.raises(ValueError):
        tfm.gather_mul_segment_sum(x, w, _t(b["senders"]),
                                   _t(b["receivers"]), None, window=2)
    assert all(v == 0 for v in tfm.LAUNCHES.values())


# --- backward: the custom VJPs against the reference's -------------------


def _vjp_jax(fn, primals, ct):
    _, pull = jax.vjp(fn, *primals)
    return [np.asarray(g) for g in pull(jnp.asarray(ct))]


def _vjp_torch(fn, primals, ct):
    ts = [_t(p).clone().requires_grad_(True) for p in primals]
    fn(*ts).backward(_t(ct))
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("masked", [True, False])
def test_gather_mul_segment_sum_grads_match_jax(masked):
    """dx (the kernel rerun on the sender-sorted ordering) and dw (plain
    indexing) against the reference VJP; dw compared on real edges only —
    on masked edges it is garbage by contract in both."""
    b = _graph_batch(31)
    n, e = len(b["node_gid"]), len(b["senders"])
    x = b["rng"].randn(n, 24).astype(np.float32)
    w = b["rng"].randn(e, 24).astype(np.float32) * b["edge_mask"][:, None]
    ct = b["rng"].randn(n, 24).astype(np.float32)
    ev = b["edge_mask"] if masked else None
    s, r, p = b["senders"], b["receivers"], b["perm"]
    want = _vjp_jax(
        lambda x_, w_: jfm.gather_mul_segment_sum(
            x_, w_, jnp.asarray(s), jnp.asarray(r), jnp.asarray(p),
            edge_valid=None if ev is None else jnp.asarray(ev)),
        (jnp.asarray(x), jnp.asarray(w)), ct)
    tfm.reset_launches()
    got = _vjp_torch(
        lambda x_, w_: tfm.gather_mul_segment_sum(
            x_, w_, _t(s), _t(r), _t(p),
            edge_valid=None if ev is None else _t(ev)), (x, w), ct)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    real = b["edge_mask"] != 0
    np.testing.assert_allclose(got[1][real], want[1][real], **TOL)
    assert all(v == 0 for v in tfm.LAUNCHES.values())  # CPU: plain


def test_gather_segment_sum_grad_matches_jax():
    b = _graph_batch(32)
    n = len(b["node_gid"])
    x = b["rng"].randn(n, 16).astype(np.float32)
    ct = b["rng"].randn(n, 16).astype(np.float32)
    s, r, p, m = b["senders"], b["receivers"], b["perm"], b["edge_mask"]
    want = _vjp_jax(
        lambda x_: jfm.gather_segment_sum(
            x_, jnp.asarray(s), jnp.asarray(r), jnp.asarray(p),
            jnp.asarray(m)), (jnp.asarray(x),), ct)
    got = _vjp_torch(
        lambda x_: tfm.gather_segment_sum(x_, _t(s), _t(r), _t(p), _t(m)),
        (x,), ct)
    np.testing.assert_allclose(got[0], want[0], **TOL)


@pytest.mark.parametrize("over", ["receivers", "node_gid"])
def test_segment_sum_dense_grad_matches_jax(over):
    """The pool's backward: a gather that zeroes masked and out-of-range
    ids, over both sorted id streams the models use."""
    b = _graph_batch(33)
    n = len(b["node_gid"])
    if over == "receivers":
        ids, segs, valid = b["receivers"], n, b["edge_mask"]
    else:
        ids, segs, valid = b["node_gid"], b["n_graphs"] - 1, None
    data = b["rng"].randn(len(ids), 8).astype(np.float32)
    ct = b["rng"].randn(segs, 8).astype(np.float32)
    want = _vjp_jax(
        lambda d: jfm.segment_sum_dense(
            d, jnp.asarray(ids), segs,
            valid=None if valid is None else jnp.asarray(valid)),
        (jnp.asarray(data),), ct)
    got = _vjp_torch(
        lambda d: tfm.segment_sum_dense(
            d, _t(ids), segs, valid=None if valid is None else _t(valid)),
        (data,), ct)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    if over == "node_gid":  # the padding graph's id is out of range
        assert np.all(got[0][b["node_gid"] >= segs] == 0.0)
