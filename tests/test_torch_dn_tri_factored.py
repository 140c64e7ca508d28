"""The triplet backward factored onto the kj rows, as csrc/dn_tri.cu computes
it, against the JAX reference's VJP (hydragnn_tpu/ops/dn_tri.py, Pallas in
interpret mode) and the port's plain backward.

Every triplet t of row k = kj(t) shares radial[k] and x2[k], and sbf_t[l*R
+ r] = radial[k, l*R + r] * cbf[t, l], so with g_t = dout[ji(t)]:

    P[k, l]  = sum_r radial[k, l*R + r] W1[l*R + r];   Q[k, l] = P[k, l] W2
    G[k, l]  = sum_{t in row k} cbf[t, l] g_t          (the per-triplet work)
    d_x2[k]  = sum_l Q[k, l] * G[k, l]
    U[k, l]  = x2[k] * G[k, l];                        Hk[k, l] = U[k, l] W2^T
    dW2      = sum_{k, l} P[k, l]^T U[k, l]
    dW1[l*R + r] = sum_k radial[k, l*R + r] Hk[k, l]
    d_radial[k, l*R + r] = Hk[k, l] . W1[l*R + r]
    d_cbf[t, l] = g_t . (x2[k] * Q[k, l])

The kernel runs only on the card (tests/test_torch_gpu.py holds it to the
plain version there); these tests hold its arithmetic, written in torch, to
the reference: in float32 against the JAX VJP on the JAX test's batches
(S = 7, R = 3, B = 8, D = 16; 1e-5 of each output's largest entry, the
triplet-summed weight gradients too), in float64 against the port's plain
backward at the dimenet cell's widths (S = 7, R = 6, B = 8, D = 64) with a
row of 60 triplets, rows without a triplet and masked and out-of-range
triplets (1e-12), and in float32 within twice the plain float32 backward's
own error from float64, or 1e-6 of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_torch.ops import dn_tri as tdt


def _factored_bwd(radial, x2, cbf, w1, w2, idx_kj, idx_ji, tmask, dout,
                  num_radial):
    """``(d_radial, d_x2, d_cbf, dw1, dw2)`` by the factored form above, in
    the inputs' dtype; masked and out-of-range triplets contribute nothing
    and get a zero ``d_cbf``."""
    e, d = x2.shape
    t, s = cbf.shape
    b = w1.shape[1]
    r = num_radial
    ok = ((tmask != 0) & (idx_kj >= 0) & (idx_kj < e) & (idx_ji >= 0)
          & (idx_ji < e))
    k, j = idx_kj[ok].long(), idx_ji[ok].long()
    rad = radial.reshape(e, s, r, 1)
    p = (rad * w1.reshape(1, s, r, b)).sum(2)                   # [E, S, B]
    q = p @ w2                                                  # [E, S, D]
    gk = torch.zeros((e, s, d), dtype=x2.dtype).index_add(
        0, k, cbf[ok][:, :, None] * dout[j][:, None, :])        # [E, S, D]
    d_x2 = (q * gk).sum(1)
    u = x2[:, None, :] * gk
    hk = u @ w2.t()                                             # [E, S, B]
    dw2 = torch.einsum("esb,esd->bd", p, u)
    dw1 = (rad * hk.reshape(e, s, 1, b)).sum(0).reshape(s * r, b)
    d_radial = (hk.reshape(e, s, 1, b) * w1.reshape(1, s, r, b)).sum(-1)
    d_cbf = torch.zeros_like(cbf)
    d_cbf[ok] = (dout[j][:, None, :] * (x2[k][:, None, :] * q[k])).sum(-1)
    return d_radial.reshape(e, s * r), d_x2, d_cbf, dw1, dw2


def _tables(n_edges, n_tri, seed, hub=60, gap=(100, 150), stray=3):
    """A triplet table in add_dimenet_extras's layout (idx_ji nondecreasing,
    a masked tail parked on the last edge, perm the stable argsort of
    idx_kj) with kj row 3 holding ``hub`` triplets, kj rows in ``gap``
    none, and ``stray`` real triplets whose ids lie outside [0, E)."""
    rng = np.random.RandomState(seed)
    real = n_tri - n_tri // 5
    ji = np.sort(rng.randint(0, n_edges - 1, real))
    kj = rng.randint(0, n_edges - 1, real)
    kj[rng.choice(real, hub, replace=False)] = 3
    inside = (kj >= gap[0]) & (kj < gap[1])
    kj[inside] = gap[1] + (kj[inside] - gap[0]) % (n_edges - 1 - gap[1])
    kj[rng.choice(real, stray, replace=False)] = n_edges + 5
    pad = np.full(n_tri - real, n_edges - 1)
    idx_ji = np.concatenate([ji, pad]).astype(np.int32)
    idx_kj = np.concatenate([kj, pad]).astype(np.int32)
    tmask = (np.arange(n_tri) < real).astype(np.int32)
    return [torch.from_numpy(a) for a in (idx_kj, idx_ji, tmask)]


def _inputs(e, t, s, r, b, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.rand(e, s * r), rng.randn(e, d), rng.randn(t, s) * 0.5,
            rng.randn(s * r, b) / (s * r) ** 0.5, rng.randn(b, d) / b ** 0.5,
            rng.randn(e, d)]


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-300)


@pytest.mark.parametrize("seed", [3, 9])
def test_factored_backward_matches_jax_vjp(seed, monkeypatch):
    """Float32, on the JAX test's collated batches: every output of the
    factored backward within 1e-5 of its largest entry of the JAX op's VJP
    (interpret-mode Pallas); d_cbf exactly zero on masked triplets."""
    from hydragnn_tpu.ops.dn_tri import dimenet_triplet_mp
    from test_torch_dimenet import R, _tri_case

    args, (kj, ji), tmask, perm, wa = _tri_case(monkeypatch, seed)
    j_ids = [jnp.asarray(v.numpy()) for v in (kj, ji, tmask, perm)]
    _, vjp = jax.vjp(lambda *a: dimenet_triplet_mp(*a, *j_ids, R),
                     *[jnp.asarray(a) for a in args])
    want = vjp(jnp.asarray(wa))
    got = _factored_bwd(*[torch.from_numpy(a) for a in args], kj, ji, tmask,
                        torch.from_numpy(wa), R)
    real = tmask.numpy() != 0
    assert (~real).any()
    assert bool((got[2][~torch.from_numpy(real)] == 0).all())
    for name, x, y in zip(("radial", "x2", "cbf", "w1", "w2"), got, want):
        assert x.dtype == torch.float32
        assert _rel(x, torch.tensor(np.asarray(y))) <= 1e-5, name


@pytest.mark.parametrize("s,r,b,d", [(7, 6, 8, 64), (8, 8, 64, 64),
                                     (1, 1, 1, 1)])
def test_factored_backward_is_the_plain_backward_in_float64(s, r, b, d):
    """Float64, at the dimenet cell's widths, the kernel's limits and one
    lane each: the factored form equals the port's plain backward (the
    kernel's oracle on the card) to 1e-12 of each output's largest entry,
    with a 60-triplet row, rows 100-149 without a triplet, three triplets
    with an id outside [0, E) and a masked tail."""
    e, t = 700, 6000
    kj, ji, tm = _tables(e, t, seed=s + b)
    ins = [torch.from_numpy(a) for a in _inputs(e, t, s, r, b, d, seed=s)]
    got = _factored_bwd(*ins[:5], kj, ji, tm, ins[5], r)
    want = tdt.dimenet_triplet_bwd_plain(*ins[:5], kj, ji, tm, ins[5], r)
    assert float(got[1][100:150].abs().max()) == 0.0
    for name, x, y in zip(("radial", "x2", "cbf", "w1", "w2"), got, want):
        assert x.dtype == torch.float64
        assert _rel(x, y) <= 1e-12, name


def test_factored_backward_float32_within_the_plain_error():
    """Float32 at the dimenet cell's widths: each output of the factored
    form is within max(2 x the plain float32 backward's error, 1e-6 of the
    largest entry) of the float64 backward, the bound the card tests hold
    the kernel to."""
    s, r, b, d = 7, 6, 8, 64
    e, t = 700, 6000
    kj, ji, tm = _tables(e, t, seed=1)
    ins = [torch.from_numpy(a) for a in _inputs(e, t, s, r, b, d, seed=2)]
    f32 = [x.float() for x in ins]
    got = _factored_bwd(*f32[:5], kj, ji, tm, f32[5], r)
    plain = tdt.dimenet_triplet_bwd_plain(*f32[:5], kj, ji, tm, f32[5], r)
    ref = tdt.dimenet_triplet_bwd_plain(*ins[:5], kj, ji, tm, ins[5], r)
    for name, x, p, y in zip(("radial", "x2", "cbf", "w1", "w2"), got, plain,
                             ref):
        scale = float(y.abs().max())
        e32 = float((p.double() - y).abs().max())
        err = float((x.double() - y).abs().max())
        assert err <= max(2 * e32, 1e-6 * scale), (name, err, e32, scale)
