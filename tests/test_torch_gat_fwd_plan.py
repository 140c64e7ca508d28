"""GAT's forward as route 1 of its kernel computes it (csrc/gat_mp.cu
``gat_fwd_kernel``), written out in torch on the CPU.

- The logits in lane order (each head's F products added one after
  another, as ``edge_logits`` and the first design add them), so ``m``, a
  max, equals the plain version's bit for bit.
- Each receiver row's edges in edge order, in groups of ``U`` edges
  (:func:`gat_mp.fwd_group`): per group and head one max over the running
  max and the group's real logits, one rescale of ``d`` and ``acc``, then
  each edge's ``p`` into ``d`` and ``p b xl[src]`` into ``acc`` in edge
  order.

Held to ``gat_edge_attention_reference``: ``m`` equal, ``acc`` and ``d``
within 1e-5 of their largest entry (the grouping moves them by roundings
only); rows without a real incoming edge read ``m = -1e9``, ``d = 0`` and
``acc = 0``.  Once against the JAX op in interpret mode, at the tolerance
of tests/test_torch_gat.py.  And the forward's route and ``U`` by width,
``U`` within the lanes and the shared memory it is given, and the staged
rows' float4 reads in distinct banks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_torch.ops import gat_mp
from hydragnn_torch.ops.aggregate import segment_offsets
from test_torch_gat import OP_TOL, SLOPE, _jax_op, _op_case, _torch_args
from test_torch_pass_s_plan import _close

WARPS = 4   # csrc/gat_mp.cu kWarps: rows in flight a block


def _head_stride(f):
    """csrc/gat_mp.cu fwd_head_stride: the staged head stride, ``4 q``
    floats, ``q = ceil(f / 4)`` made odd."""
    return 4 * ((-(-f // 4)) | 1)


def _stage_bytes(hf, f):
    """csrc/gat_mp.cu fwd_smem: a block's stage, att and then four warps
    of ``2 U + 1`` rows, each H heads of ``_head_stride(f)`` floats."""
    rows = 1 + WARPS * (2 * gat_mp.fwd_group(hf, f) + 1)
    return 4 * rows * (hf // f) * _head_stride(f)


WIDTHS = [(384, 64, 1), (768, 256, 1), (36, 12, 1), (32, 8, 1), (40, 10, 1),
          (512, 32, 1), (1024, 128, 1), (1024, 256, 1), (96, 96, 1),
          (40, 1, 2), (384, 16, 2), (384, 8, 2), (1020, 12, 2), (960, 48, 2),
          (1024, 512, 2), (1024, 1024, 2)]


def _gat_fwd_groups(xl, xr, att, senders, receivers, edge_mask, b_edge,
                    slope, u):
    """The forward as route 1 computes it at group size ``u``: ``(acc [N,
    H*F], m [N, H], d [N, H])``."""
    n, hf = xl.shape
    h, f = att.shape
    ok, s, r = gat_mp._valid_edges(edge_mask, senders, receivers, n)
    e, _, _ = gat_mp.edge_logits(xl[s], xr[r], att, slope)
    bb = torch.ones_like(e) if b_edge is None else b_edge
    ptr = segment_offsets(receivers, n, edge_mask).tolist()
    acc = torch.zeros((n, hf), dtype=xl.dtype)
    m = torch.full((n, h), gat_mp._NEG, dtype=xl.dtype)
    d = torch.zeros((n, h), dtype=xl.dtype)
    for row in range(n):
        m_run, d_run, a_run = m[row], d[row], acc[row]
        for base in range(ptr[row], ptr[row + 1], u):
            ks = [k for k in range(base, min(base + u, ptr[row + 1]))
                  if bool(ok[k])]
            mn = m_run
            for k in ks:
                mn = torch.maximum(mn, e[k])
            rescale = torch.exp(m_run - mn)
            d_run = d_run * rescale
            pbs = []
            for k in ks:
                pe = torch.exp(e[k] - mn)
                d_run = d_run + pe
                pbs.append(pe * bb[k])
            m_run = mn
            a_run = a_run * gat_mp._expand(rescale[None], f)[0]
            for k, pb in zip(ks, pbs):
                a_run = a_run + gat_mp._expand(pb[None], f)[0] * xl[s[k]]
        m[row], d[row], acc[row] = m_run, d_run, a_run
    return acc, m, d


def _fwd_case(h, f, bits, seed=0):
    """A receiver-sorted batch of 50 nodes: node 3 receives 75 edges (many
    groups), node 5 and the last nodes receive nothing, one
    real edge's sender lies outside [0, N), a masked tail is parked on the
    last node."""
    rng = np.random.RandomState(seed + h + f)
    n, e, real = 50, 320, 280
    recv = rng.randint(0, n - 3, real)
    recv[:75] = 3
    recv[recv == 5] = 6
    recv = np.sort(recv)
    send = rng.randint(0, n - 1, real)
    send[real // 2] = n + 3
    pad = np.full(e - real, n - 1)
    send, recv = (np.concatenate([v, pad]).astype(np.int32)
                  for v in (send, recv))
    mask = (np.arange(e) < real).astype(np.float32)
    vals = [rng.randn(n, h * f), rng.randn(n, h * f),
            rng.randn(h, f) / f ** 0.5]
    b = ((rng.rand(e, h) < 0.75) / 0.75) if bits else None
    xl, xr, att = (torch.from_numpy(v.astype(np.float32)) for v in vals)
    b = None if b is None else torch.from_numpy(b.astype(np.float32))
    return (xl, xr, att, b), torch.from_numpy(send), \
        torch.from_numpy(recv), torch.from_numpy(mask)


@pytest.mark.parametrize("group", ["path", 1, 5])
@pytest.mark.parametrize("bits", [False, True], ids=["ones", "dropout"])
@pytest.mark.parametrize("h,f", [(3, 12), (6, 64)])
def test_gat_fwd_groups_match_plain(h, f, bits, group):
    """The forward as route 1 computes it, at the widths' own U (8 at 3 x
    12, 3 at the gat cell's 6 x 64) and at U = 1 and 5, equals the plain
    forward: m bit for bit, acc and d within 1e-5 of their largest entry;
    rows without a real incoming edge read m = -1e9, d = 0, acc = 0."""
    (xl, xr, att, b), send, recv, mask = _fwd_case(h, f, bits)
    u = gat_mp.fwd_group(h * f, f) if group == "path" else group
    acc, m, d = _gat_fwd_groups(xl, xr, att, send, recv, mask, b, SLOPE, u)
    acc_p, m_p, d_p = gat_mp.gat_edge_attention_reference(
        xl, xr, att, send, recv, mask, b, SLOPE)
    assert torch.equal(m, m_p)
    _close(acc, acc_p)
    _close(d, d_p)
    ok = (mask != 0) & (send < xl.shape[0])
    no_in = ~torch.isin(torch.arange(xl.shape[0]), recv[ok])
    assert bool(no_in[5]) and int(no_in.sum()) >= 3
    assert bool((m[no_in] == gat_mp._NEG).all())
    assert float(d[no_in].abs().max()) == 0
    assert float(acc[no_in].abs().max()) == 0


def test_gat_fwd_groups_match_jax(monkeypatch):
    """The forward as route 1 computes it (the widths' own U = 8 at H = 4,
    F = 8, dropout bits) against the JAX op's acc, m and d (interpret
    mode; the batch and inputs of tests/test_torch_gat.py) at that file's
    tolerance."""
    h, f = 4, 8
    ids, xl, xr, att, b, ca, cd = _op_case(monkeypatch, h, f, 5, True)
    with jax.default_matmul_precision("highest"):
        _, (jacc, jm, jd) = _jax_op(ids, xl, xr, att, b)(
            jnp.asarray(xl), jnp.asarray(xr), jnp.asarray(att), ca, cd)
    s, r, _, em, tb_ = _torch_args(ids, b)
    acc, m, d = _gat_fwd_groups(
        torch.from_numpy(xl), torch.from_numpy(xr), torch.from_numpy(att),
        s, r, em, tb_, SLOPE, gat_mp.fwd_group(h * f, f))
    assert float(acc.abs().max()) > 0
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), **OP_TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **OP_TOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **OP_TOL)


@pytest.mark.parametrize("hf,f,route", WIDTHS)
def test_gat_fwd_route_by_width(hf, f, route):
    """The forward's route 1 at the widths of passes R and S (a head at
    most 8 slots of 32 lanes, at most 32 slots a lane and 16 heads: the gat
    cell's 6 x 64 and gat_h256's head groups of 3 x 256 among them); the
    first design past that, where U is 0."""
    assert gat_mp.fwd_route(hf, f) == route == gat_mp.lane_route(hf, f)
    assert (gat_mp.fwd_group(hf, f) > 0) == (route == 1)


@pytest.mark.parametrize("hf,f,route", [w for w in WIDTHS if w[2] == 1])
def test_gat_fwd_group_by_width(hf, f, route):
    """U per width: at least one edge, the group's U * H logit chains one a
    lane (H up to the instantiation's heads), its ring of two groups' xl
    rows and the row's xr within a warp's part of the stage at the
    instantiation's widest head (U = 1 past it), U the largest such, and a
    block's stage within 56 KB, so that four blocks fit a SM; 3 at 6 x 64
    and 1 at 3 x 256."""
    h = hf // f
    s = gat_mp.head_slots(f)
    nj = gat_mp.route1_nj(h, s)
    heads, row = nj // s, (nj // s) * (32 * s + 4)
    u = gat_mp.fwd_group(hf, f)
    assert nj >= h * s and nj % s == 0
    assert u >= 1 and u * heads <= 32
    assert u == 1 or (2 * u + 1) * row <= gat_mp.FWD_WARP_FLOATS
    assert (u + 1) * heads > 32 or (2 * u + 3) * row > gat_mp.FWD_WARP_FLOATS
    assert 4 * _stage_bytes(hf, f) <= 227 * 1024
    assert 32 * s + 4 >= _head_stride(f) >= f
    assert _head_stride(f) % 8 == 4
    assert {(384, 64): 3, (768, 256): 1}.get((hf, f), u) == u


@pytest.mark.parametrize("f", [1, 8, 10, 12, 64, 96, 128, 256])
def test_gat_fwd_stage_reads_fall_in_distinct_banks(f):
    """The U*H summing lanes read word hs * lane + k as float4s: within each
    quarter of the warp (eight lanes, one float4 phase) their 16-byte
    units fall in eight distinct banks of four words."""
    hs = _head_stride(f)
    for quarter in range(4):
        units = {((hs * lane) // 4) % 8
                 for lane in range(8 * quarter, 8 * quarter + 8)}
        assert len(units) == 8
