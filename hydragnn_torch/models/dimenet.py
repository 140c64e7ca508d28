"""DimeNet++ stack (port of hydragnn_tpu/models/dimenet.py).

Directional message passing on edge features with triplet (k->j->i)
interactions.  The triplet table is built on the host after collation
(:func:`build_triplets`, :func:`add_dimenet_extras`) into padded arrays of
a fixed length per run; distances and angles are recomputed from positions
on the device.  The Bessel radial basis and the spherical (Legendre x
spherical-Bessel) basis are plain PyTorch; the spherical-Bessel zeros are
found on the host with scipy when a conv first needs them.

The interaction's triplet contraction dispatches as the reference does
(``DimeNetConv.forward``):

- ``tri_kernel``: the factored-basis triplet op (ops/dn_tri.py) and, where
  ``hidden`` and ``int_emb_size`` are at most 128, the row-MLP tail
  (ops/row_mlp.py) — the batch carries ``dn_tri_ok`` and ``dn_perm_kj``,
  ``num_spherical <= 8``, ``S*R <= 64``, both embedding sizes <= 64;
- ``tri_builder`` (the same marker, wider dims: ``S*R <= 127``, both
  embedding sizes <= 128): the builder-backed triplet op
  (ops/dn_tri.py ``dimenet_tri_builder``) on the full per-triplet
  spherical basis, then the composed tail (the reference runs the row-MLP
  tail in the factored branch only);
- ``tri_window`` (opt-in ``HYDRAGNN_DIMENET_FUSED_TRI``): the
  gather-multiply kernel of ops/fused_mp.py in edge space;
- composed: a gather and a sorted segment sum over ``idx_ji``.

Each interaction tallies ``dn_tri_builder:fused`` (the builder branch),
or else ``dn_tri:fused`` (the factored kernel) or ``dn_tri:scatter`` and,
in the kernel branch, ``dn_row_mlp:fused`` or ``:scatter``; a marker that
the width gate or the edge-span gate turned away is tallied as
``dn_tri_fallback:<reason>`` (telemetry/pipeline.py).  Parameter names are
the flax tree's (``lin_in``, ``rbf.freq``, ``emb_lin_rbf``, ``emb_lin``,
``interaction.*``, ``output.*``), whatever branch runs and with or without
``HYDRAGNN_DIMENET_REMAT`` (each conv recomputed in the backward, read at
model build), so one checkpoint serves every branch in both packages.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from hydragnn_torch.graph import segment
from hydragnn_torch.models.base import Base
from hydragnn_torch.models.layers import LECUN_NORMAL, dense, dense_leaves
from hydragnn_torch.ops.aggregate import NODE_BLOCK
from hydragnn_torch.ops.dn_tri import (
    FACTORED_EMB_LIMIT,
    TRI_EMB_LIMIT,
    TRI_S_LIMIT,
    TRI_SBF_LIMIT,
    TRI_SR_LIMIT,
)
from hydragnn_torch.utils.env import env_flag


def _note_fallback(reason: str) -> None:
    from hydragnn_torch.telemetry import pipeline

    pipeline.count_dispatch("dn_tri_fallback", reason)


# ---------------------------------------------------------------------------
# host side: the triplet table
# ---------------------------------------------------------------------------

def build_triplets(edge_index: np.ndarray, num_nodes: int):
    """Triplet table (k->j->i) of an edge list: for every pair of edges
    (k->j), (j->i) with k != i, the node ids (idx_i, idx_j, idx_k) and the
    edge ids (idx_kj, idx_ji), idx_ji nondecreasing.  Vectorised numpy:
    incoming edge ids grouped by destination, each edge (j->i) expanded
    against the group of j."""
    src = np.asarray(edge_index[0], np.int64)
    dst = np.asarray(edge_index[1], np.int64)  # j->i: src=j, dst=i
    e = src.shape[0]
    if e == 0:
        return tuple(np.zeros((0,), np.int32) for _ in range(5))
    # a stable argsort of dst keeps edge ids increasing within each group
    order = np.argsort(dst, kind="stable")
    counts = np.bincount(dst, minlength=num_nodes)
    ptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    num = counts[src]  # candidates per edge
    ji = np.repeat(np.arange(e, dtype=np.int64), num)
    ends = np.cumsum(num)
    within = np.arange(int(ends[-1]), dtype=np.int64) - np.repeat(
        ends - num, num)
    kj = order[ptr[src[ji]] + within]
    keep = src[kj] != dst[ji]  # drop k == i backtracking triplets
    ji, kj = ji[keep], kj[keep]
    return tuple(
        a.astype(np.int32) for a in (dst[ji], src[ji], src[kj], kj, ji))


class DnTriGate:
    """Per-dataset gate of the factored-basis triplet marker (``dn_tri_ok``).

    The marker's presence must be the same on every batch of a run.  Two
    modes:

    - static (``max_edges_per_graph`` given): decided once from the
      dataset-wide bound.  A graph's real edges are contiguous in edge-id
      space, so a graph of at most L edges spans at most
      ceil((L-1)/NODE_BLOCK) edge blocks; the marker needs at most 2
      (graphs of at most 257 edges).  No batch is measured.
    - sticky (no bound, one-shot callers): each batch is measured, and the
      first that spans more than 2 blocks turns the marker off for the
      rest of the run (tallied as ``dn_tri_fallback:edge_span``).
    """

    def __init__(self, max_edges_per_graph=None):
        self.static = max_edges_per_graph is not None
        if self.static:
            L = max(int(max_edges_per_graph), 1)
            self.span_bound = -(-(L - 1) // NODE_BLOCK)
            self.ok = self.span_bound <= 2
        else:
            self.span_bound = None
            self.ok = True

    def allow(self, measure_span) -> bool:
        """``measure_span`` is a thunk, called only when a measurement is
        needed (never in the static mode)."""
        if self.static or not self.ok:
            return self.ok
        if measure_span() > 2:
            self.ok = False  # sticky: the whole run falls back from here
            _note_fallback("edge_span")
        return self.ok


def add_dimenet_extras(batch, max_triplets: int, tri_gate=None):
    """Post-collate hook: the batch with the padded triplet arrays in its
    ``extras`` (``dn_idx_i/j/k/kj/ji``, ``dn_perm_kj`` — the stable argsort
    of ``dn_idx_kj`` — and ``dn_triplet_mask``).  Padded triplets point at
    the last node / edge and carry mask 0.  Under the ``fused`` backend it
    adds the ``dn_tri_ok`` marker where ``tri_gate`` (a :class:`DnTriGate`;
    omitted, a per-batch sticky one) allows and ``HYDRAGNN_DN_TRI_OFF`` is
    not set, and the ``dn_tri_window`` marker (5 blocks) under
    ``HYDRAGNN_DIMENET_FUSED_TRI``."""
    import dataclasses

    from hydragnn_torch.ops.aggregate import aggr_backend

    n, e = batch.x.shape[0], batch.senders.shape[0]
    senders = np.asarray(batch.senders)
    receivers = np.asarray(batch.receivers)
    real = np.asarray(batch.edge_mask) > 0
    ei_real = np.stack([senders, receivers])[:, real]
    real_ids = np.nonzero(real)[0].astype(np.int32)
    ti, tj, tk, tkj, tji = build_triplets(ei_real, n)
    t = ti.shape[0]
    if t > max_triplets:
        raise ValueError(
            f"batch has {t} triplets > max_triplets={max_triplets}")

    def _pad(arr, fill):
        out = np.full((max_triplets,), fill, np.int32)
        out[:t] = arr
        return out

    # the sorted scatter over idx_ji needs nondecreasing ids: real_ids is
    # increasing, so the mapped ids keep tji's order, and the e-1 padding
    # fill keeps the padded array nondecreasing
    if t and not np.all(np.diff(tji) >= 0):
        raise AssertionError("build_triplets produced non-sorted idx_ji")

    extras = dict(batch.extras)
    ex = {"dn_idx_i": _pad(ti, n - 1), "dn_idx_j": _pad(tj, n - 1),
          "dn_idx_k": _pad(tk, n - 1)}
    idx_kj = _pad(real_ids[tkj] if t else tkj, e - 1)
    ex["dn_idx_kj"] = idx_kj
    ex["dn_idx_ji"] = _pad(real_ids[tji] if t else tji, e - 1)
    ex["dn_perm_kj"] = np.argsort(idx_kj, kind="stable").astype(np.int32)
    mask = np.zeros((max_triplets,), np.float32)
    mask[:t] = 1.0
    ex["dn_triplet_mask"] = mask

    if aggr_backend() == "fused":
        def measure_span() -> int:
            # the largest edge-block span of any graph in this batch
            if not t:
                return 0
            gid_of_edge = np.asarray(batch.node_gid)[
                receivers[real]].astype(np.int64)
            blocks = (real_ids // NODE_BLOCK).astype(np.int64)
            ng = int(gid_of_edge.max()) + 1
            lo = np.full(ng, np.iinfo(np.int64).max)
            hi = np.full(ng, -1)
            np.minimum.at(lo, gid_of_edge, blocks)
            np.maximum.at(hi, gid_of_edge, blocks)
            occ = hi >= 0
            return int((hi[occ] - lo[occ]).max()) if occ.any() else 0

        if tri_gate is None:
            tri_gate = DnTriGate()  # transient: per batch
        if not env_flag("HYDRAGNN_DN_TRI_OFF") and tri_gate.allow(
                measure_span):
            ex["dn_tri_ok"] = np.zeros((1,), np.float32)
        if env_flag("HYDRAGNN_DIMENET_FUSED_TRI"):
            # the opt-in edge-space path: a batch whose graphs exceed the
            # window is an error, not a fallback
            span = measure_span()
            if span > 2:
                raise ValueError(
                    f"HYDRAGNN_DIMENET_FUSED_TRI: a graph spans {span} "
                    f"edge blocks (> 2); the 5-block window cannot cover "
                    f"it — unset the knob for this dataset")
            ex["dn_tri_window"] = np.zeros((5,), np.float32)
    extras.update({k: torch.from_numpy(v) for k, v in ex.items()})
    return dataclasses.replace(batch, extras=extras)


def count_triplets(edge_index: np.ndarray, num_nodes: int) -> int:
    """Number of (k->j->i, k != i) triplets, for sizing the static pad."""
    src, dst = edge_index[0], edge_index[1]
    in_deg = np.bincount(dst, minlength=num_nodes)
    # per edge j->i: one triplet per incoming edge of j, minus (i->j)
    total = int(in_deg[src].sum())
    pair = set(zip(src.tolist(), dst.tolist()))
    reverse = sum(1 for s, d in pair if (d, s) in pair)
    return total - reverse


@functools.lru_cache(maxsize=8)
def spherical_bessel_zeros(num_spherical: int, num_radial: int) -> np.ndarray:
    """First ``num_radial`` positive zeros of j_l, l = 0..num_spherical-1."""
    from scipy.optimize import brentq
    from scipy.special import spherical_jn

    zeros = np.zeros((num_spherical, num_radial))
    # j_0's zeros are n*pi; j_l's lie between consecutive zeros of j_{l-1}
    grid = np.arange(1, num_radial + num_spherical + 2) * np.pi
    prev = grid.astype(np.float64)
    zeros[0] = prev[:num_radial]
    for l in range(1, num_spherical):
        cur = []
        for a, b in zip(prev[:-1], prev[1:]):
            cur.append(brentq(lambda x: spherical_jn(l, x), a, b))
        prev = np.asarray(cur)
        zeros[l] = prev[:num_radial]
    return zeros


@functools.lru_cache(maxsize=8)
def sbf_normalizer(num_spherical: int, num_radial: int) -> np.ndarray:
    """DimeNet's normalisation sqrt(2) / |j_{l+1}(z_ln)| per (l, n)."""
    from scipy.special import spherical_jn

    z = spherical_bessel_zeros(num_spherical, num_radial)
    norm = np.zeros_like(z)
    for l in range(num_spherical):
        norm[l] = math.sqrt(2.0) / np.abs(spherical_jn(l + 1, z[l]))
    return norm


# ---------------------------------------------------------------------------
# basis functions (the reference's clamps and wheres, so a NaN or an inf
# behaves as it does there)
# ---------------------------------------------------------------------------

def envelope(x, exponent: int):
    """DimeNet's polynomial envelope u(x), u(1) = u'(1) = u''(1) = 0."""
    p = exponent + 1
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2.0)
    c = -p * (p + 1) / 2.0
    xs = torch.clamp(x, min=1e-7)
    val = 1.0 / xs + a * xs ** (p - 1) + b * xs ** p + c * xs ** (p + 1)
    return torch.where(x < 1.0, val, torch.zeros_like(val))


def _spherical_jl(l_max: int, x):
    """j_0..j_lmax by upward recurrence, with a Taylor guard below 0.5."""
    xs = torch.clamp(x, min=1e-7)
    out = [torch.sin(xs) / xs]
    if l_max >= 1:
        out.append(torch.sin(xs) / xs ** 2 - torch.cos(xs) / xs)
        for l in range(1, l_max):
            out.append((2 * l + 1) / xs * out[l] - out[l - 1])
    # small x: j_l(x) ~ x^l / (2l+1)!! (1 - x^2/(2(2l+3))
    #                                    + x^4/(8(2l+3)(2l+5)))
    small = x < 0.5
    res = []
    dfact = 1.0
    for l in range(l_max + 1):
        if l > 0:
            dfact *= 2 * l + 1
        taylor = (x ** l / dfact
                  * (1.0 - x ** 2 / (2.0 * (2 * l + 3))
                     + x ** 4 / (8.0 * (2 * l + 3) * (2 * l + 5))))
        res.append(torch.where(small, taylor, out[l]))
    return res


def _legendre(l_max: int, c):
    """P_0..P_lmax(c) by the three-term recurrence."""
    out = [torch.ones_like(c)]
    if l_max >= 1:
        out.append(c)
        for l in range(1, l_max):
            out.append(((2 * l + 1) * c * out[l] - l * out[l - 1]) / (l + 1))
    return out


class BesselBasis(nn.Module):
    """Radial Bessel basis with trainable frequencies (PyG
    BesselBasisLayer)."""

    def __init__(self, num_radial: int, cutoff: float,
                 envelope_exponent: int):
        super().__init__()
        self.cutoff = cutoff
        self.envelope_exponent = envelope_exponent
        self.freq = nn.Parameter(
            torch.arange(1, num_radial + 1, dtype=torch.float32) * math.pi)

    def forward(self, dist):
        d = dist[:, None] / self.cutoff
        return envelope(d, self.envelope_exponent) * torch.sin(self.freq * d)


def radial_sbf(dist_norm, num_spherical: int, num_radial: int,
               envelope_exponent: int):
    """The per-edge radial part of the spherical basis: [E, S, R],
    norm * j_l(z_lr * d) * envelope(d) at slot (l, r)."""
    dev = dist_norm.device
    zeros = torch.as_tensor(spherical_bessel_zeros(num_spherical, num_radial),
                            dtype=torch.float32, device=dev)
    norms = torch.as_tensor(sbf_normalizer(num_spherical, num_radial),
                            dtype=torch.float32, device=dev)
    x = dist_norm[:, None, None] * zeros[None, :, :]
    jls = _spherical_jl(num_spherical - 1, x.reshape(-1))
    e = dist_norm.shape[0]
    # slot l needs only order l
    rbf = torch.stack(
        [jls[l].reshape(e, num_spherical, num_radial)[:, l, :]
         for l in range(num_spherical)], dim=1)
    rbf = rbf * norms[None, :, :]
    return rbf * envelope(dist_norm[:, None, None], envelope_exponent)


def angular_cbf(angle, num_spherical: int):
    """The per-triplet angular part: [T, S], Legendre polynomials with the
    real-spherical-harmonic normalisation."""
    pl = _legendre(num_spherical - 1, torch.cos(angle))
    return torch.stack([math.sqrt((2 * l + 1) / (4 * math.pi)) * pl[l]
                        for l in range(num_spherical)], dim=1)


def spherical_basis_factors(dist_norm, angle, num_spherical: int,
                            num_radial: int, envelope_exponent: int):
    """The spherical basis factored: ``sbf[t] = radial[idx_kj[t]] *
    expand(cbf[t])`` with ``radial`` [E, S*R] in edge space and ``cbf``
    [T, S] in triplet space."""
    radial = radial_sbf(dist_norm, num_spherical, num_radial,
                        envelope_exponent)
    return (radial.reshape(dist_norm.shape[0], num_spherical * num_radial),
            angular_cbf(angle, num_spherical))


def spherical_basis(dist_norm, angle, idx_kj, num_spherical: int,
                    num_radial: int, envelope_exponent: int, perm_kj=None,
                    triplet_mask=None):
    """[T, S*R] spherical basis per triplet.  ``perm_kj`` (the stable
    argsort of ``idx_kj``) routes the edge-to-triplet gather's backward
    through the sorted segment sum (``segment.gather_perm``)."""
    rbf2, cbf = spherical_basis_factors(
        dist_norm, angle, num_spherical, num_radial, envelope_exponent)
    if perm_kj is not None:
        rbf_t = segment.gather_perm(rbf2, idx_kj, perm_kj, triplet_mask)
    else:
        rbf_t = rbf2[idx_kj.long()]
    out = rbf_t.reshape(-1, num_spherical, num_radial) * cbf[:, :, None]
    return out.reshape(-1, num_spherical * num_radial)


def distances_and_angles(pos, g, cutoff):
    """Per real edge its length (``cutoff`` on padding edges, so the basis
    stays finite) and per triplet the angle at j between j->i and k->i,
    with the reference's 1e-14 terms."""
    src, dst = g.senders.long(), g.receivers.long()
    ex = g.extras
    idx_i, idx_j, idx_k = (ex[k].long() for k in
                           ("dn_idx_i", "dn_idx_j", "dn_idx_k"))
    dist = torch.sqrt(torch.sum((pos[dst] - pos[src]) ** 2, dim=-1) + 1e-14)
    dist = torch.where(g.edge_mask > 0, dist, torch.full_like(dist, cutoff))
    pos_i = pos[idx_i]
    v_ji = pos[idx_j] - pos_i
    v_ki = pos[idx_k] - pos_i
    a = torch.sum(v_ji * v_ki, dim=-1)
    b = torch.linalg.norm(torch.cross(v_ji, v_ki, dim=-1) + 1e-14, dim=-1)
    return dist, torch.atan2(b, a)


# ---------------------------------------------------------------------------
# network blocks (PyG DimeNet++)
# ---------------------------------------------------------------------------

def _dense(i, o, gen, bias=True):
    # flax nn.Dense's default init: lecun-normal kernel, zero bias
    return dense(i, o, LECUN_NORMAL, gen, bias=bias)


def _leaves(prefix, named):
    out = {}
    for name, lin in named.items():
        for path, leaf in dense_leaves(name, lin).items():
            out[prefix + path] = leaf
    return out


class ResidualLayer(nn.Module):
    def __init__(self, dim, gen):
        super().__init__()
        self.lin1 = _dense(dim, dim, gen)
        self.lin2 = _dense(dim, dim, gen)

    def forward(self, x):
        return x + F.silu(self.lin2(F.silu(self.lin1(x))))

    def raw(self):
        """(w1, b1, w2, b2) with the weights ``[in, out]`` (views)."""
        return (self.lin1.weight.t(), self.lin1.bias,
                self.lin2.weight.t(), self.lin2.bias)


class InteractionPPBlock(nn.Module):
    def __init__(self, hidden, int_emb_size, basis_emb_size, num_sbf,
                 num_rbf, num_before_skip, num_after_skip, gen):
        super().__init__()
        self.hidden = hidden
        self.int_emb_size = int_emb_size
        self.lin_ji = _dense(hidden, hidden, gen)
        self.lin_kj = _dense(hidden, hidden, gen)
        self.lin_rbf1 = _dense(num_rbf, basis_emb_size, gen, bias=False)
        self.lin_rbf2 = _dense(basis_emb_size, hidden, gen, bias=False)
        self.lin_down = _dense(hidden, int_emb_size, gen, bias=False)
        self.lin_sbf1 = _dense(num_sbf, basis_emb_size, gen, bias=False)
        self.lin_sbf2 = _dense(basis_emb_size, int_emb_size, gen, bias=False)
        self.lin_up = _dense(int_emb_size, hidden, gen, bias=False)
        self.before_skip = nn.ModuleList(
            ResidualLayer(hidden, gen) for _ in range(num_before_skip))
        self.lin = _dense(hidden, hidden, gen)
        self.after_skip = nn.ModuleList(
            ResidualLayer(hidden, gen) for _ in range(num_after_skip))

    def flax_leaves(self):
        out = _leaves((), {n: getattr(self, n) for n in (
            "lin_ji", "lin_kj", "lin_rbf1", "lin_rbf2", "lin_down",
            "lin_sbf1", "lin_sbf2", "lin_up", "lin")})
        for side, layers in (("before_skip", self.before_skip),
                             ("after_skip", self.after_skip)):
            for i, r in enumerate(layers):
                out.update(_leaves((f"{side}_{i}",),
                                   {"lin1": r.lin1, "lin2": r.lin2}))
        return out

    def forward(self, x_edge, rbf, sbf, idx_kj, idx_ji, triplet_mask,
                branch, perm_kj=None, radial=None, cbf=None, num_radial=0,
                tri_window=0, sorted_hint=False):
        e = x_edge.shape[0]
        tmask = triplet_mask.to(x_edge.dtype)
        x_ji = F.silu(self.lin_ji(x_edge))
        x_kj = F.silu(self.lin_kj(x_edge))
        x_kj = x_kj * self.lin_rbf2(self.lin_rbf1(rbf))
        x_kj = F.silu(self.lin_down(x_kj))

        if branch == "tri_builder":
            segment._count("dn_tri_builder", True)
        else:
            segment._count("dn_tri", branch == "tri_kernel")
        if branch == "tri_kernel":
            from hydragnn_torch.ops.dn_tri import dimenet_triplet_mp

            x_kj = dimenet_triplet_mp(
                radial, x_kj, cbf, self.lin_sbf1.weight.t(),
                self.lin_sbf2.weight.t(), idx_kj, idx_ji,
                triplet_mask.to(torch.int32), perm_kj, num_radial)
            tail = (not env_flag("HYDRAGNN_DN_ROW_MLP_OFF")
                    and self.hidden <= 128 and self.int_emb_size <= 128)
            segment._count("dn_row_mlp", tail)
            if tail:
                from hydragnn_torch.ops.row_mlp import dimenet_post_mlp

                wb = [self.lin_up.weight.t(), None]
                for r in self.before_skip:
                    wb += r.raw()
                wb += [self.lin.weight.t(), self.lin.bias]
                for r in self.after_skip:
                    wb += r.raw()
                return dimenet_post_mlp(
                    x_kj, x_ji, x_edge, len(self.before_skip),
                    len(self.after_skip), *wb)
        elif branch == "tri_builder":
            from hydragnn_torch.ops.dn_tri import dimenet_tri_builder

            x_kj = dimenet_tri_builder(
                x_kj, sbf, triplet_mask.to(torch.int32),
                self.lin_sbf1.weight.t(), self.lin_sbf2.weight.t(), idx_kj,
                idx_ji, perm_kj)
        elif branch == "tri_window":
            from hydragnn_torch.ops.fused_mp import gather_mul_segment_sum

            sbf_emb = self.lin_sbf2(self.lin_sbf1(sbf))
            # the triplet contraction as message passing in edge space
            x_kj = gather_mul_segment_sum(
                x_kj, sbf_emb * tmask[:, None], idx_kj, idx_ji, perm_kj,
                tri_window)
        else:
            sbf_emb = self.lin_sbf2(self.lin_sbf1(sbf))
            msg = x_kj[idx_kj.long()] * sbf_emb * tmask[:, None]
            # idx_ji is nondecreasing (build_triplets) and padded triplets
            # sit at the tail with mask 0
            x_kj = segment.sorted_segment_sum(msg, idx_ji, e, tmask,
                                              sorted_hint=sorted_hint)
        x_kj = F.silu(self.lin_up(x_kj))

        h = x_ji + x_kj
        for r in self.before_skip:
            h = r(h)
        h = F.silu(self.lin(h)) + x_edge
        for r in self.after_skip:
            h = r(h)
        return h


class OutputPPBlock(nn.Module):
    def __init__(self, num_rbf, hidden, out_emb_size, out_dim, num_layers,
                 gen):
        super().__init__()
        self.lin_rbf = _dense(num_rbf, hidden, gen, bias=False)
        self.lin_up = _dense(hidden, out_emb_size, gen, bias=False)
        self.lins = nn.ModuleList(_dense(out_emb_size, out_emb_size, gen)
                                  for _ in range(num_layers))
        self.lin_out = _dense(out_emb_size, out_dim, gen, bias=False)

    def flax_leaves(self):
        named = {"lin_rbf": self.lin_rbf, "lin_up": self.lin_up,
                 "lin_out": self.lin_out}
        named.update({f"lin_{i}": l for i, l in enumerate(self.lins)})
        return _leaves((), named)

    def forward(self, x_edge, rbf, receivers, num_nodes, edge_mask,
                sorted_hint=False):
        x = self.lin_rbf(rbf) * x_edge
        x = segment.sorted_segment_sum(x, receivers, num_nodes, edge_mask,
                                       sorted_hint=sorted_hint)
        x = self.lin_up(x)
        for lin in self.lins:
            x = F.silu(lin(x))
        return self.lin_out(x)


class DimeNetConv(nn.Module):
    """One DIMEStack conv: lin -> embedding -> interaction -> output
    (reference get_conv, DIMEStack.py:79-116)."""

    def __init__(self, in_dim, out_dim, cfg, gen, remat=False):
        super().__init__()
        self.remat = remat
        # the reference's quirk: the width is out_dim only for a
        # one-feature input
        hidden = out_dim if in_dim == 1 else in_dim
        if hidden <= 1:
            raise ValueError(
                "DimeNet requires more than one hidden dimension.")
        self.num_radial = cfg.num_radial
        self.num_spherical = cfg.num_spherical
        self.basis_emb_size = cfg.basis_emb_size
        self.int_emb_size = cfg.int_emb_size
        self.envelope_exponent = cfg.envelope_exponent
        self.cutoff = cfg.radius
        sr = cfg.num_spherical * cfg.num_radial
        self.lin_in = _dense(in_dim, hidden, gen)
        self.rbf = BesselBasis(cfg.num_radial, cfg.radius,
                               cfg.envelope_exponent)
        self.emb_lin_rbf = _dense(cfg.num_radial, hidden, gen)
        self.emb_lin = _dense(3 * hidden, hidden, gen)
        self.interaction = InteractionPPBlock(
            hidden, cfg.int_emb_size, cfg.basis_emb_size, sr,
            cfg.num_radial, cfg.num_before_skip, cfg.num_after_skip, gen)
        self.output = OutputPPBlock(cfg.num_radial, hidden, cfg.out_emb_size,
                                    out_dim, 1, gen)

    def flax_leaves(self):
        out = {("rbf", "freq"): (self.rbf.freq, False)}
        out.update(_leaves((), {"lin_in": self.lin_in,
                                "emb_lin_rbf": self.emb_lin_rbf,
                                "emb_lin": self.emb_lin}))
        for scope in ("interaction", "output"):
            for path, leaf in getattr(self, scope).flax_leaves().items():
                out[(scope,) + path] = leaf
        return out

    def branch(self, ex) -> str:
        """The reference's dispatch (models/dimenet.py:644-673)."""
        s, sr = self.num_spherical, self.num_spherical * self.num_radial
        marked = (ex.get("dn_tri_ok") is not None
                  and ex.get("dn_perm_kj") is not None)
        windowed = ex.get("dn_tri_window") is not None
        if (marked and not windowed and s <= TRI_S_LIMIT
                and sr <= TRI_SR_LIMIT
                and self.int_emb_size <= FACTORED_EMB_LIMIT
                and self.basis_emb_size <= FACTORED_EMB_LIMIT):
            return "tri_kernel"
        if (marked and not windowed and sr <= TRI_SBF_LIMIT
                and self.basis_emb_size <= TRI_EMB_LIMIT
                and self.int_emb_size <= TRI_EMB_LIMIT):
            return "tri_builder"
        if marked and not windowed:
            _note_fallback("width_gate")
        return "tri_window" if windowed else "composed"

    def forward(self, x, pos, g):
        if self.remat and torch.is_grad_enabled():
            # the reference's nn.remat: keep only the conv's inputs and
            # recompute the rest in the backward, the hand-written
            # Functions included
            from torch.utils.checkpoint import checkpoint

            return checkpoint(self._forward, x, pos, g, use_reentrant=False)
        return self._forward(x, pos, g)

    def _forward(self, x, pos, g):
        n = x.shape[0]
        ex = g.extras
        idx_kj, idx_ji = ex["dn_idx_kj"], ex["dn_idx_ji"]
        tmask = ex["dn_triplet_mask"]
        perm_kj = ex.get("dn_perm_kj")
        branch = self.branch(ex)

        dist, angle = distances_and_angles(pos, g, self.cutoff)
        rbf = self.rbf(dist)
        radial = cbf = sbf = None
        if branch == "tri_kernel":
            radial, cbf = spherical_basis_factors(
                dist / self.cutoff, angle, self.num_spherical,
                self.num_radial, self.envelope_exponent)
        else:
            sbf = spherical_basis(
                dist / self.cutoff, angle, idx_kj, self.num_spherical,
                self.num_radial, self.envelope_exponent, perm_kj=perm_kj,
                triplet_mask=tmask)

        h = self.lin_in(x)
        rbf_e = F.silu(self.emb_lin_rbf(rbf))
        # the embedding's gathers: with collate's marker their backward is
        # the sorted-segment kernel (receivers sorted; senders through the
        # sender permutation), else the plain gather's
        x_edge = F.silu(self.emb_lin(torch.cat(
            [segment.gather_receiver_sorted(h, g),
             segment.gather_sender(h, g), rbf_e], dim=-1)))
        sorted_hint = bool(ex and "edge_perm_sender" in ex)
        tri_w = ex.get("dn_tri_window")
        x_edge = self.interaction(
            x_edge, rbf, sbf, idx_kj, idx_ji, tmask, branch,
            perm_kj=perm_kj, radial=radial, cbf=cbf,
            num_radial=self.num_radial,
            tri_window=0 if tri_w is None else int(tri_w.shape[0]),
            sorted_hint=sorted_hint)
        out = self.output(x_edge, rbf, g.receivers, n, g.edge_mask,
                          sorted_hint=sorted_hint)
        return out, pos


class DIMEStack(Base):
    has_batchnorm = False

    def make_conv(self, in_dim, out_dim, last_layer, gen):
        # HYDRAGNN_DIMENET_REMAT=1 recomputes each conv in the backward
        # (hydragnn_tpu/models/dimenet.py:739-751), for memory-limited
        # configs; read at model build, as the reference does
        return DimeNetConv(in_dim, out_dim, self.cfg, gen,
                           remat=env_flag("HYDRAGNN_DIMENET_REMAT"))
