"""EGNN stack (port of hydragnn_tpu/models/egnn.py).

E(n)-equivariant graph convolution layer: edge MLP on
``[h_src, h_dst, ||dx||^2, edge_attr]``; equivariant coordinate update from
a scalar gate on the edge features (tanh-bounded, clamped, mean-aggregated
at the edge source); node MLP on ``[h, sum of the messages sent]``.  The
coordinate branch runs on all but the last layer; aggregation happens at
the edge *source*, as in the reference.  No BatchNorm feature layers.

The whole interaction block (gather, edge MLP, coordinate gate, both
scatters) dispatches to the fused EGCL kernels (ops/egcl_mp.py) when the
batch carries the sender-sort marker and the widths fit the kernels' tile
limits.  The composed path below runs otherwise (no marker, or widths past
the limits: the reference's own dispatch), tallied as ``egcl:scatter``.

Parameter names follow the reference checkpoint (``edge_mlp.0``/``.2``,
``coord_mlp.0``/``.2``, ``node_mlp.0``/``.2``).
"""

from __future__ import annotations

import os
import warnings

import torch
import torch.nn as nn

from hydragnn_torch.graph import segment
from hydragnn_torch.models.base import Base
from hydragnn_torch.models.layers import (
    LECUN_NORMAL,
    dense,
    dense_leaves,
    diff_geometry,
)
from hydragnn_torch.ops.egcl_mp import (
    EGCL_F_LIMIT,
    EGCL_GEO_LIMIT,
    EGCL_H_LIMIT,
    egcl_block,
)

_OFF = ("0", "false", "off", "no", "")


def _egcl_pipeline_enabled(features: int, hidden: int, geo_dim: int) -> bool:
    """The reference's gate for the fused EGCL block: structural tile limits
    only (no width floor), overridable with ``HYDRAGNN_EGCL_FUSED=1/0``
    within those limits."""
    if features > EGCL_F_LIMIT or hidden > EGCL_H_LIMIT \
            or geo_dim > EGCL_GEO_LIMIT:
        return False
    v = os.environ.get("HYDRAGNN_EGCL_FUSED")
    if v is not None:
        return v.strip().lower() not in _OFF
    return True


def _egcl_fused_wanted() -> bool:
    """Did the operator ask for the fused path?  Either knob counts: the
    aggregation backend or the EGCL-specific force."""
    if os.environ.get("HYDRAGNN_AGGR_BACKEND", "").strip().lower() \
            == "fused":
        return True
    v = os.environ.get("HYDRAGNN_EGCL_FUSED")
    return v is not None and v.strip().lower() not in _OFF


class EGCL(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int,
                 edge_dim: int, equivariant: bool, gen):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.edge_dim = edge_dim
        self.equivariant = equivariant
        self.edge_mlp = nn.Sequential(
            dense(2 * in_dim + 1 + edge_dim, hidden_dim, LECUN_NORMAL, gen),
            nn.ReLU(),
            dense(hidden_dim, hidden_dim, LECUN_NORMAL, gen))
        if equivariant:
            self.coord_mlp = nn.Sequential(
                dense(hidden_dim, hidden_dim, LECUN_NORMAL, gen),
                nn.ReLU(),
                dense(hidden_dim, 1, "fan_avg_uniform", gen, bias=False,
                      scale=0.001))
        self.node_mlp = nn.Sequential(
            dense(in_dim + hidden_dim, hidden_dim, LECUN_NORMAL, gen),
            nn.ReLU(),
            dense(hidden_dim, out_dim, LECUN_NORMAL, gen))

    def flax_leaves(self):
        """flax leaf path -> (tensor, transpose?), for utils/weights.py."""
        lins = {"edge_mlp_0": self.edge_mlp[0],
                "edge_mlp_1": self.edge_mlp[2],
                "node_mlp_0": self.node_mlp[0],
                "node_mlp_1": self.node_mlp[2]}
        if self.equivariant:
            lins["coord_mlp_0"] = self.coord_mlp[0]
            lins["coord_mlp_1"] = self.coord_mlp[2]
        out = {}
        for name, lin in lins.items():
            out.update(dense_leaves(name, lin))
        return out

    def forward(self, x, pos, g):
        n = x.shape[0]
        src = g.senders
        # pos at both ends through the gathers whose backward is the
        # sorted-segment kernel (with the marker; plain gathers without)
        diff, radial = diff_geometry(segment.gather_sender(pos, g)
                                     - segment.gather_receiver_sorted(pos, g))
        use_ea = bool(self.edge_dim) and g.edge_attr is not None
        geo_dim = 4 + (g.edge_attr.shape[-1] if use_ea else 0)

        perm = g.extras.get("edge_perm_sender") if g.extras else None
        fused = (perm is not None and _egcl_pipeline_enabled(
            x.shape[-1], self.hidden_dim, geo_dim))
        segment._count("egcl", fused)
        if not fused and _egcl_fused_wanted():
            warnings.warn(
                "EGNN: the fused EGCL block is off for this layer ("
                + ("the batch carries no sender permutation" if perm is None
                   else f"widths F={x.shape[-1]}, H={self.hidden_dim}, "
                        f"geo={geo_dim} past the kernel limits or "
                        "HYDRAGNN_EGCL_FUSED=0")
                + "); the composed path runs", stacklevel=2)

        e0, e1 = self.edge_mlp[0], self.edge_mlp[2]
        if fused:
            geo = torch.cat([diff, radial]
                            + ([g.edge_attr] if use_ea else []), dim=-1)
            em = g.edge_mask.to(torch.int32)
            c0 = c1 = None
            if self.equivariant:
                c0, c1 = self.coord_mlp[0], self.coord_mlp[2]
            agg, psum = egcl_block(
                self.equivariant, x, geo, em, e0.weight.t(), e0.bias,
                e1.weight.t(), e1.bias,
                None if c0 is None else c0.weight.t(),
                None if c0 is None else c0.bias,
                None if c1 is None else c1.weight.t(), src, g.receivers,
                perm)
            if self.equivariant:
                cnt = segment.segment_count(src, n, g.edge_mask)
                pos = pos + segment._mean_divide(psum, cnt)
        else:
            # gathers whose backward is the sorted-segment kernel (with the
            # marker: the width-gate fallback under the fused backend)
            parts = [segment.gather_sender(x, g),
                     segment.gather_receiver_sorted(x, g), radial]
            if use_ea:
                parts.append(g.edge_attr)
            m = torch.relu(e0(torch.cat(parts, dim=-1)))
            m = torch.relu(e1(m))
            m = m * g.edge_mask[:, None]
            if self.equivariant:
                c = self.coord_mlp(m)
                c = torch.tanh(c)
                trans = torch.clamp(diff * c, -100.0, 100.0)
                pos = pos + segment.segment_mean(trans, src, n, g.edge_mask)
            agg = segment.segment_sum(m, src, n, g.edge_mask)

        h = self.node_mlp(torch.cat([x, agg], dim=-1))
        return h, pos


class EGCLStack(Base):
    has_batchnorm = False  # identity feature layers, as in the reference

    def make_conv(self, in_dim, out_dim, last_layer, gen):
        c = self.cfg
        return EGCL(in_dim, out_dim, hidden_dim=c.hidden_dim,
                    edge_dim=c.edge_dim or 0,
                    equivariant=c.equivariance and not last_layer, gen=gen)
