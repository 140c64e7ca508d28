"""CGCNN stack (port of hydragnn_tpu/models/cgcnn.py).

CGConv with additive aggregation: for ``z_ij = [x_i, x_j, e_ij]``,
``out_i = x_i + sum_{j->i} sigmoid(W_f z_ij) * softplus(W_s z_ij)``.
CGConv keeps the feature width, so the configuration forces
``hidden_dim = input_dim`` (models/base.py) and conv-type node heads are
refused (models/create.py), as in the reference.

The whole gated sum (both gathers, the gate pair, sigmoid * softplus, the
segment sum) dispatches to the fused cgcnn kernels (ops/cgcnn_mp.py) when
the batch carries the sender-sort marker and the widths fit the kernels'
limits; the composed path below runs otherwise, tallied as
``cgcnn:scatter``.  Parameter names follow the reference checkpoint
(``lin_f``, ``lin_s``).
"""

from __future__ import annotations

import os
import warnings

import torch
import torch.nn as nn
import torch.nn.functional as F

from hydragnn_torch.graph import segment
from hydragnn_torch.models.base import Base
from hydragnn_torch.models.layers import LECUN_NORMAL, dense, dense_leaves
from hydragnn_torch.ops.cgcnn_mp import (
    CGCNN_F_LIMIT,
    CGCNN_GEO_LIMIT,
    cgcnn_gated_block,
)

_OFF = ("0", "false", "off", "no", "")


def _cgcnn_pipeline_enabled(dim: int, edge_dim: int) -> bool:
    """The reference's gate for the fused gated sum: structural limits
    only (no width floor), overridable with ``HYDRAGNN_CGCNN_FUSED=1/0``
    within those limits."""
    if dim > CGCNN_F_LIMIT or edge_dim > CGCNN_GEO_LIMIT:
        return False
    v = os.environ.get("HYDRAGNN_CGCNN_FUSED")
    if v is not None:
        return v.strip().lower() not in _OFF
    return True


def _cgcnn_fused_wanted() -> bool:
    """Did the operator ask for the fused path?  Either knob counts: the
    aggregation backend or the CGCNN-specific force."""
    if os.environ.get("HYDRAGNN_AGGR_BACKEND", "").strip().lower() \
            == "fused":
        return True
    v = os.environ.get("HYDRAGNN_CGCNN_FUSED")
    return v is not None and v.strip().lower() not in _OFF


class CGConv(nn.Module):
    def __init__(self, dim: int, edge_dim: int, gen):
        super().__init__()
        self.dim = dim
        self.edge_dim = edge_dim
        # the gate pair on z = [x_i, x_j, e_ij], flax's default init as
        # the reference's DenseParams
        self.lin_f = dense(2 * dim + edge_dim, dim, LECUN_NORMAL, gen)
        self.lin_s = dense(2 * dim + edge_dim, dim, LECUN_NORMAL, gen)

    def flax_leaves(self):
        """flax leaf path -> (tensor, transpose?), for utils/weights.py."""
        return {**dense_leaves("lin_f", self.lin_f),
                **dense_leaves("lin_s", self.lin_s)}

    def forward(self, x, pos, g):
        use_ea = bool(self.edge_dim) and g.edge_attr is not None
        a = g.edge_attr.shape[-1] if use_ea else 0

        perm = g.extras.get("edge_perm_sender") if g.extras else None
        fused = perm is not None and _cgcnn_pipeline_enabled(self.dim, a)
        segment._count("cgcnn", fused)
        if not fused and _cgcnn_fused_wanted():
            reason = "no_sender_perm" if perm is None else "width_gate"
            warnings.warn(
                f"CGCNN: the fused gated-sum block is off for this layer "
                f"({reason}: dim={self.dim}, edge_dim={a}); the composed "
                "path runs", stacklevel=2)

        if fused:
            agg = cgcnn_gated_block(
                x, g.edge_attr if use_ea else None,
                g.edge_mask.to(torch.int32), self.lin_f.weight.t(),
                self.lin_f.bias, self.lin_s.weight.t(), self.lin_s.bias,
                g.senders, g.receivers, perm)
        else:
            # gathers whose backward is the sorted-segment kernel (with the
            # marker: the width-gate fallback under the fused backend)
            parts = [segment.gather_receiver_sorted(x, g),
                     segment.gather_sender(x, g)]
            if use_ea:
                parts.append(g.edge_attr)
            z = torch.cat(parts, dim=-1)
            gate = torch.sigmoid(self.lin_f(z))
            core = F.softplus(self.lin_s(z))
            agg = segment.poly_scatter_segment(gate * core, g,
                                               ("sum",))["sum"]
        return x + agg, pos


class CGCNNStack(Base):
    def make_conv(self, in_dim, out_dim, last_layer, gen):
        return CGConv(in_dim, self.cfg.edge_dim or 0, gen)
