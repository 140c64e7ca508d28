"""GraphSAGE stack (port of hydragnn_tpu/models/sage.py).

SAGEConv: ``out_i = W_self x_i + W_neigh mean_{j->i}(x_j)``.  The masked
neighbour mean takes its sum and its count from one multi-moment pass
(``segment.poly_gather_segment`` — the gather-mode kernel of
ops/poly_mp.py under ``HYDRAGNN_AGGR_BACKEND=fused``).

Parameter names follow the reference checkpoint (PyG ``SAGEConv``):
``lin_l`` acts on the aggregated neighbours and carries the bias,
``lin_r`` on the root.  In the flax tree the bias sits on ``lin_self``;
the sum is the same.
"""

from __future__ import annotations

import torch.nn as nn

from hydragnn_torch.graph import segment
from hydragnn_torch.models.base import Base
from hydragnn_torch.models.layers import LECUN_NORMAL, dense


class SAGEConv(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, gen):
        super().__init__()
        self.lin_l = dense(in_dim, out_dim, LECUN_NORMAL, gen)
        self.lin_r = dense(in_dim, out_dim, LECUN_NORMAL, gen, bias=False)

    def flax_leaves(self):
        return {("lin_self", "kernel"): (self.lin_r.weight, True),
                ("lin_self", "bias"): (self.lin_l.bias, False),
                ("lin_neigh", "kernel"): (self.lin_l.weight, True)}

    def forward(self, x, pos, g):
        res = segment.poly_gather_segment(x, g, ("sum", "cnt"))
        neigh = segment._mean_divide(res["sum"], res["cnt"])
        return self.lin_r(x) + self.lin_l(neigh), pos


class SAGEStack(Base):
    def make_conv(self, in_dim, out_dim, last_layer, gen):
        return SAGEConv(in_dim, out_dim, gen)
