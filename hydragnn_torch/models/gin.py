"""GIN stack (port of hydragnn_tpu/models/gin.py).

GINConv with a 2-layer MLP and a trainable eps initialised to 100.0:
``out_i = MLP((1 + eps) x_i + sum_{j->i} x_j)``.  The neighbour sum goes
through ``segment.gather_segment`` — the no-``w`` mode of the
gather-multiply kernel under ``HYDRAGNN_AGGR_BACKEND=fused``.

Parameter names follow the reference checkpoint (``eps``, ``nn.0``,
``nn.2``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from hydragnn_torch.graph import segment
from hydragnn_torch.models.base import Base
from hydragnn_torch.models.layers import LECUN_NORMAL, dense, dense_leaves


class GINConv(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, gen, eps_init: float = 100.0):
        super().__init__()
        self.eps = nn.Parameter(torch.full((1,), float(eps_init)))
        self.nn = nn.Sequential(
            dense(in_dim, out_dim, LECUN_NORMAL, gen),
            nn.ReLU(),
            dense(out_dim, out_dim, LECUN_NORMAL, gen))

    def flax_leaves(self):
        """flax leaf path -> (tensor, transpose?); ``eps`` is a scalar in
        the flax tree."""
        out = {("eps",): (self.eps, False)}
        out.update(dense_leaves("mlp_0", self.nn[0]))
        out.update(dense_leaves("mlp_1", self.nn[2]))
        return out

    def forward(self, x, pos, g):
        agg = segment.gather_segment(x, g)
        return self.nn((1.0 + self.eps) * x + agg), pos


class GINStack(Base):
    def make_conv(self, in_dim, out_dim, last_layer, gen):
        return GINConv(in_dim, out_dim, gen)
