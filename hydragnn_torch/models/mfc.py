"""MFC stack (port of hydragnn_tpu/models/mfc.py).

MFConv (molecular fingerprint conv): degree-dependent weight matrices —
``out_i = W_root[d_i] x_i + W[d_i] sum_{j->i} x_j + b[d_i]`` with ``d_i``
the in-degree clamped to ``max_degree``.  Neighbour sum and degree come
from one multi-moment pass (``segment.poly_gather_segment``); the banks are
applied as one wide matmul against all degrees plus a row select, as in the
reference.

Parameter names follow the reference checkpoint (PyG ``MFConv``): per-degree
``lins_l.{d}`` on the aggregated neighbours (bias carrier) and ``lins_r.{d}``
on the root; the flax tree stacks them into ``w_neigh``/``w_root``
``[max_degree + 1, in, out]`` and ``bias`` ``[max_degree + 1, out]``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from hydragnn_torch.graph import segment
from hydragnn_torch.models.base import Base
from hydragnn_torch.models.layers import LECUN_NORMAL, dense


class MFConv(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, max_degree: int, gen):
        super().__init__()
        self.max_degree = max_degree
        self.out_dim = out_dim
        d = max_degree + 1
        # flax's lecun_normal on a [d, in, out] bank takes fan-in d * in
        self.lins_l = nn.ModuleList(
            dense(in_dim, out_dim, LECUN_NORMAL, gen, fan_in=d * in_dim)
            for _ in range(d))
        self.lins_r = nn.ModuleList(
            dense(in_dim, out_dim, LECUN_NORMAL, gen, bias=False,
                  fan_in=d * in_dim) for _ in range(d))

    def flax_leaves(self):
        """Stacked banks: (list of per-degree tensors, transpose?)."""
        return {("w_root",): ([m.weight for m in self.lins_r], True),
                ("w_neigh",): ([m.weight for m in self.lins_l], True),
                ("bias",): ([m.bias for m in self.lins_l], False)}

    def _wide(self, lins):
        """Per-degree weights [d, out, in] as one [in, d * out] matrix."""
        w = torch.stack([m.weight for m in lins])
        return w.permute(2, 0, 1).reshape(w.shape[2], -1)

    def forward(self, x, pos, g):
        n = x.shape[0]
        d = self.max_degree + 1
        res = segment.poly_gather_segment(x, g, ("sum", "cnt"))
        deg = res["cnt"].to(torch.int64).clamp(0, self.max_degree)
        # the bias joins before the row select, so its gradient is a plain
        # sum over nodes (``bias[deg]`` would scatter-add it, in an order
        # that changes from run to run)
        bias = torch.cat([m.bias for m in self.lins_l])
        h = (x @ self._wide(self.lins_r)
             + res["sum"] @ self._wide(self.lins_l) + bias).reshape(
                 n, d, self.out_dim)
        return torch.take_along_dim(h, deg[:, None, None], dim=1)[:, 0], pos


class MFCStack(Base):
    def make_conv(self, in_dim, out_dim, last_layer, gen):
        if self.cfg.max_degree is None:
            raise ValueError("MFC requires max_neighbours input.")
        return MFConv(in_dim, out_dim, self.cfg.max_degree, gen)
