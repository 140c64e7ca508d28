"""GAT stack (port of hydragnn_tpu/models/gat.py).

GATv2 attention with 6 heads, negative slope 0.05, attention dropout
(``Architecture.dropout``, 0.25 by default) and self loops.  All but the
last encoder layer concatenate their heads (``hidden_dim * heads``
features, which their BatchNorm normalises); the last layer averages them.

The softmax runs over each receiver's real incident edges plus its self
loop.  Under ``HYDRAGNN_AGGR_BACKEND=fused`` (or ``HYDRAGNN_GAT_FUSED=1``)
and with collate's sender-sort marker, the edge side goes through the
fused attention op (ops/gat_mp.py, three hand-written kernels), tiled over
head groups above its width limit, and the self loop is merged here in
plain torch; otherwise the composed path (segment ops) runs.  Both take
the maximum shift without gradient (softmax is shift-invariant), as the
reference does.  Tally key ``gat_attn``.

Parameter names follow the reference checkpoint (``lin_l``, ``lin_r``,
``att [1, heads, F]``, ``bias``).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from hydragnn_torch.graph import segment
from hydragnn_torch.models.base import Base
from hydragnn_torch.models.layers import LECUN_NORMAL, dense, dense_leaves
from hydragnn_torch.ops import gat_mp

_NEG = -1e9


def _fused_gat_enabled() -> bool:
    """The fused attention gate: ``HYDRAGNN_GAT_FUSED`` overrides, else it
    follows the fused aggregation backend."""
    v = os.environ.get("HYDRAGNN_GAT_FUSED")
    if v is not None:
        return v not in ("", "0", "false", "False")
    from hydragnn_torch.ops.aggregate import aggr_backend

    return aggr_backend() == "fused"


class GATv2Conv(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, heads: int,
                 negative_slope: float, concat: bool, dropout: float, gen):
        super().__init__()
        self.out_dim = out_dim    # per head
        self.heads = heads
        self.negative_slope = negative_slope
        self.concat = concat
        self.dropout = dropout
        # the train step's seed of this layer's dropout bits (GATStack
        # sets it before each forward; None outside a train step)
        self.dropout_seed: Optional[int] = None
        self.lin_l = dense(in_dim, heads * out_dim, LECUN_NORMAL, gen)
        self.lin_r = dense(in_dim, heads * out_dim, LECUN_NORMAL, gen)
        # flax's lecun_normal on [1, heads, F]: fan-in = heads
        std = math.sqrt(1.0 / heads) / 0.87962566103423978
        att = torch.empty(1, heads, out_dim)
        nn.init.trunc_normal_(att, 0.0, std, -2 * std, 2 * std, generator=gen)
        self.att = nn.Parameter(att)
        self.bias = nn.Parameter(
            torch.zeros(heads * out_dim if concat else out_dim))

    def flax_leaves(self):
        """flax leaf path -> (tensor, transpose?), for utils/weights.py."""
        out = dict(dense_leaves("lin_l", self.lin_l))
        out.update(dense_leaves("lin_r", self.lin_r))
        out[("att",)] = (self.att, False)
        out[("bias",)] = (self.bias, False)
        return out

    def _logits(self, s, t):
        h, f = self.heads, self.out_dim
        z = F.leaky_relu(s + t, self.negative_slope)
        return torch.sum(z.reshape(-1, h, f) * self.att, dim=-1)

    def _dropout_bits(self, e_count, n, device, dtype):
        """Attention-dropout bits over keep for the edges ``[E, H]`` and the
        self loops ``[N, H]`` (None, None when inactive: eval mode or
        dropout 0) — one definition for both attention paths.  Drawn from
        a generator on the batch's device seeded with ``dropout_seed``."""
        if not (self.training and self.dropout > 0):
            return None, None
        if self.dropout_seed is None:
            raise RuntimeError(
                "GAT attention dropout in training mode needs the train "
                "step's seed: call the model with dropout_seed=...")
        gen = torch.Generator(device=device)
        gen.manual_seed(self.dropout_seed)
        keep = 1.0 - self.dropout
        h = self.heads
        b_edge = (torch.rand((e_count, h), generator=gen, device=device)
                  < keep).to(dtype) / keep
        b_self = (torch.rand((n, h), generator=gen, device=device)
                  < keep).to(dtype) / keep
        return b_edge, b_self

    def forward(self, x, pos, g):
        n = x.shape[0]
        h, f = self.heads, self.out_dim
        xl = self.lin_l(x)  # source transform, [N, h*f]
        xr = self.lin_r(x)  # target transform
        b_edge, b_self = self._dropout_bits(g.senders.shape[0], n, x.device,
                                            x.dtype)
        perm = g.extras.get("edge_perm_sender") if g.extras else None
        # the width gate is per head: wider h*f tiles over head groups
        fused = (perm is not None and _fused_gat_enabled()
                 and gat_mp.fused_head_width_ok(f))
        segment._count("gat_attn", fused)
        if fused:
            out = self._fused_attention(xl, xr, g, perm, b_edge, b_self)
        else:
            out = self._composed_attention(xl, xr, g, b_edge, b_self)
        if self.concat:
            out = out.reshape(n, h * f)
        else:
            out = out.mean(dim=1)
        return out + self.bias, pos

    def _composed_attention(self, xl, xr, g, b_edge, b_self):
        """Segment-op attention: logits gathers, the segment softmax with
        the self loop, the gather-multiply aggregation.  [N, h, f]."""
        n = xl.shape[0]
        h, f = self.heads, self.out_dim
        dst = g.receivers.long()
        e_edge = self._logits(segment.gather_sender(xl, g),
                              segment.gather_receiver_sorted(xr, g))
        e_self = self._logits(xl, xr)
        e_edge = torch.where(g.edge_mask[:, None] > 0, e_edge,
                             torch.full_like(e_edge, _NEG))
        seg_max = segment.segment_max(e_edge, g.receivers, n)
        deg = segment.degree(g.receivers, n, g.edge_mask)
        seg_max = torch.where(deg[:, None] > 0, seg_max, e_self)
        seg_max = torch.maximum(seg_max, e_self).detach()
        exp_edge = torch.exp(e_edge - seg_max[dst]) * g.edge_mask[:, None]
        exp_self = torch.exp(e_self - seg_max)
        denom = segment.scatter_segment(exp_edge, g) + exp_self
        denom = torch.clamp(denom, min=1e-16)
        alpha_edge = exp_edge / denom[dst]
        alpha_self = exp_self / denom
        if b_edge is not None:
            alpha_edge = alpha_edge * b_edge
            alpha_self = alpha_self * b_self
        out = segment.gather_mul_segment(
            xl, alpha_edge.repeat_interleave(f, dim=1), g)
        return out.reshape(n, h, f) + alpha_self[:, :, None] * xl.reshape(
            n, h, f)

    def _fused_attention(self, xl, xr, g, perm, b_edge, b_self):
        """The fused edge attention (ops/gat_mp.py) and the self loop merged
        here: the same softmax over {incident edges} and {self} as the
        composed path, with the max shifts frozen.  [N, h, f]."""
        n = xl.shape[0]
        h, f = self.heads, self.out_dim
        acc, m, d = gat_mp.gat_edge_attention_tiled(
            xl, xr, self.att.reshape(h, f), g.senders, g.receivers, perm,
            g.edge_mask, b_edge, self.negative_slope, f)
        m = m.detach()
        e_self = self._logits(xl, xr)
        m_t = torch.maximum(m, e_self).detach()
        r_e = torch.exp(m - m_t)
        r_s = torch.exp(e_self - m_t)
        d_t = torch.clamp(d * r_e + r_s, min=1e-16)
        w_s = r_s if b_self is None else b_self * r_s
        num = (acc * r_e.repeat_interleave(f, dim=1)
               + w_s.repeat_interleave(f, dim=1) * xl)
        return (num / d_t.repeat_interleave(f, dim=1)).reshape(n, h, f)


class GATStack(Base):
    def encoder_dims(self):
        # hidden layers concatenate heads (hidden * heads features, which
        # their BatchNorm normalises); the last layer averages them
        c = self.cfg
        h = c.gat_heads
        dims = [(c.input_dim, c.hidden_dim, c.hidden_dim * h)]
        for _ in range(c.num_conv_layers - 2):
            dims.append((c.hidden_dim * h, c.hidden_dim, c.hidden_dim * h))
        dims.append((c.hidden_dim * h, c.hidden_dim, c.hidden_dim))
        return dims

    def node_conv_dims(self, head_dim):
        c = self.cfg
        h = c.gat_heads
        hdn = list(c.node_head.dim_headlayers)
        hidden = [(c.hidden_dim, hdn[0], hdn[0] * h)]
        for i in range(c.node_head.num_headlayers - 1):
            hidden.append((hdn[i] * h, hdn[i + 1], hdn[i + 1] * h))
        return hidden, (hdn[-1] * h, head_dim, head_dim)

    def make_conv(self, in_dim, out_dim, last_layer, gen):
        c = self.cfg
        return GATv2Conv(in_dim, out_dim, heads=c.gat_heads,
                         negative_slope=c.gat_negative_slope,
                         concat=not last_layer, dropout=c.dropout, gen=gen)

    def forward(self, g, dropout_seed=None):
        # each conv, node-head convs included, draws its own stream
        convs = [m for m in self.modules() if isinstance(m, GATv2Conv)]
        for i, conv in enumerate(convs):
            conv.dropout_seed = (None if dropout_seed is None
                                 else (dropout_seed << 8) | i)
        return super().forward(g)
