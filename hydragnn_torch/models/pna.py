"""PNA stack (port of hydragnn_tpu/models/pna.py).

Principal Neighbourhood Aggregation with aggregators [mean, min, max, std]
and scalers [identity, amplification, attenuation, linear] (towers=1,
pre_layers=1, post_layers=1, divide_input=False as in PyG ``PNAConv``).
The degree-scaler averages come from the training set's degree histogram
(``finalize`` writes it; ``ModelConfig.from_config`` reduces it).

All four aggregators and the degree come from one multi-moment pass over
the messages (``segment.poly_scatter_segment`` — the scatter-mode kernel of
ops/poly_mp.py under ``HYDRAGNN_AGGR_BACKEND=fused``): mean and std from
the sum / sum-of-squares pair, min and max from the max of ``[msg, -msg]``.
The endpoint gathers' backward is the sorted-segment kernel
(``segment.gather_sender`` / ``gather_receiver_sorted``).

Parameter names follow the reference checkpoint (``pre_nns.0.0``,
``post_nns.0.0``, ``lin``, ``edge_encoder``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from hydragnn_torch.graph import segment
from hydragnn_torch.models.base import Base
from hydragnn_torch.models.layers import LECUN_NORMAL, dense, dense_leaves


class PNAConv(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, avg_deg_log: float,
                 avg_deg_lin: float, edge_dim: int, gen):
        super().__init__()
        f = in_dim
        self.avg_deg_log = float(avg_deg_log)
        self.avg_deg_lin = float(avg_deg_lin)
        self.edge_dim = edge_dim
        if edge_dim:
            self.edge_encoder = dense(edge_dim, f, LECUN_NORMAL, gen)
        self.pre_nns = nn.ModuleList([nn.Sequential(
            dense((3 if edge_dim else 2) * f, f, LECUN_NORMAL, gen))])
        self.post_nns = nn.ModuleList([nn.Sequential(
            dense(17 * f, out_dim, LECUN_NORMAL, gen))])
        self.lin = dense(out_dim, out_dim, LECUN_NORMAL, gen)

    def flax_leaves(self):
        out = {}
        out.update(dense_leaves("pre_nn", self.pre_nns[0][0]))
        out.update(dense_leaves("post_nn", self.post_nns[0][0]))
        out.update(dense_leaves("lin_out", self.lin))
        if self.edge_dim:
            out.update(dense_leaves("edge_encoder", self.edge_encoder))
        return out

    def forward(self, x, pos, g):
        h_src = segment.gather_sender(x, g)
        h_dst = segment.gather_receiver_sorted(x, g)
        if self.edge_dim:
            if g.edge_attr is None:
                raise ValueError(
                    "PNA with edge_dim needs edge_attr on the batch "
                    "(Architecture.edge_features); loaders that cannot "
                    "deliver it are ROADMAP queue A item 6")
            z = torch.cat([h_dst, h_src, self.edge_encoder(g.edge_attr)],
                          dim=-1)
        else:
            z = torch.cat([h_dst, h_src], dim=-1)
        msg = self.pre_nns[0](z)

        res = segment.poly_scatter_segment(
            msg, g, ("sum", "sq", "mx", "mn", "cnt"))
        deg = torch.clamp(res["cnt"], min=1.0)[:, None]
        mean = res["sum"] / deg
        sq_mean = res["sq"] / deg
        std = torch.sqrt(torch.clamp(sq_mean - mean * mean, min=0.0) + 1e-5)
        agg = torch.cat([mean, res["mn"], res["mx"], std], dim=-1)  # [N, 4F]

        log_deg = torch.log(deg + 1.0)
        scaled = torch.cat([
            agg,
            agg * (log_deg / self.avg_deg_log),
            agg * (self.avg_deg_log / log_deg),
            agg * (deg / max(self.avg_deg_lin, 1e-8)),
        ], dim=-1)  # [N, 16F]

        out = self.post_nns[0](torch.cat([x, scaled], dim=-1))
        return self.lin(out), pos


class PNAStack(Base):
    def make_conv(self, in_dim, out_dim, last_layer, gen):
        c = self.cfg
        if c.pna_avg_deg_log is None:
            raise ValueError("PNA requires degree input.")
        return PNAConv(in_dim, out_dim,
                       avg_deg_log=max(c.pna_avg_deg_log, 1e-8),
                       avg_deg_lin=c.pna_avg_deg_lin,
                       edge_dim=c.edge_dim or 0, gen=gen)
