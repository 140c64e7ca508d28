"""SchNet stack (port of hydragnn_tpu/models/schnet.py).

Continuous-filter convolution: Gaussian-smeared edge distances feed a
filter MLP (shifted softplus) under a cosine cutoff envelope hard-zeroed
beyond the radius; messages are filter-modulated linear node features,
sum-aggregated through ``segment.gather_mul_segment`` — the fused
gather-multiply kernel under ``HYDRAGNN_AGGR_BACKEND=fused`` — or, at
``num_filters >= 256`` under ``fused``, through the fused edge pipeline
(ops/scf_mp.py), which runs the filter MLP inside its kernels.  An optional
E(3)-equivariant position update (coord MLP on the filter values,
mean-aggregated displacement at the edge source) runs on all but the last
layer.

Parameter names follow the reference checkpoint (``nn.0``/``nn.2`` filter
layers, ``lin1``, ``lin2``, ``coord_mlp.0``/``coord_mlp.2``).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn as nn

from hydragnn_torch.graph import segment
from hydragnn_torch.models.base import Base
from hydragnn_torch.models.layers import (
    LECUN_NORMAL,
    XAVIER_UNIFORM,
    ShiftedSoftplus,
    dense,
    dense_leaves,
    edge_geometry,
)
from hydragnn_torch.ops.scf_mp import (
    SCF_F_LIMIT,
    SCF_G_LIMIT,
    scf_edge_pipeline,
)


def gaussian_smearing(dist, radius, num_gaussians):
    """PyG GaussianSmearing(0, radius, num_gaussians) parity."""
    offsets = torch.linspace(0.0, radius, num_gaussians, dtype=dist.dtype,
                             device=dist.device)
    coeff = -0.5 / (offsets[1] - offsets[0]) ** 2
    return torch.exp(coeff * (dist[:, None] - offsets[None, :]) ** 2)


def _scf_pipeline_enabled(num_filters: int, num_gaussians: int) -> bool:
    """The reference's gate for SchNet's fused edge-pipeline kernel:
    structural limits plus a width floor (``num_filters >= 256``),
    overridable with ``HYDRAGNN_SCF_FUSED=1/0`` — kept as is so dispatch
    matches the reference."""
    if num_gaussians > SCF_G_LIMIT or num_filters > SCF_F_LIMIT:
        return False
    v = os.environ.get("HYDRAGNN_SCF_FUSED")
    if v is not None:
        return v.strip().lower() not in ("0", "false", "off", "no", "")
    return num_filters >= 256


class SCFConv(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, num_gaussians: int,
                 num_filters: int, cutoff: float, equivariant: bool,
                 use_edge_attr: bool, gen: Optional[torch.Generator]):
        super().__init__()
        self.num_gaussians = num_gaussians
        self.num_filters = num_filters
        self.cutoff = float(cutoff)
        self.equivariant = equivariant
        self.use_edge_attr = use_edge_attr
        # filter MLP: Linear at slots 0 and 2 (reference CFConv.nn)
        self.nn = nn.Sequential(
            dense(num_gaussians, num_filters, LECUN_NORMAL, gen),
            ShiftedSoftplus(),
            dense(num_filters, num_filters, LECUN_NORMAL, gen))
        self.lin1 = dense(in_dim, num_filters, XAVIER_UNIFORM, gen,
                          bias=False)
        self.lin2 = dense(num_filters, out_dim, XAVIER_UNIFORM, gen)
        if equivariant:
            self.coord_mlp = nn.Sequential(
                dense(num_filters, num_filters, LECUN_NORMAL, gen),
                nn.ReLU(),
                dense(num_filters, 1, "fan_avg_uniform", gen, bias=False,
                      scale=1e-6))

    def flax_leaves(self):
        """flax leaf path -> (tensor, transpose?), for utils/weights.py."""
        lins = {"filter_0": self.nn[0], "filter_1": self.nn[2],
                "lin1": self.lin1, "lin2": self.lin2}
        if self.equivariant:
            lins["coord_mlp_0"] = self.coord_mlp[0]
            lins["coord_mlp_1"] = self.coord_mlp[2]
        out = {}
        for name, lin in lins.items():
            out.update(dense_leaves(name, lin))
        return out

    def forward(self, x, pos, g):
        n = x.shape[0]
        src, dst = g.senders, g.receivers
        if self.use_edge_attr and g.edge_attr is not None:
            w = torch.linalg.norm(g.edge_attr, dim=-1)
        else:
            d = pos[src] - pos[dst]
            w = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)
        rbf = gaussian_smearing(w, self.cutoff, self.num_gaussians)

        # cosine envelope, hard-zeroed beyond the cutoff
        cut = 0.5 * (torch.cos(w * math.pi / self.cutoff) + 1.0)
        cut = torch.where(w <= self.cutoff, cut, torch.zeros_like(cut))

        perm = g.extras.get("edge_perm_sender") if g.extras else None
        fused_pipeline = (
            perm is not None and not self.equivariant
            and _scf_pipeline_enabled(self.num_filters, self.num_gaussians))

        # the filter MLP runs inside the edge-pipeline kernels when they are
        # on; the composed path applies the same Linears
        filt = None
        if not fused_pipeline:
            filt = self.nn(rbf)
            filt = filt * cut[:, None] * g.edge_mask[:, None]
        h = self.lin1(x)

        if self.equivariant:
            diff, _ = edge_geometry(pos, src, dst)
            cmlp = self.coord_mlp(filt)
            trans = torch.clamp(diff * cmlp, -100.0, 100.0)
            pos = pos + segment.segment_mean(trans, src, n, g.edge_mask)

        if fused_pipeline:
            # filter MLP + gather + multiply + segment sum in the fused
            # edge-pipeline kernels (ops/scf_mp.py); weights [in, out]
            from hydragnn_torch.telemetry import pipeline

            pipeline.count_fused_choice("scf_pipeline", True)
            cm = cut * g.edge_mask
            em = g.edge_mask.to(torch.int32)
            f0, f1 = self.nn[0], self.nn[2]
            agg = scf_edge_pipeline(h, rbf, cm, em, f0.weight.t(), f0.bias,
                                    f1.weight.t(), f1.bias, g.senders,
                                    g.receivers, perm)
        else:
            agg = segment.gather_mul_segment(h, filt, g)
        return self.lin2(agg), pos


class SCFStack(Base):
    has_batchnorm = False  # identity feature layers, as in the reference

    def make_conv(self, in_dim, out_dim, last_layer, gen):
        c = self.cfg
        if c.num_gaussians is None or c.num_filters is None:
            raise ValueError("SchNet requires num_gaussians and num_filters")
        if c.radius is None:
            raise ValueError("SchNet requires radius input.")
        return SCFConv(
            in_dim, out_dim,
            num_gaussians=c.num_gaussians,
            num_filters=c.num_filters,
            cutoff=c.radius,
            equivariant=c.equivariance and not last_layer,
            use_edge_attr=c.use_edge_attr,
            gen=gen,
        )
