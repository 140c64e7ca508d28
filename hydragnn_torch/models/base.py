"""Shared multi-headed GNN skeleton (port of hydragnn_tpu/models/base.py).

A stack of message-passing convolutions with masked BatchNorm feature
layers, masked global mean pooling, and N decoder heads (graph-level MLP
heads behind a shared MLP trunk; node-level MLP / per-node-MLP / conv-stack
heads) over a padded :class:`GraphBatch`.

Parameters carry the reference HydraGNN checkpoint names
(``graph_convs.{i}.*``, ``feature_layers.{i}.module.*``,
``graph_shared.{2j}``, ``heads_NN.{k}.{2j}``,
``heads_NN.{k}.mlp.{n}.{2j}``), the names ``tools/port_weights.py``
already translates to the flax tree; utils/weights.py carries weights and
BatchNorm statistics in both directions.  Conv-type node heads share one
hidden conv stack (``convs_node_hidden``, ``batch_norms_node_hidden``)
and end in their own output conv and BatchNorm (``heads_NN.{k}``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from hydragnn_torch.graph import segment
from hydragnn_torch.graph.batch import GraphBatch
from hydragnn_torch.models.layers import (
    MaskedBatchNorm,
    activation_module,
    loss_function,
    mlp,
)


def _validated_compute_dtype(arch) -> str:
    dt = ("bfloat16" if arch.get("mixed_precision")
          else arch.get("compute_dtype", "float32"))
    if dt not in ("float32", "bfloat16"):
        raise ValueError(
            f"compute_dtype must be 'float32' or 'bfloat16', got {dt!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class GraphHeadCfg:
    num_sharedlayers: int
    dim_sharedlayers: int
    num_headlayers: int
    dim_headlayers: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class NodeHeadCfg:
    num_headlayers: int
    dim_headlayers: Tuple[int, ...]
    type: str = "mlp"  # "mlp" | "mlp_per_node" | "conv"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model hyper-parameters (the reference's fields and
    ``from_config``)."""

    model_type: str
    input_dim: int
    hidden_dim: int
    output_dim: Tuple[int, ...]
    output_type: Tuple[str, ...]
    graph_head: Optional[GraphHeadCfg]
    node_head: Optional[NodeHeadCfg]
    activation: str = "relu"
    loss_fn: str = "mse"
    task_weights: Tuple[float, ...] = ()
    equivariance: bool = False
    num_conv_layers: int = 2
    num_nodes: Optional[int] = None
    edge_dim: Optional[int] = None
    dropout: float = 0.25
    freeze_conv: bool = False
    initial_bias: Optional[float] = None
    compute_dtype: str = "float32"
    pna_avg_deg_log: Optional[float] = None
    pna_avg_deg_lin: Optional[float] = None
    gat_heads: int = 6
    gat_negative_slope: float = 0.05
    max_degree: Optional[int] = None
    max_neighbours: Optional[int] = None
    num_gaussians: Optional[int] = None
    num_filters: Optional[int] = None
    radius: Optional[float] = None
    envelope_exponent: Optional[int] = None
    num_before_skip: Optional[int] = None
    num_after_skip: Optional[int] = None
    num_radial: Optional[int] = None
    num_spherical: Optional[int] = None
    basis_emb_size: Optional[int] = None
    int_emb_size: Optional[int] = None
    out_emb_size: Optional[int] = None

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                "compute_dtype must be 'float32' or 'bfloat16', "
                f"got {self.compute_dtype!r}")

    @property
    def use_edge_attr(self) -> bool:
        return self.edge_dim is not None and self.edge_dim > 0

    @property
    def num_heads(self) -> int:
        return len(self.output_dim)

    @property
    def norm_task_weights(self) -> Tuple[float, ...]:
        s = sum(abs(w) for w in self.task_weights)
        return tuple(w / s for w in self.task_weights)

    @staticmethod
    def from_config(config: Dict[str, Any]) -> "ModelConfig":
        """Build from a finalized reference-schema config dict (the full
        config or its NeuralNetwork section)."""
        if "NeuralNetwork" in config:
            config = config["NeuralNetwork"]
        arch = config["Architecture"]
        training = config["Training"]
        heads_cfg = arch.get("output_heads", {})
        graph_head = None
        if "graph" in heads_cfg:
            g = heads_cfg["graph"]
            graph_head = GraphHeadCfg(
                num_sharedlayers=g["num_sharedlayers"],
                dim_sharedlayers=g["dim_sharedlayers"],
                num_headlayers=g["num_headlayers"],
                dim_headlayers=tuple(g["dim_headlayers"]),
            )
        node_head = None
        if "node" in heads_cfg:
            n = heads_cfg["node"]
            node_head = NodeHeadCfg(
                num_headlayers=n["num_headlayers"],
                dim_headlayers=tuple(n["dim_headlayers"]),
                type=n.get("type", "mlp"),
            )
        pna_deg = arch.get("pna_deg")
        avg_log = avg_lin = None
        if pna_deg is not None:
            hist = np.asarray(pna_deg, dtype=np.float64)
            bins = np.arange(len(hist), dtype=np.float64)
            total = max(hist.sum(), 1.0)
            avg_log = float((np.log(bins + 1) * hist).sum() / total)
            avg_lin = float((bins * hist).sum() / total)
        hidden_dim = arch["hidden_dim"]
        if arch["model_type"] == "CGCNN":
            hidden_dim = arch["input_dim"]
        return ModelConfig(
            model_type=arch["model_type"],
            input_dim=arch["input_dim"],
            hidden_dim=hidden_dim,
            output_dim=tuple(arch["output_dim"]),
            output_type=tuple(arch["output_type"]),
            graph_head=graph_head,
            node_head=node_head,
            activation=arch.get("activation_function", "relu"),
            loss_fn=training.get("loss_function_type", "mse"),
            task_weights=tuple(float(w) for w in arch["task_weights"]),
            equivariance=bool(arch.get("equivariance", False)),
            num_conv_layers=arch["num_conv_layers"],
            num_nodes=arch.get("num_nodes"),
            edge_dim=arch.get("edge_dim"),
            freeze_conv=bool(arch.get("freeze_conv_layers", False)),
            initial_bias=arch.get("initial_bias"),
            compute_dtype=_validated_compute_dtype(arch),
            pna_avg_deg_log=avg_log,
            pna_avg_deg_lin=avg_lin,
            max_degree=arch.get("max_neighbours"),
            max_neighbours=arch.get("max_neighbours"),
            num_gaussians=arch.get("num_gaussians"),
            num_filters=arch.get("num_filters"),
            radius=arch.get("radius"),
            envelope_exponent=arch.get("envelope_exponent"),
            num_before_skip=arch.get("num_before_skip"),
            num_after_skip=arch.get("num_after_skip"),
            num_radial=arch.get("num_radial"),
            num_spherical=arch.get("num_spherical"),
            basis_emb_size=arch.get("basis_emb_size"),
            int_emb_size=arch.get("int_emb_size"),
            out_emb_size=arch.get("out_emb_size"),
            dropout=float(arch.get("dropout", 0.25)),
        )


class NodeMLPHead(nn.Module):
    """Node-level MLP head: one shared MLP (``mlp.0``), or one MLP per
    node index within its fixed-size graph (``mlp.{n}``)."""

    def __init__(self, in_dim, hidden_dims, output_dim, activation, gen,
                 per_node=False, num_nodes=None):
        super().__init__()
        self.per_node = per_node
        self.activation = activation
        if per_node and num_nodes is None:
            raise ValueError("num_nodes required for mlp_per_node")
        self.num_nodes = num_nodes
        count = num_nodes if per_node else 1
        feats = tuple(hidden_dims) + (output_dim,)
        self.mlp = nn.ModuleList(
            mlp(in_dim, feats, activation, gen) for _ in range(count))

    def forward(self, x, node_gid):
        if not self.per_node:
            return self.mlp[0](x)
        # per-node banks selected by the node's index within its graph
        n = x.shape[0]
        local = (torch.arange(n, device=x.device)
                 - node_gid.long() * self.num_nodes)
        local = local.clamp(0, self.num_nodes - 1)
        act = activation_module(self.activation)
        lins = [m for m in self.mlp[0] if isinstance(m, nn.Linear)]
        h = x
        for j in range(len(lins)):
            w = torch.stack([self.mlp[i][2 * j].weight
                             for i in range(self.num_nodes)])
            b = torch.stack([self.mlp[i][2 * j].bias
                             for i in range(self.num_nodes)])
            h = torch.einsum("ni,noi->no", h, w[local]) + b[local]
            if j < len(lins) - 1:
                h = act(h)
        return h


class NodeConvHead(nn.Module):
    """Output conv and BatchNorm of one conv-type node head; the hidden
    conv stack before them is shared by all such heads and owned by
    :class:`Base`."""

    def __init__(self, conv: nn.Module, bn: nn.Module):
        super().__init__()
        self.conv = conv
        self.bn = bn


class Base(nn.Module):
    """Shared skeleton; subclasses provide ``make_conv``."""

    # subclasses turn this off where the reference uses identity feature
    # layers instead of BatchNorm (SchNet, EGNN)
    has_batchnorm = True

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator]):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.act = activation_module(c.activation)
        enc = self.encoder_dims()
        self.graph_convs = nn.ModuleList(
            self.make_conv(din, dout, i == len(enc) - 1, gen)
            for i, (din, dout, _) in enumerate(enc))
        self.feature_layers = nn.ModuleList(
            MaskedBatchNorm(bnf) for _, _, bnf in enc
        ) if self.has_batchnorm else None
        # conv-type node heads share their hidden conv stack across heads
        self.convs_node_hidden = self.batch_norms_node_hidden = None
        if (c.node_head is not None and c.node_head.type == "conv"
                and "node" in c.output_type):
            hidden, _ = self.node_conv_dims(0)
            self.convs_node_hidden = nn.ModuleList(
                self.make_conv(din, dout, False, gen)
                for din, dout, _ in hidden)
            self.batch_norms_node_hidden = nn.ModuleList(
                MaskedBatchNorm(bnf) for _, _, bnf in hidden)
        self.graph_shared = None
        if c.graph_head is not None:
            gh = c.graph_head
            self.graph_shared = mlp(
                c.hidden_dim, (gh.dim_sharedlayers,) * gh.num_sharedlayers,
                c.activation, gen, final_activation=True)
        heads = []
        for head_dim, head_type in zip(c.output_dim, c.output_type):
            if head_type == "graph":
                gh = c.graph_head
                heads.append(mlp(gh.dim_sharedlayers,
                                 tuple(gh.dim_headlayers) + (head_dim,),
                                 c.activation, gen))
            elif head_type == "node":
                nh = c.node_head
                if nh.type in ("mlp", "mlp_per_node"):
                    heads.append(NodeMLPHead(
                        c.hidden_dim, nh.dim_headlayers, head_dim,
                        c.activation, gen,
                        per_node=nh.type == "mlp_per_node",
                        num_nodes=c.num_nodes))
                elif nh.type == "conv":
                    _, (odin, odout, obnf) = self.node_conv_dims(head_dim)
                    heads.append(NodeConvHead(
                        self.make_conv(odin, odout, True, gen),
                        MaskedBatchNorm(obnf)))
                else:
                    raise ValueError(f"Unknown node head type: {nh.type}")
            else:
                raise ValueError(f"Unknown head type: {head_type}")
        self.heads_NN = nn.ModuleList(heads)

    def make_conv(self, in_dim: int, out_dim: int, last_layer: bool,
                  gen: Optional[torch.Generator]) -> nn.Module:
        raise NotImplementedError

    def encoder_dims(self) -> List[Tuple[int, int, int]]:
        """(in, out, BatchNorm features) of each encoder layer; a conv
        whose output is wider than ``out`` (GAT's concatenated heads) says
        so in the third entry."""
        c = self.cfg
        dims = [(c.input_dim, c.hidden_dim, c.hidden_dim)]
        for _ in range(c.num_conv_layers - 1):
            dims.append((c.hidden_dim, c.hidden_dim, c.hidden_dim))
        return dims

    def node_conv_dims(self, head_dim: int):
        """(in, out, BatchNorm features) of the hidden convs and of the
        output conv of a conv-type node head."""
        c = self.cfg
        hdn = list(c.node_head.dim_headlayers)
        hidden = [(c.hidden_dim, hdn[0], hdn[0])]
        for i in range(c.node_head.num_headlayers - 1):
            hidden.append((hdn[i], hdn[i + 1], hdn[i + 1]))
        return hidden, (hdn[-1], head_dim, head_dim)

    def forward(self, g: GraphBatch, dropout_seed: Optional[int] = None
                ) -> Tuple[torch.Tensor, ...]:
        """The heads' outputs.  ``dropout_seed`` seeds the attention-dropout
        bits of a training step (GAT reads it; the other architectures
        draw no random bits and ignore it)."""
        c = self.cfg
        x, pos = g.x, g.pos
        for i, conv in enumerate(self.graph_convs):
            x, pos = conv(x, pos, g)
            if self.feature_layers is not None:
                x = self.feature_layers[i](x, g.node_mask)
            x = self.act(x)

        x_graph = segment.masked_mean_pool(
            x, g.node_gid, g.num_graphs, g.node_mask,
            sorted_hint=bool(g.extras and "edge_perm_sender" in g.extras))

        outputs = []
        for head, head_type in zip(self.heads_NN, c.output_type):
            if head_type == "graph":
                outputs.append(head(self.graph_shared(x_graph)))
            elif isinstance(head, NodeConvHead):
                z, zpos = x, pos
                for conv, bn in zip(self.convs_node_hidden,
                                    self.batch_norms_node_hidden):
                    z, zpos = conv(z, zpos, g)
                    z = self.act(bn(z, g.node_mask))
                z, zpos = head.conv(z, zpos, g)
                outputs.append(self.act(head.bn(z, g.node_mask)))
            else:
                outputs.append(head(x, g.node_gid))
        return tuple(outputs)


def multihead_loss(cfg: ModelConfig, outputs: Sequence[torch.Tensor],
                   g: GraphBatch) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Weighted multi-task loss over padded batches: per-head masked loss
    times normalized task weights."""
    if cfg.loss_fn == "gaussian_nll":
        raise NotImplementedError(
            "loss_function_type 'gaussian_nll' is not ported yet")
    loss_fn = loss_function(cfg.loss_fn)
    weights = cfg.norm_task_weights
    total = 0.0
    per_head = []
    for ihead, (out, head_type) in enumerate(zip(outputs, cfg.output_type)):
        label = g.labels[ihead]
        mask = g.graph_mask if head_type == "graph" else g.node_mask
        head_loss = loss_fn(out, label, mask)
        per_head.append(head_loss)
        total = total + weights[ihead] * head_loss
    return total, per_head
