"""Model factory (port of hydragnn_tpu/models/create.py).

All nine architectures of the reference are ported.  Parameters are
initialised from an explicit ``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn as nn

from hydragnn_torch.models.base import Base, ModelConfig
from hydragnn_torch.models.cgcnn import CGCNNStack
from hydragnn_torch.models.dimenet import DIMEStack
from hydragnn_torch.models.egnn import EGCLStack
from hydragnn_torch.models.gat import GATStack
from hydragnn_torch.models.gin import GINStack
from hydragnn_torch.models.mfc import MFCStack
from hydragnn_torch.models.pna import PNAStack
from hydragnn_torch.models.sage import SAGEStack
from hydragnn_torch.models.schnet import SCFStack

_STACKS = {"SAGE": SAGEStack, "GIN": GINStack, "MFC": MFCStack,
           "PNA": PNAStack, "SchNet": SCFStack, "EGNN": EGCLStack,
           "GAT": GATStack, "CGCNN": CGCNNStack, "DimeNet": DIMEStack}

# the reference's architecture list (models/create.py ALL_ARCHS)
ALL_ARCHS = ("SAGE", "GIN", "GAT", "MFC", "PNA", "CGCNN", "SchNet",
             "DimeNet", "EGNN")


def create_model(cfg: ModelConfig, seed: int = 0) -> Base:
    """Build and initialise the module on the CPU (move it with ``.to``)."""
    if cfg.model_type not in ALL_ARCHS:
        raise ValueError(f"Unknown model_type: {cfg.model_type}")
    if (cfg.model_type == "CGCNN" and cfg.node_head is not None
            and cfg.node_head.type == "conv" and "node" in cfg.output_type):
        raise ValueError(
            '"conv" node decoder is not supported for CGCNN '
            "(reference CGCNNStack.py:66-89).")
    if (cfg.model_type == "GAT" and cfg.dropout > 0
            and cfg.hidden_dim * cfg.gat_heads >= 256):
        # the reference's warning: at this width attention dropout makes
        # the BatchNorm running statistics track a train-time distribution
        # that eval mode does not see, and the eval error grows
        warnings.warn(
            f"GAT with attention dropout {cfg.dropout} at width "
            f"{cfg.hidden_dim}x{cfg.gat_heads} heads diverges in eval "
            "mode (BN running-stats mismatch; the JAX reference's finding, "
            'docs/PERF.md round 5). Set "Architecture": {"dropout": 0.0}.',
            stacklevel=2)
    if cfg.model_type == "PNA" and cfg.pna_avg_deg_log is None:
        raise ValueError("PNA requires degree input.")
    if cfg.model_type == "MFC" and cfg.max_degree is None:
        raise ValueError("MFC requires max_neighbours input.")
    if cfg.model_type == "DimeNet":
        for key in ("basis_emb_size", "envelope_exponent", "int_emb_size",
                    "out_emb_size", "num_after_skip", "num_before_skip",
                    "num_radial", "num_spherical", "radius"):
            if getattr(cfg, key) is None:
                raise ValueError(f"DimeNet requires {key} input.")
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            "mixed precision (compute_dtype bfloat16) is not ported yet — "
            "ROADMAP queue A5")
    gen = torch.Generator().manual_seed(seed)
    model = _STACKS[cfg.model_type](cfg, gen)
    if cfg.initial_bias is not None:
        # output-layer bias of every graph head (reference set_initial_bias)
        for head, head_type in zip(model.heads_NN, cfg.output_type):
            if head_type == "graph":
                last = [m for m in head if isinstance(m, nn.Linear)][-1]
                with torch.no_grad():
                    last.bias.fill_(float(cfg.initial_bias))
    return model
